"""Where the time of one SD3 and one PixArt-Σ txt2img request goes in the
port.

Run on a CUDA machine from the repository root:

    python3 -m cremage_tpu_torch.utils.profile_dit

Builds the full-width SD3-medium MMDiT, CLIP-L, bigG and 16-channel VAE,
and the full-width PixArt-Σ XL DiT and SD VAE (seeded random bf16 weights,
made on the card tensor by tensor), runs one warm-up `generate` of each
family's 1024^2 job (SD3: 28 flow-Euler steps at CFG 7.0; PixArt: 20
steps of "DPM++ 2M" at CFG 4.5; batch 1) and traces one more with
`torch.profiler` (utils/profile_sd15.py `trace`), and prints one JSON
object. Neither request runs T5: the served context is zeros in both
families, as in the JAX backends.
"""
from __future__ import annotations

import json
import sys

from cremage_tpu_torch.utils.profile_flux import seeded
from cremage_tpu_torch.utils.profile_sd15 import trace

RES = 1024
JOBS = {"sd3": dict(sampling_steps=28, scale=7.0),
        "pixart": dict(sampling_steps=20, scale=4.5, sampler="DPM++ 2M")}


def main() -> int:
    import torch

    from cremage_tpu_torch.core.config import GenerationOptions
    from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from cremage_tpu_torch.models.layers import set_compute_dtype
    from cremage_tpu_torch.models.mmdit import MMDiT, sd3_medium_config
    from cremage_tpu_torch.models.open_clip import (
        OpenCLIPTextModel, openclip_bigg_config,
    )
    from cremage_tpu_torch.models.pixart import PixArt, pixart_sigma_xl_config
    from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig, sd3_vae_config
    from cremage_tpu_torch.pipelines.pixart import PixArtBundle, PixArtPipeline
    from cremage_tpu_torch.pipelines.sd3 import (
        SD3Bundle, SD3Conditioner, SD3Pipeline,
    )
    from cremage_tpu_torch.prompt.tokenizer import default_tokenizer

    if not torch.cuda.is_available():
        print("profile_dit: CUDA is not available", file=sys.stderr)
        return 2
    bf16, dev = torch.bfloat16, torch.device("cuda")

    def built(cls, cfg, seed):
        with torch.device("meta"):
            return seeded(set_compute_dtype(cls(cfg), bf16), dev, seed)

    def sd3():
        cond = SD3Conditioner(
            built(CLIPTextModel, CLIPTextConfig(dtype=bf16), 1),
            built(OpenCLIPTextModel, openclip_bigg_config(dtype=bf16), 2),
            default_tokenizer())
        return SD3Pipeline(SD3Bundle(
            mmdit=built(MMDiT, sd3_medium_config(dtype=bf16), 3),
            conditioner=cond,
            vae=built(AutoencoderKL, sd3_vae_config(dtype=bf16), 4)),
            device=dev)

    def pixart():
        return PixArtPipeline(PixArtBundle(
            dit=built(PixArt, pixart_sigma_xl_config(dtype=bf16), 5),
            vae=built(AutoencoderKL, VAEConfig(dtype=bf16), 6)), device=dev)

    out = dict(res=RES, t5="none (zero context)", runs={})
    for name, build in (("sd3", sd3), ("pixart", pixart)):
        pipe = build()
        opts = GenerationOptions(
            prompt="a photograph of an astronaut riding a horse", H=RES,
            W=RES, seed=0, n_samples=1, safety_check=False, watermark=False,
            **JOBS[name])
        pipe.generate(opts)
        out["runs"][name] = dict(JOBS[name],
                                 resident_bytes=torch.cuda.memory_allocated(),
                                 **trace(lambda: pipe.generate(opts)))
        del pipe
        torch.cuda.empty_cache()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
