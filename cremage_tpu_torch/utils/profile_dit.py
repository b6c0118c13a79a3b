"""Where the time of one SD3, one PixArt-Σ and one Hunyuan-DiT txt2img
request goes in the port.

Run on a CUDA machine from the repository root:

    python3 -m cremage_tpu_torch.utils.profile_dit

Builds the full-width SD3-medium MMDiT, CLIP-L, bigG and 16-channel VAE,
and the full-width PixArt-Σ XL DiT and SD VAE (seeded random bf16 weights,
made on the card tensor by tensor), runs one warm-up `generate` of each
family's 1024^2 job (SD3: 28 flow-Euler steps at CFG 7.0; PixArt: 20
steps of "DPM++ 2M" at CFG 4.5; batch 1) and traces one more with
`torch.profiler` (utils/profile_sd15.py `trace`), and prints one JSON
object. Neither request runs T5: the served context is zeros in both
families, as in the JAX backends. Likewise Hunyuan-DiT v1.2 (the DiT, the
Chinese-CLIP BertModel, the mT5-XL encoder, the SDXL VAE) on its served
default job (25 steps of "DPM++ 2M" at CFG 5.0), both text branches
running; one more request times the blocks' MLP products by module (CUDA
events around each `mlp_fc1` and `mlp_fc2` call: their width, int(1408 *
4.3) = 6054, is not a multiple of 8), and `gemm_widths` times the same
products alone at 6054 and at the widths around it.
"""
from __future__ import annotations

import json
import sys

from cremage_tpu_torch.utils.profile_flux import seeded
from cremage_tpu_torch.utils.profile_sd15 import trace
from cremage_tpu_torch.utils.profile_svd import call_seconds

RES = 1024
JOBS = {"sd3": dict(sampling_steps=28, scale=7.0),
        "pixart": dict(sampling_steps=20, scale=4.5, sampler="DPM++ 2M"),
        "hunyuan": dict(sampling_steps=25, scale=5.0, sampler="DPM++ 2M")}
PROMPT = "a photograph of an astronaut riding a horse"
MLP_WIDTHS = (6054, 6048, 6056, 6144)   # Hunyuan-DiT's and its neighbours


def gemm_widths(dev, tokens: int = 8192, hidden: int = 1408,
                reps: int = 50) -> dict:
    """Device ms of one bf16 `Linear` product as the blocks run them (the
    CFG batch of 2 x 4096 tokens): hidden -> n (mlp_fc1) and n -> hidden
    (mlp_fc2), for each n of MLP_WIDTHS, by CUDA events around `reps`
    back-to-back calls after a warm-up."""
    import torch

    from cremage_tpu_torch.models.layers import Linear

    out = {}
    for n in MLP_WIDTHS:
        row = {}
        for name, (a, b) in (("fc1", (hidden, n)), ("fc2", (n, hidden))):
            lin = Linear(a, b).to(dev, torch.bfloat16)
            x = torch.randn(tokens, a, device=dev, dtype=torch.bfloat16)
            with torch.no_grad():
                for _ in range(5):
                    lin(x)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    lin(x)
                end.record()
                torch.cuda.synchronize()
            row[f"{name}_ms"] = start.elapsed_time(end) / reps
            row[f"{name}_tflops"] = 2.0 * tokens * a * b / row[f"{name}_ms"] / 1e9
        out[n] = row
    return out


def main() -> int:
    import torch

    import numpy as np

    from cremage_tpu_torch.core.config import GenerationOptions
    from cremage_tpu_torch.models.bert import BertModel, hunyuan_clip_config
    from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from cremage_tpu_torch.models.hunyuan import HunyuanDiT, hunyuan_dit_config
    from cremage_tpu_torch.models.layers import set_compute_dtype
    from cremage_tpu_torch.models.mmdit import MMDiT, sd3_medium_config
    from cremage_tpu_torch.models.open_clip import (
        OpenCLIPTextModel, openclip_bigg_config,
    )
    from cremage_tpu_torch.models.pixart import PixArt, pixart_sigma_xl_config
    from cremage_tpu_torch.models.t5 import T5Encoder, mt5_xl_config
    from cremage_tpu_torch.models.vae import (
        AutoencoderKL, VAEConfig, sd3_vae_config, sdxl_vae_config,
    )
    from cremage_tpu_torch.pipelines.hunyuan import (
        HunyuanBundle, HunyuanPipeline, HunyuanTextEncoder,
    )
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

    def hunyuan():
        vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + PROMPT.split()
        text = HunyuanTextEncoder(
            built(BertModel, hunyuan_clip_config(dtype=bf16), 7), vocab,
            built(T5Encoder, mt5_xl_config(dtype=bf16), 8),
            lambda prompt: np.arange(2, 3 + 2 * len(prompt.split())))
        return HunyuanPipeline(HunyuanBundle(
            dit=built(HunyuanDiT, hunyuan_dit_config(dtype=bf16), 9),
            vae=built(AutoencoderKL, sdxl_vae_config(dtype=bf16), 10),
            text=text), device=dev)

    out = dict(res=RES, t5="none (zero context) for sd3 and pixart",
               runs={})
    for name, build in (("sd3", sd3), ("pixart", pixart),
                        ("hunyuan", hunyuan)):
        pipe = build()
        opts = GenerationOptions(
            prompt=PROMPT, H=RES, W=RES, seed=0, n_samples=1,
            safety_check=False, watermark=False, **JOBS[name])
        pipe.generate(opts)
        out["runs"][name] = dict(JOBS[name],
                                 resident_bytes=torch.cuda.memory_allocated(),
                                 **trace(lambda: pipe.generate(opts)))
        if name == "hunyuan":
            blocks = pipe.bundle.dit.blocks
            out["runs"][name]["mlp_device_s"] = {
                k: dict(seconds=t, calls=n) for k, (t, n) in call_seconds(
                    {"mlp_fc1": [b.mlp_fc1 for b in blocks],
                     "mlp_fc2": [b.mlp_fc2 for b in blocks]},
                    lambda: pipe.generate(opts)).items()}
        del pipe
        torch.cuda.empty_cache()
    out["mlp_gemm_widths"] = gemm_widths(dev)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
