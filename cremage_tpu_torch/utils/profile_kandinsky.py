"""Where the time of one Kandinsky 2.2 txt2img request goes in the port.

Run on a CUDA machine from the repository root:

    python3 -m cremage_tpu_torch.utils.profile_kandinsky

Builds the full-width bundle (the prior, the decoder UNet with its image
conditioner, the bigG text tower and MoVQ; seeded random bf16 weights, made
on the card tensor by tensor), runs one warm-up `generate` of chip_smoke.py's
job (768^2, 50 decoder steps of Euler A, the prior's 25, CFG 4.0, batch 1),
traces one more with `torch.profiler` (utils/profile_sd15.py `trace`) and
times the stages of a third by module (CUDA events around each prior, text
tower, decoder UNet and MoVQ decoder call: utils/profile_svd.py
`call_seconds`), and prints one JSON object.
"""
from __future__ import annotations

import json
import sys

from cremage_tpu_torch.utils.profile_flux import seeded
from cremage_tpu_torch.utils.profile_sd15 import trace
from cremage_tpu_torch.utils.profile_svd import call_seconds

RES, STEPS, CFG = 768, 50, 4.0      # chip_smoke.py's kandinsky job
PROMPT = "a photograph of an astronaut riding a horse on the moon"


def build_pipeline(dev):
    """A full-width KandinskyPipeline on `dev` with seeded random bf16
    weights and clip statistics."""
    import torch

    from cremage_tpu_torch.models.kandinsky import (
        DiffusionPrior, KandinskyImageConditioner, PriorConfig,
    )
    from cremage_tpu_torch.models.kandinsky_decoder import (
        KandinskyUNet, KandinskyUNetConfig,
    )
    from cremage_tpu_torch.models.layers import set_compute_dtype
    from cremage_tpu_torch.models.open_clip import (
        OpenCLIPTextModel, openclip_bigg_config,
    )
    from cremage_tpu_torch.models.vq import MoVQ, MoVQConfig
    from cremage_tpu_torch.pipelines.kandinsky import (
        KandinskyBundle, KandinskyPipeline, KandinskyTextEncoder,
    )

    bf16 = torch.bfloat16

    def built(make, seed):
        with torch.device("meta"):
            return seeded(set_compute_dtype(make(), bf16), dev, seed)

    pcfg, dcfg = PriorConfig(dtype=bf16), KandinskyUNetConfig(dtype=bf16)
    g = torch.Generator(device=dev).manual_seed(20)
    e = pcfg.image_embed_dim
    bundle = KandinskyBundle(
        prior=built(lambda: DiffusionPrior(pcfg), 21),
        decoder=built(lambda: KandinskyUNet(dcfg), 22),
        image_cond=built(lambda: KandinskyImageConditioner(
            e, dcfg.time_embed_dim, dcfg.context_dim, dtype=bf16), 23),
        movq=built(lambda: MoVQ(MoVQConfig(dtype=bf16)), 24),
        text=KandinskyTextEncoder(built(lambda: OpenCLIPTextModel(
            openclip_bigg_config(dtype=bf16)), 25)),
        clip_mean=0.1 * torch.randn(e, device=dev, generator=g),
        clip_std=0.5 + torch.rand(e, device=dev, generator=g))
    return KandinskyPipeline(bundle, device=dev)


def main() -> int:
    import torch

    from cremage_tpu_torch.core.config import GenerationOptions

    if not torch.cuda.is_available():
        print("profile_kandinsky: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    pipe = build_pipeline(dev)
    opts = GenerationOptions(prompt=PROMPT, H=RES, W=RES, seed=0, n_samples=1,
                             sampling_steps=STEPS, scale=CFG,
                             safety_check=False, watermark=False)
    pipe.generate(opts)
    out = dict(res=RES, steps=STEPS, prior_steps=pipe.bundle.prior_steps,
               resident_bytes=torch.cuda.memory_allocated(),
               **trace(lambda: pipe.generate(opts)))
    b = pipe.bundle
    out["stage_device_s"] = {k: dict(seconds=t, calls=n) for k, (t, n) in
                             call_seconds({"prior": [b.prior],
                                           "text_tower": [b.text.tower],
                                           "decoder_unet": [b.decoder],
                                           "movq": [b.movq.decoder]},
                                          lambda: pipe.generate(opts)).items()}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
