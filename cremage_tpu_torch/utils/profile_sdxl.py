"""Where the time of one SDXL txt2img request goes in the PyTorch port.

Run on a CUDA machine from the repository root:

    python3 -m cremage_tpu_torch.utils.profile_sdxl

Builds the full-width SDXL base bundle with seeded random bf16 weights,
runs one warm-up `SDXLPipeline.generate` of the JAX package's bench_sdxl
job (1024^2, 30 steps of EulerEDMSampler, CFG 7.0, batch 1, as
chip_smoke.py's sdxl phase serves it), then traces one more with
`torch.profiler` and prints one JSON object, as utils/profile_sd15.py
does (wall time, busy time and idle share of the card, device time per
kernel family, top kernels).
"""
from __future__ import annotations

import json
import sys

from cremage_tpu_torch.utils.profile_sd15 import trace

STEPS, BATCH, RES = 30, 1, 1024   # bench_sdxl's job


def main() -> int:
    import torch

    from cremage_tpu_torch.core.config import GenerationOptions
    from cremage_tpu_torch.pipelines.sdxl import SDXLPipeline, build_sdxl_bundle

    if not torch.cuda.is_available():
        print("profile_sdxl: CUDA is not available", file=sys.stderr)
        return 2
    pipe = SDXLPipeline(build_sdxl_bundle("cuda", torch.bfloat16, seed=0),
                        device="cuda")
    opts = GenerationOptions(
        prompt="a photograph of an astronaut riding a horse",
        negative_prompt="blurry, low quality", H=RES, W=RES,
        sampling_steps=STEPS, sampler="EulerEDMSampler", scale=7.0, seed=0,
        n_samples=BATCH, safety_check=False, watermark=False)
    pipe.generate(opts)
    print(json.dumps(dict(steps=STEPS, batch=BATCH, res=RES,
                          **trace(lambda: pipe.generate(opts))), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
