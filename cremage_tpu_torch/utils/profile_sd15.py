"""Where the time of one SD1.5 txt2img request goes in the PyTorch port.

Run on a CUDA machine from the repository root:

    python3 -m cremage_tpu_torch.utils.profile_sd15

Builds the full-width SD1.5 bundle with seeded random bf16 weights, runs
one warm-up `SD15Pipeline.generate` of the main path's job (512^2, Euler A,
20 steps, CFG 7.5, batch 4, as chip_smoke.py serves it), then traces
one more with `torch.profiler` and prints one JSON object: the request's
wall time, the card's busy time (union of kernel intervals) and idle
share, device time per kernel family, and the top kernels by device time.
Kernel families are matched on kernel names: the port's two kernels by
their own names, the rest heuristically (layout copies, LayerNorm, cuDNN
convolutions, GEMMs, elementwise), the unmatched remainder as "other".
"""
from __future__ import annotations

import json
import sys
import time

STEPS, BATCH = 20, 4   # the main path's job

FAMILIES = (  # first match wins
    ("flash_attention (K1)", ("flash_fwd",)),
    ("group_norm_silu (K2)", ("gn_cluster", "gn_stats", "gn_apply")),
    ("layout copies", ("direct_copy", "nchwToNhwc", "nhwcToNchw", "CatArray")),
    ("layer_norm", ("layer_norm",)),
    ("convolution", ("conv", "implicit", "fprop", "cudnn")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas")),
    ("elementwise", ("elementwise", "vectorized", "reduce", "unrolled",
                     "upsample", "index")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def trace(run) -> dict:
    """Call `run()` (one request, warmed up) under torch.profiler: -> its
    wall time, the card's busy time (union of kernel intervals) and idle
    share, device time per kernel family, the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    by_family, by_name = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        by_family[family(e.name)] = by_family.get(family(e.name), 0.0) + d
        by_name[e.name] = by_name.get(e.name, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {
        "card": torch.cuda.get_device_name(0),
        "wall_s": wall, "device_busy_s": busy / 1e6,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "kernels": len(kernels),
        "device_s_by_family": {k: v / 1e6 for k, v in
                               sorted(by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels_s": [[n[:120], v / 1e6] for n, v in top],
    }


def main() -> int:
    import torch

    from cremage_tpu_torch.core.config import GenerationOptions
    from cremage_tpu_torch.pipelines.sd15 import SD15Pipeline, build_sd15_bundle

    if not torch.cuda.is_available():
        print("profile_sd15: CUDA is not available", file=sys.stderr)
        return 2
    pipe = SD15Pipeline(build_sd15_bundle("cuda", torch.bfloat16, seed=0),
                        device="cuda")
    opts = GenerationOptions(
        prompt="a photograph of an astronaut riding a horse",
        negative_prompt="blurry, low quality", H=512, W=512,
        sampling_steps=STEPS, sampler="Euler A", scale=7.5, seed=0,
        n_samples=BATCH, safety_check=False, watermark=False)
    pipe.generate(opts)
    print(json.dumps(dict(steps=STEPS, batch=BATCH,
                          **trace(lambda: pipe.generate(opts))), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
