"""Time kernel K2 (group_norm_silu) at every main-path shape under several
plans: the per-CTA piece targets of its cluster route.

Run on a CUDA machine from the repository root:

    python3 -m cremage_tpu_torch.utils.groupnorm_sweep

Records the main path's GroupNorm shapes and calls per request as
chip_smoke.py does (one full-width UNet eval at the CFG batch of 8, one VAE
decode at batch 4, seeded random bf16 weights), then for each piece target
in TARGETS checks the kernels against the plain version at every shape and
times them with chip_smoke's `time_device`. The targets run in two rounds,
the second in the reverse order. Prints one JSON line per (round, target):
device ms per request (each shape's ms times its calls per request) and
per shape, with each shape's cluster size; then the card, and a last line
with the mean of both rounds for each target.
"""
from __future__ import annotations

import json
import subprocess
import sys

TARGETS = (32 * 1024, 48 * 1024, 64 * 1024, 96 * 1024, 128 * 1024, 224 * 1024)


def main() -> int:
    import torch

    import chip_smoke
    from cremage_tpu_torch.ops.groupnorm import (
        check_kernel_inputs, group_norm_silu_reference, launch_plan,
        plan_groupnorm,
    )
    from cremage_tpu_torch.pipelines.sd15 import build_sd15_bundle

    if not torch.cuda.is_available():
        print("groupnorm_sweep: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    bundle = build_sd15_bundle(dev, dtype=torch.bfloat16, seed=0)
    _, gn = chip_smoke.record_shapes(bundle, dev)
    del bundle
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for (n, c, h, w, eps, silu), calls in sorted(gn.items()):
        x = (torch.randn(n, c, h, w, device=dev, generator=g) * 2 + 1).bfloat16()
        wt = torch.randn(c, device=dev, generator=g)
        bt = torch.randn(c, device=dev, generator=g)
        check_kernel_inputs(x, wt, bt, 32)
        ref = group_norm_silu_reference(x, wt, bt, 32, eps, silu).float()
        tol = 2.0 ** -7 * max(1.0, float(ref.abs().max()))
        cases.append((x, wt, bt, eps, silu, calls, ref, tol))

    totals = {}
    for rnd, order in enumerate((TARGETS, TARGETS[::-1])):
        for target in order:
            per_shape, total = [], 0.0
            for x, wt, bt, eps, silu, calls, ref, tol in cases:
                n, c = x.shape[:2]
                plan = plan_groupnorm(n, c, x.shape[2] * x.shape[3], 32, target)

                def run():
                    return launch_plan(x, wt, bt, plan, 32, eps, silu)

                err = float((run().float() - ref).abs().max())
                if not err <= tol:
                    raise AssertionError(f"{list(x.shape)} target {target}: "
                                         f"error {err} > {tol}")
                ms = chip_smoke.time_device(run, 20)[0]
                total += ms * calls
                per_shape.append([list(x.shape), eps, silu, plan.route,
                                  plan.cluster, ms])
            totals.setdefault(target, []).append(total)
            chip_smoke.emit(dict(round=rnd, target=target, ms_per_request=total,
                                 shapes=per_shape))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    mean = {t: sum(v) / len(v) for t, v in totals.items()}
    print(json.dumps({"mean_ms_per_request": mean,
                      "fastest": min(mean, key=mean.get)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
