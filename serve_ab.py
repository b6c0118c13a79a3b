"""The main path's serving time of two checkouts, side by side on one card.

    python3 serve_ab.py --tree build/parent --tree . [--rounds 2] [--repeats 3]

Runs the trees in the order A B B A (`--rounds` times), each in a process
of its own from its own root (so each imports its own `cremage_tpu_torch`
and `chip_smoke`): it builds the kernels, builds the seeded SD1.5 bundle and runs
chip_smoke.py's `serve` (the main path: 2 requests of 4 images at 512^2,
20 Euler A steps, through /v1/generate, after its warm-up request)
`--repeats` times, then times `Linear.forward` on the card at a shape
where the host's dispatch sets the time (bf16, (2, 77, 768) x (768, 768),
2000 calls). Prints one JSON line per process, then a summary line with
each tree's seconds per request. Needs one card and nvcc; imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path


def child(repeats: int) -> None:
    root = os.getcwd()
    sys.path[:] = [root] + [p for p in sys.path
                            if Path(p or ".").resolve() != Path(__file__).parent]
    import torch

    import chip_smoke as CS
    from cremage_tpu_torch.models.layers import Linear, set_compute_dtype
    from cremage_tpu_torch.ops import build
    from cremage_tpu_torch.pipelines.sd15 import build_sd15_bundle

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    build.build()
    build.kernels()
    bundle = build_sd15_bundle(dev, dtype=torch.bfloat16, seed=0)
    for _ in range(repeats):
        CS.serve(bundle, dev, card)     # prints its row; raises unless right
    lin = set_compute_dtype(Linear(768, 768), torch.bfloat16).to(dev)
    x = torch.randn(2, 77, 768, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        linear_ms = CS.time_ms(lambda: lin(x), 2000, warmup=50)
    print(json.dumps(dict(tree=root, linear_forward_us=linear_ms * 1e3)),
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--child", action="store_true")
    args = ap.parse_args()
    if args.child:
        child(args.repeats)
        return 0
    if len(args.tree) != 2:
        ap.error("give two --tree")
    a, b = (str(Path(t).resolve()) for t in args.tree)
    per_tree = {a: [], b: []}
    linear = {a: [], b: []}
    for tree in (a, b, b, a) * args.rounds:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             "--repeats", str(args.repeats)],
            cwd=tree, capture_output=True, text=True, timeout=600)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode:
            print(out.stdout[-4000:])
            raise SystemExit(f"{tree}: exit {out.returncode}")
        for line in out.stdout.splitlines():
            if not line.startswith("{"):
                continue
            row = json.loads(line)
            if row.get("phase") == "serving":
                per_tree[tree].append(row["seconds_per_request"])
            elif "linear_forward_us" in row:
                linear[tree].append(row["linear_forward_us"])
            print(json.dumps(dict(row, tree=tree)), flush=True)
    print(json.dumps({"summary": {
        t: dict(seconds_per_request=per_tree[t],
                median_s=statistics.median(per_tree[t]),
                linear_forward_us=linear[t]) for t in (a, b)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
