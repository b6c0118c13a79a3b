"""K1's device time at a few shapes, to compare two trees in one call.

Run on a CUDA machine from the repository root, once per tree, in the
order parent, change, change, parent (the card's clocks drift between
calls, so compare only within one):

    for t in build/parent . . build/parent; do
        python3 cremage_tpu_torch/utils/flash_ab.py $t
    done

Each run imports `cremage_tpu_torch` from `tree` (another checkout unpacked
under build/, or the repository itself), builds that tree's kernels and
prints one JSON object: the tree and K1's ms a call (chip_smoke.py
`time_device`: 30 launches behind a GPU-side sleep) at SD1.5's 4096- and
1024-token self-attention, the SDXL refiner's 24 heads, Kandinsky's
added-KV attention, FLUX's dp = 128, MoVQ's d = 512 and Hunyuan-DiT's
dp = 96.
"""
import importlib.util
import json
import os
import sys

SHAPES = ((8, 4096, 4096, 8, 40), (8, 1024, 1024, 8, 80),
          (2, 4096, 4096, 24, 64), (2, 2304, 2314, 12, 64),
          (1, 4352, 4352, 24, 128), (1, 9216, 9216, 1, 512),
          (2, 4096, 4096, 16, 88))


def main(tree: str) -> int:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import cremage_tpu_torch
    from cremage_tpu_torch.ops import build
    from cremage_tpu_torch.ops.flash_attention import flash_attention

    if not cremage_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {cremage_tpu_torch.__file__}, not {tree}")
    spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    build.build()
    build.kernels()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for b, nq, nk, h, d in SHAPES:
        q = torch.randn(b, nq, h, d, device=dev, generator=g).bfloat16()
        k = torch.randn(b, nk, h, d, device=dev, generator=g).bfloat16()
        v = torch.randn(b, nk, h, d, device=dev, generator=g).bfloat16()
        out[str((b, nq, nk, h, d))] = smoke.time_device(
            lambda: flash_attention(q, k, v), 30)[0]
    print(json.dumps(dict(tree=tree, ms=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
