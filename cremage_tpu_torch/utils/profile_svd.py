"""Where the time of one SVD img2vid request goes in the port.

Run on a CUDA machine from the repository root:

    python3 -m cremage_tpu_torch.utils.profile_svd

Builds the full-width SVD bundle (the video UNet, the image VAE and the
ViT-H image tower, seeded random bf16 weights made on the card tensor by
tensor), runs one warm-up `SVDPipeline.sample` of bench_svd's job (14
frames at 576x1024, 25 EulerEDMSampler steps, the [uc; c] batch of 28)
and traces one more with `torch.profiler` (utils/profile_sd15.py
`trace`: wall time, the card's busy time and idle share, device time per
kernel family, launches). The temporal self-attention's plain einsums
and softmax and the (3, 1, 1) convolutions run kernels that the name
families cannot tell from the rest, so one more request times them by
module: CUDA events recorded before and after each call of
`TemporalSelfAttention` and of `Conv3x1x1` (its layout copies included),
summed. The card runs ahead of the host through a video UNet evaluation,
so each pair brackets the module's kernels. Prints one JSON object.
"""
from __future__ import annotations

import json
import sys

import numpy as np

from cremage_tpu_torch.utils.profile_flux import seeded
from cremage_tpu_torch.utils.profile_sd15 import trace

FRAMES, STEPS, RES = 14, 25, (576, 1024)   # bench_svd's job


def call_seconds(groups: dict, run) -> dict:
    """Device seconds of the calls of each group of modules in `run()`
    ({name: modules}), from CUDA events around every call (forward pre- and
    post-hooks): {name: (s, calls)}. The card runs ahead of the host, so
    each pair brackets the module's kernels."""
    import torch

    pairs = {name: [] for name in groups}
    hooks = []
    for name, modules in groups.items():
        for m in modules:
            def pre(mod, args, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                pairs[name].append([ev, None])

            def post(mod, args, out, name=name):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                pairs[name][-1][1] = ev

            hooks += [m.register_forward_pre_hook(pre),
                      m.register_forward_hook(post)]
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    return {k: (sum(a.elapsed_time(b) for a, b in v) / 1e3, len(v))
            for k, v in pairs.items()}


def module_seconds(model, classes, run) -> dict:
    """`call_seconds` of each class's modules in `model`: {class name: (s,
    calls)}."""
    return call_seconds({c.__name__: [m for m in model.modules()
                                      if isinstance(m, c)] for c in classes},
                        run)


def main() -> int:
    import torch

    from cremage_tpu_torch.models.clip_vision import CLIPVisionModel, vit_h14_config
    from cremage_tpu_torch.models.layers import set_compute_dtype
    from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from cremage_tpu_torch.models.video_unet import (
        Conv3x1x1, TemporalSelfAttention, VideoUNet, svd_unet_config,
    )
    from cremage_tpu_torch.pipelines.svd import SVDBundle, SVDOptions, SVDPipeline

    if not torch.cuda.is_available():
        print("profile_svd: CUDA is not available", file=sys.stderr)
        return 2
    bf16, dev = torch.bfloat16, torch.device("cuda")

    def on_meta(make):
        with torch.device("meta"):
            return set_compute_dtype(make(), bf16)

    unet = seeded(on_meta(lambda: VideoUNet(svd_unet_config(dtype=bf16),
                                            FRAMES)), dev, 1)
    vae = seeded(on_meta(lambda: AutoencoderKL(VAEConfig(dtype=bf16))), dev, 2)
    vit = seeded(on_meta(lambda: CLIPVisionModel(vit_h14_config(dtype=bf16))),
                 dev, 3)
    pipe = SVDPipeline(SVDBundle(unet=unet, vae=vae, clip_vision=vit),
                       device=dev)
    yy, xx = np.mgrid[0:RES[0], 0:RES[1]] / np.array(RES)[:, None, None]
    image = (np.stack([np.sin(7 * xx), np.cos(5 * yy), np.sin(4 * (xx + yy))],
                      -1) * 0.45 + 0.5).astype(np.float32)
    opts = SVDOptions(num_frames=FRAMES, num_steps=STEPS, seed=0)
    pipe.sample(image, SVDOptions(num_frames=FRAMES, num_steps=2, seed=0))
    out = dict(frames=FRAMES, steps=STEPS, res=list(RES), batch=2 * FRAMES,
               **trace(lambda: pipe.sample(image, opts)))
    out["module_device_s"] = {
        k: dict(seconds=s, calls=n) for k, (s, n) in module_seconds(
            unet, (TemporalSelfAttention, Conv3x1x1),
            lambda: pipe.sample(image, opts)).items()}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
