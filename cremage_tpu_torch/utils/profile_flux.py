"""Where the time of one FLUX.1-schnell txt2img request goes in the port.

Run on a CUDA machine from the repository root:

    python3 -m cremage_tpu_torch.utils.profile_flux

Builds the full-width FLUX.1-schnell transformer (seeded random bf16
weights, made on the card tensor by tensor), CLIP-L and the FLUX VAE,
then for each 8-bit kind of `flux_quantize` ("float8_e4m3", "none",
"int8") stores the transformer that way, runs one warm-up
`FluxPipeline.generate` of bench_flux's job (1024^2, 4 flow-Euler steps,
batch 1) and traces one more with `torch.profiler` (utils/profile_sd15.py
`trace`), and prints one JSON object. The request runs without T5 (the
zero T5 context the JAX backend gives every FLUX request), so T5's
encode is not in the trace.
"""
from __future__ import annotations

import json
import sys

from cremage_tpu_torch.utils.profile_sd15 import trace

STEPS, RES = 4, 1024   # bench_flux's job


def seeded(module, device, seed: int):
    """`module` (on the meta device) with seeded random weights made on
    `device` in their dtype: N(0, 1 / (3 fan_in)) for weights, 1 + 0.02 N
    for 1-D weights and scales, 0.02 N for biases and tables."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    state = {}
    for k, v in module.state_dict().items():
        z = torch.randn(v.shape, device=device, generator=g)
        if v.ndim == 1:
            z = 0.02 * z if k.endswith("bias") else 1.0 + 0.02 * z
        elif "embedding" in k:
            z = 0.02 * z
        else:
            z = z / (3 * v[0].numel()) ** 0.5
        state[k] = z.to(v.dtype)
    module.load_state_dict(state, assign=True)
    return module.eval()


def main() -> int:
    import torch

    from cremage_tpu_torch.core.config import GenerationOptions
    from cremage_tpu_torch.io.quantize import quantize_module
    from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
    from cremage_tpu_torch.models.flux import FluxModel, flux_schnell_config
    from cremage_tpu_torch.models.layers import set_compute_dtype
    from cremage_tpu_torch.models.vae import AutoencoderKL, flux_vae_config
    from cremage_tpu_torch.pipelines.flux import (
        FluxBundle, FluxConditioner, FluxPipeline,
    )
    from cremage_tpu_torch.prompt.tokenizer import default_tokenizer

    if not torch.cuda.is_available():
        print("profile_flux: CUDA is not available", file=sys.stderr)
        return 2
    bf16, dev = torch.bfloat16, torch.device("cuda")

    def on_meta(cls, cfg):
        with torch.device("meta"):
            return set_compute_dtype(cls(cfg), bf16)

    clip = seeded(on_meta(CLIPTextModel, CLIPTextConfig(dtype=bf16)), dev, 1)
    vae = seeded(on_meta(AutoencoderKL, flux_vae_config(dtype=bf16)), dev, 2)
    opts = GenerationOptions(prompt="a photograph of an astronaut riding a "
                             "horse", H=RES, W=RES, sampling_steps=STEPS,
                             seed=0, n_samples=1, safety_check=False,
                             watermark=False)
    out = dict(steps=STEPS, res=RES, t5="none (zero context)", runs={})
    for kind in ("float8_e4m3", "none", "int8"):
        model = seeded(on_meta(FluxModel, flux_schnell_config(dtype=bf16)),
                       dev, 3)
        if kind != "none":
            quantize_module(model, kind)
        torch.cuda.empty_cache()
        pipe = FluxPipeline(FluxBundle(model=model, vae=vae, conditioner=
                                       FluxConditioner(clip, default_tokenizer())),
                            device=dev)
        pipe.generate(opts)
        out["runs"][kind] = dict(resident_bytes=torch.cuda.memory_allocated(),
                                 **trace(lambda: pipe.generate(opts)))
        del pipe, model
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
