"""Per-job generation options (the port's copy of cremage_tpu/core/config.py
`GenerationOptions`, without the yaml-backed preferences).

`GenerationOptions` is the per-job options namespace that crosses the job
queue and is serialized into PNG `generation_data` metadata; it keeps the
JAX package's fields so both packages read and write the same job dicts.
The port's SD1.5 pipeline rejects the options it does not implement yet
(pipelines/sd15.py).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict

# Generator model types (reference modules/cremage/const/const.py:17-24).
GMT_SD_1_5 = "SD 1.5"
GMT_SDXL = "SDXL"
GMT_SD_3 = "SD 3"
GMT_STABLE_CASCADE = "Stable Cascade"
GMT_PIXART_SIGMA = "PixArt-Sigma"
GMT_KANDINSKY_2_2 = "Kandinsky 2.2"
GMT_HUNYUAN_DIT = "Hunyuan DiT"
GMT_FLUX_1_SCHNELL = "FLUX.1-schnell"
GMT_SVD = "SVD"
GENERATOR_MODEL_TYPES = [
    GMT_SD_1_5, GMT_SDXL, GMT_SD_3, GMT_STABLE_CASCADE, GMT_PIXART_SIGMA,
    GMT_KANDINSKY_2_2, GMT_HUNYUAN_DIT, GMT_FLUX_1_SCHNELL, GMT_SVD,
]

# Generation modes the port runs (reference const.py:4-6).
MODE_TEXT_TO_IMAGE = "text_to_image"
MODE_IMAGE_TO_IMAGE = "image_to_image"
MODE_INPAINTING = "inpainting"


@dataclass
class GenerationOptions:
    """Per-job options namespace (reference `modules/sd/options.py`)."""

    # Core prompt/sampling options
    prompt: str = ""
    negative_prompt: str = ""
    H: int = 512
    W: int = 512
    C: int = 4                   # latent channels
    f: int = 8                   # VAE downsampling factor
    sampling_steps: int = 50
    sampler: str = "DDIM"
    scale: float = 7.5           # CFG scale
    ddim_eta: float = 0.0
    n_samples: int = 1
    n_iter: int = 1
    seed: int = -1
    clip_skip: int = 1
    # Model selection
    ckpt: str = ""
    vae_ckpt: str = ""
    control_net: str = ""
    inpaint_ckpt: str = ""
    refiner_ckpt: str = ""
    refiner_strength: float = 0.0
    lora_models: str = ""        # comma-separated paths (reference format)
    lora_weights: str = ""       # comma-separated floats
    embedding_path: str = ""
    # Mode inputs
    mode: str = MODE_TEXT_TO_IMAGE
    init_img: str = ""
    mask_img: str = ""
    strength: float = 0.75       # img2img denoising strength
    # Feature toggles
    safety_check: bool = True
    watermark: bool = False
    use_hires_fix: bool = False
    hires_fix_upscaler: str = "Latent"
    hires_fix_scale_factor: float = 1.5
    auto_face_fix: bool = False
    auto_face_fix_strength: float = 0.3
    auto_face_fix_prompt: str = ""
    auto_face_fix_face_detection_method: str = "InsightFace"
    # FaceID
    face_input_img: str = ""
    face_model: str = ""
    face_strength: float = 1.0
    # SDXL / EDM extras
    discretization: str = "LegacyDDPMDiscretization"
    discretization_sigma_min: float = 0.0292
    discretization_sigma_max: float = 14.6146
    discretization_rho: float = 3.0
    guider: str = "VanillaCFG"
    linear_prediction_guider_min_scale: float = 1.0
    linear_prediction_guider_max_scale: float = 1.5
    triangle_prediction_guider_min_scale: float = 1.0
    triangle_prediction_guider_max_scale: float = 2.5
    sampler_s_churn: float = 0.0
    sampler_s_tmin: float = 0.0
    sampler_s_tmax: float = 999.0
    sampler_s_noise: float = 1.0
    sampler_eta: float = 1.0
    sampler_order: int = 4
    # Speed features of the JAX package (not in this port yet)
    deep_cache: int = 1
    deep_cache_branch: int = 1
    tome_ratio: float = 0.0
    ada_cache: float = 0.0
    cfg_interval_low: float = 0.0
    cfg_interval_high: float = 0.0
    # Output
    outdir: str = "outputs"
    generator_model_type: str = GMT_SD_1_5
    wildcards_path: str = ""
    # Misc passthroughs
    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GenerationOptions":
        names = {f.name for f in dataclasses.fields(cls)}
        known = {k: v for k, v in d.items() if k in names}
        unknown = {k: v for k, v in d.items() if k not in names}
        opts = cls(**known)
        if unknown:
            opts.extra.update(unknown)
        return opts
