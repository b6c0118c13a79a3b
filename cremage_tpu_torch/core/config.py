"""Per-job generation options and the app preferences (the port's copy of
cremage_tpu/core/config.py `GenerationOptions` and of the `Preferences`
fields its SD1.5 backend reads).

`GenerationOptions` is the per-job options namespace that crosses the job
queue and is serialized into PNG `generation_data` metadata; it keeps the
JAX package's fields so both packages read and write the same job dicts.
The port's SD1.5 pipeline rejects the options it does not implement yet
(pipelines/sd15.py).

`load_preferences` reads the config.yaml that the JAX package's
`save_preferences` writes (`yaml.safe_dump` of a flat mapping of scalars)
without PyYAML: `read_flat_yaml` takes exactly that subset of YAML (plain,
single- and double-quoted scalars, folded over lines, resolved to null,
bool, int, float or str as YAML 1.1 resolves them) and raises on anything
else (nesting, sequences, flow collections, anchors, tags, block scalars).
"""
from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List

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


@dataclass
class Preferences:
    """The SD1.5 and SDXL model settings of the persistent app preferences
    (the JAX package's field names and defaults; its other fields are read
    from config.yaml and ignored). The SD1.5 backend loads ldm_model_path /
    ldm_model (ldm_inpaint_model for mode "inpainting") and TI files from
    embedding_path; the SDXL backend loads sdxl_ldm_model_path /
    sdxl_ldm_model (sdxl_ldm_inpaint_model, when set, for mode
    "inpainting") and TI files from sdxl_embedding_path; the SVD backend
    loads svd_model_path joined with a job's svd_model; the SD3 and
    PixArt-Σ backends sd3_ldm_model_path / sd3_ldm_model and
    pixart_sigma_ldm_model_path / pixart_sigma_ldm_model unless the job
    names its `ckpt`. A job's VAE,
    ControlNet and LoRA paths are used as given, as in the JAX backends, so
    control_model_path and lora_model_path only tell a client where the
    model files are."""

    ldm_model_path: str = "models/ldm"
    ldm_model: str = "v1-5-pruned.safetensors"
    ldm_inpaint_model: str = "sd-v1-5-inpainting.safetensors"
    control_model_path: str = "models/control_net"
    lora_model_path: str = "models/loras"
    embedding_path: str = "models/embeddings"
    sdxl_ldm_model_path: str = "models/ldm"
    sdxl_ldm_model: str = "None"
    sdxl_ldm_inpaint_model: str = "None"
    sdxl_embedding_path: str = "models/embeddings_sdxl"
    svd_model_path: str = "models/svd"
    sd3_ldm_model_path: str = "models/sd3_ldm"
    sd3_ldm_model: str = "None"
    pixart_sigma_ldm_model_path: str = "models/pixart_sigma_ldm"
    pixart_sigma_ldm_model: str = "None"


_PREF_FIELDS = {f.name for f in dataclasses.fields(Preferences)}


def load_preferences(path: str) -> Preferences:
    """Preferences from a JAX-written config.yaml (unknown keys ignored, as
    the JAX package does). Unlike the JAX package, a missing file raises
    instead of being created with defaults."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"config file {path} does not exist")
    with open(path, "r", encoding="utf-8") as f:
        data = read_flat_yaml(f.read())
    known = {}
    for k, v in data.items():
        if k not in _PREF_FIELDS:
            continue
        if v is not None and not isinstance(v, str):
            raise ValueError(f"{path}: {k} must be a string, got {v!r}")
        known[k] = v
    return dataclasses.replace(Preferences(), **known)


_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*):(?: (.*))?$")
_BOOL = {**dict.fromkeys("yes Yes YES true True TRUE on On ON".split(), True),
         **dict.fromkeys("no No NO false False FALSE off Off OFF".split(), False)}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    sign = -1 if text[0] == "-" else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def _plain(text: str):
    """A plain scalar resolved as YAML 1.1 (PyYAML's implicit resolvers)."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.lstrip("+-") == ".inf":
            return float("-inf") if t[0] == "-" else float("inf")
        if t == ".nan":
            return float("nan")
        return _sexagesimal(t, float) if ":" in t else float(t)
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        body = t.lstrip("+-")
        if ":" in body:
            return _sexagesimal(t, int)
        if body.startswith("0b"):
            return sign * int(body[2:], 2)
        if body.startswith("0x"):
            return sign * int(body[2:], 16)
        if body != "0" and body.startswith("0"):
            return sign * int(body, 8)
        return sign * int(body)
    if re.match(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}", text) or text == "=" \
            or text == "<<":
        raise ValueError(f"config: unsupported YAML scalar {text!r}")
    return text


def _fold(lines: List[str]) -> str:
    """Join the lines of a multi-line flow scalar: a line break becomes a
    space, or n newlines where n empty lines follow it; the whitespace
    around each break is dropped."""
    out, k = lines[0], 0
    if len(lines) > 1:
        out = out.rstrip(" \t")
    for j, ln in enumerate(lines[1:], 1):
        last = j == len(lines) - 1
        content = ln.lstrip(" \t") if last else ln.strip(" \t")
        if not content and not last:
            k += 1
            continue
        out += "\n" * k if k else " "
        out += content
        k = 0
    return out


def _double(body: str) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        if e in _HEX:
            n = _HEX[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        elif e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        else:
            raise ValueError(f"config: unknown escape \\{e}")
    return "".join(out)


def _quoted(lines: List[str], quote: str) -> str:
    """The scalar of the lines of a quoted value (opening quote first)."""
    text = "\n".join(lines)[1:]
    if quote == "'":
        m = re.match(r"^((?:[^']|'')*)'\s*(#.*)?$", text, re.S)
        if not m:
            raise ValueError(f"config: bad single-quoted scalar {text!r}")
        return _fold(m.group(1).replace("''", "'").split("\n"))
    m = re.match(r'^((?:[^"\\]|\\.|\\\n)*)"\s*(#.*)?$', text, re.S)
    if not m:
        raise ValueError(f"config: bad double-quoted scalar {text!r}")
    # an escaped line break joins the lines without a space
    parts = re.split(r"\\\n[ \t]*", m.group(1))
    folded = [_fold(p.split("\n")) for p in parts]
    return _double("".join(folded))


def read_flat_yaml(text: str) -> Dict[str, Any]:
    """A flat YAML mapping of scalars, as yaml.safe_dump writes one."""
    lines = text.split("\n")
    out: Dict[str, Any] = {}
    i = 0
    while i < len(lines):
        line = lines[i]
        if not line.strip() or line.lstrip().startswith("#"):
            i += 1
            continue
        m = _KEY.match(line)
        if not m:
            raise ValueError(f"config line {i + 1}: not a 'key: scalar' "
                             f"line: {line!r}")
        key, value = m.group(1), (m.group(2) or "").strip()
        cont = []       # continuation lines: indented
        i += 1
        while i < len(lines) and (lines[i][:1] in (" ", "\t")
                                  or not lines[i].strip()):
            cont.append(lines[i])
            i += 1
        while cont and not cont[-1].strip():
            cont.pop()
        if key in out:
            raise ValueError(f"config: duplicate key {key!r}")
        if value[:1] in ("'", '"'):
            out[key] = _quoted([value] + cont, value[0])
            continue
        if not value and cont:
            raise ValueError(f"config: {key} holds a nested block; only "
                             "scalars are read")
        if value[:1] and value[0] in "-?:,[]{}&*!|>%@`" and value not in \
                ("-", ) and not _FLOAT.match(value) and not _INT.match(value):
            raise ValueError(f"config: {key}: unsupported YAML value {value!r}")
        body = [value] + [c for c in cont]
        plain = _fold(body).split(" #")[0].strip()
        if any(c.lstrip().startswith("#") for c in cont):
            raise ValueError(f"config: {key}: comment inside a scalar")
        out[key] = _plain(plain)
    return out
