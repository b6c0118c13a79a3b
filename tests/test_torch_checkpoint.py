"""The port's file formats and small services against their references: the
safetensors reader and writer (against the `safetensors` package and the
JAX package's reader), .ckpt loading, the SD1.5 key universe of the
reference's key lists, the kohya LoRA grammar, config.yaml, wildcards and
the watermark (against the JAX package's)."""
import json
import random
import struct
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from safetensors.torch import save_file as st_save

from cremage_tpu.core.config import Preferences as JPreferences
from cremage_tpu.core.config import save_preferences as j_save_preferences
from cremage_tpu.io.checkpoint import load_state_dict as j_load_state_dict
from cremage_tpu.io.lora import kohya_module_to_flax_path
from cremage_tpu.models.unet import UNetConfig as JUNetConfig
from cremage_tpu.prompt.wildcards import resolve_wildcards as j_wildcards
from cremage_tpu.services import watermark as JW
from cremage_tpu_torch.core.config import load_preferences, read_flat_yaml
from cremage_tpu_torch.io import checkpoint as CK
from cremage_tpu_torch.io.convert import clip_jax_name, normalize_key
from cremage_tpu_torch.io.lora import kohya_module_to_torch_name
from cremage_tpu_torch.io.png import image_to_uint8
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.unet import UNetModel, sd15_unet_config
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.prompt.wildcards import resolve_wildcards
from cremage_tpu_torch.services import watermark as W

KEYLISTS = Path(__file__).resolve().parent / "fixtures" / "keylists"
DTYPES = [torch.float16, torch.bfloat16, torch.float32, torch.float64,
          torch.int64, torch.int32, torch.uint8]


def _tensors(seed):
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, dt in enumerate(DTYPES):
        shape = [(3, 5), (7,), (2, 3, 4), (1,), (4, 1), (0, 3), ()][i]
        base = torch.randn(shape, generator=g) * 50
        out[f"t.{i}.{str(dt)[6:]}"] = base.to(dt)
    out["scalar"] = torch.tensor(2.5)
    return out


def test_safetensors_reader_matches_the_package_and_jax(tmp_path):
    ts = _tensors(0)
    path = str(tmp_path / "a.safetensors")
    st_save(ts, path, metadata={"format": "pt"})
    got = CK.load_safetensors(path)
    assert set(got) == set(ts)
    for k, t in ts.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        assert torch.equal(got[k], t), k
    jax_sd = j_load_state_dict(path)      # the JAX reader (numpy)
    for k, t in ts.items():
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(np.asarray(jax_sd[k], np.float32),
                                          got[k].float().numpy())
        else:
            np.testing.assert_array_equal(jax_sd[k], got[k].numpy())


def test_safetensors_writer_is_read_by_the_package(tmp_path):
    from safetensors import safe_open

    ts = _tensors(1)
    path = str(tmp_path / "b.safetensors")
    CK.save_safetensors(path, ts, metadata={"k": "v"})
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"k": "v"}
        for k, t in ts.items():
            assert torch.equal(f.get_tensor(k), t), k


def _raw(header, data=b""):
    h = json.dumps(header).encode()
    return struct.pack("<Q", len(h)) + h + data


@pytest.mark.parametrize("blob,match", [
    (b"\x01\x02", "shorter than 8"),
    (struct.pack("<Q", 200 * 2**20) + b"{}", "exceeds"),
    (struct.pack("<Q", 50) + b"{}", "past the end"),
    (struct.pack("<Q", 2) + b"[]", "not a JSON object"),
    (struct.pack("<Q", 3) + b"{x}", "unreadable"),
    (_raw({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}}, b"\0" * 4),
     "outside"),
    (_raw({"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, b"\0" * 8),
     "offsets hold 8"),
    (_raw({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
           "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}},
          b"\0" * 12), "overlap"),
    (_raw({"a": {"dtype": "Q8", "shape": [2], "data_offsets": [0, 2]}}, b"\0" * 2),
     "dtype"),
    (_raw({"a": {"dtype": "F32", "shape": [-1], "data_offsets": [0, 4]}}, b"\0" * 4),
     "shape"),
    (_raw({"a": {"dtype": "F32", "shape": [1], "data_offsets": [4, 0]}}, b"\0" * 4),
     "outside"),
    (_raw({"a": {"dtype": "F32", "shape": [1]}}, b"\0" * 4), "bad entry"),
])
def test_safetensors_reader_refuses_malformed_files(tmp_path, blob, match):
    path = tmp_path / "bad.safetensors"
    path.write_bytes(blob)
    with pytest.raises(ValueError, match=match):
        CK.load_safetensors(str(path))


def test_ckpt_loads_through_torch_load(tmp_path):
    ts = {"a.weight": torch.randn(3, 2), "b": torch.arange(4)}
    nested, flat = tmp_path / "n.ckpt", tmp_path / "f.pt"
    torch.save({"state_dict": ts, "global_step": 3, "epoch": 1}, nested)
    torch.save(dict(ts, note="not a tensor"), flat)
    for p in (nested, flat):
        got = CK.load_state_dict(str(p))
        assert set(got) == set(ts) and all(torch.equal(got[k], ts[k]) for k in ts)
        want = j_load_state_dict(str(p))
        assert set(want) == set(got)


def _reference_keys():
    lines = (KEYLISTS / "reference_sd15_weight_list.txt").read_text().splitlines()
    return [ln.strip() for ln in lines if ln.strip() and not ln.startswith("#")
            and "_lora_" not in ln]


def test_reference_sd15_key_list_loads_strict():
    """Every key of a real SD1.5 checkpoint (the reference's list, less its
    LoRA wrapper slots): the model keys load strictly into the port's
    modules at published width (on the meta device: nothing is
    allocated), the schedule buffers are dropped by name."""
    with torch.device("meta"):
        mods = {CK.PREFIX_UNET: UNetModel(sd15_unet_config()),
                CK.PREFIX_VAE: AutoencoderKL(VAEConfig()),
                CK.PREFIX_CLIP_SD15: CLIPTextModel(CLIPTextConfig())}
    shapes = {p + k: v.shape for p, m in mods.items()
              for k, v in m.state_dict().items()}
    keys = _reference_keys()
    assert len(keys) == 1142
    sd = {k: torch.empty(shapes.get(k, (1000,)), device="meta") for k in keys}
    parts = CK.split_sd15(sd)
    assert sum(len(v) for v in parts.values()) == 686 + 248 + 196
    for prefix, m in mods.items():
        CK.load_into(m, parts[prefix], "meta", prefix)
    with pytest.raises(KeyError, match="missing"):
        CK.load_into(mods[CK.PREFIX_UNET],
                     dict(list(parts[CK.PREFIX_UNET].items())[1:]), "meta", "UNet")


def test_reference_lora_modules_all_map_onto_port_modules():
    lines = (KEYLISTS / "reference_sd15_lora_weight_list.txt").read_text().splitlines()
    modules = sorted({ln.strip().rsplit(".", 2)[0] if ln.strip().endswith(
        ".weight") else ln.strip().rsplit(".", 1)[0]
        for ln in lines if ln.strip() and not ln.startswith("#")})
    assert len(modules) == 264
    cfg = sd15_unet_config()
    jcfg = JUNetConfig()
    with torch.device("meta"):
        unet, clip = UNetModel(cfg), CLIPTextModel(CLIPTextConfig())
    names = set()
    for mod in modules:
        which, name = kohya_module_to_torch_name(mod, cfg)
        jwhich, jpath = kohya_module_to_flax_path(mod, jcfg)
        assert which == jwhich
        model = unet if which == "unet" else clip
        layer = model.get_submodule(name)
        assert layer.weight.ndim in (2, 4)
        flat = normalize_key(name)
        assert (flat if which == "unet" else clip_jax_name(flat)) == "_".join(jpath)
        names.add((which, name))
    assert len(names) == 264


def test_preferences_read_a_jax_written_config(tmp_path):
    path = str(tmp_path / "config.yaml")
    prefs = JPreferences(ldm_model="my model: v2.safetensors",
                         embedding_path="it's/#here", safety_check=False,
                         positive_prompt_expansion="x, " * 60)
    j_save_preferences(prefs, path)
    text = Path(path).read_text()
    assert read_flat_yaml(text) == yaml.safe_load(text)
    got = load_preferences(path)
    for f in ("ldm_model_path", "ldm_model", "ldm_inpaint_model",
              "control_model_path", "lora_model_path", "embedding_path"):
        assert getattr(got, f) == getattr(prefs, f), f
    assert got.ldm_model == "my model: v2.safetensors"
    with pytest.raises(FileNotFoundError):
        load_preferences(str(tmp_path / "absent.yaml"))


@pytest.mark.parametrize("text", ["a:\n  b: 1\n", "a: [1, 2]\n", "a: &x 1\n",
                                  "- 1\n", "a: |\n  x\n", "a: !!str 1\n",
                                  "a: {b: 1}\n", "a: 1\na: 2\n"])
def test_yaml_reader_refuses_what_is_not_a_flat_mapping(text):
    with pytest.raises(ValueError):
        read_flat_yaml(text)


def test_yaml_scalars_resolve_as_pyyaml():
    cases = {"a": "x\ty", "b": "l1\nl2", "c": "é 日本", "d": 1.5e-7, "e": -3,
             "f": True, "g": None, "h": "", "i": "yes", "j": "0123",
             "k": float("inf"), "m": "1.0", "n": "it's", "o": "a" * 90 + " b" * 40,
             "p": "\x01c", "q": "  lead", "r": "trail  ", "s": "#x", "t": "a: b",
             "w": "\n\nx\n", "x": "x # y", "y": "null", "z": 0.0, "bb": "2020-01-01",
             "dd": '"q"', "ee": "\\back"}
    for width in (80, 12):
        text = yaml.safe_dump(cases, width=width)
        assert read_flat_yaml(text) == yaml.safe_load(text) == cases
    plain = "a: 0x1F\nb: 0o17\nc: 017\nd: 1_000\ne: .5\nf: ~\ng: Off\nh: 1:30\n"
    assert read_flat_yaml(plain) == yaml.safe_load(plain)


def test_wildcards_resolve_as_jax(tmp_path):
    (tmp_path / "animal.txt").write_text("# pets\ncat\n\ndog __color__\nbird\n")
    (tmp_path / "color.txt").write_text("red\ngreen\n__color__ again\n")
    (tmp_path.parent / "secret.txt").write_text("outside\n")
    for seed in range(12):
        for prompt in ("a __animal__ and __color__, __missing__ __tail",
                       "__animal__" * 3, "plain", "", "__../secret__"):
            want = j_wildcards(prompt, str(tmp_path), rng=seed)
            got = resolve_wildcards(prompt, str(tmp_path), rng=seed)
            if "../" in prompt:   # the port stays inside the directory
                assert got == prompt and want == "outside"
            else:
                assert got == want
    assert resolve_wildcards("__animal__", str(tmp_path),
                             rng=random.Random(3)) == j_wildcards(
        "__animal__", str(tmp_path), rng=random.Random(3))


@pytest.mark.parametrize("shape", [(64, 64, 3), (72, 88, 3), (20, 13, 3)])
def test_watermark_is_bit_identical_to_jax(shape):
    img = np.random.RandomState(shape[0]).rand(*shape).astype(np.float32)
    got, want = W.embed_watermark(img), JW.embed_watermark(img)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(image_to_uint8(got), image_to_uint8(want))
    np.testing.assert_array_equal(got, want)
    u8 = image_to_uint8(img)
    np.testing.assert_array_equal(W.embed_watermark(u8), JW.embed_watermark(u8))
    if shape[0] >= 64:
        assert W.decode_watermark(image_to_uint8(got), 7) == b"Cremage"
        assert W.decode_watermark(image_to_uint8(got), 7) == \
            JW.decode_watermark(image_to_uint8(got), 7)
