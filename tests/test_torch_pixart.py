"""PixArt-Σ: the port's DiT, diffusers key map, loader, pipeline and backend
against the JAX package.

Three tests that loop over their cases, and three parametrised ones (under
`--dist load` the number of collected items sets the suite's wall time,
ROADMAP.md):

- the DiT (cremage_tpu_torch/models/pixart.py) at a head dim that is not a
  multiple of 16 (72, as PixArt-Σ XL's), in float32 and in float8_e4m3
  storage, from a diffusers-layout state dict that the port's
  `pixart_from_diffusers` maps to the same arrays as JAX's; the schedule;
- a diffusers transformer file and a standalone VAE file through JAX's
  `load_pixart_bundle` and the port's, generate() with two samplers
  against the JAX pipeline;
- /v1/generate with "PixArt-Sigma" through `pixart_factory` against JAX's
  factory's arguments, and the refusals (the missing VAE file among
  them);
- the loader arguments `pixart_factory` derives from a job's storage and
  model-file options, against JAX's backend's; the host sincos table at
  PixArt-Σ XL's width on the patch grids users generate at; the keys of a
  diffusers file that `pixart_from_diffusers` refuses; the plain-linear
  betas; the published PixArt-Σ XL config.

Each case states its tolerance.
"""
import base64
import dataclasses
import json
import os
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cremage_tpu.core.config import GenerationOptions as JOptions
from cremage_tpu.core.dtypes import FP32_POLICY
from cremage_tpu.io.diffusers_keys import pixart_from_diffusers as j_from_diffusers
from cremage_tpu.models import pixart as JPIXM
from cremage_tpu.models.pixart import PixArt as JPixArt
from cremage_tpu.models.pixart import PixArtConfig as JPixArtConfig
from cremage_tpu.models.vae import VAEConfig as JVAEConfig
from cremage_tpu.pipelines import loader as JLOADER
from cremage_tpu.pipelines.pixart import PixArtPipeline as JPipeline
from cremage_tpu.pipelines.pixart import pixart_schedule as j_schedule
from cremage_tpu.samplers import schedules as JS
from cremage_tpu_torch.app.backends import ResidentInstance, pixart_factory
from cremage_tpu_torch.app.server import ApiServer
from cremage_tpu_torch.app.worker import EngineWorker
from cremage_tpu_torch.core.config import GenerationOptions, Preferences
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import checkpoint as CK
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io import quantize as Q
from cremage_tpu_torch.io.diffusers_keys import pixart_from_diffusers
from cremage_tpu_torch.io.png import decode_png
from cremage_tpu_torch.models.pixart import (
    PixArt, PixArtConfig, pixart_sigma_xl_config,
)
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.pipelines import loader as LOADER
from cremage_tpu_torch.pipelines import pixart as PX
from cremage_tpu_torch.pipelines.loader import load_pixart_bundle
from cremage_tpu_torch.pipelines.sd3 import check_supported
from cremage_tpu_torch.samplers import schedules as S
from tests.conftest import assert_img01_close
from tests.test_torch_flux import MIN, _codes_equal, _rel, jax_quantize
from tests.test_torch_pipeline import (  # noqa: F401
    cheap_jax, jax_noise, jax_params, shared_template,
)
from tests.test_torch_sd3 import record_loaders

torch.set_num_threads(2)
F32 = torch.float32
# two heads of 72: PixArt-Σ XL's head dim, padded to 80 by the kernel
PX_KW = dict(depth=2, hidden_size=144, num_heads=2, context_dim=48)
# JAX's loader traces its template at T5's 4096 width
FILE_PX = dict(PX_KW, context_dim=4096)
FILE_VAE = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
PX_OPTS = dict(prompt="a red fox", negative_prompt="blurry", H=64, W=64,
               sampling_steps=3, n_samples=2, n_iter=1, seed=5, scale=4.5,
               safety_check=False, watermark=False)


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    """As tests/test_torch_modes.py: clear the worker's compiled programs
    before this module's JAX programs run."""
    jax.clear_caches()
    yield


def diffusers_layout(state: dict) -> dict:
    """The port's PixArt state dict in diffusers' PixArtTransformer2DModel
    layout (q, k and v apart), the inverse of `pixart_from_diffusers`."""
    top = {"x_embedder.proj.": "pos_embed.proj.",
           "t_embedder.mlp.0.": "adaln_single.emb.timestep_embedder.linear_1.",
           "t_embedder.mlp.2.": "adaln_single.emb.timestep_embedder.linear_2.",
           "t_block.1.": "adaln_single.linear.",
           "y_embedder.y_proj.fc1.": "caption_projection.linear_1.",
           "y_embedder.y_proj.fc2.": "caption_projection.linear_2.",
           "final_layer.linear.": "proj_out."}
    block = {"attn.proj.": "attn1.to_out.0.",
             "cross_attn.q_linear.": "attn2.to_q.",
             "cross_attn.proj.": "attn2.to_out.0.",
             "mlp.fc1.": "ff.net.0.proj.", "mlp.fc2.": "ff.net.2."}
    out = {}
    for k, v in state.items():
        if k == "final_layer.scale_shift_table":
            out["scale_shift_table"] = v
        elif k.startswith("blocks."):
            i, rest = k[len("blocks."):].split(".", 1)
            base = f"transformer_blocks.{i}."
            if rest.startswith(("attn.qkv.", "cross_attn.kv_linear.")):
                names = "qkv" if rest.startswith("attn.") else "kv"
                attn = "attn1" if rest.startswith("attn.") else "attn2"
                for c, part in zip(names, v.chunk(len(names), 0)):
                    out[f"{base}{attn}.to_{c}.{rest.rsplit('.', 1)[1]}"] = part
            elif rest == "scale_shift_table":
                out[base + rest] = v
            else:
                a = next(a for a in block if rest.startswith(a))
                out[base + block[a] + rest[len(a):]] = v
        else:
            a = next(a for a in top if k.startswith(a))
            out[top[a] + k[len(a):]] = v
    return out


def test_pixart_and_diffusers_keys_match_jax():
    """The tiny DiT (2 heads of 72, 2 blocks) from a diffusers-layout state
    dict: the port's pixart_from_diffusers gives JAX's arrays, unknown keys
    raise; eps + learned sigma within 1e-4 of its range of JAX's (float32
    sums in another order) in full precision and in float8_e4m3 (the
    port's codes of the JAX weights bit-equal to JAX's); the host sincos
    table equal to JAX's; the plain-linear DDPM schedule's sigmas JAX's."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 12, 4).astype(np.float32)
    t = np.array([750.3, 20.0], np.float32)
    y = rng.randn(2, 9, PX_KW["context_dim"]).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, t, y)]
    jm = JPixArt(JPixArtConfig(**PX_KW, dtype=jnp.float32))
    params = jax_params(jm, 40, jnp.zeros((1, 8, 12, 4)), jnp.zeros((1,)),
                        jnp.zeros((1, 9, PX_KW["context_dim"])))["params"]
    cfg = PixArtConfig(**PX_KW, dtype=F32)
    state = convert.state_dict_from_jax(PixArt(cfg), params)
    diffusers = diffusers_layout(state)
    got_sd = pixart_from_diffusers(diffusers)
    want_sd = j_from_diffusers({k: v.numpy() for k, v in diffusers.items()})
    assert set(got_sd) == set(want_sd) == set(state)
    for k, v in want_sd.items():
        np.testing.assert_array_equal(got_sd[k].numpy(), v, err_msg=k)
    with pytest.raises(KeyError, match="unknown key"):
        pixart_from_diffusers(dict(diffusers, **{
            "transformer_blocks.0.norm1.weight": torch.ones(144)}))

    apply = jax.jit(jm.apply)
    for kind in (None, "float8_e4m3"):
        port = PixArt(cfg)
        port.load_state_dict(got_sd)
        jp = params if kind is None else jax_quantize(params, kind)
        if kind is not None:
            Q.quantize_module(port, kind, min_size=MIN)
            carried = PixArt(cfg)
            Q.prepare_8bit(carried, kind, min_size=MIN)
            _codes_equal(port, convert.load_from_jax(carried, jp))
        want = apply({"params": jp}, *args)
        with torch.no_grad():
            got = port(*[torch.from_numpy(a) for a in (x, t, y)])
        assert got.shape == (2, 8, 12, 8)
        assert _rel(got.numpy(), want) <= 1e-4, kind

    from cremage_tpu_torch.models.pixart import sincos_2d

    np.testing.assert_array_equal(sincos_2d(144, 4, 6),
                                  JPIXM.sincos_2d(144, 4, 6))
    np.testing.assert_array_equal(PX.pixart_schedule().sigmas,
                                  j_schedule().sigmas)


_jax_template = JLOADER._template    # unpatched, whatever a test swaps in


def _files(root, monkeypatch):
    """Both loaders at the tiny configs (JAX's templates memoized), and a
    diffusers transformer file and a standalone VAE file (CompVis layout)
    of seeded random fp16 tensors. -> (paths, {component: tensors})."""
    monkeypatch.setattr(JLOADER, "_template", shared_template(_jax_template))
    monkeypatch.setattr(JPIXM, "pixart_sigma_xl_config",
                        lambda **kw: JPixArtConfig(**FILE_PX, **kw))
    monkeypatch.setattr(JLOADER, "VAEConfig",
                        lambda **kw: JVAEConfig(**FILE_VAE, **kw))
    monkeypatch.setattr(LOADER, "pixart_sigma_xl_config",
                        lambda **kw: PixArtConfig(**FILE_PX, **kw))
    monkeypatch.setattr(LOADER, "VAEConfig",
                        lambda **kw: VAEConfig(**FILE_VAE, **kw))
    gen = torch.Generator().manual_seed(50)

    def rand(module):
        return {k: (v + 0.1 * torch.randn(v.shape, generator=gen)).half()
                for k, v in module.state_dict().items()}

    torch.manual_seed(51)
    truth = dict(dit=rand(PixArt(PixArtConfig(**FILE_PX))),
                 vae=rand(AutoencoderKL(VAEConfig(**FILE_VAE))))
    paths = {"ckpt": str(root / "pixart_sigma.safetensors"),
             "vae": str(root / "vae.safetensors")}
    CK.save_safetensors(paths["ckpt"], diffusers_layout(truth["dit"]))
    CK.save_safetensors(paths["vae"], truth["vae"])
    return paths, truth


def test_files_generate_as_jax(tmp_path, monkeypatch):
    """Both files through the port's loader: every weight equals the
    file's; the VAE at JAX's `VAEConfig()` scale (0.18215), no T5 and a
    caption of 120 zero tokens, as JAX's bundle. generate() against the
    JAX pipeline on its loader's bundle, the port handed JAX's noise:
    "DDIM" (outside the k-diffusion menu: DPM++ 2M over Karras sigmas) and
    "Euler A" (the model's sigmas, a draw each step), images within 2/255,
    JAX's statuses and metadata."""
    paths, truth = _files(tmp_path, monkeypatch)
    tb = load_pixart_bundle(paths["ckpt"], vae_ckpt=paths["vae"],
                            device="cpu", dtype=F32)
    for model, want in ((tb.dit, pixart_from_diffusers(
            diffusers_layout(truth["dit"]))), (tb.vae, truth["vae"])):
        state = model.state_dict()
        assert set(state) == set(want)
        for k, v in want.items():
            assert torch.equal(state[k], v.float()), k
    jb = JLOADER.load_pixart_bundle(paths["ckpt"], vae_ckpt=paths["vae"],
                                    policy=FP32_POLICY)
    assert tb.vae.cfg.scale_factor == jb.vae.cfg.scale_factor == 0.18215
    assert tb.t5 is None and jb.t5 is None and tb.t5_len == jb.t5_len == 120
    pipe = PX.PixArtPipeline(tb, device="cpu")
    assert torch.equal(pipe.encode_text("a fox"), torch.zeros(120, 4096))

    jpipe = JPipeline(jb)
    b, h, w = PX_OPTS["n_samples"], PX_OPTS["H"] // 8, PX_OPTS["W"] // 8
    for sampler in ("DDIM", "Euler A"):
        opts = dict(PX_OPTS, sampler=sampler)
        init, steps = jax_noise(opts["seed"], 0, (b, h, w, 4),
                                opts["sampling_steps"])
        j_msgs, t_msgs = [], []
        ref = jpipe.generate(JOptions(**opts), status_cb=j_msgs.append)
        got = pipe.generate(GenerationOptions(**opts), status_cb=t_msgs.append,
                            noise=lambda seed, dev: ArrayNoise(init, steps))
        assert t_msgs == ["encoding prompt", "1 / 3", "2 / 3", "3 / 3",
                          "decoding"]
        assert sorted(j_msgs) == sorted(t_msgs)
        for (gi, gm), (wi, wm) in zip(got, ref):
            assert_img01_close(gi, wi, float_tol=2 / 255)
            assert gm == wm


def test_http_job_as_jax_pixart_backend(tmp_path, monkeypatch):
    """/v1/generate with "PixArt-Sigma": the port's factory hands its
    loader JAX's backend's arguments and keeps JAX's resident key; the
    served image is the resident pipeline's own for the seed; /v1/meta
    lists the model type. Refused before any load: a job without
    vae_ckpt (JAX would decode with an all-zero VAE), the options the port
    does not run (check_supported, the meshes)."""
    from cremage_tpu.app import backends as JBACKENDS
    from cremage_tpu.app.worker import EngineWorker as JWorker
    from cremage_tpu.core.config import Preferences as JPrefs

    paths, _ = _files(tmp_path, monkeypatch)
    params = dict(PX_OPTS, ckpt=paths["ckpt"], vae_ckpt=paths["vae"],
                  n_samples=1, seed=9, dit_quantize="none")
    with monkeypatch.context() as mp:
        seen = record_loaders(mp, "load_pixart_bundle")
        jw = JWorker()
        JBACKENDS.register_default_backends(jw, JPrefs())
        with pytest.raises(LookupError):
            jw._factories["PixArt-Sigma"]()(dict(params), lambda m: None, None)
        with pytest.raises(LookupError):
            pixart_factory(Preferences(), device="cpu")()(
                dict(params), lambda m: None, None)
    (j_args, j_kw), (t_args, t_kw) = seen["jax"], seen["port"]
    assert t_args == j_args
    assert {k: v for k, v in t_kw.items() if k != "device"} == j_kw

    with pytest.raises(FileNotFoundError, match="vae_ckpt"):
        load_pixart_bundle(paths["ckpt"], device="cpu")
    for bad in (dict(deep_cache=2), dict(ada_cache=0.1), dict(tome_ratio=0.3),
                dict(cfg_interval_low=0.2, cfg_interval_high=0.8)):
        with pytest.raises(NotImplementedError, match="not ported"):
            check_supported(GenerationOptions(**bad))
    pipe = PX.PixArtPipeline.__new__(PX.PixArtPipeline)
    for method in (pipe.use_mesh_sp, pipe.use_mesh_pp):
        with pytest.raises(NotImplementedError, match="not ported"):
            method(None)

    worker, resident = EngineWorker(), ResidentInstance()
    worker.register_backend("PixArt-Sigma", pixart_factory(
        Preferences(), device="cpu", resident=resident))
    srv = ApiServer(worker=worker, port=0, upload_dir=str(tmp_path))
    srv.start()

    def call(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}{path}",
            data=None if body is None else json.dumps(body).encode(),
            method="GET" if body is None else "POST",
            headers={"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    def job(p):
        call("/v1/generate", {"generator_model_type": "PixArt-Sigma",
                              "mode": "text_to_image", "parameters": p})
        msgs = []
        while not any(isinstance(m, dict) and "job_done" in m for m in msgs):
            got = call("/v1/status")["messages"]
            msgs += got
            if not got:     # leave the GIL to the job's thread
                time.sleep(0.02)
        return msgs

    try:
        assert "PixArt-Sigma" in call("/v1/meta")["model_types"]
        for bad, err in ((dict(vae_ckpt=""), "vae_ckpt"),
                         (dict(tome_ratio=0.5), "not ported")):
            done = job(dict(params, **bad))[-1]["job_done"]
            assert not done["ok"] and err in done["error"], done
        assert resident.instance is None     # refused before any load
        msgs = job(params)
        assert msgs[-1] == {"job_done": {"ok": True, "error": None}}, msgs
        imgs = [m for m in msgs if isinstance(m, dict) and "image_b64" in m]
        rgb, _ = decode_png(base64.b64decode(imgs[0]["image_b64"]))
        assert resident.key == ("pixart", paths["ckpt"], paths["vae"], "none")
        want = resident.instance.generate(GenerationOptions.from_dict(params))
        np.testing.assert_array_equal(
            rgb, np.round(want[0][0] * 255).astype(np.uint8))
    finally:
        srv.stop()


# a job's load options -> the same load_pixart_bundle call in both packages
PIXART_LOADS = {
    "float8-dit": dict(dit_quantize="float8_e4m3"),
    "int8-dit": dict(dit_quantize="int8"),
    "model-from-preferences": dict(ckpt="", dit_quantize=""),
}


@pytest.mark.parametrize("case", PIXART_LOADS)
def test_pixart_factory_loads_as_jax(case, tmp_path, monkeypatch):
    """What `pixart_factory` hands `load_pixart_bundle` for a job's DiT
    storage, and for a job that names no transformer file (the
    preferences' pixart_sigma_ldm_model under pixart_sigma_ldm_model_path):
    the same arguments as JAX's backend, the job's vae_ckpt and storage
    kind passed on ("" as None), nothing loaded."""
    from cremage_tpu.app import backends as JBACKENDS
    from cremage_tpu.app.worker import EngineWorker as JWorker
    from cremage_tpu.core.config import Preferences as JPrefs

    names = dict(pixart_sigma_ldm_model_path=str(tmp_path),
                 pixart_sigma_ldm_model="pixart_sigma_xl.safetensors")
    params = {**PX_OPTS, "ckpt": str(tmp_path / "job.safetensors"),
              "vae_ckpt": str(tmp_path / "vae.safetensors"),
              **PIXART_LOADS[case]}
    seen = record_loaders(monkeypatch, "load_pixart_bundle")
    jw = JWorker()
    JBACKENDS.register_default_backends(jw, JPrefs(**names))
    with pytest.raises(LookupError):
        jw._factories["PixArt-Sigma"]()(dict(params), lambda m: None, None)
    with pytest.raises(LookupError):
        pixart_factory(Preferences(**names), device="cpu")()(
            dict(params), lambda m: None, None)
    (j_args, j_kw), (t_args, t_kw) = seen["jax"], seen["port"]
    ckpt = params["ckpt"] or os.path.join(str(tmp_path),
                                          names["pixart_sigma_ldm_model"])
    assert t_args == j_args == (ckpt,)
    assert {k: v for k, v in t_kw.items() if k != "device"} == j_kw
    assert (t_kw["vae_ckpt"], t_kw["quantize_dit"]) == (
        params["vae_ckpt"], params["dit_quantize"] or None)


@pytest.mark.parametrize("dim,h,w", [(1152, 64, 64), (1152, 48, 80),
                                     (1152, 32, 32), (72, 3, 5)],
                         ids=["1024x1024", "768x1280", "512x512", "odd-grid"])
def test_sincos_table_matches_jax(dim, h, w):
    """The host sincos position table at PixArt-Σ XL's width (1152) on the
    2x2-patch grids of 1024², 768x1280 and 512² latents, and at a small
    odd grid: float32 of (h * w, dim), equal to JAX's."""
    from cremage_tpu_torch.models.pixart import sincos_2d

    got = sincos_2d(dim, h, w)
    assert got.shape == (h * w, dim) and got.dtype == np.float32
    np.testing.assert_array_equal(got, JPIXM.sincos_2d(dim, h, w))


def _tiny_diffusers_file() -> dict:
    with torch.random.fork_rng():
        torch.manual_seed(52)
        return diffusers_layout(PixArt(PixArtConfig(**PX_KW)).state_dict())


# a change to a diffusers transformer file -> the KeyError it raises
PIXART_STRAY = {
    "fixed-pos-table": (dict(add="pos_embed.pos_embed"), "unknown key"),
    "alpha-resolution-embedder": (
        dict(add="adaln_single.emb.resolution_embedder.linear_1.weight"),
        "unknown key"),
    "split-qkv-incomplete": (
        dict(drop="transformer_blocks.1.attn1.to_v.weight"), "lacks"),
}


@pytest.mark.parametrize("case", PIXART_STRAY)
def test_pixart_from_diffusers_refuses(case):
    """`pixart_from_diffusers` raises KeyError, naming the key, on a stored
    position table (the port builds it on the host), on PixArt-α's
    resolution embedder (Σ has none) and on a self-attention missing one
    of q, k and v; the file itself maps."""
    diffusers = _tiny_diffusers_file()
    assert set(pixart_from_diffusers(diffusers)) == set(
        PixArt(PixArtConfig(**PX_KW)).state_dict())
    change, err = PIXART_STRAY[case]
    if "add" in change:
        diffusers[change["add"]] = torch.zeros(3)
        named = change["add"]
    else:
        diffusers.pop(change["drop"])
        named = "blocks.1.attn.qkv.weight"
    with pytest.raises(KeyError, match=err) as raised:
        pixart_from_diffusers(diffusers)
    assert named in str(raised.value)


@pytest.mark.parametrize("n,start,end", [(1000, 0.0001, 0.02),
                                         (1000, 0.00085, 0.012),
                                         (500, 0.0001, 0.02)],
                         ids=["pixart", "sd-range", "500-steps"])
def test_plain_linear_betas_match_jax(n, start, end):
    """`make_betas_plain_linear` (diffusers' "linear", PixArt's schedule)
    and the alphas_cumprod built on it equal JAX's, in float64, at
    PixArt's range, at SD's range and over 500 steps."""
    got = S.make_betas_plain_linear(n, start, end)
    want = JS.make_betas_plain_linear(n, start, end)
    assert got.dtype == np.float64 and got.shape == (n,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(S.alphas_cumprod_from_betas(got),
                                  JS.alphas_cumprod_from_betas(want))


def test_pixart_config_matches_jax():
    """`pixart_sigma_xl_config` is JAX's field for field (28 blocks of
    1152, 16 heads of 72, 2x2 patches of 4 channels out to 8 for eps and
    the learned sigma, T5's 4096-wide caption); JAX's only other fields
    are its parameter dtype and the sequence-parallel and ToMe options
    the port refuses."""
    j, p = JPIXM.pixart_sigma_xl_config(), pixart_sigma_xl_config()
    names = {f.name for f in dataclasses.fields(p)} - {"dtype"}
    assert {f.name for f in dataclasses.fields(j)} - names == {
        "dtype", "param_dtype", "sp_axis", "tome_ratio"}
    assert {n: getattr(p, n) for n in names} == {n: getattr(j, n)
                                                 for n in names}
    assert (p.depth, p.hidden_size // p.num_heads) == (28, 72)
