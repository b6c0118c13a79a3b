"""SVD img2vid: the port's ViT-H tower, video UNet, INTER_AREA resize,
loader, pipeline and HTTP job against the JAX package's, on the tiny
video UNet of tests/test_svd.py (3 frames, 8x8 latents), a 2-layer ViT at
28^2 and the tiny VAE, all float32 on the CPU.

Tolerances:
- the models: 1e-5 of the output's range (float32 summation order);
- the resize: 1e-6 of cv2's [0, 1] output (float32 weights summed in
  another order);
- frames: one uint8 step plus 2/255, as
  tests/test_torch_pipeline.py::test_txt2img_matches_jax (both round the
  latent to bf16 before the decode);
- weights loaded from a file: equal; 8-bit codes and scales: bit-equal to
  JAX's quantization of the same file.

The JAX references run jitted under `cheap_jax_references` (an eager
video UNet costs 3-4x more); each test builds what it needs itself, as
`--dist load` spreads one module's tests over the workers.
"""
import base64
import dataclasses
import functools
import json
import os
import time
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cremage_tpu.app import backends as JBACKENDS
from cremage_tpu.core.config import Preferences as JPrefs
from cremage_tpu.core.dtypes import FP32_POLICY
from cremage_tpu.core.rng import key_for_image
from cremage_tpu.models import clip_vision as JCVM
from cremage_tpu.models import video_unet as JVUM
from cremage_tpu.models.clip_vision import CLIPVisionConfig as JCVConfig
from cremage_tpu.models.clip_vision import CLIPVisionModel as JCV
from cremage_tpu.models.unet import UNetConfig as JUNetConfig
from cremage_tpu.models.vae import AutoencoderKL as JVAE
from cremage_tpu.models.vae import VAEConfig as JVAEConfig
from cremage_tpu.pipelines import loader as JLOADER
from cremage_tpu.pipelines import svd as JSVD
from cremage_tpu_torch.app.backends import ResidentInstance, svd_factory
from cremage_tpu_torch.app.server import ApiServer
from cremage_tpu_torch.app.worker import EngineWorker
from cremage_tpu_torch.core.config import Preferences
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import checkpoint as CK
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io import quantize as Q
from cremage_tpu_torch.io.png import decode_png, encode_png, read_png
from cremage_tpu_torch.models.clip_vision import CLIPVisionConfig, CLIPVisionModel
from cremage_tpu_torch.models.unet import UNetConfig
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.models.video_unet import AlphaBlender, VideoUNet
from cremage_tpu_torch.pipelines import loader as LOADER
from cremage_tpu_torch.pipelines import svd as SVD
from cremage_tpu_torch.pipelines.loader import load_svd_bundle
from cremage_tpu_torch.utils.resize import resize_area
from tests.conftest import assert_img01_close
from tests.test_svd import CTX, T, tiny_video_cfg
from tests.test_torch_pipeline import (  # noqa: F401
    cheap_jax, jax_params, shared_template,
)

torch.set_num_threads(2)
F32 = torch.float32
UNET_KW = {f.name: getattr(tiny_video_cfg(), f.name)
           for f in dataclasses.fields(UNetConfig) if f.name != "dtype"}
VAE_KW = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
# width != output_dim: JAX's loader transposes a square `proj`
VIT_KW = dict(image_size=28, patch_size=14, width=48, num_layers=2,
              num_heads=4, output_dim=CTX)
UNET_ARGS = (jnp.zeros((T, 8, 8, 8)), jnp.zeros((T,)), jnp.zeros((T, 1, CTX)),
             jnp.zeros((T, 768)))
RES, STEPS, SEED = 64, 2, 5
VISUAL = CK.PREFIX_VISUAL_SVD
# keys of a published file that no model of the pipeline reads, one or
# two of each dropped family
DROPPED = ("first_stage_model.decoder.mid.block_1.time_stack.in_layers.0.weight",
           "first_stage_model.decoder.mid.block_1.mix_factor",
           "first_stage_model.decoder.conv_out.time_mix_conv.weight",
           "conditioner.embedders.0.open_clip.model.token_embedding.weight",
           "conditioner.embedders.0.open_clip.model.logit_scale",
           "conditioner.embedders.3.encoder.encoder.conv_in.weight")
_jax_template = JLOADER._template


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=rel * float(np.abs(want).max()))


def _jax_models():
    """The tiny JAX video UNet, VAE and ViT with seeded parameters."""
    unet = JVUM.VideoUNet(tiny_video_cfg(), num_frames=T)
    vae = JVAE(JVAEConfig(**VAE_KW, dtype=jnp.float32))
    vit = JCV(JCVConfig(**VIT_KW, dtype=jnp.float32))
    return ((unet, jax_params(unet, 31, *UNET_ARGS)),
            (vae, jax_params(vae, 32, jnp.zeros((1, 64, 64, 3)))),
            (vit, jax_params(vit, 33, jnp.zeros((1, 28, 28, 3)))))


def _port_models(params):
    (_, up), (_, vp), (_, cp) = params
    return (convert.load_from_jax(VideoUNet(UNetConfig(**UNET_KW, dtype=F32),
                                            num_frames=T), up["params"]),
            convert.load_vae(AutoencoderKL(VAEConfig(**VAE_KW, dtype=F32)),
                             vp["params"]),
            convert.load_from_jax(CLIPVisionModel(
                CLIPVisionConfig(**VIT_KW, dtype=F32)), cp["params"]))


def test_models_and_area_resize_match_jax():
    """ViT-H's module at tiny width,
    the video UNet, the AlphaBlender with and without the image_only
    override, and INTER_AREA against cv2 at SVD's 576x1024 -> 224^2 and
    two odd sizes (one of them growing an axis)."""
    rng = np.random.RandomState(0)
    for (hw, size) in (((576, 1024), (224, 224)), ((61, 97), (23, 31)),
                       ((300, 200), (224, 224))):
        img = rng.uniform(0, 1, hw + (3,)).astype(np.float32)
        want = cv2.resize(img, size[::-1], interpolation=cv2.INTER_AREA)
        got = resize_area(torch.from_numpy(img)[None], size)[0].numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)

    params = _jax_models()
    (ju, up), _, (jv, cp) = params
    tu, _, tv = _port_models(params)
    imgs = rng.uniform(0, 1, (2, 28, 28, 3)).astype(np.float32)
    with torch.no_grad():
        _close(tv(torch.from_numpy(imgs)), jax.jit(jv.apply)(cp, imgs))

    x = rng.randn(T, 8, 8, 8).astype(np.float32)
    ts = np.full((T,), 0.25 * np.log(3.0), np.float32)
    ctx = rng.randn(T, 1, CTX).astype(np.float32)
    y = rng.randn(T, 768).astype(np.float32)
    want = jax.jit(ju.apply)(up, x, ts, ctx, y)
    with torch.no_grad():
        got = tu(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(ts),
                 torch.from_numpy(ctx), torch.from_numpy(y))
    _close(got.permute(0, 2, 3, 1), want)

    jab = JVUM.AlphaBlender()
    xs, xt = rng.randn(2, 1, T, 4, 4, 3).astype(np.float32)
    mix = {"params": {"mix_factor": np.array([0.3], np.float32)}}
    tab = AlphaBlender()
    tab.mix_factor.data[:] = 0.3
    only = np.array([[True, False, True]])
    for image_only in (None, only):
        want = jab.apply(mix, xs, xt, image_only)
        got = tab(torch.from_numpy(xs.reshape(T, 4, 4, 3)),
                  torch.from_numpy(xt.reshape(T, 4, 4, 3)),
                  None if image_only is None else torch.from_numpy(image_only))
        _close(got.detach().reshape(xs.shape), want)


def _tiny_loaders(mp):
    """Both loaders at the tiny configs (JAX's through its config
    functions and its templates' input shapes, the port's through its
    config functions), as tests/test_torch_sdxl_loader.py does."""
    mp.setattr(JVUM, "svd_unet_config",
               lambda **kw: JUNetConfig(**UNET_KW, **kw))
    mp.setattr(JCVM, "vit_h14_config", lambda **kw: JCVConfig(**VIT_KW, **kw))
    mp.setattr(JLOADER, "VAEConfig", lambda **kw: JVAEConfig(**VAE_KW, **kw))
    tiny = {(T, 1, 1024): (T, 1, CTX), (1, 224, 224, 3): (1, 28, 28, 3)}
    memo = shared_template(_jax_template)
    mp.setattr(JLOADER, "_template", lambda model, *args: memo(
        model, *[jnp.zeros(tiny[a.shape], a.dtype) if a.shape in tiny else a
                 for a in args]))
    mp.setattr(LOADER, "svd_unet_config", lambda: UNetConfig(**UNET_KW))
    mp.setattr(LOADER, "VAEConfig", lambda **kw: VAEConfig(**VAE_KW, **kw))
    mp.setattr(LOADER, "vit_h14_config",
               lambda **kw: CLIPVisionConfig(**VIT_KW, **kw))


def _fused(sd):
    """A visual tower's split q/k/v keys fused into attn.in_proj_*, as
    open_clip publishes them."""
    out = {}
    for k, v in sd.items():
        if ".attn.q_proj." in k:
            base, kind = k.split(".attn.q_proj.")
            out[f"{base}.attn.in_proj_{kind}"] = torch.cat(
                [sd[f"{base}.attn.{n}_proj.{kind}"] for n in "qkv"])
        elif not (".attn.k_proj." in k or ".attn.v_proj." in k):
            out[k] = v
    return out


def _jax_layout(sd):
    """The temporal convolutions' OIDHW weights as DHWIO: JAX's loader has
    no 5-D transpose (cremage_tpu/io/checkpoint.py `convert_tensor`), so
    it reads only this layout."""
    return {k: v.permute(2, 3, 4, 1, 0).contiguous() if v.ndim == 5 else v
            for k, v in sd.items()}


def _write_files(tmp_path, models):
    """The tiny models' weights as SVD files, each with samples of the
    dropped key families: `published` as sgm and open_clip save them (the
    temporal convolutions OIDHW, the visual tower's q/k/v fused),
    `no_vit` the same without the tower, and `jax` and `jax_no_vit` in
    the one layout JAX's loader reads (DHWIO, q/k/v apart: ROADMAP.md
    Queue 3). -> (paths, the
    port's state dicts by prefix)."""
    tu, tvae, tv = models
    parts = {CK.PREFIX_UNET: tu.state_dict(), CK.PREFIX_VAE: tvae.state_dict(),
             VISUAL: tv.state_dict()}
    gen = torch.Generator().manual_seed(0)
    extra = {k: torch.randn(4, 2, generator=gen) for k in DROPPED}
    vae = {CK.PREFIX_VAE + k: v for k, v in parts[CK.PREFIX_VAE].items()}
    unet = {CK.PREFIX_UNET + k: v for k, v in parts[CK.PREFIX_UNET].items()}
    files = {"published": {**unet, **vae, **extra, **{
                 VISUAL + k: v for k, v in _fused(parts[VISUAL]).items()}},
             "no_vit": {**unet, **vae, **extra},
             "jax_no_vit": {**_jax_layout(unet), **vae, **extra}}
    files["jax"] = {**files["jax_no_vit"],
                    **{VISUAL + k: v for k, v in parts[VISUAL].items()}}
    paths = {}
    for name, sd in files.items():
        paths[name] = str(tmp_path / f"svd_{name}.safetensors")
        CK.save_safetensors(paths[name], sd)
    return paths, parts


def _jax_noise(seed):
    """The latent and conditioning-frame noise JAX's sample draws."""
    key = key_for_image(seed)
    return ArrayNoise(
        np.asarray(jax.random.normal(key, (T, 8, 8, 4), jnp.float32)),
        cond_aug=np.asarray(jax.random.normal(
            jax.random.fold_in(key, 3), (1, RES, RES, 3), jnp.float32)))


def _jax_statuses(msgs):
    """JAX's statuses with its "decoding frames" last: its step statuses
    come from io_callbacks that can reach the host after it (as in
    tests/test_torch_pipeline.py::test_txt2img_matches_jax)."""
    return ([m for m in msgs if m != "decoding frames"]
            + [m for m in msgs if m == "decoding frames"])


def test_sample_matches_jax(tmp_path):
    """SVDPipeline.sample on the same weights (the image tower's included),
    the port handed JAX's noise: frames, statuses and the frame PNGs as
    JAX's."""
    params = _jax_models()
    (ju, up), (jv, vp), (jc, cp) = params
    tu, tvae, tv = _port_models(params)
    jb = JSVD.SVDBundle(unet=ju, unet_params=up, vae=jv, vae_params=vp,
                        clip_vision=(jc, cp))
    tb = SVD.SVDBundle(unet=tu, vae=tvae, clip_vision=tv)
    rng = np.random.RandomState(1)
    img01 = np.round(rng.uniform(0, 1, (RES, RES, 3)) * 255).astype(
        np.float32) / 255
    opts = dict(num_frames=T, num_steps=STEPS, seed=SEED, cond_aug=0.05)
    j_msgs, t_msgs = [], []
    want = JSVD.SVDPipeline(jb).sample(
        img01, JSVD.SVDOptions(**opts), status_cb=j_msgs.append,
        output_dir=str(tmp_path / "jax"))
    got = SVD.SVDPipeline(tb, device="cpu").sample(
        img01, SVD.SVDOptions(**opts), status_cb=t_msgs.append,
        output_dir=str(tmp_path / "port"),
        noise=lambda seed, device: _jax_noise(seed))
    assert got.shape == want.shape == (T, RES, RES, 3)
    for g, w in zip(got, want):
        assert_img01_close(g, w, float_tol=2.0 / 255.0)
    assert t_msgs == _jax_statuses(j_msgs)
    for i in range(T):
        name = f"frame_{i:05}.png"
        np.testing.assert_array_equal(
            read_png(str(tmp_path / "port" / name)), np.round(got[i] * 255))
        assert (tmp_path / "jax" / name).exists()


def test_loader_layouts_8bit_storage_and_refusals(tmp_path, monkeypatch):
    """The published file through the port's load_svd_bundle and its copy
    in JAX's layout through JAX's: equal weights (the ViT's fused in_proj
    split into the port's q/k/v), no tower without its keys; a key of no
    family raises, the dropped ones do not. float8_e4m3 storage of the
    video UNet: codes and
    scales bit-equal to JAX's load_svd_bundle with the same kind on the
    file's copy in its layout (its quantize_min_size and the port's
    min_size lowered to reach the tiny weights); float8_e5m2: io/quantize.py's
    codes of the file's tensors (tests/test_torch_flux.py holds both
    kinds' codes to JAX's). Refused as not
    ported: int8 storage, deep_cache, tome_ratio, ada_cache, the
    pipeline-parallel mesh, FILM and the mp4 writer; JAX's errors for a
    job without init_img or ckpt and for tome_ratio out of range."""
    _tiny_loaders(monkeypatch)
    with torch.random.fork_rng():
        torch.manual_seed(2)
        models = (VideoUNet(UNetConfig(**UNET_KW, dtype=F32), num_frames=T),
                  AutoencoderKL(VAEConfig(**VAE_KW, dtype=F32)),
                  CLIPVisionModel(CLIPVisionConfig(**VIT_KW, dtype=F32)))
    paths, parts = _write_files(tmp_path, models)
    tb = load_svd_bundle(paths["published"], num_frames=T, device="cpu",
                         dtype=F32)
    jb = JLOADER.load_svd_bundle(paths["jax"], num_frames=T,
                                 policy=FP32_POLICY)
    for module, tree, prefix in (
            (tb.unet, jb.unet_params, CK.PREFIX_UNET),
            (tb.vae, jb.vae_params, CK.PREFIX_VAE),
            (tb.clip_vision, jb.clip_vision[1], VISUAL)):
        want = convert.state_dict_from_jax(module, tree["params"])
        for k, v in module.state_dict().items():
            assert torch.equal(v, parts[prefix][k]) and torch.equal(
                v, want[k]), k
    assert load_svd_bundle(paths["no_vit"], num_frames=T, device="cpu",
                           dtype=F32).clip_vision is None
    assert JLOADER.load_svd_bundle(paths["jax_no_vit"], num_frames=T,
                                   policy=FP32_POLICY).clip_vision is None
    sd = CK.load_state_dict(paths["published"])
    assert all(k not in CK.split_svd(sd)[CK.PREFIX_VAE] for k in DROPPED)
    with pytest.raises(KeyError, match="belong to no SVD component"):
        CK.split_svd({**sd, "denoiser.sigmas": torch.zeros(3)})

    size = 1024
    for kind in ("float8_e4m3", "float8_e5m2"):
        with monkeypatch.context() as mp:
            mp.setattr(LOADER, "prepare_8bit", functools.partial(
                Q.prepare_8bit, min_size=size))
            tb = load_svd_bundle(paths["published"], num_frames=T,
                                 quantize_unet=kind, device="cpu", dtype=F32)
        coded = Q.coded_weights(tb.unet.state_dict())
        assert coded and tb.load_report["quantize"]["video UNet"]["tensors"] \
            == len(coded)
        if kind == "float8_e4m3":      # JAX quantizes eagerly: one kind
            jb = JLOADER.load_svd_bundle(paths["jax"], num_frames=T,
                                         policy=FP32_POLICY, quantize_unet=kind,
                                         quantize_min_size=size)
            want = convert.state_dict_from_jax(tb.unet,
                                               jb.unet_params["params"])
        else:
            want = dict(parts[CK.PREFIX_UNET])
            for k in coded:
                want[k], want[coded[k]] = Q.quantize_weight(want[k], kind)
        for k, v in tb.unet.state_dict().items():
            assert v.dtype == want[k].dtype and torch.equal(
                v.view(torch.uint8) if Q.is_coded(v) else v,
                want[k].view(torch.uint8) if Q.is_coded(v) else want[k]), k

    with pytest.raises(NotImplementedError, match="int8"):
        load_svd_bundle(paths["published"], num_frames=T, quantize_unet="int8",
                        device="cpu")
    bundle = SVD.SVDBundle(unet=VideoUNet(UNetConfig(**UNET_KW, dtype=F32),
                                          num_frames=T),
                           vae=AutoencoderKL(VAEConfig(**VAE_KW, dtype=F32)))
    pipe = SVD.SVDPipeline(bundle, device="cpu")
    img = np.zeros((RES, RES, 3), np.float32)
    for bad in (dict(deep_cache=2), dict(tome_ratio=0.3), dict(ada_cache=0.1)):
        with pytest.raises(NotImplementedError):
            pipe.sample(img, SVD.SVDOptions(num_frames=T, **bad))
    with pytest.raises(ValueError, match="tome_ratio"):
        pipe.sample(img, SVD.SVDOptions(num_frames=T, tome_ratio=0.9))
    with pytest.raises(NotImplementedError):
        pipe.use_mesh_pp([0, 1])

    init = tmp_path / "init.png"
    init.write_bytes(encode_png(np.zeros((RES, RES, 3), np.uint8)))
    gen = svd_factory(Preferences(), device="cpu")()
    job = {"init_img": str(init), "ckpt": paths["published"]}
    for bad, err in ((dict(interpolation_frames=1), NotImplementedError),
                     (dict(interpolation_frames=2, make_mp4=True),
                      NotImplementedError),
                     (dict(unet_quantize="int8"), NotImplementedError),
                     (dict(deep_cache=3), NotImplementedError),
                     (dict(init_img=str(tmp_path / "none.png")),
                      FileNotFoundError),
                     (dict(ckpt=None), FileNotFoundError)):
        with pytest.raises(err):
            gen({k: v for k, v in dict(job, **bad).items() if v is not None},
                lambda m: None, lambda f, m: None)
    assert gen.resident.instance is None


def test_http_job_as_jax_svd_factory(tmp_path, monkeypatch):
    """/v1/generate with "SVD" through svd_factory (the port's loader on
    the published file) against JAX's svd_factory on the same job, its
    loader and pipeline recorded by stubs: the same loader arguments,
    options and input image ((init + 1) / 2 of the PNG), the port's
    resident key equal to JAX's; each served frame is the port pipeline's
    own frame for the job (test_sample_matches_jax holds those to
    JAX's) with JAX's generation parameters ({"frame": i, **the job's
    scalars}) and the mode and model type the server mirrors in. The job
    sets make_mp4 and output_mp4 at 0 FILM passes, which JAX ignores."""
    _tiny_loaders(monkeypatch)
    with torch.random.fork_rng():
        torch.manual_seed(3)
        models = (VideoUNet(UNetConfig(**UNET_KW, dtype=F32), num_frames=T),
                  AutoencoderKL(VAEConfig(**VAE_KW, dtype=F32)),
                  CLIPVisionModel(CLIPVisionConfig(**VIT_KW, dtype=F32)))
    paths, _ = _write_files(tmp_path, models)
    init = tmp_path / "init.png"
    rgb = np.random.RandomState(4).randint(0, 256, (RES, RES, 3), np.uint8)
    init.write_bytes(encode_png(rgb))
    # make_mp4 and output_mp4 act only after FILM passes in JAX: with
    # interpolation_frames 0 both backends serve the frames
    job = {"init_img": str(init), "ckpt": paths["published"], "num_frames": T,
           "sampling_steps": STEPS, "seed": SEED, "cond_aug": 0.05,
           "fps_id": 5, "motion_bucket_id": 100, "outdir": str(tmp_path),
           "interpolation_frames": 0, "make_mp4": True,
           "output_mp4": str(tmp_path / "v.mp4")}
    seen = {}

    class Stub:
        def __init__(self, bundle):
            pass

        def sample(self, image01, opts, status_cb, output_dir):
            seen["jax_sample"] = (image01, opts, output_dir)
            return np.zeros((T, RES, RES, 3), np.float32)

    monkeypatch.setattr(JLOADER, "load_svd_bundle", lambda *a, **kw: (
        seen.setdefault("jax", (a, kw)), None)[1])
    monkeypatch.setattr(JSVD, "SVDPipeline", Stub)
    j_meta = []
    JBACKENDS.svd_factory(JPrefs())(dict(job), lambda m: None,
                                    lambda f, meta: j_meta.append(meta))
    load = LOADER.load_svd_bundle
    monkeypatch.setattr(LOADER, "load_svd_bundle", lambda *a, **kw: (
        seen.setdefault("port", (a, kw)), load(*a, dtype=F32, **kw))[1])
    samples = []
    sample = SVD.SVDPipeline.sample
    monkeypatch.setattr(SVD.SVDPipeline, "sample", lambda self, *a, **kw: (
        samples.append((self, a, kw)), sample(self, *a, **kw))[1])

    worker, resident = EngineWorker(), ResidentInstance()
    worker.register_backend("SVD", svd_factory(Preferences(), device="cpu",
                                               resident=resident))
    srv = ApiServer(worker=worker, port=0)
    srv.start()

    def call(path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}{path}",
            data=None if body is None else json.dumps(body).encode(),
            method="GET" if body is None else "POST",
            headers={"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    try:
        assert "SVD" in call("/v1/meta")["model_types"]
        call("/v1/generate", {"generator_model_type": "SVD",
                              "mode": "image_to_video", "parameters": job})
        msgs = []
        while not any(isinstance(m, dict) and "job_done" in m for m in msgs):
            got = call("/v1/status")["messages"]
            msgs += got
            if not got:     # leave the GIL to the job's thread
                time.sleep(0.02)
    finally:
        srv.stop()
    assert msgs[-1]["job_done"]["ok"], msgs[-1]
    assert [m for m in msgs if isinstance(m, str)][:2] == ["conditioning",
                                                           "sampling"]
    (j_args, j_kw), (t_args, t_kw) = seen["jax"], seen["port"]
    assert t_args == j_args
    assert {k: v for k, v in t_kw.items() if k != "device"} == j_kw
    assert resident.key == ("svd", paths["published"], T, None)
    j_img, j_opts, j_dir = seen["jax_sample"]
    pipe, (t_img, t_opts), t_kw = samples[0]
    np.testing.assert_array_equal(t_img, j_img)
    assert dataclasses.asdict(t_opts) == dataclasses.asdict(j_opts)
    assert t_kw["output_dir"] == j_dir
    want = pipe.sample(t_img, t_opts)
    frames = [m for m in msgs if isinstance(m, dict) and "image_b64" in m]
    assert len(frames) == len(j_meta) == T
    for i, (m, jm) in enumerate(zip(frames, j_meta)):
        rgb, _ = decode_png(base64.b64decode(m["image_b64"]))
        np.testing.assert_array_equal(rgb, np.round(want[i] * 255))
        assert json.loads(m["generation_parameters"]) == {
            **jm, "mode": "image_to_video", "generator_model_type": "SVD"}


# a job's FILM and model-file options -> the same load_svd_bundle call in
# both packages, or the port's refusal before any load
SVD_JOBS = {
    "make-mp4-without-film": dict(make_mp4=True),
    "output-mp4-without-film": dict(output_mp4="v.mp4"),
    "model-from-preferences": dict(ckpt="", svd_model="svd_xt.safetensors"),
    "film-passes-refused": dict(interpolation_frames=2, make_mp4=True),
}


@pytest.mark.parametrize("case", SVD_JOBS)
def test_svd_factory_loads_as_jax(case, tmp_path, monkeypatch):
    """svd_factory against JAX's on a job's FILM and model-file options,
    both loaders recorded (nothing loaded): at 0 FILM passes make_mp4 and
    output_mp4 change nothing, and both load the same file with the same
    arguments (svd_model under the preferences' svd_model_path when the
    job names no ckpt); FILM passes raise NotImplementedError before any
    load, where JAX loads and interpolates."""
    from tests.test_torch_sd3 import record_loaders

    init = tmp_path / "init.png"
    init.write_bytes(encode_png(np.zeros((RES, RES, 3), np.uint8)))
    job = {"init_img": str(init), "ckpt": str(tmp_path / "svd.safetensors"),
           "num_frames": T, **SVD_JOBS[case]}
    seen = record_loaders(monkeypatch, "load_svd_bundle")
    with pytest.raises(LookupError):
        JBACKENDS.svd_factory(JPrefs(svd_model_path=str(tmp_path)))(
            dict(job), lambda m: None, None)
    port = svd_factory(Preferences(svd_model_path=str(tmp_path)),
                       device="cpu")()
    if job.get("interpolation_frames"):
        with pytest.raises(NotImplementedError, match="interpolation_frames 2"):
            port(dict(job), lambda m: None, None)
        assert "port" not in seen
        return
    with pytest.raises(LookupError):
        port(dict(job), lambda m: None, None)
    (j_args, j_kw), (t_args, t_kw) = seen["jax"], seen["port"]
    ckpt = job["ckpt"] or os.path.join(str(tmp_path), job["svd_model"])
    assert t_args == j_args == (ckpt,)
    assert {k: v for k, v in t_kw.items() if k != "device"} == j_kw
