"""SDXL as users run it: the refiner, inpainting (the 9-channel model and
the base model) and LCM, the port against the JAX package on the tiny
configs of tests/test_torch_sdxl.py.

Files are written from seeded random weights in the published layouts: a
refiner in sd_xl_refiner_1.0's (`model.diffusion_model.`, bigG under
`conditioner.embedders.0.model.` with the fused attn.in_proj and
logit_scale, its own VAE under `first_stage_model.`, which the pipeline
never reads, and `denoiser.sigmas`) and a 9-channel inpainting model in
the base model's sgm layout, beside tests/test_torch_sdxl_loader.py's base
model, LoRA and TI file. JAX's load_sdxl_bundle reads them with its
configs swapped for the tiny ones; the port's weights must equal its (the
LoRA, merged into the base model only, leaves the refiner as its file
holds it). generate() must then agree within the 3/255 of
tests/test_torch_sdxl_loader.py (one uint8 step plus 2/255 for the bf16
rounding of the latent before the decode), the port handed the noise the
JAX pipeline draws (the refiner's from fold_in(key, 99)). The refiner's
conditioner is held to 2e-5, as the base conditioner is.
"""
import base64
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.torch import save_file

from cremage_tpu.core.config import GenerationOptions as JOptions
from cremage_tpu.core.rng import key_for_image
from cremage_tpu.models.open_clip import OpenCLIPTextConfig as JOCConfig
from cremage_tpu.models.open_clip import OpenCLIPTextModel as JOC
from cremage_tpu.pipelines.sdxl import SDXLConditioner as JConditioner
from cremage_tpu.pipelines.sdxl import SDXLPipeline as JPipeline
from cremage_tpu.prompt.tokenizer import default_tokenizer as j_tokenizer
from cremage_tpu_torch.app.backends import ResidentInstance, sdxl_factory
from cremage_tpu_torch.app.server import ApiServer
from cremage_tpu_torch.app.worker import EngineWorker
from cremage_tpu_torch.core.config import GenerationOptions, Preferences
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io.png import decode_png, encode_png, image_to_uint8
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.open_clip import OpenCLIPTextConfig, OpenCLIPTextModel
from cremage_tpu_torch.models.unet import UNetConfig, UNetModel
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.pipelines import sdxl as X
from cremage_tpu_torch.pipelines.loader import load_sdxl_bundle
from cremage_tpu_torch.prompt.tokenizer import default_tokenizer
from tests.conftest import assert_img01_close
from tests.test_torch_pipeline import jax_params, cheap_jax  # noqa: F401
from tests.test_torch_sdxl import (
    CLIP_KW, G_HID, L_HID, OC_KW, R_ADM, REF_KW, TI_G_TOKENS, UNET_KW,
)
from tests.test_torch_sdxl_loader import (  # noqa: F401
    LORA_TARGETS, LORA_WEIGHT, PREFIX_G, VAE_KW, _compare, _jax_bundle,
    _perturbed, _published_openclip, _tiny_configs, files,
)

torch.set_num_threads(2)
F32 = torch.float32
PREFIX_R = "conditioner.embedders.0.model."
BASE = dict(prompt="a (red:1.2) dog <embedding:two.pt>", negative_prompt="ugly",
            H=64, W=64, n_samples=2, n_iter=1, seed=42, scale=5.0,
            safety_check=False)
STRENGTH, REFINER_STRENGTH = 0.75, 0.5


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    """As tests/test_torch_modes.py: clear the worker's compiled programs
    before this module's JAX pipelines run."""
    jax.clear_caches()
    yield


def _sgm_file(path, unet_sd, gen, vae, clip, oc):
    """A base-layout (sgm) checkpoint with `unet_sd` as its UNet."""
    sd = {"model.diffusion_model." + k: v for k, v in unet_sd.items()}
    for prefix, part in (
            ("first_stage_model.", _perturbed(vae, gen)),
            ("conditioner.embedders.0.transformer.text_model.",
             _perturbed(clip, gen)),
            (PREFIX_G, _published_openclip(_perturbed(oc, gen)))):
        sd.update({prefix + k: v for k, v in part.items()})
    sd[PREFIX_G + "logit_scale"] = torch.tensor(4.6)
    save_file(sd, str(path))


@pytest.fixture(scope="module")
def xl_files(files, tmp_path_factory):  # noqa: F811
    """The base model's files, a refiner and a 9-channel inpainting model."""
    d = tmp_path_factory.mktemp("sdxl_modes")
    gen = torch.Generator().manual_seed(5)
    with torch.random.fork_rng():
        torch.manual_seed(6)
        ref_unet = UNetModel(UNetConfig(**REF_KW, dtype=F32))
        inp_unet = UNetModel(UNetConfig(**dict(UNET_KW, in_channels=9),
                                        dtype=F32))
        vae = AutoencoderKL(VAEConfig(**VAE_KW, dtype=F32))
        clip = CLIPTextModel(CLIPTextConfig(**CLIP_KW, dtype=F32))
        oc = OpenCLIPTextModel(OpenCLIPTextConfig(**OC_KW, dtype=F32))
    sd = {"model.diffusion_model." + k: v
          for k, v in _perturbed(ref_unet, gen).items()}
    sd.update({PREFIX_R + k: v for k, v in
               _published_openclip(_perturbed(oc, gen)).items()})
    sd[PREFIX_R + "logit_scale"] = torch.tensor(4.6)
    # the refiner's own VAE (a different one): JAX decodes with the base's
    sd.update({"first_stage_model." + k: v
               for k, v in _perturbed(vae, gen).items()})
    sd["denoiser.sigmas"] = torch.linspace(0.03, 14.6, 1000)
    paths = dict(files, refiner=str(d / "refiner.safetensors"),
                 inpaint=str(d / "inpaint.safetensors"))
    save_file(sd, paths["refiner"])
    _sgm_file(paths["inpaint"], _perturbed(inp_unet, gen), gen, vae, clip, oc)
    return paths


def _port_bundle(mp, path, **kw):
    _tiny_configs(mp)
    return load_sdxl_bundle(path, device="cpu", dtype=F32, **kw)


def _equal(module, jax_params, rename=lambda k: k):
    _compare(module, jax_params, rename, set())


def test_refiner_conditioner_matches_jax(tmp_path):
    """refiner_mode: bigG's penultimate layer alone as crossattn, and
    pooled + orig_size + crop_coords + aesthetic score (6.0 for c, 2.5 for
    uc) as the vector; c and uc filler-padded to one length. bigG and the
    TI file as tests/test_torch_sdxl.py's `models` draw them."""
    jo = JOC(JOCConfig(**OC_KW, dtype=jnp.float32))
    op = jax_params(jo, 22, jnp.zeros((1, 77), jnp.int32))
    to = convert.load_open_clip(
        OpenCLIPTextModel(OpenCLIPTextConfig(**OC_KW, dtype=F32)),
        op["params"]).eval()
    rng = np.random.RandomState(23)
    torch.save({"clip_l": torch.from_numpy(rng.randn(1, L_HID).astype(np.float32)),
                "clip_g": torch.from_numpy(
                    rng.randn(TI_G_TOKENS, G_HID).astype(np.float32) * 0.02)},
               tmp_path / "two.pt")
    ours = X.SDXLConditioner(None, to, default_tokenizer(), str(tmp_path),
                             refiner_mode=True)
    ref = JConditioner(None, (jo, op), j_tokenizer(), str(tmp_path),
                       refiner_mode=True)
    for prompt, negative in (("a dog", "ugly"), ("a dog " * 80, "bad"),
                             ("<embedding:two.pt> a dog", "")):
        kw = dict(prompt=prompt, negative_prompt=negative, H=96, W=128)
        jc, juc = ref.encode_pair(JOptions(**kw), 2)
        with torch.no_grad():
            c, uc = ours.encode_pair(GenerationOptions(**kw), 2, "cpu")
        for g, w in ((c, jc), (uc, juc)):
            for k in ("crossattn", "vector"):
                assert tuple(g[k].shape) == tuple(w[k].shape), k
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                           atol=2e-5, rtol=2e-5)
        assert c["vector"].shape == (2, R_ADM)
        assert c["crossattn"].shape[2] == G_HID
    # the aesthetic score is the vector's last embedding
    a = ours.encode_cond("a dog", orig_size=(64, 64), aesthetic_score=6.0)
    b = ours.encode_cond("a dog", orig_size=(64, 64), aesthetic_score=2.5)
    assert np.abs(a["vector"][:-256] - b["vector"][:-256]).max() == 0
    assert np.abs(a["vector"][-256:] - b["vector"][-256:]).max() > 0.1


def _noise(key, shape, n_steps):
    """normal(key) and the per-step draws split(key, n)."""
    return (np.asarray(jax.random.normal(key, shape, jnp.float32)),
            [np.asarray(jax.random.normal(k, shape, jnp.float32))
             for k in jax.random.split(key, n_steps)])


def test_files_and_generate_match_jax(xl_files, monkeypatch):
    """The refiner file through both loaders (the JAX bundles load once per
    run: one test), then generate() on the base model's inpainting
    (img2img and the composite) with LCM and an LCM refiner pass (LCM's
    img2img grids). The 9-channel model's file and job are the next
    test's."""
    paths = xl_files
    lora = [(paths["lora"], LORA_WEIGHT)]
    jb = _jax_bundle(paths, monkeypatch, refiner_ckpt=paths["refiner"])
    with pytest.MonkeyPatch.context() as mp:
        tb = _port_bundle(mp, paths["model"], refiner_ckpt=paths["refiner"],
                          loras=lora, embedding_dir=paths["emb"])
    # weights: the refiner's UNet and bigG as its file holds them (no
    # LoRA: its te2 modules moved the base model's bigG only)
    assert tb.refiner_conditioner.refiner_mode
    assert tb.refiner_conditioner.clip_l is None
    _equal(tb.refiner_unet, jb.refiner_params["params"])
    _equal(tb.refiner_conditioner.open_clip,
           jb.refiner_conditioner.open_clip[1]["params"],
           convert.openclip_jax_name)
    assert not torch.equal(
        tb.conditioner.open_clip.get_submodule(
            sorted(LORA_TARGETS["te2"])[0]).weight,
        tb.refiner_conditioner.open_clip.get_submodule(
            sorted(LORA_TARGETS["te2"])[0]).weight)
    assert not tb.inpaint and jb.inpaint is False
    assert set(tb.load_report["files"]) == {paths["model"], paths["refiner"],
                                            paths["lora"]}
    _check_job("base inpainting, LCM, refiner", jb, tb,
               dict(sampler="LCM", sampling_steps=4, strength=STRENGTH,
                    refiner_strength=REFINER_STRENGTH, mode="inpainting"),
               max(1, int(STRENGTH * 4)))


def test_inpainting_file_and_generate_match_jax(xl_files, monkeypatch):
    """The 9-channel inpainting file through both loaders (its UNet with
    its conv_in, its VAE), then generate() with Euler ancestral from unit
    noise scaled by sqrt(1 + sigma0^2)."""
    paths = xl_files
    ji = _jax_bundle(dict(paths, model=paths["inpaint"]), monkeypatch,
                     loras=(), inpainting=True)
    with pytest.MonkeyPatch.context() as mp:
        ti = _port_bundle(mp, paths["inpaint"], inpainting=True,
                          embedding_dir=paths["emb"])
    assert ti.inpaint
    assert ti.unet.input_blocks[0][0].weight.shape[1] == 9
    _equal(ti.unet, ji.unet_params["params"])
    _equal(ti.vae, ji.vae_params["params"])
    _check_job("9-channel inpainting", ji, ti,
               dict(sampler="EulerAncestralSampler", sampling_steps=3,
                    mode="inpainting"), 3)


def _check_job(case, jbundle, tbundle, extra, n_steps):
    """generate() of an inpainting job on both bundles, the port handed
    JAX's noise (the refiner's from fold_in(key, 99)): images within the
    tolerance of the module docstring, the original kept outside the
    mask, the statuses."""
    rng = np.random.RandomState(7)
    init = rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    mask = np.zeros((64, 64), np.float32)
    mask[16:48, 8:40] = 1.0
    shape = (2, 8, 8, 4)
    kw = dict(init_image=init, mask_image=mask)
    opts = dict(BASE, **extra)
    want = JPipeline(jbundle).generate(JOptions(**opts), **kw)
    key = key_for_image(42, 0)
    first, steps = _noise(key, shape, n_steps)
    r_steps = max(1, int(REFINER_STRENGTH * opts["sampling_steps"]))
    r_first, r_draws = _noise(jax.random.fold_in(key, 99), shape, r_steps)
    msgs = []
    got = X.SDXLPipeline(tbundle, device="cpu").generate(
        GenerationOptions(**opts), status_cb=msgs.append,
        noise=lambda seed, device: ArrayNoise(
            first, steps, device, encode=first,
            refiner=ArrayNoise(None, r_draws, device, encode=r_first)),
        **kw)
    assert len(got) == len(want) == 2
    for (gi, gm), (wi, wm) in zip(got, want):
        assert_img01_close(gi, wi, float_tol=2.0 / 255.0)
        assert gm == wm, case
    refined = "refiner_strength" in extra
    assert ("refining" in msgs) == refined, case
    assert msgs[0] == "batch 1/1: encoding prompt" and msgs[-1] == "decoding"
    keep = mask < 0.5               # the original outside the mask
    for gi, _ in got:
        np.testing.assert_allclose(gi[keep], ((init + 1) / 2)[keep],
                                   atol=1e-6)


def test_lcm_takes_vanilla_cfg_only():
    """As in JAX: LCM under any other guider raises its ValueError before
    a model runs."""
    kw = dict(sampler="LCM", guider="IdentityGuider", sampling_steps=4)
    with pytest.raises(ValueError) as want:
        JPipeline.__new__(JPipeline)._sampler_program(
            None, JOptions(**kw), (1, 8, 8, 4), (1, 77, 8), None)
    with pytest.raises(ValueError) as got:
        X.SDXLPipeline.__new__(X.SDXLPipeline)._sample(
            GenerationOptions(**kw), None, None, None, None, None, None)
    assert str(got.value) == str(want.value)


def test_refiner_file_refuses_keys_of_no_model(xl_files, tmp_path, monkeypatch):
    from cremage_tpu_torch.io.checkpoint import load_safetensors

    sd = dict(load_safetensors(xl_files["refiner"]))
    sd["conditioner.embedders.1.model.weight"] = torch.zeros(2)
    path = str(tmp_path / "bad_refiner.safetensors")
    save_file({k: v.contiguous() for k, v in sd.items()}, path)
    with pytest.raises(KeyError, match="no SDXL refiner component"):
        _port_bundle(monkeypatch, xl_files["model"], refiner_ckpt=path)


def test_refiner_and_inpainting_over_http(xl_files, monkeypatch, tmp_path):
    """/v1/generate with "SDXL": a job naming a refiner_ckpt and one in
    mode "inpainting" (the preferences' 9-channel model) through
    sdxl_factory; each image is the resident pipeline's own for its seed,
    and each job's bundle is the one it names."""
    import urllib.request

    _tiny_configs(monkeypatch)
    d, name = xl_files["model"].rsplit("/", 1)
    prefs = Preferences(sdxl_ldm_model_path=d, sdxl_ldm_model=name,
                        sdxl_ldm_inpaint_model=xl_files["inpaint"],
                        sdxl_embedding_path=xl_files["emb"])
    worker = EngineWorker()
    resident = ResidentInstance()
    worker.register_backend("SDXL", sdxl_factory(prefs, device="cpu",
                                                 resident=resident))
    srv = ApiServer(worker=worker, port=0, upload_dir=str(tmp_path))
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"

    def call(path, body=None):
        req = urllib.request.Request(
            url + path, data=None if body is None else json.dumps(body).encode(),
            method="GET" if body is None else "POST",
            headers={"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    def drain():
        msgs = []
        while not any(isinstance(m, dict) and "job_done" in m for m in msgs):
            got = call("/v1/status")["messages"]
            msgs += got
            if not got:     # leave the GIL to the job's thread
                time.sleep(0.02)
        return msgs

    try:
        rng = np.random.RandomState(8)
        init = (rng.rand(64, 64, 3) * 255).astype(np.uint8)
        mask = np.zeros((64, 64, 3), np.uint8)
        mask[16:48, 16:48] = 255
        up = {k: call("/v1/upload", {"image": base64.b64encode(
            encode_png(a)).decode()})["path"]
            for k, a in (("init_img", init), ("mask_img", mask))}
        params = dict(prompt="a dog", negative_prompt="ugly", H=64, W=64,
                      sampling_steps=2, seed=9, n_samples=1,
                      sampler="EulerEDMSampler", safety_check=False)
        for mode, extra in (
                ("text_to_image", dict(refiner_ckpt=xl_files["refiner"],
                                       refiner_strength=0.5)),
                ("inpainting", dict(up, strength=0.5))):
            job = dict(params, **extra)
            call("/v1/generate", {"generator_model_type": "SDXL",
                                  "mode": mode, "parameters": job})
            msgs = drain()
            assert msgs[-1] == {"job_done": {"ok": True, "error": None}}, msgs
            imgs = [m for m in msgs if isinstance(m, dict) and "image_b64" in m]
            assert len(imgs) == 1
            rgb, _ = decode_png(base64.b64decode(imgs[0]["image_b64"]))
            pipe = resident.instance
            assert (pipe.bundle.refiner_unet is not None) == ("refiner_ckpt" in job)
            assert pipe.bundle.inpaint == (mode == "inpainting")
            assert ("refining" in msgs) == ("refiner_ckpt" in job)
            kw = {}
            if mode == "inpainting":
                kw = dict(init_image=init.astype(np.float32) / 255.0 * 2.0 - 1.0,
                          mask_image=mask[..., 0].astype(np.float32) / 255.0)
            want = pipe.generate(GenerationOptions.from_dict(
                dict(job, mode=mode)), **kw)
            np.testing.assert_array_equal(rgb, image_to_uint8(want[0][0]))
    finally:
        srv.stop()
