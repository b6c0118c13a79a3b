"""SDXL from checkpoint files through generate() and /v1/generate: the
port's loader and pipeline against the JAX package's, on the tiny configs
of tests/test_torch_sdxl.py.

One set of files is written from seeded random weights in the published
SDXL key layout (sgm: `model.diffusion_model.`, `first_stage_model.`,
`conditioner.embedders.0.transformer.text_model.` with CLIP's position_ids,
`conditioner.embedders.1.model.` with the fused attn.in_proj_weight/bias,
logit_scale and text_projection, and `denoiser.sigmas`), a kohya LoRA over
UNet, te1 and te2 modules (a Linear proj_in with a 2-D LoRA, a proj_out
with a 1x1-conv LoRA) and a two-tower TI file. JAX's load_sdxl_bundle
reads them with its configs swapped for the tiny ones; the weights must
agree exactly where no LoRA touched them and to 1e-6 relative after the
float32 merge. generate() txt2img and img2img must then agree within the
3/255 of tests/test_torch_pipeline.py::test_txt2img_matches_jax (one
uint8 step plus 2/255 for the bf16 rounding of the latent before the
decode), the port handed the noise the JAX pipeline draws.
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
from cremage_tpu.core.dtypes import FP32_POLICY
from cremage_tpu.core.rng import key_for_image
from cremage_tpu.models import open_clip as JOCM
from cremage_tpu.models import unet as JUNETM
from cremage_tpu.models import vae as JVAEM
from cremage_tpu.models.clip import CLIPTextConfig as JCLIPConfig
from cremage_tpu.models.open_clip import OpenCLIPTextConfig as JOCConfig
from cremage_tpu.models.unet import UNetConfig as JUNetConfig
from cremage_tpu.models.vae import VAEConfig as JVAEConfig
from cremage_tpu.pipelines import loader as JLOADER
from cremage_tpu.pipelines.sdxl import SDXLPipeline as JPipeline
from cremage_tpu_torch.app.backends import ResidentInstance, sdxl_factory
from cremage_tpu_torch.app.server import ApiServer
from cremage_tpu_torch.app.worker import EngineWorker
from cremage_tpu_torch.core.config import GenerationOptions, Preferences
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io.png import decode_png, image_to_uint8
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.open_clip import OpenCLIPTextConfig, OpenCLIPTextModel
from cremage_tpu_torch.models.unet import UNetConfig, UNetModel
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.pipelines import loader as LOADER
from cremage_tpu_torch.pipelines.loader import load_sdxl_bundle
from cremage_tpu_torch.pipelines.sdxl import SDXLPipeline
from tests.conftest import assert_img01_close
from tests.test_torch_pipeline import (  # noqa: F401
    shared_template, cheap_jax,
)
from tests.test_torch_sdxl import (
    ADM, CLIP_KW, CTX, G_HID, L_HID, OC_KW, R_ADM, REF_KW, UNET_KW,
)

torch.set_num_threads(2)
F32 = torch.float32
_jax_template = JLOADER._template    # unpatched, whatever a test swaps in
VAE_KW = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1, scale_factor=0.13025)
PREFIX_G = "conditioner.embedders.1.model."

# kohya modules of an SDXL LoRA and their (out, in[, kh, kw]) shapes, on the
# tiny UNet's attention blocks input_blocks.3.1, middle_block.1,
# output_blocks.0.1 and .1.1, CLIP-L (te1) and bigG (te2)
LORA = [
    ("lora_unet_down_blocks_1_attentions_0_transformer_blocks_1_attn2_to_k", (64, CTX)),
    ("lora_unet_mid_block_attentions_0_proj_in", (64, 64)),
    ("lora_unet_up_blocks_0_attentions_0_proj_out", (64, 64, 1, 1)),
    ("lora_unet_up_blocks_0_attentions_1_transformer_blocks_0_ff_net_2", (64, 256)),
    ("lora_te1_text_model_encoder_layers_1_self_attn_q_proj", (L_HID, L_HID)),
    ("lora_te2_text_model_encoder_layers_0_mlp_fc1", (4 * G_HID, G_HID)),
    ("lora_te2_text_model_encoder_layers_1_self_attn_out_proj", (G_HID, G_HID)),
]
LORA_TARGETS = {
    "unet": {"input_blocks.3.1.transformer_blocks.1.attn2.to_k",
             "middle_block.1.proj_in", "output_blocks.0.1.proj_out",
             "output_blocks.1.1.transformer_blocks.0.ff.net.2"},
    "te": {"encoder.layers.1.self_attn.q_proj"},
    "te2": {"transformer.resblocks.0.mlp.c_fc",
            "transformer.resblocks.1.attn.out_proj"},
}
LORA_WEIGHT = 0.7
OPTS = dict(prompt="a (red:1.2) dog <embedding:two.pt>", negative_prompt="ugly",
            H=64, W=64, sampling_steps=3, n_samples=2, n_iter=1, seed=42,
            scale=5.0, sampler="EulerEDMSampler", safety_check=False)


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    """As tests/test_torch_modes.py: clear the worker's compiled programs
    before this module's JAX pipelines run."""
    jax.clear_caches()
    yield


def _perturbed(module, gen):
    return {k: (v + 0.1 * torch.randn(v.shape, generator=gen)).contiguous()
            for k, v in module.state_dict().items()}


def _published_openclip(sd):
    """The port's split q/k/v keys fused back into attn.in_proj_*."""
    out = {}
    for k, v in sd.items():
        if ".attn.q_proj." in k:
            kind = k.rsplit(".", 1)[1]
            base = k.split(".attn.q_proj.")[0] + ".attn."
            out[f"{base}in_proj_{kind}"] = torch.cat(
                [sd[f"{base}{n}_proj.{kind}"] for n in "qkv"]).contiguous()
        elif not (".attn.k_proj." in k or ".attn.v_proj." in k):
            out[k] = v
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sdxl")
    gen = torch.Generator().manual_seed(0)
    with torch.random.fork_rng():
        torch.manual_seed(1)
        unet = UNetModel(UNetConfig(**UNET_KW, dtype=F32))
        vae = AutoencoderKL(VAEConfig(**VAE_KW, dtype=F32))
        clip = CLIPTextModel(CLIPTextConfig(**CLIP_KW, dtype=F32))
        oc = OpenCLIPTextModel(OpenCLIPTextConfig(**OC_KW, dtype=F32))
    sd = {}
    for prefix, part in (
            ("model.diffusion_model.", _perturbed(unet, gen)),
            ("first_stage_model.", _perturbed(vae, gen)),
            ("conditioner.embedders.0.transformer.text_model.",
             _perturbed(clip, gen)),
            (PREFIX_G, _published_openclip(_perturbed(oc, gen)))):
        sd.update({prefix + k: v for k, v in part.items()})
    sd["conditioner.embedders.0.transformer.text_model.embeddings.position_ids"] = \
        torch.arange(77)[None]
    sd[PREFIX_G + "logit_scale"] = torch.tensor(4.6)
    sd["denoiser.sigmas"] = torch.linspace(0.03, 14.6, 1000)
    lora = {}
    for name, shape in LORA:
        tail = shape[2:]
        lora[f"{name}.lora_down.weight"] = 0.1 * torch.randn(
            (2, shape[1]) + tail, generator=gen)
        lora[f"{name}.lora_up.weight"] = 0.1 * torch.randn(
            (shape[0], 2) + tuple(1 for _ in tail), generator=gen)
        lora[f"{name}.alpha"] = torch.tensor(1.5)
    paths = dict(model=d / "sdxl.safetensors", lora=d / "lora.safetensors",
                 emb=d / "emb")
    save_file(sd, str(paths["model"]))
    save_file(lora, str(paths["lora"]))
    paths["emb"].mkdir()
    torch.save({"clip_l": torch.randn(1, L_HID, generator=gen),
                "clip_g": 0.1 * torch.randn(3, G_HID, generator=gen)},
               paths["emb"] / "two.pt")
    return {k: str(v) for k, v in paths.items()}


def _jax_bundle(files, monkeypatch, **kw):
    """JAX's load_sdxl_bundle on the files (by default with the LoRA and
    the TI directory; `kw` adds to or overrides its arguments), with its
    configs swapped for the tiny ones (it takes no config arguments) and
    its param templates traced at the tiny context and vector widths."""
    monkeypatch.setattr(JUNETM, "sdxl_base_unet_config",
                        lambda **kw: JUNetConfig(**UNET_KW, **kw))
    monkeypatch.setattr(JUNETM, "sdxl_refiner_unet_config",
                        lambda **kw: JUNetConfig(**REF_KW, **kw))
    monkeypatch.setattr(JVAEM, "sdxl_vae_config",
                        lambda **kw: JVAEConfig(**VAE_KW, **kw))
    monkeypatch.setattr(JOCM, "openclip_bigg_config",
                        lambda **kw: JOCConfig(**OC_KW, **kw))
    monkeypatch.setattr(JLOADER, "CLIPTextConfig",
                        lambda **kw: JCLIPConfig(**CLIP_KW, **kw))
    tiny = {(1, 77, 2048): (1, 77, CTX), (1, 2816): (1, ADM),
            (1, 77, 1280): (1, 77, G_HID), (1, 2560): (1, R_ADM)}

    memo = shared_template(_jax_template)

    def tiny_template(model, *args):
        # memoized: each trace of a model's init takes a second or more,
        # and bundles share the VAE's and the towers'
        return memo(model, *[jnp.zeros(tiny[a.shape]) if a.shape in tiny
                             else a for a in args])

    monkeypatch.setattr(JLOADER, "_template", tiny_template)
    kw = {"loras": [(files["lora"], LORA_WEIGHT)],
          "embedding_dir": files["emb"], **kw}
    return JLOADER.load_sdxl_bundle(files["model"], policy=FP32_POLICY,
                                    use_cache=False, **kw)


def _tiny_configs(mp):
    """The port's loader at the tiny configs: its config functions swapped
    through `mp`, a pytest MonkeyPatch."""
    mp.setattr(LOADER, "sdxl_base_unet_config", lambda: UNetConfig(**UNET_KW))
    mp.setattr(LOADER, "sdxl_refiner_unet_config", lambda: UNetConfig(**REF_KW))
    mp.setattr(LOADER, "sdxl_vae_config", lambda: VAEConfig(**VAE_KW))
    mp.setattr(LOADER, "openclip_bigg_config",
               lambda: OpenCLIPTextConfig(**OC_KW))
    mp.setattr(LOADER, "CLIPTextConfig", lambda: CLIPTextConfig(**CLIP_KW))


@pytest.fixture(scope="module")
def port_bundle(files):
    with pytest.MonkeyPatch.context() as mp:
        _tiny_configs(mp)
        return load_sdxl_bundle(files["model"],
                                loras=[(files["lora"], LORA_WEIGHT)],
                                embedding_dir=files["emb"], device="cpu",
                                dtype=F32)


def _compare(module, jax_params, rename, lora_targets):
    want = convert.state_dict_from_jax(module, jax_params, rename)
    for k, v in module.state_dict().items():
        if k.rsplit(".", 1)[0] in lora_targets:
            w = want[k].numpy()
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-6,
                                       atol=1e-6 * np.abs(w).max())
        else:
            assert torch.equal(v, want[k]), k


def _jax_noise(seed, shape, n_steps):
    """The initial (and img2img encode) noise and the per-step noise the
    JAX pipeline draws from the batch's key."""
    key = key_for_image(seed, 0)
    first = np.asarray(jax.random.normal(key, shape, jnp.float32))
    steps = [np.asarray(jax.random.normal(k, shape, jnp.float32))
             for k in jax.random.split(key, n_steps)]
    return first, steps


@pytest.fixture(scope="module")
def jax_bundle(files):
    """JAX's bundle of the files (with the LoRA and the TI directory),
    shared by the module's two parity tests."""
    with pytest.MonkeyPatch.context() as mp:
        return _jax_bundle(files, mp)


def test_loader_and_generate_match_jax(files, port_bundle, jax_bundle):
    """The weights of both loaders, then generate() txt2img; img2img is the
    next test's (the two JAX sampler programs compile apart, and one test
    for both took over 20 s)."""
    jb, tb = jax_bundle, port_bundle
    report = tb.load_report
    assert report["loras"] == [dict(path=files["lora"], merged=len(LORA),
                                    skipped=0)]
    got = {w: {n.split(":", 1)[1] for n in report["lora_modules"]
               if n.split(":", 1)[0] == w} for w in ("unet", "te", "te2")}
    assert got == LORA_TARGETS
    jcond = jb.conditioner
    _compare(tb.unet, jb.unet_params["params"], lambda k: k,
             LORA_TARGETS["unet"])
    _compare(tb.vae, jb.vae_params["params"], lambda k: k, set())
    _compare(tb.conditioner.clip_l, jcond.clip_l[1]["params"],
             convert.clip_jax_name, LORA_TARGETS["te"])
    _compare(tb.conditioner.open_clip, jcond.open_clip[1]["params"],
             convert.openclip_jax_name, LORA_TARGETS["te2"])
    _check_generate(jb, tb, "txt2img", {}, {})
    # the TI tag and the LoRA's text modules moved the conditioning
    c = tb.conditioner
    a = c.encode_cond("a dog <embedding:two.pt>", orig_size=(64, 64))
    b = c.encode_cond("a dog", orig_size=(64, 64))
    assert np.abs(a["crossattn"] - b["crossattn"]).max() > 1e-3
    assert np.abs(a["vector"] - b["vector"]).max() > 1e-3


def test_img2img_from_the_files_matches_jax(port_bundle, jax_bundle):
    """generate() img2img (Euler ancestral under the EDM discretization)
    on both loaders' bundles."""
    init01 = np.random.RandomState(3).uniform(-1, 1, (64, 64, 3)).astype(np.float32)
    _check_generate(jax_bundle, port_bundle, "img2img",
                    dict(sampler="EulerAncestralSampler", sampling_steps=4,
                         strength=0.75, discretization="EDMDiscretization"),
                    dict(init_image=init01))


def _check_generate(jb, tb, case, extra, kw):
    """generate() on both bundles, the port handed the noise the JAX
    pipeline draws: images within 2/255 (module docstring), the same
    metadata, the port's statuses in order."""
    opts = dict(OPTS, **extra)
    # jitted: the JAX pipeline's scanned sampler compiles in less time
    # than its eager ops take (14 s against 39 s here)
    want = JPipeline(jb).generate(JOptions(**opts), **kw)
    n_steps = 3 if case == "txt2img" else max(1, int(0.75 * 4))
    first, steps = _jax_noise(42, (2, 8, 8, 4), n_steps)
    msgs = []
    got = SDXLPipeline(tb, device="cpu").generate(
        GenerationOptions(**opts), status_cb=msgs.append,
        noise=lambda seed, device: ArrayNoise(first, steps, device,
                                              encode=first), **kw)
    assert len(got) == len(want) == 2
    for (gi, gm), (wi, wm) in zip(got, want):
        assert_img01_close(gi, wi, float_tol=2.0 / 255.0)
        assert gm == wm, case
    assert msgs[:2] == ["batch 1/1: encoding prompt", "Sampling 1 / %d"
                        % n_steps] and msgs[-1] == "decoding"


def test_loader_refuses_keys_of_no_model(files, tmp_path, monkeypatch):
    from cremage_tpu_torch.io.checkpoint import load_safetensors

    sd = dict(load_safetensors(files["model"]))
    sd["conditioner.embedders.2.model.weight"] = torch.zeros(2)
    path = str(tmp_path / "bad.safetensors")
    save_file({k: v.contiguous() for k, v in sd.items()}, path)
    _tiny_configs(monkeypatch)
    with pytest.raises(KeyError, match="no SDXL component"):
        load_sdxl_bundle(path, device="cpu", dtype=F32)


def test_generate_over_http_from_the_config(files, monkeypatch, tmp_path):
    """/v1/generate with generator_model_type "SDXL": sdxl_factory loads
    the files the preferences name (bf16, the configs swapped for the tiny
    ones), serves txt2img and img2img, and the images are the resident
    pipeline's own for the same seeds; an option the port does not run
    fails the job before any load."""
    import urllib.request

    from cremage_tpu_torch.io.png import encode_png

    _tiny_configs(monkeypatch)
    d, name = files["model"].rsplit("/", 1)
    prefs = Preferences(sdxl_ldm_model_path=d, sdxl_ldm_model=name,
                        sdxl_embedding_path=files["emb"])
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
        init = (np.random.RandomState(4).rand(64, 64, 3) * 255).astype(np.uint8)
        init_path = call("/v1/upload", {"image": base64.b64encode(
            encode_png(init)).decode()})["path"]
        params = dict(prompt="a dog <embedding:two.pt>", negative_prompt="ugly",
                      H=64, W=64, sampling_steps=2, seed=9, n_samples=1,
                      sampler="DPMPP2MSampler", safety_check=False)
        for extra in ({}, dict(mode="image_to_image", init_img=init_path,
                               strength=0.5, sampler="EulerEDMSampler")):
            job = dict(params, **extra)
            call("/v1/generate", {"generator_model_type": "SDXL",
                                  "mode": job.pop("mode", "text_to_image"),
                                  "parameters": job})
            msgs = drain()
            assert msgs[-1] == {"job_done": {"ok": True, "error": None}}, msgs
            imgs = [m for m in msgs if isinstance(m, dict) and "image_b64" in m]
            assert len(imgs) == 1
            rgb, _ = decode_png(base64.b64decode(imgs[0]["image_b64"]))
            pipe = resident.instance
            assert isinstance(pipe, SDXLPipeline)
            assert pipe.bundle.unet.input_blocks[0][0].weight.dtype == torch.bfloat16
            init_img = (init.astype(np.float32) / 255.0 * 2.0 - 1.0
                        if extra else None)
            want = pipe.generate(GenerationOptions.from_dict(
                dict(job, mode=extra.get("mode", "text_to_image"))),
                init_image=init_img)
            np.testing.assert_array_equal(rgb, image_to_uint8(want[0][0]))
        call("/v1/generate", {"generator_model_type": "SDXL",
                              "parameters": dict(params, deep_cache=3)})
        done = drain()[-1]["job_done"]
        assert not done["ok"] and "NotImplementedError" in done["error"]
    finally:
        srv.stop()
