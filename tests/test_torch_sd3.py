"""SD3: the port's MMDiT, conditioner, loader, pipeline and backend against
the JAX package.

Four tests that loop over their cases, and three parametrised ones (under
`--dist load` the number of collected items sets the suite's wall time,
ROADMAP.md):

- the MMDiT (cremage_tpu_torch/models/mmdit.py) in float32: the pre-only
  last block, a non-square latent's crop of the position grid and the
  RMS qk-norm; float8_e4m3 and int8 storage with codes bit-equal to
  JAX's, the int8 patch embedding's among them; the shift-3 sigmas and
  the VAE config;
- the conditioner: the zero-T5 and the T5 branches, prompt weighting, a
  two-tower TI file and a prompt longer than one chunk;
- one file in the published layout (HF bigG, no VAE quant convs, T5, CLIP-L's
  dropped projection) through JAX's `load_sd3_bundle` (given a copy in the
  layout it reads) and the port's, generate() against the JAX pipeline;
- /v1/generate with "SD 3" through `sd3_factory` against JAX's factory's
  arguments, and the refusals;
- the loader arguments `sd3_factory` derives from a job's storage, T5 and
  model-file options, against JAX's factory's; the shift-3 sigmas at the
  step counts users pick; which stray keys of a single file `split_sd3`
  drops and which it refuses; the int8 patch embedding alone at four
  shapes; the published MMDiT config.

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
from cremage_tpu.core.rng import key_for_image
from cremage_tpu.models import mmdit as JMMDITM
from cremage_tpu.models import t5 as JT5M
from cremage_tpu.models import vae as JVAEM
from cremage_tpu.models.clip import CLIPTextConfig as JCLIPConfig
from cremage_tpu.models.clip import CLIPTextModel as JCLIP
from cremage_tpu.models.layers import Conv as JConv
from cremage_tpu.models.mmdit import MMDiT as JMMDiT
from cremage_tpu.models.mmdit import MMDiTConfig as JMMDiTConfig
from cremage_tpu.models.open_clip import OpenCLIPTextConfig as JOCConfig
from cremage_tpu.models.open_clip import OpenCLIPTextModel as JOC
from cremage_tpu.models import open_clip as JOCM
from cremage_tpu.models.t5 import T5Config as JT5Config
from cremage_tpu.models.t5 import T5Encoder as JT5
from cremage_tpu.pipelines import loader as JLOADER
from cremage_tpu.pipelines.sd3 import SD3Conditioner as JConditioner
from cremage_tpu.pipelines.sd3 import SD3Pipeline as JPipeline
from cremage_tpu.prompt.sentencepiece import T5Tokenizer as JT5Tokenizer
from cremage_tpu.prompt.tokenizer import default_tokenizer as j_tokenizer
from cremage_tpu.samplers import flow as JF
from cremage_tpu_torch.app.backends import ResidentInstance, sd3_factory
from cremage_tpu_torch.app.server import ApiServer
from cremage_tpu_torch.app.worker import EngineWorker
from cremage_tpu_torch.core.config import GenerationOptions, Preferences
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import checkpoint as CK
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io import quantize as Q
from cremage_tpu_torch.io.png import decode_png
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.layers import Conv2d, PatchConv8bit
from cremage_tpu_torch.models.mmdit import MMDiT, MMDiTConfig, sd3_medium_config
from cremage_tpu_torch.models.open_clip import OpenCLIPTextConfig, OpenCLIPTextModel
from cremage_tpu_torch.models.t5 import T5Config, T5Encoder
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig, sd3_vae_config
from cremage_tpu_torch.pipelines import loader as LOADER
from cremage_tpu_torch.pipelines import sd3 as SD3
from cremage_tpu_torch.pipelines.loader import load_sd3_bundle
from cremage_tpu_torch.prompt.sentencepiece import T5Tokenizer
from cremage_tpu_torch.prompt.tokenizer import default_tokenizer
from cremage_tpu_torch.samplers import flow as F
from tests.conftest import assert_img01_close
from tests.test_torch_flux import MIN, _codes_equal, _rel, _spiece
from tests.test_torch_pipeline import (  # noqa: F401
    cheap_jax, jax_params, shared_template,
)
from tests.test_torch_sdxl import CLIP_KW, G_HID, L_HID, OC_KW, TI_G_TOKENS

torch.set_num_threads(2)
F32 = torch.float32
# a T5 as wide as the CLIP concat needs (the context is padded to its width)
T5_KW = dict(d_model=96, d_kv=16, num_heads=2, d_ff=64, num_layers=1)
CTX, POOL = T5_KW["d_model"], L_HID + G_HID
MM_KW = dict(depth=2, hidden_size=64, num_heads=2, context_dim=CTX,
             pooled_dim=POOL, pos_embed_max_size=16)
FILE_VAE = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
SD3_OPTS = dict(prompt="a (red:1.2) fox, masterpiece", negative_prompt="blurry",
                H=64, W=64, sampling_steps=2, n_samples=2, n_iter=1, seed=7,
                scale=5.0, safety_check=False, watermark=False)


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    """As tests/test_torch_modes.py: clear the worker's compiled programs
    before this module's JAX programs run."""
    jax.clear_caches()
    yield


def test_mmdit_and_8bit_codes_match_jax():
    """The tiny MMDiT in float32 (2 joint blocks, the second's context
    stream pre-only) on a 8x12 latent (a 4x6 crop of the 16x16 grid), with
    and without the RMS qk-norm; then float8_e4m3 and int8 storage: the
    port quantizes the JAX weights itself, its codes (the int8 patch
    embedding's too) bit-equal to JAX's `_quantize_tree`'s, and carries
    JAX's 8-bit tree over. Velocity within 1e-4 of its range (float32 sums
    in another order), int8 within 2e-2 (an activation code on a rounding
    boundary moves its row by one step of 1/127). The shift-3 sigmas equal
    JAX's, and the VAE config JAX's (no quant convs in the port)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 12, 16).astype(np.float32)
    t = np.array([750.0, 250.0], np.float32)
    ctx = rng.randn(2, 9, CTX).astype(np.float32)
    pooled = rng.randn(2, POOL).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, t, ctx, pooled)]
    for qk_norm, kind in ((False, None), (True, None),
                          (False, "float8_e4m3"), (False, "int8")):
        jm = JMMDiT(JMMDiTConfig(**MM_KW, qk_norm=qk_norm, dtype=jnp.float32))
        params = jax_params(jm, 30 + qk_norm, *[jnp.zeros((1,) + a.shape[1:])
                                                for a in args])["params"]
        jp = params if kind is None else JLOADER._quantize_tree(
            params, kind, "MMDiT", min_size=MIN)
        want = jax.jit(jm.apply)({"params": jp}, *args)
        cfg = MMDiTConfig(**MM_KW, qk_norm=qk_norm, dtype=F32)
        port = convert.load_from_jax(MMDiT(cfg), params)
        if kind is not None:
            convs = kind == "int8"
            rep = Q.quantize_module(port, kind, min_size=MIN,
                                    include_convs=convs)
            carried = MMDiT(cfg)
            assert Q.prepare_8bit(carried, kind, min_size=MIN,
                                  include_convs=convs) == rep["tensors"]
            _codes_equal(port, convert.load_from_jax(carried, jp))
            assert (port.x_embedder.proj.weight.dtype == torch.int8) == convs
        with torch.no_grad():
            got = port(*[torch.from_numpy(a) for a in (x, t, ctx, pooled)])
        assert _rel(got.numpy(), want) <= (2e-2 if kind == "int8" else 1e-4), \
            (qk_norm, kind)
    with pytest.raises(NotImplementedError, match="capture"):
        port(*[torch.from_numpy(a) for a in (x, t, ctx, pooled)],
             mode="capture")

    for steps in (2, 28):
        assert np.array_equal(F.sd3_sigmas(steps), JF.sd3_sigmas(steps))
    j, p = JVAEM.sd3_vae_config(), sd3_vae_config()
    assert (p.z_channels, p.scale_factor, p.shift_factor, p.quant_convs) == \
        (j.z_channels, j.scale_factor, j.shift_factor, False)


@pytest.fixture(scope="module")
def towers(tmp_path_factory):
    """The tiny CLIP-L, bigG and T5 of both packages on the same weights,
    a two-tower TI file and the T5 tokenizer's spiece.model."""
    jc = JCLIP(JCLIPConfig(**CLIP_KW, dtype=jnp.float32))
    cp = jax_params(jc, 21, jnp.zeros((1, 77), jnp.int32))
    jo = JOC(JOCConfig(**OC_KW, dtype=jnp.float32))
    op = jax_params(jo, 22, jnp.zeros((1, 77), jnp.int32))
    vocab = T5Tokenizer(_spiece()).vocab_size
    jt = JT5(JT5Config(vocab_size=vocab, **T5_KW, dtype=jnp.float32))
    tp = jax_params(jt, 23, jnp.zeros((1, 8), jnp.int32))
    root = tmp_path_factory.mktemp("sd3_towers")
    rng = np.random.RandomState(24)
    torch.save({"clip_l": torch.from_numpy(rng.randn(1, L_HID).astype(np.float32)),
                "clip_g": torch.from_numpy(
                    rng.randn(TI_G_TOKENS, G_HID).astype(np.float32) * 0.02)},
               root / "two.pt")
    (root / "spiece.model").write_bytes(_spiece())
    return dict(
        jax=((jc, cp), (jo, op), (jt, tp)),
        port=(convert.load_clip(CLIPTextModel(CLIPTextConfig(**CLIP_KW, dtype=F32)),
                                cp["params"]).eval(),
              convert.load_open_clip(OpenCLIPTextModel(OpenCLIPTextConfig(
                  **OC_KW, dtype=F32)), op["params"]).eval(),
              convert.load_t5(T5Encoder(T5Config(vocab_size=vocab, **T5_KW,
                                                 dtype=F32)),
                              tp["params"]).eval()),
        emb=str(root), spiece=str(root / "spiece.model"))


def test_conditioner_matches_jax(towers):
    """(c, uc) of the port's SD3Conditioner against JAX's on the same
    towers: with a T5 tokenizer (T5 over 77 tokens) and without one (the
    served zero context), for a short, a weighted, a two-tower TI and a
    two-chunk prompt (the first chunk only); crossattn (154, T5 width) and
    pooled (CLIP-L's unprojected + bigG's projected) within 2e-5
    (float32). Then the HF layout of bigG against the JAX package's HF
    converter (`_check_hf_bigg_layout`)."""
    (jc, jo, jt), (tc, to, tt) = towers["jax"], towers["port"]
    prompts = [("a cat", ""), ("a (red:1.3) fox, [blurry]", "ugly"),
               ("<embedding:two.pt> a dog", "bad"),
               (" ".join(["word"] * 90), "x")]
    for spiece in (towers["spiece"], None):
        ref = JConditioner(jc, jo, j_tokenizer(), t5=(jt[0], jt[1]),
                           t5_tokenize=spiece, embedding_dir=towers["emb"])
        ours = SD3.SD3Conditioner(tc, to, default_tokenizer(), t5=tt,
                                  t5_tokenize=spiece, embedding_dir=towers["emb"])
        for prompt, negative in prompts:
            kw = dict(prompt=prompt, negative_prompt=negative)
            want = ref.encode_pair(JOptions(**kw), 2)
            got = ours.encode_pair(GenerationOptions(**kw), 2, "cpu")
            for g, w in zip(got, want):
                assert g["crossattn"].shape == (2, 154, CTX)
                assert g["pooled"].shape == (2, POOL)
                for k in g:
                    np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                               atol=2e-5, rtol=2e-5)
            t5_part = got[0]["crossattn"][:, 77:]
            assert bool((t5_part == 0).all()) == (spiece is None), prompt
    _check_hf_bigg_layout()


def _check_hf_bigg_layout():
    """io/checkpoint.py `hf_text_to_openclip` (the layout of bigG in SD3's
    file) against the JAX package's own HF converter,
    `hf_clip_text_to_openclip_subdict`: the same arrays under the same
    names (the JAX tree's bare token table aside), the projection
    transposed; a key outside the tower raises."""
    from cremage_tpu.io.checkpoint import hf_clip_text_to_openclip_subdict

    with torch.random.fork_rng():
        torch.manual_seed(5)
        oc = OpenCLIPTextModel(OpenCLIPTextConfig(**OC_KW, dtype=F32))
    hf = hf_bigg(oc.state_dict())
    got = CK.hf_text_to_openclip(
        {k.removeprefix("text_model."): v for k, v in hf.items()})
    want = hf_clip_text_to_openclip_subdict(
        {k: v.numpy() for k, v in hf.items()})
    want["token_embedding.weight"] = want.pop("token_embedding")
    assert set(got) == set(want) == set(oc.state_dict())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert torch.equal(got["text_projection"], oc.text_projection)
    with pytest.raises(KeyError, match="unknown key"):
        CK.hf_text_to_openclip({"logit_scale": torch.ones(())})


_jax_template = JLOADER._template    # unpatched, whatever a test swaps in


def _tiny_sd3_configs(mp, vocab):
    """Swap both loaders' published configs for the tiny ones, and JAX's
    MMDiT template inputs for the tiny widths (JAX's templates memoized)."""
    memo = shared_template(_jax_template)
    tiny = {(1, 154, 4096): (1, 154, CTX), (1, 2048): (1, POOL)}
    mp.setattr(JLOADER, "_template", lambda model, *args: memo(
        model, *[jnp.zeros(tiny[a.shape]) if a.shape in tiny else a
                 for a in args]))
    mp.setattr(JMMDITM, "sd3_medium_config",
               lambda **kw: JMMDiTConfig(**MM_KW, **kw))
    mp.setattr(JT5M, "t5_xxl_config",
               lambda **kw: JT5Config(vocab_size=vocab, **T5_KW, **kw))
    mp.setattr(JVAEM, "sd3_vae_config", lambda **kw: JVAEM.VAEConfig(
        z_channels=16, embed_dim=16, scale_factor=1.5305, shift_factor=0.0609,
        **FILE_VAE, **kw))
    mp.setattr(JOCM, "openclip_bigg_config",
               lambda **kw: JOCConfig(**OC_KW, **kw))
    mp.setattr(JLOADER, "CLIPTextConfig",
               lambda **kw: JCLIPConfig(**CLIP_KW, **kw))
    mp.setattr(LOADER, "sd3_medium_config",
               lambda **kw: MMDiTConfig(**MM_KW, **kw))
    mp.setattr(LOADER, "t5_xxl_config",
               lambda **kw: T5Config(vocab_size=vocab, **T5_KW, **kw))
    mp.setattr(LOADER, "sd3_vae_config", lambda **kw: VAEConfig(
        z_channels=16, scale_factor=1.5305, shift_factor=0.0609,
        quant_convs=False, **FILE_VAE, **kw))
    mp.setattr(LOADER, "openclip_bigg_config",
               lambda **kw: OpenCLIPTextConfig(**OC_KW, **kw))
    mp.setattr(LOADER, "CLIPTextConfig",
               lambda **kw: CLIPTextConfig(**CLIP_KW, **kw))


def hf_bigg(oc: dict) -> dict:
    """The port's OpenCLIP state dict in HF's CLIPTextModelWithProjection
    layout (the inverse of io/checkpoint.py `hf_text_to_openclip`)."""
    out = {}
    for k, v in oc.items():
        if k == "text_projection":
            out["text_projection.weight"] = v.t().contiguous()
        elif k == "token_embedding.weight":
            out["text_model.embeddings.token_embedding.weight"] = v
        elif k == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = v
        elif k.startswith("ln_final."):
            out["text_model.final_layer_norm." + k[len("ln_final."):]] = v
        else:
            i, sub = k[len("transformer.resblocks."):].split(".", 1)
            for a, b in CK.HF_OPENCLIP_LAYER:
                sub = sub.replace(b, a)
            out[f"text_model.encoder.layers.{i}.{sub}"] = v
    return out


def write_sd3_files(root, vocab):
    """Seeded random fp16 tensors in SD3's published single-file layout
    (paths["published"]) and the same weights in the layout JAX's loader
    reads (paths["jax"]: bigG in open_clip names under
    text_encoders.clip_g.model.). -> (paths, {component: tensors})."""
    gen = torch.Generator().manual_seed(40)

    def rand(module):
        return {k: (v + 0.1 * torch.randn(v.shape, generator=gen)).half()
                for k, v in module.state_dict().items()}

    torch.manual_seed(41)
    truth = dict(
        mmdit=rand(MMDiT(MMDiTConfig(**MM_KW))),
        vae=rand(AutoencoderKL(VAEConfig(z_channels=16, quant_convs=False,
                                         **FILE_VAE))),
        clip_l=rand(CLIPTextModel(CLIPTextConfig(**CLIP_KW))),
        clip_g=rand(OpenCLIPTextModel(OpenCLIPTextConfig(**OC_KW))),
        t5=rand(T5Encoder(T5Config(vocab_size=vocab, **T5_KW))))
    common = {CK.PREFIX_UNET + k: v for k, v in truth["mmdit"].items()}
    common.update({CK.PREFIX_VAE + k: v for k, v in truth["vae"].items()})
    common.update({CK.PREFIX_SD3_CLIP_L + k: v
                   for k, v in truth["clip_l"].items()})
    common[CK.PREFIX_SD3_CLIP_L + CK.POSITION_IDS] = torch.arange(77)[None]
    for k, v in truth["t5"].items():
        k = CK.T5_BIAS_KEY if k == "relative_attention_bias.weight" else k
        common[CK.PREFIX_SD3_T5 + ("" if k == "shared.weight"
                                   else "encoder.") + k] = v
    published = dict(common)
    for k, v in hf_bigg(truth["clip_g"]).items():
        published["text_encoders.clip_g.transformer." + k] = v
    published[CK.PREFIX_SD3_CLIP_G + CK.POSITION_IDS] = torch.arange(77)[None]
    published.update({k: torch.randn(L_HID, L_HID, generator=gen).half()
                      for k in CK.SD3_DROPPED})
    jax_copy = dict(common)
    jax_copy.update({"text_encoders.clip_g.model." + k: v
                     for k, v in truth["clip_g"].items()})
    paths = {n: str(root / f"sd3_{n}.safetensors")
             for n in ("published", "jax", "unknown")}
    CK.save_safetensors(paths["published"], published)
    CK.save_safetensors(paths["jax"], jax_copy)
    CK.save_safetensors(paths["unknown"], dict(
        published, **{"text_encoders.clip_g.transformer.logit_scale":
                      torch.ones(())}))
    return paths, truth


def _files(tmp_path, monkeypatch):
    vocab = T5Tokenizer(_spiece()).vocab_size
    _tiny_sd3_configs(monkeypatch, vocab)
    (tmp_path / "spiece.model").write_bytes(_spiece())
    return write_sd3_files(tmp_path, vocab)


def _load_both(tmp_path, monkeypatch, **kw):
    paths, truth = _files(tmp_path, monkeypatch)
    jb = JLOADER.load_sd3_bundle(paths["jax"], policy=FP32_POLICY, **kw)
    vp = jb.vae_params["params"]
    # JAX's VAE always has the quant convs; the published file has none:
    # identity 1x1 convolutions compute the same function
    vp["quant_conv"] = {"weight": jnp.eye(32)[None, None], "bias": jnp.zeros(32)}
    vp["post_quant_conv"] = {"weight": jnp.eye(16)[None, None],
                             "bias": jnp.zeros(16)}
    tb = load_sd3_bundle(paths["published"], device="cpu", dtype=F32, **kw)
    return paths, truth, jb, tb


def test_file_loads_and_generates_as_jax(tmp_path, monkeypatch):
    """The published single file through the port's loader: every weight
    equals the file's (bigG from HF's layout, its projection transposed),
    CLIP-L's projection dropped by name, T5 loaded; an unknown key and a
    missing one raise. JAX's loader on its copy: the same MMDiT, the
    towers' outputs, and generate() with a T5 tokenizer and without one
    (the served zero context) within 2/255 of JAX's pipeline, the port
    handed JAX's noise, with JAX's statuses and metadata."""
    paths, truth, jb, tb = _load_both(tmp_path, monkeypatch)
    cond = tb.conditioner
    for model, want in ((tb.mmdit, truth["mmdit"]), (tb.vae, truth["vae"]),
                        (cond.clip_l, truth["clip_l"]),
                        (cond.open_clip, truth["clip_g"]),
                        (cond.t5, truth["t5"])):
        state = model.state_dict()
        assert set(state) == set(want)
        for k, v in want.items():
            assert torch.equal(state[k], v.float()), k
    assert set(tb.load_report["files"]) == {paths["published"]}
    with pytest.raises(KeyError, match="belong to no SD3 component"):
        load_sd3_bundle(paths["unknown"], device="cpu", dtype=F32)
    sd = CK.load_safetensors(paths["published"])
    sd.pop(CK.PREFIX_UNET + "context_embedder.bias")
    with pytest.raises(KeyError, match="missing 1 keys"):
        CK.load_into(MMDiT(MMDiTConfig(**MM_KW)),
                     CK.split_sd3(sd)[CK.PREFIX_UNET], "cpu", "MMDiT")
    assert load_sd3_bundle(paths["published"], include_t5=False, device="cpu",
                           dtype=F32).conditioner.t5 is None

    want = MMDiT(tb.mmdit.cfg)
    convert.load_from_jax(want, jb.mmdit_params["params"])
    for k, v in want.state_dict().items():
        assert torch.equal(tb.mmdit.state_dict()[k], v), k

    jpipe = JPipeline(jb)
    pipe = SD3.SD3Pipeline(tb, device="cpu")
    h = w = SD3_OPTS["H"] // 8
    noise = np.asarray(jax.random.normal(key_for_image(SD3_OPTS["seed"], 0),
                                         (2, h, w, 16), jnp.float32))
    for spiece in (str(tmp_path / "spiece.model"), None):
        jb.conditioner.t5_tokenize = (None if spiece is None else
                                      JT5Tokenizer(spiece).tokenize_fn(77))
        tb.conditioner.t5_tokenize = (None if spiece is None else
                                      T5Tokenizer(spiece).tokenize_fn(77))
        j_msgs, t_msgs = [], []
        ref = jpipe.generate(JOptions(**SD3_OPTS), status_cb=j_msgs.append)
        got = pipe.generate(GenerationOptions(**SD3_OPTS),
                            status_cb=t_msgs.append,
                            noise=lambda seed, dev: ArrayNoise(noise))
        assert t_msgs == ["encoding prompt", "1 / 2", "2 / 2", "decoding"]
        assert sorted(j_msgs) == sorted(t_msgs)
        for (gi, gm), (wi, wm) in zip(got, ref):
            assert_img01_close(gi, wi, float_tol=2 / 255)
            assert gm == wm


def record_loaders(mp, name: str) -> dict:
    """Patch JAX's and the port's loader `name` to record their arguments
    under "jax" and "port" and raise LookupError: what a factory would
    load, with nothing loaded."""
    seen = {}

    def record(which):
        def load(*args, **kw):
            seen[which] = (args, kw)
            raise LookupError("recorded")
        return load

    mp.setattr(JLOADER, name, record("jax"))
    mp.setattr(LOADER, name, record("port"))
    return seen


def test_http_job_as_jax_sd3_factory(tmp_path, monkeypatch):
    """/v1/generate with "SD 3": the port's factory hands its loader JAX's
    factory's arguments and keeps JAX's resident key; the served image is
    the resident pipeline's own for the seed, its T5 loaded and its
    context zeros (no tokenizer, as JAX's backend); /v1/meta lists the
    model type. The options the port does not run are refused before any
    load (check_supported, the meshes), with the model path from the
    preferences when the job names none."""
    from cremage_tpu.app import backends as JBACKENDS
    from cremage_tpu.core.config import Preferences as JPrefs

    paths, _ = _files(tmp_path, monkeypatch)
    params = dict(SD3_OPTS, ckpt=paths["published"], n_samples=1, seed=9,
                  dit_quantize="none", sd3_quantize_t5="none")
    with monkeypatch.context() as mp:
        seen = record_loaders(mp, "load_sd3_bundle")
        with pytest.raises(LookupError):
            JBACKENDS.sd3_factory(JPrefs())(dict(params), lambda m: None, None)
        with pytest.raises(LookupError):
            sd3_factory(Preferences(), device="cpu")()(
                dict(params), lambda m: None, None)
    (j_args, j_kw), (t_args, t_kw) = seen["jax"], seen["port"]
    assert t_args == j_args
    assert {k: v for k, v in t_kw.items() if k != "device"} == j_kw

    for bad in (dict(deep_cache=2), dict(ada_cache=0.1), dict(tome_ratio=0.3),
                dict(cfg_interval_low=0.2, cfg_interval_high=0.8)):
        with pytest.raises(NotImplementedError, match="not ported"):
            SD3.check_supported(GenerationOptions(**bad))
    pipe = SD3.SD3Pipeline.__new__(SD3.SD3Pipeline)
    for method in (pipe.use_mesh_sp, pipe.use_mesh_pp):
        with pytest.raises(NotImplementedError, match="not ported"):
            method(None)

    worker, resident = EngineWorker(), ResidentInstance()
    prefs = Preferences(sd3_ldm_model_path=str(tmp_path),
                        sd3_ldm_model="sd3_published.safetensors")
    worker.register_backend("SD 3", sd3_factory(prefs, device="cpu",
                                                resident=resident))
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
        call("/v1/generate", {"generator_model_type": "SD 3",
                              "mode": "text_to_image", "parameters": p})
        msgs = []
        while not any(isinstance(m, dict) and "job_done" in m for m in msgs):
            got = call("/v1/status")["messages"]
            msgs += got
            if not got:     # leave the GIL to the job's thread
                time.sleep(0.02)
        return msgs

    try:
        assert "SD 3" in call("/v1/meta")["model_types"]
        done = job(dict(params, deep_cache=3))[-1]["job_done"]
        assert not done["ok"] and "not ported" in done["error"], done
        assert resident.instance is None     # refused before any load
        served = {k: v for k, v in params.items() if k != "ckpt"}
        msgs = job(served)
        assert msgs[-1] == {"job_done": {"ok": True, "error": None}}, msgs
        imgs = [m for m in msgs if isinstance(m, dict) and "image_b64" in m]
        rgb, _ = decode_png(base64.b64decode(imgs[0]["image_b64"]))
        assert resident.key == ("sd3", paths["published"], True, "none", "none")
        pipe = resident.instance
        cond = pipe.bundle.conditioner
        assert cond.t5 is not None and cond.t5_tokenize is None
        assert bool((cond.encode("a fox")["crossattn"][77:] == 0).all())
        want = pipe.generate(GenerationOptions.from_dict(served))
        np.testing.assert_array_equal(
            rgb, np.round(want[0][0] * 255).astype(np.uint8))
    finally:
        srv.stop()


# a job's load options -> the same load_sd3_bundle call in both packages
SD3_LOADS = {
    "float8-dit": dict(dit_quantize="float8_e4m3", sd3_quantize_t5="none"),
    "int8-dit-float8-t5": dict(dit_quantize="int8",
                               sd3_quantize_t5="float8_e4m3"),
    "no-t5": dict(include_t5=False, dit_quantize=""),
    "model-from-preferences": dict(ckpt=""),
}


@pytest.mark.parametrize("case", SD3_LOADS)
def test_sd3_factory_loads_as_jax(case, tmp_path, monkeypatch):
    """What `sd3_factory` hands `load_sd3_bundle` for a job's DiT storage,
    T5 storage and include_t5 options, and for a job that names no model
    file (the preferences' sd3_ldm_model under sd3_ldm_model_path): the
    same arguments as JAX's factory, the storage kinds passed on as the job
    gives them ("" as None), nothing loaded."""
    from cremage_tpu.app import backends as JBACKENDS
    from cremage_tpu.core.config import Preferences as JPrefs

    names = dict(sd3_ldm_model_path=str(tmp_path),
                 sd3_ldm_model="sd3_medium.safetensors")
    params = {**SD3_OPTS, "ckpt": str(tmp_path / "job.safetensors"),
              **SD3_LOADS[case]}
    seen = record_loaders(monkeypatch, "load_sd3_bundle")
    with pytest.raises(LookupError):
        JBACKENDS.sd3_factory(JPrefs(**names))(dict(params), lambda m: None,
                                                None)
    with pytest.raises(LookupError):
        sd3_factory(Preferences(**names), device="cpu")()(
            dict(params), lambda m: None, None)
    (j_args, j_kw), (t_args, t_kw) = seen["jax"], seen["port"]
    ckpt = params["ckpt"] or os.path.join(str(tmp_path),
                                          names["sd3_ldm_model"])
    assert t_args == j_args == (ckpt,)
    assert {k: v for k, v in t_kw.items() if k != "device"} == j_kw
    want = (params.get("include_t5", True), params.get("sd3_quantize_t5"),
            params.get("dit_quantize") or None)
    assert (t_kw["include_t5"], t_kw["quantize_t5"],
            t_kw["quantize_dit"]) == want


def test_sd3_sigmas_match_jax():
    """The shift-3 flow sigmas (float64, the trailing 0 appended) at the
    step counts users pick (1, 4, 20, 50) equal JAX's, and so at another
    shift. One looping test: the number of collected items sets the
    suite's wall time (ROADMAP.md)."""
    for steps in (1, 4, 20, 50):
        got = F.sd3_sigmas(steps)
        assert got.shape == (steps + 1,) and got[0] == 1.0 and got[-1] == 0.0
        assert np.array_equal(got, JF.sd3_sigmas(steps)), steps
        assert np.array_equal(F.sd3_sigmas(steps, shift=1.5),
                              JF.sd3_sigmas(steps, shift=1.5)), steps


# a key beside the MMDiT's in an SD3 single file -> the error it raises,
# or None where the key is dropped by name
SD3_STRAY = {
    "sdxl-clip-key": (CK.PREFIX_CLIP_SDXL + "final_layer_norm.weight",
                      "belong to no SD3 component"),
    "sd15-clip-key": (CK.PREFIX_CLIP_SD15 + CK.POSITION_IDS,
                      "belong to no SD3 component"),
    "lora-key": ("lora_unet_joint_blocks_0_x_block_attn_qkv.alpha",
                 "belong to no SD3 component"),
    "clip-l-projection": (next(iter(CK.SD3_DROPPED)), None),
}


@pytest.mark.parametrize("case", SD3_STRAY)
def test_split_sd3_drops_only_named_keys(case):
    """`split_sd3` on an MMDiT key beside one stray key: a key of another
    family's file (SDXL's or SD1.5's CLIP, a LoRA) raises KeyError naming
    it; CLIP-L's projection, which SD3 never uses, is dropped by name and
    reaches no component."""
    key, err = SD3_STRAY[case]
    mm_key = CK.PREFIX_UNET + "x_embedder.proj.bias"
    sd = {mm_key: torch.zeros(4), key: torch.ones(3)}
    if err is not None:
        with pytest.raises(KeyError, match=err) as raised:
            CK.split_sd3(sd)
        assert key in str(raised.value)
        return
    parts = CK.split_sd3(sd)
    assert set(parts[CK.PREFIX_UNET]) == {"x_embedder.proj.bias"}
    assert not any(parts[p] for p in parts if p != CK.PREFIX_UNET)


# (batch, channels, height, width, features) of an int8 2x2 patch embedding
PATCH_SHAPES = {
    "one-patch": (1, 4, 2, 2, 8),       # 1 row, padded for the int8 GEMM
    "16-rows": (1, 16, 8, 8, 64),       # 16 rows, padded too
    "48-rows": (2, 16, 8, 12, 96),
    "bright-and-dim": (3, 4, 6, 10, 48),
}


@pytest.mark.parametrize("case", PATCH_SHAPES)
def test_int8_patch_embedding_matches_jax(case):
    """models/layers.py `PatchConv8bit` alone against the JAX package's
    `Conv` in its w8a8 branch: the port's int8 codes and channel scales
    of the float weights equal JAX's `_quantize_tree`'s, and the output
    equals JAX's bit for bit (both quantize each image at its own max|x|,
    sum exactly in int32 and rescale in the same float32 order), with 1
    to 48 patch rows (the GEMM pads up to 17) and images three decades
    apart in brightness."""
    b, c, h, w, o = PATCH_SHAPES[case]
    rng = np.random.RandomState(b * 1000 + o)
    x = rng.randn(b, h, w, c) * np.array([1.0, 30.0, 0.02])[:b, None, None,
                                                           None]
    x = x.astype(np.float32)
    weight = (rng.randn(2, 2, c, o) / np.sqrt(4 * c)).astype(np.float32)
    bias = (rng.randn(o) * 0.1).astype(np.float32)
    jq = JLOADER._quantize_tree({"proj": {"weight": weight, "bias": bias}},
                                "int8", "patch", min_size=1)["proj"]
    want = JConv(features=o, kernel_size=2, stride=2, padding=0,
                 dtype=jnp.float32).apply({"params": jq}, jnp.asarray(x))

    holder = torch.nn.Module()
    holder.proj = Conv2d(c, o, 2, stride=2)
    with torch.no_grad():
        holder.proj.weight.copy_(torch.from_numpy(
            weight.transpose(3, 2, 0, 1).copy()))
        holder.proj.bias.copy_(torch.from_numpy(bias))
    Q.quantize_module(holder, "int8", min_size=1, include_convs=True)
    conv = holder.proj
    assert isinstance(conv, PatchConv8bit) and conv.weight.dtype == torch.int8
    np.testing.assert_array_equal(
        conv.weight.numpy(), np.asarray(jq["weight"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(conv.weight_scale.numpy().ravel(),
                                  np.asarray(jq["weight_scale"]))
    with torch.no_grad():
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


def test_mmdit_config_matches_jax():
    """`sd3_medium_config` is JAX's field for field (depth 24, hidden 1536,
    24 heads of 64, 2x2 patches of 16 channels, the 192-wide position
    grid, T5's 4096-wide context, the 2048-wide pooled vector, no
    qk-norm); JAX's only other fields are its parameter dtype and the
    sequence-parallel and ToMe options the port refuses."""
    j, p = JMMDITM.sd3_medium_config(), sd3_medium_config()
    names = {f.name for f in dataclasses.fields(p)} - {"dtype"}
    assert {f.name for f in dataclasses.fields(j)} - names == {
        "dtype", "param_dtype", "sp_axis", "tome_ratio"}
    assert {n: getattr(p, n) for n in names} == {n: getattr(j, n)
                                                 for n in names}
    assert (p.depth, p.hidden_size, p.num_heads) == (24, 1536, 24)
