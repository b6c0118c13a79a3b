"""FLUX.1-schnell and 8-bit weight storage: the port against the JAX package.

Four tests, each looping over its cases (under `--dist load` the number of
collected items sets the suite's wall time, ROADMAP.md):

- the FLUX transformer (cremage_tpu_torch/models/flux.py) in float32 with
  full-precision storage ("none", schnell and -dev's guidance),
  float8_e4m3, float8_e5m2 and int8 (w8a8); the port quantizes the JAX
  weights itself (io/quantize.py), and its codes and scales equal JAX's
  `quantize_params_8bit`'s bit for bit, from float32, bf16 and fp16
  weights; the choice of weights, the latent packing and RoPE;
- T5 and the SentencePiece tokenizer on synthetic `spiece.model` protos
  (tests/test_sentencepiece.py's), T5's buckets, and the flow sampler;
- four files in the published layouts through JAX's `load_flux_bundle`
  and the port's, generate() against the JAX pipeline, /v1/generate with
  "FLUX.1-schnell" and the refusals;
- the SD1.5 and SDXL UNets with `unet_quantize` float8 against JAX's UNet
  on its own quantized tree, the factories passing the option on, and
  int8 UNet storage refused.

Each case states its tolerance. The models run in float32 on both sides,
so what differs is the order of float32 sums (and, for int8, the codes of
activations that sit on a rounding boundary).
"""
import base64
import functools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cremage_tpu.core.config import GenerationOptions as JOptions
from cremage_tpu.core.dtypes import FP32_POLICY
from cremage_tpu.core.rng import key_for_image
from cremage_tpu.io.lora import merge_lora as j_merge_lora
from cremage_tpu.io.quantize import quantize_params_8bit
from cremage_tpu.models import flux as JFLUXM
from cremage_tpu.models import t5 as JT5M
from cremage_tpu.models import vae as JVAEM
from cremage_tpu.models.clip import CLIPTextConfig as JCLIPConfig
from cremage_tpu.models.flux import FluxConfig as JFluxConfig
from cremage_tpu.models.flux import FluxModel as JFlux
from cremage_tpu.models.t5 import T5Config as JT5Config
from cremage_tpu.models.t5 import T5Encoder as JT5
from cremage_tpu.models.unet import UNetConfig as JUNetConfig
from cremage_tpu.models.unet import UNetModel as JUNet
from cremage_tpu.pipelines import loader as JLOADER
from cremage_tpu.pipelines.flux import FluxPipeline as JPipeline
from cremage_tpu.prompt.sentencepiece import T5Tokenizer as JT5Tokenizer
from cremage_tpu.samplers import flow as JF
from cremage_tpu_torch.app import backends as BACKENDS
from cremage_tpu_torch.app.backends import ResidentInstance, flux_factory
from cremage_tpu_torch.app.server import ApiServer
from cremage_tpu_torch.app.worker import EngineWorker
from cremage_tpu_torch.core.config import GenerationOptions, Preferences
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import checkpoint as CK
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io import quantize as Q
from cremage_tpu_torch.io.png import decode_png
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.flux import FluxConfig, FluxModel, make_position_ids
from cremage_tpu_torch.models.layers import set_compute_dtype
from cremage_tpu_torch.models.t5 import T5Config, T5Encoder
from cremage_tpu_torch.models.unet import UNetConfig, UNetModel
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.pipelines import loader as LOADER
from cremage_tpu_torch.pipelines.flux import FluxPipeline, check_supported
from cremage_tpu_torch.pipelines.loader import load_flux_bundle, load_sd15_bundle
from cremage_tpu_torch.pipelines.sd15 import check_supported as sd15_check
from cremage_tpu_torch.pipelines.sdxl import check_supported as sdxl_check
from cremage_tpu_torch.prompt.sentencepiece import T5Tokenizer
from cremage_tpu_torch.samplers import flow as F
from tests.conftest import assert_img01_close
from tests.test_sentencepiece import WORDS, encode_model, t5_like_pieces
from tests.test_torch_loader import LORA_WEIGHT, _lora
from tests.test_torch_pipeline import (  # noqa: F401
    CLIP_KW, UNET_KW, VAE_KW, jax_params, cheap_jax, shared_template,
)
from tests.test_torch_sdxl import ADM, CTX
from tests.test_torch_sdxl import UNET_KW as XL_UNET_KW

torch.set_num_threads(2)
F32 = torch.float32
KINDS = ("float8_e4m3", "float8_e5m2", "int8")
MIN = 512          # 8-bit storage's min size at the tiny widths (JAX: 65536)
FLUX_KW = dict(hidden_size=64, num_heads=2, head_dim=32, depth_double=1,
               depth_single=1, context_dim=48, vec_dim=24, axes_dim=(8, 12, 12))
T5_KW = dict(d_model=32, d_kv=8, num_heads=4, d_ff=48, num_layers=2)
TORCH_DTYPES = {jnp.float32: F32, jnp.bfloat16: torch.bfloat16,
                jnp.float16: torch.float16,
                jnp.float8_e4m3fn: torch.float8_e4m3fn, jnp.int32: torch.int32}


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    """As tests/test_torch_modes.py: clear the worker's compiled programs
    before this module's JAX programs run."""
    jax.clear_caches()
    yield


class _WithIds:
    """A FLUX model whose init closes over its host position ids (as JAX's
    loader traces it), for `jax_params`."""

    def __init__(self, model, img_ids, txt_ids):
        self.model, self.ids = model, (img_ids, txt_ids)

    def __repr__(self):
        return f"{self.model!r}{[a.shape for a in self.ids]}"

    def init(self, key, img, txt, t, y, *guidance):
        return self.model.init(key, img, txt, t, y, *self.ids, *guidance)


def _codes_equal(port: torch.nn.Module, want: torch.nn.Module):
    """Every tensor of `port` bit-equal to `want`'s (8-bit codes as bits)."""
    a, b = port.state_dict(), want.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        if Q.is_coded(a[k]):
            assert torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8)), k
        else:
            assert torch.equal(a[k], b[k]), k


def jax_quantize(params, kind, min_size=MIN):
    """JAX's quantize_params_8bit over a tree, eagerly as its loaders call
    it (a jitted one divides by qmax as a product with its reciprocal: its
    scales differ in the last bit)."""
    return quantize_params_8bit(params, dtype=kind, min_size=min_size)[0]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _check_codes_and_choice():
    """Codes bit-equal to JAX's and scales equal, from float32, bf16 and
    fp16 weights (a zero row takes the 1e-12 floor); io/quantize.py's
    choice of weights equals JAX's `should_quantize` on 2-D and 4-D
    leaves around the min size, excluded table names, names other than
    `weight`, already-8-bit and integer leaves; the kinds are JAX's and an
    unknown kind is refused."""
    from cremage_tpu.io.quantize import QUANT_DTYPES as J_KINDS
    from cremage_tpu.io.quantize import should_quantize as j_should

    rng = np.random.RandomState(1)
    w = (rng.randn(48, 40) * np.exp(rng.randn(1, 40))).astype(np.float32)
    w[:, 3] = 0.0                       # an output channel of zeros
    for src in (jnp.float32, jnp.bfloat16, jnp.float16):
        wj = jnp.asarray(w).astype(src)
        wt = torch.from_numpy(np.asarray(wj.astype(jnp.float32)).T.copy()).to(
            TORCH_DTYPES[src])
        for kind in KINDS:
            jq = quantize_params_8bit({"l": {"weight": wj}}, dtype=kind,
                                      min_size=1)[0]["l"]
            codes, scale = Q.quantize_weight(wt, kind)
            want = np.ascontiguousarray(np.asarray(jq["weight"]).T)
            assert codes.view(torch.uint8).numpy().tobytes() == \
                want.view(np.uint8).tobytes(), (src, kind)
            assert np.array_equal(scale.numpy(), np.asarray(jq["weight_scale"]))

    assert {k: v[1] for k, v in Q.QUANT_DTYPES.items()} == \
        {k: v[1] for k, v in J_KINDS.items()}
    assert Q.DEFAULT_EXCLUDE == ("token_embedding", "shared", "wte",
                                 "embed_tokens", "word_embeddings")
    cases = [("blocks/0/attn/weight", (64, 64), jnp.float32),
             ("blocks/0/attn/weight", (63, 64), jnp.bfloat16),
             ("blocks/0/attn/weight", (64, 65), jnp.float16),
             ("blocks/0/conv/weight", (3, 3, 32, 32), jnp.float32),
             ("blocks/0/attn/bias", (4096,), jnp.float32),
             ("blocks/0/attn/kernel", (64, 64), jnp.float32),
             ("shared/weight", (100, 64), jnp.float32),
             ("encoder/embed_tokens/weight", (100, 64), jnp.float32),
             ("blocks/0/q/weight", (64, 64), jnp.float8_e4m3fn),
             ("blocks/0/q/weight", (64, 64), jnp.int32)]
    for path, shape, dt in cases:
        want = j_should(path.rsplit("/", 1)[1], "/" + path, jnp.zeros(shape, dt),
                        min_size=4096, exclude=Q.DEFAULT_EXCLUDE)
        got = Q.should_quantize(path.replace("/", "."),
                                torch.zeros(shape, dtype=TORCH_DTYPES[dt]),
                                min_size=4096)
        assert got == bool(want), (path, shape, dt)
    with pytest.raises(ValueError, match="unknown"):
        Q.check_dtype("float4")


def _check_packing_and_rope():
    """pack_latents / unpack_latents (2x2 patches in (dy, dx, c) order) and
    the position ids equal JAX's, and unpack inverts pack. The host
    float64 RoPE table cast to float32 equals JAX's, and the rotation
    (float32, then cast) agrees to 1e-6 in float32 and exactly in bf16."""
    from cremage_tpu.models.flux import apply_rope as j_rope
    from cremage_tpu.models.flux import make_position_ids as j_ids
    from cremage_tpu.models.flux import pack_latents as j_pack
    from cremage_tpu.models.flux import rope_freqs as j_freqs
    from cremage_tpu.models.flux import unpack_latents as j_unpack
    from cremage_tpu_torch.models.flux import (
        apply_rope, pack_latents, rope_freqs, unpack_latents,
    )

    lat = np.random.RandomState(3).randn(2, 6, 10, 16).astype(np.float32)
    got = pack_latents(torch.from_numpy(lat))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_pack(lat)))
    np.testing.assert_array_equal(
        unpack_latents(got, 6, 10).numpy(),
        np.asarray(j_unpack(jnp.asarray(got.numpy()), 6, 10)))
    assert torch.equal(unpack_latents(got, 6, 10), torch.from_numpy(lat))
    for a, b in zip(make_position_ids(3, 5, 7), j_ids(3, 5, 7)):
        np.testing.assert_array_equal(a, b)

    txt_ids, img_ids = make_position_ids(4, 6, 3)
    ids = np.concatenate([txt_ids, img_ids])
    table = rope_freqs(ids, (8, 12, 12), 10000.0)
    np.testing.assert_array_equal(table, j_freqs(ids, (8, 12, 12), 10000.0))
    x = np.random.RandomState(4).randn(2, len(ids), 3, 32).astype(np.float32)
    np.testing.assert_allclose(
        apply_rope(torch.from_numpy(x), torch.from_numpy(table)).numpy(),
        np.asarray(j_rope(jnp.asarray(x), jnp.asarray(table))), atol=1e-6)
    got = apply_rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(table))
    want = j_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(table))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_flux_model_and_8bit_codes_match_jax():
    """The tiny transformer in float32: schnell and dev (guidance) in full
    precision, schnell in each 8-bit kind. The port quantizes the JAX
    weights itself; its codes and scales equal JAX's bit for bit, and the
    8-bit weights of the JAX tree carry over to the same module. Velocity
    within 1e-4 of its range for the float kinds (float32 sums in another
    order); int8 within 2e-2: an activation code on a rounding boundary
    moves its row by one step of 1/127 of the row's max, and the
    difference runs through both blocks. Then the codes, the choice of
    weights, the packing and RoPE (`_check_codes_and_choice`,
    `_check_packing_and_rope`)."""
    rng = np.random.RandomState(0)
    b, hp, wp, nt = 2, 4, 4, 5
    txt_ids, img_ids = make_position_ids(hp, wp, nt)
    x = rng.randn(b, hp * wp, 64).astype(np.float32)
    txt = rng.randn(b, nt, FLUX_KW["context_dim"]).astype(np.float32)
    t = np.array([0.75, 0.25], np.float32)
    y = rng.randn(b, FLUX_KW["vec_dim"]).astype(np.float32)
    g = np.array([3.5, 3.5], np.float32)
    # the dev model's weights; schnell's are the same without guidance_in
    dev = jax_params(_WithIds(JFlux(JFluxConfig(
        **FLUX_KW, guidance_embed=True, dtype=jnp.float32)), img_ids, txt_ids),
        20, jnp.zeros((1, hp * wp, 64)),
        jnp.zeros((1, nt, FLUX_KW["context_dim"])), jnp.zeros((1,)),
        jnp.zeros((1, FLUX_KW["vec_dim"])), jnp.zeros((1,)))["params"]
    args = [jnp.asarray(a) for a in (x, txt, t, y)]
    applies = {}
    for guidance, kind in ((False, None), (True, None), (False, "float8_e4m3"),
                           (False, "float8_e5m2"), (False, "int8")):
        jm = JFlux(JFluxConfig(**FLUX_KW, guidance_embed=guidance,
                               dtype=jnp.float32))
        params = {k: v for k, v in dev.items()
                  if guidance or k != "guidance_in"}
        jp = params if kind is None else jax_quantize(params, kind)
        # one jitted apply per model: the 8-bit trees retrace it
        apply = applies.setdefault(guidance, jax.jit(
            lambda p, *a, jm=jm: jm.apply(p, *a[:4], img_ids, txt_ids,
                                          *a[4:])))
        want = apply({"params": jp}, *args,
                     *([jnp.asarray(g)] if guidance else []))
        cfg = FluxConfig(**FLUX_KW, guidance_embed=guidance, dtype=F32)
        port = convert.load_from_jax(FluxModel(cfg), params)
        if kind is not None:
            rep = Q.quantize_module(port, kind, min_size=MIN)
            carried = FluxModel(cfg)
            assert Q.prepare_8bit(carried, kind, min_size=MIN) == rep["tensors"]
            _codes_equal(port, convert.load_from_jax(carried, jp))
        with torch.no_grad():
            got = port(torch.from_numpy(x), torch.from_numpy(txt),
                       torch.from_numpy(t), torch.from_numpy(y), img_ids,
                       txt_ids, torch.from_numpy(g) if guidance else None)
        tol = 2e-2 if kind == "int8" else 1e-4
        assert _rel(got.numpy(), want) <= tol, (guidance, kind)

    _check_codes_and_choice()
    _check_packing_and_rope()


def _spiece():
    return encode_model(t5_like_pieces(WORDS, seed=3))


def test_t5_tokenizer_and_flow_sampler_match_jax():
    """Token ids equal on synthetic spiece.model protos (the unigram T5
    vocabulary with sentinels, unknown characters and truncation at 16
    with EOS kept; the same pieces as a BPE model); the tiny T5 encoder on
    them within 1e-5 of its range (float32), and in int8 storage
    (quantized by the port from the same weights, codes bit-equal to
    JAX's) within 1e-2 (activation codes on a rounding boundary); T5's
    bidirectional buckets equal JAX's over relative positions up to +-600
    at T5-XXL's 32 buckets and a narrow 8. The schnell and dev
    (mu-shifted) sigmas equal JAX's (float64), CFG for velocity models
    (`_check_cfg_velocity`), and flow Euler on an analytic velocity is
    within 1e-6 of JAX's scan, the steps reported in order. Then the SDXL
    UNet in float8_e5m2 (`_check_sdxl_unet_8bit`)."""
    from cremage_tpu.models.t5 import relative_position_bucket as j_bucket
    from cremage_tpu_torch.models.t5 import relative_position_bucket

    blob = _spiece()
    ours, ref = T5Tokenizer(blob), JT5Tokenizer(blob)
    prompts = ["the quick brown fox", "a lazy dog, masterpiece <extra_id_3>",
               "Portrait  lighting ÉTÉ 東京", " ".join(WORDS * 3)]
    for p in prompts:
        assert ours.encode(p) == ref.encode(p)
        for a, b in zip(ours(p, max_length=16), ref(p, max_length=16)):
            np.testing.assert_array_equal(a, b)
    bpe = encode_model(t5_like_pieces(WORDS, seed=3), model_type=2)
    for p in prompts:
        assert T5Tokenizer(bpe).encode(p) == JT5Tokenizer(bpe).encode(p), p

    ids = np.stack([ref(p, max_length=16)[0] for p in prompts[:2]])
    jm = JT5(JT5Config(vocab_size=ref.vocab_size, **T5_KW, dtype=jnp.float32))
    params = jax_params(jm, 30, jnp.zeros((1, 16), jnp.int32))["params"]
    cfg = T5Config(vocab_size=ours.vocab_size, **T5_KW, dtype=F32)
    apply = jax.jit(jm.apply)
    for kind in (None, "int8"):
        jp = params if kind is None else jax_quantize(params, kind)
        want = np.asarray(apply({"params": jp}, jnp.asarray(ids)))
        port = convert.load_t5(T5Encoder(cfg), params)
        if kind is not None:
            Q.quantize_module(port, kind, min_size=MIN)
            carried = T5Encoder(cfg)
            Q.prepare_8bit(carried, kind, min_size=MIN)
            _codes_equal(port, convert.load_t5(carried, jp))
        with torch.no_grad():
            got = port(torch.from_numpy(ids.astype(np.int64))).numpy()
        assert _rel(got, want) <= (1e-2 if kind else 1e-5), kind

    rel = np.arange(-600, 601)[None, :] - np.arange(0, 5)[:, None]
    for nb, md in ((32, 128), (8, 20)):
        np.testing.assert_array_equal(relative_position_bucket(rel, nb, md),
                                      j_bucket(rel, nb, md))

    assert np.array_equal(F.flow_sigmas(4), JF.flow_sigmas(4))
    mu = F.flux_mu(4096)
    assert mu == JF.flux_mu(4096)
    assert np.array_equal(F.flow_sigmas(6, mu=mu), JF.flow_sigmas(6, mu=mu))
    assert np.array_equal(F.flow_sigmas(5, shift=3.0), JF.flow_sigmas(5, shift=3.0))
    x = np.random.RandomState(2).randn(2, 16, 64).astype(np.float32)
    _check_cfg_velocity(x)
    _check_sdxl_unet_8bit()
    for sig in (JF.flow_sigmas(4), JF.flow_sigmas(6, mu=mu)):
        seen = []
        with jax.disable_jit():
            want = JF.sample_flow_euler(
                lambda xx, s: xx * (s + 0.5) - 0.3 * jnp.sin(xx),
                jnp.asarray(x), sig)
        got = F.sample_flow_euler(
            lambda xx, s: xx * (s + 0.5) - 0.3 * torch.sin(xx),
            torch.from_numpy(x), sig, seen.append)
        assert seen == list(range(len(sig) - 1))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))


def _check_cfg_velocity(x):
    """CFG for velocity models against JAX's: the conditional model alone
    (no uc, scale 1), the batched [uc; c] guidance with array and dict
    conditionings, and the guidance interval inside and outside; within
    1e-6 of the range (float32)."""
    def v_jax(xx, s, cond):
        c = cond["a"] + cond["b"] if isinstance(cond, dict) else cond
        return xx * s[:, None, None] + jnp.tanh(c)[:, None, :]

    def v_port(xx, s, cond):
        c = cond["a"] + cond["b"] if isinstance(cond, dict) else cond
        return xx * s[:, None, None] + torch.tanh(c)[:, None, :]

    rng = np.random.RandomState(5)
    c, uc = (rng.randn(2, 64).astype(np.float32) for _ in "cu")
    d = {"a": c, "b": 0.5 * uc}
    du = {"a": uc, "b": 0.25 * c}
    to_t = lambda v: ({k: torch.from_numpy(a) for k, a in v.items()}
                      if isinstance(v, dict) else
                      None if v is None else torch.from_numpy(v))
    to_j = lambda v: ({k: jnp.asarray(a) for k, a in v.items()}
                      if isinstance(v, dict) else
                      None if v is None else jnp.asarray(v))
    for cc, ucc, scale, interval, sigma in (
            (c, None, 3.5, None, 0.7), (c, uc, 1.0, None, 0.7),
            (c, uc, 3.5, None, 0.7), (d, du, 2.0, None, 0.4),
            (c, uc, 3.5, (0.2, 0.8), 0.5), (c, uc, 3.5, (0.2, 0.8), 0.9)):
        want = JF.cfg_velocity(v_jax, to_j(cc), to_j(ucc), scale, interval)(
            jnp.asarray(x), jnp.float32(sigma))
        got = F.cfg_velocity(v_port, to_t(cc), to_t(ucc), scale, interval)(
            torch.from_numpy(x), torch.tensor(sigma, dtype=torch.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * float(np.abs(want).max()))


# the tiny FLUX deployment of the file test: JAX's loader traces its
# templates at T5's 4096 and CLIP's 768 widths, so those stay
FILE_FLUX = dict(hidden_size=64, num_heads=2, head_dim=32, depth_double=1,
                 depth_single=1, axes_dim=(8, 12, 12))
FILE_T5 = dict(d_kv=8, num_heads=2, d_ff=32, num_layers=1)
FILE_CLIP = dict(num_layers=1, num_heads=2, intermediate_size=64)
FILE_VAE = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
FLUX_OPTS = dict(prompt="the quick brown fox, masterpiece", H=64, W=64,
                 sampling_steps=2, n_samples=2, n_iter=1, seed=7,
                 safety_check=False, watermark=False)


_jax_template = JLOADER._template    # unpatched, whatever a test swaps in


def _tiny_flux_configs(mp, vocab):
    """Swap both loaders' published configs for the tiny ones (JAX's
    templates memoized, as tests/test_torch_sdxl_loader.py does)."""
    mp.setattr(JLOADER, "_template", shared_template(_jax_template))
    mp.setattr(JFLUXM, "flux_schnell_config",
               lambda **kw: JFluxConfig(guidance_embed=False, **FILE_FLUX, **kw))
    mp.setattr(JT5M, "t5_xxl_config",
               lambda **kw: JT5Config(vocab_size=vocab, **FILE_T5, **kw))
    mp.setattr(JVAEM, "flux_vae_config", lambda **kw: JVAEM.VAEConfig(
        z_channels=16, embed_dim=16, scale_factor=0.3611, shift_factor=0.1159,
        **FILE_VAE, **kw))
    mp.setattr(JLOADER, "CLIPTextConfig",
               lambda **kw: JCLIPConfig(**FILE_CLIP, **kw))
    mp.setattr(LOADER, "flux_schnell_config",
               lambda **kw: FluxConfig(guidance_embed=False, **FILE_FLUX, **kw))
    mp.setattr(LOADER, "t5_xxl_config",
               lambda **kw: T5Config(vocab_size=vocab, **FILE_T5, **kw))
    mp.setattr(LOADER, "flux_vae_config", lambda **kw: VAEConfig(
        z_channels=16, scale_factor=0.3611, shift_factor=0.1159,
        quant_convs=False, **FILE_VAE, **kw))
    mp.setattr(LOADER, "CLIPTextConfig",
               lambda **kw: CLIPTextConfig(**FILE_CLIP, **kw))


def _write_flux_files(root, vocab):
    """Seeded random files in the four published layouts: the BFL
    transformer (bare keys, and a copy under model.diffusion_model.),
    HF's T5 encoder (encoder., the bias table in block 0, the tied
    embed_tokens), BFL's ae.safetensors (no quant convs) and HF's CLIP-L
    (text_model., position_ids), in bf16 as published; and spiece.model."""
    gen = torch.Generator().manual_seed(40)

    def rand(module):
        return {k: (v + 0.1 * torch.randn(v.shape, generator=gen)).to(
            torch.bfloat16) for k, v in module.state_dict().items()}

    torch.manual_seed(41)
    flux = rand(FluxModel(FluxConfig(**FILE_FLUX)))
    t5 = rand(T5Encoder(T5Config(vocab_size=vocab, **FILE_T5)))
    vae = rand(AutoencoderKL(VAEConfig(z_channels=16, quant_convs=False,
                                       **FILE_VAE)))
    clip = rand(CLIPTextModel(CLIPTextConfig(**FILE_CLIP)))
    hf_t5 = {}
    for k, v in t5.items():
        k = CK.T5_BIAS_KEY if k == "relative_attention_bias.weight" else k
        hf_t5["encoder." + k] = v
    hf_t5["encoder.embed_tokens.weight"] = t5["shared.weight"]
    hf_t5["shared.weight"] = hf_t5.pop("encoder.shared.weight")
    paths = {n: str(root / f) for n, f in (
        ("ckpt", "flux1-schnell.safetensors"),
        ("prefixed", "flux1-schnell-prefixed.safetensors"),
        ("t5", "t5xxl.safetensors"), ("vae", "ae.safetensors"),
        ("clip", "clip_l.safetensors"), ("spiece", "spiece.model"))}
    CK.save_safetensors(paths["ckpt"], flux)
    CK.save_safetensors(paths["prefixed"],
                        {CK.PREFIX_UNET + k: v for k, v in flux.items()})
    CK.save_safetensors(paths["t5"], hf_t5)
    CK.save_safetensors(paths["vae"], vae)
    clip = {"text_model." + k: v for k, v in clip.items()}
    clip["text_model." + CK.POSITION_IDS] = torch.arange(77)[None]
    CK.save_safetensors(paths["clip"], clip)
    (root / "spiece.model").write_bytes(_spiece())
    return paths, {"flux": flux, "t5": t5, "vae": vae}


def _check_refusals():
    """deep_cache, ada_cache and tome_ratio raise NotImplementedError, and
    cfg_interval the JAX pipeline's own ValueError, before any model runs;
    the sequence- and pipeline-parallel meshes are not ported."""
    for opt in (dict(deep_cache=2), dict(ada_cache=0.1), dict(tome_ratio=0.3)):
        with pytest.raises(NotImplementedError, match="not ported"):
            check_supported(GenerationOptions(**opt))
    for lo, hi in ((0.0, 1.0), (0.5, 5.0)):
        with pytest.raises(ValueError, match="guidance is distilled"):
            check_supported(GenerationOptions(cfg_interval_low=lo,
                                              cfg_interval_high=hi))
    check_supported(GenerationOptions(deep_cache=1, sampler="LCM",
                                      mode="image_to_image"))
    pipe = FluxPipeline.__new__(FluxPipeline)
    for method in (pipe.use_mesh_sp, pipe.use_mesh_pp):
        with pytest.raises(NotImplementedError, match="not ported"):
            method(None)


def test_files_generate_and_http_match_jax(tmp_path, monkeypatch):
    """Files in the four published layouts through both loaders (fp8-e4m3,
    the default; float32 compute): the port's transformer and T5 codes
    equal JAX's after JAX's own quantization, from the bare and the
    prefixed transformer file. generate() with a T5 tokenizer against the
    JAX pipeline given the same tokenizer, and without one (the JAX
    backend's zero T5 context: its flux_factory passes none), each within
    2/255 (tests/test_torch_pipeline.py's float tolerance), the port
    handed JAX's noise. JAX's loader cannot take BFL's ae.safetensors (no
    quant convs): its VAE gets identity 1x1 quant convs, the same
    function. Then /v1/generate with "FLUX.1-schnell" loads the bundle as
    the JAX backend does (no T5 tokenizer) and gives the resident
    pipeline's own image for the seed; deep_cache is refused as not
    ported, cfg_interval with JAX's error, a job without clip_ckpt before
    any load; /v1/meta lists the model type."""
    import urllib.request

    _check_refusals()
    vocab = T5Tokenizer(_spiece()).vocab_size
    _tiny_flux_configs(monkeypatch, vocab)
    paths, truth = _write_flux_files(tmp_path, vocab)
    jb = JLOADER.load_flux_bundle(
        paths["ckpt"], vae_ckpt=paths["vae"], clip_ckpt=paths["clip"],
        t5_ckpt=paths["t5"], t5_tokenize=paths["spiece"], policy=FP32_POLICY)
    vp = jb.vae_params["params"]
    vp["quant_conv"] = {"weight": jnp.eye(32)[None, None],
                        "bias": jnp.zeros(32)}
    vp["post_quant_conv"] = {"weight": jnp.eye(16)[None, None],
                             "bias": jnp.zeros(16)}

    bundles = {}
    for name, ckpt in (("bare", paths["ckpt"]), ("prefixed", paths["prefixed"])):
        bundles[name] = load_flux_bundle(
            ckpt, vae_ckpt=paths["vae"], clip_ckpt=paths["clip"],
            t5_ckpt=paths["t5"], t5_tokenize=paths["spiece"], device="cpu",
            dtype=F32)
    tb = bundles["bare"]
    cfg = tb.model.cfg
    for b in bundles.values():
        want = FluxModel(cfg)
        Q.prepare_8bit(want, "float8_e4m3")
        _codes_equal(b.model, convert.load_from_jax(want, jb.params["params"]))
    want_t5 = T5Encoder(tb.conditioner.t5.cfg)
    Q.prepare_8bit(want_t5, "float8_e4m3")
    _codes_equal(tb.conditioner.t5, convert.load_t5(
        want_t5, jb.conditioner.t5[1]["params"]))
    for k, v in truth["vae"].items():
        assert torch.equal(tb.vae.state_dict()[k], v.float()), k
    assert tb.load_report["quantize"]["FLUX transformer"]["tensors"] > 0

    jpipe = JPipeline(jb)
    h = w = FLUX_OPTS["H"] // 8
    noise = np.asarray(jax.random.normal(key_for_image(FLUX_OPTS["seed"], 0),
                                         (2, h, w, 16), jnp.float32))
    zero = np.zeros((256, 4096), np.float32)
    for tokenize in (paths["spiece"], None):
        jb.conditioner.t5_tokenize = (None if tokenize is None else
                                      JT5Tokenizer(paths["spiece"]).tokenize_fn(256))
        tb.conditioner.t5_tokenize = (None if tokenize is None else
                                      T5Tokenizer(paths["spiece"]).tokenize_fn(256))
        j_msgs, t_msgs = [], []
        want = jpipe.generate(JOptions(**FLUX_OPTS), status_cb=j_msgs.append)
        got = FluxPipeline(tb, device="cpu").generate(
            GenerationOptions(**FLUX_OPTS), status_cb=t_msgs.append,
            noise=lambda seed, dev: ArrayNoise(noise))
        assert t_msgs == ["encoding prompt", "1 / 2", "2 / 2", "decoding"]
        assert sorted(j_msgs) == sorted(t_msgs)
        txt = tb.conditioner.encode(FLUX_OPTS["prompt"])["txt"].numpy()
        assert (np.array_equal(txt, zero)) == (tokenize is None)
        for (gi, gm), (wi, wm) in zip(got, want):
            assert_img01_close(gi, wi, float_tol=2 / 255)
            assert gm == wm

    # JAX's FLUX backend hands its loader no T5 tokenizer, and the port's
    # backend the same arguments
    from cremage_tpu.app import backends as JBACKENDS
    from cremage_tpu.core.config import Preferences as JPrefs

    files = dict(ckpt=paths["ckpt"], vae_ckpt=paths["vae"],
                 clip_ckpt=paths["clip"], t5_ckpt=paths["t5"])
    seen = {}

    def record(which):
        def load(*args, **kw):
            seen[which] = (args, kw)
            raise LookupError("recorded")
        return load

    monkeypatch.setattr(JLOADER, "load_flux_bundle", record("jax"))
    with pytest.raises(LookupError):
        JBACKENDS.flux_factory(JPrefs())(dict(FLUX_OPTS, **files),
                                         lambda m: None, None)
    with monkeypatch.context() as mp:
        mp.setattr(LOADER, "load_flux_bundle", record("port"))
        with pytest.raises(LookupError):
            flux_factory(Preferences(), device="cpu")()(
                dict(FLUX_OPTS, **files), lambda m: None, None)
    (j_args, j_kw), (t_args, t_kw) = seen["jax"], seen["port"]
    assert t_args == j_args and "t5_tokenize" not in j_kw
    assert {k: v for k, v in t_kw.items() if k != "device"} == j_kw

    with pytest.raises(FileNotFoundError, match="clip_ckpt"):
        load_flux_bundle(paths["ckpt"], vae_ckpt=paths["vae"], device="cpu")

    worker = EngineWorker()
    resident = ResidentInstance()
    worker.register_backend("FLUX.1-schnell", flux_factory(
        Preferences(), device="cpu", resident=resident))
    srv = ApiServer(worker=worker, port=0, upload_dir=str(tmp_path))
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"

    def call(path, body=None):
        req = urllib.request.Request(
            url + path, data=None if body is None else json.dumps(body).encode(),
            method="GET" if body is None else "POST",
            headers={"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    def job(params):
        call("/v1/generate", {"generator_model_type": "FLUX.1-schnell",
                              "mode": "text_to_image", "parameters": params})
        msgs = []
        while not any(isinstance(m, dict) and "job_done" in m for m in msgs):
            got = call("/v1/status")["messages"]
            msgs += got
            if not got:     # leave the GIL to the job's thread
                time.sleep(0.02)
        return msgs

    try:
        assert "FLUX.1-schnell" in call("/v1/meta")["model_types"]
        for bad, err in ((dict(deep_cache=3), "not ported"),
                         (dict(cfg_interval_low=0.1, cfg_interval_high=0.9),
                          "cfg_interval"),
                         (dict(clip_ckpt=None), "clip_ckpt"),
                         (dict(ckpt=None), "FLUX needs local weight files")):
            done = job({**FLUX_OPTS, **files, **bad})[-1]["job_done"]
            assert not done["ok"] and err in done["error"], done
        assert resident.instance is None     # refused before any load
        params = dict(FLUX_OPTS, **files, n_samples=1, seed=9)
        msgs = job(params)
        assert msgs[-1] == {"job_done": {"ok": True, "error": None}}, msgs
        imgs = [m for m in msgs if isinstance(m, dict) and "image_b64" in m]
        rgb, _ = decode_png(base64.b64decode(imgs[0]["image_b64"]))
        pipe = resident.instance
        assert isinstance(pipe, FluxPipeline)
        assert pipe.bundle.model.txt_in.weight.dtype == torch.float8_e4m3fn
        # T5 loaded, no tokenizer: the JAX backend's zero context
        cond = pipe.bundle.conditioner
        assert cond.t5 is not None and cond.t5_tokenize is None
        assert np.array_equal(cond.encode(FLUX_OPTS["prompt"])["txt"].numpy(),
                              zero)
        want = pipe.generate(GenerationOptions.from_dict(params))
        np.testing.assert_array_equal(
            rgb, np.round(want[0][0] * 255).astype(np.uint8))
    finally:
        srv.stop()


def _unet_apply(jm, jp, x, t, ctx, y=None):
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    if y is not None:
        args += (jnp.asarray(y),)
    return np.asarray(jax.jit(jm.apply)({"params": jp}, *args))


def _sd15_file(tmp, up, dtype=F32):
    """A single-file SD1.5 checkpoint in `dtype` whose UNet holds the JAX
    weights `up` (float32), with tiny CLIP and VAE parts."""
    sd = {CK.PREFIX_UNET + k: v for k, v in convert.state_dict_from_jax(
        UNetModel(UNetConfig(**UNET_KW, dtype=F32)), up).items()}
    torch.manual_seed(0)
    for prefix, module in ((CK.PREFIX_VAE, AutoencoderKL(VAEConfig(**VAE_KW))),
                           (CK.PREFIX_CLIP_SD15,
                            CLIPTextModel(CLIPTextConfig(**CLIP_KW)))):
        sd.update({prefix + k: v for k, v in module.state_dict().items()})
    path = str(tmp / f"sd15_tiny_{str(dtype)[6:]}.safetensors")
    CK.save_safetensors(path, {k: v.to(dtype) for k, v in sd.items()})
    return path


def _check_sdxl_unet_8bit():
    """The SDXL UNet (with y) in float8_e5m2: the port's codes of JAX's
    float weights bit-equal to JAX's, and its eps within 1e-4 of its range
    of JAX's UNet on JAX's quantized tree (float32 both; only the sum
    order differs)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    t = np.array([500.0, 20.0], np.float32)
    ctx = rng.randn(2, 77, CTX).astype(np.float32)
    yv = rng.randn(2, ADM).astype(np.float32)
    jx = JUNet(JUNetConfig(**XL_UNET_KW, dtype=jnp.float32))
    xp = jax_params(jx, 11, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                    jnp.zeros((1, 77, CTX)), jnp.zeros((1, ADM)))["params"]
    jq = jax_quantize(xp, "float8_e5m2")
    xl = UNetModel(UNetConfig(**XL_UNET_KW, dtype=F32))
    Q.prepare_8bit(xl, "float8_e5m2", min_size=MIN)
    convert.load_from_jax(xl, jq)
    # the port's own codes of the same float weights are JAX's
    port = convert.load_from_jax(UNetModel(UNetConfig(**XL_UNET_KW, dtype=F32)),
                                 xp)
    Q.quantize_module(port, "float8_e5m2", min_size=MIN)
    _codes_equal(port, xl)
    with torch.no_grad():
        got = xl(torch.from_numpy(x), torch.from_numpy(t),
                 torch.from_numpy(ctx), y=torch.from_numpy(yv))
    ref = _unet_apply(jx, jq, x.transpose(0, 2, 3, 1), t, ctx, yv)
    assert _rel(got.numpy(), ref.transpose(0, 3, 1, 2)) <= 1e-4


def test_unet_8bit_storage_matches_jax(tmp_path, monkeypatch):
    """The repair of `unet_quantize`, which the port's SD1.5 path ignored
    and its SDXL path refused. The SD1.5 UNet loaded from a file with
    unet_quantize float8_e4m3 and float8_e5m2 holds JAX's quantized tree
    exactly; in float8_e4m3 its eps is within 1e-4 of its range of JAX's
    UNet on that tree (float32 both; only the sum order differs). From an
    fp16 file into bf16 storage, and with a LoRA merged first, the codes
    are still JAX's. (The SDXL UNet's float8 forward is
    `_check_sdxl_unet_8bit`, which the T5 test runs: one test for both
    UNets took 20 s.) Both factories hand the
    job's unet_quantize to their loader, as the JAX backends do, and int8
    UNet storage (w8a8 convolutions) is refused by both loaders and
    pipelines."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    t = np.array([500.0, 20.0], np.float32)
    ctx = rng.randn(2, 77, CLIP_KW["hidden_size"]).astype(np.float32)
    jm = JUNet(JUNetConfig(**UNET_KW, dtype=jnp.float32))
    up = jax_params(jm, 10, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                    jnp.zeros((1, 77, CLIP_KW["hidden_size"])))["params"]
    path = _sd15_file(tmp_path, up)
    tiny = dict(device="cpu", dtype=F32, unet_cfg=UNetConfig(**UNET_KW),
                vae_cfg=VAEConfig(**VAE_KW), clip_cfg=CLIPTextConfig(**CLIP_KW))
    # the tiny UNet's linear weights are under MIN_SIZE: the loader takes
    # them all
    monkeypatch.setattr(LOADER, "prepare_8bit",
                        functools.partial(Q.prepare_8bit, min_size=MIN))
    monkeypatch.setattr(LOADER, "quantize_module",
                        functools.partial(Q.quantize_module, min_size=MIN))
    for kind in KINDS[:2]:
        jq = jax_quantize(up, kind)
        bundle = load_sd15_bundle(path, quantize_unet=kind, **tiny)
        want = UNetModel(UNetConfig(**UNET_KW, dtype=F32))
        n = Q.prepare_8bit(want, kind, min_size=MIN)
        assert n > 0 and bundle.load_report["quantize"]["UNet"]["tensors"] == n
        _codes_equal(bundle.unet, convert.load_from_jax(want, jq))
        if kind == "float8_e4m3":
            with torch.no_grad():
                got = bundle.unet(torch.from_numpy(x), torch.from_numpy(t),
                                  torch.from_numpy(ctx))
            ref = _unet_apply(jm, jq, x.transpose(0, 2, 3, 1), t, ctx)
            assert _rel(got.numpy(), ref.transpose(0, 3, 1, 2)) <= 1e-4

    # an fp16 file into bf16 storage: the codes come from the weights
    # rounded to bf16, as JAX quantizes its bf16 parameters (its default
    # policy), not from the file's fp16 values
    bf16 = torch.bfloat16
    bundle = load_sd15_bundle(_sd15_file(tmp_path, up, torch.float16),
                              quantize_unet="float8_e4m3",
                              **dict(tiny, dtype=bf16))
    jq = jax_quantize(jax.tree.map(lambda a: jnp.asarray(
        a, jnp.float16).astype(jnp.bfloat16), up), "float8_e4m3")
    jq = jax.tree.map(lambda a: np.asarray(
        a, np.float32 if a.dtype == jnp.bfloat16 else a.dtype), jq)
    want = set_compute_dtype(UNetModel(UNetConfig(**UNET_KW, dtype=bf16)), bf16)
    Q.prepare_8bit(want, "float8_e4m3", min_size=MIN)
    want = convert.load_from_jax(want, jq).state_dict()
    got = bundle.unet.state_dict()
    coded = [k for k, v in got.items() if Q.is_coded(v)]
    assert coded
    for k in coded:     # (the port keeps its norm parameters in float32)
        assert torch.equal(got[k].view(torch.uint8), want[k].view(torch.uint8)), k
        assert torch.equal(got[k + "_scale"], want[k + "_scale"]), k

    # a LoRA merges first, then the merged weights quantize, as in JAX:
    # codes and scales equal JAX's bit for bit, the merged float weights
    # left out of 8 bits to 1e-6 (tests/test_torch_loader.py)
    lora = _lora(torch.Generator().manual_seed(0))
    CK.save_safetensors(str(tmp_path / "lora.safetensors"), lora)
    merged = jax.tree.map(np.array, up)
    j_merge_lora(merged, None, {k: v.numpy() for k, v in lora.items()},
                 LORA_WEIGHT, JUNetConfig(**UNET_KW))
    jq = jax_quantize(merged, "float8_e4m3")
    bundle = load_sd15_bundle(
        path, loras=[(str(tmp_path / "lora.safetensors"), LORA_WEIGHT)],
        quantize_unet="float8_e4m3", **tiny)
    want = UNetModel(UNetConfig(**UNET_KW, dtype=F32))
    Q.prepare_8bit(want, "float8_e4m3", min_size=MIN)
    want = convert.load_from_jax(want, jq).state_dict()
    for k, v in bundle.unet.state_dict().items():
        if Q.is_coded(v):
            assert torch.equal(v.view(torch.uint8), want[k].view(torch.uint8)), k
        else:
            torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-6)

    # the factories pass the job's unet_quantize to the loader
    seen = {}

    def record(which):
        def load(*args, **kw):
            seen[which] = kw.get("quantize_unet")
            raise LookupError("recorded")
        return load

    for which, factory, sampler in (
            ("load_sd15_bundle", BACKENDS.sd15_factory, "Euler A"),
            ("load_sdxl_bundle", BACKENDS.sdxl_factory, "EulerEDMSampler")):
        with monkeypatch.context() as mp:
            mp.setattr(LOADER, which, record(which))
            with pytest.raises(LookupError):
                factory(Preferences(), device="cpu")()(
                    dict(ckpt=path, sampler=sampler,
                         unet_quantize="float8_e5m2"), lambda m: None, None)
        assert seen[which] == "float8_e5m2", which

    for check in (sd15_check, sdxl_check):
        with pytest.raises(NotImplementedError, match="not ported"):
            check(GenerationOptions(sampler="EulerEDMSampler"
                                    if check is sdxl_check else "Euler A",
                                    extra={"unet_quantize": "int8"}))
    for load in (LOADER.load_sd15_bundle, LOADER.load_sdxl_bundle):
        with pytest.raises(NotImplementedError, match="int8"):
            load(path, device="cpu", quantize_unet="int8")
