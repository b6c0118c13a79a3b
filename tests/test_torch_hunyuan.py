"""Hunyuan-DiT: the port's tokenizer, text towers, DiT, denoiser, pipeline,
key maps, loader, backend, 8-bit storage and path delivery against the
JAX package.

Two tests that loop over their cases (under `--dist load` the number of
collected items sets the suite's wall time, ROADMAP.md), at the JAX tests'
tiny sizes (tests/test_hunyuan_bundle.py: a DiT of hidden 32, depth 4, 4
heads, here with the published mlp_ratio 4.3, so the MLP is int(32 * 4.3)
= 137 wide):

- the modules and generate(): WordPiece, BERT with its mask, mT5, the DiT
  (skips and pool included), the v denoiser and CFG over (BERT, mT5)
  pairs, and HunyuanPipeline.generate against the JAX pipeline with its
  noise;
- files, serving, storage and delivery: files in the published layouts
  through both loaders (JAX given the VAE in the CompVis layout, which is
  the one it reads), `hunyuan_from_diffusers` and `sd_vae_from_diffusers`
  against JAX's, float8_e4m3 and int8 storage against JAX's
  quantization, /v1/generate through `hunyuan_factory` against JAX's
  backend's loader arguments, the refusals, and path delivery with its
  two routes.

Each case states its tolerance.
"""
import base64
import dataclasses
import json
import time
import urllib.error
import urllib.parse
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cremage_tpu.core.config import GenerationOptions as JOptions
from cremage_tpu.core.dtypes import FP32_POLICY
from cremage_tpu.io.diffusers_keys import hunyuan_from_diffusers as j_hy_keys
from cremage_tpu.io.diffusers_keys import sd_vae_from_diffusers as j_vae_keys
from cremage_tpu.models import bert as JBERT
from cremage_tpu.models import hunyuan as JHY
from cremage_tpu.models.t5 import T5Config as JT5Config
from cremage_tpu.models.t5 import T5Encoder as JT5
from cremage_tpu.models.t5 import mt5_xl_config as j_mt5_xl_config
from cremage_tpu.models.vae import AutoencoderKL as JVAE
from cremage_tpu.models.vae import VAEConfig as JVAEConfig
from cremage_tpu.pipelines import hunyuan as JPIPE
from cremage_tpu.pipelines import loader as JLOADER
from cremage_tpu.prompt.wordpiece import WordPieceTokenizer as JWordPiece
from cremage_tpu.samplers import denoiser as JD
from cremage_tpu.samplers import schedules as JS
from cremage_tpu_torch.app import dirs
from cremage_tpu_torch.app.backends import ResidentInstance, hunyuan_factory
from cremage_tpu_torch.app.server import ApiServer
from cremage_tpu_torch.app.worker import EngineWorker
from cremage_tpu_torch.core.config import GenerationOptions, Preferences
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import checkpoint as CK
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io import quantize as Q
from cremage_tpu_torch.io.diffusers_keys import (
    hunyuan_from_diffusers, sd_vae_from_diffusers,
)
from cremage_tpu_torch.io.png import decode_png
from cremage_tpu_torch.models.bert import BertConfig, BertModel, hunyuan_clip_config
from cremage_tpu_torch.models.hunyuan import HunyuanConfig, HunyuanDiT
from cremage_tpu_torch.models.t5 import T5Config, T5Encoder, mt5_xl_config
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.pipelines import loader as LOADER
from cremage_tpu_torch.pipelines.hunyuan import (
    HunyuanBundle, HunyuanPipeline, HunyuanTextEncoder,
)
from cremage_tpu_torch.pipelines.sd3 import check_supported
from cremage_tpu_torch.prompt.wordpiece import WordPieceTokenizer
from cremage_tpu_torch.samplers import schedules as S
from cremage_tpu_torch.samplers.denoiser import VDenoiser, cfg_denoiser
from tests.conftest import assert_img01_close
from tests.test_sentencepiece import WORDS, encode_model, t5_like_pieces
from tests.test_torch_flux import MIN, _codes_equal, _rel
from tests.test_torch_pipeline import (  # noqa: F401
    cheap_jax, jax_noise, jax_params, shared_template,
)
from tests.test_torch_sd3 import record_loaders

torch.set_num_threads(2)
F32 = torch.float32
VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "cat", "photo",
         "of", "the", "##s", "paint", "##ing", "cafe", "tres", "belle", ",",
         "!", ".", "猫", "一", "只", "的", "照", "片", "quick", "##ly", "fox"]
PROMPTS = ["a photo of the cat", "一只猫的照片", "Café paintings, TRÈS belle!",
           "a cat 猫 painting\tquickly\n", "zebra\x00 ", "",
           " ".join(["the quick fox"] * 6)]
HY_KW = dict(hidden_size=32, depth=4, num_heads=4, clip_dim=16, mt5_dim=24,
             pooled_dim=16, mlp_ratio=4.3, text_len=5, text_len_t5=6)
BERT_KW = dict(vocab_size=len(VOCAB) + 8, hidden_size=16, num_layers=2,
               num_heads=2, intermediate_size=32, max_positions=64)
MT5_KW = dict(d_model=24, d_kv=4, num_heads=2, d_ff=32, num_layers=2)
VAE_KW = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1,
              scale_factor=0.13025)
OPTS = dict(prompt="a photo of a cat 猫", negative_prompt="blurry", H=32, W=32,
            sampling_steps=3, n_samples=2, n_iter=1, seed=5, scale=4.0,
            safety_check=False, watermark=False)
SPIECE = encode_model(t5_like_pieces(WORDS, seed=4))


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    """As tests/test_torch_modes.py: clear the worker's compiled programs
    before this module's JAX programs run."""
    jax.clear_caches()
    yield


def _mt5_vocab() -> int:
    from cremage_tpu_torch.prompt.sentencepiece import T5Tokenizer

    return T5Tokenizer(SPIECE).vocab_size


def _jax_models():
    """The tiny JAX DiT, BERT, mT5 and VAE with seeded parameters."""
    dit = JHY.HunyuanDiT(JHY.HunyuanConfig(**HY_KW, dtype=jnp.float32))
    bert = JBERT.BertModel(JBERT.BertConfig(**BERT_KW, dtype=jnp.float32))
    t5 = JT5(JT5Config(vocab_size=_mt5_vocab(), **MT5_KW, dtype=jnp.float32))
    vae = JVAE(JVAEConfig(**VAE_KW, dtype=jnp.float32))
    return {
        "dit": (dit, jax_params(
            dit, 70, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
            jnp.zeros((1, 5, 16)), jnp.zeros((1, 6, 24)))["params"]),
        "bert": (bert, jax_params(bert, 71, jnp.zeros((1, 8), jnp.int32))[
            "params"]),
        "mt5": (t5, jax_params(t5, 72, jnp.zeros((1, 8), jnp.int32))["params"]),
        "vae": (vae, jax_params(vae, 73, jnp.zeros((1, 64, 64, 3)))["params"]),
    }


def _check_wordpiece():
    """Tokens, ids and masks equal to JAX's on mixed Chinese, English and
    accented prompts with tabs, a control character, an unknown word, an
    empty prompt and one truncated at 12 ([SEP] kept), with and without
    padding."""
    ours, ref = WordPieceTokenizer(VOCAB), JWordPiece(VOCAB)
    for p in PROMPTS:
        assert ours.tokenize(p) == ref.tokenize(p), p
        for kw in (dict(max_length=12), dict(max_length=5, padding=False), {}):
            for a, b in zip(ours.encode(p, **kw), ref.encode(p, **kw)):
                np.testing.assert_array_equal(a, b)
    assert ours.tokenize("一只猫的照片") == ["一", "只", "猫", "的", "照", "片"]
    assert ours.tokenize("Café paintings!") == ["cafe", "paint", "##ing", "##s",
                                                "!"]


def _check_towers(jm):
    """BERT's last hidden state and pooled output with the padding masked,
    and mT5's, within 1e-5 of their range of JAX's (float32 sums in
    another order); the published configs JAX's field for field."""
    wp = WordPieceTokenizer(VOCAB)
    enc = [wp.encode(p, max_length=12) for p in PROMPTS[:3]]
    ids, mask = (np.stack([e[i] for e in enc]) for i in (0, 1))
    assert mask.min() == 0                   # some padding is masked
    bert, params = jm["bert"]
    want = jax.jit(bert.apply)({"params": params}, jnp.asarray(ids),
                               jnp.asarray(mask))
    port = convert.load_from_jax(BertModel(BertConfig(**BERT_KW)), params)
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-5

    t5, params = jm["mt5"]
    tids = np.array([[5, 9, 31, 1, 0, 0], [7, 8, 1, 0, 0, 0]], np.int32)
    want = jax.jit(t5.apply)({"params": params}, jnp.asarray(tids))
    port = convert.load_t5(T5Encoder(T5Config(vocab_size=_mt5_vocab(),
                                              **MT5_KW, dtype=F32)), params)
    with torch.no_grad():
        got = port(torch.from_numpy(tids.astype(np.int64)))
    assert _rel(got.numpy(), want) <= 1e-5

    for ours, theirs in ((mt5_xl_config(), j_mt5_xl_config()),
                         (hunyuan_clip_config(), JBERT.hunyuan_clip_config()),
                         (HunyuanConfig(), JHY.HunyuanConfig())):
        names = {f.name for f in dataclasses.fields(ours)} - {"dtype"}
        assert {f.name for f in dataclasses.fields(theirs)} - names == {
            "dtype", "param_dtype"}
        assert {n: getattr(ours, n) for n in names} == {
            n: getattr(theirs, n) for n in names}


def _check_dit_and_denoiser(jm):
    """The DiT on a 4x6 patch grid (its RoPE table over unequal axes, the
    skips of blocks 2 and 3, the pool over 6 + 1 mT5 tokens) within 1e-5
    of its range of JAX's in float32; VDenoiser and CFG over (BERT, mT5)
    pairs on an analytic v within 1e-6 (float32) at three sigmas; mode
    "capture" and the config's ToMe and sequence-parallel options refused."""
    rng = np.random.RandomState(9)
    args = [rng.randn(*s).astype(np.float32)
            for s in ((2, 8, 12, 4), (2, 5, 16), (2, 6, 24))]
    args.insert(1, np.array([750.3, 20.0], np.float32))
    dit, params = jm["dit"]
    want = jax.jit(dit.apply)({"params": params}, *map(jnp.asarray, args))
    port = convert.load_from_jax(HunyuanDiT(HunyuanConfig(**HY_KW, dtype=F32)),
                                 params)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, args))
    assert got.shape == (2, 8, 12, 8) and _rel(got.numpy(), want) <= 1e-5
    assert port.blocks[2].mlp_fc1.out_features == 137
    with pytest.raises(NotImplementedError, match="not ported"):
        port(*map(torch.from_numpy, args), mode="capture")
    for bad in (dict(tome_ratio=0.5), dict(sp_axis="data")):
        with pytest.raises(NotImplementedError, match="not ported"):
            HunyuanDiT(HunyuanConfig(**HY_KW, **bad))

    x = rng.randn(2, 4, 4, 4).astype(np.float32)
    cond = tuple(rng.randn(2, n, 3).astype(np.float32) for n in (5, 6))
    uncond = tuple(rng.randn(2, n, 3).astype(np.float32) for n in (5, 6))

    def v_jax(xx, tt, c):
        return xx * 0.3 + jnp.tanh(tt)[:, None, None, None] * 1e-3 \
            + c[0].mean() - c[1].sum((1, 2))[:, None, None, None] * 0.01

    def v_port(xx, tt, c):
        return xx * 0.3 + torch.tanh(tt)[:, None, None, None] * 1e-3 \
            + c[0].mean() - c[1].sum((1, 2))[:, None, None, None] * 0.01

    jden = jax.jit(JD.cfg_denoiser(
        JD.VDenoiser(v_jax, JS.default_sd_schedule()),
        tuple(map(jnp.asarray, cond)), tuple(map(jnp.asarray, uncond)), 4.0))
    tden = cfg_denoiser(VDenoiser(v_port, S.default_sd_schedule()),
                        tuple(map(torch.from_numpy, cond)),
                        tuple(map(torch.from_numpy, uncond)), 4.0)
    for sigma in (14.6, 1.0, 0.03):
        np.testing.assert_allclose(
            tden(torch.from_numpy(x), sigma).numpy(),
            np.asarray(jden(jnp.asarray(x), sigma)), rtol=1e-6, atol=1e-6)


def _port_bundle(jm) -> HunyuanBundle:
    """The port's bundle on the JAX models' weights, with the WordPiece
    vocabulary and the synthetic spiece.model."""
    dit = convert.load_from_jax(HunyuanDiT(HunyuanConfig(**HY_KW, dtype=F32)),
                                jm["dit"][1])
    vae = convert.load_vae(AutoencoderKL(VAEConfig(**VAE_KW, dtype=F32)),
                           jm["vae"][1])
    bert = convert.load_from_jax(BertModel(BertConfig(**BERT_KW)), jm["bert"][1])
    t5 = convert.load_t5(T5Encoder(T5Config(vocab_size=_mt5_vocab(), **MT5_KW,
                                            dtype=F32)), jm["mt5"][1])
    return HunyuanBundle(dit=dit, vae=vae, text=HunyuanTextEncoder(
        bert, VOCAB, t5, SPIECE, 5, 6, 16, 24))


def test_modules_and_generate_match_jax():
    """The modules (`_check_wordpiece`, `_check_towers`,
    `_check_dit_and_denoiser`), then generate() on the same weights
    against the JAX pipeline, the port handed JAX's noise: the text
    contexts of both branches within 1e-5 of their range; "DDIM" (outside
    the k-diffusion menu: the served default, DPM++ 2M over Karras sigmas;
    the sampling loop with a draw each step is PixArt-Σ's, held against
    JAX by tests/test_torch_pixart.py), images within 2/255 (both round
    the latent to bf16 before the decode, as test_txt2img_matches_jax
    allows), JAX's statuses and metadata."""
    jm = _jax_models()
    _check_wordpiece()
    _check_towers(jm)
    _check_dit_and_denoiser(jm)

    def pair(name):
        return jm[name][0], {"params": jm[name][1]}

    text_encode = JPIPE.make_hunyuan_text_encode(
        pair("bert"), VOCAB, mt5_pair=pair("mt5"), mt5_spiece=SPIECE,
        clip_len=5, mt5_len=6, mt5_dim=24)
    jb = JPIPE.HunyuanBundle(
        dit=jm["dit"][0], dit_params={"params": jm["dit"][1]}, vae=jm["vae"][0],
        vae_params={"params": jm["vae"][1]}, text_encode=text_encode)
    pipe = HunyuanPipeline(_port_bundle(jm), device="cpu")
    for p in (OPTS["prompt"], "the quick fox"):
        for g, w in zip(pipe.bundle.text.encode(p, "cpu"), text_encode(p)):
            assert g.shape == w.shape and _rel(g.numpy(), w) <= 1e-5
    jpipe = JPIPE.HunyuanPipeline(jb)
    b, h, w = OPTS["n_samples"], OPTS["H"] // 8, OPTS["W"] // 8
    opts = dict(OPTS, sampler="DDIM")
    init, _ = jax_noise(opts["seed"], 0, (b, h, w, 4), opts["sampling_steps"])
    j_msgs, t_msgs = [], []
    ref = jpipe.generate(JOptions(**opts), status_cb=j_msgs.append)
    got = pipe.generate(GenerationOptions(**opts), status_cb=t_msgs.append,
                        noise=lambda seed, dev: ArrayNoise(init))
    assert t_msgs == ["encoding prompt", "1 / 3", "2 / 3", "3 / 3", "decoding"]
    assert sorted(j_msgs) == sorted(t_msgs)
    assert len(got) == len(ref) == 2
    for (gi, gm), (wi, wm) in zip(got, ref):
        assert_img01_close(gi, wi, float_tol=2 / 255)
        assert gm == wm


def _diffusers_dit(state: dict) -> dict:
    """The port's HunyuanDiT state dict in diffusers' HunyuanDiT2DModel
    layout (q, k and v apart), the inverse of `hunyuan_from_diffusers`."""
    from cremage_tpu_torch.io.diffusers_keys import _HY_BLOCK, _HY_TOP

    out = {}
    for k, v in state.items():
        if not k.startswith("blocks."):
            theirs, ours = next(p for p in _HY_TOP if k.startswith(p[1]))
            out[theirs + k[len(ours):]] = v
            continue
        i, rest = k[len("blocks."):].split(".", 1)
        base, kind = f"blocks.{i}.", rest.rsplit(".", 1)[-1]
        if rest.startswith(("attn1_qkv.", "attn2_kv.")):
            names = "qkv" if rest.startswith("attn1") else "kv"
            for c, part in zip(names, v.chunk(len(names), 0)):
                out[f"{base}attn{rest[4]}.to_{c}.{kind}"] = part
        else:
            theirs, ours = next(p for p in _HY_BLOCK if rest.startswith(p[1]))
            out[base + theirs + rest[len(ours):]] = v
    return out


def _diffusers_vae(state: dict) -> dict:
    """A CompVis-layout VAE state dict (4 levels) in diffusers'
    AutoencoderKL layout, the inverse of `sd_vae_from_diffusers`."""
    import re

    out = {}
    res = {"nin_shortcut.": "conv_shortcut."}
    attn = {"norm.": "group_norm.", "q.": "to_q.", "k.": "to_k.", "v.": "to_v.",
            "proj_out.": "to_out.0."}
    for k, v in state.items():
        m = re.match(r"^(encoder|decoder)\.mid\.(block_(\d)|attn_1)\.(.+)$", k)
        if m:
            side, _, blk, rest = m.groups()
            if blk:
                a = next((a for a in res if rest.startswith(a)), None)
                rest = res[a] + rest[len(a):] if a else rest
                out[f"{side}.mid_block.resnets.{int(blk) - 1}.{rest}"] = v
            else:
                a = next(a for a in attn if rest.startswith(a))
                if v.ndim == 4 and rest.endswith("weight") and a != "norm.":
                    v = v[:, :, 0, 0]
                out[f"{side}.mid_block.attentions.0.{attn[a]}"
                    f"{rest[len(a):]}"] = v
            continue
        m = re.match(r"^(encoder\.down|decoder\.up)\.(\d)\.(.+)$", k)
        if m:
            where, lv, rest = m.groups()
            pos = lv if where.startswith("encoder") else str(3 - int(lv))
            blocks = "encoder.down_blocks." if where.startswith("encoder") \
                else "decoder.up_blocks."
            rest = re.sub(r"^block\.(\d+)\.", r"resnets.\1.", rest)
            rest = rest.replace("nin_shortcut.", "conv_shortcut.")
            rest = re.sub(r"^(down|up)sample\.conv\.", r"\1samplers.0.conv.", rest)
            out[blocks + pos + "." + rest] = v
            continue
        out[k.replace("norm_out.", "conv_norm_out.")] = v
    return out


def _tiny_loaders(monkeypatch):
    """Both loaders at the tiny configs (JAX's templates memoized)."""
    monkeypatch.setattr(JLOADER, "_template", shared_template(_jax_template))
    monkeypatch.setattr(LOADER, "hunyuan_dit_config",
                        lambda **kw: HunyuanConfig(**HY_KW, **kw))
    monkeypatch.setattr(LOADER, "hunyuan_clip_config",
                        lambda **kw: BertConfig(**BERT_KW, **kw))
    monkeypatch.setattr(LOADER, "mt5_xl_config", lambda **kw: T5Config(
        vocab_size=_mt5_vocab(), **MT5_KW, **kw))
    monkeypatch.setattr(LOADER, "sdxl_vae_config",
                        lambda **kw: VAEConfig(**VAE_KW, **kw))


_jax_template = JLOADER._template    # unpatched, whatever a test swaps in
J_CFGS = dict(dit_cfg=JHY.HunyuanConfig(**HY_KW, dtype=jnp.float32),
              clip_cfg=JBERT.BertConfig(**BERT_KW),
              mt5_cfg=JT5Config(vocab_size=0, **MT5_KW),
              vae_cfg=JVAEConfig(**VAE_KW))


def _write_files(root):
    """Seeded random fp16 component files in the published layouts, as a
    hunyuan_dir names them (the VAE in diffusers' layout), and the VAE in
    the CompVis layout beside them. -> (paths, {component: tensors})."""
    gen = torch.Generator().manual_seed(80)

    def rand(module):
        return {k: (v.float() + 0.1 * torch.randn(v.shape, generator=gen)).half()
                for k, v in module.state_dict().items()}

    torch.manual_seed(81)
    truth = dict(dit=rand(HunyuanDiT(HunyuanConfig(**HY_KW))),
                 bert=rand(BertModel(BertConfig(**BERT_KW))),
                 mt5=rand(T5Encoder(T5Config(vocab_size=_mt5_vocab(), **MT5_KW))),
                 vae=rand(AutoencoderKL(VAEConfig(**VAE_KW))))
    paths = {k: str(root / n) for k, n in (
        ("dit", "transformer.safetensors"), ("vae", "vae.safetensors"),
        ("vae_ldm", "vae_ldm.safetensors"), ("clip", "clip.safetensors"),
        ("vocab", "vocab.txt"), ("mt5", "mt5.safetensors"),
        ("spiece", "spiece.model"))}
    CK.save_safetensors(paths["dit"], _diffusers_dit(truth["dit"]))
    CK.save_safetensors(paths["vae"], _diffusers_vae(truth["vae"]))
    CK.save_safetensors(paths["vae_ldm"], truth["vae"])
    # HF's BertModel as saved by older transformers: the position_ids buffer
    CK.save_safetensors(paths["clip"], dict(truth["bert"], **{
        "embeddings.position_ids": torch.arange(64)[None]}))
    mt5 = {("encoder.block.0.layer.0.SelfAttention.relative_attention_bias."
            "weight" if k == "relative_attention_bias.weight" else
            k if k == "shared.weight" else "encoder." + k): v
           for k, v in truth["mt5"].items()}
    mt5["encoder.embed_tokens.weight"] = truth["mt5"]["shared.weight"]
    CK.save_safetensors(paths["mt5"], mt5)
    (root / "vocab.txt").write_text("\n".join(VOCAB) + "\n", encoding="utf-8")
    (root / "spiece.model").write_bytes(SPIECE)
    return paths, truth


def _check_loaders(paths, truth, jcfgs):
    """The port's bundle from the files: every weight the file's (the DiT
    through `hunyuan_from_diffusers`, equal to JAX's map of the same file;
    the diffusers VAE through `sd_vae_from_diffusers`, equal to JAX's and
    to the CompVis file); JAX's bundle from the same files (its VAE in the
    CompVis layout) carried into the port's modules equal to them; both
    text contexts within 1e-5 of their range of JAX's; the load report
    names every file."""
    tb = LOADER.load_hunyuan_bundle(
        paths["dit"], vae_ckpt=paths["vae"], clip_ckpt=paths["clip"],
        clip_vocab=paths["vocab"], mt5_ckpt=paths["mt5"],
        mt5_tokenize=paths["spiece"], device="cpu", dtype=F32)
    dsd = CK.load_state_dict(paths["dit"])
    want_dit = j_hy_keys({k: v.numpy() for k, v in dsd.items()})
    vsd = CK.load_state_dict(paths["vae"])
    want_vae = j_vae_keys({k: v.numpy() for k, v in vsd.items()})
    for model, want, got_map in (
            (tb.dit, want_dit, hunyuan_from_diffusers(dsd)),
            (tb.vae, want_vae, sd_vae_from_diffusers(vsd))):
        assert set(got_map) == set(want) == set(model.state_dict())
        for k, v in want.items():
            np.testing.assert_array_equal(got_map[k].numpy(), v, err_msg=k)
            assert torch.equal(model.state_dict()[k], torch.from_numpy(v).float())
    for k, v in truth["vae"].items():
        assert torch.equal(tb.vae.state_dict()[k], v.float()), k
    assert set(tb.load_report["files"]) == {paths[k] for k in (
        "dit", "vae", "clip", "mt5")}

    jb = JLOADER.load_hunyuan_bundle(
        paths["dit"], vae_ckpt=paths["vae_ldm"], clip_ckpt=paths["clip"],
        clip_vocab=paths["vocab"], mt5_ckpt=paths["mt5"],
        mt5_tokenize=paths["spiece"], policy=FP32_POLICY, **jcfgs)
    for model, params in ((tb.dit, jb.dit_params["params"]),
                          (tb.vae, jb.vae_params["params"])):
        carried = convert.state_dict_from_jax(model, params)
        for k, v in model.state_dict().items():
            assert torch.equal(carried[k], v), k
    for k, v in truth["bert"].items():
        assert torch.equal(tb.text.bert.state_dict()[k], v.float()), k
    for k, v in truth["mt5"].items():
        assert torch.equal(tb.text.mt5.state_dict()[k], v.float()), k
    for p in ("a photo of the cat", "一只猫"):
        for g, w in zip(tb.text.encode(p, "cpu"), jb.text_encode(p)):
            assert _rel(g.numpy(), w) <= 1e-5
    return tb


def _check_storage(paths, jcfgs):
    """float8_e4m3 and int8 storage of the DiT: the port's codes and scales
    bit-equal to JAX's `_quantize_tree` of its loaded parameters, as many
    tensors (the int8 patch embedding among them at the tiny width, where
    it reaches the min size; at the published width its 22,528 elements do
    not). The int8 DiT's output within 2e-2 of its range of JAX's
    (activation codes on a rounding boundary, as tests/test_torch_flux.py
    allows): its MLP's 137 columns and rows are not a multiple of 8, which
    cuBLAS's int8 product needs, so the port pads the operands with zeros
    (exact in int32)."""
    rng = np.random.RandomState(10)
    args = [rng.randn(*s).astype(np.float32)
            for s in ((1, 8, 8, 4), (1,), (1, 5, 16), (1, 6, 24))]
    args[1] = np.array([321.0], np.float32)
    for kind in ("float8_e4m3", "int8"):
        tb = LOADER.load_hunyuan_bundle(
            paths["dit"], vae_ckpt=paths["vae"], quantize_dit=kind,
            quantize_min_size=MIN, device="cpu", dtype=F32)
        jb = JLOADER.load_hunyuan_bundle(
            paths["dit"], vae_ckpt=paths["vae_ldm"], quantize_dit=kind,
            quantize_min_size=MIN, policy=FP32_POLICY, **jcfgs)
        carried = HunyuanDiT(HunyuanConfig(**HY_KW, dtype=F32))
        n = Q.prepare_8bit(carried, kind, min_size=MIN,
                           include_convs=kind == "int8")
        _codes_equal(tb.dit, convert.load_from_jax(carried,
                                                   jb.dit_params["params"]))
        assert tb.load_report["quantize"]["Hunyuan DiT"]["tensors"] == n
        assert (tb.dit.x_embedder.proj.weight.dtype == torch.int8) == (
            kind == "int8")
        if kind == "int8":
            assert tb.dit.blocks[2].mlp_fc1.weight.dtype == torch.int8
            want = jax.jit(jb.dit.apply)(jb.dit_params, *map(jnp.asarray, args))
            with torch.no_grad():
                got = tb.dit(*map(torch.from_numpy, args))
            assert _rel(got.numpy(), want) <= 2e-2
    assert 22528 < Q.MIN_SIZE == 65536          # 1408 * 4 * 2 * 2


def _check_refusals(paths):
    """What the port refuses before any load: the speed features and the
    guidance interval (check_supported), the meshes, a load without
    vae_ckpt (JAX decodes with an all-zero VAE), a diffusers key it does
    not know."""
    for bad in (dict(deep_cache=2), dict(ada_cache=0.1), dict(tome_ratio=0.3),
                dict(cfg_interval_low=0.2, cfg_interval_high=0.8)):
        with pytest.raises(NotImplementedError, match="not ported"):
            check_supported(GenerationOptions(**bad))
    pipe = HunyuanPipeline.__new__(HunyuanPipeline)
    for method in (pipe.use_mesh_sp, pipe.use_mesh_pp):
        with pytest.raises(NotImplementedError, match="not ported"):
            method(None)
    with pytest.raises(FileNotFoundError, match="vae_ckpt"):
        LOADER.load_hunyuan_bundle(paths["dit"], device="cpu")
    sd = dict(CK.load_state_dict(paths["dit"]))
    sd["time_extra_emb.style_embedder.weight"] = torch.zeros(2, 3)
    with pytest.raises(KeyError, match="unknown key"):
        hunyuan_from_diffusers(sd)


def _http(port, path, body=None, raw=False):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        data = r.read()
        return (data, r.headers["Content-Type"]) if raw else json.loads(data)


def _job(port, params):
    _http(port, "/v1/generate", {"generator_model_type": "Hunyuan DiT",
                                 "mode": "text_to_image", "parameters": params})
    msgs = []
    while not any(isinstance(m, dict) and "job_done" in m for m in msgs):
        got = _http(port, "/v1/status")["messages"]
        msgs += got
        if not got:     # leave the GIL to the job's thread
            time.sleep(0.02)
    return msgs


def test_files_serving_storage_and_delivery_match_jax(tmp_path, monkeypatch):
    """Files in the published layouts through both loaders
    (`_check_loaders`), 8-bit storage (`_check_storage`), the refusals
    (`_check_refusals`); then /v1/generate with "Hunyuan DiT": the port's
    factory hands its loader JAX's backend's arguments for a job that names
    hunyuan_dir and for one that names each file, and both give JAX's
    error without a transformer; a job served from hunyuan_dir is the
    resident pipeline's own image for the seed under JAX's resident key;
    with result_delivery "path" the PNG lands under the app root (HOME is
    the test's), its bytes those of the inline result, /v1/images/file
    serves them as image/png and /v1/images/meta its parameters, and a
    path outside the root, or missing, is 404."""
    from cremage_tpu.app import backends as JBACKENDS
    from cremage_tpu.app.worker import EngineWorker as JWorker
    from cremage_tpu.core.config import Preferences as JPrefs

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    files = tmp_path / "hunyuan"
    files.mkdir()
    paths, truth = _write_files(files)
    _tiny_loaders(monkeypatch)
    jcfgs = dict(J_CFGS, mt5_cfg=dataclasses.replace(
        J_CFGS["mt5_cfg"], vocab_size=_mt5_vocab()))
    tb = _check_loaders(paths, truth, jcfgs)
    _check_storage(paths, jcfgs)
    _check_refusals(paths)

    base = dict(OPTS, n_samples=1, seed=9, dit_quantize="none")
    explicit = dict(base, ckpt=paths["dit"], vae_ckpt=paths["vae"],
                    clip_ckpt=paths["clip"], clip_vocab=paths["vocab"],
                    mt5_ckpt=paths["mt5"], mt5_spiece=paths["spiece"])
    for params in (dict(base, hunyuan_dir=str(files)), explicit,
                   dict(base, hunyuan_dir=str(tmp_path))):
        with monkeypatch.context() as mp:
            seen = record_loaders(mp, "load_hunyuan_bundle")
            jw = JWorker()
            JBACKENDS.register_default_backends(jw, JPrefs())
            errors = []
            for gen in (jw._factories["Hunyuan DiT"](),
                        hunyuan_factory(Preferences(), device="cpu")()):
                with pytest.raises((LookupError, FileNotFoundError)) as e:
                    gen(dict(params), lambda m: None, None)
                errors.append((e.type, str(e.value)))
        if errors[0][0] is FileNotFoundError:      # no transformer there
            assert errors[1] == errors[0] and not seen
            continue
        (j_args, j_kw), (t_args, t_kw) = seen["jax"], seen["port"]
        assert t_args == j_args == (paths["dit"],)
        assert {k: v for k, v in t_kw.items() if k != "device"} == j_kw
        assert j_kw["mt5_tokenize"] == paths["spiece"]

    worker, resident = EngineWorker(), ResidentInstance()
    worker.register_backend("Hunyuan DiT", hunyuan_factory(
        Preferences(), device="cpu", resident=resident))
    srv = ApiServer(worker=worker, port=0, upload_dir=str(tmp_path))
    srv.start()
    try:
        root = dirs.app_root()
        assert worker.save_root == root == str(tmp_path / "home" / ".cremage_tpu")
        assert "Hunyuan DiT" in _http(srv.port, "/v1/meta")["model_types"]
        done = _job(srv.port, dict(base, hunyuan_dir=str(files),
                                   tome_ratio=0.5))[-1]["job_done"]
        assert not done["ok"] and "not ported" in done["error"]
        assert resident.instance is None     # refused before any load
        params = dict(base, hunyuan_dir=str(files))
        inline = _job(srv.port, params)
        assert inline[-1] == {"job_done": {"ok": True, "error": None}}, inline
        img = next(m for m in inline if isinstance(m, dict) and "image_b64" in m)
        png = base64.b64decode(img["image_b64"])
        assert resident.key == ("hunyuan", paths["dit"], paths["vae"],
                                paths["clip"], paths["vocab"], paths["mt5"],
                                paths["spiece"], "none")
        want = resident.instance.generate(GenerationOptions.from_dict(params))
        np.testing.assert_array_equal(
            decode_png(png)[0], np.round(want[0][0] * 255).astype(np.uint8))

        msgs = _job(srv.port, dict(params, result_delivery="path"))
        got = next(m for m in msgs if isinstance(m, dict) and "image_path" in m)
        assert set(got) == {"image_path", "generation_parameters"}
        assert got["image_path"].startswith(str(tmp_path / "home" / ".cremage_tpu"
                                                / "outputs"))
        with open(got["image_path"], "rb") as f:
            assert f.read() == png
        q = urllib.parse.quote(got["image_path"])
        assert _http(srv.port, f"/v1/images/file?path={q}", raw=True) == (
            png, "image/png")
        assert _http(srv.port, f"/v1/images/meta?path={q}") == {
            "generation_data": json.loads(got["generation_parameters"])}
        for outside in (paths["dit"], got["image_path"] + ".missing",
                        root + "/../../hunyuan/vocab.txt"):
            for route in ("file", "meta"):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _http(srv.port, f"/v1/images/{route}?path="
                          f"{urllib.parse.quote(outside)}")
                assert e.value.code == 404
    finally:
        srv.stop()
