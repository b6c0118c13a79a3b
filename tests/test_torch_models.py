"""The port's models and text path against the JAX package, module by
module, on the tiny configs of tests/test_pipeline_sd15.py.

Every JAX parameter tree is perturbed with seeded noise (so biases and
norm affines are not the init's zeros and ones) and carried into the port
by cremage_tpu_torch/io/convert.py. Everything runs in float32 on the CPU;
tolerances are float32 noise of the summation order, grown with depth.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cremage_tpu.models import layers as JL
from cremage_tpu.models.clip import CLIPTextConfig as JCLIPConfig
from cremage_tpu.models.clip import CLIPTextModel as JCLIP
from cremage_tpu.models.clip import hidden_state_for_clip_skip as j_clip_skip
from cremage_tpu.models.unet import UNetConfig as JUNetConfig
from cremage_tpu.models.unet import UNetModel as JUNet
from cremage_tpu.models.vae import AutoencoderKL as JVAE
from cremage_tpu.models.vae import VAEConfig as JVAEConfig
from cremage_tpu.models.vae import decode_from_latent as j_decode
from cremage_tpu.pipelines.conditioning import TextEncoder as JTextEncoder
from cremage_tpu.prompt.parser import compute_prompt_score as j_score
from cremage_tpu.prompt.tokenizer import default_tokenizer as j_tokenizer
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.models import layers as L
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.clip import hidden_state_for_clip_skip
from cremage_tpu_torch.models.unet import UNetConfig, UNetModel
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.models.vae import decode_from_latent, encode_to_latent
from cremage_tpu_torch.pipelines.conditioning import TextEncoder
from cremage_tpu_torch.prompt.parser import compute_prompt_score
from cremage_tpu_torch.prompt.tokenizer import default_tokenizer
from tests.test_torch_pipeline import jax_params, cheap_jax  # noqa: F401

torch.set_num_threads(2)

HID = 32
UNET_KW = dict(in_channels=4, out_channels=4, model_channels=32,
               num_res_blocks=1, attention_resolutions=(1,), channel_mult=(1, 2),
               num_heads=4, transformer_depth=(1, 1), transformer_depth_middle=1,
               context_dim=HID)
VAE_KW = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
CLIP_KW = dict(hidden_size=HID, num_layers=2, num_heads=4, intermediate_size=64)


def perturbed(params, seed):
    """numpy copy of a JAX parameter tree with seeded noise added."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p) + 0.1 * rng.randn(*np.shape(p))).astype(
            np.float32), params)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def clip_pair(seed=2):
    j = JCLIP(JCLIPConfig(**CLIP_KW, dtype=jnp.float32))
    p = jax_params(j, seed, jnp.zeros((1, 77), jnp.int32))
    t = convert.load_clip(CLIPTextModel(CLIPTextConfig(**CLIP_KW,
                                                       dtype=torch.float32)),
                          p["params"])
    return j, p, t.eval()


# ----------------------------------------------------------------- layers

def test_layers_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 6, 6, 8).astype(np.float32)
    conv = JL.Conv(16, kernel_size=3, stride=2, dtype=jnp.float32)
    pc = perturbed(conv.init(jax.random.key(0), jnp.asarray(x)), 1)
    tconv = convert.load_from_jax(L.Conv2d(8, 16, 3, stride=2, padding=1),
                                  pc["params"])
    np.testing.assert_allclose(
        tconv(nchw(x)).permute(0, 2, 3, 1).detach().numpy(),
        np.asarray(conv.apply(pc, jnp.asarray(x))), atol=1e-5, rtol=1e-5)

    t = rng.randn(3, 5, 8).astype(np.float32)
    dense = JL.Dense(12, dtype=jnp.float32)
    pd = perturbed(dense.init(jax.random.key(1), jnp.asarray(t)), 2)
    tdense = convert.load_from_jax(L.Linear(8, 12), pd["params"])
    np.testing.assert_allclose(tdense(torch.from_numpy(t)).detach().numpy(),
                               np.asarray(dense.apply(pd, jnp.asarray(t))),
                               atol=1e-5, rtol=1e-5)

    ln = JL.LayerNorm()
    pl = perturbed(ln.init(jax.random.key(2), jnp.asarray(t)), 3)
    tln = convert.load_from_jax(L.LayerNorm(8), pl["params"])
    np.testing.assert_allclose(tln(torch.from_numpy(t)).detach().numpy(),
                               np.asarray(ln.apply(pl, jnp.asarray(t))),
                               atol=1e-5, rtol=1e-5)

    np.testing.assert_allclose(L.quick_gelu(torch.from_numpy(t)).numpy(),
                               np.asarray(JL.quick_gelu(jnp.asarray(t))),
                               atol=1e-6, rtol=1e-6)
    ts = np.array([0.0, 1.5, 999.0], np.float32)
    for dim in (32, 33):
        np.testing.assert_allclose(
            L.timestep_embedding(torch.from_numpy(ts), dim).numpy(),
            np.asarray(JL.timestep_embedding(jnp.asarray(ts), dim)),
            atol=1e-5, rtol=1e-5)


# -------------------------------------------------------------- tokenizer

@pytest.mark.parametrize("text", [
    "a photograph of an astronaut riding a horse, 4k!!",
    "It's the cat's pajamas -- (masterpiece:1.2) <|endoftext|> x<|startoftext|>",
    "Café naïve façade, ½ cup of x² and 3.14159…",
    "日本語のテキスト 中文 한국어 — emoji 😀👍🏽 ok",
    "tabs\tand\nnewlines   and   nbsp   Ǆ ǅ ﬁ ß İ",
    "",
])
def test_tokenizer_matches_jax(text):
    ours, ref = default_tokenizer(), j_tokenizer()
    assert ours.encode(text) == ref.encode(text)
    assert ours.encode_with_specials(text) == ref.encode_with_specials(text)


@pytest.mark.parametrize("prompt", [
    "a (red:1.3) cat on ((a mat)) BREAK [sky]",
    "abc<embedding:hello.bin>xyz (unclosed group",
])
def test_prompt_score_matches_jax(prompt):
    assert compute_prompt_score(prompt) == j_score(prompt)


# ------------------------------------------------------------------- CLIP

@pytest.mark.parametrize("clip_skip", [1, 2])
def test_clip_inputs_embeds_and_clip_skip_match_jax(clip_skip):
    j, p, t = clip_pair()
    emb = np.random.RandomState(4).randn(1, 77, HID).astype(np.float32) * 0.3
    j_last, j_hidden, _ = j.apply(p, inputs_embeds=jnp.asarray(emb))
    with torch.no_grad():
        t_last, t_hidden = t(inputs_embeds=torch.from_numpy(emb))
    assert len(t_hidden) == len(j_hidden) == CLIP_KW["num_layers"] + 1
    np.testing.assert_allclose(
        hidden_state_for_clip_skip(t_hidden, clip_skip).numpy(),
        np.asarray(j_clip_skip(j_hidden, clip_skip)), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("prompt,negative", [
    ("a (photograph:1.3) of an ((astronaut)) riding a horse", "blurry"),
    (", ".join(f"word{i} (thing{i}:0.8)" for i in range(30)), ""),
], ids=["weighted", "multi-chunk"])
def test_text_encoder_encode_pair_matches_jax(prompt, negative):
    j, p, t = clip_pair()
    want = JTextEncoder(j, p, j_tokenizer()).encode_pair(prompt, negative)
    enc = TextEncoder(t, default_tokenizer())
    got = enc.encode_pair(prompt, negative)
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    assert (got[0].shape[0] > 77) == (len(prompt) > 200)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5, rtol=2e-5)
    assert enc.encode(prompt) is enc.encode(prompt)      # memoized


def test_text_encoder_filler_follows_clip_skip():
    # the JAX encoder keeps the filler of its first clip_skip for every
    # later one; the port encodes it at each job's clip_skip, which a
    # fresh JAX encoder asked first at clip_skip 2 gives
    j, p, t = clip_pair()
    enc = TextEncoder(t, default_tokenizer())
    enc.filler(1)
    want = JTextEncoder(j, p, j_tokenizer()).filler(2)
    np.testing.assert_allclose(enc.filler(2), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


# ------------------------------------------------------------ UNet and VAE

@functools.lru_cache(maxsize=1)
def unet_params():
    j = JUNet(JUNetConfig(**UNET_KW, dtype=jnp.float32))
    return j, jax_params(j, 5, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                         jnp.zeros((1, 77, HID)))


def test_unet_matches_jax():
    j, p = unet_params()
    t = convert.load_from_jax(
        UNetModel(UNetConfig(**UNET_KW, dtype=torch.float32)),
        p["params"]).eval()
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ts = np.array([10.5, 700.0], np.float32)
    ctx = rng.randn(2, 154, HID).astype(np.float32)
    want = jax.jit(j.apply)(p, jnp.asarray(x), jnp.asarray(ts),
                            jnp.asarray(ctx))
    with torch.no_grad():
        got = t(nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-4, rtol=1e-4)


def test_vae_decoder_matches_jax():
    cfg = JVAEConfig(**VAE_KW, dtype=jnp.float32)
    j = JVAE(cfg)
    p = jax_params(j, 7, jnp.zeros((1, 64, 64, 3)))
    t = convert.load_vae(
        AutoencoderKL(VAEConfig(**VAE_KW, dtype=torch.float32)),
        p["params"]).eval()
    z = np.random.RandomState(8).randn(2, 8, 8, 4).astype(np.float32) * 0.2
    want = j_decode(j, p, jnp.asarray(z))
    with torch.no_grad():
        got = decode_from_latent(t, torch.from_numpy(z))
    assert got.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_convert_rejects_missing_and_unused_keys():
    p = unet_params()[1]["params"]
    port = UNetModel(UNetConfig(**UNET_KW, dtype=torch.float32))
    missing = {k: v for k, v in p.items() if k != "out_2"}
    with pytest.raises(KeyError, match="missing"):
        convert.load_from_jax(port,missing)
    extra = dict(p, label_emb_0_0={"weight": np.zeros((4, 4), np.float32)})
    with pytest.raises(KeyError, match="unused"):
        convert.load_from_jax(port,extra)
    wrong = dict(p, out_2=dict(p["out_2"], bias=np.zeros(5, np.float32)))
    with pytest.raises(ValueError, match="does not convert"):
        convert.load_from_jax(port,wrong)


def test_set_compute_dtype_keeps_norms_float32():
    m = UNetModel(UNetConfig(**UNET_KW))
    L.set_compute_dtype(m, torch.bfloat16)
    dtypes = {n: p.dtype for n, p in m.named_parameters()}
    assert dtypes["input_blocks.1.0.in_layers.2.weight"] == torch.bfloat16
    assert dtypes["input_blocks.1.0.in_layers.0.weight"] == torch.float32
    assert dtypes["input_blocks.1.1.transformer_blocks.0.norm1.weight"] == \
        torch.float32
    assert dataclasses.asdict(m.cfg)["dtype"] == torch.bfloat16


def test_kernel_call_sites_pass_what_the_kernels_take(monkeypatch):
    """The CUDA kernels refuse strided views, which the CPU plain versions
    would accept: check every K1/K2 call of the UNet, of the VAE's encoder
    and decoder, of FLUX's double and single blocks (the single block's v
    is a slice of linear1's output), and of SVD's video UNet at one and
    two videos (a (3, 1, 1) convolution's output over one video is a
    strided view once its frames are put back first), ViT-H tower, SD3's
    MMDiT, PixArt-Σ, Hunyuan-DiT, and Kandinsky 2.2's decoder UNet (keys
    and values concatenated from the context's and the stream's
    projections) and MoVQ (its SpatialNorms and mid attention) here."""
    from cremage_tpu_torch.models import clip_vision as CV
    from cremage_tpu_torch.models import flux as FX
    from cremage_tpu_torch.models import mmdit as MM
    from cremage_tpu_torch.models import pixart as PXM
    from cremage_tpu_torch.models import open_clip as OC
    from cremage_tpu_torch.models import unet as U
    from cremage_tpu_torch.models import vae as V
    from cremage_tpu_torch.models import video_unet as VU
    from cremage_tpu_torch.ops import attention as A

    calls = {"attn": 0, "gn": 0}

    def attn(q, k, v, **kw):
        assert all(t.is_contiguous() for t in (q, k, v))
        calls["attn"] += 1
        return A.attention(q, k, v, **kw)

    plain_gn = L.group_norm_silu

    def gn(x, *a, **kw):
        assert x.is_contiguous()
        calls["gn"] += 1
        return plain_gn(x, *a, **kw)

    monkeypatch.setattr(U, "attention", attn)
    monkeypatch.setattr(V, "attention", attn)
    monkeypatch.setattr(FX, "attention", attn)
    monkeypatch.setattr(OC, "attention", attn)
    monkeypatch.setattr(L, "group_norm_silu", gn)
    unet = UNetModel(UNetConfig(**UNET_KW, dtype=torch.float32)).eval()
    vae = AutoencoderKL(VAEConfig(**VAE_KW, dtype=torch.float32)).eval()
    with torch.no_grad():
        unet(torch.randn(2, 4, 8, 8), torch.tensor([1.0, 2.0]),
             torch.randn(2, 77, HID))
        decode_from_latent(vae, torch.randn(1, 8, 8, 4))
        encode_to_latent(vae, torch.rand(1, 64, 64, 3) * 2 - 1,
                         lambda shape: torch.randn(shape))
    count = lambda m, kind: sum(isinstance(x, kind) for x in m.modules())
    assert calls["attn"] == count(unet, U.CrossAttention) + 2 == 10
    assert calls["gn"] == count(unet, L.GroupNorm) + count(vae, L.GroupNorm)

    flux = FX.FluxModel(FX.FluxConfig(
        hidden_size=64, num_heads=2, head_dim=32, depth_double=2,
        depth_single=3, context_dim=48, vec_dim=24, axes_dim=(8, 12, 12),
        dtype=torch.float32)).eval()
    txt_ids, img_ids = FX.make_position_ids(2, 3, 5)
    calls["attn"] = 0
    with torch.no_grad():
        flux(torch.randn(1, 6, 64), torch.randn(1, 5, 48), torch.tensor([0.5]),
             torch.randn(1, 24), img_ids, txt_ids)
    assert calls["attn"] == count(flux, FX.DoubleBlock) + \
        count(flux, FX.SingleBlock) == 5

    video = VU.VideoUNet(UNetConfig(
        in_channels=8, out_channels=4, model_channels=32, num_res_blocks=1,
        attention_resolutions=(1,), channel_mult=(1, 2), num_heads=-1,
        num_head_channels=8, context_dim=16, adm_in_channels=768,
        use_linear_in_transformer=True, dtype=torch.float32), 3).eval()
    vit = CV.CLIPVisionModel(CV.CLIPVisionConfig(
        image_size=28, width=32, num_layers=2, num_heads=4, output_dim=16,
        dtype=torch.float32)).eval()
    for videos in (1, 2):
        calls.update(attn=0, gn=0)
        n = 3 * videos
        with torch.no_grad():
            video(torch.randn(n, 8, 8, 8), torch.ones(n),
                  torch.randn(n, 1, 16), torch.randn(n, 768))
        assert calls["attn"] == count(video, U.CrossAttention) == 12
        assert calls["gn"] == count(video, L.GroupNorm)
    calls["attn"] = 0
    with torch.no_grad():
        vit(torch.rand(2, 28, 28, 3))
    assert calls["attn"] == count(vit, OC._Attention) == 2

    # SD3's joint blocks (with and without the qk-norm) and PixArt's self-
    # and cross-attention (q, k and v are slices of fused projections)
    monkeypatch.setattr(MM, "attention", attn)
    monkeypatch.setattr(PXM, "attention", attn)
    for qk_norm in (False, True):
        mmdit = MM.MMDiT(MM.MMDiTConfig(
            depth=2, hidden_size=64, num_heads=2, context_dim=48, pooled_dim=40,
            pos_embed_max_size=8, qk_norm=qk_norm, dtype=torch.float32)).eval()
        calls["attn"] = 0
        with torch.no_grad():
            mmdit(torch.randn(2, 4, 6, 16), torch.tensor([1.0, 2.0]),
                  torch.randn(2, 5, 48), torch.randn(2, 40))
        assert calls["attn"] == count(mmdit, MM.JointBlock) == 2
    pixart = PXM.PixArt(PXM.PixArtConfig(depth=2, hidden_size=144, num_heads=2,
                                         context_dim=48,
                                         dtype=torch.float32)).eval()
    calls["attn"] = 0
    with torch.no_grad():
        pixart(torch.randn(2, 4, 6, 4), torch.tensor([1.0, 2.0]),
               torch.randn(2, 5, 48))
    assert calls["attn"] == 2 * count(pixart, PXM.PixArtBlock) == 4

    # Hunyuan-DiT's self-attention (v a slice of the fused qkv), its
    # cross-attention (k and v slices of the fused kv) and its pool
    from cremage_tpu_torch.models import hunyuan as HY

    monkeypatch.setattr(HY, "attention", attn)
    hunyuan = HY.HunyuanDiT(HY.HunyuanConfig(
        hidden_size=32, depth=4, num_heads=4, clip_dim=16, mt5_dim=24,
        pooled_dim=16, text_len=5, text_len_t5=6, dtype=torch.float32)).eval()
    calls["attn"] = 0
    with torch.no_grad():
        hunyuan(torch.randn(2, 4, 6, 4), torch.tensor([1.0, 2.0]),
                torch.randn(2, 5, 16), torch.randn(2, 6, 24))
    assert calls["attn"] == 2 * count(hunyuan, HY.HunyuanBlock) + 1 == 9

    # Kandinsky 2.2's decoder UNet over a 8x6 latent (4x3 below the
    # downsampling resnet) and MoVQ over a 4x6 one
    from cremage_tpu_torch.models import kandinsky_decoder as KD
    from cremage_tpu_torch.models import vq as VQ

    monkeypatch.setattr(KD, "attention", attn)
    monkeypatch.setattr(VQ, "attention", attn)
    kd = KD.KandinskyUNet(KD.KandinskyUNetConfig(
        block_out_channels=(32, 64), layers_per_block=1, context_dim=16,
        attention_head_dim=16, dtype=torch.float32)).eval()
    movq = VQ.MoVQ(VQ.MoVQConfig(block_out_channels=(32, 64),
                                 layers_per_block=1, dtype=torch.float32)).eval()
    calls.update(attn=0, gn=0)
    with torch.no_grad():
        kd(torch.randn(2, 8, 6, 4), torch.tensor([1.0, 2.0]),
           torch.randn(2, 3, 16), torch.randn(2, 128))
        movq.decode(torch.randn(1, 4, 6, 4))
    assert calls["attn"] == count(kd, KD.AddedKVAttention) + 1 == 5
    assert calls["gn"] == count(kd, L.GroupNorm) + count(movq, L.GroupNorm)
