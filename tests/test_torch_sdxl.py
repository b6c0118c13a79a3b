"""SDXL's modules in the port against the JAX package's, on tiny configs in
the shape of tests/test_edm_sdxl.py: the UNet with vector conditioning,
per-level depths and 16-wide heads; the OpenCLIP tower; the two-tower
conditioner; the sgm discretizations, denoiser and six samplers; and the
options the port refuses.

Weights are drawn as numpy in the shapes of jax.eval_shape
(tests/test_torch_pipeline.py `jax_params`) and carried over by
cremage_tpu_torch/io/convert.py. The JAX models run jitted (the
conditioner through its own cached jit_apply), the samplers eagerly
(jax.disable_jit()): for each, the cheaper of the two here. Everything is float32 on the CPU. Tolerances:
the UNet 1e-4 (as the SD1.5 UNet's test), the towers and the conditioner
2e-5 (as the CLIP tests), the samplers 1e-5 of the result's range (as
tests/test_torch_samplers.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cremage_tpu.core.config import GenerationOptions as JOptions
from cremage_tpu.io.ti import load_embedding as j_load_embedding
from cremage_tpu.models.clip import CLIPTextConfig as JCLIPConfig
from cremage_tpu.models.clip import CLIPTextModel as JCLIP
from cremage_tpu.models.open_clip import OpenCLIPTextConfig as JOCConfig
from cremage_tpu.models.open_clip import OpenCLIPTextModel as JOC
from cremage_tpu.models.unet import UNetConfig as JUNetConfig
from cremage_tpu.models.unet import UNetModel as JUNet
from cremage_tpu.models.unet import sdxl_base_unet_config as j_base_cfg
from cremage_tpu.models.unet import sdxl_refiner_unet_config as j_refiner_cfg
from cremage_tpu.pipelines.sdxl import SDXLConditioner as JConditioner
from cremage_tpu.pipelines.sdxl import fourier_vector_embedding as j_fourier
from cremage_tpu.prompt import chunking as JCH
from cremage_tpu.prompt.tokenizer import default_tokenizer as j_tokenizer
from cremage_tpu.samplers import edm as JE
from cremage_tpu_torch.core.config import GenerationOptions
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io.ti import load_embedding
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.open_clip import OpenCLIPTextConfig, OpenCLIPTextModel
from cremage_tpu_torch.models.unet import (
    UNetConfig, UNetModel, sdxl_base_unet_config, sdxl_refiner_unet_config,
)
from cremage_tpu_torch.models.vae import sdxl_vae_config
from cremage_tpu_torch.pipelines import sdxl as X
from cremage_tpu_torch.prompt import chunking as CH
from cremage_tpu_torch.prompt.tokenizer import default_tokenizer
from cremage_tpu_torch.samplers import edm as E
from tests.test_torch_pipeline import jax_params

torch.set_num_threads(2)
F32 = torch.float32

L_HID, G_HID = 32, 48
CTX, ADM = L_HID + G_HID, G_HID + 3 * 512
UNET_KW = dict(in_channels=4, out_channels=4, model_channels=32,
               num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
               num_heads=-1, num_head_channels=16, transformer_depth=(1, 2),
               transformer_depth_middle=2, context_dim=CTX, adm_in_channels=ADM,
               use_linear_in_transformer=True)
CLIP_KW = dict(hidden_size=L_HID, num_layers=2, num_heads=4, intermediate_size=64)
OC_KW = dict(width=G_HID, num_layers=2, num_heads=4)
TI_G_TOKENS = 74      # with "a dog" after it, bigG's prompt takes 2 chunks


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    ju = JUNet(JUNetConfig(**UNET_KW, dtype=jnp.float32))
    up = jax_params(ju, 20, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                    jnp.zeros((1, 77, CTX)), jnp.zeros((1, ADM)))
    jc = JCLIP(JCLIPConfig(**CLIP_KW, dtype=jnp.float32))
    cp = jax_params(jc, 21, jnp.zeros((1, 77), jnp.int32))
    jo = JOC(JOCConfig(**OC_KW, dtype=jnp.float32))
    op = jax_params(jo, 22, jnp.zeros((1, 77), jnp.int32))
    tu = convert.load_from_jax(UNetModel(UNetConfig(**UNET_KW, dtype=F32)),
                               up["params"]).eval()
    tc = convert.load_clip(CLIPTextModel(CLIPTextConfig(**CLIP_KW, dtype=F32)),
                           cp["params"]).eval()
    to = convert.load_open_clip(
        OpenCLIPTextModel(OpenCLIPTextConfig(**OC_KW, dtype=F32)),
        op["params"]).eval()
    emb = tmp_path_factory.mktemp("emb")
    rng = np.random.RandomState(23)
    torch.save({"clip_l": torch.from_numpy(rng.randn(1, L_HID).astype(np.float32)),
                "clip_g": torch.from_numpy(
                    rng.randn(TI_G_TOKENS, G_HID).astype(np.float32) * 0.02)},
               emb / "two.pt")
    return dict(ju=ju, up=up, jc=jc, cp=cp, jo=jo, op=op, tu=tu, tc=tc, to=to,
                emb=str(emb))


def test_configs_match_jax():
    for ours, ref in ((sdxl_base_unet_config(), j_base_cfg()),
                      (sdxl_refiner_unet_config(), j_refiner_cfg())):
        for f in dataclasses.fields(ours):
            if f.name != "dtype":
                assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert sdxl_vae_config().scale_factor == 0.13025
    assert OpenCLIPTextConfig() == dataclasses.replace(
        OpenCLIPTextConfig(), width=1280, num_layers=32, num_heads=20)


def test_unet_with_y_matches_jax(models):
    rng = np.random.RandomState(24)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    ts = np.array([10.0, 700.0], np.float32)
    ctx = rng.randn(2, 154, CTX).astype(np.float32)
    y = rng.randn(2, ADM).astype(np.float32)
    # jitted: the eager UNet compiles each of its ops, three times the cost
    want = jax.jit(models["ju"].apply)(models["up"], jnp.asarray(x),
                                       jnp.asarray(ts), jnp.asarray(ctx),
                                       jnp.asarray(y))
    with torch.no_grad():
        got = models["tu"](torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(ts), torch.from_numpy(ctx),
                           y=torch.from_numpy(y))
        # y matters, and a UNet with adm_in_channels needs it
        other = models["tu"](torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(ts), torch.from_numpy(ctx),
                             y=torch.from_numpy(y) * 0.5)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-4, rtol=1e-4)
    assert float((other - got).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="vector conditioning"):
        models["tu"](torch.from_numpy(x).permute(0, 3, 1, 2),
                     torch.from_numpy(ts), torch.from_numpy(ctx))
    # the SDXL layout: Linear proj_in/out, label_emb, per-level depths
    tu = models["tu"]
    assert isinstance(tu.input_blocks[3][1].proj_in, torch.nn.Linear)
    assert len(tu.input_blocks[3][1].transformer_blocks) == 2
    assert len(tu.middle_block[1].transformer_blocks) == 2
    assert tu.label_emb[0][0].weight.shape == (128, ADM)


def test_open_clip_matches_jax(models):
    rng = np.random.RandomState(25)
    emb = rng.randn(2, 77, G_HID).astype(np.float32) * 0.1
    eos = np.array([5, 76])
    jo, op = models["jo"], models["op"]
    hidden, final = jax.jit(jo.apply)(op, inputs_embeds=jnp.asarray(emb))
    pooled = jo.apply(op, final, jnp.asarray(eos), method=JOC.project_pooled)
    ids = jo.apply(op, jnp.asarray([[49406, 320, 49407]]),
                   method=JOC.embed_tokens)
    with torch.no_grad():
        th, tf = models["to"](torch.from_numpy(emb))
        tp = models["to"].project_pooled(tf, torch.from_numpy(eos))
        tids = models["to"].embed_tokens(torch.tensor([[49406, 320, 49407]]))
    assert len(th) == len(hidden) == OC_KW["num_layers"] + 1
    for g, w in zip(th, hidden):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tf.numpy(), np.asarray(final), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(pooled), atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))


def test_chunking_keeps_the_eos_index_and_the_tower(models):
    tok = default_tokenizer()
    embed = lambda ids: np.eye(8, dtype=np.float32)[np.asarray(ids) % 8]
    for prompt in ("a dog", "a dog " * 45, ""):
        pairs = [(w, 1.0) for w in prompt.split()] or [("", 1.0)]
        got = CH.generate_weighted_chunks(tok, embed, pairs)
        want = JCH.generate_weighted_chunks(j_tokenizer(), embed, pairs)
        assert got[1] == want[1]
        for g, w in zip(got[0], want[0]):
            np.testing.assert_array_equal(g, w)
    for key in ("clip_l", "clip_g"):
        ours = CH.make_ti_fetch(models["emb"], load_embedding, key)("two.pt")
        ref = JCH.make_ti_fetch(models["emb"], j_load_embedding, key)("two.pt")
        np.testing.assert_array_equal(ours, ref)
    assert ours.shape == (TI_G_TOKENS, G_HID)


# (prompt, negative): short; weighted; a TI tag that is 1 token in CLIP-L and
# 74 in bigG (bigG takes 2 chunks, CLIP-L 1: the towers' chunks aligned);
# a prompt of 3 chunks against a negative of 1 (c and uc filler-padded)
CONDITIONER_CASES = [
    ("a dog", "ugly"),
    ("a (red:1.3) dog, [blurry] ((sharp))", ""),
    ("<embedding:two.pt> a dog", "ugly"),
    ("a dog " * 80, "bad"),
]


@pytest.mark.parametrize("prompt,negative", CONDITIONER_CASES,
                         ids=["short", "weighted", "ti-clip_g", "long"])
def test_conditioner_matches_jax(models, prompt, negative):
    ours = X.SDXLConditioner(models["tc"], models["to"], default_tokenizer(),
                             models["emb"])
    ref = JConditioner((models["jc"], models["cp"]), (models["jo"], models["op"]),
                       j_tokenizer(), models["emb"])
    kw = dict(prompt=prompt, negative_prompt=negative, H=96, W=128)
    jc, juc = ref.encode_pair(JOptions(**kw), 2)
    with torch.no_grad():
        c, uc = ours.encode_pair(GenerationOptions(**kw), 2, "cpu")
    for g, w in ((c, jc), (uc, juc)):
        assert set(g) == {"crossattn", "vector"}
        for k in g:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       atol=2e-5, rtol=2e-5)
    assert c["vector"].shape == (2, ADM)
    if "embedding" in prompt:       # bigG's 2 chunks, CLIP-L's padded
        assert c["crossattn"].shape[1] == 154
    np.testing.assert_allclose(X.fourier_vector_embedding((96, 128)),
                               j_fourier((96, 128)), atol=1e-5)


def test_discretizations_match_jax():
    for n in (1, 4, 30, 1000):
        np.testing.assert_array_equal(E.LegacyDDPMDiscretization()(n),
                                      JE.LegacyDDPMDiscretization()(n))
    kw = dict(sigma_min=0.0292, sigma_max=14.6146, rho=3.0)
    for n in (2, 8, 30):
        np.testing.assert_array_equal(E.make_discretization("EDMDiscretization",
                                                            **kw)(n),
                                      JE.make_discretization("EDMDiscretization",
                                                             **kw)(n))
        np.testing.assert_array_equal(
            E.EDMDiscretization()(n, do_append_zero=False),
            JE.EDMDiscretization()(n, do_append_zero=False))
    with pytest.raises(ValueError):
        E.LegacyDDPMDiscretization()(1001)
    assert set(E.DISCRETIZATIONS) == {"LegacyDDPMDiscretization",
                                      "EDMDiscretization"}


def _net(lib):
    """An analytic network(x, t, cond) that reads its timestep and cond."""
    return lambda x, t, cond: (x * 0.3 + lib.sin(t / 100.0).reshape(-1, 1, 1, 1)
                               + cond["vector"][:, :1].reshape(-1, 1, 1, 1))


@pytest.mark.parametrize("scaling", ["EpsScaling", "VScaling", "EDMScaling"])
def test_discrete_denoiser_matches_jax(scaling):
    table = E.LegacyDDPMDiscretization()(1000, do_append_zero=False)
    rng = np.random.RandomState(26)
    x = rng.randn(3, 4, 4, 4).astype(np.float32)
    sigma = np.array([14.6, 1.234, 0.03], np.float32)   # off the table
    cond = rng.randn(3, 8).astype(np.float32)
    want = JE.DiscreteDenoiserSGM(_net(jnp), table, scaling)(
        jnp.asarray(x), jnp.asarray(sigma), {"vector": jnp.asarray(cond)})
    den = E.DiscreteDenoiserSGM(_net(torch), table, scaling)
    got = den(torch.from_numpy(x), torch.from_numpy(sigma),
              {"vector": torch.from_numpy(cond)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(
        den.sigma_to_idx(torch.from_numpy(sigma)).numpy(),
        np.asarray(JE.DiscreteDenoiserSGM(_net(jnp), table).sigma_to_idx(
            jnp.asarray(sigma))))


def test_guiders_match_jax():
    table = E.LegacyDDPMDiscretization()(1000, do_append_zero=False)
    rng = np.random.RandomState(27)
    x = rng.randn(2, 4, 4, 4).astype(np.float32)
    c = {"vector": rng.randn(2, 8).astype(np.float32),
         "crossattn": rng.randn(2, 3, 8).astype(np.float32)}
    uc = {k: v * 0.5 for k, v in c.items()}
    tc = {k: torch.from_numpy(v) for k, v in c.items()}
    tuc = {k: torch.from_numpy(v) for k, v in uc.items()}
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    juc = {k: jnp.asarray(v) for k, v in uc.items()}
    jd = JE.DiscreteDenoiserSGM(_net(jnp), table)
    td = E.DiscreteDenoiserSGM(_net(torch), table)
    for sigma in (5.0, 0.5):
        for name, kw in (("VanillaCFG", dict(scale=6.0)),
                         ("VanillaCFG", dict(scale=6.0, interval=(1.0, 10.0))),
                         ("IdentityGuider", {})):
            jg = {"VanillaCFG": JE.vanilla_cfg,
                  "IdentityGuider": JE.identity_guider}[name]
            want = jg(jd, jc, juc, **kw)(jnp.asarray(x), sigma)
            got = E.GUIDERS[name](td, tc, tuc, **kw)(torch.from_numpy(x), sigma)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)


def _jax_steps(key, n, shape):
    """The per-step noise the JAX samplers draw (kdiffusion._keys)."""
    ks = jax.random.split(key, n)
    return [np.asarray(jax.random.normal(k, shape, jnp.float32)) for k in ks]


@pytest.mark.parametrize("disc", ["LegacyDDPMDiscretization", "EDMDiscretization"])
@pytest.mark.parametrize("name", E.SGM_SAMPLER_NAMES)
def test_sgm_sampler_matches_jax(name, disc):
    assert E.SGM_SAMPLER_NAMES == JE.SGM_SAMPLER_NAMES
    sigmas = E.make_discretization(disc, sigma_min=0.0292, sigma_max=14.6146,
                                   rho=3.0)(5)
    shape = (2, 4, 4, 4)
    key = jax.random.key(28)
    x = np.array(jax.random.normal(jax.random.key(29), shape, jnp.float32))
    den = lambda lib: (lambda xx, s: xx * (0.6 / (1.0 + s)) + 0.2 * lib.tanh(xx)
                       - 0.05)
    kw = dict(eta=0.9, s_noise=1.0)
    if name == "EulerEDMSampler":
        kw = dict(s_churn=0.0, s_noise=1.0)
    with jax.disable_jit():
        want = JE.run_sgm_sampler(name, den(jnp), jnp.asarray(x), sigmas,
                                  key=key, **kw)
    msgs = []
    got = E.run_sgm_sampler(name, den(torch), torch.from_numpy(x), sigmas,
                            ArrayNoise(None, _jax_steps(key, 5, shape)),
                            progress_cb=msgs.append, **kw)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.ptp(want)))
    assert msgs == list(range(5))
    # img2img: the noised latent as given, the last t_enc + 1 sigmas
    with jax.disable_jit():
        want = JE.run_sgm_sampler(name, den(jnp), jnp.asarray(x), sigmas[-3:],
                                  key=key, scale_input=False, **kw)
    got = E.run_sgm_sampler(name, den(torch), torch.from_numpy(x), sigmas[-3:],
                            ArrayNoise(None, _jax_steps(key, 2, shape)),
                            scale_input=False, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.ptp(np.asarray(want))))


# each option the SDXL port does not run, as a job sets it
REFUSED = [dict(sampler="LCM"), dict(sampler="Euler A"),
           dict(mode="inpainting"), dict(refiner_ckpt="r.safetensors"),
           dict(refiner_strength=0.3), dict(guider="LinearPredictionGuider"),
           dict(guider="TrianglePredictionGuider"),
           dict(cfg_interval_low=0.5, cfg_interval_high=5.0),
           dict(deep_cache=3), dict(tome_ratio=0.5), dict(ada_cache=0.1),
           dict(extra={"unet_quantize": "int8"}), dict(auto_face_fix=True)]


@pytest.mark.parametrize("opt", REFUSED, ids=lambda o: "-".join(map(str, o)))
def test_check_supported_refuses_what_is_not_ported(opt):
    base = dict(sampler="EulerEDMSampler")
    with pytest.raises(NotImplementedError, match="not ported"):
        X.check_supported(GenerationOptions(**{**base, **opt}))


def test_check_supported_takes_the_ported_options():
    for name in E.SGM_SAMPLER_NAMES:
        for guider in E.GUIDERS:
            X.check_supported(GenerationOptions(
                sampler=name, guider=guider, mode="image_to_image",
                discretization="EDMDiscretization",
                extra={"unet_quantize": "none"}))


def test_meta_lists_sdxl_as_the_jax_server():
    from cremage_tpu.app.server import ApiServer as JServer
    from cremage_tpu_torch.app.server import ApiServer

    ours = ApiServer().handle("GET", "/v1/meta", {})
    ref = JServer.handle(JServer.__new__(JServer), "GET", "/v1/meta", {})
    assert ours["model_types"] == ["SD 1.5", "SDXL"]
    assert ours["samplers_by_type"]["SDXL"] == ref["samplers_by_type"]["SDXL"]
    assert ours["samplers_by_type"]["SD 1.5"] == ref["samplers_by_type"]["SD 1.5"]
