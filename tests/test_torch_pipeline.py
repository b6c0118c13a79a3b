"""The whole txt2img slice: the port's SD15Pipeline.generate against the
JAX package's, on the tiny bundle of tests/test_pipeline_sd15.py.

Both run the same options (64x64, 3 steps, Euler A, CFG 7.5, seed 42,
n_samples 2) on the same weights (carried over by
cremage_tpu_torch/io/convert.py), and the port is handed the noise the
JAX pipeline draws from its threefry keys. Everything is float32 on the
CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cremage_tpu.core.config import GenerationOptions as JOptions
from cremage_tpu.core.rng import key_for_image
from cremage_tpu.models.clip import CLIPTextConfig as JCLIPConfig
from cremage_tpu.models.clip import CLIPTextModel as JCLIP
from cremage_tpu.models.unet import UNetConfig as JUNetConfig
from cremage_tpu.models.unet import UNetModel as JUNet
from cremage_tpu.models.vae import AutoencoderKL as JVAE
from cremage_tpu.models.vae import VAEConfig as JVAEConfig
from cremage_tpu.pipelines.conditioning import TextEncoder as JTextEncoder
from cremage_tpu.pipelines.sd15 import SD15Bundle as JBundle
from cremage_tpu.pipelines.sd15 import SD15Pipeline as JPipeline
from cremage_tpu.prompt.tokenizer import default_tokenizer as j_tokenizer
from cremage_tpu.samplers import kdiffusion as JK
from cremage_tpu.samplers import schedules as JS
from cremage_tpu.samplers.denoiser import sigma_to_t_jax
from cremage_tpu_torch.core.config import GenerationOptions
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.unet import UNetConfig, UNetModel
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.pipelines.conditioning import TextEncoder
from cremage_tpu_torch.pipelines.sd15 import SD15Bundle, SD15Pipeline
from cremage_tpu_torch.prompt.tokenizer import default_tokenizer
from cremage_tpu_torch.samplers import kdiffusion as K
from cremage_tpu_torch.samplers import schedules as S
from cremage_tpu_torch.samplers.denoiser import sigma_to_t
from tests.conftest import assert_img01_close

torch.set_num_threads(2)

HID = 32
UNET_KW = dict(in_channels=4, out_channels=4, model_channels=32,
               num_res_blocks=1, attention_resolutions=(1,), channel_mult=(1, 2),
               num_heads=4, transformer_depth=(1, 1), transformer_depth_middle=1,
               context_dim=HID)
VAE_KW = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
CLIP_KW = dict(hidden_size=HID, num_layers=2, num_heads=4, intermediate_size=64)
OPTS = dict(prompt="a (red:1.2) cat", negative_prompt="bad", H=64, W=64,
            sampling_steps=3, n_samples=2, n_iter=1, seed=42,
            sampler="Euler A", scale=7.5, safety_check=False)


def jax_params(module, seed, *args):
    """Seeded numpy parameters in the shapes of `module.init(key, *args)`,
    taken from jax.eval_shape so that no init program is compiled (the
    compile took most of this module's set-up), drawn as the JAX layers
    initialise them: norm weights 1 and biases 0, weights lecun_normal
    (a normal truncated at 2 sigma, scaled to variance 1 / fan_in),
    embeddings N(0, 0.02); each plus 0.1 N(0, 1) so no layer is trivial."""
    rng = np.random.RandomState(seed)

    def lecun_normal(shape):
        z = rng.randn(*shape)
        while (bad := np.abs(z) > 2).any():
            z[bad] = rng.randn(int(bad.sum()))
        # 0.8796... is the std of a unit normal truncated at 2 sigma
        return z / 0.87962566103423978 / np.sqrt(np.prod(shape[:-1]))

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "bias":
            base = np.zeros(shape)
        elif len(shape) == 1:
            base = np.ones(shape)
        elif name == "weight":
            base = lecun_normal(shape)
        else:
            base = 0.02 * rng.randn(*shape)
        return (base + 0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(module.init, jax.random.key(0), *args))


@pytest.fixture(scope="module")
def bundles():
    unet = JUNet(JUNetConfig(**UNET_KW, dtype=jnp.float32))
    up = jax_params(unet, 10, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                    jnp.zeros((1, 77, HID)))
    vae = JVAE(JVAEConfig(**VAE_KW, dtype=jnp.float32))
    vp = jax_params(vae, 11, jnp.zeros((1, 64, 64, 3)))
    clip = JCLIP(JCLIPConfig(**CLIP_KW, dtype=jnp.float32))
    cp = jax_params(clip, 12, jnp.zeros((1, 77), jnp.int32))
    jb = JBundle(unet=unet, unet_params=up, vae=vae, vae_params=vp,
                 text=JTextEncoder(clip, cp, j_tokenizer()),
                 schedule=JS.default_sd_schedule())
    f32 = torch.float32
    tb = SD15Bundle(
        unet=convert.load_from_jax(UNetModel(UNetConfig(**UNET_KW, dtype=f32)),
                                   up["params"]),
        vae=convert.load_vae(AutoencoderKL(VAEConfig(**VAE_KW, dtype=f32)),
                             vp["params"]),
        text=TextEncoder(convert.load_clip(
            CLIPTextModel(CLIPTextConfig(**CLIP_KW, dtype=f32)), cp["params"]),
            default_tokenizer()),
        schedule=S.default_sd_schedule())
    return jb, tb


@pytest.fixture(scope="module")
def jax_pipe(bundles):
    """One JAX pipeline for the module: its sampler program, compiled by
    the first test that runs it, serves the others."""
    return JPipeline(bundles[0])


def jax_noise(seed, img_index, shape, steps):
    """The initial and per-step noise the JAX pipeline draws for a batch
    (sd15.py txt2img_latents, kdiffusion.plan_euler_ancestral)."""
    key = key_for_image(seed, img_index)
    init = jax.random.normal(key, shape, dtype=jnp.float32)
    ks = jax.random.split(key, steps)
    return np.asarray(init), [np.asarray(jax.random.normal(k, shape,
                                                           dtype=jnp.float32))
                              for k in ks]


def test_txt2img_matches_jax(bundles, jax_pipe):
    jb, tb = bundles
    j_msgs, t_msgs = [], []
    want = jax_pipe.generate(JOptions(**OPTS), status_cb=j_msgs.append)
    init, steps = jax_noise(42, 0, (2, 8, 8, 4), 3)
    got = SD15Pipeline(tb, device="cpu").generate(
        GenerationOptions(**OPTS), status_cb=t_msgs.append,
        noise=lambda seed, device: ArrayNoise(init, steps, device))
    assert len(got) == len(want) == 2
    # float_tol = 2/255: both pipelines round the float32 latent to bf16
    # before the decode. The latents agree to float32 noise (next test),
    # but a value that lies near a bf16 rounding boundary can round one bf16
    # step apart (6 of 512 values under another draw of random weights),
    # and with such weights the latent reaches ~200, so one step moves its
    # 8x8 pixel patch by up to 2/255 (measured) on top of the quantization
    # step.
    for (gi, gm), (wi, wm) in zip(got, want):
        assert gi.shape == wi.shape == (64, 64, 3)
        assert_img01_close(gi, wi, float_tol=2.0 / 255.0)
        assert gm == wm
    # JAX posts its step statuses from ordered io_callbacks that reach the
    # host asynchronously, so under load they can land after the
    # "decoding" status it posts once the sampler is dispatched (seen once
    # in 10 runs of the port's tests on 6 workers): its "decoding" is put
    # last, where the sampler's end puts it
    j_msgs = ([m for m in j_msgs if m != "decoding"]
              + [m for m in j_msgs if m == "decoding"])
    assert t_msgs == j_msgs


def test_txt2img_latents_match_jax(bundles, jax_pipe):
    jb, tb = bundles
    jp, tp = jax_pipe, SD15Pipeline(tb, device="cpu")
    jo, to = JOptions(**OPTS), GenerationOptions(**OPTS)
    c, uc = jp._conditioning(jo, 2)
    want = np.asarray(jp.txt2img_latents(jo, c, uc, key_for_image(42, 0)))
    init, steps = jax_noise(42, 0, (2, 8, 8, 4), 3)
    tc, tuc = tp._conditioning(to, 2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(c), atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        got = tp.txt2img_latents(to, tc, tuc, ArrayNoise(init, steps, "cpu"))
    # float32 summation-order noise through 3 CFG-7.5 steps: 1e-5 of the
    # latent's range
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * float(np.abs(want).max()))


def test_unsupported_options_raise(bundles):
    """What the port does not run yet raises: the samplers beyond the
    reference's menu, FaceID, auto face fix and the speed features.
    (ControlNet, LoRA, TI, wildcards, the safety checker and the watermark
    are ported: tests/test_torch_loader.py.)"""
    pipe = SD15Pipeline(bundles[1], device="cpu")
    for bad in (dict(sampler="PLMS"), dict(sampler="DPM Solver"),
                dict(sampler="LCM"), dict(mode="face_fix"),
                dict(face_input_img="face.png"), dict(face_model="f.bin"),
                dict(auto_face_fix=True),
                dict(tome_ratio=0.5), dict(deep_cache=2), dict(ada_cache=0.1),
                dict(cfg_interval_low=0.5, cfg_interval_high=2.0)):
        with pytest.raises(NotImplementedError):
            pipe.generate(GenerationOptions(**dict(OPTS, **bad)))


def test_euler_ancestral_matches_jax_sampler():
    """The sampler alone, with a fixed toy denoiser, on the JAX-drawn
    step noise."""
    sigmas = JS.default_sd_schedule().get_sigmas(6)

    def den_np(x, s):
        return x * 0.7 / (1.0 + s) + 0.1

    key = jax.random.key(3)
    x0 = np.random.RandomState(0).randn(2, 4, 4, 4).astype(np.float32) * \
        float(sigmas[0])
    want = JK.sample_euler_ancestral(den_np, jnp.asarray(x0), sigmas, key=key)
    steps = [np.asarray(jax.random.normal(k, x0.shape, dtype=jnp.float32))
             for k in jax.random.split(key, 6)]
    got = K.sample_euler_ancestral(den_np, torch.from_numpy(x0), sigmas,
                                   ArrayNoise(x0, steps, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_schedule_and_sigma_to_t_match_jax():
    ours, ref = S.default_sd_schedule(), JS.default_sd_schedule()
    np.testing.assert_array_equal(ours.get_sigmas(20), ref.get_sigmas(20))
    sig = np.array([14.6, 3.2, 0.9, 0.05, 0.0292], np.float32)
    np.testing.assert_allclose(
        sigma_to_t(ours, torch.from_numpy(sig)).numpy(),
        np.asarray(sigma_to_t_jax(ref, jnp.asarray(sig))), atol=1e-3,
        rtol=1e-6)
