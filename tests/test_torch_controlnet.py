"""The port's ControlNet and the UNet's `control=` residuals against the JAX
package's (cremage_tpu/models/controlnet.py, models/unet.py), float32 on
the CPU, at the tiny config and tolerances of tests/test_torch_models.py."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from cremage_tpu.models.controlnet import ControlNet as JControlNet
from cremage_tpu.models.unet import UNetConfig as JUNetConfig
from cremage_tpu.models.unet import UNetModel as JUNet
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.models.controlnet import ControlNet
from cremage_tpu_torch.models.unet import UNetConfig, UNetModel
from tests.test_torch_models import HID, UNET_KW, nchw
from tests.test_torch_pipeline import jax_params, cheap_jax  # noqa: F401

torch.set_num_threads(2)


def test_controlnet_and_controlled_unet_match_jax():
    jcfg = JUNetConfig(**UNET_KW, dtype=jnp.float32)
    rng = np.random.RandomState(21)
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    hint = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    ts = np.array([10.5, 700.0], np.float32)
    ctx = rng.randn(2, 77, HID).astype(np.float32)
    jcn, junet = JControlNet(jcfg), JUNet(jcfg)
    cp = jax_params(jcn, 22, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1, 64, 64, 3)),
                    jnp.zeros((1,)), jnp.zeros((1, 77, HID)))
    up = jax_params(junet, 23, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                    jnp.zeros((1, 77, HID)))
    f32 = torch.float32
    cn = convert.load_from_jax(ControlNet(UNetConfig(**UNET_KW, dtype=f32)),
                               cp["params"]).eval()
    unet = convert.load_from_jax(UNetModel(UNetConfig(**UNET_KW, dtype=f32)),
                                 up["params"]).eval()

    j_args = tuple(map(jnp.asarray, (x, hint, ts, ctx)))
    want_in, want_mid = jax.jit(jcn.apply)(cp, *j_args)
    with torch.no_grad():
        got_in, got_mid = cn(nchw(x), nchw(hint), torch.from_numpy(ts),
                             torch.from_numpy(ctx))
    # one residual per input block (conv_in, 1 + 1 ResBlock levels, the
    # downsample) and the middle block's
    assert len(got_in) == len(want_in) == len(unet.input_blocks) == 4
    for g, w in zip(got_in + [got_mid], list(want_in) + [want_mid]):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)

    control = (list(want_in), want_mid)
    want = jax.jit(lambda p, a, b, c, ctl: junet.apply(p, a, b, c, None, ctl))(
        up, j_args[0], j_args[2], j_args[3], control)
    with torch.no_grad():
        got = unet(nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx),
                   control=([r * 1.0 for r in got_in], got_mid))
        plain = unet(nchw(x), torch.from_numpy(ts), torch.from_numpy(ctx))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    assert float((got - plain).abs().max()) > 1e-2   # the residuals count
