"""The port's img2img, inpainting and hires fix against the JAX package's,
on the tiny bundles of tests/test_torch_pipeline.py: the VAE encoder,
`encode_to_latent`, the resize of the hires fix and the inpainting mask,
and each mode through `generate()`.

Both packages run the same weights (carried over by
cremage_tpu_torch/io/convert.py), and the port is handed the noise the
JAX pipeline draws from its keys: the posterior sample at fold_in(key, 7),
the stochastic encode at key, the steps at split(key, n), and the hires
pass's own at fold_in(key, 1). Everything is float32 on the CPU.
"""
import io
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from cremage_tpu.core.config import GenerationOptions as JOptions
from cremage_tpu.core.rng import key_for_image
from cremage_tpu.models.clip import CLIPTextConfig as JCLIPConfig
from cremage_tpu.models.clip import CLIPTextModel as JCLIP
from cremage_tpu.models.unet import UNetConfig as JUNetConfig
from cremage_tpu.models.unet import UNetModel as JUNet
from cremage_tpu.models.vae import AutoencoderKL as JVAE
from cremage_tpu.models.vae import VAEConfig as JVAEConfig
from cremage_tpu.models.vae import encode_to_latent as j_encode
from cremage_tpu.pipelines.conditioning import TextEncoder as JTextEncoder
from cremage_tpu.pipelines.sd15 import SD15Bundle as JBundle
from cremage_tpu.pipelines.sd15 import SD15Pipeline as JPipeline
from cremage_tpu.prompt.tokenizer import default_tokenizer as j_tokenizer
from cremage_tpu.samplers import schedules as JS
from cremage_tpu_torch.core.config import GenerationOptions
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io.png import decode_png
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.unet import UNetConfig, UNetModel
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.models.vae import encode_to_latent
from cremage_tpu_torch.pipelines.conditioning import TextEncoder
from cremage_tpu_torch.pipelines.sd15 import SD15Bundle, SD15Pipeline
from cremage_tpu_torch.prompt.tokenizer import default_tokenizer
from cremage_tpu_torch.samplers import schedules as S
from cremage_tpu_torch.utils.resize import resize
from tests.conftest import assert_img01_close
from tests.test_torch_pipeline import jax_params, cheap_jax  # noqa: F401

torch.set_num_threads(2)

HID = 32
UNET_KW = dict(out_channels=4, model_channels=32, num_res_blocks=1,
               attention_resolutions=(1,), channel_mult=(1, 2), num_heads=4,
               transformer_depth=(1, 1), transformer_depth_middle=1,
               context_dim=HID)
VAE_KW = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1)
CLIP_KW = dict(hidden_size=HID, num_layers=2, num_heads=4, intermediate_size=64)
BASE = dict(prompt="a (red:1.2) cat", negative_prompt="bad", H=64, W=64,
            sampling_steps=4, n_samples=2, n_iter=1, seed=42, scale=7.5,
            safety_check=False)


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    """Drop the compiled programs the worker holds before this module's
    JAX pipelines compile theirs: after some sequences of earlier JAX
    tests in one process (a worker of the whole run), XLA's CPU compile
    of these pipelines' VAE programs segfaults, at the parent commit as
    well; with the caches cleared first the same sequence passes."""
    jax.clear_caches()
    yield


@pytest.fixture(scope="module")
def models():
    """JAX parameter trees and the port's modules on the same weights:
    the plain and the 9-channel inpainting UNet, the full VAE, CLIP."""
    out = {}
    j4 = JUNet(JUNetConfig(in_channels=4, **UNET_KW, dtype=jnp.float32))
    p4 = jax_params(j4, 10, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                    jnp.zeros((1, 77, HID)))
    # the inpainting UNet differs only in conv_in's input channels
    p9 = jax.tree.map(lambda a: a, p4)
    p9["params"]["input_blocks_0_0"] = dict(
        p4["params"]["input_blocks_0_0"],
        weight=(np.random.RandomState(13).randn(3, 3, 9, 32) * 0.1).astype(
            np.float32))
    for in_ch, p in ((4, p4), (9, p9)):
        j = JUNet(JUNetConfig(in_channels=in_ch, **UNET_KW, dtype=jnp.float32))
        t = convert.load_from_jax(UNetModel(UNetConfig(
            in_channels=in_ch, **UNET_KW, dtype=torch.float32)), p["params"])
        out[f"unet{in_ch}"] = (j, p, t.eval())
    j = JVAE(JVAEConfig(**VAE_KW, dtype=jnp.float32))
    p = jax_params(j, 11, jnp.zeros((1, 64, 64, 3)))
    out["vae"] = (j, p, convert.load_vae(
        AutoencoderKL(VAEConfig(**VAE_KW, dtype=torch.float32)),
        p["params"]).eval())
    j = JCLIP(JCLIPConfig(**CLIP_KW, dtype=jnp.float32))
    p = jax_params(j, 12, jnp.zeros((1, 77), jnp.int32))
    out["clip"] = (j, p, convert.load_clip(
        CLIPTextModel(CLIPTextConfig(**CLIP_KW, dtype=torch.float32)),
        p["params"]).eval())
    return out


@pytest.fixture(scope="module")
def pipes(models):
    """(JAX pipeline, port pipeline) for the plain and the inpaint bundle;
    module-scoped so each JAX sampler program compiles once."""
    jv, jvp, tv = models["vae"]
    jc, jcp, tc = models["clip"]
    out = {}
    for inpaint in (False, True):
        ju, jup, tu = models["unet9" if inpaint else "unet4"]
        jb = JBundle(unet=ju, unet_params=jup, vae=jv, vae_params=jvp,
                     text=JTextEncoder(jc, jcp, j_tokenizer()),
                     schedule=JS.default_sd_schedule(), inpaint=inpaint)
        tb = SD15Bundle(unet=tu, vae=tv, text=TextEncoder(tc, default_tokenizer()),
                        schedule=S.default_sd_schedule())
        assert tb.inpaint == inpaint
        out[inpaint] = (JPipeline(jb), SD15Pipeline(tb, device="cpu"))
    return out


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def init_image(h=64, w=64, seed=0):
    """A smooth (H, W, 3) image in [-1, 1]."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    chans = [np.sin(6 * xx * rng.uniform(0.5, 2) + 5 * yy * rng.uniform(0.5, 2)
                    + rng.uniform(0, 6)) for _ in range(3)]
    img = 0.8 * np.stack(chans, -1) + 0.1 * rng.randn(h, w, 3)
    return np.clip(img, -1, 1).astype(np.float32)


def mask_image(h=64, w=64):
    """1 (inpaint) in a block, soft values on both sides of 0.5 around it."""
    m = np.zeros((h, w), np.float32)
    m[12:44, 20:52] = 0.9
    m[10:12, 20:52] = 0.4
    m[44:46, 20:52] = 0.6
    return m


# ------------------------------------------------------------- VAE encoder

def test_encoder_matches_jax(models):
    j, p, t = models["vae"]
    x = init_image(seed=1)[None].repeat(2, 0)
    x[1] = init_image(seed=2)
    mean, logvar = jax.jit(lambda pp, xx: j.apply(pp, xx, method=JVAE.encode))(
        p, jnp.asarray(x))
    with torch.no_grad():
        tm, tl = t.encode(nchw(x))
    for got, want in ((tm, mean), (tl, logvar)):
        want = np.asarray(want)
        # float32 summation order through ~20 convolutions: 1e-5 of range
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("sample", [False, True])
def test_encode_to_latent_matches_jax(models, sample):
    j, p, t = models["vae"]
    x = init_image(seed=3)[None]
    key = jax.random.key(7)
    want = np.asarray(j_encode(j, p, jnp.asarray(x), key=key, sample=sample))
    drawn = []

    def posterior(shape):
        drawn.append(shape)
        return torch.tensor(np.asarray(jax.random.normal(key, shape,
                                                          jnp.float32)))

    with torch.no_grad():
        got = encode_to_latent(t, torch.from_numpy(x),
                               posterior if sample else None)
    assert drawn == ([(1, 8, 8, 4)] if sample else [])
    assert got.shape == want.shape == (1, 8, 8, 4)
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * float(np.abs(want).max()))


def test_encoder_downsample_pads_bottom_right(models):
    """DownsampleVAE pads (0, 1, 0, 1) before its stride-2 conv: the first
    output pixel sees input rows/cols 0..2, none of them padding."""
    down = models["vae"][2].encoder.down[0].downsample
    x = torch.randn(1, 32, 8, 8)
    with torch.no_grad():
        got = down(x)
        want = F.conv2d(x, down.conv.weight, down.conv.bias, stride=2,
                        padding=0)
    assert got.shape == (1, 32, 4, 4)
    torch.testing.assert_close(got[..., :3, :3], want, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------ resize

@pytest.mark.parametrize("method", ["nearest", "lanczos3"])
@pytest.mark.parametrize("n_in,n_out", [(8, 12), (8, 16), (64, 8), (64, 96),
                                        (16, 2)])
def test_resize_matches_jax(method, n_in, n_out):
    x = np.random.RandomState(n_in + n_out).randn(2, n_in, n_in + 8,
                                                  3).astype(np.float32)
    size = (n_out, (n_in + 8) * n_out // n_in)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2,) + size + (3,),
                                       method))
    got = resize(torch.from_numpy(x), size, method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if method == "nearest":     # torch's nearest-exact, not its nearest
        exact = F.interpolate(nchw(x), size=size, mode="nearest-exact")
        np.testing.assert_array_equal(exact.permute(0, 2, 3, 1).numpy(), got)


# ------------------------------------------------------- modes, end to end

def normal(key, shape):
    return np.asarray(jax.random.normal(key, shape, jnp.float32))


def step_noise(key, shape, n):
    return [normal(k, shape) for k in jax.random.split(key, n)]


def jax_noise(opts, key):
    """The ArrayNoise of every draw the JAX pipeline makes for `opts`."""
    b, h, w = opts["n_samples"], opts["H"] // 8, opts["W"] // 8
    steps = opts["sampling_steps"]
    t_enc = max(1, int(opts.get("strength", 0.75) * steps))
    shape = (b, h, w, 4)
    mode = opts.get("mode", "text_to_image")
    if mode == "image_to_image":
        return ArrayNoise(None, step_noise(key, shape, t_enc),
                          encode=normal(key, shape),
                          posterior=normal(jax.random.fold_in(key, 7),
                                           (1, h, w, 4)))
    # DDIM runs one step per timestep of range(0, 1000, 1000 // steps)
    n = len(range(0, 1000, 1000 // steps)) if opts["sampler"] == "DDIM" \
        else steps
    hires = None
    if opts.get("use_hires_fix"):
        f = opts["hires_fix_scale_factor"]
        hshape = (b, int(h * f) // 8 * 8, int(w * f) // 8 * 8, 4)
        key2 = jax.random.fold_in(key, 1)
        hires = ArrayNoise(None, step_noise(key2, hshape, t_enc),
                           encode=normal(key2, hshape))
    return ArrayNoise(normal(key, shape), step_noise(key, shape, n),
                      hires=hires)


MODE_CASES = {
    "img2img-dpmpp2m": dict(mode="image_to_image", sampler="DPM++ 2M",
                            strength=0.75),
    "img2img-ddim": dict(mode="image_to_image", sampler="DDIM", strength=0.5),
    "img2img-euler_a": dict(mode="image_to_image", sampler="Euler A",
                            strength=0.6),
    "inpaint-ddim": dict(mode="inpainting", sampler="DDIM"),
    "inpaint-euler_a": dict(mode="inpainting", sampler="Euler A"),
    "hires-latent": dict(use_hires_fix=True, hires_fix_upscaler="Latent",
                         hires_fix_scale_factor=1.5, sampler="Euler A",
                         H=128, W=128, sampling_steps=3, n_samples=1),
    "hires-lanczos": dict(use_hires_fix=True, hires_fix_upscaler="Lanczos",
                          hires_fix_scale_factor=2.0, sampler="Euler",
                          n_samples=1, strength=0.5),
}


@pytest.mark.parametrize("case", sorted(MODE_CASES))
def test_mode_matches_jax(pipes, case):
    opts = dict(BASE, **MODE_CASES[case])
    inpaint = opts.get("mode") == "inpainting"
    jp, tp = pipes[inpaint]
    img = init_image(opts["H"], opts["W"], seed=5)
    mask = mask_image() if inpaint else None
    kw = dict(init_image=img if opts.get("mode") else None, mask_image=mask)
    key = key_for_image(42, 0)
    t_enc = max(1, int(opts.get("strength", 0.75) * opts["sampling_steps"]))
    n_steps = len(range(0, 1000, 1000 // opts["sampling_steps"])) \
        if opts["sampler"] == "DDIM" else opts["sampling_steps"]

    # latents: 1e-5 of their range (float32 summation order)
    jo, to = JOptions(**opts), GenerationOptions(**opts)
    c, uc = jp._conditioning(jo, opts["n_samples"])
    tc, tuc = tp._conditioning(to, opts["n_samples"])
    noise = jax_noise(opts, key)
    with torch.no_grad():
        if inpaint:
            want, want_m = jp.inpaint_latents(jo, img, mask, c, uc, key)
            got, got_m = tp.inpaint_latents(to, img, mask, tc, tuc, noise)
            np.testing.assert_array_equal(got_m, want_m)
        elif opts.get("mode"):
            want = jp.img2img_latents(jo, img, c, uc, key)
            got = tp.img2img_latents(to, img, tc, tuc, noise)
        else:
            want = jp.txt2img_latents(jo, c, uc, key)
            got = tp.txt2img_latents(to, tc, tuc, noise)
    want = np.asarray(want)
    assert got.shape == want.shape
    # "Lanczos" rounds its resized image to bf16 before the encode, as the
    # JAX pipeline does: the images agree to 1e-6 of their range, but 56 of
    # 49152 values lie near a bf16 rounding boundary and round one step
    # apart, which moves the latents by 2.5e-4 of their range (measured)
    tol = 5e-4 if opts.get("hires_fix_upscaler") == "Lanczos" else 1e-5
    np.testing.assert_allclose(got.numpy(), want,
                               atol=tol * float(np.abs(want).max()))

    # images: the 2/255 of test_txt2img_matches_jax (a latent near a bf16
    # boundary rounds one step apart before the decode); the inpainted
    # images keep the unmasked pixels of the input exactly
    j_msgs, t_msgs = [], []
    want = JPipeline.generate(jp, jo, status_cb=j_msgs.append, **kw)
    got = tp.generate(to, status_cb=t_msgs.append,
                      noise=lambda seed, device: jax_noise(opts, key), **kw)
    assert len(got) == len(want) == opts["n_samples"]
    side = lambda s: (int(s // 8 * opts["hires_fix_scale_factor"]) // 8 * 64
                      if opts.get("use_hires_fix") else s)
    for (gi, gm), (wi, wm) in zip(got, want):
        assert gi.shape == wi.shape == (side(opts["H"]), side(opts["W"]), 3)
        assert_img01_close(gi, wi, float_tol=2.0 / 255.0)
        assert gm == wm
        if inpaint:
            keep = mask < 0.5
            np.testing.assert_array_equal(gi[keep], ((img + 1) / 2)[keep])
    # JAX posts its step statuses from host callbacks that may land after
    # a later status; the port posts them in order
    assert sorted(t_msgs) == sorted(j_msgs)
    passes = [(t_enc, t_enc)] if opts.get("mode") == "image_to_image" else \
        [(n_steps, opts["sampling_steps"])]
    if opts.get("use_hires_fix"):
        passes.append((t_enc, t_enc))
    assert t_msgs == ["batch 1/1: encoding prompt"] + [
        f"{i + 1} / {total}" for n, total in passes for i in range(n)] + [
        "decoding"]


def test_inpaint_extra_channels_follow_x(pipes, monkeypatch):
    """The UNet input is [x, mask, masked-image latent] along channels, as
    the JAX package concatenates them channel-last."""
    tp = pipes[True][1]
    seen = []
    unet = tp.bundle.unet
    monkeypatch.setattr(unet, "forward",
                        lambda x, t, ctx, control=None: seen.append(x) or x[:, :4])
    extra = torch.arange(5.0).reshape(1, 1, 1, 5).expand(1, 2, 2, 5)
    x = torch.full((2, 2, 2, 4), -1.0)
    tp._eps_model(extra)(x, torch.zeros(2), None)
    got = seen[0]
    assert got.shape == (2, 9, 2, 2)
    assert (got[:, :4] == -1).all()
    assert [float(got[1, 4 + k, 0, 0]) for k in range(5)] == [0, 1, 2, 3, 4]


# ------------------------------------------------------------- PNG reader

def _pil_png(arr, mode, **save):
    img = Image.fromarray(arr, mode) if mode != "P" else \
        Image.fromarray(arr).quantize(61)
    buf = io.BytesIO()
    img.save(buf, "PNG", **save)
    return buf.getvalue()


def _pil_decode(data, mode):
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode))


def _png_filters(data):
    """The row filter types of an 8-bit PNG's image data."""
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, _, ctype = hdr[:4]
    stride = w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype] + 1
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * stride] for y in range(h)}


def _pixels(kind, mode, h=23, w=37):
    rng = np.random.RandomState(len(mode) + len(kind))
    if kind == "noise":
        rgb = rng.randint(0, 256, (h, w, 3))
    else:   # smooth ramps, which PIL's adaptive filtering codes with Sub/Up
        yy, xx = np.mgrid[0:h, 0:w]
        rgb = np.stack([xx * 6, yy * 9, (xx + yy) * 4], -1) + rng.randint(0, 3,
                                                                         (h, w, 3))
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    return {"RGB": rgb, "RGBA": np.dstack([rgb, rgb[..., 1]]),
            "L": rgb[..., 0], "LA": np.dstack([rgb[..., 0], rgb[..., 2]]),
            "P": rgb}[mode]


PNG_CASES = [(m, k) for m in ("L", "LA", "RGB", "RGBA", "P")
             for k in ("noise", "ramp")]


@pytest.mark.parametrize("mode,kind", PNG_CASES)
def test_png_reader_matches_pil(mode, kind):
    """PNGs as PIL writes them (each colour type; its adaptive filters),
    decoded to RGB and to L: exactly PIL's pixels."""
    data = _pil_png(_pixels(kind, mode), mode)
    for out in ("RGB", "L"):
        got, _ = decode_png(data, out)
        want = _pil_decode(data, out)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_pil_written_cases_cover_the_filters():
    seen = set()
    for mode, kind in PNG_CASES:
        seen |= _png_filters(_pil_png(_pixels(kind, mode), mode))
    assert {0, 1, 2, 4} <= seen       # PIL never picks Average (3) here


def _filtered_png(px, ctype, kind):
    """An 8-bit PNG of (H, W, samples) px, every row coded with filter
    `kind` (PNG spec section 9): the Average filter included, which
    PIL's encoder does not choose."""
    h, w, bpp = px.shape
    rows = px.reshape(h, w * bpp).astype(np.int64)
    out = []
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if kind == 3:
            pred = (left + up) // 2
        elif kind == 4:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        else:
            pred = [np.zeros_like(cur), left, up][kind]
        out.append(bytes([kind]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(k, body):
        return (struct.pack(">I", len(body)) + k + body
                + struct.pack(">I", zlib.crc32(k + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype,samples", [(2, 3), (4, 2), (6, 4)])
def test_png_reader_undoes_every_filter(kind, ctype, samples):
    px = np.random.RandomState(kind).randint(0, 256, (9, 13, samples)).astype(
        np.uint8)
    data = _filtered_png(px, ctype, kind)
    assert _png_filters(data) == {kind}
    for out in ("RGB", "L"):
        np.testing.assert_array_equal(decode_png(data, out)[0],
                                      _pil_decode(data, out))


@pytest.mark.parametrize("h,w", [(1, 1), (1, 7), (6, 1), (3, 40)])
def test_png_reader_undoes_the_filters_of_thin_images(h, w):
    """Images one pixel wide or high, each row with its own filter."""
    rng = np.random.RandomState(h * w)
    px = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
    for kind in range(5):
        data = _filtered_png(px, 6, kind)
        np.testing.assert_array_equal(decode_png(data)[0],
                                      _pil_decode(data, "RGB"))


def test_png_reader_refuses_what_it_cannot_read():
    buf = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999).save(
        buf, "PNG")
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(buf.getvalue())
    laced = bytearray(_filtered_png(np.zeros((4, 4, 3), np.uint8), 2, 0))
    laced[8 + 8 + 12] = 1          # the IHDR's interlace byte
    laced[8 + 8 + 13:8 + 8 + 17] = struct.pack(
        ">I", zlib.crc32(bytes(laced[12:29])) & 0xFFFFFFFF)
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(bytes(laced))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


def test_png_reader_inflates_no_more_than_the_header_says():
    """Image data past the header's h * (w * bpp + 1) bytes (here 16 MB of
    zeros after a 4x4 image) is not inflated; an edge above max_edge is
    refused from the header alone."""
    px = np.random.RandomState(9).randint(0, 256, (4, 4, 3)).astype(np.uint8)
    rows = np.concatenate([np.zeros((4, 1), np.uint8), px.reshape(4, 12)], 1)
    z = zlib.compressobj()
    idat = z.compress(rows.tobytes() + bytes(1 << 24)) + z.flush()

    def chunk(k, body):
        return (struct.pack(">I", len(body)) + k + body
                + struct.pack(">I", zlib.crc32(k + body) & 0xFFFFFFFF))

    def png(w, h):
        return (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", idat) + chunk(b"IEND", b""))

    np.testing.assert_array_equal(decode_png(png(4, 4), max_edge=4)[0], px)
    with pytest.raises(ValueError, match="edge exceeds 4096"):
        decode_png(png(60000, 60000), max_edge=4096)
    with pytest.raises(ValueError, match="zero pixels"):
        decode_png(png(0, 4))
