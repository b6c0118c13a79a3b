"""Kandinsky 2.2: the port's prior, image conditioner, decoder UNet, MoVQ,
schedule, key maps, loader, pipeline and backend against the JAX package.

Three tests that loop over their cases (under `--dist load` the number of
collected items sets the suite's wall time, ROADMAP.md), at the JAX tests'
tiny sizes (tests/test_kandinsky_bundle.py `tiny_cfgs`: a prior of hidden
32, 2 layers, 4 heads over 7 + 4 tokens; a decoder UNet of (32, 64)
channels, one layer per block, 16-wide heads, 3 context tokens of 16; a
MoVQ of (32, 64) channels), with the synthetic component files of
tests/test_diffusers_keys.py and a text tower in the HF layout of
tests/test_kandinsky_bundle.py `tiny_hf_text_model` (width 16, 2 layers,
7 positions), written from seeded tensors: importing transformers to
build it costs 10-15 s of a test worker's time, and JAX's loader is held
against transformers by that JAX test:

- the modules and the schedule: each module on the same weights and
  inputs as JAX's, the squaredcos table, the published configs;
- files and generate(): the four files through both loaders, txt2img and
  inpainting against the JAX pipeline with its noise, the img2img refusal;
- serving: /v1/generate with "Kandinsky 2.2" through `kandinsky_factory`
  against JAX's `kandinsky_backend`, path delivery and the refusals.

Each case states its tolerance.
"""
import base64
import dataclasses
import json
import time
import urllib.parse
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import hf_openclip_key
from cremage_tpu.core.config import GenerationOptions as JOptions
from cremage_tpu.core.dtypes import FP32_POLICY
from cremage_tpu.core.rng import key_for_image
from cremage_tpu.io.diffusers_keys import (
    kandinsky_decoder_from_diffusers as j_dec_keys,
)
from cremage_tpu.io.diffusers_keys import kandinsky_prior_from_diffusers as j_prior_keys
from cremage_tpu.io.diffusers_keys import movq_decoder_from_diffusers as j_movq_keys
from cremage_tpu.models import kandinsky as JK
from cremage_tpu.models import kandinsky_decoder as JKD
from cremage_tpu.models import vq as JVQ
from cremage_tpu.pipelines import kandinsky as JPIPE
from cremage_tpu.pipelines import loader as JLOADER
from cremage_tpu.samplers import schedules as JS
from cremage_tpu_torch.app import dirs
from cremage_tpu_torch.app.backends import ResidentInstance, kandinsky_factory
from cremage_tpu_torch.app.server import ApiServer
from cremage_tpu_torch.app.worker import EngineWorker
from cremage_tpu_torch.core.config import GenerationOptions, Preferences
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.io import checkpoint as CK
from cremage_tpu_torch.io import convert
from cremage_tpu_torch.io.diffusers_keys import (
    kandinsky_decoder_from_diffusers, kandinsky_prior_from_diffusers,
    movq_decoder_from_diffusers,
)
from cremage_tpu_torch.io.png import decode_png, encode_png
from cremage_tpu_torch.models import kandinsky as K
from cremage_tpu_torch.models import kandinsky_decoder as KD
from cremage_tpu_torch.models import vq as VQ
from cremage_tpu_torch.models.open_clip import OpenCLIPTextConfig, OpenCLIPTextModel
from cremage_tpu_torch.pipelines import loader as LOADER
from cremage_tpu_torch.pipelines.kandinsky import (
    IMG2IMG_REFUSAL, KandinskyPipeline, kandinsky_schedule,
)
from cremage_tpu_torch.samplers import schedules as S
from tests.conftest import assert_img01_close
from tests.test_diffusers_keys import (
    PRI_C, PRI_E, PRI_T, PRI_TOK, synth_diffusers_kandinsky_unet,
    synth_diffusers_movq, synth_diffusers_prior,
)
from tests.test_torch_flux import _rel
from tests.test_torch_pipeline import (  # noqa: F401
    cheap_jax, jax_params, shared_template,
)
from tests.test_torch_sd3 import record_loaders

torch.set_num_threads(2)
F32 = torch.float32
PRIOR_KW = dict(image_embed_dim=PRI_E, text_embed_dim=PRI_T, hidden=PRI_C,
                num_layers=2, num_heads=4, text_tokens=PRI_TOK)
UNET_KW = dict(block_out_channels=(32, 64), layers_per_block=1,
               attention_head_dim=16)
MOVQ_KW = dict(block_out_channels=(32, 64), layers_per_block=1)
# the synthetic files' weights are unit normals (tests/test_diffusers_keys.py);
# scaled by WEIGHT_SCALE the latents and pixels stay away from saturation
WEIGHT_SCALE = 0.25
OPTS = dict(prompt="a photo of a cat", negative_prompt="blurry", H=32, W=32,
            sampling_steps=3, n_samples=2, n_iter=1, seed=5, scale=4.0,
            safety_check=False, watermark=False)


@pytest.fixture(scope="module", autouse=True)
def _fresh_xla_caches():
    """As tests/test_torch_modes.py: clear the worker's compiled programs
    before this module's JAX programs run."""
    jax.clear_caches()
    yield


def _jax_cfgs():
    return dict(
        prior_cfg=JK.PriorConfig(**PRIOR_KW, dtype=jnp.float32),
        decoder_cfg=JKD.KandinskyUNetConfig(**UNET_KW, dtype=jnp.float32),
        movq_cfg=JVQ.MoVQConfig(**MOVQ_KW, dtype=jnp.float32))


def _tiny_port_loader(monkeypatch):
    """The port's loader at the tiny configs (it builds the published ones:
    its config classes swapped, as tests/test_torch_hunyuan.py swaps its
    config functions)."""
    monkeypatch.setattr(LOADER, "PriorConfig",
                        lambda **kw: K.PriorConfig(**PRIOR_KW, **kw))
    monkeypatch.setattr(LOADER, "KandinskyUNetConfig",
                        lambda **kw: KD.KandinskyUNetConfig(**UNET_KW, **kw))
    monkeypatch.setattr(LOADER, "MoVQConfig",
                        lambda **kw: VQ.MoVQConfig(**MOVQ_KW, **kw))


def _check_modules():
    """The prior (its causal mask over 7 + 4 tokens, the output at the last
    position), the conditioner, the decoder UNet (added-KV attention over
    [3 context; 48 or 12 spatial] keys, the in-block pool and upsampling,
    a 8x6 latent) and MoVQ's decoder (SpatialNorm's zq upsampled 2x, its
    mid attention) on seeded weights, each within 1e-5 of its range of
    JAX's in float32; the eps half of the decoder's 8 channels."""
    rng = np.random.RandomState(9)
    t = np.array([500.3, 3.0], np.float32)
    cases = [
        (JK.DiffusionPrior(JK.PriorConfig(**PRIOR_KW, dtype=jnp.float32)),
         K.DiffusionPrior(K.PriorConfig(**PRIOR_KW, dtype=F32)),
         [rng.randn(2, PRI_E), t, rng.randn(2, PRI_TOK, PRI_T),
          rng.randn(2, PRI_T)], lambda m, a: m(*a)),
        (JK.KandinskyImageConditioner(time_embed_dim=128, cross_dim=16,
                                      num_tokens=3, dtype=jnp.float32),
         K.KandinskyImageConditioner(PRI_E, 128, 16, 3, dtype=F32),
         [rng.randn(2, PRI_E)], lambda m, a: m(*a)),
        (JKD.KandinskyUNet(JKD.KandinskyUNetConfig(
            **UNET_KW, context_dim=16, dtype=jnp.float32)),
         KD.KandinskyUNet(KD.KandinskyUNetConfig(**UNET_KW, context_dim=16,
                                                 dtype=F32)),
         [rng.randn(2, 8, 6, 4), t, rng.randn(2, 3, 16), rng.randn(2, 128)],
         lambda m, a: m(*a)),
        (JVQ.MoVQDecoder(JVQ.MoVQConfig(**MOVQ_KW, dtype=jnp.float32)),
         VQ.MoVQDecoder(VQ.MoVQConfig(**MOVQ_KW, dtype=F32)),
         [rng.randn(1, 4, 6, 4), rng.randn(1, 4, 6, 4)],
         lambda m, a: m(*(x.permute(0, 3, 1, 2) for x in a)).permute(0, 2, 3, 1)),
    ]
    for seed, (jm, tm, args, call) in enumerate(cases):
        args = [np.asarray(a, np.float32) for a in args]
        zeros = [jnp.zeros((1,) + a.shape[1:]) for a in args]
        if isinstance(jm, JVQ.MoVQDecoder):
            zeros = zeros[:1]
        params = jax_params(jm, 30 + seed, *zeros)
        want = jax.jit(jm.apply)(params, *map(jnp.asarray, args))
        port = convert.load_from_jax(tm, params["params"]).eval()
        with torch.no_grad():
            got = call(port, [torch.from_numpy(a) for a in args])
        for g, w in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            assert g.shape == w.shape and _rel(g.numpy(), w) <= 1e-5, type(tm)
        if isinstance(tm, KD.KandinskyUNet):
            assert torch.equal(KD.kandinsky_decoder_eps(got), got[..., :4])


def _check_schedule_and_configs():
    """The squaredcos_cap_v2 betas and the Kandinsky table's sigmas equal
    JAX's in float64 (and at 500 steps); the published configs are JAX's
    field for field."""
    for n in (1000, 500):
        np.testing.assert_array_equal(S.make_betas_squaredcos(n),
                                      JS.make_betas_squaredcos(n))
    ours, theirs = kandinsky_schedule(), JPIPE.kandinsky_schedule()
    np.testing.assert_array_equal(ours.sigmas, theirs.sigmas)
    for steps in (25, 50):
        np.testing.assert_array_equal(ours.get_sigmas(steps),
                                      np.asarray(theirs.get_sigmas(steps)))
    for ours, theirs in ((K.PriorConfig(), JK.PriorConfig()),
                         (KD.KandinskyUNetConfig(), JKD.KandinskyUNetConfig()),
                         (VQ.MoVQConfig(), JVQ.MoVQConfig())):
        names = {f.name for f in dataclasses.fields(ours)} - {"dtype"}
        assert {n: getattr(ours, n) for n in names} == {
            n: getattr(theirs, n) for n in names}
    assert KD.KandinskyUNetConfig().time_embed_dim == 1536


def test_modules_and_schedule_match_jax():
    """`_check_modules`, then `_check_schedule_and_configs`."""
    _check_modules()
    _check_schedule_and_configs()


TEXT_CFG = OpenCLIPTextConfig(width=PRI_T, num_layers=2, num_heads=1,
                              max_positions=PRI_TOK, mlp_ratio=2, dtype=F32)


def _hf_text_tower(seed=15):
    """An HF CLIPTextModelWithProjection state dict of TEXT_CFG's shapes
    (tiny_hf_text_model's) from seeded tensors, with the position_ids
    buffer older transformers saved."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in OpenCLIPTextModel(TEXT_CFG).state_dict().items():
        w = torch.randn(v.shape, generator=gen) * 0.3
        if k.endswith(("ln_1.weight", "ln_2.weight", "ln_final.weight")):
            w = w + 1.0
        out[hf_openclip_key(k)] = w.t() if k == "text_projection" else w
    out["text_model.embeddings.position_ids"] = torch.arange(PRI_TOK)[None]
    return out


def _write_files(root):
    """The four component files: the JAX tests' synthetic state dicts
    (weights times WEIGHT_SCALE, stored fp16 as published), the MoVQ file
    with encoder and quant_conv keys, which the loaders drop, and the text
    tower (`_hf_text_tower`). -> {component: path}."""
    paths = {}
    rng = np.random.RandomState(14)
    movq = synth_diffusers_movq()
    movq.update({"encoder.conv_in.weight": rng.randn(32, 3, 3, 3),
                 "encoder.conv_in.bias": rng.randn(32),
                 "quant_conv.weight": rng.randn(4, 4, 1, 1),
                 "quant_conv.bias": rng.randn(4)})
    for name, sd in (("prior", synth_diffusers_prior(depth=2)),
                     ("decoder", synth_diffusers_kandinsky_unet()),
                     ("movq", movq)):
        scaled = {k: torch.from_numpy(np.asarray(v, np.float32) * (
            1.0 if k.startswith("clip_") else WEIGHT_SCALE)).half()
            for k, v in sd.items()}
        paths[name] = str(root / f"{name}.safetensors")
        CK.save_safetensors(paths[name], scaled)
    paths["text_encoder"] = str(root / "text_encoder.safetensors")
    CK.save_safetensors(paths["text_encoder"], _hf_text_tower())
    return paths


def _tiny_jax_loader(monkeypatch):
    monkeypatch.setattr(JLOADER, "_template", shared_template(_jax_template))


_jax_template = JLOADER._template    # unpatched, whatever a test swaps in


def _load_both(paths):
    """(the JAX bundle, the port's) from the same files, in float32."""
    jb = JLOADER.load_kandinsky_bundle(
        paths["prior"], paths["decoder"], paths["text_encoder"],
        movq_ckpt=paths["movq"], policy=FP32_POLICY, **_jax_cfgs())
    tb = LOADER.load_kandinsky_bundle(
        paths["prior"], paths["decoder"], paths["text_encoder"],
        movq_ckpt=paths["movq"], device="cpu", dtype=F32)
    return jb, tb


def _check_loaded(paths, jb, tb):
    """Every weight of the port's bundle equals the file's and JAX's loaded
    parameters carried into the port's modules; the key maps give JAX's
    keys (the port's MoVQ names carry `decoder.`; the codebook, encoder and
    quant_conv dropped by name) and raise on a key they do not know;
    clip_mean / clip_std equal JAX's; the text tower's states and pooled
    output within 1e-5 of their range of JAX's text_encode's on three
    prompts (one past 77 tokens); the load report names every file."""
    raw = {k: CK.load_state_dict(p) for k, p in paths.items()}
    np_raw = {k: {n: v.numpy() for n, v in sd.items()} for k, sd in raw.items()}
    prior = kandinsky_prior_from_diffusers(raw["prior"])
    want = j_prior_keys(np_raw["prior"])
    assert set(prior) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(prior[k].numpy(), v, err_msg=k)
    body, heads = kandinsky_decoder_from_diffusers(raw["decoder"])
    jbody, jheads = j_dec_keys(np_raw["decoder"])
    assert set(body) == set(jbody) and set(heads) == set(jheads)
    movq = movq_decoder_from_diffusers(raw["movq"])
    jmovq = j_movq_keys(np_raw["movq"])
    jmovq.pop("quantize.embedding")
    assert {k[len("decoder."):] if k.startswith("decoder.") else k
            for k in movq} == set(jmovq)
    for bad, conv in (("prior", kandinsky_prior_from_diffusers),
                      ("movq", movq_decoder_from_diffusers)):
        with pytest.raises(KeyError, match="unknown key"):
            conv(dict(raw[bad], **{"transformer_blocks.0.attn2.to_q.weight"
                                   if bad == "prior" else
                                   "loss.discriminator.weight":
                                   torch.zeros(2, 2)}))

    for model, params in ((tb.prior, jb.prior_params),
                          (tb.decoder, jb.decoder_params),
                          (tb.image_cond, jb.image_cond_params)):
        carried = convert.state_dict_from_jax(model, params["params"])
        for k, v in model.state_dict().items():
            assert torch.equal(carried[k], v), k
    for k, v in raw["movq"].items():
        if k.startswith(("decoder.", "post_quant_conv.")):
            assert torch.equal(tb.movq.state_dict()[k], v.float()), k
    for name in ("clip_mean", "clip_std"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      getattr(jb, name))
    for p in ("a photo of a cat", "", " ".join(["the quick fox"] * 30)):
        for g, w in zip(tb.text.encode(p, "cpu"), jb.text_encode(p)):
            assert g.shape == w.shape and _rel(g.numpy(), w) <= 1e-5
    assert set(tb.load_report["files"]) == set(paths.values())


def _jax_noise(seed, shape, steps, prior_dim):
    """The JAX pipeline's draws for a batch: the decoder's initial noise
    and Euler A steps from key_for_image(seed, 0), the prior's from
    fold_in(key, 1) over its 25 steps."""
    key = key_for_image(seed, 0)
    kp = jax.random.fold_in(key, 1)

    def draws(k, shp, n):
        return (np.asarray(jax.random.normal(k, shp, jnp.float32)),
                [np.asarray(jax.random.normal(s, shp, jnp.float32))
                 for s in jax.random.split(k, n)])

    init, steps_noise = draws(key, shape, steps)
    pinit, psteps = draws(kp, (1, prior_dim), 25)
    return ArrayNoise(init, steps_noise, prior=ArrayNoise(pinit, psteps))


def _check_generate(jb, tb):
    """generate() on the loaded bundles against JAX's pipeline, the port
    handed JAX's noise: txt2img with "DDIM" (outside the k-diffusion menu:
    Euler A, as JAX), inpainting with "DPM++ 2M" (Karras sigmas) and a
    mask over the left half (the unmasked pixels the init image's), both
    within 1e-4 plus one uint8 step of JAX's images (float32 on both
    sides); JAX's statuses and metadata; the prior's embedding within
    1e-5 of its range of JAX's run_prior; img2img with an init image
    refused with JAX's error before any status."""
    jpipe = JPIPE.KandinskyPipeline(jb)
    pipe = KandinskyPipeline(tb, device="cpu")
    rng = np.random.RandomState(3)
    init_img = rng.uniform(-1, 1, (8, 8, 3)).astype(np.float32)
    mask = np.zeros((8, 8), np.float32)
    mask[:, :4] = 1.0
    key = jax.random.fold_in(key_for_image(OPTS["seed"], 0), 1)
    want = jpipe.run_prior(OPTS["prompt"], OPTS["negative_prompt"],
                           OPTS["scale"], key)
    noise = _jax_noise(OPTS["seed"], (1, 4, 4, 4), 1, PRI_E)
    got = pipe.run_prior(OPTS["prompt"], OPTS["negative_prompt"],
                         OPTS["scale"], noise.prior())
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= 1e-5
    for sampler, mode in (("DDIM", "text_to_image"),
                          ("DPM++ 2M", "inpainting")):
        opts = dict(OPTS, sampler=sampler, mode=mode)
        images = dict(init_image=init_img, mask_image=mask) \
            if mode == "inpainting" else {}
        j_msgs, t_msgs = [], []
        ref = jpipe.generate(JOptions(**opts), status_cb=j_msgs.append, **images)
        steps = opts["sampling_steps"]
        got = pipe.generate(
            GenerationOptions(**opts), status_cb=t_msgs.append,
            noise=lambda seed, dev: _jax_noise(seed, (2, 4, 4, 4), steps, PRI_E),
            **images)
        assert t_msgs == ["prior", "decoder", "1 / 3", "2 / 3", "3 / 3"]
        assert sorted(j_msgs) == sorted(t_msgs)
        assert len(got) == len(ref) == 2
        for (gi, gm), (wi, wm) in zip(got, ref):
            assert gi.shape == (8, 8, 3) and gi.std() > 0.02
            assert_img01_close(gi, wi, float_tol=1e-4)
            assert gm == wm
            if mode == "inpainting":
                np.testing.assert_array_equal(gi[:, 4:],
                                              (init_img[:, 4:] + 1) / 2)
    msgs = []
    with pytest.raises(RuntimeError) as e:
        pipe.generate(GenerationOptions(**dict(OPTS, mode="image_to_image")),
                      status_cb=msgs.append, init_image=init_img)
    with pytest.raises(RuntimeError) as je:
        jpipe.generate(JOptions(**dict(OPTS, mode="image_to_image")),
                       init_image=init_img)
    assert str(e.value) == str(je.value) == IMG2IMG_REFUSAL and not msgs


def test_files_and_generate_match_jax(tmp_path, monkeypatch):
    """The four files through both loaders (`_check_loaded`), then
    generate() against JAX's pipeline (`_check_generate`)."""
    paths = _write_files(tmp_path)
    _tiny_jax_loader(monkeypatch)
    _tiny_port_loader(monkeypatch)
    jb, tb = _load_both(paths)
    _check_loaded(paths, jb, tb)
    _check_generate(jb, tb)


def _http(port, path, body=None, raw=False):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        data = r.read()
        return (data, r.headers["Content-Type"]) if raw else json.loads(data)


def _job(port, params, mode="text_to_image"):
    _http(port, "/v1/generate", {"generator_model_type": "Kandinsky 2.2",
                                 "mode": mode, "parameters": params})
    msgs = []
    while not any(isinstance(m, dict) and "job_done" in m for m in msgs):
        got = _http(port, "/v1/status")["messages"]
        msgs += got
        if not got:     # leave the GIL to the job's thread
            time.sleep(0.02)
    return msgs


def _png(msgs):
    img = next(m for m in msgs if isinstance(m, dict) and "image_b64" in m)
    return base64.b64decode(img["image_b64"])


def test_http_job_as_jax_kandinsky_backend(tmp_path, monkeypatch):
    """/v1/generate with "Kandinsky 2.2": the port's factory hands its
    loader JAX's backend's arguments for a job that names kandinsky_dir
    and for one that names each file, and both give JAX's error where the
    directory holds no prior; /v1/meta lists the type; the options the
    port does not run are refused before any load, and a load without the
    MoVQ file; a txt2img job served from kandinsky_dir is the resident
    pipeline's own image for the seed under JAX's resident key; an
    inpainting job on an uploaded init image and mask keeps the unmasked
    pixels; with result_delivery "path" the PNG lands under the app root
    (HOME is the test's) with the inline result's bytes, and
    /v1/images/file serves them."""
    from cremage_tpu.app import backends as JBACKENDS
    from cremage_tpu.app.worker import EngineWorker as JWorker
    from cremage_tpu.core.config import Preferences as JPrefs

    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    files = tmp_path / "kandinsky"
    files.mkdir()
    paths = _write_files(files)
    base = dict(OPTS, n_samples=1, seed=9)
    explicit = dict(base, prior_ckpt=paths["prior"],
                    decoder_ckpt=paths["decoder"],
                    text_encoder_ckpt=paths["text_encoder"],
                    movq_ckpt=paths["movq"])
    for params in (dict(base, kandinsky_dir=str(files)), explicit,
                   dict(base, kandinsky_dir=str(tmp_path))):
        with monkeypatch.context() as mp:
            seen = record_loaders(mp, "load_kandinsky_bundle")
            jw = JWorker()
            JBACKENDS.register_default_backends(jw, JPrefs())
            errors = []
            for gen in (jw._factories["Kandinsky 2.2"](),
                        kandinsky_factory(Preferences(), device="cpu")()):
                with pytest.raises((LookupError, FileNotFoundError)) as e:
                    gen(dict(params), lambda m: None, None)
                errors.append((e.type, str(e.value)))
        if errors[0][0] is FileNotFoundError:      # no prior there
            assert errors[1] == errors[0] and not seen
            continue
        (j_args, j_kw), (t_args, t_kw) = seen["jax"], seen["port"]
        assert t_args == j_args == tuple(
            paths[k] for k in ("prior", "decoder", "text_encoder"))
        assert {k: v for k, v in t_kw.items() if k != "device"} == j_kw
    with pytest.raises(FileNotFoundError, match="movq_ckpt"):
        LOADER.load_kandinsky_bundle(paths["prior"], paths["decoder"],
                                     paths["text_encoder"], device="cpu")

    _tiny_port_loader(monkeypatch)
    worker, resident = EngineWorker(), ResidentInstance()
    worker.register_backend("Kandinsky 2.2", kandinsky_factory(
        Preferences(), device="cpu", resident=resident))
    srv = ApiServer(worker=worker, port=0, upload_dir=str(tmp_path))
    srv.start()
    try:
        assert "Kandinsky 2.2" in _http(srv.port, "/v1/meta")["model_types"]
        params = dict(base, kandinsky_dir=str(files))
        for bad in (dict(tome_ratio=0.5), dict(deep_cache=2)):
            done = _job(srv.port, dict(params, **bad))[-1]["job_done"]
            assert not done["ok"] and "not ported" in done["error"]
        assert resident.instance is None     # refused before any load
        inline = _job(srv.port, params)
        assert inline[-1] == {"job_done": {"ok": True, "error": None}}, inline
        png = _png(inline)
        assert resident.key == ("kandinsky", paths["prior"], paths["decoder"],
                                paths["text_encoder"], paths["movq"])
        want = resident.instance.generate(GenerationOptions.from_dict(params))
        np.testing.assert_array_equal(
            decode_png(png)[0], np.round(want[0][0] * 255).astype(np.uint8))

        rng = np.random.RandomState(4)
        init = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
        mask = np.zeros((8, 8), np.uint8)
        mask[2:6, 2:6] = 255
        up = {}
        for name, arr in (("init_img", init),
                          ("mask_img", np.repeat(mask[..., None], 3, -1))):
            up[name] = _http(srv.port, "/v1/upload", {
                "image": base64.b64encode(encode_png(arr)).decode()})["path"]
        msgs = _job(srv.port, dict(params, **up), mode="inpainting")
        assert msgs[-1] == {"job_done": {"ok": True, "error": None}}, msgs
        got = decode_png(_png(msgs))[0]
        keep = mask < 128
        np.testing.assert_array_equal(got[keep], init[keep])

        msgs = _job(srv.port, dict(params, result_delivery="path"))
        got = next(m for m in msgs if isinstance(m, dict) and "image_path" in m)
        assert got["image_path"].startswith(dirs.app_root())
        with open(got["image_path"], "rb") as f:
            assert f.read() == png
        q = urllib.parse.quote(got["image_path"])
        assert _http(srv.port, f"/v1/images/file?path={q}", raw=True) == (
            png, "image/png")
    finally:
        srv.stop()
