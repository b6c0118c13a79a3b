"""A CPU round trip through the port's HTTP API: POST /v1/generate, drain
/v1/status, decode the PNGs, inline and delivered by path. The message keys
must be the JAX worker's (cremage_tpu/app/worker.make_result_message)."""
import base64
import io
import json
import os
import struct
import time
import urllib.error
import urllib.parse
import urllib.request
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from cremage_tpu.app.worker import make_result_message as j_result_message
from cremage_tpu_torch.app import dirs
from cremage_tpu_torch.app.server import ApiServer, load_image, register_sd15
from cremage_tpu_torch.app.worker import EngineWorker, make_result_message
from cremage_tpu_torch.core.config import GenerationOptions
from cremage_tpu_torch.io.png import (
    GENERATION_DATA_KEY, decode_png, image_to_uint8,
)
from cremage_tpu_torch.models.clip import CLIPTextConfig
from cremage_tpu_torch.models.unet import UNetConfig
from cremage_tpu_torch.models.vae import VAEConfig
from cremage_tpu_torch.pipelines.sd15 import SD15Pipeline, build_sd15_bundle

torch.set_num_threads(2)

F32 = torch.float32


@pytest.fixture(scope="module")
def pipe():
    bundle = build_sd15_bundle(
        "cpu", dtype=F32, seed=0,
        unet_cfg=UNetConfig(model_channels=32, num_res_blocks=1,
                            attention_resolutions=(1,), channel_mult=(1, 2),
                            num_heads=4, transformer_depth=(1, 1),
                            context_dim=32, dtype=F32),
        vae_cfg=VAEConfig(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1,
                          dtype=F32),
        clip_cfg=CLIPTextConfig(hidden_size=32, num_layers=2, num_heads=4,
                                intermediate_size=64, dtype=F32))
    return SD15Pipeline(bundle, device="cpu")


@pytest.fixture(scope="module")
def server(pipe, tmp_path_factory):
    """The server on `pipe`, its app root (path delivery's outputs) under a
    temporary HOME."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HOME", str(tmp_path_factory.mktemp("home")))
    worker = EngineWorker()
    register_sd15(worker, pipe)          # no inpainting bundle
    srv = ApiServer(worker=worker, port=0,
                    upload_dir=str(tmp_path_factory.mktemp("uploads")))
    srv.start()
    yield f"http://127.0.0.1:{srv.port}"
    srv.stop()
    mp.undo()


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 method="GET" if body is None else "POST",
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=30).read())


def _drain(url, n_jobs, timeout=60.0):
    msgs, done = [], 0
    end = time.time() + timeout
    while done < n_jobs and time.time() < end:
        got = _call(url + "/v1/status")["messages"]
        msgs += got
        done += sum(1 for m in got if isinstance(m, dict) and "job_done" in m)
        if not got:
            time.sleep(0.05)
    assert done == n_jobs, msgs
    return msgs


def test_generate_round_trip(server):
    """Two PNGs inline with their metadata; the same job with
    result_delivery "path" writes the same PNG bytes under the app root's
    outputs (the JAX worker's message keys), which /v1/images/file serves
    as they are and /v1/images/meta reads back; /v1/health counts the
    kernels' launches."""
    body = {"generator_model_type": "SD 1.5", "mode": "text_to_image",
            "parameters": {"prompt": "a cat", "negative_prompt": "bad",
                           "H": 64, "W": 64, "sampling_steps": 2,
                           "sampler": "Euler A", "seed": 7, "n_samples": 2,
                           "safety_check": False, "watermark": False}}
    assert "job_id" in _call(server + "/v1/generate", body)
    msgs = _drain(server, 1)
    assert msgs[-1] == {"job_done": {"ok": True, "error": None}}
    assert [m for m in msgs if isinstance(m, str)][:2] == [
        "batch 1/1: encoding prompt", "1 / 2"]
    images = [m for m in msgs if isinstance(m, dict) and "image_b64" in m]
    assert len(images) == 2
    for k, m in enumerate(images):
        raw = base64.b64decode(m["image_b64"])
        pil = Image.open(io.BytesIO(raw))
        assert pil.size == (64, 64) and pil.mode == "RGB"
        rgb, text = decode_png(raw)
        np.testing.assert_array_equal(rgb, np.asarray(pil))
        meta = json.loads(text[GENERATION_DATA_KEY])
        assert meta == json.loads(m["generation_parameters"])
        assert meta["seed"] == 7 + k and meta["prompt"] == "a cat"

    body["parameters"]["result_delivery"] = "path"
    _call(server + "/v1/generate", body)
    msgs = _drain(server, 1)
    paths = [m for m in msgs if isinstance(m, dict) and "image_path" in m]
    outputs = os.path.join(dirs.app_root(), "outputs") + os.sep
    assert [set(m) for m in paths] == [{"image_path",
                                        "generation_parameters"}] * 2
    for m, inline in zip(paths, images):
        assert m["image_path"].startswith(outputs)
        png = base64.b64decode(inline["image_b64"])
        q = urllib.parse.quote(m["image_path"])
        with urllib.request.urlopen(f"{server}/v1/images/file?path={q}",
                                    timeout=30) as r:
            assert (r.read(), r.headers["Content-Type"]) == (png, "image/png")
        assert _call(f"{server}/v1/images/meta?path={q}") == {
            "generation_data": json.loads(m["generation_parameters"])}
    health = _call(server + "/v1/health")
    assert health["ok"] and "flash_attention_launches" in health["metrics"]


def test_unsupported_job_reports_failure(server):
    _call(server + "/v1/generate", {"generator_model_type": "SD 1.5",
                                    "prompt": "x", "H": 64, "W": 64,
                                    "sampler": "Euler A", "deep_cache": 3,
                                    "safety_check": False})
    done = _drain(server, 1)[-1]["job_done"]
    assert not done["ok"] and "NotImplementedError" in done["error"]


def test_bad_request_is_400(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _call(server + "/v1/generate", {"H": 65})
    assert e.value.code == 400


def test_result_message_keys_match_jax():
    img = np.random.RandomState(0).rand(8, 8, 3).astype(np.float32)
    meta = {"seed": 1, "prompt": "x"}
    ours, ref = make_result_message(img, meta), j_result_message(img, meta)
    assert set(ours) == set(ref)
    assert ours["generation_parameters"] == ref["generation_parameters"]
    np.testing.assert_array_equal(decode_png(ours["image"])[0],
                                  np.asarray(Image.open(io.BytesIO(ref["image"]))))


def _png_b64(arr, mode):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_meta_lists_the_menu(server):
    meta = _call(server + "/v1/meta")
    assert meta["samplers"] == ["DDIM", "DPM++ 2M", "DPM++ 2M SDE",
                                "DPM++ 2S A", "DPM++ 3M SDE", "DPM++ SDE",
                                "DPM2", "DPM2 A", "Euler", "Euler A", "Heun",
                                "LMS"]
    assert meta["modes"] == ["text_to_image", "image_to_image", "inpainting"]
    assert meta["samplers_by_type"]["SD 1.5"] == meta["samplers"]


def test_upload_then_img2img_matches_the_pipeline(server, pipe):
    """An RGBA PNG staged by /v1/upload is read as PIL's convert("RGB")
    reads it (the JAX backend's _load_image), and the job's images are the
    pipeline's own on that image."""
    rng = np.random.RandomState(3)
    rgba = rng.randint(0, 256, (64, 64, 4)).astype(np.uint8)
    path = _call(server + "/v1/upload", {"image": _png_b64(rgba, "RGBA")})["path"]
    staged = np.asarray(Image.open(path))
    np.testing.assert_array_equal(staged, rgba[..., :3])
    params = {"prompt": "a cat", "H": 64, "W": 64, "sampling_steps": 2,
              "sampler": "DPM++ 2M", "strength": 0.5, "seed": 3,
              "n_samples": 1, "safety_check": False, "init_img": path}
    _call(server + "/v1/generate", {"generator_model_type": "SD 1.5",
                                    "mode": "image_to_image",
                                    "parameters": params})
    msgs = _drain(server, 1)
    assert msgs[-1] == {"job_done": {"ok": True, "error": None}}
    served = [decode_png(base64.b64decode(m["image_b64"]))[0] for m in msgs
              if isinstance(m, dict) and "image_b64" in m]
    init = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255 * 2 - 1
    direct = pipe.generate(GenerationOptions(mode="image_to_image", **params),
                           init_image=init)
    assert len(served) == len(direct) == 1
    np.testing.assert_array_equal(served[0], image_to_uint8(direct[0][0]))


def test_upload_rejects_what_it_cannot_read(server):
    for payload in ({"image": base64.b64encode(b"GIF89a...").decode()},
                    {"image": "%%%"}, {"img": "x"}):
        with pytest.raises(urllib.error.HTTPError) as e:
            _call(server + "/v1/upload", payload)
        assert e.value.code == 400


def test_upload_refuses_a_decompression_bomb(server):
    """A PNG whose header claims 60000^2 RGBA pixels (a few KB of zeros
    that would inflate to 14 GB) is refused from its header, before its
    data is inflated."""
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    z = zlib.compressobj()
    idat = z.compress(bytes(1 << 24)) + z.flush()
    bomb = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 60000, 60000, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))
    with pytest.raises(urllib.error.HTTPError) as e:
        _call(server + "/v1/upload", {"image": base64.b64encode(bomb).decode()})
    assert e.value.code == 400
    assert "exceeds 4096" in json.loads(e.value.read())["error"]


def test_inpainting_without_the_inpaint_bundle_fails_clearly(server):
    _call(server + "/v1/generate", {
        "generator_model_type": "SD 1.5", "mode": "inpainting",
        "prompt": "x", "H": 64, "W": 64, "sampler": "DDIM",
        "safety_check": False})
    done = _drain(server, 1)[-1]["job_done"]
    assert not done["ok"] and "--inpaint" in done["error"]


@pytest.mark.parametrize("key,mode", [("init_img", "RGB"), ("mask_img", "L")])
def test_load_image_reads_as_the_jax_backend(tmp_path, key, mode):
    from cremage_tpu.app.backends import _load_image as j_load_image

    rng = np.random.RandomState(4)
    path = str(tmp_path / "in.png")
    Image.fromarray(rng.randint(0, 256, (16, 24, 3)).astype(np.uint8)).save(path)
    got = load_image({key: path}, key)
    want = j_load_image({key: path}, key)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert load_image({key: str(tmp_path / "missing.png")}, key) is None


def test_default_options_are_served(server):
    """The JAX package's default job (safety_check on, no classifier weights
    configured) is served, and each image's metadata carries its flag."""
    _call(server + "/v1/generate", {"generator_model_type": "SD 1.5",
                                    "prompt": "a cat", "H": 64, "W": 64,
                                    "sampling_steps": 1, "sampler": "Euler"})
    msgs = _drain(server, 1)
    assert msgs[-1] == {"job_done": {"ok": True, "error": None}}
    metas = [json.loads(m["generation_parameters"]) for m in msgs
             if isinstance(m, dict) and "image_b64" in m]
    assert len(metas) == 1 and metas[0]["safety_check"] is True
    assert metas[0]["nsfw"] is False


def test_deny_term_blocks_as_the_jax_worker():
    from cremage_tpu.app.worker import EngineWorker as JWorker
    from cremage_tpu.services.safety import TextSafetyChecker as JGate
    from cremage_tpu_torch.services.safety import TextSafetyChecker

    for params, blocked in (({"prompt": "a Bad cat"}, True),
                            ({"prompt": "a bad cat", "safety_check": False}, False),
                            ({"prompt": "a good cat"}, False)):
        job = {"type": "inference", "generator_model_type": "SD 1.5",
               "parameters": params}
        ours = EngineWorker(text_safety=TextSafetyChecker(deny_terms=["bad"]))
        theirs = JWorker(text_safety=JGate(deny_terms=["bad"]))
        ours.submit(dict(job))
        theirs.submit(dict(job))
        assert ours.job_queue.qsize() == theirs.job_queue.qsize() == int(not blocked)
        got = [ours.status_queue.get_nowait() for _ in range(ours.status_queue.qsize())]
        want = [theirs.status_queue.get_nowait()
                for _ in range(theirs.status_queue.qsize())]
        assert got == want and len(got) == int(blocked)


def test_control_image_reaches_the_pipeline_in_0_1(tmp_path):
    """control_image_path is read in [0, 1], the range the pipeline's hint
    takes; the JAX backend reads it in [-1, 1] (a fault of the reference,
    not copied)."""
    from cremage_tpu.app.backends import _load_image as j_load_image

    rgb = np.random.RandomState(5).randint(0, 256, (16, 24, 3)).astype(np.uint8)
    path = str(tmp_path / "hint.png")
    Image.fromarray(rgb).save(path)
    params = {"control_image_path": path, "prompt": "x", "safety_check": False}
    seen = {}

    class Pipe:
        def generate(self, opts, **kw):
            seen.update(kw)
            return []

    worker = EngineWorker()
    register_sd15(worker, Pipe())
    worker._run_one({"type": "inference", "generator_model_type": "SD 1.5",
                     "parameters": params})
    assert worker.status_queue.get_nowait() == {"job_done": {"ok": True,
                                                             "error": None}}
    np.testing.assert_array_equal(seen["control_image"], rgb / np.float32(255))
    assert seen["control_image"].min() >= 0
    np.testing.assert_allclose(seen["control_image"] * 2 - 1,
                               j_load_image(params, "control_image_path"),
                               atol=1e-6)


def test_checkpoint_backend_needs_a_configured_model():
    """With no model configured the job fails with FileNotFoundError (as
    in the JAX backend), never falling back to random weights; one
    resident pipeline is reused for the same files and replaced for
    others."""
    from cremage_tpu_torch.app.backends import ResidentInstance, sd15_factory
    from cremage_tpu_torch.app.server import build_server
    from cremage_tpu_torch.core.config import Preferences

    worker = EngineWorker()
    worker.register_backend("SD 1.5", sd15_factory(Preferences(ldm_model="None")))
    worker._run_one({"type": "inference", "generator_model_type": "SD 1.5",
                     "parameters": {"prompt": "x"}})
    done = worker.status_queue.get_nowait()["job_done"]
    assert not done["ok"] and "FileNotFoundError" in done["error"]
    built = []
    res = ResidentInstance()
    a = res.get(("a",), lambda: built.append("a") or "A")
    assert res.get(("a",), lambda: built.append("x") or "X") == a == "A"
    assert res.get(("b",), lambda: built.append("b") or "B") == "B"
    assert built == ["a", "b"]
    for argv in ([], ["--config", "c.yaml", "--random-weights"],
                 ["--config", "c.yaml", "--inpaint"]):
        with pytest.raises(SystemExit):
            build_server(argv)
    with pytest.raises(FileNotFoundError):
        build_server(["--config", "/nonexistent/config.yaml"])
