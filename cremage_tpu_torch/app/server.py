"""HTTP API server (the port of the generation routes of
cremage_tpu/app/server.py), a stdlib ThreadingHTTPServer over the
EngineWorker with the same JSON contract:

  POST /v1/generate   job dict (reference mp protocol), returns job id
  GET  /v1/status     drain pending status/result messages
  GET  /v1/health     liveness + devices + kernel launch counts
  GET  /v1/meta       the model types, modes and samplers served
  POST /v1/upload     {"image": b64 PNG} -> {"path": staged file}, the path
                      a job's init_img / mask_img names
  GET  /v1/images/file?path=P   the bytes of the file P under the app root
                      (image/png, or video/mp4 for .mp4): what a job with
                      result_delivery "path" wrote (its result message
                      names P as image_path)
  GET  /v1/images/meta?path=P   {"generation_data": the PNG's parameters}
Both file routes serve only files inside the app root (~/.cremage_tpu,
app/dirs.py; realpath checked): any other path is 404.

Run `python -m cremage_tpu_torch.app.server --config config.yaml --port N`
to serve SD1.5, SDXL, FLUX.1-schnell, SVD, SD3, PixArt-Σ and Hunyuan-DiT on
the GPU from the checkpoint files that the config (the JAX package's
config.yaml: ldm_model_path / ldm_model, ldm_inpaint_model, embedding_path;
sdxl_ldm_model_path / sdxl_ldm_model, sdxl_ldm_inpaint_model,
sdxl_embedding_path) and each job (ckpt, vae_ckpt, refiner_ckpt,
lora_models, control_net; FLUX's clip_ckpt, t5_ckpt; SVD's ckpt or
svd_model under svd_model_path; Hunyuan-DiT's component files or
hunyuan_dir) name (app/backends.py); one model of any family stays
resident. $SAFETY_CHECKER_PATH names the image safety checker's weights.
`--deny-term` adds a term to the prompt gate's deny list. For smoke runs
only, `--random-weights --seed N [--inpaint]` serves SD1.5 bundles of
seeded random weights instead.
"""
from __future__ import annotations

import base64
import binascii
import json
import logging
import os
import queue
import threading
import uuid
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, NamedTuple, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from cremage_tpu_torch.app import dirs
from cremage_tpu_torch.app.worker import EngineWorker, MP_MESSAGE_TYPE_INFERENCE
from cremage_tpu_torch.core.config import (
    GENERATOR_MODEL_TYPES, GMT_FLUX_1_SCHNELL, GMT_HUNYUAN_DIT,
    GMT_KANDINSKY_2_2, GMT_PIXART_SIGMA, GMT_SD_1_5, GMT_SD_3, GMT_SDXL, GMT_SVD,
    GenerationOptions, MODE_INPAINTING,
)
from cremage_tpu_torch.io.metadata import read_generation_data
from cremage_tpu_torch.io.png import decode_png, encode_png, read_png

logger = logging.getLogger(__name__)


class BadRequest(ValueError):
    """Maps to HTTP 400 (vs 500 for internal failures)."""


# request validation bounds (a headless API enforces them server-side)
MAX_EDGE = 4096
MAX_STEPS = 1000
MAX_BATCH = 64
MAX_B64_BYTES = 64 * 1024 * 1024

# job-dict envelope keys (reference mp protocol); everything else is a
# generation parameter and belongs under job["parameters"]
_JOB_ENVELOPE_KEYS = ("type", "generator_model_type", "mode", "parameters")


def _normalize_generate(body: dict) -> dict:
    """Accept both the reference job shape and a flat dict with generation
    fields at the top level (folded into "parameters"); mode and
    generator_model_type are mirrored into the parameters, and JSON nulls
    are dropped so they never override GenerationOptions defaults."""
    job = {k: body[k] for k in _JOB_ENVELOPE_KEYS if k in body}
    extra = {k: v for k, v in body.items() if k not in _JOB_ENVELOPE_KEYS}
    params = dict(job.get("parameters") or {})
    for k, v in extra.items():
        params.setdefault(k, v)
    for k in ("mode", "generator_model_type"):
        if k in job:
            params.setdefault(k, job[k])
    job["parameters"] = {k: v for k, v in params.items() if v is not None}
    return job


def _validate_generate(job) -> Optional[str]:
    """Validates the NORMALIZED job (what the worker will consume)."""
    gmt = job.get("generator_model_type")
    if gmt is not None and gmt not in GENERATOR_MODEL_TYPES:
        return (f"unknown generator_model_type {gmt!r}; "
                f"one of {GENERATOR_MODEL_TYPES}")
    p = job["parameters"]
    for dim in ("H", "W"):
        v = p.get(dim)
        if v is None:
            continue
        if not isinstance(v, int) or not (8 <= v <= MAX_EDGE) or v % 8:
            return f"{dim} must be a multiple of 8 in [8, {MAX_EDGE}]"
    steps = p.get("sampling_steps")
    if steps is not None and (not isinstance(steps, int)
                              or not 1 <= steps <= MAX_STEPS):
        return f"sampling_steps must be an int in [1, {MAX_STEPS}]"
    for k in ("n_samples", "n_iter"):
        v = p.get(k)
        if v is not None and (not isinstance(v, int)
                              or not 1 <= v <= MAX_BATCH):
            return f"{k} must be an int in [1, {MAX_BATCH}]"
    return None


def _stage_upload(data: str, directory: str) -> str:
    """Decode a b64 PNG, convert it to RGB and save it under `directory`
    as the JAX server's /v1/upload does; returns the file's path."""
    if not isinstance(data, str):
        raise BadRequest("image must be a b64 string")
    if len(data) > MAX_B64_BYTES:
        raise BadRequest(f"image payload exceeds {MAX_B64_BYTES} bytes")
    try:
        rgb, _ = decode_png(base64.b64decode(data), "RGB", MAX_EDGE)
    except (ValueError, binascii.Error, zlib.error) as e:
        raise BadRequest(f"undecodable image payload (the port reads "
                         f"8-bit PNGs): {e}") from e
    path = os.path.join(directory, f"upload_{uuid.uuid4().hex[:12]}.png")
    with open(path, "wb") as f:
        f.write(encode_png(rgb))
    return path


class RawReply(NamedTuple):
    """A reply that is a file's bytes, not JSON."""
    data: bytes
    content_type: str


def library_file(query: str) -> Optional[str]:
    """The real path of the query's `path` where it names a file inside the
    app root, else None (the JAX server's check)."""
    p = (parse_qs(query).get("path") or [""])[0]
    root = os.path.realpath(dirs.first_init())
    rp = os.path.realpath(p)
    if not rp.startswith(root + os.sep) or not os.path.isfile(rp):
        return None
    return rp


class ApiServer:
    def __init__(self, worker: Optional[EngineWorker] = None,
                 host: str = "127.0.0.1", port: int = 8787,
                 upload_dir: Optional[str] = None):
        self.worker = worker or EngineWorker()
        if self.worker.save_root is None:
            # path delivery: a job that asks for it has its PNGs written
            # under the app root's outputs, as the JAX server sets it up
            self.worker.save_root = dirs.first_init()
        self.host = host
        self.port = port
        self.upload_dir = upload_dir
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._job_counter = 0
        self._counter_lock = threading.Lock()

    def handle(self, method: str, path: str, body: Dict[str, Any]):
        url = urlparse(path)
        if method == "GET" and url.path in ("/v1/images/file",
                                            "/v1/images/meta"):
            rp = library_file(url.query)
            if rp is None:
                return None
            if url.path == "/v1/images/meta":
                return {"generation_data": read_generation_data(rp)}
            with open(rp, "rb") as f:
                return RawReply(f.read(), "video/mp4" if rp.lower().endswith(
                    ".mp4") else "image/png")
        if path == "/v1/meta":
            from cremage_tpu_torch.pipelines.sd15 import (
                EXTRA_SAMPLERS, MODES, SAMPLER_MENU,
            )
            from cremage_tpu_torch.samplers.edm import SGM_SAMPLER_NAMES

            # SDXL and SVD run the sgm menu, SD1.5 the k-diffusion/DDIM
            # names, as the JAX server lists them; both run the extra
            # samplers. FLUX and SD3 (flow Euler) take the k-diffusion
            # names and ignore them, PixArt, Hunyuan-DiT and Kandinsky's
            # decoder run them, as in the JAX server
            return {"model_types": [GMT_SD_1_5, GMT_SDXL, GMT_SD_3,
                                    GMT_PIXART_SIGMA, GMT_KANDINSKY_2_2,
                                    GMT_HUNYUAN_DIT, GMT_FLUX_1_SCHNELL,
                                    GMT_SVD],
                    "modes": list(MODES), "samplers": list(SAMPLER_MENU),
                    "extra_samplers": list(EXTRA_SAMPLERS),
                    "samplers_by_type": {GMT_SD_1_5: list(SAMPLER_MENU),
                                         GMT_SDXL: list(SGM_SAMPLER_NAMES),
                                         GMT_FLUX_1_SCHNELL: list(SAMPLER_MENU),
                                         GMT_SVD: list(SGM_SAMPLER_NAMES),
                                         GMT_SD_3: list(SAMPLER_MENU),
                                         GMT_PIXART_SIGMA: list(SAMPLER_MENU),
                                         GMT_KANDINSKY_2_2: list(SAMPLER_MENU),
                                         GMT_HUNYUAN_DIT: list(SAMPLER_MENU)}}
        if path == "/v1/upload" and method == "POST":
            if not isinstance(body, dict) or "image" not in body:
                raise BadRequest("body must be {\"image\": <b64 PNG>}")
            if self.upload_dir is None:
                self.upload_dir = dirs.upload_dir()
            os.makedirs(self.upload_dir, exist_ok=True)
            return {"path": _stage_upload(body["image"], self.upload_dir)}
        if path == "/v1/health":
            import torch

            from cremage_tpu_torch.ops.flash_attention import flash_attention
            from cremage_tpu_torch.ops.groupnorm import group_norm_silu

            devices = [torch.cuda.get_device_name(i)
                       for i in range(torch.cuda.device_count())] or ["cpu"]
            return {
                "ok": True,
                "devices": devices,
                "metrics": {
                    "flash_attention_launches": flash_attention.launches,
                    "group_norm_silu_launches": group_norm_silu.launches,
                },
            }
        if path == "/v1/generate" and method == "POST":
            if not isinstance(body, dict):
                raise BadRequest("body must be a JSON object")
            if "parameters" in body and not isinstance(
                    body["parameters"], dict):
                raise BadRequest("parameters must be a JSON object")
            job = _normalize_generate(body)
            err = _validate_generate(job)
            if err:
                raise BadRequest(err)
            with self._counter_lock:
                self._job_counter += 1
                job_id = self._job_counter
            job.setdefault("type", MP_MESSAGE_TYPE_INFERENCE)
            self.worker.submit(job)
            return {"job_id": job_id}
        if path == "/v1/status":
            msgs = []
            while True:
                try:
                    m = self.worker.status_queue.get_nowait()
                except queue.Empty:
                    break
                if isinstance(m, dict) and "image" in m:
                    m = {
                        "image_b64": base64.b64encode(m["image"]).decode(),
                        "generation_parameters": m["generation_parameters"],
                    }
                msgs.append(m)
            return {"messages": msgs}
        return None

    def _make_handler(server):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug(fmt, *args)

            def _reply(self, code, payload):
                if isinstance(payload, RawReply):
                    data, ctype = payload
                else:
                    data, ctype = json.dumps(payload).encode(), "application/json"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _dispatch(self, method):
                length = int(self.headers.get("Content-Length") or 0)
                body = {}
                if length:
                    try:
                        body = json.loads(self.rfile.read(length))
                    except json.JSONDecodeError:
                        return self._reply(400, {"error": "bad json"})
                try:
                    out = server.handle(method, self.path, body)
                except BadRequest as e:
                    return self._reply(400, {"error": str(e)})
                except Exception as e:  # structured errors
                    logger.exception("request failed")
                    return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                if out is None:
                    return self._reply(404, {"error": "not found"})
                return self._reply(200, out)

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

        return Handler

    def start(self, block: bool = False):
        self.worker.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._make_handler())
        self.port = self._httpd.server_address[1]
        logger.info("api server on %s:%d", self.host, self.port)
        if block:
            self._httpd.serve_forever()
        else:
            threading.Thread(target=self._httpd.serve_forever,
                             daemon=True).start()

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.worker.stop()


def load_image(params: dict, key: str) -> Optional[np.ndarray]:
    """The job's `key` image file: mask_img as (H, W) grey in [0, 1],
    control_image_path as (H, W, 3) RGB in [0, 1] (the range the pipeline's
    ControlNet hint takes; the JAX backend passes [-1, 1] there), any other
    as (H, W, 3) RGB in [-1, 1], as the JAX backend reads them; None when
    the parameter is unset or names no file."""
    p = params.get(key)
    if not p or not os.path.exists(p):
        return None
    if key == "mask_img":
        return read_png(p, "L", MAX_EDGE).astype(np.float32) / 255.0
    rgb01 = read_png(p, "RGB", MAX_EDGE).astype(np.float32) / 255.0
    if key == "control_image_path":
        return rgb01
    return rgb01 * 2.0 - 1.0


def register_sd15(worker: EngineWorker, pipe, inpaint_pipe=None) -> None:
    """Serve `pipe` (an SD15Pipeline) as the "SD 1.5" backend, and send
    mode "inpainting" to `inpaint_pipe` (one on the 9-channel UNet)."""
    def factory():
        def generate(params, status_cb, result_cb):
            opts = GenerationOptions.from_dict(params)
            target = pipe
            if opts.mode == MODE_INPAINTING:
                if inpaint_pipe is None:
                    raise ValueError("inpainting needs the 9-channel inpaint "
                                     "bundle, which this server was not "
                                     "started with (--inpaint)")
                target = inpaint_pipe
            target.generate(opts, status_cb=status_cb, result_cb=result_cb,
                            init_image=load_image(params, "init_img"),
                            mask_image=load_image(params, "mask_img"),
                            control_image=load_image(params,
                                                     "control_image_path"))
        return generate

    worker.register_backend(GMT_SD_1_5, factory)


def build_server(argv=None) -> ApiServer:
    """The server `main` runs, from its command line: `--config` registers
    the checkpoint-file backend (app/backends.py); `--random-weights`
    serves seeded random bundles. One of the two is required: a server
    never falls back from missing files to random weights."""
    import argparse

    from cremage_tpu_torch.services.safety import TextSafetyChecker

    p = argparse.ArgumentParser("cremage-tpu-torch-server")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--config", default=None,
                   help="config.yaml (the JAX package's preferences file) "
                        "naming the checkpoint files")
    p.add_argument("--deny-term", action="append", default=[],
                   help="prompt deny-list term (repeatable)")
    p.add_argument("--random-weights", action="store_true",
                   help="smoke runs only: serve bundles of random weights")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of --random-weights' bundles")
    p.add_argument("--inpaint", action="store_true",
                   help="with --random-weights, also build the 9-channel "
                        "inpainting bundle")
    args = p.parse_args(argv)
    if bool(args.config) == bool(args.random_weights):
        p.error("give exactly one of --config and --random-weights")
    if args.inpaint and not args.random_weights:
        p.error("--inpaint goes with --random-weights (with --config, mode "
                "'inpainting' loads ldm_inpaint_model)")
    worker = EngineWorker(text_safety=TextSafetyChecker(
        deny_terms=args.deny_term) if args.deny_term else None)
    if args.config:
        from cremage_tpu_torch.app.backends import (
            ResidentInstance, flux_factory, hunyuan_factory, kandinsky_factory,
            pixart_factory, sd3_factory, sd15_factory, sdxl_factory,
            svd_factory,
        )
        from cremage_tpu_torch.core.config import load_preferences

        prefs, resident = load_preferences(args.config), ResidentInstance()
        worker.register_backend(GMT_SD_1_5, sd15_factory(prefs,
                                                         resident=resident))
        worker.register_backend(GMT_SDXL, sdxl_factory(prefs,
                                                       resident=resident))
        worker.register_backend(GMT_FLUX_1_SCHNELL, flux_factory(
            prefs, resident=resident))
        worker.register_backend(GMT_SVD, svd_factory(prefs,
                                                     resident=resident))
        worker.register_backend(GMT_SD_3, sd3_factory(prefs,
                                                      resident=resident))
        worker.register_backend(GMT_PIXART_SIGMA, pixart_factory(
            prefs, resident=resident))
        worker.register_backend(GMT_HUNYUAN_DIT, hunyuan_factory(
            prefs, resident=resident))
        worker.register_backend(GMT_KANDINSKY_2_2, kandinsky_factory(
            prefs, resident=resident))
    else:
        from cremage_tpu_torch.pipelines.sd15 import SD15Pipeline, build_sd15_bundle

        inpaint = (SD15Pipeline(build_sd15_bundle(seed=args.seed, inpaint=True))
                   if args.inpaint else None)
        register_sd15(worker, SD15Pipeline(build_sd15_bundle(seed=args.seed)),
                      inpaint)
    return ApiServer(worker=worker, host=args.host, port=args.port)


def main(argv=None):  # pragma: no cover
    logging.basicConfig(level=logging.INFO)
    build_server(argv).start(block=True)


if __name__ == "__main__":  # pragma: no cover
    main()
