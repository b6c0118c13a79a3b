"""Job queue + engine worker (the port of cremage_tpu/app/worker.py).

Same message protocol as the JAX package:
- jobs are dicts {"type": "inference", "generator_model_type": <GMT_*>,
  "mode": ..., "parameters": {...}};
- the status channel carries str progress messages,
  {"image": png_bytes, "generation_parameters": json_str} results, and one
  terminal {"job_done": {"ok": bool, "error": str|None}} per job;
- a job whose parameters ask for `result_delivery: "path"` on a worker
  with a `save_root` (the server sets the app root, app/dirs.py
  `first_init`) has each PNG written under `save_root`/outputs instead,
  and its result message is {"image_path": path, "generation_parameters":
  json_str}; any other delivery is inline.

One worker thread drains the queue into the registered backends; PNG
encoding (and the file's write) runs on a one-thread pool so the device
starts the next batch while the previous one compresses, and results post
in generation order. With a `text_safety` checker (services/safety.py), an
inference job whose prompt it blocks never reaches the queue: its only
message is a failed job_done, as in the JAX worker. Request coalescing is
not ported yet.
"""
from __future__ import annotations

import json
import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

from cremage_tpu_torch.app import dirs
from cremage_tpu_torch.io.png import GENERATION_DATA_KEY, encode_png, image_to_uint8

logger = logging.getLogger(__name__)

MP_MESSAGE_TYPE_EXIT = "exit"
MP_MESSAGE_TYPE_INFERENCE = "inference"


class EngineWorker:
    """Single worker thread draining a job queue into pipeline backends.

    `register_backend(model_type, factory)`: factory() -> callable
    generate(parameters: dict, status_cb, result_cb), run lazily on first
    use (model load happens in the worker thread)."""

    def __init__(self, text_safety=None):
        self.text_safety = text_safety
        self.save_root: Optional[str] = None     # path delivery's app root
        self.job_queue: "queue.Queue[dict]" = queue.Queue()
        self.status_queue: "queue.Queue[Any]" = queue.Queue()
        self._factories: Dict[str, Callable[[], Callable]] = {}
        self._backends: Dict[str, Callable] = {}
        self._thread: Optional[threading.Thread] = None
        self._encode_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="cremage-encode")

    def register_backend(self, model_type: str,
                         factory: Callable[[], Callable]) -> None:
        self._factories[model_type] = factory

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cremage-torch-worker")
        self._thread.start()

    def stop(self, join: bool = True) -> None:
        self.job_queue.put({"type": MP_MESSAGE_TYPE_EXIT})
        if join and self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        self._encode_pool.shutdown(wait=join)

    def submit(self, job: dict) -> None:
        if (self.text_safety is not None
                and job.get("type") == MP_MESSAGE_TYPE_INFERENCE):
            params = job.get("parameters", {})
            prompt = params.get("prompt", params.get("positive_prompt", ""))
            if params.get("safety_check", True) and prompt \
                    and self.text_safety.should_block(prompt):
                self.status_queue.put({"job_done": {
                    "ok": False,
                    "error": "Safety check detected potentially sensitive "
                             "word(s) in prompt. To disable safety check, "
                             "set safety_check=false.",
                }})
                return
        self.job_queue.put(job)

    def _backend_for(self, model_type: str) -> Callable:
        if model_type not in self._backends:
            if model_type not in self._factories:
                raise KeyError(f"no backend registered for {model_type!r}")
            self._backends[model_type] = self._factories[model_type]()
        return self._backends[model_type]

    def _result_cb(self, params: dict, pending: list) -> Callable:
        to_path = (params.get("result_delivery", "inline") == "path"
                   and self.save_root is not None)

        def encode_and_post(img, meta):
            msg = make_result_message(img, meta)
            if to_path:
                msg = {"image_path": dirs.save_output_image(self.save_root,
                                                            msg["image"]),
                       "generation_parameters": msg["generation_parameters"]}
            self.status_queue.put(msg)

        def cb(img, meta):
            pending.append(self._encode_pool.submit(encode_and_post, img, meta))
        return cb

    def _run_one(self, job: dict) -> None:
        ok, err = True, None
        pending: list = []
        try:
            params = job.get("parameters", {})
            backend = self._backend_for(job["generator_model_type"])
            backend(params, self.status_queue.put,
                    self._result_cb(params, pending))
            for f in pending:     # job_done must follow all images
                f.result()
        except Exception as e:  # structured failure, keep the worker alive
            logger.exception("job failed")
            ok, err = False, f"{type(e).__name__}: {e}"
        self.status_queue.put({"job_done": {"ok": ok, "error": err}})

    def _loop(self) -> None:
        while True:
            job = self.job_queue.get()
            if job.get("type") == MP_MESSAGE_TYPE_EXIT:
                break
            if job.get("type") != MP_MESSAGE_TYPE_INFERENCE:
                logger.warning("unknown job type %r", job.get("type"))
                continue
            self._run_one(job)


def make_result_message(img, meta: Dict[str, Any]) -> Dict[str, Any]:
    """PNG bytes + generation_parameters JSON, with the same JSON embedded
    in the PNG's `generation_data` text chunk."""
    meta_json = json.dumps(meta)
    png = encode_png(image_to_uint8(img), {GENERATION_DATA_KEY: meta_json})
    return {"image": png, "generation_parameters": meta_json}
