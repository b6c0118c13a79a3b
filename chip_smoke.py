#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cremage_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises, so the exit code
is nonzero and no final line is printed:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: both CUDA kernels compiled from csrc/ with nvcc for sm_90a,
   with each kernel's registers and spill bytes from `-Xptxas -v`;
3. shapes: one full-width SD1.5 UNet eval (the CFG batch of 8 at 64x64
   latents) and one VAE decode (batch 4, 512^2) record every attention
   and GroupNorm call shape of the main path and its calls per request;
4. K1 flash attention and 5. K2 GroupNorm(+SiLU): each kernel against its
   plain PyTorch version at every recorded shape, with its device time
   (launches queued behind a GPU-side sleep, `time_device`), its
   host-inclusive dispatch time, the plain version's device time, one
   PyTorch library call's (a yardstick the port never calls) and the
   least time the card could take (the bound); each K2 row also names
   its plan (route, cluster size, bytes per CTA) and how many of its
   clusters the card holds at once (cudaOccupancyMaxActiveClusters);
6. unet: one full-width UNet eval in bf16 on the card against the same
   weights in fp32 on the CPU through the plain versions;
7. serving: the port's HTTP server with a full-width SD1.5 bundle of
   seeded random bf16 weights answers 2 txt2img requests (512^2, Euler A,
   20 steps, CFG 7.5, batch 4); the kernels' launch counts of that run
   must equal the counts derived from the model code;
8. the kernels line, then the contract's last line.
Each phase has a time limit (LIMITS_S): a hung kernel ends the run in its
phase with exit code 1.
Needs the repository (it imports cremage_tpu_torch), one card, and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import base64
import dataclasses
import faulthandler
import json
import re
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

STEPS, BATCH, REQUESTS, RES = 20, 4, 2, 512
# each phase's time limit, in s (all run in well under a minute here). A
# hang, say a kernel waiting on a wrong barrier phase, ends the run in its
# phase with a traceback and exit code 1 instead of using up the call. The
# K1 limit starts with the shapes phase: its model evals are K1's first
# launches.
LIMITS_S = dict(build=300, shapes_and_k1=180, k2=120, unet=180, serving=300)
PROMPT = "a photograph of an astronaut riding a horse"
NEGATIVE = "blurry, low quality"


def watchdog(phase: str) -> None:
    faulthandler.dump_traceback_later(LIMITS_S[phase], exit=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Host-inclusive ms per call: events around launches enqueued while
    the card is idle, so at short kernels they time the host's dispatch."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SLEEP_CYCLES_PER_S = 2.0e9   # at least the H100's SM clock (1.98 GHz boost)


def time_device(fn, reps: int, warmup: int = 3):
    """(device ms, dispatch ms) per call. The timed launches are enqueued
    behind a GPU-side sleep (`torch.cuda._sleep`) that outlasts their
    dispatch, so the events bracket the kernels back to back and not the
    host; the start event still pending after the enqueue shows that the
    sleep covered it (else the sleep doubles and it is timed again).
    Dispatch ms is `time_ms`'s host-inclusive time."""
    import torch

    dispatch = time_ms(fn, reps, warmup)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host_s = dispatch * reps / 1e3
    for _ in range(8):
        t0 = time.perf_counter()
        torch.cuda._sleep(int(2 * host_s * SLEEP_CYCLES_PER_S) + 1_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        covered = not start.query()
        enqueue_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / reps, dispatch
        host_s = 2 * max(host_s, enqueue_s)
    raise RuntimeError("time_device: the GPU sleep never outlasted the enqueue")


def kernel_name(mangled: str) -> str:
    """A readable name for a kernel's mangled name in ptxas output."""
    plan = mangled.partition("PlanI")[2]
    if plan:
        return f"flash_fwd_wgmma<{','.join(re.findall(r'Li(\d+)E', plan))}>"
    # _ZN <len> _GLOBAL__N_<file tag> <len> <name> [IL<type><value>E E]: a
    # kernel in an anonymous namespace
    m = re.match(r"_ZN(\d+)_GLOBAL__N_", mangled)
    if m:
        rest = mangled[m.end(1) + int(m.group(1)):]
        n = re.match(r"\d+", rest)
        end = n.end() + int(n.group())
        targ = re.match(r"IL[a-z](\d+)E", rest[end:])
        return rest[n.end():end] + (f"<{targ.group(1)}>" if targ else "")
    return re.sub(r"^_Z\d+", "", mangled)[:40]


def ptxas_summary(log: str) -> dict:
    """{kernel: [registers, spill store bytes]} from `nvcc -Xptxas -v`."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = [None, None]
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return out


def record_shapes(bundle, dev):
    """Run one UNet eval at the CFG batch and one VAE decode, recording the
    (shape -> calls) of every K1 and K2 call per request."""
    import torch

    from cremage_tpu_torch.models.layers import GroupNorm
    from cremage_tpu_torch.models.unet import CrossAttention
    from cremage_tpu_torch.models.vae import AttnBlock

    attn, gn = {}, {}
    weight = {"n": 0}

    def add(table, key):
        table[key] = table.get(key, 0) + weight["n"]

    def on_cross(mod, args):
        x, ctx = args[0], (args[1] if len(args) > 1 else None)
        nk = x.shape[1] if ctx is None else ctx.shape[1]
        add(attn, (x.shape[0], x.shape[1], nk, mod.heads, mod.dim_head))

    def on_vae_attn(mod, args):
        b, c, h, w = args[0].shape
        add(attn, (b, h * w, h * w, 1, c))

    def on_gn(mod, args):
        add(gn, tuple(args[0].shape) + (mod.eps, mod.fuse_silu))

    hooks = []
    for m in list(bundle.unet.modules()) + list(bundle.vae.modules()):
        if isinstance(m, CrossAttention):
            hooks.append(m.register_forward_pre_hook(on_cross))
        elif isinstance(m, AttnBlock):
            hooks.append(m.register_forward_pre_hook(on_vae_attn))
        elif isinstance(m, GroupNorm):
            hooks.append(m.register_forward_pre_hook(on_gn))
    g = torch.Generator(device=dev).manual_seed(1)
    lat = RES // 8
    with torch.no_grad():
        weight["n"] = STEPS
        bundle.unet(torch.randn(2 * BATCH, 4, lat, lat, device=dev, generator=g),
                    torch.full((2 * BATCH,), 500.0, device=dev),
                    torch.randn(2 * BATCH, 77, 768, device=dev, generator=g))
        weight["n"] = 1
        bundle.vae.decode(torch.randn(BATCH, 4, lat, lat, device=dev, generator=g))
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return attn, gn


def check_flash(attn, dev):
    import torch
    import torch.nn.functional as F

    from cremage_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, plan_flash,
    )

    g = torch.Generator(device=dev).manual_seed(2)
    rows = []
    for (b, nq, nk, h, d), calls in sorted(attn.items()):
        q = torch.randn(b, nq, h, d, device=dev, generator=g).bfloat16()
        k = torch.randn(b, nk, h, d, device=dev, generator=g).bfloat16()
        v = torch.randn(b, nk, h, d, device=dev, generator=g).bfloat16()
        out = flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v)
        err = float((out.float() - ref.float()).abs().max())
        # both round P to bf16 before PV (unnormalized in the kernel,
        # normalized in the plain version) and round the output once to
        # bf16, so they differ by a few bf16 ulps of the output: 2^-6 of
        # the largest output is 2 to 4 ulps of it. The tolerance follows
        # |out|, which shrinks as Nk grows, so a dropped 64-key tile or a
        # wrong rescale at Nk = 4096 still exceeds it
        tol = 2.0 ** -6 * float(ref.float().abs().max())
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        plan = plan_flash(d, nq, nk)
        flops = 4.0 * b * h * nq * nk * d
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        ms, dispatch_ms = time_device(lambda: flash_attention(q, k, v), 20)
        row = dict(
            phase="flash_attention", shape=[b, nq, nk, h, d],
            instantiation=plan.instantiation,
            calls_per_request=calls, max_abs_err=err, tol=tol,
            ms=ms, dispatch_ms=dispatch_ms,
            plain_ms=time_device(
                lambda: flash_attention_reference(q, k, v), 3, 1)[0],
            library_ms=time_device(
                lambda: F.scaled_dot_product_attention(qt, kt, vt), 20)[0],
            # what the kernel computes: d padded to plan.dp, every q row and
            # key of its tiles (the tails are computed and dropped), Q K^T
            # once per warpgroup that shares the q rows, P V once
            padded_flops=2.0 * b * h * plan.q_blocks * plan.bq
            * -(-nk // plan.bk) * plan.bk * plan.dp * (plan.split + 1),
            flops_ms=flops / PEAK_BF16_FLOPS * 1e3,
            bytes_ms=nbytes / PEAK_BYTES * 1e3)
        row["bound_ms"] = max(row["flops_ms"], row["bytes_ms"])
        emit(row)
        if not err <= tol:
            raise AssertionError(f"flash_attention {row['shape']}: max abs "
                                 f"error {err} > {tol}")
        rows.append(row)
        del q, k, v, out, ref, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def check_groupnorm(gn, dev):
    import torch
    import torch.nn.functional as F

    from cremage_tpu_torch.ops.groupnorm import (
        active_clusters, group_norm_silu, group_norm_silu_reference,
        plan_groupnorm,
    )

    g = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for (n, c, h, w, eps, silu), calls in sorted(gn.items()):
        x = (torch.randn(n, c, h, w, device=dev, generator=g) * 2 + 1).bfloat16()
        wt = torch.randn(c, device=dev, generator=g)
        bt = torch.randn(c, device=dev, generator=g)
        out = group_norm_silu(x, wt, bt, 32, eps, silu)
        torch.cuda.synchronize()
        ref = group_norm_silu_reference(x, wt, bt, 32, eps, silu)
        err = float((out.float() - ref.float()).abs().max())
        # both round an fp32 epilogue once; the statistics' summation order
        # and the kernel's sigmoid (tanh.approx, absolute error near 2^-12)
        # differ, which can flip the rounding of an output: one bf16 ulp of
        # the largest output
        tol = 2.0 ** -7 * max(1.0, float(ref.float().abs().max()))
        wb, bb = wt.bfloat16(), bt.bfloat16()

        def library():
            y = F.group_norm(x, 32, wb, bb, eps)
            return F.silu(y) if silu else y

        nbytes = 2.0 * 2 * x.numel() + 8 * c
        ms, dispatch_ms = time_device(
            lambda: group_norm_silu(x, wt, bt, 32, eps, silu), 20)
        plan = plan_groupnorm(n, c, h * w, 32)
        row = dict(
            phase="group_norm_silu", shape=[n, c, h, w], eps=eps, silu=silu,
            route=plan.route, cluster=plan.cluster,
            bytes_per_cta=plan.bytes_per_cta,
            active_clusters=(active_clusters(plan) if plan.route == "cluster"
                             else None),
            calls_per_request=calls, max_abs_err=err, tol=tol,
            ms=ms, dispatch_ms=dispatch_ms,
            plain_ms=time_device(
                lambda: group_norm_silu_reference(x, wt, bt, 32, eps, silu),
                5)[0],
            library_ms=time_device(library, 20)[0],
            flops_ms=0.0, bytes_ms=nbytes / PEAK_BYTES * 1e3)
        row["bound_ms"] = row["bytes_ms"]
        emit(row)
        if not err <= tol:
            raise AssertionError(f"group_norm_silu {row['shape']}: max abs "
                                 f"error {err} > {tol}")
        rows.append(row)
    return rows


def check_unet(bundle, dev):
    """The full-width UNet in bf16 on the card against fp32 on the CPU."""
    import torch

    from cremage_tpu_torch.models.unet import UNetModel

    with torch.device("meta"):
        cpu_unet = UNetModel(dataclasses.replace(bundle.unet.cfg,
                                                 dtype=torch.float32))
    cpu_unet.load_state_dict({k: v.float().cpu() for k, v in
                              bundle.unet.state_dict().items()}, assign=True)
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 4, 64, 64, generator=g)
    t = torch.tensor([500.0])
    ctx = torch.randn(1, 77, 768, generator=g)
    with torch.no_grad():
        t0 = time.perf_counter()
        gpu = bundle.unet(x.to(dev), t.to(dev), ctx.to(dev)).float().cpu()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cpu = cpu_unet.eval()(x, t, ctx)
        t2 = time.perf_counter()
    rel = float((gpu - cpu).abs().max() / cpu.abs().max())
    rel_l2 = float((gpu - cpu).norm() / cpu.norm())
    # bf16 keeps 8 significant bits: each of the ~70 layers on the path
    # rounds its output to 2^-9 relative, and the errors add up along the
    # residual stream, so a few percent of the output's range is expected
    tol = 5e-2
    emit(dict(phase="unet_full_width", shape=[1, 4, 64, 64],
              max_rel_err=rel, rel_l2_err=rel_l2, tol=tol,
              finite=bool(torch.isfinite(gpu).all()),
              gpu_first_call_s=t1 - t0, cpu_fp32_s=t2 - t1))
    if not (torch.isfinite(gpu).all() and rel <= tol):
        raise AssertionError(f"UNet bf16-on-card vs fp32-on-CPU: max relative "
                             f"error {rel} > {tol}")


def serve(bundle, dev, card):
    import urllib.request

    import numpy as np
    import torch

    from cremage_tpu_torch.app.server import ApiServer, register_sd15
    from cremage_tpu_torch.app.worker import EngineWorker
    from cremage_tpu_torch.io.png import GENERATION_DATA_KEY, decode_png
    from cremage_tpu_torch.models.layers import GroupNorm
    from cremage_tpu_torch.models.unet import CrossAttention
    from cremage_tpu_torch.models.vae import AttnBlock
    from cremage_tpu_torch.ops.flash_attention import flash_attention
    from cremage_tpu_torch.ops.groupnorm import group_norm_silu
    from cremage_tpu_torch.pipelines.sd15 import SD15Pipeline

    def count(module, kind):
        return sum(isinstance(m, kind) for m in module.modules())

    # one launch per module call: every UNet attention / GroupNorm runs
    # once per sampler step, the VAE's once per decode
    want_k1 = REQUESTS * (STEPS * count(bundle.unet, CrossAttention)
                          + count(bundle.vae, AttnBlock))
    want_k2 = REQUESTS * (STEPS * count(bundle.unet, GroupNorm)
                          + count(bundle.vae, GroupNorm))

    decoded = []
    hook = bundle.vae.decoder.register_forward_hook(
        lambda m, a, out: decoded.append(bool(torch.isfinite(out).all())))
    worker = EngineWorker()
    register_sd15(worker, SD15Pipeline(bundle, device=dev))
    srv = ApiServer(worker=worker, port=0)
    srv.start()
    url = f"http://127.0.0.1:{srv.port}"

    def submit(seed, steps):
        body = json.dumps({
            "generator_model_type": "SD 1.5", "mode": "text_to_image",
            "parameters": {
                "prompt": PROMPT, "negative_prompt": NEGATIVE,
                "H": RES, "W": RES, "sampling_steps": steps,
                "sampler": "Euler A", "scale": 7.5, "seed": seed,
                "n_samples": BATCH, "n_iter": 1,
                "safety_check": False, "watermark": False}}).encode()
        req = urllib.request.Request(url + "/v1/generate", data=body,
                                     method="POST",
                                     headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=30).read()

    def drain(n_jobs):
        msgs, done, end = [], 0, time.time() + 600
        while done < n_jobs:
            if time.time() > end:
                raise TimeoutError(f"{done}/{n_jobs} jobs done in 600 s")
            got = json.loads(urllib.request.urlopen(
                url + "/v1/status", timeout=60).read())["messages"]
            for m in got:
                if isinstance(m, dict) and "job_done" in m:
                    if not m["job_done"]["ok"]:
                        raise RuntimeError(m["job_done"]["error"])
                    done += 1
            msgs += got
            if not got:
                time.sleep(0.02)
        return msgs

    try:
        submit(100, 2)                # warm-up: first-call set-up of cuDNN
        drain(1)                      # and cuBLAS, not counted or timed
        decoded.clear()
        flash_attention.launches = 0
        group_norm_silu.launches = 0
        t0 = time.perf_counter()
        for r in range(REQUESTS):
            submit(r * BATCH, STEPS)
        msgs = drain(REQUESTS)
        wall = time.perf_counter() - t0
        k1, k2 = flash_attention.launches, group_norm_silu.launches
    finally:
        hook.remove()
        srv.stop()

    images = [m for m in msgs if isinstance(m, dict) and "image_b64" in m]
    pixels = []
    for m in images:
        rgb, text = decode_png(base64.b64decode(m["image_b64"]))
        if rgb.shape != (RES, RES, 3) or GENERATION_DATA_KEY not in text:
            raise AssertionError(f"bad PNG: {rgb.shape}, {sorted(text)}")
        pixels.append(rgb)
    stds = [float(np.std(p.astype(np.float32))) for p in pixels]
    emit(dict(phase="serving", card=card, requests=REQUESTS,
              images=len(pixels), decodes_finite=decoded,
              pixel_std=stds, seconds=wall,
              seconds_per_request=wall / REQUESTS,
              images_per_s=len(pixels) / wall,
              flash_attention_launches=k1, group_norm_silu_launches=k2,
              expected_flash_attention=want_k1,
              expected_group_norm_silu=want_k2))
    if len(pixels) != REQUESTS * BATCH or not all(decoded) \
            or len(decoded) != REQUESTS or min(stds) <= 0.0:
        raise AssertionError("serving: expected 8 finite, non-constant images")
    if (k1, k2) != (want_k1, want_k2):
        raise AssertionError(f"kernel launches {(k1, k2)} != derived "
                             f"{(want_k1, want_k2)}")
    return {"flash_attention": k1, "group_norm_silu": k2}


def kernel_entry(name, source, replaces, rows, launches):
    """Per-request totals over the main path's shapes: each shape's time
    times its calls per request."""
    def total(key):
        return sum(r[key] * r["calls_per_request"] for r in rows)

    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=total("ms"), dispatch_ms=total("dispatch_ms"),
                plain_ms=total("plain_ms"),
                bound_ms=total("bound_ms"),
                bound_by="operations" if total("flops_ms") > total("bytes_ms")
                else "bytes",
                library_ms=total("library_ms"),
                calls_per_request=sum(r["calls_per_request"] for r in rows),
                shapes=len(rows))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from cremage_tpu_torch.ops import build
    from cremage_tpu_torch.pipelines.sd15 import build_sd15_bundle

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    emit(dict(phase="device", nvidia_smi=smi, kind=card,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda,
              cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
              matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32))

    watchdog("build")
    t0 = time.perf_counter()
    lib = build.build()
    build.kernels()
    emit(dict(phase="build", seconds=time.perf_counter() - t0, library=str(lib),
              ptxas=ptxas_summary((lib.parent / "nvcc.log").read_text())))

    watchdog("shapes_and_k1")
    t0 = time.perf_counter()
    bundle = build_sd15_bundle(dev, dtype=torch.bfloat16, seed=0)
    attn, gn = record_shapes(bundle, dev)
    emit(dict(phase="shapes", bundle_s=time.perf_counter() - t0,
              flash_attention_shapes=len(attn), group_norm_shapes=len(gn),
              flash_attention_calls_per_request=sum(attn.values()),
              group_norm_calls_per_request=sum(gn.values())))
    k1_rows = check_flash(attn, dev)
    watchdog("k2")
    k2_rows = check_groupnorm(gn, dev)
    watchdog("unet")
    check_unet(bundle, dev)
    watchdog("serving")
    launches = serve(bundle, dev, card)
    faulthandler.cancel_dump_traceback_later()
    emit({"kernels": [
        kernel_entry("flash_attention", "cremage_tpu_torch/csrc/flash_attention.cu",
                     "cremage_tpu/ops/flash_attention.py:94", k1_rows,
                     launches["flash_attention"]),
        kernel_entry("group_norm_silu", "cremage_tpu_torch/csrc/groupnorm.cu",
                     "cremage_tpu/ops/groupnorm.py:66", k2_rows,
                     launches["group_norm_silu"]),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
