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
8. modes: the server with that bundle and a full-width 9-channel
   inpainting bundle answers one request of each: img2img from an
   uploaded 512^2 PNG (DPM++ 2M, strength 0.75, batch 2), inpainting with
   an uploaded mask (DDIM, batch 2), hires fix "Latent" x1.5 (Euler A,
   batch 2) and "Lanczos" x2 (Euler, batch 1), MODE_STEPS steps each, each
   sent twice (the first run pays the first-call set-up of its shapes and
   is timed apart); each request's launch counts must equal those derived
   from the model code and its sampler's evaluations, and the inpainted
   images keep the unmasked pixels of the input;
9. samplers: each of the 12 menu samplers runs SAMPLER_STEPS steps
   through the full-width UNet at 64^2 latents, batch 1 with CFG; its
   launch counts must equal its evaluations times the UNet's calls;
10. sd15_full: SD1.5 as users run it, at full width and depth. Seeded
   random fp16 files in the published key layouts go under build/: a
   single-file checkpoint (every model key of the reference's key list,
   the schedule buffers, CLIP's position_ids), a standalone VAE, a kohya
   LoRA over all 264 modules of the reference's LoRA list (rank 4), a TI
   embedding (.pt), a ControlNet (control_model.*), a safety checker under
   HF names, wildcards and a config.yaml naming them. The server is built
   by main()'s --config route (build_server) and serves the product's job
   (512^2, Euler A, 20 steps, CFG 7.5, batch 4) with the safety check at
   its default (on, the classifier loaded from SAFETY_CHECKER_PATH), the
   watermark on, the LoRA, a TI tag and a wildcard in the prompt, and the
   ControlNet on an uploaded control image; sent twice (the first run
   loads the files). Checks: every weight on the card equals its file's
   (per tensor; checksums per group reported), the LoRA moved exactly its
   264 modules, each by the expected delta within one bf16 ulp; each PNG's
   watermark decodes; each image's metadata carries its safety flag; the
   K1 / K2 launches equal the counts derived from the module tree (the
   ControlNet's calls in each of the 20 evaluations at batch 8, the safety
   checker's 24 K1 calls per batch); a deny-listed prompt is refused;
11. sdxl: SDXL base as the JAX package benchmarks it (bench_sdxl: 1024^2,
   30 steps of EulerEDMSampler on LegacyDDPMDiscretization, CFG 7.0,
   batch 1), at full width and depth from seeded random fp16 files under
   build/: a single-file checkpoint in the sgm key layout (bigG's
   attention input projection fused, as published), a kohya LoRA over
   UNet, te1 and te2 modules, a two-tower TI file and a config.yaml. The
   --config server serves, with generator_model_type "SDXL": a 2-step
   warm-up (the load), the job twice (timed: seconds per request and
   images/s), once more with the shape hooks, one img2img request at
   1024^2 (strength 0.75) and one txt2img request at 832x1216 (8 steps;
   its lowest UNet level, 38x26, is where H*W % 8 != 0). Checks: every
   weight equals its file's and the LoRA's 10 modules the merge within one
   bf16 ulp; an unported sampler is refused; the images are finite,
   non-constant and of their size; each request's K1 / K2 launches equal
   the module tree's count and the recorded shapes' sum; one full-width
   SDXL UNet eval in bf16 against fp32 through the plain versions, on the
   card;
12. new paths' shapes: hooks record the shape of every K1 and K2 call of
   the checked run of each modes request, of the samplers phase, of
   sd15_full and of sdxl's requests (the recorded calls must add up to
   the launch counts), and the same checks as 4 and 5 run at every shape
   the main path's rows do not hold (the safety checker's d = 64 at batch
   4 and 1, SDXL's d = 64 at 10 and 20 heads among them), and at K2's
   H*W % 8 != 0 cases (K2_ANY_HW); each row lists the paths that run its
   shape with their calls per request;
13. the kernels line (per-request totals over the main path's shapes, as
   before, and per new path), then the contract's last line.
Each phase has a time limit (LIMITS_S): a hung kernel ends the run in its
phase with exit code 1.
Needs the repository (it imports cremage_tpu_torch), one card, and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import base64
import contextlib
import dataclasses
import faulthandler
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

STEPS, BATCH, REQUESTS, RES = 20, 4, 2, 512
# the new paths' depth: steps of the modes phase's requests (6 steps in an
# img2img or hires pass at strength 0.75) and of the samplers phase
# (widths are the full model's)
MODE_STEPS, STRENGTH, SAMPLER_STEPS = 8, 0.75, 4
# each phase's time limit, in s. A hang, say a kernel waiting on a wrong
# barrier phase, ends the run in its phase with a traceback and exit code
# 1 instead of using up the call. The K1 limit starts with the shapes
# phase: its model evals are K1's first launches.
LIMITS_S = dict(build=300, shapes_and_k1=180, k2=120, unet=180,
                serving=300, modes=300, samplers=240, sd15_full=480,
                sdxl=600, new_shapes=480)
# K2 where H*W % 8 != 0, beside the paths that run it (sdxl's 832x1216
# request): SD1.5 at 640^2 (10x10) and 576^2 (18x18, 9x9), and slabs that
# start off 16-byte boundaries (640 channels at 9x9; 5 channels of 33,123
# over a cluster of 4); one call each
K2_ANY_HW = [(8, 1280, 10, 10, 1e-5, True), (8, 640, 18, 18, 1e-5, True),
             (8, 1280, 9, 9, 1e-6, False), (8, 640, 9, 9, 1e-5, True),
             (2, 160, 181, 183, 1e-6, False)]
PROMPT = "a photograph of an astronaut riding a horse"
NEGATIVE = "blurry, low quality"
# sd15_full: a wildcard and a TI tag in the prompt, a rank-4 LoRA at 0.8
FULL_PROMPT = ("a photograph of an astronaut riding a __color__ horse, "
               "<embedding:astro.pt>")
LORA_RANK, LORA_ALPHA, LORA_WEIGHT = 4, 2.0, 0.8
DENY_TERM = "forbidden words"
WATERMARK = b"Cremage"
REPO = Path(__file__).resolve().parent


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


@contextlib.contextmanager
def recording(*models):
    """While open, count the K1 and K2 calls of the models (bundles: their
    UNets, VAEs and ControlNets; or modules, such as the safety checker)
    by shape: yields (attn, gn, weight), where each call adds weight["n"]
    (1 unless the caller sets it) to its shape's count."""
    from cremage_tpu_torch.models.clip import CLIPAttention
    from cremage_tpu_torch.models.layers import GroupNorm
    from cremage_tpu_torch.models.unet import CrossAttention
    from cremage_tpu_torch.models.vae import AttnBlock

    attn, gn = {}, {}
    weight = {"n": 1}

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

    def on_clip(mod, args):        # unmasked (the safety checker's): K1
        x, mask = args
        if mask is None:
            b, n, c = x.shape
            add(attn, (b, n, n, mod.heads, c // mod.heads))

    hooks = []
    for model in models:
        parts = ([model.unet, model.vae, getattr(model, "controlnet", None)]
                 if hasattr(model, "unet") else [model])
        for m in (m for part in parts if part is not None
                  for m in part.modules()):
            if isinstance(m, CrossAttention):
                hooks.append(m.register_forward_pre_hook(on_cross))
            elif isinstance(m, AttnBlock):
                hooks.append(m.register_forward_pre_hook(on_vae_attn))
            elif isinstance(m, GroupNorm):
                hooks.append(m.register_forward_pre_hook(on_gn))
            elif isinstance(m, CLIPAttention):
                hooks.append(m.register_forward_pre_hook(on_clip))
    try:
        yield attn, gn, weight
    finally:
        for h in hooks:
            h.remove()


def record_shapes(bundle, runs):
    """Run each (calls, fn) of `runs` once; -> the shape -> calls per
    request of every K1 and K2 call, a shape seen in a run counting
    `calls` times."""
    import torch

    with recording(bundle) as (attn, gn, weight), torch.no_grad():
        for calls, fn in runs:
            weight["n"] = calls
            fn()
        torch.cuda.synchronize()
    return attn, gn


def unet_eval(bundle, dev, batch, lat, seed):
    """One UNet call at (batch, 4, lat, lat) with a 77-token context."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda: bundle.unet(
        torch.randn(batch, 4, lat, lat, device=dev, generator=g),
        torch.full((batch,), 500.0, device=dev),
        torch.randn(batch, 77, 768, device=dev, generator=g))


def vae_call(bundle, dev, method, shape, seed):
    """One VAE encode or decode of a random NCHW input of `shape`."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return lambda: getattr(bundle.vae, method)(
        torch.randn(*shape, device=dev, generator=g))


def main_path_runs(bundle, dev):
    """The main path's request: 20 UNet evals at the CFG batch of 8 and
    one decode at batch 4, 512^2."""
    lat = RES // 8
    return [(STEPS, unet_eval(bundle, dev, 2 * BATCH, lat, 1)),
            (1, vae_call(bundle, dev, "decode", (BATCH, 4, lat, lat), 1))]


def check_flash(attn, dev):
    """K1 against its plain version at each shape of `attn`
    ({(B, Nq, Nk, H, d): {path: calls per request}}): error, device,
    dispatch, plain and library times, bound. -> {shape: row}."""
    import torch
    import torch.nn.functional as F

    from cremage_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference, plan_flash,
    )

    g = torch.Generator(device=dev).manual_seed(2)
    rows = {}
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
            calls_by_path=calls, max_abs_err=err, tol=tol,
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
        rows[(b, nq, nk, h, d)] = row
        del q, k, v, out, ref, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def check_groupnorm(gn, dev):
    """K2 against its plain version at each shape of `gn`
    ({(N, C, H, W, eps, silu): {path: calls per request}}), as
    check_flash. -> {shape: row}."""
    import torch
    import torch.nn.functional as F

    from cremage_tpu_torch.ops.groupnorm import (
        active_clusters, group_norm_silu, group_norm_silu_reference,
        plan_groupnorm,
    )

    g = torch.Generator(device=dev).manual_seed(3)
    rows = {}
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
            phase="group_norm_silu", shape=[n, c, h, w], eps=eps,
            silu=silu,
            route=plan.route, cluster=plan.cluster,
            bytes_per_cta=plan.bytes_per_cta,
            active_clusters=(active_clusters(plan) if plan.route == "cluster"
                             else None),
            calls_by_path=calls, max_abs_err=err, tol=tol,
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
        rows[(n, c, h, w, eps, silu)] = row
        del x, out, ref
        torch.cuda.empty_cache()
    return rows


def check_new_paths(paths, k1_rows, k2_rows, dev):
    """K1 and K2 at every shape that `paths` ({path: (attn, gn)}, each a
    shape -> calls per request) ran and no row of k1_rows / k2_rows holds;
    a held shape gets the path added to its row's calls_by_path. ->
    ({shape: row} of K1, of K2) for the shapes checked here."""
    out = []
    for i, (held, check) in enumerate(((k1_rows, check_flash),
                                       (k2_rows, check_groupnorm))):
        todo = {}
        for path, tables in paths.items():
            for key, calls in tables[i].items():
                if key in held:
                    held[key]["calls_by_path"][path] = calls
                else:
                    todo.setdefault(key, {})[path] = calls
        out.append(check(todo, dev))
    return tuple(out)


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


def count(module, kind) -> int:
    return sum(isinstance(m, kind) for m in module.modules())


def kernel_calls(bundle, evals: int, encodes: int, decodes: int):
    """(K1, K2) launches of a request from the model code: one launch per
    attention / GroupNorm module call; each UNet evaluation (the CFG
    batch in one call) runs every UNet module once, each encode and
    decode every module of that half of the VAE."""
    from cremage_tpu_torch.models.layers import GroupNorm
    from cremage_tpu_torch.models.unet import CrossAttention
    from cremage_tpu_torch.models.vae import AttnBlock

    vae = bundle.vae
    return (evals * count(bundle.unet, CrossAttention)
            + encodes * count(vae.encoder, AttnBlock)
            + decodes * count(vae.decoder, AttnBlock),
            evals * count(bundle.unet, GroupNorm)
            + encodes * count(vae.encoder, GroupNorm)
            + decodes * count(vae.decoder, GroupNorm))


# UNet evaluations of each menu sampler over n steps: the two-stage ones
# evaluate twice a step but at the last (plain Euler to sigma 0); DDIM
# runs one step per timestep of range(0, 1000, 1000 // n)
TWO_STAGE = ("Heun", "DPM2", "DPM2 A", "DPM++ 2S A", "DPM++ SDE")


def sampler_evals(name: str, n: int) -> int:
    if name == "DDIM":
        return len(range(0, 1000, 1000 // n))
    return 2 * n - 1 if name in TWO_STAGE else n


class Client:
    """The JSON API of one running ApiServer."""

    def __init__(self, url: str):
        self.url = url

    def call(self, path: str, body=None):
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.url + path, data=data, method="GET" if body is None else "POST",
            headers={"Content-Type": "application/json"})
        return json.loads(urllib.request.urlopen(req, timeout=60).read())

    def generate(self, mode: str, params: dict, model_type: str = "SD 1.5"):
        self.call("/v1/generate", {"generator_model_type": model_type,
                                   "mode": mode, "parameters": params})

    def drain(self, n_jobs: int, limit_s: float = 600):
        msgs, done, end = [], 0, time.time() + limit_s
        while done < n_jobs:
            if time.time() > end:
                raise TimeoutError(f"{done}/{n_jobs} jobs done in {limit_s} s")
            got = self.call("/v1/status")["messages"]
            for m in got:
                if isinstance(m, dict) and "job_done" in m:
                    if not m["job_done"]["ok"]:
                        raise RuntimeError(m["job_done"]["error"])
                    done += 1
            msgs += got
            if not got:
                time.sleep(0.02)
        return msgs


def served_images(msgs):
    """(pixels, generation_data) of every PNG among the status messages;
    raises on a PNG without generation_data."""
    from cremage_tpu_torch.io.png import GENERATION_DATA_KEY, decode_png

    out = []
    for m in msgs:
        if isinstance(m, dict) and "image_b64" in m:
            rgb, text = decode_png(base64.b64decode(m["image_b64"]))
            if GENERATION_DATA_KEY not in text:
                raise AssertionError(f"PNG without generation_data: {sorted(text)}")
            out.append((rgb, json.loads(text[GENERATION_DATA_KEY])))
    return out


def reset_counts():
    from cremage_tpu_torch.ops.flash_attention import flash_attention
    from cremage_tpu_torch.ops.groupnorm import group_norm_silu

    flash_attention.launches = 0
    group_norm_silu.launches = 0


def read_counts():
    from cremage_tpu_torch.ops.flash_attention import flash_attention
    from cremage_tpu_torch.ops.groupnorm import group_norm_silu

    return flash_attention.launches, group_norm_silu.launches


def serve(bundle, dev, card):
    import numpy as np
    import torch

    from cremage_tpu_torch.app.server import ApiServer, register_sd15
    from cremage_tpu_torch.app.worker import EngineWorker
    from cremage_tpu_torch.pipelines.sd15 import SD15Pipeline

    want_k1, want_k2 = (REQUESTS * k for k in
                        kernel_calls(bundle, STEPS, 0, 1))
    decoded = []
    hook = bundle.vae.decoder.register_forward_hook(
        lambda m, a, out: decoded.append(bool(torch.isfinite(out).all())))
    worker = EngineWorker()
    register_sd15(worker, SD15Pipeline(bundle, device=dev))
    srv = ApiServer(worker=worker, port=0)
    srv.start()
    client = Client(f"http://127.0.0.1:{srv.port}")

    def params(seed, steps):
        return {"prompt": PROMPT, "negative_prompt": NEGATIVE,
                "H": RES, "W": RES, "sampling_steps": steps,
                "sampler": "Euler A", "scale": 7.5, "seed": seed,
                "n_samples": BATCH, "n_iter": 1,
                "safety_check": False, "watermark": False}

    try:
        client.generate("text_to_image", params(100, 2))  # warm-up: first-call
        client.drain(1)                   # set-up of cuDNN and cuBLAS, not
        decoded.clear()                   # counted or timed
        reset_counts()
        t0 = time.perf_counter()
        for r in range(REQUESTS):
            client.generate("text_to_image", params(r * BATCH, STEPS))
        msgs = client.drain(REQUESTS)
        wall = time.perf_counter() - t0
        k1, k2 = read_counts()
    finally:
        hook.remove()
        srv.stop()

    pixels = []
    for rgb, _ in served_images(msgs):
        if rgb.shape != (RES, RES, 3):
            raise AssertionError(f"bad PNG: {rgb.shape}")
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


def test_image(res: int):
    """A smooth (res, res, 3) uint8 test picture and a mask (white where
    to inpaint: a centred block), both as RGB."""
    import numpy as np

    yy, xx = np.mgrid[0:res, 0:res] / res
    rgb = np.stack([np.sin(7 * xx + 2 * yy), np.cos(5 * yy - 3 * xx),
                    np.sin(4 * (xx + yy) + 1)], -1)
    img = np.round((rgb * 0.45 + 0.5) * 255).astype(np.uint8)
    mask = np.zeros((res, res, 3), np.uint8)
    mask[res // 4:3 * res // 4, res // 4:3 * res // 4] = 255
    return img, mask


def modes(bundle, inpaint_bundle, dev, card, res=RES, steps=MODE_STEPS):
    """One request of each new mode through /v1/generate, images uploaded
    through /v1/upload, each sent twice; per request: the seconds of both
    runs, and of the second its PNGs checked, its K1/K2 launches against
    the counts derived from the model code, and the shape of each launch.
    -> (rows, {request: (K1 shapes, K2 shapes)}), each a shape -> calls."""
    import tempfile

    import numpy as np
    import torch

    from cremage_tpu_torch.app.server import ApiServer, register_sd15
    from cremage_tpu_torch.app.worker import EngineWorker
    from cremage_tpu_torch.io.png import encode_png
    from cremage_tpu_torch.pipelines.sd15 import SD15Pipeline

    t_enc = max(1, int(STRENGTH * steps))     # as the pipeline computes it
    init, mask = test_image(res)
    base = {"prompt": PROMPT, "negative_prompt": NEGATIVE, "H": res, "W": res,
            "sampling_steps": steps, "scale": 7.5, "strength": STRENGTH,
            "safety_check": False, "watermark": False, "n_iter": 1}
    # (name, mode, parameters, batch, side of the images, UNet evals,
    # encodes, decodes)
    requests = [
        ("img2img", "image_to_image",
         dict(sampler="DPM++ 2M", n_samples=2), 2, res, t_enc, 1, 1),
        ("inpainting", "inpainting", dict(sampler="DDIM", n_samples=2), 2,
         res, sampler_evals("DDIM", steps), 1, 1),
        ("hires Latent x1.5", "text_to_image",
         dict(sampler="Euler A", n_samples=2, use_hires_fix=True,
              hires_fix_upscaler="Latent", hires_fix_scale_factor=1.5), 2,
         int(res // 8 * 1.5) // 8 * 64, steps + t_enc, 0, 1),
        ("hires Lanczos x2", "text_to_image",
         dict(sampler="Euler", n_samples=1, use_hires_fix=True,
              hires_fix_upscaler="Lanczos", hires_fix_scale_factor=2.0), 1,
         res * 2, steps + t_enc, 1, 2),
    ]
    finite = []
    hooks = [b.vae.decoder.register_forward_hook(
        lambda m, a, out: finite.append(bool(torch.isfinite(out).all())))
        for b in (bundle, inpaint_bundle)]
    worker = EngineWorker()
    register_sd15(worker, SD15Pipeline(bundle, device=dev),
                  SD15Pipeline(inpaint_bundle, device=dev))
    rows, shapes = [], {}
    with tempfile.TemporaryDirectory() as uploads:
        srv = ApiServer(worker=worker, port=0, upload_dir=uploads)
        srv.start()
        client = Client(f"http://127.0.0.1:{srv.port}")
        try:
            paths = {k: client.call("/v1/upload", {
                "image": base64.b64encode(encode_png(a)).decode()})["path"]
                for k, a in (("init_img", init), ("mask_img", mask))}
            for seed, (name, mode, extra, batch, side, evals, enc, dec) in \
                    enumerate(requests):
                params = dict(base, seed=1000 + seed, **extra)
                if mode != "text_to_image":
                    params["init_img"] = paths["init_img"]
                if mode == "inpainting":
                    params["mask_img"] = paths["mask_img"]
                # twice: the first run pays the first-call set-up of its
                # new shapes (cuDNN, cuBLAS); the second is the one checked
                walls = []
                for _ in range(2):
                    finite.clear()
                    reset_counts()
                    with recording(bundle, inpaint_bundle) as (attn, gn, _):
                        t0 = time.perf_counter()
                        client.generate(mode, params)
                        msgs = client.drain(1)
                        walls.append(time.perf_counter() - t0)
                    k1, k2 = read_counts()
                shapes[name] = (attn, gn)
                want = kernel_calls(bundle, evals, enc, dec)
                images = served_images(msgs)
                stds = [float(np.std(p.astype(np.float32))) for p, _ in images]
                kept = None
                if mode == "inpainting":   # the unmasked pixels, up to PNG
                    keep = mask[..., 0] == 0             # rounding
                    kept = max(int(np.abs(p[keep].astype(int)
                                          - init[keep].astype(int)).max())
                               for p, _ in images)
                row = dict(phase="modes", request=name, card=card,
                           sampler=params["sampler"], steps=steps,
                           batch=batch, seconds=walls[1],
                           first_call_seconds=walls[0],
                           images=[list(p.shape) for p, _ in images],
                           decodes_finite=list(finite), pixel_std=stds,
                           unmasked_max_diff=kept,
                           flash_attention_launches=k1,
                           group_norm_silu_launches=k2,
                           expected_flash_attention=want[0],
                           expected_group_norm_silu=want[1],
                           recorded_calls=[sum(attn.values()),
                                           sum(gn.values())])
                emit(row)
                if len(images) != batch or any(
                        p.shape != (side, side, 3) for p, _ in images):
                    raise AssertionError(f"{name}: images {row['images']}, "
                                         f"want {batch} of {side}^2")
                if any(m["mode"] != mode or m["sampler"] != params["sampler"]
                       for _, m in images):
                    raise AssertionError(f"{name}: generation_data of another job")
                if len(finite) != dec or not all(finite) or min(stds) <= 0.0:
                    raise AssertionError(f"{name}: expected {dec} finite "
                                         "decodes and non-constant images")
                if kept is not None and kept > 1:
                    raise AssertionError(f"{name}: unmasked pixels moved by "
                                         f"{kept} > 1")
                if not (k1, k2) == want == tuple(row["recorded_calls"]):
                    raise AssertionError(
                        f"{name}: kernel launches {(k1, k2)}, derived {want}"
                        f", recorded {row['recorded_calls']} differ")
                rows.append(row)
        finally:
            for h in hooks:
                h.remove()
            srv.stop()
    return rows, shapes


def samplers(bundle, dev, card, res=RES, steps=SAMPLER_STEPS):
    """Each menu sampler for `steps` steps through the UNet at batch 1
    with CFG; its latents finite, its launches its evaluations' worth.
    -> (rows, (K1 shapes, K2 shapes)), each a shape -> calls over the 12
    runs."""
    import torch

    from cremage_tpu_torch.core.config import GenerationOptions
    from cremage_tpu_torch.core.rng import GeneratorNoise
    from cremage_tpu_torch.pipelines.sd15 import SAMPLER_MENU, SD15Pipeline

    pipe = SD15Pipeline(bundle, device=dev)
    rows, attn, gn = [], {}, {}
    for i, name in enumerate(SAMPLER_MENU):
        opts = GenerationOptions(prompt=PROMPT, negative_prompt=NEGATIVE,
                                 H=res, W=res, sampling_steps=steps,
                                 sampler=name, scale=7.5, n_samples=1,
                                 safety_check=False)
        with torch.no_grad():
            c, uc = pipe._conditioning(opts, 1)
            reset_counts()
            with recording(bundle) as (r_attn, r_gn, _):
                t0 = time.perf_counter()
                lat = pipe.txt2img_latents(opts, c, uc, GeneratorNoise(i, dev))
                finite = bool(torch.isfinite(lat).all())  # waits for the card
                wall = time.perf_counter() - t0
        k1, k2 = read_counts()
        for table, run in ((attn, r_attn), (gn, r_gn)):
            for key, n in run.items():
                table[key] = table.get(key, 0) + n
        evals = sampler_evals(name, steps)
        want = kernel_calls(bundle, evals, 0, 0)
        row = dict(phase="samplers", sampler=name, card=card, steps=steps,
                   unet_evals=evals, seconds=wall, finite=finite,
                   latent_std=float(lat.float().std()),
                   flash_attention_launches=k1, group_norm_silu_launches=k2,
                   expected_flash_attention=want[0],
                   expected_group_norm_silu=want[1],
                   recorded_calls=[sum(r_attn.values()), sum(r_gn.values())])
        emit(row)
        if not row["finite"] or lat.shape != (1, res // 8, res // 8, 4):
            raise AssertionError(f"{name}: latents {tuple(lat.shape)}, finite "
                                 f"{row['finite']}")
        if not (k1, k2) == want == tuple(row["recorded_calls"]):
            raise AssertionError(f"{name}: kernel launches {(k1, k2)}, derived"
                                 f" {want}, recorded {row['recorded_calls']}"
                                 " differ")
        rows.append(row)
    return rows, (attn, gn)


def keylist(name: str):
    """The keys of a reference key list (tests/fixtures/keylists)."""
    text = (REPO / "tests" / "fixtures" / "keylists" / name).read_text()
    return [ln.strip() for ln in text.splitlines()
            if ln.strip() and not ln.startswith("#")]


def seeded_state(cls, cfg, dev, seed):
    """`cls(cfg)`'s state dict with seeded random float32 weights on `dev`:
    the module's own init, each 1-D tensor (norm affines, biases) moved by
    0.02 N(0, 1) so that no tensor is trivial."""
    import torch

    fork = [dev] if torch.device(dev).type == "cuda" else []
    with torch.random.fork_rng(devices=fork), torch.device(dev):
        torch.manual_seed(seed)
        sd = cls(cfg).state_dict()
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    for v in sd.values():
        if v.ndim == 1 and v.is_floating_point():
            v.add_(0.02 * torch.randn(v.shape, device=dev, generator=g))
    return sd


def lora_modules(unet_cfg):
    """The kohya modules of the reference's SD1.5 LoRA list -> (model,
    module name) of the port."""
    from cremage_tpu_torch.io.lora import group_lora_modules, kohya_module_to_torch_name

    mods = group_lora_modules(dict.fromkeys(keylist(
        "reference_sd15_lora_weight_list.txt")))
    return {m: kohya_module_to_torch_name(m, unet_cfg) for m in sorted(mods)}


def write_full_files(root: Path, dev, cfgs: dict, full_width: bool = True):
    """Seeded random fp16 files of an SD1.5 deployment under `root`, and
    what each holds: -> (paths, truth), truth[group] = {key: fp16 CPU
    tensor} as the group's model names it (the LoRA's as its file does)."""
    import torch

    from cremage_tpu_torch.io import checkpoint as CK
    from cremage_tpu_torch.models.clip import CLIPTextModel
    from cremage_tpu_torch.models.controlnet import PREFIX_CONTROLNET, ControlNet
    from cremage_tpu_torch.models.safety_checker import StableDiffusionSafetyChecker
    from cremage_tpu_torch.models.unet import UNetModel
    from cremage_tpu_torch.models.vae import AutoencoderKL

    root.mkdir(parents=True, exist_ok=True)

    def host(sd):
        return {k: v.half().cpu() for k, v in sd.items()}

    truth = {"unet": host(seeded_state(UNetModel, cfgs["unet"], dev, 10)),
             "clip": host(seeded_state(CLIPTextModel, cfgs["clip"], dev, 11)),
             "vae": host(seeded_state(AutoencoderKL, cfgs["vae"], dev, 12)),
             "controlnet": host(seeded_state(ControlNet, cfgs["controlnet"],
                                             dev, 13)),
             "safety": host(seeded_state(StableDiffusionSafetyChecker,
                                         cfgs["safety"], dev, 14))}
    # no concept scores above their thresholds (a cosine is at most 1):
    # no image is swapped for the black placeholder, so every watermark
    # can be decoded
    truth["safety"]["concept_embeds_weights"].fill_(1.5)
    paths = {k: root / n for k, n in (
        ("ckpt", "sd15.safetensors"), ("vae", "vae.safetensors"),
        ("lora", "lora.safetensors"), ("controlnet", "control.safetensors"),
        ("safety", "safety_checker.safetensors"), ("embeddings", "embeddings"),
        ("wildcards", "wildcards"), ("config", "config.yaml"))}
    ckpt = {}
    # the checkpoint's own VAE differs from the standalone one the job names
    for prefix, sd in ((CK.PREFIX_UNET, truth["unet"]),
                       (CK.PREFIX_VAE, host(seeded_state(
                           AutoencoderKL, cfgs["vae"], dev, 15))),
                       (CK.PREFIX_CLIP_SD15, truth["clip"])):
        ckpt.update({prefix + k: v for k, v in sd.items()})
    if full_width:      # every model key of a real checkpoint, no other
        ref = [k for k in keylist("reference_sd15_weight_list.txt")
               if "_lora_" not in k and k not in CK.SCHEDULE_KEYS]
        if set(ref) != set(ckpt):
            raise AssertionError("the port's modules do not name the "
                                 "reference's checkpoint keys")
        ckpt = {k: ckpt[k] for k in ref}
    betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000,
                           dtype=torch.float64) ** 2
    ckpt["betas"] = betas.float()
    ckpt["alphas_cumprod"] = torch.cumprod(1 - betas, 0).float()
    ckpt[CK.PREFIX_CLIP_SD15 + CK.POSITION_IDS] = torch.arange(77)[None]
    CK.save_safetensors(str(paths["ckpt"]), ckpt)
    CK.save_safetensors(str(paths["vae"]), truth["vae"])
    CK.save_safetensors(str(paths["controlnet"]),
                        {PREFIX_CONTROLNET + k: v
                         for k, v in truth["controlnet"].items()})
    CK.save_safetensors(str(paths["safety"]), dict(
        truth["safety"], **{"vision_model.vision_model." + CK.POSITION_IDS:
                            torch.arange(257)[None]}))
    del ckpt
    with torch.device("meta"):
        shapes = {"unet": UNetModel(cfgs["unet"]),
                  "te": CLIPTextModel(cfgs["clip"])}
    g = torch.Generator(device=dev).manual_seed(16)
    lora = {}
    for mod, dest in lora_modules(cfgs["unet"]).items():
        if dest is None or dest[0] not in shapes:
            continue
        try:
            w = shapes[dest[0]].get_submodule(dest[1]).weight
        except AttributeError:       # not in a narrowed model
            continue
        tail = tuple(w.shape[2:])
        lora[mod + ".lora_down.weight"] = 0.05 * torch.randn(
            (LORA_RANK, w.shape[1]) + tail, device=dev, generator=g)
        lora[mod + ".lora_up.weight"] = 0.05 * torch.randn(
            (w.shape[0], LORA_RANK) + (1,) * len(tail), device=dev, generator=g)
        lora[mod + ".alpha"] = torch.tensor(LORA_ALPHA)
    truth["lora"] = host(lora)
    CK.save_safetensors(str(paths["lora"]), truth["lora"])
    paths["embeddings"].mkdir(exist_ok=True)
    truth["ti"] = 0.02 * torch.randn(2, cfgs["clip"].hidden_size,
                                     generator=torch.Generator().manual_seed(17))
    torch.save({"string_to_param": {"*": truth["ti"]}, "name": "astro"},
               paths["embeddings"] / "astro.pt")
    paths["wildcards"].mkdir(exist_ok=True)
    (paths["wildcards"] / "color.txt").write_text(
        "# the horse's colour\nwhite\nsilver\n\nchestnut\n")

    def q(v):
        return "'" + str(v).replace("'", "''") + "'"
    paths["config"].write_text("".join(f"{k}: {q(v)}\n" for k, v in (
        ("ldm_model_path", root), ("ldm_model", paths["ckpt"].name),
        ("embedding_path", paths["embeddings"]),
        ("control_model_path", root), ("lora_model_path", root))))
    return {k: str(v) for k, v in paths.items()}, truth


def bf16_ulp(x):
    """One bf16 ulp of each value of x (8 significant bits)."""
    import torch

    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_weights(bundle, safety_model, truth, unet_cfg):
    """sd15_full's weights on the card against their files (check_groups)."""
    lora_sd = truth["lora"]
    targets = {}
    for mod, dest in lora_modules(unet_cfg).items():
        if mod + ".lora_up.weight" in lora_sd:
            model, name = dest
            targets[("unet" if model == "unet" else "clip", name + ".weight")] = mod
    groups = {"unet": bundle.unet, "clip": bundle.text.model, "vae": bundle.vae,
              "controlnet": bundle.controlnet, "safety": safety_model}
    return check_groups("sd15_full_weights", groups, truth, targets)


def check_groups(phase, groups, truth, targets):
    """Every weight of `groups` ({group: model}) on the card against
    truth[group] (its file's tensors): equal where no LoRA touched it, and
    each LoRA target ({(group, key): kohya module}) within one bf16 ulp of
    the merge W + w * alpha / r * up @ down (float32) of truth["lora"].
    -> a row of per-group checksums and counts; raises on a mismatch."""
    import torch

    lora_sd = truth["lora"]
    row = dict(phase=phase, groups={})
    moved = 0
    for group, model in groups.items():
        card_sum = file_sum = 0.0
        equal = lora = 0
        for key, p in model.state_dict().items():
            want = truth[group][key].to(p.device, p.dtype)
            mod = targets.get((group, key))
            if mod is not None:
                up, down = (lora_sd[f"{mod}.lora_{s}.weight"].to(
                    p.device).float() for s in ("up", "down"))
                delta = (torch.einsum("orab,rihw->oihw", up, down)
                         if up.ndim == 4 else up @ down).reshape(p.shape)
                want_m = (want.float() + delta * (LORA_WEIGHT * LORA_ALPHA
                                                  / LORA_RANK)).to(p.dtype)
                err = (p.float() - want_m.float()).abs()
                if not bool((err <= bf16_ulp(want_m)).all()):
                    raise AssertionError(f"LoRA {mod}: {group}.{key} is "
                                         f"{float(err.max())} off the merge")
                if torch.equal(p, want):
                    raise AssertionError(f"LoRA {mod} left {key} unchanged")
                want, lora = want_m, lora + 1
            elif not torch.equal(p, want):
                raise AssertionError(f"{group}.{key} differs from its file")
            else:
                equal += 1
            card_sum += float(p.double().sum())
            file_sum += float(want.double().sum())
        row["groups"][group] = dict(tensors=equal + lora, equal=equal,
                                    lora_merged=lora, card_checksum=card_sum,
                                    file_checksum=file_sum)
        moved += lora
    row["lora_modules"] = moved
    if moved != len(targets):
        raise AssertionError(f"the LoRA moved {moved} of {len(targets)} modules")
    return row


def expect_refused(client, params, what, model_type="SD 1.5"):
    """POST a job that must fail before it runs: -> its error."""
    client.generate("text_to_image", params, model_type)
    end = time.time() + 60
    while time.time() < end:
        for m in client.call("/v1/status")["messages"]:
            if isinstance(m, dict) and "job_done" in m:
                if m["job_done"]["ok"]:
                    raise AssertionError(f"{what}: the job ran")
                return m["job_done"]["error"]
        time.sleep(0.02)
    raise TimeoutError(what)


def sd15_full(dev, card, root: Path, res=RES, steps=STEPS, batch=BATCH,
              cfgs=None, full_width=True):
    """The phase sd15_full (see the module docstring). -> (rows, {path:
    (K1 shapes, K2 shapes)}, launches of the checked run)."""
    import numpy as np
    import torch

    from cremage_tpu_torch.app.server import build_server
    from cremage_tpu_torch.io.png import encode_png
    from cremage_tpu_torch.models.clip import CLIPAttention
    from cremage_tpu_torch.models.layers import GroupNorm
    from cremage_tpu_torch.models.unet import CrossAttention
    from cremage_tpu_torch.services.watermark import decode_watermark

    cfgs = cfgs or full_configs()
    t0 = time.perf_counter()
    paths, truth = write_full_files(root, dev, cfgs, full_width)
    file_bytes = {k: os.path.getsize(v) for k, v in paths.items()
                  if os.path.isfile(v)}
    rows = [dict(phase="sd15_full_files", seconds=time.perf_counter() - t0,
                 bytes=file_bytes, lora_modules=len(truth["lora"]) // 3)]
    emit(rows[0])
    old_env = os.environ.get("SAFETY_CHECKER_PATH")
    os.environ["SAFETY_CHECKER_PATH"] = paths["safety"]
    srv = build_server(["--config", paths["config"], "--port", "0",
                        "--deny-term", DENY_TERM])
    srv.start()
    client = Client(f"http://127.0.0.1:{srv.port}")
    try:
        control = client.call("/v1/upload", {"image": base64.b64encode(
            encode_png(test_image(res)[0])).decode()})["path"]
        params = {"prompt": FULL_PROMPT, "negative_prompt": NEGATIVE,
                  "H": res, "W": res, "sampling_steps": steps,
                  "sampler": "Euler A", "scale": 7.5, "n_samples": batch,
                  "n_iter": 1, "watermark": True,
                  "vae_ckpt": paths["vae"], "lora_models": paths["lora"],
                  "lora_weights": str(LORA_WEIGHT),
                  "wildcards_path": paths["wildcards"],
                  "control_net": paths["controlnet"],
                  "control_image_path": control}
        refused = expect_refused(client, dict(params, prompt=DENY_TERM),
                                 "deny-listed prompt")
        walls, shapes = [], {}
        for run in range(2):        # the first run loads the files
            reset_counts()
            pipe = None
            if run:
                pipe = srv.worker._backends["SD 1.5"].resident.instance
            with contextlib.ExitStack() as stack:
                if pipe is not None:
                    attn, gn, _ = stack.enter_context(recording(
                        pipe.bundle, pipe.safety.classifier.model))
                t1 = time.perf_counter()
                client.generate("text_to_image", dict(params, seed=500 + run))
                msgs = client.drain(1)
                walls.append(time.perf_counter() - t1)
            k1, k2 = read_counts()
        shapes["sd15_full"] = (attn, gn)
        bundle, safety = pipe.bundle, pipe.safety
        images = served_images(msgs)
        # the safety checker at batch 1: the (1, 257, 257, 16, 64) shape
        imgs01 = np.stack([p.astype(np.float32) / 255 for p, _ in images])
        with recording(safety.classifier.model) as (attn1, gn1, _):
            _, flags1 = safety.check(imgs01[:1])
        shapes["safety batch 1"] = (attn1, gn1)
    finally:
        srv.stop()
        if old_env is None:
            os.environ.pop("SAFETY_CHECKER_PATH", None)
        else:
            os.environ["SAFETY_CHECKER_PATH"] = old_env

    weights = check_weights(bundle, safety.classifier.model, truth, cfgs["unet"])
    emit(weights)
    n_safety = count(safety.classifier.model, CLIPAttention)
    want_k1, want_k2 = kernel_calls(bundle, steps, 0, 1)
    want_k1 += steps * count(bundle.controlnet, CrossAttention) + n_safety
    want_k2 += steps * count(bundle.controlnet, GroupNorm)
    loads = dict(bundle.load_report["files"], **safety.classifier.load_report)
    marks = [decode_watermark(p, len(WATERMARK)) for p, _ in images]
    row = dict(phase="sd15_full", card=card, steps=steps, batch=batch,
               seconds=walls[1], seconds_per_request=walls[1],
               first_run_seconds=walls[0],
               load={k: dict(v, gb_per_s=v["bytes"] / max(v["seconds"], 1e-9)
                             / 1e9) for k, v in loads.items()},
               images=[list(p.shape) for p, _ in images],
               pixel_std=[float(np.std(p.astype(np.float32))) for p, _ in images],
               watermarks=[m.decode("latin-1") for m in marks],
               nsfw=[m.get("nsfw") for _, m in images],
               prompts=[m["prompt"] for _, m in images],
               safety_batch1_flags=flags1, refused=refused,
               lora=bundle.load_report["loras"],
               flash_attention_launches=k1, group_norm_silu_launches=k2,
               expected_flash_attention=want_k1,
               expected_group_norm_silu=want_k2,
               safety_checker_k1_per_batch=n_safety,
               recorded_calls=[sum(attn.values()), sum(gn.values())])
    emit(row)
    if len(images) != batch or any(p.shape != (res, res, 3) for p, _ in images):
        raise AssertionError(f"sd15_full: images {row['images']}")
    if min(row["pixel_std"]) <= 0.0:
        raise AssertionError("sd15_full: a constant image")
    if any(m != WATERMARK for m in marks):
        raise AssertionError(f"sd15_full: watermarks decode to {marks}")
    if any(not isinstance(f, bool) for f in row["nsfw"]) or \
            flags1 != row["nsfw"][:1]:
        raise AssertionError(f"sd15_full: safety flags {row['nsfw']}, "
                             f"at batch 1 {flags1}")
    if any("__" in p or "<embedding" not in p for p in row["prompts"]):
        raise AssertionError(f"sd15_full: prompts {row['prompts']}")
    if "Safety check" not in (refused or ""):
        raise AssertionError(f"sd15_full: deny term not refused: {refused}")
    if not (k1, k2) == (want_k1, want_k2) == tuple(row["recorded_calls"]):
        raise AssertionError(f"sd15_full: kernel launches {(k1, k2)}, derived "
                             f"{(want_k1, want_k2)}, recorded "
                             f"{row['recorded_calls']} differ")
    return rows + [weights, row], shapes, (k1, k2)


# SDXL: the JAX package's bench_sdxl job (1024^2, 30 steps of
# EulerEDMSampler on LegacyDDPMDiscretization, CFG 7.0, batch 1)
SDXL_RES, SDXL_STEPS, SDXL_CFG, SDXL_BATCH, SDXL_REQUESTS = 1024, 30, 7.0, 1, 2
# SDXL's standard 832x1216 bucket (H, W): its lowest UNet level is 26x38
SDXL_TALL, SDXL_TALL_STEPS = (1216, 832), 8
SDXL_PROMPT = "a photograph of an astronaut riding a horse, <embedding:astro_xl.pt>"
# kohya modules of sdxl's LoRA (UNet under diffusers names, te1 -> CLIP-L,
# te2 -> OpenCLIP bigG), 2-D as kohya exports SDXL's; SDXL_LORA_CONV of them
# in the 1x1-conv form of SD1.5's proj_in / proj_out, which the loader also
# merges onto SDXL's Linear layers
SDXL_LORA_CONV = ("lora_unet_down_blocks_2_attentions_0_proj_out",)
SDXL_LORA = SDXL_LORA_CONV + (
    "lora_unet_down_blocks_1_attentions_0_transformer_blocks_0_attn1_to_q",
    "lora_unet_down_blocks_2_attentions_1_transformer_blocks_9_attn2_to_k",
    "lora_unet_mid_block_attentions_0_transformer_blocks_5_ff_net_0_proj",
    "lora_unet_mid_block_attentions_0_proj_in",
    "lora_unet_up_blocks_0_attentions_2_proj_out",
    "lora_unet_up_blocks_1_attentions_0_transformer_blocks_1_ff_net_2",
    "lora_te1_text_model_encoder_layers_11_self_attn_v_proj",
    "lora_te2_text_model_encoder_layers_0_self_attn_q_proj",
    "lora_te2_text_model_encoder_layers_31_mlp_fc2",
)


def sdxl_configs():
    """The published SDXL base widths and depths, in bf16."""
    import torch

    from cremage_tpu_torch.models.clip import CLIPTextConfig
    from cremage_tpu_torch.models.open_clip import openclip_bigg_config
    from cremage_tpu_torch.models.unet import sdxl_base_unet_config
    from cremage_tpu_torch.models.vae import sdxl_vae_config

    bf16 = torch.bfloat16
    return dict(unet=sdxl_base_unet_config(dtype=bf16),
                clip=CLIPTextConfig(dtype=bf16),
                openclip=openclip_bigg_config(dtype=bf16),
                vae=sdxl_vae_config(dtype=bf16))


def fused_openclip(sd):
    """The OpenCLIP tower's split q/k/v keys as the published checkpoints
    store them: one attn.in_proj_weight / in_proj_bias, rows [q; k; v]."""
    import torch

    out = {}
    for k, v in sd.items():
        if ".attn.q_proj." in k:
            base, kind = k.split(".attn.q_proj.")
            out[f"{base}.attn.in_proj_{kind}"] = torch.cat(
                [sd[f"{base}.attn.{n}_proj.{kind}"] for n in "qkv"])
        elif ".attn.k_proj." not in k and ".attn.v_proj." not in k:
            out[k] = v
    return out


def write_sdxl_files(root: Path, dev, cfgs: dict):
    """Seeded random fp16 files of an SDXL base deployment under `root`: a
    single-file checkpoint in the sgm key layout (the OpenCLIP tower's
    attention input projection fused, its logit_scale, CLIP-L's
    position_ids), a kohya LoRA (rank 4) over SDXL_LORA, a two-tower TI
    file and a config.yaml. -> (paths, truth, {(group, key): module} of
    the LoRA's targets)."""
    import torch

    from cremage_tpu_torch.io import checkpoint as CK
    from cremage_tpu_torch.io.lora import kohya_module_to_torch_name
    from cremage_tpu_torch.models.clip import CLIPTextModel
    from cremage_tpu_torch.models.open_clip import OpenCLIPTextModel
    from cremage_tpu_torch.models.unet import UNetModel
    from cremage_tpu_torch.models.vae import AutoencoderKL

    root.mkdir(parents=True, exist_ok=True)

    def host(sd):
        return {k: v.half().cpu() for k, v in sd.items()}

    truth = {"unet": host(seeded_state(UNetModel, cfgs["unet"], dev, 20)),
             "clip": host(seeded_state(CLIPTextModel, cfgs["clip"], dev, 21)),
             "openclip": host(seeded_state(OpenCLIPTextModel, cfgs["openclip"],
                                           dev, 22)),
             "vae": host(seeded_state(AutoencoderKL, cfgs["vae"], dev, 23))}
    paths = {k: root / n for k, n in (
        ("ckpt", "sdxl_base.safetensors"), ("lora", "lora_xl.safetensors"),
        ("embeddings", "embeddings_sdxl"), ("config", "config.yaml"))}
    ckpt = {}
    for prefix, sd in ((CK.PREFIX_UNET, truth["unet"]),
                       (CK.PREFIX_VAE, truth["vae"]),
                       (CK.PREFIX_CLIP_SDXL, truth["clip"]),
                       (CK.PREFIX_OPENCLIP_SDXL,
                        fused_openclip(truth["openclip"]))):
        ckpt.update({prefix + k: v for k, v in sd.items()})
    ckpt[CK.PREFIX_CLIP_SDXL + CK.POSITION_IDS] = torch.arange(77)[None]
    ckpt[CK.PREFIX_OPENCLIP_SDXL + "logit_scale"] = torch.tensor(4.6052)
    CK.save_safetensors(str(paths["ckpt"]), ckpt)
    del ckpt
    with torch.device("meta"):
        models = {"unet": UNetModel(cfgs["unet"]),
                  "te": CLIPTextModel(cfgs["clip"]),
                  "te2": OpenCLIPTextModel(cfgs["openclip"])}
    group = {"unet": "unet", "te": "clip", "te2": "openclip"}
    g = torch.Generator(device=dev).manual_seed(24)
    lora, targets = {}, {}
    for mod in SDXL_LORA:
        which, name = kohya_module_to_torch_name(mod, cfgs["unet"])
        w = models[which].get_submodule(name).weight
        tail = (1, 1) if mod in SDXL_LORA_CONV else ()
        lora[mod + ".lora_down.weight"] = 0.05 * torch.randn(
            (LORA_RANK, w.shape[1]) + tail, device=dev, generator=g)
        lora[mod + ".lora_up.weight"] = 0.05 * torch.randn(
            (w.shape[0], LORA_RANK) + tail, device=dev, generator=g)
        lora[mod + ".alpha"] = torch.tensor(LORA_ALPHA)
        targets[(group[which], name + ".weight")] = mod
    truth["lora"] = host(lora)
    CK.save_safetensors(str(paths["lora"]), truth["lora"])
    paths["embeddings"].mkdir(exist_ok=True)
    gen = torch.Generator().manual_seed(25)
    torch.save({"clip_l": 0.02 * torch.randn(2, cfgs["clip"].hidden_size,
                                             generator=gen),
                "clip_g": 0.02 * torch.randn(2, cfgs["openclip"].width,
                                             generator=gen)},
               paths["embeddings"] / "astro_xl.pt")

    def q(v):
        return "'" + str(v).replace("'", "''") + "'"
    paths["config"].write_text("".join(f"{k}: {q(v)}\n" for k, v in (
        ("sdxl_ldm_model_path", root), ("sdxl_ldm_model", paths["ckpt"].name),
        ("sdxl_embedding_path", paths["embeddings"]),
        ("sdxl_lora_model_path", root))))
    return {k: str(v) for k, v in paths.items()}, truth, targets


@contextlib.contextmanager
def plain_kernels():
    """While open, the model code calls the kernels' plain versions (for an
    fp32 reference on the card: the kernels take bf16 only)."""
    from cremage_tpu_torch.models import layers
    from cremage_tpu_torch.ops import flash_attention as FA
    from cremage_tpu_torch.ops import groupnorm as GN

    saved = FA.flash_attention, layers.group_norm_silu
    FA.flash_attention = FA.flash_attention_reference
    layers.group_norm_silu = GN.group_norm_silu_reference
    try:
        yield
    finally:
        FA.flash_attention, layers.group_norm_silu = saved


def check_unet_sdxl(bundle, dev):
    """The full-width SDXL UNet at a 1024^2 latent in bf16 through the
    kernels against the same weights in fp32 through the plain versions,
    both on the card."""
    import torch

    from cremage_tpu_torch.models.unet import UNetModel

    with torch.device("meta"):
        ref = UNetModel(dataclasses.replace(bundle.unet.cfg,
                                            dtype=torch.float32))
    ref.load_state_dict({k: v.float() for k, v in
                         bundle.unet.state_dict().items()}, assign=True)
    g = torch.Generator(device=dev).manual_seed(26)
    lat = SDXL_RES // 8
    x = torch.randn(1, 4, lat, lat, device=dev, generator=g)
    t = torch.tensor([500.0], device=dev)
    ctx = torch.randn(1, 77, 2048, device=dev, generator=g)
    y = torch.randn(1, 2816, device=dev, generator=g)
    with torch.no_grad():
        got = bundle.unet(x, t, ctx, y=y).float()
        with plain_kernels():
            want = ref.eval()(x, t, ctx, y=y)
    rel = float((got - want).abs().max() / want.abs().max())
    rel_l2 = float((got - want).norm() / want.norm())
    # bf16 rounds each layer's output to 2^-9 relative and the errors add
    # up along the residual stream, as for SD1.5's UNet (unet_full_width)
    tol = 5e-2
    emit(dict(phase="sdxl_unet_full_width", shape=[1, 4, lat, lat],
              max_rel_err=rel, rel_l2_err=rel_l2, tol=tol,
              finite=bool(torch.isfinite(got).all())))
    del ref, want
    torch.cuda.empty_cache()
    if not (torch.isfinite(got).all() and rel <= tol):
        raise AssertionError(f"SDXL UNet bf16 vs fp32: max relative error "
                             f"{rel} > {tol}")


def sdxl(dev, card, root: Path, res=SDXL_RES, steps=SDXL_STEPS,
         tall=SDXL_TALL, tall_steps=SDXL_TALL_STEPS, check_unet=True):
    """The phase sdxl (see the module docstring). -> (rows, {path: (K1
    shapes, K2 shapes)}, launches of the timed requests)."""
    import numpy as np
    import torch

    from cremage_tpu_torch.app.server import build_server
    from cremage_tpu_torch.io.png import encode_png

    cfgs = sdxl_configs()
    t0 = time.perf_counter()
    paths, truth, targets = write_sdxl_files(root, dev, cfgs)
    rows = [dict(phase="sdxl_files", seconds=time.perf_counter() - t0,
                 bytes={k: os.path.getsize(v) for k, v in paths.items()
                        if os.path.isfile(v)},
                 lora_modules=len(targets))]
    emit(rows[0])
    srv = build_server(["--config", paths["config"], "--port", "0"])
    srv.start()
    client = Client(f"http://127.0.0.1:{srv.port}")
    job = {"prompt": SDXL_PROMPT, "negative_prompt": NEGATIVE, "H": res,
           "W": res, "sampling_steps": steps, "sampler": "EulerEDMSampler",
           "discretization": "LegacyDDPMDiscretization", "scale": SDXL_CFG,
           "n_samples": SDXL_BATCH, "n_iter": 1, "safety_check": False,
           "watermark": False, "lora_models": paths["lora"],
           "lora_weights": str(LORA_WEIGHT)}
    finite = []
    shapes, runs = {}, {}

    def run(name, params, mode="text_to_image", record=False):
        """One job: -> (seconds, (K1, K2) launches, images, finite
        decodes)."""
        pipe = srv.worker._backends["SDXL"].resident.instance \
            if "SDXL" in srv.worker._backends else None
        finite.clear()
        reset_counts()
        with contextlib.ExitStack() as stack:
            if record:
                attn, gn, _ = stack.enter_context(recording(pipe.bundle))
                shapes[name] = (attn, gn)
            t1 = time.perf_counter()
            client.generate(mode, params, "SDXL")
            msgs = client.drain(1)
            wall = time.perf_counter() - t1
        return wall, read_counts(), served_images(msgs), list(finite)

    try:
        refused = expect_refused(client, dict(job, sampler="LCM"),
                                 "an unported sampler", "SDXL")
        # the first run loads the files, then pays its shapes' first-call
        # set-up (cuDNN, cuBLAS); 2 steps
        first_s = run("warm-up", dict(job, sampling_steps=2, seed=1))[0]
        bundle = srv.worker._backends["SDXL"].resident.instance.bundle
        hook = bundle.vae.decoder.register_forward_hook(
            lambda m, a, out: finite.append(bool(torch.isfinite(out).all())))
        reset_counts()
        t1 = time.perf_counter()
        for r in range(SDXL_REQUESTS):
            client.generate("text_to_image", dict(job, seed=10 + r), "SDXL")
        images = served_images(client.drain(SDXL_REQUESTS))
        wall = time.perf_counter() - t1
        launches = read_counts()
        decodes = list(finite)
        # the same job once more with the shape hooks on (they cost host
        # time, so the timed requests run without them)
        runs["sdxl 1024^2"] = run("sdxl 1024^2", dict(job, seed=12),
                                  record=True) + (steps, 0, 1)
        up = client.call("/v1/upload", {"image": base64.b64encode(
            encode_png(test_image(res)[0])).decode()})["path"]
        runs["sdxl img2img"] = run(
            "sdxl img2img", dict(job, seed=13, init_img=up, strength=STRENGTH),
            "image_to_image", record=True) + (
                max(1, int(STRENGTH * steps)), 1, 1)
        runs["sdxl 832x1216"] = run(
            "sdxl 832x1216", dict(job, seed=14, H=tall[0], W=tall[1],
                                  sampling_steps=tall_steps), record=True) + (
                tall_steps, 0, 1)
        hook.remove()
    finally:
        srv.stop()

    weights = check_groups("sdxl_weights", {
        "unet": bundle.unet, "clip": bundle.conditioner.clip_l,
        "openclip": bundle.conditioner.open_clip, "vae": bundle.vae},
        truth, targets)
    emit(weights)
    want = [SDXL_REQUESTS * k for k in kernel_calls(bundle, steps, 0, 1)]
    pixel_std = [float(np.std(p.astype(np.float32))) for p, _ in images]
    row = dict(phase="sdxl", card=card, steps=steps, batch=SDXL_BATCH,
               sampler=job["sampler"], cfg=SDXL_CFG, requests=SDXL_REQUESTS,
               seconds=wall, seconds_per_request=wall / SDXL_REQUESTS,
               images_per_s=len(images) / wall, first_run_seconds=first_s,
               load={k: dict(v, gb_per_s=v["bytes"] / max(v["seconds"], 1e-9)
                             / 1e9)
                     for k, v in bundle.load_report["files"].items()},
               lora=bundle.load_report["loras"],
               images=[list(p.shape) for p, _ in images], pixel_std=pixel_std,
               decodes_finite=decodes, refused=refused,
               flash_attention_launches=launches[0],
               group_norm_silu_launches=launches[1],
               expected_flash_attention=want[0],
               expected_group_norm_silu=want[1])
    emit(row)
    if len(images) != SDXL_REQUESTS * SDXL_BATCH or any(
            p.shape != (res, res, 3) for p, _ in images) or \
            len(decodes) != SDXL_REQUESTS or not all(decodes) or \
            min(pixel_std) <= 0.0:
        raise AssertionError(f"sdxl: images {row['images']}, finite decodes "
                             f"{decodes}, pixel std {pixel_std}")
    if any("<embedding:astro_xl.pt>" not in m["prompt"] for _, m in images):
        raise AssertionError("sdxl: generation_data of another job")
    if "NotImplementedError" not in (refused or ""):
        raise AssertionError(f"sdxl: LCM not refused: {refused}")
    if tuple(launches) != tuple(want):
        raise AssertionError(f"sdxl: kernel launches {launches} != derived "
                             f"{want}")
    rows += [weights, row]
    for name, (sec, (k1, k2), imgs, fin, evals, enc, dec) in runs.items():
        attn, gn = shapes[name]
        side = (tall if "832" in name else (res, res))
        want = kernel_calls(bundle, evals, enc, dec)
        r = dict(phase="sdxl_request", request=name, card=card, seconds=sec,
                 unet_evals=evals, images=[list(p.shape) for p, _ in imgs],
                 decodes_finite=fin,
                 pixel_std=[float(np.std(p.astype(np.float32)))
                            for p, _ in imgs],
                 flash_attention_launches=k1, group_norm_silu_launches=k2,
                 expected_flash_attention=want[0],
                 expected_group_norm_silu=want[1],
                 recorded_calls=[sum(attn.values()), sum(gn.values())])
        emit(r)
        if len(imgs) != 1 or imgs[0][0].shape != tuple(side) + (3,) or \
                min(r["pixel_std"]) <= 0.0 or fin != [True]:
            raise AssertionError(f"{name}: images {r['images']}")
        if not (k1, k2) == want == tuple(r["recorded_calls"]):
            raise AssertionError(f"{name}: kernel launches {(k1, k2)}, derived"
                                 f" {want}, recorded {r['recorded_calls']}")
        rows.append(r)
    if check_unet:
        check_unet_sdxl(bundle, dev)
    return rows, shapes, launches


def full_configs():
    """The published SD1.5 widths: UNet, CLIP-L, VAE, ControlNet (the
    UNet's encoder on 4 latent channels) and the CompVis safety checker,
    in bf16."""
    import torch

    from cremage_tpu_torch.models.clip import CLIPTextConfig
    from cremage_tpu_torch.models.safety_checker import SafetyCheckerConfig
    from cremage_tpu_torch.models.unet import sd15_unet_config
    from cremage_tpu_torch.models.vae import VAEConfig

    unet = sd15_unet_config(dtype=torch.bfloat16)
    return dict(unet=unet, clip=CLIPTextConfig(dtype=torch.bfloat16),
                vae=VAEConfig(dtype=torch.bfloat16), controlnet=unet,
                safety=SafetyCheckerConfig(dtype=torch.bfloat16))


def kernel_entry(name, source, replaces, rows, launches, path_launches):
    """Per-request totals over the main path's shapes (each shape's time
    times its calls per request), as earlier slices report them; the other
    paths' totals beside them (`new_paths`), and `launches_by_phase` the
    counts of the modes and samplers phases' runs."""
    def total(key, path):
        return sum(r[key] * r["calls_by_path"][path] for r in rows
                   if path in r["calls_by_path"])

    def on(path):
        return [r for r in rows if path in r["calls_by_path"]]

    main = on("main")
    paths = dict.fromkeys(p for r in rows for p in r["calls_by_path"])
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in main),
                ms=total("ms", "main"), dispatch_ms=total("dispatch_ms", "main"),
                plain_ms=total("plain_ms", "main"),
                bound_ms=total("bound_ms", "main"),
                bound_by="operations" if total("flops_ms", "main")
                > total("bytes_ms", "main") else "bytes",
                library_ms=total("library_ms", "main"),
                calls_per_request=sum(r["calls_by_path"]["main"] for r in main),
                shapes=len(main),
                launches_by_phase=path_launches,
                new_paths={p: dict(
                    shapes=len(on(p)),
                    max_abs_err=max(r["max_abs_err"] for r in on(p)),
                    max_err_over_tol=max(r["max_abs_err"] / r["tol"]
                                         for r in on(p)),
                    calls_per_request=sum(r["calls_by_path"][p] for r in on(p)),
                    **{k: total(k, p) for k in ("ms", "dispatch_ms", "plain_ms",
                                                "bound_ms", "library_ms")})
                    for p in paths if p != "main"})


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
    attn, gn = record_shapes(bundle, main_path_runs(bundle, dev))
    emit(dict(phase="shapes", bundle_s=time.perf_counter() - t0,
              flash_attention_shapes=len(attn), group_norm_shapes=len(gn),
              flash_attention_calls_per_request=sum(attn.values()),
              group_norm_calls_per_request=sum(gn.values())))
    k1_rows = check_flash({k: {"main": n} for k, n in attn.items()}, dev)
    watchdog("k2")
    k2_rows = check_groupnorm({k: {"main": n} for k, n in gn.items()}, dev)
    watchdog("unet")
    check_unet(bundle, dev)
    watchdog("serving")
    launches = serve(bundle, dev, card)
    watchdog("modes")
    inpaint_bundle = build_sd15_bundle(dev, dtype=torch.bfloat16, seed=1,
                                       inpaint=True)
    mode_rows, paths = modes(bundle, inpaint_bundle, dev, card)
    del inpaint_bundle
    torch.cuda.empty_cache()
    watchdog("samplers")
    sampler_rows, paths["samplers"] = samplers(bundle, dev, card)
    del bundle
    torch.cuda.empty_cache()
    watchdog("sd15_full")
    full_root = REPO / "build" / "sd15_full"
    try:
        _, full_paths, full_launches = sd15_full(dev, card, full_root)
    finally:
        shutil.rmtree(full_root, ignore_errors=True)
    paths.update(full_paths)
    torch.cuda.empty_cache()
    watchdog("sdxl")
    sdxl_root = REPO / "build" / "sdxl"
    try:
        _, sdxl_paths, sdxl_launches = sdxl(dev, card, sdxl_root)
    finally:
        shutil.rmtree(sdxl_root, ignore_errors=True)
    paths.update(sdxl_paths)
    paths["K2 any H*W"] = ({}, dict.fromkeys(K2_ANY_HW, 1))
    torch.cuda.empty_cache()
    watchdog("new_shapes")
    for path, (p_attn, p_gn) in paths.items():
        emit(dict(phase="shapes", path=path,
                  flash_attention_shapes=len(p_attn),
                  group_norm_shapes=len(p_gn),
                  flash_attention_calls_per_request=sum(p_attn.values()),
                  group_norm_calls_per_request=sum(p_gn.values())))
    new_k1, new_k2 = check_new_paths(paths, k1_rows, k2_rows, dev)
    faulthandler.cancel_dump_traceback_later()

    def by_phase(key):
        return {"modes": sum(r[key] for r in mode_rows),
                "samplers": sum(r[key] for r in sampler_rows),
                "sd15_full": full_launches[key.startswith("group")],
                "sdxl": sdxl_launches[key.startswith("group")]}

    emit({"kernels": [
        kernel_entry("flash_attention", "cremage_tpu_torch/csrc/flash_attention.cu",
                     "cremage_tpu/ops/flash_attention.py:94",
                     list(k1_rows.values()) + list(new_k1.values()),
                     launches["flash_attention"],
                     by_phase("flash_attention_launches")),
        kernel_entry("group_norm_silu", "cremage_tpu_torch/csrc/groupnorm.cu",
                     "cremage_tpu/ops/groupnorm.py:66",
                     list(k2_rows.values()) + list(new_k2.values()),
                     launches["group_norm_silu"],
                     by_phase("group_norm_silu_launches")),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
