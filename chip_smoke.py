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
   must equal the counts derived from the model code; then one request
   (DELIVERY_STEPS steps) inline and the same with result_delivery "path":
   GET /v1/images/file must return the inline PNG's bytes for each image
   and /v1/images/meta its parameters, a path outside the app root 404;
8. modes: the server with that bundle and a full-width 9-channel
   inpainting bundle answers one request of each: img2img from an
   uploaded 512^2 PNG (DPM++ 2M, strength 0.75, batch 2), inpainting with
   an uploaded mask (DDIM, batch 2), hires fix "Latent" x1.5 (Euler A,
   batch 2) and "Lanczos" x2 (Euler, batch 1), MODE_STEPS steps each, each
   sent twice (the first run pays the first-call set-up of its shapes and
   is timed apart); each request's launch counts must equal those derived
   from the model code and its sampler's evaluations, and the inpainted
   images keep the unmasked pixels of the input;
9. samplers: each of the 12 menu samplers and the 3 extra ones (PLMS, DPM
   Solver, LCM) runs SAMPLER_STEPS steps through the full-width UNet at
   64^2 latents, batch 1 with CFG; its launch counts must equal its
   evaluations times the UNet's calls;
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
   loads the files), then once more without the LoRA and with
   unet_quantize "float8_e4m3" (a new load). Checks: every weight on the
   card equals its file's (per tensor; checksums per group reported), the
   LoRA moved exactly its 264 modules, each by the expected delta within
   one bf16 ulp; each PNG's watermark decodes; each image's metadata
   carries its safety flag; the K1 / K2 launches equal the counts derived
   from the module tree (the ControlNet's calls in each of the 20
   evaluations at batch 8, the safety checker's 24 K1 calls per batch); a
   deny-listed prompt is refused; the float8_e4m3 UNet's 8-bit weights
   equal io/quantize.py's codes and scales of the file's tensors, the
   others the file's, and its request's images are non-constant with the
   same launches;
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
   bf16 ulp; an unported option (deep_cache) is refused; the images are finite,
   non-constant and of their size; each request's K1 / K2 launches equal
   the module tree's count and the recorded shapes' sum; one full-width
   SDXL UNet eval in bf16 against fp32 through the plain versions, on the
   card;
12. sdxl_modes: SDXL as users run it, beside sdxl's base files: a refiner
   in sd_xl_refiner_1.0's layout (UNet, bigG under
   conditioner.embedders.0.model., its own VAE keys; 6.1 GB of fp16)
   and a 9-channel inpainting checkpoint in the sgm layout (6.9 GB). The
   --config server serves, with the base model, its LoRA and the refiner:
   a warm-up (the load), bench_sdxl's job with the refiner at
   refiner_strength 0.3 twice (timed), once more with the shape hooks,
   LCM at 1024^2 (LCM_STEPS steps) and inpainting on the base model
   (INPAINT_STEPS steps, a centred-square mask), each once timed and once
   with the hooks; a second --config server whose config names the
   inpainting model serves inpainting with the 9-channel UNet the same
   way. Checks: the refiner's and the inpainting model's weights equal
   their files' (the LoRA leaves the refiner alone); images finite,
   non-constant, of their size, the unmasked pixels kept; each request's
   K1 / K2 launches equal the module tree's count (the refiner's 88 / 56
   per evaluation) and the recorded shapes' sum; the refiner UNet in bf16
   against fp32 through the plain versions, on the card;
13. flux: FLUX.1-schnell as the JAX package benchmarks it (bench_flux:
   1024^2, 4 flow-Euler steps, batch 1, the transformer and T5 in
   fp8-e4m3; the T5 context at the conditioner's 256 tokens), from
   seeded random bf16 files at full width and depth under build/flux/
   (34 GB; refused without the free disk): the BFL transformer (19
   double and 38 single blocks, hidden 3072, 24 heads of 128), HF's
   T5-XXL encoder, BFL's ae.safetensors (no quant convs), HF's CLIP-L and
   a synthetic spiece.model. The --config server serves with
   generator_model_type "FLUX.1-schnell": with flux_quantize
   "float8_e4m3" a warm-up (the load), the job twice (timed), once more
   with the shape hooks; with "none" (bf16) and "int8" a load and one
   timed request each. The server passes no T5 tokenizer, as the JAX
   backend does, so its T5 context is zeros; T5-XXL then runs once at
   full width through `load_flux_bundle(t5_tokenize=<a callable>)` and
   one FluxPipeline request. Checks: every weight equals its file's, or
   its 8-bit codes and scale equal io/quantize.py's of the file's
   tensor; deep_cache is refused; images finite, non-constant, 1024^2;
   the K1 / K2 launches equal the module tree's count (one K1 call per
   block a step, the decoder's attention and GroupNorms) and the
   recorded shapes' sum; the served T5 context zeros, the T5 run's
   finite and not zeros; the full-width transformer's velocity in fp8
   and int8 against bf16's, and one double and one single block in bf16
   (K1) against fp32 (the plain versions), on the card;
14. svd: SVD img2vid as the JAX package benchmarks it (bench_svd: 14
   frames at 576x1024, 25 EulerEDMSampler steps over EDM sigmas (0.002,
   700, rho 7), the LinearPredictionGuider from 1.0 to 2.5 over [uc; c],
   so the video UNet runs at batch 28; one VAE decode per frame), from one
   seeded random fp16 file at full width and depth under build/svd/
   (4.5 GB): the video UNet (1.5 B parameters), the image VAE and the
   ViT-H/14 image tower as published (the temporal convolutions OIDHW,
   the tower's attention input projection fused), with keys of the
   families the loader drops (the VideoDecoder's temporal layers, the
   conditioner's other keys). The --config server (svd_model_path)
   serves with generator_model_type "SVD", on an uploaded 576x1024
   image: a warm-up of 2 steps (the load), the job twice (timed: seconds
   a request and frames/s), once more with the shape hooks, and with
   unet_quantize "float8_e4m3" a 2-step warm-up (a new load) and the job
   once. Checks: every weight equals
   its file's, or its 8-bit codes and scale io/quantize.py's of the
   file's tensor; interpolation_frames (FILM) is refused; 14 finite,
   non-constant 576x1024 frames a request; the K1 / K2 launches equal the
   module tree's count (48 K1 a UNet evaluation: each of the 16 spatial
   video transformers' spatial self- and cross-attention and its temporal
   block's cross-attention over one key; the VAE's and the tower's) and
   the recorded shapes' sum; the full-width video UNet over one CFG half
   (14 frames) in bf16 against fp32 through the plain versions, on the
   card;
15. sd3: SD3-medium at its published settings (1024^2, 28 flow-Euler
   steps over the shift-3 sigmas, CFG 7.0 over [uc; c], batch 1), from
   one seeded random fp16 file at full width and depth under build/sd3/
   (5.9 GB, sd3_medium_incl_clips' layout: the MMDiT (24 joint blocks,
   hidden 1536, 24 heads of 64), the 16-channel VAE without quant convs,
   CLIP-L and bigG in HF's layout, CLIP-L's projection, which the loader
   drops). The --config server (sd3_ldm_model_path / sd3_ldm_model)
   serves with generator_model_type "SD 3": a 2-step warm-up (the load),
   the job twice (timed), once more with the shape hooks, then with
   dit_quantize "float8_e4m3" and "int8" a warm-up (a new load) and one
   timed request each. The file has no T5, so the T5 context is zeros,
   as the served JAX request's. Checks: every weight equals its file's,
   or its 8-bit codes and scale io/quantize.py's of the file's tensor
   (int8: the patch embedding's too, whose GEMM on the card matches its
   CPU branch on the same codes); deep_cache is refused; images finite,
   non-constant, 1024^2; the K1 / K2 launches equal the module tree's
   count (one joint attention over [154; 4096] tokens per block a step,
   the decoder's attention and GroupNorms) and the recorded shapes' sum;
   the first and the last joint block in bf16 (K1) against fp32 (the
   plain versions), on the card;
16. pixart: PixArt-Σ XL at diffusers' PixArtSigmaPipeline defaults
   (1024^2, 20 steps of "DPM++ 2M", CFG 4.5, batch 1), from seeded random
   fp16 files under build/pixart/: the transformer in diffusers' layout
   (28 blocks, hidden 1152, 16 heads of 72) and the SD VAE as a
   standalone file. The --config server (pixart_sigma_ldm_model_path /
   pixart_sigma_ldm_model, the job's vae_ckpt) serves with
   generator_model_type "PixArt-Sigma" as sd3 does, with dit_quantize
   "float8_e4m3" after the bf16 requests. The caption is zeros of (120,
   4096), as in JAX (no T5). The same checks, with two K1 calls per block
   a step (self-attention, cross-attention over the 120 caption tokens);
17. hunyuan: Hunyuan-DiT v1.2 at 1024^2, 25 steps of "DPM++ 2M" (the
   served default), CFG 5.0, batch 1 (the DiT at batch 2), from seeded
   random fp16 component files under build/hunyuan/ as a hunyuan_dir
   holds them (7.3 GB): the transformer in diffusers' HunyuanDiT2DModel
   layout (40 blocks of 1408, 16 heads of 88), the SDXL VAE in diffusers'
   AutoencoderKL layout, the Chinese-CLIP BertModel in HF's layout with a
   47,020-line vocab.txt, the mT5-XL encoder in HF's T5EncoderModel layout
   and a synthetic spiece.model, so both text branches run. The --config
   server serves jobs naming hunyuan_dir as sd3 does, in bf16, then with
   dit_quantize "float8_e4m3" and "int8". The same checks, with two K1
   calls per block a step at d = 88 (self-attention over 4096 tokens,
   cross-attention over the 333 text tokens) and one at d = 256 (the
   attention pool, one query over 257 mT5 tokens), counted by
   instantiation; both text contexts finite and not zeros; the int8 patch
   embedding left in bf16 (below the min size);
18. kandinsky: Kandinsky 2.2 at 768^2, 50 decoder steps of the served
   default ("DDIM" -> Euler A), the prior's 25 Euler A steps, CFG 4.0,
   batch 1 (the decoder at batch 2), from seeded random fp16 component
   files under build/kandinsky/ as a kandinsky_dir holds them (6.6 GB):
   the prior in diffusers' PriorTransformer layout (20 layers of 2048
   over 81 tokens, with clip_mean and clip_std), the decoder UNet in
   diffusers' layout ((384, 768, 1152, 1536), 3 layers a block, 64-wide
   heads, its image heads), the bigG text tower in HF's layout and MoVQ
   in diffusers' VQModel layout (the decoder, post_quant_conv, the
   codebook, an encoder and quant_conv the loader drops by name). The
   --config server serves jobs naming kandinsky_dir: a 2-step warm-up (the
   load), the job twice (timed), once more with the shape hooks, once
   traced by torch.profiler (the idle share), and one inpainting request
   on an uploaded image and mask. Checks: every weight and clip_mean /
   clip_std equal their files'; deep_cache and img2img refused; images
   finite, non-constant, 768^2, the inpainted one keeping the unmasked
   pixels; the K1 / K2 launches equal the module tree's count (22 K1 calls
   an evaluation over [10 context; spatial] keys at d = 64, MoVQ's d = 512
   over 9216 tokens) and the recorded shapes' sum; one full-width decoder
   evaluation in bf16 against fp32 through the plain versions, on the
   card;
19. new paths' shapes: hooks record the shape of every K1 and K2 call of
   the checked run of each modes request, of the samplers phase, of
   sd15_full, of sdxl's and sdxl_modes' requests, of flux's, svd's, sd3's,
   pixart's, hunyuan's and kandinsky's (the recorded calls
   must add up to the launch counts), and the same checks as 4 and 5 run
   at every shape the main path's rows do not hold (the safety checker's
   d = 64 at batch 4 and 1, SDXL's d = 64 at 10 and 20 heads and the
   refiner's at 12 and 24 among them, FLUX's d = 128, SVD's batch-28
   calls over 9216 tokens and over one key, SD3's 4250 keys, PixArt's
   d = 72, Hunyuan-DiT's d = 88 and its pool's d = 256 at one q row,
   Kandinsky's Nk = Nq + 10 at d = 64 and its 36- and 48-channel groups),
   and at K2's H*W % 8 != 0 cases
   (K2_ANY_HW); each row lists the paths that run its shape with their
   calls per request;
20. the kernels line (per-request totals over the main path's shapes, as
   before, and per new path; K1's dp = 96 and dp = 256 instantiations in
   entries of their own, per Hunyuan-DiT request), then the contract's
   last line.
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
# path delivery's check: one request inline and once more by path
DELIVERY_STEPS = 4
# each phase's time limit, in s. A hang, say a kernel waiting on a wrong
# barrier phase, ends the run in its phase with a traceback and exit code
# 1 instead of using up the call. The K1 limit starts with the shapes
# phase: its model evals are K1's first launches.
LIMITS_S = dict(build=300, shapes_and_k1=180, k2=120, unet=180,
                serving=300, modes=300, samplers=300, sd15_full=480,
                sdxl=600, sdxl_modes=720, flux=900, svd=600, sd3=420,
                pixart=300, hunyuan=480, kandinsky=420, new_shapes=600)
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


def time_device(fn, reps: int, warmup: int = 3, tries: int = 8):
    """(device ms, dispatch ms) per call. The timed launches are enqueued
    behind a GPU-side sleep (`torch.cuda._sleep`) that outlasts their
    dispatch, so the events bracket the kernels back to back and not the
    host; the start event still pending after the enqueue shows that the
    sleep covered it (else the sleep doubles and it is timed again, up to
    `tries` times). Dispatch ms is `time_ms`'s host-inclusive time."""
    import torch

    dispatch = time_ms(fn, reps, warmup)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host_s = dispatch * reps / 1e3
    for _ in range(tries):
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


def time_plain(fn):
    """The plain version's device ms per call, and how it was timed: behind
    the GPU sleep ("device"), or, where the enqueue of a call outlasts
    three doublings of the sleep (a call over many head groups, whose
    allocations wait on the card: K1's at (28, 9216, 9216, 5, 64) runs 56
    of them), by events around two back-to-back calls ("host-inclusive";
    the card's work, hundreds of ms a call, outweighs the dispatch)."""
    try:
        return time_device(fn, 3, 1, tries=3)[0], "device"
    except RuntimeError:
        return time_ms(fn, 2, 1), "host-inclusive"


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
    UNets, VAEs, ControlNets and SVD's image tower, a FLUX, SD3, PixArt
    or Hunyuan-DiT bundle's transformer and VAE, or a Kandinsky bundle's
    decoder UNet and MoVQ; or modules, such as the safety checker)
    by shape: yields (attn, gn, weight), where each call adds weight["n"]
    (1 unless the caller sets it) to its shape's count."""
    from cremage_tpu_torch.models.clip import CLIPAttention
    from cremage_tpu_torch.models.flux import DoubleBlock, SingleBlock
    from cremage_tpu_torch.models.hunyuan import AttentionPool, HunyuanBlock
    from cremage_tpu_torch.models.kandinsky_decoder import AddedKVAttention
    from cremage_tpu_torch.models.layers import GroupNorm
    from cremage_tpu_torch.models.mmdit import JointBlock
    from cremage_tpu_torch.models.open_clip import _Attention
    from cremage_tpu_torch.models.pixart import PixArtBlock
    from cremage_tpu_torch.models.unet import CrossAttention
    from cremage_tpu_torch.models.vae import AttnBlock
    from cremage_tpu_torch.models.vq import MoVQAttention

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

    def on_clip(mod, args):        # unmasked (the safety checker's, the
        x, mask = args             # SVD image tower's): K1
        if mask is None:
            b, n, c = x.shape
            add(attn, (b, n, n, mod.heads, c // mod.heads))

    def on_flux(mod, args):        # joint attention over [txt; img]: K1
        n = sum(a.shape[1] for a in args[:2 if isinstance(mod, DoubleBlock)
                                         else 1])
        add(attn, (args[0].shape[0], n, n, mod.cfg.num_heads, mod.cfg.head_dim))

    def on_joint(mod, args):       # SD3: one K1 call over [ctx; x]
        ctx, x = args[:2]
        n = ctx.shape[1] + x.shape[1]
        cfg = mod.cfg
        add(attn, (x.shape[0], n, n, cfg.num_heads,
                   cfg.hidden_size // cfg.num_heads))

    def on_pixart(mod, args):      # PixArt, Hunyuan: self- and cross-attn
        x, y = args[:2]
        b, n = x.shape[:2]
        cfg = mod.cfg
        h, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        add(attn, (b, n, n, h, d))
        add(attn, (b, n, y.shape[1], h, d))

    def on_added_kv(mod, args):    # Kandinsky's decoder: [ctx; x] keys
        x, ctx = args[:2]
        b, c, h, w = x.shape
        add(attn, (b, h * w, h * w + ctx.shape[1], mod.heads, c // mod.heads))

    def on_pool(mod, args):        # Hunyuan-DiT's pool: one query row
        b, lm, w = args[0].shape
        ph = mod.cfg.pooler_heads
        add(attn, (b, 1, lm + 1, ph, w // ph))

    hooks = []
    for model in models:
        if hasattr(model, "unet"):
            parts = [model.unet, model.vae, getattr(model, "controlnet", None),
                     getattr(model, "clip_vision", None)]
        elif hasattr(model, "vae"):        # a FLUX, SD3, PixArt or Hunyuan one
            parts = [getattr(model, a, None) for a in ("model", "mmdit", "dit")
                     ] + [model.vae]
        elif hasattr(model, "movq"):       # a Kandinsky one
            parts = [model.decoder, model.movq]
        else:
            parts = [model]
        for m in (m for part in parts if part is not None
                  for m in part.modules()):
            if isinstance(m, CrossAttention):
                hooks.append(m.register_forward_pre_hook(on_cross))
            elif isinstance(m, (AttnBlock, MoVQAttention)):
                hooks.append(m.register_forward_pre_hook(on_vae_attn))
            elif isinstance(m, AddedKVAttention):
                hooks.append(m.register_forward_pre_hook(on_added_kv))
            elif isinstance(m, GroupNorm):
                hooks.append(m.register_forward_pre_hook(on_gn))
            elif isinstance(m, (CLIPAttention, _Attention)):
                hooks.append(m.register_forward_pre_hook(on_clip))
            elif isinstance(m, (DoubleBlock, SingleBlock)):
                hooks.append(m.register_forward_pre_hook(on_flux))
            elif isinstance(m, JointBlock):
                hooks.append(m.register_forward_pre_hook(on_joint))
            elif isinstance(m, (PixArtBlock, HunyuanBlock)):
                hooks.append(m.register_forward_pre_hook(on_pixart))
            elif isinstance(m, AttentionPool):
                hooks.append(m.register_forward_pre_hook(on_pool))
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
        plain_ms, plain_timing = time_plain(
            lambda: flash_attention_reference(q, k, v))
        row = dict(
            phase="flash_attention", shape=[b, nq, nk, h, d],
            instantiation=plan.instantiation,
            calls_by_path=calls, max_abs_err=err, tol=tol,
            ms=ms, dispatch_ms=dispatch_ms,
            plain_ms=plain_ms, plain_timing=plain_timing,
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


# UNet evaluations of each sampler over n steps: the two-stage ones
# evaluate twice a step but at the last (plain Euler to sigma 0); DDIM
# runs one step per timestep of range(0, 1000, 1000 // n), PLMS those and
# one more (its first step's trial evaluation); DPM Solver's last
# transition and LCM's steps take one evaluation each
TWO_STAGE = ("Heun", "DPM2", "DPM2 A", "DPM++ 2S A", "DPM++ SDE")


def sampler_evals(name: str, n: int) -> int:
    if name in ("DDIM", "PLMS"):
        return len(range(0, 1000, 1000 // n)) + (name == "PLMS")
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

    def raw(self, path: str):
        """GET `path` -> (status, body bytes, content type); an HTTP error
        status is returned, not raised."""
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(self.url + path, timeout=60) as r:
                return r.status, r.read(), r.headers["Content-Type"]
        except urllib.error.HTTPError as e:
            return e.code, e.read(), e.headers["Content-Type"]

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
    flash_attention.launches_by_dp = {}
    group_norm_silu.launches = 0


def read_counts():
    from cremage_tpu_torch.ops.flash_attention import flash_attention
    from cremage_tpu_torch.ops.groupnorm import group_norm_silu

    return flash_attention.launches, group_norm_silu.launches


def read_dp_counts() -> dict:
    """K1's launches by instantiation (padded head dim) since reset_counts."""
    from cremage_tpu_torch.ops.flash_attention import flash_attention

    return dict(flash_attention.launches_by_dp)


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
        hook.remove()                     # the timed requests' decodes only
        delivery = path_delivery(client, params(7, DELIVERY_STEPS))
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
              path_delivery=delivery,
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


def path_delivery(client, params):
    """The same SD1.5 request inline and with result_delivery "path": each
    delivered file under the app root's outputs, GET /v1/images/file
    returns the inline PNG's bytes as image/png, /v1/images/meta its
    generation parameters; a path outside the root is 404. The files are
    removed. -> a row."""
    from urllib.parse import quote

    from cremage_tpu_torch.app import dirs

    client.generate("text_to_image", params)
    inline = [base64.b64decode(m["image_b64"]) for m in client.drain(1)
              if isinstance(m, dict) and "image_b64" in m]
    client.generate("text_to_image", dict(params, result_delivery="path"))
    sent = [m for m in client.drain(1)
            if isinstance(m, dict) and "image_path" in m]
    outputs = os.path.join(os.path.realpath(dirs.app_root()), "outputs")
    row = dict(images=len(sent), outputs=outputs, same_bytes=[], meta=[])
    try:
        if len(sent) != len(inline) or not inline:
            raise AssertionError(f"path delivery: {len(sent)} paths, "
                                 f"{len(inline)} inline images")
        for m, png in zip(sent, inline):
            if os.path.dirname(os.path.realpath(m["image_path"])) != outputs:
                raise AssertionError(f"path delivery: {m['image_path']} is "
                                     f"not under {outputs}")
            q = quote(m["image_path"])
            status, body, ctype = client.raw(f"/v1/images/file?path={q}")
            row["same_bytes"].append(status == 200 and body == png
                                     and ctype == "image/png")
            row["meta"].append(client.call(f"/v1/images/meta?path={q}") == {
                "generation_data": json.loads(m["generation_parameters"])})
        row["outside_root"] = client.raw(
            f"/v1/images/file?path={quote(str(REPO / 'chip_smoke.py'))}")[0]
    finally:
        for m in sent:
            os.remove(m["image_path"])
    if not (all(row["same_bytes"]) and all(row["meta"])
            and row["outside_root"] == 404):
        raise AssertionError(f"path delivery: {row}")
    return row


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
    """Each menu sampler and each extra one for `steps` steps through the
    UNet at batch 1 with CFG; its latents finite, its launches its
    evaluations' worth. -> (rows, (K1 shapes, K2 shapes)), each a shape ->
    calls over the 15 runs."""
    import torch

    from cremage_tpu_torch.core.config import GenerationOptions
    from cremage_tpu_torch.core.rng import GeneratorNoise
    from cremage_tpu_torch.pipelines.sd15 import (
        EXTRA_SAMPLERS, SAMPLER_MENU, SD15Pipeline,
    )

    pipe = SD15Pipeline(bundle, device=dev)
    rows, attn, gn = [], {}, {}
    for i, name in enumerate(SAMPLER_MENU + EXTRA_SAMPLERS):
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
        # unet_quantize: a new load with the UNet's linear weights in
        # float8_e4m3, coded from the file's tensors as they load (no LoRA)
        reset_counts()
        t1 = time.perf_counter()
        client.generate("text_to_image", dict(
            {k: v for k, v in params.items() if not k.startswith("lora_")},
            seed=502, unet_quantize="float8_e4m3"))
        q_images = served_images(client.drain(1))
        q_wall = time.perf_counter() - t1
        q_counts = read_counts()
        q_bundle = srv.worker._backends["SD 1.5"].resident.instance.bundle
    finally:
        srv.stop()
        if old_env is None:
            os.environ.pop("SAFETY_CHECKER_PATH", None)
        else:
            os.environ["SAFETY_CHECKER_PATH"] = old_env

    weights = check_weights(bundle, safety.classifier.model, truth, cfgs["unet"])
    emit(weights)
    q_weights = check_coded("sd15_full_fp8_weights", "float8_e4m3",
                            {"unet": (q_bundle.unet, truth["unet"])})
    emit(q_weights)
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
               recorded_calls=[sum(attn.values()), sum(gn.values())],
               fp8=dict(seconds_with_load=q_wall,
                        quantize=q_bundle.load_report["quantize"],
                        images=[list(p.shape) for p, _ in q_images],
                        pixel_std=[float(np.std(p.astype(np.float32)))
                                   for p, _ in q_images],
                        flash_attention_launches=q_counts[0],
                        group_norm_silu_launches=q_counts[1]))
    emit(row)
    if len(images) != batch or any(p.shape != (res, res, 3) for p, _ in images):
        raise AssertionError(f"sd15_full: images {row['images']}")
    if len(q_images) != batch or min(row["fp8"]["pixel_std"]) <= 0.0 or \
            not q_weights["groups"]["unet"]["eight_bit"] or \
            tuple(q_counts) != (want_k1, want_k2):
        raise AssertionError(f"sd15_full: the float8_e4m3 request: {row['fp8']}")
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
    return rows + [weights, q_weights, row], shapes, (k1, k2)


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
    """The published SDXL base and refiner widths and depths, in bf16."""
    import torch

    from cremage_tpu_torch.models.clip import CLIPTextConfig
    from cremage_tpu_torch.models.open_clip import openclip_bigg_config
    from cremage_tpu_torch.models.unet import (
        sdxl_base_unet_config, sdxl_refiner_unet_config,
    )
    from cremage_tpu_torch.models.vae import sdxl_vae_config

    bf16 = torch.bfloat16
    return dict(unet=sdxl_base_unet_config(dtype=bf16),
                clip=CLIPTextConfig(dtype=bf16),
                openclip=openclip_bigg_config(dtype=bf16),
                vae=sdxl_vae_config(dtype=bf16),
                refiner=sdxl_refiner_unet_config(dtype=bf16))


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


def check_unet_sdxl(unet, dev, phase="sdxl_unet_full_width"):
    """A full-width SDXL UNet (the base's or the refiner's) at a 1024^2
    latent in bf16 through the kernels against the same weights in fp32
    through the plain versions, both on the card."""
    import torch

    from cremage_tpu_torch.models.unet import UNetModel

    cfg = unet.cfg
    with torch.device("meta"):
        ref = UNetModel(dataclasses.replace(cfg, dtype=torch.float32))
    ref.load_state_dict({k: v.float() for k, v in
                         unet.state_dict().items()}, assign=True)
    g = torch.Generator(device=dev).manual_seed(26)
    lat = SDXL_RES // 8
    x = torch.randn(1, 4, lat, lat, device=dev, generator=g)
    t = torch.tensor([500.0], device=dev)
    ctx = torch.randn(1, 77, cfg.context_dim, device=dev, generator=g)
    y = torch.randn(1, cfg.adm_in_channels, device=dev, generator=g)
    with torch.no_grad():
        got = unet(x, t, ctx, y=y).float()
        with plain_kernels():
            want = ref.eval()(x, t, ctx, y=y)
    rel = float((got - want).abs().max() / want.abs().max())
    rel_l2 = float((got - want).norm() / want.norm())
    # bf16 rounds each layer's output to 2^-9 relative and the errors add
    # up along the residual stream, as for SD1.5's UNet (unet_full_width)
    tol = 5e-2
    emit(dict(phase=phase, shape=[1, 4, lat, lat],
              max_rel_err=rel, rel_l2_err=rel_l2, tol=tol,
              finite=bool(torch.isfinite(got).all())))
    del ref, want
    torch.cuda.empty_cache()
    if not (torch.isfinite(got).all() and rel <= tol):
        raise AssertionError(f"{phase}: max relative error {rel} > {tol}")


def sdxl_job(client, params, mode="text_to_image", record=()):
    """One SDXL job through `client`, with the shape hooks on the models
    of `record` if any: -> (seconds, (K1, K2) launches, images, (K1
    shapes, K2 shapes) or None)."""
    reset_counts()
    with contextlib.ExitStack() as stack:
        rec = stack.enter_context(recording(*record)) if record else None
        t1 = time.perf_counter()
        client.generate(mode, params, "SDXL")
        msgs = client.drain(1)
        wall = time.perf_counter() - t1
    return wall, read_counts(), served_images(msgs), rec and rec[:2]


def sdxl(dev, card, root: Path, res=SDXL_RES, steps=SDXL_STEPS,
         tall=SDXL_TALL, tall_steps=SDXL_TALL_STEPS, check_unet=True):
    """The phase sdxl (see the module docstring). -> (rows, {path: (K1
    shapes, K2 shapes)}, launches of the timed requests, the files)."""
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
        finite.clear()
        wall, counts, images, rec = sdxl_job(client, params, mode, (
            srv.worker._backends["SDXL"].resident.instance.bundle,)
            if record else ())
        if record:
            shapes[name] = rec
        return wall, counts, images, list(finite)

    try:
        refused = expect_refused(client, dict(job, deep_cache=3),
                                 "an unported option", "SDXL")
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
        raise AssertionError(f"sdxl: deep_cache not refused: {refused}")
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
        check_unet_sdxl(bundle.unet, dev)
    return rows, shapes, launches, paths


# sdxl_modes: the refiner at bench_sdxl's job, inpainting and LCM at 1024^2
SDXL_REFINER_STRENGTH, SDXL_INPAINT_STEPS, SDXL_LCM_STEPS = 0.3, 8, 4


def write_sdxl_modes_files(root: Path, dev, cfgs: dict, base: dict):
    """Seeded random fp16 files beside sdxl's (`base`, its paths): a
    refiner in sd_xl_refiner_1.0's layout (UNet, bigG under
    conditioner.embedders.0.model. with its attention input projection
    fused and its logit_scale, and a VAE of its own, which the pipeline
    never reads), a 9-channel inpainting checkpoint in the sgm layout and a
    config.yaml naming it beside the base model. -> (paths, truth), truth
    keyed by the groups check_groups holds."""
    import torch

    from cremage_tpu_torch.io import checkpoint as CK
    from cremage_tpu_torch.models.clip import CLIPTextModel
    from cremage_tpu_torch.models.open_clip import OpenCLIPTextModel
    from cremage_tpu_torch.models.unet import UNetModel
    from cremage_tpu_torch.models.vae import AutoencoderKL

    def host(sd):
        return {k: v.half().cpu() for k, v in sd.items()}

    paths = {k: root / n for k, n in (
        ("refiner", "sdxl_refiner.safetensors"),
        ("inpaint", "sdxl_inpaint.safetensors"),
        ("config_inpaint", "config_inpaint.yaml"))}
    truth = {"lora": {},
             "refiner_unet": host(seeded_state(UNetModel, cfgs["refiner"],
                                               dev, 30)),
             "refiner_openclip": host(seeded_state(
                 OpenCLIPTextModel, cfgs["openclip"], dev, 31))}
    ckpt = {}
    for prefix, sd in (
            (CK.PREFIX_UNET, truth["refiner_unet"]),
            (CK.PREFIX_OPENCLIP_REFINER,
             fused_openclip(truth["refiner_openclip"])),
            (CK.PREFIX_VAE, host(seeded_state(AutoencoderKL, cfgs["vae"],
                                              dev, 32)))):
        ckpt.update({prefix + k: v for k, v in sd.items()})
    ckpt[CK.PREFIX_OPENCLIP_REFINER + "logit_scale"] = torch.tensor(4.6052)
    CK.save_safetensors(str(paths["refiner"]), ckpt)
    ckpt = {}
    inpaint_cfg = dataclasses.replace(cfgs["unet"], in_channels=9)
    for (group, cls, cfg, seed), prefix in zip(
            (("inpaint_unet", UNetModel, inpaint_cfg, 33),
             ("inpaint_vae", AutoencoderKL, cfgs["vae"], 34),
             ("inpaint_clip", CLIPTextModel, cfgs["clip"], 35),
             ("inpaint_openclip", OpenCLIPTextModel, cfgs["openclip"], 36)),
            (CK.PREFIX_UNET, CK.PREFIX_VAE, CK.PREFIX_CLIP_SDXL,
             CK.PREFIX_OPENCLIP_SDXL)):
        truth[group] = host(seeded_state(cls, cfg, dev, seed))
        sd = truth[group]
        if cls is OpenCLIPTextModel:
            sd = fused_openclip(sd)
        ckpt.update({prefix + k: v for k, v in sd.items()})
    ckpt[CK.PREFIX_CLIP_SDXL + CK.POSITION_IDS] = torch.arange(77)[None]
    ckpt[CK.PREFIX_OPENCLIP_SDXL + "logit_scale"] = torch.tensor(4.6052)
    CK.save_safetensors(str(paths["inpaint"]), ckpt)
    del ckpt
    paths["config_inpaint"].write_text(
        Path(base["config"]).read_text()
        + f"sdxl_ldm_inpaint_model: '{paths['inpaint'].name}'\n")
    return {k: str(v) for k, v in paths.items()}, truth


def sdxl_modes(dev, card, root: Path, base: dict, res=SDXL_RES,
               steps=SDXL_STEPS, inpaint_steps=SDXL_INPAINT_STEPS,
               lcm_steps=SDXL_LCM_STEPS, check_unet=True):
    """The phase sdxl_modes (see the module docstring), beside sdxl's files
    `base`. -> (rows, {path: (K1 shapes, K2 shapes)}, launches of the timed
    refiner requests)."""
    import numpy as np
    import torch

    from cremage_tpu_torch.app.server import build_server
    from cremage_tpu_torch.io.png import encode_png
    from cremage_tpu_torch.models.layers import GroupNorm
    from cremage_tpu_torch.models.unet import CrossAttention

    cfgs = sdxl_configs()
    t0 = time.perf_counter()
    paths, truth = write_sdxl_modes_files(root, dev, cfgs, base)
    rows = [dict(phase="sdxl_modes_files", seconds=time.perf_counter() - t0,
                 bytes={k: os.path.getsize(v) for k, v in paths.items()})]
    emit(rows[0])
    init, mask = test_image(res)
    # bench_sdxl's job with sdxl's LoRA and the refiner loaded (at strength
    # 0 a job runs no refiner pass: LCM and inpainting keep the resident
    # bundle)
    job = {"prompt": SDXL_PROMPT, "negative_prompt": NEGATIVE, "H": res,
           "W": res, "sampling_steps": steps, "sampler": "EulerEDMSampler",
           "discretization": "LegacyDDPMDiscretization", "scale": SDXL_CFG,
           "n_samples": SDXL_BATCH, "n_iter": 1, "safety_check": False,
           "watermark": False, "lora_models": base["lora"],
           "lora_weights": str(LORA_WEIGHT), "refiner_ckpt": paths["refiner"],
           "refiner_strength": 0.0}
    refine = dict(refiner_strength=SDXL_REFINER_STRENGTH)
    t_refine = max(1, int(SDXL_REFINER_STRENGTH * steps))
    t_inpaint = max(1, int(STRENGTH * inpaint_steps))
    finite, shapes, runs = [], {}, {}

    def serve(config):
        srv = build_server(["--config", config, "--port", "0"])
        srv.start()
        client = Client(f"http://127.0.0.1:{srv.port}")
        up = {k: client.call("/v1/upload", {"image": base64.b64encode(
            encode_png(a)).decode()})["path"]
            for k, a in (("init_img", init), ("mask_img", mask))}
        return srv, client, up

    def resident(srv):
        return srv.worker._backends["SDXL"].resident.instance.bundle

    def timed_and_hooked(client, name, params, mode, bundle, counts):
        """The request once timed, once with the shape hooks."""
        sec = sdxl_job(client, params, mode)[0]
        finite.clear()
        run = sdxl_job(client, dict(params, seed=params["seed"] + 1), mode,
                       (bundle, bundle.refiner_unet) if bundle.refiner_unet
                       is not None else (bundle,))
        shapes[name] = run[3]
        runs[name] = (sec,) + run[1:3] + (list(finite), mode, counts)

    srv, client, up = serve(base["config"])
    try:
        # the first run loads the base model, its LoRA and the refiner
        first_s = sdxl_job(client, dict(job, sampling_steps=2, seed=1,
                                        **refine))[0]
        bundle = resident(srv)
        hook = bundle.vae.decoder.register_forward_hook(
            lambda m, a, out: finite.append(bool(torch.isfinite(out).all())))
        finite.clear()
        reset_counts()
        t1 = time.perf_counter()
        for r in range(SDXL_REQUESTS):
            client.generate("text_to_image", dict(job, seed=30 + r, **refine),
                            "SDXL")
        images = served_images(client.drain(SDXL_REQUESTS))
        wall = time.perf_counter() - t1
        launches = read_counts()
        decodes = list(finite)
        finite.clear()
        run = sdxl_job(client, dict(job, seed=32, **refine), record=(
            bundle, bundle.refiner_unet))
        shapes["sdxl refiner"] = run[3]
        runs["sdxl refiner"] = (wall / SDXL_REQUESTS,) + run[1:3] + (
            list(finite), "text_to_image", (steps, t_refine, 0, 1))
        timed_and_hooked(client, "sdxl LCM",
                         dict(job, seed=40, sampler="LCM",
                              sampling_steps=lcm_steps),
                         "text_to_image", bundle, (lcm_steps, 0, 0, 1))
        timed_and_hooked(client, "sdxl inpainting base",
                         dict(job, seed=50, sampling_steps=inpaint_steps,
                              strength=STRENGTH, **up),
                         "inpainting", bundle, (t_inpaint, 0, 1, 1))
        hook.remove()
    finally:
        srv.stop()
    # the 9-channel inpainting model, from the config that names it
    srv, client, up = serve(paths["config_inpaint"])
    try:
        ip9 = {k: v for k, v in job.items()
               if k not in ("lora_models", "lora_weights", "refiner_ckpt")}
        ip9.update(seed=60, sampling_steps=inpaint_steps, **up)
        first9_s = sdxl_job(client, ip9, "inpainting")[0]   # the load
        bundle9 = resident(srv)
        hook = bundle9.vae.decoder.register_forward_hook(
            lambda m, a, out: finite.append(bool(torch.isfinite(out).all())))
        timed_and_hooked(client, "sdxl inpainting 9-channel",
                         dict(ip9, seed=61), "inpainting", bundle9,
                         (inpaint_steps, 0, 1, 1))
        hook.remove()
    finally:
        srv.stop()

    weights = [check_groups("sdxl_refiner_weights", {
        "refiner_unet": bundle.refiner_unet,
        "refiner_openclip": bundle.refiner_conditioner.open_clip}, truth, {}),
        check_groups("sdxl_inpaint_weights", {
            "inpaint_unet": bundle9.unet, "inpaint_vae": bundle9.vae,
            "inpaint_clip": bundle9.conditioner.clip_l,
            "inpaint_openclip": bundle9.conditioner.open_clip}, truth, {})]
    for w in weights:
        emit(w)
    del truth
    per_eval = (count(bundle.refiner_unet, CrossAttention),
                count(bundle.refiner_unet, GroupNorm))

    def derived(b, evals, r_evals, enc, dec):
        k1, k2 = kernel_calls(b, evals, enc, dec)
        return k1 + r_evals * per_eval[0], k2 + r_evals * per_eval[1]

    want = [SDXL_REQUESTS * k for k in derived(bundle, steps, t_refine, 0, 1)]
    loads = {k: dict(v, gb_per_s=v["bytes"] / max(v["seconds"], 1e-9) / 1e9)
             for b in (bundle, bundle9)
             for k, v in b.load_report["files"].items()}
    pixel_std = [float(np.std(p.astype(np.float32))) for p, _ in images]
    row = dict(phase="sdxl_modes", card=card, steps=steps, batch=SDXL_BATCH,
               sampler=job["sampler"], cfg=SDXL_CFG,
               refiner_strength=SDXL_REFINER_STRENGTH,
               refiner_steps=t_refine, requests=SDXL_REQUESTS, seconds=wall,
               seconds_per_request=wall / SDXL_REQUESTS,
               images_per_s=len(images) / wall, first_run_seconds=first_s,
               inpaint_first_run_seconds=first9_s, load=loads,
               lora=bundle.load_report["loras"],
               refiner_calls_per_eval=list(per_eval),
               images=[list(p.shape) for p, _ in images], pixel_std=pixel_std,
               decodes_finite=decodes,
               flash_attention_launches=launches[0],
               group_norm_silu_launches=launches[1],
               expected_flash_attention=want[0],
               expected_group_norm_silu=want[1])
    emit(row)
    if len(images) != SDXL_REQUESTS * SDXL_BATCH or any(
            p.shape != (res, res, 3) for p, _ in images) or \
            decodes != [True] * SDXL_REQUESTS or min(pixel_std) <= 0.0:
        raise AssertionError(f"sdxl_modes: images {row['images']}, finite "
                             f"decodes {decodes}, pixel std {pixel_std}")
    if tuple(launches) != tuple(want):
        raise AssertionError(f"sdxl_modes: refiner launches {launches} != "
                             f"derived {want}")
    rows += weights + [row]
    keep = mask[..., 0] == 0
    for name, (sec, (k1, k2), imgs, fin, mode, counts) in runs.items():
        attn, gn = shapes[name]
        b = bundle9 if "9-channel" in name else bundle
        want = derived(b, *counts)
        kept = None
        if mode == "inpainting":      # the unmasked pixels, up to PNG rounding
            kept = max(int(np.abs(p[keep].astype(int)
                                  - init[keep].astype(int)).max())
                       for p, _ in imgs)
        r = dict(phase="sdxl_modes_request", request=name, card=card,
                 seconds=sec, unet_evals=counts[0], refiner_evals=counts[1],
                 images=[list(p.shape) for p, _ in imgs], decodes_finite=fin,
                 pixel_std=[float(np.std(p.astype(np.float32)))
                            for p, _ in imgs],
                 modes=[m["mode"] for _, m in imgs],
                 unmasked_max_diff=kept,
                 flash_attention_launches=k1, group_norm_silu_launches=k2,
                 expected_flash_attention=want[0],
                 expected_group_norm_silu=want[1],
                 recorded_calls=[sum(attn.values()), sum(gn.values())])
        emit(r)
        if len(imgs) != 1 or imgs[0][0].shape != (res, res, 3) or \
                min(r["pixel_std"]) <= 0.0 or fin != [True] or \
                r["modes"] != [mode]:
            raise AssertionError(f"{name}: images {r['images']}, finite "
                                 f"{fin}, modes {r['modes']}")
        if kept is not None and kept > 1:
            raise AssertionError(f"{name}: unmasked pixels moved by {kept}")
        if not (k1, k2) == want == tuple(r["recorded_calls"]):
            raise AssertionError(f"{name}: kernel launches {(k1, k2)}, derived"
                                 f" {want}, recorded {r['recorded_calls']}")
        rows.append(r)
    if check_unet:
        check_unet_sdxl(bundle.refiner_unet, dev,
                        "sdxl_refiner_unet_full_width")
    return rows, shapes, launches


# flux: bench_flux's job (1024^2, 4 flow-Euler steps, batch 1), the T5
# context at the FluxConditioner's 256 tokens
FLUX_RES, FLUX_STEPS, FLUX_REQUESTS, FLUX_T5_LEN = 1024, 4, 2, 256
FLUX_PROMPT = "a photograph of an astronaut riding a horse on the moon"
FLUX_FILES_GB = 36          # free disk the four files need, with room
# the full-width velocity's relative L2 off bf16's: each about 2.5x the
# readings of the sound runs (NVIDIA H100 80GB HBM3, 700.00 W)
FLUX_VELOCITY_TOL = {"float8_e4m3": 0.1, "int8": 0.06}
FLUX_WORDS = ("a photograph of an astronaut riding horse on the moon quick "
              "brown fox jumps over lazy dog").split()


def flux_configs():
    """The published FLUX.1-schnell, T5-XXL, CLIP-L and FLUX VAE widths and
    depths, in bf16."""
    import torch

    from cremage_tpu_torch.models.clip import CLIPTextConfig
    from cremage_tpu_torch.models.flux import flux_schnell_config
    from cremage_tpu_torch.models.t5 import t5_xxl_config
    from cremage_tpu_torch.models.vae import flux_vae_config

    bf16 = torch.bfloat16
    return dict(flux=flux_schnell_config(dtype=bf16), t5=t5_xxl_config(dtype=bf16),
                clip=CLIPTextConfig(dtype=bf16), vae=flux_vae_config(dtype=bf16))


def spiece_model(words=FLUX_WORDS) -> bytes:
    """A synthetic unigram `spiece.model` (protobuf ModelProto): <pad>,
    </s>, <unk>, then each word with and without the U+2581 prefix and
    every character, scored by length."""
    import struct

    def varint(v):
        out = b""
        while True:
            b, v = v & 0x7F, v >> 7
            if not v:
                return out + bytes([b])
            out += bytes([b | 0x80])

    def field(num, wire, payload):
        return varint((num << 3) | wire) + payload

    def ld(num, payload):
        return field(num, 2, varint(len(payload)) + payload)

    pieces = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
    seen = {p for p, _, _ in pieces}
    for w in list(words) + sorted(set("".join(words))):
        for p in ("▁" + w, w):
            if p not in seen:
                seen.add(p)
                pieces.append((p, -1.0 / len(p) - 1.0, 1))
    blob = b"".join(ld(1, ld(1, p.encode()) + field(2, 5, struct.pack("<f", sc))
                       + field(3, 0, varint(t))) for p, sc, t in pieces)
    blob += ld(2, field(3, 0, varint(1)) + field(40, 0, varint(2))
               + field(41, 0, varint((1 << 64) - 1)) + field(42, 0, varint(1))
               + field(43, 0, varint(0)))
    return blob + ld(3, field(3, 0, varint(1)) + field(4, 0, varint(1))
                     + field(5, 0, varint(1)))


def write_seeded_safetensors(path: Path, shapes: dict, dev, seed: int,
                             tables=(), ties=None, extra=None, dtype="BF16"):
    """A .safetensors file of seeded random bf16 (or `dtype`: "F16")
    tensors, made on `dev` one
    at a time and streamed to disk (a 24 GB file never sits in host
    memory): weights N(0, 1 / (3 fan_in)) (the variance of torch's default
    Linear init), 1-D weights and scales 1 + 0.02 N, biases 0.02 N, the
    gather tables named by `tables` N(0, 1) and other tables 0.02 N.
    `ties` ({key: source key}) repeats a tensor's bytes under another key;
    `extra` ({key: CPU tensor}) is written as it is. -> seconds."""
    import struct

    import torch

    from cremage_tpu_torch.io import checkpoint as CK

    ties, extra = ties or {}, extra or {}
    specs = {k: (dtype, tuple(v), 2) for k, v in shapes.items()}
    for k, t in extra.items():
        specs[k] = (CK._NAMES[t.dtype], tuple(t.shape), t.element_size())
    header, off = {}, 0
    for k, (dt, shape, size) in specs.items():
        n = size
        for d in shape:
            n *= d
        header[k] = {"dtype": dt, "shape": list(shape),
                     "data_offsets": [off, off + n]}
        off += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    g = torch.Generator(device=dev).manual_seed(seed)
    kept = {}
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for k, (_, shape, _) in specs.items():
            if k in extra:
                f.write(extra[k].contiguous().reshape(-1).view(torch.uint8)
                        .numpy().tobytes())
                continue
            if k in ties:
                f.write(kept.pop(ties[k]))
                continue
            z = torch.randn(shape, device=dev, generator=g)
            if len(shape) == 1:
                z = (1.0 + 0.02 * z) if not k.endswith("bias") else 0.02 * z
            elif any(t in k for t in tables):
                pass
            elif "embedding" in k or "relative_attention_bias" in k:
                z = 0.02 * z
            else:
                fan_in = 1
                for d in shape[1:]:
                    fan_in *= d
                z = z / (3 * fan_in) ** 0.5
            data = z.to(CK.DTYPES[dtype]).view(torch.uint8).cpu().numpy().tobytes()
            if k in ties.values():
                kept[k] = data
            f.write(data)
            del z, data
    return time.perf_counter() - t0


def write_flux_files(root: Path, dev, cfgs: dict):
    """FLUX.1-schnell as published, from seeded random bf16 tensors under
    `root`: the BFL transformer (bare keys), HF's T5 encoder (encoder.,
    block 0's bias table, the tied embed_tokens), BFL's ae.safetensors (no
    quant convs), HF's CLIP-L (text_model., position_ids), a synthetic
    spiece.model and a config.yaml. Refuses to start without FLUX_FILES_GB
    of free disk. -> (paths, {file: seconds})."""
    import torch

    from cremage_tpu_torch.io import checkpoint as CK
    from cremage_tpu_torch.models.clip import CLIPTextModel
    from cremage_tpu_torch.models.flux import FluxModel
    from cremage_tpu_torch.models.t5 import T5Encoder
    from cremage_tpu_torch.models.vae import AutoencoderKL

    root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root).free / 1e9
    if free < FLUX_FILES_GB:
        raise RuntimeError(f"flux: {free:.1f} GB free under {root}, the "
                           f"files need {FLUX_FILES_GB} GB")

    def shapes(cls, cfg, rename=lambda k: k):
        with torch.device("meta"):
            return {rename(k): tuple(v.shape)
                    for k, v in cls(cfg).state_dict().items()}

    def hf_t5(k):
        if k == "shared.weight":
            return k
        if k == "relative_attention_bias.weight":
            return "encoder." + CK.T5_BIAS_KEY
        return "encoder." + k

    t5 = shapes(T5Encoder, cfgs["t5"], hf_t5)
    t5["encoder.embed_tokens.weight"] = t5["shared.weight"]
    clip = shapes(CLIPTextModel, cfgs["clip"], lambda k: "text_model." + k)
    paths = {k: root / n for k, n in (
        ("ckpt", "flux1-schnell.safetensors"), ("t5", "t5xxl_encoder.safetensors"),
        ("vae", "ae.safetensors"), ("clip", "clip_l.safetensors"),
        ("spiece", "spiece.model"), ("config", "config.yaml"))}
    seconds = {
        "ckpt": write_seeded_safetensors(
            paths["ckpt"], shapes(FluxModel, cfgs["flux"]), dev, 50),
        # embed_tokens is the tied copy of shared, as published
        "t5": write_seeded_safetensors(
            paths["t5"], t5, dev, 51, tables=("shared",),
            ties={"encoder.embed_tokens.weight": "shared.weight"}),
        "vae": write_seeded_safetensors(
            paths["vae"], shapes(AutoencoderKL, cfgs["vae"]), dev, 52),
        "clip": write_seeded_safetensors(
            paths["clip"], clip, dev, 53, extra={
                "text_model." + CK.POSITION_IDS: torch.arange(77)[None]}),
    }
    paths["spiece"].write_bytes(spiece_model())
    paths["config"].write_text(f"ldm_model_path: '{root}'\n")
    return {k: str(v) for k, v in paths.items()}, seconds


def check_flux_weights(bundle, paths, quantize):
    """check_coded over the FLUX bundle's four files."""
    from cremage_tpu_torch.io import checkpoint as CK

    return check_coded("flux_weights", quantize, {
        "flux": (bundle.model, CK.load_safetensors(paths["ckpt"])),
        "t5": (bundle.conditioner.t5, CK.t5_encoder_state_dict(
            CK.load_safetensors(paths["t5"]))),
        "vae": (bundle.vae, CK.load_safetensors(paths["vae"])),
        "clip": (bundle.conditioner.clip_l, CK.component_state_dict(
            CK.load_safetensors(paths["clip"]), "text_model.")),
    })


def check_coded(phase, quantize, groups):
    """Every tensor of each model of `groups` ({group: (model, its file's
    state dict)}) on the card against its file's: equal, or, for the
    8-bit weights, equal to io/quantize.py's codes and scale of the file's
    tensor in the model's dtype (JAX quantizes its parameters in their
    param dtype: an fp16 file's weights are rounded to bf16 first). -> a
    row of counts per group."""
    import torch

    from cremage_tpu_torch.io.quantize import coded_weights, quantize_weight

    row = dict(phase=phase, quantize=quantize, groups={})
    for group, (model, sd) in groups.items():
        state = model.state_dict()
        scales = coded_weights(state)
        derived = set(scales.values())
        coded = equal = 0
        for k, p in state.items():
            if k in derived:
                continue
            want = sd[k].to(p.device)
            if k in scales:
                codes, scale = quantize_weight(want.to(model.cfg.dtype),
                                               quantize)
                ok = (torch.equal(p.view(torch.uint8), codes.view(torch.uint8))
                      and torch.equal(state[scales[k]], scale))
                coded += 1
            else:
                ok = torch.equal(p, want.to(p.dtype))
                equal += 1
            if not ok:
                raise AssertionError(f"{phase} {quantize}: {group}.{k} "
                                     "differs from its file")
        row["groups"][group] = dict(tensors=coded + equal, equal=equal,
                                    eight_bit=coded)
    return row


def flux_kernel_calls(bundle, steps: int, decodes: int = 1):
    """(K1, K2) launches of a FLUX request from the module tree: one K1
    call per double and single block each step, one per VAE decoder
    attention and one K2 per decoder GroupNorm each decode (CLIP's
    causal attention and T5's biased one take the plain path)."""
    from cremage_tpu_torch.models.flux import DoubleBlock, SingleBlock
    from cremage_tpu_torch.models.layers import GroupNorm
    from cremage_tpu_torch.models.vae import AttnBlock

    blocks = count(bundle.model, DoubleBlock) + count(bundle.model, SingleBlock)
    return (steps * blocks + decodes * count(bundle.vae.decoder, AttnBlock),
            decodes * count(bundle.vae.decoder, GroupNorm))


def flux_velocity(model, dev):
    """The transformer's velocity at one seeded full-size input (the 4096
    image tokens of 1024^2, the 256 T5 tokens), float32 on the CPU."""
    import torch

    from cremage_tpu_torch.models.flux import make_position_ids

    g = torch.Generator(device=dev).manual_seed(54)
    x = torch.randn(1, 4096, 64, device=dev, generator=g)
    txt = torch.randn(1, FLUX_T5_LEN, 4096, device=dev, generator=g)
    vec = torch.randn(1, 768, device=dev, generator=g)
    txt_ids, img_ids = make_position_ids(64, 64, FLUX_T5_LEN)
    with torch.no_grad():
        return model(x, txt, torch.tensor([0.75], device=dev), vec, img_ids,
                     txt_ids).float().cpu()


def check_flux_blocks(model, dev):
    """One double and one single block of the full-width transformer in
    bf16 through K1 against the same weights in float32 through the plain
    versions, on the card, at the 1024^2 request's token counts."""
    import copy

    import torch

    from cremage_tpu_torch.models.flux import make_position_ids

    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(55)
    img = torch.randn(1, 4096, cfg.hidden_size, device=dev, generator=g)
    txt = torch.randn(1, FLUX_T5_LEN, cfg.hidden_size, device=dev, generator=g)
    vec = torch.randn(1, cfg.hidden_size, device=dev, generator=g)
    txt_ids, img_ids = make_position_ids(64, 64, FLUX_T5_LEN)
    freqs = model.freqs(img_ids, txt_ids, dev)
    rows = []
    for name, blk, args in (
            ("double", model.double_blocks[0], (img, txt)),
            ("single", model.single_blocks[0], (torch.cat([txt, img], 1),))):
        ref = copy.deepcopy(blk).float()
        with torch.no_grad():
            got = blk(*[a.bfloat16() for a in args], vec.bfloat16(), freqs)
            with plain_kernels():
                want = ref(*args, vec, freqs)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        rel = max(float((a.float() - b).abs().max() / b.abs().max())
                  for a, b in zip(got, want))
        rows.append(dict(block=name, max_rel_err=rel))
        del ref
    # bf16 rounds each of the block's ~10 products and its residual adds to
    # 2^-9 relative; their errors add along the block: a few 1e-2 of range
    tol = 5e-2
    row = dict(phase="flux_blocks_bf16_vs_fp32", rows=rows, tol=tol)
    emit(row)
    if not all(r["max_rel_err"] <= tol for r in rows):
        raise AssertionError(f"flux blocks bf16 vs fp32: {rows}")
    return row


def flux_t5(dev, card, paths, res, steps):
    """T5-XXL at full width, once: the four files through
    `load_flux_bundle` with a T5 tokenizer callable (the synthetic
    spiece.model's; the HTTP path passes none, as the JAX backend does),
    and one FluxPipeline request in the default fp8-e4m3 storage. -> the
    row: load seconds, the conditioner's seconds (CLIP-L and T5), the
    request's, its launches against the module tree's count (T5's biased
    attention takes no kernel), the T5 context's range."""
    import gc

    import numpy as np
    import torch

    from cremage_tpu_torch.core.config import GenerationOptions
    from cremage_tpu_torch.pipelines.flux import FluxPipeline
    from cremage_tpu_torch.pipelines.loader import load_flux_bundle
    from cremage_tpu_torch.prompt.sentencepiece import T5Tokenizer

    gc.collect()
    torch.cuda.empty_cache()
    tokenize = T5Tokenizer(Path(paths["spiece"]).read_bytes()).tokenize_fn(
        FLUX_T5_LEN)
    t0 = time.perf_counter()
    bundle = load_flux_bundle(paths["ckpt"], vae_ckpt=paths["vae"],
                              clip_ckpt=paths["clip"], t5_ckpt=paths["t5"],
                              t5_tokenize=tokenize, device=dev)
    load_s = time.perf_counter() - t0
    pipe = FluxPipeline(bundle, device=dev)
    t5_out = []
    hook = bundle.conditioner.t5.register_forward_hook(
        lambda m, a, out: t5_out.append(out.detach().float()))
    try:
        bundle.conditioner.encode(FLUX_PROMPT)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle.conditioner.encode(FLUX_PROMPT)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        out = pipe.generate(GenerationOptions(
            prompt=FLUX_PROMPT, H=res, W=res, sampling_steps=steps,
            n_samples=1, n_iter=1, seed=3, safety_check=False,
            watermark=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        hook.remove()
    txt = t5_out[-1]
    img = out[0][0]
    want = flux_kernel_calls(bundle, steps)
    row = dict(phase="flux_t5", card=card, load_seconds=load_s,
               conditioner_seconds=encode_s, seconds=wall,
               t5_context=list(txt.shape), t5_finite=bool(torch.isfinite(txt).all()),
               t5_abs_max=float(txt.abs().max()),
               image=list(img.shape), image_finite=bool(np.isfinite(img).all()),
               pixel_std=float(np.std(img)),
               flash_attention_launches=launches[0],
               group_norm_silu_launches=launches[1],
               expected_flash_attention=want[0],
               expected_group_norm_silu=want[1])
    emit(row)
    d_model = bundle.conditioner.t5.cfg.d_model
    del pipe, bundle, out
    gc.collect()
    torch.cuda.empty_cache()
    if row["t5_context"] != [1, FLUX_T5_LEN, d_model] or not row["t5_finite"] \
            or row["t5_abs_max"] <= 0.0 or row["image"] != [res, res, 3] \
            or not row["image_finite"] or row["pixel_std"] <= 0.0:
        raise AssertionError(f"flux_t5: {row}")
    if tuple(launches) != tuple(want):
        raise AssertionError(f"flux_t5: kernel launches {launches} != "
                             f"derived {want}")
    return row


def flux(dev, card, root: Path, res=FLUX_RES, steps=FLUX_STEPS,
         requests=FLUX_REQUESTS, check_model=True):
    """The phase flux: FLUX.1-schnell from full-width files through
    /v1/generate (bench_flux's job) with flux_quantize float8_e4m3 (the
    default: a warm-up that loads, `requests` timed requests, one with the
    shape hooks), "none" (bf16) and "int8" (a load, then one timed
    request each). -> (rows, {path: (K1 shapes, K2 shapes)}, launches of
    the timed fp8 requests)."""
    import gc

    import numpy as np
    import torch

    from cremage_tpu_torch.app.server import build_server

    gc.collect()
    torch.cuda.empty_cache()
    cfgs = flux_configs()
    paths, seconds = write_flux_files(root, dev, cfgs)
    rows = [dict(phase="flux_files", seconds=seconds,
                 resident_bytes_before=torch.cuda.memory_allocated(),
                 bytes={k: os.path.getsize(v) for k, v in paths.items()})]
    emit(rows[0])
    srv = build_server(["--config", paths["config"], "--port", "0"])
    srv.start()
    client = Client(f"http://127.0.0.1:{srv.port}")
    job = {"prompt": FLUX_PROMPT, "H": res, "W": res, "sampling_steps": steps,
           "n_samples": 1, "n_iter": 1, "safety_check": False,
           "watermark": False, "ckpt": paths["ckpt"], "vae_ckpt": paths["vae"],
           "clip_ckpt": paths["clip"], "t5_ckpt": paths["t5"]}
    finite, velocity, shapes, runs, served_txt = [], {}, {}, {}, {}

    def resident():
        return srv.worker._backends["FLUX.1-schnell"].resident.instance.bundle

    def run(params, record=False):
        """-> (seconds, (K1, K2), images, finite decodes, shapes)."""
        finite.clear()
        hooks = [resident().vae.decoder.register_forward_hook(
            lambda m, a, out: finite.append(bool(torch.isfinite(out).all())))
        ] if srv.worker._backends["FLUX.1-schnell"].resident.instance else []
        reset_counts()
        with contextlib.ExitStack() as stack:
            rec = (stack.enter_context(recording(resident()))
                   if record else None)
            t1 = time.perf_counter()
            client.generate("text_to_image", params, "FLUX.1-schnell")
            images = served_images(client.drain(1))
            wall = time.perf_counter() - t1
        for h in hooks:
            h.remove()
        return wall, read_counts(), images, list(finite), rec and rec[:2]

    loads = {}
    try:
        refused = expect_refused(client, dict(job, deep_cache=3),
                                 "an unported option", "FLUX.1-schnell")
        for quantize in ("float8_e4m3", "none", "int8"):
            params = dict(job, flux_quantize=quantize, seed=1)
            first = run(params)
            bundle = resident()
            loads[quantize] = dict(
                first_run_seconds=first[0],
                resident_bytes=torch.cuda.memory_allocated(),
                quantize=bundle.load_report.get("quantize"),
                files={k: dict(v, gb_per_s=v["bytes"] / max(v["seconds"], 1e-9)
                               / 1e9)
                       for k, v in bundle.load_report["files"].items()})
            rows.append(check_flux_weights(bundle, paths, quantize))
            emit(rows[-1])
            served_txt[quantize] = dict(
                t5_loaded=bundle.conditioner.t5 is not None,
                tokenizer=bundle.conditioner.t5_tokenize is not None,
                txt_abs_max=float(bundle.conditioner.encode(
                    FLUX_PROMPT)["txt"].abs().max()))
            if quantize == "float8_e4m3":
                reset_counts()
                t1 = time.perf_counter()
                finite.clear()
                hook = bundle.vae.decoder.register_forward_hook(
                    lambda m, a, out: finite.append(
                        bool(torch.isfinite(out).all())))
                for r in range(requests):
                    client.generate("text_to_image", dict(params, seed=10 + r),
                                    "FLUX.1-schnell")
                images = served_images(client.drain(requests))
                wall = time.perf_counter() - t1
                launches, decodes = read_counts(), list(finite)
                hook.remove()
                runs["flux 1024^2"] = run(dict(params, seed=12), record=True)
                shapes["flux 1024^2"] = runs["flux 1024^2"][4]
            else:
                runs[f"flux {quantize}"] = run(dict(params, seed=13))
            if check_model:
                velocity[quantize] = flux_velocity(bundle.model, dev)
                if quantize == "none":
                    rows.append(check_flux_blocks(bundle.model, dev))
            del bundle
    finally:
        srv.stop()
    want = [requests * k for k in flux_kernel_calls(resident(), steps)]
    held = srv.worker._backends["FLUX.1-schnell"].resident
    held.key = held.instance = None         # free the served bundle
    t5_row = flux_t5(dev, card, paths, res, steps)
    pixel_std = [float(np.std(p.astype(np.float32))) for p, _ in images]
    row = dict(phase="flux", card=card, steps=steps, batch=1,
               t5_len=FLUX_T5_LEN, quantize="float8_e4m3", requests=requests,
               seconds=wall, seconds_per_request=wall / requests,
               images_per_s=len(images) / wall, loads=loads,
               images=[list(p.shape) for p, _ in images], pixel_std=pixel_std,
               decodes_finite=decodes, refused=refused,
               served_t5_context=served_txt,
               flash_attention_launches=launches[0],
               group_norm_silu_launches=launches[1],
               expected_flash_attention=want[0],
               expected_group_norm_silu=want[1])
    if check_model:
        ref = velocity["none"]
        row["velocity_vs_bf16"] = {
            q: dict(rel_l2=float((v - ref).norm() / ref.norm()),
                    max_rel=float((v - ref).abs().max() / ref.abs().max()))
            for q, v in velocity.items() if q != "none"}
    emit(row)
    if len(images) != requests or any(p.shape != (res, res, 3)
                                      for p, _ in images) or \
            decodes != [True] * requests or min(pixel_std) <= 0.0:
        raise AssertionError(f"flux: images {row['images']}, finite decodes "
                             f"{decodes}, pixel std {pixel_std}")
    if "NotImplementedError" not in (refused or ""):
        raise AssertionError(f"flux: deep_cache not refused: {refused}")
    if any(not v["t5_loaded"] or v["tokenizer"] or v["txt_abs_max"] != 0.0
           for v in served_txt.values()):
        raise AssertionError(f"flux: the served T5 context is not the JAX "
                             f"backend's zeros: {served_txt}")
    if tuple(launches) != tuple(want):
        raise AssertionError(f"flux: kernel launches {launches} != derived "
                             f"{want}")
    # weight-only fp8 keeps 3 mantissa bits (2^-4 relative a weight), int8
    # about 2^-8 of each row's max plus the activations' codes: the sound
    # runs read 4.11e-2 (fp8) and 2.02e-2 (int8) relative L2 off bf16's,
    # and a wrong scale or product on a few layers moves it past these
    if check_model and not all(
            v["rel_l2"] <= FLUX_VELOCITY_TOL[q] and np.isfinite(v["max_rel"])
            for q, v in row["velocity_vs_bf16"].items()):
        raise AssertionError(f"flux: 8-bit velocity off bf16's: "
                             f"{row['velocity_vs_bf16']}")
    rows += [row, t5_row]
    for name, (sec, (k1, k2), imgs, fin, rec) in runs.items():
        r = dict(phase="flux_request", request=name, card=card, seconds=sec,
                 images=[list(p.shape) for p, _ in imgs], decodes_finite=fin,
                 flash_attention_launches=k1, group_norm_silu_launches=k2,
                 expected_flash_attention=want[0] // requests,
                 expected_group_norm_silu=want[1] // requests)
        if rec is not None:
            r["recorded_calls"] = [sum(rec[0].values()), sum(rec[1].values())]
        emit(r)
        if len(imgs) != 1 or imgs[0][0].shape != (res, res, 3) or fin != [True]:
            raise AssertionError(f"{name}: images {r['images']}")
        if (k1, k2) != (r["expected_flash_attention"],
                        r["expected_group_norm_silu"]) or (
                rec is not None and tuple(r["recorded_calls"]) != (k1, k2)):
            raise AssertionError(f"{name}: kernel launches {(k1, k2)}, "
                                 f"derived {want}, recorded "
                                 f"{r.get('recorded_calls')}")
        rows.append(r)
    return rows, shapes, launches


SVD_RES = (576, 1024)       # bench_svd's job: 14 frames, 25 EulerEDM steps,
SVD_FRAMES, SVD_STEPS, SVD_REQUESTS = 14, 25, 2     # CFG over [uc; c]
SVD_WARMUP_STEPS = 2
SVD_FILE_GB = 10            # free disk the 4.5 GB file needs, with room


def svd_configs():
    """SVD's published widths and depths: the video UNet, the image VAE
    and the OpenCLIP ViT-H/14 image tower, in bf16."""
    import torch

    from cremage_tpu_torch.models.clip_vision import vit_h14_config
    from cremage_tpu_torch.models.vae import VAEConfig
    from cremage_tpu_torch.models.video_unet import svd_unet_config

    bf16 = torch.bfloat16
    return dict(unet=svd_unet_config(dtype=bf16), vae=VAEConfig(dtype=bf16),
                vit=vit_h14_config(dtype=bf16))


def write_svd_file(root: Path, dev, cfgs: dict):
    """SVD as published, one file of seeded random fp16 tensors under
    `root`: the video UNet (the temporal convolutions OIDHW), the image VAE
    under first_stage_model., the ViT-H image tower under
    conditioner.embedders.0.open_clip.model.visual. with its attention
    input projection fused, and keys of each dropped family (the
    VideoDecoder's temporal layers, the conditioner's other keys); and a
    config.yaml naming svd_model_path. Refuses to start without
    SVD_FILE_GB of free disk. -> (paths, seconds)."""
    import torch

    from cremage_tpu_torch.io import checkpoint as CK
    from cremage_tpu_torch.models.clip_vision import CLIPVisionModel
    from cremage_tpu_torch.models.vae import AutoencoderKL
    from cremage_tpu_torch.models.video_unet import VideoUNet

    root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root).free / 1e9
    if free < SVD_FILE_GB:
        raise RuntimeError(f"svd: {free:.1f} GB free under {root}, the file "
                           f"needs {SVD_FILE_GB} GB")
    with torch.device("meta"):
        models = {CK.PREFIX_UNET: VideoUNet(cfgs["unet"], SVD_FRAMES),
                  CK.PREFIX_VAE: AutoencoderKL(cfgs["vae"]),
                  CK.PREFIX_VISUAL_SVD: CLIPVisionModel(cfgs["vit"])}
    shapes = {}
    for prefix, model in models.items():
        sd = model.state_dict()
        if prefix == CK.PREFIX_VISUAL_SVD:
            sd = fused_openclip(sd)
        shapes.update({prefix + k: tuple(v.shape) for k, v in sd.items()})
    gen = torch.Generator().manual_seed(61)
    dropped = {k: torch.randn(shape, generator=gen).half() for k, shape in (
        ("first_stage_model.decoder.mid.block_1.time_stack.in_layers.2.weight",
         (512, 512, 3, 1, 1)),
        ("first_stage_model.decoder.mid.block_1.mix_factor", (1,)),
        ("first_stage_model.decoder.conv_out.time_mix_conv.weight",
         (3, 3, 3, 1, 1)),
        ("conditioner.embedders.0.open_clip.model.token_embedding.weight",
         (49408, 1024)),
        ("conditioner.embedders.0.open_clip.model.logit_scale", ()),
        ("conditioner.embedders.3.encoder.encoder.conv_in.weight",
         (128, 3, 3, 3)))}
    paths = {"ckpt": root / "svd.safetensors", "config": root / "config.yaml"}
    seconds = write_seeded_safetensors(paths["ckpt"], shapes, dev, 60,
                                       extra=dropped, dtype="F16")
    paths["config"].write_text(f"svd_model_path: '{root}'\n")
    return {k: str(v) for k, v in paths.items()}, seconds


def check_svd_weights(bundle, path, quantize):
    """check_coded over the SVD bundle's models and its file."""
    from cremage_tpu_torch.io import checkpoint as CK

    parts = CK.split_svd(CK.load_safetensors(path))
    return check_coded("svd_weights", quantize, {
        "unet": (bundle.unet, parts[CK.PREFIX_UNET]),
        "vae": (bundle.vae, parts[CK.PREFIX_VAE]),
        "clip_vision": (bundle.clip_vision, parts[CK.PREFIX_VISUAL_SVD])})


def svd_kernel_calls(bundle, steps: int, frames: int):
    """(K1, K2) launches of an SVD request from the module tree: each of
    the `steps` UNet evaluations (the [uc; c] batch in one call) runs every
    attention and GroupNorm of the video UNet once (the temporal
    self-attention is plain torch, not K1), the VAE encodes the
    conditioning frame once and decodes each frame alone, and the image
    tower runs once."""
    from cremage_tpu_torch.models.layers import GroupNorm
    from cremage_tpu_torch.models.open_clip import _Attention
    from cremage_tpu_torch.models.unet import CrossAttention
    from cremage_tpu_torch.models.vae import AttnBlock

    vae = bundle.vae
    tower = (count(bundle.clip_vision, _Attention)
             if bundle.clip_vision is not None else 0)
    return (steps * count(bundle.unet, CrossAttention)
            + count(vae.encoder, AttnBlock)
            + frames * count(vae.decoder, AttnBlock) + tower,
            steps * count(bundle.unet, GroupNorm)
            + count(vae.encoder, GroupNorm)
            + frames * count(vae.decoder, GroupNorm))


def check_unet_svd(unet, dev, frames=SVD_FRAMES):
    """The full-width video UNet over one CFG half (1 x `frames` frames at
    SVD's 72x128 latent) in bf16 through the kernels against the same
    weights in fp32 through the plain versions, both on the card."""
    import torch

    from cremage_tpu_torch.models.video_unet import VideoUNet

    cfg = unet.cfg
    with torch.device("meta"):
        ref = VideoUNet(dataclasses.replace(cfg, dtype=torch.float32),
                        unet.num_frames)
    ref.load_state_dict({k: v.float() for k, v in
                         unet.state_dict().items()}, assign=True)
    g = torch.Generator(device=dev).manual_seed(62)
    h, w = SVD_RES[0] // 8, SVD_RES[1] // 8
    x = torch.randn(frames, cfg.in_channels, h, w, device=dev, generator=g)
    t = torch.full((frames,), 0.25 * float(torch.log(torch.tensor(10.0))),
                   device=dev)
    ctx = torch.randn(frames, 1, cfg.context_dim, device=dev, generator=g)
    y = torch.randn(frames, cfg.adm_in_channels, device=dev, generator=g)
    with torch.no_grad():
        got = unet(x, t, ctx, y).float()
        with plain_kernels():
            want = ref.eval()(x, t, ctx, y)
    rel = float((got - want).abs().max() / want.abs().max())
    rel_l2 = float((got - want).norm() / want.norm())
    # bf16 rounds each layer's output to 2^-9 relative and the errors add
    # up along the residual stream, as for the image UNets
    tol = 5e-2
    row = dict(phase="svd_unet_full_width", shape=[frames, cfg.in_channels,
                                                   h, w],
               max_rel_err=rel, rel_l2_err=rel_l2, tol=tol,
               finite=bool(torch.isfinite(got).all()))
    emit(row)
    del ref, want
    torch.cuda.empty_cache()
    if not (row["finite"] and rel <= tol):
        raise AssertionError(f"svd_unet_full_width: max relative error "
                             f"{rel} > {tol}")
    return row


def svd_test_image(h: int, w: int):
    """A smooth (h, w, 3) uint8 picture."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w] / np.array([h, w])[:, None, None]
    rgb = np.stack([np.sin(7 * xx + 2 * yy), np.cos(5 * yy - 3 * xx),
                    np.sin(4 * (xx + yy) + 1)], -1)
    return np.round((rgb * 0.45 + 0.5) * 255).astype(np.uint8)


def svd(dev, card, root: Path, res=SVD_RES, frames=SVD_FRAMES,
        steps=SVD_STEPS, requests=SVD_REQUESTS, check_model=True):
    """The phase svd: SVD img2vid from one full-width file through
    /v1/generate (bench_svd's job on an uploaded 576x1024 image): a
    warm-up of SVD_WARMUP_STEPS steps that loads, `requests` timed
    requests, one more with the shape hooks, then with unet_quantize
    "float8_e4m3" a warm-up that loads anew and one timed request. ->
    (rows, {path: (K1 shapes, K2 shapes)}, launches of the timed
    requests)."""
    import gc

    import numpy as np
    import torch

    from cremage_tpu_torch.app.server import build_server
    from cremage_tpu_torch.io.png import encode_png

    gc.collect()
    torch.cuda.empty_cache()
    paths, seconds = write_svd_file(root, dev, svd_configs())
    rows = [dict(phase="svd_file", seconds=seconds,
                 bytes=os.path.getsize(paths["ckpt"]))]
    emit(rows[0])
    srv = build_server(["--config", paths["config"], "--port", "0"])
    srv.start()
    client = Client(f"http://127.0.0.1:{srv.port}")
    upload = client.call("/v1/upload", {"image": base64.b64encode(encode_png(
        svd_test_image(*res))).decode()})["path"]
    job = {"init_img": upload, "svd_model": Path(paths["ckpt"]).name,
           "num_frames": frames, "sampling_steps": steps, "fps_id": 6,
           "motion_bucket_id": 127, "cond_aug": 0.02}
    finite, runs, shapes, loads = [], {}, {}, {}

    def resident():
        return srv.worker._backends["SVD"].resident.instance.bundle

    def run(params, record=False):
        """-> (seconds, (K1, K2), frames, finite decodes, shapes)."""
        finite.clear()
        reset_counts()
        with contextlib.ExitStack() as stack:
            rec = (stack.enter_context(recording(resident()))
                   if record else None)
            t1 = time.perf_counter()
            client.generate("image_to_video", params, "SVD")
            out = served_images(client.drain(1))
            wall = time.perf_counter() - t1
        return wall, read_counts(), out, list(finite), rec and rec[:2]

    def watch_decodes(bundle):
        return bundle.vae.decoder.register_forward_hook(
            lambda m, a, out: finite.append(bool(torch.isfinite(out).all())))

    def load_row(kind, first):
        bundle = resident()
        loads[kind] = dict(
            first_run_seconds=first[0],
            resident_bytes=torch.cuda.memory_allocated(),
            quantize=bundle.load_report.get("quantize"),
            files={k: dict(v, gb_per_s=v["bytes"] / max(v["seconds"], 1e-9)
                           / 1e9)
                   for k, v in bundle.load_report["files"].items()})
        rows.append(check_svd_weights(bundle, paths["ckpt"], kind))
        emit(rows[-1])
        return bundle

    try:
        refused = expect_refused(client, dict(job, interpolation_frames=1),
                                 "FILM interpolation", "SVD")
        bundle = load_row("none", run(dict(job, sampling_steps=SVD_WARMUP_STEPS,
                                           seed=1)))
        hook = watch_decodes(bundle)
        finite.clear()
        reset_counts()
        t1 = time.perf_counter()
        for r in range(requests):
            client.generate("image_to_video", dict(job, seed=10 + r), "SVD")
        served = served_images(client.drain(requests))
        wall = time.perf_counter() - t1
        launches, decodes = read_counts(), list(finite)
        runs["svd 576x1024"] = run(dict(job, seed=12), record=True)
        hook.remove()
        shapes["svd 576x1024"] = runs["svd 576x1024"][4]
        want = [requests * k for k in svd_kernel_calls(bundle, steps, frames)]
        if check_model:
            rows.append(check_unet_svd(bundle.unet, dev))
        del bundle
        params = dict(job, unet_quantize="float8_e4m3", seed=13)
        load_row("float8_e4m3", run(dict(params,
                                         sampling_steps=SVD_WARMUP_STEPS)))
        runs["svd float8_e4m3"] = run(params)
    finally:
        srv.stop()
    held = srv.worker._backends["SVD"].resident
    held.key = held.instance = None         # free the served bundle
    gc.collect()
    torch.cuda.empty_cache()
    stds = [float(np.std(p.astype(np.float32))) for p, _ in served]
    row = dict(phase="svd", card=card, frames=frames, steps=steps,
               res=list(res), requests=requests, seconds=wall,
               seconds_per_request=wall / requests,
               frames_per_s=len(served) / wall, loads=loads,
               frames_served=len(served), pixel_std_min=min(stds),
               frame_shapes=sorted({tuple(p.shape) for p, _ in served}),
               decodes_finite=all(decodes), decodes=len(decodes),
               refused=refused, flash_attention_launches=launches[0],
               group_norm_silu_launches=launches[1],
               expected_flash_attention=want[0],
               expected_group_norm_silu=want[1])
    emit(row)
    if len(served) != requests * frames or row["frame_shapes"] != [
            (res[0], res[1], 3)] or not all(decodes) \
            or len(decodes) != requests * frames or min(stds) <= 0.0:
        raise AssertionError(f"svd: {len(served)} frames of "
                             f"{row['frame_shapes']}, finite decodes "
                             f"{decodes}, least pixel std {min(stds)}")
    if "NotImplementedError" not in (refused or ""):
        raise AssertionError(f"svd: interpolation_frames not refused: "
                             f"{refused}")
    if tuple(launches) != tuple(want):
        raise AssertionError(f"svd: kernel launches {launches} != derived "
                             f"{want}")
    rows.append(row)
    for name, (sec, (k1, k2), imgs, fin, rec) in runs.items():
        r = dict(phase="svd_request", request=name, card=card, seconds=sec,
                 frames=len(imgs), frame_shapes=sorted(
                     {tuple(p.shape) for p, _ in imgs}),
                 pixel_std_min=min(float(np.std(p.astype(np.float32)))
                                   for p, _ in imgs),
                 decodes_finite=fin, flash_attention_launches=k1,
                 group_norm_silu_launches=k2,
                 expected_flash_attention=want[0] // requests,
                 expected_group_norm_silu=want[1] // requests)
        if rec is not None:
            r["recorded_calls"] = [sum(rec[0].values()), sum(rec[1].values())]
        emit(r)
        if len(imgs) != frames or r["frame_shapes"] != [(res[0], res[1], 3)] \
                or r["pixel_std_min"] <= 0.0 or (
                fin and fin != [True] * frames):
            raise AssertionError(f"{name}: {r}")
        if (k1, k2) != (r["expected_flash_attention"],
                        r["expected_group_norm_silu"]) or (
                rec is not None and tuple(r["recorded_calls"]) != (k1, k2)):
            raise AssertionError(f"{name}: kernel launches {(k1, k2)}, "
                                 f"derived {want}, recorded "
                                 f"{r.get('recorded_calls')}")
        rows.append(r)
    return rows, shapes, launches


SD3_RES, SD3_STEPS, SD3_REQUESTS, SD3_CFG = 1024, 28, 2, 7.0   # SD3-medium's
DIT_WARMUP_STEPS = 2        # published settings; a load's first request
SD3_FILE_GB = 14            # free disk the 5.9 GB file needs, with room
PIXART_RES, PIXART_STEPS, PIXART_REQUESTS, PIXART_CFG = 1024, 20, 2, 4.5
PIXART_SAMPLER = "DPM++ 2M"  # diffusers' PixArtSigmaPipeline defaults
PIXART_FILES_GB = 4
HUNYUAN_RES, HUNYUAN_STEPS, HUNYUAN_REQUESTS, HUNYUAN_CFG = 1024, 25, 2, 5.0
HUNYUAN_SAMPLER = "DPM++ 2M"   # the served default; CFG diffusers' default
HUNYUAN_FILES_GB = 16          # free disk the 7.3 GB of files need, with room
HUNYUAN_VOCAB = 47020          # the Chinese-CLIP BertModel's vocab.txt lines
DIT_PROMPT = "a photograph of an astronaut riding a horse on the moon"


def sd3_configs():
    """SD3-medium's published widths and depths: the MMDiT, CLIP-L, bigG
    and the 16-channel VAE, in bf16."""
    import torch

    from cremage_tpu_torch.models.clip import CLIPTextConfig
    from cremage_tpu_torch.models.mmdit import sd3_medium_config
    from cremage_tpu_torch.models.open_clip import openclip_bigg_config
    from cremage_tpu_torch.models.vae import sd3_vae_config

    bf16 = torch.bfloat16
    return dict(mmdit=sd3_medium_config(dtype=bf16),
                clip=CLIPTextConfig(dtype=bf16),
                bigg=openclip_bigg_config(dtype=bf16),
                vae=sd3_vae_config(dtype=bf16))


def meta_shapes(cls, cfg) -> dict:
    """{key: shape} of `cls(cfg)`'s state dict, built on the meta device."""
    import torch

    with torch.device("meta"):
        return {k: tuple(v.shape) for k, v in cls(cfg).state_dict().items()}


def hf_openclip_key(key: str) -> str:
    """A key of the port's OpenCLIP tower as HF's CLIPTextModelWithProjection
    names it (under `text_model.`, the projection beside it), the inverse of
    io/checkpoint.py `hf_text_to_openclip`."""
    from cremage_tpu_torch.io import checkpoint as CK

    if key == "text_projection":
        return "text_projection.weight"
    if key == "token_embedding.weight":
        return "text_model.embeddings.token_embedding.weight"
    if key == "positional_embedding":
        return "text_model.embeddings.position_embedding.weight"
    if key.startswith("ln_final."):
        return "text_model.final_layer_norm." + key[len("ln_final."):]
    i, sub = key[len("transformer.resblocks."):].split(".", 1)
    for hf, ours in CK.HF_OPENCLIP_LAYER:
        sub = sub.replace(ours, hf)
    return f"text_model.encoder.layers.{i}.{sub}"


def write_sd3_file(root: Path, dev, cfgs: dict):
    """SD3-medium as published (sd3_medium_incl_clips: no T5), one file of
    seeded random fp16 tensors under `root`: the MMDiT under
    model.diffusion_model., the VAE (no quant convs) under
    first_stage_model., CLIP-L and bigG in HF's CLIPTextModelWithProjection
    layout under text_encoders.clip_{l,g}.transformer. (CLIP-L's
    projection, which the loader drops, included), and a config.yaml
    naming it. Refuses to start without SD3_FILE_GB of free disk. ->
    (paths, seconds)."""
    import torch

    from cremage_tpu_torch.io import checkpoint as CK
    from cremage_tpu_torch.models.clip import CLIPTextModel
    from cremage_tpu_torch.models.mmdit import MMDiT
    from cremage_tpu_torch.models.open_clip import OpenCLIPTextModel
    from cremage_tpu_torch.models.vae import AutoencoderKL

    root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root).free / 1e9
    if free < SD3_FILE_GB:
        raise RuntimeError(f"sd3: {free:.1f} GB free under {root}, the file "
                           f"needs {SD3_FILE_GB} GB")
    shapes = {CK.PREFIX_UNET + k: v
              for k, v in meta_shapes(MMDiT, cfgs["mmdit"]).items()}
    shapes.update({CK.PREFIX_VAE + k: v
                   for k, v in meta_shapes(AutoencoderKL, cfgs["vae"]).items()})
    shapes.update({CK.PREFIX_SD3_CLIP_L + k: v for k, v in meta_shapes(
        CLIPTextModel, cfgs["clip"]).items()})
    shapes.update({"text_encoders.clip_g.transformer." + hf_openclip_key(k): v
                   for k, v in meta_shapes(OpenCLIPTextModel,
                                           cfgs["bigg"]).items()})
    for name in CK.SD3_DROPPED:
        shapes[name] = (cfgs["clip"].hidden_size,) * 2
    ids = torch.arange(77)[None]
    paths = {"ckpt": root / "sd3_medium_incl_clips.safetensors",
             "config": root / "config.yaml"}
    seconds = write_seeded_safetensors(
        paths["ckpt"], shapes, dev, 70, dtype="F16", extra={
            CK.PREFIX_SD3_CLIP_L + CK.POSITION_IDS: ids,
            CK.PREFIX_SD3_CLIP_G + CK.POSITION_IDS: ids})
    paths["config"].write_text(f"sd3_ldm_model_path: '{root}'\n"
                               f"sd3_ldm_model: '{paths['ckpt'].name}'\n")
    return {k: str(v) for k, v in paths.items()}, seconds


def diffusers_pixart_key(key: str):
    """The diffusers PixArtTransformer2DModel keys a key of the port's PixArt
    comes from, with the rows each holds (a fused qkv / kv weight or bias
    splits into to_q, to_k, to_v): the inverse of io/diffusers_keys.py
    `pixart_from_diffusers`. -> [(diffusers key, part, parts)]."""
    from cremage_tpu_torch.io import diffusers_keys as DK

    if key == "final_layer.scale_shift_table":
        return [("scale_shift_table", 0, 1)]
    if key.startswith("blocks."):
        i, rest = key[len("blocks."):].split(".", 1)
        base, kind = f"transformer_blocks.{i}.", rest.rsplit(".", 1)[-1]
        if rest.startswith("attn.qkv."):
            return [(f"{base}attn1.to_{c}.{kind}", j, 3)
                    for j, c in enumerate("qkv")]
        if rest.startswith("cross_attn.kv_linear."):
            return [(f"{base}attn2.to_{c}.{kind}", j, 2)
                    for j, c in enumerate("kv")]
        if rest == "scale_shift_table":
            return [(base + rest, 0, 1)]
        theirs, ours = next(p for p in DK._BLOCK if rest.startswith(p[1]))
        return [(base + theirs + rest[len(ours):], 0, 1)]
    theirs, ours = next(p for p in DK._TOP if key.startswith(p[1]))
    return [(theirs + key[len(ours):], 0, 1)]


def write_pixart_files(root: Path, dev):
    """PixArt-Σ XL as published, from seeded random fp16 tensors under
    `root`: the transformer in diffusers' layout
    (transformer/diffusion_pytorch_model.safetensors) and the SD VAE as a
    standalone file in the CompVis layout, and a config.yaml naming the
    transformer. -> (paths, {file: seconds})."""
    from cremage_tpu_torch.models.pixart import PixArt, pixart_sigma_xl_config
    from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root).free / 1e9
    if free < PIXART_FILES_GB:
        raise RuntimeError(f"pixart: {free:.1f} GB free under {root}, the "
                           f"files need {PIXART_FILES_GB} GB")
    shapes = {}
    for k, shape in meta_shapes(PixArt, pixart_sigma_xl_config()).items():
        for name, _, parts in diffusers_pixart_key(k):
            shapes[name] = (shape[0] // parts,) + shape[1:]
    paths = {"ckpt": root / "diffusion_pytorch_model.safetensors",
             "vae": root / "sdxl_vae.safetensors", "config": root / "config.yaml"}
    seconds = {
        "ckpt": write_seeded_safetensors(paths["ckpt"], shapes, dev, 80,
                                         dtype="F16"),
        "vae": write_seeded_safetensors(
            paths["vae"], meta_shapes(AutoencoderKL, VAEConfig()), dev, 81,
            dtype="F16")}
    paths["config"].write_text(
        f"pixart_sigma_ldm_model_path: '{root}'\n"
        f"pixart_sigma_ldm_model: '{paths['ckpt'].name}'\n")
    return {k: str(v) for k, v in paths.items()}, seconds


def hunyuan_configs():
    """Hunyuan-DiT v1.2's published widths and depths: the DiT, the
    Chinese-CLIP BertModel, the mT5-XL encoder and the SDXL VAE, in
    bf16."""
    import torch

    from cremage_tpu_torch.models.bert import hunyuan_clip_config
    from cremage_tpu_torch.models.hunyuan import hunyuan_dit_config
    from cremage_tpu_torch.models.t5 import mt5_xl_config
    from cremage_tpu_torch.models.vae import sdxl_vae_config

    bf16 = torch.bfloat16
    return dict(dit=hunyuan_dit_config(dtype=bf16),
                bert=hunyuan_clip_config(dtype=bf16),
                mt5=mt5_xl_config(dtype=bf16), vae=sdxl_vae_config(dtype=bf16))


def diffusers_hunyuan_key(key: str):
    """The diffusers HunyuanDiT2DModel keys a key of the port's HunyuanDiT
    comes from, with the rows each holds, as diffusers_pixart_key: the
    inverse of io/diffusers_keys.py `hunyuan_from_diffusers`."""
    from cremage_tpu_torch.io import diffusers_keys as DK

    if not key.startswith("blocks."):
        theirs, ours = next(p for p in DK._HY_TOP if key.startswith(p[1]))
        return [(theirs + key[len(ours):], 0, 1)]
    i, rest = key[len("blocks."):].split(".", 1)
    base, kind = f"blocks.{i}.", rest.rsplit(".", 1)[-1]
    if rest.startswith(("attn1_qkv.", "attn2_kv.")):
        names = "qkv" if rest.startswith("attn1") else "kv"
        return [(f"{base}attn{rest[4]}.to_{c}.{kind}", j, len(names))
                for j, c in enumerate(names)]
    theirs, ours = next(p for p in DK._HY_BLOCK if rest.startswith(p[1]))
    return [(base + theirs + rest[len(ours):], 0, 1)]


def diffusers_vae_key(key: str, shape):
    """(diffusers AutoencoderKL key, shape) of a key of the port's (CompVis)
    VAE, the inverse of io/diffusers_keys.py `sd_vae_from_diffusers` at 4
    levels: the mid attention's 1x1 convolutions are linear layers
    there."""
    sub = [(r"^(encoder|decoder)\.norm_out\.", r"\1.conv_norm_out."),
           (r"^(encoder|decoder)\.mid\.block_1\.", r"\1.mid_block.resnets.0."),
           (r"^(encoder|decoder)\.mid\.block_2\.", r"\1.mid_block.resnets.1."),
           (r"^(encoder|decoder)\.mid\.attn_1\.norm\.",
            r"\1.mid_block.attentions.0.group_norm."),
           (r"^(encoder|decoder)\.mid\.attn_1\.(q|k|v)\.",
            r"\1.mid_block.attentions.0.to_\2."),
           (r"^(encoder|decoder)\.mid\.attn_1\.proj_out\.",
            r"\1.mid_block.attentions.0.to_out.0."),
           (r"^encoder\.down\.(\d)\.block\.", r"encoder.down_blocks.\1.resnets."),
           (r"^encoder\.down\.(\d)\.downsample\.",
            r"encoder.down_blocks.\1.downsamplers.0."),
           (r"^decoder\.up\.(\d)\.block\.", r"decoder.up_blocks.@\1.resnets."),
           (r"^decoder\.up\.(\d)\.upsample\.",
            r"decoder.up_blocks.@\1.upsamplers.0."),
           (r"\.nin_shortcut\.", ".conv_shortcut.")]
    name = key
    for pat, to in sub:
        name = re.sub(pat, to, name)
    name = re.sub(r"@(\d)", lambda m: str(3 - int(m.group(1))), name)
    if ".attentions.0.to_" in name and name.endswith("weight"):
        shape = tuple(shape[:2])
    return name, tuple(shape)


def write_hunyuan_files(root: Path, dev, cfgs: dict):
    """Hunyuan-DiT's component files as a hunyuan_dir holds them, from
    seeded random fp16 tensors under `root`: transformer.safetensors
    (diffusers' HunyuanDiT2DModel layout), vae.safetensors (the SDXL VAE in
    diffusers' AutoencoderKL layout), clip.safetensors (HF's BertModel),
    vocab.txt (the prompts' words, the rest of its HUNYUAN_VOCAB lines
    unused), mt5.safetensors (HF's T5EncoderModel: the shared table and the
    encoder, the tied embed_tokens stored once as HF saves it) and a
    synthetic spiece.model; a config.yaml with no model (a Hunyuan-DiT job
    names its files). Refuses to start without HUNYUAN_FILES_GB of free
    disk. -> (paths, {file: seconds})."""
    from cremage_tpu_torch.models.bert import BertModel
    from cremage_tpu_torch.models.hunyuan import HunyuanDiT
    from cremage_tpu_torch.models.t5 import T5Encoder
    from cremage_tpu_torch.models.vae import AutoencoderKL

    root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root).free / 1e9
    if free < HUNYUAN_FILES_GB:
        raise RuntimeError(f"hunyuan: {free:.1f} GB free under {root}, the "
                           f"files need {HUNYUAN_FILES_GB} GB")
    dit = {}
    for k, shape in meta_shapes(HunyuanDiT, cfgs["dit"]).items():
        for name, _, parts in diffusers_hunyuan_key(k):
            dit[name] = (shape[0] // parts,) + shape[1:]
    vae = dict(diffusers_vae_key(k, v) for k, v in
               meta_shapes(AutoencoderKL, cfgs["vae"]).items())
    mt5 = {("shared.weight" if k == "shared.weight" else
            "encoder.block.0.layer.0.SelfAttention.relative_attention_bias."
            "weight" if k == "relative_attention_bias.weight" else
            "encoder." + k): v
           for k, v in meta_shapes(T5Encoder, cfgs["mt5"]).items()}
    paths = {k: root / n for k, n in (
        ("dit", "transformer.safetensors"), ("vae", "vae.safetensors"),
        ("clip", "clip.safetensors"), ("vocab", "vocab.txt"),
        ("mt5", "mt5.safetensors"), ("spiece", "spiece.model"),
        ("config", "config.yaml"))}
    words = sorted(set((DIT_PROMPT + " " + NEGATIVE).replace(",", " ").split()))
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ","]
    lines = specials + words + [f"[unused{i}]" for i in range(
        HUNYUAN_VOCAB - len(specials) - len(words))]
    paths["vocab"].write_text("\n".join(lines) + "\n", encoding="utf-8")
    paths["spiece"].write_bytes(spiece_model(words))
    paths["config"].write_text("# Hunyuan-DiT jobs name their files\n")
    seconds = {
        "dit": write_seeded_safetensors(paths["dit"], dit, dev, 90, dtype="F16"),
        "vae": write_seeded_safetensors(paths["vae"], vae, dev, 91, dtype="F16"),
        "clip": write_seeded_safetensors(
            paths["clip"], meta_shapes(BertModel, cfgs["bert"]), dev, 92,
            dtype="F16"),
        "mt5": write_seeded_safetensors(paths["mt5"], mt5, dev, 93,
                                        tables=("shared.weight",),
                                        dtype="F16")}
    out = {k: str(v) for k, v in paths.items()}
    out["dir"] = str(root)
    return out, seconds


def check_dit_weights(phase, bundle, paths, quantize):
    """check_coded over an SD3, PixArt or Hunyuan-DiT bundle's models and
    their files."""
    from cremage_tpu_torch.io import checkpoint as CK
    from cremage_tpu_torch.io.diffusers_keys import (
        hunyuan_from_diffusers, pixart_from_diffusers,
    )
    from cremage_tpu_torch.pipelines.loader import (
        bert_state_dict, standalone_vae_state_dict,
    )

    if phase == "sd3":
        parts = CK.split_sd3(CK.load_safetensors(paths["ckpt"]))
        cond = bundle.conditioner
        groups = {"mmdit": (bundle.mmdit, parts[CK.PREFIX_UNET]),
                  "vae": (bundle.vae, parts[CK.PREFIX_VAE]),
                  "clip_l": (cond.clip_l, parts[CK.PREFIX_SD3_CLIP_L]),
                  "clip_g": (cond.open_clip, parts[CK.PREFIX_SD3_CLIP_G])}
    elif phase == "hunyuan":
        def load(key):
            return CK.load_safetensors(paths[key])

        groups = {"dit": (bundle.dit, hunyuan_from_diffusers(load("dit"))),
                  "vae": (bundle.vae, standalone_vae_state_dict(load("vae"))),
                  "bert": (bundle.text.bert, bert_state_dict(load("clip"))),
                  "mt5": (bundle.text.mt5, CK.t5_encoder_state_dict(
                      load("mt5")))}
    else:
        groups = {"dit": (bundle.dit, pixart_from_diffusers(
            CK.load_safetensors(paths["ckpt"]))),
                  "vae": (bundle.vae, CK.component_state_dict(
                      CK.vae_state_dict_from_standalone(
                          CK.load_safetensors(paths["vae"])), CK.PREFIX_VAE))}
    return check_coded(f"{phase}_weights", quantize, groups)


def dit_kernel_calls(bundle, steps: int):
    """(K1, K2) launches of an SD3, PixArt or Hunyuan-DiT request from the
    module tree: each of the `steps` evaluations (the [uc; c] batch in one
    call) runs one K1 call per joint block (SD3), two per block (PixArt's
    and Hunyuan-DiT's self- and cross-attention) and one per attention
    pool (Hunyuan-DiT), and the one decode the VAE decoder's attention and
    GroupNorms (the text towers' causal or masked attention and T5's
    biased one take the plain path)."""
    from cremage_tpu_torch.models.hunyuan import AttentionPool, HunyuanBlock
    from cremage_tpu_torch.models.layers import GroupNorm
    from cremage_tpu_torch.models.mmdit import JointBlock
    from cremage_tpu_torch.models.pixart import PixArtBlock
    from cremage_tpu_torch.models.vae import AttnBlock

    dit = getattr(bundle, "mmdit", None) or bundle.dit
    per_eval = (count(dit, JointBlock) + 2 * count(dit, PixArtBlock)
                + 2 * count(dit, HunyuanBlock) + count(dit, AttentionPool))
    return (steps * per_eval + count(bundle.vae.decoder, AttnBlock),
            count(bundle.vae.decoder, GroupNorm))


def hunyuan_dp_calls(bundle, steps: int) -> dict:
    """K1 launches of a Hunyuan-DiT request by instantiation (padded head
    dim): each evaluation the blocks' two calls (d = 88, dp 96, at full
    width) and the pool's (d = 256), the decode the decoder's mid attention
    (d = 512)."""
    from cremage_tpu_torch.models.hunyuan import AttentionPool, HunyuanBlock
    from cremage_tpu_torch.models.vae import AttnBlock

    cfg, out = bundle.dit.cfg, {}

    def add(d, n):
        dp = -(-d // 16) * 16
        out[dp] = out.get(dp, 0) + n

    add(cfg.hidden_size // cfg.num_heads,
        2 * steps * count(bundle.dit, HunyuanBlock))
    add(cfg.mt5_dim // cfg.pooler_heads, steps * count(bundle.dit, AttentionPool))
    for m in bundle.vae.decoder.modules():
        if isinstance(m, AttnBlock):
            add(m.q.weight.shape[0], 1)
    return out


def check_dit_blocks(phase, dit, dev):
    """The first and the last block of a full-width DiT in bf16 through K1
    against the same weights in float32 through the plain versions, on
    the card, at the 1024^2 request's token counts: SD3's joint blocks
    (the last one's context stream pre-only) over [154; 4096] tokens,
    PixArt's blocks over 4096 tokens and 120 caption tokens, Hunyuan-DiT's
    over 4096 tokens, the 333 text tokens and the grid's RoPE table (the
    last one with its long skip)."""
    import copy

    import torch

    from cremage_tpu_torch.models.hunyuan import HunyuanBlock
    from cremage_tpu_torch.models.mmdit import JointBlock

    h = dit.cfg.hidden_size
    blocks = getattr(dit, "blocks", None) or dit.joint_blocks
    g = torch.Generator(device=dev).manual_seed(71)
    rows = []
    for name, blk in (("first", blocks[0]), ("last", blocks[-1])):
        x = torch.randn(1, 4096, h, device=dev, generator=g)
        keep = ()                     # arguments that stay float32
        if isinstance(blk, JointBlock):
            args = (torch.randn(1, 154, h, device=dev, generator=g), x,
                    torch.randn(1, h, device=dev, generator=g))
        elif isinstance(blk, HunyuanBlock):
            args = (x, torch.randn(1, 333, blk.cfg.clip_dim, device=dev,
                                   generator=g),
                    torch.randn(1, h, device=dev, generator=g),
                    dit.rope_table(64, 64, dev))
            if hasattr(blk, "skip_linear"):
                args += (torch.randn(1, 4096, h, device=dev, generator=g),)
            keep = (3,)
        else:
            args = (x, torch.randn(1, 120, h, device=dev, generator=g),
                    0.1 * torch.randn(1, 6, h, device=dev, generator=g))
            keep = (2,)
        ref = copy.deepcopy(blk).float()
        with torch.no_grad():
            got = blk(*[a if i in keep else a.bfloat16()
                        for i, a in enumerate(args)])
            with plain_kernels():
                want = ref(*args)
        got = [t for t in (got if isinstance(got, tuple) else (got,))
               if t is not None]
        want = [t for t in (want if isinstance(want, tuple) else (want,))
                if t is not None]
        rel = max(float((a.float() - b).abs().max() / b.abs().max())
                  for a, b in zip(got, want))
        rows.append(dict(block=name, max_rel_err=rel))
        del ref
    # as flux_blocks_bf16_vs_fp32: bf16 rounds each of the block's products
    # and residual adds to 2^-9 relative, and the errors add along it
    tol = 5e-2
    row = dict(phase=f"{phase}_blocks_bf16_vs_fp32", rows=rows, tol=tol)
    emit(row)
    if not all(r["max_rel_err"] <= tol for r in rows):
        raise AssertionError(f"{phase} blocks bf16 vs fp32: {rows}")
    return row


def check_patch_gemm(mmdit, dev):
    """The int8 patch embedding on the card (`_int_mm` over the 2x2
    patches) against its CPU branch on the same codes, at the 1024^2
    request's batch of 2 latents: 2^-6 of the largest output, as the
    int8 Linear's check in tests/test_torch_ops.py."""
    import copy

    import torch

    conv = mmdit.x_embedder.proj
    g = torch.Generator(device=dev).manual_seed(72)
    x = torch.randn(2, 16, SD3_RES // 8, SD3_RES // 8, device=dev,
                    generator=g).bfloat16()
    with torch.no_grad():
        got = conv(x).float().cpu()
        want = copy.deepcopy(conv).cpu()(x.cpu()).float()
    err = float((got - want).abs().max())
    tol = 2.0 ** -6 * float(want.abs().max())
    row = dict(phase="sd3_int8_patch_gemm", weight=str(conv.weight.dtype),
               shape=list(x.shape), max_abs_err=err, tol=tol)
    emit(row)
    if conv.weight.dtype != torch.int8 or not err <= tol:
        raise AssertionError(f"sd3 int8 patch GEMM: {row}")
    return row


def check_hunyuan_load(bundle, kind, dev, load):
    """A Hunyuan-DiT bundle as served from hunyuan_dir: both text branches
    loaded, the prompt's BERT and mT5 contexts finite and not zeros (their
    RMS into `load`); under int8 the patch embedding (22,528 elements,
    below the min size) still in the model's dtype, as JAX leaves it."""
    import torch

    text = bundle.text
    if text.bert is None or text.mt5 is None:
        raise AssertionError("hunyuan: a text branch did not load")
    clip, mt5 = text.encode(DIT_PROMPT, dev)
    load["text_rms"] = [float(t.pow(2).mean().sqrt()) for t in (clip, mt5)]
    if not all(bool(torch.isfinite(t).all()) for t in (clip, mt5)) \
            or min(load["text_rms"]) <= 0.0:
        raise AssertionError(f"hunyuan: text contexts {load['text_rms']}")
    patch = bundle.dit.x_embedder.proj.weight.dtype
    load["patch_weight"] = str(patch)
    if patch != bundle.dit.cfg.dtype:
        raise AssertionError(f"hunyuan {kind}: patch embedding in {patch}")


def dit_phase(phase, dev, card, root: Path, res, steps, requests, quantized,
              check_model=True):
    """The phase sd3, pixart or hunyuan: the family's files
    (write_sd3_file, write_pixart_files, write_hunyuan_files) under `root`,
    its job (SD3-medium's published settings, diffusers'
    PixArtSigmaPipeline defaults, or Hunyuan-DiT's served default sampler
    from a hunyuan_dir) through the --config server's /v1/generate: a
    warm-up of DIT_WARMUP_STEPS steps that loads, `requests` timed
    requests, one more with the shape hooks; then for each kind of
    `quantized` (dit_quantize) a warm-up that loads anew and one timed
    request. -> (rows, {path: (K1 shapes, K2 shapes)}, launches of the
    timed requests, their K1 launches by padded head dim)."""
    import gc

    import numpy as np
    import torch

    from cremage_tpu_torch.app.server import build_server

    gc.collect()
    torch.cuda.empty_cache()
    if phase == "sd3":
        model_type = "SD 3"
        paths, seconds = write_sd3_file(root, dev, sd3_configs())
        job = {"scale": SD3_CFG}
    elif phase == "hunyuan":
        model_type = "Hunyuan DiT"
        paths, seconds = write_hunyuan_files(root, dev, hunyuan_configs())
        job = {"scale": HUNYUAN_CFG, "sampler": HUNYUAN_SAMPLER,
               "hunyuan_dir": paths["dir"]}
    else:
        model_type = "PixArt-Sigma"
        paths, seconds = write_pixart_files(root, dev)
        job = {"scale": PIXART_CFG, "sampler": PIXART_SAMPLER,
               "vae_ckpt": paths["vae"]}
    rows = [dict(phase=f"{phase}_files", seconds=seconds,
                 bytes={k: os.path.getsize(v) for k, v in paths.items()
                        if os.path.isfile(v)})]
    emit(rows[0])
    job.update(prompt=DIT_PROMPT, negative_prompt=NEGATIVE, H=res, W=res,
               sampling_steps=steps, n_samples=1, n_iter=1,
               safety_check=False, watermark=False)
    srv = build_server(["--config", paths["config"], "--port", "0"])
    srv.start()
    client = Client(f"http://127.0.0.1:{srv.port}")
    finite, runs, shapes, loads = [], {}, {}, {}

    def resident():
        return srv.worker._backends[model_type].resident.instance.bundle

    def run(params, record=False):
        """-> (seconds, (K1, K2), images, finite decodes, shapes)."""
        finite.clear()
        reset_counts()
        with contextlib.ExitStack() as stack:
            rec = (stack.enter_context(recording(resident()))
                   if record else None)
            t1 = time.perf_counter()
            client.generate("text_to_image", params, model_type)
            out = served_images(client.drain(1))
            wall = time.perf_counter() - t1
        return wall, read_counts(), out, list(finite), rec and rec[:2]

    def load_row(kind, first):
        bundle = resident()
        loads[kind] = dict(
            first_run_seconds=first[0],
            resident_bytes=torch.cuda.memory_allocated(),
            quantize=bundle.load_report.get("quantize"),
            files={k: dict(v, gb_per_s=v["bytes"] / max(v["seconds"], 1e-9)
                           / 1e9)
                   for k, v in bundle.load_report["files"].items()})
        rows.append(check_dit_weights(phase, bundle, paths, kind))
        emit(rows[-1])
        if phase == "hunyuan":
            check_hunyuan_load(bundle, kind, dev, loads[kind])
        return bundle

    name = f"{phase} {res}^2"
    try:
        refused = expect_refused(client, dict(job, deep_cache=3),
                                 "an unported option", model_type)
        bundle = load_row("none", run(dict(job, sampling_steps=DIT_WARMUP_STEPS,
                                           seed=1)))
        hook = bundle.vae.decoder.register_forward_hook(
            lambda m, a, out: finite.append(bool(torch.isfinite(out).all())))
        finite.clear()
        reset_counts()
        t1 = time.perf_counter()
        for r in range(requests):
            client.generate("text_to_image", dict(job, seed=10 + r), model_type)
        served = served_images(client.drain(requests))
        wall = time.perf_counter() - t1
        launches, decodes = read_counts(), list(finite)
        by_dp = read_dp_counts()
        runs[name] = run(dict(job, seed=12), record=True)
        hook.remove()
        shapes[name] = runs[name][4]
        want = [requests * k for k in dit_kernel_calls(bundle, steps)]
        want_dp = ({dp: requests * n for dp, n in hunyuan_dp_calls(
            bundle, steps).items()} if phase == "hunyuan" else by_dp)
        if check_model:
            rows.append(check_dit_blocks(
                phase, getattr(bundle, "mmdit", None) or bundle.dit, dev))
        del bundle
        for kind in quantized:
            params = dict(job, dit_quantize=kind, seed=13)
            bundle = load_row(kind, run(dict(params,
                                             sampling_steps=DIT_WARMUP_STEPS)))
            if kind == "int8" and phase == "sd3":
                rows.append(check_patch_gemm(bundle.mmdit, dev))
            del bundle
            runs[f"{phase} {kind}"] = run(params)
    finally:
        srv.stop()
    held = srv.worker._backends[model_type].resident
    held.key = held.instance = None         # free the served bundle
    gc.collect()
    torch.cuda.empty_cache()
    stds = [float(np.std(p.astype(np.float32))) for p, _ in served]
    row = dict(phase=phase, card=card, steps=steps, res=res, batch=1,
               requests=requests, seconds=wall,
               flash_attention_launches_by_dp=by_dp,
               expected_flash_attention_by_dp=want_dp,
               seconds_per_request=wall / requests,
               images_per_s=len(served) / wall, loads=loads,
               images=[list(p.shape) for p, _ in served], pixel_std=stds,
               decodes_finite=decodes, refused=refused,
               flash_attention_launches=launches[0],
               group_norm_silu_launches=launches[1],
               expected_flash_attention=want[0],
               expected_group_norm_silu=want[1])
    emit(row)
    if len(served) != requests or any(p.shape != (res, res, 3)
                                      for p, _ in served) \
            or decodes != [True] * requests or min(stds) <= 0.0:
        raise AssertionError(f"{phase}: images {row['images']}, finite "
                             f"decodes {decodes}, pixel std {stds}")
    if "NotImplementedError" not in (refused or ""):
        raise AssertionError(f"{phase}: deep_cache not refused: {refused}")
    if tuple(launches) != tuple(want) or by_dp != want_dp:
        raise AssertionError(f"{phase}: kernel launches {launches} (by dp "
                             f"{by_dp}) != derived {want} ({want_dp})")
    rows.append(row)
    for rname, (sec, (k1, k2), imgs, fin, rec) in runs.items():
        r = dict(phase=f"{phase}_request", request=rname, card=card,
                 seconds=sec, images=[list(p.shape) for p, _ in imgs],
                 pixel_std=[float(np.std(p.astype(np.float32)))
                            for p, _ in imgs],
                 decodes_finite=fin, flash_attention_launches=k1,
                 group_norm_silu_launches=k2,
                 expected_flash_attention=want[0] // requests,
                 expected_group_norm_silu=want[1] // requests)
        if rec is not None:
            r["recorded_calls"] = [sum(rec[0].values()), sum(rec[1].values())]
        emit(r)
        if len(imgs) != 1 or imgs[0][0].shape != (res, res, 3) \
                or min(r["pixel_std"]) <= 0.0 or (fin and fin != [True]):
            raise AssertionError(f"{rname}: {r}")
        if (k1, k2) != (r["expected_flash_attention"],
                        r["expected_group_norm_silu"]) or (
                rec is not None and tuple(r["recorded_calls"]) != (k1, k2)):
            raise AssertionError(f"{rname}: kernel launches {(k1, k2)}, "
                                 f"derived {want}, recorded "
                                 f"{r.get('recorded_calls')}")
        rows.append(r)
    return rows, shapes, launches, by_dp


KANDINSKY_RES, KANDINSKY_STEPS, KANDINSKY_REQUESTS = 768, 50, 2
KANDINSKY_CFG = 4.0          # diffusers' KandinskyV22 pipelines' default
KANDINSKY_FILES_GB = 14      # free disk the 6.5 GB of files need, with room
KANDINSKY_CODEBOOK = 16384   # MoVQ's codebook entries (num_vq_embeddings)


def kandinsky_configs():
    """Kandinsky 2.2's published widths and depths: the prior (20 layers of
    2048 over 77 + 4 tokens), the decoder UNet ((384, 768, 1152, 1536), 3
    layers a block, 64-wide heads, 10 context tokens of 768), MoVQ ((128,
    256, 256, 512)) and the bigG text tower, in bf16."""
    import torch

    from cremage_tpu_torch.models.kandinsky import PriorConfig
    from cremage_tpu_torch.models.kandinsky_decoder import KandinskyUNetConfig
    from cremage_tpu_torch.models.open_clip import openclip_bigg_config
    from cremage_tpu_torch.models.vq import MoVQConfig

    bf16 = torch.bfloat16
    return dict(prior=PriorConfig(dtype=bf16),
                decoder=KandinskyUNetConfig(dtype=bf16),
                movq=MoVQConfig(dtype=bf16), text=openclip_bigg_config(dtype=bf16))


def diffusers_prior_key(key: str, shape):
    """(diffusers PriorTransformer key, shape) of a key of the port's
    DiffusionPrior, the inverse of io/diffusers_keys.py
    `kandinsky_prior_from_diffusers` (the position table is (1, N, C)
    there)."""
    from cremage_tpu_torch.io import diffusers_keys as DK

    if key == "positional_embedding":
        return key, (1,) + tuple(shape)
    if key.startswith("blocks."):
        i, rest = key[len("blocks."):].split(".", 1)
        theirs, ours = next(p for p in DK._KP_BLOCK if rest.startswith(p[1]))
        return f"transformer_blocks.{i}.{theirs}{rest[len(ours):]}", tuple(shape)
    theirs, ours = next(p for p in DK._KP_TOP if key.startswith(p[1]))
    return theirs + key[len(ours):], tuple(shape)


def write_kandinsky_files(root: Path, dev, cfgs: dict):
    """Kandinsky 2.2's four component files as a kandinsky_dir holds them,
    from seeded random fp16 tensors under `root`: prior.safetensors
    (diffusers' PriorTransformer, with clip_mean and clip_std),
    decoder.safetensors (diffusers' UNet2DConditionModel with its
    add_embedding and encoder_hid_proj image heads), text_encoder.safetensors
    (HF's CLIPTextModelWithProjection of bigG) and movq.safetensors
    (diffusers' VQModel: the decoder, post_quant_conv, the codebook and an
    encoder and quant_conv, which the loader drops by name); a config.yaml
    with no model (a Kandinsky job names its files). Refuses to start
    without KANDINSKY_FILES_GB of free disk. -> (paths, {file: seconds})."""
    import torch

    from cremage_tpu_torch.io.diffusers_keys import KANDINSKY_HEADS
    from cremage_tpu_torch.models.kandinsky import (
        DiffusionPrior, KandinskyImageConditioner,
    )
    from cremage_tpu_torch.models.kandinsky_decoder import KandinskyUNet
    from cremage_tpu_torch.models.open_clip import OpenCLIPTextModel
    from cremage_tpu_torch.models.vae import Encoder, VAEConfig
    from cremage_tpu_torch.models.vq import MoVQ

    root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root).free / 1e9
    if free < KANDINSKY_FILES_GB:
        raise RuntimeError(f"kandinsky: {free:.1f} GB free under {root}, the "
                           f"files need {KANDINSKY_FILES_GB} GB")
    pcfg, dcfg, mcfg = cfgs["prior"], cfgs["decoder"], cfgs["movq"]
    prior = dict(diffusers_prior_key(k, v)
                 for k, v in meta_shapes(DiffusionPrior, pcfg).items())
    g = torch.Generator().manual_seed(94)
    stats = {"clip_mean": 0.1 * torch.randn(1, pcfg.image_embed_dim, generator=g),
             "clip_std": 0.5 + torch.rand(1, pcfg.image_embed_dim, generator=g)}
    decoder = meta_shapes(KandinskyUNet, dcfg)
    with torch.device("meta"):
        heads = KandinskyImageConditioner(
            pcfg.image_embed_dim, dcfg.time_embed_dim, dcfg.context_dim)
    for k, v in heads.state_dict().items():
        theirs, ours = next(p for p in KANDINSKY_HEADS if k.startswith(p[1]))
        decoder[theirs + k[len(ours):]] = tuple(v.shape)
    text = {hf_openclip_key(k): v for k, v in
            meta_shapes(OpenCLIPTextModel, cfgs["text"]).items()}
    movq = meta_shapes(MoVQ, mcfg)
    movq.update(dict(diffusers_vae_key("encoder." + k, v) for k, v in
                     meta_shapes(Encoder, VAEConfig(
                         ch_mult=(1, 2, 2, 4))).items()))
    movq.update({"quant_conv.weight": (4, 4, 1, 1), "quant_conv.bias": (4,),
                 "quantize.embedding.weight": (KANDINSKY_CODEBOOK, 4)})
    paths = {k: root / f"{k}.safetensors"
             for k in ("prior", "decoder", "text_encoder", "movq")}
    paths["config"] = root / "config.yaml"
    paths["config"].write_text("# Kandinsky 2.2 jobs name their files\n")
    seconds = {
        "prior": write_seeded_safetensors(paths["prior"], prior, dev, 95,
                                          extra=stats, dtype="F16"),
        "decoder": write_seeded_safetensors(paths["decoder"], decoder, dev, 96,
                                            dtype="F16"),
        "text_encoder": write_seeded_safetensors(
            paths["text_encoder"], text, dev, 97,
            tables=("token_embedding",), dtype="F16"),
        "movq": write_seeded_safetensors(paths["movq"], movq, dev, 98,
                                         dtype="F16")}
    out = {k: str(v) for k, v in paths.items()}
    out["dir"] = str(root)
    return out, seconds


def check_kandinsky_weights(bundle, paths):
    """check_coded over a Kandinsky bundle's five models and their files."""
    from cremage_tpu_torch.io import checkpoint as CK
    from cremage_tpu_torch.io.diffusers_keys import (
        kandinsky_decoder_from_diffusers, kandinsky_prior_from_diffusers,
        movq_decoder_from_diffusers,
    )
    from cremage_tpu_torch.pipelines.loader import hf_text_tower_state_dict

    def load(key):
        return CK.load_safetensors(paths[key])

    prior = kandinsky_prior_from_diffusers(load("prior"))
    body, heads = kandinsky_decoder_from_diffusers(load("decoder"))
    row = check_coded("kandinsky_weights", None, {
        "prior": (bundle.prior, prior), "decoder": (bundle.decoder, body),
        "image_cond": (bundle.image_cond, heads),
        "text": (bundle.text.tower, hf_text_tower_state_dict(
            load("text_encoder"))),
        "movq": (bundle.movq, movq_decoder_from_diffusers(load("movq")))})
    for k in ("clip_mean", "clip_std"):
        if not bool((getattr(bundle, k).cpu() == prior[k].float().reshape(-1)
                     ).all()):
            raise AssertionError(f"kandinsky: {k} differs from its file")
    return row


def kandinsky_kernel_calls(bundle, steps: int):
    """(K1, K2) launches of a Kandinsky 2.2 request from the module tree:
    each of the `steps` decoder evaluations (the [uc; c] batch in one call)
    runs one K1 call per added-KV attention (22 at full width: 9 down, 1
    mid, 12 up) and every GroupNorm of the UNet, the MoVQ decode its mid
    attention and every SpatialNorm's GroupNorm (the prior's causal
    attention and the text tower's take the plain path)."""
    from cremage_tpu_torch.models.kandinsky_decoder import AddedKVAttention
    from cremage_tpu_torch.models.layers import GroupNorm
    from cremage_tpu_torch.models.vq import MoVQAttention

    return (steps * count(bundle.decoder, AddedKVAttention)
            + count(bundle.movq, MoVQAttention),
            steps * count(bundle.decoder, GroupNorm)
            + count(bundle.movq, GroupNorm))


def check_kandinsky_decoder(bundle, dev, res=KANDINSKY_RES):
    """One full-width decoder UNet evaluation at the 768^2 latent, the CFG
    batch of 2 (its context and time vector from the image conditioner on
    seeded embeddings), in bf16 through the kernels against the same
    weights in float32 through the plain versions, both on the card."""
    import torch

    from cremage_tpu_torch.models.kandinsky_decoder import KandinskyUNet

    unet = bundle.decoder
    with torch.device("meta"):
        ref = KandinskyUNet(dataclasses.replace(unet.cfg, dtype=torch.float32))
    ref.load_state_dict({k: v.float() for k, v in unet.state_dict().items()},
                        assign=True)
    g = torch.Generator(device=dev).manual_seed(27)
    lat = res // 8
    x = torch.randn(2, lat, lat, 4, device=dev, generator=g)
    t = torch.tensor([500.0, 500.0], device=dev)
    emb = torch.randn(2, bundle.prior.cfg.image_embed_dim, device=dev,
                      generator=g)
    with torch.no_grad():
        tvec, ctx = bundle.image_cond(emb)
        got = unet(x, t, ctx, tvec).float()
        with plain_kernels():
            want = ref.eval()(x, t, ctx.float(), tvec.float())
    rel = float((got - want).abs().max() / want.abs().max())
    rel_l2 = float((got - want).norm() / want.norm())
    # bf16 rounds each layer's output to 2^-9 relative and the errors add
    # up along the residual stream, as for SD1.5's UNet (unet_full_width)
    tol = 5e-2
    row = dict(phase="kandinsky_decoder_full_width", shape=[2, lat, lat, 4],
               max_rel_err=rel, rel_l2_err=rel_l2, tol=tol,
               finite=bool(torch.isfinite(got).all()))
    emit(row)
    del ref, want
    torch.cuda.empty_cache()
    if not (row["finite"] and rel <= tol):
        raise AssertionError(f"kandinsky decoder: max relative error {rel} > "
                             f"{tol}")
    return row


def kandinsky(dev, card, root: Path, res=KANDINSKY_RES, steps=KANDINSKY_STEPS,
              requests=KANDINSKY_REQUESTS, check_model=True):
    """The phase kandinsky: the four component files (write_kandinsky_files)
    under `root`, the job (768^2, 50 decoder steps of the served default,
    "DDIM" -> Euler A, the prior's 25, CFG 4.0, batch 1) through the
    --config server's /v1/generate naming kandinsky_dir: a warm-up of
    DIT_WARMUP_STEPS steps that loads, `requests` timed requests, one more
    with the shape hooks, one traced by torch.profiler (utils/profile_sd15.py
    `trace`: the idle share), then one timed inpainting request on an
    uploaded image and mask; img2img and an unported option refused. ->
    (rows, {path: (K1 shapes, K2 shapes)}, launches of the timed txt2img
    requests)."""
    import gc

    import numpy as np
    import torch

    from cremage_tpu_torch.app.server import build_server
    from cremage_tpu_torch.core.config import GenerationOptions
    from cremage_tpu_torch.io.png import encode_png
    from cremage_tpu_torch.utils.profile_sd15 import trace

    gc.collect()
    torch.cuda.empty_cache()
    model_type = "Kandinsky 2.2"
    paths, seconds = write_kandinsky_files(root, dev, kandinsky_configs())
    rows = [dict(phase="kandinsky_files", seconds=seconds,
                 bytes={k: os.path.getsize(v) for k, v in paths.items()
                        if os.path.isfile(v)})]
    emit(rows[0])
    job = dict(prompt=DIT_PROMPT, negative_prompt=NEGATIVE, H=res, W=res,
               sampling_steps=steps, n_samples=1, n_iter=1, scale=KANDINSKY_CFG,
               safety_check=False, watermark=False, kandinsky_dir=paths["dir"])
    srv = build_server(["--config", paths["config"], "--port", "0"])
    srv.start()
    client = Client(f"http://127.0.0.1:{srv.port}")
    finite, runs, shapes = [], {}, {}
    init, mask = test_image(res)

    def resident():
        return srv.worker._backends[model_type].resident.instance

    def run(params, mode="text_to_image", record=False):
        """-> (seconds, (K1, K2), images, finite decodes, shapes)."""
        finite.clear()
        reset_counts()
        with contextlib.ExitStack() as stack:
            rec = (stack.enter_context(recording(resident().bundle))
                   if record else None)
            t1 = time.perf_counter()
            client.generate(mode, params, model_type)
            out = served_images(client.drain(1))
            wall = time.perf_counter() - t1
        return wall, read_counts(), out, list(finite), rec and rec[:2]

    name = f"kandinsky {res}^2"
    try:
        refused = expect_refused(client, dict(job, deep_cache=3),
                                 "an unported option", model_type)
        up = {k: client.call("/v1/upload", {
            "image": base64.b64encode(encode_png(a)).decode()})["path"]
            for k, a in (("init_img", init), ("mask_img", mask))}
        first = run(dict(job, sampling_steps=DIT_WARMUP_STEPS, seed=1))
        bundle = resident().bundle
        load = dict(first_run_seconds=first[0],
                    resident_bytes=torch.cuda.memory_allocated(),
                    files={k: dict(v, gb_per_s=v["bytes"] / max(v["seconds"],
                                                                1e-9) / 1e9)
                           for k, v in bundle.load_report["files"].items()})
        rows.append(check_kandinsky_weights(bundle, paths))
        emit(rows[-1])
        client.generate("image_to_image", dict(job, init_img=up["init_img"]),
                        model_type)
        img2img = None
        try:
            client.drain(1)
        except RuntimeError as e:
            img2img = str(e)
        hook = bundle.movq.decoder.register_forward_hook(
            lambda m, a, out: finite.append(bool(torch.isfinite(out).all())))
        finite.clear()
        reset_counts()
        t1 = time.perf_counter()
        for r in range(requests):
            client.generate("text_to_image", dict(job, seed=10 + r), model_type)
        served = served_images(client.drain(requests))
        wall = time.perf_counter() - t1
        launches, decodes = read_counts(), list(finite)
        runs[name] = run(dict(job, seed=12), record=True)
        shapes[name] = runs[name][4]
        opts = GenerationOptions.from_dict(dict(job, seed=13))
        traced = trace(lambda: resident().generate(opts))
        traced.pop("top_kernels_s")
        runs[f"{name} inpainting"] = run(dict(job, seed=14, **up),
                                         mode="inpainting", record=False)
        hook.remove()
        want = [requests * k for k in kandinsky_kernel_calls(bundle, steps)]
        if check_model:
            rows.append(check_kandinsky_decoder(bundle, dev, res))
        del bundle
    finally:
        srv.stop()
    held = srv.worker._backends[model_type].resident
    held.key = held.instance = None         # free the served bundle
    gc.collect()
    torch.cuda.empty_cache()
    stds = [float(np.std(p.astype(np.float32))) for p, _ in served]
    inpainted = runs[f"{name} inpainting"][2][0][0]
    keep = mask[..., 0] < 128
    row = dict(phase="kandinsky", card=card, steps=steps, prior_steps=25,
               res=res, batch=1, requests=requests, seconds=wall,
               seconds_per_request=wall / requests,
               images_per_s=len(served) / wall, load=load, traced=traced,
               images=[list(p.shape) for p, _ in served], pixel_std=stds,
               decodes_finite=decodes, refused=refused, img2img=img2img,
               inpainting_unmasked_equal=bool(
                   (inpainted[keep] == init[keep]).all()),
               flash_attention_launches=launches[0],
               group_norm_silu_launches=launches[1],
               expected_flash_attention=want[0],
               expected_group_norm_silu=want[1])
    emit(row)
    if len(served) != requests or any(p.shape != (res, res, 3)
                                      for p, _ in served) \
            or decodes != [True] * requests or min(stds) <= 0.0:
        raise AssertionError(f"kandinsky: images {row['images']}, finite "
                             f"decodes {decodes}, pixel std {stds}")
    if "NotImplementedError" not in (refused or "") \
            or "latent encoder" not in (img2img or ""):
        raise AssertionError(f"kandinsky: refusals {refused}, {img2img}")
    if not row["inpainting_unmasked_equal"]:
        raise AssertionError("kandinsky: inpainting moved unmasked pixels")
    if tuple(launches) != tuple(want):
        raise AssertionError(f"kandinsky: kernel launches {launches} != "
                             f"derived {want}")
    rows.append(row)
    for rname, (sec, (k1, k2), imgs, fin, rec) in runs.items():
        r = dict(phase="kandinsky_request", request=rname, card=card,
                 seconds=sec, images=[list(p.shape) for p, _ in imgs],
                 pixel_std=[float(np.std(p.astype(np.float32)))
                            for p, _ in imgs],
                 decodes_finite=fin, flash_attention_launches=k1,
                 group_norm_silu_launches=k2,
                 expected_flash_attention=want[0] // requests,
                 expected_group_norm_silu=want[1] // requests)
        if rec is not None:
            r["recorded_calls"] = [sum(rec[0].values()), sum(rec[1].values())]
        emit(r)
        if len(imgs) != 1 or imgs[0][0].shape != (res, res, 3) \
                or min(r["pixel_std"]) <= 0.0 or fin != [True]:
            raise AssertionError(f"{rname}: {r}")
        if (k1, k2) != (r["expected_flash_attention"],
                        r["expected_group_norm_silu"]) or (
                rec is not None and tuple(r["recorded_calls"]) != (k1, k2)):
            raise AssertionError(f"{rname}: kernel launches {(k1, k2)}, "
                                 f"derived {want}, recorded "
                                 f"{r.get('recorded_calls')}")
        rows.append(r)
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


def instantiation_entry(dp, rows, path, launches):
    """One K1 instantiation (padded head dim `dp`) on `path`: its rows'
    per-request totals over that path's shapes, as kernel_entry's, and the
    launches one request of the path counted for it."""
    mine = [r for r in rows if f"Plan<{dp}," in r["instantiation"]
            and path in r["calls_by_path"]]
    if not mine:
        raise AssertionError(f"no K1 row at dp = {dp} on {path}")

    def total(key):
        return sum(r[key] * r["calls_by_path"][path] for r in mine)

    return dict(name=f"flash_attention[dp={dp}]", route="cuda",
                source="cremage_tpu_torch/csrc/flash_attention.cu",
                replaces="cremage_tpu/ops/flash_attention.py:94",
                launches=launches, path=path,
                shapes=[r["shape"] for r in mine],
                instantiations=sorted({r["instantiation"] for r in mine}),
                max_abs_err=max(r["max_abs_err"] for r in mine),
                max_err_over_tol=max(r["max_abs_err"] / r["tol"] for r in mine),
                ms=total("ms"), dispatch_ms=total("dispatch_ms"),
                plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
                bound_by="operations" if total("flops_ms") > total("bytes_ms")
                else "bytes",
                library_ms=total("library_ms"),
                calls_per_request=sum(r["calls_by_path"][path] for r in mine))


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
        _, sdxl_paths, sdxl_launches, sdxl_files = sdxl(dev, card, sdxl_root)
        paths.update(sdxl_paths)
        torch.cuda.empty_cache()
        watchdog("sdxl_modes")
        _, xl_mode_paths, xl_mode_launches = sdxl_modes(dev, card, sdxl_root,
                                                        sdxl_files)
    finally:
        shutil.rmtree(sdxl_root, ignore_errors=True)
    paths.update(xl_mode_paths)
    torch.cuda.empty_cache()
    watchdog("flux")
    flux_root = REPO / "build" / "flux"
    try:
        _, flux_paths, flux_launches = flux(dev, card, flux_root)
    finally:
        shutil.rmtree(flux_root, ignore_errors=True)
    paths.update(flux_paths)
    torch.cuda.empty_cache()
    watchdog("svd")
    svd_root = REPO / "build" / "svd"
    try:
        _, svd_paths, svd_launches = svd(dev, card, svd_root)
    finally:
        shutil.rmtree(svd_root, ignore_errors=True)
    paths.update(svd_paths)
    dit_launches, by_dp = {}, {}
    for phase, res, steps, requests, quantized in (
            ("sd3", SD3_RES, SD3_STEPS, SD3_REQUESTS, ("float8_e4m3", "int8")),
            ("pixart", PIXART_RES, PIXART_STEPS, PIXART_REQUESTS,
             ("float8_e4m3",)),
            ("hunyuan", HUNYUAN_RES, HUNYUAN_STEPS, HUNYUAN_REQUESTS,
             ("float8_e4m3", "int8"))):
        torch.cuda.empty_cache()
        watchdog(phase)
        dit_root = REPO / "build" / phase
        try:
            _, dit_paths, dit_launches[phase], by_dp[phase] = dit_phase(
                phase, dev, card, dit_root, res, steps, requests, quantized)
        finally:
            shutil.rmtree(dit_root, ignore_errors=True)
        paths.update(dit_paths)
    torch.cuda.empty_cache()
    watchdog("kandinsky")
    kandinsky_root = REPO / "build" / "kandinsky"
    try:
        _, kandinsky_paths, kandinsky_launches = kandinsky(dev, card,
                                                           kandinsky_root)
    finally:
        shutil.rmtree(kandinsky_root, ignore_errors=True)
    paths.update(kandinsky_paths)
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
                "sdxl": sdxl_launches[key.startswith("group")],
                "sdxl_modes": xl_mode_launches[key.startswith("group")],
                "flux": flux_launches[key.startswith("group")],
                "svd": svd_launches[key.startswith("group")],
                **{p: n[key.startswith("group")]
                   for p, n in dit_launches.items()},
                "kandinsky": kandinsky_launches[key.startswith("group")]}

    all_k1 = list(k1_rows.values()) + list(new_k1.values())
    hunyuan_path = f"hunyuan {HUNYUAN_RES}^2"
    emit({"kernels": [
        kernel_entry("flash_attention", "cremage_tpu_torch/csrc/flash_attention.cu",
                     "cremage_tpu/ops/flash_attention.py:94", all_k1,
                     launches["flash_attention"],
                     by_phase("flash_attention_launches")),
        *(instantiation_entry(dp, all_k1, hunyuan_path,
                              by_dp["hunyuan"][dp] // HUNYUAN_REQUESTS)
          for dp in (96, 256)),
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
