#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``eelunet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; none is skipped):

1. A CUDA card is present; print ``nvidia-smi``'s name and power limit.
2. Build the CUDA kernels from ``eelunet_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source, all started together; print the build time
   and ptxas' register report, and, where the toolkit has ``cuobjdump``,
   the count of tensor-core instructions (HMMA/HGMMA) in the SASS of the
   five tensor-core kernels (kernel 1, ``contract_kernel_tc``; kernel 2,
   ``expand_kernel_tc``; kernel 3, ``bwd_contract_kernel_tc``; kernel 4,
   ``bwd_expand_kernel_tc``; kernel 6, ``conv3x3_kernel_tc``), which must be
   above 0 for every K of kernels 1-4 and both types of kernel 6.
3. The forward kernels against their plain PyTorch twins at the serving
   path's two high-pass sites, (16,256,256,128) and (16,512,512,64), m = 20,
   in float32 (TF32 off) and bfloat16: contract and expand alone, then the
   whole high-pass, and the whole float32 op against the torch.fft golden
   path. Errors are relative to max|reference|: <= 1e-4 in float32,
   <= 2e-2 in bfloat16. Kernel, twin and library times come from CUDA
   events; each kernel's bound is computed from its shapes and printed with
   the kernel's share of it, and beside it the floor of the arithmetic the
   kernel does (its products at the peak of their type). Kernel 1 is timed
   in turns with its yardstick,
   one ``torch.bmm`` that writes T in f32 (kernel, bmm, bmm, kernel).
3b. The backward kernels against their twins at the training path's sites,
   (8,256,256,128) and (8,512,512,64), m = 20, in float32 and bfloat16:
   kernel 3 (u_re, T) and kernel 4 (dx) alone, then the whole Function's
   gradient against autograd through the plain low-rank op. Kernel 4 is
   timed in turns with an f32 ``torch.baddbmm`` (TF32 on for that call in
   bfloat16, as the kernel's arithmetic) and, in bfloat16, with a bf16 one.
3c. Kernel 5 (the Canny stencil) against its twin in both modes at the
   Canny path's site, (8,512,512,1) float32 grayscale of seeded blob images:
   the share of pixels that disagree and, in mode ``improve``, the max |d|
   of the NMS magnitude. Its time by a host loop of wrapper calls and, as
   device time, by replays of a CUDA graph of 20 launches (the 8 MB image
   and output stay in the 50 MB L2 between them, as they do in the chain,
   whose grayscale was just written). The hysteresis kernel (the fixpoint
   behind mode ``improve``) on that site's NMS output, equal bit for bit to
   the plain loop ``hysteresis_fixpoint``, its rounds beside the loop's
   steps. Kernel 6 (the 3x3 conv, tensor cores: bf16, and bf16x6 in
   float32) against its twin (cuDNN in float32, TF32 off) in bfloat16 and
   float32 at (8,512,512,128) -> 64 and (8,512,512,64) -> 64, by relative
   L2, timed in turns (kernel, cuDNN, cuDNN, kernel) with one cuDNN call of
   the same function on channels_last operands of its type, TF32 off (its
   ``library_ms``), beside its bound and the floor of its arithmetic.
4. Serve through the entry point a user runs: a seeded random-init EELUnet
   (full width, 26.26M params) is written as an upstream-layout .npz, and
   ``python -m eelunet_tpu_torch.cli.serve ... --image_size 512 --set
   model.dtype=bfloat16 --max_batch 16`` answers concurrent uint8 .npy
   requests (probabilities and ?output=mask), one pre-batched request and
   one PNG. The server's launch counts start at 0 and must end at exactly 2
   per forward for each forward kernel.
5. In-process, the same weights at 512^2 batch 16: both forward kernels
   launch exactly twice per forward; the kernel path agrees with the plain
   path (float32 at batch 2, bfloat16 at batch 16, bounds printed); the
   forward time per batch is printed beside its reading with kernels 2
   and 3 on CUDA cores.
6. In-process training at full width, 512^2, batch 8, bf16 autocast on f32
   weights, seeded synthetic batches, 6 steps of the port's train step: each
   of the four kernels launches exactly twice per step and the loss stays
   finite. One step on the kernels and one on ``highpass_impl="lowrank"``,
   from the same state, agree on loss and gradient norm (float32 at batch 2
   and bfloat16 at batch 8, bounds printed). The step time of both paths
   (CUDA events, warm, in turns), img/s and the peak memory are printed,
   the step time beside its reading with kernels 2 and 3 on CUDA cores.
7. Train through the entry point a user runs: ``python -m
   eelunet_tpu_torch.cli.train --model_type eelunet --image_size 512
   --batch_size 8 --set model.dtype=bfloat16 --epochs 2`` on a synthetic
   tree of 24/8 images, in a subprocess; check the history, the best tags
   and ``last``, the run's kernel launches, and serve the ``best`` tag
   through the Predictor on the card.
9. The Canny path: in-process, the device-side input chain once under
   ``torch.cuda.set_sync_debug_mode("error")`` (it reads nothing back to
   the host), then the train step at 512^2 b8 bf16 with
   ``data.add_canny_edge`` and ``data.canny_enhance`` (4 input channels)
   behind the chain, timed against phase 6's step, with the chain's time,
   the eval step's time with the chain and fed pre-made inputs, and the
   hysteresis kernel's rounds per pass. Then
   ``python -m eelunet_tpu_torch.cli.train`` with both flags for 2 epochs on
   phase 7's tree and ``python -m eelunet_tpu_torch.cli.evaluate`` on its
   best tag: kernel 5 and the hysteresis kernel launch twice per batch in
   both runs, kernels 1-4 as in phase 7, and the evaluation prints the
   metrics the training run recorded for that tag.
10. The other families, each at its published width from seeded random
   weights (random BN statistics): ``unet``, ``unet++``, ``unext``,
   ``unext_s``, ``egeunet`` and ``malunet``. For each, its parameter count
   against the reference's (U-Net++ printed only); the served forward at
   512^2 batch 16, bf16, BN folded where the family folds, channels_last:
   finite, of the right shape, within a printed bound of the same weights
   in float32 unfolded on the card, and its time by CUDA events; three
   train steps at 512^2 batch 8, bf16 autocast, on the family's ``auto``
   loss, after one warm step: finite losses, ms per step, peak memory. No
   hand-written kernel launches on these paths. Then EGE-UNet through
   ``cli.train`` with ``data.add_canny_edge`` and ``data.canny_enhance`` for
   2 epochs on phase 7's tree and ``cli.evaluate`` on its best tag (kernel 5 and the hysteresis
   twice per batch; the metrics equal the training run's), and UNeXt-S
   through ``cli.serve`` from an upstream-layout .npz, answering a few
   requests. The phase prints its time.
11. Multi-class and the rest of the feed, on a 3-class EELUnet
   (background and two classes): (11a) its train step in-process at 512^2
   b8 bf16 on ``edge_ce_dice`` (ms, peak memory, 2 launches per step of
   kernels 1-4; one step on the kernels against ``lowrank`` at phase 6's
   bounds, its float32 leaves anchored to the float64 step, see
   F64_LEAF_SHARE); (11b) ``cli.pack --multiclass`` on a 24/8 synthetic
   3-class tree, then ``cli.train`` with both Canny flags for 2 epochs on
   the PNG tree and on the pack with ``data.device_cache`` and
   ``profile_steps=2``: the first batch of each epoch byte-equal, the
   per-epoch losses within the spread of two identical streamed fits run
   in-process (whose every background snapshot must equal the state at its
   epoch), a trace with CUDA kernel records; (11c) ``cli.evaluate`` with
   the flags: the training run's metrics, kernel 5 launching, the per-class
   table; (11d) ``cli.predict``: phase 9's binary tag in resize mode with
   TTA and both flags, masks equal to ``Predictor.predict`` on the same
   chain, and the 3-class tag tiled (512, overlap 64) on 700x1000 images,
   masks of their size with ids in [0, 3), and the throughput of both;
   (11e) ``cli.serve`` with the 3-class tag, one mask request equal to the
   Predictor's argmax. Its launches join the JSON line's.
12. The compression and deployment path on the full-width EELUnet at 512^2:
   (12a) group masks at amounts 0.3 and 0.5 (``round_to`` 32), the slice,
   and each slim model against its masked model on the card (float32 b2 at
   JAX's slice bound, bf16 b16 at phase 10's bounds), kernels 1 and 2 twice
   per slim forward; kernels 1-4 against their twins at the slim high-pass
   sites (C = 96 at 256^2, C = 32 at 512^2; kernels 1 and 4 in turns with
   their yardsticks); the served forwards in turns, unfolded and folded;
   (12b) ``cli.prune --physical`` (one finetune epoch) on phase 7's best
   tag and tree: its launches, every masked channel still zero, the slim
   checkpoint, then ``cli.evaluate`` on it (the slim metrics cli.prune
   printed) and ``cli.serve`` on it (one request, equal to the slim
   Predictor); (12c) ``Predictor(quantize="int8")`` at b16: its op counts
   equal the CPU's, probabilities within 0.1 of bf16, one eligible conv's
   int product through im2col and ``torch._int_mm`` equal to the float64
   twin, with its breakdown, and both Predictors timed in turns; (12d)
   ``cli.export`` (buckets 1 and 8), ``cli.serve --artifact`` answering a
   batch of 3 equal to the Predictor on the low-rank high-pass, the
   artifact timed beside it, and an int8 artifact at bucket 1 equal to the
   int8 Predictor. Its entry points' launches join the JSON line's.
13. Data parallelism, with ``torch.cuda.device_count()`` printed: (13a)
   two ranks over gloo on card 0, spawned from here (full-width EELUnet,
   512^2, bf16 autocast, global batch 8 = 4 per rank, phase 6's batches):
   one DDP step from the state of a single-process b8 step, loss and
   gradient norm within GRAD_TOL of it and the BN running statistics within
   DDP_STATS_TOL, two more steps and one step of the Canny model with both
   flags; each rank's launches (kernels 1-4 twice per step, kernel 5 and
   the hysteresis twice per batch) and step time, two processes sharing a
   card (no scaling figure); (13b) ``torchrun --standalone
   --nproc_per_node=<cards> -m eelunet_tpu_torch.cli.train`` (NCCL) for 2
   epochs on phase 7's tree and ``cli.evaluate`` under the same launcher on
   its best tag: the recorded metrics (one rank on a one-card machine);
   (13c) ``Predictor(mesh=create_mesh(-1, 1))`` over every card and a mesh
   listing card 0 twice, at b16 and a ragged b13, against the single-device
   Predictor at phase 10's bounds, kernels 1 and 2 launching twice per
   shard, then ``cli.serve --set mesh.data_axis=-1`` answering requests.
   Where only one card is present it says that launches across two
   physical cards are not verified. Its launches join the JSON line's.

The line before the last holds the kernels' JSON record, the one before it
the card's name and power limit, and the one before that the hysteresis
kernel's (not a TPU kernel's) time, check and launches; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

SITES = ((16, 256, 256, 128), (16, 512, 512, 64))
TRAIN_SITES = ((8, 256, 256, 128), (8, 512, 512, 64))
MASK_RANGE = 20
SEED = 0
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # relative to max|reference|
# In-process model comparison, kernel path vs plain path (max |d prob|):
# float32 differs by summation order only; bfloat16 by where each path
# rounds the high-pass output to bf16, carried through the edge decoder.
MODEL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# Whole-Function gradient vs autograd through the plain low-rank op, as
# ||d|| / ||reference|| (max|d| is printed too). float32: the same adjoint
# factored differently. bfloat16: the kernel path contracts with V_H in bf16,
# as the JAX kernels do (fft_pallas.py:194), the low-rank op in f32; that
# moves the low-pass by ~0.3%, and where |z| is that small the direction
# z/|z| of u turns, so single pixels differ by up to ~20% of the maximum
# while the whole gradient differs by ~0.5% (CPU, 128^2 to 256^2).
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Backward kernels vs their twins, ||d|| / ||reference|| for u_re and dx:
# u = g z/|z| turns with f32 summation order where |z| is near 0, so one
# pixel in 1e8 can differ by a percent of max|u| in float32; the norm is
# what a bug moves. bfloat16 adds one rounding of u and of dx. T, a sum over
# H, is held to max|d| relative to max|T| <= 1e-4 in both types.
BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# One train step, kernel path vs low-rank path from the same state: relative
# difference of the loss and of the gradient's global norm. float32 differs
# by summation order; bfloat16 also by the bf16 V_H of the kernel path (see
# GRAD_TOL), carried through the edge decoder and its backward. Measured at
# 512^2 on an H100 at 700 W: 0 and 2.7e-7 in float32 (b2), 6.2e-7 and 1.1e-5
# in bfloat16 (b8); the bounds are about 10x those. (At a site with 2m >= H,
# as at 16x16 with m = 20, the exact high-pass is 0 and the bf16 V_H leaves
# a residual there, so small images compare far worse.)
STEP_TOL = {"float32": (1e-6, 1e-5), "bfloat16": (1e-5, 1e-4)}
# A global norm misses a wrong direction, and a wrong high-pass backward
# whose share of the norm is small. So the step also holds, leaf by leaf in
# relative L2, the gradients that reach the weights only through the
# high-pass's backward: the two decoder stages whose outputs it filters
# (their biases add a constant that the batch norm or the high-pass removes,
# so their gradient is 0). A weight's gradient sums dx times an activation
# over the image, with cancellation, so it differs more than dx does: on an
# H100 at 700 W the worst leaf read 6.4e-5 in float32 (b2) and 8.9e-3 in
# bfloat16 (b8). The bounds are about 15x and 5x those; a high-pass backward
# with its sign flipped reads about 2.
LEAF_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# The 3-class step (phase 11a) amplifies rounding on these leaves more: its
# float32 kernel and low-rank leaves read 1.23e-3 apart at 512^2 b2 (an H100
# at 700 W), while the low-rank path's own float32 leaves lie about 2.7e-2
# from the same step in float64 (CPU, 128^2; 1 and 3 classes alike). Where
# it is larger, the bound on a leaf there is this share of that float32
# error, measured in the same run: a kernel difference ten times smaller
# than the reference path's own rounding; a flipped backward still reads 2.
F64_LEAF_SHARE = 0.1
HIGHPASS_LEAVES = ("edge_up2.convt.weight", "edge_up2.bn0.weight",
                   "edge_up1.convt.weight", "edge_up1.bn0.weight")
KERNELS = {
    "highpass_contract": "eelunet_tpu/ops/fft_pallas.py:106",
    "highpass_expand": "eelunet_tpu/ops/fft_pallas.py:167",
    "highpass_bwd_contract": "eelunet_tpu/ops/fft_pallas.py:390",
    "highpass_bwd_expand": "eelunet_tpu/ops/fft_pallas.py:427",
    "fused_canny": "eelunet_tpu/ops/edge_pallas.py:70",
    "conv3x3": "eelunet_tpu/ops/conv_pallas.py:42",
}
SOURCES = {
    "highpass_contract": "eelunet_tpu_torch/csrc/highpass.cu",
    "highpass_expand": "eelunet_tpu_torch/csrc/highpass.cu",
    "highpass_bwd_contract": "eelunet_tpu_torch/csrc/highpass_bwd.cu",
    "highpass_bwd_expand": "eelunet_tpu_torch/csrc/highpass_bwd.cu",
    "fused_canny": "eelunet_tpu_torch/csrc/canny.cu",
    "conv3x3": "eelunet_tpu_torch/csrc/conv3x3.cu",
}
HIGHPASS = tuple(KERNELS)[:4]
FWD, BWD = HIGHPASS[:2], HIGHPASS[2:]
# Kernel 5 runs on the grayscale of each batch of the Canny path, twice per
# batch (canny_enhance, then add_canny_edge), in mode "improve".
CANNY_SITE = (8, 512, 512, 1)
# Kernel 5 vs its twin: both round every product and sum alike, so the
# outputs should agree exactly; a few pixels could flip where the kernel's
# atan2f and PyTorch's disagree on the last bit at a bucket edge.
CANNY_TOL = {"disagree": 1e-4, "nms": 1e-5}  # share of pixels; max |d| where both keep
# Kernel 6 at the two full-resolution decoder shapes, (B,H,W,Cin) -> Cout.
CONV_SITES = ((8, 512, 512, 128, 64), (8, 512, 512, 64, 64))
# Kernel 6 vs its twin (cuDNN in float32, TF32 off), relative L2: float32
# differs by summation order, bfloat16 by one rounding of the output.
CONV_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# Kernel 6's arithmetic: bf16 products of bf16 operands, and in float32
# bf16x6 (both operands split into three bf16 pieces, six products each);
# as (name, bf16 products per product of its work).
CONV_ARITHMETIC = {"bfloat16": ("bfloat16", 1), "float32": ("bf16x6", 6)}
# Floating-point operations per output pixel of kernel 5, counted from its
# code: blur 2 x (5 mul + 4 add), Sobel 6 sub + 2 mul + 4 add, mag^2 3,
# then the zero mode's bucket products 3, or the improve mode's sqrt, eps
# add, atan2, degree mul and wrap add 5.
CANNY_FLOPS = {"zero": 36, "improve": 38}
# Published H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s, and
# FLOP/s by the arithmetic a kernel does: bf16 and TF32 on the tensor
# cores, f32 on CUDA cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
PEAK_INT8_OPS = 1979e12
# Readings with kernels 2 and 3 on CUDA cores (their earlier versions;
# kernels 1 and 4 on the tensor cores), on an NVIDIA H100 80GB HBM3 at
# 700.00 W, printed beside this run's: the served forward (512^2 b16 bf16)
# and the train step (512^2 b8 bf16).
CUDA_CORE_23_FORWARD_MS = 62.01
CUDA_CORE_23_STEP_MS = 114.69
# Readings of the Canny path with the hysteresis as a plain loop that reads
# a flag back per step, on an NVIDIA H100 80GB HBM3 at 700.00 W, printed
# beside this run's: the chain per batch, the Canny train step and the eval
# step with the chain (512^2 b8 bf16).
LOOP_HYSTERESIS_MS = {"chain": 5.24, "canny step": 119.75, "eval step": 57.42}
# The kernels on tensor cores: (library, function in the SASS, the
# instantiations that must each hold tensor-core instructions).
TC_KERNELS = {"highpass_contract": ("highpass", "contract_kernel_tc", ("16", "32", "48", "64")),
              "highpass_expand": ("highpass", "expand_kernel_tc", ("16", "32", "48", "64")),
              "highpass_bwd_contract": ("highpass_bwd", "bwd_contract_kernel_tc",
                                        ("16", "32", "48", "64")),
              "highpass_bwd_expand": ("highpass_bwd", "bwd_expand_kernel_tc",
                                      ("16", "32", "48", "64")),
              "conv3x3": ("conv3x3", "conv3x3_kernel_tc", ("bf16", "f32"))}


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(got, want) -> tuple:
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def work_arithmetic(name: str, dname: str) -> str:
    """The type of the products of a high-pass kernel's work in a model of
    type ``dname``, whose peak its bound takes: float32 models run f32
    throughout. In a bf16 model, kernel 1 multiplies bf16 x by a bf16 V_H;
    kernels 2-4 multiply f32 factors and spectra, which the tensor cores
    take at best in TF32."""
    if dname == "float32":
        return "float32"
    return "bfloat16" if name == "highpass_contract" else "tf32"


# What each kernel does in a bf16 model (csrc/tc_bf16.cuh), as (name, the
# bf16 products it issues per product of its work): kernel 2 splits f32
# operands into two bf16 pieces and takes three products (bf16x3); kernel 3
# rebuilds z with three pieces and six products (bf16x6), then sums T in
# bf16x3, so 4.5 per product of its work (two thirds of them the rebuild's).
KERNEL_ARITHMETIC = {"highpass_contract": ("bfloat16", 1.0),
                     "highpass_expand": ("bf16x3", 3.0),
                     "highpass_bwd_contract": ("bf16x6 rebuild, bf16x3 T", 4.5),
                     "highpass_bwd_expand": ("tf32", 1.0)}


def arithmetic(name: str, dname: str) -> str:
    """The arithmetic a high-pass kernel does in a model of type ``dname``."""
    return "float32" if dname == "float32" else KERNEL_ARITHMETIC[name][0]


def _bytes_fma(name: str, shape, dname: str, k: int) -> tuple:
    """(bytes, FMAs per element of x) of one launch of kernel ``name``."""
    b, h, w, c = shape
    n = b * h * w * c                 # elements of x
    sx = 2 if dname == "bfloat16" else 4
    skinny = 2 * b * k * w * c * 4    # a (re, im) pair of (B,K,W*C) f32
    factors = 2 * h * k * 4           # a (re, im) pair of (H,K) f32
    return {
        "highpass_contract": (n * sx + factors + skinny, 2 * k),   # x -> T
        "highpass_expand": (2 * n * sx + factors + skinny, 4 * k),  # x, S -> out
        "highpass_bwd_contract": (3 * n * sx + factors + 2 * skinny, 8 * k),  # x, g, S -> u, T
        "highpass_bwd_expand": (2 * n * sx + factors + skinny, 2 * k),  # R, u -> dx
    }[name]


def arithmetic_floor(name: str, shape, dname: str, k: int) -> float:
    """ms of the products kernel ``name`` issues in its arithmetic, at the
    peak of their type: its work's FLOPs times the products per product of
    the work (KERNEL_ARITHMETIC), over the bf16, TF32 or f32 peak."""
    b, h, w, c = shape
    _, fma = _bytes_fma(name, shape, dname, k)
    if dname == "float32":
        return 2 * fma * b * h * w * c / PEAK_FLOPS["float32"] * 1e3
    arith, passes = KERNEL_ARITHMETIC[name]
    peak = PEAK_FLOPS["tf32" if arith == "tf32" else "bfloat16"]
    return passes * 2 * fma * b * h * w * c / peak * 1e3


def kernel_bound(name: str, shape, dname: str, k: int) -> tuple:
    """(bound_ms, bound_by) of one launch of kernel ``name`` on an NHWC
    ``shape`` in ``dname``: the larger of its bytes (each input read once,
    each output written once) over the HBM rate and its FLOPs over the peak
    for the type of its work's products (``work_arithmetic``)."""
    b, h, w, c = shape
    nbytes, fma = _bytes_fma(name, shape, dname, k)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * fma * b * h * w * c / PEAK_FLOPS[work_arithmetic(name, dname)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def in_turns(kernel, library, iters: int = 10) -> tuple:
    """Kernel and library times in turns (kernel, library, library,
    kernel): (kernel ms, library ms, the four turns)."""
    turns = [cuda_ms(f, iters=iters) for f in (kernel, library, library, kernel)]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


# ------------------------------------------------------------------ phases

def phase_card():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    return card


def phase_build():
    from eelunet_tpu_torch.ops import _build, conv_cuda, edge_cuda, fft_cuda

    t0 = time.monotonic()
    built = _build.build_all(fft_cuda.SOURCES + edge_cuda.SOURCES + conv_cuda.SOURCES)
    for name, (path, seconds, log) in built.items():
        print(f"[2] built {path.name} in {seconds:.1f} s (0 = already built)")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    {line.strip()}")
        _build.load(name)
    print(f"[2] build wall time {time.monotonic() - t0:.1f} s (one nvcc per source, in parallel)")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        print("[2] no cuobjdump in the toolkit: tensor-core instructions not counted")
    for name, (lib, fn, variants) in TC_KERNELS.items():
        if not os.path.exists(cuobjdump):
            break
        sass = subprocess.run([cuobjdump, "-sass", str(built[lib][0])], capture_output=True,
                              text=True, timeout=120).stdout
        counts, current = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                current = line.split("Function :", 1)[1].strip()
            elif current and fn + "I" in current and ("HMMA" in line or "HGMMA" in line):
                counts[current] = counts.get(current, 0) + 1
        per = {_instantiation(f.split(fn + "I", 1)[1]): c for f, c in counts.items()}
        print(f"[2] {name} ({fn}): tensor-core instructions (HMMA/HGMMA) in the SASS per "
              f"instantiation {per}")
        check(sorted(per) == sorted(variants) and min(per.values()) > 0,
              f"{fn}: no tensor-core instructions in the SASS of every one of {variants}: {per}")
    sys.stdout.flush()


def _instantiation(args: str) -> str:
    """The template arguments of a mangled kernel name, after its ``I``: K of
    kernels 1-4 (``Li48E``), the type of kernel 6 (``13__nv_bfloat16`` or
    ``f``)."""
    if args.startswith("Li"):
        return args[2:].split("E", 1)[0]
    return "bf16" if args.startswith("13__nv_bfloat16") else "f32" if args[0] == "f" else args


def phase_kernels():
    """Kernel vs plain twin at both sites; returns the 512-site bf16 record."""
    import torch

    from eelunet_tpu_torch.models.eelunet import high_pass_fft_reference
    from eelunet_tpu_torch.ops import fft_cuda
    from eelunet_tpu_torch.ops.fft import high_pass_fft_lowrank

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {}
    for shape in SITES:
        b, h, w, c = shape
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            g = torch.Generator(device=dev).manual_seed(SEED)
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            x3 = x.view(b, h, w * c)
            vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = fft_cuda.factor_tensors(
                h, w, MASK_RANGE, dtype, dev)
            tol = TOL[dname]
            rows = {}

            with torch.inference_mode():
                tk = fft_cuda.highpass_contract(x3, vr_t, vi_t)
                tp = fft_cuda.highpass_contract_plain(x3, vr_t, vi_t)
                torch.cuda.synchronize()
                e_c = max(rel_err(tk[0], tp[0]), rel_err(tk[1], tp[1]), key=lambda e: e[1])
                s_r, s_i = fft_cuda.w_axis_middle(tp[0], tp[1], uwr, uwi, vwr, vwi, w, c)
                ok_ = fft_cuda.highpass_expand(x3, uhr, uhi, s_r, s_i)
                op_ = fft_cuda.highpass_expand_plain(x3, uhr, uhi, s_r, s_i)
                torch.cuda.synchronize()
                e_e = rel_err(ok_, op_)
                whole_k = fft_cuda.high_pass_fft_cuda(x, MASK_RANGE)
                whole_p = high_pass_fft_lowrank(x, MASK_RANGE)
                e_w = rel_err(whole_k, whole_p)
                e_f = rel_err(whole_k, high_pass_fft_reference(x, MASK_RANGE)) \
                    if dtype == torch.float32 else None
                del whole_p, tk, tp, ok_, op_
                # Library yardstick of kernel 1: one bmm of the stacked V_H
                # (2K, H) against x that writes T in f32, as the kernel does,
                # operands made first; in turns with the kernel.
                v_stack = torch.cat([vr_t.t(), vi_t.t()]).contiguous().expand(b, -1, h)
                out_dt = {"out_dtype": torch.float32} if dtype == torch.bfloat16 else {}
                ms_c, lib_c, turns = in_turns(
                    lambda: fft_cuda.highpass_contract(x3, vr_t, vi_t),
                    lambda: torch.bmm(v_stack, x3, **out_dt))
                print(f"[3] highpass_contract {str(shape):22s} {dname:8s} turns (kernel, bmm, "
                      f"bmm, kernel) {[round(t, 4) for t in turns]} ms")
                rows["highpass_contract"] = (e_c, ms_c, cuda_ms(
                    lambda: fft_cuda.highpass_contract_plain(x3, vr_t, vi_t)), lib_c)
                rows["highpass_expand"] = (e_e, cuda_ms(
                    lambda: fft_cuda.highpass_expand(x3, uhr, uhi, s_r, s_i)), cuda_ms(
                    lambda: fft_cuda.highpass_expand_plain(x3, uhr, uhi, s_r, s_i)), None)
                rows["high_pass_fft"] = (e_w, cuda_ms(
                    lambda: fft_cuda.high_pass_fft_cuda(x, MASK_RANGE)), cuda_ms(
                    lambda: high_pass_fft_lowrank(x, MASK_RANGE)), None)
            _print_rows("3", rows, shape, dname, tol, uhr.shape[1])
            if e_f is not None:
                print(f"[3] high_pass_fft vs torch.fft {str(shape):14s} float32  "
                      f"max|d| {e_f[0]:.3e} rel {e_f[1]:.3e} (bound {tol:g})")
                check(e_f[1] <= tol, f"high_pass_fft vs torch.fft {shape}: {e_f[1]:.3e}")
            if shape == SITES[-1] and dtype == torch.bfloat16:
                record = {k: rows[k] + kernel_bound(k, shape, dname, uhr.shape[1])
                          for k in FWD}
            del x, x3, s_r, s_i, v_stack
            torch.cuda.empty_cache()
    sys.stdout.flush()
    return record


def rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _print_rows(phase, rows, shape, dname, tol, k, metric="rel"):
    for name, ((abs_e, rel_e), ms, plain_ms, lib_ms) in rows.items():
        extra = ""
        if name in HIGHPASS:
            bound_ms, bound_by = kernel_bound(name, shape, dname, k)
            extra = (f"  bound {bound_ms:.3f} ms ({bound_by}, "
                     f"{work_arithmetic(name, dname)}; {100 * bound_ms / ms:.1f}% of it); "
                     f"floor of its arithmetic ({arithmetic(name, dname)}) "
                     f"{arithmetic_floor(name, shape, dname, k):.3f} ms")
        if lib_ms is not None:
            extra += f"  library {lib_ms:.3f} ms"
        print(f"[{phase}] {name:21s} {str(shape):22s} {dname:8s} max|d| {abs_e:.3e} "
              f"{metric} {rel_e:.3e} (bound {tol:g})  kernel {ms:.3f} ms  "
              f"plain {plain_ms:.3f} ms{extra}")
        check(rel_e <= tol, f"{name} {shape} {dname}: rel err {rel_e:.3e} > {tol:g}")


def phase_bwd_kernels():
    """Backward kernels vs their twins at both training sites, then the
    whole Function's gradient vs autograd of the plain low-rank op; returns
    the 512-site bf16 record."""
    import torch

    from eelunet_tpu_torch.ops import fft_cuda
    from eelunet_tpu_torch.ops.fft import high_pass_fft_lowrank

    dev = torch.device("cuda")
    record = {}
    for shape in TRAIN_SITES:
        b, h, w, c = shape
        for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            gen = torch.Generator(device=dev).manual_seed(SEED + 3)
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            g = torch.randn(shape, generator=gen, device=dev).to(dtype)
            x3, g3 = x.view(b, h, w * c), g.view(b, h, w * c)
            vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = fft_cuda.factor_tensors(
                h, w, MASK_RANGE, torch.float32, dev)
            k = uhr.shape[1]
            tol = TOL[dname]
            rows = {}
            with torch.inference_mode():
                _, s_r, s_i = fft_cuda.highpass_fwd(x, MASK_RANGE)
                uk, trk, tik = fft_cuda.highpass_bwd_contract(x3, g3, uhr, uhi, s_r, s_i)
                up, trp, tip = fft_cuda.highpass_bwd_contract_plain(x3, g3, uhr, uhi, s_r, s_i)
                torch.cuda.synchronize()
                # T sums the unrounded f32 u in both: f32 summation order only.
                e_t = max(rel_err(trk, trp), rel_err(tik, tip), key=lambda e: e[1])
                e_u = (rel_err(uk, up)[0], rel_l2(uk, up))
                r_r, r_i = fft_cuda.w_axis_middle(trp, tip, vwr.T, vwi.T, uwr.T, uwi.T, w, c)
                del uk, trk, tik, trp, tip
                dk = fft_cuda.highpass_bwd_expand(up, vr_t, vi_t, r_r, r_i)
                dp = fft_cuda.highpass_bwd_expand_plain(up, vr_t, vi_t, r_r, r_i)
                torch.cuda.synchronize()
                e_d = (rel_err(dk, dp)[0], rel_l2(dk, dp))
                del dk, dp
                print(f"[3b] highpass_bwd_contract T {str(shape):22s} {dname:8s} "
                      f"max|d| {e_t[0]:.3e} rel {e_t[1]:.3e} (bound {TOL['float32']:g})")
                check(e_t[1] <= TOL["float32"], f"bwd contract T {shape} {dname}: {e_t[1]:.3e}")
                # Library yardsticks of kernel 4, one baddbmm each, u - [V_r^T,
                # -V_i^T] [R_r; R_i], operands made first: in f32 with TF32 on
                # for that call only in a bf16 model (the kernel's arithmetic;
                # TF32 off in a float32 one), and, in a bf16 model, in bf16.
                v_cat = torch.cat([vr_t, -vi_t], dim=1).expand(b, h, 2 * k)
                r_cat = torch.cat([r_r, r_i], dim=1)
                u32 = up.float()

                def lib_f32():
                    torch.backends.cuda.matmul.allow_tf32 = dtype == torch.bfloat16
                    try:
                        return torch.baddbmm(u32, v_cat, r_cat, alpha=-1)
                    finally:
                        torch.backends.cuda.matmul.allow_tf32 = False

                ms_d, lib_d, turns = in_turns(
                    lambda: fft_cuda.highpass_bwd_expand(up, vr_t, vi_t, r_r, r_i), lib_f32)
                lib_bf16 = ""
                if dtype == torch.bfloat16:
                    v16, r16 = v_cat.to(dtype), r_cat.to(dtype)
                    _, lib16, turns16 = in_turns(
                        lambda: fft_cuda.highpass_bwd_expand(up, vr_t, vi_t, r_r, r_i),
                        lambda: torch.baddbmm(up, v16, r16, alpha=-1))
                    lib_bf16 = (f"; bf16 baddbmm {lib16:.3f} ms, turns "
                                f"{[round(t, 4) for t in turns16]}")
                    del v16, r16
                print(f"[3b] highpass_bwd_expand {str(shape):22s} {dname:8s} turns (kernel, "
                      f"f32 baddbmm{' in TF32' if lib_bf16 else ''}, the same, kernel) "
                      f"{[round(t, 4) for t in turns]} ms{lib_bf16}")
                rows["highpass_bwd_contract"] = (e_u, cuda_ms(
                    lambda: fft_cuda.highpass_bwd_contract(x3, g3, uhr, uhi, s_r, s_i)), cuda_ms(
                    lambda: fft_cuda.highpass_bwd_contract_plain(x3, g3, uhr, uhi, s_r, s_i)),
                    None)
                rows["highpass_bwd_expand"] = (e_d, ms_d, cuda_ms(
                    lambda: fft_cuda.highpass_bwd_expand_plain(up, vr_t, vi_t, r_r, r_i)), lib_d)
                del v_cat, r_cat, u32
            # The whole Function (four launches) against autograd of the plain op.
            xg = x.detach().requires_grad_(True)
            (got,) = torch.autograd.grad(fft_cuda.high_pass_fft_cuda(xg, MASK_RANGE), xg, g)
            (want,) = torch.autograd.grad(high_pass_fft_lowrank(xg, MASK_RANGE), xg, g)
            e_g = rel_err(got, want)
            e_l2 = rel_l2(got, want)
            del got, want

            def fn_step():
                out = fft_cuda.high_pass_fft_cuda(xg, MASK_RANGE)
                return torch.autograd.grad(out, xg, g)

            def plain_step():
                out = high_pass_fft_lowrank(xg, MASK_RANGE)
                return torch.autograd.grad(out, xg, g)

            _print_rows("3b", rows, shape, dname, BWD_TOL[dname], k, metric="rel-l2")
            gtol = GRAD_TOL[dname]
            print(f"[3b] HighPassFunction grad vs autograd of lowrank {str(shape):22s} {dname:8s} "
                  f"max|d| {e_g[0]:.3e} rel-max {e_g[1]:.3e} rel-l2 {e_l2:.3e} (bound "
                  f"{gtol:g})  fwd+bwd {cuda_ms(fn_step):.3f} ms  plain "
                  f"{cuda_ms(plain_step):.3f} ms", flush=True)
            check(e_l2 <= gtol, f"Function grad {shape} {dname}: rel-l2 {e_l2:.3e}")
            if shape == TRAIN_SITES[-1] and dtype == torch.bfloat16:
                record = {n: rows[n] + kernel_bound(n, shape, dname, k) for n in BWD}
            del x, g, x3, g3, xg, s_r, s_i, up, r_r, r_i
            torch.cuda.empty_cache()

    # K = 64 (mask_range 25-32), which the training path does not take: the
    # contract is compiled for 2 blocks per SM there. Held to its twin and
    # timed once at the 512 site in bfloat16.
    b, h, w, c = shape = TRAIN_SITES[-1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x3, g3 = x.view(b, h, w * c), g.view(b, h, w * c)
    _, _, uhr, uhi, *_ = fft_cuda.factor_tensors(h, w, 32, torch.float32, dev)
    with torch.inference_mode():
        _, s_r, s_i = fft_cuda.highpass_fwd(x, 32)
        uk, trk, tik = fft_cuda.highpass_bwd_contract(x3, g3, uhr, uhi, s_r, s_i)
        up, trp, tip = fft_cuda.highpass_bwd_contract_plain(x3, g3, uhr, uhi, s_r, s_i)
        e_t = max(rel_err(trk, trp)[1], rel_err(tik, tip)[1])
        e_u = rel_l2(uk, up)
        del uk, trk, tik, up, trp, tip
        ms = cuda_ms(lambda: fft_cuda.highpass_bwd_contract(x3, g3, uhr, uhi, s_r, s_i))
    print(f"[3b] highpass_bwd_contract K=64 {str(shape):22s} bfloat16 T rel {e_t:.3e} "
          f"(bound {TOL['float32']:g}) u rel-l2 {e_u:.3e} (bound {BWD_TOL['bfloat16']:g})  "
          f"kernel {ms:.3f} ms", flush=True)
    check(e_t <= TOL["float32"] and e_u <= BWD_TOL["bfloat16"], "bwd contract K=64")
    del x, g, x3, g3, s_r, s_i
    torch.cuda.empty_cache()
    return record


def canny_bound(shape, mode: str) -> tuple:
    """(bound_ms, bound_by) of one launch of kernel 5 on a float32 image
    ``shape``: the image read once and the output written once, against
    CANNY_FLOPS per pixel at the float32 peak."""
    n = int(np.prod(shape))
    t_bytes = 2 * n * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = CANNY_FLOPS[mode] * n / PEAK_FLOPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_bound(site, dname: str) -> tuple:
    """(bound_ms, bound_by) of one launch of kernel 6 at ``site`` (B,H,W,Cin,
    Cout) in ``dname``: x, w and out once each (scale and shift in f32),
    against 2*B*H*W*9*Cin*Cout flops at the tensor cores' peak for the input
    type: bf16, and TF32 for float32 (the tensor cores take f32 at best in
    TF32; kernels 2-4's bounds take it so too)."""
    b, h, w, cin, cout = site
    sx = 2 if dname == "bfloat16" else 4
    nbytes = (b * h * w * (cin + cout) + 9 * cin * cout) * sx + 2 * cout * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = PEAK_FLOPS["bfloat16" if dname == "bfloat16" else "tf32"]
    t_ops = 2.0 * b * h * w * 9 * cin * cout / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_arithmetic_floor(site, dname: str) -> float:
    """ms of the bf16 products kernel 6 issues in ``dname`` (CONV_ARITHMETIC:
    one per product of its work in bfloat16, six in float32) at the bf16
    peak."""
    b, h, w, cin, cout = site
    return CONV_ARITHMETIC[dname][1] * 2.0 * b * h * w * 9 * cin * cout / PEAK_FLOPS[
        "bfloat16"] * 1e3


def graph_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device ms per call of ``fn``: replays of a CUDA graph that holds
    ``launches`` calls, so no host work sits between the kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm, off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * launches)
    del graph
    return ms


def phase_canny_conv_kernels():
    """Kernels 5 and 6 and the hysteresis kernel against their twins on the
    card; returns the record of kernel 5 in mode "improve" (the Canny path's
    mode), of kernel 6 in bfloat16 at (8,512,512,128) -> 64, and the
    hysteresis kernel's readings under "hysteresis"."""
    import torch
    import torch.nn.functional as F

    from eelunet_tpu_torch.ops import conv_cuda, edge_cuda
    from eelunet_tpu_torch.ops.edge import rgb_to_grayscale

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    record = {}
    (u8, _), = _train_batches(1, CANNY_SITE[0], SEED + 6)
    gray = rgb_to_grayscale(torch.from_numpy(u8).to(dev).float() / 255.0).contiguous()
    check(tuple(gray.shape) == CANNY_SITE, f"canny site {tuple(gray.shape)}")
    low = 100.0 / 255.0
    rows = {}
    for mode in ("zero", "improve"):
        with torch.inference_mode():
            got = edge_cuda.fused_canny(gray, low, mode=mode)
            want = edge_cuda.fused_canny_reference(gray, low, mode=mode)
            torch.cuda.synchronize()
            both = (got > 0) & (want > 0)
            rows[mode] = {
                "disagree": ((got > 0) != (want > 0)).float().mean().item(),
                "abs_e": (got - want).abs().max().item(),
                "nms_e": (got - want)[both].abs().max().item() if mode == "improve" else 0.0,
                "kept": (got > 0).float().mean().item(),
                "plain_ms": cuda_ms(lambda: edge_cuda.fused_canny_reference(gray, low, mode=mode)),
                "loop": [], "graph": []}
        del got, want, both
    # The two modes' times in turns (zero, improve, improve, zero): a host
    # loop of wrapper calls, and the device time by CUDA-graph replay.
    with torch.inference_mode():
        for mode in ("zero", "improve", "improve", "zero"):
            fn = lambda: edge_cuda.fused_canny(gray, low, mode=mode)  # noqa: E731
            rows[mode]["loop"].append(cuda_ms(fn, iters=20, warmup=3))
            rows[mode]["graph"].append(graph_ms(fn))
    for mode, r in rows.items():
        ms, loop_ms = float(np.mean(r["graph"])), float(np.mean(r["loop"]))
        bound_ms, bound_by = canny_bound(CANNY_SITE, mode)
        print(f"[3c] fused_canny {mode:7s} {str(CANNY_SITE):22s} float32  pixels kept "
              f"{r['kept']:.4f}, disagreeing {r['disagree']:.3e} "
              f"(bound {CANNY_TOL['disagree']:g}); "
              f"max|d| {r['abs_e']:.3e}, NMS magnitude max|d| where both keep {r['nms_e']:.3e} "
              f"(bound {CANNY_TOL['nms']:g})  kernel {ms:.4f} ms by graph replay (turns "
              f"{[round(t, 4) for t in r['graph']]}; image in L2), {loop_ms:.4f} ms by a host "
              f"loop (turns {[round(t, 4) for t in r['loop']]})  plain {r['plain_ms']:.3f} ms  "
              f"bound {bound_ms:.4f} ms ({bound_by}; {100 * bound_ms / ms:.1f}% of it)",
              flush=True)
        check(r["disagree"] <= CANNY_TOL["disagree"] and r["nms_e"] <= CANNY_TOL["nms"],
              f"fused_canny {mode}: {r['disagree']:.3e} of pixels disagree, "
              f"NMS max|d| {r['nms_e']:.3e}")
        if mode == "improve":
            record["fused_canny"] = ((r["abs_e"], r["disagree"]), ms, r["plain_ms"], None,
                                     bound_ms, bound_by)

    # The hysteresis kernel on this site's NMS output at the chain's
    # thresholds, against the plain loop to the fixpoint.
    lo, hi = 100.0 / 255.0, 200.0 / 255.0
    with torch.inference_mode():
        nms = edge_cuda.fused_canny(gray, mode="improve")
        got, rounds = edge_cuda.hysteresis(nms, lo, hi)
        want, steps = edge_cuda.hysteresis_fixpoint(nms >= hi, (nms >= lo) & (nms < hi))
        torch.cuda.synchronize()
        equal = torch.equal(got, want.float())
        hyst = {"equal": equal, "rounds": int(rounds.item()), "steps": steps,
                "on": got.mean().item(),
                "ms": cuda_ms(lambda: edge_cuda.hysteresis(nms, lo, hi), iters=10),
                "plain_ms": cuda_ms(lambda: edge_cuda.hysteresis_reference(nms, lo, hi), iters=3),
                # nms read once, the map written once (float32)
                "bound_ms": 2 * nms.numel() * 4 / HBM_BYTES_PER_S * 1e3}
    print(f"[3c] hysteresis {str(CANNY_SITE):22s} float32  equal to hysteresis_fixpoint bit for "
          f"bit: {equal} ({hyst['on']:.4f} of pixels on); {hyst['rounds']} rounds against the "
          f"loop's {steps} steps  kernel {hyst['ms']:.4f} ms  plain loop {hyst['plain_ms']:.3f} "
          f"ms  bound {hyst['bound_ms']:.4f} ms (bytes)", flush=True)
    check(equal, "hysteresis kernel differs from hysteresis_fixpoint")
    record["hysteresis"] = hyst
    del gray, nms, got, want

    for site in CONV_SITES:
        b, h, w, cin, cout = site
        for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            gen = torch.Generator(device=dev).manual_seed(SEED + 7)
            x = torch.randn((b, h, w, cin), generator=gen, device=dev).to(dtype)
            wt = (0.1 * torch.randn((3, 3, cin, cout), generator=gen, device=dev)).to(dtype)
            scale = 1.0 + 0.1 * torch.randn((cout,), generator=gen, device=dev)
            shift = 0.1 * torch.randn((cout,), generator=gen, device=dev)
            with torch.inference_mode():
                got = conv_cuda.conv3x3(x, wt, scale, shift, relu=True)
                want = conv_cuda.conv3x3_reference(x, wt, scale, shift, relu=True)
                torch.cuda.synchronize()
                e = (rel_err(got, want)[0], rel_l2(got, want))
                del got, want
                # Library yardstick: one cuDNN conv with the affine folded in,
                # then ReLU, on channels_last operands made first (TF32 off).
                x_cl = x.permute(0, 3, 1, 2)
                w_lib = (wt.float() * scale).permute(3, 2, 0, 1).to(dtype).contiguous(
                    memory_format=torch.channels_last)
                b_lib = shift.to(dtype)
                ms, lib_ms, turns = in_turns(
                    lambda: conv_cuda.conv3x3(x, wt, scale, shift, relu=True),
                    lambda: F.relu(F.conv2d(x_cl, w_lib, b_lib, padding=1)))
                plain_ms = cuda_ms(
                    lambda: conv_cuda.conv3x3_reference(x, wt, scale, shift, relu=True))
            bound_ms, bound_by = conv_bound(site, dname)
            arith = CONV_ARITHMETIC[dname][0]
            print(f"[3c] conv3x3 {str(site):22s} {dname:8s} max|d| {e[0]:.3e} rel-l2 {e[1]:.3e} "
                  f"(bound {CONV_TOL[dname]:g})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms  "
                  f"library {lib_ms:.3f} ms (turns: kernel, cuDNN, cuDNN, kernel "
                  f"{[round(t, 4) for t in turns]})  bound {bound_ms:.3f} ms ({bound_by}; "
                  f"{100 * bound_ms / ms:.1f}% of it); floor of its arithmetic ({arith}) "
                  f"{conv_arithmetic_floor(site, dname):.3f} ms", flush=True)
            check(e[1] <= CONV_TOL[dname], f"conv3x3 {site} {dname}: rel-l2 {e[1]:.3e}")
            if site == CONV_SITES[0] and dtype == torch.bfloat16:
                record["conv3x3"] = (e, ms, plain_ms, lib_ms, bound_ms, bound_by)
            del x, wt, x_cl, w_lib
            torch.cuda.empty_cache()
    return record


def _random_upstream_checkpoint(cfg, path):
    """Seeded random-init full-width model of ``cfg.name`` with randomised
    BN statistics, saved in the upstream layout that cli.export_torch
    --numpy writes."""
    import torch

    from eelunet_tpu_torch.inference import random_state_dict
    from eelunet_tpu_torch.models.convert import to_upstream_state_dict

    sd = random_state_dict(cfg, seed=SEED)
    g = torch.Generator().manual_seed(SEED + 1)
    for k, v in sd.items():
        if k.endswith(".running_var"):
            sd[k] = 0.5 + torch.rand(v.shape, generator=g)
        elif k.endswith(".running_mean"):
            sd[k] = 0.1 * torch.randn(v.shape, generator=g)
    np.savez(path, **to_upstream_state_dict(sd, cfg.name))
    return sd


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url, body=None, ctype="application/octet-stream", timeout=600):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def _npy(arr) -> bytes:
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


@contextlib.contextmanager
def _server(ckpt: str, workdir: str, model_type: str, phase: str, extra=()):
    """``python -m eelunet_tpu_torch.cli.serve`` on ``ckpt`` (None: an
    ``--artifact`` in ``extra``) at 512^2 bf16 in a subprocess; yields its
    base URL once it answers, its launch counts at 0, and stops it on exit."""
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    log_path = os.path.join(workdir, f"serve_{model_type}_{phase}.log")
    cmd = [sys.executable, "-m", "eelunet_tpu_torch.cli.serve", "--model_type", model_type,
           *(("--checkpoint", ckpt) if ckpt else ()), "--image_size", "512", "--set",
           "model.dtype=bfloat16", "--max_batch", "16", "--window_ms", "20", "--port",
           str(port), *extra]
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        t0 = time.monotonic()
        while True:
            if proc.poll() is not None:
                raise SmokeFailure(f"server exited with {proc.returncode}:\n"
                                   + open(log_path).read()[-4000:])
            try:
                health = json.loads(_http(base + "/v1/healthz", timeout=5)[1])
                break
            except OSError:
                check(time.monotonic() - t0 < 300, "server did not come up in 300 s")
                time.sleep(1.0)
        print(f"[{phase}] server up in {time.monotonic() - t0:.1f} s: {health}", flush=True)
        check(health["image_size"] == [512, 512], f"healthz: {health}")
        stats0 = json.loads(_http(base + "/v1/stats")[1])
        check(set(stats0["kernel_launches"].values()) == {0},
              f"launch counts before the run: {stats0['kernel_launches']}")
        yield base
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)


def phase_serve(ckpt: str, workdir: str, model_type: str = "eelunet", n_singles: int = 24,
                phase: str = "4", extra=()):
    """The main path: the serve CLI in a subprocess (``extra`` arguments),
    ``n_singles`` concurrent requests, one batched and one PNG. Returns its
    launches: 2 per forward and card of the batch (``/v1/stats``
    ``data_size``) of each forward high-pass kernel for the EELUnet, 0 for
    the others."""
    from PIL import Image

    with _server(ckpt, workdir, model_type, phase, extra) as base:
        rng = np.random.default_rng(SEED)
        singles = rng.integers(0, 256, (n_singles, 512, 512, 3), dtype=np.uint8)
        results, errors = [None] * len(singles), []

        def one(i):
            try:
                q = "?output=mask" if i % 2 else ""
                results[i] = _http(base + "/v1/predict" + q, _npy(singles[i]))
            except Exception as e:  # reported below; every thread is joined
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        t1 = time.monotonic()
        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(singles))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not errors and all(not t.is_alive() for t in threads), f"requests: {errors}")
        batch = rng.integers(0, 256, (4, 512, 512, 3), dtype=np.uint8)
        code_b, body_b, _ = _http(base + "/v1/predict", _npy(batch))
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (600, 500, 3), dtype=np.uint8)).save(buf, "PNG")
        code_p, body_p, ctype_p = _http(base + "/v1/predict", buf.getvalue(), "image/png")
        wall = time.monotonic() - t1

        for i, (code, body, _) in enumerate(results):
            check(code == 200, f"request {i}: HTTP {code}")
            arr = np.load(io.BytesIO(body))
            check(arr.shape == (1, 512, 512, 1) and arr.dtype == np.float32,
                  f"request {i}: {arr.shape} {arr.dtype}")
            check(bool(np.isfinite(arr).all()) and arr.min() >= 0.0 and arr.max() <= 1.0,
                  f"request {i}: values outside [0, 1]")
            if i % 2:
                check(set(np.unique(arr)) <= {0.0, 1.0}, f"request {i}: mask not in {{0,1}}")
        arr = np.load(io.BytesIO(body_b))
        check(code_b == 200 and arr.shape == (4, 512, 512, 1) and bool(np.isfinite(arr).all())
              and arr.min() >= 0.0 and arr.max() <= 1.0, f"batched request: {arr.shape}")
        png = np.asarray(Image.open(io.BytesIO(body_p)))
        check(code_p == 200 and ctype_p == "image/png" and png.shape == (512, 512)
              and set(np.unique(png)) <= {0, 255}, f"PNG request: {png.shape}")

        stats = json.loads(_http(base + "/v1/stats")[1])
        launches = stats["kernel_launches"]
        print(f"[{phase}] {model_type}: {stats['requests']} requests in {stats['batches']} forwards "
              f"over {stats['data_size']} device(s), "
              f"{wall:.2f} s wall; device_ms {stats['device_ms']}; "
              f"latency_ms {stats['latency_ms']}; launches {launches}", flush=True)
        check(stats["requests"] == len(singles) + batch.shape[0] + 1, f"stats: {stats}")
        shards = stats["data_size"]
        for name in HIGHPASS:
            want = 2 * shards * stats["batches"] if name in FWD and model_type == "eelunet" else 0
            check(launches[name] == want,
                  f"{name}: {launches[name]} launches for {stats['batches']} forwards")
        return launches


def phase_model(sd, cfg):
    import dataclasses

    import torch

    from eelunet_tpu_torch.data.augment import normalize_imagenet
    from eelunet_tpu_torch.inference import build_serving_model
    from eelunet_tpu_torch.nn.layers import nchw
    from eelunet_tpu_torch.ops import fft_cuda

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    u8 = torch.from_numpy(rng.integers(0, 256, (16, 512, 512, 3), dtype=np.uint8)).to(dev)
    x = nchw(normalize_imagenet(u8.float() / 255.0))
    out = {}
    for dname, batch in (("float32", 2), ("bfloat16", 16)):
        c = dataclasses.replace(cfg, dtype=dname)
        kern = build_serving_model(sd, c, dev)
        plain = build_serving_model(sd, dataclasses.replace(c, highpass_impl="lowrank"), dev)
        xb = x[:batch].to(kern.final_conv.weight.dtype)
        with torch.inference_mode():
            fft_cuda.reset_launches()
            seg_k = kern(xb).seg
            torch.cuda.synchronize()
            launches = dict(fft_cuda.LAUNCHES)
            seg_p = plain(xb).seg
            d = (seg_k - seg_p).abs()
            print(f"[5] {dname} b{batch}: launches per forward {launches}; kernel vs plain "
                  f"path max|d prob| {d.max().item():.3e} mean {d.mean().item():.3e} "
                  f"(bound {MODEL_TOL[dname]:g})", flush=True)
            check(launches == {k: 2 if k in FWD else 0 for k in HIGHPASS},
                  f"launches per forward: {launches}")
            check(bool(torch.isfinite(seg_k).all()) and seg_k.shape == (batch, 1, 512, 512),
                  f"{dname}: bad output {tuple(seg_k.shape)}")
            check(d.max().item() <= MODEL_TOL[dname], f"{dname}: kernel vs plain path too far")
            if dname == "bfloat16":
                ms_k = cuda_ms(lambda: kern(xb), iters=5)
                ms_p = cuda_ms(lambda: plain(xb), iters=5)
                print(f"[5] forward 512^2 b16 bf16 (BN folded): {ms_k:.2f} ms/batch with the "
                      f"kernels ({16e3 / ms_k:.1f} img/s; {CUDA_CORE_23_FORWARD_MS} ms with "
                      f"kernels 2 and 3 on CUDA cores, on an NVIDIA H100 80GB HBM3 at 700.00 W), "
                      f"{ms_p:.2f} ms/batch with the plain "
                      f"high-pass; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                      "GiB", flush=True)
                out = {"forward_ms": ms_k, "plain_forward_ms": ms_p}
        del kern, plain
        torch.cuda.empty_cache()
    return out


def _train_batches(n_batches: int, batch: int, seed: int):
    """Seeded synthetic (uint8 image, uint8 mask) batches at 512^2, NHWC,
    as the data loader feeds them."""
    from eelunet_tpu_torch.data.synthetic import make_blob_sample

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        pairs = [make_blob_sample(rng, 512, 512) for _ in range(batch)]
        out.append((np.stack([(p[0] * 255).astype(np.uint8) for p in pairs]),
                    np.stack([(p[1] * 255).astype(np.uint8) for p in pairs])))
    return out


def phase_train(workdir: str):
    """In-process training at full width through the port's Trainer and
    train step: launch counts, finite losses, kernels vs low-rank, timing."""
    import torch

    from eelunet_tpu_torch.config import TrainConfig, apply_overrides
    from eelunet_tpu_torch.data.augment import make_input_preprocess
    from eelunet_tpu_torch.ops import fft_cuda
    from eelunet_tpu_torch.train.trainer import Trainer, make_train_step

    dev = torch.device("cuda")
    cfg = apply_overrides(TrainConfig(), [
        "model.name=eelunet", "model.dtype=bfloat16", f"model.fft_mask_range={MASK_RANGE}",
        "data.image_size=512", "data.batch_size=8", f"seed={SEED}",
        f"save_dir={workdir}/ckpt_inproc"])
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=6)
    step = make_train_step(trainer.loss_fn, trainer.amp_dtype)
    preprocess = make_input_preprocess(cfg.data)
    batches = [preprocess(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
               for x, y in _train_batches(2, 8, SEED + 4)]
    n_params = sum(p.numel() for p in state.model.parameters())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fft_cuda.reset_launches()
    losses = [step(state, *batches[i % 2])[0] for i in range(6)]
    torch.cuda.synchronize()
    launches = dict(fft_cuda.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses = [v.item() for v in losses]
    print(f"[6] {n_params / 1e6:.2f}M params, 512^2 b8 bf16 autocast: 6 steps, losses "
          f"{[round(v, 4) for v in losses]}; launches {launches}; peak memory "
          f"{peak_gib:.2f} GiB", flush=True)
    check(launches == {k: 12 for k in HIGHPASS}, f"launches over 6 steps: {launches}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")

    def steps_ms(impl: str, n: int = 3) -> float:
        state.model.highpass_impl = impl
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            step(state, *batches[i % 2])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    for impl in ("auto", "lowrank"):  # warm both paths
        steps_ms(impl, 1)
    times = {"auto": [], "lowrank": []}
    for impl in ("auto", "lowrank", "lowrank", "auto"):
        times[impl].append(steps_ms(impl))
    state.model.highpass_impl = "auto"
    ms_k, ms_p = (float(np.mean(times[k])) for k in ("auto", "lowrank"))
    print(f"[6] train step 512^2 b8 bf16: {ms_k:.2f} ms/step with the kernels "
          f"({8e3 / ms_k:.1f} img/s; turns {[round(t, 2) for t in times['auto']]}; "
          f"{CUDA_CORE_23_STEP_MS} ms with kernels 2 and 3 on CUDA cores, on an NVIDIA "
          f"H100 80GB HBM3 at 700.00 W), "
          f"{ms_p:.2f} ms/step with highpass_impl=lowrank "
          f"(turns {[round(t, 2) for t in times['lowrank']]})", flush=True)

    _kernels_vs_lowrank("6", state.model, trainer.loss_fn, batches[0])
    del state, trainer, batches
    torch.cuda.empty_cache()
    return {"step_ms": ms_k, "lowrank_step_ms": ms_p, "peak_gib": peak_gib}


def _kernels_vs_lowrank(phase: str, model, loss_fn, batch, f64_anchor: bool = False):
    """One step's loss, gradient norm and the gradient of the weights behind
    the high-pass, on the kernels and on ``highpass_impl="lowrank"`` from the
    same weights and batch: float32 at batch 2, bfloat16 at batch 8, within
    STEP_TOL and LEAF_TOL. Its launches are a comparison's, not a path's.

    ``f64_anchor``: the float32 leaves are also held to a tenth of the
    low-rank path's own float32 error on them (against the same step in
    float64, see F64_LEAF_SHARE), where that is the larger bound."""
    import copy

    import torch

    from eelunet_tpu_torch.train.trainer import forward_loss

    runs = [("float32", 2, "auto"), ("float32", 2, "lowrank"), ("bfloat16", 8, "auto"),
            ("bfloat16", 8, "lowrank")]
    if f64_anchor:
        runs.insert(2, ("float64", 2, "lowrank"))
    got = {}
    for dname, b, impl in runs:
        amp = torch.bfloat16 if dname == "bfloat16" else None
        x, y = (t[:b] for t in batch)
        if dname == "float64":
            x, y = x.double(), y.double()
        model_i = copy.deepcopy(model).train()
        if dname == "float64":
            model_i = model_i.double()
        model_i.highpass_impl = impl
        loss = forward_loss(model_i, loss_fn, x, y, amp)
        loss.backward()
        gnorm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad.double())
                         for p in model_i.parameters()]))
        grads = dict(model_i.named_parameters())
        leaves = {n: grads[n].grad.double().clone() for n in HIGHPASS_LEAVES}
        got[dname, impl] = (loss.item(), gnorm.item(), leaves)
        del model_i, loss, grads
    for dname, b in (("float32", 2), ("bfloat16", 8)):
        (lk, gk, leaves_k), (lp, gp, leaves_p) = got[dname, "auto"], got[dname, "lowrank"]
        d_loss, d_g = abs(lk - lp) / abs(lp), abs(gk - gp) / gp
        d_leaf = {n: rel_l2(leaves_k[n], leaves_p[n]) for n in HIGHPASS_LEAVES}
        tl, tg = STEP_TOL[dname]
        bound = dict.fromkeys(HIGHPASS_LEAVES, LEAF_TOL[dname])
        anchored = ""
        if dname == "float32" and f64_anchor:
            own = {n: rel_l2(leaves_p[n], got["float64", "lowrank"][2][n])
                   for n in HIGHPASS_LEAVES}
            bound = {n: max(LEAF_TOL[dname], F64_LEAF_SHARE * own[n]) for n in HIGHPASS_LEAVES}
            anchored = (f"; the low-rank float32 leaves vs float64: "
                        f"{ {n: f'{e:.2e}' for n, e in own.items()} }, so the bounds are "
                        f"{ {n: f'{e:.2e}' for n, e in bound.items()} }")
        print(f"[{phase}] {dname} b{b} one step, kernels vs lowrank: loss {lk:.6f} vs {lp:.6f} "
              f"(rel {d_loss:.2e}, bound {tl:g}); grad norm {gk:.6f} vs {gp:.6f} "
              f"(rel {d_g:.2e}, bound {tg:g}); rel-l2 of the leaves behind the high-pass "
              f"{ {n: f'{e:.2e}' for n, e in d_leaf.items()} } (bound {LEAF_TOL[dname]:g})"
              f"{anchored}", flush=True)
        check(d_loss <= tl and d_g <= tg, f"{dname}: kernel step vs lowrank step too far")
        check(all(d_leaf[n] <= bound[n] for n in HIGHPASS_LEAVES),
              f"{dname}: gradient behind the high-pass too far: {d_leaf}")
    torch.cuda.empty_cache()


def _cli(phase: str, module: str, args, nproc: int = 0):
    """Run ``python -m eelunet_tpu_torch.cli.<module> args`` to its end
    (with ``nproc``, under ``torchrun --standalone --nproc_per_node=nproc``);
    print its progress lines. Returns (stdout, its kernel launches, wall s);
    under torchrun only rank 0 prints."""
    launcher = ("-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={nproc}") if nproc else ()
    cmd = [sys.executable, *launcher, "-m", f"eelunet_tpu_torch.cli.{module}", *args]
    t1 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.monotonic() - t1
    check(proc.returncode == 0, f"cli.{module} exited with {proc.returncode}:\n"
          + (proc.stdout + proc.stderr)[-4000:])
    for line in proc.stdout.splitlines():
        if line.startswith(("Epoch [", "Device:", "Training complete", "kernel launches",
                            "Loaded", "Dice", "Mean IoU", "Mesh:", "Distributed")):
            print(f"[{phase}] {line}")
    launch_lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("kernel launches: ")]
    check(len(launch_lines) == 1, f"cli.{module} printed no launch counts")
    return proc.stdout, json.loads(launch_lines[0].split(": ", 1)[1]), wall


def _train_args(tree: str, save: str, logs: str, model_type: str = "eelunet"):
    return ["--model_type", model_type, "--data_dir", tree, "--image_size", "512",
            "--batch_size", "8", "--set", "model.dtype=bfloat16", "--epochs", "2",
            "--seed", str(SEED), "--save_dir", save, "--log_dir", logs]


# A cli.train run on phase 7's tree: 21 train images (90%) -> 2 steps of 8
# per epoch; 3 val images and 8 test images -> one forward each per epoch.
CLI_STEPS, CLI_FORWARDS = 2 * 2, 2 * (2 + 1 + 1)


def _history(root: str, name: str = "eelunet"):
    with open(os.path.join(root, "loss_history.json")) as f:
        hist = json.load(f)
    check(len(hist["train_loss"]) == 2 and all(np.isfinite(hist["train_loss"] + hist["val_loss"])),
          f"history: {hist}")
    with open(os.path.join(root, f"{name}_last", "framework_meta.json")) as f:
        check(json.load(f)["epoch"] == 2, "last snapshot epoch")
    best = os.path.join(root, f"{name}_best.npz")
    check(os.path.isfile(best) and os.path.isfile(os.path.join(root, f"{name}_last", "state.pt")),
          f"checkpoints: {sorted(os.listdir(root))}")
    return hist, best


def phase_train_cli(workdir: str):
    """The main path of the training slice: the train CLI in a subprocess on
    a synthetic tree; its best tag then serves on the card. Returns the
    run's launches and the tree."""
    import torch

    from eelunet_tpu_torch.config import ModelConfig
    from eelunet_tpu_torch.data.synthetic import write_synthetic_tree
    from eelunet_tpu_torch.inference import Predictor

    t0 = time.monotonic()
    tree = write_synthetic_tree(os.path.join(workdir, "tree"), n_train=24, n_test=8,
                                image_size=(512, 512), seed=SEED)
    t1 = time.monotonic()
    save, logs = os.path.join(workdir, "ckpt"), os.path.join(workdir, "runs")
    _, launches, wall = _cli("7", "train", _train_args(tree, save, logs))
    want = {k: 2 * (CLI_FORWARDS if k in FWD else CLI_STEPS) for k in HIGHPASS}
    want.update(fused_canny=0, hysteresis=0, conv3x3=0)
    check(launches == want, f"cli.train launches {launches}, want {want}")
    root = os.path.join(save, "eelunet")
    _, best = _history(root)

    from PIL import Image

    test_dir = os.path.join(tree, "test", "images")
    u8 = np.stack([np.asarray(Image.open(os.path.join(test_dir, f)).convert("RGB"))
                   for f in sorted(os.listdir(test_dir))[:2]])
    pred = Predictor(ModelConfig(name="eelunet", dtype="bfloat16"), checkpoint=best,
                     device="cuda")
    probs = pred.predict_proba(u8)
    check(probs.shape == (2, 512, 512, 1) and bool(np.isfinite(probs).all())
          and probs.min() >= 0.0 and probs.max() <= 1.0, f"best tag prediction {probs.shape}")
    print(f"[7] cli.train: {wall:.1f} s wall for 2 epochs (tree written in {t1 - t0:.1f} s); "
          f"launches {launches}; checkpoints {sorted(os.listdir(root))}; the best tag "
          f"served on {pred.device}: mean prob {float(probs.mean()):.4f}", flush=True)
    del pred
    torch.cuda.empty_cache()
    return launches, tree


CANNY_FLAGS = ("data.add_canny_edge=true", "data.canny_enhance=true")


def phase_canny_path(workdir: str, tree: str, plain_step_ms: float):
    """The Canny path: the chain under sync-debug "error", in-process step,
    chain and eval timing and the hysteresis kernel's rounds, then cli.train
    and cli.evaluate with both flags. Returns the two runs' launches,
    summed, and the run's best tag."""
    import torch

    from eelunet_tpu_torch.config import TrainConfig, apply_overrides
    from eelunet_tpu_torch.data.augment import canny_enhance, make_input_preprocess
    from eelunet_tpu_torch.ops import edge_cuda
    from eelunet_tpu_torch.ops.edge import rgb_to_grayscale
    from eelunet_tpu_torch.train.trainer import Trainer, make_eval_step, make_train_step

    dev = torch.device("cuda")
    cfg = apply_overrides(TrainConfig(), [
        "model.name=eelunet", "model.dtype=bfloat16", f"model.fft_mask_range={MASK_RANGE}",
        "data.image_size=512", "data.batch_size=8", f"seed={SEED}",
        f"save_dir={workdir}/ckpt_canny_inproc", *CANNY_FLAGS])
    trainer = Trainer(cfg, device="cuda")
    check(trainer.cfg.model.in_channels == 4, "the edge channel did not widen the input")
    state = trainer.init_state(steps_per_epoch=6)
    step = make_train_step(trainer.loss_fn, trainer.amp_dtype)
    eval_step = make_eval_step(trainer.meta, cfg.threshold, cfg.tta, trainer.amp_dtype)
    preprocess = make_input_preprocess(cfg.data)
    raw = [(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
           for x, y in _train_batches(2, 8, SEED + 4)]
    edge_cuda.reset_launches()
    prepped = [preprocess(*b) for b in raw]
    torch.cuda.synchronize()
    check(edge_cuda.LAUNCHES == {"fused_canny": 4, "hysteresis": 4},
          f"chain launches: {edge_cuda.LAUNCHES}")
    check(tuple(prepped[0][0].shape) == (8, 512, 512, 4), f"input {prepped[0][0].shape}")
    # The chain reads nothing back to the host: any synchronising call
    # raises in this mode.
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = preprocess(*raw[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(torch.equal(again[0], prepped[0][0]), "the chain under sync-debug differs")
    del again

    # The hysteresis kernel's rounds to the fixpoint, per batch, for each of
    # the chain's two Canny passes (on the raw image, then on the enhanced
    # one); read after the loop.
    rounds = []
    with torch.inference_mode():
        for u8, _ in raw:
            x = u8.float() / 255.0
            for imgs in (x, canny_enhance(x, cfg.data.canny_enhance_alpha)):
                nms = edge_cuda.fused_canny(rgb_to_grayscale(imgs).contiguous(), mode="improve")
                rounds.append(edge_cuda.hysteresis(nms, 100.0 / 255.0, 200.0 / 255.0)[1])
    rounds = [int(r.item()) for r in rounds]

    def events_ms(fn, n: int) -> float:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            fn(i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    losses = [step(state, *prepped[i % 2])[0] for i in range(2)]  # warm
    eval_step(state, *prepped[1])
    whole = events_ms(lambda i: step(state, *preprocess(*raw[i % 2])), 4)
    alone = events_ms(lambda i: step(state, *prepped[i % 2]), 4)
    chain = events_ms(lambda i: preprocess(*raw[i % 2]), 4)
    ev = events_ms(lambda i: eval_step(state, *preprocess(*raw[i % 2])), 4)
    ev_alone = events_ms(lambda i: eval_step(state, *prepped[i % 2]), 4)
    losses = [v.item() for v in losses]
    check(all(np.isfinite(losses)), f"non-finite Canny-path loss: {losses}")
    print(f"[9] Canny train step 512^2 b8 bf16, 4 input channels: {whole:.2f} ms/step with the "
          f"input chain ({8e3 / whole:.1f} img/s): chain {chain:.2f} ms + step {alone:.2f} ms; "
          f"phase 6's step without the augmentations {plain_step_ms:.2f} ms; eval step with "
          f"the chain {ev:.2f} ms/batch ({ev_alone:.2f} fed pre-made inputs); hysteresis kernel "
          f"rounds per pass {rounds} (enhance, "
          f"edge per batch); losses {[round(v, 4) for v in losses]}; with the hysteresis as a "
          f"plain loop reading a flag back per step, on an NVIDIA H100 80GB HBM3 at 700.00 W: "
          f"{LOOP_HYSTERESIS_MS}", flush=True)
    del state, trainer, raw, prepped
    torch.cuda.empty_cache()

    flags = [a for f in CANNY_FLAGS for a in ("--set", f)]
    save, logs = os.path.join(workdir, "ckpt_canny"), os.path.join(workdir, "runs_canny")
    _, trained, wall = _cli("9", "train", _train_args(tree, save, logs) + flags)
    want = {k: 2 * (CLI_FORWARDS if k in FWD else CLI_STEPS) for k in HIGHPASS}
    # Every batch the run feeds (train, val, test) goes through the chain
    # once: two launches of kernel 5 per forward.
    want.update(fused_canny=2 * CLI_FORWARDS, hysteresis=2 * CLI_FORWARDS, conv3x3=0)
    check(trained == want, f"Canny cli.train launches {trained}, want {want}")
    hist, best = _history(os.path.join(save, "eelunet"))
    out, evaluated, wall_e = _cli("9", "evaluate", [
        "--model_type", "eelunet", "--data_dir", tree, "--image_size", "512",
        "--batch_size", "8", "--set", "model.dtype=bfloat16", "--seed", str(SEED),
        "--checkpoint", best, *flags])
    want_e = {k: 2 if k in FWD else 0 for k in HIGHPASS}
    want_e.update(fused_canny=2, hysteresis=2, conv3x3=0)
    check(evaluated == want_e, f"Canny cli.evaluate launches {evaluated}, want {want_e}")
    metrics = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("metrics: ")).split(": ", 1)[1])
    recorded = hist["metrics"][int(np.argmin(hist["val_loss"]))]
    diff = max(abs(metrics[k] - recorded[k]) for k in recorded)
    print(f"[9] Canny cli.train {wall:.1f} s wall for 2 epochs, launches {trained}; "
          f"cli.evaluate on the best tag {wall_e:.1f} s wall, launches {evaluated}; its metrics "
          f"vs the training run's for that tag: max|d| {diff:.3e} (dice {metrics['dice']:.4f}, "
          f"boundary_f1 {metrics['boundary_f1']:.4f})", flush=True)
    check(metrics == recorded, f"cli.evaluate {metrics} != the training run's {recorded}")
    return {k: trained[k] + evaluated[k] for k in (*KERNELS, "hysteresis")}, best


# Phase 10: the other families at their published widths (the JAX
# package's defaults), with their parameter counts in millions
# (tests/test_models.py:18-25; U-Net++ has none and is printed only).
FAMILIES = {"unet": 31.03, "unet++": None, "unext": 1.47, "unext_s": 0.25,
            "egeunet": 0.044, "malunet": 0.178}
# Served forward (bf16, BN folded where the family folds) against the same
# weights in float32, unfolded, on the card: the mean |d prob| and the share
# of pixels whose mask (p > 0.5) differs. With random weights the logits of
# EGE-UNet and MALUNet reach +-40, and bf16 rounding grows through GHPA's and
# the attention's products, so single pixels near p = 0.5 move by up to
# ~0.4, in the JAX package's bf16 model as in the port's
# (tests/test_torch_port_families_forward.py holds the port's drift to
# JAX's); the mean and the mask are what a wrong bf16 path moves.
FAMILY_TOL = {"mean": 1e-2, "mask": 1e-2}


def _family_phase(name: str, workdir: str, raw_batches):
    """One family in-process: parameter count, the served forward against
    float32 and its time, three timed train steps, no kernel launched."""
    import dataclasses

    import torch

    from eelunet_tpu_torch.cli.common import kernel_launches
    from eelunet_tpu_torch.config import ModelConfig, TrainConfig, apply_overrides
    from eelunet_tpu_torch.data.augment import make_input_preprocess, normalize_imagenet
    from eelunet_tpu_torch.inference import build_serving_model
    from eelunet_tpu_torch.nn.layers import nchw
    from eelunet_tpu_torch.ops import conv_cuda, edge_cuda, fft_cuda
    from eelunet_tpu_torch.registry import MODEL_REGISTRY, seg_probabilities
    from eelunet_tpu_torch.train.trainer import Trainer, make_train_step

    def reset():
        for mod in (fft_cuda, edge_cuda, conv_cuda):
            mod.reset_launches()

    dev = torch.device("cuda")
    meta = MODEL_REGISTRY[name]
    cfg = ModelConfig(name=name, dtype="bfloat16")
    sd = _random_upstream_checkpoint(cfg, os.path.join(workdir, f"{name}_random.npz"))
    n_params = sum(v.numel() for k, v in sd.items()
                   if not k.endswith(("running_mean", "running_var", "num_batches_tracked")))
    want_m = FAMILIES[name]
    check(want_m is None or abs(n_params / 1e6 - want_m) < 0.005,
          f"{name}: {n_params / 1e6:.4f}M parameters, want {want_m}M")

    rng = np.random.default_rng(SEED + 6)
    u8 = torch.from_numpy(rng.integers(0, 256, (16, 512, 512, 3), dtype=np.uint8)).to(dev)
    x = nchw(normalize_imagenet(u8.float() / 255.0)).contiguous(memory_format=torch.channels_last)
    served = build_serving_model(sd, cfg, dev)
    ref = build_serving_model(sd, dataclasses.replace(cfg, dtype="float32"), dev, fold_bn=False)
    folded = sum(1 for k in sd if k.endswith("running_mean")) - sum(
        1 for k in served.state_dict() if k.endswith("running_mean"))
    xb = x.to(torch.bfloat16)
    with torch.inference_mode():
        reset()
        out = served(xb)
        torch.cuda.synchronize()
        launched = kernel_launches()
        p_bf16 = seg_probabilities(out, meta)
        p_f32 = seg_probabilities(ref(x), meta)
        d = (p_bf16 - p_f32).abs()
        flips = ((p_bf16 > 0.5) != (p_f32 > 0.5)).float().mean().item()
        aux_ok = len(out.aux) == (5 if name == "egeunet" else 0) and all(
            bool(torch.isfinite(a).all()) and tuple(a.shape) == (16, 1, 512, 512) for a in out.aux)
        check(bool(torch.isfinite(p_bf16).all()) and tuple(p_bf16.shape) == (16, 1, 512, 512)
              and aux_ok, f"{name}: served output {tuple(p_bf16.shape)}")
        check(d.mean().item() <= FAMILY_TOL["mean"] and flips <= FAMILY_TOL["mask"],
              f"{name}: bf16 vs float32 mean|d prob| {d.mean().item():.3e}, mask pixels "
              f"differing {flips:.3e} (bounds {FAMILY_TOL})")
        check(set(launched.values()) == {0}, f"{name}: kernels launched: {launched}")
        fwd_ms = cuda_ms(lambda: served(xb), iters=5)
    del served, ref, out, p_f32, x, xb, u8
    torch.cuda.empty_cache()

    tcfg = apply_overrides(TrainConfig(), [
        f"model.name={name}", "model.dtype=bfloat16", "data.image_size=512",
        "data.batch_size=8", f"seed={SEED}", f"save_dir={workdir}/ckpt_{name}_inproc"])
    trainer = Trainer(tcfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=4)
    step = make_train_step(trainer.loss_fn, trainer.amp_dtype)
    preprocess = make_input_preprocess(tcfg.data)
    batches = [preprocess(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
               for a, b in raw_batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset()
    losses = [step(state, *batches[0])[0]]  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses += [step(state, *batches[i % 2])[0] for i in range(1, 4)]
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 3
    launched = kernel_launches()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [v.item() for v in losses]
    check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    check(set(launched.values()) == {0}, f"{name}: kernels launched in training: {launched}")
    print(f"[10] {name}: {n_params / 1e6:.4f}M params (want {want_m}); served 512^2 b16 bf16 "
          f"({folded} BNs folded): {fwd_ms:.2f} ms/batch ({16e3 / fwd_ms:.1f} img/s), "
          f"vs float32 unfolded mean|d prob| {d.mean().item():.3e}, mask pixels differing "
          f"{flips:.3e} (bounds {FAMILY_TOL}), max|d prob| {d.max().item():.3e}; "
          f"train 512^2 b8 bf16 autocast, {trainer.loss_name}: "
          f"{step_ms:.2f} ms/step over 3 steps after 1 warm ({8e3 / step_ms:.1f} img/s), "
          f"losses {[round(v, 4) for v in losses]}, peak {peak:.2f} GiB; kernel launches 0",
          flush=True)
    del state, trainer, batches
    torch.cuda.empty_cache()
    return {"forward_ms": fwd_ms, "step_ms": step_ms, "peak_gib": peak}


def phase_families(workdir: str, tree: str):
    """The other five families (six models): each in-process, then EGE-UNet
    through cli.train with both Canny flags (the edge channel among them)
    and cli.evaluate on its best tag, and UNeXt-S through cli.serve from an
    upstream-layout .npz.
    Returns the launches of the two CLI runs of EGE-UNet, summed."""
    t0 = time.monotonic()
    raw_batches = _train_batches(2, 8, SEED + 7)
    for name in FAMILIES:
        _family_phase(name, workdir, raw_batches)

    # both Canny flags, as phase 9: the edge channel and the enhancement
    flags = [a for f in CANNY_FLAGS for a in ("--set", f)]
    save, logs = os.path.join(workdir, "ckpt_ege"), os.path.join(workdir, "runs_ege")
    _, trained, wall = _cli("10", "train", _train_args(tree, save, logs, "egeunet") + flags)
    want = {k: 0 for k in (*KERNELS, "hysteresis")}
    want.update(fused_canny=2 * CLI_FORWARDS, hysteresis=2 * CLI_FORWARDS)
    check(trained == want, f"EGE-UNet cli.train launches {trained}, want {want}")
    hist, best = _history(os.path.join(save, "egeunet"), "egeunet")
    out, evaluated, wall_e = _cli("10", "evaluate", [
        "--model_type", "egeunet", "--data_dir", tree, "--image_size", "512",
        "--batch_size", "8", "--set", "model.dtype=bfloat16", "--seed", str(SEED),
        "--checkpoint", best, *flags])
    want_e = {k: 0 for k in (*KERNELS, "hysteresis")}
    want_e.update(fused_canny=2, hysteresis=2)
    check(evaluated == want_e, f"EGE-UNet cli.evaluate launches {evaluated}, want {want_e}")
    metrics = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("metrics: ")).split(": ", 1)[1])
    recorded = hist["metrics"][int(np.argmin(hist["val_loss"]))]
    print(f"[10] EGE-UNet cli.train with both Canny flags: {wall:.1f} s wall for 2 epochs, "
          f"launches {trained}; cli.evaluate on its best tag {wall_e:.1f} s wall, launches "
          f"{evaluated}; metrics vs the training run's max|d| "
          f"{max(abs(metrics[k] - recorded[k]) for k in recorded):.3e}", flush=True)
    check(metrics == recorded, f"cli.evaluate {metrics} != the training run's {recorded}")

    from eelunet_tpu_torch.config import ModelConfig

    ckpt = os.path.join(workdir, "unext_s_upstream.npz")
    _random_upstream_checkpoint(ModelConfig(name="unext_s", dtype="bfloat16"), ckpt)
    served = phase_serve(ckpt, workdir, model_type="unext_s", n_singles=6, phase="10")
    check(set(served.values()) == {0}, f"UNeXt-S cli.serve launches {served}")
    print(f"[10] families phase: {time.monotonic() - t0:.1f} s", flush=True)
    return {k: trained.get(k, 0) + evaluated.get(k, 0) for k in (*KERNELS, "hysteresis")}


# Phase 11: multi-class segmentation (3 classes: background and two) and the
# rest of the data feed and entry points: the packed, device-cached feed,
# the traced window, the async checkpoint writer, cli.predict.
CLASSES = 3
MC_FLAGS = ("--set", f"model.out_channels={CLASSES}")


def _state_equal(a, b) -> bool:
    """Nested state dicts equal, tensors bit for bit."""
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    return a == b


def _host_copy(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_copy(v) for v in tree)
    return tree


def _mc_batches(n_batches: int, batch: int, seed: int):
    """Seeded 3-class (uint8 image, uint8 id mask) batches at 512^2, NHWC."""
    from eelunet_tpu_torch.data.synthetic import make_multiclass_sample

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        pairs = [make_multiclass_sample(rng, 512, 512, CLASSES) for _ in range(batch)]
        out.append((np.stack([(p[0] * 255).astype(np.uint8) for p in pairs]),
                    np.stack([p[1].astype(np.uint8) for p in pairs])))
    return out


def _multiclass_step(workdir: str):
    """11a: the 3-class EELUnet's train step in-process at 512^2 b8 bf16 on
    ``edge_ce_dice``: launches, ms, peak memory, kernels vs lowrank. Returns
    (the timed steps' launches, an upstream-layout tag of the trained
    weights, ms per step)."""
    import torch

    from eelunet_tpu_torch.config import TrainConfig, apply_overrides
    from eelunet_tpu_torch.data.augment import make_input_preprocess
    from eelunet_tpu_torch.ops import fft_cuda
    from eelunet_tpu_torch.train.trainer import Trainer, make_train_step

    dev = torch.device("cuda")
    cfg = apply_overrides(TrainConfig(), [
        "model.name=eelunet", f"model.out_channels={CLASSES}", "model.dtype=bfloat16",
        f"model.fft_mask_range={MASK_RANGE}", "data.image_size=512", "data.batch_size=8",
        f"seed={SEED}", f"save_dir={workdir}/ckpt_mc_inproc"])
    trainer = Trainer(cfg, device="cuda")
    check(trainer.loss_name == "edge_ce_dice", f"criterion {trainer.loss_name}")
    state = trainer.init_state(steps_per_epoch=4)
    step = make_train_step(trainer.loss_fn, trainer.amp_dtype)
    preprocess = make_input_preprocess(cfg.data, CLASSES)
    batches = [preprocess(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
               for x, y in _mc_batches(2, 8, SEED + 11)]
    check(set(torch.unique(batches[0][1]).tolist()) <= {0.0, 1.0, 2.0}, "labels are not ids")
    step(state, *batches[0])  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fft_cuda.reset_launches()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    losses = [step(state, *batches[i % 2])[0] for i in range(3)]
    end.record()
    torch.cuda.synchronize()
    launches = dict(fft_cuda.LAUNCHES)
    ms = start.elapsed_time(end) / 3
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [v.item() for v in losses]
    print(f"[11a] 3-class EELUnet 512^2 b8 bf16 autocast, edge_ce_dice: {ms:.2f} ms/step "
          f"({8e3 / ms:.1f} img/s) over 3 steps after a warm one; peak memory {peak:.2f} GiB; "
          f"losses {[round(v, 4) for v in losses]}; launches {launches}", flush=True)
    check(launches == {k: 6 for k in HIGHPASS}, f"launches over 3 steps: {launches}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    _kernels_vs_lowrank("11a", state.model, trainer.loss_fn, batches[0], f64_anchor=True)
    tag = trainer.ckpt.save_weights_tags(["mc"], state.model.state_dict())[0]
    del state, trainer, batches
    torch.cuda.empty_cache()
    return launches, tag, ms


def _fit_in_process(cfg, tag: str):
    """Trainer.fit on ``cfg`` with every epoch's snapshot written by the
    background writer. Returns the history, and checks each snapshot
    against the state at the epoch it names: epoch 1's copied while epoch
    2 updates the live tensors in place, epoch 2's at the end."""
    from eelunet_tpu_torch.cli.common import build_loaders
    from eelunet_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device="cuda")
    tr, va, te = build_loaders(trainer.cfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=len(tr))
    at_epoch = {}

    def log(line):
        if line.startswith("Epoch ["):
            at_epoch[int(line[7:line.index("/")])] = _host_copy(state.state_dict())

    state, hist = trainer.fit(tr, va, te, state=state, log=log)
    import torch

    for epoch, want in at_epoch.items():
        path = os.path.join(trainer.ckpt.root, f"eelunet_epoch_{epoch}", "state.pt")
        saved = torch.load(path, map_location="cpu", weights_only=True)
        check(_state_equal(saved, want),
              f"{tag}: the background snapshot of epoch {epoch} differs from the state then")
    shutil.rmtree(trainer.ckpt.root)
    del trainer, state
    return hist


def _multiclass_feed(workdir: str):
    """11b: cli.pack --multiclass, then cli.train on the PNG tree and on the
    pack with the device cache and a traced window, both with the Canny
    flags and the async writer (default); their first batches, losses
    against the spread of two identical streamed runs, the trace, and the
    background writer's snapshots. Returns (the CLI runs' launches, the
    PNG run's best tag and history, the tree)."""
    import torch

    from eelunet_tpu_torch.cli.common import build_loaders
    from eelunet_tpu_torch.config import TrainConfig, apply_overrides
    from eelunet_tpu_torch.data.synthetic import write_synthetic_tree

    t0 = time.monotonic()
    tree = write_synthetic_tree(os.path.join(workdir, "tree3"), n_train=24, n_test=8,
                                image_size=(512, 512), seed=SEED + 12, num_classes=CLASSES)
    packed = os.path.join(workdir, "packed3")
    _, packed_l, wall_p = _cli("11b", "pack", ["--data_dir", tree, "--out", packed,
                                               "--image_size", "512", "--multiclass"])
    check(set(packed_l.values()) == {0}, f"cli.pack launches {packed_l}")
    flags = [a for f in CANNY_FLAGS for a in ("--set", f)] + list(MC_FLAGS)
    runs = {}
    for name, data_dir, extra in (
            ("png", tree, []),
            ("packed", packed, ["--set", "data.packed=true", "--set", "data.device_cache=true",
                                "--set", "profile_steps=2"])):
        save = os.path.join(workdir, f"ckpt_mc_{name}")
        logs = os.path.join(workdir, f"runs_mc_{name}")
        out, launches, wall = _cli("11b", "train",
                                   _train_args(data_dir, save, logs) + flags + extra)
        hist, best = _history(os.path.join(save, "eelunet"))
        epoch_s = [float(ln.rsplit("(", 1)[1].rstrip("s)")) for ln in out.splitlines()
                   if ln.startswith("Epoch [")]
        runs[name] = (launches, wall, hist, best, logs, epoch_s)
    want = {k: 2 * (CLI_FORWARDS if k in FWD else CLI_STEPS) for k in HIGHPASS}
    want.update(fused_canny=2 * CLI_FORWARDS, hysteresis=2 * CLI_FORWARDS, conv3x3=0)
    for name, (launches, *_r) in runs.items():
        check(launches == want, f"3-class cli.train ({name}) launches {launches}, want {want}")

    # The two feeds give the same batches: the first of each epoch, byte for byte.
    base = ["model.name=eelunet", f"model.out_channels={CLASSES}", "model.dtype=bfloat16",
            "data.image_size=512", "data.batch_size=8", f"seed={SEED}", *CANNY_FLAGS]
    streamed = build_loaders(apply_overrides(TrainConfig(), base + [f"data.data_dir={tree}"]))[0]
    cached = build_loaders(apply_overrides(TrainConfig(), base + [
        f"data.data_dir={packed}", "data.packed=true", "data.device_cache=true"]),
        device="cuda")[0]
    for epoch in (0, 1):
        streamed.set_epoch(epoch)
        cached.set_epoch(epoch)
        (sx, sy), (cx, cy) = next(iter(streamed)), next(iter(cached))
        check(cx.is_cuda, "the cached batch is not on the card")
        check(np.array_equal(sx, cx.cpu().numpy()) and np.array_equal(sy, cy.cpu().numpy()),
              f"epoch {epoch}: the first batches of the two feeds differ")
    del cached
    torch.cuda.empty_cache()

    # Run to run: two identical streamed fits in-process (every epoch
    # snapshotted by the background writer, each snapshot checked).
    hists = [_fit_in_process(apply_overrides(TrainConfig(), base + [
        f"data.data_dir={tree}", f"save_dir={workdir}/ckpt_mc_rr{i}",
        f"log_dir={workdir}/runs_mc_rr{i}", "epochs=2", "snapshot_every=1"]), f"run {i}")
        for i in (0, 1)]

    def spread(a, b):
        return max(abs(x - y) / abs(y) for k in ("train_loss", "val_loss")
                   for x, y in zip(a[k], b[k]))

    rr = spread(*hists)
    bound = max(4 * rr, 1e-6)
    d_feed = spread(runs["packed"][2], runs["png"][2])
    print(f"[11b] 3-class cli.train with both Canny flags, 2 epochs: PNG tree {runs['png'][1]:.1f} s "
          f"wall (epochs {runs['png'][5]} s), packed + device cache + 2 traced steps "
          f"{runs['packed'][1]:.1f} s (epochs {runs['packed'][5]} s; cli.pack "
          f"{wall_p:.1f} s); launches {runs['png'][0]}; per-epoch losses PNG "
          f"{runs['png'][2]['train_loss']} / {runs['png'][2]['val_loss']}, packed "
          f"{runs['packed'][2]['train_loss']} / {runs['packed'][2]['val_loss']}: max rel "
          f"{d_feed:.2e}; two identical streamed runs in-process: max rel {rr:.2e} (bound "
          f"max(4 x that, 1e-6) = {bound:.2e}); first batches of epochs 1 and 2 byte-equal; the "
          f"background writer's snapshots equal the state at their epochs", flush=True)
    check(d_feed <= bound, f"packed feed vs PNG feed {d_feed:.2e} > {bound:.2e}")

    prof = os.path.join(runs["packed"][4], "eelunet", "profile")
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")] \
        if os.path.isdir(prof) else []
    check(len(traces) == 1, f"profile directory {prof}: {traces}")
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"[11b] trace {traces[0]}: {len(events)} events, {kernels} CUDA kernel records "
          f"(the traced window is step 1 of epoch 1: an epoch has {CLI_STEPS // 2} steps)",
          flush=True)
    check(kernels > 0, "the trace holds no CUDA kernel")
    print(f"[11b] {time.monotonic() - t0:.1f} s", flush=True)
    total = {k: runs["png"][0][k] + runs["packed"][0][k] for k in want}
    return total, runs["png"][3], runs["png"][2], tree


def _read_masks(out: str, n: int):
    from PIL import Image

    line = next(ln for ln in out.splitlines() if ln.startswith("Saved "))
    out_dir = line.rsplit(" to ", 1)[1]
    return np.stack([np.asarray(Image.open(os.path.join(out_dir, f"pred_{i}.png")))
                     for i in range(n)])


def phase_multiclass(workdir: str, tree: str, canny_best: str):
    """Phase 11: the 3-class EELUnet step (11a), the data feed (11b),
    cli.evaluate with the Canny flags (11c), cli.predict binary (resize,
    TTA, Canny) and 3-class (tiled) (11d), and cli.serve's class ids (11e).
    Returns the launches of its paths, summed."""
    import torch
    from PIL import Image

    from eelunet_tpu_torch.config import DataConfig, ModelConfig
    from eelunet_tpu_torch.data.augment import make_input_preprocess
    from eelunet_tpu_torch.data.synthetic import write_synthetic_tree
    from eelunet_tpu_torch.inference import Predictor

    t0 = time.monotonic()
    dev = torch.device("cuda")
    keys = (*KERNELS, "hysteresis")
    total = dict.fromkeys(keys, 0)
    step_l, mc_tag, _ = _multiclass_step(workdir)
    feed_l, mc_best, mc_hist, tree3 = _multiclass_feed(workdir)
    for part in (step_l, feed_l):
        for k, v in part.items():
            total[k] += v

    # 11c: cli.evaluate of the PNG run's best tag, with the flags it trained with.
    flags = [a for f in CANNY_FLAGS for a in ("--set", f)] + list(MC_FLAGS)
    out, evaluated, wall_e = _cli("11c", "evaluate", [
        "--model_type", "eelunet", "--data_dir", tree3, "--image_size", "512",
        "--batch_size", "8", "--set", "model.dtype=bfloat16", "--seed", str(SEED),
        "--checkpoint", mc_best, *flags])
    want_e = {k: 2 if k in FWD else 0 for k in HIGHPASS}
    want_e.update(fused_canny=2, hysteresis=2, conv3x3=0)
    check(evaluated == want_e, f"3-class cli.evaluate launches {evaluated}, want {want_e}")
    metrics = json.loads(next(ln for ln in out.splitlines()
                              if ln.startswith("metrics: ")).split(": ", 1)[1])
    recorded = mc_hist["metrics"][int(np.argmin(mc_hist["val_loss"]))]
    table = [ln for ln in out.splitlines() if ln.startswith("|")]
    print(f"[11c] 3-class cli.evaluate {wall_e:.1f} s wall, launches {evaluated}; metrics vs "
          f"the training run's max|d| {max(abs(metrics[k] - recorded[k]) for k in recorded):.3e} "
          f"(miou {metrics['miou']:.4f}, mdice {metrics['mdice']:.4f}); per class:", flush=True)
    for line in table:
        print(f"[11c]   {line}")
    check(len(table) == 1 + CLASSES, f"per-class table: {table}")
    check(metrics == recorded, f"cli.evaluate {metrics} != the training run's {recorded}")
    for k in keys:
        total[k] += evaluated[k]

    # 11d: cli.predict. Binary: phase 9's best tag (trained with both Canny
    # flags) on phase 7's test split, TTA, the chain on the card.
    test_dir = os.path.join(tree, "test", "images")
    names = sorted(os.listdir(test_dir))
    canny = [a for f in CANNY_FLAGS for a in ("--set", f)]
    out, pred_b, wall_b = _cli("11d", "predict", [
        "--model_type", "eelunet", "--data_dir", tree, "--image_size", "512",
        "--batch_size", "16", "--set", "model.dtype=bfloat16", "--set", "tta=true", *canny,
        "--checkpoint", canny_best, "--results_dir", os.path.join(workdir, "pred_binary")])
    want_b = {k: 8 if k in FWD else 0 for k in HIGHPASS}  # 4 flips x 2 per forward
    want_b.update(fused_canny=2, hysteresis=2, conv3x3=0)
    check(pred_b == want_b, f"binary cli.predict launches {pred_b}, want {want_b}")
    got = _read_masks(out, len(names))
    u8 = torch.from_numpy(np.stack([np.asarray(Image.open(os.path.join(test_dir, f))
                                               .convert("RGB")) for f in names])).to(dev)
    data = DataConfig(add_canny_edge=True, canny_enhance=True)
    x, _ = make_input_preprocess(data)(u8, torch.zeros((1, 1, 1, 1), device=dev))
    ref_pred = Predictor(ModelConfig(name="eelunet", dtype="bfloat16", in_channels=4),
                         checkpoint=canny_best, tta=True, device="cuda")
    ref = ref_pred.predict(x)
    check(got.shape == (len(names), 512, 512) and set(np.unique(got)) <= {0, 255},
          f"binary masks {got.shape} {np.unique(got)}")
    check(np.array_equal(got, (ref[..., 0] * 255).astype(np.uint8)),
          f"binary cli.predict masks differ from Predictor.predict in "
          f"{int((got != ref[..., 0] * 255).sum())} pixels")
    t1 = time.perf_counter()
    for _ in range(3):  # the chain and 4 flipped forwards per batch, then the readback
        ref_pred.predict(make_input_preprocess(data)(u8, torch.zeros((1, 1, 1, 1),
                                                                     device=dev))[0])
    resize_ms = (time.perf_counter() - t1) / 3 * 1e3

    # 3-class, tiled at native size: 700x1000 images take 2 x 3 tiles of 512
    # (a chunk of 6, padded to the bucket of 8), 5 images.
    native = (700, 1000)
    tree_n = write_synthetic_tree(os.path.join(workdir, "tree_native"), n_train=1, n_test=5,
                                  image_size=native, seed=SEED + 13, num_classes=CLASSES)
    out, pred_t, wall_t = _cli("11d", "predict", [
        "--model_type", "eelunet", "--data_dir", tree_n, "--set", "model.dtype=bfloat16",
        *MC_FLAGS, "--tile", "512", "--tile_overlap", "64", "--checkpoint", mc_tag,
        "--results_dir", os.path.join(workdir, "pred_tiled")])
    want_t = {k: 10 if k in FWD else 0 for k in HIGHPASS}  # one forward of 6 tiles per image
    want_t.update(fused_canny=0, hysteresis=0, conv3x3=0)
    check(pred_t == want_t, f"tiled cli.predict launches {pred_t}, want {want_t}")
    masks = _read_masks(out, 5)
    check(masks.shape == (5, *native) and set(np.unique(masks)) <= set(range(CLASSES)),
          f"tiled masks {masks.shape} {np.unique(masks)}")
    first = np.asarray(Image.open(os.path.join(tree_n, "test", "images", "0000.png"))
                       .convert("RGB"))
    mc_pred = Predictor(ModelConfig(name="eelunet", dtype="bfloat16", out_channels=CLASSES),
                        checkpoint=mc_tag, device="cuda")
    ref_t = mc_pred.predict_tiled(first[None], tile=512, overlap=64)
    check(np.array_equal(masks[0], ref_t[0, ..., 0].astype(np.uint8)),
          "tiled cli.predict differs from Predictor.predict_tiled")
    t1 = time.perf_counter()
    for _ in range(3):
        mc_pred.predict_tiled(first[None], tile=512, overlap=64)
    tiled_ms = (time.perf_counter() - t1) / 3 * 1e3
    print(f"[11d] cli.predict binary (resize, TTA, both Canny flags, 8 images): {wall_b:.1f} s "
          f"wall, launches {pred_b}, masks equal to Predictor.predict with the same chain; "
          f"3-class tiled (512, overlap 64) on 5 images of {native[0]}x{native[1]}: "
          f"{wall_t:.1f} s wall, launches {pred_t}, ids {sorted(np.unique(masks).tolist())}, "
          f"the first equal to Predictor.predict_tiled. In-process, host clock to the masks on "
          f"the host: a batch of 8 with the chain and TTA {resize_ms:.1f} ms "
          f"({8e3 / resize_ms:.1f} img/s); one {native[0]}x{native[1]} image tiled "
          f"{tiled_ms:.1f} ms ({1e3 / tiled_ms:.1f} img/s)", flush=True)
    for part in (pred_b, pred_t):
        for k in keys:
            total[k] += part[k]

    # 11e: cli.serve with the 3-class tag, one mask request.
    with _server(mc_tag, workdir, "eelunet", "11e", extra=MC_FLAGS) as base:
        img = np.asarray(Image.open(os.path.join(tree3, "test", "images", "0000.png"))
                         .convert("RGB"))
        code, body, _ = _http(base + "/v1/predict?output=mask", _npy(img))
        served = json.loads(_http(base + "/v1/stats")[1])["kernel_launches"]
    ids = np.load(io.BytesIO(body))
    want_ids = mc_pred.predict(img[None])
    check(code == 200 and ids.shape == (1, 512, 512, 1), f"serve mask {code} {ids.shape}")
    check(np.array_equal(ids, want_ids), "cli.serve class ids differ from the Predictor's")
    check(served == {"highpass_contract": 2, "highpass_expand": 2, "highpass_bwd_contract": 0,
                     "highpass_bwd_expand": 0}, f"cli.serve launches {served}")
    print(f"[11e] 3-class cli.serve: one mask request, ids {sorted(np.unique(ids).tolist())} "
          f"equal to the Predictor's argmax; launches {served}", flush=True)
    for k, v in served.items():
        total[k] += v
    del mc_pred, ref_pred
    torch.cuda.empty_cache()
    print(f"[11] multi-class and predict phase: {time.monotonic() - t0:.1f} s; launches "
          f"{total}", flush=True)
    return total


# ------------------------------------------- phase 12: compression and deployment

# The slim models of phase 12: (amount, round_to), cli.prune's default
# round_to for the EELUnet. At 0.3 the high-pass sites keep C = 96 at 256^2
# and 64 at 512^2; at 0.5, 64 and 32.
PRUNE = ((0.3, 32), (0.5, 32))
SLIM_SITES = ((16, 256, 256, 96), (16, 512, 512, 32))
SLIM_TRAIN_SITES = ((8, 256, 256, 96), (8, 512, 512, 32))
# The slim model against its masked model in float32: JAX's bound for the
# EELUnet slice (tests/test_prune_physical.py:212), |d| <= atol + rtol |want|.
SLIM_TOL = (3e-5, 1e-4)
# The int8 Predictor's probabilities against the bf16 one: JAX's bound
# (tests/test_quantize.py:176).
QUANT_PROB_TOL = 0.1
# An exported program against the Predictor pinned to the low-rank high-pass.
ARTIFACT_TOL = 1e-5
# cli.prune --physical --finetune_epochs 1 on phase 7's tree (batch 8): three
# evaluations of the 8 test images, 2 finetune steps, 1 val forward and the
# slim model's evaluation.
PRUNE_FORWARDS, PRUNE_STEPS = 3 + 2 + 1 + 1, 2


def _slim_kernel_rows(shape, dname, bwd: bool):
    """Kernels 1-2 (or 3-4 with ``bwd``) against their twins at a slim
    high-pass site, with kernel and twin times; printed with their bounds."""
    import torch

    from eelunet_tpu_torch.ops import fft_cuda

    dev = torch.device("cuda")
    dtype = torch.float32 if dname == "float32" else torch.bfloat16
    b, h, w, c = shape
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    x = torch.randn(shape, generator=gen, device=dev).to(dtype)
    x3 = x.view(b, h, w * c)
    rows = {}
    with torch.inference_mode():
        if not bwd:
            vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = fft_cuda.factor_tensors(
                h, w, MASK_RANGE, dtype, dev)
            tk = fft_cuda.highpass_contract(x3, vr_t, vi_t)
            tp = fft_cuda.highpass_contract_plain(x3, vr_t, vi_t)
            e_c = max(rel_err(tk[0], tp[0]), rel_err(tk[1], tp[1]), key=lambda e: e[1])
            s_r, s_i = fft_cuda.w_axis_middle(tp[0], tp[1], uwr, uwi, vwr, vwi, w, c)
            del tk, tp
            ok_ = fft_cuda.highpass_expand(x3, uhr, uhi, s_r, s_i)
            op_ = fft_cuda.highpass_expand_plain(x3, uhr, uhi, s_r, s_i)
            e_e = rel_err(ok_, op_)
            del ok_, op_
            # kernel 1's yardstick, as phase 3: one bmm writing T in f32
            v_stack = torch.cat([vr_t.t(), vi_t.t()]).contiguous().expand(b, -1, h)
            out_dt = {"out_dtype": torch.float32} if dtype == torch.bfloat16 else {}
            ms_c, lib_c, _ = in_turns(lambda: fft_cuda.highpass_contract(x3, vr_t, vi_t),
                                      lambda: torch.bmm(v_stack, x3, **out_dt))
            rows["highpass_contract"] = (e_c, ms_c, cuda_ms(
                lambda: fft_cuda.highpass_contract_plain(x3, vr_t, vi_t)), lib_c)
            rows["highpass_expand"] = (e_e, cuda_ms(
                lambda: fft_cuda.highpass_expand(x3, uhr, uhi, s_r, s_i)), cuda_ms(
                lambda: fft_cuda.highpass_expand_plain(x3, uhr, uhi, s_r, s_i)), None)
            _print_rows("12a", rows, shape, dname, TOL[dname], uhr.shape[1])
        else:
            g3 = torch.randn(shape, generator=gen, device=dev).to(dtype).view(b, h, w * c)
            vr_t, vi_t, uhr, uhi, uwr, uwi, vwr, vwi = fft_cuda.factor_tensors(
                h, w, MASK_RANGE, torch.float32, dev)
            _, s_r, s_i = fft_cuda.highpass_fwd(x, MASK_RANGE)
            uk, trk, tik = fft_cuda.highpass_bwd_contract(x3, g3, uhr, uhi, s_r, s_i)
            up, trp, tip = fft_cuda.highpass_bwd_contract_plain(x3, g3, uhr, uhi, s_r, s_i)
            e_t = max(rel_err(trk, trp)[1], rel_err(tik, tip)[1])
            e_u = (rel_err(uk, up)[0], rel_l2(uk, up))
            r_r, r_i = fft_cuda.w_axis_middle(trp, tip, vwr.T, vwi.T, uwr.T, uwi.T, w, c)
            del uk, trk, tik, trp, tip
            dk = fft_cuda.highpass_bwd_expand(up, vr_t, vi_t, r_r, r_i)
            dp = fft_cuda.highpass_bwd_expand_plain(up, vr_t, vi_t, r_r, r_i)
            e_d = (rel_err(dk, dp)[0], rel_l2(dk, dp))
            del dk, dp
            print(f"[12a] highpass_bwd_contract T {str(shape):22s} {dname:8s} rel {e_t:.3e} "
                  f"(bound {TOL['float32']:g})")
            check(e_t <= TOL["float32"], f"bwd contract T {shape} {dname}: {e_t:.3e}")
            rows["highpass_bwd_contract"] = (e_u, cuda_ms(
                lambda: fft_cuda.highpass_bwd_contract(x3, g3, uhr, uhi, s_r, s_i)), cuda_ms(
                lambda: fft_cuda.highpass_bwd_contract_plain(x3, g3, uhr, uhi, s_r, s_i)), None)
            # kernel 4's yardstick, as phase 3b: an f32 baddbmm, TF32 on for
            # that call in a bf16 model
            v_cat = torch.cat([vr_t, -vi_t], dim=1).expand(b, h, 2 * vr_t.shape[1])
            r_cat = torch.cat([r_r, r_i], dim=1)
            u32 = up.float()

            def lib_f32():
                torch.backends.cuda.matmul.allow_tf32 = dtype == torch.bfloat16
                try:
                    return torch.baddbmm(u32, v_cat, r_cat, alpha=-1)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False

            ms_d, lib_d, _ = in_turns(
                lambda: fft_cuda.highpass_bwd_expand(up, vr_t, vi_t, r_r, r_i), lib_f32)
            rows["highpass_bwd_expand"] = (e_d, ms_d, cuda_ms(
                lambda: fft_cuda.highpass_bwd_expand_plain(up, vr_t, vi_t, r_r, r_i)), lib_d)
            _print_rows("12a", rows, shape, dname, BWD_TOL[dname], uhr.shape[1], metric="rel-l2")
    del x, x3
    torch.cuda.empty_cache()


def _slim_close(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|) over the seg and aux
    maps (<= 1 passes SLIM_TOL)."""
    atol, rtol = SLIM_TOL
    return max(((g.float() - w.float()).abs() / (atol + rtol * w.float().abs())).max().item()
               for g, w in zip((got.seg, *got.aux), (want.seg, *want.aux)))


def _phase12_slim(sd, x16):
    """12a: masks, the slice and the slim models on the card; the kernels at
    the slim sites; the slim served forwards timed beside the unpruned one."""
    import dataclasses

    import torch

    from eelunet_tpu_torch.config import ModelConfig
    from eelunet_tpu_torch.inference import build_serving_model
    from eelunet_tpu_torch.ops import fft_cuda
    from eelunet_tpu_torch.prune import apply_masks
    from eelunet_tpu_torch.prune_physical import (
        eelunet_prune_masks,
        param_count,
        physical_prune_eelunet,
        slim_eelunet,
    )
    from eelunet_tpu_torch.registry import create_model

    # float32 means float32 (phase 3 sets the same): TF32 convs would miss
    # the slice's float32 bound by their own rounding
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg32 = ModelConfig(name="eelunet", fft_mask_range=MASK_RANGE)
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    # The JAX package serves slim models unfolded; the unpruned model is
    # timed both ways, and the slim ones folded too, to tell the slice's
    # effect from the fold's.
    served = {"unpruned (BN folded)": build_serving_model(sd, cfg16, dev),
              "unpruned (unfolded)": build_serving_model(sd, cfg16, dev, fold_bn=False)}
    for amount, rt in PRUNE:
        masks, _ = eelunet_prune_masks(sd, amount, rt)
        masked, _ = create_model(cfg32)
        masked.load_state_dict(sd)
        apply_masks(masked, masks)
        msd = masked.state_dict()
        slim_sd, widths = physical_prune_eelunet(msd, amount, rt)
        slim = slim_eelunet(widths, mask_range=MASK_RANGE)
        slim.load_state_dict(slim_sd)
        n0, n1 = param_count(masked), param_count(slim)
        masked = masked.to(dev, memory_format=torch.channels_last).eval()
        slim = slim.to(dev, memory_format=torch.channels_last).eval()
        with torch.inference_mode():
            want = masked(x16[:2])
            fft_cuda.reset_launches()
            got = slim(x16[:2])
            torch.cuda.synchronize()
            launches = dict(fft_cuda.LAUNCHES)
            f32 = _slim_close(got, want)
        del masked, slim, want, got
        m16 = build_serving_model(msd, cfg16, dev, fold_bn=False)
        s16 = build_serving_model(slim_sd, cfg16, dev, fold_bn=False, widths=widths)
        with torch.inference_mode():
            pw, pg = m16(x16.to(torch.bfloat16)).seg, s16(x16.to(torch.bfloat16)).seg
            mean = (pg - pw).abs().mean().item()
            mask = ((pg > 0.5) != (pw > 0.5)).float().mean().item()
        del m16, pw, pg
        sites = {k: widths[k] for k in ("eu2", "eu1")}
        print(f"[12a] amount {amount}, round_to {rt}: params {n0 / 1e6:.2f}M -> "
              f"{n1 / 1e6:.2f}M ({n1 / n0:.1%}); high-pass channels (eu2 at 256^2, eu1 at "
              f"512^2) {sites}; float32 b2 slim vs masked: max |d| / (atol + rtol |want|) "
              f"{f32:.3f} (bound 1; atol {SLIM_TOL[0]:g}, rtol {SLIM_TOL[1]:g}); bf16 b16: "
              f"mean |d prob| {mean:.3e}, masks disagree on {mask:.2e} of pixels (bounds "
              f"{FAMILY_TOL['mean']:g}, {FAMILY_TOL['mask']:g}); launches per slim forward "
              f"{launches}", flush=True)
        check(f32 <= 1.0, f"slim vs masked float32 at amount {amount}: {f32:.3f}")
        check(mean <= FAMILY_TOL["mean"] and mask <= FAMILY_TOL["mask"],
              f"slim vs masked bf16 at amount {amount}: mean {mean:.3e}, mask {mask:.2e}")
        check(launches == {k: 2 if k in FWD else 0 for k in HIGHPASS},
              f"launches per slim forward: {launches}")
        served[f"slim {amount} (unfolded)"] = s16
        served[f"slim {amount} (BN folded)"] = build_serving_model(slim_sd, cfg16, dev,
                                                                   widths=widths)
        torch.cuda.empty_cache()
    for shape in SLIM_SITES:
        for dname in ("float32", "bfloat16"):
            _slim_kernel_rows(shape, dname, bwd=False)
    for shape in SLIM_TRAIN_SITES:
        for dname in ("float32", "bfloat16"):
            _slim_kernel_rows(shape, dname, bwd=True)
    xb = x16.to(torch.bfloat16)
    names = list(served)
    with torch.inference_mode():
        turns = {n: [] for n in names}
        for n in names + names[::-1]:
            turns[n].append(cuda_ms(lambda: served[n](xb), iters=5))
    ms = {n: sum(t) / 2 for n, t in turns.items()}
    print("[12a] served forward 512^2 b16 bf16, in turns (each model, then the same in "
          "reverse): " + "; ".join(f"{n} {ms[n]:.2f} ms ({turns[n][0]:.2f}, {turns[n][1]:.2f})"
                                   for n in names), flush=True)
    del served, xb
    torch.cuda.empty_cache()
    return ms


def _phase12_cli(workdir: str, tree: str, best: str):
    """12b: cli.prune --physical on phase 7's best tag and tree, cli.evaluate
    and cli.serve on its slim checkpoint. Returns their launches."""
    import torch

    from eelunet_tpu_torch.config import ModelConfig
    from eelunet_tpu_torch.inference import Predictor, read_checkpoint
    from eelunet_tpu_torch.prune_physical import eelunet_prune_masks, is_slim_checkpoint

    out = os.path.join(workdir, "pruned")
    common = ["--model_type", "eelunet", "--data_dir", tree, "--image_size", "512",
              "--batch_size", "8", "--set", "model.dtype=bfloat16", "--seed", str(SEED),
              "--save_dir", os.path.join(workdir, "ckpt_prune"),
              "--set", f"log_dir={os.path.join(workdir, 'runs_prune')}"]
    stdout, pl, wall = _cli("12b", "prune", common + [
        "--checkpoint", best, "--physical", "--prune_amount", "0.3", "--finetune_epochs", "1",
        "--out", out])
    for line in stdout.splitlines():
        if line.startswith(("params:", "iou ", "dice ", "[finetune", "Saved")):
            print(f"[12b] {line}")
    want = {k: 2 * (PRUNE_FORWARDS if k in FWD else PRUNE_STEPS) for k in HIGHPASS}
    want.update(fused_canny=0, hysteresis=0, conv3x3=0)
    check(pl == want, f"cli.prune launches {pl}, want {want}")
    slim = out + "_slim"
    check(is_slim_checkpoint(slim), f"no slim checkpoint at {slim}")
    masks, _ = eelunet_prune_masks(read_checkpoint(best, "eelunet"), 0.3, 32)
    tuned = torch.load(os.path.join(out, "state.pt"), map_location="cpu",
                       weights_only=True)["model"]
    leaked = [k for k, m in masks.items() if bool((tuned[k][m == 0] != 0).any())]
    check(not leaked, f"masked channels not zero after the finetune: {leaked[:4]}")
    m_prune = json.loads(stdout.split("slim metrics: ", 1)[1].splitlines()[0])

    stdout, el, _ = _cli("12b", "evaluate", common + ["--checkpoint", slim])
    m_eval = json.loads(stdout.split("metrics: ", 1)[1].splitlines()[0])
    check(m_eval == m_prune, f"cli.evaluate on the slim checkpoint {m_eval} != cli.prune's "
          f"{m_prune}")
    check(el == {k: 2 if k in FWD else 0 for k in (*HIGHPASS, "fused_canny", "hysteresis",
                                                     "conv3x3")}, f"evaluate launches {el}")

    u8 = np.random.default_rng(SEED + 12).integers(0, 256, (1, 512, 512, 3), dtype=np.uint8)
    with _server(slim, workdir, "eelunet", "12b") as base:
        code, body, _ = _http(base + "/v1/predict", _npy(u8))
        got = np.load(io.BytesIO(body))
        sl = json.loads(_http(base + "/v1/stats")[1])["kernel_launches"]
    pred = Predictor(ModelConfig(name="eelunet", dtype="bfloat16"), checkpoint=slim,
                     device="cuda")
    want_p = pred.predict_proba(u8)
    d = float(np.abs(got - want_p).max())
    print(f"[12b] cli.prune {wall:.1f} s, launches {pl}; masked channels zero after the "
          f"finetune; cli.evaluate on {os.path.basename(slim)} equals cli.prune's slim metrics "
          f"{ {k: round(v, 4) for k, v in m_eval.items()} }; cli.serve on it: HTTP {code}, "
          f"max |d| to the slim Predictor {d:.3e} (bound 1e-2), launches {sl}", flush=True)
    check(code == 200 and got.shape == (1, 512, 512, 1) and d <= 1e-2, f"slim serve: {d}")
    check(all(sl[k] == (2 if k in FWD else 0) for k in HIGHPASS), f"serve launches {sl}")
    del pred
    torch.cuda.empty_cache()
    return {k: pl[k] + el[k] + sl.get(k, 0) for k in pl}


def _phase12_int8(best: str, u8):
    """12c: the int8 Predictor at 512^2 b16: its op counts against the CPU's,
    its probabilities against the bf16 Predictor's, one eligible conv's int
    product at a 512^2 site against the float64 twin, and both timed."""
    import dataclasses

    import torch

    from eelunet_tpu_torch.config import ModelConfig
    from eelunet_tpu_torch.inference import Predictor, build_serving_model, read_checkpoint
    from eelunet_tpu_torch.ops import fft_cuda
    from eelunet_tpu_torch import quantize as Q

    cfg = ModelConfig(name="eelunet", dtype="bfloat16", fft_mask_range=MASK_RANGE)
    dense = Predictor(cfg, checkpoint=best, device="cuda", proba_wire_dtype="float32")
    quant = Predictor(cfg, checkpoint=best, device="cuda", quantize="int8",
                      proba_wire_dtype="float32")
    fft_cuda.reset_launches()
    Q.reset_launches()
    pq = quant.predict_proba(u8)
    launches = dict(fft_cuda.LAUNCHES)
    int_mm = Q.LAUNCHES["int8_mm"]
    pd = dense.predict_proba(u8)
    d = float(np.abs(pq - pd).max())
    cpu_stats = {}
    cpu = Q.quantize_model(build_serving_model(read_checkpoint(best, "eelunet"),
                                               dataclasses.replace(cfg, dtype="float32"),
                                               "cpu"), stats=cpu_stats)
    with torch.inference_mode():
        cpu(torch.zeros((1, 3, 64, 64)))
    print(f"[12c] int8 Predictor 512^2 b16: quantized ops {quant.quant_stats} (the CPU's "
          f"{cpu_stats}); max |d prob| to the bf16 Predictor {d:.4f} (bound {QUANT_PROB_TOL}), "
          f"mean {float(np.abs(pq - pd).mean()):.2e}; launches per forward {launches}, "
          f"torch._int_mm calls {int_mm}", flush=True)
    check(quant.quant_stats == cpu_stats and cpu_stats["quantized_convs"] > 0,
          "int8 op counts differ from the CPU's")
    check(d <= QUANT_PROB_TOL and not np.array_equal(pq, pd), f"int8 vs bf16: {d}")
    check(launches == {k: 2 if k in FWD else 0 for k in HIGHPASS}, f"int8 launches {launches}")
    # one eligible conv at a 512^2 site (enc1.conv1, 64 -> 64, 3x3): the int
    # product through im2col and _int_mm against the float64 conv twin
    conv = quant.model.enc1.conv1
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    xh = torch.randint(-127, 128, (16, 512, 512, 64), generator=gen, device="cuda",
                       dtype=torch.int8)
    with torch.inference_mode():
        got = Q.int8_conv2d(xh, conv.wq, conv.n_out, conv.kernel, conv.stride, conv.padding,
                            conv.dilation)
        wq = conv.wq[:conv.n_out, :conv.k].reshape(conv.n_out, 3, 3, 64).permute(0, 3, 1, 2)
        want = Q.int8_conv2d_plain(xh.permute(0, 3, 1, 2), wq, 1, 1, 1).permute(0, 2, 3, 1)
        equal = torch.equal(got, want)
        del want
        ms_int = cuda_ms(lambda: Q.int8_conv2d(xh, conv.wq, conv.n_out, conv.kernel,
                                               conv.stride, conv.padding, conv.dilation))
        # where its time goes: the patches alone, and one GEMM on a chunk
        cols = Q.im2col_nhwc(xh[:4], conv.kernel, conv.stride, conv.padding, conv.dilation,
                             conv.wq.shape[1]).reshape(-1, conv.wq.shape[1])
        ms_cols = cuda_ms(lambda: Q.im2col_nhwc(xh[:4], conv.kernel, conv.stride,
                                                conv.padding, conv.dilation,
                                                conv.wq.shape[1])) * 4
        ms_mm = cuda_ms(lambda: torch._int_mm(cols, conv.wq.t())) * 4
        ms_act = cuda_ms(lambda: Q.quantize_activation(xh[:4].permute(0, 3, 1, 2).to(
            torch.bfloat16))) * 4
        xb = xh.permute(0, 3, 1, 2).to(torch.bfloat16)
        wb = wq.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        ms_bf16 = cuda_ms(lambda: torch.nn.functional.conv2d(xb, wb, None, 1, 1))
        del cols, xb, wb
    # int8 in read once, int32 out written once; the products at the int8 peak
    bound = max(16 * 512 * 512 * 64 * (1 + 4) / HBM_BYTES_PER_S,
                2 * 16 * 512 * 512 * 64 * 576 / PEAK_INT8_OPS) * 1e3
    print(f"[12c] enc1.conv1 int product (16,512,512,64) -> 64 through im2col and _int_mm "
          f"equals the float64 conv twin: {equal}; {ms_int:.3f} ms (im2col {ms_cols:.3f}, "
          f"_int_mm {ms_mm:.3f}, by 4-image chunks; quantizing its bf16 input "
          f"{ms_act:.3f}); cuDNN bf16 on the same shape {ms_bf16:.3f} ms; int8 bound "
          f"{bound:.3f} ms (int8 in, int32 out: bytes)", flush=True)
    check(equal, "int8 conv != its float64 twin")
    del xh, got
    x = torch.from_numpy(u8).cuda()
    with torch.inference_mode():
        turns = [cuda_ms(lambda: p._probs(x), iters=5) for p in (dense, quant, quant, dense)]
    print(f"[12c] forward 512^2 b16: bf16 {(turns[0] + turns[3]) / 2:.2f} ms, int8 "
          f"{(turns[1] + turns[2]) / 2:.2f} ms per batch (turns bf16, int8, int8, bf16 "
          f"{[round(t, 2) for t in turns]})", flush=True)
    del dense, quant, cpu
    torch.cuda.empty_cache()
    return launches, {"bf16_ms": (turns[0] + turns[3]) / 2, "int8_ms": (turns[1] + turns[2]) / 2}


def _phase12_export(workdir: str, best: str):
    """12d: cli.export at 512^2 (buckets 1 and 8) on the card, cli.serve
    --artifact answering a ragged batch of 3, the artifact against the
    Predictor pinned to the low-rank high-pass, an int8 artifact at bucket 1,
    and the artifact's forward timed beside the Predictor's."""
    import dataclasses

    import torch

    from eelunet_tpu_torch.config import ModelConfig
    from eelunet_tpu_torch.export import ExportedModel, export_model
    from eelunet_tpu_torch.inference import Predictor

    art = os.path.join(workdir, "artifact")
    stdout, el, wall = _cli("12d", "export", [
        "--model_type", "eelunet", "--checkpoint", best, "--image_size", "512", "--set",
        "model.dtype=bfloat16", "--batch_sizes", "1,8", "--output", art])
    check(set(el.values()) == {0}, f"export launches {el}")
    u8 = np.random.default_rng(SEED + 14).integers(0, 256, (8, 512, 512, 3), dtype=np.uint8)
    u8[3:] = 0  # the rows the artifact pads a batch of 3 with
    with _server(None, workdir, "eelunet", "12d", extra=("--artifact", art)) as base:
        code, body, _ = _http(base + "/v1/predict", _npy(u8[:3]))
        got = np.load(io.BytesIO(body))
    cfg = ModelConfig(name="eelunet", dtype="bfloat16", highpass_impl="lowrank")
    lowrank = Predictor(cfg, checkpoint=best, device="cuda", bucket_batches=False,
                        proba_wire_dtype="float32")
    want = lowrank.predict_proba(u8)[:3]
    d = float(np.abs(got - want).max())
    print(f"[12d] cli.export {wall:.1f} s: {stdout.splitlines()[0]}; cli.serve --artifact, "
          f"a batch of 3 (bucket 8): HTTP {code}, max |d| to the low-rank Predictor {d:.3e} "
          f"(bound {ARTIFACT_TOL:g})", flush=True)
    check(code == 200 and got.shape == (3, 512, 512, 1) and d <= ARTIFACT_TOL,
          f"artifact vs Predictor: {d}")
    model = ExportedModel(art)
    x = torch.from_numpy(u8).cuda()
    kernels = Predictor(dataclasses.replace(cfg, highpass_impl="auto"), checkpoint=best,
                        device="cuda", bucket_batches=False)
    with torch.inference_mode():
        fns = (lambda: model._fns[8](x), lambda: lowrank._probs(x), lambda: kernels._probs(x))
        turns = [cuda_ms(f, iters=5) for f in fns + fns[::-1]]
    ms = {n: (turns[i] + turns[5 - i]) / 2 for i, n in enumerate(("artifact", "lowrank",
                                                                   "kernels"))}
    print(f"[12d] forward 512^2 b8 bf16: artifact {ms['artifact']:.2f} ms, Predictor on the "
          f"low-rank high-pass {ms['lowrank']:.2f} ms, Predictor on the kernels "
          f"{ms['kernels']:.2f} ms (turns {[round(t, 2) for t in turns]})", flush=True)
    del model, kernels
    t0 = time.monotonic()
    qart = export_model(cfg, best, (512, 512), (1,), os.path.join(workdir, "artifact_int8"),
                        quantize="int8", device="cuda")
    qwall = time.monotonic() - t0
    quant = Predictor(cfg, checkpoint=best, device="cuda", bucket_batches=False,
                      quantize="int8", proba_wire_dtype="float32")
    qd = float(np.abs(ExportedModel(qart).predict_proba(u8[:1])
                      - quant.predict_proba(u8[:1])).max())
    print(f"[12d] int8 artifact (bucket 1, exported in {qwall:.1f} s; _int_mm traced): max "
          f"|d| to the int8 Predictor on the low-rank high-pass {qd:.3e} (bound "
          f"{ARTIFACT_TOL:g})", flush=True)
    check(qd <= ARTIFACT_TOL, f"int8 artifact vs Predictor: {qd}")
    del lowrank, quant
    torch.cuda.empty_cache()
    return ms


def phase_compression(workdir: str, tree: str, best: str):
    """Phase 12: the compression and deployment path on the full-width
    EELUnet at 512^2 (module docstring). Returns the launches of its entry
    points: cli.prune, cli.evaluate and cli.serve on the slim checkpoint,
    and the int8 Predictor's forward."""
    import torch

    from eelunet_tpu_torch.config import ModelConfig
    from eelunet_tpu_torch.data.augment import normalize_imagenet
    from eelunet_tpu_torch.inference import random_state_dict
    from eelunet_tpu_torch.nn.layers import nchw

    t0 = time.monotonic()
    sd = random_state_dict(ModelConfig(name="eelunet", fft_mask_range=MASK_RANGE), seed=SEED)
    rng = np.random.default_rng(SEED + 11)
    for k, v in sd.items():  # random BN statistics and affines: a leak would show
        if ".bn" in f".{k}" or k.startswith("bottleneck_bn"):
            if k.endswith((".weight", ".running_var")):
                sd[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
            elif k.endswith((".bias", ".running_mean")):
                sd[k] = torch.from_numpy((rng.standard_normal(v.shape) * 0.1).astype(np.float32))
    u8 = rng.integers(0, 256, (16, 512, 512, 3), dtype=np.uint8)
    x16 = nchw(normalize_imagenet(torch.from_numpy(u8).cuda().float() / 255.0))
    x16 = x16.contiguous(memory_format=torch.channels_last)
    slim_ms = _phase12_slim(sd, x16)
    del sd, x16
    torch.cuda.empty_cache()
    t1 = time.monotonic()
    launches = _phase12_cli(workdir, tree, best)
    t2 = time.monotonic()
    q_launches, q_ms = _phase12_int8(best, u8)
    t3 = time.monotonic()
    a_ms = _phase12_export(workdir, best)
    for k in q_launches:
        launches[k] += q_launches[k]
    print(f"[12] compression and deployment phase: {time.monotonic() - t0:.1f} s (12a "
          f"{t1 - t0:.1f}, 12b {t2 - t1:.1f}, 12c {t3 - t2:.1f}, 12d {time.monotonic() - t3:.1f}); "
          f"launches {launches}; times {slim_ms | q_ms | a_ms}", flush=True)
    return launches


# ------------------------------------------------------- phase 13: data parallel

# Phase 13a: one DDP step of two ranks on the one card (gloo) against the
# single-process step at b8 from the same state. The BN running statistics
# after it, relative L2 over every layer's means and over its variances.
DDP_STATS_TOL = 2e-3


def _ddp_cfg(workdir: str, canny: bool = False):
    from eelunet_tpu_torch.config import TrainConfig, apply_overrides

    return apply_overrides(TrainConfig(), [
        "model.name=eelunet", "model.dtype=bfloat16", f"model.fft_mask_range={MASK_RANGE}",
        "data.image_size=512", "data.batch_size=8", f"seed={SEED}",
        f"save_dir={workdir}/ckpt_ddp", *(CANNY_FLAGS if canny else ())])


def _grad_norm(model) -> float:
    import torch

    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad.double()) for p in model.parameters()])).item()


def _bn_stats(model):
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def ddp_rank(rank: int, workdir: str) -> None:
    """One of phase 13a's two ranks (a subprocess on card 0, gloo): from the
    saved state, one data-parallel step on its 4 rows of phase 6's first
    batch, two more steps, then one step of the Canny model with both flags
    behind the input chain. Writes its readings to ``ddp_rank<r>.json``."""
    import torch

    from eelunet_tpu_torch.data.augment import make_input_preprocess
    from eelunet_tpu_torch.data.pipeline import process_rows
    from eelunet_tpu_torch.ops import edge_cuda, fft_cuda
    from eelunet_tpu_torch.parallel.distributed import (
        all_reduce_sum_,
        init_distributed,
        shutdown_distributed,
    )
    from eelunet_tpu_torch.train.trainer import Trainer

    check(init_distributed(f"file://{workdir}/ddp_rendezvous", 2, rank, backend="gloo",
                           device="cuda:0"), "init_distributed returned False")
    dev = torch.device("cuda", 0)
    rows = process_rows(rank, 2, 8)
    raw = [(torch.from_numpy(x[rows]).to(dev), torch.from_numpy(y[rows]).to(dev))
           for x, y in _train_batches(2, 8, SEED + 4)]
    cfg = _ddp_cfg(workdir)
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=6)
    state.model.load_state_dict(torch.load(os.path.join(workdir, "ddp_init.pt"),
                                           map_location=dev, weights_only=True))
    preprocess = make_input_preprocess(cfg.data)
    batches = [preprocess(x, y) for x, y in raw]
    step = trainer._get_step("train")
    fft_cuda.reset_launches()
    edge_cuda.reset_launches()
    losses, ms = [], []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, ok = step(state, *batches[i % 2])
        glob = float(all_reduce_sum_(loss.detach().clone())) / 2
        ms.append((time.perf_counter() - t0) * 1e3)
        check(ok, f"rank {rank}: step {i} skipped")
        if i == 0:
            gnorm, stats = _grad_norm(state.model), _bn_stats(state.model)
        losses.append(glob)
    out = {"losses": losses, "gnorm": gnorm, "ms": ms}
    ref = torch.load(os.path.join(workdir, "ddp_single.pt"), weights_only=True)["stats"]
    for kind in ("running_mean", "running_var"):
        keys = [k for k in ref if k.endswith(kind)]
        got, want = (torch.cat([t[k].flatten() for k in keys]) for t in (stats, ref))
        out[kind] = rel_l2(got, want)
    worst = max(ref, key=lambda k: ((stats[k] - ref[k]).abs().max() / ref[k].abs().max()).item())
    out["worst"] = [worst, (stats[worst] - ref[worst]).abs().max().item(),
                    ref[worst].abs().max().item()]
    del state, trainer, batches, step
    gc.collect()  # the DDP wrapper's hooks hold the model in cycles
    torch.cuda.empty_cache()

    cfg_c = _ddp_cfg(workdir, canny=True)
    trainer = Trainer(cfg_c, device="cuda")
    state = trainer.init_state(steps_per_epoch=1)
    loss, ok = trainer._get_step("train")(state, *make_input_preprocess(cfg_c.data)(*raw[0]))
    out["canny_loss"] = float(all_reduce_sum_(loss.detach().clone())) / 2
    torch.cuda.synchronize()
    out["launches"] = {**fft_cuda.LAUNCHES, **edge_cuda.LAUNCHES}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(workdir, f"ddp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    shutdown_distributed()


def _phase13_ddp_step(workdir: str):
    """13a: the single-process step at b8 from a fresh state (saved), then
    the two ranks in subprocesses on the one card."""
    import torch

    from eelunet_tpu_torch.data.augment import make_input_preprocess
    from eelunet_tpu_torch.train.trainer import Trainer, make_train_step

    dev = torch.device("cuda")
    cfg = _ddp_cfg(workdir)
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=6)
    torch.save(state.model.state_dict(), os.path.join(workdir, "ddp_init.pt"))
    x, y = _train_batches(1, 8, SEED + 4)[0]
    images, labels = make_input_preprocess(cfg.data)(torch.from_numpy(x).to(dev),
                                                      torch.from_numpy(y).to(dev))
    loss, _ = make_train_step(trainer.loss_fn, trainer.amp_dtype)(state, images, labels)
    single = {"loss": loss.item(), "gnorm": _grad_norm(state.model)}
    torch.save({"stats": _bn_stats(state.model)}, os.path.join(workdir, "ddp_single.pt"))
    del state, trainer, images, labels, loss
    torch.cuda.empty_cache()

    root = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path.insert(0, {root!r}); import chip_smoke; "
            "chip_smoke.ddp_rank(int(sys.argv[1]), sys.argv[2])")
    logs = [open(os.path.join(workdir, f"ddp_rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), workdir], stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=root) for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, rc in enumerate(rcs):
        check(rc == 0, f"13a rank {r} exited with {rc}:\n"
              + open(os.path.join(workdir, f"ddp_rank{r}.log")).read()[-4000:])
    ranks = [json.load(open(os.path.join(workdir, f"ddp_rank{r}.json"))) for r in range(2)]
    tol = GRAD_TOL["bfloat16"]
    d_loss = abs(ranks[0]["losses"][0] - single["loss"]) / abs(single["loss"])
    d_g = abs(ranks[0]["gnorm"] - single["gnorm"]) / single["gnorm"]
    print(f"[13a] 2 ranks (gloo) on card 0, 512^2 global b8 (4 per rank) bf16: first step "
          f"loss {ranks[0]['losses'][0]:.6f} vs single-process b8 {single['loss']:.6f} (rel "
          f"{d_loss:.2e}), grad norm {ranks[0]['gnorm']:.6f} vs {single['gnorm']:.6f} (rel "
          f"{d_g:.2e}; bound {tol:g}, GRAD_TOL); BN running statistics, relative L2 over all "
          f"layers: means {[round(r['running_mean'], 8) for r in ranks]}, variances "
          f"{[round(r['running_var'], 8) for r in ranks]} (bound {DDP_STATS_TOL:g}; the buffer "
          f"farthest in max|d|/max|ref|: {ranks[0]['worst']}); losses "
          f"{[round(v, 4) for v in ranks[0]['losses']]}; Canny step (both flags) loss "
          f"{ranks[0]['canny_loss']:.4f}; step ms per rank {[[round(t, 1) for t in r['ms']] for r in ranks]} "
          f"(two processes sharing one card over gloo: no scaling figure); peak GiB per rank "
          f"{[round(r['peak_gib'], 2) for r in ranks]}", flush=True)
    check(d_loss <= tol and d_g <= tol, "13a: DDP step vs single-process step too far")
    check(all(max(r["running_mean"], r["running_var"]) <= DDP_STATS_TOL for r in ranks),
          "13a: BN running statistics")
    check(all(np.isfinite(r["losses"] + [r["canny_loss"]]).all() for r in ranks),
          "13a: non-finite loss")
    check(abs(ranks[0]["gnorm"] - ranks[1]["gnorm"]) <= 1e-6 * ranks[0]["gnorm"],
          "13a: the ranks' reduced gradients differ")
    want = {**{k: 2 * 4 for k in HIGHPASS}, "fused_canny": 2, "hysteresis": 2}
    for r, out in enumerate(ranks):
        print(f"[13a] rank {r} launches {out['launches']} (3 steps + the Canny step: kernels 1-4 "
              f"twice per step, kernel 5 and the hysteresis twice per batch)")
        check(out["launches"] == want, f"13a rank {r} launches {out['launches']}, want {want}")
    return {k: sum(r["launches"].get(k, 0) for r in ranks) for k in (*KERNELS, "hysteresis")}


def _phase13_torchrun(workdir: str, tree: str, n: int):
    """13b: cli.train and cli.evaluate under torchrun, one rank per card
    (NCCL)."""
    save, logs = os.path.join(workdir, "ckpt_torchrun"), os.path.join(workdir, "runs_torchrun")
    out, trained, wall = _cli("13b", "train", _train_args(tree, save, logs), nproc=n)
    check(f"over {n} device(s)" in out, "13b: no mesh line over the ranks")
    want = {k: 2 * (CLI_FORWARDS if k in FWD else CLI_STEPS) for k in HIGHPASS}
    want.update(fused_canny=0, hysteresis=0, conv3x3=0)
    check(trained == want, f"13b cli.train launches (rank 0) {trained}, want {want}")
    hist, best = _history(os.path.join(save, "eelunet"))
    out_e, evaluated, wall_e = _cli("13b", "evaluate", [
        "--model_type", "eelunet", "--data_dir", tree, "--image_size", "512",
        "--batch_size", "8", "--set", "model.dtype=bfloat16", "--seed", str(SEED),
        "--checkpoint", best], nproc=n)
    metrics = json.loads(next(ln for ln in out_e.splitlines()
                              if ln.startswith("metrics: ")).split(": ", 1)[1])
    recorded = hist["metrics"][int(np.argmin(hist["val_loss"]))]
    diff = max(abs(metrics[k] - recorded[k]) for k in recorded)
    print(f"[13b] torchrun --nproc_per_node={n} (NCCL): cli.train {wall:.1f} s wall for 2 "
          f"epochs, launches (rank 0) {trained}; cli.evaluate on its best tag {wall_e:.1f} s, "
          f"launches {evaluated}; metrics vs the training run's max|d| {diff:.3e}"
          + ("; one card: one rank, so NCCL across cards is not exercised here" if n == 1
             else ""), flush=True)
    check(diff <= (0.0 if n == 1 else 1e-5),
          f"13b cli.evaluate {metrics} != the training run's {recorded}")
    return {k: trained[k] + evaluated[k] for k in (*KERNELS, "hysteresis")}


def _phase13_mesh_predictor(best: str, n: int):
    """13c: the multi-device Predictor over every card, and over a mesh that
    lists card 0 twice, against the single-device Predictor."""
    import torch

    from eelunet_tpu_torch.config import ModelConfig
    from eelunet_tpu_torch.inference import Predictor
    from eelunet_tpu_torch.ops import fft_cuda
    from eelunet_tpu_torch.parallel.mesh import create_mesh

    cfg = ModelConfig(name="eelunet", dtype="bfloat16")
    single = Predictor(cfg, checkpoint=best, device="cuda")
    u8 = np.random.default_rng(SEED + 13).integers(0, 256, (16, 512, 512, 3), dtype=np.uint8)
    want = {b: single.predict_proba(u8[:b]) for b in (16, 13)}
    for name, mesh in (("every card", create_mesh(-1, 1)),
                       ("card 0 twice", create_mesh(-1, 1, devices=["cuda:0", "cuda:0"]))):
        pred = Predictor(cfg, checkpoint=best, mesh=mesh, device="cuda")
        shards = pred.data_size
        for b in (16, 13):
            fft_cuda.reset_launches()
            got = pred.predict_proba(u8[:b])
            launches = dict(fft_cuda.LAUNCHES)
            d = np.abs(got - want[b])
            flips = float(((got > 0.5) != (want[b] > 0.5)).mean())
            print(f"[13c] mesh over {name} ({shards} shard(s)), b{b}: vs the single-device "
                  f"Predictor mean|d prob| {d.mean():.3e}, max {d.max():.3e}, masks differing "
                  f"{flips:.3e} (bounds {FAMILY_TOL}); launches {launches}", flush=True)
            check(got.shape == (b, 512, 512, 1) and bool(np.isfinite(got).all()),
                  f"13c: bad output {got.shape}")
            check(d.mean() <= FAMILY_TOL["mean"] and flips <= FAMILY_TOL["mask"],
                  f"13c {name} b{b}: too far from the single-device Predictor")
            check(launches == {k: 2 * shards if k in FWD else 0 for k in HIGHPASS},
                  f"13c {name} b{b}: launches {launches}, want 2 per shard")
        del pred
        torch.cuda.empty_cache()
    if n == 1:
        print("[13c] one card: launches across two physical cards are not verified on this "
              "machine (the mesh that lists card 0 twice runs both shards on it)", flush=True)


def phase_multidevice(workdir: str, tree: str, best: str):
    """Phase 13: data parallelism (module docstring). Returns the launches
    of its main paths: the two ranks of 13a, the torchrun runs of 13b and
    cli.serve with every card in 13c."""
    import torch

    n = torch.cuda.device_count()
    print(f"[13] torch.cuda.device_count() = {n}", flush=True)
    t0 = time.monotonic()
    torch.cuda.empty_cache()
    launches = _phase13_ddp_step(workdir)
    t1 = time.monotonic()
    for k, v in _phase13_torchrun(workdir, tree, n).items():
        launches[k] += v
    t2 = time.monotonic()
    _phase13_mesh_predictor(best, n)
    served = phase_serve(best, workdir, n_singles=6, phase="13c",
                         extra=("--set", "mesh.data_axis=-1"))
    for k, v in served.items():
        launches[k] = launches.get(k, 0) + v
    print(f"[13] data-parallel phase: {time.monotonic() - t0:.1f} s (13a {t1 - t0:.1f}, 13b "
          f"{t2 - t1:.1f}, 13c {time.monotonic() - t2:.1f}); launches {launches}", flush=True)
    return launches


def main() -> int:
    import torch

    card = phase_card()
    from eelunet_tpu_torch.config import ModelConfig

    t0 = time.monotonic()
    phase_build()
    record = phase_kernels()
    record.update(phase_bwd_kernels())
    record.update(phase_canny_conv_kernels())
    cfg = ModelConfig(name="eelunet", dtype="bfloat16", fft_mask_range=MASK_RANGE)
    with tempfile.TemporaryDirectory(prefix="eelunet_smoke_") as workdir:
        ckpt = os.path.join(workdir, "eelunet_random.npz")
        sd = _random_upstream_checkpoint(cfg, ckpt)
        served = phase_serve(ckpt, workdir)
        phase_model(sd, cfg)
        del sd
        step = phase_train(workdir)
        trained, tree = phase_train_cli(workdir)
        canny, canny_best = phase_canny_path(workdir, tree, step["step_ms"])
        families = phase_families(workdir, tree)
        multiclass = phase_multiclass(workdir, tree, canny_best)
        best = os.path.join(workdir, "ckpt", "eelunet", "eelunet_best.npz")
        compression = phase_compression(workdir, tree, best)
        multidevice = phase_multidevice(workdir, tree, best)
    launches = {k: served.get(k, 0) + trained[k] + canny[k] + families[k] + multiclass[k]
                + compression.get(k, 0) + multidevice.get(k, 0)
                for k in (*KERNELS, "hysteresis")}
    print(f"[8] all phases passed in {time.monotonic() - t0:.1f} s")
    hyst = record.pop("hysteresis")
    print(f"[3c] hysteresis (csrc/canny.cu hysteresis_kernel; the JAX package's lax.while_loop, "
          f"eelunet_tpu/ops/edge.py:147, not a TPU kernel): launches {launches['hysteresis']} "
          f"on the main paths (one per launch of fused_canny in mode improve); "
          f"{hyst['ms']:.4f} ms at {CANNY_SITE}, plain loop {hyst['plain_ms']:.3f} ms, bound "
          f"{hyst['bound_ms']:.4f} ms; equal to hysteresis_fixpoint bit for bit: {hyst['equal']}")
    print(card)
    kernels = []
    for name in KERNELS:
        (abs_e, _), ms, plain_ms, lib_ms, bound_ms, bound_by = record[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": KERNELS[name],
            "launches": launches[name], "max_abs_err": abs_e, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
