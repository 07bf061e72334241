"""Where the time goes in the PyTorch port on a CUDA card: the serving
forward, or the train step.

``--mode forward`` (default) builds the full-width EELUnet (random weights
from a seed, BN folded) in the serving dtype and runs forwards at
(batch, 3, size, size). ``--mode train`` runs the port's train step
(``train/trainer.make_train_step``: bf16 autocast on f32 weights, live BN,
the edge_bce_dice loss, Adam) on seeded random images and random binary
masks. Either way: warm-up, ``--iters`` timed with CUDA events, then
``--iters`` traced with ``torch.profiler``. Prints the card's name and power
limit, the time per batch, the device busy share of the traced window, the
device time grouped by kind (convolutions, GEMMs, the high-pass kernels,
the optimizer, everything else) and the top ops by device time. To tell
lost trace records from a card that waits on the host, it also counts per
batch the kernel launches the host issued (the trace's launch API records)
against the kernel records on the device, the union of the kernels' busy
intervals against the span from the first to the last, and the host's
time to issue one batch without synchronising. In ``--mode forward`` it
captures one forward in a CUDA graph: the graph's kernel nodes are the
forward's launches, and a replay's time (CUDA events) is its device time
without the host's gaps between launches.

    python tools/profile_torch_forward.py [--mode forward|train] [--size 512]
        [--batch 16] [--dtype bfloat16] [--iters 5] [--highpass_impl auto]

Fails when no CUDA card is present: a CPU run measures nothing of the card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def kind(name: str) -> str:
    n = name.lower()
    if "bwd_contract_kernel" in n or "bwd_expand_kernel" in n:
        return "high-pass backward kernels (csrc/highpass_bwd.cu)"
    if "contract_kernel" in n or "expand_kernel" in n:
        return "high-pass forward kernels (csrc/highpass.cu)"
    if "adam" in n or "multi_tensor" in n or "foreach" in n:
        return "optimizer (Adam, foreach)"
    if any(t in n for t in ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")):
        return "convolutions (cuDNN)"
    if any(t in n for t in ("gemm", "sm90_", "sm80_", "cutlass", "ampere", "xmma")):
        return "matmuls (cuBLAS)"
    return "elementwise, norms, copies, reductions"


# The CUDA calls that launch a kernel (runtime and cu* API), as the profiler names them.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel")


def launches_vs_records(prof):
    """(launch calls by name, kernel records, busy us, span us) over a
    trace: busy is the union of the kernel records' intervals, span the time
    from the first kernel's start to the last one's end."""
    calls, spans = {}, []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if "#" in e.name or e.name.startswith(("Memcpy", "Memset", "ProfilerStep")):
                continue
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name in LAUNCH_CALLS:
            calls[e.name] = calls.get(e.name, 0) + 1
    spans.sort()
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    return calls, len(spans), busy, span


def graph_forward(run, iters: int):
    """(kernel nodes, other nodes, ms per replay) of one ``run()`` captured
    in a CUDA graph, or None where this PyTorch cannot hand out the graph."""
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:  # a PyTorch without keep_graph
        return None
    with torch.cuda.graph(graph):
        run()
    rt = None
    for name in ("libcudart.so.12", "libcudart.so"):
        try:
            rt = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if rt is None:
        return None
    ptr, size_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    rt.cudaGraphGetNodes.argtypes = [ptr, ctypes.POINTER(ptr), size_p]
    rt.cudaGraphGetNodes.restype = ctypes.c_int
    rt.cudaGraphNodeGetType.argtypes = [ptr, ctypes.POINTER(ctypes.c_int)]
    rt.cudaGraphNodeGetType.restype = ctypes.c_int
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    if rt.cudaGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
        return None
    nodes = (ptr * count.value)()
    rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(count))
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        rt.cudaGraphNodeGetType(node, ctypes.byref(kind))
        kernels += kind.value == 0  # cudaGraphNodeTypeKernel
    graph.instantiate()
    for _ in range(2):
        graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return kernels, count.value - kernels, start.elapsed_time(end) / iters


def forward_runner(args):
    """The serving forward: BN folded, weights in the serving dtype."""
    from eelunet_tpu_torch.config import ModelConfig
    from eelunet_tpu_torch.inference import build_serving_model, random_state_dict

    cfg = ModelConfig(name="eelunet", dtype=args.dtype, highpass_impl=args.highpass_impl)
    dev = torch.device("cuda")
    model = build_serving_model(random_state_dict(cfg, seed=args.seed), cfg, dev)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((args.batch, 3, args.size, args.size), generator=g, device=dev)
    x = x.to(model.final_conv.weight.dtype).contiguous(memory_format=torch.channels_last)
    return (lambda: model(x)), torch.inference_mode


def train_runner(args):
    """The train step on f32 weights, autocast to ``--dtype``."""
    import contextlib

    from eelunet_tpu_torch.config import TrainConfig, apply_overrides
    from eelunet_tpu_torch.train.trainer import Trainer, make_train_step

    cfg = apply_overrides(TrainConfig(), [
        "model.name=eelunet", f"model.dtype={args.dtype}",
        f"model.highpass_impl={args.highpass_impl}", f"data.image_size={args.size}",
        f"data.batch_size={args.batch}", f"seed={args.seed}"])
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=1000)
    step = make_train_step(trainer.loss_fn, trainer.amp_dtype)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((args.batch, args.size, args.size, 3), generator=g, device=dev)
    y = (torch.rand((args.batch, args.size, args.size, 1), generator=g, device=dev) > 0.7).float()
    return (lambda: step(state, x, y)), contextlib.nullcontext


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", default="forward", choices=["forward", "train"])
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--batch", type=int, default=None,
                   help="default 16 for forward, 8 for train")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--highpass_impl", default="auto", choices=["auto", "lowrank"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card: nothing to measure", file=sys.stderr)
        return 1
    if args.batch is None:
        args.batch = 16 if args.mode == "forward" else 8

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    run, grad_mode = (train_runner if args.mode == "train" else forward_runner)(args)
    peak = 0.0
    with grad_mode():
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / args.iters
        peak = torch.cuda.max_memory_allocated() / 2**30
        # The host's time to issue a batch, not waiting for the card.
        t0 = time.perf_counter()
        for _ in range(args.iters):
            run()
        host_ms = (time.perf_counter() - t0) * 1e3 / args.iters
        torch.cuda.synchronize()
        graphed = None
        if args.mode == "forward":
            try:
                graphed = graph_forward(run, args.iters)
            except RuntimeError as e:  # reported; the other numbers stand
                print(f"the forward could not be captured in a CUDA graph: {e}")

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.iters):
                run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6

    # Device-side ranges of annotations (e.g. "Optimizer.step#Adam.step")
    # span kernels already counted: leave them out of the sums.
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
              and "#" not in e.key and not e.key.startswith("ProfilerStep")]
    dev_us = {e.key: e.self_device_time_total for e in events}
    total = sum(dev_us.values())
    print(smi)
    print(f"{args.mode} ({args.batch},3,{args.size},{args.size}) {args.dtype} highpass="
          f"{args.highpass_impl}: {ms:.2f} ms/batch ({args.batch * 1e3 / ms:.1f} img/s, "
          f"CUDA events); peak memory {peak:.2f} GiB")
    print(f"host issue time {host_ms:.2f} ms/{args.mode} without synchronising "
          f"(the card waits on the host where it is near {ms:.2f})")
    if total == 0:
        print("the profiler recorded no device time; only the CUDA-event time above holds")
        return 0
    if graphed is not None:
        print(f"one forward captured in a CUDA graph: {graphed[0]} kernel nodes ({graphed[1]} "
              f"other nodes); a replay takes {graphed[2]:.2f} ms (CUDA events), against "
              f"{ms:.2f} ms launched from the host")
    calls, records, busy_us, span_us = launches_vs_records(prof)
    per_call = {k: v / args.iters for k, v in calls.items()}
    print(f"per {args.mode}: kernel launch calls {per_call}, "
          f"{records / args.iters:.1f} kernel records on the device; kernels busy "
          f"{busy_us / args.iters / 1e3:.2f} ms of {span_us / args.iters / 1e3:.2f} ms from the "
          f"first kernel to the last ({100 * (1 - busy_us / span_us):.1f}% idle)")
    print(f"traced {args.iters} {args.mode} steps: device busy {total / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms wall ({100 * total / wall_us:.1f}% busy)")
    groups = defaultdict(float)
    for k, us in dev_us.items():
        groups[kind(k)] += us
    for k, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {100 * us / total:5.1f}%  {us / args.iters / 1e3:8.3f} ms/{args.mode}  {k}")
    print(f"top ops by device time (per {args.mode}):")
    for k, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:20]:
        print(f"  {us / args.iters / 1e3:8.3f} ms  {100 * us / total:5.1f}%  {k[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
