"""Where a training step's device time goes, on the card:

    python -m picotron_tpu_torch.profile_step \
        --config picotron_tpu_torch/configs/smollm17-1gpu-seq2048.json \
        [--warmup 2] [--steps 2] [--trace chiprun_out/step_trace.json]
    python -m torch.distributed.run --standalone --nproc_per_node 1 \
        -m picotron_tpu_torch.profile_step \
        --config picotron_tpu_torch/configs/smollm17-1gpu-dp-zero1.json

Runs the trainer (`train.run`) for `warmup + steps` steps and traces the
last `steps` under torch.profiler (CPU + CUDA activity), then prints per
step: wall time, device-busy time (the sum of kernel durations: the
kernels run on one stream, so they do not overlap), the idle share 1 -
busy / wall, and device time by class (the three flash kernels, the
AdamW kernel, GEMMs, NCCL's kernels ("nccl", every kernel whose name
holds "nccl": under torchrun the layout's grad all-reduces and ZeRO-1
all-gathers, and under context parallelism the ring's SendRecv and
Ulysses' all-to-all, which run on NCCL's own streams and may overlap
the compute), everything else;
host-device copies, which the
offloaded optimizer runs on two streams of their own beside the kernels,
apart as "memcpy" and outside the busy time) and by kernel name, and by
part of the step: the kernels launched under the optimizer's and the
guard's grad-norm host ranges, and the rest, the grads (forward and
backward: autograd launches its backward kernels from its own thread,
outside any range of the step's thread, so the grads are the busy time
less the two ranges). The flash and AdamW kernels are launched through
ctypes, so the profiler ties them to no host range: the AdamW kernel's
time, which launches only inside the optimizer's step, is added to that
part by its class. Under optimizer_offload the optimizer's part counts
the kernels on the compute stream, and beside it are its H2D copies, its
kernel and its D2H copies (the ranges "offload.h2d", "offload.adamw",
"offload.d2h"; the copies run on their own streams, overlapping each
other and the kernel). The last line is one JSON object with the same
numbers.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from collections import defaultdict

import torch

from picotron_tpu_torch import train
from picotron_tpu_torch.config import load_config
from picotron_tpu_torch.mesh import launcher_contract, shutdown

# (name substring, class): each kernel's variants share its class
_FLASH = (("fwd_wgmma_kernel", "fwd_kernel"),
          ("fwd_mma_kernel", "fwd_kernel"), ("fwd_kernel", "fwd_kernel"),
          ("bwd_dq_wgmma_kernel", "bwd_dq_kernel"),
          ("bwd_dq_mma_kernel", "bwd_dq_kernel"),
          ("bwd_dq_kernel", "bwd_dq_kernel"),
          ("bwd_dkv_wgmma_kernel", "bwd_dkv_kernel"),
          ("bwd_dkv_mma_kernel", "bwd_dkv_kernel"),
          ("bwd_dkv_kernel", "bwd_dkv_kernel"))
# the wgmma kernels' rotation pre-pass, a class of its own
_ROPE = ("rope_rows_kernel", "rope_rows")
_GEMM = ("gemm", "xmma", "cutlass", "cublas", "nvjet")
RANGES = ("train_step.grad_norm", "Optimizer.step")
# the offloaded update's pieces, inside its Optimizer.step range
OFFLOAD_RANGES = ("offload.h2d", "offload.adamw", "offload.d2h")


def kernel_class(name: str) -> str:
    low = name.lower()
    for k, cls in _FLASH:
        if k in name:
            return "flash:" + cls
    if _ROPE[0] in name:
        return "flash:" + _ROPE[1]
    if "adamw_kernel" in name:
        return "adamw"
    if "nccl" in low:
        return "nccl"
    if low.startswith("memcpy"):
        return "memcpy"
    if any(g in low for g in _GEMM):
        return "gemm"
    return "other"


def device_kernels(events) -> list:
    """The device events of a torch.profiler trace that are kernels or
    copies, not ranges: a host range such as "Optimizer.step#AdamW.step"
    is mirrored on the GPU track under the same name and spans the
    kernels it launched, so device events whose name a host event
    carries are left out."""
    host_names = {evt.name for evt in events
                  if evt.device_type == torch.autograd.DeviceType.CPU}
    return [evt for evt in events
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and evt.name not in host_names]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--warmup", type=int, default=2,
                    help="untraced steps first (at least 1)")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled steps here")
    args = ap.parse_args(argv)
    if args.warmup < 1 or args.steps < 1:
        ap.error("--warmup and --steps must be at least 1")

    from torch.profiler import ProfilerActivity, profile

    cfg = load_config(args.config)
    cfg = dataclasses.replace(cfg, training=dataclasses.replace(
        cfg.training, total_train_steps=args.warmup + args.steps,
        max_tokens=None))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    clock = {}

    def on_step(step: int, metrics: dict) -> None:
        # the trainer has synced the device (the loss reached the host)
        if step == args.warmup:
            prof.start()
            clock["t0"] = time.perf_counter()
        elif step == args.warmup + args.steps:
            torch.cuda.synchronize()
            clock["wall"] = (time.perf_counter() - clock["t0"]) / args.steps
            prof.stop()

    launched = launcher_contract() is not None
    try:
        train.run(cfg, "cuda", on_step=on_step)
    finally:
        if launched:
            shutdown()
    wall = clock["wall"]
    if args.trace:
        prof.export_chrome_trace(args.trace)

    events = prof.events()
    by_name = defaultdict(float)
    for evt in device_kernels(events):
        by_name[evt.name] += evt.device_time_total / 1e3 / args.steps
    if not by_name:
        raise RuntimeError("torch.profiler recorded no device time on this "
                           "card; time with CUDA events instead")
    # the kernels launched under the optimizer's and the grad norm's host
    # ranges; the grads are the rest
    by_range, offload = defaultdict(float), defaultdict(float)
    for evt in events:
        if evt.device_type != torch.autograd.DeviceType.CPU:
            continue
        ms = evt.device_time_total / 1e3 / args.steps
        if evt.name.startswith(RANGES):
            by_range[evt.name] += ms
        elif evt.name in OFFLOAD_RANGES:
            offload[evt.name] += ms
    by_class = defaultdict(float)
    for name, ms in by_name.items():
        by_class[kernel_class(name)] += ms
    busy = sum(ms for name, ms in by_name.items()
               if kernel_class(name) != "memcpy")
    adamw = by_class.get("adamw", 0.0)
    copies = offload.get("offload.h2d", 0.0) + offload.get("offload.d2h", 0.0)
    for name in by_range:
        if name.startswith("Optimizer.step"):
            by_range[name] += adamw - copies
    if offload:
        offload["offload.adamw"] += adamw
    card = torch.cuda.get_device_name(0)
    print(f"card {card}: step wall {wall * 1e3:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:28s} {ms:9.2f} ms/step  {ms / busy:6.1%}")
    by_range["grads (the rest)"] = busy - sum(by_range.values())
    for name, ms in sorted(by_range.items()):
        print(f"  part {name:29s} {ms:9.2f} ms/step")
    for name in OFFLOAD_RANGES:
        if name in offload:
            print(f"    beside it: {name:20s} {offload[name]:9.2f} ms/step")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        print(f"    {ms:9.2f} ms/step  {name[:100]}")
    out = {"card": card, "step_wall_ms": wall * 1e3, "device_busy_ms": busy,
           "idle_share": 1 - busy / (wall * 1e3),
           "by_class_ms": dict(by_class), "by_range_ms": dict(by_range),
           "offload_ms": dict(offload)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
