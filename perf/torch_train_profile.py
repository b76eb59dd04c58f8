#!/usr/bin/env python3
"""Where a train step of the PyTorch port spends its time.

    python3 perf/torch_train_profile.py [--remat-policy NAME] [--steps N]

Builds Llama-3-8B width at 8 layers (fp32 masters from --seed,
bf16 compute, remat ``--remat-policy``, flash attention) behind
`accelerate_tpu_torch.accelerator.Accelerator` (AdamW 3e-4, max_grad_norm
1.0) on one random (2, 2048) batch, runs one warm-up step, then traces
``--steps`` steps with `torch.profiler` and prints one JSON line: wall ms
per step (host clock, each step ends in a synchronize), device-busy ms per
step (union of the GPU activity intervals), the device's idle share, CUDA
launches per step, device ms per step of the flash-attention kernels, the
matmuls, the optimizer and the rest, and the kernels with the most device
time. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _union_us(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def _family(name: str) -> str:
    if "_bf16_kernel" in name or "_f32_kernel" in name:
        return "flash_attention"
    if "gemm" in name or "nvjet" in name or "cutlass" in name or "sm90_xmma" in name:
        return "matmul"
    if "multi_tensor_apply" in name:
        return "optimizer_foreach"
    return "other"


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--remat-policy", default="attn_and_outputs",
                   choices=("nothing", "dots", "block_outputs", "attn_and_outputs"))
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = llama.LlamaConfig.llama3_8b(
        n_layers=8, remat=True, remat_policy=args.remat_policy, attention_impl="flash"
    )
    acc = Accelerator(mixed_precision="bf16", seed=args.seed, max_grad_norm=1.0, device="cuda")
    state = acc.create_train_state(lambda s: llama.init(cfg, seed=s, device="cuda"), optim.adamw(3e-4))
    step = acc.make_train_step(lambda p_, b, g: llama.loss_fn(p_, b, cfg, g))
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 3)
    batch = {"input_ids": torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen, device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, batch)  # warm-up: optimizer state, cuBLAS handles, kernel build
    torch.cuda.synchronize()

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Kernels and copies only: the profiler also puts user annotations
    # (such as the optimizer's "Optimizer.step#AdamW.step" range) on the
    # device timeline, and counting those would count their kernels twice.
    gpu = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation
    ]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in gpu]) / 1e3
    by_name: dict[str, float] = {}
    for e in gpu:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    by_family: dict[str, float] = {}
    for name, ms in by_name.items():
        by_family[_family(name)] = by_family.get(_family(name), 0.0) + ms / args.steps
    launches = sum(
        1 for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU
        and e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
    )
    wall_ms = sum(walls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(card)
    print(json.dumps({
        "script": "perf/torch_train_profile.py", "card": card, "model": "llama3-8b",
        "n_layers": cfg.n_layers, "batch": 2, "seq": 2048, "remat_policy": cfg.remat_policy,
        "steps": args.steps, "loss": metrics["loss"].item(), "wall_ms_per_step": wall_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "cuda_launches_per_step": launches / args.steps,
        "device_ms_per_step_by_family": by_family,
        "peak_memory_gb": peak_gb,
        "top_kernels_ms_per_step": {name[:80]: ms / args.steps for name, ms in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
