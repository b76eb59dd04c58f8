#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's serving path spends its time.

    python3 perf/torch_serve_profile.py [--kv-cache-dtype bf16|int8] [--steps N]

Builds Llama-3-8B (random bf16 weights from --seed) behind
`accelerate_tpu_torch.serving.Engine` (8 slots, max_len 512), fills every
slot with a 128-token prompt, then traces ``--steps`` decode steps with
`torch.profiler` and prints one JSON line: wall ms per step (host clock,
each step ends in its token fetch), device-busy ms per step (union of the
GPU activity intervals), the device's idle share, CUDA launches per step,
and the kernels with the most device time. Needs one CUDA device.
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


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kv-cache-dtype", default="bf16", choices=("bf16", "int8"))
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.generation import GenerationConfig, cache_dtype
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.serving import Engine

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init(cfg, seed=args.seed, dtype=torch.bfloat16, device="cuda")
    gcfg = GenerationConfig(kv_cache_dtype=args.kv_cache_dtype)
    engine = Engine(
        lambda p_, t, c: llama.forward_with_cache(p_, t, c, cfg),
        lambda b, m: llama.init_cache(cfg, b, m, cache_dtype(gcfg), device="cuda"),
        params, gcfg, slots=8, buckets=(32, 64, 128, 256), max_len=512, prefix_cache=False,
    )
    rng = np.random.RandomState(args.seed)
    for _ in range(8):
        engine.submit(rng.randint(0, cfg.vocab_size, (128,)), 2 * args.steps + 8)
    while engine.stats["prefill_chunks"] < 8:  # every slot prefilled
        engine.step()
    for _ in range(4):  # warm decode steps
        engine.step()
    torch.cuda.synchronize()

    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            engine.step()
            walls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()

    gpu = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in gpu]) / 1e3
    by_name: dict[str, float] = {}
    for e in gpu:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    launches = sum(
        1 for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CPU
        and e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")
    )
    wall_ms = sum(walls)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    decode_ms = sum(ms for name, ms in by_name.items() if "decode_partial" in name or "decode_combine" in name)
    print(card)
    print(json.dumps({
        "script": "perf/torch_serve_profile.py", "card": card, "model": "llama3-8b",
        "kv_cache_dtype": args.kv_cache_dtype, "slots": 8, "steps": args.steps,
        "wall_ms_per_step": wall_ms / args.steps,
        "device_busy_ms_per_step": busy_ms / args.steps,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "cuda_launches_per_step": launches / args.steps,
        "flash_decode_ms_per_step": decode_ms / args.steps,
        "top_kernels_ms_per_step": {name[:80]: ms / args.steps for name, ms in top},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
