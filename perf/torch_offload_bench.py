#!/usr/bin/env python3
"""What offloading the optimizer moments costs and saves on one GPU.

    python3 perf/torch_offload_bench.py [--layers N] [--seed N]

Prints one JSON line each for:

1. copy: the host link's rate for pinned memory, a 4 GiB buffer each way,
   host-to-device alone, device-to-host alone, and both at once on two
   streams (device time by CUDA events): the bound of the offloaded update;
2. offloaded: the Llama-3-8B-width train step at ``--layers`` layers (bf16,
   remat "attn_and_outputs", flash attention, max_grad_norm 1.0, one (2,
   2048) batch from ``--seed``) with ``FsdpPlugin(offload_optimizer=True)``
   and `host_offloaded_adamw(3e-4)`: peak device memory, step ms (host
   clock, each step ends in a synchronize; mean of two after one warm-up),
   the update's ms and its copy rate;
3. device_resident: the same step with the moments on the card: whether it
   fits, and if it does its peak memory, step ms and update ms.

Then the card's name and power limit. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def copy_rates(torch) -> dict:
    """GB/s of pinned host <-> device copies of 4 GiB, alone and together."""
    n = 1 << 30  # fp32 elements
    host_a = torch.empty(n, pin_memory=True)
    host_b = torch.empty(n, pin_memory=True)
    dev_a = torch.empty(n, device="cuda")
    dev_b = torch.empty(n, device="cuda")
    h2d, d2h = torch.cuda.Stream(), torch.cuda.Stream()

    def timed(copies) -> float:
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for stream, dst, src in copies:
            stream.wait_event(start)
            with torch.cuda.stream(stream):
                dst.copy_(src, non_blocking=True)
        for stream, _, _ in copies:
            torch.cuda.current_stream().wait_stream(stream)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    nbytes = 4 * n
    up, down = (h2d, dev_a, host_a), (d2h, host_b, dev_b)
    timed([up])  # warm-up
    out = {"bytes_each_way": nbytes}
    for name, copies in (("h2d_alone", [up]), ("d2h_alone", [down]), ("both", [up, down])):
        ms = min(timed(copies) for _ in range(3))
        out[f"{name}_ms"] = ms
        out[f"{name}_gb_per_s_each_way"] = nbytes / ms / 1e6
    del host_a, host_b, dev_a, dev_b
    torch.cuda.empty_cache()
    return out


def train(torch, chip_smoke, llama, layers: int, seed: int, offload: bool) -> dict:
    from accelerate_tpu_torch import FsdpPlugin, host_offloaded_adamw

    cfg = llama.LlamaConfig.llama3_8b(
        n_layers=layers, remat=True, remat_policy="attn_and_outputs", attention_impl="flash"
    )
    torch.cuda.reset_peak_memory_stats()
    acc, state, batch = chip_smoke.train_setup(
        torch, llama, cfg, seed, tx=host_offloaded_adamw(3e-4), strategy=FsdpPlugin(offload_optimizer=offload))
    step = acc.make_train_step(lambda p, b, g: llama.loss_fn(p, b, cfg, g))
    losses, step_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    opt = state.opt_state
    update_ms = chip_smoke.event_ms(torch, opt.step, 2)
    moment_bytes = sum(t.numel() * t.element_size() for st in opt.state.values() for t in (st["mu"], st["nu"]))
    row = {"phase": "offloaded" if offload else "device_resident", "n_layers": layers,
           "params": cfg.param_count(), "fits": True, "peak_memory_gb": peak_gb, "losses": losses,
           "step_ms": step_ms, "step_ms_mean": sum(step_ms[1:]) / 2, "update_ms": update_ms,
           "moment_bytes": moment_bytes}
    if offload:
        row["update_gb_per_s_each_way"] = moment_bytes / update_ms / 1e6
    return row


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    import chip_smoke
    from accelerate_tpu_torch.models import llama

    if not torch.cuda.is_available():
        print("torch_offload_bench: no CUDA device", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    print(json.dumps({"phase": "copy", "card": card, **copy_rates(torch)}), flush=True)
    for offload in (True, False):
        try:
            row = train(torch, chip_smoke, llama, args.layers, args.seed, offload)
        except torch.OutOfMemoryError as e:  # the measurement: does it fit the card?
            row = {"phase": "device_resident" if not offload else "offloaded", "n_layers": args.layers,
                   "fits": False, "error": str(e).splitlines()[0]}
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({**row, "card": card}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
