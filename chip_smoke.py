#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`accelerate_tpu_torch`) on one GPU.

    python3 chip_smoke.py [--seed N] [--requests N]

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. build: compiles every CUDA source of the port with nvcc (sm_90a);
2. kernel: each kernel against its plain PyTorch version on the card, at
   the serving path's shapes (Llama-3-8B decode: 8 rows, 8 KV heads, GQA
   group 4, head_dim 128) for a 512- and a 4096-position cache, in bf16,
   fp32 and int8 + scales, with ragged cursors including 1 and T; prints
   the largest error, the kernel's, the plain version's and one PyTorch
   library call's device time (CUDA-graph replays over cache copies that
   exceed the 50 MB L2, so every call reads its cache cold), and the bound;
3. serve: Llama-3-8B at full width and depth with random bf16 weights from
   --seed behind `serving.Engine` (8 slots, buckets 32..256, max_len 512,
   greedy), replaying a Poisson trace in real time; every request must
   complete, flash-decode must have launched exactly 32 times per decode
   step, and one decode step's logits with the kernel must agree with the
   plain attention's; then the same with an int8 KV cache;
4. a {"kernels": [...]} line;
5. last line: {"ok": true, "device": {...}}.

Exits non-zero without a CUDA device, and without the package beside it.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from unittest import mock

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
DECODE_SHAPE = dict(B=8, K=8, group=4, h=128)
SERVE_BUCKETS = (32, 64, 128, 256)
SERVE_MAX_LEN = 512
# Kernel vs plain version on identical inputs: fp32 differs only in
# summation order; bf16 (and int8, whose output is bf16) by one rounding of
# the output (2^-8 relative) plus the order. The JAX bf16 test's 2e-2.
TOLERANCE = {"bf16": 2e-2, "fp32": 2e-5, "int8": 2e-2}
# One decode step of the 8B model, kernel vs plain attention: the bf16
# rounding differences of 32 layers, bounded as a fraction of the largest
# logit (a wrong head mapping or mask moves logits by their own size).
LOGIT_TOLERANCE = 5e-2


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def graph_ms(torch, fns, reps: int = 5) -> float:
    """Device ms per call: ``fns`` (one closure per cache copy, copies
    together larger than L2) captured once each into a CUDA graph, replayed
    ``reps`` times between two events."""
    for fn in fns:  # warm up outside the capture (lazy inits, workspaces)
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(fns))


def decode_operands(torch, dtype: str, T: int, gen, copies: int):
    B, K, G, h = (DECODE_SHAPE[k] for k in ("B", "K", "group", "h"))
    qd = torch.float32 if dtype == "fp32" else torch.bfloat16
    lengths = torch.randint(1, T + 1, (B,), generator=gen, device=DEVICE, dtype=torch.int32)
    lengths[0], lengths[-1] = 1, T
    q = torch.randn(B, 1, K * G, h, generator=gen, device=DEVICE).to(qd)
    sets = []
    for _ in range(copies):
        k = torch.randn(B, T, K, h, generator=gen, device=DEVICE)
        v = torch.randn(B, T, K, h, generator=gen, device=DEVICE)
        if dtype == "int8":
            ks = (k.abs().amax(-1) / 127).clamp_min(1e-8)
            vs = (v.abs().amax(-1) / 127).clamp_min(1e-8)
            k = (k / ks[..., None]).round().clamp(-127, 127).to(torch.int8)
            v = (v / vs[..., None]).round().clamp(-127, 127).to(torch.int8)
            sets.append((k, v, ks.bfloat16(), vs.bfloat16()))
        else:
            sets.append((k.to(qd), v.to(qd), None, None))
    return q, lengths, sets


def kernel_phase(torch, da, dtype: str, T: int, seed: int) -> dict:
    B, K, G, h = (DECODE_SHAPE[k] for k in ("B", "K", "group", "h"))
    H = K * G
    itemsize = {"bf16": 2, "fp32": 4, "int8": 1}[dtype]
    set_bytes = 2 * B * T * K * h * itemsize
    copies = max(1, math.ceil(128e6 / set_bytes))  # twice the 50 MB L2 in total
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q, lengths, sets = decode_operands(torch, dtype, T, gen, copies)
    k, v, ks, vs = sets[0]
    out = da.flash_decode(q, k, v, lengths, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    ref = da.flash_decode_reference(q, k, v, lengths, k_scale=ks, v_scale=vs)
    diff = (out.float() - ref.float()).abs()
    tol = TOLERANCE[dtype]
    max_err = diff.max().item()
    if not torch.isfinite(out).all() or (diff > tol + tol * ref.float().abs()).any():
        fail(f"flash_decode {dtype} T={T}: max |kernel - plain| {max_err} over tolerance {tol}")

    kernel_ms = graph_ms(torch, [
        lambda s=s: da.flash_decode(q, s[0], s[1], lengths, k_scale=s[2], v_scale=s[3]) for s in sets
    ])
    plain_ms = graph_ms(torch, [
        lambda s=s: da.flash_decode_reference(q, s[0], s[1], lengths, k_scale=s[2], v_scale=s[3])
        for s in sets
    ])
    # Yardstick only (the port never calls it): SDPA over the dequantized
    # cache in (B, heads, T, h) layout, laid out outside the timing.
    qd = q.dtype
    lib_in = []
    for kc, vc, ksc, vsc in sets:
        if ksc is not None:
            kc, vc = kc.to(qd) * ksc[..., None].to(qd), vc.to(qd) * vsc[..., None].to(qd)
        lib_in.append((kc.transpose(1, 2).contiguous(), vc.transpose(1, 2).contiguous()))
    mask = (torch.arange(T, device=DEVICE)[None, :] < lengths[:, None])[:, None, None, :]
    qt = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = graph_ms(torch, [
        lambda a=a: sdpa(qt, a[0], a[1], attn_mask=mask, enable_gqa=True) for a in lib_in
    ])

    tokens = int(lengths.sum().item())
    moved = tokens * K * h * 2 * itemsize + 2 * q.numel() * q.element_size() + 4 * B
    if dtype == "int8":
        moved += tokens * K * 2 * 2  # bf16 scales
    flops = 4 * tokens * H * h  # q.k and p.v, fp32
    bound = {"bytes": moved / HBM_BYTES_PER_S * 1e3, "operations": flops / FP32_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    return {
        "phase": "kernel", "name": "flash_decode", "dtype": dtype, "T": T, **DECODE_SHAPE,
        "lengths": lengths.tolist(), "max_abs_err": max_err, "tolerance": tol,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound[bound_by], "bound_by": bound_by, "bytes": moved,
        "cache_copies": copies,
    }


def logits_check(torch, llama, layers, da, cfg, params, kv_dtype, seed: int) -> dict:
    """One decode step over 8 ragged rows: kernel vs the plain attention
    (`flash_decode_reference`, swapped in by name for the second run)."""
    cache = llama.init_cache(cfg, 8, SERVE_MAX_LEN, kv_dtype, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    cursors = [1, 33, 64, 130, 200, 256, 300, SERVE_MAX_LEN - 1]
    for row, n in enumerate(cursors):
        view = layers.cache_slot_view({k: v for k, v in cache.items() if k != "length"}, row)
        prompt = torch.randint(0, cfg.vocab_size, (1, n), generator=gen, device=DEVICE)
        llama.forward_with_cache(params, prompt, dict(view, length=0), cfg)
    step = torch.randint(0, cfg.vocab_size, (8, 1), generator=gen, device=DEVICE)
    length = torch.tensor(cursors, dtype=torch.int32, device=DEVICE)
    with torch.no_grad():
        before = da.KERNEL.launches
        kern, _ = llama.forward_with_cache(params, step, dict(cache, length=length), cfg)
        if da.KERNEL.launches - before != cfg.n_layers:
            fail("the decode step did not launch flash_decode once per layer")
        with mock.patch.object(layers, "flash_decode", da.flash_decode_reference):
            plain, _ = llama.forward_with_cache(params, step, dict(cache, length=length), cfg)
    kern, plain = kern.float(), plain.float()
    if kern.shape != (8, 1, cfg.vocab_size) or not torch.isfinite(kern).all():
        fail(f"decode logits {tuple(kern.shape)} not finite or misshapen")
    err = (kern - plain).abs().max().item()
    scale = plain.abs().max().item()
    if err > LOGIT_TOLERANCE * scale:
        fail(f"decode logits kernel vs plain: max |diff| {err} > {LOGIT_TOLERANCE} * {scale}")
    del cache
    return {
        "logits_max_abs_err": err, "logits_max_abs": scale,
        "logits_tolerance": LOGIT_TOLERANCE * scale,
        "argmax_agree": int((kern.argmax(-1) == plain.argmax(-1)).sum().item()),
    }


def serve_phase(torch, modules, cfg, params, kv: str, args, card: str) -> dict:
    llama, layers, da, dispatch, generation, serving, telemetry = modules
    gcfg = generation.GenerationConfig(kv_cache_dtype=kv)
    kv_dtype = generation.cache_dtype(gcfg)
    engine = serving.Engine(
        lambda p, t, c: llama.forward_with_cache(p, t, c, cfg),
        lambda b, m: llama.init_cache(cfg, b, m, kv_dtype, device=DEVICE),
        params, gcfg, slots=8, buckets=SERVE_BUCKETS, max_len=SERVE_MAX_LEN,
    )
    # Warm-up (cuBLAS handles, allocator pools): two short requests.
    engine.serve(serving.poisson_trace(
        2, 100.0, vocab_size=cfg.vocab_size, prompt_lens=(16, 40), new_tokens=(4, 4),
        seed=args.seed + 1,
    ))
    torch.cuda.synchronize()
    trace = serving.poisson_trace(
        args.requests, args.rate, vocab_size=cfg.vocab_size, prompt_lens=(16, 200),
        new_tokens=(32, 64), seed=args.seed,
    )
    steps0 = engine.stats["decode_steps"]
    slot_steps0 = engine.stats["decode_slot_steps"]
    decode_hist = telemetry.REGISTRY.get("serve_decode_step_ms")
    decode_ms0 = decode_hist.sum(**engine.stats.labels)
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    completions = engine.serve(trace, realtime=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dispatch.launch_counts()["flash_decode"]
    steps = engine.stats["decode_steps"] - steps0
    if sorted(c.rid for c in completions) != [r.rid for r in trace]:
        fail(f"{kv}: {len(completions)} of {len(trace)} requests completed")
    by_rid = {r.rid: r for r in trace}
    for c in completions:
        if c.n_new != by_rid[c.rid].max_new_tokens or c.finish_reason != "length":
            fail(f"{kv}: request {c.rid} ended early ({c.finish_reason}, {c.n_new} tokens)")
        if not ((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all():
            fail(f"{kv}: request {c.rid} emitted token ids outside the vocabulary")
    if steps < 1 or launches != steps * cfg.n_layers:
        fail(f"{kv}: flash_decode launched {launches} times over {steps} decode steps "
             f"x {cfg.n_layers} layers")
    decode_s = (decode_hist.sum(**engine.stats.labels) - decode_ms0) / 1e3
    decode_tokens = engine.stats["decode_slot_steps"] - slot_steps0
    ttft = sorted((c.first_token_at - c.submitted_at) * 1e3 for c in completions)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del engine
    torch.cuda.empty_cache()
    check = logits_check(torch, llama, layers, da, cfg, params, kv_dtype, args.seed + 2)
    return {
        "phase": "serve", "model": "llama3-8b", "kv_cache_dtype": kv, "card": card,
        "requests": len(completions), "generated_tokens": sum(c.n_new for c in completions),
        "decode_steps": steps, "flash_decode_launches": launches,
        "decode_tokens_per_s": decode_tokens / decode_s,
        "decode_step_ms": decode_s * 1e3 / steps,
        "serve_tokens_per_s": sum(c.n_new for c in completions) / wall,
        "ttft_p50_ms": ttft[len(ttft) // 2], "ttft_max_ms": ttft[-1],
        "wall_s": wall, "peak_memory_gb": peak_gb, **check,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--rate", type=float, default=16.0, help="Poisson arrivals/sec")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from accelerate_tpu_torch import generation, serving, telemetry
    from accelerate_tpu_torch.models import layers, llama
    from accelerate_tpu_torch.native import build, dispatch
    from accelerate_tpu_torch.native import decode_attention as da

    card = card_line()
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "card": card,
          "libraries": {k: str(v.name) for k, v in libs.items()}})
    for src, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[nvcc {src}] {line.strip()}", file=sys.stderr)

    main_path = None
    for T in (SERVE_MAX_LEN, 4096):
        for dtype in ("bf16", "fp32", "int8"):
            row = kernel_phase(torch, da, dtype, T, args.seed)
            row["card"] = card
            emit(row)
            if T == SERVE_MAX_LEN and dtype == "bf16":
                main_path = row

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init(cfg, seed=args.seed, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.synchronize()
    emit({"phase": "init", "model": "llama3-8b", "params": cfg.param_count(),
          "seconds": time.perf_counter() - t0})
    modules = (llama, layers, da, dispatch, generation, serving, telemetry)
    serve_rows = [serve_phase(torch, modules, cfg, params, kv, args, card) for kv in ("bf16", "int8")]
    for row in serve_rows:
        emit(row)

    print(card)
    emit({"kernels": [{
        "name": "flash_decode",
        "route": "cuda",
        "source": "accelerate_tpu_torch/native/csrc/decode_attention.cu",
        "replaces": "accelerate_tpu/native/pallas/decode_attention.py:188",
        "launches": serve_rows[0]["flash_decode_launches"],
        "max_abs_err": main_path["max_abs_err"],
        "ms": main_path["kernel_ms"],
        "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"],
        "library_ms": main_path["library_ms"],
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
