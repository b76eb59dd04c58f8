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
3. flash kernel: the flash-attention fwd, dq and dkv kernels against their
   plain versions at the train shape (B 2, H 32, K 8, head_dim 128, S 2048,
   bf16, causal), at S 4096, in fp32 (S 1024), with a 512 window, not
   causal with valid = S - 37, and at head_dim 64 with a ragged S, each
   output at its own tolerance (lse at fp32's), then dq and dkv on the
   forward kernel's own o and lse against the plain forward and backward;
   prints each kernel's error, its, the plain version's and SDPA's device
   time (CUDA events), and the bound;
4. serve: Llama-3-8B at full width and depth with random bf16 weights from
   --seed behind `serving.Engine` (8 slots, buckets 32..256, max_len 512,
   greedy), replaying a Poisson trace in real time; every request must
   complete, flash-decode must have launched exactly 32 times per decode
   step, and one decode step's logits with the kernel must agree with the
   plain attention's; then the same with an int8 KV cache;
5. train: Llama-3-8B width cut to 8 layers (fp32 masters, bf16 compute,
   remat "attn_and_outputs", flash attention) through `Accelerator`
   (AdamW 3e-4, max_grad_norm 1.0) on one random (2, 2048) batch from
   --seed: one warm-up and three timed steps with finite, falling loss and
   16 / 8 / 8 fwd / dq / dkv launches per step; then, at 2 layers, one
   step's loss and gradients under flash against the plain attention;
6. a {"kernels": [...]} line;
7. last line: {"ok": true, "device": {...}}.

Exits non-zero without a CUDA device, and without the package beside it.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time
from unittest import mock

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense tensor cores
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
# Flash attention at the train shape (Llama-3-8B heads, batch 2 x 2048) and
# the other cases of the kernel phase: (name, B, S, H, K, h, dtype, causal,
# valid offset from S, window).
FLASH_CASES = (
    ("train", 2, 2048, 32, 8, 128, "bf16", True, 0, None),
    ("S4096", 2, 4096, 32, 8, 128, "bf16", True, 0, None),
    ("fp32", 2, 1024, 32, 8, 128, "fp32", True, 0, None),
    ("window512", 2, 2048, 32, 8, 128, "bf16", True, 0, 512),
    ("noncausal", 2, 2048, 32, 8, 128, "bf16", False, 37, None),
    ("hd64", 1, 300, 8, 2, 64, "bf16", True, 0, 100),
)
# Flash kernels against their plain versions on identical inputs, (abs,
# rel) per output. lse is fp32 on both sides (an fp32 logsumexp in another
# order; measured 1.4e-6 on an H100). A bf16 output differs by at most one
# rounding (one ulp, 2^-8 to 2^-7 relative) plus, for o, the p of rows
# whose running max moved rounded apart: measured on an H100 at most 3.9e-3
# for o and dq at the train shape (one ulp of |o| in [0.5, 1)) and one ulp
# for dk/dv.
FLASH_TOLERANCE = {
    "bf16": {"o": (4e-3, 1e-2), "lse": (1e-4, 1e-5), "dq": (4e-3, 1e-2),
             "dk": (4e-3, 1e-2), "dv": (4e-3, 1e-2)},
    "fp32": {"o": (2e-5, 2e-5), "lse": (1e-4, 1e-5), "dq": (2e-5, 2e-5),
             "dk": (2e-5, 2e-5), "dv": (2e-5, 2e-5)},
}
# The whole chain, kernel forward -> kernel dq/dkv on the kernel's own o and
# lse, against the plain forward -> plain backward: the JAX tests' own
# tolerances for flash gradients (bf16 2e-2, fp32 5e-4). The kernels' o
# reaches dq/dk/dv through delta, so its roundings add up here.
FLASH_CHAIN_TOLERANCE = {"bf16": (2e-2, 2e-2), "fp32": (5e-4, 5e-4)}
TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 2, 2048, 3
# One step at 2 layers, flash vs the plain attention (bf16 compute): the
# plain attention rounds its logits to bf16 where the kernels keep fp32,
# so the two differ by bf16 roundings that a wrong mask, head mapping or
# gradient formula would exceed by orders of magnitude. Measured on an
# H100 (seed 0): |dloss| 1.6e-4, grad-norm 7.7e-7 relative, worst leaf
# 8.9e-3 relative; the limits leave 2-100x of room.
FLASH_VS_DOT = {"loss": 2e-3, "grad_norm_rel": 1e-4, "leaf_rel": 2e-2}


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


def event_ms(torch, fn, reps: int) -> float:
    """Device ms per call of ``fn``: ``reps`` calls between two CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_close(torch, label: str, got, ref, tol: tuple[float, float]) -> tuple[float, float]:
    """Fails unless every element is finite and |got - ref| <= abs + rel *
    |ref|; returns (max |got - ref|, the largest share of its tolerance)."""
    atol, rtol = tol
    diff = (got.float() - ref.float()).abs()
    share = (diff / (atol + rtol * ref.float().abs())).max().item()
    max_err = diff.max().item()
    if not torch.isfinite(got).all() or not share <= 1.0:
        fail(f"{label}: max |kernel - plain| {max_err}, {share:.3g}x its tolerance {tol}")
    return max_err, share


def flash_kernel_phase(torch, fa, case, seed: int) -> dict:
    """fwd, dq and dkv against their plain versions on the same inputs (the
    backward ones fed the plain forward's o and lse), then the kernels'
    whole chain (dq and dkv on the kernel forward's own o and lse) against
    the plain one; with device times and bounds. SDPA (forward, and the
    backward of one forward) is the library yardstick; the port never calls
    it."""
    name, B, S, H, K, h, dtype, causal, valid_off, window = case
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    valid = S - valid_off
    kw = dict(causal=causal, valid=valid, window=window)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(B, S, H, h, generator=gen, device=DEVICE).to(dt)
    k = torch.randn(B, S, K, h, generator=gen, device=DEVICE).to(dt)
    v = torch.randn(B, S, K, h, generator=gen, device=DEVICE).to(dt)
    do = torch.randn(B, S, H, h, generator=gen, device=DEVICE).to(dt)

    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, **kw)
    delta = fa.flash_attention_delta(ro, do)
    dq = fa.flash_attention_dq(q, k, v, do, rlse, delta, **kw)
    dk, dv = fa.flash_attention_dkv(q, k, v, do, rlse, delta, **kw)
    torch.cuda.synchronize()
    rdq = fa.flash_attention_dq_reference(q, k, v, do, rlse, delta, **kw)
    rdk, rdv = fa.flash_attention_dkv_reference(q, k, v, do, rlse, delta, **kw)
    tol = FLASH_TOLERANCE[dtype]
    errs, shares = {}, {}
    for label, got, ref in (("o", o, ro), ("lse", lse, rlse), ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        errs[label], shares[label] = check_close(torch, f"flash {label} {name}", got, ref, tol[label])
    del dq, dk, dv
    kdelta = fa.flash_attention_delta(o, do)
    chain = {"dq": fa.flash_attention_dq(q, k, v, do, lse, kdelta, **kw)}
    chain["dk"], chain["dv"] = fa.flash_attention_dkv(q, k, v, do, lse, kdelta, **kw)
    torch.cuda.synchronize()
    chain_errs = {}
    for label, ref in (("dq", rdq), ("dk", rdk), ("dv", rdv)):
        chain_errs[label], shares[f"chain_{label}"] = check_close(
            torch, f"flash chain {label} {name}", chain[label], ref, FLASH_CHAIN_TOLERANCE[dtype])
    del ro, rdq, rdk, rdv, chain, kdelta

    # Visible (row, col) pairs: the work this mask needs.
    rows = torch.arange(S, device=DEVICE)[:, None]
    cols = torch.arange(S, device=DEVICE)[None, :]
    keep = cols <= rows if causal else (cols < valid).expand(S, S)
    if window is not None:
        keep = keep & (rows - cols < window)
    pairs = int(keep.sum().item())
    peak = FP32_FLOPS if dtype == "fp32" else BF16_FLOPS
    itemsize = q.element_size()
    qb, kvb, stat = q.numel() * itemsize, k.numel() * itemsize, B * H * S * 4
    work = {  # (products of 2*h FLOPs per visible pair and head, bytes moved)
        "fwd": (2, 2 * qb + 2 * kvb + stat),
        "dq": (3, 3 * qb + 2 * kvb + 2 * stat),
        "dkv": (4, 2 * qb + 4 * kvb + 2 * stat),
    }
    reps = 10
    kernel_ms = {
        "fwd": event_ms(torch, lambda: fa.flash_attention_fwd(q, k, v, **kw), reps),
        "dq": event_ms(torch, lambda: fa.flash_attention_dq(q, k, v, do, rlse, delta, **kw), reps),
        "dkv": event_ms(torch, lambda: fa.flash_attention_dkv(q, k, v, do, rlse, delta, **kw), reps),
    }
    plain_ms = {
        "fwd": event_ms(torch, lambda: fa.flash_attention_fwd_reference(q, k, v, **kw), 2),
        "dq": event_ms(torch, lambda: fa.flash_attention_dq_reference(q, k, v, do, rlse, delta, **kw), 2),
        "dkv": event_ms(torch, lambda: fa.flash_attention_dkv_reference(q, k, v, do, rlse, delta, **kw), 2),
    }
    # Yardstick: SDPA in its (B, heads, S, h) layout, laid out outside the
    # timing; a window or a valid prefix becomes a boolean mask.
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    dot_ = do.transpose(1, 2).contiguous()
    sdpa_kw = dict(enable_gqa=True, scale=1.0 / math.sqrt(h))
    if window is None and causal:
        sdpa_kw["is_causal"] = True
    else:
        sdpa_kw["attn_mask"] = keep
    sdpa = torch.nn.functional.scaled_dot_product_attention
    sdpa_fwd_ms = event_ms(torch, lambda: sdpa(qt, kt, vt, **sdpa_kw), reps)
    out = sdpa(qt, kt, vt, **sdpa_kw)
    sdpa_bwd_ms = event_ms(
        torch, lambda: torch.autograd.grad(out, (qt, kt, vt), dot_, retain_graph=True), reps
    )
    library = {"fwd": sdpa_fwd_ms, "dq": sdpa_bwd_ms, "dkv": sdpa_bwd_ms}
    row = {"phase": "flash_kernel", "case": name, "B": B, "S": S, "H": H, "K": K, "h": h,
           "dtype": dtype, "causal": causal, "valid": valid, "window": window,
           "visible_pairs": pairs, "tolerance": tol, "chain_tolerance": FLASH_CHAIN_TOLERANCE[dtype],
           "max_abs_err": errs, "chain_max_abs_err": chain_errs, "tolerance_share": shares,
           "sdpa_fwd_ms": sdpa_fwd_ms,
           "sdpa_bwd_ms": sdpa_bwd_ms}
    for part, (products, moved) in work.items():
        flops = products * 2 * h * H * B * pairs
        bound = {"bytes": moved / HBM_BYTES_PER_S * 1e3, "operations": flops / peak * 1e3}
        bound_by = max(bound, key=bound.get)
        part_errs = {"fwd": ("o", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}[part]
        row[part] = {
            "max_abs_err": max(errs[e] for e in part_errs),
            "kernel_ms": kernel_ms[part], "plain_ms": plain_ms[part],
            # SDPA's backward computes dq, dk and dv together.
            "library_ms": library[part],
            "bound_ms": bound[bound_by], "bound_by": bound_by, "flops": flops, "bytes": moved,
            "tflops": flops / kernel_ms[part] / 1e9,
        }
    del out, qt, kt, vt, dot_
    torch.cuda.empty_cache()
    return row


def train_setup(torch, llama, cfg, seed: int):
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator

    acc = Accelerator(mixed_precision="bf16", seed=seed, max_grad_norm=1.0, device=DEVICE)
    state = acc.create_train_state(lambda s: llama.init(cfg, seed=s, device=DEVICE), optim.adamw(3e-4))
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    batch = {"input_ids": torch.randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=gen, device=DEVICE)}
    return acc, state, batch


def train_phase(torch, llama, dispatch, seed: int, card: str) -> dict:
    """The port's train step at Llama-3-8B width and 8 layers: launches,
    loss, step time, tokens/s, model-FLOP share and peak memory."""
    cfg = llama.LlamaConfig.llama3_8b(
        n_layers=TRAIN_LAYERS, remat=True, remat_policy="attn_and_outputs", attention_impl="flash"
    )
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    acc, state, batch = train_setup(torch, llama, cfg, seed)
    step = acc.make_train_step(lambda p, b, g: llama.loss_fn(p, b, cfg, g))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    dispatch.reset_launch_counts()
    losses, step_s, grad_norms = [], [], []
    for _ in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        grad_norms.append(metrics["grad_norm"].item())
    launches = dispatch.launch_counts()
    steps = 1 + TRAIN_STEPS
    want = {"flash_attention_fwd": 2 * TRAIN_LAYERS, "flash_attention_dq": TRAIN_LAYERS,
            "flash_attention_dkv": TRAIN_LAYERS}
    for kname, per_step in want.items():
        if launches.get(kname, 0) != per_step * steps:
            fail(f"train: {kname} launched {launches.get(kname, 0)} times over {steps} steps, "
                 f"expected {per_step} per step")
    if not all(math.isfinite(x) for x in losses + grad_norms):
        fail(f"train: non-finite loss or grad norm {losses} {grad_norms}")
    if not losses[-1] < losses[0]:
        fail(f"train: loss did not fall on a repeated batch: {losses}")

    # The optimizer update alone (AdamW foreach over the fp32 masters).
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state.opt_state.step()
    end.record()
    torch.cuda.synchronize()
    adamw_ms = start.elapsed_time(end)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_params = cfg.param_count()
    step_mean = sum(step_s[1:]) / TRAIN_STEPS
    tokens = TRAIN_BATCH * (TRAIN_SEQ - 1)  # loss_fn shifts by one
    tokens_per_s = tokens / step_mean
    flops_per_token = 6.0 * n_params + 6.0 * cfg.n_layers * cfg.d_model * TRAIN_SEQ
    del state, acc, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {
        "phase": "train", "model": "llama3-8b", "n_layers": cfg.n_layers, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat_policy": cfg.remat_policy,
        "attention_impl": cfg.attention_impl, "card": card, "setup_s": setup_s,
        "losses": losses, "grad_norms": grad_norms, "step_ms": [s * 1e3 for s in step_s],
        "step_ms_mean": step_mean * 1e3, "tokens_per_s": tokens_per_s,
        "model_flop_share": tokens_per_s * flops_per_token / BF16_FLOPS,
        "adamw_ms": adamw_ms, "peak_memory_gb": peak_gb, "launches": launches,
        "launches_per_step": {k: launches[k] / steps for k in want},
    }


def flash_vs_dot_phase(torch, llama, seed: int, card: str) -> dict:
    """At 2 layers, one step's loss and gradients (before the update) with
    the flash kernels against the plain attention, on the same params and
    batch."""
    from accelerate_tpu_torch.utils.dataclasses import MixedPrecisionPolicy

    base = dict(n_layers=2, remat=True, remat_policy="attn_and_outputs")
    cfg_flash = llama.LlamaConfig.llama3_8b(attention_impl="flash", **base)
    cfg_dot = llama.LlamaConfig.llama3_8b(attention_impl="dot", **base)
    acc, state, batch = train_setup(torch, llama, cfg_flash, seed)
    policy = MixedPrecisionPolicy.from_precision("bf16")
    leaves = [p for p in state.leaves() if p.requires_grad]
    results = {}
    for name, cfg in (("flash", cfg_flash), ("dot", cfg_dot)):
        for p in leaves:
            p.grad = None
        loss = llama.loss_fn(policy.cast_for_compute(state.params), batch, cfg).float()
        loss.backward()
        results[name] = (loss.item(), [p.grad.clone() for p in leaves])
        for p in leaves:
            p.grad = None
    (lf, gf), (ld, gd) = results["flash"], results["dot"]
    names = list(llama.flatten(state.params))
    leaf_rel = {
        n: ((a - b).norm() / b.norm().clamp_min(1e-30)).item() for n, a, b in zip(names, gf, gd)
    }
    norm_f = torch.linalg.vector_norm(torch.stack([g.norm() for g in gf])).item()
    norm_d = torch.linalg.vector_norm(torch.stack([g.norm() for g in gd])).item()
    row = {
        "phase": "flash_vs_dot", "n_layers": 2, "card": card, "loss_flash": lf, "loss_dot": ld,
        "loss_abs_diff": abs(lf - ld), "grad_norm_flash": norm_f, "grad_norm_dot": norm_d,
        "grad_norm_rel_diff": abs(norm_f - norm_d) / norm_d, "leaf_rel_diff": leaf_rel,
        "tolerance": FLASH_VS_DOT,
    }
    del state, acc, results, gf, gd
    gc.collect()
    torch.cuda.empty_cache()
    if not (math.isfinite(lf) and math.isfinite(ld)) or row["loss_abs_diff"] > FLASH_VS_DOT["loss"]:
        fail(f"flash vs dot: loss {lf} vs {ld}")
    if row["grad_norm_rel_diff"] > FLASH_VS_DOT["grad_norm_rel"]:
        fail(f"flash vs dot: grad norm {norm_f} vs {norm_d}")
    worst = max(leaf_rel, key=leaf_rel.get)
    if leaf_rel[worst] > FLASH_VS_DOT["leaf_rel"]:
        fail(f"flash vs dot: gradient of {worst} differs by {leaf_rel[worst]} (relative)")
    return row


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
    from accelerate_tpu_torch.native import flash_attention as fa

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

    flash_rows = {}
    for case in FLASH_CASES:
        row = flash_kernel_phase(torch, fa, case, args.seed)
        row["card"] = card
        emit(row)
        flash_rows[case[0]] = row

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
    del params
    gc.collect()
    torch.cuda.empty_cache()

    train_row = train_phase(torch, llama, dispatch, args.seed, card)
    emit(train_row)
    emit(flash_vs_dot_phase(torch, llama, args.seed, card))

    print(card)
    kernels = [{
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
    }]
    # Each kernel ports the resident and the blocked TPU kernel of one
    # function; "replaces" names the resident one's pallas_call (the train
    # shape's route on the TPU) and the blocked one's.
    replaces = {
        "fwd": "accelerate_tpu/ops/flash_attention.py:179 (and :468)",
        "dq": "accelerate_tpu/ops/flash_attention.py:303 (and :617)",
        "dkv": "accelerate_tpu/ops/flash_attention.py:320 (and :649)",
    }
    main = flash_rows["train"]
    for part in ("fwd", "dq", "dkv"):
        kernels.append({
            "name": f"flash_attention_{part}",
            "route": "cuda",
            "source": "accelerate_tpu_torch/native/csrc/flash_attention.cu",
            "replaces": replaces[part],
            "launches": train_row["launches"][f"flash_attention_{part}"],
            "max_abs_err": main[part]["max_abs_err"],
            "ms": main[part]["kernel_ms"],
            "plain_ms": main[part]["plain_ms"],
            "bound_ms": main[part]["bound_ms"],
            "bound_by": main[part]["bound_by"],
            "library_ms": main[part]["library_ms"],
        })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
