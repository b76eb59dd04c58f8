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
4. quant kernel: the int8 kernel against its plain version at the int8
   prefill's products (M 2048; q/o with the per-h weight scale, k/v,
   gate/up, down), with int4-range weights and with ragged M (37) and
   ragged fp32 operands, to one ulp of x's dtype; the fp8 kernel at the
   fp8 train step's products (M 4096) in its three orientations and type
   pairs (forward e4m3.e4m3, dx e5m2.e4m3, dw e4m3.e5m2), the fourth
   orientation and ragged edges, within fp32 reordering plus one output
   rounding; device times of the kernel, the plain version and
   `torch._int_mm` / `torch._scaled_mm`, and the bound;
5. serve: Llama-3-8B at full width and depth with random bf16 weights from
   --seed behind `serving.Engine` (8 slots, buckets 32..256, max_len 512,
   greedy), replaying a Poisson trace in real time; every request must
   complete, flash-decode must have launched exactly 32 times per decode
   step, and one decode step's logits with the kernel must agree with the
   plain attention's; then the same with an int8 KV cache;
6. int8 prefill: the same weights through `quantize_pytree` (int8), a
   (4, 512) `forward` under `int8_compute` with exactly 224 int8_matmul
   launches, its logits against the dequantize path's (argmax agreement,
   logit drift), forward times beside the dequantize path's and the bf16
   weights', the weight bytes; then 16 greedy tokens from the quantized
   tree through flash-decode (32 launches a decode step);
7. train: Llama-3-8B width cut to 8 layers (fp32 masters, bf16 compute,
   remat "attn_and_outputs", flash attention) through `Accelerator`
   (AdamW 3e-4, max_grad_norm 1.0) on one random (2, 2048) batch from
   --seed: one warm-up and three timed steps with finite, falling loss and
   16 / 8 / 8 fwd / dq / dkv launches per step; then, at 2 layers, one
   step's loss and gradients under flash against the plain attention;
8. fp8 train: the same with mixed_precision="fp8", 200 fp8_matmul
   launches a step besides the flash ones, the bf16 step's numbers beside
   it; then, at 2 layers, one fp8 step's loss and grad norm against bf16's;
9. a {"kernels": [...]} line with the seven hand-written kernels;
10. last line: {"ok": true, "device": {...}}.

Besides, after the quant kernel phase: adamw_kernel, the fused-AdamW kernel
against its plain version (`host_offload._adamw_slice`) at the main path's
largest leaf (blocks.mlp.w_gate at 8 layers, 469.8 M fp32 elements), one
layer slice of it, final_norm, a 24-element leaf, an odd misaligned size,
bf16 grads, bf16 moments, without grad_scale, counts 1 to 1000, each in
both modes (update out; update added into p), with the kernel's, the plain
version's and `torch.optim.AdamW(fused=True)`'s device times and the bound;
and kv_scale, whether `quantize_kv`'s scales equal an IEEE divide on the
card. After the train phase: fused_adamw_train, the same 8-layer step with
the device-resident `host_offloaded_adamw` (12 fused_adamw launches a step,
losses within 1e-3 of the foreach run's). After fp8 train: offload_train,
Llama-3-8B width at 16 layers with `FsdpPlugin(offload_optimizer=True)`
(moments in pinned host memory, 147 fused_adamw launches a step, finite
and falling loss, step and update times, copy rate, peak device memory
beside the reckoned device-resident need); and offload_parity, 3 steps at
2 layers offloaded and device-resident, bit-identical params and moments.

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
import warnings
from unittest import mock

DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM, dense tensor cores
FP8_FLOPS = 1979e12  # H100 SXM, dense tensor cores; int8 TOP/s the same
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
# Quantized kernels against their plain versions (the quant_kernel phase):
# (name, M rows as (B, S), C, N, weight view). The int8 cases are the
# prefill's products at M 2048 (a (4, 512) batch): q/o (4096, 4096, per-h
# weight scale of the stacked wq), k/v (4096, 1024), gate/up (4096, 14336),
# down (14336, 4096); an int4-range weight from `_unpack_int4`; a ragged M
# of 37 (and a ragged fp32 case through the byte-wise loads). The fp8 cases
# are the train step's products at M 4096 (2 x 2048) in the three
# orientations the path uses (forward e4m3.e4m3 "trail x lead", dx
# e5m2.e4m3 "trail x trail", dw e4m3.e5m2 "lead x lead"), plus the fourth
# orientation and ragged edges.
INT8_CASES = (
    ("qo", (4, 512), 4096, 4096, "heads"),
    ("kv", (4, 512), 4096, 1024, "heads"),
    ("gate_up", (4, 512), 4096, 14336, "dense"),
    ("down", (4, 512), 14336, 4096, "dense"),
    ("int4", (4, 512), 4096, 4096, "int4"),
    ("ragged_m37", (1, 37), 4096, 1024, "dense"),
    ("ragged_fp32", (1, 37), 1000, 998, "fp32"),
)
FP8_SHAPES = (("qo", 4096, 4096), ("kv", 4096, 1024), ("gate_up", 4096, 14336), ("down", 14336, 4096))
FP8_TRAIN_ROWS = (2, 2048)
# int8: integer accumulation is exact and the kernel repeats the plain
# version's roundings (IEEE division, half-even rint, float(acc) * (sx *
# ws)), so the two agree to one ulp of x's dtype relative to max|out|.
# fp8: the exact fp8 products are summed in fp32 in another order (at most
# gamma_C = C u / (1 - C u), u = 2^-24, times sum |a b| * scale), and the
# bf16 output may round to a neighbouring value (one ulp, <= 2^-7 |out|;
# 2^-23 for fp32): |kernel - plain| <= ulp_rel * |plain| + 2 gamma_C * bound.
FP8_ULP_REL = {"bf16": 2.0**-7, "fp32": 2.0**-23}
# int8 prefill: Llama-3-8B, full width and depth, a (4, 512) prompt batch.
# Both paths use the same int8 weights; only the per-row int8 rounding of
# the activations (1/127 of each row's max, ~0.2 % rms a product) is new,
# and it adds up over 32 layers. A wrong scale, layout or rounding moves
# the logits by their own size (drift ~1, argmax agreement ~0).
PREFILL_BATCH, PREFILL_NEW_TOKENS = (4, 512), 16
INT8_VS_DEQUANT = {"rms_drift": 0.1, "argmax_agree": 0.5}
# fp8 train step: the bf16 train configuration with mixed_precision="fp8".
# fp8_matmul launches a step: 7 forward products a layer, 14 backward (dx
# and dw), and the forward products of the segments "attn_and_outputs"
# recomputes (the output projection, and gate, up and down; q/k/v are kept):
# 25 a layer, 200 at 8 layers.
FP8_LAUNCHES_PER_LAYER = 7 + 14 + 4
# One step at 2 layers, fp8 against bf16 on the same params and batch: e4m3
# keeps 3 mantissa bits and e5m2 2 (rounding up to 6 % and 12.5 % an
# element, a few % rms), averaged over the thousands of terms of every
# product; the loss of the random model near its uniform start moves far
# less. A dropped scale or a wrong operand moves both by orders of
# magnitude.
FP8_VS_BF16 = {"loss_rel": 1e-2, "grad_norm_ratio": (0.9, 1.1)}
# Fused AdamW (kernel 10) against its plain version: (name, elements, g
# dtype, moment dtype, grad_scale on, count, misaligned). The main path's
# largest leaf (blocks.mlp.w_gate at 8 layers, 8 x 4096 x 14336), one layer
# slice of it (the offloaded path's largest launch), final_norm, a 24-element
# leaf, an odd size at a 4-byte offset (the scalar path), bf16 grads, bf16
# moments, no grad_scale; counts 1, 7 and 1000. Each case in both modes
# (update written out; update added into p).
W_GATE = 4096 * 14336
ADAMW_CASES = (
    ("w_gate_8_layers", 8 * W_GATE, "fp32", "fp32", True, 1000, False),
    ("w_gate_slice", W_GATE, "fp32", "fp32", True, 1, False),
    ("final_norm", 4096, "fp32", "fp32", True, 7, False),
    ("leaf_24", 24, "fp32", "fp32", True, 1000, False),
    ("ragged_misaligned", 1_000_003, "fp32", "fp32", True, 7, True),
    ("g_bf16", W_GATE, "bf16", "fp32", True, 7, False),
    ("mu_bf16", W_GATE, "fp32", "bf16", True, 7, False),
    ("no_grad_scale", W_GATE, "fp32", "fp32", False, 1000, False),
)
ADAMW_HP = dict(lr_t=3e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
# The kernel repeats the plain version's operations (IEEE fp32 ops, bf16
# rounding after each with bf16 moments), so the two should agree bit for
# bit; the stated tolerance is JAX's own kernel-vs-body one for fp32
# moments (rtol 1e-6, atol 1e-7) and one bf16 rounding for bf16 ones. An
# applied p may differ by one more rounding of p itself.
ADAMW_TOLERANCE = {"fp32": (1e-7, 1e-6), "bf16": (1e-7, 2.0**-8)}
ADAMW_OPS = 17  # fp32 operations an element (scale, EMAs, corrections, sqrt, decay, lr, apply)
# The 8-layer train step with `host_offloaded_adamw` instead of the foreach
# AdamW: the same math in another order of operations, so the losses of the
# two runs agree far inside this (relative, at every step).
FUSED_VS_FOREACH_LOSS = 1e-3
# Offloaded moments: Llama-3-8B width at 16 layers (4.54 B params), the
# depth at which device-resident fp32 state (16 B a param) no longer fits
# the card while masters + gradients (8 B) do. 9 stacked leaves are updated
# one layer slice at a time and embed, final_norm and lm_head whole.
OFFLOAD_LAYERS = 16
LLAMA_STACKED_LEAVES, LLAMA_LEAVES = 9, 12
PARITY_LAYERS, PARITY_STEPS = 2, 3


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


def _eps(torch, dtype) -> float:
    return torch.finfo(dtype).eps


def int8_kernel_case(torch, qm, int8_ops, case, seed: int) -> dict:
    """One int8 product, kernel against plain version, with times."""
    name, rows, C, N, kind = case
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = torch.float32 if kind == "fp32" else torch.bfloat16
    x = torch.randn(*rows, C, generator=gen, device=DEVICE).to(dt)
    if kind == "heads":  # a per-layer wq / wk node: (D, heads, 128), scale (1, 1, 128)
        w_shape, s_shape, eq = (C, N // 128, 128), (1, 1, 128), "bsd,dhk->bshk"
    else:
        w_shape, s_shape, eq = (C, N), (1, N), "bsd,df->bsf"
    if kind == "int4":
        packed = torch.randint(0, 256, (C, N // 2), generator=gen, device=DEVICE, dtype=torch.int32)
        wq = int8_ops._unpack_int4(packed.to(torch.uint8))
        wq = torch.where(wq == -8, torch.zeros_like(wq), wq)  # quantize_array packs [-7, 7]
    else:
        wq = torch.randint(-127, 128, w_shape, generator=gen, device=DEVICE, dtype=torch.int32).to(torch.int8)
    ws = torch.rand(s_shape, generator=gen, device=DEVICE) * 1e-2 + 1e-3
    out = qm.int8_matmul(eq, x, wq, ws)
    torch.cuda.synchronize()
    ref = qm.int8_matmul_reference(eq, x, wq, ws)
    tol = _eps(torch, dt) * ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    if out.shape != ref.shape or not torch.isfinite(out).all() or err > tol:
        fail(f"int8_matmul {name}: max |kernel - plain| {err} over {tol}")
    M = x.numel() // C
    kernel_ms = event_ms(torch, lambda: qm.int8_matmul(eq, x, wq, ws), 10)
    plain_ms = event_ms(torch, lambda: qm.int8_matmul_reference(eq, x, wq, ws), 2)
    # Yardstick, the contraction only: torch._int_mm on rows quantized
    # beforehand (cuBLASLt int8; it wants M > 16 and C, N multiples of 8).
    library_ms = None
    if M > 16 and C % 8 == 0 and N % 8 == 0:
        qx, _ = int8_ops.quantize_act(x.reshape(M, C), (1,))
        w2 = wq.reshape(C, N)
        library_ms = event_ms(torch, lambda: torch._int_mm(qx, w2), 10)
    flops = 2 * M * N * C
    moved = x.numel() * x.element_size() + wq.numel() + 4 * N + M * N * x.element_size()
    bound = {"bytes": moved / HBM_BYTES_PER_S * 1e3, "operations": flops / FP8_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    return {"phase": "quant_kernel", "kernel": "int8_matmul", "case": name, "eq": eq, "M": M, "C": C,
            "N": N, "dtype": "fp32" if dt == torch.float32 else "bf16", "max_abs_err": err,
            "tolerance": tol, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "torch._int_mm on pre-quantized rows (contraction only)",
            "bound_ms": bound[bound_by], "bound_by": bound_by, "flops": flops, "bytes": moved,
            "tops": flops / kernel_ms / 1e9}


def _fp8_operands(torch, fp8_ops, a_shape, b_shape, types, gen):
    a = torch.randn(a_shape, generator=gen, device=DEVICE)
    b = torch.randn(b_shape, generator=gen, device=DEVICE) * 0.05
    qa, sa = fp8_ops.quantize(a, types[0])
    qb, sb = fp8_ops.quantize(b, types[1])
    return qa, qb, sa * sb


def fp8_kernel_case(torch, qm, fp8_ops, name, eq, a_shape, b_shape, types, out_dtype, seed: int) -> dict:
    """One fp8 product, kernel against plain version, with times."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    qa, qb, scale = _fp8_operands(torch, fp8_ops, a_shape, b_shape, types, gen)
    plan = qm._plan(eq, tuple(qa.shape), tuple(qb.shape))
    out = qm.scaled_matmul(eq, qa, qb, scale, out_dtype)
    torch.cuda.synchronize()
    ref = qm.scaled_matmul_reference(eq, qa, qb, scale, out_dtype)
    a2, b2 = qm._as_mc_cn(plan, *qm._views(plan, qa, qb))
    bound_sum = ((a2.float().abs() @ b2.float().abs()) * scale).reshape(ref.shape)
    u = 2.0**-24
    gamma = plan.C * u / (1 - plan.C * u)
    dname = "fp32" if out_dtype == torch.float32 else "bf16"
    tol = FP8_ULP_REL[dname] * ref.float().abs() + 2 * gamma * bound_sum
    diff = (out.float() - ref.float()).abs()
    share = (diff / tol.clamp_min(1e-30)).max().item()
    err = diff.max().item()
    if out.shape != ref.shape or not torch.isfinite(out).all() or not share <= 1.0:
        fail(f"fp8_matmul {name}: max |kernel - plain| {err}, {share:.3g}x its tolerance")
    del bound_sum, tol, diff
    M, N, C = plan.M, plan.N, plan.C
    kernel_ms = event_ms(torch, lambda: qm.scaled_matmul(eq, qa, qb, scale, out_dtype), 10)
    plain_ms = event_ms(torch, lambda: qm.scaled_matmul_reference(eq, qa, qb, scale, out_dtype), 2)
    # Yardstick: torch._scaled_mm (cuBLASLt fp8) wants a row-major and b
    # column-major, dims multiples of 16 and not e5m2 x e5m2; the layouts
    # are made outside the timing.
    library_ms = None
    if M % 16 == 0 and N % 16 == 0 and C % 16 == 0:
        la = a2.contiguous()
        lb = b2.t().contiguous().t()
        one = torch.ones((), device=DEVICE)
        library_ms = event_ms(
            torch, lambda: torch._scaled_mm(la, lb, scale_a=scale, scale_b=one, out_dtype=out_dtype), 10)
    flops = 2 * M * N * C
    moved = qa.numel() + qb.numel() + 4 + M * N * out.element_size()
    bound = {"bytes": moved / HBM_BYTES_PER_S * 1e3, "operations": flops / FP8_FLOPS * 1e3}
    bound_by = max(bound, key=bound.get)
    return {"phase": "quant_kernel", "kernel": "fp8_matmul", "case": name, "eq": eq,
            "orientation": [plan.oa, plan.ob], "types": [str(t).split(".")[-1] for t in types],
            "M": M, "C": C, "N": N, "out_dtype": dname, "max_abs_err": err,
            "tolerance_share": share, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library": "torch._scaled_mm",
            "bound_ms": bound[bound_by], "bound_by": bound_by, "flops": flops, "bytes": moved,
            "tflops": flops / kernel_ms / 1e9}


def fp8_cases(torch, fp8_ops):
    """(name, eq, a shape, b shape, (a type, b type), out dtype) of the fp8
    products of the train step at Llama-3-8B width, then the extra cases."""
    e4, e5 = fp8_ops.E4M3, fp8_ops.E5M2
    B, S = FP8_TRAIN_ROWS
    cases = []
    for name, C, N in FP8_SHAPES:
        cases += [
            (f"{name}_fwd", "bsd,df->bsf", (B, S, C), (C, N), (e4, e4), torch.bfloat16),
            (f"{name}_dx", "bsf,df->bsd", (B, S, N), (C, N), (e5, e4), torch.bfloat16),
            (f"{name}_dw", "bsd,bsf->df", (B, S, C), (B, S, N), (e4, e5), torch.bfloat16),
        ]
    cases += [
        ("lead_trail", "ki,jk->ij", (512, 384), (256, 512), (e4, e4), torch.bfloat16),
        ("ragged_fwd", "bsd,df->bsf", (1, 37, 100), (100, 50), (e4, e4), torch.bfloat16),
        ("ragged_dx", "bsf,df->bsd", (1, 37, 50), (100, 50), (e5, e4), torch.float32),
        ("ragged_dw", "bsd,bsf->df", (1, 37, 100), (1, 37, 50), (e4, e5), torch.bfloat16),
        ("ragged_lead_trail", "ki,jk->ij", (37, 45), (29, 37), (e5, e5), torch.float32),
    ]
    return cases


def quant_kernel_phase(torch, card: str, seed: int) -> list[dict]:
    from accelerate_tpu_torch.native import quant_matmul as qm
    from accelerate_tpu_torch.ops import fp8 as fp8_ops
    from accelerate_tpu_torch.ops import int8 as int8_ops

    rows = []
    for case in INT8_CASES:
        rows.append(dict(int8_kernel_case(torch, qm, int8_ops, case, seed), card=card))
        emit(rows[-1])
    for name, eq, a_shape, b_shape, types, out_dtype in fp8_cases(torch, fp8_ops):
        rows.append(dict(fp8_kernel_case(torch, qm, fp8_ops, name, eq, a_shape, b_shape, types,
                                         out_dtype, seed), card=card))
        emit(rows[-1])
    torch.cuda.empty_cache()
    return rows


def _offset_copy(torch, t, off: int):
    """A copy of ``t`` that starts ``off`` elements into a fresh buffer, so
    that a nonzero ``off`` misaligns it."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = buf[off:]
    view.copy_(t)
    return view


def _adamw_within(torch, label: str, got, ref, tol) -> dict:
    """Fails unless every element is finite and |got - ref| <= tol (an
    elementwise tensor); returns the largest error, the largest share of
    the tolerance and the share of bit-equal elements."""
    diff = (got.float() - ref.float()).abs()
    share = (diff / tol).max().item()
    if not torch.isfinite(got).all() or not share <= 1.0:
        fail(f"{label}: max |kernel - plain| {diff.max().item()}, {share:.3g}x its tolerance")
    return {"max_abs_err": diff.max().item(), "tolerance_share": share,
            "bit_equal": (got == ref).float().mean().item()}


def adamw_kernel_case(torch, fa, ho, case, seed: int) -> dict:
    """Kernel 10 against its plain version (`host_offload._adamw_slice`) on
    the same leaf, in both modes, with device times of the kernel, the
    plain version and `torch.optim.AdamW(fused=True)` (a yardstick: its
    math is torch's, not optax's), and the bound."""
    name, n, g_name, m_name, with_scale, count, misaligned = case
    dts = {"fp32": torch.float32, "bf16": torch.bfloat16}
    gdt, mdt = dts[g_name], dts[m_name]
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    off = 1 if misaligned else 0

    def draw(scale, dt, magnitude=False):
        x = torch.randn(n, generator=gen, device=DEVICE)
        x = x.abs_() if magnitude else x
        return _offset_copy(torch, (x * scale).to(dt), off)

    # The scales of a trained leaf's state: g ~ 1e-2, mu ~ 1e-3, nu ~ 1e-6.
    g, mu0, nu0, p0 = draw(1e-2, gdt), draw(1e-3, mdt), draw(1e-6, mdt, True), draw(1.0, torch.float32)
    scale = torch.full((1,), 0.5, device=DEVICE) if with_scale else None
    args = (count, *ADAMW_HP.values())
    ref_u, ref_mu, ref_nu = ho._adamw_slice(g, mu0, nu0, p0, *args, scale)
    ref_p = p0 + ref_u
    atol, rtol = ADAMW_TOLERANCE[m_name]
    errs = {}
    mu, nu = _offset_copy(torch, mu0, off), _offset_copy(torch, nu0, off)
    u, _, _ = fa.fused_adamw(g, mu, nu, p0, *args, scale)
    torch.cuda.synchronize()
    for label, got, ref in (("update", u, ref_u), ("mu", mu, ref_mu), ("nu", nu, ref_nu)):
        errs[label] = _adamw_within(torch, f"fused_adamw {name} {label}", got, ref, atol + rtol * ref.float().abs())
    del u
    mu, nu, p = (_offset_copy(torch, t, off) for t in (mu0, nu0, p0))
    fa.fused_adamw(g, mu, nu, p, *args, scale, apply=True)
    torch.cuda.synchronize()
    # p: the update's tolerance plus one fp32 rounding of the sum.
    p_tol = atol + rtol * ref_u.float().abs() + 2.0**-23 * ref_p.abs()
    errs["applied_p"] = _adamw_within(torch, f"fused_adamw {name} applied p", p, ref_p, p_tol)
    for label, got, ref in (("applied_mu", mu, ref_mu), ("applied_nu", nu, ref_nu)):
        errs[label] = _adamw_within(torch, f"fused_adamw {name} {label}", got, ref, atol + rtol * ref.float().abs())
    del ref_u, ref_mu, ref_nu, ref_p, p_tol
    torch.cuda.empty_cache()

    reps = 10
    kernel_ms = event_ms(torch, lambda: fa.fused_adamw(g, mu, nu, p, *args, scale, apply=True), reps)
    update_ms = event_ms(torch, lambda: fa.fused_adamw(g, mu, nu, p, *args, scale), reps)
    plain_ms = event_ms(torch, lambda: ho._adamw_slice(g, mu0, nu0, p0, *args, scale), 2)
    # Yardstick: PyTorch's fused AdamW on an fp32 copy of p with g as its
    # gradient (fp32 moments; it keeps its own state).
    param = p0.detach().clone()
    param.grad = g.float().contiguous()
    lib = torch.optim.AdamW([param], lr=ADAMW_HP["lr_t"], betas=(ADAMW_HP["b1"], ADAMW_HP["b2"]),
                            eps=ADAMW_HP["eps"], weight_decay=ADAMW_HP["weight_decay"], fused=True)
    library_ms = event_ms(torch, lib.step, reps)
    del lib, param
    gs, ms_, ps = g.element_size(), mu.element_size(), p.element_size()
    moved = {"apply": n * (gs + 4 * ms_ + 2 * ps), "update": n * (gs + ps + 5 * ms_)}
    moved["update_then_apply"] = moved["update"] + n * (2 * ps + ms_)
    ops = ADAMW_OPS * n
    bounds = {}
    for mode, nbytes in moved.items():
        bound = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3, "operations": ops / FP32_FLOPS * 1e3}
        bounds[mode] = (bound[max(bound, key=bound.get)], max(bound, key=bound.get))
    row = {"phase": "adamw_kernel", "case": name, "n": n, "g_dtype": g_name, "moment_dtype": m_name,
           "grad_scale": with_scale, "count": count, "misaligned": misaligned,
           "tolerance": ADAMW_TOLERANCE[m_name], "errors": errs,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "kernel_ms": kernel_ms, "kernel_update_ms": update_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "library": "torch.optim.AdamW(fused=True).step()",
           "bound_ms": bounds["apply"][0], "bound_by": bounds["apply"][1],
           "bound_update_ms": bounds["update"][0],
           "bound_update_then_apply_ms": bounds["update_then_apply"][0],
           "bytes": moved, "kernel_gb_per_s": moved["apply"] / kernel_ms / 1e6}
    del g, mu0, nu0, p0, mu, nu, p
    torch.cuda.empty_cache()
    return row


def adamw_kernel_phase(torch, card: str, seed: int) -> dict[str, dict]:
    from accelerate_tpu_torch.native import fused_adamw as fa
    from accelerate_tpu_torch.parallel import host_offload as ho

    rows = {}
    for case in ADAMW_CASES:
        rows[case[0]] = dict(adamw_kernel_case(torch, fa, ho, case, seed), card=card)
        emit(rows[case[0]])
    return rows


def kv_scale_phase(torch, layers, seed: int, card: str) -> dict:
    """Does PyTorch on the card divide a tensor by a Python scalar as an
    IEEE divide? `layers.quantize_kv` computes its scales as JAX does
    (``amax / 127``, an IEEE divide): it must equal that divide bit for
    bit. Counts the scales where the divide by the Python scalar 127.0
    differs, on a Llama-3-8B-shaped KV slab and on int8 prefill rows."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.randn(8, SERVE_MAX_LEN, 8, 128, generator=gen, device=DEVICE).to(torch.bfloat16)
    rows = torch.randn(PREFILL_BATCH[0] * PREFILL_BATCH[1], 4096, generator=gen, device=DEVICE).to(torch.bfloat16)
    out = {"phase": "kv_scale", "card": card}
    for label, t in (("kv", x), ("prefill_rows", rows)):
        amax = t.float().abs().amax(-1)
        ieee = amax / torch.full_like(amax, 127.0)
        out[f"{label}_scalar_divide_mismatches"] = int((amax / 127.0 != ieee).sum().item())
        out[f"{label}_scales"] = amax.numel()
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-8)
    q, s = layers.quantize_kv(x)
    want_q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    out["quantize_kv_equals_ieee"] = bool(torch.equal(s, scale.to(torch.bfloat16)) and torch.equal(q, want_q))
    if not out["quantize_kv_equals_ieee"]:
        fail("quantize_kv: scales or values differ from the IEEE divide amax / 127")
    return out


def train_setup(torch, llama, cfg, seed: int, precision: str = "bf16", tx=None, strategy=None):
    from accelerate_tpu_torch import optim
    from accelerate_tpu_torch.accelerator import Accelerator

    acc = Accelerator(mixed_precision=precision, seed=seed, max_grad_norm=1.0, strategy=strategy, device=DEVICE)
    state = acc.create_train_state(lambda s: llama.init(cfg, seed=s, device=DEVICE), tx or optim.adamw(3e-4))
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 3)
    batch = {"input_ids": torch.randint(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=gen, device=DEVICE)}
    return acc, state, batch


def train_phase(torch, llama, dispatch, seed: int, card: str, precision: str = "bf16",
                optimizer: str = "adamw") -> dict:
    """The port's train step at Llama-3-8B width and 8 layers: launches,
    loss, step time, tokens/s, model-FLOP share and peak memory; with
    ``optimizer="host_offloaded_adamw"`` the device-resident fused AdamW
    (one kernel launch a leaf) instead of the foreach one."""
    from accelerate_tpu_torch import host_offloaded_adamw

    cfg = llama.LlamaConfig.llama3_8b(
        n_layers=TRAIN_LAYERS, remat=True, remat_policy="attn_and_outputs", attention_impl="flash"
    )
    fused = optimizer == "host_offloaded_adamw"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    acc, state, batch = train_setup(torch, llama, cfg, seed, precision,
                                    tx=host_offloaded_adamw(3e-4) if fused else None)
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
    if precision == "fp8":
        want["fp8_matmul"] = FP8_LAUNCHES_PER_LAYER * TRAIN_LAYERS
    if fused:
        want["fused_adamw"] = LLAMA_LEAVES
    for kname, per_step in want.items():
        if launches.get(kname, 0) != per_step * steps:
            fail(f"train: {kname} launched {launches.get(kname, 0)} times over {steps} steps, "
                 f"expected {per_step} per step")
    if not all(math.isfinite(x) for x in losses + grad_norms):
        fail(f"train: non-finite loss or grad norm {losses} {grad_norms}")
    if not losses[-1] < losses[0]:
        fail(f"train: loss did not fall on a repeated batch: {losses}")

    # The optimizer update alone (over the fp32 masters, gradients unscaled).
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
        "phase": "fused_adamw_train" if fused else "train", "precision": precision,
        "optimizer": optimizer, "model": "llama3-8b", "n_layers": cfg.n_layers,
        "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "remat_policy": cfg.remat_policy,
        "attention_impl": cfg.attention_impl, "card": card, "setup_s": setup_s,
        "losses": losses, "grad_norms": grad_norms, "step_ms": [s * 1e3 for s in step_s],
        "step_ms_mean": step_mean * 1e3, "tokens_per_s": tokens_per_s,
        "model_flop_share": tokens_per_s * flops_per_token / BF16_FLOPS,
        "model_flop_share_fp8_peak": tokens_per_s * flops_per_token / FP8_FLOPS,
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


def fp8_vs_bf16_phase(torch, llama, seed: int, card: str) -> dict:
    """At 2 layers, one step's loss and gradients (before the update) with
    every projection in fp8 against bf16, on the same params and batch."""
    from accelerate_tpu_torch.ops.fp8 import fp8_matmuls
    from accelerate_tpu_torch.utils.dataclasses import MixedPrecisionPolicy

    cfg = llama.LlamaConfig.llama3_8b(
        n_layers=2, remat=True, remat_policy="attn_and_outputs", attention_impl="flash")
    acc, state, batch = train_setup(torch, llama, cfg, seed)
    policy = MixedPrecisionPolicy.from_precision("bf16")
    leaves = [p for p in state.leaves() if p.requires_grad]
    results = {}
    for name in ("fp8", "bf16"):
        for p in leaves:
            p.grad = None
        with fp8_matmuls(name == "fp8"):
            loss = llama.loss_fn(policy.cast_for_compute(state.params), batch, cfg).float()
            loss.backward()
        results[name] = (loss.item(), [p.grad.clone() for p in leaves])
    (l8, g8), (lb, gb) = results["fp8"], results["bf16"]
    names = list(llama.flatten(state.params))
    leaf_rel = {n: ((a - b).norm() / b.norm().clamp_min(1e-30)).item() for n, a, b in zip(names, g8, gb)}
    norm8 = torch.linalg.vector_norm(torch.stack([g.norm() for g in g8])).item()
    normb = torch.linalg.vector_norm(torch.stack([g.norm() for g in gb])).item()
    row = {"phase": "fp8_vs_bf16", "n_layers": 2, "card": card, "loss_fp8": l8, "loss_bf16": lb,
           "loss_rel_diff": abs(l8 - lb) / abs(lb), "grad_norm_fp8": norm8, "grad_norm_bf16": normb,
           "grad_norm_ratio": norm8 / normb, "leaf_rel_diff": leaf_rel, "tolerance": FP8_VS_BF16}
    del state, acc, results, g8, gb
    gc.collect()
    torch.cuda.empty_cache()
    lo, hi = FP8_VS_BF16["grad_norm_ratio"]
    if not math.isfinite(l8) or row["loss_rel_diff"] > FP8_VS_BF16["loss_rel"]:
        fail(f"fp8 vs bf16: loss {l8} vs {lb}")
    if not lo <= row["grad_norm_ratio"] <= hi:
        fail(f"fp8 vs bf16: grad norm {norm8} vs {normb}")
    return row


def _host_memory() -> dict:
    """`free -g` of the machine: the pinned moments must fit its RAM."""
    out = subprocess.run(["free", "-g"], capture_output=True, text=True, check=True, timeout=60)
    return {"free_g": out.stdout.strip().splitlines()}


def offload_train_phase(torch, llama, dispatch, seed: int, card: str) -> dict:
    """The train step with the optimizer moments offloaded to pinned host
    memory, at Llama-3-8B width and `OFFLOAD_LAYERS` layers, where the
    device-resident state would not fit the card: launches (every stacked
    leaf once a layer, the others whole), pinned host moments, finite and
    falling loss, step time, the update's time and copy rate, peak device
    memory beside the reckoned device-resident need."""
    from accelerate_tpu_torch import FsdpPlugin, host_offloaded_adamw

    cfg = llama.LlamaConfig.llama3_8b(
        n_layers=OFFLOAD_LAYERS, remat=True, remat_policy="attn_and_outputs", attention_impl="flash"
    )
    host_before = _host_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        acc, state, batch = train_setup(torch, llama, cfg, seed, tx=host_offloaded_adamw(3e-4),
                                        strategy=FsdpPlugin(offload_optimizer=True))
    step = acc.make_train_step(lambda p, b, g: llama.loss_fn(p, b, cfg, g))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    opt = state.opt_state
    moments = [t for st in opt.state.values() for t in (st["mu"], st["nu"])]
    if not opt.offload or not all(t.device.type == "cpu" and t.is_pinned() for t in moments):
        fail("offload: the optimizer moments are not pinned host tensors")
    moment_bytes = sum(t.numel() * t.element_size() for t in moments)
    host_after = _host_memory()

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
    per_step = LLAMA_STACKED_LEAVES * OFFLOAD_LAYERS + (LLAMA_LEAVES - LLAMA_STACKED_LEAVES)
    if launches.get("fused_adamw", 0) != per_step * steps:
        fail(f"offload: fused_adamw launched {launches.get('fused_adamw', 0)} times over {steps} steps, "
             f"expected {per_step} per step")
    for kname, n in (("flash_attention_fwd", 2 * OFFLOAD_LAYERS), ("flash_attention_dq", OFFLOAD_LAYERS),
                     ("flash_attention_dkv", OFFLOAD_LAYERS)):
        if launches.get(kname, 0) != n * steps:
            fail(f"offload: {kname} launched {launches.get(kname, 0)} times, expected {n} per step")
    if not all(math.isfinite(x) for x in losses + grad_norms):
        fail(f"offload: non-finite loss or grad norm {losses} {grad_norms}")
    if not losses[-1] < losses[0]:
        fail(f"offload: loss did not fall on a repeated batch: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # The update alone: host clock and CUDA events around one more step.
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    opt.step()
    end.record()
    torch.cuda.synchronize()
    update_host_ms = (time.perf_counter() - t0) * 1e3
    update_ms = start.elapsed_time(end)

    n_params = cfg.param_count()
    shapes = [(name, p) for p, name in opt.leaves()]
    stacked_slice = max(p[0].numel() for name, p in shapes if name.startswith("blocks."))
    whole = max(p.numel() for name, p in shapes if not name.startswith("blocks."))
    slot_bytes = 2 * moments[0].element_size() * (3 * stacked_slice + whole)
    step_mean = sum(step_s[1:]) / TRAIN_STEPS
    tokens_per_s = TRAIN_BATCH * (TRAIN_SEQ - 1) / step_mean
    flops_per_token = 6.0 * n_params + 6.0 * cfg.n_layers * cfg.d_model * TRAIN_SEQ
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    # Device-resident: 16 B a param, the offloaded run's 8 (masters and
    # gradients) plus the moments' 8, and the rest as this run measured it.
    need_gb = peak_gb + moment_bytes / 1e9
    host_stats = {k: v for k, v in torch.cuda.host_memory_stats().items()
                  if "bytes" in k and (k.endswith(".current") or k.endswith(".peak"))}
    row = {
        "phase": "offload_train", "model": "llama3-8b", "n_layers": cfg.n_layers, "params": n_params,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "card": card, "setup_s": setup_s,
        "host_memory_before": host_before, "host_memory_after": host_after,
        "warnings": [str(w.message) for w in caught],
        "moments_pinned_gb": moment_bytes / 1e9, "pinned_host_allocator": host_stats,
        "losses": losses, "grad_norms": grad_norms, "step_ms": [x * 1e3 for x in step_s],
        "step_ms_mean": step_mean * 1e3, "tokens_per_s": tokens_per_s,
        "model_flop_share": tokens_per_s * flops_per_token / BF16_FLOPS,
        "update_ms": update_ms, "update_host_ms": update_host_ms,
        "update_share_of_step": update_ms / (step_mean * 1e3),
        "h2d_bytes_per_step": moment_bytes, "d2h_bytes_per_step": moment_bytes,
        "h2d_gb_per_s_each_way": moment_bytes / update_ms / 1e6,
        "peak_memory_gb": peak_gb, "slot_gb": slot_bytes / 1e9,
        "device_resident_need_gb": need_gb, "card_memory_gb": card_gb,
        "device_resident_exceeds_card": need_gb > card_gb,
        "launches": launches, "fused_adamw_per_step": launches["fused_adamw"] / steps,
    }
    del state, acc, step, batch, opt, moments
    gc.collect()
    torch.cuda.empty_cache()
    return row


def offload_parity_phase(torch, llama, dispatch, seed: int, card: str) -> dict:
    """At Llama-3-8B width and `PARITY_LAYERS` layers, `PARITY_STEPS`
    steps with the moments offloaded and as many device-resident, from the
    same params and batch: the same kernel on the same elements, so the
    final params and moments must be bit-identical."""
    from accelerate_tpu_torch import FsdpPlugin, host_offloaded_adamw

    cfg = llama.LlamaConfig.llama3_8b(
        n_layers=PARITY_LAYERS, remat=True, remat_policy="attn_and_outputs", attention_impl="flash"
    )
    runs = {}
    for offload in (False, True):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the unstacked-moments warning (embed, lm_head)
            acc, state, batch = train_setup(torch, llama, cfg, seed, tx=host_offloaded_adamw(3e-4),
                                            strategy=FsdpPlugin(offload_optimizer=offload))
        step = acc.make_train_step(lambda p, b, g: llama.loss_fn(p, b, cfg, g))
        dispatch.reset_launch_counts()
        losses = []
        for _ in range(PARITY_STEPS):
            state, metrics = step(state, batch)
            losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        launches = dispatch.launch_counts()["fused_adamw"]
        per_step = LLAMA_STACKED_LEAVES * PARITY_LAYERS + 3 if offload else LLAMA_LEAVES
        if launches != per_step * PARITY_STEPS:
            fail(f"offload parity: fused_adamw launched {launches} times, expected {per_step} a step")
        for p in state.leaves():
            p.grad = None
        runs[offload] = (state, losses, launches)
        del acc, step, batch
        gc.collect()
        torch.cuda.empty_cache()
    (dev, dev_losses, dev_launches), (off, off_losses, off_launches) = runs[False], runs[True]
    differ = []
    for (name, a), b in zip(llama.flatten(dev.params).items(), llama.flatten(off.params).values()):
        if not torch.equal(a, b):
            differ.append(name)
        for m in ("mu", "nu"):
            if not torch.equal(dev.opt_state.state[a][m], off.opt_state.state[b][m].to(DEVICE)):
                differ.append(f"{name}.{m}")
    row = {"phase": "offload_parity", "n_layers": PARITY_LAYERS, "steps": PARITY_STEPS, "card": card,
           "losses_device_resident": dev_losses, "losses_offloaded": off_losses,
           "fused_adamw_launches": {"device_resident": dev_launches, "offloaded": off_launches},
           "bit_identical": not differ, "differ": differ}
    del runs, dev, off
    gc.collect()
    torch.cuda.empty_cache()
    if differ:
        fail(f"offload parity: offloaded and device-resident differ in {differ}")
    return row


def _timed(torch, fn, reps: int = 3):
    """(last output, host ms of each of ``reps`` calls after one warm-up),
    each call ending in a synchronize."""
    out = fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times


def int8_prefill_phase(torch, llama, dispatch, cfg, params, seed: int, card: str) -> dict:
    """Llama-3-8B quantized to int8 weights on the card: a (4, 512) prefill
    under `int8_compute` (224 int8_matmul launches) against the dequantize
    path and the bf16 weights, then 16 greedy tokens through flash-decode
    on the dequantize path."""
    from accelerate_tpu_torch.generation import GenerationConfig
    from accelerate_tpu_torch.ops.int8 import int8_compute
    from accelerate_tpu_torch.utils.quantization import quantize_pytree, quantized_nbytes

    t0 = time.perf_counter()
    qparams = quantize_pytree(params, bits=8)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 4)
    tokens = torch.randint(0, cfg.vocab_size, PREFILL_BATCH, generator=gen, device=DEVICE)
    with torch.no_grad():
        with int8_compute():
            dispatch.reset_launch_counts()
            int8_logits = llama.forward(qparams, tokens, cfg)
            torch.cuda.synchronize()
            launches = dispatch.launch_counts()["int8_matmul"]
            if launches != 7 * cfg.n_layers:
                fail(f"int8 prefill: int8_matmul launched {launches} times, expected {7 * cfg.n_layers}")
            int8_logits, int8_ms = _timed(torch, lambda: llama.forward(qparams, tokens, cfg))
        deq_logits, deq_ms = _timed(torch, lambda: llama.forward(qparams, tokens, cfg))
        bf16_logits, bf16_ms = _timed(torch, lambda: llama.forward(params, tokens, cfg))
    shape = (*PREFILL_BATCH, cfg.vocab_size)
    for name, lg in (("int8", int8_logits), ("dequantize", deq_logits), ("bf16", bf16_logits)):
        if tuple(lg.shape) != shape or not torch.isfinite(lg).all():
            fail(f"int8 prefill: {name} logits {tuple(lg.shape)} not finite or misshapen")
    a, b = int8_logits.float(), deq_logits.float()
    agree = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    rms_drift = ((a - b).square().mean().sqrt() / b.square().mean().sqrt()).item()
    max_drift = ((a - b).abs().max() / b.abs().max()).item()
    bf16_agree = (b.argmax(-1) == bf16_logits.float().argmax(-1)).float().mean().item()
    del a, b, int8_logits, deq_logits, bf16_logits
    if not rms_drift <= INT8_VS_DEQUANT["rms_drift"] or not agree >= INT8_VS_DEQUANT["argmax_agree"]:
        fail(f"int8 prefill vs the dequantize path: rms drift {rms_drift}, argmax agreement {agree}")

    prompt = tokens[:, :64]
    dispatch.reset_launch_counts()
    out = llama.generate(qparams, prompt, cfg, generation_config=GenerationConfig(max_new_tokens=PREFILL_NEW_TOKENS))
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    decode_steps = PREFILL_NEW_TOKENS - 1
    if counts["flash_decode"] != decode_steps * cfg.n_layers or counts["int8_matmul"] != 0:
        fail(f"quantized generate: launches {counts}, expected flash_decode {decode_steps * cfg.n_layers}")
    new = out[:, prompt.shape[1]:]
    if tuple(out.shape) != (PREFILL_BATCH[0], 64 + PREFILL_NEW_TOKENS) or not (
            (new >= 0) & (new < cfg.vocab_size)).all():
        fail(f"quantized generate: output {tuple(out.shape)} or token ids out of range")
    blocks_bytes = {"bf16": quantized_nbytes(params["blocks"]), "int8": quantized_nbytes(qparams["blocks"])}
    row = {
        "phase": "int8_prefill", "model": "llama3-8b", "card": card, "batch": list(PREFILL_BATCH),
        "quantize_s": quantize_s, "int8_matmul_launches": launches,
        "int8_forward_ms": int8_ms, "dequantize_forward_ms": deq_ms, "bf16_forward_ms": bf16_ms,
        "int8_forward_ms_mean": sum(int8_ms) / len(int8_ms),
        "dequantize_forward_ms_mean": sum(deq_ms) / len(deq_ms),
        "bf16_forward_ms_mean": sum(bf16_ms) / len(bf16_ms),
        "weight_bytes": {"bf16": quantized_nbytes(params), "int8": quantized_nbytes(qparams)},
        "block_weight_bytes": blocks_bytes,
        "argmax_agree_int8_vs_dequantize": agree, "rms_drift": rms_drift, "max_drift": max_drift,
        "argmax_agree_dequantize_vs_bf16": bf16_agree, "tolerance": INT8_VS_DEQUANT,
        "generate_new_tokens": PREFILL_NEW_TOKENS, "generate_launches": counts,
    }
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
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
    quant_rows = {(r["kernel"], r["case"]): r for r in quant_kernel_phase(torch, card, args.seed)}
    adamw_rows = adamw_kernel_phase(torch, card, args.seed)
    emit(kv_scale_phase(torch, layers, args.seed, card))

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
    prefill_row = int8_prefill_phase(torch, llama, dispatch, cfg, params, args.seed, card)
    emit(prefill_row)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    train_row = train_phase(torch, llama, dispatch, args.seed, card)
    emit(train_row)
    fused_row = train_phase(torch, llama, dispatch, args.seed, card, optimizer="host_offloaded_adamw")
    fused_row["foreach"] = {k: train_row[k] for k in (
        "step_ms_mean", "tokens_per_s", "model_flop_share", "peak_memory_gb", "adamw_ms", "losses")}
    fused_row["loss_rel_diff"] = [abs(a - b) / abs(b) for a, b in zip(fused_row["losses"], train_row["losses"])]
    emit(fused_row)
    if not max(fused_row["loss_rel_diff"]) <= FUSED_VS_FOREACH_LOSS:
        fail(f"fused AdamW vs foreach: losses {fused_row['losses']} vs {train_row['losses']}")
    emit(flash_vs_dot_phase(torch, llama, args.seed, card))
    fp8_row = train_phase(torch, llama, dispatch, args.seed, card, precision="fp8")
    fp8_row["bf16"] = {k: train_row[k] for k in (
        "step_ms_mean", "tokens_per_s", "model_flop_share", "peak_memory_gb", "losses")}
    emit(fp8_row)
    emit(fp8_vs_bf16_phase(torch, llama, args.seed, card))
    offload_row = offload_train_phase(torch, llama, dispatch, args.seed, card)
    emit(offload_row)
    emit(offload_parity_phase(torch, llama, dispatch, args.seed, card))

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
    # The quantized kernels at the main paths' largest products: the gate/up
    # projection (C 4096, N 14336) of the int8 prefill (M 2048) and of the
    # fp8 train step's forward (M 4096).
    for kname, case, replaces, launches in (
        ("int8_matmul", "gate_up", "accelerate_tpu/native/pallas/quant_matmul.py:190",
         prefill_row["int8_matmul_launches"]),
        ("fp8_matmul", "gate_up_fwd", "accelerate_tpu/native/pallas/quant_matmul.py:225",
         fp8_row["launches"]["fp8_matmul"]),
    ):
        q = quant_rows[(kname, case)]
        kernels.append({
            "name": kname, "route": "cuda", "source": "accelerate_tpu_torch/native/csrc/quant_matmul.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": q["max_abs_err"],
            "ms": q["kernel_ms"], "plain_ms": q["plain_ms"], "bound_ms": q["bound_ms"],
            "bound_by": q["bound_by"], "library_ms": q["library_ms"],
        })
    # Kernel 10 at the device-resident 8-layer step's largest leaf
    # (blocks.mlp.w_gate), in the mode the step uses (the update added
    # into p); launches from that step.
    adamw = adamw_rows["w_gate_8_layers"]
    kernels.append({
        "name": "fused_adamw", "route": "cuda", "source": "accelerate_tpu_torch/native/csrc/fused_adamw.cu",
        "replaces": "accelerate_tpu/native/pallas/fused_adamw.py:129",
        "launches": fused_row["launches"]["fused_adamw"], "max_abs_err": adamw["max_abs_err"],
        "ms": adamw["kernel_ms"], "plain_ms": adamw["plain_ms"], "bound_ms": adamw["bound_ms"],
        "bound_by": adamw["bound_by"], "library_ms": adamw["library_ms"],
    })
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
