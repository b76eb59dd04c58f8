"""Continuous-batching micro-server: the port's counterpart of `atx serve`.

Builds a model preset with random weights, replays a Poisson arrival trace
of mixed-length requests through `serving.Engine`, and prints one JSON line
of serving metrics:

    python -m accelerate_tpu_torch.commands.serve --model llama3-8b --slots 8 --requests 64

Runs on the card (``--device cuda``, the default) unless told otherwise;
``--device cpu`` runs the kernels' plain PyTorch versions. Every reported
time is of the device named in the line.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..generation import GenerationConfig, cache_dtype
from ..models import llama
from ..serving import Engine, default_buckets, poisson_trace
from ..utils.environment import resolve_device

MODEL_PRESETS = {
    "llama-tiny": llama.LlamaConfig.tiny,
    "llama3-8b": llama.LlamaConfig.llama3_8b,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m accelerate_tpu_torch.commands.serve",
        description="Continuous-batching serving benchmark (Poisson request trace)",
    )
    p.add_argument("--model", default="llama-tiny", choices=sorted(MODEL_PRESETS))
    p.add_argument("--device", default="cuda", help="cuda (default), cuda:N or cpu")
    p.add_argument("--slots", type=int, default=None, help="KV slot pool size (ATX_SERVE_SLOTS)")
    p.add_argument("--buckets", default=None,
                   help="comma-separated prefill bucket lengths (ATX_SERVE_BUCKETS)")
    p.add_argument("--requests", type=int, default=64)
    p.add_argument("--rate", type=float, default=16.0, help="Poisson arrivals/sec")
    p.add_argument("--prompt-lens", default="8:96", help="min:max prompt length")
    p.add_argument("--new-tokens", default="8:48", help="min:max tokens per request")
    p.add_argument("--kv-cache-dtype", default="bf16", choices=("bf16", "fp32", "int8"))
    p.add_argument("--seed", type=int, default=0, help="seeds the weights and the trace")
    return p


def _span(text: str) -> tuple[int, int]:
    lo, _, hi = text.partition(":")
    return int(lo), int(hi or lo)


def run(args: argparse.Namespace) -> dict:
    """Serve the trace on the preset with random bf16 weights from
    ``--seed`` (throughput is weight-agnostic), each slot sized for the
    trace's longest request; returns the metrics line."""
    device = resolve_device(args.device)
    prompt_lens, new_tokens = _span(args.prompt_lens), _span(args.new_tokens)
    buckets = tuple(int(b) for b in args.buckets.split(",")) if args.buckets else default_buckets()
    # Fit the worst-case request: prompt rounded up to a bucket + budget.
    rounded = min((b for b in buckets if b >= prompt_lens[1]), default=None)
    top = rounded if rounded is not None else -(-prompt_lens[1] // buckets[-1]) * buckets[-1]
    max_len = top + new_tokens[1]
    # The rotary table must cover the slot capacity (llama-tiny's 128 does
    # not cover the default trace).
    preset = MODEL_PRESETS[args.model]
    cfg = preset(max_seq_len=max(preset().max_seq_len, max_len))
    params = llama.init(cfg, seed=args.seed, dtype=torch.bfloat16, device=device)
    gcfg = GenerationConfig(kv_cache_dtype=args.kv_cache_dtype)
    engine = Engine(
        lambda p, t, c: llama.forward_with_cache(p, t, c, cfg),
        lambda b, m: llama.init_cache(cfg, b, m, cache_dtype(gcfg), device=device),
        params,
        gcfg,
        slots=args.slots,
        buckets=buckets,
        max_len=max_len,
    )
    trace = poisson_trace(
        args.requests, args.rate, vocab_size=cfg.vocab_size,
        prompt_lens=prompt_lens, new_tokens=new_tokens, seed=args.seed,
    )
    t0 = time.perf_counter()
    completions = engine.serve(trace)
    wall = time.perf_counter() - t0
    lat_ms = sorted(1e3 * (c.finished_at - c.submitted_at) for c in completions)
    ttft_ms = sorted(1e3 * (c.first_token_at - c.submitted_at) for c in completions)
    pick = lambda xs, q: xs[min(len(xs) - 1, int(q * len(xs)))]
    result = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "model": args.model,
        "kv_cache_dtype": args.kv_cache_dtype,
        "serve_requests": len(completions),
        "serve_tokens_per_sec": sum(c.n_new for c in completions) / wall,
        "serve_wall_s": wall,
        "serve_p50_ms": pick(lat_ms, 0.50),
        "serve_p99_ms": pick(lat_ms, 0.99),
        "serve_ttft_p50_ms": pick(ttft_ms, 0.50),
        "serve_ttft_p99_ms": pick(ttft_ms, 0.99),
        "serve_slots": engine.n_slots,
        "serve_buckets": list(engine.buckets),
        "serve_occupancy": engine.stats["decode_slot_steps"]
        / max(engine.stats["decode_steps"] * engine.n_slots, 1),
    }
    for key, val in engine.prefix_metrics().items():
        result["serve_" + key] = val
    return result


def main(argv: list[str] | None = None) -> int:
    print(json.dumps(run(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
