"""Iteration-level continuous-batching serving engine, ported from the JAX
package's `serving/engine.py`.

- The KV cache is a fixed pool of ``slots`` (batch rows of one slot-batched
  family cache). Requests are admitted into free slots and evicted on EOS,
  a stop sequence or their token budget.
- Per-slot length cursors live on the HOST (the scheduler knows them) and
  ship to the device as one (N,) int32 tensor per decode step.
- Prefill is bucketed and chunked: prompts are split into chunks, each
  padded to one of a small set of bucket lengths and computed on one
  slot's cache row (`models.layers.cache_slot_view`, a view, so the forward
  writes straight into the pool). Chunks alternate with decode steps, so a
  long prompt never stalls in-flight decodes.
- One decode step runs over the FULL slot batch every time (free slots
  compute garbage that is never read). Its attention is the flash-decode
  CUDA kernel on the card, masked by each row's cursor.
- The prefix cache keeps committed prompt-prefix KV in a second device
  pool indexed by a host radix tree and serves shared prefixes by copy
  instead of prefill.

Where JAX jits each step and donates the pool, the port runs eagerly and
updates the pool in place. Tokens come back to the host with one ``.cpu()``
per decode block.

Not ported yet (later slices): chaos fault points, the static capacity
check, request-scoped flight tracing, latency histograms beyond the decode
step's, streaming callbacks and detokenization, and the multi-replica
router.

Knobs: ``ATX_SERVE_SLOTS`` / ``ATX_SERVE_BUCKETS`` /
``ATX_SERVE_PREFIX_CACHE`` / ``ATX_SERVE_PREFIX_CACHE_MIB``, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from .. import telemetry as _telemetry
from ..generation import GenerationConfig, warp_logits
from ..models.layers import cache_slot_copy, cache_slot_view, cache_slot_write
from ..utils.environment import get_int_from_env, get_str_from_env, parse_flag_from_env
from .prefix_cache import PrefixCache

__all__ = [
    "Engine",
    "Request",
    "Completion",
    "poisson_trace",
    "shared_prefix_trace",
    "default_buckets",
]

ApplyFn = Callable[[Any, torch.Tensor, Any], tuple[torch.Tensor, Any]]

_DEFAULT_BUCKETS = (32, 64, 128, 256)


def default_buckets() -> tuple[int, ...]:
    """Prefill bucket lengths from ``ATX_SERVE_BUCKETS`` (comma-separated,
    e.g. ``"16,64,256"``), else (32, 64, 128, 256)."""
    raw = get_str_from_env(("ATX_SERVE_BUCKETS",), "")
    if not raw:
        return _DEFAULT_BUCKETS
    try:
        buckets = tuple(sorted({int(x) for x in raw.split(",") if x.strip()}))
    except ValueError:
        raise ValueError(f"ATX_SERVE_BUCKETS={raw!r}: expected comma-separated ints") from None
    if not buckets or buckets[0] <= 0:
        raise ValueError(f"ATX_SERVE_BUCKETS={raw!r}: buckets must be positive")
    return buckets


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival`` is seconds from the trace start
    (`Engine.serve(realtime=True)`); ``seed`` drives the request's own
    sampling stream; ``max_new_tokens=None`` takes the engine config's
    budget; ``stop_sequences`` are token sequences matched host-side
    against the emitted tail."""

    prompt: np.ndarray
    max_new_tokens: int | None = None
    rid: int = -1
    seed: int = 0
    arrival: float | None = None
    stop_sequences: Sequence[Sequence[int]] | None = None


@dataclasses.dataclass
class Completion:
    """A finished request. ``tokens`` is (max_new_tokens,) int32 padded with
    ``pad_token_id`` after the last generated token. Timestamps are
    `time.perf_counter()` values. ``finish_reason``: ``"eos"`` / ``"stop"``
    / ``"length"`` / ``"cancelled"``."""

    rid: int
    prompt: np.ndarray
    tokens: np.ndarray
    n_new: int
    submitted_at: float
    first_token_at: float
    finished_at: float
    finish_reason: str = "length"


class _Slot:
    __slots__ = ("req", "chunks", "cursor", "n_new", "last_token", "out",
                 "first_token_at", "decoding", "pending_copy")

    def __init__(self, req: Request, chunks: list, pad: int, *, matched: int = 0,
                 pending_copy=None) -> None:
        self.req = req
        self.chunks = chunks  # [(padded (1, bucket) np.int32, real_len), ...]
        # KV positions written and committed so far. A prefix-cache hit
        # starts at the match boundary; the pinned source node in
        # ``pending_copy`` is copied into the row right before the first
        # prefill chunk.
        self.cursor = matched
        self.pending_copy = pending_copy  # (CacheNode, matched) | None
        self.n_new = 0
        self.last_token = 0
        self.out = np.full((req.max_new_tokens,), pad, np.int32)
        self.first_token_at = 0.0
        self.decoding = False


def _stream_seed(seed: int, n: int) -> int:
    """Seed of token ``n`` of a request: its stream never depends on which
    other requests share the batch."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(n) & 0xFFFFFFFF)


class Engine:
    """Continuous-batching engine over a family cached forward.

    ``apply_fn(params, tokens, cache) -> (logits, cache)`` and
    ``init_cache_fn(batch, max_len) -> cache`` follow the model-family cache
    contract (`models.llama.forward_with_cache` / ``init_cache``): every
    non-``length`` leaf is a layer-stacked (L, B, T, ...) tensor, and the
    forward updates the leaves in place. The engine runs on the device the
    cache lives on.

    ``max_len`` is the per-slot KV capacity (default ``2 * max(buckets)``);
    ``decode_block`` chains that many decode steps per host sync. While
    both prefill and decode work are pending they alternate, one prefill
    chunk per decode step. ``prefix_cache`` (default on) sizes its pool
    from ``ATX_SERVE_PREFIX_CACHE_MIB`` (default 64 MiB).

    Not thread-safe: one thread drives an engine.
    """

    def __init__(
        self,
        apply_fn: ApplyFn,
        init_cache_fn: Callable[[int, int], Any],
        params: Any,
        config: GenerationConfig | None = None,
        *,
        slots: int | None = None,
        buckets: Sequence[int] | None = None,
        max_len: int | None = None,
        decode_block: int = 1,
        prefix_cache: bool | None = None,
    ) -> None:
        self.config = config or GenerationConfig()
        self.n_slots = slots if slots is not None else get_int_from_env(("ATX_SERVE_SLOTS",), 8)
        if self.n_slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.n_slots}")
        self.buckets = tuple(sorted(set(buckets))) if buckets else default_buckets()
        if self.buckets[0] <= 0:
            raise ValueError(f"buckets must be positive, got {self.buckets}")
        self.max_len = max_len if max_len is not None else 2 * self.buckets[-1]
        self.decode_block = max(1, decode_block)
        self.apply_fn = apply_fn
        self.params = params
        cache = init_cache_fn(self.n_slots, self.max_len)
        self._kv = {k: v for k, v in cache.items() if k != "length"}
        self.device = next(iter(self._kv.values())).device

        enabled = (
            parse_flag_from_env("ATX_SERVE_PREFIX_CACHE", True)
            if prefix_cache is None
            else prefix_cache
        )
        self.prefix_cache: PrefixCache | None = None
        self._pool: dict[str, torch.Tensor] | None = None
        if enabled:
            mib = get_int_from_env(("ATX_SERVE_PREFIX_CACHE_MIB",), 64)
            row_bytes = sum(v.numel() * v.element_size() for v in self._kv.values()) // self.n_slots
            rows = min(int(mib * 2**20 // max(row_bytes, 1)), 1024)  # bound host bookkeeping
            if rows >= 1:
                pool = init_cache_fn(rows, self.max_len)
                self._pool = {k: v for k, v in pool.items() if k != "length"}
                self.prefix_cache = PrefixCache(rows, self.buckets, self.max_len)

        self._queue: deque[Request] = deque()
        self._slots: list[_Slot | None] = [None] * self.n_slots
        self._free: deque[int] = deque(range(self.n_slots))
        self._prefill_order: deque[int] = deque()  # slots with pending chunks
        self._prefill_next = True  # alternate while both kinds of work pend
        self._next_rid = 0
        # decode_slot_steps sums active rows over decode steps;
        # prefill_tokens_saved counts prompt tokens served by KV copy.
        self.stats = _telemetry.StatsView(
            "serve",
            (
                "admitted", "completed", "prefill_chunks", "decode_steps",
                "decode_slot_steps", "prompt_tokens", "prefix_hits",
                "prefill_tokens_saved", "prefix_copy_chunks", "prefix_promotions",
                "cancelled",
            ),
            label="engine",
        )
        # Wall time of each decode step, its token fetch included: with
        # decode_slot_steps, the decode rate (`chip_smoke.py`).
        self._h_decode_ms = _telemetry.histogram(
            "serve_decode_step_ms",
            "wall per decode scheduler step (includes the token fetch sync)",
            labels=("engine",),
        )

    # ------------------------------------------------------------- submit
    def submit(
        self,
        prompt: Any,
        max_new_tokens: int | None = None,
        *,
        seed: int = 0,
        arrival: float | None = None,
        stop_sequences: Sequence[Sequence[int]] | None = None,
    ) -> int:
        """Queue one request; returns its id."""
        req = Request(
            prompt=np.asarray(prompt, np.int32).reshape(-1),
            max_new_tokens=max_new_tokens,
            seed=seed,
            arrival=arrival,
            stop_sequences=stop_sequences,
        )
        return self.submit_request(req)

    def validate_request(self, req: Request) -> Request:
        """Resolve per-request defaults and check the request fits this
        engine, without queueing it (raises ValueError)."""
        if req.max_new_tokens is None:
            req.max_new_tokens = self.config.max_new_tokens
        if req.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        if req.stop_sequences is not None:
            req.stop_sequences = tuple(tuple(int(t) for t in seq) for seq in req.stop_sequences)
            if any(len(seq) == 0 for seq in req.stop_sequences):
                raise ValueError("empty stop sequence")
        S = int(req.prompt.shape[0])
        if S < 1:
            raise ValueError("empty prompt")
        if S + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({S}) + max_new_tokens ({req.max_new_tokens}) exceeds "
                f"the engine's per-slot KV capacity max_len={self.max_len}"
            )
        # Every prefill chunk writes a full BUCKET of positions (pad tail
        # included), so the padded plan must fit max_len too.
        self._chunk_plan(req.prompt)
        return req

    def submit_request(self, req: Request) -> int:
        self.validate_request(req)
        if req.rid < 0:
            req.rid = self._next_rid
        self._next_rid = max(self._next_rid, req.rid) + 1
        req.submitted_at = time.perf_counter()  # type: ignore[attr-defined]
        self._queue.append(req)
        return req.rid

    # ------------------------------------------------------------- cancel
    def cancel(self, rid: int) -> Completion | None:
        """Cancel a queued or in-flight request: a ``"cancelled"``
        `Completion` with whatever was generated, or None for an unknown or
        finished ``rid``. The slot's partial KV is not promoted."""
        for i, req in enumerate(self._queue):
            if req.rid == rid:
                del self._queue[i]
                self.stats["cancelled"] += 1
                pad = np.full((req.max_new_tokens,), self.config.pad_token_id, np.int32)
                return self._cancelled_completion(req, pad, 0, 0.0)
        for slot_id, slot in enumerate(self._slots):
            if slot is not None and slot.req.rid == rid:
                if slot.pending_copy is not None:
                    self.prefix_cache.release(slot.pending_copy[0])
                    slot.pending_copy = None
                if slot_id in self._prefill_order:
                    self._prefill_order.remove(slot_id)
                # The next occupant's first prefill chunk overwrites the row
                # from cursor 0.
                self._slots[slot_id] = None
                self._free.append(slot_id)
                self.stats["cancelled"] += 1
                return self._cancelled_completion(
                    slot.req, slot.out, slot.n_new, slot.first_token_at
                )
        return None

    def _cancelled_completion(
        self, req: Request, tokens: np.ndarray, n_new: int, first_token_at: float
    ) -> Completion:
        return Completion(
            rid=req.rid,
            prompt=req.prompt,
            tokens=tokens,
            n_new=n_new,
            submitted_at=getattr(req, "submitted_at", 0.0),
            first_token_at=first_token_at,
            finished_at=time.perf_counter(),
            finish_reason="cancelled",
        )

    # ---------------------------------------------------------- scheduler
    @property
    def busy(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def _chunk_plan(self, prompt: np.ndarray, start: int = 0) -> list[tuple[np.ndarray, int]]:
        """Bucket-padded prefill chunks for ``prompt[start:]`` (``start`` is
        the prefix-cache match boundary)."""
        chunks = []
        pos, S = start, len(prompt)
        while pos < S:
            rem = S - pos
            bucket = self.buckets[-1] if rem > self.buckets[-1] else min(
                b for b in self.buckets if b >= rem
            )
            real = min(rem, bucket)
            if pos + bucket > self.max_len:
                raise ValueError(
                    f"prompt length {S}: the prefill chunk covering positions "
                    f"[{pos}, {pos + bucket}) (bucket {bucket}, buckets "
                    f"{self.buckets}) pads past the per-slot KV capacity "
                    f"max_len={self.max_len}; raise max_len or add a bucket "
                    f"<= {self.max_len - pos} so bucket-padded prefill fits"
                )
            buf = np.full((1, bucket), self.config.pad_token_id, np.int32)
            buf[0, :real] = prompt[pos : pos + real]
            chunks.append((buf, real))
            pos += real
        return chunks

    def _admit(self) -> None:
        while self._queue and self._free:
            req = self._queue.popleft()
            slot_id = self._free.popleft()
            node, matched = None, 0
            if self.prefix_cache is not None:
                # Leave at least one prompt token to prefill: something has
                # to produce the first sampling logits.
                node, matched = self.prefix_cache.match(req.prompt, limit=len(req.prompt) - 1)
            try:
                chunks = self._chunk_plan(req.prompt, start=matched)
            except ValueError:
                # The match-shifted plan can pad past max_len where the full
                # plan fits: a hit is an optimization, so prefill it all.
                self.prefix_cache.release(node)
                node, matched = None, 0
                chunks = self._chunk_plan(req.prompt)
            self._slots[slot_id] = _Slot(
                req, chunks, self.config.pad_token_id, matched=matched,
                pending_copy=(node, matched) if node is not None else None,
            )
            self._prefill_order.append(slot_id)
            self.stats["admitted"] += 1
            self.stats["prompt_tokens"] += len(req.prompt)
            if matched:
                self.stats["prefix_hits"] += 1
                self.stats["prefill_tokens_saved"] += matched

    @torch.no_grad()
    def step(self) -> list[Completion]:
        """One scheduler iteration: admit what fits, then run EITHER one
        prefill chunk OR one decode block over the slot batch (alternating
        while both are pending). Returns the requests that finished."""
        self._admit()
        decoding = [i for i, s in enumerate(self._slots) if s is not None and s.decoding]
        if self._prefill_order and (not decoding or self._prefill_next):
            self._prefill_next = False
            return self._prefill_step()
        if decoding:
            self._prefill_next = True
            t0 = time.perf_counter()
            out = self._decode_step(decoding)
            self._h_decode_ms.observe((time.perf_counter() - t0) * 1e3, **self.stats.labels)
            return out
        return []

    def run_until_idle(self) -> list[Completion]:
        out: list[Completion] = []
        while self.busy:
            out.extend(self.step())
        return out

    def serve(self, requests: Iterable[Request], *, realtime: bool = False) -> list[Completion]:
        """Drive a whole trace. ``realtime=True`` honours each request's
        ``arrival`` on the wall clock; otherwise requests are submitted in
        arrival order as fast as the engine drains them."""
        reqs = sorted(requests, key=lambda r: (r.arrival or 0.0))
        out: list[Completion] = []
        t0 = time.perf_counter()
        i = 0
        while i < len(reqs) or self.busy:
            if i < len(reqs):
                now = time.perf_counter() - t0
                while i < len(reqs) and (not realtime or (reqs[i].arrival or 0.0) <= now):
                    self.submit_request(reqs[i])
                    i += 1
                if realtime and not self.busy and i < len(reqs):
                    time.sleep(max((reqs[i].arrival or 0.0) - (time.perf_counter() - t0), 0.0))
                    continue
            out.extend(self.step())
        return out

    # ------------------------------------------------------------ actions
    def _sample(self, logits: torch.Tensor, seeds: Sequence[int], steps: Sequence[int]) -> torch.Tensor:
        """(N, V) logits -> (N,) int32 tokens on the device. Token n of a
        request draws from its own generator seeded by (seed, n)."""
        if not self.config.do_sample:
            return logits.argmax(-1).to(torch.int32)
        probs = torch.softmax(warp_logits(logits, self.config), dim=-1)
        out = []
        for row, seed, n in zip(probs, seeds, steps):
            gen = torch.Generator(device=logits.device).manual_seed(_stream_seed(seed, n))
            out.append(torch.multinomial(row, 1, generator=gen))
        return torch.cat(out).to(torch.int32)

    def _prefill_step(self) -> list[Completion]:
        slot_id = self._prefill_order[0]
        slot = self._slots[slot_id]
        if slot.pending_copy is not None:
            # Prefix-cache hit: copy the matched KV span from the pool row
            # into this slot's row before its first prefill chunk (stream
            # order: copy, then the chunk's attention reads it).
            node, matched = slot.pending_copy
            off = 0
            for ln in self.prefix_cache.chunks(matched):
                cache_slot_copy(self._kv, self._pool, slot_id, node.row, off, ln)
                self.stats["prefix_copy_chunks"] += 1
                off += ln
            self.prefix_cache.release(node)
            slot.pending_copy = None
        buf, real = slot.chunks.pop(0)
        row = cache_slot_view(self._kv, slot_id)
        tokens = torch.from_numpy(buf).to(self.device)
        logits, new = self.apply_fn(self.params, tokens, dict(row, length=slot.cursor))
        # A forward that wrote into the view has already updated the pool;
        # cache_slot_write copies only a row that is not that view.
        cache_slot_write(self._kv, {k: new[k] for k in row}, slot_id)
        slot.cursor += real
        self.stats["prefill_chunks"] += 1
        if slot.chunks:
            return []  # more prompt to go
        tok = self._sample(logits[0, real - 1][None], [slot.req.seed], [0])
        tok = int(tok[0])  # the one host sync of a prompt
        self._prefill_order.popleft()
        slot.first_token_at = time.perf_counter()
        slot.decoding = True
        return self._emit(slot_id, tok)

    def _decode_step(self, decoding: list[int]) -> list[Completion]:
        lengths = np.zeros((self.n_slots,), np.int32)
        seeds = np.zeros((self.n_slots,), np.int64)
        steps = np.zeros((self.n_slots,), np.int64)
        tokens = np.zeros((self.n_slots,), np.int32)
        for i, s in enumerate(self._slots):
            if s is None:
                continue  # free slot: garbage write at 0, overwritten on admission
            # Mid-prefill slots ride along: their cursor is the next chunk's
            # start, so the garbage write lands where that chunk overwrites.
            tokens[i] = s.last_token
            lengths[i] = s.cursor
            seeds[i] = s.req.seed
            steps[i] = s.n_new
        # Chain up to decode_block steps, bounded by the smallest remaining
        # budget, then fetch their tokens in one sync. Interleaving wins
        # while prefill work is pending: block = 1.
        block = min(self.decode_block, *(
            self._slots[i].req.max_new_tokens - self._slots[i].n_new for i in decoding
        ))
        if self._prefill_order:
            block = 1
        fetched = []
        tok = torch.from_numpy(tokens).to(self.device)
        for _ in range(block):
            cursors = torch.from_numpy(lengths).to(self.device)
            logits, new = self.apply_fn(self.params, tok[:, None], dict(self._kv, length=cursors))
            self._kv = {k: new[k] for k in self._kv}
            tok = self._sample(logits[:, -1, :], seeds.tolist(), steps.tolist())
            fetched.append(tok)
            lengths[decoding] += 1
            steps[decoding] += 1
        host_tokens = torch.stack(fetched).cpu().numpy()
        self.stats["decode_steps"] += block
        self.stats["decode_slot_steps"] += block * len(decoding)
        out: list[Completion] = []
        for nxt in host_tokens:
            for i in decoding:
                slot = self._slots[i]
                if slot is None or not slot.decoding:
                    continue  # finished mid-block: later tokens are zombies
                slot.cursor += 1
                out.extend(self._emit(i, int(nxt[i])))
        return out

    def _emit(self, slot_id: int, tok: int) -> list[Completion]:
        """Record one generated token; finish and evict on EOS, a stop
        sequence or an exhausted budget."""
        slot = self._slots[slot_id]
        req = slot.req
        slot.out[slot.n_new] = tok
        slot.n_new += 1
        slot.last_token = tok
        eos_hit = self.config.eos_token_id is not None and tok == self.config.eos_token_id
        stop_hit = False
        if req.stop_sequences and not eos_hit:
            for seq in req.stop_sequences:
                n = len(seq)
                if n <= slot.n_new and slot.out[slot.n_new - n : slot.n_new].tolist() == list(seq):
                    stop_hit = True
                    break
        if not eos_hit and not stop_hit and slot.n_new < req.max_new_tokens:
            return []
        completion = Completion(
            rid=req.rid,
            prompt=req.prompt,
            tokens=slot.out,
            n_new=slot.n_new,
            submitted_at=getattr(req, "submitted_at", 0.0),
            first_token_at=slot.first_token_at,
            finished_at=time.perf_counter(),
            finish_reason="eos" if eos_hit else ("stop" if stop_hit else "length"),
        )
        if self.prefix_cache is not None:
            self._promote(slot_id, slot)
        self._slots[slot_id] = None  # evict: the slot is immediately reusable
        self._free.append(slot_id)
        self.stats["completed"] += 1
        return [completion]

    def _promote(self, slot_id: int, slot: _Slot) -> None:
        """Offer an evicted slot's committed prefix (the chunk-aligned front
        of [0, cursor): the prompt plus every generated token whose KV is
        committed) to the prefix cache. The copies are issued before any
        later admission can overwrite the row (stream order)."""
        cached_len = self.prefix_cache.aligned(slot.cursor)
        if cached_len <= 0:
            return
        tokens = slot.req.prompt
        if cached_len > len(tokens):
            tokens = np.concatenate([tokens, slot.out[: cached_len - len(tokens)]])
        else:
            tokens = tokens[:cached_len]
        row = self.prefix_cache.insert(tokens)
        if row is None:
            return
        off = 0
        for ln in self.prefix_cache.chunks(cached_len):
            cache_slot_copy(self._pool, self._kv, row, slot_id, off, ln)
            self.stats["prefix_copy_chunks"] += 1
            off += ln
        self.stats["prefix_promotions"] += 1

    # ------------------------------------------------------------ metrics
    def prefix_metrics(self) -> dict:
        """Prefix-cache counters in reporting shape. ``prefill_saved_frac``
        is the fraction of admitted prompt tokens served by KV copy."""
        if self.prefix_cache is None:
            return {"prefix_cache": 0}
        pc = self.prefix_cache
        return {
            "prefix_cache": 1,
            "prefix_rows": pc.n_rows,
            "prefix_rows_used": pc.used_rows,
            "prefix_hit_rate": round(self.stats["prefix_hits"] / max(pc.stats["lookups"], 1), 3),
            "prefill_tokens_saved": self.stats["prefill_tokens_saved"],
            "prefill_saved_frac": round(
                self.stats["prefill_tokens_saved"] / max(self.stats["prompt_tokens"], 1), 3
            ),
            "prefix_promotions": self.stats["prefix_promotions"],
            "prefix_evictions": pc.stats["evictions"],
        }


def poisson_trace(
    n: int,
    rate: float,
    *,
    vocab_size: int,
    prompt_lens: tuple[int, int] = (8, 96),
    new_tokens: tuple[int, int] = (8, 48),
    seed: int = 0,
) -> list[Request]:
    """Synthetic mixed-length request trace with Poisson arrivals at
    ``rate`` requests/sec (the same draws as the JAX package's, seed for
    seed)."""
    rng = np.random.RandomState(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    reqs = []
    for i in range(n):
        S = int(rng.randint(prompt_lens[0], prompt_lens[1] + 1))
        reqs.append(
            Request(
                prompt=rng.randint(0, vocab_size, (S,)).astype(np.int32),
                max_new_tokens=int(rng.randint(new_tokens[0], new_tokens[1] + 1)),
                rid=i,
                seed=i,
                arrival=float(arrivals[i]),
            )
        )
    return reqs


def shared_prefix_trace(
    n: int,
    rate: float,
    *,
    vocab_size: int,
    n_prefixes: int = 2,
    prefix_len: int = 64,
    tail_lens: tuple[int, int] = (4, 24),
    new_tokens: tuple[int, int] = (4, 16),
    seed: int = 0,
) -> list[Request]:
    """Poisson trace where every prompt is one of ``n_prefixes`` shared
    system prompts (``prefix_len`` tokens) plus a unique tail — the
    workload shape prefix caching targets."""
    rng = np.random.RandomState(seed)
    prefixes = [
        rng.randint(0, vocab_size, (prefix_len,)).astype(np.int32) for _ in range(n_prefixes)
    ]
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    reqs = []
    for i in range(n):
        tail = rng.randint(
            0, vocab_size, (int(rng.randint(tail_lens[0], tail_lens[1] + 1)),)
        ).astype(np.int32)
        reqs.append(
            Request(
                prompt=np.concatenate([prefixes[i % n_prefixes], tail]),
                max_new_tokens=int(rng.randint(new_tokens[0], new_tokens[1] + 1)),
                rid=i,
                seed=i,
                arrival=float(arrivals[i]),
            )
        )
    return reqs
