"""Autoregressive generation over KV caches, ported from the JAX package's
`generation.py`.

PyTorch runs eagerly, so the loop is a plain host loop over a cached
forward that updates the cache in place: one prefill, then one decode step
per token, with the tokens kept on the device until the end. EOS handling
keeps a ``done`` mask (finished rows emit ``pad_token_id``); with an EOS
configured, the loop reads the mask every ``eos_check_every`` steps and
stops once every row is done.

Sampling draws from a ``torch.Generator``. JAX's ``fold_in`` key stream
cannot be reproduced here, so sampled tokens differ from the JAX package's
for the same seed; greedy decoding (the default) is the parity oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

__all__ = [
    "GenerationConfig",
    "Generator",
    "cache_dtype",
    "generate",
    "sample_tokens",
    "warp_logits",
]


@dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    do_sample: bool = False  # False -> greedy argmax
    temperature: float = 1.0
    top_k: int | None = None
    top_p: float | None = None
    eos_token_id: int | None = None
    pad_token_id: int = 0
    # KV cache storage: "bf16" (default), "fp32", or "int8" (per-token-scale
    # quantized: half the cache bytes per decode step).
    kv_cache_dtype: str = "bf16"


def cache_dtype(config: GenerationConfig) -> torch.dtype:
    try:
        return {"bf16": torch.bfloat16, "fp32": torch.float32, "int8": torch.int8}[
            config.kv_cache_dtype
        ]
    except KeyError:
        raise ValueError(
            f"kv_cache_dtype={config.kv_cache_dtype!r}; expected bf16, fp32, or int8."
        ) from None


def warp_logits(logits: torch.Tensor, config: GenerationConfig) -> torch.Tensor:
    """Temperature / top-k / top-p warps of (..., V) logits, in fp32."""
    logits = logits.float()
    if config.temperature != 1.0:
        logits = logits / max(config.temperature, 1e-6)
    if config.top_k is not None:
        kth = torch.topk(logits, config.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if config.top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cumulative = torch.softmax(sorted_logits, dim=-1).cumsum(-1)
        # Keep the smallest prefix with cumulative prob >= top_p (always
        # keeping the most likely token). Where the fp32 cumsum ends below
        # top_p the index is V: JAX's fill-mode gather keeps every token
        # there, and the smallest logit as the cutoff keeps them too.
        cutoff_idx = (cumulative < config.top_p).sum(-1, keepdim=True)
        cutoff_idx = cutoff_idx.clamp_max(logits.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_tokens(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    config: GenerationConfig,
) -> torch.Tensor:
    """Next tokens (B,) int32 from (B, V) logits per the sampling config."""
    if not config.do_sample:
        return logits.argmax(-1).to(torch.int32)
    probs = torch.softmax(warp_logits(logits, config), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


class Generator:
    """Reusable generation harness over ``apply_fn(params, tokens, cache) ->
    (logits, cache)`` (e.g. `models.llama.forward_with_cache`) and
    ``init_cache_fn(batch_size, max_len)``."""

    def __init__(
        self,
        apply_fn: Callable[[Any, torch.Tensor, Any], tuple[torch.Tensor, Any]],
        init_cache_fn: Callable[[int, int], Any],
        config: GenerationConfig | None = None,
        *,
        eos_check_every: int = 8,
    ) -> None:
        self.apply_fn = apply_fn
        self.init_cache_fn = init_cache_fn
        self.config = config or GenerationConfig()
        self.eos_check_every = max(1, eos_check_every)

    def _step(self, params, tokens, cache, generator, done):
        cfg = self.config
        logits, cache = self.apply_fn(params, tokens, cache)
        nxt = sample_tokens(logits[:, -1, :], generator, cfg)
        if cfg.eos_token_id is not None:
            nxt = torch.where(done, cfg.pad_token_id, nxt).to(torch.int32)
            done = done | (nxt == cfg.eos_token_id)
        return nxt, cache, done

    @torch.no_grad()
    def __call__(
        self,
        params: Any,
        prompt: torch.Tensor,
        *,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """(B, S_prompt) int -> (B, S_prompt + max_new_tokens) int32 on the
        prompt's device; rows that hit EOS are padded."""
        cfg = self.config
        prompt = prompt.to(torch.int32)
        if cfg.max_new_tokens <= 0:
            return prompt
        B, S = prompt.shape
        cache = self.init_cache_fn(B, S + cfg.max_new_tokens)
        done = torch.zeros((B,), dtype=torch.bool, device=prompt.device)
        token, cache, done = self._step(params, prompt, cache, generator, done)
        tokens = [token]
        n_rest = cfg.max_new_tokens - 1
        ran = 0
        while ran < n_rest:
            if cfg.eos_token_id is not None and bool(done.all()):
                break
            for _ in range(min(self.eos_check_every, n_rest - ran)):
                token, cache, done = self._step(params, token[:, None], cache, generator, done)
                tokens.append(token)
                ran += 1
        if ran < n_rest:
            # Every row is done: the skipped steps would each emit pure pad.
            pad = torch.full((B,), cfg.pad_token_id, dtype=torch.int32, device=prompt.device)
            tokens.extend([pad] * (n_rest - ran))
        return torch.cat([prompt] + [t[:, None] for t in tokens], dim=1)


def generate(
    params: Any,
    prompt: torch.Tensor,
    *,
    apply_fn: Callable[[Any, torch.Tensor, Any], tuple[torch.Tensor, Any]],
    init_cache_fn: Callable[[int, int], Any],
    config: GenerationConfig | None = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """One-shot convenience over `Generator`."""
    return Generator(apply_fn, init_cache_fn, config)(params, prompt, generator=generator)
