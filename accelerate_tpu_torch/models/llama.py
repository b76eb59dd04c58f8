"""Llama-3-style decoder: parameters, KV cache, the cached forward that
serving runs (prefill and decode) and the training forward and loss,
ported from the JAX package's `models/llama.py`.

Parameters keep the JAX layout — a dict whose ``blocks`` leaves are
layer-stacked along a leading ``n_layers`` axis — so `models.convert` is a
checked tree copy. The layer loop is a Python loop over views of those
stacks (JAX scans).

Weight-only int8 / int4 parameters (a tree from
`utils.quantization.quantize_pytree`) run through `forward`,
`forward_with_cache` and `generate`: each layer's quantized nodes are
dequantized to the compute dtype as the layer runs (`_maybe_dequantize`),
or, inside `ops.int8.int8_compute`, passed untouched to the projections,
which contract them through the int8 kernel. ``embed`` and ``lm_head`` stay
full precision; the head is a plain matmul.

Left for later slices, and refused here with NotImplementedError: MoE
blocks, sliding-window attention, ring and ulysses attention, the chunked
LM loss and host/disk-offloaded weights.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..ops.int8 import int8_compute_enabled
from ..utils.environment import resolve_device
from ..utils.quantization import dequantize_pytree, has_quantized
from ..utils.tree import flatten, nest
from .layers import (
    AttentionSpec,
    RopeScaling,
    apply_rope,
    attention_out,
    attention_qkv,
    cache_positions,
    cache_write,
    cached_decode_attention,
    cross_entropy_loss,
    dot_product_attention,
    init_attention,
    init_swiglu,
    normed_qkv,
    quantize_kv,
    remat,
    remat_policy,
    rms_norm,
    rope_frequencies,
    swiglu,
    truncated_normal_init,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    d_ff: int = 14336
    head_dim: int | None = None
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rope_scaling: RopeScaling | None = None
    # Not ported yet: a non-None window or n_experts > 0 raises.
    sliding_window: int | None = None
    norm_eps: float = 1e-5
    # Training (the JAX fields): recompute each block in the backward under
    # `remat_policy` ("nothing" | "dots" | "block_outputs" |
    # "attn_and_outputs"); attention "dot" (plain) or "flash" (the CUDA
    # kernels; "ring" / "ulysses" are not ported and raise); z-loss weight.
    remat: bool = False
    remat_policy: str = "block_outputs"
    attention_impl: str = "dot"
    z_loss: float = 0.0
    # Not ported yet: a non-None chunk size raises.
    loss_chunk_size: int | None = None
    n_experts: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.num_heads

    @property
    def attention_spec(self) -> AttentionSpec:
        return AttentionSpec(self.d_model, self.num_heads, self.num_kv_heads, self.resolved_head_dim)

    @classmethod
    def tiny(cls, **overrides: Any) -> "LlamaConfig":
        """A toy config for tests."""
        defaults = dict(
            vocab_size=256, d_model=64, n_layers=2, num_heads=4, num_kv_heads=2,
            d_ff=128, max_seq_len=128, rope_theta=10000.0,
        )
        defaults.update(overrides)
        return cls(**defaults)

    @classmethod
    def llama3_8b(cls, **overrides: Any) -> "LlamaConfig":
        return cls(**{**dict(
            vocab_size=128256, d_model=4096, n_layers=32, num_heads=32,
            num_kv_heads=8, d_ff=14336, max_seq_len=8192,
        ), **overrides})

    def param_count(self) -> int:
        return sum(int(np.prod(s)) for s in param_shapes(self).values())


def _check_supported(config: LlamaConfig) -> None:
    if config.n_experts:
        raise NotImplementedError("MoE blocks are not ported yet (n_experts > 0)")
    if config.sliding_window is not None:
        raise NotImplementedError("sliding-window attention is not ported yet")
    if config.loss_chunk_size is not None:
        raise NotImplementedError("the chunked LM loss (loss_chunk_size) is not ported yet")
    if config.attention_impl in ("ring", "ulysses"):
        raise NotImplementedError(f"attention_impl={config.attention_impl!r} is not ported yet")
    if config.attention_impl not in ("dot", "flash"):
        raise ValueError(
            f"Unknown attention_impl {config.attention_impl!r}; expected "
            "'dot', 'flash', 'ring', or 'ulysses'"
        )


def param_shapes(config: LlamaConfig) -> dict[str, tuple[int, ...]]:
    """Flat ``"a.b.c" -> shape`` map of every parameter (block leaves carry
    the leading layer axis) — the one layout `init` builds and
    `convert.params_from_jax` checks against."""
    _check_supported(config)
    L, D, F = config.n_layers, config.d_model, config.d_ff
    H, K, h = config.num_heads, config.num_kv_heads, config.resolved_head_dim
    return {
        "embed": (config.vocab_size, D),
        "final_norm": (D,),
        "blocks.attn_norm": (L, D),
        "blocks.mlp_norm": (L, D),
        "blocks.attn.wq": (L, D, H, h),
        "blocks.attn.wk": (L, D, K, h),
        "blocks.attn.wv": (L, D, K, h),
        "blocks.attn.wo": (L, H, h, D),
        "blocks.mlp.w_gate": (L, D, F),
        "blocks.mlp.w_up": (L, D, F),
        "blocks.mlp.w_down": (L, F, D),
        "lm_head": (D, config.vocab_size),
    }


def init_block(generator: torch.Generator, config: LlamaConfig, dtype=torch.float32) -> Params:
    """One layer's parameters (no layer axis). Norm gains start at 0
    (``1 + scale`` convention)."""
    attn = init_attention(generator, config.attention_spec, dtype)
    zeros = torch.zeros((config.d_model,), dtype=dtype, device=generator.device)
    return {
        "attn_norm": zeros,
        "attn": attn,
        "mlp_norm": zeros.clone(),
        "mlp": init_swiglu(generator, config.d_model, config.d_ff, dtype),
    }


def init(
    config: LlamaConfig,
    *,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> Params:
    """Random parameters from ``seed`` on ``device`` (default CUDA), drawn
    one layer at a time into preallocated layer-stacked buffers of
    ``dtype``, so the fp32 draws never exceed one layer (Llama-3-8B in bf16
    peaks at its 16 GB of weights plus one fp32 layer). The draws are not
    JAX's: tests load JAX's weights through `convert.params_from_jax`."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {
        key: torch.empty(shape, dtype=dtype, device=device)
        for key, shape in param_shapes(config).items()
    }
    for i in range(config.n_layers):
        layer = flatten(init_block(gen, config, dtype), "blocks")
        for key, value in layer.items():
            flat[key][i].copy_(value)
    D = config.d_model
    flat["embed"].copy_(truncated_normal_init(gen, (config.vocab_size, D), 1.0, dtype))
    flat["final_norm"].zero_()
    flat["lm_head"].copy_(
        truncated_normal_init(gen, (D, config.vocab_size), 1.0 / np.sqrt(D), dtype)
    )
    return nest(flat)


@functools.lru_cache(maxsize=8)
def _rope_tables(config: LlamaConfig, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    cos, sin = rope_frequencies(
        config.resolved_head_dim, config.max_seq_len, config.rope_theta, config.rope_scaling
    )
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


# ----------------------------------------------------------------- training
def _attention(config: LlamaConfig, q, k, v, mask):
    if config.attention_impl == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True, segment_mask=mask)
    return dot_product_attention(q, k, v, mask=mask, causal=True)


def block_forward(
    block: Params,
    x: torch.Tensor,
    *,
    config: LlamaConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
    mask: torch.Tensor | None,
) -> torch.Tensor:
    """One decoder block. With ``config.remat`` the block recomputes in the
    backward what its `remat_policy` does not keep: it runs as checkpointed
    segments cut after the kept names (``q_rope``/``k_rope``/``v_proj``,
    ``attn_out``, ``ffn_out``), or, for ``"dots"``, as one segment that
    keeps every projection output. Keeping ``q_rope``/``k_rope``/``v_proj``
    leaves the q/k/v projections out of the recompute and only the norm
    before them in it (`layers.normed_qkv`), as in JAX. The flash forward
    kernel re-runs in the backward under every policy (its lse is internal
    to the autograd function, as it is to JAX's custom VJP)."""

    def qkv(x, recompute_norm=False):
        q, k, v = normed_qkv(
            block["attn"], x, block["attn_norm"], config.norm_eps, recompute_norm=recompute_norm
        )
        return apply_rope(q, cos, sin, positions), apply_rope(k, cos, sin, positions), v

    def attn_out(q, k, v):
        return attention_out(block["attn"], _attention(config, q, k, v, mask))

    def attn_branch(x):
        return attn_out(*qkv(x))

    def ffn_out(x):
        return swiglu(block["mlp"], rms_norm(x, block["mlp_norm"], config.norm_eps))

    def whole(x):
        x = x + attn_branch(x)
        return x + ffn_out(x)

    if not config.remat:
        return whole(x)
    keep = remat_policy(config.remat_policy)
    if keep is None:
        return remat(whole, x, keep_matmuls=True)
    if not keep:
        return remat(whole, x)
    if "q_rope" in keep:
        x = x + remat(attn_out, *qkv(x, recompute_norm=True))
    else:
        x = x + remat(attn_branch, x)
    return x + remat(ffn_out, x)


def _unstack(tree: Params, n: int) -> list[Params]:
    """The layer-stacked block params as ``n`` per-layer trees of views, one
    ``unbind`` per leaf (its backward stacks the layers' gradients once,
    where indexing would add a zero-filled full-size gradient per layer)."""
    out: list[Params] = [{} for _ in range(n)]
    for key, value in tree.items():
        parts = _unstack(value, n) if isinstance(value, dict) else value.unbind(0)
        for i in range(n):
            out[i][key] = parts[i]
    return out


def _maybe_dequantize(block: Params, dtype: torch.dtype) -> Params:
    """One layer's quantized nodes dequantized to ``dtype``, so the device
    holds int8 and the products see the compute dtype; inside
    `ops.int8.int8_compute` the nodes pass through untouched (the
    projections contract them through the int8 kernel)."""
    if int8_compute_enabled():
        return block
    return dequantize_pytree(block, dtype)


def forward(
    params: Params,
    tokens: torch.Tensor,
    config: LlamaConfig,
    *,
    positions: torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
    return_hidden: bool = False,
) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab) in the params' dtype, or with
    ``return_hidden`` the final-norm hidden states (B, S, D). ``mask`` is a
    (B, S) padding or (B, S, S) attention mask (it routes flash attention to
    the plain attention, as in JAX)."""
    _check_supported(config)
    B, S = tokens.shape
    if S > config.max_seq_len:
        raise ValueError(f"sequence length {S} exceeds max_seq_len={config.max_seq_len}")
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    cos, sin = _rope_tables(config, tokens.device)
    x = params["embed"][tokens]
    quantized = has_quantized(params["blocks"])
    for block in _unstack(params["blocks"], config.n_layers):
        if quantized:
            block = _maybe_dequantize(block, x.dtype)
        x = block_forward(block, x, config=config, cos=cos, sin=sin, positions=positions, mask=mask)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    if return_hidden:
        return x
    return x @ params["lm_head"].to(x.dtype)


def loss_fn(
    params: Params,
    batch: dict[str, torch.Tensor],
    config: LlamaConfig,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Next-token prediction loss (fp32 scalar). batch: {"input_ids": (B, S)}
    with optional "labels" (already shifted) and "attention_mask". Without
    labels the forward runs at the full S and the last logit is dropped, as
    in JAX. ``generator`` is the step's per-microbatch generator (unused:
    the model draws no random numbers)."""
    tokens = batch["input_ids"]
    labels = batch.get("labels")
    attn_mask = batch.get("attention_mask")
    logits = forward(params, tokens, config, mask=attn_mask)
    if labels is None:
        labels = tokens[:, 1:]
        loss_mask = attn_mask[:, 1:] if attn_mask is not None else None
        logits = logits[:, :-1]
    else:
        loss_mask = attn_mask
    return cross_entropy_loss(logits, labels, mask=loss_mask, z_loss=config.z_loss)


# ---------------------------------------------------------------- KV cache
def init_cache(
    config: LlamaConfig,
    batch_size: int,
    max_len: int,
    dtype: torch.dtype = torch.bfloat16,
    *,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Decode-time KV cache, layer-stacked (L, B, max_len, K, h), on
    ``device`` (default CUDA). ``dtype=torch.int8`` stores K/V quantized
    with per-(token, head) bf16 scales. ``length`` is the host-side cursor:
    an int (the rows share it) or a (B,) int32 tensor on the cache's device
    (per-row cursors, as the serving engine keeps them)."""
    device = resolve_device(device)
    shape = (config.n_layers, batch_size, max_len, config.num_kv_heads, config.resolved_head_dim)
    zeros = lambda s, dt: torch.zeros(s, dtype=dt, device=device)
    if dtype == torch.int8:
        return {
            "k": zeros(shape, torch.int8),
            "v": zeros(shape, torch.int8),
            "k_scale": zeros(shape[:-1], torch.bfloat16),
            "v_scale": zeros(shape[:-1], torch.bfloat16),
            "length": 0,
        }
    return {"k": zeros(shape, dtype), "v": zeros(shape, dtype), "length": 0}


def forward_with_cache(
    params: Params,
    tokens: torch.Tensor,
    cache: dict[str, Any],
    config: LlamaConfig,
) -> tuple[torch.Tensor, dict[str, Any]]:
    """Append ``tokens`` (B, T_new) at ``cache['length']`` and attend over
    everything cached so far. Returns (logits (B, T_new, vocab), cache).

    The cache leaves are updated IN PLACE and returned in a new dict with
    ``length`` advanced by T_new. (JAX keeps two numerically identical
    layouts, a scan carry for long caches and scan xs/ys for short ones;
    here one in-place write per layer serves both.)

    ``cache['length']`` is an int (all rows at one cursor; prefill and the
    fixed-batch generator) or a (B,) int32 tensor (per-row cursors; the
    serving engine's decode step). A decode step (T_new == 1) attends
    through `native.decode_attention.flash_decode` — the CUDA kernel on the
    card — masked by each row's cursor; prefill runs the masked reference
    attention."""
    _check_supported(config)
    B, T_new = tokens.shape
    max_len = cache["k"].shape[2]
    if max_len > config.max_seq_len:
        # Out-of-range rotary positions would index past the table.
        raise ValueError(f"cache length {max_len} exceeds max_seq_len={config.max_seq_len}")
    start = cache["length"]
    if not isinstance(start, torch.Tensor) and not 0 <= start <= max_len - T_new:
        raise ValueError(f"cursor {start} + {T_new} new tokens exceeds the cache's {max_len}")
    positions = cache_positions(start, T_new, B, tokens.device)
    cos, sin = _rope_tables(config, tokens.device)
    int8_kv = cache["k"].dtype == torch.int8

    mask = lengths = None
    if T_new == 1:
        # Valid prefix per row after this step's write.
        lengths = (positions[:, 0] + 1).to(torch.int32)
    else:
        cache_pos = torch.arange(max_len, device=tokens.device)
        mask = cache_pos[None, None, :] <= positions[:, :, None]  # (B, T_new, max_len)

    x = params["embed"][tokens]
    blocks = params["blocks"]
    quantized = has_quantized(blocks)
    for i in range(config.n_layers):
        block = _layer(blocks, i)
        if quantized:
            block = _maybe_dequantize(block, x.dtype)
        h = rms_norm(x, block["attn_norm"], config.norm_eps)
        q, k, v = attention_qkv(block["attn"], h)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        if int8_kv:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            attn = cached_decode_attention(
                q,
                cache_write(cache["k"][i], kq, start),
                cache_write(cache["v"][i], vq, start),
                mask=mask,
                lengths=lengths,
                k_scale=cache_write(cache["k_scale"][i], ks, start),
                v_scale=cache_write(cache["v_scale"][i], vs, start),
            )
        else:
            k_layer = cache_write(cache["k"][i], k, start)
            v_layer = cache_write(cache["v"][i], v, start)
            attn = cached_decode_attention(
                q, k_layer.to(q.dtype), v_layer.to(q.dtype), mask=mask, lengths=lengths
            )
        x = x + attention_out(block["attn"], attn)
        h = rms_norm(x, block["mlp_norm"], config.norm_eps)
        x = x + swiglu(block["mlp"], h)
    x = rms_norm(x, params["final_norm"], config.norm_eps)
    logits = x @ params["lm_head"].to(x.dtype)
    return logits, dict(cache, length=start + T_new)


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of the stacked block params, as views."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def generate(
    params: Params,
    prompt: torch.Tensor,
    config: LlamaConfig,
    *,
    generation_config: Any = None,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Autoregressive generation for this family on ``prompt``'s device:
    (B, S) int -> (B, S + max_new_tokens)."""
    from ..generation import GenerationConfig, Generator, cache_dtype

    gcfg = generation_config or GenerationConfig()
    total = prompt.shape[1] + gcfg.max_new_tokens
    if total > config.max_seq_len:
        raise ValueError(
            f"prompt ({prompt.shape[1]}) + max_new_tokens ({gcfg.max_new_tokens}) "
            f"= {total} exceeds max_seq_len={config.max_seq_len}"
        )
    gen = Generator(
        lambda p, t, c: forward_with_cache(p, t, c, config),
        lambda b, m: init_cache(config, b, m, cache_dtype(gcfg), device=prompt.device),
        gcfg,
    )
    return gen(params, prompt, generator=generator)
