"""Shared building blocks of the decoder's forward (cached and training), as
plain functions over tensors and parameter dicts.

This is the subset of the JAX package's `models/layers.py` that the serving
and training paths run, with its tensor layouts kept at every public
function so the two can be compared like with like: activations
(B, S, H, h), caches layer-stacked (L, B, T, ...), attention weights
wq/wk/wv (D, heads, h) and wo (H, h, D).

Where JAX returns an updated copy (its arrays are immutable and the cache
is donated), the port updates the cache IN PLACE and returns the same
tensor: `cache_write`, `cache_write_stacked`, `cache_slot_write` and
`cache_slot_copy` all write into their first argument, and
`cache_slot_view` returns views, so a forward over a slot view writes
straight into the slot pool.

Every projection (`attention_qkv`, `normed_qkv`, `attention_out`,
`swiglu`) routes through `ops.fp8.matmul_einsum` under the fp8 mode or for
a quantized weight node, as the JAX layers do. Outside both it stays the
one ``x @ w`` it was, with no einsum parsing (the serving loop is
host-bound, so host work per projection counts).

Conventions: ``B`` batch, ``S`` sequence, ``D`` model dim, ``H`` heads,
``K`` kv-heads, ``h`` head dim, ``F`` ff dim, ``L`` layers.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..native.decode_attention import flash_decode
from ..native.quant_matmul import scaled_matmul
from ..ops.fp8 import E4M3, E5M2, _grad_equations, count_hit, fp8_enabled, fp8_mode, matmul_einsum, quantize

Params = dict[str, Any]
_NEG_INF = -1e30


def truncated_normal_init(
    generator: torch.Generator,
    shape: tuple[int, ...],
    stddev: float,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Normal draws truncated to [-2, 2], cast to ``dtype``, times ``stddev``
    (the JAX recipe). Made on the generator's device, in fp32 first."""
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out.to(dtype) * stddev


# --------------------------------------------------------------------- remat
# The checkpoint names each policy keeps (the JAX `save_only_these_names`
# sets): a block remats as checkpointed segments cut right after each kept
# name, so exactly those tensors (plus the block input, the JAX scan carry)
# survive the forward.
_REMAT_NAMES = {
    "nothing": frozenset(),
    "block_outputs": frozenset({"attn_out", "ffn_out"}),
    "attn_and_outputs": frozenset({"attn_out", "ffn_out", "q_rope", "k_rope", "v_proj"}),
}
_MATMULS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _keep_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(name: str) -> frozenset[str] | None:
    """Resolve a remat-policy name (the JAX package's four) to the
    checkpoint names its block keeps; None for ``"dots"``, which keeps every
    matmul output without batch dims (the projections, not the attention
    products) through a selective-checkpoint context (`remat`)."""
    if name == "dots":
        return None
    if name not in _REMAT_NAMES:
        raise ValueError(
            f"Unknown remat_policy {name!r}; expected 'nothing', 'dots', "
            "'block_outputs', or 'attn_and_outputs'"
        )
    return _REMAT_NAMES[name]


def _in_fp8_mode(fn: Callable, *args):
    with fp8_mode(True):
        return fn(*args)


def remat(fn: Callable, *args, keep_matmuls: bool = False):
    """``fn(*args)`` under `torch.utils.checkpoint` (non-reentrant): only
    ``args`` are kept and the rest is recomputed in the backward, or, with
    ``keep_matmuls``, every ``mm``/``addmm`` output is kept too. The blocks
    draw no random numbers, so the RNG state is not stashed.

    Under fp8 the recompute re-enters the fp8 mode, whenever the backward
    runs: it must repeat the forward's fp8 products, not bf16 ones. The fp8
    products are opaque kernel calls that ``keep_matmuls`` cannot keep, so
    fp8 with the "dots" policy raises."""
    kwargs = {}
    if fp8_enabled():
        if keep_matmuls:
            raise NotImplementedError(
                "remat_policy='dots' keeps mm/addmm outputs, and the fp8 products are "
                "kernel calls it does not see; use 'attn_and_outputs', 'block_outputs' "
                "or 'nothing' under mixed_precision='fp8'"
            )
        fn = functools.partial(_in_fp8_mode, fn)
    if keep_matmuls:
        kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _keep_matmuls)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 whatever the input dtype, with a ``1 + scale`` gain."""
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * (1.0 + scale.float())).to(dtype)


# ------------------------------------------------------------------ kv cache
def cache_positions(start, t_new: int, batch: int, device=None) -> torch.Tensor:
    """(B, T_new) int64 positions for tokens appended at ``start``: an int
    (every row appends at one offset) or a (B,) tensor (per-row cursors)."""
    if isinstance(start, torch.Tensor) and start.ndim == 1:
        offs = torch.arange(t_new, device=start.device)
        return start.long()[:, None] + offs[None, :]
    start = int(start)
    return torch.arange(start, start + t_new, device=device)[None, :].expand(batch, t_new)


def cache_write(buf: torch.Tensor, new: torch.Tensor, start) -> torch.Tensor:
    """Write ``new`` (B, T, ...) into ``buf`` (B, S, ...) at ``start`` along
    the sequence dim, in place; returns ``buf``.

    ``start`` is an int (one slice assignment) or a (B,) tensor of per-row
    offsets (one indexed assignment). Like JAX's ``dynamic_update_slice``
    the offset is clamped so the whole update lands inside ``buf``."""
    S, T = buf.shape[1], new.shape[1]
    new = new.to(buf.dtype)
    if isinstance(start, torch.Tensor) and start.ndim == 1:
        rows = start.long().clamp(0, S - T)[:, None] + torch.arange(T, device=buf.device)
        buf[torch.arange(buf.shape[0], device=buf.device)[:, None], rows] = new
        return buf
    s = min(max(int(start), 0), S - T)
    buf[:, s : s + T] = new
    return buf


def cache_write_stacked(
    all_buf: torch.Tensor, i: int, rows: torch.Tensor, start
) -> tuple[torch.Tensor, torch.Tensor]:
    """Write ``rows`` into layer ``i`` of a layer-stacked (L, B, S, ...)
    cache in place. Returns (the stacked buffer, the layer view)."""
    layer = all_buf[i]
    cache_write(layer, rows, start)
    return all_buf, layer


def cache_slot_view(kv: Params, slot: int) -> Params:
    """One slot row (batch axis 1) of every layer-stacked leaf, as views:
    a forward that writes into the view writes into the slot pool."""
    return {name: a[:, slot : slot + 1] for name, a in kv.items()}


def _same_view(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (
        a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.stride() == b.stride()
    )


def cache_slot_write(kv: Params, row: Params, slot: int) -> Params:
    """Write a batch-1 cache row back into slot ``slot`` in place. A row that
    is still the `cache_slot_view` of this slot is already there."""
    for name, a in kv.items():
        dst = a[:, slot : slot + 1]
        if not _same_view(dst, row[name]):
            dst.copy_(row[name])
    return kv


def cache_slot_copy(
    dst: Params, src: Params, dst_slot: int, src_slot: int, start: int, length: int
) -> Params:
    """Copy ``length`` committed positions from row ``src_slot`` of ``src``
    into row ``dst_slot`` of ``dst`` at the same offset ``start`` (rotary
    encoding is baked into cached K, so KV is only reusable at its own
    position), for every layer-stacked leaf, in place. ``dst`` and ``src``
    are distinct pools (prefix pool and slot pool), so the copy never
    aliases."""
    for name, d in dst.items():
        d[:, dst_slot, start : start + length].copy_(
            src[name][:, src_slot, start : start + length]
        )
    return dst


# ---------------------------------------------------------------------- rope
@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Rotary-frequency rescaling (HF ``rope_scaling``): ``"llama3"``
    (Llama-3.1+ wavelength-banded rescale) or ``"linear"`` (every frequency
    divided by ``factor``)."""

    rope_type: str
    factor: float
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


def rope_frequencies(
    head_dim: int,
    max_len: int,
    theta: float = 10000.0,
    scaling: RopeScaling | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """cos/sin tables of shape (max_len, head_dim/2), fp32, built on the host
    in fp64."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if scaling is not None:
        if scaling.rope_type == "linear":
            inv_freq = inv_freq / scaling.factor
        elif scaling.rope_type == "llama3":
            old_len = scaling.original_max_position_embeddings
            low_wavelen = old_len / scaling.low_freq_factor
            high_wavelen = old_len / scaling.high_freq_factor
            wavelen = 2.0 * np.pi / inv_freq
            smooth = (old_len / wavelen - scaling.low_freq_factor) / (
                scaling.high_freq_factor - scaling.low_freq_factor
            )
            smoothed = ((1.0 - smooth) / scaling.factor + smooth) * inv_freq
            inv_freq = np.where(
                wavelen > low_wavelen,
                inv_freq / scaling.factor,
                np.where(wavelen < high_wavelen, inv_freq, smoothed),
            )
        else:
            raise ValueError(
                f"Unimplemented rope_type {scaling.rope_type!r}; supported: "
                "'llama3', 'linear'."
            )
    t = np.arange(max_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    return np.cos(freqs).astype(np.float32), np.sin(freqs).astype(np.float32)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, positions: torch.Tensor
) -> torch.Tensor:
    """Rotary embedding, rotate-half pairing (dimension i pairs with
    i + h/2), in fp32. x: (B, S, H, h); positions: (B, S)."""
    dtype = x.dtype
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dtype)


# ----------------------------------------------------------------- attention
def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    causal: bool = False,
    scale: float | None = None,
) -> torch.Tensor:
    """Reference attention. q: (B, S, H, h), k/v: (B, T, K, h), grouped-query
    broadcast when K < H (head kk * group + g reads kv head kk). fp32
    logits and softmax; probabilities cast to v's dtype for the value sum.
    ``mask``: (B, T) padding or (B, S, T) full boolean mask."""
    B, S, H, h = q.shape
    T, K = k.shape[1], k.shape[2]
    if H % K != 0:
        raise ValueError(f"num_heads {H} not divisible by num_kv_heads {K}")
    group = H // K
    logits = torch.einsum("bskgh,btkh->bkgst", q.reshape(B, S, K, group, h), k).float()
    logits = logits * (scale if scale is not None else 1.0 / math.sqrt(h))
    if causal:
        keep = torch.ones((S, T), dtype=torch.bool, device=q.device).tril(T - S)
        logits = logits.masked_fill(~keep, _NEG_INF)
    if mask is not None:
        if mask.ndim == 2:
            mask = mask[:, None, :]
        logits = logits.masked_fill(~mask.bool()[:, None, None], _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, H, h)


def cached_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    lengths: torch.Tensor | None = None,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention of new tokens over one layer's KV cache.

    A decode step (one query token, ``lengths`` given) goes to
    `native.decode_attention.flash_decode`: the CUDA kernel on the card, its
    plain version on the CPU; an int8 cache goes in raw with its scales and
    is dequantized inside. Prefill (T_new > 1) runs `dot_product_attention`
    under ``mask``, on the dequantized cache when it is int8. (The JAX
    function takes the dequantized copies plus ``kv_raw``; here the raw
    cache and scales are the arguments and the copies are made only where
    they are read.)"""
    if lengths is not None and q.shape[1] == 1:
        return flash_decode(q, k, v, lengths, k_scale=k_scale, v_scale=v_scale)
    if k_scale is not None:
        k = dequant_kv(k, k_scale, q.dtype)
        v = dequant_kv(v, v_scale, q.dtype)
    return dot_product_attention(q, k, v, mask=mask)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, K, h) -> int8 values + per-(token, head) bf16 scales. Rounds
    half to even, as ``jnp.round`` does. The scale divides by a tensor:
    PyTorch on the card turns a divide by a Python scalar into a multiply
    by its reciprocal, which is not JAX's IEEE divide."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = (amax / torch.full_like(amax, 127.0)).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequant_kv(vals: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of `quantize_kv`, in ``dtype``."""
    return vals.to(dtype) * scales[..., None].to(dtype)


# ------------------------------------------------------------ attention block
@dataclasses.dataclass(frozen=True)
class AttentionSpec:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int


def init_attention(
    generator: torch.Generator, spec: AttentionSpec, dtype: torch.dtype = torch.float32
) -> Params:
    """Bias-free llama-family attention weights (the JAX ``bias=False``)."""
    std = 1.0 / np.sqrt(spec.d_model)
    H, K, h, D = spec.num_heads, spec.num_kv_heads, spec.head_dim, spec.d_model
    return {
        "wq": truncated_normal_init(generator, (D, H, h), std, dtype),
        "wk": truncated_normal_init(generator, (D, K, h), std, dtype),
        "wv": truncated_normal_init(generator, (D, K, h), std, dtype),
        "wo": truncated_normal_init(generator, (H, h, D), std, dtype),
    }


def _routed(w) -> bool:
    """Does this projection go through `matmul_einsum` (fp8 mode, or a
    quantized node) rather than the plain ``x @ w``?"""
    return fp8_enabled() or not isinstance(w, torch.Tensor)


_QKV_EQ = "bsd,dhk->bshk"


def _project(x: torch.Tensor, w) -> torch.Tensor:
    """(B, S, D) x (D, N, h) -> (B, S, N, h) as one matmul."""
    if _routed(w):
        return matmul_einsum(_QKV_EQ, x, w)
    out = x @ w.reshape(w.shape[0], -1).to(x.dtype)
    return out.view(*x.shape[:-1], *w.shape[1:])


def attention_qkv(
    params: Params, x: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _project(x, params["wq"]), _project(x, params["wk"]), _project(x, params["wv"])


class _NormProject(torch.autograd.Function):
    """``_project(rms_norm(x, scale, eps), w)`` for each ``w``, keeping
    ``x`` instead of the normed ``h``: the backward recomputes the norm.

    Under fp8 (read when the forward runs) the products are `fp8_einsum`'s:
    the forward quantizes h once and each w (in h's dtype) to e4m3 and
    keeps the quantized weights; the backward re-quantizes the recomputed h
    (the same values), quantizes each cotangent to e5m2 and runs the fp8 dx
    and dw products, as JAX's custom VJP does for each projection."""

    @staticmethod
    def forward(ctx, x, scale, eps, *ws):
        h = rms_norm(x, scale, eps)
        ctx.eps, ctx.fp8, ctx.w_dtypes = eps, fp8_enabled(), [w.dtype for w in ws]
        if not ctx.fp8:
            ctx.save_for_backward(x, scale, *ws)
            return tuple(_project(h, w) for w in ws)
        qh, sh = quantize(h, E4M3)
        qws = [quantize(w.to(h.dtype), E4M3) for w in ws]
        ctx.save_for_backward(x, scale, *(t for qw in qws for t in qw))
        outs = []
        for qw, sw in qws:
            count_hit()
            outs.append(scaled_matmul(_QKV_EQ, qh, qw, sh * sw, h.dtype))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        x, scale, *ws = ctx.saved_tensors
        need_x, need_scale = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xd = x.detach().requires_grad_(need_x)
            sd = scale.detach().requires_grad_(need_scale)
            h = rms_norm(xd, sd, ctx.eps)
        if ctx.fp8:
            dh, dws = _norm_project_fp8_grads(h.detach(), ws, grads, ctx.w_dtypes)
        else:
            dh, dws = _norm_project_grads(h.detach(), ws, grads)
        inputs = [t for t, need in ((xd, need_x), (sd, need_scale)) if need]
        found = iter(torch.autograd.grad(h, inputs, dh.reshape(h.shape)) if inputs else ())
        dx = next(found) if need_x else None
        dscale = next(found) if need_scale else None
        return (dx, dscale, None, *dws)


def _norm_project_grads(h, ws, grads):
    h2 = h.reshape(-1, h.shape[-1])
    dh = torch.zeros_like(h2)
    dws = []
    for w, g in zip(ws, grads):
        w2 = w.reshape(w.shape[0], -1).to(h2.dtype)
        g2 = g.reshape(h2.shape[0], -1)
        dws.append((h2.t() @ g2).reshape(w.shape).to(w.dtype))
        dh += g2 @ w2.t()
    return dh, dws


def _norm_project_fp8_grads(h, qws, grads, w_dtypes):
    """dh and the dws of `_NormProject` under fp8 (``qws`` alternates the
    saved e4m3 weights and their scales)."""
    dx_eq, dw_eq = _grad_equations(_QKV_EQ)
    qh, sh = quantize(h, E4M3)
    dh, dws = None, []
    for qw, sw, g, w_dtype in zip(qws[0::2], qws[1::2], grads, w_dtypes):
        qg, sg = quantize(g.contiguous(), E5M2)
        d = scaled_matmul(dx_eq, qg, qw, sg * sw, h.dtype)
        dh = d if dh is None else dh + d
        dws.append(scaled_matmul(dw_eq, qh, qg, sh * sg, w_dtype))
    return dh, dws


def normed_qkv(
    params: Params, x: torch.Tensor, scale: torch.Tensor, eps: float, *, recompute_norm: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`attention_qkv` of ``rms_norm(x, scale, eps)``. With
    ``recompute_norm`` the backward keeps ``x`` rather than the normed
    activations and recomputes the norm (the ``attn_and_outputs`` remat,
    which keeps the projections' outputs: in JAX the norm is all it
    recomputes of them). Quantized weight nodes (inference) take the plain
    path."""
    if not recompute_norm or not isinstance(params["wq"], torch.Tensor):
        return attention_qkv(params, rms_norm(x, scale, eps))
    return _NormProject.apply(x, scale, eps, params["wq"], params["wk"], params["wv"])


def attention_out(params: Params, attn: torch.Tensor) -> torch.Tensor:
    wo = params["wo"]
    if _routed(wo):
        return matmul_einsum("bshk,hkd->bsd", attn, wo)
    return attn.reshape(*attn.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1]).to(attn.dtype)


# ------------------------------------------------------------------------ mlp
def init_swiglu(
    generator: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype = torch.float32
) -> Params:
    return {
        "w_gate": truncated_normal_init(generator, (d_model, d_ff), 1.0 / np.sqrt(d_model), dtype),
        "w_up": truncated_normal_init(generator, (d_model, d_ff), 1.0 / np.sqrt(d_model), dtype),
        "w_down": truncated_normal_init(generator, (d_ff, d_model), 1.0 / np.sqrt(d_ff), dtype),
    }


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    if _routed(params["w_gate"]):
        gate = matmul_einsum("bsd,df->bsf", x, params["w_gate"])
        up = matmul_einsum("bsd,df->bsf", x, params["w_up"])
        return matmul_einsum("bsf,fd->bsd", F.silu(gate) * up, params["w_down"])
    gate = x @ params["w_gate"].to(x.dtype)
    up = x @ params["w_up"].to(x.dtype)
    return (F.silu(gate) * up) @ params["w_down"].to(x.dtype)


# ---------------------------------------------------------------------- loss
def cross_entropy_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    z_loss: float = 0.0,
) -> torch.Tensor:
    """Token-level cross entropy in fp32 with the optional z-loss term
    (``z_loss * logsumexp**2``); a ``mask`` averages over its nonzero
    entries (at least one)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = logits.gather(-1, labels.long()[..., None])[..., 0]
    losses = logz - label_logits
    if z_loss > 0.0:
        losses = losses + z_loss * logz.square()
    if mask is not None:
        mask = mask.float()
        return (losses * mask).sum() / mask.sum().clamp_min(1.0)
    return losses.mean()
