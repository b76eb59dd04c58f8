"""Flash attention: the entry point of the JAX package's
`ops/flash_attention.py`, over the CUDA kernels of `native.flash_attention`.

`flash_attention` routes exactly as the JAX function does, by shape only: a
``segment_mask``, S != T or S < 16 go to `models.layers.dot_product_attention`
(the window band folded into the mask); everything else goes through
`FlashAttention`, a `torch.autograd.Function` whose forward runs the fwd
kernel and saves (q, k, v, o, lse), the JAX custom VJP's residuals, and
whose backward runs the dq and dkv kernels. The kernels mask a ragged S
themselves, so nothing is padded to a block multiple. On CPU tensors the
same function runs the kernels' plain versions.
"""

from __future__ import annotations

import math

import torch

from ..native.flash_attention import (
    flash_attention_delta,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
)


class FlashAttention(torch.autograd.Function):
    """Attention over (B, S, H, h) q and (B, S, K, h) k/v through the
    flash kernels; gradients for q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, window: int | None):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = dict(scale=scale, causal=causal, window=window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_attention_delta(o, do)
        dq = flash_attention_dq(q, k, v, do, lse, delta, **ctx.kw)
        dk, dv = flash_attention_dkv(q, k, v, do, lse, delta, **ctx.kw)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_mask: torch.Tensor | None = None,
    scale: float | None = None,
    window: int | None = None,
) -> torch.Tensor:
    """Fused attention over (B, S, H, h) queries and (B, T, K, h) kv (GQA).

    ``window`` keeps key c visible from row r only while ``r - c < window``,
    in the kernels (tiles outside the band are skipped). The JAX function's
    TPU-only ``block_size`` and ``interpret`` arguments and its block-size
    autotune table have no counterpart here: the kernels' tiles are fixed
    for Hopper and the CPU runs the plain versions."""
    B, S, H, h = q.shape
    T, K = k.shape[1], k.shape[2]
    if H % K != 0:
        raise ValueError(f"num_heads {H} not divisible by num_kv_heads {K}")
    scale = scale if scale is not None else 1.0 / math.sqrt(h)
    if segment_mask is not None or S != T or S < 16:
        from ..models.layers import dot_product_attention

        if window is not None:
            # Queries are the last S of T positions (the KV-cache decode
            # convention), as in the JAX function.
            rows = (T - S) + torch.arange(S, device=q.device)[:, None]
            cols = torch.arange(T, device=q.device)[None, :]
            band = (rows - cols < window).expand(B, S, T)
            if segment_mask is not None:
                mask = segment_mask[:, None, :] if segment_mask.ndim == 2 else segment_mask
                band = band & mask.bool()
            segment_mask = band
        return dot_product_attention(q, k, v, mask=segment_mask, causal=causal, scale=scale)
    return FlashAttention.apply(q, k, v, scale, causal, window)
