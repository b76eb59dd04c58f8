"""fp8 matmuls with dynamic per-tensor scaling, ported from the JAX
package's `ops/fp8.py`.

Every projection of `models.layers` routes through `matmul_einsum`. Inside
an `fp8_matmuls` context (which `Accelerator` enters for
``mixed_precision="fp8"``) it runs `fp8_einsum`, the torchao "dynamic
scaling" recipe:

- forward: x and w quantized to **e4m3** (max 448) with per-tensor scales
  ``amax / 448``; the product accumulates in fp32 and is rescaled by
  ``scale_x * scale_w``;
- backward: the cotangent is quantized to **e5m2** (max 57344) and both
  transposed products run on fp8 values the same way.

Every product goes through `native.quant_matmul.scaled_matmul`: the fp8
CUDA kernel on the card, its plain version on the CPU. The scales stay
device tensors: no host sync per projection. The embedding lookup and the
logits head are not routed through fp8, as in JAX.

Unlike JAX, PyTorch reads the mode when a function runs, not when it is
traced: the backward of `fp8_einsum` is fp8 whatever the mode then, and
`models.layers.remat` re-enters the forward's mode for its recompute.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from ..native.quant_matmul import scaled_matmul

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2

_MODE = threading.local()


def fp8_enabled() -> bool:
    return getattr(_MODE, "fp8", False)


def fp8_hits() -> int:
    """How many matmuls were routed to fp8 inside the current (innermost)
    `fp8_matmuls` context: a model that never reaches `matmul_einsum` would
    make the fp8 mode a silent no-op."""
    return getattr(_MODE, "hits", 0)


@contextlib.contextmanager
def fp8_matmuls(enabled: bool = True):
    """While active, `matmul_einsum` runs fp8-quantized contractions."""
    prev = getattr(_MODE, "fp8", False)
    prev_hits = getattr(_MODE, "hits", 0)
    _MODE.fp8 = enabled
    _MODE.hits = 0
    try:
        yield
    finally:
        _MODE.fp8 = prev
        _MODE.hits = prev_hits


@contextlib.contextmanager
def fp8_mode(enabled: bool):
    """Set the mode without touching the hit count (the remat recompute)."""
    prev = getattr(_MODE, "fp8", False)
    _MODE.fp8 = enabled
    try:
        yield
    finally:
        _MODE.fp8 = prev


def count_hit() -> None:
    _MODE.hits = getattr(_MODE, "hits", 0) + 1


def matmul_einsum(eq: str, x: torch.Tensor, w) -> torch.Tensor:
    """The one matmul entry point of the model's projections.

    Normally a plain einsum with the weight cast to the activation dtype.
    Inside `fp8_matmuls`, `fp8_einsum`. ``w`` may also be a quantized node
    (`utils.quantization`): inside `ops.int8.int8_compute` (and not fp8) it
    contracts through the int8 kernel; otherwise it dequantizes to x's
    dtype and takes the normal path."""
    if isinstance(w, dict):
        from ..utils.quantization import dequantize_array
        from .int8 import int8_compute_enabled, int8_einsum_quantized

        if int8_compute_enabled() and not fp8_enabled():
            return int8_einsum_quantized(eq, x, w)
        w = dequantize_array(w, x.dtype)
    if fp8_enabled():
        count_hit()
        return fp8_einsum(eq, x, w.to(x.dtype))
    return torch.einsum(eq, x, w.to(x.dtype))


def quantize(x: torch.Tensor, dtype: torch.dtype = E4M3) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor dynamic scaling: ``(q, scale)`` with ``q ≈ x / scale`` in
    ``dtype`` and ``scale = amax / finfo(dtype).max`` (an fp32 scalar
    tensor on x's device), so q spans the full fp8 range. The amax of x's
    own dtype is exact (abs and max do not round)."""
    amax = x.detach().abs().amax().float()
    scale = amax.clamp_min(1e-12) / torch.finfo(dtype).max
    q = x.detach().to(torch.float32, copy=True).div_(scale).to(dtype)
    return q, scale


def _grad_equations(eq: str) -> tuple[str, str]:
    """Transposes of ``einsum(eq, x, w)``: ``(dx_eq, dw_eq)`` with
    ``dx = einsum(dx_eq, g, w)`` and ``dw = einsum(dw_eq, x, g)``."""
    ins, out = eq.split("->")
    a, b = ins.split(",")
    return f"{out},{b}->{a}", f"{a},{out}->{b}"


class _Fp8Einsum(torch.autograd.Function):
    """`_fp8_einsum_fwd` / `_fp8_einsum_bwd`: saves (qx, sx, qw, sw) and
    returns dx and dw in the primal dtypes."""

    @staticmethod
    def forward(ctx, eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        qx, sx = quantize(x, E4M3)
        qw, sw = quantize(w, E4M3)
        out = scaled_matmul(eq, qx, qw, sx * sw, x.dtype)
        ctx.save_for_backward(qx, sx, qw, sw)
        ctx.eq, ctx.dtypes = eq, (x.dtype, w.dtype)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        qx, sx, qw, sw = ctx.saved_tensors
        dx_eq, dw_eq = _grad_equations(ctx.eq)
        qg, sg = quantize(g.contiguous(), E5M2)
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dx = scaled_matmul(dx_eq, qg, qw, sg * sw, ctx.dtypes[0])
        if ctx.needs_input_grad[2]:
            dw = scaled_matmul(dw_eq, qx, qg, sx * sg, ctx.dtypes[1])
        return None, dx, dw


def fp8_einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, x, w)`` on dynamically scaled fp8 operands (e4m3
    forward, e5m2 cotangent), fp32 accumulation."""
    return _Fp8Einsum.apply(eq, x, w)
