"""int8 x int8 -> int32 products on quantized weights, ported from the JAX
package's `ops/int8.py`.

The weight-only quantization of `utils.quantization` stores int8 weights
and, by default, dequantizes them to the compute dtype before each product.
Inside an `int8_compute` context, `ops.fp8.matmul_einsum` instead hands a
quantized node to `int8_einsum_quantized`: activations are quantized per
row (amax/127 over the contracted axes), the contraction runs on int8 with
int32 accumulation, and the result is rescaled by row scale x per-channel
weight scale. The weight's rounding is the dequantize path's; only the
activation rounding is new. Packed int4 weights unpack to int8 values first
(plain elementwise code) and take the same product.

`int8_einsum` always goes through `native.quant_matmul.int8_matmul`: the
CUDA kernel on the card, its plain version on the CPU. There is no "kernel
off" mode. Inference only: the product has no backward.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from ..native.quant_matmul import int8_matmul

_MODE = threading.local()


def int8_compute_enabled() -> bool:
    return getattr(_MODE, "int8", False)


@contextlib.contextmanager
def int8_compute(enabled: bool = True):
    """While active, `matmul_einsum` runs quantized-weight contractions
    through the int8 kernel instead of dequantizing first. PyTorch runs
    eagerly, so the mode is read at every call (JAX reads it at trace
    time)."""
    prev = getattr(_MODE, "int8", False)
    _MODE.int8 = enabled
    try:
        yield
    finally:
        _MODE.int8 = prev


def with_int8_compute(fn):
    """A new callable that always runs ``fn`` inside `int8_compute`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with int8_compute():
            return fn(*args, **kwargs)

    return wrapped


def quantize_act(
    x: torch.Tensor, reduce_axes: tuple[int, ...] | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic int8 scaling: ``(q, scale)`` with ``q ≈ x / scale`` in int8
    and ``scale = amax / 127`` (fp32), per tensor (``reduce_axes=None``) or
    per row (amax over ``reduce_axes``, kept as size-1 dims). Rounds half
    to even, as ``jnp.round``. The scale divides by a tensor: PyTorch on
    the card turns a divide by a Python scalar into a multiply by its
    reciprocal, which for some rows is one ulp off the IEEE divide of JAX
    and of the kernel's row-quantize pass."""
    xf = x.float()
    if reduce_axes is None:
        amax = xf.abs().amax()
    else:
        amax = xf.abs().amax(dim=reduce_axes, keepdim=True)
    amax = amax.clamp_min(1e-12)
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def _scale_to_out(eq: str, operand: int, scale: torch.Tensor) -> torch.Tensor:
    """Align a scale of operand ``operand`` (its shape, contracted dims kept
    as size 1) to the output of ``einsum(eq, x, w)``: contracted axes are
    summed away (they have size 1, so this is the identity) and output
    labels the operand does not carry become size-1 dims."""
    ins, out = eq.split("->")
    labels = ins.split(",")[operand]
    kept = "".join(lbl for lbl in out if lbl in labels)
    squeezed = torch.einsum(f"{labels}->{kept}", scale.float())
    shape = tuple(squeezed.shape[kept.index(lbl)] if lbl in kept else 1 for lbl in out)
    return squeezed.reshape(shape)


def _w_scale_to_out(eq: str, w_scale: torch.Tensor) -> torch.Tensor:
    """A per-output-channel weight scale aligned to ``einsum(eq, x, w)``'s
    output (the per-h scale of a stacked ``wq`` included)."""
    return _scale_to_out(eq, 1, w_scale)


def _x_scale_to_out(eq: str, x_scale: torch.Tensor) -> torch.Tensor:
    """A per-row activation scale aligned to the output (the x-side twin of
    `_w_scale_to_out`)."""
    return _scale_to_out(eq, 0, x_scale)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed uint8 (two 4-bit values a byte, `utils.quantization` layout)
    -> int8 values in [-7, 7], doubling the last axis."""
    hi = (packed >> 4).to(torch.int8) - 8
    lo = (packed & 0xF).to(torch.int8) - 8
    return torch.stack([hi, lo], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def _x_contracted_axes(eq: str) -> tuple[int, ...]:
    """Axes of x reduced by ``einsum(eq, x, w)`` (labels shared with w and
    absent from the output): the per-row quantization group."""
    ins, out = eq.split("->")
    a, b = ins.split(",")
    return tuple(i for i, lbl in enumerate(a) if lbl in b and lbl not in out)


def int8_einsum(eq: str, x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, x, dequant(wq))`` computed int8 x int8 -> int32 with
    per-row activation scales, through `native.quant_matmul.int8_matmul`."""
    return int8_matmul(eq, x.contiguous(), wq.contiguous(), w_scale)


def int8_einsum_quantized(eq: str, x: torch.Tensor, wnode: dict) -> torch.Tensor:
    """`int8_einsum` over a ``{"__quant__" | "__quant4__", "scale"}`` node
    (int4 unpacks to int8 values first)."""
    from ..utils.quantization import _QUANT4_KEY, _QUANT_KEY

    if _QUANT4_KEY in wnode:
        return int8_einsum(eq, x, _unpack_int4(wnode[_QUANT4_KEY]), wnode["scale"])
    return int8_einsum(eq, x, wnode[_QUANT_KEY], wnode["scale"])
