"""Quantized matrix products: the fp8 and int8 CUDA kernels' wrappers and
their plain PyTorch versions.

Two kernels (`csrc/quant_matmul.cu`) replace the two Pallas kernels of the
JAX package's `native/pallas/quant_matmul.py`; the source note gives the
design and the bound:

- `scaled_matmul(eq, qa, qb, scale, out_dtype)`: ``(einsum(eq, qa, qb) in
  fp32) * scale`` on e4m3 / e5m2 operands (each on its own), ``scale`` an
  fp32 scalar tensor read on the device — the fp8 forward and both backward
  contractions of `ops.fp8.fp8_einsum`;
- `int8_matmul(eq, x, wq, w_scale)`: the body of `ops.int8.int8_einsum` —
  per-row int8 quantization of ``x``, an int8 x int8 -> int32 product with
  ``wq`` and the rescale by row scale x per-channel weight scale.

Every equation of the model's projections (and of their `_grad_equations`
transposes) is a 2D product in one of four orientations, reached by reshape
(`_parse_matmul_eq`, ported from the JAX module); the kernels take all four
for fp8, and a trailing-contracted ``x`` (the per-row scale) for int8.

CUDA tensors launch the kernel and raise on an equation, dtype or layout it
does not take; CPU tensors run the plain version (no fallback on the card,
see `native/dispatch.py`). The plain versions: kernel 9's is
``(qa.float() @ qb.float()) * scale`` on the 2D views (exact fp8 products
summed in fp32); kernel 8's is the literal `ops.int8.quantize_act` ->
integer product (int32 on the CPU; float64 on the card, where PyTorch has
no int32 matmul and float64 holds every int32 sum exactly) -> rescale.
Either takes any einsum the JAX fallback takes when `_plan` refuses it.

The weight scale follows the JAX fallback's `_w_scale_to_out` broadcast:
the wrapper expands it to one fp32 value per output column, so the per-h
scale of the stacked ``wq`` (L, 1, 1, h) works (the Pallas
``w_scale.reshape(1, N)`` raises on it).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import build
from .dispatch import register_kernel

INT8_KERNEL = register_kernel(
    "int8_matmul", "per-row int8 quantize pre-pass -> int8 x int8 -> int32 mma.sync -> rescale"
)
FP8_KERNEL = register_kernel(
    "fp8_matmul", "e4m3/e5m2 mma.sync with fp32 accumulation x a device scalar scale"
)

FP8_DTYPES = {torch.float8_e4m3fn: 0, torch.float8_e5m2: 1}
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    oa: str  # "trail": a stored (M, C); "lead": (C, M)
    ob: str  # "lead": b stored (C, N); "trail": (N, C)
    na: int  # output dims from a
    M: int
    N: int
    C: int
    out_shape: tuple[int, ...]


def _parse_matmul_eq(eq: str):
    """Prove ``eq`` is a pure matmul: returns ``(oa, ob, na, nb)`` with
    orientations in {"lead", "trail"} (contracted labels at the front or
    back of the operand, same order in both) and the output dims each
    operand keeps, or ``None``."""
    if "->" not in eq or "." in eq:
        return None
    lhs, out = eq.split("->")
    if "," not in lhs:
        return None
    a, b = lhs.split(",")
    contracted = "".join(c for c in a if c in b)
    if not contracted or any(c in out for c in contracted):
        return None  # no contraction, or shared batch labels: not this kernel
    if "".join(c for c in b if c in a) != contracted:
        return None  # contracted labels must appear in the same order
    a_rest = "".join(c for c in a if c not in contracted)
    b_rest = "".join(c for c in b if c not in contracted)
    if a_rest + b_rest != out or not a_rest or not b_rest:
        return None
    if a.startswith(contracted):
        oa = "lead"
    elif a.endswith(contracted):
        oa = "trail"
    else:
        return None
    if b.startswith(contracted):
        ob = "lead"
    elif b.endswith(contracted):
        ob = "trail"
    else:
        return None
    return oa, ob, len(a_rest), len(b_rest)


@functools.lru_cache(maxsize=256)
def _plan(eq: str, a_shape: tuple[int, ...], b_shape: tuple[int, ...]) -> Plan | None:
    """The 2D product behind ``eq`` at these shapes, or ``None``."""
    parsed = _parse_matmul_eq(eq)
    if parsed is None:
        return None
    oa, ob, na, nb = parsed
    a_rest = a_shape[:na] if oa == "trail" else a_shape[len(a_shape) - na :]
    b_rest = b_shape[len(b_shape) - nb :] if ob == "lead" else b_shape[:nb]
    c_dims = a_shape[na:] if oa == "trail" else a_shape[: len(a_shape) - na]
    M, N, C = math.prod(a_rest), math.prod(b_rest), math.prod(c_dims)
    if M == 0 or N == 0 or C == 0:
        return None
    return Plan(oa, ob, na, M, N, C, tuple(a_rest) + tuple(b_rest))


def _views(plan: Plan, a: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a and b as the kernel sees them: a (M, C) or (C, M), b (C, N) or (N, C)."""
    M, N, C = plan.M, plan.N, plan.C
    a2 = a.reshape(M, C) if plan.oa == "trail" else a.reshape(C, M)
    b2 = b.reshape(C, N) if plan.ob == "lead" else b.reshape(N, C)
    return a2, b2


def _as_mc_cn(plan: Plan, a2: torch.Tensor, b2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The 2D views as (M, C) and (C, N) (transposed views, no copy)."""
    return (a2 if plan.oa == "trail" else a2.t()), (b2 if plan.ob == "lead" else b2.t())


# ------------------------------------------------------------ plain versions
def scaled_matmul_reference(
    eq: str, qa: torch.Tensor, qb: torch.Tensor, scale, out_dtype: torch.dtype
) -> torch.Tensor:
    """Plain version of the fp8 kernel: ``(qa.float() @ qb.float()) *
    scale`` cast to ``out_dtype``, on the 2D views (any einsum the JAX
    fallback takes otherwise). Any device."""
    plan = _plan(eq, tuple(qa.shape), tuple(qb.shape))
    if plan is None:
        acc = torch.einsum(eq, qa.float(), qb.float())
    else:
        a, b = _as_mc_cn(plan, *_views(plan, qa, qb))
        acc = (a.float() @ b.float()).reshape(plan.out_shape)
    return (acc * scale).to(out_dtype)


def int8_matmul_reference(
    eq: str, x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor
) -> torch.Tensor:
    """Plain version of the int8 kernel, the JAX `int8_einsum` fallback
    literally: `quantize_act` over x's contracted axes, an exact integer
    product, ``acc * (x scale * w scale)`` in x's dtype. Any device."""
    from ..ops.int8 import _w_scale_to_out, _x_contracted_axes, _x_scale_to_out, quantize_act

    qx, sx = quantize_act(x, _x_contracted_axes(eq))
    exact = torch.int32 if x.device.type == "cpu" else torch.float64
    acc = torch.einsum(eq, qx.to(exact), wq.to(exact))
    scale = _x_scale_to_out(eq, sx) * _w_scale_to_out(eq, w_scale)
    return (acc.to(torch.float32) * scale).to(x.dtype)


# ------------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("quant_matmul")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.atx_fp8_matmul.argtypes = [p, p, p, p] + [i] * 8 + [p]
    lib.atx_int8_matmul.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.atx_fp8_matmul.restype = ctypes.c_int
    lib.atx_int8_matmul.restype = ctypes.c_int
    return lib


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _cuda_plan(name: str, eq: str, a: torch.Tensor, b: torch.Tensor) -> Plan:
    """The kernel's contract for the operands, checked before any pointer
    is taken."""
    plan = _plan(eq, tuple(a.shape), tuple(b.shape))
    if plan is None:
        raise ValueError(f"{name}: {eq!r} at {tuple(a.shape)} x {tuple(b.shape)} is not a 2D matmul")
    for t in (a, b):
        if t.device != a.device:
            raise ValueError(f"{name}: operands on {a.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous operands")
    return plan


def scaled_matmul(
    eq: str, qa: torch.Tensor, qb: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """``(einsum(eq, qa, qb) in fp32) * scale`` cast to ``out_dtype`` (bf16
    or fp32), qa and qb each e4m3 or e5m2, ``scale`` an fp32 scalar tensor.
    CUDA tensors launch the fp8 kernel; CPU tensors run
    `scaled_matmul_reference`."""
    if qa.device.type == "cpu":
        return scaled_matmul_reference(eq, qa, qb, scale, out_dtype)
    plan = _cuda_plan("fp8_matmul", eq, qa, qb)
    if qa.dtype not in FP8_DTYPES or qb.dtype not in FP8_DTYPES:
        raise ValueError(f"fp8_matmul: operands {qa.dtype}, {qb.dtype} (the kernel takes e4m3 and e5m2)")
    if out_dtype not in _OUT_CODE:
        raise ValueError(f"fp8_matmul: out_dtype {out_dtype} (the kernel writes fp32 or bf16)")
    if not isinstance(scale, torch.Tensor) or scale.numel() != 1 or scale.dtype != torch.float32 \
            or scale.device != qa.device:
        raise ValueError("fp8_matmul: scale must be one fp32 value on the operands' device")
    a2, b2 = _views(plan, qa, qb)
    out = torch.empty((plan.M, plan.N), dtype=out_dtype, device=qa.device)
    err = _lib().atx_fp8_matmul(
        a2.data_ptr(), b2.data_ptr(), scale.data_ptr(), out.data_ptr(), plan.M, plan.N, plan.C,
        int(plan.oa == "lead"), int(plan.ob == "lead"), FP8_DTYPES[qa.dtype], FP8_DTYPES[qb.dtype],
        _OUT_CODE[out_dtype], torch.cuda.current_stream(qa.device).cuda_stream,
    )
    _raise_on("fp8_matmul", err)
    FP8_KERNEL.launches += 1
    return out.reshape(plan.out_shape)


def column_scales(eq: str, w_scale: torch.Tensor, plan: Plan) -> torch.Tensor:
    """The per-channel weight scale as one fp32 value per output column
    (N,), by the `_w_scale_to_out` broadcast."""
    from ..ops.int8 import _w_scale_to_out

    ws = _w_scale_to_out(eq, w_scale)  # out's rank: 1 on x's labels
    b_rest = plan.out_shape[plan.na :]
    return ws.reshape(ws.shape[plan.na :]).expand(b_rest).reshape(plan.N).contiguous()


def int8_matmul(eq: str, x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """`ops.int8.int8_einsum`'s body: x quantized per row (amax/127 over its
    contracted axes), int8 x int8 -> int32 with ``wq``, rescaled by ``row
    scale x w_scale`` in x's dtype (bf16 or fp32). CUDA tensors launch the
    row-quantize and int8 kernels (x contracted on its trailing axes);
    CPU tensors run `int8_matmul_reference`."""
    if x.device.type == "cpu":
        return int8_matmul_reference(eq, x, wq, w_scale)
    plan = _cuda_plan("int8_matmul", eq, x, wq)
    if plan.oa != "trail":
        raise ValueError(f"int8_matmul: {eq!r} contracts x on its leading axes (rows need the trailing ones)")
    if x.dtype not in _OUT_CODE or wq.dtype != torch.int8:
        raise ValueError(f"int8_matmul: x {x.dtype}, wq {wq.dtype} (the kernel takes fp32/bf16 x, int8 wq)")
    if w_scale.device != x.device:
        raise ValueError(f"int8_matmul: w_scale on {w_scale.device}, x on {x.device}")
    ws = column_scales(eq, w_scale, plan)
    x2, w2 = _views(plan, x, wq)
    qx = torch.empty((plan.M, plan.C), dtype=torch.int8, device=x.device)
    sx = torch.empty((plan.M,), dtype=torch.float32, device=x.device)
    out = torch.empty((plan.M, plan.N), dtype=x.dtype, device=x.device)
    err = _lib().atx_int8_matmul(
        x2.data_ptr(), w2.data_ptr(), ws.data_ptr(), qx.data_ptr(), sx.data_ptr(), out.data_ptr(),
        plan.M, plan.N, plan.C, int(plan.ob == "lead"), _OUT_CODE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on("int8_matmul", err)
    INT8_KERNEL.launches += 1
    return out.reshape(plan.out_shape)
