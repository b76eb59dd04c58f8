"""Flash attention forward and backward: the CUDA kernels' wrappers and
their plain PyTorch versions.

Three kernels (`csrc/flash_attention.cu`) compute what the JAX package's six
Pallas kernels compute (`ops/flash_attention.py`: the resident and the
blocked forward, dq and dk/dv kernels, whose split exists only for the
TPU's VMEM budget); the source note gives the design and the bound:

- `flash_attention_fwd(q, k, v) -> (o, lse)`;
- `flash_attention_dq(q, k, v, do, lse, delta) -> dq`;
- `flash_attention_dkv(q, k, v, do, lse, delta) -> (dk, dv)`, folded over
  the GQA group inside the kernel.

Layouts are the framework's: q, o, do, dq (B, S, H, h); k, v, dk, dv
(B, S, K, h), query head ``kk * (H // K) + g`` reading kv head ``kk``; lse
and delta (B, H, S) in fp32. `flash_attention_delta` computes delta =
sum(do * o) in plain PyTorch, as XLA does outside Pallas in JAX.

Masking (the TPU kernels'): causal keeps ``col <= row``; otherwise
``col < valid``; ``window`` adds ``row - col < window``. A row that sees no
column at all has an unspecified output (the kernels and the plain versions
spread it differently), as in JAX.

CUDA tensors launch the kernel (bf16 or fp32, head_dim 64 or 128,
contiguous) and raise on anything else; CPU tensors take the plain version
of the same function (no fallback on the card, see `native/dispatch.py`).
The plain versions follow the TPU kernels' formulas, not autograd of the
forward: fp32 logits from fp32 copies of the operands, p cast to v's (dv:
do's) dtype and ds to k's (dk: q's) dtype before their products.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .dispatch import register_kernel

FWD_KERNEL = register_kernel(
    "flash_attention_fwd", "flash attention forward: O and fp32 lse (bf16/fp32, GQA, causal/valid/window)"
)
DQ_KERNEL = register_kernel("flash_attention_dq", "flash attention backward: dQ from lse and delta")
DKV_KERNEL = register_kernel(
    "flash_attention_dkv", "flash attention backward: dK/dV folded over the GQA group"
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_NEG_INF = -1e30


def _check(q, k, v, *extra) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash attention: q (B, S, H, h) and k/v (B, S, K, h), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, h = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != h:
        raise ValueError(f"flash attention: q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError(f"num_heads {H} not divisible by num_kv_heads {k.shape[2]}")
    for t, shape in extra:
        if tuple(t.shape) != shape:
            raise ValueError(f"flash attention: operand {tuple(t.shape)}, expected {shape}")


def _resolve(q, scale, valid) -> tuple[float, int]:
    S, h = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(h) if scale is None else float(scale)
    valid = S if valid is None else int(valid)
    if not 0 <= valid <= S:
        raise ValueError(f"flash attention: valid {valid} outside [0, {S}]")
    return scale, valid


def _keep(S: int, device, causal: bool, valid: int, window: int | None) -> torch.Tensor:
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    keep = cols <= rows if causal else cols < valid
    if window is not None:
        keep = keep & (rows - cols < window)
    return keep


def _grouped(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B, S, H, h) -> fp32 (B, S, K, G, h)."""
    B, S, H, h = x.shape
    return x.float().reshape(B, S, K, H // K, h)


def _scores(q, k, scale, causal, valid, window) -> torch.Tensor:
    """Masked fp32 logits (B, K, G, S, S)."""
    K = k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst", _grouped(q, K), k.float()) * scale
    return torch.where(_keep(q.shape[1], q.device, causal, valid, window), s, _NEG_INF)


def _stat(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B, H, S) -> (B, K, G, S, 1)."""
    B, H, S = x.shape
    return x.reshape(B, K, H // K, S, 1)


def flash_attention_fwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = True,
    valid: int | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: one full-row softmax instead of
    the online one. Returns (o in q's dtype, lse (B, H, S) fp32). Any
    device."""
    _check(q, k, v)
    scale, valid = _resolve(q, scale, valid)
    B, S, H, h = q.shape
    s = _scores(q, k, scale, causal, valid, window)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).float(), v.float())
    o = acc / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(B, H, S)
    return o.reshape(B, S, H, h).to(q.dtype), lse


def flash_attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = sum(do * o) over the head dim, fp32, (B, S, H, h) -> (B, H, S)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _probs(q, k, v, do, lse, delta, scale, causal, valid, window):
    """p = exp(s - lse) and the fp32 ds = p * (do.v^T - delta), (B, K, G, S, S)."""
    K = k.shape[2]
    p = torch.exp(_scores(q, k, scale, causal, valid, window) - _stat(lse, K))
    dp = torch.einsum("bskgd,btkd->bkgst", _grouped(do, K), v.float())
    return p, p * (dp - _stat(delta, K))


def flash_attention_dq_reference(
    q, k, v, do, lse, delta, *, scale=None, causal=True, valid=None, window=None
) -> torch.Tensor:
    """Plain version of the dq kernel: dq = scale * ds.k, ds cast to k's
    dtype. Any device."""
    B, S, H, h = q.shape
    _check(q, k, v, (do, tuple(q.shape)), (lse, (B, H, S)), (delta, (B, H, S)))
    scale, valid = _resolve(q, scale, valid)
    _, ds = _probs(q, k, v, do, lse, delta, scale, causal, valid, window)
    dq = scale * torch.einsum("bkgst,btkd->bskgd", ds.to(k.dtype).float(), k.float())
    return dq.reshape(B, S, H, h).to(q.dtype)


def flash_attention_dkv_reference(
    q, k, v, do, lse, delta, *, scale=None, causal=True, valid=None, window=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dkv kernel: dv = p^T.do (p cast to do's dtype),
    dk = scale * ds^T.q (ds cast to q's dtype), summed over each kv head's
    query heads in fp32. Any device."""
    B, S, H, h = q.shape
    _check(q, k, v, (do, tuple(q.shape)), (lse, (B, H, S)), (delta, (B, H, S)))
    scale, valid = _resolve(q, scale, valid)
    K = k.shape[2]
    p, ds = _probs(q, k, v, do, lse, delta, scale, causal, valid, window)
    dv = torch.einsum("bkgst,bskgd->btkd", p.to(do.dtype).float(), _grouped(do, K))
    dk = scale * torch.einsum("bkgst,bskgd->btkd", ds.to(q.dtype).float(), _grouped(q, K))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(
    q, k, v, o, lse, do, *, scale=None, causal=True, valid=None, window=None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the whole backward (the TPU `_bwd_resident`):
    delta, then dq, then dk/dv with the group fold. Any device."""
    delta = flash_attention_delta(o, do)
    kw = dict(scale=scale, causal=causal, valid=valid, window=window)
    dq = flash_attention_dq_reference(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_attention_dkv_reference(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


# ------------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    tail = [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.atx_flash_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + tail
    lib.atx_flash_attention_dq.argtypes = [ctypes.c_void_p] * 7 + tail
    lib.atx_flash_attention_dkv.argtypes = [ctypes.c_void_p] * 8 + tail
    for fn in (lib.atx_flash_attention_fwd, lib.atx_flash_attention_dq, lib.atx_flash_attention_dkv):
        fn.restype = ctypes.c_int
    return lib


def _cuda_operands(name: str, q: torch.Tensor, tensors, stats) -> None:
    """The kernel's contract, checked before any pointer is taken."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype} (the kernel takes fp32, bf16)")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {q.shape[3]} (the kernel takes {_HEAD_DIMS})")
    for t in tensors:
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: mixed dtypes {t.dtype} and {q.dtype}")
    for t in stats:
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: lse/delta must be fp32, got {t.dtype}")
    for t in list(tensors) + list(stats):
        if t.device != q.device:
            raise ValueError(f"{name}: operand on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous operands")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


def _tail(q, k, scale, causal, valid, window) -> list:
    B, S, H, h = q.shape
    return [
        B, S, H, k.shape[2], h, scale, int(bool(causal)), valid,
        0 if window is None else int(window), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    ]


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _check_window(window) -> None:
    if window is not None and int(window) < 1:
        raise ValueError(f"flash attention: window must be >= 1, got {window}")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float | None = None,
    causal: bool = True,
    valid: int | None = None,
    window: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(o (B, S, H, h) in q's dtype, lse (B, H, S) fp32). CUDA tensors
    launch the forward kernel; CPU tensors run `flash_attention_fwd_reference`."""
    _check(q, k, v)
    _check_window(window)
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, scale=scale, causal=causal, valid=valid, window=window)
    _cuda_operands("flash_attention_fwd", q, (q, k, v), ())
    scale, valid = _resolve(q, scale, valid)
    B, S, H, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = _lib().atx_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *_tail(q, k, scale, causal, valid, window),
    )
    _raise_on("flash_attention_fwd", err)
    FWD_KERNEL.launches += 1
    return o, lse


def flash_attention_dq(
    q, k, v, do, lse, delta, *, scale=None, causal=True, valid=None, window=None
) -> torch.Tensor:
    """dq (B, S, H, h) in q's dtype. CUDA tensors launch the dq kernel; CPU
    tensors run `flash_attention_dq_reference`."""
    B, S, H, _ = q.shape
    _check(q, k, v, (do, tuple(q.shape)), (lse, (B, H, S)), (delta, (B, H, S)))
    _check_window(window)
    kw = dict(scale=scale, causal=causal, valid=valid, window=window)
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, do, lse, delta, **kw)
    _cuda_operands("flash_attention_dq", q, (q, k, v, do), (lse, delta))
    scale, valid = _resolve(q, scale, valid)
    dq = torch.empty_like(q)
    err = _lib().atx_flash_attention_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *_tail(q, k, scale, causal, valid, window),
    )
    _raise_on("flash_attention_dq", err)
    DQ_KERNEL.launches += 1
    return dq


def flash_attention_dkv(
    q, k, v, do, lse, delta, *, scale=None, causal=True, valid=None, window=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) (B, S, K, h) in k's / v's dtype, folded over the GQA group.
    CUDA tensors launch the dkv kernel; CPU tensors run
    `flash_attention_dkv_reference`."""
    B, S, H, _ = q.shape
    _check(q, k, v, (do, tuple(q.shape)), (lse, (B, H, S)), (delta, (B, H, S)))
    _check_window(window)
    kw = dict(scale=scale, causal=causal, valid=valid, window=window)
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, do, lse, delta, **kw)
    _cuda_operands("flash_attention_dkv", q, (q, k, v, do), (lse, delta))
    scale, valid = _resolve(q, scale, valid)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = _lib().atx_flash_attention_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_tail(q, k, scale, causal, valid, window),
    )
    _raise_on("flash_attention_dkv", err)
    DKV_KERNEL.launches += 1
    return dk, dv
