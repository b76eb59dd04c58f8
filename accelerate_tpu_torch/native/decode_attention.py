"""Flash-decode attention over the slot KV cache: the CUDA kernel's wrapper
and its plain PyTorch version.

One query token per row attends over the row's cached prefix, masked by
the row's length cursor — the decode step of `models.llama.forward_with_cache`.
The kernel (`csrc/decode_attention.cu`) replaces the TPU kernel
`_decode_kernel` of the JAX package's `native/pallas/decode_attention.py`;
its source note gives the design and the bound.

`flash_decode` launches the kernel for CUDA tensors and raises on anything
the kernel does not take; CPU tensors take `flash_decode_reference`, the
plain version of the same length-masked function (no fallback on the card,
see `native/dispatch.py`). Parity with the reference attention
(`models.layers.dot_product_attention` over the masked cache) is to
tolerance, not bitwise: both keep fp32 logits and softmax, but the kernel
merges per-split partials and keeps the probabilities in fp32.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build
from .dispatch import register_kernel

KERNEL = register_kernel(
    "flash_decode",
    "single-query flash-decode over the slot KV cache (bf16/fp32, int8 + scales)",
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIM = 128  # every preset's (Llama-3 8B and 70B)
_MAX_GROUP = 8
# Fewest cache positions one split (one block of pass 1) walks: below this
# the fp32 partials cost more traffic than the parallelism gains.
_MIN_CHUNK = 64
_NEG_INF = -1e30


def _check_shapes(q, k, v, lengths, k_scale, v_scale) -> None:
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"flash_decode: q and k must be 4-D, got {q.shape}, {k.shape}")
    B, S, H, h = q.shape
    if S != 1:
        raise ValueError(f"flash_decode is single-query only, got T_new={S}")
    if v.shape != k.shape or k.shape[0] != B or k.shape[3] != h:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} vs k {tuple(k.shape)} / v {tuple(v.shape)}")
    if H % k.shape[2] != 0:
        raise ValueError(f"num_heads {H} not divisible by num_kv_heads {k.shape[2]}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("flash_decode: pass both k_scale and v_scale, or neither")
    if (k.dtype == torch.int8) != (k_scale is not None):
        raise ValueError("flash_decode: an int8 cache needs k_scale/v_scale, and only it")
    if k_scale is not None and (
        k_scale.shape != k.shape[:3] or v_scale.shape != k.shape[:3]
    ):
        raise ValueError(f"flash_decode: scales must be {tuple(k.shape[:3])}")
    if isinstance(lengths, torch.Tensor) and lengths.shape not in ((), (B,)):
        raise ValueError(f"flash_decode: lengths must be () or ({B},), got {tuple(lengths.shape)}")


def _lengths_vector(lengths, batch: int, device) -> torch.Tensor:
    """() / (B,) / int cursor -> (B,) int32 on ``device`` (the broadcast the
    TPU wrapper does with ``jnp.broadcast_to``)."""
    if not isinstance(lengths, torch.Tensor):
        return torch.full((batch,), int(lengths), dtype=torch.int32, device=device)
    if lengths.dtype != torch.int32:
        raise ValueError(f"flash_decode: lengths must be int32, got {lengths.dtype}")
    return lengths.reshape(-1).expand(batch).contiguous()


def flash_decode_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same length-masked fp32
    softmax attention, one full-row softmax instead of merged partials.
    Any device."""
    _check_shapes(q, k, v, lengths, k_scale, v_scale)
    B, _, H, h = q.shape
    T, K = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
        vf = vf * v_scale.float()[..., None]
    qf = q.float().reshape(B, K, H // K, h)  # head = kk * group + g
    s = torch.einsum("bkgh,btkh->bkgt", qf, kf) / math.sqrt(h)
    lens = _lengths_vector(lengths, B, q.device)
    keep = (torch.arange(T, device=q.device)[None, :] < lens[:, None])[:, None, None, :]
    s = torch.where(keep, s, _NEG_INF)
    p = torch.where(keep, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    acc = torch.einsum("bkgt,btkh->bkgh", p, vf)
    out = acc / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.reshape(B, 1, H, h).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attention")
    fn = lib.atx_flash_decode
    fn.argtypes = (
        [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 7
        + [ctypes.c_float]
        + [ctypes.c_int] * 2
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(batch: int, kv_heads: int, cache_len: int, sms: int) -> tuple[int, int]:
    """(n_splits, chunk) for pass 1: about four blocks per SM over the
    (row, kv-head) pairs, each split walking at least `_MIN_CHUNK` positions."""
    n = -(-4 * sms // (batch * kv_heads))
    n = max(1, min(n, cache_len // _MIN_CHUNK))
    chunk = -(-cache_len // n)
    return -(-cache_len // chunk), chunk


def flash_decode(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths,
    *,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """q: (B, 1, H, h); k/v: (B, T, K, h) cache buffers (bf16/fp32 of q's
    dtype, or int8 with per-(token, head) bf16 ``*_scale`` of shape
    (B, T, K)); lengths: int, () or (B,) int32 valid-prefix cursors.
    Returns (B, 1, H, h) in q's dtype.

    Scale 1/sqrt(h). CUDA tensors launch the kernel (contiguous operands,
    head_dim 128, H / K <= 8, any T); CPU tensors run
    `flash_decode_reference`."""
    _check_shapes(q, k, v, lengths, k_scale, v_scale)
    if q.device.type == "cpu":
        return flash_decode_reference(q, k, v, lengths, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    B, _, H, h = q.shape
    T, K = k.shape[1], k.shape[2]
    operands = [q, k, v] + ([k_scale, v_scale] if k_scale is not None else [])
    for t in operands + ([lengths] if isinstance(lengths, torch.Tensor) else []):
        if t.device != q.device:
            raise ValueError(f"flash_decode: operand on {t.device}, q on {q.device}")
    for t in operands:
        if not t.is_contiguous():
            raise ValueError("flash_decode: the kernel takes contiguous operands")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_decode: q dtype {q.dtype} (kernel takes fp32, bf16)")
    if k.dtype not in (q.dtype, torch.int8):
        raise ValueError(f"flash_decode: cache dtype {k.dtype} with q {q.dtype}")
    if k_scale is not None and (
        k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16
    ):
        raise ValueError("flash_decode: int8 scales must be bf16")
    if h != _HEAD_DIM or H // K > _MAX_GROUP:
        raise ValueError(
            f"flash_decode: head_dim {h} / group {H // K} (kernel takes head_dim "
            f"{_HEAD_DIM}, group <= {_MAX_GROUP})"
        )
    lens = _lengths_vector(lengths, B, q.device)
    n_splits, chunk = split_plan(B, K, T, _sm_count(q.device.index or 0))
    part_m = torch.empty((B, H, n_splits), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, H, n_splits, h), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    err = _lib().atx_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if k_scale is not None else None,
        v_scale.data_ptr() if v_scale is not None else None,
        lens.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(),
        B, T, K, H // K, h, n_splits, chunk, 1.0 / math.sqrt(h),
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError_t {err}")
    KERNEL.launches += 1
    return out
