"""Fused AdamW: the CUDA kernel's wrapper.

One AdamW step for one leaf, or one layer slice of one, in a single pass:
the moment EMAs, the bias correction, the weight-decay term and the
learning-rate step, with the moments updated in place. The kernel
(`csrc/fused_adamw.cu`) replaces the TPU kernel `_adamw_kernel` of the JAX
package's `native/pallas/fused_adamw.py`; its source note gives the design
and the bound. The plain version is `parallel.host_offload._adamw_slice`,
the body the JAX package's kernel replaces too.

`fused_adamw` launches the kernel for CUDA tensors and raises on anything
the kernel does not take; CPU tensors take the plain version (no fallback
on the card, see `native/dispatch.py`). Unlike the TPU kernel it takes
every leaf, whatever its size: the 1024-element minimum, the block-divisor
rule and the traced-hyperparameter fallback were TPU tiling rules.

The scalars of the update follow JAX's typing: a Python scalar meeting a
moment array takes the moment dtype (weak typing), so `update_scalars`
rounds each to it, and the bias corrections ``1 - b^c`` are computed once
on the host in that dtype from the host-int count. The kernel and the
plain version both take them from there.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build
from .dispatch import register_kernel

KERNEL = register_kernel(
    "fused_adamw",
    "one AdamW step per leaf, moments in place; the update written out or added into p",
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256
_BLOCKS_PER_SM = 32  # grid-stride: enough blocks to cover latency, no more


@dataclasses.dataclass(frozen=True)
class UpdateScalars:
    """The update's constants, each a Python float exactly representable in
    the moment dtype."""

    b1: float
    one_minus_b1: float
    b2: float
    one_minus_b2: float
    bias_correction1: float
    bias_correction2: float
    eps: float
    weight_decay: float
    neg_lr: float


@functools.lru_cache(maxsize=64)  # one step's launches (147 offloaded at 16 layers) share them
def update_scalars(count: int, lr_t: float, b1: float, b2: float, eps: float,
                   weight_decay: float, dtype: torch.dtype) -> UpdateScalars:
    """The constants of one AdamW step at ``count`` (the 1-based count of
    this update) in the moment dtype: ``b1``, ``1 - b1``, ... as JAX's
    weak-typed scalars become, and ``1 - b^c`` with ``c`` the count in that
    dtype, as ``count.astype(mu.dtype)`` makes it."""

    def r(x) -> float:
        return torch.tensor(x, dtype=dtype).item()

    c = torch.tensor(count, dtype=dtype)
    return UpdateScalars(
        b1=r(b1), one_minus_b1=r(1.0 - b1), b2=r(b2), one_minus_b2=r(1.0 - b2),
        bias_correction1=(1.0 - torch.tensor(b1, dtype=dtype) ** c).item(),
        bias_correction2=(1.0 - torch.tensor(b2, dtype=dtype) ** c).item(),
        eps=r(eps), weight_decay=r(weight_decay), neg_lr=r(-lr_t),
    )


def _check(g, mu, nu, p, grad_scale) -> None:
    if not (g.shape == mu.shape == nu.shape == p.shape):
        raise ValueError(
            f"fused_adamw: g {tuple(g.shape)}, mu {tuple(mu.shape)}, nu {tuple(nu.shape)} "
            f"and p {tuple(p.shape)} must have one shape"
        )
    for name, t in (("g", g), ("mu", mu), ("nu", nu), ("p", p)):
        if t.dtype not in _DTYPE_CODE:
            raise ValueError(f"fused_adamw: {name} dtype {t.dtype} (takes fp32, bf16)")
    if nu.dtype != mu.dtype:
        raise ValueError(f"fused_adamw: mu {mu.dtype} and nu {nu.dtype} must share a dtype")
    if grad_scale is not None and (grad_scale.numel() != 1 or grad_scale.dtype != torch.float32):
        raise ValueError("fused_adamw: grad_scale must be one fp32 element")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_adamw")
    fn = lib.atx_fused_adamw
    fn.argtypes = (
        [ctypes.c_void_p] * 6
        + [ctypes.c_int64]
        + [ctypes.c_int] * 3
        + [ctypes.c_float] * 9
        + [ctypes.c_int] * 3
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_adamw(
    g: torch.Tensor,
    mu: torch.Tensor,
    nu: torch.Tensor,
    p: torch.Tensor,
    count: int,
    lr_t: float,
    b1: float,
    b2: float,
    eps: float,
    weight_decay: float,
    grad_scale: torch.Tensor | None = None,
    *,
    apply: bool = False,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """One AdamW step of one leaf: ``count`` is the host-int count of this
    update (1 on the first), ``lr_t`` the learning rate, ``grad_scale`` an
    optional one-element fp32 device tensor that multiplies g (the folded
    clip). mu and nu (one dtype, the moment dtype) are updated in place.
    Returns ``(update, mu, nu)`` with the update in the moment dtype; with
    ``apply=True`` the update is added into p in place instead and the
    first item is None.

    g, mu, nu and p share a shape; each is fp32 or bf16. CUDA tensors
    launch the kernel (contiguous operands on one device); CPU tensors run
    `parallel.host_offload._adamw_slice` and write its results in place."""
    _check(g, mu, nu, p, grad_scale)
    if g.device.type == "cpu":
        from ..parallel.host_offload import _adamw_slice  # the plain version; it imports this module

        u, new_mu, new_nu = _adamw_slice(g, mu, nu, p, count, lr_t, b1, b2, eps, weight_decay, grad_scale)
        mu.copy_(new_mu)
        nu.copy_(new_nu)
        if apply:
            p.add_(u)
            return None, mu, nu
        return u, mu, nu
    if g.device.type != "cuda":
        raise ValueError(f"fused_adamw: unsupported device {g.device}")
    operands = [g, mu, nu, p] + ([grad_scale] if grad_scale is not None else [])
    for t in operands:
        if t.device != g.device:
            raise ValueError(f"fused_adamw: operand on {t.device}, g on {g.device}")
        if not t.is_contiguous():
            raise ValueError("fused_adamw: the kernel takes contiguous operands")
    n = g.numel()
    u = None if apply else torch.empty_like(mu)
    if n == 0:
        return u, mu, nu
    s = update_scalars(count, lr_t, b1, b2, eps, weight_decay, mu.dtype)
    vec = all(t.data_ptr() % (4 * t.element_size()) == 0 for t in (g, mu, nu, p) + ((u,) if u is not None else ()))
    work = n // 4 + n % 4 if vec else n
    grid = max(1, min(-(-work // _THREADS), _BLOCKS_PER_SM * _sm_count(g.device.index or 0)))
    err = _lib().atx_fused_adamw(
        g.data_ptr(), mu.data_ptr(), nu.data_ptr(), p.data_ptr(),
        u.data_ptr() if u is not None else None,
        grad_scale.data_ptr() if grad_scale is not None else None,
        n, _DTYPE_CODE[g.dtype], _DTYPE_CODE[mu.dtype], _DTYPE_CODE[p.dtype],
        s.b1, s.one_minus_b1, s.b2, s.one_minus_b2, s.bias_correction1, s.bias_correction2,
        s.eps, s.weight_decay, s.neg_lr, int(apply), int(vec), grid,
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_adamw kernel launch failed: cudaError_t {err}")
    KERNEL.launches += 1
    return u, mu, nu
