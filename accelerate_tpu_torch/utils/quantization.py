"""Weight-only int8 / packed-int4 quantization of parameter trees, ported
from the JAX package's `utils/quantization.py`.

Symmetric per-channel quantization with one fp32 scale per output channel
(last axis), kept separately for every slice of the leading "stack" axes
(the layer axis of the stacked blocks; layer and expert for MoE). A
quantized leaf is a small dict node, ``{"__quant__": int8, "scale": fp32}``
or ``{"__quant4__": uint8 (two values a byte), "scale": fp32}``, with the
scale keeping the reduced axes as size 1: the stacked ``wq`` (L, D, H, h)
gets a scale of shape (L, 1, 1, h). `models.llama` dequantizes the nodes per
layer to the compute dtype, or, inside `ops.int8.int8_compute`, hands them
to the int8 kernel untouched.

Rounding is half to even (`torch.round`), as ``jnp.round`` and ``np.rint``
round, so values and scales are bit-equal to the JAX package's. Stacked
leaves are quantized one leading slice at a time, which keeps the fp32
scratch of an 8B model's largest leaf to one layer's worth on the card.
"""

from __future__ import annotations

import re
from typing import Any

import torch

_QUANT_KEY = "__quant__"
_QUANT4_KEY = "__quant4__"

# Leaves that stay full precision: cheap, sensitive, integer-indexed, or
# consumed outside the per-block dequant (embedding lookup / head matmul).
DEFAULT_SKIP_PATTERNS = (
    r"norm",
    r"scale",
    r"bias",
    r"router",
    r"(^|/)b$",
    r"embed",
    r"head",
    r"pooler",
    r"classifier",
)

# Path patterns whose weights carry extra leading stack axes beyond the
# layer one (value = total stack dims): MoE experts keep their own scales.
DEFAULT_STACK_DIM_PATTERNS: tuple[tuple[str, int], ...] = (
    (r"moe", 2),
    (r"expert", 2),
)


def is_quantized(x: Any) -> bool:
    return isinstance(x, dict) and (_QUANT_KEY in x or _QUANT4_KEY in x)


def _quantize_impl(w: torch.Tensor, stack_dims: int | None, bits: int) -> dict[str, torch.Tensor]:
    """The int8 / int4 math of the JAX `_quantize_impl` (its jnp branch)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    w32 = w.float()
    if stack_dims is None:
        stack_dims = 1 if w32.ndim >= 3 else 0
    stack_dims = min(stack_dims, max(w32.ndim - 2, 0))
    reduce_axes = tuple(range(stack_dims, w32.ndim - 1))
    qmax = 7.0 if (bits == 4 and w32.shape[-1] % 2 == 0) else 127.0
    absmax = w32.abs().amax(dim=reduce_axes, keepdim=True)
    scale = absmax.clamp_min(1e-12) / qmax
    q = torch.round(w32 / scale).clamp_(-qmax, qmax).to(torch.int8)
    if qmax == 7.0:
        q8 = (q + 8).to(torch.uint8)
        packed = (q8[..., 0::2] << 4) | q8[..., 1::2]
        return {_QUANT4_KEY: packed, "scale": scale}
    return {_QUANT_KEY: q, "scale": scale}


def quantize_array(
    w: torch.Tensor, stack_dims: int | None = None, bits: int = 8
) -> dict[str, torch.Tensor]:
    """Symmetric int8 (or, with ``bits=4``, packed int4 in [-7, 7]; int8
    when the last axis is odd), one fp32 scale per output channel per
    slice of the ``stack_dims`` leading axes (default 1 for ndim >= 3)."""
    if stack_dims is None:
        stack_dims = 1 if w.ndim >= 3 else 0
    if min(stack_dims, max(w.ndim - 2, 0)) == 0 or w.shape[0] == 1:
        return _quantize_impl(w, stack_dims, bits)
    # Slices along the first stack axis reduce independently: the same
    # values, with one slice's fp32 scratch at a time.
    parts = [_quantize_impl(w[i : i + 1], stack_dims, bits) for i in range(w.shape[0])]
    return {key: torch.cat([p[key] for p in parts]) for key in parts[0]}


def leaf_quant_plan(
    path_s: str,
    shape: tuple[int, ...],
    dtype: torch.dtype,
    *,
    skip_patterns: tuple[str, ...] = DEFAULT_SKIP_PATTERNS,
    min_size: int = 4096,
    stack_dim_patterns: tuple[tuple[str, int], ...] = DEFAULT_STACK_DIM_PATTERNS,
) -> tuple[bool, int | None]:
    """``(eligible, stack_dims)`` for the leaf at ``path_s`` ("a/b/c"):
    float leaves of at least ``min_size`` elements and two dims, not
    matching ``skip_patterns``."""
    if any(re.search(pat, path_s) for pat in skip_patterns):
        return False, None
    if not dtype.is_floating_point:
        return False, None
    numel = 1
    for n in shape:
        numel *= int(n)
    if numel < min_size or len(shape) < 2:
        return False, None
    for pat, dims in stack_dim_patterns:
        if re.search(pat, path_s) and len(shape) >= dims + 2:
            return True, dims
    return True, None


def dequantize_array(d: dict[str, torch.Tensor], dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if _QUANT4_KEY in d:
        packed = d[_QUANT4_KEY]
        hi = (packed >> 4).to(torch.int8) - 8
        lo = (packed & 0xF).to(torch.int8) - 8
        q = torch.stack([hi, lo], dim=-1).reshape(*packed.shape[:-1], packed.shape[-1] * 2)
        return (q.float() * d["scale"]).to(dtype)
    return (d[_QUANT_KEY].float() * d["scale"]).to(dtype)


def _map_with_path(fn, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a nested dict / list / tuple, paths joined
    with "/" as the JAX package's `_path_str` joins its key path."""
    if isinstance(tree, dict) and not is_quantized(tree):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _map_with_path(fn, v, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)
        )
    return fn(path, tree)


def quantize_pytree(
    tree: Any,
    *,
    skip_patterns: tuple[str, ...] = DEFAULT_SKIP_PATTERNS,
    min_size: int = 4096,
    stack_dim_patterns: tuple[tuple[str, int], ...] = DEFAULT_STACK_DIM_PATTERNS,
    bits: int = 8,
) -> Any:
    """Quantize the eligible float leaves (big matmul weights) of a nested
    dict; embeddings, the head and whatever matches ``skip_patterns`` stay
    full precision. Leaves stay on their device."""

    def visit(path: str, leaf: Any) -> Any:
        if not isinstance(leaf, torch.Tensor):
            return leaf
        eligible, stack = leaf_quant_plan(
            path, tuple(leaf.shape), leaf.dtype, skip_patterns=skip_patterns,
            min_size=min_size, stack_dim_patterns=stack_dim_patterns,
        )
        if not eligible:
            return leaf
        return quantize_array(leaf, stack_dims=stack, bits=bits)

    return _map_with_path(visit, tree)


def dequantize_pytree(tree: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    return _map_with_path(lambda _, x: dequantize_array(x, dtype) if is_quantized(x) else x, tree)


def has_quantized(tree: Any) -> bool:
    if is_quantized(tree):
        return True
    if isinstance(tree, dict):
        return any(has_quantized(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_quantized(v) for v in tree)
    return False


def quantized_nbytes(tree: Any) -> int:
    """Total bytes of the tensors of a (possibly partly quantized) tree."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(quantized_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(quantized_nbytes(v) for v in tree)
    return 0
