"""Load the JAX package's Llama parameters into the port.

The port keeps the JAX parameter layout (layer-stacked ``blocks`` with
``attn.{wq,wk,wv,wo}``, ``attn_norm``, ``mlp_norm``,
``mlp.{w_gate,w_up,w_down}``, plus ``embed``, ``final_norm`` and
``lm_head``), so conversion is a copy of every leaf, checked against the
port's own layout for the config. The JAX tree arrives as numpy arrays
(``jax.device_get``); this module imports neither JAX nor its package.

A tree from the JAX `quantize_pytree` comes across node for node: each
``{"__quant__" | "__quant4__", "scale"}`` node keeps its int8 / uint8
values and fp32 scale (`utils.quantization` has the layout), checked
against the parameter's shape (the packed int4 last axis is half of it).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..utils.environment import resolve_device
from ..utils.quantization import _QUANT4_KEY, _QUANT_KEY, is_quantized
from ..utils.tree import flatten, nest
from .llama import LlamaConfig, Params, param_shapes


# ml_dtypes float8 arrays cross as their bytes (a uint8 view), bit for bit.
_FLOAT8 = {"float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2}


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: no numpy->torch path
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    if a.dtype.name in _FLOAT8:
        raw = torch.from_numpy(np.array(a).view(np.uint8))
        return raw.view(_FLOAT8[a.dtype.name]).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _values_shape(leaf: Any) -> tuple[int, ...]:
    """The parameter shape a leaf stands for (a packed int4 node holds half
    of the last axis)."""
    if is_quantized(leaf):
        if _QUANT4_KEY in leaf:
            *lead, last = np.shape(leaf[_QUANT4_KEY])
            return (*lead, 2 * last)
        return tuple(np.shape(leaf[_QUANT_KEY]))
    return tuple(np.shape(leaf))


def _leaf_to_tensor(leaf: Any, device: torch.device) -> Any:
    if is_quantized(leaf):
        return {k: _to_tensor(v, device) for k, v in leaf.items()}
    return _to_tensor(leaf, device)


def params_from_jax(
    np_params: Mapping[str, Any],
    config: LlamaConfig,
    device: str | torch.device | None = None,
) -> Params:
    """JAX ``llama.init`` parameter tree (numpy leaves, or quantized nodes of
    numpy arrays) -> the port's parameters on ``device`` (default CUDA),
    dtypes preserved. Raises on a missing, extra or misshapen leaf."""
    device = resolve_device(device)
    flat = flatten(np_params)
    want = param_shapes(config)
    if set(flat) != set(want):
        raise ValueError(
            f"parameter tree mismatch: missing {sorted(set(want) - set(flat))}, "
            f"unexpected {sorted(set(flat) - set(want))}"
        )
    out = {}
    for key, shape in want.items():
        if _values_shape(flat[key]) != shape:
            raise ValueError(f"{key}: shape {_values_shape(flat[key])}, expected {shape}")
        out[key] = _leaf_to_tensor(flat[key], device)
    return nest(out)
