"""Load the JAX package's Llama parameters into the port.

The port keeps the JAX parameter layout (layer-stacked ``blocks`` with
``attn.{wq,wk,wv,wo}``, ``attn_norm``, ``mlp_norm``,
``mlp.{w_gate,w_up,w_down}``, plus ``embed``, ``final_norm`` and
``lm_head``), so conversion is a copy of every leaf, checked against the
port's own layout for the config. The JAX tree arrives as numpy arrays
(``jax.device_get``); this module imports neither JAX nor its package.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..utils.environment import resolve_device
from ..utils.tree import flatten, nest
from .llama import LlamaConfig, Params, param_shapes


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: no numpy->torch path
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax(
    np_params: Mapping[str, Any],
    config: LlamaConfig,
    device: str | torch.device | None = None,
) -> Params:
    """JAX ``llama.init`` parameter tree (numpy leaves) -> the port's
    parameters on ``device`` (default CUDA), dtypes preserved. Raises on a
    missing, extra or misshapen leaf."""
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
        if tuple(np.shape(flat[key])) != shape:
            raise ValueError(f"{key}: shape {np.shape(flat[key])}, expected {shape}")
        out[key] = _to_tensor(flat[key], device)
    return nest(out)
