"""Environment-variable helpers and device resolution.

The env parsers are this package's own copy of the JAX package's
(``ATX_`` prefix, same semantics), so the two packages read one knob set.
"""

from __future__ import annotations

import os

import torch

_TRUE = {"1", "true", "yes", "y", "on"}
_FALSE = {"0", "false", "no", "n", "off", ""}


def str_to_bool(value: str) -> bool:
    value = value.strip().lower()
    if value in _TRUE:
        return True
    if value in _FALSE:
        return False
    raise ValueError(f"Cannot interpret {value!r} as a boolean")


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    value = os.environ.get(key)
    if value is None:
        return default
    return str_to_bool(value)


def get_int_from_env(keys: list[str] | tuple[str, ...], default: int) -> int:
    for key in keys:
        value = os.environ.get(key)
        if value is not None and value != "":
            return int(value)
    return default


def get_str_from_env(keys: list[str] | tuple[str, ...], default: str = "") -> str:
    for key in keys:
        value = os.environ.get(key)
        if value is not None and value != "":
            return value
    return default


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises when CUDA is asked for and absent — the port never moves to the
    CPU on its own; callers that want the plain PyTorch path pass
    ``device="cpu"`` explicitly (the CPU tests do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
