"""Kernel registry and launch counters.

The rule every wrapper in `native/` follows, with no knob to change it:

- a CUDA tensor launches the hand-written kernel, or the wrapper raises
  (wrong dtype, shape, layout, or a failed build) — there is no fallback
  on the card;
- a CPU tensor runs the kernel's plain PyTorch version (the CPU tests).

Each registered kernel carries a launch counter that its wrapper bumps
exactly where it launches, so a run can prove its main path went through
the kernel (`chip_smoke.py` zeroes the counts, drives the path, reads them).
Calls of the plain version by name never count.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass
class Kernel:
    name: str
    doc: str
    launches: int = 0


# name -> Kernel (introspection via `kernel_status`).
_REGISTRY: dict[str, Kernel] = {}


def register_kernel(name: str, doc: str = "") -> Kernel:
    """Get-or-create the registry entry for kernel ``name``."""
    kernel = _REGISTRY.get(name)
    if kernel is None:
        kernel = _REGISTRY[name] = Kernel(name, doc)
    return kernel


def kernel_status() -> list[dict[str, Any]]:
    """Registry snapshot: every registered kernel with its launch count."""
    return [
        {"kernel": k.name, "doc": k.doc, "launches": k.launches}
        for k in sorted(_REGISTRY.values(), key=lambda k: k.name)
    ]


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in _REGISTRY.values()}


def reset_launch_counts() -> None:
    for kernel in _REGISTRY.values():
        kernel.launches = 0
