"""Optimizers with the semantics of the optax transformations the JAX
package trains with.

`adamw` matches ``optax.adamw`` (whose weight decay defaults to 1e-4, where
``torch.optim.AdamW`` defaults to 0.01, and decays every leaf): it builds a
``torch.optim.AdamW(foreach=True)`` over the master params. The update is
the same, because decoupled decay of the old parameter commutes with the
Adam term: optax's ``p - lr * (adam + wd * p)`` is torch's
``p * (1 - lr * wd) - lr * adam``. ``fused=True`` is not used: PyTorch's
fused optimizer is only the yardstick of the port's own fused-AdamW
kernel, which `host_offloaded_adamw` (`parallel.host_offload`) runs.
Learning-rate schedules are not ported here yet (`host_offloaded_adamw`
takes them).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AdamW:
    """An optax-style transformation: `init` builds the optimizer (its
    moments are the optimizer state) over a list of master params."""

    learning_rate: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4

    def __post_init__(self) -> None:
        if not isinstance(self.learning_rate, (int, float)):
            raise NotImplementedError("learning-rate schedules are not ported yet; pass a float")

    def init(self, params: list[torch.Tensor]) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            params,
            lr=float(self.learning_rate),
            betas=(self.b1, self.b2),
            eps=self.eps,
            weight_decay=self.weight_decay,
            foreach=True,
        )


def adamw(
    learning_rate: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
) -> AdamW:
    """``optax.adamw`` (eps_root 0, no mask) with a scalar learning rate."""
    return AdamW(learning_rate, b1, b2, eps, weight_decay)
