"""The subset of the JAX package's `utils/dataclasses.py` that the train
step reads: the precision names, the mixed-precision policy, the
gradient-accumulation plugin and the FSDP strategy (whose
``offload_optimizer`` is what acts on one device).

fp8 computes in bf16 and routes every projection through the scaled fp8
products (`ops.fp8`), as in JAX. fp16, which needs the dynamic loss scale,
is not ported yet and raises NotImplementedError.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any

import torch


class PrecisionType(str, enum.Enum):
    NO = "no"
    BF16 = "bf16"
    FP16 = "fp16"
    FP8 = "fp8"


_DTYPES = {PrecisionType.NO: torch.float32, PrecisionType.BF16: torch.bfloat16}


@dataclass
class MixedPrecisionPolicy:
    """Dtype policy: master params as initialized (fp32), compute in
    ``compute_dtype``.

    ``param_dtype`` (None keeps the init dtype) is read by
    `Accelerator.create_train_state`, ``output_dtype`` by the train step's
    reported loss."""

    param_dtype: Any = None
    compute_dtype: Any = torch.float32
    output_dtype: Any = None
    # fp8 is not a blanket cast: activations and params stay bf16 at call
    # boundaries and the train step routes the projections through the
    # dynamically scaled e4m3/e5m2 products (`ops.fp8.fp8_matmuls`).
    fp8: bool = False

    @classmethod
    def from_precision(cls, precision: str | PrecisionType) -> "MixedPrecisionPolicy":
        precision = PrecisionType(precision)
        if precision == PrecisionType.FP8:
            return cls(compute_dtype=torch.bfloat16, fp8=True)
        if precision not in _DTYPES:
            raise NotImplementedError(
                f"mixed_precision={precision.value!r} is not ported yet "
                "(fp16 needs the dynamic loss scale)"
            )
        return cls(compute_dtype=_DTYPES[precision])

    def cast_for_compute(self, tree: Any) -> Any:
        """Floating tensors of a (nested dict / list / tuple) tree cast to
        ``compute_dtype``; autograd flows through the cast, so gradients
        reach the fp32 masters in fp32. Other leaves pass through."""
        if isinstance(tree, dict):
            return {k: self.cast_for_compute(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.cast_for_compute(v) for v in tree)
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return tree.to(self.compute_dtype)
        return tree


@dataclass
class GradientAccumulationPlugin:
    """Microbatches per optimizer step."""

    num_steps: int = 1

    def __post_init__(self) -> None:
        if self.num_steps < 1:
            raise ValueError(f"gradient accumulation steps must be >= 1, got {self.num_steps}")


@dataclass
class FsdpPlugin:
    """FSDP / ZeRO-3-style strategy, with the JAX package's fields and
    defaults. On one device only ``offload_optimizer`` acts: the optimizer
    moments live in host memory, pinned on a card, and stream through the
    device around the update (`parallel.host_offload`; it needs
    `host_offloaded_adamw`). ``min_weight_size`` (smaller tensors stay
    replicated) and ``state_dict_type`` change nothing on one device, as on
    the JAX package's 1 x 1 mesh.

    No environment variable is read: the port has no launcher, so a
    variable a JAX launch left behind (``ATX_OFFLOAD_OPTIMIZER``) must not
    change a port run."""

    min_weight_size: int = 2**11
    state_dict_type: str = "SHARDED_STATE_DICT"
    offload_optimizer: bool = False
