"""The single-device train core of the JAX package's `accelerator.py`:
`Accelerator`, `TrainState`, `create_train_state`, `make_train_step` and
`global_norm`.

The step follows the JAX `make_train_step`: params cast to the compute
dtype (autograd flows through the cast, so gradients land on the fp32
masters in fp32), an fp32 loss, the batch split into microbatches along
dim 0 with one generator per microbatch from (seed, step, microbatch),
gradients averaged, clipped by value and then by global norm
(``min(1, max_norm / (norm + 1e-6))``), and the optimizer update. PyTorch
runs eagerly, so there is no compile step; the update is in place (the JAX
step donates its state), and the returned state shares its params and
optimizer with the one passed in.

Under ``mixed_precision="fp8"`` the step runs the loss and its backward
inside `ops.fp8.fp8_matmuls`, and warns when no projection reached
`matmul_einsum` (the JAX `_warn_fp8_noop`).

Host offload of the optimizer: ``strategy=FsdpPlugin(offload_optimizer=
True)`` keeps the AdamW moments in pinned host memory and streams them
through the device around each update (`parallel.host_offload`); it needs
`host_offloaded_adamw` (a plain `optim.adamw` raises, as in JAX). With a
`host_offloaded_adamw` optimizer, offloaded or not, the global-norm clip is
not multiplied into the gradients: it is passed to the update as
``grad_scale`` and applied inside the fused-AdamW kernel (for fp32
gradients the same product, without a pass over every gradient).

Not ported yet, and absent from the signatures rather than ignored: the
mesh and the sharding strategies' placement, disk offload, the fp16 loss
scale, the non-finite guard, telemetry and the lint.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import numpy as np
import torch

from .ops.fp8 import fp8_hits, fp8_matmuls
from .parallel.host_offload import HostOffloadedAdamW, OffloadedAdamW
from .utils.dataclasses import FsdpPlugin, GradientAccumulationPlugin, MixedPrecisionPolicy
from .utils.environment import resolve_device
from .utils.tree import flatten, map_tree


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors])
    )


@dataclasses.dataclass
class TrainState:
    """step (host int), fp32 master params (a nested dict of leaf tensors
    that require grad) and the optimizer (its moments are the optimizer
    state)."""

    step: int
    params: Any
    opt_state: torch.optim.Optimizer

    def leaves(self) -> list[torch.Tensor]:
        return list(flatten(self.params).values())


def _warn_fp8_noop() -> None:
    warnings.warn(
        "mixed_precision='fp8' had no effect: the loss_fn never routed a matmul "
        "through accelerate_tpu_torch.ops.fp8.matmul_einsum, so the whole step ran "
        "in bf16. Use the port's model layers (or call matmul_einsum for your "
        "projections) to get fp8 matmuls.",
        stacklevel=3,
    )


def _microbatch_seed(seed: int, step: int, index: int) -> int:
    """A 63-bit seed, well mixed from (seed, step, microbatch)."""
    return int(np.random.SeedSequence([seed, step, index]).generate_state(1, np.uint64)[0] >> 1)


class Accelerator:
    """Single-device entry point: precision policy, accumulation, clipping,
    optimizer offload and the train step, on ``device`` (default CUDA;
    raises without one)."""

    def __init__(
        self,
        *,
        mixed_precision: str = "no",
        gradient_accumulation_steps: int = 1,
        gradient_accumulation_plugin: GradientAccumulationPlugin | None = None,
        max_grad_norm: float | None = None,
        max_grad_value: float | None = None,
        seed: int | None = None,
        strategy: FsdpPlugin | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        self.device = resolve_device(device)
        self.offload_optimizer = strategy is not None and strategy.offload_optimizer
        self.policy = MixedPrecisionPolicy.from_precision(mixed_precision)
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(gradient_accumulation_steps)
        self.gradient_accumulation_steps = gradient_accumulation_plugin.num_steps
        self.max_grad_norm = max_grad_norm
        self.max_grad_value = max_grad_value
        self.seed = 0 if seed is None else int(seed)

    def create_train_state(self, init_fn: Callable[[int], Any] | Any, tx: Any) -> TrainState:
        """``init_fn`` is ``(seed) -> params`` (called with the
        Accelerator's seed) or a params tree. Leaves move to the device
        (cast to ``policy.param_dtype`` when set) and become leaf tensors
        that require grad; ``tx.init`` builds the optimizer over them (a
        `host_offloaded_adamw` also gets their tree paths and, under
        ``offload_optimizer``, puts its moments on the host)."""
        offload_aware = isinstance(tx, HostOffloadedAdamW)
        if self.offload_optimizer and not offload_aware:
            raise ValueError(
                "offload_optimizer requires an offload-aware optimizer: use "
                "accelerate_tpu_torch.host_offloaded_adamw(...) instead of a plain "
                "optimizer; the streamed update must know the optimizer's math "
                "(the DeepSpeedCPUAdam requirement)."
            )
        params = init_fn(self.seed) if callable(init_fn) else init_fn
        pd = self.policy.param_dtype

        def master(x: torch.Tensor) -> torch.Tensor:
            x = x.to(self.device)
            if pd is not None and x.is_floating_point():
                x = x.to(pd)
            return x.detach().requires_grad_(x.is_floating_point())

        params = map_tree(master, params)
        named = {k: x for k, x in flatten(params).items() if x.requires_grad}
        leaves = list(named.values())
        opt = tx.init(leaves, list(named), offload=self.offload_optimizer) if offload_aware else tx.init(leaves)
        return TrainState(step=0, params=params, opt_state=opt)

    def make_train_step(
        self, loss_fn: Callable[..., Any], *, has_aux: bool = False
    ) -> Callable[[TrainState, Any], tuple[TrainState, dict[str, torch.Tensor]]]:
        """``loss_fn(params, batch, generator) -> loss`` (or ``(loss, aux)``
        with ``has_aux``; aux is dropped, as JAX drops it without
        ``extra_metrics_fn``). Returns ``step(state, batch) -> (state,
        metrics)`` with metrics ``{"loss"}`` plus ``"grad_norm"`` (the norm
        before clipping) when ``max_grad_norm`` is set."""
        accum = self.gradient_accumulation_steps
        policy = self.policy
        max_grad_norm, max_grad_value = self.max_grad_norm, self.max_grad_value

        def step_fn(state: TrainState, batch: Any) -> tuple[TrainState, dict[str, torch.Tensor]]:
            leaves = [p for p in state.leaves() if p.requires_grad]
            for p in leaves:
                p.grad = None
            microbatches = _split(batch, accum) if accum > 1 else [batch]
            loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
            for index, mb in enumerate(microbatches):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(_microbatch_seed(self.seed, state.step, index))
                # The backward runs inside the mode too (JAX reads it at
                # trace time, which covers the backward and the remat).
                with fp8_matmuls(policy.fp8):
                    out = loss_fn(policy.cast_for_compute(state.params), policy.cast_for_compute(mb), gen)
                    if policy.fp8 and fp8_hits() == 0:
                        _warn_fp8_noop()
                    loss = (out[0] if has_aux else out).float()
                    loss.backward()
                loss_sum += loss.detach()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
            if accum > 1:
                torch._foreach_div_(grads, float(accum))
            loss = loss_sum / accum
            metrics = {"loss": loss if policy.output_dtype is None else loss.to(policy.output_dtype)}
            if max_grad_value is not None:
                torch._foreach_clamp_min_(grads, -max_grad_value)
                torch._foreach_clamp_max_(grads, max_grad_value)
            fused = isinstance(state.opt_state, OffloadedAdamW)
            grad_scale = None
            if max_grad_norm is not None:
                gnorm = global_norm(grads)
                clip = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                if fused:
                    grad_scale = clip  # applied inside the fused update
                else:
                    torch._foreach_mul_(grads, clip)
                metrics["grad_norm"] = gnorm
            for p, g in zip(leaves, grads):
                p.grad = g
            if fused:
                state.opt_state.step(grad_scale=grad_scale)
            else:
                state.opt_state.step()
            return dataclasses.replace(state, step=state.step + 1), metrics

        return step_fn


def _split(batch: Any, accum: int) -> list[Any]:
    """The batch (a dict of tensors, or one tensor) as ``accum``
    microbatches along dim 0."""
    if isinstance(batch, dict):
        parts = {k: _split(v, accum) for k, v in batch.items()}
        return [{k: parts[k][i] for k in batch} for i in range(accum)]
    b = batch.shape[0]
    if b % accum != 0:
        raise ValueError(
            f"Global batch size {b} is not divisible by "
            f"gradient_accumulation_steps={accum}; adjust the "
            "dataloader batch size or the accumulation steps."
        )
    return list(batch.reshape((accum, b // accum) + tuple(batch.shape[1:])).unbind(0))
