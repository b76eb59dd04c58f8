"""Offload-aware AdamW: the port of the JAX package's
`parallel/host_offload.py`, the ZeRO-Offload analog.

`host_offloaded_adamw(...)` gives a `HostOffloadedAdamW`, whose `init`
builds `OffloadedAdamW`, a `torch.optim.Optimizer` with ``optax.adamw``'s
math (weight decay 1e-4 by default, an optional learning-rate schedule and
moment dtype). Every leaf's update is one launch of the fused-AdamW kernel
(`native.fused_adamw`, the port of TPU kernel 10), which adds the update
into the fp32 master in place.

- **Device-resident** (``offload=False``): the moments live beside the
  params and `step()` updates each leaf whole.
- **Offloaded** (``offload=True``, which `Accelerator(strategy=
  FsdpPlugin(offload_optimizer=True))` asks for): the float moments live
  in host memory, pinned when the params are on a card, and `step()` is
  `streaming_adamw_update`: every leaf under ``stacked_paths`` (the layer
  axis leads) goes one layer slice at a time, its moment slices copied to
  the device on one copy stream, updated by the kernel on the current
  stream, and copied back on a second copy stream, through a ring of
  device slots, so that the next slice's upload and the last one's
  download overlap the kernel. Other leaves round-trip whole. On the CPU
  the device *is* the host: the moments are plain CPU tensors and the
  same loop runs with synchronous copies (the CPU tests' path).

The JAX package runs its streamed update inside the jitted step (a
``lax.scan`` whose per-layer DMAs XLA schedules); PyTorch runs eagerly, so
the streams and events here do that scheduling. Device memory holds the
params, the gradients and a few slices of moments instead of all of them:
16 bytes a parameter become 8 plus the slots.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Sequence

import torch

from ..native.fused_adamw import fused_adamw, update_scalars

# Past this many bytes of moments outside the stacked paths, which
# round-trip through device memory whole, offload loses the headroom it
# exists to make (the JAX package's 2 GiB warning).
UNSTACKED_WARN_BYTES = 2 << 30
# Device slots of the streamed update: three, so that one slice's upload,
# another's kernel and a third's download can all be in flight.
STREAM_SLOTS = 3


def _adamw_slice(g, mu, nu, p, count, lr_t, b1, b2, eps, weight_decay, grad_scale=None):
    """One AdamW step for one leaf (or one layer slice of one): returns
    ``(update, new_mu, new_nu)`` in the moment dtype and changes nothing.
    The plain version of the fused-AdamW kernel, in the JAX body's order of
    operations. ``count`` is the host-int count of this update;
    ``grad_scale`` an optional fp32 tensor that multiplies g (the folded
    global-norm clip, so the caller never materializes a scaled copy of
    the gradients).

    Every scalar is a tensor of the moment dtype on the operands' device
    (`update_scalars`), so every divide is an IEEE divide: PyTorch on the
    card turns a divide by a Python scalar into a multiply by its
    reciprocal."""
    dt, dev = mu.dtype, mu.device
    s = update_scalars(count, lr_t, b1, b2, eps, weight_decay, dt)

    def c(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=dt, device=dev)

    g32 = g.to(dt)
    if grad_scale is not None:
        g32 = g32 * grad_scale.to(dt)
    new_mu = c(s.b1) * mu + c(s.one_minus_b1) * g32
    new_nu = c(s.b2) * nu + c(s.one_minus_b2) * torch.square(g32)
    mu_hat = new_mu / c(s.bias_correction1)
    nu_hat = new_nu / c(s.bias_correction2)
    step = mu_hat / (torch.sqrt(nu_hat) + c(s.eps)) + c(s.weight_decay) * p.to(dt)
    return c(s.neg_lr) * step, new_mu, new_nu


@dataclasses.dataclass(frozen=True)
class HostOffloadedAdamW:
    """An optax-style transformation that knows its own math, so that the
    offloaded update can re-derive it per layer slice (the JAX package's
    NamedTuple of the same name). `init` builds the optimizer."""

    learning_rate: float | Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    mu_dtype: torch.dtype | None = None
    # Top-level keys of the param tree whose leaves are layer-stacked
    # (leading dim = n_layers): their moments stream one layer at a time.
    stacked_paths: tuple[str, ...] = ("blocks",)

    def lr_at(self, count: int) -> float:
        """The learning rate of the update that follows ``count`` earlier
        ones: optax's convention, the schedule sees the count of previous
        updates (``schedule(0)`` on the first)."""
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(
        self, params: Sequence[torch.Tensor], names: Sequence[str] | None = None, *, offload: bool = False
    ) -> "OffloadedAdamW":
        """The optimizer over ``params`` (the master leaves). ``names`` are
        their dotted tree paths (`utils.tree.flatten`'s keys), which say
        which leaves are stacked; ``offload`` puts the moments on the
        host."""
        return OffloadedAdamW(params, self, names=names, offload=offload)


def host_offloaded_adamw(
    learning_rate: float | Callable[[int], float],
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
    mu_dtype: torch.dtype | None = None,
    stacked_paths: tuple[str, ...] = ("blocks",),
) -> HostOffloadedAdamW:
    """AdamW that the offloaded train step can stream layer by layer (the
    DeepSpeed CPU-Adam requirement: offload must know the optimizer's
    math). Without offload it is ``optax.adamw`` (eps_root 0, no mask) with
    the moments in ``mu_dtype`` (default: the param dtype)."""
    return HostOffloadedAdamW(learning_rate, b1, b2, eps, weight_decay, mu_dtype, tuple(stacked_paths))


def is_stacked(name: str, p: torch.Tensor, stacked_paths: Sequence[str]) -> bool:
    """Is the leaf at dotted path ``name`` layer-stacked (streamed one
    layer slice at a time)?"""
    return name.split(".")[0] in stacked_paths and p.dim() >= 2


def host_moments(shape, dtype: torch.dtype, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero mu and nu of an offloaded leaf, on the host: pinned when the
    params are on a card (so the copies are asynchronous DMAs), plain CPU
    tensors when the params are on the CPU, where the device is the host.
    Both moments share one block: the pinned allocator rounds each block up
    to a power of two, so one block a leaf wastes less than two."""
    pair = torch.zeros((2, *shape), dtype=dtype, pin_memory=device.type == "cuda")
    return pair[0], pair[1]


class OffloadedAdamW(torch.optim.Optimizer):
    """AdamW with optax's math through the fused-AdamW kernel, its moments
    beside the params or on the host (see the module note). State: ``mu``
    and ``nu`` per param, and one host-int ``count`` of updates so far.

    ``step(grad_scale=None)`` updates every param that has a gradient, in
    place; ``grad_scale`` (a one-element fp32 tensor on the params' device)
    multiplies the gradients inside the kernel. With offload on a card the
    host moments are written by copies the current stream waits for at the
    end of `step()`: synchronize before reading them on the host."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        tx: HostOffloadedAdamW,
        names: Sequence[str] | None = None,
        offload: bool = False,
    ) -> None:
        params = list(params)
        names = [str(i) for i in range(len(params))] if names is None else list(names)
        if len(names) != len(params):
            raise ValueError(f"{len(names)} names for {len(params)} params")
        super().__init__(params, {"lr": tx.learning_rate, "betas": (tx.b1, tx.b2), "eps": tx.eps,
                                  "weight_decay": tx.weight_decay})
        self.tx = tx
        self.offload = offload
        self.count = 0
        self.names = dict(zip(map(id, params), names))
        self._streams: tuple[torch.cuda.Stream, torch.cuda.Stream] | None = None
        unstacked_bytes = 0
        for p, name in zip(params, names):
            dt = tx.mu_dtype or p.dtype
            if offload:
                mu, nu = host_moments(p.shape, dt, p.device)
                if not is_stacked(name, p, tx.stacked_paths):
                    unstacked_bytes += 2 * mu.numel() * mu.element_size()
            else:
                mu, nu = torch.zeros_like(p, dtype=dt), torch.zeros_like(p, dtype=dt)
            self.state[p] = {"mu": mu, "nu": nu}
        if unstacked_bytes > UNSTACKED_WARN_BYTES:
            # Whole-leaf round trips are device temporaries; past ~2 GiB
            # they erode the headroom offload exists to create.
            warnings.warn(
                f"{unstacked_bytes / 2**30:.1f} GiB of offloaded moments belong to leaves "
                f"outside the declared layer-stacked paths {tx.stacked_paths}; they "
                "round-trip through device memory whole. If the model stacks its layers "
                "under a different key, pass host_offloaded_adamw(..., stacked_paths=(<key>,)).",
                stacklevel=3,
            )

    def leaves(self) -> list[tuple[torch.Tensor, str]]:
        """(param, tree path) of every param that has a gradient."""
        return [(p, self.names[id(p)]) for group in self.param_groups for p in group["params"]
                if p.grad is not None]

    def _copy_streams(self, device: torch.device) -> tuple[torch.cuda.Stream, torch.cuda.Stream]:
        """The (host-to-device, device-to-host) copy streams, made once."""
        if self._streams is None:
            self._streams = (torch.cuda.Stream(device), torch.cuda.Stream(device))
        return self._streams

    @torch.no_grad()
    def step(self, closure: Callable[[], Any] | None = None, grad_scale: torch.Tensor | None = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        lr_t = self.tx.lr_at(self.count)
        self.count += 1
        if self.offload:
            streaming_adamw_update(self, lr_t, grad_scale)
        else:
            tx = self.tx
            for p, _ in self.leaves():
                st = self.state[p]
                fused_adamw(p.grad, st["mu"], st["nu"], p, self.count, lr_t, tx.b1, tx.b2, tx.eps,
                            tx.weight_decay, grad_scale, apply=True)
        return loss


@dataclasses.dataclass
class _Slot:
    """One pair of device byte buffers for moment slices, and the event
    after which its last download has read it."""

    mu: torch.Tensor
    nu: torch.Tensor
    free: torch.cuda.Event | None = None

    def views(self, mu: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The front of each buffer as a tensor of ``mu``'s shape and dtype."""
        nbytes = mu.numel() * mu.element_size()
        return tuple(b[:nbytes].view(mu.dtype).view(mu.shape) for b in (self.mu, self.nu))


class _CopyPipeline:
    """Moves moment slices between host and device around the kernel, which
    runs on the current stream. On CUDA: uploads on one copy stream, each
    waiting until its slot's last download is done, then the current
    stream waits for the upload; downloads on the other copy stream after
    the kernel. On the CPU every copy is synchronous."""

    def __init__(self, opt: OffloadedAdamW, device: torch.device) -> None:
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(device)
            self.h2d, self.d2h = opt._copy_streams(device)
            # The slots were just allocated on the current stream.
            self.h2d.wait_stream(self.compute)
            self.d2h.wait_stream(self.compute)

    def load(self, slot: _Slot, mu: torch.Tensor, nu: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``mu``/``nu`` (host) into the front of ``slot``, as device views
        of their shape that the current stream may read."""
        dmu, dnu = slot.views(mu)
        if not self.cuda:
            dmu.copy_(mu)
            dnu.copy_(nu)
            return dmu, dnu
        if slot.free is not None:
            self.h2d.wait_event(slot.free)
        with torch.cuda.stream(self.h2d):
            dmu.copy_(mu, non_blocking=True)
            dnu.copy_(nu, non_blocking=True)
        self.compute.wait_event(self.h2d.record_event())
        return dmu, dnu

    def store(self, slot: _Slot, dmu, dnu, mu: torch.Tensor, nu: torch.Tensor) -> None:
        """The slot's updated slices back to the host, after the kernel."""
        if not self.cuda:
            mu.copy_(dmu)
            nu.copy_(dnu)
            return
        self.d2h.wait_event(self.compute.record_event())
        with torch.cuda.stream(self.d2h):
            mu.copy_(dmu, non_blocking=True)
            nu.copy_(dnu, non_blocking=True)
        slot.free = self.d2h.record_event()

    def finish(self) -> None:
        """The current stream waits for every copy, so the slots may be
        freed and the next step's uploads see this step's downloads."""
        if self.cuda:
            self.compute.wait_stream(self.d2h)
            self.compute.wait_stream(self.h2d)


def streaming_adamw_update(opt: OffloadedAdamW, lr_t: float, grad_scale: torch.Tensor | None = None) -> None:
    """The offloaded update of `OffloadedAdamW.step` (count already
    advanced): each stacked leaf one layer slice at a time, every other
    leaf whole, each slice or leaf one kernel launch on device copies of
    its host moments, the params updated in place."""
    tx = opt.tx
    stacked, whole = [], []  # (param, grad, host mu, host nu, stacked)
    for p, name in opt.leaves():
        st = opt.state[p]
        if is_stacked(name, p, tx.stacked_paths):
            stacked += [(p[i], p.grad[i], st["mu"][i], st["nu"][i], True) for i in range(p.shape[0])]
        else:
            whole.append((p, p.grad, st["mu"], st["nu"], False))
    # One whole leaf before the slices and the others after them: the
    # whole slot's next user then waits on a download that finished long
    # before, where back to back it would stall the upload stream.
    items = whole[:1] + stacked + whole[1:]
    if not items:
        return
    device = items[0][0].device

    def slot(nbytes: int) -> _Slot:
        return _Slot(*(torch.empty(nbytes, dtype=torch.uint8, device=device) for _ in range(2)))

    def nbytes(t: torch.Tensor) -> int:
        return t.numel() * t.element_size()

    stacked_max = max((nbytes(it[2]) for it in items if it[4]), default=0)
    whole_max = max((nbytes(it[2]) for it in items if not it[4]), default=0)
    ring = [slot(stacked_max) for _ in range(STREAM_SLOTS)] if stacked_max else []
    whole = slot(whole_max) if whole_max else None
    pipe = _CopyPipeline(opt, device)
    k = 0
    for p, g, mu, nu, stacked in items:
        if stacked:
            s = ring[k % STREAM_SLOTS]
            k += 1
        else:
            s = whole
        dmu, dnu = pipe.load(s, mu, nu)
        fused_adamw(g, dmu, dnu, p, opt.count, lr_t, tx.b1, tx.b2, tx.eps, tx.weight_decay,
                    grad_scale, apply=True)
        pipe.store(s, dmu, dnu, mu, nu)
    pipe.finish()
