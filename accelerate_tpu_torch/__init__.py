"""PyTorch / CUDA port of `accelerate_tpu`, for NVIDIA Hopper (H100, sm_90a).

The JAX package beside this one is the reference; this package imports
neither it nor JAX. It ports the framework slice by slice:

- `models.llama` / `models.layers`: the Llama decoder's cached forward
  (prefill and decode over a layer-stacked KV cache, bf16/fp32/int8) and
  its training forward and loss, with the remat policies;
- `generation`: the fixed-batch generation loop;
- `serving`: the continuous-batching `Engine` with its prefix cache;
- `accelerator`, `optim`, `utils.dataclasses`: the single-device train
  step (mixed precision, accumulation, clipping, AdamW);
- `ops.flash_attention`: flash attention with its autograd backward;
- `ops.fp8`, `ops.int8`, `utils.quantization`: fp8 training matmuls
  (`mixed_precision="fp8"`), weight-only int8 / int4 trees and int8
  products on them (`int8_compute`);
- `parallel.host_offload`: `host_offloaded_adamw`, AdamW through the
  fused-AdamW kernel with its moments on the device or streamed from
  pinned host memory (``FsdpPlugin(offload_optimizer=True)``);
- `native`: hand-written CUDA kernels (built with ``nvcc`` at first use)
  and the plain PyTorch version beside each one.

Every entry point takes ``device=`` and defaults to ``"cuda"``; without a
card it raises (`utils.environment.resolve_device`). Kernels launch on CUDA
tensors; a CPU tensor takes the kernel's plain version (the CPU tests).
"""

from .parallel.host_offload import host_offloaded_adamw
from .utils.dataclasses import FsdpPlugin
from .utils.environment import resolve_device

__version__ = "0.1.0"

__all__ = ["FsdpPlugin", "host_offloaded_adamw", "resolve_device", "__version__"]
