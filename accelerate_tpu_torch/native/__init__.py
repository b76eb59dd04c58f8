"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

`dispatch` holds the registry and launch counters, `build` compiles
``csrc/*.cu`` with ``nvcc`` at first use; one module per kernel wraps it.
"""

from .dispatch import kernel_status, launch_counts, register_kernel, reset_launch_counts

__all__ = ["kernel_status", "launch_counts", "register_kernel", "reset_launch_counts"]
