"""Parallelism and memory tiers of the port. So far: the offload-aware
AdamW of `host_offload` (moments on the device or in pinned host memory)."""

from .host_offload import HostOffloadedAdamW, OffloadedAdamW, host_offloaded_adamw, streaming_adamw_update

__all__ = ["HostOffloadedAdamW", "OffloadedAdamW", "host_offloaded_adamw", "streaming_adamw_update"]
