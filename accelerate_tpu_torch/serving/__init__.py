"""Continuous-batching serving (`serving.engine`) and its prefix cache."""

from .engine import (
    Completion,
    Engine,
    Request,
    default_buckets,
    poisson_trace,
    shared_prefix_trace,
)
from .prefix_cache import CacheNode, PrefixCache

__all__ = [
    "CacheNode",
    "Completion",
    "Engine",
    "PrefixCache",
    "Request",
    "default_buckets",
    "poisson_trace",
    "shared_prefix_trace",
]
