"""Nested-dict parameter trees: flatten to dotted keys, nest back, map
over the leaves. A quantized-weight node (`utils.quantization`) is one
leaf, as the JAX package's ``is_leaf=is_quantized`` makes it."""

from __future__ import annotations

from typing import Any, Callable, Mapping

from .quantization import is_quantized


def flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """``{"a": {"b": x}}`` -> ``{"a.b": x}`` (the inverse of `nest`)."""
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else key
        if isinstance(value, Mapping) and not is_quantized(value):
            out.update(flatten(value, name))
        else:
            out[name] = value
    return out


def nest(flat: Mapping[str, Any]) -> dict[str, Any]:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    out: dict[str, Any] = {}
    for key, value in flat.items():
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf of a nested dict, keeping its shape."""
    if isinstance(tree, Mapping) and not is_quantized(tree):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)
