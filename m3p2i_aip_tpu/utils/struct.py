"""Frozen dataclasses that are JAX pytrees.

``@struct.dataclass`` freezes the class, registers it with
``jax.tree_util.register_dataclass`` and adds ``.replace(**changes)``.
Fields made with ``struct.field(pytree_node=False)`` are static metadata
(part of the treedef, so part of the jit signature); every other field is a
traced leaf.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` that records whether the field is a leaf."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = dataclasses.replace
    return cls
