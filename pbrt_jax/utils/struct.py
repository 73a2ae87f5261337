"""Frozen dataclasses that are JAX pytrees.

`dataclass` registers the class with `jax.tree_util.register_dataclass`:
fields declared with `field(pytree_node=False)` are static metadata (part
of the jit cache key), every other field is a pytree child. Instances get
a `replace(**changes)` method, as `dataclasses.replace`.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node=True, **kwargs):
    """dataclasses.field with a `pytree_node` flag in its metadata."""
    metadata = dict(kwargs.pop("metadata", None) or {}, pytree_node=pytree_node)
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree (static fields: metadata)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
