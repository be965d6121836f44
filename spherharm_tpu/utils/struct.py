"""Frozen dataclasses registered as JAX pytrees.

``dataclass`` makes a frozen dataclass whose fields are pytree leaves,
except those declared with ``field(pytree_node=False)``, which are static
metadata (part of the tree structure, so a change recompiles).
``replace(**changes)`` returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=meta)
