"""Frozen dataclasses registered as JAX pytrees.

`@dataclass` makes a frozen dataclass whose fields are pytree leaves, with
a `.replace(**changes)` method; `field(static=True)` marks a field as static
metadata (part of the tree structure, hashed into jit cache keys).
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """A dataclass field; `static=True` keeps it out of the pytree leaves."""
    return dataclasses.field(metadata={"static": static}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
