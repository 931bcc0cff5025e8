"""utils/struct.py: the pytree dataclass that replaces flax.struct."""

import jax
import jax.numpy as jnp
import pytest

from kylespathtracer.scene import default_scene
from kylespathtracer.utils import struct


@struct.dataclass
class _Pair:
    a: jnp.ndarray
    b: jnp.ndarray
    tag: int = struct.field(static=True, default=0)


def test_pytree_replace_and_static_field():
    p = _Pair(a=jnp.ones(2), b=jnp.zeros(3), tag=5)
    leaves, treedef = jax.tree_util.tree_flatten(p)
    assert len(leaves) == 2  # the static field is not a leaf
    q = jax.tree_util.tree_unflatten(treedef, [l + 1 for l in leaves])
    assert q.tag == 5 and float(q.b[0]) == 1.0
    r = p.replace(a=jnp.full(2, 4.0))
    assert float(r.a[0]) == 4.0 and r.tag == 5 and float(p.a[0]) == 1.0
    with pytest.raises(Exception):
        p.a = jnp.ones(2)  # frozen
    # jit sees the static field in the tree structure, not as a tracer.
    assert jax.jit(lambda x: x.a * x.tag)(p)[0] == 5.0
    # The scene keeps its light index static.
    scene = default_scene()
    assert all(hasattr(l, "dtype") for l in jax.tree_util.tree_leaves(scene))
    assert jax.tree_util.tree_structure(scene) == jax.tree_util.tree_structure(
        scene.replace(light_color=scene.light_color * 2)
    )
