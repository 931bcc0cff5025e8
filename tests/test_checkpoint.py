"""utils/checkpoint.py: bit-exact round trip of every dtype, and a torn
write (a process killed before the rename) is never taken for a step."""

import numpy as np
import jax.numpy as jnp
import pytest

from kylespathtracer.utils import checkpoint as ck


def test_roundtrip_is_bit_exact(tmp_path):
    state = {
        "f": jnp.asarray([1.0, -0.0, np.nan, 1e-38], jnp.float32),
        "i": jnp.arange(5, dtype=jnp.int32),
        "b": jnp.asarray([True, False]),
        "nested": ({"count": jnp.asarray(7, jnp.int32)}, None),
    }
    ck.save(tmp_path, 3, state)
    step, got = ck.restore(tmp_path, like=state)
    assert step == 3
    for a, b in zip(jax_leaves(state), jax_leaves(got)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError, match="leaves"):
        ck.restore(tmp_path, like={"f": state["f"]})


def test_torn_write_is_ignored(tmp_path):
    ck.save(tmp_path, 1, {"x": jnp.ones(3)})
    ck.save(tmp_path, 2, {"x": jnp.full(3, 2.0)})
    # A write killed before its rename leaves only the temporary file.
    (tmp_path / "step_3.npz.tmp").write_bytes(b"partial")
    assert ck.steps(tmp_path) == [1, 2]
    step, got = ck.restore(tmp_path, like={"x": jnp.zeros(3)})
    assert step == 2 and float(got["x"][0]) == 2.0
    with pytest.raises(FileNotFoundError):
        ck.restore(tmp_path / "empty", like={"x": jnp.zeros(3)})


def jax_leaves(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)
