"""Checkpoint / resume.

The reference loses all state on exit (GPU textures + 3 global vec3s,
main.cpp:41-44). Here any pytree of frame state — history buffers, camera,
scene parameters, optimizer state, RNG counters — serializes to one numpy
`.npz` file per step, so a rendering or inverse-rendering run is
deterministically resumable.

Each step is written to a temporary file and renamed into place, so a
process killed mid-write leaves either the previous set of steps or the
complete new one, never a torn file. Leaves keep their exact dtype and bits.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import numpy as np


def _path(root: Path, step: int) -> Path:
    return root / f"step_{step}.npz"


def steps(directory) -> list[int]:
    """The complete checkpoint steps under `directory`, ascending."""
    root = Path(directory)
    found = []
    for p in root.glob("step_*.npz"):
        tag = p.name[len("step_"):-len(".npz")]
        if tag.isdigit():
            found.append(int(tag))
    return sorted(found)


def save(directory, step: int, state) -> str:
    """Serialize a state pytree as `directory/step_{step}.npz`; returns path."""
    root = Path(directory).resolve()
    root.mkdir(parents=True, exist_ok=True)
    leaves = jax.device_get(jax.tree_util.tree_leaves(state))
    arrays = {f"leaf_{i:05d}": np.asarray(l) for i, l in enumerate(leaves)}
    path = _path(root, step)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return str(path)


def restore(directory, like, step: int | None = None):
    """Restore `(step, state)`; the latest step if not given. `like` is a
    pytree of the expected structure (its leaves give shapes and dtypes)."""
    root = Path(directory).resolve()
    if step is None:
        avail = steps(root)
        if not avail:
            raise FileNotFoundError(f"no checkpoints under {root}")
        step = avail[-1]
    ref_leaves, treedef = jax.tree_util.tree_flatten(like)
    with np.load(_path(root, step)) as data:
        leaves = [data[f"leaf_{i:05d}"] for i in range(len(data.files))]
    if len(leaves) != len(ref_leaves):
        raise ValueError(
            f"checkpoint step {step} holds {len(leaves)} leaves, the "
            f"expected structure has {len(ref_leaves)}"
        )
    for i, (got, ref) in enumerate(zip(leaves, ref_leaves)):
        if got.shape != np.shape(ref):
            raise ValueError(
                f"checkpoint leaf {i}: shape {got.shape} != {np.shape(ref)}"
            )
    return step, jax.tree_util.tree_unflatten(
        treedef, [jax.numpy.asarray(l) for l in leaves]
    )
