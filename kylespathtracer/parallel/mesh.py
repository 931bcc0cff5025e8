"""Device mesh + sharding helpers.

The reference's only parallelism is the GL fragment stage on one GPU
(SURVEY §2.3); here the pixel grid is the data axis: image rows are sharded
over a 1-D `jax.sharding.Mesh` ("data"), the scene pytree is replicated, and
XLA/GSPMD inserts the collectives (reprojection cross-shard gathers, scene
gradient all-reduce) automatically. Multi-host runs use the same code after
`jax.distributed.initialize()` — collective routing is XLA's job.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D data mesh over the first n devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (row) axis of image-shaped arrays."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_image_pytree(tree, mesh: Mesh, height: int):
    """Place every leaf whose leading dim == height on the row sharding and
    replicate the rest (cameras, scalars)."""
    rows = row_sharding(mesh)
    rep = replicated(mesh)

    def place(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == height:
            return jax.device_put(x, rows)
        return jax.device_put(x, rep)

    return jax.tree_util.tree_map(place, tree)
