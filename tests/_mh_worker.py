"""Worker for the 2-process multi-host smoke test (tests/test_multihost.py).

Each process: force the CPU backend with 2 virtual local devices, join the
distributed runtime via the KPT_* env contract (parallel/multihost.py),
build the global mesh, and run a psum + a tiny sharded render-style reduce
across the simulated DCN (localhost gloo). Prints PSUM_OK/RENDER_OK.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

from kylespathtracer.parallel import multihost  # noqa: E402

assert multihost.initialize_from_env(), "env did not request multihost"

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from kylespathtracer.parallel import mesh as mesh_mod  # noqa: E402

info = multihost.process_info()
assert info["process_count"] == 2, info
assert info["global_devices"] == 4, info

mesh = multihost.global_mesh()


def f(x):
    return jax.lax.psum(jnp.sum(x), mesh_mod.DATA_AXIS)


mapped = jax.jit(
    jax.shard_map(f, mesh=mesh, in_specs=P(mesh_mod.DATA_AXIS), out_specs=P())
)
# Each process contributes its local rows of a global (8, 4) array of ones.
local = jnp.ones((4, 4), jnp.float32)
garr = jax.make_array_from_process_local_data(
    jax.NamedSharding(mesh, P(mesh_mod.DATA_AXIS)), local, (8, 4)
)
total = mapped(garr)
# out_specs=P() -> replicated: every process holds the full value.
val = float(total.addressable_shards[0].data)
assert val == 32.0, val
print("PSUM_OK", flush=True)

# A sharded mini render step: scene-grad style pmean across all devices
# (axis indices 0..3 -> mean of 2*(1..4) = 5).
g = jax.jit(
    jax.shard_map(
        lambda x: jax.lax.pmean(x * (1.0 + jax.lax.axis_index(mesh_mod.DATA_AXIS)),
                                mesh_mod.DATA_AXIS),
        mesh=mesh, in_specs=P(), out_specs=P(),
    )
)(jnp.asarray(2.0))
gval = float(g.addressable_shards[0].data)
assert abs(gval - 5.0) < 1e-6, gval
print("RENDER_OK", flush=True)
