"""Multi-host launch path.

The reference is a single-GPU windowed app (main.cpp:298-363); this
framework scales over hosts: every host runs the same program,
`jax.distributed.initialize` wires the processes into one JAX runtime, and
the existing mesh/shard code (parallel.mesh, parallel.shard) then sees all
devices, with collectives routed by XLA.

Launch contract (env-driven so the same code runs under any scheduler):

    KPT_COORDINATOR   host:port of process 0          (required on >1 host)
    KPT_NUM_PROCESSES total process count             (required on >1 host)
    KPT_PROCESS_ID    this process's rank             (required on >1 host)

All three or none must be set. A 2-process CPU smoke test lives in
tests/test_multihost.py (subprocesses over localhost).
"""

from __future__ import annotations

import os

import jax

_INITIALIZED = False


def initialize_from_env() -> bool:
    """Initialize the distributed runtime if the env asks for it.

    Returns True when running multi-process (after initialize), False for
    the ordinary single-process case. Safe to call more than once.
    """
    global _INITIALIZED
    if _INITIALIZED:
        return True

    coord = os.environ.get("KPT_COORDINATOR")
    nproc = os.environ.get("KPT_NUM_PROCESSES")
    pid = os.environ.get("KPT_PROCESS_ID")

    if coord is None and nproc is None:
        return False

    if not (coord and nproc and pid is not None):
        raise ValueError(
            "multi-host launch needs KPT_COORDINATOR, KPT_NUM_PROCESSES and "
            "KPT_PROCESS_ID (or none of them)"
        )
    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=int(nproc),
        process_id=int(pid),
    )
    _INITIALIZED = True
    return True


def process_info() -> dict:
    """Host/process topology for logs and metrics."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def global_mesh():
    """1-D "data" mesh over all global devices (call after
    initialize_from_env)."""
    from kylespathtracer.parallel.mesh import make_mesh

    return make_mesh(None)
