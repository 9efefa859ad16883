"""Multi-host wiring: `jax.distributed` behind the same mesh API.

The reference is strictly single-node shared memory (its `_mpi.hxx` is never
compiled — SURVEY §2.6); multi-host is our beyond-parity scaling axis.  The
model: one process per host, `init_distributed()` once at startup, then
`make_global_mesh()` — a 1-D mesh over every device of every process.  All
higher layers are process-count-agnostic:

* `shard_stream_for_mesh` materializes only each process's addressable blocks
  (`jax.make_array_from_callback`), so the slot stream is distributed across
  hosts — per-host memory = total/P + the replicated degree vector;
* the tile scan's top-k merge is one `all_gather` of [M, k] buffers, which XLA
  routes over NVLink within a host and the network across hosts;
* every process computes the same replicated result (standard JAX SPMD).

An end-to-end N-process CPU simulation lives in
`examples/multihost_sim/run.py` (spawns N coordinated processes on localhost
and asserts exactness against the single-process result).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["init_distributed", "make_global_mesh", "process_info"]


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
) -> None:
    """Initialize the process group (call before any other JAX use).

    With no arguments, reads ``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``; unset or
    ``JAX_NUM_PROCESSES<=1`` means a single process and nothing is
    initialized.  Nothing else is autodetected: a cluster signal such as
    ``SLURM_JOB_ID`` is set for every batch job, and acting on it made a
    single-process run block on a peer barrier that never formed.  A failed
    init raises — silently degrading to independent processes would produce
    P copies of the answer with no error.
    """
    import os

    import jax

    if coordinator_address is None and num_processes is None:
        env_np = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        if env_np <= 1:
            return
        coordinator_address = os.environ["JAX_COORDINATOR_ADDRESS"]
        num_processes = env_np
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def make_global_mesh(axis: str = "workers"):
    """A 1-D mesh over EVERY device of every connected process."""
    from .mesh import make_mesh

    return make_mesh(axis=axis)


def process_info() -> tuple[int, int]:
    """(process_index, process_count) of this host."""
    import jax

    return jax.process_index(), jax.process_count()
