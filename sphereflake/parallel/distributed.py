"""Multi-host distribution: process init + global mesh construction.

The reference is strictly single-machine — its "cluster" is
`hardware_concurrency()` threads over shared memory
(`Sphereflake.cpp:67-74`). This framework scales the same workload
across hosts: `jax.distributed.initialize` brings up the process group,
every process contributes its
local devices to one global 2D tile mesh, and the existing shard_map
render/fit programs run unchanged — tile assignment is
placement-invariant, so N-host output equals 1-host output.

CPU CI shape: the same code paths run as N processes x M virtual
host-platform devices (`tools/multihost_worker.py`), which is how the
multi-process tests exercise cross-process collectives without GPUs.
"""

from __future__ import annotations

import os

import jax

from sphereflake.parallel.mesh import make_mesh


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
) -> None:
    """Bring up the JAX process group (idempotent for single process).

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID), which
    also lets cluster launchers that pre-set that env work with no
    arguments at all.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if num_processes <= 1:
        return  # single-process: nothing to initialize
    if coordinator_address is None:
        raise ValueError(
            "multi-process run needs a coordinator address "
            "(JAX_COORDINATOR_ADDRESS or coordinator_address=)"
        )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_mesh(shape=None):
    """2D tile mesh over ALL processes' devices (call after init).

    Rows are laid out so that each host's local devices form contiguous
    row-bands where possible — forward rendering then needs no
    cross-host traffic at all (rays are independent), and only the
    backward gradient psum rides DCN.
    """
    return make_mesh(jax.devices(), shape=shape)


def process_info() -> tuple[int, int]:
    """(process_index, process_count)."""
    return jax.process_index(), jax.process_count()
