"""Multi-host (multi-process) execution scaffolding.

The reference is strictly single-host (SURVEY §5). This module layers
``jax.distributed`` multi-controller SPMD on top of the edge-partitioned
walking of ``parallel/distgraph.py``: every process runs the identical
program over the *global* device mesh, the shard_map collectives
(all_gather / psum / all_to_all) ride the interconnect between hosts, and each
process feeds and reads only its addressable shards.

Typical worker:

    from pecanpy_tpu.parallel import multihost
    multihost.initialize("host0:1234", num_processes=4, process_id=rank)
    mesh = multihost.global_mesh()
    walks, eff = distgraph.simulate_walks_distributed(graph, mesh, starts, L)
    my_walks = multihost.local_array(walks)   # this process's shard rows

Tested by ``tests/test_multihost.py``, which spawns real worker
processes over the CPU backend (2 processes x 2 virtual devices) and
checks the cross-process collectives produce valid walks — the test
topology the reference never had.
"""
from typing import Optional

import numpy as np


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_count: Optional[int] = None,
) -> None:
    """``jax.distributed.initialize`` with CPU-backend conveniences.

    Where the cluster is auto-detected, call with no arguments. Otherwise
    (GPU hosts without a cluster manager, CPU multi-process testing) pass the coordinator host:port and the
    process grid explicitly; ``local_device_count`` forces that many
    virtual CPU devices per process (must be set before jax imports
    elsewhere in the process).
    """
    import os

    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{local_device_count}"
            ).strip()

    import jax

    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)


def global_mesh(model_parallel: int = 1):
    """(data, model) mesh over every device of every process.

    ``jax.devices()`` orders devices grouped by process, so the data
    axis is contiguous per host and the leading data-axis blocks belong
    to process 0, then process 1, ... — which is what makes
    ``local_array`` a contiguous row slice.
    """
    import jax
    from jax.sharding import Mesh

    from pecanpy_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

    devices = jax.devices()
    n = len(devices)
    if n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide {n} devices"
        )
    grid = np.array(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def local_array(arr) -> np.ndarray:
    """This process's rows of a leading-axis-sharded global array."""
    shards = sorted(
        arr.addressable_shards, key=lambda s: s.index[0].start or 0
    )
    return np.concatenate([np.asarray(s.data) for s in shards])


def process_slice(total: int) -> slice:
    """The contiguous [lo, hi) range of a length-``total`` leading axis
    owned by this process (equal split by process index)."""
    import jax

    per = -(-total // jax.process_count())
    lo = jax.process_index() * per
    return slice(lo, min(lo + per, total))
