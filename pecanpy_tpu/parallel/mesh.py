"""Device meshes and sharded execution.

The reference's only parallelism is Numba ``prange`` threads over walks and
gensim's hogwild threads (SURVEY §2 "native components"); there is no
distributed backend to port. This module is new capability:

* walkers are data-parallel over a ``data`` mesh axis — the walk batch is
  sharded; the graph is replicated (no collectives during walking) or
  row-sharded over the same axis (``parallel/distgraph.py`` — collective
  row fetches, for graphs bigger than one device's memory);
* SGNS embedding tables are tensor-parallel over a ``model`` mesh axis —
  ``W_in``/``W_out`` are sharded along the embedding dimension, so row
  gathers are local and the pair scores require one ``psum`` over the
  model axis, which GSPMD inserts from the sharding annotations;
* SGNS pair batches are data-parallel over ``data``; scatter-add updates
  to the (data-replicated) tables become an all-reduce, again inserted by
  GSPMD.

Everything goes through ``jax.jit`` + ``NamedSharding`` — no explicit
collectives; XLA lays them onto the interconnect (NCCL on GPUs).
"""
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    Args:
        n_devices: total devices to use (default: all).
        model_parallel: size of the model axis; must divide n_devices.
        devices: explicit device list override.
    """
    devices = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % model_parallel:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide {n} devices"
        )
    grid = np.array(devices).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def walk_shardings(mesh: Mesh) -> Tuple[NamedSharding, NamedSharding]:
    """(batch sharding, replicated sharding) for the walk engine."""
    return (
        NamedSharding(mesh, P(DATA_AXIS)),
        NamedSharding(mesh, P()),
    )


def sgns_shardings(mesh: Mesh):
    """Sharding set for SGNS training state and batches.

    Returns a dict with:
        table: [N, dim] sharded over the model axis (tensor parallel).
        batch: leading-axis sharded over the data axis.
        replicated: fully replicated.
    """
    return {
        "table": NamedSharding(mesh, P(None, MODEL_AXIS)),
        "batch": NamedSharding(mesh, P(DATA_AXIS)),
        "replicated": NamedSharding(mesh, P()),
    }


def shard_device_graph(graph, mesh: Mesh):
    """Replicate the padded graph across the mesh.

    (Stage-1 scaling strategy: graph replicated, walkers sharded. For
    graphs that exceed one device's memory, use the edge-partitioned layout —
    ``parallel.distgraph.shard_graph`` / ``partition="edge"``.)
    """
    replicated = NamedSharding(mesh, P())
    return jax.device_put(graph, replicated)
