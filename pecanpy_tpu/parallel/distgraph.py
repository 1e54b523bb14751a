"""Edge-partitioned walking: the graph sharded across the mesh.

The reference is strictly single-host (SURVEY §5: its only parallelism is
Numba threads). `parallel/train.py` scales *walkers* with a replicated
graph — enough until the graph itself outgrows one device's memory. This
module removes that ceiling: the fused row table row-shards over the
``data`` axis (shard s owns the contiguous node range
[s * rows_per_shard, ...)), walkers stay sharded, and the per-step row
fetch becomes a collective:

    all_gather the batch's node ids          (tiny: 4 B per walker)
    each shard gathers the rows it owns      (local fast-path gather)
    psum combines the masked partial rows    (the bandwidth cost)

This "fetch by all-reduce" exchange is deliberately the simple, exactly
load-balanced formulation: every shard does identical work regardless of
which shard owns a walker's node, there are no capacity/overflow concerns,
and XLA lays the psum onto the interconnect. The traffic-optimal variant (request/
response all-to-all, O(B/S) per link instead of O(B)) is the documented
follow-up; it changes only ``gather_rows`` here.

Hub graphs shard the same way: ``edge_pack`` and ``hbuckets`` row-shard
over the data axis, the rejection sampler's per-trial fetches go through
the identical all_gather + int-psum exchange, and its compaction
``while_loop`` syncs its trip count across shards via a psum-carried
pending counter (``rejection.second_order_sample``) so the in-loop
collectives never deadlock. PreComp's per-edge tables remain
single-device (their Σdeg² footprint is the reason that mode targets
small graphs).

Scope: SparseOTF / DenseOTF / FirstOrderUnweighted, with or without
node2vec+, hub graphs included.

Consumers: ``simulate_walks_distributed`` (sharded walks surface) and
the edge-partitioned ``parallel.train.MultichipTrainer`` — reachable as
``embed(n_devices=N, partition="edge")``, auto-selected once the graph
tables outgrow the per-chip replication budget — which fuses these
collective-fetch walks with the SGNS update on the same mesh.
"""
import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pecanpy_tpu.models import engine
from pecanpy_tpu.ops import hubs as hubs_lib
from pecanpy_tpu.ops import rejection
from pecanpy_tpu.ops.layout import DeviceCSR
from pecanpy_tpu.parallel.mesh import DATA_AXIS


def _collective_fetch(
    table_local: jax.Array,
    idx: jax.Array,
    rows_per_shard: int,
    axis: str,
) -> jax.Array:
    """Row fetch from a row-sharded table inside shard_map.

    all_gather the flat indices (4 B per lane), gather the locally-owned
    rows, combine with an exact integer psum (float payloads are bitcast
    int32 — a float psum would flush denormal-coded ids to zero on FTZ
    hardware), and slice back this shard's part of the batch.

    ``idx`` may be any shape; returns ``idx.shape + (row_width,)``.
    """
    shape = idx.shape
    flat = idx.reshape(-1)
    all_idx = jax.lax.all_gather(flat, axis, tiled=True)
    base = jax.lax.axis_index(axis) * rows_per_shard
    local = all_idx - base
    mine = (local >= 0) & (local < rows_per_shard)
    rows = table_local[jnp.clip(local, 0, max(rows_per_shard - 1, 0))]
    rows_i = jax.lax.bitcast_convert_type(rows, jnp.int32)
    rows_i = jnp.where(mine[:, None], rows_i, 0)
    rows_i = jax.lax.psum(rows_i, axis)
    b_local = flat.shape[0]
    start = jax.lax.axis_index(axis) * b_local
    rows_i = jax.lax.dynamic_slice(
        rows_i, (start, 0), (b_local, rows_i.shape[1])
    )
    out = jax.lax.bitcast_convert_type(rows_i, jnp.float32)
    return out.reshape(shape + (table_local.shape[1],))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedDeviceCSR(DeviceCSR):
    """Per-shard view of a row-sharded fused table (lives inside shard_map).

    ``fused`` holds only this shard's rows; ``gather_rows`` runs the
    collective exchange. All row-level accessors (``rows_nbr`` etc.)
    operate on gathered rows and are inherited unchanged.
    """

    global_nodes: int = dataclasses.field(
        metadata=dict(static=True), default=0
    )
    axis: str = dataclasses.field(
        metadata=dict(static=True), default=DATA_AXIS
    )
    exchange: str = dataclasses.field(
        metadata=dict(static=True), default="psum"
    )
    capacity: int = dataclasses.field(
        metadata=dict(static=True), default=0
    )
    # rows per shard of the row-sharded hub tables (0 = no hubs)
    ep_rows: int = dataclasses.field(metadata=dict(static=True), default=0)
    hb_rows: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def num_nodes(self) -> int:  # sentinel space is the GLOBAL node count
        return self.global_nodes

    @property
    def rows_per_shard(self) -> int:
        return self.fused.shape[0]

    @property
    def loop_sync_axis(self) -> str:
        """Axis the rejection sampler syncs its sweep loop over (its
        in-loop fetches are collectives here)."""
        return self.axis

    def _fetch_ep_super(self, row: jax.Array) -> jax.Array:
        # super-row decode (slot -> sub-row select) lives in the base
        # class; only the stored-row fetch is collective here
        n_shards = jax.lax.axis_size(self.axis)
        row = jnp.clip(row, 0, max(self.ep_rows * n_shards - 1, 0))
        return _collective_fetch(
            self.edge_pack, row, self.ep_rows, self.axis
        )

    def _fetch_hb_super(self, row: jax.Array) -> jax.Array:
        n_shards = jax.lax.axis_size(self.axis)
        row = jnp.clip(row, 0, max(self.hb_rows * n_shards - 1, 0))
        return _collective_fetch(self.hbuckets, row, self.hb_rows, self.axis)

    def gather_rows(self, idx: jax.Array) -> jax.Array:
        if self.exchange == "alltoall":
            return self._gather_rows_a2a(idx)
        return self._gather_rows_psum(idx)

    def _gather_rows_psum(self, idx: jax.Array) -> jax.Array:
        """Collective row fetch: all_gather ids, local gather, psum rows.

        The combine runs in the int32 domain: fused rows carry int32
        payloads bitcast into float32 lanes (neighbor ids), which are
        *denormals* as floats — a float psum flushes them to zero on
        FTZ hardware. Integer adds are exact; the float payloads survive
        the int round-trip bit-for-bit.
        """
        all_idx = jax.lax.all_gather(idx, self.axis, tiled=True)  # [B]
        base = jax.lax.axis_index(self.axis) * self.rows_per_shard
        local = all_idx - base
        mine = (local >= 0) & (local < self.rows_per_shard)
        rows = self.fused[jnp.clip(local, 0, self.rows_per_shard - 1)]
        rows_i = jax.lax.bitcast_convert_type(rows, jnp.int32)
        rows_i = jnp.where(mine[:, None], rows_i, 0)
        rows_i = jax.lax.psum(rows_i, self.axis)  # [B, W] exact
        # back to this shard's slice of the batch
        b_local = idx.shape[0]
        start = jax.lax.axis_index(self.axis) * b_local
        rows_i = jax.lax.dynamic_slice(
            rows_i, (start, 0), (b_local, rows_i.shape[1])
        )
        return jax.lax.bitcast_convert_type(rows_i, jnp.float32)

    def _gather_rows_a2a(self, idx: jax.Array) -> jax.Array:
        """Request/response row fetch over all_to_all.

        Per round: each shard packs up to ``capacity`` not-yet-served
        requests per owner into a [S, CAP] id buffer, all_to_all routes
        the buffers to their owners, owners gather their rows locally,
        and a second all_to_all returns [S, CAP, W] replies. Walkers
        whose request did not fit retry next round; the loop runs until
        every lane is served (expected: one round).
        """
        b = idx.shape[0]
        s_axis = jax.lax.axis_size(self.axis)
        cap = self.capacity
        w = self.fused.shape[1]
        rps = self.rows_per_shard
        my = jax.lax.axis_index(self.axis)

        def round_body(state):
            rows_out, served, _pending, _t = state
            owner = jnp.where(served, s_axis, idx // rps)  # served -> nowhere
            # rank of each pending lane within its owner group
            onehot = owner[:, None] == jnp.arange(s_axis)[None, :]  # [b, S]
            rank = jnp.cumsum(onehot, axis=0) - 1  # occurrences before me
            rank = jnp.sum(jnp.where(onehot, rank, 0), axis=1)
            fits = (~served) & (rank < cap)
            slot = jnp.where(fits, owner * cap + rank, s_axis * cap)
            send_ids = (
                jnp.full((s_axis * cap,), -1, dtype=jnp.int32)
                .at[slot]
                .set(idx, mode="drop")
                .reshape(s_axis, cap)
            )
            # route requests to owners: recv[k] = shard k's requests to me
            recv_ids = jax.lax.all_to_all(
                send_ids, self.axis, split_axis=0, concat_axis=0, tiled=True
            )
            local = recv_ids - my * rps
            valid = (local >= 0) & (local < rps)
            got = self.fused[jnp.clip(local, 0, rps - 1)]
            got_i = jax.lax.bitcast_convert_type(got, jnp.int32)
            got_i = jnp.where(valid[:, :, None], got_i, 0)
            # route replies back to the requesters
            back = jax.lax.all_to_all(
                got_i.reshape(s_axis, cap, w),
                self.axis,
                split_axis=0,
                concat_axis=0,
                tiled=True,
            ).reshape(s_axis * cap, w)
            mine = back[jnp.clip(slot, 0, s_axis * cap - 1)]
            rows_out = jnp.where(fits[:, None], mine, rows_out)
            served = served | fits
            # the retry decision must be GLOBAL: a shard that exits the
            # loop early while another retries would deadlock the
            # all_to_all, so every shard carries the summed pending count
            pending = jax.lax.psum(jnp.sum(~served), self.axis)
            return rows_out, served, pending, _t + 1

        def cond(state):
            _, _, pending, t = state
            return (pending > 0) & (t < b + 1)

        rows0 = jnp.zeros((b, w), dtype=jnp.int32)
        served0 = jnp.zeros((b,), dtype=bool)
        rows_i, _, _, _ = jax.lax.while_loop(
            cond, round_body, (rows0, served0, jnp.int32(1), jnp.int32(0))
        )
        return jax.lax.bitcast_convert_type(rows_i, jnp.float32)


def exchange_cost_model(b_local: int, n_shards: int, width: int) -> dict:
    """Per-shard bytes moved by ONE row fetch under each exchange.

    psum ("fetch by all-reduce", ``_gather_rows_psum``):
      * all_gather of the ids: (S - 1) * b_local * 4 B received;
      * ring all-reduce of the [S * b_local, W] masked rows: each shard
        sends/receives ~2 * (S-1)/S * (S * b_local) * W * 4 B.
      Total ~ 2 * S * b_local * W * 4 — the full global batch's rows
      cross every link, regardless of who owns what.

    alltoall (request/response, ``_gather_rows_a2a``):
      * request a2a: S * cap ids out (+ the same in);
      * reply a2a: S * cap * W lanes each way;
      with cap ~ b_local / S + 4 * sqrt(b_local / S) slack. Total
      ~ 2 * (b_local + slack * S) * W * 4 — only the requested rows
      move, so it beats psum by ~S/(1 + slack overhead).

    The crossover is S >= 2 on bytes; the a2a path additionally pays a
    per-fetch rank computation ([b_local, S] one-hot cumsum) and a
    retry ``while_loop``, so ``auto`` requires a 2x modeled advantage
    (in practice: picks a2a from S >= 4). Virtual-mesh wall times:
    ``benchmarks/bench_exchange.py`` (CPU collectives are memcpys —
    the model, not those times, is the interconnect-relevant
    comparison).
    """
    per_shard = max(b_local // n_shards, 1)
    cap = per_shard + 4 * int(np.sqrt(per_shard)) + 8
    psum_bytes = 4 * (
        (n_shards - 1) * b_local  # id all_gather
        + 2 * n_shards * b_local * width  # row all-reduce (ring)
    )
    a2a_bytes = 4 * (
        2 * n_shards * cap  # request ids out + in
        + 2 * n_shards * cap * width  # replies out + in
    )
    pick = "alltoall" if a2a_bytes * 2 < psum_bytes else "psum"
    return {
        "psum_bytes": int(psum_bytes),
        "a2a_bytes": int(a2a_bytes),
        "capacity": int(cap),
        "pick": pick,
    }


def resolve_exchange(
    exchange: str, b_local: int, n_shards: int, width: int
) -> str:
    """Resolve "auto" to a concrete exchange via the cost model."""
    if exchange != "auto":
        return exchange
    return exchange_cost_model(b_local, n_shards, width)["pick"]


@dataclasses.dataclass(frozen=True)
class ShardMeta:
    """Per-table rows-per-shard of a sharded graph (static plan)."""

    fused_rows: int
    ep_rows: int = 0
    hb_rows: int = 0


def _put(arr, sharding):
    """Lay out host data under a sharding, multi-process-safe.

    ``jax.device_put`` cannot target non-addressable shards; the
    callback form hands each process exactly its local blocks (every
    process holds the full host copy — fine at graph-build scales).
    """
    arr = np.asarray(arr)
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr), sharding)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx]
    )


def _shard_rows(arr, mesh, pad_value=0.0):
    """Pad a [R, W] table to a multiple of the data-axis size and lay it
    out row-sharded. Returns (device array, rows per shard)."""
    n_shards = mesh.shape[DATA_AXIS]
    arr = np.asarray(arr)
    r = arr.shape[0]
    rows = max(-(-r // n_shards), 1)
    pad = rows * n_shards - r
    if pad:
        arr = np.concatenate(
            [arr, np.full((pad, arr.shape[1]), pad_value, arr.dtype)]
        )
    sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    return _put(arr, sharding), rows


def shard_graph(graph: DeviceCSR, mesh: Mesh):
    """Pad + device_put the graph tables row-sharded over the data axis.

    Returns (sharded graph container, ShardMeta). The returned object
    still carries the full logical metadata; ``distributed_walk_fn``
    re-wraps each shard's slice as a ``ShardedDeviceCSR`` inside
    shard_map. Hub graphs shard their alias/bucket tables the same way.
    """
    # padded fused rows read as zero-degree sentinels (nbr bitcast 0.0 is
    # node id 0 — but their weight row is 0 and no walker can reach
    # them: node ids stay < n)
    fused, rows = _shard_rows(graph.fused, mesh)
    # bucket pad keys are -1 bitcast (never a node id): a clamped
    # out-of-range probe cannot fake a membership hit. Non-hub graphs
    # still lay out (padded-empty) tables so the shard_map signature is
    # uniform; their fetchers are never traced.
    neg1 = float(np.int32(-1).view(np.float32))
    ep, ep_rows = _shard_rows(graph.edge_pack, mesh)
    hb, hb_rows = _shard_rows(graph.hbuckets, mesh, pad_value=neg1)
    threshold = _put(graph.threshold, NamedSharding(mesh, P()))
    out = dataclasses.replace(
        graph, fused=fused, edge_pack=ep, hbuckets=hb, threshold=threshold
    )
    return out, ShardMeta(fused_rows=rows, ep_rows=ep_rows, hb_rows=hb_rows)


def make_local_walker(
    graph: DeviceCSR,
    meta: ShardMeta,
    n_shards: int,
    walk_length: int,
    p: float = 1.0,
    q: float = 1.0,
    extend: bool = False,
    mode: str = "SparseOTF",
    exchange: str = "auto",
    capacity: Optional[int] = None,
):
    """Per-shard walk function over an edge-partitioned graph.

    Returns ``walk(fused_local, ep_local, hb_local, threshold,
    starts_local, key) -> (walks_local, eff_local)`` — to be called
    INSIDE ``shard_map`` over the ``data`` axis. ``graph`` supplies only
    static metadata (channels, dpad, node count); its leaves may live on
    host. The walk engine runs unchanged; only the row fetches are the
    collective exchanges above, so for a given (per-shard starts, key)
    the walks are bit-identical to a replicated-graph run — the edge
    partition changes WHERE rows live, never which rows come back.

    Used by both ``distributed_walk_fn`` (walks-only surface) and the
    edge-partitioned ``parallel.train.MultichipTrainer`` (fused
    walk+SGNS step on the same mesh).
    """
    num_nodes = graph.num_nodes

    def walk(fused_local, ep_local, hb_local, threshold, starts_local, key):
        b_local = starts_local.shape[0]
        exch = resolve_exchange(
            exchange, b_local, n_shards, graph.fused.shape[1]
        )
        cap = capacity
        if cap is None:
            mean = max(b_local // n_shards, 1)
            cap = mean + 4 * int(np.sqrt(mean)) + 8
        dg = ShardedDeviceCSR(
            fused=fused_local,
            deg=jnp.zeros(0, jnp.int32),  # unused in the fused path
            threshold=threshold,
            indptr=jnp.zeros(0, jnp.int32),
            edge_pack=ep_local,
            hbuckets=hb_local,
            channels=graph.channels,
            dpad=graph.dpad,
            max_degree=graph.max_degree,
            gamma=graph.gamma,
            has_hubs=graph.has_hubs,
            symmetric=graph.symmetric,
            global_nodes=num_nodes,
            exchange=exch,
            capacity=cap,
            ep_rows=meta.ep_rows,
            hb_rows=meta.hb_rows,
        )
        key = jax.random.fold_in(key, jax.lax.axis_index(DATA_AXIS))

        if mode == "FirstOrderUnweighted":
            def first_fn(k, cur, cur_rows):
                return rejection.uniform_propose(dg, k, cur_rows)

            def step_fn(k, cur, prev, cur_rows, prev_rows):
                return rejection.uniform_propose(dg, k, cur_rows)
        else:
            from pecanpy_tpu.models.modes import _otf_step_fns

            f0, s0 = _otf_step_fns(p, q, extend)

            def first_fn(k, cur, cur_rows):
                return f0(dg, (), k, cur, cur_rows)

            def step_fn(k, cur, prev, cur_rows, prev_rows):
                return s0(dg, (), k, cur, prev, cur_rows, prev_rows)

        if mode != "FirstOrderUnweighted" and dg.has_hubs:
            # hub graphs: the stall-round amortized walker (the psum-
            # synced loop count keeps the collective schedule uniform)
            return engine.generate_walks_amortized(
                dg, starts_local, key, walk_length, p, q, extend
            )
        return engine.generate_walks(
            dg, first_fn, step_fn, starts_local, key, walk_length
        )

    return walk


def distributed_walk_fn(
    mesh: Mesh,
    graph: DeviceCSR,
    meta: ShardMeta,
    walk_length: int,
    p: float = 1.0,
    q: float = 1.0,
    extend: bool = False,
    mode: str = "SparseOTF",
    exchange: str = "auto",
    capacity: Optional[int] = None,
):
    """Compiled sharded walk program: starts sharded in, walks sharded out.

    The walk engine runs unchanged inside ``shard_map``; only the row
    fetches differ (the collective exchanges above). Hub graphs route
    through the same rejection sampler as single-device walking, with
    its trial fetches collective and its sweep loop psum-synced.

    ``exchange``: "psum", "alltoall", or "auto" (default — picked per
    batch/mesh shape by ``exchange_cost_model``).
    """
    walk = make_local_walker(
        graph, meta, mesh.shape[DATA_AXIS], walk_length, p, q, extend,
        mode, exchange=exchange, capacity=capacity,
    )

    mapped = jax.shard_map(
        walk,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None),
            P(DATA_AXIS, None),
            P(DATA_AXIS, None),
            P(),
            P(DATA_AXIS),
            P(),
        ),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS)),
        check_vma=False,
    )

    @jax.jit
    def run(fused, edge_pack, hbuckets, threshold, starts, key):
        return mapped(fused, edge_pack, hbuckets, threshold, starts, key)

    return run


def simulate_walks_distributed(
    graph: DeviceCSR,
    mesh: Mesh,
    starts: np.ndarray,
    walk_length: int,
    p: float = 1.0,
    q: float = 1.0,
    extend: bool = False,
    mode: str = "SparseOTF",
    seed: Optional[int] = 0,
    exchange: str = "auto",
    capacity: Optional[int] = None,
):
    """One-call sharded walk generation over an edge-partitioned graph.

    Works on a single-process mesh and on a multi-process
    (``jax.distributed``) global mesh alike: every process passes the
    identical full ``starts`` schedule and receives the global sharded
    result (read your process's part via ``.addressable_shards`` /
    ``parallel.multihost.local_array``).
    """
    sharded, meta = shard_graph(graph, mesh)
    n_shards = mesh.shape[DATA_AXIS]
    b = starts.size
    pad = (-b) % n_shards
    starts = np.pad(np.asarray(starts, dtype=np.int32), (0, pad))
    starts_dev = _put(starts, NamedSharding(mesh, P(DATA_AXIS)))
    fn = distributed_walk_fn(
        mesh, graph, meta, walk_length, p, q, extend, mode,
        exchange=exchange, capacity=capacity,
    )
    walks, eff = fn(
        sharded.fused, sharded.edge_pack, sharded.hbuckets,
        sharded.threshold, starts_dev, jax.random.PRNGKey(seed or 0),
    )
    if pad:
        walks, eff = walks[:-pad], eff[:-pad]
    return walks, eff
