"""Fused-row device layout for the batched walk kernels.

The reference walks a scalar CSR one node at a time (Numba closures over
``indptr``/``indices``/``data``, ``src/pecanpy/rw/sparse_rw.py:133-139``).
On the device the equivalent structure is a *fused padded row table*: everything a
walk step needs about a node — neighbor ids, edge weights, and mode-specific
extras (noise thresholds of the neighbors, precomputed CDFs) — lives in ONE
fixed-width float32 row, channel-packed:

    fused[i] = [ nbr (int32 bitcast) | wgt | extras... ]    width = C * dpad

so a batch of B walkers fetches all per-node state with a single gather.

Why one wide row instead of separate nbr/wgt matrices: fusing the
channels turns 2-4 row accesses per walk step into one. The layout was
tuned where gather cost was per row access, not per byte; on a GPU a
gather costs bytes (32-byte sectors) plus latency, so the 64-lane
padding below is paid in bytes on every gather. Not re-measured on the
GPU yet.

Layout invariants (the transition kernels rely on all of these):

* ``nbr`` channel slots ``[0, deg)`` list neighbors in **ascending order**
  (same sorted-row invariant as the reference CSR, ``graph.py:323-341``),
  stored as int32 bitcast to float32 (never touched by float arithmetic).
* nbr padding is the sentinel ``num_nodes`` — strictly greater than any real
  node index, so padded rows stay sorted and the sentinel never collides
  with a real neighbor during membership tests.
* ``wgt`` channel is 0 at padded positions, so padded entries carry zero
  probability through every bias path without extra masking.
* ``thr`` channel (node2vec+ modes) holds the noise threshold of the
  *neighbor* in that slot: ``thr[i, j] = threshold[nbr[i, j]]``; padding 1.0.
  The current node's own threshold is recomputed on the fly from the wgt
  channel (elementwise math — cheaper than another memory access).
* ``cdf`` channel (PreComp* modes) holds the normalized inclusive CDF of the
  node's first-order transition distribution; padding 1.0.

Degree skew: rows are padded to ``min(max_degree, degree_cap)`` (rounded
up to 64 lanes). Nodes above the cap — the power-law hubs that would blow
up an O(N * max_degree) padded layout — store a 4-slot marker instead and
are served by O(E) flat structures (packed alias rows + bucketized
neighbor hashes, ``ops/hubs.py``) driving exact rejection sampling
(``ops/rejection.py``). Graphs whose max degree fits the cap compile the
pure fused path (``has_hubs`` is static).
"""
import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pecanpy_tpu.ops import hubs as hubs_lib

LANE = 64  # fused channel width granularity (f32 lanes; unmeasured on GPU)

# Nodes above this degree leave the fused table for the flat hub structures
# (see ops/hubs.py). 128 keeps the fused all-pairs membership test cheap
# while covering the bulk of nodes on real power-law graphs.
DEFAULT_DEGREE_CAP = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# Hub-table row shapes. Both hub tables store SUPER-ROWS of 64 lanes:
# 8 alias slots (8 lanes each) or 4 hash buckets (16 lanes each) per
# stored row; a fetch gathers the super-row and mask-selects the logical
# sub-row. This was tuned where wider rows gathered faster per row
# access; on a GPU it moves 8x the bytes of one logical row and is not
# re-measured yet. Memory is unchanged (pure reshape of the flat table,
# padded to a whole super-row at the end).
HB_WIDTH = 2 * hubs_lib.BUCKET_WIDTH  # 8 key lanes (int32 bitcast) + 8 vals
SUPER_W = 64  # stored row width of both hub tables
EP_SUPER = SUPER_W // hubs_lib.EP_WIDTH  # alias slots per stored row (8)
HB_SUPER = SUPER_W // HB_WIDTH  # hash buckets per stored row (4)


def _pack_super(rows: np.ndarray) -> np.ndarray:
    """Host-side reshape of [R, w] logical rows into [*, 64] super-rows."""
    r, w = rows.shape
    per = SUPER_W // w
    pad = (-r) % per
    if pad:
        rows = np.pad(rows, ((0, pad), (0, 0)))
    return rows.reshape(-1, SUPER_W)


def _empty_pack():
    return jnp.empty((0, SUPER_W), dtype=jnp.float32)


def _empty_buckets():
    return jnp.empty((0, SUPER_W), dtype=jnp.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DeviceCSR:
    """Channel-packed padded neighbor table resident on device.

    Attributes:
        fused: [N, C * dpad] float32 fused rows (C = number of channels).
        deg: [N] int32 true degree of each node.
        threshold: [N + 1] float32 node2vec+ noise thresholds
            (mean + gamma * std of each node's edge weights, clipped at 0;
            reference: ``sparse_rw.py:22-35``). Sentinel slot = 1.0.
        indptr: [N + 1] int32 row offsets of the flat CSR — kept for the
            PreComp per-edge table addressing scheme (edge id = indptr[cur]
            + local neighbor position, ``pecanpy.py:426-436``).
        channels: static channel-name tuple, e.g. ("nbr", "wgt").
        dpad: static padded slots per channel (multiple of 64).
        max_degree: static true max degree.
    """

    fused: jax.Array
    deg: jax.Array
    threshold: jax.Array
    indptr: jax.Array
    # hub structures (empty when has_hubs is False; see ops/hubs.py for
    # the logical layout and HB_WIDTH above for the bucket row packing)
    edge_pack: jax.Array = dataclasses.field(default_factory=_empty_pack)
    hbuckets: jax.Array = dataclasses.field(default_factory=_empty_buckets)
    channels: Tuple[str, ...] = dataclasses.field(
        metadata=dict(static=True), default=("nbr", "wgt")
    )
    dpad: int = dataclasses.field(metadata=dict(static=True), default=LANE)
    max_degree: int = dataclasses.field(metadata=dict(static=True), default=0)
    gamma: float = dataclasses.field(metadata=dict(static=True), default=0.0)
    has_hubs: bool = dataclasses.field(metadata=dict(static=True), default=False)
    # w(u, v) == w(v, u) and both directions present (the undirected .edg
    # contract) — lets the amortized walker reuse each accepted proposal's
    # weight as the next return-edge weight instead of a membership probe.
    # False is always safe (it only disables that shortcut).
    symmetric: bool = dataclasses.field(metadata=dict(static=True), default=False)
    # fraction of edge mass on hub nodes (degree > cap), rounded to 1%.
    # Sizes the tiered trial block's compacted hub sub-batches (see
    # ops/rejection.tier_compact); an underestimate only slows walkers
    # standing at hubs (never wrong), an overestimate wastes descriptor
    # lanes. Rounded so minor graph edits don't retrigger compilation.
    hub_frac: float = dataclasses.field(metadata=dict(static=True), default=0.0)

    @property
    def num_nodes(self) -> int:
        return self.fused.shape[0]

    # -- channel accessors ---------------------------------------------------

    def channel(self, rows: jax.Array, name: str) -> jax.Array:
        """Slice channel ``name`` out of gathered fused rows [B, C * dpad]."""
        c = self.channels.index(name)
        return rows[..., c * self.dpad : (c + 1) * self.dpad]

    def rows_nbr(self, rows: jax.Array) -> jax.Array:
        """[B, dpad] int32 neighbor ids from gathered rows."""
        return jax.lax.bitcast_convert_type(
            self.channel(rows, "nbr"), jnp.int32
        )

    def rows_wgt(self, rows: jax.Array) -> jax.Array:
        return self.channel(rows, "wgt")

    def rows_thr(self, rows: jax.Array) -> jax.Array:
        """Per-slot neighbor noise thresholds.

        Served from the fused ``thr`` channel when packed (the hot path);
        otherwise falls back to an elementwise gather from the [N + 1]
        threshold vector (test / compat paths only — that gather is slow).
        """
        if "thr" in self.channels:
            return self.channel(rows, "thr")
        return self.threshold[self.rows_nbr(rows)]

    def rows_cdf(self, rows: jax.Array) -> jax.Array:
        return self.channel(rows, "cdf")

    def gather_rows(self, idx: jax.Array) -> jax.Array:
        """Fetch fused rows for a batch of node indices (THE hot gather)."""
        return self.fused[idx]

    # -- hub-row decoding (see ops/hubs.py for the encoding) ------------------

    def rows_is_hub(self, rows: jax.Array) -> jax.Array:
        """[B] bool — the row belongs to a hub (degree > degree_cap) node."""
        return self.rows_nbr(rows)[:, 0] > self.num_nodes

    def rows_degree(self, rows: jax.Array) -> jax.Array:
        """[B] int32 true degree, decoding hub markers."""
        nbr = self.rows_nbr(rows)
        counted = jnp.sum((nbr != self.num_nodes).astype(jnp.int32), axis=-1)
        hub_deg = nbr[:, 0] - (self.num_nodes + 1)
        return jnp.where(nbr[:, 0] > self.num_nodes, hub_deg, counted)

    def rows_edge_base(self, rows: jax.Array) -> jax.Array:
        """[B] int32 base row into edge_pack (hub rows only)."""
        return self.rows_nbr(rows)[:, 1]

    def rows_hash_meta(self, rows: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """[B] (base bucket row, log2 bucket count) of the hub hashes."""
        nbr = self.rows_nbr(rows)
        return nbr[:, 2], nbr[:, 3]

    def rows_hub_threshold(self, rows: jax.Array) -> jax.Array:
        """[B] noise threshold stored in hub rows (wgt channel slot 0)."""
        return self.rows_wgt(rows)[:, 0]

    def rows_hub_wsum(self, rows: jax.Array) -> jax.Array:
        """[B] total edge weight stored in hub rows (wgt channel slot 1)."""
        return self.rows_wgt(rows)[:, 1]

    # -- hub-table lookups (one row gather each) ------------------------------

    def _fetch_ep_super(self, row: jax.Array) -> jax.Array:
        """[..., 64] edge_pack super-rows by stored-row index. The one
        overridable primitive — the edge-partitioned layout replaces it
        with a collective fetch (``parallel/distgraph.py``)."""
        hi = max(self.edge_pack.shape[0] - 1, 0)
        return self.edge_pack[jnp.clip(row, 0, hi)]

    def _fetch_hb_super(self, row: jax.Array) -> jax.Array:
        """[..., 64] hbuckets super-rows by stored-row index
        (overridable, see ``_fetch_ep_super``)."""
        hi = max(self.hbuckets.shape[0] - 1, 0)
        return self.hbuckets[jnp.clip(row, 0, hi)]

    def fetch_edge_slots(self, slot: jax.Array) -> jax.Array:
        """[..., EP_WIDTH] resolved alias slot rows by global slot index.

        The proposal step of the rejection sampler (``ops/rejection.py``).
        One 64-lane super-row gather + a mask-select of the slot's
        8-lane sub-row.
        """
        r = self._fetch_ep_super(slot // EP_SUPER)
        # select in the INT32 domain: the rows carry int32 ids bitcast
        # into float lanes, which are denormals a float add would flush
        # to zero on a flush-to-zero backend; integer adds keep every bit
        # pattern intact
        ri = jax.lax.bitcast_convert_type(r, jnp.int32).reshape(
            *r.shape[:-1], EP_SUPER, hubs_lib.EP_WIDTH
        )
        sub = (slot % EP_SUPER)[..., None, None]
        sel = jnp.arange(EP_SUPER, dtype=jnp.int32)[:, None] == sub
        row_i = jnp.sum(jnp.where(sel, ri, 0), axis=-2)
        return jax.lax.bitcast_convert_type(row_i, jnp.float32)

    def fetch_bucket(self, bucket: jax.Array):
        """(keys [..., 8] int32, vals [..., 8] f32) of one hash bucket.

        One 64-lane super-row gather + a select of the bucket's 16-lane
        sub-row; the key and value halves ride in the same sub-row.
        """
        r = self._fetch_hb_super(bucket // HB_SUPER)
        # int32-domain select — see fetch_edge_slots for the FTZ hazard
        ri = jax.lax.bitcast_convert_type(r, jnp.int32).reshape(
            *r.shape[:-1], HB_SUPER, HB_WIDTH
        )
        sub = (bucket % HB_SUPER)[..., None, None]
        sel = jnp.arange(HB_SUPER, dtype=jnp.int32)[:, None] == sub
        row_i = jnp.sum(jnp.where(sel, ri, 0), axis=-2)
        w = hubs_lib.BUCKET_WIDTH
        keys = row_i[..., :w]
        vals = jax.lax.bitcast_convert_type(row_i[..., w:], jnp.float32)
        return keys, vals

    # -- whole-table views (preprocessing / tests; not walk-hot) -------------

    @property
    def nbr(self) -> jax.Array:
        """[N, dpad] int32 neighbor matrix view."""
        return self.rows_nbr(self.fused)

    @property
    def wgt(self) -> jax.Array:
        """[N, dpad] float32 weight matrix view."""
        return self.rows_wgt(self.fused)


def _segment_stats(
    indptr: np.ndarray, data: np.ndarray, gamma: float
) -> np.ndarray:
    """Per-row mean + gamma * std (population std), clipped at 0.

    Matches ``SparseRWGraph.get_noise_thresholds`` (``sparse_rw.py:22-35``)
    but as one vectorized pass instead of a Python loop per node. Rows with
    no edges get threshold 0 (never consulted: walkers terminate there).
    """
    deg = np.diff(indptr).astype(np.int64)
    csum = np.concatenate([[0.0], np.cumsum(data, dtype=np.float64)])
    csum2 = np.concatenate([[0.0], np.cumsum(data.astype(np.float64) ** 2)])
    row_sum = csum[indptr[1:]] - csum[indptr[:-1]]
    row_sum2 = csum2[indptr[1:]] - csum2[indptr[:-1]]
    safe_deg = np.maximum(deg, 1)
    mean = row_sum / safe_deg
    var = np.maximum(row_sum2 / safe_deg - mean**2, 0.0)
    thresholds = mean + gamma * np.sqrt(var)
    thresholds[deg == 0] = 0.0
    return np.maximum(thresholds, 0.0).astype(np.float32)


def edges_symmetric(
    indptr: np.ndarray, indices: np.ndarray, data: np.ndarray
) -> bool:
    """True iff the CSR equals its transpose (weights bit-exact).

    One lexsort each of the forward and reversed edge lists; rows with
    duplicate (u, v) entries (never produced by ``to_csr``) may report a
    false negative, which is safe — consumers only use True as license
    to skip work.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    if indices.size == 0:
        return True
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(indptr.size - 1), deg)
    fwd = np.lexsort((indices, rows))
    rev = np.lexsort((rows, indices))
    return bool(
        np.array_equal(rows[fwd], indices[rev])
        and np.array_equal(indices[fwd], rows[rev])
        and np.array_equal(data[fwd], data[rev])
    )


def build_padded_host(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    gamma: float = 0.0,
    max_degree: Optional[int] = None,
):
    """Build the padded row layout as plain host numpy arrays.

    Returns (nbr [N, D] i32, wgt [N, D] f32, deg [N] i32,
    threshold [N + 1] f32, indptr [N + 1] i32) where D is the true max
    degree (or the ``max_degree`` override). Used by CPU reference code
    (tests, the benchmark baseline) that wants the padded view without a
    device transfer; ``build_device_csr`` packs these into fused rows.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    data = np.asarray(data, dtype=np.float32)
    num_nodes = indptr.size - 1
    deg = np.diff(indptr).astype(np.int32)
    width = int(deg.max()) if deg.size and deg.max() > 0 else 1
    if max_degree is not None:
        if max_degree < width:
            raise ValueError(
                f"max_degree={max_degree} is below the true max degree {width}"
            )
        width = max_degree

    nbr = np.full((num_nodes, width), num_nodes, dtype=np.int32)
    wgt = np.zeros((num_nodes, width), dtype=np.float32)
    if indices.size:
        row_of_edge = np.repeat(np.arange(num_nodes), deg)
        col_of_edge = np.arange(indices.size) - indptr[row_of_edge]
        nbr[row_of_edge, col_of_edge] = indices
        wgt[row_of_edge, col_of_edge] = data

    thresholds = np.concatenate(
        [_segment_stats(indptr, data, gamma), np.ones(1, dtype=np.float32)]
    )
    return nbr, wgt, deg, thresholds, indptr.astype(np.int32)


def pack_fused_host(channels_data) -> np.ndarray:
    """Channel-pack host [N, dpad] arrays into one [N, C * dpad] f32 table.

    Args:
        channels_data: list of (name, array) where int32 arrays are bitcast
            into the float32 row and float arrays are cast.
    """
    parts = []
    for _, arr in channels_data:
        if arr.dtype == np.int32:
            parts.append(arr.view(np.float32))
        else:
            parts.append(np.ascontiguousarray(arr, dtype=np.float32))
    return np.concatenate(parts, axis=1)


def build_device_csr(
    indptr: np.ndarray,
    indices: np.ndarray,
    data: np.ndarray,
    gamma: float = 0.0,
    max_degree: Optional[int] = None,
    with_thresholds: bool = False,
    with_cdf: bool = False,
    degree_cap: Optional[int] = DEFAULT_DEGREE_CAP,
    symmetric: Optional[bool] = None,
    to_device: bool = True,
) -> DeviceCSR:
    """Pack a host CSR triple into the fused device layout.

    Args:
        indptr: [N+1] row offsets (any integer dtype).
        indices: [E] neighbor indices, ascending within each row.
        data: [E] positive edge weights.
        gamma: node2vec+ noise-threshold std multiplier.
        max_degree: optional fused row-width override; useful to keep a
            fixed compiled shape across graphs.
        with_thresholds: add the per-neighbor noise-threshold channel
            (node2vec+ / node2vec++ modes).
        with_cdf: add the per-node first-order CDF channel (PreComp* modes).
        degree_cap: nodes above this degree become *hubs*, served by the
            O(E) flat structures + rejection sampling instead of fused rows
            (see ops/hubs.py). None disables capping (the fused table is
            padded to the true max degree — only sane for small graphs).
        symmetric: declare the graph undirected-symmetric (True), directed
            (False), or unknown (None — detected via ``edges_symmetric``,
            one host lexsort pass).
        to_device: transfer the tables to the default device (the normal
            single-device path). False leaves every leaf as host numpy —
            the edge-partitioned pipeline device_puts each shard's slice
            directly (``parallel/distgraph.shard_graph``), so a graph
            bigger than one device's memory never lands on one device.
    """
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    data = np.asarray(data, dtype=np.float32)
    num_nodes = indptr.size - 1
    deg = np.diff(indptr).astype(np.int32)
    true_max = int(deg.max()) if deg.size and deg.max() > 0 else 1
    if symmetric is None:
        symmetric = edges_symmetric(indptr, indices, data)

    has_hubs = degree_cap is not None and true_max > degree_cap
    width = min(true_max, degree_cap) if has_hubs else true_max
    if max_degree is not None:
        if max_degree < width:
            raise ValueError(
                f"max_degree={max_degree} is below the fused width {width}"
            )
        width = max_degree
    dpad = _round_up(max(width, 1), LANE)

    if degree_cap is None:
        # Uncapped layouts pad EVERY node to the true max degree — one
        # skewed hub silently demands O(N * max_degree) fused memory
        # long before the PreComp E * 64 guard can trip. Hard byte
        # budget (same guard class as the hub int32 address checks);
        # the reference's check_mode heuristics give the same advice.
        from pecanpy_tpu.utils.budget import FUSED, budget_bytes

        n_channels = 2 + int(with_thresholds) + int(with_cdf)
        fused_bytes = num_nodes * dpad * n_channels * 4
        budget = budget_bytes(FUSED)
        if fused_bytes > budget:
            raise ValueError(
                f"uncapped fused layout needs {num_nodes} nodes x {dpad} "
                f"slots x {n_channels} channels = {fused_bytes / 2**30:.1f} "
                f"GiB (> {budget / 2**30:.1f} GiB budget, "
                "PECANPY_TPU_FUSED_BUDGET_MB). The max degree "
                f"({true_max}) is too skewed for degree_cap=None — use "
                "SparseOTF (hub-capable, the reference's mode-selection "
                "heuristics give the same advice) or set a degree_cap."
            )

    thresholds = np.concatenate(
        [_segment_stats(indptr, data, gamma), np.ones(1, dtype=np.float32)]
    )

    nbr_p = np.full((num_nodes, dpad), num_nodes, dtype=np.int32)
    wgt_p = np.zeros((num_nodes, dpad), dtype=np.float32)
    is_hub_node = deg > degree_cap if has_hubs else np.zeros(num_nodes, bool)
    if indices.size:
        row_of_edge = np.repeat(np.arange(num_nodes), deg)
        col_of_edge = np.arange(indices.size) - indptr[row_of_edge]
        keep = ~is_hub_node[row_of_edge]
        nbr_p[row_of_edge[keep], col_of_edge[keep]] = indices[keep]
        wgt_p[row_of_edge[keep], col_of_edge[keep]] = data[keep]

    hub_kwargs = {}
    if has_hubs:
        hub_ids = np.nonzero(is_hub_node)[0]
        hub_edges = int(deg[is_hub_node].astype(np.int64).sum())
        hub_kwargs["hub_frac"] = (
            round(hub_edges / max(int(indptr[-1]), 1), 2)
        )
        (
            edge_pack,
            hub_base,
            hkey8,
            hval8,
            bucket_base,
            bucket_log,
        ) = hubs_lib.build_hub_structures(indptr, indices, data, hub_ids)
        # marker encoding (see ops/hubs.py HUB_MARKER_SLOTS)
        nbr_p[hub_ids, 0] = num_nodes + 1 + deg[hub_ids]
        nbr_p[hub_ids, 1] = hub_base
        nbr_p[hub_ids, 2] = bucket_base
        nbr_p[hub_ids, 3] = bucket_log
        wgt_p[hub_ids, 0] = thresholds[hub_ids]
        csum = np.concatenate([[0.0], np.cumsum(data, dtype=np.float64)])
        wgt_p[hub_ids, 1] = (
            csum[indptr[hub_ids + 1]] - csum[indptr[hub_ids]]
        ).astype(np.float32)
        # keys bitcast into the left half of the bucket row, values right
        buckets = np.concatenate(
            [hkey8.view(np.float32), hval8], axis=1
        )  # [NB, 16]
        hub_kwargs.update(
            edge_pack=_pack_super(edge_pack),
            hbuckets=_pack_super(buckets),
        )

    channels_data = [("nbr", nbr_p), ("wgt", wgt_p)]
    if with_thresholds:
        thr_p = np.ones((num_nodes, dpad), dtype=np.float32)
        small = ~is_hub_node
        thr_p[small] = thresholds[np.minimum(nbr_p[small], num_nodes)]
        channels_data.append(("thr", thr_p))
    if with_cdf:
        cdf = np.cumsum(wgt_p, axis=1, dtype=np.float64)
        total = np.maximum(cdf[:, -1:], 1e-30)
        cdf_p = np.minimum(cdf / total, 1.0).astype(np.float32)
        cdf_p[is_hub_node] = 1.0  # hub rows draw from the alias tables
        channels_data.append(("cdf", cdf_p))

    put = jnp.asarray if to_device else np.asarray
    if "edge_pack" in hub_kwargs:
        hub_kwargs["edge_pack"] = put(hub_kwargs["edge_pack"])
        hub_kwargs["hbuckets"] = put(hub_kwargs["hbuckets"])
    elif not to_device:
        hub_kwargs["edge_pack"] = np.empty((0, SUPER_W), dtype=np.float32)
        hub_kwargs["hbuckets"] = np.empty((0, SUPER_W), dtype=np.float32)
    return DeviceCSR(
        fused=put(pack_fused_host(channels_data)),
        deg=put(deg),
        threshold=put(thresholds),
        indptr=put(indptr.astype(np.int32)),
        channels=tuple(name for name, _ in channels_data),
        dpad=dpad,
        max_degree=true_max,
        gamma=gamma,
        has_hubs=has_hubs,
        symmetric=symmetric,
        **hub_kwargs,
    )


def device_csr_from_dense(
    dense: np.ndarray,
    gamma: float = 0.0,
    max_degree: Optional[int] = None,
    with_thresholds: bool = False,
    with_cdf: bool = False,
    degree_cap: Optional[int] = DEFAULT_DEGREE_CAP,
    symmetric: Optional[bool] = None,
    to_device: bool = True,
) -> DeviceCSR:
    """Build the fused layout from a dense adjacency matrix.

    The dense walk modes (DenseOTF / node2vec++) share the fused layout: at
    density >= 0.2 padding costs little, and one layout means one walk
    engine. Row order (ascending neighbor index) matches ``np.nonzero``.
    """
    dense = np.asarray(dense)
    if symmetric is None:
        symmetric = bool(np.array_equal(dense, dense.T))
    rows, cols = np.nonzero(dense)
    deg = np.bincount(rows, minlength=dense.shape[0])
    indptr = np.concatenate([[0], np.cumsum(deg)])
    return build_device_csr(
        indptr,
        cols,
        dense[rows, cols],
        gamma=gamma,
        max_degree=max_degree,
        with_thresholds=with_thresholds,
        with_cdf=with_cdf,
        degree_cap=degree_cap,
        symmetric=symmetric,
        to_device=to_device,
    )
