"""The five walk modes, as step-function factories over the shared engine.

Reference mode classes: ``pecanpy.py:293-614``. Each mode differs only in
how a batch of walkers picks its next node; the walk driver, termination
semantics, and fused device layout are shared. The Sparse/Dense split of
the reference collapses on the device — both feed the same fused row layout — so
the Dense classes differ only in which host container they parse into.

Step functions receive the *pre-gathered fused rows* of the current and
previous nodes (threaded through the scan carry by the engine) and must not
touch the node table again — keeping every mode at one gather per step
(plus one per-edge-table gather for PreComp).
"""
import os

import jax
import jax.numpy as jnp

from pecanpy_tpu.graph import DenseGraph, SparseGraph
from pecanpy_tpu.models import engine
from pecanpy_tpu.models.base import Base
from pecanpy_tpu.ops import rejection, sampling, transition
from pecanpy_tpu.ops.layout import (
    DeviceCSR,
    build_device_csr,
    device_csr_from_dense,
)


def _want_cdf(mode, max_degree: int) -> bool:
    """Should this graph carry the precomputed first-order CDF channel?

    PreComp* modes require it. OTF modes on HUB graphs want it too: the
    amortized walker's per-trial proposal replaces a cumsum over the
    [B, dpad] wgt rows with a channel read. The channel costs
    N * dpad * 4 bytes of device memory, so it is gated on a budget (an
    eighth of the device's memory, ``utils/budget.py``;
    ``PECANPY_TPU_CDF_BUDGET_MB`` overrides, 0 disables).
    """
    from pecanpy_tpu.utils.budget import CDF, budget_bytes

    if mode._needs_cdf_channel:
        return True
    cap = mode.degree_cap
    if cap is None or max_degree <= cap:
        return False  # no hubs: the fused scan engine has no use for it
    if not getattr(mode, "_cdf_for_hubs", False):
        return False
    if os.environ.get("PECANPY_TPU_AMORTIZED", "1") in ("0", "false"):
        return False
    lane = 64  # layout.LANE granularity
    dpad = -(-min(max_degree, cap) // lane) * lane
    return mode.num_nodes * dpad * 4 <= budget_bytes(CDF)


class _SparseModeBase(Base, SparseGraph):
    """Modes whose host container is the CSR ``SparseGraph``."""

    _needs_cdf_channel = False

    def _build_device_graph(self, to_device: bool = True) -> DeviceCSR:
        import numpy as np

        deg_max = (
            int(np.diff(self.indptr).max()) if self.num_edges else 0
        )
        return build_device_csr(
            self.indptr,
            self.indices,
            self.data,
            gamma=self.gamma,
            with_thresholds=self.extend,
            with_cdf=_want_cdf(self, deg_max),
            degree_cap=self.degree_cap,
            to_device=to_device,
        )


class _DenseModeBase(Base, DenseGraph):
    """Modes whose host container is the dense ``DenseGraph``."""

    _needs_cdf_channel = False

    def _build_device_graph(self, to_device: bool = True) -> DeviceCSR:
        import numpy as np

        nonzero_per_row = (np.asarray(self.data) != 0).sum(axis=1)
        deg_max = int(nonzero_per_row.max()) if nonzero_per_row.size else 0
        return device_csr_from_dense(
            self.data,
            gamma=self.gamma,
            with_thresholds=self.extend,
            with_cdf=_want_cdf(self, deg_max),
            degree_cap=self.degree_cap,
            to_device=to_device,
        )


def _pick_kernel(extend: bool):
    """2nd-order bias kernel; gamma rides on the device graph metadata."""
    if extend:
        return transition.node2vec_plus_weights_rows
    return transition.node2vec_weights_rows


def _otf_step_fns(p: float, q: float, extend: bool):
    """On-the-fly transition sampling: bias kernel + inverse-CDF draw.

    Semantics of the reference OTF move (``pecanpy.py:543-559``), batched.
    Steps touching a hub node run the exact rejection sampler instead of
    the fused kernel (``ops/rejection.py``); graphs without hubs compile
    the fused path only.
    """
    kernel = _pick_kernel(extend)

    def first_fn(dg, aux, key, cur, cur_rows):
        x, _ = rejection.propose(dg, key, cur_rows)
        return x

    def step_fn(dg, aux, key, cur, prev, cur_rows, prev_rows):
        k_fused, k_rej = jax.random.split(key)
        weights = kernel(dg, cur_rows, prev_rows, prev, p, q)
        choice = sampling.categorical_rows(k_fused, weights)
        nxt = sampling.pick_int_columns(dg.rows_nbr(cur_rows), choice)
        if dg.has_hubs:
            use_rej = dg.rows_is_hub(cur_rows) | dg.rows_is_hub(prev_rows)
            nxt_rej = rejection.second_order_sample(
                dg, k_rej, cur, prev, cur_rows, prev_rows, p, q, extend,
                use_rej,
            )
            nxt = jnp.where(use_rej, nxt_rej, nxt)
        return nxt

    return first_fn, step_fn


class _AmortizedOTFMixin:
    """Routes hub graphs through the stall-round amortized walker.

    Also requests the first-order CDF channel on hub graphs
    (``_cdf_for_hubs``, see ``_want_cdf``) — the amortized proposal
    reads it instead of cumsum-ing the wgt rows every trial.

    ``engine.generate_walks_amortized`` replaces the per-step rejection
    sampler's compaction sweeps with cross-step stalling — identical
    transition law, far fewer serial steps on power-law graphs. Graphs without
    hubs keep the pure fused scan engine (faster when no lane ever
    stalls). ``PECANPY_TPU_AMORTIZED=0`` forces the per-step sampler
    (benchmark comparisons / debugging).
    """

    _cdf_for_hubs = True

    def _walk_queue_factor(self) -> int:
        """Walks per dispatch = queue_factor * walker lanes (hub graphs).

        The queued engine amortizes its straggler tail over the whole
        dispatch, so larger walk queues per dispatch walk faster; the
        default 8 lanes' worth (~262k walks at the default 32k lanes, an
        85 MB walk buffer) is not yet re-measured on the GPU. 1 falls
        back to one
        batch per dispatch (``PECANPY_TPU_QUEUE_FACTOR``; 0 disables
        the queued engine entirely and uses the per-batch amortized
        walker).
        """
        if not self.get_device_graph().has_hubs:
            return 1
        if os.environ.get("PECANPY_TPU_AMORTIZED", "1") in ("0", "false"):
            return 1
        return max(int(os.environ.get("PECANPY_TPU_QUEUE_FACTOR", "8")), 1)

    def _make_walk_runner(self, walk_length: int):
        use_amortized = self.get_device_graph().has_hubs
        if os.environ.get("PECANPY_TPU_AMORTIZED", "1") in ("0", "false"):
            use_amortized = False
        if not use_amortized:
            return super()._make_walk_runner(walk_length)
        p, q, extend = self.p, self.q, self.extend
        trials = int(os.environ.get("PECANPY_TPU_AMORTIZED_TRIALS", "2"))
        unroll = int(os.environ.get("PECANPY_TPU_UNROLL", "4"))
        queued = os.environ.get("PECANPY_TPU_QUEUE_FACTOR", "8") != "0"
        lanes = self._resolved_walker_batch()

        def run(dg, aux, start, key):
            if queued:
                return engine.generate_walks_queued(
                    dg, start, key, walk_length, p, q, extend,
                    lanes=lanes, trials=trials, unroll=unroll,
                )
            return engine.generate_walks_amortized(
                dg, start, key, walk_length, p, q, extend, trials=trials,
                unroll=unroll,
            )

        return run


class SparseOTF(_AmortizedOTFMixin, _SparseModeBase):
    """Compute 2nd-order probabilities on the fly each step (default mode).

    Reference: ``pecanpy.py:510-561``.
    """

    def make_step_fns(self):
        return _otf_step_fns(self.p, self.q, self.extend)


class DenseOTF(_AmortizedOTFMixin, _DenseModeBase):
    """OTF walking from a dense adjacency input.

    Reference: ``pecanpy.py:564-614``. Same transition law as SparseOTF —
    the fused device layout serves both; only host-side parsing differs.
    """

    def make_step_fns(self):
        return _otf_step_fns(self.p, self.q, self.extend)


class FirstOrderUnweighted(_SparseModeBase):
    """Uniform neighbor sampling; no probabilities at all.

    Reference: ``pecanpy.py:293-309`` — next = random entry of the CSR row.
    """

    def make_step_fns(self):
        def first_fn(dg, aux, key, cur, cur_rows):
            return rejection.uniform_propose(dg, key, cur_rows)

        def step_fn(dg, aux, key, cur, prev, cur_rows, prev_rows):
            return rejection.uniform_propose(dg, key, cur_rows)

        return first_fn, step_fn


class PreCompFirstOrder(_SparseModeBase):
    """First-order weighted walks from precomputed per-node tables.

    Reference: ``pecanpy.py:312-361`` — per-edge alias tables giving O(1)
    draws. The device equivalent precomputes each node's normalized transition
    CDF into a fused-row channel: the walk step is one fused gather + a
    compare-reduce — O(1) memory transactions per step, the same contract
    the alias tables buy the reference (identical sampled distribution).
    """

    _needs_cdf_channel = True

    def preprocess_transition_probs(self):
        self.get_device_graph()  # CDF channel is packed at build time

    def make_step_fns(self):
        def move(dg, key, cur_rows):
            x, _ = rejection.propose(dg, key, cur_rows, use_cdf=True)
            return x

        def first_fn(dg, aux, key, cur, cur_rows):
            return move(dg, key, cur_rows)

        def step_fn(dg, aux, key, cur, prev, cur_rows, prev_rows):
            return move(dg, key, cur_rows)

        return first_fn, step_fn


class PreComp(_SparseModeBase):
    """Precompute 2nd-order transition tables for every (cur, prev) edge.

    Reference: ``pecanpy.py:364-507`` — one alias table per directed edge
    (cur, prev-neighbor), total Sigma deg(i)^2 entries, addressed by flat
    edge id = indptr[cur] + position of prev in cur's row
    (``pecanpy.py:426-436``).

    Device layout: a [E, PRECOMP_WIDTH(=64)] CDF table holding the full
    precomputed transition CDF for every edge whose source degree fits
    the row — a walk step there is one edge-row gather + compare-reduce.
    Edges of wider nodes fall back to the on-the-fly kernel on the
    carried fused rows (no extra memory access) — the same
    transition law, computed instead of looked up. This replaces the
    round-1 [E, dpad] layout whose per-edge rows padded to the global
    max degree (the reference's ragged Sigma deg^2 concern): memory is
    now a flat E x 64 regardless of degree skew, and the viability guard
    is E < 2^31 / 64 edges. The mode-selection heuristics
    (``cli.py:226-254``) carry over unchanged.

    First step (no prev) samples the node's 1st-order CDF channel
    (``pecanpy.py:412-424``).
    """

    _needs_cdf_channel = True
    PRECOMP_WIDTH = 64

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        # edge-id addressing (indptr[cur] + position) needs full-width
        # fused rows; wide nodes use the OTF fallback instead of hubs
        self.degree_cap = None
        self.edge_cdf = None

    def preprocess_transition_probs(self):
        dg = self.get_device_graph()
        w = min(self.PRECOMP_WIDTH, dg.dpad)
        if int(dg.indptr[-1]) * w >= 2**31:
            raise ValueError(
                f"PreComp's per-edge tables need E * {w} < 2^31 "
                f"(got E={int(dg.indptr[-1])}); use SparseOTF for graphs "
                "of this size (the reference's mode-selection heuristics "
                "give the same advice)."
            )
        kernel = _pick_kernel(self.extend)
        p, q = self.p, self.q

        # One CDF row per directed edge (u -> x): the transition
        # distribution out of u given the walker arrived from x.
        edge_cur, flat_pos = _flat_edge_positions(dg)

        @jax.jit
        def build(dg, edge_cur, flat_pos):
            cur_rows = dg.gather_rows(edge_cur)  # [S, W]
            edge_prev = dg.nbr.reshape(-1)[flat_pos]  # [S] prev per row
            prev_rows = dg.gather_rows(edge_prev)
            weights = kernel(dg, cur_rows, prev_rows, edge_prev, p, q)
            cdf = jnp.cumsum(weights, axis=-1)
            total = jnp.maximum(cdf[:, -1:], 1e-30)
            # rows of nodes with deg <= w carry their complete CDF in the
            # first w slots (padding saturates at 1.0); wider rows are
            # never read (OTF fallback)
            return jnp.minimum(cdf / total, 1.0)[:, :w]

        # The build is chunked over fixed-size edge slices: the one-shot
        # form gathers cur_rows + prev_rows as [E, W] f32 temporaries,
        # which at the E*64 < 2^31 guard's admitted sizes (E ~ 33M) is
        # tens of GB — past device memory long before the guard trips (the same
        # transient-footprint class as the reference's Sigma deg^2
        # discussion, ``pecanpy.py:442-507``). Per-edge CDF rows are
        # independent, so slicing is bit-identical to the one-shot
        # build; the slice size comes from a transient-bytes budget
        # (``PECANPY_TPU_PRECOMP_BUILD_MB``, default 1024), padded to a
        # single static shape so only one program compiles.
        e = int(dg.indptr[-1])
        row_w = dg.fused.shape[1]
        # per-edge transients: cur+prev gathered rows, the bias-kernel
        # weights + cumsum, and the output slice
        per_edge = (2 * row_w + 2 * dg.dpad + w) * 4
        budget_mb = int(
            os.environ.get("PECANPY_TPU_PRECOMP_BUILD_MB", "1024")
        )
        slice_e = max(min(e, (budget_mb << 20) // max(per_edge, 1)), 256)
        if e <= slice_e:
            self.edge_cdf = build(dg, edge_cur, flat_pos)
            return
        parts = []
        for lo in range(0, e, slice_e):
            size = min(slice_e, e - lo)
            ec = jax.lax.dynamic_slice_in_dim(edge_cur, lo, size)
            fp = jax.lax.dynamic_slice_in_dim(flat_pos, lo, size)
            if size < slice_e:  # pad the tail slice to the static shape
                ec = jnp.pad(ec, (0, slice_e - size))
                fp = jnp.pad(fp, (0, slice_e - size))
            parts.append(build(dg, ec, fp)[:size])
        self.edge_cdf = jnp.concatenate(parts)

    def _walk_aux(self):
        return (self.edge_cdf,)

    def make_step_fns(self):
        kernel = _pick_kernel(self.extend)
        p, q = self.p, self.q

        def first_fn(dg, aux, key, cur, cur_rows):
            choice = sampling.sample_from_cdf(key, dg.rows_cdf(cur_rows))
            return sampling.pick_int_columns(dg.rows_nbr(cur_rows), choice)

        def step_fn(dg, aux, key, cur, prev, cur_rows, prev_rows):
            (edge_cdf,) = aux
            w = edge_cdf.shape[1]
            cur_nbr = dg.rows_nbr(cur_rows)
            pos = transition.row_searchsorted(cur_nbr, prev[:, None])[:, 0]
            pos = jnp.minimum(pos, cur_nbr.shape[1] - 1).astype(jnp.int32)
            edge_row = dg.indptr[cur] + pos
            cdf = edge_cdf[edge_row]  # [B, w] edge-table gather
            choice = sampling.sample_from_cdf(key, cdf)
            if w >= dg.dpad:
                return sampling.pick_int_columns(cur_nbr, choice)
            # wide-degree fallback: same law, computed on the fly from
            # the carried rows (no extra gather)
            weights = kernel(dg, cur_rows, prev_rows, prev, p, q)
            choice_otf = sampling.categorical_rows(key, weights)
            deg = transition.row_degrees(dg, cur_rows)
            choice = jnp.where(deg > w, choice_otf, choice)
            return sampling.pick_int_columns(cur_nbr, choice)

        return first_fn, step_fn


def _flat_edge_positions(dg: DeviceCSR):
    """Per-edge (source node, flat index into the padded [N, D] rows)."""
    e = int(dg.indptr[-1])
    edge_cur = jnp.repeat(
        jnp.arange(dg.num_nodes, dtype=jnp.int32), dg.deg, total_repeat_length=e
    )
    local = jnp.arange(e, dtype=jnp.int32) - dg.indptr[edge_cur]
    return edge_cur, edge_cur * dg.dpad + local
