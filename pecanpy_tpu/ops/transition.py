"""Batched transition-probability kernels over fused rows.

Each kernel maps a batch of walker states to *unnormalized* transition
weights over the padded neighbor slots of the current nodes:

    cur_rows [B, W], prev_rows [B, W]  ->  [B, dpad] weights

where the rows are channel-packed fused rows (see ``ops/layout.py``),
pre-gathered by the walk engine and threaded through the scan carry — so a
2nd-order step touches device memory exactly once (the gather of the *next* node's
row), instead of the reference's four row reads per step.

Sampling by inverse CDF consumes unnormalized weights directly, so the
kernels skip the final normalization the reference performs
(``sparse_rw.py:89``) — the sampled distribution is identical.

The reference computes these per node with scalar Numba loops and a
sorted-merge set difference (``isnotin``, ``sparse_rw.py:142-230``). The
batched formulation replaces the merge with an all-pairs equality mask over
the two padded rows — one fused [B, D, D] elementwise pass with no extra
memory traffic (both rows are already gathered). Padding safety: padded slots
carry weight 0 and the sentinel index N, so whatever bias factor they pick
up, their probability stays 0.

``*_rows`` kernels are the hot path; the same-named wrappers taking node
indices (gather-then-compute) are kept for unit tests and scalar-callback
compatibility shims.
"""
from typing import Optional

import jax
import jax.numpy as jnp

from pecanpy_tpu.ops.layout import DeviceCSR

_EPS = 1e-30


def _active_width(graph: DeviceCSR) -> int:
    """Slots that can hold real neighbors in a fused row.

    The channel is padded to 64-lane multiples, but the all-pairs
    membership test is O(width^2) — slicing to the true max degree
    (rounded to 8 sublanes) cuts real work; hub graphs keep the full
    capped width (their rows ARE full).
    """
    width = -(-min(graph.max_degree, graph.dpad) // 8) * 8
    return min(max(width, 8), graph.dpad)


def row_searchsorted(a: jax.Array, v: jax.Array) -> jax.Array:
    """Row-wise ``searchsorted``: first index where a[b, i] >= v[b, j].

    Args:
        a: [B, D] rows, each sorted ascending.
        v: [B, D] query values.

    Returns:
        [B, D] int32 insertion positions in [0, D].

    Batched binary search as a fixed log2(D) unrolled loop of
    ``take_along_axis`` gathers. (``jnp.searchsorted`` under ``vmap``
    lowers to a sequential scan per query.)
    """
    b, d = a.shape
    lo = jnp.zeros(v.shape, dtype=jnp.int32)
    hi = jnp.full(v.shape, d, dtype=jnp.int32)
    # positions range over [0, d] — d + 1 values — so d.bit_length() rounds
    for _ in range(max(d, 1).bit_length()):
        mid = (lo + hi) // 2
        mid_val = jnp.take_along_axis(a, jnp.minimum(mid, d - 1), axis=1)
        go_right = mid_val < v
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


def _locate_in_prev(cur_nbr: jax.Array, prev_nbr: jax.Array,
                    prev_wgt=None):
    """For each candidate x in cur's row, look x up in prev's row.

    Returns:
        found: [B, D] bool — x is a neighbor of prev.
        prev_wgt_of: [B, D] float32 — w(prev, x), 0 where not found —
            or None when ``prev_wgt`` is None (plain node2vec needs only
            membership; skipping the weight reduction avoids a second
            [B, D, D] float pass, roughly half the kernel's work).

    Batched replacement for the sorted-merge ``isnotin`` /
    ``isnotin_extended`` scans (``sparse_rw.py:142-295``): an all-pairs
    equality mask — for the padded widths in play (<= a few hundred) one
    [B, D, D] elementwise pass on already-gathered rows. The O(D log D)
    ``row_searchsorted`` alternative is not yet compared on the GPU.
    """
    eq = cur_nbr[:, :, None] == prev_nbr[:, None, :]  # [B, D, D]
    found = jnp.any(eq, axis=-1)
    if prev_wgt is None:
        return found, None
    prev_wgt_of = jnp.sum(jnp.where(eq, prev_wgt[:, None, :], 0.0), axis=-1)
    return found, prev_wgt_of


def row_degrees(graph: DeviceCSR, rows: jax.Array) -> jax.Array:
    """[B] int32 true degrees, counted from the nbr channel sentinels."""
    nbr = graph.rows_nbr(rows)
    return jnp.sum((nbr != graph.num_nodes).astype(jnp.int32), axis=-1)


def row_thresholds(
    graph: DeviceCSR, rows: jax.Array, gamma: float
) -> jax.Array:
    """[B] noise threshold of each row's node, recomputed from its weights.

    Matches ``get_noise_thresholds`` (``sparse_rw.py:22-35``): population
    mean + gamma * std over the node's edge weights, clipped at 0. Pure
    math on the already-gathered wgt channel — no extra memory access.
    """
    w = graph.rows_wgt(rows)
    deg = jnp.maximum(
        jnp.sum((w > 0).astype(jnp.float32), axis=-1), 1.0
    )
    mean = jnp.sum(w, axis=-1) / deg
    var = jnp.maximum(jnp.sum(w * w, axis=-1) / deg - mean * mean, 0.0)
    return jnp.maximum(mean + gamma * jnp.sqrt(var), 0.0)


def first_order_weights_rows(graph: DeviceCSR, rows: jax.Array) -> jax.Array:
    """First-order transition weights: the raw edge weights w(cur, .).

    Reference: ``get_normalized_probs_first_order`` (``sparse_rw.py:37-49``).
    """
    return graph.rows_wgt(rows)


def node2vec_weights_rows(
    graph: DeviceCSR,
    cur_rows: jax.Array,
    prev_rows: jax.Array,
    prev: jax.Array,
    p: float,
    q: float,
) -> jax.Array:
    """Second-order node2vec biased weights from fused rows.

    Per the reference (``sparse_rw.py:51-91``): neighbors of cur that are
    neither neighbors of prev nor prev itself are "out" edges and divide by
    q; the return edge (cur -> prev) divides by p; common neighbors keep
    their weight.
    """
    d = _active_width(graph)
    cur_nbr = graph.rows_nbr(cur_rows)[:, :d]
    w = graph.rows_wgt(cur_rows)[:, :d]
    prev_nbr = graph.rows_nbr(prev_rows)[:, :d]
    found, _ = _locate_in_prev(cur_nbr, prev_nbr)
    is_prev = cur_nbr == prev[:, None]
    is_out = ~found & ~is_prev
    w = w * jnp.where(is_out, 1.0 / q, 1.0)
    w = w * jnp.where(is_prev, 1.0 / p, 1.0)
    return w


def node2vec_plus_weights_rows(
    graph: DeviceCSR,
    cur_rows: jax.Array,
    prev_rows: jax.Array,
    prev: jax.Array,
    p: float,
    q: float,
    gamma: Optional[float] = None,
) -> jax.Array:
    """Second-order node2vec+ biased weights (the ``extend`` mode).

    Follows the sparse reference kernel (``sparse_rw.py:93-130`` with
    ``isnotin_extended`` at 233-295):

    * candidate x is an out edge iff it is not a neighbor of prev, or its
      connection to prev is loose: w(prev, x) < threshold[x];
    * out edges get ``alpha = 1/q + (1 - 1/q) * t`` with interpolant
      ``t = w(prev, x) / threshold[x]`` (0 for non-neighbors of prev);
    * out edges that are themselves noisy (w(cur, x) < threshold[cur])
      get ``alpha = min(1, 1/q)`` instead;
    * the return edge divides by p.

    The neighbors' thresholds come from the fused ``thr`` channel; the
    current node's own threshold is recomputed from its wgt channel.
    """
    d = _active_width(graph)
    cur_nbr = graph.rows_nbr(cur_rows)[:, :d]
    w = graph.rows_wgt(cur_rows)[:, :d]
    prev_nbr = graph.rows_nbr(prev_rows)[:, :d]
    found, prev_wgt_of = _locate_in_prev(
        cur_nbr, prev_nbr, graph.rows_wgt(prev_rows)[:, :d]
    )
    is_prev = cur_nbr == prev[:, None]

    if gamma is None:
        gamma = graph.gamma
    theta_x = graph.rows_thr(cur_rows)[:, :d]  # padded slots are 1.0
    theta_cur = row_thresholds(graph, cur_rows, gamma)[:, None]  # [B, 1]

    loose = prev_wgt_of < theta_x
    is_out = jnp.where(found, loose, True) & ~is_prev

    t = jnp.where(
        found & is_out, prev_wgt_of / jnp.maximum(theta_x, _EPS), 0.0
    )
    inv_q = 1.0 / q
    alpha = inv_q + (1.0 - inv_q) * t
    noisy = w < theta_cur
    alpha = jnp.where(noisy, jnp.minimum(1.0, inv_q), alpha)

    w = w * jnp.where(is_out, alpha, 1.0)
    w = w * jnp.where(is_prev, 1.0 / p, 1.0)
    return w


def node2vec_pp_weights_rows(
    graph: DeviceCSR,
    cur_rows: jax.Array,
    prev_rows: jax.Array,
    prev: jax.Array,
    p: float,
    q: float,
) -> jax.Array:
    """Experimental node2vec++ continuous bias weights from fused rows.

    Mirrors ``Node2vecPlusPlus.get_normalized_probs``
    (``experimental.py:61-102``, dense semantics, undirected assumed):
    out edges are candidates with w(prev, x) < threshold[x] (prev excluded);
    the interpolant t flips to ``1 - t`` when q < 1, and the bias is
    ``alpha = t * b / (1 + (b - 1)) * |1 - 1/q| + min(1, 1/q)`` with
    ``b = w(cur, x) / threshold[x]`` (as written in the reference the
    b-terms cancel; kept verbatim for parity).
    """
    d = _active_width(graph)
    cur_nbr = graph.rows_nbr(cur_rows)[:, :d]
    w = graph.rows_wgt(cur_rows)[:, :d]
    prev_nbr = graph.rows_nbr(prev_rows)[:, :d]
    _, prev_wgt_of = _locate_in_prev(
        cur_nbr, prev_nbr, graph.rows_wgt(prev_rows)[:, :d]
    )
    is_prev = cur_nbr == prev[:, None]

    theta_x = jnp.maximum(graph.rows_thr(cur_rows)[:, :d], _EPS)
    is_out = (prev_wgt_of < theta_x) & ~is_prev

    t = jnp.clip(prev_wgt_of / theta_x, 0.0, 1.0)
    t = jnp.where(q < 1.0, 1.0 - t, t)
    b = w / theta_x

    inv_q = 1.0 / q
    scale = jnp.abs(1.0 - inv_q)
    offset = jnp.minimum(1.0, inv_q)
    # 1 + (b - 1) == b; guard against b == 0 on padded zero-weight slots
    alpha = t * b / jnp.maximum(1.0 + (b - 1.0), _EPS) * scale + offset

    w = w * jnp.where(is_out, alpha, 1.0)
    w = w * jnp.where(is_prev, 1.0 / p, 1.0)
    return w


# -- index-taking wrappers (tests / scalar-compat paths; not walk-hot) -------


def first_order_weights(graph: DeviceCSR, cur: jax.Array) -> jax.Array:
    """Gather-then-compute wrapper around ``first_order_weights_rows``."""
    return first_order_weights_rows(graph, graph.gather_rows(cur))


def node2vec_weights(
    graph: DeviceCSR, cur: jax.Array, prev: jax.Array, p: float, q: float
) -> jax.Array:
    """Gather-then-compute wrapper around ``node2vec_weights_rows``."""
    return node2vec_weights_rows(
        graph, graph.gather_rows(cur), graph.gather_rows(prev), prev, p, q
    )


def node2vec_plus_weights(
    graph: DeviceCSR,
    cur: jax.Array,
    prev: jax.Array,
    p: float,
    q: float,
    gamma: Optional[float] = None,
) -> jax.Array:
    """Gather-then-compute wrapper around ``node2vec_plus_weights_rows``."""
    return node2vec_plus_weights_rows(
        graph,
        graph.gather_rows(cur),
        graph.gather_rows(prev),
        prev,
        p,
        q,
        gamma,
    )


def node2vec_pp_weights(
    graph: DeviceCSR, cur: jax.Array, prev: jax.Array, p: float, q: float
) -> jax.Array:
    """Gather-then-compute wrapper around ``node2vec_pp_weights_rows``."""
    return node2vec_pp_weights_rows(
        graph, graph.gather_rows(cur), graph.gather_rows(prev), prev, p, q
    )
