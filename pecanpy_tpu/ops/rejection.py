"""Degree-independent sampling for hub nodes: alias draws + rejection.

The fused-row kernels (``ops/transition.py``) are O(dpad) per walker per
step — unbeatable for bounded degrees, impossible for power-law hubs. For
steps touching a hub (degree > degree_cap) this module samples the *exact*
same transition distribution with O(1) memory transactions per trial,
regardless of degree:

1. **Proposal**: draw x ~ w(cur, .) — the first-order distribution. Hub
   rows draw from their packed alias rows (ONE 8-lane gather: the row
   carries the acceptance probability plus the neighbor/weight of the slot
   and of its alias target, ``ops/hubs.py``); capped rows draw from their
   carried fused row (elementwise cumsum, no memory access).
2. **Bias evaluation** for the single candidate x: the node2vec factor
   alpha(x) in {1/p, 1, 1/q} (or the node2vec+ continuous alpha) needs one
   membership test "is x a neighbor of prev" — ONE 8-lane gather of the
   hub's hash bucket, or a compare against prev's carried fused row.
3. **Accept** with probability alpha(x) / alpha_max where
   alpha_max = max(1/p, 1, 1/q) bounds every factor; otherwise retry.

This is the classic rejection formulation of second-order walks (used by
CPU/GPU systems like KnightKing) recast for batched walkers. The batch
dimension makes the naive loop-until-everyone-accepts catastrophic — the
max of B~1e5 geometric variables is ~30 rounds — and EVERY lane in a
trial batch costs real memory transactions whether or not it needs a
sample. The
sampler therefore never runs a full-batch round: lanes that need the
rejection path are *compacted first* (scatter-free: a cumsum +
searchsorted picks the first S pending lanes), and every phase runs on a
fixed sub-batch:

* phase 1 handles up to B/2 lanes with a small trial count (typical hub
  mixes put 30-50% of lanes on the rejection path, and the expected
  trials per lane is ~1/accept ≈ 2);
* a ``while_loop`` then re-compacts the survivors into B/8-lane sweeps
  until the (psum-shared, for the sharded layout) pending count drains.

The per-lane state the trial blocks need (the return-edge atom mass, the
fused rows) is sliced per phase from the compacted index set, so no
full-batch bucket probes happen anywhere.

A safety cap bounds the loop for degenerate p/q; lanes still unaccepted
at the cap keep their last proposal (probability <= (1-a)^(cap*T) —
negligible for any sane bias).
"""
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pecanpy_tpu.ops import hubs as hubs_lib
from pecanpy_tpu.ops import sampling
from pecanpy_tpu.ops.layout import DeviceCSR
from pecanpy_tpu.ops.transition import row_thresholds

_EPS = 1e-30
_KNUTH = np.uint32(2654435761)  # plain numpy: no backend init at import

# Knobs of the per-step sampler, swept on another accelerator (1M-node
# Chung-Lu mixed batch) and not yet re-measured on the GPU. A phase with
# S lanes and T trials issues ~2*S*T narrow-row gathers, so phase 1 sizes
# to the typical active fraction (~B/2 covers it) with few trials, and
# sweeps re-compact the geometric tail into B/8 blocks.
FIRST_ROUND_TRIALS = 2  # candidates per lane in the phase-1 blocks
FIRST_FRACTION = 4  # phase-1 sub-batch = B / FIRST_FRACTION per group
SWEEP_TRIALS = 4  # candidates per lane in each compacted sweep
COMPACT_FRACTION = 32  # sweep sub-batch = B / COMPACT_FRACTION per group
SWEEP_CAP = 256  # hard bound on while_loop sweeps (safety, never hit)


def alias_propose(
    dg: DeviceCSR, key: jax.Array, cur_rows: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Hub-path proposal: one packed alias-row gather per candidate.

    Returns ([B] x, [B] w(cur, x)); only meaningful where the row is a
    hub. (Strictly flat [B] shapes — see ``_trial_block``.)
    """
    k_slot, k_acc = jax.random.split(key)
    deg = dg.rows_degree(cur_rows)
    base = dg.rows_edge_base(cur_rows)
    kk = jax.random.randint(k_slot, deg.shape, 0, jnp.maximum(deg, 1))
    rows = dg.fetch_edge_slots(base + kk.astype(jnp.int32))
    take_self = (
        jax.random.uniform(k_acc, deg.shape) < rows[..., hubs_lib.EP_ACCEPT]
    )
    nbr_pair = jax.lax.bitcast_convert_type(
        rows[..., [hubs_lib.EP_NBR_SELF, hubs_lib.EP_NBR_ALIAS]], jnp.int32
    )
    x = jnp.where(take_self, nbr_pair[..., 0], nbr_pair[..., 1])
    w = jnp.where(
        take_self,
        rows[..., hubs_lib.EP_WGT_SELF],
        rows[..., hubs_lib.EP_WGT_ALIAS],
    )
    return x, w


def fused_propose(
    dg: DeviceCSR, key: jax.Array, cur_rows: jax.Array, use_cdf: bool
) -> Tuple[jax.Array, jax.Array]:
    """Capped-row proposal from the carried fused row (no memory access)."""
    if use_cdf:
        cdf = dg.rows_cdf(cur_rows)
    else:
        cdf = jnp.cumsum(dg.rows_wgt(cur_rows), axis=-1)
    total = cdf[:, -1:]
    u = jax.random.uniform(key, (cdf.shape[0],), dtype=cdf.dtype)
    c = jnp.sum(cdf < u[:, None] * total, -1)
    c = jnp.minimum(c, cdf.shape[-1] - 1)
    cols = jnp.arange(cdf.shape[-1], dtype=jnp.int32)
    onehot = cols == c[..., None]
    nbr = dg.rows_nbr(cur_rows)
    wgt = dg.rows_wgt(cur_rows)
    x = jnp.sum(jnp.where(onehot, nbr, 0), -1)
    w = jnp.sum(jnp.where(onehot, wgt, 0.0), -1)
    return x, w


def propose(
    dg: DeviceCSR,
    key: jax.Array,
    cur_rows: jax.Array,
    use_cdf: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """First-order draw x ~ w(cur, .), hub and capped paths combined."""
    k_hub, k_small = jax.random.split(key)
    x_s, w_s = fused_propose(dg, k_small, cur_rows, use_cdf)
    if not dg.has_hubs:
        return x_s, w_s
    x_h, w_h = alias_propose(dg, k_hub, cur_rows)
    is_hub = dg.rows_is_hub(cur_rows)
    return jnp.where(is_hub, x_h, x_s), jnp.where(is_hub, w_h, w_s)


def uniform_propose(
    dg: DeviceCSR, key: jax.Array, cur_rows: jax.Array
) -> jax.Array:
    """Uniform neighbor draw (FirstOrderUnweighted), hub-aware."""
    deg = dg.rows_degree(cur_rows)
    kk = jax.random.randint(
        key, deg.shape, 0, jnp.maximum(deg, 1)
    ).astype(jnp.int32)
    x_s = sampling.pick_int_columns(dg.rows_nbr(cur_rows), kk)
    if not dg.has_hubs:
        return x_s
    rows = dg.fetch_edge_slots(dg.rows_edge_base(cur_rows) + kk)
    x_h = jax.lax.bitcast_convert_type(
        rows[..., hubs_lib.EP_NBR_SELF], jnp.int32
    )
    return jnp.where(dg.rows_is_hub(cur_rows), x_h, x_s)


def membership(
    dg: DeviceCSR,
    x: jax.Array,
    prev_rows: jax.Array,
    mode: str = "auto",
) -> Tuple[jax.Array, jax.Array]:
    """(x in nbr(prev), w(prev, x)) — bucket probe or carried-row compare.

    The degree-independent replacement for the reference's sorted-merge
    ``isnotin`` / ``isnotin_extended`` (``sparse_rw.py:142-295``) for
    per-walker candidates. ``x`` may be [B] or [B, T].

    ``mode`` (static): "auto" computes both paths and selects per lane;
    "row" / "hub" run only the carried-row compare / only the hash-bucket
    probe — for callers that pre-partition their lanes by prev-hubness,
    which skips the bucket gather for row lanes and the [.., dpad]
    compare for hub lanes (each costs real milliseconds at batch size).
    """
    if mode == "row" or not dg.has_hubs:
        pn = dg.rows_nbr(prev_rows)
        pw = dg.rows_wgt(prev_rows)
        eq = pn == x[..., None]
        return (
            jnp.any(eq, axis=-1),
            jnp.sum(jnp.where(eq, pw, 0.0), axis=-1),
        )

    hbase, hlog = dg.rows_hash_meta(prev_rows)
    mask = (
        jnp.uint32(1) << jnp.clip(hlog, 0, 30).astype(jnp.uint32)
    ) - jnp.uint32(1)
    bucket = hbase + ((x.astype(jnp.uint32) * _KNUTH) & mask).astype(
        jnp.int32
    )
    keys, vals = dg.fetch_bucket(bucket)  # one 64-lane gather
    hit = keys == x[..., None]
    found_h = jnp.any(hit, axis=-1)
    w_h = jnp.sum(jnp.where(hit, vals, 0.0), axis=-1)
    if mode == "hub":
        return found_h, w_h

    found_s, w_s = membership(dg, x, prev_rows, mode="row")
    is_hub = dg.rows_is_hub(prev_rows)
    return (
        jnp.where(is_hub, found_h, found_s),
        jnp.where(is_hub, w_h, w_s),
    )


def _expand(sub: jax.Array, pos: jax.Array, valid: jax.Array, fill):
    """full[i] = sub[pos[i]] where valid else fill (elementwise gather).

    The scatter-free return path of the tiered trial block: compacted
    hub results come back to full-batch lanes through each lane's
    compaction RANK — an elementwise gather in place of a scatter.
    """
    v = sub[jnp.minimum(pos, sub.shape[0] - 1)]
    return jnp.where(valid, v, fill)


def tier_compact(dg: DeviceCSR, cur_rows: jax.Array, prev_rows: jax.Array,
                 s: int):
    """Round-stable compaction of the hub descriptor work.

    The amortized trial block issues its two per-trial gathers (alias
    proposal row, membership hash bucket) over the FULL batch even
    though only cur-hub lanes consume the first and prev-hub lanes the
    second (~37% each on the Chung-Lu bench) — gathers are
    descriptor-rate-bound, so every inactive lane pays full price.
    This helper compacts each hub group once per ROUND (the groups are
    round-stable: lane residency only changes when a lane advances, at
    round end) into an ``s``-lane sub-batch; every trial of the round
    then runs its descriptor gathers at s lanes and expands results
    back by rank (``_expand``).

    Lanes whose group overflows ``s`` are marked unserved; the caller
    voids their trials for this round (they retry next round). The void
    decision depends only on round-stable state — never on the trial's
    own randomness — so the sampled law is unchanged; overflow only
    delays those lanes. Callers size ``s`` with slack above the graph's
    hub-edge fraction so overflow is rare.

    Returns a dict of compacted operands (see the field comments).
    """
    cur_hub = dg.rows_is_hub(cur_rows)
    prev_hub = dg.rows_is_hub(prev_rows)
    ca = jnp.cumsum(cur_hub.astype(jnp.int32))
    cb = jnp.cumsum(prev_hub.astype(jnp.int32))
    idx_a, _ = _compact_indices(cur_hub, s)
    idx_b, _ = _compact_indices(prev_hub, s)
    deg = dg.rows_degree(cur_rows)
    base = dg.rows_edge_base(cur_rows)
    hbase, hlog = dg.rows_hash_meta(prev_rows)
    served_a = cur_hub & (ca <= s)
    served_b = prev_hub & (cb <= s)
    return dict(
        cur_hub=cur_hub,
        prev_hub=prev_hub,
        pos_a=jnp.minimum(ca - 1, s - 1),  # rank of lane i in group a
        pos_b=jnp.minimum(cb - 1, s - 1),
        deg_a=deg[idx_a],  # [s] alias metadata of the compacted lanes
        base_a=base[idx_a],
        idx_b=idx_b,  # [s] lane of each prev-hub slot (slices x per trial)
        hbase_b=hbase[idx_b],
        hlog_b=hlog[idx_b],
        served=(~cur_hub | served_a) & (~prev_hub | served_b),
    )


def _alias_propose_tiered(dg: DeviceCSR, key: jax.Array, tier):
    """[s] alias proposals for the compacted cur-hub lanes."""
    k_slot, k_acc = jax.random.split(key)
    deg, base = tier["deg_a"], tier["base_a"]
    kk = jax.random.randint(k_slot, deg.shape, 0, jnp.maximum(deg, 1))
    rows = dg.fetch_edge_slots(base + kk.astype(jnp.int32))
    take_self = (
        jax.random.uniform(k_acc, deg.shape) < rows[..., hubs_lib.EP_ACCEPT]
    )
    nbr_pair = jax.lax.bitcast_convert_type(
        rows[..., [hubs_lib.EP_NBR_SELF, hubs_lib.EP_NBR_ALIAS]], jnp.int32
    )
    x = jnp.where(take_self, nbr_pair[..., 0], nbr_pair[..., 1])
    w = jnp.where(
        take_self,
        rows[..., hubs_lib.EP_WGT_SELF],
        rows[..., hubs_lib.EP_WGT_ALIAS],
    )
    return x, w


def _membership_tiered(dg: DeviceCSR, x: jax.Array, tier):
    """[s] bucket probes of candidate x for the compacted prev-hub lanes."""
    x_b = x[tier["idx_b"]]
    mask = (
        jnp.uint32(1) << jnp.clip(tier["hlog_b"], 0, 30).astype(jnp.uint32)
    ) - jnp.uint32(1)
    bucket = tier["hbase_b"] + (
        (x_b.astype(jnp.uint32) * _KNUTH) & mask
    ).astype(jnp.int32)
    keys, vals = dg.fetch_bucket(bucket)
    hit = keys == x_b[..., None]
    return jnp.any(hit, axis=-1), jnp.sum(jnp.where(hit, vals, 0.0), axis=-1)


def _bias_from_membership(
    dg: DeviceCSR,
    x: jax.Array,
    wx: jax.Array,
    prev: jax.Array,
    cur_rows: jax.Array,
    found: jax.Array,
    wpx: jax.Array,
    p: float,
    q: float,
    extend: bool,
) -> jax.Array:
    """Bias factor alpha(x) given the membership test's (found, w(prev,x))."""
    is_prev = x == prev
    inv_q = 1.0 / q
    if not extend:
        return jnp.where(is_prev, 1.0 / p, jnp.where(found, 1.0, inv_q))

    theta_x = jnp.maximum(dg.threshold[x], _EPS)
    theta_cur = row_thresholds(dg, cur_rows, dg.gamma)
    if dg.has_hubs:
        theta_cur = jnp.where(
            dg.rows_is_hub(cur_rows),
            dg.rows_hub_threshold(cur_rows),
            theta_cur,
        )

    loose = wpx < theta_x
    is_out = jnp.where(found, loose, True) & ~is_prev
    t = jnp.where(found & is_out, wpx / theta_x, 0.0)
    alpha_out = inv_q + (1.0 - inv_q) * t
    noisy = wx < theta_cur
    alpha_out = jnp.where(noisy, jnp.minimum(1.0, inv_q), alpha_out)
    return jnp.where(is_prev, 1.0 / p, jnp.where(is_out, alpha_out, 1.0))


def _bias(
    dg: DeviceCSR,
    x: jax.Array,
    wx: jax.Array,
    prev: jax.Array,
    cur_rows: jax.Array,
    prev_rows: jax.Array,
    p: float,
    q: float,
    extend: bool,
    mode: str = "auto",
) -> jax.Array:
    """node2vec / node2vec+ bias factor alpha(x) for single candidates.

    Mirrors the fused kernels (``transition.node2vec_weights_rows`` /
    ``node2vec_plus_weights_rows``) evaluated per candidate. ``x`` is
    flat [B]. ``mode`` routes the membership test (see there).
    """
    found, wpx = membership(dg, x, prev_rows, mode=mode)
    return _bias_from_membership(
        dg, x, wx, prev, cur_rows, found, wpx, p, q, extend
    )


def _single_trial(
    dg, key, prev, cur_rows, prev_rows, p, q, extend, alpha_np,
    theta, wp, mode, use_cdf=False, tier=None,
):
    """One flat [B] proposal + accept test per lane.

    With ``tier`` (see ``tier_compact``) the two descriptor gathers run
    on the compacted hub sub-batches; unserved lanes' accepts are voided
    by the caller via ``tier["served"]``.
    """
    k_prop, k_acc, k_atom = jax.random.split(key, 3)
    if tier is None or not dg.has_hubs:
        x, wx = propose(dg, k_prop, cur_rows, use_cdf=use_cdf)
    else:
        k_hub, k_small = jax.random.split(k_prop)
        x_s, w_s = fused_propose(dg, k_small, cur_rows, use_cdf)
        xh_sub, wh_sub = _alias_propose_tiered(dg, k_hub, tier)
        hub, pos = tier["cur_hub"], tier["pos_a"]
        x = _expand(xh_sub, pos, hub, x_s)
        wx = _expand(wh_sub, pos, hub, w_s)
    if theta is not None:
        atom = jax.random.uniform(k_atom, theta.shape) < theta
        x = jnp.where(atom, prev, x)
        wx = jnp.where(atom, wp, wx)
    if tier is None or not dg.has_hubs:
        alpha = _bias(
            dg, x, wx, prev, cur_rows, prev_rows, p, q, extend, mode=mode
        )
    else:
        found_s, w_ps = membership(dg, x, prev_rows, mode="row")
        fh_sub, wh_sub2 = _membership_tiered(dg, x, tier)
        phub, pos_b = tier["prev_hub"], tier["pos_b"]
        found = _expand(fh_sub, pos_b, phub, found_s)
        wpx = _expand(wh_sub2, pos_b, phub, w_ps)
        alpha = _bias_from_membership(
            dg, x, wx, prev, cur_rows, found, wpx, p, q, extend
        )
    accept = alpha / alpha_np
    if theta is not None:
        accept = jnp.where(x == prev, 1.0, accept)
    ok = jax.random.uniform(k_acc, x.shape) < accept
    return x, ok, wx


def _trial_block(
    dg, key, prev, cur_rows, prev_rows, p, q, extend, alpha_np, trials,
    theta=None, wp=None, mode="auto", use_cdf=False, force_ok=None,
    tier=None,
):
    """T iid proposals per lane; returns (first accepted or last, any ok,
    w(cur, chosen)).

    ``force_ok`` ([B] bool, optional) marks lanes whose trial-1 proposal
    is accepted unconditionally — the queued engine's FIRST-ORDER steps,
    where the first-order draw IS the transition law (no bias factor;
    the caller zeroes those lanes' atom mass so the proposal is a pure
    first-order draw).

    The T trials run as a STATIC Python loop of flat [B] evaluations
    rather than a [B, T] trial axis, whose tiny minor dimension pads
    badly on some accelerators; T sequential flat blocks cost exactly
    T x one trial.

    ``alpha_np`` bounds the bias over non-return candidates
    (max(1, 1/q)). With the return-edge atom (``theta``/``wp`` set), a
    proposal is the previous node with probability theta and a
    first-order draw otherwise; x == prev always accepts (see module
    docstring — exactness verified against the plain construction).
    Without the atom, alpha_np must also bound 1/p. ``mode`` routes the
    membership test (see ``membership``).
    """
    chosen = None
    for t in range(trials):
        x_t, ok_t, wx_t = _single_trial(
            dg, jax.random.fold_in(key, t), prev, cur_rows, prev_rows,
            p, q, extend, alpha_np, theta, wp, mode, use_cdf=use_cdf,
            tier=tier,
        )
        if force_ok is not None:
            ok_t = ok_t | force_ok
        if tier is not None and dg.has_hubs:
            # overflowed hub lanes void the whole trial (pre-randomness
            # decision — unbiased; they simply retry next round)
            ok_t = ok_t & tier["served"]
        if chosen is None:
            chosen, got, chosen_w = x_t, ok_t, wx_t
        else:
            # first accepted wins; lanes with no accept yet track the
            # freshest proposal (the safety-cap fallback)
            chosen = jnp.where(~got, x_t, chosen)
            chosen_w = jnp.where(~got, wx_t, chosen_w)
            got = got | ok_t
    return chosen, got, chosen_w


_CBLK = 128  # compaction block width (one fast row gather per query)


def _compact_indices(pending: jax.Array, s: int):
    """Indices of the first ``s`` pending lanes, scatter- and scan-free.

    The lane holding the j-th pending slot is the searchsorted position
    of j+1 in the (monotone) cumsum of the pending mask — but BOTH
    ``jnp.searchsorted`` (log(B) serialized element-gather rounds) and a
    scatter-built slot table are avoided here. Instead the cumsum
    reshapes to [B/128, 128] and the search runs blocked: a broadcast
    compare against the per-block maxima picks the block, one 128-lane
    ROW gather fetches it, and a second
    broadcast compare picks the lane — two compares and one fast-path
    row gather total.

    Returns (idx [s] int32 clamped in-range, valid [s] bool).
    """
    b = pending.shape[0]
    csum = jnp.cumsum(pending.astype(jnp.int32))
    total = csum[-1]
    pad = (-b) % _CBLK
    if pad:
        csum = jnp.pad(csum, (0, pad), constant_values=jnp.iinfo(jnp.int32).max)
    c2 = csum.reshape(-1, _CBLK)
    block_max = c2[:, -1]  # nondecreasing
    j = jnp.arange(s, dtype=jnp.int32)
    tgt = j + 1
    blk = jnp.sum(
        (block_max[None, :] < tgt[:, None]).astype(jnp.int32), axis=1
    )
    blk = jnp.minimum(blk, c2.shape[0] - 1)
    rows = c2[blk]  # [s, 128] row gather
    col = jnp.sum((rows < tgt[:, None]).astype(jnp.int32), axis=1)
    idx = blk * _CBLK + jnp.minimum(col, _CBLK - 1)
    return jnp.minimum(idx, b - 1), j < total


def second_order_sample(
    dg: DeviceCSR,
    key: jax.Array,
    cur: jax.Array,
    prev: jax.Array,
    cur_rows: jax.Array,
    prev_rows: jax.Array,
    p: float,
    q: float,
    extend: bool,
    active: jax.Array,
) -> jax.Array:
    """Exact 2nd-order transition draw by rejection, O(1) per trial.

    Args:
        active: [B] bool — lanes that need a rejection-path sample (the
            rest are pre-accepted so the loop never waits on them).

    Returns [B] int32 samples (valid where active).
    """
    b = cur.shape[0]
    alpha_np = max(1.0, 1.0 / q)  # bound over non-return candidates
    use_atom = (1.0 / p - alpha_np) > 0.0
    # partition the rejection lanes by PREV-hubness: the "hub" group's
    # membership test is a bucket probe only, the "row" group's a carried
    # -row compare only — each group skips the other's cost (the bucket
    # gather and the [.., dpad] compare are the two biggest terms of the
    # unpartitioned trial block)
    part = dg.has_hubs

    # When the hub tables are row-sharded (parallel/distgraph.py), every
    # fetch inside the sweep is a collective — all shards must take the
    # same number of sweeps or the collectives deadlock, so the loop
    # condition is the psum-shared global pending count. The group split
    # is static, so the collective schedule matches across shards.
    sync_axis = getattr(dg, "loop_sync_axis", None)

    def pending_of(*pendings):
        n_pend = sum(jnp.sum(pnd) for pnd in pendings)
        if sync_axis is not None:
            n_pend = jax.lax.psum(n_pend, sync_axis)
        return n_pend

    if use_atom:
        # return-edge atom: propose x = prev with the exact mixture
        # mass, removing the 1/p factor from the rejection bound.
        # Computed ONCE over the full batch (one membership probe of
        # "is prev a neighbor of CUR", routed by cur-hubness) — phases
        # slice it; per-phase recompute would repeat the probe every
        # sweep iteration.
        excess = 1.0 / p - alpha_np
        _, wp_full = membership(dg, prev, cur_rows)
        wsum = jnp.sum(dg.rows_wgt(cur_rows), axis=-1)
        if dg.has_hubs:
            wsum = jnp.where(
                dg.rows_is_hub(cur_rows), dg.rows_hub_wsum(cur_rows), wsum
            )
        theta_full = (
            wp_full * excess
            / (wp_full * excess + alpha_np * jnp.maximum(wsum, _EPS))
        )
    else:
        theta_full, wp_full = None, None

    def run_phase(nxt, pending, phase_key, s, trials, mode):
        """One compacted trial phase over the first S pending lanes."""
        idx, valid = _compact_indices(pending, s)
        prev_i = prev[idx]
        cr_i = cur_rows[idx]
        pr_i = prev_rows[idx]
        theta = None if theta_full is None else theta_full[idx]
        wp_arr = None if wp_full is None else wp_full[idx]
        x_sub, ok_sub, _ = _trial_block(
            dg, phase_key, prev_i, cr_i, pr_i, p, q, extend,
            alpha_np, trials, theta, wp_arr, mode=mode,
        )
        # every valid lane records its freshest proposal (pending lanes
        # get overwritten by a later sweep; if the safety cap trips, the
        # last proposal stands); accepted lanes leave the pending set
        write_to = jnp.where(valid, idx, b)
        nxt = nxt.at[write_to].set(x_sub, mode="drop")
        clear_to = jnp.where(valid & ok_sub, idx, b)
        pending = pending.at[clear_to].set(False, mode="drop")
        return nxt, pending

    s1 = min(max(-(-b // FIRST_FRACTION), 8), b)
    s2 = min(max(-(-b // COMPACT_FRACTION), 8), b)

    if not part:
        # no hubs anywhere (compat path): single group, row membership
        nxt, pending = run_phase(
            cur, active, jax.random.fold_in(key, 0), s1,
            FIRST_ROUND_TRIALS, "row",
        )

        def cond(state):
            # the count is computed in the body and carried (a collective
            # in the cond itself would not lower under shard_map)
            _, _, pend, t = state
            return (pend > 0) & (t < SWEEP_CAP)

        def body(state):
            nxt, pending, _, t = state
            nxt, pending = run_phase(
                nxt, pending, jax.random.fold_in(key, 1 + t), s2,
                SWEEP_TRIALS, "row",
            )
            return nxt, pending, pending_of(pending), t + 1

        nxt, pending, _, _ = jax.lax.while_loop(
            cond, body, (nxt, pending, pending_of(pending), jnp.int32(0))
        )
        return nxt

    prev_hub = dg.rows_is_hub(prev_rows)
    pend_h = active & prev_hub
    pend_n = active & ~prev_hub

    # phase 1: each group gets an s1-lane compacted block
    nxt, pend_h = run_phase(
        cur, pend_h, jax.random.fold_in(key, 0), s1,
        FIRST_ROUND_TRIALS, "hub",
    )
    nxt, pend_n = run_phase(
        nxt, pend_n, jax.random.fold_in(key, 1), s1,
        FIRST_ROUND_TRIALS, "row",
    )

    def cond2(state):
        _, _, _, pend, t = state
        return (pend > 0) & (t < SWEEP_CAP)

    def body2(state):
        nxt, pend_h, pend_n, _, t = state
        nxt, pend_h = run_phase(
            nxt, pend_h, jax.random.fold_in(key, 2 + 2 * t), s2,
            SWEEP_TRIALS, "hub",
        )
        nxt, pend_n = run_phase(
            nxt, pend_n, jax.random.fold_in(key, 3 + 2 * t), s2,
            SWEEP_TRIALS, "row",
        )
        return nxt, pend_h, pend_n, pending_of(pend_h, pend_n), t + 1

    nxt, pend_h, pend_n, _, _ = jax.lax.while_loop(
        cond2,
        body2,
        (nxt, pend_h, pend_n, pending_of(pend_h, pend_n), jnp.int32(0)),
    )
    return nxt
