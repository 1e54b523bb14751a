"""The batched walk engine: one ``lax.scan`` over steps, B walkers at once.

The reference drives each walk with a scalar Python loop compiled by Numba
(``Base._random_walks``, ``pecanpy.py:164-210``), parallelized with
``prange`` threads over walks. The device formulation inverts the loop
nest: the *batch* axis holds thousands of walkers advancing in lockstep,
and the sequential walk-length axis is a compiled ``lax.scan``.

Memory discipline (the perf-critical design point): the fused rows of the
current AND previous node ride in the scan carry, so each step performs
exactly ONE table gather — fetching the fused row of the node just stepped
to. The previous node's row is last step's current row, renamed. The
membership test, bias, CDF sampling, and the next-node pick are all
elementwise work on rows already gathered, instead of the naive
4-gathers-per-step formulation.

Every mode plugs into the engine through two step callables:

    first_fn(key, cur, cur_rows)                  -> next   (1st-order)
    step_fn(key, cur, prev, cur_rows, prev_rows)  -> next   (2nd-order)

Walk semantics preserved from the reference (``pecanpy.py:180-206``):

* column 0 holds the start node; steps fill columns 1..L;
* a walker whose current node has no neighbors stops: the *effective
  length* records how many valid entries the walk has (L+1 when it never
  stopped, j when the node reached at column j-1 had no out-edges);
* dead walkers keep emitting their resting node, which is never read
  because consumers cut each walk at its effective length.
"""
import os
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from pecanpy_tpu.ops import rejection
from pecanpy_tpu.ops.layout import DeviceCSR

FirstFn = Callable[[jax.Array, jax.Array, jax.Array], jax.Array]
StepFn = Callable[
    [jax.Array, jax.Array, jax.Array, jax.Array, jax.Array], jax.Array
]


def _tier_lanes(graph: DeviceCSR, b: int) -> int:
    """Compacted hub sub-batch size for the tiered trial block (0 = off).

    OPT-IN (``PECANPY_TPU_TIERED=1``); it measured slower than the
    full-batch block on the accelerator it was written for: the
    compact-then-expand round trip replaces full-batch alias/bucket
    gathers with s-lane gathers PLUS per-trial elementwise expansion
    gathers. Not measured on the GPU. Kept behind the flag with
    distribution tests; the sampled law is exact either way.

    When enabled: sized to the graph's hub-edge fraction (the
    stationary share of lanes standing at / coming from a hub) plus
    slack; when hubs carry most of the edge mass the compaction saves
    too little to pay for itself and the full-batch block runs instead.
    """
    if not graph.has_hubs:
        return 0
    if os.environ.get("PECANPY_TPU_TIERED", "0") in ("0", "false"):
        return 0
    frac = graph.hub_frac + float(
        os.environ.get("PECANPY_TPU_TIER_SLACK", "0.08")
    )
    if frac >= 0.6:
        return 0
    s = max(256, -(-int(b * frac) // 128) * 128)
    return min(s, b)


def generate_walks(
    graph: DeviceCSR,
    first_fn: FirstFn,
    step_fn: StepFn,
    start: jax.Array,
    key: jax.Array,
    walk_length: int,
) -> Tuple[jax.Array, jax.Array]:
    """Advance a batch of walkers ``walk_length`` steps.

    Args:
        graph: fused device CSR.
        first_fn / step_fn: mode-specific transition samplers (see module
            docstring for signatures).
        start: [B] int32 start nodes.
        key: PRNG key for the whole batch.
        walk_length: number of steps L (static).

    Returns:
        walks: [B, L + 1] int32 node indices, column 0 = start.
        eff_len: [B] int32 effective walk lengths in [1, L + 1].
    """
    sentinel = graph.num_nodes
    key_first, key_rest = jax.random.split(key)

    start_rows = graph.gather_rows(start)
    alive0 = graph.rows_nbr(start_rows)[:, 0] != sentinel
    first = first_fn(key_first, start, start_rows)
    col1 = jnp.where(alive0, first, start)
    eff0 = jnp.where(alive0, walk_length + 1, 1).astype(jnp.int32)

    if walk_length == 1:
        return jnp.stack([start, col1], axis=1), eff0

    col1_rows = graph.gather_rows(col1)

    def body(carry, inp):
        cur, prev, cur_rows, prev_rows, alive, eff = carry
        step_idx, step_key = inp
        has = graph.rows_nbr(cur_rows)[:, 0] != sentinel
        eff = jnp.where(alive & ~has, step_idx, eff)
        alive = alive & has
        nxt = step_fn(step_key, cur, prev, cur_rows, prev_rows)
        nxt = jnp.where(alive, nxt, cur)
        nxt_rows = graph.gather_rows(nxt)  # THE one gather per step
        return (nxt, cur, nxt_rows, cur_rows, alive, eff), nxt

    step_ids = jnp.arange(2, walk_length + 1, dtype=jnp.int32)
    step_keys = jax.random.split(key_rest, walk_length - 1)
    carry0 = (col1, start, col1_rows, start_rows, alive0, eff0)
    (_, _, _, _, _, eff_len), cols = jax.lax.scan(
        body, carry0, (step_ids, step_keys)
    )

    walks = jnp.concatenate(
        [start[:, None], col1[:, None], cols.T.astype(jnp.int32)], axis=1
    )
    return walks, eff_len


def generate_walks_queued(
    graph: DeviceCSR,
    starts: jax.Array,
    key: jax.Array,
    walk_length: int,
    p: float,
    q: float,
    extend: bool,
    lanes: int = 32768,
    trials: int = 2,
    round_cap_factor: int = 40,
    return_rounds: bool = False,
    undirected: Optional[bool] = None,
    unroll: int = 4,
    flush_every: int = 4,
):
    """Persistent-lane amortized walker over a walk QUEUE (W >= lanes).

    ``generate_walks_amortized`` pays its stall tail once per B-lane
    batch: the batch only returns when the SLOWEST lane has drained its
    sum of geometric retries, so the round count is
    ``max_over_B(sum_j Geom_j)`` — measured ~185 rounds for a mean-~114
    workload at B=32k (a 2.3x inflation over the 80 accepted steps).
    This engine decouples walks from lanes: B persistent lanes process a
    queue of W walks, and a lane that finishes its walk (completed L
    columns, or died on a neighborless node) immediately claims the next
    unstarted walk from the queue. The straggler tail is then paid once
    per WORKLOAD, not once per batch — per-walk round inflation drops
    from ~2.3x toward the ~1/accept_per_round floor (~1.4x at the
    default T=2) with no change to the sampled law.

    Per-walk semantics (start column, early termination, effective
    lengths, resting-node emission) match ``generate_walks``; each
    step's transition law is the exact second-order distribution, via
    the same trial blocks as the amortized engine. First-order steps
    (column 1 of each walk) run as auto-accepted trials with the atom
    mass zeroed, so a claimed walk starts advancing one round after its
    claim.

    Execution structure (what keeps the round cheap): every round's
    walk writes go to a PER-LANE local buffer via the amortized
    engine's masked-where trick — per-round scatters into the [W, L+1]
    output cost more than the straggler amortization saves (on the
    accelerator this was written for; not re-measured on the GPU).
    Finished rows are flushed to the output with ONE row
    scatter per ``unroll`` block, and claims happen at the same block
    boundary — a finished lane idles at most ``unroll - 1`` rounds per
    walk transition (~2% of a walk's lifetime at the defaults).

    Determinism: output row w always serves ``starts[w]``; the walk
    CONTENT for a fixed key additionally depends on (lanes, W) — the
    lane scheduling feeds the per-round key stream — matching the
    engine-level contract (walks already depend on the batch split).

    Args:
        starts: [W] int32 start nodes (the walk queue; W >= 1).
        lanes: persistent walker lanes B (walks in flight at once).
        flush_every: flush + claim once per this many ``unroll`` blocks.
            Larger values amortize the flush scatters further at the
            price of finished lanes idling up to
            ``unroll * flush_every - 1`` rounds before their next claim
            (~2% of a walk's lifetime at 4). The default is not yet
            re-measured on the GPU.
        Other args as in ``generate_walks_amortized``.

    Returns:
        walks: [W, L + 1] int32; eff_len: [W] int32;
        (+ rounds taken when ``return_rounds``).
    """
    if undirected is None:
        undirected = graph.symmetric
    if os.environ.get("PECANPY_TPU_RBG", "0") == "1":
        data = jax.random.key_data(key).astype(jnp.uint32)
        key = jax.random.key(data[0] ^ (data[1] << 7), impl="rbg")
    w_total = starts.shape[0]
    b = min(lanes, w_total)
    sentinel = graph.num_nodes
    alpha_np = max(1.0, 1.0 / q)
    excess = 1.0 / p - alpha_np
    use_atom = excess > 0.0
    use_cdf = "cdf" in graph.channels
    cols_row = jnp.arange(walk_length + 1, dtype=jnp.int32)

    # lane i starts on walk i; the queue cursor sits past them
    wid0 = jnp.arange(b, dtype=jnp.int32)
    cur0 = starts[:b]
    cur_rows0 = graph.gather_rows(cur0)

    big = jnp.zeros((w_total, walk_length + 1), dtype=jnp.int32)
    eff_big = jnp.full((w_total,), walk_length + 1, dtype=jnp.int32)
    buf_l = jnp.zeros((b, walk_length + 1), dtype=jnp.int32)
    buf_l = buf_l.at[:, 0].set(cur0)
    eff_l = jnp.full((b,), walk_length + 1, dtype=jnp.int32)

    zero_b = jnp.zeros((b,), dtype=jnp.float32)
    step0 = jnp.ones((b,), dtype=jnp.int32)  # next column to write
    active0 = jnp.ones((b,), dtype=bool)
    done0 = jnp.zeros((b,), dtype=bool)

    n_batches = -(-w_total // b)
    round_cap = n_batches * walk_length * round_cap_factor + 64
    tier_s = _tier_lanes(graph, b)

    def trial_fn(rkey, prev_, cur_rows_, prev_rows_, theta_, wp_, first_,
                 tier_):
        return rejection._trial_block(
            graph, rkey, prev_, cur_rows_, prev_rows_, p, q, extend,
            alpha_np, trials, theta_, wp_, mode="auto", use_cdf=use_cdf,
            force_ok=first_, tier=tier_,
        )

    def _theta_from(wp, cur_rows):
        wsum = jnp.sum(graph.rows_wgt(cur_rows), axis=-1)
        if graph.has_hubs:
            wsum = jnp.where(
                graph.rows_is_hub(cur_rows),
                graph.rows_hub_wsum(cur_rows),
                wsum,
            )
        return (
            wp * excess
            / (wp * excess + alpha_np * jnp.maximum(wsum, rejection._EPS))
        )

    def round_body(state):
        (wid, cur, prev, cur_rows, prev_rows, step, active, done, theta,
         wp, buf_l, eff_l, big, eff_big, next_w, pending, t) = state
        rkey = jax.random.fold_in(key, t)

        # -- dead-arrival / dead-start check on the current node --------
        has = graph.rows_nbr(cur_rows)[:, 0] != sentinel
        died = active & ~has & (step <= walk_length)
        eff_l = jnp.where(died, step, eff_l)

        # -- one trial block over every lane (first-order lanes force
        #    acceptance of trial 1's proposal; their atom mass is 0) ----
        first = step == 1
        needs = active & has & (step <= walk_length)
        tier = (
            rejection.tier_compact(graph, cur_rows, prev_rows, tier_s)
            if tier_s
            else None
        )
        x, ok, wx = trial_fn(
            rkey, prev, cur_rows, prev_rows,
            theta if use_atom else None, wp if use_atom else None,
            first, tier,
        )
        adv = needs & ok
        new_cur = jnp.where(adv, x, cur)
        new_prev = jnp.where(adv, cur, prev)
        new_prev_rows = jnp.where(adv[:, None], cur_rows, prev_rows)
        # masked-where write into the LANE-LOCAL row (same trick as the
        # per-batch amortized engine, in place of a scatter)
        col = jnp.where(adv, step, walk_length + 2)
        buf_l = jnp.where(
            cols_row[None, :] == col[:, None], x[:, None], buf_l
        )
        step = step + adv.astype(jnp.int32)

        # finished lanes park until the block-boundary flush + claim
        finished = died | (step > walk_length)
        done = done | (active & finished)
        active = active & ~finished

        nxt_rows = graph.gather_rows(new_cur)  # THE one gather per round
        if use_atom:
            if undirected:
                theta_n, wp_n = _theta_from(wx, nxt_rows), wx
            else:
                _, wp_n = rejection.membership(graph, new_prev, nxt_rows)
                theta_n = _theta_from(wp_n, nxt_rows)
            theta = jnp.where(adv, theta_n, theta)
            wp = jnp.where(adv, wp_n, wp)
        return (wid, new_cur, new_prev, nxt_rows, new_prev_rows, step,
                active, done, theta, wp, buf_l, eff_l, big, eff_big,
                next_w, pending, t + 1)

    def flush_claim(state):
        """Block boundary: flush done lanes' rows to the output (one row
        scatter + one eff scatter), then claim new walks for them."""
        (wid, cur, prev, cur_rows, prev_rows, step, active, done, theta,
         wp, buf_l, eff_l, big, eff_big, next_w, pending, t) = state
        tgt = jnp.where(done, wid, w_total)
        big = big.at[tgt].set(buf_l, mode="drop")
        eff_big = eff_big.at[tgt].set(eff_l, mode="drop")

        rank = jnp.cumsum(done.astype(jnp.int32))
        wid_new = next_w + rank - 1
        claim = done & (wid_new < w_total)
        next_w = jnp.minimum(next_w + rank[-1], w_total)
        wid = jnp.where(claim, wid_new, wid)
        start_new = starts[jnp.minimum(wid_new, w_total - 1)]
        cur = jnp.where(claim, start_new, cur)
        step = jnp.where(claim, 1, step)
        eff_l = jnp.where(claim, walk_length + 1, eff_l)
        buf_l = jnp.where(
            (claim[:, None]) & (cols_row[None, :] == 0),
            cur[:, None], buf_l,
        )
        active = active | claim
        done = jnp.zeros_like(done)  # flushed; unclaimed lanes retire
        if use_atom:
            theta = jnp.where(claim, 0.0, theta)
            wp = jnp.where(claim, 0.0, wp)
        # refresh rows for claimed lanes (full-batch gather, one per
        # block — amortized over ``unroll`` rounds)
        cur_rows = jnp.where(
            claim[:, None], graph.gather_rows(cur), cur_rows
        )
        return (wid, cur, prev, cur_rows, prev_rows, step, active, done,
                theta, wp, buf_l, eff_l, big, eff_big, next_w,
                jnp.sum(active.astype(jnp.int32)), t)

    def cond(state):
        pending, t = state[-2], state[-1]
        return (pending > 0) & (t < round_cap)

    unroll = max(int(unroll), 1)
    flush_every = max(int(flush_every), 1)

    def body(state):
        for _ in range(unroll * flush_every):
            state = round_body(state)
        return flush_claim(state)

    state = (wid0, cur0, cur0, cur_rows0, cur_rows0, step0, active0,
             done0, zero_b, zero_b, buf_l, eff_l, big, eff_big,
             jnp.int32(b), jnp.int32(b), jnp.int32(0))
    state = jax.lax.while_loop(cond, body, state)
    (wid, cur, _, _, _, step, active, done, _, _, buf_l, eff_l, big,
     eff_big, _, _, t_end) = state
    # lanes cut off by the safety cap flush their partial rows; their
    # eff records the columns actually written
    residual = active | done
    eff_l = jnp.where(active, jnp.minimum(eff_l, step), eff_l)
    tgt = jnp.where(residual, wid, w_total)
    big = big.at[tgt].set(buf_l, mode="drop")
    eff_big = eff_big.at[tgt].set(eff_l, mode="drop")
    # resting emission: columns at/past the effective length repeat the
    # walk's final node (same contract as the other engines)
    last = jnp.take_along_axis(big, (eff_big[:, None] - 1), axis=1)
    walks = jnp.where(cols_row[None, :] < eff_big[:, None], big, last)
    if return_rounds:
        return walks, eff_big, t_end
    return walks, eff_big


def generate_walks_amortized(
    graph: DeviceCSR,
    start: jax.Array,
    key: jax.Array,
    walk_length: int,
    p: float,
    q: float,
    extend: bool,
    trials: int = 2,
    round_cap_factor: int = 40,
    return_rounds: bool = False,
    undirected: Optional[bool] = None,
    unroll: int = 4,
):
    """Hub-graph OTF walker amortizing rejection retries ACROSS steps.

    The per-step rejection sampler (``ops/rejection.second_order_sample``)
    must drain the slowest lane before any walker advances: the max of B
    geometric retry counts forces compaction phases plus a ``while_loop``
    of small sweeps inside EVERY step — a ~10-dispatch serial chain of
    tiny ops per step that dominates the step time. This engine
    removes the per-step barrier instead of fighting it: each round every
    walker runs ONE flat full-batch trial (propose -> bias -> accept) and
    a lane that fails simply stays put and retries next round with fresh
    randomness while its neighbors advance. A walker needs
    sum_j Geom_j(accept) rounds for L steps — a SUM of geometrics, whose
    max over ~1e5 lanes concentrates at ~L/a + O(sqrt(L)) — so the whole
    walk costs ~L/a wide, shallow rounds with no compaction anywhere.

    Every lane advances by rejection here, hub or not: a non-hub proposal
    is an elementwise draw on the carried fused row and its membership test a
    carried-row compare, so the only price over the fused kernel is the
    ~1/a round inflation — far cheaper than the [B, D, D] all-pairs
    membership the fused kernel pays per step (a rejection trial tests
    ONE candidate: [B, D]).

    Walk semantics (start column, early termination, effective lengths,
    resting emission) match ``generate_walks``; the sampled law is the
    same exact second-order distribution — including the return-edge atom
    construction that removes 1/p from the rejection bound
    (``ops/rejection.py`` module docstring; distributional tests in
    ``tests/test_hubs.py``).

    Args:
        trials: proposals per lane per round. On the 1M-node Chung-Lu
            bench (p=0.5, q=2, per-round accept ~0.45) T=2 lifts
            per-round acceptance to ~0.7; the default 2 is not yet
            re-measured on the GPU.
        round_cap_factor: safety bound — at most ``L * factor + 64``
            rounds; lanes still short of L columns then emit their
            resting node (reachable only at pathological p/q).
        return_rounds: also return the round count taken (diagnostics).
        unroll: rounds per ``while_loop`` iteration. The pending-count
            reduction and loop bookkeeping are paid once per iteration;
            running several rounds per iteration amortizes them at the
            price of at most ``unroll - 1`` extra no-op rounds in
            the drain tail (a no-advance round leaves every lane's
            state bit-identical). Each unrolled round keeps its own
            ``fold_in`` key, so the sampled law is unchanged.
        undirected: None (default) takes ``graph.symmetric`` — the
            build-time symmetry detection. Promise that edge weights are
            symmetric
            (w(u, v) == w(v, u) and edges exist in both directions, the
            ``.edg`` undirected contract). The return-edge atom for the
            post-advance state needs w(new_cur -> new_prev); with the
            promise that equals the accepted proposal's own w(cur, x),
            which is already in hand — saving a full-batch membership
            probe (one hash-bucket gather + one [B, dpad] carried-row
            compare) EVERY round.
    """
    if undirected is None:
        undirected = graph.symmetric
    if os.environ.get("PECANPY_TPU_RBG", "0") == "1":
        # derive an rbg-implementation key (XLA's RngBitGenerator,
        # unmeasured against threefry on the GPU) from the incoming key;
        # the whole round loop below inherits it through split/fold_in
        data = jax.random.key_data(key).astype(jnp.uint32)
        key = jax.random.key(data[0] ^ (data[1] << 7), impl="rbg")
    b = start.shape[0]
    sentinel = graph.num_nodes
    alpha_np = max(1.0, 1.0 / q)  # bound over non-return candidates
    excess = 1.0 / p - alpha_np
    use_atom = excess > 0.0
    use_cdf = "cdf" in graph.channels  # precomputed 1st-order CDF rows

    key_first, key_rounds = jax.random.split(key)
    start_rows = graph.gather_rows(start)
    alive0 = graph.rows_nbr(start_rows)[:, 0] != sentinel
    first, w_first = rejection.propose(
        graph, key_first, start_rows, use_cdf=use_cdf
    )
    col1 = jnp.where(alive0, first, start)
    eff0 = jnp.where(alive0, walk_length + 1, 1).astype(jnp.int32)
    if walk_length == 1:
        walks1 = jnp.stack([start, col1], axis=1)
        if return_rounds:
            return walks1, eff0, jnp.int32(0)
        return walks1, eff0

    col1_rows = graph.gather_rows(col1)
    has1 = graph.rows_nbr(col1_rows)[:, 0] != sentinel
    eff = jnp.where(alive0 & ~has1, 2, eff0)
    alive = alive0 & has1

    buf = jnp.zeros((b, walk_length + 1), dtype=jnp.int32)
    buf = buf.at[:, 0].set(start).at[:, 1].set(col1)

    def _theta_from(wp, cur_rows):
        """Return-edge atom mass from w(cur -> prev) + cur's weight sum."""
        wsum = jnp.sum(graph.rows_wgt(cur_rows), axis=-1)
        if graph.has_hubs:
            wsum = jnp.where(
                graph.rows_is_hub(cur_rows),
                graph.rows_hub_wsum(cur_rows),
                wsum,
            )
        return (
            wp * excess
            / (wp * excess + alpha_np * jnp.maximum(wsum, rejection._EPS))
        )

    def atom_state(prev, cur_rows):
        """Atom mass for each (cur, prev) pair via a membership probe
        (the directed-safe path; ``undirected`` skips the probe)."""
        _, wp = rejection.membership(graph, prev, cur_rows)
        return _theta_from(wp, cur_rows), wp

    if use_atom:
        if undirected:
            # w(col1 -> start) == the first proposal's own weight
            theta, wp = _theta_from(w_first, col1_rows), w_first
        else:
            theta, wp = atom_state(start, col1_rows)
    else:
        theta = wp = jnp.zeros((b,), dtype=jnp.float32)

    cols_row = jnp.arange(walk_length + 1, dtype=jnp.int32)
    step0 = jnp.full((b,), 2, dtype=jnp.int32)
    round_cap = walk_length * round_cap_factor + 64

    # Edge-partitioned graphs (parallel/distgraph.py) fetch rows through
    # collectives — every shard must take the same number of rounds, so
    # the loop condition is the psum-shared global pending count (the
    # round body itself has a uniform collective schedule).
    sync_axis = getattr(graph, "loop_sync_axis", None)

    # tiered descriptor compaction (local runs only: the sharded
    # layout's collective fetches keep the audited full-batch block)
    tier_s = _tier_lanes(graph, b) if sync_axis is None else 0

    def trial_fn(rkey, prev_, cur_rows_, prev_rows_, theta_, wp_):
        tier = (
            rejection.tier_compact(graph, cur_rows_, prev_rows_, tier_s)
            if tier_s
            else None
        )
        return rejection._trial_block(
            graph, rkey, prev_, cur_rows_, prev_rows_, p, q, extend,
            alpha_np, trials, theta_, wp_, mode="auto",
            use_cdf=use_cdf, tier=tier,
        )

    def pending_count(alive, step):
        n_pend = jnp.sum((alive & (step <= walk_length)).astype(jnp.int32))
        if sync_axis is not None:
            n_pend = jax.lax.psum(n_pend, sync_axis)
        return n_pend

    def cond(state):
        pending, t = state[-2], state[-1]
        return (pending > 0) & (t < round_cap)

    def round_body(state):
        (cur, prev, cur_rows, prev_rows, step, alive, eff, buf,
         theta, wp, pending, t) = state
        rkey = jax.random.fold_in(key_rounds, t)
        needs = alive & (step <= walk_length)
        x, ok, wx = trial_fn(
            rkey, prev, cur_rows, prev_rows,
            theta if use_atom else None, wp if use_atom else None,
        )
        adv = needs & ok
        # masked-where write: one [B, L+1] compare+select in place of a
        # per-lane scatter-set (not yet measured against it on the GPU)
        col = jnp.where(adv, step, walk_length + 2)
        buf = jnp.where(cols_row[None, :] == col[:, None], x[:, None], buf)
        new_cur = jnp.where(adv, x, cur)
        new_prev = jnp.where(adv, cur, prev)
        nxt_rows = graph.gather_rows(new_cur)  # THE one gather per round
        new_prev_rows = jnp.where(adv[:, None], cur_rows, prev_rows)
        step = step + adv.astype(jnp.int32)
        # arrival check: stepping onto a neighborless node ends the walk,
        # recording the effective length (same contract as the scan engine)
        has = graph.rows_nbr(nxt_rows)[:, 0] != sentinel
        died = adv & ~has & (step <= walk_length)
        eff = jnp.where(died, step, eff)
        alive = alive & ~died
        if use_atom:
            if undirected:
                # w(new_cur -> new_prev) == w(cur -> x) == the accepted
                # proposal's weight: no membership probe needed
                theta_n, wp_n = _theta_from(wx, nxt_rows), wx
            else:
                theta_n, wp_n = atom_state(new_prev, nxt_rows)
            theta = jnp.where(adv, theta_n, theta)
            wp = jnp.where(adv, wp_n, wp)
        return (new_cur, new_prev, nxt_rows, new_prev_rows, step, alive,
                eff, buf, theta, wp, pending, t + 1)

    unroll = max(int(unroll), 1)

    def body(state):
        # `unroll` rounds per loop iteration: the pending reduction (and
        # its psum under edge partitioning) runs once per iteration, not
        # once per round; the drain tail costs at most unroll - 1 no-op
        # rounds (state is bit-stable once nothing is pending)
        for _ in range(unroll):
            state = round_body(state)
        return state[:-2] + (pending_count(state[5], state[4]), state[-1])

    state = (col1, start, col1_rows, start_rows, step0, alive, eff, buf,
             theta, wp, pending_count(alive, step0), jnp.int32(0))
    state = jax.lax.while_loop(cond, body, state)
    cur, step, eff, buf = state[0], state[4], state[6], state[7]
    # resting emission: columns past the effective length (or past a
    # safety-cap truncation) repeat the walker's final node
    cols = jnp.arange(walk_length + 1, dtype=jnp.int32)[None, :]
    fill_from = jnp.minimum(eff, step)[:, None]
    walks = jnp.where(cols < fill_from, buf, cur[:, None])
    if return_rounds:
        return walks, eff, state[-1]
    return walks, eff
