"""On-device skip-gram negative-sampling (SGNS) trainer.

Replaces the reference's external gensim ``Word2Vec`` dependency
(``pecanpy.py:279-288``, ``cli.py:310-319``) with a from-scratch JAX
implementation whose training recipe mirrors gensim's skip-gram path:

* vocabulary = graph node indices (min_count=0 semantics: every node
  appears in the walks because every node starts ``num_walks`` walks);
* frequent-word subsampling with gensim's keep probability
  ``(sqrt(f / s) + 1) * s / f`` applied by *pruning the sentence before
  windowing* (as gensim does — dropped tokens don't count as context);
* per-position reduced windows: effective window ~ U{1..window};
* for a pair (center, context), the *input* vector is the context word's
  row of W_in and the *output* is the center word's row of W_out, matching
  gensim's ``train_sg_pair``; negatives come from the unigram^0.75
  distribution, collisions with the center masked out;
* linear learning-rate decay from ``alpha`` to ``min_alpha`` over the
  total token count across epochs.

The execution model is batched ("walk-structured"): where gensim's C
threads race scalar updates pair by pair, here a chunk of walks trains in
one fused device step that never materializes per-pair rows:

1. embedding rows are gathered once per *walk token* ([Wb, T, dim]) —
   every window pair reuses them, cutting memory traffic ~20x versus
   per-pair gathers;
2. all window interactions happen as banded batched matmuls on the
   walk tensor: scores = v @ u^T per walk ([T, T], masked to the
   window band), gradients flow back as two more [T, T] x [T, dim]
   matmuls — no per-offset accumulator passes;
3. negatives draw independently per walk token from a pre-built,
   shuffled unigram^0.75 table (the original word2vec's InitUnigramTable:
   one randint + one gather instead of a CDF search per draw); a
   token's ``negative`` draws serve all of its window pairs;
4. per-row updates apply through ``ops.apply.apply_mean_updates``, which
   touches only the rows a chunk names and is deterministic (no atomics
   in the reduction). Each row moves by its capped gradient sum over the
   chunk (equal to plain SGD when a row appears once; stable,
   gensim-sequential-like when it repeats).

The window and negative dot products run at ``lax.Precision.HIGHEST``:
on a GPU an f32 matmul may otherwise run in TF32, and the trainer is
checked against CPU references that compute in full f32.
"""
import dataclasses
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pecanpy_tpu.ops.apply import (
    apply_mean_updates,
    apply_mean_updates_two,
)

# Version tag of the single-device trainers' RNG-stream derivation (the
# split(key) structure + the per-global-step fold_in of the span step).
# Stamped into every checkpoint; resume refuses a mismatch — see
# ``utils.checkpoint.verify_rng_scheme``.
RNG_SCHEME = "single-span-foldin-v1"


@dataclasses.dataclass(frozen=True)
class SGNSConfig:
    """Hyperparameters; defaults match the reference CLI / gensim defaults.

    ``batch_walks=None`` resolves to ~32 update applications per epoch
    (clamped to [16, 4096]) — small corpora take many small steps
    (gensim-like dynamics), large corpora get full device batches.
    """

    dim: int = 128
    window: int = 10
    negative: int = 5
    epochs: int = 1
    alpha: float = 0.025
    min_alpha: float = 0.0001
    sample: float = 1e-3
    batch_walks: Optional[int] = None
    # max gradient contributions ("pair-steps") a row absorbs per update
    # application; None resolves to 2 * window — roughly the pairs one
    # token occurrence generates, so typical rows take their full
    # gradient sum and only abnormally hot rows (many occurrences per
    # chunk) are damped. Measured on the BlogCatalog-scale benchmark: a
    # fixed cap of 4 throttled default (window=10) training ~4x
    # (micro-F1 0.19 -> 0.51 after the change).
    update_cap: Optional[float] = None
    # per-step negative pool: the chunk's negative draws come from a pool
    # of this many iid unigram^0.75 samples (deterministic stride
    # assignment), so their table updates pre-aggregate per pool slot
    # with a reshape-sum — the applier's stream shrinks ~15x at default
    # shapes while every pair still sees an exactly unigram-distributed
    # negative. 0 disables (direct per-token draws).
    neg_pool: int = 32768
    # "auto" (default, resolves to float32), "float32", or "bfloat16".
    # bf16 halves table memory, but the applier rounds each update to
    # nearest, which at SGD-sized steps silently drops most updates.
    table_dtype: str = "auto"
    # unused (pre-walk-structured trainer); kept for call compatibility
    batch_pairs: Optional[int] = None
    seed: Optional[int] = None


def resolve_table_dtype(config: SGNSConfig) -> jnp.dtype:
    """Concrete table dtype.

    ``"auto"`` resolves to float32 on every backend. Explicitly
    requesting bfloat16 warns: the applier rounds each updated row to
    nearest, and at lr ~1e-3 the per-step row movement is below the bf16
    ulp of typical weights, so most updates silently vanish.
    """
    name = config.table_dtype
    if name in (None, "auto"):
        name = "float32"
    elif name == "bfloat16":
        import warnings

        warnings.warn(
            "bfloat16 tables round every update to nearest; SGD updates "
            "smaller than the bf16 ulp are dropped (quality degrades). "
            "Use float32.",
            stacklevel=2,
        )
    return jnp.dtype(name)


def _fetch_f32(w_in: jax.Array) -> np.ndarray:
    """Fetch the trained table to host as float32.

    bf16 tables transfer in bf16 (half the device->host bytes) and
    upcast on the host; bf16 -> f32 is exact, so the result is
    bitwise-identical to casting on device first.
    """
    return np.asarray(w_in).astype(np.float32, copy=False)


def _alloc_tables(
    k_init: jax.Array, num_nodes: int, dim: int, table_dtype
) -> tuple:
    """Initial [num_nodes, dim] (w_in, w_out): uniform w_in, zero w_out."""
    bound = 0.5 / dim
    w_in = jax.random.uniform(
        k_init, (num_nodes, dim), minval=-bound, maxval=bound
    ).astype(table_dtype)
    w_out = jnp.zeros((num_nodes, dim), dtype=table_dtype)
    return w_in, w_out


def _gather_1d(vec: jax.Array, idx: jax.Array) -> jax.Array:
    """``vec[idx]`` for 1-D ``vec`` via a row gather + lane select.

    Reshapes the source to [*, 128] lanes, gathers rows, and selects the
    lane with a masked reduce: 128x the bytes of a scalar gather, chosen
    to avoid scalar-gather latency. Its cost against plain ``vec[idx]``
    is not measured on the GPU yet. Exact: a padding lane is never
    selected (idx stays in range), and exactly one lane matches per
    element.
    """
    lanes = 128
    pad = (-vec.shape[0]) % lanes
    v2 = jnp.pad(vec, (0, pad)).reshape(-1, lanes)
    rows = v2[idx // lanes]  # [..., 128] row gather
    lane = jax.lax.broadcasted_iota(jnp.int32, rows.shape, rows.ndim - 1)
    return jnp.sum(
        jnp.where(
            lane == (idx % lanes)[..., None],
            rows,
            jnp.zeros((), vec.dtype),
        ),
        axis=-1,
    )


def _count_tokens(
    walks: jax.Array, eff_len: jax.Array, num_nodes: int
) -> jax.Array:
    """Occurrence count of every node across the valid walk prefix."""
    valid = jnp.arange(walks.shape[1]) < eff_len[:, None]
    return (
        jnp.zeros(num_nodes, dtype=jnp.float32)
        .at[walks.reshape(-1)]
        .add(valid.reshape(-1).astype(jnp.float32))
    )


def _keep_probs(counts: jax.Array, sample: float) -> jax.Array:
    """Gensim subsampling keep-probability per word."""
    if sample <= 0:
        return jnp.ones_like(counts)
    threshold = sample * jnp.sum(counts)
    safe = jnp.maximum(counts, 1.0)
    keep = (jnp.sqrt(safe / threshold) + 1.0) * threshold / safe
    return jnp.clip(keep, 0.0, 1.0)


def resolve_batch_walks(
    config: SGNSConfig, num_nodes: int, walk_cols: int
) -> int:
    """Walks per update application.

    Sized so one application carries ~max(2048, N) window pairs — enough
    to fill the device, few enough that most rows see a handful of
    gradient contributions per application (fresh-gradient dynamics).
    """
    if config.batch_walks is not None:
        return config.batch_walks
    target_pairs = max(2048, num_nodes)
    per_walk = max(walk_cols * min(config.window, walk_cols), 1)
    return int(np.clip(-(-target_pairs // per_walk), 1, 4096))


def build_negative_table(
    counts: np.ndarray, size: int = 1 << 22, seed: int = 0
) -> np.ndarray:
    """Shuffled unigram^0.75 sampling table (word2vec InitUnigramTable).

    Proportional fill by cumulative mass, then a random permutation so a
    block of consecutive slots reads as iid draws. One randint + one
    gather replaces a CDF binary search per negative sample.
    """
    counts = np.asarray(counts, dtype=np.float64)
    p = counts**0.75
    p = p / max(p.sum(), 1e-30)
    grid = (np.arange(size) + 0.5) / size
    table = np.searchsorted(np.cumsum(p), grid).astype(np.int32)
    table = np.minimum(table, counts.size - 1)
    np.random.default_rng(seed).shuffle(table)
    return table


def _stripe_bases(k_neg: int, bt: int, m_pool: int) -> list:
    """Static per-stripe base offsets into the negative pool.

    Stripe k of token n reads pool slot ``(bases[k] + n) % m_pool``. The
    bases must be pairwise distinct mod m_pool so a token's K negatives
    land on K distinct pool slots (the property the original flat
    ``(s + off) % M`` assignment had). The plain ``k * BT`` base aliases
    whenever ``m_pool | d * BT`` for a stripe distance d < K — e.g.
    BT == m_pool makes all K negatives of every token the SAME slot,
    silently degrading training. Start each base at ``k * BT + k`` and
    bump past collisions (K << M in practice, so this terminates with
    distinct bases; a degenerate K >= M pool keeps the raw bases).
    """
    bases: list = []
    if k_neg >= m_pool:  # distinctness impossible; degenerate tiny pool
        return [(k * bt + k) % m_pool for k in range(k_neg)]
    used: set = set()
    for k in range(k_neg):
        b = (k * bt + k) % m_pool
        while b in used:
            b = (b + 1) % m_pool
        bases.append(b)
        used.add(b)
    return bases


def _pair_counts_banded(
    comp: jax.Array,
    negs: jax.Array,
    cnt_v: jax.Array,
    eff_win: jax.Array,
    m: jax.Array,
    window: int,
) -> jax.Array:
    """Per-(context j, negative k) trained-pair count minus collisions.

    Equals ``cnt_v[:, :, None] - einsum("bij,bijk->bjk", pm, coll)`` where
    ``coll[b, i, j, k] = comp[b, i] == negs[b, j, k]`` — but evaluated
    over the window BAND (|i - j| <= window, 2W shifted [Wb, T, K]
    compares) instead of materializing the [Wb, T, T, K] tensor.
    """
    wb, t = comp.shape
    ti = jnp.arange(t)
    valid_tok = ti[None, :] < m[:, None]  # [Wb, T]
    pair_cnt = jnp.broadcast_to(
        cnt_v[:, :, None].astype(jnp.float32), negs.shape
    )
    for d in range(-window, window + 1):
        if d == 0:
            continue
        in_rng = (ti + d >= 0) & (ti + d < t)  # [T] center stays in range
        comp_d = jnp.roll(comp, -d, axis=1)  # comp[b, j + d]
        effw_d = jnp.roll(eff_win, -d, axis=1)
        valid_d = jnp.roll(valid_tok, -d, axis=1)
        band = (
            (abs(d) <= effw_d) & valid_d & valid_tok & in_rng[None, :]
        )  # pm[b, j + d, j]
        coll_d = comp_d[:, :, None] == negs  # [Wb, T, K]
        pair_cnt = pair_cnt - jnp.where(
            band[:, :, None] & coll_d, 1.0, 0.0
        )
    return pair_cnt


def make_step_body(
    num_nodes: int,
    config: SGNSConfig,
    model_axis: Optional[str] = None,
    data_axis: Optional[str] = None,
):
    """Build the pure (unjitted) per-chunk training step.

    Single-device by default. Inside ``shard_map`` the same math runs
    SPMD with two optional collective hooks (``pecanpy_tpu.parallel``):

    * ``model_axis``: the embedding tables are sharded along ``dim``.
      Row gathers stay local; the two pair-score einsums produce partial
      dot products that ``psum`` over the model axis.
    * ``data_axis``: the walk batch is sharded. The per-shard update
      streams ``all_gather`` along the data axis before application, so
      every data shard applies the identical full stream to its
      (data-replicated) table slice — bitwise-identical tables across
      shards.

    In sharded mode pass a *data-shard-local* key (fold the axis index
    in) so walks, subsampling, and negatives differ per shard.
    """
    window = config.window
    k_neg = config.negative
    cap = (
        config.update_cap
        if config.update_cap is not None
        else 2.0 * config.window
    )
    hi = jax.lax.Precision.HIGHEST  # no TF32: see the module docstring

    def step(w_in, w_out, walks, eff_len, keep_prob, neg_table, lr, key):
        wb, t = walks.shape
        dim = w_in.shape[1]
        # the 4th key is unused; splitting 4 ways keeps the other streams
        key_sub, key_win, key_neg, _ = jax.random.split(key, 4)

        # 1. Subsample: prune dropped tokens, compact each walk left
        #    (sort-based — XLA scatter-free).
        u = jax.random.uniform(key_sub, (wb, t))
        in_walk = jnp.arange(t) < eff_len[:, None]
        keep = in_walk & (u < _gather_1d(keep_prob, walks))
        pos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (wb, t))
        sort_key = jnp.where(keep, pos, pos + t)  # kept first, order stable
        _, comp = jax.lax.sort((sort_key, walks), dimension=1, num_keys=1)
        m = jnp.sum(keep, axis=1)  # [Wb] compacted lengths

        # 2. Reduced windows per center position: effective ~ U{1..window}.
        eff_win = window - jax.random.randint(key_win, (wb, t), 0, window)

        # 3. One row gather per walk token (both tables); bf16 tables
        #    upcast once here, all arithmetic stays f32.
        v = w_in[comp].astype(jnp.float32)  # [Wb, T, dim]
        uo = w_out[comp].astype(jnp.float32)

        # 4. Per-token negatives from the shuffled unigram^0.75 table —
        #    via a per-step pool when the chunk is large enough: pool[s]
        #    are iid unigram draws, and the negative of (token n, slot k)
        #    is pool slot (k * BT + n) % M — a K-MAJOR stripe assignment.
        #    Marginally each negative is exactly unigram^0.75; the payoff
        #    is twofold: the negative EMBEDDING rows are gathered once
        #    for the M pool slots (not once per draw), and for a fixed k
        #    the token axis maps onto a contiguous modular range of
        #    slots, so everything negative-side evaluates as K streamed
        #    [BT, dim] stripes — no [Wb, T, K, dim] tensor ever exists —
        #    and the per-slot update aggregation is a reshape-sum plus a
        #    roll (no sort, no scatter).
        bt = wb * t
        r_neg = bt * k_neg
        m_pool = config.neg_pool
        use_pool = bool(m_pool) and r_neg > m_pool
        v_flat = v.reshape(bt, dim)
        if use_pool:
            k_pool, k_off = jax.random.split(key_neg)
            pool = _gather_1d(
                neg_table,
                jax.random.randint(
                    k_pool, (m_pool,), 0, neg_table.shape[0]
                ),
            )  # [M]
            off = jax.random.randint(k_off, (), 0, m_pool)
            pool_r = jnp.roll(pool, -off)  # stripe k, token n: slot
            # (bases[k] + n) % M of pool_r
            pool_rows = w_out[pool_r].astype(jnp.float32)  # [M, dim]
            reps = -(-bt // m_pool)
            pad_bt = reps * m_pool - bt
            bases = _stripe_bases(k_neg, bt, m_pool)
            # Padded [reps, M, dim] VIEW of the token rows, built once:
            # every stripe op below runs against it with the pool rows
            # broadcast over the (tiny) reps axis — nothing ever
            # materializes a [BT, dim]-tiled copy of the pool.
            v_pad = jnp.pad(v_flat, ((0, pad_bt), (0, 0))).reshape(
                reps, m_pool, dim
            )
            rolled = [
                jnp.roll(pool_rows, -bases[k], axis=0)
                for k in range(k_neg)
            ]  # K x [M, dim]

            def stripe(arr_m, k):
                """[BT] view of stripe k of an [M]-indexed 1-D table."""
                r1 = jnp.roll(arr_m, -bases[k], axis=0)
                tiled = jnp.broadcast_to(r1[None], (reps,) + r1.shape)
                return tiled.reshape(reps * m_pool)[:bt]

            neg_logits = jnp.stack(
                [
                    jnp.sum(v_pad * rolled[k][None], axis=-1)
                    .reshape(-1)[:bt]
                    for k in range(k_neg)
                ]
            )  # [K, BT]
            negs = jnp.stack(
                [stripe(pool_r, k) for k in range(k_neg)]
            ).T.reshape(wb, t, k_neg)  # ids only (collision counts)
            u_neg = None
        else:
            slots = jax.random.randint(
                key_neg, (wb, t, k_neg), 0, neg_table.shape[0]
            )
            negs = neg_table[slots]  # [Wb, T, K]
            u_neg = w_out[negs].astype(jnp.float32)  # [Wb, T, K, dim]
            neg_logits = jnp.einsum(
                "btd,btkd->btk", v, u_neg, precision=hi
            )
        if model_axis is not None:  # partial dots over the dim shards
            neg_logits = jax.lax.psum(neg_logits, model_axis)
        g_neg = jax.nn.sigmoid(neg_logits)  # sigma(v_ctx . u_neg)

        # 5. Window interactions as banded batched matmuls. With T <= ~100
        #    the full [T, T] score matrix is small and avoids 2W
        #    read-modify-write passes over [Wb, T, dim] accumulators.
        #    pm[b, i, j] = pair (center i, context j) is trained.
        ti = jnp.arange(t)
        dist = jnp.abs(ti[:, None] - ti[None, :])  # [T, T]
        valid_tok = ti[None, :] < m[:, None]  # [Wb, T]
        pm = (
            (dist[None] >= 1)
            & (dist[None] <= eff_win[:, :, None])  # window of the center i
            & valid_tok[:, :, None]
            & valid_tok[:, None, :]
        ).astype(jnp.float32)  # [Wb, T, T]

        scores = jnp.einsum(
            "bjd,bid->bij", v, uo, preferred_element_type=jnp.float32,
            precision=hi,
        )  # s[i, j] = v_ctx(j) . u_cen(i)
        if model_axis is not None:
            scores = jax.lax.psum(scores, model_axis)
        g_pos = (jax.nn.sigmoid(scores) - 1.0) * pm  # [Wb, T, T]

        du = jnp.einsum("bij,bjd->bid", g_pos, v, precision=hi)
        dv = jnp.einsum("bij,bid->bjd", g_pos, uo, precision=hi)
        cnt_u = jnp.sum(pm, axis=2)  # pairs as center
        cnt_v = jnp.sum(pm, axis=1)  # pairs as context

        # negative coefficients per (context token, neg slot): every pair
        # (i, j) contributes g_neg[j, k] unless neg k collides with the
        # pair's center token i. Collision counts evaluate over the
        # window BAND (2W shifted [Wb, T, K] compares) — the all-pairs
        # [Wb, I, J, K] tensor never materializes.
        pair_cnt = _pair_counts_banded(
            comp, negs, cnt_v, eff_win, m, window
        )  # pairs per (j, k) surviving the collision mask
        c_v = pair_cnt

        # negative-side gradients: the context rows get the accumulated
        # pull away from their negatives; each negative row collects the
        # symmetric push from its context token
        if use_pool:
            # stripe-streamed: K fused passes over the padded [reps, M,
            # dim] view; the rolled pool rows broadcast over reps
            # inside the fusion (no [BT, dim] stripe materialization)
            a_km = g_neg * pair_cnt.reshape(bt, k_neg).T  # [K, BT]
            a_pad = jnp.pad(a_km, ((0, 0), (0, pad_bt))).reshape(
                k_neg, reps, m_pool
            )
            dv_neg_pad = jnp.zeros((reps, m_pool, dim), dtype=jnp.float32)
            for k in range(k_neg):
                dv_neg_pad = dv_neg_pad + (
                    a_pad[k][:, :, None] * rolled[k][None]
                )
            dv_neg = dv_neg_pad.reshape(-1, dim)[:bt]
            dv = dv + dv_neg.reshape(wb, t, dim)
            a_v = None
            du_neg = None
        else:
            a_v = g_neg * pair_cnt
            dv = dv + jnp.einsum("btk,btkd->btd", a_v, u_neg, precision=hi)
            du_neg = a_v[..., None] * v[:, :, None, :]  # [Wb, T, K, dim]

        # 6. Apply: capped gradient sums per row (``ops/apply.py``).
        ids_tok = comp.reshape(-1)
        dv_flat = dv.reshape(-1, dim)
        cnt_v_flat = cnt_v.reshape(-1)
        du_flat = du.reshape(-1, dim)
        cnt_u_flat = cnt_u.reshape(-1)
        if use_pool:
            # pre-aggregate the negative updates per pool slot, one
            # stripe at a time: stripe k's token n feeds slot
            # (n + bases[k]) % M, so a multiply-reduce over the (tiny)
            # reps axis of the padded view groups by n % M and a roll
            # by the stripe base realigns to slot order. Sums and
            # counts per table row reach the applier unchanged — only
            # grouped; the rolled pool itself is the id stream. (No
            # [BT, dim] z tensor, no per-k payload pads.)
            du_neg_flat = jnp.zeros((m_pool, dim), dtype=jnp.float32)
            c_v_flat = jnp.zeros((m_pool,), dtype=jnp.float32)
            c_km = pair_cnt.reshape(bt, k_neg).T  # [K, BT]
            c_pad = jnp.pad(c_km, ((0, 0), (0, pad_bt))).reshape(
                k_neg, reps, m_pool
            )
            for k in range(k_neg):
                shift = bases[k]
                by_mod = jnp.sum(
                    a_pad[k][:, :, None] * v_pad, axis=0
                )  # [M, dim]
                du_neg_flat = du_neg_flat + jnp.roll(by_mod, shift, axis=0)
                c_v_flat = c_v_flat + jnp.roll(
                    jnp.sum(c_pad[k], axis=0), shift
                )
            negs_flat = pool_r
        else:
            negs_flat = negs.reshape(-1)
            du_neg_flat = du_neg.reshape(-1, dim)
            c_v_flat = c_v.reshape(-1)
        if data_axis is not None:
            # every data shard applies the identical full update stream
            # to its table slice (tables are data-replicated)
            ag = lambda x: jax.lax.all_gather(x, data_axis, tiled=True)
            ids_tok, dv_flat, cnt_v_flat = map(
                ag, (ids_tok, dv_flat, cnt_v_flat)
            )
            du_flat, cnt_u_flat = map(ag, (du_flat, cnt_u_flat))
            negs_flat, du_neg_flat, c_v_flat = map(
                ag, (negs_flat, du_neg_flat, c_v_flat)
            )
        # context gradients stream into W_in
        w_in = apply_mean_updates(
            w_in, ids_tok, dv_flat, cnt_v_flat, lr, cap=cap
        )
        # W_out takes the center-gradient (token-keyed) and the
        # negative-gradient streams in ONE merged table pass. They stay
        # separate NORMALIZATION groups (as in per-role sequential SGD):
        # folding the 5x more numerous negative pushes into the center
        # mean would dominate every W_out row and the embedding space
        # collapses to one direction.
        w_out = apply_mean_updates_two(
            w_out,
            ids_tok,
            du_flat,
            cnt_u_flat,
            negs_flat,
            du_neg_flat,
            c_v_flat,
            lr,
            cap_a=cap,
            cap_b=cap,
        )
        return w_in, w_out

    return step


def _make_span_step(num_nodes: int, config: SGNSConfig, chunk: int):
    """One-dispatch-per-SPAN step: a ``fori_loop`` over chunk-steps with
    slice, lr lookup, and key derivation all in-graph.

    Dispatching chunk-steps one by one would put a host round trip
    between every pair of steps. This program takes the *full* walk
    buffer plus a global-step span [g_lo, g_hi) and trains every chunk in
    it in one dispatch. The per-step key is ``fold_in(key0, g)`` — a pure
    function of the global step — so any span split (checkpoint
    boundaries, max_steps, resume) produces the identical parameter
    trajectory.

    ``g - g0`` indexes the chunk and its lr within this walk buffer;
    ``walks_full`` must be pre-padded to a multiple of ``chunk`` rows.
    """
    body = make_step_body(num_nodes, config)

    def run(w_in, w_out, walks_full, eff_full, keep_prob, neg_table,
            lrs, key0, g_lo, g_hi, g0):
        def step(g, carry):
            w_in, w_out = carry
            i = g - g0
            walks = jax.lax.dynamic_slice_in_dim(
                walks_full, i * chunk, chunk, 0
            )
            eff = jax.lax.dynamic_slice_in_dim(eff_full, i * chunk, chunk, 0)
            return body(
                w_in, w_out, walks, eff, keep_prob, neg_table, lrs[i],
                jax.random.fold_in(key0, g),
            )

        return jax.lax.fori_loop(g_lo, g_hi, step, (w_in, w_out))

    return jax.jit(run, donate_argnums=(0, 1))


def _chunk_lrs(config, eff_sums, done_tokens, total_tokens):
    """Per-chunk learning rates from the token-progress schedule."""
    starts = done_tokens + np.concatenate([[0.0], np.cumsum(eff_sums)[:-1]])
    return np.maximum(
        config.min_alpha,
        config.alpha
        - (config.alpha - config.min_alpha)
        * (starts / max(total_tokens, 1.0)),
    ).astype(np.float32)


def _progress(verbose, t0, done_tokens, total_tokens):
    """One flushed progress line per applied span (replaces the
    reference's per-walk ProgressBar, ``pecanpy.py:148,208``)."""
    if not verbose:
        return
    rate = done_tokens / max(time.perf_counter() - t0, 1e-9)
    print(
        f"SGNS: {done_tokens:.3e}/{total_tokens:.3e} tokens "
        f"({100.0 * done_tokens / max(total_tokens, 1.0):.1f}%, "
        f"{rate:.2e} tokens/s)",
        flush=True,
    )


def train(
    walks: jax.Array,
    eff_len: jax.Array,
    num_nodes: int,
    config: SGNSConfig = SGNSConfig(),
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    max_steps: Optional[int] = None,
    verbose: bool = False,
) -> np.ndarray:
    """Train SGNS embeddings from device walks.

    Args:
        walks: [W, T] int32 walk matrix (T = walk_length + 1).
        eff_len: [W] int32 effective walk lengths.
        num_nodes: vocabulary size N.
        config: hyperparameters.
        checkpoint_dir: if set, snapshot training state every
            ``checkpoint_every`` chunk-steps and resume from the latest
            snapshot when one exists (new capability vs. the reference,
            which has no training checkpointing).
        checkpoint_every: snapshot period in chunk-steps.
        max_steps: optional chunk-step budget — stop early after this many
            steps (combine with checkpointing to split a long run across
            invocations; the lr schedule stays pinned to the full plan).

    Returns:
        [N, dim] float32 input-embedding matrix, row i = node i.
    """
    walks = jnp.asarray(walks, dtype=jnp.int32)
    eff_len = jnp.asarray(eff_len, dtype=jnp.int32)
    seed = config.seed if config.seed is not None else 0
    key = jax.random.PRNGKey(seed)
    k_init, k_train = jax.random.split(key)

    counts = _count_tokens(walks, eff_len, num_nodes)
    keep_prob = _keep_probs(counts, config.sample)
    neg_table = jnp.asarray(
        build_negative_table(np.asarray(counts), seed=seed)
    )

    table_dtype = resolve_table_dtype(config)
    w_in, w_out = _alloc_tables(
        k_init, num_nodes, config.dim, table_dtype
    )

    ckpt, resume_step, restored = _open_checkpoint(
        checkpoint_dir, RNG_SCHEME, table_dtype
    )
    if restored is not None:
        w_in, w_out = restored

    num_walks = walks.shape[0]
    chunk = min(
        resolve_batch_walks(config, num_nodes, walks.shape[1]), num_walks
    )
    step = _make_span_step(num_nodes, config, chunk)
    eff_host = np.asarray(eff_len)
    total_tokens = float(eff_host.sum()) * config.epochs
    done_tokens = 0.0

    # pad once so any chunk index slices in-bounds (eff 0: no pairs)
    n_chunks = -(-num_walks // chunk)
    pad = n_chunks * chunk - num_walks
    if pad:
        walks = jnp.pad(walks, ((0, pad), (0, 0)))
        eff_len = jnp.pad(eff_len, (0, pad))
    eff_sums = np.add.reduceat(
        np.pad(eff_host, (0, pad)).astype(np.float64),
        np.arange(n_chunks) * chunk,
    )

    step_idx = 0
    t_start = time.perf_counter()
    for epoch in range(config.epochs):
        lrs = jnp.asarray(
            _chunk_lrs(config, eff_sums, done_tokens, total_tokens)
        )
        g0 = epoch * n_chunks
        g = g0
        while g < g0 + n_chunks:
            if max_steps is not None and step_idx >= max_steps:
                break
            if step_idx < resume_step:  # replay the cursor, skip the work
                done_tokens += float(eff_sums[g - g0])
                step_idx += 1
                g += 1
                continue
            span = _span_len(
                g0 + n_chunks - g, step_idx, resume_step, max_steps,
                checkpoint_every if ckpt is not None else None,
            )
            w_in, w_out = step(
                w_in, w_out, walks, eff_len, keep_prob, neg_table,
                lrs, k_train, g, g + span, g0,
            )
            done_tokens += float(eff_sums[g - g0 : g - g0 + span].sum())
            step_idx += span
            g += span
            _progress(verbose, t_start, done_tokens, total_tokens)
            if ckpt is not None and step_idx % checkpoint_every == 0:
                ckpt.save(
                    step_idx, w_in, w_out,
                    {"next_step": step_idx, "rng_scheme": RNG_SCHEME},
                )

    return _fetch_f32(w_in)


def _open_checkpoint(checkpoint_dir, rng_scheme, table_dtype):
    """(checkpointer or None, resume step, restored (w_in, w_out) or None).

    Restoring refuses a checkpoint written under another RNG scheme
    (``utils.checkpoint.verify_rng_scheme``).
    """
    if checkpoint_dir is None:
        return None, 0, None
    from pecanpy_tpu.utils.checkpoint import (
        SGNSCheckpointer,
        verify_rng_scheme,
    )

    ckpt = SGNSCheckpointer(checkpoint_dir)
    if ckpt.latest_step() is None:
        return ckpt, 0, None
    w_in_np, w_out_np, meta = ckpt.restore()
    verify_rng_scheme(meta, rng_scheme)
    restored = tuple(
        jnp.asarray(w).astype(table_dtype) for w in (w_in_np, w_out_np)
    )
    return ckpt, int(meta["next_step"]), restored


def _span_len(remaining, step_idx, resume_step, max_steps, checkpoint_every):
    """Chunk-steps to run in the next single dispatch.

    Bounded by the end of the walk buffer, the max_steps budget, and the
    next checkpoint boundary (snapshots happen between dispatches).
    """
    span = remaining
    if max_steps is not None:
        span = min(span, max_steps - step_idx)
    if checkpoint_every is not None:
        next_ckpt = (step_idx // checkpoint_every + 1) * checkpoint_every
        span = min(span, next_ckpt - step_idx)
    return max(int(span), 1)


def _prefetch_iter(it, depth: int = 1):
    """Yield items while keeping ``depth`` future items already pulled.

    Pulling an item from the walk-chunk generator DISPATCHES its device
    program (JAX dispatch is async), so a one-deep lookahead keeps the
    walk program for buffer i+1 queued behind buffer i's training span:
    the device never idles between buffers, and the per-buffer host sync
    (the ``eff_len`` fetch) overlaps device execution instead of
    stalling the pipeline. The yielded values are unchanged — only the
    dispatch order shifts — so the deterministic chunk-stream contract
    (and the streaming == materialized bit-equality) is unaffected.
    """
    from collections import deque

    buf = deque()
    for item in it:
        buf.append(item)
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def train_streaming(
    walk_chunks,
    num_nodes: int,
    config: SGNSConfig = SGNSConfig(),
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 100,
    max_steps: Optional[int] = None,
    cache_walks_bytes: Optional[int] = None,
) -> np.ndarray:
    """Two-pass streaming trainer: walks regenerated OR device-cached.

    Pass 1 sweeps the walk stream once to build the vocabulary
    statistics (token counts -> subsampling probabilities and the
    negative table, exactly what gensim's vocab scan does); each epoch
    then trains on the identical stream. Where that stream comes from is
    a memory/compute trade: by default the vocab pass *caches* the walk
    chunks on device as they arrive (the full default 1M-node corpus is
    ~3.2 GB — cheap next to regenerating it, which on hub graphs costs
    as much as a training epoch), and later passes replay the cache; if
    the budget is exceeded mid-pass the cache is dropped and every pass
    regenerates from the (deterministic, same key tree) generator as
    before. Either way the values streamed are identical.

    Args:
        walk_chunks: callable ``(epoch_or_pass: int) -> iterator`` over
            ``(walks [W, T] int32, eff_len [W] int32)`` device chunks.
            Must yield the same stream for every argument value.
        num_nodes: vocabulary size N.
        config: hyperparameters (``epochs`` counts training passes).
        checkpoint_dir / checkpoint_every / max_steps: same contract as
            ``train`` — resume replays the (deterministic) walk-chunk
            cursor, so an interrupted run continues bit-exactly.
        cache_walks_bytes: device-byte budget for the walk cache. None
            resolves to a quarter of the device's memory (override via
            env ``PECANPY_TPU_WALK_CACHE_MB``; see ``utils/budget.py``);
            0 disables caching.

    Returns:
        [N, dim] float32 input-embedding matrix, row i = node i.
    """
    from pecanpy_tpu.utils.budget import WALK_CACHE, budget_bytes

    seed = config.seed if config.seed is not None else 0
    key = jax.random.PRNGKey(seed)
    k_init, k_train = jax.random.split(key)

    if cache_walks_bytes is None:
        cache_walks_bytes = budget_bytes(WALK_CACHE)
    cache: Optional[list] = [] if cache_walks_bytes > 0 else None
    cached_bytes = 0

    def stream(pass_idx):
        nonlocal cache, cached_bytes
        if cache is not None and pass_idx >= 0:
            return iter(cache)

        def first_pass():
            nonlocal cache, cached_bytes
            for chunk_pair in walk_chunks(pass_idx):
                if cache is not None:
                    cached_bytes += sum(a.nbytes for a in chunk_pair)
                    if cached_bytes > cache_walks_bytes:
                        cache = None  # over budget: regenerate instead
                    else:
                        cache.append(chunk_pair)
                yield chunk_pair

        return first_pass()

    @jax.jit
    def count_chunk(counts, walks, eff_len):
        valid = jnp.arange(walks.shape[1]) < eff_len[:, None]
        return counts.at[walks.reshape(-1)].add(
            valid.reshape(-1).astype(jnp.float32)
        )

    counts = jnp.zeros(num_nodes, dtype=jnp.float32)
    for walks, eff_len in stream(-1):
        counts = count_chunk(counts, walks, eff_len)
    keep_prob = _keep_probs(counts, config.sample)
    neg_table = jnp.asarray(
        build_negative_table(np.asarray(counts), seed=seed)
    )
    total_tokens = float(jnp.sum(counts)) * config.epochs

    # With the device walk cache populated, every buffer's eff_len is
    # already materialized: fetch them ALL in one concatenated D2H
    # transfer now instead of one blocking round trip per buffer inside
    # the training loop.
    host_eff = None
    if cache is not None and cache:
        sizes = [int(e.shape[0]) for _, e in cache]
        host_eff = np.split(
            np.asarray(jnp.concatenate([e for _, e in cache])),
            np.cumsum(sizes)[:-1],
        )

    table_dtype = resolve_table_dtype(config)
    w_in, w_out = _alloc_tables(
        k_init, num_nodes, config.dim, table_dtype
    )

    ckpt, resume_step, restored = _open_checkpoint(
        checkpoint_dir, RNG_SCHEME, table_dtype
    )
    if restored is not None:
        w_in, w_out = restored
    step = None

    done_tokens = 0.0
    step_idx = 0
    stop = False
    t_start = time.perf_counter()
    for epoch in range(config.epochs):
        if stop:
            break
        for buf_idx, (walks, eff_len) in enumerate(
            _prefetch_iter(stream(epoch), 1)
        ):
            if stop:
                break
            chunk = resolve_batch_walks(config, num_nodes, walks.shape[1])
            if step is None:
                step = _make_span_step(num_nodes, config, chunk)
            eff_host = (
                host_eff[buf_idx]
                if host_eff is not None and buf_idx < len(host_eff)
                else np.asarray(eff_len)
            )
            n_chunks = -(-walks.shape[0] // chunk)
            pad = n_chunks * chunk - walks.shape[0]
            if pad:
                walks = jnp.pad(walks, ((0, pad), (0, 0)))
                eff_len = jnp.pad(eff_len, (0, pad))
            eff_sums = np.add.reduceat(
                np.pad(eff_host, (0, pad)).astype(np.float64),
                np.arange(n_chunks) * chunk,
            )
            lrs = jnp.asarray(
                _chunk_lrs(config, eff_sums, done_tokens, total_tokens)
            )
            g0 = step_idx
            g = g0
            while g < g0 + n_chunks:
                if max_steps is not None and step_idx >= max_steps:
                    stop = True
                    break
                if step_idx < resume_step:  # replay the cursor only
                    done_tokens += float(eff_sums[g - g0])
                    step_idx += 1
                    g += 1
                    continue
                span = _span_len(
                    g0 + n_chunks - g, step_idx, resume_step, max_steps,
                    checkpoint_every if ckpt is not None else None,
                )
                w_in, w_out = step(
                    w_in, w_out, walks, eff_len, keep_prob, neg_table,
                    lrs, k_train, g, g + span, g0,
                )
                done_tokens += float(eff_sums[g - g0 : g - g0 + span].sum())
                step_idx += span
                g += span
                _progress(verbose, t_start, done_tokens, total_tokens)
                if ckpt is not None and step_idx % checkpoint_every == 0:
                    ckpt.save(
                        step_idx, w_in, w_out,
                        {"next_step": step_idx, "rng_scheme": RNG_SCHEME},
                    )
        if verbose:
            print(
                f"epoch {epoch + 1}/{config.epochs}: "
                f"{done_tokens:.3e} tokens trained"
            )
    return _fetch_f32(w_in)


def train_sequential(
    walks,
    eff_len,
    num_nodes: int,
    config: SGNSConfig = SGNSConfig(),
    workers: int = 1,
    verbose: bool = False,
) -> np.ndarray:
    """Host-side sequential SGNS (gensim loop semantics) on device walks.

    The quality-reference trainer: per-pair immediate updates, per-token
    linear lr decay, reduced windows, subsampling, unigram^0.75
    negatives with collision skip — gensim's exact sequential loop
    (reference usage: ``pecanpy.py:279-288``), run by the native C++
    trainer (``native/seqsgns.cpp``). ``workers>1`` races hogwild
    threads exactly like gensim's worker threads (nondeterministic).

    It is the quality reference for the batched device trainer; the
    trade is wall clock: the sequential loop runs on host CPU threads,
    so it suits small graphs (<~50M tokens) where gensim-parity quality
    matters more than device throughput.

    Args:
        walks: [W, T] int32 walk matrix (device or host).
        eff_len: [W] int32 effective walk lengths.
        num_nodes: vocabulary size N.
        config: hyperparameters (same object the device trainer takes;
            ``table_dtype``/``neg_pool``/``update_cap`` are
            device-trainer knobs and are ignored here).
        workers: hogwild threads; 0 resolves to all host CPUs.

    Returns:
        [N, dim] float32 input-embedding matrix, row i = node i.
    """
    import os

    from pecanpy_tpu.native.loader import (
        native_available,
        train_sgns_sequential_native,
    )

    if not native_available():
        raise RuntimeError(
            "trainer='sequential' needs the native toolchain (g++) to "
            "build pecanpy_tpu/native/seqsgns.cpp; use the default "
            "device trainer instead"
        )
    walks = np.ascontiguousarray(walks, dtype=np.int32)
    eff_len = np.ascontiguousarray(eff_len, dtype=np.int32)
    if workers is None or workers <= 0:
        workers = os.cpu_count() or 1
    seed = config.seed if config.seed is not None else 0

    valid = np.arange(walks.shape[1])[None, :] < eff_len[:, None]
    counts = np.bincount(
        walks[valid], minlength=num_nodes
    ).astype(np.float32)
    keep_prob = np.asarray(_keep_probs(counts, config.sample))
    neg_table = build_negative_table(counts, seed=seed)

    rng_init = np.random.default_rng(seed)
    w_in = rng_init.uniform(
        -0.5 / config.dim, 0.5 / config.dim, (num_nodes, config.dim)
    ).astype(np.float32)
    w_out = np.zeros((num_nodes, config.dim), dtype=np.float32)

    total_tokens = float(eff_len.sum()) * config.epochs
    t0 = time.perf_counter()
    pairs = train_sgns_sequential_native(
        walks, eff_len, w_in, w_out, keep_prob, neg_table,
        config.window, config.negative, config.alpha, config.min_alpha,
        total_tokens, config.epochs, seed, workers=workers,
    )
    if verbose:
        dt = max(time.perf_counter() - t0, 1e-9)
        print(
            f"sequential SGNS: {pairs} pairs on {workers} thread(s) "
            f"({pairs / dt:.2e} pairs/s)",
            flush=True,
        )
    return w_in
