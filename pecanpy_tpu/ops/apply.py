"""Sparse-row update application for the SGNS tables.

The SGNS update is "W[i] -= lr * capped sum of the gradient rows with id
i" for ~1e5 (id, grad) pairs per step against an [N, dim] table. The
applier touches only the rows the stream names, never the whole table:

1. sort the stream by destination row (one variadic sort carries the
   counts and the permutation along with the keys);
2. PRE-SCALE the payload on the stream: each destination row's total
   contribution count is an entry-wise function of the sorted stream
   (``_sorted_scales``: scan arithmetic, no [N]-sized array), so
   ``lr * min(total, cap) / total`` folds into the update rows and
   application becomes linear — ``table -= sum of scaled rows``. Two
   streams with *independent normalization groups* (the SGNS
   center-gradient and negative-gradient streams into W_out) therefore
   merge into one pass under the composite sort key ``id * 2 + stream``;
3. reduce each destination row's run of the sorted stream with a
   segmented scan, then write every touched row exactly once.

Step 3 is what keeps training deterministic. A scatter-add with repeated
ids runs as atomics on a GPU, in an order that changes from run to run,
so the same seed would give tables that differ in the last bits. Here
the per-row sums are taken in the scan's fixed tree order and the final
scatter has one writer per row: the same inputs give bit-identical
tables on every run and every backend.
"""
import functools

import jax
import jax.numpy as jnp

DEFAULT_UPDATE_CAP = 4.0  # max "pair-steps" a row absorbs per application
_EPS = 1e-9


def _sorted_scales(keys_s, cnt_s, lr, cap):
    """Entry-wise ``lr * min(total, cap) / total`` over a sorted stream.

    ``total`` is the summed count of the entry's key group. Over a SORTED
    stream the group totals fall out of pure scan arithmetic — no
    searchsorted and no [N]-sized array:

    * ``cum`` (inclusive cumsum of counts) is nondecreasing, so the
      nearest group END at-or-right of i is ``cummin(reverse)`` of cum
      masked to end positions, and the nearest group START at-or-left is
      ``cummax`` of the exclusive cumsum masked to start positions.

    Rows with few contributions take the plain gradient SUM — the batch
    equivalent of gensim applying each pair sequentially; hot rows are
    capped at ``cap`` pair-steps per application so a row repeated
    thousands of times in one chunk cannot blow past the sigmoid's
    saturation region the sequential algorithm would have entered.
    Exact for the integer-valued counts SGNS produces.
    """
    cnt_f = cnt_s.astype(jnp.float32)
    cum = jnp.cumsum(cnt_f)  # inclusive
    change = keys_s[1:] != keys_s[:-1]
    true1 = jnp.ones(1, dtype=bool)
    start = jnp.concatenate([true1, change])
    end = jnp.concatenate([change, true1])
    inf = jnp.float32(jnp.inf)
    seg_lo = jax.lax.cummax(jnp.where(start, cum - cnt_f, -inf))
    seg_hi = jax.lax.cummin(jnp.where(end, cum, inf), reverse=True)
    tot = seg_hi - seg_lo
    return lr * jnp.minimum(tot, cap) / jnp.maximum(tot, _EPS)


def _segment_sums(ids_s, upd_s):
    """Inclusive running sums of ``upd_s`` within each run of equal ids.

    A segmented ``associative_scan``: its combine order is fixed by the
    array length alone, so the sums are bit-reproducible (unlike atomics).
    At a run's last entry the value is the run's total.
    """
    start = jnp.concatenate(
        [jnp.ones(1, dtype=bool), ids_s[1:] != ids_s[:-1]]
    )

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb[..., None], vb, va + vb)

    _, sums = jax.lax.associative_scan(combine, (start, upd_s))
    return sums


def _apply_sorted(table, keys, upd, cnt, lr, cap_even, cap_odd):
    """Apply a keyed stream (``key = id * 2 + stream``) in one pass."""
    if keys.shape[0] == 0:  # empty stream: nothing to apply
        return table
    n = table.shape[0]
    keys_s, cnt_s, order = jax.lax.sort(
        (keys, cnt.astype(jnp.float32),
         jax.lax.iota(jnp.int32, keys.shape[0])),
        num_keys=1,
    )
    cap_s = jnp.where((keys_s & 1) == 1, cap_odd, cap_even)
    scale = _sorted_scales(keys_s, cnt_s, lr, cap_s)
    upd_s = upd[order].astype(jnp.float32) * scale[:, None]
    ids_s = keys_s >> 1
    sums = _segment_sums(ids_s, upd_s)
    last = jnp.concatenate(
        [ids_s[1:] != ids_s[:-1], jnp.ones(1, dtype=bool)]
    )
    new = (table[ids_s].astype(jnp.float32) - sums).astype(table.dtype)
    # one writer per row: every entry but a run's last targets row n,
    # which mode="drop" discards
    return table.at[jnp.where(last, ids_s, n)].set(new, mode="drop")


@functools.partial(
    jax.jit, static_argnames=("cap_a", "cap_b"), donate_argnums=(0,)
)
def apply_mean_updates_two(
    table: jax.Array,
    ids_a: jax.Array,
    upd_a: jax.Array,
    cnt_a: jax.Array,
    ids_b: jax.Array,
    upd_b: jax.Array,
    cnt_b: jax.Array,
    lr: jax.Array,
    cap_a: float = DEFAULT_UPDATE_CAP,
    cap_b: float = DEFAULT_UPDATE_CAP,
) -> jax.Array:
    """Apply two independent capped-sum update streams in ONE table pass.

    Semantics: ``apply_mean_updates(apply_mean_updates(table, a...),
    b...)`` up to float summation order, because application is linear
    in the pre-scaled rows. The streams keep separate normalization
    groups (counts and caps), which is the point: merging them into one
    group would let the more numerous stream drown the other (see the
    w_out note in ``models/sgns.py``). Group separation rides the
    composite sort key ``id * 2 + stream`` (ids must stay < 2^30).
    """
    keys = jnp.concatenate([ids_a * 2, ids_b * 2 + 1])
    upd = jnp.concatenate(
        [upd_a.astype(jnp.float32), upd_b.astype(jnp.float32)]
    )
    cnt = jnp.concatenate(
        [cnt_a.astype(jnp.float32), cnt_b.astype(jnp.float32)]
    )
    return _apply_sorted(table, keys, upd, cnt, lr, cap_a, cap_b)


@functools.partial(jax.jit, static_argnames=("cap",), donate_argnums=(0,))
def apply_mean_updates(
    table: jax.Array,
    ids: jax.Array,
    upd: jax.Array,
    cnt: jax.Array,
    lr: jax.Array,
    cap: float = DEFAULT_UPDATE_CAP,
) -> jax.Array:
    """table[i] -= lr * capped-sum of the upd rows with id i.

    The rule: the gradient sum of row i's entries times
    ``min(total, cap) / total``, where ``total`` sums their counts
    (see ``_sorted_scales``). Rows not present in ``ids`` are unchanged;
    entries with cnt 0 and zero upd rows are no-ops (padding-friendly).
    ``ids`` must be < table rows.
    """
    return _apply_sorted(table, ids * 2, upd, cnt, lr, cap, cap)
