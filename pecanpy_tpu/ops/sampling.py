"""Batched discrete samplers: inverse-CDF categorical and alias tables.

The reference samples one node at a time: ``cumsum + searchsorted`` for the
OTF modes (``pecanpy.py:556-557``) and Vose alias tables for the PreComp
modes (``alias_setup``/``alias_draw``, ``pecanpy.py:617-677``). Here both
are batched over thousands of walkers:

* ``categorical_rows`` — inverse-CDF over padded weight rows; one cumsum +
  compare-reduce per batch, no normalization needed.
* ``alias_build`` — Vose construction vectorized across rows with
  ``vmap`` of a fixed-trip-count ``fori_loop`` (the per-row worklist
  algorithm is sequential, but every row runs independently, so the
  device runs R rows in lockstep).
* ``alias_draw`` — O(1) per walker: one randint, two flat gathers, one
  Bernoulli accept.
"""
import jax
import jax.numpy as jnp


def pick_int_columns(values: jax.Array, choice: jax.Array) -> jax.Array:
    """Select values[b, choice[b]] for int32 rows via a one-hot masked sum.

    A compare + masked reduce in place of ``take_along_axis``, which
    lowers to a per-element gather (not yet compared on the GPU).
    Exact for any int32 payload (no float round-trip).
    """
    cols = jnp.arange(values.shape[-1], dtype=jnp.int32)
    onehot = cols[None, :] == choice[:, None]
    return jnp.sum(jnp.where(onehot, values, 0), axis=-1)


def sample_from_cdf(key: jax.Array, cdf: jax.Array) -> jax.Array:
    """Sample one column per row from inclusive CDF rows.

    Args:
        key: PRNG key.
        cdf: [B, D] non-decreasing rows; padded slots must hold the total
            (normalized: 1.0) so they are never selected.

    Returns:
        [B] int32 column choices.
    """
    total = cdf[:, -1:]
    u = jax.random.uniform(key, (cdf.shape[0], 1), dtype=cdf.dtype) * total
    choice = jnp.sum((cdf < u).astype(jnp.int32), axis=-1)
    return jnp.minimum(choice, cdf.shape[1] - 1)


def categorical_rows(key: jax.Array, weights: jax.Array) -> jax.Array:
    """Sample one column index per row proportionally to ``weights``.

    Args:
        key: PRNG key.
        weights: [B, D] non-negative weights; padded slots must be 0.

    Returns:
        [B] int32 column choices. Rows summing to 0 return 0 (callers mask
        dead walkers out separately).

    Equivalent to the reference's ``searchsorted(cumsum(probs), rand())``
    (``pecanpy.py:556-557``) with the normalization folded into the draw:
    ``u ~ U[0, sum(w))`` instead of ``U[0, 1)`` over normalized probs.
    """
    return sample_from_cdf(key, jnp.cumsum(weights, axis=-1))


def _alias_setup_row(weights: jax.Array, k: jax.Array):
    """Vose alias construction for one padded row.

    Args:
        weights: [D] non-negative weights (padded slots 0).
        k: scalar int — true number of entries in the row.

    Returns:
        (alias_j [D] int32, alias_q [D] float32). Padded slots get
        ``q = 1, j = self`` so an (impossible) draw would be a no-op.

    Matches the reference construction (``pecanpy.py:617-665``): scale the
    normalized probs by k, split indices into small (< 1) and large
    worklists, then repeatedly pair one small with one large. The loop here
    has a *fixed* trip count D (each pairing retires exactly one slot, and
    iterations after the worklists drain are masked no-ops) so it maps onto
    a static ``fori_loop`` that vmaps cleanly across rows.
    """
    d = weights.shape[0]
    idx = jnp.arange(d, dtype=jnp.int32)
    valid = idx < k
    total = jnp.sum(weights)
    kf = k.astype(weights.dtype)
    q = jnp.where(valid, weights * kf / jnp.maximum(total, 1e-30), 1.0)
    j = idx  # identity alias by default

    is_small = (q < 1.0) & valid
    is_large = (q >= 1.0) & valid
    # Compact worklists: positions of small/large entries, stacked from 0.
    small_rank = jnp.cumsum(is_small) - 1
    large_rank = jnp.cumsum(is_large) - 1
    small_stack = jnp.full((d,), -1, dtype=jnp.int32)
    large_stack = jnp.full((d,), -1, dtype=jnp.int32)
    small_stack = small_stack.at[jnp.where(is_small, small_rank, d)].set(
        idx, mode="drop"
    )
    large_stack = large_stack.at[jnp.where(is_large, large_rank, d)].set(
        idx, mode="drop"
    )
    n_small = jnp.sum(is_small).astype(jnp.int32)
    n_large = jnp.sum(is_large).astype(jnp.int32)

    def body(_, state):
        j, q, small_stack, large_stack, n_small, n_large = state
        active = (n_small > 0) & (n_large > 0)
        small = small_stack[jnp.maximum(n_small - 1, 0)]
        large = large_stack[jnp.maximum(n_large - 1, 0)]

        new_q_large = q[large] + q[small] - 1.0
        j = jnp.where(active, j.at[small].set(large), j)
        q = jnp.where(active, q.at[large].set(new_q_large), q)

        ns = n_small - 1
        nl = n_large - 1
        # The retired large index re-enters one of the worklists.
        goes_small = new_q_large < 1.0
        small_stack = jnp.where(
            active & goes_small, small_stack.at[ns].set(large), small_stack
        )
        large_stack = jnp.where(
            active & ~goes_small, large_stack.at[nl].set(large), large_stack
        )
        ns = jnp.where(goes_small, ns + 1, ns)
        nl = jnp.where(goes_small, nl, nl + 1)

        n_small = jnp.where(active, ns, n_small)
        n_large = jnp.where(active, nl, n_large)
        return j, q, small_stack, large_stack, n_small, n_large

    state = (j, q, small_stack, large_stack, n_small, n_large)
    j, q, *_ = jax.lax.fori_loop(0, d, body, state)
    return j, q.astype(jnp.float32)


def alias_build(weights: jax.Array, degrees: jax.Array):
    """Build alias tables for a batch of padded weight rows.

    Args:
        weights: [R, D] non-negative weights, 0 at padded slots.
        degrees: [R] int32 true row lengths.

    Returns:
        (alias_j [R, D] int32, alias_q [R, D] float32).
    """
    return jax.vmap(_alias_setup_row)(weights, degrees)


def alias_draw(
    key: jax.Array,
    alias_j: jax.Array,
    alias_q: jax.Array,
    row: jax.Array,
    degree: jax.Array,
) -> jax.Array:
    """Draw one column per walker from per-row alias tables.

    Args:
        key: PRNG key.
        alias_j: [R, D] int32 alias indices.
        alias_q: [R, D] float32 acceptance thresholds.
        row: [B] int32 table row per walker.
        degree: [B] int32 true length of each walker's row.

    Returns:
        [B] int32 column choices in [0, degree).

    Reference draw (``pecanpy.py:668-677``): ``kk = randint(k)``; return kk
    if ``rand() < q[kk]`` else ``j[kk]``. Here the two table reads are flat
    device-memory gathers — O(1) per walker regardless of degree.
    """
    k_int, k_unif = jax.random.split(key)
    b = row.shape[0]
    d = alias_j.shape[1]
    kk = jax.random.randint(k_int, (b,), 0, jnp.maximum(degree, 1))
    flat = row.astype(jnp.int64) * d + kk
    q_val = jnp.take(alias_q.reshape(-1), flat)
    j_val = jnp.take(alias_j.reshape(-1), flat)
    accept = jax.random.uniform(k_unif, (b,)) < q_val
    return jnp.where(accept, kk, j_val).astype(jnp.int32)
