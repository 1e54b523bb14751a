"""SGNS gradient parity with gensim's train_sg_pair math.

BASELINE.md's north star asks for "per-layer embedding gradients
allclose on fixed RNG" against gensim. The trainers differ structurally
— gensim applies pairs *sequentially* (hogwild), this framework applies
one *simultaneous* capped-sum step per chunk — so trajectory-level
equality is out of scope by design (documented in BENCH.md). What IS
checkable, and checked here, is the per-pair gradient formula: with a
deterministic configuration (window=1 so reduced windows collapse,
subsampling off, a constant negative table, update cap -> inf so the
capped mean degenerates to the plain gradient sum) one training step
must equal the hand-written gensim skip-gram update
(gensim word2vec train_sg_pair semantics: input vector = the CONTEXT
word's W_in row, output = the CENTER word's W_out row; negatives drawn
per context token; a negative colliding with the pair's center is
skipped).
"""
import jax
import jax.numpy as jnp
import numpy as np

from pecanpy_tpu.models import sgns


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def gensim_simultaneous_step(w_in, w_out, walk, negs_of_token, lr, window=1):
    """Hand-written gensim SGNS step, all pairs from the INITIAL tables.

    For every pair (center i, context j) within ``window``:
      l1 = w_in[walk[j]]                      (context row, the "input")
      pos: g = sigma(l1 . w_out[walk[i]]) - 1
           d_wout[walk[i]] += g * l1;  neu1e  = g * w_out[walk[i]]
      for each negative n of token j (skip n == walk[i]):
           g = sigma(l1 . w_out[n])
           d_wout[n] += g * l1;       neu1e += g * w_out[n]
      d_win[walk[j]] += neu1e
    then W -= lr * d_W (simultaneous application).
    """
    d_in = np.zeros_like(w_in)
    d_out = np.zeros_like(w_out)
    t = len(walk)
    for i in range(t):  # center position
        for j in range(t):  # context position
            if j == i or abs(i - j) > window:
                continue
            ctx, cen = walk[j], walk[i]
            l1 = w_in[ctx]
            g = _sigmoid(l1 @ w_out[cen]) - 1.0
            d_out[cen] += g * l1
            neu1e = g * w_out[cen]
            for n in negs_of_token[j]:
                if n == cen:
                    continue
                g = _sigmoid(l1 @ w_out[n])
                d_out[n] += g * l1
                neu1e += g * w_out[n]
            d_in[ctx] += neu1e
    return w_in - lr * d_in, w_out - lr * d_out


def test_single_step_matches_gensim_formula():
    n, dim, lr = 5, 16, 0.05
    rng = np.random.default_rng(3)
    w_in = rng.standard_normal((n, dim)).astype(np.float32) * 0.1
    w_out = rng.standard_normal((n, dim)).astype(np.float32) * 0.1

    walk = [0, 1, 2, 3]
    neg_node = 4  # constant negative table -> known negative draws
    config = sgns.SGNSConfig(
        dim=dim, window=1, negative=1, sample=0.0,
        update_cap=float("inf"), seed=0,
    )
    step = sgns.make_step_body(n, config)
    walks = jnp.asarray([walk], dtype=jnp.int32)
    eff = jnp.asarray([len(walk)], dtype=jnp.int32)
    keep = jnp.ones(n, dtype=jnp.float32)
    neg_table = jnp.full((64,), neg_node, dtype=jnp.int32)
    out_in, out_out = jax.jit(step)(
        jnp.asarray(w_in), jnp.asarray(w_out), walks, eff, keep,
        neg_table, jnp.float32(lr), jax.random.PRNGKey(0),
    )

    negs_of_token = {j: [neg_node] for j in range(len(walk))}
    exp_in, exp_out = gensim_simultaneous_step(
        w_in.astype(np.float64), w_out.astype(np.float64), walk,
        negs_of_token, lr, window=1,
    )
    np.testing.assert_allclose(np.asarray(out_in), exp_in, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_out), exp_out, atol=1e-5)


def test_negative_collision_skipped():
    """A negative equal to the pair's center contributes nothing
    (gensim: ``if target == word: continue``)."""
    n, dim, lr = 4, 8, 0.1
    rng = np.random.default_rng(5)
    w_in = rng.standard_normal((n, dim)).astype(np.float32) * 0.1
    w_out = rng.standard_normal((n, dim)).astype(np.float32) * 0.1

    walk = [0, 1]
    config = sgns.SGNSConfig(
        dim=dim, window=1, negative=1, sample=0.0,
        update_cap=float("inf"), seed=0,
    )
    step = sgns.make_step_body(n, config)
    # every negative draw == node 0 == the center of pair (0 -> ctx 1):
    # that pair's negative must be skipped; pair (1 -> ctx 0) keeps it
    neg_table = jnp.zeros((64,), dtype=jnp.int32)
    out_in, out_out = jax.jit(step)(
        jnp.asarray(w_in), jnp.asarray(w_out),
        jnp.asarray([walk], jnp.int32), jnp.asarray([2], jnp.int32),
        jnp.ones(n), neg_table, jnp.float32(lr), jax.random.PRNGKey(1),
    )
    negs_of_token = {0: [0], 1: [0]}
    exp_in, exp_out = gensim_simultaneous_step(
        w_in.astype(np.float64), w_out.astype(np.float64), walk,
        negs_of_token, lr, window=1,
    )
    np.testing.assert_allclose(np.asarray(out_in), exp_in, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out_out), exp_out, atol=1e-5)
