"""SGNS trainer tests: shapes, determinism, and embedding quality."""
import numpy as np
import pytest

from pecanpy_tpu import pecanpy
from pecanpy_tpu.models import sgns


def two_clique_graph(k=8, bridge=True):
    """Two k-cliques joined by one bridge edge — a clean community signal."""
    n = 2 * k
    adj = np.zeros((n, n))
    adj[:k, :k] = 1.0
    adj[k:, k:] = 1.0
    np.fill_diagonal(adj, 0.0)
    if bridge:
        adj[0, k] = adj[k, 0] = 1.0
    return adj


def test_embed_shapes_and_determinism():
    adj = two_clique_graph()
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    e1 = g.embed(dim=16, num_walks=4, walk_length=10, window_size=3)
    g2 = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    e2 = g2.embed(dim=16, num_walks=4, walk_length=10, window_size=3)
    assert e1.shape == (16, 16)
    assert np.isfinite(e1).all()
    np.testing.assert_allclose(e1, e2)


def test_embeddings_separate_communities():
    adj = two_clique_graph(k=10)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    walks, eff = g.simulate_walks_device(10, 20)
    # subsampling off: on a 20-node vocabulary every node is "frequent"
    # and gensim's formula would discard most of the tiny corpus
    config = sgns.SGNSConfig(
        dim=32, window=5, epochs=10, sample=0.0, seed=0, batch_pairs=1024
    )
    emb = np.asarray(sgns.train(walks, eff, g.num_nodes, config))

    norm = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sim = norm @ norm.T
    k = 10
    within = np.concatenate(
        [sim[:k, :k][np.triu_indices(k, 1)], sim[k:, k:][np.triu_indices(k, 1)]]
    )
    between = sim[:k, k:].ravel()
    assert within.mean() > between.mean() + 0.2, (
        f"within {within.mean():.3f} vs between {between.mean():.3f}"
    )


def test_counts_and_subsampling():
    import jax.numpy as jnp

    walks = jnp.asarray([[0, 1, 2, 1], [1, 1, 3, 0]], dtype=jnp.int32)
    eff = jnp.asarray([3, 2], dtype=jnp.int32)
    counts = np.asarray(sgns._count_tokens(walks, eff, 5))
    np.testing.assert_array_equal(counts, [1, 3, 1, 0, 0])

    keep = np.asarray(sgns._keep_probs(jnp.asarray(counts), sample=1e-3))
    assert keep.shape == (5,)
    assert (keep >= 0).all() and (keep <= 1).all()
    # disabled subsampling keeps everything
    keep_off = np.asarray(sgns._keep_probs(jnp.asarray(counts), sample=0.0))
    np.testing.assert_array_equal(keep_off, np.ones(5))


def test_train_handles_multiple_chunks():
    adj = two_clique_graph(k=4)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    walks, eff = g.simulate_walks_device(6, 8)
    config = sgns.SGNSConfig(dim=8, window=2, epochs=2, batch_walks=16, seed=0)
    emb = np.asarray(sgns.train(walks, eff, g.num_nodes, config))
    assert emb.shape == (8, 8)
    assert np.isfinite(emb).all()


def test_checkpoint_resume(tmp_path):
    """Interrupted training resumes to the identical final state."""
    adj = two_clique_graph(k=4)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    walks, eff = g.simulate_walks_device(6, 8)
    config = sgns.SGNSConfig(dim=8, window=2, epochs=4, batch_walks=16, seed=0)

    # uninterrupted run
    full = np.asarray(sgns.train(walks, eff, g.num_nodes, config))

    # checkpointed run: snapshot every step, "crash" after 2 chunk-steps
    # (same full schedule so the lr plan is identical), then resume
    ckdir = str(tmp_path / "ck")
    sgns.train(walks, eff, g.num_nodes, config,
               checkpoint_dir=ckdir, checkpoint_every=1, max_steps=2)
    resumed = np.asarray(sgns.train(walks, eff, g.num_nodes, config,
                                    checkpoint_dir=ckdir, checkpoint_every=1))
    np.testing.assert_allclose(full, resumed, rtol=1e-5, atol=1e-7)


def test_streaming_embed_matches_materialized():
    """Two-pass streaming embed is bit-identical to the stored-walk path."""
    adj = two_clique_graph(k=8)
    ids = [str(i) for i in range(adj.shape[0])]
    g1 = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    e1 = g1.embed(dim=16, num_walks=4, walk_length=10, window_size=3,
                  streaming=True)
    g2 = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    e2 = g2.embed(dim=16, num_walks=4, walk_length=10, window_size=3,
                  streaming=False)
    np.testing.assert_allclose(e1, e2, atol=1e-7)


def test_bfloat16_tables_train():
    """bf16 tables train (the applier rounds each update to nearest) and
    the explicit choice warns about it."""
    adj = two_clique_graph(k=8)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    walks, eff = g.simulate_walks_device(8, 12)
    config = sgns.SGNSConfig(
        dim=16, window=3, epochs=2, sample=0.0, seed=0,
        table_dtype="bfloat16",
    )
    with pytest.warns(UserWarning, match="round every update to nearest"):
        emb = np.asarray(sgns.train(walks, eff, g.num_nodes, config))
    assert emb.dtype == np.float32  # upcast on return
    assert np.isfinite(emb).all()


def test_streaming_checkpoint_resume(tmp_path):
    """Interrupted streaming training resumes to the identical state."""
    adj = two_clique_graph(k=4)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    base_key = g._base_key()

    def walk_chunks(_pass):
        return g._walk_chunks(6, 8, base_key)

    config = sgns.SGNSConfig(dim=8, window=2, epochs=4, batch_walks=16, seed=0)
    full = np.asarray(sgns.train_streaming(walk_chunks, g.num_nodes, config))

    ckdir = str(tmp_path / "ck")
    sgns.train_streaming(walk_chunks, g.num_nodes, config,
                         checkpoint_dir=ckdir, checkpoint_every=1,
                         max_steps=2)
    resumed = np.asarray(
        sgns.train_streaming(walk_chunks, g.num_nodes, config,
                             checkpoint_dir=ckdir, checkpoint_every=1)
    )
    np.testing.assert_allclose(full, resumed, rtol=1e-5, atol=1e-7)


def test_negative_pool_equivalence_constant_table(rng):
    """With a constant negative table every draw is the same node, so the
    pooled and direct paths must produce the same update (the pooling
    machinery — stride assignment, residue aggregation, roll — reduces
    to a reorder of float sums)."""
    import jax
    import jax.numpy as jnp

    n, dim = 30, 16
    walks = jnp.asarray(
        rng.integers(0, n, (8, 12), dtype=np.int32)
    )
    eff = jnp.full((8,), 12, dtype=jnp.int32)
    w_in = jnp.asarray(rng.standard_normal((n, dim)).astype(np.float32) * 0.1)
    w_out = jnp.asarray(rng.standard_normal((n, dim)).astype(np.float32) * 0.1)
    keep = jnp.ones(n, dtype=jnp.float32)
    neg_table = jnp.full((256,), 7, dtype=jnp.int32)
    key = jax.random.PRNGKey(3)

    outs = {}
    for pool in (0, 16):
        config = sgns.SGNSConfig(
            dim=dim, window=3, negative=4, sample=0.0, seed=0,
            neg_pool=pool,
        )
        step = jax.jit(sgns.make_step_body(n, config))
        outs[pool] = step(
            w_in, w_out, walks, eff, keep, neg_table,
            jnp.float32(0.02), key,
        )
    np.testing.assert_allclose(
        np.asarray(outs[0][0]), np.asarray(outs[16][0]), atol=2e-6
    )
    np.testing.assert_allclose(
        np.asarray(outs[0][1]), np.asarray(outs[16][1]), atol=2e-6
    )


def test_negative_pool_quality(rng):
    """Training quality holds with the pooled negative sampler forced on
    (tiny pool relative to the draw count)."""
    import test_downstream as td

    adj, labels = td.sbm_graph(rng)
    ids = [str(i) for i in range(adj.shape[0])]
    from pecanpy_tpu import pecanpy

    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    walks, eff = g.simulate_walks_device(8, 30)
    config = sgns.SGNSConfig(
        dim=32, window=5, epochs=3, sample=0.0, seed=0, neg_pool=256,
    )
    emb = np.asarray(sgns.train(walks, eff, g.num_nodes, config))
    f1 = td.micro_f1_nearest_centroid(emb, labels, rng)
    assert f1 >= 0.9, f"micro-F1 {f1:.3f} below 0.9 with pooled negatives"


def test_stripe_bases_distinct():
    """Stripe bases must be pairwise distinct mod M — including the
    aliasing case M | BT where the raw k*BT bases all collapse to 0
    (e.g. batch_walks=512, walk_length=63: BT = 32768 = default pool,
    which made all 5 negatives of every token the SAME pool slot)."""
    for k_neg, bt, m in [
        (5, 32768, 32768),  # BT == M: raw bases all zero
        (5, 16384, 32768),  # M | 2*BT: raw bases pair up
        (5, 40, 32),
        (3, 7, 8),
        (4, 1000, 4096),
    ]:
        bases = sgns._stripe_bases(k_neg, bt, m)
        assert len(set(bases)) == k_neg, (k_neg, bt, m, bases)
        assert all(0 <= b < m for b in bases)


@pytest.mark.parametrize("wb,t,m_pool", [(4, 10, 32), (4, 8, 32)])
def test_negative_pool_kmajor_oracle(rng, wb, t, m_pool):
    """Pooled path vs the DIRECT path forced onto the identical k-major
    negative assignment: per-id update totals must match, so the final
    tables agree to float-reorder tolerance. Catches any misalignment in
    the stripe roll/reshape-sum slot math (which a constant negative
    table cannot see). The (4, 8, 32) case has BT == M — the stripe
    aliasing regression."""
    import dataclasses as dc
    from unittest import mock

    import jax
    import jax.numpy as jnp

    n, dim = 25, 8
    k_neg = 3  # r_neg > M in both cases: pooled
    bt = wb * t
    walks = jnp.asarray(rng.integers(0, n, (wb, t), dtype=np.int32))
    eff = jnp.full((wb,), t, dtype=jnp.int32)
    w_in = jnp.asarray(rng.standard_normal((n, dim)).astype(np.float32) * 0.1)
    w_out = jnp.asarray(
        rng.standard_normal((n, dim)).astype(np.float32) * 0.1
    )
    keep = jnp.ones(n, dtype=jnp.float32)
    # identity table: the direct path's negative ids equal its slots
    neg_table = jnp.arange(n, dtype=jnp.int32)
    key = jax.random.PRNGKey(5)
    lr = jnp.float32(0.02)

    # replicate the pooled step's key tree and stripe assignment
    _, _, key_neg, _ = jax.random.split(key, 4)
    k_pool, k_off = jax.random.split(key_neg)
    pool = neg_table[jax.random.randint(k_pool, (m_pool,), 0, n)]
    off = jax.random.randint(k_off, (), 0, m_pool)
    pool_r = jnp.roll(pool, -off)
    bases = jnp.asarray(
        sgns._stripe_bases(k_neg, bt, m_pool), dtype=jnp.int32
    )
    f = (
        bases[:, None] + jnp.arange(bt, dtype=jnp.int32)[None, :]
    ) % m_pool
    negs_kmajor = pool_r[f].T.reshape(wb, t, k_neg)

    cfg = sgns.SGNSConfig(
        dim=dim, window=3, negative=k_neg, sample=0.0, seed=0,
        neg_pool=m_pool,
    )
    out_pool = sgns.make_step_body(n, cfg)(
        jnp.copy(w_in), jnp.copy(w_out), walks, eff, keep, neg_table,
        lr, key,
    )

    real_randint = jax.random.randint

    def forced_randint(k, shape, minval, maxval, *a, **kw):
        if tuple(shape) == (wb, t, k_neg):  # the direct slot draw
            return negs_kmajor
        return real_randint(k, shape, minval, maxval, *a, **kw)

    with mock.patch.object(jax.random, "randint", forced_randint):
        out_direct = sgns.make_step_body(n, dc.replace(cfg, neg_pool=0))(
            jnp.copy(w_in), jnp.copy(w_out), walks, eff, keep, neg_table,
            lr, key,
        )
    for got, want in zip(out_pool, out_direct):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(want), atol=3e-6
        )


def test_streaming_walk_cache_equivalence():
    """Device-cached walk replay must be bit-identical to regeneration
    (same chunks either way), including across epochs."""
    import jax.numpy as jnp

    adj = two_clique_graph()
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, p=1, q=1, random_state=4)
    base_key = g._base_key()

    def walk_chunks(_pass):
        return g._walk_chunks(num_walks=4, walk_length=8, base_key=base_key)

    config = sgns.SGNSConfig(dim=8, window=3, epochs=2, seed=0)
    outs = [
        np.asarray(
            sgns.train_streaming(
                walk_chunks, g.num_nodes, config, cache_walks_bytes=cb
            )
        )
        for cb in (0, None)
    ]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_auto_table_dtype_size_aware(monkeypatch):
    """table_dtype='auto' resolves to f32 on a GPU backend, for any
    table size (the applier has no stochastic rounding, so bf16 would
    drop sub-ulp SGD updates)."""
    import jax.numpy as jnp

    from pecanpy_tpu.models import sgns as sgns_mod

    monkeypatch.setattr(sgns_mod.jax, "default_backend", lambda: "gpu")
    for dim in (16, 128, 1024):
        cfg = sgns_mod.SGNSConfig(dim=dim, table_dtype="auto")
        assert sgns_mod.resolve_table_dtype(cfg) == jnp.float32
    # explicit choices pass through
    assert (
        sgns_mod.resolve_table_dtype(sgns_mod.SGNSConfig(table_dtype="float32"))
        == jnp.float32
    )
    with pytest.warns(UserWarning, match="round every update to nearest"):
        assert (
            sgns_mod.resolve_table_dtype(
                sgns_mod.SGNSConfig(table_dtype="bfloat16")
            )
            == jnp.bfloat16
        )


def test_embed_small_corpus_epochs_advisory(rng):
    """embed() surfaces the measured epochs/quality exchange rate when a
    small corpus runs at the default epochs=1."""
    import warnings

    import oracle
    from pecanpy_tpu import pecanpy

    adj = oracle.random_graph(rng, 12, mean_degree=3.0)
    ids = [str(i) for i in range(12)]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    with pytest.warns(UserWarning, match="epochs=2 matches"):
        g.embed(dim=8, num_walks=2, walk_length=5, window_size=2, epochs=1)
    # no advisory once the user opts into epochs >= 2
    g2 = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g2.embed(dim=8, num_walks=2, walk_length=5, window_size=2, epochs=2)


def test_gather_1d_exact(rng):
    """Lane-select gather (``_gather_1d``) equals direct indexing for
    f32 and int32 vectors, any length (incl. non-multiples of 128)."""
    import jax.numpy as jnp

    for n, shape in ((1000, (37,)), (4096, (5, 9)), (131, (64,))):
        vec_f = jnp.asarray(rng.normal(size=n).astype(np.float32))
        vec_i = jnp.asarray(rng.integers(0, 1 << 20, n).astype(np.int32))
        idx = jnp.asarray(rng.integers(0, n, shape).astype(np.int32))
        np.testing.assert_array_equal(
            np.asarray(sgns._gather_1d(vec_f, idx)), np.asarray(vec_f[idx])
        )
        np.testing.assert_array_equal(
            np.asarray(sgns._gather_1d(vec_i, idx)), np.asarray(vec_i[idx])
        )


def test_alloc_tables_aligned_and_logical_init():
    """Tables allocate exactly [N, dim]; the init values equal a direct
    [N, dim] uniform draw (the seeded values of earlier releases), and
    w_out starts at zero."""
    import jax
    import jax.numpy as jnp

    n, dim = 100, 16
    key = jax.random.PRNGKey(7)
    w_in, w_out = sgns._alloc_tables(key, n, dim, jnp.float32)
    assert w_in.shape == w_out.shape == (n, dim)
    bound = 0.5 / dim
    direct = jax.random.uniform(
        key, (n, dim), minval=-bound, maxval=bound
    )
    np.testing.assert_array_equal(np.asarray(w_in), np.asarray(direct))
    assert not np.asarray(w_out).any()
