"""Hub (degree > cap) structures and the rejection-sampling walk path.

Forcing a tiny ``degree_cap`` on small random graphs routes most steps
through the flat alias + hash + rejection machinery (``ops/hubs.py``,
``ops/rejection.py``), which must reproduce the exact same transition
distributions as the fused kernels / the numpy oracle.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from pecanpy_tpu import pecanpy
from pecanpy_tpu.ops import hubs, rejection
from pecanpy_tpu.ops.layout import device_csr_from_dense

CAP = 6  # far below the mean degree -> most nodes become hubs


def hub_graph(rng, n=14, mean_degree=8.0, weighted=True, **kwargs):
    adj = oracle.random_graph(rng, n, mean_degree=mean_degree, weighted=weighted)
    return adj, device_csr_from_dense(adj, degree_cap=CAP, **kwargs)


def test_capped_layout_markers(rng):
    adj, g = hub_graph(rng)
    n = adj.shape[0]
    assert g.has_hubs
    deg = np.asarray(g.deg)
    nbr = np.asarray(g.rows_nbr(g.fused))
    seen_base = -1
    for i in range(n):
        if deg[i] > CAP:
            assert nbr[i, 0] == n + 1 + deg[i]
            assert nbr[i, 1] > seen_base  # edge_pack bases strictly grow
            seen_base = nbr[i, 1]
        else:
            row = nbr[i][nbr[i] != n]
            np.testing.assert_array_equal(np.sort(row), np.nonzero(adj[i])[0])


def test_edge_pack_alias_exact(rng):
    """Packed alias rows must imply the exact first-order distribution."""
    adj, g = hub_graph(rng)
    n = adj.shape[0]
    deg = np.asarray(g.deg)
    # slot view of the 64-lane super-row storage (8 slots per stored row)
    pack = np.asarray(g.edge_pack).reshape(-1, 8)
    packi = pack.view(np.int32)
    nbr = np.asarray(g.rows_nbr(g.fused))
    for u in np.nonzero(deg > CAP)[0]:
        base, k = nbr[u, 1], deg[u]
        mass = np.zeros(n)
        for s in range(base, base + k):
            mass[packi[s, 1]] += pack[s, 0]  # self slot, prob q
            mass[packi[s, 3]] += 1.0 - pack[s, 0]  # alias target
        expected = np.zeros(n)
        expected[np.nonzero(adj[u])[0]] = oracle.first_order_probs(adj, u) * k
        np.testing.assert_allclose(mass, expected, rtol=1e-5, atol=1e-5)
        # packed weights must be the true edge weights
        for s in range(base, base + k):
            np.testing.assert_allclose(pack[s, 2], adj[u, packi[s, 1]])
            np.testing.assert_allclose(pack[s, 4], adj[u, packi[s, 3]])


def test_hub_hash_membership(rng):
    adj, g = hub_graph(rng)
    n = adj.shape[0]
    deg = np.asarray(g.deg)
    hub_ids = np.nonzero(deg > CAP)[0]
    assert hub_ids.size > 0
    rows = g.gather_rows(jnp.asarray(hub_ids, dtype=jnp.int32))
    for x in range(n):
        found, wpx = jax.jit(rejection.membership)(
            g, jnp.full((hub_ids.size,), x, dtype=jnp.int32), rows
        )
        for i, u in enumerate(hub_ids):
            assert bool(found[i]) == bool(adj[u, x] != 0), f"{u=} {x=}"
            np.testing.assert_allclose(float(wpx[i]), adj[u, x], rtol=1e-6)


def test_membership_against_small_rows(rng):
    """The carried-row compare path of membership (prev below the cap)."""
    adj, g = hub_graph(rng)
    n = adj.shape[0]
    deg = np.asarray(g.deg)
    small_ids = np.nonzero((deg > 0) & (deg <= CAP))[0]
    if small_ids.size == 0:
        pytest.skip("no small nodes in fixture")
    rows = g.gather_rows(jnp.asarray(small_ids, dtype=jnp.int32))
    for x in range(n):
        found, wpx = jax.jit(rejection.membership)(
            g, jnp.full((small_ids.size,), x, dtype=jnp.int32), rows
        )
        for i, u in enumerate(small_ids):
            assert bool(found[i]) == bool(adj[u, x] != 0)
            np.testing.assert_allclose(float(wpx[i]), adj[u, x], rtol=1e-6)


def test_propose_matches_first_order(rng):
    """Proposal draws (hub alias + fused CDF select) ~ w(cur, .)."""
    adj, g = hub_graph(rng, n=10)
    reps = 4000
    for u in range(adj.shape[0]):
        if np.asarray(g.deg)[u] == 0:
            continue
        cur = jnp.full((reps,), u, dtype=jnp.int32)
        rows = g.gather_rows(cur)
        x, wx = jax.jit(rejection.propose)(g, jax.random.PRNGKey(u), rows)
        x = np.asarray(x)
        expected = oracle.first_order_probs(adj, u)
        nbrs = np.nonzero(adj[u])[0]
        freq = np.array([(x == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(freq, expected, atol=0.05)
        # returned weights must be the true edge weights
        np.testing.assert_allclose(
            np.asarray(wx), adj[u, x], rtol=1e-6
        )


@pytest.mark.parametrize(
    "p,q,extend,gamma",
    [(0.5, 2.0, False, 0.0), (1.0, 0.5, True, 0.0), (2.0, 0.5, True, 0.5)],
)
def test_hub_second_order_distribution(p, q, extend, gamma, rng):
    """Walks through hub nodes follow the exact 2nd-order law."""
    adj = oracle.random_graph(rng, 8, mean_degree=5.0, weighted=True)
    ids = [str(i) for i in range(8)]
    g = pecanpy.SparseOTF.from_mat(
        adj, ids, p=p, q=q, extend=extend, gamma=gamma, random_state=11,
        degree_cap=CAP,
    )
    assert g.get_device_graph().has_hubs
    walks, eff = g.simulate_walks_device(num_walks=700, walk_length=4)
    walks, eff = np.asarray(walks), np.asarray(eff)

    counts = {}
    for row, m in zip(walks, eff):
        for j in range(2, m):
            counts.setdefault((row[j - 2], row[j - 1]), []).append(row[j])

    checked = 0
    for (prev, cur), nxts in counts.items():
        if len(nxts) < 400:
            continue
        nbrs = np.nonzero(adj[cur])[0]
        if extend:
            expected = oracle.node2vec_plus_probs(adj, cur, prev, p, q, gamma)
        else:
            expected = oracle.node2vec_probs(adj, cur, prev, p, q)
        freq = np.array([(np.array(nxts) == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(
            freq, expected, atol=4.5 * np.sqrt(0.25 / len(nxts)),
            err_msg=f"cur={cur} prev={prev} n={len(nxts)}",
        )
        checked += 1
    assert checked >= 3, "not enough high-count transitions to test"


def test_hub_second_order_distribution_per_step_sampler(rng, monkeypatch):
    """The per-step rejection sampler (the sharded walker's path) stays
    distributionally exact with the amortized engine forced off."""
    monkeypatch.setenv("PECANPY_TPU_AMORTIZED", "0")
    p, q = 0.5, 2.0
    adj = oracle.random_graph(rng, 8, mean_degree=5.0, weighted=True)
    ids = [str(i) for i in range(8)]
    g = pecanpy.SparseOTF.from_mat(
        adj, ids, p=p, q=q, random_state=7, degree_cap=CAP
    )
    walks, eff = g.simulate_walks_device(num_walks=700, walk_length=4)
    walks, eff = np.asarray(walks), np.asarray(eff)
    counts = {}
    for row, m in zip(walks, eff):
        for j in range(2, m):
            counts.setdefault((row[j - 2], row[j - 1]), []).append(row[j])
    checked = 0
    for (prev, cur), nxts in counts.items():
        if len(nxts) < 400:
            continue
        nbrs = np.nonzero(adj[cur])[0]
        expected = oracle.node2vec_probs(adj, cur, prev, p, q)
        freq = np.array([(np.array(nxts) == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(
            freq, expected, atol=4.5 * np.sqrt(0.25 / len(nxts))
        )
        checked += 1
    assert checked >= 3


def test_amortized_walks_deterministic(rng):
    """Same seed -> identical walks through the stall-round engine."""
    adj = oracle.random_graph(rng, 12, mean_degree=8.0, weighted=True)
    ids = [str(i) for i in range(12)]
    outs = []
    for _ in range(2):
        g = pecanpy.SparseOTF.from_mat(
            adj, ids, p=0.5, q=2.0, random_state=3, degree_cap=CAP
        )
        walks, eff = g.simulate_walks_device(3, 6)
        outs.append((np.asarray(walks), np.asarray(eff)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_amortized_early_termination(rng):
    """Walkers hitting a sink stop with the right effective length and
    resting emission (the scan engine's contract)."""
    n = 9
    adj = oracle.random_graph(rng, n, mean_degree=5.0, weighted=True)
    adj[n - 1, :] = 0  # sink: edges in, none out
    ids = [str(i) for i in range(n)]
    g = pecanpy.SparseOTF.from_mat(
        adj, ids, p=0.5, q=2.0, random_state=5, degree_cap=CAP
    )
    walks, eff = g.simulate_walks_device(40, 6)
    walks, eff = np.asarray(walks), np.asarray(eff)
    hit_sink = False
    for row, m in zip(walks, eff):
        for a, b in zip(row[: m - 1], row[1:m]):
            assert adj[a, b] != 0, f"non-edge {a}->{b}"
        if m <= 6:
            hit_sink = True
            assert adj[row[m - 1]].sum() == 0  # stopped at a sink
            assert (row[m:] == row[m - 1]).all()  # resting emission
    assert hit_sink, "fixture never reached the sink"


def test_hub_walks_follow_edges(rng):
    for mode_cls, weighted in [
        (pecanpy.SparseOTF, True),
        (pecanpy.FirstOrderUnweighted, False),
        (pecanpy.PreCompFirstOrder, True),
    ]:
        adj = oracle.random_graph(rng, 12, mean_degree=8.0, weighted=weighted)
        ids = [str(i) for i in range(12)]
        g = mode_cls.from_mat(adj, ids, random_state=0, degree_cap=CAP)
        walks, eff = g.simulate_walks_device(2, 6)
        walks, eff = np.asarray(walks), np.asarray(eff)
        for row, n in zip(walks, eff):
            for a, b in zip(row[: n - 1], row[1:n]):
                assert adj[a, b] != 0, f"{mode_cls.__name__}: non-edge {a}->{b}"


def test_first_order_hub_modes_distribution(rng):
    adj = oracle.random_graph(rng, 8, mean_degree=6.0, weighted=True)
    ids = [str(i) for i in range(8)]
    g = pecanpy.PreCompFirstOrder.from_mat(
        adj, ids, random_state=2, degree_cap=CAP
    )
    walks, eff = g.simulate_walks_device(num_walks=900, walk_length=3)
    walks, eff = np.asarray(walks), np.asarray(eff)
    for node in range(8):
        nbrs = np.nonzero(adj[node])[0]
        if nbrs.size < 2:
            continue
        rows = walks[(walks[:, 0] == node) & (eff > 1)]
        expected = oracle.first_order_probs(adj, node)
        freq = np.array([(rows[:, 1] == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(freq, expected, atol=0.07)


def test_no_hubs_static_path(rng):
    """degree_cap above the max degree compiles the pure fused engine."""
    adj = oracle.random_graph(rng, 10, mean_degree=3.0)
    g = device_csr_from_dense(adj, degree_cap=128)
    assert not g.has_hubs
    assert g.edge_pack.size == 0 and g.hbuckets.size == 0


def test_bucket_hash_contains_every_key(rng):
    """Every hub neighbor must sit in exactly its hashed bucket."""
    n = 50
    adj = oracle.random_graph(rng, n, mean_degree=20.0)
    rows_, cols = np.nonzero(adj)
    deg = np.bincount(rows_, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    hub_ids = np.nonzero(deg > 8)[0]
    wgt = adj[rows_, cols].astype(np.float32)
    hkey8, hval8, bbase, blog = hubs.build_bucket_hash(
        indptr, cols, wgt, hub_ids
    )
    for i, u in enumerate(hub_ids):
        mask = (1 << blog[i]) - 1
        for e in range(indptr[u], indptr[u + 1]):
            x = cols[e]
            bucket = bbase[i] + int(hubs.hub_hash(np.int64(x), mask))
            slots = np.nonzero(hkey8[bucket] == x)[0]
            assert slots.size == 1, f"key {x} of hub {u} not in its bucket"
            np.testing.assert_allclose(hval8[bucket, slots[0]], wgt[e])


def test_scalar_move_forward_on_hub_graph(rng):
    """Batch-1 compat callback through the rejection path (tiny batches)."""
    adj = oracle.random_graph(rng, 10, mean_degree=6.0, weighted=True)
    ids = [str(i) for i in range(10)]
    g = pecanpy.SparseOTF.from_mat(
        adj, ids, p=0.5, q=2.0, random_state=0, degree_cap=CAP
    )
    assert g.get_device_graph().has_hubs
    move = g.get_move_forward()
    start = next(i for i in range(10) if adj[i].sum() > 0)
    nxt = move(start)
    assert adj[start, nxt] != 0
    nxt2 = move(nxt, start)
    assert adj[nxt, nxt2] != 0


@pytest.mark.parametrize("b,s", [(64, 8), (300, 64), (1024, 128), (1000, 1000)])
def test_compact_indices(rng, b, s):
    """Blocked compaction == "indices of the first s pending lanes"."""
    pending = jnp.asarray(rng.random(b) < 0.3)
    idx, valid = rejection._compact_indices(pending, s)
    idx, valid = np.asarray(idx), np.asarray(valid)
    expected = np.nonzero(np.asarray(pending))[0]
    k = min(s, expected.size)
    np.testing.assert_array_equal(valid[:k], True)
    np.testing.assert_array_equal(valid[k:], False)
    np.testing.assert_array_equal(idx[:k], expected[:k])


def test_compact_indices_empty(rng):
    pending = jnp.zeros(100, dtype=bool)
    idx, valid = rejection._compact_indices(pending, 16)
    assert not np.asarray(valid).any()
    assert (np.asarray(idx) < 100).all()


def test_amortized_undirected_atom_bitwise_identical(rng):
    """On a symmetric graph, ``undirected=True`` (atom mass from the
    carried proposal weight — no membership probe) must reproduce the
    directed-safe path BITWISE: both read the same stored weight value
    and consume the identical RNG stream."""
    from pecanpy_tpu.models import engine

    adj = oracle.random_graph(rng, 14, mean_degree=9.0, weighted=True)
    g = device_csr_from_dense(adj, degree_cap=CAP)
    assert g.has_hubs
    start = jnp.asarray(rng.integers(0, 14, 64, dtype=np.int32))
    key = jax.random.PRNGKey(11)
    out = [
        engine.generate_walks_amortized(
            g, start, key, 8, 0.5, 2.0, False, undirected=u
        )
        for u in (False, True)
    ]
    np.testing.assert_array_equal(np.asarray(out[0][0]), np.asarray(out[1][0]))
    np.testing.assert_array_equal(np.asarray(out[0][1]), np.asarray(out[1][1]))


def test_amortized_cdf_channel_distribution(rng):
    """The precomputed-CDF proposal (``with_cdf`` rows) samples the same
    second-order law: chi-square-style check against the oracle."""
    from pecanpy_tpu.models import engine

    p, q = 0.5, 2.0
    adj = oracle.random_graph(rng, 8, mean_degree=5.0, weighted=True)
    g = device_csr_from_dense(adj, degree_cap=CAP, with_cdf=True)
    start = jnp.asarray(rng.integers(0, 8, 6400, dtype=np.int32))
    walks, eff = engine.generate_walks_amortized(
        g, start, jax.random.PRNGKey(3), 4, p, q, False, undirected=True
    )
    walks, eff = np.asarray(walks), np.asarray(eff)
    counts = {}
    for row, m in zip(walks, eff):
        for j in range(2, m):
            counts.setdefault((row[j - 2], row[j - 1]), []).append(row[j])
    checked = 0
    for (prev, cur), nxts in counts.items():
        if len(nxts) < 400:
            continue
        nbrs = np.nonzero(adj[cur])[0]
        expected = oracle.node2vec_probs(adj, cur, prev, p, q)
        freq = np.array([(np.array(nxts) == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(
            freq, expected, atol=4.5 * np.sqrt(0.25 / len(nxts))
        )
        checked += 1
    assert checked >= 3


def test_amortized_directed_asymmetric_distribution(rng):
    """Directed graph with ASYMMETRIC weights through the amortized
    walker: `symmetric` detection must come back False, forcing the
    membership-probe atom path, and the sampled law must match the
    oracle. (The undirected shortcut would read the wrong return-edge
    weight here — this pins the router.)"""
    from pecanpy_tpu.models import engine

    p, q = 0.5, 2.0
    n = 8
    adj = oracle.random_graph(rng, n, mean_degree=6.0, weighted=True,
                              directed=True)
    # every node needs out-edges so contexts accumulate
    for i in range(n):
        if adj[i].sum() == 0:
            adj[i, (i + 1) % n] = 1.5
    assert not np.array_equal(adj, adj.T)
    g = device_csr_from_dense(adj, degree_cap=CAP)
    assert g.has_hubs and not g.symmetric
    start = jnp.asarray(rng.integers(0, n, 6400, dtype=np.int32))
    walks, eff = engine.generate_walks_amortized(
        g, start, jax.random.PRNGKey(9), 4, p, q, False
    )
    walks, eff = np.asarray(walks), np.asarray(eff)
    counts = {}
    for row, m in zip(walks, eff):
        for j in range(2, m):
            counts.setdefault((row[j - 2], row[j - 1]), []).append(row[j])
    checked = 0
    for (prev, cur), nxts in counts.items():
        if len(nxts) < 400:
            continue
        nbrs = np.nonzero(adj[cur])[0]
        expected = oracle.node2vec_probs(adj, cur, prev, p, q)
        freq = np.array([(np.array(nxts) == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(
            freq, expected, atol=4.5 * np.sqrt(0.25 / len(nxts))
        )
        checked += 1
    assert checked >= 3


# -- queued persistent-lane engine (walk queue >> lanes) ------------------

from pecanpy_tpu.models import engine  # noqa: E402


def test_queued_engine_second_order_distribution(rng):
    """The queued engine (lanes << walks, live claim machinery) samples
    the exact 2nd-order law; starts, early termination, and resting
    emission match the per-batch engines."""
    p, q = 0.5, 2.0
    n = 9
    adj = oracle.random_graph(rng, n, mean_degree=5.0, weighted=True)
    adj[n - 1, :] = 0  # sink: exercises death -> claim
    g = device_csr_from_dense(adj, degree_cap=CAP, with_cdf=True)
    assert g.has_hubs
    starts_h = rng.integers(0, n, 12000).astype(np.int32)
    walks, eff = engine.generate_walks_queued(
        g, jnp.asarray(starts_h), jax.random.PRNGKey(3), 4, p, q, False,
        lanes=256,
    )
    walks, eff = np.asarray(walks), np.asarray(eff)
    np.testing.assert_array_equal(walks[:, 0], starts_h)
    counts = {}
    for row, m in zip(walks, eff):
        assert (row[m:] == row[m - 1]).all()  # resting emission
        if m <= 4:
            assert adj[row[m - 1]].sum() == 0  # early stop only at sinks
        for a, b in zip(row[: m - 1], row[1:m]):
            assert adj[a, b] != 0, f"non-edge {a}->{b}"
        for j in range(2, m):
            counts.setdefault((row[j - 2], row[j - 1]), []).append(row[j])
    checked = 0
    for (prev, cur), nxts in counts.items():
        if len(nxts) < 400:
            continue
        nbrs = np.nonzero(adj[cur])[0]
        expected = oracle.node2vec_probs(adj, cur, prev, p, q)
        freq = np.array([(np.array(nxts) == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(
            freq, expected, atol=4.5 * np.sqrt(0.25 / len(nxts)),
            err_msg=f"cur={cur} prev={prev} n={len(nxts)}",
        )
        checked += 1
    assert checked >= 3


def test_queued_engine_first_order_column(rng):
    """Column 1 of every queued walk (including claimed mid-run walks)
    follows the FIRST-order law w(start, .) -- the forced-accept trial."""
    n = 8
    adj = oracle.random_graph(rng, n, mean_degree=5.0, weighted=True)
    g = device_csr_from_dense(adj, degree_cap=CAP, with_cdf=True)
    u = int(np.argmax((adj > 0).sum(1)))  # well-connected start
    starts_h = np.full(6000, u, dtype=np.int32)
    walks, eff = engine.generate_walks_queued(
        g, jnp.asarray(starts_h), jax.random.PRNGKey(5), 3, 0.25, 4.0,
        False, lanes=128,
    )
    col1 = np.asarray(walks)[:, 1]
    expected = oracle.first_order_probs(adj, u)
    nbrs = np.nonzero(adj[u])[0]
    freq = np.array([(col1 == nb).mean() for nb in nbrs])
    np.testing.assert_allclose(
        freq, expected, atol=4.5 * np.sqrt(0.25 / col1.size)
    )


def test_queued_engine_directed_distribution(rng):
    """Directed asymmetric graph through the queued engine (membership
    probe atom path)."""
    p, q = 0.5, 2.0
    n = 10
    adj = oracle.random_graph(rng, n, mean_degree=6.0, weighted=True,
                              directed=True)
    for i in range(n):
        if adj[i].sum() == 0:
            adj[i, (i + 1) % n] = 1.5
    g = device_csr_from_dense(adj, degree_cap=CAP)
    assert g.has_hubs and not g.symmetric
    starts_h = rng.integers(0, n, 6400).astype(np.int32)
    walks, eff = engine.generate_walks_queued(
        g, jnp.asarray(starts_h), jax.random.PRNGKey(9), 4, p, q, False,
        lanes=512,
    )
    walks, eff = np.asarray(walks), np.asarray(eff)
    counts = {}
    for row, m in zip(walks, eff):
        for j in range(2, m):
            counts.setdefault((row[j - 2], row[j - 1]), []).append(row[j])
    checked = 0
    for (prev, cur), nxts in counts.items():
        if len(nxts) < 400:
            continue
        nbrs = np.nonzero(adj[cur])[0]
        expected = oracle.node2vec_probs(adj, cur, prev, p, q)
        freq = np.array([(np.array(nxts) == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(
            freq, expected, atol=4.5 * np.sqrt(0.25 / len(nxts))
        )
        checked += 1
    assert checked >= 3


def test_queued_engine_walk_length_one(rng):
    adj, g = hub_graph(rng, n=10)
    starts_h = rng.integers(0, 10, 300).astype(np.int32)
    walks, eff = engine.generate_walks_queued(
        g, jnp.asarray(starts_h), jax.random.PRNGKey(1), 1, 0.5, 2.0,
        False, lanes=64,
    )
    walks = np.asarray(walks)
    assert walks.shape == (300, 2)
    np.testing.assert_array_equal(walks[:, 0], starts_h)
    for a, b in zip(walks[:, 0], walks[:, 1]):
        if adj[a].sum() > 0:
            assert adj[a, b] != 0


# -- tiered (compacted-descriptor) trial block ----------------------------


def _moderate_hub_graph(rng, n=40, cap=8):
    """Graph whose hub-edge fraction is well under the tier cutoff."""
    adj = oracle.random_graph(rng, n, mean_degree=4.0, weighted=True)
    # two hubs touching most nodes; the rest stay under the cap
    for h in (0, 1):
        for j in range(2, n, 2 + h):
            w = 0.5 + ((h + j) % 7) * 0.2
            adj[h, j] = adj[j, h] = w
    g = device_csr_from_dense(adj, degree_cap=cap, with_cdf=True)
    assert g.has_hubs
    assert 0.05 < g.hub_frac < 0.5, g.hub_frac
    return adj, g


def _second_order_check(adj, walks, eff, p, q, min_checked=3):
    counts = {}
    for row, m in zip(np.asarray(walks), np.asarray(eff)):
        for j in range(2, m):
            counts.setdefault((row[j - 2], row[j - 1]), []).append(row[j])
    checked = 0
    for (prev, cur), nxts in counts.items():
        if len(nxts) < 400:
            continue
        nbrs = np.nonzero(adj[cur])[0]
        expected = oracle.node2vec_probs(adj, cur, prev, p, q)
        freq = np.array([(np.array(nxts) == nb).mean() for nb in nbrs])
        np.testing.assert_allclose(
            freq, expected, atol=4.5 * np.sqrt(0.25 / len(nxts)),
            err_msg=f"cur={cur} prev={prev} n={len(nxts)}",
        )
        checked += 1
    assert checked >= min_checked, f"only {checked} transitions checkable"


def test_tiered_trials_distribution(rng, monkeypatch):
    """Moderate hub fraction -> the tiered block engages (tier_lanes > 0)
    and the sampled law stays exact through both engines. (The tier is
    an OPT-IN negative result -- see engine._tier_lanes -- but
    its law must stay exact for anyone who enables it.)"""
    from pecanpy_tpu.models import engine as eng

    monkeypatch.setenv("PECANPY_TPU_TIERED", "1")
    p, q = 0.5, 2.0
    adj, g = _moderate_hub_graph(rng)
    assert eng._tier_lanes(g, 4096) > 0  # the tier actually engages
    starts_h = rng.integers(0, adj.shape[0], 16000).astype(np.int32)
    walks, eff = eng.generate_walks_queued(
        g, jnp.asarray(starts_h), jax.random.PRNGKey(21), 4, p, q, False,
        lanes=4096,
    )
    _second_order_check(adj, walks, eff, p, q)
    walks, eff = eng.generate_walks_amortized(
        g, jnp.asarray(starts_h), jax.random.PRNGKey(22), 4, p, q, False,
    )
    _second_order_check(adj, walks, eff, p, q, min_checked=2)


def test_tiered_trials_overflow_unbiased(rng, monkeypatch):
    """An undersized tier sub-batch (forced overflow) voids trials but
    must NOT bias the sampled law — voided lanes just retry."""
    from pecanpy_tpu.models import engine as eng

    monkeypatch.setenv("PECANPY_TPU_TIERED", "1")
    monkeypatch.setenv("PECANPY_TPU_TIER_SLACK", "-0.15")
    p, q = 0.5, 2.0
    adj, g = _moderate_hub_graph(rng)
    s = eng._tier_lanes(g, 4096)
    assert 0 < s < int(4096 * g.hub_frac)  # genuinely undersized
    starts_h = rng.integers(0, adj.shape[0], 16000).astype(np.int32)
    walks, eff = eng.generate_walks_queued(
        g, jnp.asarray(starts_h), jax.random.PRNGKey(23), 4, p, q, False,
        lanes=4096,
    )
    _second_order_check(adj, walks, eff, p, q)


def test_tiered_disabled_on_hub_dominated_graphs(rng, monkeypatch):
    from pecanpy_tpu.models import engine as eng

    monkeypatch.setenv("PECANPY_TPU_TIERED", "1")
    adj, g = hub_graph(rng, n=14)  # CAP=6: nearly every edge is hub mass
    assert g.hub_frac > 0.6
    assert eng._tier_lanes(g, 4096) == 0
    monkeypatch.delenv("PECANPY_TPU_TIERED")
    adj2, g2 = _moderate_hub_graph(rng)
    assert eng._tier_lanes(g2, 4096) == 0  # off by default
