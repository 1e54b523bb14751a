"""Pin the native sequential SGNS trainer against a Python oracle.

``native/seqsgns.cpp`` reproduces gensim's sequential training loop (the
evidence baseline for the capped-sum batching quality comparison,
``benchmarks/bench_quality.py --trainer sequential``). The oracle here
duplicates its splitmix64 RNG bit-for-bit and replays the identical
draw order (one uniform per token for subsampling, one randint(window)
per center, one randint(table) per negative), so any drift in the C++
loop structure — window bounds, collision skip, update order — fails the
comparison. Floats are compared with tolerance (gcc may contract the
dot products into FMAs).
"""
import numpy as np
import pytest

from pecanpy_tpu.native.loader import native_available

_M64 = (1 << 64) - 1


class SplitMix64:
    """Bit-exact replica of the C++ RNG in native/seqsgns.cpp."""

    def __init__(self, seed: int):
        self.state = seed & _M64

    def next(self) -> int:
        self.state = (self.state + 0x9E3779B97F4A7C15) & _M64
        z = self.state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        return z ^ (z >> 31)

    def uniform(self) -> float:
        return (self.next() >> 11) * (1.0 / 9007199254740992.0)

    def randint(self, n: int) -> int:
        return self.next() % n


def sequential_oracle(
    walks, eff_len, w_in, w_out, keep_prob, neg_table, window, negative,
    alpha, min_alpha, total_tokens, epochs, seed,
):
    """Python replica of pp_train_sgns_sequential (float64 math)."""
    rng = SplitMix64(seed)
    w_in = w_in.astype(np.float64).copy()
    w_out = w_out.astype(np.float64).copy()
    done = 0.0
    pairs = 0
    for _epoch in range(epochs):
        for w in range(walks.shape[0]):
            eff = min(int(eff_len[w]), walks.shape[1])
            sent = [
                int(t)
                for t in walks[w, :eff]
                if rng.uniform() < keep_prob[t]
            ]
            lr = alpha - (alpha - min_alpha) * (done / max(total_tokens, 1.0))
            lr = max(lr, min_alpha)
            m = len(sent)
            for i in range(m):
                b = rng.randint(window)
                lo = max(i - (window - b), 0)
                hi = min(i + (window - b), m - 1)
                cen = sent[i]
                for j in range(lo, hi + 1):
                    if j == i:
                        continue
                    ctx = sent[j]
                    l1 = w_in[ctx].copy()
                    neu1e = np.zeros_like(l1)
                    for k in range(negative + 1):
                        if k == 0:
                            target, label = cen, 1.0
                        else:
                            target = int(neg_table[rng.randint(len(neg_table))])
                            if target == cen:
                                continue
                            label = 0.0
                        f = float(l1 @ w_out[target])
                        g = (label - 1.0 / (1.0 + np.exp(-f))) * lr
                        neu1e += g * w_out[target]
                        w_out[target] += g * l1
                    w_in[ctx] += neu1e
                    pairs += 1
            done += eff
    return w_in, w_out, pairs


@pytest.mark.skipif(not native_available(), reason="no native toolchain")
def test_sequential_matches_python_oracle(rng):
    from pecanpy_tpu.native.loader import train_sgns_sequential_native

    n, dim, window, negative = 12, 8, 3, 2
    walks = rng.integers(0, n, (5, 9), dtype=np.int32)
    eff = np.array([9, 7, 9, 4, 9], dtype=np.int32)
    w_in0 = (rng.standard_normal((n, dim)) * 0.1).astype(np.float32)
    w_out0 = (rng.standard_normal((n, dim)) * 0.1).astype(np.float32)
    keep = np.clip(rng.random(n).astype(np.float32) + 0.5, 0, 1)
    neg_table = rng.integers(0, n, 64, dtype=np.int32)
    total = float(eff.sum()) * 2

    w_in = w_in0.copy()
    w_out = w_out0.copy()
    pairs = train_sgns_sequential_native(
        walks, eff, w_in, w_out, keep, neg_table,
        window, negative, 0.05, 0.001, total, 2, 1234,
    )
    exp_in, exp_out, exp_pairs = sequential_oracle(
        walks, eff, w_in0, w_out0, keep, neg_table,
        window, negative, 0.05, 0.001, total, 2, 1234,
    )
    assert pairs == exp_pairs and pairs > 0
    np.testing.assert_allclose(w_in, exp_in, atol=2e-5)
    np.testing.assert_allclose(w_out, exp_out, atol=2e-5)


@pytest.mark.skipif(not native_available(), reason="no native toolchain")
def test_sequential_trains_communities(rng):
    """Sequential reference learns the same SBM the device trainer is gated
    on (sanity that it is a usable quality baseline)."""
    import test_downstream as td

    from pecanpy_tpu import pecanpy
    from pecanpy_tpu.models import sgns
    from pecanpy_tpu.native.loader import train_sgns_sequential_native

    adj, labels = td.sbm_graph(rng)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    walks, eff = g.simulate_walks_device(8, 30)
    walks = np.asarray(walks)
    eff = np.asarray(eff)
    n, dim = g.num_nodes, 32

    counts = np.zeros(n)
    for row, e in zip(walks, eff):
        np.add.at(counts, row[:e], 1.0)
    keep = np.asarray(sgns._keep_probs(counts.astype(np.float32), 0.0))
    neg_table = sgns.build_negative_table(counts, size=1 << 16, seed=0)
    rng_init = np.random.default_rng(0)
    w_in = rng_init.uniform(-0.5 / dim, 0.5 / dim, (n, dim)).astype(
        np.float32
    )
    w_out = np.zeros((n, dim), dtype=np.float32)
    train_sgns_sequential_native(
        walks, eff, w_in, w_out, keep, neg_table,
        5, 5, 0.025, 0.0001, float(eff.sum()) * 3, 3, 7,
    )
    f1 = td.micro_f1_nearest_centroid(w_in, labels, rng)
    assert f1 >= 0.9, f"sequential trainer micro-F1 {f1:.3f} below 0.9"


@pytest.mark.skipif(not native_available(), reason="no native toolchain")
def test_hogwild_trains_communities(rng):
    """The multithreaded (hogwild) path learns the same SBM — races
    degrade determinism, not quality (the gensim workers>1 contract)."""
    import test_downstream as td

    from pecanpy_tpu import pecanpy
    from pecanpy_tpu.models import sgns

    adj, labels = td.sbm_graph(rng)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    walks, eff = g.simulate_walks_device(8, 30)
    config = sgns.SGNSConfig(dim=32, window=5, epochs=3, seed=7, sample=0.0)
    emb = sgns.train_sequential(
        np.asarray(walks), np.asarray(eff), g.num_nodes, config, workers=3
    )
    assert emb.shape == (g.num_nodes, 32)
    assert np.isfinite(emb).all()
    f1 = td.micro_f1_nearest_centroid(emb, labels, rng)
    assert f1 >= 0.9, f"hogwild trainer micro-F1 {f1:.3f} below 0.9"


@pytest.mark.skipif(not native_available(), reason="no native toolchain")
def test_embed_trainer_sequential(karate_edg):
    """embed(trainer='sequential') end to end on karate."""
    from pecanpy_tpu import pecanpy

    g = pecanpy.SparseOTF(random_state=0, workers=2)
    g.read_edg(karate_edg, weighted=False, directed=False)
    emb = g.embed(
        dim=8, num_walks=2, walk_length=10, window_size=3,
        trainer="sequential",
    )
    assert emb.shape == (34, 8)
    assert np.isfinite(emb).all()
    assert np.abs(emb).sum() > 0


def test_embed_trainer_rejects_unknown(karate_edg):
    from pecanpy_tpu import pecanpy

    g = pecanpy.SparseOTF(random_state=0)
    g.read_edg(karate_edg, weighted=False, directed=False)
    with pytest.raises(ValueError, match="unknown trainer"):
        g.embed(dim=4, num_walks=1, walk_length=5, trainer="gensim")
    with pytest.raises(ValueError, match="sequential"):
        g.embed(
            dim=4, num_walks=1, walk_length=5,
            trainer="sequential", n_devices=2,
        )
