#!/usr/bin/env python
"""End-to-end `embed()` wall-clock benchmark at the BASELINE.md shape.

Default: 1M-node uniform random graph (mean degree 16), num_walks=10,
walk_length=80, dim 128, window 10 -> 810M-token corpus, streaming
pipeline with the device walk cache. `--powerlaw` switches to the
1M-node Chung-Lu hub graph (max degree ~467k) — the workload family the
reference is known for; walks then run the amortized rejection engine.

Numbers recorded in BENCH.md were produced by exactly this flow.

Run from repo root: python benchmarks/bench_e2e.py [--powerlaw] [n]
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def build_uniform_csr(n, deg=16, seed=0):
    rng = np.random.default_rng(seed)
    m = n * deg // 2
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    w = np.concatenate([rng.uniform(0.5, 2.0, keep.sum())] * 2)
    order = np.lexsort((v, u))
    u, v, w = u[order], v[order], w[order]
    dup = np.zeros(u.size, bool)
    dup[1:] = (u[1:] == u[:-1]) & (v[1:] == v[:-1])
    u, v, w = u[~dup], v[~dup], w[~dup]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, u + 1, 1)
    return np.cumsum(indptr), v, w


def main():
    from pecanpy_tpu import pecanpy

    powerlaw = "--powerlaw" in sys.argv
    pos = [a for a in sys.argv[1:] if not a.startswith("-")]
    n = int(pos[0]) if pos else 1_000_000

    if powerlaw:
        from benchmarks.bench_powerlaw import build_powerlaw_graph

        indptr, indices, data = build_powerlaw_graph(n)
    else:
        indptr, indices, data = build_uniform_csr(n)

    g = pecanpy.SparseOTF(p=0.5, q=2.0, random_state=0)
    g.indptr = indptr.astype(np.uint32)
    g.indices = np.asarray(indices).astype(np.uint32)
    g.data = np.asarray(data).astype(np.float32)
    g.set_node_ids(None, implicit_ids=True, num_nodes=n)
    print(
        f"{'power-law' if powerlaw else 'uniform'} graph ready: "
        f"{g.num_edges} directed edges",
        file=sys.stderr,
    )
    t0 = time.perf_counter()
    emb = g.embed(
        dim=128, num_walks=10, walk_length=80, window_size=10, verbose=True
    )
    dt = time.perf_counter() - t0
    assert emb.shape == (n, 128) and np.isfinite(emb).all()
    name = "e2e_powerlaw_seconds" if powerlaw else "e2e_embed_seconds"
    print(f'{{"metric": "{name}", "value": {dt:.1f}, "unit": "s"}}')


if __name__ == "__main__":
    main()
