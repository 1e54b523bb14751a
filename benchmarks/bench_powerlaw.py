#!/usr/bin/env python
"""Hub-path benchmark: 2nd-order walks on a heavy-tailed 1M-node graph.

The headline ``bench.py`` uses a near-uniform-degree graph (pure fused
path). This one builds a Chung-Lu style power-law graph whose hubs exceed
any sane fused row width, so steps touching them run the rejection
sampler (``ops/rejection.py``). A padded layout would need
O(N * max_degree) memory (hundreds of GB here); the hub structures keep
it at O(E).

Usage: python benchmarks/bench_powerlaw.py [n_nodes] [exponent]
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")  # run as: python benchmarks/bench_powerlaw.py


def build_powerlaw_graph(n, avg_deg=16, exponent=2.2, seed=0, directed=False):
    """Chung-Lu heavy-tail graph as a sorted CSR triple.

    ``directed=True`` keeps each sampled arc one-way with an asymmetric
    weight (w(u,v) != w(v,u) even when both arcs exist), so the
    symmetric-graph shortcuts (build-time ``symmetric`` detection, the
    amortized walker's probe-free return-edge atom) cannot engage.
    """
    rng = np.random.default_rng(seed)
    # expected-degree weights ~ Pareto(exponent - 1)
    w = (1.0 - rng.random(n)) ** (-1.0 / (exponent - 1.0))
    prob = w / w.sum()
    m = n * avg_deg // 2
    cdf = np.cumsum(prob)
    src = np.searchsorted(cdf, rng.random(m)).astype(np.int64)
    dst = np.searchsorted(cdf, rng.random(m)).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if directed:
        u, v = src, dst
    else:
        u = np.concatenate([src, dst])
        v = np.concatenate([dst, src])
    code = np.unique(u * n + v)
    u, v = code // n, code % n
    if directed:
        wgt = (((u * 2654435761 + v) % 1000) / 1000.0 * 1.5 + 0.5).astype(
            np.float32
        )
    else:
        lo, hi = np.minimum(u, v), np.maximum(u, v)
        wgt = (((lo * 2654435761 + hi) % 1000) / 1000.0 * 1.5 + 0.5).astype(
            np.float32
        )
    deg = np.bincount(u, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    return indptr, v.astype(np.int64), wgt


def main():
    import jax
    import jax.numpy as jnp

    from pecanpy_tpu.models import engine
    from pecanpy_tpu.ops import rejection, sampling, transition
    from pecanpy_tpu.ops.layout import build_device_csr

    import os

    pos = [a for a in sys.argv[1:] if not a.startswith("-")]
    n = int(pos[0]) if len(pos) > 0 else 1_000_000
    exponent = float(pos[1]) if len(pos) > 1 else 2.2
    p, q = 0.5, 2.0
    eng = os.environ.get("POWERLAW_ENGINE", "queued")
    lanes = int(os.environ.get("BENCH_LANES", 32_768))
    walkers = int(
        os.environ.get("BENCH_WALKERS", 262_144 if eng == "queued" else 32_768)
    )
    walk_length = int(os.environ.get("BENCH_WALK_LENGTH", 80))
    cap = 128

    directed = "--directed" in sys.argv
    print(
        f"building {n}-node {'directed ' if directed else ''}power-law "
        "graph...",
        file=sys.stderr,
    )
    indptr, indices, data = build_powerlaw_graph(
        n, exponent=exponent, directed=directed
    )
    deg = np.diff(indptr)
    print(
        f"graph: {int(indptr[-1])} directed edges, max degree {deg.max()}, "
        f"hubs(deg>{cap}): {(deg > cap).sum()} "
        f"({(deg * (deg > cap)).sum() / max(indptr[-1], 1):.1%} of edges)",
        file=sys.stderr,
    )
    # default 1: the production OTF path builds the cdf channel for hub
    # graphs (modes._want_cdf; measured +26% walk throughput)
    with_cdf = os.environ.get("BENCH_CDF", "1") == "1"
    t0 = time.perf_counter()
    graph = build_device_csr(
        indptr, indices, data, degree_cap=cap, with_cdf=with_cdf
    )
    print(
        f"device build (incl. hub tables): {time.perf_counter() - t0:.1f}s, "
        f"has_hubs={graph.has_hubs}",
        file=sys.stderr,
    )

    import os

    legacy = eng == "per-step"
    trials = int(os.environ.get("PECANPY_TPU_AMORTIZED_TRIALS", "2"))
    print(
        f"engine: {eng}"
        + (
            ""
            if legacy
            else f" (trials={trials}, cdf={with_cdf}, walks={walkers}"
            + (f", lanes={lanes})" if eng == "queued" else ")")
        ),
        file=sys.stderr,
    )

    if eng == "queued":

        @jax.jit
        def run(g, starts, key):
            return engine.generate_walks_queued(
                g, starts, key, walk_length, p, q, False,
                lanes=lanes, trials=trials,
            )

    elif legacy:

        @jax.jit
        def run(g, starts, key):
            def first_fn(k, cur, cur_rows):
                x, _ = rejection.propose(g, k, cur_rows)
                return x

            def step_fn(k, cur, prev, cur_rows, prev_rows):
                k_f, k_r = jax.random.split(k)
                w = transition.node2vec_weights_rows(
                    g, cur_rows, prev_rows, prev, p, q
                )
                c = sampling.categorical_rows(k_f, w)
                nxt = sampling.pick_int_columns(g.rows_nbr(cur_rows), c)
                use_rej = g.rows_is_hub(cur_rows) | g.rows_is_hub(prev_rows)
                nxt_rej = rejection.second_order_sample(
                    g, k_r, cur, prev, cur_rows, prev_rows, p, q, False,
                    use_rej,
                )
                return jnp.where(use_rej, nxt_rej, nxt)

            return engine.generate_walks(
                g, first_fn, step_fn, starts, key, walk_length
            )

    else:

        @jax.jit
        def run(g, starts, key):
            return engine.generate_walks_amortized(
                g, starts, key, walk_length, p, q, False, trials=trials
            )

    rng = np.random.default_rng(0)
    starts = jnp.asarray(rng.integers(0, n, walkers, dtype=np.int32))
    key = jax.random.PRNGKey(0)

    np.asarray(run(graph, starts, key)[1])  # warmup/compile
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        np.asarray(run(graph, starts, jax.random.fold_in(key, i))[1])
        times.append(time.perf_counter() - t0)
    sps = walkers * walk_length / min(times)
    print(f"device: {sps:.3e} steps/s (best of 3)", file=sys.stderr)
    name = "powerlaw_walk_steps_per_sec" + ("_directed" if directed else "")
    print(
        f'{{"metric": "{name}", "value": {sps}, "unit": "steps/s"}}'
    )


if __name__ == "__main__":
    main()
