#!/usr/bin/env python
"""SGNS trainer benchmark: tokens/s at the 1M-node default workload shape.

Trains on synthetic walks (uniform random nodes — the trainer's cost is
shape-driven, not data-driven) with the production span-step program: one
dispatch per walk buffer.

Also times the applier in isolation at the step's real stream sizes.

Usage: python benchmarks/bench_sgns.py [n_nodes] [n_walks]
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")  # run as: python benchmarks/bench_sgns.py


def main():
    import jax
    import jax.numpy as jnp

    from pecanpy_tpu.models import sgns
    from pecanpy_tpu.ops.apply import apply_mean_updates

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    n_walks = int(sys.argv[2]) if len(sys.argv) > 2 else 32_768
    t_cols = 81  # walk_length 80 + start

    rng = np.random.default_rng(0)
    walks = jnp.asarray(rng.integers(0, n, (n_walks, t_cols), dtype=np.int32))
    eff = jnp.full((n_walks,), t_cols, dtype=jnp.int32)

    import os

    bw = int(sys.argv[3]) if len(sys.argv) > 3 else None
    # default to the shipping table dtype (float32); override with
    # BENCH_TABLE_DTYPE=bfloat16
    table_dtype = os.environ.get("BENCH_TABLE_DTYPE", "auto")
    config = sgns.SGNSConfig(
        dim=128, window=10, negative=5, seed=0, batch_walks=bw,
        table_dtype=table_dtype,
    )
    chunk = sgns.resolve_batch_walks(config, n, t_cols)
    n_chunks = n_walks // chunk
    print(
        f"N={n}, walks={n_walks}, chunk={chunk}, {n_chunks} chunk-steps",
        file=sys.stderr,
    )

    step = sgns._make_span_step(n, config, chunk)
    keep = jnp.ones(n, dtype=jnp.float32)
    neg_table = jnp.asarray(
        sgns.build_negative_table(np.ones(n), seed=0)
    )
    lrs = jnp.full((n_chunks,), 0.025, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)

    def init():
        # allocate exactly as production does
        dt = sgns.resolve_table_dtype(config)
        return sgns._alloc_tables(key, n, config.dim, dt)

    w_in, w_out = init()
    w_in, w_out = step(
        w_in, w_out, walks, eff, keep, neg_table, lrs, key, 0, n_chunks, 0
    )
    np.asarray(w_in[:1])  # force completion
    tokens = float(n_walks * t_cols)
    best = float("inf")
    for _ in range(3):
        w_in, w_out = init()
        t0 = time.perf_counter()
        w_in, w_out = step(
            w_in, w_out, walks, eff, keep, neg_table, lrs, key, 0,
            n_chunks, 0,
        )
        np.asarray(w_in[:1])
        best = min(best, time.perf_counter() - t0)
    print(
        f"span step: {tokens / best / 1e6:.2f}M tokens/s "
        f"({best / n_chunks * 1e3:.1f} ms per {chunk}-walk chunk-step)",
        file=sys.stderr,
    )

    # applier in isolation at the negative-stream size of one chunk-step
    r = chunk * t_cols * config.negative
    ids = jnp.asarray(rng.integers(0, n, r, dtype=np.int32))
    upd = jnp.asarray(rng.standard_normal((r, 128)).astype(np.float32))
    cnt = jnp.ones(r, dtype=jnp.float32)
    table = jnp.zeros(
        (n, 128),
        sgns.resolve_table_dtype(config),
    )
    # slope-timed (1 vs 5 chained applies per sync): a single-dispatch
    # wall includes the host round trip
    def chain(t, k):
        for i in range(k):
            t = apply_mean_updates(
                t, ids, upd, cnt, jnp.float32(1e-3 + i * 1e-9)
            )
        return t

    out = chain(table, 1)
    np.asarray(out[:1])
    out = chain(out, 5)
    np.asarray(out[:1])
    arm = {}
    for reps in (1, 5):
        a_best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = chain(out, reps)
            np.asarray(out[:1])
            a_best = min(a_best, time.perf_counter() - t0)
        arm[reps] = a_best
    best_a = (arm[5] - arm[1]) / 4
    print(
        f"applier alone ({r} rows into [{n}, 128]): {best_a * 1e3:.1f} ms"
        " (slope-timed)",
        file=sys.stderr,
    )
    print(
        f'{{"metric": "sgns_tokens_per_sec", "value": {tokens / best}, '
        f'"unit": "tokens/s"}}'
    )


if __name__ == "__main__":
    main()
