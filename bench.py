#!/usr/bin/env python
"""Headline benchmark: 2nd-order biased walk throughput, 1M-node sparse graph.

Prints ONE JSON line:
    {"metric": "walk_steps_per_sec", "value": ..., "unit": "steps/s",
     "vs_baseline": ...}

``value`` is walker-steps/second of the device walk engine (SparseOTF
semantics, weighted, p=0.5 q=2) on a synthetic 1M-node graph with mean
degree ~16 (the BASELINE.md workload shape). ``vs_baseline`` compares
against a compiled scalar CPU walker with the identical transition math
(``native/refwalker.cpp``, -O3, all host threads) — the closest
available stand-in for PecanPy's Numba walk loop, which cannot run here
(no numba in the image); both JIT the same scalar per-step loop to
machine code. A vectorized-numpy fallback baseline runs when the
native toolchain is missing.
"""
import json
import os
import sys
import time

import numpy as np


def build_graph(n, avg_deg, seed=0):
    """Random undirected weighted graph as a CSR triple."""
    rng = np.random.default_rng(seed)
    m = n * avg_deg // 2
    src = rng.integers(0, n, m, dtype=np.int64)
    dst = rng.integers(0, n, m, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    code = np.unique(u * n + v)
    u, v = code // n, code % n
    # symmetric deterministic weights
    lo, hi = np.minimum(u, v), np.maximum(u, v)
    w = (((lo * 2654435761 + hi) % 1000) / 1000.0 * 1.5 + 0.5).astype(np.float32)
    order = np.lexsort((v, u))
    u, v, w = u[order], v[order], w[order]
    deg = np.bincount(u, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    return indptr, v, w


def _batch_searchsorted(a, v):
    """Row-wise searchsorted on equal-width sorted rows (vectorized)."""
    b, d = a.shape
    lo = np.zeros(v.shape, dtype=np.int64)
    hi = np.full(v.shape, d, dtype=np.int64)
    steps = int(np.ceil(np.log2(d))) + 1
    for _ in range(steps):
        mid = (lo + hi) // 2
        mid_val = np.take_along_axis(a, np.minimum(mid, d - 1), 1)
        go_right = mid_val < v
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(go_right, hi, mid)
    return lo


def cpu_reference_steps_per_sec(nbr, wgt, deg, starts, n_steps, p, q):
    """Vectorized-numpy walker with identical transition math (baseline)."""
    rng = np.random.default_rng(1)
    b, d = starts.size, nbr.shape[1]
    cur = starts.copy()
    rows_w = wgt[cur]
    cdf = np.cumsum(rows_w, axis=1)
    u = rng.random((b, 1)) * cdf[:, -1:]
    choice = np.minimum((cdf < u).sum(1), d - 1)
    prev = cur
    cur = nbr[cur, choice]

    t0 = time.perf_counter()
    for _ in range(n_steps):
        cur_nbr = nbr[cur]
        w = wgt[cur].copy()
        prev_nbr = nbr[prev]
        # membership of cur's candidates in prev's sorted row
        pos = np.minimum(_batch_searchsorted(prev_nbr, cur_nbr), d - 1)
        found = np.take_along_axis(prev_nbr, pos, 1) == cur_nbr
        is_prev = cur_nbr == prev[:, None]
        w *= np.where(~found & ~is_prev, 1.0 / q, 1.0)
        w *= np.where(is_prev, 1.0 / p, 1.0)
        cdf = np.cumsum(w, axis=1)
        u = rng.random((b, 1)) * cdf[:, -1:]
        choice = np.minimum((cdf < u).sum(1), d - 1)
        nxt = np.take_along_axis(cur_nbr, choice[:, None], 1)[:, 0]
        alive = deg[cur] > 0
        prev, cur = cur, np.where(alive, nxt, cur)
    dt = time.perf_counter() - t0
    # nominal step count (dead walkers keep "stepping"): on sink-heavy
    # inputs this OVERSTATES the CPU rate, i.e. is conservative for
    # vs_baseline. The device and native-walker rates use effective steps.
    return b * n_steps / dt


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; found {dev.platform!r}")

    from pecanpy_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from pecanpy_tpu.models import engine
    from pecanpy_tpu.ops import sampling, transition
    from pecanpy_tpu.ops.layout import build_device_csr

    n = int(os.environ.get("BENCH_NODES", 1_000_000))
    avg_deg = 16
    p, q = 0.5, 2.0
    walkers = int(os.environ.get("BENCH_WALKERS", 131_072))
    walk_length = 80

    print(f"building {n}-node graph...", file=sys.stderr)
    indptr, indices, data = build_graph(n, avg_deg)
    graph = build_device_csr(indptr, indices, data)
    # run() below compiles the fused-only step: hub marker rows would be
    # mis-read as neighbor lists (the power-law bench covers the hub path)
    assert not graph.has_hubs, "bench graph must fit the fused layout"
    print(
        f"graph: {int(indptr[-1])} directed edges, max degree "
        f"{graph.max_degree}, device {jax.devices()[0].platform}",
        file=sys.stderr,
    )

    @jax.jit
    def run(g, starts, key):
        # graph passed as an argument (closing over it would bake the
        # arrays into the program as constants)
        def first_fn(k, cur, cur_rows):
            w = transition.first_order_weights_rows(g, cur_rows)
            c = sampling.categorical_rows(k, w)
            return sampling.pick_int_columns(g.rows_nbr(cur_rows), c)

        def step_fn(k, cur, prev, cur_rows, prev_rows):
            w = transition.node2vec_weights_rows(
                g, cur_rows, prev_rows, prev, p, q
            )
            c = sampling.categorical_rows(k, w)
            return sampling.pick_int_columns(g.rows_nbr(cur_rows), c)

        return engine.generate_walks(
            g, first_fn, step_fn, starts, key, walk_length
        )

    rng = np.random.default_rng(0)
    starts = jnp.asarray(rng.integers(0, n, walkers, dtype=np.int32))
    key = jax.random.PRNGKey(0)

    np.asarray(run(graph, starts, key)[1])  # warmup / compile
    # device steps are EFFECTIVE (eff_len sum minus the start tokens) —
    # the same convention as the CPU baseline below, so vs_baseline does
    # not credit the device for padded resting steps on sink-heavy inputs
    rates = []
    for i in range(3):
        t0 = time.perf_counter()
        eff = np.asarray(run(graph, starts, jax.random.fold_in(key, i))[1])
        dt = time.perf_counter() - t0
        rates.append(float(eff.sum() - walkers) / dt)
    device_sps = max(rates)
    print(f"device: {device_sps:.3e} steps/s (best of 3)", file=sys.stderr)

    # CPU baseline on the same graph, scaled-down batch (host arrays —
    # never transfer the padded layout back over the device link).
    # Preferred: the compiled scalar walker (PecanPy's execution shape,
    # all host threads); fallback: the vectorized-numpy reference.
    from pecanpy_tpu.native.loader import (
        native_available,
        walk_node2vec_native,
    )

    if native_available():
        cpu_threads = os.cpu_count() or 1
        # scale the workload with the thread count so per-call thread
        # spawn/join (no persistent pool) stays negligible in the
        # timed region on many-core hosts
        cpu_walks = max(2048, 1024 * cpu_threads)
        cpu_starts = rng.integers(0, n, cpu_walks, dtype=np.int32)
        # dtype conversions happen OUTSIDE the timed region (the int64 ->
        # int32 copy of a 16M-entry indices array would otherwise
        # dominate the measurement)
        indptr64 = np.ascontiguousarray(indptr, dtype=np.int64)
        indices32 = np.ascontiguousarray(indices, dtype=np.int32)
        data32 = np.ascontiguousarray(data, dtype=np.float32)
        walk_node2vec_native(  # warm the thread pool / page the arrays
            indptr64, indices32, data32, cpu_starts[:64], walk_length,
            p, q, seed=1, workers=cpu_threads,
        )
        t0 = time.perf_counter()
        _, eff = walk_node2vec_native(
            indptr64, indices32, data32, cpu_starts, walk_length, p, q,
            seed=1, workers=cpu_threads,
        )
        cpu_sps = float(eff.sum() - cpu_walks) / (time.perf_counter() - t0)
        print(
            f"cpu baseline (compiled scalar walker, {cpu_threads} "
            f"thread(s)): {cpu_sps:.3e} steps/s",
            file=sys.stderr,
        )
    else:
        from pecanpy_tpu.ops.layout import build_padded_host

        nbr_host, wgt_host, deg_host, _, _ = build_padded_host(
            indptr, indices, data
        )
        cpu_starts = rng.integers(0, n, 8192, dtype=np.int64)
        cpu_sps = cpu_reference_steps_per_sec(
            nbr_host, wgt_host, deg_host, cpu_starts, 8, p, q
        )
        print(
            f"cpu baseline (vectorized numpy): {cpu_sps:.3e} steps/s",
            file=sys.stderr,
        )

    print(
        json.dumps(
            {
                "metric": "walk_steps_per_sec",
                "value": device_sps,
                "unit": "steps/s",
                "vs_baseline": device_sps / cpu_sps,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
