#!/usr/bin/env python
"""Edge-partitioned exchange comparison on the virtual CPU mesh.

Compares the two collective row-fetch strategies of
``parallel/distgraph.py`` — "fetch by all-reduce" (psum) vs
request/response (alltoall) — at 8 and 16 shards, reporting measured
wall time AND the modeled per-fetch collective bytes
(``exchange_cost_model``).

CAVEAT: the walls here are CPU collectives — memcpys through host
memory, whose relative costs do not transfer to the devices'
interconnect. The byte model is the interconnect-relevant comparison;
the CPU walls only sanity-check that the a2a machinery (rank
computation, retry loop) does not swamp its own savings.

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=16 \
     python benchmarks/bench_exchange.py
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=16"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    from pecanpy_tpu.ops.layout import build_device_csr
    from pecanpy_tpu.parallel import mesh as mesh_lib
    from pecanpy_tpu.parallel.distgraph import (
        exchange_cost_model,
        simulate_walks_distributed,
    )

    n = 50_000
    rng = np.random.default_rng(0)
    deg = 8
    dst = rng.integers(0, n, (n, deg))
    src = np.repeat(np.arange(n), deg)
    dst = dst.reshape(-1)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    code = np.unique(u.astype(np.int64) * n + v)
    u, v = code // n, code % n
    w = rng.uniform(0.5, 2.0, u.size).astype(np.float32)
    order = np.lexsort((v, u))
    u, v, w = u[order], v[order], w[order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(u, minlength=n))])
    graph = build_device_csr(indptr, v, w, degree_cap=None)

    walkers = 16_384
    walk_length = 16
    starts = rng.integers(0, n, walkers, dtype=np.int32)

    n_dev = len(jax.devices())
    for shards in (8, 16):
        if shards > n_dev:
            print(f"skip {shards} shards ({n_dev} devices)", file=sys.stderr)
            continue
        mesh = mesh_lib.make_mesh(shards)
        model = exchange_cost_model(
            walkers // shards, shards, graph.fused.shape[1]
        )
        for exchange in ("psum", "alltoall"):
            t_best = float("inf")
            for rep in range(3):
                t0 = time.perf_counter()
                _, eff = simulate_walks_distributed(
                    graph, mesh, starts, walk_length, p=0.5, q=2.0,
                    seed=rep, exchange=exchange,
                )
                np.asarray(eff)
                t_best = min(t_best, time.perf_counter() - t0)
            bytes_key = "psum_bytes" if exchange == "psum" else "a2a_bytes"
            print(
                f"shards={shards:2d} {exchange:8s}: {t_best:6.2f} s wall "
                f"(CPU mesh), modeled {model[bytes_key] / 1e6:8.2f} MB "
                f"per fetch per shard",
                flush=True,
            )
        print(
            f"shards={shards:2d} auto pick: {model['pick']} "
            f"(psum/a2a byte ratio "
            f"{model['psum_bytes'] / model['a2a_bytes']:.1f}x)",
            flush=True,
        )


if __name__ == "__main__":
    main()
