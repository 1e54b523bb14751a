#!/usr/bin/env python
"""On-card smoke check: the walk + SGNS pipeline on one NVIDIA GPU.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py           # every single-card phase
    python chip_smoke.py --four    # only the 4-card mesh path

One process, the only one that opens the card: the CLI runs in-process
through ``pecanpy_tpu.cli.main``. Each phase prints its own lines; any
failed check raises, so the process exits non-zero and never prints the
final ``{"ok": true, ...}`` line. With no GPU it fails at the first
phase. Every line that carries a number ends with the card's name and
power limit as ``nvidia-smi`` reports them.

Phases (single card):
 1. device: platform, kind, count, ``nvidia-smi`` name and power limit;
 2. kernels against plain references at real widths: the node2vec
    transition weights against the numpy oracle (``tests/oracle.py``),
    the SGNS update applier and one SGNS step against the same call on
    the CPU device, plus ``memory_analysis()`` of the walk step and the
    SGNS span step, and steady-state walk and SGNS rates;
 3. end to end through the CLI on a 1M-node weighted graph, then
    ``SparseOTF.embed`` on a 1M-node power-law graph (the hub path);
 4. every walk mode with ``extend=True``, checking edge validity;
 5. quality: micro-F1 on the BlogCatalog-shaped overlapping SBM;
 6. reproducibility: the end-to-end embed again, byte-identical; and
    streaming == stored walks, resumed == uninterrupted training.
"""
import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD = "no card"  # "<name>, <power limit>" once phase 1 has run
P, Q = 0.5, 2.0
WALK_LEN = 80
# sizes: the published widths; a CPU rehearsal may shrink the counts
N_GRAPH = 1_000_000  # nodes of the uniform and power-law graphs
HUB_MIN = 100_000  # the power-law graph's max degree must reach this
N_MODES = 100_000  # nodes of the all-modes graph
N_DENSE = 4096  # nodes of the DenseOTF graph
N_SBM = 10_312  # BlogCatalog's node count
BATCH = 131072  # walkers of one fused walk dispatch
_COMPILE_S = [0.0]


class SmokeFailure(AssertionError):
    """A check failed on the card."""


def say(msg: str) -> None:
    print(f"{msg}  [{CARD}]", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    say(f"  ok: {what}")


def run_cli(argv) -> None:
    """``cli.main`` in-process; its own output lines (timings) are
    re-printed with the card label like every other line."""
    from pecanpy_tpu import cli

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
    finally:
        for line in buf.getvalue().splitlines():
            say(f"  cli: {line}")


def _on_path(path: str) -> None:
    if path not in sys.path:
        sys.path.insert(0, path)


# -- graphs (generated from a seed; no download) -------------------------


def uniform_graph(n: int, avg_deg: int = 16, seed: int = 0):
    """The weighted, mean-degree-16 graph of ``bench.py`` (CSR triple)."""
    _on_path(ROOT)
    from bench import build_graph

    return build_graph(n, avg_deg, seed=seed)


def powerlaw_graph(n: int, exponent: float = 2.2, seed: int = 0):
    """The Chung-Lu graph of ``benchmarks/bench_powerlaw.py``."""
    _on_path(os.path.join(ROOT, "benchmarks"))
    from bench_powerlaw import build_powerlaw_graph

    return build_powerlaw_graph(n, exponent=exponent, seed=seed)


def bad_steps(indptr, indices, walks, eff) -> int:
    """Consecutive walk pairs (within each effective length) that are not
    edges of the CSR graph (rows sorted ascending)."""
    walks = np.asarray(walks, dtype=np.int64)
    eff = np.asarray(eff)
    n = indptr.size - 1
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    edge_keys = src * n + np.asarray(indices, dtype=np.int64)
    a, b = walks[:, :-1], walks[:, 1:]
    valid = np.arange(1, walks.shape[1])[None, :] < eff[:, None]
    keys = (a * n + b)[valid]
    pos = np.minimum(np.searchsorted(edge_keys, keys), edge_keys.size - 1)
    return int(np.sum(edge_keys[pos] != keys))


def mode_from_csr(mode_cls, indptr, indices, data, **kw):
    """A walk-mode instance holding a CSR graph with implicit node IDs."""
    g = mode_cls(**kw)
    g.indptr = np.asarray(indptr, dtype=np.uint32)
    g.indices = np.asarray(indices, dtype=np.uint32)
    g.data = np.asarray(data, dtype=np.float32)
    g.set_node_ids(None, implicit_ids=True, num_nodes=indptr.size - 1)
    return g


# -- measurement helpers --------------------------------------------------


def _count_compile(event, duration, **_):
    if event == "/jax/core/compile/backend_compile_duration":
        _COMPILE_S[0] += duration


def peak_gib(dev) -> float:
    return dev.memory_stats()["peak_bytes_in_use"] / 2**30


def timed(fn, *args, **kw):
    """(result, wall seconds, backend compile seconds inside the call);
    the wall includes waiting for the device to finish."""
    import jax

    c0 = _COMPILE_S[0]
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kw))
    return out, time.perf_counter() - t0, _COMPILE_S[0] - c0


def print_memory(name, compiled) -> None:
    ma = compiled.memory_analysis()
    say(
        f"  memory_analysis[{name}]: args "
        f"{ma.argument_size_in_bytes / 2**20:.1f} MiB, outputs "
        f"{ma.output_size_in_bytes / 2**20:.1f} MiB, temp "
        f"{ma.temp_size_in_bytes / 2**20:.1f} MiB, code "
        f"{ma.generated_code_size_in_bytes / 2**20:.2f} MiB"
    )


# -- phases ---------------------------------------------------------------


def phase_device():
    global CARD
    import jax

    devs = jax.devices()
    dev = devs[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    CARD = smi[0].strip()
    say("phase 1: device")
    say(
        f"  jax platform={dev.platform} kind={dev.device_kind} "
        f"count={len(devs)} jax={jax.__version__}"
    )
    check(dev.platform == "gpu", "the default JAX device is a GPU")
    return dev


def phase_kernels(dev):
    import jax
    import jax.numpy as jnp

    _on_path(os.path.join(ROOT, "tests"))
    import oracle
    from pecanpy_tpu.models import engine, sgns
    from pecanpy_tpu.ops import apply, sampling, transition
    from pecanpy_tpu.ops.layout import build_device_csr

    say("phase 2: kernels against plain references")
    cpu = jax.devices("cpu")[0]
    n = N_GRAPH
    indptr, indices, data = uniform_graph(n)
    dg = build_device_csr(indptr, indices, data)
    check(dg.dpad == 64 and not dg.has_hubs, f"{n}-node graph, dpad {dg.dpad}")

    # transition weights + membership, 131072 walkers, vs the oracle
    b = BATCH
    rng = np.random.default_rng(1)
    deg = np.diff(indptr)
    cur = rng.choice(np.nonzero(deg)[0], b).astype(np.int32)
    prev = indices[indptr[cur] + rng.integers(0, deg[cur])].astype(np.int32)

    @jax.jit
    def weights(g, cur, prev):
        cr, pr = g.gather_rows(cur), g.gather_rows(prev)
        d = transition._active_width(g)
        found, _ = transition._locate_in_prev(
            g.rows_nbr(cr)[:, :d], g.rows_nbr(pr)[:, :d]
        )
        return found, transition.node2vec_weights_rows(g, cr, pr, prev, P, Q)

    found, w = jax.device_get(weights(dg, jnp.asarray(cur), jnp.asarray(prev)))
    worst, mask_bad = 0.0, 0
    for i in range(b):
        k = deg[cur[i]]
        want_found, want_p = oracle.node2vec_probs_csr(
            indptr, indices, data, cur[i], prev[i], P, Q
        )
        mask_bad += int(np.any(found[i, :k] != want_found))
        got = w[i, :k] / w[i, :k].sum()
        worst = max(worst, float(np.max(np.abs(got - want_p) / want_p)))
    say(f"  transition: {b} (cur, prev) pairs, max rel err {worst:.2e}")
    check(mask_bad == 0, "membership masks equal the oracle's exactly")
    check(worst <= 1e-5, "normalized weights within rtol 1e-5 (f32 vs f64)")

    # the update applier at [1M, 128] with one SGNS step's W_out streams
    config = sgns.SGNSConfig(dim=128, window=10, negative=5, seed=0)
    chunk = sgns.resolve_batch_walks(config, n, WALK_LEN + 1)
    r_a, r_b = chunk * (WALK_LEN + 1), config.neg_pool
    table = rng.uniform(-0.004, 0.004, (n, 128)).astype(np.float32)
    stream = dict(
        ids_a=rng.integers(0, n, r_a).astype(np.int32),
        upd_a=(rng.standard_normal((r_a, 128)) * 0.01).astype(np.float32),
        cnt_a=rng.integers(0, 21, r_a).astype(np.float32),
        ids_b=rng.integers(0, n, r_b).astype(np.int32),
        upd_b=(rng.standard_normal((r_b, 128)) * 0.01).astype(np.float32),
        cnt_b=rng.integers(0, 50, r_b).astype(np.float32),
        lr=np.float32(0.025),
    )

    def run_apply(device):
        put = {k: jax.device_put(v, device) for k, v in stream.items()}
        out = apply.apply_mean_updates_two(
            jax.device_put(table, device), cap_a=20.0, cap_b=20.0, **put
        )
        return np.asarray(out)

    (got, t_gpu, c_gpu) = timed(run_apply, dev)
    again = run_apply(dev)
    want = run_apply(cpu)
    delta = np.abs(want - table).max()
    err = np.abs(got - want).max()
    say(
        f"  applier: streams {r_a} + {r_b} rows into [{n}, 128]; max |gpu - "
        f"cpu| {err:.2e} vs max update {delta:.2e}; bit-identical to cpu: "
        f"{bool(np.array_equal(got, want))}"
    )
    check(err <= 1e-5 * delta, "applier within 1e-5 of the largest update")
    check(np.array_equal(got, again), "applier repeat call bit-identical")

    # one SGNS step at dim 128, window 10, 5 negatives: GPU vs CPU
    walks = rng.integers(0, n, (chunk, WALK_LEN + 1)).astype(np.int32)
    args = dict(
        w_in=rng.uniform(-0.004, 0.004, (n, 128)).astype(np.float32),
        w_out=(rng.standard_normal((n, 128)) * 0.01).astype(np.float32),
        walks=walks,
        eff_len=np.full(chunk, WALK_LEN + 1, np.int32),
        keep_prob=rng.uniform(0.5, 1.0, n).astype(np.float32),
        neg_table=rng.integers(0, n, 1 << 20).astype(np.int32),
        lr=np.float32(0.025),
        key=np.asarray(jax.random.PRNGKey(3)),
    )
    body = sgns.make_step_body(n, config)

    def run_step(device):
        a = {k: jax.device_put(v, device) for k, v in args.items()}
        out = jax.jit(body)(**a)
        return [np.asarray(x) for x in out]

    step_gpu, step_cpu = run_step(dev), run_step(cpu)
    for name, g_, c_, w0 in zip(
        ("w_in", "w_out"), step_gpu, step_cpu, (args["w_in"], args["w_out"])
    ):
        upd = np.abs(c_ - w0).max()
        err = np.abs(g_ - c_).max()
        say(f"  sgns step {name}: max |gpu - cpu| {err:.2e} vs max update "
            f"{upd:.2e}")
        check(err <= 1e-4 * upd, f"sgns {name} within 1e-4 of largest update")

    # compiled memory + steady rates: the fused walk step, the span step
    def walk(g, starts, key):
        def first_fn(k, c, rows):
            wts = transition.first_order_weights_rows(g, rows)
            return sampling.pick_int_columns(
                g.rows_nbr(rows), sampling.categorical_rows(k, wts)
            )

        def step_fn(k, c, p_, cr, pr):
            wts = transition.node2vec_weights_rows(g, cr, pr, p_, P, Q)
            return sampling.pick_int_columns(
                g.rows_nbr(cr), sampling.categorical_rows(k, wts)
            )

        return engine.generate_walks(
            g, first_fn, step_fn, starts, key, WALK_LEN
        )

    starts = jnp.asarray(rng.integers(0, n, b).astype(np.int32))
    walk_c = jax.jit(walk).lower(dg, starts, jax.random.PRNGKey(0)).compile()
    print_memory(f"walk step, {b} walkers x {WALK_LEN}", walk_c)
    walk_c(dg, starts, jax.random.PRNGKey(0))[1].block_until_ready()
    t0 = time.perf_counter()
    wk, ef = walk_c(dg, starts, jax.random.PRNGKey(1))
    ef = np.asarray(ef)
    t_walk = time.perf_counter() - t0
    say(f"  walk rate: {(ef.sum() - b) / t_walk:.4e} steps/s "
        f"({b} walkers x {WALK_LEN} steps, {t_walk * 1e3:.1f} ms)")
    check(bad_steps(indptr, indices, np.asarray(wk)[:4096], ef[:4096]) == 0,
          "walk-step sample follows graph edges")

    n_chunks = 8
    span = sgns._make_span_step(n, config, chunk)
    w_in0, w_out0 = sgns._alloc_tables(jax.random.PRNGKey(0), n, 128,
                                       jnp.float32)
    span_args = (
        jnp.asarray(np.asarray(wk)[: n_chunks * chunk]),
        jnp.asarray(ef[: n_chunks * chunk]),
        jnp.ones(n, jnp.float32),
        jnp.asarray(args["neg_table"]),
        jnp.full((n_chunks,), 0.025, jnp.float32),
        jax.random.PRNGKey(0), 0, n_chunks, 0,
    )
    span_c = span.lower(w_in0, w_out0, *span_args).compile()
    print_memory(f"SGNS span step, {n_chunks} x {chunk} walks", span_c)
    w_in0, w_out0 = span_c(w_in0, w_out0, *span_args)
    w_in0.block_until_ready()
    t0 = time.perf_counter()
    w_in0, w_out0 = span_c(w_in0, w_out0, *span_args)
    w_in0.block_until_ready()
    t_span = time.perf_counter() - t0
    tokens = n_chunks * chunk * (WALK_LEN + 1)
    say(f"  sgns rate: {tokens / t_span:.4e} tokens/s ({n_chunks} chunk-steps"
        f" of {chunk} walks, {t_span / n_chunks * 1e3:.2f} ms each)")
    say(f"  applier call (incl. transfer, first call): {t_gpu:.2f} s, "
        f"compile {c_gpu:.2f} s; peak {peak_gib(dev):.2f} GiB")
    return indptr, indices, data


def phase_e2e(dev, work, graph_csr):
    from pecanpy_tpu import pecanpy

    say("phase 3: end to end at full width")
    indptr, indices, data = graph_csr
    path = os.path.join(work, "uniform_1m.csr.npz")
    np.savez(path, indptr=indptr, indices=indices, data=data)
    argv = [
        "--input", path, "--weighted", "--implicit_ids",
        "--mode", "SparseOTF", "--p", "0.5", "--q", "2",
        "--dimensions", "128", "--walk-length", "80", "--num-walks", "10",
        "--window-size", "10", "--max-steps", "8", "--random_state", "0",
    ]
    out = os.path.join(work, "uniform_1m.emb.npz")
    _, wall, comp = timed(run_cli, argv + ["--output", out])
    emb = np.load(out)["data"]
    say(f"  cli uniform {N_GRAPH}: wall {wall:.2f} s, compile {comp:.2f} s, "
        f"peak {peak_gib(dev):.2f} GiB, output {emb.shape}")
    check(emb.shape == (indptr.size - 1, 128) and np.isfinite(emb).all(),
          "one finite 128-wide row per node")

    # the hub path: 1M-node Chung-Lu graph, queued rejection engine
    pl = powerlaw_graph(N_GRAPH)
    deg = np.diff(pl[0])
    say(f"  power-law graph: {int(pl[0][-1])} arcs, max degree {deg.max()}")
    check(deg.max() >= HUB_MIN, f"hubs of degree {HUB_MIN}+")
    g = mode_from_csr(pecanpy.SparseOTF, *pl, p=P, q=Q, random_state=0)
    (wk, ef), wall, comp = timed(g.simulate_walks_device, 1, WALK_LEN)
    ef = np.asarray(ef)
    say(f"  power-law walks, first call: wall {wall:.2f} s, compile "
        f"{comp:.2f} s")
    check(g.get_device_graph().has_hubs, "hub structures in use")
    (wk, ef), wall, _ = timed(g.simulate_walks_device, 1, WALK_LEN)
    ef = np.asarray(ef)
    say(f"  power-law walk rate: {(ef.sum() - ef.size) / wall:.4e} steps/s "
        f"({ef.size} walks)")
    check(bad_steps(pl[0], pl[1], np.asarray(wk[:8192]), ef[:8192]) == 0,
          "power-law walk sample follows graph edges")
    emb, wall, comp = timed(
        g.embed, dim=128, num_walks=2, walk_length=WALK_LEN,
        window_size=10, max_steps=4,
    )
    say(f"  power-law embed: wall {wall:.2f} s, compile {comp:.2f} s, "
        f"peak {peak_gib(dev):.2f} GiB")
    check(emb.shape == (N_GRAPH, 128) and np.isfinite(emb).all(),
          "power-law embedding finite")
    return argv, out


def phase_modes(dev):
    from pecanpy_tpu import pecanpy

    _on_path(os.path.join(ROOT, "tests"))
    import oracle

    say("phase 4: all modes, extend=True")
    indptr, indices, data = uniform_graph(N_MODES, seed=2)
    ones = np.ones_like(data)
    rng = np.random.default_rng(5)
    adj = oracle.random_graph(rng, N_DENSE, mean_degree=16.0)
    rows, cols = np.nonzero(adj)
    d_indptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                          minlength=N_DENSE))])
    cases = [
        ("PreComp", mode_from_csr, (indptr, indices, data), P, Q, 1),
        ("PreCompFirstOrder", mode_from_csr, (indptr, indices, data),
         1, 1, 1),
        ("FirstOrderUnweighted", mode_from_csr, (indptr, indices, ones),
         1, 1, 1),
        ("SparseOTF", mode_from_csr, (indptr, indices, data), P, Q, 1),
        ("DenseOTF", None, (d_indptr, cols, None), P, Q, 24),
    ]
    for name, build, csr, p, q, walks_per_node in cases:
        cls = getattr(pecanpy, name)
        kw = dict(p=p, q=q, extend=True, random_state=0, walker_batch=32768)
        if build is None:
            g = cls.from_mat(adj, [str(i) for i in range(N_DENSE)], **kw)
        else:
            g = build(cls, *csr, **kw)
        (wk, ef), wall, comp = timed(
            g.simulate_walks_device, walks_per_node, WALK_LEN
        )
        wk, ef = np.asarray(wk), np.asarray(ef)
        batches = -(-wk.shape[0] // 32768)
        say(f"  {name}: {wk.shape[0]} walks in {batches} batches, wall "
            f"{wall:.2f} s, compile {comp:.2f} s")
        check(bad_steps(csr[0], csr[1], wk, ef) == 0,
              f"{name} walks follow graph edges")


def phase_quality(dev):
    from pecanpy_tpu import pecanpy
    from pecanpy_tpu.utils import evaluate

    say("phase 5: quality (BlogCatalog-shaped SBM, epochs=2)")
    indptr, indices, data, labels = evaluate.overlapping_sbm(
        n=N_SBM, n_communities=39, mean_degree=64.0, seed=1
    )
    g = mode_from_csr(pecanpy.SparseOTF, indptr, indices, data,
                      random_state=0)
    emb, wall, comp = timed(
        g.embed, dim=128, num_walks=10, walk_length=WALK_LEN,
        window_size=10, epochs=2,
    )
    f1 = evaluate.multilabel_node_classification(emb, labels, seed=0)
    rand = evaluate.multilabel_node_classification(
        np.random.default_rng(9).standard_normal(emb.shape).astype(
            np.float32), labels, seed=0,
    )
    say(f"  micro-F1 {f1:.4f} (random-embedding floor {rand:.4f}); embed "
        f"wall {wall:.2f} s, compile {comp:.2f} s")
    check(f1 > max(0.5, rand + 0.2), "micro-F1 > max(0.5, random + 0.2)")


def phase_repro(dev, work, argv, first_out):
    from pecanpy_tpu import pecanpy

    _on_path(os.path.join(ROOT, "tests"))
    import oracle

    say("phase 6: reproducibility")
    out = os.path.join(work, "uniform_1m_again.emb.npz")
    _, wall, comp = timed(run_cli, argv + ["--output", out])
    a, b = np.load(first_out)["data"], np.load(out)["data"]
    digest = hashlib.sha256(a.tobytes()).hexdigest()[:16]
    say(f"  rerun wall {wall:.2f} s, compile {comp:.2f} s; sha256 {digest}")
    check(a.tobytes() == b.tobytes(), "same seed: byte-identical embeddings")

    adj = oracle.random_graph(np.random.default_rng(7), 400, 8.0)
    ids = [str(i) for i in range(400)]
    kw = dict(dim=32, num_walks=6, walk_length=20, window_size=4, epochs=2)

    def embed(**extra):
        g = pecanpy.SparseOTF.from_mat(adj, ids, p=P, q=Q, random_state=3)
        return g.embed(**kw, **extra)

    stored, streamed = embed(streaming=False), embed(streaming=True)
    check(stored.tobytes() == streamed.tobytes(),
          "streaming == stored walks, byte for byte")
    ck = os.path.join(work, "ckpt")
    embed(streaming=False, checkpoint_dir=ck, checkpoint_every=1,
          max_steps=2)
    resumed = embed(streaming=False, checkpoint_dir=ck, checkpoint_every=1)
    check(resumed.tobytes() == stored.tobytes(),
          "resumed == uninterrupted, byte for byte")


def phase_four(dev):
    import jax

    from pecanpy_tpu import pecanpy
    from pecanpy_tpu.ops.layout import build_device_csr
    from pecanpy_tpu.parallel import mesh as mesh_lib
    from pecanpy_tpu.parallel.distgraph import simulate_walks_distributed

    say("phase 4x: the mesh path on four cards")
    check(len(jax.devices()) == 4, "four GPUs visible")
    indptr, indices, data = uniform_graph(N_GRAPH)
    kw = dict(dim=128, num_walks=1, walk_length=WALK_LEN, window_size=10,
              max_steps=3, n_devices=4)

    def embed(**extra):
        g = mode_from_csr(pecanpy.SparseOTF, indptr, indices, data,
                          p=P, q=Q, random_state=0)
        return timed(g.embed, **kw, **extra)

    rep, wall, comp = embed(partition="replicated")
    say(f"  replicated: wall {wall:.2f} s, compile {comp:.2f} s")
    edge, wall, comp = embed(partition="edge")
    say(f"  edge: wall {wall:.2f} s, compile {comp:.2f} s")
    check(np.isfinite(rep).all() and rep.shape == (N_GRAPH, 128),
          "replicated embedding finite")
    check(rep.tobytes() == edge.tobytes(),
          "replicated and edge layouts train bit-identical tables")
    mp, wall, comp = embed(partition="replicated", model_parallel=2)
    say(f"  model_parallel=2: wall {wall:.2f} s, compile {comp:.2f} s")
    check(np.isfinite(mp).all() and mp.shape == (N_GRAPH, 128),
          "model_parallel=2 embedding finite")

    dg = build_device_csr(indptr, indices, data)
    mesh = mesh_lib.make_mesh(4)
    starts = np.random.default_rng(0).integers(0, N_GRAPH, BATCH)
    for exchange in ("psum", "alltoall"):
        (wk, ef), wall, comp = timed(
            simulate_walks_distributed, dg, mesh, starts, WALK_LEN, P, Q,
            seed=0, exchange=exchange,
        )
        wk, ef = np.asarray(wk), np.asarray(ef)
        say(f"  distributed walks ({exchange}): wall {wall:.2f} s, compile "
            f"{comp:.2f} s")
        check(bad_steps(indptr, indices, wk, ef) == 0,
              f"{exchange} walks follow graph edges")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-card mesh path")
    args = parser.parse_args(argv)
    # the card first, the CPU beside it for the reference comparisons
    os.environ["JAX_PLATFORMS"] = "cuda,cpu"
    import jax
    from jax import monitoring

    import pecanpy_tpu  # noqa: F401  (fail before touching the card)

    monitoring.register_event_duration_secs_listener(_count_compile)
    dev = phase_device()
    if args.four:
        phase_four(dev)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            csr = phase_kernels(dev)
            argv_e2e, out = phase_e2e(dev, work, csr)
            phase_modes(dev)
            phase_quality(dev)
            phase_repro(dev, work, argv_e2e, out)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
