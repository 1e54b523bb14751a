#!/usr/bin/env python
"""Downstream quality at BlogCatalog scale, REAL protocol.

Builds an overlapping-community SBM with BlogCatalog's shape (10,312
nodes, 39 labels, ~334k edges; nodes carry 1-3 labels), embeds with the
default node2vec pipeline, and scores with the published protocol:
multi-label one-vs-rest logistic regression, top-k prediction, micro-F1
(node2vec paper §4.3). Also reports the random-embedding floor so the
number is interpretable.

``--trainer sequential`` scores the native SEQUENTIAL trainer
(``native/seqsgns.cpp`` — gensim's exact loop: per-pair immediate
updates, reduced windows, subsampling, collision skip) on the SAME
device-generated walks: the head-to-head that settles whether the
device trainer's capped-sum batching loses quality vs sequential SGD.

Run: python benchmarks/bench_quality.py [n_nodes] [--trainer sequential]
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")  # run as: python benchmarks/bench_quality.py


def embed_sequential(
    g, dim, num_walks, walk_length, window, epochs, seed, workers=1
):
    """Walks on device, SGNS on host with gensim's sequential loop.

    ``workers=1`` is the strictly-sequential evidence baseline;
    ``workers>1`` measures the hogwild production path
    (``embed(trainer="sequential")``).
    """
    from pecanpy_tpu.models import sgns

    t0 = time.perf_counter()
    walks, eff = g.simulate_walks_device(num_walks, walk_length)
    walks, eff = np.asarray(walks), np.asarray(eff)
    print(f"walks: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    config = sgns.SGNSConfig(dim=dim, window=window, epochs=epochs, seed=seed)
    emb = sgns.train_sequential(
        walks, eff, g.num_nodes, config, workers=workers, verbose=True
    )
    print(
        f"sequential train ({workers} thread(s)): "
        f"{time.perf_counter() - t0:.1f}s",
        file=sys.stderr,
    )
    return emb


def main():
    sys.path.insert(0, ".")
    from pecanpy_tpu import pecanpy
    from pecanpy_tpu.graph import SparseGraph
    from pecanpy_tpu.utils import evaluate

    args = sys.argv[1:]
    sequential = "--trainer" in args and "sequential" in args
    workers = 1
    if "--workers" in args:
        i = args.index("--workers")
        if i + 1 >= len(args):
            sys.exit("--workers needs a value")
        workers = int(args[i + 1])
    pos = [
        a
        for i, a in enumerate(args)
        if not a.startswith("-")
        and (i == 0 or args[i - 1] not in ("--trainer", "--workers"))
    ]
    n = int(pos[0]) if pos else 10_312
    c = 39
    t0 = time.perf_counter()
    indptr, indices, data, labels = evaluate.overlapping_sbm(
        n=n, n_communities=c, mean_degree=64.0, seed=1
    )
    print(
        f"graph: {n} nodes, {int(indptr[-1])} directed edges, {c} labels, "
        f"avg {labels.sum(1).mean():.2f} labels/node "
        f"({time.perf_counter() - t0:.1f}s)",
        file=sys.stderr,
    )

    g = pecanpy.SparseOTF(random_state=0)
    SparseGraph.__init__(g)
    g.indptr = indptr.astype(np.uint32)
    g.indices = indices.astype(np.uint32)
    g.data = data
    g.set_node_ids([str(i) for i in range(n)])

    t0 = time.perf_counter()
    # default (auto) batch_walks: sized so per-row gradient counts stay
    # near the update cap — large forced chunks throttle learning
    import os

    # "auto" = the shipping default (float32); override to pin
    table_dtype = os.environ.get("BENCH_TABLE_DTYPE", "auto")
    if sequential:
        emb = embed_sequential(
            g, dim=128, num_walks=10, walk_length=80, window=10,
            epochs=int(os.environ.get("BENCH_EPOCHS", "1")),
            seed=0, workers=workers,
        )
    else:
        bw = os.environ.get("BENCH_BATCH_WALKS", "")
        epochs = int(os.environ.get("BENCH_EPOCHS", "1"))
        emb = g.embed(
            dim=128, num_walks=10, walk_length=80, window_size=10,
            epochs=epochs,
            table_dtype=table_dtype,
            batch_walks=int(bw) if bw else None,
        )
    t_embed = time.perf_counter() - t0
    print(f"embed: {t_embed:.1f}s", file=sys.stderr)

    t0 = time.perf_counter()
    f1 = evaluate.multilabel_node_classification(
        emb, labels, train_fraction=0.5, seed=0
    )
    rng = np.random.default_rng(9)
    f1_rand = evaluate.multilabel_node_classification(
        rng.standard_normal(emb.shape).astype(np.float32), labels,
        train_fraction=0.5, seed=0,
    )
    print(
        f"micro-F1 (OvR logistic, top-k): {f1:.4f} "
        f"(random-embedding floor {f1_rand:.4f}; "
        f"eval {time.perf_counter() - t0:.1f}s)",
        file=sys.stderr,
    )
    trainer = "sequential" if sequential else "device"
    print(
        f'{{"metric": "multilabel_micro_f1", "value": {f1:.4f}, '
        f'"unit": "micro-F1", "floor": {f1_rand:.4f}, '
        f'"trainer": "{trainer}", "embed_seconds": {t_embed:.1f}}}'
    )


if __name__ == "__main__":
    main()
