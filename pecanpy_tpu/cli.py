"""Command-line interface.

Mirrors the reference CLI surface (``src/pecanpy/cli.py``): the same flag
set, task dispatch (``pecanpy`` / ``tocsr`` / ``todense``), mode-selection
recommendation heuristics, and output formats (.npz or word2vec text).

Example::

    pecanpy-tpu --input demo/karate.edg --output karate.emb --mode SparseOTF
"""
import argparse
import warnings

import numpy as np

from pecanpy_tpu import graph, pecanpy
from pecanpy_tpu.wrappers import Timer


def parse_args(argv=None):
    """Parse node2vec arguments (flag parity: ``cli.py:27-176``)."""
    parser = argparse.ArgumentParser(
        description="Run pecanpy-tpu, an accelerator-native node2vec(+) "
        "framework built on JAX/XLA",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument(
        "--input", required=True, help="Path to the input graph (.edg edgelist or .npz CSR/dense)."
    )
    parser.add_argument(
        "--output",
        required=True,
        help="Where to write the embeddings: a .npz archive when the path "
        "ends in .npz, word2vec text format otherwise.",
    )
    parser.add_argument(
        "--task",
        default="pecanpy",
        choices=["pecanpy", "tocsr", "todense", "walks"],
        help="Pipeline to run: full embedding, graph format conversion, "
        "or `walks` to write the raw random walks (one space-separated "
        "node-ID walk per line) for external training.",
    )
    parser.add_argument(
        "--mode",
        default="SparseOTF",
        choices=[
            "DenseOTF",
            "FirstOrderUnweighted",
            "PreComp",
            "PreCompFirstOrder",
            "SparseOTF",
        ],
        help="Walk engine variant (see README for the selection heuristics).",
    )
    parser.add_argument(
        "--dimensions", type=int, default=128, help="Embedding dimensionality."
    )
    parser.add_argument(
        "--walk-length", type=int, default=80, help="Steps taken by each walk."
    )
    parser.add_argument(
        "--num-walks", type=int, default=10, help="Walks started from every node."
    )
    parser.add_argument(
        "--window-size", type=int, default=10, help="Skip-gram context window radius."
    )
    parser.add_argument(
        "--epochs", type=int, default=1, help="Number of SGNS training epochs."
    )
    parser.add_argument(
        "--workers",
        type=int,
        default=0,
        help="Number of host threads (0 = all available). Device kernels "
        "are unaffected.",
    )
    parser.add_argument("--p", type=float, default=1, help="node2vec return parameter (bias 1/p toward the previous node).")
    parser.add_argument("--q", type=float, default=1, help="node2vec in-out parameter (bias 1/q on outward edges).")
    parser.add_argument(
        "--weighted", action="store_true", help="Treat the third edgelist column as edge weights."
    )
    parser.add_argument(
        "--directed", action="store_true", help="Keep edges one-directional (default inserts both directions)."
    )
    parser.add_argument(
        "--verbose", action="store_true", help="Print stage timings and progress."
    )
    parser.add_argument(
        "--extend", action="store_true", help="Enable the node2vec+ extended transition kernel."
    )
    parser.add_argument(
        "--gamma", type=float, default=0, help="node2vec+ noise-threshold std multiplier."
    )
    parser.add_argument(
        "--random_state",
        type=int,
        default=None,
        help="Seed for the walk RNG tree and start-node shuffle.",
    )
    parser.add_argument(
        "--delimiter",
        type=str,
        default="\t",
        help="Column separator of the edgelist file.",
    )
    parser.add_argument(
        "--implicit_ids",
        action="store_true",
        help="Number nodes 0..N-1 instead of reading an IDs array.",
    )
    # --- device-specific extensions (absent from the reference CLI) ---
    parser.add_argument(
        "--degree-cap",
        type=int,
        default=None,
        help="Nodes above this degree use the O(E) hub structures + "
        "rejection sampling instead of fused rows (default: 128; pass 0 "
        "to disable capping).",
    )
    parser.add_argument(
        "--walker-batch",
        type=int,
        default=None,
        help="Walkers advanced per device dispatch (default 131072).",
    )
    parser.add_argument(
        "--table-dtype",
        choices=["auto", "float32", "bfloat16"],
        default="auto",
        help="Embedding-table dtype. bfloat16 halves memory/traffic but "
        "rounds updates to nearest (small SGD steps are lost); 'auto' "
        "(default) picks float32.",
    )
    parser.add_argument(
        "--streaming",
        choices=["auto", "on", "off"],
        default="auto",
        help="Stream walks into training (regenerated, never stored). "
        "auto: on above ~1e8 tokens.",
    )
    parser.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="Capture a jax.profiler trace of the pipeline into DIR "
        "(view with TensorBoard / xprof). Replaces the reference's "
        "Timer-only observability with device-level traces.",
    )
    parser.add_argument(
        "--trainer",
        choices=["device", "tpu", "sequential"],
        default="device",
        help="SGNS implementation: 'device' is the batched on-device "
        "trainer ('tpu' is its old name, still accepted); 'sequential' "
        "runs gensim's exact sequential loop on host threads (native "
        "C++, hogwild over --workers threads) — the quality reference, "
        "at host CPU speed.",
    )
    parser.add_argument(
        "--checkpoint-dir",
        default=None,
        help="Snapshot the full SGNS training state into this directory "
        "every --checkpoint-every chunk-steps, and resume from the "
        "latest snapshot when one exists (bit-identical to an "
        "uninterrupted run).",
    )
    parser.add_argument(
        "--checkpoint-every",
        type=int,
        default=100,
        help="Checkpoint period in training chunk-steps.",
    )
    parser.add_argument(
        "--max-steps",
        type=int,
        default=None,
        help="Stop training after this many chunk-steps (combine with "
        "--checkpoint-dir to split a long run across invocations; the "
        "lr schedule stays pinned to the full plan).",
    )
    parser.add_argument(
        "--devices",
        type=int,
        default=None,
        help="Run the fused multi-device pipeline over this many chips "
        "(walkers data-parallel, tables tensor-parallel).",
    )
    parser.add_argument(
        "--model-parallel",
        type=int,
        default=1,
        help="Tensor-parallel shards for the embedding tables "
        "(must divide --devices).",
    )
    parser.add_argument(
        "--partition",
        type=str,
        default="auto",
        choices=("auto", "replicated", "edge"),
        help="Graph layout on the mesh: 'replicated' (full table per "
        "device), 'edge' (table row-sharded over the data axis with "
        "collective row fetches — graphs bigger than one device's "
        "memory), or 'auto' (edge once the tables exceed half a "
        "device's memory, PECANPY_TPU_REPLICATED_BUDGET_MB overrides). "
        "Both layouts train bit-identical embeddings for a given seed.",
    )
    return parser.parse_args(argv)


def check_mode(g, args):
    """Validate mode constraints and recommend better modes.

    Same decision table as the reference (``cli.py:179-254``):
    FirstOrderUnweighted requires unweighted p=q=1; PreCompFirstOrder
    requires p=q=1; density thresholds steer PreComp / SparseOTF / DenseOTF.
    """
    mode, weighted, p, q = args.mode, args.weighted, args.p, args.q

    if mode == "FirstOrderUnweighted":
        if not p == q == 1 or weighted:
            raise ValueError(
                f"FirstOrderUnweighted only works when weighted = False and "
                f"p = q = 1, got {weighted=}, {p=}, {q=}",
            )
        return
    if p == q == 1 and not weighted:
        warnings.warn(
            f"unweighted graph with p = q = 1: FirstOrderUnweighted would "
            f"be much faster and lighter than the selected {mode}",
            stacklevel=2,
        )
        return

    if mode == "PreCompFirstOrder":
        if not p == q == 1:
            raise ValueError(
                f"PreCompFirstOrder only works when p = q = 1, got {p=}, {q=}",
            )
        return
    if p == 1 == q:
        warnings.warn(
            f"p = q = 1 makes the walk first-order: PreCompFirstOrder would "
            f"be much faster than the selected {mode} at little memory cost",
            stacklevel=2,
        )
        return

    size, dens = g.num_nodes, g.density
    if dens >= 0.2 and mode != "DenseOTF":
        warnings.warn(
            f"density {dens:.3f} >= 0.2: DenseOTF usually beats the "
            f"selected {mode} on graphs this dense",
            stacklevel=2,
        )
    if dens < 0.001 and size < 10000 and mode != "PreComp":
        warnings.warn(
            f"density {dens:.2e} < 0.001 and {size} nodes < 10000: PreComp "
            f"usually beats the selected {mode} on small sparse graphs",
            stacklevel=2,
        )
    if 0.001 <= dens < 0.2 and mode != "SparseOTF":
        warnings.warn(
            f"density {dens:.3f} sits in SparseOTF's sweet spot "
            f"(0.001-0.2); consider it over the selected {mode}",
            stacklevel=2,
        )
    if dens < 0.001 and size >= 10000 and mode != "SparseOTF":
        warnings.warn(
            f"density {dens:.3f} < 0.001 with {size} nodes >= 10000: "
            f"SparseOTF usually beats the selected {mode} at this scale",
            stacklevel=2,
        )


@Timer("load Graph")
def read_graph(args):
    """Load the input network; handle the conversion tasks.

    Reference flow: ``cli.py:257-304``.
    """
    if args.directed and args.extend:
        raise NotImplementedError(
            "Node2vec+ not implemented for directed graph yet."
        )
    if args.extend and not args.weighted:
        print("NOTE: node2vec+ is equivalent to node2vec for unweighted graphs.")

    if args.task in ("tocsr", "todense"):
        g = graph.SparseGraph() if args.task == "tocsr" else graph.DenseGraph()
        g.read_edg(args.input, args.weighted, args.directed, args.delimiter)
        g.save(args.output)
        return None

    mode_cls = getattr(pecanpy, args.mode)
    extra = {}
    if args.degree_cap is not None:
        extra["degree_cap"] = args.degree_cap if args.degree_cap > 0 else None
    if args.walker_batch is not None:
        extra["walker_batch"] = args.walker_batch
    g = mode_cls(
        p=args.p,
        q=args.q,
        workers=args.workers,
        verbose=args.verbose,
        extend=args.extend,
        gamma=args.gamma,
        random_state=args.random_state,
        **extra,
    )
    if args.input.endswith(".npz"):
        g.read_npz(args.input, args.weighted, implicit_ids=args.implicit_ids)
    else:
        g.read_edg(args.input, args.weighted, args.directed, args.delimiter)

    check_mode(g, args)
    return g


def save_embeddings(path: str, node_ids, embeddings: np.ndarray):
    """Write embeddings as .npz (keys IDs/data) or word2vec text format.

    Output contract: ``cli.py:321-325``. The text format is the standard
    word2vec layout: a ``"<vocab> <dim>"`` header line, then one
    space-separated ``<id> <v1> ... <vd>`` row per node.
    """
    if path.endswith(".npz"):
        np.savez(path, IDs=node_ids, data=embeddings)
        return
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{len(node_ids)} {embeddings.shape[1]}\n")
        for node_id, row in zip(node_ids, embeddings):
            vec = " ".join(repr(float(v)) for v in row)
            f.write(f"{node_id} {vec}\n")


@Timer("pre-compute transition probabilities")
def preprocess(g):
    """Transition-probability preprocessing stage (timed)."""
    g.preprocess_transition_probs()


@Timer("generate walks")
def simulate_walks(args, g):
    """Walk generation stage (timed); keeps walks on device."""
    return g.simulate_walks_device(args.num_walks, args.walk_length)


@Timer("train embeddings")
def learn_embeddings(args, g, walks, eff_len):
    """SGNS training stage (timed) + output writing."""
    from pecanpy_tpu.models import sgns

    config = sgns.SGNSConfig(
        dim=args.dimensions,
        window=args.window_size,
        epochs=args.epochs,
        seed=args.random_state,
        table_dtype=args.table_dtype,
    )
    embeddings = np.asarray(
        sgns.train(
            walks,
            eff_len,
            g.num_nodes,
            config,
            verbose=args.verbose,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            max_steps=args.max_steps,
        )
    )
    save_embeddings(args.output, g.nodes, embeddings)


def main(argv=None):
    """End-to-end pipeline: read -> preprocess -> walk -> embed -> save."""
    args = parse_args(argv)
    if args.task not in ("tocsr", "todense"):
        # after parse_args (so --help stays instant) and skipped for the
        # pure host-side conversion tasks, which never compile anything
        from pecanpy_tpu.utils.cache import enable_compilation_cache

        enable_compilation_cache()
    if args.profile:
        import jax

        with jax.profiler.trace(args.profile):
            return _run(args)
    return _run(args)


def _run(args):
    g = read_graph(args)
    if g is None:  # conversion task
        return
    preprocess(g)

    if args.task == "walks":
        # raw-walk export (capability beyond the reference CLI): device
        # walks mapped to node-ID strings, one walk per line, cut at the
        # effective length. Chunks stream straight to the file — the
        # full corpus (810M tokens at the default 1M-node workload) is
        # never materialized as host Python lists.
        if args.devices is not None and args.devices > 1:
            warnings.warn(
                "--task walks runs single-device; --devices is ignored "
                "(use the default embedding task for multi-device runs)",
                stacklevel=2,
            )

        @Timer("generate walks", args.verbose)
        def export_walks():
            ids = g.nodes
            with open(args.output, "w", encoding="utf-8") as f:
                for walks, eff in g._walk_chunks(
                    args.num_walks, args.walk_length, g._base_key()
                ):
                    for row, n in zip(np.asarray(walks), np.asarray(eff)):
                        f.write(" ".join(ids[node] for node in row[:n]))
                        f.write("\n")

        export_walks()
        return

    if args.trainer == "sequential":
        if args.devices is not None and args.devices > 1:
            raise ValueError(
                "--trainer sequential runs on the host; it cannot be "
                "combined with --devices"
            )
        embeddings = g.embed(
            dim=args.dimensions,
            num_walks=args.num_walks,
            walk_length=args.walk_length,
            window_size=args.window_size,
            epochs=args.epochs,
            verbose=args.verbose,
            trainer="sequential",
            checkpoint_dir=args.checkpoint_dir,  # embed() rejects it
        )
        save_embeddings(args.output, g.nodes, np.asarray(embeddings))
        return

    if args.devices is not None and args.devices > 1:
        embeddings = g.embed(
            dim=args.dimensions,
            num_walks=args.num_walks,
            walk_length=args.walk_length,
            window_size=args.window_size,
            epochs=args.epochs,
            verbose=args.verbose,
            table_dtype=args.table_dtype,
            n_devices=args.devices,
            model_parallel=args.model_parallel,
            partition=args.partition,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            max_steps=args.max_steps,
        )
        save_embeddings(args.output, g.nodes, np.asarray(embeddings))
        return

    total_tokens = g.num_nodes * args.num_walks * (args.walk_length + 1)
    use_stream = args.streaming == "on" or (
        args.streaming == "auto"
        and total_tokens > type(g).STREAMING_TOKEN_THRESHOLD
    )
    if use_stream:
        embeddings = Timer("stream walks + train embeddings", args.verbose)(
            g.embed
        )(
            dim=args.dimensions,
            num_walks=args.num_walks,
            walk_length=args.walk_length,
            window_size=args.window_size,
            epochs=args.epochs,
            verbose=args.verbose,
            streaming=True,
            table_dtype=args.table_dtype,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            max_steps=args.max_steps,
        )
        save_embeddings(args.output, g.nodes, np.asarray(embeddings))
        return
    walks, eff_len = simulate_walks(args, g)
    learn_embeddings(args, g, walks, eff_len)


if __name__ == "__main__":
    main()
