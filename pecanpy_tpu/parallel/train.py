"""Multi-device fused training: sharded walks + sharded SGNS updates.

One ``shard_map`` program per step: a batch of walkers (sharded over the
``data`` mesh axis) advances ``walk_length`` steps over the graph —
replicated per device, or row-sharded over the same axis with collective
row fetches (``partition="edge"``, ``parallel/distgraph.py``) once the
graph outgrows one device's memory; hub graphs included, via the same
rejection path as single-device walking — the walks expand into
skip-gram pairs, and the tensor-parallel embedding tables (sharded along
``dim`` over ``model``) take one SGNS update. Collectives are explicit (``models/sgns.py`` ``make_step_body``):

* ``psum`` over ``model`` for the two pair-score einsums (partial dots of
  dim-sharded rows);
* ``all_gather`` over ``data`` for the update streams, so every data
  shard applies the identical full stream to its (data-replicated) table
  slice with the deterministic applier (``ops/apply.py``) — tables stay
  bitwise-identical across data shards.

``shard_map`` (not GSPMD sharding annotations) keeps each collective
where the step body places it, so the per-shard program is the
single-device step plus those collectives.

The reference has no distributed backend at all (SURVEY §5); this module
is new capability, constrained only to reproduce the single-device
training semantics per step.
"""
import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pecanpy_tpu.models import engine, sgns
from pecanpy_tpu.models.sgns import SGNSConfig
from pecanpy_tpu.ops import rejection
from pecanpy_tpu.ops.layout import DeviceCSR
from pecanpy_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

# Version tag of the multichip trainer's RNG-stream derivation
# (split(key, 3) init/walk/sgns streams, per-BATCH walk keys, per-step
# sgns fold_ins). Stamped into every checkpoint; resume refuses a
# mismatch (utils.checkpoint.verify_rng_scheme) — the round-4 stream
# restructure would otherwise have silently resumed older checkpoints
# onto a different corpus/schedule.
RNG_SCHEME = "multichip-split3-batchwalk-v1"
# (the edge partition keeps the same scheme: the collective row fetch
# changes where graph rows live, not the key tree, so the walk corpus —
# and therefore a checkpoint's resume trajectory — is bit-identical
# across partitions; tests/test_parallel.py pins this.)


def graph_table_bytes(graph: DeviceCSR) -> int:
    """Total bytes of the graph's device tables (fused + hub + aux)."""
    return int(
        sum(getattr(leaf, "nbytes", 0) for leaf in jax.tree.leaves(graph))
    )


def resolve_partition(
    partition: str,
    graph_bytes: int,
    n_data_shards: int,
    mode_supported: bool = True,
) -> str:
    """Resolve ``partition="auto"`` to a concrete graph layout.

    Replicate while the graph's tables fit comfortably under the
    per-device budget (half the device's memory, leaving room for
    embedding tables, walk buffers, and XLA scratch;
    ``PECANPY_TPU_REPLICATED_BUDGET_MB`` overrides, see
    ``utils/budget.py``); row-shard ("edge") past it. Modes without
    an edge-partitioned walker (the PreComp family — per-edge tables are
    single-device by design) always replicate, matching the trainer's
    own validation.
    """
    from pecanpy_tpu.utils.budget import REPLICATED, budget_bytes

    if partition != "auto":
        return partition
    if n_data_shards <= 1 or not mode_supported:
        return "replicated"
    return "edge" if graph_bytes > budget_bytes(REPLICATED) else "replicated"


@dataclasses.dataclass
class MultichipTrainer:
    """Holds the mesh, sharded state, and the compiled fused step.

    ``partition`` picks the graph layout:

    * ``"replicated"`` (default): every chip holds the full fused table;
      walking needs no collectives. Right while the graph fits one
      device's memory.
    * ``"edge"``: the fused table (and hub tables) row-shard over the
      ``data`` axis (``parallel/distgraph.py``); per-step row fetches
      become the collective exchange (psum or request/response
      all-to-all, cost-model ``exchange="auto"``). Removes the
      one-device memory ceiling — per-device graph memory is 1/S of the
      table. The walks (and therefore the trained embeddings) are
      bit-identical to the replicated layout for the same seed: the
      partition changes where rows live, never which rows come back.

    ``graph`` may carry host-numpy leaves (``Base.get_host_graph``);
    under ``partition="edge"`` each shard's slice is device_put directly
    so the full table never lands on one device.
    """

    mesh: Mesh
    graph: DeviceCSR
    config: SGNSConfig
    walk_length: int
    p: float = 1.0
    q: float = 1.0
    extend: bool = False
    mode: str = "SparseOTF"
    partition: str = "replicated"
    exchange: str = "auto"

    def __post_init__(self):
        self._table_sharding = NamedSharding(self.mesh, P(None, MODEL_AXIS))
        self._batch_sharding = NamedSharding(self.mesh, P(DATA_AXIS))
        self._repl_sharding = NamedSharding(self.mesh, P())
        if self.partition == "edge":
            from pecanpy_tpu.parallel import distgraph

            if self.mode not in (
                "SparseOTF", "DenseOTF", "FirstOrderUnweighted"
            ):
                raise ValueError(
                    f"partition='edge' does not support mode {self.mode!r} "
                    "(PreComp's per-edge tables are single-device by "
                    "design); use SparseOTF"
                )
            sharded, self._meta = distgraph.shard_graph(self.graph, self.mesh)
            self._graph_args = (
                sharded.fused, sharded.edge_pack, sharded.hbuckets,
                sharded.threshold,
            )
            self._graph_specs = (
                P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None),
                P(),
            )
            self._local_walker = distgraph.make_local_walker(
                self.graph, self._meta, self.mesh.shape[DATA_AXIS],
                self.walk_length, self.p, self.q, self.extend, self.mode,
                exchange=self.exchange,
            )
        elif self.partition == "replicated":
            self.graph = jax.device_put(self.graph, self._repl_sharding)
            self._graph_args = (self.graph,)
            self._graph_specs = (P(),)
        else:
            raise ValueError(
                f"unknown partition {self.partition!r}; "
                "use 'replicated' or 'edge'"
            )
        self._step = self._build_step()
        self._count = self._build_count_fn()

    # -- construction ---------------------------------------------------------

    def _step_fns(self):
        """Mode-specific (first_fn, step_fn) — same plug points as the
        single-device engine (``models/modes.py``), hub-aware."""
        from pecanpy_tpu.models import modes

        if self.mode in ("SparseOTF", "DenseOTF"):
            return modes._otf_step_fns(self.p, self.q, self.extend)
        if self.mode == "FirstOrderUnweighted":
            def first_fn(dg, aux, key, cur, cur_rows):
                return rejection.uniform_propose(dg, key, cur_rows)

            return first_fn, (
                lambda dg, aux, key, cur, prev, cur_rows, prev_rows:
                rejection.uniform_propose(dg, key, cur_rows)
            )
        if self.mode == "PreCompFirstOrder":
            def first_fn(dg, aux, key, cur, cur_rows):
                x, _ = rejection.propose(dg, key, cur_rows, use_cdf=True)
                return x

            return first_fn, (
                lambda dg, aux, key, cur, prev, cur_rows, prev_rows:
                first_fn(dg, aux, key, cur, cur_rows)
            )
        raise ValueError(
            f"mode {self.mode!r} has no multichip trainer path "
            "(PreComp's per-edge tables are not replicable at scale; "
            "use SparseOTF)"
        )

    def _walk(self, graph, starts, key):
        if self.mode in ("SparseOTF", "DenseOTF") and graph.has_hubs:
            # hub graphs: stall-round amortized walker (replicated graph
            # -> local gathers, per-shard loop counts may diverge freely)
            return engine.generate_walks_amortized(
                graph, starts, key, self.walk_length,
                self.p, self.q, self.extend,
            )
        first_fn, step_fn = self._step_fns()
        return engine.generate_walks(
            graph,
            lambda k, cur, rows: first_fn(graph, (), k, cur, rows),
            lambda k, cur, prev, cr, pr: step_fn(
                graph, (), k, cur, prev, cr, pr
            ),
            starts,
            key,
            self.walk_length,
        )

    def _local_walk(self, graph_args, starts, walk_key):
        """Per-shard walk dispatch (INSIDE shard_map): same walk-key
        derivation (fold the data-axis index) under both partitions, so
        the corpora are bit-identical across layouts."""
        if self.partition == "edge":
            # the local walker folds the axis index itself
            return self._local_walker(*graph_args, starts, walk_key)
        k = jax.random.fold_in(walk_key, jax.lax.axis_index(DATA_AXIS))
        return self._walk(graph_args[0], starts, k)

    def _build_step(self) -> Callable:
        body = sgns.make_step_body(
            self.graph.num_nodes,
            self.config,
            model_axis=MODEL_AXIS,
            data_axis=DATA_AXIS,
        )
        ng = len(self._graph_args)

        def fused_step(*args):
            graph_args = args[:ng]
            (w_in, w_out, starts, keep_prob, neg_table,
             lr, walk_key, sgns_key) = args[ng:]
            # walk and SGNS keys are independent so the streaming driver
            # can replay the identical walk corpus every epoch (keyed per
            # batch) while subsampling/negatives still differ per step —
            # the single-device streaming semantics (models/sgns.py)
            k_sgns = jax.random.fold_in(
                sgns_key, jax.lax.axis_index(DATA_AXIS)
            )
            walks, eff = self._local_walk(graph_args, starts, walk_key)
            return body(
                w_in, w_out, walks, eff, keep_prob, neg_table, lr, k_sgns
            )

        mapped = jax.shard_map(
            fused_step,
            mesh=self.mesh,
            in_specs=self._graph_specs + (
                P(None, MODEL_AXIS),
                P(None, MODEL_AXIS),
                P(DATA_AXIS),
                P(),
                P(),
                P(),
                P(),
                P(),
            ),
            out_specs=(P(None, MODEL_AXIS), P(None, MODEL_AXIS)),
            check_vma=False,
        )
        return jax.jit(mapped, donate_argnums=(ng, ng + 1))

    def _build_count_fn(self) -> Callable:
        """Sharded walk + token-count pass (the vocab scan of the
        streaming pipeline; gensim's equivalent is its vocabulary
        build)."""
        n = self.graph.num_nodes
        ng = len(self._graph_args)

        def count(*args):
            graph_args, starts, key = args[:ng], args[ng], args[ng + 1]
            # same walk-key derivation as fused_step, so counting a batch
            # under a key sees the exact walks training will consume
            walks, eff = self._local_walk(graph_args, starts, key)
            valid = jnp.arange(walks.shape[1]) < eff[:, None]
            c = (
                jnp.zeros(n, dtype=jnp.float32)
                .at[walks.reshape(-1)]
                .add(valid.reshape(-1).astype(jnp.float32))
            )
            return jax.lax.psum(c, DATA_AXIS)

        mapped = jax.shard_map(
            count,
            mesh=self.mesh,
            in_specs=self._graph_specs + (P(DATA_AXIS), P()),
            out_specs=P(),
            check_vma=False,
        )
        return jax.jit(mapped)

    # -- state ----------------------------------------------------------------

    def init_params(self, key: jax.Array):
        """Sharded [N, dim] (w_in, w_out) tables (dims split over
        ``model``), initialized exactly as the single-device trainer."""
        n, d = self.graph.num_nodes, self.config.dim
        from pecanpy_tpu.models.sgns import (
            _alloc_tables,
            resolve_table_dtype,
        )

        dtype = resolve_table_dtype(self.config)
        w_in, w_out = _alloc_tables(key, n, d, dtype)
        return (
            jax.device_put(w_in, self._table_sharding),
            jax.device_put(w_out, self._table_sharding),
        )

    def shard_batch(self, starts):
        n_shards = self.mesh.shape[DATA_AXIS]
        starts = np.asarray(starts, dtype=np.int32)
        pad = (-starts.size) % n_shards
        if pad:  # dead-pad with node 0; walks from pads are never consumed
            starts = np.pad(starts, (0, pad))
        return jax.device_put(jnp.asarray(starts), self._batch_sharding)

    # -- stepping -------------------------------------------------------------

    def count_tokens(self, starts, key) -> jax.Array:
        """[N] token counts of the walks this batch of starts generates."""
        return self._count(*self._graph_args, self.shard_batch(starts), key)

    def step(self, w_in, w_out, starts, keep_prob, neg_table, lr, key,
             walk_key=None):
        """One fused walk + SGNS update step.

        ``neg_table`` is a shuffled unigram^0.75 sampling table
        (``sgns.build_negative_table``), replicated across the mesh.
        ``walk_key`` seeds walk generation separately from the SGNS
        randomness — pass a per-batch key to replay the identical walk
        corpus across epochs. Default (None) splits ``key`` so the two
        streams stay independent.
        """
        if walk_key is None:
            walk_key, key = jax.random.split(key)
        return self._step(
            *self._graph_args, w_in, w_out, starts, keep_prob, neg_table,
            jnp.float32(lr), walk_key, key,
        )


def train_streaming_multichip(
    trainer: MultichipTrainer,
    starts: np.ndarray,
    epochs: int = 1,
    seed: int = 0,
    verbose: bool = False,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    batch: Optional[int] = None,
    max_steps: Optional[int] = None,
) -> np.ndarray:
    """Two-pass streaming pipeline on a mesh: vocab scan, then fused
    walk+train steps. Multi-device counterpart of
    ``sgns.train_streaming`` (walks regenerated, never stored).

    Args:
        trainer: the compiled mesh program holder.
        starts: full start-node schedule (every node x num_walks,
            pre-shuffled — ``Base._start_nodes``).
        batch: walkers per fused step (global, across shards); default
            ``sgns.resolve_batch_walks`` — the SAME update-application
            granularity as the single-device trainer (~max(2048, N)
            window pairs per application), rounded up to the shard
            multiple and capped by the schedule size. A mesh-sized
            floor (128 walks/shard) here would collapse small corpora
            into one giant mean-aggregated update per epoch and gut
            quality (measured: SBM micro-F1 0.25 vs 1.0); learning
            dynamics win over per-dispatch efficiency.

    Returns:
        [N, dim] float32 embeddings (gathered to host).
    """
    import time as _time

    n = trainer.graph.num_nodes
    config = trainer.config
    n_shards = trainer.mesh.shape[DATA_AXIS]
    if batch is None:
        batch = min(
            max(
                sgns.resolve_batch_walks(
                    config, n, trainer.walk_length + 1
                ),
                n_shards,
            ),
            max(starts.size, n_shards),
        )
    batch += (-batch) % n_shards
    key = jax.random.PRNGKey(seed)
    k_init, k_walks, k_sgns = jax.random.split(key, 3)

    batches = [
        starts[lo : lo + batch] for lo in range(0, starts.size, batch)
    ]

    # pass 1: vocabulary statistics over the identical walk stream the
    # training epochs will replay (walk keys are per BATCH, not per
    # step, so every epoch regenerates the same corpus — gensim's
    # corpus-epochs semantics and the single-device streaming contract).
    # The per-batch token sums recorded here drive the lr schedule and
    # the resume replay with MEASURED counts, the same as the
    # single-device path (models/sgns.py _chunk_lrs).
    counts = jnp.zeros(n, dtype=jnp.float32)
    batch_tokens = []
    for i, part in enumerate(batches):
        c = trainer.count_tokens(part, jax.random.fold_in(k_walks, i))
        batch_tokens.append(float(jnp.sum(c)))
        counts = counts + c
    counts_np = np.asarray(counts)
    keep_prob = jax.device_put(
        sgns._keep_probs(counts, config.sample), trainer._repl_sharding
    )
    neg_table = jax.device_put(
        jnp.asarray(sgns.build_negative_table(counts_np, seed=seed)),
        trainer._repl_sharding,
    )
    total_tokens = float(counts_np.sum()) * epochs

    w_in, w_out = trainer.init_params(k_init)

    ckpt, resume_step, restored = sgns._open_checkpoint(
        checkpoint_dir, RNG_SCHEME, w_in.dtype
    )
    if restored is not None:
        w_in, w_out = (
            jax.device_put(w, trainer._table_sharding) for w in restored
        )

    step_idx = 0
    done_tokens = 0.0
    t0 = _time.perf_counter()
    for epoch in range(epochs):
        for i, part in enumerate(batches):
            if max_steps is not None and step_idx >= max_steps:
                return sgns._fetch_f32(w_in)
            if step_idx < resume_step:
                done_tokens += batch_tokens[i]
                step_idx += 1
                continue
            lr = max(
                config.min_alpha,
                config.alpha
                - (config.alpha - config.min_alpha)
                * (done_tokens / max(total_tokens, 1.0)),
            )
            w_in, w_out = trainer.step(
                w_in, w_out, trainer.shard_batch(part), keep_prob,
                neg_table, lr, jax.random.fold_in(k_sgns, step_idx),
                walk_key=jax.random.fold_in(k_walks, i),
            )
            done_tokens += batch_tokens[i]
            step_idx += 1
            sgns._progress(verbose, t0, done_tokens, total_tokens)
            if ckpt is not None and step_idx % checkpoint_every == 0:
                ckpt.save(
                    step_idx, w_in, w_out,
                    {"next_step": step_idx, "rng_scheme": RNG_SCHEME},
                )
    return sgns._fetch_f32(w_in)
