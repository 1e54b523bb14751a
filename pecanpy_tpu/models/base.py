"""Walk-mode base class: device-graph management, walk driver, embedding.

Mirrors the surface of the reference ``Base`` (``pecanpy.py:27-290``):
constructor parameters ``p, q, workers, verbose, extend, gamma,
random_state``, the ``simulate_walks`` / ``embed`` entry points, and the
lazy one-shot ``preprocess_transition_probs`` hook. The execution model is
completely different: walks run as batched ``lax.scan`` programs on device
(see ``pecanpy_tpu.models.engine``), and embeddings train with the on-device
SGNS trainer instead of gensim.

Reproducibility contract: the reference promises identical walks for a
fixed ``random_state`` with one thread (same RNG stream). Here the promise
is the JAX equivalent — a fixed ``random_state`` yields an identical
``jax.random`` key tree and therefore identical walks, independent of batch
chunking or device count. The two implementations agree *distributionally*
(same per-step transition law), not sample-for-sample.
"""
import time
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pecanpy_tpu.graph import BaseGraph
from pecanpy_tpu.models import engine
from pecanpy_tpu.ops.layout import DEFAULT_DEGREE_CAP, DeviceCSR
from pecanpy_tpu.typing import Embeddings
from pecanpy_tpu.wrappers import Timer

TRAINERS = ("device", "sequential")


def resolve_trainer(trainer: str) -> str:
    """Canonical trainer name; ``"tpu"`` is the old name of ``"device"``."""
    if trainer == "tpu":
        return "device"
    if trainer not in TRAINERS:
        raise ValueError(
            f"unknown trainer {trainer!r}; use 'device' or 'sequential'"
        )
    return trainer


DEFAULT_WALKER_BATCH = 131072
# Hub graphs take a smaller batch: the stall-tail inflation (max over
# lanes of summed geometric retries) grows with the batch. Both defaults
# were tuned on another accelerator and are not yet re-measured on the
# GPU.
DEFAULT_HUB_WALKER_BATCH = 32768


class Base(BaseGraph):
    """Skeleton for all walk modes.

    Args:
        p: return parameter (bias 1/p on the edge back to the previous node).
        q: in-out parameter (bias 1/q on edges leaving prev's neighborhood).
        workers: host thread count for CPU-side work; device kernels ignore
            it (kept for reference API parity, where it is also a no-op for
            walks — ``pecanpy.py:96``).
        verbose: print stage timings / progress.
        extend: use the node2vec+ extended transition kernel.
        gamma: node2vec+ noise-threshold std multiplier.
        random_state: seed for start-node shuffling and the device RNG tree.
        walker_batch: walkers advanced per device dispatch (compiled batch
            size). None resolves per graph: 131072 on fused-path graphs,
            32768 on hub graphs (see DEFAULT_HUB_WALKER_BATCH).
        degree_cap: nodes above this degree are served by the O(E) hub
            structures + rejection sampling instead of fused rows
            (``ops/hubs.py``); None pads fused rows to the true max degree.
    """

    def __init__(
        self,
        p: float = 1,
        q: float = 1,
        workers: int = 1,
        verbose: bool = False,
        extend: bool = False,
        gamma: float = 0,
        random_state: Optional[int] = None,
        walker_batch: Optional[int] = None,
        degree_cap: Optional[int] = DEFAULT_DEGREE_CAP,
    ):
        super().__init__()
        from pecanpy_tpu.utils.cache import enable_compilation_cache

        enable_compilation_cache()
        self.degree_cap = degree_cap
        self.p = p
        self.q = q
        self.workers = workers
        self.verbose = verbose
        self.extend = extend
        self.gamma = gamma
        self.random_state = random_state
        self._resolved_seed: Optional[int] = None
        self.walker_batch = walker_batch
        self._device_graph: Optional[DeviceCSR] = None
        self._host_graph: Optional[DeviceCSR] = None
        self._preprocessed: bool = False
        self._walk_fn_cache: Dict[int, object] = {}

    # -- device graph -------------------------------------------------------

    def _build_device_graph(self, to_device: bool = True) -> DeviceCSR:
        raise NotImplementedError

    def get_device_graph(self) -> DeviceCSR:
        """Padded device layout of this graph (built once, cached)."""
        if self._device_graph is None:
            self._device_graph = self._build_device_graph()
        return self._device_graph

    def get_host_graph(self) -> DeviceCSR:
        """The fused layout with host-numpy leaves (built once, cached).

        Used by the edge-partitioned pipeline, which device_puts each
        shard's row slice directly onto its device — the full table never
        lands on a single device, so graphs bigger than one device's
        memory stay buildable. Reuses the device copy's leaves when that was
        already built (fetching beats building twice).
        """
        if self._host_graph is None:
            if self._device_graph is not None:
                self._host_graph = jax.tree.map(
                    np.asarray, self._device_graph
                )
            else:
                self._host_graph = self._build_device_graph(to_device=False)
        return self._host_graph

    # -- mode plug points ----------------------------------------------------

    def make_step_fns(self) -> Tuple[engine.FirstFn, engine.StepFn]:
        """Return (first_fn, step_fn), each taking (dg, aux, key, ...)."""
        raise NotImplementedError

    def _walk_aux(self):
        """Extra device state threaded to the step fns (e.g. alias tables)."""
        return ()

    def preprocess_transition_probs(self):
        """Build device-resident state ahead of walking.

        Default: materialize the device graph. PreComp modes additionally
        build their alias tables here (reference hook: ``pecanpy.py:231-238``).
        """
        self.get_device_graph()

    def _preprocess_transition_probs(self):
        if not self._preprocessed:
            self.preprocess_transition_probs()
            self._preprocessed = True

    # -- reference scalar-callback compat ------------------------------------

    def get_noise_thresholds(self) -> np.ndarray:
        """Per-node node2vec+ noise thresholds (``sparse_rw.py:22-35``)."""
        return np.asarray(self.get_device_graph().threshold)[:-1]

    def get_has_nbrs(self):
        """Scalar has-neighbors callback (reference: ``sparse_rw.py:12-20``).

        Provided for API parity; the batch engine checks degrees inline.
        """
        deg = np.asarray(self.get_device_graph().deg)

        def has_nbrs(idx: int) -> bool:
            return bool(deg[idx] > 0)

        return has_nbrs

    def get_move_forward(self):
        """Scalar single-step callback (reference: ``pecanpy.py:384-440``).

        Runs the batch-1 engine per call — useful for debugging and API
        parity, hopeless for throughput (use ``simulate_walks_device``).
        Each call consumes a fresh slice of the instance RNG stream.
        """
        self._preprocess_transition_probs()
        dg = self.get_device_graph()
        aux = self._walk_aux()
        first_fn, step_fn = self.make_step_fns()
        state = {"key": self._base_key(), "n": 0}

        def move_forward(cur_idx: int, prev_idx: Optional[int] = None) -> int:
            key = jax.random.fold_in(state["key"], state["n"])
            state["n"] += 1
            cur = jnp.asarray([cur_idx], dtype=jnp.int32)
            cur_rows = dg.gather_rows(cur)
            if prev_idx is None:
                nxt = first_fn(dg, aux, key, cur, cur_rows)
            else:
                prev = jnp.asarray([prev_idx], dtype=jnp.int32)
                prev_rows = dg.gather_rows(prev)
                nxt = step_fn(dg, aux, key, cur, prev, cur_rows, prev_rows)
            return int(nxt[0])

        return move_forward

    # -- walk driver ---------------------------------------------------------

    def _make_walk_runner(self, walk_length: int):
        """Build the (dg, aux, start, key) -> (walks, eff) walk callable.

        Default: the shared scan engine over this mode's step functions.
        Modes may override to pick a different engine (the OTF modes route
        hub graphs through ``engine.generate_walks_amortized``).
        """
        first_fn, step_fn = self.make_step_fns()

        def run(dg, aux, start, key):
            return engine.generate_walks(
                dg,
                lambda k, cur, rows: first_fn(dg, aux, k, cur, rows),
                lambda k, cur, prev, cr, pr: step_fn(
                    dg, aux, k, cur, prev, cr, pr
                ),
                start,
                key,
                walk_length,
            )

        return run

    def _get_walk_fn(self, walk_length: int):
        if walk_length not in self._walk_fn_cache:
            self._walk_fn_cache[walk_length] = jax.jit(
                self._make_walk_runner(walk_length)
            )
        return self._walk_fn_cache[walk_length]

    def _resolved_walker_batch(self) -> int:
        """Walker LANES per device dispatch; None resolves per graph type."""
        if self.walker_batch is not None:
            return self.walker_batch
        if self.get_device_graph().has_hubs:
            return DEFAULT_HUB_WALKER_BATCH
        return DEFAULT_WALKER_BATCH

    def _walk_queue_factor(self) -> int:
        """Walks per dispatch, in units of walker lanes (see the
        amortized-OTF mixin, which overrides this for hub graphs whose
        queued engine amortizes straggler tails across the dispatch)."""
        return 1

    def _seed(self) -> int:
        """Concrete seed for this instance, resolved exactly once.

        With ``random_state=None`` one entropy draw is pinned on first use,
        so every later pass (streaming vocab scan, each training epoch, the
        checkpoint-resume cursor replay) sees the identical start-node
        shuffle and key tree — the determinism contract ``_walk_chunks``
        documents holds regardless of how ``random_state`` was set.
        """
        if self._resolved_seed is None:
            if self.random_state is not None:
                self._resolved_seed = int(self.random_state)
            else:
                self._resolved_seed = int(
                    np.random.default_rng().integers(0, 2**31 - 1)
                )
        return self._resolved_seed

    def _start_nodes(self, num_walks: int) -> np.ndarray:
        """Every node repeated num_walks times, shuffled under the seed.

        Matches the reference start-node construction (``pecanpy.py:135-141``);
        the shuffle only permutes output order here (no load-balancing role),
        kept so walk *sets* line up across implementations.
        """
        nodes = np.arange(self.num_nodes, dtype=np.int32)
        starts = np.concatenate([nodes] * num_walks)
        np.random.seed(self._seed())
        np.random.shuffle(starts)
        return starts

    def _base_key(self) -> jax.Array:
        return jax.random.PRNGKey(self._seed())

    def _walk_chunks(self, num_walks: int, walk_length: int, base_key):
        """Yield (walks, eff_len) device chunks, deterministically.

        The same ``base_key`` reproduces the identical chunk stream —
        the contract the streaming trainer's two passes rely on.
        """
        self._preprocess_transition_probs()
        dg = self.get_device_graph()
        aux = self._walk_aux()
        walk_fn = self._get_walk_fn(walk_length)

        starts = self._start_nodes(num_walks)
        total = starts.size
        chunk = min(
            self._resolved_walker_batch() * self._walk_queue_factor(), total
        )
        n_chunks = -(-total // chunk)
        t0 = time.perf_counter()
        for i, lo in enumerate(range(0, total, chunk)):
            part = starts[lo : lo + chunk]
            pad = chunk - part.size
            if pad:
                part = np.pad(part, (0, pad))
            walks, eff = walk_fn(
                dg, aux, jnp.asarray(part), jax.random.fold_in(base_key, i)
            )
            if pad:
                walks, eff = walks[:-pad], eff[:-pad]
            if self.verbose and n_chunks > 1:
                done = min(lo + chunk, total)
                rate = done * walk_length / max(
                    time.perf_counter() - t0, 1e-9
                )
                print(
                    f"walks: chunk {i + 1}/{n_chunks} "
                    f"({done}/{total} walkers, {rate:.2e} steps/s)",
                    flush=True,
                )
            yield walks, eff

    def simulate_walks_device(
        self,
        num_walks: int,
        walk_length: int,
    ) -> Tuple[jax.Array, jax.Array]:
        """Generate all walks on device.

        Returns:
            walks: [num_walks * N, walk_length + 1] int32 node indices.
            eff_len: [num_walks * N] int32 effective walk lengths.
        """
        parts = list(
            self._walk_chunks(num_walks, walk_length, self._base_key())
        )
        if len(parts) == 1:
            return parts[0]
        return (
            jnp.concatenate([p[0] for p in parts]),
            jnp.concatenate([p[1] for p in parts]),
        )

    def simulate_walks(
        self,
        num_walks: int,
        walk_length: int,
    ) -> List[List[str]]:
        """Generate walks as lists of node-ID strings (reference API).

        Note: converting device walks to Python string lists is O(total
        walk tokens) host work — the reference has the same liability
        (``pecanpy.py:160``). Device consumers should use
        ``simulate_walks_device`` instead.
        """
        walks, eff_len = self.simulate_walks_device(num_walks, walk_length)
        walks = np.asarray(walks)
        eff_len = np.asarray(eff_len)
        ids = self.nodes
        return [
            [ids[node] for node in row[:n]] for row, n in zip(walks, eff_len)
        ]

    # -- embedding -----------------------------------------------------------

    # tokens above which embed() streams walks instead of storing them
    STREAMING_TOKEN_THRESHOLD = 100_000_000

    def embed(
        self,
        dim: int = 128,
        num_walks: int = 10,
        walk_length: int = 80,
        window_size: int = 10,
        epochs: int = 1,
        verbose: bool = False,
        streaming: Optional[bool] = None,
        table_dtype: str = "auto",
        n_devices: Optional[int] = None,
        model_parallel: int = 1,
        partition: str = "auto",
        batch_walks: Optional[int] = None,
        trainer: str = "device",
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 100,
        max_steps: Optional[int] = None,
    ) -> Embeddings:
        """Walks + on-device SGNS, returning graph-aligned embeddings.

        Matches the reference defaults and training recipe
        (``pecanpy.py:240-290``: skip-gram, negative sampling, min_count=0);
        row i of the result embeds node i.

        ``streaming=None`` auto-selects the two-pass streaming pipeline
        (walks regenerated, never stored — the walk engine is ~25x faster
        than training, so regeneration beats a multi-GB walk buffer) once
        the corpus exceeds ~1e8 tokens; pass True/False to force.

        ``n_devices > 1`` runs the fused multi-device pipeline
        (``parallel/train.py``): walkers data-parallel, embedding tables
        tensor-parallel over ``model_parallel`` shards. ``partition``
        picks the graph layout on that mesh: ``"replicated"`` (full
        table per device, collective-free walking), ``"edge"`` (table
        row-sharded over the data axis with collective row fetches —
        graphs bigger than one device's memory), or ``"auto"`` (default
        — edge once the tables exceed the per-device budget,
        ``utils/budget.py``). Both layouts train bit-identical
        embeddings for a given seed.

        ``trainer`` selects the SGNS implementation: ``"device"``
        (default; ``"tpu"`` is accepted as an alias) is the batched
        on-device trainer; ``"sequential"`` trains on the host with
        gensim's exact sequential loop (native C++, hogwild over
        ``self.workers`` threads) — the quality reference, at host CPU
        speed, intended for small graphs.

        ``checkpoint_dir`` snapshots the full training state (both
        tables + the step cursor) every ``checkpoint_every`` chunk-steps
        and resumes from the latest snapshot when one exists — the
        resumed trajectory is bit-identical to an uninterrupted run (a
        capability the reference lacks entirely, SURVEY §5).
        ``max_steps`` stops after that many chunk-steps (combine with
        checkpointing to split a long run across invocations; the lr
        schedule stays pinned to the full plan).
        """
        from pecanpy_tpu.models import sgns

        config = sgns.SGNSConfig(
            dim=dim,
            window=window_size,
            epochs=epochs,
            seed=self.random_state,
            table_dtype=table_dtype,
            batch_walks=batch_walks,
        )

        trainer = resolve_trainer(trainer)
        if partition not in ("auto", "replicated", "edge"):
            raise ValueError(
                f"unknown partition {partition!r}; use 'auto', "
                "'replicated', or 'edge'"
            )
        total_tokens = self.num_nodes * num_walks * (walk_length + 1)
        if trainer == "device" and epochs == 1 and total_tokens <= 5e7:
            # at small corpus scale the batched trainer's one-epoch
            # quality trails the sequential reference on the
            # BlogCatalog-shaped benchmark, and epochs=2 closes the gap.
            # Advisory only — same spirit as the CLI's check_mode
            # recommendations.
            import warnings

            warnings.warn(
                f"epochs=1 on a small corpus (~{total_tokens:.1e} tokens) "
                "leaves quality on the table: epochs=2 matches the "
                "sequential reference's micro-F1 at BlogCatalog scale for "
                "seconds of extra device compute",
                stacklevel=2,
            )
        sequential = trainer == "sequential"
        if sequential:
            if n_devices is not None and n_devices > 1:
                raise ValueError(
                    "trainer='sequential' runs on the host; it cannot be "
                    "combined with n_devices > 1"
                )
            if streaming:
                raise ValueError(
                    "trainer='sequential' trains on materialized host "
                    "walks; it cannot honor streaming=True (drop one of "
                    "the two)"
                )
            if checkpoint_dir is not None:
                raise ValueError(
                    "trainer='sequential' (the host gensim loop) has no "
                    "checkpoint/resume support; use the default device "
                    "trainer with checkpoint_dir"
                )
            seq_tokens = self.num_nodes * num_walks * (walk_length + 1)
            if seq_tokens > 5e7:
                import warnings

                warnings.warn(
                    f"trainer='sequential' trains ~{seq_tokens:.1e} "
                    "tokens on host CPU threads — expect minutes to "
                    "hours; the default device trainer is built for "
                    "this scale",
                    stacklevel=2,
                )

        if n_devices is not None and n_devices > 1:
            from pecanpy_tpu.parallel import mesh as mesh_lib
            from pecanpy_tpu.parallel import train as train_lib
            from pecanpy_tpu.parallel.train import (
                MultichipTrainer,
                train_streaming_multichip,
            )

            mesh = mesh_lib.make_mesh(
                n_devices, model_parallel=model_parallel
            )
            # build the fused layout host-side: the trainer lays it out on
            # the mesh itself (replicated, or row-sharded per chip under
            # partition="edge" — the full table never lands on one device)
            host_graph = self.get_host_graph()
            partition = train_lib.resolve_partition(
                partition,
                train_lib.graph_table_bytes(host_graph),
                mesh.shape[mesh_lib.DATA_AXIS],
                mode_supported=type(self).__name__
                in ("SparseOTF", "DenseOTF", "FirstOrderUnweighted"),
            )
            if verbose:
                print(f"multichip graph partition: {partition}", flush=True)
            trainer = MultichipTrainer(
                mesh=mesh,
                graph=host_graph,
                config=config,
                walk_length=walk_length,
                p=self.p,
                q=self.q,
                extend=self.extend,
                mode=type(self).__name__,
                partition=partition,
            )
            timed = Timer("multichip walks + training", verbose)(
                train_streaming_multichip
            )
            return timed(
                trainer,
                self._start_nodes(num_walks),
                epochs=epochs,
                seed=self._seed(),
                verbose=verbose,
                checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every,
                max_steps=max_steps,
            )

        if streaming is None:
            streaming = total_tokens > self.STREAMING_TOKEN_THRESHOLD
        if streaming and not sequential:
            base_key = self._base_key()

            def walk_chunks(_pass):
                return self._walk_chunks(num_walks, walk_length, base_key)

            timed = Timer("stream walks + train embeddings", verbose)(
                sgns.train_streaming
            )
            return np.asarray(
                timed(
                    walk_chunks,
                    self.num_nodes,
                    config,
                    verbose,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_every=checkpoint_every,
                    max_steps=max_steps,
                )
            )

        # materialized-walk tail, shared by the device and sequential
        # trainers
        timed_walk = Timer("generate walks", verbose)(self.simulate_walks_device)
        walks, eff_len = timed_walk(num_walks, walk_length)
        if sequential:
            timed_train = Timer("train embeddings (sequential)", verbose)(
                sgns.train_sequential
            )
            return timed_train(
                np.asarray(walks),
                np.asarray(eff_len),
                self.num_nodes,
                config,
                workers=self.workers,
                verbose=verbose,
            )
        timed_train = Timer("train embeddings", verbose)(sgns.train)
        embeddings = timed_train(
            walks,
            eff_len,
            self.num_nodes,
            config,
            verbose=verbose,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            max_steps=max_steps,
        )
        return np.asarray(embeddings)
