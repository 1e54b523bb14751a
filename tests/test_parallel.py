"""Multi-device tests on the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import oracle
from pecanpy_tpu.models.sgns import SGNSConfig
from pecanpy_tpu.ops.layout import device_csr_from_dense
from pecanpy_tpu.parallel import mesh as mesh_lib
from pecanpy_tpu.parallel.train import MultichipTrainer


@pytest.fixture(scope="module")
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jax.devices()[:8]


def test_make_mesh_shapes(eight_devices):
    m = mesh_lib.make_mesh(8, model_parallel=2)
    assert m.shape == {"data": 4, "model": 2}
    m1 = mesh_lib.make_mesh(8)
    assert m1.shape == {"data": 8, "model": 1}
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(8, model_parallel=3)


def test_multichip_fused_step(eight_devices, rng):
    adj = oracle.random_graph(rng, 32, mean_degree=4.0)
    graph = device_csr_from_dense(adj)
    m = mesh_lib.make_mesh(8, model_parallel=2)
    config = SGNSConfig(dim=16, window=3, negative=2, seed=0)
    trainer = MultichipTrainer(
        mesh=m, graph=graph, config=config, walk_length=8, p=0.5, q=2.0
    )
    key = jax.random.PRNGKey(0)
    w_in, w_out = trainer.init_params(key)
    assert w_in.sharding.spec == jax.sharding.PartitionSpec(None, "model")

    keep_prob = jnp.ones(32)
    neg_table = jnp.arange(32, dtype=jnp.int32)  # uniform negatives
    starts = trainer.shard_batch(np.arange(32, dtype=np.int32).repeat(2))

    w_in2, w_out2 = trainer.step(
        w_in, w_out, starts, keep_prob, neg_table, 0.025, key
    )
    # tables are exactly [N, dim]
    assert w_in2.shape == (32, 16)
    assert np.isfinite(np.asarray(w_in2)).all()
    # training moved the parameters
    assert float(jnp.abs(w_out2).sum()) > 0.0


def test_sharded_walks_match_semantics(eight_devices, rng):
    """Sharded walk batches still follow graph edges."""
    adj = oracle.random_graph(rng, 16, mean_degree=4.0)
    graph = device_csr_from_dense(adj)
    m = mesh_lib.make_mesh(8)
    config = SGNSConfig(dim=8, window=2, negative=2, seed=0)
    trainer = MultichipTrainer(mesh=m, graph=graph, config=config, walk_length=5)

    from pecanpy_tpu.models import engine
    from pecanpy_tpu.ops import sampling, transition

    def first_fn(k, cur, cur_rows):
        w = transition.first_order_weights_rows(trainer.graph, cur_rows)
        c = sampling.categorical_rows(k, w)
        return sampling.pick_int_columns(trainer.graph.rows_nbr(cur_rows), c)

    def step_fn(k, cur, prev, cur_rows, prev_rows):
        w = transition.node2vec_weights_rows(
            trainer.graph, cur_rows, prev_rows, prev, 1.0, 1.0
        )
        c = sampling.categorical_rows(k, w)
        return sampling.pick_int_columns(trainer.graph.rows_nbr(cur_rows), c)

    starts = trainer.shard_batch(np.tile(np.arange(16, dtype=np.int32), 4))
    walks, eff = jax.jit(
        lambda s, k: engine.generate_walks(
            trainer.graph, first_fn, step_fn, s, k, 5
        )
    )(starts, jax.random.PRNGKey(1))
    walks, eff = np.asarray(walks), np.asarray(eff)
    for row, n in zip(walks, eff):
        for a, b in zip(row[: n - 1], row[1:n]):
            assert adj[a, b] != 0


def test_multichip_hub_graph_step(eight_devices, rng):
    """Hub-marker graphs train on the mesh via the rejection path."""
    adj = oracle.random_graph(rng, 24, mean_degree=8.0, weighted=True)
    graph = device_csr_from_dense(adj, degree_cap=4)
    assert graph.has_hubs
    m = mesh_lib.make_mesh(8, model_parallel=2)
    config = SGNSConfig(dim=16, window=3, negative=2, seed=0)
    trainer = MultichipTrainer(
        mesh=m, graph=graph, config=config, walk_length=6, p=0.5, q=2.0
    )
    key = jax.random.PRNGKey(0)
    w_in, w_out = trainer.init_params(key)
    starts = trainer.shard_batch(np.arange(24, dtype=np.int32).repeat(2))
    w_in, w_out = trainer.step(
        w_in, w_out, starts, jnp.ones(24), jnp.arange(24, dtype=jnp.int32),
        0.025, key,
    )
    assert np.isfinite(np.asarray(w_in)).all()
    assert float(jnp.abs(np.asarray(w_out)).sum()) > 0.0


def test_multichip_count_tokens(eight_devices, rng):
    adj = oracle.random_graph(rng, 16, mean_degree=4.0)
    graph = device_csr_from_dense(adj)
    m = mesh_lib.make_mesh(8)
    config = SGNSConfig(dim=8, window=2, negative=2, seed=0)
    trainer = MultichipTrainer(
        mesh=m, graph=graph, config=config, walk_length=5
    )
    starts = np.tile(np.arange(16, dtype=np.int32), 4)
    counts = np.asarray(
        trainer.count_tokens(starts, jax.random.PRNGKey(0))
    )
    # every walk contributes between 1 and walk_length+1 tokens
    assert counts.sum() >= starts.size
    assert counts.sum() <= starts.size * 6


def test_multichip_embed_end_to_end(eight_devices, rng):
    from pecanpy_tpu import pecanpy

    adj = oracle.random_graph(rng, 20, mean_degree=5.0, weighted=True)
    ids = [str(i) for i in range(20)]
    g = pecanpy.SparseOTF.from_mat(adj, ids, p=0.5, q=2.0, random_state=3)
    emb = g.embed(
        dim=16, num_walks=4, walk_length=8, window_size=3,
        n_devices=8, model_parallel=2,
    )
    assert emb.shape == (20, 16)
    assert np.isfinite(emb).all()
    assert emb.std() > 0.0


def test_multichip_cli_devices(eight_devices, tmp_path, karate_edg):
    from pecanpy_tpu import cli

    out = tmp_path / "k.emb.npz"
    cli.main([
        "--input", karate_edg, "--output", str(out),
        "--dimensions", "8", "--walk-length", "5", "--num-walks", "2",
        "--window-size", "3", "--random_state", "0",
        "--devices", "8", "--model-parallel", "2",
    ])
    z = np.load(out)
    assert z["data"].shape == (34, 8)
    assert np.isfinite(z["data"]).all()


def test_multichip_streaming_checkpoint_resume(eight_devices, rng, tmp_path):
    """The mesh streaming trainer resumes from a snapshot: a fresh run and
    an interrupted+resumed run produce identical embeddings."""
    from pecanpy_tpu.parallel.train import train_streaming_multichip

    adj = oracle.random_graph(rng, 20, mean_degree=5.0, weighted=True)
    graph = device_csr_from_dense(adj)
    m = mesh_lib.make_mesh(8, model_parallel=2)
    config = SGNSConfig(dim=16, window=3, negative=2, seed=0)
    starts = np.tile(np.arange(20, dtype=np.int32), 6)

    def trainer():
        return MultichipTrainer(
            mesh=m, graph=graph, config=config, walk_length=6, p=0.5, q=2.0
        )

    full = train_streaming_multichip(
        trainer(), starts, epochs=2, seed=5, batch=40
    )
    ckpt_dir = str(tmp_path / "ck")
    # interrupted run (same 2-epoch plan, stopped after 3 steps),
    # snapshotting every step; then resume to completion
    train_streaming_multichip(
        trainer(), starts, epochs=2, seed=5, batch=40,
        checkpoint_dir=ckpt_dir, checkpoint_every=1, max_steps=3,
    )
    resumed = train_streaming_multichip(
        trainer(), starts, epochs=2, seed=5, batch=40,
        checkpoint_dir=ckpt_dir, checkpoint_every=1,
    )
    np.testing.assert_allclose(full, resumed, atol=1e-6)


# -- edge-partitioned training (graph row-sharded over the data axis) -----


def test_resolve_partition(monkeypatch):
    from pecanpy_tpu.parallel.train import resolve_partition

    monkeypatch.setenv("PECANPY_TPU_REPLICATED_BUDGET_MB", "1")
    assert resolve_partition("auto", 2 * 2**20, 8) == "edge"
    # a single data shard cannot partition
    assert resolve_partition("auto", 2 * 2**20, 1) == "replicated"
    # unsupported modes (PreComp family) always replicate
    assert (
        resolve_partition("auto", 2 * 2**20, 8, mode_supported=False)
        == "replicated"
    )
    # explicit choices pass through untouched
    assert resolve_partition("replicated", 10**15, 8) == "replicated"
    assert resolve_partition("edge", 0, 8) == "edge"
    monkeypatch.setenv("PECANPY_TPU_REPLICATED_BUDGET_MB", "4096")
    assert resolve_partition("auto", 2 * 2**20, 8) == "replicated"


def _one_step(trainer, n, key):
    w_in, w_out = trainer.init_params(key)
    starts = trainer.shard_batch(np.arange(n, dtype=np.int32).repeat(2))
    w_in, w_out = trainer.step(
        w_in, w_out, starts, jnp.ones(n), jnp.arange(n, dtype=jnp.int32),
        0.025, key,
    )
    return np.asarray(w_in), np.asarray(w_out)


def test_edge_partition_step_bitwise_matches_replicated(eight_devices, rng):
    """The edge partition changes WHERE graph rows live, never which rows
    come back: one fused walk+SGNS step is bit-identical across layouts."""
    adj = oracle.random_graph(rng, 32, mean_degree=4.0, weighted=True)
    graph = device_csr_from_dense(adj)
    m = mesh_lib.make_mesh(8, model_parallel=2)
    config = SGNSConfig(dim=16, window=3, negative=2, seed=0)
    kwargs = dict(
        mesh=m, graph=graph, config=config, walk_length=8, p=0.5, q=2.0
    )
    key = jax.random.PRNGKey(0)
    rep = _one_step(MultichipTrainer(**kwargs), 32, key)
    edge = _one_step(
        MultichipTrainer(**kwargs, partition="edge"), 32, key
    )
    np.testing.assert_array_equal(rep[0], edge[0])
    np.testing.assert_array_equal(rep[1], edge[1])


def test_edge_partition_hub_step_matches_replicated(eight_devices, rng):
    """Hub graphs: the rejection sampler's trial fetches go collective
    (psum-synced sweep loop) and still reproduce the replicated walks."""
    adj = oracle.random_graph(rng, 24, mean_degree=8.0, weighted=True)
    graph = device_csr_from_dense(adj, degree_cap=4)
    assert graph.has_hubs
    m = mesh_lib.make_mesh(8, model_parallel=2)
    config = SGNSConfig(dim=16, window=3, negative=2, seed=0)
    kwargs = dict(
        mesh=m, graph=graph, config=config, walk_length=6, p=0.5, q=2.0
    )
    key = jax.random.PRNGKey(3)
    rep = _one_step(MultichipTrainer(**kwargs), 24, key)
    edge = _one_step(
        MultichipTrainer(**kwargs, partition="edge"), 24, key
    )
    np.testing.assert_array_equal(rep[0], edge[0])
    np.testing.assert_array_equal(rep[1], edge[1])


def test_edge_partition_count_tokens_matches(eight_devices, rng):
    adj = oracle.random_graph(rng, 16, mean_degree=4.0)
    graph = device_csr_from_dense(adj)
    m = mesh_lib.make_mesh(8)
    config = SGNSConfig(dim=8, window=2, negative=2, seed=0)
    kwargs = dict(mesh=m, graph=graph, config=config, walk_length=5)
    starts = np.tile(np.arange(16, dtype=np.int32), 4)
    key = jax.random.PRNGKey(0)
    c_rep = np.asarray(
        MultichipTrainer(**kwargs).count_tokens(starts, key)
    )
    c_edge = np.asarray(
        MultichipTrainer(**kwargs, partition="edge").count_tokens(
            starts, key
        )
    )
    np.testing.assert_array_equal(c_rep, c_edge)


def test_edge_partition_rejects_precomp(eight_devices, rng):
    adj = oracle.random_graph(rng, 16, mean_degree=4.0)
    graph = device_csr_from_dense(adj)
    m = mesh_lib.make_mesh(8)
    with pytest.raises(ValueError, match="edge"):
        MultichipTrainer(
            mesh=m, graph=graph, config=SGNSConfig(dim=8, seed=0),
            walk_length=5, mode="PreComp", partition="edge",
        )


def test_embed_edge_partition_matches_replicated(eight_devices, rng):
    from pecanpy_tpu import pecanpy

    adj = oracle.random_graph(rng, 20, mean_degree=5.0, weighted=True)
    ids = [str(i) for i in range(20)]

    def run(partition):
        g = pecanpy.SparseOTF.from_mat(adj, ids, p=0.5, q=2.0, random_state=7)
        return g.embed(
            dim=16, num_walks=4, walk_length=8, window_size=3,
            n_devices=8, model_parallel=2, partition=partition,
        )

    rep, edge = run("replicated"), run("edge")
    assert np.isfinite(edge).all() and edge.std() > 0.0
    np.testing.assert_array_equal(rep, edge)


def test_embed_auto_partition_oversized_graph(
    eight_devices, rng, monkeypatch, capsys
):
    """End-to-end: a graph whose tables exceed the (forced tiny)
    replication budget auto-selects the edge partition and still trains
    community-recovering embeddings."""
    from pecanpy_tpu import pecanpy
    from test_downstream import micro_f1_nearest_centroid, sbm_graph

    monkeypatch.setenv("PECANPY_TPU_REPLICATED_BUDGET_MB", "0")
    adj, labels = sbm_graph(rng, blocks=4, per_block=30)
    ids = [str(i) for i in range(adj.shape[0])]
    g = pecanpy.SparseOTF.from_mat(adj, ids, random_state=0)
    emb = g.embed(
        dim=32, num_walks=6, walk_length=20, window_size=5, epochs=3,
        n_devices=8, verbose=True,
    )
    assert "partition: edge" in capsys.readouterr().out
    f1 = micro_f1_nearest_centroid(emb, labels, rng)
    assert f1 >= 0.8, f"micro-F1 {f1:.3f} below 0.8"


def test_multichip_cli_partition_edge(eight_devices, tmp_path, karate_edg):
    from pecanpy_tpu import cli

    out = tmp_path / "k_edge.emb.npz"
    cli.main([
        "--input", karate_edg, "--output", str(out),
        "--dimensions", "8", "--walk-length", "5", "--num-walks", "2",
        "--window-size", "3", "--random_state", "0",
        "--devices", "8", "--partition", "edge",
    ])
    z = np.load(out)
    assert z["data"].shape == (34, 8)
    assert np.isfinite(z["data"]).all()
