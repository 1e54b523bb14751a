"""Checkpoint/resume through the PUBLIC surfaces (embed() and the CLI).

The trainer-level resume bit-equality is pinned by tests/test_sgns.py
and tests/test_parallel.py; these tests pin the round-5 plumbing: the
same capability reachable from ``Base.embed()`` and the ``pecanpy-tpu``
CLI, plus the RNG-scheme version guard on stale checkpoints.
"""
import numpy as np
import pytest

from pecanpy_tpu import cli, pecanpy


def _toy_adj(n=24, seed=3):
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < 0.25
    np.fill_diagonal(mask, False)
    upper = np.triu(np.where(mask, rng.uniform(0.5, 2.0, (n, n)), 0.0))
    adj = upper + upper.T
    for i in range(n):  # no isolated nodes
        if adj[i].sum() == 0:
            j = (i + 1) % n
            adj[i, j] = adj[j, i] = 1.0
    return adj


EMBED_KW = dict(
    dim=8, num_walks=2, walk_length=5, window_size=3, epochs=2,
    table_dtype="float32",
)


def _graph():
    adj = _toy_adj()
    ids = [str(i) for i in range(adj.shape[0])]
    return pecanpy.SparseOTF.from_mat(adj, ids, p=0.5, q=2.0, random_state=7)


def test_embed_checkpoint_resume_bit_identical(tmp_path):
    full = _graph().embed(**EMBED_KW)

    ckdir = str(tmp_path / "ck")
    partial = _graph().embed(
        **EMBED_KW, checkpoint_dir=ckdir, checkpoint_every=1, max_steps=1
    )
    assert not np.array_equal(partial, full)  # genuinely interrupted
    resumed = _graph().embed(
        **EMBED_KW, checkpoint_dir=ckdir, checkpoint_every=1
    )
    np.testing.assert_array_equal(resumed, full)


def test_embed_sequential_rejects_checkpoint_and_streaming(tmp_path):
    g = _graph()
    with pytest.raises(ValueError, match="checkpoint"):
        g.embed(
            **EMBED_KW, trainer="sequential",
            checkpoint_dir=str(tmp_path / "x"),
        )
    with pytest.raises(ValueError, match="streaming"):
        g.embed(**EMBED_KW, trainer="sequential", streaming=True)


def test_cli_kill_and_resume_bit_identical(tmp_path, karate_edg):
    common = [
        "--input", karate_edg, "--mode", "SparseOTF",
        "--p", "0.5", "--q", "2",
        "--dimensions", "8", "--walk-length", "5", "--num-walks", "2",
        "--window-size", "3", "--epochs", "2", "--random_state", "7",
        "--table-dtype", "float32",
    ]
    out_full = str(tmp_path / "full.emb.npz")
    cli.main(common + ["--output", out_full])

    ckdir = str(tmp_path / "ck")
    out_partial = str(tmp_path / "partial.emb.npz")
    cli.main(
        common
        + [
            "--output", out_partial, "--checkpoint-dir", ckdir,
            "--checkpoint-every", "1", "--max-steps", "1",
        ]
    )
    out_resumed = str(tmp_path / "resumed.emb.npz")
    cli.main(
        common
        + [
            "--output", out_resumed, "--checkpoint-dir", ckdir,
            "--checkpoint-every", "1",
        ]
    )
    full = np.load(out_full)["data"]
    partial = np.load(out_partial)["data"]
    resumed = np.load(out_resumed)["data"]
    assert not np.array_equal(partial, full)
    np.testing.assert_array_equal(resumed, full)


def test_rng_scheme_mismatch_refuses_resume(tmp_path):
    from pecanpy_tpu.models import sgns
    from pecanpy_tpu.utils.checkpoint import SGNSCheckpointer

    n, dim = 16, 8
    ckdir = str(tmp_path / "stale")
    ck = SGNSCheckpointer(ckdir)
    ck.save(
        1,
        np.zeros((n, dim), np.float32),
        np.zeros((n, dim), np.float32),
        {"next_step": 1, "rng_scheme": "some-older-scheme"},
    )

    walks = np.tile(np.arange(6, dtype=np.int32), (8, 1)) % n
    eff = np.full(8, 6, dtype=np.int32)
    config = sgns.SGNSConfig(dim=dim, window=2, seed=0, table_dtype="float32")
    with pytest.raises(ValueError, match="RNG scheme"):
        sgns.train(walks, eff, n, config, checkpoint_dir=ckdir)


def test_checkpoint_files_roundtrip_and_prune(tmp_path):
    """npz snapshots: tables and JSON meta round-trip exactly, only the
    newest ``max_to_keep`` survive, and no temporary file is left."""
    import os

    from pecanpy_tpu.utils.checkpoint import SGNSCheckpointer

    ck = SGNSCheckpointer(str(tmp_path / "ck"), max_to_keep=2)
    assert ck.latest_step() is None
    rng = np.random.default_rng(0)
    tables = {}
    for step in (1, 2, 3):
        w_in = rng.normal(size=(5, 4)).astype(np.float32)
        w_out = rng.normal(size=(5, 4)).astype(np.float32)
        tables[step] = (w_in, w_out)
        ck.save(step, w_in, w_out, {"next_step": step, "rng_scheme": "s-v1"})
    assert ck.steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2.npz", "step_3.npz"]
    w_in, w_out, meta = ck.restore()
    np.testing.assert_array_equal(w_in, tables[3][0])
    np.testing.assert_array_equal(w_out, tables[3][1])
    assert meta == {"next_step": 3, "rng_scheme": "s-v1"}
    assert ck.restore(2)[2]["next_step"] == 2
    with pytest.raises(FileNotFoundError):
        SGNSCheckpointer(str(tmp_path / "empty")).restore()
