"""Backend-facing setup that runs identically on every backend: the
compile-cache placement, the device-memory budgets, the trainer name,
and the on-card smoke script's host-side pieces (graph builders,
edge-validity check, refusal to run without a GPU)."""
import os
import subprocess
import sys

import numpy as np
import pytest

import oracle
from pecanpy_tpu.utils import budget, cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- compile cache ---------------------------------------------------------


def test_cache_follows_env_var(monkeypatch):
    """A configured cache dir (JAX reads JAX_COMPILATION_CACHE_DIR into
    jax_compilation_cache_dir) is left alone: nothing is set in code."""
    monkeypatch.delenv("PECANPY_TPU_COMPILE_CACHE", raising=False)
    assert cache.cache_dir_to_set("gpu", "/elsewhere/xla") is None


def test_cache_fixed_path_inside_checkout(monkeypatch):
    monkeypatch.delenv("PECANPY_TPU_COMPILE_CACHE", raising=False)
    path = cache.cache_dir_to_set("gpu", None)
    assert path == cache.CHECKOUT_CACHE_DIR
    assert os.path.dirname(path) == ROOT
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("backend,configured,env", [
    ("cpu", None, None),  # XLA:CPU entries are host-specific
    ("gpu", None, "0"),  # explicit opt-out
])
def test_cache_sets_nothing(monkeypatch, backend, configured, env):
    if env is None:
        monkeypatch.delenv("PECANPY_TPU_COMPILE_CACHE", raising=False)
    else:
        monkeypatch.setenv("PECANPY_TPU_COMPILE_CACHE", env)
    assert cache.cache_dir_to_set(backend, configured) is None


# -- memory budgets ----------------------------------------------------------


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _fake_devices(monkeypatch, stats):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeDevice(stats)])


ALL_BUDGETS = [budget.REPLICATED, budget.FUSED, budget.CDF, budget.WALK_CACHE]


@pytest.mark.parametrize("b", ALL_BUDGETS, ids=lambda b: b.env)
def test_budget_is_share_of_device_memory(monkeypatch, b):
    monkeypatch.delenv(b.env, raising=False)
    _fake_devices(monkeypatch, {"bytes_limit": 60 << 30, "bytes_in_use": 0})
    assert budget.budget_bytes(b) == int((60 << 30) * b.share)


@pytest.mark.parametrize("b", ALL_BUDGETS, ids=lambda b: b.env)
def test_budget_env_override_and_fallback(monkeypatch, b):
    _fake_devices(monkeypatch, None)  # the CPU reports no memory stats
    monkeypatch.delenv(b.env, raising=False)
    assert budget.budget_bytes(b) == b.fallback_mb << 20
    monkeypatch.setenv(b.env, "3")
    _fake_devices(monkeypatch, {"bytes_limit": 60 << 30})
    assert budget.budget_bytes(b) == 3 << 20


def test_partition_auto_follows_device_memory(monkeypatch):
    from pecanpy_tpu.parallel.train import resolve_partition

    monkeypatch.delenv(budget.REPLICATED.env, raising=False)
    _fake_devices(monkeypatch, {"bytes_limit": 8 << 30})  # 4 GiB budget
    assert resolve_partition("auto", 3 << 30, 4) == "replicated"
    assert resolve_partition("auto", 5 << 30, 4) == "edge"


# -- trainer name --------------------------------------------------------------


def test_trainer_tpu_is_an_alias_of_device():
    from pecanpy_tpu.models.base import resolve_trainer

    assert resolve_trainer("tpu") == "device"
    assert resolve_trainer("device") == "device"
    assert resolve_trainer("sequential") == "sequential"
    with pytest.raises(ValueError, match="unknown trainer"):
        resolve_trainer("gpu")


def test_embed_trainer_alias_trains_identically():
    from pecanpy_tpu import pecanpy

    adj = oracle.random_graph(np.random.default_rng(2), 16, 4.0)
    ids = [str(i) for i in range(16)]
    out = [
        pecanpy.SparseOTF.from_mat(adj, ids, random_state=1).embed(
            dim=8, num_walks=2, walk_length=6, window_size=2, epochs=2,
            trainer=t,
        )
        for t in ("tpu", "device")
    ]
    np.testing.assert_array_equal(out[0], out[1])


# -- chip_smoke.py host-side pieces --------------------------------------------


def test_chip_smoke_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


def test_chip_smoke_graph_builders():
    cs = _chip_smoke()
    indptr, indices, data = cs.uniform_graph(500)
    assert indptr.size == 501 and indices.size == data.size == indptr[-1]
    assert (data >= 0.5).all() and (data <= 2.0).all()
    rows = np.repeat(np.arange(500), np.diff(indptr))
    assert all(
        np.all(np.diff(indices[indptr[i]:indptr[i + 1]]) > 0)
        for i in range(500)
    )
    # undirected: every arc has its reverse
    fwd = set(zip(rows.tolist(), indices.tolist()))
    assert all((v, u) in fwd for u, v in fwd)
    pl_indptr, _, _ = cs.powerlaw_graph(5000)
    deg = np.diff(pl_indptr)
    assert deg.max() > 20 * np.median(deg)  # heavy tail: hubs exist


def test_chip_smoke_edge_check_counts_non_edges(rng):
    from pecanpy_tpu import pecanpy

    cs = _chip_smoke()
    indptr, indices, data = cs.uniform_graph(300)
    g = cs.mode_from_csr(pecanpy.SparseOTF, indptr, indices, data,
                         p=0.5, q=2.0, random_state=0)
    walks, eff = g.simulate_walks_device(2, 12)
    walks, eff = np.array(walks), np.asarray(eff)
    assert cs.bad_steps(indptr, indices, walks, eff) == 0
    # break one step inside a walk's effective length
    w = int(np.nonzero(eff > 3)[0][0])
    a = walks[w, 1]
    non_nbr = next(
        x for x in range(300)
        if x != a and x not in indices[indptr[a]:indptr[a + 1]]
    )
    walks[w, 2] = non_nbr
    assert cs.bad_steps(indptr, indices, walks, eff) >= 1


def test_csr_oracle_matches_dense_oracle(rng):
    adj = oracle.random_graph(rng, 30, mean_degree=6.0)
    rows, cols = np.nonzero(adj)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=30))])
    data = adj[rows, cols]
    for c in range(30):
        for pv in np.nonzero(adj[c])[0]:
            found, probs = oracle.node2vec_probs_csr(
                indptr, cols, data, c, pv, 0.5, 2.0
            )
            np.testing.assert_allclose(
                probs, oracle.node2vec_probs(adj, c, pv, 0.5, 2.0)
            )
            nbr = np.nonzero(adj[c])[0]
            np.testing.assert_array_equal(found, adj[pv, nbr] != 0)
