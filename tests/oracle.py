"""Scalar numpy oracle of the reference transition math.

Implements the exact per-node transition-probability definitions from the
reference (``src/pecanpy/rw/sparse_rw.py``, ``rw/dense_rw.py``,
``experimental.py``) as straightforward dense numpy code. Used as ground
truth for the batched device kernels: the kernels must reproduce these
distributions to float tolerance on every (cur, prev) pair.
"""
import numpy as np


def noise_thresholds(adj: np.ndarray, gamma: float) -> np.ndarray:
    """Per-node mean + gamma * std of outgoing edge weights, clipped >= 0."""
    n = adj.shape[0]
    out = np.zeros(n, dtype=np.float64)
    for i in range(n):
        w = adj[i][adj[i] != 0]
        if w.size:
            out[i] = w.mean() + gamma * w.std()
    return np.maximum(out, 0.0)


def first_order_probs(adj: np.ndarray, cur: int) -> np.ndarray:
    """1st-order probs over cur's neighbor list (ascending order)."""
    w = adj[cur][adj[cur] != 0]
    return w / w.sum()


def node2vec_probs(
    adj: np.ndarray, cur: int, prev: int, p: float, q: float
) -> np.ndarray:
    """node2vec 2nd-order probs over cur's neighbors (ascending order)."""
    nbr_mask = adj[cur] != 0
    w = adj[cur].astype(np.float64).copy()
    out = nbr_mask & (adj[prev] == 0)
    out[prev] = False
    w[out] /= q
    w[prev] /= p
    w = w[nbr_mask]
    return w / w.sum()


def node2vec_probs_csr(indptr, indices, data, cur: int, prev: int,
                       p: float, q: float):
    """``node2vec_probs`` on a CSR graph (rows sorted ascending).

    Returns (membership, probs) over cur's neighbors: ``membership[i]``
    says whether cur's i-th neighbor is also a neighbor of prev.
    """
    nbr = indices[indptr[cur]:indptr[cur + 1]]
    w = data[indptr[cur]:indptr[cur + 1]].astype(np.float64)
    found = np.isin(nbr, indices[indptr[prev]:indptr[prev + 1]])
    is_prev = nbr == prev
    w = np.where(~found & ~is_prev, w / q, w)
    w = np.where(is_prev, w / p, w)
    return found, w / w.sum()


def node2vec_plus_probs(
    adj: np.ndarray,
    cur: int,
    prev: int,
    p: float,
    q: float,
    gamma: float,
) -> np.ndarray:
    """node2vec+ probs (sparse-kernel semantics, ``sparse_rw.py:93-130``)."""
    theta = noise_thresholds(adj, gamma)
    nbr_mask = adj[cur] != 0
    w = adj[cur].astype(np.float64).copy()

    prev_w = adj[prev].astype(np.float64)
    common = nbr_mask & (prev_w != 0)
    # out edges: non-neighbors of prev, plus loosely-connected common nbrs
    out = nbr_mask & ~common
    t = np.zeros(adj.shape[0])
    loose = common & (prev_w < theta)
    out |= loose
    t[loose] = prev_w[loose] / theta[loose]
    out[prev] = False

    alpha = 1.0 / q + (1.0 - 1.0 / q) * t
    noisy = w < theta[cur]
    alpha = np.where(noisy, min(1.0, 1.0 / q), alpha)
    w[out] *= alpha[out]
    w[prev] /= p
    w = w[nbr_mask]
    return w / w.sum()


def node2vec_pp_probs(
    adj: np.ndarray,
    cur: int,
    prev: int,
    p: float,
    q: float,
    gamma: float,
) -> np.ndarray:
    """node2vec++ probs (``experimental.py:61-102``, dense semantics)."""
    theta = noise_thresholds(adj, gamma)
    nbr_mask = adj[cur] != 0
    w = adj[cur].astype(np.float64).copy()
    prev_w = adj[prev].astype(np.float64)

    out = nbr_mask & (prev_w < theta)
    out[prev] = False

    t = np.clip(prev_w / np.maximum(theta, 1e-300), 0, 1)
    t = 1.0 - t if q < 1 else t
    b = w / np.maximum(theta, 1e-300)
    scale = abs(1.0 - 1.0 / q)
    offset = min(1.0, 1.0 / q)
    alpha = t * b / np.maximum(1.0 + (b - 1.0), 1e-300) * scale + offset

    w[out] *= alpha[out]
    w[prev] /= p
    w = w[nbr_mask]
    return w / w.sum()


def transition_matrix_first_order(adj: np.ndarray) -> np.ndarray:
    """[N, N] first-order transition matrix (rows of isolated nodes = 0)."""
    n = adj.shape[0]
    mat = np.zeros((n, n))
    for i in range(n):
        nbrs = np.nonzero(adj[i])[0]
        if nbrs.size:
            mat[i, nbrs] = first_order_probs(adj, i)
    return mat


def random_graph(
    rng: np.random.Generator,
    n: int,
    mean_degree: float = 4.0,
    weighted: bool = True,
    directed: bool = False,
) -> np.ndarray:
    """Random positive-weighted adjacency matrix with no self loops."""
    prob = min(mean_degree / max(n - 1, 1), 1.0)
    mask = rng.random((n, n)) < prob
    np.fill_diagonal(mask, False)
    weights = rng.uniform(0.2, 3.0, size=(n, n)) if weighted else np.ones((n, n))
    adj = np.where(mask, weights, 0.0)
    if not directed:
        upper = np.triu(adj)
        adj = upper + upper.T
    return adj
