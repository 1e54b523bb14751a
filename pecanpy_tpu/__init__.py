"""pecanpy-tpu: an accelerator-native node2vec(+) framework.

A from-scratch reimplementation of the capabilities of PecanPy
(krishnanlab/PecanPy) for accelerators (an NVIDIA GPU today): batched,
vectorized random walk generation via JAX/XLA (``lax.scan`` over walk
steps, thousands of simultaneous walkers), exact rejection sampling for
hub nodes, and an on-device skip-gram-with-negative-sampling (SGNS)
trainer replacing gensim.

Public surface mirrors the reference package layout
(``/root/reference/src/pecanpy/__init__.py``):

    >>> from pecanpy_tpu import pecanpy
    >>> g = pecanpy.SparseOTF(p=1, q=1)
    >>> g.read_edg("karate.edg", weighted=False, directed=False)
    >>> emb = g.embed(dim=128)
"""

from pecanpy_tpu import graph  # noqa: F401
from pecanpy_tpu import pecanpy  # noqa: F401

__version__ = "0.1.0"
__all__ = ["graph", "pecanpy", "__version__"]
