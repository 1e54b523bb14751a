"""Sphinx configuration (autodoc over the pecanpy_tpu package).

Build: pip install sphinx sphinx-rtd-theme && sphinx-build -b html
docs/source docs/_build (CI/RTD; sphinx is not baked into the dev image).
"""
import os
import sys

sys.path.insert(0, os.path.abspath("../.."))

project = "pecanpy-tpu"
author = "pecanpy-tpu developers"
release = "0.1.0"

extensions = [
    "sphinx.ext.autodoc",
    "sphinx.ext.napoleon",
    "sphinx.ext.viewcode",
]
autodoc_member_order = "bysource"
autodoc_mock_imports = ["jax", "jaxlib"]
html_theme = "sphinx_rtd_theme"
