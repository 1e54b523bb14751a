"""Test configuration: force CPU backend with 8 virtual devices.

Must run before jax initializes so sharding tests see a multi-device mesh.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# pin CPU after import as well: the session must never reach a GPU, even
# where JAX_PLATFORMS was set to something else before the setdefault
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def karate_edg() -> str:
    """In-repo copy of the public-domain Zachary karate club edgelist."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "demo",
        "karate.edg",
    )


@pytest.fixture()
def rng() -> np.random.Generator:
    return np.random.default_rng(0)
