"""Device-memory budgets, derived from the device the program runs on.

Each budget is a share of the first device's memory limit
(``memory_stats()["bytes_limit"]``: what this process may allocate on
the card). A backend that reports no limit (the CPU) gets the fixed
fallback. The ``PECANPY_TPU_*_MB`` environment variable of each budget
overrides both, in MiB.
"""
import dataclasses
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Budget:
    env: str  # override, in MiB
    share: float  # of the device's memory limit
    fallback_mb: int  # when the backend reports no limit


# graph tables above this replicate no more; ``partition="auto"`` shards
# them across the mesh (``parallel/train.py``)
REPLICATED = Budget("PECANPY_TPU_REPLICATED_BUDGET_MB", 0.5, 8192)
# an uncapped fused layout past this is refused (``ops/layout.py``)
FUSED = Budget("PECANPY_TPU_FUSED_BUDGET_MB", 0.5, 8192)
# hub graphs carry the first-order CDF channel up to this
# (``models/modes.py``)
CDF = Budget("PECANPY_TPU_CDF_BUDGET_MB", 0.125, 2048)
# the streaming trainer caches walks on device up to this
# (``models/sgns.py``)
WALK_CACHE = Budget("PECANPY_TPU_WALK_CACHE_MB", 0.25, 4096)


def device_memory_limit() -> Optional[int]:
    """Bytes this process may allocate on the first device, if reported."""
    import jax

    stats = jax.devices()[0].memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


def budget_bytes(budget: Budget) -> int:
    """The budget in bytes: env override, else share of the device."""
    raw = os.environ.get(budget.env)
    if raw is not None:
        return int(raw) * (1 << 20)
    limit = device_memory_limit()
    if limit is None:
        return budget.fallback_mb * (1 << 20)
    return int(limit * budget.share)
