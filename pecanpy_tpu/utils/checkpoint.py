"""SGNS training checkpoint/resume.

The reference has no training checkpointing (SURVEY §5: its only
persistence is graph-format conversion and the final embedding file). For
large embedding runs, interruptible training matters, so the SGNS trainer
can periodically snapshot its full state — both [N, dim] embedding
tables plus the scalar training cursor — and resume mid-epoch.

Format: one ``step_<n>.npz`` per snapshot holding ``w_in``, ``w_out``
and ``meta`` (a JSON document as UTF-8 bytes). Each file is written to
a temporary name, flushed to disk, then renamed into place, so a crash
mid-save never leaves a partial snapshot under a step name.
"""
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

_NAME = re.compile(r"^step_(\d+)\.npz$")


def verify_rng_scheme(meta: Dict[str, Any], expected: str) -> None:
    """Refuse to resume across an RNG-stream derivation change.

    Each trainer stamps its checkpoints with the version tag of its key
    derivation (walk keys, per-step fold_ins, split structure). Resuming
    a checkpoint written under a different scheme would silently
    continue training on a DIFFERENT corpus/schedule than the run that
    wrote it — the resume would "work" and produce subtly wrong
    trajectories, so mismatch (or a pre-versioning checkpoint) is a hard
    error rather than a warning.
    """
    found = meta.get("rng_scheme")
    if found != expected:
        raise ValueError(
            f"checkpoint was written under RNG scheme {found!r} but this "
            f"trainer derives its streams under {expected!r}; resuming "
            "would train on a different corpus/schedule than the "
            "original run. Start fresh (delete or relocate the "
            "checkpoint directory), or rerun with the matching package "
            "version."
        )


class SGNSCheckpointer:
    """Manages a directory of numbered SGNS training snapshots."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.npz")

    def steps(self) -> List[int]:
        """Snapshot steps present, ascending."""
        found = (_NAME.match(f) for f in os.listdir(self._dir))
        return sorted(int(m.group(1)) for m in found if m)

    def save(self, step: int, w_in, w_out, meta: Dict[str, Any]):
        """Snapshot tables + training cursor at ``step`` (a chunk index)."""
        final = self._path(step)
        tmp = f"{final}.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(
                f,
                w_in=np.asarray(w_in),
                w_out=np.asarray(w_out),
                meta=np.frombuffer(
                    json.dumps(meta).encode("utf-8"), dtype=np.uint8
                ),
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        for old in self.steps()[: -self._keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(
        self, step: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
        """Load (w_in, w_out, meta) from ``step`` (default: latest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        with np.load(self._path(step)) as z:
            meta = json.loads(z["meta"].tobytes().decode("utf-8"))
            return z["w_in"], z["w_out"], meta
