"""Stage checkpointing for preemptible EigenSNP runs.

The reference has no checkpoint/resume (SURVEY §5 — single-shot batch
tool).  On preemptible capacity the expensive stages (per-block local
bases, global basis, refinement passes) are worth persisting: this module
writes each stage's arrays + a config fingerprint to `.npz` files so an
interrupted run resumes at the last completed stage.

Layout under `checkpoint_dir/`:
    meta.json            - config fingerprint + dataset shape
    stage1_bases.npz     - per-block local bases (keyed by block index)
    stage2_basis.npz     - orthonormal score basis after global PCA
    refine_pass_{i}.npz  - basis after refinement pass i

A fingerprint mismatch (different config or dataset) invalidates the
checkpoint wholesale.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
from typing import Dict, List, Optional

import numpy as np

log = logging.getLogger(__name__)


def fingerprint(config, n_samples: int, n_pca_snps: int, block_tags: List[str]) -> str:
    payload = {
        "config": dataclasses.asdict(config),
        "n_samples": n_samples,
        "n_pca_snps": n_pca_snps,
        "block_tags": list(block_tags),
    }
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()
    ).hexdigest()[:16]


class StageCheckpointer:
    """Write/read per-stage arrays guarded by a config fingerprint."""

    def __init__(self, directory: Optional[str], fp: str):
        self.dir = directory
        self.fp = fp
        self.enabled = directory is not None
        if self.enabled:
            os.makedirs(directory, exist_ok=True)
            self._init_meta()

    def _meta_path(self) -> str:
        return os.path.join(self.dir, "meta.json")

    def _init_meta(self) -> None:
        path = self._meta_path()
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    meta = json.load(fh)
                if meta.get("fingerprint") == self.fp:
                    return  # valid resume
            except (OSError, json.JSONDecodeError):
                pass
            log.warning(
                "Checkpoint at %s belongs to a different run; invalidating.",
                self.dir,
            )
            for name in os.listdir(self.dir):
                if name.endswith(".npz") or name == "meta.json":
                    os.remove(os.path.join(self.dir, name))
        with open(path, "w") as fh:
            json.dump({"fingerprint": self.fp}, fh)

    def _path(self, stage: str) -> str:
        return os.path.join(self.dir, f"{stage}.npz")

    def save(self, stage: str, arrays: Dict[str, np.ndarray]) -> None:
        if not self.enabled:
            return
        tmp = self._path(stage) + ".tmp.npz"  # .npz suffix: savez keeps name
        np.savez(tmp, **arrays)
        os.replace(tmp, self._path(stage))
        log.info("Checkpointed stage '%s' to %s", stage, self._path(stage))

    def has(self, stage: str) -> bool:
        """Cheap presence probe: reads only the npz's zip directory (no
        array materialization, no 'Resuming' log) — for pass planning
        and leg-completion checks.  `load` remains the authority on
        array-level readability."""
        if not self.enabled:
            return False
        path = self._path(stage)
        if not os.path.exists(path):
            return False
        try:
            with np.load(path) as z:
                _ = z.files  # zip central directory only
            return True
        except (OSError, ValueError):
            return False

    def load(self, stage: str) -> Optional[Dict[str, np.ndarray]]:
        if not self.enabled:
            return None
        path = self._path(stage)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                out = {k: z[k] for k in z.files}
            log.info("Resuming stage '%s' from %s", stage, path)
            return out
        except (OSError, ValueError) as e:
            log.warning("Corrupt checkpoint %s (%s); recomputing.", path, e)
            return None
