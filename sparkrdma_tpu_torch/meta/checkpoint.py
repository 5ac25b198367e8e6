"""Segment checkpoints of chunked map output — the restart path of the
tiered store.

The segment-level subset of ``sparkrdma_tpu.meta.checkpoint
.MapOutputStore``: a shuffle's map output saved as independent
CRC-framed segment files plus a ``segments.json`` manifest, so that a
restarted job adopts only the segments missing from its live
:class:`~sparkrdma_tpu_torch.hbm.tiered_store.TieredStore`
(``ShuffleManager.resume_segments``). Files and manifest are laid out
as the reference lays them out, so either package resumes the other's
checkpoints.

The whole-shuffle checkpoint (``save`` / ``save_shards`` / ``load``,
behind ``checkpoint_shuffle`` / ``resume_shuffle``) waits for a later
slice.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import List, Optional

import numpy as np

from sparkrdma_tpu_torch.hbm.host_staging import SpillWriter

_MANIFEST = "segments.json"
_SPOOL_DEPTH = 4        # segment writes in flight


class MapOutputStore:
    """Directory-backed store: one subdirectory per shuffle id."""

    def __init__(self, root: str, compression: str = "",
                 compression_level: int = 1):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.compression = compression
        self.compression_level = compression_level

    def _dir(self, shuffle_id: int) -> Path:
        return self.root / f"shuffle_{shuffle_id}"

    def save_segments(self, shuffle_id: int, segments, plan,
                      num_parts: int,
                      extra_meta: Optional[dict] = None) -> Path:
        """Persist ``segments`` (``[(key, np.ndarray), ...]``) as
        individual CRC-framed files, then the manifest (tmp + rename, so
        a crash mid-save reads as no checkpoint). ``plan`` (a
        ``ShufflePlan``, or None for output checkpoints) adds its
        geometry to the manifest, as do ``extra_meta``'s fields."""
        d = self._dir(shuffle_id)
        d.mkdir(parents=True, exist_ok=True)
        spool = SpillWriter(depth=_SPOOL_DEPTH, codec=self.compression,
                            level=self.compression_level)
        manifest = {}
        tmp_paths = []
        try:
            for key, data in segments:
                data = np.ascontiguousarray(data)
                safe = str(key).replace("/", "_")
                tmp = d / f"seg_{safe}.u32.tmp"
                spool.submit(str(tmp), data)
                tmp_paths.append((tmp, d / f"seg_{safe}.u32"))
                manifest[str(key)] = {
                    "file": f"seg_{safe}.u32",
                    "shape": list(data.shape),
                    "dtype": data.dtype.name,
                }
            errors = spool.drain()
        finally:
            spool.close()
        if errors:
            for tmp, _ in tmp_paths:
                tmp.unlink(missing_ok=True)
            raise OSError(f"segment spill of shuffle {shuffle_id} failed "
                          f"({errors} errors)")
        for tmp, final in tmp_paths:
            tmp.replace(final)
        meta = dict(extra_meta or {})
        meta.update({
            "shuffle_id": shuffle_id,
            "num_parts": num_parts,
            "segments": manifest,
        })
        if plan is not None:
            meta.update({
                "counts": np.asarray(plan.counts).tolist(),
                "num_rounds": plan.num_rounds,
                "out_capacity": plan.out_capacity,
                "capacity": plan.capacity,
                "split_factor": plan.split_factor,
            })
        mtmp = d / (_MANIFEST + ".tmp")
        mtmp.write_text(json.dumps(meta))
        mtmp.replace(d / _MANIFEST)
        return d

    def load_segment_meta(self, shuffle_id: int) -> dict:
        """Manifest of a segment checkpoint (KeyError if absent)."""
        p = self._dir(shuffle_id) / _MANIFEST
        if not p.exists():
            raise KeyError(f"no segment checkpoint for shuffle "
                           f"{shuffle_id} under {self.root}")
        return json.loads(p.read_text())

    def segment_path(self, shuffle_id: int, entry: dict) -> str:
        return str(self._dir(shuffle_id) / entry["file"])

    def contains(self, shuffle_id: int) -> bool:
        """True for a complete segment checkpoint (its manifest written
        and readable)."""
        try:
            self.load_segment_meta(shuffle_id)
            return True
        except (KeyError, ValueError):
            return False

    def delete(self, shuffle_id: int) -> None:
        d = self._dir(shuffle_id)
        if d.exists():
            shutil.rmtree(d)

    def list_segment_checkpoints(self) -> List[int]:
        """Shuffle ids holding a segment checkpoint."""
        out = []
        for p in self.root.glob("shuffle_*"):
            if (p / _MANIFEST).exists():
                try:
                    out.append(int(p.name.split("_", 1)[1]))
                except ValueError:
                    continue
        return sorted(out)


__all__ = ["MapOutputStore"]
