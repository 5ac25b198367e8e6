"""Host persistence of map output — checkpoint and resume of the map
stage.

The port's copy of ``sparkrdma_tpu.meta.checkpoint.MapOutputStore``. In
Spark, map output files on local disk survive a task's death and are
served again without running the map stage; here the map output lives
on the card and dies with the process, so the store persists it to host
disk explicitly:

- **whole checkpoints** (``save`` / ``load`` / ``read_records``): one
  CRC-framed ``records.u32`` holding the stacked ``uint32[W, N]`` batch,
  then ``meta.json`` with the plan (counts and geometry), written last
  in a temporary directory that is renamed into place, so that a crash
  mid-save reads as no checkpoint;
- **sharded checkpoints** (``save_shards`` / ``read_shard``): the
  reference's multi-host layout, ``shard_{c}.u32`` per mesh coordinate
  plus a ``proc{p}.json`` marker per process and, from process 0, a
  global ``meta.json``; complete only when every marker carries the
  plan's ``save_id``. The port is one process, but resumes such a
  checkpoint whole;
- **segment checkpoints** (``save_segments``): chunked map output as
  independent CRC-framed segment files and a ``segments.json``
  manifest, so that a restarted job adopts only the segments missing
  from its live :class:`~sparkrdma_tpu_torch.hbm.tiered_store
  .TieredStore` (``ShuffleManager.resume_segments``).

Every file and manifest is laid out as the reference lays it out, byte
for byte, so either package resumes the other's checkpoints. Data reads
go through :func:`_checked_read` (the ``checkpoint.read`` fault site and
two bounded re-reads). What is persisted is the map side's input to the
exchange, not its output: the fetch runs again, as in Spark.
"""

from __future__ import annotations

import hashlib
import json
import logging
import shutil
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from sparkrdma_tpu_torch import faults
from sparkrdma_tpu_torch.exchange.protocol import ShufflePlan
from sparkrdma_tpu_torch.hbm.host_staging import SpillWriter, read_array

log = logging.getLogger("sparkrdma_tpu_torch.checkpoint")

_META = "meta.json"
_RECORDS = "records.u32"
_MANIFEST = "segments.json"
_SPOOL_DEPTH = 4        # writes in flight


def _as_u32(arr: np.ndarray) -> np.ndarray:
    """Contiguous ``uint32`` words: the port's ``int32`` bit views are
    reinterpreted, not converted."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.int32:
        return arr.view(np.uint32)
    return np.ascontiguousarray(arr, dtype=np.uint32)


def _checked_read(what: str, fn):
    """``fn()`` with the ``checkpoint.read`` fault site fired per attempt
    and up to two re-reads after an ``OSError`` (injected, or a CRC
    mismatch that reads clean later); each failure overcome counts one
    ``checkpoint_reread`` recovery. A persistent failure re-raises the
    last ``OSError``, which the manager maps to
    ``UnrecoverableShuffleError``."""
    last: Optional[OSError] = None
    for attempt in (0, 1, 2):
        try:
            if faults.fire("checkpoint.read") == "fail":
                raise OSError(f"injected fault (checkpoint.read): {what}")
            out = fn()
        except OSError as e:
            last = e
            log.warning("checkpoint read of %s failed (attempt %d): %s",
                        what, attempt + 1, e)
            continue
        for _ in range(attempt):
            faults.note_recovery("checkpoint_reread")
        return out
    raise last


def _plan_meta(plan: ShufflePlan) -> dict:
    return {"counts": np.asarray(plan.counts).tolist(),
            "num_rounds": plan.num_rounds,
            "out_capacity": plan.out_capacity,
            "capacity": plan.capacity,
            "split_factor": plan.split_factor}


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

    def _spool(self) -> SpillWriter:
        return SpillWriter(depth=_SPOOL_DEPTH, codec=self.compression,
                           level=self.compression_level)

    # --- whole checkpoints ---------------------------------------------
    def save(self, shuffle_id: int, records: np.ndarray, plan: ShufflePlan,
             num_parts: int) -> Path:
        """Persist ``records`` (``[W, N]`` words) and ``plan``, replacing
        any earlier checkpoint: the records through the spill writer into
        a temporary directory, then the metadata, then one rename."""
        d = self._dir(shuffle_id)
        tmp = d.with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        records = _as_u32(records)
        spool = self._spool()
        try:
            spool.submit(str(tmp / _RECORDS), records)
            errors = spool.drain()
        finally:
            spool.close()
        if errors:
            shutil.rmtree(tmp, ignore_errors=True)
            raise OSError(f"spill of shuffle {shuffle_id} failed "
                          f"({errors} errors)")
        meta = {"shuffle_id": shuffle_id, "num_parts": num_parts,
                "shape": list(records.shape), **_plan_meta(plan)}
        (tmp / _META).write_text(json.dumps(meta))
        if d.exists():
            shutil.rmtree(d)
        tmp.rename(d)
        log.info("checkpointed shuffle %d: %s records -> %s",
                 shuffle_id, records.shape, d)
        return d

    @staticmethod
    def _save_id(plan: ShufflePlan, global_shape) -> str:
        """Fingerprint of the plan that every process computes alike
        without talking: a re-save after the map ran again has other
        counts, so stale markers read as incomplete."""
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(plan.counts).tobytes())
        h.update(repr((plan.num_rounds, plan.out_capacity, plan.capacity,
                       plan.split_factor, tuple(global_shape))).encode())
        return h.hexdigest()[:16]

    def save_shards(self, shuffle_id: int,
                    shards: List[Tuple[int, np.ndarray]],
                    plan: ShufflePlan, num_parts: int, global_shape,
                    process_index: int, num_processes: int) -> Path:
        """Persist this process's shards (``[(mesh_coord, data), ...]``)
        in the multi-host layout: ``shard_{coord}.u32`` each, the marker
        ``proc{p}.json`` and, from process 0, ``meta.json`` with
        ``sharded: true``. Each file lands by tmp + rename, markers and
        meta last. (Re-saving other records under a byte-identical plan
        can tear, as in the reference.)"""
        d = self._dir(shuffle_id)
        d.mkdir(parents=True, exist_ok=True)
        save_id = self._save_id(plan, global_shape)
        spool = self._spool()
        tmp_paths = []
        try:
            for coord, data in shards:
                tmp = d / f"shard_{coord}.u32.tmp"
                spool.submit(str(tmp), _as_u32(data))
                tmp_paths.append((tmp, d / f"shard_{coord}.u32"))
            errors = spool.drain()
        finally:
            spool.close()
        if errors:
            for tmp, _ in tmp_paths:
                tmp.unlink(missing_ok=True)
            raise OSError(f"sharded spill of shuffle {shuffle_id} failed "
                          f"({errors} errors)")
        for tmp, final in tmp_paths:
            tmp.replace(final)
        marker = {"process_index": process_index,
                  "save_id": save_id,
                  "shards": sorted(c for c, _ in shards),
                  "shard_shapes": {str(c): list(a.shape)
                                   for c, a in shards}}
        mtmp = d / f"proc{process_index}.json.tmp"
        mtmp.write_text(json.dumps(marker))
        mtmp.replace(d / f"proc{process_index}.json")
        if process_index == 0:
            meta = {"shuffle_id": shuffle_id, "num_parts": num_parts,
                    "shape": list(global_shape), **_plan_meta(plan),
                    "sharded": True, "save_id": save_id,
                    "num_processes": num_processes}
            gtmp = d / (_META + ".tmp")
            gtmp.write_text(json.dumps(meta))
            gtmp.replace(d / _META)
        log.info("checkpointed shuffle %d shards %s (proc %d) -> %s",
                 shuffle_id, [c for c, _ in shards], process_index, d)
        return d

    def load_meta(self, shuffle_id: int) -> dict:
        """The checkpoint's metadata; KeyError if it is absent or, for a
        sharded one, incomplete (a marker missing) or torn (a marker of
        another save)."""
        d = self._dir(shuffle_id)
        meta_path = d / _META
        if not meta_path.exists():
            raise KeyError(f"no checkpoint for shuffle {shuffle_id} "
                           f"under {self.root}")
        meta = json.loads(meta_path.read_text())
        if meta.get("sharded"):
            want = meta.get("save_id")
            for p in range(int(meta["num_processes"])):
                mp = d / f"proc{p}.json"
                if not mp.exists():
                    raise KeyError(
                        f"sharded checkpoint for shuffle {shuffle_id} is "
                        f"incomplete: missing proc{p}.json")
                marker = json.loads(mp.read_text())
                if marker.get("save_id") != want:
                    raise KeyError(
                        f"sharded checkpoint for shuffle {shuffle_id} is "
                        f"torn: proc{p} save_id mismatch")
        return meta

    @staticmethod
    def plan_from_meta(meta: dict) -> ShufflePlan:
        return ShufflePlan(
            counts=np.asarray(meta["counts"], dtype=np.int64),
            num_rounds=int(meta["num_rounds"]),
            out_capacity=int(meta["out_capacity"]),
            capacity=int(meta["capacity"]),
            # checkpoints from before skew splitting have no field
            split_factor=int(meta.get("split_factor", 1)))

    def read_shard(self, shuffle_id: int, coord: int, shape) -> np.ndarray:
        p = str(self._dir(shuffle_id) / f"shard_{coord}.u32")
        return _checked_read(p, lambda: read_array(p, np.uint32,
                                                   tuple(shape)))

    def read_records(self, shuffle_id: int, meta: dict) -> np.ndarray:
        """The records of a whole checkpoint whose metadata is loaded."""
        p = str(self._dir(shuffle_id) / _RECORDS)
        return _checked_read(p, lambda: read_array(
            p, np.uint32, tuple(meta["shape"])))

    def load(self, shuffle_id: int) -> Tuple[np.ndarray, ShufflePlan, int]:
        """``(records, plan, num_parts)`` of a whole checkpoint; KeyError
        if absent, ValueError for a sharded one (resume that through
        ``ShuffleManager.resume_shuffle``)."""
        meta = self.load_meta(shuffle_id)
        if meta.get("sharded"):
            raise ValueError(
                f"shuffle {shuffle_id} is a sharded (multi-host) "
                "checkpoint; resume via ShuffleManager.resume_shuffle")
        return (self.read_records(shuffle_id, meta),
                self.plan_from_meta(meta), int(meta["num_parts"]))

    # --- segment checkpoints -------------------------------------------
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
        spool = self._spool()
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
            meta.update(_plan_meta(plan))
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

    def has_records(self, shuffle_id: int) -> bool:
        """True for a complete whole or sharded checkpoint (every marker
        of the same save), which ``resume_shuffle`` can take; a torn or
        truncated one reads as absent."""
        try:
            self.load_meta(shuffle_id)
            return True
        except (KeyError, ValueError):
            return False

    def contains(self, shuffle_id: int) -> bool:
        """True for a complete checkpoint of any layout: whole, sharded
        (:meth:`has_records`) or segments (a readable manifest)."""
        if self.has_records(shuffle_id):
            return True
        try:
            self.load_segment_meta(shuffle_id)
            return True
        except (KeyError, ValueError):
            return False

    def delete(self, shuffle_id: int) -> None:
        d = self._dir(shuffle_id)
        if d.exists():
            shutil.rmtree(d)

    def list_shuffles(self) -> List[int]:
        """Shuffle ids holding a whole or sharded checkpoint."""
        return self._list(_META)

    def list_segment_checkpoints(self) -> List[int]:
        """Shuffle ids holding a segment checkpoint."""
        return self._list(_MANIFEST)

    def _list(self, name: str) -> List[int]:
        out = []
        for p in self.root.glob("shuffle_*"):
            if (p / name).exists():
                try:
                    out.append(int(p.name.split("_", 1)[1]))
                except ValueError:
                    continue
        return sorted(out)


__all__ = ["MapOutputStore"]
