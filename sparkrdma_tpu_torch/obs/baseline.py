"""Persisted cross-run baselines — the port's copy of
``sparkrdma_tpu.obs.baseline``, with the same file.

The telemetry store (``obs/tsdb.py``) answers "what is the spill rate
over the last 2 s"; this module answers "is that normal here". A JSON
file under ``ShuffleConf.baseline_dir`` holds, per ``(metric,
geometry)`` pair, an exponentially weighted estimate of the metric's
median and MAD (median absolute deviation): robust location and scale,
so one pathological run cannot poison the baseline as it would a mean
and standard deviation. The alert evaluator's ``throughput_anomaly``
rule scores live rates against :meth:`BaselineStore.zscore`, and folds
each evaluation's rates in. Geometry keys (``w8``: the partition count)
keep a topology change from reading as an anomaly.

Durability, as in the reference: the file carries ``BASELINE_SCHEMA``
and a file of another version is ignored, never rewritten blindly; an
unreadable file starts a fresh baseline (counted in ``load_errors``)
and never raises; :meth:`BaselineStore.save` writes a temporary file
and renames it over the old one, so a crash mid-save leaves the previous
baseline. Files are byte-equal to the reference's for the same
observations (``tests/test_torch_alerts.py``).
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Dict, Optional

log = logging.getLogger("sparkrdma_tpu_torch.baseline")

#: version of the on-disk baseline file layout. v1: flat
#: ``{"schema": 1, "entries": {"metric|geometry": {median, mad, count}}}``.
BASELINE_SCHEMA = 1

#: file name inside ``baseline_dir`` (one store per directory)
BASELINE_FILENAME = "baselines.json"

#: MAD -> stddev-equivalent scale for a normal distribution; makes
#: :meth:`BaselineStore.zscore` read in familiar sigma units
_MAD_SIGMA = 1.4826

#: default EWMA weight of one new observation (0 < alpha <= 1)
DEFAULT_ALPHA = 0.2


def _key(metric: str, geometry: str) -> str:
    return f"{metric}|{geometry}" if geometry else metric


class BaselineStore:
    """Persisted median/MAD EWMA per ``(metric, geometry)`` pair.

    Not thread-safe by itself — the alert evaluator calls it from its
    single evaluation thread.
    """

    def __init__(self, dirpath: str, alpha: float = DEFAULT_ALPHA):
        if not (0.0 < alpha <= 1.0):
            raise ValueError("baseline alpha must be in (0, 1]")
        self.dirpath = str(dirpath)
        self.alpha = float(alpha)
        self.load_errors = 0
        self.dirty = False
        # "metric|geometry" -> {"median": f, "mad": f, "count": n}
        self._entries: Dict[str, Dict] = {}
        self._load()

    @property
    def path(self) -> str:
        return os.path.join(self.dirpath, BASELINE_FILENAME)

    # -- persistence --------------------------------------------------
    def _load(self) -> None:   # never-raises
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or \
                    doc.get("schema") != BASELINE_SCHEMA:
                raise ValueError(f"unsupported baseline schema "
                                 f"{doc.get('schema')!r}")
            entries = doc.get("entries", {})
            if not isinstance(entries, dict):
                raise ValueError("baseline entries must be a dict")
            for key, ent in entries.items():
                try:
                    self._entries[str(key)] = {
                        "median": float(ent["median"]),
                        "mad": float(ent["mad"]),
                        "count": int(ent["count"]),
                    }
                except (KeyError, TypeError, ValueError):
                    self.load_errors += 1   # skip the one bad entry
        except FileNotFoundError:
            pass                            # first run: empty baseline
        except (OSError, ValueError):
            # corrupt or foreign file: start fresh, keep the evidence
            self.load_errors += 1
            log.warning("unreadable baseline file %s — starting fresh",
                        self.path, exc_info=True)

    def save(self) -> bool:   # never-raises
        """Atomically persist (temp file + rename). Returns success."""
        doc = {"schema": BASELINE_SCHEMA, "entries": self._entries}
        try:
            os.makedirs(self.dirpath, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.dirpath,
                                       prefix=".baselines.",
                                       suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(doc, f, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
            self.dirty = False
            return True
        except OSError:
            log.warning("baseline save to %s failed", self.path,
                        exc_info=True)
            return False

    # -- statistics ---------------------------------------------------
    def observe(self, metric: str, value: float,
                geometry: str = "") -> Dict:
        """Fold one observation into the (metric, geometry) baseline.

        First observation seeds ``median=value, mad=0``; later ones move
        both estimates by ``alpha`` toward the new sample / its absolute
        deviation — the EWMA form of median/MAD that needs O(1) state.
        """
        key = _key(metric, geometry)
        ent = self._entries.get(key)
        v = float(value)
        if ent is None:
            ent = self._entries[key] = {"median": v, "mad": 0.0,
                                        "count": 1}
        else:
            dev = abs(v - ent["median"])
            ent["median"] += self.alpha * (v - ent["median"])
            ent["mad"] += self.alpha * (dev - ent["mad"])
            ent["count"] += 1
        self.dirty = True
        return ent

    def get(self, metric: str, geometry: str = "") -> Optional[Dict]:
        """The stored ``{"median", "mad", "count"}`` entry, or None."""
        return self._entries.get(_key(metric, geometry))

    def zscore(self, metric: str, value: float,
               geometry: str = "") -> Optional[float]:
        """Robust z-score of ``value`` against the baseline — sigma
        units via the normal-consistency MAD scale. None without a
        baseline or with a degenerate (zero-MAD, <2 samples) one."""
        ent = self._entries.get(_key(metric, geometry))
        if ent is None or ent["count"] < 2:
            return None
        scale = _MAD_SIGMA * ent["mad"]
        if scale <= 0.0:
            # flat history: any change is "infinitely" surprising; use
            # a tiny relative scale so the score stays finite
            scale = max(abs(ent["median"]) * 1e-3, 1e-9)
        return (float(value) - ent["median"]) / scale

    def update_from_telemetry(self, telemetry, geometry: str = "") -> int:
        """Fold the TelemetryStore's full-ring per-second rates in —
        one observation per series. Returns the number folded."""
        stats = telemetry.stats()
        rates = stats.get("rate", {}) if stats else {}
        for name, r in rates.items():
            self.observe(name, r, geometry=geometry)
        return len(rates)

    def stats(self) -> Dict:
        """JSON-ready summary (probe / debugging)."""
        return {
            "schema": BASELINE_SCHEMA,
            "path": self.path,
            "entries": len(self._entries),
            "load_errors": self.load_errors,
            "dirty": self.dirty,
        }


__all__ = ["BaselineStore", "BASELINE_SCHEMA", "BASELINE_FILENAME",
           "DEFAULT_ALPHA"]
