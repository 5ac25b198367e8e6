"""Host row codec helpers — the part of ``sparkrdma_tpu.api.serde`` the
ported paths use.

Only :func:`rows_content_digest` is here, which ``Dataset.from_host_rows``
stamps on a dataset. The byte-payload codecs (the v1 rows format and the
``RowSchema`` columnar v2 format) and the pipelined encode/decode wait
for a later slice (ROADMAP A.4).
"""

from __future__ import annotations

import hashlib

import numpy as np


def rows_content_digest(rows: np.ndarray) -> str:
    """Canonical 16-hex content digest of a host row batch (shape, dtype
    and bytes): one digest value for one bit pattern, the same value the
    reference's function gives."""
    r = np.ascontiguousarray(rows)
    h = hashlib.sha256()
    h.update(repr((r.shape, r.dtype.name)).encode())
    h.update(r.data)
    return h.hexdigest()[:16]


__all__ = ["rows_content_digest"]
