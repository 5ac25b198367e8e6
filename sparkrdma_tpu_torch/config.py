"""Shuffle configuration — a trimmed copy of ``sparkrdma_tpu.config``.

Only the knobs the ported paths read are kept (TeraSort, and the
aggregation path with its map-side combine gate), under the reference's
names and with its defaults, so a configuration written for one package
means the same thing to the other. Knobs of paths that are not ported
yet (streaming, the pack/wide sort modes, the hierarchical transport)
are refused where they would change what runs, never silently ignored;
the reference's ``combine_fallback`` rung is not kept at all, because a
map-side combine that fails raises here.
"""

from __future__ import annotations

import dataclasses

DEFAULT_KEY_WORDS = 2
DEFAULT_VAL_WORDS = 2

#: transports the port implements: ``"xla"`` is the plain stacked
#: permute, ``"pallas_ring"`` the hand-written CUDA exchange kernel
_TRANSPORTS = ("xla", "pallas_ring")


@dataclasses.dataclass(frozen=True)
class ShuffleConf:
    """All knobs for a shuffle job (the slice's subset of the reference)."""

    # --- exchange geometry ---
    slot_records: int = 4096          # records per (src,dst) slot per round
    max_rounds: int = 64              # static upper bound on rounds
    #: rounds run by one exchange; more rounds need the streaming regime,
    #: which the port does not implement yet (it raises)
    max_rounds_in_flight: int = 2

    # --- record geometry ---
    key_words: int = DEFAULT_KEY_WORDS   # uint32 words per key
    val_words: int = DEFAULT_VAL_WORDS   # uint32 words per payload

    # --- transport ---
    transport: str = "xla"
    #: pallas_ring only: all rounds in one kernel launch, with the size
    #: exchange riding a prefix lane of round 0
    ring_fused: bool = True
    #: "pow2" or "fine" size classes for slot and output capacity
    geometry_classes: str = "pow2"

    # --- reduce-side sort ---
    #: merge-path sort for key-ordered reads when the output capacity is
    #: a power of two holding at least two runs
    fast_sort: bool = False
    fast_sort_run: int = 1 << 15
    #: keep arrival order within equal keys (disables the merge-path sort)
    stable_key_sort: bool = False
    #: payload widths that select the reference's "wide" / "pack" sort
    #: modes; those modes are not ported, so a geometry that selects one
    #: raises — set both to 0 (as the reference's bench does)
    wide_sort_min_payload: int = 20
    pack_sort_min_payload: int = 20

    # --- map-side combine (pre-exchange reduction) ---
    #: map-side combine policy for aggregator shuffles: "auto" (a sampled
    #: duplicate-ratio estimate gates it per shuffle), "on", "off"
    map_side_combine: str = "auto"
    #: leading rows of partition 0 sampled for the "auto" gate's estimate;
    #: 0 skips sampling and makes "auto" behave as "on"
    combine_sample_rows: int = 1024
    #: sampled duplicate ratio (1 - unique/sample) at which "auto" turns
    #: the map-side combine on
    combine_min_dup_ratio: float = 0.25

    def __post_init__(self):
        if self.slot_records <= 0:
            raise ValueError("slot_records must be positive")
        if self.max_rounds <= 0 or self.max_rounds_in_flight <= 0:
            raise ValueError("max_rounds and max_rounds_in_flight must be "
                             "positive")
        if self.key_words <= 0 or self.val_words < 0:
            raise ValueError("key_words must be > 0 and val_words >= 0")
        if self.transport not in _TRANSPORTS:
            raise ValueError(f"unknown transport {self.transport!r} "
                             f"(ported: {', '.join(_TRANSPORTS)})")
        if self.geometry_classes not in ("pow2", "fine"):
            raise ValueError(f"unknown geometry_classes "
                             f"{self.geometry_classes!r}")
        run = self.fast_sort_run
        if run < 128 or run & (run - 1):
            raise ValueError("fast_sort_run must be a power of two >= 128")
        if self.map_side_combine not in ("auto", "on", "off"):
            raise ValueError(
                f"unknown map_side_combine {self.map_side_combine!r} "
                "(supported: 'auto', 'on', 'off')")
        if self.combine_sample_rows < 0:
            raise ValueError("combine_sample_rows must be >= 0 (0 = "
                             "no sampling, 'auto' behaves as 'on')")
        if not 0.0 <= self.combine_min_dup_ratio <= 1.0:
            raise ValueError("combine_min_dup_ratio must be in [0, 1]")

    @property
    def record_words(self) -> int:
        """Total uint32 words per record in exchange buffers."""
        return self.key_words + self.val_words

    def replace(self, **kw) -> "ShuffleConf":
        return dataclasses.replace(self, **kw)


def size_class(n_records: int) -> int:
    """Round a record count up to its power-of-two size class."""
    if n_records <= 0:
        raise ValueError("n_records must be positive")
    return 1 << (n_records - 1).bit_length()


def size_class_fine(n_records: int, bits: int = 4) -> int:
    """Round up keeping the top ``bits`` bits (padding < 1/2^bits)."""
    if n_records <= 0:
        raise ValueError("n_records must be positive")
    shift = max(0, n_records.bit_length() - 1 - bits)
    return ((n_records + (1 << shift) - 1) >> shift) << shift


__all__ = ["ShuffleConf", "size_class", "size_class_fine",
           "DEFAULT_KEY_WORDS", "DEFAULT_VAL_WORDS"]
