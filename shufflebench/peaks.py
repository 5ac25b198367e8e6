"""Published peaks of the cards the benchmark knows, by the name
``torch.cuda.get_device_name()`` gives. NVIDIA's H100 SXM data sheet:
80 GB of HBM3 at 3.35 TB/s (at the full 700 W power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str, what: str):
    """The peak ``what`` of card ``kind``, or None for a card not listed."""
    return PEAKS.get(kind, {}).get(what)
