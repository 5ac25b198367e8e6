"""Uniform words: every bit pattern of a uint32 alike, or ``[0, high)``."""

import torch


def generate(n, words, gen, device, high=1 << 32):
    """``int32[words, n]`` whose uint32 values are uniform in ``[0, high)``."""
    x = torch.randint(0, int(high), (words, n), generator=gen,
                      dtype=torch.int64, device=device)
    # uint32 values as int32 bit patterns
    return (x - ((x >> 31) << 32)).to(torch.int32)
