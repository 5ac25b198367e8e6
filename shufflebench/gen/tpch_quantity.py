"""TPC-H ``lineitem.l_quantity`` (TPC-H v3 §4.2.3): uniform in [1, 50],
held as decimal(15,2) unscaled, so each word is 100 x U[1, 50]."""

import torch


def generate(n, words, gen, device, low=1, high=50, scale=100):
    q = torch.randint(low, high + 1, (words, n), generator=gen,
                      dtype=torch.int32, device=device)
    return q * scale
