"""Words that hold one value in every record (a key word a deployment
leaves unused, WordCount's count of 1)."""

import torch


def generate(n, words, gen, device, value=0):
    return torch.full((words, n), int(value), dtype=torch.int32,
                      device=device)
