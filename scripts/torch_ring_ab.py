#!/usr/bin/env python3
"""Time one checkout's ring exchange kernel (PyTorch port) at every send
shape ``chip_smoke.py`` checks.

    python3 scripts/torch_ring_ab.py [--root DIR] [--label NAME]

Imports ``sparkrdma_tpu_torch`` from DIR (default: the checkout holding
this script), builds its kernels there, and prints one JSON line per
shape of ``chip_smoke.py``'s ``RING_LEG_SHAPES`` and ``RING_PHASE_SHAPES``
(taken from the ``chip_smoke.py`` beside this script; the push shapes,
which need two processes, are left to its leg T), each checked
bit-exact against ``ring_exchange_plain`` first. The timings are
``chip_smoke.ring_times``':

  device_ms, library_device_ms
      20 launches captured in a CUDA graph, the replay timed with CUDA
      events, over 20 (median of 5), for the kernel and for
      ``out.copy_(send.permute(...))``, the copy ``permute().contiguous()``
      makes; a pair of buffers that fits the 50 MB L2 stays there;
  device_cold_ms, library_device_cold_ms
      the same with the launches rotating over 128 MB of copies of the
      buffers, so none is found in L2;
  share
      every word read once and written once at 3.35 TB/s, over
      ``device_cold_ms``;

and ``kernel_ms``, 20 back-to-back launches timed with CUDA events, over
20 (median of 5): the host's launch path shows when it is slower than
the kernel. Then one ``host`` line: microseconds per call of 1000
enqueues of a tiny shape for ``ring_exchange``, ``ring_all_to_all`` and
``permute().contiguous()`` (``chip_smoke.ring_host_us``).

To compare two trees on one card, unpack the other with ``git archive``
into a gitignored directory and run this script on both in one command,
in turns: old, new, new, old. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import torch


def load_smoke(here: str):
    """``chip_smoke.py`` of this checkout, as a module."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_ring_ab: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = load_smoke(here)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from sparkrdma_tpu_torch.exchange import ring

    if not os.path.abspath(ring.__file__).startswith(root + os.sep):
        print(f"torch_ring_ab: imported {ring.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    label = args.label or root

    def emit(line):
        line.update(label=label, card=card)
        print(json.dumps(line), flush=True)

    # the stacked kernel's shapes (the push shapes need two processes)
    shapes = [row for row in smoke.RING_LEG_SHAPES
              if not smoke.is_push(row[1])] + [
        (name, shape, False)
        for name, shape in smoke.RING_PHASE_SHAPES.items()]
    for seed, (where, shape, a2a) in enumerate(shapes):
        send = smoke.rand_words(shape, seed)
        if a2a:
            send = send.squeeze(1)
            kernel, want = ring.ring_all_to_all, \
                send.transpose(0, 1).contiguous()
        else:
            kernel, want = ring.ring_exchange, ring.ring_exchange_plain(send)
        out = torch.empty_like(send)
        kernel(send, out=out)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            print(f"torch_ring_ab: {label} disagrees with the plain "
                  f"version at {list(shape)}", file=sys.stderr)
            return 1
        del want
        times = smoke.ring_times(send, out, a2a)
        emit({"leg": where, "shape": list(shape), "a2a": a2a, **times,
              "kernel_ms": smoke.time_ms(lambda: kernel(send, out=out),
                                         reps=5, inner=20),
              "bound_ms": 2 * send.numel() * 4 / smoke.MEM_RATE * 1e3,
              "share": times["device_share_of_bound"]})
        del send, out
        torch.cuda.empty_cache()

    emit({"host": "us_per_launch", "calls": 1000, **smoke.ring_host_us()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
