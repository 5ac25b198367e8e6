"""Profiling hooks — the port's ``sparkrdma_tpu.utils.profiling``.

The reference wraps a region in a ``jax.profiler`` trace and names its
sub-regions with ``jax.profiler.TraceAnnotation``. The port does the
same in PyTorch's idiom:

- :func:`trace` runs the region under ``torch.profiler.profile``. It
  records CPU activity, and CUDA activity (kernels, copies, through
  CUPTI) when CUDA is available, and writes a Chrome trace
  (``trace.json``, viewable in Perfetto) into ``log_dir``.
- :func:`span` names a layer inside the program (``shuffle:map``,
  ``shuffle:chunk``, ...). While a ``torch.profiler`` session is active
  it is a ``record_function`` range, on the clock of the device trace,
  and on a CUDA device also an NVTX range; otherwise it is a shared
  no-op that reads one flag and allocates nothing, so the ~150 spans a
  streaming read passes cost nothing untraced. A span records host
  scalars only: it never reads a device tensor and never syncs.
- :func:`annotate` is the same range for the SPI's three ranges
  (``shuffle:plan``, ``shuffle:exchange``, ``shuffle:filter+agg+sort``),
  whose NVTX range on a CUDA device is opened whether or not a profiler
  runs, so Nsight Systems (``nsys profile``) shows the same regions; on
  the CPU NVTX is never touched.
- :func:`annotate_span` names an exchange's range after its journal span
  (``shuffle:exchange#s42``), so a range in the trace and a line in the
  journal identify the same read.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

log = logging.getLogger("sparkrdma_tpu_torch.profiling")

#: the file :func:`trace` writes into its ``log_dir``
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False
          ) -> Iterator["torch.profiler.profile"]:
    """Profile the enclosed region into ``log_dir/trace.json``.

    Usage::

        with profiling.trace("/tmp/shuffle-trace"):
            reader.read()

    ``create_perfetto_link`` is accepted for the reference's signature
    and ignored (the trace is a file to open in Perfetto). Yields the
    profiler, whose ``key_averages()`` summarise the region."""
    from torch.profiler import ProfilerActivity, profile

    del create_perfetto_link
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


class _Off:
    """The span of an untraced run: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Range:
    """A ``record_function`` range, and an NVTX range on a CUDA device."""

    __slots__ = ("_name", "_cuda", "_rf")

    def __init__(self, name: str, cuda: bool):
        self._name = name
        self._cuda = cuda
        self._rf = torch.profiler.record_function(name)

    def __enter__(self) -> None:
        self._rf.__enter__()
        if self._cuda:
            torch.cuda.nvtx.range_push(self._name)

    def __exit__(self, *exc) -> bool:
        if self._cuda:
            torch.cuda.nvtx.range_pop()
        self._rf.__exit__(*exc)
        return False


def span(name: str, device=None):
    """A layer's range in the profiler's trace, named ``name``; on a CUDA
    ``device`` (a ``torch.device`` or a string) also an NVTX range. With
    no profiler session active it returns a shared no-op at once: no
    ``record_function``, no NVTX, no allocation."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Range(name, device is not None
                  and torch.device(device).type == "cuda")


@contextlib.contextmanager
def annotate(name: str, device=None) -> Iterator[None]:
    """A named range in the profiler's trace (a :func:`span` without a
    device: none when no profiler runs); on a CUDA ``device`` also an
    NVTX range of the same name, opened whether or not a profiler runs
    (for Nsight Systems). ``device`` is the device the region's work
    runs on (a ``torch.device`` or a string); ``None`` or a CPU device
    records the profiler range only."""
    cuda = device is not None and torch.device(device).type == "cuda"
    with span(name):
        if cuda:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if cuda:
                torch.cuda.nvtx.range_pop()


def annotate_span(phase: str, span_id: int = 0, device=None):
    """:func:`annotate` under ``phase#s<span_id>``: the exchange-journal
    span id in the range name, so a trace region and a journal line of
    the same read correlate. The plain phase name when no span id is in
    flight (journal off)."""
    return annotate(f"{phase}#s{span_id}" if span_id else phase, device)


@contextlib.contextmanager
def maybe_trace(log_dir: Optional[str]) -> Iterator[None]:
    """:func:`trace` when a directory is given, a no-op otherwise."""
    if log_dir:
        with trace(log_dir):
            yield
    else:
        yield


__all__ = ["trace", "span", "annotate", "annotate_span",
           "maybe_trace", "TRACE_FILE"]
