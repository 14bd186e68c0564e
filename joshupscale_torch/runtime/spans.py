"""Named host spans on the serving path, seen by ``torch.profiler``.

``span(name)`` is a profiler record named ``name`` while a profiler
session is active and a shared no-op context otherwise, so a span costs
one read of the profiler's own enabled flag when no one is tracing.  A
span is a profiler record: it shares the trace's clock with the card's
kernel and copy records, so a reader can set a span's edges against
kernel timestamps directly.  The record is a plain function-scope one
(``torch._C._profiler._RecordFunctionFast``), not a user annotation
(``torch.profiler.record_function``): the profiler mirrors a user
annotation onto the card's timeline as a record as long as the kernels
inside it, and a reader that tells kernels from other card records by
name would count that mirror as a kernel.

The spans of the serving engines (``runtime/engine.py``,
``parallel/serving.py``, ``parallel/pipeline.py``), nested in this
order:

- ``engine.process``: one ``process`` call (``ShardedEngine`` and
  ``SpatialEngine`` too) or ``process_async`` call;
- ``engine.stage_wait``: the wait for the pinned staging slot's last
  copy to finish;
- ``engine.stage_copy``: the frame's checks and its copy into the
  staging slot (on the CPU, into a new tensor);
- ``engine.h2d``: the staged frame's copy into the graph's input buffer
  being enqueued (``SpatialEngine``: the frame's scatter to the slabs);
- ``engine.replay``: the frame graph's replay (the marked graph while
  profiling, ``Engine``), or the eager step;
- ``engine.readback``: the display frame's copy into host memory;
- ``engine.reset``: a ``reset`` (the drain and the state copy).

``marking()`` says whether a replay made now runs ``Engine``'s marked
frame graph: while profiling, outside ``unmarked()``.  A tool that
profiles what the main path replays (its kernel counts, its device
time by part) profiles inside ``unmarked()``.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()
_unmarked = 0  # the depth of open ``unmarked()`` blocks
_RECORD = torch._C._profiler._RecordFunctionFast
profiling = torch._C._autograd._profiler_enabled
"""Whether a ``torch.profiler`` session is active."""


def span(name: str):
    """A profiler record named ``name`` while profiling, else a no-op."""
    if profiling():
        return _RECORD(name)
    return _OFF


def marking() -> bool:
    """Whether a replay made now runs the marked frame graph."""
    return not _unmarked and profiling()


@contextlib.contextmanager
def unmarked():
    """Replays made inside run the served (unmarked) frame graph, also
    while profiling."""
    global _unmarked
    _unmarked += 1
    try:
        yield
    finally:
        _unmarked -= 1
