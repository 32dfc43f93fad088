"""Structured logging, the program's tracer, and the profiler scope.

Counterpart of ``imt_tpu.utils.observability``: key=value log lines
(``log_event``) and ``trace``, a scope that can record a ``torch.profiler``
trace of a region.  The tracer is the port's own:

* ``span(name)`` marks a stretch of host time inside the program (a context
  manager): its name, its start and end (``time.perf_counter_ns``), its
  parent span and the id of the API call it belongs to (the outermost
  span's: every span of one ``insert_batch`` call shares it).
* ``count(name, n)`` adds to a counter.  Each counter keeps a cumulative
  total, always (``total``), and, while the tracer is on, the current
  session's share.
* The tracer is **off** by default: a span then costs one look at the
  profiler's state and one flag read, opens no profiler range and
  records nothing.  It is **on** while a ``torch.profiler`` session runs,
  or after ``enable()`` (until ``disable()``).  While the profiler runs,
  each span is also a ``record_function("imt.<name>")`` range, so it sits
  in the Chrome trace on the device trace's clock.
* Spans and counts go to a **session**, kept in memory (nothing is
  written out).  A change of the profiler's state, as a span or count sees
  it, starts a new session while the tracer is on, and so does
  ``enable()``: a session holds exactly one profiled stretch, or one
  stretch of ``enable()`` without the profiler.  ``snapshot()`` gives the
  totals and the newest session as plain data; ``reset()`` drops both.
* ``held_counts()`` diverts the counts made inside it into a dict it
  yields and records them nowhere: work recorded now and run later (a CUDA
  graph's capture) keeps its counts, and each run adds them with
  ``count``.

Not thread-safe, by design: one engine loop a process.
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from contextlib import contextmanager, nullcontext

import torch

logger = logging.getLogger("imt_tpu_torch")

_profiler_on = torch._C._autograd._profiler_enabled

# a session stops recording spans beyond this many (and counts the rest)
MAX_SPANS = 1 << 20


def log_event(event: str, **kv) -> None:
    if logger.isEnabledFor(logging.INFO):
        payload = " ".join(f"{k}={v}" for k, v in kv.items())
        logger.info("%s %s", event, payload)


class Session:
    """The spans and counts of one stretch.  A span is a list [name,
    start_ns, end_ns, parent, call]: end_ns None while it is open, parent
    the index of its parent span in ``spans`` (None at the top)."""

    __slots__ = ("profiled", "spans", "counts", "dropped")

    def __init__(self, profiled: bool):
        self.profiled = profiled
        self.spans: list = []
        self.counts: dict = {}
        self.dropped = 0

    def as_dict(self) -> dict:
        keys = ("name", "start_ns", "end_ns", "parent", "call")
        return {"profiled": self.profiled,
                "spans": [dict(zip(keys, s)) for s in self.spans],
                "counts": dict(self.counts), "dropped": self.dropped}


_enabled = False
_prof = False              # the profiler's state at the last span or count
_session: Session | None = None
_open: list = []           # [session, index] of each open span, innermost last
_calls = itertools.count(1)
_totals: dict = {}
_held: list = []           # the dict of each open held_counts, innermost last


def _recording() -> Session | None:
    """The session to record into, or None while the tracer is off."""
    global _prof, _session
    prof = _profiler_on()
    if prof != _prof:
        _prof = prof
        if prof or _enabled:
            _session = Session(prof)
    if not (prof or _enabled):
        return None
    if _session is None:
        _session = Session(prof)
    return _session


_OFF = nullcontext()


class _Span:
    __slots__ = ("_name", "_session", "_entry", "_range")

    def __init__(self, name: str, session: Session):
        self._name, self._session = name, session

    def __enter__(self):
        s = self._session
        parent = call = None
        if _open and _open[-1][0] is s:
            parent = _open[-1][1]
            call = s.spans[parent][4]
        self._range = None
        if s.profiled:
            self._range = torch.profiler.record_function("imt." + self._name)
            self._range.__enter__()
        self._entry = [s, len(s.spans)]
        _open.append(self._entry)
        s.spans.append([self._name, time.perf_counter_ns(), None, parent,
                        next(_calls) if call is None else call])
        return None

    def __exit__(self, *exc):
        s, i = self._entry
        s.spans[i][2] = time.perf_counter_ns()
        if _open and _open[-1] is self._entry:
            _open.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking a stretch of host time named `name`; see
    the module docstring."""
    if not (_enabled or _prof or _profiler_on()):
        return _OFF
    s = _recording()
    if s is None:
        return _OFF
    if len(s.spans) >= MAX_SPANS:
        s.dropped += 1
        return _OFF
    return _Span(name, s)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`: to its total, and while the tracer
    is on to the current session's share; inside ``held_counts`` to its
    dict alone."""
    if _held:
        _held[-1][name] = _held[-1].get(name, 0) + n
        return
    _totals[name] = _totals.get(name, 0) + n
    if not (_enabled or _prof or _profiler_on()):
        return
    s = _recording()
    if s is not None:
        s.counts[name] = s.counts.get(name, 0) + n


@contextmanager
def held_counts():
    """Yield a dict {name: n} that takes every count made inside, in place
    of the totals and the session; see the module docstring."""
    held: dict = {}
    _held.append(held)
    try:
        yield held
    finally:
        _held.pop()


def total(name: str) -> int:
    """The counter's cumulative total since the process started (or since
    ``reset()``)."""
    return _totals.get(name, 0)


def enable() -> None:
    """Turn the tracer on without the profiler, in a new session."""
    global _enabled, _prof, _session
    _enabled = True
    _prof = _profiler_on()
    _session = Session(_prof)


def disable() -> None:
    """Back to the default: on only while the profiler runs."""
    global _enabled
    _enabled = False


def snapshot() -> dict:
    """{"totals": the counters' totals, "session": the newest session as
    plain data (``Session.as_dict``), None before any}."""
    return {"totals": dict(_totals),
            "session": None if _session is None else _session.as_dict()}


def reset() -> None:
    """Zero the totals and drop the sessions."""
    global _session, _prof
    _totals.clear()
    _session, _prof = None, False
    _open.clear()


_trace_files = itertools.count()


@contextmanager
def trace(label: str, trace_dir: str | None = None):
    """Profiling scope (``imt_tpu`` :78-100): the region is the span
    `label` and a ``trace`` log line with its wall seconds.  With
    `trace_dir` set (or IMT_TRACE_DIR in the environment) it also runs a
    ``torch.profiler.profile`` over the region, with CUDA activity when a
    card is present (the card is synchronised before the profile stops, so
    the region's kernels are in it), and exports a Chrome trace,
    ``<label>.<pid>.<n>.json``, into that directory (Perfetto or
    chrome://tracing read it), in which the span is the range
    ``imt.<label>``."""
    from torch.profiler import ProfilerActivity, profile

    td = trace_dir or os.environ.get("IMT_TRACE_DIR")
    t0 = time.time()
    if td:
        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        os.makedirs(td, exist_ok=True)
        with profile(activities=activities) as prof:
            with span(label):
                yield
            if cuda:
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(
            td, f"{label}.{os.getpid()}.{next(_trace_files)}.json"))
    else:
        with span(label):
            yield
    log_event("trace", label=label, wall_s=round(time.time() - t0, 6),
              profile_dir=td or "-")
