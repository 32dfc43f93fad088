"""Structured logging, throughput counters and the profiler scope.

Counterpart of ``imt_tpu.utils.observability``: key=value log lines
(``log_event``), a tiny registry of hash/insert counters with derived rates
(``Metrics``, ``GLOBAL_METRICS``), and ``trace``, a named profiler range
around a region that can also record a ``torch.profiler`` trace of it.
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

logger = logging.getLogger("imt_tpu_torch")


def log_event(event: str, **kv) -> None:
    if logger.isEnabledFor(logging.INFO):
        payload = " ".join(f"{k}={v}" for k, v in kv.items())
        logger.info("%s %s", event, payload)


@dataclass
class Metrics:
    """Cumulative counters; thread-unsafe by design (per-host engine loop)."""

    hashes: int = 0
    permutations: int = 0
    inserts: int = 0
    inserts_rejected: int = 0
    inserts_submitted: int = 0
    non_inclusion_queries: int = 0
    _start: float = field(default_factory=time.time)

    def record_hashes(self, n: int) -> None:
        self.hashes += n
        self.permutations += 2 * n  # 2 perms per fixed-length hash

    def record_inserts(self, accepted: int, rejected: int = 0) -> None:
        self.inserts += accepted
        self.inserts_rejected += rejected

    def record_submitted(self, n: int) -> None:
        """Inserts dispatched whose acceptance stays on the device
        (as_numpy=False): counted without waiting for the device."""
        self.inserts_submitted += n

    def record_queries(self, n: int) -> None:
        self.non_inclusion_queries += n

    def rates(self) -> dict:
        dt = max(time.time() - self._start, 1e-9)
        return {
            "hashes_per_s": self.hashes / dt,
            "perms_per_s": self.permutations / dt,
            "inserts_per_s": self.inserts / dt,
            "uptime_s": dt,
        }

    def snapshot(self) -> dict:
        return {
            "hashes": self.hashes,
            "permutations": self.permutations,
            "inserts": self.inserts,
            "inserts_rejected": self.inserts_rejected,
            "inserts_submitted": self.inserts_submitted,
            "non_inclusion_queries": self.non_inclusion_queries,
            **self.rates(),
        }


GLOBAL_METRICS = Metrics()

_trace_files = itertools.count()


@contextmanager
def trace(label: str, trace_dir: str | None = None):
    """Profiling scope (``imt_tpu`` :78-100).  The region is always a named
    ``torch.profiler.record_function`` range and a ``trace`` log line with
    its wall seconds: cheap enough to leave on around batch loops.  With
    `trace_dir` set (or IMT_TRACE_DIR in the environment) it also runs a
    ``torch.profiler.profile`` over the region, with CUDA activity when a
    card is present (the card is synchronised before the profile stops, so
    the region's kernels are in it), and exports a Chrome trace,
    ``<label>.<pid>.<n>.json``, into that directory (Perfetto or
    chrome://tracing read it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    td = trace_dir or os.environ.get("IMT_TRACE_DIR")
    t0 = time.time()
    if td:
        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        os.makedirs(td, exist_ok=True)
        with profile(activities=activities) as prof:
            with record_function(label):
                yield
            if cuda:
                torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(
            td, f"{label}.{os.getpid()}.{next(_trace_files)}.json"))
    else:
        with record_function(label):
            yield
    log_event("trace", label=label, wall_s=round(time.time() - t0, 6),
              profile_dir=td or "-")
