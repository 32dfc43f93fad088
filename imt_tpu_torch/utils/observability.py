"""Structured logging + throughput counters.

Counterpart of the counters half of ``imt_tpu.utils.observability``
(``log_event``, ``Metrics``, ``GLOBAL_METRICS``): key=value log lines and a
tiny registry of hash/insert counters with derived rates.  The profiler
scope (``trace``) is not ported yet.
"""

from __future__ import annotations

import logging
import time
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
