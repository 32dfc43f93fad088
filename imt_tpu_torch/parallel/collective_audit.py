"""The N-independence audit of the shard-local programs, on counted bytes.

Counterpart of ``imt_tpu.parallel.collective_audit``, which compiled each
shard-local program at two tree sizes and read the collectives out of the
optimized HLO.  Here the collectives are calls on a process group, and
``collectives.py`` counts the bytes of each call (its result on one rank),
so the audit runs the four programs at `depth` and at `depth + 2` (four
times the state), with the same K and chain, and compares what they moved,
under ``imt_tpu``'s rule (its collective_audit.py:16-18):

* **N-independent**: each program makes as many calls at both depths, and
  its total bytes grow at most by the deeper witness output, the two extra
  levels of 2K node columns in the one psum of the witness (and query)
  program's sharded levels: ``allowance(k)``.  A full-state gather grows
  with the state and fails.
* **Exact** where there is a formula: the insert programs move exactly
  ``local_plan.exchange_bytes`` at both depths.

Every rank of the mesh calls ``audit_local_plan`` (it runs the programs,
SPMD) and gets the same result.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np

from ..ops import field
from . import collectives, local_plan

PROGRAMS = ("insert_batch", "insert_batches", "non_inclusion_witness",
            "insert_batch_witness")


def allowance(k: int) -> int:
    """What a program's total may grow from depth to depth + 2: two more
    sharded levels of 2K node columns (``imt_tpu`` collective_audit.py
    :207)."""
    return 2 * (2 * k) * field.WORDS * 4


@dataclass
class ProgramAudit:
    name: str
    calls: list             # [(op, bytes)] at the base depth
    calls_big: list         # at depth + 2
    allowed_big: int        # the most the total may be at depth + 2
    expected: int | None    # the exact total, where there is a formula

    @property
    def total(self) -> int:
        return sum(b for _, b in self.calls)

    @property
    def total_big(self) -> int:
        return sum(b for _, b in self.calls_big)

    @property
    def n_independent(self) -> bool:
        return len(self.calls) == len(self.calls_big) and \
            self.total_big <= self.allowed_big

    @property
    def exact(self) -> bool:
        return self.expected is None or \
            self.total == self.expected == self.total_big

    @property
    def ok(self) -> bool:
        return self.n_independent and self.exact


@dataclass
class AuditResult:
    devices: int
    depth: int
    k: int
    chain: int
    programs: list = dc_field(default_factory=list)

    @property
    def failures(self) -> list:
        return [p for p in self.programs if not p.ok]

    def summary(self) -> str:
        lines = []
        for p in self.programs:
            status = "OK" if p.ok else (
                "GROWS WITH N" if not p.n_independent else
                "NOT THE EXPECTED BYTES")
            lines.append(
                f"{p.name}: {len(p.calls)} calls, {p.total:,} B at depth "
                f"{self.depth}; {len(p.calls_big)} calls, {p.total_big:,} B "
                f"at depth {self.depth + 2} (allowed {p.allowed_big:,}) "
                f"[{status}]")
        return "\n".join(lines)


def _run_programs(mesh, depth: int, k: int, chain: int, device,
                  programs) -> dict:
    """Each of `programs` once, on a fresh dense tree of `depth`: its
    calls."""
    from .sharded import ShardedIndexedMerkleTree
    rng = np.random.default_rng(7)
    draw = lambda n: field.random_limbs(int(rng.integers(1 << 31)), n, 253)
    runs = {
        "insert_batch": lambda t: t.insert_batch(draw(k)),
        "insert_batches": lambda t: t.insert_batches(
            np.stack([draw(k) for _ in range(chain)])),
        "non_inclusion_witness": lambda t: t.non_inclusion_witness(draw(k)),
        "insert_batch_witness": lambda t: t.insert_batch(draw(k),
                                                         witness=True),
    }
    out = {}
    for name in programs:
        tree = ShardedIndexedMerkleTree(depth, mesh, sparse=False,
                                        device=device)
        if not tree.is_sharded:
            raise ValueError(f"depth {depth} is not shardable over "
                             f"{mesh.size()} devices")
        collectives.reset_counts()
        runs[name](tree)
        out[name] = list(collectives.CALLS[name])
    collectives.reset_counts()
    return out


def audit_local_plan(mesh, depth: int = 6, k: int = 4, chain: int = 2,
                     device=None, programs=PROGRAMS) -> AuditResult:
    """Run the shard-local `programs` (all four by default) at `depth` and
    `depth + 2` on `mesh` (every rank calls this) and audit their
    collectives (see the module docstring)."""
    d = mesh.size()
    small = _run_programs(mesh, depth, k, chain, device, programs)
    big = _run_programs(mesh, depth + 2, k, chain, device, programs)
    expected = {"insert_batch": local_plan.exchange_bytes(d, k, 1),
                "insert_batches": local_plan.exchange_bytes(d, k, chain)}
    res = AuditResult(devices=d, depth=depth, k=k, chain=chain)
    for name in programs:
        total = sum(b for _, b in small[name])
        res.programs.append(ProgramAudit(
            name=name, calls=small[name], calls_big=big[name],
            allowed_big=total + allowance(k), expected=expected.get(name)))
    return res
