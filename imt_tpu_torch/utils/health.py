"""In-run failure detection for indexed trees.

Counterpart of ``imt_tpu.utils.health``, with its semantics but for the
slots of rejected inserts:

* ``check_tree(tree, sample=.., seed=..)`` audits a point in time: slot 0
  and up to `sample` occupied slots, drawn exactly as ``imt_tpu`` draws
  them (``_sample_slots``), so both packages audit the same slots.  Each
  sampled leaf must verify against the current root through the tree's
  own proof path, hashed with the python-int Poseidon (``hash_fixed``),
  independent of the kernels being audited (``path``); an occupied slot
  must not hold the reserved zero value (``empty``), unless it is the
  empty leaf of a rejected insert, which consumed the slot and which no
  slot links to; its value must be below its successor's, or the
  successor 0 (``order``); and the slot cursor must lie within the tree
  (``cursor``).  It returns a ``HealthReport``, or raises
  ``TreeCorruption`` naming every failure.

  ``imt_tpu``'s audit counts every zero in an occupied slot as ``empty``,
  so it fails a sound tree that has rejected an insert; this one tells
  the two apart by the link, which a zeroed slot keeps and a rejected one
  never had.
* ``Watchdog`` wraps a tree and audits it every `interval` calls to
  ``insert``, ``insert_batch``, ``insert_batches`` or ``insert_seq``
  (each passes its keywords, ``as_numpy=`` and ``witness=``, through), so
  a silently corrupting deployment halts within a bounded number of calls.

With checkpoints (``utils/checkpoint.py``) this is the failure story:
detect in the run, restart from the last atomic snapshot.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from ..ops import field
from ..ops.poseidon_spec import default_params
from ..ops.poseidon_ref import hash_fixed
from .observability import log_event


class TreeCorruption(AssertionError):
    """An invariant audit failed: the tree state is not trustworthy."""


@dataclass
class HealthReport:
    ok: bool
    checked_slots: list
    failures: list = dc_field(default_factory=list)


def _sample_slots(count: int, sample: int, seed: int) -> np.ndarray:
    """Occupied slots to audit: slot 0 (the sentinel) + up to `sample`
    distinct occupied slots (1..count)."""
    rng = np.random.default_rng(seed)
    occ = np.arange(1, count + 1)
    if len(occ) > sample:
        occ = rng.choice(occ, size=sample, replace=False)
    return np.concatenate([[0], np.sort(occ)]).astype(np.int64)


def _linked(tree, slot: int) -> bool:
    """Whether any slot's next_idx points at `slot` (> 0)."""
    want = torch.as_tensor(field.int_to_limbs(slot),
                           device=tree.device)[:, None]
    return bool(field.eq(tree.next_idxs, want).any())


def check_tree(tree, sample: int = 8, seed: int = 0) -> HealthReport:
    """Audit `tree` (``IndexedMerkleTree`` or ``SparseIndexedMerkleTree``,
    on any device).  Raises TreeCorruption on any failure."""
    params = default_params()
    slots = _sample_slots(tree.count, sample, seed)
    root = tree.get_root_int()
    failures = []
    for s in slots.tolist():
        v, nv, ni = tree.get_leaf_ints(s)
        # A zero value in an occupied slot is corruption (inserts never
        # store 0, and skipping such a slot would let a zeroed and rehashed
        # state pass), unless it is a rejected insert's empty leaf: all
        # zero, and linked from no slot, where a zeroed value keeps the
        # link of its predecessor.
        if v == 0 and s != 0:
            if nv or ni or _linked(tree, s):
                failures.append((s, "empty", "occupied slot holds the "
                                 "reserved zero value"))
        elif nv != 0 and not v < nv:
            failures.append((s, "order", f"val={v} next_val={nv}"))
        proof, _ = tree.get_proof(s)
        sibs = field.limbs_to_ints(proof[:, :, 0].T.cpu().numpy())
        acc, idx = hash_fixed([v, nv, ni], params), s
        for sib in sibs:
            acc = (hash_fixed([acc, sib], params) if idx % 2 == 0
                   else hash_fixed([sib, acc], params))
            idx //= 2
        if acc != root:
            failures.append((s, "path", "leaf does not verify against the "
                             "current root"))
    if not 0 <= tree.count < tree.num_slots:
        failures.append((-1, "cursor",
                         f"count={tree.count} cap={tree.num_slots}"))
    report = HealthReport(ok=not failures,
                          checked_slots=slots.tolist(), failures=failures)
    if failures:
        log_event("health_check_failed", failures=failures)
        raise TreeCorruption(f"tree invariant audit failed: {failures}")
    return report


class Watchdog:
    """Wrap a tree; audit its invariants every `interval` mutating calls.

    >>> t = Watchdog(SparseIndexedMerkleTree(32), interval=64)
    >>> t.insert_batch(values)          # delegates; audits on cadence
    """

    _MUTATORS = ("insert", "insert_batch", "insert_batches", "insert_seq")

    def __init__(self, tree, interval: int = 256, sample: int = 8):
        self._tree = tree
        self._interval = interval
        self._sample = sample
        self._ops = 0
        self._audits = 0

    def __getattr__(self, name):
        attr = getattr(self._tree, name)
        if name in self._MUTATORS and callable(attr):
            def wrapped(*a, **kw):
                out = attr(*a, **kw)
                self._ops += 1
                if self._ops % self._interval == 0:
                    self.audit()
                return out
            return wrapped
        return attr

    def audit(self) -> HealthReport:
        self._audits += 1
        report = check_tree(self._tree, sample=self._sample,
                            seed=self._audits)
        log_event("health_check_ok", audits=self._audits,
                  slots=len(report.checked_slots))
        return report
