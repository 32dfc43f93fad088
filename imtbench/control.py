#!/usr/bin/env python3
"""The check's control and its planted faults: runs of a cell with the
program's timed path changed underneath, each of which the check must
find not correct.  The benchmark's own runs never use this.

    python3 imtbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s> [--kind control]

Kinds (``patched``), each a patch of the program's tree class:

* ``control``: the step that would tempt a later PR, with the guarantee
  the configurations state broken.  Block sync acknowledges a group's
  root before its last block is in the tree (a pipelined
  acknowledgement); proving hands out bundles whose intermediate roots are
  the block's first old root and last new root (skipping the walk's
  per-insert roots).
* ``unchanged``: each step leaves the tree's state as it was.
* ``half``: half of each block is left out, the rest reported as if it
  were the whole.
* ``altered``: one answer changed where it is produced (a root's or a
  witness root's lowest bit).

Prints one line per seed: the kind, the seed, ``correct`` and the checks.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KINDS = ("control", "unchanged", "half", "altered")


def _flip_root(w, name):
    """The lowest bit of the root of the last lane that is ok."""
    ok = np.flatnonzero(np.asarray(w.ok))
    root = getattr(w, name).clone()
    root[0, ok[-1] if ok.size else -1] ^= 1
    setattr(w, name, root)
    return w


def _doubled(w):
    """A witness of half the lanes, each lane given twice."""
    for name, v in vars(w).items():
        cat = np.concatenate if isinstance(v, np.ndarray) else torch.cat
        setattr(w, name, cat([v, v], -1))
    return w


@contextlib.contextmanager
def patched(kind: str):
    """Patch imt_tpu_torch's tree class for the duration (every instance,
    dense and sparse)."""
    from imt_tpu_torch.tree.indexed import IndexedMerkleTree as T
    names = ("insert_batches", "insert_batch", "get_root_int")
    saved = {n: getattr(T, n) for n in names}
    ibs, ib, root = (saved[n] for n in names)

    def keep_state(self, fn):
        state = [x.clone() for x in (self.vals, self.next_vals,
                                     self.next_idxs)]
        levels = [lv.clone() for lv in self.levels]
        count, live = self.count, self._live
        out = fn()
        self.vals, self.next_vals, self.next_idxs = state
        self.levels, self.count, self._live = levels, count, live
        return out

    if kind == "control":
        def insert_batches(self, values, as_numpy=True):
            head = ibs(self, values[:-1], as_numpy)
            self._acked_root = root(self)
            return np.concatenate([head, ibs(self, values[-1:], as_numpy)])

        def get_root_int(self):
            return self.__dict__.pop("_acked_root", None) or root(self)

        def insert_batch(self, values, witness=False, as_numpy=True):
            w = ib(self, values, witness, as_numpy)
            if witness:
                w.new_root = w.new_root[:, -1:].expand_as(w.new_root) \
                    .contiguous()
                w.old_root = w.old_root[:, :1].expand_as(w.old_root) \
                    .contiguous()
            return w
    elif kind == "unchanged":
        def insert_batches(self, values, as_numpy=True):
            return keep_state(self, lambda: ibs(self, values, as_numpy))

        def insert_batch(self, values, witness=False, as_numpy=True):
            return keep_state(self, lambda: ib(self, values, witness,
                                               as_numpy))
        get_root_int = root
    elif kind == "half":
        def insert_batches(self, values, as_numpy=True):
            k = values.shape[-1]
            ok = ibs(self, np.ascontiguousarray(values[..., :k // 2]),
                     as_numpy)
            return np.concatenate([ok, ok], axis=-1)

        def insert_batch(self, values, witness=False, as_numpy=True):
            k = values.shape[-1]
            w = ib(self, np.ascontiguousarray(values[:, :k // 2]), witness,
                   as_numpy)
            if not witness:
                return np.concatenate([w, w])
            return _doubled(w)
        get_root_int = root
    elif kind == "altered":
        insert_batches = ibs

        def get_root_int(self):
            return root(self) ^ 1

        def insert_batch(self, values, witness=False, as_numpy=True):
            w = ib(self, values, witness, as_numpy)
            return _flip_root(w, "new_root") if witness else w
    else:
        raise ValueError(f"unknown kind {kind!r}")
    for n, f in zip(names, (insert_batches, insert_batch, get_root_int)):
        setattr(T, n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(T, n, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--kind", choices=KINDS, default="control")
    args = ap.parse_args(argv)
    from imtbench import run
    for seed in (int(s) for s in args.seeds.split(",")):
        with patched(args.kind):
            line = run.run_cell(args.workload, seed, args.seconds, False)
        print(json.dumps({"kind": args.kind, "seed": seed,
                          "correct": line["correct"],
                          "checks": line["checks"],
                          "notes": line["notes"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
