"""The yardstick of the Poseidon kernels: what the inputs need, and the least
time the card could take for it.

* ``least_perm_work`` / ``PERM_WORK``: frozen copy of
  ``imt_tpu_torch/ops/perm_work.py`` at commit 127fa2b5370957ac: the least
  multiply-adds of one Poseidon-BN254 permutation among the repo's
  schedules (8 x 32-bit limbs: a product 64 wide multiply-adds, a square
  36, a Montgomery reduction 64 wide and 8 narrow; S-box x^5 as two squares
  and a product; MDS dots reduced once; sparse partial rounds with lazy
  column words at the best refresh period).
* ``imad_peak_per_s``: frozen copy of ``ops/vpu_roofline.peak_per_s``
  (``"imad"``) at the same commit: 64 IMAD a clock per SM (NVIDIA's
  Hopper throughput table), each multiply-add counted as one.
* ``needed_hashes``: the hashes an acknowledged group of inserts needs,
  counted from its values: one hash3 per distinct leaf slot whose leaf
  changes, one hash2 per distinct internal node above them up to the
  active prefix's root, and the spine fold of the acknowledged root.
  Every fixed-length hash of 2 or 3 inputs is 2 permutations.
"""

from __future__ import annotations

import numpy as np

from .tree import accepted, keys

R_F, R_P = 8, 57
PRODUCT, SQUARE, REDC_WIDE, REDC_NARROW = 64, 36, 64, 8
PERMS_PER_HASH = 2
IMAD_PER_CLOCK_PER_SM = 64


def least_perm_work(g: int) -> tuple:
    """(wide, 32-bit) multiply-adds of one permutation whose partial rounds
    refresh their column words every g rounds."""
    sbox_w, sbox_n = 2 * SQUARE + PRODUCT + 3 * REDC_WIDE, 3 * REDC_NARROW
    wide = R_F * 3 * (sbox_w + 3 * PRODUCT + REDC_WIDE)
    narrow = R_F * 3 * (sbox_n + REDC_NARROW)
    for start in range(0, R_P, g):
        n = min(g, R_P - start)
        wide += n * sbox_w + sum(3 + d for d in range(n)) * PRODUCT \
            + n * REDC_WIDE + 2 * n * PRODUCT + 2 * REDC_WIDE
        narrow += n * sbox_n + n * REDC_NARROW + 2 * REDC_NARROW
    return wide, narrow


PERM_WORK = min((least_perm_work(g) for g in range(1, 12)), key=sum)


def imad_peak_per_s(sm_count: int, clock_mhz: float) -> float:
    return sm_count * IMAD_PER_CLOCK_PER_SM * clock_mhz * 1e6


def least_seconds(perms: int, sm_count: int, clock_mhz: float) -> float:
    """The least time of `perms` permutations at the card's IMAD peak."""
    return perms * sum(PERM_WORK) / imad_peak_per_s(sm_count, clock_mhz)


def needed_hashes(pre16: np.ndarray, group16: np.ndarray, active_depth: int,
                  full_depth: int) -> dict:
    """Hashes that inserting `group16` [16, n] into a tree that got
    `pre16` [16, m] (slots 1..m) needs before its root can be acknowledged:
    {"hash3": leaves, "hash2": nodes of the active prefix + the spine}."""
    m, n = pre16.shape[1], group16.shape[1]
    ok_all = accepted(np.concatenate([pre16, group16], axis=1))
    ok_pre, ok_new = ok_all[:m], ok_all[m:]
    members = np.concatenate([[0], 1 + np.flatnonzero(ok_pre)])
    mkeys = np.concatenate([[b""], keys(pre16)[ok_pre]]).astype("S32")
    order = np.argsort(mkeys, kind="stable")
    pos = np.searchsorted(mkeys[order], keys(group16)[ok_new], side="left")
    changed = members[order][pos - 1]          # each new value's predecessor
    dirty = np.unique(np.concatenate(
        [changed, m + 1 + np.flatnonzero(ok_new)]))
    nodes = sum(np.unique(dirty >> d).size
                for d in range(1, active_depth + 1))
    return {"hash3": int(dirty.size),
            "hash2": int(nodes + full_depth - active_depth)}
