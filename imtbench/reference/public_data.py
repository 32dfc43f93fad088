"""Aztec's public data tree, written again from the protocol's rules
(aztec-packages: ``PublicDataTreeLeafPreimage { slot, value, next_slot,
next_index }`` and the base rollup's public-data writes), not taken from
the program.

A tree of 2^depth slots starts with every leaf (0, 0, 0, 0); slot 0 is the
sentinel, whose slot is 0 and which no write changes.  Write number j of a tree takes slot j + 1, whatever its
outcome.  A write of a slot not yet in the tree is an insert: the slot's
leaf joins the sorted list after its low leaf (the largest slot below it).
A write of a slot already in the tree (or written earlier in the same
batch) is an update: the leaf that holds the slot takes the value, and the
write's own slot stays empty; of several writes to one slot the last
wins.  A write of slot 0 is rejected.  Since every write lands in stream
order, the state after a stream is that of the whole stream at once, so
nothing here depends on how the stream was cut into batches.

A leaf hashes as H4(slot, value, next_slot, next_index), the fixed-length
sponge of four inputs (three permutations), a node as H(left, right), an
empty subtree of level d as ``zero_hashes(depth)[d]``, from H4(0, 0, 0, 0).

Values cross this module as canonical 16-bit limbs ``[16, n]`` (numpy);
slot order is the order of ``tree.keys``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .poseidon import Hasher, N, hash_int
from .tree import _HOST_WIDTH, keys

# the Hasher's MDS products are float64 matmuls: no TF32 on any path
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REJECTED, INSERTED, UPDATED = 0, 1, 2
PERMS_LEAF, PERMS_NODE = 3, 2


@lru_cache(maxsize=None)
def zero_hashes(depth: int) -> tuple:
    """Node value of an all-empty subtree per level 0..depth: H4(0,0,0,0),
    then H(z, z)."""
    z = [hash_int([0, 0, 0, 0])]
    for _ in range(depth):
        z.append(hash_int([z[-1], z[-1]]))
    return tuple(z)


def _groups(keys16: np.ndarray):
    """(order, first, last, nonzero) of a stream's slots: the stable sort
    by slot, and by sorted position whether the entry is its slot's first
    write, its last, and whether the slot is nonzero."""
    k = keys(np.asarray(keys16))
    order = np.argsort(k, kind="stable")
    ks = k[order]
    new = ks[1:] != ks[:-1]
    first = np.concatenate([[True], new])
    last = np.concatenate([new, [True]])
    return order, first, last, np.asarray(keys16).any(axis=0)[order]


def _outcomes(order, first, nonzero) -> np.ndarray:
    out = np.empty(order.size, dtype=np.int8)
    out[order] = np.where(nonzero, np.where(first, INSERTED, UPDATED),
                          REJECTED)
    return out


def outcomes(keys16: np.ndarray) -> np.ndarray:
    """int8[n]: each write's outcome in a stream written in order into an
    empty tree (0 rejected, 1 inserted, 2 updated)."""
    order, first, _, nonzero = _groups(keys16)
    return _outcomes(order, first, nonzero)


def leaf_state(keys16: np.ndarray, values16: np.ndarray):
    """The leaves of slots 0..n after writing the stream (`keys16`,
    `values16`, [16, n] each) into an empty tree: (slot, value, next_slot,
    next_index) as int64 [16, n + 1] each."""
    keys16, values16 = np.asarray(keys16), np.asarray(values16)
    n = keys16.shape[1]
    order, first, last, nonzero = _groups(keys16)
    heads, tails = order[first & nonzero], order[last & nonzero]
    chain = np.concatenate([[0], 1 + heads])       # the sentinel is least
    # built slot-major ([n + 1, 16], rows contiguous) for the gathers
    key = np.zeros((n + 1, 16), dtype=np.int64)
    key[chain[1:]] = keys16.T[heads]
    val = np.zeros((n + 1, 16), dtype=np.int64)
    val[chain[1:]] = values16.T[tails]
    nk = np.zeros((n + 1, 16), dtype=np.int64)
    nk[chain[:-1]] = key[chain[1:]]
    ni = np.zeros((n + 1, 16), dtype=np.int64)
    ni[chain[:-1], 0] = chain[1:] & 0xFFFF
    ni[chain[:-1], 1] = chain[1:] >> 16
    return key.T, val.T, nk.T, ni.T


def _sponge(h: Hasher, words: list) -> torch.Tensor:
    """The fixed-length sponge of any arity over Montgomery limbs [N, B]
    (``poseidon.hash_int``'s rule on the Hasher's lanes): chunks of two
    added into words 1 and 2, a permutation after each, the pad 1 last."""
    b = words[0].shape[-1]
    s = h.iv.expand(3, N, b).clone()
    seq = list(words) + [h.one_m.expand(N, b)]
    for i in range(0, len(seq), 2):
        add = torch.stack(seq[i:i + 2])
        w = 1 + add.shape[0]
        s = h.permute(torch.cat([s[:1], h._add(s[1:w], add), s[w:]]))
    return s[1]


def leaf_nodes(h: Hasher, *cols) -> torch.Tensor:
    """H4 leaf hashes (Montgomery limbs [10, n]) of the limb arrays
    (slot, value, next_slot, next_index), [16, n] each."""
    out = []
    for i in range(0, cols[0].shape[1], h.chunk):
        s = slice(i, i + h.chunk)
        out.append(_sponge(h, [h.to_mont(torch.from_numpy(
            np.ascontiguousarray(x[:, s]))) for x in cols]))
    return torch.cat(out, dim=1)


def root_of_level(h: Hasher, nodes: torch.Tensor, level: int,
                  depth: int) -> int:
    """The depth-`depth` root over the occupied nodes [10, w] of `level`,
    whose slots from w on are empty subtrees of this tree's zero chain."""
    z = zero_hashes(depth)
    while nodes.shape[1] > _HOST_WIDTH:
        if nodes.shape[1] % 2:
            nodes = torch.cat([nodes, h.const(z[level], 1)], dim=1)
        nodes = h.hash2(nodes[:, 0::2].contiguous(),
                        nodes[:, 1::2].contiguous())
        level += 1
    ints = h.to_ints(nodes)
    while level < depth:
        if len(ints) % 2:
            ints.append(z[level])
        ints = [hash_int([ints[i], ints[i + 1]])
                for i in range(0, len(ints), 2)]
        level += 1
    return ints[0]


def tree_root(h: Hasher, keys16: np.ndarray, values16: np.ndarray,
              depth: int) -> int:
    """Root of a depth-`depth` tree after writing the stream."""
    return root_of_level(h, leaf_nodes(h, *leaf_state(keys16, values16)), 0,
                         depth)


def needed_perms(pre16: np.ndarray, group16: np.ndarray, active_depth: int,
                 full_depth: int) -> int:
    """Permutations that writing the slots `group16` [16, n] into a tree
    that got the slots `pre16` [16, m] (writes 1..m) needs before its root
    can be acknowledged: 3 a distinct leaf written (an insert's new slot
    and its low leaf, the slot an update writes, each once, even where the
    value written is the one it held), 2 a distinct node above them up to
    the active prefix's root, and 2 a level of the spine."""
    m = pre16.shape[1]
    stream = np.concatenate([pre16, group16], axis=1)
    order, first, _, nonzero = _groups(stream)
    out = _outcomes(order, first, nonzero)
    # each write's leader: the slot of its slot's first write
    start = np.maximum.accumulate(np.where(first, np.arange(order.size), 0))
    leader = np.empty(order.size, dtype=np.int64)
    leader[order] = 1 + order[start]
    ins = np.flatnonzero(out[m:] == INSERTED)
    upd = np.flatnonzero(out[m:] == UPDATED)
    members = np.concatenate([[0], 1 + np.flatnonzero(out[:m] == INSERTED)])
    mkeys = np.concatenate(
        [[b""], keys(pre16)[out[:m] == INSERTED]]).astype("S32")
    srt = np.argsort(mkeys, kind="stable")
    pos = np.searchsorted(mkeys[srt], keys(group16)[ins], side="left")
    dirty = np.unique(np.concatenate([members[srt][pos - 1], m + 1 + ins,
                                      leader[m + upd]]))
    nodes = sum(np.unique(dirty >> d).size
                for d in range(1, active_depth + 1))
    return PERMS_LEAF * int(dirty.size) \
        + PERMS_NODE * int(nodes + full_depth - active_depth)
