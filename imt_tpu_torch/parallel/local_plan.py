"""Shard-local batched-insert planner: O(K) collectives whatever N is.

Counterpart of ``imt_tpu.parallel.local_plan``, SPMD over
``torch.distributed``: each rank runs the body that ``jax.shard_map`` runs
per shard, and each collective is a call on the rank's process group
(``collectives.py``, which counts the bytes).  A rank holds a ``Shard``:
the C = 2^ad / D contiguous slots [r C, (r + 1) C) of the leaf state and
the levels of its own subtree; the levels from the D subtree roots up are
replicated on every rank.

Per batch of K values (``imt_tpu`` :10-38):

1. local candidate search: one stable sort of the rank's live slots and
   the K values by (value, is_query) gives, per value q, the largest local
   participant <= q (below1; an equal value sorts before the query, so a
   duplicate is caught) and the smallest one > q (above1);
2. one all-gather of the packed candidates, 2 x D x K x (value, slot,
   flag) as int32: 2 x D x K x 72 bytes, whatever N is;
3. the replicated rank-space plan (``_rank_plan``): acceptance, final
   low and successor, the existing-entry rewrites, by cumulative scans;
4. each rank writes the rows it owns, hashes 1/D of the 2K dirty leaves
   (one all-gather of the hashes), updates its subtree on local
   coordinates (the slab/low split of the single-device update), and,
   once per chain of batches, one all-gather of the D subtree roots feeds
   the replicated rebuild of the top.

``imt_tpu`` drops another rank's rows with ``.at[...].set(mode="drop")`` on
an index one past the end; torch's ``index_put_`` raises on that index and
wraps a negative one.  Here the new-slot rows are a contiguous range known
on the host (the slot cursor), so a rank writes its overlap with a slice;
the other scatters keep their lanes by an explicit mask (``_put_kept``),
and a parent recomputed from the final children of any column is right
whoever owns it, so the path updates clamp instead of dropping.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import field, hashing
from ..tree import batch_witness, indexed
from ..tree.merkle import _dec_path
from . import collectives

# candidate rows of the exchange: value limbs, slot, found
_ROWS = field.LIMBS + 2


@dataclass
class Shard:
    """One rank's part of a sharded tree with 2^active_depth slots held,
    over `n_shards` ranks of which this is `index`.  vals / next_vals /
    next_idxs are the rank's slots [off, off + c) (canonical limbs
    [16, c], c = 2^ad / n_shards); levels[l] for l < l_loc = log2(c) are
    the nodes of its own subtree ([8, c >> l]); levels[l] for l >= l_loc
    are the whole level, the same on every rank ([8, 2^ad >> l]; level
    l_loc holds the subtree roots, this rank's in column `index`)."""

    vals: torch.Tensor
    next_vals: torch.Tensor
    next_idxs: torch.Tensor
    levels: list
    count: int
    active_depth: int
    tree_depth: int
    index: int
    n_shards: int

    @property
    def c(self) -> int:
        return (1 << self.active_depth) // self.n_shards

    @property
    def off(self) -> int:
        return self.index * self.c

    @property
    def l_loc(self) -> int:
        return self.c.bit_length() - 1

    @property
    def device(self) -> torch.device:
        return self.vals.device


def shardable(active_depth: int, d: int) -> bool:
    """Whether the shard-local planner runs on 2^active_depth slots over d
    ranks (``imt_tpu`` sharded.py:326): d > 1, d divides the slots and
    each rank holds at least two."""
    n = 1 << active_depth
    return d > 1 and n % d == 0 and n >= 2 * d


def _check(shard: Shard, mesh) -> None:
    if not shardable(shard.active_depth, mesh.size()):
        raise ValueError(f"2^{shard.active_depth} slots not shardable over "
                         f"{mesh.size()} devices")


def _put_kept(x: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
              val: torch.Tensor) -> None:
    """x[:, idx[i]] = val[:, i] where keep[i], in place, without a host
    sync; the kept targets must lie in range and be unique (CUDA
    index_put_ picks an undefined winner on repeats).  Every dropped lane
    repeats the first kept lane's write; with no lane kept, a spare lane
    writes column 0 back to itself."""
    none = ~keep.any()
    keep = torch.cat([keep, none.view(1)])
    idx = torch.cat([idx.clamp(0, x.shape[1] - 1), idx.new_zeros(1)])
    val = torch.cat([val, x[:, :1]], dim=1)
    first = torch.argmax(keep.to(torch.uint8)).view(1)
    x[:, torch.where(keep, idx, idx[first])] = torch.where(
        keep, val, val.index_select(1, first))


def _put_range(x: torch.Tensor, start: int, rows: torch.Tensor,
               shard: Shard) -> None:
    """x[:, slot - off] = rows[:, slot - start] for the rank's slots among
    [start, start + K)."""
    a = max(start, shard.off)
    b = min(start + rows.shape[1], shard.off + shard.c)
    if a < b:
        x[:, a - shard.off:b - shard.off] = rows[:, a - start:b - start]


def _candidates(shard: Shard, queries: torch.Tensor):
    """Step 1 (``imt_tpu`` :199-227): per query of `queries` [16, K], the
    largest local participant <= it and the smallest > it, as (val, slot,
    found) each, plus each query's position in the local sort (the queries'
    relative order there is the same on every rank: value, then batch
    index).  Only the live slots [off, count] can be participants, so the
    sort takes those and the queries (``indexed.sort_queries``, the
    single-device witness's sort)."""
    dev, k = queries.device, queries.shape[1]
    live = max(0, min(shard.count + 1 - shard.off, shard.c))
    vals = shard.vals[:, :live]
    m = live + k
    order, qpos = indexed.sort_queries(vals, queries)
    participant = torch.cat([~field.is_zero(vals),
                             torch.zeros(k, dtype=torch.bool, device=dev)])
    if shard.off == 0 and live:
        participant[0] = True                   # the slot-0 sentinel
    part_s = participant[order]
    out = []
    for p in indexed._true_neighbours(part_s, qpos):
        found = (p >= 0) & (p < m)
        e = order[p.clamp(0, m - 1)].clamp(max=max(live - 1, 0))
        val = vals[:, e] * found if live else queries * 0
        out.append((val, torch.where(found, shard.off + e, 0), found))
    return out[0], out[1], qpos


def _pack(*cands) -> torch.Tensor:
    """(val [16, K], slot [K], found [K]) triples -> int32 [n * 18, K]."""
    rows = []
    for val, slot, found in cands:
        rows += [val.to(torch.int32), slot.to(torch.int32)[None],
                 found.to(torch.int32)[None]]
    return torch.cat(rows)


def _unpack(g: torch.Tensor, i: int):
    """The i-th triple of a gathered pack [D, n * 18, K] -> ([D, 16, K],
    [D, K] int64, [D, K] bool)."""
    r = i * _ROWS
    return (g[:, r:r + field.LIMBS], g[:, r + field.LIMBS].to(torch.int64),
            g[:, r + field.LIMBS + 1] != 0)


def _lex_reduce(cand_val, cand_slot, cand_found, take_max: bool):
    """[D, 16, K] / [D, K] candidates -> the global best per query, the
    max or min by value (``imt_tpu`` :156; participant values are
    globally unique, so there is no tie)."""
    best_v, best_s, best_f = cand_val[0], cand_slot[0], cand_found[0]
    for i in range(1, cand_val.shape[0]):
        v, s, f = cand_val[i], cand_slot[i], cand_found[i]
        beats = field.less_than(best_v, v) if take_max else \
            field.less_than(v, best_v)
        better = f & (~best_f | beats)
        best_v = torch.where(better, v, best_v)
        best_s = torch.where(better, s, best_s)
        best_f = best_f | f
    return best_v, best_s, best_f


def _exchange(shard: Shard, queries: torch.Tensor, group):
    """Steps 1 and 2: local candidates, one all-gather, the global below1
    (max) and above1 (min) per query, and each query's local position."""
    lo, hi, qpos = _candidates(shard, queries)
    g = collectives.all_gather(_pack(lo, hi), group, what="candidates")
    return (_lex_reduce(*_unpack(g, 0), take_max=True),
            _lex_reduce(*_unpack(g, 1), take_max=False), qpos)


def _rank_plan(new_vals, slots, qpos, blo_v, blo_s, blo_f, bhi_v, bhi_s,
               bhi_f, k: int) -> dict:
    """The replicated rank-space planner (``imt_tpu`` :67-153; its
    docstring carries the proof of each reduction).  In new-value rank
    order the global candidates are monotone: a value is rejected iff it
    ties its below1 participant or the previous rank's value; its final low
    is the later of below1 and the previous accepted value, its final
    successor the earlier of above1 and the next accepted value.

    `qpos` int[K] is each query's position in a local sort; its argsort is
    the rank -> batch permutation.  Returns, in batch order: ok, lo_is_new
    (the final low is a new value), low_slot, fin_succ_val, fin_succ_slot,
    has_fin; and vrank / brank (rank -> batch, batch -> rank) with acc_r
    (acceptance in rank order) for the temporal planner.  ``imt_tpu``'s
    low_val output, which no caller reads, is left out."""
    dev = new_vals.device
    iota = torch.arange(k, device=dev)
    vrank = torch.sort(qpos, stable=True).indices
    brank = torch.empty_like(vrank)
    brank[vrank] = iota

    def t_r(a):
        return a[..., vrank]

    def b_r(a):
        return a[..., brank]

    v_r, slot_r = t_r(new_vals), t_r(slots)
    blo_v_r, blo_s_r, blo_f_r = t_r(blo_v), t_r(blo_s), t_r(blo_f)
    bhi_v_r, bhi_s_r, bhi_f_r = t_r(bhi_v), t_r(bhi_s), t_r(bhi_f)

    dup_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                          (v_r[:, 1:] == v_r[:, :-1]).all(dim=0)])
    dup_part = blo_f_r & (v_r == blo_v_r).all(dim=0)
    acc_r = ~dup_prev & ~dup_part

    pa = torch.where(acc_r, iota, -1).cummax(0).values   # prev accepted
    pa = torch.cat([pa.new_full((1,), -1), pa[:-1]])
    pa_c = pa.clamp(0, k - 1)
    lo_is_new_r = (pa >= 0) & (~blo_f_r | field.less_than(blo_v_r,
                                                          v_r[:, pa_c]))
    low_slot_r = torch.where(lo_is_new_r, slot_r[pa_c], blo_s_r)

    na = torch.where(acc_r, iota, k).flip(0).cummin(0).values.flip(0)
    na = torch.cat([na[1:], na.new_full((1,), k)])       # next accepted
    has_na = na < k
    na_c = na.clamp(0, k - 1)
    v_na = v_r[:, na_c]
    succ_is_new_r = has_na & (~bhi_f_r | field.less_than(v_na, bhi_v_r))
    fin_succ_val_r = torch.where(succ_is_new_r, v_na,
                                 torch.where(bhi_f_r, bhi_v_r, 0))
    fin_succ_slot_r = torch.where(succ_is_new_r, slot_r[na_c],
                                  torch.where(bhi_f_r, bhi_s_r, 0))
    return dict(vrank=vrank, brank=brank, acc_r=acc_r, ok=b_r(acc_r),
                lo_is_new=b_r(lo_is_new_r), low_slot=b_r(low_slot_r),
                fin_succ_val=b_r(fin_succ_val_r),
                fin_succ_slot=b_r(fin_succ_slot_r),
                has_fin=b_r(has_na | bhi_f_r))


def exchange_bytes(d: int, k: int, b: int = 1) -> int:
    """Bytes one rank's collectives return over a chain of `b` batches
    (``imt_tpu`` :17-18): per batch the candidates, 2 x D x K x (value 64
    + slot 4 + flag 4), and the 2K dirty-leaf hash columns (padded to a
    multiple of D) as nodes of 32 bytes; once per chain the D subtree
    roots."""
    per_batch = 2 * d * k * _ROWS * 4 + (2 * k + (-2 * k) % d) \
        * field.WORDS * 4
    return b * per_batch + d * field.WORDS * 4


# ---------------------------------------------------------------------------
# insert_batch / insert_batches
# ---------------------------------------------------------------------------

def _insert_one(shard: Shard, lower: list, new_vals: torch.Tensor, group,
                k: int) -> torch.Tensor:
    """One planned batch (``imt_tpu`` ``batch_body``, :198-328) on the
    rank's state and its subtree levels `lower` (levels 0 .. l_loc, the
    last its own root [8, 1]), in place.  Returns ok bool[K]."""
    c, off, dev = shard.c, shard.off, shard.device
    d, r = shard.n_shards, shard.index
    (blo_v, blo_s, blo_f), (bhi_v, bhi_s, bhi_f), qpos = _exchange(
        shard, new_vals, group)
    s0 = shard.count + 1
    slots = s0 + torch.arange(k, device=dev)
    rp = _rank_plan(new_vals, slots, qpos, blo_v, blo_s, blo_f, bhi_v,
                    bhi_s, bhi_f, k)
    ok = rp["ok"]
    nrow_val = torch.where(ok, new_vals, 0)
    nrow_nv = torch.where(ok, rp["fin_succ_val"], 0)
    nrow_ni = indexed.index_to_limbs(torch.where(ok, rp["fin_succ_slot"], 0))
    # the existing entries whose pointers change: the low of an accepted
    # value when that low is a participant (targets unique, ``imt_tpu``
    # :247-254)
    wr_k = ok & ~rp["lo_is_new"]
    wr_nv = torch.where(wr_k, new_vals, 0)
    wr_ni = indexed.index_to_limbs(torch.where(wr_k, slots, 0))
    wr_val = torch.where(wr_k, blo_v, 0)

    # ---- 4a. the rows this rank owns -----------------------------------
    for x, rows in ((shard.vals, nrow_val), (shard.next_vals, nrow_nv),
                    (shard.next_idxs, nrow_ni)):
        _put_range(x, s0, rows, shard)
    wr_loc = blo_s - off
    wr_keep = wr_k & (wr_loc >= 0) & (wr_loc < c)
    _put_kept(shard.next_vals, wr_loc, wr_keep, wr_nv)
    _put_kept(shard.next_idxs, wr_loc, wr_keep, wr_ni)

    # ---- 4b. the 2K dirty leaf hashes, 1/d of them per rank --------------
    pad = (-2 * k) % d
    per = (2 * k + pad) // d
    cols = [torch.cat([a, b, a.new_zeros((field.LIMBS, pad))], dim=1)
            [:, r * per:(r + 1) * per].contiguous()
            for a, b in ((nrow_val, wr_val), (nrow_nv, wr_nv),
                         (nrow_ni, wr_ni))]
    dirty = collectives.all_gather(hashing.hash3_leaf(*cols), group, dim=1,
                                   what="leaf_hashes")

    # ---- 4c. the subtree: slab/low split on local coordinates -----------
    _put_range(lower[0], s0, dirty[:, :k], shard)
    _put_kept(lower[0], wr_loc, wr_keep, dirty[:, k:2 * k])
    # a lane whose rewrite is not this rank's follows a clamped path: it
    # recomputes a parent from its final children, which writes the value
    # that parent already has or must have
    cur = wr_loc.clamp(0, c - 1)
    s, w = max(0, min(s0 - off, max(c - k, 0))), k
    for lvl in range(shard.l_loc):
        level, width = lower[lvl], c >> lvl
        if 2 * k >= width // 2:
            # every level from here up is rebuilt whole
            indexed.rebuild_levels(lower, lvl, shard.l_loc)
            break
        # the slab window and the K rewrite paths in one launch
        wp = w // 2 + 1
        ps = max(min(s >> 1, width // 2 - wp), 0)
        kids = level[:, 2 * ps:2 * (ps + wp)]
        parent = cur >> 1
        h = hashing.hash2_nodes(
            torch.cat([kids[:, 0::2], level[:, parent * 2]], dim=1),
            torch.cat([kids[:, 1::2], level[:, parent * 2 + 1]], dim=1))
        lower[lvl + 1][:, ps:ps + wp] = h[:, :wp]
        lower[lvl + 1][:, parent] = h[:, wp:]
        cur, s, w = parent, ps, wp
    shard.count += k
    return ok


def _rebuild_top(shard: Shard, root: torch.Tensor, group) -> None:
    """ONE all-gather of the D subtree roots, then the replicated levels
    above them rebuilt on every rank."""
    lv = shard.levels
    lv[shard.l_loc] = collectives.all_gather(root, group, dim=1,
                                             what="roots")
    indexed.rebuild_levels(lv, shard.l_loc, shard.active_depth)


def local_insert_batches(shard: Shard, new_vals: torch.Tensor, mesh, k: int,
                         b: int) -> torch.Tensor:
    """B chained shard-local batches (``imt_tpu`` :433): `new_vals`
    [B, 16, K], the same on every rank; each batch plans, exchanges and
    updates the rank's subtree, and the root gather and the top rebuild
    run once after the last.  Mutates the shard; returns ok bool[B, K]."""
    _check(shard, mesh)
    group = mesh.get_group()
    name = "insert_batch" if b == 1 else "insert_batches"
    with collectives.program(name):
        lv = shard.levels
        lower = lv[:shard.l_loc] + [
            lv[shard.l_loc][:, shard.index:shard.index + 1].clone()]
        oks = [_insert_one(shard, lower, new_vals[i], group, k)
               for i in range(b)]
        lv[:shard.l_loc] = lower[:-1]
        _rebuild_top(shard, lower[-1], group)
    return torch.stack(oks)


def local_insert_batch(shard: Shard, new_vals: torch.Tensor, mesh,
                       k: int) -> torch.Tensor:
    """One shard-local planned batch (``imt_tpu`` :415): `new_vals`
    [16, K], the same on every rank.  Mutates the shard; returns ok
    bool[K] (the same on every rank)."""
    return local_insert_batches(shard, new_vals[None], mesh, k, 1)[0]


# ---------------------------------------------------------------------------
# non_inclusion_witness
# ---------------------------------------------------------------------------

def local_non_inclusion_witness(shard: Shard, queries: torch.Tensor,
                                mesh, k: int) -> dict:
    """Shard-local non-inclusion witnesses (``imt_tpu`` :468-605): each
    rank's below1 candidate with its pointers, one all-gather, the global
    low leaf; the proof's sharded levels from the owner rank (one psum for
    all of them, every other rank adding zeros), the levels above from the
    replicated top.  Read-only; returns the NonInclusionWitness fields,
    the same on every rank."""
    _check(shard, mesh)
    group = mesh.get_group()
    c, off = shard.c, shard.off
    with collectives.program("non_inclusion_witness"):
        (lo_v, lo_s, lo_f), _, _ = _candidates(shard, queries)
        lc = (lo_s - off).clamp(0, c - 1)
        nv = shard.next_vals[:, lc] * lo_f
        ni = shard.next_idxs[:, lc] * lo_f
        g = collectives.all_gather(torch.cat(
            [_pack((lo_v, lo_s, lo_f)), nv, ni]), group, what="candidates")
        cand_v, cand_s, cand_f = _unpack(g, 0)
        cand_nv, cand_ni = (g[:, _ROWS:_ROWS + field.LIMBS],
                            g[:, _ROWS + field.LIMBS:])
        best_v, best_s, best_f = cand_v[0], cand_s[0], cand_f[0]
        best_nv, best_ni = cand_nv[0], cand_ni[0]
        for i in range(1, shard.n_shards):
            f = cand_f[i]
            better = f & (~best_f | field.less_than(best_v, cand_v[i]))
            best_v = torch.where(better, cand_v[i], best_v)
            best_nv = torch.where(better, cand_nv[i], best_nv)
            best_ni = torch.where(better, cand_ni[i], best_ni)
            best_s = torch.where(better, cand_s[i], best_s)
            best_f = best_f | f
        low = torch.where(best_f, best_s, 0)
        ok = best_f & field.less_than(best_v, queries) & (
            field.less_than(queries, best_nv) | field.is_zero(best_nv))

        # the sharded levels' siblings from the owner: ONE psum, every
        # other rank adding zeros
        owned = (low >= off) & (low < off + c)
        cur = (low - off).clamp(0, c - 1)
        lv, l_loc = shard.levels, shard.l_loc
        sibs = torch.stack([lv[lvl][:, (cur >> lvl) ^ 1]
                            for lvl in range(l_loc)])
        proof = list(collectives.psum(torch.where(owned, sibs, 0), group,
                                      what="proof_levels"))
        proof += [lv[lvl][:, (low >> lvl) ^ 1]
                  for lvl in range(l_loc, shard.active_depth)]
        helpers = [(((low >> lvl) & 1) == 0).to(torch.int32)
                   for lvl in range(shard.active_depth)]
    ad, full = shard.active_depth, shard.tree_depth
    proof, helpers = indexed._extend_proof(torch.stack(proof),
                                           torch.stack(helpers), ad, full)
    root = hashing.dec_nodes(indexed._spine_fold(lv[ad], ad, full)) \
        .expand(field.LIMBS, k).contiguous()
    return dict(ok=ok, root=root, low_leaf_val=best_v,
                low_leaf_next_val=best_nv, low_leaf_next_idx=best_ni,
                low_leaf_proof=_dec_path(proof),
                low_leaf_proof_helper=helpers,
                is_new_leaf_largest=field.is_zero(best_nv))


# ---------------------------------------------------------------------------
# the witness-producing batch
# ---------------------------------------------------------------------------

def local_insert_batch_witness(shard: Shard, new_vals: torch.Tensor, mesh,
                               k: int) -> dict:
    """Shard-local witness-producing batch (``imt_tpu`` :625-861): the
    insert planner's exchange and rank plan, the final state written by
    the owner ranks, the temporal (ANSV) plan in rank space, then the
    level-synchronous walk of ``tree/batch_witness.py`` run replicated (2K
    hashes per level on every rank) with the pre-batch nodes of the
    sharded levels read from their owners (one psum before the walk) and
    the updates written by the owners.  No root gather: the walk computes the
    levels above the subtree roots on every rank.  Mutates the shard;
    returns the InsertWitness fields (roots and proofs as nodes of the
    active prefix, as ``batch_witness.insert_batch_witness`` does)."""
    _check(shard, mesh)
    group = mesh.get_group()
    c, off, dev, r = shard.c, shard.off, shard.device, shard.index
    with collectives.program("insert_batch_witness"):
        (blo_v, blo_s, blo_f), (bhi_v, bhi_s, bhi_f), qpos = _exchange(
            shard, new_vals, group)
        s0 = shard.count + 1
        slots = s0 + torch.arange(k, device=dev)
        rp = _rank_plan(new_vals, slots, qpos, blo_v, blo_s, blo_f, bhi_v,
                        bhi_s, bhi_f, k)
        ok = rp["ok"]

        # ---- the final state, written by the owners ---------------------
        fin = ok & rp["has_fin"]
        fin_val = torch.where(fin, rp["fin_succ_val"], 0)
        fin_slot = torch.where(fin, rp["fin_succ_slot"], 0)
        low_loc = rp["low_slot"] - off
        low_keep = ok & (low_loc >= 0) & (low_loc < c)
        new_rows = torch.where(ok, new_vals, 0)
        _put_range(shard.vals, s0, new_rows, shard)
        _put_kept(shard.next_vals, low_loc, low_keep, new_rows)
        _put_range(shard.next_vals, s0, fin_val, shard)
        _put_kept(shard.next_idxs, low_loc, low_keep,
                  indexed.index_to_limbs(torch.where(ok, slots, 0)))
        _put_range(shard.next_idxs, s0, indexed.index_to_limbs(fin_slot),
                   shard)

        # ---- temporal planning (ANSV in rank space, ``imt_tpu`` :706-744)
        vrank, brank, acc_r = rp["vrank"], rp["brank"], rp["acc_r"]
        v_r, slot_r = new_vals[:, vrank], slots[vrank]
        blo_v_r, blo_s_r, blo_f_r = blo_v[:, vrank], blo_s[vrank], \
            blo_f[vrank]
        bhi_v_r, bhi_s_r, bhi_f_r = bhi_v[:, vrank], bhi_s[vrank], \
            bhi_f[vrank]
        sigma = torch.where(acc_r, vrank, batch_witness._NEVER)
        lo_r, lo_f = batch_witness._ansv_prev(sigma, vrank)
        hi_rev, hi_f_rev = batch_witness._ansv_prev(sigma.flip(0),
                                                    vrank.flip(0))
        hi_r, hi_f = k - 1 - hi_rev.flip(0), hi_f_rev.flip(0)
        tl_val = v_r[:, lo_r]
        tlo_new = lo_f & (~blo_f_r | field.less_than(blo_v_r, tl_val))
        low_val = torch.where(tlo_new, tl_val, blo_v_r)[:, brank]
        low_slot = torch.where(tlo_new, slot_r[lo_r], blo_s_r)[brank]
        th_val = v_r[:, hi_r]
        thi_new = hi_f & (~bhi_f_r | field.less_than(th_val, bhi_v_r))
        succ_val = torch.where(thi_new, th_val,
                               torch.where(bhi_f_r, bhi_v_r, 0))[:, brank]
        succ_slot = torch.where(thi_new, slot_r[hi_r],
                                torch.where(bhi_f_r, bhi_s_r, 0))[brank]
        succ_idx = indexed.index_to_limbs(succ_slot)

        # ---- the 2K leaf updates, replicated; then the walk -------------
        z = lambda x: torch.where(ok, x, 0)
        upd_val = hashing.hash3_leaf(
            torch.cat([z(new_vals), z(low_val)], dim=1),
            torch.cat([z(succ_val), z(new_vals)], dim=1),
            torch.cat([z(succ_idx), z(indexed.index_to_limbs(slots))],
                      dim=1))
        # the pre-batch query nodes of the sharded levels, (path >> lvl) ^ 1,
        # read from their owners in ONE psum before the walk (``imt_tpu``
        # :757-769): a level is written only after its own read
        lv, l_loc = shard.levels, shard.l_loc
        l_path = torch.where(ok, low_slot, slots)
        parts = []
        for lvl in range(l_loc):
            w = c >> lvl
            li = torch.cat([l_path >> lvl, slots >> lvl]) ^ 1
            li = li - r * w
            mine = (li >= 0) & (li < w)
            parts.append(torch.where(mine, lv[lvl][:, li.clamp(0, w - 1)],
                                     0))
        bases = collectives.psum(torch.stack(parts), group, what="bases")

        def base(lvl, qnode):
            return bases[lvl] if lvl < l_loc else lv[lvl][:, qnode]

        def scatter(lvl, idx, keep, val):
            if lvl >= l_loc:
                batch_witness._scatter_level(lv[lvl], idx, keep, val)
                return
            w = c >> lvl
            li = idx - r * w
            _put_kept(lv[lvl], li, keep & (li >= 0) & (li < w), val)

        (low_proof, new_proof, low_help, new_help, old_root,
         new_root) = batch_witness.witness_walk(
            None, l_path, slots, s0, upd_val,
            (lv[shard.active_depth], 1 << shard.active_depth, base,
             scatter))
    shard.count += k
    return dict(
        ok=ok, old_root=old_root, low_leaf_val=low_val,
        low_leaf_next_val=succ_val, low_leaf_next_idx=succ_idx,
        low_leaf_proof=low_proof, low_leaf_proof_helper=low_help,
        new_root=new_root, new_leaf_val=new_vals,
        new_leaf_next_val=succ_val, new_leaf_next_idx=succ_idx,
        new_leaf_index=slots.to(torch.int32), new_leaf_proof=new_proof,
        new_leaf_proof_helper=new_help,
        is_new_leaf_largest=field.is_zero(succ_val))
