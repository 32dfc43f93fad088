"""Witness-producing batched insert, on torch tensors.

Counterpart of ``imt_tpu.tree.batch_witness``: the ``InsertWitness`` of all
K inserts of a batch, equal on its accepted lanes to what K sequential
inserts give (the reference's discipline, src/indexed_merkle_tree.rs:
710-802), with every hash at batch width 2K instead of 2.

* Temporal planning.  Insert i's low leaf is the largest value below v_i in
  the list AFTER inserts 0..i-1, not in the final list.  In value order it
  is the nearest position to the left whose insert step precedes i's:
  existing participants (step -1) resolve with one cumulative max,
  intra-batch chains with an all-nearest-smaller-values descent over the K
  new entries (``_ansv_prev``).  The successor is the mirror query.
* Level-synchronous walk (``_witness_walk``).  Each insert updates two
  leaves (its slot and its low leaf), so every level sees 2K timestamped
  node updates; the proof siblings each insert needs ("node n after step
  t") resolve with one stable sort per level, and the 2K parent hashes run
  as one launch.  The root level yields every intermediate root.

The final-list sort and links are ``indexed._sort_batch`` and
``indexed._link_batch``, which the plain batched insert runs too.  The
state and the levels are updated IN PLACE, as the batched insert does: each
level is read for the proofs before the walk writes it.  Rejected lanes
(duplicates, zero) get ok=False and the same well-defined fields
``imt_tpu`` computes for them; parity with sequential inserts holds on the
accepted lanes.
"""

from __future__ import annotations

import torch

from ..ops import field, hashing
from . import indexed

# the largest step: no insert step reaches it
_NEVER = 2 ** 31 - 1


def _ansv_prev(sigma: torch.Tensor, thresholds: torch.Tensor):
    """All nearest smaller values (``imt_tpu`` :61): for each r in 0..K-1,
    the largest r' < r with sigma[r'] < thresholds[r].  A sparse table of
    block minima and a binary descent from r: O(K log K), no sequential
    scan.  Returns (r' clamped into [0, K-1], found) as int64[K] /
    bool[K]."""
    k = sigma.shape[0]
    logk = max((k - 1).bit_length(), 1)
    # tables[j][r] = min sigma over [r - 2^j + 1, r]
    tables = [sigma]
    for j in range(1, logk + 1):
        w = 1 << (j - 1)
        prev = tables[-1]
        tables.append(torch.minimum(prev, torch.cat(
            [torch.full((w,), _NEVER, dtype=sigma.dtype,
                        device=sigma.device), prev[:-w]])))
    pos = torch.arange(k, device=sigma.device)     # exclusive upper bound
    for j in range(logk, -1, -1):
        w = 1 << j
        blockmin = tables[j][(pos - 1).clamp(0, k - 1)]
        pos = torch.where((pos >= w) & (blockmin >= thresholds), pos - w,
                          pos)
    return (pos - 1).clamp(0, k - 1), pos > 0


def _set_kept(size: int, fill, idx: torch.Tensor, keep: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """A length-`size` vector of `fill` with val[i] at idx[i] where
    keep[i]: ``jnp.full(size, fill).at[where(keep, idx, size)].set(val,
    mode="drop")`` with the mask explicit.  The dropped lanes write a spare
    element past the end, which is cut off; the kept targets must be unique,
    since CUDA index_put_ picks an undefined winner on repeats."""
    out = torch.full((size + 1,), fill, dtype=val.dtype, device=val.device)
    out[torch.where(keep, idx, size)] = val
    return out[:size]


def _scatter_level(level: torch.Tensor, idx: torch.Tensor,
                   keep: torch.Tensor, val: torch.Tensor) -> None:
    """level[:, idx[i]] = val[:, i] where keep[i], in place and without a
    host sync: a dropped lane writes the first kept lane's value to that
    lane's target again, so a repeated target always carries one value.
    The kept targets are unique and never none: each node a step touches
    has exactly one last update (``imt_tpu`` :114)."""
    first = torch.argmax(keep.to(torch.uint8)).view(1)
    level[:, torch.where(keep, idx, idx[first])] = torch.where(
        keep, val, val.index_select(1, first))


def _merge_order(node: torch.Tensor, key2: torch.Tensor, kb: int):
    """The walk's per-level merge (``imt_tpu`` :141-155): rows sorted by
    (node, key2, row), with key2 < 2^kb, as one stable sort of the int64
    key (node << kb) | key2 (node < 2^32 and kb <= 20 fit, where
    ``lax.sort`` needs two int32 keys).  Returns (sorted nodes, row ids)."""
    srt, pid = torch.sort((node << kb) | key2, stable=True)
    return srt >> kb, pid


def _witness_walk(levels: list, l_path: torch.Tensor, n_path: torch.Tensor,
                  s0: int, upd_val: torch.Tensor):
    """The level-synchronous walk (``imt_tpu`` ``_witness_walk``, :86), in
    place on `levels`.  Insert i updates the node of its new slot (n_path,
    the contiguous slab s0 .. s0+K-1) and of its low leaf (l_path) on each
    level; upd_val [8, 2K] holds the new slab nodes, then the new low-path
    nodes, of the level being walked.

    A query "sibling of X before step i" takes the latest update at or
    before step i-1: slab hits by interval arithmetic (the slab steps under
    node q are [(q << lvl) - s0, ((q + 1) << lvl) - 1 - s0]), low-path hits
    from one stable sort of the K low-path updates and the 2K queries by
    (node, step, kind), and the later of the two wins (ties carry equal
    values).  Same-step siblings (the parent hash's children, the new
    path's sibling after the low leaf's update, reference :734) are a
    select between the two paths.

    Returns (low_proof, new_proof [depth, 8, K], low_help, new_help
    int32[depth, K], old_root, new_root [8, K]): the proofs as nodes, the
    roots of the active prefix before and after each step."""
    depth, k = len(levels) - 1, n_path.shape[0]
    n = levels[0].shape[1]
    dev = upd_val.device
    steps = torch.arange(k, device=dev)
    mm, tot = 2 * k, 3 * k                     # 2K queries; K updates first
    kind = torch.cat([torch.zeros(k, dtype=torch.int64, device=dev),
                      torch.ones(mm, dtype=torch.int64, device=dev)])
    qstep = torch.cat([steps - 1, steps - 1])
    # key2 = 2 (step + 1) + kind: an update sorts before the queries of
    # the step after it
    kb = (2 * (k + 1) + 1).bit_length()
    key2 = 2 * (torch.cat([steps, qstep]) + 1) + kind
    pos = torch.arange(tot, device=dev)
    low_proof, new_proof, low_help, new_help = [], [], [], []
    for lvl in range(depth):
        level, width = levels[lvl], n >> lvl
        vN, vL = upd_val[:, :k], upd_val[:, k:]
        qnode = torch.cat([l_path ^ 1, n_path ^ 1])

        # slab hits: the latest slab step <= the query's step at its node
        lo_q = (qnode << lvl) - s0
        hi_q = (lo_q + (1 << lvl) - 1).clamp(max=k - 1)
        jstar = torch.minimum(hi_q, qstep)
        n_hit = (jstar >= lo_q.clamp(min=0)) & (lo_q <= k - 1)
        n_val = vN[:, jstar.clamp(0, k - 1)]

        # low-path hits: K updates and 2K queries, one stable sort
        ns, pid = _merge_order(torch.cat([l_path, qnode]), key2, kb)
        ks = kind[pid]
        last_upd = torch.where(ks == 0, pos, -1).cummax(0).values
        p_c = last_upd.clamp(0, tot - 1)
        hit = (last_upd >= 0) & (ns[p_c] == ns)
        # a hit's row is a low-path update, whose id is its step; a miss
        # may point at a query row, clamped (its value is never used)
        ans = pid[p_c].clamp(max=k - 1)
        is_q = ks == 1
        res_idx = _set_kept(mm, 0, pid - k, is_q, ans)
        res_hit = _set_kept(mm, False, pid - k, is_q, hit)

        # the later hit wins (ties carry equal values), else the level as
        # it was before the batch: read before this level is written below
        base = level[:, qnode]
        use_l = res_hit & (~n_hit | (res_idx >= jstar))
        res = torch.where(use_l, vL[:, res_idx],
                          torch.where(n_hit, n_val, base))
        lsib_prev, nsib_prev = res[:, :k], res[:, k:]

        # this level after the batch: each node's last update wins
        nxt_upd = indexed._next_true(ks == 0)
        is_lastl_s = (ks == 0) & ((nxt_upd == tot)
                                  | (ns[nxt_upd.clamp(0, tot - 1)] != ns))
        is_lastl = _set_kept(k, False, pid, ks == 0, is_lastl_s)
        l_lo = (l_path << lvl) - s0
        l_hi = (l_lo + (1 << lvl) - 1).clamp(max=k - 1)
        l_in_slab = (l_lo.clamp(min=0) <= l_hi) & (l_lo <= k - 1)
        l_wins = is_lastl & (~l_in_slab | (steps >= l_hi))
        is_lastn = steps == (((n_path + 1) << lvl) - 1 - s0).clamp(max=k - 1)
        claimed = _set_kept(width, -1, l_path, l_wins, steps)
        n_wins = is_lastn & (claimed[n_path.clamp(0, width - 1)] < steps)
        _scatter_level(level, torch.cat([n_path, l_path]),
                       torch.cat([n_wins, l_wins]), upd_val)

        # same-step siblings: the other path's update where it is the sibling
        lsib_t = torch.where(n_path == (l_path ^ 1), vN, lsib_prev)
        nsib_t = torch.where(l_path == (n_path ^ 1), vL, nsib_prev)
        low_proof.append(lsib_prev)                # low path vs the old tree
        new_proof.append(nsib_t)                   # new path vs the updated
        l_even, n_even = (l_path & 1) == 0, (n_path & 1) == 0
        low_help.append(l_even.to(torch.int32))
        new_help.append(n_even.to(torch.int32))
        upd_val = hashing.hash2_nodes(
            torch.cat([torch.where(n_even, vN, nsib_t),
                       torch.where(l_even, vL, lsib_t)], dim=1),
            torch.cat([torch.where(n_even, nsib_t, vN),
                       torch.where(l_even, lsib_t, vL)], dim=1))
        n_path, l_path = n_path >> 1, l_path >> 1

    # the root series: step i's new root is its low-path update (the later
    # of the two rows), its old root the previous step's new root
    new_root = upd_val[:, k:]
    old_root = torch.cat([levels[depth], new_root[:, :k - 1]], dim=1)
    levels[depth].copy_(new_root[:, k - 1:])
    return (torch.stack(low_proof), torch.stack(new_proof),
            torch.stack(low_help), torch.stack(new_help), old_root,
            new_root.contiguous())


def insert_batch_witness(vals, nvs, nis, levels: list, new_vals,
                         count: int) -> dict:
    """K inserts of new_vals [16, K] into the slots count+1 .. count+K,
    in place on the state (vals / nvs / nis [16, n]) and the active-prefix
    `levels` (``imt_tpu`` ``_insert_batch_witness_fn``, :240).  Returns the
    InsertWitness fields as tensors, ``ok`` bool[K] included, with the
    roots and proofs as nodes of the active prefix (the tree folds,
    extends and decodes them, ``indexed._finish_witness``)."""
    n, k = vals.shape[1], new_vals.shape[1]
    m = n + k
    dev = vals.device
    s0 = count + 1
    slots = s0 + torch.arange(k, device=dev)

    # ---- the final list: the planner of the plain batched insert ----------
    sort = indexed._sort_batch(vals, new_vals, s0, n, k)
    order, entry_slot, accepted, pos_new = sort

    # ---- temporal planning (imt_tpu :308-362) -------------------------------
    # nearest existing participant (slot 0 or an occupied slot, in the
    # state before the batch) below / above each sorted position
    part_s = torch.cat([indexed._participants(vals),
                        torch.zeros(k, dtype=torch.bool, device=dev)])[order]
    prv_e, nxt_e = indexed._prev_true(part_s, -1), indexed._next_true(part_s)

    # intra-batch chains: ANSV over the new entries in value order; sigma
    # is an accepted entry's step (its batch index), else never
    spn, ids = torch.sort(pos_new)                     # rank -> entry
    sigma = torch.where(accepted[spn], ids, _NEVER)
    lo_r, lo_f = _ansv_prev(sigma, ids)
    hi_r, hi_f = _ansv_prev(sigma.flip(0), ids.flip(0))
    lo_pos = torch.where(lo_f, spn[lo_r], -1)
    hi_pos = torch.where(hi_f.flip(0), spn[(k - 1 - hi_r.flip(0))], m)
    rank = torch.empty_like(ids)
    rank[ids] = torch.arange(k, device=dev)
    low_pos = torch.maximum(prv_e[pos_new], lo_pos[rank]).clamp(0, m - 1)
    succ_pos = torch.minimum(nxt_e[pos_new], hi_pos[rank])
    has_succ = succ_pos < m
    low_entry = order[low_pos]
    succ_entry = order[succ_pos.clamp(0, m - 1)]
    low_slot = entry_slot[low_entry]
    low_val = indexed._entry_vals(vals, new_vals, low_entry, n)
    succ_val = torch.where(
        has_succ, indexed._entry_vals(vals, new_vals, succ_entry, n), 0)
    succ_idx = indexed.index_to_limbs(
        torch.where(has_succ, entry_slot[succ_entry], 0))

    # ---- the final state, in place (read above before it is written) ------
    _, ok = indexed._link_batch(vals, nvs, nis, new_vals, sort, s0, n, k)

    # ---- the leaf updates: 2 per step; a rejected step rewrites its own
    # empty slot (an identity update) on both rows --------------------------
    z = lambda x: torch.where(ok, x, 0)
    upd_val = hashing.hash3_leaf(
        torch.cat([z(new_vals), z(low_val)], dim=1),
        torch.cat([z(succ_val), z(new_vals)], dim=1),
        torch.cat([z(succ_idx), z(indexed.index_to_limbs(slots))], dim=1))
    (low_proof, new_proof, low_help, new_help, old_root,
     new_root) = _witness_walk(levels, torch.where(ok, low_slot, slots),
                               slots, s0, upd_val)
    return dict(
        ok=ok, old_root=old_root, low_leaf_val=low_val,
        low_leaf_next_val=succ_val, low_leaf_next_idx=succ_idx,
        low_leaf_proof=low_proof, low_leaf_proof_helper=low_help,
        new_root=new_root, new_leaf_val=new_vals,
        new_leaf_next_val=succ_val, new_leaf_next_idx=succ_idx,
        new_leaf_index=slots.to(torch.int32), new_leaf_proof=new_proof,
        new_leaf_proof_helper=new_help,
        is_new_leaf_largest=field.is_zero(succ_val))
