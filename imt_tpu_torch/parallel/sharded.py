"""Multi-GPU sharding of the indexed Merkle tree, SPMD over torch.distributed.

Counterpart of ``imt_tpu.parallel.sharded``.  Every rank runs the same
program; the JAX package's ``jax.shard_map`` body becomes what each rank
runs, and its collectives are calls on the rank's process group
(``collectives.py``).

* ``make_mesh`` / ``make_mesh2`` give a ``torch.distributed.device_mesh.
  DeviceMesh`` with the dims ("shard",) or ("host", "chip"), PyTorch's
  counterpart of ``jax.sharding.Mesh``.  Rank r of the "shard" dim owns the
  contiguous columns [r C, (r + 1) C), which is ``P(None, "shard")``.
* Hash batches are data-parallel: each rank hashes its columns.
* A tree build reduces each rank's subtree level by level, then ONE
  all-gather of the D subtree roots and a replicated top.
* ``ShardedIndexedMerkleTree``: the leaf state and every level wide enough
  to split live sharded; the batched entry points run the shard-local
  planner (``local_plan.py``), whose collectives are O(K) whatever the tree
  size.  The JAX package's GSPMD comparator (``local_plan=False``) has no
  torch counterpart.

Process groups are the caller's: ``torch.distributed.init_process_group``
must have run on every rank (gloo for CPU tensors, or for tensors on the
card moved through the host; NCCL for tensors on the card).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops import field, hashing
from ..tree import indexed
from ..tree.indexed import (IndexedMerkleTree, InsertWitness,
                            NonInclusionWitness, _as_batch_stack,
                            _as_limb_batch)
from ..tree.merkle import _dec_path, verify_proofs
from ..tree.sparse import SparseIndexedMerkleTree
from ..utils.observability import count, log_event
from . import collectives, local_plan
from .local_plan import Shard, shardable

NO_GSPMD = ("local_plan=False selects imt_tpu's GSPMD-partitioned step, "
            "which has no torch.distributed counterpart: the port runs the "
            "shard-local planner only")


def _group_timeout():
    """The default process group's timeout, which every group made here
    takes (a new group's own default is 30 minutes)."""
    pg = dist.distributed_c10d._get_default_group()
    for dev in ("cpu", "cuda"):
        try:
            return pg._get_backend(torch.device(dev)).options._timeout
        except (RuntimeError, AttributeError):
            continue
    return None


def _blocks(need: int):
    """Split the world into blocks of `need` consecutive ranks: (the
    blocks, the index of the block that holds this rank)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed."
                           "init_process_group on every rank first")
    world = dist.get_world_size()
    need = need or world
    if need < 1 or world % need:
        raise ValueError(f"need {need} devices, have {world}: the mesh "
                         f"size must divide the world size")
    blocks = [list(range(b, b + need)) for b in range(0, world, need)]
    return blocks, dist.get_rank() // need


def make_mesh(n_devices: int | None = None, axis: str = "shard",
              device_type: str | None = None) -> DeviceMesh:
    """A 1-D mesh of `n_devices` ranks (None: the whole world) with the dim
    `axis` (``imt_tpu`` :33).  The world splits into blocks of n_devices
    consecutive ranks, each its own mesh: the first n_devices ranks form
    the first one.  device_type: "cuda" when a card is present, else
    "cpu"."""
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    blocks, mine = _blocks(n_devices)
    if len(blocks) == 1:
        group = dist.group.WORLD
    else:
        timeout = _group_timeout()
        groups = [dist.new_group(b, timeout=timeout) for b in blocks]
        group = groups[mine]
    return DeviceMesh.from_group(group, device_type, mesh=blocks[mine],
                                 mesh_dim_names=(axis,))


def make_mesh2(n_hosts: int, n_chips: int,
               axes: tuple[str, str] = ("host", "chip"),
               device_type: str | None = None) -> DeviceMesh:
    """A 2-D (host, chip) mesh of n_hosts x n_chips ranks (``imt_tpu``
    :39): rank h * n_chips + c of a block sits at (h, c), so the chip dim
    joins the ranks of one host and the host dim one rank of each host."""
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    need = n_hosts * n_chips
    blocks, mine = _blocks(need)
    timeout = _group_timeout()
    rank = dist.get_rank()
    host_group = chip_group = None
    for b in blocks:
        grid = np.asarray(b).reshape(n_hosts, n_chips)
        for row in grid:                      # the chip dim: one host
            g = dist.new_group(row.tolist(), timeout=timeout)
            if rank in row:
                chip_group = g
        for col in grid.T:                    # the host dim
            g = dist.new_group(col.tolist(), timeout=timeout)
            if rank in col:
                host_group = g
    return DeviceMesh.from_group(
        [host_group, chip_group], device_type,
        mesh=np.asarray(blocks[mine]).reshape(n_hosts, n_chips).tolist(),
        mesh_dim_names=axes)


def default_device() -> torch.device:
    """cuda:<local rank>: $LOCAL_RANK if a launcher set it, else the rank
    modulo the cards present."""
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        n = torch.cuda.device_count()
        local = dist.get_rank() % n if n else dist.get_rank()
    return torch.device("cuda", int(local))


def _rank_device(device) -> torch.device:
    """`device`, where "cuda" without an index (or None) means the rank's
    own card."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    return default_device() if dev.type == "cuda" and dev.index is None \
        else dev


def _as_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int64)
                           .astype(np.int32), device=device)


def shard_batch(arr, mesh: DeviceMesh, axis: str | None = None,
                device=None):
    """This rank's columns of a [rows, B] array (numpy or a tensor, the
    same on every rank), as int32 on `device` (``imt_tpu`` :52,
    ``P(None, axis)``, by default the mesh's first dim); B must divide
    over the mesh."""
    dim = mesh.mesh_dim_names.index(axis) if axis else 0
    d, r = mesh.size(dim), mesh.get_local_rank(dim)
    b = arr.shape[1]
    if b % d:
        raise ValueError(f"{b} columns do not divide over {d} devices")
    per = b // d
    return _as_tensor(arr[:, r * per:(r + 1) * per],
                      _rank_device(device)).contiguous()


def sharded_hash2(a, b, mesh: DeviceMesh, device=None) -> torch.Tensor:
    """Data-parallel batched 2-to-1 hash (``imt_tpu`` :174): each rank
    hashes its columns of a, b [16, B] (canonical limbs, the same on every
    rank) and returns them, the shard it holds of the result."""
    return hashing.hash2(shard_batch(a, mesh, device=device),
                         shard_batch(b, mesh, device=device))


def sharded_hash3(a, b, c, mesh: DeviceMesh, device=None) -> torch.Tensor:
    """Data-parallel batched 3-to-1 hash of a, b, c [16, B] (``imt_tpu``
    :181); returns this rank's columns of the result."""
    return hashing.hash3(*(shard_batch(x, mesh, device=device)
                           for x in (a, b, c)))


def _subtree(leaves: torch.Tensor, what: str) -> list:
    """A rank's subtree over its leaf nodes [8, w], all levels."""
    w = leaves.shape[1]
    if w & (w - 1):
        raise ValueError(f"leaves per {what} must be a power of two")
    return indexed._build_levels(leaves, w.bit_length() - 1)


def _top(roots: torch.Tensor) -> torch.Tensor:
    """The replicated levels over `roots` [8, D], as columns [8, 2D - 1]:
    the roots first, the root last."""
    return torch.cat(_subtree(roots, "mesh"), dim=1)


def _nodes(local: torch.Tensor):
    """Leaves as nodes, and whether they came as canonical limbs."""
    if local.shape[0] == field.LIMBS:
        return hashing.enc_nodes(local), True
    return local, False


def sharded_tree_root(leaves, mesh: DeviceMesh, device=None):
    """Root of the Poseidon Merkle tree over leaves [16, N] (canonical
    limbs) or [8, N] (nodes), the same array on every rank (``imt_tpu``
    :87): each rank reduces its N/D columns, then ONE all-gather of the D
    subtree roots and the replicated top.  Returns (this rank's subtree
    root [rows, 1], the top [rows, 2D - 1]: the D subtree roots first,
    the root last), in the leaves' form; the root is the single-device
    MerkleTree's bit for bit."""
    if leaves.shape[1] % mesh.size():
        raise ValueError("leaves per shard must be a power of two")
    nodes, limbs = _nodes(shard_batch(leaves, mesh, device=device))
    own = _subtree(nodes, "shard")[-1]
    with collectives.program("build"):
        top = _top(collectives.all_gather(own, mesh.get_group(), dim=1))
    if limbs:
        return hashing.dec_nodes(own), hashing.dec_nodes(top)
    return own, top


def sharded_root(leaves, mesh: DeviceMesh, device=None) -> torch.Tensor:
    return sharded_tree_root(leaves, mesh, device)[1][:, -1:]


def sharded_tree_root2(leaves, mesh: DeviceMesh, device=None):
    """Root over a (host, chip) mesh (``imt_tpu`` :147), bit-exact with the
    flat build (leaf order host-major): each rank reduces its subtree, ONE
    all-gather over "chip" and the reduction to its host's root, ONE
    all-gather over "host" of the H host roots and the replicated top.
    Returns (this rank's subtree root [rows, 1], the host-level top
    [rows, 2H - 1])."""
    h, c = mesh.size(0), mesh.size(1)
    if h & (h - 1) or c & (c - 1):
        raise ValueError("mesh axes must be powers of two")
    n = leaves.shape[1]
    if n % (h * c):
        raise ValueError("leaves per device must be a power of two")
    per = n // (h * c)
    pos = mesh.get_local_rank(0) * c + mesh.get_local_rank(1)
    nodes, limbs = _nodes(_as_tensor(leaves[:, pos * per:(pos + 1) * per],
                                     _rank_device(device)).contiguous())
    own = _subtree(nodes, "device")[-1]
    with collectives.program("build"):
        host = _top(collectives.all_gather(own, mesh.get_group(1), dim=1))
        top = _top(collectives.all_gather(host[:, -1:], mesh.get_group(0),
                                          dim=1))
    if limbs:
        return hashing.dec_nodes(own), hashing.dec_nodes(top)
    return own, top


def sharded_root2(leaves, mesh: DeviceMesh, device=None) -> torch.Tensor:
    return sharded_tree_root2(leaves, mesh, device)[1][:, -1:]


class ShardedIndexedMerkleTree:
    """Indexed Merkle tree with its state sharded over a 1-D mesh
    (``imt_tpu`` :189-492), SPMD: every rank of the mesh constructs it and
    makes the same calls, and gets the same answers.

    While the active prefix of 2^ad slots is shardable (``local_plan.
    shardable``: D > 1, D divides it and each rank holds two slots or
    more), each rank holds a ``local_plan.Shard`` and the batched entry
    points run the shard-local planner; ``insert`` and ``insert_seq`` run
    its witness batch (K = 1, K = len).  Otherwise every rank holds the
    whole tree, a plain single-device ``IndexedMerkleTree`` or
    ``SparseIndexedMerkleTree``, and runs the plain step: the results are
    deterministic, so the ranks agree (the JAX package's replicated
    placement of narrow arrays).  D = 1 always takes the plain step.

    ``sparse=True`` (default for depth > 20) holds an active prefix that
    doubles as inserts need; when it doubles, each rank receives its new
    columns from the ranks that held them and rebuilds its subtree (the
    exchange counted under the program "growth", apart from the per-batch
    collectives).  The tree lives on `device`: the rank's own card
    ("cuda:<local rank>") unless the caller names one, "cpu" included.
    Getters and proofs read the owner rank's slots (one psum) and the
    replicated top."""

    def __init__(self, depth: int, mesh: DeviceMesh | None = None,
                 sparse: bool | None = None,
                 initial_capacity_log2: int = 10, local_plan: bool = True,
                 device=None):
        self._setup(depth, mesh, sparse, local_plan, device)
        if self.sparse:
            ad = min(max(initial_capacity_log2, 1), depth)
        else:
            ad = depth
        if shardable(ad, self._d):
            self._shard = self._empty_shard(ad)
        elif self.sparse:
            self._inner = SparseIndexedMerkleTree(depth, ad,
                                                  device=self.device)
        else:
            self._inner = IndexedMerkleTree(depth, device=self.device)

    def _setup(self, depth, mesh, sparse, local_plan_, device) -> None:
        if not local_plan_:
            raise NotImplementedError(NO_GSPMD)
        self.local_plan = True
        self._mesh = mesh or make_mesh()
        if not isinstance(self._mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh, got "
                            f"{type(self._mesh).__name__}")
        if self._mesh.ndim != 1:
            raise ValueError("ShardedIndexedMerkleTree takes a 1-D mesh")
        self._group = self._mesh.get_group()
        self._d = self._mesh.size()
        self._r = self._mesh.get_local_rank()
        self.device = _rank_device(device)
        self.sparse = depth > 20 if sparse is None else bool(sparse)
        self.tree_depth = depth
        self.num_slots = 1 << depth
        self._shard: Shard | None = None
        self._inner = None

    def _empty_shard(self, ad: int) -> Shard:
        """All-empty state of 2^ad slots, this rank's part."""
        c = (1 << ad) // self._d
        z = lambda: torch.zeros((field.LIMBS, c), dtype=torch.int32,
                                device=self.device)
        shard = Shard(z(), z(), z(), [], 0, ad, self.tree_depth, self._r,
                      self._d)
        for lvl, h in enumerate(indexed._zero_level_roots(ad)):
            width = (c if lvl < shard.l_loc else 1 << ad) >> lvl
            col = torch.as_tensor(field.int_to_node(h),
                                  device=self.device)[:, None]
            shard.levels.append(col.expand(field.WORDS, width).contiguous())
        return shard

    # -- the state ---------------------------------------------------------

    @property
    def mesh(self) -> DeviceMesh:
        return self._mesh

    @property
    def count(self) -> int:
        return (self._shard or self._inner).count

    @property
    def active_depth(self) -> int:
        return (self._shard or self._inner).active_depth

    @property
    def is_sharded(self) -> bool:
        """Whether the state is sharded (the shard-local planner runs)."""
        return self._shard is not None

    def _install(self, state: list, ad: int, count: int) -> None:
        """The tree holding `state` (vals, next_vals, next_idxs over 2^ad
        slots, numpy or tensors, whole on every rank) and `count`: when
        shardable, each rank takes its columns (``_install_local``);
        otherwise every rank rebuilds the whole tree."""
        arrays = dict(depth=self.tree_depth, count=count,
                      vals=state[0], next_vals=state[1], next_idxs=state[2])
        if not shardable(ad, self._d):
            host = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                        else v) for k, v in arrays.items()}
            cls = SparseIndexedMerkleTree if self.sparse \
                else IndexedMerkleTree
            self._inner = cls.from_arrays(host, device=self.device)
            self._shard = None
            return
        c = (1 << ad) // self._d
        cols = slice(self._r * c, (self._r + 1) * c)
        self._install_local([_as_tensor(x[:, cols], self.device).contiguous()
                             for x in state], ad, count)

    def _install_local(self, local: list, ad: int, count: int) -> None:
        """This rank's columns `local` (vals, next_vals, next_idxs [16, C]
        of 2^ad slots): it hashes and reduces its subtree, and one
        all-gather of the roots feeds the top."""
        shard = Shard(*local, [], count, ad, self.tree_depth, self._r,
                      self._d)
        shard.levels = _subtree(hashing.hash3_leaf(*local), "shard")
        own = shard.levels.pop()
        with collectives.program("build"):
            roots = collectives.all_gather(own, self._group, dim=1)
        shard.levels.append(roots)
        indexed.rebuild_levels(shard.levels, shard.l_loc, ad)
        self._shard, self._inner = shard, None

    def _regroup(self, m: int) -> list:
        """This rank's columns once the sharded prefix has doubled m times:
        old rank q's slice moves to rank q >> m, at column (q mod 2^m) C
        there, and a rank that no old slice reaches starts empty.  Each
        rank receives at most its new slice, 2^m old ones: O(N/D), never
        the whole state."""
        s, d, r = self._shard, self._d, self._r
        c, span = s.c, 1 << m
        mine = torch.cat([s.vals, s.next_vals, s.next_idxs])
        rows = mine.shape[0]
        srcs = [q for q in range(r * span, min((r + 1) * span, d)) if q != r]
        got = collectives.send_recv(
            [(mine, r >> m)] if r >> m != r else [],
            [((rows, c), q, self.device) for q in srcs], self._group,
            what="slices")
        out = torch.zeros((rows, c * span), dtype=torch.int32,
                          device=self.device)
        if r >> m == r:                     # rank 0 keeps its own slice
            out[:, :c] = mine
        for q, x in zip(srcs, got):
            j = q - r * span
            out[:, j * c:(j + 1) * c] = x
        return list(out.split(field.LIMBS))

    def _grow_to(self, need: int) -> None:
        """Double the active prefix until it holds `need` slots (``imt_tpu``
        sparse :56).  Once it is sharded, each rank's new columns come from
        the ranks that held them (``_regroup``, program "growth"); a
        replicated tree that becomes shardable gives each rank its columns
        of the state it holds whole.  The metrics count the single-device
        rebuild."""
        ad = self.active_depth
        new = ad
        while (1 << new) < need:
            new += 1
        if new == ad:
            return
        if not shardable(new, self._d):
            self._inner._grow_to(need)
            return
        if self._shard is None:
            c = (1 << new) // self._d
            a = self._r * c
            b = min(a + c, 1 << ad)
            local = []
            for x in (self._inner.vals, self._inner.next_vals,
                      self._inner.next_idxs):
                col = x.new_zeros((field.LIMBS, c))
                col[:, :max(b - a, 0)] = x[:, a:b]
                local.append(col)
        else:
            with collectives.program("growth"):
                local = self._regroup(new - ad)
        self._install_local(local, new, self.count)
        log_event("sparse_grow", active_depth=new, slots=1 << new,
                  sharded=self.is_sharded)

    def _reserve(self, c: int) -> None:
        """Room for c more inserts, growing a sparse tree, or raise."""
        if self.count + c >= self.num_slots:
            raise ValueError("tree full")
        if self.sparse:
            self._grow_to(self.count + c + 1)

    # -- queries -------------------------------------------------------------

    def get_root(self) -> torch.Tensor:
        """Root as canonical limbs int32[16, 1]."""
        if self._shard is None:
            return self._inner.get_root()
        s = self._shard
        return hashing.dec_nodes(indexed._spine_fold(
            s.levels[-1], s.active_depth, self.tree_depth))

    def get_root_int(self) -> int:
        return field.limbs_to_int(self.get_root()[:, 0].cpu())

    def _owner_cols(self, index: int, xs: list) -> list:
        """The columns `index` (a slot, or a node of a sharded level) of
        the tensors `xs`, read on the rank that owns it and summed over the
        ranks (the others add zeros): one psum."""
        s = self._shard
        mine = s.off <= index < s.off + s.c
        col = lambda x: x[:, index - s.off:index - s.off + 1] if mine \
            else torch.zeros_like(x[:, :1])
        with collectives.program("read"):
            out = collectives.psum(torch.cat([col(x) for x in xs]),
                                   self._group)
        return list(out.split([x.shape[0] for x in xs]))

    def get_leaf_ints(self, index: int):
        if self._shard is None:
            return self._inner.get_leaf_ints(index)
        s = self._shard
        return tuple(field.limbs_to_int(x[:, 0].cpu()) for x in
                     self._owner_cols(index, [s.vals, s.next_vals,
                                              s.next_idxs]))

    def get_proof(self, index: int):
        """Sibling path as canonical limbs int32[depth, 16, 1] and helper
        bits int32[depth, 1], over the full depth.  A slot beyond the
        active prefix takes its siblings from the zero spine and the
        replicated prefix root, with no collective."""
        if self._shard is None:
            return self._inner.get_proof(index)
        s = self._shard
        if not 0 <= index < self.num_slots:
            raise IndexError(f"slot {index} is outside the tree's "
                             f"{self.num_slots} slots")
        if index >> s.active_depth:
            proof, helpers = indexed._beyond_prefix_proof(
                s.levels[-1], index, s.active_depth, self.tree_depth)
            return _dec_path(proof), helpers
        sibs, helpers = [], []
        mine = s.off <= index < s.off + s.c
        with collectives.program("read"):
            local = [s.levels[lvl][:, ((index - s.off) >> lvl) ^ 1][:, None]
                     if mine else torch.zeros((field.WORDS, 1),
                                              dtype=torch.int32,
                                              device=self.device)
                     for lvl in range(s.l_loc)]
            if local:
                sibs = list(collectives.psum(torch.stack(local),
                                             self._group))
        for lvl in range(s.active_depth):
            if lvl >= s.l_loc:
                sibs.append(s.levels[lvl][:, [(index >> lvl) ^ 1]])
            helpers.append(((index >> lvl) & 1) == 0)
        helpers = torch.tensor(helpers, dtype=torch.int32,
                               device=self.device)[:, None]
        proof, helpers = indexed._extend_proof(
            torch.stack(sibs), helpers, s.active_depth, self.tree_depth)
        return _dec_path(proof), helpers

    def verify_proof(self, leaf, index: int, root, proof) -> bool:
        """Verify by index parity, statelessly, on the tree's device."""
        return bool(verify_proofs(leaf, [index], root, proof, self.device)[0])

    def non_inclusion_witness(self, values, as_numpy: bool = True):
        """Batched non-membership witnesses (``imt_tpu`` :395): the
        shard-local program when sharded, else the plain one."""
        if self._shard is None:
            return self._inner.non_inclusion_witness(values,
                                                     as_numpy=as_numpy)
        queries, k = _as_limb_batch(values, self.device)
        count("queries", k)
        w = NonInclusionWitness(**local_plan.local_non_inclusion_witness(
            self._shard, queries, self._mesh, k))
        if not as_numpy:
            return w
        w.ok = w.ok.cpu().numpy()
        if indexed.debug_witness_enabled():
            indexed.check_non_inclusion_witness(w, queries)
        return w

    # -- mutation ------------------------------------------------------------

    def insert(self, value: int, as_numpy: bool = True) -> InsertWitness:
        """Single insert with its witness (``imt_tpu`` :258): the
        shard-local witness batch at K = 1 when sharded."""
        return self.insert_seq([value], as_numpy=as_numpy)

    def insert_seq(self, values, as_numpy: bool = True) -> InsertWitness:
        """Strictly sequential inserts with their witnesses (``imt_tpu``
        :345): when sharded, the shard-local witness batch, equal on its
        accepted lanes to sequential insertion by construction."""
        new_vals, k = _as_limb_batch(values, self.device)
        self._reserve(k)
        if self._shard is None:
            return self._inner.insert_seq(new_vals, as_numpy=as_numpy)
        return self.insert_batch(new_vals, witness=True, as_numpy=as_numpy)

    def insert_batch(self, values, witness: bool = False,
                     as_numpy: bool = True):
        """Batched insert (``imt_tpu`` :276): the shard-local planner when
        sharded (with witness=True its witness batch), else the plain
        step.  Returns ok bool[K], or the InsertWitness."""
        new_vals, k = _as_limb_batch(values, self.device)
        self._reserve(k)
        if self._shard is None:
            return self._inner.insert_batch(new_vals, witness=witness,
                                             as_numpy=as_numpy)
        s = self._shard
        ad = s.active_depth
        if witness:
            fields = local_plan.local_insert_batch_witness(
                s, new_vals, self._mesh, k)
            w = indexed._finish_witness(fields, ad, self.tree_depth)
            return IndexedMerkleTree._package_witness(w, as_numpy)
        ok = local_plan.local_insert_batch(s, new_vals, self._mesh, k)
        return IndexedMerkleTree._accepted(ok, as_numpy)

    def insert_batches(self, values, as_numpy: bool = True):
        """B chained batches, [B, 16, K] or B lists (``imt_tpu`` :308):
        when sharded, one shard-local chain (the root gather and the top
        rebuild once, after the last batch).  Returns ok bool[B, K]."""
        arr = _as_batch_stack(values, self.device)
        b, _, k = arr.shape
        self._reserve(b * k)
        if self._shard is None:
            return self._inner.insert_batches(arr, as_numpy=as_numpy)
        oks = local_plan.local_insert_batches(self._shard, arr, self._mesh,
                                              k, b)
        return IndexedMerkleTree._accepted(oks, as_numpy)

    # -- serialization -------------------------------------------------------

    def write_once(self, write) -> None:
        """Run `write()` on rank 0 of the mesh; every rank returns once it
        has run (one psum), and raises if it failed."""
        err = None
        if self._r == 0:
            try:
                write()
            except BaseException as e:        # re-raised below
                err = e
        with collectives.program("read"):
            failed = collectives.psum(torch.tensor(
                [err is not None], dtype=torch.int32, device=self.device),
                self._group)
        if err is not None:
            raise err
        if int(failed[0]):
            raise RuntimeError("rank 0 of the mesh failed to write")

    def to_arrays(self) -> dict:
        """The single-device tree's ``to_arrays`` dict, on every rank (one
        all-gather of each limb array when sharded)."""
        if self._shard is None:
            return self._inner.to_arrays()
        s = self._shard
        with collectives.program("gather_state"):
            state = [collectives.all_gather(x, self._group, dim=1)
                     for x in (s.vals, s.next_vals, s.next_idxs)]
        host = lambda x: x.cpu().numpy().astype(np.uint32)
        out = {"depth": np.int64(self.tree_depth),
               "count": np.int64(self.count),
               "vals": host(state[0]), "next_vals": host(state[1]),
               "next_idxs": host(state[2])}
        if self.sparse:
            out["sparse"] = np.int64(1)
        return out

    @classmethod
    def from_arrays(cls, arrays: dict, mesh: DeviceMesh | None = None,
                    local_plan: bool = True,
                    device=None) -> "ShardedIndexedMerkleTree":
        """Resume ``to_arrays`` output of either package (dense or sparse)
        onto a mesh (``imt_tpu`` :478): each rank takes its columns and
        rebuilds its own subtree, and one all-gather of the subtree roots
        feeds the top; no rank rebuilds the whole tree."""
        depth = int(arrays["depth"])
        sparse = bool(int(arrays.get("sparse", 0)))
        self = cls.__new__(cls)
        self._setup(depth, mesh, sparse, local_plan, device)
        n = int(np.asarray(arrays["vals"]).shape[1])
        ad = min(max(n.bit_length() - 1, 1), depth) if sparse else depth
        if n != 1 << ad:
            raise ValueError(f"vals of width {n} do not hold 2^{ad} slots")
        self._install([np.asarray(arrays[k]) for k in
                       ("vals", "next_vals", "next_idxs")], ad,
                      int(arrays["count"]))
        return self
