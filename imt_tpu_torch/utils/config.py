"""Typed configuration for the engine.

Counterpart of ``imt_tpu.utils.config``: the same fields, plus ``device``,
where the tree lives and its hashes run (the card unless the caller asks
for "cpu").  ``hash_engine`` and ``pallas_layout`` choose among
``imt_tpu``'s TPU engines and kernel layouts; the port has one engine per
device (the plain torch version on the CPU, the CUDA kernel on the card),
so both accept only "auto".  ``mesh_devices`` None (the whole world) or
N >= 2 (a mesh of N ranks, the first N for rank 0) builds the multi-GPU
``ShardedIndexedMerkleTree`` on a mesh with the dim ``mesh_axis``; every
rank of the world calls ``build_tree``.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield


@dataclass(frozen=True)
class PoseidonConfig:
    t: int = 3
    rate: int = 2
    r_f: int = 8
    r_p: int = 57


@dataclass(frozen=True)
class EngineConfig:
    poseidon: PoseidonConfig = dfield(default_factory=PoseidonConfig)
    tree_depth: int = 32
    # imt_tpu's engine and kernel-layout switches: "auto" only here
    hash_engine: str = "auto"
    pallas_layout: str = "auto"
    batch_size: int = 4096
    # sparse-prefix storage: None = auto (depth > 20)
    sparse: bool | None = None
    initial_capacity_log2: int = 10
    # mesh: 0 devices = single-device tree; None = all ranks
    mesh_axis: str = "shard"
    mesh_devices: int | None = 0
    # fail-fast witness re-verification (tree.indexed.set_debug_witness)
    debug_witness: bool = False
    device: str = "cuda"

    def apply(self) -> None:
        """Validate and install the global knobs this config carries.

        The Poseidon spec is pinned by reference bit-exactness
        (T=3/RATE=2/R_F=8/R_P=57, src/indexed_merkle_tree.rs:362-365): any
        other spec is rejected rather than silently mis-hashed; so is a TPU
        engine or layout."""
        if self.poseidon != PoseidonConfig():
            raise ValueError(
                f"unsupported Poseidon spec {self.poseidon}: the engine is "
                f"pinned to T=3/RATE=2/R_F=8/R_P=57 for reference parity")
        for knob in ("hash_engine", "pallas_layout"):
            value = getattr(self, knob)
            if value != "auto":
                raise ValueError(
                    f"{knob}={value!r} selects an imt_tpu TPU engine; "
                    f"imt_tpu_torch picks its engine by device: use 'auto'")
        from ..tree import indexed
        indexed.set_debug_witness(self.debug_witness)
        from .observability import log_event
        log_event("engine_config", depth=self.tree_depth,
                  engine=self.hash_engine, batch=self.batch_size,
                  mesh=self.mesh_devices, device=self.device)

    def build_tree(self):
        """apply() + construct the tree this config describes on `device`:
        dense, or sparse-prefix when `sparse` says so (by default when the
        depth exceeds 20); mesh-sharded when mesh_devices is None (all
        ranks) or >= 2, on the rank's own card for device "cuda"."""
        self.apply()
        if self.mesh_devices is None or self.mesh_devices >= 2:
            from ..parallel.sharded import ShardedIndexedMerkleTree, make_mesh
            return ShardedIndexedMerkleTree(
                self.tree_depth, mesh=make_mesh(self.mesh_devices,
                                                axis=self.mesh_axis),
                sparse=self.sparse,
                initial_capacity_log2=self.initial_capacity_log2,
                device=self.device)
        sparse = self.sparse if self.sparse is not None else \
            self.tree_depth > 20
        if sparse:
            from ..tree.sparse import SparseIndexedMerkleTree
            return SparseIndexedMerkleTree(
                self.tree_depth, self.initial_capacity_log2,
                device=self.device)
        from ..tree.indexed import IndexedMerkleTree
        return IndexedMerkleTree(self.tree_depth, device=self.device)
