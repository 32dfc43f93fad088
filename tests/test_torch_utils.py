"""imt_tpu_torch's checkpoint, EngineConfig and trace (utils/, CPU).

Mirrors tests/test_gates_utils.py's checkpoint, config, metrics and trace
cases and tests/test_sparse.py's checkpoint half on the port's trees:
round trips of a dense tree, a sparse tree and a sparse tree that grows
after its resume, each resumed tree going on inserting to the root of the
tree it was saved from; an atomic save that fails midway and leaves the previous
snapshot whole with no temporary file; a sharded snapshot and a mesh,
which need the multi-GPU tree (not ported), refused.  EngineConfig has
imt_tpu's fields plus ``device``, rejects any other Poseidon spec and
imt_tpu's TPU engines and layouts, builds the tree its depth calls for and
moves the metrics.  Snapshots across the two packages are in
test_torch_sparse.py.  Tolerance: exact.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

from imt_tpu.utils.config import EngineConfig as JaxEngineConfig
from imt_tpu_torch import IndexedMerkleTree, SparseIndexedMerkleTree
from imt_tpu_torch.tree import indexed
from imt_tpu_torch.utils import checkpoint, observability
from imt_tpu_torch.utils.config import EngineConfig, PoseidonConfig
from _torch_inference import inference_mode  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"


def _state(t) -> list:
    return [t.vals, t.next_vals, t.next_idxs] + t.levels


@pytest.mark.parametrize("make,first,then", [
    (lambda: IndexedMerkleTree(3, device=CPU), [11, 5, 19, 3, 7, 2], [100]),
    (lambda: SparseIndexedMerkleTree(5, initial_capacity_log2=3, device=CPU),
     [11, 5, 19], [3]),
    (lambda: SparseIndexedMerkleTree(6, initial_capacity_log2=2, device=CPU),
     [11, 5], [19, 3, 7]),
], ids=["dense", "sparse", "sparse_grows_after_resume"])
def test_checkpoint_round_trip(tmp_path, make, first, then):
    tree = make()
    tree.insert_batch(first)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(tree, path)
    assert os.listdir(tmp_path) == ["ckpt.npz"]
    restored = checkpoint.load(path, device=CPU)
    assert type(restored) is type(tree)
    assert restored.count == tree.count and restored._live == tree._live
    for x, y in zip(_state(tree), _state(restored)):
        assert torch.equal(x, y)
    # the resumed tree keeps working (the sparse one grows 2^2 -> 2^3)
    assert restored.insert_batch(then).tolist() == \
        tree.insert_batch(then).tolist()
    assert restored.active_depth == tree.active_depth
    assert restored.get_root_int() == tree.get_root_int()


def test_checkpoint_sparse_holds_the_prefix(tmp_path):
    """A depth-32 sparse snapshot holds the active prefix and its marker,
    in imt_tpu's format (uint32 limbs)."""
    tree = SparseIndexedMerkleTree(32, initial_capacity_log2=1, device=CPU)
    path = str(tmp_path / "deep.npz")
    checkpoint.save(tree, path)
    with np.load(path) as z:
        assert sorted(z.files) == ["count", "depth", "next_idxs",
                                   "next_vals", "sparse", "vals"]
        assert z["vals"].shape == (16, 2) and z["vals"].dtype == np.uint32
        assert int(z["depth"]) == 32 and int(z["sparse"]) == 1
    back = checkpoint.load(path, device=CPU)
    assert isinstance(back, SparseIndexedMerkleTree)
    assert back.active_depth == 1 and back.tree_depth == 32


class _FullDisk:
    def __reduce__(self):
        raise OSError("no space left on device")


class _Unsaveable:
    """A tree whose snapshot fails midway: the write of its second array
    raises after the npz has begun."""

    def to_arrays(self):
        return {"depth": np.int64(3), "vals": np.arange(4096),
                "next_vals": np.array([_FullDisk()], dtype=object)}


def test_checkpoint_save_is_atomic(tmp_path):
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(IndexedMerkleTree(2, device=CPU), path)
    with open(path, "rb") as f:
        before = f.read()
    with pytest.raises(OSError, match="no space left"):
        checkpoint.save(_Unsaveable(), path)
    assert os.listdir(tmp_path) == ["ckpt.npz"]
    with open(path, "rb") as f:
        assert f.read() == before


def test_checkpoint_refuses_a_sharded_snapshot(tmp_path):
    """A sharded snapshot, or a plain one with mesh=, restores onto a mesh
    (tests/test_torch_parallel.py): without a process group, or with a
    mesh that is not a DeviceMesh, load refuses."""
    path = str(tmp_path / "sharded.npz")
    np.savez(path, sharded=np.int64(1),
             **IndexedMerkleTree(2, device=CPU).to_arrays())
    with pytest.raises(RuntimeError, match="init_process_group"):
        checkpoint.load(path, device=CPU)
    plain = str(tmp_path / "plain.npz")
    checkpoint.save(IndexedMerkleTree(2, device=CPU), plain)
    with pytest.raises(TypeError, match="DeviceMesh"):
        checkpoint.load(plain, device=CPU, mesh=object())


def test_engine_config_fields_are_imt_tpus_plus_device():
    ours = [f.name for f in dataclasses.fields(EngineConfig)]
    theirs = [f.name for f in dataclasses.fields(JaxEngineConfig)]
    assert ours == theirs + ["device"]
    defaults = {f.name: getattr(JaxEngineConfig(), f.name)
                for f in dataclasses.fields(JaxEngineConfig)}
    assert {n: getattr(EngineConfig(), n) for n in theirs} == {
        n: (PoseidonConfig() if n == "poseidon" else v)
        for n, v in defaults.items()}
    assert EngineConfig().device == "cuda"


@pytest.mark.parametrize("bad,match", [
    (dict(poseidon=PoseidonConfig(r_p=56)), "Poseidon spec"),
    (dict(hash_engine="pallas"), "hash_engine='pallas'"),
    (dict(pallas_layout="split"), "pallas_layout='split'"),
])
def test_engine_config_rejects(bad, match):
    with pytest.raises(ValueError, match=match):
        EngineConfig(device=CPU, **bad).apply()


def test_engine_config_refuses_a_mesh():
    """mesh_devices None or >= 2 builds the sharded tree
    (tests/test_torch_parallel.py), which needs a process group: without
    one, build_tree refuses."""
    for n in (None, 2):
        with pytest.raises(RuntimeError, match="init_process_group"):
            EngineConfig(mesh_devices=n, device=CPU).build_tree()


def test_engine_config_debug_witness_round_trip():
    try:
        EngineConfig(debug_witness=True, device=CPU).apply()
        assert indexed.debug_witness_enabled()
        EngineConfig(device=CPU).apply()
        assert not indexed.debug_witness_enabled()
    finally:
        indexed.set_debug_witness(False)


def test_engine_config_builds_the_tree_and_moves_metrics():
    """Dense at depth 4, sparse at depth 24 (the depth > 20 rule), on the
    asked device; insert, insert_batch and a query move the counters."""
    ts = EngineConfig(tree_depth=24, initial_capacity_log2=3,
                      device=CPU).build_tree()
    assert isinstance(ts, SparseIndexedMerkleTree)
    assert ts.active_depth == 3 and ts.device.type == CPU
    t = EngineConfig(tree_depth=4, device=CPU).build_tree()
    assert type(t) is IndexedMerkleTree and t.device.type == CPU

    before = observability.snapshot()["totals"]
    t.insert(7)
    assert t.insert_batch([9, 9]).tolist() == [True, False]
    t.non_inclusion_witness([8])
    after = observability.snapshot()["totals"]
    moved = lambda n: after.get(n, 0) - before.get(n, 0)
    assert moved("inserts.accepted") == 2
    assert moved("inserts.rejected") == 1
    assert moved("queries") == 1
    assert moved("hash2.lanes") > 0 and moved("hash3.lanes") > 0


def test_trace_scope(tmp_path, monkeypatch, caplog):
    """Annotation only, then with a trace directory, where a Chrome trace
    naming the region is written; both log their wall time."""
    monkeypatch.delenv("IMT_TRACE_DIR", raising=False)
    caplog.set_level("INFO", logger="imt_tpu_torch")
    with observability.trace("unit"):
        x = torch.arange(4.0) * 2
    assert x.sum().item() == 12.0
    assert not os.listdir(tmp_path)
    with observability.trace("unit_profiled", trace_dir=str(tmp_path)):
        torch.arange(4.0).cumsum(0)
    files = glob.glob(str(tmp_path / "unit_profiled.*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "imt.unit_profiled" for e in events)
    lines = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("trace label=unit wall_s=") and
               m.endswith("profile_dir=-") for m in lines)
    assert any(m.startswith("trace label=unit_profiled") and
               m.endswith(f"profile_dir={tmp_path}") for m in lines)
