"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import ast
import glob
import json
import os
import re

import pytest

from imtbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
MAN = harness.manifest()
CELLS = {w["name"]: w for w in MAN["workloads"]}


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert LINE.match(word) and not word.startswith("/")
        assert ".." not in word
        if os.sep in word:
            assert any(word.startswith(p + "/") for p in MAN["paths"])
            assert os.path.exists(os.path.join(harness.ROOT, word))
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    cells = 24
    assert 2 + 14 * cells * (MAN["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_and_units():
    groups = [MAN["configs"], MAN["workloads"], MAN["end_to_end"],
              MAN["per_layer"]]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for c in MAN["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    assert [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]


def test_every_cell_reports_enough_and_moves_are_reported():
    for name in CELLS:
        e2e = {m["name"] for m in harness.metrics_for(MAN, name, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_for(MAN, name, True)
    for m in MAN["per_layer"]:
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            reported = {e["name"] for e in harness.metrics_for(MAN, cell,
                                                              False)}
            assert m["moves"] in reported, (m["name"], cell)
    for m in MAN["end_to_end"]:
        assert all(c in CELLS for c in m.get("workloads", []))


def test_files_found_by_name():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("imtbench/")
        conf = json.load(open(os.path.join(harness.ROOT, c["file"])))
        assert conf["name"] == c["name"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
        assert set(c["reduced"]) <= set(conf["assumed"])
    for name in CELLS:
        _, _, _, traffic = harness.resolve(MAN, name)
        assert LINE.match(traffic["source"]) and traffic["assumed"]
    for name in CELLS:
        _, _, _, traffic = harness.resolve(MAN, name)
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "drivers",
                                           traffic["driver"] + ".py"))
    for m in MAN["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)
    # one reader a quantity, each read by some metric
    readers = {os.path.basename(p)[:-3] for p in glob.glob(os.path.join(
        harness.BENCH_DIR, "metrics", "*.py"))}
    assert readers == {harness.quantity(m["name"]) for m in MAN["per_layer"]}
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    harness.BENCH_DIR, "**", "*.py"), recursive=True)))
def test_no_jax_and_a_reference_of_its_own(path):
    mods = set(_imports(path))
    assert not mods & {"jax", "jaxlib", "flax", "imt_tpu"}, path
    rel = os.path.relpath(path, harness.BENCH_DIR)
    program_side = rel.split(os.sep)[0] in ("drivers", "tests") \
        or rel in ("run.py", "control.py")
    if not program_side:
        assert "imt_tpu_torch" not in mods, path
