"""The benchmark's generic part: everything that is not one configuration,
one traffic mix or one metric.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration and a
traffic mix; both are JSON files found by name (``configs/<config>.json``,
``traffic/<traffic>.json``).  The traffic file names its driver
(``drivers/<driver>.py``, whose ``run(cell)`` does set-up, the window and
the check), and each per-layer metric is read by
``metrics/<quantity>.py``, whose ``read(view)`` returns a number or None;
a metric named ``<quantity>.<suffix>`` is the same quantity in the cells
it lists (end-to-end ones likewise, from the driver's numbers).  Kernels are put in classes by
the patterns of ``kernel_classes/*.json``.  So a new cell, mix or metric
is new files and new entries, never an edit.

Spans are the benchmark's own: ``Cell.span`` around each call into the
program, recorded as profiler ranges named ``imtbench.<span>``.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import importlib.util
import json
import os
import re
import shutil
import subprocess
import tempfile
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "imt_tpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TRACED = "imtbench.traced"


def process_age_s(fallback_t0: float) -> float:
    """Seconds since this process started (from /proc), or since
    `fallback_t0` (a perf_counter reading) where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - fallback_t0


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    name = "imtbench_" + re.sub(r"\W", "_", os.path.relpath(path, BENCH_DIR))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def resolve(man: dict, workload: str) -> tuple:
    """(cell entry, config entry, config dict, traffic dict) of a cell."""
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in man["configs"]}[cell["config"]]
    config = load_json(os.path.join(ROOT, conf["file"]))
    traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                     cell["traffic"] + ".json"))
    return cell, conf, config, traffic


def metrics_for(man: dict, workload: str, trace: bool) -> list:
    """The metric entries a run of `workload` reports: its end-to-end ones,
    or with a trace its per-layer ones."""
    e2e = [m for m in man["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def quantity(metric: str) -> str:
    """The quantity a metric reports: its name before the first dot."""
    return metric.split(".")[0]


def metric_reader(metric: str):
    """The module that reads a per-layer metric: metrics/<quantity>.py."""
    return load_module(os.path.join(BENCH_DIR, "metrics",
                                    quantity(metric) + ".py"))


def kernel_classes() -> list:
    """[(class, compiled pattern)] from kernel_classes/*.json, in file
    order; a kernel takes the first class whose pattern it matches."""
    out = []
    for path in sorted(glob.glob(os.path.join(BENCH_DIR, "kernel_classes",
                                              "*.json"))):
        entry = load_json(path)
        out += [(entry["class"], re.compile(p)) for p in entry["patterns"]]
    return out


def classify(name: str, classes: list) -> str:
    for cls, pat in classes:
        if pat.search(name):
            return cls
    return "other"


def nvidia_smi(field: str) -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0].strip() if out.strip() else None


class TraceView:
    """What the per-layer readers read: the traced sub-window's length,
    the device's busy time in it, device seconds by kernel class, the
    units (blocks) it covered, the counts from drivers/<name>.py, and the
    card."""

    def __init__(self, window_s, busy_s, class_s, units, counts, card):
        self.window_s, self.busy_s, self.class_s = window_s, busy_s, class_s
        self.units, self.counts, self.card = units, counts, card

    def seconds(self, *classes) -> float:
        return sum(self.class_s.get(c, 0.0) for c in classes)

    def ms_per_unit(self, *classes):
        """Device milliseconds of `classes` per traced unit, or None."""
        s = self.seconds(*classes)
        return 1e3 * s / self.units if self.units and s > 0 else None


def _union(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce_trace(events: list, classes: list) -> dict:
    """Chrome-trace events -> the sub-window ("imtbench.traced" range):
    its length, the union of device operations in it, device seconds by
    class and by name, and the idle gaps summed by the innermost
    benchmark span the host was in when each began."""
    win = [e for e in events if e.get("name") == TRACED
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no imtbench.traced range")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev, by_class, by_name = [], {}, {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        dev.append((a, b))
        cls = classify(e["name"], classes) if e["cat"] == "kernel" \
            else "copy"
        by_class[cls] = by_class.get(cls, 0.0) + (b - a) * 1e-6
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _union(dev)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("imtbench.")
                   and e["name"] != TRACED)
    gaps, t = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            _attribute(gaps, t, a, spans)
        t = max(t, b)
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "class_s": by_class,
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(gaps)}}


def _attribute(gaps: dict, a: float, b: float, spans: list) -> None:
    """Add the idle stretch [a, b) (microseconds) to the spans it overlaps
    (the benchmark's window spans do not nest), the rest to
    "imtbench.between_spans"."""
    rest = b - a
    for s0, s1, name in spans:
        if s0 >= b:
            break
        part = min(b, s1) - max(a, s0)
        if part > 0:
            gaps[name] = gaps.get(name, 0.0) + part * 1e-6
            rest -= part
    if rest > 0:
        gaps["imtbench.between_spans"] = \
            gaps.get("imtbench.between_spans", 0.0) + rest * 1e-6


class Cell:
    """What a driver gets: the cell's configuration and traffic, the run's
    seed, window and trace flag, the device, and the span and profiler
    hooks.  A driver calls ``begin_window()`` when set-up ends, and with a
    trace wraps a few whole units of the window in ``profiled()``."""

    def __init__(self, name, config, traffic, seed, seconds, trace, device,
                 t0):
        self.name, self.config, self.traffic = name, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self._t0 = device, t0
        self.setup_s = None
        self.trace_result = None
        self.notes = []
        self._pinned = {}

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def span(self, name: str):
        import torch
        return torch.profiler.record_function("imtbench." + name)

    def begin_window(self) -> float:
        """Set-up ends here: returns the window's start on perf_counter.
        Set-up's objects are moved out of the collector's generations, so
        that no full collection in the window scans them again."""
        self.sync()
        gc.collect()
        gc.freeze()
        self.setup_s = process_age_s(self._t0)
        return time.perf_counter()

    def host_copy(self, fields: dict) -> dict:
        """Device tensors -> numpy, through pinned buffers that the
        harness keeps and reuses (one per field), with one wait for all
        copies: the client's side of handing a bundle to the host.  The
        arrays returned are overwritten by the next call; other values
        pass through."""
        import numpy as np
        import torch
        if self.device.type != "cuda":
            return {k: v.cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v) for k, v in fields.items()}
        bufs, out = self._pinned, {}
        for k, v in fields.items():
            if not isinstance(v, torch.Tensor):
                out[k] = np.asarray(v)
                continue
            buf = bufs.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                buf = bufs[k] = torch.empty(v.shape, dtype=v.dtype,
                                            pin_memory=True)
            buf.copy_(v, non_blocking=True)
            out[k] = buf.numpy()
        torch.cuda.current_stream(self.device).synchronize()
        return out

    def note(self, text: str):
        self.notes.append(text)

    @contextlib.contextmanager
    def profiled(self):
        """Profile the block inside (CPU and device activity) as the traced
        sub-window.  Its chrome trace goes to a directory of TMPDIR, is
        reduced, and deleted."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        tmp = tempfile.mkdtemp(prefix="imtbench_trace_")
        try:
            with profile(activities=acts) as prof:
                with torch.profiler.record_function(TRACED):
                    yield
                    self.sync()
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            self.trace_result = reduce_trace(
                load_json(path)["traceEvents"], kernel_classes())
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
