#!/usr/bin/env python3
"""The benchmark of imt_tpu_torch: one cell, one run, one JSON line.

    python3 imtbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  It looks the cell up in ``BENCHMARK.json``,
loads its configuration, its traffic mix and the mix's driver by name,
and runs set-up, the measured window and the check against the plain
reference (``reference/``) on one CUDA device.  With ``--trace 0`` the
line carries the cell's end-to-end metrics; with ``--trace 1`` its
per-layer ones, read from a profiled stretch of whole units of the window.
The numbers the check compared are printed last on standard error and,
under ``checks``, last in the line.

It exits non-zero and prints no result when there is no CUDA device (or
fewer than the cell asks for), when the cell's files or the program are
missing, or when ``jax``, ``jaxlib``, ``flax`` or ``imt_tpu`` is loaded
once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from imtbench import harness  # noqa: E402


def _cache_env():
    """Kernel caches at fixed paths inside the checkout (the program's own
    nvcc builds go to imt_tpu_torch/build/ there already)."""
    cache = os.path.join(harness.ROOT, ".imtbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(harness.FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, overrides=None, t0: float = _T0) -> dict:
    """One run of a cell; returns the result line as a dict.  `device`
    None means the first CUDA device.  `overrides` ({"config": {...},
    "traffic": {...}}) replaces keys of the cell's files: the CPU tests use
    it to run a cell at a tiny size on the plain path."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    man = harness.manifest()
    entry, _, config, traffic = harness.resolve(man, workload)
    overrides = overrides or {}
    config = dict(config, **overrides.get("config", {}))
    traffic = dict(traffic, **overrides.get("traffic", {}))
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cell = harness.Cell(workload, config, traffic, seed, seconds, trace, dev,
                        t0)
    driver = harness.load_module(os.path.join(
        harness.BENCH_DIR, "drivers", traffic["driver"] + ".py"))
    with torch.inference_mode():
        res = driver.run(cell)

    checks = res["checks"]
    correct = bool(checks) and all(v <= lim for _, v, lim in checks)
    card = {}
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        clock = harness.nvidia_smi("clocks.max.sm")
        card = {"sm_count": props.multi_processor_count,
                "clock_mhz": float(clock.split()[0]) if clock else None,
                "power_limit": harness.nvidia_smi("power.limit")}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "count": 1,
        "memory_peak_bytes": int(res["memory_peak_bytes"])}

    metrics, breakdown = {}, None
    if trace:
        tr = cell.trace_result
        view = harness.TraceView(tr["window_s"], tr["busy_s"], tr["class_s"],
                                 res["traced"]["units"],
                                 res["traced"].get("counts", {}), card)
        for m in harness.metrics_for(man, workload, True):
            value = harness.metric_reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        breakdown = tr["breakdown"]
    else:
        values = dict(res["e2e"], setup_s=cell.setup_s)
        for m in harness.metrics_for(man, workload, False):
            metrics[m["name"]] = {"value": values[harness.quantity(m["name"])],
                                  "unit": m["unit"]}
    line = {"correct": correct, "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics,
            "device": device_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["notes"] = cell.notes + [f"card {card}"] if card else cell.notes
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    try:
        man = harness.manifest()
        entry, _, _, traffic = harness.resolve(man, args.workload)
        if not os.path.exists(os.path.join(
                harness.BENCH_DIR, "drivers", traffic["driver"] + ".py")):
            raise FileNotFoundError(traffic["driver"])
        import imt_tpu_torch  # noqa: F401  (the program under test)
    except (OSError, KeyError, ValueError, ImportError) as e:
        print(f"imtbench: cannot set up {args.workload}: {e!r}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print(f"imtbench: {args.workload} needs {entry['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"imtbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for note in line["notes"]:
        print(f"imtbench: {note}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
