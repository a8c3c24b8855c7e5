"""One run of one cell, found by name in BENCHMARK.json.

A cell names a configuration (`configs/<config>.json`, the sizes as run)
and a traffic mix (`traffic/<traffic>.json`, the parameters its driver
reads and the limit of each number `correct` compares). The traffic's
`kind` names its driver, `drivers/<kind>.py`, whose `Driver(cfg, traffic,
seed, device)` sets up, serves one request a `request()`, and after the
window judges a seeded sample of what it served (`check(rng, control)`);
it may have `end_window()`, `trace_spans()` and `flops_per_request()`.
Every metric, end-to-end or per-layer, is the file `metrics/<name>.py`,
whose `read(ctx)` returns its value, or None when the cell gives it
nothing to read. Adding a cell, a traffic kind, a configuration or a
metric adds files and entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.dirname(os.path.abspath(__file__))
# Top-level module names that may not be loaded by a run: the JAX package
# and what it runs on, and the repository's TPU-era smoke script.
FORBIDDEN = ("jax", "jaxlib", "flax", "foundationpose_tpu", "chip_smoke")


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def find_cell(man: dict, workload: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return _json("configs", name + ".json")


def load_traffic(name: str) -> dict:
    return _json("traffic", name + ".json")


def load_module(folder: str, name: str):
    """The module <folder>/<name>.py, loaded by path (names hold dots and
    dashes)."""
    path = os.path.join(BENCH, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{folder}_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    return load_module("metrics", name)


def make_driver(cfg: dict, tr: dict, seed: int, device):
    import torch

    return load_module("drivers", tr["kind"]).Driver(cfg, tr, seed, torch.device(device))


@dataclasses.dataclass
class Window:
    seconds: float
    served: int
    latencies: list


def run_window(driver, seconds: float, count: int | None = None) -> Window:
    """Serve requests back to back for `seconds` (or exactly `count`), and
    wait for the device; every request's host latency is kept."""
    import torch

    lat = []
    sync = torch.cuda.synchronize if driver.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    while (count is None and time.perf_counter() - t0 < seconds) or (count is not None and len(lat) < count):
        a = time.perf_counter()
        driver.request()
        lat.append(time.perf_counter() - a)
    sync()
    return Window(time.perf_counter() - t0, len(lat), lat)


def metrics_of(man: dict, section: str, workload: str) -> list:
    return [m for m in man[section] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card() -> dict:
    """The card's name, count and power limit (nvidia-smi)."""
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(q.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        out["power_limit_w"] = None
    return out


@dataclasses.dataclass
class Context:
    """What a metric's reader may read: the cell's configuration, its
    traffic kind and driver, the set-up's seconds, the untraced window
    (the whole window of a --trace 0 run), and in a --trace 1 run the
    traced stretch's window, its trace summary and the driver's spans."""

    cfg: dict
    kind: str
    driver: object
    setup_s: float
    untraced: Window
    traced: Window | None = None
    summary: object = None
    spans: list | None = None


def read_metrics(man: dict, section: str, workload: str, ctx: Context) -> dict:
    out = {}
    for m in metrics_of(man, section, workload):
        value = load_metric(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def finite(v) -> float:
    """A number as the result line prints it: one that is not finite (a
    spread of nought, the pick of an invalid hypothesis) reads 1e300."""
    v = float(v)
    return v if math.isfinite(v) else 1e300


def compared(numbers: dict, limits: dict) -> dict:
    return {k: {"value": finite(numbers[k]), "limit": float(limits[k])} for k in limits}


def run(workload: str, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
        control=False) -> dict:
    """Set up, measure, check; returns the result line's object. With
    `control` the check puts the reference computed in fp8 in the
    program's place (calibrate.py)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    man = manifest()
    cell = find_cell(man, workload)
    cfg, tr = load_config(cell["config"]), load_traffic(cell["traffic"])
    from . import trace as tracing

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    driver = make_driver(cfg, tr, seed, dev)
    setup_s = time.perf_counter() - t_start
    result = {"correct": None, "attempted": 0, "failed": 0, "metrics": {}}
    end_window = getattr(driver, "end_window", lambda: None)
    if not trace:
        win = run_window(driver, seconds)
        end_window()
        result["attempted"] = win.served
        result["metrics"] = read_metrics(man, "end_to_end", workload, Context(cfg, tr["kind"], driver, setup_s, win))
    else:
        untraced = run_window(driver, seconds / 2)
        spans = driver.trace_spans() if hasattr(driver, "trace_spans") else None
        out_dir = os.path.join(ROOT, "build", "benchmark")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "trace.json")
        win, events = tracing.traced(lambda: run_window(driver, 0, tr["traced_requests"]), path, dev)
        os.unlink(path)
        end_window()
        summary = tracing.summarize(events)
        result["attempted"] = untraced.served + win.served
        ctx = Context(cfg, tr["kind"], driver, setup_s, untraced, win, summary, spans)
        result["metrics"] = read_metrics(man, "per_layer", workload, ctx)
        result["breakdown"] = {
            "device_ops": [[k, s] for k, s in sorted(summary.kernels.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k, s] for k, s in summary.gaps]}
    device_info = card() if dev.type == "cuda" else {"platform": "cpu", "kind": "cpu", "count": 1}
    device_info["memory_peak_bytes"] = torch.cuda.max_memory_reserved() if dev.type == "cuda" else 0
    if trace:
        device_info["busy_s"], device_info["window_s"] = summary.busy_s, win.seconds
    result["device"] = device_info
    if getattr(driver, "recoveries_in_window", None) is not None:
        result["full_frame_reruns"] = driver.recoveries_in_window
    numbers = driver.check(np.random.default_rng([seed, 7]), control)
    checks = compared(numbers, tr["limits"])
    result["failed"] = sum(not v["value"] <= v["limit"] for v in checks.values())
    result["correct"] = result["failed"] == 0
    result["numbers"] = {k: finite(v) for k, v in numbers.items() if k not in checks}
    result["checks"] = checks
    return result


def main(argv=None, t_start=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one benchmark cell once; print its result as a JSON line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch

    cell = find_cell(manifest(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    found = forbidden_modules()
    if found:
        print(f"modules that a run may not load were loaded: {found}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']:.6g} limit {v['limit']:.6g}", file=sys.stderr)
    print(json.dumps(result))
    return 0
