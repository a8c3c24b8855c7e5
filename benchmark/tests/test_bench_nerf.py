"""The cell nerf-oct-train on the CPU at a small cut (4 levels, 2^12 rows a
level, 3 views of 48x64, 64 rays x (16 + 16) samples; the cut is made here,
as the other cells' is in conftest.py): its files found by name, the
configuration at every published width, the work counts, a sound f32 run
`correct` and the fp8 control not, and every per-layer metric of the cell
read from a traced run."""
from __future__ import annotations

import dataclasses
import json
import os

import pytest

from conftest import ROOT

from benchmark import harness, nerf_work
from benchmark.reference import nerf as ref

WORKLOAD = "nerf-oct-train"
SEED = 2**33 + 17
CUT = dict(num_levels=4, log2_hashmap_size=12, base_res=8, finest_res=32, frame_height=48, frame_width=64,
           fx=120.0, fy=120.0, views=3, first_frame_dilate=10, n_rand=64, n_samples=16, n_samples_around_depth=16)
CUT_TRAFFIC = dict(azimuth_step_deg=120, elevations_deg=[30], traced_requests=2, check_window_steps=2)


@pytest.fixture
def small(monkeypatch):
    cell = harness.find_cell(harness.manifest(), WORKLOAD)
    cfg, tr = harness.load_config(cell["config"]), harness.load_traffic(cell["traffic"])
    cfg = dict(cfg, **CUT, amp=False, mesh=dict(cfg["mesh"], subdivisions=2))
    tr = dict(tr, **CUT_TRAFFIC)
    monkeypatch.setattr(harness, "load_config", lambda name: cfg)
    monkeypatch.setattr(harness, "load_traffic", lambda name: tr)
    return cfg, tr


def test_files_found_by_name_at_every_published_width():
    from foundationpose_torch.nerf import NerfCfg

    man = harness.manifest()
    cell = harness.find_cell(man, WORKLOAD)
    entry = next(c for c in man["configs"] if c["name"] == cell["config"])
    cfg, tr = harness.load_config(cell["config"]), harness.load_traffic(cell["traffic"])
    assert cfg["name"] == cell["config"] and entry["reduced"] == [] and tr["kind"] == "nerf"
    assert callable(harness.load_module("drivers", tr["kind"]).Driver) and tr["limits"]
    defaults = NerfCfg()
    for f in dataclasses.fields(NerfCfg):
        if f.name in cfg:
            assert cfg[f.name] == getattr(defaults, f.name), f.name
    assert cfg["views"] == 16
    layer = [m for m in man["per_layer"] if WORKLOAD in m.get("workloads", [])]
    assert len(layer) == 11 and all(m["moves"] == "train_step_ms" for m in layer)
    for section in ("end_to_end", "per_layer"):
        for m in harness.metrics_of(man, section, WORKLOAD):
            assert callable(harness.load_metric(m["name"]).read)


def test_work_counts():
    with open(os.path.join(ROOT, "benchmark", "configs", "fp-modelfree-nerf.json")) as f:
        cfg = json.load(f)
    assert ref.level_tables(cfg)[3] == 36_112_368
    assert nerf_work.mlp_flops_per_point(cfg) == 2 * (32 * 64 + 64 * 16 + 26 * 64 + 64 * 64 + 64 * 3) == 18048
    assert nerf_work.points_per_step(cfg) == 2048 * 256
    assert nerf_work.step_flops(cfg) == 3 * 18048 * 524288
    assert nerf_work.grid_grad_bytes(cfg, 524288) == 524288 * 35 * 4 + 36_112_368 * 8


def test_sound_run_is_correct(small):
    r = harness.run(WORKLOAD, SEED, 0.3, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and set(r["metrics"]) == {"train_step_ms", "setup_s"}


def test_control_is_not_correct(small):
    r = harness.run(WORKLOAD, SEED, 0.3, False, device="cpu", control=True)
    assert not r["correct"], r["checks"]


def test_traced_run_reads_every_metric(small):
    r = harness.run(WORKLOAD, SEED + 1, 0.3, True, device="cpu")
    names = [m["name"] for m in harness.metrics_of(harness.manifest(), "per_layer", WORKLOAD)]
    assert set(r["metrics"]) == set(names), set(names) - set(r["metrics"])
    assert all(v["value"] >= 0 for v in r["metrics"].values())
