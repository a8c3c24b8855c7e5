"""Shared fixtures of the benchmark's CPU tests: each cell's configuration
and traffic cut to a test's size (widths 8, 32 px crops, 160x120 frames,
a 320-face mesh, 84 hypotheses, fewer frames and pairs), compared under
the cells' own limits."""
from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

SMALL = dict(base_width=8, input_res=32, frame_height=120, frame_width=160, fx=140.0, fy=140.0)
SMALL_ESTIMATOR = dict(inplane_step_deg=180)
SMALL_TRAFFIC = {"register": dict(frames=1, depth_m=[0.8, 0.9], offset_px=10, warm_passes=1, check_registers=1,
                                  traced_requests=1),
                 "track": dict(frames=4, check_frames=4, chain_frames=4, traced_requests=4),
                 "train": dict(batch=4, traced_requests=2, check_window_steps=1)}


def small(workload: str):
    from benchmark import harness

    cell = harness.find_cell(harness.manifest(), workload)
    cfg, tr = harness.load_config(cell["config"]), harness.load_traffic(cell["traffic"])
    cfg = dict(cfg, **SMALL, mesh=dict(cfg["mesh"], subdivisions=2))
    if "n_views" in cfg:
        cfg.update(SMALL_ESTIMATOR)
    tr = dict(tr, **SMALL_TRAFFIC[tr["kind"]])
    return cell, cfg, tr


@pytest.fixture
def small_cell(monkeypatch):
    """Make harness.run load the cut configuration and traffic of a cell."""
    from benchmark import harness

    def use(workload):
        cell, cfg, tr = small(workload)
        monkeypatch.setattr(harness, "load_config", lambda name: cfg)
        monkeypatch.setattr(harness, "load_traffic", lambda name: tr)
        return cell, cfg, tr

    return use


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def manifest_copy(tmp_path, edit):
    from benchmark import harness

    man = harness.manifest()
    edit(man)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    return str(tmp_path)
