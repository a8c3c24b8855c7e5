"""`correct` at test size on the CPU, under each cell's own limits: a sound
run is correct; the control (the reference computed in fp8 in the
program's place) is not; nor is a run with a fault planted under the timed
path (benchmark/faults.py), once for each fault the cell can have (a
tracked frame has no batch to halve, and one chip no exchange). The sound
run computes in f32: at widths of 8 channels bf16's rounding reads higher
than at the cells' widths (a training gradient's worst leaf 0.014-0.04
against 0.002-0.006 at width 64), so the limits set at full width hold
only the f32 path here."""
from __future__ import annotations

import pytest

from benchmark import faults, harness

SEED = 2**31 + 99
CELLS = ["register-bop", "track-video", "train-refiner"]
FAULTED = [(w, f) for w in CELLS for f in faults.FAULTS if not (w == "track-video" and f == "half_batch")]


def _run(workload, control=False):
    return harness.run(workload, SEED, 0.3, False, device="cpu", control=control)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(small_cell, workload):
    _, cfg, _ = small_cell(workload)
    cfg["compute_dtype"] = "float32"
    r = _run(workload)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(small_cell, workload):
    small_cell(workload)
    r = _run(workload, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload,fault", FAULTED)
def test_fault_is_not_correct(small_cell, workload, fault):
    _, _, tr = small_cell(workload)
    with faults.planted(tr["kind"], fault):
        r = _run(workload)
    assert not r["correct"], r["checks"]
