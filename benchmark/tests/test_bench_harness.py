"""The harness on the CPU: the manifest against the contract, files found by
name, a cell added by files and entries alone, the trace summary and every
metric reader on a small chrome trace, the FLOP counts, and the imports of
a run."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from conftest import ROOT

sys.path.insert(0, ROOT)

from benchmark import flops, harness, trace  # noqa: E402
from benchmark.peaks import bound  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trace_fixture.json")


def test_manifest_keeps_the_contract():
    man = harness.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"] and man["command"][1].startswith("benchmark/")
    assert 1 <= man["run_seconds"] <= 51
    configs = {c["name"]: c for c in man["configs"]}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/configs/")
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == c["name"]
    used = set()
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
        used.add(w["config"])
        e2e = harness.metrics_of(man, "end_to_end", w["name"])
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert harness.metrics_of(man, "per_layer", w["name"])
    assert used == set(configs)
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
    e2e_names = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e_names and NAME.match(m["name"])
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", m["name"] + ".py"))
        moved = next(e for e in man["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    names = [x["name"] for s in ("configs", "workloads", "end_to_end", "per_layer") for x in man[s]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("workload", ["register-bop", "track-video", "train-refiner"])
def test_files_found_by_name(workload):
    man = harness.manifest()
    cell = harness.find_cell(man, workload)
    cfg, tr = harness.load_config(cell["config"]), harness.load_traffic(cell["traffic"])
    assert cfg["name"] == cell["config"] and callable(harness.load_module("drivers", tr["kind"]).Driver)
    assert tr["limits"], "every cell compares some numbers"
    for section in ("end_to_end", "per_layer"):
        for m in harness.metrics_of(man, section, workload):
            assert callable(harness.load_metric(m["name"]).read)


COUNT_DRIVER = """
class Driver:
    def __init__(self, cfg, tr, seed, device):
        self.device, self.step, self.served = device, cfg["step"], 0

    def request(self):
        self.served += self.step

    def check(self, rng, control=False):
        return {"miscount": float(control)}
"""


def test_a_cell_is_added_by_files_and_entries(tmp_path):
    """A copy of the benchmark gains, as files and entries alone, a cell of
    an existing kind (a traffic file and a per-layer metric), and a cell of
    a new traffic kind with its own configuration, driver and end-to-end
    metric; the copy's harness finds them and runs the new kind's cell on
    the CPU, no file edited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "benchmark"
    man = harness.manifest()
    tr = dict(harness.load_traffic("bop-frames"), frames=4)
    (bench / "traffic" / "bop-frames-4.json").write_text(json.dumps(tr))
    (bench / "metrics" / "register.served.py").write_text("def read(ctx):\n    return float(ctx.traced.served)\n")
    man["workloads"].append({"name": "register-bop-4", "config": "fp-estimator-bf16", "traffic": "bop-frames-4",
                             "chips": 1, "why": "four frames"})
    man["end_to_end"][0]["workloads"].append("register-bop-4")
    man["per_layer"].append({"name": "register.served", "unit": "registers", "better": "higher",
                             "source": "host_clock", "layer": "device", "moves": "register_ms",
                             "workloads": ["register-bop-4"]})
    (bench / "drivers" / "count.py").write_text(COUNT_DRIVER)
    (bench / "configs" / "counter.json").write_text(json.dumps({"name": "counter", "step": 2}))
    (bench / "traffic" / "count-1.json").write_text(json.dumps(
        {"kind": "count", "traced_requests": 3, "limits": {"miscount": 0.5}}))
    (bench / "metrics" / "count_per_s.py").write_text(
        "def read(ctx):\n    return ctx.driver.served / ctx.untraced.seconds\n")
    (bench / "metrics" / "count.traced.py").write_text("def read(ctx):\n    return float(ctx.traced.served)\n")
    man["configs"].append({"name": "counter", "source": "https://example.org/counter", "reduced": [],
                           "file": "benchmark/configs/counter.json", "why": "a counter"})
    man["workloads"].append({"name": "count-1", "config": "counter", "traffic": "count-1", "chips": 1,
                             "why": "counts"})
    man["end_to_end"].insert(0, {"name": "count_per_s", "unit": "1/s", "better": "higher", "bound": 0.01,
                                 "source": "host_clock", "workloads": ["count-1"]})
    man["per_layer"].append({"name": "count.traced", "unit": "requests", "better": "higher",
                             "source": "host_clock", "layer": "device", "moves": "count_per_s",
                             "workloads": ["count-1"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = ("import sys, types; sys.path.insert(0, sys.argv[1]); from benchmark import harness\n"
            "assert harness.__file__.startswith(sys.argv[1]) and harness.ROOT == sys.argv[1]\n"
            "man = harness.manifest(); cell = harness.find_cell(man, 'register-bop-4')\n"
            "assert harness.load_traffic(cell['traffic'])['frames'] == 4\n"
            "ms = [m['name'] for m in harness.metrics_of(man, 'per_layer', 'register-bop-4')]\n"
            "assert ms == ['register.served'], ms\n"
            "ctx = types.SimpleNamespace(traced=types.SimpleNamespace(served=3))\n"
            "assert harness.load_metric('register.served').read(ctx) == 3.0\n"
            "r = harness.run('count-1', 2**33 + 1, 0.05, False, device='cpu')\n"
            "assert r['correct'] and set(r['metrics']) == {'count_per_s', 'setup_s'}, r\n"
            "assert r['metrics']['count_per_s']['value'] > 0 and r['attempted'] > 0\n"
            "r = harness.run('count-1', 5, 0.05, True, device='cpu')\n"
            "assert set(r['metrics']) == {'count.traced'} and r['metrics']['count.traced']['value'] == 3.0, r\n"
            "assert not harness.run('count-1', 5, 0.05, False, device='cpu', control=True)['correct']\n")
    subprocess.run([sys.executable, "-c", code, str(tmp_path)], check=True, cwd=tmp_path)


def test_trace_summary():
    s = trace.summarize(trace.load(FIXTURE))
    assert s.busy_s == pytest.approx(326e-6)
    assert s.activities == 10 and s.launches == 4
    assert s.gaps == [("cudaStreamSynchronize", pytest.approx(430e-6)), ("cudaGraphLaunch", pytest.approx(50e-6)),
                      ("cudaGraphLaunch", pytest.approx(10e-6))]
    mha = [k for k in s.kernels if k.startswith("mha_")]
    assert len(mha) == 1 and s.kernels[mha[0]] == pytest.approx(60e-6)


def _ctx(kind):
    s = trace.summarize(trace.load(FIXTURE))
    cfg = {"base_width": 1, "input_res": 8, "num_heads": 1}
    drv = types.SimpleNamespace(n_hyp=4, iters=1, flops_per_request=lambda: 1e12,
                                mesh=types.SimpleNamespace(pos=types.SimpleNamespace(shape=(10, 3)),
                                                           faces=types.SimpleNamespace(shape=(12, 3))))
    win = lambda seconds, served: harness.Window(seconds, served, [seconds / served] * served)  # noqa: E731
    return harness.Context(cfg, kind, drv, 12.5, win(1e-3, 2), win(5e-3, 2), s, None)


def test_metric_readers_on_the_fixture():
    read = lambda name, kind: harness.load_metric(name).read(_ctx(kind))  # noqa: E731
    assert read("register.elementwise_ms", "register") == pytest.approx(0.06)
    assert read("register.conv_ms", "register") == pytest.approx(0.0475)
    assert read("register.host_launches", "register") == 2 and read("track.host_launches", "track") == 2
    assert read("track.device_ms", "track") == pytest.approx(0.163)
    for kind in ("register", "track", "train"):
        assert read(f"{kind}.idle_share", kind) == pytest.approx((1 - 326e-6 / 5e-3) * 100)
        assert read(f"{kind}.mfu", kind) == pytest.approx(2e12 / (1e-3 * 989e12) * 100)
    k1 = 2 * bound(10 * 36 + 12 * 24 + 4 * 100 + 4 * 64 * 25, 0, "f32")[0] * 2 / 50e-6 * 100
    assert read("register.k1_roofline", "register") == pytest.approx(k1)
    # 3 self-attention calls at (B 4, L 1, d 8) and one cross-attention at (1, 4, 8)
    k2 = (3 * bound(4 * 1 * 4 * 8 * 2, 4 * 4 * 1 * 8, "bf16")[0]
          + bound(1 * 4 * 4 * 8 * 2, 4 * 1 * 16 * 8, "bf16")[0]) * 2 / 60e-6 * 100
    assert read("register.k2_roofline", "register") == pytest.approx(k2)
    assert read("train.batch_ms", "train") is None  # no spans: nothing to read
    for name in ("register_ms", "track_ms", "train_step_ms", "track_p95_ms"):
        assert read(name, "register") == pytest.approx(0.5)
    assert read("setup_s", "train") == 12.5
    assert read("register.mfu", "track") is None and read("track.device_ms", "register") is None


def test_flops_against_hand_counts():
    assert flops.refine_pair(64, 160) / 1e9 == pytest.approx(23.946, abs=1e-3)
    assert flops.score_pair(64, 160) / 1e9 == pytest.approx(21.938, abs=1e-3)
    assert flops.register(252, 5, 64, 160) / 1e12 == pytest.approx(35.70, abs=0.01)
    assert flops.track_frame(2, 64, 160) / 1e9 == pytest.approx(47.89, abs=0.01)
    assert flops.train_step(64, 64, 160) / 1e12 == pytest.approx(4.60, abs=0.01)
    # width 1, 16 px crops: every layer by hand
    conv = (2 * 6 * 49 * 1 * 64 + 2 * 1 * 9 * 2 * 16 + 4 * 2 * 2 * 9 * 2 * 16) * 2 \
        + 4 * 2 * 4 * 9 * 4 * 16 + 2 * 4 * 9 * 8 * 4 + 4 * 2 * 8 * 9 * 8 * 4
    layer = 2 * 4 * 8 * 24 + 4 * 16 * 8 + 2 * 4 * 8 * 8 + 4 * 4 * 8 * 512
    assert flops.refine_pair(1, 16) == conv + 2 * layer + 2 * 4 * 8 * 6
    assert flops.k2_work(252, 400, 512, 4) == (252 * 400 * 2048 * 2, 4 * 252 * 400 * 400 * 512)


def test_no_card_no_result():
    """Without a CUDA card a run exits nonzero and prints no result."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "register-bop", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax(small_cell):
    """A run's whole import graph (harness, drivers, reference, readers, the
    program) at test size, in a fresh process: no top-level module jax,
    jaxlib, flax, foundationpose_tpu or chip_smoke."""
    code = ("import sys; sys.path.insert(0, 'benchmark/tests'); sys.path.insert(0, '.')\n"
            "import conftest; from benchmark import harness\n"
            "cell, cfg, tr = conftest.small('train-refiner')\n"
            "harness.load_config = lambda n: cfg; harness.load_traffic = lambda n: tr\n"
            "r = harness.run('train-refiner', 5, 0.2, True, device='cpu')\n"
            "[harness.load_metric(m['name']) for m in harness.manifest()['per_layer']]\n"
            "import benchmark.run, benchmark.calibrate, benchmark.faults\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            "assert harness.forbidden_modules() == [], harness.forbidden_modules()\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "foundationpose_torch" in p.stdout and "'jax'" not in p.stdout


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            src = open(os.path.join(ref, f)).read()
            assert "foundationpose" not in src.replace("FoundationPose", ""), f
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.reference.pipeline, benchmark.traffic\n"
            "assert not any(m.split('.')[0] == 'foundationpose_torch' for m in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


@pytest.mark.gpu
def test_cell_runs_on_the_card(card):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train-refiner", "--seed", "2147483659",
                        "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] and list(r)[-1] == "checks" and r["device"]["platform"] == "gpu"
    assert set(r["metrics"]) == {"train_step_ms", "setup_s"}
