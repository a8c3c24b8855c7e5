"""On-card smoke run of foundationpose_torch: build, check, drive, time.

    python3 chip_smoke.py

Needs one CUDA card (sm_90a) and nvcc; imports no JAX. Phases, each
under its own time limit (a phase that fails or runs out ends the run
with a nonzero exit and no result line):

1. environment: versions, nvcc, the card's name and power limit;
2. build both kernels from foundationpose_torch/csrc/ (nvcc, first use);
3. K1, the tile rasterizer, against the plain brute path at the main
   path's crop shape (16 poses, 160x160, ~5k-face mesh, vertex colors,
   light, culling off and on) and the probes: one pose, object behind
   the camera, tiny object; masks bit-equal, max |d| < 2e-4 on smooth
   pixels, < 4% of covered pixels off by more than 1e-3;
4. K2, the attention core, against its plain version in bf16 (< 2e-3)
   and f32 (< 1e-4);
5. the main path: a small f32 register + track on the card against the
   same run on the CPU plain path, then the full-width estimator
   (base_width 64, 160x160 crops, bf16, random weights from a seed,
   zeroed delta heads): register(iteration=5) over the 252-hypothesis
   grid and 3 x track_one(iteration=2), with the kernels' launch counts
   read around that run;
6. times: each kernel against its plain version at the main path's
   shapes, register wall time, per-frame track time, stage times.

Prints a {"kernels": [...]} JSON line, then as its last line
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import shutil
import signal
import subprocess
import sys
import time

import numpy as np

_CARD = "not measured"  # nvidia-smi "name, power.limit", set in phase 1


class PhaseTimeout(Exception):
    pass


def _alarm(signum, frame):
    raise PhaseTimeout("phase time limit reached")


def phase(name, seconds, fn, *args):
    print(f"[phase] {name} (limit {seconds} s)", flush=True)
    signal.signal(signal.SIGALRM, _alarm)
    signal.alarm(seconds)
    t0 = time.perf_counter()
    try:
        out = fn(*args)
    finally:
        signal.alarm(0)
    print(f"[phase] {name} done in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def _event_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------- phases


def env_phase():
    global _CARD
    import torch

    print("python", sys.version.split()[0], "torch", torch.__version__, "cuda", torch.version.cuda)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this run needs a CUDA card")
    from foundationpose_torch.ops.cuda_build import find_nvcc

    print("nvcc", find_nvcc(), "| nvidia-smi", shutil.which("nvidia-smi"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    _CARD = smi.stdout.strip().splitlines()[0]
    print(_CARD)
    print("device", torch.cuda.get_device_name(0), "count", torch.cuda.device_count(),
          "capability", torch.cuda.get_device_capability(0))


def build_phase():
    from foundationpose_torch.ops import attention_cuda, raster_cuda

    for k in (raster_cuda.KERNEL, attention_cuda.KERNEL):
        t0 = time.perf_counter()
        path = k.build()
        print(f"built {k.source} -> {path} in {time.perf_counter() - t0:.2f} s")
        for line in k.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print("   ", line.strip())


def _bench_mesh():
    """bench.py:361-363: icosphere(4) (5120 faces, r = 0.1 m) with a
    sinusoidal radial bump; vertex colors from a seed."""
    from foundationpose_torch.geometry.icosphere import icosphere
    from foundationpose_tpu.meshio import TriMesh

    verts, faces = icosphere(4, radius=0.1)
    verts = verts * (1.0 + 0.15 * np.sin(8 * verts[:, 2:3]))
    colors = np.random.default_rng(0).integers(30, 255, (len(verts), 3)).astype(np.uint8)
    return TriMesh(vertices=verts, faces=faces, vertex_colors=colors)


K_FULL = np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1.0]], np.float32)


def _shift_filter(x, reduce):
    out = x.copy()
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out = reduce(out, np.roll(np.roll(x, dy, axis=1), dx, axis=2))
    return out


def render_criterion(ref, out):
    """bench.py:36-45. Returns (mask mismatches, smooth max |d|, share of
    covered pixels off by > 1e-3, max |d| over covered pixels)."""
    mr = ref.mask.cpu().numpy()
    mo = out.mask.cpu().numpy()
    interior = _shift_filter(mr.astype(np.uint8), np.minimum).astype(bool)
    bd = ref.depth.cpu().numpy()
    zmax = _shift_filter(np.where(mr, bd, -1e9), np.maximum)
    zmin = _shift_filter(np.where(mr, bd, 1e9), np.minimum)
    smooth = interior & ((zmax - zmin) < 2e-3)
    smooth_max = big = covered_max = 0.0
    for f in ("color", "depth", "xyz"):
        a = getattr(ref, f).cpu().numpy()
        b = getattr(out, f).cpu().numpy()
        if not np.isfinite(b).all():
            raise AssertionError(f"K1 output {f} is not finite")
        sm = smooth[..., None] if a.ndim == 4 else smooth
        mm = mr[..., None] if a.ndim == 4 else mr
        d = np.abs(a - b)
        smooth_max = max(smooth_max, float((d * sm).max()))
        covered_max = max(covered_max, float((d * mm).max()))
        if f != "xyz":
            big = max(big, int(((d * mm) > 1e-3).sum()))
    return int((mr != mo).sum()), smooth_max, big / max(int(mr.sum()), 1), covered_max


def k1_phase():
    import torch

    from foundationpose_torch.geometry.icosphere import sample_views_icosphere
    from foundationpose_torch.geometry.projection import compute_crop_window_tf
    from foundationpose_torch.ops.rasterizer import render_mesh, render_mesh_brute
    from foundationpose_tpu.meshio import compute_mesh_diameter

    dev = torch.device("cuda")
    mesh = _bench_mesh()
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    rng = np.random.default_rng(7)
    views = sample_views_icosphere(n_views=4)[:16]
    poses = np.linalg.inv(views).astype(np.float32)
    poses[:, :3, 3] = [0.02, -0.01, 0.9]
    poses[:, 2, 3] += rng.uniform(-0.15, 0.3, len(poses))
    diam = compute_mesh_diameter(mesh.vertices)
    pos, faces = T(mesh.vertices), torch.as_tensor(mesh.faces, device=dev)
    colors = T(mesh.vertex_colors / 255.0)
    vn = T(mesh.vertex_normals)
    Kt = T(K_FULL)

    # full 160x160 view for the uncropped probes
    K_probe = T([[600.0, 0, 80.0], [0, 600.0, 80.0], [0, 0, 1.0]])

    def check(name, P, crop=True, **extra):
        Pt = T(P)
        K = Kt if crop else K_probe
        kw = dict(out_hw=(160, 160), vertex_color=colors, vnormals=vn, use_light=True)
        if crop:
            kw["crop_tf"] = compute_crop_window_tf(Pt, Kt, 1.2, 160, diam)
        kw.update(extra)
        out = render_mesh(pos, faces, Pt, K, **kw)
        ref = render_mesh_brute(pos, faces, Pt, K, **kw)
        torch.cuda.synchronize()
        mism, smooth_max, edge, covered_max = render_criterion(ref, out)
        print(f"  K1 {name}: mask mismatches {mism}, covered {int(ref.mask.sum())}, "
              f"smooth max |d| {smooth_max:.3e}, share > 1e-3 {edge:.5f}, "
              f"covered max |d| {covered_max:.3e}")
        if mism or smooth_max >= 2e-4 or edge >= 0.04:
            raise AssertionError(f"K1 {name} fails the criterion")
        return covered_max

    err = 0.0
    for cull in (False, True):
        err = max(err, check(f"16 poses, cull={cull}", poses, cull_backfaces=cull))
    tex = np.random.default_rng(1).uniform(0, 1, (64, 64, 3))
    uv = np.random.default_rng(2).uniform(0, 1, (len(mesh.vertices), 2))
    err = max(err, check("16 poses, texture + normals", poses, uv=T(uv), tex=T(tex),
                         get_normal=True, vertex_color=None))
    err = max(err, check("one pose", poses[:1]))
    behind = poses[:1].copy()
    behind[0, 2, 3] = -0.9
    err = max(err, check("behind camera", behind, crop=False))
    tiny = poses[:1].copy()
    tiny[0, 2, 3] = 30.0  # ~5 px across: many faces per pixel
    err = max(err, check("tiny object", tiny, crop=False))
    return err


ATTN_SHAPES = [(252, 400, 512, 4), (1, 252, 512, 4), (2, 20, 256, 2)]


def k2_phase():
    import torch

    from foundationpose_torch.ops.attention import attention_core_plain
    from foundationpose_torch.ops.attention_cuda import attention_core_cuda

    err = 0.0
    for dtype, tol in ((torch.bfloat16, 2e-3), (torch.float32, 1e-4)):
        for B, L, D, H in ATTN_SHAPES:
            g = torch.Generator().manual_seed(3)
            x = ((torch.rand((B, L, 3 * D), generator=g) * 2 - 1)).to("cuda", dtype)
            d = (attention_core_cuda(x, H).float() - attention_core_plain(x, H).float())
            torch.cuda.synchronize()
            e = float(d.abs().max())
            print(f"  K2 {str(dtype)[6:]} B={B} L={L} D={D} H={H}: max |d| {e:.3e} (< {tol})")
            if not e < tol:
                raise AssertionError("K2 disagrees with its plain version")
            if dtype == torch.bfloat16:
                err = max(err, e)
    return err


def _estimator(mesh, cfg, device, seed=0, head_scale=0.0):
    import torch

    from foundationpose_torch.models import init_refine_net, init_score_net
    from foundationpose_torch.pipeline import FoundationPose

    refiner = init_refine_net(cfg.refiner.net, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for head in (refiner.trans_head, refiner.rot_head):
            head[1].weight.mul_(head_scale)
            head[1].bias.mul_(head_scale)
    scorer = init_score_net(cfg.scorer.net, torch.Generator().manual_seed(seed + 1))
    return FoundationPose(mesh=mesh, cfg=cfg, refiner_params=refiner,
                          scorer_params=scorer, device=device)


def _frame(mesh, t, hw, K, device):
    """The mesh rendered by the port at translation t (identity rotation)."""
    import torch

    from foundationpose_torch.ops.rasterizer import render_mesh

    gt = np.eye(4, dtype=np.float32)
    gt[:3, 3] = t
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    out = render_mesh(
        T(mesh.vertices), torch.as_tensor(mesh.faces, device=device), T(gt[None]), T(K),
        out_hw=hw, vertex_color=T(mesh.vertex_colors / 255.0), vnormals=T(mesh.vertex_normals),
    )
    rgb = (out.color[0].cpu().numpy() * 255).astype(np.uint8)
    return rgb, out.depth[0].cpu().numpy().astype(np.float32), out.mask[0].cpu().numpy().astype(np.uint8)


def small_slice_phase():
    """f32 register + track at test width on the card vs the CPU plain
    path: same winner, poses within 1e-4."""
    from foundationpose_torch.models import RefineNetCfg, ScoreNetCfg
    from foundationpose_torch.pipeline import EstimatorCfg, RefinerCfg, ScorerCfg
    from foundationpose_tpu.meshio import make_box

    box = make_box(np.array([0.12, 0.16, 0.2]))
    box.vertex_colors = np.random.default_rng(0).integers(40, 255, (8, 3)).astype(np.uint8)
    cfg = EstimatorCfg(
        refiner=RefinerCfg(net=RefineNetCfg(base_width=4), input_res=32, compute_dtype="float32"),
        scorer=ScorerCfg(net=ScoreNetCfg(base_width=4), input_res=32, mode="depth",
                         compute_dtype="float32"),
        min_n_views=4, inplane_step_deg=120.0,
    )
    K = np.array([[140.0, 0, 80.0], [0, 140.0, 60.0], [0, 0, 1.0]], np.float32)
    frame = _frame(box, (0.01, -0.02, 0.85), (120, 160), K, "cpu")
    res = {}
    for dev in ("cpu", "cuda"):
        est = _estimator(box, cfg, dev, head_scale=0.05)
        reg = est.register(K, *frame, iteration=2)
        trk = est.track_one(frame[0], frame[1], K, iteration=2)
        res[dev] = (est.best_id, reg, trk)
    d_reg = float(np.abs(res["cpu"][1] - res["cuda"][1]).max())
    d_trk = float(np.abs(res["cpu"][2] - res["cuda"][2]).max())
    print(f"  small slice: winner cpu {res['cpu'][0]} cuda {res['cuda'][0]}, "
          f"register max |d| {d_reg:.2e}, track max |d| {d_trk:.2e}")
    if res["cpu"][0] != res["cuda"][0] or not (d_reg < 1e-4 and d_trk < 1e-4):
        raise AssertionError("the slice on the card disagrees with the CPU plain path")


def main_path_phase():
    """Full-width register + 3 tracked frames; returns the launch counts
    of that run and the estimator + frame for timing."""
    import torch

    from foundationpose_torch.ops import attention_cuda, raster_cuda
    from foundationpose_torch.pipeline import EstimatorCfg, RasterCfg, RefinerCfg, ScorerCfg

    mesh = _bench_mesh()
    raster = RasterCfg(cull_backfaces=True)  # closed, outward-wound mesh: exact
    cfg = EstimatorCfg(
        refiner=RefinerCfg(raster=raster), scorer=ScorerCfg(mode="network", raster=raster)
    )
    est = _estimator(mesh, cfg, "cuda")
    n_hyp = int(est.hyp_valid.sum())
    frame = _frame(mesh, (0.02, -0.01, 0.9), (480, 640), K_FULL, "cuda")
    print(f"  hypotheses {n_hyp} (+{len(est.hyp_valid) - n_hyp} pad), "
          f"render faces {len(est.mesh_tensors.faces)}, mask px {int(frame[2].sum())}")
    torch.cuda.synchronize()

    raster_cuda.KERNEL.launches = 0
    attention_cuda.KERNEL.launches = 0
    pose = est.register(K_FULL, *frame, iteration=5)
    counts_reg = (raster_cuda.KERNEL.launches, attention_cuda.KERNEL.launches)
    tracked = [est.track_one(frame[0], frame[1], K_FULL, iteration=2) for _ in range(3)]
    torch.cuda.synchronize()
    counts = {"raster": raster_cuda.KERNEL.launches, "attention": attention_cuda.KERNEL.launches}
    print(f"  register pose t = {pose[:3, 3]}, best hypothesis {est.best_id}")
    print(f"  launches: register {counts_reg}, register + 3 frames "
          f"raster {counts['raster']} attention {counts['attention']}")
    for p in [pose] + tracked:
        if not (p.shape == (4, 4) and np.isfinite(p).all() and abs(p[2, 3] - 0.9) < 0.2):
            raise AssertionError(f"main path pose out of bounds:\n{p}")
    if counts_reg[0] < 6 or counts_reg[1] < 12:
        raise AssertionError(f"register launched too few kernels: {counts_reg}")
    if counts["raster"] - counts_reg[0] < 6 or counts["attention"] - counts_reg[1] < 12:
        raise AssertionError(f"tracking launched too few kernels: {counts}")
    return counts, est, frame, n_hyp


def timing_phase(est, frame, n_hyp):
    import torch

    from foundationpose_torch.geometry.projection import compute_crop_window_tf
    from foundationpose_torch.ops.attention import attention_core_plain
    from foundationpose_torch.ops.attention_cuda import attention_core_cuda
    from foundationpose_torch.ops.raster_cuda import raster_shade
    from foundationpose_torch.ops.rasterizer import _prepare, shade_brute
    from foundationpose_torch.pipeline.crops import make_crop_inputs

    t = {}
    mt = est.mesh_tensors
    res = est.cfg.refiner.input_res
    Kt = torch.as_tensor(K_FULL, device="cuda")
    poses = est.rot_grid.clone()
    poses[:, :3, 3] = torch.tensor([0.02, -0.01, 0.9], device="cuda")
    ctf = compute_crop_window_tf(poses, Kt, 1.2, res, est._diam)
    prep = _prepare(mt.pos, mt.faces, poses, Kt, (res, res), ctf, mt.vertex_color, mt.uv,
                    mt.vnormals, True, False, None, True)
    t["k1_ms"] = _event_ms(lambda: raster_shade(prep, None, 0.8, 0.5), reps=10)
    t["k1_plain_ms"] = _event_ms(lambda: shade_brute(prep, None, 0.8, 0.5), reps=2)
    x = (torch.rand((252, 400, 1536), generator=torch.Generator().manual_seed(4)) * 2 - 1)
    x = x.to("cuda", torch.bfloat16)
    t["k2_ms"] = _event_ms(lambda: attention_core_cuda(x, 4), reps=20)
    t["k2_plain_ms"] = _event_ms(lambda: attention_core_plain(x, 4), reps=20)

    # Stages of one refine iteration at the main path's batch.
    rgb = torch.as_tensor(frame[0], device="cuda").float() / 255.0
    from foundationpose_torch.geometry.projection import depth_to_xyz_map

    xyz = depth_to_xyz_map(torch.as_tensor(frame[1], device="cuda"), Kt)
    rc = est.cfg.refiner

    def crops():
        return make_crop_inputs(mt, poses, Kt, rgb, xyz, est._diam, input_res=res,
                                crop_ratio=rc.crop_ratio, normalize_xyz=rc.normalize_xyz,
                                invalid_z=rc.xyz_invalid_z, raster=rc.raster)

    with torch.inference_mode():
        a, b, _ = crops()
        t["stage_crops_ms"] = _event_ms(crops, reps=5)
        t["stage_refine_fwd_ms"] = _event_ms(lambda: est.refiner(a, b, dtype=torch.bfloat16), reps=5)
        t["stage_score_fwd_ms"] = _event_ms(lambda: est.scorer(a, b, dtype=torch.bfloat16), reps=5)

    reg = []
    est.register(K_FULL, *frame, iteration=5)  # warm-up
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.register(K_FULL, *frame, iteration=5)
        reg.append(time.perf_counter() - t0)
    t["register_ms_median3"] = float(np.median(reg)) * 1e3
    t["register_hyp_per_s"] = n_hyp / float(np.median(reg))
    trk = []
    est.track_one(frame[0], frame[1], K_FULL, iteration=2)  # warm-up
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.track_one(frame[0], frame[1], K_FULL, iteration=2)
        trk.append(time.perf_counter() - t0)
    t["track_ms_median10"] = float(np.median(trk)) * 1e3
    t["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    for k, v in t.items():
        print(f"  {k} = {v:.3f}   [{_CARD}]")
    return t


def main():
    import torch  # noqa: F401  (fails fast without PyTorch)

    phase("environment", 120, env_phase)
    phase("build kernels", 400, build_phase)
    k1_err = phase("K1 tile rasterizer vs brute", 240, k1_phase)
    k2_err = phase("K2 attention vs plain", 120, k2_phase)
    phase("small slice: card vs CPU plain path", 180, small_slice_phase)
    counts, est, frame, n_hyp = phase("main path: register + 3 tracked frames", 300, main_path_phase)
    t = phase("timing", 300, timing_phase, est, frame, n_hyp)

    kernels = [
        {"name": "K1 tile rasterizer", "route": "cuda",
         "source": "foundationpose_torch/csrc/raster.cu",
         "replaces": "foundationpose_tpu/ops/pallas_raster2.py:69",
         "launches": counts["raster"], "max_abs_err": k1_err,
         "ms": t["k1_ms"], "plain_ms": t["k1_plain_ms"]},
        {"name": "K2 attention core", "route": "cuda",
         "source": "foundationpose_torch/csrc/attention.cu",
         "replaces": "foundationpose_tpu/ops/attention.py:44",
         "launches": counts["attention"], "max_abs_err": k2_err,
         "ms": t["k2_ms"], "plain_ms": t["k2_plain_ms"]},
    ]
    print(_CARD)
    print(json.dumps({"kernels": kernels}))
    import torch as _torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": _torch.cuda.get_device_name(0),
        "count": _torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()  # any exception ends the run with a traceback and exit code 1
