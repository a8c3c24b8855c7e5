"""On-card smoke run of foundationpose_torch: build, check, drive, time.

    python3 chip_smoke.py

Needs one CUDA card (sm_90a) and nvcc; imports no JAX. Phases, each
under its own time limit (a phase that fails or runs out ends the run
with a nonzero exit and no result line):

1. environment: versions, nvcc, the card's name and power limit;
2. build the kernels from foundationpose_torch/csrc/ (one nvcc per
   source, all at once; K3 and K4 share segment_add.cu);
3. K1, the tile rasterizer, against the plain brute path at the main
   path's crop shape (16 poses, 160x160, ~5k-face mesh, vertex colors,
   light, culling off and on) and the probes: one pose, object behind
   the camera, tiny object, slivers in front of a plane (their rounded
   edge tests accept pixels far outside their bboxes); masks bit-equal,
   max |d| < 2e-4 on smooth pixels, < 4% of covered pixels off by more
   than 1e-3; K1's face boxes bit-equal to their plain version;
4. K2, the attention core, against its plain version in bf16 (< 2e-3)
   and f32 (< 1e-4) at the main path's shapes and edge shapes (L = 1,
   L = 513, head widths 8, 24, 5 and 100);
5. K3 and K4, the hash-grid backward's segment-adds, against their plain
   versions at the shapes of NerfCfg's defaults (per-row bound 1e-5 of
   the row's sum of |update|: atomics add in another order each run),
   and their times (K3 in turns with its plain version and index_add_)
   on a synthetic stream (random rows, a hot block, drop sentinels);
Phases 6-8 and 10 run unpacked full-frame uploads (`UNPACKED`), as
before the packed, windowed uploads became EstimatorCfg's defaults, so
their records stay comparable; phase 9 runs the defaults.

6. small slices on the card against the CPU plain path: an f32 register
   + track, an f32 funneled register (prune after 1 iteration, keep 8:
   the whole order equal, poses within 1e-4), the scorer tournament
   (36 hypotheses in groups of 8, network scorer: the same rows win,
   scores within 1e-4), and 3 f32 NeRF train steps per grid layout from
   the same parameters and pinned draws ("oct" and "cuda"; "quad" in phase
   16), with the NerfCfg options off and
   with every option on (importance sampling, near-band subset, linear
   truncation annealing, depth, free-space rgb and eikonal losses; every
   aux term present, the eikonal's second-order table term nonzero on
   both devices; the "oct" table gradient with the options on within the
   CPU tests' bf16-tie bound);
7. the model-based main path: the full-width estimator (base_width 64,
   160x160 crops, bf16, random weights from a seed, zeroed delta heads):
   register(iteration=5) over the 252-hypothesis grid and
   3 x track_one(iteration=2), with the kernels' launch counts read
   around that run; then K1 against the brute path at the timed shape
   (the 252 grid poses, 160x160, culling) and its wrapper run under
   torch.cuda.set_sync_debug_mode("error"); then times: each kernel
   against its plain version at the main path's shapes (K1 alone from
   prepared face boxes in turns with its whole wrapper, `k1_wrapper_ms`,
   and the faces it tests per pixel from its own counts; K2 in turns
   with its plain version and
   scaled_dot_product_attention, also at (1, 252) and (1, 400)), register
   wall time, the packed register on its window (the default) in turns
   with this unpacked one (10 each), per-frame track time, stage times,
   and 3 traced registers (device busy time and idle share, the kernels
   and operators that own the device time);
8. estimator completion: reference-style checkpoints (`.pth` + config.yml
   with BatchNorm and the 6d rotation, seeded full-width nets) loaded on
   the card through cli.run_demo.build_estimator, bit-equal and with
   their configs; save_weights -> .npz -> load_weights bit-equal; a .npz
   embedding a reference config; then the funneled register
   (EstimatorCfg.fast_register) at the main path's workload with K1 and
   K2 counted around it, and its time beside the full register's, timed
   in turns;
9. video tracking: the full-width estimator (seeded weights, live delta
   heads) on a 30-frame 640x480 video of the bench mesh rendered by K1:
   (a) pipelined track_one_async fetched in batches of 4 by
   fetch_track_results against sync track_one, bit-equal in packed
   full-frame mode and within TRACK_BOUND windowed; (b) packed windowed
   against unpacked full-frame tracking within TRACK_BOUND; (c) a 0.2 m
   jump that outruns the window: recovered full-frame, the frames in
   flight repaired, bit-equal to full-frame tracking; (d) TrackChain, 16
   frames replayed from a CUDA graph, bit-equal to 16 track_graph_packed
   calls and free of host synchronisation; (e) MultiTracker with 3
   objects against 3 single trackers, full-frame and windowed, within
   TRACK_BOUND; (f) K1 and K2 launched by every path; then per-frame
   times in turns (sync unpacked against pipelined windowed, the chain
   against per-frame calls, MultiTracker against 3 single trackers;
   medians of 10) and traces of tracked frames and a chain;
10. the model-free path: run_neural_object_field (NerfCfg defaults,
   n_step 200, "oct" layout) on 12 rendered views of the bench mesh, the
   mesh held against the bench mesh (extents within 25%, median vertex
   distance < 5 mm, 1024^2 texture), register on the reconstruction,
   then 20 "cuda"-layout steps; launch counts read around that run;
11. K3 on the stream a "cuda"-layout step sends it: the (idx, upd) pair of
   one step captured around the hash-grid backward, its share of distinct
   rows (overall and within chunks of 1024-8192 consecutive updates), the
   reductions K3 issues on it (`k3_reductions`) and the table sectors it
   touches, K3 against its plain version on it, and K3, plain and
   index_add_ timed in turns on it (the kernels line gives K3 these times,
   the synthetic stream's beside them); then
   K1 against the brute path on the reconstruction at 32 register crops,
   its times (train step, extraction, bake, register, peak memory) and a
   traced pass of 10 train steps per layout (device busy time and idle
   share, the kernels and operators that own the device time);
12. the model-free entry points with every option: the 12 views written
   to disk in run_nerf's layout (rgb/, depth/ in uint16 mm, masks/,
   cam_in_ob/, K.txt) and cli.run_nerf.main at the parity preset (200
   steps; the mesh read back from disk meets phase 10's bars); then
   run_neural_object_field with every option on (NERF_OPTIONS) and
   artifacts every 100 steps; then a runner with every option on that
   checkpoints at step 100, is stopped at step 120 and resumed by a fresh
   runner that finishes the run (poses, images and meshes every 100
   steps, the metric sink's scalars finite with every aux term): finite
   losses, K4 twice and K3 (the second-order table term, counted apart)
   once a step; the option runs' mesh distances reported, not gated;
13. K3 on the stream the eikonal's second-order table term sends it in
   one full-width options-on step (captured around
   `ops.hashgrid.corner_table_grad`) against its plain version, timed in
   turns with it and index_add_, with its bound (the kernels line gives
   them as K3's `second_order_*`);
14. options-on against options-off full-width "oct" steps in turns
   (median of 10), an options-on step's peak memory and its trace.

15. the training path: (a) attention_core with a gradient (K2 forward,
   the plain core's recompute backward) against the plain core at
   (64, 400, 512, 4) bf16 and a small f32 shape, and one full-width f32
   RefineNet loss: a finite gradient on every trained tensor (BN
   statistics included), in-projection gradients within 1e-3 of the
   plain core's; (b) 2 refiner and 2 scorer steps at test width in f32,
   cuda against cpu from one init and the same draws, within the bounds
   of tests/test_torch_training.py; (c) the full-width configuration in
   bf16 (RefinerCfg() / ScorerCfg() nets, Adam lr 1e-4, 64 pairs of
   160x160 crops, a 64-hypothesis scorer group on a 640x480 frame, the
   bench mesh): 5 steps of each with their batches made on the card, K1
   twice a batch and K2 twice a step; batch and step times in turns,
   samples per second, peak memory, a traced step of each, and the host
   synchronisations of one batch and step (set_sync_debug_mode("warn"));
   (d) the recipe of tests/test_training.py::TestTrainedNetworkRegistration
   trained on the card (refiner width 8, 64 px, 250 steps; scorer 250
   steps on a fixed scene) on the batches of the port's CPU test (its
   CPU generator's draws) with deterministic cuDNN, then registers on a
   frame at the scene's gt: the scorer's loss drops by more than 0.15
   and the network-scored ADD-S is below 6 cm; the same recipe on the
   card generator's draws from the same seeds is reported, not gated;
16. parallel, quad layout, tooling: (a) FoundationPose over a mesh of 2
   shards of the one card (parallel.make_device_mesh(devices=[cuda:0] * 2))
   against the unsharded estimator at the main path's workload in f32, the
   network scorer spread by `spread_scorer` on the register's crops: the
   same order and poses within 1e-4, full, funneled (fast_register) and
   packed; K1 and K2 counted per sharded register; the full and funneled
   registers timed in turns with the unsharded ones (two shards of one card
   measure the split's overhead, not scaling); (b) 2 refiner and 2 scorer
   steps of (b) above, data-parallel over 2 shards of the card against the
   unsharded steps on the card: losses within 1e-5 relative, parameters by
   param_agreement; 2 f32 steps of (c)'s full-width nets at batch 64 the
   same way (losses within 1e-5, first-step gradients within 1e-3 of the
   largest, parameters reported), then their bf16 data-parallel step timed
   in turns with the unsharded one, with the peak memory of each, K2's
   launches and the time of a replica's copy; (c) 3 "quad" NeRF steps of the small slice, card
   against CPU, options off and on, then K3 on the stream of one full-width
   "quad" step (NerfCfg defaults, 8 planes) against its plain version, timed
   in turns with it and index_add_ (the kernels line gives them as K3's
   `quad_*`); (d) a debug=3 register of the small slice on the card and the
   CPU: the files exist, the canvases agree (rgb panels within 1 level,
   depth panels within one JET step, on all but 1e-3 of the pixels: K1's
   criterion admits edge pixels covered otherwise); (e) warp_perspective and
   warp_perspective_batch, card against CPU; (f) a profiling.trace() of one
   register names K1 and K2, and a stage_timer around another.

Every kernel's bound is computed from this run's inputs (`bound`: the
bytes it must move over the memory rate or its operations over the peak
rate, whichever is larger). Prints a {"kernels": [...]} JSON line, then as
its last line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import logging
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


# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# device memory 3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
# f32 outside them.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def bound(nbytes, ops, kind):
    """The least time the card could take: the larger of the bytes that
    must move (each input read once, each output written once) over the
    memory rate and the operations over the peak rate of their type.
    Returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _wall_in_turns(fns, n):
    """Host-clock time of one call of each fn (the card synchronised
    before and after), taken in the order a, b, b, a, ... until each fn has
    n samples; returns each fn's median in ms."""
    import torch

    order = list(fns) + list(reversed(fns))
    times = {k: [] for k in fns}
    while min(len(v) for v in times.values()) < n:
        for k in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def _in_turns(fns, reps):
    """Times each fn by CUDA events in the order a, b, c, c, b, a (one
    card, one call); returns the mean of its two times per fn."""
    order = list(fns) + list(reversed(fns))
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(_event_ms(fns[k], reps=reps))
    return {k: float(np.mean(v)) for k, v in times.items()}


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
    """One nvcc per source, all started together (K3 and K4 share one)."""
    from concurrent.futures import ThreadPoolExecutor

    from foundationpose_torch.ops import attention_cuda, raster_cuda, segment_add_cuda

    def build(k):
        t0 = time.perf_counter()
        return k.build(), time.perf_counter() - t0

    libs = (raster_cuda.KERNEL, attention_cuda.KERNEL, segment_add_cuda.K3)
    with ThreadPoolExecutor(len(libs)) as pool:
        results = list(pool.map(build, libs))
    for k, (path, sec) in zip(libs, results):
        print(f"built {k.source} -> {path} in {sec:.2f} s")
        for line in k.ptxas_log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                print("   ", line.strip())


def _bench_mesh():
    """bench.py:361-363: icosphere(4) (5120 faces, r = 0.1 m) with a
    sinusoidal radial bump; vertex colors from a seed."""
    from foundationpose_torch.geometry.icosphere import icosphere
    from foundationpose_torch.meshio import TriMesh

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


def _k1_gate(name, ref, out):
    """The K1 criterion on one probe; returns the max |d| over covered pixels."""
    import torch

    torch.cuda.synchronize()
    mism, smooth_max, edge, covered_max = render_criterion(ref, out)
    print(f"  K1 {name}: mask mismatches {mism}, covered {int(ref.mask.sum())}, "
          f"smooth max |d| {smooth_max:.3e}, share > 1e-3 {edge:.5f}, "
          f"covered max |d| {covered_max:.3e}")
    if mism or smooth_max >= 2e-4 or edge >= 0.04:
        raise AssertionError(f"K1 {name} fails the criterion")
    return covered_max


def _k1_boxes(name, prep):
    """K1's face-box kernel against its plain version (raster_cuda._records):
    bit-equal. Prints the faces whose box is widened past half a pixel by
    the sliver bound and those that are unbounded."""
    import torch

    from foundationpose_torch.ops.raster_cuda import _records, kernel_boxes

    fk, ck = kernel_boxes(prep)
    fp, cp = _records(prep)
    torch.cuda.synchronize()
    if not (torch.equal(fk, fp) and torch.equal(ck, cp)):
        bad = int((fk != fp).any(-1).sum())
        raise AssertionError(f"K1 {name}: face boxes differ from the plain version on {bad} faces")
    F = prep.coeffs.shape[1]
    ok = prep.coeffs[..., 9] > 0
    box = fp[:, :F][ok]
    unbounded = int((box[:, 1] >= 1e30).sum())
    pad = (box - prep.bbox[ok]).abs().amax(-1)
    pad = pad[box[:, 1] < 1e30]
    print(f"  K1 {name}: boxes bit-equal to plain; valid faces {int(ok.sum())}, "
          f"widened > 0.5 px {int((pad > 0.5).sum())}, unbounded {unbounded}, "
          f"largest pad {float(pad.max()) if pad.numel() else 0.0:.3e} px")


def _k1_prepared(name, prep, tex=None):
    """raster_shade against shade_brute on one prepared batch, and the boxes."""
    from foundationpose_torch.ops.raster_cuda import raster_shade
    from foundationpose_torch.ops.rasterizer import RenderOutput, shade_brute

    out = RenderOutput(*raster_shade(prep, tex, 0.8, 0.5))
    ref = RenderOutput(*shade_brute(prep, tex, 0.8, 0.5))
    err = _k1_gate(name, ref, out)
    _k1_boxes(name, prep)
    return err


# Slivers whose rounded edge test accepts pixels 7-47 px outside their
# bbox in a 160x160 frame (found by a seeded search like the sweep of
# tests/test_torch_raster.py, which also checks them), and last a sliver
# whose vertices were recorded to three decimals (so rounded, it no
# longer escapes).
ESCAPERS = [
    [[99.1486587524414, 78.82369995117188], [123.34191131591797, 86.75849151611328], [102.77344512939453, 80.01254272460938]],
    [[95.58267974853516, 61.46034240722656], [50.609127044677734, 111.71696472167969], [69.16873168945312, 90.9771499633789]],
    [[29.812515258789062, 71.01371765136719], [20.24817657470703, 131.93894958496094], [23.83448600769043, 109.09400939941406]],
    [[155.26461791992188, 109.67045593261719], [159.01321411132812, 101.51575469970703], [158.99005126953125, 101.56616973876953]],
    [[123.79788208007812, 123.70269775390625], [155.23565673828125, 35.334049224853516], [151.65969848632812, 45.3857307434082]],
    [[135.51797485351562, 110.35066986083984], [155.1244354248047, 50.99928665161133], [145.00608825683594, 81.62884521484375]],
    [[141.71031188964844, 104.97235107421875], [25.474990844726562, 146.6495819091797], [103.12737274169922, 118.80668640136719]],
    [[46.31814193725586, 36.059940338134766], [87.65369415283203, 91.79170227050781], [62.2302360534668, 57.51384735107422]],
    [[96.55662536621094, 137.51416015625], [12.705251693725586, 122.51629638671875], [44.2486457824707, 128.15823364257812]],
    [[95.58979797363281, 111.78732299804688], [149.62335205078125, 145.29025268554688], [102.18024444580078, 115.8736572265625]],
    [[31.467, 98.069], [137.861, 105.520], [109.494, 103.533]],
]


def sliver_scene():
    """ESCAPERS at z = 1 in front of a plane at z = 2 that fills a 160x160
    frame: with K = I and the identity pose the screen coordinates are
    exactly the listed ones. Returns (verts (V, 3), faces (F, 3))."""
    tri = np.float32(ESCAPERS)
    sl = np.concatenate([tri.reshape(-1, 2), np.ones((tri.size // 2, 1), np.float32)], -1)
    corners = np.float32([[-8, -8], [168, -8], [168, 168], [-8, 168]]) * 2
    plane = np.concatenate([corners, np.full((4, 1), 2.0, np.float32)], -1)
    n = len(sl)
    faces = np.concatenate([np.arange(n).reshape(-1, 3), n + np.array([[0, 1, 2], [0, 2, 3]])])
    return np.concatenate([sl, plane]).astype(np.float32), faces.astype(np.int64)


def k1_phase():
    import torch

    from foundationpose_torch.geometry.icosphere import sample_views_icosphere
    from foundationpose_torch.geometry.projection import compute_crop_window_tf
    from foundationpose_torch.ops.rasterizer import _prepare, render_mesh, render_mesh_brute
    from foundationpose_torch.meshio import compute_mesh_diameter

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

    def check(name, P, crop=True, pos=pos, faces=faces, K=None, **extra):
        Pt = T(P)
        K = K if K is not None else (Kt if crop else K_probe)
        kw = dict(out_hw=(160, 160), vertex_color=colors, vnormals=vn, use_light=True)
        if crop:
            kw["crop_tf"] = compute_crop_window_tf(Pt, Kt, 1.2, 160, diam)
        kw.update(extra)
        err = _k1_gate(name, render_mesh_brute(pos, faces, Pt, K, **kw), render_mesh(pos, faces, Pt, K, **kw))
        _k1_boxes(name, _prepare(
            pos, faces, Pt, K, kw["out_hw"], kw.get("crop_tf"), kw["vertex_color"], kw.get("uv"),
            kw["vnormals"], kw["use_light"], kw.get("get_normal", False), None,
            kw.get("cull_backfaces", False)))
        return err

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
    # Slivers in front of a plane: the brute path covers pixels far outside
    # their bboxes, which K1's widened boxes must hold.
    sv, sf = sliver_scene()
    err = max(err, check("slivers + plane", np.eye(4, dtype=np.float32)[None], crop=False,
                         pos=T(sv), faces=torch.as_tensor(sf, device=dev), K=T(np.eye(3)),
                         vertex_color=T(np.random.default_rng(3).uniform(0.1, 1, (len(sv), 3))),
                         vnormals=T(np.tile([0.0, 0.0, -1.0], (len(sv), 1)))))
    return err


ATTN_SHAPES = [
    (252, 400, 512, 4), (1, 252, 512, 4), (1, 400, 512, 4),  # the main path's shapes
    (2, 20, 256, 2),
    (2, 1, 512, 4), (2, 513, 512, 4),  # L = 1; ragged L past 8 key tiles
    (1, 64, 512, 4),  # the funneled register's scorer: 64 hypotheses
    (3, 9, 24, 3), (2, 77, 48, 2),  # dh = 8, 24: not multiples of 16
    (2, 50, 20, 4), (1, 130, 200, 2),  # dh = 5, 100: element loads, padded head
]


def k2_phase():
    """Returns the largest bf16 error over ATTN_SHAPES; prints the one at
    the main shape (the first)."""
    import torch

    from foundationpose_torch.ops.attention import attention_core_plain
    from foundationpose_torch.ops.attention_cuda import attention_core_cuda

    err = {}
    for dtype, tol in ((torch.bfloat16, 2e-3), (torch.float32, 1e-4)):
        for B, L, D, H in ATTN_SHAPES:
            g = torch.Generator().manual_seed(3)
            x = ((torch.rand((B, L, 3 * D), generator=g) * 2 - 1)).to("cuda", dtype)
            d = (attention_core_cuda(x, H).float() - attention_core_plain(x, H).float())
            torch.cuda.synchronize()
            e = float(d.abs().max())
            print(f"  K2 {str(dtype)[6:]} B={B} L={L} D={D} H={H}: max |d| {e:.3e} (< {tol}), "
                  f"share of outputs not equal to plain {float((d != 0).float().mean()):.2e}")
            if not e < tol:
                raise AssertionError("K2 disagrees with its plain version")
            if dtype == torch.bfloat16:
                err[(B, L, D, H)] = e
    print(f"  K2 bf16 at the main shape {ATTN_SHAPES[0]}: max |d| {err[ATTN_SHAPES[0]]:.3e}")
    return max(err.values())


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


K_SMALL = np.array([[140.0, 0, 80.0], [0, 140.0, 60.0], [0, 0, 1.0]], np.float32)
# The upload mode of the phases that predate the packed, windowed uploads
# (EstimatorCfg's defaults since they were ported): full frames, rgb and f32
# depth uploaded apart, so their records stay comparable.
UNPACKED = dict(register_pack=False, register_roi=False, track_pack=False, track_roi=False)


def _box():
    """tests/test_pipeline.py::colored_box: 0.12 x 0.16 x 0.2 m, seeded
    vertex colors."""
    from foundationpose_torch.meshio import make_box

    box = make_box(np.array([0.12, 0.16, 0.2]))
    box.vertex_colors = np.random.default_rng(0).integers(40, 255, (8, 3)).astype(np.uint8)
    return box


def _small_cfg():
    """The test-width f32 estimator config (depth scorer, UNPACKED uploads)."""
    from foundationpose_torch.models import RefineNetCfg, ScoreNetCfg
    from foundationpose_torch.pipeline import EstimatorCfg, RefinerCfg, ScorerCfg

    return EstimatorCfg(
        refiner=RefinerCfg(net=RefineNetCfg(base_width=4), input_res=32, compute_dtype="float32"),
        scorer=ScorerCfg(net=ScoreNetCfg(base_width=4), input_res=32, mode="depth",
                         compute_dtype="float32"),
        min_n_views=4, inplane_step_deg=120.0, **UNPACKED,
    )


def _small_scene():
    """The test-width scene: a colored box at (0.01, -0.02, 0.85), 160x120,
    rendered on the CPU, and `_small_cfg()`."""
    box = _box()
    return box, _small_cfg(), _frame(box, (0.01, -0.02, 0.85), (120, 160), K_SMALL, "cpu")


def funnel_slice(device):
    """An f32 funneled register (prune after 1 of 2 iterations, keep 8) on
    the small scene: (order, pose, refined poses, scores) as numpy."""
    import dataclasses

    box, cfg, frame = _small_scene()
    cfg = dataclasses.replace(cfg, prune_after_iter=1, prune_keep=8)
    est = _estimator(box, cfg, device, head_scale=0.05)
    pose = est.register(K_SMALL, *frame, iteration=2)
    return est.order.cpu().numpy(), pose, est.poses.cpu().numpy(), est.scores.cpu().numpy()


def spread_scorer(net, a, b, scale=300.0, gain=100.0):
    """Reshape a ScoreNetMultiPair in place so its logits on the crops
    (a, b) spread far beyond rounding.

    A random narrow ScoreNet gives every hypothesis nearly the same logit
    (spread ~1e-6): its cross-hypothesis attention averages features that
    differ by ~2%. Here that attention is made diagonal on these
    hypotheses (query and key = scale x the feature minus the features'
    mean, values centered the same way) and the last layer is scaled by
    `gain`, so each logit follows its own hypothesis's features (gaps of
    ~1e-3 and more)."""
    import torch

    from foundationpose_torch.models.networks import _tokens

    with torch.no_grad():
        tok = _tokens(net.encoderA, net.encoderAB, a, b, net.cfg.embed_dim, torch.float32)
        mu = net.att(tok, torch.float32).mean(dim=1).mean(dim=0)
        d = mu.shape[0]
        w, bias = net.att_cross.in_proj_weight, net.att_cross.in_proj_bias
        eye = torch.eye(d, dtype=w.dtype, device=w.device) * scale
        w[:d], w[d:2 * d] = eye, eye
        bias[:d], bias[d:2 * d] = -scale * mu, -scale * mu
        bias[2 * d:] -= w[2 * d:] @ mu
        net.linear.weight.mul_(gain)
        net.linear.bias.mul_(gain)
    return net


def tournament_slice(devices, n=36, group_size=8):
    """score_poses_tournament over n seeded hypotheses of the small scene,
    network scorer (test width, f32, spread by `spread_scorer`), on each
    device from the same weights: {device: scores as numpy}."""
    import copy
    import dataclasses

    import torch

    from foundationpose_torch.geometry.projection import depth_to_xyz_map
    from foundationpose_torch.geometry.rotations import so3_exp_map
    from foundationpose_torch.models import init_score_net
    from foundationpose_torch.pipeline import make_crop_inputs, make_mesh_tensors
    from foundationpose_torch.pipeline.scorer import score_poses_tournament

    box, cfg, (rgb, depth, _mask) = _small_scene()
    scfg = dataclasses.replace(cfg.scorer, mode="network")
    rng = np.random.default_rng(4)
    P = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    P[:, :3, :3] = so3_exp_map(torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)).numpy()
    P[:, :3, 3] = [0.012, -0.018, 0.86] + rng.normal(scale=0.01, size=(n, 3))
    valid = np.ones(n, bool)
    valid[5] = False
    K = torch.as_tensor(K_SMALL)
    rgb_t = torch.as_tensor(rgb).float() / 255.0
    xyz = depth_to_xyz_map(torch.as_tensor(depth), K)
    net = init_score_net(scfg.net, torch.Generator().manual_seed(1))
    a, b, _ = make_crop_inputs(make_mesh_tensors(box), torch.as_tensor(P), K, rgb_t, xyz, 0.25,
                               input_res=scfg.input_res, crop_ratio=scfg.crop_ratio,
                               normalize_xyz=scfg.normalize_xyz, invalid_z=scfg.xyz_invalid_z)
    spread_scorer(net, a, b)
    out = {}
    for dev in devices:
        T = lambda x: x.to(dev)  # noqa: E731
        out[dev] = score_poses_tournament(
            copy.deepcopy(net).to(dev), scfg, make_mesh_tensors(box, device=dev),
            T(torch.as_tensor(P)), T(K), T(rgb_t), T(xyz), 0.25,
            valid=T(torch.as_tensor(valid)), group_size=group_size).cpu().numpy()
    return out


def small_slice_phase():
    """f32 slices at test width on the card vs the CPU plain path: register
    + track (same winner, poses within 1e-4), the funneled register (the
    whole order equal, poses within 1e-4), the tournament (the same rows
    win, scores within 1e-4). Mode: UNPACKED uploads."""
    box, cfg, frame = _small_scene()
    print("  mode: unpacked full-frame uploads (register_pack, register_roi, track_pack, track_roi off)")
    res = {}
    for dev in ("cpu", "cuda"):
        est = _estimator(box, cfg, dev, head_scale=0.05)
        reg = est.register(K_SMALL, *frame, iteration=2)
        trk = est.track_one(frame[0], frame[1], K_SMALL, iteration=2)
        res[dev] = (est.best_id, reg, trk)
    d_reg = float(np.abs(res["cpu"][1] - res["cuda"][1]).max())
    d_trk = float(np.abs(res["cpu"][2] - res["cuda"][2]).max())
    print(f"  small slice: winner cpu {res['cpu'][0]} cuda {res['cuda'][0]}, "
          f"register max |d| {d_reg:.2e}, track max |d| {d_trk:.2e}")
    if res["cpu"][0] != res["cuda"][0] or not (d_reg < 1e-4 and d_trk < 1e-4):
        raise AssertionError("the slice on the card disagrees with the CPU plain path")

    fc, fg = funnel_slice("cpu"), funnel_slice("cuda")
    d_pose = float(np.abs(fc[1] - fg[1]).max())
    d_all = float(np.abs(fc[2] - fg[2]).max())
    print(f"  funneled slice: {len(fc[0])} hypotheses, order equal {bool((fc[0] == fg[0]).all())}, "
          f"survivors {int((fc[3] > 1e4).sum())}, pose max |d| {d_pose:.2e}, "
          f"all poses max |d| {d_all:.2e}")
    if not ((fc[0] == fg[0]).all() and d_pose < 1e-4 and d_all < 1e-4):
        raise AssertionError("the funneled register on the card disagrees with the CPU plain path")

    tr = tournament_slice(("cpu", "cuda"))
    fin = np.isfinite(tr["cpu"])
    d_s = float(np.abs(tr["cpu"][fin] - tr["cuda"][fin]).max())
    won = {dev: np.flatnonzero(s > 50).tolist() for dev, s in tr.items()}
    print(f"  tournament (36 in groups of 8): final-round rows cpu {won['cpu']} cuda "
          f"{won['cuda']}, winner {int(np.argmax(tr['cpu']))} / {int(np.argmax(tr['cuda']))}, "
          f"scores max |d| {d_s:.2e}")
    if not (won["cpu"] == won["cuda"] and np.argmax(tr["cpu"]) == np.argmax(tr["cuda"])
            and (np.isfinite(tr["cuda"]) == fin).all() and d_s < 1e-4):
        raise AssertionError("the tournament on the card disagrees with the CPU plain path")


def main_path_phase():
    """Full-width register + 3 tracked frames, UNPACKED uploads; returns
    the launch counts of that run and the estimator + frame for timing."""
    import torch

    from foundationpose_torch.ops import attention_cuda, raster_cuda
    from foundationpose_torch.pipeline import EstimatorCfg, RasterCfg, RefinerCfg, ScorerCfg

    mesh = _bench_mesh()
    raster = RasterCfg(cull_backfaces=True)  # closed, outward-wound mesh: exact
    cfg = EstimatorCfg(
        refiner=RefinerCfg(raster=raster), scorer=ScorerCfg(mode="network", raster=raster),
        **UNPACKED,
    )
    est = _estimator(mesh, cfg, "cuda")
    print("  mode: unpacked full-frame uploads (register_pack, register_roi, track_pack, track_roi off)")
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
    from foundationpose_torch.ops import raster_cuda
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
    t["k1_err_timed_shape"] = _k1_prepared(f"timed shape ({len(poses)} grid poses, {res}x{res}, cull)", prep)
    # No host synchronisation inside a render of checked mesh tensors.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        raster_cuda.raster_shade(prep, None, 0.8, 0.5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  K1 raster_shade ran under torch.cuda.set_sync_debug_mode('error'): no synchronisation")
    # K1 alone (raster_kernel from prepared face boxes) in turns with the
    # whole wrapper (box kernel + raster_kernel + allocations; before the
    # redesign k1_ms timed that wrapper with its record prep and a sync).
    boxes = raster_cuda.kernel_boxes(prep)
    t.update(_in_turns({
        "k1_ms": lambda: raster_cuda.kernel_shade(prep, boxes, None, 0.8, 0.5),
        "k1_wrapper_ms": lambda: raster_cuda.raster_shade(prep, None, 0.8, 0.5),
        "k1_boxes_ms": lambda: raster_cuda.kernel_boxes(prep),
    }, reps=20))
    t["k1_plain_ms"] = _event_ms(lambda: shade_brute(prep, None, 0.8, 0.5), reps=2)
    # Work per pixel from the kernel's own counts (one launch).
    stats = torch.zeros(3, dtype=torch.int64, device="cuda")
    raster_cuda.kernel_shade(prep, boxes, None, 0.8, 0.5, stats=stats)
    n_tile, n_patch, n_round = stats.tolist()
    n_tiles = len(poses) * (-(-res // raster_cuda.TILE)) ** 2
    t["k1_tile_list_per_tile"] = n_tile / n_tiles
    t["k1_faces_tested_per_pixel"] = n_patch / (n_tiles * raster_cuda.TILE**2 // 32)
    t["k1_rounds_per_tile"] = n_round / n_tiles
    # K1's bound: its inputs (edge coefficients, inverse depths, faces,
    # vertex data) read once, color, xyz and mask written once; operations:
    # each covered pixel's three edge functions and one multiply-add per
    # value it writes (f32).
    color, xyz, normal, mask = raster_cuda.raster_shade(prep, None, 0.8, 0.5)
    covered = int(mask.sum())
    n_out = color.shape[-1] + xyz.shape[-1] + (normal.shape[-1] if normal is not None else 0)
    t["k1_bound_ms"], t["k1_bound_by"] = bound(
        _nbytes(prep.coeffs, prep.zinv, prep.faces, prep.vdata, color, xyz, normal, mask),
        2 * covered * (3 + n_out), "f32")
    t["k1_library_ms"] = None  # no one PyTorch call rasterizes

    # K2 at the main path's shapes: the kernel, its plain version and one
    # PyTorch call of the same function (scaled_dot_product_attention on
    # (B, H, L, dh) views of the same packed qkv; a yardstick only, which
    # the port never calls), timed in turns.
    for B, L, reps in ((252, 400, 10), (1, 252, 50), (1, 400, 50)):
        x = (torch.rand((B, L, 1536), generator=torch.Generator().manual_seed(4)) * 2 - 1)
        x = x.to("cuda", torch.bfloat16)
        q, k, v = (a.view(B, L, 4, 128).transpose(1, 2) for a in x.split(512, dim=-1))
        key = "k2" if B == 252 else f"k2_b{B}_l{L}"
        t.update(_in_turns({
            f"{key}_ms": lambda: attention_core_cuda(x, 4),
            f"{key}_plain_ms": lambda: attention_core_plain(x, 4),
            f"{key}_library_ms": lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v),
        }, reps))
        t[f"{key}_bound_ms"], t[f"{key}_bound_by"] = bound(
            _nbytes(x) + B * L * 512 * x.element_size(), 4 * B * 4 * L * L * 128, "bf16")

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
    # The packed register on a detection-sized window (EstimatorCfg's
    # defaults) in turns with this unpacked full-frame one.
    packed = _tracker(est, **PACKED)
    roi = packed._register_roi_window(K_FULL, frame[1], frame[2])
    p_unpacked = est.register(K_FULL, *frame, iteration=5)
    p_packed = packed.register(K_FULL, *frame, iteration=5)
    print(f"  packed register: window {roi} of {frame[1].shape}, recoveries "
          f"{packed.register_roi_recoveries}, best hypothesis {packed.best_id} (unpacked "
          f"{est.best_id}), |dt| {np.abs(p_packed[:3, 3] - p_unpacked[:3, 3]).max() * 1e3:.4f} mm")
    if roi is None or packed.register_roi_recoveries:
        raise AssertionError("the packed register did not run on its window")
    t.update({f"register_{k}_ms_in_turns_median10": v for k, v in _wall_in_turns({
        "unpacked": lambda: est.register(K_FULL, *frame, iteration=5),
        "packed_roi": lambda: packed.register(K_FULL, *frame, iteration=5),
    }, 10).items()})
    t["register_window_px"] = roi[2]
    del packed
    trk = []
    est.track_one(frame[0], frame[1], K_FULL, iteration=2)  # warm-up
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.track_one(frame[0], frame[1], K_FULL, iteration=2)
        trk.append(time.perf_counter() - t0)
    t["track_ms_median10"] = float(np.median(trk)) * 1e3
    t["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t.update(_profile("register", lambda: est.register(K_FULL, *frame, iteration=5), 3))
    _print_times(t)
    return t


def _reference_checkpoints(root):
    """Reference-style run directories under `root` from seeded
    full-width port nets: model_best.pth ({"model": {"module." + name}})
    and config.yml, a non-default refiner (BatchNorm, 6d rotation, zfar
    2 m). Returns {kind: (pth path, source state_dict, config dict)}."""
    import os

    import torch
    import yaml

    from foundationpose_torch.models import (
        RefineNetCfg, ScoreNetCfg, init_refine_net, init_score_net)

    common = {"c_in": 6, "use_BN": True, "normalize_xyz": True, "crop_ratio": 1.2,
              "input_resize": [160, 160]}
    nets = {
        "refiner": (init_refine_net(RefineNetCfg(rot_rep="6d"), torch.Generator().manual_seed(5)),
                    dict(common, rot_rep="6d", trans_rep="tracknet", zfar=2.0,
                         trans_normalizer=[0.02, 0.02, 0.05], rot_normalizer=0.34906585)),
        "scorer": (init_score_net(ScoreNetCfg(), torch.Generator().manual_seed(6)), dict(common)),
    }
    out = {}
    g = torch.Generator().manual_seed(7)
    for kind, (net, cfg_yaml) in nets.items():
        with torch.no_grad():  # BatchNorm statistics that are not the defaults
            for name, buf in net.named_buffers():
                if name.endswith("running_mean"):
                    buf.copy_(torch.randn(buf.shape, generator=g) * 0.1)
                elif name.endswith("running_var"):
                    buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
        run = os.path.join(root, kind)
        os.makedirs(run)
        sd = net.state_dict()
        torch.save({"model": {f"module.{k}": v for k, v in sd.items()}},
                   os.path.join(run, "model_best.pth"))
        with open(os.path.join(run, "config.yml"), "w") as f:
            yaml.safe_dump(cfg_yaml, f)
        out[kind] = (os.path.join(run, "model_best.pth"), sd, cfg_yaml)
    return out


def _bit_equal(name, net, sd):
    import torch

    got = net.state_dict()
    same = set(got) == set(sd) and all(torch.equal(got[k].cpu(), v.cpu()) for k, v in sd.items())
    print(f"  {name}: {len(sd)} tensors, bit-equal {same}")
    if not same:
        raise AssertionError(f"{name}: the weights on the card differ from their source")


def checkpoint_check(mesh, device):
    """Reference-style checkpoints through the user entry points on
    `device`: a .pth + config.yml per net via cli.run_demo.build_estimator
    (configs read back, weights bit-equal), save_weights -> .npz ->
    build_estimator (bit-equal, same configs), and a .npz embedding the
    reference config via load_weights."""
    import argparse
    import os
    import tempfile

    from foundationpose_torch.cli.run_demo import build_estimator
    from foundationpose_torch.models.convert import params_to_jax
    from foundationpose_torch.utils.checkpoint import save_params

    def build(refiner, scorer):
        return build_estimator(mesh, argparse.Namespace(
            refiner_ckpt=refiner, scorer_ckpt=scorer, fast_register=False, device=device))

    with tempfile.TemporaryDirectory() as root:
        ck = _reference_checkpoints(root)
        loaded = build(ck["refiner"][0], ck["scorer"][0])
        c = loaded.cfg
        print(f"  .pth + config.yml via build_estimator: refiner rot_rep {c.refiner.rot_rep} "
              f"(net {c.refiner.net.rot_rep}), use_bn {c.refiner.net.use_bn}/{c.scorer.net.use_bn}, "
              f"zfar {c.zfar}, scorer mode {c.scorer.mode}, device {loaded.device}")
        if not (c.refiner.rot_rep == c.refiner.net.rot_rep == "6d" and c.refiner.net.use_bn
                and c.scorer.net.use_bn and c.zfar == 2.0 and c.scorer.mode == "network"
                and loaded.has_refiner and loaded.device.type == device):
            raise AssertionError("the reference configs did not reach the estimator")
        _bit_equal(".pth refiner", loaded.refiner, ck["refiner"][1])
        _bit_equal(".pth scorer", loaded.scorer, ck["scorer"][1])

        rp, sp = os.path.join(root, "refiner.npz"), os.path.join(root, "scorer.npz")
        loaded.save_weights(rp, sp)
        again = build(rp, sp)
        if (again.cfg.refiner, again.cfg.scorer) != (c.refiner, c.scorer):
            raise AssertionError("save_weights -> load_weights changed the configuration")
        _bit_equal("save_weights .npz refiner", again.refiner, ck["refiner"][1])
        _bit_equal("save_weights .npz scorer", again.scorer, ck["scorer"][1])

        conv = os.path.join(root, "converted_refiner.npz")
        save_params(conv, params_to_jax(ck["refiner"][1]),
                    meta={"reference_config": ck["refiner"][2]})
        again.load_weights(refiner_path=conv)
        if again.cfg.refiner != c.refiner or again.cfg.zfar != 2.0:
            raise AssertionError("the embedded reference config did not load")
        _bit_equal("reference_config .npz refiner", again.refiner, ck["refiner"][1])


def completion_phase(est, frame):
    """Checkpoints through the user entry points on the card, then the
    funneled register at the main path's workload: its gates, its K1/K2
    launches and its time beside the full register's (`est`), in turns."""
    import torch

    from foundationpose_torch.ops import attention_cuda, raster_cuda

    mesh = est.mesh_ori
    checkpoint_check(mesh, "cuda")
    funnel = _estimator(mesh, est.cfg.fast_register(), "cuda")
    print("  mode: unpacked full-frame uploads, as the main path's estimator")
    n_hyp = int(funnel.hyp_valid.sum())
    torch.cuda.synchronize()
    raster_cuda.KERNEL.launches = 0
    attention_cuda.KERNEL.launches = 0
    pose = funnel.register(K_FULL, *frame, iteration=5)
    torch.cuda.synchronize()
    counts = {"raster": raster_cuda.KERNEL.launches, "attention": attention_cuda.KERNEL.launches}
    order = funnel.order.cpu().numpy()
    scores = funnel.scores.cpu().numpy()
    print(f"  funneled register: pose t = {pose[:3, 3]}, best hypothesis {funnel.best_id}, "
          f"launches raster {counts['raster']} attention {counts['attention']} "
          f"(full register: 6 and 12)")
    print(f"  funneled scores: first 64 in [{scores[63]:.10g}, {scores[0]:.10g}], "
          f"65th {scores[64]:.6g}, distinct order entries {len(set(order.tolist()))}")
    if not (pose.shape == (4, 4) and np.isfinite(pose).all() and abs(pose[2, 3] - 0.9) < 0.2):
        raise AssertionError(f"funneled register pose out of bounds:\n{pose}")
    if not ((scores[:64] > 1e4).all() and (np.diff(scores[:64]) <= 0).all()
            and len(set(order.tolist())) == len(order) == len(funnel.hyp_valid)):
        raise AssertionError("the funneled register's order or scores are malformed")
    if (counts["raster"], counts["attention"]) != (7, 12):
        raise AssertionError(f"the funneled register launched {counts}, not K1 7 and K2 12")

    regs = {"full": est, "funneled": funnel}
    times = {k: [] for k in regs}
    for e in regs.values():  # warm-up
        e.register(K_FULL, *frame, iteration=5)
    for name in ("full", "funneled", "funneled", "full"):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            regs[name].register(K_FULL, *frame, iteration=5)
            times[name].append((time.perf_counter() - t0) * 1e3)
    t = {"register_ms_in_turns_median6": float(np.median(times["full"])),
         "register_funneled_ms": float(np.median(times["funneled"])),
         "register_funneled_hyp_per_s": n_hyp / float(np.median(times["funneled"])) * 1e3,
         "funneled_k1_launches": counts["raster"], "funneled_k2_launches": counts["attention"]}
    t.update(_profile("register_funneled", lambda: funnel.register(K_FULL, *frame, iteration=5), 3))
    _print_times(t)
    return counts, t


# --------------------------------------------------------- video tracking

PACKED = dict(register_pack=True, register_roi=True, track_pack=True, track_roi=True)
VIDEO_FRAMES = 30
CHAIN_K = 16
# Bound on two tracking runs that differ by rounding only (packed against
# unpacked uploads: 0.125 mm depth quantization; a window's shifted
# principal point; one batched forward against M): the JAX package's own
# test bound of 1e-3 on pose entries, as translation and rotation angle.
TRACK_BOUND_MM, TRACK_BOUND_DEG = 1.0, 0.1


def _tracker(est, **cfg):
    """Another estimator over est's mesh and nets (shared modules) with
    config fields replaced, starting from est's tracking state."""
    import dataclasses

    from foundationpose_torch.pipeline import FoundationPose

    t = FoundationPose(mesh=est.mesh_ori, cfg=dataclasses.replace(est.cfg, **cfg),
                       refiner_params=est.refiner, scorer_params=est.scorer, device=est.device)
    if est.pose_last is not None:
        _set_state(t, (est.pose_last.clone(), est._pose_hint.copy()))
    return t


def _set_state(e, state):
    """Put a tracker at (device pose, host hint) with a fresh chain."""
    e.pose_last = state[0].clone()
    e._pose_hint = state[1].copy()
    e._chain_repair = None


def _video_poses(n, start=(0.02, -0.01, 0.9), step=(0.003, 0.001, -0.002), deg=0.3):
    """A pose a frame: translation moving by `step` (m) and the object
    turning `deg` degrees a frame about its y axis."""
    P = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = np.deg2rad(deg * i)
        P[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        P[i, :3, 3] = np.asarray(start) + i * np.asarray(step)
    return P


def _render_video(meshes, poses, hw=(480, 640)):
    """Frames of the meshes at poses[m][i], z-merged, rendered by K1 on the
    card (one batch of frames per mesh): [(rgb u8, depth f32, mask u8)]."""
    import torch

    from foundationpose_torch.ops.rasterizer import render_mesh

    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    rgb = depth = mask = None
    for mesh, P in zip(meshes, poses):
        out = render_mesh(T(mesh.vertices), torch.as_tensor(mesh.faces, device="cuda"), T(P),
                          T(K_FULL), out_hw=hw, vertex_color=T(mesh.vertex_colors / 255.0),
                          vnormals=T(mesh.vertex_normals))
        d = torch.where(out.mask, out.depth, torch.full_like(out.depth, float("inf")))
        if depth is None:
            rgb, depth, mask = out.color, d, out.mask
        else:
            closer = d < depth
            rgb = torch.where(closer[..., None], out.color, rgb)
            depth, mask = torch.minimum(depth, d), mask | out.mask
    depth = torch.where(torch.isinf(depth), torch.zeros_like(depth), depth)
    rgb = (rgb.cpu().numpy() * 255).astype(np.uint8)
    return [(rgb[i], depth[i].cpu().numpy().astype(np.float32), mask[i].cpu().numpy().astype(np.uint8))
            for i in range(len(poses[0]))]


def _live_heads(est, frame, pose, target=0.01):
    """Scale the refiner's delta heads so that its largest output on the
    crop of `pose` in `frame` is `target` (about 1 mm and 0.2 degrees an
    iteration): live, non-zero deltas, so a tracking path that reads the
    wrong frame or pose moves the poses, without the random net throwing
    the object out of view in 30 frames."""
    import torch

    from foundationpose_torch.geometry.projection import depth_to_xyz_map
    from foundationpose_torch.pipeline.crops import make_crop_inputs

    rc = est.cfg.refiner
    Kt = torch.as_tensor(K_FULL, device="cuda")
    rgb = torch.as_tensor(frame[0], device="cuda").float() / 255.0
    xyz = depth_to_xyz_map(torch.as_tensor(frame[1], device="cuda"), Kt)
    P = torch.as_tensor(pose, dtype=torch.float32, device="cuda")[None]
    with torch.inference_mode():
        a, b, _ = make_crop_inputs(est.mesh_tensors, P, Kt, rgb, xyz, est._diam,
                                   input_res=rc.input_res, crop_ratio=rc.crop_ratio,
                                   normalize_xyz=rc.normalize_xyz, invalid_z=rc.xyz_invalid_z,
                                   raster=rc.raster)
        out = est.refiner(a, b, dtype=torch.bfloat16)
    with torch.no_grad():
        for head, key in ((est.refiner.trans_head, "trans"), (est.refiner.rot_head, "rot")):
            s = target / float(out[key].abs().max())
            head[1].weight.mul_(s)
            head[1].bias.mul_(s)


def _pose_gap(a, b):
    """(max |dt| in mm, max rotation angle in degrees) between pose lists."""
    a, b = np.asarray(a), np.asarray(b)
    dt = float(np.abs(a[..., :3, 3] - b[..., :3, 3]).max()) * 1e3
    # |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2): exact for small angles,
    # where the arccos of the trace rounds to 0
    chord = np.linalg.norm(a[..., :3, :3] - b[..., :3, :3], axis=(-2, -1)) / (2 * np.sqrt(2))
    return dt, float(np.degrees(2 * np.arcsin(np.clip(chord, 0, 1))).max())


def _check_gap(name, a, b):
    dt, deg = _pose_gap(a, b)
    print(f"  {name}: max |dt| {dt:.5f} mm, max angle {deg:.5f} deg "
          f"(bound {TRACK_BOUND_MM} mm, {TRACK_BOUND_DEG} deg)")
    if not (dt <= TRACK_BOUND_MM and deg <= TRACK_BOUND_DEG):
        raise AssertionError(f"{name}: the two runs differ beyond the bound")
    return dt, deg


def _sync_pass(e, frames):
    return [e.track_one(r, d, K_FULL, iteration=2) for r, d, _m in frames]


def _pipelined_pass(e, frames, batch=4, depth=8):
    """track_one_async with up to `depth` frames in flight, fetched in
    batches of `batch` by fetch_track_results (as cli/run_demo.py)."""
    from collections import deque

    from foundationpose_torch.pipeline import fetch_track_results

    pending, out = deque(), []
    for r, d, _m in frames:
        pending.append(e.track_one_async(r, d, K_FULL, iteration=2))
        if len(pending) >= depth:
            out += fetch_track_results([pending.popleft() for _ in range(batch)])
    while pending:
        out += fetch_track_results([pending.popleft() for _ in range(min(batch, len(pending)))])
    return out


class _Counts:
    """K1 / K2 launches of each path of a phase, the counters set to 0
    before each and read after it."""

    def __init__(self):
        self.paths = {}

    def run(self, name, fn, *args):
        import torch

        from foundationpose_torch.ops import attention_cuda, raster_cuda

        torch.cuda.synchronize()
        raster_cuda.KERNEL.launches = attention_cuda.KERNEL.launches = 0
        out = fn(*args)
        torch.cuda.synchronize()
        k = (raster_cuda.KERNEL.launches, attention_cuda.KERNEL.launches)
        self.paths[name] = k
        print(f"  launches {name}: K1 {k[0]} K2 {k[1]}")
        if not (k[0] > 0 and k[1] > 0):
            raise AssertionError(f"{name} did not launch K1 and K2")
        return out

    def total(self):
        return {"raster": sum(k[0] for k in self.paths.values()),
                "attention": sum(k[1] for k in self.paths.values())}


def video_phase():
    """The video-tracking path at full width (base_width 64, 160x160 crops,
    bf16, seeded weights, live delta heads) on a 30-frame 640x480 video of
    the bench mesh rendered by K1: (a) pipelined against synchronous
    tracking, (b) packed windowed against unpacked full-frame tracking,
    (c) a jump that outruns the window, recovered and repaired through the
    frames in flight, (d) the chain of 16 frames replayed from a CUDA graph
    against 16 per-frame calls, (e) MultiTracker with 3 objects against 3
    single trackers, (f) K1 / K2 launches of each path; then times, each
    in turns with its counterpart, and traces."""
    import torch

    from foundationpose_torch.pipeline import EstimatorCfg, MultiTracker, RasterCfg, RefinerCfg, ScorerCfg
    from foundationpose_torch.pipeline.graph import TrackChain, pack_track_frame, track_graph_packed

    mesh = _bench_mesh()
    gts = _video_poses(VIDEO_FRAMES)
    frames = _render_video([mesh], [gts])
    raster = RasterCfg(cull_backfaces=True)
    cfg = EstimatorCfg(refiner=RefinerCfg(raster=raster),
                       scorer=ScorerCfg(mode="network", raster=raster), **PACKED)
    est = _estimator(mesh, cfg, "cuda", head_scale=1.0)
    raw0 = gts[0] @ np.linalg.inv(est.get_tf_to_centered_mesh())
    _live_heads(est, frames[0], raw0)
    counts, t = _Counts(), {}
    print(f"  {VIDEO_FRAMES} frames 640x480, mode: packed uploads on windows (EstimatorCfg defaults)")
    pose = counts.run("register (packed, window)",
                      lambda: est.register(K_FULL, *frames[0], iteration=5))
    print(f"  register: t = {pose[:3, 3]}, window {est._register_roi_window(K_FULL, *frames[0][1:])}, "
          f"recoveries {est.register_roi_recoveries}")
    start = (est.pose_last.clone(), est._pose_hint.copy())
    video = frames[1:]
    full = _tracker(est, track_roi=False)  # packed full-frame
    unpacked = _tracker(est, **UNPACKED)

    # (a) pipelined against synchronous, on the same frames
    sync_full = counts.run("sync track_one (packed full-frame)", _sync_pass, full, video)
    _set_state(full, start)
    pipe_full = counts.run("pipelined track_one_async (packed full-frame)", _pipelined_pass, full, video)
    equal = bool(np.array_equal(np.stack(sync_full), np.stack(pipe_full)))
    print(f"  (a) pipelined (batches of 4, 8 in flight) against sync, packed full-frame: "
          f"equal {equal}")
    if not equal:
        raise AssertionError("(a) pipelined tracking differs from synchronous tracking")
    _set_state(est, start)
    sync_roi = counts.run("sync track_one (packed, window)", _sync_pass, est, video)
    _set_state(est, start)
    pipe_roi = counts.run("pipelined track_one_async (packed, window)", _pipelined_pass, est, video)
    t["video_roi_pipelined_vs_sync_mm"], t["video_roi_pipelined_vs_sync_deg"] = _check_gap(
        "(a) windowed, pipelined against sync (the lagging windows move)", pipe_roi, sync_roi)
    if est.track_stats["roi_recoveries"]:
        raise AssertionError(f"smooth motion needed a recovery: {est.track_stats}")

    # (b) packed windowed against unpacked full-frame, synchronous
    sync_unpacked = counts.run("sync track_one (unpacked full-frame)", _sync_pass, unpacked, video)
    t["video_roi_vs_unpacked_mm"], t["video_roi_vs_unpacked_deg"] = _check_gap(
        "(b) packed windowed against unpacked full-frame", sync_roi, sync_unpacked)
    moved = _pose_gap(sync_roi[-1], pose)
    print(f"  the live heads moved the pose {moved[0]:.2f} mm, {moved[1]:.3f} deg over the video")
    if moved[0] < 1.0:
        raise AssertionError("the live heads did not move the pose")

    # (c) a jump the window cannot follow: the pose follows the object (as a
    # trained refiner would) while the window, placed from the last fetched
    # pose, stays behind; four frames in flight
    jump = gts[20:24].copy()
    jump[:, 0, 3] += 0.2
    jframes = _render_video([mesh], [jump])
    _set_state(est, start)
    _sync_pass(est, video[:19])
    forced = torch.as_tensor(jump[0] @ np.linalg.inv(est.get_tf_to_centered_mesh()),
                             dtype=torch.float32, device="cuda")
    est.pose_last = forced
    est.track_stats = {"frames": 0, "roi_recoveries": 0, "chain_repairs": 0}
    got = counts.run("jump: pipelined, recovered", _pipelined_pass, est, jframes)
    _set_state(full, (forced, est._pose_hint))
    want = _sync_pass(full, jframes)
    equal = bool(np.array_equal(np.stack(got), np.stack(want)))
    print(f"  (c) jump of 0.2 m: {est.track_stats}, poses equal to full-frame tracking {equal}")
    if not (est.track_stats["roi_recoveries"] >= 1 and est.track_stats["chain_repairs"] >= 1
            and est._chain_repair is None and equal):
        raise AssertionError("(c) the window recovery or the chain repair failed")

    # (d) the chain: CHAIN_K frames, one upload, a CUDA graph replayed per frame
    hw = frames[0][1].shape
    bufs = torch.as_tensor(np.stack([pack_track_frame(r, d, 0, 0) for r, d, _m in video[:CHAIN_K]]),
                           device="cuda")
    Kd = torch.as_tensor(K_FULL, device="cuda")
    pose0 = start[0]
    args = (est.refiner, est.cfg, est.mesh_tensors)
    chain = TrackChain(*args, Kd, est._diam, hw, 2, bufs.shape[1])
    traj = counts.run("chain (capture + replays)", chain, pose0, bufs)

    def per_frame():
        p, out = pose0, []
        with torch.inference_mode():
            for i in range(CHAIN_K):
                p = track_graph_packed(*args, p, Kd, bufs[i], est._diam, hw, 2)
                out.append(p)
        return torch.stack(out)

    seq = per_frame()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        traj2 = chain(pose0, bufs)  # replays only: no host synchronisation
    finally:
        torch.cuda.set_sync_debug_mode("default")
    d_seq = float((traj - seq).abs().max())
    print(f"  (d) chain of {CHAIN_K} against per-frame track_graph_packed: bit-equal "
          f"{bool(torch.equal(traj, seq))} (max |d| {d_seq:.3e}); replays bit-equal "
          f"{bool(torch.equal(traj, traj2))}, no synchronisation between steps")
    if not (torch.equal(traj, seq) and torch.equal(traj, traj2)):
        raise AssertionError("(d) the chain differs from per-frame tracking")

    # (e) MultiTracker: 3 copies of the bench mesh at distinct poses
    starts = [(-0.16, 0.02, 0.95), (0.0, -0.05, 1.05), (0.15, 0.04, 0.9)]
    mposes = [_video_poses(12, start=s_, step=(0.002 * (1 - m), 0.001, 0.001), deg=0.2 * (m + 1))
              for m, s_ in enumerate(starts)]
    mframes = _render_video([mesh] * 3, mposes)
    tf_inv = np.linalg.inv(est.get_tf_to_centered_mesh())

    def singles_at(mode):
        out = []
        for m in range(3):
            s_ = _tracker(est, **mode)
            raw = mposes[m][0] @ tf_inv
            _set_state(s_, (torch.as_tensor(raw, dtype=torch.float32, device="cuda"), raw))
            out.append(s_)
        return out

    for name, mode in (("full-frame", dict(track_roi=False)), ("window", {})):
        singles = singles_at(mode)
        multi = MultiTracker.from_estimators(singles)
        m_out = counts.run(f"MultiTracker M=3 ({name})", lambda: [
            multi.track(r, d, K_FULL, iteration=2) for r, d, _m in mframes[1:]])
        s_out = [np.stack([s_.track_one(r, d, K_FULL, iteration=2) for s_ in singles])
                 for r, d, _m in mframes[1:]]
        key = "full" if name == "full-frame" else "roi"
        t[f"multi_{key}_vs_singles_mm"], t[f"multi_{key}_vs_singles_deg"] = _check_gap(
            f"(e) MultiTracker M=3 against 3 single trackers, {name}", m_out, s_out)
    t["video_launches_by_path"] = json.dumps(counts.paths)

    # times, each in turns with its counterpart
    def timed_pass(e, run):
        def go():
            _set_state(e, start)
            run(e, video)
        return go

    tp = _wall_in_turns({"sync_unpacked": timed_pass(unpacked, _sync_pass),
                         "pipelined_roi": timed_pass(est, _pipelined_pass)}, 10)
    t["track_sync_unpacked_ms_per_frame"] = tp["sync_unpacked"] / len(video)
    t["track_pipelined_roi_ms_per_frame"] = tp["pipelined_roi"] / len(video)
    tc = _wall_in_turns({"chain": lambda: chain(pose0, bufs), "per_frame": per_frame}, 10)
    t["chain_ms_per_frame"] = tc["chain"] / CHAIN_K
    t["chain_per_frame_calls_ms_per_frame"] = tc["per_frame"] / CHAIN_K
    mf = iter(mframes[1:] * 10)

    def singles_frame():
        r, d, _m = next(mf)
        return [s_.track_one(r, d, K_FULL, iteration=2) for s_ in singles]

    tm = _wall_in_turns({"multi": lambda: multi.track(*next(mf)[:2], K_FULL, iteration=2),
                         "singles": singles_frame}, 10)
    t["multi_m3_ms_per_frame"], t["singles_m3_ms_per_frame"] = tm["multi"], tm["singles"]
    r, d, _m = video[0]
    t.update(_profile("track_unpacked", lambda: unpacked.track_one(r, d, K_FULL, iteration=2), 10))
    t.update(_profile("track_roi", lambda: est.track_one(r, d, K_FULL, iteration=2), 10))
    t.update(_profile("chain16", lambda: chain(pose0, bufs).cpu(), 2))
    for k in ("ms_untraced_2", "ms_cuda_traced", "device_activities", "device_busy_ms"):
        t[f"chain16_{k}_per_frame"] = t[f"chain16_{k}"] / CHAIN_K
    _print_times(t)
    return counts.total(), t


def _print_times(t):
    for k, v in t.items():
        print(f"  {k} = {v if isinstance(v, str) or v is None else f'{v:.6g}'}   [{_CARD}]")


# ------------------------------------------------- model-free path (K3, K4)


def _row_check(name, out, want, abs_sum):
    """Atomic sums run in another order each launch: per-row bound
    |kernel - plain| <= 1e-5 * sum|update| + 1e-30. Returns max |d|."""
    import torch

    err = (out - want).abs()
    bad = int((err > 1e-5 * abs_sum + 1e-30).sum())
    e = float(err.max())
    finite = bool(torch.isfinite(out).all())
    print(f"  {name}: max |d| {e:.3e}, entries over the bound {bad}, finite {finite}")
    if bad or not finite:
        raise AssertionError(f"{name} disagrees with its plain version")
    return e


def k3_k4_phase():
    """K3 and K4 against their plain versions at the shapes of NerfCfg's
    defaults (2048 rays x 256 samples x 16 levels, 2^22 hashmap): heavy
    duplicates, K3 with 1% sentinel indices, K4 with 1% zero-cotangent
    entries at their level's first row. Returns errors and times."""
    import torch

    from foundationpose_torch.ops.hashgrid import HashGridCfg
    from foundationpose_torch.ops.segment_add import (
        factored_segment_add_plain, segment_add_planes_plain)
    from foundationpose_torch.ops.segment_add_cuda import (
        factored_segment_add_cuda, segment_add_planes_cuda)

    dev = torch.device("cuda")
    _, sizes, offsets, T = HashGridCfg().level_tables()
    L, N = 16, 2048 * 256
    M = N * L * 8
    g = torch.Generator(device=dev).manual_seed(5)
    res = {}

    idx = torch.randint(0, T, (M,), generator=g, device=dev, dtype=torch.int32)
    idx[: M // 8] = torch.randint(0, 4096, (M // 8,), generator=g, device=dev, dtype=torch.int32)
    idx[torch.rand(M, generator=g, device=dev) < 0.01] = T  # the drop sentinel
    upd = torch.randn((2, M), generator=g, device=dev)
    out = segment_add_planes_cuda(idx, upd, T)
    want = segment_add_planes_plain(idx, upd, T)
    res["k3_err"] = _row_check(f"K3 M={M} C=2 T={T}", out, want, segment_add_planes_plain(idx, upd.abs(), T))
    del out, want
    # K3's library call: index_add_ into a zeroed table with a spare row
    # for the drop sentinel (its plain version is built on it).
    res.update(_in_turns({
        "k3_ms": lambda: segment_add_planes_cuda(idx, upd, T),
        "k3_plain_ms": lambda: segment_add_planes_plain(idx, upd, T),
        "k3_library_ms": lambda: torch.zeros((T + 1, 2), device=dev).index_add_(0, idx, upd.T),
    }, reps=3))
    # Bound: indices and updates read once, the (T, 2) f32 table written
    # once; one f32 add per update and channel.
    res["k3_bound_ms"], res["k3_bound_by"] = bound(_nbytes(idx, upd) + T * 2 * 4, 2 * M, "f32")
    del idx, upd

    sz = torch.as_tensor(sizes, device=dev)
    off = torch.as_tensor(offsets, device=dev)
    idx = off[:, None] + (torch.rand((L, N), generator=g, device=dev) * sz[:, None]).long()
    idx[:, : N // 8] = off[:, None] + torch.randint(0, 64, (L, N // 8), generator=g, device=dev)
    w = torch.rand((8, L, N), generator=g, device=dev)
    gp = torch.randn((2, L, N), generator=g, device=dev)
    zero = torch.rand((L, N), generator=g, device=dev) < 0.01  # out-of-bounds points
    idx = torch.where(zero, off[:, None], idx).to(torch.int32)
    gp = torch.where(zero, 0.0, gp)
    out = factored_segment_add_cuda(idx, w, gp, T)
    want = factored_segment_add_plain(idx, w, gp, T)
    res["k4_err"] = _row_check(f"K4 (L, N)=({L}, {N}) nw=8 C=2 T={T}", out, want,
                               factored_segment_add_plain(idx, w, gp.abs(), T))
    del out, want
    res["k4_ms"] = _event_ms(lambda: factored_segment_add_cuda(idx, w, gp, T), reps=5)
    res["k4_plain_ms"] = _event_ms(lambda: factored_segment_add_plain(idx, w, gp, T), reps=3)
    res["k4_library_ms"] = None  # no one PyTorch call forms and adds the outer products
    # Bound: indices, weights and cotangents read once, the (T, 16) f32
    # table written once; a product and an add per (level, point, column).
    res["k4_bound_ms"], res["k4_bound_by"] = bound(
        _nbytes(idx, w, gp) + T * 16 * 4, 2 * 16 * L * N, "f32")
    _print_times({k: v for k, v in res.items() if not k.endswith("_err")})
    return res


K3_CHUNKS = (1024, 2048, 4096, 8192)


def distinct_rows(idx, table_size, chunk=None):
    """Distinct in-range rows of an index stream, over the whole stream or
    summed over chunks of `chunk` consecutive updates (what a kernel that
    merges duplicates within each chunk adds globally). Returns (in-range
    updates, distinct rows)."""
    import torch

    keep = (idx >= 0) & (idx < table_size)
    rows = idx[keep].long()
    if chunk is not None:
        pos = torch.nonzero(keep).squeeze(1)
        rows = (pos // chunk) * table_size + rows
    return rows.numel(), torch.unique(rows).numel()


def k3_reductions(idx, table_size, span):
    """The reductions K3 (csrc/segment_add.cu) issues on a stream, for one
    pass of channels: each warp walks a span of `span` updates 128 at a
    time and keeps one run of a row per column of that step; an in-range
    entry starts a run unless the entry 128 before it in its span has its
    row."""
    import torch

    row = torch.where((idx >= 0) & (idx < table_size), idx.long(), -1)
    prev = torch.full_like(row, -2)
    prev[128:] = row[:-128]
    first = torch.arange(row.numel(), device=row.device) % span < 128
    return int(((first | (row != prev)) & (row >= 0)).sum())


def k3_real_phase(cuda_runner):
    """K3 on the stream a "cuda"-layout train step sends it: the (idx, upd)
    pair of one step, captured by wrapping the name the hash-grid backward
    calls; its distinct-row shares, the reductions K3 issues and the table
    sectors they touch, K3 against its plain version, and K3, plain,
    index_add_ and two yardsticks timed in turns on it."""
    return k3_on_step(cuda_runner, "k3_real")


def k3_on_step(runner, key):
    """k3_real_phase on the one K3 stream of a train step of `runner`
    ("cuda" layout: C = 2; "quad": the 4C = 8 planes of its quad rows);
    results under `key`_*."""
    import torch

    from foundationpose_torch.ops import hashgrid
    from foundationpose_torch.ops.segment_add import segment_add_planes_plain
    from foundationpose_torch.ops.segment_add_cuda import segment_add_planes_cuda

    grabbed = []
    orig = hashgrid.segment_add_planes

    def grab(idx, upd, table_size):
        grabbed.append((idx.clone(), upd.clone(), table_size))
        return orig(idx, upd, table_size)

    hashgrid.segment_add_planes = grab
    try:
        runner.train_step(torch.Generator(device=runner.device).manual_seed(2))
    finally:
        hashgrid.segment_add_planes = orig
    if len(grabbed) != 1:
        raise AssertionError(f"one {key} step called segment_add_planes {len(grabbed)} times")
    idx, upd, T = grabbed[0]
    M = idx.numel()
    if not (int(idx.min()) >= 0 and int(idx.max()) <= T):  # out-of-bounds points send T
        raise AssertionError("the captured stream has indices outside [0, T]")
    res = {}
    n, d = distinct_rows(idx, T)
    res[f"{key}_updates"], res[f"{key}_in_range"] = M, n
    res[f"{key}_distinct_share"] = d / n
    for s in K3_CHUNKS:
        res[f"{key}_distinct_share_chunk{s}"] = distinct_rows(idx, T, s)[1] / n
    for s in (1024, 4096):
        res[f"{key}_reductions_share_span{s}"] = k3_reductions(idx, T, s) / n
    # 32-byte sectors of the (T, C) f32 table that the step's rows touch
    res[f"{key}_table_sectors"] = distinct_rows(
        torch.where((idx >= 0) & (idx < T), idx * upd.shape[0] // 8, -1), T * upd.shape[0] // 8)[1]
    out = segment_add_planes_cuda(idx, upd, T)
    want = segment_add_planes_plain(idx, upd, T)
    res[f"{key}_err"] = _row_check(f"K3 captured {key} step M={M} C={upd.shape[0]} T={T}", out, want,
                                    segment_add_planes_plain(idx, upd.abs(), T))
    del out, want
    # Yardsticks beside them: the wrapper's zeroing of the table alone, and
    # one read of the stream (two sums).
    res.update(_in_turns({
        f"{key}_ms": lambda: segment_add_planes_cuda(idx, upd, T),
        f"{key}_plain_ms": lambda: segment_add_planes_plain(idx, upd, T),
        f"{key}_library_ms": lambda: torch.zeros((T + 1, upd.shape[0]), device=idx.device).index_add_(
            0, idx, upd.T),
        f"{key}_zero_ms": lambda: torch.zeros((T, upd.shape[0]), device=idx.device),
        f"{key}_read_ms": lambda: (idx.sum(), upd.sum()),
    }, reps=3))
    res[f"{key}_bound_ms"], res[f"{key}_bound_by"] = bound(
        _nbytes(idx, upd) + T * upd.shape[0] * 4, upd.numel(), "f32")
    # The same with the traffic of adding into a zeroed table that does not
    # fit the L2: each touched 32-byte sector read back and written again.
    res[f"{key}_sector_bound_ms"] = bound(
        _nbytes(idx, upd) + T * upd.shape[0] * 4 + 2 * 32 * res[f"{key}_table_sectors"],
        upd.numel(), "f32")[0]
    _print_times(res)
    return res


def _reference_views(mesh, hw, K, device):
    """RGB-D views of `mesh` rendered by the port from the 12 icosahedron
    vertices of the icosphere view sampler (its first 12 views) at 0.6 m;
    numpy (rgbs u8, depths, masks, cam_in_obs)."""
    import torch

    from foundationpose_torch.geometry.icosphere import sample_views_icosphere
    from foundationpose_torch.ops.rasterizer import render_mesh

    cam_in_obs = sample_views_icosphere(n_views=12)[:12]
    cam_in_obs[:, :3, 3] *= 0.6
    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    colors = mesh.vertex_colors / 255.0 if mesh.vertex_colors is not None else np.full((len(mesh.vertices), 3), 0.7)
    out = render_mesh(T(mesh.vertices), torch.as_tensor(mesh.faces, device=device),
                      T(np.linalg.inv(cam_in_obs)), T(K), out_hw=hw, vertex_color=T(colors),
                      vnormals=T(mesh.vertex_normals), use_light=True)
    rgbs = (out.color.cpu().numpy() * 255).astype(np.uint8)
    return (rgbs, out.depth.cpu().numpy().astype(np.float32), out.mask.cpu().numpy().astype(np.uint8),
            cam_in_obs)


def _nerf_runner(cfg, K, views, device):
    """run_neural_object_field's set-up: scene bounds, normalization, runner."""
    import dataclasses

    from foundationpose_torch.nerf.runner import NerfRunner
    from foundationpose_torch.nerf.scene import compute_scene_bounds, preprocess_data

    rgbs, depths, masks, cam_in_obs = views
    sc, tr, pts = compute_scene_bounds(K, rgbs, depths, masks, cam_in_obs)
    cfg = dataclasses.replace(cfg, sc_factor=sc, translation=tuple(np.asarray(tr).tolist()))
    rn, dn, pn = preprocess_data(rgbs, depths, masks, cam_in_obs, sc, tr)
    return NerfRunner(cfg, rn, dn, masks, pn, K, build_pcd=pts, device=device)


# Every NerfCfg option that ships off, on at once: the small slice's
# (SMALL_NERF_OPTIONS) and the full-width run's (NERF_OPTIONS).
SMALL_NERF_OPTIONS = dict(n_importance=8, occ_keep_frac=0.75, trunc_decay_type="linear", trunc_start=0.05,
                          depth_weight=1.0, fs_rgb_weight=0.5, eikonal_weight=0.1)
NERF_OPTIONS = dict(SMALL_NERF_OPTIONS, n_importance=64)
NERF_AUX = ("rgb_loss", "fs_loss", "empty_loss", "sdf_loss", "depth_loss", "fs_rgb_loss", "eikonal_loss")


class _CornerGrab:
    """Within a `with`: every (idx, upd) stream the second-order table term
    sends K3 (`ops.hashgrid.corner_table_grad`), kept on the card, and its
    outputs' largest magnitude."""

    def __enter__(self):
        from foundationpose_torch.ops import hashgrid

        self.streams, self.out_max = [], []
        self._orig = orig = hashgrid.corner_table_grad

        def grab(idx, upd, table_size):
            self.streams.append((idx.clone(), upd.contiguous().clone(), table_size))
            out = orig(idx, upd, table_size)
            self.out_max.append(float(out.abs().max()))
            return out

        hashgrid.corner_table_grad = grab
        return self

    def __exit__(self, *exc):
        from foundationpose_torch.ops import hashgrid

        hashgrid.corner_table_grad = self._orig


def small_nerf_phase():
    """A tiny f32 NerfCfg, "oct" and "cuda" layouts ("quad" in phase 16,
    `nerf_slice`), with the options off and with
    every option on (SMALL_NERF_OPTIONS), 3 steps on the card and on the
    CPU plain path from the same parameters and the same pinned draws:
    losses within 1e-4 relative, step 1's gradients within 1e-4 of their
    largest magnitude (options on, the "oct" / "quad" table gradient within
    1e-3 of its largest entry and 1e-4 relative L2: bf16 rounding ties); options
    on, every aux term present and the eikonal loss's second-order table
    term (K3 on the card) nonzero on both."""
    for options in ({}, SMALL_NERF_OPTIONS):
        for layout in ("oct", "cuda"):
            nerf_slice(layout, options)


def _small_nerf_views():
    """The small NeRF slice's scene: a 0.2 m box, 64x64 views on the CPU."""
    from foundationpose_torch.meshio import make_box

    box = make_box(np.array([0.2, 0.2, 0.2]))
    box.vertex_colors = np.random.default_rng(0).integers(50, 255, (8, 3)).astype(np.uint8)
    K = np.array([[60.0, 0, 32.0], [0, 60.0, 32.0], [0, 0, 1.0]], np.float32)
    return K, _reference_views(box, (64, 64), K, "cpu")


def nerf_slice(layout, options):
    """3 steps of the tiny f32 NerfCfg in `layout` with `options` on the
    card and on the CPU (see small_nerf_phase). Returns the card's K3 /
    K4 launches."""
    import dataclasses

    import torch

    from foundationpose_torch.nerf import NerfCfg
    from foundationpose_torch.ops import segment_add_cuda

    K, views = _small_nerf_views()
    launches = [segment_add_cuda.K3.launches, segment_add_cuda.K4.launches]
    cfg = NerfCfg(n_step=10, n_rand=256, n_samples=16, n_samples_around_depth=16, num_levels=6,
                  finest_res=128, log2_hashmap_size=14, amp=False, grid_layout=layout)
    cfg = dataclasses.replace(cfg, **options)
    runners = {dev: _nerf_runner(cfg, K, views, dev) for dev in ("cpu", "cuda")}
    cpu = runners["cpu"]
    gen = torch.Generator().manual_seed(1)
    name = f"{layout}{' options on' if options else ''}"
    for step in range(3):
        idx = torch.randint(0, cpu.n_rays, (cfg.n_rand,), generator=gen)
        draws = (idx,) + cpu.draw(cfg.n_rand, gen)
        out = {}
        for dev, r in runners.items():
            with _CornerGrab() as grab:
                loss, aux, grads = r.loss_and_grads(*(None if d is None else d.to(r.device) for d in draws))
            r.apply_gradients(grads)
            r.global_step += 1
            out[dev] = (float(loss), {k: v.cpu() for k, v in grads.items()}, set(aux), grab.out_max)
        rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        errs = {k: (float((out["cuda"][1][k] - g).abs().max() / g.abs().max().clamp(min=1e-30)),
                    float((out["cuda"][1][k] - g).norm() / g.norm().clamp(min=1e-30)))
                for k, g in out["cpu"][1].items()}
        # With the options on, the "oct" / "quad" table gradient also adds
        # the second-order term's bf16-rounded corner cotangents: an f32
        # cotangent an ulp apart on the two devices can round to the
        # neighbouring bf16 value, as K4's bf16 weights can. That entry
        # is held by the CPU tests' bound against the JAX package
        # (1e-4 relative L2, 1e-3 of the largest entry), the rest by
        # 1e-4 of the largest entry.
        tie = options and layout in ("oct", "quad")
        ok = all(m < 1e-4 or (tie and k == "grid" and m < 1e-3 and l2 < 1e-4) for k, (m, l2) in errs.items())
        gerr = max(m for m, _ in errs.values())
        print(f"  {name} step {step + 1}: loss cpu {out['cpu'][0]:.6f} cuda {out['cuda'][0]:.6f} "
              f"(rel {rel:.2e}), grads max |d| / max |g| {gerr:.2e} (grid {errs['grid'][0]:.2e}, "
              f"relative L2 {errs['grid'][1]:.2e})"
              + (f", second-order table term max |.| cpu {out['cpu'][3]} cuda {out['cuda'][3]}"
                 if options else ""))
        if not rel < 1e-4 or (step == 0 and not ok):
            raise AssertionError(f"NeRF {name} step on the card disagrees with the CPU plain path")
        if options and not all(o[2] == set(NERF_AUX) and len(o[3]) == 1 and o[3][0] > 0
                               for o in out.values()):
            raise AssertionError(f"NeRF {name}: an aux term is missing or the eikonal table term is zero")
    return segment_add_cuda.K3.launches - launches[0], segment_add_cuda.K4.launches - launches[1]


NERF_STEPS = 200
NERF_CUDA_STEPS = 20


class _StepLog(logging.Handler):
    """Collects (step, loss, host time) from the lines NerfRunner.train
    logs every tenth of a run; each such line has read the loss, so the
    step before it has ended on the card."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.steps = []
        self._logger = logging.getLogger("foundationpose_torch.nerf.runner")

    def emit(self, record):
        if record.msg.startswith("step "):
            self.steps.append((record.args[0], record.args[2], time.perf_counter()))

    def __enter__(self):
        self._level = self._logger.level
        self._logger.setLevel(logging.INFO)
        self._logger.addHandler(self)
        return self

    def __exit__(self, *exc):
        self._logger.removeHandler(self)
        self._logger.setLevel(self._level)


def _surface_sample(mesh, n, seed=0):
    """n points uniform by area on the mesh's surface."""
    rng = np.random.default_rng(seed)
    tri = mesh.vertices[mesh.faces]
    area = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1)
    f = rng.choice(len(tri), n, p=area / area.sum())
    a, b = rng.uniform(size=(2, n, 1))
    flip = (a + b) > 1
    a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
    return tri[f, 0] + a * (tri[f, 1] - tri[f, 0]) + b * (tri[f, 2] - tri[f, 0])


def model_free_phase():
    """The model-free path at the full width of NerfCfg's defaults:
    run_neural_object_field on 12 reference views of the bench mesh, the
    mesh checked against the bench mesh, register on the reconstruction,
    then NERF_CUDA_STEPS steps with the "cuda" layout. Returns the launch
    counts of that run and what the timing needs."""
    import torch
    from scipy.spatial import cKDTree

    from foundationpose_torch.nerf import NerfCfg, run_neural_object_field
    from foundationpose_torch.ops import attention_cuda, raster_cuda, segment_add_cuda
    from foundationpose_torch.pipeline import EstimatorCfg, RefinerCfg, ScorerCfg

    mesh = _bench_mesh()
    views = _reference_views(mesh, (480, 640), K_FULL, "cuda")
    print(f"  {len(views[0])} views {views[0].shape[1:3]}, mask px per view "
          f"{int(views[2].sum()) // len(views[0])}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels = (raster_cuda.KERNEL, attention_cuda.KERNEL, segment_add_cuda.K3, segment_add_cuda.K4)
    for k in kernels:
        k.launches = 0

    log = _StepLog()
    cfg = NerfCfg(n_step=NERF_STEPS)
    t0 = time.perf_counter()
    with log:
        recon, runner = run_neural_object_field(cfg, K_FULL, *views, device="cuda")
    t = {"reconstruction_wall_s": time.perf_counter() - t0}
    steps = dict((it, (loss, at)) for it, loss, at in log.steps)
    losses = [loss for loss, _ in steps.values()]
    t["train_step_ms_mean_41_200"] = (steps[NERF_STEPS][1] - steps[40][1]) / (NERF_STEPS - 40) * 1e3
    t["train_wall_s"] = steps[NERF_STEPS][1] - t0
    print(f"  rays {runner.n_rays}, steps {runner.global_step}, logged at {sorted(steps)}, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, K4 launches {segment_add_cuda.K4.launches}")
    if segment_add_cuda.K4.launches < NERF_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"K4 launched {segment_add_cuda.K4.launches} times in {NERF_STEPS} steps")
    ext_b = mesh.vertices.max(0) - mesh.vertices.min(0)
    ext_r = recon.bounds()[1] - recon.bounds()[0]
    dist, _ = cKDTree(_surface_sample(mesh, 400_000)).query(recon.vertices)
    med = float(np.median(dist))
    t["mesh_median_dist_mm"] = med * 1e3
    print(f"  mesh: {len(recon.faces)} faces, extents {ext_r} vs {ext_b}, "
          f"median vertex distance {med * 1e3:.3f} mm, texture {recon.texture.shape}")
    if not (np.abs(ext_r / ext_b - 1) <= 0.25).all() or not med < 0.005:
        raise AssertionError("the reconstruction is off the bench mesh")
    if recon.texture.shape != (1024, 1024, 3) or not np.isfinite(recon.vertices).all():
        raise AssertionError("the reconstruction has no 1024^2 texture or non-finite vertices")

    est = _estimator(recon, EstimatorCfg(refiner=RefinerCfg(), scorer=ScorerCfg(mode="network"),
                                         **UNPACKED), "cuda")
    frame = _frame(mesh, (0.02, -0.01, 0.9), (480, 640), K_FULL, "cuda")
    before = (raster_cuda.KERNEL.launches, attention_cuda.KERNEL.launches)
    pose = est.register(K_FULL, *frame, iteration=5)
    reg = (raster_cuda.KERNEL.launches - before[0], attention_cuda.KERNEL.launches - before[1])
    print(f"  register on the reconstruction: t = {pose[:3, 3]}, launches K1 {reg[0]} K2 {reg[1]}")
    if not (pose.shape == (4, 4) and np.isfinite(pose).all() and abs(pose[2, 3] - 0.9) < 0.2):
        raise AssertionError(f"register on the reconstruction: pose out of bounds\n{pose}")
    if reg[0] < 6 or reg[1] < 12:
        raise AssertionError(f"register on the reconstruction launched too few kernels: {reg}")

    cuda_runner = _nerf_runner(NerfCfg(n_step=NERF_STEPS, grid_layout="cuda"), K_FULL, views, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    losses, stamps = [], [time.perf_counter()]
    for _ in range(NERF_CUDA_STEPS):
        loss, _ = cuda_runner.train_step(gen)
        losses.append(float(loss))
        stamps.append(time.perf_counter())
    t["cuda_layout_step_ms_median"] = float(np.median(np.diff(stamps)[1:])) * 1e3
    print(f"  cuda layout: losses {losses[0]:.4f} -> {losses[-1]:.4f}, K3 launches {segment_add_cuda.K3.launches}")
    if segment_add_cuda.K3.launches < NERF_CUDA_STEPS or not np.isfinite(losses).all():
        raise AssertionError("the cuda-layout steps launched too few K3 or gave non-finite losses")
    torch.cuda.synchronize()
    t["nerf_peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    counts = {"raster": kernels[0].launches, "attention": kernels[1].launches,
              "k3": kernels[2].launches, "k4": kernels[3].launches}
    return counts, t, (runner, cuda_runner, views, est, frame)


def nerf_timing_phase(t, runner, cuda_runner, views, est, frame):
    import torch

    from foundationpose_torch.nerf.texture import bake_texture

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mesh = runner.extract_mesh(voxel_size=runner.cfg.mesh_resolution)
    t["extract_mesh_s"] = time.perf_counter() - t0
    rgbs, depths, _, _ = views
    t0 = time.perf_counter()
    bake_texture(runner.mesh_to_real_world(mesh), rgbs, depths, runner.get_optimized_poses_in_real_world(),
                 K_FULL, tex_res=runner.cfg.tex_res, top_views=runner.cfg.tex_top_views, device="cuda")
    t["bake_texture_s"] = time.perf_counter() - t0
    # K1 on the reconstructed (marching-cubes) mesh at 32 register crops.
    from foundationpose_torch.geometry.projection import compute_crop_window_tf
    from foundationpose_torch.ops.rasterizer import _prepare

    mt, res = est.mesh_tensors, est.cfg.refiner.input_res
    Kt = torch.as_tensor(K_FULL, device="cuda")
    poses = est.rot_grid[:32].clone()
    poses[:, :3, 3] = torch.tensor([0.02, -0.01, 0.9], device="cuda")
    prep = _prepare(mt.pos, mt.faces, poses, Kt, (res, res),
                    compute_crop_window_tf(poses, Kt, 1.2, res, est._diam), mt.vertex_color, mt.uv,
                    mt.vnormals, True, False, None, est.cfg.refiner.raster.cull_backfaces)
    t["k1_err_recon"] = _k1_prepared(f"reconstruction ({len(mt.faces)} faces), 32 register crops",
                                     prep, mt.tex if mt.uv is not None else None)
    est.register(K_FULL, *frame, iteration=5)  # warm-up
    reg = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.register(K_FULL, *frame, iteration=5)
        reg.append(time.perf_counter() - t0)
    t["register_recon_ms_median3"] = float(np.median(reg)) * 1e3
    for name, r in (("oct", runner), ("cuda", cuda_runner)):
        gen = torch.Generator(device="cuda").manual_seed(1)
        t.update(_profile(f"{name}_step", lambda: float(r.train_step(gen)[0]), PROFILE_STEPS))
    _print_times(t)
    return t


# ------------------------------------ model-free entry point, every option


def _write_ref_views(root, views, K):
    """The views in run_nerf's layout: rgb/ (PNG, written by cv2 from RGB),
    depth/ (uint16 millimetres), masks/, cam_in_ob/*.txt and K.txt."""
    import os

    import cv2

    rgbs, depths, masks, cam_in_obs = views
    for sub in ("rgb", "depth", "masks", "cam_in_ob"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    np.savetxt(os.path.join(root, "K.txt"), K)
    for i in range(len(rgbs)):
        name = f"{i:06d}"
        cv2.imwrite(os.path.join(root, "rgb", f"{name}.png"), np.ascontiguousarray(rgbs[i][..., ::-1]))
        cv2.imwrite(os.path.join(root, "depth", f"{name}.png"), np.round(depths[i] * 1e3).astype(np.uint16))
        cv2.imwrite(os.path.join(root, "masks", f"{name}.png"), (masks[i] > 0).astype(np.uint8) * 255)
        np.savetxt(os.path.join(root, "cam_in_ob", f"{name}.txt"), cam_in_obs[i])


def _mesh_gate(name, recon, mesh, gate=True):
    """Phase 10's bars against the bench mesh: extents within 25%, median
    vertex distance < 5 mm (every vertex; 100k of them, seeded, where
    reported and not gated: a query far off the sampled surface visits
    many leaves), a 1024^2 texture. Returns the distance in mm."""
    from scipy.spatial import cKDTree

    ext_b = mesh.vertices.max(0) - mesh.vertices.min(0)
    ext_r = recon.vertices.max(0) - recon.vertices.min(0)
    verts = recon.vertices
    if not gate and len(verts) > 100_000:
        verts = verts[np.random.default_rng(0).choice(len(verts), 100_000, replace=False)]
    med = float(np.median(cKDTree(_surface_sample(mesh, 400_000)).query(verts, workers=-1)[0]))
    tex = None if recon.texture is None else recon.texture.shape
    print(f"  {name}: {len(recon.faces)} faces, extents {ext_r} vs {ext_b}, median vertex distance "
          f"{med * 1e3:.3f} mm, texture {tex}")
    if gate and (not (np.abs(ext_r / ext_b - 1) <= 0.25).all() or not med < 0.005 or tex != (1024, 1024, 3)
                 or not np.isfinite(recon.vertices).all()):
        raise AssertionError(f"{name}: the reconstruction misses phase 10's bars")
    return med * 1e3


class _Interrupt(Exception):
    pass


def entry_point_phase(views):
    """(c) The model-free path at full width through its entry points, on
    the 12 views of the model-free phase written to disk in run_nerf's
    layout: cli.run_nerf.main at the parity preset (200 steps), gated by
    phase 10's bars; run_neural_object_field with every option on
    (NERF_OPTIONS), artifacts every 100 steps; and a runner with every
    option on that saves its train state at step 100, stops at step 120,
    and is resumed by a fresh runner that finishes the run (artifacts and
    poses every 100 steps). Launch counts are read around the whole phase;
    K3's launches in these "oct" runs are the second-order table term's."""
    import os
    import tempfile

    import torch

    from foundationpose_torch.cli import run_nerf
    from foundationpose_torch.meshio import load_mesh
    from foundationpose_torch.nerf import NerfCfg, run_neural_object_field
    from foundationpose_torch.nerf.texture import bake_texture
    from foundationpose_torch.ops import attention_cuda, raster_cuda, segment_add_cuda

    mesh = _bench_mesh()
    kernels = (raster_cuda.KERNEL, attention_cuda.KERNEL, segment_add_cuda.K3, segment_add_cuda.K4)
    t = {}
    clock = [time.perf_counter()]

    def stage(name):
        now = time.perf_counter()
        t[f"stage_{name}_s"] = now - clock[0]
        clock[0] = now

    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "ref")
        _write_ref_views(ref, views, K_FULL)
        stage("write_views")
        for k in kernels:
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_nerf.main(["--ref_view_dir", ref, "--n_step", str(NERF_STEPS), "--out_dir", os.path.join(tmp, "out")])
        t["run_nerf_wall_s"] = time.perf_counter() - t0
        stage("run_nerf")
        recon = load_mesh(os.path.join(tmp, "out", "model.obj"))
        stage("load_mesh")
        t["run_nerf_mesh_median_dist_mm"] = _mesh_gate("run_nerf (parity preset, read back from disk)", recon, mesh)
        stage("mesh_gate")
        if segment_add_cuda.K4.launches < NERF_STEPS + 1:
            raise AssertionError(f"run_nerf launched K4 {segment_add_cuda.K4.launches} times")

        cfg = NerfCfg(n_step=NERF_STEPS, **NERF_OPTIONS)
        counts0 = {k: k.launches for k in kernels}
        sunk = []
        art = os.path.join(tmp, "art")
        log = _StepLog()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with log:
            recon_on, runner = run_neural_object_field(cfg, K_FULL, *views, artifact_dir=art, i_img=100,
                                                       i_mesh=100, device="cuda")
        t["options_reconstruction_wall_s"] = time.perf_counter() - t0
        stage("options_run")
        steps = dict((it, at) for it, _, at in log.steps)
        t["options_train_step_ms_mean_41_200"] = (steps[NERF_STEPS] - steps[40]) / (NERF_STEPS - 40) * 1e3
        k3_on = segment_add_cuda.K3.launches - counts0[segment_add_cuda.K3]
        k4_on = segment_add_cuda.K4.launches - counts0[segment_add_cuda.K4]
        n = NERF_STEPS + 1
        print(f"  every option on: {n} steps, losses {[round(loss, 4) for _, loss, _ in log.steps]}, "
              f"K4 {k4_on} (first order, 2 network passes a step), K3 {k3_on} (second-order table term)")
        if k4_on < 2 * n or k3_on < n or not np.isfinite([loss for _, loss, _ in log.steps]).all():
            raise AssertionError("the options-on run launched too few K3 / K4 or gave non-finite losses")
        for f in ("image/step_0000100.png", "image/step_0000200.png"):
            if not os.path.exists(os.path.join(art, f)):
                raise AssertionError(f"artifact {f} missing")
        meshes = sorted(os.listdir(os.path.join(art, "mesh"))) if os.path.isdir(os.path.join(art, "mesh")) else []
        print(f"  artifacts: images {sorted(os.listdir(os.path.join(art, 'image')))}, meshes {meshes}")
        t["options_mesh_median_dist_mm"] = _mesh_gate("every option on (reported, not gated)", recon_on, mesh,
                                                      gate=False)

        # checkpoint at 100, interrupted at 120, resumed by a fresh runner
        ck, art2 = os.path.join(tmp, "ck"), os.path.join(tmp, "art2")

        def stop_at_120(it, scalars):
            sunk.append((it, scalars))
            if it == 120:
                raise _Interrupt

        stage("options_checks")
        first = _nerf_runner(cfg, K_FULL, views, "cuda")
        stage("first_runner_setup")
        kw = dict(ckpt_dir=ck, i_weights=100, artifact_dir=art2, i_img=100, i_mesh=100, i_pose=100)
        try:
            first.train(metric_sink=stop_at_120, **kw)
        except _Interrupt:
            pass
        stage("first_train_to_120")
        resumed = _nerf_runner(cfg, K_FULL, views, "cuda")
        resumed.resume(ck)
        at = resumed.global_step
        resumed.train(metric_sink=lambda it, s: sunk.append((it, s)), **kw)
        stage("resume_and_finish")
        print(f"  checkpoints {sorted(os.listdir(ck))}, resumed at step {at}, ran to {resumed.global_step}; "
              f"metric sink at {[it for it, _ in sunk]}")
        if at != 101 or resumed.global_step != n or sorted(os.listdir(ck))[-1] != f"step_{n:07d}":
            raise AssertionError("the resumed run did not continue from the step-100 checkpoint")
        if not all(set(s) == {"loss", *NERF_AUX} and np.isfinite(list(s.values())).all() for _, s in sunk):
            raise AssertionError("the metric sink missed an aux term or got a non-finite loss")
        for f in ("pose/step_0000100.npy", "pose/step_0000200.npy", "image/step_0000200.png"):
            if not os.path.exists(os.path.join(art2, f)):
                raise AssertionError(f"artifact {f} missing")
        # the resumed run against the uninterrupted one: the same draws, atomics add in another order
        d = max(float((a - b).abs().max()) for a, b in zip(runner.model.state_dict().values(),
                                                         resumed.model.state_dict().values()))
        t["resumed_vs_uninterrupted_max_param_diff"] = d
        rmesh = resumed.extract_mesh(voxel_size=cfg.mesh_resolution)
        rgbs, depths, _, _ = views
        rmesh = bake_texture(resumed.mesh_to_real_world(rmesh), rgbs, depths,
                             resumed.get_optimized_poses_in_real_world(), K_FULL, tex_res=cfg.tex_res,
                             top_views=cfg.tex_top_views, device="cuda")
        t["resumed_mesh_median_dist_mm"] = _mesh_gate("resumed, every option on (reported, not gated)", rmesh,
                                                      mesh, gate=False)
        stage("resumed_mesh")
    stage("cleanup")
    counts = {"raster": kernels[0].launches, "attention": kernels[1].launches, "k3": kernels[2].launches,
              "k4": kernels[3].launches, "k3_second_order": kernels[2].launches}
    print(f"  launches in this phase: {counts}")
    _print_times(t)
    return counts, t, runner


def k3_second_order_phase(runner):
    """(b) K3 on the stream the eikonal loss's second-order table term sends
    it in one full-width step with every option on ("oct"): captured around
    `corner_table_grad`, held against its plain version by the per-row
    bound, timed in turns with its plain version and index_add_, and its
    bound."""
    import torch

    from foundationpose_torch.ops.segment_add import segment_add_planes_plain
    from foundationpose_torch.ops.segment_add_cuda import segment_add_planes_cuda

    with _CornerGrab() as grab:
        runner.train_step(torch.Generator(device=runner.device).manual_seed(4))
    if len(grab.streams) != 1:
        raise AssertionError(f"one options-on step sent the second-order term {len(grab.streams)} streams")
    idx, upd, T = grab.streams[0]
    M = idx.numel()
    res = {"k3_eik_updates": M}
    n, d = distinct_rows(idx, T)
    res["k3_eik_in_range"], res["k3_eik_distinct_share"] = n, d / n
    res["k3_eik_reductions_share_span1024"] = k3_reductions(idx, T, 1024) / n
    out = segment_add_planes_cuda(idx, upd, T)
    want = segment_add_planes_plain(idx, upd, T)
    res["k3_eik_err"] = _row_check(f"K3 second-order stream M={M} C={upd.shape[0]} T={T}", out, want,
                                   segment_add_planes_plain(idx, upd.abs(), T))
    if not float(want.abs().max()) > 0:
        raise AssertionError("the second-order table term is zero")
    del out, want
    res.update(_in_turns({
        "k3_eik_ms": lambda: segment_add_planes_cuda(idx, upd, T),
        "k3_eik_plain_ms": lambda: segment_add_planes_plain(idx, upd, T),
        "k3_eik_library_ms": lambda: torch.zeros((T + 1, upd.shape[0]), device=idx.device).index_add_(
            0, idx, upd.T),
    }, reps=3))
    # indices and updates read once, the (T, C) f32 table written once; one
    # f32 add per update and channel
    res["k3_eik_bound_ms"], res["k3_eik_bound_by"] = bound(
        _nbytes(idx, upd) + T * upd.shape[0] * 4, upd.numel(), "f32")
    _print_times(res)
    return res


def options_timing_phase(on_runner, off_runner):
    """Options-on against options-off full-width "oct" steps in turns
    (host clock, synchronised, median of 10), the peak memory of an
    options-on step, and a traced options-on step."""
    import torch

    t = {}
    gens = {k: torch.Generator(device="cuda").manual_seed(5) for k in ("on", "off")}
    t.update({f"options_{k}_step_ms_median10": v for k, v in _wall_in_turns({
        "on": lambda: on_runner.train_step(gens["on"]),
        "off": lambda: off_runner.train_step(gens["off"]),
    }, 10).items()})
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    on_runner.train_step(gens["on"])
    torch.cuda.synchronize()
    t["options_on_step_peak_gib_above_resident"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    t["options_on_step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    t.update(_profile("options_on_step", lambda: float(on_runner.train_step(gens["on"])[0]), PROFILE_STEPS))
    _print_times(t)
    return t


# ------------------------------------------------------------ training path

TRAIN_N = 64  # the reference's batch_size 64 (training_config.py)
TRAIN_STEPS = 5
# tests/test_pipeline.py's K (320x240) and box diameter: the training recipe's scene
K_TEST = np.array([[280.0, 0, 160.0], [0, 280.0, 120.0], [0, 0, 1.0]], np.float32)
BOX_DIAMETER = 0.28
# Bounds of tests/test_torch_training.py for two runs of the same train
# steps (the JAX package against the port, or the card against the CPU):
# the loss of each step, relative; and the parameters after the steps, by
# `param_agreement`.
TRAIN_LOSS_RTOL = 5e-5
# resolved: |g| >= 1e-3 x its tensor's largest |g| and >= 1e-6 x the step's
# largest, at every step
TRAIN_RESOLVED = (1e-3, 1e-6)
TRAIN_RESOLVED_TOL = 0.1  # x lr x steps, on resolved entries
TRAIN_ADAM_REACH = 2.1  # x lr x steps, on every entry
TRAIN_MIN_RESOLVED = 0.5  # share of the trained entries that must be resolved
TRAIN_ULPS = 4  # f32 roundings of the parameter itself, a step


def param_agreement(got, want, grads, lr):
    """Parameters of two runs of the same Adam steps (state_dicts: `got`
    and the reference `want`; `grads`, the reference's gradients at each
    step by name) -> (share of the trained entries that are resolved, the
    largest difference on them and on any entry, in units of lr x steps,
    after TRAIN_ULPS f32 roundings of |parameter| a step are taken off).

    Adam scales each update to about lr whatever the gradient's size, so
    an entry whose gradient is near its rounding noise (or is noise: what
    the loss does not depend on, such as a key bias) moves either way, by
    up to ~1.01 lr a step on each side (TRAIN_ADAM_REACH). Where the
    gradient stands clear of that noise at every step (TRAIN_RESOLVED),
    the update's relative error is the gradient's, and the runs agree
    within TRAIN_RESOLVED_TOL of a step. A missed or wrong update (a
    tensor left untrained, a bias correction left out) moves whole
    tensors by ~lr a step and fails that."""
    import torch

    eps = torch.finfo(torch.float32).eps
    steps = len(grads)
    n_res = n_all = 0
    d_res = d_all = 0.0
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        res = torch.ones(w.shape, dtype=torch.bool)
        for g in grads:
            top = max(float(x.abs().max()) for x in g.values())
            a = g[name].cpu().abs()
            res &= (a >= TRAIN_RESOLVED[0] * a.max()) & (a >= TRAIN_RESOLVED[1] * top)
        w = w.float().cpu()
        d = ((got[name].float().cpu() - w).abs() - TRAIN_ULPS * eps * w.abs() * steps) / (lr * steps)
        n_res, n_all = n_res + int(res.sum()), n_all + res.numel()
        d_all = max(d_all, float(d.max()))
        if res.any():
            d_res = max(d_res, float(d[res].max()))
    return n_res / n_all, d_res, d_all


def agreement_ok(share, d_res, d_all):
    return share >= TRAIN_MIN_RESOLVED and d_res <= TRAIN_RESOLVED_TOL and d_all <= TRAIN_ADAM_REACH


def _core_checks():
    """(a) attention_core with a gradient on the card against the plain
    core: forward (K2) within K2's tolerance, the qkv gradient (the same
    plain recompute) against the plain path's."""
    import torch

    from foundationpose_torch.ops import attention_cuda
    from foundationpose_torch.ops.attention import attention_core, attention_core_plain

    worst = {}
    for shape, dtype, tol in (((TRAIN_N, 400, 512, 4), torch.bfloat16, 2e-3),
                              ((2, 20, 64, 4), torch.float32, 1e-4)):
        B, L, D, H = shape
        g = torch.Generator().manual_seed(5)
        x = (torch.rand((B, L, 3 * D), generator=g) * 2 - 1).to("cuda", dtype)
        up = torch.randn((B, L, D), generator=g).to("cuda", dtype)
        xk, xp = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
        attention_cuda.KERNEL.launches = 0
        out = attention_core(xk, H)
        launched = attention_cuda.KERNEL.launches
        out.backward(up)
        ref = attention_core_plain(xp, H)
        ref.backward(up)
        d_fwd = float((out.detach().float() - ref.detach().float()).abs().max())
        gmax = float(xp.grad.float().abs().max())
        dg = (xk.grad.float() - xp.grad.float()).abs()
        print(f"  (a) attention_core {str(dtype)[6:]} {shape}: K2 launches {launched}, forward max |d| "
              f"{d_fwd:.3e} (< {tol}), qkv gradient max |d| {float(dg.max()):.3e} of max "
              f"{gmax:.3e}, share not equal {float((dg != 0).float().mean()):.2e}")
        if launched != 1 or out.grad_fn is None:
            raise AssertionError("attention_core with a gradient did not run K2 through its autograd.Function")
        if not (d_fwd < tol and float(dg.max()) <= tol * max(1.0, gmax)):
            raise AssertionError("the differentiable core on the card disagrees with the plain core")
        worst[str(dtype)[6:]] = d_fwd
    return worst


def _refiner_step_grads():
    """(a) One full-width RefineNet loss (f32, 8 pairs of the training
    batch): every trained tensor, BN statistics included, gets a finite
    gradient, and the in-projections' gradients are non-zero and within
    1e-3 (relative L2) of the same loss with the plain core."""
    import torch

    from foundationpose_torch.datasets import make_refiner_batch
    from foundationpose_torch.models import layers, training
    from foundationpose_torch.models.networks import RefineNetCfg, init_refine_net
    from foundationpose_torch.ops.attention import attention_core_plain
    from foundationpose_torch.pipeline import RefinerCfg, make_mesh_tensors

    cfg = RefinerCfg(compute_dtype="float32")
    mesh = make_mesh_tensors(_bench_mesh(), device="cuda")
    K = torch.as_tensor(K_FULL, device="cuda")
    batch = make_refiner_batch(torch.Generator(device="cuda").manual_seed(1), mesh, K, cfg,
                               torch.tensor(0.23, device="cuda"), n=8)
    net = init_refine_net(RefineNetCfg(), torch.Generator().manual_seed(0))
    training.make_optimizer(training.TrainCfg(), net, "cuda")

    def grads():
        for t in net.state_dict(keep_vars=True).values():
            t.grad = None
        training.refine_loss_fn(net, batch, "l2", torch.float32).backward()
        return {n: t.grad.clone() for n, t in net.state_dict(keep_vars=True).items()
                if t.grad is not None}

    g_k2 = grads()
    core, layers.attention_core = layers.attention_core, attention_core_plain
    try:
        g_plain = grads()
    finally:
        layers.attention_core = core
    want = {n for n in net.state_dict() if not n.endswith("num_batches_tracked")}
    missing = want - set(g_k2)
    bad = [n for n, g in g_k2.items() if not torch.isfinite(g).all()]
    proj = [n for n in want if n.endswith("in_proj_weight")]
    rel = {n: float((g_k2[n] - g_plain[n]).norm() / g_plain[n].norm()) for n in proj}
    print(f"  (a) full-width RefineNet gradients: {len(g_k2)} of {len(want)} trained tensors "
          f"(BN statistics {sum('running_' in n for n in g_k2)}), not finite {len(bad)}, "
          + ", ".join(f"{n} max |g| {float(g_k2[n].abs().max()):.3e} vs plain core {rel[n]:.2e}"
                      for n in proj))
    if missing or bad or not all(float(g_k2[n].abs().max()) > 0 and rel[n] < 1e-3 for n in proj):
        raise AssertionError(f"RefineNet gradients: missing {sorted(missing)[:4]}, "
                             f"not finite {bad[:4]}, in-projections {rel}")


def _train_slice(device, net0, kind, draws, mesh=None):
    """(b) f32 steps at test width on `device` from the weights `net0` and
    the given draws, one step a draw (data-parallel over `mesh` if given):
    (losses, batches, net, the gradients of each step by name)."""
    import copy
    import dataclasses

    import torch

    from foundationpose_torch.datasets import make_refiner_batch, make_scorer_batch
    from foundationpose_torch.models import training
    from foundationpose_torch.pipeline import make_mesh_tensors

    cfg = _small_cfg()
    mt = make_mesh_tensors(_box(), device=device)
    K = torch.as_tensor(K_TEST, device=device)
    to = lambda d: {k: to(v) if isinstance(v, dict) else v.to(device) for k, v in d.items()}  # noqa: E731
    tcfg = training.TrainCfg(compute_dtype="float32")
    net = copy.deepcopy(net0)
    opt = training.make_optimizer(tcfg, net, device)
    losses, batches, grads = [], [], []
    for d in draws:
        if kind == "refiner":
            b = make_refiner_batch(None, mt, K, cfg.refiner, BOX_DIAMETER, draws=to(d))
            losses.append(training.refine_train_step(net, opt, tcfg, b, mesh=mesh))
        else:
            b = make_scorer_batch(None, mt, K, dataclasses.replace(cfg.scorer, mode="network"),
                                  BOX_DIAMETER, n=8, frame_hw=(240, 320), draws=to(d))
            losses.append(training.score_train_step(net, opt, tcfg, b, mesh=mesh))
        batches.append(b)
        grads.append({n: t.grad.detach().cpu() for n, t in net.state_dict(keep_vars=True).items()
                      if t.grad is not None})
    return [float(x) for x in losses], batches, net, grads


def _train_slice_inputs():
    """(b)'s draws and initial nets (the scorer spread by `spread_scorer`)."""
    import dataclasses

    import torch

    from foundationpose_torch.datasets import make_scorer_batch, synthetic
    from foundationpose_torch.models import init_refine_net, init_score_net
    from foundationpose_torch.pipeline import make_mesh_tensors

    scfg = dataclasses.replace(_small_cfg().scorer, mode="network")
    g = torch.Generator().manual_seed(11)
    draws = {"refiner": [{"pairs": synthetic._pair_draws(g, 4)} for _ in range(2)],
             "scorer": [{"scene": synthetic._pair_draws(g, 1), "dw": torch.randn((8, 3), generator=g),
                         "dt": torch.randn((8, 3), generator=g)} for _ in range(2)]}
    nets0 = {"refiner": init_refine_net(_small_cfg().refiner.net, torch.Generator().manual_seed(11)),
             "scorer": init_score_net(scfg.net, torch.Generator().manual_seed(12))}
    b = make_scorer_batch(None, make_mesh_tensors(_box()), torch.as_tensor(K_TEST), scfg,
                          BOX_DIAMETER, n=8, frame_hw=(240, 320), draws=draws["scorer"][0])
    spread_scorer(nets0["scorer"], b["A"], b["B"])  # logits that differ beyond rounding
    return draws, nets0


def _train_slice_check():
    """(b) 2 refiner and 2 scorer steps of `_train_slice` on the CPU and on
    the card from one init (the scorer spread by `spread_scorer`) and the
    same draws, within the bounds of tests/test_torch_training.py."""
    from foundationpose_torch.models import training

    draws, nets0 = _train_slice_inputs()
    lr = training.TrainCfg().lr
    t, ok = {}, True
    for kind, net0 in nets0.items():
        lc, bc, nc, gc = _train_slice("cpu", net0, kind, draws[kind])
        lg, bg, ng, gg = _train_slice("cuda", net0, kind, draws[kind])
        d_crop = max(float((x[k].cpu() - y[k]).abs().max()) for x, y in zip(bg, bc) for k in ("A", "B"))
        d_tgt = max(float((x[k].cpu() - y[k]).abs().max())
                    for x, y in zip(bg, bc) for k in y if k not in ("A", "B"))
        d_loss = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
        gmax = max(float(x.abs().max()) for x in gc[0].values())
        d_grad = max(float((gg[0][n] - x).abs().max()) for n, x in gc[0].items()) / gmax
        agree = param_agreement(ng.state_dict(), nc.state_dict(), gc, lr)
        print(f"  (b) {kind}, 2 f32 steps at test width, cuda against cpu: losses cpu "
              f"{[round(x, 6) for x in lc]}, relative |d| {d_loss:.2e} (< {TRAIN_LOSS_RTOL}); crops "
              f"max |d| {d_crop:.2e}, targets and poses {d_tgt:.2e} (< 1e-5); first-step gradients "
              f"{d_grad:.2e} of the largest (< 1e-4); parameters: resolved share {agree[0]:.4f} "
              f"(>= {TRAIN_MIN_RESOLVED}), resolved max |d| {agree[1]:.2e} (<= {TRAIN_RESOLVED_TOL}) "
              f"and any max |d| {agree[2]:.3f} (<= {TRAIN_ADAM_REACH}) of lr x steps")
        ok &= d_loss < TRAIN_LOSS_RTOL and d_tgt < 1e-5 and d_grad < 1e-4 and agreement_ok(*agree)
        t.update({f"train_slice_{kind}_loss_rel": d_loss, f"train_slice_{kind}_crop_max_abs": d_crop,
                  f"train_slice_{kind}_resolved_share": agree[0],
                  f"train_slice_{kind}_resolved_max_lr_steps": agree[1],
                  f"train_slice_{kind}_max_lr_steps": agree[2]})
    if not ok:
        raise AssertionError("the training slice on the card disagrees with the CPU plain path")
    return t


def _count_syncs(fn):
    """Runs fn under torch.cuda.set_sync_debug_mode("warn"); returns, for
    each synchronising operation it reported, the innermost frame of this
    repository that led to it (file:line function)."""
    import os
    import traceback
    import warnings

    import torch

    root = os.path.dirname(os.path.abspath(__file__))
    where = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):  # not torch's prototype notice
            ours = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(root)]
            f = ours[-1] if ours else None
            where.append(f"{os.path.relpath(f.filename, root)}:{f.lineno} {f.name}" if f
                         else f"{filename}:{lineno}")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return where


def _full_width_training():
    """(c) the configuration of PERF.md section 4 in bf16: TRAIN_STEPS
    refiner and scorer steps, each batch made on the card; launches per
    batch and step, times, memory, a trace, and the host synchronisations."""
    import torch

    from foundationpose_torch.datasets import make_refiner_batch, make_scorer_batch
    from foundationpose_torch.meshio import compute_mesh_diameter
    from foundationpose_torch.models import init_refine_net, init_score_net, training
    from foundationpose_torch.ops import attention_cuda, raster_cuda
    from foundationpose_torch.pipeline import RefinerCfg, ScorerCfg, make_mesh_tensors

    mesh = _bench_mesh()
    mt = make_mesh_tensors(mesh, device="cuda")
    K = torch.as_tensor(K_FULL, device="cuda")
    diam = torch.tensor(compute_mesh_diameter(mesh.vertices), dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    tcfg = training.TrainCfg()  # Adam, lr 1e-4, l2, bf16
    rcfg, scfg = RefinerCfg(), ScorerCfg(mode="network")
    nets = {"refiner": init_refine_net(rcfg.net, torch.Generator().manual_seed(3)),
            "scorer": init_score_net(scfg.net, torch.Generator().manual_seed(4))}
    opts = {k: training.make_optimizer(tcfg, v, "cuda") for k, v in nets.items()}
    make = {"refiner": lambda: make_refiner_batch(gen, mt, K, rcfg, diam, n=TRAIN_N),
            "scorer": lambda: make_scorer_batch(gen, mt, K, scfg, diam, n=TRAIN_N,
                                                frame_hw=(480, 640))}
    step = {"refiner": lambda b: training.refine_train_step(nets["refiner"], opts["refiner"], tcfg, b),
            "scorer": lambda b: training.score_train_step(nets["scorer"], opts["scorer"], tcfg, b)}

    def counted(fn, *args):
        torch.cuda.synchronize()
        raster_cuda.KERNEL.launches = attention_cuda.KERNEL.launches = 0
        out = fn(*args)
        torch.cuda.synchronize()
        return out, (raster_cuda.KERNEL.launches, attention_cuda.KERNEL.launches)

    t, losses, per = {}, {}, {}
    counts = {"raster": 0, "attention": 0}
    for kind in ("refiner", "scorer"):
        losses[kind], per[kind] = [], []
        for _ in range(TRAIN_STEPS):
            b, kb = counted(make[kind])
            loss, ks = counted(step[kind], b)
            losses[kind].append(loss)
            per[kind].append((kb, ks))
            counts["raster"] += kb[0] + ks[0]
            counts["attention"] += kb[1] + ks[1]
        if kind == "refiner":  # (a) every trained tensor of this bf16 step has a gradient
            sd = nets[kind].state_dict(keep_vars=True)
            bad = [n for n, x in sd.items() if not n.endswith("num_batches_tracked")
                   and (x.grad is None or not torch.isfinite(x.grad).all())]
            if bad:
                raise AssertionError(f"full-width refiner step: no finite gradient for {bad[:4]}")
        ls = [float(x) for x in losses[kind]]
        print(f"  (c) {kind} bf16 n={TRAIN_N}: losses {[round(x, 5) for x in ls]}; launches per "
              f"(batch, step) as (K1, K2): {per[kind]}")
        if not np.isfinite(ls).all():
            raise AssertionError(f"{kind} losses are not finite")
        if any(kb != (2, 0) or ks != (0, 2) for kb, ks in per[kind]):
            raise AssertionError(f"{kind}: a batch must launch K1 twice and a step K2 twice")
        t[f"train_{kind}_loss_first"], t[f"train_{kind}_loss_last"] = ls[0], ls[-1]

    batches = {k: make[k]() for k in nets}
    tw = _wall_in_turns({f"{k}_{w}": (make[k] if w == "batch" else (lambda k=k: step[k](batches[k])))
                         for k in nets for w in ("batch", "step")}, 10)
    for kind in nets:
        t[f"train_{kind}_batch_ms"] = tw[f"{kind}_batch"]
        t[f"train_{kind}_step_ms"] = tw[f"{kind}_step"]
        t[f"train_{kind}_samples_per_s"] = TRAIN_N / (tw[f"{kind}_batch"] + tw[f"{kind}_step"]) * 1e3
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()  # the nets, Adam's moments, earlier phases
        torch.cuda.reset_peak_memory_stats()
        step[kind](make[kind]())
        torch.cuda.synchronize()
        t[f"train_{kind}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        t[f"train_{kind}_peak_above_resident_gb"] = (torch.cuda.max_memory_allocated() - resident) / 1e9
        t.update(_profile(f"train_{kind}_step", lambda k=kind: float(step[k](batches[k])), 3))
    syncs = _count_syncs(lambda: [step[k](make[k]()) for k in nets])
    t["train_syncs_per_batch_and_step"] = len(syncs)
    print(f"  (c) host synchronisations in one batch + step of each net: {len(syncs)} "
          f"{sorted(set(syncs))[:6]}")
    return counts, t


def _recipe_draws(seed, n, scene_seed=None):
    """The draws make_refiner_batch (scene_seed None) or make_scorer_batch
    makes from an int key on the CPU: the batches of
    tests/test_torch_training.py's convergence classes."""
    import torch

    from foundationpose_torch.datasets import synthetic

    g = torch.Generator().manual_seed(seed)
    if scene_seed is None:
        return {"pairs": synthetic._pair_draws(g, n)}
    return {"scene": synthetic._pair_draws(torch.Generator().manual_seed(scene_seed), 1),
            "dw": synthetic._normal(g, (n, 3)), "dt": synthetic._normal(g, (n, 3))}


def _train_tiny_nets(test_batches=True):
    """(d) tests/test_torch_training.py::train_estimator_nets on the card:
    the refiner (width 8, 64 px, 250 steps, rot_sigma 0.25, trans_sigma
    0.05, 16 pairs), then the scorer (250 steps of 16 hypotheses, 320x240,
    the scene pinned by seed 42). test_batches: on that test's batches
    (`_recipe_draws`, moved to the card); else on the card generator's
    draws from the same seeds. Returns the nets, their losses and the
    scene's gt pose."""
    import torch

    from foundationpose_torch.datasets import make_refiner_batch, make_scorer_batch
    from foundationpose_torch.models import (
        RefineNetCfg, ScoreNetCfg, init_refine_net, init_score_net, training)
    from foundationpose_torch.pipeline import RefinerCfg, ScorerCfg, make_mesh_tensors

    mt = make_mesh_tensors(_box(), device="cuda")
    K = torch.as_tensor(K_TEST, device="cuda")
    diam = torch.tensor(BOX_DIAMETER, device="cuda")
    to = lambda d: {k: v.to("cuda") if torch.is_tensor(v) else to(v) for k, v in d.items()}  # noqa: E731

    def key(seed, n, scene=None):  # -> the batch maker's key and draws
        return (None, to(_recipe_draws(seed, n, scene))) if test_batches else (seed, None)

    rcfg = RefinerCfg(net=RefineNetCfg(base_width=8), compute_dtype="float32", input_res=64)
    refiner = init_refine_net(rcfg.net, torch.Generator().manual_seed(7))
    tcfg = training.TrainCfg(lr=1e-3, compute_dtype="float32")
    opt = training.make_optimizer(tcfg, refiner, "cuda")
    for step in range(250):
        k, d = key(100 + step, 16)
        b = make_refiner_batch(k, mt, K, rcfg, diam, n=16, rot_sigma=0.25, trans_sigma=0.05, draws=d)
        rloss = training.refine_train_step(refiner, opt, tcfg, b)
    scfg = ScorerCfg(net=ScoreNetCfg(base_width=8), input_res=64, mode="network",
                     compute_dtype="float32")
    scorer = init_score_net(scfg.net, torch.Generator().manual_seed(8))
    stcfg = training.TrainCfg(lr=3e-4, compute_dtype="float32")
    sopt = training.make_optimizer(stcfg, scorer, "cuda")

    def group(seed):
        k, d = key(seed, 16, 42)
        return make_scorer_batch(k, mt, K, scfg, diam, n=16, frame_hw=(240, 320),
                                 scene_seed=None if test_batches else 42, draws=d)

    slosses = [training.score_train_step(scorer, sopt, stcfg, group(5000 + step))
               for step in range(250)]
    gt = group(77)["gt"].cpu().numpy()
    return rcfg, refiner, scfg, scorer, float(rloss), [float(x) for x in slosses], gt


def _trained_registration(test_batches=True):
    """(d) the bars of tests/test_training.py::TestTrainedNetworkRegistration
    with nets trained on the card (`_train_tiny_nets`): the scorer's loss
    falls by more than 0.15 and the network-scored register is within 6
    cm ADD-S. cuDNN runs deterministic here: this training is chaotic,
    and a run that another choice of convolution algorithm can change is
    no test. Returns the numbers and whether the bars are met."""
    import dataclasses

    import torch

    from foundationpose_torch.pipeline import EstimatorCfg, FoundationPose
    from foundationpose_torch.utils.metrics import adds_err

    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        t0 = time.perf_counter()
        rcfg, refiner, scfg, scorer, rloss, slosses, gt = _train_tiny_nets(test_batches)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    box = _box()
    frame = _frame_at(box, gt, (240, 320), K_TEST)

    def register(mode, fast=False):
        cfg = EstimatorCfg(refiner=rcfg, scorer=dataclasses.replace(scfg, mode=mode))
        est = FoundationPose(mesh=box, cfg=cfg.fast_register() if fast else cfg,
                             refiner_params=refiner,
                             scorer_params=scorer if mode == "network" else None, device="cuda")
        est.gt_pose = gt
        pose = est.register(K_TEST, *frame, iteration=5)
        errs = est.compute_add_err_to_gt_pose(est.poses.cpu().numpy())
        return adds_err(pose, gt, box.vertices), int(np.where(np.argsort(errs) == 0)[0][0])

    (err_net, rank), (err_depth, _r), (err_fast, _f) = (
        register("network"), register("depth"), register("network", fast=True))
    drop = float(np.mean(slosses[:20]) - np.mean(slosses[-20:]))
    name = "the CPU test's batches" if test_batches else "the card generator's draws"
    print(f"  (d) on {name}, trained in {train_s:.1f} s: refiner loss {rloss:.4f}, scorer loss "
          f"{np.mean(slosses[:20]):.4f} -> {np.mean(slosses[-20:]):.4f} (drop {drop:.4f} > 0.15); "
          f"ADD-S network {err_net * 1e3:.2f} mm (< 60), depth {err_depth * 1e3:.2f} mm, "
          f"winner's rank by ADD {rank}, funneled {err_fast * 1e3:.2f} mm "
          f"(gap {(err_fast - err_net) * 1e3:+.2f} mm); gt t {np.round(gt[:3, 3], 4)}")
    tag = "trained" if test_batches else "card_draws"
    return {f"{tag}_s": train_s, f"{tag}_scorer_loss_drop": drop, f"{tag}_adds_network_m": err_net,
            f"{tag}_adds_depth_m": err_depth, f"{tag}_winner_rank": rank,
            f"{tag}_funneled_gap_m": err_fast - err_net}, drop > 0.15 and err_net < 0.06


def _frame_at(mesh, pose, hw, K):
    """(rgb u8, depth, mask) of mesh rendered by the port at `pose` on the card."""
    import torch

    from foundationpose_torch.ops.rasterizer import render_mesh

    T = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    out = render_mesh(T(mesh.vertices), torch.as_tensor(mesh.faces, device="cuda"), T(pose[None]),
                      T(K), out_hw=hw, vertex_color=T(mesh.vertex_colors / 255.0),
                      vnormals=T(mesh.vertex_normals))
    return ((out.color[0].cpu().numpy() * 255).astype(np.uint8),
            out.depth[0].cpu().numpy().astype(np.float32),
            out.mask[0].cpu().numpy().astype(np.uint8))


def training_phase():
    """The training path: (a) the differentiable attention core and one
    full-width RefineNet's gradients, (b) a small f32 slice on the card
    against the CPU plain path, (c) the full-width bf16 configuration
    (launches, times, memory, a trace, host synchronisations), (d) tiny
    nets trained on the card pass the JAX test's registration bars.
    Returns the launch counts of (c) and the times."""
    worst = _core_checks()
    _refiner_step_grads()
    t = {f"train_core_{k}_max_abs": v for k, v in worst.items()}
    t.update(_train_slice_check())
    counts, tc = _full_width_training()
    t.update(tc)
    td, ok = _trained_registration()
    t.update(td)
    # Reported, not gated: the same seeds on the card's generator draw a
    # scene whose scorer the recipe does not train (PERF.md, section 6).
    t.update(_trained_registration(test_batches=False)[0])
    _print_times(t)
    if not ok:
        raise AssertionError("training on the card misses the JAX test's bars")
    return counts, t


# ------------------------------------------- parallel, quad layout, tooling


def _sharded_register_check(counts):
    """(a) FoundationPose(device_mesh=) over 2 shards of the card against the
    unsharded estimator at the main path's workload in f32 (the network
    scorer spread on the register's crops, so that its order is not
    rounding noise): the same order and poses within 1e-4, full and
    funneled (fast_register), unpacked and packed; K1 and K2 counted per
    register; times in turns."""
    import dataclasses

    import torch

    from foundationpose_torch.geometry.projection import depth_to_xyz_map
    from foundationpose_torch.ops import attention_cuda, raster_cuda
    from foundationpose_torch.parallel import make_device_mesh
    from foundationpose_torch.pipeline import EstimatorCfg, FoundationPose, RasterCfg, RefinerCfg, ScorerCfg
    from foundationpose_torch.pipeline.crops import make_crop_inputs

    mesh = _bench_mesh()
    raster = RasterCfg(cull_backfaces=True)
    base = EstimatorCfg(refiner=RefinerCfg(raster=raster, compute_dtype="float32"),
                        scorer=ScorerCfg(mode="network", raster=raster, compute_dtype="float32"),
                        **UNPACKED)
    frame = _frame(mesh, (0.02, -0.01, 0.9), (480, 640), K_FULL, "cuda")
    mesh2 = make_device_mesh(devices=["cuda:0", "cuda:0"])
    one = _estimator(mesh, base, "cuda")
    one.register(K_FULL, *frame, iteration=5)
    sc = base.scorer
    Kt, rgb_t, depth_t = one._frame(K_FULL, frame[0], frame[1])
    with torch.no_grad():
        a, b, _ = make_crop_inputs(one.mesh_tensors, one.poses, Kt, rgb_t, depth_to_xyz_map(depth_t, Kt),
                                   one._diam, input_res=sc.input_res, crop_ratio=sc.crop_ratio,
                                   normalize_xyz=sc.normalize_xyz, invalid_z=sc.xyz_invalid_z, raster=raster)
        spread_scorer(one.scorer, a, b)
    del a, b
    t = {}
    for name, cfg in (("full", base), ("funneled", base.fast_register()),
                      ("packed", dataclasses.replace(base, register_pack=True, register_roi=True))):
        e1 = FoundationPose(mesh=mesh, cfg=cfg, refiner_params=one.refiner, scorer_params=one.scorer,
                            device="cuda")
        e2 = FoundationPose(mesh=mesh, cfg=cfg, refiner_params=one.refiner, scorer_params=one.scorer,
                            device_mesh=mesh2)
        p1 = e1.register(K_FULL, *frame, iteration=5)
        torch.cuda.synchronize()
        raster_cuda.KERNEL.launches = attention_cuda.KERNEL.launches = 0
        p2 = e2.register(K_FULL, *frame, iteration=5)
        torch.cuda.synchronize()
        k1, k2 = raster_cuda.KERNEL.launches, attention_cuda.KERNEL.launches
        counts["raster"] += k1
        counts["attention"] += k2
        same = bool(torch.equal(e1.order, e2.order))
        d_pose = float(np.abs(p1 - p2).max())
        d_all = float((e1.poses - e2.poses).abs().max())
        gap = float(e1.scores[0] - e1.scores[1])
        print(f"  (a) {name} register, 2 shards of one card against 1: {len(e1.order)} hypotheses, order "
              f"equal {same}, pose max |d| {d_pose:.2e}, all poses {d_all:.2e}, top-2 score gap {gap:.3g}; "
              f"K1 {k1} K2 {k2} launches a sharded register")
        if not (same and d_pose < 1e-4 and d_all < 1e-4) or k1 < 12 or k2 < 12:
            raise AssertionError(f"the {name} sharded register disagrees with the unsharded one")
        if name != "packed":
            tt = _wall_in_turns({f"register_{name}_f32_ms": lambda: e1.register(K_FULL, *frame, iteration=5),
                                 f"register_{name}_f32_2shards_ms":
                                     lambda: e2.register(K_FULL, *frame, iteration=5)}, 3)
            t.update(tt)
            t[f"register_{name}_2shards_k1_launches"] = k1
            t[f"register_{name}_2shards_k2_launches"] = k2
    return t, one


def _dp_check(counts):
    """(b) 2 refiner and 2 scorer steps of `_train_slice` data-parallel
    over 2 shards of the card against the unsharded steps on the card,
    from one init and the same draws: losses within 1e-5 relative,
    parameters by param_agreement."""
    from foundationpose_torch.models import training
    from foundationpose_torch.ops import attention_cuda
    from foundationpose_torch.parallel import DATA_AXIS, make_device_mesh

    draws, nets0 = _train_slice_inputs()
    mesh = make_device_mesh(axis=DATA_AXIS, devices=["cuda:0", "cuda:0"])
    lr = training.TrainCfg().lr
    t = {}
    for kind, net0 in nets0.items():
        l1, _b1, n1, g1 = _train_slice("cuda", net0, kind, draws[kind])
        k2 = attention_cuda.KERNEL.launches
        l2, _b2, n2, _g2 = _train_slice("cuda", net0, kind, draws[kind], mesh=mesh)
        k2 = attention_cuda.KERNEL.launches - k2
        counts["attention"] += k2
        d_loss = max(abs(a - b) / abs(a) for a, b in zip(l1, l2))
        agree = param_agreement(n2.state_dict(), n1.state_dict(), g1, lr)
        print(f"  (b) {kind}, 2 data-parallel f32 steps over 2 shards of one card against 2 unsharded: "
              f"losses {[round(x, 6) for x in l1]}, relative |d| {d_loss:.2e} (< 1e-5); parameters: "
              f"resolved share {agree[0]:.4f}, resolved max |d| {agree[1]:.2e}, any {agree[2]:.3f} of lr x "
              f"steps; K2 {k2} launches")
        if not (d_loss < 1e-5 and agreement_ok(*agree)) or k2 < 2:
            raise AssertionError(f"the data-parallel {kind} step disagrees with the unsharded one")
        t[f"dp_{kind}_loss_rel"] = d_loss
    return t


DP_STEPS = 2
# First-step gradients of the full-width data-parallel step against the
# unsharded one, as a share of the largest: a shard left out of the sum or
# weighted wrong moves them by ~0.5; the rounding that the spread scorer's
# attention amplifies reaches 7.6e-5 on an NVIDIA H100 80GB HBM3 at 700 W
# (f32 convolutions of 32 and of 64 samples round otherwise).
DP_FULL_GRAD_TOL = 1e-3


def _dp_full_width(counts):
    """(b) the training workload of phase 15 (c) (full-width nets, batch
    64: 64 pairs, or one 64-hypothesis group) data-parallel over 2 shards
    of the card against the unsharded step. Gated in f32: DP_STEPS steps of
    each net from one init on the same batches, losses within 1e-5
    relative, first-step gradients within DP_FULL_GRAD_TOL of the largest,
    K2 launched on each shard; parameters by param_agreement, reported.
    Measured in bf16 (TrainCfg(), the workload's): the data-parallel step
    in turns with the unsharded one, the first step's loss against it, the
    peak memory of each above what is resident, and a replica's copy (the
    deepcopy that replicate_tree makes for each other card, each step).

    A random full-width scorer gives the 64 hypotheses equal logits, and
    the group's gradient through its near-uniform cross attention cancels
    to rounding noise; `spread_scorer` at scale 30 and gain 10 (milder than
    (a)'s 300 and 100, whose attention amplifies rounding to 2.0e-4 of the
    largest gradient on the same card) gives it a gradient to compare."""
    import copy

    import torch

    from foundationpose_torch.datasets import make_refiner_batch, make_scorer_batch
    from foundationpose_torch.meshio import compute_mesh_diameter
    from foundationpose_torch.models import init_refine_net, init_score_net, training
    from foundationpose_torch.ops import attention_cuda
    from foundationpose_torch.parallel import DATA_AXIS, make_device_mesh
    from foundationpose_torch.pipeline import RefinerCfg, ScorerCfg, make_mesh_tensors

    mesh = make_device_mesh(axis=DATA_AXIS, devices=["cuda:0", "cuda:0"])
    bench = _bench_mesh()
    mt = make_mesh_tensors(bench, device="cuda")
    K = torch.as_tensor(K_FULL, device="cuda")
    diam = torch.tensor(compute_mesh_diameter(bench.vertices), dtype=torch.float32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    rcfg, scfg = RefinerCfg(), ScorerCfg(mode="network")
    batches = {"refiner": [make_refiner_batch(gen, mt, K, rcfg, diam, n=TRAIN_N) for _ in range(DP_STEPS)],
               "scorer": [make_scorer_batch(gen, mt, K, scfg, diam, n=TRAIN_N, frame_hw=(480, 640))
                          for _ in range(DP_STEPS)]}
    nets0 = {"refiner": init_refine_net(rcfg.net, torch.Generator().manual_seed(3)).cuda(),
             "scorer": init_score_net(scfg.net, torch.Generator().manual_seed(4)).cuda()}
    spread_scorer(nets0["scorer"], batches["scorer"][0]["A"], batches["scorer"][0]["B"], scale=30.0, gain=10.0)
    steps = {"refiner": training.refine_train_step, "scorer": training.score_train_step}
    k2_want = {"refiner": 2 * mesh.size, "scorer": mesh.size + 1}  # two heads a shard; trunks + the group
    f32, bf16 = training.TrainCfg(compute_dtype="float32"), training.TrainCfg()
    t = {}
    for kind, net0 in nets0.items():
        step = steps[kind]
        runs, k2 = {}, []
        for name, m in (("one", None), ("dp", mesh)):
            net = copy.deepcopy(net0)
            opt = training.make_optimizer(f32, net, "cuda")
            losses, grads = [], []
            for b in batches[kind]:
                torch.cuda.synchronize()
                launched = attention_cuda.KERNEL.launches
                losses.append(float(step(net, opt, f32, b, mesh=m)))
                if m is not None:
                    k2.append(attention_cuda.KERNEL.launches - launched)
                grads.append({n: x.grad.detach().cpu() for n, x in net.state_dict(keep_vars=True).items()
                              if x.grad is not None})
            runs[name] = (losses, net, grads)
            del opt
        (l1, n1, g1), (l2, n2, g2) = runs["one"], runs["dp"]
        counts["attention"] += sum(k2)
        d_loss = max(abs(a - b) / abs(a) for a, b in zip(l1, l2))
        gmax = max(float(x.abs().max()) for x in g1[0].values())
        d_grad = max(float((g2[0][n] - x).abs().max()) for n, x in g1[0].items()) / gmax
        agree = param_agreement(n2.state_dict(), n1.state_dict(), g1, f32.lr)
        del runs, n1, n2, g1, g2

        nets = {name: copy.deepcopy(net0) for name in ("one", "dp")}
        opts = {name: training.make_optimizer(bf16, v, "cuda") for name, v in nets.items()}
        b = batches[kind][0]
        run = {"one": lambda: step(nets["one"], opts["one"], bf16, b),
               "dp": lambda: step(nets["dp"], opts["dp"], bf16, b, mesh=mesh)}
        lb = {name: float(fn()) for name, fn in run.items()}  # both from net0
        d_bf16 = abs(lb["dp"] - lb["one"]) / abs(lb["one"])
        peak = {}
        for name, fn in run.items():
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            torch.cuda.synchronize()
            peak[name] = (torch.cuda.max_memory_allocated() - resident) / 1e9
        tw = _wall_in_turns({"dp": run["dp"], "one": run["one"],
                             "copy": lambda: copy.deepcopy(nets["dp"])}, 10)
        print(f"  (b) full-width {kind}, {DP_STEPS} f32 steps of batch {TRAIN_N} over 2 shards of one card "
              f"against unsharded: losses {[round(x, 6) for x in l1]}, relative |d| {d_loss:.2e} (< 1e-5); "
              f"first-step gradients {d_grad:.2e} of the largest (< {DP_FULL_GRAD_TOL}); parameters "
              f"(reported): resolved share {agree[0]:.4f}, resolved max |d| {agree[1]:.2e}, any "
              f"{agree[2]:.3f} of lr x steps; K2 {k2} launches a step (want {k2_want[kind]}); bf16 step "
              f"{tw['dp']:.2f} ms against {tw['one']:.2f} ms unsharded, first loss relative |d| {d_bf16:.2e}, "
              f"peak above resident {peak['dp']:.3f} / {peak['one']:.3f} GB, a replica's copy "
              f"{tw['copy']:.2f} ms")
        if not (d_loss < 1e-5 and d_grad < DP_FULL_GRAD_TOL) or any(k != k2_want[kind] for k in k2) \
                or not np.isfinite(d_bf16):
            raise AssertionError(f"the full-width data-parallel {kind} step disagrees with the unsharded one")
        t.update({f"dp_full_{kind}_loss_rel": d_loss, f"dp_full_{kind}_grad_rel": d_grad,
                  f"dp_full_{kind}_resolved_share": agree[0],
                  f"dp_full_{kind}_resolved_max_lr_steps": agree[1], f"dp_full_{kind}_max_lr_steps": agree[2],
                  f"dp_full_{kind}_k2_launches_per_step": k2[0],
                  f"dp_full_{kind}_bf16_step_ms": tw["dp"], f"dp_full_{kind}_bf16_unsharded_step_ms": tw["one"],
                  f"dp_full_{kind}_bf16_first_loss_rel": d_bf16,
                  f"dp_full_{kind}_bf16_peak_above_resident_gb": peak["dp"],
                  f"dp_full_{kind}_bf16_unsharded_peak_above_resident_gb": peak["one"],
                  f"dp_full_{kind}_replica_copy_ms": tw["copy"]})
        del nets, opts, run
    return t


def _quad_check(counts, seg):
    """(c) 3 "quad" NeRF steps of the small slice, card against CPU, options
    off and on; then K3 on the stream of one full-width "quad" step
    (NerfCfg defaults on the bench mesh's views): K3 against its plain
    version, timed in turns with it and index_add_ (`k3_on_step`)."""
    import torch

    from foundationpose_torch.nerf import NerfCfg
    from foundationpose_torch.ops import segment_add_cuda

    for options in ({}, SMALL_NERF_OPTIONS):
        k3, k4 = nerf_slice("quad", options)
        counts["k3"] += k3
        if k3 < 3 or k4:
            raise AssertionError(f"quad steps launched K3 {k3} and K4 {k4} times")
    views = _reference_views(_bench_mesh(), (480, 640), K_FULL, "cuda")
    cfg = NerfCfg(grid_layout="quad")
    runner = _nerf_runner(cfg, K_FULL, views, "cuda")
    launched = segment_add_cuda.K3.launches
    loss = float(runner.train_step(torch.Generator(device="cuda").manual_seed(1))[0])
    k3 = segment_add_cuda.K3.launches - launched
    counts["k3"] += k3
    print(f"  (c) a full-width quad step: loss {loss:.6f}, K3 {k3} launch")
    if k3 != 1 or not np.isfinite(loss):
        raise AssertionError("the full-width quad step")
    seg.update(k3_on_step(runner, "k3_quad"))
    if seg["k3_quad_updates"] != cfg.n_rand * (cfg.n_samples + cfg.n_samples_around_depth) * cfg.num_levels * 2:
        raise AssertionError(f"quad stream of {seg['k3_quad_updates']} updates")


def _tooling_check(tmp_dir):
    """(d) a debug=3 register of the small slice on the card and on the
    CPU: the files exist, the canvases within 1 uint8 level; (e)
    warp_perspective(_batch) card against CPU; (f) a profiling.trace() of
    one full-width register names K1 and K2."""
    import os

    import torch

    from foundationpose_torch.ops import warp_perspective, warp_perspective_batch
    from foundationpose_torch.utils.vis import read_rgb

    box, cfg, frame = _small_scene()
    canv, order = {}, {}
    for dev in ("cpu", "cuda"):
        d = os.path.join(tmp_dir, dev)
        est = _estimator(box, cfg, dev, head_scale=0.05)
        est.debug, est.debug_dir = 3, d
        est.register(K_SMALL, *frame, iteration=2)
        files = sorted(os.listdir(d))
        if files != ["model_tf.obj", "vis_refiner_iter0.png", "vis_refiner_iter1.png", "vis_score.png"]:
            raise AssertionError(f"debug dumps on {dev}: {files}")
        canv[dev] = [read_rgb(os.path.join(d, f)).astype(np.int32) for f in files[1:]]
        order[dev] = est.order[:16].cpu().numpy()
    # A canvas row is [rgb A | depth A | rgb B | depth B] (32 px panels,
    # 2 px apart, 4 px margin; rows 40 px apart). A pixel is off when its
    # rgb panel is more than 1 level away, or its depth panel more than one
    # step of the JET colormap (4 levels). K1 against the brute path may
    # cover an edge pixel of a rendered crop otherwise (its criterion,
    # `render_criterion`, admits such pixels), and the canvas shows that
    # pixel as it is: at most 1e-3 of the panel pixels may be off.
    # vis_score's rows are the top 16 by score: near-tied depth scores may
    # rank two hypotheses the other way on the card, so its rows are
    # compared where both devices put the same hypothesis (the winner's
    # first row always).
    res = cfg.refiner.input_res
    same = order["cpu"] == order["cuda"]
    if not same[0]:
        raise AssertionError("the debug register's winner differs between the card and the CPU")
    n_off = n_px = d_max = 0
    for name, a, b in zip(files[1:], canv["cpu"], canv["cuda"]):
        diff = np.abs(a - b).max(axis=2)
        if name == "vis_score.png":
            row = (np.arange(diff.shape[0]) - 4) // (res + 8)
            diff = diff[np.isin(row, np.flatnonzero(same))]
        panel = (np.arange(diff.shape[1]) - 6) // (res + 2)
        depth = ((panel == 1) | (panel == 3))[None]
        n_off += int((diff > np.where(depth, 4, 1)).sum())
        n_px += diff.size
        d_max = max(d_max, int(diff.max()))
    print(f"  (d) debug=3 register, card against CPU: {len(canv['cuda'])} canvases + model_tf.obj, top-16 "
          f"rows in the same order {int(same.sum())} of {len(same)}; pixels off (rgb > 1 level, depth > one "
          f"JET step) {n_off} of {n_px} (share <= 1e-3), max |d| {d_max}")
    if n_off > 1e-3 * n_px:
        raise AssertionError("the debug canvases on the card disagree with the CPU's")

    g = torch.Generator().manual_seed(4)
    img = torch.rand((480, 640, 3), generator=g)
    imgs = torch.rand((4, 120, 160, 3), generator=g)
    crops = torch.tensor([[[0.35, 0, -40.0], [0, 0.35, -30.0], [0, 0, 1]], [[1.7, 0, -2.0], [0, 1.3, 0.5], [0, 0, 1]],
                          [[0.5, 0, 3.0], [0, 0.75, 1.0], [0, 0, 1]], [[2.0, 0, -4.0], [0, 2.0, -6.0], [0, 0, 1]]])
    homog = crops.clone()
    homog[:, 0, 1], homog[:, 2, 0] = 0.05, 1e-4
    worst = {}
    for name, fn, src in (("warp_perspective", warp_perspective, img), ("warp_perspective_batch",
                                                                       warp_perspective_batch, imgs)):
        for mode in ("bilinear", "nearest"):
            for kind, M in (("crops", crops), ("homographies", homog)):
                want = fn(src, M, (160, 160), mode=mode)
                got = fn(src.cuda(), M.cuda(), (160, 160), mode=mode).cpu()
                d = float((got - want).abs().max())
                worst[(name, mode, kind)] = d
                # Crop transforms are inverted in closed form, with the CPU's
                # arithmetic: nearest exact, bilinear within 1e-5. A general
                # homography is inverted by torch.linalg.inv, which rounds
                # otherwise on the card: a source point ~1e-6 relative apart
                # on a 640 px frame moves a bilinear sample of this noise
                # image by up to ~1e-3.
                exact = mode == "nearest" and kind == "crops"
                tol = 1.0 if mode == "nearest" else (1e-5 if kind == "crops" else 1e-3)
                if (exact and d != 0) or d > tol:
                    raise AssertionError(f"{name} {mode} {kind} on the card: max |d| {d}")
                if mode == "nearest" and kind == "homographies":
                    worst[(name, mode, kind)] = float((got != want).any(-1).float().mean())
    print("  (e) " + ", ".join(f"{n} {m} {k} {'mismatched px share' if m == 'nearest' and k == 'homographies' else 'max |d|'} "
                               f"{v:.2e}" for (n, m, k), v in worst.items()))
    if max(v for (n, m, k), v in worst.items() if m == "nearest" and k == "homographies") > 1e-3:
        raise AssertionError("nearest warps of general homographies on the card disagree with the CPU's")


def parallel_quad_tooling_phase():
    """(a) the hypothesis-sharded register, (b) data-parallel train steps,
    (c) the "quad" hash-grid layout and K3 on its stream, (d) debug dumps,
    (e) warp_perspective, (f) a profiling trace. Two shards of one card
    measure the split's overhead, not scaling. Returns (launch counts,
    times, K3 results)."""
    import os
    import tempfile

    import torch

    from foundationpose_torch.utils import profiling

    counts = {"raster": 0, "attention": 0, "k3": 0}
    seg = {}
    t, one = _sharded_register_check(counts)
    t.update(_dp_check(counts))
    t.update(_dp_full_width(counts))
    _quad_check(counts, seg)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile")
    with tempfile.TemporaryDirectory() as tmp:
        _tooling_check(tmp)
    frame = _frame(_bench_mesh(), (0.02, -0.01, 0.9), (480, 640), K_FULL, "cuda")
    with profiling.trace(out_dir, name="register_f32"):
        one.register(K_FULL, *frame, iteration=5)
    text = open(os.path.join(out_dir, "register_f32.json")).read()
    named = {k: tag in text for k, tag in (("K1", "raster_kernel"), ("K2", "mha_"))}
    print(f"  (f) profiling.trace of one register: {out_dir}/register_f32.json, "
          f"{len(text) / 1e6:.1f} MB, names {named}")
    if not all(named.values()):
        raise AssertionError(f"the register's trace does not name every kernel: {named}")
    with profiling.stage_timer("register_f32"):
        one.register(K_FULL, *frame, iteration=5)
    t["stage_timer_register_f32_ms"] = profiling.timing_report(reset=True)["register_f32"]["mean_ms"]
    torch.cuda.synchronize()
    _print_times(t)
    _print_times({k: v for k, v in seg.items() if k.startswith("k3_quad")})
    return counts, t, seg


PROFILE_STEPS = 10


def _device_time_us(trace_path):
    """From a chrome trace written by torch.profiler: the union of the
    device activity intervals (kernels, memsets, copies), their count, and
    each kernel name's summed duration."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    acts = [e for e in events if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")]
    busy, end = 0.0, -np.inf
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in acts):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_kernel = {}
    for e in acts:
        if e["cat"] == "kernel":
            by_kernel[e["name"]] = by_kernel.get(e["name"], 0.0) + e["dur"]
    return busy, len(acts), by_kernel


def _profile(name, fn, n):
    """Where the time of `fn` (which ends by reading a result on the host)
    goes, in this run. n calls untraced; n calls under a CUDA-only trace
    (little host cost): the device's busy time, its idle share over the
    traced host wall time and the kernels that own the device time; then n
    calls under a CPU + CUDA trace: the operators that own it. All per call."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "profile")
    os.makedirs(out_dir, exist_ok=True)

    def calls():
        for _ in range(n):
            fn()

    calls()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls()
    plain_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    path = os.path.join(out_dir, f"{name}_cuda_only.json")
    prof.export_chrome_trace(path)
    busy_us, n_act, by_kernel = _device_time_us(path)
    if n_act == 0:
        raise AssertionError("the CUDA-only trace holds no device activity")
    busy_ms = busy_us / 1e3 / n
    print(f"  {name}: {plain_ms:.3f} ms untraced, {wall_ms:.3f} ms under the CUDA-only trace, "
          f"device busy {busy_ms:.3f} ms, {n_act / n:.0f} device activities per call")
    ranked = sorted(by_kernel.items(), key=lambda kv: kv[1], reverse=True)
    ours = ("raster_kernel", "face_box_kernel", "mha_", "seg_add")  # the port's kernels, always
    share = {f"{name}_{k}_device_ms": sum(us for kn, us in by_kernel.items() if tag in kn) / 1e3 / n
             for k, tag in (("k1", "raster_kernel"), ("k2", "mha_"), ("k3", "seg_add_planes"),
                            ("k4", "factored_seg_add"))}
    for rank, (k, us) in enumerate(ranked):
        if rank < 12 or any(o in k for o in ours):
            short = k.replace("void ", "").replace("at::native::", "").replace("(anonymous namespace)::", "")
            print(f"    kernel #{rank + 1} {short[:106]:106s} {us / 1e3 / n:8.3f} ms/call")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls()
    ops = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    for e in sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f"    op {e.key[:48]:48s} {e.self_device_time_total / 1e3 / n:8.3f} ms/call "
              f"{e.count / n:6.0f} calls/call")
    return {f"{name}_ms_untraced_{n}": plain_ms,
            f"{name}_ms_cuda_traced": wall_ms,
            f"{name}_device_activities": n_act / n,
            f"{name}_device_busy_ms": busy_ms,
            f"{name}_device_idle_share": 1.0 - busy_ms / wall_ms,
            **{k: v for k, v in share.items() if v > 0}}


def main():
    import torch  # noqa: F401  (fails fast without PyTorch)

    phase("environment", 120, env_phase)
    phase("build kernels", 400, build_phase)
    k1_err = phase("K1 tile rasterizer vs brute", 240, k1_phase)
    k2_err = phase("K2 attention vs plain", 120, k2_phase)
    seg = phase("K3, K4 segment-adds vs plain at the NeRF shapes", 240, k3_k4_phase)
    phase("small slice: card vs CPU plain path", 180, small_slice_phase)
    phase("small NeRF slice: card vs CPU plain path", 180, small_nerf_phase)
    counts, est, frame, n_hyp = phase("main path: register + 3 tracked frames", 300, main_path_phase)
    t = phase("timing", 300, timing_phase, est, frame, n_hyp)
    fn_counts, t_fn = phase("estimator completion: checkpoints, funneled register", 240,
                            completion_phase, est, frame)
    t.update(t_fn)
    del est
    vid_counts, t_vid = phase("video tracking: async, windows, chain, MultiTracker", 240, video_phase)
    t.update(t_vid)
    mf_counts, t_mf, mf = phase("model-free path: reconstruct, register, cuda layout", 420, model_free_phase)
    seg.update(phase("K3 on the stream of a captured cuda-layout step", 180, k3_real_phase, mf[1]))
    t.update(phase("model-free timing and step profile", 240, nerf_timing_phase, t_mf, *mf))
    ep_counts, t_ep, on_runner = phase("model-free entry points, every NeRF option, checkpoints and resume", 600,
                                       entry_point_phase, mf[2])
    t.update(t_ep)
    seg.update(phase("K3 on the second-order stream of an options-on step", 180, k3_second_order_phase,
                     on_runner))
    t.update(phase("options-on against options-off NeRF steps", 240, options_timing_phase, on_runner, mf[0]))
    del on_runner, mf
    tr_counts, t_tr = phase("training: differentiable core, slices, full width, trained nets", 420,
                            training_phase)
    t.update(t_tr)
    pq_counts, t_pq, seg_pq = phase("parallel, quad layout, tooling", 180, parallel_quad_tooling_phase)
    t.update(t_pq)
    seg.update(seg_pq)

    def entry(name, source, replaces, launches, err, key, times):
        return {"name": name, "route": "cuda", "source": f"foundationpose_torch/csrc/{source}",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": times[f"{key}_ms"], "plain_ms": times[f"{key}_plain_ms"],
                "bound_ms": times[f"{key}_bound_ms"], "bound_by": times[f"{key}_bound_by"],
                "library_ms": times[f"{key}_library_ms"]}

    k1_err = max(k1_err, t["k1_err_timed_shape"], t["k1_err_recon"])
    kernels = [
        entry("K1 tile rasterizer", "raster.cu", "foundationpose_tpu/ops/pallas_raster2.py:69",
              counts["raster"] + fn_counts["raster"] + vid_counts["raster"] + mf_counts["raster"]
              + ep_counts["raster"] + tr_counts["raster"] + pq_counts["raster"], k1_err, "k1", t),
        entry("K2 attention core", "attention.cu", "foundationpose_tpu/ops/attention.py:44",
              counts["attention"] + fn_counts["attention"] + vid_counts["attention"]
              + mf_counts["attention"] + ep_counts["attention"] + tr_counts["attention"]
              + pq_counts["attention"], max(k2_err, t["train_core_bfloat16_max_abs"]), "k2", t),
        # K3's times are those of the captured "cuda"-layout step's stream;
        # the synthetic stream's (random rows, sentinels), the eikonal
        # loss's second-order stream's (its launches counted apart) and the
        # "quad" layout's stream's (8 planes; its launches counted apart)
        # stand beside them.
        dict(entry("K3 segment-add", "segment_add.cu", "foundationpose_tpu/ops/pallas_scatter.py:43",
                   mf_counts["k3"] + ep_counts["k3"],
                   max(seg["k3_err"], seg["k3_real_err"], seg["k3_eik_err"], seg["k3_quad_err"]),
                   "k3_real", seg),
             **{f"synthetic_{k}": seg[f"k3_{k}"] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
             second_order_launches=ep_counts["k3_second_order"], second_order_max_abs_err=seg["k3_eik_err"],
             **{f"second_order_{k}": seg[f"k3_eik_{k}"]
                for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
             quad_launches=pq_counts["k3"], quad_max_abs_err=seg["k3_quad_err"],
             **{f"quad_{k}": seg[f"k3_quad_{k}"] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}),
        entry("K4 factored segment-add", "segment_add.cu", "foundationpose_tpu/ops/pallas_scatter.py:275",
              mf_counts["k4"] + ep_counts["k4"], seg["k4_err"], "k4", seg),
    ]
    print(_CARD)
    print(json.dumps({"kernels": kernels}))
    import torch as _torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": _torch.cuda.get_device_name(0),
        "count": _torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()  # any exception ends the run with a traceback and exit code 1
