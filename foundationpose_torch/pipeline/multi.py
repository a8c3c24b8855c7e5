"""Batched multi-object tracking: every tracked object in one step.

Port of foundationpose_tpu/pipeline/multi.py. The reference tracks M
objects with M estimators, so each frame pays M frame preparations and
M small network forwards. `MultiTracker` runs one step per frame for
all of them:

* frame preparation (depth erode + bilateral filter, XYZ map) runs once
  per frame, or as one batch over the M windows in ROI mode;
* each object renders its own mesh into its crop through K1, with no
  padding across objects;
* the M crop pairs go through one batched RefineNet forward (K2 sees
  batch M), and the deltas apply batched with per-object diameters
  (per object for the "deepim" parameterization in ROI mode, whose
  deltas read each object's K);
* one upload and one result per frame for all objects; the (M, 4, 4)
  pose block chains on the device as in `track_one_async`;
* each step is replayed from a CUDA graph captured once per path, object
  count, size and iterations (step_graphs.py), as the JAX package
  jit-compiles it.

The poses are those of M single-object trackers on the same frames.
"""
from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from ..torch_config import default_device
from ..geometry.projection import depth_to_xyz_map
from ..meshio import TriMesh, compute_mesh_diameter
from ..models.networks import RefineNet, init_refine_net
from ..ops.depth_filters import bilateral_filter_depth, erode_depth
from .config import EstimatorCfg, torch_dtype
from .crops import make_crop_inputs
from .estimator import (
    FoundationPose,
    TrackResult,
    _as_module,
    _PinnedRing,
    prepare_render_mesh,
    roi_contains_pose,
)
from .graph import (
    TRACK_PACK_FOOTER,
    _offset,
    _pack_pixels,
    _unpack_pixels,
    pack_track_frame,
    shift_principal_point,
    unpack_track_frame,
)
from .mesh_tensors import MeshTensors, make_mesh_tensors
from .refiner import apply_pose_delta
from .step_graphs import GraphOwner, StepGraphs, run_step

logger = logging.getLogger(__name__)


def _prep(depth_raw, K, zfar):
    """Frame preparation of one frame (H, W) or a batch of windows
    (M, S, S) with their K (M, 3, 3): filtered depth -> XYZ map."""
    depth = bilateral_filter_depth(erode_depth(depth_raw, radius=2), radius=2)
    return depth_to_xyz_map(depth, K, zfar=zfar)


@torch.inference_mode()
def _multi_step(refiner_net, cfg: EstimatorCfg, meshes, poses, Ks, rgbs, xyzs, diameters,
                iterations, per_object_k):
    """`iterations` refine steps of M objects. Ks / rgbs / xyzs are
    per-object sequences (one shared frame repeated, or M windows)."""
    rcfg = cfg.refiner
    dtype = torch_dtype(rcfg.compute_dtype)
    cur = poses.to(torch.float32)
    M = len(meshes)
    for _ in range(int(iterations)):
        crops = [
            make_crop_inputs(
                mesh, cur[m : m + 1], Ks[m], rgbs[m], xyzs[m], diameters[m],
                input_res=rcfg.input_res, crop_ratio=rcfg.crop_ratio,
                normalize_xyz=rcfg.normalize_xyz, invalid_z=rcfg.xyz_invalid_z,
                use_normal=rcfg.use_normal, raster=rcfg.raster,
            )
            for m, mesh in enumerate(meshes)
        ]
        A = torch.cat([c[0] for c in crops])
        B = torch.cat([c[1] for c in crops])
        tfs = torch.cat([c[2] for c in crops])
        out = refiner_net(A, B, dtype=dtype)
        if per_object_k and rcfg.trans_rep == "deepim":
            # deepim deltas read K, which differs per window
            cur = torch.cat([
                apply_pose_delta(cur[m : m + 1], out["trans"][m : m + 1], out["rot"][m : m + 1],
                                 rcfg, diameters[m], K=Ks[m], tf_to_crops=tfs[m : m + 1])
                for m in range(M)
            ])
        else:
            cur = apply_pose_delta(cur, out["trans"], out["rot"], rcfg, diameters[:, None],
                                   K=Ks[0], tf_to_crops=tfs)
    return cur


def _multi_full(refiner_net, cfg, meshes, poses, K, rgb, depth_raw, diameters, iterations):
    """Full-frame M-object step (rgb f32 in [0, 1]): frame prep once."""
    xyz = _prep(depth_raw, K, cfg.zfar)
    M = len(meshes)
    return _multi_step(refiner_net, cfg, meshes, poses, [K] * M, [rgb] * M, [xyz] * M,
                       diameters, iterations, per_object_k=False)


def _multi_windows(refiner_net, cfg, meshes, poses, Ks, rgb_w, depth_w, diameters, iterations):
    """ROI M-object step: M windows (rgb_w (M, S, S, 3) f32, depth_w (M, S,
    S)) with their principal-point-shifted Ks (M, 3, 3); frame prep as one
    batch over the windows."""
    xyz = _prep(depth_w, Ks, cfg.zfar)
    return _multi_step(refiner_net, cfg, meshes, poses, Ks, rgb_w, xyz, diameters, iterations,
                       per_object_k=True)


def multi_track_body(refiner_net, cfg, meshes, poses, K, rgb_u8, depth_raw, diameters,
                     iterations):
    """One frame of tracking for M objects from unpacked tensors (rgb u8
    (H, W, 3), depth f32 (H, W)); returns the refined (M, 4, 4) poses."""
    rgb = rgb_u8.to(torch.float32) / 255.0
    return _multi_full(refiner_net, cfg, meshes, poses, K, rgb, depth_raw, diameters, iterations)


def multi_track_packed_body(refiner_net, cfg, meshes, poses, K_full, buf, diameters, hw,
                            iterations):
    """Full-frame M-object tracking from one pack_track_frame buffer."""
    rgb, depth_raw, _x0, _y0 = unpack_track_frame(buf, hw)
    return _multi_full(refiner_net, cfg, meshes, poses, K_full, rgb, depth_raw, diameters,
                       iterations)


def multi_track_roi_body(refiner_net, cfg, meshes, poses, Ks, rgb_w, depth_w, diameters,
                         iterations):
    """ROI variant of multi_track_body: each object has its own window of
    the frame (rgb_w (M, S, S, 3) u8, depth_w (M, S, S) f32) and its K with
    the principal point shifted by the window's offset (Ks (M, 3, 3))."""
    rgb = rgb_w.to(torch.float32) / 255.0
    return _multi_windows(refiner_net, cfg, meshes, poses, Ks, rgb, depth_w, diameters,
                          iterations)


def pack_multi_track_frame(rgb, depth, x0s, y0s, size: int, out=None) -> np.ndarray:
    """Host side: M windows of size x size cut from the frame, packed as
    pack_track_frame packs one (5 bytes a pixel), then a 4-byte (x0, y0)
    footer per window; byte for byte the JAX package's buffer. `out` as
    for pack_track_frame."""
    M = len(x0s)
    n_img = M * size * size * 5
    n = n_img + 4 * M
    buf = np.empty(n, np.uint8) if out is None else out[:n]
    img = buf[:n_img].reshape(M, size, size, 5)
    for m, (x0, y0) in enumerate(zip(x0s, y0s)):
        win = (slice(y0, y0 + size), slice(x0, x0 + size))
        _pack_pixels(img[m], rgb[win], depth[win])
    foot = buf[n_img:].reshape(M, 4)
    x0a = np.asarray(x0s, np.int64)
    y0a = np.asarray(y0s, np.int64)
    foot[:, 0] = x0a & 255
    foot[:, 1] = x0a >> 8
    foot[:, 2] = y0a & 255
    foot[:, 3] = y0a >> 8
    return buf


def multi_track_roi_packed_body(refiner_net, cfg, meshes, poses, K_full, buf, diameters, size,
                                iterations):
    """ROI tracking from one pack_multi_track_frame buffer: unpack the M
    windows and offsets on the device and shift each object's K."""
    M = len(meshes)
    n_img = M * size * size * 5
    rgb, depth_w = _unpack_pixels(buf[:n_img].reshape(M, size, size, 5))
    x0, y0 = _offset(buf[n_img:].reshape(M, 4))
    Ks = shift_principal_point(K_full.expand(M, 3, 3), x0, y0)
    return _multi_windows(refiner_net, cfg, meshes, poses, Ks, rgb, depth_w, diameters,
                          iterations)


# The four steps as the JAX package jit-compiles them: each body as one
# captured step (step_graphs.py), replayed from `graphs`, an owner's cache,
# keyed by the path, the object count, the frame or window size and the
# iterations.


def _captured(path, body, refiner_net, cfg, meshes, sizes, iterations, graphs, *inputs):
    meshes, iterations = tuple(meshes), int(iterations)
    return run_step(graphs, (path, len(meshes), sizes, iterations), (refiner_net, cfg, *meshes),
                    lambda *x: body(refiner_net, cfg, meshes, *x, *sizes, iterations), *inputs)


def multi_track_graph(refiner_net, cfg, meshes, poses, K, rgb_u8, depth_raw, diameters,
                      iterations, graphs: StepGraphs | None = None):
    """multi_track_body as one captured step."""
    return _captured("multi", multi_track_body, refiner_net, cfg, meshes, (), iterations, graphs,
                     poses, K, rgb_u8, depth_raw, diameters)


def multi_track_graph_packed(refiner_net, cfg, meshes, poses, K_full, buf, diameters, hw,
                             iterations, graphs: StepGraphs | None = None):
    """multi_track_packed_body as one captured step."""
    return _captured("multi_packed", multi_track_packed_body, refiner_net, cfg, meshes,
                     (tuple(hw),), iterations, graphs, poses, K_full, buf, diameters)


def multi_track_roi_graph(refiner_net, cfg, meshes, poses, Ks, rgb_w, depth_w, diameters,
                          iterations, graphs: StepGraphs | None = None):
    """multi_track_roi_body as one captured step."""
    return _captured("multi_roi", multi_track_roi_body, refiner_net, cfg, meshes, (), iterations,
                     graphs, poses, Ks, rgb_w, depth_w, diameters)


def multi_track_roi_graph_packed(refiner_net, cfg, meshes, poses, K_full, buf, diameters, size,
                                 iterations, graphs: StepGraphs | None = None):
    """multi_track_roi_packed_body as one captured step."""
    return _captured("multi_roi_packed", multi_track_roi_packed_body, refiner_net, cfg, meshes,
                     (int(size),), iterations, graphs, poses, K_full, buf, diameters)


class MultiTrackResult(TrackResult):
    """Handle to an in-flight multi-object frame: result() returns the (M,
    4, 4) poses, row m in object m's original mesh frame, as
    FoundationPose.track_one would return it for that object."""

    __slots__ = ()


class MultiTracker(GraphOwner):
    """Track M rigid objects with one step per frame.

    Register each object once with a FoundationPose (which needs the
    scorer and the rotation grid), hand the estimators to
    `from_estimators`, and stream frames through `track` / `track_async`.
    Objects may also be added from meshes and seeded with `set_poses`.

    All objects share one refiner; per object there are its mesh tensors,
    diameter and centering transform, and its row of the pose block.
    Each frame replays one captured step (step_graphs.py) of its path,
    object count, size and iterations; add_object, from_estimators and any
    assignment of the refiner, the config or the render meshes clear them."""

    def __init__(self, meshes: Sequence[TriMesh] | None = None, cfg: EstimatorCfg | None = None,
                 refiner_params=None, device: str | torch.device = "cuda"):
        self._graphs = StepGraphs()
        self.device = default_device(device)
        self.cfg = cfg or EstimatorCfg()
        self.has_refiner = refiner_params is not None
        if refiner_params is None:
            refiner = init_refine_net(self.cfg.refiner.net, torch.Generator().manual_seed(0))
            logger.info("no refiner weights: refinement iterations disabled")
        else:
            refiner = _as_module(refiner_params, RefineNet, self.cfg.refiner.net)
        self.refiner = refiner.to(self.device).eval()
        self.mesh_tensors: list[MeshTensors] = []
        self.diameters: list[float] = []
        self.tf_to_centered: list[np.ndarray] = []
        self.poses_last: torch.Tensor | None = None  # (M, 4, 4) centered-mesh frame
        # Host copies of the latest fetched raw poses: they place the windows.
        self._pose_hints: np.ndarray | None = None
        self._track_seq = 0
        self._chain_repair = None  # (seq, corrected device poses), see track_async
        self._K_cache: tuple[bytes, torch.Tensor] | None = None
        self.track_stats = {"frames": 0, "roi_recoveries": 0, "chain_repairs": 0}
        self._uploads = _PinnedRing(self.device)
        for mesh in meshes or ():
            self.add_object(mesh)

    # ------------------------------------------------------------ setup

    def add_object(self, mesh: TriMesh) -> int:
        """Prepare one object (center, bake/decimate per cfg, upload), as
        FoundationPose.reset_object prepares its render mesh; returns its
        index."""
        center = (mesh.vertices.min(axis=0) + mesh.vertices.max(axis=0)) / 2
        mesh = mesh.copy()
        mesh.vertices = mesh.vertices - center.reshape(1, 3)
        diameter = compute_mesh_diameter(mesh.vertices)
        render_src = prepare_render_mesh(mesh, self.cfg, diameter)
        tf = np.eye(4)
        tf[:3, 3] = -center
        self.mesh_tensors.append(make_mesh_tensors(render_src, self.cfg.max_tex_size, self.device))
        self.diameters.append(float(diameter))
        self.tf_to_centered.append(tf)
        self._objects_changed()
        return len(self.mesh_tensors) - 1

    @classmethod
    def from_estimators(cls, estimators: Sequence[FoundationPose],
                        cfg: EstimatorCfg | None = None) -> "MultiTracker":
        """A tracker from registered single-object estimators, reusing each
        one's render mesh and current pose, and the first one's refiner
        and device."""
        if not estimators:
            raise ValueError("need at least one estimator")
        first = estimators[0]
        for est in estimators:
            if est.pose_last is None:
                raise RuntimeError(
                    "all estimators must be registered (pose_last set) "
                    "before building a MultiTracker"
                )
            # One refiner for every object: the delta parameterization, crop
            # geometry and weights must agree.
            if est.cfg.refiner != first.cfg.refiner:
                raise ValueError(
                    "estimators have different refiner configs (delta rep / crop "
                    "geometry / net): MultiTracker runs one shared refiner"
                )
            if est.has_refiner != first.has_refiner:
                raise ValueError("estimators disagree on has_refiner")
            if est.device != first.device:
                raise ValueError("estimators live on different devices")
            if est.refiner is not first.refiner:
                logger.warning(
                    "estimators carry different refiner modules; MultiTracker uses "
                    "estimators[0]'s weights for all objects"
                )
        t = cls(meshes=None, cfg=cfg or first.cfg, refiner_params=first.refiner,
                device=first.device)
        t.has_refiner = first.has_refiner
        for est in estimators:
            t.mesh_tensors.append(est.mesh_tensors)
            t.diameters.append(float(est.diameter))
            t.tf_to_centered.append(est.get_tf_to_centered_mesh())
        t.poses_last = torch.stack([e.pose_last.to(torch.float32) for e in estimators])
        t._pose_hints = t.poses_last.cpu().numpy().astype(np.float64)
        t._objects_changed()
        return t

    def _objects_changed(self):
        """Upload the diameters and drop the captured steps, which read the
        render meshes by address."""
        self._diam = torch.tensor(self.diameters, dtype=torch.float32, device=self.device)
        self._graphs.clear()

    @property
    def n_objects(self) -> int:
        return len(self.mesh_tensors)

    def set_poses(self, poses: np.ndarray):
        """Seed or overwrite all poses; `poses` (M, 4, 4) in each object's
        original mesh frame (what register / track return)."""
        poses = np.asarray(poses, dtype=np.float64)
        if poses.shape != (self.n_objects, 4, 4):
            raise ValueError(f"expected {(self.n_objects, 4, 4)}, got {poses.shape}")
        raw = np.stack([p @ np.linalg.inv(tf) for p, tf in zip(poses, self.tf_to_centered)])
        self.poses_last = torch.tensor(raw, dtype=torch.float32, device=self.device)
        self._pose_hints = raw
        self._chain_repair = None  # a fresh chain
        self.track_stats = {"frames": 0, "roi_recoveries": 0, "chain_repairs": 0}

    # ------------------------------------------------------ ROI windows

    def _roi_windows(self, K: np.ndarray, H: int, W: int):
        """Per-object square windows around the last fetched poses (the
        single tracker's window, batched) with one common size, the largest
        over the objects. Returns (x0s, y0s, size), or None for the full
        frame."""
        if not self.cfg.track_roi or self._pose_hints is None:
            return None
        f = float(max(K[0, 0], K[1, 1]))
        sizes = []
        for m in range(self.n_objects):
            z = float(self._pose_hints[m][2, 3])
            if z <= 1e-6:
                return None
            crop_px = f * (self.diameters[m] * self.cfg.refiner.crop_ratio) / z
            sizes.append(int(np.ceil((crop_px * self.cfg.track_roi_margin + 16) / 64) * 64))
        size = max(sizes)
        if size >= min(H, W):
            return None
        x0s, y0s = [], []
        for m in range(self.n_objects):
            t = self._pose_hints[m][:3, 3]
            z = float(t[2])
            u = float(K[0, 0] * t[0] / z + K[0, 2])
            v = float(K[1, 1] * t[1] / z + K[1, 2])
            x0s.append(int(np.clip(round(u - size / 2), 0, W - size)))
            y0s.append(int(np.clip(round(v - size / 2), 0, H - size)))
        return x0s, y0s, size

    def _K_device(self, K: np.ndarray) -> torch.Tensor:
        kb = K.tobytes()
        if self._K_cache is None or self._K_cache[0] != kb:
            self._K_cache = (kb, torch.tensor(K, device=self.device))
        return self._K_cache[1]

    # --------------------------------------------------------- tracking

    def _full_frame(self, poses_in, K_full, rgb, depth, iters):
        meshes = tuple(self.mesh_tensors)
        if self.cfg.track_pack:
            h, w = depth.shape
            buf = self._uploads.upload(h * w * 5 + TRACK_PACK_FOOTER,
                                       lambda out: pack_track_frame(rgb, depth, 0, 0, out=out))
            return multi_track_graph_packed(self.refiner, self.cfg, meshes, poses_in,
                                            self._K_device(K_full), buf, self._diam, (h, w), iters,
                                            graphs=self._graphs)
        dev = self.device
        return multi_track_graph(
            self.refiner, self.cfg, meshes, poses_in, torch.as_tensor(K_full, device=dev),
            torch.as_tensor(rgb, dtype=torch.uint8, device=dev),
            torch.as_tensor(depth, dtype=torch.float32, device=dev), self._diam, iters,
            graphs=self._graphs,
        )

    def _windows(self, poses_in, K_full, rgb, depth, roi, iters):
        x0s, y0s, size = roi
        meshes = tuple(self.mesh_tensors)
        M = self.n_objects
        if self.cfg.track_pack:
            buf = self._uploads.upload(
                M * size * size * 5 + 4 * M,
                lambda out: pack_multi_track_frame(rgb, depth, x0s, y0s, size, out=out),
            )
            return multi_track_roi_graph_packed(self.refiner, self.cfg, meshes, poses_in,
                                                self._K_device(K_full), buf, self._diam, size,
                                                iters, graphs=self._graphs)
        dev = self.device
        rgb_w = np.stack([rgb[y0 : y0 + size, x0 : x0 + size] for x0, y0 in zip(x0s, y0s)])
        depth_w = np.stack([depth[y0 : y0 + size, x0 : x0 + size] for x0, y0 in zip(x0s, y0s)])
        Ks = np.tile(K_full, (M, 1, 1))
        Ks[:, 0, 2] -= np.asarray(x0s, np.float32)
        Ks[:, 1, 2] -= np.asarray(y0s, np.float32)
        return multi_track_roi_graph(
            self.refiner, self.cfg, meshes, poses_in, torch.as_tensor(Ks, device=dev),
            torch.as_tensor(rgb_w, dtype=torch.uint8, device=dev),
            torch.as_tensor(depth_w, dtype=torch.float32, device=dev), self._diam, iters,
            graphs=self._graphs,
        )

    @torch.inference_mode()
    def track_async(self, rgb, depth, K, iteration=2) -> MultiTrackResult:
        """Enqueue one frame for all M objects; non-blocking.

        The (M, 4, 4) pose block stays on the device as the next frame's
        input, so frames pipeline as with `track_one_async`. With
        cfg.track_roi only M windows around the objects are uploaded; each
        fetch checks every object's crop against its window and re-runs
        the frame full-frame when one left it. Corrections cascade through
        the frames in flight when results are fetched in dispatch order
        (out of order: a warning, and each frame's own check)."""
        if self.poses_last is None:
            raise RuntimeError("seed poses first (set_poses / from_estimators)")
        rgb = np.asarray(rgb)
        depth = np.asarray(depth)
        K_full = np.asarray(K, dtype=np.float32)
        H, W = depth.shape
        iters = int(iteration) if self.has_refiner else 0
        poses_in = self.poses_last
        roi = self._roi_windows(K_full, H, W)
        if roi is None:
            poses = self._full_frame(poses_in, K_full, rgb, depth, iters)
        else:
            poses = self._windows(poses_in, K_full, rgb, depth, roi, iters)
        self.poses_last = poses
        self._track_seq += 1
        seq = self._track_seq

        def rerun_full_frame(from_poses):
            with torch.inference_mode():
                p = self._full_frame(from_poses, K_full, rgb, depth, iters)
                return p, p.cpu().numpy().astype(np.float64)

        def adopt(poses2, raw2):
            self._pose_hints = raw2
            self._chain_repair = (seq, poses2)
            if self._track_seq == seq:  # no later frame in flight
                self.poses_last = poses2
                self._chain_repair = None
            return raw2

        def on_fetch(raw):
            self.track_stats["frames"] += 1
            repair = self._chain_repair
            if repair is not None and repair[0] == seq - 1:
                # the predecessor was corrected after this frame was
                # enqueued: re-run it from the corrected chain (cascade)
                self.track_stats["chain_repairs"] += 1
                return adopt(*rerun_full_frame(repair[1]))
            if repair is not None and repair[0] < seq - 1:
                logger.warning("multi-tracking chain correction could not cascade "
                               "(results fetched out of dispatch order?)")
                self._chain_repair = None
            self._pose_hints = raw
            if roi is None:
                return None
            x0s, y0s, size = roi
            if all(
                roi_contains_pose(raw[m], K_full, H, W, (x0s[m], y0s[m], size),
                                  self.diameters[m], self.cfg.refiner.crop_ratio)
                for m in range(self.n_objects)
            ):
                return None
            logger.warning("multi-tracking ROI violated (an object outran its window); "
                           "re-running frame full-frame")
            self.track_stats["roi_recoveries"] += 1
            return adopt(*rerun_full_frame(poses_in))

        return MultiTrackResult(poses, np.stack(self.tf_to_centered), on_fetch)

    def track(self, rgb, depth, K, iteration=2) -> np.ndarray:
        """Blocking per-frame tracking; (M, 4, 4) poses in each object's
        original mesh frame."""
        return self.track_async(rgb, depth, K, iteration=iteration).result()
