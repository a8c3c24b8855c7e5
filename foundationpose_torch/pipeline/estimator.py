"""FoundationPose public estimator API on torch.

Port of foundationpose_tpu/pipeline/estimator.py:

    est = FoundationPose(mesh=mesh, refiner_params=..., scorer_params=...,
                         device="cuda")
    pose = est.register(K, rgb, depth, ob_mask, iteration=5)  # (4, 4) np
    pose = est.track_one(rgb, depth, K, iteration=2)          # (4, 4) np
    fut = est.track_one_async(rgb, depth, K)                  # TrackResult
    poses = fetch_track_results([fut, ...])                   # one fetch

Per-frame compute runs on `device` (pipeline/graph.py); the rotation
grid is built once per object on the host (icosphere + greedy symmetry
clustering), as in the reference (estimater.py:106-124). With the
default config each frame is uploaded as one packed buffer holding a
window around the object (`EstimatorCfg.register_pack` / `register_roi`
/ `track_pack` / `track_roi`); a frame whose object left its window is
re-run on the full frame, so the poses are those of full-frame runs.
Tracking is asynchronous: the pose chain stays on the device and each
frame's pose streams back to pinned host memory while later frames run.
"""
from __future__ import annotations

import dataclasses
import logging
from collections.abc import Mapping

import numpy as np
import torch
import torch.nn as nn

from .. import torch_config  # noqa: F401
from ..geometry.clustering import cluster_poses
from ..geometry.icosphere import sample_views_icosphere
from ..geometry.projection import guess_translation
from ..meshio import TriMesh, compute_mesh_diameter, voxel_downsample
from ..models.networks import (
    RefineNet,
    ScoreNetMultiPair,
    init_refine_net,
    init_score_net,
)
from ..parallel.sharding import batch_sharding, make_device_mesh, replicate_tree
from .config import EstimatorCfg
from .graph import (
    REGISTER_PACK_FOOTER,
    TRACK_PACK_FOOTER,
    pack_register_frame,
    pack_track_frame,
    register_body_sharded,
    register_graph_packed_sharded,
    track_body,
    track_graph_packed,
)
from .mesh_tensors import make_mesh_tensors

logger = logging.getLogger(__name__)


def _copy_to_host_async(t: torch.Tensor):
    """Start copying `t` to the host: on the card a non-blocking copy into
    pinned memory and a recorded event; on the CPU `t` itself. Returns
    (host tensor, event or None)."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


class TrackResult:
    """Handle to an in-flight tracking frame.

    `track_one_async` returns it right after enqueueing the frame; the
    pose stays on the device (it is also the next frame's input, so the
    frame-to-frame chain never leaves the card) while its copy streams
    into pinned host memory. `result()` waits for that copy and returns
    the (4, 4) float64 object-in-camera pose with the centered-mesh
    transform applied, as the blocking `track_one` returns it.
    `MultiTrackResult` is the same handle for a (M, 4, 4) pose block."""

    __slots__ = ("_pose_dev", "_tf", "_on_fetch", "_cached", "_raw_host", "_host", "_event")

    def __init__(self, pose_dev: torch.Tensor, tf: np.ndarray, on_fetch=None):
        self._pose_dev = pose_dev
        self._tf = tf
        self._on_fetch = on_fetch
        self._cached = None
        self._raw_host = None
        self._host, self._event = _copy_to_host_async(pose_dev)

    def _prefill(self, raw_host: np.ndarray) -> None:
        """Install an already fetched raw pose (from fetch_track_results'
        one transfer); result() then runs its checks on it."""
        if self._cached is None and self._raw_host is None:
            self._raw_host = np.asarray(raw_host, np.float64).reshape(self._pose_dev.shape)

    def result(self) -> np.ndarray:
        if self._cached is None:
            raw = self._raw_host
            if raw is None:
                if self._event is not None:
                    self._event.synchronize()
                raw = self._host.numpy().astype(np.float64)
            if self._on_fetch is not None:
                # on_fetch may return a corrected raw pose (the window
                # check re-running the frame full-frame)
                corrected = self._on_fetch(raw)
                if corrected is not None:
                    raw = corrected
            self._cached = raw @ self._tf
        return self._cached


def fetch_track_results(results) -> list[np.ndarray]:
    """Resolve in-flight TrackResults with one device-to-host copy: the
    pending poses are stacked on the device and fetched together, then
    each frame's checks (window containment, chain repair) run in
    dispatch order, as sequential result() calls would run them. Pass
    the results in dispatch order; returns their poses."""
    results = list(results)
    pending = [r for r in results if r._cached is None and r._raw_host is None]
    if len(pending) > 1:
        host = torch.stack([r._pose_dev for r in pending]).cpu().numpy()
        for r, raw in zip(pending, host):
            r._prefill(raw)
    return [r.result() for r in results]


class _PinnedRing:
    """Host staging buffers for packed uploads, one slot per in-flight
    frame. On the card a slot is pinned memory copied to the device
    without blocking; its event marks the end of that copy, and a slot is
    refilled only after its previous copy has ended. On the CPU the packed
    array is used as it is."""

    def __init__(self, device: torch.device, depth: int = 8):
        self.device = device
        self._slots = [(None, None)] * depth
        self._next = 0

    def upload(self, nbytes: int, pack) -> torch.Tensor:
        """pack(out) writes the buffer into `out` (a uint8 array of at least
        nbytes, or None for a fresh array) and returns it; returns the
        packed bytes on the device."""
        if self.device.type != "cuda":
            return torch.from_numpy(pack(None))
        i = self._next
        self._next = (i + 1) % len(self._slots)
        host, event = self._slots[i]
        if event is not None:
            event.synchronize()
        if host is None or host.numel() < nbytes:
            host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        pack(host.numpy())
        dev_buf = host[:nbytes].to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._slots[i] = (host, event)
        return dev_buf


def _rotation_about_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    out = np.eye(4)
    out[:2, :2] = [[c, -s], [s, c]]
    return out


def prepare_render_mesh(mesh: TriMesh, cfg: EstimatorCfg, diameter: float) -> TriMesh:
    """Bake textures to vertex colors and/or decimate dense meshes per
    cfg. `mesh` is the centered mesh."""
    render_src = mesh
    if cfg.vertex_color_render and mesh.has_texture:
        from ..meshio import texture_to_vertex_colors

        render_src = texture_to_vertex_colors(mesh)
    if cfg.max_render_faces is not None and len(mesh.faces) > cfg.max_render_faces:
        from ..meshio import decimate_vertex_clustering

        vox = diameter / 160.0  # crop-pixel scale
        render_src = decimate_vertex_clustering(mesh, vox)
        while len(render_src.faces) > cfg.max_render_faces:
            vox *= 1.4
            render_src = decimate_vertex_clustering(mesh, vox)
        logger.info(
            "render mesh decimated: %d -> %d faces", len(mesh.faces), len(render_src.faces)
        )
    return render_src


def roi_contains_pose(
    raw_pose: np.ndarray,
    K: np.ndarray,
    H: int,
    W: int,
    roi: tuple[int, int, int],
    diameter: float,
    crop_ratio: float,
) -> bool:
    """Was the crop window implied by `raw_pose` (centered-mesh frame,
    full-frame K) inside the uploaded window (x0, y0, size), up to the
    stencil filters' halo? The crop is first clipped to the image: pixels
    past the border sample zeros in full-frame mode too, so only in-image
    excursions count. Shared by the single- and multi-object trackers."""
    x0, y0, size = roi
    t = raw_pose[:3, 3]
    z = float(t[2])
    if z <= 1e-6:
        return False
    f = float(max(K[0, 0], K[1, 1]))
    halo = 4.0  # erode(r=2) + bilateral(r=2) support
    half = f * (diameter * crop_ratio) / z / 2 + halo
    u = float(K[0, 0] * t[0] / z + K[0, 2])
    v = float(K[1, 1] * t[1] / z + K[1, 2])
    lo_u, hi_u = max(u - half, 0.0), min(u + half, float(W))
    lo_v, hi_v = max(v - half, 0.0), min(v + half, float(H))
    return lo_u >= x0 and hi_u <= x0 + size and lo_v >= y0 and hi_v <= y0 + size


def _as_module(params, cls, net_cfg):
    """A net module from a module or a state_dict."""
    if isinstance(params, nn.Module):
        return params
    if isinstance(params, Mapping):
        net = cls(net_cfg)
        net.load_state_dict(params)
        return net.eval()
    raise TypeError(f"expected an nn.Module or a state_dict, got {type(params)}")


class FoundationPose:
    def __init__(
        self,
        model_pts=None,
        model_normals=None,
        symmetry_tfs=None,
        mesh: TriMesh | None = None,
        cfg: EstimatorCfg | None = None,
        refiner_params=None,
        scorer_params=None,
        device: str | torch.device = "cuda",
        debug: int = 0,
        debug_dir: str | None = None,
        n_devices: int | None = None,
        device_mesh=None,
    ):
        """`refiner_params` / `scorer_params`: a RefineNet /
        ScoreNetMultiPair module or its state_dict. `device` is where
        every frame is computed; asking for CUDA without a card raises.

        `n_devices` > 1 splits the register's hypotheses over a 1-D device
        mesh (`parallel.make_device_mesh(n_devices, device=device)`: cuda:0
        to cuda:n-1, or n copies of the CPU); `device_mesh` gives the mesh
        itself (a device may repeat), in place of `device` and
        `n_devices`. Without either the mesh is `device` alone. The
        refiner, the scorer and the render mesh are replicated, the
        rotation grid is padded to a multiple of the mesh size and split;
        each device renders, refines and runs the scorer's trunk on its
        shard, and only the pooled scorer features are gathered, onto the
        mesh's first device, which also tracks. `debug` >= 2 writes crop
        canvases of each register to `debug_dir`, >= 3 also the posed mesh
        (utils/debug_vis.py)."""
        if device_mesh is None:
            device_mesh = (make_device_mesh(n_devices, device=device) if n_devices and n_devices > 1
                           else make_device_mesh(devices=[device]))
        elif n_devices is not None:
            raise ValueError("give n_devices or device_mesh, not both")
        self.device_mesh = device_mesh
        self.device = device_mesh.first
        self.debug = debug
        self.debug_dir = debug_dir
        self._guess_center = None  # set by register(); read by the debug dumps
        self.cfg = cfg or EstimatorCfg()
        self.gt_pose = None
        self.pose_last: torch.Tensor | None = None
        # Host copy of the latest fetched raw pose (centered-mesh frame):
        # it places the tracking window. It may lag pose_last by the
        # frames in flight, which track_roi_margin absorbs.
        self._pose_hint: np.ndarray | None = None
        # (seq, corrected device pose) of the newest correction that frames
        # in flight have not absorbed yet (see track_one_async.on_fetch).
        self._chain_repair = None
        self._track_seq = 0
        # Device-resident full-frame K, keyed by the host K's bytes.
        self._K_cache: tuple[bytes, torch.Tensor] | None = None
        # Reset by register: frames fetched, window recoveries, chain repairs.
        self.track_stats = {"frames": 0, "roi_recoveries": 0, "chain_repairs": 0}
        self.register_roi_recoveries = 0
        self._uploads = _PinnedRing(self.device)
        # Weights-awareness: a randomly initialized refiner would apply
        # garbage deltas, so refinement is skipped unless real weights
        # are supplied; "auto" scoring falls back to the depth scorer.
        self.has_refiner = refiner_params is not None
        if self.cfg.scorer.mode == "auto":
            resolved = "network" if scorer_params is not None else "depth"
            self.cfg = dataclasses.replace(
                self.cfg, scorer=dataclasses.replace(self.cfg.scorer, mode=resolved)
            )
            logger.info("scorer mode auto -> %s", resolved)
        if refiner_params is None:
            refiner = init_refine_net(self.cfg.refiner.net, torch.Generator().manual_seed(0))
            logger.info("no refiner weights: refinement iterations disabled")
        else:
            refiner = _as_module(refiner_params, RefineNet, self.cfg.refiner.net)
        if scorer_params is None:
            scorer = init_score_net(self.cfg.scorer.net, torch.Generator().manual_seed(1))
        else:
            scorer = _as_module(scorer_params, ScoreNetMultiPair, self.cfg.scorer.net)
        self.refiner = refiner.to(self.device).eval()
        self.scorer = scorer.to(self.device).eval()

        self.reset_object(
            model_pts=model_pts, model_normals=model_normals,
            symmetry_tfs=symmetry_tfs, mesh=mesh,
        )
        self.make_rotation_grid(
            min_n_views=self.cfg.min_n_views, inplane_step=self.cfg.inplane_step_deg
        )

    # ------------------------------------------------------------ setup

    def reset_object(self, model_pts=None, model_normals=None, symmetry_tfs=None, mesh=None):
        """Re-center the mesh, compute diameter and points, upload the
        render mesh (estimater.py:44-78)."""
        if mesh is None:
            raise ValueError("mesh is required")
        max_xyz = mesh.vertices.max(axis=0)
        min_xyz = mesh.vertices.min(axis=0)
        self.model_center = (min_xyz + max_xyz) / 2
        self.mesh_ori = mesh
        mesh = mesh.copy()
        mesh.vertices = mesh.vertices - self.model_center.reshape(1, 3)

        self.diameter = compute_mesh_diameter(mesh.vertices)
        self.vox_size = max(self.diameter / 20.0, 0.003)
        pts, normals = voxel_downsample(mesh.vertices, self.vox_size, mesh.vertex_normals)
        self.max_xyz = pts.max(axis=0)
        self.min_xyz = pts.min(axis=0)
        self.pts = torch.as_tensor(pts, dtype=torch.float32, device=self.device)
        self.normals = torch.as_tensor(normals, dtype=torch.float32, device=self.device)
        self.mesh = mesh
        render_src = prepare_render_mesh(mesh, self.cfg, self.diameter)
        self.mesh_tensors = make_mesh_tensors(render_src, self.cfg.max_tex_size, self.device)
        self._diam = torch.tensor(self.diameter, dtype=torch.float32, device=self.device)
        if symmetry_tfs is None:
            self.symmetry_tfs = np.eye(4)[None]
        else:
            self.symmetry_tfs = np.asarray(symmetry_tfs, dtype=np.float64)
        logger.info(
            "reset done: diameter=%.4f V=%d F=%d",
            self.diameter, len(mesh.vertices), len(mesh.faces),
        )

    def get_tf_to_centered_mesh(self) -> np.ndarray:
        tf = np.eye(4)
        tf[:3, 3] = -self.model_center
        return tf

    def make_rotation_grid(self, min_n_views=40, inplane_step=60):
        """Icosphere views x in-plane rotations, deduplicated under
        symmetry and padded to a multiple of cfg.rot_grid_pad."""
        cam_in_obs = sample_views_icosphere(n_views=min_n_views)
        rot_grid = []
        for cam_in_ob in cam_in_obs:
            for inplane_rot in np.deg2rad(np.arange(0, 360, inplane_step)):
                rot_grid.append(np.linalg.inv(cam_in_ob @ _rotation_about_z(inplane_rot)))
        rot_grid = cluster_poses(
            self.cfg.cluster_angle_deg, 99999.0, np.asarray(rot_grid), self.symmetry_tfs
        )
        n = len(rot_grid)
        # the hypotheses split evenly over the mesh
        pad = (-n) % int(np.lcm(self.cfg.rot_grid_pad, self.device_mesh.size))
        if pad:
            rot_grid = np.concatenate([rot_grid, np.tile(np.eye(4)[None], (pad, 1, 1))])
        self.hyp_valid = torch.as_tensor(
            np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]), device=self.device
        )
        self.rot_grid = torch.as_tensor(rot_grid, dtype=torch.float32, device=self.device)
        logger.info("rotation grid: %d (+%d pad)", n, pad)

    def _shards(self):
        """The register's inputs on the mesh, made again for each register
        so that a net changed in place, a new render mesh or a new
        rotation grid reaches every device: per mesh device (refiner,
        scorer, mesh tensors, diameter), and the rows of the rotation grid
        and of its validity. A device that is the first one's gets the
        estimator's own objects, so an unsharded register copies nothing."""
        mesh = self.device_mesh
        replicas = list(zip(*(replicate_tree(t, mesh) for t in (
            self.refiner, self.scorer, self.mesh_tensors, self._diam))))
        sh = batch_sharding(mesh)
        return replicas, sh(self.rot_grid), sh(self.hyp_valid)

    def save_weights(self, refiner_path: str | None = None, scorer_path: str | None = None):
        """Save the refiner / scorer as `.npz` param trees in the JAX
        package's layout, with the live pipeline config embedded, so
        load_weights (either package's) rebuilds the net width, crop
        resolution, delta parameterization and scorer mode."""
        from ..models.convert import params_to_jax
        from ..utils.checkpoint import save_params

        for path, kind in ((refiner_path, "refiner"), (scorer_path, "scorer")):
            if path:
                save_params(path, params_to_jax(getattr(self, kind).state_dict()),
                            meta={"pipeline_cfg": dataclasses.asdict(getattr(self.cfg, kind))})

    def load_weights(self, refiner_path: str | None = None, scorer_path: str | None = None):
        """Load checkpoints with their configs (models/loading.py): a
        reference `.pth` (with its sidecar config.yml if there is one),
        a converted `.npz` that embeds the reference config, a
        save_weights `.npz`, or a bare `.npz`. The refiner checkpoint's
        reference config also sets EstimatorCfg.zfar (3 m by default,
        predict_pose_refine.py:124-129)."""
        from ..models.loading import load_estimator_checkpoint

        for path, kind in ((refiner_path, "refiner"), (scorer_path, "scorer")):
            if not path:
                continue
            sd, sub, zfar = load_estimator_checkpoint(path, kind, base=getattr(self.cfg, kind))
            cls = RefineNet if kind == "refiner" else ScoreNetMultiPair
            setattr(self, kind, _as_module(sd, cls, sub.net).to(self.device).eval())
            self.cfg = dataclasses.replace(self.cfg, **{kind: sub})
            if kind == "refiner":
                self.has_refiner = True
                if zfar is not None:
                    self.cfg = dataclasses.replace(self.cfg, zfar=zfar)

    def compute_add_err_to_gt_pose(self, poses) -> np.ndarray:
        """ADD of each pose in the centered-mesh frame against
        self.gt_pose (the reference stubs this to -1, estimater.py:243-247;
        so does this without a gt pose)."""
        if self.gt_pose is None:
            return -np.ones(len(poses))
        pts = self.pts.cpu().numpy()
        gt = np.asarray(self.gt_pose) @ np.linalg.inv(self.get_tf_to_centered_mesh())
        poses = np.asarray(poses)
        gt_pts = pts @ gt[:3, :3].T + gt[:3, 3]
        pred = np.einsum("nij,pj->npi", poses[:, :3, :3], pts) + poses[:, None, :3, 3]
        return np.linalg.norm(pred - gt_pts[None], axis=-1).mean(axis=-1)

    # --------------------------------------------------------- inference

    def _frame(self, K, rgb, depth):
        dev = self.device
        K_t = torch.as_tensor(np.asarray(K, np.float32), device=dev)
        rgb_t = torch.as_tensor(np.asarray(rgb, np.uint8), device=dev).to(torch.float32) / 255.0
        depth_t = torch.as_tensor(np.asarray(depth, np.float32), device=dev)
        return K_t, rgb_t, depth_t

    def _K_device(self, K: np.ndarray) -> torch.Tensor:
        """The full-frame K on the device, uploaded again only when it changes."""
        kb = K.tobytes()
        if self._K_cache is None or self._K_cache[0] != kb:
            self._K_cache = (kb, torch.tensor(K, device=self.device))
        return self._K_cache[1]

    def _register_crop_ratio(self) -> float:
        """The register window covers the crops of both the refiner and the
        scorer, so it is sized and checked with the larger crop ratio."""
        return max(self.cfg.refiner.crop_ratio, self.cfg.scorer.crop_ratio)

    def _register_roi_window(self, K, depth_np, mask_np):
        """Detection-sized square upload window for register: the projected
        crop extent at the mask's median depth x register_roi_margin,
        placed on the mask centroid, in 64-px steps, and never smaller than
        the mask's bbox + the filter halo. Returns (x0, y0, size), or None
        for the full frame (no smaller window, or the window would not hold
        the mask)."""
        if not (self.cfg.register_roi and self.cfg.register_pack):
            return None
        H, W = depth_np.shape
        ys, xs = np.nonzero(mask_np)
        if len(ys) == 0:
            return None
        vals = depth_np[ys, xs]
        vals = vals[vals >= 0.001]
        if len(vals) == 0:
            return None
        z = float(np.median(vals))
        f = float(max(K[0, 0], K[1, 1]))
        crop_px = f * (self.diameter * self._register_crop_ratio()) / z
        size = int(np.ceil((crop_px * self.cfg.register_roi_margin + 16) / 64) * 64)
        size = max(
            size,
            int(np.ceil((int(xs.max() - xs.min()) + 17) / 64) * 64),
            int(np.ceil((int(ys.max() - ys.min()) + 17) / 64) * 64),
        )
        if size >= min(H, W):
            return None
        x0 = int(np.clip(round(float(xs.mean()) - size / 2), 0, W - size))
        y0 = int(np.clip(round(float(ys.mean()) - size / 2), 0, H - size))
        if xs.min() < x0 or xs.max() >= x0 + size or ys.min() < y0 or ys.max() >= y0 + size:
            return None  # detection off its centroid: upload the frame
        return x0, y0, size

    def _register_window_holds(self, out, K, H, W, roi) -> bool:
        """Did the crop of every valid refined hypothesis stay inside the
        register window? Every score and every refinement read its crop, so
        any hypothesis, not only the winner, may have been changed by the
        window's edge. One (N, 4, 4) fetch with the validity of each row."""
        order, refined = out[0], out[1]
        host = torch.cat(
            [refined.reshape(-1, 16), self.hyp_valid[order][:, None].to(torch.float32)], dim=1
        ).cpu().numpy().astype(np.float64)
        poses, valid = host[:, :16].reshape(-1, 4, 4), host[:, 16] > 0
        ratio = self._register_crop_ratio()
        return all(
            roi_contains_pose(p, K, H, W, roi, self.diameter, ratio) for p in poses[valid]
        )

    @torch.inference_mode()
    def register(self, K, rgb, depth, ob_mask, ob_id=None, iteration=5) -> np.ndarray:
        """Single-frame pose estimation (estimater.py:159-240)."""
        mask_np = np.asarray(ob_mask)
        depth_np = np.asarray(depth)
        K_np = np.asarray(K)
        valid = (depth_np >= 0.001) & (mask_np > 0)
        if valid.sum() < 4:
            # Degenerate input: identity rotation at the translation guess
            # (raw-depth median, filtering skipped).
            logger.info("valid region too small; returning translation guess")
            pose = np.eye(4)
            pose[:3, 3] = guess_translation(depth_np, mask_np, K_np)
            return pose
        iters = int(iteration) if self.has_refiner else 0
        rgb_np = np.asarray(rgb)
        H, W = depth_np.shape
        K_t = torch.as_tensor(np.asarray(K_np, np.float32), device=self.device)

        def run_packed(roi):
            x0, y0, size = roi if roi is not None else (0, 0, None)
            rgb_w, depth_w, mask_w = rgb_np, depth_np, mask_np
            if roi is not None:
                win = (slice(y0, y0 + size), slice(x0, x0 + size))
                rgb_w, depth_w, mask_w = rgb_np[win], depth_np[win], mask_np[win]
            h, w = depth_w.shape
            buf = self._uploads.upload(
                h * w * 5 + h * w // 8 + REGISTER_PACK_FOOTER,
                lambda out: pack_register_frame(rgb_w, depth_w.astype(np.float32), mask_w,
                                                x0, y0, out=out),
            )
            replicas, rot_parts, valid_parts = self._shards()
            return register_graph_packed_sharded(replicas, self.cfg, rot_parts, valid_parts, K_t,
                                                 buf, (h, w), iters)

        if self.cfg.register_pack and depth_np.size % 8 == 0:
            roi = self._register_roi_window(K_np, depth_np, mask_np)
            out = run_packed(roi)
            if roi is not None and not self._register_window_holds(out, K_np, H, W, roi):
                logger.info("register window left by a hypothesis's crop; re-running full-frame")
                self.register_roi_recoveries += 1
                out = run_packed(None)
        else:
            _, rgb_t, depth_t = self._frame(K_np, rgb_np, depth_np)
            mask_t = torch.as_tensor(mask_np, device=self.device)
            replicas, rot_parts, valid_parts = self._shards()
            frames = [tuple(t.to(r.device) for t in (K_t, rgb_t, depth_t, mask_t)) for r in rot_parts]
            out = register_body_sharded(replicas, self.cfg, rot_parts, valid_parts, frames, iters)
        order, refined, scores, center, _n = out
        self.poses = refined
        self.scores = scores
        self.order = order
        self.pose_last = refined[0]
        self.best_id = int(order[0])
        self._pose_hint = self.pose_last.cpu().numpy().astype(np.float64)
        self._guess_center = center.cpu().numpy().astype(np.float64)
        self._chain_repair = None  # a fresh chain
        self.track_stats = {"frames": 0, "roi_recoveries": 0, "chain_repairs": 0}
        best_pose = self._pose_hint @ self.get_tf_to_centered_mesh()
        if self.debug >= 2 and self.debug_dir:
            from ..utils.debug_vis import dump_refiner_debug, dump_register_debug

            dump_register_debug(self, self.debug_dir, K, rgb, depth)
            if self.has_refiner and int(iteration) > 0:
                dump_refiner_debug(self, self.debug_dir, K, rgb, depth, int(iteration))
        if self.debug >= 3 and self.debug_dir:
            from ..utils.debug_vis import dump_transformed_mesh

            dump_transformed_mesh(self, self.debug_dir, best_pose)
        return best_pose

    def track_one(self, rgb, depth, K, iteration=2, extra=None) -> np.ndarray:
        """Per-frame tracking: refine-only from pose_last
        (estimater.py:250-268); `track_one_async(...).result()`."""
        return self.track_one_async(rgb, depth, K, iteration=iteration).result()

    def _track_roi_window(self, K: np.ndarray, H: int, W: int):
        """Square upload window around the last fetched pose: the projected
        crop extent x track_roi_margin + the filter halo, in 64-px steps.
        Returns (x0, y0, size), or None for the full frame. Exact while the
        refiner's crop stays inside the window, which every fetch checks."""
        if not self.cfg.track_roi or self._pose_hint is None:
            return None
        t = self._pose_hint[:3, 3]
        z = float(t[2])
        if z <= 1e-6:
            return None
        f = float(max(K[0, 0], K[1, 1]))
        crop_px = f * (self.diameter * self.cfg.refiner.crop_ratio) / z
        size = int(np.ceil((crop_px * self.cfg.track_roi_margin + 16) / 64) * 64)
        if size >= min(H, W):
            return None
        u = float(K[0, 0] * t[0] / z + K[0, 2])
        v = float(K[1, 1] * t[1] / z + K[1, 2])
        x0 = int(np.clip(round(u - size / 2), 0, W - size))
        y0 = int(np.clip(round(v - size / 2), 0, H - size))
        return x0, y0, size

    def _track_step(self, pose_in, K_full, rgb, depth, x0, y0, iters):
        """One tracking step on the window (x0, y0) of the frame (rgb,
        depth: that window) -> the device pose. Packed: one upload and the
        principal point shifted on the device; unpacked: three uploads."""
        if self.cfg.track_pack:
            h, w = depth.shape
            buf = self._uploads.upload(
                h * w * 5 + TRACK_PACK_FOOTER,
                lambda out: pack_track_frame(rgb, depth, x0, y0, out=out),
            )
            return track_graph_packed(self.refiner, self.cfg, self.mesh_tensors, pose_in,
                                      self._K_device(K_full), buf, self._diam, (h, w), iters)
        Kr = K_full.copy()
        Kr[0, 2] -= x0
        Kr[1, 2] -= y0
        K_t, rgb_t, depth_t = self._frame(Kr, rgb, depth)
        return track_body(self.refiner, self.cfg, self.mesh_tensors, pose_in, K_t, rgb_t,
                          depth_t, self._diam, iters)

    @torch.inference_mode()
    def track_one_async(self, rgb, depth, K, iteration=2) -> TrackResult:
        """Non-blocking tracking: enqueue this frame and return a
        TrackResult whose result() fetches the pose.

        The chain (pose_last) stays on the device, so callers can enqueue
        frame N+1 before fetching frame N. With track_roi on, only a window
        around the object is uploaded; each fetch checks that the refined
        pose's crop stayed inside it and re-runs the frame full-frame from
        the same input pose when it did not. A correction also cascades
        through the frames already in flight: each re-runs full-frame from
        the corrected chain when fetched, so the poses are those of
        sequential full-frame track_one calls, provided the results are
        fetched in dispatch order. Fetching out of order breaks the
        cascade (a warning is logged); each frame's own check still holds.
        """
        if self.pose_last is None:
            raise RuntimeError("Please init pose by register() first")
        rgb_full = np.asarray(rgb)
        depth_full = np.asarray(depth)
        K_full = np.asarray(K, dtype=np.float32)
        H, W = depth_full.shape
        pose_in = self.pose_last
        iters = int(iteration) if self.has_refiner else 0
        roi = self._track_roi_window(K_full, H, W)
        if roi is None:
            pose = self._track_step(pose_in, K_full, rgb_full, depth_full, 0, 0, iters)
        else:
            x0, y0, size = roi
            win = (slice(y0, y0 + size), slice(x0, x0 + size))
            pose = self._track_step(pose_in, K_full, rgb_full[win], depth_full[win], x0, y0, iters)
        self.pose_last = pose
        self._track_seq += 1
        seq = self._track_seq

        def rerun_full_frame(from_pose):
            with torch.inference_mode():
                pose2 = self._track_step(from_pose, K_full, rgb_full, depth_full, 0, 0, iters)
                return pose2, pose2.cpu().numpy().astype(np.float64)

        def adopt(pose2, raw2):
            """A corrected pose for this frame: the new hint, and the chain
            continues from it (at once if no later frame is in flight)."""
            self._pose_hint = raw2
            self._chain_repair = (seq, pose2)
            if self._track_seq == seq:
                self.pose_last = pose2
                self._chain_repair = None  # the chain is repaired
            return raw2

        def on_fetch(raw):
            self.track_stats["frames"] += 1
            repair = self._chain_repair
            if repair is not None and repair[0] == seq - 1:
                # The predecessor was corrected after this frame was
                # enqueued: this frame chained from a stale pose. Re-run
                # it full-frame from the corrected chain (cascade).
                self.track_stats["chain_repairs"] += 1
                return adopt(*rerun_full_frame(repair[1]))
            if repair is not None and repair[0] < seq - 1:
                logger.warning(
                    "tracking chain correction could not cascade "
                    "(results fetched out of dispatch order?)"
                )
                self._chain_repair = None
            self._pose_hint = raw
            if roi is None or roi_contains_pose(
                raw, K_full, H, W, roi, self.diameter, self.cfg.refiner.crop_ratio
            ):
                return None
            # The window was placed from a hint that lagged the motion, and
            # the crop left it: re-run this frame full-frame from the same
            # input pose.
            logger.warning("tracking ROI violated (object outran the window); "
                           "re-running frame full-frame")
            self.track_stats["roi_recoveries"] += 1
            return adopt(*rerun_full_frame(pose_in))

        return TrackResult(pose, self.get_tf_to_centered_mesh(), on_fetch)
