"""Dataset readers: YCBInEOAT demo videos + the BOP family.

A copy of foundationpose_tpu/datasets/readers.py. Host-side I/O
mirroring the reference's datareader.py (9 reader classes,
datareader.py:57-611), built on the package's own mesh loader instead
of trimesh/open3d. cv2 and imageio are imported only where an image is
read. All poses are meters, OpenCV camera convention.
"""
from __future__ import annotations

import copy
import glob
import json
import logging
import os

import numpy as np

from ..geometry.symmetry import symmetry_tfs_from_info
from ..meshio import TriMesh, load_mesh

logger = logging.getLogger(__name__)

BOP_DIR = os.getenv("BOP_DIR", "")
YCB_VIDEO_DIR = os.getenv("YCB_VIDEO_DIR", "")


def _imread(path, flags=-1):
    import cv2

    return cv2.imread(path, flags)


def _imresize_nearest(img, W, H):
    import cv2

    return cv2.resize(img, (W, H), interpolation=cv2.INTER_NEAREST)


def _rot_tfs(axes_angles):
    """4x4 rotations about principal axes for the YCB-V geometric
    symmetry overrides (datareader.py:455-479)."""
    out = []
    for rx, ry, rz in axes_angles:
        tf = np.eye(4)
        cx, sx = np.cos(rx), np.sin(rx)
        cy, sy = np.cos(ry), np.sin(ry)
        cz, sz = np.cos(rz), np.sin(rz)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        tf[:3, :3] = Rz @ Ry @ Rx
        out.append(tf)
    return out


class YcbineoatReader:
    """Demo/tracking videos: rgb/ depth/ masks/ annotated_poses/ cam_K.txt
    (datareader.py:57-152)."""

    def __init__(self, video_dir, downscale=1, shorter_side=None, zfar=np.inf):
        self.video_dir = video_dir
        self.downscale = downscale
        self.zfar = zfar
        self.color_files = sorted(glob.glob(f"{video_dir}/rgb/*.png"))
        self.K = np.loadtxt(f"{video_dir}/cam_K.txt").reshape(3, 3)
        self.id_strs = [
            os.path.basename(f).replace(".png", "") for f in self.color_files
        ]
        first = _imread(self.color_files[0])
        self.H, self.W = first.shape[:2]
        if shorter_side is not None:
            self.downscale = shorter_side / min(self.H, self.W)
        self.H = int(self.H * self.downscale)
        self.W = int(self.W * self.downscale)
        self.K[:2] *= self.downscale
        self.gt_pose_files = sorted(glob.glob(f"{video_dir}/annotated_poses/*"))
        self.videoname_to_object = {
            "bleach0": "021_bleach_cleanser",
            "bleach_hard_00_03_chaitanya": "021_bleach_cleanser",
            "cracker_box_reorient": "003_cracker_box",
            "cracker_box_yalehand0": "003_cracker_box",
            "mustard0": "006_mustard_bottle",
            "mustard_easy_00_02": "006_mustard_bottle",
            "sugar_box1": "004_sugar_box",
            "sugar_box_yalehand0": "004_sugar_box",
            "tomato_soup_can_yalehand0": "005_tomato_soup_can",
        }

    def get_video_name(self):
        return self.video_dir.rstrip("/").split("/")[-1]

    def __len__(self):
        return len(self.color_files)

    def get_gt_pose(self, i):
        try:
            return np.loadtxt(self.gt_pose_files[i]).reshape(4, 4)
        except Exception:
            logger.info("GT pose not found, return None")
            return None

    def get_color(self, i):
        import imageio.v2 as imageio

        color = imageio.imread(self.color_files[i])[..., :3]
        return _imresize_nearest(color, self.W, self.H)

    def get_mask(self, i):
        mask = _imread(self.color_files[i].replace("rgb", "masks"))
        if mask.ndim == 3:
            for c in range(3):
                if mask[..., c].sum() > 0:
                    mask = mask[..., c]
                    break
        return _imresize_nearest(mask, self.W, self.H).astype(bool).astype(np.uint8)

    def get_depth(self, i):
        depth = _imread(self.color_files[i].replace("rgb", "depth")) / 1e3
        depth = _imresize_nearest(depth, self.W, self.H)
        depth[(depth < 0.001) | (depth >= self.zfar)] = 0
        return depth

    def get_occ_mask(self, i):
        occ = np.zeros((self.H, self.W), dtype=bool)
        for sub in ("masks_hand", "masks_hand_right"):
            f = self.color_files[i].replace("rgb", sub)
            if os.path.exists(f):
                m = _imread(f)
                occ = occ | (_imresize_nearest(m, self.W, self.H) > 0)
        return occ.astype(np.uint8)

    def get_gt_mesh(self) -> TriMesh:
        ob_name = self.videoname_to_object[self.get_video_name()]
        return load_mesh(f"{YCB_VIDEO_DIR}/models/{ob_name}/textured_simple.obj")


class BopBaseReader:
    """BOP scene layout (datareader.py:155-366)."""

    def __init__(self, base_dir, zfar=np.inf, resize=1):
        self.base_dir = base_dir
        self.resize = resize
        self.dataset_name = None
        self.zfar = zfar
        self.color_files = sorted(glob.glob(f"{base_dir}/rgb/*"))
        if not self.color_files:
            self.color_files = sorted(glob.glob(f"{base_dir}/gray/*"))

        self.K_table = {}
        with open(f"{base_dir}/scene_camera.json") as ff:
            info = json.load(ff)
        for k in info:
            self.K_table[f"{int(k):06d}"] = np.array(info[k]["cam_K"]).reshape(3, 3)
            self.bop_depth_scale = info[k]["depth_scale"]

        gt_file = f"{base_dir}/scene_gt.json"
        if os.path.exists(gt_file):
            with open(gt_file) as ff:
                self.scene_gt = json.load(ff)
        else:
            self.scene_gt = None
        self.scene_ob_ids_dict = None
        self.make_id_strs()

    def __len__(self):
        return len(self.color_files)

    def make_id_strs(self):
        self.id_strs = [
            os.path.basename(f).split(".")[0] for f in self.color_files
        ]

    def make_scene_ob_ids_dict(self):
        path = f"{BOP_DIR}/{self.dataset_name}/test_targets_bop19.json"
        self.scene_ob_ids_dict = {}
        if not os.path.exists(path):
            return
        with open(path) as ff:
            data = json.load(ff)
        for d in data:
            if d["scene_id"] == self.get_video_id():
                id_str = f"{d['im_id']:06d}"
                self.scene_ob_ids_dict.setdefault(id_str, [])
                self.scene_ob_ids_dict[id_str] += [d["obj_id"]] * d["inst_count"]

    def get_video_id(self):
        return int(self.base_dir.rstrip("/").split("/")[-1])

    def get_K(self, i_frame):
        K = self.K_table[self.id_strs[i_frame]].copy()
        if self.resize != 1:
            K[:2, :2] *= self.resize
        return K

    def get_instance_ids_in_image(self, i_frame: int):
        ob_ids = []
        if self.scene_gt is not None:
            name = int(self.id_strs[i_frame])
            for k in self.scene_gt[str(name)]:
                ob_ids.append(k["obj_id"])
        elif self.scene_ob_ids_dict:
            return np.array(self.scene_ob_ids_dict[self.id_strs[i_frame]])
        else:
            mask_dir = os.path.dirname(self.color_files[0]).replace("rgb", "mask_visib")
            for f in sorted(glob.glob(f"{mask_dir}/{self.id_strs[i_frame]}_*.png")):
                ob_ids.append(int(os.path.basename(f).split(".")[0].split("_")[1]))
        return np.asarray(ob_ids)

    def get_color(self, i):
        import cv2
        import imageio.v2 as imageio

        color = imageio.imread(self.color_files[i])
        if color.ndim == 2:
            color = np.tile(color[..., None], (1, 1, 3))
        if self.resize != 1:
            color = cv2.resize(color, fx=self.resize, fy=self.resize, dsize=None)
        return color

    def get_depth(self, i):
        import cv2

        f = self.color_files[i].replace("rgb", "depth").replace("gray", "depth")
        depth = _imread(f) * 1e-3 * self.bop_depth_scale
        if self.resize != 1:
            depth = cv2.resize(
                depth, fx=self.resize, fy=self.resize, dsize=None,
                interpolation=cv2.INTER_NEAREST,
            )
        depth[depth < 0.001] = 0
        depth[depth > self.zfar] = 0
        return depth

    def get_mask(self, i_frame: int, ob_id: int, type="mask_visib"):
        import cv2

        if self.scene_gt is None:
            raise RuntimeError("mask lookup needs scene_gt")
        pos = 0
        name = int(self.id_strs[i_frame])
        for k in self.scene_gt[str(name)]:
            if k["obj_id"] == ob_id:
                break
            pos += 1
        mask_file = f"{self.base_dir}/{type}/{name:06d}_{pos:06d}.png"
        if not os.path.exists(mask_file):
            logger.info("%s not found", mask_file)
            return None
        mask = _imread(mask_file)
        if self.resize != 1:
            mask = cv2.resize(
                mask, fx=self.resize, fy=self.resize, dsize=None,
                interpolation=cv2.INTER_NEAREST,
            )
        return mask > 0

    def get_gt_mesh_file(self, ob_id):
        raise NotImplementedError

    def get_gt_mesh(self, ob_id: int) -> TriMesh:
        mesh = load_mesh(self.get_gt_mesh_file(ob_id))
        mesh.vertices = mesh.vertices * 1e-3
        return mesh

    def get_model_diameter(self, ob_id):
        d = os.path.dirname(self.get_gt_mesh_file(self.ob_ids[0]))
        with open(f"{d}/models_info.json") as ff:
            info = json.load(ff)
        return info[str(ob_id)]["diameter"] / 1e3

    def get_gt_poses(self, i_frame, ob_id):
        gt_poses = []
        name = int(self.id_strs[i_frame])
        for k in self.scene_gt[str(name)]:
            if k["obj_id"] == ob_id:
                cur = np.eye(4)
                cur[:3, :3] = np.array(k["cam_R_m2c"]).reshape(3, 3)
                cur[:3, 3] = np.array(k["cam_t_m2c"]) / 1e3
                gt_poses.append(cur)
        return np.asarray(gt_poses).reshape(-1, 4, 4)

    def get_gt_pose(self, i_frame: int, ob_id, mask=None):
        """Multi-instance disambiguation by mask IoU (datareader.py:319-349)."""
        ob_in_cam = np.eye(4)
        best_iou = -np.inf
        name = int(self.id_strs[i_frame])
        for i_k, k in enumerate(self.scene_gt[str(name)]):
            if k["obj_id"] != ob_id:
                continue
            cur = np.eye(4)
            cur[:3, :3] = np.array(k["cam_R_m2c"]).reshape(3, 3)
            cur[:3, 3] = np.array(k["cam_t_m2c"]) / 1e3
            if mask is None:
                return cur
            gt_mask = _imread(
                f"{self.base_dir}/mask_visib/{self.id_strs[i_frame]}_{i_k:06d}.png"
            ).astype(bool)
            union = (gt_mask | mask.astype(bool)).sum()
            iou = float((gt_mask & mask.astype(bool)).sum()) / max(union, 1)
            if iou > best_iou:
                best_iou = iou
                ob_in_cam = cur
        return ob_in_cam

    def load_symmetry_tfs(self):
        d = os.path.dirname(self.get_gt_mesh_file(self.ob_ids[0]))
        with open(f"{d}/models_info.json") as ff:
            info = json.load(ff)
        self.symmetry_tfs = {}
        self.symmetry_info_table = {}
        for ob_id in self.ob_ids:
            self.symmetry_info_table[ob_id] = info[str(ob_id)]
            self.symmetry_tfs[ob_id] = symmetry_tfs_from_info(
                info[str(ob_id)], rot_angle_discrete=5
            )
        self.geometry_symmetry_info_table = copy.deepcopy(self.symmetry_info_table)


class LinemodOcclusionReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "lmo"
        self.K = list(self.K_table.values())[0]
        self.ob_ids = [1, 5, 6, 8, 9, 10, 11, 12]
        self.ob_id_to_names = {
            1: "ape", 2: "benchvise", 3: "bowl", 4: "camera", 5: "water_pour",
            6: "cat", 7: "cup", 8: "driller", 9: "duck", 10: "eggbox",
            11: "glue", 12: "holepuncher", 13: "iron", 14: "lamp", 15: "phone",
        }
        self.load_symmetry_tfs()

    def get_gt_mesh_file(self, ob_id):
        return f"{BOP_DIR}/{self.dataset_name}/models/obj_{ob_id:06d}.ply"


class LinemodReader(LinemodOcclusionReader):
    def __init__(self, base_dir, zfar=np.inf, split=None):
        """split: 'train'/'test' selects the Linemod_preprocessed frame
        subset (datareader.py:400-410). The split files live under
        $LINEMOD_PREPROCESSED_DIR/data/{video_id:02d}/{split}.txt (the
        reference hardcodes its own absolute dataset root)."""
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "lm"
        if split is not None:
            pre_dir = os.getenv("LINEMOD_PREPROCESSED_DIR", "")
            if not pre_dir:
                raise RuntimeError(
                    "LinemodReader(split=...) needs the Linemod_preprocessed "
                    "root: set the LINEMOD_PREPROCESSED_DIR environment "
                    "variable to the directory containing data/{id}/train.txt"
                )
            split_file = (
                f"{pre_dir}/data/{self.get_video_id():02d}/{split}.txt"
            )
            if not os.path.isfile(split_file):
                raise FileNotFoundError(
                    f"Linemod split file not found: {split_file} "
                    "(check LINEMOD_PREPROCESSED_DIR)"
                )
            with open(split_file) as ff:
                lines = ff.read().splitlines()
            self.color_files = [
                f"{self.base_dir}/rgb/{int(line):06d}.png" for line in lines
            ]
            self.make_id_strs()
        # Exclude bowl and mug (datareader.py:413).
        self.ob_ids = np.setdiff1d(np.arange(1, 16), np.array([7, 3])).tolist()
        self.load_symmetry_tfs()

    def get_gt_mesh_file(self, ob_id):
        root = self.base_dir
        while True:
            if os.path.exists(f"{root}/lm_models"):
                return f"{root}/lm_models/models/obj_{ob_id:06d}.ply"
            parent = os.path.abspath(f"{root}/../")
            if parent == root:
                raise FileNotFoundError("lm_models not found above " + self.base_dir)
            root = parent

    def get_reconstructed_mesh(self, ob_id, ref_view_dir) -> TriMesh:
        return load_mesh(
            os.path.abspath(f"{ref_view_dir}/ob_{ob_id:07d}/model/model.obj")
        )


class YcbVideoReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "ycbv"
        self.K = list(self.K_table.values())[0]
        self.ob_ids = np.arange(1, 22).astype(int).tolist()
        if YCB_VIDEO_DIR and os.path.isdir(f"{YCB_VIDEO_DIR}/models"):
            names = sorted(os.listdir(f"{YCB_VIDEO_DIR}/models/"))
            self.ob_id_to_names = {
                ob: names[i]
                for i, ob in enumerate(self.ob_ids)
                if i < len(names)
            }
            self.name_to_ob_id = {v: k for k, v in self.ob_id_to_names.items()}
        if "BOP" not in self.base_dir:
            kf = f"{self.base_dir}/../../keyframe.txt"
            if os.path.exists(kf):
                with open(kf) as ff:
                    self.keyframe_lines = ff.read().splitlines()
        self.load_symmetry_tfs()
        # Manual geometric-symmetry overrides (datareader.py:455-479).
        for ob_id in self.ob_ids:
            if ob_id in [1, 4, 6, 18]:  # cylinders
                self.geometry_symmetry_info_table[ob_id] = {
                    "symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}],
                    "symmetries_discrete": np.asarray(
                        _rot_tfs([(0, np.pi, 0)])
                    ).reshape(1, 4, 4).tolist(),
                }
            elif ob_id in [13]:
                self.geometry_symmetry_info_table[ob_id] = {
                    "symmetries_continuous": [{"axis": [0, 0, 1], "offset": [0, 0, 0]}],
                }
            elif ob_id in [2, 3, 9, 21]:  # rectangular boxes
                tfs = _rot_tfs(
                    [(rx, ry, rz) for rz in [0, np.pi] for rx in [0, np.pi] for ry in [0, np.pi]]
                )
                self.geometry_symmetry_info_table[ob_id] = {
                    "symmetries_discrete": np.asarray(tfs).reshape(-1, 4, 4).tolist(),
                }

    def get_gt_mesh_file(self, ob_id):
        return os.path.abspath(
            f"{self.base_dir}/../../ycbv_models/models/obj_{ob_id:06d}.ply"
        )

    def get_gt_mesh(self, ob_id: int, get_posecnn_version=False) -> TriMesh:
        """get_posecnn_version: the original YCB-Video (PoseCNN) mesh in
        meters from $YCB_VIDEO_DIR/models/<name>/textured_simple.obj —
        the coordinate/mesh convention PoseCNN-era baselines evaluate
        against (datareader.py:489-505)."""
        if get_posecnn_version:
            name = self.ob_id_to_names[ob_id]
            return load_mesh(
                f"{YCB_VIDEO_DIR}/models/{name}/textured_simple.obj"
            )
        return super().get_gt_mesh(ob_id)

    def get_reconstructed_mesh(self, ob_id, ref_view_dir) -> TriMesh:
        return load_mesh(
            os.path.abspath(f"{ref_view_dir}/ob_{ob_id:07d}/model/model.obj")
        )

    def is_keyframe(self, i):
        frame_id = int(os.path.basename(self.color_files[i]).split(".")[0])
        key = f"{self.get_video_id():04d}/{frame_id:06d}"
        return key in getattr(self, "keyframe_lines", [])


class TlessReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "tless"
        self.ob_ids = np.arange(1, 31).astype(int).tolist()
        self.load_symmetry_tfs()

    def get_gt_mesh_file(self, ob_id):
        return f"{self.base_dir}/../../../models_cad/obj_{ob_id:06d}.ply"

    def get_gt_mesh(self, ob_id) -> TriMesh:
        mesh = load_mesh(self.get_gt_mesh_file(ob_id))
        mesh.vertices = mesh.vertices * 1e-3
        # CAD models are untextured: assign a uniform gray like the
        # reference (datareader.py:549-551).
        mesh.vertex_colors = np.full((len(mesh.vertices), 3), 200, dtype=np.uint8)
        return mesh


class HomebrewedReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "hb"
        self.ob_ids = np.arange(1, 34).astype(int).tolist()
        self.load_symmetry_tfs()
        self.make_scene_ob_ids_dict()

    def get_gt_mesh_file(self, ob_id):
        return f"{self.base_dir}/../../../hb_models/models/obj_{ob_id:06d}.ply"

    def get_gt_pose(self, i_frame, ob_id, mask=None):
        logger.info("HomeBrewed has no GT poses")
        return np.eye(4)


class ItoddReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "itodd"
        self.ob_ids = np.arange(1, 29).astype(int).tolist()
        self.load_symmetry_tfs()
        self.make_scene_ob_ids_dict()

    def get_gt_mesh_file(self, ob_id):
        return f"{self.base_dir}/../../../itodd_models/models/obj_{ob_id:06d}.ply"


class IcbinReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "icbin"
        self.ob_ids = np.arange(1, 3).astype(int).tolist()
        self.load_symmetry_tfs()

    def get_gt_mesh_file(self, ob_id):
        return f"{self.base_dir}/../../../icbin_models/models/obj_{ob_id:06d}.ply"


class TudlReader(BopBaseReader):
    def __init__(self, base_dir, zfar=np.inf):
        super().__init__(base_dir, zfar=zfar)
        self.dataset_name = "tudl"
        self.ob_ids = np.arange(1, 4).astype(int).tolist()
        self.load_symmetry_tfs()

    def get_gt_mesh_file(self, ob_id):
        return f"{self.base_dir}/../../../tudl_models/models/obj_{ob_id:06d}.ply"


def get_bop_reader(video_dir, zfar=np.inf):
    """Factory matching datareader.py:17-33."""
    if "ycbv" in video_dir or "YCB" in video_dir:
        return YcbVideoReader(video_dir, zfar=zfar)
    if "lmo" in video_dir or "LINEMOD-O" in video_dir:
        return LinemodOcclusionReader(video_dir, zfar=zfar)
    if "tless" in video_dir or "TLESS" in video_dir:
        return TlessReader(video_dir, zfar=zfar)
    if "hb" in video_dir:
        return HomebrewedReader(video_dir, zfar=zfar)
    if "tudl" in video_dir:
        return TudlReader(video_dir, zfar=zfar)
    if "icbin" in video_dir:
        return IcbinReader(video_dir, zfar=zfar)
    if "itodd" in video_dir:
        return ItoddReader(video_dir, zfar=zfar)
    raise RuntimeError(f"unknown BOP dataset for {video_dir}")


def get_bop_video_dirs(dataset):
    """Standard BOP test-scene directory globs (datareader.py:36-53)."""
    patterns = {
        "ycbv": f"{BOP_DIR}/ycbv/test/*",
        "lmo": f"{BOP_DIR}/lmo/lmo_test_bop19/test/*",
        "tless": f"{BOP_DIR}/tless/tless_test_primesense_bop19/test_primesense/*",
        "hb": f"{BOP_DIR}/hb/hb_test_primesense_bop19/test_primesense/*",
        "tudl": f"{BOP_DIR}/tudl/tudl_test_bop19/test/*",
        "icbin": f"{BOP_DIR}/icbin/icbin_test_bop19/test/*",
        "itodd": f"{BOP_DIR}/itodd/itodd_test_bop19/test/*",
    }
    if dataset not in patterns:
        raise RuntimeError(f"unknown dataset {dataset}")
    return sorted(glob.glob(patterns[dataset]))
