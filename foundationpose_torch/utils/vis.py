"""Host-side visualization helpers (Utils.py:456-479, 675-749).

A copy of foundationpose_tpu/utils/vis.py: numpy in and out, cv2
imported by each function that draws."""
from __future__ import annotations

import numpy as np


def project_3d_to_2d(pt, K, ob_in_cam):
    pt = np.asarray(pt, dtype=np.float64).reshape(4, 1)
    projected = K @ ((ob_in_cam @ pt)[:3, :])
    projected = projected.reshape(-1)
    projected = projected / projected[2]
    return projected[:2].round().astype(int)


def draw_xyz_axis(color, ob_in_cam, scale=0.1, K=np.eye(3), thickness=3,
                  transparency=0, is_input_rgb=False):
    """Draw the object frame axes (red/green/blue = x/y/z)."""
    import cv2

    if is_input_rgb:
        color = cv2.cvtColor(color, cv2.COLOR_RGB2BGR)
    origin = tuple(project_3d_to_2d(np.array([0, 0, 0, 1.0]), K, ob_in_cam))
    tmp = color.copy()
    for axis, col in [
        ([scale, 0, 0, 1.0], (0, 0, 255)),
        ([0, scale, 0, 1.0], (0, 255, 0)),
        ([0, 0, scale, 1.0], (255, 0, 0)),
    ]:
        end = tuple(project_3d_to_2d(np.array(axis), K, ob_in_cam))
        tmp1 = cv2.arrowedLine(
            tmp.copy(), origin, end, color=col, thickness=thickness,
            line_type=cv2.LINE_AA, tipLength=0,
        )
        mask = np.linalg.norm(tmp1.astype(float) - tmp.astype(float), axis=-1) > 0
        tmp[mask] = (
            tmp[mask] * transparency + tmp1[mask] * (1 - transparency)
        ).astype(np.uint8)
    if is_input_rgb:
        tmp = cv2.cvtColor(tmp, cv2.COLOR_BGR2RGB)
    return tmp


def draw_posed_3d_box(K, img, ob_in_cam, bbox, line_color=(0, 255, 0), linewidth=2):
    """bbox: (2, 3) min/max corners in object frame."""
    import cv2

    min_xyz = np.asarray(bbox).min(axis=0)
    max_xyz = np.asarray(bbox).max(axis=0)
    xmin, ymin, zmin = min_xyz
    xmax, ymax, zmax = max_xyz

    def draw_line3d(start, end, img):
        pts = np.stack([start, end]).reshape(-1, 3)
        pts = (ob_in_cam[:3, :3] @ pts.T).T + ob_in_cam[:3, 3]
        projected = (K @ pts.T).T
        uv = np.round(projected[:, :2] / projected[:, 2:3]).astype(int)
        return cv2.line(
            img, uv[0].tolist(), uv[1].tolist(), color=line_color,
            thickness=linewidth, lineType=cv2.LINE_AA,
        )

    for y in [ymin, ymax]:
        for z in [zmin, zmax]:
            img = draw_line3d(np.array([xmin, y, z]), np.array([xmax, y, z]), img)
    for x in [xmin, xmax]:
        for z in [zmin, zmax]:
            img = draw_line3d(np.array([x, ymin, z]), np.array([x, ymax, z]), img)
    for x in [xmin, xmax]:
        for y in [ymin, ymax]:
            img = draw_line3d(np.array([x, y, zmin]), np.array([x, y, zmax]), img)
    return img


def depth_to_vis(depth, zmin=None, zmax=None, mode="rgb", inverse=True):
    import cv2

    depth = np.asarray(depth, dtype=np.float64)
    if zmin is None:
        zmin = depth.min()
    if zmax is None:
        zmax = depth.max()
    if inverse:
        invalid = depth < 0.001
        vis = zmin / (depth + 1e-8)
        vis[invalid] = 0
    else:
        depth = depth.clip(zmin, zmax)
        invalid = (depth == zmin) | (depth == zmax)
        vis = (depth - zmin) / max(zmax - zmin, 1e-12)
        vis[invalid] = 1
    if mode == "gray":
        return (vis * 255).clip(0, 255).astype(np.uint8)
    return cv2.applyColorMap((vis * 255).astype(np.uint8), cv2.COLORMAP_JET)[..., ::-1]


def cv_draw_text(img, text, uv_top_left, color=(255, 255, 255), font_scale=0.5,
                 thickness=1, line_spacing=1.5):
    """Multi-line text kept inside the image (Utils.py:630-655)."""
    import cv2

    H, W = img.shape[:2]
    uv = np.array(uv_top_left, dtype=float)
    for line in text.splitlines():
        (w, h), _ = cv2.getTextSize(line, cv2.FONT_HERSHEY_SIMPLEX, font_scale, thickness)
        org = uv + [0, h]
        org[0] = np.clip(org[0], 0, max(W - w - 1, 0))
        org[1] = np.clip(org[1], h, H - 1)
        cv2.putText(img, line, tuple(org.astype(int)), cv2.FONT_HERSHEY_SIMPLEX,
                    font_scale, color, thickness, cv2.LINE_AA)
        uv[1] = org[1] + h * (line_spacing - 1) + h
    return img


def make_grid_image(imgs, nrow, padding=5, pad_value=255):
    """(B, H, W, C) -> one tiled grid image (torchvision-free)."""
    imgs = [np.asarray(im) for im in imgs]
    H = max(im.shape[0] for im in imgs)
    W = max(im.shape[1] for im in imgs)
    n = len(imgs)
    ncol = nrow
    nrows = int(np.ceil(n / ncol))
    out = np.full(
        (nrows * (H + padding) + padding, ncol * (W + padding) + padding, 3),
        pad_value,
        dtype=np.uint8,
    )
    for i, im in enumerate(imgs):
        if im.ndim == 2:
            im = np.tile(im[..., None], (1, 1, 3))
        r, c = divmod(i, ncol)
        y = padding + r * (H + padding)
        x = padding + c * (W + padding)
        out[y : y + im.shape[0], x : x + im.shape[1]] = im[..., :3].astype(np.uint8)
    return out


def write_png(path, rgb):
    """Write an (H, W, 3) uint8 RGB image: imageio where it is installed,
    else cv2 (which takes BGR)."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        import cv2

        cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1]))
    else:
        imageio.imwrite(path, rgb)


def read_rgb(path):
    """Read a color image as (H, W, 3) uint8 RGB: imageio where it is
    installed, else cv2 (which reads BGR)."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        import cv2

        return np.ascontiguousarray(cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])
    return imageio.imread(path)[..., :3]
