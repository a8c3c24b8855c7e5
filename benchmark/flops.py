"""Work counted from the configuration's widths and the inputs' shapes.

Model FLOPs count 2 per multiply-add of the convolutions, the linear
layers and the two attention products (QK^T and PV), forward only;
nothing recomputed is counted. The kernels' bytes and operations are the
algorithm's own, from the shapes of its inputs and outputs, so a roofline
reads the same work whoever implements the kernel.
"""
from __future__ import annotations

FF = 512


def _conv(cin, cout, k, hw_out):
    return 2 * cin * k * k * cout * hw_out * hw_out


def trunk(w: int, res: int, c_in: int = 6) -> float:
    """Both crops of one pair through encodeA, the pair through encodeAB."""
    h1, h2, h3 = res // 2, res // 4, res // 8
    a = _conv(c_in, w, 7, h1) + _conv(w, 2 * w, 3, h2) + 4 * _conv(2 * w, 2 * w, 3, h2)
    ab = 4 * _conv(4 * w, 4 * w, 3, h2) + _conv(4 * w, 8 * w, 3, h3) + 4 * _conv(8 * w, 8 * w, 3, h3)
    return 2 * a + ab


def attention(L: int, d: int) -> float:
    """In-projection, QK^T, PV and out-projection of one sequence."""
    return 2 * L * d * 3 * d + 2 * 2 * L * L * d + 2 * L * d * d


def encoder_layer(L: int, d: int, ff: int = FF) -> float:
    return attention(L, d) + 2 * 2 * L * d * ff


def refine_pair(w: int, res: int) -> float:
    """RefineNet on one pair: trunk, two encoder layers, two linear heads."""
    L, d = (res // 8) ** 2, 8 * w
    return trunk(w, res) + 2 * encoder_layer(L, d) + 2 * L * d * (3 + 3)


def score_pair(w: int, res: int) -> float:
    """ScoreNet's per-pair half: trunk and self-attention."""
    L, d = (res // 8) ** 2, 8 * w
    return trunk(w, res) + attention(L, d)


def score_group(n: int, w: int) -> float:
    """ScoreNet's cross-hypothesis attention over n pooled features and logit."""
    d = 8 * w
    return attention(n, d) + 2 * n * d


def register(n_hyp: int, iterations: int, w: int, res: int) -> float:
    return n_hyp * (iterations * refine_pair(w, res) + score_pair(w, res)) + score_group(n_hyp, w)


def track_frame(iterations: int, w: int, res: int) -> float:
    return iterations * refine_pair(w, res)


def train_step(batch: int, w: int, res: int) -> float:
    """Forward, and backward at twice the forward."""
    return 3 * batch * refine_pair(w, res)


def k1_bytes(n_poses: int, h: int, w: int, n_verts: int, n_faces: int) -> float:
    """One render of n_poses crops: the mesh (positions, normals, colors in
    f32, faces in int64) and each pose and crop transform read once; color
    and xyz (f32) and the mask (1 byte) of every pixel written once. Its
    operations (edge tests and interpolation of covered pixels) are far
    below the bytes' time, so the bytes bound it."""
    inputs = n_verts * 9 * 4 + n_faces * 3 * 8 + n_poses * (16 + 9) * 4
    return inputs + n_poses * h * w * (3 * 4 + 3 * 4 + 1)


def k2_work(B: int, L: int, d: int, heads: int, elem_bytes: int = 2):
    """Attention core on packed qkv (B, L, 3d) -> (B, L, d): (bytes,
    operations): qkv read once, the output written once; QK^T and PV."""
    return B * L * 4 * d * elem_bytes, 4 * B * L * L * d
