"""register.k1_roofline (%): K1's least time at the register's render
shapes (benchmark/flops.py k1_bytes: the mesh read, color, xyz and mask of
every crop pixel written, at 3.35 TB/s) over the device time of K1's
kernels (ops/raster_cuda.py, csrc/raster.cu: the face-box and raster
kernels). A register renders its hypotheses' crops once an iteration and
once for the scorer. Moves register_ms."""

from benchmark import flops
from benchmark.peaks import bound

KERNELS = ("raster_kernel", "face_box_kernel")


def matches(name):
    return any(k in name for k in KERNELS)


def read(ctx):
    if ctx.kind != "register":
        return None
    spent = ctx.summary.kernel_s(matches)
    if spent == 0:
        return None
    d, c = ctx.driver, ctx.cfg
    renders = d.iters + 1
    nbytes = flops.k1_bytes(d.n_hyp, c["input_res"], c["input_res"], d.mesh.pos.shape[0], d.mesh.faces.shape[0])
    least = renders * bound(nbytes, 0, "f32")[0] * ctx.traced.served
    return least / spent * 100.0
