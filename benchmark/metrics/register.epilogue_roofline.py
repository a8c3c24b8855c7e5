"""register.epilogue_roofline (%): the layer epilogues' least time in a
register over the device time of the fused epilogue kernel
(ops/epilogue_cuda.py, csrc/epilogue.cu). The least bytes: each epilogue
reads its product and, where it has one, its residual, and writes its
output once, in the configuration's compute type; the per-channel
parameters are left out. A register runs RefineNet `register_iterations`
times and ScoreNet once on its hypotheses, at 3.35 TB/s. Nothing to read
where the kernel did not run. Moves register_ms."""

from benchmark.peaks import bound

KERNELS = ("fp_epilogue",)
ELEM_BYTES = {"bfloat16": 2, "float32": 4}


def matches(name):
    return any(k in name for k in KERNELS)


def trunk_elements(w: int, res: int):
    """(outputs, residual elements read) of the conv epilogues of one pair:
    both crops through encodeA (the 7x7 and a 3x3 stride-2 ConvBNReLU, two
    residual blocks at 2w), the pair through encodeAB (two residual blocks
    at 4w, a stride-2 ConvBNReLU, two residual blocks at 8w). A block's
    second conv reads the residual."""
    a2, a4, a8 = (res // 2) ** 2, (res // 4) ** 2, (res // 8) ** 2
    out = 2 * (a2 * w + 5 * a4 * 2 * w) + 4 * a4 * 4 * w + 5 * a8 * 8 * w
    resid = 2 * 2 * a4 * 2 * w + 2 * a4 * 4 * w + 2 * a8 * 8 * w
    return out, resid


def refine_elements(n: int, w: int, res: int, ff: int):
    """(outputs, residual elements) of one RefineNet forward on n pairs: the
    trunk, the two heads' encoder layers over 400 tokens a pair (in- and
    out-projection, the feed-forward; out_proj and linear2 read the
    residual) and their output layers (3 + 3 outputs a token)."""
    tokens, d = n * (res // 8) ** 2, 8 * w
    out, resid = trunk_elements(w, res)
    return n * out + 2 * tokens * (3 * d + d + ff + d) + tokens * 6, n * resid + 2 * tokens * 2 * d


def score_elements(n: int, w: int, res: int):
    """(outputs, residual elements) of one ScoreNet forward on a group of n
    pairs: the trunk, the self-attention's projections per pair, the
    cross-attention's over the n pooled features, the logit."""
    tokens, d = n * (res // 8) ** 2, 8 * w
    out, resid = trunk_elements(w, res)
    return n * out + tokens * 4 * d + n * 4 * d + n, n * resid


def register_bytes(cfg: dict, n_hyp: int, iters: int) -> int:
    """Each output read as a product and written once, each residual read."""
    w, res = cfg["base_width"], cfg["input_res"]
    r_out, r_res = refine_elements(n_hyp, w, res, cfg["feed_forward"])
    s_out, s_res = score_elements(n_hyp, w, res)
    return ELEM_BYTES[cfg["compute_dtype"]] * (iters * (2 * r_out + r_res) + 2 * s_out + s_res)


def read(ctx):
    if ctx.kind != "register":
        return None
    spent = ctx.summary.kernel_s(matches)
    if spent == 0:
        return None
    d = ctx.driver
    least = bound(register_bytes(ctx.cfg, d.n_hyp, d.iters), 0, "f32")[0] * ctx.traced.served
    return least / spent * 100.0
