"""register.k2_roofline (%): K2's least time in a register (benchmark/flops.py
k2_work: qkv read and the output written once, QK^T and PV at the bf16
peak; two encoder layers an iteration and the scorer's self-attention at
(hypotheses, 400 tokens), the scorer's cross-attention at (1, hypotheses))
over the device time of K2's kernels (ops/attention_cuda.py,
csrc/attention.cu). Moves register_ms."""

from benchmark import flops
from benchmark.peaks import bound

KERNELS = ("mha_",)


def matches(name):
    return any(k in name for k in KERNELS)


def read(ctx):
    if ctx.kind != "register":
        return None
    spent = ctx.summary.kernel_s(matches)
    if spent == 0:
        return None
    d, c = ctx.driver, ctx.cfg
    dim, tokens = 8 * c["base_width"], (c["input_res"] // 8) ** 2
    self_attn = bound(*flops.k2_work(d.n_hyp, tokens, dim, c["num_heads"]), "bf16")[0]
    cross = bound(*flops.k2_work(1, d.n_hyp, dim, c["num_heads"]), "bf16")[0]
    least = ((2 * d.iters + 1) * self_attn + cross) * ctx.traced.served
    return least / spent * 100.0
