"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the least time a kernel's work
can take on it."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "f32": 67e12}


def bound(nbytes: float, ops: float, kind: str):
    """The larger of the bytes that must move (each input read once, each
    output written once) over the memory rate and the operations over the
    peak rate of their type. Returns (seconds, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
