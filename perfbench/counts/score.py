"""Kernel 2, the score (``ops/csrc/score.cu``): M read once, six row vectors
and five node vectors read, five row outputs written; and its
instructions a (row, node) pair on the pipes that run them, as read from
the SASS nvcc 12.8 emits for sm_90a: the IEEE division (one MUFU
reciprocal and 7 others), with noise two ``logf`` (26 each) and the u32
mixer (2 integer multiplies and 12 others), and the score's own 23. The
issue rate decides: 97 instructions a pair with noise, 31 without."""

from perfbench import peaks

SYMBOL = "score_kernel"
DIV = {"mufu": 1, "other": 7}
LOGF = {"other": 26}
MIXER = {"imul": 2, "other": 12}
BODY = {"other": 23}


def score_bytes(C: int, N: int) -> int:
    return C * N * 4 + C * (4 * 5 + 1) + N * (4 * 4 + 1) + C * 4 * 5


def bound_ms(C: int, N: int, noise: bool = True, nbytes: float | None = None,
             extra_ops: float = 0.0) -> float:
    """``nbytes`` and ``extra_ops`` (issued with the rest) are a kernel's
    that scores a mass of its own (kernel 6)."""
    parts = [DIV, BODY] + ([LOGF, LOGF, MIXER] if noise else [])
    per = {k: sum(p.get(k, 0) for p in parts) for k in ("mufu", "imul", "other")}
    pairs = C * N
    rate = peaks.SMS * peaks.CLOCK_HZ
    t_ops = max(pairs * per["mufu"] / (peaks.MUFU_PER_SM_CLOCK * rate),
                pairs * per["imul"] / (peaks.IMUL_PER_SM_CLOCK * rate),
                (pairs * sum(per.values()) + extra_ops) / (peaks.ISSUE_PER_SM_CLOCK * rate))
    nbytes = score_bytes(C, N) if nbytes is None else nbytes
    return max(t_ops, nbytes / peaks.HBM_BYTES_PER_S) * 1e3
