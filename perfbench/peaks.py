"""The card's published peaks (NVIDIA H100 SXM data sheet, at the full
700 W) and the per-SM pipe rates a score kernel's instructions need."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
SMS = 132
CLOCK_HZ = F32_OPS_PER_S / (SMS * 128 * 2)  # 128 f32 lanes an SM, 2 ops a fused multiply-add
MUFU_PER_SM_CLOCK = 16
IMUL_PER_SM_CLOCK = 64
ISSUE_PER_SM_CLOCK = 128


def bound_ms(nbytes: float, ops: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the float32 rate, in ms."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
