"""Hand-written Hopper kernels for the solver's chunk step, each beside its
plain PyTorch version (``fused_admission``), and the build that compiles
them at first use (``_build``)."""

from kubernetes_rescheduling_tpu_torch.ops.fused_admission import (
    admission_stage,
    fused_neighbor_mass,
    fused_score_admission,
    reference_score_admission,
)

__all__ = [
    "admission_stage",
    "fused_neighbor_mass",
    "fused_score_admission",
    "reference_score_admission",
]
