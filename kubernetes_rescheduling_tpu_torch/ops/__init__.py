"""Hand-written Hopper kernels, each beside its plain PyTorch version: the
chunk step of the dense solver (``fused_admission``), the sparse neighbor
mass (``sparse_mass``), the chunk's swap phase (``swap``, whose plain twin
is ``solver/swap.py``), the sparse input cost's same-node pod pairs
(``pod_cost``), and the build that compiles them at first use
(``_build``). :func:`launch_counts` reads every wrapper's count of kernel
launches."""

from kubernetes_rescheduling_tpu_torch.ops.fused_admission import (
    admission_stage,
    fused_neighbor_mass,
    fused_score_admission,
    reference_score_admission,
    score_stage,
)
from kubernetes_rescheduling_tpu_torch.ops.pod_cost import pod_pair_cross
from kubernetes_rescheduling_tpu_torch.ops.sparse_mass import (
    hub_neighbor_mass,
    sparse_mass_score,
    sparse_neighbor_mass,
)
from kubernetes_rescheduling_tpu_torch.ops.swap import swap_decide, swap_desire

KERNEL_WRAPPERS = (
    fused_neighbor_mass, score_stage, admission_stage,
    sparse_neighbor_mass, hub_neighbor_mass, sparse_mass_score,
    swap_desire, swap_decide, pod_pair_cross,
)


def reset_launch_counts() -> None:
    """Zero every kernel wrapper's launch count."""
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


__all__ = [
    "KERNEL_WRAPPERS",
    "admission_stage",
    "fused_neighbor_mass",
    "fused_score_admission",
    "hub_neighbor_mass",
    "launch_counts",
    "pod_pair_cross",
    "reference_score_admission",
    "reset_launch_counts",
    "score_stage",
    "sparse_mass_score",
    "sparse_neighbor_mass",
    "swap_decide",
    "swap_desire",
]
