"""kubernetes_rescheduling_tpu_torch — the PyTorch/CUDA port of
``kubernetes_rescheduling_tpu``.

Same module layout and public names as the JAX package, so every function
here has its counterpart at the same path there. Inside, PyTorch idiom:
dataclasses of tensors that carry an explicit ``device``, plain functions on
tensors, ``torch.Generator`` for all randomness. The TPU's Pallas kernels
are hand-written CUDA kernels for Hopper (``ops/csrc``), each with its plain
PyTorch version beside it in the same module.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.

The package never imports ``jax`` or the JAX package.
"""

import torch

# The plain float32 products around the kernels (loads, swap contractions,
# the admission race's plain version) must stay exact, as the JAX package
# runs them at HIGHEST precision: no TF32 anywhere in the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from kubernetes_rescheduling_tpu_torch.core.state import ClusterState, CommGraph  # noqa: E402

__version__ = "0.1.0"

__all__ = ["ClusterState", "CommGraph", "__version__"]
