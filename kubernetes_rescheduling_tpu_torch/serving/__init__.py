"""The serving plane: request-grain placement as a query service — the port
of ``kubernetes_rescheduling_tpu.serving``.

The round loop answers "which pod should move" once a round; this package
answers "where should THIS pod go, now". :func:`serving.kernel.place_one`
scores one request against the device-resident state with the greedy
machinery; :class:`serving.engine.ServingEngine` coalesces concurrent
arrivals into ONE :func:`serving.kernel.place_batch` (one captured graph on
the card), each row equal to the solo decision. The HTTP front is
``POST /place`` on the ops server (``telemetry/server.py``:
``OpsPlane.bind_serving``).
"""

from kubernetes_rescheduling_tpu_torch.serving.engine import (
    OUTCOME_NO_CANDIDATE,
    OUTCOME_PLACED,
    OUTCOME_SHED,
    OUTCOME_TIMEOUT,
    PlaceResult,
    ServingEngine,
)
from kubernetes_rescheduling_tpu_torch.serving.kernel import place_batch, place_one

__all__ = [
    "OUTCOME_NO_CANDIDATE",
    "OUTCOME_PLACED",
    "OUTCOME_SHED",
    "OUTCOME_TIMEOUT",
    "PlaceResult",
    "ServingEngine",
    "place_batch",
    "place_one",
]
