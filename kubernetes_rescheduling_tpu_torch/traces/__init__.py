"""Trace corpus: recorded cluster data as an input of the control loop — the
port of ``kubernetes_rescheduling_tpu.traces``.

One normalized on-disk form, the ``ClusterTrace`` JSONL schema
(``traces.corpus``), plus adapters from the public cluster-trace layouts
(Alibaba cluster-trace-style and Borg-ClusterData-style CSVs) and a
converter from the loop's own recorded ``rounds.jsonl``
(``traces.adapters``). ``backends.replay.ReplayBackend`` serves a loaded
trace through the ``Backend`` surface, so the unchanged control loop runs
against recorded data in shadow mode (``bench.shadow``): recommend, never
apply, and score against what the recorded scheduler did.

The corpus is host-side Python and numpy; states and graphs become tensors
at ``ClusterState.build`` and :meth:`ClusterTrace.comm_graph`.
"""

from kubernetes_rescheduling_tpu_torch.traces.adapters import (
    load_alibaba_csv,
    load_borg_csv,
    load_shadow_trace,
    rounds_to_trace,
)
from kubernetes_rescheduling_tpu_torch.traces.corpus import (
    ClusterTrace,
    TraceWindow,
    dump_trace_jsonl,
    load_trace_jsonl,
    parse_records,
    window_state,
)

__all__ = [
    "ClusterTrace",
    "TraceWindow",
    "dump_trace_jsonl",
    "load_trace_jsonl",
    "parse_records",
    "window_state",
    "load_alibaba_csv",
    "load_borg_csv",
    "load_shadow_trace",
    "rounds_to_trace",
]
