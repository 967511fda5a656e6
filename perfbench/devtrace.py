"""The reduction of a profiler trace of the window to the device's busy
time, its idle gaps and the time of each kernel.

The window's rounds are delimited by the harness's ``perfbench/mark``
annotations, one when the window opens and one at each round's end. Busy
time is the union of the intervals in which an operation ran on the
device (kernels, copies, fills), clipped to the traced rounds; an idle gap
is labelled with the innermost harness span (``perfbench/<name>``) the
host was in when the gap began.
"""

from __future__ import annotations

import importlib
import pkgutil
import re
from dataclasses import dataclass

from perfbench import counts

MARK = "perfbench/mark"
OUTSIDE = "outside harness spans"
NAME_CHARS = 160


def short_name(name: str) -> str:
    """A device operation's name, without the leading ``void`` and cut to
    ``NAME_CHARS`` characters (template kernels' names run to thousands)."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def kernel_symbols() -> dict[str, str]:
    """Kernel name → trace symbol, one entry a module of ``perfbench.counts``."""
    out = {}
    for m in pkgutil.iter_modules(counts.__path__):
        mod = importlib.import_module(f"perfbench.counts.{m.name}")
        out[m.name] = mod.SYMBOL
    return out


def symbol_pattern(symbol: str) -> re.Pattern:
    return re.compile(rf"(?<![A-Za-z0-9_]){re.escape(symbol)}(?![A-Za-z0-9_])")


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclass
class Summary:
    rounds: int
    window_s: float
    busy_s: float
    kernels: dict[str, tuple[int, float]]   # kernel → (launches, device seconds)
    device_ops: list[tuple[str, float]]     # by device seconds, largest first
    idle_gaps: list[tuple[str, float]]      # idle seconds by host span, largest first

    def breakdown(self) -> dict:
        return {"device_ops": [[n, s] for n, s in self.device_ops[:10]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


def summarize(events, traced_rounds: int) -> Summary | None:
    """The summary of ``events`` (the profiler's kineto events) over the
    traced rounds; None when the trace holds no device operation."""
    if not events:
        return None
    marks, spans, device = [], [], []
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation() and e.duration_ns() > 0:
                device.append((e.start_ns(), e.end_ns(), name))
        elif name == MARK:
            marks.append(e.start_ns())
        elif name.startswith("perfbench/"):
            spans.append((e.start_ns(), e.end_ns(), name[len("perfbench/"):]))
    marks.sort()
    marks = marks[:traced_rounds + 1]
    if len(marks) < 2 or not device:
        return None
    w0, w1 = marks[0], marks[-1]
    clipped = [(max(a, w0), min(b, w1), n) for a, b, n in device if b > w0 and a < w1]
    if not clipped:
        return None
    busy = union([(a, b) for a, b, _ in clipped])
    busy_ns = sum(b - a for a, b in busy)

    by_name: dict[str, float] = {}
    for a, b, n in clipped:
        n = short_name(n)
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-9
    kernels = {}
    for kernel, symbol in kernel_symbols().items():
        pat = symbol_pattern(symbol)
        hits = [(a, b) for a, b, n in clipped if pat.search(n)]
        if hits:
            kernels[kernel] = (len(hits), sum(b - a for a, b in hits) * 1e-9)

    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    # idle time by what the host was doing: each gap split over the harness
    # spans it overlaps (they do not overlap each other), the rest outside
    spans.sort()
    idle: dict[str, float] = {}
    j = 0
    for a, b in gaps:
        covered = 0
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            s, e, n = spans[k]
            part = min(b, e) - max(a, s)
            if part > 0:
                idle[n] = idle.get(n, 0.0) + part * 1e-9
                covered += part
            k += 1
        rest = (b - a) - covered
        if rest > 0:
            idle[OUTSIDE] = idle.get(OUTSIDE, 0.0) + rest * 1e-9
    return Summary(
        rounds=len(marks) - 1, window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
        kernels=kernels,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1]),
        idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1]),
    )
