"""Result charts — the port of ``kubernetes_rescheduling_tpu.bench.plots``.
matplotlib is imported inside each function, never at module import.

The reference publishes three normalized bar charts
(result/*.png: node CPU-std, communication cost, response time; SURVEY.md §6)
but not the script that made them. This module regenerates all three from a
harness ``summary.json``, with the same normalizations:

- node CPU-std:        Before = 1.0   (reference result/Node standard.png)
- communication cost:  spread = 1.0   (reference result/communication cost.png)
- response time:       Before = 1.0   (reference result/responsetime.png)

Design: one measure across algorithms → single-series bars, one neutral hue
with the CAR/global bars accented, direct value labels, no legend (the title
names the single series), light grid behind thin bars.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_BAR = "#9aa5b1"      # neutral series hue
_ACCENT = "#4269d0"   # the subject policies (communication/global)
_INK = "#2b2f36"


def _plot_bar(ax, labels, values, title, accent_on=("communication", "global")):
    import matplotlib

    xs = np.arange(len(labels))
    colors = [
        _ACCENT if any(l == a or l.startswith(f"{a} ") for a in accent_on) else _BAR
        for l in labels
    ]
    ax.bar(xs, values, width=0.62, color=colors, zorder=2)
    for x, v in zip(xs, values):
        ax.text(x, v, f"{v:.2f}", ha="center", va="bottom", fontsize=9, color=_INK)
    ax.set_xticks(xs, labels, rotation=20, ha="right", fontsize=9)
    ax.set_title(title, fontsize=11, color=_INK, loc="left")
    ax.grid(axis="y", color="#e3e6ea", linewidth=0.8, zorder=0)
    ax.spines[["top", "right"]].set_visible(False)
    ax.tick_params(colors=_INK)
    ax.margins(y=0.15)


def merge_summaries(base: dict, extras: list[tuple[str, dict]]) -> dict:
    """One summary whose runs include labeled configuration variants.

    ``extras`` entries are ``(label, summary)``; their runs appear as
    ``"<algorithm> <label>"`` bars — how the wave-capped global
    configuration (``global_moves_cap=k``) shows up next to the uncapped
    one in the disruption chart. ``base``'s per-run-derived ``aggregate``
    is dropped rather than copied stale — the merged dict describes its
    runs, nothing else."""
    runs = list(base["runs"])
    for label, s in extras:
        for r in s["runs"]:
            runs.append({**r, "algorithm": f"{r['algorithm']} {label}"})
    return {k: v for k, v in base.items() if k != "aggregate"} | {"runs": runs}


def plot_summary(summary: dict | str | Path, out_dir: str | Path) -> list[Path]:
    """Write the three normalized charts from a harness summary.

    Accepts the summary dict or a path to ``summary.json``. Returns the
    written file paths.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if not isinstance(summary, dict):
        summary = json.loads(Path(summary).read_text())

    runs = summary["runs"]
    algos = list(dict.fromkeys(r["algorithm"] for r in runs))

    def mean(algo, phase, metric):
        vals = [r[phase][metric] for r in runs if r["algorithm"] == algo]
        return float(np.mean(vals)) if vals else float("nan")

    before_std = float(np.mean([r["before"]["load_std"] for r in runs]))
    before_rt = float(np.mean([r["before"]["response_time_ms"] for r in runs]))
    spread_cost = mean("spread", "after", "communication_cost") if "spread" in algos else 1.0

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: list[Path] = []

    charts = [
        (
            "node_standard.png",
            "Node CPU-usage std-dev (Before = 1.0, lower is better)",
            [mean(a, "after", "load_std") / before_std if before_std else 0 for a in algos],
        ),
        (
            "communication_cost.png",
            "Communication cost (spread = 1.0, lower is better)",
            [
                mean(a, "after", "communication_cost") / spread_cost
                if spread_cost
                else 0
                for a in algos
            ],
        ),
        (
            "responsetime.png",
            "Avg response time (Before = 1.0, lower is better)",
            [mean(a, "after", "response_time_ms") / before_rt if before_rt else 0 for a in algos],
        ),
    ]

    # request-level stats (the reference's release1.sh:74-117 block): tail
    # latency after rescheduling and the disruption paid during it
    def load_mean(algo, phase, metric):
        vals = [
            r["load"][phase][metric]
            for r in runs
            if r["algorithm"] == algo and "load" in r
        ]
        return float(np.mean(vals)) if vals else float("nan")

    if any("load" in r for r in runs):
        charts += [
            (
                "tail_latency.png",
                "p95 response time after rescheduling (ms)",
                [load_mean(a, "after", "latency_p95_ms") for a in algos],
            ),
            (
                "disruption.png",
                "Requests failed while rescheduling (% of phase r2)",
                [100.0 * load_mean(a, "during", "error_rate") for a in algos],
            ),
        ]
    for fname, title, values in charts:
        fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=120)
        _plot_bar(ax, algos, values, title)
        fig.tight_layout()
        path = out / fname
        fig.savefig(path)
        plt.close(fig)
        written.append(path)
    return written


# the two frontier hues, shared by both panels (and both new charts)
_CAP_COLOR = "#1f77b4"   # wave-cap configs
_MC_COLOR = "#d62728"    # move-cost (disruption pricing) configs


def _is_move_cost(config_name: str) -> bool:
    return config_name.startswith("mc")


def plot_disruption_frontier(rows: list[dict], out_dir: str | Path) -> Path:
    """The disruption/quality frontier: wave capping vs move-cost pricing.

    ``rows`` are the measured µBench-matrix aggregates (scripts/frontier.py
    output): each dict carries config / restarts / error_rate_during /
    communication_cost / response_time_ms. Two panels — restarts vs final
    comm cost (the frontier itself; marker AREA scales with the in-flight
    error rate during rescheduling) and response time (the end-user view;
    a config that avoids all disruption by never moving leaves the
    pile-up's queueing latency in place)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    is_mc = [_is_move_cost(r["config"]) for r in rows]
    colors = [_MC_COLOR if m else _CAP_COLOR for m in is_mc]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.2))
    for r, m, color in zip(rows, is_mc, colors):
        ax1.scatter(r["restarts"], r["communication_cost"], c=color,
                    marker="o" if m else "s",
                    s=40 + 600 * r.get("error_rate_during", 0.0), zorder=3)
        ax1.annotate(r["config"], (r["restarts"], r["communication_cost"]),
                     textcoords="offset points", xytext=(6, 4), fontsize=8)
    ax1.set_xlabel("pods restarted during rescheduling")
    ax1.set_ylabel("final communication cost")
    ax1.set_title(
        "disruption vs quality — marker area = error rate during\n"
        "(red: --move-cost, blue: wave cap)"
    )
    ax1.grid(alpha=0.3)

    labels = [r["config"] for r in rows]
    lat = [r["response_time_ms"] for r in rows]
    ax2.bar(range(len(rows)), lat, color=colors)
    ax2.set_xticks(range(len(rows)))
    ax2.set_xticklabels(labels, rotation=30, ha="right", fontsize=8)
    ax2.set_ylabel("response time after (ms)")
    ax2.set_title("what the user sees")
    ax2.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    path = out_dir / "disruption_frontier.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def plot_scale_curve(points: list[dict], out_dir: str | Path) -> Path:
    """Device ms/round vs problem scale for the dense and sparse solvers.

    ``points``: dicts with scale (str label), services (int), solver
    ("dense"/"sparse"), ms (positive float — the y axis is log-scale)
    or None (= cannot allocate)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fig, ax = plt.subplots(figsize=(6.4, 4.2))
    for solver, color in (("dense", _CAP_COLOR), ("sparse", _MC_COLOR)):
        pts = [p for p in points if p["solver"] == solver and p["ms"] is not None]
        ax.plot(
            [p["services"] for p in pts],
            [p["ms"] for p in pts],
            "o-",
            color=color,
            label=f"{solver} pair weights",
        )
        for p in pts:
            ax.annotate(
                f"{p['scale']}\n{p['ms']:.0f} ms",
                (p["services"], p["ms"]),
                textcoords="offset points", xytext=(6, -2), fontsize=8,
            )
    dead = [p for p in points if p["ms"] is None]
    for i, p in enumerate(dead):
        ax.annotate(
            f"{p['scale']}: {p['solver']} cannot allocate",
            (0.02, 0.93 - 0.05 * i),
            xycoords="axes fraction", fontsize=8, color="gray",
        )
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("services")
    ax.set_ylabel("device ms/round (9 sweeps)")
    ax.set_title("solver scale curve")
    ax.grid(alpha=0.3, which="both")
    ax.legend()
    fig.tight_layout()
    path = out_dir / "scale_curve.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


# validated categorical slots (dataviz reference palette, fixed order —
# color follows the CONFIG identity, never its rank in a given chart)
_CAT = ("#2a78d6", "#eb6834", "#1baf7a", "#eda100")


def plot_optimality_gap(rows, out_dir) -> "Path":
    """Round-5 solver-quality chart: % above the MILP optimum/incumbent
    per capacity-binding instance, grouped by solver configuration.

    ``rows``: [{"instance": "40x5", "configs": {label: gap_pct, ...}}, ...]
    with every row carrying the SAME config labels (fixed series order).
    A dashed line marks the 10% target; negative bars mean the solver
    beat the MILP's own incumbent."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from pathlib import Path

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    labels = list(rows[0]["configs"].keys())
    n_cfg = len(labels)
    xs = np.arange(len(rows))
    width = 0.8 / n_cfg
    fig, ax = plt.subplots(figsize=(7.2, 3.6))
    for ci, lab in enumerate(labels):
        vals = [r["configs"][lab] for r in rows]
        pos = xs + (ci - (n_cfg - 1) / 2) * width
        ax.bar(pos, vals, width=width * 0.92, color=_CAT[ci], zorder=2,
               label=lab)
        for x, v in zip(pos, vals):
            ax.text(x, v + (0.3 if v >= 0 else -1.2), f"{v:.1f}",
                    ha="center", va="bottom", fontsize=7.5, color=_INK)
    ax.axhline(10.0, color="#9aa5b1", linewidth=1.0, linestyle="--", zorder=1)
    ax.text(len(rows) - 0.5, 10.3, "10% target", fontsize=8, color="#6b7280",
            ha="right")
    ax.axhline(0.0, color=_INK, linewidth=0.8, zorder=1)
    ax.set_xticks(xs, [r["instance"] for r in rows], fontsize=9)
    ax.set_ylabel("% above MILP optimum / incumbent", fontsize=9, color=_INK)
    ax.set_title(
        "optimality gap, capacity-binding instances (round 5)",
        fontsize=11, color=_INK, loc="left",
    )
    ax.grid(axis="y", color="#e3e6ea", linewidth=0.8, zorder=0)
    ax.spines[["top", "right"]].set_visible(False)
    ax.tick_params(colors=_INK)
    ax.legend(fontsize=8, frameon=False, ncols=2)
    ax.margins(y=0.18)
    fig.tight_layout()
    path = out_dir / "optimality_gap.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
