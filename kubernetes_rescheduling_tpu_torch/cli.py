"""Command line of the port: ``reschedule`` (the control loop on the
simulator), ``bench`` (the experiment matrix), ``solve`` (one global
rescheduling round), ``trace`` (online rescheduling over a streaming trace)
and ``telemetry`` (a run's artifacts rendered), printing the JSON keys (or
the report text) of the JAX package's commands.

    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm car --imbalance
    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm global --scenario large
    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm global --global-moves-cap 10
    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm global --placement-unit pod
    python -m kubernetes_rescheduling_tpu_torch reschedule --scenario large --scan-block 10
    python -m kubernetes_rescheduling_tpu_torch reschedule --scenario large --pipeline
    python -m kubernetes_rescheduling_tpu_torch reschedule --churn-profile diurnal-autoscale
    python -m kubernetes_rescheduling_tpu_torch reschedule --fleet 16 --scenario mubench --imbalance
    python -m kubernetes_rescheduling_tpu_torch reschedule --fleet 4 --scenario large --algorithm global
    python -m kubernetes_rescheduling_tpu_torch reschedule --fleet 4 --algorithm global --restarts 2
    torchrun --nproc-per-node 4 -m kubernetes_rescheduling_tpu_torch reschedule --fleet 8 --fleet-plane dp
    python -m kubernetes_rescheduling_tpu_torch reschedule --algorithm proactive --churn-profile diurnal-autoscale
    python -m kubernetes_rescheduling_tpu_torch reschedule --serve 0 --metrics-out m.jsonl --trace-out t.json
    python -m kubernetes_rescheduling_tpu_torch reschedule --serve 0 --place --imbalance
    python -m kubernetes_rescheduling_tpu_torch reschedule --shadow tests/fixtures/shadow --algorithm global
    python -m kubernetes_rescheduling_tpu_torch reschedule --backend k8s --namespace default
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large --sparse
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large --placement-unit pod
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large --latency-budget 100
    python -m kubernetes_rescheduling_tpu_torch solve --scenario large --restarts 4
    torchrun --nproc-per-node 2 -m kubernetes_rescheduling_tpu_torch solve --scenario large --tp 2
    python -m kubernetes_rescheduling_tpu_torch trace --steps 12
    python -m kubernetes_rescheduling_tpu_torch bench --scenario mubench --repeats 1 --session s
    python -m kubernetes_rescheduling_tpu_torch telemetry perf result/session_s/perf_ledger.jsonl

All run on the card unless ``--device cpu`` is given. ``--sparse`` (and
``reschedule --solver-backend sparse``) solves on the block-local sparse
form of the scenario's graph; ``--placement-unit pod`` re-places every pod
on its own, on the pod-level sparse graph; ``--latency-budget`` picks the
sweep count that fills that many ms of device time a round
(``solver/autotune.py``). ``reschedule --pipeline`` runs the pipelined
schedule, ``--scan-block K`` the scanned one (K rounds a device block, with
the in-block tripwires), and ``--churn-profile`` churns the cluster between
rounds. ``reschedule --fleet N`` runs N tenants under the multiplexed fleet
loop (``bench/fleet.py``). ``reschedule --algorithm proactive`` decides
against the forecast plane's predicted next window (``--forecast-*`` set
its ``ForecastConfig``). ``--serve PORT`` runs the live ops plane beside the
loop (``/metrics``, ``/healthz``, ``/events``, ``/tenants``, ``/slo``,
``/query``, ``POST /profile``; the flight recorder and the SLO watchdog;
``--place`` adds the serving engine behind ``POST /place``), and
``--metrics-out`` / ``--trace-out`` write the metrics registry (JSONL and a
``.prom`` exposition) and the host-side spans (Chrome trace JSON), each with
a run manifest. ``reschedule --shadow TRACE`` replays a recorded cluster
trace (a native ``.jsonl`` file, or a directory of Alibaba- or Borg-style
CSVs) in shadow mode: recommendations are recorded, never applied, and
scored against the trace's scheduler (the output's ``shadow`` block).
``--backend k8s`` drives a live cluster through the ``kubernetes`` client
(``--namespace``, ``--workmodel``), pacing 15 s between rounds.
``--restarts N`` makes every global solve a best-of-N (in sequence on one
device, over the dp ranks of a process group); ``--tp T`` shards each
solve's node axis over T ranks of the process group ``torchrun`` starts
(the CLI joins it when ``WORLD_SIZE`` is set), and on one device fails with
the JAX package's message. With ``--fleet``, ``--restarts N`` runs each
tenant's best-of-N inside the fleet's one program, and ``--fleet-plane dp``
shards the tenants over the ranks of that process group (``/devices`` and
``--slo-mesh-imbalance-ratio`` read its mesh plane). Under ``torchrun``
every rank runs the command; only rank 0 prints, serves the ops plane and
writes ``--metrics-out`` / ``--trace-out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

import torch

from kubernetes_rescheduling_tpu_torch.bench.controller import run_controller
from kubernetes_rescheduling_tpu_torch.bench.harness import SCENARIOS, make_backend
from kubernetes_rescheduling_tpu_torch.bench.trace import (
    bookinfo_workmodel,
    canary_trace,
    load_trace,
    replay,
)
from kubernetes_rescheduling_tpu_torch.config import (
    POLICY_NAMES,
    FleetConfig,
    ForecastConfig,
    PerfConfig,
    RescheduleConfig,
    ServingConfig,
    ShadowConfig,
    SloConfig,
)
from kubernetes_rescheduling_tpu_torch.core.sparsegraph import from_comm_graph
from kubernetes_rescheduling_tpu_torch.core.topology import state_from_workmodel
from kubernetes_rescheduling_tpu_torch.core.workmodel import Workmodel
from kubernetes_rescheduling_tpu_torch.objectives import communication_cost, load_std
from kubernetes_rescheduling_tpu_torch.parallel.mesh import collective_backend, rank_device
from kubernetes_rescheduling_tpu_torch.parallel.sharded import solve_with_restarts
from kubernetes_rescheduling_tpu_torch.solver import (
    GlobalSolverConfig,
    global_assign_pods,
    pod_level_graph,
)
from kubernetes_rescheduling_tpu_torch.solver.autotune import tune_sweeps


ALGO_ALIASES = {"car": "communication"}
WORKMODEL_HELP = ("path to a µBench workmodel JSON (e.g. workmodelC.json); "
                  "overrides the scenario's builtin topology")


def _norm_algo(name: str) -> str:
    name = name.strip().lower()
    return ALGO_ALIASES.get(name, name)


def _moves_per_round(value: str) -> int | str:
    if value == "all":
        return "all"
    try:
        n = int(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected a positive int or 'all', got {value!r}")
    if n < 1:
        raise argparse.ArgumentTypeError(f"expected a positive int or 'all', got {value!r}")
    return n


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kubernetes_rescheduling_tpu_torch",
        description="Communication-aware Kubernetes rescheduling on PyTorch/CUDA",
    )
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("reschedule", help="run the rescheduling control loop")
    r.add_argument("--algorithm", default="communication",
                   help="spread|binpack|random|kubescheduling|communication|car|global|"
                        "proactive")
    r.add_argument("--backend", default="sim", choices=["sim", "k8s"],
                   help="sim (the simulator) or k8s (a live cluster through the kubernetes "
                        "client)")
    r.add_argument("--namespace", default="default",
                   help="the k8s backend's namespace")
    r.add_argument("--scenario", default="mubench", choices=SCENARIOS)
    r.add_argument("--workmodel", default=None, help=WORKMODEL_HELP)
    r.add_argument("--rounds", type=int, default=10)
    r.add_argument("--threshold", type=float, default=30.0)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--imbalance", action="store_true",
                   help="inject the cordon-style imbalance before starting")
    r.add_argument("--moves-per-round", type=_moves_per_round, default=1,
                   help="deployments moved per round: a positive int "
                        "(1 = reference-faithful) or 'all' (global solve)")
    r.add_argument("--balance-weight", type=float, default=0.0,
                   help="λ: comm-cost edges traded per load-std point (global algorithm)")
    r.add_argument("--capacity-frac", type=float, default=None,
                   help="enable capacity enforcement with this packing budget "
                        "(fraction of node capacity)")
    r.add_argument("--restarts", type=int, default=1,
                   help="best-of-N global solves per round over the mesh")
    r.add_argument("--tp", type=int, default=1,
                   help="node-axis devices per solve (the node-sharded solver over tp ranks)")
    r.add_argument("--move-cost", type=float, default=0.0,
                   help="disruption pricing: comm-weight units per restarted pod "
                        "inside the global solve (0 = moves are free)")
    r.add_argument("--solver-backend", default="dense", choices=["dense", "sparse"],
                   help="pair-weight storage for global rounds (sparse = block-local form)")
    r.add_argument("--global-moves-cap", type=_moves_per_round, default="all",
                   help="apply only the k highest-gain improving moves per "
                        "global round ('all' = uncapped)")
    r.add_argument("--placement-unit", default="service", choices=["service", "pod"],
                   help="pod = every replica places independently (global algorithm)")
    r.add_argument("--fleet", type=int, default=0, metavar="N",
                   help="fleet mode: N tenants of the scenario (tenant t seeded seed*1000+t) "
                        "under the multiplexed loop, one boundary and breaker a tenant and "
                        "ONE device decision a round (greedy policies, or --algorithm global)")
    r.add_argument("--fleet-plane", default="vmap", choices=["vmap", "dp"],
                   help="device batching for --fleet: 'vmap' (one program over the "
                        "tenants) or 'dp' (a block of tenants a rank of the process group "
                        "torchrun starts, the blocks gathered; one process: the vmap "
                        "program)")
    r.add_argument("--fleet-chaos-tenants", default="", metavar="I,J,...",
                   help="tenant indices the --chaos-profile wraps (empty = every tenant; "
                        "tenant t's faults seeded --chaos-seed + t)")
    r.add_argument("--shadow", default=None, metavar="TRACE",
                   help="shadow mode: replay a recorded cluster trace (a native ClusterTrace "
                        ".jsonl file, or a directory of Alibaba-style machines/containers CSVs "
                        "or Borg-style machine_events/task_usage CSVs), recommend moves WITHOUT "
                        "applying any, and score our counterfactual placement against what the "
                        "trace's scheduler actually did")
    r.add_argument("--shadow-format", default="auto",
                   choices=["auto", "native", "alibaba", "borg"],
                   help="force the --shadow trace layout (auto detects from the path's "
                        "contents)")
    r.add_argument("--shadow-win-margin", type=float, default=0.0,
                   help="undercut a shadow round must achieve to count as a win: "
                        "counterfactual cost <= actual * (1 - margin); 0 = ties count as wins")
    r.add_argument("--perf-ledger", default=None, metavar="PATH",
                   help="append this run's decisions/sec to the perf ledger at PATH and "
                        "judge it with the [perf] block's rolling-window detector; a "
                        "regression arms the ops plane's perf_regression rule when --serve "
                        "is active (render trends with `telemetry perf PATH`)")
    r.add_argument("--tenant-label-budget", type=int, default=None, metavar="N",
                   help="fleet cardinality budget: fleets of more than N tenants suppress "
                        "the per-tenant labeled series (counted) and observe through the "
                        "device-side rollups (default: the config's tenant_label_budget, 64)")
    _add_resilience_flags(r)
    _add_forecast_flags(r)
    _add_pipeline_flags(r)
    _add_telemetry_flags(r)
    _add_serve_flags(r)
    r.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")

    b = sub.add_parser("bench", help="run the experiment matrix")
    b.add_argument("--backend", default="sim", choices=["sim", "k8s"],
                   help="k8s runs the matrix against the live cluster, like the reference's "
                        "auto_full_pipeline_repeat.sh")
    b.add_argument("--namespace", default="default")
    b.add_argument("--scenario", default="mubench", choices=SCENARIOS)
    b.add_argument("--workmodel", default=None, help=WORKMODEL_HELP)
    b.add_argument("--algorithms",
                   default="spread,binpack,random,kubescheduling,communication,global")
    b.add_argument("--repeats", type=int, default=5)
    b.add_argument("--rounds", type=int, default=10)
    b.add_argument("--out", default="result")
    b.add_argument("--session", default=None,
                   help="named session: re-running with the same name resumes a crashed "
                        "matrix instead of restarting")
    b.add_argument("--moves-per-round", type=_moves_per_round, default=1)
    b.add_argument("--move-cost", type=float, default=0.0,
                   help="disruption pricing in the global solve (see reschedule --move-cost)")
    b.add_argument("--solver-backend", default="dense", choices=["dense", "sparse"],
                   help="pair-weight storage for global rounds")
    b.add_argument("--global-moves-cap", type=_moves_per_round, default="all",
                   help="wave cap for global rounds: apply only the k highest-gain moves "
                        "per round ('all' = uncapped)")
    b.add_argument("--restarts", type=int, default=1,
                   help="best-of-N global solves per round (global algorithm)")
    b.add_argument("--tp", type=int, default=1,
                   help="node-axis devices per solve: each global solve runs as the "
                        "node-sharded solver over tp ranks (composes with --restarts as a "
                        "dp×tp mesh)")
    b.add_argument("--capacity-frac", type=float, default=None,
                   help="enable capacity enforcement with this packing budget (fraction of "
                        "node capacity; global algorithm only)")
    b.add_argument("--observe-weights", action="store_true",
                   help="estimate edge weights from the request stream's traversal counts "
                        "and solve on those instead of the declared workmodel topology")
    b.add_argument("--placement-unit", default="service", choices=["service", "pod"],
                   help="pod = every replica places independently (global algorithm, sim "
                        "backend)")
    b.add_argument("--seed", type=int, default=0)
    _add_resilience_flags(b)
    _add_forecast_flags(b)
    _add_pipeline_flags(b)
    _add_telemetry_flags(b)
    _add_serve_flags(b)
    b.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda)")

    s = sub.add_parser("solve", help="one-shot global solve")
    s.add_argument("--scenario", default="mubench", choices=SCENARIOS)
    s.add_argument("--workmodel", default=None, help=WORKMODEL_HELP)
    s.add_argument("--sweeps", type=int, default=9)
    s.add_argument("--balance-weight", type=float, default=0.0)
    s.add_argument("--capacity-frac", type=float, default=1.0,
                   help="packing budget as a fraction of node capacity "
                        "(solver feasibility + over-budget repulsion)")
    s.add_argument("--move-cost", type=float, default=0.0,
                   help="disruption pricing: comm-weight units per restarted "
                        "pod (0 = moves are free)")
    s.add_argument("--sparse", action="store_true",
                   help="solve on the block-local sparse pair-weight form")
    s.add_argument("--placement-unit", choices=("service", "pod"), default="service",
                   help="pod: re-place every pod independently on the pod-level graph")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--restarts", type=int, default=1,
                   help="best-of-N independent solves over the device mesh (1 = single "
                        "solve)")
    s.add_argument("--tp", type=int, default=1,
                   help="node-axis devices per solve (the node-sharded solver; composes "
                        "with --restarts as a dp×tp mesh)")
    s.add_argument("--latency-budget", type=float, default=None,
                   help="auto-tune the sweep count to fill this many ms of "
                        "device time per round (overrides --sweeps)")
    s.add_argument("--device", default="cuda",
                   help="torch device to solve on (default: cuda)")

    t = sub.add_parser(
        "trace",
        help="streaming trace replay: online rescheduling as edge weights "
             "shift (external workmodel + trace stream, or the builtin "
             "Bookinfo canary rollout demo)",
    )
    t.add_argument("--workmodel", default=None,
                   help="external µBench workmodel JSON to replay over "
                        "(default: builtin Bookinfo)")
    t.add_argument("--trace", default=None,
                   help="external trace stream (JSONL, one step per line: "
                        '{"t": 1.0, "weights": [["a", "b", 0.9], ...]}); '
                        "default: the builtin canary schedule")
    t.add_argument("--steps", type=int, default=12,
                   help="builtin canary steps (ignored with --trace)")
    t.add_argument("--replicas", type=int, default=1,
                   help="replicas per service (builtin workmodel only)")
    t.add_argument("--nodes", type=int, default=3)
    t.add_argument("--sweeps", type=int, default=4)
    t.add_argument("--balance-weight", type=float, default=0.5)
    t.add_argument("--capacity-frac", type=float, default=None,
                   help="enable capacity enforcement with this packing "
                        "budget (fraction of node capacity)")
    t.add_argument("--restarts", type=int, default=1,
                   help="best-of-N solves per trace step over the mesh")
    t.add_argument("--seed", type=int, default=0)
    _add_telemetry_flags(t)
    t.add_argument("--device", default="cuda",
                   help="torch device to replay on (default: cuda)")

    m = sub.add_parser(
        "telemetry",
        help="summarize telemetry artifacts (metrics JSONL, structured event logs, "
             "manifests, Chrome traces, flight-recorder bundles, rounds.jsonl, perf "
             "ledgers) as a readable report",
    )
    m.add_argument("paths", nargs="+",
                   help="artifact files (kind detected from record shape); an optional "
                        "leading mode word selects the rendering: 'report' (default), "
                        "'explain' (decision explanations), 'bundle' (a flight-recorder "
                        "bundle with its explain-consistency verdict), 'perf' (perf-ledger "
                        "JSONL and/or BENCH_r*.json / MULTICHIP_r*.json snapshots: the "
                        "trend table with improved/flat/regressed verdicts), 'topo' (cost "
                        "attribution, node-pair heatmap, move provenance), 'dataset' "
                        "(forecast training windows from rounds.jsonl, the oracle fit "
                        "against persistence), 'shadow' (a --shadow run's head-to-head), "
                        "'fleet' (tenant-rollup quantiles and worst offenders) or 'slo' "
                        "(error budgets and burn sparklines)")
    m.add_argument("--perf-window", type=int, default=5,
                   help="perf mode: prior readings each series is judged against")
    m.add_argument("--perf-threshold", type=float, default=0.2,
                   help="perf mode: fraction above baseline that counts as a regression")
    m.add_argument("--perf-baseline", default="median", choices=["median", "best"],
                   help="perf mode: judge against the window's median or its best reading")
    m.add_argument("--dataset-lags", type=int, default=4,
                   help="dataset mode: lag-feature window length of the training windows")
    m.add_argument("--dataset-ridge", type=float, default=1e-3,
                   help="dataset mode: L2 term of the offline oracle fit scored against "
                        "the persistence baseline")
    return p


def _add_resilience_flags(parser: argparse.ArgumentParser) -> None:
    """Fault injection, churn and the degraded-mode and reconciliation
    knobs, shared by ``reschedule`` and ``bench``; the defaults are the
    config's."""
    d = RescheduleConfig()
    parser.add_argument("--chaos-profile", default="none", metavar="NAME",
                        help="wrap the loop's backend in the fault-injecting ChaosBackend under "
                             "this named profile (none|flaky-monitor|flaky-moves|node-flap|"
                             "soak|reconcile); faults are seeded and counted as "
                             "chaos_faults_total{kind}")
    parser.add_argument("--chaos-seed", type=int, default=0,
                        help="seed for the injected fault stream (reproducible chaos)")
    parser.add_argument("--max-consecutive-failures", type=int,
                        default=d.max_consecutive_failures,
                        help="circuit breaker threshold: consecutive boundary failures before "
                             "the loop opens into safe mode (0 disables the breaker; retries "
                             "still apply)")
    parser.add_argument("--churn-profile", default="none", metavar="NAME",
                        help="elastic topology churn between rounds under this seeded profile "
                             "(none|steady|diurnal-autoscale|deploy-waves|node-flap): services "
                             "deploy and tear down, replicas autoscale, nodes drain and join")
    parser.add_argument("--churn-seed", type=int, default=0,
                        help="seed of the churn event stream")
    parser.add_argument("--no-admission", action="store_true",
                        help="turn off the snapshot admission guard")
    parser.add_argument("--no-reconcile", action="store_true",
                        help="turn off the intent ledger: divergences between intended and "
                             "observed placement go undetected and unrepaired")
    parser.add_argument("--repair-budget", type=int, default=d.repair_budget_per_round,
                        help="corrective moves the reconciliation plane may issue per round "
                             "(0 = detect and count only)")


def _add_pipeline_flags(parser: argparse.ArgumentParser) -> None:
    """The loop's schedules and the scanned schedule's tripwires, shared by
    ``reschedule`` and ``bench``."""
    parser.add_argument("--pipeline", action="store_true",
                        help="the software-pipelined loop: the previous round's round-end "
                             "transfer and record overlap this round's device work, and the "
                             "post-move monitor runs on a background thread; the records equal "
                             "the sequential loop's. Rounds it cannot honor (open breaker, "
                             "churn) drain to the sequential path. With --fleet N: the tenants' "
                             "boundary phases run on a worker pool, each tenant's records equal "
                             "to the serial fleet's")
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        help="depth of the pipelined loop; only 2 is implemented")
    parser.add_argument("--scan-block", type=int, default=0,
                        help="the scanned schedule: K steady-state rounds a device block (decide, "
                             "the simulator's twin and the round-end metrics, one counted "
                             "round_end transfer a block); rounds it cannot honor drain to the "
                             "per-round path. A pinning greedy algorithm with one move a round; "
                             "exclusive with --pipeline. 0 = off")
    parser.add_argument("--no-scan-tripwires", action="store_true",
                        help="turn off the in-block tripwires (device-side health rules in the "
                             "scan body; a trip latches the rest of the block to no-move rounds "
                             "and drains the trip round)")
    parser.add_argument("--tripwire-cost-frac", type=float, default=0.0,
                        help="tripwire cost_regression rule: cost rising more than this fraction "
                             "above the block-start baseline trips (0 = off)")
    parser.add_argument("--tripwire-load-factor", type=float, default=0.0,
                        help="tripwire load_std_spike rule: load std above this factor of the "
                             "block-start baseline trips (0 = off)")
    parser.add_argument("--tripwire-hazard-streak", type=int, default=0,
                        help="tripwire hazard_streak rule: the same most-hazardous node this many "
                             "rounds in a row trips (0 = off)")


def _reconcile_config(args):
    from kubernetes_rescheduling_tpu_torch.config import ReconcileConfig

    return ReconcileConfig(admission=not args.no_admission, enabled=not args.no_reconcile,
                           repair_budget_per_round=args.repair_budget)


def _add_telemetry_flags(parser: argparse.ArgumentParser) -> None:
    """The observability outputs of a run command."""
    parser.add_argument("--metrics-out", default=None, metavar="PATH",
                        help="write the metrics registry as JSONL here, plus a Prometheus "
                             "text exposition at <PATH stem>.prom and a run manifest at "
                             "<PATH stem>.manifest.json")
    parser.add_argument("--trace-out", default=None, metavar="PATH",
                        help="write host-side spans as Chrome trace-event JSON here (load in "
                             "ui.perfetto.dev); also writes the run manifest")


def _add_serve_flags(parser: argparse.ArgumentParser) -> None:
    """The live ops plane of ``reschedule``."""
    parser.add_argument("--serve", type=int, default=None, metavar="PORT",
                        help="serve the live ops plane on 127.0.0.1:PORT while the run "
                             "executes: /metrics, /healthz (breaker + SLO + staleness; 503 "
                             "when unhealthy), /events, /tenants, /slo, /query, POST /profile, "
                             "POST /place (with --place). 0 picks an ephemeral port. Also "
                             "arms the flight recorder (bundle on breaker-open/crash/SIGUSR1) "
                             "and the SLO watchdog")
    parser.add_argument("--bundle-dir", default=None, metavar="DIR",
                        help="where flight-recorder bundles and profiler captures land "
                             "(default: ./flight_recorder)")
    parser.add_argument("--place", action="store_true",
                        help="serving mode: the request-grain placement service behind POST "
                             "/place on the ops server, scoring each request against the "
                             "device-resident state with the run's greedy policy. Requires "
                             "--serve and a greedy algorithm")
    parser.add_argument("--place-max-batch", type=int, default=None, metavar="B",
                        help="serving batcher: the static batch shape dispatches pad to "
                             "(default 8)")
    parser.add_argument("--place-queue-depth", type=int, default=None, metavar="N",
                        help="serving admission queue bound; arrivals beyond it shed "
                             "(default 64)")
    parser.add_argument("--place-window-ms", type=float, default=None, metavar="MS",
                        help="serving batch-formation window (default 2.0)")
    parser.add_argument("--place-deadline-ms", type=float, default=None, metavar="MS",
                        help="default per-request deadline; requests still queued past it "
                             "complete 'timeout' (default 250; 0 = none)")
    parser.add_argument("--slo-serving-p99-ms", type=float, default=0.0, metavar="MS",
                        help="serving_p99 watchdog rule: rolling-window p99 request latency "
                             "above this many ms flips /healthz to 503 and dumps a "
                             "flight-recorder bundle (0 = off)")
    parser.add_argument("--profile-rounds", type=int, default=0, metavar="N",
                        help="arm one torch.profiler capture covering the next N committed "
                             "rounds (a scan block rounds it up to the block); the artifact "
                             "lands as profile_NNN/ under the bundle dir. POST /profile arms "
                             "later captures (0 = none armed at start)")
    parser.add_argument("--slo-mesh-imbalance-ratio", type=float, default=0.0, metavar="R",
                        help="mesh_imbalance watchdog rule: worst/median attributed device "
                             "step time above this ratio flips /healthz to 503 (needs the dp "
                             "fleet plane's device rollup; >= 1.0, 0 = rule off)")
    d = SloConfig()
    parser.add_argument("--slo", action="store_true",
                        help="the SLO v2 plane: sample registry families into the bounded "
                             "history store each round/batch, account per-SLO error budgets, "
                             "page/ticket on multi-window burn rates (/slo and /query)")
    parser.add_argument("--slo-objective", type=float, default=None, metavar="FRAC",
                        help=f"success-fraction objective of every default SLO "
                             f"(default {d.objective})")
    parser.add_argument("--slo-latency-ms", type=float, default=None, metavar="MS",
                        help="also a serving-latency SLO: requests over this end-to-end "
                             "threshold burn budget (default 0 = off)")
    parser.add_argument("--slo-budget-window", type=int, default=None, metavar="TICKS",
                        help=f"error-budget window in ticks (default {d.budget_window})")
    parser.add_argument("--slo-fast-window", type=int, default=None, metavar="TICKS",
                        help=f"fast (page) burn window in ticks (default {d.fast_window})")
    parser.add_argument("--slo-fast-burn", type=float, default=None, metavar="X",
                        help=f"fast burn-rate threshold (default {d.fast_burn}; 0 = off)")
    parser.add_argument("--slo-slow-window", type=int, default=None, metavar="TICKS",
                        help=f"slow (ticket) burn window in ticks (default {d.slow_window})")
    parser.add_argument("--slo-slow-burn", type=float, default=None, metavar="X",
                        help=f"slow burn-rate threshold (default {d.slow_burn}; 0 = off)")
    parser.add_argument("--slo-series-capacity", type=int, default=None, metavar="N",
                        help=f"history ring points per series (default {d.series_capacity})")
    parser.add_argument("--slo-max-series", type=int, default=None, metavar="N",
                        help=f"history series budget (default {d.max_series})")


def _slo_config(args) -> SloConfig:
    """The SloConfig of the --slo* flags (unset flags keep the defaults)."""
    overrides = {
        k: v for k, v in (
            ("objective", args.slo_objective),
            ("latency_threshold_ms", args.slo_latency_ms),
            ("budget_window", args.slo_budget_window),
            ("fast_window", args.slo_fast_window),
            ("fast_burn", args.slo_fast_burn),
            ("slow_window", args.slo_slow_window),
            ("slow_burn", args.slo_slow_burn),
            ("series_capacity", args.slo_series_capacity),
            ("max_series", args.slo_max_series),
        ) if v is not None
    }
    return SloConfig(enabled=bool(args.slo), **overrides)


def _serving_config(args) -> ServingConfig:
    """The ServingConfig of the --place* flags (unset flags keep the
    defaults)."""
    overrides = {
        k: v for k, v in (
            ("max_batch", args.place_max_batch),
            ("queue_depth", args.place_queue_depth),
            ("batch_window_ms", args.place_window_ms),
            ("deadline_ms", args.place_deadline_ms),
        ) if v is not None
    }
    return ServingConfig(enabled=bool(args.place), **overrides)


def _rank0() -> bool:
    """Whether this process is rank 0 of its process group (or alone): the
    one that prints, serves and writes files."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_initialized() else int(os.environ.get("RANK", "0"))
    return rank == 0


def _build_ops_plane(args, config: RescheduleConfig):
    """The live ops plane of a run (``--serve``), started; ``(None, None)``
    when off, and on every rank but rank 0. Returns ``(ops, logger)``: the
    logger feeds ``/events`` and the decision events."""
    if args.serve is None or not _rank0():
        return None, None
    from kubernetes_rescheduling_tpu_torch.telemetry.server import OpsPlane
    from kubernetes_rescheduling_tpu_torch.utils.logging import get_logger

    logger = get_logger()
    ops = OpsPlane.from_config(dataclasses.replace(config, serve_port=args.serve),
                               logger=logger, bundle_dir=args.bundle_dir).start()
    if ops.server is not None:
        sys.stderr.write(f"ops plane: http://127.0.0.1:{ops.server.port}/metrics "
                         "/healthz /events\n")
    return ops, logger


def write_telemetry_artifacts(args) -> dict | None:
    """Flush the process registry and tracer to the paths the run asked
    for (``--metrics-out``, ``--trace-out``) and write the run manifest
    beside them; returns the manifest (None when neither was asked)."""
    metrics_out = getattr(args, "metrics_out", None)
    trace_out = getattr(args, "trace_out", None)
    if not metrics_out and not trace_out:
        return None
    from kubernetes_rescheduling_tpu_torch.telemetry import (
        get_registry,
        get_tracer,
        write_manifest,
    )

    if metrics_out:
        registry = get_registry()
        registry.dump_jsonl(metrics_out)
        registry.write_exposition(Path(metrics_out).with_suffix(".prom"))
    if trace_out:
        get_tracer().export_chrome(trace_out)
    anchor = Path(metrics_out if metrics_out else trace_out)
    config = {k: v for k, v in vars(args).items() if k != "command" and not callable(v)}
    config["command"] = args.command
    return write_manifest(anchor.with_suffix(".manifest.json"), config)


def _add_forecast_flags(parser: argparse.ArgumentParser) -> None:
    """The forecast plane behind ``--algorithm proactive``; the defaults are
    ``ForecastConfig``'s, so a CLI run and a run built in code agree."""
    d = ForecastConfig()
    parser.add_argument("--forecast-lags", type=int, default=d.lags,
                        help="lag-feature window of the online per-node ridge forecaster "
                             "(proactive algorithm)")
    parser.add_argument("--forecast-decay", type=float, default=d.decay,
                        help="exponential weight of the rolling skill window per scored "
                             "round (~1/(1-decay) rounds dominate; 1.0 = cumulative)")
    parser.add_argument("--forecast-ridge", type=float, default=d.ridge,
                        help="L2 regularization of the per-node ridge fits (keeps cold "
                             "solves well-posed)")
    parser.add_argument("--forecast-min-history", type=int, default=d.min_history,
                        help="observations a node needs before its model prediction is "
                             "trusted; until then proactive rounds equal reactive CAR's")
    parser.add_argument("--forecast-min-skill", type=float, default=d.min_skill,
                        help="degrade gate: when forecast_skill (1 - mae_model/"
                             "mae_persistence) drops below this, proactive rounds fall back "
                             "to reactive CAR while the shadow model keeps scoring")


def _forecast_config(args) -> ForecastConfig:
    return ForecastConfig(lags=args.forecast_lags, ridge=args.forecast_ridge,
                          min_history=args.forecast_min_history,
                          min_skill=args.forecast_min_skill, decay=args.forecast_decay)


def _parse_tenant_list(raw: str) -> tuple[int, ...]:
    try:
        return tuple(int(x) for x in raw.split(",") if x.strip())
    except ValueError:
        raise SystemExit(
            f"--fleet-chaos-tenants must be comma-separated ints, got {raw!r}") from None


def _refuse_shadow_compositions(args) -> None:
    """The JAX command's clean exits for what ``--shadow`` and ``--backend
    k8s`` cannot compose with (``config.validate()`` refuses the same),
    before any trace parsing or cluster work."""
    if args.shadow:
        for flag, why in (
            (args.fleet, "--fleet (no per-tenant counterfactual twin)"),
            (args.backend == "k8s", "--backend k8s (the trace IS the cluster)"),
            (args.churn_profile != "none", "--churn-profile (the trace replays recorded churn)"),
            (args.chaos_profile != "none",
             "--chaos-profile (corrupting the replayed trace poisons the head-to-head scores)"),
            (args.imbalance, "--imbalance (recorded state cannot be mutated)"),
            (args.placement_unit == "pod",
             "--placement-unit pod (shadow scoring is service-granular)"),
            (args.no_admission, "--no-admission (replayed snapshots must ride the guard)"),
        ):
            if flag:
                raise SystemExit(f"--shadow is incompatible with {why}")
        if args.place:
            raise SystemExit("--place is incompatible with --shadow: the replay backend's "
                             "fresh-snapshot contract cannot feed a second consumer")
    if args.fleet:
        return
    if args.backend == "k8s" and args.churn_profile != "none":
        raise SystemExit("--churn-profile requires the sim backend: a live cluster churns itself")
    if args.backend == "k8s" and args.placement_unit == "pod":
        # K8sBackend refuses per-pod moves: fail before solving the pod graph
        raise SystemExit("--placement-unit pod requires the sim backend: the k8s Deployment "
                         "mechanism cannot pin a single replica")


def _make_backend(args):
    """The run's backend: a replayed trace (``--shadow``), a live cluster
    (``--backend k8s``) or the scenario's simulator."""
    if args.shadow:
        from kubernetes_rescheduling_tpu_torch.backends.replay import ReplayBackend
        from kubernetes_rescheduling_tpu_torch.traces.adapters import load_shadow_trace

        return ReplayBackend(load_shadow_trace(args.shadow, fmt=args.shadow_format),
                             device=args.device)
    if args.backend == "k8s":
        from kubernetes_rescheduling_tpu_torch.backends.k8s import K8sBackend
        from kubernetes_rescheduling_tpu_torch.core.workmodel import mubench_workmodel_c

        wm = Workmodel.from_file(args.workmodel) if args.workmodel else mubench_workmodel_c()
        return K8sBackend(workmodel=wm, namespace=args.namespace, device=args.device)
    backend = make_backend(args.scenario, args.seed, device=args.device,
                           workmodel_path=args.workmodel)
    if args.imbalance:
        backend.inject_imbalance(backend.node_names[0])
    return backend


def _shadow_summary(args, backend, result) -> dict:
    """The output's ``shadow`` block: recommendations, scored rounds, wins,
    the final running win rate and the mean cost delta."""
    blocks = [r.shadow for r in result.rounds if r.shadow]
    deltas = [b["cost_delta"] for b in blocks]
    return {
        "trace": args.shadow,
        "recommendations": len(backend.recommendations),
        "scored_rounds": len(blocks),
        "wins": sum(1 for b in blocks if b.get("win")),
        "win_rate": blocks[-1]["win_rate"] if blocks else None,
        "mean_cost_delta": sum(deltas) / len(deltas) if deltas else None,
    }


def cmd_reschedule(args) -> dict:
    algo = _norm_algo(args.algorithm)
    _refuse_shadow_compositions(args)
    if args.place and args.fleet:
        raise SystemExit("--place is a solo-loop plane: serving scores against ONE backend's "
                         "snapshot (per-tenant serving is future work)")
    if args.place and args.serve is None:
        raise SystemExit("--place requires --serve PORT: the ops plane's HTTP server is the "
                         "serving front (POST /place)")
    if args.place and algo not in POLICY_NAMES:
        raise SystemExit("--place requires a greedy algorithm (the serving plane scores "
                         f"requests with the greedy machinery): got {algo!r}")
    if args.fleet and args.backend != "sim":
        raise SystemExit("--fleet requires the sim backend (one live cluster is one tenant; "
                         "fleet mode multiplexes hermetic tenants)")
    if args.fleet and args.perf_ledger:
        raise SystemExit("--perf-ledger is not supported with --fleet yet (the solo path's "
                         "decisions/sec series has no fleet consumer)")
    # every solver-shaping flag reaches the config, so the fleet validation
    # refuses what fleet mode cannot batch instead of running something else
    cfg = RescheduleConfig(
        algorithm=algo,
        max_rounds=args.rounds,
        hazard_threshold_pct=args.threshold,
        # pacing: none on the simulator, the reference's 15 s otherwise
        sleep_after_action_s=0.0 if args.backend == "sim" else 15.0,
        moves_per_round=args.moves_per_round,
        balance_weight=args.balance_weight,
        move_cost=args.move_cost,
        solver_restarts=args.restarts,
        solver_tp=args.tp,
        solver_backend=args.solver_backend,
        global_moves_cap=args.global_moves_cap,
        placement_unit=args.placement_unit,
        enforce_capacity=args.capacity_frac is not None,
        capacity_frac=args.capacity_frac if args.capacity_frac is not None else 1.0,
        seed=args.seed,
        backend="replay" if args.shadow else args.backend,
        **_reconcile_config(args).flat(),
        max_consecutive_failures=args.max_consecutive_failures,
        perf=PerfConfig(ledger_path=args.perf_ledger),
        shadow=ShadowConfig(enabled=bool(args.shadow), win_margin=args.shadow_win_margin),
        chaos=args.chaos_profile,
        chaos_seed=args.chaos_seed,
        pipeline=args.pipeline,
        pipeline_depth=args.pipeline_depth,
        scan_block=args.scan_block,
        scan_tripwires=not args.no_scan_tripwires,
        tripwire_cost_frac=args.tripwire_cost_frac,
        tripwire_load_factor=args.tripwire_load_factor,
        tripwire_hazard_streak=args.tripwire_hazard_streak,
        elastic=args.churn_profile,
        elastic_seed=args.churn_seed,
        fleet=FleetConfig(tenants=args.fleet, plane=args.fleet_plane,
                          chaos_tenants=_parse_tenant_list(args.fleet_chaos_tenants)),
        **({} if args.tenant_label_budget is None
           else {"tenant_label_budget": args.tenant_label_budget}),
        forecast=_forecast_config(args),
        serving=_serving_config(args),
        slo=_slo_config(args),
        slo_serving_p99_ms=args.slo_serving_p99_ms,
        slo_mesh_imbalance_ratio=args.slo_mesh_imbalance_ratio,
        profile_rounds=args.profile_rounds,
    )
    try:
        cfg.validate()
    except ValueError as e:
        raise SystemExit(f"{'--fleet' if args.fleet else 'reschedule'}: {e}") from None
    if args.fleet:
        return _run_fleet(args, cfg)
    backend = _make_backend(args)
    ops, logger = _build_ops_plane(args, cfg)
    engine = None
    try:
        if args.place:
            from kubernetes_rescheduling_tpu_torch.serving import ServingEngine

            engine = ServingEngine(backend, config=cfg.serving, policy=algo,
                                   threshold=cfg.hazard_threshold_pct, seed=cfg.seed,
                                   top_k=cfg.explain_top_k, ops=ops, device=args.device).start()
            ops.bind_serving(engine)
            sys.stderr.write(f"serving: POST http://127.0.0.1:{ops.server.port}/place "
                             '{"service": <name>}\n')
        result = run_controller(backend, cfg, device=args.device, logger=logger, ops=ops)
        perf = _reschedule_perf(args, cfg, result, ops, algo)
    finally:
        if engine is not None:
            engine.stop()
        if ops is not None:
            ops.close()
    out = {
        "algorithm": algo,
        "rounds": [rec.as_dict() for rec in result.rounds],
        "moves": result.moves,
        "decisions_per_sec": result.decisions_per_sec,
        "skipped_rounds": result.skipped_rounds,
        "degraded_rounds": result.degraded_rounds,
        "boundary_failures": result.boundary_failures,
        "breaker_transitions": result.breaker_transitions,
    }
    if perf is not None:
        out["perf"] = perf
    if args.shadow:
        out["shadow"] = _shadow_summary(args, backend, result)
    return out


def _reschedule_perf(args, cfg: RescheduleConfig, result, ops, algo: str) -> dict | None:
    """``reschedule --perf-ledger``: append the run's decisions/sec, judge
    every series with the ``[perf]`` block's knobs, feed the verdicts to the
    ops plane's ``perf_regression`` rule, and return their statuses."""
    if not (cfg.perf.enabled and cfg.perf.ledger_path):
        return None
    from kubernetes_rescheduling_tpu_torch.telemetry import perf_ledger as pl

    ledger = pl.PerfLedger(cfg.perf.ledger_path)
    # seed excluded: repeated runs of one setup form one series
    digest_src = {k: v for k, v in dataclasses.asdict(cfg).items() if k not in ("seed", "perf")}
    ledger.append(
        metric="decisions_per_sec", value=result.decisions_per_sec, unit="1/s",
        scenario=f"{getattr(args, 'scenario', 'k8s')}/{algo}",
        device_kind=pl.device_kind(args.device), config=digest_src, better="higher",
        seed=cfg.seed,
    )
    verdicts = pl.detect(ledger.entries(), window=cfg.perf.window,
                         threshold_frac=cfg.perf.regression_frac, baseline=cfg.perf.baseline,
                         min_history=cfg.perf.min_history)
    if ops is not None:
        ops.observe_perf(verdicts)
    return {k: v["status"] for k, v in sorted(verdicts.items())}


def cmd_bench(args) -> dict:
    """The experiment matrix (``bench/harness.py``) on ``--device``."""
    from kubernetes_rescheduling_tpu_torch.bench.harness import ExperimentConfig, run_experiment

    if args.backend == "k8s" and args.placement_unit == "pod":
        raise SystemExit("--placement-unit pod requires the sim backend: the k8s Deployment "
                         "mechanism cannot pin a single replica")
    cfg = ExperimentConfig(
        algorithms=tuple(_norm_algo(a) for a in args.algorithms.split(",") if a),
        repeats=args.repeats,
        rounds=args.rounds,
        scenario=args.scenario,
        backend=args.backend,
        namespace=args.namespace,
        workmodel=args.workmodel,
        out_dir=args.out,
        session_name=args.session,
        moves_per_round=args.moves_per_round,
        global_moves_cap=args.global_moves_cap,
        move_cost=args.move_cost,
        solver_backend=args.solver_backend,
        placement_unit=args.placement_unit,
        solver_restarts=args.restarts,
        solver_tp=args.tp,
        observe_weights=args.observe_weights,
        enforce_capacity=args.capacity_frac is not None,
        capacity_frac=args.capacity_frac if args.capacity_frac is not None else 1.0,
        seed=args.seed,
        chaos_profile=args.chaos_profile,
        chaos_seed=args.chaos_seed,
        max_consecutive_failures=args.max_consecutive_failures,
        churn_profile=args.churn_profile,
        churn_seed=args.churn_seed,
        forecast=_forecast_config(args),
        pipeline=args.pipeline,
        pipeline_depth=args.pipeline_depth,
        scan_block=args.scan_block,
        reconcile=_reconcile_config(args),
        serve_port=args.serve,
        bundle_dir=args.bundle_dir,
    )
    return run_experiment(cfg, device=args.device)


TELEMETRY_MODES = ("report", "explain", "bundle", "perf", "topo", "dataset", "shadow",
                   "fleet", "slo")


def cmd_telemetry(args) -> str:
    """Render a run's artifacts; the leading path may name the mode."""
    from kubernetes_rescheduling_tpu_torch.telemetry import report as rep

    mode, paths = "report", list(args.paths)
    if paths and paths[0] in TELEMETRY_MODES:
        mode, paths = paths[0], paths[1:]
    if not paths:
        raise SystemExit(f"telemetry {mode}: no artifact paths given")
    if mode == "dataset":
        from kubernetes_rescheduling_tpu_torch.forecast.dataset import report_dataset

        return report_dataset(paths, lags=args.dataset_lags, ridge=args.dataset_ridge)
    if mode == "perf":
        return rep.report_perf(paths, window=args.perf_window,
                               threshold_frac=args.perf_threshold, baseline=args.perf_baseline)
    return {"report": rep.report, "explain": rep.report_explain, "bundle": rep.report_bundle,
            "topo": rep.report_topo, "shadow": rep.report_shadow, "fleet": rep.report_fleet,
            "slo": rep.report_slo}[mode](paths)


def _run_fleet(args, cfg: RescheduleConfig) -> dict:
    """``reschedule --fleet N``: N tenants of the scenario under the
    multiplexed loop; prints the JAX package's keys (per-tenant round
    streams and the amortized fleet-decision cost)."""
    from kubernetes_rescheduling_tpu_torch.backends.fleet import make_fleet
    from kubernetes_rescheduling_tpu_torch.bench.fleet import run_fleet_controller

    fleet = make_fleet(args.scenario, args.fleet, seed=args.seed,
                       workmodel_path=args.workmodel, device=args.device)
    if args.imbalance:
        fleet.inject_imbalance()
    ops, logger = _build_ops_plane(args, cfg)
    try:
        result = run_fleet_controller(fleet, cfg, device=args.device, logger=logger, ops=ops)
    finally:
        if ops is not None:
            ops.close()
    return {
        "algorithm": cfg.algorithm,
        "fleet": {"tenants": args.fleet, "plane": args.fleet_plane},
        "batched_solves": result.batched_solves,
        "amortized_solve_ms_per_tenant_round": round(
            result.amortized_solve_ms_per_tenant_round, 4),
        "per_tenant": {
            name: {
                "rounds": len(r.rounds),
                "skipped_rounds": r.skipped_rounds,
                "degraded_rounds": r.degraded_rounds,
                "moves": r.moves,
                "boundary_failures": r.boundary_failures,
                "final_communication_cost": (r.rounds[-1].communication_cost
                                             if r.rounds else None),
                "final_load_std": r.rounds[-1].load_std if r.rounds else None,
            }
            for name, r in result.results.items()
        },
    }


def cmd_trace(args) -> dict:
    wm = (
        Workmodel.from_file(args.workmodel)
        if args.workmodel
        else bookinfo_workmodel(replicas=args.replicas)
    )
    steps = load_trace(args.trace) if args.trace else canary_trace(steps=args.steps)
    state = state_from_workmodel(
        wm,
        node_names=[f"worker{i}" for i in range(args.nodes)],
        node_cpu_cap_m=20_000.0,
        seed=args.seed,
        device=args.device,
    )
    _, records = replay(
        state,
        wm.comm_graph(device=args.device),
        steps,
        generator=torch.Generator().manual_seed(args.seed),
        config=GlobalSolverConfig(
            sweeps=args.sweeps,
            balance_weight=args.balance_weight,
            enforce_capacity=args.capacity_frac is not None,
            capacity_frac=args.capacity_frac if args.capacity_frac is not None else 1.0,
        ),
        restarts=args.restarts,
    )
    return {
        "workmodel": wm.source,
        "trace": args.trace or f"builtin:canary[{args.steps}]",
        "balance_weight": args.balance_weight,
        "restarts": args.restarts,
        "steps": [dataclasses.asdict(r) for r in records],
        "total_moves": sum(r.moves for r in records),
        "final_cost": records[-1].cost_after_solve if records else None,
    }


def cmd_solve(args) -> dict:
    """One global solve of the scenario through ``parallel.solve_with_restarts``
    (``--restarts``, ``--tp``), as the JAX command runs it; the autotuner
    tunes that same path."""
    backend = make_backend(args.scenario, args.seed, device=args.device,
                           workmodel_path=args.workmodel)
    state = backend.monitor()
    graph = backend.comm_graph()
    cfg = GlobalSolverConfig(
        sweeps=args.sweeps,
        balance_weight=args.balance_weight,
        capacity_frac=args.capacity_frac,
        move_cost=args.move_cost,
    )
    # the solver and the graph it takes as an argument, as the JAX package
    # tunes and runs them: the full restart × tp matrix on every unit
    if args.placement_unit == "pod":
        solve_graph = pod_level_graph(state, graph)

        def solver(st, g, generator, c):
            return global_assign_pods(st, None, generator, c, pod_graph=g,
                                      n_restarts=args.restarts, tp=args.tp)
    else:
        solve_graph = from_comm_graph(graph) if args.sparse else graph

        def solver(st, g, generator, c):
            return solve_with_restarts(st, None if args.sparse else g, generator,
                                       n_restarts=args.restarts, config=c, tp=args.tp,
                                       sparse_graph=g if args.sparse else None)
    tune_info = None
    if args.latency_budget is not None:
        cfg, tune_info = tune_sweeps(state, solve_graph, cfg, args.latency_budget, solver=solver)
    new_state, info = solver(state, solve_graph, torch.Generator().manual_seed(args.seed), cfg)
    out = {
        "scenario": args.scenario,
        "restarts": int(info["restarts"]),
        "tp": int(info["tp"]) if "tp" in info else 1,
        "communication_cost_before": float(communication_cost(state, graph)),
        "communication_cost_after": float(communication_cost(new_state, graph)),
        "load_std_before": float(load_std(state)),
        "load_std_after": float(load_std(new_state)),
    }
    if "moves_per_sweep" in info:
        out["moves_per_sweep"] = [int(m) for m in info["moves_per_sweep"]]
    if "restart_objectives" in info:
        out["restart_objectives"] = [float(o) for o in info["restart_objectives"]]
    if args.move_cost > 0 and "move_penalty" in info:
        out["move_cost"] = args.move_cost
        out["move_penalty"] = float(info["move_penalty"])
    if args.sparse:
        out["sparse"] = True
    if args.placement_unit != "service":
        out["placement_unit"] = args.placement_unit
    if tune_info is not None:
        out["autotune"] = tune_info
        out["sweeps"] = tune_info["sweeps"]
    return out


def _join_process_group(args) -> bool:
    """Under ``torchrun`` (``WORLD_SIZE`` above 1) join the process group
    the launcher describes, on this rank's device: NCCL for the card
    (``cuda:LOCAL_RANK``), gloo for ``--device cpu``. Returns whether it
    joined one."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized() \
            or not hasattr(args, "device"):
        return False
    dev = rank_device(args.device)
    args.device = str(dev)
    dist.init_process_group(collective_backend(dev))
    return True


def run_command(argv: list[str] | None = None) -> dict | str:
    """Parse ``argv``, run the command and write its telemetry artifacts;
    returns the command's JSON object, or the ``telemetry`` report's text
    (what :func:`main` prints)."""
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    joined = _join_process_group(args)
    try:
        out = {"reschedule": cmd_reschedule, "bench": cmd_bench, "solve": cmd_solve,
               "trace": cmd_trace, "telemetry": cmd_telemetry}[args.command](args)
        if _rank0():
            write_telemetry_artifacts(args)
    finally:
        if joined:
            dist.destroy_process_group()
    return out


def main(argv: list[str] | None = None) -> int:
    out = run_command(argv)
    if int(os.environ.get("RANK", "0")) != 0:
        return 0  # every rank computed the same result; rank 0 prints it
    if isinstance(out, str):  # the telemetry report is human text already
        print(out)
        return 0
    json.dump(out, sys.stdout, indent=2, default=float)
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
