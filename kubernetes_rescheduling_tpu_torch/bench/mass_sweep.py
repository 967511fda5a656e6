"""Device time of the dense and hub mass kernels at other prefetch depths
than the one they are built with, and on weights that isolate where the
time goes, on the card.

    python -m kubernetes_rescheduling_tpu_torch.bench.mass_sweep

Kernel 1 (``fused_neighbor_mass``) on the ``large`` scenario's bf16 pair
weights (C = 1024, N = 1000, SP = 10240) and kernel 5
(``hub_neighbor_mass``) on the ``sparse50k`` graph's hub groups (N =
2000). Each depth of DEPTHS other than the sources' ``kLongRowDepth``
(``csrc/sparse_row.cuh``) is built from a copy of the sources with that
constant replaced, under ``ops/build/`` (the shipped build is left as it
is), and served to the wrappers in place of their library. At every
depth each kernel is checked equal to its plain version on the sweep's
first chunk or group, and timed with CUDA events around a captured CUDA
graph of 100 calls that cycle through a sweep's chunks or hub groups
(whose weights overflow the L2). Then, at the built depth, where the time
goes: the same calls on weights of the same shape that are all zero (the
stream of W and the zero rows of M alone), and on the weights with every
row of more than 32 nonzeros cleared (no long product list), beside the
most nonzeros any row has. Prints one JSON object; the depth the sources
build is marked ``"default"``. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
from contextlib import contextmanager

import torch

from kubernetes_rescheduling_tpu_torch.bench import harness
from kubernetes_rescheduling_tpu_torch.bench.score_sweep import ITERS
from kubernetes_rescheduling_tpu_torch.ops import _build
from kubernetes_rescheduling_tpu_torch.ops import fused_admission as fa
from kubernetes_rescheduling_tpu_torch.ops import sparse_mass as sm
from kubernetes_rescheduling_tpu_torch.solver import global_solver as gs
from kubernetes_rescheduling_tpu_torch.solver import sparse_solver as ss

DEPTHS = (2, 4, 8)
THIN = 32  # rows with more nonzeros than this are cleared in the "thin" weights
_DEPTH = re.compile(r"constexpr int kLongRowDepth = (\d+);")
SOURCES = ("mass", "sparse_mass")


def built_depth() -> int:
    """The prefetch depth the sources build the long-row kernels with."""
    return int(_DEPTH.search((_build.CSRC / "sparse_row.cuh").read_text()).group(1))


def depth_libraries(depths) -> dict:
    """``{depth: {source: library}}``: SOURCES built from a copy of the
    sources with ``kLongRowDepth`` replaced, every build started at once."""
    procs = {}
    for depth in depths:
        src = _build.BUILD_DIR / f"sweep_depth{depth}"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(_build.CSRC, src)
        head = src / "sparse_row.cuh"
        text, n = _DEPTH.subn(f"constexpr int kLongRowDepth = {depth};", head.read_text())
        if n != 1:
            raise RuntimeError("sparse_row.cuh has no single kLongRowDepth to replace")
        head.write_text(text)
        for name in SOURCES:
            out = src / f"lib{name}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(src / f"{name}.cu")]
            procs[depth, name] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs: dict = {}
    for (depth, name), (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}.cu at depth {depth} failed to build:\n{log}")
        libs.setdefault(depth, {})[name] = _build.load(out)
    return libs


@contextmanager
def serving(libs: dict):
    """The wrappers launch from ``libs`` (``{source: library}``) inside."""
    own = {name: _build.library(name) for name in libs}
    _build._LIBS.update(libs)
    try:
        yield
    finally:
        _build._LIBS.update(own)


def weight_variants(w_mm, spans) -> dict:
    """The real weights, all zeros, and the weights with each row of a
    column span (``(lo, hi)``: the columns one output row sums over) cleared
    where it holds more than THIN nonzeros; with the most nonzeros a row of
    a span holds and how many rows were cleared."""
    thin = w_mm.clone()
    most = over = 0
    for lo, hi in spans:
        nnz = (w_mm[:, lo:hi] != 0).sum(dim=1)
        most, over = max(most, int(nnz.max())), over + int((nnz > THIN).sum())
        thin[:, lo:hi] = torch.where((nnz > THIN)[:, None], 0, w_mm[:, lo:hi])
    return {"max_row_nnz": most, "rows_over_thin": over,
            "weights": {"real": w_mm, "zero": torch.zeros_like(w_mm), "thin": thin}}


def graph_ms(fn) -> float:
    """Mean device ms of ``fn(i)`` over ITERS calls captured in one graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(ITERS):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def dense_operands():
    """The ``large`` round's mass operands: its bf16 weights, a seeded
    placement and one sweep's chunks of 4 row blocks."""
    backend = harness.make_backend("large", 0, device="cuda")
    state, graph = backend.monitor(), backend.comm_graph()
    cfg = gs.GlobalSolverConfig()
    w_mm = gs.prepare_weights(state, graph, cfg)
    SP, N = w_mm.shape[0], state.num_nodes
    gen = torch.Generator().manual_seed(0)
    assign = torch.randint(0, N, (SP,), generator=gen, dtype=torch.int32).cuda()
    valid = gs._pad_to(graph.service_valid, SP, False)
    plan = gs.draw_plans(gen, 1, SP, 1024, SP // 1024, gs.COMPOSITION_BLOCK)[0]
    return w_mm, assign, valid, plan.block_rows.cuda(), N


def hub_operands():
    """The ``sparse50k`` round's hub groups at the round-start placement, as
    ``global_assign_sparse`` builds them."""
    state, sgraph = harness.sparse_problem(50_000, 2_000, seed=0, device="cuda")
    cfg = gs.GlobalSolverConfig()
    lay = ss.sparse_layout(sgraph, cfg)
    N = state.num_nodes
    svc_valid, _, _, cur_s, rv_s, _ = ss.sorted_problem_arrays(state, sgraph, lay.spx)
    assign = torch.where(svc_valid, torch.clamp(cur_s, 0, N - 1), 0).to(torch.int32)
    hubs = []
    for blocks_g in lay.hub_groups:
        u_g = ss.hub_slab_ids(sgraph, blocks_g)
        rvu_g = ss.hub_rvu(sgraph, u_g, rv_s, lay.spx)
        tgt = assign[torch.clamp(u_g.long(), 0, lay.spx - 1)]
        hubs.append((tgt, rvu_g, sm.hub_tile_arrays(sgraph, blocks_g, "cuda"), len(blocks_g)))
    spans = [(sgraph.block_toff[b] * sgraph.bu,
              (sgraph.block_toff[b] + sgraph.block_ntiles[b]) * sgraph.bu)
             for b in sgraph.hub_blocks]
    return sgraph.w_local.to(torch.bfloat16), hubs, sgraph.bu, N, spans


def sweep_dense(libs: dict) -> dict:
    w_mm, assign, valid, block_rows, N = dense_operands()
    kw = dict(num_nodes=N, block_b=gs.COMPOSITION_BLOCK, block_j=1024)
    want = fa.neighbor_mass_plain(w_mm, assign, valid, block_rows[0], num_nodes=N,
                                  block_b=gs.COMPOSITION_BLOCK)
    out = []
    for depth in DEPTHS:
        with serving(libs.get(depth, {})):
            got = fa.fused_neighbor_mass(w_mm, assign, valid, block_rows[0], **kw)
            torch.cuda.synchronize()
            out.append({
                "depth": depth, "equal": torch.equal(got, want),
                "default": depth == built_depth(),
                "ms": graph_ms(lambda i: fa.fused_neighbor_mass(
                    w_mm, assign, valid, block_rows[i % block_rows.shape[0]], **kw)),
            })
    var = weight_variants(w_mm, [(0, w_mm.shape[1])])
    times = {name: graph_ms(lambda i, w=w: fa.fused_neighbor_mass(
        w, assign, valid, block_rows[i % block_rows.shape[0]], **kw))
        for name, w in var.pop("weights").items()}
    return {"kernel": "fused_neighbor_mass", "C": 1024, "N": N, "depths": out,
            "ms_by_weights": times, **var}


def sweep_hub(libs: dict) -> dict:
    w_mm, hubs, bu, N, spans = hub_operands()

    def call(i, w=w_mm):
        tgt, rvu, tiles, n_out = hubs[i % len(hubs)]
        return sm.hub_neighbor_mass(w, tgt, rvu, *tiles, num_nodes=N, num_hub_blocks=n_out,
                                    bu=bu)

    tgt, rvu, tiles, n_out = hubs[0]
    want = sm.hub_mass_plain(w_mm, tgt, rvu, *tiles, num_nodes=N, num_hub_blocks=n_out, bu=bu)
    out = []
    for depth in DEPTHS:
        with serving(libs.get(depth, {})):
            got = call(0)
            torch.cuda.synchronize()
            out.append({
                "depth": depth, "equal": torch.equal(got, want),
                "default": depth == built_depth(), "ms": graph_ms(call),
            })
    var = weight_variants(w_mm, spans)
    times = {name: graph_ms(lambda i, w=w: call(i, w)) for name, w in var.pop("weights").items()}
    return {"kernel": "hub_neighbor_mass", "groups": len(hubs), "N": N, "depths": out,
            "ms_by_weights": times, **var}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mass_sweep needs a CUDA device")
    libs = depth_libraries([d for d in DEPTHS if d != built_depth()])
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "sweeps": [sweep_dense(libs), sweep_hub(libs)]}))


if __name__ == "__main__":
    main()
