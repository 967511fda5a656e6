"""Device time of the score kernels at other launch geometries than
``score_geometry``'s, on the card.

    python -m kubernetes_rescheduling_tpu_torch.bench.score_sweep

For C = 1024 rows and N = 1000 and 2000 nodes (the ``large`` chunk and
the ``sparse50k`` chunk), seeded integer inputs with noise on: kernel 2
(``score_stage``) and kernel 6 (``sparse_mass_score``, on W strips of
about 3 nonzeros a row) at every (threads, rows per tile) of the list
below, each checked equal to its plain version and timed with CUDA events
around a captured CUDA graph of 100 calls. Prints one JSON object; the
geometry the wrappers take is marked ``"default"``. Needs a CUDA device.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from kubernetes_rescheduling_tpu_torch.ops import fused_admission as fa
from kubernetes_rescheduling_tpu_torch.ops import sparse_mass as sm

GEOMETRIES = ((64, 1), (128, 1), (256, 1), (128, 2), (256, 2))
ITERS = 100


def graph_ms(fn) -> float:
    """Mean device ms of ``fn()`` over ITERS calls captured in one graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def operands(C: int, N: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    U = 1024
    KB = C // 256

    def t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device="cuda")

    cur = rng.integers(0, N, size=C)
    return {
        "M": t(rng.integers(0, 6, size=(C, N)), torch.float32),
        "rows": (t(cur, torch.int32), t(cur, torch.int32), t(np.zeros(C), torch.float32),
                 t(rng.integers(1, 5, size=C) * 100, torch.float32),
                 t(rng.integers(0, 3, size=C) * 2**20, torch.float32), t(rng.random(C) < 0.9)),
        "nodes": (t(rng.integers(0, 40, size=N) * 100, torch.float32),
                  t(rng.integers(0, 100, size=N) * 2**20, torch.float32),
                  t(np.full(N, 4000.0), torch.float32), t(np.full(N, 2.0**30), torch.float32),
                  t(rng.random(N) < 0.95)),
        "strips": (t(np.where(rng.random((256, KB * U)) < 3 / U, 1, 0), torch.bfloat16),
                   t(rng.integers(0, N, size=KB * U), torch.int32),
                   t(rng.integers(1, 3, size=KB * U), torch.float32),
                   torch.arange(KB, dtype=torch.int32, device="cuda"),
                   torch.arange(KB, dtype=torch.int32, device="cuda") * 2,
                   t(rng.integers(1, 3, size=C), torch.float32)),
    }


def sweep(C: int, N: int) -> dict:
    op = operands(C, N)
    rows, nodes, strips = op["rows"], op["nodes"], op["strips"]
    kw = dict(enforce_capacity=True, use_noise=True)
    skw = dict(use_move_pen=False, block_c=256, **kw)
    mkw = dict(num_nodes=N, bu=512, reg_tiles=2, **kw)
    want2 = fa.score_stage_plain(op["M"], *rows, *nodes, 0.5, 1.0, 7, 10.0, **skw)
    want6 = sm.sparse_mass_score_plain(*strips, *rows, *nodes, 0.5, 1.0, 7, 10.0,
                                       use_move_pen=False, **mkw)
    default = fa.score_geometry(C, N)[:2]
    own = fa.score_geometry
    out = []
    try:
        for threads, r in GEOMETRIES:
            geometry = lambda c, n, threads=threads, r=r: (threads, r, -(-c // r))  # noqa: E731
            fa.score_geometry = sm.score_geometry = geometry
            got2 = fa.score_stage(op["M"], *rows, *nodes, 0.5, 1.0, 7, 10.0, **skw)
            got6 = sm.sparse_mass_score(*strips, *rows[:2], None, *rows[3:], *nodes, 0.5, 1.0,
                                        7, 10.0, **mkw)
            torch.cuda.synchronize()
            equal = all(torch.equal(g, w) for g, w in zip((*got2, *got6), (*want2, *want6)))
            out.append({
                "threads": threads, "rows": r, "default": (threads, r) == default,
                "equal": equal,
                "score_ms": graph_ms(lambda: fa.score_stage(op["M"], *rows, *nodes, 0.5, 1.0, 7,
                                                            10.0, **skw)),
                "mass_score_ms": graph_ms(lambda: sm.sparse_mass_score(
                    *strips, *rows[:2], None, *rows[3:], *nodes, 0.5, 1.0, 7, 10.0, **mkw)),
            })
    finally:
        fa.score_geometry = sm.score_geometry = own
    return {"C": C, "N": N, "geometries": out}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("score_sweep needs a CUDA device")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "sweeps": [sweep(1024, 1000), sweep(1024, 2000)]}))


if __name__ == "__main__":
    main()
