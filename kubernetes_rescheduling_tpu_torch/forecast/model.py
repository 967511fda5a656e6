"""The online forecaster: lag-feature ridge regression per node — the port
of ``kubernetes_rescheduling_tpu.forecast.model``.

For a node's CPU load fraction ``y`` the one-step prediction is persistence
plus a learned trend over the last L differences::

    ŷ_{t+1} = y_t + w · [Δy_{t-L+1}, …, Δy_t, 1],   Δy_t = y_t − y_{t-1}

with ``w`` the ridge solution ``(XᵀX + λI)⁻¹ XᵀΔy``. Ridge shrinkage pulls
``w`` toward zero, and a zero trend IS the persistence baseline, so a series
with nothing to learn degrades toward skill 0 instead of extrapolating.
Online, the state keeps the normal-equation statistics ``A``/``b`` per node
(recursive least squares with forgetting ``fit_decay``) and re-solves the
(L+1)² system every round.

The per-node solve is an explicit Gaussian elimination with partial
pivoting, unrolled over F = L+1 in Python into elementwise ops over the node
axis (:func:`solve_ridge_systems`), and the outer products and the
prediction's product are elementwise ops and sums over F in a fixed order.
So the step does the same arithmetic on the card and on the CPU, reads
nothing back to the host (it runs inside a captured CUDA graph), and calls
no solver library. Only the node-axis sums behind the skill scalars are
reductions whose order differs between devices. The JAX package solves with
``jnp.linalg.solve`` (LAPACK on its CPU): the two differ in the last bits of
W, so its state is matched at a tolerance, not bit for bit.

Mask-awareness (the elastic contract): every accumulation is weighted by
``state.node_valid``, a slot whose validity flips on restarts its series
from zero, and an invalid slot predicts persistence with a zero applied
delta, so a padded, masked problem reproduces its unpadded twin.

Skill and the gate: ``forecast_skill = 1 − MAE(model)/MAE(persistence)``
over a decayed window of scored rounds. The applied delta is gated on
``skill ≥ min_skill`` on the device; a gated-off model keeps scoring its
shadow predictions so it can earn the gate back. Until a node has
``min_history`` observations its prediction IS persistence: the delta is
exactly 0.0, and a proactive round equals a reactive one bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from kubernetes_rescheduling_tpu_torch._device import DEFAULT_DEVICE, resolve_device
from kubernetes_rescheduling_tpu_torch.core.state import ClusterState

# diagnostic vector layout (read once per round, riding the round-end read)
DIAG_SKILL = 0          # 1 - mae_model/mae_persistence (0 until scored)
DIAG_MAE_MODEL = 1      # decayed mean |model pred - observed|, in load fraction
DIAG_MAE_PERSIST = 2    # decayed mean |persistence pred - observed|
DIAG_ROUNDS = 3         # decayed weight of the scored rounds
DIAG_FRAC_MODEL = 4     # fraction of valid nodes on the model path
DIAG_TRAINED = 5        # 1.0 once any node has min_history observations
DIAG_SIZE = 6

# ForecastState's fields, in order (the capture bodies' input names)
FORECAST_FIELDS = ("history", "count", "A", "b", "prev_model_pred", "prev_model_valid",
                   "prev_valid", "err_model_sum", "err_persist_sum", "err_rounds", "steps")


@dataclass(frozen=True)
class ForecastState:
    """Online per-node forecaster state (every array carries the node axis
    last but A and b, which carry it first).

    ``history`` is a rolling window, row 0 oldest; ``A``/``b`` the ridge
    normal-equation statistics per node; ``prev_model_pred`` last round's
    shadow model prediction (kept while the skill gate zeroes the applied
    delta, so a losing model keeps being scored). The scalars accumulate
    the decayed per-round mean absolute errors behind the skill."""

    history: torch.Tensor           # f32[L+1, N]
    count: torch.Tensor             # f32[N] observations since the slot was (re)validated
    A: torch.Tensor                 # f32[N, F, F], F = L+1
    b: torch.Tensor                 # f32[N, F]
    prev_model_pred: torch.Tensor   # f32[N]
    prev_model_valid: torch.Tensor  # bool[N]
    prev_valid: torch.Tensor        # bool[N]
    err_model_sum: torch.Tensor     # f32[]
    err_persist_sum: torch.Tensor   # f32[]
    err_rounds: torch.Tensor        # f32[]
    steps: torch.Tensor             # i32[]

    @property
    def lags(self) -> int:
        return int(self.history.shape[-2]) - 1

    @property
    def num_nodes(self) -> int:
        return int(self.history.shape[-1])

    def replace(self, **changes) -> "ForecastState":
        return dataclasses.replace(self, **changes)

    def tensors(self, prefix: str = "") -> dict[str, torch.Tensor]:
        """The fields as a dict of tensors, names prefixed (a body's inputs)."""
        return {prefix + k: getattr(self, k) for k in FORECAST_FIELDS}

    @classmethod
    def from_tensors(cls, t: dict, prefix: str = "") -> "ForecastState":
        return cls(**{k: t[prefix + k] for k in FORECAST_FIELDS})


def init_forecast_state(lags: int, num_nodes: int,
                        device: str | torch.device | None = DEFAULT_DEVICE) -> ForecastState:
    """A fresh, all-cold forecaster over ``num_nodes`` series on ``device``."""
    if lags < 1:
        raise ValueError(f"lags must be >= 1, got {lags}")
    dev = resolve_device(device)
    f = lags + 1

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return ForecastState(
        history=z((lags + 1, num_nodes)),
        count=z((num_nodes,)),
        A=z((num_nodes, f, f)),
        b=z((num_nodes, f)),
        prev_model_pred=z((num_nodes,)),
        prev_model_valid=z((num_nodes,), torch.bool),
        prev_valid=z((num_nodes,), torch.bool),
        err_model_sum=z(()),
        err_persist_sum=z(()),
        err_rounds=z(()),
        steps=z((), torch.int32),
    )


def _pad_axis(x: torch.Tensor, axis: int, pad: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim=axis)


# the node axis of each per-node field, counted from the end (stacked fleet
# states carry a leading tenant axis, which this leaves alone)
_NODE_AXIS = {"history": -1, "count": -1, "A": -3, "b": -2, "prev_model_pred": -1,
              "prev_model_valid": -1, "prev_valid": -1}


def repad_forecast_state(fstate: ForecastState, num_nodes: int) -> ForecastState:
    """Grow the node axis to a promoted bucket capacity. New slots arrive
    cold (zero statistics, invalid) — what the step's slot hygiene resets a
    freshly validated node to. Shrinking raises: buckets never demote. A
    stacked fleet state (leading tenant axis) grows the same way."""
    n_old = fstate.num_nodes
    if num_nodes < n_old:
        raise ValueError(
            f"forecast state cannot shrink ({n_old} -> {num_nodes}); shape buckets never demote"
        )
    if num_nodes == n_old:
        return fstate
    pad = num_nodes - n_old
    return fstate.replace(**{k: _pad_axis(getattr(fstate, k), axis, pad)
                             for k, axis in _NODE_AXIS.items()})


def solve_ridge_systems(A: torch.Tensor, b: torch.Tensor, ridge) -> torch.Tensor:
    """``W[n] = (A[n] + ridge·I)⁻¹ b[n]`` for every n: f32[N, F, F], f32[N, F]
    → f32[N, F], by Gaussian elimination with partial pivoting (the first
    row of largest magnitude, as LAPACK's getrf picks it), unrolled over F
    into elementwise ops over N. A singular system gives non-finite entries
    (the step falls back to persistence there)."""
    F = int(b.shape[-1])
    M = [[A[..., i, j] + ridge if i == j else A[..., i, j] for j in range(F)]
         for i in range(F)]
    rhs = [b[..., i] for i in range(F)]
    for k in range(F):
        best = M[k][k].abs()
        piv = torch.full_like(best, k, dtype=torch.int32)
        for r in range(k + 1, F):
            a = M[r][k].abs()
            take = a > best
            best = torch.where(take, a, best)
            piv = torch.where(take, r, piv)
        for r in range(k + 1, F):
            swap = piv == r
            for j in range(k, F):
                M[k][j], M[r][j] = (torch.where(swap, M[r][j], M[k][j]),
                                    torch.where(swap, M[k][j], M[r][j]))
            rhs[k], rhs[r] = torch.where(swap, rhs[r], rhs[k]), torch.where(swap, rhs[k], rhs[r])
        for r in range(k + 1, F):
            factor = M[r][k] / M[k][k]
            for j in range(k + 1, F):
                M[r][j] = M[r][j] - factor * M[k][j]
            rhs[r] = rhs[r] - factor * rhs[k]
    x = [None] * F
    for i in reversed(range(F)):
        acc = rhs[i]
        for j in range(i + 1, F):
            acc = acc - M[i][j] * x[j]
        x[i] = acc / M[i][i]
    return torch.stack(x, dim=-1)


def fit_ridge(X, y, mask, ridge: float) -> torch.Tensor:
    """Batched masked ridge fit, the offline form of what the online step
    accumulates: ``X`` f32[B, T, F] windows, ``y`` f32[B, T] targets,
    ``mask`` [B, T] sample weights. Returns ``W`` f32[B, F]; the ridge term
    keeps an all-masked series well-posed (W = 0 there)."""
    X = torch.as_tensor(X, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=X.device)
    w = torch.as_tensor(mask, dtype=torch.float32, device=X.device)
    A = torch.einsum("btf,btg,bt->bfg", X, X, w)
    b = torch.einsum("btf,bt,bt->bf", X, y, w)
    return solve_ridge_systems(A, b, float(ridge))


def ridge_predict(W: torch.Tensor, X) -> torch.Tensor:
    """Per-series weights over window arrays: f32[B, F] × f32[B, T, F] →
    f32[B, T] (or f32[B, F] × f32[B, F] → f32[B])."""
    X = torch.as_tensor(X, dtype=torch.float32, device=W.device)
    if X.dim() == W.dim():
        return torch.einsum("bf,bf->b", X, W)
    return torch.einsum("btf,bf->bt", X, W)


def node_loads(state: ClusterState) -> torch.Tensor:
    """The series the forecaster trains on: each node's CPU load as a
    fraction of its capacity, 0 on invalid nodes. Fractions keep the
    normal equations O(1), where raw millicores would square into ~4e8 and
    drown the ridge term."""
    cap = torch.where(state.node_cpu_cap > 0, state.node_cpu_cap, 1.0)
    return torch.where(state.node_valid, state.node_cpu_used() / cap, 0.0)


def _features(hist: torch.Tensor) -> torch.Tensor:
    """f32[F, N]: the window's L differences, then the bias row."""
    return torch.cat([hist[1:] - hist[:-1], torch.ones_like(hist[:1])])


def forecast_step(
    state: ClusterState,
    fstate: ForecastState,
    ridge: torch.Tensor,
    min_skill: torch.Tensor,
    min_history: torch.Tensor,
    decay: torch.Tensor,
    fit_decay: torch.Tensor,
) -> tuple[ForecastState, torch.Tensor, torch.Tensor]:
    """One online round: score last round's predictions, fold the new
    observation into the ridge statistics, and predict the next window.

    The scalars are f32 device tensors (0-d), so one captured step serves
    every configuration. Returns ``(fstate', delta, diag)``: ``delta``
    f32[N] is the load adjustment in millicores the proactive decision adds
    to ``node_base_cpu`` — exactly 0.0 wherever the model is cold, gated
    off or the slot invalid; ``diag`` is f32[DIAG_SIZE] (``DIAG_*``)."""
    loads = node_loads(state)
    valid = state.node_valid
    lags = fstate.history.shape[0] - 1

    # slot hygiene: a slot whose validity flips on is a NEW series — its
    # history, count and statistics restart from zero
    fresh = valid & ~fstate.prev_valid & (fstate.steps > 0)
    keep = (~fresh).float()
    history = fstate.history * keep[None, :]
    count = fstate.count * keep
    A = fstate.A * keep[:, None, None]
    b = fstate.b * keep[:, None]

    # score last round's shadow model prediction and the persistence
    # prediction on the same nodes (trained, and kept their identity)
    prev_obs = history[-1]
    acct_mask = valid & fstate.prev_model_valid & ~fresh
    n_acct = acct_mask.float().sum()
    # where(), not multiply-by-mask: a non-finite shadow prediction on a
    # masked slot would turn inf·0 into NaN
    em = torch.where(acct_mask, (fstate.prev_model_pred - loads).abs(), 0.0).sum()
    ep = torch.where(acct_mask, (prev_obs - loads).abs(), 0.0).sum()
    has = n_acct > 0
    denom = torch.clamp_min(n_acct, 1.0)
    # exponentially decayed error window per scored round
    err_model_sum = torch.where(has, decay * fstate.err_model_sum + em / denom,
                                fstate.err_model_sum)
    err_persist_sum = torch.where(has, decay * fstate.err_persist_sum + ep / denom,
                                  fstate.err_persist_sum)
    err_rounds = torch.where(has, decay * fstate.err_rounds + 1.0, fstate.err_rounds)

    # ridge accumulation: a node with a full difference window contributes
    # one sample — features are the window's differences before today's
    # observation (+ bias), the target today's delta; contributing nodes
    # forget their statistics by fit_decay
    x_feat = _features(history)
    target_delta = loads - history[-1]
    upd = (valid & (count >= lags + 1)).float()
    rho = 1.0 - upd * (1.0 - fit_decay)
    xt = x_feat.T
    outer = xt[:, :, None] * xt[:, None, :]
    A = rho[:, None, None] * A + upd[:, None, None] * outer
    b = rho[:, None] * b + upd[:, None] * (x_feat * target_delta[None, :]).T

    # push today's observation into the window
    history = torch.cat([history[1:], torch.where(valid, loads, 0.0)[None, :]])
    count = count + valid.float()

    # solve every node's system and predict the next window from the
    # post-push features; a negative load prediction clips to zero
    W = solve_ridge_systems(A, b, ridge)
    x_next = _features(history)
    trend = W[:, 0] * x_next[0]
    for f in range(1, W.shape[1]):
        trend = trend + W[:, f] * x_next[f]
    model_pred = torch.clamp_min(loads + trend, 0.0)
    # the never-NaN contract: a pathological slot falls back to persistence
    model_pred = torch.where(torch.isfinite(model_pred), model_pred, loads)

    node_trained = valid & (count >= min_history)
    scored = err_rounds > 0
    persist_ok = err_persist_sum > 1e-9
    skill = torch.where(
        persist_ok,
        1.0 - err_model_sum / torch.where(persist_ok, err_persist_sum, 1.0),
        # no persistence error at all: the model is at worst even
        torch.where(err_model_sum > 1e-9, -1.0, 0.0),
    )
    skill = torch.where(scored, skill, 0.0)
    use_model = node_trained & (skill >= min_skill)
    pred = torch.where(use_model, model_pred, loads)
    # back to millicores; persistence gives (loads - loads) * cap = 0.0
    cap = torch.where(state.node_cpu_cap > 0, state.node_cpu_cap, 1.0)
    delta = torch.where(valid, (pred - loads) * cap, 0.0)

    n_valid = torch.clamp_min(valid.float().sum(), 1.0)
    rounds1 = torch.clamp_min(err_rounds, 1.0)
    diag = torch.stack([
        skill,
        err_model_sum / rounds1,
        err_persist_sum / rounds1,
        err_rounds,
        use_model.float().sum() / n_valid,
        node_trained.any().float(),
    ])
    new = ForecastState(
        history=history,
        count=count,
        A=A,
        b=b,
        prev_model_pred=model_pred,
        prev_model_valid=node_trained,
        prev_valid=valid.clone(),
        err_model_sum=err_model_sum,
        err_persist_sum=err_persist_sum,
        err_rounds=err_rounds,
        steps=fstate.steps + 1,
    )
    return new, delta, diag


def forecast_params(config, device) -> torch.Tensor:
    """f32[5] ``(ridge, min_skill, min_history, decay, fit_decay)`` of a
    :class:`~config.ForecastConfig` on ``device``: the step's scalars live in
    device memory, so one captured step serves every configuration."""
    return torch.tensor([config.ridge, config.min_skill, float(config.min_history),
                         config.decay, config.fit_decay], dtype=torch.float32, device=device)


def step_with_params(state: ClusterState, fstate: ForecastState, params: torch.Tensor):
    """:func:`forecast_step` with its scalars read from ``params``
    (:func:`forecast_params`)."""
    return forecast_step(state, fstate, params[0], params[1], params[2], params[3], params[4])
