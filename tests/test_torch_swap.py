"""The port's swap phase against the JAX package's, exactly, on instances
with many tied exchange desires and a candidate subset smaller than the
chunk (k < C), so that the top-k order — descending, ties to the lower
index — is pinned."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_rescheduling_tpu.solver import swap as jswap
from kubernetes_rescheduling_tpu_torch.solver import swap as tswap


def swap_instance(seed, C=48, N=6):
    """Small-integer masses and pair weights (frequent exact ties), integer
    CPU sizes and loads (every sum exact in f32), a finite memory budget."""
    rng = np.random.default_rng(seed)
    M = rng.integers(0, 4, size=(C, N)).astype(np.float32)
    Wc = np.triu(rng.integers(0, 3, size=(C, C)), 1).astype(np.float32)
    Wc = Wc + Wc.T
    cur = rng.integers(0, N, size=C).astype(np.int32)
    eligible = rng.random(C) < 0.85
    c_cpu = (rng.integers(1, 4, size=C) * 100.0).astype(np.float32)
    c_mem = (rng.integers(0, 3, size=C) * 10.0).astype(np.float32)
    cap = np.full((N,), 1600.0, np.float32)
    cpu_load = (rng.integers(8, 17, size=N) * 100.0).astype(np.float32)
    mem_cap = np.full((N,), 400.0, np.float32)
    mem_load = (rng.integers(0, 30, size=N) * 10.0).astype(np.float32)
    pen = rng.integers(0, 3, size=C).astype(np.float32)
    home = rng.integers(0, N, size=C).astype(np.int32)
    return M, Wc, cur, eligible, c_cpu, c_mem, cpu_load, mem_load, cap, mem_cap, pen, home


def _both(arrays):
    return [jnp.asarray(a) for a in arrays], [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("k", [8, 16, 48])
@pytest.mark.parametrize("priced", [False, True])
def test_chunk_swap_matches_jax(seed, k, priced):
    (M, Wc, cur, elig, c_cpu, c_mem, cl, ml, cap, mcap, pen, home) = swap_instance(seed)
    (jM, jW, jcur, jel, jcc, jcm, jcl, jml, jcap, jmc), (tM, tW, tcur, tel, tcc, tcm, tcl,
                                                        tml, tcap, tmc) = _both(
        [M, Wc, cur, elig, c_cpu, c_mem, cl, ml, cap, mcap])
    jp, jh = (jnp.asarray(pen), jnp.asarray(home)) if priced else (None, None)
    tp, th = (torch.as_tensor(pen), torch.as_tensor(home)) if priced else (None, None)
    j_new, j_sw, j_n = jswap.chunk_swap(
        jM, jW, jcur, jel, jcc, jcm, jcl, jml, jcap, jmc, 0.5, 10.0, jp, jh, k,
        enforce_capacity=True,
    )
    t_new, t_sw, t_n = tswap.chunk_swap(
        tM, tW, tcur, tel, tcc, tcm, tcl, tml, tcap, tmc, 0.5, 10.0, tp, th, k,
        enforce_capacity=True,
    )
    np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))
    np.testing.assert_array_equal(t_sw.numpy(), np.asarray(j_sw))
    assert int(t_n) == int(j_n)


def test_instances_exercise_swaps_and_ties():
    """The instances above are not vacuous: swaps get admitted and the
    desire ranking has ties straddling the top-k boundary."""
    total = 0
    tied_at_boundary = 0
    for seed in range(6):
        (M, Wc, cur, elig, c_cpu, c_mem, cl, ml, cap, mcap, _, _) = swap_instance(seed)
        t = [torch.as_tensor(a) for a in (M, Wc, cur, elig, c_cpu, c_mem, cl, ml, cap, mcap)]
        _, _, n = tswap.chunk_swap(*t, 0.5, 10.0, None, None, 8, enforce_capacity=True)
        total += int(n)
        m_cur = M[np.arange(len(cur)), cur]
        desire = np.where(elig, M.max(axis=1) - m_cur, -np.inf)
        top = np.sort(desire)[::-1]
        tied_at_boundary += int(top[7] == top[8])
    assert total > 0
    assert tied_at_boundary > 0


@pytest.mark.parametrize("seed", range(4))
def test_swap_decisions_matches_jax(seed):
    """The replicated core on the full chunk, with and without capacity."""
    (M, Wc, cur, elig, c_cpu, c_mem, cl, ml, cap, mcap, pen, home) = swap_instance(seed, C=24)
    m_own = M[np.arange(len(cur)), cur]
    M_cur = M[:, cur]
    arrays = [M_cur, m_own, Wc, cur, elig, c_cpu, c_mem, cl[cur], ml[cur], cap[cur], mcap[cur]]
    j_args, t_args = _both(arrays)
    for enforce in (True, False):
        j_new, j_sw, j_n = jswap.swap_decisions(
            *j_args, 0.5, 10.0, pen=jnp.asarray(pen), home=jnp.asarray(home),
            enforce_capacity=enforce,
        )
        t_new, t_sw, t_n = tswap.swap_decisions(
            *t_args, 0.5, 10.0, pen=torch.as_tensor(pen), home=torch.as_tensor(home),
            enforce_capacity=enforce,
        )
        np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))
        np.testing.assert_array_equal(t_sw.numpy(), np.asarray(j_sw))
        assert int(t_n) == int(j_n)


def test_cols_at_matches_jax():
    rng = np.random.default_rng(3)
    M = rng.integers(-3, 9, size=(10, 7)).astype(np.float32)
    cur = rng.integers(0, 7, size=10).astype(np.int32)
    want = jswap.cols_at(jnp.asarray(M), jnp.asarray(cur))
    got = tswap.cols_at(torch.as_tensor(M), torch.as_tensor(cur))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_swap_subset_top_k_order_matches_jax():
    """Ties in desire go to the lower index, and ineligible rows last."""
    desire = np.array([3, 5, 5, 1, 5, 3, 0, 5], np.float32)
    eligible = np.array([1, 1, 0, 1, 1, 1, 1, 1], bool)
    M = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    Wc = np.arange(64, dtype=np.float32).reshape(8, 8)
    for k in (3, 5, 8):
        j_sel, j_Mk, j_Wk, _ = jswap.swap_subset(
            jnp.asarray(desire), jnp.asarray(eligible), jnp.asarray(M), jnp.asarray(Wc), k
        )
        t_sel, t_Mk, t_Wk, _ = tswap.swap_subset(
            torch.as_tensor(desire), torch.as_tensor(eligible), torch.as_tensor(M),
            torch.as_tensor(Wc), k,
        )
        np.testing.assert_array_equal(t_sel.numpy(), np.asarray(j_sel))
        np.testing.assert_array_equal(t_Mk.numpy(), np.asarray(j_Mk))
        np.testing.assert_array_equal(t_Wk.numpy(), np.asarray(j_Wk))


@pytest.mark.parametrize("sweeps,every", [(9, 3), (4, 1), (5, 0), (2, 5)])
def test_swap_flags_match_jax(sweeps, every):
    np.testing.assert_array_equal(
        tswap.swap_flags(sweeps, every), jswap.swap_flags(sweeps, every)
    )


def test_scan_sweeps_runs_segments_in_order():
    """Same-flag segments, each with its own body, outputs in sweep order."""
    flags = tswap.swap_flags(7, 3)
    made = []

    def make_body(flag):
        made.append(flag)
        return lambda carry, xs: (carry + [(xs, flag)], xs)

    carry, outs = tswap.scan_sweeps(make_body, [], list("abcdefg"), list(range(7)), flags)
    assert outs == [(p, t) for p, t in zip("abcdefg", range(7))]
    assert [f for _, f in carry] == list(flags)
    assert sorted(made) == [False, True]  # one body per flag value
