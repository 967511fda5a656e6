"""The kernel counts give the kernel table's bounds at its shapes (PERF.md:
kernels 1–3 at C = 1024, N = 1000, SP = 10,240 in bf16; the score at
N = 4,000)."""

import pytest

from perfbench.counts import admission, mass, score


@pytest.mark.parametrize("got, want", [
    (lambda: mass.bound_ms(1024, 10240, 1000, 2), 0.0075),
    (lambda: score.bound_ms(1024, 1000, True), 0.0030),
    (lambda: score.bound_ms(1024, 4000, True), 0.0119),
    (lambda: admission.bound_ms(1024, 1000), 0.000014),
])
def test_bound_matches_the_kernel_table(got, want):
    assert got() == pytest.approx(want, rel=0.02)


def test_score_without_noise_is_cheaper():
    assert score.bound_ms(1024, 1000, False) < score.bound_ms(1024, 1000, True) / 2
