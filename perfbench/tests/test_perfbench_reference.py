"""The plain references decide as the port does, at a size the CPU holds."""

import pytest

from perfbench.tests import small


@pytest.mark.parametrize("workload", ["dense12k.drift", "sparse60k.drift"])
def test_solve_reference_solves_every_sampled_round_as_the_port(workload):
    d = small.driver(workload, seed=5)
    d.hooks.seconds = 0.5
    d.run()
    checks = d.check()
    assert checks["placement_mismatch_share"]["value"] == 0.0
    assert checks["solve_objective_rel_gap"]["value"] == 0.0
    assert checks["objective_after_rel_gap"]["value"] < 1e-6

