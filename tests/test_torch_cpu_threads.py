"""One torch intra-op thread in each process that runs the port's tests.

The tier-1 command runs six pytest workers on one machine. Left at its
default, torch gives each of them one intra-op thread per core, so the
workers' threads outnumber the cores several times over and the port's
small CPU ops wait on one another: on an 8-core machine, the port's loop
tests took 4-25 times as long beside five other workers as alone. Every
worker imports this module while it collects the tests, before any test
runs, so the setting holds for the whole run. The placements and objectives the tests compare do not depend
on it: the same tests pass with torch's default thread count.
"""

import torch

torch.set_num_threads(1)


def test_one_intra_op_thread_per_process():
    assert torch.get_num_threads() == 1
