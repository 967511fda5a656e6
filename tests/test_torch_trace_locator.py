"""The streaming half of the port's sparse graph against the JAX package's:
``trace_locator``, ``reorder_for_trace`` and ``with_edge_weights`` give the
same arrays, exactly (host numpy in both packages for the locator; a
scatter of the same values for the weight update), on the ``hub`` and
``plain`` instances of tests/test_torch_sparse_solver.py, and a JAX
locator carried across as arrays equals the port's own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sparse_graph import ARRAYS, assert_same_graph, random_edges
from test_torch_sparse_solver import hub_instance, plain_instance

from kubernetes_rescheduling_tpu.core import sparsegraph as jsg
from kubernetes_rescheduling_tpu_torch import convert
from kubernetes_rescheduling_tpu_torch.core import sparsegraph as tsg

LOCATOR = ("coo", "w_rows", "w_cols", "base_w")


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, make in (("hub", hub_instance), ("plain", plain_instance)):
        _, j_graph, _, t_graph = make()
        out[name] = (j_graph, t_graph)
    return out


def assert_same_locator(t, j):
    for name in LOCATOR:
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert t.canonical == j.canonical
    assert t.num_edges == j.num_edges


@pytest.mark.parametrize("name", ["hub", "plain"])
def test_trace_locator_matches_jax(graphs, name):
    j_graph, t_graph = graphs[name]
    loc = tsg.trace_locator(t_graph)
    assert_same_locator(loc, jsg.trace_locator(j_graph))
    assert loc.num_edges * 2 == t_graph.edges_src.numel()
    # every slot points at its edge's weight in the strips and the COO list
    w2 = torch.cat([loc.base_w, loc.base_w])
    assert torch.equal(t_graph.w_local[loc.w_rows.long(), loc.w_cols.long()], w2)
    assert torch.equal(t_graph.edges_w[loc.coo.long()], w2)


@pytest.mark.parametrize("name", ["hub", "plain"])
def test_reorder_for_trace_matches_jax(graphs, name):
    j_graph, t_graph = graphs[name]
    j2, j_loc = jsg.reorder_for_trace(j_graph)
    t2, t_loc = tsg.reorder_for_trace(t_graph)
    assert_same_graph(t2, j2)
    assert_same_locator(t_loc, j_loc)
    assert t_loc.canonical
    # the reordered COO list is the same edge multiset
    before = sorted(zip(t_graph.edges_src.tolist(), t_graph.edges_dst.tolist()))
    after = sorted(zip(t2.edges_src.tolist(), t2.edges_dst.tolist()))
    assert before == after


@pytest.mark.parametrize("name", ["hub", "plain"])
@pytest.mark.parametrize("canonical", [False, True])
def test_with_edge_weights_matches_jax(graphs, name, canonical):
    """Seeded non-integer weights through the locator: the strips and the
    COO weights equal the JAX package's, and the structure is untouched."""
    j_graph, t_graph = graphs[name]
    if canonical:
        j_graph, j_loc = jsg.reorder_for_trace(j_graph)
        t_graph, t_loc = tsg.reorder_for_trace(t_graph)
    else:
        j_loc, t_loc = jsg.trace_locator(j_graph), tsg.trace_locator(t_graph)
    w = np.random.default_rng(7).uniform(0.1, 3.0, size=t_loc.num_edges).astype(np.float32)
    j_new = jsg.with_edge_weights(j_graph, j_loc, jnp.asarray(w))
    t_new = tsg.with_edge_weights(t_graph, t_loc, torch.as_tensor(w))
    assert_same_graph(t_new, j_new)
    for arr in set(ARRAYS) - {"w_local", "edges_w"}:
        assert getattr(t_new, arr) is getattr(t_graph, arr), arr
    # the graph it came from keeps its weights
    assert torch.equal(t_graph.edges_w, torch.as_tensor(np.array(j_graph.edges_w)))


def test_locator_carried_across_from_jax(graphs):
    j_graph, t_graph = graphs["hub"]
    _, j_loc = jsg.reorder_for_trace(j_graph)
    carried = convert.trace_locator_from_arrays(
        {**{k: np.asarray(getattr(j_loc, k)) for k in LOCATOR}, "canonical": j_loc.canonical},
        device="cpu",
    )
    assert_same_locator(carried, j_loc)
    assert_same_locator(carried, tsg.reorder_for_trace(t_graph)[1])
    assert carried.coo.dtype == torch.int32 and carried.base_w.dtype == torch.float32


def test_with_edge_weights_refuses_single_block_graphs():
    src, dst, w = random_edges(200, 4.0, seed=4)
    t = tsg.from_edges(src, dst, w, 200, device="cpu")
    assert t.num_blocks == 1 and t.dense_adj is not None
    loc = tsg.trace_locator(t)
    with pytest.raises(ValueError, match="single-block"):
        tsg.with_edge_weights(t, loc, loc.base_w)
