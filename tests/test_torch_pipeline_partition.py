"""The port's LM pipeline-stage partitioner against the reference's, on
every arch of the reference's registry at 2, 4 and 8 stages.  The port's
stages are H100s (``STAGE_PEAK_FLOPS``, the dense bf16 peak) where the
reference's divide by another rate, so which block lands in which stage
must be equal (``stage_of``, ``boundaries``), the stage times equal the
reference's scaled by the ratio of the two rates, and the imbalance, a
ratio of times, equal the reference's."""

import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import all_archs as jall_archs  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import pipeline_partition as jpp  # noqa: E402
from repro_torch.configs import all_archs, get_config  # noqa: E402
from repro_torch.core import pipeline_partition as pp  # noqa: E402

RTOL = 1e-12
ARCHS = jall_archs()


def port_config(arch):
    """The port's config of ``arch``, from its registry."""
    return get_config(arch)


def ref_stage_rate():
    """The reference stage model's rate [FLOP/s], read off its cost model."""
    g = jpp.transformer_block_graph(jget_config("gemma3-1b"), 16)
    node = g.nodes[g.topo_order()[0]]
    return node.flops / jpp._flops_cost_model().time(node)


def rel(a, b):
    return 0.0 if a == b == 0.0 else abs(a / b - 1.0)


def test_registry_covers_the_reference():
    assert len(ARCHS) == 10 and all_archs() == ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))


def test_stage_rate_is_the_h100_bf16_peak():
    assert pp.STAGE_PEAK_FLOPS == 989e12


@pytest.mark.parametrize("arch", ARCHS)
def test_block_graph_equals_reference(arch):
    g = pp.transformer_block_graph(port_config(arch), 4096)
    rg = jpp.transformer_block_graph(jget_config(arch), 4096)
    assert g.to_json() == rg.to_json()


@pytest.mark.parametrize("n_stages", [2, 4, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_equals_reference(arch, n_stages):
    plan = pp.partition(port_config(arch), n_stages)
    ref = jpp.partition(jget_config(arch), n_stages)
    assert plan.stage_of == ref.stage_of
    assert plan.boundaries == ref.boundaries
    scale = ref_stage_rate() / pp.STAGE_PEAK_FLOPS
    assert len(plan.loads) == len(ref.loads) == n_stages
    for got, want in zip(plan.loads, ref.loads):
        assert rel(got, want * scale) <= RTOL
    assert rel(plan.lblp_bottleneck, ref.lblp_bottleneck * scale) <= RTOL
    assert rel(plan.imbalance, ref.imbalance) <= RTOL
    # contiguous stages in layer order
    order = sorted(plan.stage_of)
    assert [plan.stage_of[n] for n in order] == sorted(plan.stage_of.values())


def test_partition_at_another_sequence_length():
    cfg = get_config("gemma3-1b")
    plan = pp.partition(cfg, 4, seq_len=1024)
    ref = jpp.partition(jget_config("gemma3-1b"), 4, seq_len=1024)
    assert (plan.stage_of, plan.boundaries) == (ref.stage_of, ref.boundaries)
