"""The port's IMCE cost model against the reference's: every node time,
per-frame time and transfer time of the deployment graphs, on every PU
of ``make_pus(8, 4)``, under both hardware profiles, equal with ``==``."""

import dataclasses

import pytest

pytest.importorskip("torch")

from helpers import build_random_graph
from repro.core import cost as jcost
from repro.core.graph import PUType as JPUType
from repro.models.cnn import graphs as jgraphs
from repro_torch.core import cost
from repro_torch.core.graph import Graph, PUType
from repro_torch.models.cnn import graphs

PROFILES = ["IMCE_DEFAULT", "IMCE_FAST_LINK"]


def graph_pairs():
    """(label, port graph, reference graph): the ResNets from each
    package's builder, YOLOv8n, a replicated ResNet-18 and two random
    graphs carried across as JSON."""
    out = [("resnet8", graphs.resnet8_graph(), jgraphs.resnet8_graph()),
           ("resnet18", graphs.resnet18_graph(), jgraphs.resnet18_graph())]
    refs = [("yolov8n", jgraphs.yolov8n_graph()),
            ("resnet18-replicated",
             jgraphs.resnet18_graph().with_replicas({2: 3, 7: 2})),
            ("rand-0", build_random_graph(20, 0.3, 0)),
            ("rand-1", build_random_graph(20, 0.3, 1, imc_fraction=0.3))]
    out += [(label, Graph.from_json(r.to_json()), r) for label, r in refs]
    return out


PAIRS = graph_pairs()


def test_profiles_and_fleet_equal_reference():
    for name in PROFILES:
        assert (dataclasses.asdict(getattr(cost, name))
                == dataclasses.asdict(getattr(jcost, name)))
    for n_imc, n_dpu in [(8, 4), (2, 1), (0, 3)]:
        mine = cost.make_pus(n_imc, n_dpu)
        ref = jcost.make_pus(n_imc, n_dpu)
        assert ([(p.pu_id, p.pu_type.value, p.speed, p.weight_capacity)
                 for p in mine]
                == [(p.pu_id, p.pu_type.value, p.speed, p.weight_capacity)
                    for p in ref])
        assert ([p.capacity(cost.IMCE_DEFAULT) for p in mine]
                == [p.capacity(jcost.IMCE_DEFAULT) for p in ref])


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("label,g,rg", PAIRS, ids=[p[0] for p in PAIRS])
def test_node_and_transfer_times_equal_reference(label, g, rg, profile):
    cm = cost.CostModel(getattr(cost, profile))
    rcm = jcost.CostModel(getattr(jcost, profile))
    pus, rpus = cost.make_pus(8, 4), jcost.make_pus(8, 4)
    speeds = (1.0, 0.5, 1.7)
    for nid in g.nodes:
        n, rn = g.nodes[nid], rg.nodes[nid]
        assert cm.time(n) == rcm.time(rn), nid
        for pu, rpu in zip(pus, rpus):
            for speed in speeds:
                assert (cm.time(n, pu.pu_type, speed)
                        == rcm.time(rn, rpu.pu_type, speed)), (nid, pu, speed)
                assert (cm.frame_time(n, pu.pu_type, speed)
                        == rcm.frame_time(rn, rpu.pu_type, speed))
        for same in (True, False):
            assert cm.transfer(n, same) == rcm.transfer(rn, same)
    assert cm.graph_times(g) == rcm.graph_times(rg)
    assert cm.longest_path(g) == rcm.longest_path(rg)
    assert cm.table(g) == rcm.table(rg)
    # a second model over the same nodes takes its own profile, not the
    # first model's per-node side table
    other = "IMCE_FAST_LINK" if profile == "IMCE_DEFAULT" else "IMCE_DEFAULT"
    cm2, rcm2 = cost.CostModel(getattr(cost, other)), jcost.CostModel(
        getattr(jcost, other))
    assert ([cm2.time(n, PUType.DPU) for n in g.nodes.values()]
            == [rcm2.time(n, JPUType.DPU) for n in rg.nodes.values()])
