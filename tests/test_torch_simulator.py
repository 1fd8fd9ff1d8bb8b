"""The port's IMCE simulator against the reference's, in one process:
every ``SimResult`` field (tenants included) equal with ``==`` under the
``exact``, ``periodic`` and ``reference`` engines, on the paper's graphs
and schedules, replicated graphs, bounded in-flight windows, multi-tenant
closed- and open-loop runs, and again after each graph mutation (the
simulation contexts are cached on the graph object)."""

import pytest

pytest.importorskip("torch")

from helpers import build_random_graph
from repro import core as jcore
from repro.core import metrics as jmetrics
from repro.models.cnn import graphs as jgraphs
from repro_torch import core
from repro_torch.core import metrics
from repro_torch.core.graph import Graph, MultiTenantGraph
from repro_torch.models.cnn import graphs
from test_torch_schedulers import plain, schedule_both

ENGINES = ["exact", "periodic", "reference"]
PAPER_ALGS = ["lblp", "wb", "rr", "rd"]


def sim_both(g, rg, a, ra, engine, frames, max_in_flight=0, **kw):
    """Simulate ``a`` on ``g`` with the port and ``ra`` on ``rg`` with the
    reference; assert the results equal and return the port's."""
    cm, rcm = core.CostModel(), jcore.CostModel()
    sim = core.make_simulator(g, cm, engine=engine, max_in_flight=max_in_flight)
    rsim = jcore.make_simulator(rg, rcm, engine=engine,
                                max_in_flight=max_in_flight)
    res, rres = sim.run(a, frames=frames, **kw), rsim.run(ra, frames=frames, **kw)
    assert plain(res) == plain(rres)
    assert sim.last_early_exit == rsim.last_early_exit
    assert sim.last_events == rsim.last_events
    return res


def run_graph(a, g):
    """The graph a mapping refers to (lblp-r maps its replicated graph)."""
    return a.meta.get("replicated_graph", g)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fleet", [(2, 1), (4, 2), (7, 3), (10, 4)], ids=str)
def test_resnet8_fig2_equals_reference(fleet, engine):
    for alg in PAPER_ALGS + ["lblp-r"]:
        g, rg = graphs.resnet8_graph(), jgraphs.resnet8_graph()
        a, ra = schedule_both(alg, g, rg, fleet)
        sim_both(run_graph(a, g), run_graph(ra, rg), a, ra, engine, 64)


@pytest.mark.parametrize("engine", ENGINES)
def test_resnet18_table1_equals_reference(engine):
    out = {}
    for alg in core.available():
        if alg == "optimal":
            continue
        g, rg = graphs.resnet18_graph(), jgraphs.resnet18_graph()
        a, ra = schedule_both(alg, g, rg, (8, 4))
        out[alg] = sim_both(run_graph(a, g), run_graph(ra, rg), a, ra, engine,
                            128)
    # the paper's claim holds on the port as it does on the reference
    paper = {k: out[k] for k in PAPER_ALGS}
    assert out["lblp"].rate >= max(r.rate for r in paper.values()) * 0.999
    assert out["lblp"].latency <= min(r.latency for r in paper.values()) * 1.001


@pytest.mark.parametrize("alg", ["lblp", "lblp-r", "wb"])
def test_yolov8n_periodic_equals_reference(alg):
    rg = jgraphs.yolov8n_graph()
    g = Graph.from_json(rg.to_json())
    a, ra = schedule_both(alg, g, rg, (8, 4))
    sim_both(run_graph(a, g), run_graph(ra, rg), a, ra, "periodic", 32)


@pytest.mark.parametrize("engine", ["exact", "periodic"])
@pytest.mark.parametrize("alg", PAPER_ALGS + ["lblp-r"])
def test_port_built_yolov8n_equals_reference(alg, engine):
    """The YOLOv8n graph from the port's own builder on the paper's §V.C
    fleet, 48 frames: the setting of ``chip_smoke.py``'s placement phase
    and of the paper's claim (LBLP's rate at least WB's)."""
    g, rg = graphs.yolov8n_graph(), jgraphs.yolov8n_graph()
    a, ra = schedule_both(alg, g, rg, (16, 8))
    sim_both(run_graph(a, g), run_graph(ra, rg), a, ra, engine, 48)


@pytest.mark.parametrize("engine", ["exact", "periodic"])
def test_port_built_yolov8n_lblp_beats_wb(engine):
    g, cm = graphs.yolov8n_graph(), core.CostModel()
    rate = {alg: core.make_simulator(g, cm, engine=engine).run(
        core.get_scheduler(alg, cm).schedule(g, core.make_pus(16, 8)),
        frames=48).rate for alg in ("lblp", "wb")}
    assert rate["lblp"] >= rate["wb"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("seed", range(4))
def test_random_graphs_equal_reference(seed, engine):
    rg = build_random_graph(14, 0.3, seed)
    g = Graph.from_json(rg.to_json())
    prof = dict(pu_weight_capacity=1e12)
    cm = core.CostModel(core.HardwareProfile(**prof))
    rcm = jcore.CostModel(jcore.HardwareProfile(**prof))
    a = core.get_scheduler("lblp", cm).schedule(g, core.make_pus(3, 2))
    ra = jcore.get_scheduler("lblp", rcm).schedule(rg, jcore.make_pus(3, 2))
    res = core.make_simulator(g, cm, engine=engine).run(a, frames=48)
    rres = jcore.make_simulator(rg, rcm, engine=engine).run(ra, frames=48)
    assert plain(res) == plain(rres)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("max_in_flight", [1, 3, 9])
def test_max_in_flight_equals_reference(max_in_flight, engine):
    g, rg = graphs.resnet18_graph(), jgraphs.resnet18_graph()
    a, ra = schedule_both("lblp", g, rg, (4, 2))
    sim_both(g, rg, a, ra, engine, 64, max_in_flight=max_in_flight)


@pytest.mark.parametrize("engine", ENGINES)
def test_replicated_graphs_equal_reference(engine):
    g = graphs.resnet18_graph().with_replicas({2: 2, 5: 3})
    rg = jgraphs.resnet18_graph().with_replicas({2: 2, 5: 3})
    for alg in ("lblp", "rr", "heft"):
        a, ra = schedule_both(alg, g, rg, (8, 4))
        sim_both(g, rg, a, ra, engine, 96)
    g_r, a = core.schedule_replicated(graphs.resnet8_graph(), core.make_pus(12, 6))
    rg_r, ra = jcore.schedule_replicated(jgraphs.resnet8_graph(),
                                         jcore.make_pus(12, 6))
    sim_both(g_r, rg_r, a, ra, engine, 64)


def _union_pair(weights=None):
    mt = MultiTenantGraph.union([graphs.resnet8_graph(), graphs.resnet18_graph()])
    rmt = jcore.MultiTenantGraph.union([jgraphs.resnet8_graph(),
                                        jgraphs.resnet18_graph()])
    for t, w in (weights or {}).items():
        mt.set_tenant_weight(t, w)
        rmt.set_tenant_weight(t, w)
    return mt, rmt


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("rates", [None, {"resnet8": 30.0,
                                          "resnet18_cifar": 1000.0},
                                   {"resnet8": 4000.0,
                                    "resnet18_cifar": 2500.0}],
                         ids=["closed", "readme-open", "overload-open"])
def test_multi_tenant_equals_reference(rates, engine):
    for weights in (None, {"resnet18_cifar": 3.0}):
        mt, rmt = _union_pair(weights)
        for alg in ("lblp-mt", "lblp-r"):
            a, ra = schedule_both(alg, mt, rmt, (8, 4))
            res = sim_both(run_graph(a, mt), run_graph(ra, rmt), a, ra, engine,
                           48, rates=rates)
            assert set(res.tenants) == {"resnet8", "resnet18_cifar"}


def test_metrics_equal_reference():
    group, rgroup = {}, {}
    for alg in PAPER_ALGS:
        g, rg = graphs.resnet18_graph(), jgraphs.resnet18_graph()
        a, ra = schedule_both(alg, g, rg, (8, 4))
        group[alg] = core.IMCESimulator(g, core.CostModel()).run(a, frames=64)
        rgroup[alg] = jcore.IMCESimulator(rg, jcore.CostModel()).run(ra, frames=64)
        assert (metrics.utilization_table(group[alg])
                == jmetrics.utilization_table(rgroup[alg]))
    assert plain(metrics.normalize(group)) == plain(jmetrics.normalize(rgroup))
    assert metrics.normalize({}) == {}
    assert metrics.normalize(group)["lblp"].norm_rate == 1.0


def test_raw_loop_and_latency_only_equal_reference():
    g, rg = graphs.resnet18_graph(), jgraphs.resnet18_graph()
    a, ra = schedule_both("lblp", g, rg, (4, 2))
    sim, rsim = core.IMCESimulator(g), jcore.IMCESimulator(rg)
    assert (plain(sim._simulate(a, frames=24, in_flight=6))
            == plain(rsim._simulate(ra, frames=24, in_flight=6)))
    assert sim.latency_only(a) == rsim.latency_only(ra)
    assert plain(sim.run(a, frames=64)) == plain(rsim.run(ra, frames=64))


@pytest.mark.parametrize("engine", ENGINES)
def test_resimulation_after_mutation_equals_reference(engine):
    """Each step simulates, mutates, reschedules and simulates again on
    the same graph object on both sides, and checks the port also against
    a fresh graph of the same structure (no cached context to go stale)."""
    cm = core.CostModel()

    def step(g, rg, alg="lblp", fleet=(8, 4), **kw):
        a, ra = schedule_both(alg, g, rg, fleet)
        res = sim_both(run_graph(a, g), run_graph(ra, rg), a, ra, engine, 48,
                       **kw)
        fresh = type(g).from_json(run_graph(a, g).to_json())
        assert plain(core.make_simulator(fresh, cm, engine=engine).run(
            a, frames=48, **kw)) == plain(res)
        return res

    # replicate and drop_replica derive new graphs seeded from the parent
    g, rg = graphs.resnet18_graph(), jgraphs.resnet18_graph()
    base = step(g, rg)
    g2, rg2 = g.replicate(2, 3), rg.replicate(2, 3)
    rep = step(g2, rg2)
    assert plain(rep) != plain(base)
    drop = g2.replica_groups()[2][1]
    step(g2.drop_replica(drop), rg2.drop_replica(drop))
    step(g.with_replicas({2: 2, 9: 2}), rg.with_replicas({2: 2, 9: 2}))
    # an in-place edit of a graph whose context is cached
    g.add_edge(3, 6)
    rg.add_edge(3, 6)
    step(g, rg)
    # tenants removed, re-weighted and added on one union object
    mt, rmt = _union_pair()
    step(mt, rmt, "lblp-mt")
    mt.set_tenant_weight("resnet8", 4.0)
    rmt.set_tenant_weight("resnet8", 4.0)
    step(mt, rmt, "lblp-mt")
    mt.remove_tenant("resnet8")
    rmt.remove_tenant("resnet8")
    step(mt, rmt, "lblp-mt")
    mt.add_tenant(graphs.resnet8_graph(), "again")
    rmt.add_tenant(jgraphs.resnet8_graph(), "again")
    step(mt, rmt, "lblp-mt", rates={"resnet18_cifar": 900.0, "again": 2000.0})
