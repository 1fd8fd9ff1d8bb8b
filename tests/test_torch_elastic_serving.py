"""The port's elastic tier and serving control plane against the
reference's, in one process: ``ElasticSession`` event lists and
degradation curves equal with ``==`` (PU failure and rejoin, replica
absorption, tenant churn), and ``ServingControlPlane.audit_json()``
string-equal under both engines, on the README's trace and on seeded
churn traces of the reference's serving benchmark, carried over as JSON
(``dump_trace`` -> the port's ``load_trace``)."""

import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks.serving import solo_profile, synth_trace  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.core import elastic as jelastic  # noqa: E402
from repro.core import serving as jserving  # noqa: E402
from repro.core.graph import PUType as JPUType  # noqa: E402
from repro.models.cnn import graphs as jgraphs  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.core import elastic, serving  # noqa: E402
from repro_torch.core.graph import PUType  # noqa: E402
from repro_torch.models.cnn import graphs  # noqa: E402
from test_torch_schedulers import assert_same_assignment, plain  # noqa: E402

ENGINES = ["exact", "periodic"]


class Pair:
    """The same session on both packages: every call goes to each side,
    and the histories, curves and assignments must stay equal."""

    def __init__(self, g, rg, fleet, **kw):
        self.s = elastic.ElasticSession(g, core.make_pus(*fleet), **kw)
        self.r = jelastic.ElasticSession(rg, jcore.make_pus(*fleet), **kw)
        self.check()

    def check(self):
        assert plain(self.s.history) == plain(self.r.history)
        assert self.s.degradation_curve() == self.r.degradation_curve()
        assert_same_assignment(self.s.assignment, self.r.assignment)
        assert (self.s.serving_graph.to_json()
                == self.r.serving_graph.to_json())
        assert self.s.replica_counts() == self.r.replica_counts()

    def __call__(self, verb, *args, port_args=None, **kw):
        ev = getattr(self.s, verb)(*(port_args or args), **kw)
        rev = getattr(self.r, verb)(*args, **kw)
        self.check()
        return ev, rev


def imc(pu_id, ref=False):
    cls = jcore.cost.PUSpec if ref else core.cost.PUSpec
    return cls(pu_id=pu_id, pu_type=(JPUType if ref else PUType).IMC)


def fail_join(pair, fails):
    for pu in fails:
        pair("fail", pu)
    pair("join", imc(fails[0], ref=True), port_args=(imc(fails[0]),))


# ---------------------------------------------------------------------------
# ElasticSession
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_resnet18_fail_join_equals_reference(engine):
    pair = Pair(graphs.resnet18_graph(), jgraphs.resnet18_graph(), (8, 4),
                engine=engine)
    fail_join(pair, (1, 2))
    assert [n for n, _, _ in pair.s.degradation_curve()] == [12, 11, 10, 11]
    assert {e.recovery for e in pair.s.history} == {"schedule"}
    assert pair.s.history[-1].result is not None
    assert all(e.result is None for e in pair.s.history[:-1])


@pytest.mark.parametrize("fleet", [(4, 2), (7, 3)], ids=str)
@pytest.mark.parametrize("alg", ["lblp", "wb", "lblp-r"])
def test_resnet8_fail_join_equals_reference(alg, fleet):
    pair = Pair(graphs.resnet8_graph(), jgraphs.resnet8_graph(), fleet,
                algorithm=alg, frames=32)
    fail_join(pair, (2, fleet[0] + 1))         # an IMC and a DPU PU


def test_replica_absorb_equals_reference():
    """lblp-r on ResNet-8 over 12 + 6 PUs: a PU that holds only replicas
    is absorbed (no reschedule, no node moves); a PU holding a sole copy
    falls back to a full reschedule."""
    pair = Pair(graphs.resnet8_graph(), jgraphs.resnet8_graph(), (12, 6),
                algorithm="lblp-r")
    mapping = dict(pair.s.assignment.mapping)
    reps = {m for ms in pair.s.serving_graph.replica_groups().values()
            for m in ms}
    only = [pid for pid in sorted(set(mapping.values()))
            if all(n in reps for n, p in mapping.items() if p == pid)]
    assert only == [1, 2, 3, 9, 10, 11, 12]
    ev, _ = pair("fail", only[0])
    assert ev.recovery == "replica-absorb"
    assert all(ev.mapping[n] == mapping[n] for n in ev.mapping)
    g = pair.s.serving_graph
    solo = next(p for n, p in pair.s.assignment.mapping.items()
                if g.nodes[n].replica_group is None)
    ev, _ = pair("fail", solo)
    assert ev.recovery == "schedule"
    with pytest.raises(KeyError):
        pair.s.fail(solo)
    with pytest.raises(KeyError):
        pair.s.join(pair.s.live[0])


@pytest.mark.parametrize("engine", ENGINES)
def test_tenant_churn_equals_reference(engine):
    """Every serving verb of a MultiTenantGraph-backed session on both
    packages: add, reweight, explicit replica widths, remove, adopt a
    prepared union, and a PU failure under the replicated union."""
    mt = core.MultiTenantGraph.union([graphs.resnet8_graph()])
    rmt = jcore.MultiTenantGraph.union([jgraphs.resnet8_graph()])
    pair = Pair(mt, rmt, (8, 4), engine=engine, frames=32)
    pair("add_tenant", jgraphs.resnet18_graph(), "bulk", weight=2.0,
         port_args=(graphs.resnet18_graph(), "bulk"))
    pair("reweight", "resnet8", 3.0)
    base = next(n for n in sorted(mt.tenant_nodes("resnet8"))
                if not mt.nodes[n].is_free())
    pair("set_replicas", {base: 2})
    pair("add_tenant", jgraphs.resnet8_graph(), "cam", replicas={base: 3},
         port_args=(graphs.resnet8_graph(), "cam"))
    pair("fail", 3)
    pair("remove_tenant", "resnet8", replicas={base: 2})
    cand, rcand = mt.copy(), rmt.copy()
    cand.add_tenant(graphs.resnet8_graph(), "late")
    rcand.add_tenant(jgraphs.resnet8_graph(), "late")
    pair("adopt_union", rcand, tenant="late", port_args=(cand,))
    pair("set_replicas", {}, recovery="reclaim")
    assert [e.recovery for e in pair.s.history] == [
        "schedule", "tenant-add", "reweight", "replicate", "tenant-add",
        pair.s.history[5].recovery, "tenant-remove", "tenant-add", "reclaim"]
    with pytest.raises(ValueError):
        elastic.ElasticSession(mt, core.make_pus(4, 2),
                               algorithm="lblp-r").set_replicas({base: 2})


def test_empty_union_session_equals_reference():
    mt, rmt = core.MultiTenantGraph("empty"), jcore.MultiTenantGraph("empty")
    pair = Pair(mt, rmt, (4, 2), frames=32)
    pair("add_tenant", jgraphs.resnet8_graph(), "a",
         port_args=(graphs.resnet8_graph(), "a"))
    pair("remove_tenant", "a")
    assert pair.s.history[-1].rate == 0.0
    assert pair.s.history[-1].tenant_rates == {}
    with pytest.raises(TypeError):
        elastic.ElasticSession(graphs.resnet8_graph(),
                               core.make_pus(2, 1)).add_tenant(
            graphs.resnet8_graph())


# ---------------------------------------------------------------------------
# ServingControlPlane
# ---------------------------------------------------------------------------

def readme_trace(pkg):
    return [
        pkg.TraceEvent("arrive", tenant="cam-0", model="resnet8",
                       slo=pkg.SLO(min_rate=300.0, max_latency=0.05)),
        pkg.TraceEvent("arrive", tenant="bulk-0", model="resnet18",
                       slo=pkg.SLO(min_rate=400.0), weight=2.0),
        pkg.TraceEvent("fail", pu_id=3),
    ]


def play_both(trace_json, fleet, engine, **kw):
    """Play one JSON trace on a plane of each package; their audits must
    be equal strings.  Returns the port's plane."""
    plane = serving.ServingControlPlane(
        core.make_pus(*fleet), {"resnet8": graphs.resnet8_graph(),
                                "resnet18": graphs.resnet18_graph()},
        engine=engine, **kw)
    rplane = jserving.ServingControlPlane(
        jcore.make_pus(*fleet), {"resnet8": jgraphs.resnet8_graph(),
                                 "resnet18": jgraphs.resnet18_graph()},
        engine=engine, **kw)
    plane.play(serving.load_trace(trace_json))
    rplane.play(jserving.load_trace(trace_json))
    assert plane.audit_json() == rplane.audit_json()
    assert plain(plane.decisions) == plain(rplane.decisions)
    assert plane.probes == rplane.probes
    assert plain(plane.session.history) == plain(rplane.session.history)
    return plane


@pytest.mark.parametrize("engine", ENGINES)
def test_readme_trace_audit_equals_reference(engine):
    trace = jserving.dump_trace(readme_trace(jserving))
    assert serving.dump_trace(readme_trace(serving)) == trace
    plane = play_both(trace, (8, 4), engine)
    assert [d.action for d in plane.decisions][:3] == ["admit", "admit", "fail"]
    assert plane.reports["cam-0"].satisfied()


SYNTH_CELLS = [((4, 2), ("resnet8", "resnet18"), 11), ((4, 2), ("resnet8",), 23)]


def synth_json(fleet, mix, seed):
    """A seeded churn trace of the reference's serving benchmark, as JSON:
    arrivals past the fleet's capacity, a weight change, a departure, and
    a PU failure that later rejoins."""
    models = {"resnet8": jgraphs.resnet8_graph(),
              "resnet18": jgraphs.resnet18_graph()}
    solo = solo_profile({m: models[m] for m in mix}, fleet, jcore.CostModel(),
                        64)
    return jserving.dump_trace(synth_trace(seed, mix, solo, fleet))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("cell", SYNTH_CELLS, ids=lambda c: f"{c[1]}-{c[2]}")
def test_synth_trace_audit_equals_reference(cell, engine):
    fleet, mix, seed = cell
    plane = play_both(synth_json(fleet, mix, seed), fleet, engine)
    acts = {d.action for d in plane.decisions}
    assert {"admit", "fail", "join"} <= acts
    # with admission on, no admitted tenant ever samples a broken promise
    assert all(not r.violations for r in plane.reports.values())


@pytest.mark.parametrize("engine", ENGINES)
def test_admit_all_audit_equals_reference(engine):
    """The baseline without admission or autoscaling: violations appear,
    and they appear alike."""
    fleet, mix, seed = SYNTH_CELLS[0]
    play_both(synth_json(fleet, mix, seed), fleet, engine, admission=False,
              autoscale=False)


@pytest.mark.parametrize("cell", SYNTH_CELLS + [None],
                         ids=lambda c: "readme" if c is None else str(c[2]))
def test_trace_round_trip(cell):
    text = (jserving.dump_trace(readme_trace(jserving)) if cell is None
            else synth_json(*cell))
    events = serving.load_trace(text)
    assert serving.dump_trace(events) == text
    assert serving.load_trace(serving.dump_trace(events)) == events
    assert [e.label() for e in events] == [
        e.label() for e in jserving.load_trace(text)]


def test_slo_helpers_equal_reference():
    for pkg in (serving, jserving):
        assert pkg.SLO.from_dict(None) == pkg.SLO()
    for rate, lat, slo in ((500.0, 0.01, (400.0, 0.02)),
                           (300.0, 0.03, (400.0, 0.02)),
                           (300.0, 0.03, (None, None)),
                           (300.0, 0.03, (None, 0.05))):
        assert (serving.SLO(*slo).headroom(rate, lat)
                == jserving.SLO(*slo).headroom(rate, lat))
        assert serving.SLO(*slo).to_dict() == jserving.SLO(*slo).to_dict()
    samples = [(0, 10.0, 0.1, 0.5), (1, 4.0, 0.1, -0.2), (2, 3.0, 0.1, -0.1),
               (4, 9.0, 0.1, 0.0), (5, 1.0, 0.1, -1.0)]
    reps = {}
    for pkg in (serving, jserving):
        rep = pkg.SLOReport("t", pkg.SLO(min_rate=5.0), 1.0, admitted_index=0,
                            samples=list(samples))
        reps[pkg] = (rep.violations, rep.satisfied(), rep.to_dict(),
                     pkg.aggregate_goodput({"t": rep}, 6))
    assert reps[serving] == reps[jserving]
    assert reps[serving][0] == [(1, 2), (5, 5)]
    with pytest.raises(ValueError):
        serving.ServingControlPlane(core.make_pus(2, 1), {}).step(
            serving.TraceEvent("nope"))


def test_core_exports_serving():
    for name in ("SLO", "Decision", "ServingControlPlane", "SLOReport",
                 "TraceEvent", "aggregate_goodput", "dump_trace", "load_trace"):
        assert getattr(core, name) is getattr(serving, name)
        assert name in core.__all__
    assert set(jcore.__all__) <= set(core.__all__)
