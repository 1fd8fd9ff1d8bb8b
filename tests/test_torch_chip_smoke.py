"""The card-free phases of ``chip_smoke.py`` rehearsed on the CPU: the
LM card-against-CPU gate with the CPU on both sides, and the placement
phase (schedule and simulate the ResNet-18 graph the main path executes)
against the reference's schedulers and simulator."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.models.cnn import graphs as jgraphs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.cnn import graphs  # noqa: E402
from repro_torch.models.lm import transformer  # noqa: E402


def test_lm_gate_compares_tokens_on_cpu():
    cfg = get_config("gemma3-1b").smoke()
    out = chip_smoke.lm_card_vs_cpu(cfg, torch.device("cpu"), 12, 3)
    assert out["worst_rel"] == 0.0
    assert 1 <= out["tokens_compared"] <= 4


def test_lm_gate_fails_when_no_token_is_compared(monkeypatch):
    """Flat logits leave no top-2 margin at any step: the gate compared
    nothing, and says so instead of passing."""
    cfg = get_config("gemma3-1b").smoke()

    def flat(cfg, params, toks, *rest):
        return torch.ones((toks.shape[0], toks.shape[1], cfg.vocab)), None

    monkeypatch.setattr(transformer, "prefill", flat)
    monkeypatch.setattr(transformer, "decode", flat)
    with pytest.raises(AssertionError, match="no greedy token compared"):
        chip_smoke.lm_card_vs_cpu(cfg, torch.device("cpu"), 8, 2)


def test_placement_phase_equals_reference():
    g18 = graphs.resnet18_graph()
    lblp, rec = chip_smoke.schedule_and_simulate(g18)
    assert set(lblp.mapping) == set(g18.nodes) and len(g18) == 30
    cm = jcore.CostModel()
    rg = jgraphs.resnet18_graph()
    for alg in chip_smoke.PLACE_ALGS:
        ra = jcore.get_scheduler(alg, cm).schedule(
            rg, jcore.make_pus(*chip_smoke.PLACE_FLEET))
        row = rec["schedulers"][alg]
        assert row["mapping"] == {str(k): v for k, v in sorted(ra.mapping.items())}
        for engine in ("exact", "periodic"):
            res = jcore.make_simulator(rg, cm, engine=engine).run(
                ra, frames=chip_smoke.PLACE_FRAMES)
            assert (row[engine]["rate"], row[engine]["latency"],
                    row[engine]["mean_utilization"]) == (
                res.rate, res.latency, res.mean_utilization)
    assert rec["replicated"]["replicas"]
    assert set(rec["multi_tenant"]["tenants"]) == set(chip_smoke.MT_RATES)
