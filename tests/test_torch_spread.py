"""The run-to-run spread script (``benchmarks_torch.spread``) on the host:

* its statistics against numpy on fixed samples: median, quartiles, IQR
  over the median, and the tail rule, the highest integer percentile with
  at least 10 samples beyond it (none below the median);
* its rank correlation against Spearman's by hand, ties averaged;
* ``spread.main(device="cpu", rounds=2)`` at the stand-in sizes (ResNet-8,
  granite-moe's 2-layer smoke config) returns and writes every host field
  of both paths and no card field or traced round, with the tokens equal
  across rounds;
* the CNN request it builds is phase 4's served request, which on the
  CPU is the plain ``execute(..., mode="int8")`` (on the card it is
  ``executor.GraphedExecute``);
* a call's host time is the timed rounds' median wall less the traced
  round's median device time;
* asked for the card where there is none, it raises.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")


def test_summary_against_numpy():
    from benchmarks_torch import spread
    xs = np.random.default_rng(3).lognormal(size=96)
    got = spread.summary(list(xs))
    q1, med, q3 = np.percentile(xs, (25, 50, 75))
    assert got == {"n": 96, "median": med, "q1": q1, "q3": q3,
                   "iqr_over_median": (q3 - q1) / med, "min": xs.min(),
                   "max": xs.max(), "tail_percentile": 89,
                   "tail": np.percentile(xs, 89)}
    # 96 samples: 10.56 beyond the 89th percentile, 9.6 beyond the 90th
    assert (np.sort(xs) > got["tail"]).sum() >= 10
    # a median of 0 (a load average that reads 0) has no IQR ratio
    assert spread.summary([0.0] * 12)["iqr_over_median"] is None


@pytest.mark.parametrize("n,p", [(0, None), (12, None), (19, None), (20, 50),
                                 (96, 89), (100, 90), (384, 97), (1000, 99),
                                 (10_000, 99)])
def test_tail_percentile_rule(n, p):
    """The highest integer P with n (100 - P) / 100 >= 10, or None where it
    would be below the median."""
    from benchmarks_torch import spread
    assert spread.tail_percentile(n) == p
    if p is not None:
        assert n * (100 - p) >= 1000 > n * (100 - p - 1) or p == 99


def test_spearman_ties_and_constants():
    from benchmarks_torch import spread
    x = [3.0, 1.0, 2.0, 2.0, 5.0]
    y = [30.0, 11.0, 19.0, 25.0, 40.0]
    rx = np.array([3, 0, 1.5, 1.5, 4])
    ry = np.array([3, 0, 1, 2, 4])
    assert spread.ranks(x).tolist() == rx.tolist()
    assert spread.spearman(x, y) == pytest.approx(np.corrcoef(rx, ry)[0, 1])
    assert spread.spearman(x, [-v for v in x]) == pytest.approx(-1.0)
    assert spread.spearman(x, [1.0] * 5) is None


def test_spread_on_the_host(tmp_path, monkeypatch):
    from benchmarks_torch import common, spread
    monkeypatch.setattr(common, "ARTIFACT_DIR", str(tmp_path))
    out = spread.main(device="cpu", rounds=2)
    assert json.loads((tmp_path / "spread.json").read_text()) == json.loads(
        json.dumps(out))
    assert "card" not in out and "traced" not in out and out["device"] == "cpu"
    assert out["tokens_equal"] and out["rounds"] == 2
    sizes = spread.stand_in_sizes()
    assert out["sizes"]["cnn"] == "resnet8" and out["sizes"]["lm_layers"] == 2
    n = {"cnn_latency_ms": 2 * sizes.requests, "cnn_frames_per_s":
         2 * sizes.requests, "ttft_ms": 2, "decode_ms": 2 * sizes.decode_steps,
         "probe_python_ms": 2, "loadavg_1m": 2, "cpus": 2}
    assert {k: m["n"] for k, m in out["metrics"].items()} == n
    assert not set(spread.CARD_METRICS) & set(out["metrics"])
    assert set(out["round_medians"]) == set(n)
    for k, r in out["round_medians"].items():
        assert len(r["values"]) == 2 and r["min"] <= r["max"]
    assert out["rank_correlation"].keys() == set(spread.WALL_METRICS)
    assert all(set(v) == {"probe_python_ms"}
               for v in out["rank_correlation"].values())
    for rec in out["per_round"]:
        assert set(rec) == set(n)
        assert rec["cnn_frames_per_s"] > 0 and rec["decode_ms"] > 0


def test_a_shorter_round_serves_the_tokens_prefix():
    """The traced round serves fewer decode steps than the timed rounds:
    its tokens are the first of theirs, and it runs that many steps."""
    from benchmarks_torch import spread
    sizes = spread.stand_in_sizes()
    dev = torch.device("cpu")
    request, xs = spread.build_cnn(sizes, dev)
    server, prompts = spread.build_lm(sizes, dev)

    def wrap(fn, samples):
        return spread.timed(fn, samples, False)
    _, full = spread.serve_round(sizes, request, xs, server, prompts, wrap)
    short = sizes._replace(decode_steps=2)
    raw, head = spread.serve_round(short, request, xs, server, prompts, wrap)
    assert len(raw["decode"]) == 2 and len(raw["prefill"]) == 1
    assert head == [t[:2] for t in full] and len(full[0]) == sizes.decode_steps


def test_cnn_request_on_the_host_is_the_plain_execute():
    from benchmarks_torch import spread
    from repro_torch.models import quant
    from repro_torch.models.cnn import executor, graphs, resnet
    sizes = spread.stand_in_sizes()
    dev = torch.device("cpu")
    request, xs = spread.build_cnn(sizes, dev)
    params = resnet.init(torch.Generator().manual_seed(0), resnet.RESNET8,
                         device=dev)
    data = torch.Generator(device=dev).manual_seed(1)
    x_cal = torch.randn((sizes.frames, 32, 32, 3), generator=data, device=dev)
    scales = quant.calibrate_resnet(params, x_cal, resnet.RESNET8)
    assert xs.shape == (sizes.requests, sizes.frames, 32, 32, 3)
    assert torch.equal(request(xs[0]), executor.execute(
        graphs.resnet8_graph(), params, xs[0], mode="int8", act_scales=scales))


def test_spread_needs_the_card(monkeypatch):
    from benchmarks_torch import spread
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spread.main()


def test_device_split():
    """Each call's device time is the traced round's summary; its host time
    the timed rounds' median wall less the device median, and its host
    share that over the wall."""
    from benchmarks_torch import spread
    raw = {"cnn": [0.5, 0.4, 0.6], "prefill": [150.0],
           "decode": [20.0, 19.0, 21.0, 20.0]}
    metrics = {"cnn_latency_ms": {"median": 6.0}, "ttft_ms": {"median": 160.0},
               "decode_ms": {"median": 80.0}}
    got = spread.device_split(raw, metrics)
    assert set(got) == {p for _, p in spread.CALLS} == {"cnn", "ttft", "decode"}
    assert got["cnn"]["device_ms"] == spread.summary([0.5, 0.4, 0.6])
    assert got["cnn"]["host_ms"] == pytest.approx(5.5)
    assert got["cnn"]["host_share"] == pytest.approx(5.5 / 6.0)
    assert got["ttft"]["host_ms"] == pytest.approx(10.0)
    assert got["decode"]["device_ms"]["n"] == 4
    assert got["decode"]["wall_ms_median"] == 80.0
    assert got["decode"]["host_share"] == pytest.approx(0.75)
