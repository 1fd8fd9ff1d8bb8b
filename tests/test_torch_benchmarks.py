"""The port's benchmark harness (``benchmarks_torch``) against the
reference's (``benchmarks``):

* each ported paper suite (Fig. 2, Fig. 3, Table I, Fig. 4, YOLOv8n
  latency) runs in-process from both packages, each package's artifact
  directory monkeypatched to ``tmp_path``; the two JSON artifacts (and
  the returned payloads) are equal but for the wall-clock fields in
  ``TIMING_FIELDS`` (``schedule_time_us``: the host time of each
  scheduler call, the only one these suites record);
* ``run.py`` forwards ``--frames N`` to a suite whose ``main`` takes
  ``frames`` and to no other, as the reference's does (probed with a
  stand-in suite registered in both tables), refuses a bad ``--frames``
  with the usage line, and prints the reference's message for an unknown
  suite, naming its own table, whose entries are the reference's;
* ``kernel_bench.main`` with ``device="cpu"`` at the reference's five
  shapes (one timed call each: about 6 s on the host) writes the
  reference's keys with the plain versions' times and no card field;
  asked for the card where there is none, it raises.
"""

import importlib
import json
import sys
import types

import pytest

torch = pytest.importorskip("torch")

PAPER_SUITES = ("fig2", "fig3", "table1", "fig4", "yolo")
TIMING_FIELDS = {"schedule_time_us"}
#: the reference's kernel-bench keys (``benchmarks/kernel_bench.py``: the
#: mvm shapes at ``:34-35``, the flash shapes at ``:54``)
KERNEL_KEYS = ("imc_mvm.256x512x512", "imc_mvm.1024x1024x1024",
               "imc_mvm.128x4096x4096", "flash.2x8x1024x128",
               "flash.1x8x4096x128")


def _strip(x):
    """``x`` without the wall-clock fields, at any depth."""
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in TIMING_FIELDS}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def _timing_fields(x) -> set:
    if isinstance(x, dict):
        return {k for k in x if k in TIMING_FIELDS}.union(
            *(_timing_fields(v) for v in x.values()))
    if isinstance(x, list):
        return set().union(*(_timing_fields(v) for v in x))
    return set()


@pytest.mark.parametrize("name", PAPER_SUITES)
def test_paper_suite_json_equals_reference(name, tmp_path, monkeypatch):
    from benchmarks import common as jcommon, run as jrun
    from benchmarks_torch import common, run
    assert run.SUITES[name] == jrun.SUITES[name]
    monkeypatch.setattr(jcommon, "ARTIFACT_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(common, "ARTIFACT_DIR", str(tmp_path / "port"))
    want = importlib.import_module(f"benchmarks.{jrun.SUITES[name]}").main()
    got = importlib.import_module(
        f"benchmarks_torch.{run.SUITES[name]}").main()
    assert _strip(got) == _strip(want)
    file = f"{run.SUITES[name]}.json"
    ref_json = json.loads((tmp_path / "ref" / file).read_text())
    port_json = json.loads((tmp_path / "port" / file).read_text())
    assert _strip(port_json) == _strip(ref_json)
    assert _timing_fields(port_json) == _timing_fields(ref_json)


def _probe(package, monkeypatch):
    """A stand-in suite ``probe`` (``main(frames)``) and ``plain``
    (``main()``) registered in ``package``'s table; returns the calls."""
    calls = []
    takes = types.ModuleType(f"{package}._probe_frames")
    takes.main = lambda frames=96: calls.append(("probe", frames))
    plain = types.ModuleType(f"{package}._probe_plain")
    plain.main = lambda: calls.append(("plain", None))
    monkeypatch.setitem(sys.modules, takes.__name__, takes)
    monkeypatch.setitem(sys.modules, plain.__name__, plain)
    run = importlib.import_module(f"{package}.run")
    monkeypatch.setitem(run.SUITES, "probe", "_probe_frames")
    monkeypatch.setitem(run.SUITES, "plain", "_probe_plain")
    return calls


def _run_reference(monkeypatch, args):
    from benchmarks import run as jrun
    monkeypatch.setattr(sys, "argv", ["benchmarks.run", *args])
    jrun.main()


@pytest.mark.parametrize("args", [["--frames", "7", "probe", "plain"],
                                  ["probe", "plain"]])
def test_frames_forwarding_matches_reference(monkeypatch, args):
    from benchmarks_torch import run
    want = _probe("benchmarks", monkeypatch)
    got = _probe("benchmarks_torch", monkeypatch)
    _run_reference(monkeypatch, args)
    run.main(args)
    assert got == want
    assert got[0] == ("probe", 7 if "--frames" in args else 96)


def test_bad_frames_prints_usage(capsys):
    from benchmarks_torch import run
    with pytest.raises(SystemExit) as e:
        run.main(["--frames", "x"])
    assert e.value.code == 2
    assert capsys.readouterr().out.startswith(
        "usage: python -m benchmarks_torch.run [--frames N]")


def test_unknown_suite_message_matches_reference(monkeypatch, capsys):
    from benchmarks import run as jrun
    from benchmarks_torch import run
    _run_reference(monkeypatch, ["nope"])
    want = capsys.readouterr().out.splitlines()[0]
    run.main(["nope"])
    got = capsys.readouterr().out.splitlines()[0]
    assert got == f"unknown suite 'nope'; have {sorted(run.SUITES)}"
    assert got == want.replace(str(sorted(jrun.SUITES)),
                               str(sorted(run.SUITES)))
    assert {k: jrun.SUITES[k] for k in run.SUITES} == run.SUITES


def test_kernel_bench_on_the_host(tmp_path, monkeypatch):
    from benchmarks_torch import common, kernel_bench
    monkeypatch.setattr(common, "ARTIFACT_DIR", str(tmp_path))
    out = kernel_bench.main(device="cpu", iters=1)
    assert tuple(out) == KERNEL_KEYS
    written = json.loads((tmp_path / "kernel_bench.json").read_text())
    assert written == out
    for rec in out.values():
        assert set(rec) == {"plain_us"} and rec["plain_us"] > 0


def test_kernel_bench_needs_the_card(monkeypatch):
    from benchmarks_torch import kernel_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_bench.main()
