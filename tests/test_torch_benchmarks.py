"""The port's benchmark harness (``benchmarks_torch``) against the
reference's (``benchmarks``):

* each ported paper suite (Fig. 2, Fig. 3, Table I, Fig. 4, YOLOv8n
  latency) runs in-process from both packages, each package's artifact
  directory monkeypatched to ``tmp_path``; the two JSON artifacts (and
  the returned payloads) are equal but for the wall-clock fields in
  ``TIMING_FIELDS`` (``schedule_time_us``, the host time of each
  scheduler call, and ``optimal_time_us``, the exhaustive search's in
  the scheduler-quality suite);
* so is each beyond-paper simulator suite (scheduler quality, elastic,
  multi-tenant, replication, serving, sensitivity), at ``--frames 16``
  where its ``main`` takes frames; the serving suite's trace generator
  and solo profiles equal the reference's for every cell's seed;
* the LM partition suite's imbalances (max/mean stage load, which the
  port's H100 stage rate does not change) and winners equal the
  reference's, the floats within 1e-12 relative;
* ``sim_speed`` at 4 frames writes the keys of the committed
  ``BENCH_sim.json``, only ever into ``BENCH_sim_torch.json`` (its
  ``ROOT_JSON``) and never with ``--check``; its gate passes against its
  own output and fails on a baseline with one suite's speedup doubled;
* ``run.py``'s table is the reference's, entry for entry and in order;
* ``run.py`` forwards ``--frames N`` to a suite whose ``main`` takes
  ``frames`` and to no other, as the reference's does (probed with a
  stand-in suite registered in both tables), refuses a bad ``--frames``
  with the usage line, and prints the reference's message for an unknown
  suite, naming its own table, whose entries are the reference's;
* ``kernel_bench.main`` with ``device="cpu"`` at the reference's five
  shapes (one timed call each: about 6 s on the host) writes the
  reference's keys with the plain versions' times and no card field;
  asked for the card where there is none, it raises;
* the kernel bench bounds its two f32 flash cases by one pass at the TF32
  tensor-core peak or by their bytes (10.02 and 69.47 µs).
"""

import importlib
import json
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

PAPER_SUITES = ("fig2", "fig3", "table1", "fig4", "yolo")
TIMING_FIELDS = {"schedule_time_us", "optimal_time_us"}
#: the beyond-paper simulator suites, whose JSON equals the reference's
SIM_SUITES = ("quality", "elastic", "multi_tenant", "replication", "serving",
              "sensitivity")
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


def _suite_pair(name, tmp_path, monkeypatch):
    """(reference, port) payloads and JSON artifacts of suite ``name`` run
    in-process, at ``--frames 16`` where its ``main`` takes frames."""
    import inspect
    from benchmarks import common as jcommon, run as jrun
    from benchmarks_torch import common, run
    monkeypatch.setattr(jcommon, "ARTIFACT_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(common, "ARTIFACT_DIR", str(tmp_path / "port"))
    out = []
    for package, table, side in (("benchmarks", jrun.SUITES, "ref"),
                                 ("benchmarks_torch", run.SUITES, "port")):
        fn = importlib.import_module(f"{package}.{table[name]}").main
        kw = {"frames": 16} if "frames" in inspect.signature(fn).parameters \
            else {}
        payload = fn(**kw)
        art = json.loads((tmp_path / side / f"{table[name]}.json")
                         .read_text())
        out.append((payload, art))
    return out


@pytest.mark.parametrize("name", SIM_SUITES)
def test_beyond_paper_suite_json_equals_reference(name, tmp_path,
                                                  monkeypatch):
    (want, ref_json), (got, port_json) = _suite_pair(name, tmp_path,
                                                     monkeypatch)
    assert _strip(got) == _strip(want)
    assert _strip(port_json) == _strip(ref_json)
    assert _timing_fields(port_json) == _timing_fields(ref_json)


def test_lm_partition_imbalances_equal_reference(tmp_path, monkeypatch):
    (want, ref_json), (got, port_json) = _suite_pair("partition", tmp_path,
                                                     monkeypatch)
    assert list(got) == list(want) and list(port_json) == list(ref_json)
    for arch in want:
        assert got[arch]["winner"] == want[arch]["winner"], arch
        for key in ("uniform", "lblp"):
            assert got[arch][key] == pytest.approx(want[arch][key],
                                                   rel=1e-12), (arch, key)
            assert port_json[arch][key] == got[arch][key]


def test_serving_traces_and_solo_profiles_equal_reference():
    from benchmarks import serving as jsuite
    from benchmarks_torch import serving as suite
    from repro import core as jcore
    from repro.core import serving as jserving
    from repro.models.cnn import graphs as jgraphs
    from repro_torch import core
    from repro_torch.core import serving
    from repro_torch.models.cnn import graphs
    assert suite.CELLS == jsuite.CELLS
    for fleet, mix, seed in suite.CELLS:
        solo = suite.solo_profile({m: getattr(graphs, f"{m}_graph")()
                                   for m in mix}, fleet, core.CostModel(), 16)
        jsolo = jsuite.solo_profile({m: getattr(jgraphs, f"{m}_graph")()
                                     for m in mix}, fleet, jcore.CostModel(),
                                    16)
        assert solo == jsolo, (fleet, mix)
        assert serving.dump_trace(suite.synth_trace(seed, mix, solo, fleet)) \
            == jserving.dump_trace(jsuite.synth_trace(seed, mix, jsolo, fleet))


@pytest.fixture(scope="module")
def sim_speed_run(tmp_path_factory):
    """The port's ``sim_speed`` at 4 frames and one run a suite and engine,
    its ``ROOT_JSON`` and artifact directory moved to a temporary
    directory; returns (payload, that directory, the ``ROOT_JSON`` it
    had)."""
    from benchmarks_torch import common, sim_speed
    tmp = tmp_path_factory.mktemp("sim_speed")
    root_json = sim_speed.ROOT_JSON
    mp = pytest.MonkeyPatch()
    mp.setattr(sim_speed, "BASELINE_ROUNDS", 1)
    mp.setattr(sim_speed, "ROOT_JSON", str(tmp / "root.json"))
    mp.setattr(common, "ARTIFACT_DIR", str(tmp / "art"))
    try:
        yield sim_speed.main(frames=4), tmp, root_json
    finally:
        mp.undo()


def _keys(d, prefix=""):
    """Dotted key paths of nested dicts (a suite table's names aside)."""
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "suites":
            out |= _keys(v, f"{prefix}{k}.")
    return out


def test_sim_speed_output_has_the_reference_keys(sim_speed_run):
    from benchmarks_torch import sim_speed
    out, tmp, root_json = sim_speed_run
    committed = json.loads((ROOT / "BENCH_sim.json").read_text())
    assert _keys(out) == _keys(committed)
    assert set(out["run_frames64"]["suites"]) == set(sim_speed.SIM_SUITES)
    assert json.loads((tmp / "root.json").read_text()) == \
        json.loads(json.dumps(out))
    assert Path(root_json).resolve() == ROOT / "BENCH_sim_torch.json"


def test_committed_port_baseline_has_the_reference_keys():
    """``BENCH_sim_torch.json``, measured on the card machine's host, is
    laid out as the reference's ``BENCH_sim.json`` and gates every
    simulator suite."""
    from benchmarks_torch import sim_speed
    port = json.loads((ROOT / "BENCH_sim_torch.json").read_text())
    committed = json.loads((ROOT / "BENCH_sim.json").read_text())
    assert _keys(port) == _keys(committed)
    assert set(port["run_frames64"]["suites"]) == set(sim_speed.SIM_SUITES)
    assert all(c["speedup"] > 0
               for c in port["run_frames64"]["suites"].values())


def test_sim_speed_gate_passes_against_its_own_output(sim_speed_run):
    from benchmarks_torch import sim_speed
    out, tmp, _ = sim_speed_run
    assert sim_speed.check_against(str(tmp / "root.json"), out) == 0


def test_sim_speed_gate_fails_on_a_doubled_speedup(sim_speed_run, tmp_path):
    from benchmarks_torch import sim_speed
    out, tmp, _ = sim_speed_run
    base = json.loads((tmp / "root.json").read_text())
    suites = base["run_frames64"]["suites"]
    name = max(suites, key=lambda n: suites[n]["ref_s"])
    assert suites[name]["ref_s"] >= 0.25       # held to the plain slack
    suites[name]["speedup"] *= 2
    (tmp_path / "doubled.json").write_text(json.dumps(base))
    assert sim_speed.check_against(str(tmp_path / "doubled.json"), out) == 1


def test_sim_speed_check_writes_no_root_file(sim_speed_run, tmp_path,
                                             monkeypatch):
    """With ``check`` the suite measures and gates only: ``ROOT_JSON`` is
    never written (a baseline of zero speedups passes the gate, so the
    check itself cannot fail on a noisy host)."""
    from benchmarks_torch import common, sim_speed
    out, tmp, _ = sim_speed_run
    base = json.loads((tmp / "root.json").read_text())
    for cell in base["run_frames64"]["suites"].values():
        cell["speedup"] = 0.0
    (tmp_path / "zero.json").write_text(json.dumps(base))
    monkeypatch.setattr(sim_speed, "ROOT_JSON", str(tmp_path / "root.json"))
    monkeypatch.setattr(common, "ARTIFACT_DIR", str(tmp_path / "art"))
    monkeypatch.setattr(sim_speed, "SIM_SUITES", ("fig2", "fig3", "table1",
                                                 "fig4"))
    monkeypatch.setattr(sim_speed, "SUITE_REPEATS", 1)
    before = {p: p.read_bytes() for p in (ROOT / "BENCH_sim.json",
                                          ROOT / "BENCH_sim_torch.json")
              if p.exists()}
    got = sim_speed.main(frames=4, check=str(tmp_path / "zero.json"))
    assert got["check"]["regressions"] == 0
    assert not (tmp_path / "root.json").exists()
    assert {p: p.read_bytes() for p in before} == before


def test_run_table_is_the_references():
    from benchmarks import run as jrun
    from benchmarks_torch import run
    assert list(run.SUITES.items()) == list(jrun.SUITES.items())


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


def test_kernel_bench_f32_flash_bounds():
    """Both f32 flash cases run on the f32 tensor-core instance (hd 128),
    so their bound is one pass at the TF32 peak or the bytes: 10.02 µs by
    bytes at (2, 8, 1024, 128) and 69.47 µs by operations at (1, 8, 4096,
    128), as ``kernel_bench.bound`` gives them from the case shapes."""
    from benchmarks_torch import kernel_bench as kb
    from repro_torch.launch.roofline import PEAK_TF32_FLOPS
    want = {(2, 8, 1024, 128): (10.02, "bytes", "HBM_BW"),
            (1, 8, 4096, 128): (69.47, "operations", "PEAK_TF32_FLOPS")}
    assert set(kb.FLASH_SHAPES) == set(want)
    for (B, H, S, hd), (us, by, const) in want.items():
        pairs = B * H * S * (S + 1) / 2
        got = kb.bound(4.0 * 4 * B * H * S * hd, 4.0 * hd * pairs,
                       PEAK_TF32_FLOPS, "PEAK_TF32_FLOPS")
        assert (round(got[0], 2), got[1]) == (us, by)
        assert kb.flash_bound(B, H, S, hd) == (got[0], by, const)
    # a head wider than the f32 tensor-core instance's plan is bound at the
    # CUDA cores' f32 peak
    assert kb.flash_bound(1, 1, 1000, 320)[2] == "PEAK_F32_FLOPS"


def test_kernel_bench_needs_the_card(monkeypatch):
    from benchmarks_torch import kernel_bench
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_bench.main()
