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
  reference's keys first, in order, with the plain versions' times and no
  card field, then stand-in port cases under ``port.`` keys and their
  path sums; asked for the card where there is none, it raises;
* the kernel bench bounds its two f32 flash cases by one pass at the TF32
  tensor-core peak or by their bytes (10.02 and 69.47 µs);
* its served cases are the configs' and the graph's: bf16 flash at
  granite-moe's, recurrentgemma's and gemma3-1b's heads, KV heads, head
  width and first-segment windows, 11 distinct ResNet-18-CIFAR convs
  whose counts (20) rebuild the reference graph's conv nodes, and the
  fc; the bf16 bound rule gives 52.14, 278.0, 19.72 and 39.1 µs (1.668,
  3.336 and 0.590 ms a prefill), its pairs equal a mask's count, and a
  path sum adds launches x µs, a missing library call making it None.
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


def _stand_in_port_cases(kernel_bench):
    """Port cases at small shapes, one of each kind, on both summed paths
    and on one that is not summed."""
    P = kernel_bench.PortCase
    return [P(kernel_bench.flash_key("s", 1, 4, 2, 32, 16, None), "flash_bf16",
              (1, 4, 2, 32, 16, None), "granite_prefill", 3),
            P(kernel_bench.flash_key("s", 1, 4, 1, 32, 16, 8), "flash_bf16",
              (1, 4, 1, 32, 16, 8), "gemma3_prefill", 2),
            P(kernel_bench.conv_key(2, 8, 8, 3, 8, 3, 1, "SAME"), "imc_conv2d",
              (2, 8, 8, 3, 8, 3, 1, "SAME"), "resnet18_int8", 2),
            P("port.imc_mvm.4x16x10", "imc_mvm", (4, 16, 10), "resnet18_int8",
              1)]


def test_kernel_bench_on_the_host(tmp_path, monkeypatch):
    from benchmarks_torch import common, kernel_bench
    monkeypatch.setattr(common, "ARTIFACT_DIR", str(tmp_path))
    port = _stand_in_port_cases(kernel_bench)
    out = kernel_bench.main(device="cpu", iters=1, port=port)
    assert tuple(out)[:5] == KERNEL_KEYS
    assert tuple(out)[5:] == tuple(c.key for c in port) + (
        "port.path.resnet18_int8", "port.path.granite_prefill")
    assert all(k.startswith("port.") for k in tuple(out)[5:])
    written = json.loads((tmp_path / "kernel_bench.json").read_text())
    assert written == out
    for key in KERNEL_KEYS:
        assert set(out[key]) == {"plain_us"} and out[key]["plain_us"] > 0
    for c in port:      # the plain time and the case's path, no card field
        rec = out[c.key]
        assert set(rec) == {"plain_us", "path", "path_launches"}
        assert rec["plain_us"] > 0 and rec["path_launches"] == c.path_launches
    cnn = out["port.path.resnet18_int8"]
    assert set(cnn) == {"cases", "path_launches", "plain_us"}
    assert cnn["path_launches"] == 3
    assert cnn["plain_us"] == pytest.approx(
        2 * out[port[2].key]["plain_us"] + out[port[3].key]["plain_us"])
    assert out["port.path.granite_prefill"]["cases"] == [port[0].key]
    # no port case on the host unless given
    assert tuple(kernel_bench.main(device="cpu", iters=1)) == KERNEL_KEYS


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


def test_kernel_bench_served_flash_cases_are_the_configs():
    """One bf16 flash case per distinct window of each served arch's first
    segment, at batch 4 and its served prompt width, with its launches a
    prefill: granite 32 (global), recurrentgemma 12 (its 2,048 window at
    3,072 tokens), gemma3-1b 22 local and 4 global.  Each runs on the
    instance the rule names: granite (hd 64) on the wgmma instance at
    width 64, hd 256 on the bf16 tensor-core instance's 16-step plan and
    hd 288 on its 18-step one."""
    from benchmarks_torch import kernel_bench as kb
    from repro_torch.configs import GLOBAL_WINDOW, get_config
    from repro_torch.kernels import flash_attention as fa
    flash = [c for c in kb.served_cases() if c.kind == "flash_bf16"]
    want = []
    for arch, S, path in kb.FLASH_SERVED:
        cfg = get_config(arch)
        windows = cfg.segments[0].windows()
        for w in sorted(set(windows)):
            want.append(((4, cfg.n_heads, cfg.n_kv_heads, S, cfg.hd,
                          None if w == GLOBAL_WINDOW else w), path,
                         windows.count(w)))
    assert [(c.shape, c.path, c.path_launches) for c in flash] == want
    assert [(c.shape, c.path_launches) for c in flash] == [
        ((4, 24, 8, 2048, 64, None), 32), ((4, 16, 1, 3072, 256, 2048), 12),
        ((4, 4, 1, 2048, 288, 512), 22), ((4, 4, 1, 2048, 288, None), 4)]
    assert [kb.rule_instance(c) for c in flash] == [
        fa.WGMMA, fa.TENSOR_CORE, fa.TENSOR_CORE, fa.TENSOR_CORE]
    assert [kb.plan(c.shape[4]) for c in flash] == [
        "wgmma width 64", "16 steps", "18 steps", "18 steps"]
    assert len({c.key for c in kb.served_cases()}) == len(kb.served_cases())


def test_kernel_bench_served_convs_are_the_graphs():
    """The 11 distinct convs of ResNet-18-CIFAR at batch 256, with counts
    (1, 4, 1, 3, 1, 1, 3, 1, 1, 3, 1) that sum to its 20 conv nodes:
    expanded by their counts they are the reference graph's conv nodes
    (Cin, Cout, k, stride, output map); then its one fc, 256 x 10."""
    from benchmarks_torch import kernel_bench as kb
    from repro.models.cnn import graphs as jgraphs
    cases = kb.served_cases()
    convs = [c for c in cases if c.kind == "imc_conv2d"]
    assert [c.path_launches for c in convs] == [1, 4, 1, 3, 1, 1, 3, 1, 1, 3, 1]
    got = sorted((c.shape[3], c.shape[4], c.shape[5], c.shape[6],
                  (c.shape[1] // c.shape[6], c.shape[2] // c.shape[6]))
                 for c in convs for _ in range(c.path_launches))
    g = jgraphs.resnet18_graph()
    want = sorted((n.meta["cin_kk"] // n.meta["k"] ** 2, n.meta["cout"],
                   n.meta["k"], n.meta["stride"], tuple(n.meta["out_hw"]))
                  for n in (g.nodes[i] for i in g.topo_order())
                  if n.kind.value == "conv")
    assert len(want) == 20 and got == want
    assert all(c.shape[0] == 256 and c.path == "resnet18_int8" for c in convs)
    assert [c for c in cases if c.kind == "imc_mvm"] == [kb.PortCase(
        "port.imc_mvm.256x256x10", "imc_mvm", (256, 256, 10), "resnet18_int8",
        1)]
    per_request = sum(c.path_launches * kb.bound(
        *kb.conv_work(c.shape), kb.PEAK_INT8_OPS, "PEAK_INT8_OPS")[0]
        for c in convs)
    assert round(per_request, 1) == 122.4


def test_kernel_bench_bf16_flash_bounds():
    """The bf16 bound rule at the served shapes: granite 52.14 µs and
    recurrentgemma 278.0 µs by operations at the bf16 peak, gemma3-1b's
    local layer 19.72 µs by bytes and its global one 39.1 µs by
    operations; a prefill's bound is 32 x 52.14 = 1.668 ms, 12 x 278.0 =
    3.336 ms and 22 x 19.72 + 4 x 39.1 = 0.590 ms."""
    from benchmarks_torch import kernel_bench as kb
    want = [(52.14, "operations", "PEAK_FLOPS"),
            (278.0, "operations", "PEAK_FLOPS"), (19.72, "bytes", "HBM_BW"),
            (39.1, "operations", "PEAK_FLOPS")]
    flash = [c for c in kb.served_cases() if c.kind == "flash_bf16"]
    per_prefill = {}
    for c, (want_us, want_by, want_const) in zip(flash, want, strict=True):
        _, n_bytes, n_ops = kb.flash_bf16_work(*c.shape)
        us, by, const = kb.bound(n_bytes, n_ops, kb.PEAK_FLOPS, "PEAK_FLOPS")
        # the figures as written: to 4 significant digits
        assert (us, by, const) == (pytest.approx(want_us, rel=5e-4),
                                   want_by, want_const)
        per_prefill[c.path] = per_prefill.get(c.path, 0.0) + \
            c.path_launches * us / 1e3
    assert {p: round(ms, 3) for p, ms in per_prefill.items()} == {
        "granite_prefill": 1.668, "recurrentgemma_prefill": 3.336,
        "gemma3_prefill": 0.590}


@pytest.mark.parametrize("S,window", [(1, None), (7, None), (7, 3), (7, 7),
                                      (7, 9), (33, 8)])
def test_flash_bf16_work_counts_the_mask(S, window):
    """The closed-form pairs equal the causal and window mask's count, and
    the bytes count q at H heads and k, v at KV heads in bf16 and the f32
    output."""
    from benchmarks_torch import kernel_bench as kb
    idx = torch.arange(S)
    d = idx[:, None] - idx[None, :]
    mask = (d >= 0) & (d < (window or S + 1))
    pairs, n_bytes, n_ops = kb.flash_bf16_work(2, 6, 3, S, 16, window)
    assert pairs == 2 * 6 * int(mask.sum())
    assert n_bytes == 2 * (2 * 6 * S * 16 + 2 * 2 * 3 * S * 16) \
        + 4 * 2 * 6 * S * 16
    assert n_ops == 4 * 16 * pairs


def test_kernel_bench_path_sum():
    """Σ launches x µs of each column a case has; None where a case has
    no library call; a column no case has is left out; the sum is bound
    by the larger of its summed byte and operation times."""
    from benchmarks_torch import kernel_bench as kb
    P = kb.PortCase
    cases = [P("a", "imc_conv2d", (), "p", 4), P("b", "imc_mvm", (), "p", 1)]
    out = {"a": {"kernel_us": 2.0, "library_us": None, "bound_us": 1.0,
                 "bound": "bytes", "bytes_us": 1.0, "ops_us": 0.25},
           "b": {"kernel_us": 3.0, "library_us": 5.0, "bound_us": 5.0,
                 "bound": "operations", "bytes_us": 0.5, "ops_us": 5.0}}
    assert kb.path_sum(cases, out) == {
        "cases": ["a", "b"], "path_launches": 5, "kernel_us": 11.0,
        "library_us": None, "bound_us": 9.0, "bytes_us": 4.5, "ops_us": 6.0,
        "bound": "operations"}


def test_served_cases_are_the_shared_case_lists():
    """``served_cases`` is ``flash_cases`` of each served prefill and
    ``cnn_cases`` of ResNet-18-CIFAR at batch 256, the case lists that
    ``chip_smoke.py``'s phases 5, 9, 14 and 15 time."""
    from benchmarks_torch import kernel_bench as kb
    from repro_torch.configs import get_config
    from repro_torch.models.cnn import graphs
    want = []
    for arch, S, path in kb.FLASH_SERVED:
        want += kb.flash_cases(get_config(arch), 4, S, path)
    want += kb.cnn_cases(graphs.resnet18_graph(), 256)
    assert kb.served_cases() == want
    small = kb.cnn_cases(graphs.resnet8_graph(), 8, "p")
    assert all(c.path == "p" and c.shape[0] == 8 for c in small)
    assert sum(c.path_launches for c in small if c.kind == "imc_conv2d") == \
        graphs.resnet8_graph().num_nodes(graphs.OpKind.CONV)
