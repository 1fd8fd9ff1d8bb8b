"""``BENCHMARK.json`` keeps to the benchmark's contract, and names only
parts that exist under ``imc_bench/``."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(map(_line, BENCH["command"]))
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("imc_bench/") and c["file"] not in files
        files.add(c["file"])
        assert c["reduced"] == []
        assert (ROOT / c["file"]).is_file()
        for part in ("configs", "reference"):
            assert (ROOT / "imc_bench" / part / f"{c['name']}.py").is_file()


def test_workloads():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (ROOT / "imc_bench" / "traffic" / f"{w['traffic']}.json").is_file()


def _cells(metric):
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_metrics():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert _line(m["layer"]) and m["moves"] in e2e
        # every cell of the metric reports what it moves
        assert set(_cells(m)) <= set(_cells(e2e[m["moves"]]))
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(_cells(m)) <= cells
        stem = m["name"].split(".")[0]
        assert any((ROOT / "imc_bench" / "metrics" / f"{n}.py").is_file()
                   for n in (m["name"], stem))
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if w["name"] in _cells(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in _cells(m) for m in BENCH["per_layer"])


def test_kernel_rooflines_have_a_whole_step_share_beside_them():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in n["name"] and n["moves"] == m["moves"]
                       and set(_cells(m)) <= set(_cells(n))
                       for n in BENCH["per_layer"])
