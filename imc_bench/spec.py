"""Find a cell's parts by the names ``BENCHMARK.json`` gives them."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, NamedTuple

BENCH_DIR = "imc_bench"


def load_module(path: Path) -> ModuleType:
    """The Python file ``path`` as a module of its own (its name need not
    be an identifier)."""
    if not path.is_file():
        raise FileNotFoundError(f"no module {path}")
    spec = importlib.util.spec_from_file_location(
        "imc_bench._loaded." + path.stem.replace("-", "_").replace(".", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict            # the configuration's file
    port: ModuleType        # configs/<config>.py: the port's request
    reference: ModuleType   # reference/<config>.py
    traffic: Dict           # traffic/<mix>.json
    end_to_end: List[Dict]  # the metric entries this cell reports
    per_layer: List[Dict]


def _applies(metric: Dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(root: Path, workload: str) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``, with its
    configuration, traffic and metric entries loaded."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        names = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json ({names})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    base = root / BENCH_DIR
    return Cell(
        workload, entry["chips"],
        json.loads((root / conf["file"]).read_text()),
        load_module(base / "configs" / f"{conf['name']}.py"),
        load_module(base / "reference" / f"{conf['name']}.py"),
        json.loads((base / "traffic" / f"{entry['traffic']}.json").read_text()),
        [m for m in bench["end_to_end"] if _applies(m, workload)],
        [m for m in bench["per_layer"] if _applies(m, workload)])


def reader(root: Path, metric: str) -> Callable:
    """The ``read(run)`` of ``metrics/<metric>.py``, or, for a name
    ``<stem>.<part>`` with no file of its own, of ``metrics/<stem>.py``."""
    base = root / BENCH_DIR / "metrics"
    path = base / f"{metric}.py"
    if not path.is_file():
        path = base / f"{metric.split('.')[0]}.py"
    return load_module(path).read
