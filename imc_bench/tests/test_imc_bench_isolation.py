"""The benchmark imports neither JAX nor the JAX package nor the old
benchmark folders, its reference imports nothing of the port, and a run
without a card, or without the port beside it, prints no result."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from imc_bench.run import FORBIDDEN, forbidden_loaded

ROOT = Path(__file__).resolve().parents[2]
FILES = sorted((ROOT / "imc_bench").rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_forbidden_import(path):
    for mod in _imports(path):
        assert mod.split(".")[0] not in FORBIDDEN, f"{path}: imports {mod}"


@pytest.mark.parametrize("path", sorted((ROOT / "imc_bench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    for mod in _imports(path):
        assert mod.split(".")[0] in ("torch", "math", "typing", "imc_bench",
                                     "__future__"), f"{path}: imports {mod}"
        assert mod not in ("imc_bench.configs",)


def test_top_level_names_are_compared_whole():
    assert forbidden_loaded({"repro_torch": 1, "repro_torch.kernels": 1,
                             "benchmarks_torchx": 1, "jaxtyping": 1}) == []
    assert forbidden_loaded({"repro.core": 1, "jaxlib.xla": 1, "flax": 1,
                             "benchmarks_torch.spread": 1}) == \
        ["benchmarks_torch", "flax", "jaxlib", "repro"]


def _run(cwd, env_extra=None):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(cwd),
           "PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run(
        [sys.executable, "-m", "imc_bench.run", "--workload",
         "resnet18-int8.frame", "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=120)


def _has_result(stdout):
    lines = stdout.strip().splitlines()
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except ValueError:
        return False


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode != 0 and not _has_result(p.stdout)
    assert "CUDA" in p.stderr


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(ROOT / "imc_bench", tmp_path / "imc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0 and not _has_result(p.stdout)
