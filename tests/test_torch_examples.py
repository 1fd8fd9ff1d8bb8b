"""The port's examples (``examples/torch/``) run on the CPU, each in a
subprocess that must exit 0 without importing ``jax``.  Where the
reference's example prints deterministic simulator numbers (quickstart,
elastic_reschedule, replicate_bottleneck, serve_two_models,
serve_with_slos), the port's stdout equals the reference's.

``train_lm.py`` trains a ~100M model for 300 steps, which is work for the
card: here its ``main`` runs with the model cut to 2 layers of width 128
and a 1e-2 learning rate (at the example's 3e-4 a small model's bf16
weights move by less than an ulp), for 24 steps, and must report a lower
loss, as the example asserts."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SIM_EXAMPLES = ["quickstart", "elastic_reschedule", "replicate_bottleneck",
                "serve_two_models", "serve_with_slos"]

_RUN = """
import runpy, sys
path = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(path, run_name="__main__")
assert "jax" not in sys.modules, "the example imported jax"
"""

_TRAIN = """
import dataclasses, importlib.util, sys
path = sys.argv[1]
spec = importlib.util.spec_from_file_location("train_lm", path)
ex = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ex)
from repro_torch.configs.base import Segment
full = ex.make_100m_config
ex.make_100m_config = lambda: dataclasses.replace(
    full(), d_model=128, n_heads=4, n_kv_heads=4, head_dim=32, d_ff=256,
    vocab=512, segments=(Segment("attn", 2),))
real = ex.adamw.AdamWConfig
ex.adamw = type("adamw", (), {"AdamWConfig": staticmethod(
    lambda **kw: real(**dict(kw, lr=1e-2)))})
sys.argv = sys.argv[1:]
ex.main()
assert "jax" not in sys.modules, "the example imported jax"
"""


def _run(code, path, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code, str(path), *args],
                         env=env, capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


_RUN_ALL = """
import contextlib, io, json, runpy, sys
out = {}
for path in sys.argv[1:]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(path, run_name="__main__")
    out[path] = buf.getvalue()
print(json.dumps({"jax": "jax" in sys.modules, "out": out}))
"""


def _run_all(folder):
    import json
    paths = [str(ROOT / folder / f"{n}.py") for n in SIM_EXAMPLES]
    res = json.loads(_run(_RUN_ALL, *paths).splitlines()[-1])
    return res["jax"], {Path(p).stem: o for p, o in res["out"].items()}


@pytest.fixture(scope="module")
def sim_outputs():
    """Every simulator example's stdout, the port's (one subprocess) and
    the reference's (another)."""
    return _run_all("examples/torch"), _run_all("examples")


@pytest.mark.parametrize("name", SIM_EXAMPLES)
def test_simulator_example_prints_the_references_numbers(sim_outputs, name):
    (port_jax, port), (_, ref) = sim_outputs
    assert not port_jax, "a port example imported jax"
    assert port[name] == ref[name]
    assert port[name].strip()


def test_schedule_and_run_cnn_on_cpu():
    out = _run(_RUN, ROOT / "examples" / "torch" / "schedule_and_run_cnn.py",
               "--device", "cpu")
    assert "float graph == reference model: exact" in out
    assert "simulated rate" in out and "INT8 top-1 agreement" in out


def test_serve_lm_on_cpu():
    out = _run(_RUN, ROOT / "examples" / "torch" / "serve_lm.py",
               "--device", "cpu")
    assert out.startswith("served 10 requests, 80 new tokens")


def test_train_lm_on_cpu(tmp_path):
    out = _run(_TRAIN, ROOT / "examples" / "torch" / "train_lm.py",
               "--steps", "24", "--batch", "8", "--seq", "32", "--device",
               "cpu", "--ckpt-dir", str(tmp_path / "ckpt"))
    assert "OK: loss decreased on the synthetic stream" in out


def test_examples_are_the_references():
    names = {p.stem for p in (ROOT / "examples").glob("*.py")}
    assert names == {p.stem for p in (ROOT / "examples" / "torch").glob("*.py")}
