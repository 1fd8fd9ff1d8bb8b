"""The port stands alone: no file of ``src/repro_torch/`` nor
``chip_smoke.py`` imports ``jax`` or anything of ``repro``; its entry
points default to the card; and ``chip_smoke.py`` fails, printing no
result, where there is no card or no repository around it."""

import ast
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"graph.py", "quant.py", "executor.py", "ops.py", "ref.py",
            "imc_mvm.py", "conv2d.py", "_build.py", "weights.py",
            "chip_smoke.py", "flash_attention.py", "attention.py",
            "transformer.py", "serve_loop.py", "cost.py", "simcontext.py",
            "simulator.py", "_sim_reference.py", "metrics.py", "base.py",
            "lblp.py", "wb.py", "rr.py", "rd.py", "heft.py", "lblp_x.py",
            "optimal.py", "lblp_mt.py", "lblp_r.py", "elastic.py",
            "serving.py", "pipeline_partition.py", "yolo.py", "tree.py",
            "adamw.py", "compression.py", "pipeline.py", "ckpt.py",
            "train_loop.py", "straggler.py", "model.py"} <= names


CORE_FILES = sorted((ROOT / "src" / "repro_torch" / "core").rglob("*.py"))


@pytest.mark.parametrize("path", CORE_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in CORE_FILES])
def test_core_is_plain_python(path):
    """The scheduler and simulator hold no tensors and take no device:
    ``repro_torch.core`` imports the standard library (and numpy, which
    the simulator's optional vectorised path uses) and nothing else."""
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top in sys.stdlib_module_names or top == "numpy", \
            f"{path}: imports {mod}"


def test_core_exports_the_reference_core():
    import repro.core as jcore
    import repro_torch.core as core
    assert set(jcore.__all__) <= set(core.__all__)
    for name in core.__all__:
        assert hasattr(core, name), name


def test_entry_points_default_to_cuda():
    from repro_torch import weights
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import DataIterator, make_batch
    from repro_torch.models.cnn import layers, resnet
    from repro_torch.models.lm import attention, mlp, model, transformer
    from repro_torch.runtime.straggler import DeadlineDataIterator
    from repro_torch.runtime.train_loop import train
    for fn in (resnet.init, weights.from_jax_params, layers.conv_init,
               layers.dense_init, transformer.init_params, transformer.init_segment,
               transformer.init_block, attention.init, attention.init_cache,
               mlp.init_gated, mlp.init_plain, mlp.normal, train, make_batch,
               DataIterator, model.synth_batch, DeadlineDataIterator,
               ckpt.restore, ckpt.restore_latest):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn


def test_server_and_attention_follow_their_tensors():
    """``Server`` has no device of its own: it serves where the parameters
    are (the card, by ``init_params``' default).  ``ops.attention`` takes
    the plain path only for CPU tensors: any other device goes to the
    kernel's wrapper, which launches on CUDA tensors or raises."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.lm import transformer
    from repro_torch.runtime.serve_loop import Server
    cfg = get_config("gemma3-1b").smoke()
    params = transformer.init_params(cfg, torch.Generator(), device="meta")
    assert Server(cfg, params).device == torch.device("meta")
    q = torch.empty((1, 1, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, q, q)


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    res = _run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
