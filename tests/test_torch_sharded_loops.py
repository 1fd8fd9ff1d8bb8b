"""The port's two loops on sharded state, as the reference's take it: the
``Server`` on parameters placed on a mesh, and ``train(..., mesh=)``,
held against the reference's ``Server`` on parameters ``jax.device_put``
on a mesh and its ``train(..., mesh=)``.

The port's side runs on gloo ranks in a subprocess
(``test_torch_sharded_loop_workers.py`` run as a script: one rank on a
(1, 1) mesh, two ranks on a (1, 2) mesh), so no process group
is ever opened in a test worker.  The reference's side runs in this
process on a one-device mesh with ``Auto`` axes (``jax.make_mesh``'s
default ``Explicit`` axes make ``with_sharding_constraint`` fail on jax
0.9).  Both sides start from what this process writes: the reference's
f32 parameters of a two-layer gemma3-1b smoke cut (a checkpoint, which
both packages read), seeded prompts, and the reference loop's step-0
checkpoint of the stablelm smoke model.

Tolerances: greedy tokens equal (the port's whole ``Server`` gives the
reference's on this cut, ``tests/test_torch_prefill_graph.py``; a split
product adds its partial sums in another order, ~1e-7 of an f32 logit);
the loop's losses within ``LOOP_RTOL`` = 1e-3 of the reference's over 4
steps (``tests/test_torch_train_loop.py`` says why); a resume, the graphed
steps under stand-ins and the checkpoint files exact.

Under the stand-ins for the CUDA graph machinery
(``tests/test_torch_prefill_graph.py``'s ``stand_ins``, applied inside the
ranks) the graphed steps take DTensor parameters: one graph a key, the
key separating placements of one shape, static buffers placed as the
step's inputs and outputs, replays equal to the plain sharded steps,
flash launches counted a replay, a replay error raised as ``GraphError``,
other parameters refused; and the sharded prefill, decode and train steps
read no value on the host."""

import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import ShapeSpec as JShapeSpec  # noqa: E402
from repro.models.lm import sharding as jsharding  # noqa: E402
from repro.models.lm import transformer as jtransformer  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.runtime import train_loop as jtrain_loop  # noqa: E402
from repro.runtime.serve_loop import Request as JRequest  # noqa: E402
from repro.runtime.serve_loop import Server as JServer  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.runtime.train_loop import train  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402
from test_torch_sharded_loop_workers import (  # noqa: E402
    FAULT_AT, MAX_NEW, MESHES, OPT, TRAIN_ARCH, TRAIN_SHAPE, TRAIN_STEPS,
    fault_once, load, train_loop_cfg)

ROOT = Path(__file__).resolve().parents[1]
WORKERS = ROOT / "tests" / "test_torch_sharded_loop_workers.py"
MESH_NAMES = [name for meshes in MESHES.values() for name in meshes]
LOOP_RTOL = 1e-3
PROMPT_LENS = (7, 12, 5, 9, 15, 3)


def _auto_mesh():
    """The reference's one-device (data, model) mesh on ``Auto`` axes."""
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _jcut(cfg):
    import dataclasses
    return dataclasses.replace(cfg, segments=tuple(
        dataclasses.replace(s, n=n) for s, n in zip(cfg.segments, (2,))))


def _jloop(path, total):
    return jtrain_loop.TrainLoopConfig(
        total_steps=total, ckpt_every=2, ckpt_dir=str(path), log_every=0,
        opt=jadamw.AdamWConfig(**OPT))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs both sides start from, written under ``in/``, and the
    reference's tokens and losses on its mesh."""
    root = tmp_path_factory.mktemp("sharded_loops")
    jc = _jcut(jget_config("gemma3-1b").smoke())
    jparams = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32),
        jtransformer.init_params(jc, jax.random.PRNGKey(0)))
    ckpt.save(str(root / "in" / "serve"), 0, from_jax_params(jparams, "cpu"))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, jc.vocab, n).astype(np.int32)
               for n in PROMPT_LENS]
    (root / "in" / "prompts.json").write_text(
        json.dumps([p.tolist() for p in prompts]))
    mesh = _auto_mesh()
    placed = jax.device_put(jparams,
                            jsharding.param_shardings(jc, mesh, jparams))

    def serve(at):
        reqs = [JRequest(i, jnp.asarray(p), max_new=MAX_NEW)
                for i, p in enumerate(prompts)]
        stats = JServer(jc, placed, max_batch=2, s_max=32,
                        fault_hook=fault_once(at)).serve(reqs)
        return [r.out_tokens for r in reqs], stats

    tokens, _ = serve(None)
    retry_tokens, retry_stats = serve(FAULT_AT)
    assert retry_stats.retries == 1

    jcfg = jget_config(TRAIN_ARCH).smoke()
    jshape = JShapeSpec(*TRAIN_SHAPE)
    jtrain_loop.train(jcfg, jshape, _jloop(root / "in" / "step0", 0))
    shutil.copytree(root / "in" / "step0", root / "ref")
    want = jtrain_loop.train(jcfg, jshape, _jloop(root / "ref", TRAIN_STEPS),
                             mesh=mesh)
    return {"root": root, "tokens": tokens, "retry_tokens": retry_tokens,
            "losses": want.losses, "resumed_from": want.resumed_from}


@pytest.fixture(scope="module")
def ranks(reference):
    root = reference["root"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="1",
        CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(WORKERS), str(root)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return dict(load(root), root=root)


def test_reference_server_on_its_mesh_gives_its_unsharded_tokens(reference):
    """The parity target is the reference's unsharded answer too: its
    ``Server`` on the one-device mesh gives the tokens of its parameters
    unplaced."""
    jc = _jcut(jget_config("gemma3-1b").smoke())
    jparams = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32),
        jtransformer.init_params(jc, jax.random.PRNGKey(0)))
    prompts = json.loads((reference["root"] / "in" / "prompts.json").read_text())
    reqs = [JRequest(i, jnp.asarray(p, jnp.int32), max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    JServer(jc, jparams, max_batch=2, s_max=32).serve(reqs)
    assert [r.out_tokens for r in reqs] == reference["tokens"]


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_sharded_server_gives_the_reference_tokens(ranks, reference, mesh):
    """``Server`` on DTensor parameters serves (it raised a mixed
    ``torch.Tensor``/DTensor error before the padded tokens were placed)
    and gives the reference server's greedy tokens, three batches of two
    prompts."""
    r = ranks[mesh]["serve"]
    assert r["prefills"] == 3
    assert r["tokens"] == reference["tokens"]


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_sharded_server_retry_gives_the_same_tokens(ranks, reference, mesh):
    """A decode fault at step 1 re-prefills the live prompts with what was
    generated, placed on the mesh: the tokens are unchanged, and the
    reference's under the same fault."""
    r = ranks[mesh]["serve"]
    assert r["retries"] == 0 and r["retry_retries"] == 1
    assert r["retry_prefills"] == 4
    assert r["retry_tokens"] == reference["retry_tokens"] == r["tokens"]


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_sharded_train_matches_the_reference(ranks, reference, mesh):
    """``train(..., mesh=)`` from the reference's step-0 checkpoint: the
    reference's resume point, 4 steps, losses within ``LOOP_RTOL`` of the
    reference's ``train(..., mesh=)``."""
    r = ranks[mesh]["train"]
    assert r["resumed_from"] == reference["resumed_from"] == 0
    assert r["retries"] == r["rollbacks"] == 0
    np.testing.assert_allclose(r["losses"], reference["losses"],
                               rtol=LOOP_RTOL)


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_sharded_resume_gives_the_same_losses(ranks, mesh):
    """Cut at step 2 and resumed from the sharded run's own checkpoint
    (restored onto the mesh), the losses are the uncut run's."""
    r = ranks[mesh]["train"]
    assert r["resume_points"] == [0, 2]
    assert r["resume_losses"] == r["losses"]


def _files(step_dir: Path) -> dict:
    """A checkpoint's bytes: the manifest, and each array's ``.npy``
    entry of the npz (the zip's own entry headers carry the save's
    clock)."""
    with zipfile.ZipFile(step_dir / "arrays.npz") as z:
        files = {name: z.read(name) for name in z.namelist()}
    files["manifest.json"] = (step_dir / "manifest.json").read_bytes()
    return files


@pytest.fixture(scope="module")
def unsharded(reference, tmp_path_factory):
    """The port's unsharded loop: a fresh step 0, and 4 steps from the
    reference's step-0 checkpoint."""
    root = tmp_path_factory.mktemp("unsharded")
    cfg, shape = get_config(TRAIN_ARCH).smoke(), ShapeSpec(*TRAIN_SHAPE)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train(cfg, shape, train_loop_cfg(root / "fresh", 0), device="cpu")
        shutil.copytree(reference["root"] / "in" / "step0", root / "train")
        rep = train(cfg, shape, train_loop_cfg(root / "train", TRAIN_STEPS),
                    device="cpu")
    finally:
        torch.set_num_threads(n)
    return {"root": root, "losses": rep.losses}


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_sharded_checkpoint_files_equal_the_unsharded(ranks, unsharded, mesh):
    """The step-0 checkpoint of a sharded run from the port's own
    initialisation holds the whole tree: its manifest and every array are
    byte-equal to the unsharded run's."""
    got = _files(ranks["root"] / mesh / "fresh" / "step_000000000")
    want = _files(unsharded["root"] / "fresh" / "step_000000000")
    assert got.keys() == want.keys()
    assert all(got[k] == want[k] for k in want)


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_sharded_train_matches_the_unsharded_port(ranks, unsharded, mesh):
    """Against the port's unsharded loop from the same checkpoint the
    sharded loop's losses stay within ``LOOP_RTOL``.  (Not bit for bit,
    even on the (1, 1) mesh: from step 3 the bf16 parameters differ in a
    few hundred elements by one ulp, the gradients' sums running in
    another order.)"""
    np.testing.assert_allclose(ranks[mesh]["train"]["losses"],
                               unsharded["losses"], rtol=LOOP_RTOL)


# ---------------------------------------------------------------------------
# the graphed steps on DTensors, under the stand-ins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_graphed_prefill_on_dtensors(ranks, mesh):
    """One graph a key, and the key holds the placements: the same shape
    placed another way (or whole) keys another graph, a clone the same;
    the static inputs and outputs are DTensors placed as the step's;
    the capture's and a replay's outputs equal the plain sharded step's;
    a replay counts its 3 flash launches; every capture shares one pool;
    a replay error raises ``GraphError``; other parameters are refused
    before anything runs."""
    r = ranks[mesh]["graph"]["prefill"]
    for k in ("key_same_for_clone", "key_separates_placements",
              "key_separates_whole", "other_params_refused",
              "static_inputs_placed", "static_outputs_placed",
              "capture_equal", "replay_equal", "moved_equal"):
        assert r[k] is True, k
    assert r["replays"] == 1 and r["launches_a_replay"] == 3
    assert r["graphs_after_two_placements"] == 2
    assert r["replay_error"] == "GraphError" and r["pools"] == 1


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_graphed_decode_on_dtensors(ranks, mesh):
    """Four decode steps through one graph: each replay's logits and cache
    equal the plain sharded step's, placed as its; a whole token keys
    another graph; a replay error raises ``GraphError``."""
    r = ranks[mesh]["graph"]["decode"]
    assert r["replay_equal"] and r["static_placed"]
    assert r["graphs"] == 1 and r["key_separates_whole"]
    assert r["replay_error"] == "GraphError"


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_graphed_server_on_dtensors_gives_the_plain_tokens(ranks, reference,
                                                           mesh):
    """``Server`` with both steps graphed (three prompt widths, one decode
    graph) gives the plain sharded server's tokens, with and without the
    decode fault (the retry's new width captured too)."""
    r = ranks[mesh]["graph"]["server"]
    assert r["tokens"] == ranks[mesh]["serve"]["tokens"] == reference["tokens"]
    assert r["graphs"] == [3, 1]
    assert r["retry_tokens"] == reference["retry_tokens"]
    assert r["retry_retries"] == 1 and r["retry_graphs"] == [4, 1]


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_graphed_train_on_dtensors(ranks, mesh):
    """``train(..., mesh=)`` through a ``GraphedTrainStep`` whose recording
    is the eager stand-in: one capture for the run, its static state
    placed as ``param_shardings``/``opt_shardings`` place it, the plain
    sharded loop's losses exactly; whole state is refused by a graph with
    a mesh, and sharded state by one without; the key holds the
    placements."""
    r = ranks[mesh]["graph"]["train"]
    assert r["captures"] == 1 and r["static_placed"]
    assert r["losses"] == ranks[mesh]["train"]["losses"]
    assert r["whole_state_refused"] == [True, True]
    assert r["sharded_state_refused_without_mesh"]
    assert r["key_separates_whole"]


@pytest.mark.parametrize("mesh", MESH_NAMES)
def test_sharded_steps_read_no_value_on_the_host(ranks, mesh):
    """The sharded prefill, decode and train steps of gemma3-1b and
    granite-moe (the MoE layer shard by shard) run under a dispatch mode
    and patched conversions that fail on any read of a value on the host:
    nothing in them waits for the card, so a capture records each whole."""
    r = ranks[mesh]["graph"]["host_reads"]
    assert r == {arch: ["prefill", "decode", "train"]
                 for arch in ("gemma3-1b", "granite-moe-3b-a800m")}
