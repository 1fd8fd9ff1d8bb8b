"""The training loop's step as one captured program
(``runtime.train_loop.GraphedTrainStep``, the port's counterpart of the
reference's ``jax.jit`` of the step), on the CPU.

The CPU has no CUDA graphs: ``train()`` runs the plain step there, and
``GraphedTrainStep`` refuses parameters off the card.  What a capture
records is ``step_and_commit`` over static buffers; these tests run that
body eagerly and hold it to the plain step's bits, check that the plain
step reads no value on the host (a capture cannot), and drive ``train()``
through a ``GraphedTrainStep`` whose recording is replaced by an eager
stand-in (``EagerGraphed``: keys, refusals, copy-in and the loop's
retry, rollback and ``GraphError`` handling are the class's own), held
to the plain loop bit for bit and to the reference's loop within
``tests/test_torch_train_loop.py``'s ``LOOP_RTOL``.  They also rehearse
``chip_smoke.py`` phase 12's fault runs."""

import math
import shutil
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import ShapeSpec, get_config  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.models.lm import model, transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.runtime.serve_loop import GraphError  # noqa: E402
from repro_torch.runtime.train_loop import (  # noqa: E402
    GraphedTrainStep, TrainLoopConfig, step_and_commit, train)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = get_config("stablelm-1.6b").smoke()
SHAPE = ShapeSpec("rt-train", 32, 8, "train")
CPU = "cpu"
OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100)
TCFG = model.TrainStepConfig(opt=OPT)
LOOP_RTOL = 1e-3       # tests/test_torch_train_loop.py's, and why


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: many small ops in several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop(path, total=6):
    return TrainLoopConfig(total_steps=total, ckpt_every=2,
                           ckpt_dir=str(path), log_every=0, opt=OPT)


def _state(cfg=SMOKE):
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device=CPU)
    return params, adamw.init(params)


def _leaves(params, opt_state, metrics):
    return tree_leaves((params, opt_state, metrics["loss"]))


class _EagerGraph:
    """What a replay of the captured program does, run eagerly:
    ``step_and_commit`` over the static buffers, its metrics written into
    the static metrics."""

    def __init__(self, step, static, metrics):
        self.step, self.static, self.metrics = step, static, metrics

    def replay(self):
        for k, v in step_and_commit(self.step, *self.static).items():
            self.metrics[k].copy_(v)


def _eager_record(self, params, opt_state, batch):
    """``GraphedTrainStep._record`` on the CPU: the warm-up commits into
    the static buffers as on the card; the "graph" is an ``_EagerGraph``."""
    metrics = tree_map(torch.clone,
                       step_and_commit(self.step, params, opt_state, batch))
    return _EagerGraph(self.step, (params, opt_state, batch), metrics), metrics


class EagerGraphed(GraphedTrainStep):
    _record = _eager_record


def _graphed_train(monkeypatch, *args, **kwargs):
    """``train(*args, **kwargs)`` on the CPU through an ``EagerGraphed``
    step; the run must have captured its one graph."""
    with monkeypatch.context() as m:
        m.setattr(train_loop, "step_for_device",
                  lambda cfg, tcfg, device: EagerGraphed(cfg, tcfg))
        rep = train(*args, device=CPU, **kwargs)
    assert len(rep.capture_seconds) == 1
    return rep


def _same(a, b):
    """Equal loss lists, NaN where NaN."""
    return len(a) == len(b) and all(
        x == y or (math.isnan(x) and math.isnan(y)) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the CPU keeps the plain step
# ---------------------------------------------------------------------------

def test_train_on_the_cpu_keeps_the_plain_step(tmp_path, monkeypatch):
    step = train_loop.step_for_device(SMOKE, TCFG, CPU)
    assert not isinstance(step, GraphedTrainStep)

    def refused(*a, **k):
        raise AssertionError("a graph was made on the CPU")

    monkeypatch.setattr(GraphedTrainStep, "__init__", refused)
    rep = train(SMOKE, SHAPE, _loop(tmp_path, 2), device=CPU)
    assert rep.final_step == 2 and rep.capture_seconds == []


# ---------------------------------------------------------------------------
# the step reads nothing on the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [8, 4], ids=["one_slice", "two_slices"])
def test_plain_step_reads_no_value_on_the_host(microbatch, monkeypatch):
    """A captured step cannot read a tensor's value on the host: the plain
    step (remat on) runs with ``item``, ``tolist`` and the conversions to
    Python numbers and bools made to raise."""
    assert SMOKE.remat and SHAPE.global_batch // microbatch in (1, 2)
    step = model.make_train_step(SMOKE, TCFG, microbatch=microbatch)
    params, opt_state = _state()
    batch = make_batch(SMOKE, SHAPE, 0, device=CPU)

    def host_read(*a, **k):
        raise AssertionError("the train step read a value on the host")

    with monkeypatch.context() as m:
        for name in ("item", "tolist", "__float__", "__int__", "__bool__"):
            m.setattr(torch.Tensor, name, host_read)
        new_params, new_opt, metrics = step(params, opt_state, batch)
    assert math.isfinite(float(metrics["loss"]))
    assert int(new_opt.step) == 1


# ---------------------------------------------------------------------------
# the captured body, run eagerly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [8, 4], ids=["one_slice", "two_slices"])
def test_captured_body_gives_the_plain_steps_bits(microbatch):
    """``step_and_commit`` over static copies, the batch copied in each
    step, gives the plain step's loss, parameters, moments and step
    counter bit for bit over 3 steps."""
    step = model.make_train_step(SMOKE, TCFG, microbatch=microbatch)
    params, opt_state = _state()
    static = tree_map(torch.clone, (params, opt_state,
                                    make_batch(SMOKE, SHAPE, 0, device=CPU)))
    for i in range(3):
        batch = make_batch(SMOKE, SHAPE, i, device=CPU)
        params, opt_state, metrics = step(params, opt_state, batch)
        for dst, src in zip(tree_leaves(static[2]), tree_leaves(batch)):
            dst.copy_(src)
        got = step_and_commit(step, *static)
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(*static[:2], got), _leaves(params, opt_state, metrics),
            strict=True))
    assert int(static[1].step) == 3


# ---------------------------------------------------------------------------
# keys and refusals
# ---------------------------------------------------------------------------

def test_graphed_train_step_keys_on_shapes_and_refuses_others():
    """A graph for each (batch, parameter, state) shape, as jit's cache is
    keyed; parameters of another model's shapes are refused, and so are
    parameters off the card (both before anything would run on one)."""
    params, opt_state = _state()
    batch = make_batch(SMOKE, SHAPE, 0, device=CPU)
    key = GraphedTrainStep.key
    assert key(params, opt_state, batch) == key(
        *tree_map(torch.clone, (params, opt_state, batch)))
    wider = make_batch(SMOKE, ShapeSpec("w", 48, 8, "train"), 0, device=CPU)
    assert key(params, opt_state, batch) != key(params, opt_state, wider)
    graphed = GraphedTrainStep(SMOKE, TCFG)
    other, other_opt = _state(get_config("gemma3-1b").smoke())
    with pytest.raises(ValueError, match="other shapes"):
        graphed.capture(other, other_opt, batch)
    narrow = tree_map(lambda t: t[..., :1], params)
    with pytest.raises(ValueError, match="other shapes"):
        graphed.capture(narrow, opt_state, batch)
    with pytest.raises(ValueError, match="on the card"):
        graphed(params, opt_state, batch)
    assert graphed.graphs == {}


def test_eager_stand_in_keeps_one_graph_and_copies_in_only_new_state():
    """One capture a key; a call copies the parameters and state in unless
    they are the static ones the last call returned."""
    graphed = EagerGraphed(SMOKE, TCFG)
    params, opt_state = _state()
    batch = make_batch(SMOKE, SHAPE, 0, device=CPU)
    p, o, _ = graphed(params, opt_state, batch)
    g = next(iter(graphed.graphs.values()))
    assert p is g.params and o is g.opt
    p2, o2, m = graphed(p, o, batch)
    assert p2 is p and len(graphed.graphs) == 1
    assert int(o2.step) == 2
    # a restore: new tensors are copied over the static ones
    p3, o3, m3 = graphed(params, opt_state, batch)
    assert int(o3.step) == 1
    assert len(graphed.capture_seconds) == 1


# ---------------------------------------------------------------------------
# train() through the graphed step
# ---------------------------------------------------------------------------

def test_graph_error_ends_the_run_without_retry_or_checkpoint(tmp_path,
                                                              monkeypatch):
    """A step that raises ``GraphError`` (a failed replay) is not retried
    and writes no checkpoint: the newest is the last committed one."""
    real = model.make_train_step
    calls = []

    def failing(*a, **k):
        step = real(*a, **k)

        def stand_in(params, opt_state, batch):
            calls.append(int(opt_state.step))
            if len(calls) == 4:
                raise GraphError("replay failed")
            return step(params, opt_state, batch)
        return stand_in

    monkeypatch.setattr(model, "make_train_step", failing)
    with pytest.raises(GraphError, match="replay failed"):
        train(SMOKE, SHAPE, _loop(tmp_path), device=CPU)
    assert calls == [0, 1, 2, 3]
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_graphed_loop_gives_the_plain_loops_losses(tmp_path, monkeypatch):
    """Through the graphed step the loop's losses, checkpoints and resume
    are the plain loop's bit for bit."""
    plain = train(SMOKE, SHAPE, _loop(tmp_path / "plain"), device=CPU)
    graphed = _graphed_train(monkeypatch, SMOKE, SHAPE,
                             _loop(tmp_path / "graph", 4))
    resumed = _graphed_train(monkeypatch, SMOKE, SHAPE, _loop(tmp_path / "graph"))
    assert resumed.resumed_from == 4
    assert graphed.losses + resumed.losses == plain.losses
    like = {"params": _state()[0], "opt": _state()[1]}
    _, a, _ = ckpt.restore_latest(str(tmp_path / "plain"), like, CPU)
    _, b, _ = ckpt.restore_latest(str(tmp_path / "graph"), like, CPU)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_graphed_loop_retries_a_fault_before_the_replay(tmp_path, monkeypatch):
    """A fault-hook error before the replay leaves the static state as it
    was: 1 retry, and the fault-free run's losses."""
    plain = train(SMOKE, SHAPE, _loop(tmp_path / "plain"), device=CPU)
    fails = []

    def hook(step):
        if step == 3 and not fails:
            fails.append(step)
            raise RuntimeError("injected device failure")

    rep = _graphed_train(monkeypatch, SMOKE, SHAPE, _loop(tmp_path / "graph"),
                         fault_hook=hook)
    assert rep.retries == 1 and rep.rollbacks == 0
    assert rep.losses == plain.losses


def test_graphed_loop_persistent_fault_saves_the_committed_state(
        tmp_path, monkeypatch):
    """A fault that persists past ``max_retries`` saves the state the last
    replay committed (that of step 3) before it re-raises."""
    def hook(step):
        if step == 3:
            raise RuntimeError("dead node")

    with pytest.raises(RuntimeError, match="dead node"):
        _graphed_train(monkeypatch, SMOKE, SHAPE, _loop(tmp_path / "graph"),
                       fault_hook=hook)
    assert ckpt.latest_step(str(tmp_path / "graph")) == 3
    train(SMOKE, SHAPE, _loop(tmp_path / "plain", 3), device=CPU)
    like = {"params": _state()[0], "opt": _state()[1]}
    a, _ = ckpt.restore(str(tmp_path / "plain"), 3, like, CPU)
    b, _ = ckpt.restore(str(tmp_path / "graph"), 3, like, CPU)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def test_graphed_loop_rolls_back_through_the_static_buffers(tmp_path,
                                                            monkeypatch):
    """A NaN read by the graph at step 3 (its static embedding table
    poisoned after the copy-in) commits a non-finite state; the loop
    counts a rollback, records NaN and restores the step-2 checkpoint,
    which the next call copies in: every later loss is the plain loop's
    under the same NaN (``model.loss_fn`` made NaN at step 3)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    monkeypatch.setattr(GraphedTrainStep, "_record", _eager_record)
    make = chip_smoke.nan_graph(3)
    monkeypatch.setattr(train_loop, "step_for_device",
                        lambda cfg, tcfg, device: make(cfg, tcfg))
    rep = train(SMOKE, SHAPE, _loop(tmp_path / "graph"), device=CPU)
    graph = make.made[-1]
    assert rep.rollbacks == 1 and rep.retries == 0
    assert [c for c, _ in graph.loaded] == [0, 4]
    like = {"params": _state()[0], "opt": _state()[1]}
    disk, _ = ckpt.restore(str(tmp_path / "graph"), 2, like, CPU)
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(graph.loaded[-1][1]),
        tree_leaves((disk["params"], disk["opt"])), strict=True))

    loss_fn = model.loss_fn
    calls = []
    per_step = SHAPE.global_batch // SMOKE.microbatch

    def nan_at_step_3(cfg, params, batch):
        calls.append(1)
        loss = loss_fn(cfg, params, batch)
        return loss * float("nan") if len(calls) == 3 * per_step + 1 else loss

    monkeypatch.undo()
    monkeypatch.setattr(model, "loss_fn", nan_at_step_3)
    plain = train(SMOKE, SHAPE, _loop(tmp_path / "plain"), device=CPU)
    assert plain.rollbacks == 1
    assert _same(rep.losses, plain.losses) and math.isnan(rep.losses[3])


def test_graphed_loop_without_a_checkpoint_to_restore_raises(tmp_path,
                                                             monkeypatch):
    """The replay has committed the non-finite step over the state: with
    no checkpoint to roll back to, the run ends (the plain loop would go
    on from the state before the step)."""
    monkeypatch.setattr(ckpt, "restore_latest", lambda *a, **k: None)
    real = model.loss_fn
    monkeypatch.setattr(model, "loss_fn", lambda *a: real(*a) * float("nan"))
    with monkeypatch.context() as m:
        m.setattr(train_loop, "step_for_device",
                  lambda cfg, tcfg, device: EagerGraphed(cfg, tcfg))
        with pytest.raises(FloatingPointError, match="non-finite loss at 0"):
            train(SMOKE, SHAPE, _loop(tmp_path), device=CPU)
    plain = train(SMOKE, SHAPE, _loop(tmp_path / "plain", 2), device=CPU)
    assert plain.rollbacks == 2


def test_graphed_loop_matches_the_reference_from_its_step0_checkpoint(
        tmp_path, monkeypatch):
    """The reference's ``train(total_steps=0)`` writes its step-0
    checkpoint; the reference's loop and the port's through the graphed
    step each resume from a copy and run 4 steps: equal resume points,
    losses within ``LOOP_RTOL``."""
    pytest.importorskip("jax")
    from repro.configs import get_config as jget_config
    from repro.configs.base import ShapeSpec as JShapeSpec
    from repro.optim import adamw as jadamw
    from repro.runtime import train_loop as jtrain_loop
    jcfg = jget_config("stablelm-1.6b").smoke()
    jshape = JShapeSpec("rt-train", 32, 8, "train")

    def jloop(path, total):
        return jtrain_loop.TrainLoopConfig(
            total_steps=total, ckpt_every=2, ckpt_dir=str(path), log_every=0,
            opt=jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100))

    jtrain_loop.train(jcfg, jshape, jloop(tmp_path / "step0", 0))
    for name in ("ref", "port"):
        shutil.copytree(tmp_path / "step0", tmp_path / name)
    want = jtrain_loop.train(jcfg, jshape, jloop(tmp_path / "ref", 4))
    got = _graphed_train(monkeypatch, SMOKE, SHAPE, _loop(tmp_path / "port", 4))
    assert got.resumed_from == want.resumed_from == 0
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOOP_RTOL)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 12's fault runs, rehearsed
# ---------------------------------------------------------------------------

def test_chip_smoke_fault_runs_rehearsed_on_the_cpu(tmp_path, monkeypatch):
    """Phase 12's retry and NaN runs on the smoke model, the NaN run's
    graph an ``EagerGraphed`` (the retry run takes the CPU's plain step),
    and the plain loop's timing run."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    monkeypatch.setattr(GraphedTrainStep, "_record", _eager_record)
    full = train(SMOKE, SHAPE, _loop(tmp_path / "full", 10), device=CPU)
    rec = chip_smoke.train_fault_runs(SMOKE, CPU, SHAPE, 2, OPT, tmp_path,
                                      full.losses, n=8, at=5)
    assert rec["retry"] == {"retries": 1, "losses_equal": True}
    assert rec["nan"]["restored_step"] == 4 and rec["nan"]["restored_equal"]
    assert rec["nan"]["copied_in_at_call"] == 6
    plain = chip_smoke.train_plain_loop(SMOKE, CPU, SHAPE, 2, OPT, tmp_path,
                                        n=4)
    assert plain["steps"] == 4 and plain["step_s_median"] > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == ["full"]


def test_chip_smoke_fault_runs_fail_when_they_should(tmp_path, monkeypatch):
    """The NaN gate is live: a graph that does not copy a restored state
    in leaves the poisoned state in place, and the run fails."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    monkeypatch.setattr(GraphedTrainStep, "_record", _eager_record)
    real = GraphedTrainStep.load

    def batch_only(self, g, params, opt_state, batch):
        if not self.loaded:
            return real(self, g, params, opt_state, batch)
        for dst, src in zip(tree_leaves(g.batch), tree_leaves(batch)):
            dst.copy_(src)

    monkeypatch.setattr(GraphedTrainStep, "load", batch_only)
    full = train(SMOKE, SHAPE, _loop(tmp_path / "full", 10), device=CPU)
    with pytest.raises(AssertionError, match="NaN run"):
        chip_smoke.train_fault_runs(SMOKE, CPU, SHAPE, 2, OPT, tmp_path,
                                    full.losses, n=8, at=5)


def test_chip_smoke_graph_gate_compares_every_part():
    """``max_diffs`` over (params, state, metrics) triples: equal parts
    and the largest |d| of a part that differs."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    params, opt_state = _state()
    metrics = {"loss": torch.tensor(1.0)}
    a = (params, opt_state, metrics)
    b = (tree_map(torch.clone, params),
         opt_state._replace(m=tree_map(lambda t: t + 0.5, opt_state.m)),
         {"loss": torch.tensor(1.25)})
    d = chip_smoke.max_diffs(a, b)
    assert d["params"] == {"equal": True, "max_d": 0.0}
    assert d["m"] == {"equal": False, "max_d": 0.5}
    assert d["loss"] == {"equal": False, "max_d": 0.25}
    assert d["v"]["equal"] and d["step"]["equal"]
