"""The port's runtime tier for training, on the CPU: every case of the
reference's ``tests/test_runtime.py`` classes ``TestCheckpoint``,
``TestData``, ``TestTrainLoop``, ``TestStraggler`` and ``TestCompression``
run on the port, a NaN rollback, and the loop against the reference's:
both resume from the reference's step-0 checkpoint and run 4 steps.

Loop parity tolerance: both loops train bf16 parameters, whose gradients
differ between the packages by up to 2.2e-2 of a leaf's max |g|
(``tests/test_torch_train.py``); an AdamW step moves a parameter by about
lr per step whatever |g|, so where a small gradient's sign differs a
parameter moves the other way.  Over 4 steps the losses stay within
``LOOP_RTOL`` = 1e-3 of the reference's (measured: at most 7.1e-5)."""

import os
import shutil

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np

from repro.runtime import train_loop as jtrain_loop
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data.pipeline import DataConfig, DataIterator, make_batch
from repro_torch.models.lm import model, transformer
from repro_torch.optim import adamw, compression
from repro_torch.runtime.straggler import DeadlineDataIterator, StragglerPolicy
from repro_torch.runtime.train_loop import TrainLoopConfig, train
from repro_torch.tree import tree_leaves

SMOKE = get_config("stablelm-1.6b").smoke()
TRAIN_SHAPE = ShapeSpec("rt-train", 32, 8, "train")
CPU = "cpu"
LOOP_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these steps run many small ops, and with the
    default one thread per core in each of several test workers, the
    workers' spinning threads slow each other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                "b": [torch.ones((4,), dtype=torch.bfloat16),
                      {"c": torch.tensor(3, dtype=torch.int32)}]}
        ckpt.save(str(tmp_path), 5, tree, extras={"note": "x"})
        out, extras = ckpt.restore(str(tmp_path), 5, tree, device=CPU)
        assert extras["note"] == "x"
        for a, b in zip(tree_leaves(tree), tree_leaves(out)):
            assert torch.equal(a, b)
            assert a.dtype == b.dtype

    def test_latest_ignores_uncommitted(self, tmp_path):
        tree = {"a": torch.zeros(2)}
        ckpt.save(str(tmp_path), 1, tree)
        ckpt.save(str(tmp_path), 2, tree)
        # fake a torn write: directory without COMMITTED marker
        os.makedirs(tmp_path / "step_000000003")
        assert ckpt.latest_step(str(tmp_path)) == 2

    def test_prune_keeps_newest(self, tmp_path):
        tree = {"a": torch.zeros(2)}
        for s in (1, 2, 3, 4):
            ckpt.save(str(tmp_path), s, tree)
        ckpt.prune(str(tmp_path), keep=2)
        assert ckpt.latest_step(str(tmp_path)) == 4
        assert ckpt.restore_latest(str(tmp_path), tree, device=CPU) is not None
        assert not os.path.exists(tmp_path / "step_000000001")

    def test_shape_mismatch_rejected(self, tmp_path):
        ckpt.save(str(tmp_path), 1, {"a": torch.zeros((2, 2))})
        with pytest.raises(ValueError):
            ckpt.restore(str(tmp_path), 1, {"a": torch.zeros((3,))}, device=CPU)


class TestData:
    def test_deterministic_per_step(self):
        b1 = make_batch(SMOKE, TRAIN_SHAPE, 7, device=CPU)
        b2 = make_batch(SMOKE, TRAIN_SHAPE, 7, device=CPU)
        assert torch.equal(b1["tokens"], b2["tokens"])
        b3 = make_batch(SMOKE, TRAIN_SHAPE, 8, device=CPU)
        assert not torch.equal(b1["tokens"], b3["tokens"])

    def test_resume_replays_stream(self):
        it1 = DataIterator(SMOKE, TRAIN_SHAPE, start_step=0, device=CPU)
        seen = [next(it1)["tokens"] for _ in range(5)]
        it2 = DataIterator(SMOKE, TRAIN_SHAPE, start_step=3, device=CPU)
        assert torch.equal(next(it2)["tokens"], seen[3])

    def test_host_sharding_disjoint(self):
        d0 = DataConfig(num_hosts=2, host_id=0)
        d1 = DataConfig(num_hosts=2, host_id=1)
        b0 = make_batch(SMOKE, TRAIN_SHAPE, 0, d0, device=CPU)
        b1 = make_batch(SMOKE, TRAIN_SHAPE, 0, d1, device=CPU)
        assert b0["tokens"].shape[0] == TRAIN_SHAPE.global_batch // 2
        assert not torch.equal(b0["tokens"], b1["tokens"])

    def test_tokens_in_vocab(self):
        b = make_batch(SMOKE, TRAIN_SHAPE, 0, device=CPU)
        assert int(b["tokens"].max()) < SMOKE.vocab
        assert int(b["tokens"].min()) >= 0


def _loop_cfg(tmp_path, total=6):
    return TrainLoopConfig(
        total_steps=total, ckpt_every=2, ckpt_dir=str(tmp_path),
        log_every=0,
        opt=adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=100))


class TestTrainLoop:
    def test_runs_and_checkpoints(self, tmp_path):
        rep = train(SMOKE, TRAIN_SHAPE, _loop_cfg(tmp_path), device=CPU)
        assert rep.final_step == 6
        assert ckpt.latest_step(str(tmp_path)) == 6
        assert all(np.isfinite(rep.losses))

    def test_resume_after_interruption(self, tmp_path):
        train(SMOKE, TRAIN_SHAPE, _loop_cfg(tmp_path, total=4), device=CPU)
        rep = train(SMOKE, TRAIN_SHAPE, _loop_cfg(tmp_path, total=8), device=CPU)
        assert rep.resumed_from == 4
        assert rep.steps_run == 4
        assert rep.final_step == 8

    def test_transient_fault_retried(self, tmp_path):
        fails = {"left": 2}

        def hook(step):
            if step == 2 and fails["left"] > 0:
                fails["left"] -= 1
                raise RuntimeError("injected device failure")

        rep = train(SMOKE, TRAIN_SHAPE, _loop_cfg(tmp_path), fault_hook=hook,
                    device=CPU)
        assert rep.retries == 2
        assert rep.final_step == 6

    def test_persistent_fault_leaves_consistent_ckpt(self, tmp_path):
        def hook(step):
            if step == 3:
                raise RuntimeError("dead node")

        with pytest.raises(RuntimeError):
            train(SMOKE, TRAIN_SHAPE, _loop_cfg(tmp_path), fault_hook=hook,
                  device=CPU)
        # a committed checkpoint exists and a fresh run resumes cleanly
        assert ckpt.latest_step(str(tmp_path)) is not None
        rep = train(SMOKE, TRAIN_SHAPE, _loop_cfg(tmp_path), device=CPU)
        assert rep.resumed_from is not None

    def test_nan_loss_rolls_back_and_skips_the_step(self, tmp_path, monkeypatch):
        """A non-finite loss at step 3 restores the step-2 checkpoint and
        skips data step 3: the run records one rollback, a NaN loss for
        step 3, and goes on from the restored state to the end."""
        loss_fn = model.loss_fn
        calls = {"n": 0}
        per_step = TRAIN_SHAPE.global_batch // SMOKE.microbatch    # 2 slices

        def nan_at_step_3(cfg, params, batch):
            calls["n"] += 1
            loss = loss_fn(cfg, params, batch)
            return loss * float("nan") if calls["n"] == 3 * per_step + 1 else loss

        monkeypatch.setattr(model, "loss_fn", nan_at_step_3)
        rep = train(SMOKE, TRAIN_SHAPE, _loop_cfg(tmp_path), device=CPU)
        assert rep.rollbacks == 1 and rep.retries == 0
        assert np.isnan(rep.losses[3])
        assert all(np.isfinite(rep.losses[:3] + rep.losses[4:]))
        assert rep.final_step == 6 and ckpt.latest_step(str(tmp_path)) == 6

    def test_default_ckpt_dir_is_under_tmpdir(self):
        import tempfile
        assert TrainLoopConfig().ckpt_dir.startswith(tempfile.gettempdir())


class TestStraggler:
    def test_slow_batches_substituted(self):
        slow_steps = {3, 4}
        src = DataIterator(SMOKE, TRAIN_SHAPE, start_step=0, device=CPU,
                           delay_fn=lambda s: 0.3 if s in slow_steps else 0.0)
        pol = StragglerPolicy(slack=2.0, min_deadline_s=0.1)
        it = DeadlineDataIterator(SMOKE, TRAIN_SHAPE, src, pol, device=CPU)
        for step in range(6):
            b = next(it)
            assert b["tokens"].shape[0] == TRAIN_SHAPE.global_batch
            # a stand-in is the deterministic batch of the same step
            assert torch.equal(b["tokens"],
                               make_batch(SMOKE, TRAIN_SHAPE, step, device=CPU)["tokens"])
        assert pol.drops == len(slow_steps)

    def test_escalation_fires(self):
        src = DataIterator(SMOKE, TRAIN_SHAPE, start_step=0, device=CPU,
                           delay_fn=lambda s: 0.2 if s > 0 else 0.0)
        pol = StragglerPolicy(slack=1.5, min_deadline_s=0.05,
                              escalate_after=3)
        fired = []
        it = DeadlineDataIterator(SMOKE, TRAIN_SHAPE, src, pol, device=CPU,
                                  on_escalate=lambda: fired.append(1))
        for _ in range(6):
            next(it)
        assert fired


class TestCompression:
    def test_roundtrip_error_bounded(self):
        g = {"w": torch.randn((64, 64), generator=torch.Generator().manual_seed(0))}
        st = compression.init(g)
        q, s, st = compression.compress(g, st)
        back = compression.decompress(q, s)
        err = (back["w"] - g["w"]).abs().max()
        assert float(err) <= float(s["w"]) * 0.5 + 1e-7

    def test_error_feedback_unbiased_over_steps(self):
        """With a CONSTANT gradient, error feedback makes the mean of the
        decompressed stream converge to the true gradient."""
        g = {"w": torch.randn((32,), generator=torch.Generator().manual_seed(1)) * 0.01}
        st = compression.init(g)
        acc = torch.zeros((32,))
        n = 50
        for _ in range(n):
            q, s, st = compression.compress(g, st)
            acc = acc + compression.decompress(q, s)["w"]
        np.testing.assert_allclose((acc / n).numpy(), g["w"].numpy(),
                                   rtol=0.02, atol=1e-5)

    def test_traffic_reduction(self):
        g = {"w": torch.zeros((1000,), dtype=torch.float32)}
        st = compression.init(g)
        q, s, _ = compression.compress(g, st)
        assert compression.compressed_bytes(q) * 4 == compression.raw_bytes(g)


def test_loop_matches_reference_from_its_step0_checkpoint(tmp_path):
    """The reference's ``train(total_steps=0)`` writes its step-0
    checkpoint; the reference and the port each resume from a copy and run
    4 steps on the same data: equal resume points, losses within
    ``LOOP_RTOL``."""
    jcfg = jget_config("stablelm-1.6b").smoke()
    jshape = JShapeSpec("rt-train", 32, 8, "train")
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=100)

    def jloop(path, total):
        return jtrain_loop.TrainLoopConfig(
            total_steps=total, ckpt_every=2, ckpt_dir=str(path), log_every=0,
            opt=jadamw.AdamWConfig(**opt))

    jtrain_loop.train(jcfg, jshape, jloop(tmp_path / "step0", 0))
    assert ckpt.latest_step(str(tmp_path / "step0")) == 0
    for name in ("ref", "port"):
        shutil.copytree(tmp_path / "step0", tmp_path / name)
    want = jtrain_loop.train(jcfg, jshape, jloop(tmp_path / "ref", 4))
    got = train(SMOKE, TRAIN_SHAPE, TrainLoopConfig(
        total_steps=4, ckpt_every=2, ckpt_dir=str(tmp_path / "port"), log_every=0,
        opt=adamw.AdamWConfig(**opt)), device=CPU)
    assert got.resumed_from == want.resumed_from == 0
    assert got.steps_run == want.steps_run == 4
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOOP_RTOL)
    # the port's last checkpoint reads back into the reference's loop
    assert ckpt.latest_step(str(tmp_path / "port")) == 4
    again = jtrain_loop.train(jcfg, jshape, jloop(tmp_path / "port", 5))
    assert again.resumed_from == 4 and np.isfinite(again.losses).all()


def test_train_from_the_ports_own_init_matches_init_params(tmp_path):
    """``train`` draws its parameters from ``torch.Generator(device)``
    seeded 0: its step-0 checkpoint holds ``init_params`` of that seed."""
    train(SMOKE, TRAIN_SHAPE, _loop_cfg(tmp_path, total=0), device=CPU)
    params = transformer.init_params(SMOKE, torch.Generator(CPU).manual_seed(0),
                                     device=CPU)
    like = {"params": params, "opt": adamw.init(params)}
    step, state, extras = ckpt.restore_latest(str(tmp_path), like, device=CPU)
    assert step == 0 and extras == {"arch": SMOKE.name}
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(state["params"])))
