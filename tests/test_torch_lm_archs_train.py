"""The port's training slice on the other LM families (MoE, SSM, RG-LRU
hybrid, encoder-decoder, image prefix) against the reference:
``loss_and_grads`` against ``jax.value_and_grad`` on the smoke config of
each arch (the batches from both packages' data pipelines), the prefix
dropped before the head, and a microbatched train step with an image
prefix.

Tolerances are ``tests/test_torch_train.py``'s.  In f32 the loss agrees
within ``LOSS_F32_RTOL`` = 1e-5 of itself and each gradient leaf within
``GRAD_F32_TOL`` = 1e-4 of its max |g| (measured: at most 1.6e-7 and
3.7e-6 here).  In bf16 the loss agrees within ``LOSS_BF16_RTOL`` = 1e-3
and each leaf within ``LOGIT_TOL`` = 3e-2 of its max |g| (measured: at
most 2.0e-2 on falcon-mamba, whisper and paligemma).  Whisper runs in
bf16 only (the reference's encoder casts its frames to bf16).  The bf16
gradients of the MoE archs and of recurrentgemma are held by their loss
alone, for the reasons ``tests/test_torch_lm_archs.py`` measures: a
route that flips on a near tie moves a whole expert's share of a token's
gradient (measured 0.19 of max |g| on a w_gate leaf), and recurrentgemma's
per-op bf16 GeLU in the reference adds ~0.5% a block (0.07-0.10 of max
|g| on its conv and FFN leaves); their gradients are held in f32."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import pipeline as jpipeline
from repro.models.lm import model as jmodel
from repro.models.lm import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.data import pipeline
from repro_torch.models.lm import model, transformer
from repro_torch.optim import adamw
from repro_torch.tree import tree_flatten_with_names, tree_leaves
from repro_torch.weights import from_jax_params

LOSS_F32_RTOL = 1e-5
GRAD_F32_TOL = 1e-4
LOSS_BF16_RTOL = 1e-3
LOGIT_TOL = 3e-2
NEW_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "falcon-mamba-7b",
             "recurrentgemma-9b", "whisper-small", "paligemma-3b"]
SEQ, ROWS = 80, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: many small ops, and several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _assert_grads(jgrads, tgrads, tol):
    jn, tn = jckpt._flatten_with_names(jgrads), tree_flatten_with_names(tgrads)
    assert [n for n, _ in jn] == [n for n, _ in tn]
    for (name, a), (_, b) in zip(jn, tn):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, name
        err = float(np.abs(a - b).max())
        scale = float(np.abs(a).max())
        assert err <= tol * scale, f"{name}: max |d| {err} > {tol} * {scale}"


def _batches(arch, mode="train", rows=ROWS, seq=SEQ, step=0):
    """The pipeline's batch of ``step`` from both packages."""
    jc, tc = jget_config(arch).smoke(), get_config(arch).smoke()
    jb = jpipeline.make_batch(jc, JShapeSpec("d", seq, rows, mode), step)
    tb = pipeline.make_batch(tc, ShapeSpec("d", seq, rows, mode), step,
                             device="cpu")
    return jc, tc, jb, tb


def _grads(arch, dtype):
    jc, tc, jb, tb = _batches(arch)
    jparams = jtransformer.init_params(jc, jax.random.PRNGKey(0))
    if dtype == "f32":
        jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jparams)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(jc, p, b)))(jparams, jb)
    tparams = from_jax_params(jparams, "cpu")
    loss, grads = model.loss_and_grads(tc, tparams, tb)
    assert not any(t.requires_grad for t in tree_leaves(tparams))
    return float(jloss), jgrads, float(loss), grads


@pytest.mark.parametrize("arch", [a for a in NEW_ARCHS if a != "whisper-small"])
def test_loss_and_grads_f32(arch):
    jloss, jgrads, loss, grads = _grads(arch, "f32")
    assert abs(loss - jloss) <= LOSS_F32_RTOL * abs(jloss)
    _assert_grads(jgrads, grads, GRAD_F32_TOL)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "whisper-small",
                                  "paligemma-3b"])
def test_loss_and_grads_bf16(arch):
    jloss, jgrads, loss, grads = _grads(arch, "bf16")
    assert abs(loss - jloss) <= LOSS_BF16_RTOL * abs(jloss)
    assert [str(g.dtype).split(".")[-1] for g in tree_leaves(grads)] == \
        [g.dtype.name for g in jax.tree_util.tree_leaves(jgrads)]
    _assert_grads(jgrads, grads, LOGIT_TOL)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b",
                                  "recurrentgemma-9b"])
def test_loss_bf16(arch):
    jloss, jgrads, loss, grads = _grads(arch, "bf16")
    assert abs(loss - jloss) <= LOSS_BF16_RTOL * abs(jloss)
    assert all(torch.isfinite(g.float()).all() for g in tree_leaves(grads))
    assert [n for n, _ in jckpt._flatten_with_names(jgrads)] == \
        [n for n, _ in tree_flatten_with_names(grads)]


def test_loss_drops_the_prefix_positions(monkeypatch):
    """The head sees only the text positions: the prefix's hidden states
    are sliced off before the logits, as in the reference."""
    jc, tc, jb, tb = _batches("paligemma-3b")
    seen = []
    real = transformer.logits_head
    monkeypatch.setattr(transformer, "logits_head",
                        lambda cfg, p, x: seen.append(x.shape) or real(cfg, p, x))
    params = transformer.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    model.loss_fn(tc, params, tb)
    text = SEQ - tc.num_prefix_tokens
    assert seen == [(ROWS, text, tc.d_model)] and tb["tokens"].shape == (ROWS, text)


def test_train_step_with_prefix_matches_reference():
    """One microbatched ``make_train_step`` step in f32 on paligemma's
    smoke (2 slices of 2 rows; the prefix is sliced with the tokens)."""
    jc, tc, jb, tb = _batches("paligemma-3b", rows=4, seq=40)
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                     jtransformer.init_params(jc, jax.random.PRNGKey(2)))
    jp, jopt, jm = jax.jit(jmodel.make_train_step(
        jc, jmodel.TrainStepConfig(opt=opt), microbatch=2))(
            jparams, jadamw.init(jparams), jb)
    tparams = from_jax_params(jparams, "cpu")
    step = model.make_train_step(tc, model.TrainStepConfig(
        opt=adamw.AdamWConfig(*opt)), microbatch=2)
    tp, topt, tm = step(tparams, adamw.init(tparams), tb)
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= \
            LOSS_F32_RTOL * abs(float(jm[key])), key
    _assert_grads(jopt.m, topt.m, GRAD_F32_TOL)
