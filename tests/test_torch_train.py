"""The port's training slice against the JAX package on the same inputs:
the loss and its gradients (``loss_and_grads`` against
``jax.value_and_grad``), the train step with microbatches, AdamW and its
schedule, the gradient compression, the data pipeline's batches, the
batch specs, and checkpoints read across the two packages in both
directions.  Parameters come from the reference's ``init`` through
``from_jax_params``; inputs are made with numpy.

Tolerances.  In f32 both packages compute the same sums in other orders:
the loss agrees within ``LOSS_F32_RTOL`` = 1e-5 of itself and each
gradient leaf within ``GRAD_F32_TOL`` = 1e-4 of its max |g| (measured:
2e-7 and 1.4e-6).  In bf16 they also round in other places (the LM tests'
module note), so each leaf is held to the LM tests' ``LOGIT_TOL`` = 3e-2
of its max |g| (measured: at most 2.2e-2) and the loss, a mean over
tokens, to 1e-3 of itself (measured: 1.3e-4).  AdamW on equal inputs
gives m and v within 1e-6 relative and bf16 parameters at most one ulp
apart (global norms, f32 sums of squares in other orders, within 1e-5); the batches, the int8 compression and the checkpoints are equal."""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jget_config
from repro.configs.base import Segment as JSegment
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.data import pipeline as jpipeline
from repro.models.lm import model as jmodel
from repro.models.lm import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.optim import compression as jcompression
from repro_torch.checkpoint import ckpt
from repro_torch.configs import Segment, ShapeSpec, get_config
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.models.lm import attention, model, transformer
from repro_torch.optim import adamw, compression
from repro_torch.tree import tree_flatten_with_names, tree_leaves
from repro_torch.weights import from_jax_params

LOSS_F32_RTOL = 1e-5
GRAD_F32_TOL = 1e-4
LOSS_BF16_RTOL = 1e-3
LOGIT_TOL = 3e-2
NORM_RTOL = 1e-5       # f32 sums of squares over ~1e5 terms, other orders
ARCHS = ["gemma3-1b", "stablelm-1.6b"]
SEQ = 80               # > 64: the gemma3 smoke's local window bites


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these steps run many small ops, and with the
    default one thread per core in each of several test workers, the
    workers' spinning threads slow each other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _jnamed(tree):
    """The reference's leaves with their checkpoint names."""
    return [(name, leaf) for name, leaf in jckpt._flatten_with_names(tree)]


def _assert_grads(jgrads, tgrads, tol):
    jn, tn = _jnamed(jgrads), tree_flatten_with_names(tgrads)
    assert [n for n, _ in jn] == [n for n, _ in tn]
    for (name, a), (_, b) in zip(jn, tn):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape, name
        err = float(np.abs(a - b).max())
        scale = float(np.abs(a).max())
        assert err <= tol * scale, f"{name}: max |d| {err} > {tol} * {scale}"


def _batch(vocab, rows, seq, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (rows, seq)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(toks)})


def _f32(tree):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), tree)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """One arch's smoke config, reference parameters, a batch, and the
    reference's jitted loss and gradients in f32 and in bf16."""
    arch = request.param
    jcfg = jget_config(arch).smoke()
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    jb, tb = _batch(jcfg.vocab, 2, SEQ, 1)
    vg = jax.jit(jax.value_and_grad(lambda p, b: jmodel.loss_fn(jcfg, p, b)))
    out = {"cfg": get_config(arch).smoke(), "jparams": jparams, "jbatch": jb,
           "batch": tb}
    for dt, params in (("f32", _f32(jparams)), ("bf16", jparams)):
        loss, grads = vg(params, jb)
        out[dt] = (params, float(loss), grads)
    return out


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

def test_loss_and_grads_f32(ref):
    params, jloss, jgrads = ref["f32"]
    loss, grads = model.loss_and_grads(ref["cfg"], from_jax_params(params, "cpu"),
                                       ref["batch"])
    assert loss.dtype == torch.float32
    assert abs(float(loss) - jloss) <= LOSS_F32_RTOL * abs(jloss)
    _assert_grads(jgrads, grads, GRAD_F32_TOL)


def test_loss_and_grads_bf16(ref):
    params, jloss, jgrads = ref["bf16"]
    tparams = from_jax_params(params, "cpu")
    loss, grads = model.loss_and_grads(ref["cfg"], tparams, ref["batch"])
    assert abs(float(loss) - jloss) <= LOSS_BF16_RTOL * abs(jloss)
    assert all(g.dtype == torch.bfloat16 for g in tree_leaves(grads))
    _assert_grads(jgrads, grads, LOGIT_TOL)
    # the parameters are left as they were
    assert not any(t.requires_grad for t in tree_leaves(tparams))


def test_chunked_route_long_sequence():
    """S = 8192 = CHUNK_THRESHOLD: the reference scans 8 query chunks of
    1024, the port loops over them; one layer whose 3000-token window
    crosses the chunk edges, 2 heads, in f32."""
    tiny = dict(n_heads=2, d_model=32, d_ff=64, head_dim=8)
    jcfg = dataclasses.replace(jget_config("gemma3-1b").smoke(), **tiny,
                               segments=(JSegment("attn", 1, (3000,)),))
    cfg = dataclasses.replace(get_config("gemma3-1b").smoke(), **tiny,
                              segments=(Segment("attn", 1, (3000,)),))
    S = attention.CHUNK_THRESHOLD
    assert S % attention.Q_CHUNK == 0 and S // attention.Q_CHUNK == 8
    jparams = _f32(jtransformer.init_params(jcfg, jax.random.PRNGKey(3)))
    jb, tb = _batch(jcfg.vocab, 1, S, 2)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(jcfg, p, b)))(jparams, jb)
    loss, grads = model.loss_and_grads(cfg, from_jax_params(jparams, "cpu"), tb)
    assert abs(float(loss) - float(jloss)) <= LOSS_F32_RTOL * abs(float(jloss))
    _assert_grads(jgrads, grads, GRAD_F32_TOL)


def test_training_never_reaches_the_kernel_route(monkeypatch):
    """The training route is the plain ``attend``: ``ops.attention`` (the
    flash kernel's entry) is never called, so its autograd guard never
    has to refuse a training step."""
    def refuse(*a, **k):
        raise AssertionError("training called ops.attention")

    monkeypatch.setattr(ops, "attention", refuse)
    cfg = get_config("gemma3-1b").smoke()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, tb = _batch(cfg.vocab, 1, 16, 0)
    loss, grads = model.loss_and_grads(cfg, params, tb)
    assert torch.isfinite(loss)


def test_remat_does_not_change_numerics():
    cfg = get_config("stablelm-1.6b").smoke()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    _, tb = _batch(cfg.vocab, 2, 24, 5)
    a = model.loss_and_grads(cfg, params, tb)
    b = model.loss_and_grads(dataclasses.replace(cfg, remat=False), params, tb)
    assert cfg.remat and torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[1]),
                                                tree_leaves(b[1])))


def test_stacked_leaves_collect_every_layer():
    """Each layer's gradient lands in its slice of the stacked (L, ...)
    leaf: with 2 layers, both slices of every block leaf are nonzero."""
    cfg = get_config("gemma3-1b").smoke()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    _, tb = _batch(cfg.vocab, 1, 20, 6)
    _, grads = model.loss_and_grads(cfg, params, tb)
    for name, g in tree_flatten_with_names(grads["segments"]):
        assert g.shape[0] == 2 and all(g[i].abs().max() > 0 for i in range(2)), name


# ---------------------------------------------------------------------------
# train step with microbatches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatch", [2, 4])
def test_train_step_matches_reference(microbatch):
    """One ``make_train_step`` step in f32 on a batch of 4 (2 slices of 2,
    or 1 of 4): loss and grad norm within the f32 loss limit, m and v
    within the gradient limit of their max, and the parameters, whose
    update is lr * m/sqrt(v) with |m/sqrt(v)| <= 1 at step 1, within
    2 lr where a near-zero gradient's sign may differ."""
    jcfg = jget_config("gemma3-1b").smoke()
    cfg = get_config("gemma3-1b").smoke()
    opt = jadamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jparams = _f32(jtransformer.init_params(jcfg, jax.random.PRNGKey(2)))
    jb, tb = _batch(jcfg.vocab, 4, 48, 7)
    jstep = jax.jit(jmodel.make_train_step(jcfg, jmodel.TrainStepConfig(opt=opt),
                                           microbatch=microbatch))
    jp, jopt, jm = jstep(jparams, jadamw.init(jparams), jb)
    tparams = from_jax_params(jparams, "cpu")
    step = model.make_train_step(
        cfg, model.TrainStepConfig(opt=adamw.AdamWConfig(*opt)),
        microbatch=microbatch)
    tp, topt, tm = step(tparams, adamw.init(tparams), tb)
    for key in ("loss", "grad_norm"):
        assert abs(float(tm[key]) - float(jm[key])) <= \
            LOSS_F32_RTOL * abs(float(jm[key])), key
    assert int(topt.step) == int(jopt.step) == 1
    _assert_grads(jopt.m, topt.m, GRAD_F32_TOL)
    _assert_grads(jopt.v, topt.v, GRAD_F32_TOL)
    for (name, a), (_, b) in zip(_jnamed(jp), tree_flatten_with_names(tp)):
        assert float(np.abs(_np(a) - _np(b)).max()) <= 2 * opt.lr * 1.001, name


# ---------------------------------------------------------------------------
# AdamW and its schedule
# ---------------------------------------------------------------------------

def _ordered(x):
    """bf16 bit patterns as integers ordered like the values (adjacent
    bf16 values differ by 1)."""
    bits = (x.view(torch.int16).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).view(np.int16)).astype(np.int32)
    return np.where(bits < 0, -(bits & 0x7FFF), bits)


def test_adamw_apply_matches_reference():
    """Two AdamW steps on bf16 parameters with the same f32 gradients on
    both sides (clipped on the first step, not on the second)."""
    jcfg = jget_config("stablelm-1.6b").smoke()
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    grads = [jax.tree_util.tree_map(
        lambda p: jnp.asarray(scale * rng.standard_normal(p.shape).astype(np.float32)),
        jparams) for scale in (1.0, 1e-3)]
    opt = jadamw.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=5)
    jp, jstate = jparams, jadamw.init(jparams)
    tp, tstate = from_jax_params(jparams, "cpu"), adamw.init(from_jax_params(jparams, "cpu"))
    for g in grads:
        jp, jstate, jm = jadamw.apply(opt, jp, jstate, g)
        tp, tstate, tm = adamw.apply(adamw.AdamWConfig(*opt), tp, tstate,
                                     from_jax_params(g, "cpu"))
        assert tstate.step.dtype == torch.int32 and int(tstate.step) == int(jstate.step)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=NORM_RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        for jt, tt in ((jstate.m, tstate.m), (jstate.v, tstate.v)):
            for (name, a), (_, b) in zip(_jnamed(jt), tree_flatten_with_names(tt)):
                assert b.dtype == torch.float32
                a = np.asarray(a)
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-6,
                                           atol=1e-6 * float(np.abs(a).max()),
                                           err_msg=name)
        for (name, a), (_, b) in zip(_jnamed(jp), tree_flatten_with_names(tp)):
            assert b.dtype == torch.bfloat16
            assert int(np.abs(_ordered(a) - _ordered(b)).max()) <= 1, name


@pytest.mark.parametrize("step", [0, 1, 50, 100, 3000, 5050, 10_000, 12_000])
def test_schedule_matches_reference(step):
    """Warmup (0-100), the cosine (mid-way at 5050) and past the end."""
    cfg = adamw.AdamWConfig()
    want = float(jadamw.schedule(jadamw.AdamWConfig(), jnp.asarray(step, jnp.int32)))
    got = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_global_norm_matches_reference():
    jcfg = jget_config("gemma3-1b").smoke()
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(5))
    got = adamw.global_norm(from_jax_params(jparams, "cpu"))
    np.testing.assert_allclose(float(got), float(jadamw.global_norm(jparams)),
                               rtol=NORM_RTOL)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def test_compress_matches_reference():
    """Three rounds with error feedback: equal int8 trees and equal
    scales each round."""
    rng = np.random.default_rng(11)
    shapes = {"a": (33, 17), "b": [(64,), (5, 3, 2)]}
    rounds = [jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s).astype(np.float32) * 1e-2),
        shapes, is_leaf=lambda s: isinstance(s, tuple)) for _ in range(3)]
    jst = jcompression.init(rounds[0])
    tst = compression.init(from_jax_params(rounds[0], "cpu"))
    for g in rounds:
        jq, js, jst = jcompression.compress(g, jst)
        tq, ts, tst = compression.compress(from_jax_params(g, "cpu"), tst)
        for (name, a), (_, b) in zip(_jnamed(jq), tree_flatten_with_names(tq)):
            assert b.dtype == torch.int8
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        for (name, a), (_, b) in zip(_jnamed(js), tree_flatten_with_names(ts)):
            assert float(b) == float(a), name
        back = compression.decompress(tq, ts)
        jback = jcompression.decompress(jq, js)
        for (name, a), (_, b) in zip(_jnamed(jback), tree_flatten_with_names(back)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert compression.compressed_bytes(tq) == jcompression.compressed_bytes(jq)
    assert compression.raw_bytes(tq) == jcompression.raw_bytes(jq)


# ---------------------------------------------------------------------------
# data and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts,host", [(1, 0), (2, 0), (2, 1), (4, 3)])
def test_make_batch_equals_reference(hosts, host):
    jcfg = jget_config("gemma3-1b").smoke()
    cfg = get_config("gemma3-1b").smoke()
    dcfg = pipeline.DataConfig(num_hosts=hosts, host_id=host)
    jdcfg = jpipeline.DataConfig(num_hosts=hosts, host_id=host)
    for step in (0, 1, 7, 1000):
        want = jpipeline.make_batch(jcfg, JShapeSpec("d", 200, 8, "train"), step, jdcfg)
        got = pipeline.make_batch(cfg, ShapeSpec("d", 200, 8, "train"), step, dcfg,
                                  device="cpu")
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_data_iterator_equals_reference():
    jcfg = jget_config("stablelm-1.6b").smoke()
    cfg = get_config("stablelm-1.6b").smoke()
    jit = jpipeline.DataIterator(jcfg, JShapeSpec("d", 32, 4, "train"), start_step=3)
    it = pipeline.DataIterator(cfg, ShapeSpec("d", 32, 4, "train"), start_step=3,
                               device="cpu")
    for _ in range(3):
        np.testing.assert_array_equal(next(it)["tokens"].numpy(),
                                      np.asarray(next(jit)["tokens"]))
    assert it.step == jit.step == 6


def test_prefix_and_encdec_batches_are_not_ported():
    cfg = dataclasses.replace(get_config("gemma3-1b").smoke(), num_prefix_tokens=4,
                              prefix_dim=8)
    with pytest.raises(NotImplementedError, match="Other LM families"):
        pipeline.make_batch(cfg, ShapeSpec("d", 32, 2, "train"), 0, device="cpu")


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_batch_spec_and_synth_batch(mode):
    jcfg = jget_config("gemma3-1b").smoke()
    cfg = get_config("gemma3-1b").smoke()
    want = jmodel.make_batch_spec(jcfg, JShapeSpec("s", 40, 3, mode))
    got = model.make_batch_spec(cfg, ShapeSpec("s", 40, 3, mode))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()} == \
        {k: (v.shape, str(v.dtype).split(".")[-1]) for k, v in got.items()}
    batch = model.synth_batch(cfg, ShapeSpec("s", 40, 3, mode),
                              torch.Generator().manual_seed(0), device="cpu")
    for k, spec in got.items():
        assert batch[k].shape == spec.shape and batch[k].dtype == spec.dtype
        assert int(batch[k].min()) >= 0 and int(batch[k].max()) < cfg.vocab


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

def _manifest(path, step):
    with open(path / f"step_{step:09d}" / "manifest.json") as f:
        return json.load(f)


def _state(arch="gemma3-1b"):
    """A reference training state (bf16 params, f32 moments, int32 step)
    after one AdamW step, so no leaf is trivially zero."""
    jcfg = jget_config(arch).smoke()
    jparams = jtransformer.init_params(jcfg, jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda p: jnp.ones(p.shape, jnp.float32), jparams)
    jparams, jopt, _ = jadamw.apply(jadamw.AdamWConfig(), jparams,
                                    jadamw.init(jparams), grads)
    return {"params": jparams, "opt": jopt}


def _assert_bits_equal(jtree, ttree):
    jn, tn = _jnamed(jtree), tree_flatten_with_names(ttree)
    assert [n for n, _ in jn] == [n for n, _ in tn]
    for (name, a), (_, b) in zip(jn, tn):
        a = np.asarray(a)
        assert str(b.dtype).split(".")[-1] == a.dtype.name, name
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                          a.view(np.int16), err_msg=name)
        else:
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


def test_checkpoint_reference_to_port(tmp_path):
    jstate = _state()
    jckpt.save(str(tmp_path / "ref"), 7, jstate, extras={"arch": "x"})
    like = from_jax_params(jstate, "cpu")
    got, extras = ckpt.restore(str(tmp_path / "ref"), 7, like, device="cpu")
    assert extras == {"arch": "x"}
    assert type(got["opt"]).__module__ == "repro_torch.optim.adamw"
    _assert_bits_equal(jstate, got)
    # the port writes the same names and dtypes
    ckpt.save(str(tmp_path / "port"), 7, got, extras={"arch": "x"})
    a, b = _manifest(tmp_path / "ref", 7), _manifest(tmp_path / "port", 7)
    assert a["names"] == b["names"] and a["dtypes"] == b["dtypes"]
    assert a["step"] == b["step"] and a["extras"] == b["extras"]


def test_checkpoint_port_to_reference(tmp_path):
    jstate = _state("stablelm-1.6b")
    tstate = from_jax_params(jstate, "cpu")
    ckpt.save(str(tmp_path), 3, tstate)
    assert jckpt.latest_step(str(tmp_path)) == 3
    step, got, _ = jckpt.restore_latest(str(tmp_path), jstate)
    assert step == 3
    _assert_bits_equal(got, tstate)
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jstate)


def test_checkpoint_restores_on_meta_like(tmp_path):
    """``like`` may be shapes only (the meta device), as a resuming run
    has before it holds any weights."""
    jstate = _state()
    jckpt.save(str(tmp_path), 1, jstate)
    cfg = get_config("gemma3-1b").smoke()
    meta = transformer.init_params(cfg, torch.Generator(), device="meta")
    like = {"params": meta, "opt": adamw.init(meta)}
    got, _ = ckpt.restore(str(tmp_path), 1, like, device="cpu")
    _assert_bits_equal(jstate, got)
