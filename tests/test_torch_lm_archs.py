"""The port's LM stacks against the reference on the smoke config of each
of the ten archs: ``transformer.prefill`` then ``decode`` steps (through
``model.make_prefill_step``, with the encoder frames or image prefix
where the arch takes one), ``param_count`` at full size, and the caches'
structure.  Parameters come from the reference's ``init`` through
``from_jax_params``; inputs are made with numpy.

Tolerances.  In f32 both packages compute the same function in other
summation orders: logits agree within ``F32_LOGIT_TOL`` = 1e-4 of max
|logit| (measured at most 2.5e-6 through these stacks of up to 8 layers).
Whisper runs in bf16 only, since the reference's encoder casts its frames
to bf16.  In bf16 the packages also round in other places, a bf16 ulp or
two per block (the module tests' note), and logits agree within
``LOGIT_TOL`` = 3e-2 of max |logit|, as in ``tests/test_torch_lm.py``.
Two things keep the bf16 comparison off the full smoke of three archs,
each measured and held by a test below:

* recurrentgemma's smoke stacks 8 blocks with 8 FFNs, and the
  reference's bf16 GeLU rounds after every op with bf16 constants where
  PyTorch's rounds once (``test_quirk_jax_bf16_gelu_rounds_every_op``):
  each FFN adds ~0.5% of the hidden state's magnitude, ~5% at the logits
  over 8 blocks.  Its bf16 comparison runs at one super-block and one
  recurrent layer (the cut the card-against-CPU phase uses), and the
  full smoke is held in f32.
* An MoE route is a discontinuous function of the router logits: where
  two experts' logits lie closer than the bf16 difference of the router
  input, the packages may pick different experts, and that token's
  output moves by a whole expert's share.  In bf16 the MoE archs are held
  to: every route that differs is such a near tie, and the logits agree
  within ``LOGIT_TOL`` at every step before the first differing route;
  the full smoke is held in f32, where the routes agree."""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.configs import all_archs as jall_archs
from repro.configs import get_config as jget_config
from repro.models.lm import model as jmodel
from repro.models.lm import moe as jmoe
from repro.models.lm import transformer as jtransformer
from repro_torch.configs import all_archs, get_config
from repro_torch.models.lm import attention, model, moe, rglru, ssm, transformer
from repro_torch.tree import tree_leaves
from repro_torch.weights import from_jax_params

F32_LOGIT_TOL = 1e-4
LOGIT_TOL = 3e-2
ARCHS = jall_archs()
MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]
B, S, STEPS = 2, 80, 6
ENC_FRAMES = 120


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


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-6)


def _configs(arch, cut=None):
    jc, tc = jget_config(arch).smoke(), get_config(arch).smoke()
    if cut is not None:
        jc = dataclasses.replace(jc, segments=tuple(
            dataclasses.replace(s, n=n) for s, n in zip(jc.segments, cut)))
        tc = dataclasses.replace(tc, segments=tuple(
            dataclasses.replace(s, n=n) for s, n in zip(tc.segments, cut)))
    return jc, tc


def _inputs(jc, seed):
    """Prompt tokens, the stub frames or prefix (bf16), and decode tokens."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, jc.vocab, (B, S)).astype(np.int32)}
    if jc.is_encdec():
        batch["enc_frames"] = rng.standard_normal(
            (B, ENC_FRAMES, jc.enc_frame_dim)).astype(np.float32)
    if jc.num_prefix_tokens:
        batch["prefix"] = rng.standard_normal(
            (B, jc.num_prefix_tokens, jc.prefix_dim)).astype(np.float32)
    steps = [rng.integers(0, jc.vocab, (B, 1)).astype(np.int32)
             for _ in range(STEPS)]
    return batch, steps


def _run(jc, tc, dtype, seed=0):
    """(per-step logits of the reference, of the port, last caches)."""
    jparams = jtransformer.init_params(jc, jax.random.PRNGKey(seed))
    if dtype == "f32":
        jparams = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), jparams)
    params = from_jax_params(jparams, "cpu")
    batch, steps = _inputs(jc, seed + 1)
    jbatch = {k: jnp.asarray(v) if k == "tokens" else
              jnp.asarray(v).astype(jnp.bfloat16) for k, v in batch.items()}
    tbatch = {k: from_jax_params(v, "cpu") for k, v in jbatch.items()}
    tbatch["tokens"] = tbatch["tokens"].long()
    s_max = S + jc.num_prefix_tokens + STEPS
    jlog, jcache = jax.jit(jmodel.make_prefill_step(jc, s_max))(jparams, jbatch)
    log, cache = model.make_prefill_step(tc, s_max)(params, tbatch)
    assert cache.cur_pos == int(jcache.cur_pos) == S + jc.num_prefix_tokens
    jlogs, logs = [jlog], [log]
    jdec = jax.jit(jmodel.make_decode_step(jc))
    dec = model.make_decode_step(tc)
    for i, tok in enumerate(steps):
        jlog, jcache = jdec(jparams, jnp.asarray(tok), jcache)
        log, cache = dec(params, torch.from_numpy(tok).long(), cache)
        assert cache.cur_pos == int(jcache.cur_pos) == S + jc.num_prefix_tokens + i + 1
        jlogs.append(jlog)
        logs.append(log)
    return jlogs, logs, (jcache, cache)


F32_CASES = [a for a in ARCHS if a != "whisper-small"]


@pytest.mark.parametrize("arch", F32_CASES)
def test_prefill_then_decode_f32(arch):
    jc, tc = _configs(arch)
    jlogs, logs, _ = _run(jc, tc, "f32")
    for step, (a, b) in enumerate(zip(logs, jlogs)):
        assert a.dtype == torch.float32 and a.shape == (B, 1, jc.vocab)
        assert _rel(a, b) <= F32_LOGIT_TOL, (step, _rel(a, b))


BF16_CASES = [(a, None) for a in ARCHS
              if a not in MOE_ARCHS and a != "recurrentgemma-9b"] + \
    [("recurrentgemma-9b", (1, 1))]


@pytest.mark.parametrize("arch,cut", BF16_CASES)
def test_prefill_then_decode_bf16(arch, cut):
    jc, tc = _configs(arch, cut)
    jlogs, logs, _ = _run(jc, tc, "bf16")
    for step, (a, b) in enumerate(zip(logs, jlogs)):
        assert _rel(a, b) <= LOGIT_TOL, (step, _rel(a, b))


def _record_routes(monkeypatch):
    """Router logits of every ``route`` call, reference and port, in call
    order (the reference's through an ordered debug callback)."""
    jrec, trec = [], []
    jroute, troute = jmoe.route, moe.route

    def jr(p, x, k):
        logits = x.astype(jnp.float32) @ p.w_router
        jax.debug.callback(lambda a: jrec.append(np.asarray(a)), logits,
                           ordered=True)
        return jroute(p, x, k)

    def tr(p, x, k):
        trec.append((x.to(torch.float32) @ p.w_router).numpy())
        return troute(p, x, k)

    monkeypatch.setattr(jmoe, "route", jr)
    monkeypatch.setattr(moe, "route", tr)
    return jrec, trec


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_bf16_routes_differ_only_on_near_ties(arch, monkeypatch):
    jrec, trec = _record_routes(monkeypatch)
    jc, tc = _configs(arch)
    jlogs, logs, _ = _run(jc, tc, "bf16")
    L, k = jc.n_layers, jc.top_k
    assert len(jrec) == len(trec) == L * (STEPS + 1)
    first_differing = None
    for call, (a, b) in enumerate(zip(jrec, trec)):
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        ta = np.sort(np.argsort(-a, axis=-1, kind="stable")[:, :k], axis=-1)
        tb = np.sort(np.argsort(-b, axis=-1, kind="stable")[:, :k], axis=-1)
        differ = np.where((ta != tb).any(-1))[0]
        if len(differ) == 0:
            continue
        first_differing = call if first_differing is None else first_differing
        srt = -np.sort(-a, axis=-1)
        margin = srt[differ, k - 1] - srt[differ, k]
        bound = 2 * float(np.abs(a - b).max())
        assert (margin <= bound).all(), (call, margin, bound)
    last_clean = len(logs) if first_differing is None else first_differing // L
    for step in range(last_clean):
        assert _rel(logs[step], jlogs[step]) <= LOGIT_TOL, step


def test_quirk_jax_bf16_gelu_rounds_every_op():
    """``jax.nn.gelu`` on bf16 evaluates its tanh formula with the
    constants rounded to bf16 and rounds after every op: written out in
    bf16 tensor ops it is bit-equal; PyTorch's ``F.gelu`` (tanh form),
    which the port keeps, computes in f32 and rounds once, one ulp off on
    a large share of values."""
    x = (3 * np.random.default_rng(0).standard_normal(20000)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = _np(jax.nn.gelu(jx))
    t = from_jax_params(jx, "cpu")
    c = float(torch.tensor(math.sqrt(2 / math.pi)).to(torch.bfloat16))
    k = float(torch.tensor(0.044715).to(torch.bfloat16))
    per_op = t * (0.5 * (1.0 + torch.tanh(c * (t + k * (t * t * t)))))
    np.testing.assert_array_equal(_np(per_op), want)
    once = _np(torch.nn.functional.gelu(t, approximate="tanh"))
    assert 0.2 < float((once != want).mean()) < 0.6
    assert float(np.abs(once - want).max()) <= 2 ** -7 * float(np.abs(want).max())


# ---------------------------------------------------------------------------
# registry, sizes, caches
# ---------------------------------------------------------------------------

def test_registry_equals_the_reference():
    assert all_archs() == jall_archs() and len(ARCHS) == 10
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_at_full_size(arch):
    assert transformer.param_count(get_config(arch)) == \
        jtransformer.param_count(jget_config(arch))


def test_cache_structure():
    """Per segment: KVCache (attn), SSMState (ssm), RGLRUState (rec), a
    (rec1, rec2, kv) triple (hybrid3) and a (self, cross) pair (xattn),
    each stacked (L, ...) with the reference's shapes and dtypes."""
    def shapes(tree):
        return [(tuple(x.shape), str(x.dtype).split(".")[-1])
                for x in tree_leaves(tree)]

    kinds = {"falcon-mamba-7b": (ssm.SSMState,),
             "recurrentgemma-9b": (tuple, rglru.RGLRUState),
             "whisper-small": (tuple,)}
    for arch, types in kinds.items():
        jc, tc = _configs(arch)
        params = transformer.init_params(tc, torch.Generator().manual_seed(0),
                                         device="cpu")
        batch, _ = _inputs(jc, 0)
        tb = {key: torch.from_numpy(v).to(torch.bfloat16) if key != "tokens"
              else torch.from_numpy(v).long() for key, v in batch.items()}
        jb = {key: jnp.asarray(v).astype(jnp.bfloat16) if key != "tokens"
              else jnp.asarray(v) for key, v in batch.items()}
        _, cache = model.make_prefill_step(tc, S + 4)(params, tb)
        jcache = jax.eval_shape(
            lambda p, b: jmodel.make_prefill_step(jc, S + 4)(p, b)[1],
            jtransformer.init_params(jc, jax.random.PRNGKey(0)), jb)
        assert isinstance(cache.entries[0], types[0])
        assert shapes(cache.entries) == [
            (tuple(x.shape), x.dtype.name)
            for x in jax.tree_util.tree_leaves(jcache.entries)], arch
        if arch == "recurrentgemma-9b":
            st1, st2, kv = cache.entries[0]
            assert isinstance(st1, rglru.RGLRUState) and \
                isinstance(kv, attention.KVCache)
            assert isinstance(cache.entries[1], rglru.RGLRUState)
        if arch == "whisper-small":
            self_kv, cross_kv = cache.entries[0]
            assert cross_kv.k.shape[2] == ENC_FRAMES


def test_quirk_encoder_casts_frames_to_bf16():
    """The reference's encoder casts its stub frames to bf16 before the
    sinusoid, whatever their dtype, and so does the port: f32 frames give
    the output of their bf16 rounding.  (With f32 parameters the
    reference's encoder scan would then change its carry's dtype, which
    is why whisper is compared in bf16 only.)"""
    jc, tc = _configs("whisper-small")
    jparams = jtransformer.init_params(jc, jax.random.PRNGKey(0))
    params = from_jax_params(jparams, "cpu")
    frames = np.random.default_rng(3).standard_normal(
        (2, 30, jc.enc_frame_dim)).astype(np.float32)
    got = transformer.encode(tc, params, torch.from_numpy(frames), train=False)
    rounded = transformer.encode(tc, params, torch.from_numpy(frames).to(
        torch.bfloat16), train=False)
    assert got.dtype == torch.bfloat16 and torch.equal(got, rounded)
    want = jtransformer.encode(jc, jparams, jnp.asarray(frames))
    assert _rel(got, want) <= LOGIT_TOL
