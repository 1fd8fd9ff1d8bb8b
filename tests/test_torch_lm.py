"""The port's LM modules against the JAX package on the same inputs
(parameters from the reference's ``init`` through ``from_jax_params``,
inputs made with numpy): rope, the MLPs and norms, attention's forward /
prefill / decode_step, and the slice as a whole (``transformer.prefill``
then ``decode`` steps) on the smoke configs of every registered arch,
plus a 6-layer gemma3-1b smoke with a global layer, prompts past the
64-token smoke window and decode steps past it.  The reference's quirks
that the port keeps each have a test here.

Tolerances.  Both packages work in bf16 and round in slightly different
places: the port's attention returns f32 probabilities times V and rounds
once (the reference rounds the probabilities to bf16 first), and PyTorch
computes a bf16 activation in f32 and rounds once.  Each module differs
from the reference by at most a bf16 ulp or two of its output (2^-8 of
the magnitude), so module tolerances are ``MODULE_TOL`` = 1e-2 of the
output's largest magnitude.  Through a stack those differences compound;
logits must agree within ``LOGIT_TOL`` = 3e-2 of the largest |logit|
(about twice the worst difference seen on these configs)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models.lm import attention as jattention
from repro.models.lm import mlp as jmlp
from repro.models.lm import rope as jrope
from repro.models.lm import transformer as jtransformer
from repro_torch.configs import GLOBAL_WINDOW, get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.lm import attention, mlp, rope, transformer
from repro_torch.weights import from_jax_params

MODULE_TOL = 1e-2
LOGIT_TOL = 3e-2
ARCHS = ["gemma3-1b", "stablelm-1.6b", "starcoder2-3b", "gemma2-27b"]


def _t(x):
    """A jax/numpy array as a CPU tensor, bf16 bit for bit."""
    return from_jax_params(x, device="cpu")


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


def _rel_close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max |d| {err} > {tol} * {scale}"


def _bf16(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32)
                       ).astype(jnp.bfloat16)


# ---------------------------------------------------------------------------
# rope
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd", [16, 288])
def test_rope_angles(hd):
    pos = np.arange(0, 2100, 7)
    jc, js = jrope.rope_angles(jnp.asarray(pos), hd)
    tc, ts = rope.rope_angles(torch.from_numpy(pos), hd)
    # float32 pow and cos of angles up to ~2000 rad: a few ulps of 2000
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-3)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-3)


def test_apply_rope_bf16_exact():
    x = _bf16((2, 40, 4, 16), 1)
    jc, js = jrope.rope_angles(jnp.arange(40), 16)
    want = jrope.apply_rope(x, jc, js)
    got = rope.apply_rope(_t(x), _t(jc), _t(js))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))


def test_quirk_rope_rotates_halves():
    """x[i] turns with x[i + hd/2], not with x[i + 1] (the reference's code,
    whatever its docstring says)."""
    x = torch.zeros((1, 1, 1, 8))
    x[..., 0] = 1.0
    cos, sin = rope.rope_angles(torch.tensor([1]), 8)
    out = rope.apply_rope(x, cos, sin)[0, 0, 0]
    assert out[0] == pytest.approx(float(cos[0, 0]))
    assert out[4] == pytest.approx(float(sin[0, 0]))
    assert out[1] == 0.0
    want = jrope.apply_rope(jnp.asarray(x.numpy()),
                            *jrope.rope_angles(jnp.array([1]), 8))
    # float32 cos/sin of the two libraries may differ in the last ulp
    np.testing.assert_allclose(out.numpy(), np.asarray(want)[0, 0, 0], rtol=1e-6)


def test_quirk_rope_ignores_config_theta():
    """gemma3-1b sets rope_theta 1e6, yet attention calls rope_angles with
    its default 10,000: the slice's logits do not depend on rope_theta."""
    cfg = jget_config("gemma3-1b").smoke()
    params = _t(jtransformer.init_params(cfg, jax.random.PRNGKey(0)))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, 20)))
    tcfg = get_config("gemma3-1b").smoke()
    a, _ = transformer.prefill(tcfg, params, toks, 24)
    b, _ = transformer.prefill(dataclasses.replace(tcfg, rope_theta=10.0),
                               params, toks, 24)
    assert tcfg.rope_theta == 1e6 and torch.equal(a, b)


# ---------------------------------------------------------------------------
# mlp and norms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated(act):
    p = jmlp.init_gated(jax.random.PRNGKey(2), 64, 128)
    x = _bf16((2, 10, 64), 3)
    _rel_close(mlp.gated(_t(p), _t(x), act), jmlp.gated(p, x, act), MODULE_TOL)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_plain(act):
    p = jmlp.init_plain(jax.random.PRNGKey(4), 64, 128)
    p = p._replace(b_in=_bf16((128,), 5), b_out=_bf16((64,), 6))
    x = _bf16((2, 10, 64), 7)
    _rel_close(mlp.plain(_t(p), _t(x), act), jmlp.plain(p, x, act), MODULE_TOL)


def test_quirk_gelu_is_tanh_approximation():
    """jax.nn.gelu defaults to the tanh form; so does the port (in f32 the
    port matches the reference to float rounding, and the erf form would
    not)."""
    d, f = 8, 16
    rng = np.random.default_rng(8)
    p = jmlp.GatedMLP(*(jnp.asarray(rng.standard_normal(s).astype(np.float32))
                        for s in ((d, f), (d, f), (f, d))))
    x = jnp.asarray(3 * rng.standard_normal((4, d)).astype(np.float32))
    want = np.asarray(jmlp.gated(p, x, "gelu"))
    got = mlp.gated(_t(p), _t(x), "gelu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    tp, tx = _t(p), _t(x)
    erf = (torch.nn.functional.gelu(tx @ tp.w_gate) * (tx @ tp.w_up)) @ tp.w_down
    assert np.abs(erf.numpy() - want).max() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    x = _bf16((3, 5, 64), 9, scale=4.0).astype(dtype)
    scale = _bf16((64,), 10)
    _rel_close(mlp.rmsnorm(_t(scale), _t(x)), jmlp.rmsnorm(scale, x), MODULE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(dtype):
    x = (_bf16((3, 5, 64), 11, scale=4.0) + 2.0).astype(dtype)
    p = {"scale": _bf16((64,), 12), "bias": _bf16((64,), 13)}
    _rel_close(mlp.layernorm(_t(p), _t(x)), jmlp.layernorm(p, x), MODULE_TOL)


def test_quirk_rmsnorm_scale_and_unscaled_embedding():
    """RMSNorm multiplies by scale (zero scale gives zeros, not x), and
    token embeddings are the table's rows, not scaled by sqrt(D)."""
    x = _t(_bf16((2, 3, 16), 14))
    assert torch.equal(mlp.rmsnorm(torch.zeros(16, dtype=torch.bfloat16), x),
                       torch.zeros_like(x))
    cfg = get_config("gemma3-1b").smoke()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    toks = torch.tensor([[3, 7, 0]])
    assert torch.equal(transformer.embed_tokens(cfg, params, toks)[0],
                       params["embed"][[3, 7, 0]])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv,window,softcap", [
    (1, None, None), (1, 24, None), (2, GLOBAL_WINDOW, None), (4, 24, 50.0),
])
def test_attention_forward(kv, window, softcap):
    p = jattention.init(jax.random.PRNGKey(15), 64, 4, kv, 16)
    x = _bf16((2, 40, 64), 16)
    pos = np.arange(40)
    jw = None if window is None else jnp.int32(window)
    want = jattention.forward(p, x, jnp.asarray(pos), window=jw, softcap=softcap)
    before = flash_attention.launches
    got = attention.forward(_t(p), _t(x), torch.from_numpy(pos), window=window,
                            softcap=softcap)
    assert flash_attention.launches == before      # the CPU takes the plain path
    assert got.dtype == torch.bfloat16
    _rel_close(got, want, MODULE_TOL)


def test_attention_prefill_exact():
    p = jattention.init(jax.random.PRNGKey(17), 64, 4, 2, 16)
    x = _bf16((2, 30, 64), 18)
    want = jattention.prefill(p, x, jnp.arange(30), 48)
    got = attention.prefill(_t(p), _t(x), torch.arange(30), 48)
    assert isinstance(got, attention.KVCache) and got.k.shape == (2, 48, 2, 16)
    np.testing.assert_array_equal(_np(got.k), _np(want.k))
    np.testing.assert_array_equal(_np(got.v), _np(want.v))


@pytest.mark.parametrize("window", [None, 20])
def test_attention_decode_steps(window):
    p = jattention.init(jax.random.PRNGKey(19), 64, 4, 1, 16)
    S, s_max = 24, 40
    x = _bf16((2, S, 64), 20)
    jcache = jattention.prefill(p, x, jnp.arange(S), s_max)
    tp, tcache = _t(p), _t(jcache)
    jw = None if window is None else jnp.int32(window)
    for step in range(6):
        xt = _bf16((2, 1, 64), 21 + step)
        want, jcache = jattention.decode_step(p, xt, jcache, jnp.int32(S + step),
                                              window=jw)
        got, tcache = attention.decode_step(tp, _t(xt), tcache, S + step,
                                            window=window)
        _rel_close(got, want, MODULE_TOL)
        _rel_close(tcache.k, jcache.k, MODULE_TOL)
    with pytest.raises(ValueError, match="outside the cache"):
        attention.decode_step(tp, _t(xt), tcache, s_max, window=window)


# ---------------------------------------------------------------------------
# the slice: prefill then decode, port against the reference
# ---------------------------------------------------------------------------

def _configs(arch, n_layers=None):
    jc, tc = jget_config(arch).smoke(), get_config(arch).smoke()
    if n_layers is not None:
        jc = dataclasses.replace(jc, segments=(dataclasses.replace(
            jc.segments[0], n=n_layers),))
        tc = dataclasses.replace(tc, segments=(dataclasses.replace(
            tc.segments[0], n=n_layers),))
    return jc, tc


@pytest.mark.parametrize("arch,n_layers", [
    ("gemma3-1b", None), ("gemma3-1b", 6), ("stablelm-1.6b", None),
    ("starcoder2-3b", None), ("gemma2-27b", None),
])
def test_prefill_then_decode(arch, n_layers):
    """Prompts of 80 tokens (past the 64-token smoke window), then 8 decode
    steps of given tokens (so both packages see the same inputs)."""
    jc, tc = _configs(arch, n_layers)
    if n_layers == 6:
        assert tc.segments[0].windows()[-1] == GLOBAL_WINDOW
    jparams = jtransformer.init_params(jc, jax.random.PRNGKey(0))
    params = _t(jparams)
    rng = np.random.default_rng(1)
    B, S, s_max = 2, 80, 96
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    jlog, jcache = jax.jit(lambda p, t: jtransformer.prefill(jc, p, t, s_max))(
        jparams, jnp.asarray(toks))
    log, cache = transformer.prefill(tc, params, torch.from_numpy(toks).long(),
                                     s_max)
    assert log.shape == (B, 1, jc.vocab) and cache.cur_pos == S
    assert cache.entries[0].k.shape == jcache.entries[0].k.shape
    _rel_close(log, jlog, LOGIT_TOL)
    jdec = jax.jit(lambda p, t, c: jtransformer.decode(jc, p, t, c))
    for step in range(8):
        tok = rng.integers(0, jc.vocab, (B, 1)).astype(np.int32)
        jlog, jcache = jdec(jparams, jnp.asarray(tok), jcache)
        log, cache = transformer.decode(tc, params, torch.from_numpy(tok).long(),
                                        cache)
        assert cache.cur_pos == int(jcache.cur_pos) == S + step + 1
        _rel_close(log, jlog, LOGIT_TOL)


def test_quirk_prefill_cache_is_the_attention_input_kv():
    """The reference projects K/V twice in prefill (attention.forward and
    attention.prefill, on the same normed input); the port keeps that
    structure, and layer 0's cache equals the reference's bit for bit."""
    jc, tc = _configs("gemma3-1b")
    jparams = jtransformer.init_params(jc, jax.random.PRNGKey(2))
    params = _t(jparams)
    toks = np.random.default_rng(3).integers(0, jc.vocab, (2, 30)).astype(np.int32)
    _, jcache = jtransformer.prefill(jc, jparams, jnp.asarray(toks), 32)
    _, cache = transformer.prefill(tc, params, torch.from_numpy(toks).long(), 32)
    np.testing.assert_array_equal(_np(cache.entries[0].k[0]),
                                  _np(jcache.entries[0].k[0]))
    p0 = transformer.layer(params["segments"][0], 0)
    h = transformer.norm_apply(tc, p0["norm1"], transformer.embed_tokens(
        tc, params, torch.from_numpy(toks).long()))
    again = attention.prefill(p0["attn"], h, torch.arange(30), 32)
    assert torch.equal(again.k, cache.entries[0].k[0])


def test_unsupported_configs_raise():
    cfg = get_config("gemma3-1b").smoke()
    ssm = dataclasses.replace(cfg, segments=(dataclasses.replace(
        cfg.segments[0], kind="ssm"),))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.init_params(ssm, torch.Generator(), device="meta")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        transformer.init_params(dataclasses.replace(cfg, n_experts=4, top_k=2),
                                torch.Generator(), device="meta")
