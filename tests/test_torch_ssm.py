"""The port's recurrent blocks against the reference on the same inputs:
``scan.linear_scan`` against ``jax.lax.associative_scan`` with the
reference's combine, the Mamba block (``ssm``) and the RG-LRU block
(``rglru``), with and without a carried state, and their decode steps.
Parameters come from the reference's ``init`` through
``from_jax_params``; inputs are made with numpy.

Tolerances.  The scan runs in f32 in both packages, the same recurrence
in other association orders: within ``SCAN_TOL`` = 1e-5 of the largest
|h| (f32 rounding, 2^-24, over about 2 log2(S) rounds).  The blocks work
in bf16 around that f32 scan and round in slightly different places
(PyTorch computes a bf16 SiLU in f32 and rounds once), so they are held
to ``MODULE_TOL`` = 1e-2 of the output's largest magnitude, a bf16 ulp
or two, as in ``tests/test_torch_lm.py``; the carried f32 states to the
same limit, since they are sums of those bf16 inputs."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.models.lm import rglru as jrglru
from repro.models.lm import ssm as jssm
from repro_torch.models.lm import rglru, scan, ssm
from repro_torch.weights import from_jax_params

SCAN_TOL = 1e-5
MODULE_TOL = 1e-2
D, DI, N, R = 64, 128, 8, 8


def _t(x):
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


def _x(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32)
                       ).astype(jnp.bfloat16)


def _ref_scan(g, u, axis):
    def combine(a, b):
        ga, ua = a
        gb, ub = b
        return (ga * gb, ub + gb * ua)
    return jax.lax.associative_scan(combine, (g, u), axis=axis)[1]


# ---------------------------------------------------------------------------
# scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 2, 3, 7, 1000])
def test_scan_equals_associative_scan(S):
    rng = np.random.default_rng(S)
    g = rng.uniform(0.5, 1.0, (2, S, 3, 4)).astype(np.float32)
    u = rng.standard_normal((2, S, 3, 4)).astype(np.float32)
    want = _ref_scan(jnp.asarray(g), jnp.asarray(u), 1)
    got = scan.linear_scan(torch.from_numpy(g), torch.from_numpy(u), dim=1)
    assert got.dtype == torch.float32
    _rel_close(got, want, SCAN_TOL)


def test_scan_is_the_recurrence():
    """h_t = g_t h_{t-1} + u_t, checked step by step in float64, along a
    middle and a last axis."""
    rng = np.random.default_rng(0)
    g = rng.uniform(0.0, 1.2, (3, 13, 5))
    u = rng.standard_normal((3, 13, 5))
    for dim in (1, 2):
        got = scan.linear_scan(torch.from_numpy(g), torch.from_numpy(u), dim=dim)
        gm, um = np.moveaxis(g, dim, 0), np.moveaxis(u, dim, 0)
        h, want = np.zeros_like(um[0]), []
        for t in range(gm.shape[0]):
            h = gm[t] * h + um[t]
            want.append(h)
        np.testing.assert_allclose(np.moveaxis(got.numpy(), dim, 0),
                                   np.stack(want), rtol=1e-12, atol=1e-12)


def test_scan_is_differentiable():
    """Its gradients equal those of the step-by-step recurrence."""
    rng = np.random.default_rng(1)
    g0 = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 9, 3)))
    u0 = torch.from_numpy(rng.standard_normal((2, 9, 3)))
    grads = []
    for fast in (True, False):
        g, u = g0.clone().requires_grad_(), u0.clone().requires_grad_()
        if fast:
            hs = scan.linear_scan(g, u, dim=1)
        else:
            h, steps = torch.zeros_like(u[:, 0]), []
            for t in range(9):
                h = g[:, t] * h + u[:, t]
                steps.append(h)
            hs = torch.stack(steps, dim=1)
        (hs * torch.arange(27.0, dtype=hs.dtype).reshape(1, 9, 3)).sum().backward()
        grads.append((g.grad, u.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_scan_launches_grow_with_log_depth(monkeypatch):
    """No loop over the sequence: the number of multiplies grows with
    log2(S), not S."""
    counts = {}
    real = torch.Tensor.__mul__
    for S in (64, 4096):
        n = [0]

        def mul(a, b, n=n):
            n[0] += 1
            return real(a, b)

        monkeypatch.setattr(torch.Tensor, "__mul__", mul)
        scan.linear_scan(torch.ones(1, S), torch.ones(1, S), dim=1)
        monkeypatch.setattr(torch.Tensor, "__mul__", real)
        counts[S] = n[0]
    assert counts[4096] <= counts[64] + 3 * 6


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ssm_params():
    jp = jssm.init(jax.random.PRNGKey(0), D, DI, N, R)
    return jp, _t(jp)


def test_ssm_init_tree_equals_reference(ssm_params):
    jp, p = ssm_params
    got = ssm.init(torch.Generator().manual_seed(0), D, DI, N, R, device="cpu")
    for name, a, b in zip(jssm.SSMParams._fields, jp, got):
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(b.dtype).split(".")[-1] == np.asarray(a).dtype.name, name
    # the deterministic leaves are equal (a_log to the f32 log's last ulp)
    for name in ("conv_b", "dt_bias", "d_skip"):
        np.testing.assert_array_equal(_np(getattr(got, name)),
                                      _np(getattr(jp, name)), err_msg=name)
    np.testing.assert_allclose(got.a_log.numpy(), np.asarray(jp.a_log),
                               rtol=2e-7)


def test_ssm_forward(ssm_params):
    jp, p = ssm_params
    x = _x((2, 40, D), 1)
    jy, jst = jssm.forward(jp, x)
    y, st = ssm.forward(p, _t(x))
    assert y.dtype == torch.bfloat16 and st.h.dtype == torch.float32
    _rel_close(y, jy, MODULE_TOL)
    _rel_close(st.h, jst.h, MODULE_TOL)
    np.testing.assert_array_equal(_np(st.conv), _np(jst.conv))


def test_ssm_forward_with_a_carried_state(ssm_params):
    """A prompt in two pieces: the second carries the first's state."""
    jp, p = ssm_params
    x = _x((2, 30, D), 2)
    _, jst = jssm.forward(jp, x[:, :20])
    jy, jst2 = jssm.forward(jp, x[:, 20:], jst)
    y, st2 = ssm.forward(p, _t(x[:, 20:]), _t(jst))
    _rel_close(y, jy, MODULE_TOL)
    _rel_close(st2.h, jst2.h, MODULE_TOL)
    np.testing.assert_array_equal(_np(st2.conv), _np(jst2.conv))
    # and the carried state continues the sequence, as one pass would
    whole, _ = ssm.forward(p, _t(x))
    _rel_close(y, whole[:, 20:], MODULE_TOL)


def test_ssm_decode_steps(ssm_params):
    jp, p = ssm_params
    x = _x((2, 12, D), 3)
    jst = jssm.init_state(2, DI, N)
    st = ssm.init_state(2, DI, N, device="cpu")
    np.testing.assert_array_equal(_np(st.h), _np(jst.h))
    ys, jys = [], []
    for t in range(12):
        jy, jst = jssm.decode_step(jp, x[:, t:t + 1], jst)
        y, st = ssm.decode_step(p, _t(x[:, t:t + 1]), st)
        ys.append(y)
        jys.append(jy)
    # the 12 steps' outputs as one (B, 12, D) output
    _rel_close(torch.cat(ys, dim=1), jnp.concatenate(jys, axis=1), MODULE_TOL)
    _rel_close(st.h, jst.h, MODULE_TOL)


def test_ssm_conv_adds_taps_in_bf16(ssm_params):
    """The causal conv sums its 4 taps one after another in bf16, as the
    reference: bit-equal to it, where one f32 sum rounded once is not."""
    jp, p = ssm_params
    x = _x((2, 50, DI), 4, scale=3.0)
    want = jssm._causal_depthwise_conv(x, jp.conv_w, jp.conv_b)
    got = ssm._causal_depthwise_conv(_t(x), p.conv_w, p.conv_b)
    np.testing.assert_array_equal(_np(got), _np(want))
    once = torch.nn.functional.conv1d(
        torch.nn.functional.pad(_t(x).float().transpose(1, 2), (3, 0)),
        p.conv_w.float().T.flip(1)[:, None, :], groups=DI).transpose(1, 2)
    assert not np.array_equal(_np(once.to(torch.bfloat16)), _np(want))


def test_ssm_softplus_is_logaddexp():
    """dt's softplus is ``jax.nn.softplus``, logaddexp(x, 0) in f32; the
    port computes the same expression (not ``F.softplus``, which switches
    to x above a threshold) and agrees with it over dt's range to the
    last ulp of the two libraries' f32 exp and log1p."""
    v = np.linspace(-40.0, 40.0, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(v)))
    t = torch.from_numpy(v)
    np.testing.assert_allclose(torch.logaddexp(t, torch.zeros_like(t)).numpy(),
                               want, rtol=2.4e-7, atol=0)


def test_quirk_left_padding_enters_the_ssm_state(ssm_params):
    """The server left-pads prompts with token 0, and a recurrent block has
    no mask: the pads' embeddings run through the recurrence, so a padded
    prompt's output differs from the unpadded one's, in both packages."""
    jp, p = ssm_params
    x = _x((1, 16, D), 5)
    pad = jnp.broadcast_to(_x((1, 1, D), 6), (1, 4, D))
    jy, _ = jssm.forward(jp, jnp.concatenate([pad, x], axis=1))
    jy0, _ = jssm.forward(jp, x)
    y, _ = ssm.forward(p, _t(jnp.concatenate([pad, x], axis=1)))
    _rel_close(y, jy, MODULE_TOL)
    assert float(np.abs(_np(jy)[:, 4:] - _np(jy0)).max()) > 1e-3


# ---------------------------------------------------------------------------
# the RG-LRU block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rec_params():
    jp = jrglru.init(jax.random.PRNGKey(1), D, DI)
    return jp, _t(jp)


def test_rglru_forward(rec_params):
    jp, p = rec_params
    x = _x((2, 40, D), 7)
    jy, jst = jrglru.forward(jp, x)
    y, st = rglru.forward(p, _t(x))
    assert y.dtype == torch.bfloat16 and st.h.dtype == torch.float32
    _rel_close(y, jy, MODULE_TOL)
    _rel_close(st.h, jst.h, MODULE_TOL)
    np.testing.assert_array_equal(_np(st.conv), _np(jst.conv))


def test_rglru_forward_with_a_carried_state(rec_params):
    jp, p = rec_params
    x = _x((2, 30, D), 8)
    _, jst = jrglru.forward(jp, x[:, :25])
    jy, jst2 = jrglru.forward(jp, x[:, 25:], jst)
    y, st2 = rglru.forward(p, _t(x[:, 25:]), _t(jst))
    _rel_close(y, jy, MODULE_TOL)
    _rel_close(st2.h, jst2.h, MODULE_TOL)
    whole, _ = rglru.forward(p, _t(x))
    _rel_close(y, whole[:, 25:], MODULE_TOL)


def test_rglru_decode_steps(rec_params):
    jp, p = rec_params
    x = _x((2, 10, D), 9)
    jst = jrglru.init_state(2, DI)
    st = rglru.init_state(2, DI, device="cpu")
    ys, jys = [], []
    for t in range(10):
        jy, jst = jrglru.forward(jp, x[:, t:t + 1], jst)
        y, st = rglru.forward(p, _t(x[:, t:t + 1]), st)
        ys.append(y)
        jys.append(jy)
    _rel_close(torch.cat(ys, dim=1), jnp.concatenate(jys, axis=1), MODULE_TOL)
    _rel_close(st.h, jst.h, MODULE_TOL)


def test_rglru_scan_keeps_the_clamp(rec_params):
    """sqrt(max(1 - a^2, 1e-12)): with Lambda large, a = sigmoid(Lambda)^(8r)
    rounds to 1 in f32 and the input weight is sqrt(1e-12), not 0 — in
    both packages."""
    jp, p = rec_params
    lam = jnp.full((DI,), 30.0, jnp.float32)
    x = _x((1, 5, DI), 10)
    r = jnp.full((1, 5, DI), 1e-3, jnp.float32)
    i = jnp.ones((1, 5, DI), jnp.float32)
    jy, jh = jrglru._rglru_scan(x, r, i, lam, None)
    y, h = rglru._rglru_scan(_t(x), _t(r), _t(i), _t(lam), None)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-6)
    # h_5 = sum of the 5 inputs times sqrt(1e-12): small, and not zero
    bound = 5 * 1e-6 * float(np.abs(_np(x)).max()) * (1 + 1e-5)
    assert 0 < float(np.abs(h.numpy()).max()) <= bound


def test_rglru_init_tree_equals_reference(rec_params):
    jp, _ = rec_params
    got = rglru.init(torch.Generator().manual_seed(0), D, DI, device="cpu")
    for name, a, b in zip(jrglru.RGLRUParams._fields, jp, got):
        assert tuple(a.shape) == tuple(b.shape), name
        assert str(b.dtype).split(".")[-1] == np.asarray(a).dtype.name, name
    np.testing.assert_array_equal(got.lam.numpy(), np.asarray(jp.lam))
