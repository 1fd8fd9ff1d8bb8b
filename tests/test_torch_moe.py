"""The port's MoE layer (``repro_torch.models.lm.moe``) against the
reference's ``repro.models.lm.moe`` on the same inputs: parameters from
the reference's ``init`` through ``from_jax_params``, inputs made with
numpy.

Tolerances.  ``route`` is held ``==`` on the experts: both packages
compute the router logits from the same bf16 input in f32, so only an
exact tie could order them differently, and ties go to the lower expert
in both (held on exact ties below).  ``forward`` and ``dense_forward``
work in bf16 and round in slightly different places (PyTorch computes
the bf16 SiLU/GeLU in f32 and rounds once), so they are held to
``MODULE_TOL`` = 1e-2 of the output's largest magnitude, a bf16 ulp or
two (2^-8 of the magnitude), as in ``tests/test_torch_lm.py``."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.models.lm import moe as jmoe
from repro_torch.models.lm import moe
from repro_torch.weights import from_jax_params

MODULE_TOL = 1e-2


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


def _x(shape, seed):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                       ).astype(jnp.bfloat16)


def _params(seed, d=64, f=96, e=8):
    return jmoe.init(jax.random.PRNGKey(seed), d, f, e)


@pytest.mark.parametrize("S", [1, 7, 40])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_capacity_equals_reference(S, top_k):
    for e in (4, 8, 40, 128):
        for cf in (0.25, 1.0, 1.25, 2.0):
            assert moe.capacity(S, e, top_k, cf) == jmoe.capacity(S, e, top_k, cf)


def test_route_equals_reference():
    p = _params(0)
    x = _x((3, 50, 64), 1)
    jg, je = jmoe.route(p, x, 2)
    g, e = moe.route(_t(p), _t(x), 2)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)


def test_top_k_on_exact_ties():
    """``jax.lax.top_k``'s order on ties: sorted descending, the lower
    index first.  Rows of repeated values, in f32 router logits."""
    rows = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0],
                     [0.5, 0.5, 0.5, 0.5, 0.5, 0.5],
                     [-1.0, 2.0, -1.0, 2.0, -1.0, 2.0],
                     [0.0, -0.0, 1.0, 1.0, -2.0, 1.0]], np.float32)
    for k in (1, 2, 3, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        v, i = moe._top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    # the same ties through route: an identity router turns x into logits
    p = jmoe.MoEParams(jnp.eye(6, dtype=jnp.float32), *(jnp.zeros((6, 6, 2)),) * 3)
    x = jnp.asarray(rows[None]).astype(jnp.bfloat16)
    np.testing.assert_array_equal(moe.route(_t(p), _t(x), 3)[1].numpy(),
                                  np.asarray(jmoe.route(p, x, 3)[1]))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("B,S", [(2, 40), (1, 1), (3, 7)])
def test_forward_equals_reference(act, B, S):
    p = _params(2)
    x = _x((B, S, 64), 3)
    want = jmoe.forward(p, x, 2, 1.25, act)
    got = moe.forward(_t(p), _t(x), 2, 1.25, act)
    assert got.dtype == torch.bfloat16
    _rel_close(got, want, MODULE_TOL)


def test_forward_drops_with_a_small_capacity_factor():
    """cf 0.25 at S = 40, k = 2, E = 8: C = 3 slots per expert for 80
    (token, choice) pairs, so most choices drop (their gate weight is 0);
    the port drops the same ones."""
    p = _params(4)
    x = _x((2, 40, 64), 5)
    C = moe.capacity(40, 8, 2, 0.25)
    assert C == 3
    want = jmoe.forward(p, x, 2, 0.25)
    got = moe.forward(_t(p), _t(x), 2, 0.25)
    _rel_close(got, want, MODULE_TOL)
    # tokens whose every choice dropped get exactly zero in both packages
    zero_t = (_np(got) == 0).all(-1)
    zero_j = (_np(want) == 0).all(-1)
    assert zero_t.any()
    np.testing.assert_array_equal(zero_t, zero_j)
    # with no drops the capacity path equals the dense oracle
    full = moe.forward(_t(p), _t(x), 2, 100.0)
    _rel_close(full, moe.dense_forward(_t(p), _t(x), 2), MODULE_TOL)


def test_groups_split_long_sequences(monkeypatch):
    """S a multiple of GROUP routes each group separately; S not a multiple
    is one group.  GROUP is cut to 8 in both packages to see both cases at
    test size."""
    monkeypatch.setattr(jmoe, "GROUP", 8)
    monkeypatch.setattr(moe, "GROUP", 8)
    p = _params(6)
    for S in (24, 20):
        x = _x((2, S, 64), 7 + S)
        _rel_close(moe.forward(_t(p), _t(x), 2, 1.0),
                   jmoe.forward(p, x, 2, 1.0), MODULE_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_dense_forward_equals_reference(act):
    p = _params(8)
    x = _x((2, 12, 64), 9)
    _rel_close(moe.dense_forward(_t(p), _t(x), 2, act),
               jmoe.dense_forward(p, x, 2, act), MODULE_TOL)


def test_quirk_decode_capacity_is_k_slots_per_expert(monkeypatch):
    """At decode (S = 1) the capacity is max(ceil(k/E cf), k) = k: every
    expert runs k slot rows per sequence, filled or not.  granite-moe's
    40 experts, top-8: 8 slots, 320 slot rows for one token."""
    assert moe.capacity(1, 40, 8, 1.25) == jmoe.capacity(1, 40, 8, 1.25) == 8
    p = _t(_params(10, e=4))
    seen = []
    real = torch.einsum

    def spy(eq, *ops):
        if eq == "becd,edf->becf":
            seen.append(tuple(ops[0].shape))
        return real(eq, *ops)

    monkeypatch.setattr(torch, "einsum", spy)
    moe.forward(p, _t(_x((3, 1, 64), 11)), 2)
    assert seen == [(3, 4, 2, 64)] * 2


def test_forward_is_differentiable():
    """Gradients reach every parameter through the gathers (the router via
    the gates)."""
    p = _t(_params(12))
    leaves = [t.float().requires_grad_() for t in p]
    x = _t(_x((2, 16, 64), 13)).float()
    out = moe.forward(moe.MoEParams(*leaves), x, 2)
    out.square().sum().backward()
    assert all(t.grad is not None and t.grad.abs().max() > 0 for t in leaves)
