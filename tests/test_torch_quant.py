"""The port's INT8 quantization against ``repro.models.quant``: quantized
values, scales and integer accumulators bit-equal, f32 outputs
array_equal, on the same numpy inputs."""

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.models import quant as jquant
from repro_torch.models import quant


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("shape,axis", [((3, 3, 8, 16), -1), ((64, 10), -1),
                                        ((1, 1, 5, 7), -1), ((16, 4), 0)])
def test_quantize_weight(shape, axis):
    w = _np(shape, 1, 0.3)
    want = jquant.quantize_weight(jnp.asarray(w), channel_axis=axis)
    got = quant.quantize_weight(torch.from_numpy(w), channel_axis=axis)
    assert got.q.dtype == torch.int8
    _eq(want.q, got.q)
    _eq(want.scale, got.scale)
    _eq(jquant.dequantize(want, axis), quant.dequantize(got, axis))


@pytest.mark.parametrize("given", [False, True])
def test_quantize_act(given):
    x = _np((2, 9, 9, 8), 2, 2.0)
    s = np.float32(0.013)
    want = jquant.quantize_act(jnp.asarray(x), jnp.float32(s) if given else None)
    got = quant.quantize_act(torch.from_numpy(x),
                             torch.tensor(s) if given else None)
    _eq(want.q, got.q)
    _eq(want.scale, got.scale)
    _eq(jquant.act_scale(jnp.asarray(x)), quant.act_scale(torch.from_numpy(x)))


def test_round_half_to_even():
    s = np.float32(0.5)
    x = (np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5], np.float32) * s)
    want = jquant.quantize_act(jnp.asarray(x), jnp.float32(s))
    got = quant.quantize_act(torch.from_numpy(x), torch.tensor(s))
    _eq(want.q, got.q)
    assert got.q.tolist() == [0, 2, 2, 0, -2, 4]


@pytest.mark.parametrize("M,K,N", [(8, 16, 8), (33, 129, 65), (2, 256, 10)])
def test_matmul_accumulator_and_output(M, K, N):
    x, w, b = _np((M, K), 3), _np((K, N), 4, 0.2), _np((N,), 5)
    qx = jquant.quantize_act(jnp.asarray(x))
    qw = jquant.quantize_weight(jnp.asarray(w))
    acc = quant.int8_matmul_acc(torch.tensor(np.asarray(qx.q)),
                                torch.tensor(np.asarray(qw.q)))
    assert acc.dtype == torch.int32
    _eq(jquant.int8_matmul_acc(qx.q, qw.q), acc)
    want = jquant.quantized_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = quant.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b))
    _eq(want, got)


@pytest.mark.parametrize("H,Cin,Cout,k,stride,padding", [
    (8, 4, 8, 3, 1, "SAME"), (16, 8, 16, 3, 2, "SAME"), (32, 3, 16, 3, 1, "SAME"),
    (10, 5, 7, 1, 1, "SAME"), (9, 4, 6, 3, 2, "SAME"), (16, 8, 16, 1, 2, "SAME"),
    (12, 8, 130, 5, 1, "SAME"), (9, 4, 6, 3, 2, "VALID"), (11, 3, 5, 3, 1, "VALID"),
])
def test_conv_accumulator_and_output(H, Cin, Cout, k, stride, padding):
    x = _np((2, H, H, Cin), H + Cout, 1.5)
    w = _np((k, k, Cin, Cout), Cin * Cout, 0.2)
    b = _np((Cout,), k)
    qx = jquant.quantize_act(jnp.asarray(x))
    qw = jquant.quantize_weight(jnp.asarray(w))
    jacc = jax.lax.conv_general_dilated(
        qx.q.astype(jnp.int32), qw.q.astype(jnp.int32),
        window_strides=(stride, stride), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    from repro_torch.kernels import ref
    from repro_torch.models.cnn.layers import conv_pads
    acc = ref.conv2d_acc(torch.tensor(np.asarray(qx.q)),
                         torch.tensor(np.asarray(qw.q)), stride,
                         conv_pads(H, H, k, stride, padding))
    assert acc.dtype == torch.int32
    _eq(jacc, acc)
    want = jquant.quantized_conv2d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), stride=stride, padding=padding)
    got = quant.quantized_conv2d(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), stride=stride,
                                 padding=padding)
    _eq(want, got)


def test_noise_hook_distribution():
    """The AIMC noise is drawn from a torch.Generator, so it is held by its
    distribution: (noisy - clean) / (sx * sw) is N(0, noise_std)."""
    x, w = _np((64, 32), 6), _np((32, 16), 7, 0.3)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    clean = quant.quantized_matmul(tx, tw)
    _eq(jquant.quantized_matmul(jnp.asarray(x), jnp.asarray(w)), clean)
    assert torch.equal(quant.quantized_matmul(tx, tw, noise_std=3.0), clean)
    noisy = quant.quantized_matmul(tx, tw, noise_std=3.0,
                                   generator=torch.Generator().manual_seed(0))
    unit = quant.act_scale(tx) * quant.weight_scale(tw)
    z = ((noisy - clean) / unit).flatten()
    assert abs(z.mean().item()) < 0.3
    assert abs(z.std().item() - 3.0) < 0.3
