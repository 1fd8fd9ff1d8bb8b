"""The port's flash attention on the CPU: the plain version behind
``ops.attention`` against the reference's ``ref.flash_attention_ref`` and
against the Pallas kernel in interpret mode, at ``tests/test_kernels.py``'s
shapes, windows, softcap, padding and dtypes plus gemma3-1b's head
dimension (288); a Python model of the CUDA kernel's tiling (key-tile
skipping, -1e30 masking, online softmax) against the plain version; a
numpy model of the tensor-core instance's arithmetic (bf16 products, P
split into two bf16 terms, f32 sums, its tiles) against the plain version,
and why P is split; the shared-memory layouts and the dispatch rule of the
two instances; and the wrapper's checks.  The CUDA kernel itself runs only
on the card, where ``chip_smoke.py`` holds it against the plain version.

Tolerances are ``tests/test_kernels.py``'s: 2e-4 for float32 inputs (the
same math summed in another order), 2e-2 for bfloat16 inputs where one
side rounds the logits to bfloat16 and the other does not."""

import ast
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.configs import GLOBAL_WINDOW
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.weights import from_jax_params

F32_TOL = 2e-4
BF16_TOL = 2e-2


def _qkv(shape, seed, scale=1.0, kv_heads=None):
    """f32 numpy q, k, v; k/v with ``kv_heads`` heads if given."""
    rng = np.random.default_rng(seed)
    B, H, S, hd = shape
    kv_shape = (B, kv_heads or H, S, hd)
    q = scale * rng.standard_normal(shape)
    k = scale * rng.standard_normal(kv_shape)
    v = rng.standard_normal(kv_shape)
    return [a.astype(np.float32) for a in (q, k, v)]


def _as(arrs, dtype):
    """The same values as jax arrays of ``dtype`` and as CPU tensors (bf16
    carried bit for bit)."""
    j = [jnp.asarray(a).astype(dtype) for a in arrs]
    return j, from_jax_params(j, device="cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _check(shape, seed, *, causal=True, window=None, softcap=None, scale=1.0,
           pallas=True):
    (jq, jk, jv), (q, k, v) = _as(_qkv(shape, seed, scale), jnp.float32)
    got = ops.attention(q, k, v, causal=causal, window=window, softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == shape
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window,
                                    softcap=softcap)
    _close(got, want, F32_TOL)
    if pallas:
        kern = pallas_flash(jq, jk, jv, causal=causal, window=window,
                            softcap=softcap, bq=64, bk=64, interpret=True)
        _close(got, kern, F32_TOL)


@pytest.mark.parametrize("B,H,S,hd", [
    (1, 2, 128, 64), (2, 4, 256, 32), (1, 1, 384, 128), (2, 2, 100, 64),
    (1, 2, 96, 288),
])
def test_causal_matches_reference(B, H, S, hd):
    _check((B, H, S, hd), S + hd)


@pytest.mark.parametrize("window", [32, 128])
def test_sliding_window(window):
    _check((1, 2, 256, 64), window, window=window)


def test_softcap():
    _check((1, 2, 128, 64), 5, softcap=50.0, scale=3.0)


def test_non_causal_with_padding():
    """S not a multiple of the block: padded keys must be masked."""
    _check((1, 1, 100, 32), 9, causal=False)


def test_window_at_head_dim_288():
    """gemma3-1b's head dimension under a window shorter than S."""
    _check((1, 1, 160, 288), 11, window=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_sweep(dtype):
    dt = jnp.dtype(dtype)
    (jq, jk, jv), (q, k, v) = _as(_qkv((1, 2, 128, 64), 3), dt)
    got = ops.attention(q, k, v, causal=True)
    assert got.dtype == torch.float32
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    # the reference's plain version on the same inputs (its einsum in bf16)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=True), tol)
    # the Pallas kernel does f32 math on bf16 inputs: the port's plain
    # version fed the f32 upcast of the same values matches it tightly
    kern = pallas_flash(jq, jk, jv, causal=True, bq=64, bk=64, interpret=True)
    _close(got, kern, tol)
    up = ops.attention(q.float(), k.float(), v.float(), causal=True)
    _close(up, kern, F32_TOL)


def test_global_window_equals_none():
    _, (q, k, v) = _as(_qkv((1, 2, 80, 16), 4), jnp.float32)
    a = ops.attention(q, k, v, causal=True, window=None)
    b = ops.attention(q, k, v, causal=True, window=GLOBAL_WINDOW)
    assert torch.equal(a, b)


@pytest.mark.parametrize("kv_heads", [1, 2])
def test_kv_head_groups(kv_heads):
    """K/V with fewer heads: head h reads KV head h // (H // KV), which is
    the reference's ``jnp.repeat`` expansion."""
    H = 4
    arrs = _qkv((2, H, 70, 16), 6, kv_heads=kv_heads)
    (jq, jk, jv), (q, k, v) = _as(arrs, jnp.float32)
    got = ops.attention(q, k, v, causal=True, window=32)
    rep = H // kv_heads
    want = jref.flash_attention_ref(jq, jnp.repeat(jk, rep, axis=1),
                                    jnp.repeat(jv, rep, axis=1), causal=True,
                                    window=32)
    _close(got, want, F32_TOL)
    expanded = ops.attention(q, k.repeat_interleave(rep, 1),
                             v.repeat_interleave(rep, 1), causal=True, window=32)
    assert torch.equal(got, expanded)


# ---------------------------------------------------------------------------
# the CUDA kernel's tiling, modelled in Python
# ---------------------------------------------------------------------------

def _kernel_model(q, k, v, causal, window, softcap):
    """The loop of ``csrc/flash_attention.cu`` in float64 numpy: 64-row
    query tiles, 32-row key tiles from ``k_begin`` (rounded down to a tile)
    to ``k_end``, masked logits -1e30, online softmax, denominator clamped
    at 1e-30.  Checks that skipping key tiles changes nothing."""
    B, H, S, hd = q.shape
    group = H // k.shape[1]
    win = fa.NO_WINDOW if window is None else window
    out = np.zeros(q.shape)
    for b in range(B):
        for h in range(H):
            kb, vb = k[b, h // group], v[b, h // group]
            for q0 in range(0, S, fa.BQ):
                rows = np.arange(q0, min(q0 + fa.BQ, S))
                q_last = rows[-1]
                k_end = q_last + 1 if causal else S
                k_begin = max(0, q0 - win + 1)
                m = np.full(len(rows), -1e30)
                l = np.zeros(len(rows))
                acc = np.zeros((len(rows), hd))
                for k0 in range(k_begin // fa.BK * fa.BK, k_end, fa.BK):
                    cols = np.arange(k0, k0 + fa.BK)
                    kt = np.where((cols < S)[:, None], kb[np.minimum(cols, S - 1)], 0)
                    vt = np.where((cols < S)[:, None], vb[np.minimum(cols, S - 1)], 0)
                    s = q[b, h, rows] @ kt.T / math.sqrt(hd)
                    if softcap is not None:
                        s = np.tanh(s / softcap) * softcap
                    d = rows[:, None] - cols[None, :]
                    ok = (cols < S)[None, :] & (d < win)
                    if causal:
                        ok &= d >= 0
                    s = np.where(ok, s, -1e30)
                    m_new = np.maximum(m, s.max(axis=1))
                    p = np.exp(s - m_new[:, None])
                    corr = np.exp(m - m_new)
                    l = l * corr + p.sum(axis=1)
                    acc = acc * corr[:, None] + p @ vt
                    m = m_new
                out[b, h, rows] = acc / np.maximum(l, 1e-30)[:, None]
    return out


@pytest.mark.parametrize("shape,kv,causal,window,softcap", [
    ((1, 2, 200, 16), 2, True, 48, None),     # window bites, ragged S
    ((1, 4, 161, 16), 1, True, None, None),   # MQA, global, S % 32 = 1
    ((2, 1, 100, 32), 1, False, None, None),  # non-causal, padded keys
    ((1, 2, 130, 16), 1, False, 40, 50.0),    # non-causal window, softcap
    ((1, 1, 300, 8), 1, True, 1, None),       # window 1: the diagonal only
])
def test_kernel_tiling_model(shape, kv, causal, window, softcap):
    q, k, v = _qkv(shape, 21, kv_heads=kv)
    got = _kernel_model(q.astype(np.float64), k.astype(np.float64),
                        v.astype(np.float64), causal, window, softcap)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window,
                                   softcap=softcap)
    np.testing.assert_allclose(got, want.numpy(), rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def test_wrapper_takes_cuda_tensors_only():
    _, (q, k, v) = _as(_qkv((1, 1, 8, 16), 1), jnp.float32)
    before = fa.flash_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)
    assert fa.flash_attention.launches == before
    ops.attention(q, k, v)          # the CPU path never counts a launch
    assert fa.flash_attention.launches == before


@pytest.mark.parametrize("hd", [8, 16, 17, 32, 64, 100, 128, 288, 512])
def test_shared_memory_layout(hd):
    """Rows are padded to an odd number of 32-bit words (16 rows read at
    one column hit 16 banks), and gemma3-1b's hd fits in both dtypes."""
    for elem in (2, 4):
        stride = fa.smem_stride(hd, elem)
        assert stride >= hd and (stride * elem) % 4 == 0
        assert (stride * elem // 4) % 2 == 1, (hd, elem, stride)
    assert fa.smem_bytes(288, 4) <= fa.MAX_SMEM_BYTES
    assert fa.smem_bytes(288, 2) <= fa.MAX_SMEM_BYTES // 2


# ---------------------------------------------------------------------------
# the tensor-core instance: its arithmetic modelled in numpy, its layout and
# the dispatch rule
# ---------------------------------------------------------------------------

CU_SOURCE = Path(fa.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu"


def _bf16(x):
    """float32 -> the nearest bfloat16 value (ties to even), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _tc_model(q, k, v, causal, window, softcap, split=True):
    """The tensor-core instance's loop in float32 numpy on bf16-valued
    inputs: TC_BQ-row query tiles, TC_BK-row key tiles from ``k_begin``
    (rounded down to a tile) to ``k_end``, logits as f32 sums of exact
    bf16 products, masked logits -1e30, online softmax in f32, and P.V as
    hi.V + lo.V with hi = bf16(p), lo = bf16(p - hi) (only hi.V when not
    ``split``), denominator clamped at 1e-30."""
    B, H, S, hd = q.shape
    group = H // k.shape[1]
    win = fa.NO_WINDOW if window is None else window
    scale = np.float32(1.0 / math.sqrt(hd))
    neg = np.float32(-1e30)
    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        for h in range(H):
            kb, vb = k[b, h // group], v[b, h // group]
            for q0 in range(0, S, fa.TC_BQ):
                rows = np.arange(q0, min(q0 + fa.TC_BQ, S))
                k_end = rows[-1] + 1 if causal else S
                k_begin = max(0, q0 - win + 1)
                m = np.full(len(rows), neg, np.float32)
                l = np.zeros(len(rows), np.float32)
                acc = np.zeros((len(rows), hd), np.float32)
                for k0 in range(k_begin // fa.TC_BK * fa.TC_BK, k_end, fa.TC_BK):
                    cols = np.arange(k0, k0 + fa.TC_BK)
                    pad = (cols < S)[:, None]
                    kt = np.where(pad, kb[np.minimum(cols, S - 1)], 0).astype(np.float32)
                    vt = np.where(pad, vb[np.minimum(cols, S - 1)], 0).astype(np.float32)
                    s = (q[b, h, rows] @ kt.T) * scale
                    if softcap is not None:
                        sc = np.float32(softcap)
                        s = np.tanh(s / sc) * sc
                    d = rows[:, None] - cols[None, :]
                    ok = (cols < S)[None, :] & (d < win)
                    if causal:
                        ok &= d >= 0
                    s = np.where(ok, s, neg).astype(np.float32)
                    m_new = np.maximum(m, s.max(axis=1))
                    p = np.exp(s - m_new[:, None])
                    corr = np.exp(m - m_new)
                    l = l * corr + p.sum(axis=1, dtype=np.float32)
                    hi = _bf16(p)
                    pv = hi @ vt
                    if split:
                        pv = pv + _bf16(p - hi) @ vt
                    acc = acc * corr[:, None] + pv
                    m = m_new
                out[b, h, rows] = acc / np.maximum(l, np.float32(1e-30))[:, None]
    return out


def _bf16_qkv(shape, seed, kv_heads, scale=1.0):
    return [_bf16(a) for a in _qkv(shape, seed, scale, kv_heads=kv_heads)]


def _plain_f32(q, k, v, **kw):
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    return ref.flash_attention_ref(tq, tk, tv, **kw).numpy()


@pytest.mark.parametrize("shape,kv,causal,window,softcap,scale", [
    ((1, 2, 160, 288), 2, True, 64, None, 1.0),   # gemma3-1b's hd, window
    ((1, 4, 150, 288), 1, True, None, None, 1.0),  # MQA, ragged S
    ((1, 2, 97, 288), 1, True, 64, 50.0, 3.0),     # softcap, ragged S
    ((2, 4, 70, 64), 2, False, None, None, 1.0),   # GQA, non-causal, pads
    ((1, 2, 130, 128), 1, False, 40, 2.0, 1.0),    # non-causal window
])
def test_tensor_core_model(shape, kv, causal, window, softcap, scale):
    q, k, v = _bf16_qkv(shape, 31, kv, scale)
    got = _tc_model(q, k, v, causal, window, softcap)
    want = _plain_f32(q, k, v, causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_split_probabilities_are_needed():
    """At hd 288 a single bf16 term for P misses the 2e-4 check against
    the f32 plain version (bf16 keeps 8 significant bits of p); hi + lo
    holds it.  This is why the kernel runs two mma for P.V."""
    q, k, v = _bf16_qkv((1, 2, 128, 288), 41, 1)
    want = _plain_f32(q, k, v, causal=True)
    single = np.abs(_tc_model(q, k, v, True, None, None, split=False) - want).max()
    split = np.abs(_tc_model(q, k, v, True, None, None) - want).max()
    assert single > F32_TOL, single
    assert split <= F32_TOL / 10, split


@pytest.mark.parametrize("hd", [8, 16, 17, 32, 64, 100, 128, 256, 288])
def test_tc_shared_memory_layout(hd):
    """Rows of the tensor-core instance are 16-byte aligned for ldmatrix,
    an odd number of 16-byte chunks long, so the 8 rows one ldmatrix phase
    reads at a column fall in 8 distinct 16-byte bank groups (of the 8 in
    a 128-byte bank row); gemma3-1b's hd fits in a block's shared
    memory."""
    stride = fa.tc_smem_stride(hd)
    width = 16 * fa.tc_steps(hd)
    assert width >= hd and stride >= width
    assert (stride * 2) % 16 == 0
    chunks = stride * 2 // 16
    assert chunks % 2 == 1
    for col_chunk in range(width // 8):
        groups = {(r * chunks + col_chunk) % 8 for r in range(8)}
        assert len(groups) == 8, (hd, col_chunk)
    assert fa.tc_smem_bytes(288) <= fa.MAX_SMEM_BYTES


def _cu_int(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CU_SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def test_dispatch_rule_and_mirror():
    """bf16 within the register plan goes to the tensor cores, f32 and
    wider bf16 to the CUDA cores; the Python constants mirror the CUDA
    source's, and the choice depends on dtype and hd only: no ``try`` in
    the wrapper or in ``ops`` gives way to another instance or the plain
    version."""
    for hd in (64, 128, 288, 16, 100):
        assert fa.uses_tensor_cores(torch.bfloat16, hd)
    for hd in (16, 64, 128, 288, 512):
        assert not fa.uses_tensor_cores(torch.float32, hd)
    for hd in (289, 320, 512):
        assert not fa.uses_tensor_cores(torch.bfloat16, hd)
    assert not fa.uses_tensor_cores(torch.float16, 64)
    assert _cu_int("kTcMaxHeadDim") == fa.TC_MAX_HEAD_DIM
    assert (_cu_int("kTcBQ"), _cu_int("kTcBK")) == (fa.TC_BQ, fa.TC_BK)
    assert (_cu_int("kBQ"), _cu_int("kBK")) == (fa.BQ, fa.BK)
    src = CU_SOURCE.read_text()
    body = src[src.index("inline int tc_steps(int hd)"):]
    body = body[:body.index("}")]
    steps = [int(x) for x in re.findall(r"\? (\d+)", body)]
    steps.append(int(re.search(r": (\d+);", body).group(1)))
    for hd in range(1, fa.TC_MAX_HEAD_DIM + 1):
        ks = -(-hd // 16)
        assert fa.tc_steps(hd) == next(s for s in steps if ks <= s), hd
    for mod in (fa, ops):
        tree = ast.parse(Path(mod.__file__).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), mod
    assert set(fa.flash_attention.instance_launches) == {fa.TENSOR_CORE,
                                                         fa.CUDA_CORE}
