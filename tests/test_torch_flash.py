"""The port's flash attention on the CPU: the plain version behind
``ops.attention`` against the reference's ``ref.flash_attention_ref`` and
against the Pallas kernel in interpret mode, at ``tests/test_kernels.py``'s
shapes, windows, softcap, padding and dtypes plus gemma3-1b's head
dimension (288); a Python model of the CUDA kernel's tiling (key-tile
skipping, -1e30 masking, online softmax) against the plain version; a
numpy model of the tensor-core instance's arithmetic (bf16 products, P
split into two bf16 terms, f32 sums, its tiles) against the plain version,
and why P is split; a numpy model of the f32 tensor-core instance's (Q.K^T
as three TF32 products, P.V as three bf16 products) against the plain
version and the reference's, and why both are split; the shared-memory
layouts and the dispatch rule of the three instances; and the wrapper's
checks.  The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it against the plain version.

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

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_flash_holds_to_the_tolerances(dtype):
    """``ref.check_flash``, the card's check of a flash output: the f32
    plain version's own output passes (bf16 inputs also within 2e-2 of
    the plain version in bf16); 3e-4 off it, or a NaN, fails."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 4, 64, 32), generator=g).to(dtype)
               for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   window=16)
    err, err16 = ref.check_flash(want, q, k, v, True, 16, None, "case")
    assert err == 0.0
    assert (err16 is None) == (dtype == torch.float32)
    if err16 is not None:
        assert 0.0 < err16 <= ref.FLASH_BF16_TOL
    bad = want.clone()
    bad[0, 1, 5, 7] += 3e-4
    with pytest.raises(AssertionError, match="case: max"):
        ref.check_flash(bad, q, k, v, True, 16, None, "case")
    bad[0, 1, 5, 7] = float("nan")
    with pytest.raises(AssertionError, match="case: bad output"):
        ref.check_flash(bad, q, k, v, True, 16, None, "case")


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


def _bf16_trunc(x):
    """float32 -> its upper 16 bits (bfloat16 by truncation), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def _tf32(x):
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero: ``cvt.rna.tf32.f32``), as float32."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x1000) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32)


def _split(x, rnd):
    """x -> (hi, lo) with hi = rnd(x), lo = rnd(x - hi)."""
    hi = rnd(x)
    return hi, rnd(x - hi)


def _split3(a, b, rnd):
    """a @ b as three products of split terms in f32: lo.hi + hi.lo + hi.hi
    (lo.lo dropped)."""
    ah, al = _split(a, rnd)
    bh, bl = _split(b, rnd)
    return al @ bh + ah @ bl + ah @ bh


def _tc_loop(q, k, v, causal, window, softcap, logits, pv, bq=None, bk=None,
             packed=False, log2=False):
    """The tensor-core instances' loop in float32 numpy: ``bq``-row query
    tiles (``TC_BQ``), ``bk``-row key tiles (``TC_BK``) from ``k_begin``
    (rounded down to a tile) to ``k_end``, logits ``logits(q_tile,
    k_tile)``, masked logits -1e30, online softmax in f32, ``pv(p,
    v_tile)`` added to the rescaled accumulator, denominator clamped at
    1e-30.  ``packed``: a block's rows are the query heads of one KV head
    packed by position, row ``pr`` being position ``pr // group`` of head
    ``pr % group`` of the group, and the key range is that of the block's
    first and last positions (the wgmma instance).  ``log2``: the logits
    are scaled by ``scale * log2(e)`` (after the softcap, if any),
    exponentiated in base 2 and masked with -inf (the wgmma instance's
    stand-in for -1e30, which gives the same result on every row that has
    a valid key)."""
    bq, bk = bq or fa.TC_BQ, bk or fa.TC_BK
    B, H, S, hd = q.shape
    group = H // k.shape[1]
    pg = group if packed else 1          # query heads packed in a block
    win = fa.NO_WINDOW if window is None else window
    scale = np.float32(1.0 / math.sqrt(hd))
    log2e = np.float32(math.log2(math.e))
    neg = np.float32(-1e30)
    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        for h0 in range(0, H, pg):
            kb, vb = k[b, h0 // group], v[b, h0 // group]
            qp = q[b, h0:h0 + pg].transpose(1, 0, 2).reshape(S * pg, hd)
            for r0 in range(0, S * pg, bq):
                pr = np.arange(r0, min(r0 + bq, S * pg))
                pos = pr // pg
                k_end = pos[-1] + 1 if causal else S
                k_begin = max(0, pos[0] - win + 1)
                m = np.full(len(pr), neg, np.float32)
                l = np.zeros(len(pr), np.float32)
                acc = np.zeros((len(pr), hd), np.float32)
                for k0 in range(k_begin // bk * bk, k_end, bk):
                    cols = np.arange(k0, k0 + bk)
                    pad = (cols < S)[:, None]
                    kt = np.where(pad, kb[np.minimum(cols, S - 1)], 0).astype(np.float32)
                    vt = np.where(pad, vb[np.minimum(cols, S - 1)], 0).astype(np.float32)
                    s = logits(qp[pr], kt.T)
                    if softcap is not None:
                        sc = np.float32(softcap)
                        s = np.tanh(s * scale / sc) * sc
                        s = s * log2e if log2 else s
                    else:
                        s = s * (scale * log2e) if log2 else s * scale
                    d = pos[:, None] - cols[None, :]
                    ok = (cols < S)[None, :] & (d < win)
                    if causal:
                        ok &= d >= 0
                    s = np.where(ok, s, -np.inf if log2 else neg)
                    s = s.astype(np.float32)
                    m_new = np.maximum(m, s.max(axis=1))
                    ex = np.exp2 if log2 else np.exp
                    p = ex(s - m_new[:, None])
                    corr = ex(m - m_new)
                    l = l * corr + p.sum(axis=1, dtype=np.float32)
                    acc = acc * corr[:, None] + pv(p, vt)
                    m = m_new
                res = acc / np.maximum(l, np.float32(1e-30))[:, None]
                out[b, h0 + pr % pg, pos] = res
    return out


def _tc_model(q, k, v, causal, window, softcap, split=True, hi=_bf16,
              **tiles):
    """The tensor-core instance on bf16-valued inputs: logits as f32 sums
    of exact bf16 products, and P.V as hi.V + lo.V with hi = bf16(p)
    (``hi``: rounded, or truncated as the wgmma instance does), lo =
    bf16(p - hi) (only hi.V when not ``split``).  ``tiles``: the loop's
    tile widths, packing and exponent base (``_tc_loop``)."""
    def pv(p, vt):
        h = hi(p)
        return h @ vt + _bf16(p - h) @ vt if split else h @ vt

    return _tc_loop(q, k, v, causal, window, softcap, np.matmul, pv, **tiles)


def _wg_model(q, k, v, causal, window, softcap, split=True):
    """The wgmma instance: the tensor-core instance's arithmetic with P_hi
    truncated, over ``WG_CONSUMERS * WG_BM`` packed rows a block and
    ``WG_BN``-key tiles, in base 2."""
    return _tc_model(q, k, v, causal, window, softcap, split, _bf16_trunc,
                     bq=fa.WG_CONSUMERS * fa.WG_BM, bk=fa.WG_BN, packed=True,
                     log2=True)


#: the f32 tensor-core instance's arithmetic and the alternatives it was
#: chosen over: logits and P.V each as one product of rounded terms or as
#: three products of split terms
TC32_LOGITS = {"tf32x3": lambda a, b: _split3(a, b, _tf32),
               "bf16x3": lambda a, b: _split3(a, b, _bf16),
               "tf32": lambda a, b: _tf32(a) @ _tf32(b)}
TC32_VALUES = {"bf16x3": lambda p, vt: _split3(p, vt, _bf16),
               "tf32": lambda p, vt: _tf32(p) @ _tf32(vt)}


def _tc32_model(q, k, v, causal, window, softcap, logits="tf32x3",
                values="bf16x3"):
    """The f32 tensor-core instance on f32 inputs: Q.K^T as three TF32
    products (lo.hi + hi.lo + hi.hi of hi = tf32(x), lo = tf32(x - hi)),
    P.V as three bf16 products of P and V split the same way."""
    return _tc_loop(q, k, v, causal, window, softcap, TC32_LOGITS[logits],
                    TC32_VALUES[values])


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


@pytest.mark.parametrize("shape,kv,causal,window,softcap,scale", [
    ((1, 6, 200, 64), 2, True, None, None, 1.0),    # granite's group, ragged
    ((1, 6, 257, 64), 2, True, 48, None, 1.0),      # window, S % 128 = 1
    ((1, 6, 1, 64), 2, True, None, None, 1.0),      # S = 1
    ((1, 6, 257, 64), 2, False, None, None, 1.0),   # non-causal, padded keys
    ((1, 6, 200, 64), 2, True, None, 50.0, 3.0),    # softcap, logits ~9
    ((2, 3, 200, 16), 3, True, None, None, 1.0),    # hd 16, group 1
    ((1, 4, 257, 128), 1, True, 100, None, 1.0),    # hd 128, MQA, window
    ((1, 2, 200, 128), 2, False, None, 2.0, 1.0),   # hd 128, softcap
    ((1, 8, 130, 100), 1, True, None, None, 1.0),   # hd 100, group 8
])
def test_wgmma_model(shape, kv, causal, window, softcap, scale):
    """The wgmma instance's arithmetic, packing and tiles on bf16-valued
    inputs within 2e-4 of the Pallas kernel (interpret mode) on their f32
    upcast, K/V expanded to H heads as the reference takes them, and of
    the port's plain version."""
    q, k, v = _bf16_qkv(shape, 37, kv, scale)
    got = _wg_model(q, k, v, causal, window, softcap)
    rep = shape[1] // kv
    jq, jk, jv = (jnp.asarray(a) for a in (q, np.repeat(k, rep, axis=1),
                                           np.repeat(v, rep, axis=1)))
    kern = pallas_flash(jq, jk, jv, causal=causal, window=window,
                        softcap=softcap, bq=64, bk=64, interpret=True)
    _close(got, kern, F32_TOL)
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


@pytest.mark.parametrize("hd", [64, 128])
def test_wgmma_split_probabilities_are_needed(hd):
    """The same holds for the wgmma instance at granite's group and head
    width, and at its widest: one bf16 term for P misses 2e-4 by ~15x,
    hi + lo holds it by ~30x.  So it runs two wgmma for P.V as well."""
    q, k, v = _bf16_qkv((1, 6, 256, hd), 41, 2)
    want = _plain_f32(q, k, v, causal=True)
    single = np.abs(_wg_model(q, k, v, True, None, None, split=False)
                    - want).max()
    split = np.abs(_wg_model(q, k, v, True, None, None) - want).max()
    assert single > 5 * F32_TOL, single
    assert split <= F32_TOL / 10, split


@pytest.mark.parametrize("shape,kv,causal,window,softcap,scale", [
    ((1, 4, 150, 256), 1, True, 64, None, 1.0),    # the widest plan, MQA
    ((1, 4, 130, 256), 1, True, None, None, 1.0),  # the same, global
    ((1, 3, 160, 64), 3, True, None, None, 1.0),
    ((2, 3, 200, 256), 1, True, 64, None, 1.0),    # hd 256 with a window
    ((2, 3, 100, 64), 3, False, None, None, 1.0),  # non-causal, pads
    ((1, 2, 300, 128), 2, True, None, 50.0, 3.0),  # logits ~9, softcap
    ((2, 2, 100, 16), 1, False, 32, 50.0, 3.0),
    ((1, 1, 1, 16), 1, True, None, None, 1.0),     # S = 1
])
def test_f32_tensor_core_model(shape, kv, causal, window, softcap, scale):
    """The f32 tensor-core instance's arithmetic and tiles on f32 inputs
    within the f32 tolerance of the plain version and of the reference's,
    at phase 6's f32 shapes of ``chip_smoke.py`` cut in S (hd 256, the
    widest the instance takes, where phase 6 also has hd 288)."""
    q, k, v = _qkv(shape, 31, scale, kv_heads=kv)
    got = _tc32_model(q, k, v, causal, window, softcap)
    want = _plain_f32(q, k, v, causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    rep = shape[1] // kv
    jq, jk, jv = (jnp.asarray(a) for a in (q, np.repeat(k, rep, axis=1),
                                           np.repeat(v, rep, axis=1)))
    jwant = jref.flash_attention_ref(jq, jk, jv, causal=causal, window=window,
                                     softcap=softcap)
    _close(got, jwant, F32_TOL)


def test_split_tf32_logits_are_chosen():
    """Why the f32 instance splits both products.  One TF32 pass (10-bit
    mantissas for Q, K, P and V) misses the 2e-4 check against the f32
    plain version by 40x at logits of ~9 (input scale 3, softcap 50, hd
    128: ``chip_smoke.py``'s f32 softcap case) and 4x at input scale 1.
    Three bf16 products for Q.K^T (split bf16 P.V beside them) hold it
    here, but at 1.2-1.8e-4 over eight seeds: under 1.7x of margin.  Three
    TF32 products hold it at 2-3e-5."""
    q, k, v = _qkv((1, 2, 1000, 128), 31, 3.0, kv_heads=2)
    want = _plain_f32(q, k, v, causal=True, softcap=50.0)

    def err(logits, values):
        got = _tc32_model(q, k, v, True, None, 50.0, logits, values)
        return np.abs(got - want).max()

    one_pass, bf16x3, chosen = (err("tf32", "tf32"), err("bf16x3", "bf16x3"),
                                err("tf32x3", "bf16x3"))
    assert one_pass > 20 * F32_TOL, one_pass
    assert bf16x3 > F32_TOL / 2 and bf16x3 > 3 * chosen, (bf16x3, chosen)
    assert chosen <= F32_TOL / 4, chosen
    q, k, v = _qkv((1, 2, 256, 128), 31, 1.0, kv_heads=2)
    want = _plain_f32(q, k, v, causal=True)
    one_pass = np.abs(_tc32_model(q, k, v, True, None, None, "tf32", "tf32")
                      - want).max()
    assert one_pass > F32_TOL, one_pass


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


@pytest.mark.parametrize("hd", [8, 16, 17, 32, 64, 100, 128, 200, 255, 256])
def test_tc32_shared_memory_layout(hd):
    """The f32 tensor-core instance's f32 rows (Q, K, V's staged tile) are
    16-byte aligned for ldmatrix and an odd number of 16-byte chunks long,
    so the 8 rows of one ldmatrix phase fall in 8 distinct 16-byte bank
    groups at every chunk column; V's bf16 planes take the tensor-core
    instance's layout; the widest instantiation fits a block's shared
    memory.  The Python mirrors are the CUDA source's formulas."""
    stride = fa.tc32_smem_stride(hd)
    width = 16 * fa.tc_steps(hd)
    assert width >= hd and stride >= width
    assert (stride * 4) % 16 == 0
    chunks = stride * 4 // 16
    assert chunks % 2 == 1
    for col_chunk in range(width // 4):
        groups = {(r * chunks + col_chunk) % 8 for r in range(8)}
        assert len(groups) == 8, (hd, col_chunk)
    assert fa.tc32_smem_bytes(hd) == ((fa.TC_BQ + 2 * fa.TC_BK) * stride * 4
                                      + 2 * fa.TC_BK * fa.tc_smem_stride(hd) * 2)
    assert fa.tc32_smem_bytes(fa.TC32_MAX_HEAD_DIM) <= fa.MAX_SMEM_BYTES
    src = CU_SOURCE.read_text()
    assert "return (4 * tc_steps(hd) + 1) * 4;" in src
    assert "(size_t)2 * kTcBK * tc_smem_stride(hd) * sizeof(bf16);" in src


@pytest.mark.parametrize("hd", [8, 16, 17, 32, 64, 100, 128])
def test_wg_shared_memory_layout(hd):
    """The wgmma instance's tiles (a warpgroup's 64 Q rows, a 128-key K or
    V tile) in 64-column blocks of 128-byte rows: each 16-byte chunk has
    its own place inside the tile, and the place is the unswizzled one with
    address bits 4-6 XORed with bits 7-9, the 128-byte swizzle that the
    descriptors' layout type 1 reads from a tile aligned to 1,024 bytes;
    the 8 rows of a core matrix fall in 8 distinct 16-byte bank groups at
    every chunk, so the producer's stores and the reads do not conflict.
    Every tile is a whole number of swizzle atoms, the block's shared
    memory fits at the widest head, and the Python mirrors are the CUDA
    source's formulas."""
    width = fa.wg_width(hd)
    assert width >= hd and width % 64 == 0
    for rows in (fa.WG_BM, fa.WG_BN):
        assert rows * width * 2 % 1024 == 0
        offs = {}
        for r in range(rows):
            for c in range(width // 8):
                off = fa.wg_swizzle(r, c, rows)
                plain = (c >> 3) * rows * 128 + r * 128 + (c & 7) * 16
                assert off ^ plain == ((plain >> 7) & 7) << 4, (r, c)
                offs[off] = (r, c)
        assert len(offs) == rows * width // 8
        assert sorted(offs) == list(range(0, rows * width * 2, 16))
        for c in range(width // 8):
            for r0 in range(0, rows, 8):
                groups = {fa.wg_swizzle(r, c, rows) // 16 % 8
                          for r in range(r0, r0 + 8)}
                assert len(groups) == 8, (hd, rows, c, r0)
    assert fa.wg_smem_bytes(fa.WG_MAX_HEAD_DIM) <= fa.MAX_SMEM_BYTES
    assert fa.wg_smem_bytes(64) <= fa.MAX_SMEM_BYTES
    assert (fa.wg_stages(64), fa.wg_stages(128)) == (3, 2)
    src = CU_SOURCE.read_text()
    assert ("return (uint32_t)((c >> 3) * rows * 128 + r * 128 + "
            "(((c & 7) ^ (r & 7)) << 4));") in src
    assert "inline int wg_width(int hd) { return hd <= 64 ? 64 : 128; }" in src
    assert "return width == 64 ? 3 : 2;" in src
    assert ("return 1024 + (size_t)(2 * kWgRows + 2 * wg_stages(w) * kWgBN) "
            "* w * 2 +\n         (size_t)2 * (wg_stages(w) + 2) * 8;") in src


def _cu_int(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CU_SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def test_dispatch_rule_and_mirror():
    """bf16 at hd 1-128 goes to the wgmma instance, at hd 129-288 to the
    tensor-core instance, f32 within its plan to the f32 tensor-core
    instance, wider heads of either dtype to the CUDA cores; the Python
    constants mirror the CUDA source's, the bf16 tensor-core instance is
    built only at the 16 and 18 steps that hd 129-288 take, and the choice
    depends on dtype and hd only: no ``try`` in the wrapper or in ``ops``
    gives way to another instance or the plain version."""
    for hd in range(1, fa.WG_MAX_HEAD_DIM + 1):
        assert fa.instance(torch.bfloat16, hd) == fa.WGMMA
    for hd in range(fa.WG_MAX_HEAD_DIM + 1, fa.TC_MAX_HEAD_DIM + 1):
        assert fa.instance(torch.bfloat16, hd) == fa.TENSOR_CORE
        assert fa.tc_steps(hd) in (16, 18)
    for hd in (16, 64, 100, 128, 200, 256):
        assert fa.instance(torch.float32, hd) == fa.TENSOR_CORE_F32
    for hd in (289, 320, 512):
        assert fa.instance(torch.bfloat16, hd) == fa.CUDA_CORE
    for hd in (257, 288, 320, 512):
        assert fa.instance(torch.float32, hd) == fa.CUDA_CORE
    assert fa.instance(torch.float16, 64) is None
    assert fa.instance(torch.float32, 0) is None
    assert _cu_int("kTcMaxHeadDim") == fa.TC_MAX_HEAD_DIM
    assert _cu_int("kWgMaxHeadDim") == fa.WG_MAX_HEAD_DIM
    assert (_cu_int("kWgBM"), _cu_int("kWgConsumers"), _cu_int("kWgBN")) == (
        fa.WG_BM, fa.WG_CONSUMERS, fa.WG_BN)
    assert _cu_int("kTc32MaxHeadDim") == fa.TC32_MAX_HEAD_DIM
    assert (_cu_int("kTcBQ"), _cu_int("kTcBK")) == (fa.TC_BQ, fa.TC_BK)
    assert (_cu_int("kBQ"), _cu_int("kBK")) == (fa.BQ, fa.BK)
    src = CU_SOURCE.read_text()
    rule = src[src.index('extern "C" int flash_attention_instance'):]
    rule = rule[:rule.index("\n}\n")]
    assert "if (dtype == 0) return hd <= kTc32MaxHeadDim ? 2 : 0;" in rule
    assert "if (hd <= kWgMaxHeadDim) return 3;" in rule
    assert "return hd <= kTcMaxHeadDim ? 1 : 0;" in rule
    assert rule.index("return 3;") < rule.index("? 1 : 0;")
    assert fa.INSTANCES == {0: fa.CUDA_CORE, 1: fa.TENSOR_CORE,
                            2: fa.TENSOR_CORE_F32, 3: fa.WGMMA}
    launch = src[src.index("cudaError_t tc_dispatch("):]
    launch = launch[:launch.index("#undef FLASH_TC_LAUNCH")]
    for steps in (2, 4, 8):
        assert f"if constexpr (f32) FLASH_TC_LAUNCH({steps});" in launch
    assert "if constexpr (!f32) FLASH_TC_LAUNCH(18);" in launch
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
    assert set(fa.flash_attention.instance_launches) == {
        fa.WGMMA, fa.TENSOR_CORE, fa.TENSOR_CORE_F32, fa.CUDA_CORE}
