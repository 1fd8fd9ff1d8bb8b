"""The port's INT8 kernels on the CPU: the plain versions behind ``ops``
against ``repro.kernels.ref`` (bit-equal) and against the Pallas kernels
in interpret mode (within ``tests/test_kernels.py``'s tolerances), the
weight repack and tap decode the CUDA conv kernel relies on, and the
rule that nothing is compiled at import.  The CUDA kernels themselves run
only on the card, where ``chip_smoke.py`` holds them against these plain
versions with ``torch.equal``."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp
import numpy as np

from repro.kernels import ref as jref
from repro.kernels.conv2d import imc_conv2d as pallas_conv2d
from repro.kernels.imc_mvm import imc_mvm as pallas_mvm
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.conv2d import imc_conv2d, pack_weight
from repro_torch.kernels.imc_mvm import imc_mvm
from repro_torch.models.cnn.layers import conv_pads

ROOT = Path(__file__).resolve().parents[1]


def _int8(shape, seed):
    return np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    sw = rng.uniform(1e-3, 0.2, n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return sw, b


@pytest.mark.parametrize("M,K,N", [
    (8, 16, 8), (128, 128, 128), (64, 256, 32), (200, 300, 77),
    (1, 512, 512), (257, 129, 65),
])
def test_mvm_plain_matches_reference(M, K, N):
    qx, qw = _int8((M, K), M), _int8((K, N), N)
    sw, b = _inputs(N, K)
    sx = np.float32(0.02)
    got = ops.quantized_matmul(torch.from_numpy(qx), torch.from_numpy(qw),
                               torch.tensor(sx), torch.from_numpy(sw),
                               torch.from_numpy(b)).numpy()
    args = (jnp.asarray(qx), jnp.asarray(qw), jnp.float32(sx), jnp.asarray(sw),
            jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(jref.imc_mvm_ref(*args)), got)
    np.testing.assert_allclose(np.asarray(pallas_mvm(*args, interpret=True)),
                               got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("H,W,Cin,Cout,K,stride", [
    (8, 8, 4, 8, 3, 1),
    (16, 16, 8, 16, 3, 2),
    (32, 32, 3, 16, 3, 1),
    (10, 10, 5, 7, 1, 1),
    (9, 9, 4, 6, 3, 2),
    (12, 12, 8, 130, 5, 1),   # cout > block
    (9, 9, 3, 6, 3, 2),       # cin = 3 at stride 2
])
def test_conv_plain_matches_reference(H, W, Cin, Cout, K, stride):
    qx, qw = _int8((2, H, W, Cin), H * W), _int8((K, K, Cin, Cout), Cout)
    sw, b = _inputs(Cout, Cin)
    sx = np.float32(0.04)
    got = ops.quantized_conv2d(torch.from_numpy(qx), torch.from_numpy(qw),
                               torch.tensor(sx), torch.from_numpy(sw),
                               torch.from_numpy(b), stride=stride).numpy()
    args = (jnp.asarray(qx), jnp.asarray(qw), jnp.float32(sx), jnp.asarray(sw),
            jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(jref.conv2d_ref(*args, stride=stride)), got)
    np.testing.assert_allclose(
        np.asarray(pallas_conv2d(*args, stride=stride, interpret=True)), got,
        rtol=1e-4, atol=1e-4)


def test_conv_valid_padding():
    qx, qw = _int8((2, 11, 11, 4), 0), _int8((3, 3, 4, 6), 1)
    sw, b = _inputs(6, 2)
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(qx, jnp.int32), jnp.asarray(qw, jnp.int32), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    want = np.asarray(acc.astype(jnp.float32) * jnp.float32(0.03)
                      * jnp.asarray(sw) + jnp.asarray(b))
    got = ops.quantized_conv2d(torch.from_numpy(qx), torch.from_numpy(qw), 0.03,
                               torch.from_numpy(sw), torch.from_numpy(b),
                               stride=2, padding="VALID").numpy()
    assert got.shape == (2, 5, 5, 6)
    np.testing.assert_array_equal(want, got)


def _implicit_gemm_acc(qx, qw, stride, pads):
    """The CUDA conv kernel's index arithmetic, in numpy: output pixel m,
    packed K word w holds k = 4w .. 4w+3 in (kh, kw, ci) order, each
    gathered from x or zero outside it."""
    B, H, W, Cin = qx.shape
    KH, KW, _, Cout = qw.shape
    top, bottom, left, right = pads
    Ho = (H + top + bottom - KH) // stride + 1
    Wo = (W + left + right - KW) // stride + 1
    words = pack_weight(torch.from_numpy(qw)).numpy()          # (Cout, Kw)
    wbytes = words.view(np.int8).astype(np.int64)               # (Cout, 4*Kw)
    K = KH * KW * Cin
    a = np.zeros((B * Ho * Wo, wbytes.shape[1]), np.int64)
    for m in range(B * Ho * Wo):
        b, rem = divmod(m, Ho * Wo)
        oh, ow = divmod(rem, Wo)
        for k in range(K):
            tap, ci = divmod(k, Cin)
            ih = oh * stride - top + tap // KW
            iw = ow * stride - left + tap % KW
            if 0 <= ih < H and 0 <= iw < W:
                a[m, k] = qx[b, ih, iw, ci]
    return (a @ wbytes.T).reshape(B, Ho, Wo, Cout)


@pytest.mark.parametrize("H,Cin,Cout,k,stride", [
    (6, 3, 5, 3, 1), (7, 3, 4, 3, 2), (6, 8, 5, 3, 2), (5, 4, 3, 1, 2),
])
def test_kernel_index_math_matches_conv(H, Cin, Cout, k, stride):
    qx, qw = _int8((2, H, H, Cin), H), _int8((k, k, Cin, Cout), Cout)
    pads = conv_pads(H, H, k, stride, "SAME")
    want = ref.conv2d_acc(torch.from_numpy(qx), torch.from_numpy(qw), stride,
                          pads).numpy()
    np.testing.assert_array_equal(_implicit_gemm_acc(qx, qw, stride, pads), want)


def test_pack_weight_layout():
    qw = torch.from_numpy(_int8((3, 3, 3, 32), 9))            # the stem: K = 27
    words = pack_weight(qw)
    assert words.dtype == torch.int32 and words.shape == (32, 7)
    packed = words.view(torch.int8)
    assert torch.equal(packed[:, :27], qw.reshape(27, 32).t())
    assert not packed[:, 27:].any()


def test_cuda_wrappers_refuse_cpu_tensors():
    qx, qw = torch.zeros((4, 8), dtype=torch.int8), torch.zeros((8, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        imc_mvm(qx, qw, 0.1, torch.ones(2))
    with pytest.raises(ValueError, match="CUDA"):
        imc_conv2d(torch.zeros((1, 4, 4, 8), dtype=torch.int8),
                   torch.zeros((3, 3, 8, 2), dtype=torch.int8), 0.1, torch.ones(2))


def test_build_flags_target_sm90a():
    assert _build.sources() == ["flash_attention", "imc_conv2d", "imc_mvm"]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-gencode arch=compute_90a,code=sm_90a" in flags
    for f in ("-std=c++17", "-O3", "-shared", "-Xcompiler -fPIC"):
        assert f in flags
    lib = _build.library_path("imc_mvm")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"


def test_import_and_cpu_path_never_call_nvcc(tmp_path):
    """Importing every kernel module, and running the CPU path, starts no
    process and builds nothing."""
    code = (
        "import subprocess\n"
        "def boom(*a, **k):\n"
        "    raise AssertionError('a process was started')\n"
        "subprocess.Popen = subprocess.run = boom\n"
        "import torch\n"
        "from repro_torch.kernels import _build, conv2d, flash_attention, imc_mvm, ops, ref\n"
        "from repro_torch.models.cnn import executor\n"
        "from repro_torch.runtime import serve_loop\n"
        "x = torch.ones((1, 2, 8, 16))\n"
        "ops.attention(x, x[:, :1], x[:, :1], window=4)\n"
        "q = torch.ones((2, 4, 4, 4), dtype=torch.int8)\n"
        "w = torch.ones((3, 3, 4, 2), dtype=torch.int8)\n"
        "ops.quantized_conv2d(q, w, 0.1, torch.ones(2))\n"
        "ops.quantized_matmul(q.reshape(16, 8), w.reshape(36, 2)[:8], 0.1, torch.ones(2))\n"
        "assert not _build._libs\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
