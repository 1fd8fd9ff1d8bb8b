"""The port's INT8 kernels on the CPU: the plain versions behind ``ops``
against ``repro.kernels.ref`` (bit-equal) and against the Pallas kernels
in interpret mode (within ``tests/test_kernels.py``'s tolerances), the
weight repack and tap decode the CUDA conv kernel relies on, a numpy
model of both kernels' s8 tensor-core tiling (ldmatrix and m16n8k32
fragments as the PTX ISA lays them out), the instance rules, and the
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
from repro_torch.kernels import _build, conv2d, ops, ref
from repro_torch.kernels import imc_mvm as imc_mvm_mod
from repro_torch.kernels.conv2d import imc_conv2d, pack_weight
from repro_torch.kernels.imc_mvm import imc_mvm
from repro_torch.models.cnn import graphs
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
    packed K column k < Kpad (a multiple of 32) in (kh, kw, ci) order,
    each gathered from x, zero outside it and past K."""
    a, wbytes, (B, Ho, Wo, Cout) = _im2col(qx, qw, stride, pads)
    assert a.shape[1] == wbytes.shape[1] and a.shape[1] % 32 == 0
    return (a @ wbytes.T).reshape(B, Ho, Wo, Cout)


def _im2col(qx, qw, stride, pads):
    """(im2col rows (M, Kpad), packed weight rows (Cout, Kpad), output
    shape) as int64, with the K padding of ``pack_weight``."""
    B, H, W, Cin = qx.shape
    KH, KW, _, Cout = qw.shape
    top, bottom, left, right = pads
    Ho = (H + top + bottom - KH) // stride + 1
    Wo = (W + left + right - KW) // stride + 1
    words = pack_weight(torch.from_numpy(qw)).numpy()          # (Cout, Kpad/4)
    wbytes = words.view(np.int8).astype(np.int64)               # (Cout, Kpad)
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
    return a, wbytes, (B, Ho, Wo, Cout)


@pytest.mark.parametrize("H,Cin,Cout,k,stride", [
    (6, 3, 5, 3, 1), (7, 3, 4, 3, 2), (6, 8, 5, 3, 2), (5, 4, 3, 1, 2),
])
def test_kernel_index_math_matches_conv(H, Cin, Cout, k, stride):
    qx, qw = _int8((2, H, H, Cin), H), _int8((k, k, Cin, Cout), Cout)
    pads = conv_pads(H, H, k, stride, "SAME")
    want = ref.conv2d_acc(torch.from_numpy(qx), torch.from_numpy(qw), stride,
                          pads).numpy()
    np.testing.assert_array_equal(_implicit_gemm_acc(qx, qw, stride, pads), want)


# --- numpy model of the s8 tensor-core tiling (csrc/imc_mma.cuh) -----------

_LANES = np.arange(32)
_G, _T = _LANES // 4, _LANES % 4


def _row_stride(nbytes):
    """imc::row_stride: the next odd number of 16-byte chunks."""
    return ((nbytes // 16) | 1) * 16


def _a_lane_offset(ld):
    return ((_LANES & 7) + 8 * ((_LANES >> 3) & 1)) * ld + 16 * (_LANES >> 4)


def _b_lane_offset(ld):
    return ((_LANES & 7) + 8 * (_LANES >> 4)) * ld + 16 * ((_LANES >> 3) & 1)


def _ldmatrix_x4(smem, addrs):
    """ldmatrix .x4 .b16 on a byte array: lanes 8j..8j+7 give the row
    addresses of matrix j; lane l gets 4 bytes at word l % 4 of row l / 4
    of each matrix.  Returns (32 lanes, 4 registers, 4 bytes)."""
    rows = addrs[8 * np.arange(4)[None, :] + (_LANES // 4)[:, None]]   # (32, 4)
    return smem[rows[..., None] + 4 * _T[:, None, None] + np.arange(4)]


def _mma_m16n8k32(c, a, b0, b1):
    """mma.sync m16n8k32 .row.col s8 x s8 + s32 on per-lane fragments, laid
    out as the PTX ISA says: a0 = row g, k 4t..4t+3; a1 = row g + 8; a2, a3
    the same rows at k + 16; b0 = column g, k 4t..; b1 at k + 16; c0, c1 =
    row g, columns 2t, 2t + 1; c2, c3 = row g + 8.  c (32, 4) int64."""
    A = np.zeros((16, 32), np.int64)
    Bm = np.zeros((32, 8), np.int64)
    e = np.arange(4)
    k = 4 * _T[:, None] + e[None, :]
    A[_G[:, None], k] = a[:, 0]
    A[_G[:, None] + 8, k] = a[:, 1]
    A[_G[:, None], k + 16] = a[:, 2]
    A[_G[:, None] + 8, k + 16] = a[:, 3]
    Bm[k, _G[:, None]] = b0
    Bm[k + 16, _G[:, None]] = b1
    D = A @ Bm
    c += np.stack([D[_G, 2 * _T], D[_G, 2 * _T + 1], D[_G + 8, 2 * _T],
                   D[_G + 8, 2 * _T + 1]], axis=1)


def _warp_mma_k32(acc, smem, a_addr, b_addr, ld):
    """imc::warp_mma_k32 over acc (MI, NI, 32, 4)."""
    MI, NI = acc.shape[:2]
    a = [_ldmatrix_x4(smem, a_addr + i * 16 * ld) for i in range(MI)]
    for j in range(0, NI, 2):
        b = _ldmatrix_x4(smem, b_addr + j * 8 * ld)
        for i in range(MI):
            _mma_m16n8k32(acc[i, j], a[i], b[:, 0], b[:, 1])
            _mma_m16n8k32(acc[i, j + 1], a[i], b[:, 2], b[:, 3])


def _scatter_c(acc, tile, r0, c0):
    """C fragments of a warp tile back to (row, column) of ``tile``."""
    MI, NI = acc.shape[:2]
    for i in range(MI):
        for j in range(NI):
            r, c = r0 + 16 * i + _G, c0 + 8 * j + 2 * _T
            tile[r, c] = acc[i, j, :, 0]
            tile[r, c + 1] = acc[i, j, :, 1]
            tile[r + 8, c] = acc[i, j, :, 2]
            tile[r + 8, c + 1] = acc[i, j, :, 3]


#: Tile<BN> in csrc/imc_conv2d.cu: N tile -> (BM, warps along M, warps
#: along N, K bytes a stage)
_CONV_TILES = {32: (128, 4, 1, 64), 64: (128, 4, 2, 64), 128: (64, 2, 4, 128)}


def _conv_tiling_model(a, wbytes, bn):
    """The conv kernel's tiling: BM x BN tiles, K in stages of BKS bytes
    (rows at an odd number of 16-byte chunks: A rows, then B rows; zero
    past Kpad), each stage run as BKS / 32 m16n8k32 steps by warps that
    own WM x WN sub-tiles."""
    bm, warps_m, warps_n, bks = _CONV_TILES[bn]
    wm_rows, wn_cols = bm // warps_m, bn // warps_n
    M, Kpad = a.shape
    N = wbytes.shape[0]
    ld = _row_stride(bks)
    assert ld % 16 == 0 and (ld // 16) % 2 == 1 and ld >= bks
    out = np.zeros((M, N), np.int64)
    for m0 in range(0, M, bm):
        for n0 in range(0, N, bn):
            acc = np.zeros((warps_m, warps_n, wm_rows // 16, wn_cols // 8, 32, 4),
                           np.int64)
            for k0 in range(0, Kpad, bks):
                smem = np.zeros((bm + bn) * ld, np.int64)
                rows_a = a[m0:m0 + bm, k0:k0 + bks]
                rows_b = wbytes[n0:n0 + bn, k0:k0 + bks]
                for r in range(rows_a.shape[0]):
                    smem[r * ld:r * ld + rows_a.shape[1]] = rows_a[r]
                for r in range(rows_b.shape[0]):
                    smem[(bm + r) * ld:(bm + r) * ld + rows_b.shape[1]] = rows_b[r]
                for st in range(min(bks, Kpad - k0) // 32):
                    for wm in range(warps_m):
                        for wn in range(warps_n):
                            _warp_mma_k32(
                                acc[wm, wn], smem,
                                wm * wm_rows * ld + 32 * st + _a_lane_offset(ld),
                                (bm + wn * wn_cols) * ld + 32 * st
                                + _b_lane_offset(ld), ld)
            tile = np.zeros((bm, bn), np.int64)
            for wm in range(warps_m):
                for wn in range(warps_n):
                    _scatter_c(acc[wm, wn], tile, wm * wm_rows, wn * wn_cols)
            rows, cols = min(bm, M - m0), min(bn, N - n0)
            out[m0:m0 + rows, n0:n0 + cols] = tile[:rows, :cols]
    return out


@pytest.mark.parametrize("B,H,Cin,Cout,k,stride", [
    (1, 6, 3, 32, 3, 1),      # the stem: Cin 3, K = 27 padded to 32
    (1, 5, 32, 32, 3, 1),     # stage 1: Cin 32, one tap per 32-step
    (1, 6, 32, 64, 1, 2),     # 1x1 shortcut at stride 2
    (1, 5, 16, 130, 3, 2),    # ragged Cout over two 128-wide N tiles
    (2, 4, 48, 40, 3, 1),     # Cin 48: 16-byte pieces, K = 432 not 32-aligned per tap
])
def test_tensor_core_tiling_model_matches_conv(B, H, Cin, Cout, k, stride):
    qx, qw = _int8((B, H, H, Cin), Cin + H), _int8((k, k, Cin, Cout), Cout)
    pads = conv_pads(H, H, k, stride, "SAME")
    a, wbytes, shape = _im2col(qx, qw, stride, pads)
    bn = int(conv2d.conv_instance(Cin, Cout, True).split("_n")[1])
    got = _conv_tiling_model(a, wbytes, bn).reshape(shape)
    want = ref.conv2d_acc(torch.from_numpy(qx), torch.from_numpy(qw), stride,
                          pads).numpy()
    np.testing.assert_array_equal(got, want)


def _mvm_tiling_model(qx, qw):
    """The mvm kernel's tiling: 16 x 32 blocks, K in 128-byte stages (rows
    at a 144-byte stride) split over 4 warps of one 32-deep slice each,
    qw transposed into K-contiguous rows, partial tiles summed."""
    M, K = qx.shape
    N = qw.shape[1]
    bm, bn, warps = 16, 32, 4
    ld = _row_stride(32 * warps)
    assert ld == 144
    out = np.zeros((M, N), np.int64)
    for m0 in range(0, M, bm):
        for n0 in range(0, N, bn):
            acc = np.zeros((warps, 1, 4, 32, 4), np.int64)
            for k0 in range(0, K, 32 * warps):
                smem = np.zeros((bm + bn) * ld, np.int64)
                xa = qx[m0:m0 + bm, k0:k0 + 32 * warps]
                wb = qw[k0:k0 + 32 * warps, n0:n0 + bn].T      # transposed
                for r in range(xa.shape[0]):
                    smem[r * ld:r * ld + xa.shape[1]] = xa[r]
                for r in range(wb.shape[0]):
                    smem[(bm + r) * ld:(bm + r) * ld + wb.shape[1]] = wb[r]
                for w in range(warps):
                    _warp_mma_k32(acc[w], smem, 32 * w + _a_lane_offset(ld),
                                  bm * ld + 32 * w + _b_lane_offset(ld), ld)
            tile = np.zeros((bm, bn), np.int64)
            for w in range(warps):
                part = np.zeros((bm, bn), np.int64)
                _scatter_c(acc[w], part, 0, 0)
                tile += part
            rows, cols = min(bm, M - m0), min(bn, N - n0)
            out[m0:m0 + rows, n0:n0 + cols] = tile[:rows, :cols]
    return out


@pytest.mark.parametrize("M,K,N", [(40, 256, 10), (17, 129, 65), (1, 512, 40)])
def test_tensor_core_tiling_model_matches_matmul(M, K, N):
    qx, qw = _int8((M, K), M), _int8((K, N), N)
    want = ref.matmul_acc(torch.from_numpy(qx), torch.from_numpy(qw)).numpy()
    got = _mvm_tiling_model(qx.astype(np.int64), qw.astype(np.int64))
    np.testing.assert_array_equal(got, want)


def _resnet18_conv_shapes():
    """(Cin, Cout, k, stride) of every conv node of ResNet-18-CIFAR."""
    g = graphs.resnet18_graph()
    out = []
    for nid in g.topo_order():
        n = g.nodes[nid]
        if n.kind.value == "conv":
            k = n.meta["k"]
            out.append((n.meta["cin_kk"] // (k * k), n.meta["cout"], k,
                        n.meta["stride"]))
    return out


def test_conv_dispatch_rule():
    """Every ResNet-18-CIFAR layer but the stem stages by cp.async; the
    stem (Cin 3), odd Cin, Cin 24 (a multiple of 8, not 16) and an
    unaligned x gather.  The N tile follows Cout."""
    shapes = _resnet18_conv_shapes()
    assert len(shapes) == 20
    inst = [conv2d.conv_instance(cin, cout, True) for cin, cout, _, _ in shapes]
    assert inst[0] == "gather_n32" and shapes[0][0] == 3
    assert all(i.startswith("cp_async_") for i in inst[1:])
    assert sum(i.startswith("cp_async_") for i in inst) == 19
    for (cin, cout, _, _), i in zip(shapes, inst):
        assert i.endswith("_n32" if cout <= 32 else "_n64" if cout <= 64
                          else "_n128")
    for cin in (3, 5, 24, 33):
        assert conv2d.conv_instance(cin, 64, True) == "gather_n64"
    for cin in (16, 32, 48, 256):
        assert conv2d.conv_instance(cin, 130, True) == "cp_async_n128"
        assert conv2d.conv_instance(cin, 130, False) == "gather_n128"
    assert conv2d.INSTANCES.index(conv2d.conv_instance(32, 32, True)) == 0
    assert conv2d.INSTANCES.index(conv2d.conv_instance(3, 256, False)) == 5
    with pytest.raises(ValueError):
        conv2d.conv_instance(0, 32, True)
    assert imc_mvm_mod.mvm_instance(256, True) == "cp_async"
    for k, aligned in ((129, True), (256, False), (24, True)):
        assert imc_mvm_mod.mvm_instance(k, aligned) == "gather"


def test_pack_weight_layout():
    qw = torch.from_numpy(_int8((3, 3, 3, 32), 9))            # the stem: K = 27
    words = pack_weight(qw)
    assert words.dtype == torch.int32 and words.shape == (32, 8)
    packed = words.view(torch.int8)
    assert packed.shape == (32, 32)
    assert torch.equal(packed[:, :27], qw.reshape(27, 32).t())
    assert not packed[:, 27:].any()
    qw = torch.from_numpy(_int8((3, 3, 16, 8), 10))           # K = 144 -> 160
    packed = pack_weight(qw).view(torch.int8)
    assert packed.shape == (8, 160)
    assert torch.equal(packed[:, :144], qw.reshape(144, 8).t())
    assert not packed[:, 144:].any()


def test_cuda_wrappers_refuse_cpu_tensors():
    qx, qw = torch.zeros((4, 8), dtype=torch.int8), torch.zeros((8, 2), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):
        imc_mvm(qx, qw, 0.1, torch.ones(2))
    with pytest.raises(ValueError, match="CUDA"):
        imc_conv2d(torch.zeros((1, 4, 4, 8), dtype=torch.int8),
                   torch.zeros((3, 3, 8, 2), dtype=torch.int8), 0.1, torch.ones(2))


@pytest.mark.parametrize("launcher", ["conv", "mvm"])
def test_cuda_launchers_refuse_cpu_tensors(launcher):
    """The uncounted launches the kernel bench times check their inputs as
    the wrappers do (they are the wrappers' own launch)."""
    before = (imc_conv2d.launches, imc_mvm.launches)
    with pytest.raises(ValueError, match="CUDA"):
        if launcher == "mvm":
            imc_mvm_mod.mvm_launcher(torch.zeros((4, 8), dtype=torch.int8),
                                     torch.zeros((8, 2), dtype=torch.int8),
                                     0.1, torch.ones(2))
        else:
            conv2d.conv_launcher(torch.zeros((1, 4, 4, 8), dtype=torch.int8),
                                 torch.zeros((3, 3, 8, 2), dtype=torch.int8),
                                 0.1, torch.ones(2), stride=1, pads=(1,) * 4)
    assert (imc_conv2d.launches, imc_mvm.launches) == before


def test_build_flags_target_sm90a():
    assert _build.sources() == ["flash_attention", "imc_conv2d", "imc_mvm"]
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-gencode arch=compute_90a,code=sm_90a" in flags
    for f in ("-std=c++17", "-O3", "-shared", "-Xcompiler -fPIC"):
        assert f in flags
    lib = _build.library_path("imc_mvm")
    assert lib.parent == _build.BUILD_DIR and lib.suffix == ".so"


def test_library_path_follows_headers(tmp_path, monkeypatch):
    """Editing a header of csrc/ (on a copy) changes every library's path,
    so a source that includes it is rebuilt; the path is stable
    otherwise."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    assert (csrc / "imc_mma.cuh").exists()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {n: _build.library_path(n) for n in _build.sources()}
    assert before == {n: _build.library_path(n) for n in _build.sources()}
    header = csrc / "imc_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.sources()}
    assert all(before[n] != after[n] for n in before)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.library_path("imc_conv2d") != after["imc_conv2d"]


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


def test_refuse_grad_raises_only_where_a_gradient_is_asked_for():
    w = torch.ones(3, requires_grad=True)
    q = torch.ones(3, dtype=torch.int8)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.refuse_grad("quantized_matmul", q, w, None)
    with torch.no_grad():
        ops.refuse_grad("quantized_matmul", q, w, None)
    ops.refuse_grad("attention", q, torch.ones(3), None)


@pytest.mark.parametrize("route", ["quantized_matmul", "quantized_conv2d",
                                   "attention"])
def test_kernel_routes_refuse_grad_before_launching(route):
    """Off the CPU every op checks for gradients before its wrapper: a
    meta tensor that requires grad stops at the guard, not at the
    wrapper's device check."""
    dev = torch.device("meta")
    f = torch.ones(4, device=dev, requires_grad=True)
    q8 = torch.ones((2, 4), dtype=torch.int8, device=dev)
    calls = {
        "quantized_matmul": lambda: ops.quantized_matmul(q8, q8.T, 0.1, f),
        "quantized_conv2d": lambda: ops.quantized_conv2d(
            q8.view(1, 2, 4, 1), torch.ones((1, 1, 1, 4), dtype=torch.int8,
                                             device=dev), 0.1, f),
        "attention": lambda: ops.attention(*(torch.ones(
            (1, 1, 2, 4), device=dev, requires_grad=True),) * 3),
    }
    with pytest.raises(RuntimeError, match="no backward"):
        calls[route]()


def test_cpu_routes_stay_differentiable():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 5, 8), generator=gen, requires_grad=True)
               for _ in range(3))
    out = ops.attention(q, k, v, window=3, softcap=20.0)
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
    qx = torch.randint(-127, 128, (4, 6), generator=gen, dtype=torch.int8)
    qw = torch.randint(-127, 128, (6, 3), generator=gen, dtype=torch.int8)
    sw = torch.rand(3, generator=gen).requires_grad_()
    assert ops.quantized_matmul(qx, qw, 0.1, sw).grad_fn is not None
