"""Port parity: the quantized-tensor layer (llama_cpp_gfx906_tpu_torch.ops.
quant_matmul) against the JAX package's ops/quant_matmul.

1. device planes byte-equal to the JAX packer (plain and folded scales,
   int8 and nib4c, pad_qt_n), so both packages stream the same bytes;
2. dequantize_qt exact;
3. the GEMV's plain version against the JAX Pallas GEMV (interpret mode)
   and the XLA dequant-dot, max error / max|ref| < 0.02 as in
   tests/test_quant_matmul.py (the JAX kernel rounds x and w to bf16).
The kernels themselves are held against the plain version on a card in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_cpp_gfx906_tpu.gguf import GGMLType, quantize
from llama_cpp_gfx906_tpu.ops import quant_matmul as jq
from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as tq

TYPES = [GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q4_K, GGMLType.Q6_K]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small CPU ops, fastest on one thread; under
    pytest-xdist, torch's default of one thread per core in every worker
    oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(qtype, N, K, seed=0):
    w = np.random.default_rng(seed).standard_normal((N, K)).astype(np.float32)
    return quantize(w, qtype)


def _assert_planes_equal(jqt, tqt):
    assert (tqt.fmt, tqt.group, tqt.shape, tqt.sgroup) == (
        jqt.fmt, jqt.group, tuple(jqt.shape), jqt.sgroup or 0)
    for name in ("q", "s", "m", "sd", "md"):
        a, b = getattr(jqt, name), getattr(tqt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a, b = np.asarray(a), b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("K", [512, 2048])
@pytest.mark.parametrize("qtype", TYPES)
def test_pack_planes_byte_equal(qtype, K, fold):
    raw = _raw(qtype, 48, K)
    jqt = jq.pack_gguf_tensor(raw, qtype, (48, K), fold_scales=fold)
    tqt = tq.pack_gguf_tensor(raw, qtype, (48, K), fold_scales=fold)
    _assert_planes_equal(jqt, tqt)
    assert tqt.fmt == ("nib4c" if qtype in (GGMLType.Q4_0, GGMLType.Q4_K) else "int8")
    assert (tqt.sd is not None) == (fold and qtype in (GGMLType.Q4_K, GGMLType.Q6_K))


@pytest.mark.parametrize("qtype", [GGMLType.Q6_K, GGMLType.Q4_K])
def test_pad_qt_n_byte_equal(qtype):
    raw = _raw(qtype, 200, 512, seed=1)
    jqt = jq.pad_qt_n(jq.pack_gguf_tensor(raw, qtype, (200, 512), fold_scales=True), 128)
    tqt = tq.pad_qt_n(tq.pack_gguf_tensor(raw, qtype, (200, 512), fold_scales=True), 128)
    assert tqt.q.shape[-1] == 256 and tqt.N == 200
    _assert_planes_equal(jqt, tqt)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("qtype", TYPES)
def test_dequantize_exact(qtype, fold):
    raw = _raw(qtype, 40, 1024, seed=2)
    jqt = jq.pad_qt_n(jq.pack_gguf_tensor(raw, qtype, (40, 1024), fold_scales=fold), 64)
    tqt = tq.pad_qt_n(tq.pack_gguf_tensor(raw, qtype, (40, 1024), fold_scales=fold), 64)
    ref = np.asarray(jq.dequantize_qt(jqt, jnp.float32))
    got = tq.dequantize_qt(tqt, torch.float32).numpy()
    assert got.shape == (1024, 40)
    np.testing.assert_array_equal(got, ref)


def test_nib4c_chunk_rule():
    for K in (256, 512, 1024, 2048, 4096, 11008, 14336, 768):
        assert tq.nib4c_chunk(K) == jq.nib4c_chunk(K), K
        for t in TYPES:
            assert tq._fold_streams(K, t) == jq._fold_streams(K, t), (K, t)


@pytest.mark.parametrize("sms,want", [(132, (64, 16)), (16, (128, 4)), (17, (128, 5)),
                                      (64, (128, 16)), (100, (64, 13)), (8, (128, 2)),
                                      (2, (128, 1))])
def test_gemv_splits_fill_the_card(sms, want):
    """K1/K2 split K only as far as reaching every SM needs: 4 tiles of 128
    columns (8 of 64) over 32 stages of 64 rows take the fewest splits
    that give every SM a block, 64-column tiles where 128-column ones
    cannot at any split count, and the most (16) where neither can.  (K6's
    GEMV units keep 512-row segments.)"""
    qt = tq.pack_gguf_tensor(_raw(GGMLType.Q8_0, 512, 2048, seed=3), GGMLType.Q8_0,
                             (512, 2048))
    assert tq._gemv_segment(qt) == (512, 0)
    assert tq.gemv_config(qt.q.shape[0], qt.q.shape[1], sms) == want


@pytest.mark.parametrize("M", [1, 8])
@pytest.mark.parametrize("qtype,fold", [
    (GGMLType.Q8_0, False), (GGMLType.Q4_0, False), (GGMLType.Q4_K, False),
    (GGMLType.Q4_K, True), (GGMLType.Q6_K, False), (GGMLType.Q6_K, True)])
def test_gemv_plain_matches_jax(qtype, fold, M):
    """K1/K2 plain version (what the wrapper runs for a CPU tensor) against
    the JAX Pallas GEMV in interpret mode and the XLA dequant-dot."""
    K, N = 1024, 256
    raw = _raw(qtype, N, K, seed=3)
    jqt = jq.pack_gguf_tensor(raw, qtype, (N, K), fold_scales=fold)
    tqt = tq.pack_gguf_tensor(raw, qtype, (N, K), fold_scales=fold)
    x = (np.random.default_rng(4).standard_normal((M, K)) * 0.5).astype(np.float32)
    gemv = tq.gemv_nib4c if tqt.fmt == "nib4c" else tq.gemv_int8
    got = gemv(torch.from_numpy(x), tqt).numpy()
    assert jq._gemv_tiles(jqt) is not None
    pallas = np.asarray(jq._quant_gemv_pallas(
        jnp.asarray(x), jqt.q, jqt.s, jqt.m, jqt.sd, jqt.md, fmt=jqt.fmt,
        group=jqt.group, sgroup=jqt.sgroup or 0, shape=jqt.shape, interpret=True))
    xla = np.asarray(jq.quant_matmul_xla(jnp.asarray(x), jqt))
    for ref in (pallas, xla):
        assert np.abs(got - ref).max() / (np.abs(ref).max() + 1e-6) < 0.02


@pytest.mark.parametrize("M", [3, 12])
def test_quant_matmul_dispatch(M):
    """M <= 8 takes the GEMV wrapper, M > 8 the bf16 dequant matmul, which
    matches quant_matmul_xla to f32 summation order."""
    qtype = GGMLType.Q4_K
    raw = _raw(qtype, 64, 512, seed=5)
    jqt = jq.pack_gguf_tensor(raw, qtype, (64, 512), fold_scales=True)
    tqt = tq.pack_gguf_tensor(raw, qtype, (64, 512), fold_scales=True)
    x = np.random.default_rng(6).standard_normal((1, M, 512)).astype(np.float32)
    got = tq.linear(torch.from_numpy(x), tqt).numpy()
    ref = np.asarray(jq.quant_matmul_xla(jnp.asarray(x), jqt))
    assert got.shape == (1, M, 64)
    tol = 0.02 if M <= 8 else 1e-5
    assert np.abs(got - ref).max() / np.abs(ref).max() < tol
    dense = tq.dequantize_qt(tqt, torch.float32)
    np.testing.assert_allclose(tq.linear(torch.from_numpy(x), dense).numpy(),
                               tq.gemv_plain(torch.from_numpy(x[0]), tqt).numpy()[None],
                               rtol=1e-5, atol=1e-5)



def _jax_int8_qt(tqt):
    """The JAX QuantTensor of the same int8 planes (the JAX packer keeps a
    Q4_0 weight whose K has no nib4c chunk in its nib4 split format, so the
    int8-with-mins case is carried over plane by plane)."""
    m = None if tqt.m is None else jnp.asarray(tqt.m.numpy())
    return jq.QuantTensor(q=jnp.asarray(tqt.q.numpy()), s=jnp.asarray(tqt.s.numpy()),
                          m=m, fmt="int8", group=tqt.group, shape=tqt.shape)


@pytest.mark.parametrize("M", [9, 100])
@pytest.mark.parametrize("qtype,K", [(GGMLType.Q8_0, 512), (GGMLType.Q6_K, 512),
                                     (GGMLType.Q4_0, 800)])
def test_qmm_plain_matches_jax_k5(qtype, K, M):
    """K5's plain version (what the wrapper runs for a CPU tensor) against
    the JAX K5 kernel in interpret mode: the same rounding points (x and
    each weight in bf16, f32 sums, mins outside), so only the order of the
    f32 sums differs."""
    N = 256
    tqt = tq.pack_gguf_tensor(_raw(qtype, N, K, seed=7), qtype, (N, K))
    assert tqt.fmt == "int8" and (tqt.m is not None) == (qtype == GGMLType.Q4_0)
    jqt = _jax_int8_qt(tqt)
    assert tq.qmm_tileable(tqt)
    assert jq._pallas_tileable(jqt.fmt, jqt.group, jqt.shape, jqt.q.shape[-1])
    x = (np.random.default_rng(8).standard_normal((M, K)) * 0.5).astype(np.float32)
    got = tq.qmm_int8(torch.from_numpy(x), tqt).numpy()
    ref = np.asarray(jq._quant_matmul_pallas(
        jnp.asarray(x), jqt.q, jqt.s, jqt.m, fmt=jqt.fmt, group=jqt.group,
        shape=jqt.shape, interpret=True))
    assert got.shape == ref.shape == (M, N)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("qtype,K,N,fold,pad", [
    (GGMLType.Q8_0, 640, 1536, False, 0), (GGMLType.Q8_0, 640, 200, False, 0),
    (GGMLType.Q8_0, 512, 200, False, 128), (GGMLType.Q8_0, 8448, 128, False, 0),
    (GGMLType.Q8_0, 8224, 128, False, 0), (GGMLType.Q6_K, 1024, 256, False, 0),
    (GGMLType.Q6_K, 1024, 256, True, 0), (GGMLType.Q4_K, 1024, 256, False, 0)])
def test_qmm_gate_matches_jax(qtype, K, N, fold, pad):
    """K5's gate against the JAX dispatch for M > 8: its Pallas kernel runs
    for int8 weights without folded scales that ``_pallas_tileable`` admits
    (nib4c and folded weights take XLA's dequant-dot there)."""
    raw = _raw(qtype, N, K, seed=9)
    jqt = jq.pack_gguf_tensor(raw, qtype, (N, K), fold_scales=fold)
    tqt = tq.pack_gguf_tensor(raw, qtype, (N, K), fold_scales=fold)
    if pad:
        jqt, tqt = jq.pad_qt_n(jqt, pad), tq.pad_qt_n(tqt, pad)
    jax_k5 = (jqt.fmt == "int8" and jqt.sd is None
              and jq._pallas_tileable(jqt.fmt, jqt.group, jqt.shape, jqt.q.shape[-1]))
    assert tq.qmm_tileable(tqt) == jax_k5
