"""The split-K nib4 layout and the nib4 modes of K5 and K8 (port
``ops/quant_matmul.py``) against the JAX package on the CPU, and K1 at a K
of 64 rows past a multiple of 128 (gpt-oss's 2880).

Inputs come from numpy seeds.  Tolerances:
- packing: byte-equal planes, bit-equal dequantized values;
- the plain versions against the JAX kernels in interpret mode: 1e-5 of
  max |jax| (the same rounding points: x and each weight in bf16, f32 sums,
  mins outside (K5) or folded into the weight (K8); only the order of the
  f32 sums differs);
- K1's plain version against the JAX XLA matmul: 2e-2 (the JAX CPU path
  rounds its weights to bf16, the plain version keeps f32);
- gates: equal booleans.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_cpp_gfx906_tpu.gguf import GGMLType, quantize
from llama_cpp_gfx906_tpu.ops import quant_matmul as jq
from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as tq


def _raw(seed: int, rows: int, K: int, qtype=GGMLType.Q4_0) -> np.ndarray:
    w = np.random.default_rng(seed).standard_normal((rows, K)).astype(np.float32)
    return quantize(w / np.sqrt(K), qtype)


def _experts(E: int, N: int, K: int, seed: int = 1, pad_n: bool = False):
    """(JAX, port) stacked Q4_0 experts packed from the same bytes."""
    raw = _raw(seed, E * N, K)
    jt = jq.pack_gguf_experts(raw, GGMLType.Q4_0, (E, N, K), put=np.asarray, pad_n=pad_n)
    tt = tq.pack_gguf_experts(raw, GGMLType.Q4_0, (E, N, K), pad_n=pad_n)
    return jt, tt


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("K,N,pad_n", [(320, 128, False), (320, 320, True),
                                       (2880, 128, False), (2880, 2880, True)])
def test_nib4_expert_bytes_match_jax(K, N, pad_n):
    """Q4_0 experts whose K has no nib4c chunk: the port's split-K nib4
    planes hold the JAX package's bytes (the low nibble the first K half)."""
    jt, tt = _experts(2, N, K, pad_n=pad_n)
    assert jt.fmt == tt.fmt == "nib4"
    assert (tt.group, tt.shape) == (jt.group, tuple(jt.shape))
    assert tt.q.shape == (2, K // 2, -(-N // 512) * 512 if pad_n else N)
    for name in ("q", "s", "m"):
        assert np.asarray(getattr(jt, name)).tobytes() == getattr(tt, name).numpy().tobytes()
    np.testing.assert_array_equal(tq.dequantize_qt_experts(tt, torch.float32).numpy(),
                                  np.asarray(jq.dequantize_qt_experts(jt, jnp.float32)))
    e1 = tq.qt_expert(tt, 1)
    np.testing.assert_array_equal(
        tq.dequantize_qt(e1, torch.float32).numpy(),
        np.asarray(jq.dequantize_qt_experts(jt, jnp.float32))[1][:, : tt.N])


@pytest.mark.parametrize("K", [320, 2880])
@pytest.mark.parametrize("M", [9, 101])
def test_qmm_nib4_plain_matches_jax_kernel(K, M):
    """K5-nib4's plain version (what ``qmm_nib4`` runs on the CPU) against
    the JAX K5 nib4 kernel in interpret mode, on one expert of a stack
    padded as the loader pads gpt-oss's gate and up (N 2880 -> 3072 at
    K 2880)."""
    N = 320 if K == 320 else 2880
    jt, tt = _experts(2, N, K, seed=3, pad_n=True)
    je, te = jq.qt_expert(jt, 1), tq.qt_expert(tt, 1)
    assert tq.qmm_tileable(te)
    x = (np.random.default_rng(4).standard_normal((M, K)) * 0.5).astype(np.float32)
    ref = np.asarray(jq._quant_matmul_pallas(
        jnp.asarray(x), je.q, je.s, je.m, fmt="nib4", group=je.group, shape=je.shape,
        interpret=True))
    got = tq.qmm_nib4(torch.from_numpy(x), te)
    assert got.shape == ref.shape == (M, te.N)
    assert _rel(got, ref) < 1e-5
    assert _rel(tq.quant_matmul(torch.from_numpy(x), te), ref) < 2e-2  # the CPU route


@pytest.mark.parametrize("K,P", [(320, 3), (2880, 4), (2880, 8)])
def test_rqmm_nib4_plain_matches_jax_kernel(K, P):
    """K8-nib4's plain version against the JAX routed kernel's nib4 mode
    in interpret mode, with mins (Q4_0: m = 8 d), ids repeating."""
    N = 320 if K == 320 else 2880
    jt, tt = _experts(4, N, K, seed=5, pad_n=True)
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((P, K)) * 0.5).astype(np.float32)
    idx = rng.integers(0, 4, P).astype(np.int32)
    idx[-1] = idx[0]
    ref = np.asarray(jq._routed_qmm_pallas(
        jnp.asarray(x), jt.q, jt.s, jt.m, jnp.asarray(idx), fmt="nib4", group=jt.group,
        shape=jt.shape, has_m=True, interpret=True))
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    got = tq.rqmm_nib4(xt, tt, it)
    assert got.shape == ref.shape == (P, tt.N)
    assert _rel(got, ref) < 1e-5
    gather = np.asarray(jq.routed_quant_matmul_xla(jnp.asarray(x), jt, jnp.asarray(idx)))
    assert _rel(tq.routed_quant_matmul(xt, tt, it.long()), gather) < 1e-5


@pytest.mark.parametrize("E,N,K,pad_n,drop", [
    (2, 128, 320, False, 0), (2, 320, 320, True, 0), (2, 2880, 2880, True, 0),
    (2, 96, 320, False, 0),        # stored N not a multiple of 128
    (2, 128, 17984, False, 0),     # each K half 8992 rows: no tile, too long
    (2, 128, 16448, False, 0),     # halves of 8224: whole, too long
    (2, 128, 2880, False, 64),     # an N whose tail the kernel grid would drop
])
def test_nib4_gate_matches_jax(E, N, K, pad_n, drop):
    """K5's and K8's gate on nib4 weights against JAX ``_pallas_tileable``:
    the stored N a multiple of 128, and each K half tiled by 512 or 256
    rows of at least 8 groups, or at most 8192 rows whole."""
    jt, tt = _experts(E, N, K, pad_n=pad_n)
    if drop:  # a stored width of N - drop columns
        jt = jq.QuantTensor(q=jt.q[..., :-drop], s=jt.s[..., :-drop], m=jt.m[..., :-drop],
                            fmt=jt.fmt, group=jt.group, shape=(K, N - drop))
        tt = tq.QuantTensor(tt.q[..., :-drop].contiguous(), tt.s[..., :-drop].contiguous(),
                            tt.m[..., :-drop].contiguous(), tt.fmt, tt.group, (K, N - drop))
    want = jq._pallas_tileable(jt.fmt, jt.group, jt.shape, jt.q.shape[-1])
    assert tt.fmt == "nib4" and tq.qmm_tileable(tt) == want
    assert tq.qmm_tileable(tq.qt_expert(tt, 0)) == want


@pytest.mark.parametrize("N", [512, 2880, 5120])
def test_gemv_segment_at_k_2880(N):
    """K1 takes gpt-oss's K = 2880 (a Q4_0 or Q8_0 projection without a
    nib4c chunk stays int8) in 45 stages of 64 rows, dealt in order to at
    most 16 splits that give every SM a block where the tiles allow (K6's
    GEMV units: 64-row segments, 2 rows a thread inside one 32-row group);
    its plain version against the JAX CPU matmul."""
    for qtype in (GGMLType.Q4_0, GGMLType.Q8_0):
        raw = _raw(7, N, 2880, qtype)
        tqt = tq.pack_gguf_tensor(raw, qtype, (N, 2880))
        assert tqt.fmt == "int8" and (tqt.m is not None) == (qtype == GGMLType.Q4_0)
        assert tq._gemv_segment(tqt) == (64, 0)
        for sms in (1, 8, 132):
            tn, splits = tq.gemv_config(2880, N, sms)
            assert 1 <= splits <= 16 and (splits == 16 or -(-N // tn) * splits >= sms)
            assert [i for r in tq.qmm_split_steps(45, splits) for i in r] == list(range(45))
        x = np.random.default_rng(8).standard_normal((1, 2880)).astype(np.float32)
        jqt = jq.pack_gguf_tensor(raw, qtype, (N, 2880))
        ref = np.asarray(jq.quant_matmul(jnp.asarray(x), jqt))
        assert _rel(tq.quant_matmul(torch.from_numpy(x), tqt), ref) < 2e-2
