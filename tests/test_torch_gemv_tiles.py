"""K1/K2's schedule without a card: its stages, warps, scale runs and splits in plain PyTorch.

``gemv_split_plain`` (ops/quant_matmul.py) walks the weight as csrc/gemv.cu
does: stages of 64 packed rows dealt to the splits in order, each stage's
rows shared by the block's warps, each quant group's integer product with x
(an f32 x as its bf16 high part and the bf16 remainder: two products) times
its scale row, minus the group's x sums times its min row; nib4c's low and
high nibbles as the two halves of their chunk; the warps' sums, then the
splits', added in order; cast last.  It is held to ``gemv_plain`` (f32:
1e-5) and to the JAX GEMV: ``_quant_gemv_pallas`` in interpret mode where
the JAX kernel takes the weight, else the JAX ``quant_matmul`` (K 2880 and a
ragged N 2880 have no JAX GEMV tiling), at 2e-2, the bound of
tests/test_torch_quant.py::test_gemv_plain_matches_jax (the JAX kernel rounds
x and w to bf16).  Both formats, plain and folded scales, with and without
mins, M 1, 3, 4 and 8, K 1024 and 2880, N 256, 640 and 2880 (a ragged last
tile), an f32 and a bf16 x.  The tile and split chooser (``gemv_config``) is
held to the launcher's rules in csrc/gemv.cu: the constants it mirrors, a
grid that gives every SM of an H100 a block at every
``kernel_times.GEMV_CASES`` and ``OSS_GEMV_CASES`` entry, and split counts
that deal every stage to exactly one split.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_cpp_gfx906_tpu.gguf import GGMLType, quantize
from llama_cpp_gfx906_tpu.ops import quant_matmul as jq
from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as tq
from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

SRC = (Path(tq.__file__).resolve().parents[1] / "csrc" / "gemv.cu").read_text()
H100_SMS = 132

# kind: (GGML type, K, N, folded, mins kept)
WEIGHTS = {
    "int8_q8_0_1024": (GGMLType.Q8_0, 1024, 256, False, True),
    "int8_q6_k_folded_1024": (GGMLType.Q6_K, 1024, 256, True, True),
    "int8_q6_k_plain_1024": (GGMLType.Q6_K, 1024, 256, False, True),
    "int8_q8_0_2880": (GGMLType.Q8_0, 2880, 640, False, True),
    "int8_q4_0_mins_2880_ragged": (GGMLType.Q4_0, 2880, 2880, False, True),
    "nib4c_q4_k_folded_mins_1024": (GGMLType.Q4_K, 1024, 256, True, True),
    "nib4c_q4_k_plain_mins_1024": (GGMLType.Q4_K, 1024, 256, False, True),
    "nib4c_q4_0_no_mins_1024": (GGMLType.Q4_0, 1024, 256, False, False),
    "nib4c_q4_0_mins_1024_ragged": (GGMLType.Q4_0, 1024, 2880, False, True),
}
_QTS = {}


def weight(kind):
    """(JAX, port) QuantTensors of ``kind``, packed from the same bytes."""
    if kind not in _QTS:
        qtype, K, N, fold, keep_mins = WEIGHTS[kind]
        w = np.random.default_rng(len(_QTS) + 3).standard_normal((N, K)).astype(np.float32)
        raw = quantize(w / np.sqrt(K), qtype)
        jqt = jq.pack_gguf_tensor(raw, qtype, (N, K), fold_scales=fold)
        tqt = tq.pack_gguf_tensor(raw, qtype, (N, K), fold_scales=fold)
        if not keep_mins:
            jqt = jq.QuantTensor(q=jqt.q, s=jqt.s, m=None, fmt=jqt.fmt, group=jqt.group,
                                 shape=jqt.shape, sd=jqt.sd, sgroup=jqt.sgroup)
            tqt = tq.QuantTensor(tqt.q, tqt.s, None, tqt.fmt, tqt.group, tqt.shape, tqt.sd,
                                 None, tqt.sgroup)
        assert tqt.fmt == kind.split("_")[0] and (tqt.sd is not None) == fold
        assert (tqt.m is not None) == (keep_mins and qtype in (GGMLType.Q4_0, GGMLType.Q4_K))
        _QTS[kind] = (jqt, tqt)
    return _QTS[kind]


def x_of(M, K, dtype, seed=8):
    x = torch.from_numpy(
        (np.random.default_rng(seed).standard_normal((M, K)) * 0.5).astype(np.float32))
    return x.to(dtype)


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [1, 3, 4, 8])
@pytest.mark.parametrize("kind", list(WEIGHTS))
def test_schedule_matches_plain(kind, M, dtype):
    """The stages, the warps' rows, the scale runs, the x parts and the
    splits at the chooser's tile and split count on an H100 give the plain
    version's output to f32 rounding."""
    _, qt = weight(kind)
    x = x_of(M, qt.K, dtype)
    got = tq.gemv_split_plain(x, qt)
    ref = tq.gemv_plain(x, qt)
    assert got.shape == ref.shape == (M, qt.N) and got.dtype == torch.float32
    assert torch.isfinite(got).all() and rel(got, ref) < 1e-5


@pytest.mark.parametrize("tn,splits", [(64, 1), (128, 1), (128, 3), (64, 16)])
@pytest.mark.parametrize("kind", ["int8_q6_k_folded_1024", "int8_q4_0_mins_2880_ragged",
                                  "nib4c_q4_k_folded_mins_1024", "nib4c_q4_0_no_mins_1024"])
def test_every_tile_and_split_matches_plain(kind, tn, splits):
    """64- and 128-column blocks (4 and 2 warps across each stage's rows:
    scale runs of 16 and 32 rows) and 1, 3 and 16 splits, f32 x at M 3."""
    _, qt = weight(kind)
    x = x_of(3, qt.K, torch.float32, seed=9)
    got = tq.gemv_split_plain(x, qt, tn=tn, splits=splits)
    assert rel(got, tq.gemv_plain(x, qt)) < 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("M", [1, 3, 4, 8])
@pytest.mark.parametrize("kind", list(WEIGHTS))
def test_schedule_matches_jax(kind, M, dtype):
    """The schedule against the JAX GEMV on the same planes: its Pallas
    kernel in interpret mode where its tiling takes the weight, else its
    ``quant_matmul``; with the mins the JAX wrapper takes after its kernel."""
    jqt, qt = weight(kind)
    x = x_of(M, qt.K, dtype)
    xj = jnp.asarray(x.float().numpy())
    if jq._gemv_tiles(jqt) is not None:
        want = jq._quant_gemv_pallas(xj, jqt.q, jqt.s, jqt.m, jqt.sd, jqt.md, fmt=jqt.fmt,
                                     group=jqt.group, sgroup=jqt.sgroup or 0,
                                     shape=jqt.shape, interpret=True)
    else:
        assert qt.K == 2880 or qt.N == 2880
        want = jq.quant_matmul(xj, jqt)
    got = tq.gemv_split_plain(x, qt).numpy()
    assert got.shape == np.asarray(want).shape == (M, qt.N)
    assert rel(got, want) < 2e-2


@pytest.mark.parametrize("kind", ["int8_q4_0_mins_2880_ragged", "nib4c_q4_k_folded_mins_1024"])
def test_output_cast_is_last(kind):
    """A bf16 output is the f32 result rounded once."""
    _, qt = weight(kind)
    x = x_of(4, qt.K, torch.bfloat16)
    got = tq.gemv_split_plain(x, qt, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, tq.gemv_split_plain(x, qt).to(torch.bfloat16))


def test_x_parts():
    """An f32 x is its bf16 high part plus the bf16 remainder to ~2^-17; a
    bf16 x is one part, as it is."""
    x = x_of(8, 1024, torch.float32)
    hi, lo = tq._gemv_x_parts(x)
    assert torch.equal(hi, x.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    assert float(((hi + lo) - x).abs().max() / x.abs().max()) < 2 ** -16
    xb = x.to(torch.bfloat16)
    (only,) = tq._gemv_x_parts(xb)
    assert torch.equal(only, xb.float())


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_constants_match_the_kernel():
    """The Python mirror of the launcher reads the kernel's own numbers."""
    assert (_cu_const("SK"), _cu_const("MAX_SPLIT"), _cu_const("MAX_M"), _cu_const("NCW")) == (
        tq.GEMV_STAGE, tq.GEMV_MAX_SPLITS, tq.GEMV_MAX_M, tq.GEMV_WARPS)
    assert "(group != 16 && group != 32)" in SRC and tq.GEMV_GROUPS == (16, 32)
    assert "(tn != 64 && tn != 128)" in SRC and sorted(tq.GEMV_TILES) == [64, 128]
    # stages dealt to splits as qmm_split_steps deals K5's steps
    assert "st0 = split * nst_all / a.nsplit, st1 = (split + 1) * nst_all / a.nsplit" in SRC
    assert "nsplit > MAX_SPLIT || nsplit > nsteps" in SRC
    # the warps of a block: 64 columns each, the rest across each stage's rows
    assert "constexpr int SLABS = TN / 64, KP = NCW / SLABS, R = SK / KP;" in SRC
    assert "constexpr int RL = R < G ? R : G, RUNS = R / RL, STEPS = RL / 16;" in SRC
    # the warps' sums, then the splits', in order
    assert "for (int kk = 0; kk < KP; ++kk) v += rp[" in SRC


GEMV_SHAPES = [(c[1], c[2], c[3], c[4], c[5]) for c in (*kt.GEMV_CASES, *kt.OSS_GEMV_CASES)]


def _stored(gtype, K, N, pad):
    """(packed rows, stored columns) of a GEMV case's weight, as the loader
    packs it: nib4c where a 4-bit type's K has a chunk; the head padded to
    2048 columns."""
    nib = gtype in ("Q4_0", "Q4_K") and tq.nib4c_chunk(K) is not None
    return (K // 2 if nib else K), (-(-N // 2048) * 2048 if pad else N)


@pytest.mark.parametrize("case,gtype,K,N,pad", GEMV_SHAPES, ids=[s[0] for s in GEMV_SHAPES])
def test_config_covers_the_card(case, gtype, K, N, pad):
    """At every GEMV case on an H100: a tile width and a split count the
    launcher takes, every SM given a block, and every stage dealt to
    exactly one split, in order; the heads, whose tiles already fill the
    card, take 128-column tiles and one split."""
    kp, Np = _stored(gtype, K, N, pad)
    tn, splits = tq.gemv_config(kp, Np, H100_SMS)
    stages = kp // tq.GEMV_STAGE
    assert tn in tq.GEMV_TILES and 1 <= splits <= min(tq.GEMV_MAX_SPLITS, stages)
    assert -(-Np // tn) * splits >= H100_SMS
    dealt = [i for r in tq.qmm_split_steps(stages, splits) for i in r]
    assert dealt == list(range(stages))
    if pad:
        assert (tn, splits) == (128, 1)


@pytest.mark.parametrize("sms", [1, 16, 132, 1000])
def test_config_limits(sms):
    """Any card: the splits stay within the cluster limit and the stages;
    128-column tiles unless they leave SMs idle at every split count; a
    card already full of tiles takes one split."""
    for kp, Np in ((512, 256), (2048, 640), (2880, 5120), (4096, 1024), (7168, 4096),
                   (4096, 129024)):
        tn, s = tq.gemv_config(kp, Np, sms)
        stages = kp // tq.GEMV_STAGE
        assert 1 <= s <= min(tq.GEMV_MAX_SPLITS, stages)
        if -(-Np // 128) * min(tq.GEMV_MAX_SPLITS, stages) >= sms:
            assert tn == 128
        if -(-Np // 128) >= sms:
            assert s == 1
