"""K5's tiled schedule without a card: its K steps, splits and epilogue in plain PyTorch.

``qmm_split_plain`` (ops/quant_matmul.py) walks the weight as
csrc/qmm.cu does: K steps of 64 packed rows with a 32-row tail, each step's
rows dequantized with their own scale rows (a step spans 2 scale rows at
group 32, 4 at group 16) and rounded to bf16; the mins from each step's
per-group x sums, summed apart; a tile's K split over blocks whose partials
are added in split order; the product minus the mins, cast last.  It is
held to ``qmm_plain`` (f32: 1e-5) and to the JAX ``_quant_matmul_pallas``
in interpret mode (1e-5, the bound of
tests/test_torch_quant.py::test_qmm_plain_matches_jax_k5: the same rounding
points, only the order of the f32 sums differs), in both modes (int8,
split-K nib4), at K 800 (a tail step), 1440 per nib4 half (a tail step
per half), 2880 and 14336, at M 9, 65, 101 and 676 (ragged row tiles of 64
and 128), with and without mins, at group 32 and 16.  The split chooser
(``qmm_config``) is held to the launcher's rules in csrc/qmm.cu: the
constants it mirrors, a grid that covers the SMs at every
``kernel_times.QMM_CASES`` entry, and split counts that deal every K step
to exactly one split.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_cpp_gfx906_tpu.ops import quant_matmul as jq
from llama_cpp_gfx906_tpu_torch.gguf.constants import GGMLType
from llama_cpp_gfx906_tpu_torch.gguf.quants import quantize
from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as tq
from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt
from llama_cpp_gfx906_tpu_torch.tools import synth_gguf

SRC = (Path(tq.__file__).resolve().parents[1] / "csrc" / "qmm.cu").read_text()
N = 128
H100_SMS = 132


def _raw(qtype, rows, K, seed):
    rng = np.random.default_rng(seed)
    if qtype in (GGMLType.Q4_K, GGMLType.Q6_K):  # no quantizer here: valid blocks
        return synth_gguf._ROWS[qtype](rng, rows, K).reshape(-1)
    w = rng.standard_normal((rows, K)).astype(np.float32)
    return quantize(w / np.sqrt(K), qtype)


def _weight(kind):
    """The port's QuantTensor of ``kind``: (mode, GGML type, K, mins)."""
    mode, qtype, K, mins = WEIGHTS[kind]
    if mode == "nib4":  # one expert of a split-K nib4 stack (no nib4c chunk)
        qt = tq.qt_expert(tq.pack_gguf_experts(_raw(qtype, 2 * N, K, 3), qtype, (2, N, K)), 1)
    elif kind == "int8_g16_mins_14336":  # Q4_K experts unified to int8, group 16
        qt = tq.qt_expert(tq.pack_experts_int8_g16(_raw(qtype, 2 * N, K, 4), qtype,
                                                   (2, N, K)), 0)
    else:
        qt = tq.pack_gguf_tensor(_raw(qtype, N, K, 5), qtype, (N, K))
    if not mins:
        qt = tq.QuantTensor(qt.q, qt.s, None, qt.fmt, qt.group, qt.shape)
    assert qt.fmt == mode and (qt.m is not None) == mins and tq.qmm_tileable(qt)
    return qt


# kind: (mode, GGML type, K, mins)
WEIGHTS = {
    "int8_800": ("int8", GGMLType.Q8_0, 800, False),
    "int8_800_mins": ("int8", GGMLType.Q4_0, 800, True),
    "int8_2880": ("int8", GGMLType.Q8_0, 2880, False),
    "int8_2880_mins": ("int8", GGMLType.Q4_0, 2880, True),
    "int8_14336": ("int8", GGMLType.Q8_0, 14336, False),
    "int8_g16_14336": ("int8", GGMLType.Q6_K, 14336, False),
    "int8_g16_mins_14336": ("int8", GGMLType.Q4_K, 14336, True),
    "nib4_2880": ("nib4", GGMLType.Q4_0, 2880, False),
    "nib4_2880_mins": ("nib4", GGMLType.Q4_0, 2880, True),
}
_QTS = {}


def weight(kind):
    if kind not in _QTS:
        _QTS[kind] = _weight(kind)
    return _QTS[kind]


def x_of(M, K, seed=8):
    return (np.random.default_rng(seed).standard_normal((M, K)) * 0.5).astype(np.float32)


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("splits", [None, 1, 3, 8])
@pytest.mark.parametrize("M", [9, 65, 101, 676])
@pytest.mark.parametrize("kind", list(WEIGHTS))
def test_schedule_matches_plain(kind, M, splits):
    """The steps, the tail, the scale rows a step spans, the mins from each
    step's x sums and the partials added in split order give the plain
    version's output to f32 rounding, at the chooser's split count on an
    H100 and at 1, 3 and 8 splits."""
    qt = weight(kind)
    x = torch.from_numpy(x_of(M, qt.K))
    got = tq.qmm_split_plain(x, qt, splits=splits)
    ref = tq.qmm_plain(x, qt)
    assert got.shape == ref.shape == (M, N) and got.dtype == torch.float32
    assert torch.isfinite(got).all() and rel(got, ref) < 1e-5


@pytest.mark.parametrize("M", [9, 65, 101, 676])
@pytest.mark.parametrize("kind", list(WEIGHTS))
def test_schedule_matches_jax(kind, M):
    """The schedule at the chooser's split count against the JAX K5 kernel
    in interpret mode (the same planes), with its mins taken after it."""
    qt = weight(kind)
    x = x_of(M, qt.K)
    m = None if qt.m is None else jnp.asarray(qt.m.numpy())
    want = np.asarray(jq._quant_matmul_pallas(
        jnp.asarray(x), jnp.asarray(qt.q.numpy()), jnp.asarray(qt.s.numpy()), m, fmt=qt.fmt,
        group=qt.group, shape=qt.shape, interpret=True))
    got = tq.qmm_split_plain(torch.from_numpy(x), qt).numpy()
    assert got.shape == want.shape == (M, N)
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("kind", ["int8_800_mins", "nib4_2880_mins", "int8_g16_14336"])
def test_output_cast_is_last(kind):
    """A bf16 output is the f32 result rounded once, in the schedule as in
    the plain version."""
    qt = weight(kind)
    x = torch.from_numpy(x_of(101, qt.K))
    for splits in (1, 5):
        got = tq.qmm_split_plain(x, qt, torch.bfloat16, splits=splits)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, tq.qmm_split_plain(x, qt, splits=splits).to(torch.bfloat16))
    assert torch.equal(tq.qmm_plain(x, qt, torch.bfloat16),
                       tq.qmm_plain(x, qt).to(torch.bfloat16))


def test_steps_and_tail():
    """64-row steps and one 32-row tail where the packed K is 32 times an
    odd number (K 800; gpt-oss's nib4 half of 1440)."""
    assert tq.qmm_steps(800) == [(64 * i, 64) for i in range(12)] + [(768, 32)]
    assert tq.qmm_steps(1440)[-1] == (1408, 32) and len(tq.qmm_steps(1440)) == 23
    assert tq.qmm_steps(2880) == [(64 * i, 64) for i in range(45)]
    assert len(tq.qmm_steps(14336)) == 224


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def test_constants_match_the_kernel():
    """The Python mirror of the launcher reads the kernel's own numbers."""
    assert (_cu_const("BN"), _cu_const("BK"), _cu_const("TAIL"), _cu_const("MAX_SPLIT")) == (
        tq.QMM_BN, tq.QMM_STEP, tq.QMM_TAIL, tq.QMM_MAX_SPLITS)
    assert "(group != 16 && group != 32)" in SRC and tq.QMM_GROUPS == (16, 32)
    assert "(bm != 64 && bm != 128)" in SRC
    # the kernel deals steps to splits as qmm_split_steps does
    assert "st0 = split * nsteps / nsplit, st1 = (split + 1) * nsteps / nsplit" in SRC
    assert "nsplit > MAX_SPLIT || nsplit > nsteps" in SRC
    # the blocks an SM holds, which the chooser's cost counts
    assert "__launch_bounds__(NT, (NIB || MINS) ? 1 : 2)" in SRC
    assert [tq.qmm_blocks_per_sm(n, m) for n in (0, 1) for m in (0, 1)] == [2, 1, 1, 1]


@pytest.mark.parametrize("spec", kt.QMM_CASES, ids=[c[1] for c in kt.QMM_CASES])
def test_config_covers_the_card(spec):
    """At every case of QMM_CASES on an H100: 64- or 128-row tiles as M
    and the card say, a split count the launcher takes, every SM given a block, and
    every K step dealt to exactly one split, in order."""
    mode, _, _, K, N_, M = spec
    kp = K // 2 if mode == "nib4" else K
    Np = -(-N_ // 512) * 512 if mode == "nib4" else N_  # gpt-oss's padded N
    bm, splits = tq.qmm_config(M, kp, Np, H100_SMS, mode == "nib4", spec[2] == "Q4_0")
    full = -(-M // 128) * (Np // tq.QMM_BN) * min(tq.QMM_MAX_SPLITS, len(tq.qmm_steps(kp)))
    assert bm == (64 if M <= 64 or full < H100_SMS else 128)
    steps = len(tq.qmm_steps(kp))
    assert 1 <= splits <= min(tq.QMM_MAX_SPLITS, steps)
    assert -(-M // bm) * (Np // tq.QMM_BN) * splits >= H100_SMS
    dealt = [i for r in tq.qmm_split_steps(steps, splits) for i in r]
    assert dealt == list(range(steps))
    assert all(len(r) >= 1 for r in tq.qmm_split_steps(steps, splits))


@pytest.mark.parametrize("sms", [1, 16, 132, 1000])
def test_config_limits(sms):
    """Any card: the splits stay within the cluster limit and the steps; a
    card already full of tiles takes few splits."""
    for M, kp, Np in ((9, 800, 128), (676, 2048, 640), (1000, 1440, 3072),
                      (256, 4096, 14336), (65, 14336, 4096)):
        bm, s = tq.qmm_config(M, kp, Np, sms)
        steps = len(tq.qmm_steps(kp))
        assert 1 <= s <= min(tq.QMM_MAX_SPLITS, steps)
        if -(-M // bm) * (Np // tq.QMM_BN) >= 2 * sms:
            assert s <= 2
