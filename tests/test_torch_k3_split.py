"""K3's split-KV design without a card: the split and merge in plain PyTorch.

``flash_decode_split_plain`` (ops/flash_decode.py) computes each split's
softmax state over the keys the kernel's rule (``split_rows``) deals it,
then merges the states in split order with the sink joining once, as
csrc/flash_decode.cu does.  It is held to ``flash_decode_plain`` (one
softmax over all keys, f32: 1e-5) and to the JAX ``flash_decode`` in
interpret mode (2e-2, the bound of tests/test_flash_decode.py: the JAX
kernel rounds q and p to bf16; 3e-2 with int8 rows and ALiBi, as
tests/test_torch_alibi.py holds that mode) in every mode: int8 rows, a
shared segment, ALiBi, logical positions, sinks, a window, a softcap; at
n_past 0, 1, 15 and 16 (the key tile is 16 rows), on each side of a split
edge and at S - 1; with 1, 3, 4 and 32 splits of at least 1 or 2 tiles
(32 leaves splits without a key), and the split count and minimum the
kernel takes on an H100 (one split over this short cache).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from llama_cpp_gfx906_tpu.ops.attention import alibi_slopes_for as j_slopes
from llama_cpp_gfx906_tpu.ops.flash_decode import flash_decode as j_flash_decode
from llama_cpp_gfx906_tpu.ops.kv_quant import quantize_rows as j_quantize_rows
from llama_cpp_gfx906_tpu_torch.ops import flash_decode as fd
from llama_cpp_gfx906_tpu_torch.ops.kv_quant import QuantKV

S, D, Hq, Hkv, BK = 128, 64, 4, 2, fd.KEY_TILE
# n_past of the 4 slots of one call, (T, groups): the tile edges BK - 1 and
# BK; three tiles exactly and one row past (with 3 splits: one tile each,
# then a split of two); five tiles; the last row S - 1
N_PAST = {1: ((0, 1, BK - 1, BK), (3 * BK - 1, 3 * BK, 4 * BK, S - 1)),
          4: ((0, 1, BK - 4, BK - 3), (3 * BK - 4, 3 * BK - 3, 4 * BK, S - 4))}
# mode: (T, int8, shared rows, flash_decode keywords)
MODES = {
    "bf16": (1, False, 0, {}),
    "int8": (1, True, 0, {}),
    "shared": (1, False, 40, {}),
    "int8_shared_window": (1, True, 40, dict(sliding_window=50)),
    "alibi": (1, False, 0, dict(alibi=True)),
    "int8_alibi": (1, True, 0, dict(alibi=True)),
    "shared_alibi_window": (1, False, 40, dict(alibi=True, sliding_window=60)),
    "pos": (4, False, 0, dict(pos=2)),
    "int8_pos_window": (4, True, 0, dict(pos=3, sliding_window=12)),
    "alibi_pos": (1, False, 0, dict(alibi=True, pos=2)),
    "sinks": (1, False, 0, dict(sinks=True)),
    "sinks_window_t4": (4, False, 0, dict(sinks=True, sliding_window=20)),
    "shared_sinks_softcap": (1, False, 40, dict(sinks=True, logit_softcap=3.0)),
    "softcap_window": (4, False, 0, dict(logit_softcap=3.0, sliding_window=33)),
}


def case(mode, group, seed=0):
    """numpy inputs of ``mode`` with the slots' n_past of ``group``: q, k,
    v, n_past, shared rows (or None) and flash_decode's keywords."""
    T, _, S0, opts = MODES[mode]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((4, T, Hq, D)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((4, S, Hkv, D)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((4, S, Hkv, D)) * 0.5).astype(np.float32)
    n_past = np.asarray(N_PAST[T][group], np.int32)
    sh = (rng.standard_normal((2, 1, S0, Hkv, D)) * 0.5).astype(np.float32) if S0 else None
    kw = {k_: v_ for k_, v_ in opts.items() if k_ in ("sliding_window", "logit_softcap")}
    if opts.get("sinks"):
        kw["sinks"] = (rng.standard_normal(Hq) * 2).astype(np.float32)
    if opts.get("alibi"):
        kw["alibi_slopes"] = np.asarray(j_slopes(Hq), np.float32)
    if "pos" in opts:
        kw["kv_pos"] = np.broadcast_to(np.arange(S, dtype=np.int32) // opts["pos"], (4, S)).copy()
        kw["q_pos"] = ((n_past[:, None] + np.arange(T)) // opts["pos"]).astype(np.int32)
    return q, k, v, n_past, sh, kw


def port_args(mode, group):
    """The port's arguments (torch, f32 on the CPU) and the JAX reference's
    cache planes: the int8 rows are JAX's, handed to both."""
    q, k, v, n_past, sh, kw = case(mode, group)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if MODES[mode][1]:
        jk, jv = j_quantize_rows(jk), j_quantize_rows(jv)
        tk = QuantKV(torch.from_numpy(np.array(jk.q)), torch.from_numpy(np.array(jk.s)))
        tv = QuantKV(torch.from_numpy(np.array(jv.q)), torch.from_numpy(np.array(jv.s)))
    tkw = {k_: torch.from_numpy(np.array(v_)) if isinstance(v_, np.ndarray) else v_
           for k_, v_ in kw.items()}
    if sh is not None:
        tkw.update(shared_k=torch.from_numpy(sh[0]), shared_v=torch.from_numpy(sh[1]))
    args = (torch.from_numpy(q), tk, tv, torch.from_numpy(n_past), D ** -0.5)
    return args, tkw, (jk, jv)


def rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("nsplit,min_tiles", [(1, 1), (3, 1), (32, 1), (4, 2),
                                              (None, fd.SPLIT_MIN_TILES)])
@pytest.mark.parametrize("group", [0, 1])
@pytest.mark.parametrize("mode", list(MODES))
def test_split_plain_matches_plain(mode, group, nsplit, min_tiles):
    """The split and merge gives the one-softmax plain version's output, to
    f32 rounding, whatever the split count."""
    args, kw, _ = port_args(mode, group)
    got = fd.flash_decode_split_plain(*args, nsplit=nsplit, min_tiles=min_tiles, **kw)
    ref = fd.flash_decode_plain(*args, **kw)
    assert got.shape == args[0].shape and torch.isfinite(got).all()
    assert rel(got, ref) < 1e-5


@pytest.mark.parametrize("min_tiles", [1, fd.SPLIT_MIN_TILES])
@pytest.mark.parametrize("group", [0, 1])
@pytest.mark.parametrize("mode", list(MODES))
def test_split_plain_matches_jax(mode, group, min_tiles):
    """The split and merge at the split count the kernel takes on an H100
    (a tile each of a full cache here), splits of one tile or more (most
    splits of the short slots hold no key) and of the kernel's minimum,
    against the JAX kernel in interpret mode."""
    args, kw, (jk, jv) = port_args(mode, group)
    q, k, v, n_past, sh, jkw = case(mode, group)
    jkw = {k_: jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_ for k_, v_ in jkw.items()}
    if sh is not None:
        jkw.update(shared_k=jnp.asarray(sh[0]), shared_v=jnp.asarray(sh[1]))
    want = j_flash_decode(jnp.asarray(q), jk, jv, jnp.asarray(n_past), D ** -0.5,
                          interpret=True, **jkw)
    got = fd.flash_decode_split_plain(*args, min_tiles=min_tiles, **kw)
    tol = 3e-2 if MODES[mode][1] and "alibi" in mode else 2e-2
    assert rel(got.numpy(), want) < tol


def test_split_count_from_shapes():
    """``splits`` reads shapes only: up to two blocks an SM, at most 32
    splits and at most the key tiles of a full cache; a launch's blocks stay
    within 2 an SM whenever it splits, which sizes the workspace."""
    assert fd.splits(1, 8, 4, 8192) == 32           # the 8B at B 1: 8 heads
    assert fd.splits(1, 32, 1, 4096) == 8           # MPT-7B: 32 heads
    assert fd.splits(4, 8, 4, 4096) == 8            # the 8B, 4 slots
    assert fd.splits(1, 32, 101, 4096) == 1         # a prefill chunk: 416 blocks
    assert fd.splits(2, 2, 2, 40) == 3              # 3 tiles of a 40-row cache
    assert fd.splits(1, 8, 8, 0, S0=512) == 32
    for B in (1, 2, 4, 8):
        for Hkv in (1, 2, 4, 8, 32):
            for NQ in (1, 4, 8, 101, 128):
                n = fd.splits(B, Hkv, NQ, 8192)
                tiles = B * Hkv * -(-NQ // fd.query_tile(NQ))
                assert 1 <= n <= fd.MAX_SPLITS
                assert n == 1 or tiles * n <= 2 * fd.H100_SMS


@pytest.mark.parametrize("min_tiles", [1, fd.SPLIT_MIN_TILES])
@pytest.mark.parametrize("window,S0,positions", [
    (0, 0, False), (0, 40, False), (50, 40, False), (20, 0, False), (0, 0, True),
    (20, 0, True)])
def test_split_rows_deal_out_the_live_rows(window, S0, positions, min_tiles):
    """Every live row (the shared rows inside the window, the own rows from
    the window's start, every own row with logical positions, up to
    n_past + T) goes to exactly one split, in order, in whole tiles but the
    segments' last; a split takes min_tiles tiles or more, so some splits
    are empty."""
    T = 2
    for n_past in (0, 1, BK - 1, BK, 3 * BK - 2, S - T):
        for nsplit in (1, 3, 32):
            runs = fd.split_rows(n_past, T, S, S0, window, positions, nsplit, min_tiles)
            assert len(runs) == nsplit
            rows = torch.cat(runs).tolist()
            lo = max(0, n_past + 1 - window) if window and not positions else 0
            slo = max(0, S0 + n_past + 1 - window) if window else 0
            live = list(range(min(slo, S0), S0)) + [S0 + r for r in range(lo, n_past + T)]
            assert rows == live
            if nsplit == 32 and n_past == 0 and not S0:
                assert sum(r.numel() == 0 for r in runs) >= 30


def test_empty_split_is_neutral():
    """A split without keys leaves m = -1e30, l = 0, acc = 0: the merge
    weighs it 0, so 32 splits of one live row give the plain output."""
    args, kw, _ = port_args("sinks", 0)
    n_past = args[3]
    assert sum(r.numel() == 0 for r in fd.split_rows(int(n_past[0]), 1, S, 0, 0, False, 32)) == 31
    ref = fd.flash_decode_plain(*args, **kw)
    assert rel(fd.flash_decode_split_plain(*args, nsplit=32, **kw), ref) < 1e-5


def test_kernel_takes_the_wrappers_split_constants():
    """The kernel's compile-time key tile and split bound are the wrapper's;
    the tiles a split takes at least are passed in at each launch, so the
    kernel keeps no copy of them."""
    src = (Path(fd.__file__).parents[1] / "csrc" / "flash_decode.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["SUB"] == fd.KEY_TILE and consts["MAX_SPLIT"] == fd.MAX_SPLITS
    assert "MIN_TILES" not in consts and "int min_tiles" in src
