"""Write a structurally valid synthetic llama GGUF at a chosen scale.

For loading and timing the engine where no real checkpoint is at hand:
block payloads are valid (finite f16 scales, random quants), so the engine
loads and decodes at a real model's speed, which does not depend on the
values.  Not for quality metrics.  A few distinct rows per tensor are drawn
from ``--seed`` and tiled, so the 8B file is written in seconds.

Two quant mixes, with an F16 token embedding in both:
- Q4_K_M (``8b``, ``3b``, ``small``, ``tiny``), as ``scripts/make_synth_gguf.py``:
  Q4_K projections, a Q6_K ``attn_v`` and a Q6_K ``output``;
- Q8_0 (``270m-q8_0``, ``tiny-q8_0``): every projection and the output.
  ``270m-q8_0`` is the Gemma-3-270M shape that ``bench.py`` decodes (run as
  a llama); its layers hold 6.27 MB of int8 planes and scales, the JAX
  forward's single-launch (K7) shape.

Usage:
    python -m llama_cpp_gfx906_tpu_torch.tools.synth_gguf out.gguf [--preset 8b] [--seed 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.writer import GGUFWriter

PRESETS = {
    # (L, D, heads, kv, head_dim, F, V, quant mix)
    "8b": (32, 4096, 32, 8, 128, 14336, 128256, "q4_k_m"),
    "3b": (28, 3072, 24, 8, 128, 8192, 128256, "q4_k_m"),
    "small": (2, 512, 4, 1, 128, 1024, 2048, "q4_k_m"),
    "tiny": (2, 256, 2, 1, 128, 512, 2048, "q4_k_m"),
    "270m-q8_0": (18, 640, 4, 1, 256, 2048, 262144, "q8_0"),
    "tiny-q8_0": (2, 256, 2, 1, 128, 512, 2048, "q8_0"),
}
DISTINCT_ROWS = 64


def _tile(rows: np.ndarray, n_rows: int) -> np.ndarray:
    return np.tile(rows, (-(-n_rows // rows.shape[0]), 1))[:n_rows]


def _f16_bytes(v: float) -> np.ndarray:
    return np.frombuffer(np.float16(v).tobytes(), np.uint8)


# Every generator below gives zero-mean weights of rms about 1/sqrt(K), so a
# projection roughly keeps the norm of its input: the layer stack neither
# blows up nor amplifies rounding noise, and a decode kernel can be held
# against its plain version through a full-depth stack.


def q4k_rows(rng, n_rows: int, K: int) -> np.ndarray:
    """(n_rows, K/256*144) valid Q4_K block bytes: each sub-block's 6-bit
    min equals its scale v and dmin = 7.5 d, so w = d v (q - 7.5)."""
    nb = K // 256
    n = min(n_rows, DISTINCT_ROWS)
    d = 1.0 / (36.8 * 4.61 * np.sqrt(K))  # rms of v in 1..63, of q in 0..15
    v = rng.integers(1, 64, (n, nb, 8), dtype=np.uint8)
    lo, hi = v[..., :4], v[..., 4:]
    sc = np.empty((n, nb, 12), np.uint8)
    sc[..., 0:4] = sc[..., 4:8] = lo | ((hi >> 4) << 6)  # scales, mins 0..3
    sc[..., 8:12] = (hi & 0xF) | ((hi & 0xF) << 4)       # scales, mins 4..7
    blk = np.zeros((n, nb, 144), np.uint8)
    blk[:, :, 0:2] = _f16_bytes(d)
    blk[:, :, 2:4] = _f16_bytes(7.5 * float(np.float16(d)))
    blk[:, :, 4:16] = sc
    blk[:, :, 16:] = rng.integers(0, 256, (n, nb, 128), dtype=np.uint8)
    return _tile(blk.reshape(n, nb * 144), n_rows)


def q6k_rows(rng, n_rows: int, K: int) -> np.ndarray:
    """(n_rows, K/256*210) valid Q6_K block bytes."""
    nb = K // 256
    n = min(n_rows, DISTINCT_ROWS)
    blk = np.zeros((n, nb, 210), np.uint8)
    blk[:, :, :192] = rng.integers(0, 256, (n, nb, 192), dtype=np.uint8)
    blk[:, :, 192:208] = rng.integers(1, 32, (n, nb, 16), dtype=np.uint8)
    # rms of the int8 scales in 1..31, of q - 32 for q in 0..63
    blk[:, :, 208:210] = _f16_bytes(1.0 / (18.0 * 18.5 * np.sqrt(K)))
    return _tile(blk.reshape(n, nb * 210), n_rows)


def q8_0_rows(rng, n_rows: int, K: int) -> np.ndarray:
    """(n_rows, K/32*34) valid Q8_0 block bytes."""
    nb = K // 32
    n = min(n_rows, DISTINCT_ROWS)
    blk = np.zeros((n, nb, 34), np.uint8)
    blk[:, :, 0:2] = _f16_bytes(1.0 / (73.6 * np.sqrt(K)))  # rms of -127..127
    blk[:, :, 2:] = rng.integers(-127, 128, (n, nb, 32)).astype(np.int8).view(np.uint8)
    return _tile(blk.reshape(n, nb * 34), n_rows)


_ROWS = {GGMLType.Q4_K: q4k_rows, GGMLType.Q6_K: q6k_rows, GGMLType.Q8_0: q8_0_rows}


def write_synth(path: str, preset: str = "8b", seed: int = 0,
                n_layers: int | None = None, n_vocab: int | None = None) -> str:
    """Write ``preset``; ``n_layers`` / ``n_vocab`` cut its depth and vocab
    (the first layers' and tokens' rows stay those of the full preset)."""
    L, D, H, KVH, DH, F, V, mix = PRESETS[preset]
    L, V = n_layers or L, n_vocab or V
    q8 = mix == "q8_0"
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, "llama")
    w.add_string("general.name", f"synth-{preset}" + ("" if q8 else "-q4km"))
    w.add_uint32("llama.block_count", L)
    w.add_uint32("llama.embedding_length", D)
    w.add_uint32("llama.attention.head_count", H)
    w.add_uint32("llama.attention.head_count_kv", KVH)
    w.add_uint32("llama.attention.key_length", DH)
    w.add_uint32("llama.attention.value_length", DH)
    w.add_uint32("llama.feed_forward_length", F)
    w.add_uint32("llama.context_length", 8192)
    w.add_float32("llama.attention.layer_norm_rms_epsilon", 1e-5)
    w.add_float32("llama.rope.freq_base", 500000.0)
    w.add_uint32("llama.vocab_size", V)
    w.add_string("tokenizer.ggml.model", "llama")
    tokens = ["<s>", "</s>", "<unk>"] + [f"<0x{b:02X}>" for b in range(256)]
    tokens += [f"tok{i}" for i in range(V - len(tokens))]
    w.add_array("tokenizer.ggml.tokens", tokens)
    w.add_array("tokenizer.ggml.scores", np.zeros(V, np.float32))
    w.add_array("tokenizer.ggml.token_type", np.asarray(
        [3, 3, 2] + [6] * 256 + [1] * (V - 259), np.int32))
    w.add_uint32("tokenizer.ggml.bos_token_id", 0)
    w.add_uint32("tokenizer.ggml.eos_token_id", 1)

    proj, side = ((GGMLType.Q8_0, GGMLType.Q8_0) if q8
                  else (GGMLType.Q4_K, GGMLType.Q6_K))

    def add_q(name, out_dim, in_dim, qtype=proj):
        rows = _ROWS[qtype](rng, out_dim, in_dim)
        w.add_tensor(name, rows.reshape(-1), ggml_type=qtype,
                     raw_ne=(in_dim, out_dim))

    emb = (rng.standard_normal((min(V, DISTINCT_ROWS), D)) * 0.02).astype(np.float16)
    w.add_tensor("token_embd.weight", _tile(emb, V).view(np.uint8).reshape(-1),
                 ggml_type=GGMLType.F16, raw_ne=(D, V))
    w.add_tensor("output_norm.weight", np.ones(D, np.float32))
    add_q("output.weight", V, D, side)
    for i in range(L):
        w.add_tensor(f"blk.{i}.attn_norm.weight", np.ones(D, np.float32))
        w.add_tensor(f"blk.{i}.ffn_norm.weight", np.ones(D, np.float32))
        add_q(f"blk.{i}.attn_q.weight", H * DH, D)
        add_q(f"blk.{i}.attn_k.weight", KVH * DH, D)
        add_q(f"blk.{i}.attn_v.weight", KVH * DH, D, side)
        add_q(f"blk.{i}.attn_output.weight", D, H * DH)
        add_q(f"blk.{i}.ffn_gate.weight", F, D)
        add_q(f"blk.{i}.ffn_up.weight", F, D)
        add_q(f"blk.{i}.ffn_down.weight", D, F)
    return w.write()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--preset", default="8b", choices=sorted(PRESETS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    path = write_synth(args.out, args.preset, args.seed)
    print(path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
