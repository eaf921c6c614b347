"""Write a structurally valid synthetic Q4_K_M llama GGUF at a chosen scale.

For loading and timing the engine where no real checkpoint is at hand:
block payloads are valid (finite f16 scales, random nibbles), so the engine
loads and decodes at a real model's speed, which does not depend on the
values.  Not for quality metrics.  A few distinct rows per tensor are drawn
from ``--seed`` and tiled, so the 8B file is written in seconds.  Shapes
and quant types follow ``scripts/make_synth_gguf.py``: Q4_K projections, a
Q6_K ``attn_v`` and a Q6_K ``output``.

Usage:
    python -m llama_cpp_gfx906_tpu_torch.tools.synth_gguf out.gguf [--preset 8b|3b|tiny] [--seed 0]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..gguf.constants import GGMLType
from ..gguf.writer import GGUFWriter

PRESETS = {
    # (L, D, heads, kv, head_dim, F, V)
    "8b": (32, 4096, 32, 8, 128, 14336, 128256),
    "3b": (28, 3072, 24, 8, 128, 8192, 128256),
    "tiny": (2, 256, 2, 1, 128, 512, 2048),
}
DISTINCT_ROWS = 64


def _tile(rows: np.ndarray, n_rows: int) -> np.ndarray:
    return np.tile(rows, (-(-n_rows // rows.shape[0]), 1))[:n_rows]


def q4k_rows(rng, n_rows: int, K: int) -> np.ndarray:
    """(n_rows, K/256*144) valid Q4_K block bytes."""
    nb = K // 256
    n = min(n_rows, DISTINCT_ROWS)
    blk = np.zeros((n, nb, 144), np.uint8)
    blk[:, :, 0:2] = np.frombuffer(np.float16(2e-3).tobytes(), np.uint8)
    blk[:, :, 2:4] = np.frombuffer(np.float16(1e-3).tobytes(), np.uint8)
    blk[:, :, 4:16] = rng.integers(0, 63, (n, nb, 12), dtype=np.uint8)
    blk[:, :, 16:] = rng.integers(0, 256, (n, nb, 128), dtype=np.uint8)
    return _tile(blk.reshape(n, nb * 144), n_rows)


def q6k_rows(rng, n_rows: int, K: int) -> np.ndarray:
    """(n_rows, K/256*210) valid Q6_K block bytes."""
    nb = K // 256
    n = min(n_rows, DISTINCT_ROWS)
    blk = np.zeros((n, nb, 210), np.uint8)
    blk[:, :, :192] = rng.integers(0, 256, (n, nb, 192), dtype=np.uint8)
    blk[:, :, 192:208] = rng.integers(1, 32, (n, nb, 16), dtype=np.uint8)
    blk[:, :, 208:210] = np.frombuffer(np.float16(2e-3).tobytes(), np.uint8)
    return _tile(blk.reshape(n, nb * 210), n_rows)


def write_synth(path: str, preset: str = "8b", seed: int = 0) -> str:
    L, D, H, KVH, DH, F, V = PRESETS[preset]
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, "llama")
    w.add_string("general.name", f"synth-{preset}-q4km")
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

    def add_q(name, out_dim, in_dim, kind="q4k"):
        rows = (q4k_rows if kind == "q4k" else q6k_rows)(rng, out_dim, in_dim)
        w.add_tensor(name, rows.reshape(-1),
                     ggml_type=GGMLType.Q4_K if kind == "q4k" else GGMLType.Q6_K,
                     raw_ne=(in_dim, out_dim))

    emb = (rng.standard_normal((min(V, DISTINCT_ROWS), D)) * 0.02).astype(np.float16)
    w.add_tensor("token_embd.weight", _tile(emb, V).view(np.uint8).reshape(-1),
                 ggml_type=GGMLType.F16, raw_ne=(D, V))
    w.add_tensor("output_norm.weight", np.ones(D, np.float32))
    add_q("output.weight", V, D, "q6k")
    for i in range(L):
        w.add_tensor(f"blk.{i}.attn_norm.weight", np.ones(D, np.float32))
        w.add_tensor(f"blk.{i}.ffn_norm.weight", np.ones(D, np.float32))
        add_q(f"blk.{i}.attn_q.weight", H * DH, D)
        add_q(f"blk.{i}.attn_k.weight", KVH * DH, D)
        add_q(f"blk.{i}.attn_v.weight", KVH * DH, D, "q6k")
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
