"""Write a structurally valid synthetic llama-family, gemma3, qwen, ALiBi or gpt-oss GGUF.

For loading and timing the engine where no real checkpoint is at hand:
block payloads are valid (finite f16 scales, random quants), so the engine
loads and decodes at a real model's speed, which does not depend on the
values.  Not for quality metrics.  A few distinct rows per tensor are drawn
from ``--seed`` and tiled, so the 8B file is written in seconds.

Two quant mixes, with an F16 token embedding in both:
- Q4_K_M (``8b``, ``3b``, ``small``, ``tiny``, ``mixtral-q4_k_m``,
  ``tiny-moe``), as ``scripts/make_synth_gguf.py`` and the repo quantizer's
  Q4_K_M rule: Q4_K projections (experts included), a Q6_K ``attn_v`` and a
  Q6_K ``output``;
- Q8_0 (``270m-q8_0``, ``tiny-q8_0``, ``mixtral-q8_0``, ``tiny-moe-q8_0``):
  every projection and the output.
  ``270m-q8_0`` is the Gemma-3-270M shape that ``bench.py`` decodes (run as
  a llama); its layers hold 6.27 MB of int8 planes and scales, the JAX
  forward's single-launch (K7) shape.

The MoE presets are llama files with ``llama.expert_count`` experts, as
llama.cpp converts Mixtral: ``mixtral-*`` has the widths of Mistral AI's
``Mixtral-8x7B-v0.1`` ``config.json`` (hidden 4096, expert FF 14336, 32
layers, 32/8 heads, 8 experts, 2 per token, vocab 32000, rope theta 1e6);
``tiny-moe*`` is a 2-layer model for the tests (the narrowest whose nib4c
projections K6's chunk grid takes) whose expert FF (768) the loader pads to
1024.  Each layer has an F32 router ``ffn_gate_inp``
(zero-mean random rows) and stacked experts ``ffn_{gate,up,down}_exps``;
every expert's rows are drawn from a seed that holds its index, so no two
experts are alike.

The gemma3 presets write arch ``gemma3`` with the keys and tensors
llama.cpp's converter writes for it: per-layer ``attn_q_norm``,
``attn_k_norm`` (Dh), ``post_attention_norm`` and ``post_ffw_norm`` (D)
beside the llama tensors, norm weights that already carry Gemma's +1, no
``output.weight`` (the head is tied to ``token_embd``), rms eps 1e-6, rope
theta 1e6 with a local base of 10000 for the SWA layers, and a chat template
with Gemma's turn markers (two control tokens).  Every norm vector is drawn
per layer as 1 + 0.1 N(0, 1), so a swapped or missing norm shows.
- ``gemma3-4b-q4_k_m``: the widths of Google's ``google/gemma-3-4b-it``
  ``text_config`` (hidden 2560, intermediate 10240, 34 layers, 8 / 4
  heads of 256, sliding window 1024, linear rope scaling 8 on the global
  layers, vocab 262208): Q4_K projections, Q6_K ``attn_v`` and
  ``token_embd``;
- ``gemma3-270m-q8_0``: ``google/gemma-3-270m`` (hidden 640, intermediate
  2048, 18 layers, 4 / 1 heads of 256, window 512, no scaling, vocab
  262144), Q8_0 everywhere, ``token_embd`` included;
- ``tiny-gemma3`` (Q4_K_M as the 4B, the narrowest width whose nib4c
  projections K6's chunk grid takes) and ``tiny-gemma3-q8_0``: 6 layers
  (one global), window 16, for the tests.

The qwen presets write archs ``qwen2``, ``qwen2moe``, ``qwen3`` and
``qwen3moe`` with the keys and tensors llama.cpp's converter writes for
them: rms eps 1e-6, rope theta 1e6, vocab 151,936 unless stated, an untied
``output.weight`` (up to 4096 distinct rows, as the gemma head); qwen2 and qwen2moe add the q/k/v biases
``attn_{q,k,v}.bias`` (small zero-mean f32 vectors, 0.1 N(0, 1)), qwen3
and qwen3moe the per-head ``attn_q_norm`` / ``attn_k_norm`` (1 + 0.1
N(0, 1)); qwen2moe adds the shared expert ``ffn_{gate,up,down}_shexp`` and
its gate ``ffn_gate_inp_shexp`` (f32, written as a (1, D) row, ne (D, 1),
as the converter writes HF's ``shared_expert_gate``; llama.cpp reads it as
its (D,) vector), ``expert_shared_feed_forward_length`` and
``expert_weights_norm`` false (``norm_topk_prob``); qwen3moe writes
``expert_weights_norm`` true.  Widths of the public ``config.json`` files:
- ``qwen3-8b-q4_k_m`` (``Qwen/Qwen3-8B``: 36 layers, hidden 4096, 32 / 8
  heads of 128, intermediate 12288) and ``tiny-qwen3`` /
  ``tiny-qwen3-q8_0`` (2 layers, hidden 512: the narrowest whose nib4c
  projections K6's chunk grid takes, 4 / 2 heads);
- ``qwen3moe-30b-a3b-q4_k_m`` (``Qwen/Qwen3-30B-A3B``: 48 layers, hidden
  2048, 32 / 4 heads of 128, 128 experts of 768, 8 per token, intermediate
  6144) and ``tiny-qwen3moe`` (2 layers, hidden 512, 8 experts of 768, 2 per
  token);
- ``qwen2-7b-q4_k_m`` (``Qwen/Qwen2.5-7B-Instruct``: 28 layers, hidden
  3584, 28 / 4 heads of 128, intermediate 18944, vocab 152,064) and
  ``tiny-qwen2`` / ``tiny-qwen2-q8_0`` (2 layers, hidden 256, 4 / 2 heads);
- ``qwen2moe-a2.7b-q8_0`` (``Qwen/Qwen1.5-MoE-A2.7B``: 24 layers, hidden
  2048, 16 / 16 heads of 128, 60 experts of 1408, 4 per token, a shared
  expert of 5632, intermediate 5632), Q8_0 everywhere, and
  ``tiny-qwen2moe`` (Q4_K_M) / ``tiny-qwen2moe-q8_0`` (2 layers, hidden
  512, 4 / 2 heads, 8 experts of 768 / 384, 2 per token, a shared expert
  of 512).  Every expert FF pads to a multiple of 512 at load.
``write_synth(..., attn_bias=False)`` leaves a qwen2 or qwen2moe file
without its biases (the stack the JAX K6 gate takes).

The ALiBi presets write archs ``mpt`` and ``bloom`` with the tensors
llama.cpp's converter writes for them: q/k/v fused into one
``attn_qkv.weight`` (rows q, then k, then v), an ungated FFN
(``ffn_up``, ``ffn_down``), LayerNorm weights drawn per layer as 1 + 0.1
N(0, 1), ``{arch}.attention.layer_norm_epsilon`` 1e-5, context 2048, no
rope keys; mpt writes no bias (``mpt.attention.max_alibi_bias`` 8), bloom
a bias (0.1 N(0, 1)) on every projection and every norm, and
``token_embd_norm``.  The head is an untied Q6_K ``output.weight`` (up to
4096 distinct rows) in the Q4_K_M mix: the published checkpoints tie
their head to the embedding, which llama.cpp's Q4_K_M then stores as a
Q6_K ``token_embd`` with no ``output.weight``; and a real Q4_K_M stores
``attn_qkv`` as Q5_K, a codec the port lacks (here Q4_K as every
projection).  Widths of the public ``config.json`` files:
- ``mpt-7b-q4_k_m`` (``mosaicml/mpt-7b``: 32 layers, d_model 4096, 32
  heads of 128, expansion 4: FF 16384, vocab 50,432) and ``tiny-mpt`` /
  ``tiny-mpt-q8_0`` (2 layers, hidden 256, 4 heads of 64);
- ``bloom-7b1-q4_k_m`` (``bigscience/bloom-7b1``: 30 layers, hidden 4096,
  32 heads of 128, FF 16384, vocab 250,880) and ``tiny-bloom`` /
  ``tiny-bloom-q8_0`` (2 layers, hidden 768, 12 heads of 64: a head count
  that is not a power of two, so the slopes' tail is used).

The gpt-oss presets write arch ``gpt-oss`` with the keys and tensors
llama.cpp's converter writes for it: q/k/v and o biases, per-head
``attn_sinks`` (f32, N(0, 1)), the FFN pre-norm named
``post_attention_norm``, a router ``ffn_gate_inp`` with its bias, stacked
experts with their biases ``ffn_{gate,up,down}_exps.bias`` (biases 0.1
N(0, 1), norms 1 + 0.1 N(0, 1)), rms eps 1e-5, rope theta 150000 with YaRN
scaling 32 over a 4096 original context, a sliding window on the even
layers, and ``expert_feed_forward_length``.  Projections and experts are
Q4_0 (w = d (q - 8), the sign of d drawn per block so the weights are
zero-mean); ``token_embd`` and ``output`` Q8_0 (4096 distinct rows each);
router, sinks, norms and biases F32.  The published checkpoint stores its
experts as MXFP4 and its vocabulary as BPE (``gpt2``); here the experts are
Q4_0, whose gate and up (K = D, no 256-row chunk) pack split-K nib4, and
the vocabulary stays SPM.
- ``gpt-oss-20b-q4_0``: the widths of ``openai/gpt-oss-20b``'s
  ``config.json`` (24 layers, hidden 2880, 64 / 8 heads of 64, 32 experts of
  2880, 4 per token, window 128, vocab 201,088);
- ``tiny-gpt-oss``: 4 layers, hidden 320 (64-aligned, not 256-aligned, so
  its gate and up experts pack nib4), 4 / 2 heads of 64, 4 experts of 512,
  2 per token, window 16, vocab 2048.  Its expert FF is a multiple of 512:
  the JAX loader pads the expert FF to one but not the experts' biases, so
  the JAX forward (the tests' oracle) fails on any other width.

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
    # MoE: F is the expert FF
    "mixtral-q4_k_m": (32, 4096, 32, 8, 128, 14336, 32000, "q4_k_m"),
    "mixtral-q8_0": (32, 4096, 32, 8, 128, 14336, 32000, "q8_0"),
    "tiny-moe": (2, 512, 4, 1, 128, 768, 512, "q4_k_m"),
    "tiny-moe-q8_0": (2, 512, 4, 1, 128, 768, 512, "q8_0"),
    # gemma3
    "gemma3-4b-q4_k_m": (34, 2560, 8, 4, 256, 10240, 262208, "q4_k_m"),
    "gemma3-270m-q8_0": (18, 640, 4, 1, 256, 2048, 262144, "q8_0"),
    "tiny-gemma3": (6, 512, 2, 1, 256, 1024, 2048, "q4_k_m"),
    "tiny-gemma3-q8_0": (6, 512, 2, 1, 256, 1024, 2048, "q8_0"),
    # qwen: F is the expert FF for the MoE ones
    "qwen3-8b-q4_k_m": (36, 4096, 32, 8, 128, 12288, 151936, "q4_k_m"),
    "qwen3moe-30b-a3b-q4_k_m": (48, 2048, 32, 4, 128, 768, 151936, "q4_k_m"),
    "qwen2-7b-q4_k_m": (28, 3584, 28, 4, 128, 18944, 152064, "q4_k_m"),
    "qwen2moe-a2.7b-q8_0": (24, 2048, 16, 16, 128, 1408, 151936, "q8_0"),
    "tiny-qwen3": (2, 512, 4, 2, 128, 1024, 2048, "q4_k_m"),
    "tiny-qwen3-q8_0": (2, 512, 4, 2, 128, 1024, 2048, "q8_0"),
    "tiny-qwen3moe": (2, 512, 4, 2, 128, 768, 2048, "q4_k_m"),
    "tiny-qwen2": (2, 256, 4, 2, 128, 512, 2048, "q4_k_m"),
    "tiny-qwen2-q8_0": (2, 256, 4, 2, 128, 512, 2048, "q8_0"),
    "tiny-qwen2moe": (2, 512, 4, 2, 128, 768, 2048, "q4_k_m"),
    "tiny-qwen2moe-q8_0": (2, 512, 4, 2, 128, 384, 2048, "q8_0"),
    # the ALiBi families (MHA)
    "mpt-7b-q4_k_m": (32, 4096, 32, 32, 128, 16384, 50432, "q4_k_m"),
    "bloom-7b1-q4_k_m": (30, 4096, 32, 32, 128, 16384, 250880, "q4_k_m"),
    "tiny-mpt": (2, 256, 4, 4, 64, 1024, 2048, "q4_k_m"),
    "tiny-mpt-q8_0": (2, 256, 4, 4, 64, 1024, 2048, "q8_0"),
    "tiny-bloom": (2, 768, 12, 12, 64, 1024, 2048, "q4_k_m"),
    "tiny-bloom-q8_0": (2, 768, 12, 12, 64, 1024, 2048, "q8_0"),
    # gpt-oss: F is the expert FF
    "gpt-oss-20b-q4_0": (24, 2880, 64, 8, 64, 2880, 201088, "q4_0"),
    "tiny-gpt-oss": (4, 320, 4, 2, 64, 512, 2048, "q4_0"),
}
# (experts, experts per token, rope theta) of the MoE presets
EXPERTS = {"mixtral-q4_k_m": (8, 2, 1e6), "mixtral-q8_0": (8, 2, 1e6),
           "tiny-moe": (4, 2, 1e6), "tiny-moe-q8_0": (4, 2, 1e6),
           "qwen3moe-30b-a3b-q4_k_m": (128, 8, 1e6), "qwen2moe-a2.7b-q8_0": (60, 4, 1e6),
           "tiny-qwen3moe": (8, 2, 1e6), "tiny-qwen2moe": (8, 2, 1e6),
           "tiny-qwen2moe-q8_0": (8, 2, 1e6),
           "gpt-oss-20b-q4_0": (32, 4, 150000.0), "tiny-gpt-oss": (4, 2, 150000.0)}
# qwen presets: (arch, dense FF of the MoE ones, the shared expert's FF)
QWEN = {"qwen3-8b-q4_k_m": ("qwen3", 0, 0), "tiny-qwen3": ("qwen3", 0, 0),
        "tiny-qwen3-q8_0": ("qwen3", 0, 0),
        "qwen3moe-30b-a3b-q4_k_m": ("qwen3moe", 6144, 0), "tiny-qwen3moe": ("qwen3moe", 512, 0),
        "qwen2-7b-q4_k_m": ("qwen2", 0, 0), "tiny-qwen2": ("qwen2", 0, 0),
        "tiny-qwen2-q8_0": ("qwen2", 0, 0),
        "qwen2moe-a2.7b-q8_0": ("qwen2moe", 5632, 5632), "tiny-qwen2moe": ("qwen2moe", 512, 512),
        "tiny-qwen2moe-q8_0": ("qwen2moe", 512, 512)}
# gemma3 presets: (sliding window, linear rope scaling factor of the global
# layers or None, training context)
GEMMA3 = {"gemma3-4b-q4_k_m": (1024, 8.0, 131072), "gemma3-270m-q8_0": (512, None, 32768),
          "tiny-gemma3": (16, 8.0, 8192), "tiny-gemma3-q8_0": (16, None, 8192)}
ALIBI = {p: p.split("-")[1 if p.startswith("tiny") else 0]
         for p in PRESETS if "mpt" in p or "bloom" in p}
# gpt-oss presets: (sliding window, YaRN factor, YaRN original context)
GPT_OSS = {"gpt-oss-20b-q4_0": (128, 32.0, 4096), "tiny-gpt-oss": (16, 32.0, 4096)}
GEMMA_TEMPLATE = ("{{ bos_token }}{% for m in messages %}<start_of_turn>{{ m['role'] }}\n"
                  "{{ m['content'] }}<end_of_turn>\n{% endfor %}"
                  "{% if add_generation_prompt %}<start_of_turn>model\n{% endif %}")
DISTINCT_ROWS = 64
EMBD_DISTINCT_ROWS = 4096


def _tile(rows: np.ndarray, n_rows: int) -> np.ndarray:
    return np.tile(rows, (-(-n_rows // rows.shape[0]), 1))[:n_rows]


def _f16_bytes(v: float) -> np.ndarray:
    return np.frombuffer(np.float16(v).tobytes(), np.uint8)


# Every generator below gives zero-mean weights of rms about 1/sqrt(K), so a
# projection roughly keeps the norm of its input: the layer stack neither
# blows up nor amplifies rounding noise, and a decode kernel can be held
# against its plain version through a full-depth stack.


def q4k_rows(rng, n_rows: int, K: int, distinct: int = DISTINCT_ROWS) -> np.ndarray:
    """(n_rows, K/256*144) valid Q4_K block bytes: each sub-block's 6-bit
    min equals its scale v and dmin = 7.5 d, so w = d v (q - 7.5)."""
    nb = K // 256
    n = min(n_rows, distinct)
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


def q6k_rows(rng, n_rows: int, K: int, distinct: int = DISTINCT_ROWS) -> np.ndarray:
    """(n_rows, K/256*210) valid Q6_K block bytes."""
    nb = K // 256
    n = min(n_rows, distinct)
    blk = np.zeros((n, nb, 210), np.uint8)
    blk[:, :, :192] = rng.integers(0, 256, (n, nb, 192), dtype=np.uint8)
    blk[:, :, 192:208] = rng.integers(1, 32, (n, nb, 16), dtype=np.uint8)
    # rms of the int8 scales in 1..31, of q - 32 for q in 0..63
    blk[:, :, 208:210] = _f16_bytes(1.0 / (18.0 * 18.5 * np.sqrt(K)))
    return _tile(blk.reshape(n, nb * 210), n_rows)


def q8_0_rows(rng, n_rows: int, K: int, distinct: int = DISTINCT_ROWS) -> np.ndarray:
    """(n_rows, K/32*34) valid Q8_0 block bytes."""
    nb = K // 32
    n = min(n_rows, distinct)
    blk = np.zeros((n, nb, 34), np.uint8)
    blk[:, :, 0:2] = _f16_bytes(1.0 / (73.6 * np.sqrt(K)))  # rms of -127..127
    blk[:, :, 2:] = rng.integers(-127, 128, (n, nb, 32)).astype(np.int8).view(np.uint8)
    return _tile(blk.reshape(n, nb * 34), n_rows)


def q4_0_rows(rng, n_rows: int, K: int, distinct: int = DISTINCT_ROWS) -> np.ndarray:
    """(n_rows, K/32*18) valid Q4_0 block bytes: w = d (q - 8), the sign of
    d drawn per block (q - 8 alone has mean -1/2)."""
    nb = K // 32
    n = min(n_rows, distinct)
    blk = np.zeros((n, nb, 18), np.uint8)
    d = np.float16(1.0 / (4.637 * np.sqrt(K)))  # rms of q - 8 for q in 0..15
    sign = np.where(rng.integers(0, 2, (n, nb)) == 1, -1.0, 1.0)
    blk[:, :, 0:2] = (sign * d).astype(np.float16)[..., None].view(np.uint8)
    blk[:, :, 2:] = rng.integers(0, 256, (n, nb, 16), dtype=np.uint8)
    return _tile(blk.reshape(n, nb * 18), n_rows)


_ROWS = {GGMLType.Q4_K: q4k_rows, GGMLType.Q6_K: q6k_rows, GGMLType.Q8_0: q8_0_rows,
         GGMLType.Q4_0: q4_0_rows}


def write_synth(path: str, preset: str = "8b", seed: int = 0,
                n_layers: int | None = None, n_vocab: int | None = None,
                attn_bias: bool = True) -> str:
    """Write ``preset``; ``n_layers`` / ``n_vocab`` cut its depth and vocab
    (the first layers' and tokens' rows stay those of the full preset);
    ``attn_bias`` False leaves out a qwen2 / qwen2moe file's q/k/v biases."""
    L, D, H, KVH, DH, F, V, mix = PRESETS[preset]
    L, V = n_layers or L, n_vocab or V
    q8 = mix == "q8_0"
    E, K_USED, rope_base = EXPERTS.get(preset, (0, 0, 500000.0))
    gemma = preset in GEMMA3
    arch, dense_ff, shared_ff = QWEN.get(preset, ("gemma3" if gemma else "llama", 0, 0))
    arch = ALIBI.get(preset, arch)
    oss = preset in GPT_OSS
    arch = "gpt-oss" if oss else arch
    qwen = preset in QWEN
    alibi = preset in ALIBI
    biases = attn_bias and arch in ("qwen2", "qwen2moe")
    rng = np.random.default_rng(seed)
    w = GGUFWriter(path, arch)
    w.add_string("general.name", f"synth-{preset}" + ("" if q8 else "-q4km"))
    w.add_uint32(f"{arch}.block_count", L)
    w.add_uint32(f"{arch}.embedding_length", D)
    w.add_uint32(f"{arch}.attention.head_count", H)
    w.add_uint32(f"{arch}.attention.head_count_kv", KVH)
    w.add_uint32(f"{arch}.attention.key_length", DH)
    w.add_uint32(f"{arch}.attention.value_length", DH)
    w.add_uint32(f"{arch}.feed_forward_length", dense_ff or F)
    if gemma:
        window, scaling, n_ctx = GEMMA3[preset]
        w.add_uint32("gemma3.context_length", n_ctx)
        w.add_float32("gemma3.attention.layer_norm_rms_epsilon", 1e-6)
        w.add_float32("gemma3.rope.freq_base", 1e6)
        w.add_float32("gemma3.rope.local_freq_base", 10000.0)
        w.add_uint32("gemma3.attention.sliding_window", window)
        if scaling:
            w.add_string("gemma3.rope.scaling.type", "linear")
            w.add_float32("gemma3.rope.scaling.factor", scaling)
    elif alibi:
        w.add_uint32(f"{arch}.context_length", 2048)
        w.add_float32(f"{arch}.attention.layer_norm_epsilon", 1e-5)
        if arch == "mpt":
            w.add_float32("mpt.attention.max_alibi_bias", 8.0)
    elif oss:
        window, yarn, orig_ctx = GPT_OSS[preset]
        w.add_uint32("gpt-oss.context_length", 131072)
        w.add_float32("gpt-oss.attention.layer_norm_rms_epsilon", 1e-5)
        w.add_float32("gpt-oss.rope.freq_base", rope_base)
        w.add_string("gpt-oss.rope.scaling.type", "yarn")
        w.add_float32("gpt-oss.rope.scaling.factor", yarn)
        w.add_uint32("gpt-oss.rope.scaling.original_context_length", orig_ctx)
        w.add_uint32("gpt-oss.attention.sliding_window", window)
    elif qwen:
        w.add_uint32(f"{arch}.context_length", 32768)
        w.add_float32(f"{arch}.attention.layer_norm_rms_epsilon", 1e-6)
        w.add_float32(f"{arch}.rope.freq_base", 1e6)
    else:
        w.add_uint32("llama.context_length", 8192)
        w.add_float32("llama.attention.layer_norm_rms_epsilon", 1e-5)
        w.add_float32("llama.rope.freq_base", rope_base)
    if E:
        w.add_uint32(f"{arch}.expert_count", E)
        w.add_uint32(f"{arch}.expert_used_count", K_USED)
    if (qwen or oss) and E:
        w.add_uint32(f"{arch}.expert_feed_forward_length", F)
    if qwen and E:
        w.add_bool(f"{arch}.expert_weights_norm", arch == "qwen3moe")
    if shared_ff:
        w.add_uint32(f"{arch}.expert_shared_feed_forward_length", shared_ff)
    w.add_uint32(f"{arch}.vocab_size", V)
    w.add_string("tokenizer.ggml.model", "llama")
    tokens = ["<s>", "</s>", "<unk>"] + [f"<0x{b:02X}>" for b in range(256)]
    tokens += [f"tok{i}" for i in range(V - len(tokens))]
    types = [3, 3, 2] + [6] * 256 + [1] * (V - 259)
    if gemma:  # the turn markers, as control tokens at the vocab's end
        tokens[-2:] = ["<start_of_turn>", "<end_of_turn>"]
        types[-2:] = [3, 3]
        w.add_string("tokenizer.chat_template", GEMMA_TEMPLATE)
    w.add_array("tokenizer.ggml.tokens", tokens)
    w.add_array("tokenizer.ggml.scores", np.zeros(V, np.float32))
    w.add_array("tokenizer.ggml.token_type", np.asarray(types, np.int32))
    w.add_uint32("tokenizer.ggml.bos_token_id", 0)
    w.add_uint32("tokenizer.ggml.eos_token_id", 1)

    proj, side = {"q8_0": (GGMLType.Q8_0, GGMLType.Q8_0),
                  "q4_0": (GGMLType.Q4_0, GGMLType.Q8_0)}.get(
                      mix, (GGMLType.Q4_K, GGMLType.Q6_K))

    def add_q(name, out_dim, in_dim, qtype=proj, distinct=DISTINCT_ROWS):
        rows = _ROWS[qtype](rng, out_dim, in_dim, distinct)
        w.add_tensor(name, rows.reshape(-1), ggml_type=qtype,
                     raw_ne=(in_dim, out_dim))

    def add_experts(name, layer, which, out_dim, in_dim):
        rows = np.concatenate([_ROWS[proj](np.random.default_rng(
            [seed, layer, which, e]), out_dim, in_dim) for e in range(E)])
        w.add_tensor(name, rows.reshape(-1), ggml_type=proj,
                     raw_ne=(in_dim, out_dim, E))

    def norm(n, vary=gemma):  # gemma, qk-norms: 1 + 0.1 N(0, 1) per layer; else ones
        return ((1 + 0.1 * rng.standard_normal(n)) if vary else np.ones(n)).astype(np.float32)

    def bias(n):
        return (0.1 * rng.standard_normal(n)).astype(np.float32)

    if gemma or oss:  # gemma: a tied head, token_embd is the output, in the
        # side type; its rows are the logits' too, so more of them differ
        add_q("token_embd.weight", V, D, side, distinct=EMBD_DISTINCT_ROWS)
    else:
        emb = (rng.standard_normal((min(V, DISTINCT_ROWS), D)) * 0.02).astype(np.float16)
        w.add_tensor("token_embd.weight", _tile(emb, V).view(np.uint8).reshape(-1),
                     ggml_type=GGMLType.F16, raw_ne=(D, V))
    if alibi:
        _alibi_tensors(w, add_q, norm, bias, arch, L, D, H * DH, F, V, side)
        return w.write()
    if oss:
        _gpt_oss_tensors(w, rng, add_q, add_experts, norm, bias, L, D, H, KVH * DH,
                         H * DH, F, V, E)
        return w.write()
    w.add_tensor("output_norm.weight", np.ones(D, np.float32))
    if not gemma:  # a qwen head: up to 4096 distinct rows, so the top logits
        # of a tiny vocab do not tie exactly (as the gemma tied head)
        add_q("output.weight", V, D, side,
              distinct=EMBD_DISTINCT_ROWS if qwen else DISTINCT_ROWS)
    for i in range(L):
        w.add_tensor(f"blk.{i}.attn_norm.weight", norm(D))
        w.add_tensor(f"blk.{i}.ffn_norm.weight", norm(D))
        if gemma or arch in ("qwen3", "qwen3moe"):
            w.add_tensor(f"blk.{i}.attn_q_norm.weight", norm(DH, True))
            w.add_tensor(f"blk.{i}.attn_k_norm.weight", norm(DH, True))
        if gemma:
            w.add_tensor(f"blk.{i}.post_attention_norm.weight", norm(D))
            w.add_tensor(f"blk.{i}.post_ffw_norm.weight", norm(D))
        add_q(f"blk.{i}.attn_q.weight", H * DH, D)
        add_q(f"blk.{i}.attn_k.weight", KVH * DH, D)
        add_q(f"blk.{i}.attn_v.weight", KVH * DH, D, side)
        if biases:
            w.add_tensor(f"blk.{i}.attn_q.bias", bias(H * DH))
            w.add_tensor(f"blk.{i}.attn_k.bias", bias(KVH * DH))
            w.add_tensor(f"blk.{i}.attn_v.bias", bias(KVH * DH))
        add_q(f"blk.{i}.attn_output.weight", D, H * DH)
        if E:
            router = rng.standard_normal((E, D)) / np.sqrt(D)
            w.add_tensor(f"blk.{i}.ffn_gate_inp.weight", router.astype(np.float32))
            add_experts(f"blk.{i}.ffn_gate_exps.weight", i, 0, F, D)
            add_experts(f"blk.{i}.ffn_up_exps.weight", i, 1, F, D)
            add_experts(f"blk.{i}.ffn_down_exps.weight", i, 2, D, F)
            if shared_ff:
                gate = rng.standard_normal((1, D)) / np.sqrt(D)
                w.add_tensor(f"blk.{i}.ffn_gate_inp_shexp.weight", gate.astype(np.float32))
                add_q(f"blk.{i}.ffn_gate_shexp.weight", shared_ff, D)
                add_q(f"blk.{i}.ffn_up_shexp.weight", shared_ff, D)
                add_q(f"blk.{i}.ffn_down_shexp.weight", D, shared_ff)
            continue
        add_q(f"blk.{i}.ffn_gate.weight", F, D)
        add_q(f"blk.{i}.ffn_up.weight", F, D)
        add_q(f"blk.{i}.ffn_down.weight", D, F)
    return w.write()


def _alibi_tensors(w, add_q, norm, bias, arch, L, D, Dq, F, V, side) -> None:
    """The tensors of an mpt or bloom file after ``token_embd`` (MHA: k and
    v as wide as q): LayerNorms with varied weights, fused q|k|v, the
    ungated FFN, and for bloom a bias on each, and the embedding norm."""
    bloom = arch == "bloom"

    def layer_norm(name, n):
        w.add_tensor(f"{name}.weight", norm(n, True))
        if bloom:
            w.add_tensor(f"{name}.bias", bias(n))

    def proj(name, out_dim, in_dim):
        add_q(f"{name}.weight", out_dim, in_dim)
        if bloom:
            w.add_tensor(f"{name}.bias", bias(out_dim))

    if bloom:
        layer_norm("token_embd_norm", D)
    layer_norm("output_norm", D)
    add_q("output.weight", V, D, side, distinct=EMBD_DISTINCT_ROWS)
    for i in range(L):
        b = f"blk.{i}."
        layer_norm(b + "attn_norm", D)
        proj(b + "attn_qkv", 3 * Dq, D)
        proj(b + "attn_output", D, Dq)
        layer_norm(b + "ffn_norm", D)
        proj(b + "ffn_up", F, D)
        proj(b + "ffn_down", D, F)


def _gpt_oss_tensors(w, rng, add_q, add_experts, norm, bias, L, D, H, Dkv, Dq, F, V,
                     E) -> None:
    """The tensors of a gpt-oss file after ``token_embd``: varied RMS norms
    (the FFN pre-norm named ``post_attention_norm``), biased q/k/v and o,
    attention sinks, the router with its bias, the experts with theirs."""
    w.add_tensor("output_norm.weight", norm(D, True))
    add_q("output.weight", V, D, GGMLType.Q8_0, distinct=EMBD_DISTINCT_ROWS)
    for i in range(L):
        b = f"blk.{i}."
        w.add_tensor(b + "attn_norm.weight", norm(D, True))
        w.add_tensor(b + "post_attention_norm.weight", norm(D, True))
        for n, out_dim in (("q", Dq), ("k", Dkv), ("v", Dkv)):
            add_q(f"{b}attn_{n}.weight", out_dim, D)
            w.add_tensor(f"{b}attn_{n}.bias", bias(out_dim))
        add_q(b + "attn_output.weight", D, Dq)
        w.add_tensor(b + "attn_output.bias", bias(D))
        w.add_tensor(b + "attn_sinks.weight", rng.standard_normal(H).astype(np.float32))
        router = rng.standard_normal((E, D)) / np.sqrt(D)
        w.add_tensor(b + "ffn_gate_inp.weight", router.astype(np.float32))
        w.add_tensor(b + "ffn_gate_inp.bias", bias(E))
        add_experts(b + "ffn_gate_exps.weight", i, 0, F, D)
        add_experts(b + "ffn_up_exps.weight", i, 1, F, D)
        add_experts(b + "ffn_down_exps.weight", i, 2, D, F)
        w.add_tensor(b + "ffn_gate_exps.bias", bias(E * F).reshape(E, F))
        w.add_tensor(b + "ffn_up_exps.bias", bias(E * F).reshape(E, F))
        w.add_tensor(b + "ffn_down_exps.bias", bias(E * D).reshape(E, D))


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
