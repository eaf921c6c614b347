#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``llama_cpp_gfx906_tpu_torch``) on one card.

Phases, each printing JSON lines:
  0. the card (nvidia-smi name and power limit) and the kernel build, with
     what ``-Xptxas -v`` reports per kernel;
  1. each kernel against its plain PyTorch version at the shapes of the main
     paths, launched twice on the same inputs (the same bits: every split-K
     sum adds in a fixed order), with its time, its bound and a PyTorch
     yardstick (the cases K1/K2, K8, K6, K7, K3's modes and K4 share with
     ``tools/kernel_times.py``): K1/K2 at the 8B Q4_K_M shapes at M 1, 4
     and 8 rows of x (one stream, a 4-slot served step, the most a step
     takes; an f32 x too; one K1/K2 launch per ``quant_matmul`` call); K3 at
     every decode shape of the model phases (``K3_CASES``: the 8B's over
     4096 and 8192 rows, the serve modes at the 8B's and tinydoc's heads,
     the Qwen group sizes G 7 and G 8, gpt-oss's heads of 64 with sinks,
     Gemma-3-4B's heads of 256; bf16 and int8 caches); K4 at
     every model phase's prefill shape (``K4_CASES``: the 8B's T 512, the
     served q8 chunks, the Qwen group sizes' ragged chunks, gpt-oss's heads
     of 64 with sinks, Gemma-3-4B's heads of 256, and its FMA body at
     tinydoc's heads), K5 in both modes at every prefill projection shape
     of ``QMM_CASES`` (the 270M Q8_0's four at its 676-token prompt,
     Gemma-3-4B's attn_v at group 16, a Mixtral Q8_0 expert's gate and
     down, gpt-oss-20b's q|k|v with mins and a gate expert in the nib4
     mode, M 101-1000) through ``quant_matmul`` as the main path calls
     it (one launch, bf16 out), K6 on two
     full-width 8B layers (B 1 and 8), K7 on the 18 layers of the 270M Q8_0
     shape, K8 at the Mixtral Q8_0 expert shapes (one token's 2 pairs and 4
     slots' 8), K6's MoE branch on two full-width Mixtral layers (nib4c and
     int8 experts) with the expert ids it chose; the gemma modes: K6 on 6
     full-width Gemma-3-4B Q4_K_M layers (five local, one global; B 1 and
     4), K7 on the 18 layers of Gemma-3-270M Q8_0, each over the whole
     stack, the first two layers and each layer alone (keeping its SWA
     flag), at n_past 700 and 3000 (above both windows); K6's qwen modes
     on two full-width layers each: qk-norm without post-norms (Qwen3-8B,
     B 1 and 4), MoE with qk-norm (Qwen3-30B-A3B), the shared expert with
     and without its gate (Qwen1.5-MoE-A2.7B without its biases); K3's
     ALiBi mode at MPT-7B's 32/32 heads (B 1 and 4, n_past 700 / 3000, bf16
     and int8, after 512 shared rows) and its self-extend mode at the 8B's
     (B 1, n_past 3000, rows at i // 4 and at the ``-gan 4 -gaw 1024``
     ladder's positions, T 1 and 4), each with an SDPA yardstick whose
     float mask holds the bias and the mask, and both at the JAX kernel
     tests' shape; at gpt-oss-20b's shapes (``oss_cases``): K8's nib4 mode
     (P 4 / 8 pairs of 32 experts, with mins), K1 at K 2880 (q|k|v with
     mins, the head), K2 at N 2880, each at M 1, 4 and 8;
  2. the 8B Q4_K_M model end to end (synthetic weights from a seed, full
     width and depth): ``Engine.from_gguf``, a greedy ``generate`` (decode
     through K6), the per-layer loop called as a function (K1-K4), and a
     profile of both decode routes;
  3. ``8b_fused``: the same model through ``decode_fused`` (one captured
     step replayed per token), launches per token, and 8 steps of the K6
     path held against the per-layer loop from the same state;
     ``8b_self_extend``: the same model at ``max_seq`` 4096, a 3,000-token
     prompt, then the CLI's self-extend loop (``-gan 4 -gaw 1024``, 64
     greedy tokens through the per-layer loop and K3's self-extend mode),
     its launches per token, layer 0's K rows after the ladder against raw
     keys roped fresh at their new positions, and 8 steps held against the
     same loop with the plain attention;
  4. ``270m_q8_0``: the 270M-shape Q8_0 model (prefill through K5, decode
     through K7), the same way;
  5. ``8b_serve``: the continuous-batching server on the 8B model
     (``python -m llama_cpp_gfx906_tpu_torch.server -np 4 -c 4096``), once
     with ``-ctk q8`` and once with ``-ctk bf16``: 8 concurrent token-id
     requests over HTTP (tok/s, TTFT, the decode step's idle share, and the
     server's own kernel launches per decode step and prefill chunk, all
     from /metrics); then the same engine in this process for what the
     server cannot show (launches with a 512-token shared system prompt, a
     profile of a 4-slot decode stretch) and two holds: the batched T = 1
     forward against single-slot forwards, and the shared segment against
     the same prompts unshared;
  6. ``mixtral_q4km``: Mixtral-8x7B Q4_K_M (synthetic, full width, cut to
     4 of 32 layers): prefill through the dense all-experts path, a
     greedy ``generate`` and ``decode_fused`` through K6's MoE branch, one
     K6 and one K1 launch per fused token, the fused route held against the
     per-layer loop;
  7. ``mixtral_q8_0``: Mixtral-8x7B Q8_0 cut to 4 of 32 layers: one stream
     through K6 with int8 experts and prefill through K5 per expert; then
     ``BatchedEngine`` at 4 slots x 4096 (bf16 cache), whose batched decode
     step routes every layer's experts through K8 (3 launches a layer),
     counted per decode step and prefill chunk, and held against
     single-slot forwards;
  8. ``gemma3_4b``: Gemma-3-4B Q4_K_M (synthetic, full width and depth):
     synth write, load, a 1,500-token prefill, ``generate`` and
     ``decode_fused`` through K6's gemma mode (one launch per token; the
     tied head a dense bf16 product, timed apart), the fused route against
     the per-layer loop (reported: the JAX kernel's own gap at this depth);
  9. ``gemma3_4b_serve``: the server on that model, ``-np 4 -c 4096``, bf16
     then q8 cache: 8 concurrent requests of 256-1,536-token prompts (some
     past the 1,024 window), launches per step and chunk from /metrics;
     then ``BatchedEngine`` in this process held against single slots;
 10. ``gemma3_270m_q8_0``: Gemma-3-270M Q8_0 at full depth: decode through
     K7's gemma mode, prefill through K5;
 11. ``qwen3_8b``: Qwen3-8B Q4_K_M at full width and depth, a ragged
     1,499-token prefill, ``generate`` and ``decode_fused`` through K6's
     qk-norm mode, K6 against plain at full depth, the fused route against
     its plain version and the loop;
 12. ``qwen3_8b_serve``: the server on it, bf16 then q8, 8 ragged requests,
     each prefill chunk's launches from its own T; ``BatchedEngine`` held
     against single slots;
 13. ``qwen3moe_30b_a3b``: Qwen3-30B-A3B Q4_K_M (24 of 48 layers) through K6's
     MoE branch with qk-norm, each layer's experts beside the plain
     version's;
 14. ``qwen2_7b`` and ``qwen2moe_a2_7b``: Qwen2.5-7B Q4_K_M and
     Qwen1.5-MoE-A2.7B Q8_0 at 4 layers with their q/k/v biases, through
     the per-layer loop (K1, K2, K3, K8), held against the CPU's plain
     loop; then the bias-free qwen2moe stack through ``decode_fused`` (K6's
     shared-expert mode);
 15. ``mpt_7b``: MPT-7B Q4_K_M (synthetic, full width and depth): a
     ragged 1,531-token prefill (the counted einsum: G·T > 128 with ALiBi
     has no kernel, as in JAX), ``generate`` and ``decode_fused`` through
     the per-layer loop with K3's ALiBi mode, launches per token exact, 8
     fused steps' greedy tokens held to the loop's, every K1/K2 and K3 call
     of a step and each layer alone held to its plain version (the 32-layer
     stack's logits against the plain versions reported beside them), then
     ``BatchedEngine`` at 4 slots: its launches per decode step and the
     batched step against single slots;
 16. ``bloom_7b1``: BLOOM-7B1 Q4_K_M at full width, 4 of 30 layers, every
     bias and the embedding norm, through the loop on the card held
     against the CPU's plain loop;
 17. ``gpt_oss_20b``: gpt-oss-20b with Q4_0 experts (synthetic, full width,
     6 of 24 layers): a ragged 997-token prefill (K5-int8 on q|k|v,
     K5-nib4 on every expert's gate and up, K4 with sinks), 32 greedy
     tokens through the per-layer loop and ``decode_fused`` (the loop in a
     graph: K8-nib4 twice a layer per token), launches per prefill and per
     token held on the host and the device; then a cut of the same preset
     (4 layers, 8,192 tokens) against the CPU's plain loop, the CPU
     following the card's routes (``kernel_times.RouteLog``);
 18. the committed tinydoc fixture at f32 on the card: pinned greedy tokens
     and held-out perplexity, through ``Engine`` and, all prompts at once,
     through ``BatchedEngine`` with an f32 and a q8 cache.
Then ``k4_bodies``: every K4 launch of the 8B, Qwen3-8B, Gemma-3-4B and
gpt-oss prefills and of the 8B's served chunks ran the tensor-core body
(counted as ``flash_attention_mma`` / ``flash_attention_int8_mma``), and
tinydoc's the FMA body.
Kernel launch counts are set to 0 before each path and read after it.  A
replayed CUDA graph bypasses the wrappers' counts, so the fused loop's and
the batched step's launches are read from the counts the kernels keep on
the device (``kernels.device_counts``; the server reports them in its
/metrics).  The last line is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero.  Without a CUDA device, or without the package beside this file,
it exits non-zero and prints no result.

Usage: python3 chip_smoke.py

``python3 chip_smoke.py --plant-faults [-j N] [fault ...]`` shows instead whether
the K1/K2, K3, K4, K5, K6/K7 and nib4 checks can fail: it copies the
package and this script into temporary directories, plants one known fault
(``FAULTS``, ``NIB4_FAULTS``, ``K4_FAULTS``, ``K5_FAULTS`` and
``GEMV_FAULTS``; all of them unless some are named) in each copy's
``csrc/decode_stream.cu`` (``k6_next_group_scale`` in K6's GEMV tile,
``csrc/gemv_tile.cuh``), for K3's (``K3_FAULTS``)
``csrc/flash_decode.cu``, for K4's ``csrc/flash_attention.cu``, for K5's
``csrc/qmm.cu``, for K5's and K8's nib4 modes ``csrc/qmm.cu`` and
``csrc/rqmm.cu``, for K1/K2's ``csrc/gemv.cu``, builds the copies, and
prints K1/K2's errors against plain on every GEMV case (and an f32 x a
weight, ``gemv_errors_of_copy``), K5-nib4's and K8-nib4's on their gpt-oss
cases (``nib4_cases``), K5's on each ``kernel_times.QMM_CASES`` entry,
K3's on each ``kernel_times.K3_CASES`` entry, K4's on each ``K4_CASES``
entry and the errors that
``decode_errors`` reads for each
(K6 on two 8B layers and on two Mixtral
Q4_K_M layers, K7 on the 18 layers of the 270M shape, K6's gemma mode on 6
Gemma-3-4B layers, K7's on the 18 of Gemma-3-270M, K6's qwen modes on 2
layers each of Qwen3-8B, Qwen3-30B-A3B and bias-free Qwen1.5-MoE; B = 1,
n_past 700), the unmodified source first (on the kernels of the named
faults); the ``moe_qk_norm_skipped`` copy also runs the
``qwen3moe_30b_a3b`` phase's 8-step comparison at its depth, with its
one-ulp control.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOP_S = 989e12       # H100 SXM dense bf16 tensor-core peak
F32_FLOP_S = 67e12         # H100 SXM float32 outside the tensor cores
TOL = 2e-2                 # max |kernel - plain| / max |plain|, as the JAX tests
TOL_Q4KM = 8e-2            # decode logits of the Q4_K_M mix (JAX tests' bound)
TOL_F32X = 1e-4            # K1/K2 on an f32 x against the f32 plain version: the
# kernel's high part and remainder keep ~17 bits of x (the card test
# test_gemv_f32_x_and_bf16_out's bound)
FIX = ROOT / "tests" / "fixtures"
PKG = "llama_cpp_gfx906_tpu_torch"

# --plant-faults: name -> (text of csrc/decode_stream.cu, what replaces it),
# or (file under the package, text, what replaces it)
FAULTS = {
    "none": None,
    # the current token's value left out of its own attention output
    "no_self_value": ("o += ws * bf16r(ldcg(vrow + d));", ""),
    # every layer but the last loses its MLP residual
    "no_mlp_residual": ("return bf16r(ldcg(a.xmid + (size_t)m * D + k) + mb);",
                        "return bf16r(ldcg(a.xmid + (size_t)m * D + k));"),
    # attention reads one live row too few
    "one_row_short": ("const int live = min(np, a.S);",
                      "const int live = min(np - 1, a.S);"),
    # gemma: q and k rotated without their per-head RMS norms
    "no_qk_norm": ("  const bool norm = w != nullptr;", "  const bool norm = false;"),
    # gemma: each post-norm weighted by the other's vector
    "post_norms_swapped": ("T_PANORM = 46,\n              T_PFNORM = 47",
                           "T_PANORM = 47,\n              T_PFNORM = 46"),
    # gemma: every layer rotates with the local (SWA) rope table
    "one_rope_base": ("(GEMMA && tb[T_SWA]) ? a.inv_freq_local", "GEMMA ? a.inv_freq_local"),
    # the MoE router drops each token's best expert: the second best takes
    # its place (and the third the second's)
    "wrong_expert": ("    float wsum = 0.f;\n",
                     "    float wsum = 0.f;\n    {\n      int b0 = 0;\n"
                     "      for (int i = 1; i < E; ++i)\n"
                     "        if (lg[i] > lg[b0]) b0 = i;\n"
                     "      lg[b0] = lcg::kNegInf;\n    }\n"),
    # qwen2moe: the shared expert's down partial sums scaled by 0
    "shexp_dropped": ("nsplit, u, smem,\n                                        e_sig);",
                      "nsplit, u, smem,\n                                        0.f);"),
    # qwen2moe: the shared expert taken ungated
    "shexp_gate_ignored": ("e_sig = sgi != nullptr ? 1.f / (1.f + expf(-t)) : 1.f;",
                           "e_sig = 1.f;"),
    # qwen3moe: an MoE stack dispatched to the instantiation without qk-norm
    "moe_qk_norm_skipped": ("return launch<1, FOLDED, true, true, GEMMA, KV>",
                            "return launch<1, FOLDED, true, true, false, KV>"),
    # the attention merge leaves out the last split
    "k6_merge_split_dropped": ("for (int sp = 0; sp < a.nsplit; ++sp) o += ldcg(",
                               "for (int sp = 0; sp < a.nsplit - 1; ++sp) o += ldcg("),
    # each GEMV unit takes the next quant group's scale for its rows (the low
    # K half's, for nib4c; the last group wraps to the first)
    "k6_next_group_scale": (
        "csrc/gemv_tile.cuh",
        "load_planes<FOLDED>(s, sd, klo / group, klo / sgroup, Np, col0, sc_lo);",
        "load_planes<FOLDED>(s, sd, (klo / group + 1) % (K / group), klo / sgroup, Np, col0,"
        " sc_lo);"),
    # K3: the ALiBi distance from physical rows while logical positions are set
    "alibi_physical_under_pos": (
        "if (alibi) sc -= sh.slope[qi] * static_cast<float>(qp - kq);",
        "if (alibi) sc -= sh.slope[qi] * static_cast<float>(qph - kp);"),
    # K3: the physical window skip kept with logical positions on
    "pos_window_skip": (
        "const int lo = (window > 0 && kv_pos == nullptr) ? max(0, n_past + 1 - window) : 0;",
        "const int lo = window > 0 ? max(0, n_past + 1 - window) : 0;"),
    # K3: the sink joins every partial state's denominator (each warp's and
    # each split's), not once at the last merge
    "k3_sink_per_split": ("L += w * l;",
                          "L += w * (l > 0.f ? l + expf(sk - sh.mw[i][qi]) : l);"),
    # K3: the partial states summed without their rescale exp(m_s - M)
    "k3_merge_unrescaled": ("const float w = l > 0.f ? expf(m - M) : 0.f;",
                            "const float w = l > 0.f ? 1.f : 0.f;"),
}
K3_FAULTS = ("alibi_physical_under_pos", "pos_window_skip", "k3_sink_per_split",
             "k3_merge_unrescaled")  # csrc/flash_decode.cu
# --plant-faults of K5's and K8's nib4 modes: name -> its edits, each (file
# under the package, text, what replaces it); each plants the fault in both
NIB4_FAULTS = {
    # the low and the high nibble read as the other K half's
    "nib4_halves_swapped": (
        ("csrc/qmm.cu", "h ? (words[i] >> 4) & 0x0F0F0F0Fu : words[i] & 0x0F0F0F0Fu",
         "h ? words[i] & 0x0F0F0F0Fu : (words[i] >> 4) & 0x0F0F0F0Fu"),
        ("csrc/rqmm.cu", "v8[0] = words[i] & 0x0F0F0F0Fu;\n            v8[H - 1] = (",
         "v8[H - 1] = words[i] & 0x0F0F0F0Fu;\n            v8[0] = (")),
    # the mins left out: K5 subtracts them after the product (its epilogue,
    # as the JAX wrapper does after its kernel), K8 folds them into each
    # weight
    "nib4_mins_dropped": (
        ("csrc/qmm.cu", "return make_float4(p.x - mn.x, p.y - mn.y, p.z - mn.z, p.w - mn.w);",
         "return p;"),
        ("csrc/rqmm.cu", "return launch<true>(x, q, s, m, idx,",
         "return launch<true>(x, q, s, nullptr, idx,")),
}

# --plant-faults of K5 (both modes): name -> its edits (file under the
# package, text, what replaces it)
K5_FAULTS = {
    # each 64-row step dequantized with its first scale row only (shows at
    # group 32 and 16: a step spans 2 or 4 scale rows)
    "k5_first_scale_row": (("csrc/qmm.cu", "const int seg = 2 * p / group;",
                            "const int seg = 0;"),),
    # the split merge leaves the last split's partials out
    "k5_split_dropped": (("csrc/qmm.cu", "for (int src = 0; src < nsplit; ++src) {",
                          "for (int src = 0; src < nsplit - 1; ++src) {"),),
    # each group's x sums multiplied by the next group's min row
    "k5_mins_wrong_group": (
        ("csrc/qmm.cu", "+ H * MAX_SEG * BN + j * BN + mcol + 2 * tq;",
         "+ H * MAX_SEG * BN + (j + 1) % nseg * BN + mcol + 2 * tq;"),),
}

# --plant-faults of K1 / K2: name -> its edits (file under the package,
# text, what replaces it)
GEMV_FAULTS = {
    # each scale run's product (and x sums) times the next group's scale
    # (and min) row
    "gemv_next_group_scale": (
        ("csrc/gemv.cu", "return h * GPR + (kpart * R + r * RL) / G;",
         "return h * GPR + ((kpart * R + r * RL) / G + 1) % GPR;"),),
    # the cluster merge leaves the last split's partials out
    "gemv_split_dropped": (("csrc/gemv.cu", "for (int src = 0; src < a.nsplit; ++src) {",
                            "for (int src = 0; src < a.nsplit - 1; ++src) {"),),
    # nib4c: the high nibbles multiplied against the low half's x rows
    "gemv_hi_nibbles_lo_x": (
        ("csrc/gemv.cu",
         "mma(d[H - 1][j], hi[0], hi[1], hi[2], hi[3], b[H - 1][p][0], b[H - 1][p][1]);",
         "mma(d[H - 1][j], hi[0], hi[1], hi[2], hi[3], b[0][p][0], b[0][p][1]);"),),
    # the mins left out (nib4c's bias of 128 still taken off)
    "gemv_mins_dropped": (("csrc/gemv.cu", "const bool mins = a.mins;",
                           "const bool mins = false;"),),
    # an f32 x's bf16 remainder left out: its high part alone
    "gemv_f32_remainder_dropped": (
        ("csrc/gemv.cu", "b[1][i] = *reinterpret_cast<const uint32_t*>(&lo);", "b[1][i] = 0u;"),),
}

# --plant-faults of K4's tensor-core body: name -> its edits (file under the
# package, text, what replaces it)
K4_FAULTS = {
    # the causal diagonal lets each query see the next key too
    "k4_causal_one_past": (
        ("csrc/flash_attention.cu",
         "const bool live = kp < k_end && kp <= qp && (window <= 0 || kp > qp - window);",
         "const bool live = kp < k_end && kp <= qp + 1 && (window <= 0 || kp > qp - window);"),),
    # int8: the key's scale left off its score column
    "k4_int8_kscale_dropped": (
        ("csrc/flash_attention.cu", "if constexpr (I8) x *= ksc[col];", ""),),
    # int8: the value's scale left off p
    "k4_int8_vscale_dropped": (
        ("csrc/flash_attention.cu", "if constexpr (I8) s[n][e] *= vsc[8 * n + 2 * tq + (e & 1)];",
         ""),),
    # the sink joins the running max but not the denominator
    "k4_sink_not_in_denominator": (
        ("csrc/flash_attention.cu", "den = den * alpha + expf(sk - mn);", "den = den * alpha;"),),
}

KERNEL_INFO = {
    "gemv_int8": ("llama_cpp_gfx906_tpu_torch/csrc/gemv.cu",
                  "llama_cpp_gfx906_tpu/ops/quant_matmul.py:725"),
    "gemv_nib4c": ("llama_cpp_gfx906_tpu_torch/csrc/gemv.cu",
                   "llama_cpp_gfx906_tpu/ops/quant_matmul.py:813"),
    "flash_decode": ("llama_cpp_gfx906_tpu_torch/csrc/flash_decode.cu",
                     "llama_cpp_gfx906_tpu/ops/flash_decode.py:62"),
    "flash_attention": ("llama_cpp_gfx906_tpu_torch/csrc/flash_attention.cu",
                        "llama_cpp_gfx906_tpu/ops/flash_attention.py:29"),
    "decode_stream": ("llama_cpp_gfx906_tpu_torch/csrc/decode_stream.cu",
                      "llama_cpp_gfx906_tpu/ops/decode_stream.py:97"),
    "decode_step": ("llama_cpp_gfx906_tpu_torch/csrc/decode_stream.cu",
                    "llama_cpp_gfx906_tpu/ops/decode_step.py:69"),
    "qmm_int8": ("llama_cpp_gfx906_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_gfx906_tpu/ops/quant_matmul.py:706"),
    "rqmm_int8": ("llama_cpp_gfx906_tpu_torch/csrc/rqmm.cu",
                  "llama_cpp_gfx906_tpu/ops/quant_matmul.py:1225"),
    "decode_stream_moe": ("llama_cpp_gfx906_tpu_torch/csrc/decode_stream.cu",
                          "llama_cpp_gfx906_tpu/ops/decode_stream.py:676"),
    "decode_stream_gemma": ("llama_cpp_gfx906_tpu_torch/csrc/decode_stream.cu",
                            "llama_cpp_gfx906_tpu/ops/decode_stream.py:519"),
    "decode_step_gemma": ("llama_cpp_gfx906_tpu_torch/csrc/decode_stream.cu",
                          "llama_cpp_gfx906_tpu/ops/decode_step.py:167"),
    "decode_stream_qk_norm": ("llama_cpp_gfx906_tpu_torch/csrc/decode_stream.cu",
                              "llama_cpp_gfx906_tpu/ops/decode_stream.py:519"),
    "decode_stream_moe_qk_norm": ("llama_cpp_gfx906_tpu_torch/csrc/decode_stream.cu",
                                  "llama_cpp_gfx906_tpu/ops/decode_stream.py:676"),
    "decode_stream_shexp": ("llama_cpp_gfx906_tpu_torch/csrc/decode_stream.cu",
                            "llama_cpp_gfx906_tpu/ops/decode_stream.py:683"),
    "qmm_nib4": ("llama_cpp_gfx906_tpu_torch/csrc/qmm.cu",
                 "llama_cpp_gfx906_tpu/ops/quant_matmul.py:948"),
    "rqmm_nib4": ("llama_cpp_gfx906_tpu_torch/csrc/rqmm.cu",
                  "llama_cpp_gfx906_tpu/ops/quant_matmul.py:1253"),
}
# the count a summary entry reads where its name is not a count of its own:
# qwen3's qk-norm is K6's gemma instantiation with has_post 0; qwen3moe's
# MoE with qk-norm its MoE + gemma instantiation
COUNT_NAME = {"decode_stream_qk_norm": "decode_stream_gemma",
              "decode_stream_moe_qk_norm": "decode_stream_moe_gemma"}
# the K3 / K4 modes of the serve path: the same kernels, counted apart
for _mode in ("int8", "shared", "int8_shared", "alibi", "pos"):
    KERNEL_INFO[f"flash_decode_{_mode}"] = KERNEL_INFO["flash_decode"]
# K4's tensor-core body (bf16 q; "flash_attention" alone: the FMA body of an
# f32 q, whose launches the tinydoc phase counts)
for _mode in ("mma", "int8_mma"):
    KERNEL_INFO[f"flash_attention_{_mode}"] = KERNEL_INFO["flash_attention"]
# the path whose launch count each kernel reports in the summary line (the
# serve paths' counts are the kernels' device-side counts: the batched
# decode step is a replayed CUDA graph)
KERNEL_PATH = {"gemv_int8": "8b_layer_loop", "gemv_nib4c": "8b_layer_loop",
               "flash_decode": "8b_layer_loop", "flash_attention": "tinydoc",
               "flash_attention_mma": "8b_layer_loop",
               "decode_stream": "8b", "decode_step": "270m_q8_0",
               "qmm_int8": "270m_q8_0",
               "flash_decode_int8": "8b_serve_http_q8",
               "flash_attention_int8_mma": "8b_serve_http_q8",
               "flash_decode_int8_shared": "8b_serve_q8_shared",
               "flash_decode_shared": "8b_serve_bf16_shared",
               "decode_stream_moe": "mixtral_q4km", "rqmm_int8": "mixtral_q8_0_serve",
               "decode_stream_gemma": "gemma3_4b", "decode_step_gemma": "gemma3_270m_q8_0",
               "decode_stream_qk_norm": "qwen3_8b",
               "decode_stream_moe_qk_norm": "qwen3moe_30b_a3b",
               "decode_stream_shexp": "qwen2moe_shexp",
               "flash_decode_alibi": "mpt_7b_fused", "flash_decode_pos": "8b_self_extend",
               "qmm_nib4": "gpt_oss_20b_prefill", "rqmm_nib4": "gpt_oss_20b_fused"}
# one main-path case per kernel in the summary line (K4: also the one case
# of each body whose plain version is timed, ``k4_cases``)
SUMMARY_CASE = {"gemv_int8": "lm_head 4096x129024 M=1",
                "gemv_nib4c": "ffn_gate_up 4096x28672 M=1",
                "flash_decode": "S=8192 n_past=8000 window=0", "flash_attention": "tinydoc f32 T=256",
                "flash_attention_mma": "8B 32/8 T=512 n_past=256",
                "decode_stream": "B=1 n_past=3000", "decode_step": "B=1 n_past=3000",
                "qmm_int8": "ffn_gate_up", "flash_decode_int8": "8b B=4 int8 n_past=17/",
                "flash_decode_shared": "8b B=4 bf16 S0=512 n_past=700",
                "flash_decode_int8_shared": "8b B=4 int8 S0=512",
                "flash_attention_int8_mma": "8b T=256 n_past=700",
                "rqmm_int8": "gate 4096x14336 P=2", "decode_stream_moe": "n_past=3000 nib4c",
                "decode_stream_gemma": "B=1 n_past=3000", "decode_step_gemma": "B=1 n_past=3000",
                "decode_stream_qk_norm": "B=1 n_past=3000",
                "decode_stream_moe_qk_norm": "n_past=3000",
                "decode_stream_shexp": "n_past=3000 gate",
                "flash_decode_alibi": "mpt B=1 bf16 n_past=3000",
                "flash_decode_pos": "8b gan4 gaw1024 T=1 bf16",
                "qmm_nib4": "M=1000", "rqmm_nib4": "P=4"}
SERVE_PROMPT_LENS = (256, 384, 512, 640, 768, 896, 1024, 320)
# the serve path's launches per 4-slot decode step
SERVE_PER_STEP = {"q8": {"flash_decode_int8": 32, "flash_decode": 32, "gemv_nib4c": 128,
                         "gemv_int8": 33, "decode_stream": 0},
                  "bf16": {"decode_stream": 1, "gemv_int8": 1, "gemv_nib4c": 0,
                           "flash_decode": 0}}
N_CHUNK = 256  # the server's prefill chunk: a prompt of n tokens prefills in
# chunks of 256 and a last one of n % 256
# per served model, a prefill chunk of T tokens launches, on each of its L
# layers, the attention kernel T takes (K3 when G * T <= 128, else K4's
# tensor-core body, mode "mma"; each also in its int8 mode on a q8 cache)
# and, for T <= 8, the GEMVs of the
# layer's projections (K2 per nib4c one, K1 per int8 one), else K5 per
# plain-scale int8 one (nib4c and folded ones take the dequant matmul);
# then the head's K1 on the chunk's last row where the head is quantized
SERVE_CHUNK = {"8b": dict(L=32, G=4, gemv={"gemv_nib4c": 4, "gemv_int8": 1}, k5=0, head=1),
               "gemma3_4b": dict(L=34, G=2, gemv={"gemv_nib4c": 4, "gemv_int8": 1}, k5=1,
                                 head=0),
               "qwen3_8b": dict(L=36, G=4, gemv={"gemv_nib4c": 4, "gemv_int8": 1}, k5=0,
                                head=1)}
CHUNK_KERNELS = ("flash_decode", "flash_decode_int8", "flash_attention",
                 "flash_attention_int8", "flash_attention_mma", "flash_attention_int8_mma",
                 "gemv_nib4c", "gemv_int8", "qmm_int8")


def chunk_launches(model: str, kind: str, T: int) -> dict:
    """The launches of one prefill chunk of T tokens (``SERVE_CHUNK``)."""
    m = SERVE_CHUNK[model]
    out = dict.fromkeys(CHUNK_KERNELS, 0)
    attn = "flash_decode" if m["G"] * T <= 128 else "flash_attention"
    out[attn] = m["L"]
    mode = [f for f, on in (("int8", kind == "q8"), ("mma", attn == "flash_attention")) if on]
    if mode:
        out[f"{attn}_{'_'.join(mode)}"] = m["L"]
    if T <= 8:
        for k, n in m["gemv"].items():
            out[k] += n * m["L"]
    else:
        out["qmm_int8"] = m["k5"] * m["L"]
    out["gemv_int8"] += m["head"]
    return out


def prompt_chunks(n: int) -> list[int]:
    return [N_CHUNK] * (n // N_CHUNK) + ([n % N_CHUNK] if n % N_CHUNK else [])
SYSTEM_LEN = 512  # the shared system prompt of the serve path's shared runs
MIXTRAL_Q8_LAYERS = 4  # the mixtral_q8_0 phase's cut depth (of 32)
# its batched decode step at 4 slots (bf16 cache: the per-layer loop, K6
# refuses MoE at B > 1), per layer: K1 for q|k|v and o, K3, K8 for the
# experts' gate, up and down; plus K1 for the head.  A prefill chunk (more
# than 8 tokens: the dense path) per layer: K5 for q|k|v, o and each of the
# 8 experts' 3 matrices, K4; plus K1 for the head on the chunk's last row
MIXTRAL_PER_STEP = {"rqmm_int8": 3 * MIXTRAL_Q8_LAYERS,
                    "gemv_int8": 2 * MIXTRAL_Q8_LAYERS + 1,
                    "flash_decode": MIXTRAL_Q8_LAYERS, "decode_stream": 0,
                    "qmm_int8": 0, "flash_attention": 0}
MIXTRAL_PER_CHUNK = {"qmm_int8": (2 + 3 * 8) * MIXTRAL_Q8_LAYERS,
                     "flash_attention": MIXTRAL_Q8_LAYERS, "gemv_int8": 1,
                     "rqmm_int8": 0, "flash_decode": 0, "decode_stream": 0}
GEMMA_PROMPT_TOKENS = 1500  # the gemma3_4b prefill: past the 1,024 window
# ragged: last chunks of 3 (GEMVs, K3), 36 (K5, K3) and 133-244 tokens (K4)
GEMMA_SERVE_LENS = (256, 500, 1060, 1024, 1283, 1536, 390, 1157)
G4B = 34  # Gemma-3-4B layers
# its served decode step at 4 slots, q8 cache: per layer K2 on q|k, o,
# gate|up and down, K1 on the Q6_K attn_v, K3-int8; bf16: one K6 (gemma
# mode).  The tied head is a dense bf16 product (no K1).  A prefill chunk
# (64-256 tokens) per layer: K4 and K5 on attn_v (plain-scale int8; the
# nib4c projections take the dequant matmul)
GEMMA_PER_STEP = {"q8": {"flash_decode_int8": G4B, "flash_decode": G4B, "gemv_nib4c": 4 * G4B,
                         "gemv_int8": G4B, "decode_stream": 0},
                  "bf16": {"decode_stream": 1, "decode_stream_gemma": 1, "gemv_int8": 0,
                           "gemv_nib4c": 0, "flash_decode": 0}}
QWEN3_L = 36  # Qwen3-8B layers
QWEN3_PROMPT_TOKENS = 1499  # the qwen3_8b prefill (ragged)
# ragged: last chunks of 5 (GEMVs, K3), 25 and 20 (K3), 188-208 tokens (K4)
QWEN3_SERVE_LENS = (256, 517, 700, 1049, 1300, 1536, 390, 2000)
# its served decode step at 4 slots, q8 cache: per layer K2 on q|k, o,
# gate|up and down, K1 on the Q6_K attn_v, K3-int8, and the head's K1;
# bf16: one K6 (its gemma instantiation: qk-norm) and the head's K1
QWEN3_PER_STEP = {"q8": {"flash_decode_int8": QWEN3_L, "flash_decode": QWEN3_L,
                         "gemv_nib4c": 4 * QWEN3_L, "gemv_int8": QWEN3_L + 1,
                         "decode_stream": 0},
                  "bf16": {"decode_stream": 1, "decode_stream_gemma": 1, "gemv_int8": 1,
                           "gemv_nib4c": 0, "flash_decode": 0}}
QWEN2_LAYERS = 4  # the qwen2_7b and qwen2moe_a2_7b phases' cut depths (of 28, 24)
# the qwen3moe_30b_a3b phase's depth (of 48): the phase took ~103 s at 48
# and ~61 s at 24 on an H100, and at 48 the whole run would near its
# 1,200 s limit once K1/K2's M 4 / 8 cases and MPT-7B's per-call holds
# came in
QWEN3MOE_LAYERS = 24
MIXTRAL_Q4_LAYERS = 4  # the mixtral_q4km phase's cut depth (of 32)
SE_PROMPT_TOKENS, SE_NEW_TOKENS = 3000, 64  # the 8b_self_extend phase
GA_N, GA_W = 4, 1024  # its -gan / -gaw
# its launches per decode token (the per-layer loop, K3's self-extend mode)
SE_PER_TOKEN = {"flash_decode_pos": 32, "flash_decode": 32, "gemv_nib4c": 128,
                "gemv_int8": 33, "decode_stream": 0, "decode_step": 0}
MPT_PROMPT_TOKENS = 1531  # the mpt_7b prefill (ragged)
# MPT-7B's launches per fused decode token: per layer K2 on q|k|v, o, up
# and down, K3-ALiBi; the head's K1; no K6/K7 (refused, as in JAX)
MPT_PER_TOKEN = {"flash_decode_alibi": 32, "flash_decode": 32, "gemv_nib4c": 128,
                 "gemv_int8": 1, "decode_stream": 0, "decode_step": 0}
BLOOM_LAYERS = 4  # the bloom_7b1 phase's cut depth (of 30)
# the gpt_oss_20b phase's depth (of 24): at full depth the whole run took
# 1,045-1,086 s, past its 1,050 s budget; the shapes and launches per layer
# do not change with depth
OSS_LAYERS = 6
OSS_CPU_LAYERS = 4  # its cut held against the CPU's plain loop, with the
OSS_CPU_VOCAB = 8192  # first 8,192 tokens (the CPU's head costs ~3 s a step
# at the full 201,088: the whole run neared its 1,200 s limit)
OSS_PROMPT_TOKENS = 997  # its prefill (ragged)
OSS_E = 32  # gpt-oss-20b's experts


def oss_per_token(L: int) -> dict:
    """gpt-oss's launches per decode token through the per-layer loop: per
    layer K1 on the fused q|k|v (int8 with mins at K 2880), K2 on o, K3
    (sinks; window 128 on the even layers), K8-nib4 on the chosen pairs'
    gate and up (the nib4c down experts take the quantized gather); the
    head's K1.  No K6/K7 (refused, as in JAX)."""
    return {"rqmm_nib4": 2 * L, "gemv_int8": L + 1, "gemv_nib4c": L, "flash_decode": L,
            "decode_stream": 0, "decode_step": 0, "qmm_nib4": 0, "flash_attention": 0}


def oss_per_prefill(L: int, T: int) -> dict:
    """gpt-oss's launches for a prefill of T > 8 tokens: per layer K5-int8 on
    q|k|v, K5-nib4 on every expert's gate and up (the all-experts path; o
    and the nib4c down experts take the dequant matmul), K4 where
    8 T > 128 (else K3); the head's K1 on the last row."""
    attn = "flash_decode" if 8 * T <= 128 else "flash_attention"
    other = "flash_attention" if attn == "flash_decode" else "flash_decode"
    return {"qmm_nib4": 2 * OSS_E * L, "qmm_int8": L, attn: L, other: 0, "gemv_int8": 1,
            "gemv_nib4c": 0, "rqmm_nib4": 0}


FAILURES: list[str] = []


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def fail(message: str) -> None:
    """Record a failed check; the script goes on with the other phases and
    exits non-zero at the end."""
    FAILURES.append(message)
    emit(phase="failure", message=message)


def run_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 (every phase runs; the exit code tells)
        traceback.print_exc()
        fail(f"{name}: {e!r}")
        return None
    finally:
        emit(phase="phase_time", name=name, seconds=time.perf_counter() - t0)


def device_ms(fn, torch, flush, n: int = 10) -> float:
    """Device time per call of ``fn`` (``tools/kernel_times.device_ms``)."""
    from llama_cpp_gfx906_tpu_torch.tools.kernel_times import device_ms as timed

    return timed(fn, torch, flush, n)


def bound(nbytes: float, flops: float, flop_s: float = BF16_FLOP_S) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_S * 1e3, flops / flop_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check(name: str, got, ref, torch, tol: float = TOL) -> tuple[float, float]:
    got, ref = got.float(), ref.float()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite kernel output")
    abs_err = float((got - ref).abs().max())
    rel = abs_err / max(float(ref.abs().max()), 1e-30)
    if not rel <= tol:
        fail(f"{name}: max error / max|plain| = {rel} > {tol}")
    return abs_err, rel


def bit_identical(name: str, a, b, torch) -> bool:
    """Two launches on the same inputs: their outputs hold the same bits
    (the split-K sums add in a fixed order)."""
    torch.cuda.synchronize()
    same = bool(torch.equal(a, b))
    if not same:
        fail(f"{name}: two launches on the same inputs differ by "
             f"{float((a.float() - b.float()).abs().max())}")
    return same


def kernel_counts(reset: bool = False) -> dict:
    """Every kernel wrapper's launch count (set to 0 first with ``reset``)."""
    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.models import llama  # noqa: F401 (registers all)

    if reset:
        kernels.set_counts({})
    return kernels.counts()


def phase_build(torch):
    from llama_cpp_gfx906_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    report = {}
    for name in kernels.SOURCES:
        lines = kernels.ptxas_reports.get(name, "").splitlines()
        report[name] = [ln.split("ptxas info    :")[-1].strip() for ln in lines
                        if "registers" in ln or "spill" in ln or "Compiling" in ln]
        kernels.lib(name)
    emit(phase="build", seconds=time.perf_counter() - t0, ptxas=report)


def phase_kernels(torch, results: dict, tmp: Path) -> None:
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt
    import numpy as np

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)

    def record(name, case, err, ms, plain_ms, nbytes, flops, lib_ms,
               flop_s=BF16_FLOP_S, **extra):
        b_ms, b_by = bound(nbytes, flops, flop_s)
        emit(phase="kernel", kernel=name, case=case, max_abs_err=err[0],
             rel_err=err[1], tol=TOL, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
             bound_by=b_by, library_ms=lib_ms, **extra)
        results.setdefault(name, []).append(dict(
            case=case, max_abs_err=err[0], ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))

    one_launch_checks(torch, dev)
    # K1 / K2: folded Q6_K int8 (head, attn_v) and folded Q4_K nib4c, M 1 / 4 / 8
    gemv_seen: dict = {}
    gemv_cases(torch, dev, flush, record, kt.GEMV_CASES, rng, g, gemv_seen)

    k4_cases(torch, dev, flush, record)
    k3_cases(torch, dev, flush, record)

    k5_cases(torch, dev, flush, record)

    decode_cases(torch, flush, record, tmp)
    expert_cases(torch, dev, flush, record)
    oss_cases(torch, dev, flush, record, gemv_seen)
    del flush


# (x dtype, M) of the K1 / K2 calls whose card kernels one_launch_checks lists
GEMV_CALL_CHECKS = (("bfloat16", 1), ("bfloat16", 3), ("float32", 1))


def one_launch_checks(torch, dev) -> None:
    """The kernels each ``quant_matmul`` call runs on the card, in one
    profiler session, the run's first (``kernels_of_call``; on the card a
    later session missed the kernels of a library first launched after an
    earlier one): K1 on the 8B's ``attn_v`` weight and K2 on its q|k, each
    for a bf16 x at M 1 and 3 and an f32 x at M 1; K5 on the first
    ``QMM_CASES`` entry with mins of each mode.  Each call must run one
    kernel, its own: no pad, cast or mins kernels beside it."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    rng = np.random.default_rng(7)
    g = torch.Generator(device=dev).manual_seed(7)
    calls, want = [], []
    for name, case, gtype, K, N, pad, _ in kt.GEMV_CASES:
        if not case.startswith(("attn_v", "attn_qk")) or "M=1" not in case:
            continue
        qt = kt.gemv_weights(rng, gtype, K, N, pad, dev)
        for dtype, M in GEMV_CALL_CHECKS:
            x = torch.randn((M, K), generator=g, device=dev).to(getattr(torch, dtype))
            calls.append((f"{name} {case.split()[0]} {dtype} M={M}",
                          lambda x=x, qt=qt: qmm.quant_matmul(x, qt)))
            want.append("gemv_kernel")
    for mode in ("int8", "nib4"):
        i, spec = next((i, c) for i, c in enumerate(kt.QMM_CASES)
                       if c[0] == mode and c[2] == "Q4_0")
        c = kt.qmm_case(torch, dev, spec, 80 + i)
        calls.append((f"{c['name']} {c['case']}", c["kern"]))
        want.append("qmm_kernel")
    ran = kernels_of_call(torch, *(fn for _, fn in calls))
    ok = len(ran) == len(want) and all(w in r for w, r in zip(want, ran))
    emit(phase="one_launch", calls=[n for n, _ in calls], ran=ran, ok=ok)
    if not ok:
        fail(f"one_launch: the calls {[n for n, _ in calls]} ran {ran} on the card, want "
             f"one kernel each: {want}")
    torch.cuda.empty_cache()


def gemv_cases(torch, dev, flush, record, cases, rng, g, seen: dict) -> None:
    """K1 / K2 on ``cases`` (``kernel_times.GEMV_CASES`` or
    ``OSS_GEMV_CASES``: each weight made once from ``rng``, x from ``g``),
    each against ``gemv_plain`` at TOL and launched twice (the same bits),
    timed as the main path calls it (``quant_matmul``, bf16 out: one
    launch) beside its bound (the planes' bytes once, x in, bf16 out), with
    the tile columns and split count the launch took.  ``torch.matmul`` on
    the weight dequantized to bf16 beforehand is timed once per weight, at
    M 1 (reading the bf16 weight dominates it at every M up to 8); the
    plain version once per kernel, at its ``SUMMARY_CASE`` (``seen`` keeps
    the kernels already timed, across calls).  An f32 x at M 1 of each weight
    is held to the f32 plain version at TOL_F32X (its high part and
    remainder: ~2^-17).  One launch a call: ``one_launch_checks``.  Emits
    the loop's wall time."""
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    t0 = time.perf_counter()

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for (gtype, K, N, pad), group in kt.gemv_by_shape(cases):
        qt = kt.gemv_weights(rng, gtype, K, N, pad, dev)
        w = qmm.dequantize_qt(qt, torch.bfloat16)
        kp, Np = qt.q.shape
        tn, splits = qmm.gemv_config(kp, Np, sms)
        planes = sum(t.numel() * t.element_size()
                     for t in (qt.q, qt.s, qt.m, qt.sd, qt.md) if t is not None)
        name = group[0][0]
        kern = getattr(qmm, name)
        x = torch.randn((1, K), generator=g, device=dev)
        f32 = check(f"{name} {group[0][1]} f32 x", kern(x, qt), qmm.gemv_plain(x, qt), torch,
                    TOL_F32X)
        for _, case, *_, M in group:
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            got = kern(x, qt)
            err = check(f"{name} {case}", got, qmm.gemv_plain(x, qt), torch)
            same = bit_identical(f"{name} {case}", got, kern(x, qt), torch)
            plain_ms = None
            if name not in seen and SUMMARY_CASE[name] in case:
                seen[name] = True
                plain_ms = device_ms(lambda: qmm.gemv_plain(x, qt), torch, flush)
            lib_ms = device_ms(lambda: torch.matmul(x, w), torch, flush) if M == 1 else None
            record(name, case, err, device_ms(lambda: qmm.quant_matmul(x, qt), torch, flush),
                   plain_ms, planes + M * K * 2 + M * N * 2, 2 * M * K * N, lib_ms,
                   bit_identical=same, tn=tn, splits=splits, f32_x_rel_err=f32[1])
        del w, qt
        torch.cuda.empty_cache()
    emit(phase="gemv_cases", cases=len(cases), seconds=time.perf_counter() - t0)


def k5_cases(torch, dev, flush, record) -> None:
    """K5 on ``kernel_times.QMM_CASES`` (both modes; inputs from seed 80 +
    the case's index, ``kernel_times.qmm_case``) through ``quant_matmul``
    as the main path calls it (bf16 x and out: one launch), each against
    ``qmm_plain`` (its bf16 output) at TOL, launched twice (the same bits),
    timed beside its bound (bf16 tensor cores or the bytes: x, the packed
    weight, scales and mins once, the bf16 output) and ``torch.matmul`` on
    the weight dequantized to bf16 beforehand, with the tile rows and split
    count the launch took.  The plain version is timed once per mode, at
    its ``SUMMARY_CASE`` (one launch a call: ``one_launch_checks``).  Emits
    the loop's wall time."""
    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    t0, plain_timed = time.perf_counter(), set()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for i, spec in enumerate(kt.QMM_CASES):
        c = kt.qmm_case(torch, dev, spec, 80 + i)
        name = c["name"]
        got = c["kern"]()
        err = check(f"{name} {c['case']}", got, c["plain"](), torch)
        same = bit_identical(f"{name} {c['case']}", got, c["kern"](), torch)
        plain_ms = None
        if name not in plain_timed and SUMMARY_CASE[name] in c["case"]:
            plain_timed.add(name)
            plain_ms = device_ms(c["plain"], torch, flush)
        kp, Np = c["qt"].q.shape
        bm, splits = qmm.qmm_config(spec[5], kp, Np, sms, c["mode"] == "nib4",
                                     c["qt"].m is not None)
        record(name, c["case"], err, device_ms(c["kern"], torch, flush), plain_ms,
               c["nbytes"], c["flops"], device_ms(c["lib"], torch, flush),
               bit_identical=same, bm=bm, splits=splits,
               library="torch.matmul on the weight dequantized to bf16 beforehand")
        del c, got
        torch.cuda.empty_cache()
    emit(phase="k5_cases", seconds=time.perf_counter() - t0)


def kernels_of_call(torch, *fns) -> list[str]:
    """The names of the kernels one call of each of ``fns`` ran on the
    card, in the order they started, in one torch.profiler session (after
    a warm-up call of each)."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    ran = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.name for e in sorted(ran, key=lambda e: e.time_range.start)]


def nib4_cases(torch, dev):
    """K5-nib4 and K8-nib4 at gpt-oss-20b's gate experts: the nib4 entries
    of ``kernel_times.QMM_CASES`` (``kernel_times.qmm_case``, M 101 / 256 /
    1000), then ``rqmm_nib4_cases``."""
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    for i, spec in enumerate(kt.QMM_CASES):
        if spec[0] == "nib4":
            yield kt.qmm_case(torch, dev, spec, 80 + i)
    yield from rqmm_nib4_cases(torch, dev)


def rqmm_nib4_cases(torch, dev):
    """K8-nib4 at gpt-oss-20b's gate experts (``kernel_times.RQMM_NIB4_CASES``:
    32 experts, P 4 / 8, inputs from their own seeds, 13 and 14): per case
    its name, case, kernel call, plain call, bytes (each distinct expert's
    packed slice, scales and mins once; x in, f32 out), operations and a
    library call (a gather of the experts dequantized to bf16 beforehand
    and ``torch.bmm``)."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    qt = kt.oss_experts(dev)
    K, Np = qt.K, qt.q.shape[-1]
    one = sum(t[0].numel() * t.element_size() for t in (qt.q, qt.s, qt.m))
    g = torch.Generator(device=dev).manual_seed(13)
    wb = qmm.dequantize_qt_experts(qt, torch.bfloat16)
    rng = np.random.default_rng(14)
    for case, P in kt.RQMM_NIB4_CASES:
        ids = kt.oss_pair_ids(rng, P)
        idx = torch.tensor(ids, dtype=torch.int32, device=dev)
        x = torch.randn((P, K), generator=g, device=dev).to(torch.bfloat16)
        distinct = len(set(ids.tolist()))
        yield dict(name="rqmm_nib4", case=case,
                   kern=lambda x=x, idx=idx: qmm.rqmm_nib4(x, qt, idx),
                   plain=lambda x=x, idx=idx: qmm.rqmm_nib4_plain(x, qt, idx),
                   lib=lambda x=x, idx=idx: torch.bmm(x[:, None, :], wb[idx.long()]),
                   nbytes=distinct * one + P * K * 2 + P * Np * 4, flops=2 * P * K * Np,
                   library="gather of pre-dequantized bf16 experts + torch.bmm",
                   distinct_experts=distinct)


def oss_cases(torch, dev, flush, record, gemv_seen: dict) -> None:
    """The kernels of the gpt_oss_20b phase at its shapes, each against its
    plain version and launched twice (the same bits): K8's nib4 mode
    (``rqmm_nib4_cases``); K1 at K 2880 (the fused q|k|v with mins, the head's
    2880 rows) and K2 at N 2880 (the o projection: a ragged last
    128-column tile), ``kernel_times.OSS_GEMV_CASES`` at M 1, 4 and 8
    (``gemv_cases``).  K5's (both modes) are ``k5_cases``', K3's and K4's
    gpt-oss cases are in ``kernel_times.K3_CASES`` and ``K4_CASES``.  Inputs
    from their own generators (seeds 15 and 16)."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    for c in rqmm_nib4_cases(torch, dev):
        got = c["kern"]()
        err = check(f"{c['name']} {c['case']}", got, c["plain"](), torch)
        same = bit_identical(f"{c['name']} {c['case']}", got, c["kern"](), torch)
        extra = {k: c[k] for k in ("library", "distinct_experts") if k in c}
        record(c["name"], c["case"], err, device_ms(c["kern"], torch, flush),
               device_ms(c["plain"], torch, flush), c["nbytes"], c["flops"],
               device_ms(c["lib"], torch, flush), bit_identical=same, **extra)
    torch.cuda.empty_cache()

    gemv_cases(torch, dev, flush, record, kt.OSS_GEMV_CASES, np.random.default_rng(15),
               torch.Generator(device=dev).manual_seed(16), gemv_seen)


def expert_cases(torch, dev, flush, record) -> None:
    """K8 at the Mixtral expert shapes (``kernel_times.EXPERT_CASES``: 8
    experts; gate 4096 x 14336 and down 14336 x 4096 for one token's 2
    pairs and 4 slots' 8, two distinct experts per token; once with mins,
    Q4_K experts unified to int8/g16), inputs from seeds of their own (5).
    K8's bound counts each distinct expert's slice once
    (``bound_ms_every_pair``: every pair's); its library yardstick is a
    gather of pre-dequantized bf16 experts and ``torch.bmm``."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    rng = np.random.default_rng(5)
    g = torch.Generator(device=dev).manual_seed(5)
    for case, gtype, N, K, pairs in kt.EXPERT_CASES:
        qt = kt.expert_weights(gtype, N, K, dev)
        wb = qmm.dequantize_qt_experts(qt, torch.bfloat16)
        one = sum(t[0].numel() * t.element_size() for t in (qt.q, qt.s, qt.m) if t is not None)
        for P in pairs:
            ids = kt.pair_ids(rng, P)
            idx = torch.tensor(ids, dtype=torch.int32, device=dev)
            x = torch.randn((P, K), generator=g, device=dev).to(torch.bfloat16)
            got = qmm.rqmm_int8(x, qt, idx)
            err = check(f"rqmm_int8 {case} P={P}", got, qmm.rqmm_plain(x, qt, idx), torch)
            same = bit_identical(f"rqmm_int8 {case} P={P}", got, qmm.rqmm_int8(x, qt, idx),
                                 torch)
            io = P * K * 2 + P * N * 4
            lib = lambda: torch.bmm(x[:, None, :], wb[idx.long()])  # noqa: E731
            record("rqmm_int8", f"{case} P={P}", err,
                   device_ms(lambda: qmm.rqmm_int8(x, qt, idx), torch, flush),
                   device_ms(lambda: qmm.rqmm_plain(x, qt, idx), torch, flush),
                   len(set(ids.tolist())) * one + io, 2 * P * K * N,
                   device_ms(lib, torch, flush), distinct_experts=len(set(ids.tolist())),
                   bound_ms_every_pair=bound(P * one + io, 2 * P * K * N)[0],
                   library="gather of pre-dequantized bf16 experts + torch.bmm",
                   bit_identical=same)
        del qt, wb
        torch.cuda.empty_cache()


def decode_cases(torch, flush, record, tmp: Path) -> None:
    """K6 and K7 in every mode (``kernel_times.DECODE_CASES``; each case's
    tokens from seed 100 + its index), each
    against the plain version at n_past 700 and 3000, with the per-layer
    loop's device time for the same step beside it: K6 on two full-width
    8B Q4_K_M layers (B 1 and 8); K7 on the 18 layers of the 270M Q8_0
    shape; the gemma modes, K6 on a 6-layer cut of Gemma-3-4B Q4_K_M
    (layers 0-4 local, 5 global; B 1 and 4) and K7 on the 18 layers of
    Gemma-3-270M Q8_0 (every 6th global; 3000 is above both windows, 1024
    and 512); K6's MoE branch on two full-width Mixtral layers with nib4c
    (Q4_K_M) and int8 (Q8_0) experts; K6's qwen modes on two full-width
    layers each: qk-norm without post-norms on Qwen3-8B Q4_K_M (B 1 and
    4), MoE with qk-norm on Qwen3-30B-A3B Q4_K_M (128 experts, top 8), and
    the shared expert on Qwen1.5-MoE-A2.7B Q8_0 with its q/k/v biases left
    out (the stack K6's gate takes), with its sigmoid gate and without it.
    Every case is held over the first two layers and each layer alone (its
    SWA flag kept), an MoE stack's expert ids beside the plain version's.
    K7's 18-layer llama stack is reported, not held whole: at that depth
    these random weights carry one bf16 rounding that the kernel and the
    plain version take differently to a few percent of the output (each
    case reports ``one_ulp_spread``, the plain version's own such move)."""
    from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    for i, (name, preset, L, batches, synth) in enumerate(kt.DECODE_CASES):
        eng, path = kt.decode_engine(str(tmp), preset, L, **synth)
        g = torch.Generator(device=eng.device).manual_seed(100 + i)
        if "gemma" in name and (not any(eng.cfg.swa_layers) or all(eng.cfg.swa_layers)):
            raise AssertionError(f"{name}: the stack lacks a local or a global layer")
        kern = (k7.fused_decode_step if name.startswith("decode_step")
                else k6.fused_decode_step_streamed)
        stacks = [(eng, {})]
        if name == "decode_stream_shexp":
            stacks = [(eng, dict(shexp_gate="gate")),
                      (without_shexp_gate(torch, eng), dict(shexp_gate="no gate"))]
        for stack, extra in stacks:
            if "moe_gate_inp" in stack.params["layers"][0]:
                extra = dict(extra, expert_format=stack.params["layers"][0]["moe_gate"].fmt)
            for B in batches:
                for n_past in (700, 3000):
                    decode_case(torch, stack, name, kern, k6.decode_layers_plain, B, n_past,
                                g, flush, record, name != "decode_step", **extra)
        del eng, stacks
        Path(path).unlink()
        torch.cuda.empty_cache()


class _Stack:
    """What ``decode_case`` reads of an engine: params, cfg, max_seq, device."""

    def __init__(self, params, cfg, max_seq, device):
        self.params, self.cfg, self.max_seq, self.device = params, cfg, max_seq, device


def without_shexp_gate(torch, eng) -> _Stack:
    """The engine's stack with every layer's shared-expert gate vector left
    out (the same planes): K6's shared expert ungated."""
    from llama_cpp_gfx906_tpu_torch.runtime.weights import ParamDict

    layers = [ParamDict({k: p[k] for k in p.keys() if k != "shexp_gate_inp"})
              for p in eng.params["layers"]]
    params = ParamDict({k: eng.params[k] for k in ("tok_emb", "out_norm", "lm_head")})
    params["layers"] = torch.nn.ModuleList(layers)
    return _Stack(params, eng.cfg, eng.max_seq, eng.device)


def k4_cases(torch, dev, flush, record) -> None:
    """K4 on ``kernel_times.K4_CASES`` (every prefill shape of the model
    phases, each mode: inputs from seed 60 + the case's index,
    ``kernel_times.k4_case``), each against ``flash_attention_plain`` at
    TOL, launched twice (the same bits), timed beside its bound (bf16
    tensor cores, or f32 FMA for the FMA body) and SDPA on the same rows
    without the sinks (an int8 cache dequantized beforehand), under the
    count name of its mode.  The plain version is timed once per count
    name, at its ``SUMMARY_CASE`` (or its first case where the summary
    has none).  Emits the loop's wall time."""
    from llama_cpp_gfx906_tpu_torch.ops.flash_attention import (flash_attention,
                                                              flash_attention_plain)
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    t0, plain_timed = time.perf_counter(), set()
    for i, spec in enumerate(kt.K4_CASES):
        c = kt.k4_case(torch, dev, spec, 60 + i)
        args, kw, name = c["args"], c["kw"], c["name"]
        got = flash_attention(*args, **kw)
        err = check(f"{name} {c['case']}", got, flash_attention_plain(*args, **kw), torch)
        same = bit_identical(f"{name} {c['case']}", got, flash_attention(*args, **kw), torch)
        plain_ms = None
        if name not in plain_timed and SUMMARY_CASE.get(name, c["case"]) in c["case"]:
            plain_timed.add(name)
            plain_ms = device_ms(lambda: flash_attention_plain(*args, **kw), torch, flush)
        record(name, c["case"], err, device_ms(lambda: flash_attention(*args, **kw), torch, flush),
               plain_ms, c["nbytes"], c["flops"], device_ms(c["sdpa"], torch, flush),
               flop_s=BF16_FLOP_S if "mma" in c["mode"] else F32_FLOP_S, bit_identical=same,
               library="SDPA, boolean mask, no sinks" + (", rows dequantized beforehand"
                                                          if "int8" in c["mode"] else ""))
        del c, args, kw, got
        torch.cuda.empty_cache()
    emit(phase="k4_cases", seconds=time.perf_counter() - t0)


def k3_name(mode: str) -> str:
    """The count name a K3 case of ``mode`` reports under: its positions or
    ALiBi mode where it has one (positions first), else its int8 / shared
    mode, else ``flash_decode``."""
    if "pos" in mode:
        return "flash_decode_pos"
    if "alibi" in mode:
        return "flash_decode_alibi"
    return "flash_decode" + (f"_{mode}" if mode else "")


def k3_sdpa(torch, c):
    """One ``scaled_dot_product_attention`` call computing the same function
    as the K3 case ``c`` (without its sinks): rows dequantized to bf16
    beforehand, the shared rows put before each slot's own, and no mask
    where every key is seen, else a boolean mask, or with ALiBi a float
    mask holding the bias where a key is seen and -inf where it is not;
    None with a softcap (SDPA cannot apply it before the bias).  Returns
    (callable or None, its description, the live own rows per slot, the
    shared rows any query sees, the (query token, key) pairs seen)."""
    import torch.nn.functional as F

    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import QuantKV, dequantize_rows

    q, k, v, kw = c["q"], c["k"], c["v"], c["kw"]
    what = ["SDPA"]
    if isinstance(k, QuantKV):
        k, v = dequantize_rows(k, torch.bfloat16), dequantize_rows(v, torch.bfloat16)
        what.append("rows dequantized beforehand")
    B, T, Hq, D = q.shape
    dev = q.device
    n = c["npast"].long()
    L = int(n.max()) + T
    t = torch.arange(T, device=dev)
    rows = torch.arange(L, device=dev)
    S0 = kw["shared_k"].shape[1] if "shared_k" in kw else 0
    if "kv_pos" in kw:
        kpos, qpos = kw["kv_pos"][:, :L].long(), kw["q_pos"].long()
    else:
        kpos = (S0 + rows)[None].expand(B, L)
        qpos = S0 + n[:, None] + t[None]
    if S0:
        kpos = torch.cat([torch.arange(S0, device=dev)[None].expand(B, S0), kpos], 1)
        k = torch.cat([kw["shared_k"].expand(B, -1, -1, -1), k[:, :L]], 1)
        v = torch.cat([kw["shared_v"].expand(B, -1, -1, -1), v[:, :L]], 1)
        live_row = torch.cat([torch.ones(S0, dtype=torch.bool, device=dev),
                              torch.zeros(L, dtype=torch.bool, device=dev)])
        own = torch.cat([torch.zeros(S0, dtype=torch.long, device=dev), rows])
        what.append("shared rows before each slot's own")
    else:
        k, v = k[:, :L], v[:, :L]
        live_row, own = torch.zeros(L, dtype=torch.bool, device=dev), rows
    seen = (kpos[:, None, :] <= qpos[:, :, None]) & (
        live_row[None, None] | (own[None, None, :] < (n[:, None, None] + T)))
    window = kw.get("sliding_window", 0)
    if window:
        seen &= kpos[:, None, :] > qpos[:, :, None] - window
    if "alibi_slopes" in kw:
        dist = (qpos[:, :, None] - kpos[:, None, :]).float()
        bias = -kw["alibi_slopes"].float()[None, :, None, None] * dist[:, None]
        mask = torch.where(seen[:, None], bias, float("-inf")).to(torch.bfloat16)
        what.append("float mask (bias and mask)")
    elif bool(seen.all()):
        mask = None
    else:
        mask = seen[:, None]
        what.append("boolean mask")
    if "sinks" in kw:
        what.append("no sinks")
    qs = q.transpose(1, 2).contiguous()
    ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    seen_rows = seen.any(1)  # (B, keys)
    live = [int(x) for x in seen_rows[:, S0:].sum(1)]
    shared = int(seen_rows[:, :S0].any(0).sum())
    if "logit_softcap" in kw:
        return None, "none: SDPA cannot apply a softcap", live, shared, int(seen.sum())
    return (lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                   scale=c["scale"], enable_gqa=True),
            ", ".join(what), live, shared, int(seen.sum()))


def shared_vs_own_rows(torch, c, flush) -> None:
    """L2 and the shared rows: the shared-mode case ``c`` against the same
    step with the shared rows copied before each slot's own (n_past + S0,
    the same logical positions), held at TOL; both timed."""
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode

    q, kw, scale = c["q"], c["kw"], c["scale"]
    B = q.shape[0]
    S0 = kw["shared_k"].shape[1]
    kd = torch.cat([kw["shared_k"].expand(B, -1, -1, -1), c["k"]], 1)
    vd = torch.cat([kw["shared_v"].expand(B, -1, -1, -1), c["v"]], 1)
    nd = c["npast"] + S0
    err = check(f"flash_decode_shared {c['case']}: shared rows vs the same rows in each slot",
                flash_decode(q, kd, vd, nd, scale),
                flash_decode(q, c["k"], c["v"], c["npast"], scale, **kw), torch)
    emit(phase="kernel", kernel="flash_decode_shared", case=f"{c['case']} rows in each slot",
         max_abs_err_vs_shared=err[0],
         ms_rows_in_each_slot=device_ms(lambda: flash_decode(q, kd, vd, nd, scale),
                                        torch, flush))


def k3_cases(torch, dev, flush, record) -> None:
    """K3 on ``kernel_times.K3_CASES`` (every decode shape of the model
    phases, each mode: inputs from seed 17 + the case's index,
    ``kernel_times.k3_case``), each against ``flash_decode_plain`` at TOL,
    launched twice (the same bits), timed beside its bound and the SDPA
    yardstick (``k3_sdpa``), under its count name (``k3_name``) with its
    split count.  Bytes: each live K and V row once (int8: with its two
    4-byte scales; 4 bytes of logical position a live row), the shared
    rows any query sees once, q in and out; operations: 4·D per query head
    and (query token, key) pair the mask lets through.  The plain version
    is timed once per count name, at its ``SUMMARY_CASE``; a shared case
    without a window is also held against its rows copied into each slot
    (``shared_vs_own_rows``).  Emits the loop's wall time."""
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import (flash_decode, flash_decode_plain,
                                                         split_count)
    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import QuantKV
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    t0, plain_timed = time.perf_counter(), set()
    for i, spec in enumerate(kt.K3_CASES):
        c = kt.k3_case(torch, dev, spec, 17 + i)
        q, k, kw, name = c["q"], c["k"], c["kw"], k3_name(c["mode"])
        args = (q, k, c["v"], c["npast"], c["scale"])
        got = flash_decode(*args, **kw)
        err = check(f"{name} {c['case']}", got, flash_decode_plain(*args, **kw), torch)
        same = bit_identical(f"{name} {c['case']}", got, flash_decode(*args, **kw), torch)
        lib, library, live, shared, pairs = k3_sdpa(torch, c)
        B, T, Hq, D = q.shape
        Hkv = (k.q if isinstance(k, QuantKV) else k).shape[2]
        row = Hkv * (2 * D + 8) if isinstance(k, QuantKV) else Hkv * 2 * D * 2
        row += 4 if "kv_pos" in kw else 0
        nbytes = sum(live) * row + shared * Hkv * 2 * D * 2 + 2 * q.numel() * 2
        plain_ms = None
        if name not in plain_timed and SUMMARY_CASE.get(name, c["case"]) in c["case"]:
            plain_timed.add(name)
            plain_ms = device_ms(lambda: flash_decode_plain(*args, **kw), torch, flush)
        extra = {}
        if shared:  # what the bound would be if every slot read the shared rows
            extra["bound_ms_if_shared_read_per_slot"] = bound(
                nbytes + (B - 1) * shared * Hkv * 2 * D * 2, 0)[0]
        record(name, c["case"], err, device_ms(lambda: flash_decode(*args, **kw), torch, flush),
               plain_ms, nbytes, 4 * Hq * D * pairs,
               None if lib is None else device_ms(lib, torch, flush), mode=c["mode"],
               bit_identical=same, splits=split_count(q, k, kw.get("shared_k")),
               library=library, **extra)
        if c["mode"] == "shared" and not kw.get("sliding_window"):
            shared_vs_own_rows(torch, c, flush)
        del c, args, kw, got
        torch.cuda.empty_cache()
    emit(phase="k3_cases", seconds=time.perf_counter() - t0)


def decode_errors(torch, eng, kern, plain, B: int, n_past: int, toks) -> tuple:
    """A decode kernel against its plain version from one state: x for the
    tokens ``toks`` (B, 1) and caches of random rows (seed 11) filled to
    n_past.  Errors are max |kernel - plain| / max |plain|: of the whole
    stack's output x and its new K/V rows (``x``, ``k_rows``, ``v_rows``),
    of the first two layers as a stack of their own (``first_two_layers``,
    the hand-off between layers), and the worst of each layer run alone, as
    a one-layer stack on the same planes, fed the kernel's own output of
    the layer before (``per_layer``; each sub-stack keeps its layers' SWA
    flags, ``sub_config``); depth amplifies neither of the two last; for an
    MoE stack, the layers where a layer alone chose another set of experts
    than the plain version from the same input (``per_layer_expert_sets_differ``:
    none, unless a router holds an exact tie) and another order of the same
    set (``per_layer_expert_order_differs``: a near-tie between two chosen
    experts, which changes only the order of the sum).  ``one_ulp_spread`` is
    the plain version's own output moved by one bf16 ulp on x's largest
    element: how far depth carries a single rounding; for an MoE stack of at
    most two layers, ``plain_cpu_vs_plain`` is the plain version on the CPU
    from the same state (the same rounding points, other summation orders)
    against the card's.  For an MoE stack (B = 1),
    ``expert_ids_kernel`` and ``expert_ids_plain`` are the experts each
    layer chose, as the kernel wrote them and as the plain version chose
    them: a router near-tie shows as a differing id.  Returns the errors, x
    and the three caches."""
    from llama_cpp_gfx906_tpu_torch.models.config import sub_config
    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, embed
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
    from llama_cpp_gfx906_tpu_torch.runtime.weights import ParamDict

    params, cfg, dev = eng.params, eng.cfg, eng.device
    moe = "moe_gate_inp" in params["layers"][0]
    caches = []
    for _ in range(3):
        kv = KVCache.create(cfg, B, eng.max_seq, torch.bfloat16, dev)
        gg = torch.Generator(device=dev).manual_seed(11)
        kv.k.copy_(torch.randn(kv.k.shape, generator=gg, device=dev))
        kv.v.copy_(torch.randn(kv.v.shape, generator=gg, device=dev))
        kv.n_past.fill_(n_past)
        caches.append(kv)

    def rel(a, b) -> float:
        a, b = a.float(), b.float()
        return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))

    def rows(kv):
        return kv.k[:, :, n_past], kv.v[:, :, n_past]

    def sub_stack(first: int, n: int):
        """Layers [first, first + n) as a stack of their own, with their KV."""
        sub = ParamDict({"layers": torch.nn.ModuleList(list(params["layers"])[first:first + n])})
        kvs = [KVCache(k=c.k[first:first + n], v=c.v[first:first + n], n_past=c.n_past)
               for c in caches[:2]]
        return sub, sub_config(cfg, first, n), kvs

    layer_ids = ([], [])  # each layer alone: the experts K6 and plain chose

    def stack_err(sub, sub_cfg, kvs, xin):
        a = kern(sub, sub_cfg, xin, kvs[0])
        if moe and sub_cfg.n_layers == 1:
            ids = []
            b = k6.decode_layers_plain(sub, sub_cfg, xin, kvs[1], ids_out=ids)
            layer_ids[0].append(k6.last_expert_ids(sub, kvs[0])[0].tolist())
            layer_ids[1].append(ids[0][0].tolist())
        else:
            b = plain(sub, sub_cfg, xin, kvs[1])
        (ka, va), (kb, vb) = rows(kvs[0]), rows(kvs[1])
        return max(rel(a, b), rel(ka, kb), rel(va, vb)), a

    x = embed(params, cfg, toks)
    with torch.inference_mode():
        got = kern(params, cfg, x, caches[0])
        kern_ids = k6.last_expert_ids(params, caches[0]).tolist() if moe else None
        ref = plain(params, cfg, x, caches[1])
        (ka, va), (kb, vb) = rows(caches[0]), rows(caches[1])
        errs = dict(x=rel(got, ref), x_abs=float((got.float() - ref.float()).abs().max()),
                    k_rows=rel(ka, kb), v_rows=rel(va, vb), finite=bool(
                        torch.isfinite(got).all()))
        if moe:  # the plain version again on its cache: the same step, same rows
            ids = []
            k6.decode_layers_plain(params, cfg, x, caches[1], ids_out=ids)
            errs["expert_ids_kernel"] = kern_ids
            errs["expert_ids_plain"] = [i[0].tolist() for i in ids]
        errs["first_two_layers"] = stack_err(*sub_stack(0, min(2, cfg.n_layers)), x)[0]
        worst, xl = 0.0, x
        for li in range(cfg.n_layers):
            err, xl = stack_err(*sub_stack(li, 1), xl)
            worst = max(worst, err)
        errs["per_layer"] = worst
        if moe:  # a layer alone on the same input: the same experts (as a set)
            errs["per_layer_expert_sets_differ"] = [
                (li, a, b) for li, (a, b) in enumerate(zip(*layer_ids)) if sorted(a) != sorted(b)]
            errs["per_layer_expert_order_differs"] = [
                li for li, (a, b) in enumerate(zip(*layer_ids)) if a != b]
        if moe and cfg.n_layers <= 2:  # the plain version in another valid order
            import copy

            cpu = ParamDict({"layers": torch.nn.ModuleList(
                copy.deepcopy(lp).cpu() for lp in params["layers"])})
            kvc = KVCache(k=caches[2].k.cpu(), v=caches[2].v.cpu(),
                          n_past=caches[2].n_past.cpu())
            errs["plain_cpu_vs_plain"] = rel(k6.decode_layers_plain(cpu, cfg, x.cpu(), kvc),
                                             ref.cpu())
            del cpu, kvc
        x1 = x.clone().reshape(-1)
        i = int(x1.float().abs().argmax())  # a nonzero element moves by an ulp
        x1[i] = (x1[i].float() * (1 + 2 ** -7)).to(x.dtype)
        errs["one_ulp_spread"] = rel(plain(params, cfg, x1.reshape(x.shape), caches[2]), ref)
    torch.cuda.synchronize()
    return errs, x, caches


def decode_case(torch, eng, name, kern, plain, B, n_past, g, flush, record,
                whole_stack: bool, **extra) -> None:
    """One decode kernel case: its errors against the plain version (the
    first two layers and each layer alone always held to TOL; the whole
    stack too where ``whole_stack``), its time, the plain version's and
    the per-layer loop's, and the bound."""
    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, layers_forward
    from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6

    params, cfg = eng.params, eng.cfg
    gate = k6._stream_ok if name.startswith("decode_stream") else k7._fused_ok
    if not gate(params, cfg, KVCache.create(cfg, B, eng.max_seq, torch.bfloat16, "meta"),
                B, 1):
        raise AssertionError(f"{name}: the gate refuses B={B}")
    toks = torch.randint(0, cfg.n_vocab, (B, 1), generator=g, device=eng.device)
    errs, x, caches = decode_errors(torch, eng, kern, plain, B, n_past, toks)
    with torch.inference_mode():  # n_past stays: the same step twice
        first = kern(params, cfg, x, caches[0])
        krow = caches[0].k[:, :, n_past].clone()
        same = bit_identical(f"{name} B={B} n_past={n_past}", first,
                             kern(params, cfg, x, caches[0]), torch)
        same = same and bit_identical(f"{name} B={B} n_past={n_past} K rows", krow,
                                      caches[0].k[:, :, n_past], torch)
    case = f"L={cfg.n_layers} B={B} n_past={n_past}" + "".join(
        f" {v} experts" if k == "expert_format" else f" {v}" for k, v in extra.items())
    if not errs["finite"]:
        fail(f"{name} {case}: non-finite kernel output")
    for what in ("first_two_layers", "per_layer") + (
            ("x", "k_rows", "v_rows") if whole_stack else ()):
        if not errs[what] <= TOL:
            fail(f"{name} {case} {what}: max error / max|plain| = {errs[what]} > {TOL}")
    if errs.get("per_layer_expert_sets_differ"):
        fail(f"{name} {case}: a layer alone chose other experts than the plain version: "
             f"{errs['per_layer_expert_sets_differ']}")
    with torch.inference_mode():
        ms = device_ms(lambda: kern(params, cfg, x, caches[0]), torch, flush)
        plain_ms = device_ms(lambda: plain(params, cfg, x, caches[1]), torch, flush)
        loop_ms = device_ms(lambda: layers_forward(params, cfg, x, caches[2]), torch, flush)
    HD = cfg.n_kv_heads * cfg.head_dim
    D = cfg.n_embd
    # the rows each layer attends: its window's, or all n_past + 1
    rows = sum(min(n_past + 1, w) if w else n_past + 1 for w in cfg.layer_windows)
    nbytes, macs = weight_bytes_macs(params, errs.get("expert_ids_kernel"))
    nbytes += (2 * rows * B * HD * 2  # live KV read, new rows written
               + B * D * 4)           # x in and out (bf16)
    flops = 2 * B * macs + 4 * rows * B * cfg.n_heads * cfg.head_dim
    record(name, case, (errs["x_abs"], errs["x"]), ms, plain_ms, nbytes, flops, None,
           flop_s=F32_FLOP_S, per_layer_loop_ms=loop_ms,
           errors={k: v for k, v in errs.items() if k not in ("x_abs", "finite")},
           whole_stack_checked=whole_stack, bit_identical=same, **extra)
    del caches


def weight_bytes_macs(params, expert_ids=None) -> tuple[int, int]:
    """The plane bytes one decode step must read and its weight MACs per
    token: every dense projection and norm; of a layer's stacked experts,
    the slices of the distinct experts it chose (``expert_ids``, per layer)
    and the router."""
    from llama_cpp_gfx906_tpu_torch.ops.quant_matmul import QuantTensor

    nbytes = macs = 0
    for li, p in enumerate(params["layers"]):
        for q in p.children():
            if not isinstance(q, QuantTensor):
                continue
            planes = [t for t in (q.q, q.s, q.m, q.sd, q.md) if t is not None]
            if q.q.ndim == 3:
                one = sum(t[0].numel() * t.element_size() for t in planes)
                nbytes += len(set(expert_ids[li])) * one
                macs += len(expert_ids[li]) * q.K * q.N
            else:
                nbytes += sum(t.numel() * t.element_size() for t in planes)
                macs += q.K * q.N
        nbytes += sum(p[n].numel() * p[n].element_size()
                      for n in ("attn_norm", "ffn_norm", "moe_gate_inp", "q_norm",
                                "k_norm", "post_attn_norm", "post_ffn_norm",
                                "shexp_gate_inp") if n in p)
    return nbytes, macs


def loop_logits(torch, eng, tok: int, layers_fn=None):
    """One decode step through ``layers_fn``, by default the per-layer loop
    (``layers_forward``, the route the JAX package takes off its
    accelerator: K1/K2 GEMVs and K3 attention per layer), called as a
    function, then the head."""
    from llama_cpp_gfx906_tpu_torch.models.llama import embed, head, layers_forward

    p, cfg = eng.params, eng.cfg
    with torch.inference_mode():
        x = embed(p, cfg, torch.tensor([[tok]], device=eng.device))
        x = (layers_fn or layers_forward)(p, cfg, x, eng.kv)
        logits = head(p, cfg, x)
        eng.set_n_past(eng.n_past + 1)
        return logits[0, -1].cpu().numpy()


def launches_since(before: dict) -> dict:
    """Launches that ran since ``before`` (a ``kernels.device_counts()``), as
    the kernels count them on the device: graph replays included, and exact
    where a profiler trace can drop records (it dropped a K7 record in
    some runs)."""
    from llama_cpp_gfx906_tpu_torch import kernels

    return {k: v - before[k] for k, v in kernels.device_counts().items()}


def profile_steps(torch, step, steps: int, tokens_per_step: int = 1) -> dict:
    """Device time of ``steps`` calls of ``step`` by kernel name
    (torch.profiler), against the wall time of the same calls run without
    the profiler, and the launches of the port's kernels in the profiled
    calls (device-side counts, graph replays included); per generated
    token."""
    from torch.profiler import ProfilerActivity, profile

    from llama_cpp_gfx906_tpu_torch import kernels

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    n_tok = steps * tokens_per_step
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_tok
    before = kernels.device_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        # device-side events only (kernels, memsets, copies): the CPU-side
        # aten:: ops also carry the device time of the kernels they launch
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            by_name[ev.key] = by_name.get(ev.key, 0.0) + us / 1e3 / n_tok
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    launches = launches_since(before)
    return dict(tokens=n_tok, wall_ms_per_token=wall_ms, launches=launches,
                launches_per_token={k: n / n_tok for k, n in launches.items()},
                device_ms_per_token=dev_ms if by_name else "not measured",
                device_idle_share=(1 - dev_ms / wall_ms) if by_name else "not measured",
                top_kernels_ms_per_token=[[k[:90], v] for k, v in top])


def prompt_ids(eng, n_words: int = 110) -> list[int]:
    words = " ".join(f"w{i % 97}" for i in range(n_words))
    return eng.tokenizer.tokenize(f"The synthetic model reads: {words}",
                                  add_special=True, parse_special=True)


def compare_routes(torch, eng, ids, tol: float, enforce_loop: bool,
                   steps: int = 8, kernel_tol: float = TOL,
                   ulp_control: bool = False) -> dict:
    """``steps`` decode steps from the same state three ways, each fed the
    fused route's greedy tokens and read through the same head: the fused
    route (``forward``: one K6/K7 launch), the decode kernel's plain version
    (``decode_layers_plain``, the same rounding points) and the per-layer
    loop.  The kernel is held to its plain version (max |diff| / max |plain|
    <= ``kernel_tol``); the fused route to the loop by the JAX kernel tests' check,
    assert_allclose(rtol=tol, atol=tol), where ``enforce_loop``.  For the
    18-layer 270M Q8_0 it is reported, not enforced: the JAX package's own
    K7 sits beyond 2e-2 of its loop there (the fused route's f32 carry and
    bf16-rounded int8 weights against the loop's roundings, amplified by
    depth; tests/test_torch_decode_step.py::
    test_k7_loop_gap_matches_jax_reference holds the port to that gap).
    With ``ulp_control``, the plain version again with its first step's x
    moved by one bf16 ulp on its largest element (``plain_one_ulp_vs_plain``:
    how far the steps carry one rounding)."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.ops.decode_stream import decode_layers_plain

    eng.reset()
    tok = int(np.argmax(eng.prefill(ids)))
    n0 = eng.n_past
    k0, v0 = eng.kv.k.clone(), eng.kv.v.clone()

    def rewind():
        eng.kv.k.copy_(k0)
        eng.kv.v.copy_(v0)
        eng.set_n_past(n0)

    fused, fed = [], []
    for _ in range(steps):
        fed.append(tok)
        fused.append(eng.decode_one(tok))
        tok = int(np.argmax(fused[-1]))
    rewind()
    plain = [loop_logits(torch, eng, t, decode_layers_plain) for t in fed]
    rewind()
    loop = [loop_logits(torch, eng, t) for t in fed]
    nudged = []
    if ulp_control:
        rewind()

        def plain_nudged(p, cfg, x, kv):
            if not nudged:
                x1 = x.clone().reshape(-1)
                i = int(x1.float().abs().argmax())
                x1[i] = (x1[i].float() * (1 + 2 ** -7)).to(x.dtype)
                x = x1.reshape(x.shape)
            return decode_layers_plain(p, cfg, x, kv)

        for t in fed:
            nudged.append(loop_logits(torch, eng, t, plain_nudged))
    del k0, v0

    def stats(xs, ys):
        return dict(
            max_rel=max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(xs, ys)),
            allclose_ratio=max(float((np.abs(a - b) / (tol + tol * np.abs(b))).max())
                               for a, b in zip(xs, ys)),
            greedy_agree=sum(int(np.argmax(a) == np.argmax(b)) for a, b in zip(xs, ys)))

    out = dict(steps=steps, tol=tol, kernel_vs_plain=stats(fused, plain),
               fused_vs_loop=stats(fused, loop), plain_vs_loop=stats(plain, loop))
    if nudged:
        out["plain_one_ulp_vs_plain"] = stats(nudged, plain)
    if not all(np.isfinite(a).all() for a in fused):
        fail("fused route: non-finite logits")
    if not out["kernel_vs_plain"]["max_rel"] <= kernel_tol:
        fail(f"fused route vs its plain version: {out['kernel_vs_plain']}, tol {kernel_tol}")
    if enforce_loop and not out["fused_vs_loop"]["allclose_ratio"] <= 1:
        fail(f"fused route vs per-layer loop: {out['fused_vs_loop']}, tol {tol}")
    return out


def fused_run(torch, eng, ids, kernel: str, chunk: int = 32, chunks: int = 2,
              want: dict | None = None) -> dict:
    """decode_fused after a prefill: tok/s (the first chunk, which captures
    the step, apart), and a profile of two chunks with its launches per
    token, held to ``want`` (by default: the decode kernel and the head's
    K1 once each)."""
    import numpy as np

    eng.reset()
    tok = int(np.argmax(eng.prefill(ids)))
    t0 = time.perf_counter()
    toks = eng.decode_fused(tok, n_steps=chunk)
    capture_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(chunks):
        toks = eng.decode_fused(toks[-1], n_steps=chunk)
    dt = time.perf_counter() - t0
    prof = profile_steps(torch, lambda: eng.decode_fused(tok, n_steps=chunk), 2,
                         tokens_per_step=chunk)
    per_tok = prof["launches_per_token"]  # counted on the device
    want = want or {kernel: 1.0, "gemv_int8": 1.0, "gemv_nib4c": 0.0, "flash_decode": 0.0}
    if any(per_tok[k] != v for k, v in want.items()):
        fail(f"fused decode launches per token {per_tok}, want {want}")
    return dict(first_chunk_with_capture_s=capture_s,
                decode_fused_tok_s=chunk * chunks / dt,
                launches=prof["launches"], launches_per_token=per_tok,
                profile=prof)


def phase_8b(torch, paths: dict, tmp: Path):
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = str(tmp / "synth-8b-q4km.gguf")
    t0 = time.perf_counter()
    write_synth(path, "8b", seed=0)
    t_write = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    eng = Engine.from_gguf(path, max_seq=8192)
    mem_weights = torch.cuda.memory_allocated()
    route = decode_route(eng.params, eng.cfg, eng.kv)
    if route != "k6":
        raise AssertionError(f"8b: decode route {route}, want k6")
    ids = prompt_ids(eng)
    prompt = eng.tokenizer.detokenize(ids)
    kernel_counts(reset=True)
    _, toks = eng.generate(prompt, n_predict=32, stop_on_eog=False)
    torch.cuda.synchronize()
    paths["8b"] = launches = kernel_counts()
    logits = eng.decode_one(toks[-1])
    perf = eng.perf.summary()
    emit(phase="8b", synth_write_s=t_write, prompt_tokens=len(ids),
         new_tokens=len(toks), route=route, **perf,
         prefill_s=eng.perf.t_prefill_s, decode_s=eng.perf.t_decode_s,
         weights_and_cache_bytes=mem_weights,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         launches=launches)
    if len(toks) != 32 or not all(0 <= t < eng.cfg.n_vocab for t in toks):
        raise AssertionError(f"8b: bad generated tokens {toks}")
    if logits.shape != (eng.cfg.n_vocab,) or not bool(
            torch.isfinite(torch.from_numpy(logits)).all()):
        raise AssertionError("8b: logits of the wrong shape or not finite")
    if launches["decode_stream"] != 32 or launches["gemv_nib4c"] or launches["flash_decode"]:
        raise AssertionError(f"8b: decode went elsewhere than K6: {launches}")
    if launches["qmm_int8"]:  # nib4c and folded int8: the dequant matmul, as in JAX
        raise AssertionError(f"8b: prefill went through K5: {launches}")

    # the per-layer loop (PR 1's decode route), called as a function
    eng.reset()
    kernel_counts(reset=True)
    tok = int(eng.prefill(ids).argmax())
    t0 = time.perf_counter()
    for _ in range(16):
        tok = int(loop_logits(torch, eng, tok).argmax())
    loop_tok_s = 16 / (time.perf_counter() - t0)
    torch.cuda.synchronize()
    paths["8b_layer_loop"] = kernel_counts()
    emit(phase="8b_layer_loop", decode_tok_s=loop_tok_s, launches=paths["8b_layer_loop"])
    profile = {
        "k6_decode_one": profile_steps(torch, lambda: eng.decode_one(tok), 4),
        "per_layer_loop": profile_steps(torch, lambda: loop_logits(torch, eng, tok), 4)}
    emit(phase="8b_decode_profile", **profile)
    return eng, ids


def phase_8b_fused(torch, eng, ids, paths: dict) -> None:
    out = fused_run(torch, eng, ids, "decode_stream")
    paths["8b_fused"] = out["launches"]
    cmp = compare_routes(torch, eng, ids, TOL_Q4KM, enforce_loop=True)
    eng.reset()
    eng.prefill(ids)
    t0 = time.perf_counter()
    for i in range(16):
        eng.decode_one(5 + i)
    one_tok_s = 16 / (time.perf_counter() - t0)
    prompt = eng.tokenizer.detokenize(ids)
    t_dec, n_dec = eng.perf.t_decode_s, eng.perf.n_decode
    t0 = time.perf_counter()
    _, toks = eng.generate_fused(prompt, n_predict=65, stop_on_eog=False, chunk=32)
    gen_s = time.perf_counter() - t0
    emit(phase="8b_fused", decode_one_tok_s=one_tok_s,
         generate_fused_s=gen_s, generate_fused_new_tokens=len(toks),
         generate_fused_decode_tok_s=(eng.perf.n_decode - n_dec)
         / (eng.perf.t_decode_s - t_dec),
         **out, layer_loop_comparison=cmp)


def phase_8b_self_extend(torch, eng, paths: dict) -> None:
    """Self-extend on the 8B engine of phase ``8b`` (full width and depth)
    with a fresh cache of 4096 rows: a 3,000-token prompt, then the CLI's
    loop (``tools/cli._generate_self_extend``, ``-gan 4 -gaw 1024``): its
    ladder compresses the prompt's positions, then 64 greedy tokens through
    ``decode_one`` (the per-layer loop: both decode kernels' gates refuse a
    cache with positions, as JAX's do).  Held: the launches per decode token
    (``SE_PER_TOKEN``; the loop's prefill launches measured apart), layer
    0's K rows of the prompt against raw keys roped fresh at their new
    positions (2e-2 of max |fresh|: bf16 roundings of the re-ropes), and 8
    decode steps from one cloned state against the same loop with K3's
    plain version (2e-2 per step, the same greedy tokens)."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route, embed
    from llama_cpp_gfx906_tpu_torch.ops.norms import rms_norm
    from llama_cpp_gfx906_tpu_torch.ops.quant_matmul import linear
    from llama_cpp_gfx906_tpu_torch.ops.rope import apply_rope, inv_freq_for
    from llama_cpp_gfx906_tpu_torch.tools.cli import _generate_self_extend
    from llama_cpp_gfx906_tpu_torch.tools.kernel_times import ladder_positions

    eng.kv, eng.max_seq = None, 4096
    eng.reset()
    torch.cuda.empty_cache()
    cfg, dev = eng.cfg, eng.device
    ids = prompt_ids(eng, 1500)[:SE_PROMPT_TOKENS]
    if len(ids) != SE_PROMPT_TOKENS:
        raise AssertionError(f"8b_self_extend: a prompt of {len(ids)} tokens")
    before = kernels.device_counts()
    t0 = time.perf_counter()
    eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = launches_since(before)
    before = kernels.device_counts()
    t_dec = eng.perf.t_decode_s
    t0 = time.perf_counter()
    # the synthetic head repeats 64 distinct rows: an end-of-generation id
    # wins one step in 64, so the phase decodes past it, as ``generate``'s do
    toks = _generate_self_extend(eng, ids, SE_NEW_TOKENS, GA_N, GA_W, stop_on_eog=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    decode_s = eng.perf.t_decode_s - t_dec
    ran = launches_since(before)
    n = len(toks)
    paths["8b_self_extend"] = {k: ran[k] - prefill_launches.get(k, 0) for k in ran}
    per_token = {k: v / max(n, 1) for k, v in paths["8b_self_extend"].items()}
    if n != SE_NEW_TOKENS or not all(0 <= t < cfg.n_vocab for t in toks):
        raise AssertionError(f"8b_self_extend: generated {toks}")
    if any(per_token.get(k) != v for k, v in SE_PER_TOKEN.items()):
        fail(f"8b_self_extend: launches per decode token {per_token}, want {SE_PER_TOKEN}")
    if decode_route(eng.params, cfg, eng.kv) is not None:
        fail("8b_self_extend: a decode kernel's gate takes a cache with positions")
    pos = eng.kv.pos[0, :SE_PROMPT_TOKENS].long()
    want_pos = ladder_positions(SE_PROMPT_TOKENS, GA_N, GA_W)[0]  # the CPU engine's
    if not np.array_equal(pos.cpu().numpy(), want_pos):
        fail("8b_self_extend: the prompt's positions are not the ladder's on the CPU")
    with torch.inference_mode():
        p0 = eng.params["layers"][0]
        h = rms_norm(embed(eng.params, cfg, torch.tensor([ids], device=dev)),
                     p0["attn_norm"], cfg.rms_eps)
        Dq = cfg.n_heads * cfg.head_dim
        k_raw = linear(h, p0["wqk_fused"])[..., Dq:].reshape(
            1, SE_PROMPT_TOKENS, cfg.n_kv_heads, cfg.head_dim)
        fresh = apply_rope(k_raw, pos[None], inv_freq_for(cfg, dev), cfg.rope_interleaved)
        k_rows_rel = rel_of(torch, eng.kv.k[0, 0, :SE_PROMPT_TOKENS], fresh[0])
    if not k_rows_rel <= TOL:
        fail(f"8b_self_extend: layer 0's K rows vs fresh rope {k_rows_rel} > {TOL}")

    # 8 steps from one cloned state: K3's positions mode against its plain version
    kv = eng.kv
    n0 = eng.n_past
    saved = [t.clone() for t in (kv.k, kv.v, kv.pos, kv.pos_next)]

    def restore():
        eng.set_n_past(n0)
        for t, s in zip((kv.k, kv.v, kv.pos, kv.pos_next), saved):
            t.copy_(s)

    fed, kern = [], []
    tok = toks[-1]
    for _ in range(8):
        fed.append(tok)
        kern.append(eng.decode_one(tok))
        tok = int(np.argmax(kern[-1]))
    restore()
    plain = plain_attention_steps(torch, eng, fed)
    restore()
    del saved
    rel = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(kern, plain)]
    agree = [int(np.argmax(a) == np.argmax(b)) for a, b in zip(kern, plain)]
    if not max(rel) <= TOL or not all(agree):
        fail(f"8b_self_extend: 8 steps vs the plain attention: rel {rel}, greedy {agree}")
    emit(phase="8b_self_extend", prompt_tokens=len(ids), new_tokens=n, ga_n=GA_N, ga_w=GA_W,
         prefill_s=prefill_s, prefill_tok_s=len(ids) / prefill_s, self_extend_wall_s=wall,
         decode_tok_s=n / decode_s, pos_next=int(kv.pos_next[0]), n_past=eng.n_past,
         prefill_launches=prefill_launches, launches_per_token=per_token,
         k_rows_vs_fresh_rope_rel=k_rows_rel, steps_vs_plain_rel=rel,
         steps_greedy_agree=agree)
    eng.reset()


def http(url: str, body: dict | None = None, timeout: float = 900) -> tuple[int, str]:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read().decode()


def metrics_of(base: str) -> dict:
    """/metrics by name (a labelled kernel count as ``kernel_launches_total``
    plus its label)."""
    text = http(base + "/metrics")[1]
    return {ln.split()[0].split(":", 1)[1]: float(ln.split()[1])
            for ln in text.splitlines() if ln and not ln.startswith("#")}


def serve_bodies(rng, vocab: int, lens, n_predict: int) -> list[dict]:
    """Token-id completion requests: the first half greedy, the second at
    temperature 0.8 with a seed; the first of each half streamed."""
    half = len(lens) // 2
    out = []
    for i, n in enumerate(lens):
        body = {"prompt": [int(t) for t in rng.integers(3, vocab, n)],
                "max_tokens": n_predict, "temperature": 0.0 if i < half else 0.8,
                "stream": i in (0, half)}
        if i >= half:
            body["seed"] = 1000 + i
        out.append(body)
    return out


def post_all(base: str, bodies: list[dict]) -> list[dict]:
    """POST every body to /v1/completions at once, one thread each; per
    request its status, completion tokens and the server's timings."""
    results: list[dict] = [{} for _ in bodies]

    def one(i, body):
        try:
            status, text = http(base + "/v1/completions", body)
            if body["stream"]:
                ev = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
                if ev[-1] != "[DONE]":
                    raise AssertionError(f"stream did not end in [DONE]: {ev[-1:]}")
                timings = json.loads(ev[-2])["timings"]
                n = timings["predicted_n"]
            else:
                out = json.loads(text)
                timings = out["choices"][0]["timings"]
                n = out["usage"]["completion_tokens"]
            results[i] = dict(status=status, completion_tokens=n, **timings)
        except Exception as e:  # noqa: BLE001 (reported as this request's failure)
            results[i] = dict(status=getattr(e, "code", None), error=repr(e))

    threads = [threading.Thread(target=one, args=(i, b)) for i, b in enumerate(bodies)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return results


def serve_http_run(torch, path: str, kind: str, rng, vocab: int, tmp: Path,
                   lens=SERVE_PROMPT_LENS, per_step=SERVE_PER_STEP,
                   model: str = "8b", name: str = "8b_serve") -> dict:
    """The server as a user starts it, with 4 slots of 4096 tokens and a
    ``kind`` cache: two warm requests (other prompts, so no prefix cache
    hit flatters the times), then 8 timed requests of ``lens`` prompt
    tokens at once.  The server's /metrics before and after them give the
    run's tokens, times, decode steps, prefill chunks and the kernels'
    device launch counts, held to ``per_step`` per decode step and, per
    prefill chunk, to what its own length launches (``chunk_launches`` of
    ``model``)."""
    import numpy as np

    log_path = tmp / f"server-{name}-{kind}.log"
    cmd = [sys.executable, "-m", f"{PKG}.server", "-m", path, "-np", "4", "-c", "4096",
           "-ctk", kind, "--host", "127.0.0.1", "--port", "0"]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    try:
        base = None
        while base is None:
            if proc.poll() is not None:
                raise RuntimeError(f"server exited with {proc.returncode}: "
                                   f"{log_path.read_text()[-2000:]}")
            if time.perf_counter() - t0 > 600:
                raise RuntimeError("server did not start in 600 s")
            m = re.search(r"listening on (http://[\d.]+:\d+)", log_path.read_text())
            base = m.group(1) if m else time.sleep(0.5)
        start_s = time.perf_counter() - t0
        post_all(base, serve_bodies(rng, vocab, (64, 300), 8))
        before = metrics_of(base)
        bodies = serve_bodies(rng, vocab, lens, 64)
        t0 = time.perf_counter()
        results = post_all(base, bodies)
        wall = time.perf_counter() - t0
        after = metrics_of(base)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    d = {k: after[k] - before[k] for k in after if "_total" in k}
    launches = {m.group(1): int(v) for k, v in d.items()
                if (m := re.fullmatch(r'kernel_launches_total\{kernel="(\w+)"\}', k))}
    steps, chunks = int(d["decode_steps_total"]), int(d["prefill_chunks_total"])
    chunk_ts = [t for n in lens for t in prompt_chunks(n)]
    want = {k: per_step[kind].get(k, 0) * steps for k in {*per_step[kind], *CHUNK_KERNELS}}
    for t in chunk_ts:
        for k, v in chunk_launches(model, kind, t).items():
            want[k] += v
    n_out = sum(r.get("completion_tokens", 0) for r in results)
    ttft = [r["ttft_ms"] for r in results if r.get("ttft_ms") is not None]
    out = dict(
        kind=kind, start_to_listening_s=start_s, requests=len(bodies),
        prompt_tokens=sum(len(b["prompt"]) for b in bodies), completion_tokens=n_out,
        wall_s=wall, served_tok_s=n_out / wall,
        decode_tok_s=(d["tokens_predicted_total"] - d["requests_total"])
        / d["predicted_seconds_total"],
        prefill_tok_s=(d["prompt_tokens_total"] - d["prompt_tokens_cached_total"])
        / d["prompt_seconds_total"],
        ttft_ms_p50=float(np.percentile(ttft, 50)) if ttft else None,
        ttft_ms_p90=float(np.percentile(ttft, 90)) if ttft else None,
        decode_steps=steps, prefill_chunks=chunks,
        decode_step_wall_ms=d["predicted_seconds_total"] * 1e3 / max(steps, 1),
        decode_step_device_ms=d["predicted_device_seconds_total"] * 1e3 / max(steps, 1),
        decode_idle_share=1 - d["predicted_device_seconds_total"]
        / d["predicted_seconds_total"],
        launches=launches, launches_want=want,
        launches_per_step={k: v / max(steps, 1) for k, v in launches.items()},
        per_request=results)
    bad = [r for r in results if r.get("status") != 200]
    if bad:
        fail(f"{name} {kind}: requests failed: {bad}")
    if d["tokens_predicted_total"] != n_out or d["requests_total"] != len(bodies) or \
            d["prompt_tokens_total"] != out["prompt_tokens"]:
        fail(f"{name} {kind}: /metrics {d} does not add up to the responses "
             f"({n_out} tokens, {out['prompt_tokens']} prompt tokens)")
    if not steps or chunks != len(chunk_ts) or any(launches.get(k) != v
                                                   for k, v in want.items()):
        fail(f"{name} {kind}: the server launched {launches} in {steps} decode steps "
             f"and {chunks} prefill chunks (want {len(chunk_ts)}: {chunk_ts}), want {want}")
    return out


def run_requests(eng, prompts, n_predict: int, until_generating: bool = False) -> list:
    """Admit ``prompts`` (greedy) and step until every one has finished and
    release them, or, with ``until_generating``, until every one has its
    first token (with ``n_predict`` 1, no decode step runs: each slot stops
    at its prompt's end); returns the slots."""
    from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import SamplerConfig, SlotState

    slots = [eng.add_request(p, n_predict, SamplerConfig(temp=0.0)) for p in prompts]
    if any(s is None for s in slots):
        raise AssertionError("no free slot")
    while True:
        if until_generating and all(s.state == SlotState.GENERATING for s in slots):
            return slots
        if all(s.stop_reason is not None for s in slots):
            break
        eng.step()
    for s in slots:
        eng.release(s)
    return slots


def kv_clone(kv, i: int):
    """Slot i of a batched cache as a cache of its own (copies)."""
    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache
    from llama_cpp_gfx906_tpu_torch.ops.kv_quant import QuantKV

    def one(x):
        x = x[:, i:i + 1]
        return QuantKV(x.q.clone(), x.s.clone()) if isinstance(x, QuantKV) else x.clone()

    return KVCache(k=one(kv.k), v=one(kv.v), n_past=kv.n_past[i:i + 1].clone(),
                   shared_k=kv.shared_k, shared_v=kv.shared_v)


def first_decode_logits(torch, eng, tokens):
    """The T = 1 forward of every slot at its n_past, fed ``tokens``."""
    from llama_cpp_gfx906_tpu_torch.models.llama import forward

    eng.kv.n_past.copy_(torch.from_numpy(eng.n_past_host))
    with torch.inference_mode():
        logits, _ = forward(eng.params, eng.cfg, tokens, eng.kv, last_only=True)
    return logits[:, 0]


def rel_of(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def loop_forward(params, cfg, tokens, kv, last_only: bool = True):
    """``forward`` through the per-layer loop whatever the decode route."""
    from llama_cpp_gfx906_tpu_torch.models.llama import advance, embed, head, layers_forward

    x = layers_forward(params, cfg, embed(params, cfg, tokens), kv)[:, -1:]
    advance(kv, tokens.shape[1])
    return head(params, cfg, x), kv


def batched_vs_single(torch, eng, prompts, rng, steps: int = 8, single_fn=None) -> dict:
    """4 slots at different n_past: ``steps`` teacher-forced T = 1 forwards
    of the whole batch against each slot alone on a copy of its rows
    (through ``single_fn``, by default ``forward``); ``worst_rel``, the
    worst max |batched - single| / max |single| over slots and steps.  For
    an MoE model it also counts the (slot, step) pairs whose expert ids
    differ between the two in some layer, and the worst error over the
    pairs whose ids agree: a near-tie that two routes' roundings (K6's
    router on the f32 h2, the loop's on the bf16 h) break differently
    changes an expert, and that step with it."""
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route, forward
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
    from llama_cpp_gfx906_tpu_torch.ops import moe

    slots = run_requests(eng, prompts, 1, until_generating=True)  # prefill only
    dev = eng.device
    toks = torch.tensor(rng.integers(3, eng.cfg.n_vocab, (len(slots), steps)), device=dev)
    singles = [kv_clone(eng.kv, s.id) for s in slots]
    for s, kv1 in zip(slots, singles):
        kv1.n_past.fill_(s.n_past)
    ids = torch.tensor([s.id for s in slots], device=dev)
    track = (single_fn is None and "moe_gate_inp" in eng.params["layers"][0]
             and decode_route(eng.params, eng.cfg, singles[0]) == "k6")
    out = dict(worst_rel=0.0)
    if track:
        out.update(worst_rel_same_experts=0.0, pairs=0, pairs_expert_differs=0)
    chosen, route = [], moe.route

    def recording_route(logits, cfg):
        w, i = route(logits, cfg)
        chosen.append(i.sort(-1).values)
        return w, i

    with torch.inference_mode():
        eng.kv.n_past.copy_(torch.from_numpy(eng.n_past_host))
        for j in range(steps):
            col = torch.zeros((eng.n_slots, 1), dtype=torch.long, device=dev)
            col[ids, 0] = toks[:, j]
            chosen.clear()
            moe.route = recording_route
            try:
                batched = forward(eng.params, eng.cfg, col, eng.kv, last_only=True)[0][ids, 0]
            finally:
                moe.route = route
            for r, kv1 in enumerate(singles):
                one = (single_fn or forward)(eng.params, eng.cfg, toks[r:r + 1, j:j + 1],
                                             kv1, last_only=True)[0][0, 0]
                err = rel_of(torch, batched[r], one)
                out["worst_rel"] = max(out["worst_rel"], err)
                if track:
                    k6_ids = k6.last_expert_ids(eng.params, kv1).sort(-1).values
                    same = all(bool((k6_ids[li] == c[ids[r]]).all())
                               for li, c in enumerate(chosen))
                    out["pairs"] += 1
                    out["pairs_expert_differs"] += not same
                    if same:
                        out["worst_rel_same_experts"] = max(out["worst_rel_same_experts"], err)
    for s in slots:
        s.stop_reason = "length"
        eng.release(s)
        s.cache_tokens = []  # rows past the prompt were teacher-forced
    return out


def phase_8b_serve(torch, paths: dict, tmp: Path) -> None:
    import numpy as np

    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine
    from llama_cpp_gfx906_tpu_torch.runtime.engine import load_model
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = tmp / "synth-8b-q4km.gguf"
    if not path.exists():
        write_synth(str(path), "8b", seed=0)
    V = 128256
    rng = np.random.default_rng(3)
    for kind in ("q8", "bf16"):
        out = serve_http_run(torch, str(path), kind, rng, V, tmp)
        paths[f"8b_serve_http_{kind}"] = out["launches"]
        emit(phase="8b_serve_http", **out)

    dev = torch.device("cuda")
    cfg, params, tok = load_model(str(path), torch.bfloat16, dev)

    def prompts(lens):
        return [[int(t) for t in rng.integers(3, V, n)] for n in lens]

    # the shared-segment hold: one system prompt, 4 tails, teacher tokens
    system, tails = prompts((SYSTEM_LEN,))[0], prompts((256, 300, 400, 500))
    teach = rng.integers(3, V, len(tails))
    unshared_bf16 = None
    for kind in ("bf16", "q8"):  # bf16 first: its unshared logits are q8's reference
        kv_dtype = "q8" if kind == "q8" else torch.bfloat16
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def engine():
            eng = BatchedEngine(cfg, params, tok, n_slots=4, max_seq=4096,
                                kv_cache_dtype=kv_dtype, device=dev)
            eng.warmup()
            return eng

        def hold_logits(eng):
            """Prefill system + tails (the system rows shared or not), then the
            teacher tokens' first-decode logits, row i for tail i."""
            slots = run_requests(eng, [system + t for t in tails], 1, until_generating=True)
            toks = torch.zeros((eng.n_slots, 1), dtype=torch.long, device=dev)
            for s, t in zip(slots, teach):
                toks[s.id, 0] = int(t)
            logits = first_decode_logits(torch, eng, toks)[[s.id for s in slots]]
            for s in slots:
                eng.release(s)
            return logits

        eng = engine()
        out = dict(kind=kind, kv_bytes=eng.kv.nbytes)
        if eng._step.graph is None:
            fail(f"8b_serve {kind}: the decode step was not captured")
        # a 4-slot decode stretch: launches per step, device idle share
        slots = run_requests(eng, prompts((700, 800, 900, 1000)), 64, until_generating=True)
        stretch = profile_steps(torch, eng.step, 16)
        for s in slots:
            while s.stop_reason is None:
                eng.step()
            eng.release(s)
        per_step = stretch["launches_per_token"]
        if any(per_step.get(k) != v for k, v in SERVE_PER_STEP[kind].items()):
            fail(f"8b_serve {kind}: launches per decode step {per_step}, "
                 f"want {SERVE_PER_STEP[kind]}")
        out["decode_stretch"] = stretch
        out["batched_vs_single_rel"] = worst = batched_vs_single(
            torch, eng, prompts((256, 700, 1500, 3000)), rng)["worst_rel"]
        if not worst <= TOL:
            fail(f"8b_serve {kind}: batched vs single-slot logits {worst} > {TOL}")
        # a 512-token system prompt stored once: first-decode logits against
        # the same prompts unshared, then the shared path counted.  With a
        # q8 cache the two differ by more than the shared mode (unshared,
        # the system rows are int8 too): that gap is reported, and the
        # shared q8 logits are held to TOL of the bf16 unshared ones.
        eng.set_system_prompt(system)
        shared_logits = hold_logits(eng)
        plain = BatchedEngine(cfg, params, tok, n_slots=4, max_seq=4096,
                              kv_cache_dtype=kv_dtype, device=dev)
        unshared_logits = hold_logits(plain)
        del plain

        def rel_rows(a, b):
            return max(rel_of(torch, a[i], b[i]) for i in range(len(tails)))

        out["shared_vs_unshared_rel"] = worst = rel_rows(shared_logits, unshared_logits)
        if kind == "bf16":
            unshared_bf16 = unshared_logits
            if not worst <= TOL:
                fail(f"8b_serve bf16: shared vs unshared first-decode logits {worst} > {TOL}")
        else:
            gap = out["unshared_q8_vs_unshared_bf16_rel"] = rel_rows(unshared_logits,
                                                                     unshared_bf16)
            got = out["shared_q8_vs_unshared_bf16_rel"] = rel_rows(shared_logits,
                                                                   unshared_bf16)
            if not got <= TOL:
                fail(f"8b_serve q8: shared first-decode logits {got} > {TOL} from the "
                     f"bf16 unshared ones (the all-int8 cache: {gap})")
        eng.set_system_prompt(system)  # drops the rows the hold left in the slots
        kernel_counts(reset=True)
        before = kernels.device_counts()
        run_requests(eng, [system + t for t in prompts((256, 300, 400, 500))], 64)
        torch.cuda.synchronize()
        paths[f"8b_serve_{kind}_shared"] = launches_since(before)
        out.update(shared_launches=paths[f"8b_serve_{kind}_shared"],
                   shared_wrapper_counts=kernel_counts(),
                   shared_rows_bytes=eng.kv.shared_k.nbytes * 2,
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        mode = "flash_decode_int8_shared" if kind == "q8" else "flash_decode_shared"
        if not paths[f"8b_serve_{kind}_shared"][mode]:
            fail(f"8b_serve {kind}: the shared path never launched {mode}")
        emit(phase="8b_serve_engine", **out)
        del eng
    del params


def phase_270m(torch, paths: dict, tmp: Path) -> None:
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = str(tmp / "synth-270m-q8_0.gguf")
    t0 = time.perf_counter()
    write_synth(path, "270m-q8_0", seed=0)
    t_write = time.perf_counter() - t0
    eng = Engine.from_gguf(path, max_seq=4096)
    route = decode_route(eng.params, eng.cfg, eng.kv)
    if route != "k7":
        raise AssertionError(f"270m_q8_0: decode route {route}, want k7")
    ids = prompt_ids(eng)
    kernel_counts(reset=True)
    _, toks = eng.generate(eng.tokenizer.detokenize(ids), n_predict=32, stop_on_eog=False)
    torch.cuda.synchronize()
    paths["270m_q8_0"] = launches = kernel_counts()
    if launches["decode_step"] != 32 or launches["gemv_nib4c"] or launches["flash_decode"]:
        raise AssertionError(f"270m_q8_0: decode went elsewhere than K7: {launches}")
    if launches["qmm_int8"] != 4 * eng.cfg.n_layers:  # one prefill, 4 projections
        raise AssertionError(f"270m_q8_0: prefill went elsewhere than K5: {launches}")
    perf = eng.perf.summary()
    out = fused_run(torch, eng, ids, "decode_step")
    cmp = compare_routes(torch, eng, ids, TOL, enforce_loop=False)
    emit(phase="270m_q8_0", synth_write_s=t_write, prompt_tokens=len(ids),
         route=route, generate_launches=launches, **perf, **out,
         layer_loop_comparison=cmp)
    del eng
    torch.cuda.empty_cache()


def head_time(torch, eng) -> dict:
    """The tied head's device time: one row through the dense bf16 (D, V)
    product (``linear``, a PyTorch matmul outside the port's kernels, as
    the JAX forward computes it), against its byte bound."""
    from llama_cpp_gfx906_tpu_torch.ops.quant_matmul import linear

    head = eng.params["lm_head"]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=eng.device)
    x = torch.randn((1, 1, eng.cfg.n_embd), device=eng.device).to(head.dtype)
    with torch.inference_mode():
        ms = device_ms(lambda: linear(x, head), torch, flush)
    nbytes = head.numel() * head.element_size() + eng.cfg.n_vocab * 4
    return dict(head_ms=ms, head_bound_ms=bound(nbytes, 2 * head.numel())[0],
                head_bytes=nbytes)


def gemma_fused_want(kernel: str) -> dict:
    """Launches per fused gemma token: the decode kernel, in its gemma mode,
    once; no head GEMV (the tied head is dense) and no loop kernel."""
    return {kernel: 1.0, f"{kernel}_gemma": 1.0, "gemv_int8": 0.0, "gemv_nib4c": 0.0,
            "flash_decode": 0.0}


def phase_gemma3_4b(torch, paths: dict, tmp: Path):
    """Gemma-3-4B Q4_K_M at full width and depth: synth write, load, a
    1,500-token prefill (K4 with per-layer windows, K5 on attn_v), a greedy
    ``generate`` (decode through K6's gemma mode), ``decode_fused`` with
    its idle share and launches per token, the tied head's device time,
    and the fused route against the per-layer loop over 8 steps (its
    kernel held to the plain version, its gap from the loop reported)."""
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = tmp / "synth-gemma3-4b-q4km.gguf"
    t0 = time.perf_counter()
    write_synth(str(path), "gemma3-4b-q4_k_m", seed=0)
    t_write = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine.from_gguf(str(path), max_seq=8192)
    t_load = time.perf_counter() - t0
    mem_weights = torch.cuda.memory_allocated()
    route = decode_route(eng.params, eng.cfg, eng.kv)
    if route != "k6":
        raise AssertionError(f"gemma3_4b: decode route {route}, want k6")
    ids = prompt_ids(eng, 300)[:GEMMA_PROMPT_TOKENS]
    eng.reset()
    kernel_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    paths["gemma3_4b_prefill"] = prefill_launches = kernel_counts()
    if prefill_launches["flash_attention"] != G4B or prefill_launches["qmm_int8"] != G4B:
        raise AssertionError(f"gemma3_4b: prefill launches {prefill_launches}")
    prompt = eng.tokenizer.detokenize(ids)
    kernel_counts(reset=True)
    _, toks = eng.generate(prompt, n_predict=32, stop_on_eog=False)
    torch.cuda.synchronize()
    paths["gemma3_4b"] = launches = kernel_counts()
    logits = eng.decode_one(toks[-1])
    perf = eng.perf.summary()
    if len(toks) != 32 or not all(0 <= t < eng.cfg.n_vocab for t in toks):
        raise AssertionError(f"gemma3_4b: bad generated tokens {toks}")
    if logits.shape != (eng.cfg.n_vocab,) or not bool(
            torch.isfinite(torch.from_numpy(logits)).all()):
        raise AssertionError("gemma3_4b: logits of the wrong shape or not finite")
    if (launches["decode_stream"], launches["decode_stream_gemma"]) != (32, 32) or \
            launches["gemv_nib4c"] or launches["flash_decode"] or launches["gemv_int8"]:
        raise AssertionError(f"gemma3_4b: decode went elsewhere than K6's gemma mode: "
                             f"{launches}")
    head = head_time(torch, eng)
    out = fused_run(torch, eng, ids, "decode_stream", want=gemma_fused_want("decode_stream"))
    # K6 at full depth against its plain version from one state: the first
    # two layers and each layer alone held to TOL (depth-free); the whole
    # 34-layer stack reported beside the plain version's own one-ulp spread
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6

    toks = torch.tensor([[7]], device=eng.device)
    full, _, caches = decode_errors(torch, eng, k6.fused_decode_step_streamed,
                                    k6.decode_layers_plain, 1, 3000, toks)
    del caches
    torch.cuda.empty_cache()
    for what in ("first_two_layers", "per_layer"):
        if not full[what] <= TOL:
            fail(f"gemma3_4b: K6 at full depth, {what} {full[what]} > {TOL}")
    # Over 8 steps through all 34 layers the kernel against its plain
    # version (the sums now in a fixed order: the same reading every run).
    # The fused route against the loop is reported: at 34 layers the JAX
    # package's own K6 sits beyond the Q4_K_M check from its scan
    # (tests/test_torch_gemma3.py::test_gemma_loop_gap_matches_jax_reference
    # holds the port to that gap)
    cmp = compare_routes(torch, eng, ids, TOL_Q4KM, enforce_loop=False)
    emit(phase="gemma3_4b", synth_write_s=t_write, gguf_bytes=path.stat().st_size,
         load_s=t_load, prompt_tokens=len(ids), prefill_s=prefill_s,
         prefill_tok_s=len(ids) / prefill_s, prefill_launches=prefill_launches,
         new_tokens=len(toks), route=route, generate_perf=perf, generate_launches=launches,
         weights_and_cache_bytes=mem_weights,
         max_memory_allocated=torch.cuda.max_memory_allocated(), **head, **out,
         full_depth_vs_plain={k: v for k, v in full.items() if k != "finite"},
         layer_loop_comparison=cmp)
    return eng


def phase_gemma3_4b_serve(torch, paths: dict, tmp: Path, eng) -> None:
    """The server on Gemma-3-4B Q4_K_M at 4 slots x 4096, bf16 then q8
    cache (``serve_http_run``), then ``BatchedEngine`` on the single-stream
    engine's weights: 4 slots at n_past 256-3000 (past the window) held
    against each slot alone, with either cache."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine

    path = tmp / "synth-gemma3-4b-q4km.gguf"
    V = eng.cfg.n_vocab
    rng = np.random.default_rng(5)
    for kind in ("bf16", "q8"):
        out = serve_http_run(torch, str(path), kind, rng, V - 2, tmp, lens=GEMMA_SERVE_LENS,
                             per_step=GEMMA_PER_STEP, model="gemma3_4b",
                             name="gemma3_4b_serve")
        paths[f"gemma3_4b_serve_http_{kind}"] = out["launches"]
        emit(phase="gemma3_4b_serve_http", **out)
    for kind in ("bf16", "q8"):
        torch.cuda.empty_cache()
        be = BatchedEngine(eng.cfg, eng.params, eng.tokenizer, n_slots=4, max_seq=4096,
                           kv_cache_dtype="q8" if kind == "q8" else torch.bfloat16,
                           device=eng.device)
        be.warmup()
        if be._step.graph is None:
            fail(f"gemma3_4b_serve {kind}: the decode step was not captured")
        lens = (256, 700, 1500, 3000)
        held = batched_vs_single(torch, be, [[int(t) for t in rng.integers(3, V - 2, n)]
                                             for n in lens], rng)
        emit(phase="gemma3_4b_serve_engine", kind=kind, kv_bytes=be.kv.nbytes,
             n_past=lens, batched_vs_single=held)
        # 8 steps through 34 layers, the sums in a fixed order: one reading
        # per build; a slot's wrong row or position moves it by O(1)
        if not held["worst_rel"] <= TOL:
            fail(f"gemma3_4b_serve {kind}: batched vs single-slot logits "
                 f"{held['worst_rel']} > {TOL}")
        del be


def phase_gemma3_270m(torch, paths: dict, tmp: Path) -> None:
    """Gemma-3-270M Q8_0 at full depth: decode through K7's gemma mode,
    prefill through K5, ``decode_fused`` and the fused route against the
    loop (reported: the Q8_0 route gap, as for the llama 270M shape)."""
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = str(tmp / "synth-gemma3-270m-q8_0.gguf")
    t0 = time.perf_counter()
    write_synth(path, "gemma3-270m-q8_0", seed=0)
    t_write = time.perf_counter() - t0
    eng = Engine.from_gguf(path, max_seq=4096)
    route = decode_route(eng.params, eng.cfg, eng.kv)
    if route != "k7":
        raise AssertionError(f"gemma3_270m_q8_0: decode route {route}, want k7")
    ids = prompt_ids(eng)
    kernel_counts(reset=True)
    _, toks = eng.generate(eng.tokenizer.detokenize(ids), n_predict=32, stop_on_eog=False)
    torch.cuda.synchronize()
    paths["gemma3_270m_q8_0"] = launches = kernel_counts()
    if (launches["decode_step"], launches["decode_step_gemma"]) != (32, 32) or \
            launches["gemv_int8"] or launches["flash_decode"]:
        raise AssertionError(f"gemma3_270m_q8_0: decode went elsewhere than K7's gemma "
                             f"mode: {launches}")
    if launches["qmm_int8"] != 4 * eng.cfg.n_layers:  # one prefill, 4 projections
        raise AssertionError(f"gemma3_270m_q8_0: prefill went elsewhere than K5: {launches}")
    perf = eng.perf.summary()
    head = head_time(torch, eng)
    out = fused_run(torch, eng, ids, "decode_step", want=gemma_fused_want("decode_step"))
    cmp = compare_routes(torch, eng, ids, TOL, enforce_loop=False)
    emit(phase="gemma3_270m_q8_0", synth_write_s=t_write, prompt_tokens=len(ids),
         route=route, generate_launches=launches, **perf, **head, **out,
         layer_loop_comparison=cmp)
    del eng
    torch.cuda.empty_cache()


def phase_mixtral_q4km(torch, paths: dict, tmp: Path) -> None:
    """Mixtral-8x7B Q4_K_M at full width, ``MIXTRAL_Q4_LAYERS`` of 32 layers
    (nib4c experts; the cut keeps K6's MoE launch per token and the fused
    route against the loop, and writes 3.3 GB instead of 26.5): load, a
    greedy ``generate`` (the 676-token prefill through the dense
    all-experts path, decode through K6's MoE branch), ``decode_fused``
    with its launches per token, and the fused route held against the
    per-layer loop (routed: the quantized nib4c gather)."""
    import os

    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.ops.decode_stream import last_expert_ids
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = tmp / "synth-mixtral-q4km.gguf"
    t0 = time.perf_counter()
    write_synth(str(path), "mixtral-q4_k_m", seed=0, n_layers=MIXTRAL_Q4_LAYERS)
    t_write = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    eng = Engine.from_gguf(str(path), max_seq=8192)
    mem_weights = torch.cuda.memory_allocated()
    route = decode_route(eng.params, eng.cfg, eng.kv)
    if route != "k6":
        raise AssertionError(f"mixtral_q4km: decode route {route}, want k6")
    ids = prompt_ids(eng)
    kernel_counts(reset=True)
    _, toks = eng.generate(eng.tokenizer.detokenize(ids), n_predict=32, stop_on_eog=False)
    torch.cuda.synchronize()
    paths["mixtral_q4km"] = launches = kernel_counts()
    perf = eng.perf.summary()
    chosen = last_expert_ids(eng.params, eng.kv).tolist()
    head = eng.params["lm_head"]
    nbytes, macs = weight_bytes_macs(eng.params, chosen)
    nbytes += sum(t.numel() * t.element_size() for t in (head.q, head.s, head.m, head.sd, head.md)
                  if t is not None)
    if len(toks) != 32 or not all(0 <= t < eng.cfg.n_vocab for t in toks):
        raise AssertionError(f"mixtral_q4km: bad generated tokens {toks}")
    if (launches["decode_stream_moe"] != 32 or launches["decode_stream"] != 32
            or launches["gemv_nib4c"] or launches["flash_decode"] or launches["rqmm_int8"]):
        raise AssertionError(f"mixtral_q4km: decode went elsewhere than K6's MoE branch: "
                             f"{launches}")
    fused = fused_run(torch, eng, ids, "decode_stream_moe")
    cmp = compare_routes(torch, eng, ids, TOL_Q4KM, enforce_loop=True)
    emit(phase="mixtral_q4km", layers=eng.cfg.n_layers, synth_write_s=t_write,
         gguf_bytes=os.path.getsize(path),
         prompt_tokens=len(ids), new_tokens=len(toks), route=route, **perf,
         weights_and_cache_bytes=mem_weights,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         active_weight_bytes_per_token=nbytes, weight_macs_per_token=macs,
         bound_ms_per_token=bound(nbytes, 2 * macs)[0], expert_ids_last_step=chosen,
         generate_launches=launches, **fused, layer_loop_comparison=cmp)
    del eng
    path.unlink()
    torch.cuda.empty_cache()


def phase_mixtral_q8_0(torch, paths: dict, tmp: Path) -> None:
    """Mixtral-8x7B Q8_0 at full width, cut to ``MIXTRAL_Q8_LAYERS`` layers
    (int8 experts): one stream (prefill: K5 for every projection and
    expert; decode: K6's MoE branch), then ``BatchedEngine`` at 4 slots x
    4096 with a bf16 cache: 4 requests of 256-1024 prompt tokens and 32 new
    tokens each, their launches held to ``MIXTRAL_PER_STEP`` per decode step
    (K8 in the captured batched step) and ``MIXTRAL_PER_CHUNK`` per prefill
    chunk, and the batched forward held against single-slot ones."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = tmp / "synth-mixtral-q8_0.gguf"
    t0 = time.perf_counter()
    write_synth(str(path), "mixtral-q8_0", seed=0, n_layers=MIXTRAL_Q8_LAYERS)
    t_write = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    eng = Engine.from_gguf(str(path), max_seq=4096)
    L = eng.cfg.n_layers
    route = decode_route(eng.params, eng.cfg, eng.kv)
    if route != "k6":
        raise AssertionError(f"mixtral_q8_0: decode route {route}, want k6")
    ids = prompt_ids(eng)
    kernel_counts(reset=True)
    _, toks = eng.generate(eng.tokenizer.detokenize(ids), n_predict=32, stop_on_eog=False)
    torch.cuda.synchronize()
    paths["mixtral_q8_0"] = launches = kernel_counts()
    single = dict(eng.perf.summary(), launches=launches)
    if launches["decode_stream_moe"] != 32 or launches["rqmm_int8"]:
        raise AssertionError(f"mixtral_q8_0: decode went elsewhere than K6: {launches}")
    if launches["qmm_int8"] != MIXTRAL_PER_CHUNK["qmm_int8"]:  # one prefill
        raise AssertionError(f"mixtral_q8_0: prefill went elsewhere than K5: {launches}")
    cfg, params, tok, dev = eng.cfg, eng.params, eng.tokenizer, eng.device
    del eng

    rng = np.random.default_rng(4)

    def prompts(lens):
        return [[int(t) for t in rng.integers(3, cfg.n_vocab, n)] for n in lens]

    be = BatchedEngine(cfg, params, tok, n_slots=4, max_seq=4096,
                       kv_cache_dtype=torch.bfloat16, device=dev)
    be.warmup()
    run_requests(be, prompts((20, 40, 60, 80)), 4)  # captures the decode step
    if be._step.graph is None:
        fail("mixtral_q8_0: the batched decode step was not captured")
    m0 = dict(be.metrics)
    before = kernels.device_counts()
    t0 = time.perf_counter()
    run_requests(be, prompts((256, 512, 768, 1024)), 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["mixtral_q8_0_serve"] = served = launches_since(before)
    steps = be.metrics["n_decode_steps"] - m0["n_decode_steps"]
    chunks = be.metrics["n_prefill_chunks"] - m0["n_prefill_chunks"]
    want = {k: MIXTRAL_PER_STEP.get(k, 0) * steps + MIXTRAL_PER_CHUNK.get(k, 0) * chunks
            for k in {*MIXTRAL_PER_STEP, *MIXTRAL_PER_CHUNK}}
    if any(served.get(k) != v for k, v in want.items()):
        fail(f"mixtral_q8_0: the batched engine launched {served} in {steps} decode steps "
             f"and {chunks} prefill chunks, want {want}")
    n_out = be.metrics["n_generated_tokens"] - m0["n_generated_tokens"]
    if n_out != 4 * 32:
        fail(f"mixtral_q8_0: {n_out} tokens served, want 128")
    # each slot alone through the same route (the per-layer loop: K8 at 2
    # pairs) is held; through its own route (K6 at B = 1: the router on the
    # f32 h2, Q8_0 weights rounded to bf16 in the kernel) it is reported
    worst = batched_vs_single(torch, be, prompts((256, 700, 1500, 3000)), rng,
                              single_fn=loop_forward)["worst_rel"]
    if not worst <= TOL:
        fail(f"mixtral_q8_0: batched vs single-slot logits {worst} > {TOL}")
    k6_routes = batched_vs_single(torch, be, prompts((256, 700, 1500, 3000)), rng)
    emit(phase="mixtral_q8_0", layers=L, synth_write_s=t_write, single_stream=single,
         served_tokens=n_out, served_wall_s=wall, served_tok_s=n_out / wall,
         decode_steps=steps, prefill_chunks=chunks,
         decode_step_wall_ms=(be.metrics["t_decode_s"] - m0["t_decode_s"]) * 1e3 / max(steps, 1),
         decode_step_device_ms=(be.metrics["t_decode_device_s"] - m0["t_decode_device_s"])
         * 1e3 / max(steps, 1),
         launches=served, launches_want=want, batched_vs_single_rel=worst,
         batched_vs_single_k6=k6_routes,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del be, params
    path.unlink()
    torch.cuda.empty_cache()

def single_stream(torch, name: str, eng, n_prompt: int, kernel: str, mode: str,
                  paths: dict) -> tuple:
    """A ragged prefill, then a greedy ``generate`` of 32 tokens through the
    decode kernel's ``mode``, one launch per token; the phase's launches."""
    ids = prompt_ids(eng, 300)[:n_prompt]
    eng.reset()
    kernel_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    paths[f"{name}_prefill"] = prefill_launches = kernel_counts()
    kernel_counts(reset=True)
    _, toks = eng.generate(eng.tokenizer.detokenize(ids), n_predict=32, stop_on_eog=False)
    torch.cuda.synchronize()
    paths[name] = launches = kernel_counts()
    logits = eng.decode_one(toks[-1])
    if len(toks) != 32 or not all(0 <= t < eng.cfg.n_vocab for t in toks):
        raise AssertionError(f"{name}: bad generated tokens {toks}")
    if logits.shape != (eng.cfg.n_vocab,) or not bool(
            torch.isfinite(torch.from_numpy(logits)).all()):
        raise AssertionError(f"{name}: logits of the wrong shape or not finite")
    if (launches[kernel], launches[mode]) != (32, 32) or launches["gemv_nib4c"] \
            or launches["flash_decode"] or launches["rqmm_int8"]:
        raise AssertionError(f"{name}: decode went elsewhere than {mode}: {launches}")
    return ids, dict(prompt_tokens=len(ids), prefill_s=prefill_s,
                     prefill_tok_s=len(ids) / prefill_s, prefill_launches=prefill_launches,
                     generate_perf=eng.perf.summary(), generate_launches=launches)


def phase_qwen3_8b(torch, paths: dict, tmp: Path):
    """Qwen3-8B Q4_K_M at full width and depth: synth write, load, a ragged
    1,499-token prefill (K4; the folded projections take the dequant
    matmul), ``generate`` and ``decode_fused`` through K6's qk-norm mode
    (its gemma instantiation with no post-norms: one launch per token, and
    the Q6_K head's K1), K6 against its plain version at full depth from one
    state (the first two layers and each layer alone held to TOL), and 8
    steps of the fused route against its plain version (TOL) and the
    per-layer loop (TOL_Q4KM)."""
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = tmp / "synth-qwen3-8b-q4km.gguf"
    t0 = time.perf_counter()
    write_synth(str(path), "qwen3-8b-q4_k_m", seed=0)
    t_write = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine.from_gguf(str(path), max_seq=8192)
    t_load = time.perf_counter() - t0
    mem_weights = torch.cuda.memory_allocated()
    cfg = eng.cfg
    if not (cfg.qk_norm and not cfg.post_attn_norm and cfg.act_fn == "silu"):
        raise AssertionError(f"qwen3_8b: not qwen3's modes: {cfg}")
    route = decode_route(eng.params, cfg, eng.kv)
    if route != "k6":
        raise AssertionError(f"qwen3_8b: decode route {route}, want k6")
    ids, single = single_stream(torch, "qwen3_8b", eng, QWEN3_PROMPT_TOKENS, "decode_stream",
                                "decode_stream_gemma", paths)
    if single["prefill_launches"]["flash_attention"] != QWEN3_L:
        raise AssertionError(f"qwen3_8b: prefill launches {single['prefill_launches']}")
    out = fused_run(torch, eng, ids, "decode_stream",
                    want={"decode_stream": 1.0, "decode_stream_gemma": 1.0, "gemv_int8": 1.0,
                          "gemv_nib4c": 0.0, "flash_decode": 0.0})
    full, _, caches = decode_errors(torch, eng, k6.fused_decode_step_streamed,
                                    k6.decode_layers_plain, 1, 3000,
                                    torch.tensor([[7]], device=eng.device))
    del caches
    torch.cuda.empty_cache()
    for what in ("first_two_layers", "per_layer"):
        if not full[what] <= TOL:
            fail(f"qwen3_8b: K6 at full depth, {what} {full[what]} > {TOL}")
    cmp = compare_routes(torch, eng, ids, TOL_Q4KM, enforce_loop=True)
    nbytes, macs = weight_bytes_macs(eng.params)
    emit(phase="qwen3_8b", synth_write_s=t_write, gguf_bytes=path.stat().st_size,
         load_s=t_load, route=route, **single, weights_and_cache_bytes=mem_weights,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         layer_weight_bytes=nbytes / cfg.n_layers,
         k6_bound_ms_per_token=bound(nbytes, 2 * macs)[0], **out,
         full_depth_vs_plain={k: v for k, v in full.items() if k != "finite"},
         layer_loop_comparison=cmp)
    return eng


def phase_qwen3_8b_serve(torch, paths: dict, tmp: Path, eng) -> None:
    """The server on Qwen3-8B Q4_K_M at 4 slots x 4096, bf16 (K6's qk-norm
    mode at B 4) then q8 (the loop), 8 ragged requests, launches per step
    and per chunk (each chunk's own T) from /metrics; then
    ``BatchedEngine`` on the single-stream engine's weights, 4 slots at
    n_past 256-3000, held against each slot alone with either cache."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine

    path = tmp / "synth-qwen3-8b-q4km.gguf"
    V = eng.cfg.n_vocab
    rng = np.random.default_rng(6)
    for kind in ("bf16", "q8"):
        out = serve_http_run(torch, str(path), kind, rng, V, tmp, lens=QWEN3_SERVE_LENS,
                             per_step=QWEN3_PER_STEP, model="qwen3_8b",
                             name="qwen3_8b_serve")
        paths[f"qwen3_8b_serve_http_{kind}"] = out["launches"]
        emit(phase="qwen3_8b_serve_http", **out)
    for kind in ("bf16", "q8"):
        torch.cuda.empty_cache()
        be = BatchedEngine(eng.cfg, eng.params, eng.tokenizer, n_slots=4, max_seq=4096,
                           kv_cache_dtype="q8" if kind == "q8" else torch.bfloat16,
                           device=eng.device)
        be.warmup()
        if be._step.graph is None:
            fail(f"qwen3_8b_serve {kind}: the decode step was not captured")
        lens = (256, 700, 1500, 3000)
        held = batched_vs_single(torch, be, [[int(t) for t in rng.integers(3, V, n)]
                                             for n in lens], rng)
        emit(phase="qwen3_8b_serve_engine", kind=kind, kv_bytes=be.kv.nbytes, n_past=lens,
             batched_vs_single=held)
        if not held["worst_rel"] <= TOL:
            fail(f"qwen3_8b_serve {kind}: batched vs single-slot logits "
                 f"{held['worst_rel']} > {TOL}")
        del be


def phase_qwen3moe(torch, paths: dict, tmp: Path) -> None:
    """Qwen3-30B-A3B Q4_K_M at full width (``QWEN3MOE_LAYERS`` layers; 128
    nib4c experts of 768 padded to 1024, top 8 renormalised): load, a
    greedy ``generate`` and ``decode_fused`` through K6's MoE branch with
    qk-norm (one launch per token), K6 against its plain version over the
    whole stack from one state (the first two layers and each layer alone held to
    TOL, each layer alone choosing the plain version's experts; the whole
    stack's ids reported: a near-tie's order swap there moves every later
    layer), and the fused route against its plain version over 8 steps
    (TOL_Q4KM: the stack's own one-ulp spread is ~0.6-1.5); against the
    loop reported (the loop's router reads the bf16 h, K6's the f32 h2: over
    24 layers x 128 experts a near-tie the two break apart is expected,
    ROADMAP reference-side fact 6)."""
    import os

    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = tmp / "synth-qwen3moe-q4km.gguf"
    t0 = time.perf_counter()
    write_synth(str(path), "qwen3moe-30b-a3b-q4_k_m", seed=0, n_layers=QWEN3MOE_LAYERS)
    t_write = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine.from_gguf(str(path), max_seq=8192)
    t_load = time.perf_counter() - t0
    mem_weights = torch.cuda.memory_allocated()
    route = decode_route(eng.params, eng.cfg, eng.kv)
    if route != "k6":
        raise AssertionError(f"qwen3moe_30b_a3b: decode route {route}, want k6")
    ids, single = single_stream(torch, "qwen3moe_30b_a3b", eng, 300, "decode_stream",
                                "decode_stream_moe_gemma", paths)
    chosen = k6.last_expert_ids(eng.params, eng.kv).tolist()
    nbytes, macs = weight_bytes_macs(eng.params, chosen)
    head = eng.params["lm_head"]
    nbytes += sum(t.numel() * t.element_size() for t in (head.q, head.s, head.m, head.sd,
                                                         head.md) if t is not None)
    fused = fused_run(torch, eng, ids, "decode_stream",
                      want={"decode_stream": 1.0, "decode_stream_moe_gemma": 1.0,
                            "gemv_int8": 1.0, "gemv_nib4c": 0.0, "flash_decode": 0.0,
                            "rqmm_int8": 0.0})
    full, _, caches = decode_errors(torch, eng, k6.fused_decode_step_streamed,
                                    k6.decode_layers_plain, 1, 3000,
                                    torch.tensor([[7]], device=eng.device))
    del caches
    torch.cuda.empty_cache()
    if full["per_layer_expert_sets_differ"]:
        fail(f"qwen3moe_30b_a3b: a layer alone chose other experts than the plain version: "
             f"{full['per_layer_expert_sets_differ']}")
    for what in ("first_two_layers", "per_layer"):
        if not full[what] <= TOL:
            fail(f"qwen3moe_30b_a3b: K6 over its stack, {what} {full[what]} > {TOL}")
    # 8 steps through QWEN3MOE_LAYERS layers of 128 random experts: one
    # bf16 ulp on x moves the plain version's own output by ~0.6-1.5 at 12
    # to 48 layers (``one_ulp_spread``), so the fused route is held to its plain version
    # at the Q4_K_M bound, beside the plain version's own 8-step spread
    # from one ulp (``plain_one_ulp_vs_plain``); each layer alone is held to
    # TOL above
    cmp = qwen3moe_routes(torch, eng, ids)
    emit(phase="qwen3moe_30b_a3b", layers=eng.cfg.n_layers, synth_write_s=t_write,
         gguf_bytes=os.path.getsize(path), load_s=t_load, route=route, **single,
         weights_and_cache_bytes=mem_weights,
         max_memory_allocated=torch.cuda.max_memory_allocated(),
         active_weight_bytes_per_token=nbytes, weight_macs_per_token=macs,
         bound_ms_per_token=bound(nbytes, 2 * macs)[0], expert_ids_last_step=chosen,
         stack_vs_plain={k: v for k, v in full.items() if k != "finite"},
         **fused, layer_loop_comparison=cmp)
    del eng
    path.unlink()
    torch.cuda.empty_cache()


def qwen3moe_routes(torch, eng, ids) -> dict:
    """Qwen3-30B-A3B's 8 fused steps against its plain version (held at
    TOL_Q4KM) and the per-layer loop (reported), with the one-ulp control."""
    return compare_routes(torch, eng, ids, TOL_Q4KM, enforce_loop=False,
                          kernel_tol=TOL_Q4KM, ulp_control=True)


def loop_vs_cpu(torch, name: str, path: str, n_prompt: int, per_token: dict,
                paths: dict, steps: int = 4) -> dict:
    """A stack the decode kernels' gates refuse, through the per-layer loop
    on the card and on the CPU (the plain versions), from the same ragged
    prompt: the prefill and ``steps`` decode steps fed the card's greedy
    tokens, held with the Q4_K_M check (allclose at TOL_Q4KM); the card's
    decode launches per token held to ``per_token``."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    card = Engine.from_gguf(path, max_seq=4096)
    if decode_route(card.params, card.cfg, card.kv) is not None or \
            k6._stream_ok(card.params, card.cfg, card.kv, 1, 1) or \
            k7._fused_ok(card.params, card.cfg, card.kv, 1, 1):
        raise AssertionError(f"{name}: a decode kernel's gate takes the stack")
    ids = prompt_ids(card, 300)[:n_prompt]
    kernel_counts(reset=True)
    t0 = time.perf_counter()
    a = [card.prefill(ids)]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = kernel_counts()
    kernel_counts(reset=True)
    fed = []
    t0 = time.perf_counter()
    for _ in range(steps):
        fed.append(int(np.argmax(a[-1])))
        a.append(card.decode_one(fed[-1]))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    paths[name] = launches = kernel_counts()
    want = {k: v * steps for k, v in per_token.items()}
    if any(launches.get(k) != v for k, v in want.items()):
        fail(f"{name}: decode launched {launches} in {steps} tokens, want {want}")
    del card
    torch.cuda.empty_cache()
    cpu = Engine.from_gguf(path, max_seq=4096, device="cpu")
    b = [cpu.prefill(ids)] + [cpu.decode_one(t) for t in fed]
    ratio = max(float((np.abs(x - y) / (TOL_Q4KM + TOL_Q4KM * np.abs(y))).max())
                for x, y in zip(a, b))
    rel = [float(np.abs(x - y).max() / np.abs(y).max()) for x, y in zip(a, b)]
    if not all(np.isfinite(x).all() for x in a) or not ratio <= 1:
        fail(f"{name}: the card's loop vs the CPU's: max rel {rel}, allclose ratio {ratio} "
             f"at {TOL_Q4KM}")
    return dict(prompt_tokens=len(ids), prefill_launches=prefill_launches,
                prefill_tok_s=len(ids) / prefill_s,
                decode_launches=launches, decode_tok_s=steps / decode_s,
                card_vs_cpu_rel=rel, card_vs_cpu_allclose_ratio=ratio)


def phase_qwen2_7b(torch, paths: dict, tmp: Path) -> None:
    """Qwen2.5-7B Q4_K_M at full width, ``QWEN2_LAYERS`` of 28 layers: q/k/v
    biases (K6 and K7 refuse them, as JAX's gates do), so decode is the
    per-layer loop: per layer K1 on the fused q|k|v (its nib4c q and k
    repacked to int8 beside the Q6_K v, as the JAX loader fuses a biased
    stack), K2 on o, gate|up and down, K3 at G 7; plus the head's K1.
    Prefill of 101 tokens: K4 at G 7.  Held against the CPU's plain loop."""
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = str(tmp / "synth-qwen2-7b-q4km.gguf")
    t0 = time.perf_counter()
    write_synth(path, "qwen2-7b-q4_k_m", seed=0, n_layers=QWEN2_LAYERS)
    t_write = time.perf_counter() - t0
    L = QWEN2_LAYERS
    out = loop_vs_cpu(torch, "qwen2_7b", path, 101,
                      {"gemv_int8": L + 1, "gemv_nib4c": 3 * L, "flash_decode": L,
                       "decode_stream": 0, "decode_step": 0}, paths)
    if out["prefill_launches"]["flash_attention"] != L:
        fail(f"qwen2_7b: prefill launches {out['prefill_launches']}")
    emit(phase="qwen2_7b", layers=L, synth_write_s=t_write, **out)
    Path(path).unlink()


def phase_qwen2moe(torch, paths: dict, tmp: Path) -> None:
    """Qwen1.5-MoE-A2.7B Q8_0 at full width, ``QWEN2_LAYERS`` of 24 layers,
    with its q/k/v biases: the decode kernels' gates refuse it (as JAX's
    do), so decode is the loop: per layer K1 on q|k|v, o and the shared
    expert's gate|up and down, K8 on the 4 chosen experts' gate, up and
    down (3 launches), K3; plus the head's K1; held against the CPU's plain
    loop.  Then the same widths without the biases, 2 layers, through
    ``decode_fused``: K6's shared-expert mode, once per token."""
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = str(tmp / "synth-qwen2moe-q8_0.gguf")
    t0 = time.perf_counter()
    write_synth(path, "qwen2moe-a2.7b-q8_0", seed=0, n_layers=QWEN2_LAYERS)
    t_write = time.perf_counter() - t0
    L = QWEN2_LAYERS
    out = loop_vs_cpu(torch, "qwen2moe_a2_7b", path, 101,
                      {"gemv_int8": 4 * L + 1, "rqmm_int8": 3 * L, "flash_decode": L,
                       "gemv_nib4c": 0, "decode_stream": 0, "decode_step": 0}, paths)
    Path(path).unlink()
    path = str(tmp / "synth-qwen2moe-q8_0-nobias.gguf")
    write_synth(path, "qwen2moe-a2.7b-q8_0", seed=0, n_layers=2, attn_bias=False)
    eng = Engine.from_gguf(path, max_seq=4096)
    route = decode_route(eng.params, eng.cfg, eng.kv)
    if route != "k6":
        raise AssertionError(f"qwen2moe without biases: decode route {route}, want k6")
    ids = prompt_ids(eng)[:301]
    kernel_counts(reset=True)
    _, toks = eng.generate(eng.tokenizer.detokenize(ids), n_predict=16, stop_on_eog=False)
    torch.cuda.synchronize()
    launches = kernel_counts()
    if (launches["decode_stream_moe"], launches["decode_stream_shexp"]) != (16, 16):
        raise AssertionError(f"qwen2moe without biases: decode went elsewhere than K6's "
                             f"shared-expert mode: {launches}")
    fused = fused_run(torch, eng, ids, "decode_stream",
                      want={"decode_stream": 1.0, "decode_stream_moe": 1.0,
                            "decode_stream_shexp": 1.0, "gemv_int8": 1.0, "rqmm_int8": 0.0,
                            "flash_decode": 0.0})
    paths["qwen2moe_shexp"] = fused["launches"]
    emit(phase="qwen2moe_a2_7b", layers=L, synth_write_s=t_write, **out,
         shexp_route=route, shexp_generate_launches=launches, shexp_fused=fused)
    del eng
    Path(path).unlink()
    torch.cuda.empty_cache()


def plain_attention_steps(torch, eng, fed: list[int]) -> list:
    """``decode_one`` over the tokens ``fed`` with K3's plain version in
    place of the kernel (the same loop otherwise)."""
    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.ops import attention
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode_plain

    attention.flash_decode = flash_decode_plain
    try:
        return [eng.decode_one(t) for t in fed]
    finally:
        attention.flash_decode = kernels.COUNTERS["flash_decode"]


class plain_kernels:
    """Within: the model's quantized products (``models/llama.linear``: K1 /
    K2 at decode) and K3's calls take their plain versions (``gemv_plain``,
    ``flash_decode_plain``) on the card; ``per_call`` instead runs each
    kernel and its plain version on the same inputs and keeps the worst max
    |kernel - plain| / max |plain| of each kernel's calls in ``worst``."""

    def __init__(self, torch, per_call: bool = False):
        self.torch, self.per_call, self.worst = torch, per_call, {}

    def __enter__(self):
        from llama_cpp_gfx906_tpu_torch.models import llama
        from llama_cpp_gfx906_tpu_torch.ops import attention
        from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
        from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode_plain

        torch, worst = self.torch, self.worst
        self.saved = [(llama, "linear", llama.linear),
                      (attention, "flash_decode", attention.flash_decode)]

        def linear_plain(x, w):
            if not isinstance(w, qmm.QuantTensor):
                return x @ w
            x2 = x.reshape(-1, w.K)
            return qmm.gemv_plain(x2, w).reshape(*x.shape[:-1], w.N).to(x.dtype)

        def swap(kern, plain, name_of):
            def call(*args, **kw):
                if not self.per_call:
                    return plain(*args, **kw)
                got = kern(*args, **kw)
                name = name_of(*args)
                if name:
                    worst[name] = max(worst.get(name, 0.0),
                                      rel_of(torch, got, plain(*args, **kw)))
                return got
            return call

        def gemv_name(x, w):
            return f"gemv_{w.fmt}" if isinstance(w, qmm.QuantTensor) else None

        llama.linear = swap(llama.linear, linear_plain, gemv_name)
        attention.flash_decode = swap(attention.flash_decode, flash_decode_plain,
                                      lambda *a: "flash_decode")
        return self

    def __exit__(self, *exc):
        for mod, name, kern in self.saved:
            setattr(mod, name, kern)


def loop_layer_errors(torch, eng, tok: int) -> float:
    """Each layer of the per-layer loop alone, from the engine's state: the
    token's embedding through layer 0, then each layer fed the kernels'
    output of the layer before, run with the kernels and with their plain
    versions (``plain_kernels``) on clones of its cache rows; the worst max
    |kernels - plain| / max |plain| of a layer's output x and its new K/V
    rows (depth amplifies neither)."""
    from llama_cpp_gfx906_tpu_torch.models.config import sub_config
    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, embed, layers_forward
    from llama_cpp_gfx906_tpu_torch.runtime.weights import ParamDict

    params, cfg, kv = eng.params, eng.cfg, eng.kv
    n = int(kv.n_past[0])
    worst = 0.0
    with torch.inference_mode():
        x = embed(params, cfg, torch.tensor([[tok]], device=eng.device))
        for li in range(cfg.n_layers):
            sub = ParamDict({"layers": torch.nn.ModuleList([params["layers"][li]])})
            sub_cfg = sub_config(cfg, li, 1)
            kvs = [KVCache(k=kv.k[li:li + 1].clone(), v=kv.v[li:li + 1].clone(),
                           n_past=kv.n_past.clone()) for _ in range(2)]
            got = layers_forward(sub, sub_cfg, x, kvs[0])
            with plain_kernels(torch):
                ref = layers_forward(sub, sub_cfg, x, kvs[1])
            worst = max(worst, rel_of(torch, got, ref),
                        rel_of(torch, kvs[0].k[:, :, n], kvs[1].k[:, :, n]),
                        rel_of(torch, kvs[0].v[:, :, n], kvs[1].v[:, :, n]))
            x = got
            del kvs
    return worst


def phase_mpt_7b(torch, paths: dict, tmp: Path) -> None:
    """MPT-7B Q4_K_M at full width and depth (ALiBi, LayerNorm, an ungated
    gelu FFN): synth write and load; a ragged 1,531-token prefill (ALiBi at
    G·T > 128: the counted einsum, one a layer); ``generate`` and
    ``decode_fused`` through the per-layer loop with K3's ALiBi mode, the
    fused launches per token held to ``MPT_PER_TOKEN``; 8 fused steps: their
    greedy tokens those of the loop fed the same tokens; every K1 / K2 and
    K3 call of the loop's first step held to its plain version on the same
    inputs at TOL, and each layer alone (``loop_layer_errors``) at TOL; the
    32-layer stack's logits over the 8 steps against the loop with every
    kernel's plain version, reported beside them (depth carries a near-tie
    of the synthetic stack's greedy path to a few bf16 ulps there: a hold at
    its rounding floor, not of the kernels); then ``BatchedEngine`` at 4
    slots x 4096 (bf16 cache): 4 requests of 256-1,531 prompt tokens and 16
    new tokens each, K3-ALiBi once a layer per decode step, and the batched
    step against single slots."""
    import os

    import numpy as np

    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = tmp / "synth-mpt-7b-q4km.gguf"
    t0 = time.perf_counter()
    write_synth(str(path), "mpt-7b-q4_k_m", seed=0)
    t_write = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    eng = Engine.from_gguf(str(path), max_seq=4096)
    mem_weights = torch.cuda.memory_allocated()
    L = eng.cfg.n_layers
    if decode_route(eng.params, eng.cfg, eng.kv) is not None:
        raise AssertionError("mpt_7b: a decode kernel's gate takes an ALiBi stack")
    ids = prompt_ids(eng, 600)[:MPT_PROMPT_TOKENS]
    eng.reset()
    kernel_counts(reset=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = kernel_counts()
    if (prefill_launches["attend_einsum"], prefill_launches["flash_decode"],
            prefill_launches["flash_attention"]) != (L, 0, 0):
        fail(f"mpt_7b: prefill launches {prefill_launches}, want {L} einsum")
    kernel_counts(reset=True)
    _, toks = eng.generate(eng.tokenizer.detokenize(ids), n_predict=32, stop_on_eog=False)
    torch.cuda.synchronize()
    paths["mpt_7b"] = launches = kernel_counts()
    generate_perf = eng.perf.summary()
    if len(toks) != 32 or not all(0 <= t < eng.cfg.n_vocab for t in toks):
        raise AssertionError(f"mpt_7b: bad generated tokens {toks}")
    if (launches["flash_decode_alibi"] != 32 * L or launches["decode_stream"]
            or launches["decode_step"]):
        fail(f"mpt_7b: generate's decode went elsewhere than K3's ALiBi mode: {launches}")
    fused = fused_run(torch, eng, ids, "flash_decode_alibi",
                      want={k: float(v) for k, v in MPT_PER_TOKEN.items()})
    paths["mpt_7b_fused"] = fused["launches"]

    # 8 fused steps against the loop with K3 and with K3's plain version
    eng.reset()
    first = int(np.argmax(eng.prefill(ids)))
    n0 = eng.n_past
    k0, v0 = eng.kv.k.clone(), eng.kv.v.clone()

    def rewind():
        eng.kv.k.copy_(k0)
        eng.kv.v.copy_(v0)
        eng.set_n_past(n0)

    steps = eng.decode_fused(first, n_steps=8)
    fed = [first] + steps[:-1]
    rewind()
    loop = [eng.decode_one(t) for t in fed]
    rewind()
    with plain_kernels(torch):
        plain = [eng.decode_one(t) for t in fed]
    rewind()
    with plain_kernels(torch, per_call=True) as calls:
        eng.decode_one(first)
    rewind()
    per_layer = loop_layer_errors(torch, eng, first)
    del k0, v0
    rel = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(loop, plain)]
    fused_vs_loop = [int(t == int(np.argmax(a))) for t, a in zip(steps, loop)]
    if not all(fused_vs_loop):
        fail(f"mpt_7b: 8 fused steps: fused greedy vs the loop's {fused_vs_loop}")
    if not max(calls.worst.values()) <= TOL or not per_layer <= TOL:
        fail(f"mpt_7b: the loop's calls vs plain {calls.worst}, each layer alone "
             f"{per_layer}, tol {TOL}")
    emit(phase="mpt_7b", layers=L, synth_write_s=t_write, gguf_bytes=os.path.getsize(path),
         prompt_tokens=len(ids), prefill_s=prefill_s, prefill_tok_s=len(ids) / prefill_s,
         prefill_launches=prefill_launches, generate_perf=generate_perf,
         generate_launches=launches, weights_and_cache_bytes=mem_weights,
         max_memory_allocated=torch.cuda.max_memory_allocated(), **fused,
         per_call_vs_plain=calls.worst, per_layer_vs_plain=per_layer,
         steps_loop_vs_plain_rel=rel, steps_fused_vs_loop_greedy=fused_vs_loop)
    cfg, params, tok, dev = eng.cfg, eng.params, eng.tokenizer, eng.device
    del eng
    torch.cuda.empty_cache()

    rng = np.random.default_rng(6)

    def prompts(lens):
        return [[int(t) for t in rng.integers(3, cfg.n_vocab, n)] for n in lens]

    be = BatchedEngine(cfg, params, tok, n_slots=4, max_seq=4096,
                       kv_cache_dtype=torch.bfloat16, device=dev)
    be.warmup()
    m0 = dict(be.metrics)
    before = kernels.device_counts()
    t0 = time.perf_counter()
    run_requests(be, prompts((256, 700, 1024, MPT_PROMPT_TOKENS)), 16)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    paths["mpt_7b_serve"] = served = launches_since(before)
    steps_n = be.metrics["n_decode_steps"] - m0["n_decode_steps"]
    chunks = be.metrics["n_prefill_chunks"] - m0["n_prefill_chunks"]
    # every chunk holds more than 128 tokens (the einsum), then the head's
    # K1 on its last row; each decode step: K3-ALiBi and 4 K2 a layer, K1
    want = {"flash_decode_alibi": L * steps_n, "gemv_nib4c": 4 * L * steps_n,
            "gemv_int8": steps_n + chunks, "decode_stream": 0, "flash_attention": 0}
    if any(served.get(k) != v for k, v in want.items()):
        fail(f"mpt_7b: the batched engine launched {served} in {steps_n} decode steps "
             f"and {chunks} prefill chunks, want {want}")
    n_out = be.metrics["n_generated_tokens"] - m0["n_generated_tokens"]
    if n_out != 4 * 16:
        fail(f"mpt_7b: {n_out} tokens served, want 64")
    worst = batched_vs_single(torch, be, prompts((256, 700, 1500, 3000)), rng)["worst_rel"]
    if not worst <= TOL:
        fail(f"mpt_7b: batched vs single-slot logits {worst} > {TOL}")
    emit(phase="mpt_7b_serve", served_tokens=n_out, served_wall_s=wall,
         served_tok_s=n_out / wall, decode_steps=steps_n, prefill_chunks=chunks,
         decode_step_wall_ms=(be.metrics["t_decode_s"] - m0["t_decode_s"]) * 1e3
         / max(steps_n, 1),
         decode_step_device_ms=(be.metrics["t_decode_device_s"] - m0["t_decode_device_s"])
         * 1e3 / max(steps_n, 1),
         launches=served, launches_want=want, batched_vs_single_rel=worst)
    del be, params
    path.unlink()
    torch.cuda.empty_cache()


def phase_bloom_7b1(torch, paths: dict, tmp: Path) -> None:
    """BLOOM-7B1 Q4_K_M at full width, ``BLOOM_LAYERS`` of 30 layers (every
    bias, the LayerNorms' biases, the embedding norm; vocab 250,880): the
    per-layer loop on the card (per layer K2 on q|k|v, o, up and down,
    K3-ALiBi; the head's K1), held against the CPU's plain loop; a 101-token
    prefill (G·T <= 128: K3's ALiBi mode)."""
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = str(tmp / "synth-bloom-7b1-q4km.gguf")
    t0 = time.perf_counter()
    write_synth(path, "bloom-7b1-q4_k_m", seed=0, n_layers=BLOOM_LAYERS)
    t_write = time.perf_counter() - t0
    L = BLOOM_LAYERS
    out = loop_vs_cpu(torch, "bloom_7b1", path, 101,
                      {"gemv_nib4c": 4 * L, "gemv_int8": 1, "flash_decode": L,
                       "flash_decode_alibi": L, "decode_stream": 0, "decode_step": 0},
                      paths)
    if out["prefill_launches"]["flash_decode_alibi"] != L:
        fail(f"bloom_7b1: prefill launches {out['prefill_launches']}")
    emit(phase="bloom_7b1", layers=L, synth_write_s=t_write, **out)
    Path(path).unlink()


def oss_vs_cpu(torch, path: str, n_prompt: int, steps: int = 4) -> dict:
    """A gpt-oss stack through the per-layer loop on the card and on the CPU
    (the plain versions) from the same ragged prompt: the prefill and
    ``steps`` decode steps, fed the CPU's greedy tokens, the CPU following
    the card's routes (``kernel_times.RouteLog``: the devices round the
    bf16 activations differently, so a router near-tie may pick another
    expert on each).  Held: every expert of the card's that the CPU ranks
    below its own top k explained by the two devices' router logits
    (``RouteLog.unexplained`` <= 1), the logits with the Q4_K_M check
    (allclose at TOL_Q4KM), the greedy token where the CPU's margin is
    clear; reported: the tokens whose experts the CPU would have chosen
    otherwise and how far below its top k they ranked."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    card, cpu = (Engine.from_gguf(path, max_seq=4096),
                 Engine.from_gguf(path, max_seq=4096, device="cpu"))
    ids = prompt_ids(card, 300)[:n_prompt]
    tok, rows = None, []
    for step in range(steps + 1):
        with kt.RouteLog() as routes:
            a = card.prefill(ids) if tok is None else card.decode_one(tok)
        with kt.RouteLog(replay=routes.calls) as replayed:
            b = cpu.prefill(ids) if tok is None else cpu.decode_one(tok)
        err = float(np.abs(a - b).max())
        top2 = np.sort(b)[-2:]
        row = dict(step=step, rel=err / float(np.abs(b).max()),
                   allclose_ratio=float((np.abs(a - b) / (TOL_Q4KM + TOL_Q4KM * np.abs(b))
                                         ).max()),
                   route_deficit=replayed.deficit(), tokens_rerouted=replayed.replaced(),
                   route_unexplained=replayed.unexplained(routes),
                   greedy_agree=int(np.argmax(a)) == int(np.argmax(b)),
                   greedy_margin_clear=bool(top2[1] - top2[0] > 2 * err))
        if not (np.isfinite(a).all() and row["allclose_ratio"] <= 1
                and row["route_unexplained"] <= 1
                and (row["greedy_agree"] or not row["greedy_margin_clear"])):
            fail(f"gpt_oss_20b vs cpu, step {step}: {row}")
        rows.append(row)
        tok = int(np.argmax(b))
    return dict(prompt_tokens=len(ids), steps=rows)


def phase_gpt_oss_20b(torch, paths: dict, tmp: Path) -> None:
    """gpt-oss-20b with Q4_0 experts (synthetic, full width, ``OSS_LAYERS``
    of 24 layers): synth write and load; a ragged 997-token prefill (per
    layer K5-int8 on q|k|v, K5-nib4 on every expert's gate and up: 2 x 32,
    K4 with sinks; the nib4c o and down take the dequant matmul), its
    launches held on the host and the device (``oss_per_prefill``); 32
    greedy tokens through the per-layer loop (``decode_one``) and then
    ``decode_fused`` (the loop captured in a graph), launches per token
    held to ``oss_per_token`` (K8-nib4 twice a layer), tok/s, device ms per
    token and the idle share; then a cut of the same preset (4 layers, the
    first 8,192 tokens) against the CPU's plain loop (``oss_vs_cpu``)."""
    import os

    import numpy as np

    from llama_cpp_gfx906_tpu_torch import kernels
    from llama_cpp_gfx906_tpu_torch.models.llama import decode_route
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    path = tmp / "synth-gpt-oss-20b-q4_0.gguf"
    t0 = time.perf_counter()
    write_synth(str(path), "gpt-oss-20b-q4_0", seed=0, n_layers=OSS_LAYERS)
    t_write = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine.from_gguf(str(path), max_seq=4096)
    t_load = time.perf_counter() - t0
    mem_weights = torch.cuda.memory_allocated()
    L = eng.cfg.n_layers
    p0 = eng.params["layers"][0]
    fmts = {k: (p0[k].fmt, p0[k].m is not None)
            for k in ("wqkv_fused", "wo", "moe_gate", "moe_up", "moe_down")}
    want_fmts = {"wqkv_fused": ("int8", True), "wo": ("nib4c", True),
                 "moe_gate": ("nib4", True), "moe_up": ("nib4", True),
                 "moe_down": ("nib4c", True)}
    if fmts != want_fmts or "sinks" not in p0:
        raise AssertionError(f"gpt_oss_20b: planes {fmts}, want {want_fmts} and sinks")
    if decode_route(eng.params, eng.cfg, eng.kv) is not None:
        raise AssertionError("gpt_oss_20b: a decode kernel's gate takes the stack")
    ids = prompt_ids(eng, 600)[:OSS_PROMPT_TOKENS]
    eng.reset()
    kernel_counts(reset=True)
    before = kernels.device_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_launches = kernel_counts()
    paths["gpt_oss_20b_prefill"] = prefill_device = launches_since(before)
    want = oss_per_prefill(L, len(ids))
    if any(prefill_launches.get(k) != v or prefill_device.get(k) != v
           for k, v in want.items()):
        fail(f"gpt_oss_20b: prefill launched {prefill_launches} (device {prefill_device}),"
             f" want {want}")
    kernel_counts(reset=True)
    tok, toks = int(np.argmax(logits)), []
    t0 = time.perf_counter()
    for _ in range(32):
        logits = eng.decode_one(tok)
        tok = int(np.argmax(logits))
        toks.append(tok)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    paths["gpt_oss_20b"] = launches = kernel_counts()
    want = {k: 32 * v for k, v in oss_per_token(L).items()}
    want["routed_gather"] = 32 * L  # the nib4c down experts (host count)
    if any(launches.get(k) != v for k, v in want.items()):
        fail(f"gpt_oss_20b: 32 decode steps launched {launches}, want {want}")
    if not (np.isfinite(logits).all() and logits.shape == (eng.cfg.n_vocab,)
            and all(0 <= t < eng.cfg.n_vocab for t in toks)):
        raise AssertionError("gpt_oss_20b: bad logits or tokens")
    fused = fused_run(torch, eng, ids, "rqmm_nib4",
                      want={k: float(v) for k, v in oss_per_token(L).items()})
    paths["gpt_oss_20b_fused"] = fused["launches"]
    emit(phase="gpt_oss_20b", layers=L, synth_write_s=t_write,
         gguf_bytes=os.path.getsize(path), load_s=t_load, prompt_tokens=len(ids),
         prefill_s=prefill_s, prefill_tok_s=len(ids) / prefill_s,
         prefill_launches=prefill_launches, prefill_device_launches=prefill_device,
         decode_loop_tok_s=32 / loop_s, decode_loop_launches=launches,
         weights_and_cache_bytes=mem_weights,
         max_memory_allocated=torch.cuda.max_memory_allocated(), **fused)
    del eng, p0
    path.unlink()
    torch.cuda.empty_cache()
    cut = tmp / "synth-gpt-oss-20b-q4_0-cut.gguf"
    t0 = time.perf_counter()
    write_synth(str(cut), "gpt-oss-20b-q4_0", seed=0, n_layers=OSS_CPU_LAYERS,
                n_vocab=OSS_CPU_VOCAB)
    out = oss_vs_cpu(torch, str(cut), 150)
    emit(phase="gpt_oss_20b_vs_cpu", layers=OSS_CPU_LAYERS, vocab=OSS_CPU_VOCAB,
         seconds=time.perf_counter() - t0, **out)
    cut.unlink()
    torch.cuda.empty_cache()


def phase_tinydoc(torch, paths: dict) -> None:
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, forward
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine

    expected = json.loads((FIX / "tinydoc_expected.json").read_text())
    eng = Engine.from_gguf(str(FIX / "tinydoc-byte.f16.gguf"), max_seq=192,
                           dtype=torch.float32)
    kernel_counts(reset=True)
    for prompt, want in expected["greedy"].items():
        _, toks = eng.generate(prompt, n_predict=len(want), stop_on_eog=False)
        if toks != want:
            raise AssertionError(f"tinydoc: greedy drift for {prompt!r}: {toks}")
        if eng.generate_fused(prompt, n_predict=len(want), stop_on_eog=False,
                              chunk=8)[1] != want:
            raise AssertionError(f"tinydoc: generate_fused drift for {prompt!r}")
    held = expected["held_ids"]
    kv = KVCache.create(eng.cfg, 1, len(held) - 1, torch.float32, eng.device)
    with torch.inference_mode():
        logits, _ = forward(eng.params, eng.cfg,
                            torch.tensor([held[:-1]], device=eng.device), kv)
        logp = torch.log_softmax(logits[0], -1)[
            torch.arange(len(held) - 1, device=eng.device),
            torch.tensor(held[1:], device=eng.device)]
    ppl = float(np.exp(-float(logp.mean())))
    paths["tinydoc"] = counts = kernel_counts()
    emit(phase="tinydoc", greedy_prompts=len(expected["greedy"]), ppl=ppl,
         ppl_pinned=expected["ppl"], launches=counts)
    if abs(ppl - expected["ppl"]) / expected["ppl"] >= 0.01:
        raise AssertionError(f"tinydoc: ppl {ppl} vs pinned {expected['ppl']}")
    if not (counts["flash_decode"] and counts["flash_attention"]):
        raise AssertionError(f"tinydoc: attention kernels not launched: {counts}")


def phase_tinydoc_batched(torch, paths: dict) -> None:
    """tinydoc's pinned greedy prompts, all at once through ``BatchedEngine``
    (one slot each, 8-token prefill chunks, the decode step replayed from a
    CUDA graph): with an f32 cache on the card the pinned tokens exactly;
    with a q8 cache the tokens' agreement with the same engine on the CPU
    (reported), and the held-out perplexity through a q8 cache within 1% of
    the CPU's."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.models.llama import KVCache, forward
    from llama_cpp_gfx906_tpu_torch.runtime.batch_engine import BatchedEngine, SamplerConfig

    expected = json.loads((FIX / "tinydoc_expected.json").read_text())
    prompts, held = list(expected["greedy"]), expected["held_ids"]
    out = {}
    for kv_dtype, devs in ((None, ("cuda",)), ("q8", ("cuda", "cpu"))):
        name = kv_dtype or "f32"
        for dev in devs:
            eng = BatchedEngine.from_gguf(str(FIX / "tinydoc-byte.f16.gguf"),
                                          dtype=torch.float32, device=dev,
                                          n_slots=len(prompts), max_seq=128, n_chunk=8,
                                          kv_cache_dtype=kv_dtype)
            kernel_counts(reset=True)
            slots = [eng.add_request(
                eng.tokenizer.tokenize(p, add_special=True, parse_special=True),
                len(expected["greedy"][p]), SamplerConfig(temp=0.0)) for p in prompts]
            got = {s.id: [] for s in slots}
            while any(s.stop_reason is None for s in slots):
                for s, t, _ in eng.step():
                    got[s.id].append(t)
            kv = KVCache.create(eng.cfg, 1, len(held) - 1, kv_dtype or torch.float32,
                                eng.device)
            with torch.inference_mode():
                logits, _ = forward(eng.params, eng.cfg,
                                    torch.tensor([held[:-1]], device=eng.device), kv)
                logp = torch.log_softmax(logits[0], -1)[
                    torch.arange(len(held) - 1, device=eng.device),
                    torch.tensor(held[1:], device=eng.device)]
            out[f"{name}_{dev}"] = dict(tokens=[got[s.id] for s in slots],
                                        ppl=float(np.exp(-float(logp.mean()))))
            if dev == "cuda":
                paths[f"tinydoc_batched_{name}"] = out[f"{name}_{dev}"]["launches"] = \
                    kernel_counts()
                if eng._step.graph is None:
                    fail(f"tinydoc_batched {name}: the decode step was not captured")
            del eng
    want = [expected["greedy"][p] for p in prompts]
    pairs = [(a, b) for x, y in zip(out["q8_cuda"]["tokens"], out["q8_cpu"]["tokens"])
             for a, b in zip(x, y)]
    q8_ppl_gap = abs(out["q8_cuda"]["ppl"] - out["q8_cpu"]["ppl"]) / out["q8_cpu"]["ppl"]
    emit(phase="tinydoc_batched", f32_tokens_exact=out["f32_cuda"]["tokens"] == want,
         q8_tokens_agree_with_cpu=sum(a == b for a, b in pairs) / len(pairs),
         q8_tokens_agree_with_pinned=sum(a == b for x, y in zip(out["q8_cuda"]["tokens"], want)
                                         for a, b in zip(x, y)) / len(pairs),
         f32_ppl=out["f32_cuda"]["ppl"], q8_ppl_card=out["q8_cuda"]["ppl"],
         q8_ppl_cpu=out["q8_cpu"]["ppl"], q8_ppl_rel_gap=q8_ppl_gap,
         launches={k: v.get("launches") for k, v in out.items() if "launches" in v})
    if out["f32_cuda"]["tokens"] != want:
        fail(f"tinydoc_batched: f32 tokens {out['f32_cuda']['tokens']} are not the pinned ones")
    if not q8_ppl_gap < 0.01:
        fail(f"tinydoc_batched: q8 ppl on the card {out['q8_cuda']['ppl']} vs the CPU "
             f"{out['q8_cpu']['ppl']}")


# K4's launches by body: the model paths whose every K4 launch must be the
# body named here (a bf16 q: the tensor-core body, counted as "mma"; q8:
# "int8_mma"; tinydoc's f32 q: the FMA body, "flash_attention" alone)
K4_COUNTS = ("flash_attention", "flash_attention_mma", "flash_attention_int8_mma",
             "flash_attention_int8")
K4_BODY = {"8b_layer_loop": "flash_attention_mma", "qwen3_8b_prefill": "flash_attention_mma",
           "gemma3_4b_prefill": "flash_attention_mma",
           "gpt_oss_20b_prefill": "flash_attention_mma",
           "8b_serve_http_bf16": "flash_attention_mma",
           "8b_serve_http_q8": "flash_attention_int8_mma", "tinydoc": "flash_attention"}


def check_k4_bodies(paths: dict) -> dict:
    """Each ``K4_BODY`` path launched K4, and every launch was its body;
    the paths' K4 counts."""
    got = {p: {k: paths.get(p, {}).get(k, 0) for k in K4_COUNTS} for p in K4_BODY}
    emit(phase="k4_bodies", launches=got)
    for p, body in K4_BODY.items():
        n = got[p]["flash_attention"]
        others = sum(v for k, v in got[p].items() if k not in ("flash_attention", body))
        if not n or got[p][body] != n or others:
            fail(f"k4_bodies: {p} launched {got[p]}, want every K4 launch as {body}")
    return got


def plant_faults(names: list[str]) -> None:
    """``--plant-faults [-j N] [fault ...]`` (see the module docstring): the
    named faults (all of them when none is named) and the unmodified
    source; with ``-j N`` the copies' readings run N at a time (each copy
    its own process on the card, as one at a time)."""
    jobs = 1
    if names[:1] == ["-j"]:
        jobs, names = int(names[1]), names[2:]
    known = {**FAULTS, **NIB4_FAULTS, **K4_FAULTS, **K5_FAULTS, **GEMV_FAULTS}
    unknown = set(names) - set(known)
    if unknown:
        raise SystemExit(f"unknown faults {sorted(unknown)}; known: {sorted(known)}")
    with tempfile.TemporaryDirectory() as tmp:
        roots = {}
        for fault, edit in known.items():
            if names and fault not in names and edit is not None:
                continue
            root = Path(tmp) / fault
            shutil.copytree(ROOT / PKG, root / PKG,
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "chip_smoke.py", root)
            for rel, text, planted in fault_edits(fault):
                src = root / PKG / rel
                body = src.read_text()
                if body.count(text) != 1:
                    raise RuntimeError(f"{fault}: the text to replace is not in "
                                       f"{src.name} once")
                src.write_text(body.replace(text, planted))
            roots[fault] = root
        # the control reads the kernels of the named faults (all: every kernel)
        groups = sorted({fault_group(f) for f in names} if names
                        else {"k3", "k4", "k5", "k6", "nib4", "gemv"})
        procs = []
        for fault, root in roots.items():
            libs = sorted({lib for grp in (groups if fault == "none" else
                                           [fault_group(fault)]) for lib in GROUP_LIBS[grp]})
            build = f"from {PKG} import kernels; kernels.build_all({tuple(libs)!r})"
            procs.append(subprocess.Popen([sys.executable, "-c", build], cwd=root))
        if any(p.wait() != 0 for p in procs):
            raise RuntimeError("a copy failed to build")
        def finish(proc, out: Path) -> None:
            # a copy's lines together, whatever ran beside it
            rc = proc.wait()
            sys.stdout.write(out.read_text())
            sys.stdout.flush()
            if rc != 0:
                raise RuntimeError("a copy's readings failed")

        running = []
        for fault, root in roots.items():
            group = ",".join(groups) if fault == "none" else fault_group(fault)
            out = root / "readings.jsonl"
            with open(out, "w") as f:
                running.append((subprocess.Popen(
                    [sys.executable, "chip_smoke.py", "--decode-errors", fault, group],
                    cwd=root, stdout=f), out))
            if len(running) >= jobs:
                finish(*running.pop(0))
        for proc, out in running:
            finish(proc, out)


GROUP_LIBS = {"nib4": ("qmm", "rqmm"), "k3": ("flash_decode",), "k4": ("flash_attention",),
              "k5": ("qmm",), "gemv": ("gemv",),
              "k6": ("decode_stream",)}  # the libraries a group's kernels need


def fault_group(fault: str) -> str:
    """The kernels a planted fault's copy is read on: "nib4" (K5-nib4 and
    K8-nib4), "gemv" (K1 / K2), "k3", "k4", "k5" or "k6" (K6 and K7)."""
    if fault in NIB4_FAULTS:
        return "nib4"
    if fault in GEMV_FAULTS:
        return "gemv"
    if fault in K5_FAULTS:
        return "k5"
    return "k4" if fault in K4_FAULTS else "k3" if fault in K3_FAULTS else "k6"


def fault_edits(fault: str) -> tuple:
    """The edits that plant ``fault``: (file under the package, text, what
    replaces it) each; none for the unmodified source."""
    grouped = {**NIB4_FAULTS, **K4_FAULTS, **K5_FAULTS, **GEMV_FAULTS}
    if fault in grouped:
        return grouped[fault]
    if FAULTS[fault] is None:
        return ()
    if len(FAULTS[fault]) == 3:
        return (FAULTS[fault],)
    src = "flash_decode" if fault in K3_FAULTS else "decode_stream"
    return ((f"csrc/{src}.cu", *FAULTS[fault]),)


def gemv_errors_of_copy(torch, fault: str) -> None:
    """K1 / K2's errors against ``gemv_plain`` on every
    ``kernel_times.GEMV_CASES`` and ``OSS_GEMV_CASES`` entry (bf16 x, held at
    TOL), and on an f32 x at M 1 of each weight (held at TOL_F32X), one JSON
    line each, with the case's tile columns and splits."""
    import numpy as np

    from llama_cpp_gfx906_tpu_torch.ops import quant_matmul as qmm
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    g = torch.Generator(device=dev).manual_seed(0)
    for (gtype, K, N, pad), group in kt.gemv_by_shape((*kt.GEMV_CASES, *kt.OSS_GEMV_CASES)):
        qt = kt.gemv_weights(rng, gtype, K, N, pad, dev)
        kern = getattr(qmm, group[0][0])
        tn, splits = qmm.gemv_config(*qt.q.shape, sms)
        xs = [(case, torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16), TOL)
              for _, case, *_, M in group]
        xs.append((f"{group[0][1]} f32 x", torch.randn((1, K), generator=g, device=dev),
                   TOL_F32X))
        for case, x, tol in xs:
            emit(phase="planted_fault", fault=fault, kernel=group[0][0], case=case, tn=tn,
                 splits=splits, rel_err=rel_of(torch, kern(x, qt), qmm.gemv_plain(x, qt)),
                 tol=tol)
        del qt, xs
        torch.cuda.empty_cache()


def decode_errors_of_copy(torch, fault: str, groups: list[str]) -> None:
    """The errors against plain of this copy's kernels in ``groups``
    (``fault_group``), one JSON line each: K5-nib4 and K8-nib4
    (``nib4_cases``), K3 (``kernel_times.K3_CASES``), K4 (``kernel_times.K4_CASES``),
    K5 (``kernel_times.QMM_CASES``, with each case's split count), K6 and
    K7 (``decode_errors`` on ``kernel_times.DECODE_CASES``)."""
    from llama_cpp_gfx906_tpu_torch.ops import decode_step as k7
    from llama_cpp_gfx906_tpu_torch.ops import decode_stream as k6
    from llama_cpp_gfx906_tpu_torch.ops.flash_decode import flash_decode, flash_decode_plain
    from llama_cpp_gfx906_tpu_torch.runtime.engine import Engine
    from llama_cpp_gfx906_tpu_torch.tools import kernel_times as kt
    from llama_cpp_gfx906_tpu_torch.tools.synth_gguf import write_synth

    if "nib4" in groups:
        for c in nib4_cases(torch, torch.device("cuda")):
            emit(phase="planted_fault", fault=fault, kernel=c["name"], case=c["case"],
                 rel_err=rel_of(torch, c["kern"](), c["plain"]()), tol=TOL)
        torch.cuda.empty_cache()
    if "gemv" in groups:
        gemv_errors_of_copy(torch, fault)
    if "k5" in groups:
        from llama_cpp_gfx906_tpu_torch.ops.quant_matmul import qmm_config

        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for i, spec in enumerate(kt.QMM_CASES):
            c = kt.qmm_case(torch, torch.device("cuda"), spec, 80 + i)
            kp, Np = c["qt"].q.shape
            emit(phase="planted_fault", fault=fault, kernel=c["name"], case=c["case"],
                 splits=qmm_config(spec[5], kp, Np, sms, c["mode"] == "nib4",
                                   c["qt"].m is not None)[1],
                 rel_err=rel_of(torch, c["kern"](), c["plain"]()), tol=TOL)
            del c
        torch.cuda.empty_cache()
    if "k3" in groups:
        for i, spec in enumerate(kt.K3_CASES):
            c = kt.k3_case(torch, torch.device("cuda"), spec, 17 + i)
            args = (c["q"], c["k"], c["v"], c["npast"], c["scale"])
            got = flash_decode(*args, **c["kw"])
            ref = flash_decode_plain(*args, **c["kw"])
            emit(phase="planted_fault", fault=fault, kernel="_".join(
                ["flash_decode"] + ([c["mode"]] if c["mode"] else [])), case=c["case"],
                 rel_err=rel_of(torch, got, ref), tol=TOL)
            del c, args, got, ref
        torch.cuda.empty_cache()
    if "k4" in groups:
        from llama_cpp_gfx906_tpu_torch.ops.flash_attention import (flash_attention,
                                                                  flash_attention_plain)

        for i, spec in enumerate(kt.K4_CASES):
            c = kt.k4_case(torch, torch.device("cuda"), spec, 60 + i)
            got = flash_attention(*c["args"], **c["kw"])
            ref = flash_attention_plain(*c["args"], **c["kw"])
            emit(phase="planted_fault", fault=fault, kernel=c["name"], case=c["case"],
                 rel_err=rel_of(torch, got, ref), tol=TOL)
            del c, got, ref
        torch.cuda.empty_cache()
    if "k6" not in groups:
        return
    with tempfile.TemporaryDirectory() as tmp:
        for name, preset, L, _, synth in kt.DECODE_CASES:
            eng, path = kt.decode_engine(tmp, preset, L, **synth)
            kern = (k7.fused_decode_step if name.startswith("decode_step")
                    else k6.fused_decode_step_streamed)
            toks = torch.tensor([[7]], device=eng.device)
            errs, _, _ = decode_errors(torch, eng, kern, k6.decode_layers_plain, 1,
                                       700, toks)
            emit(phase="planted_fault", fault=fault, kernel=name,
                 layers=eng.cfg.n_layers, rel_err=errs, tol=TOL)
            del eng
            Path(path).unlink()
            torch.cuda.empty_cache()
        if fault == "moe_qk_norm_skipped":  # the qwen3moe phase's 8-step hold
            path = write_synth(f"{tmp}/qwen3moe.gguf", "qwen3moe-30b-a3b-q4_k_m", seed=0,
                               n_layers=QWEN3MOE_LAYERS)
            eng = Engine.from_gguf(path, max_seq=8192)
            emit(phase="planted_fault", fault=fault, kernel="decode_stream_moe_qk_norm",
                 layers=eng.cfg.n_layers, eight_steps=qwen3moe_routes(
                     torch, eng, prompt_ids(eng, 300)[:300]))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    if not (ROOT / "llama_cpp_gfx906_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:2] == ["--plant-faults"]:
        plant_faults(sys.argv[2:])
        return
    if sys.argv[1:2] == ["--decode-errors"]:
        decode_errors_of_copy(torch, sys.argv[2], sys.argv[3].split(","))
        return

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="card", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device_count=torch.cuda.device_count())
    phase_build(torch)
    results: dict = {}
    paths: dict = {}
    with tempfile.TemporaryDirectory() as tmpdir:
        tmp = Path(tmpdir)
        run_phase("kernel", phase_kernels, torch, results, tmp)
        got = run_phase("8b", phase_8b, torch, paths, tmp)
        if got is not None:
            run_phase("8b_fused", phase_8b_fused, torch, *got, paths)
            run_phase("8b_self_extend", phase_8b_self_extend, torch, got[0], paths)
        del got
        torch.cuda.empty_cache()
        run_phase("8b_serve", phase_8b_serve, torch, paths, tmp)
        torch.cuda.empty_cache()
        run_phase("270m_q8_0", phase_270m, torch, paths, tmp)
        torch.cuda.empty_cache()
        run_phase("mixtral_q4km", phase_mixtral_q4km, torch, paths, tmp)
        run_phase("mixtral_q8_0", phase_mixtral_q8_0, torch, paths, tmp)
        torch.cuda.empty_cache()
        eng = run_phase("gemma3_4b", phase_gemma3_4b, torch, paths, tmp)
        if eng is not None:
            run_phase("gemma3_4b_serve", phase_gemma3_4b_serve, torch, paths, tmp, eng)
        del eng
        torch.cuda.empty_cache()
        run_phase("gemma3_270m_q8_0", phase_gemma3_270m, torch, paths, tmp)
        torch.cuda.empty_cache()
        eng = run_phase("qwen3_8b", phase_qwen3_8b, torch, paths, tmp)
        if eng is not None:
            run_phase("qwen3_8b_serve", phase_qwen3_8b_serve, torch, paths, tmp, eng)
        del eng
        torch.cuda.empty_cache()
        run_phase("qwen3moe_30b_a3b", phase_qwen3moe, torch, paths, tmp)
        run_phase("qwen2_7b", phase_qwen2_7b, torch, paths, tmp)
        run_phase("qwen2moe_a2_7b", phase_qwen2moe, torch, paths, tmp)
        run_phase("mpt_7b", phase_mpt_7b, torch, paths, tmp)
        torch.cuda.empty_cache()
        run_phase("bloom_7b1", phase_bloom_7b1, torch, paths, tmp)
        torch.cuda.empty_cache()
        run_phase("gpt_oss_20b", phase_gpt_oss_20b, torch, paths, tmp)
    run_phase("tinydoc", phase_tinydoc, torch, paths)
    run_phase("tinydoc_batched", phase_tinydoc_batched, torch, paths)

    k4_bodies = check_k4_bodies(paths)
    idle = [k for k, p in KERNEL_PATH.items()
            if not paths.get(p, {}).get(COUNT_NAME.get(k, k))]
    if idle:
        fail(f"kernels never launched on their path: {idle}")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failed check(s)", file=sys.stderr)
        sys.exit(1)
    summary = []
    for name, (source, replaces) in KERNEL_INFO.items():
        r = next(r for r in results[name] if SUMMARY_CASE[name] in r["case"])
        summary.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=paths[KERNEL_PATH[name]][COUNT_NAME.get(name, name)],
            max_abs_err=max(x["max_abs_err"] for x in results[name]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        if name.startswith("flash_attention"):  # which body each K4 path took
            summary[-1]["launches_by_path"] = k4_bodies
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
