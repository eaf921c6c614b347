"""Model hyperparameters read from GGUF metadata.

Port of ``llama_cpp_gfx906_tpu/models/config.py`` for arch ``llama``: only
the fields that ``models/llama.py`` reads on this slice's path.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..gguf.constants import Keys, RopeScalingType

_ROPE_SCALING_NAMES = {
    "none": RopeScalingType.NONE,
    "linear": RopeScalingType.LINEAR,
    "yarn": RopeScalingType.YARN,
    "longrope": RopeScalingType.LONGROPE,
}


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    n_layers: int
    n_embd: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    n_ff: int
    n_vocab: int
    n_ctx_train: int
    rms_eps: float = 1e-5
    rope_dim: int = 0  # 0 -> full head_dim
    rope_base: float = 10000.0
    rope_interleaved: bool = True  # ggml NORM mode (llama); False = NEOX
    rope_scaling: RopeScalingType = RopeScalingType.NONE
    rope_scale: float = 1.0
    rope_orig_ctx: int = 0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    sliding_window: int = 0  # every layer windowed when > 0 (mistral style)
    attn_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)


def config_from_gguf(reader) -> ModelConfig:
    arch = reader.architecture
    if arch != "llama":
        raise NotImplementedError(f"arch {arch!r}: the port covers 'llama' only")

    def g(key, default=None):
        v = reader.get(key, arch=arch)
        return default if v is None else v

    if int(g(Keys.LLM.EXPERT_COUNT, 0)):
        raise NotImplementedError("MoE llama models are not ported yet")
    n_embd = int(g(Keys.LLM.EMBEDDING_LENGTH))
    n_heads = int(g(Keys.Attention.HEAD_COUNT))
    head_dim = int(g(Keys.Attention.KEY_LENGTH, n_embd // n_heads))
    n_vocab = g(Keys.LLM.VOCAB_SIZE)
    if n_vocab is None:
        n_vocab = len(reader.get(Keys.Tokenizer.LIST) or [])
    return ModelConfig(
        arch=arch,
        n_layers=int(g(Keys.LLM.BLOCK_COUNT)),
        n_embd=n_embd,
        n_heads=n_heads,
        n_kv_heads=int(g(Keys.Attention.HEAD_COUNT_KV, n_heads)),
        head_dim=head_dim,
        n_ff=int(g(Keys.LLM.FEED_FORWARD_LENGTH)),
        n_vocab=int(n_vocab),
        n_ctx_train=int(g(Keys.LLM.CONTEXT_LENGTH, 2048)),
        rms_eps=float(g(Keys.Attention.LAYERNORM_RMS_EPS, 1e-5)),
        rope_dim=int(g(Keys.Rope.DIMENSION_COUNT, head_dim)),
        rope_base=float(g(Keys.Rope.FREQ_BASE, 10000.0)),
        rope_scaling=_ROPE_SCALING_NAMES.get(
            str(g(Keys.Rope.SCALING_TYPE, "none")), RopeScalingType.NONE),
        rope_scale=float(g(Keys.Rope.SCALING_FACTOR, 1.0)),
        rope_orig_ctx=int(g(Keys.Rope.SCALING_ORIG_CTX_LEN, 0)),
        rope_low_freq_factor=float(g(Keys.Rope.SCALING_LOW_FREQ_FACTOR, 1.0)),
        rope_high_freq_factor=float(g(Keys.Rope.SCALING_HIGH_FREQ_FACTOR, 4.0)),
        sliding_window=int(g(Keys.Attention.SLIDING_WINDOW, 0)),
    )
