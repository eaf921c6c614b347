"""Model hyperparameters read from GGUF metadata.

Port of ``llama_cpp_gfx906_tpu/models/config.py`` for archs ``llama`` (and
its aliases ``llama2``, ``llama3``, ``mistral``, ``mixtral``,
``tinyllama``), ``gemma3`` and the qwen families: only the fields that
``models/llama.py`` and ``ops/moe.py`` read.  A file with
``{arch}.expert_count`` > 0 is an MoE model (Mixtral, qwen2moe, qwen3moe);
its routing fields take the JAX package's defaults (softmax, top-k
renormalised unless ``{arch}.expert_weights_norm`` says otherwise).
``qwen2`` and ``qwen2moe`` add q/k/v biases and NEOX rope, ``qwen3`` and
``qwen3moe`` per-head q/k RMS norms and NEOX rope (JAX
``models/config.py:225-226, 237-238``); qwen2moe's shared expert takes its
width from its tensors, as the JAX loader does (the file's
``{arch}.expert_shared_feed_forward_length`` says the same).  ``gemma3``
takes the JAX package's gemma branch: gelu-tanh, the embedding scaled by
sqrt(D), per-head q/k RMS norms, post-attention and post-FFN norms, NEOX
rope, and interleaved sliding windows (every 6th layer global) whose
layers rotate with a local rope base, unscaled.  ``mpt`` and ``bloom``
take the JAX ALiBi branches (``models/config.py:369-391``): LayerNorm with
the eps of ``{arch}.attention.layer_norm_epsilon``, no positional
embedding, ALiBi slopes on the attention scores and an ungated FFN
(gelu-erf for mpt; gelu-tanh, biases everywhere and a norm after the
embedding for bloom).  ``gpt-oss`` takes the JAX branch
(``models/config.py:321-329``): NEOX rope, alternating sliding windows
(``swa_pattern`` 2: even layers windowed), a router whose top-k logits
are softmaxed, and the ``swiglu_oai`` expert activation (gate clamped
above and up clamped to +-``swiglu_limit``, ``(up + 1) g sigmoid(1.702 g)``);
its attention sinks, router bias and expert biases come from its tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

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
    sliding_window: int = 0  # the window of the SWA layers (swa_layers)
    swa_pattern: int = 1  # every n-th layer is full attention (iSWA); 1: none
    attn_scale: float = 0.0  # 0 -> 1/sqrt(head_dim)
    # gemma3: SWA layers rotate with this base (rope scaling off); 0: one base
    rope_local_base: float = 0.0
    qk_norm: bool = False  # per-head q/k RMS norms before rope
    post_attn_norm: bool = False  # RMS norm of the attention output
    post_ffn_norm: bool = False  # RMS norm of the FFN output
    embedding_scale: float = 1.0  # gemma multiplies the embedding by sqrt(D)
    # "silu" | "gelu" / "gelu_tanh" (tanh form) | "gelu_erf" | "swiglu_oai" (experts)
    act_fn: str = "silu"
    attn_logit_softcap: float = 0.0  # gemma2's; the port refuses it (gates)
    n_experts: int = 0  # > 0: every layer's FFN is routed (ops/moe.py)
    n_experts_used: int = 0
    expert_ff: int = 0
    expert_weights_norm: bool = False  # renormalise the top-k probabilities
    expert_weights_scale: float = 1.0
    expert_gating_func: int = 1  # 1 softmax, 2 sigmoid (LLAMA_EXPERT_GATING_FUNC_*)
    moe_topk_softmax: bool = False  # gpt-oss: softmax over the top-k logits
    moe_scale_input: bool = False  # llama4's variant: ops/moe.py refuses it
    swiglu_limit: float = 7.0  # gpt-oss's swiglu_oai clamp
    attn_bias: bool = False  # q/k/v biases (qwen2, qwen2moe, bloom)
    norm_type: str = "rms"  # "rms" | "layer" (LayerNorm, with optional bias)
    pos_emb: str = "rope"  # "rope" | "none" (mpt, bloom: ALiBi only)
    alibi: bool = False  # mpt/bloom positional bias on the attention scores
    ffn_gated: bool = True  # False: the 2-matrix MLP act(x W_up + b) W_down + b

    @property
    def swa_layers(self) -> tuple[bool, ...]:
        """Per-layer sliding-window flags (True: windowed), as JAX
        ``ModelConfig.swa_layers``: with pattern n, layer il is full
        attention when (il + 1) % n == 0."""
        if self.sliding_window <= 0:
            return (False,) * self.n_layers
        n = max(self.swa_pattern, 1)
        if n == 1:
            return (True,) * self.n_layers
        return tuple((il + 1) % n != 0 for il in range(self.n_layers))

    @property
    def layer_windows(self) -> tuple[int, ...]:
        """Each layer's attention window (0: full attention)."""
        return tuple(self.sliding_window if w else 0 for w in self.swa_layers)


def sub_config(cfg: ModelConfig, first: int, n: int) -> ModelConfig:
    """The config of layers [first, first + n) run as a stack of their own,
    each layer keeping its SWA flag (its window and rope table): a pattern
    that starts at layer 0 reproduces their flags, or this raises."""
    want = cfg.swa_layers[first:first + n]
    if not any(want):
        return replace(cfg, n_layers=n, sliding_window=0)
    for pattern in range(1, n + 2):
        sub = replace(cfg, n_layers=n, swa_pattern=pattern)
        if sub.swa_layers == want:
            return sub
    raise ValueError(f"layers {first}..{first + n - 1}: no SWA pattern gives {want}")


# the archs the port loads: the llama graph under its names, gemma3, qwen,
# the ALiBi families, gpt-oss
LLAMA_ARCHS = ("llama", "llama2", "llama3", "mistral", "mixtral", "tinyllama")
QWEN_ARCHS = ("qwen2", "qwen2moe", "qwen3", "qwen3moe")
ALIBI_ARCHS = ("mpt", "bloom")
ARCHS = LLAMA_ARCHS + ("gemma3",) + QWEN_ARCHS + ALIBI_ARCHS + ("gpt-oss",)


def config_from_gguf(reader) -> ModelConfig:
    arch = reader.architecture
    covers = "the port covers " + ", ".join(repr(a) for a in ARCHS)
    if arch in ("gemma", "gemma2"):
        raise NotImplementedError(
            f"arch {arch!r}: Gemma (v1) and Gemma 2 (attention and final-logit "
            f"softcaps) are not ported; {covers}")
    if arch not in ARCHS:
        raise NotImplementedError(f"arch {arch!r}: {covers}")

    def g(key, default=None):
        v = reader.get(key, arch=arch)
        return default if v is None else v

    n_embd = int(g(Keys.LLM.EMBEDDING_LENGTH))
    n_heads = int(g(Keys.Attention.HEAD_COUNT))
    head_dim = int(g(Keys.Attention.KEY_LENGTH, n_embd // n_heads))
    n_vocab = g(Keys.LLM.VOCAB_SIZE)
    if n_vocab is None:
        n_vocab = len(reader.get(Keys.Tokenizer.LIST) or [])
    cfg = ModelConfig(
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
        n_experts=int(g(Keys.LLM.EXPERT_COUNT, 0)),
        n_experts_used=int(g(Keys.LLM.EXPERT_USED_COUNT, 0)),
        expert_ff=int(g(Keys.LLM.EXPERT_FEED_FORWARD_LENGTH, 0)),
        # mixtral and qwen3moe renormalise the selected expert probabilities
        # (the key absent: true, as the JAX package reads it); the JAX
        # package reads no gating function for these archs (softmax)
        expert_weights_norm=bool(g(Keys.LLM.EXPERT_WEIGHTS_NORM, True)),
        expert_weights_scale=float(g(Keys.LLM.EXPERT_WEIGHTS_SCALE, 1.0)),
    )
    if arch in ("qwen2", "qwen2moe"):  # JAX models/config.py:225-226
        cfg = replace(cfg, attn_bias=True, rope_interleaved=False)
    elif arch in ("qwen3", "qwen3moe"):  # :237-238
        cfg = replace(cfg, qk_norm=True, rope_interleaved=False)
    if arch == "gemma3":  # JAX models/config.py, the gemma branch
        cfg = replace(
            cfg, rope_interleaved=False, act_fn="gelu",
            embedding_scale=float(n_embd) ** 0.5, post_attn_norm=True,
            post_ffn_norm=True, qk_norm=True, swa_pattern=6,
            attn_scale=float(g(Keys.Attention.SCALE, 0.0)),
            rope_local_base=float(g(Keys.Rope.LOCAL_FREQ_BASE, 10000.0)))
    if arch in ALIBI_ARCHS:  # JAX models/config.py:369-391
        cfg = replace(
            cfg, norm_type="layer", rms_eps=float(g(Keys.Attention.LAYERNORM_EPS, 1e-5)),
            pos_emb="none", alibi=True, ffn_gated=False,
            act_fn="gelu_erf" if arch == "mpt" else "gelu_tanh",
            attn_bias=arch == "bloom")
    if arch == "gpt-oss":  # JAX models/config.py:321-329
        cfg = replace(cfg, rope_interleaved=False, swa_pattern=2,
                      moe_topk_softmax=True, act_fn="swiglu_oai")
    return cfg
