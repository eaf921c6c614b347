"""GGUF file-format and ggml tensor-type constants (the subset the port reads).

The GGUF container format is public and fixed: magic ``GGUF``, version 3,
little-endian, typed KV metadata, aligned tensor data.  The numeric values
below are part of the on-disk format.
"""

from __future__ import annotations

import enum

GGUF_MAGIC = 0x46554747  # b"GGUF" little-endian
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

QK_K = 256  # superblock size for K-quants


class GGUFValueType(enum.IntEnum):
    """Metadata value types in the GGUF KV section."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """ggml tensor dtypes as stored in GGUF tensor infos (values are on-disk)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35
    MXFP4 = 39


# (block_size_in_elements, bytes_per_block) per type, so that any file's
# header parses; the port decodes only the types in gguf/quants.py.
GGML_BLOCK_SIZES: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 2 + 16),
    GGMLType.Q4_1: (32, 2 + 2 + 16),
    GGMLType.Q5_0: (32, 2 + 4 + 16),
    GGMLType.Q5_1: (32, 2 + 2 + 4 + 16),
    GGMLType.Q8_0: (32, 2 + 32),
    GGMLType.Q8_1: (32, 2 + 2 + 32),
    GGMLType.Q2_K: (QK_K, 16 + QK_K // 4 + 2 + 2),
    GGMLType.Q3_K: (QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),
    GGMLType.Q4_K: (QK_K, 2 + 2 + 12 + QK_K // 2),
    GGMLType.Q5_K: (QK_K, 2 + 2 + 12 + QK_K // 8 + QK_K // 2),
    GGMLType.Q6_K: (QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
    GGMLType.Q8_K: (QK_K, 4 + QK_K + QK_K // 16 * 2),
    GGMLType.MXFP4: (32, 1 + 16),
    GGMLType.TQ1_0: (QK_K, 2 + 4 * 13),
    GGMLType.TQ2_0: (QK_K, 2 + 64),
    GGMLType.IQ4_NL: (32, 2 + 16),
    GGMLType.IQ4_XS: (QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),
    # codebook i-quants (sizes: reference gguf-py constants.py:2854-2869)
    GGMLType.IQ2_XXS: (QK_K, 2 + QK_K // 4),
    GGMLType.IQ2_XS: (QK_K, 2 + QK_K // 4 + QK_K // 32),
    GGMLType.IQ2_S: (QK_K, 2 + QK_K // 4 + QK_K // 16),
    GGMLType.IQ3_XXS: (QK_K, 2 + QK_K // 4 + QK_K // 8),
    GGMLType.IQ3_S: (QK_K, 2 + QK_K // 4 + QK_K // 32 + QK_K // 8 + QK_K // 64),
    GGMLType.IQ1_S: (QK_K, 2 + QK_K // 8 + QK_K // 16),
    GGMLType.IQ1_M: (QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),
}


class Keys:
    """GGUF metadata keys this slice reads (``{arch}`` is substituted)."""

    class General:
        ARCHITECTURE = "general.architecture"
        ALIGNMENT = "general.alignment"

    class Split:
        COUNT = "split.count"
        TENSORS_COUNT = "split.tensors.count"

    class LLM:
        CONTEXT_LENGTH = "{arch}.context_length"
        EMBEDDING_LENGTH = "{arch}.embedding_length"
        BLOCK_COUNT = "{arch}.block_count"
        FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
        EXPERT_COUNT = "{arch}.expert_count"
        VOCAB_SIZE = "{arch}.vocab_size"

    class Attention:
        HEAD_COUNT = "{arch}.attention.head_count"
        HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
        KEY_LENGTH = "{arch}.attention.key_length"
        LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
        SLIDING_WINDOW = "{arch}.attention.sliding_window"

    class Rope:
        DIMENSION_COUNT = "{arch}.rope.dimension_count"
        FREQ_BASE = "{arch}.rope.freq_base"
        SCALING_TYPE = "{arch}.rope.scaling.type"
        SCALING_FACTOR = "{arch}.rope.scaling.factor"
        SCALING_ORIG_CTX_LEN = "{arch}.rope.scaling.original_context_length"
        SCALING_LOW_FREQ_FACTOR = "{arch}.rope.scaling.low_freq_factor"
        SCALING_HIGH_FREQ_FACTOR = "{arch}.rope.scaling.high_freq_factor"

    class Tokenizer:
        MODEL = "tokenizer.ggml.model"
        PRE = "tokenizer.ggml.pre"
        LIST = "tokenizer.ggml.tokens"
        TOKEN_TYPE = "tokenizer.ggml.token_type"
        SCORES = "tokenizer.ggml.scores"
        BOS_ID = "tokenizer.ggml.bos_token_id"
        EOS_ID = "tokenizer.ggml.eos_token_id"
        EOT_ID = "tokenizer.ggml.eot_token_id"
        EOM_ID = "tokenizer.ggml.eom_token_id"
        UNK_ID = "tokenizer.ggml.unknown_token_id"
        ADD_BOS = "tokenizer.ggml.add_bos_token"
        ADD_EOS = "tokenizer.ggml.add_eos_token"
        ADD_PREFIX = "tokenizer.ggml.add_space_prefix"


class TokenType(enum.IntEnum):
    """tokenizer.ggml.token_type values."""

    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6


class RopeScalingType(enum.IntEnum):
    NONE = 0
    LINEAR = 1
    YARN = 2
    LONGROPE = 3
