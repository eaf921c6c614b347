"""GGUF format layer: constants, block codecs, reader, writer."""

from .constants import GGML_BLOCK_SIZES, QK_K, GGMLType, Keys, RopeScalingType  # noqa: F401
from .reader import GGUFModelReader, GGUFReader, TensorInfo  # noqa: F401
from .writer import GGUFWriter  # noqa: F401
