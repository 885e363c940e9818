"""Rule compiler, request encoder and wire packer (numpy, host side)."""

from .compile import CompiledPolicy, ConfigRules, compile_corpus  # noqa: F401
from .encode import EncodedBatch, encode_batch  # noqa: F401
from .intern import EMPTY_ID, PAD, UNSEEN, StringInterner  # noqa: F401
