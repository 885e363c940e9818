"""Device layer: the lanes' operands, the mega-kernel and the lane router."""

from .fused_kernel import dispatch_megakernel, eval_fused_kernel  # noqa: F401
from .operands import unpack_verdicts  # noqa: F401
from .pattern_eval import dispatch_fused, to_device  # noqa: F401
