"""Device layer: the fused-lane operands and the mega-kernel."""

from .fused_kernel import dispatch_megakernel, eval_fused_kernel  # noqa: F401
from .operands import to_device, unpack_verdicts  # noqa: F401
