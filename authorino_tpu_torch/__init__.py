"""PyTorch / CUDA port of authorino-tpu's policy-evaluation main path.

Policy compile → micro-batched evaluation → verdicts on one NVIDIA card:
``compiler`` (compile, encode, pack; numpy), ``ops`` (the fused-lane
operands and the hand-written CUDA mega-kernel), ``models.PolicyModel`` and
``runtime.PolicyEngine``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``, which runs the kernel's plain PyTorch
version instead."""

__version__ = "0.1.0"
