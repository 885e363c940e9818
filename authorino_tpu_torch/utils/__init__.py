"""Host utilities shared by the compiler and the engine."""

__all__ = ["bucket_pow2"]


def bucket_pow2(n: int, minimum: int = 16) -> int:
    """Round up to the next power-of-two bucket (≥ minimum) — the shared
    policy that pins jit-variant counts for batch sizes (runtime/engine.py)
    and byte-tensor widths (compiler/pack.py)."""
    b = minimum
    while b < n:
        b *= 2
    return b
