"""Pattern-expression layer: the DSL that compiles to device tensors."""

from .ast import (  # noqa: F401
    All,
    And,
    Any_,
    Expression,
    InGroup,
    Operator,
    Or,
    Pattern,
    PatternError,
    TRUE,
    FALSE,
)
