"""The policy model: a compiled corpus plus its batched evaluation."""

from .policy_model import PolicyModel  # noqa: F401
