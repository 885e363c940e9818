"""Mesh layer: dp (batch) x mp (rules/configs) policy evaluation."""

from .sharded_eval import Mesh, ShardedPolicyModel, build_mesh  # noqa: F401
