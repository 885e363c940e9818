"""Compiled relations: hierarchical entity/group membership precomputed at
compile time into per-snapshot bitmatrix relation tables (closure.py)."""

from .closure import RelationClosure

__all__ = ["RelationClosure"]
