"""Kubernetes access seam: the cluster reader protocol and the in-memory
cluster."""

from .client import ClusterReader, InMemoryCluster, LabelSelector, Secret  # noqa: F401
