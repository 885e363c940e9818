"""Kubernetes access seam: the cluster reader protocol, the in-memory and
REST clusters, and lease-based leader election."""

from .client import ClusterReader, InMemoryCluster, LabelSelector, RestCluster, Secret  # noqa: F401
from .leader import InMemoryLeases, LeaderElector, Lease  # noqa: F401
