"""Kubernetes TokenReview identity (semantics: ref
pkg/evaluators/identity/kubernetes_auth.go:26-99): reviews the bearer token
in-cluster; default audience is the request host (ref :81-88)."""

from __future__ import annotations

from typing import List, Optional

from ...k8s.client import ClusterReader
from ..base import EvaluationError
from ..credentials import AuthCredentials, CredentialNotFound


class KubernetesAuth:
    def __init__(
        self,
        name: str,
        audiences: Optional[List[str]] = None,
        credentials: Optional[AuthCredentials] = None,
        cluster: Optional[ClusterReader] = None,
    ):
        self.name = name
        self.audiences = audiences or []
        self.credentials = credentials or AuthCredentials()
        self.cluster = cluster

    def _audiences_with_default(self, host: str) -> List[str]:
        return self.audiences if self.audiences else [host]

    async def call(self, pipeline):
        if self.cluster is None:
            raise EvaluationError("kubernetes cluster access is not configured")
        try:
            token = self.credentials.extract(pipeline.request.http)
        except CredentialNotFound as e:
            raise EvaluationError(str(e))
        review = await self.cluster.token_review(
            token, self._audiences_with_default(pipeline.request.host())
        )
        status = review.get("status", {})
        if not status.get("authenticated"):
            raise EvaluationError(
                f"Not authenticated: {status.get('error', 'invalid bearer token')}"
            )
        return status.get("user", {})
