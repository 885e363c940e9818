"""Kubernetes SubjectAccessReview authorization (semantics: ref
pkg/evaluators/authorization/kubernetes_authz.go:24-120): user/groups plus
resource- or non-resource attributes resolved from the Authorization JSON."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ...authjson.value import JSONValue, stringify_json
from ...k8s.client import ClusterReader
from ..base import EvaluationError


class KubernetesAuthz:
    def __init__(
        self,
        name: str,
        user: JSONValue,
        groups: Optional[List[str]] = None,
        resource_attributes: Optional[Dict[str, JSONValue]] = None,
        cluster: Optional[ClusterReader] = None,
    ):
        self.name = name
        self.user = user
        self.groups = groups or []
        # keys: namespace, group, resource, name, subresource, verb
        self.resource_attributes = resource_attributes or {}
        self.cluster = cluster

    async def call(self, pipeline) -> Any:
        if self.cluster is None:
            raise EvaluationError("kubernetes cluster access is not configured")
        doc = pipeline.authorization_json()
        spec: Dict[str, Any] = {"user": stringify_json(self.user.resolve_for(doc))}
        if self.groups:
            spec["groups"] = self.groups
        if self.resource_attributes:
            spec["resourceAttributes"] = {
                k: stringify_json(v.resolve_for(doc))
                for k, v in self.resource_attributes.items()
            }
        else:
            # non-resource attributes: path + lower-cased verb (ref :75-86)
            spec["nonResourceAttributes"] = {
                "path": doc["request"]["url_path"],
                "verb": str(doc["request"]["method"]).lower(),
            }
        review = await self.cluster.subject_access_review(spec)
        status = review.get("status", {})
        if not status.get("allowed"):
            reason = status.get("reason", "")
            raise EvaluationError(f"Not authorized: {reason}" if reason else "Not authorized")
        return True
