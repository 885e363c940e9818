"""OIDC UserInfo metadata, bound to a resolved OIDC identity of the same
issuer (semantics: ref pkg/evaluators/metadata/user_info.go:22-109)."""

from __future__ import annotations

from ...utils import http as http_util
from ..base import EvaluationError
from ..credentials import CredentialNotFound
from ..identity.oidc import OIDC


class UserInfo:
    def __init__(self, oidc: OIDC):
        self.oidc = oidc

    async def call(self, pipeline):
        # the identity that resolved must come from the same OIDC issuer
        id_config, _ = pipeline.resolved_identity()
        resolved_oidc = getattr(id_config, "evaluator", None)
        if resolved_oidc is not self.oidc:
            raise EvaluationError(
                f"Missing identity for OIDC issuer {self.oidc.endpoint}. "
                "Skipping related UserInfo metadata."
            )
        await self.oidc._ensure_loaded()
        endpoint = self.oidc.get_url("userinfo_endpoint")
        if not endpoint:
            raise EvaluationError("provider has no userinfo endpoint")
        try:
            token = self.oidc.credentials.extract(pipeline.request.http)
        except CredentialNotFound as e:
            raise EvaluationError(str(e))
        try:
            return http_util.parse_response(await http_util.request(
                "GET", endpoint, headers={"Authorization": f"Bearer {token}"}))
        except http_util.HttpError as e:
            raise EvaluationError(str(e))
