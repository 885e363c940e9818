"""Festival Wristband: issues a short-lived signed JWT carrying
iss/iat/exp/sub=sha256(resolved identity) + custom claims; serves OpenID
discovery + JWKS documents
(semantics: ref pkg/evaluators/response/wristband.go:20-181)."""

from __future__ import annotations

import hashlib
import json as _json
import time
from dataclasses import dataclass
from typing import Any, List, Optional

from ...authjson.value import JSONProperty
from ...utils import jose, pki
from ..base import EvaluationError

DEFAULT_WRISTBAND_DURATION = 300


@dataclass
class SigningKey:
    kid: str
    algorithm: str  # ES256 | ES384 | ES512 | RS256 | RS384 | RS512
    private_key: Any

    @classmethod
    def from_pem(cls, name: str, algorithm: str, pem: bytes) -> "SigningKey":
        """(ref :22-56 — EC or RSA private keys)"""
        try:
            key = pki.load_pem_private_key(pem)
        except Exception as e:
            raise ValueError(f"failed to decode PEM file: {e}")
        return cls(kid=name, algorithm=algorithm, private_key=key)

    def public_jwk(self) -> dict:
        return jose.jwk_from_public_key(
            self.private_key.public_key(), kid=self.kid, alg=self.algorithm
        )


class Wristband:
    def __init__(
        self,
        issuer: str,
        custom_claims: Optional[List[JSONProperty]] = None,
        token_duration: Optional[int] = None,
        signing_keys: Optional[List[SigningKey]] = None,
    ):
        if not signing_keys:
            raise ValueError("missing at least one signing key")
        self.issuer = issuer
        self.custom_claims = custom_claims or []
        self.token_duration = token_duration if token_duration is not None else DEFAULT_WRISTBAND_DURATION
        self.signing_keys = signing_keys

    async def call(self, pipeline) -> Any:
        id_config, resolved_identity = pipeline.resolved_identity()
        # pass-through: if the identity is itself a wristband from this issuer
        # (ref :94-100 compares the resolved OIDC endpoint to the issuer)
        oidc = getattr(id_config, "evaluator", None)
        if oidc is not None and getattr(oidc, "endpoint", None) == self.issuer:
            return None

        # sub = sha256 of the marshaled identity object (ref :102-104)
        identity_json = _json.dumps(resolved_identity, separators=(",", ":"), sort_keys=True)
        sub = hashlib.sha256(identity_json.encode()).hexdigest()

        iat = int(time.time())
        claims = {
            "iss": self.issuer,
            "iat": iat,
            "exp": iat + int(self.token_duration),
            "sub": sub,
        }
        if self.custom_claims:
            doc = pipeline.authorization_json()
            for prop in self.custom_claims:
                claims[prop.name] = prop.value.resolve_for(doc)

        key = self.signing_keys[0]
        try:
            return jose.sign_jwt(claims, key.private_key, key.algorithm, kid=key.kid)
        except jose.JoseError as e:
            raise EvaluationError(str(e))

    # --- WristbandIssuer (ref :150-178) ---

    def get_issuer(self) -> str:
        return self.issuer

    def openid_config(self) -> str:
        return _json.dumps(
            {
                "issuer": self.issuer,
                "jwks_uri": f"{self.issuer}/.well-known/openid-connect/certs",
            }
        )

    def jwks(self) -> str:
        return _json.dumps({"keys": [k.public_jwk() for k in self.signing_keys]})
