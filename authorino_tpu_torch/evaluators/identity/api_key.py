"""API-key identity: trusted keys from labeled cluster Secrets, live
add/revoke from the secret reconciler
(semantics: ref pkg/evaluators/identity/api_key.go:23-155)."""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ...k8s.client import ClusterReader, LabelSelector, Secret
from ..base import EvaluationError
from ..credentials import AuthCredentials, CredentialNotFound

API_KEY_SELECTOR = "api_key"
INVALID_API_KEY_MSG = "the API Key provided is invalid"


class APIKey:
    def __init__(
        self,
        name: str,
        label_selector: LabelSelector,
        namespace: str = "",
        credentials: Optional[AuthCredentials] = None,
        cluster: Optional[ClusterReader] = None,
    ):
        self.name = name
        self.label_selector = label_selector
        self.namespace = namespace
        self.credentials = credentials or AuthCredentials()
        self.cluster = cluster
        self._secrets: Dict[str, Secret] = {}  # api-key value → Secret
        self._lock = threading.RLock()

    async def load_secrets(self) -> None:
        """(ref :51-69)"""
        if self.cluster is None:
            return
        secrets = await self.cluster.list_secrets(
            self.label_selector, self.namespace or None
        )
        with self._lock:
            for secret in secrets:
                self._append(secret)

    async def call(self, pipeline):
        try:
            req_key = self.credentials.extract(pipeline.request.http)
        except CredentialNotFound as e:
            raise EvaluationError(str(e))
        with self._lock:
            secret = self._secrets.get(req_key)
        if secret is None:
            raise EvaluationError(INVALID_API_KEY_MSG)
        return secret.to_identity_object()

    def snapshot_secrets(self) -> Dict[str, Secret]:
        """Point-in-time copy of the key→Secret map — the native frontend
        resolves each key's ``auth.identity.*`` pattern operands to
        constants at refresh time (the fast-lane analog of the per-request
        map lookup, ref :72-93)."""
        with self._lock:
            return dict(self._secrets)

    # --- K8sSecretBasedIdentity (ref :95-140) ---

    def get_k8s_secret_label_selectors(self) -> LabelSelector:
        return self.label_selector

    def add_k8s_secret_based_identity(self, new: Secret) -> bool:
        """Returns True when the key map actually changed."""
        if not self._within_scope(new.namespace):
            return False
        with self._lock:
            new_value = new.data.get(API_KEY_SELECTOR, b"").decode()
            for old_value, current in list(self._secrets.items()):
                if current.namespace == new.namespace and current.name == new.name:
                    if old_value != new_value:
                        self._append(new)
                        del self._secrets[old_value]
                        return True
                    # same key value: refresh the stored Secret (its
                    # labels and annotations are the identity object)
                    changed = current.to_identity_object() != new.to_identity_object()
                    self._secrets[old_value] = new
                    return changed
            return self._append(new)

    def revoke_k8s_secret_based_identity(self, namespace: str, name: str) -> bool:
        if not self._within_scope(namespace):
            return False
        with self._lock:
            for key, secret in list(self._secrets.items()):
                if secret.namespace == namespace and secret.name == name:
                    del self._secrets[key]
                    return True
        return False

    def _within_scope(self, namespace: str) -> bool:
        return not self.namespace or self.namespace == namespace

    def _append(self, secret: Secret) -> bool:
        value = secret.data.get(API_KEY_SELECTOR, b"")
        if value:
            self._secrets[value.decode()] = secret
            return True
        return False
