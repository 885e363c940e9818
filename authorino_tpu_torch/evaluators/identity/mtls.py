"""mTLS / X.509 identity: trusted root CAs from labeled cluster Secrets
(`tls.crt`/`ca.crt`), verifies the PEM certificate Envoy forwards in
``source.certificate``, resolves the cert subject (+SANs) as the identity
(semantics: ref pkg/evaluators/identity/mtls.go:23-189).

Certificates are read by the port's own X.509 reader (``utils/x509.py``)
and signatures checked by ``utils/pki.py``: RSA PKCS#1 v1.5 and ECDSA, with
the hash the certificate's signature algorithm names.  A signature or CA
key of any other kind (RSA-PSS, Ed25519) is "not signed by that CA"."""

from __future__ import annotations

import threading
import urllib.parse
from datetime import datetime, timezone
from typing import Dict, Optional

from ...k8s.client import ClusterReader, LabelSelector, Secret
from ...utils import pki, x509
from ..base import EvaluationError
from ..credentials import AuthCredentials

CA_KEYS = ("ca.crt", "tls.crt")


def _verify_signed_by(cert: x509.Certificate, ca: x509.Certificate) -> bool:
    if cert.issuer != ca.subject:
        return False
    pub = ca.public_key
    bits = cert.signature_hash_bits
    try:
        if bits is None:
            return False
        if isinstance(pub, pki.RSAPublicKey):
            pub.verify(cert.signature, cert.tbs_certificate_bytes,
                       "PKCS1v15", bits)
        elif isinstance(pub, pki.ECPublicKey):
            pub.verify(x509.ecdsa_signature(cert.signature),
                       cert.tbs_certificate_bytes, bits)
        else:
            return False
        return True
    except Exception:
        return False


class MTLS:
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
        self._cas: Dict[tuple, x509.Certificate] = {}  # (ns, name) → CA cert
        self._pems: Dict[tuple, bytes] = {}            # (ns, name) → raw PEM
        self._lock = threading.RLock()

    async def load_secrets(self) -> None:
        if self.cluster is None:
            return
        secrets = await self.cluster.list_secrets(self.label_selector, self.namespace or None)
        with self._lock:
            for secret in secrets:
                self._append(secret)

    async def call(self, pipeline):
        pem = urllib.parse.unquote(pipeline.request.source.certificate or "")
        if not pem:
            raise EvaluationError("client certificate is missing")
        try:
            cert = x509.load_pem_x509_certificate(pem.encode())
        except Exception as e:
            raise EvaluationError(f"invalid client certificate: {e}")
        now = datetime.now(timezone.utc)
        if now < cert.not_valid_before_utc or now > cert.not_valid_after_utc:
            raise EvaluationError("certificate has expired or is not yet valid")
        with self._lock:
            cas = list(self._cas.values())
        if not any(_verify_signed_by(cert, ca) for ca in cas):
            raise EvaluationError("x509: certificate signed by unknown authority")
        subject: Dict[str, object] = {}
        for attr in cert.subject:
            key = {
                "commonName": "CommonName",
                "organizationName": "Organization",
                "organizationalUnitName": "OrganizationalUnit",
                "countryName": "Country",
                "localityName": "Locality",
                "stateOrProvinceName": "Province",
                "streetAddress": "StreetAddress",
                "postalCode": "PostalCode",
                "serialNumber": "SerialNumber",
            }.get(attr.name, attr.name)
            subject[key] = attr.value
        dns_names = cert.dns_names()
        if dns_names is not None:
            subject["DNSNames"] = dns_names
        return subject

    # --- K8sSecretBasedIdentity ---

    def get_k8s_secret_label_selectors(self) -> LabelSelector:
        return self.label_selector

    def add_k8s_secret_based_identity(self, new: Secret) -> bool:
        """True only when the CA pool actually changed (PEM-byte compare —
        informer resyncs of unchanged secrets must not trigger the native
        frontend's snapshot rebuild)."""
        if self.namespace and new.namespace != self.namespace:
            return False
        with self._lock:
            before = self._pems.get(new.key)
            self._append(new)
            return self._pems.get(new.key) != before

    def revoke_k8s_secret_based_identity(self, namespace: str, name: str) -> bool:
        if self.namespace and namespace != self.namespace:
            return False
        with self._lock:
            self._pems.pop((namespace, name), None)
            return self._cas.pop((namespace, name), None) is not None

    def _append(self, secret: Secret) -> None:
        for key in CA_KEYS:
            pem = secret.data.get(key)
            if not pem:
                continue
            try:
                self._cas[secret.key] = x509.load_pem_x509_certificate(pem)
                self._pems[secret.key] = pem
                return
            except Exception:
                continue
