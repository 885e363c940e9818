"""X.509 certificates on the DER reader of ``utils/pki.py``: what the mTLS
identity (``evaluators/identity/mtls.py``) reads of a client certificate
and of a trusted CA, without ``cryptography`` (the card's machine is not
held to have it).

``load_pem_x509_certificate`` reads the first ``CERTIFICATE`` block of a
PEM (a bundle contributes its first certificate, as cryptography's loader
reads it) and ``load_der_x509_certificate`` one DER certificate.  A
``Certificate`` exposes:

- ``tbs_certificate_bytes``, ``signature``, ``signature_algorithm_oid``
  and ``signature_hash_bits`` (``"1"``, ``"224"``, ``"256"``, ``"384"``,
  ``"512"``, or None for an algorithm with no such hash: RSA-PSS, Ed25519,
  an unknown OID);
- ``issuer`` and ``subject`` as ``Name``s: RDN sequences of (OID, value)
  attributes.  Two names are equal when their RDNs are equal as sets of
  (OID, value): the string type is ignored, as cryptography's
  ``NameAttribute.__eq__`` ignores it, so a PrintableString and a
  UTF8String of the same text are equal;
- ``not_valid_before_utc`` and ``not_valid_after_utc`` (UTCTime years 50-99
  are 19xx; GeneralizedTime is read too);
- ``dns_names()``: the SubjectAlternativeName's DNS names, ``[]`` for a
  SAN without any, None without the extension;
- ``public_key``: a ``pki.RSAPublicKey``, a ``pki.ECPublicKey`` (P-256,
  P-384, P-521), or None for any other key type.

A malformed certificate raises ValueError.  ``ecdsa_signature`` decodes a
DER ``(r, s)``.
"""

from __future__ import annotations

import base64
import datetime
import re
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple, Union

from . import pki

__all__ = ["Certificate", "Name", "NameAttribute", "OID_NAMES",
           "load_pem_x509_certificate", "load_der_x509_certificate",
           "ecdsa_signature"]

_SEQ, _SET, _INT, _BITS, _OCTETS, _OID = 0x30, 0x31, 0x02, 0x03, 0x04, 0x06
_UTC_TIME, _GENERALIZED_TIME = 0x17, 0x18
_BMP_STRING, _UNIVERSAL_STRING = 0x1E, 0x1C
_SAN_OID = "2.5.29.17"
_DNS_NAME_TAG = 0x82  # GeneralName dNSName: [2] IMPLICIT IA5String

# the names cryptography gives name-attribute OIDs (``ObjectIdentifier.
# _name``, cryptography 46); any other OID is "Unknown OID"
OID_NAMES = {
    "0.9.2342.19200300.100.1.1": "userID",
    "0.9.2342.19200300.100.1.25": "domainComponent",
    "1.2.643.100.1": "OGRN",
    "1.2.643.100.3": "SNILS",
    "1.2.643.3.131.1.1": "INN",
    "1.2.840.113549.1.9.1": "emailAddress",
    "1.2.840.113549.1.9.2": "unstructuredName",
    "1.3.6.1.4.1.311.60.2.1.1": "jurisdictionLocalityName",
    "1.3.6.1.4.1.311.60.2.1.2": "jurisdictionStateOrProvinceName",
    "1.3.6.1.4.1.311.60.2.1.3": "jurisdictionCountryName",
    "2.5.4.3": "commonName",
    "2.5.4.4": "surname",
    "2.5.4.5": "serialNumber",
    "2.5.4.6": "countryName",
    "2.5.4.7": "localityName",
    "2.5.4.8": "stateOrProvinceName",
    "2.5.4.9": "streetAddress",
    "2.5.4.10": "organizationName",
    "2.5.4.11": "organizationalUnitName",
    "2.5.4.12": "title",
    "2.5.4.15": "businessCategory",
    "2.5.4.16": "postalAddress",
    "2.5.4.17": "postalCode",
    "2.5.4.42": "givenName",
    "2.5.4.44": "generationQualifier",
    "2.5.4.45": "x500UniqueIdentifier",
    "2.5.4.46": "dnQualifier",
    "2.5.4.65": "pseudonym",
}

# signature algorithm OID → the digest's bits (RFC 4055, RFC 5758)
_SIG_HASH = {
    "1.2.840.113549.1.1.5": "1",      # sha1WithRSAEncryption
    "1.2.840.113549.1.1.14": "224",   # sha224WithRSAEncryption
    "1.2.840.113549.1.1.11": "256",   # sha256WithRSAEncryption
    "1.2.840.113549.1.1.12": "384",   # sha384WithRSAEncryption
    "1.2.840.113549.1.1.13": "512",   # sha512WithRSAEncryption
    "1.2.840.10045.4.1": "1",         # ecdsa-with-SHA1
    "1.2.840.10045.4.3.1": "224",     # ecdsa-with-SHA224
    "1.2.840.10045.4.3.2": "256",     # ecdsa-with-SHA256
    "1.2.840.10045.4.3.3": "384",     # ecdsa-with-SHA384
    "1.2.840.10045.4.3.4": "512",     # ecdsa-with-SHA512
}


def _tlvs(data: bytes) -> List[Tuple[int, bytes, bytes]]:
    """The (tag, content, whole TLV) elements that exactly fill ``data``."""
    out, pos = [], 0
    while pos < len(data):
        start = pos
        if pos + 2 > len(data):
            raise ValueError("DER: truncated header")
        tag, length = data[pos], data[pos + 1]
        pos += 2
        if length & 0x80:
            nbytes = length & 0x7F
            if not 1 <= nbytes <= 4 or pos + nbytes > len(data):
                raise ValueError("DER: bad length")
            length = int.from_bytes(data[pos:pos + nbytes], "big")
            pos += nbytes
        if pos + length > len(data):
            raise ValueError("DER: truncated content")
        out.append((tag, data[pos:pos + length], data[start:pos + length]))
        pos += length
    return out


def _one(data: bytes, tag: int) -> bytes:
    items = _tlvs(data)
    if len(items) != 1 or items[0][0] != tag:
        raise ValueError(f"DER: expected one element of tag {tag:#x}")
    return items[0][1]


def _bit_string(content: bytes) -> bytes:
    if not content or content[0] != 0:
        raise ValueError("DER: a BIT STRING with unused bits")
    return content[1:]


# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NameAttribute:
    """An (OID, value) attribute; the value's string type is not kept, as
    cryptography's equality ignores it."""

    oid: str
    value: Union[str, bytes]

    @property
    def name(self) -> str:
        """cryptography's ``attr.oid._name``."""
        return OID_NAMES.get(self.oid, "Unknown OID")


class Name:
    """A distinguished name: its RDNs in order, each a tuple of
    attributes in encoded order."""

    def __init__(self, rdns: Tuple[Tuple[NameAttribute, ...], ...]):
        self.rdns = rdns

    def __iter__(self) -> Iterator[NameAttribute]:
        for rdn in self.rdns:
            yield from rdn

    def __eq__(self, other) -> bool:
        return isinstance(other, Name) and [frozenset(r) for r in self.rdns] \
            == [frozenset(r) for r in other.rdns]

    def __repr__(self) -> str:
        return "Name(" + ",".join(
            "+".join(f"{a.name}={a.value!r}" for a in rdn)
            for rdn in self.rdns) + ")"


def _string_value(tag: int, content: bytes) -> Union[str, bytes]:
    if tag == _BMP_STRING:
        return content.decode("utf-16-be")
    if tag == _UNIVERSAL_STRING:
        return content.decode("utf-32-be")
    if tag == _BITS:  # x500UniqueIdentifier
        return _bit_string(content)
    return content.decode("utf-8")


def _name(content: bytes) -> Name:
    rdns = []
    for tag, rdn, _ in _tlvs(content):
        if tag != _SET:
            raise ValueError("X.509: an RDN is not a SET")
        attrs = []
        for atag, atv, _ in _tlvs(rdn):
            parts = _tlvs(atv)
            if atag != _SEQ or len(parts) != 2 or parts[0][0] != _OID:
                raise ValueError("X.509: bad AttributeTypeAndValue")
            vtag, vcontent, _ = parts[1]
            attrs.append(NameAttribute(pki._der_oid(parts[0][1]),
                                       _string_value(vtag, vcontent)))
        if not attrs:
            raise ValueError("X.509: an empty RDN")
        rdns.append(tuple(attrs))
    return Name(tuple(rdns))


# ---------------------------------------------------------------------------
# times, keys, extensions
# ---------------------------------------------------------------------------

def _time(tag: int, content: bytes) -> datetime.datetime:
    text = content.decode("ascii")
    if tag == _UTC_TIME and re.fullmatch(r"\d{12}Z", text):
        yy = int(text[:2])
        text = ("19" if yy >= 50 else "20") + text
    elif not (tag == _GENERALIZED_TIME and re.fullmatch(r"\d{14}Z", text)):
        raise ValueError(f"X.509: bad time {text!r}")
    return datetime.datetime.strptime(text, "%Y%m%d%H%M%SZ").replace(
        tzinfo=datetime.timezone.utc)


def _public_key(spki: bytes):
    items = _tlvs(spki)
    if len(items) != 2 or items[0][0] != _SEQ or items[1][0] != _BITS:
        raise ValueError("X.509: bad SubjectPublicKeyInfo")
    alg = _tlvs(items[0][1])
    if not alg or alg[0][0] != _OID:
        raise ValueError("X.509: bad key AlgorithmIdentifier")
    oid = pki._der_oid(alg[0][1])
    key = _bit_string(items[1][1])
    if oid == pki._RSA_OID:
        nums = _tlvs(_one(key, _SEQ))
        if len(nums) != 2 or any(t != _INT for t, _, _ in nums):
            raise ValueError("X.509: bad RSAPublicKey")
        return pki.RSAPublicKey(pki._der_uint(nums[0][1]),
                                pki._der_uint(nums[1][1]))
    if oid == pki._EC_OID:
        curve = (pki._CURVE_BY_OID.get(pki._der_oid(alg[1][1]))
                 if len(alg) == 2 and alg[1][0] == _OID else None)
        if curve is None:
            return None
        x, y = pki._point(curve, b"\x00" + key)
        return pki.ECPublicKey(curve, x, y)
    return None  # Ed25519, RSA-PSS keys, DSA, ...


def _extensions(content: bytes) -> dict:
    out = {}
    for tag, ext, _ in _tlvs(_one(content, _SEQ)):
        parts = _tlvs(ext)
        if tag != _SEQ or len(parts) not in (2, 3) or parts[0][0] != _OID \
                or parts[-1][0] != _OCTETS:
            raise ValueError("X.509: bad Extension")
        oid = pki._der_oid(parts[0][1])
        if oid in out:
            raise ValueError(f"X.509: duplicate extension {oid}")
        out[oid] = parts[-1][1]
    return out


def ecdsa_signature(sig: bytes) -> Tuple[int, int]:
    """(r, s) of a DER ECDSA-Sig-Value."""
    nums = _tlvs(_one(sig, _SEQ))
    if len(nums) != 2 or any(t != _INT for t, _, _ in nums):
        raise ValueError("not a DER ECDSA signature")
    return pki._der_uint(nums[0][1]), pki._der_uint(nums[1][1])


# ---------------------------------------------------------------------------
# the certificate
# ---------------------------------------------------------------------------

class Certificate:
    def __init__(self, der: bytes):
        self.der = der
        parts = _tlvs(_one(der, _SEQ))
        if len(parts) != 3 or parts[0][0] != _SEQ or parts[1][0] != _SEQ \
                or parts[2][0] != _BITS:
            raise ValueError("X.509: not a Certificate")
        self.tbs_certificate_bytes: bytes = parts[0][2]
        sig_alg = _tlvs(parts[1][1])
        if not sig_alg or sig_alg[0][0] != _OID:
            raise ValueError("X.509: bad signature AlgorithmIdentifier")
        self.signature_algorithm_oid = pki._der_oid(sig_alg[0][1])
        self.signature_hash_bits: Optional[str] = _SIG_HASH.get(
            self.signature_algorithm_oid)
        self.signature: bytes = _bit_string(parts[2][1])

        tbs = _tlvs(parts[0][1])
        i = 0
        self.version = 0
        if tbs and tbs[0][0] == 0xA0:
            self.version = pki._der_uint(_one(tbs[0][1], _INT))
            if self.version > 2:
                raise ValueError(f"X.509: invalid version {self.version}")
            i = 1
        fields = tbs[i:]
        if len(fields) < 6 or [t for t, _, _ in fields[:6]] != [
                _INT, _SEQ, _SEQ, _SEQ, _SEQ, _SEQ]:
            raise ValueError("X.509: bad TBSCertificate")
        self.serial_number = int.from_bytes(fields[0][1], "big", signed=True)
        self.issuer = _name(fields[2][1])
        validity = _tlvs(fields[3][1])
        if len(validity) != 2:
            raise ValueError("X.509: bad Validity")
        self.not_valid_before_utc = _time(validity[0][0], validity[0][1])
        self.not_valid_after_utc = _time(validity[1][0], validity[1][1])
        self.subject = _name(fields[4][1])
        self.public_key = _public_key(fields[5][1])
        self.extensions = {}
        for tag, content, _ in fields[6:]:
            if tag == 0xA3:
                self.extensions = _extensions(content)
            elif tag not in (0x81, 0x82):  # issuer/subject unique IDs
                raise ValueError("X.509: unexpected TBSCertificate field")

    def dns_names(self) -> Optional[List[str]]:
        san = self.extensions.get(_SAN_OID)
        if san is None:
            return None
        return [content.decode("ascii")
                for tag, content, _ in _tlvs(_one(san, _SEQ))
                if tag == _DNS_NAME_TAG]


def load_der_x509_certificate(der: bytes) -> Certificate:
    return Certificate(bytes(der))


_PEM_CERT = re.compile(
    rb"-----BEGIN (X509 )?CERTIFICATE-----(.*?)-----END \1?CERTIFICATE-----",
    re.S)


def load_pem_x509_certificate(pem: bytes) -> Certificate:
    """The first CERTIFICATE block of ``pem``."""
    m = _PEM_CERT.search(pem)
    if m is None:
        raise ValueError("no PEM CERTIFICATE block")
    try:
        der = base64.b64decode(b"".join(m.group(2).split()), validate=True)
    except ValueError as e:
        raise ValueError(f"bad PEM base64: {e}") from None
    return Certificate(der)
