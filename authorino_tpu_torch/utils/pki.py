"""Public-key primitives on Python integers, for the JOSE layer
(``utils/jose.py``) and the wristband signer: the card's machine has no
``cryptography``.

- RSA (RFC 8017): RSASSA-PKCS1-v1_5 and RSASSA-PSS (MGF1, salt length =
  digest length) sign and verify; signing uses the CRT.  The v1.5 verifier
  builds the whole expected encoded message and compares it byte for byte
  (it never parses the padding, which would open it to forgeries with
  small exponents).
- ECDSA on NIST P-256, P-384 and P-521 (FIPS 186-4 D.1.2, SEC 2 2.4):
  Jacobian-coordinate arithmetic for a = -3, the digest truncated to the
  order's bit length, ``r`` and ``s`` outside ``[1, n-1]`` and the point
  at infinity rejected, a random nonce from ``secrets``.
- A minimal DER reader and writer and the PEM private-key loader for what
  ``load_pem_private_key(pem, password=None)`` accepts from a wristband
  Secret: PKCS#1 ``RSA PRIVATE KEY``, SEC1 ``EC PRIVATE KEY`` and PKCS#8
  ``PRIVATE KEY`` wrapping either.  An encrypted or unknown PEM raises
  ValueError.
- Key generation from a caller's ``random.Random`` (RSA by Miller-Rabin,
  EC by a scalar draw), for test and benchmark keys made from a seed.

None of this is constant-time: it verifies public tokens and signs with
keys of a test deployment.  Keys that guard real secrets belong to a
constant-time library.
"""

from __future__ import annotations

import base64
import hashlib
import re
import secrets
from dataclasses import dataclass, field
from math import gcd
from typing import List, Optional, Tuple

__all__ = ["InvalidSignature", "Curve", "P256", "P384", "P521", "CURVES",
           "RSAPublicKey", "RSAPrivateKey", "ECPublicKey", "ECPrivateKey",
           "load_pem_private_key", "private_key_to_pem",
           "generate_rsa_private_key", "generate_ec_private_key"]


class InvalidSignature(Exception):
    pass


# SHA-1 and SHA-224 only for X.509 signatures (utils/x509.py); the JOSE
# layer admits 256, 384 and 512 alone
_HASH = {"1": hashlib.sha1, "224": hashlib.sha224, "256": hashlib.sha256,
         "384": hashlib.sha384, "512": hashlib.sha512}

# DER DigestInfo prefixes, RFC 8017 §9.2 note 1
_DIGEST_INFO = {
    "1": bytes.fromhex("3021300906052b0e03021a05000414"),
    "224": bytes.fromhex("302d300d06096086480165030402040500041c"),
    "256": bytes.fromhex("3031300d060960864801650304020105000420"),
    "384": bytes.fromhex("3041300d060960864801650304020205000430"),
    "512": bytes.fromhex("3051300d060960864801650304020305000440"),
}


def _i2osp(x: int, length: int) -> bytes:
    return x.to_bytes(length, "big")


def _os2ip(b: bytes) -> int:
    return int.from_bytes(b, "big")


# ---------------------------------------------------------------------------
# RSA (RFC 8017)
# ---------------------------------------------------------------------------

def _mgf1(seed: bytes, length: int, hashfn) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < length:
        out += hashfn(seed + counter.to_bytes(4, "big")).digest()
        counter += 1
    return bytes(out[:length])


def _xor(a: bytes, b: bytes) -> bytes:
    return _i2osp(_os2ip(a) ^ _os2ip(b), len(a))


def _pkcs1v15_encoded(data: bytes, bits: str, k: int) -> bytes:
    """EMSA-PKCS1-v1_5 (§9.2): the whole k-byte encoded message."""
    t = _DIGEST_INFO[bits] + _HASH[bits](data).digest()
    if k < len(t) + 11:
        raise ValueError("intended encoded message length too short")
    return b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t


def _pss_encode(data: bytes, bits: str, em_bits: int) -> bytes:
    """EMSA-PSS-ENCODE (§9.1.1) with sLen = hLen."""
    hashfn = _HASH[bits]
    m_hash = hashfn(data).digest()
    h_len = len(m_hash)
    em_len = (em_bits + 7) // 8
    if em_len < 2 * h_len + 2:
        raise ValueError("encoding error: key too small for the digest")
    salt = secrets.token_bytes(h_len)
    h = hashfn(b"\x00" * 8 + m_hash + salt).digest()
    db = b"\x00" * (em_len - 2 * h_len - 2) + b"\x01" + salt
    masked = bytearray(_xor(db, _mgf1(h, em_len - h_len - 1, hashfn)))
    masked[0] &= 0xFF >> (8 * em_len - em_bits)
    return bytes(masked) + h + b"\xbc"


def _pss_verify(data: bytes, bits: str, em: bytes, em_bits: int) -> bool:
    """EMSA-PSS-VERIFY (§9.1.2) with sLen = hLen."""
    hashfn = _HASH[bits]
    m_hash = hashfn(data).digest()
    h_len = s_len = len(m_hash)
    em_len = (em_bits + 7) // 8
    if len(em) != em_len or em_len < h_len + s_len + 2 or em[-1] != 0xBC:
        return False
    masked, h = em[:em_len - h_len - 1], em[em_len - h_len - 1:-1]
    top = 8 * em_len - em_bits
    if top and masked[0] >> (8 - top):
        return False
    db = bytearray(_xor(masked, _mgf1(h, em_len - h_len - 1, hashfn)))
    db[0] &= 0xFF >> top
    pad = em_len - h_len - s_len - 2
    if any(db[:pad]) or db[pad] != 0x01:
        return False
    salt = bytes(db[len(db) - s_len:])
    return hashfn(b"\x00" * 8 + m_hash + salt).digest() == h


@dataclass(frozen=True)
class RSAPublicKey:
    n: int
    e: int

    def __post_init__(self):
        # the checks of cryptography's RSAPublicNumbers.public_key()
        if self.n < 3:
            raise ValueError("n must be >= 3.")
        if self.e < 3 or self.e >= self.n:
            raise ValueError("e must be >= 3 and < n.")
        if self.e & 1 == 0:
            raise ValueError("e must be odd.")

    def verify(self, signature: bytes, data: bytes, padding: str,
               bits: str) -> None:
        """Raise InvalidSignature unless ``signature`` is a ``padding``
        ("PKCS1v15" or "PSS") signature of ``data`` under SHA-``bits``."""
        k = (self.n.bit_length() + 7) // 8
        if len(signature) != k:
            raise InvalidSignature("wrong signature length")
        s = _os2ip(signature)
        if s >= self.n:
            raise InvalidSignature("signature representative out of range")
        m = pow(s, self.e, self.n)
        if padding == "PKCS1v15":
            if _i2osp(m, k) != _pkcs1v15_encoded(data, bits, k):
                raise InvalidSignature()
        elif padding == "PSS":
            em_bits = self.n.bit_length() - 1
            em_len = (em_bits + 7) // 8
            if m >> (8 * em_len) or not _pss_verify(
                    data, bits, _i2osp(m, em_len), em_bits):
                raise InvalidSignature()
        else:
            raise ValueError(f"unsupported padding: {padding}")


@dataclass(frozen=True)
class RSAPrivateKey:
    n: int
    e: int
    d: int
    p: int
    q: int
    dp: int
    dq: int
    qinv: int

    @classmethod
    def from_primes(cls, p: int, q: int, e: int = 65537) -> "RSAPrivateKey":
        lam = (p - 1) * (q - 1) // gcd(p - 1, q - 1)
        d = pow(e, -1, lam)
        return cls(p * q, e, d, p, q, d % (p - 1), d % (q - 1),
                   pow(q, -1, p))

    def __post_init__(self):
        if self.p * self.q != self.n or not 1 < self.d < self.n:
            raise ValueError("invalid RSA private key")

    def public_key(self) -> RSAPublicKey:
        return RSAPublicKey(self.n, self.e)

    def _private(self, m: int) -> int:
        """m^d mod n by the CRT (RFC 8017 §5.1.2, 2.b)."""
        m1 = pow(m, self.dp, self.p)
        m2 = pow(m, self.dq, self.q)
        h = (self.qinv * (m1 - m2)) % self.p
        return m2 + h * self.q

    def sign(self, data: bytes, padding: str, bits: str) -> bytes:
        k = (self.n.bit_length() + 7) // 8
        if padding == "PKCS1v15":
            em = _pkcs1v15_encoded(data, bits, k)
        elif padding == "PSS":
            em = _pss_encode(data, bits, self.n.bit_length() - 1)
        else:
            raise ValueError(f"unsupported padding: {padding}")
        return _i2osp(self._private(_os2ip(em)), k)


# ---------------------------------------------------------------------------
# ECDSA over the NIST prime curves (a = -3)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Curve:
    name: str        # JWK "crv"
    key_size: int    # bits of the field
    oid: str
    p: int
    b: int
    gx: int
    gy: int
    n: int

    def on_curve(self, x: int, y: int) -> bool:
        p = self.p
        return (0 <= x < p and 0 <= y < p
                and (y * y - (x * x * x - 3 * x + self.b)) % p == 0)


P256 = Curve(
    "P-256", 256, "1.2.840.10045.3.1.7",
    p=0xffffffff00000001000000000000000000000000ffffffffffffffffffffffff,
    b=0x5ac635d8aa3a93e7b3ebbd55769886bc651d06b0cc53b0f63bce3c3e27d2604b,
    gx=0x6b17d1f2e12c4247f8bce6e563a440f277037d812deb33a0f4a13945d898c296,
    gy=0x4fe342e2fe1a7f9b8ee7eb4a7c0f9e162bce33576b315ececbb6406837bf51f5,
    n=0xffffffff00000000ffffffffffffffffbce6faada7179e84f3b9cac2fc632551)
P384 = Curve(
    "P-384", 384, "1.3.132.0.34",
    p=int("ffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
          "fffffffeffffffff0000000000000000ffffffff", 16),
    b=int("b3312fa7e23ee7e4988e056be3f82d19181d9c6efe8141120314088f"
          "5013875ac656398d8a2ed19d2a85c8edd3ec2aef", 16),
    gx=int("aa87ca22be8b05378eb1c71ef320ad746e1d3b628ba79b9859f741e0"
           "82542a385502f25dbf55296c3a545e3872760ab7", 16),
    gy=int("3617de4a96262c6f5d9e98bf9292dc29f8f41dbd289a147ce9da3113"
           "b5f0b8c00a60b1ce1d7e819d7a431d7c90ea0e5f", 16),
    n=int("ffffffffffffffffffffffffffffffffffffffffffffffffc7634d81"
          "f4372ddf581a0db248b0a77aecec196accc52973", 16))
P521 = Curve(
    "P-521", 521, "1.3.132.0.35",
    p=(1 << 521) - 1,
    b=int("0051953eb9618e1c9a1f929a21a0b68540eea2da725b99b315f3b8b4"
          "89918ef109e156193951ec7e937b1652c0bd3bb1bf073573df883d2c"
          "34f1ef451fd46b503f00", 16),
    gx=int("00c6858e06b70404e9cd9e3ecb662395b4429c648139053fb521f828"
           "af606b4d3dbaa14b5e77efe75928fe1dc127a2ffa8de3348b3c1856a"
           "429bf97e7e31c2e5bd66", 16),
    gy=int("011839296a789a3bc0045c8a5fb42c7d1bd998f54449579b446817af"
           "bd17273e662c97ee72995ef42640c550b9013fad0761353c7086a272"
           "c24088be94769fd16650", 16),
    n=int("01ffffffffffffffffffffffffffffffffffffffffffffffffffffff"
          "fffffffffffa51868783bf2f966b7fcc0148f709a5d03bb5c9b8899c"
          "47aebb6fb71e91386409", 16))
CURVES = {c.name: c for c in (P256, P384, P521)}
_CURVE_BY_OID = {c.oid: c for c in CURVES.values()}

_INF = (1, 1, 0)  # Jacobian point at infinity (Z = 0)


def _jdouble(pt, p):
    """dbl-2001-b (a = -3)."""
    x1, y1, z1 = pt
    if z1 == 0 or y1 == 0:
        return _INF
    delta = z1 * z1 % p
    gamma = y1 * y1 % p
    beta = x1 * gamma % p
    alpha = 3 * (x1 - delta) * (x1 + delta) % p
    x3 = (alpha * alpha - 8 * beta) % p
    z3 = ((y1 + z1) ** 2 - gamma - delta) % p
    y3 = (alpha * (4 * beta - x3) - 8 * gamma * gamma) % p
    return (x3, y3, z3)


def _jadd(p1, p2, p):
    """add-2007-bl, falling back to doubling for equal points."""
    x1, y1, z1 = p1
    x2, y2, z2 = p2
    if z1 == 0:
        return p2
    if z2 == 0:
        return p1
    z1z1 = z1 * z1 % p
    z2z2 = z2 * z2 % p
    u1 = x1 * z2z2 % p
    u2 = x2 * z1z1 % p
    s1 = y1 * z2 * z2z2 % p
    s2 = y2 * z1 * z1z1 % p
    h = (u2 - u1) % p
    r = (s2 - s1) % p
    if h == 0:
        return _jdouble(p1, p) if r == 0 else _INF
    hh = h * h % p
    hhh = h * hh % p
    v = u1 * hh % p
    x3 = (r * r - hhh - 2 * v) % p
    y3 = (r * (v - x3) - s1 * hhh) % p
    z3 = h * z1 * z2 % p
    return (x3, y3, z3)


def _affine(pt, p) -> Optional[Tuple[int, int]]:
    x, y, z = pt
    if z == 0:
        return None
    zi = pow(z, -1, p)
    zi2 = zi * zi % p
    return (x * zi2 % p, y * zi2 * zi % p)


def _table(pt, p, size: int = 16) -> List[tuple]:
    out = [_INF, pt]
    for _ in range(size - 2):
        out.append(_jadd(out[-1], pt, p))
    return out


def _multi_mul(pairs, curve: Curve):
    """sum(k_i * P_i) by interleaved 4-bit windows (P_i affine)."""
    p = curve.p
    tables = [(k, _table((x, y, 1), p)) for k, (x, y) in pairs]
    top = max(k.bit_length() for k, _ in tables)
    acc = _INF
    for shift in range((top + 3) // 4 * 4 - 4, -4, -4):
        for _ in range(4):
            acc = _jdouble(acc, p)
        for k, table in tables:
            w = (k >> shift) & 0xF
            if w:
                acc = _jadd(acc, table[w], p)
    return acc


def _digest_int(data: bytes, bits: str, curve: Curve) -> int:
    """The digest as an integer, truncated to the order's bit length
    (SEC 1 §4.1.3 step 5)."""
    digest = _HASH[bits](data).digest()
    e = _os2ip(digest)
    excess = 8 * len(digest) - curve.n.bit_length()
    return e >> excess if excess > 0 else e


@dataclass(frozen=True)
class ECPublicKey:
    curve: Curve
    x: int
    y: int

    def __post_init__(self):
        if not self.curve.on_curve(self.x, self.y):
            raise ValueError("Invalid EC key: the point is not on the curve")

    def verify(self, signature: Tuple[int, int], data: bytes,
               bits: str) -> None:
        """Raise InvalidSignature unless ``signature`` = (r, s) is an
        ECDSA signature of ``data`` under SHA-``bits``."""
        r, s = signature
        n = self.curve.n
        if not (1 <= r < n and 1 <= s < n):
            raise InvalidSignature("r or s out of range")
        w = pow(s, -1, n)
        e = _digest_int(data, bits, self.curve)
        pt = _affine(_multi_mul(
            [(e * w % n, (self.curve.gx, self.curve.gy)),
             (r * w % n, (self.x, self.y))], self.curve), self.curve.p)
        if pt is None or pt[0] % n != r:
            raise InvalidSignature()


@dataclass(frozen=True)
class ECPrivateKey:
    curve: Curve
    d: int
    q: ECPublicKey = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        if not 1 <= self.d < self.curve.n:
            raise ValueError("Invalid EC key: private scalar out of range")
        c = self.curve
        x, y = _affine(_multi_mul([(self.d, (c.gx, c.gy))], c), c.p)
        object.__setattr__(self, "q", ECPublicKey(c, x, y))  # Q = d·G

    def public_key(self) -> ECPublicKey:
        return self.q

    def sign(self, data: bytes, bits: str) -> Tuple[int, int]:
        """(r, s) with a fresh random nonce (SEC 1 §4.1.3)."""
        c = self.curve
        e = _digest_int(data, bits, c)
        while True:
            k = secrets.randbelow(c.n - 1) + 1
            x, _ = _affine(_multi_mul([(k, (c.gx, c.gy))], c), c.p)
            r = x % c.n
            if r == 0:
                continue
            s = pow(k, -1, c.n) * (e + r * self.d) % c.n
            if s:
                return r, s


# ---------------------------------------------------------------------------
# DER and PEM
# ---------------------------------------------------------------------------

_SEQ, _INT, _BITS, _OCTETS, _NULL, _OID = 0x30, 0x02, 0x03, 0x04, 0x05, 0x06
_RSA_OID = "1.2.840.113549.1.1.1"
_EC_OID = "1.2.840.10045.2.1"


def _der_items(data: bytes) -> List[Tuple[int, bytes]]:
    """The (tag, content) TLVs that exactly fill ``data``."""
    out, pos = [], 0
    while pos < len(data):
        if pos + 2 > len(data):
            raise ValueError("DER: truncated header")
        tag, length = data[pos], data[pos + 1]
        pos += 2
        if length & 0x80:
            nbytes = length & 0x7F
            if not 1 <= nbytes <= 4 or pos + nbytes > len(data):
                raise ValueError("DER: bad length")
            length = _os2ip(data[pos:pos + nbytes])
            pos += nbytes
        if pos + length > len(data):
            raise ValueError("DER: truncated content")
        out.append((tag, data[pos:pos + length]))
        pos += length
    return out


def _der_one(data: bytes, tag: int) -> bytes:
    items = _der_items(data)
    if len(items) != 1 or items[0][0] != tag:
        raise ValueError(f"DER: expected one element of tag {tag:#x}")
    return items[0][1]


def _der_uint(content: bytes) -> int:
    if not content or content[0] & 0x80:
        raise ValueError("DER: expected a non-negative INTEGER")
    return _os2ip(content)


def _der_oid(content: bytes) -> str:
    if not content:
        raise ValueError("DER: empty OID")
    arcs, v = [], 0
    for byte in content:
        v = (v << 7) | (byte & 0x7F)
        if not byte & 0x80:
            arcs.append(v)
            v = 0
    first = min(arcs[0] // 40, 2)
    return ".".join(str(a) for a in [first, arcs[0] - 40 * first] + arcs[1:])


def _tlv(tag: int, content: bytes) -> bytes:
    n = len(content)
    if n < 0x80:
        head = bytes([n])
    else:
        raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
        head = bytes([0x80 | len(raw)]) + raw
    return bytes([tag]) + head + content


def _der_int(x: int) -> bytes:
    return _tlv(_INT, x.to_bytes(x.bit_length() // 8 + 1, "big"))


def _oid_der(oid: str) -> bytes:
    arcs = [int(a) for a in oid.split(".")]
    out = bytearray()
    for a in [40 * arcs[0] + arcs[1]] + arcs[2:]:
        chunk = [a & 0x7F]
        a >>= 7
        while a:
            chunk.append(0x80 | (a & 0x7F))
            a >>= 7
        out += bytes(reversed(chunk))
    return _tlv(_OID, bytes(out))


def _rsa_from_pkcs1(der: bytes) -> RSAPrivateKey:
    items = _der_items(_der_one(der, _SEQ))
    if len(items) != 9 or any(t != _INT for t, _ in items):
        raise ValueError("not a PKCS#1 RSAPrivateKey")
    version, *nums = (_der_uint(c) for _, c in items)
    if version != 0:
        raise ValueError("unsupported RSAPrivateKey version")
    return RSAPrivateKey(*nums)


def _point(curve: Curve, bits: bytes) -> Tuple[int, int]:
    """An uncompressed point from a BIT STRING's content."""
    size = (curve.key_size + 7) // 8
    if len(bits) != 2 + 2 * size or bits[:2] != b"\x00\x04":
        raise ValueError("unsupported EC public key encoding")
    return _os2ip(bits[2:2 + size]), _os2ip(bits[2 + size:])


def _ec_from_sec1(der: bytes, curve: Optional[Curve] = None) -> ECPrivateKey:
    items = _der_items(_der_one(der, _SEQ))
    if (len(items) < 2 or items[0] != (_INT, b"\x01")
            or items[1][0] != _OCTETS):
        raise ValueError("not a SEC1 ECPrivateKey")
    d = _os2ip(items[1][1])
    public = None
    for tag, content in items[2:]:
        if tag == 0xA0:
            named = _CURVE_BY_OID.get(_der_oid(_der_one(content, _OID)))
            if named is None or (curve is not None and named != curve):
                raise ValueError("unsupported or mismatched EC curve")
            curve = named
        elif tag == 0xA1:
            public = _der_one(content, _BITS)
        else:
            raise ValueError("SEC1 ECPrivateKey: unexpected element")
    if curve is None:
        raise ValueError("SEC1 ECPrivateKey names no curve")
    key = ECPrivateKey(curve, d)  # computes Q = d·G, also when omitted
    q = key.public_key()
    if public is not None and _point(curve, public) != (q.x, q.y):
        raise ValueError("EC public key does not match the private key")
    return key


def _from_pkcs8(der: bytes):
    items = _der_items(_der_one(der, _SEQ))
    if (len(items) < 3 or items[0][0] != _INT
            or _der_uint(items[0][1]) not in (0, 1) or items[1][0] != _SEQ
            or items[2][0] != _OCTETS):
        raise ValueError("not a PKCS#8 PrivateKeyInfo")
    alg = _der_items(items[1][1])
    oid = _der_oid(alg[0][1]) if alg and alg[0][0] == _OID else ""
    if oid == _RSA_OID:
        return _rsa_from_pkcs1(items[2][1])
    if oid == _EC_OID and len(alg) == 2 and alg[1][0] == _OID:
        curve = _CURVE_BY_OID.get(_der_oid(alg[1][1]))
        if curve is None:
            raise ValueError("unsupported EC curve")
        return _ec_from_sec1(items[2][1], curve)
    raise ValueError(f"unsupported private key algorithm {oid!r}")


_PEM_RE = re.compile(
    rb"-----BEGIN ([A-Z0-9 ]+)-----(.*?)-----END \1-----", re.S)
_PARSERS = {b"RSA PRIVATE KEY": _rsa_from_pkcs1,
            b"EC PRIVATE KEY": _ec_from_sec1,
            b"PRIVATE KEY": _from_pkcs8}


def load_pem_private_key(pem: bytes):
    """The first private key of ``pem`` (an RSAPrivateKey or
    ECPrivateKey).  Raises ValueError for an encrypted key, an unknown
    type or malformed data."""
    for label, body in _PEM_RE.findall(pem):
        if label == b"ENCRYPTED PRIVATE KEY":
            raise ValueError("the private key is encrypted")
        parse = _PARSERS.get(label)
        if parse is None:
            continue
        lines = [ln.strip() for ln in body.strip().splitlines()]
        if any(ln.startswith(b"Proc-Type:") and b"ENCRYPTED" in ln
               for ln in lines):
            raise ValueError("the private key is encrypted")
        try:
            der = base64.b64decode(b"".join(ln for ln in lines
                                            if b":" not in ln),
                                   validate=True)
        except ValueError as e:
            raise ValueError(f"bad PEM base64: {e}") from None
        return parse(der)
    raise ValueError("no supported private key in the PEM data")


def _pem(label: str, der: bytes) -> bytes:
    b64 = base64.b64encode(der).decode()
    body = "\n".join(b64[i:i + 64] for i in range(0, len(b64), 64))
    return f"-----BEGIN {label}-----\n{body}\n-----END {label}-----\n".encode()


def private_key_to_pem(key) -> bytes:
    """PKCS#1 ``RSA PRIVATE KEY`` or SEC1 ``EC PRIVATE KEY`` (with the
    curve and the public point)."""
    if isinstance(key, RSAPrivateKey):
        nums = (0, key.n, key.e, key.d, key.p, key.q, key.dp, key.dq,
                key.qinv)
        return _pem("RSA PRIVATE KEY",
                    _tlv(_SEQ, b"".join(_der_int(x) for x in nums)))
    c = key.curve
    size = (c.key_size + 7) // 8
    q = key.public_key()
    point = b"\x00\x04" + _i2osp(q.x, size) + _i2osp(q.y, size)
    der = _tlv(_SEQ, _der_int(1) + _tlv(_OCTETS, _i2osp(key.d, size))
               + _tlv(0xA0, _oid_der(c.oid)) + _tlv(0xA1, _tlv(_BITS, point)))
    return _pem("EC PRIVATE KEY", der)


# ---------------------------------------------------------------------------
# key generation from a caller's random.Random
# ---------------------------------------------------------------------------

_SMALL_PRIMES = [q for q in range(3, 2000)
                 if all(q % f for f in range(3, int(q ** 0.5) + 1, 2))]


def _probable_prime(n: int, rng, rounds: int = 16) -> bool:
    """Trial division, then Miller-Rabin with ``rounds`` bases."""
    if any(n % q == 0 for q in _SMALL_PRIMES):
        return n in _SMALL_PRIMES
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime(bits: int, e: int, rng) -> int:
    while True:
        # top two bits set, so a product of two such primes has 2*bits bits
        c = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        if gcd(e, c - 1) == 1 and _probable_prime(c, rng):
            return c


def generate_rsa_private_key(bits: int, rng, e: int = 65537) -> RSAPrivateKey:
    while True:
        p, q = _prime(bits // 2, e, rng), _prime(bits - bits // 2, e, rng)
        if p != q:
            if p < q:
                p, q = q, p
            return RSAPrivateKey.from_primes(p, q, e)


def generate_ec_private_key(curve: Curve, rng) -> ECPrivateKey:
    return ECPrivateKey(curve, rng.randrange(1, curve.n))
