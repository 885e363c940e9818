"""Minimal JOSE (JWS/JWT/JWK) on the standard library and ``utils/pki.py``
— the card's machine has neither ``cryptography`` nor python-jose/pyjwt.
Covers what the framework needs: RS256/384/512, PS256/384/512,
ES256/384/512, HS256/384/512 verification and signing, JWK parse/export,
and JWT claim validation mirroring go-oidc's verifier behavior (iss, exp,
nbf; audience check optional — the reference skips client-id checks, ref
pkg/evaluators/identity/oidc.go)."""

from __future__ import annotations

import base64
import hashlib
import hmac as hmac_mod
import json
import time
from typing import Any, Dict, List, Optional, Tuple

from . import pki

__all__ = [
    "JoseError", "b64url_encode", "b64url_decode", "jwk_from_public_key",
    "public_key_from_jwk", "sign_jwt", "verify_jws", "verify_jwt_claims",
    "decode_unverified",
]


class JoseError(Exception):
    pass


def b64url_encode(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


# an alg of another size raises KeyError, as the reference's hash lookup does
_HASH_BITS = ("256", "384", "512")
_EC_SIZES = {"ES256": 32, "ES384": 48, "ES512": 66}


def _int_to_b64(n: int, size: Optional[int] = None) -> str:
    length = size or (n.bit_length() + 7) // 8
    return b64url_encode(n.to_bytes(length, "big"))


def jwk_from_public_key(key, kid: str = "", alg: str = "") -> Dict[str, Any]:
    """Public JWK dict for an RSA or EC public key."""
    if isinstance(key, pki.RSAPublicKey):
        jwk = {"kty": "RSA", "n": _int_to_b64(key.n), "e": _int_to_b64(key.e)}
        jwk["alg"] = alg or "RS256"
    elif isinstance(key, pki.ECPublicKey):
        size = (key.curve.key_size + 7) // 8
        crv = key.curve.name
        jwk = {
            "kty": "EC",
            "crv": crv,
            "x": _int_to_b64(key.x, size),
            "y": _int_to_b64(key.y, size),
        }
        jwk["alg"] = alg or {"P-256": "ES256", "P-384": "ES384", "P-521": "ES512"}[crv]
    else:
        raise JoseError(f"unsupported key type: {type(key)}")
    jwk["use"] = "sig"
    if kid:
        jwk["kid"] = kid
    return jwk


def public_key_from_jwk(jwk: Dict[str, Any]):
    kty = jwk.get("kty")
    if kty == "RSA":
        n = int.from_bytes(b64url_decode(jwk["n"]), "big")
        e = int.from_bytes(b64url_decode(jwk["e"]), "big")
        return pki.RSAPublicKey(n, e)
    if kty == "EC":
        crv = pki.CURVES[jwk["crv"]]
        x = int.from_bytes(b64url_decode(jwk["x"]), "big")
        y = int.from_bytes(b64url_decode(jwk["y"]), "big")
        return pki.ECPublicKey(crv, x, y)  # raises off the curve
    if kty == "oct":
        return b64url_decode(jwk["k"])
    raise JoseError(f"unsupported kty: {kty}")


def _sign_raw(alg: str, key, signing_input: bytes) -> bytes:
    fam, bits = alg[:2], alg[2:]
    if bits not in _HASH_BITS:
        raise KeyError(bits)
    if fam == "HS":
        if not isinstance(key, (bytes, bytearray)):
            raise JoseError("HS* needs a bytes key")
        return hmac_mod.new(key, signing_input, getattr(hashlib, f"sha{bits}")).digest()
    if fam == "RS":
        return key.sign(signing_input, "PKCS1v15", bits)
    if fam == "PS":
        return key.sign(signing_input, "PSS", bits)
    if fam == "ES":
        r, s = key.sign(signing_input, bits)
        size = _EC_SIZES[alg]
        return r.to_bytes(size, "big") + s.to_bytes(size, "big")
    raise JoseError(f"unsupported alg: {alg}")


def _verify_raw(alg: str, key, signing_input: bytes, sig: bytes) -> bool:
    fam, bits = alg[:2], alg[2:]
    if bits not in _HASH_BITS:
        raise KeyError(bits)
    try:
        if fam == "HS":
            # an RSA or EC key object is no HMAC key: hmac raises TypeError
            # and the token fails (algorithm confusion)
            expected = hmac_mod.new(
                key, signing_input, getattr(hashlib, f"sha{bits}")
            ).digest()
            return hmac_mod.compare_digest(expected, sig)
        if fam == "RS":
            key.verify(sig, signing_input, "PKCS1v15", bits)
            return True
        if fam == "PS":
            key.verify(sig, signing_input, "PSS", bits)
            return True
        if fam == "ES":
            size = _EC_SIZES[alg]
            if len(sig) != 2 * size:
                return False
            r = int.from_bytes(sig[:size], "big")
            s = int.from_bytes(sig[size:], "big")
            key.verify((r, s), signing_input, bits)
            return True
    except Exception:
        return False
    raise JoseError(f"unsupported alg: {alg}")


def sign_jwt(claims: Dict[str, Any], key, alg: str, kid: str = "", extra_header: Optional[dict] = None) -> str:
    header: Dict[str, Any] = {"alg": alg, "typ": "JWT"}
    if kid:
        header["kid"] = kid
    if extra_header:
        header.update(extra_header)
    h = b64url_encode(json.dumps(header, separators=(",", ":")).encode())
    p = b64url_encode(json.dumps(claims, separators=(",", ":")).encode())
    signing_input = f"{h}.{p}".encode()
    sig = _sign_raw(alg, key, signing_input)
    return f"{h}.{p}.{b64url_encode(sig)}"


def decode_unverified(token: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    try:
        h, p, _ = token.split(".")
        return json.loads(b64url_decode(h)), json.loads(b64url_decode(p))
    except Exception as e:
        raise JoseError(f"malformed JWT: {e}")


# parsing a JWK into a key object on every request would repeat the base64
# and integer decoding (and the on-curve check for EC keys); cache by key
# material (not dict identity: JWKS refreshes rebuild the dicts).
_PUBKEY_CACHE: Dict[Tuple, Any] = {}


def _cached_public_key(jwk: Dict[str, Any]):
    # the tuple must cover EVERY field that determines the key material —
    # omitting "k" would collapse all symmetric (oct) keys onto one entry,
    # verifying HMAC tokens against the wrong secret
    k = (jwk.get("kty"), jwk.get("n"), jwk.get("e"),
         jwk.get("crv"), jwk.get("x"), jwk.get("y"), jwk.get("k"))
    key = _PUBKEY_CACHE.get(k)
    if key is None:
        key = public_key_from_jwk(jwk)
        if len(_PUBKEY_CACHE) > 256:  # bound: rotated keys age out wholesale
            _PUBKEY_CACHE.clear()
        _PUBKEY_CACHE[k] = key
    return key


def verify_jws(token: str, keys: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Verify signature against a JWKS key list; returns the claims."""
    try:
        h_b64, p_b64, s_b64 = token.split(".")
    except ValueError:
        raise JoseError("malformed JWT")
    header = json.loads(b64url_decode(h_b64))
    alg = header.get("alg", "")
    if alg in ("", "none"):
        raise JoseError("unsigned JWTs are rejected")
    kid = header.get("kid")
    signing_input = f"{h_b64}.{p_b64}".encode()
    sig = b64url_decode(s_b64)
    candidates = [k for k in keys if not kid or k.get("kid") in (None, kid)]
    if kid and not candidates:
        candidates = keys  # kid not found: try all (JWKS may have rotated)
    for jwk in candidates:
        if jwk.get("alg") and jwk["alg"] != alg:
            continue
        try:
            key = _cached_public_key(jwk)
        except Exception:
            continue
        if _verify_raw(alg, key, signing_input, sig):
            return json.loads(b64url_decode(p_b64))
    raise JoseError("failed to verify signature against any key")


def verify_jwt_claims(
    claims: Dict[str, Any],
    issuer: Optional[str] = None,
    audience: Optional[str] = None,
    leeway_s: int = 30,
) -> None:
    now = time.time()
    if issuer is not None and claims.get("iss") != issuer:
        raise JoseError(f"id token issued by a different provider: {claims.get('iss')!r}")
    exp = claims.get("exp")
    if exp is not None and now > float(exp) + leeway_s:
        raise JoseError("token is expired")
    nbf = claims.get("nbf")
    if nbf is not None and now < float(nbf) - leeway_s:
        raise JoseError("token not valid yet")
    if audience is not None:
        aud = claims.get("aud")
        auds = aud if isinstance(aud, list) else [aud]
        if audience not in auds:
            raise JoseError("audience mismatch")
