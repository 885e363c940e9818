"""The port's X.509 reader (``utils/x509.py``) and mTLS identity against
the reference's, which stands on ``cryptography``.  Certificates and CAs
are made here with ``cryptography`` (the test may import it; the port may
not); each case goes through both packages' ``MTLS`` evaluators, each
with an ``InMemoryCluster`` of its own holding the same CA Secrets, and
the identity object or the error must be equal (tolerance 0).  Where the
reference's message embeds cryptography's own parse error ("invalid
client certificate: ..."), the prefix is compared and the tail is a
listed divergence (ROADMAP queue 3).  A hypothesis test holds the parsed
names of random subjects to cryptography's, and certificates written by
the port's test writer (``models/control_plane.py``) to cryptography's
reading of them."""

import asyncio
import datetime
import random
import urllib.parse
from types import SimpleNamespace

import pytest
from cryptography import x509 as cx
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import ec, ed25519, padding, rsa
from cryptography.x509.oid import NameOID
from hypothesis import given, settings
from hypothesis import strategies as st

from authorino_tpu.evaluators.identity.mtls import MTLS as RefMTLS
from authorino_tpu.k8s import InMemoryCluster as RefCluster
from authorino_tpu.k8s import LabelSelector as RefSelector
from authorino_tpu.k8s import Secret as RefSecret
from authorino_tpu_torch.evaluators.base import EvaluationError as PortError
from authorino_tpu_torch.evaluators.identity import MTLS as PortMTLS
from authorino_tpu_torch.k8s import InMemoryCluster as PortCluster
from authorino_tpu_torch.k8s import LabelSelector as PortSelector
from authorino_tpu_torch.k8s import Secret as PortSecret
from authorino_tpu_torch.models import control_plane as cp
from authorino_tpu_torch.utils import pki
from authorino_tpu_torch.utils import x509 as px

NOW = datetime.datetime.now(datetime.timezone.utc)
DAY = datetime.timedelta(days=1)
LABELS = {"authorino.kuadrant.io/ca": "clients"}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def _name(*rdns):
    """A cryptography Name from RDNs of (oid, value[, string type])."""
    out = []
    for rdn in rdns:
        attrs = []
        for a in rdn:
            if len(a) > 2:
                attrs.append(cx.NameAttribute(a[0], a[1], _type=a[2]))
            else:
                attrs.append(cx.NameAttribute(a[0], a[1]))
        out.append(cx.RelativeDistinguishedName(attrs))
    return cx.Name(out)


def _pem(cert) -> bytes:
    return cert.public_bytes(serialization.Encoding.PEM)


def _build(subject, issuer, pub, signer, start=NOW - DAY, end=NOW + 365 * DAY,
           san=None, ca=False, algorithm=None, serial=None, pss=False):
    b = (cx.CertificateBuilder().subject_name(subject).issuer_name(issuer)
         .public_key(pub).serial_number(serial or cx.random_serial_number())
         .not_valid_before(start).not_valid_after(end))
    if ca:
        b = b.add_extension(cx.BasicConstraints(ca=True, path_length=None),
                            critical=True)
    if san is not None:
        b = b.add_extension(cx.SubjectAlternativeName(san), critical=False)
    if isinstance(signer, ed25519.Ed25519PrivateKey):
        return b.sign(signer, None)
    kw = {}
    if pss:
        kw["rsa_padding"] = padding.PSS(mgf=padding.MGF1(hashes.SHA256()),
                                        salt_length=32)
    return b.sign(signer, algorithm or hashes.SHA256(), **kw)


class CA:
    def __init__(self, key, subject):
        self.key, self.subject = key, subject
        self.cert = _build(subject, subject, key.public_key(), key, ca=True)
        self.pem = _pem(self.cert)

    def issue(self, subject, **kw):
        key = ec.generate_private_key(ec.SECP256R1())
        return _pem(_build(subject, self.subject, key.public_key(), self.key,
                           **kw))


RSA_KEY = rsa.generate_private_key(public_exponent=65537, key_size=2048)
_nums = RSA_KEY.private_numbers()
RSA_PKI = pki.RSAPrivateKey.from_primes(_nums.p, _nums.q, _nums.public_numbers.e)
CAS = {
    "rsa": CA(RSA_KEY, _name([(NameOID.COMMON_NAME, "Root RSA")],
                             [(NameOID.ORGANIZATION_NAME, "acme")])),
    "p256": CA(ec.generate_private_key(ec.SECP256R1()),
               _name([(NameOID.COMMON_NAME, "Root P-256")])),
    "p384": CA(ec.generate_private_key(ec.SECP384R1()),
               _name([(NameOID.COMMON_NAME, "Root P-384")])),
    # the same name as "rsa" as PrintableStrings: equal names
    "printable": CA(rsa.generate_private_key(65537, 2048), _name(
        [(NameOID.COMMON_NAME, "Root Printable", cx.name._ASN1Type.PrintableString)],
        [(NameOID.ORGANIZATION_NAME, "acme",
          cx.name._ASN1Type.PrintableString)])),
    "ed25519": CA(ed25519.Ed25519PrivateKey.generate(),
                  _name([(NameOID.COMMON_NAME, "Root Ed25519")])),
}
FOREIGN = CA(ec.generate_private_key(ec.SECP256R1()),
             _name([(NameOID.COMMON_NAME, "Root P-256")]))  # same name, other key
TRUSTED = ("rsa", "p256", "p384", "printable", "ed25519")

CLIENT = _name([(NameOID.COMMON_NAME, "client-1"),
                (NameOID.ORGANIZATIONAL_UNIT_NAME, "eng")],
               [(NameOID.ORGANIZATION_NAME, "org-1")],
               [(NameOID.COUNTRY_NAME, "PT")],
               [(NameOID.EMAIL_ADDRESS, "c1@example.com")],
               [(cx.ObjectIdentifier("1.3.6.1.4.1.99999.7"), "custom")],
               [(NameOID.DOMAIN_COMPONENT, "example")])


def _cases():
    rsa_ca, p256, p384, printable = (CAS[k] for k in ("rsa", "p256", "p384",
                                                       "printable"))
    good = rsa_ca.issue(CLIENT, san=[cx.DNSName("a.example"),
                                     cx.DNSName("b.example")])
    text = good.decode()
    printable_issued = printable.issue(CLIENT)
    # the printable CA's subject with UTF8Strings: a client issued under it
    # names its issuer in another string type
    utf8_twin = CA(printable.key, _name(
        [(NameOID.COMMON_NAME, "Root Printable")],
        [(NameOID.ORGANIZATION_NAME, "acme")]))
    return {
        "rsa-san": good,
        "rsa-sha384": rsa_ca.issue(CLIENT, algorithm=hashes.SHA384()),
        "rsa-sha512": rsa_ca.issue(CLIENT, algorithm=hashes.SHA512()),
        # cryptography signs no SHA-1 certificate: the port's writer does,
        # with the same CA key
        "rsa-sha1": cp.pem(cp.make_certificate(
            [[(cp.OID["CN"], "client-1")]],
            [[(cp.OID["CN"], "Root RSA")], [(cp.OID["O"], "acme")]],
            RSA_PKI.public_key(), RSA_PKI, NOW - DAY, NOW + DAY,
            hash_bits="1")),
        "rsa-pss": _pem(_build(CLIENT, rsa_ca.subject,
                               ec.generate_private_key(ec.SECP256R1()).public_key(),
                               rsa_ca.key, pss=True)),
        "p256-san-empty": p256.issue(CLIENT, san=[cx.RFC822Name("x@example.com")]),
        "p256-no-san": p256.issue(_name([(NameOID.COMMON_NAME, "bare")])),
        "p384": p384.issue(CLIENT, algorithm=hashes.SHA384()),
        "p384-sha256": p384.issue(CLIENT),
        "ed25519-ca": CAS["ed25519"].issue(CLIENT),
        "foreign": FOREIGN.issue(CLIENT),
        "expired": rsa_ca.issue(CLIENT, start=NOW - 10 * DAY, end=NOW - DAY),
        "not-yet-valid": rsa_ca.issue(CLIENT, start=NOW + DAY,
                                      end=NOW + 10 * DAY),
        "utcy2k": rsa_ca.issue(CLIENT, start=datetime.datetime(
            1999, 1, 1, tzinfo=datetime.timezone.utc),
            end=datetime.datetime(2051, 1, 1, tzinfo=datetime.timezone.utc)),
        "multivalued-rdn": p256.issue(_name(
            [(NameOID.COMMON_NAME, "mv"), (NameOID.ORGANIZATION_NAME, "o1"),
             (NameOID.ORGANIZATIONAL_UNIT_NAME, "u1")],
            [(NameOID.ORGANIZATION_NAME, "o2")])),
        "printable-issuer": printable_issued,
        "utf8-issuer-of-printable-ca": utf8_twin.issue(CLIENT),
        "bundle": good + p256.issue(CLIENT),
        "bundle-foreign-first": FOREIGN.issue(CLIENT) + good,
        "url-encoded": urllib.parse.quote(text).encode(),
        "preamble": b"subject=CN=client-1\n" + good,
        "garbage": b"not a certificate",
        "bad-base64": b"-----BEGIN CERTIFICATE-----\n!!!!\n-----END CERTIFICATE-----\n",
        "truncated": ("-----BEGIN CERTIFICATE-----\n" + "".join(
            text.split("\n")[1:4]) + "\n-----END CERTIFICATE-----\n").encode(),
        "empty": b"",
    }


CASES = _cases()


def _secret(ns, name, pem_bytes, key="ca.crt", labels=None):
    cls = RefSecret if ns == "ref" else PortSecret
    return cls(name=name, namespace="t", labels=dict(labels or LABELS),
               data={key: pem_bytes})


def _evaluators(secrets):
    """(reference MTLS, port MTLS), each with its own cluster holding
    ``secrets`` [(name, pem, key)]."""
    out = []
    for ns, cluster_cls, sel_cls, mtls_cls in (
            ("ref", RefCluster, RefSelector, RefMTLS),
            ("port", PortCluster, PortSelector, PortMTLS)):
        cluster = cluster_cls()
        for name, data, key in secrets:
            cluster.put_secret(_secret(ns, name, data, key))
        ev = mtls_cls("mtls", sel_cls.from_spec({"matchLabels": LABELS}),
                      namespace="t", cluster=cluster)
        run(ev.load_secrets())
        out.append(ev)
    return out


def _pipeline(cert):
    return SimpleNamespace(request=SimpleNamespace(
        source=SimpleNamespace(certificate=cert)))


def outcome(ev, cert: str):
    try:
        return ("ok", run(ev.call(_pipeline(cert))))
    except Exception as e:
        msg = str(e)
        if msg.startswith("invalid client certificate: "):
            msg = "invalid client certificate: <parse error>"
        return (type(e).__name__, msg)


TRUSTED_SECRETS = [(f"ca-{k}", CAS[k].pem, "ca.crt") for k in TRUSTED]


@pytest.mark.parametrize("case", sorted(CASES))
def test_mtls_identity_equals_reference(case):
    ref, port = _evaluators(TRUSTED_SECRETS)
    cert = CASES[case].decode("latin-1")
    want, got = outcome(ref, cert), outcome(port, cert)
    assert got == want
    assert got[0] in ("ok", "EvaluationError")


def test_expected_outcomes():
    _, port = _evaluators(TRUSTED_SECRETS)
    ok = {k for k in CASES if outcome(port, CASES[k].decode("latin-1"))[0] == "ok"}
    assert ok == {"rsa-san", "rsa-sha384", "rsa-sha512", "rsa-sha1",
                  "p256-san-empty", "p256-no-san", "p384", "p384-sha256",
                  "multivalued-rdn", "printable-issuer",
                  "utf8-issuer-of-printable-ca", "bundle", "url-encoded",
                  "preamble", "utcy2k"}
    ident = outcome(port, CASES["rsa-san"].decode())[1]
    assert ident == {"CommonName": "client-1", "OrganizationalUnit": "eng",
                     "Organization": "org-1", "Country": "PT",
                     "emailAddress": "c1@example.com",
                     "Unknown OID": "custom", "domainComponent": "example",
                     "DNSNames": ["a.example", "b.example"]}
    assert outcome(port, CASES["p256-san-empty"].decode())[1]["DNSNames"] == []
    assert "DNSNames" not in outcome(port, CASES["p256-no-san"].decode())[1]
    for k, msg in (("foreign", "x509: certificate signed by unknown authority"),
                   ("rsa-pss", "x509: certificate signed by unknown authority"),
                   ("ed25519-ca", "x509: certificate signed by unknown authority"),
                   ("expired", "certificate has expired or is not yet valid"),
                   ("not-yet-valid", "certificate has expired or is not yet valid"),
                   ("empty", "client certificate is missing")):
        assert outcome(port, CASES[k].decode()) == ("EvaluationError", msg), k


def test_ca_secret_forms_equal_reference():
    """``tls.crt`` instead of ``ca.crt``, a bundle (its first certificate
    only), an unparseable ``ca.crt`` beside a good ``tls.crt``, and a
    Secret of no certificate at all."""
    bundle = CAS["p256"].pem + CAS["rsa"].pem
    for secrets in ([("a", CAS["rsa"].pem, "tls.crt")],
                    [("a", bundle, "ca.crt")],
                    [("a", b"garbage", "ca.crt")],
                    [("a", b"x", "other")]):
        ref, port = _evaluators(secrets)
        for case in ("rsa-san", "p256-no-san"):
            cert = CASES[case].decode()
            assert outcome(port, cert) == outcome(ref, cert), (secrets, case)
    # ca.crt garbage, tls.crt good: the reference tries tls.crt next
    both = []
    for ns, cluster_cls, sel_cls, mtls_cls in (
            ("ref", RefCluster, RefSelector, RefMTLS),
            ("port", PortCluster, PortSelector, PortMTLS)):
        cluster = cluster_cls()
        secret = _secret(ns, "a", b"garbage")
        secret.data["tls.crt"] = CAS["rsa"].pem
        cluster.put_secret(secret)
        ev = mtls_cls("m", sel_cls.from_spec({"matchLabels": LABELS}),
                      cluster=cluster)
        run(ev.load_secrets())
        both.append(outcome(ev, CASES["rsa-san"].decode()))
    assert both[0] == both[1] and both[1][0] == "ok"


def test_rotation_add_and_revoke_equal_reference():
    ref, port = _evaluators([])
    cert = CASES["rsa-san"].decode()
    steps = []
    for ev, ns in ((ref, "ref"), (port, "port")):
        trace = [outcome(ev, cert)[0]]
        trace.append(ev.add_k8s_secret_based_identity(
            _secret(ns, "ca-rsa", CAS["rsa"].pem)))
        trace.append(outcome(ev, cert)[0])
        # the same PEM again: nothing changed
        trace.append(ev.add_k8s_secret_based_identity(
            _secret(ns, "ca-rsa", CAS["rsa"].pem)))
        # another namespace: out of scope
        other = _secret(ns, "ca-x", CAS["p256"].pem)
        other.namespace = "elsewhere"
        trace.append(ev.add_k8s_secret_based_identity(other))
        trace.append(ev.revoke_k8s_secret_based_identity("t", "ca-rsa"))
        trace.append(outcome(ev, cert)[0])
        trace.append(ev.revoke_k8s_secret_based_identity("t", "ca-rsa"))
        trace.append(ev.get_k8s_secret_label_selectors().matches(LABELS))
        steps.append(trace)
    assert steps[1] == steps[0]
    assert steps[1] == ["EvaluationError", True, "ok", False, False, True,
                        "EvaluationError", False, True]


# ---- the reader against cryptography ---------------------------------------

def _attrs(cert_name):
    return [[(a.oid.dotted_string, a.value, a.oid._name) for a in rdn]
            for rdn in cert_name.rdns]


def _port_attrs(name):
    return [[(a.oid, a.value, a.name) for a in rdn] for rdn in name.rdns]


@pytest.mark.parametrize("case", sorted(k for k in CASES if k not in (
    "garbage", "bad-base64", "truncated", "empty", "url-encoded")))
def test_reader_fields_equal_cryptography(case):
    data = CASES[case]
    want = cx.load_pem_x509_certificate(data)
    got = px.load_pem_x509_certificate(data)
    assert got.tbs_certificate_bytes == want.tbs_certificate_bytes
    assert got.signature == want.signature
    assert got.signature_algorithm_oid == \
        want.signature_algorithm_oid.dotted_string
    assert _port_attrs(got.subject) == _attrs(want.subject)
    assert _port_attrs(got.issuer) == _attrs(want.issuer)
    assert got.not_valid_before_utc == want.not_valid_before_utc
    assert got.not_valid_after_utc == want.not_valid_after_utc
    assert got.serial_number == want.serial_number
    try:
        dns = want.extensions.get_extension_for_class(
            cx.SubjectAlternativeName).value.get_values_for_type(cx.DNSName)
    except cx.ExtensionNotFound:
        dns = None
    assert got.dns_names() == dns
    # name equality as cryptography decides it, against every trusted CA
    for k in TRUSTED:
        ca_c = CAS[k].cert
        ca_p = px.load_pem_x509_certificate(CAS[k].pem)
        assert (got.issuer == ca_p.subject) == (want.issuer == ca_c.subject)


def test_public_keys_equal_cryptography():
    for k in ("rsa", "p256", "p384", "printable"):
        want = CAS[k].cert.public_key().public_numbers()
        got = px.load_pem_x509_certificate(CAS[k].pem).public_key
        if isinstance(got, pki.RSAPublicKey):
            assert (got.n, got.e) == (want.n, want.e)
        else:
            assert (got.x, got.y, got.curve.name) == (
                want.x, want.y, {"secp256r1": "P-256",
                                 "secp384r1": "P-384"}[want.curve.name])
    assert px.load_pem_x509_certificate(CAS["ed25519"].pem).public_key is None


NAME_OIDS = [v for k, v in vars(NameOID).items() if not k.startswith("_")
             and k not in ("COUNTRY_NAME", "JURISDICTION_COUNTRY_NAME",
                           "X500_UNIQUE_IDENTIFIER")]
UNKNOWN_OIDS = [cx.ObjectIdentifier(o) for o in ("1.2.3.4.5", "2.999.1",
                                                 "1.3.6.1.4.1.4242.1.2")]
VALUE = st.text(alphabet=st.characters(blacklist_categories=("Cs", "Cc")),
                min_size=1, max_size=12)
PRINTABLE = st.text(alphabet="ABCxyz0189 '()+,-./:=?", min_size=1,
                    max_size=12)
ATTR = st.one_of(
    st.tuples(st.sampled_from(NAME_OIDS + UNKNOWN_OIDS), VALUE,
              st.sampled_from([cx.name._ASN1Type.UTF8String,
                               cx.name._ASN1Type.BMPString,
                               cx.name._ASN1Type.UniversalString])),
    st.tuples(st.sampled_from(NAME_OIDS + UNKNOWN_OIDS), PRINTABLE,
              st.just(cx.name._ASN1Type.PrintableString)))
RDNS = st.lists(st.lists(ATTR, min_size=1, max_size=3), min_size=1, max_size=5)
SIGNER = ec.generate_private_key(ec.SECP256R1())


def _random_name(rdns):
    out = []
    for rdn in rdns:
        attrs = []
        for oid, value, typ in rdn:
            a = cx.NameAttribute(oid, value, _type=typ)
            if a not in attrs:
                attrs.append(a)
        out.append(cx.RelativeDistinguishedName(attrs))
    return cx.Name(out)


@settings(max_examples=60, deadline=None)
@given(RDNS, RDNS)
def test_random_subjects_parse_as_cryptography(a, b):
    subject, issuer = _random_name(a), _random_name(b)
    cert = _build(subject, issuer, SIGNER.public_key(), SIGNER)
    data = _pem(cert)
    back = cx.load_pem_x509_certificate(data)
    got = px.load_pem_x509_certificate(data)
    assert _port_attrs(got.subject) == _attrs(back.subject)
    assert _port_attrs(got.issuer) == _attrs(back.issuer)
    assert (got.subject == got.issuer) == (back.subject == back.issuer)
    # the mTLS identity object's keys and values: the reference's mapping
    ev = PortMTLS("m", PortSelector())
    ident = {}
    for attr in got.subject:
        ident[attr.name] = attr.value
    want = {}
    for attr in back.subject:
        want[attr.oid._name] = attr.value
    assert ident == want
    assert ev.name == "m"


def test_writer_certificates_read_by_cryptography():
    """The port's test writer (used by chip_smoke.py, whose machine has no
    cryptography requirement): RSA and P-256/P-384 keys of ``utils/pki``,
    each hash, names with string types, SAN present, empty and absent;
    cryptography reads every field as written and verifies each
    signature."""
    rng = random.Random(3)
    rsa_key = pki.generate_rsa_private_key(1024, rng)
    keys = {"rsa": rsa_key, "p256": pki.generate_ec_private_key(pki.P256, rng),
            "p384": pki.generate_ec_private_key(pki.P384, rng)}
    O = cp.OID
    subject = [[(O["CN"], "w"), (O["OU"], "eng", cp.PRINTABLE)],
               [(O["O"], "org-3")], [(O["EMAIL"], "w@example.com", cp.IA5)],
               [("1.2.3.4.5", "x")]]
    for kname, key in keys.items():
        for bits in ("1", "256", "384", "512"):
            for san in (None, [], ["a.example", "b.example"]):
                ca = cp.CertAuthority(key, [[(O["CN"], f"ca-{kname}")]],
                                      hash_bits=bits)
                data = ca.issue(subject, dns_names=san)
                want = cx.load_pem_x509_certificate(data)
                got = px.load_pem_x509_certificate(data)
                assert _port_attrs(got.subject) == _attrs(want.subject)
                assert got.tbs_certificate_bytes == want.tbs_certificate_bytes
                pub = cx.load_pem_x509_certificate(ca.pem).public_key()
                alg = want.signature_hash_algorithm
                if isinstance(pub, rsa.RSAPublicKey):
                    pub.verify(want.signature, want.tbs_certificate_bytes,
                               padding.PKCS1v15(), alg)
                else:
                    pub.verify(want.signature, want.tbs_certificate_bytes,
                               ec.ECDSA(alg))
                try:
                    dns = want.extensions.get_extension_for_class(
                        cx.SubjectAlternativeName).value.get_values_for_type(
                            cx.DNSName)
                except cx.ExtensionNotFound:
                    dns = None
                assert got.dns_names() == dns == san
                ref, port = _evaluators([("ca", ca.pem, "ca.crt")])
                assert outcome(port, data.decode()) == outcome(ref, data.decode())
                assert outcome(port, data.decode())[0] == "ok"


def test_malformed_certificates_raise_value_error():
    for data in (b"", b"garbage", CASES["bad-base64"], CASES["truncated"]):
        with pytest.raises(ValueError):
            px.load_pem_x509_certificate(data)
    der = cx.load_pem_x509_certificate(CASES["rsa-san"]).public_bytes(
        serialization.Encoding.DER)
    assert px.load_der_x509_certificate(der).tbs_certificate_bytes == \
        px.load_pem_x509_certificate(CASES["rsa-san"]).tbs_certificate_bytes
    for cut in (1, 10, len(der) // 2, len(der) - 1):
        with pytest.raises(ValueError):
            px.load_der_x509_certificate(der[:cut])
    assert isinstance(PortError("x"), Exception)
