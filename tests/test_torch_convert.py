"""The port's AuthConfig conversion (``apis/convert.py``) against the
reference's: every golden of ``tests/test_conversion_golden.py`` runs
with that module's converters swapped for the port's, and every call the
golden makes is held, at tolerance 0, to the reference's output on a copy
of the same input.  Round trips of the control-plane corpora (the V2
config of the control-plane tests, the north-star and phase-10
manifests) reach the converter's canonical form after one round trip and
keep it exactly, as the reference's do."""

import copy
import inspect

import pytest

import test_conversion_golden as golden
from authorino_tpu.apis import convert as ref_convert
from authorino_tpu_torch.apis import convert as port_convert
from authorino_tpu_torch.apis import to_v1beta1, to_v1beta2
from authorino_tpu_torch.models import control_plane as cp
from authorino_tpu_torch.models import northstar
from test_control_plane import V2_SPEC


def _held_to_reference(name, calls):
    port_fn, ref_fn = getattr(port_convert, name), getattr(ref_convert, name)

    def fn(resource):
        want = ref_fn(copy.deepcopy(resource))
        got = port_fn(resource)
        assert got == want, golden._diff(want, got)
        calls.append(name)
        return got

    return fn


def _golden_cases():
    out = []
    for name, fn in sorted(vars(golden).items()):
        if not name.startswith("test_") or not callable(fn):
            continue
        marks = getattr(fn, "pytestmark", [])
        params = [m for m in marks if m.name == "parametrize"]
        if params:
            argname, values = params[0].args
            out += [pytest.param(name, {argname: v}, id=f"{name}[{i}]")
                    for i, v in enumerate(values)]
        else:
            out.append(pytest.param(name, {}, id=name))
    return out


GOLDEN = _golden_cases()


def test_every_golden_is_collected():
    names = {p.values[0] for p in GOLDEN}
    assert names == {n for n, f in vars(golden).items()
                     if n.startswith("test_") and inspect.isfunction(f)}
    assert len(GOLDEN) >= 19


@pytest.mark.parametrize("name,kwargs", GOLDEN)
def test_golden_through_the_port(monkeypatch, name, kwargs):
    calls = []
    for fn in ("to_v1beta1", "to_v1beta2"):
        monkeypatch.setattr(golden, fn, _held_to_reference(fn, calls))
    getattr(golden, name)(**kwargs)
    assert calls, "the golden converted nothing"


def _corpus():
    v2 = {"apiVersion": port_convert.API_VERSION_V1BETA2,
          "kind": "AuthConfig", "metadata": {"name": "ac", "namespace": "t"},
          "spec": copy.deepcopy(V2_SPEC)}
    return ([v2] + northstar.build_auth_configs(6, 10)
            + cp.build_auth_configs(6, 10)
            + [cp.mtls_auth_config(0),
               cp.opa_external_auth_config("http://r.invalid/p", 30)])


@pytest.mark.parametrize("k", range(len(_corpus())))
def test_corpus_round_trips_equal_reference(k):
    resource = _corpus()[k]
    for fn in (to_v1beta1, to_v1beta2):
        got = fn(copy.deepcopy(resource))
        want = getattr(ref_convert, fn.__name__)(copy.deepcopy(resource))
        assert got == want
    # one round trip reaches the converter's canonical form, which every
    # later round trip keeps exactly
    v2 = to_v1beta2(to_v1beta1(to_v1beta2(copy.deepcopy(resource))))
    assert to_v1beta2(to_v1beta1(copy.deepcopy(v2))) == v2
    assert v2 == ref_convert.to_v1beta2(ref_convert.to_v1beta1(
        ref_convert.to_v1beta2(copy.deepcopy(resource))))
    v1 = to_v1beta1(copy.deepcopy(v2))
    assert to_v1beta1(to_v1beta2(copy.deepcopy(v1))) == v1
