"""The port's mega-kernel module against the JAX package's Pallas kernel
(interpret mode on the CPU): the [B, W] uint8 readback byte for byte
(tolerance 0), with params from the port's own compile and with params
carried across from the JAX package's operand tree by
``params_from_numpy``.  On the CPU the wrapper runs the plain PyTorch
version; tests/test_torch_cuda.py holds the CUDA kernel to it on a card."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from authorino_tpu.ops import fused_kernel as r_fk
from authorino_tpu.ops import pattern_eval as r_pe
from authorino_tpu_torch.ops import fused_kernel as p_fk
from authorino_tpu_torch.ops import operands as p_ops

from test_torch_compiler import (CASES, PORT, REF, assert_same, batch_of,
                                 build_case, widen)


def reference_packed(rp, docs, rows, batch_pad=0):
    db = batch_of(REF, rp, docs, rows, batch_pad)
    return np.asarray(r_fk.eval_fused_kernel(
        r_pe.to_device(rp, lane="fused"), db))


def port_packed(params, pp, docs, rows, batch_pad=0, wide=False):
    db = batch_of(PORT, pp, docs, rows, batch_pad)
    out = p_fk.eval_fused_kernel(params, widen(db) if wide else db)
    assert out.dtype == torch.uint8 and out.device.type == "cpu"
    return out.numpy()


@pytest.mark.parametrize("kind,seed,ovf_assist", CASES)
def test_plain_readback_matches_pallas(kind, seed, ovf_assist):
    rp, pp, docs, rows = build_case(kind, seed, ovf_assist)
    want = reference_packed(rp, docs, rows)
    assert want.shape == (len(docs), pp.fused_pack_w)
    own = p_ops.to_device(pp, device="cpu")
    carried = p_ops.params_from_numpy(
        r_pe.to_device(rp, host=True, lane="fused"), device="cpu")
    for params in (own, carried):
        np.testing.assert_array_equal(port_packed(params, pp, docs, rows), want)
    # the int32 wire gives the same bits
    np.testing.assert_array_equal(
        port_packed(own, pp, docs, rows, wide=True), want)


def test_host_fallback_corpus_matches_pallas():
    """Without ovf-assist the overflowing rows are lossy on the device (the
    host re-decides them), yet the device bits — pad tail included — must
    still be byte-equal to the reference's."""
    rp, pp, docs, rows = build_case("lanes", 5, ovf_assist=False)
    assert batch_of(PORT, pp, docs, rows).host_fallback.any()
    want = reference_packed(rp, docs, rows, batch_pad=64)
    got = port_packed(p_ops.to_device(pp, device="cpu"), pp, docs, rows,
                      batch_pad=64)
    np.testing.assert_array_equal(got, want)


def test_out_of_range_config_id_gives_zero_bits():
    rp, pp, docs, rows = build_case("lanes", 7, True, n_docs=8)
    params = p_ops.to_device(pp, device="cpu")
    db = batch_of(PORT, pp, docs, rows)
    db.config_id[:] = [-1, pp.n_configs, 1 << 30, 0, 1, 2, 3, -7]
    got = p_fk.eval_fused_kernel(params, db).numpy()
    assert not got[[0, 1, 2, 7]].any()
    r_db = batch_of(REF, rp, docs, rows)
    r_db.config_id[:] = db.config_id
    want = np.asarray(r_fk.eval_fused_kernel(
        r_pe.to_device(rp, lane="fused"), r_db))
    np.testing.assert_array_equal(got, want)


def test_counts_plain_calls_not_launches():
    _, pp, docs, rows = build_case("lanes", 7, True, n_docs=4)
    params = p_ops.to_device(pp, device="cpu")
    l0, c0 = p_fk.launches, p_fk.plain_calls
    h = p_fk.dispatch_megakernel(params, batch_of(PORT, pp, docs, rows))
    assert h.is_ready() and np.asarray(h).shape == (4, pp.fused_pack_w)
    assert (p_fk.launches - l0, p_fk.plain_calls - c0) == (0, 1)


@pytest.mark.parametrize("counts,dp,n,floor,cap", [
    ([3, 9, 1], 2, 5, 16, None), ([], 1, 0, 16, None), ([40], 1, 10, 8, 32),
    ([40], 4, 10, 16, 64), ([2, 2], 3, 100, 1, None), ([0], 0, 1, 0, 4),
])
def test_occupancy_pad_matches_reference(counts, dp, n, floor, cap):
    assert p_fk.occupancy_pad(counts, dp, n, floor, cap) == \
        r_fk.occupancy_pad(counts, dp, n, floor, cap)


@pytest.mark.parametrize("E", [1, 2, 5, 11])
def test_unpack_attribution_matches_reference(E):
    rng = np.random.default_rng(E)
    packed = rng.integers(0, 256, size=(37, p_ops.packed_width(1 + 2 * E)),
                          dtype=np.uint8)
    for got, want in zip(p_ops.unpack_attribution(packed, E),
                         r_pe.unpack_attribution(packed, E)):
        assert_same(want, got)
    assert_same(r_pe.unpack_verdicts(packed, 1 + 2 * E),
                p_ops.unpack_verdicts(packed, 1 + 2 * E))


def test_params_from_numpy_rejects_out_of_range_indices():
    rp, _, _, _ = build_case("lanes", 7, True, n_docs=1)
    tree = r_pe.to_device(rp, host=True, lane="fused")
    tree["eval_rule"] = tree["eval_rule"].copy()
    tree["eval_rule"][0, 0] = 10 ** 6
    with pytest.raises(ValueError, match="eval_rule"):
        p_ops.params_from_numpy(tree, device="cpu")
    tree = r_pe.to_device(rp, host=True, lane="fused")
    tree["fused"]["leaf_dfa_pos"] = tree["fused"]["leaf_dfa_pos"] + 100
    with pytest.raises(ValueError, match="leaf_dfa_pos"):
        p_ops.params_from_numpy(tree, device="cpu")


def test_batch_with_out_of_range_relation_row_is_refused():
    _, pp, docs, rows = build_case("lanes", 7, True, n_docs=4)
    params = p_ops.to_device(pp, device="cpu")
    db = batch_of(PORT, pp, docs, rows)
    db.rel_rows[1, 0] = pp.rel_bits.shape[0]
    with pytest.raises(ValueError, match="rel_rows"):
        p_fk.eval_fused_kernel(params, db)


def test_kernel_argument_block_matches_the_cuda_struct():
    """The wrapper's word list names the CUDA struct's fields in order."""
    src = (Path(p_fk.__file__).parent / "csrc" / "fused_kernel.cu").read_text()
    body = src[src.index("struct FusedArgs {"):src.index("};", src.index(
        "struct FusedArgs {"))]
    names = []
    for line in body.splitlines()[1:]:
        decl = line.split("//")[0].strip().rstrip(";")
        if decl:
            names += [re.sub(r"^.*[\s*]", "", d.strip())
                      for d in decl.split(",")]
    assert tuple(names) == p_fk._ARG_FIELDS


def test_probe_plain():
    x = torch.arange(4, dtype=torch.int32)
    assert p_fk.probe_plain(x).tolist() == [1, 2, 3, 4]
