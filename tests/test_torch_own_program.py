"""The mega-kernel's per-config program (``operands._own_program``) on the
CPU, with no card.

``interpret`` walks the program row by row doing what the v3 kernel
(``ops/csrc/fused_kernel.cu``) does: it stages the row's operands out of
the staging buffer by the wrapper's stage layout, evaluates the row's own
leaves, walks its own DFA rows through the
uploaded table image, runs its own circuit level by level and packs the
evaluator bits.  It must equal the plain version and the JAX package's
interpret-mode Pallas kernel byte for byte (tolerance 0: the readback is a
uint8 bitmask), and each config's program must be what an independent
reachability walk written here gives."""

import dataclasses

import numpy as np
import pytest
import torch

from authorino_tpu.ops import pattern_eval as r_pe
from authorino_tpu_torch.compiler import compile_corpus
from authorino_tpu_torch.compiler.compile import (
    OP_EQ, OP_EXCL, OP_INCL, OP_NEQ, OP_NUM_GT, OP_NUM_GE, OP_NUM_LT,
    OP_REGEX_DFA, OP_RELATION, OP_CPU, OP_TREE_CPU)
from authorino_tpu_torch.models import corpora
from authorino_tpu_torch.ops import fused_kernel as p_fk
from authorino_tpu_torch.ops import operands as p_ops

from test_torch_compiler import CASES, PORT, batch_of, build_case, widen
from test_torch_fused_kernel import reference_packed


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


def interpret(params, db) -> np.ndarray:
    """[B, W] uint8 from the per-config program, row by row, as v3 runs it."""
    kp = {k: _np(v) for k, v in params["kernel"].items()}
    buf, layout = p_ops.fuse_batch(db)
    lay = {name: (dt, shape, off) for name, dt, shape, off, _ in layout}

    def off(name):
        return lay[name][2] if name in lay else -1

    def dim(name, axis):
        return lay[name][1][axis] if name in lay else 0

    def ld(at, width):
        return int.from_bytes(buf[at:at + width].tobytes(), "little",
                              signed=True)

    idw = 4 if lay["attrs_val"][0] == "int32" else 2
    B, A = lay["attrs_val"][1]
    _, M, K = lay["members_c"][1]
    C, NB, LB = dim("cpu_dense", 1), dim("attr_bytes", 1), dim("attr_bytes", 2)
    NN, NR = dim("attrs_num", 1), dim("rel_rows", 1)
    # the row stage as the wrapper lays it out: size, then each segment's
    # start (attrs_val, members_c, member_ovf, byte_ovf, attr_bytes,
    # attrs_num, num_valid, rel_rows), each segment one row of its operand
    T, starts, ends = p_fk.stage_layout(params, layout)
    rows_at = [off(name) for name in p_fk.STAGE_SEGMENTS]
    row_bytes = [A * idw, M * K * idw, M, NB, NB * LB, 4 * NN, NN, 4 * NR]
    G, E = params["eval_rule"].shape
    W = p_ops.packed_width(1 + 2 * E)
    image, S, tab_bytes = kp["dfa_image"], kp["S"], kp["tab_bytes"]
    rel_bits = _np(params["rel_bits"])
    has_dfa = image is not None and off("attr_bytes") >= 0
    has_num = params["leaf_num_slot"] is not None and off("attrs_num") >= 0
    has_rel = rel_bits is not None and off("rel_rows") >= 0
    has_movf = off("member_ovf") >= 0
    out = np.zeros((B, W), dtype=np.uint8)
    for b in range(B):
        cfg = ld(off("config_id") + 4 * b, 4)
        rs = np.zeros(T, dtype=np.uint8)  # alignment gaps stay 0
        for g in range(8):
            n = ends[g] - starts[g]
            assert n in (0, row_bytes[g]) and starts[g] % 4 == 0
            at = rows_at[g] + b * n
            rs[starts[g]:ends[g]] = buf[at:at + n]
        s_av, s_mc, s_movf, s_bovf, s_ab, s_num, s_nv, s_rel = starts

        def rd(at, width):
            return int.from_bytes(rs[at:at + width].tobytes(), "little",
                                  signed=True)

        if not 0 <= cfg < G:
            continue                      # all-zero bits
        lo, hi = kp["cfg_off"][cfg], kp["cfg_off"][cfg + 1]
        nl, nn, nd, nv = (int(x) for x in hi[:4] - lo[:4])
        cb = np.full(kp["max_local"], 2, dtype=np.int64)  # 2: never written
        cb[0], cb[1] = 1, 0

        def read(i):
            assert cb[i] in (0, 1), f"row {b} reads unwritten slot {i}"
            return int(cb[i])

        # leaves: one 16-byte record each
        for i in range(nl):
            op, k, slot, ccol = (int(x) for x in kp["leaf_rec"][lo[0] + i])
            cpu = int(ccol >= 0 and buf[off("cpu_dense") + b * C + ccol] != 0)
            res = 0
            if op in (OP_EQ, OP_NEQ):
                eq = rd(s_av + slot * idw, idw) == k
                res = int(eq if op == OP_EQ else not eq)
            elif op in (OP_INCL, OP_EXCL):
                if has_movf and rs[s_movf + slot]:
                    res = cpu
                else:
                    base = s_mc + slot * K * idw
                    incl = any(rd(base + j * idw, idw) == k for j in range(K))
                    res = int(incl if op == OP_INCL else not incl)
            elif op == OP_REGEX_DFA:
                if has_dfa and not rs[s_bovf + slot]:
                    continue              # the DFA walk writes this slot
                res = cpu
            elif op in (OP_CPU, OP_TREE_CPU):
                res = cpu
            elif op >= OP_NUM_GT:
                if op == OP_RELATION:
                    if has_rel:
                        row = rd(s_rel + 4 * slot, 4)
                        res = int(rel_bits[row, k >> 3]) >> (k & 7) & 1
                elif has_num:
                    lv = rd(s_num + 4 * slot, 4)
                    ok = rs[s_nv + slot] != 0
                    c = (lv > k if op == OP_NUM_GT else lv >= k
                         if op == OP_NUM_GE else lv < k
                         if op == OP_NUM_LT else lv <= k)
                    res = int(ok and c)
            cb[2 + i] = res
        # DFA rows: one walk each, in the uploaded table image
        if has_dfa:
            for j in range(nd):
                tab, slot, leaf, _ = (int(x) for x in kp["dfa_rec"][lo[2] + j])
                if rs[s_bovf + slot]:
                    continue
                at = s_ab + slot * LB
                st = 0
                for byte in rs[at:at + LB]:
                    st = int(image[(tab * S + st) * 256 + int(byte)])
                cb[leaf] = int(image[tab_bytes + tab * S + st] != 0)
        # the circuit, one level at a time: on the children's bit mask
        # where the row buffer fits 64 slots, else on the children's list
        fast = nl <= 32 and nn <= 32 and nd <= 32 and 2 + nl + nn <= 64
        prev = 0
        for v in range(nv):
            end = int(kp["lvl_end"][lo[3] + v])
            for i in range(prev, end):
                kb, meta, m_lo, m_hi = (int(x) & 0xFFFFFFFF
                                        for x in kp["node_rec"][lo[1] + i])
                if fast:
                    mask = m_hi << 32 | m_lo
                    kids = [read(j) for j in range(64) if mask >> j & 1]
                else:
                    kb += int(lo[4])
                    kids = [read(int(c))
                            for c in kp["node_kids"][kb:kb + (meta >> 1)]]
                cb[2 + nl + i] = int(all(kids) if meta & 1 else any(kids))
            prev = end
        # evaluators → [verdict, rule[E], skipped[E]], little bit order
        cols = np.zeros(8 * W, dtype=np.uint8)
        verdict = 1
        for e in range(E):
            w = int(kp["ev"][cfg, e]) & 0xFFFFFFFF
            r, s = read(w & 0xFFFF), 1 - read(w >> 16)
            cols[1 + e], cols[1 + E + e] = r, s
            verdict &= r | s
        cols[0] = verdict
        out[b] = np.packbits(cols, bitorder="little")
    return out


def plain(params, db):
    return p_fk.eval_fused_kernel(params, db).numpy()


def both_params(rp, pp):
    return (p_ops.to_device(pp, device="cpu"),
            p_ops.params_from_numpy(r_pe.to_device(rp, host=True,
                                                   lane="fused"),
                                    device="cpu"))


@pytest.mark.parametrize("kind,seed,ovf_assist", CASES)
def test_interpreter_matches_plain_and_pallas(kind, seed, ovf_assist):
    rp, pp, docs, rows = build_case(kind, seed, ovf_assist)
    want = reference_packed(rp, docs, rows)
    db = batch_of(PORT, pp, docs, rows)
    for params in both_params(rp, pp):
        for d in (db, widen(db)):
            got = interpret(params, d)
            np.testing.assert_array_equal(got, plain(params, d))
            np.testing.assert_array_equal(got, want)


def test_interpreter_on_the_host_fallback_corpus():
    rp, pp, docs, rows = build_case("lanes", 5, ovf_assist=False)
    db = batch_of(PORT, pp, docs, rows, batch_pad=64)
    assert db.host_fallback.any()
    want = reference_packed(rp, docs, rows, batch_pad=64)
    for params in both_params(rp, pp):
        np.testing.assert_array_equal(interpret(params, db), want)
        np.testing.assert_array_equal(plain(params, db), want)


# ---------------------------------------------------------------------------
# the program against an independent walk
# ---------------------------------------------------------------------------


def independent_program(tree, g):
    """Config g's program rebuilt from the tree by a recursive walk: leaf
    records, (meta, kids) per node, level ends, DFA records, evaluators."""
    fz = tree["fused"]
    L = tree["leaf_op"].shape[0]
    nodes = {}                              # global slot → (is_and, kids)
    base = 2 + L
    level_of = {}
    for lv, (ch, ia) in enumerate(tree["levels"]):
        for r in range(ch.shape[0]):
            pad = 0 if ia[r] else 1
            nodes[base + r] = (bool(ia[r]), [int(c) for c in ch[r] if c != pad])
            level_of[base + r] = lv
        base += ch.shape[0]
    seen = set()

    def walk(s):
        if s < 2 or s in seen:
            return
        seen.add(s)
        for c in nodes.get(s, (None, []))[1]:
            walk(c)

    for e in range(tree["eval_rule"].shape[1]):
        walk(int(tree["eval_rule"][g, e]))
        if tree["eval_has_cond"][g, e]:
            walk(int(tree["eval_cond"][g, e]))
    leaves = sorted(s for s in seen if s < 2 + L)
    own_nodes = sorted(s for s in seen if s >= 2 + L)
    local = {0: 0, 1: 1}
    local.update({s: 2 + i for i, s in enumerate(leaves + own_nodes)})
    sc = list(tree["cpu_scatter_idx"])
    recs, dfa = [], []
    for s in leaves:
        l = s - 2
        op = int(fz["leaf_op_i8"][l])
        k, slot = int(tree["leaf_const"][l]), 0
        if op in (OP_EQ, OP_NEQ):
            slot = int(tree["leaf_attr"][l])
        elif op in (OP_INCL, OP_EXCL):
            slot = int(tree["member_slot_of_leaf"][l])
        elif op == OP_RELATION:
            if tree["rel_bits"] is not None:
                slot = int(tree["leaf_rel_slot"][l])
                k = int(tree["leaf_rel_col"][l])
        elif op == OP_REGEX_DFA and tree["dfa_tables"] is not None:
            pos = int(fz["leaf_dfa_pos"][l])
            slot = int(fz["dfa_byte_slot_g"][pos])
            dfa.append([int(fz["dfa_table_of_row_g"][pos]), slot, local[s], 0])
        elif op >= OP_NUM_GT and tree["leaf_num_slot"] is not None:
            slot = int(tree["leaf_num_slot"][l])
        recs.append([op, k, slot, sc.index(l) if l in sc else -1])
    n_dfa = sum(1 for s in leaves if int(fz["leaf_op_i8"][s - 2]) == OP_REGEX_DFA
                and tree["dfa_tables"] is not None)
    fast = (len(leaves) <= 32 and len(own_nodes) <= 32 and n_dfa <= 32
            and 2 + len(leaves) + len(own_nodes) <= 64)
    node_progs = [(len(nodes[s][1]) << 1 | nodes[s][0],
                   [local[c] for c in nodes[s][1]],
                   sum({1 << local[c] for c in nodes[s][1]}) if fast else 0)
                  for s in own_nodes]
    ends, lv_seen = [], [level_of[s] for s in own_nodes]
    for i, lv in enumerate(lv_seen):
        if i + 1 == len(lv_seen) or lv_seen[i + 1] != lv:
            ends.append(i + 1)
    ev = [local[int(tree["eval_rule"][g, e])]
          | local[int(tree["eval_cond"][g, e])
                  if tree["eval_has_cond"][g, e] else 0] << 16
          for e in range(tree["eval_rule"].shape[1])]
    return leaves, own_nodes, recs, node_progs, ends, dfa, ev


def program_of(kp, g):
    lo, hi = kp["cfg_off"][g], kp["cfg_off"][g + 1]
    kids = kp["node_kids"][lo[4]:hi[4]]
    recs = kp["node_rec"][lo[1]:hi[1]].astype(np.int64) & 0xFFFFFFFF
    nodes = [(int(m), [int(c) for c in kids[kb:kb + (m >> 1)]], int(hi_ << 32 | lo_))
             for kb, m, lo_, hi_ in recs]
    return (kp["leaf_rec"][lo[0]:hi[0]].tolist(), nodes,
            kp["lvl_end"][lo[3]:hi[3]].tolist(),
            kp["dfa_rec"][lo[2]:hi[2]].tolist(),
            (kp["ev"][g].astype(np.int64) & 0xFFFFFFFF).tolist())


@pytest.mark.parametrize("kind,seed,ovf_assist", CASES)
def test_reachable_sets_match_an_independent_walk(kind, seed, ovf_assist):
    _, pp, _, _ = build_case(kind, seed, ovf_assist, n_docs=1)
    tree = p_ops.to_device(pp, host=True)
    kp = p_ops._kernel_layout(tree)
    G = tree["eval_rule"].shape[0]
    sizes = []
    for g in range(G):
        leaves, nodes, recs, node_progs, ends, dfa, ev = \
            independent_program(tree, g)
        assert program_of(kp, g) == (recs, node_progs, ends, dfa, ev), g
        sizes.append((2 + len(leaves) + len(nodes),
                      sum(len(kids) for _, kids, _ in node_progs)))
    assert kp["max_local"] == max(n for n, _ in sizes)
    assert kp["max_kids"] == max(k for _, k in sizes)


def test_large_config_takes_the_buffer_path():
    """A config whose row buffer outgrows 64 slots (and one warp's 32
    leaves) carries no children masks: the kernel walks its children from
    the list, looping leaves over the lanes.  Its corpus also has more
    evaluator columns than one ballot holds."""
    cfgs = corpora.wide_config_corpus()
    policy = small_policy(cfgs)
    params = p_ops.to_device(policy, device="cpu")
    kp = params["kernel"]
    off = kp["cfg_off"].numpy()
    assert off[1, 0] - off[0, 0] > 32 and kp["max_local"] > 64
    assert not kp["node_rec"].numpy()[off[0, 1]:off[1, 1], 2:].any()
    docs = corpora.wide_config_docs()
    rows = [i % 2 for i in range(len(docs))]
    db = PORT.pack(policy, PORT.encode(policy, docs, rows))
    got = interpret(params, db)
    np.testing.assert_array_equal(got, plain(params, db))
    assert (got[0::2, 0] & 1).any() and not (got[0::2, 0] & 1).all()
    assert params["eval_rule"].shape[1] > 31 and got.shape[1] > 8


def test_program_is_the_same_from_both_uploads():
    rp, pp, _, _ = build_case("lanes", 19, True, n_docs=1)
    own, carried = both_params(rp, pp)
    for name, arr in own["kernel"].items():
        if isinstance(arr, torch.Tensor):
            np.testing.assert_array_equal(arr.numpy(),
                                          carried["kernel"][name].numpy())
        elif name != "bounds":
            assert arr == carried["kernel"][name], name


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------


def small_policy(cfgs, **kw):
    return compile_corpus(cfgs, members_k=corpora.LANES_K, **kw)


def test_config_without_cond_reads_the_true_slot():
    ns = corpora.port_classes()
    Op = ns.Operator
    cfgs = [ns.ConfigRules(name="a", evaluators=[
                (None, ns.Pattern("req.m", Op.EQ, "GET")),
                (ns.Pattern("req.n", Op.EQ, "1"),
                 ns.Pattern("req.m", Op.NEQ, "PUT"))])]
    policy = small_policy(cfgs)
    params = p_ops.to_device(policy, device="cpu")
    ev = params["kernel"]["ev"].numpy().astype(np.int64) & 0xFFFFFFFF
    assert ev[0, 0] >> 16 == 0 and ev[0, 1] >> 16 >= 2
    docs = [{"req": {"m": m, "n": n}} for m in ("GET", "PUT", "POST")
            for n in ("1", "2")]
    db = PORT.pack(policy, PORT.encode(policy, docs, [0] * len(docs)))
    np.testing.assert_array_equal(interpret(params, db), plain(params, db))


def test_two_configs_share_a_node():
    ns = corpora.port_classes()
    Op = ns.Operator
    shared = ns.All(ns.Pattern("req.m", Op.EQ, "GET"),
                    ns.Pattern("req.p", Op.EQ, "/x"))
    cfgs = [ns.ConfigRules(name="a", evaluators=[(None, shared)]),
            ns.ConfigRules(name="b", evaluators=[
                (None, ns.Any_(shared, ns.Pattern("req.q", Op.EQ, "1")))])]
    policy = small_policy(cfgs)
    tree = p_ops.to_device(policy, host=True)
    walks = [independent_program(tree, g)[1] for g in (0, 1)]
    assert set(walks[0]) < set(walks[1])      # b reaches a's node too
    params = p_ops.to_device(policy, device="cpu")
    docs = [{"req": {"m": m, "p": p, "q": q}} for m in ("GET", "PUT")
            for p in ("/x", "/y") for q in ("1", "0")]
    rows = [i % 2 for i in range(len(docs))]
    db = PORT.pack(policy, PORT.encode(policy, docs, rows))
    got = interpret(params, db)
    np.testing.assert_array_equal(got, plain(params, db))
    verdict = got[:, 0] & 1
    assert verdict.any() and not verdict.all()


def test_out_of_range_config_id_gives_zero_bits():
    _, pp, docs, rows = build_case("lanes", 7, True, n_docs=8)
    params = p_ops.to_device(pp, device="cpu")
    db = batch_of(PORT, pp, docs, rows)
    db.config_id[:] = [-1, pp.n_configs, 1 << 30, 0, 1, 2, 3, -7]
    got = interpret(params, db)
    assert not got[[0, 1, 2, 7]].any()
    np.testing.assert_array_equal(got, plain(params, db))


def test_cpu_padding_column_belongs_to_no_leaf():
    """Forced shapes pad the CPU lane (and the leaves, the levels' rows and
    the configs): padding columns map to the dump slot L, which no leaf
    reads, and padded config rows evaluate like any other."""
    cfgs = corpora.all_lanes_corpus(7)
    natural = small_policy(cfgs, ovf_assist=True).shape_targets()
    targets = dataclasses.replace(
        natural, n_cpu_leaves=natural.n_cpu_leaves + 3,
        n_leaves=natural.n_leaves + 8, n_configs=natural.n_configs + 2,
        levels=tuple((r + 2, w + 1) for r, w in natural.levels))
    policy = small_policy(cfgs, ovf_assist=True, targets=targets)
    params = p_ops.to_device(policy, device="cpu")
    sc = params["cpu_scatter_idx"].numpy()
    pad_cols = np.nonzero(sc == params["leaf_op"].shape[0])[0]
    assert pad_cols.size == 3
    cols = params["kernel"]["leaf_rec"].numpy()[:, 3]
    assert not np.isin(cols, pad_cols).any()
    docs = corpora.all_lanes_docs(7, 24)
    rows = [i % policy.n_configs for i in range(len(docs))]
    assert policy.n_configs > len(cfgs)        # padded config rows ride too
    db = PORT.pack(policy, PORT.encode(policy, docs, rows))
    db.cpu_dense[:, pad_cols] = True           # junk in the padding
    np.testing.assert_array_equal(interpret(params, db), plain(params, db))


def _flip_cpu_column(params, db, op, ovf_name):
    """Rows whose own config has a leaf of ``op`` under the ``ovf_name``
    mask: flipping that leaf's CPU-lane column must change what interpret
    and plain read, identically."""
    kp = {k: _np(v) for k, v in params["kernel"].items()}
    ovf = getattr(db, ovf_name)
    hits = 0
    for b, g in enumerate(db.config_id):
        lo, hi = kp["cfg_off"][g], kp["cfg_off"][g + 1]
        for op_, _, slot, col in kp["leaf_rec"][lo[0]:hi[0]]:
            if op_ == op and col >= 0 and ovf[b, slot]:
                db.cpu_dense[b, col] = ~db.cpu_dense[b, col]
                hits += 1
    return hits


def test_regex_leaf_under_byte_ovf_reads_the_cpu_lane():
    _, pp, docs, rows = build_case("lanes", 7, True)
    params = p_ops.to_device(pp, device="cpu")
    db = batch_of(PORT, pp, docs, rows)
    before = interpret(params, db)
    assert _flip_cpu_column(params, db, OP_REGEX_DFA, "byte_ovf")
    after = interpret(params, db)
    np.testing.assert_array_equal(after, plain(params, db))
    assert (after != before).any()


def test_excl_under_member_ovf_reads_the_cpu_lane_as_it_is():
    ns = corpora.port_classes()
    Op = ns.Operator
    cfgs = [ns.ConfigRules(name="a", evaluators=[
        (None, ns.Pattern("auth.roles", Op.EXCL, "r1"))])]
    policy = small_policy(cfgs, ovf_assist=True)
    params = p_ops.to_device(policy, device="cpu")
    docs = [{"auth": {"roles": [f"r{i}" for i in range(n)]}}
            for n in (1, 2, corpora.LANES_K + 3, corpora.LANES_K + 5)]
    db = PORT.pack(policy, PORT.encode(policy, docs, [0] * len(docs)))
    assert db.member_ovf is not None and db.member_ovf.any()
    before = interpret(params, db)
    np.testing.assert_array_equal(before, plain(params, db))
    assert _flip_cpu_column(params, db, OP_EXCL, "member_ovf")
    after = interpret(params, db)
    np.testing.assert_array_equal(after, plain(params, db))
    # the CPU lane's bit is the final answer: no negation on top of it
    ovf_rows = db.member_ovf.any(axis=1)
    col = params["kernel"]["leaf_rec"].numpy()[0, 3]
    np.testing.assert_array_equal(after[ovf_rows, 0] & 1,
                                  db.cpu_dense[ovf_rows, col].astype(np.uint8))


def test_local_index_width_is_enforced(monkeypatch):
    _, pp, _, _ = build_case("lanes", 7, True, n_docs=1)
    tree = p_ops.to_device(pp, host=True)
    need = p_ops._kernel_layout(tree)["max_local"]
    monkeypatch.setattr(p_ops, "LOCAL_LIMIT", need - 1)
    with pytest.raises(ValueError, match="16 bits"):
        p_ops._kernel_layout(tree)


def test_dfa_image_is_padded_for_one_bulk_copy():
    _, pp, _, _ = build_case("lanes", 7, True, n_docs=1)
    kp = p_ops._kernel_layout(p_ops.to_device(pp, host=True))
    T, S, _ = pp.dfa_tables.shape
    assert kp["tab_bytes"] % 16 == 0 and kp["dfa_image"].size % 16 == 0
    np.testing.assert_array_equal(kp["dfa_image"][:T * S * 256],
                                  pp.dfa_tables.reshape(-1))
    np.testing.assert_array_equal(
        kp["dfa_image"][kp["tab_bytes"]:kp["tab_bytes"] + T * S],
        pp.dfa_accept.reshape(-1).astype(np.uint8))
