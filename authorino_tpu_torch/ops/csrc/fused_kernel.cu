// Fused policy-evaluation mega-kernel for Hopper (sm_90a), v3.
//
// Replaces the Pallas kernel of the JAX package,
// authorino_tpu/ops/fused_kernel.py::_pallas_wrap (body _fused_packed ->
// _eval_verdicts_fused, plus the in-kernel operand decode
// pattern_eval._defuse), and its probe fused_kernel_supported.
//
// One launch turns one micro-batch's staging buffer into the [B, W] uint8
// little-endian bitmask [own verdict, own rule[E], own skipped[E]]:
//   decode -> leaf compare -> membership -> CPU lane -> DFA scan ->
//   numeric lane -> relation lane -> membership-overflow assist -> op
//   cascade -> And/Or circuit -> verdict table -> bitpack.
//
// What bounds it on an H100.  A row's output covers only its own config,
// so a row needs only that config's subcircuit: on the north-star corpus
// (1k configs x 10 rules) about 9 leaves, 2 nodes and 0-3 DFA rows, some
// 100 integer operations, ~24k for a batch of 256 -- under a nanosecond
// at the card's INT32 rate.  The bytes it must move (each operand once:
// ~32 KB of staging buffer, ~220 KB of corpus params, B * W out) take
// under 0.1 us at 3.35 TB/s, so bytes set the bound.  Both are far below
// one launch: what the kernel waits on is a chain of dependent loads
// (config id -> the config's offsets -> its records -> the row's operands
// -> the circuit), so its time is the launch plus that chain's latency.
// v2 ran one 1,024-thread block per row over all 8,192 leaves and all
// 1,000 nodes of the corpus (~800x the work a row needs, each block
// re-reading ~200 KB of params from L2) behind a block-wide barrier after
// each row's DFA walk through L2.
//
// What v3 does about it.  The host builds a per-config program at upload
// (ops/operands.py::_own_program): each config's reachable leaves as
// 16-byte records, its nodes in level order with children as local
// indices into the row's buffer [TRUE, FALSE, own leaves, own nodes], its
// DFA rows and its evaluators.  Then, one warp per row, 4 rows per block:
//   - prologue: the row's slice of the staging buffer (ids, byte and
//     numeric operands, overflow masks) is loaded while the config id is
//     in flight and lands in the warp's shared memory; the config's
//     offsets follow, then all its records in one load round (a leaf, a
//     node, a DFA row per lane, the level ends, the evaluator words).
//     Three dependent rounds to L2, the floor of this layout.
//   - leaves: lane i evaluates leaf i from the staged operands.
//   - DFA: the tables and accept bits (one 16-B padded image, ~21.6 KB on
//     the north-star corpus) arrive in shared memory by one TMA bulk copy
//     (cp.async.bulk, completing on an mbarrier) issued at block start;
//     the warps wait on the barrier only before the walk, and lane j
//     walks DFA row j, LB dependent steps in shared memory.  Where the
//     image does not fit beside the warps' regions, the SMEM_TABLES=false
//     instance reads it with __ldg (the wrapper picks the instance from
//     the sizes: a placement, not a fallback).
//   - circuit: where the row's buffer fits 64 slots (nearly every config)
//     it lives in one 64-bit register: the leaves' results come in by one
//     __ballot_sync, the DFA bits by an OR-reduce, and each level is one
//     ballot of its nodes, node j on lane j against its children's mask.
//     Larger configs keep the buffer in shared memory (max_local bytes a
//     warp) and run each level across the lanes, __syncwarp() between.
//   - verdict: the evaluator bits combine with __ballot_sync and lane w
//     writes byte w of the row.
// There is no __syncthreads() after the prologue.  Rows per block are a
// compile-time 4 (kWarps): 2, 4 and 8 measured within 3% of each other at
// B = 256 on an H100 80GB HBM3 at 700 W (PERF.md), and 4 takes half the
// table copies of 2.  No tensor cores: the work is ~100 integer gathers
// and compares per row with no dense product in it.
//
// The staging buffer is packed without alignment padding, so the config
// id is assembled from byte loads; the stage in shared memory starts each
// operand 4-byte aligned, so ids, numbers and DFA bytes are read at their
// width there.  Every index operand was range-checked on the host at
// upload (and each batch's row-dependent indices before launch), so the
// kernel reads without bounds checks.  Absent lanes arrive as null
// pointers / negative offsets / empty stage segments.
//
// The STAMP instance (entry authz_fused_stamp_launch, used only by
// chip_smoke.py) writes clock64() stamps per row after each phase:
// prologue, leaves, copy wait, DFA walk, circuit, verdict.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 4;  // rows (one warp each) per block
constexpr int64_t kMagic = 0x4155544846555633LL;  // layout version tag
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStamps = 8;  // stamp words per row (7 used)
constexpr int kSegs = 8;         // staged operand segments of a row
constexpr int kStageUnroll = 2;  // bytes per lane and segment in flight

// op codes (compiler/compile.py OP_*)
constexpr int OP_EQ = 0, OP_NEQ = 1, OP_INCL = 2, OP_EXCL = 3, OP_CPU = 4,
              OP_TREE_CPU = 6, OP_REGEX_DFA = 7, OP_NUM_GT = 8,
              OP_NUM_GE = 9, OP_NUM_LT = 10, OP_RELATION = 12;

// Every field is 8 bytes wide, so the struct has no padding and mirrors
// the int64 word list the Python wrapper builds (ops/fused_kernel.py
// _ARG_FIELDS), field for field and in the same order.
struct FusedArgs {
  int64_t magic;
  uint8_t* out;                 // [B, W]
  const uint8_t* buf;           // staging buffer
  int64_t B, wide;
  int64_t off_attrs_val, off_members_c, off_cpu_dense, off_config_id;
  int64_t off_attr_bytes, off_byte_ovf, off_attrs_num, off_num_valid;
  int64_t off_rel_rows, off_member_ovf;
  int64_t A, M, K, C, NB, LB, NN, NR;
  const int32_t* cfg_off;       // [G+1, 8]: leaves, nodes, DFA, levels, kids
  const int32_t* leaf_rec;      // [*, 4]: op, k, slot, cpu col
  const int32_t* node_rec;      // [*, 4]: own kid offset, n_kids<<1 | is_and,
                                //   64-bit mask of the children's slots
  const int32_t* node_kids;     // [*] local indices, config by config
  const int32_t* lvl_end;       // [*] level ends in the config's node list
  const int32_t* dfa_rec;       // [*, 4]: table, byte slot, local leaf, 0
  const uint32_t* ev;           // [G, E]: local rule | local cond << 16
  int64_t G, E, W, has_num;
  const uint8_t* dfa_image;     // tables [T, S, 256] | accept [T, S] (null:
  int64_t S, tab_bytes, image_bytes;  //   no DFA lane), each 16-B padded
  const uint8_t* rel_bits;      // [Rp, RW] (null: no relation lane)
  int64_t RW;
  int64_t smem_tables, smem_head, warp_bytes, kids_at, masks_at;
  // the row's staged operands: where they start in the warp's region,
  // their size, each segment's offset (attrs_val's is 0; each 4-byte
  // aligned) and end (rel_rows ends at stage_bytes)
  int64_t stage_at, stage_bytes;
  int64_t s_mc, s_movf, s_bovf, s_ab, s_num, s_nv, s_rel;
  int64_t e_av, e_mc, e_movf, e_bovf, e_ab, e_num, e_nv;  // segment ends
};
static_assert(sizeof(FusedArgs) == 61 * 8, "FusedArgs must be 61 words");

__device__ __forceinline__ int32_t ld_i32(const uint8_t* p) {
  return (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                   ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

// An id out of the row's stage in shared memory, where every segment
// starts 4-byte aligned (fused_kernel.py::stage_layout).
template <bool WIDE>
__device__ __forceinline__ int32_t ld_id(const uint8_t* base, int64_t i) {
  return WIDE ? reinterpret_cast<const int32_t*>(base)[i]
              : reinterpret_cast<const int16_t*>(base)[i];
}

__device__ __forceinline__ int32_t ld_s32(const uint8_t* p) {
  return *reinterpret_cast<const int32_t*>(p);
}

template <bool SMEM>
__device__ __forceinline__ uint8_t ld_tab(const uint8_t* p) {
  return SMEM ? *p : __ldg(p);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

template <bool STAMP>
__device__ __forceinline__ void stamp(unsigned long long* row, int k,
                                      int lane) {
  if (STAMP) {
    __syncwarp();
    if (lane == 0) row[k] = clock64();
  }
}

// Which lanes a row has: absent lanes arrive as null pointers / negative
// offsets, and the row's operands sit staged in shared memory (rs).
struct RowLanes {
  const uint8_t* rs;  // the row's staged operands
  const uint8_t* cd;  // the row's CPU-lane columns (device memory)
  bool dfa, num, rel, movf;
};

// One leaf's result (0 or 1) from its 16-byte record, or -1 when a DFA
// walk decides it.  Mirrors the op cascade of the plain version.
template <bool WIDE>
__device__ __forceinline__ int eval_leaf(const FusedArgs& a, const int4 r,
                                         const RowLanes& w) {
  const int op = r.x;
  const int32_t k = r.y;
  const int slot = r.z;
  bool cpu = false;  // the result is the CPU lane's bit
  int res = 0;
  if (op == OP_EQ || op == OP_NEQ) {
    const bool eq = ld_id<WIDE>(w.rs, slot) == k;
    res = (op == OP_EQ) ? eq : !eq;
  } else if (op == OP_INCL || op == OP_EXCL) {
    if (w.movf && w.rs[a.s_movf + slot] != 0) {
      cpu = true;  // EXCL too: the encoder stores the final answer
    } else {
      constexpr int IDW = WIDE ? 4 : 2;
      const uint8_t* m = w.rs + a.s_mc + (int64_t)slot * a.K * IDW;
      bool incl = false;
#pragma unroll 8
      for (int j = 0; j < (int)a.K; ++j) incl |= ld_id<WIDE>(m, j) == k;
      res = (op == OP_INCL) ? incl : !incl;
    }
  } else if (op == OP_REGEX_DFA) {
    if (w.dfa && w.rs[a.s_bovf + slot] == 0) return -1;  // the DFA walk's
    cpu = true;  // overflowed bytes, or no DFA lane: the CPU lane
  } else if (op == OP_CPU || op == OP_TREE_CPU) {
    cpu = true;
  } else if (op >= OP_NUM_GT) {
    if (op == OP_RELATION) {
      if (w.rel) {
        const int row = ld_s32(w.rs + a.s_rel + 4 * slot);
        const uint8_t byte =
            __ldg(a.rel_bits + (int64_t)row * a.RW + (k >> 3));
        res = (byte >> (k & 7)) & 1;
      }
    } else if (w.num) {
      const int32_t lv = ld_s32(w.rs + a.s_num + 4 * slot);
      const bool ok = w.rs[a.s_nv + slot] != 0;
      const bool cmp = op == OP_NUM_GT   ? lv > k
                       : op == OP_NUM_GE ? lv >= k
                       : op == OP_NUM_LT ? lv < k
                                         : lv <= k;
      res = ok && cmp;
    }
  }
  // OP_ERROR (and any other code) stays false
  if (cpu) res = r.w >= 0 ? (w.cd[r.w] != 0) : 0;
  return res;
}

// One DFA row (table, byte slot, local leaf): the accept bit after LB
// dependent steps through the table image, or -1 when the row's bytes
// overflowed (its leaf took the CPU lane).
template <bool SMEM_TABLES>
__device__ __forceinline__ int walk_dfa(const FusedArgs& a, const int4 r,
                                        const uint8_t* tabs,
                                        const RowLanes& w) {
  if (w.rs[a.s_bovf + r.y] != 0) return -1;
  const int LB = (int)a.LB;
  const uint8_t* bytes = w.rs + a.s_ab + r.y * LB;
  const uint8_t* tab = tabs + (int64_t)r.x * a.S * 256;
  int st = 0;
  if ((LB & 3) == 0) {  // the row's bytes start 4-byte aligned: by words
    const uint32_t* w4 = reinterpret_cast<const uint32_t*>(bytes);
#pragma unroll 4
    for (int i = 0; i < LB / 4; ++i) {
      const uint32_t q = w4[i];
#pragma unroll
      for (int t = 0; t < 4; ++t)
        st = ld_tab<SMEM_TABLES>(tab + st * 256 + ((q >> (8 * t)) & 0xff));
    }
  } else {
    for (int i = 0; i < LB; ++i)
      st = ld_tab<SMEM_TABLES>(tab + st * 256 + bytes[i]);
  }
  return ld_tab<SMEM_TABLES>(tabs + a.tab_bytes + (int64_t)r.x * a.S + st) !=
         0;
}

__device__ __forceinline__ uint64_t warp_or64(uint64_t v) {
  const uint32_t lo = __reduce_or_sync(kFull, (uint32_t)v);
  const uint32_t hi = __reduce_or_sync(kFull, (uint32_t)(v >> 32));
  return (uint64_t)hi << 32 | lo;
}

template <bool WIDE, bool SMEM_TABLES, bool STAMP>
// (minimum 1 block per SM: with 128 threads alone ptxas spilled the
// global-tables instances at 64-80 registers)
__global__ void __launch_bounds__(kWarps * 32, 1)
fused_megakernel(const FusedArgs a, unsigned long long* stamps) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + warp;
  const bool has_dfa = a.dfa_image != nullptr && a.off_attr_bytes >= 0;
  const uint32_t bar = smem_addr(smem + a.smem_head - 16);
  const uint8_t* tabs = SMEM_TABLES ? smem : a.dfa_image;

  // ---- prologue: one bulk copy of the DFA image into shared memory ------
  if (SMEM_TABLES && has_dfa) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                   "r"(1u)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              bar),
          "r"((uint32_t)a.image_bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
          "l"(a.dfa_image), "r"((uint32_t)a.image_bytes), "r"(bar)
          : "memory");
    }
  }

  if (b < a.B) {
    constexpr int IDW = WIDE ? 4 : 2;
    // the warp's region: circuit buffer, the config's node children, the
    // ballot words, the row's staged operands (fused_kernel.py::_warp_layout)
    uint8_t* cb = smem + a.smem_head + warp * a.warp_bytes;  // [max_local]
    uint16_t* sk = reinterpret_cast<uint16_t*>(cb + a.kids_at);
    uint32_t* masks = reinterpret_cast<uint32_t*>(cb + a.masks_at);
    uint8_t* rs = cb + a.stage_at;
    unsigned long long* st_row = stamps + b * kStamps;
    if (STAMP && lane == 0) st_row[0] = clock64();
    const int W = (int)a.W;
    uint8_t* out = a.out + b * W;
    const int32_t cfg = ld_i32(a.buf + a.off_config_id + 4 * b);

    // ---- the row's operands into shared memory, while cfg is in flight -
    // (cpu_dense stays in device memory: a row reads few of its columns).
    // Segment g holds the row's slice of one operand, from stage offset
    // s_g (4-byte aligned) to e_g; each lane loads kStageUnroll bytes of
    // every segment now and stores them once the records are in flight.
    const int64_t src[kSegs] = {
        a.off_attrs_val + b * a.A * IDW, a.off_members_c + b * a.M * a.K * IDW,
        a.off_member_ovf + b * a.M,      a.off_byte_ovf + b * a.NB,
        a.off_attr_bytes + b * a.NB * a.LB, a.off_attrs_num + b * a.NN * 4,
        a.off_num_valid + b * a.NN,      a.off_rel_rows + b * a.NR * 4};
    const int dst[kSegs] = {0,          (int)a.s_mc,  (int)a.s_movf,
                            (int)a.s_bovf, (int)a.s_ab, (int)a.s_num,
                            (int)a.s_nv, (int)a.s_rel};
    const int len[kSegs] = {
        (int)a.e_av,             (int)(a.e_mc - a.s_mc),
        (int)(a.e_movf - a.s_movf), (int)(a.e_bovf - a.s_bovf),
        (int)(a.e_ab - a.s_ab),  (int)(a.e_num - a.s_num),
        (int)(a.e_nv - a.s_nv),  (int)(a.stage_bytes - a.s_rel)};
    uint8_t v[kSegs][kStageUnroll];
#pragma unroll
    for (int g = 0; g < kSegs; ++g)
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        const int i = 32 * u + lane;
        v[g][u] = i < len[g] ? a.buf[src[g] + i] : 0;
      }
    if (cfg < 0 || cfg >= a.G) {
      for (int w = lane; w < W; w += 32) out[w] = 0;  // no config: 0 bits
    } else {
      // ---- prologue: the config's offsets, then every record at once ----
      const int4* co = reinterpret_cast<const int4*>(a.cfg_off) + 2 * cfg;
      const int4 o0 = __ldg(co), p0 = __ldg(co + 1);
      const int4 o1 = __ldg(co + 2), p1 = __ldg(co + 3);
      const int nl = o1.x - o0.x, nn = o1.y - o0.y, nd = o1.z - o0.z,
                nv = o1.w - o0.w, nk = p1.x - p0.x;
      const int E = (int)a.E;
      // the whole row buffer fits one 64-bit word: the circuit runs in
      // registers, one ballot per level
      const bool fast = nl <= 32 && nn <= 32 && nd <= 32 && 2 + nl + nn <= 64;
      const int4* lrec = reinterpret_cast<const int4*>(a.leaf_rec) + o0.x;
      const int4* drec = reinterpret_cast<const int4*>(a.dfa_rec) + o0.z;
      const int4* nrecs = reinterpret_cast<const int4*>(a.node_rec) + o0.y;
      const int4 zero4 = make_int4(0, 0, 0, 0);
      const int4 leaf0 = lane < nl ? __ldg(lrec + lane) : zero4;
      const int4 dfa0 = lane < nd ? __ldg(drec + lane) : zero4;
      const int4 nrec = lane < nn ? __ldg(nrecs + lane) : zero4;
      const int lend = lane < nv ? __ldg(a.lvl_end + o0.w + lane) : 0;
      const uint32_t ev0 =
          lane < E ? __ldg(a.ev + (int64_t)cfg * E + lane) : 0;
      // land the staged operands (they arrived with cfg)
#pragma unroll
      for (int g = 0; g < kSegs; ++g) {
#pragma unroll
        for (int u = 0; u < kStageUnroll; ++u) {
          const int i = 32 * u + lane;
          if (i < len[g]) rs[dst[g] + i] = v[g][u];
        }
        for (int i = 32 * kStageUnroll + lane; i < len[g]; i += 32)
          rs[dst[g] + i] = a.buf[src[g] + i];
      }
      if (!fast) {
        for (int t = lane; t < nk; t += 32)
          sk[t] = (uint16_t)__ldg(a.node_kids + p0.x + t);
        if (lane == 0) {
          cb[0] = 1;  // TRUE
          cb[1] = 0;  // FALSE
        }
      }
      // a stamp waits for nothing in flight: storing the records' bits
      // makes the prologue's stamp wait for them to land
      if (STAMP && lane == 0)
        masks[0] = nrec.x ^ lend ^ ev0 ^ leaf0.x ^ dfa0.x;
      __syncwarp();
      stamp<STAMP>(st_row, 1, lane);

      const RowLanes rl{rs, a.buf + a.off_cpu_dense + b * a.C, has_dfa,
                        a.has_num && a.off_attrs_num >= 0,
                        a.rel_bits != nullptr && a.off_rel_rows >= 0,
                        a.off_member_ovf >= 0};
      uint64_t bits = 1;  // fast path: bit i is local slot i (TRUE, FALSE..)
      if (fast) {
        // ---- leaves: lane i takes leaf i, one ballot gathers them -------
        const int res = lane < nl ? eval_leaf<WIDE>(a, leaf0, rl) : 0;
        bits |= (uint64_t)__ballot_sync(kFull, res == 1) << 2;
        stamp<STAMP>(st_row, 2, lane);
        // ---- DFA rows: lane j walks row j through the table image -------
        if (has_dfa && nd > 0) {
          if (SMEM_TABLES) mbar_wait(bar, 0);  // the copy has landed
          stamp<STAMP>(st_row, 3, lane);
          const int acc =
              lane < nd ? walk_dfa<SMEM_TABLES>(a, dfa0, tabs, rl) : 0;
          bits |= warp_or64(acc == 1 ? 1ull << dfa0.z : 0);
        } else {
          stamp<STAMP>(st_row, 3, lane);
        }
        stamp<STAMP>(st_row, 4, lane);
        // ---- the circuit: node j on lane j, one ballot per level --------
        const uint64_t kids = (uint64_t)(uint32_t)nrec.w << 32 |
                              (uint32_t)nrec.z;
        int prev = 0;
        for (int v = 0; v < nv; ++v) {
          const int end = __shfl_sync(kFull, lend, v);
          bool val = false;
          if (lane >= prev && lane < end)
            val = (nrec.y & 1) ? (bits & kids) == kids : (bits & kids) != 0;
          bits |= (uint64_t)__ballot_sync(kFull, val) << (2 + nl);
          prev = end;
        }
      } else {
        // ---- leaves: the lanes share the own config's leaf records ------
        for (int i = lane; i < nl; i += 32) {
          const int res =
              eval_leaf<WIDE>(a, i < 32 ? leaf0 : __ldg(lrec + i), rl);
          if (res >= 0) cb[2 + i] = (uint8_t)res;
        }
        stamp<STAMP>(st_row, 2, lane);
        // ---- DFA rows: one lane each, LB steps through the table image --
        if (has_dfa && nd > 0) {
          if (SMEM_TABLES) mbar_wait(bar, 0);  // the copy has landed
          stamp<STAMP>(st_row, 3, lane);
          for (int j = lane; j < nd; j += 32) {
            const int4 r = j < 32 ? dfa0 : __ldg(drec + j);
            const int acc = walk_dfa<SMEM_TABLES>(a, r, tabs, rl);
            if (acc >= 0) cb[r.z] = (uint8_t)acc;
          }
        } else {
          stamp<STAMP>(st_row, 3, lane);
        }
        __syncwarp();
        stamp<STAMP>(st_row, 4, lane);
        // ---- the circuit, one level at a time across the lanes ----------
        const int nbase = 2 + nl;
        int prev = 0;
        for (int v = 0; v < nv; ++v) {
          const int end = v < 32 ? __shfl_sync(kFull, lend, v)
                                 : __ldg(a.lvl_end + o0.w + v);
          for (int i = prev + lane; i < end; i += 32) {
            const int4 nr = __ldg(nrecs + i);
            const uint16_t* kid = sk + nr.x;
            const int n = nr.y >> 1;
            uint8_t all = 1, any = 0;
            int t = 0;
            for (; t + 4 <= n; t += 4) {  // 4 children's loads in flight
              const uint8_t c0 = cb[kid[t]], c1 = cb[kid[t + 1]],
                            c2 = cb[kid[t + 2]], c3 = cb[kid[t + 3]];
              all &= c0 & c1 & c2 & c3;
              any |= c0 | c1 | c2 | c3;
            }
            for (; t < n; ++t) {
              const uint8_t c0 = cb[kid[t]];
              all &= c0;
              any |= c0;
            }
            cb[nbase + i] = (nr.y & 1) ? all : any;
          }
          prev = end;
          __syncwarp();
        }
      }
      stamp<STAMP>(st_row, 5, lane);

      // ---- evaluators: ballots, then the row's W bytes ------------------
      auto slot_bit = [&](uint32_t i) -> bool {
        return fast ? (bits >> i) & 1 : cb[i] != 0;
      };
      if (E <= 31) {
        // one ballot each: [verdict, rule[E], skipped[E]] fit in 64 bits
        bool r = false, s = false;
        if (lane < E) {
          r = slot_bit(ev0 & 0xffff);
          s = !slot_bit(ev0 >> 16);
        }
        const uint64_t rb = __ballot_sync(kFull, r);
        const uint64_t sb = __ballot_sync(kFull, s);
        const uint64_t verdict =
            __ballot_sync(kFull, lane >= E || r || s) == kFull;
        const uint64_t cols = verdict | rb << 1 | sb << (1 + E);
        if (lane < W) out[lane] = (uint8_t)(cols >> (8 * lane));
      } else {
        bool verdict = true;
        for (int c0 = 0; c0 < E; c0 += 32) {
          const int e = c0 + lane;
          bool r = false, s = false;
          if (e < E) {
            const uint32_t w =
                c0 == 0 ? ev0 : __ldg(a.ev + (int64_t)cfg * E + e);
            r = slot_bit(w & 0xffff);
            s = !slot_bit(w >> 16);
          }
          const unsigned rb = __ballot_sync(kFull, r);
          const unsigned sb = __ballot_sync(kFull, s);
          verdict &= __ballot_sync(kFull, e >= E || r || s) == kFull;
          if (lane == 0) {
            masks[2 * (c0 >> 5)] = rb;
            masks[2 * (c0 >> 5) + 1] = sb;
          }
        }
        __syncwarp();
        for (int w = lane; w < W; w += 32) {
          uint8_t byte = 0;
          for (int j = 0; j < 8; ++j) {
            const int col = 8 * w + j;
            if (col > 2 * E) break;
            bool bit;
            if (col == 0) {
              bit = verdict;
            } else {
              const int e = col <= E ? col - 1 : col - 1 - E;
              bit = (masks[2 * (e >> 5) + (col > E)] >> (e & 31)) & 1;
            }
            byte |= (uint8_t)bit << j;
          }
          out[w] = byte;
        }
      }
      stamp<STAMP>(st_row, 6, lane);
    }
  }
  // the block must not exit while the bulk copy still writes its memory
  if (SMEM_TABLES && has_dfa && threadIdx.x == 0) mbar_wait(bar, 0);
}

__global__ void probe_add_one(const int32_t* x, int32_t* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1;
}

template <bool WIDE, bool SMEM_TABLES, bool STAMP>
cudaError_t launch(const FusedArgs& a, int64_t smem,
                   unsigned long long* stamps, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_megakernel<WIDE, SMEM_TABLES, STAMP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((a.B + kWarps - 1) / kWarps);
  fused_megakernel<WIDE, SMEM_TABLES, STAMP>
      <<<blocks, 32 * kWarps, (size_t)smem, stream>>>(a, stamps);
  return cudaGetLastError();
}

template <bool STAMP>
cudaError_t dispatch(const FusedArgs& a, int64_t smem,
                     unsigned long long* stamps, cudaStream_t s) {
  if (a.smem_tables)
    return a.wide ? launch<true, true, STAMP>(a, smem, stamps, s)
                  : launch<false, true, STAMP>(a, smem, stamps, s);
  return a.wide ? launch<true, false, STAMP>(a, smem, stamps, s)
                : launch<false, false, STAMP>(a, smem, stamps, s);
}

int unpack(const int64_t* words, int64_t n_words, FusedArgs* a) {
  if (n_words * 8 != (int64_t)sizeof(FusedArgs)) return -2;
  memcpy(a, words, sizeof(FusedArgs));
  if (a->magic != kMagic) return -3;
  return 0;
}

}  // namespace

extern "C" {

// Launch one batch.  ``words`` is the FusedArgs word list; returns a
// cudaError_t (0 on success), -2 for a word count that does not match the
// struct, -3 for a wrong layout tag.
int authz_fused_launch(const int64_t* words, int64_t n_words,
                       int64_t smem_bytes, void* stream) {
  FusedArgs a;
  const int err = unpack(words, n_words, &a);
  if (err != 0) return err;
  if (a.B <= 0) return 0;
  return dispatch<false>(a, smem_bytes, nullptr,
                         reinterpret_cast<cudaStream_t>(stream));
}

// The instrumented instance: as authz_fused_launch, and writes 8 clock64()
// words per row into ``stamps`` ([B, 8] uint64).
int authz_fused_stamp_launch(const int64_t* words, int64_t n_words,
                             int64_t smem_bytes, unsigned long long* stamps,
                             void* stream) {
  FusedArgs a;
  const int err = unpack(words, n_words, &a);
  if (err != 0) return err;
  if (a.B <= 0) return 0;
  return dispatch<true>(a, smem_bytes, stamps,
                        reinterpret_cast<cudaStream_t>(stream));
}

int authz_probe_launch(const int32_t* x, int32_t* y, int n, void* stream) {
  probe_add_one<<<(n + 127) / 128, 128, 0,
                  reinterpret_cast<cudaStream_t>(stream)>>>(x, y, n);
  return cudaGetLastError();
}

const char* authz_error_string(int err) {
  if (err == -2) return "argument block does not match the kernel's layout";
  if (err == -3) return "argument block carries a wrong layout tag";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
