// Fused policy-evaluation mega-kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package,
// authorino_tpu/ops/fused_kernel.py::_pallas_wrap (body _fused_packed ->
// _eval_verdicts_fused, plus the in-kernel operand decode
// pattern_eval._defuse), and its probe fused_kernel_supported.
//
// One launch turns one micro-batch's staging buffer into the [B, W] uint8
// little-endian bitmask [own verdict, own rule[E], own skipped[E]]:
//   decode -> leaf compare -> membership -> CPU-lane scatter -> DFA scan ->
//   numeric lane -> relation lane -> membership-overflow assist -> op
//   cascade -> And/Or circuit -> verdict table -> own-config select ->
//   bitpack.
//
// Bound on an H100: the kernel must read each operand byte once (~32 KB of
// batch operands and ~220 KB of corpus params at 1k configs x 10 rules,
// B = 256) and write B * W bytes: under 0.1 us of HBM traffic, which is
// the bound.  The integer work a row needs is only its own config's
// subcircuit (~100 operations), ~24k for the batch, well under a
// nanosecond at the card's INT32 rate.  This design evaluates every leaf
// and node of the corpus for every row instead, re-reading the corpus
// params from L2 with dependent loads, so it is latency-bound, far above
// the bound (PERF.md has the times).
//
// Design: one thread block of 1,024 threads per batch row.  The row's
// circuit buffer [TRUE, FALSE, leaves..., nodes...] lives in dynamic
// shared memory (uint8), so the circuit's gathers never touch device
// memory; the row's attr ids and membership ids are staged there too, as
// int32.  Phases:
//   0  constants, zeroed leaf slots, the row's ids decoded into shared
//      memory, CPU-lane scatter into the leaf slots
//   1  one thread per DFA row walks the row's bytes, writes the accept bit
//   2  threads stride over the leaves (unrolled by 4, so the leaves'
//      parameter loads from L2 overlap) and write each leaf's cascade
//      result over its CPU-lane slot (the leaf only reads its own slot)
//   3  the circuit, one level at a time, __syncthreads() between levels
//   4  the own config's evaluators only, bitpacked into W bytes
// Multi-byte operands are assembled from byte loads: the staging buffer is
// packed without alignment padding, so offsets can be odd.  Every index
// operand was range-checked on the host at upload (and each batch's
// row-dependent indices before launch), so the kernel reads without
// bounds checks.  Absent lanes arrive as null pointers / negative offsets.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 1024;
constexpr int64_t kMagic = 0x4155544846555345LL;  // layout version tag

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
  const int8_t* leaf_op;
  const int32_t* leaf_attr;
  const int32_t* leaf_const;
  const int32_t* member_slot_of_leaf;
  const int32_t* cpu_scatter_idx;
  int64_t L;
  const int32_t* children;
  const uint8_t* is_and;
  const int32_t* level_meta;    // [n_levels, 4]: rows, width, child off, base
  int64_t n_levels, buf_size;
  const int32_t* eval_cond;
  const int32_t* eval_rule;
  const uint8_t* eval_has_cond;
  int64_t G, E, W;
  const uint8_t* dfa_tables;    // [T, S, 256] (null: no DFA lane)
  const uint8_t* dfa_accept;    // [T, S]
  const int32_t* dfa_tab_g;     // [R]
  const int32_t* dfa_slot_g;    // [R]
  const int32_t* leaf_dfa_pos;  // [L]
  int64_t S, R;
  const int32_t* leaf_num_slot; // [L] (null: no numeric lane)
  const uint8_t* rel_bits;      // [Rp, RW] (null: no relation lane)
  const int32_t* leaf_rel_slot;
  const int32_t* leaf_rel_col;
  int64_t RW;
};
static_assert(sizeof(FusedArgs) == 52 * 8, "FusedArgs must be 52 words");

__device__ __forceinline__ int32_t ld_i16(const uint8_t* p) {
  return (int32_t)(int16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
}

__device__ __forceinline__ int32_t ld_i32(const uint8_t* p) {
  return (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                   ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24));
}

template <bool WIDE>
__device__ __forceinline__ int32_t ld_id(const uint8_t* base, int64_t i) {
  return WIDE ? ld_i32(base + 4 * i) : ld_i16(base + 2 * i);
}

template <bool WIDE>
__global__ void __launch_bounds__(kThreads)
fused_megakernel(const FusedArgs a) {
  extern __shared__ uint8_t smem[];
  uint8_t* cb = smem;                   // circuit buffer [buf_size]
  uint8_t* dres = smem + a.buf_size;    // DFA row accept bits [R]
  int32_t* s_av = reinterpret_cast<int32_t*>(
      smem + ((a.buf_size + a.R + 3) & ~(int64_t)3));  // attr ids [A]
  int32_t* s_mc = s_av + a.A;           // membership ids [M, K]
  const int64_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int L = (int)a.L;
  constexpr int IDW = WIDE ? 4 : 2;

  // ---- decode: this row's operands inside the staging buffer -----------
  const uint8_t* av = a.buf + a.off_attrs_val + b * a.A * IDW;
  const uint8_t* mc = a.buf + a.off_members_c + b * a.M * a.K * IDW;
  const uint8_t* cd = a.buf + a.off_cpu_dense + b * a.C;
  const int32_t cfg = ld_i32(a.buf + a.off_config_id + 4 * b);
  const bool has_dfa = a.dfa_tables != nullptr && a.off_attr_bytes >= 0;
  const bool has_num = a.leaf_num_slot != nullptr && a.off_attrs_num >= 0;
  const bool has_rel = a.rel_bits != nullptr && a.off_rel_rows >= 0;
  const bool has_movf = a.off_member_ovf >= 0;

  // ---- phase 0: constants + CPU-lane scatter onto the leaf slots --------
  for (int i = tid; i < L; i += nt) cb[2 + i] = 0;
  if (tid == 0) {
    cb[0] = 1;  // TRUE
    cb[1] = 0;  // FALSE
  }
  for (int i = tid; i < (int)a.A; i += nt) s_av[i] = ld_id<WIDE>(av, i);
  for (int i = tid; i < (int)(a.M * a.K); i += nt)
    s_mc[i] = ld_id<WIDE>(mc, i);
  __syncthreads();
  for (int c = tid; c < (int)a.C; c += nt) {
    const int l = __ldg(a.cpu_scatter_idx + c);
    if (l < L) cb[2 + l] = cd[c] != 0;  // l == L: padding column, dumped
  }

  // ---- phase 1: DFA byte scan, one thread per DFA row -------------------
  if (has_dfa) {
    const uint8_t* ab = a.buf + a.off_attr_bytes + b * a.NB * a.LB;
    for (int r = tid; r < (int)a.R; r += nt) {
      const int t = __ldg(a.dfa_tab_g + r);
      const uint8_t* tab = a.dfa_tables + (int64_t)t * a.S * 256;
      const uint8_t* bytes = ab + (int64_t)__ldg(a.dfa_slot_g + r) * a.LB;
      int st = 0;
      for (int i = 0; i < (int)a.LB; ++i)
        st = __ldg(tab + st * 256 + bytes[i]);
      dres[r] = __ldg(a.dfa_accept + (int64_t)t * a.S + st) != 0;
    }
  }
  __syncthreads();

  // ---- phase 2: leaves (compare, membership, lanes, op cascade) ---------
#pragma unroll 4
  for (int l = tid; l < L; l += nt) {
    const int op = __ldg(a.leaf_op + l);
    const int32_t k = __ldg(a.leaf_const + l);
    const uint8_t cpu = cb[2 + l];
    uint8_t res = 0;
    if (op == OP_EQ || op == OP_NEQ) {
      const bool eq = s_av[__ldg(a.leaf_attr + l)] == k;
      res = (op == OP_EQ) ? eq : !eq;
    } else if (op == OP_INCL || op == OP_EXCL) {
      const int ms = __ldg(a.member_slot_of_leaf + l);
      const bool movf =
          has_movf && a.buf[a.off_member_ovf + b * a.M + ms] != 0;
      if (movf) {
        res = cpu;  // EXCL too: the encoder stores the final answer
      } else {
        bool incl = false;
        const int32_t* m = s_mc + (int64_t)ms * a.K;
        for (int j = 0; j < (int)a.K; ++j) incl |= m[j] == k;
        res = (op == OP_INCL) ? incl : !incl;
      }
    } else if (op == OP_REGEX_DFA) {
      if (has_dfa) {
        const int pos = __ldg(a.leaf_dfa_pos + l);
        const int slot = __ldg(a.dfa_slot_g + pos);
        const bool bovf = a.buf[a.off_byte_ovf + b * a.NB + slot] != 0;
        res = bovf ? cpu : dres[pos];
      } else {
        res = cpu;  // regexes ride the CPU lane entirely
      }
    } else if (op == OP_CPU || op == OP_TREE_CPU) {
      res = cpu;
    } else if (op >= OP_NUM_GT) {
      if (op == OP_RELATION) {
        if (has_rel) {
          const int rs = __ldg(a.leaf_rel_slot + l);
          const int row = ld_i32(a.buf + a.off_rel_rows + 4 * (b * a.NR + rs));
          const int col = __ldg(a.leaf_rel_col + l);
          const uint8_t byte = __ldg(a.rel_bits + (int64_t)row * a.RW + (col >> 3));
          res = (byte >> (col & 7)) & 1;
        }
      } else if (has_num) {
        const int ns = __ldg(a.leaf_num_slot + l);
        const int32_t lv = ld_i32(a.buf + a.off_attrs_num + 4 * (b * a.NN + ns));
        const bool ok = a.buf[a.off_num_valid + b * a.NN + ns] != 0;
        const bool c = op == OP_NUM_GT   ? lv > k
                       : op == OP_NUM_GE ? lv >= k
                       : op == OP_NUM_LT ? lv < k
                                         : lv <= k;
        res = ok && c;
      }
    }
    // OP_ERROR (and any other code) stays false
    cb[2 + l] = res;
  }
  __syncthreads();

  // ---- phase 3: the And/Or circuit, level by level ----------------------
  for (int lv = 0; lv < (int)a.n_levels; ++lv) {
    const int rows = __ldg(a.level_meta + 4 * lv);
    const int width = __ldg(a.level_meta + 4 * lv + 1);
    const int coff = __ldg(a.level_meta + 4 * lv + 2);
    const int base = __ldg(a.level_meta + 4 * lv + 3);
    for (int i = tid; i < rows; i += nt) {
      const int32_t* ch = a.children + coff + (int64_t)i * width;
      const bool is_and = __ldg(a.is_and + (base - 2 - L) + i) != 0;
      uint8_t v = is_and ? 1 : 0;
      for (int j = 0; j < width; ++j) {
        const uint8_t c = cb[__ldg(ch + j)];
        if (is_and ? !c : c) {
          v = c;
          break;
        }
      }
      cb[base + i] = v;
    }
    __syncthreads();
  }

  // ---- phase 4: own config's verdict table + bitpack --------------------
  const int E = (int)a.E;
  const int n_cols = 1 + 2 * E;
  const bool own = cfg >= 0 && cfg < a.G;
  for (int w = tid; w < (int)a.W; w += nt) {
    uint8_t byte = 0;
    if (own) {
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * w + j;
        if (col >= n_cols) break;
        bool bit;
        if (col == 0) {
          bit = true;
          for (int e = 0; e < E; ++e) {
            const int64_t ge = (int64_t)cfg * E + e;
            const bool skip = __ldg(a.eval_has_cond + ge) &&
                              !cb[__ldg(a.eval_cond + ge)];
            bit &= skip || cb[__ldg(a.eval_rule + ge)];
          }
        } else if (col <= E) {
          bit = cb[__ldg(a.eval_rule + (int64_t)cfg * E + col - 1)];
        } else {
          const int64_t ge = (int64_t)cfg * E + col - 1 - E;
          bit = __ldg(a.eval_has_cond + ge) && !cb[__ldg(a.eval_cond + ge)];
        }
        byte |= (uint8_t)bit << j;
      }
    }
    a.out[b * a.W + w] = byte;  // out-of-range config_id: all-zero bits
  }
}

__global__ void probe_add_one(const int32_t* x, int32_t* y, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = x[i] + 1;
}

template <bool WIDE>
cudaError_t launch(const FusedArgs& a, int64_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_megakernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  fused_megakernel<WIDE><<<(unsigned)a.B, kThreads, (size_t)smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch one batch.  ``words`` is the FusedArgs word list; returns a
// cudaError_t (0 on success), -2 for a word count that does not match the
// struct, -3 for a wrong layout tag.
int authz_fused_launch(const int64_t* words, int64_t n_words,
                       int64_t smem_bytes, void* stream) {
  if (n_words * 8 != (int64_t)sizeof(FusedArgs)) return -2;
  FusedArgs a;
  memcpy(&a, words, sizeof(FusedArgs));
  if (a.magic != kMagic) return -3;
  if (a.B <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return a.wide ? launch<true>(a, smem_bytes, s)
                : launch<false>(a, smem_bytes, s);
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
