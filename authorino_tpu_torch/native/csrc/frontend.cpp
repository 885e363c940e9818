// Native device-owner gRPC ext_authz frontend.
//
// The reference serves Check() from a Go gRPC server in the same process as
// the evaluation hot loop (ref: main.go:437-488, pkg/service/auth.go:239-310).
// Here ONE process owns the CUDA card while the wire path runs at native
// speed: this file is an epoll HTTP/2 gRPC server (framing/HPACK via the
// system libnghttp2, loaded with dlopen so the encoder stays usable without
// it) that parses CheckRequest protobufs, encodes pattern-only ("fast
// lane") requests straight into the mega-kernel's operands, micro-batches
// them, and hands each batch to a Python dispatcher thread for ONE launch of
// the CUDA mega-kernel (ops/csrc/fused_kernel.cu).  Python is touched once
// per batch, never per request.
//
// Correctness contract:
//   - fast lane only for configs whose full pipeline semantics reduce to
//     the compiled kernel verdict (anonymous or API-key identity + compiled
//     pattern authorization + identity-constant responses) — eligibility
//     decided in Python (runtime/native_frontend.py), byte-exact response
//     templates built with the same codec (protos/wire.py) as the Python
//     gRPC server;
//   - everything else (OIDC identities, metadata fetches, templated
//     denyWith, wildcard host corpora, …) routes to the Python pipeline
//     over the slow queue — full semantics, lower throughput;
//   - the packed verdict column 0 is exactly the pipeline's decision for a
//     fast-lane config: ∧ over evaluators of (¬cond ∨ rule)
//     (ops/fused_kernel.py fused_packed_plain; ref
//     pkg/service/auth_pipeline.go:287-322);
//   - a batch's verdict bytes (complete_batch) are 1 = allow, 0 = deny with
//     the config's column-less denial, 2 + c = deny attributed to evaluator
//     column c (its denial carries that rule's provenance, as the Python
//     server's does), 255 = UNAVAILABLE (the card did not decide the batch).
//
// Compiled as part of the _atpuenc_torch single translation unit
// (pymod.cpp).

#include <arpa/inet.h>
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <sys/timerfd.h>
#include <unistd.h>

#include <algorithm>
#include <array>
#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// nghttp2 ABI subset (dlopen'd from libnghttp2.so.14; prototypes per the
// public stable C API)
// ---------------------------------------------------------------------------
namespace ng {

typedef struct nghttp2_session nghttp2_session;
typedef struct nghttp2_session_callbacks nghttp2_session_callbacks;
typedef struct nghttp2_option nghttp2_option;

typedef struct {
  size_t length;
  int32_t stream_id;
  uint8_t type;
  uint8_t flags;
  uint8_t reserved;
} nghttp2_frame_hd;

typedef struct {
  uint8_t* name;
  uint8_t* value;
  size_t namelen;
  size_t valuelen;
  uint8_t flags;
} nghttp2_nv;

typedef union {
  int fd;
  void* ptr;
} nghttp2_data_source;

typedef ssize_t (*nghttp2_data_read_callback)(nghttp2_session*, int32_t,
                                              uint8_t*, size_t, uint32_t*,
                                              nghttp2_data_source*, void*);

typedef struct {
  nghttp2_data_source source;
  nghttp2_data_read_callback read_callback;
} nghttp2_data_provider;

typedef struct {
  int32_t settings_id;
  uint32_t value;
} nghttp2_settings_entry;

enum {
  NGHTTP2_FLAG_END_STREAM = 0x01,
  NGHTTP2_DATA_FLAG_EOF = 0x01,
  NGHTTP2_DATA_FLAG_NO_END_STREAM = 0x02,
  NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS = 0x03,
  NGHTTP2_SETTINGS_INITIAL_WINDOW_SIZE = 0x04,
  NGHTTP2_DATA = 0,
  NGHTTP2_HEADERS = 1,
  NGHTTP2_ERR_TEMPORAL_CALLBACK_FAILURE = -521,
};

typedef ssize_t (*send_cb)(nghttp2_session*, const uint8_t*, size_t, int, void*);
typedef int (*frame_recv_cb)(nghttp2_session*, const void*, void*);
typedef int (*data_chunk_cb)(nghttp2_session*, uint8_t, int32_t, const uint8_t*, size_t, void*);
typedef int (*header_cb)(nghttp2_session*, const void*, const uint8_t*, size_t,
                         const uint8_t*, size_t, uint8_t, void*);
typedef int (*stream_close_cb)(nghttp2_session*, int32_t, uint32_t, void*);

struct Api {
  int (*callbacks_new)(nghttp2_session_callbacks**);
  void (*callbacks_del)(nghttp2_session_callbacks*);
  void (*set_on_frame_recv)(nghttp2_session_callbacks*, frame_recv_cb);
  void (*set_on_data_chunk)(nghttp2_session_callbacks*, data_chunk_cb);
  void (*set_on_header)(nghttp2_session_callbacks*, header_cb);
  void (*set_on_stream_close)(nghttp2_session_callbacks*, stream_close_cb);
  int (*session_server_new)(nghttp2_session**, const nghttp2_session_callbacks*, void*);
  void (*session_del)(nghttp2_session*);
  ssize_t (*mem_recv)(nghttp2_session*, const uint8_t*, size_t);
  ssize_t (*mem_send)(nghttp2_session*, const uint8_t**);
  int (*want_read)(nghttp2_session*);
  int (*want_write)(nghttp2_session*);
  int (*submit_response)(nghttp2_session*, int32_t, const nghttp2_nv*, size_t,
                         const nghttp2_data_provider*);
  int (*submit_trailer)(nghttp2_session*, int32_t, const nghttp2_nv*, size_t);
  int (*submit_settings)(nghttp2_session*, uint8_t, const nghttp2_settings_entry*, size_t);
  int (*submit_window_update)(nghttp2_session*, uint8_t, int32_t, int32_t);
  bool ok = false;
};

static Api api;

static bool load() {
  if (api.ok) return true;
  void* h = dlopen("libnghttp2.so.14", RTLD_NOW | RTLD_GLOBAL);
  if (!h) h = dlopen("libnghttp2.so", RTLD_NOW | RTLD_GLOBAL);
  if (!h) return false;
  auto sym = [&](const char* n) { return dlsym(h, n); };
  api.callbacks_new = (int (*)(nghttp2_session_callbacks**))sym("nghttp2_session_callbacks_new");
  api.callbacks_del = (void (*)(nghttp2_session_callbacks*))sym("nghttp2_session_callbacks_del");
  api.set_on_frame_recv = (void (*)(nghttp2_session_callbacks*, frame_recv_cb))sym(
      "nghttp2_session_callbacks_set_on_frame_recv_callback");
  api.set_on_data_chunk = (void (*)(nghttp2_session_callbacks*, data_chunk_cb))sym(
      "nghttp2_session_callbacks_set_on_data_chunk_recv_callback");
  api.set_on_header = (void (*)(nghttp2_session_callbacks*, header_cb))sym(
      "nghttp2_session_callbacks_set_on_header_callback");
  api.set_on_stream_close = (void (*)(nghttp2_session_callbacks*, stream_close_cb))sym(
      "nghttp2_session_callbacks_set_on_stream_close_callback");
  api.session_server_new = (int (*)(nghttp2_session**, const nghttp2_session_callbacks*, void*))sym(
      "nghttp2_session_server_new");
  api.session_del = (void (*)(nghttp2_session*))sym("nghttp2_session_del");
  api.mem_recv = (ssize_t(*)(nghttp2_session*, const uint8_t*, size_t))sym("nghttp2_session_mem_recv");
  api.mem_send = (ssize_t(*)(nghttp2_session*, const uint8_t**))sym("nghttp2_session_mem_send");
  api.want_read = (int (*)(nghttp2_session*))sym("nghttp2_session_want_read");
  api.want_write = (int (*)(nghttp2_session*))sym("nghttp2_session_want_write");
  api.submit_response = (int (*)(nghttp2_session*, int32_t, const nghttp2_nv*, size_t,
                                 const nghttp2_data_provider*))sym("nghttp2_submit_response");
  api.submit_trailer = (int (*)(nghttp2_session*, int32_t, const nghttp2_nv*, size_t))sym(
      "nghttp2_submit_trailer");
  api.submit_settings = (int (*)(nghttp2_session*, uint8_t, const nghttp2_settings_entry*,
                                 size_t))sym("nghttp2_submit_settings");
  api.submit_window_update = (int (*)(nghttp2_session*, uint8_t, int32_t, int32_t))sym(
      "nghttp2_submit_window_update");
  api.ok = api.callbacks_new && api.callbacks_del && api.set_on_frame_recv &&
           api.set_on_data_chunk && api.set_on_header && api.set_on_stream_close &&
           api.session_server_new && api.session_del && api.mem_recv && api.mem_send &&
           api.want_read && api.want_write && api.submit_response && api.submit_trailer &&
           api.submit_settings && api.submit_window_update;
  return api.ok;
}

// the file the dynamic loader opened for libnghttp2 ("" when absent)
static std::string path() {
  if (!load()) return std::string();
  Dl_info info;
  if (dladdr((void*)api.session_server_new, &info) == 0 ||
      info.dli_fname == nullptr)
    return std::string();
  return std::string(info.dli_fname);
}

}  // namespace ng

namespace fe {

// ---------------------------------------------------------------------------
// Minimal protobuf walker for envoy CheckRequest
// (field numbers: protos/src/envoy/service/auth/v3/*.proto)
// ---------------------------------------------------------------------------
struct PbView {
  const char* p = nullptr;
  size_t n = 0;
  bool set = false;
  std::string str() const { return std::string(p ? p : "", n); }
};

struct ReqView {
  bool has_attributes = false, has_request = false, has_http = false;
  PbView method, path, host, scheme, query, fragment, protocol;
  PbView source_cert;  // AttributeContext.source.certificate (Peer field 5)
  int64_t size = 0;
  std::vector<std::pair<PbView, PbView>> headers;   // last-wins on dup keys
  std::vector<std::pair<PbView, PbView>> ctx_ext;
};

static bool pb_varint(const char*& p, const char* end, uint64_t& v) {
  v = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = (uint8_t)*p++;
    v |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) return true;
    shift += 7;
  }
  return false;
}

// returns false on malformed input
static bool pb_skip(const char*& p, const char* end, int wt) {
  uint64_t v;
  switch (wt) {
    case 0: return pb_varint(p, end, v);
    case 1: if (end - p < 8) return false; p += 8; return true;
    case 2:
      if (!pb_varint(p, end, v) || (uint64_t)(end - p) < v) return false;
      p += v; return true;
    case 5: if (end - p < 4) return false; p += 4; return true;
    default: return false;
  }
}

static bool pb_len(const char*& p, const char* end, PbView& out) {
  uint64_t v;
  if (!pb_varint(p, end, v) || (uint64_t)(end - p) < v) return false;
  out.p = p;
  out.n = (size_t)v;
  out.set = true;
  p += v;
  return true;
}

static bool parse_map_entry(PbView msg, PbView& k, PbView& v) {
  const char* p = msg.p;
  const char* end = msg.p + msg.n;
  while (p < end) {
    uint64_t tag;
    if (!pb_varint(p, end, tag)) return false;
    int f = (int)(tag >> 3), wt = (int)(tag & 7);
    if (f == 1 && wt == 2) { if (!pb_len(p, end, k)) return false; }
    else if (f == 2 && wt == 2) { if (!pb_len(p, end, v)) return false; }
    else if (!pb_skip(p, end, wt)) return false;
  }
  return true;
}

static bool parse_http(PbView msg, ReqView& rv) {
  const char* p = msg.p;
  const char* end = msg.p + msg.n;
  while (p < end) {
    uint64_t tag;
    if (!pb_varint(p, end, tag)) return false;
    int f = (int)(tag >> 3), wt = (int)(tag & 7);
    PbView v;
    switch (f) {
      case 2: if (wt != 2 || !pb_len(p, end, v)) return false; rv.method = v; break;
      case 3: {  // headers map entry
        if (wt != 2 || !pb_len(p, end, v)) return false;
        PbView k, val;
        if (!parse_map_entry(v, k, val)) return false;
        rv.headers.emplace_back(k, val);
        break;
      }
      case 4: if (wt != 2 || !pb_len(p, end, v)) return false; rv.path = v; break;
      case 5: if (wt != 2 || !pb_len(p, end, v)) return false; rv.host = v; break;
      case 6: if (wt != 2 || !pb_len(p, end, v)) return false; rv.scheme = v; break;
      case 7: if (wt != 2 || !pb_len(p, end, v)) return false; rv.query = v; break;
      case 8: if (wt != 2 || !pb_len(p, end, v)) return false; rv.fragment = v; break;
      case 9: {
        uint64_t u;
        if (wt != 0 || !pb_varint(p, end, u)) return false;
        rv.size = (int64_t)u;
        break;
      }
      case 10: if (wt != 2 || !pb_len(p, end, v)) return false; rv.protocol = v; break;
      default: if (!pb_skip(p, end, wt)) return false;
    }
  }
  return true;
}

static bool parse_check_request(const char* data, size_t n, ReqView& rv) {
  const char* p = data;
  const char* end = data + n;
  PbView attrs;
  while (p < end) {
    uint64_t tag;
    if (!pb_varint(p, end, tag)) return false;
    int f = (int)(tag >> 3), wt = (int)(tag & 7);
    if (f == 1 && wt == 2) {
      if (!pb_len(p, end, attrs)) return false;
      rv.has_attributes = true;
    } else if (!pb_skip(p, end, wt)) return false;
  }
  if (!attrs.set) return true;
  p = attrs.p;
  end = attrs.p + attrs.n;
  while (p < end) {
    uint64_t tag;
    if (!pb_varint(p, end, tag)) return false;
    int f = (int)(tag >> 3), wt = (int)(tag & 7);
    if (f == 1 && wt == 2) {  // source peer (certificate at field 5)
      PbView peer;
      if (!pb_len(p, end, peer)) return false;
      const char* q = peer.p;
      const char* qe = peer.p + peer.n;
      while (q < qe) {
        uint64_t t2;
        if (!pb_varint(q, qe, t2)) return false;
        int f2 = (int)(t2 >> 3), w2 = (int)(t2 & 7);
        if (f2 == 5 && w2 == 2) {
          if (!pb_len(q, qe, rv.source_cert)) return false;
        } else if (!pb_skip(q, qe, w2)) return false;
      }
    } else if (f == 4 && wt == 2) {  // request
      PbView req;
      if (!pb_len(p, end, req)) return false;
      rv.has_request = true;
      const char* q = req.p;
      const char* qe = req.p + req.n;
      while (q < qe) {
        uint64_t t2;
        if (!pb_varint(q, qe, t2)) return false;
        int f2 = (int)(t2 >> 3), w2 = (int)(t2 & 7);
        if (f2 == 2 && w2 == 2) {  // http
          PbView http;
          if (!pb_len(q, qe, http)) return false;
          rv.has_http = true;
          if (!parse_http(http, rv)) return false;
        } else if (!pb_skip(q, qe, w2)) return false;
      }
    } else if (f == 10 && wt == 2) {  // context_extensions entry
      PbView v, k, val;
      if (!pb_len(p, end, v)) return false;
      if (!parse_map_entry(v, k, val)) return false;
      rv.ctx_ext.emplace_back(k, val);
    } else if (!pb_skip(p, end, wt)) return false;
  }
  return true;
}

// last-wins lookup (protobuf map semantics on duplicate keys)
static const PbView* map_get(const std::vector<std::pair<PbView, PbView>>& m,
                             const char* key, size_t klen) {
  const PbView* out = nullptr;
  for (const auto& kv : m)
    if (kv.first.n == klen && memcmp(kv.first.p, key, klen) == 0) out = &kv.second;
  return out;
}

// ---------------------------------------------------------------------------
// Snapshot: everything the fast lane needs, swapped atomically on reconcile
// ---------------------------------------------------------------------------
enum PlanKind {
  K_CONST = 0, K_METHOD, K_PATH, K_URL_PATH, K_QUERY, K_HOST, K_SCHEME,
  K_PROTOCOL, K_SIZE, K_FRAGMENT, K_HEADER, K_CTX_EXT,
};

struct FastPlan {
  int32_t attr;
  int kind;
  std::string key;              // K_HEADER / K_CTX_EXT
  // K_CONST precomputed encoding:
  int32_t const_vid = 0;
  bool const_missing = false;   // missing/null → no member write
  std::vector<int32_t> const_members;
  std::string const_bytes;      // byte-slot payload (raw value bytes)
  bool const_byte_ovf = false;
};

// deny responses of one config or identity variant: [0] is the column-less
// denial, [1 + c] the denial attributed to evaluator column c
typedef std::vector<std::string> DenySet;

// verdict byte → response (see the contract at the top of the file)
static const uint8_t V_ALLOW = 1, V_UNAVAILABLE = 255;

static inline const std::string& pick_deny(const DenySet& d, uint8_t v) {
  size_t i = v >= 2 ? (size_t)v - 1 : 0;
  return i < d.size() ? d[i] : d[0];
}

struct VarEnt {
  int32_t idx;                  // var_plans index
  int64_t exp_ns;               // CLOCK_REALTIME expiry; INT64_MAX = static
  int32_t ok_idx = -1;          // var_oks index (per-identity OK response
                                // bytes — response-template configs); -1 =
                                // the config's default OK
  int32_t deny_idx = -1;        // var_denies index (per-identity DENY bytes
                                // — denyWith templates over the identity)
};

// one identity source of a config (multi-identity configs carry several,
// in pipeline priority-then-declaration order — identity is an OR,
// ref pkg/service/auth_pipeline.go:203-258)
struct CredSource {
  int cred_kind = 0;            // 1 auth header, 2 custom header, 3 cookie,
                                // 4 query, 5 client certificate
  std::string cred_key;
  // static (API key): the full key set is known at refresh time — each
  // key's auth.identity.* operands resolved to constant plan variants
  std::unordered_map<std::string, VarEnt> variants;
  std::deque<std::vector<FastPlan>> var_plans;       // deque: stable refs
  std::deque<std::string> var_oks;                   // per-key OK bytes
  std::deque<DenySet> var_denies;                    // per-key DENY bytes
  // dyn (OIDC/JWT, mTLS): the variant map is a verified-credential cache
  // registered at runtime by the slow lane.  Entries hold their plans by
  // shared_ptr so overwrites and expiry sweeps reclaim memory immediately
  // while a mid-request reader keeps its copy alive without the lock.
  bool dyn = false;
  struct DynVar {
    std::shared_ptr<const std::vector<FastPlan>> plans;
    int64_t exp_ns;
    // per-credential OK / DENY response bytes (response / denyWith
    // templates over the identity); null = the config's defaults
    std::shared_ptr<const std::string> ok;
    std::shared_ptr<const DenySet> deny;
  };
  std::unordered_map<std::string, DynVar> dyn_variants;
};

struct FastConfig {
  int32_t row = 0;
  int32_t shard = 0;            // owning mp shard (sharded corpora; else 0)
  bool has_batch = true;        // false → identity-only: decide entirely here
  // hybrid lane: the kernel covers only part of the authorization phase
  // (procedural Rego / SAR / SpiceDB evaluators stay in Python).  A kernel
  // DENY answers immediately — ∧-semantics, any authz failure denies with
  // the same config bytes — while a kernel PASS hands the RAW request to
  // the slow lane for the full pipeline (which re-runs the covered
  // patterns too: correct by construction, and they are kernel-batched
  // there as well)
  bool hybrid = false;
  std::vector<FastPlan> plans;
  bool needs_split = false;     // any K_URL_PATH / K_QUERY plan
  std::string ok_msg;           // CheckResponse payloads (built in Python)
  DenySet deny;
  // identity sources (empty = anonymous).  A request authenticates via the
  // first source whose credential resolves a variant; an extractable dyn
  // credential that misses its cache routes to the slow lane (it may still
  // verify); with no authentication at all the response is the
  // all-sources-failed template for the observed extraction bitmask
  std::vector<CredSource> sources;
  // [2^n_static] UNAUTHENTICATED templates indexed by which STATIC
  // sources' credentials were present (present ⇒ invalid; absent ⇒
  // missing; dyn sources reaching this path are always missing)
  std::vector<std::string> unauth_msgs;
  std::string ns, name;         // per-authconfig metric labels
};

// per-fc cap on runtime-registered variants (attacker-supplied token floods
// must not grow the map unboundedly; beyond the cap new tokens keep being
// served — correctly — by the slow lane)
static const size_t DYN_VARIANT_CAP = 65536;

static inline int64_t now_realtime_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (int64_t)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

static inline int64_t now_mono_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (int64_t)ts.tv_sec * 1000000000LL + ts.tv_nsec;
}

// auth_server_authconfig_duration_seconds bucket bounds — EXACTLY
// prometheus_client's default Histogram buckets, so drained counts map 1:1
// onto the same series the Python pipeline observes
// (ref pkg/service/auth_pipeline.go:26-36 records per-request duration
// histograms; the fast lane records them here and Python folds them in)
static const int64_t DUR_BOUNDS_NS[] = {
    5000000LL,    10000000LL,   25000000LL,  50000000LL,  75000000LL,
    100000000LL,  250000000LL,  500000000LL, 750000000LL, 1000000000LL,
    2500000000LL, 5000000000LL, 7500000000LL, 10000000000LL};
static const int N_DUR_BUCKETS = 15;  // 14 bounds + +Inf
// per-fc slot layout in fc_durs: [15 buckets][sum_ns] = 16 u64
static const int DUR_STRIDE = N_DUR_BUCKETS + 1;

// on-box stage bounds (µs-scale: the stages a co-located chip pays —
// queue-wait enq→flush, execute flush→complete, respond complete→submit)
static const int64_t STAGE_BOUNDS_NS[] = {
    10000LL,     25000LL,     50000LL,     100000LL,   250000LL,
    500000LL,    1000000LL,   2500000LL,   5000000LL,  10000000LL,
    25000000LL,  50000000LL,  100000000LL, 250000000LL, 1000000000LL};
static const int N_STAGE_BUCKETS = 16;  // 15 bounds + +Inf

static inline int dur_bucket(int64_t ns) {
  for (int i = 0; i < N_DUR_BUCKETS - 1; ++i)
    if (ns <= DUR_BOUNDS_NS[i]) return i;
  return N_DUR_BUCKETS - 1;
}

static inline int stage_bucket(int64_t ns) {
  for (int i = 0; i < N_STAGE_BUCKETS - 1; ++i)
    if (ns <= STAGE_BOUNDS_NS[i]) return i;
  return N_STAGE_BUCKETS - 1;
}

struct DfaRef { int32_t row; int32_t col; };  // dfa table row, cpu_dense column

struct Entry {
  uint32_t conn_id;
  int32_t stream_id;
  int32_t fc;
  int64_t t_enq;  // CLOCK_MONOTONIC at encode time (stage/duration hists)
  // per-identity OK / DENY response overrides (response + denyWith
  // templates); the _hold fields keep dyn bytes alive until completion
  const std::string* ok_msg = nullptr;
  std::shared_ptr<const std::string> ok_hold;
  const DenySet* deny_msg = nullptr;
  std::shared_ptr<const DenySet> deny_hold;
  // hybrid configs only: the raw CheckRequest pb, kept so a kernel PASS
  // can hand the request to the slow lane at completion time (the stream
  // buffer is not safely reachable from a dispatch thread)
  std::string raw;
};

struct Slot {
  // sharded corpora carry a leading shard axis: [Bmax, S, ...]; the
  // single-corpus layout is the S=1 special case of the same strides
  char* attrs_val = nullptr;     // [Bmax, S, A] int16/int32
  char* members = nullptr;       // [Bmax, S, M, K] int16/int32
  uint8_t* cpu_dense = nullptr;  // [Bmax, S, C] bool
  int32_t* config_id = nullptr;  // [Bmax] row within the owning shard
  int32_t* shard_of = nullptr;   // [Bmax] owning shard (null for S=1)
  uint8_t* attr_bytes = nullptr; // [Bmax, S, NB, DVB]
  uint8_t* byte_ovf = nullptr;   // [Bmax, S, NB] bool
};

struct Snapshot {
  int64_t id = 0;
  const Interner* interner = nullptr;  // borrowed from Policy (Python-owned)
  int A = 0, M = 0, K = 0, C = 0, NB = 0, DVB = 0;
  int S = 1;  // mp shards (sharded corpora stack per-shard metadata)
  bool elem16 = false;
  std::vector<int32_t> attr_member_slot;  // [S*A] → M row or -1
  std::vector<int32_t> attr_byte_slot_v;  // [S*A] → NB row or -1
  std::vector<std::vector<DfaRef>> attr_dfas;  // [S*A]; rows globalized
  std::vector<uint8_t> dfa_trans;  // [S*R, St, 256]
  std::vector<uint8_t> dfa_accept; // [S*R, St]
  int dfa_S = 0;
  // head-based trace sampling: route every Nth fast-eligible request to
  // the slow lane for full span export (0 = tracing off → all fast).
  // The reference traces every request (ref pkg/service/auth.go:261); the
  // fast lane never touches Python per request, so sampling trades span
  // completeness for keeping the native throughput while observability is on
  int64_t trace_every = 0;
  // host / "*.suffix" wildcard → fc idx, -1 = slow lane
  std::unordered_map<std::string, int32_t> host_map;
  std::vector<FastConfig> fcs;
  // guards every fc's variants/var_plans once dynamic registration starts
  // (epoll thread looks up; the slow lane inserts via fe_add_variant).
  // FastPlan vectors are immutable after publication, so a looked-up
  // pointer stays valid after unlock (deque push_back never moves elements)
  std::mutex var_mu;
  // batch slots (numpy arrays owned by Python until retirement)
  std::vector<Slot> slots;
  std::vector<int> free_slots;
  std::vector<std::vector<Entry>> slot_entries;
  std::vector<int> slot_count;
  int pending_batches = 0;
  // global response templates (pb2-built in Python for byte parity with the
  // Python gRPC server)
  std::string invalid_msg, notfound_msg, health_msg, unavailable_msg;
  // per-fc direct-decision counters [ok, unauth_missing, unauth_invalid] —
  // decisions that never enter a batch; the Python dispatcher folds them
  // into the pipeline's Prometheus series (fe_drain_fc_counts)
  std::unique_ptr<std::atomic<uint64_t>[]> fc_counts;
  // per-fc request-duration histograms, DUR_STRIDE u64 each (15 prom
  // buckets + sum_ns) — drained into
  // auth_server_authconfig_duration_seconds (fe_drain_durations)
  std::unique_ptr<std::atomic<uint64_t>[]> fc_durs;
  // monotonic flush time of each slot's current batch
  std::vector<int64_t> slot_flush_ns;
};

// ---------------------------------------------------------------------------
// Connections / streams
// ---------------------------------------------------------------------------
enum StreamKind { SK_UNSET = 0, SK_CHECK, SK_HEALTH, SK_OTHER };

struct StreamSt {
  int kind = SK_UNSET;
  bool compressed = false;
  std::string body;
  // response state
  std::string resp;     // full gRPC message payload (5B prefix + pb)
  size_t resp_off = 0;
  bool responded = false;
};

struct Conn {
  int fd = -1;
  uint32_t id = 0;
  ng::nghttp2_session* sess = nullptr;
  std::unordered_map<int32_t, StreamSt> streams;
  std::string outbuf;
  bool want_eout = false;
  bool dead = false;
};

struct Done {
  uint32_t conn_id;
  int32_t stream_id;
  std::string msg;       // CheckResponse payload (no gRPC prefix)
  int grpc_status = 0;   // non-zero → trailers-only error response
  int64_t t_done = 0;    // completion time (respond-stage histogram)
};

struct SlowReq {
  uint64_t id;
  std::string bytes;     // raw CheckRequest pb
};

struct SlowPending {
  uint32_t conn_id;
  int32_t stream_id;
};

// events to Python
enum EvKind { EV_TIMEOUT = 0, EV_BATCH = 1, EV_SNAP_RETIRED = 3, EV_STOPPED = 4 };
struct Event { int kind; int64_t a, b, c; };

struct Server {
  // config
  int port = 0;
  int bound_port = 0;
  bool any_addr = false;  // bind 0.0.0.0 (servers) vs loopback (bench/tests)
  int bmax = 1024;
  int nslots = 8;
  long window_us = 2000;
  size_t slow_cap = 65536;
  std::string health_msg;  // pre-first-swap health reply

  // epoll machinery
  int epfd = -1, listen_fd = -1, evfd = -1, tfd = -1;
  std::thread thr;
  std::atomic<bool> running{false};
  // graceful drain (fe_drain): new Check() streams answer UNAVAILABLE, the
  // filling batch flushes at once, and the shutdown writes every answer
  // already queued before it closes a connection
  std::atomic<bool> draining{false};

  // shared state
  std::mutex mu;
  std::unordered_map<uint32_t, Conn*> conns;
  uint32_t next_conn_id = 1;
  std::shared_ptr<Snapshot> cur;                      // swapped under mu
  std::unordered_map<int64_t, std::shared_ptr<Snapshot>> snaps;
  // snapshot the epoll thread is mid-request on (under mu): retirement
  // must skip it so direct-decision counter bumps are never lost to an
  // already-drained, erased snapshot
  Snapshot* epoll_pin = nullptr;
  // current filling batch (epoll thread only, but slot recycle under mu)
  int fill_slot = -1;
  int fill_count = 0;
  std::shared_ptr<Snapshot> fill_snap;
  bool timer_armed = false;

  // queues
  std::mutex done_mu;   // done_q only — its own lock so completion storms
                        // from dispatch/slow threads don't contend with
                        // everything else S->mu guards
  std::deque<Done> done_q;                            // under done_mu; evfd wakes epoll
  std::mutex batch_mu;
  std::condition_variable batch_cv;
  std::deque<Event> batch_events;
  std::mutex slow_mu;
  std::condition_variable slow_cv;
  std::deque<SlowReq> slow_q;
  bool stopping = false;
  std::unordered_map<uint64_t, SlowPending> slow_pending;  // under mu
  uint64_t next_slow_id = 1;

  // stats
  std::atomic<uint64_t> n_fast{0}, n_slow{0}, n_notfound{0}, n_invalid{0},
      n_health{0}, n_allowed{0}, n_denied{0}, n_dfa_ovf{0}, n_slow_shed{0},
      n_hybrid{0},
      n_parse_err{0}, n_conns{0}, n_unauth{0}, n_direct_ok{0}, n_dyn_hit{0},
      n_dyn_miss{0}, n_dyn_add{0}, n_trace_sampled{0}, n_unavailable{0},
      n_drain_refused{0};
  std::atomic<uint64_t> trace_ctr{0};
  // on-box stage histograms (server-wide): queue-wait (encode→flush),
  // execute (flush→complete_batch), respond (complete→HTTP/2 submit)
  std::atomic<uint64_t> stage_wait[N_STAGE_BUCKETS] = {};
  std::atomic<uint64_t> stage_exec[N_STAGE_BUCKETS] = {};
  std::atomic<uint64_t> stage_respond[N_STAGE_BUCKETS] = {};
  // duration-histogram leftovers of retired snapshots (key ns+'\x1f'+name;
  // under mu)
  std::unordered_map<std::string, std::array<uint64_t, DUR_STRIDE>> dur_leftover;
  // fc counters of retired snapshots not yet drained (key ns+'\x1f'+name;
  // under mu)
  std::unordered_map<std::string, std::array<uint64_t, 3>> fc_leftover;
};

static Server* g_srv = nullptr;

// ---- response submission (epoll thread only) ------------------------------

static ssize_t resp_read_cb(ng::nghttp2_session*, int32_t stream_id, uint8_t* buf,
                            size_t length, uint32_t* data_flags,
                            ng::nghttp2_data_source* source, void*) {
  Conn* c = (Conn*)source->ptr;
  auto it = c->streams.find(stream_id);
  if (it == c->streams.end()) return ng::NGHTTP2_ERR_TEMPORAL_CALLBACK_FAILURE;
  StreamSt& st = it->second;
  size_t left = st.resp.size() - st.resp_off;
  size_t n = left < length ? left : length;
  memcpy(buf, st.resp.data() + st.resp_off, n);
  st.resp_off += n;
  if (st.resp_off == st.resp.size()) {
    *data_flags = ng::NGHTTP2_DATA_FLAG_EOF | ng::NGHTTP2_DATA_FLAG_NO_END_STREAM;
    static const char kStatus[] = "grpc-status";
    static const char kZero[] = "0";
    ng::nghttp2_nv trailer = {(uint8_t*)kStatus, (uint8_t*)kZero,
                              sizeof(kStatus) - 1, sizeof(kZero) - 1, 0};
    ng::api.submit_trailer(c->sess, stream_id, &trailer, 1);
  }
  return (ssize_t)n;
}

static void nv_set(ng::nghttp2_nv& nv, const char* n, size_t nl, const char* v, size_t vl) {
  nv.name = (uint8_t*)n; nv.namelen = nl;
  nv.value = (uint8_t*)v; nv.valuelen = vl;
  nv.flags = 0;
}

// msg: CheckResponse payload; builds 5-byte gRPC prefix + body, then
// HEADERS(:status 200) + DATA + trailers(grpc-status 0)
static void submit_grpc_response(Conn* c, int32_t stream_id, const std::string& msg) {
  auto it = c->streams.find(stream_id);
  if (it == c->streams.end()) return;
  StreamSt& st = it->second;
  if (st.responded) return;
  st.responded = true;
  st.resp.clear();
  st.resp.reserve(5 + msg.size());
  uint32_t len = (uint32_t)msg.size();
  char pfx[5] = {0, (char)(len >> 24), (char)(len >> 16), (char)(len >> 8), (char)len};
  st.resp.append(pfx, 5);
  st.resp.append(msg);
  st.resp_off = 0;
  ng::nghttp2_nv nv[2];
  nv_set(nv[0], ":status", 7, "200", 3);
  nv_set(nv[1], "content-type", 12, "application/grpc", 16);
  ng::nghttp2_data_provider dp;
  dp.source.ptr = c;
  dp.read_callback = resp_read_cb;
  ng::api.submit_response(c->sess, stream_id, nv, 2, &dp);
}

// trailers-only gRPC error (no message body)
static void submit_grpc_error(Conn* c, int32_t stream_id, int code) {
  auto it = c->streams.find(stream_id);
  if (it == c->streams.end()) return;
  if (it->second.responded) return;
  it->second.responded = true;
  char buf[8];
  int n = snprintf(buf, sizeof buf, "%d", code);
  ng::nghttp2_nv nv[3];
  nv_set(nv[0], ":status", 7, "200", 3);
  nv_set(nv[1], "content-type", 12, "application/grpc", 16);
  nv_set(nv[2], "grpc-status", 11, buf, (size_t)n);
  ng::api.submit_response(c->sess, stream_id, nv, 3, nullptr);
}

// ---- fast-lane encode -----------------------------------------------------

static inline void put_id(Snapshot* s, char* base, int64_t idx, int32_t v) {
  if (s->elem16) ((int16_t*)base)[idx] = (int16_t)v;
  else ((int32_t*)base)[idx] = v;
}

// run one DFA over arbitrary-length bytes (exact overflow handling for the
// device regex lane: the value doesn't fit the byte tensor, but the DFA
// itself is length-agnostic — same tables, host scan)
static bool dfa_scan(Snapshot* s, int32_t row, const char* p, size_t n) {
  const uint8_t* t = s->dfa_trans.data() + (size_t)row * s->dfa_S * 256;
  uint8_t state = 0;
  for (size_t i = 0; i < n; ++i) state = t[(size_t)state * 256 + (uint8_t)p[i]];
  return s->dfa_accept[(size_t)row * s->dfa_S + state] != 0;
}

static void render_i64(int64_t v, std::string& out) {
  char buf[24];
  int n = snprintf(buf, sizeof buf, "%lld", (long long)v);
  out.assign(buf, (size_t)n);
}

// mirror of evaluators/credentials.py AuthCredentials.extract
// (ref pkg/auth/credentials.go:62-75); false → credential not found
static bool extract_cred(const CredSource& fc, const ReqView& rv, std::string& cred) {
  const size_t kl = fc.cred_key.size();
  switch (fc.cred_kind) {
    case 1: {  // authorization header: "<key_selector> <cred>"
      const PbView* h = map_get(rv.headers, "authorization", 13);
      if (!h) return false;
      if (h->n < kl + 1 || memcmp(h->p, fc.cred_key.data(), kl) != 0 ||
          h->p[kl] != ' ')
        return false;
      cred.assign(h->p + kl + 1, h->n - kl - 1);
      return true;
    }
    case 2: {  // custom header (name pre-lowercased in Python)
      const PbView* h = map_get(rv.headers, fc.cred_key.data(), kl);
      if (!h) return false;
      cred.assign(h->p, h->n);
      return true;
    }
    case 3: {  // cookie: split on ';', strip, "<key>=<cred>"
      const PbView* h = map_get(rv.headers, "cookie", 6);
      if (!h) return false;
      const char* p = h->p;
      const char* end = p + h->n;
      while (p < end) {
        const char* semi = (const char*)memchr(p, ';', (size_t)(end - p));
        const char* pe = semi ? semi : end;
        const char* a = p;
        const char* b = pe;
        while (a < b && isspace((unsigned char)*a)) ++a;
        while (b > a && isspace((unsigned char)b[-1])) --b;
        if ((size_t)(b - a) >= kl + 1 && memcmp(a, fc.cred_key.data(), kl) == 0 &&
            a[kl] == '=') {
          cred.assign(a + kl + 1, (size_t)(b - a) - kl - 1);
          return true;
        }
        if (!semi) break;
        p = semi + 1;
      }
      return false;
    }
    case 5: {  // client certificate (mTLS): the raw forwarded PEM is the key
      if (!rv.source_cert.set || rv.source_cert.n == 0) return false;
      cred.assign(rv.source_cert.p, rv.source_cert.n);
      return true;
    }
    case 4: {  // query param in the raw path: [?&]<key>=([^&]*)
      if (!rv.path.set) return false;
      const char* p = rv.path.p;
      const size_t n = rv.path.n;
      for (size_t i = 0; i + kl + 2 <= n; ++i) {
        if ((p[i] == '?' || p[i] == '&') &&
            memcmp(p + i + 1, fc.cred_key.data(), kl) == 0 && p[i + 1 + kl] == '=') {
          const char* vs = p + i + 2 + kl;
          const char* ve = (const char*)memchr(vs, '&', (size_t)(p + n - vs));
          cred.assign(vs, ve ? (size_t)(ve - vs) : (size_t)(p + n - vs));
          return true;
        }
      }
      return false;
    }
  }
  return false;
}

// encode one request into row b of the filling slot; returns false when the
// request needs the slow lane after all (odd path shapes).  `extra` carries
// the per-credential K_CONST plan variant (API-key identity), if any.
static bool encode_fast(Server* S, Snapshot* snap, Slot& sl, int b,
                        const FastConfig& fc, const std::vector<FastPlan>* extra,
                        const ReqView& rv) {
  // pre-split path once if any plan needs url_path/query (urlsplit parity
  // only holds for origin-form paths; anything else → slow lane)
  PbView url_path, qpart;
  if (fc.needs_split) {
    if (!rv.path.set || rv.path.n == 0 || rv.path.p[0] != '/') return false;
    const char* p = rv.path.p;
    const char* end = p + rv.path.n;
    const char* q = (const char*)memchr(p, '?', rv.path.n);
    const char* h = (const char*)memchr(p, '#', rv.path.n);
    const char* path_end = end;
    if (h && (!q || h < q)) { path_end = h; q = nullptr; }
    else if (q) path_end = q;
    if (q) {
      const char* qe = h ? h : end;
      qpart.p = q + 1; qpart.n = (size_t)(qe - q - 1); qpart.set = true;
    }
    url_path.p = p; url_path.n = (size_t)(path_end - p); url_path.set = true;
  }

  const int A = snap->A, K = snap->K, NB = snap->NB, DVB = snap->DVB;
  // the request's row along the flattened [B, S] axis: all writes land in
  // its owning shard's slice (other shards keep the zeroed EMPTY encoding)
  const int64_t bs = (int64_t)b * snap->S + fc.shard;
  const int64_t meta0 = (int64_t)fc.shard * A;  // per-shard metadata base
  std::string tmp;
  const std::vector<FastPlan>* lists[2] = {&fc.plans, extra};
  for (int li = 0; li < 2; ++li) {
  if (lists[li] == nullptr) continue;
  for (const FastPlan& pl : *lists[li]) {
    const int32_t attr = pl.attr;
    int32_t vid;
    const char* vp = nullptr;
    size_t vn = 0;
    bool missing = false;
    if (pl.kind == K_CONST) {
      vid = pl.const_vid;
      missing = pl.const_missing;
      vp = pl.const_bytes.data(); vn = pl.const_bytes.size();
    } else {
      switch (pl.kind) {
        case K_METHOD:   vp = rv.method.p;   vn = rv.method.n; break;
        case K_PATH:     vp = rv.path.p;     vn = rv.path.n; break;
        case K_HOST:     vp = rv.host.p;     vn = rv.host.n; break;
        case K_SCHEME:   vp = rv.scheme.p;   vn = rv.scheme.n; break;
        case K_PROTOCOL: vp = rv.protocol.p; vn = rv.protocol.n; break;
        case K_FRAGMENT: vp = rv.fragment.p; vn = rv.fragment.n; break;
        case K_URL_PATH: vp = url_path.p;    vn = url_path.n; break;
        case K_QUERY:
          // wellknown: split.query or http.query
          if (qpart.set && qpart.n) { vp = qpart.p; vn = qpart.n; }
          else { vp = rv.query.p; vn = rv.query.n; }
          break;
        case K_SIZE:
          render_i64(rv.size, tmp);
          vp = tmp.data(); vn = tmp.size();
          break;
        case K_HEADER: {
          const PbView* h = map_get(rv.headers, pl.key.data(), pl.key.size());
          if (h) { vp = h->p; vn = h->n; } else missing = true;
          break;
        }
        case K_CTX_EXT: {
          const PbView* h = map_get(rv.ctx_ext, pl.key.data(), pl.key.size());
          if (h) { vp = h->p; vn = h->n; } else missing = true;
          break;
        }
        default: return false;
      }
      if (vp == nullptr) vn = 0;
      vid = missing ? snap->interner->lookup("", 0) : snap->interner->lookup(vp, vn);
    }
    put_id(snap, sl.attrs_val, bs * A + attr, vid);
    int32_t mslot = snap->attr_member_slot[meta0 + attr];
    if (mslot >= 0) {
      if (pl.kind == K_CONST) {
        for (size_t k = 0; k < pl.const_members.size() && (int)k < K; ++k)
          put_id(snap, sl.members, (bs * snap->M + mslot) * K + k,
                 pl.const_members[k]);
      } else if (!missing) {
        put_id(snap, sl.members, (bs * snap->M + mslot) * K, vid);
      }
    }
    int32_t bslot = snap->attr_byte_slot_v[meta0 + attr];
    if (bslot >= 0) {
      if (pl.kind != K_CONST && vn && memchr(vp, 0, vn) != nullptr)
        return false;  // NUL: byte 0 is the DFA pad identity — Python regex
                       // lane is the only exact evaluator (slow lane)
      bool ovf = pl.kind == K_CONST ? pl.const_byte_ovf : (int)vn > DVB;
      if (ovf) {
        sl.byte_ovf[bs * NB + bslot] = 1;
        S->n_dfa_ovf.fetch_add(1, std::memory_order_relaxed);
        // exact host evaluation of every DFA leaf reading this attr (the
        // DFA is length-agnostic; only the device tensor is fixed-width)
        const char* sp = missing ? "" : vp;
        size_t sn = missing ? 0 : vn;
        for (const DfaRef& d : snap->attr_dfas[meta0 + attr])
          sl.cpu_dense[bs * snap->C + d.col] = dfa_scan(snap, d.row, sp, sn) ? 1 : 0;
      } else if (vn) {
        memcpy(sl.attr_bytes + (bs * NB + bslot) * DVB, vp, vn);
      }
    }
  }
  }
  sl.config_id[b] = fc.row;
  if (sl.shard_of) sl.shard_of[b] = fc.shard;
  return true;
}

// zero row b of the filling slot (arrays may hold a previous batch's rows);
// zeroes ALL S shard slices — non-owning shards must present the EMPTY
// encoding so their verdict contributions stay masked out
static void zero_row(Snapshot* snap, Slot& sl, int b) {
  const int A = snap->A * snap->S, M = snap->M, K = snap->K,
            C = snap->C * snap->S, NB = snap->NB * snap->S,
            DVB = snap->DVB;
  const int MK = M * K * snap->S;
  const int es = snap->elem16 ? 2 : 4;
  // attrs_val ← EMPTY_ID (0), members ← PAD (-3)
  memset(sl.attrs_val + (int64_t)b * A * es, 0, (size_t)A * es);
  if (snap->elem16) {
    int16_t* m = (int16_t*)sl.members + (int64_t)b * MK;
    for (int i = 0; i < MK; ++i) m[i] = -3;
  } else {
    int32_t* m = (int32_t*)sl.members + (int64_t)b * MK;
    for (int i = 0; i < MK; ++i) m[i] = -3;
  }
  memset(sl.cpu_dense + (int64_t)b * C, 0, (size_t)C);
  if (sl.attr_bytes) memset(sl.attr_bytes + (int64_t)b * NB * DVB, 0, (size_t)NB * DVB);
  if (sl.byte_ovf) memset(sl.byte_ovf + (int64_t)b * NB, 0, (size_t)NB);
  if (sl.shard_of) sl.shard_of[b] = 0;
}

// ---- batching (epoll thread) ----------------------------------------------

static void arm_timer(Server* S) {
  struct itimerspec its;
  memset(&its, 0, sizeof its);
  its.it_value.tv_sec = S->window_us / 1000000;
  its.it_value.tv_nsec = (S->window_us % 1000000) * 1000;
  timerfd_settime(S->tfd, 0, &its, nullptr);
  S->timer_armed = true;
}

static void disarm_timer(Server* S) {
  struct itimerspec its;
  memset(&its, 0, sizeof its);
  timerfd_settime(S->tfd, 0, &its, nullptr);
  S->timer_armed = false;
}

static void maybe_retire_locked(Server* S, std::vector<int64_t>& retired);
static void emit_retired(Server* S, const std::vector<int64_t>& retired);

static void flush_batch(Server* S, bool from_timer = false) {
  if (S->fill_slot < 0) {
    disarm_timer(S);
    return;
  }
  std::shared_ptr<Snapshot> snap = S->fill_snap;
  int slot = S->fill_slot, count = S->fill_count;
  std::vector<int64_t> retired;
  bool flushed = false;
  {
    // fill_slot/fill_snap transitions stay under mu: Python threads read
    // fill_snap in maybe_retire_locked (an unsynchronized shared_ptr
    // write would be a data race)
    std::lock_guard<std::mutex> lk(S->mu);
    if (count == 0) {
      // empty held slot (a swap raced a failed encode): return it so the
      // old snapshot can retire
      snap->free_slots.push_back(slot);
      S->fill_slot = -1;
      S->fill_snap.reset();
      maybe_retire_locked(S, retired);
    } else if (from_timer && count < S->bmax && snap->pending_batches >= 6 &&
               snap == S->cur) {
      // saturated: enough batches already hide the device RTT, and a
      // partial flush would burn a whole slot on a part-filled batch —
      // slot capacity in *requests* collapses and fast traffic spills to
      // the slow lane.  Let the batch keep filling; re-check next window.
    } else {
      snap->slot_count[slot] = count;
      snap->slot_flush_ns[slot] = now_mono_ns();
      snap->pending_batches++;
      S->fill_slot = -1;
      S->fill_count = 0;
      S->fill_snap.reset();
      flushed = true;
    }
  }
  emit_retired(S, retired);
  if (flushed || count == 0) {
    disarm_timer(S);
  } else {
    arm_timer(S);  // deferred partial batch: re-check next window
  }
  if (flushed) {
    {
      std::lock_guard<std::mutex> lk(S->batch_mu);
      S->batch_events.push_back({EV_BATCH, snap->id, slot, count});
    }
    S->batch_cv.notify_all();
  }
}

// acquire the filling slot for the current snapshot; nullptr when exhausted
// (back-pressure: request stays queued at the socket)
static Slot* ensure_fill(Server* S, std::shared_ptr<Snapshot>& snap_out) {
  std::lock_guard<std::mutex> lk(S->mu);
  std::shared_ptr<Snapshot> cur = S->cur;
  if (!cur || cur->slots.empty()) return nullptr;
  if (S->fill_slot >= 0 && S->fill_snap != cur) {
    // snapshot changed mid-fill: flush the old batch first (outside mu —
    // just mark and let caller retry)
    return nullptr;
  }
  if (S->fill_slot < 0) {
    if (cur->free_slots.empty()) return nullptr;
    S->fill_slot = cur->free_slots.back();
    cur->free_slots.pop_back();
    S->fill_snap = cur;
    S->fill_count = 0;
    cur->slot_entries[S->fill_slot].clear();
  }
  snap_out = S->fill_snap;
  return &snap_out->slots[S->fill_slot];
}

// ---- request processing (epoll thread) ------------------------------------

// Host resolution with wildcard walk-up (ref pkg/index/index.go:153-174;
// mirrors index/index.py::_get_node): exact hit first, then "*."-prefixed
// suffixes deepest-first — "*.example.com" matches a.example.com,
// b.a.example.com AND example.com itself — then a bare "*".
static bool resolve_host(Snapshot* snap, const std::string& host, int32_t& out) {
  auto it = snap->host_map.find(host);
  if (it != snap->host_map.end()) { out = it->second; return true; }
  size_t pos = 0;
  std::string cand;
  for (;;) {
    cand.assign("*.");
    cand.append(host, pos, std::string::npos);
    auto w = snap->host_map.find(cand);
    if (w != snap->host_map.end()) { out = w->second; return true; }
    size_t dot = host.find('.', pos);
    if (dot == std::string::npos) break;
    pos = dot + 1;
  }
  auto b = snap->host_map.find("*");
  if (b != snap->host_map.end()) { out = b->second; return true; }
  return false;
}

static void push_slow(Server* S, Conn* c, int32_t stream_id, const char* msg, size_t n) {
  uint64_t id;
  bool shed = false;
  {
    std::lock_guard<std::mutex> lk(S->mu);
    if (S->slow_pending.size() >= S->slow_cap) {
      shed = true;
    } else {
      id = S->next_slow_id++;
      S->slow_pending[id] = {c->id, stream_id};
    }
  }
  if (shed) {
    S->n_slow_shed.fetch_add(1, std::memory_order_relaxed);
    submit_grpc_error(c, stream_id, 8);  // RESOURCE_EXHAUSTED
    return;
  }
  {
    std::lock_guard<std::mutex> lk(S->slow_mu);
    S->slow_q.push_back({id, std::string(msg, n)});
  }
  S->slow_cv.notify_all();
  S->n_slow.fetch_add(1, std::memory_order_relaxed);
}

// record one direct (never-batched) decision's duration for fc_idx
static inline void record_direct_dur(Snapshot* snap, int32_t fc_idx, int64_t t0) {
  if (!snap->fc_durs) return;
  int64_t dur = now_mono_ns() - t0;
  auto* d = &snap->fc_durs[(size_t)fc_idx * DUR_STRIDE];
  d[dur_bucket(dur)].fetch_add(1, std::memory_order_relaxed);
  d[N_DUR_BUCKETS].fetch_add((uint64_t)dur, std::memory_order_relaxed);
}

static void process_check(Server* S, Conn* c, int32_t stream_id, StreamSt& st) {
  const int64_t t_start = now_mono_ns();
  if (S->draining.load(std::memory_order_relaxed)) {
    S->n_drain_refused.fetch_add(1, std::memory_order_relaxed);
    submit_grpc_error(c, stream_id, 14);  // UNAVAILABLE: the server drains
    return;
  }
  if (st.body.size() < 5) { submit_grpc_error(c, stream_id, 13); return; }
  if (st.body[0] != 0) { submit_grpc_error(c, stream_id, 12); return; }  // compressed
  uint32_t mlen = ((uint8_t)st.body[1] << 24) | ((uint8_t)st.body[2] << 16) |
                  ((uint8_t)st.body[3] << 8) | (uint8_t)st.body[4];
  if (st.body.size() < 5 + (size_t)mlen) { submit_grpc_error(c, stream_id, 13); return; }
  const char* msg = st.body.data() + 5;

  std::shared_ptr<Snapshot> snap;
  {
    std::lock_guard<std::mutex> lk(S->mu);
    snap = S->cur;
    S->epoll_pin = snap.get();
  }
  // unpin at every exit; a swap may have been waiting on the pin, so run
  // the retire check the moment it clears
  struct PinGuard {
    Server* S;
    ~PinGuard() {
      std::vector<int64_t> retired;
      {
        std::lock_guard<std::mutex> lk(S->mu);
        S->epoll_pin = nullptr;
        maybe_retire_locked(S, retired);
      }
      emit_retired(S, retired);
    }
  } pin_guard{S};
  if (!snap) { push_slow(S, c, stream_id, msg, mlen); return; }

  ReqView rv;
  if (!parse_check_request(msg, mlen, rv)) {
    S->n_parse_err.fetch_add(1, std::memory_order_relaxed);
    submit_grpc_error(c, stream_id, 13);
    return;
  }
  if (!rv.has_attributes || !rv.has_request || !rv.has_http) {
    S->n_invalid.fetch_add(1, std::memory_order_relaxed);
    submit_grpc_response(c, stream_id, snap->invalid_msg);
    return;
  }
  // host: context_extensions["host"] override, then :authority, then
  // port-strip retry (ref pkg/service/auth.go:270-289)
  const PbView* ov = map_get(rv.ctx_ext, "host", 4);
  std::string host = ov ? ov->str() : rv.host.str();
  int32_t fc_idx;
  bool found = resolve_host(snap.get(), host, fc_idx);
  if (!found) {
    size_t colon = host.rfind(':');
    if (colon != std::string::npos)
      found = resolve_host(snap.get(), host.substr(0, colon), fc_idx);
  }
  if (!found) {
    S->n_notfound.fetch_add(1, std::memory_order_relaxed);
    submit_grpc_response(c, stream_id, snap->notfound_msg);
    return;
  }
  if (fc_idx < 0) { push_slow(S, c, stream_id, msg, mlen); return; }
  if (snap->trace_every > 0 &&
      (int64_t)(S->trace_ctr.fetch_add(1, std::memory_order_relaxed) %
                (uint64_t)snap->trace_every) == 0) {
    // sampled: full pipeline + span export in Python
    S->n_trace_sampled.fetch_add(1, std::memory_order_relaxed);
    push_slow(S, c, stream_id, msg, mlen);
    return;
  }

  FastConfig& fc = snap->fcs[fc_idx];
  const std::vector<FastPlan>* extra = nullptr;
  // keeps a dyn variant's plan vector alive across encode_fast after the
  // variant lock is released (overwrites/sweeps may drop the map entry)
  std::shared_ptr<const std::vector<FastPlan>> dyn_hold;
  // the winning identity's OK/DENY response overrides (template configs)
  const std::string* ok_override = nullptr;
  std::shared_ptr<const std::string> ok_hold;
  const DenySet* deny_override = nullptr;
  std::shared_ptr<const DenySet> deny_hold;
  if (!fc.sources.empty()) {
    // identity is an OR over the sources, tried in the pipeline's
    // priority-then-declaration order: the first source whose credential
    // resolves a variant authenticates (its auth.* constants ride along).
    // An extractable dyn credential that misses its cache routes to the
    // slow lane — it may still verify there; a missed STATIC credential
    // (unknown API key) just falls through to the next source.  With no
    // authentication at all, the all-fail template for the observed
    // static-extraction bitmask answers (every per-source failure message
    // is a static string in that case, so the aggregate is too —
    // ref pkg/service/auth_pipeline.go:203-258 + :468-472).
    bool authenticated = false;
    uint32_t extracted_static = 0;
    int static_idx = 0;
    std::string cred;
    for (const CredSource& src : fc.sources) {
      const int bit = src.dyn ? -1 : static_idx++;
      cred.clear();
      if (!extract_cred(src, rv, cred)) continue;
      if (src.dyn) {
        {
          std::lock_guard<std::mutex> vlk(snap->var_mu);
          auto vit = src.dyn_variants.find(cred);
          if (vit != src.dyn_variants.end() &&
              vit->second.exp_ns > now_realtime_ns()) {
            dyn_hold = vit->second.plans;
            extra = dyn_hold.get();
            if (vit->second.ok) {
              ok_hold = vit->second.ok;
              ok_override = ok_hold.get();
            }
            if (vit->second.deny) {
              deny_hold = vit->second.deny;
              deny_override = deny_hold.get();
            }
          }
        }
        if (extra == nullptr) {
          // unknown/expired credential: the slow lane verifies (and
          // registers on success) — full pipeline semantics
          S->n_dyn_miss.fetch_add(1, std::memory_order_relaxed);
          push_slow(S, c, stream_id, msg, mlen);
          return;
        }
        S->n_dyn_hit.fetch_add(1, std::memory_order_relaxed);
        authenticated = true;
        break;
      }
      extracted_static |= 1u << bit;
      auto vit = src.variants.find(cred);
      if (vit != src.variants.end()) {
        extra = &src.var_plans[vit->second.idx];
        if (vit->second.ok_idx >= 0)
          ok_override = &src.var_oks[vit->second.ok_idx];
        if (vit->second.deny_idx >= 0)
          deny_override = &src.var_denies[vit->second.deny_idx];
        authenticated = true;
        break;
      }
    }
    if (!authenticated) {
      const bool any_present = extracted_static != 0;
      snap->fc_counts[3 * (size_t)fc_idx + (any_present ? 2 : 1)].fetch_add(
          1, std::memory_order_relaxed);
      S->n_fast.fetch_add(1, std::memory_order_relaxed);
      S->n_unauth.fetch_add(1, std::memory_order_relaxed);
      S->n_denied.fetch_add(1, std::memory_order_relaxed);
      record_direct_dur(snap.get(), fc_idx, t_start);
      submit_grpc_response(c, stream_id, fc.unauth_msgs[extracted_static]);
      return;
    }
  }
  if (!fc.has_batch) {
    // identity-only config: authenticated → OK, no kernel involvement
    snap->fc_counts[3 * (size_t)fc_idx].fetch_add(1, std::memory_order_relaxed);
    S->n_fast.fetch_add(1, std::memory_order_relaxed);
    S->n_direct_ok.fetch_add(1, std::memory_order_relaxed);
    S->n_allowed.fetch_add(1, std::memory_order_relaxed);
    record_direct_dur(snap.get(), fc_idx, t_start);
    submit_grpc_response(c, stream_id,
                         ok_override ? *ok_override : fc.ok_msg);
    return;
  }
  std::shared_ptr<Snapshot> fsnap;
  Slot* sl = ensure_fill(S, fsnap);
  if (sl == nullptr) {
    // no slot (exhausted or snapshot raced): flush and retry once
    flush_batch(S);
    sl = ensure_fill(S, fsnap);
    if (sl == nullptr) { push_slow(S, c, stream_id, msg, mlen); return; }
  }
  if (fsnap != snap) {
    // snapshot swapped between lookup and slot acquire: redo via slow lane
    push_slow(S, c, stream_id, msg, mlen);
    return;
  }
  int b = S->fill_count;
  zero_row(snap.get(), *sl, b);
  if (!encode_fast(S, snap.get(), *sl, b, fc, extra, rv)) {
    push_slow(S, c, stream_id, msg, mlen);
    return;
  }
  snap->slot_entries[S->fill_slot].push_back(
      {c->id, stream_id, fc_idx, t_start, ok_override, std::move(ok_hold),
       deny_override, std::move(deny_hold),
       fc.hybrid ? std::string(msg, mlen) : std::string()});
  S->fill_count++;
  S->n_fast.fetch_add(1, std::memory_order_relaxed);
  if (S->fill_count >= S->bmax) flush_batch(S);
  else if (S->fill_count == 1) arm_timer(S);
}

static void process_request(Server* S, Conn* c, int32_t stream_id) {
  auto it = c->streams.find(stream_id);
  if (it == c->streams.end()) return;
  StreamSt& st = it->second;
  switch (st.kind) {
    case SK_HEALTH: {
      std::shared_ptr<Snapshot> snap;
      {
        std::lock_guard<std::mutex> lk(S->mu);
        snap = S->cur;
      }
      S->n_health.fetch_add(1, std::memory_order_relaxed);
      submit_grpc_response(c, stream_id, snap ? snap->health_msg : S->health_msg);
      break;
    }
    case SK_CHECK:
      if (st.compressed) { submit_grpc_error(c, stream_id, 12); break; }
      process_check(S, c, stream_id, st);
      break;
    default:
      submit_grpc_error(c, stream_id, 12);  // UNIMPLEMENTED
  }
}

// ---- nghttp2 callbacks ----------------------------------------------------

static int on_header(ng::nghttp2_session*, const void* frame, const uint8_t* name,
                     size_t namelen, const uint8_t* value, size_t valuelen, uint8_t,
                     void* user_data) {
  Conn* c = (Conn*)user_data;
  const ng::nghttp2_frame_hd* hd = (const ng::nghttp2_frame_hd*)frame;
  if (hd->type != ng::NGHTTP2_HEADERS) return 0;
  StreamSt& st = c->streams[hd->stream_id];
  if (namelen == 5 && memcmp(name, ":path", 5) == 0) {
    static const char kCheck[] = "/envoy.service.auth.v3.Authorization/Check";
    static const char kHealth[] = "/grpc.health.v1.Health/Check";
    if (valuelen == sizeof(kCheck) - 1 && memcmp(value, kCheck, valuelen) == 0)
      st.kind = SK_CHECK;
    else if (valuelen == sizeof(kHealth) - 1 && memcmp(value, kHealth, valuelen) == 0)
      st.kind = SK_HEALTH;
    else
      st.kind = SK_OTHER;
  } else if (namelen == 13 && memcmp(name, "grpc-encoding", 13) == 0) {
    if (!(valuelen == 8 && memcmp(value, "identity", 8) == 0)) st.compressed = true;
  }
  return 0;
}

static int on_data_chunk(ng::nghttp2_session*, uint8_t, int32_t stream_id,
                         const uint8_t* data, size_t len, void* user_data) {
  Conn* c = (Conn*)user_data;
  auto it = c->streams.find(stream_id);
  if (it != c->streams.end()) {
    if (it->second.body.size() + len > (size_t)16 << 20) return 0;  // cap 16MB
    it->second.body.append((const char*)data, len);
  }
  return 0;
}

static int on_frame_recv(ng::nghttp2_session*, const void* frame, void* user_data) {
  Conn* c = (Conn*)user_data;
  const ng::nghttp2_frame_hd* hd = (const ng::nghttp2_frame_hd*)frame;
  if ((hd->type == ng::NGHTTP2_DATA || hd->type == ng::NGHTTP2_HEADERS) &&
      (hd->flags & ng::NGHTTP2_FLAG_END_STREAM)) {
    process_request(g_srv, c, hd->stream_id);
  }
  return 0;
}

static int on_stream_close(ng::nghttp2_session*, int32_t stream_id, uint32_t,
                           void* user_data) {
  Conn* c = (Conn*)user_data;
  c->streams.erase(stream_id);
  return 0;
}

// ---- epoll loop -----------------------------------------------------------

static void conn_close(Server* S, Conn* c) {
  {
    std::lock_guard<std::mutex> lk(S->mu);
    S->conns.erase(c->id);
  }
  epoll_ctl(S->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
  close(c->fd);
  if (c->sess) ng::api.session_del(c->sess);
  delete c;
}

// drain nghttp2's send queue into conn.outbuf, write once
static bool conn_pump(Server* S, Conn* c) {
  for (;;) {
    if (c->outbuf.size() < (size_t)256 << 10) {
      const uint8_t* data = nullptr;
      ssize_t n = ng::api.mem_send(c->sess, &data);
      if (n < 0) return false;
      if (n > 0) {
        c->outbuf.append((const char*)data, (size_t)n);
        continue;
      }
    }
    if (c->outbuf.empty()) break;
    ssize_t w = send(c->fd, c->outbuf.data(), c->outbuf.size(), MSG_NOSIGNAL);
    if (w < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        if (!c->want_eout) {
          struct epoll_event ev;
          ev.events = EPOLLIN | EPOLLOUT;
          ev.data.u32 = c->id;
          epoll_ctl(S->epfd, EPOLL_CTL_MOD, c->fd, &ev);
          c->want_eout = true;
        }
        return true;
      }
      return false;
    }
    c->outbuf.erase(0, (size_t)w);
    if (c->outbuf.empty() && !ng::api.want_write(c->sess)) break;
  }
  if (c->want_eout && c->outbuf.empty()) {
    struct epoll_event ev;
    ev.events = EPOLLIN;
    ev.data.u32 = c->id;
    epoll_ctl(S->epfd, EPOLL_CTL_MOD, c->fd, &ev);
    c->want_eout = false;
  }
  return true;
}

static void accept_conns(Server* S) {
  for (;;) {
    int fd = accept4(S->listen_fd, nullptr, nullptr, SOCK_NONBLOCK);
    if (fd < 0) return;
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
    Conn* c = new Conn();
    c->fd = fd;
    ng::nghttp2_session_callbacks* cbs = nullptr;
    ng::api.callbacks_new(&cbs);
    ng::api.set_on_header(cbs, on_header);
    ng::api.set_on_data_chunk(cbs, on_data_chunk);
    ng::api.set_on_frame_recv(cbs, on_frame_recv);
    ng::api.set_on_stream_close(cbs, on_stream_close);
    ng::api.session_server_new(&c->sess, cbs, c);
    ng::api.callbacks_del(cbs);
    ng::nghttp2_settings_entry iv[2] = {
        {ng::NGHTTP2_SETTINGS_MAX_CONCURRENT_STREAMS, 10000},  // ref main.go:68-69
        {ng::NGHTTP2_SETTINGS_INITIAL_WINDOW_SIZE, 1 << 20},
    };
    ng::api.submit_settings(c->sess, 0, iv, 2);
    // widen the connection receive window (auto-replenished by nghttp2)
    ng::api.submit_window_update(c->sess, 0, 0, (1 << 30) - 65535);
    {
      std::lock_guard<std::mutex> lk(S->mu);
      c->id = S->next_conn_id++;
      S->conns[c->id] = c;
    }
    S->n_conns.fetch_add(1, std::memory_order_relaxed);
    struct epoll_event ev;
    ev.events = EPOLLIN;
    ev.data.u32 = c->id;
    epoll_ctl(S->epfd, EPOLL_CTL_ADD, fd, &ev);
    conn_pump(S, c);
  }
}

static void drain_done(Server* S) {
  std::deque<Done> q;
  {
    std::lock_guard<std::mutex> lk(S->done_mu);
    q.swap(S->done_q);
  }
  std::vector<Conn*> touched;
  for (Done& d : q) {
    Conn* c;
    {
      std::lock_guard<std::mutex> lk(S->mu);
      auto it = S->conns.find(d.conn_id);
      c = it == S->conns.end() ? nullptr : it->second;
    }
    if (!c) continue;
    if (d.grpc_status) submit_grpc_error(c, d.stream_id, d.grpc_status);
    else submit_grpc_response(c, d.stream_id, d.msg);
    if (d.t_done)
      S->stage_respond[stage_bucket(now_mono_ns() - d.t_done)].fetch_add(
          1, std::memory_order_relaxed);
    if (std::find(touched.begin(), touched.end(), c) == touched.end())
      touched.push_back(c);
  }
  for (Conn* c : touched)
    if (!conn_pump(S, c)) conn_close(S, c);
}

static void epoll_loop(Server* S) {
  struct epoll_event evs[64];
  while (S->running.load(std::memory_order_relaxed)) {
    int n = epoll_wait(S->epfd, evs, 64, 100);
    for (int i = 0; i < n; ++i) {
      uint32_t id = evs[i].data.u32;
      if (id == 0xFFFFFFFFu) {  // listen fd
        accept_conns(S);
        continue;
      }
      if (id == 0xFFFFFFFEu) {  // eventfd: completions pending
        uint64_t v;
        while (read(S->evfd, &v, 8) == 8) {}
        drain_done(S);
        if (S->draining.load(std::memory_order_relaxed)) flush_batch(S);
        continue;
      }
      if (id == 0xFFFFFFFDu) {  // timerfd: micro-batch window expired
        uint64_t v;
        while (read(S->tfd, &v, 8) == 8) {}
        flush_batch(S, /*from_timer=*/true);
        continue;
      }
      Conn* c;
      {
        std::lock_guard<std::mutex> lk(S->mu);
        auto it = S->conns.find(id);
        c = it == S->conns.end() ? nullptr : it->second;
      }
      if (!c) continue;
      bool dead = false;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) dead = true;
      if (!dead && (evs[i].events & EPOLLIN)) {
        char buf[65536];
        for (;;) {
          ssize_t r = recv(c->fd, buf, sizeof buf, 0);
          if (r > 0) {
            ssize_t rc = ng::api.mem_recv(c->sess, (const uint8_t*)buf, (size_t)r);
            if (rc < 0) { dead = true; break; }
            if (r < (ssize_t)sizeof buf) break;
          } else if (r == 0) { dead = true; break; }
          else {
            if (errno == EAGAIN || errno == EWOULDBLOCK) break;
            dead = true; break;
          }
        }
      }
      if (!dead) dead = !conn_pump(S, c);
      if (dead) conn_close(S, c);
    }
  }
  // shutdown: write the answers already queued (bounded: 1 s in all), then
  // close all conns and notify waiters
  drain_done(S);
  std::vector<Conn*> all;
  {
    std::lock_guard<std::mutex> lk(S->mu);
    for (auto& kv : S->conns) all.push_back(kv.second);
    S->conns.clear();
  }
  const int64_t flush_deadline = now_mono_ns() + 1000000000LL;
  for (Conn* c : all) {
    while (!c->outbuf.empty() && now_mono_ns() < flush_deadline) {
      ssize_t w = send(c->fd, c->outbuf.data(), c->outbuf.size(),
                       MSG_NOSIGNAL);
      if (w > 0) { c->outbuf.erase(0, (size_t)w); continue; }
      if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
        struct pollfd pfd = {c->fd, POLLOUT, 0};
        poll(&pfd, 1, 10);
        continue;
      }
      break;
    }
  }
  for (Conn* c : all) {
    epoll_ctl(S->epfd, EPOLL_CTL_DEL, c->fd, nullptr);
    close(c->fd);
    if (c->sess) ng::api.session_del(c->sess);
    delete c;
  }
  {
    std::lock_guard<std::mutex> lk(S->batch_mu);
    S->batch_events.push_back({EV_STOPPED, 0, 0, 0});
  }
  S->batch_cv.notify_all();
  S->slow_cv.notify_all();
}

// ---- control-plane entry points (called from Python with GIL held, except
// the waits which release it in pymod) ---------------------------------------

static int server_start(Server* S) {
  if (!ng::load()) return -1;
  S->listen_fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (S->listen_fd < 0) return -2;
  int one = 1;
  setsockopt(S->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof addr);
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(S->any_addr ? INADDR_ANY : INADDR_LOOPBACK);
  addr.sin_port = htons((uint16_t)S->port);
  if (bind(S->listen_fd, (struct sockaddr*)&addr, sizeof addr) < 0 ||
      listen(S->listen_fd, 1024) < 0) {
    close(S->listen_fd);  // error paths must not leak the socket
    S->listen_fd = -1;
    return -3;
  }
  socklen_t alen = sizeof addr;
  getsockname(S->listen_fd, (struct sockaddr*)&addr, &alen);
  S->bound_port = ntohs(addr.sin_port);
  S->epfd = epoll_create1(0);
  S->evfd = eventfd(0, EFD_NONBLOCK);
  S->tfd = timerfd_create(CLOCK_MONOTONIC, TFD_NONBLOCK);
  struct epoll_event ev;
  ev.events = EPOLLIN;
  ev.data.u32 = 0xFFFFFFFFu;
  epoll_ctl(S->epfd, EPOLL_CTL_ADD, S->listen_fd, &ev);
  ev.data.u32 = 0xFFFFFFFEu;
  epoll_ctl(S->epfd, EPOLL_CTL_ADD, S->evfd, &ev);
  ev.data.u32 = 0xFFFFFFFDu;
  epoll_ctl(S->epfd, EPOLL_CTL_ADD, S->tfd, &ev);
  S->running.store(true);
  S->thr = std::thread(epoll_loop, S);
  return 0;
}

static void wake_epoll(Server* S);

// begin the graceful drain: refuse new Check() streams, flush the filling
// batch (the epoll thread does, on the wake)
static void server_drain(Server* S) {
  S->draining.store(true);
  wake_epoll(S);
}

// work the server still owes answers for: flushed batches not completed,
// the filling batch's rows, slow-lane requests taken or queued, and
// completions not yet handed to the epoll thread
static void pending_work(Server* S, uint64_t& batches, uint64_t& filling,
                         uint64_t& done_queued) {
  std::lock_guard<std::mutex> lk(S->mu);
  batches = 0;
  for (auto& kv : S->snaps) batches += (uint64_t)kv.second->pending_batches;
  filling = S->fill_slot >= 0 ? (uint64_t)S->fill_count : 0;
  std::lock_guard<std::mutex> lk2(S->done_mu);
  done_queued = S->done_q.size();
}

static void server_stop(Server* S) {
  if (!S->running.exchange(false)) return;
  if (S->thr.joinable()) S->thr.join();
  if (S->listen_fd >= 0) close(S->listen_fd);
  if (S->epfd >= 0) close(S->epfd);
  if (S->evfd >= 0) close(S->evfd);
  if (S->tfd >= 0) close(S->tfd);
}

static void wake_epoll(Server* S) {
  uint64_t one = 1;
  ssize_t r = write(S->evfd, &one, 8);
  (void)r;
}

// retire check: emit SNAP_RETIRED for non-current snapshots with no pending
// batches, and ERASE them from the registry — retired snapshots hold
// dangling pointers (numpy slots, interner) once Python frees its side, and
// an append-only map would leak a full corpus copy per reconcile.
// Call under S->mu.
static void maybe_retire_locked(Server* S, std::vector<int64_t>& retired) {
  for (auto it = S->snaps.begin(); it != S->snaps.end();) {
    Snapshot* sn = it->second.get();
    if (it->second != S->cur && sn->pending_batches == 0 && sn != S->epoll_pin &&
        (S->fill_snap == nullptr || S->fill_snap.get() != sn)) {
      // undrained direct-decision counters survive retirement in the
      // leftover map so no metric increment is lost
      for (size_t f = 0; sn->fc_counts && f < sn->fcs.size(); ++f) {
        uint64_t ok = sn->fc_counts[3 * f].exchange(0);
        uint64_t mi = sn->fc_counts[3 * f + 1].exchange(0);
        uint64_t inv = sn->fc_counts[3 * f + 2].exchange(0);
        if (ok | mi | inv) {
          auto& agg = S->fc_leftover[sn->fcs[f].ns + '\x1f' + sn->fcs[f].name];
          agg[0] += ok;
          agg[1] += mi;
          agg[2] += inv;
        }
      }
      // same for undrained duration-histogram buckets
      for (size_t f = 0; sn->fc_durs && f < sn->fcs.size(); ++f) {
        uint64_t any = 0;
        uint64_t vals[DUR_STRIDE];
        for (int k = 0; k < DUR_STRIDE; ++k)
          any |= (vals[k] = sn->fc_durs[f * DUR_STRIDE + k].exchange(0));
        if (any) {
          auto& agg = S->dur_leftover[sn->fcs[f].ns + '\x1f' + sn->fcs[f].name];
          for (int k = 0; k < DUR_STRIDE; ++k) agg[k] += vals[k];
        }
      }
      retired.push_back(sn->id);
      it = S->snaps.erase(it);
    } else {
      ++it;
    }
  }
}

// drain per-authconfig direct-decision counters (all live snapshots + the
// leftovers of retired ones) into `out`, keyed ns+'\x1f'+name
static void drain_fc_counts(
    Server* S, std::unordered_map<std::string, std::array<uint64_t, 3>>& out) {
  std::lock_guard<std::mutex> lk(S->mu);
  for (auto& kv : S->snaps) {
    Snapshot* sn = kv.second.get();
    for (size_t f = 0; sn->fc_counts && f < sn->fcs.size(); ++f) {
      uint64_t ok = sn->fc_counts[3 * f].exchange(0);
      uint64_t mi = sn->fc_counts[3 * f + 1].exchange(0);
      uint64_t inv = sn->fc_counts[3 * f + 2].exchange(0);
      if (ok | mi | inv) {
        auto& agg = out[sn->fcs[f].ns + '\x1f' + sn->fcs[f].name];
        agg[0] += ok;
        agg[1] += mi;
        agg[2] += inv;
      }
    }
  }
  for (auto& kv : S->fc_leftover) {
    auto& agg = out[kv.first];
    agg[0] += kv.second[0];
    agg[1] += kv.second[1];
    agg[2] += kv.second[2];
  }
  S->fc_leftover.clear();
}

// drain per-authconfig duration histograms (live snapshots + retired
// leftovers) into `out`, keyed ns+'\x1f'+name → [15 buckets, sum_ns]
static void drain_durations(
    Server* S, std::unordered_map<std::string, std::array<uint64_t, DUR_STRIDE>>& out) {
  std::lock_guard<std::mutex> lk(S->mu);
  for (auto& kv : S->snaps) {
    Snapshot* sn = kv.second.get();
    for (size_t f = 0; sn->fc_durs && f < sn->fcs.size(); ++f) {
      uint64_t any = 0;
      uint64_t vals[DUR_STRIDE];
      for (int k = 0; k < DUR_STRIDE; ++k)
        any |= (vals[k] = sn->fc_durs[f * DUR_STRIDE + k].exchange(0));
      if (any) {
        auto& agg = out[sn->fcs[f].ns + '\x1f' + sn->fcs[f].name];
        for (int k = 0; k < DUR_STRIDE; ++k) agg[k] += vals[k];
      }
    }
  }
  for (auto& kv : S->dur_leftover) {
    auto& agg = out[kv.first];
    for (int k = 0; k < DUR_STRIDE; ++k) agg[k] += kv.second[k];
  }
  S->dur_leftover.clear();
}

static void emit_retired(Server* S, const std::vector<int64_t>& retired) {
  if (retired.empty()) return;
  {
    std::lock_guard<std::mutex> lk(S->batch_mu);
    for (int64_t id : retired) S->batch_events.push_back({EV_SNAP_RETIRED, id, 0, 0});
  }
  S->batch_cv.notify_all();
}

static void complete_batch(Server* S, int64_t snap_id, int slot, const uint8_t* verdict) {
  std::shared_ptr<Snapshot> snap;
  std::vector<Entry> entries;
  {
    std::lock_guard<std::mutex> lk(S->mu);
    auto it = S->snaps.find(snap_id);
    if (it == S->snaps.end()) return;
    snap = it->second;
    entries.swap(snap->slot_entries[slot]);
  }
  uint64_t allowed = 0, handed_off = 0, unavailable = 0;
  const int64_t t_now = now_mono_ns();
  const int64_t t_flush = snap->slot_flush_ns[slot];
  const int exec_b = stage_bucket(t_now - t_flush);
  // hybrid kernel-PASS entries: collected under mu, enqueued to the slow
  // lane after (push ordering mirrors push_slow: mu for slow_pending,
  // then slow_mu — never nested)
  struct Handoff { uint32_t conn_id; int32_t stream_id; std::string raw; };
  std::vector<Handoff> handoffs;
  std::deque<Done> dones;
  {
    std::lock_guard<std::mutex> lk(S->mu);
    for (size_t i = 0; i < entries.size(); ++i) {
      Entry& e = entries[i];
      const FastConfig& fc = snap->fcs[e.fc];
      const uint8_t v = verdict[i];
      bool ok = v == V_ALLOW;
      if (v == V_UNAVAILABLE) {
        unavailable++;
        dones.push_back({e.conn_id, e.stream_id, snap->unavailable_msg, 0,
                         t_now});
        continue;
      }
      if (ok && fc.hybrid) {
        handed_off++;
        handoffs.push_back({e.conn_id, e.stream_id, std::move(e.raw)});
        continue;
      }
      allowed += ok;
      dones.push_back(
          {e.conn_id, e.stream_id,
           ok ? (e.ok_msg ? *e.ok_msg : fc.ok_msg)
              : pick_deny(e.deny_msg ? *e.deny_msg : fc.deny, v),
           0, t_now});
    }
    snap->free_slots.push_back(slot);
    snap->pending_batches--;
  }
  for (Handoff& h : handoffs) {
    uint64_t id = 0;
    bool shed = false;
    {
      std::lock_guard<std::mutex> lk(S->mu);
      if (S->slow_pending.size() >= S->slow_cap) {
        shed = true;
      } else {
        id = S->next_slow_id++;
        S->slow_pending[id] = {h.conn_id, h.stream_id};
      }
    }
    if (shed) {
      dones.push_back({h.conn_id, h.stream_id, std::string(), 8, 0});
      S->n_slow_shed.fetch_add(1, std::memory_order_relaxed);
      continue;
    }
    {
      std::lock_guard<std::mutex> lk(S->slow_mu);
      S->slow_q.push_back({id, std::move(h.raw)});
    }
    S->n_slow.fetch_add(1, std::memory_order_relaxed);
  }
  if (!handoffs.empty()) S->slow_cv.notify_all();
  if (!dones.empty()) {
    std::lock_guard<std::mutex> lk(S->done_mu);
    for (Done& d : dones) S->done_q.push_back(std::move(d));
  }
  // per-request on-box stages + the duration series the pipeline observes
  // (ref pkg/service/auth_pipeline.go:26-36): all clocked here, no tunnel.
  // Hybrid handoffs skip the duration series — the Python pipeline they
  // continue into observes them itself (no double counting)
  for (size_t i = 0; i < entries.size(); ++i) {
    const Entry& e = entries[i];
    S->stage_wait[stage_bucket(t_flush - e.t_enq)].fetch_add(
        1, std::memory_order_relaxed);
    S->stage_exec[exec_b].fetch_add(1, std::memory_order_relaxed);
    if ((verdict[i] == V_ALLOW && snap->fcs[e.fc].hybrid) ||
        verdict[i] == V_UNAVAILABLE)
      continue;
    if (snap->fc_durs) {
      int64_t dur = t_now - e.t_enq;
      auto* d = &snap->fc_durs[(size_t)e.fc * DUR_STRIDE];
      d[dur_bucket(dur)].fetch_add(1, std::memory_order_relaxed);
      d[N_DUR_BUCKETS].fetch_add((uint64_t)dur, std::memory_order_relaxed);
    }
  }
  S->n_hybrid.fetch_add(handed_off, std::memory_order_relaxed);
  S->n_allowed.fetch_add(allowed, std::memory_order_relaxed);
  S->n_unavailable.fetch_add(unavailable, std::memory_order_relaxed);
  S->n_denied.fetch_add(entries.size() - handed_off - allowed - unavailable,
                        std::memory_order_relaxed);
  std::vector<int64_t> retired;
  {
    std::lock_guard<std::mutex> lk(S->mu);
    maybe_retire_locked(S, retired);
  }
  emit_retired(S, retired);
  wake_epoll(S);
}

// register (or refresh) a runtime plan variant for one credential — the
// slow lane calls this after a successful token verification.  Overwrites
// swap the shared_ptr (a mid-request reader holds its own reference), so
// stale plan vectors free as soon as the last reader drops.  Returns false
// when the snapshot is gone (stale registration: harmless no-op) or the
// cap is hit.
static bool add_variant(Server* S, int64_t snap_id, int32_t fc_idx,
                        int32_t src_idx, std::string cred,
                        std::vector<FastPlan> plans, std::string ok_bytes,
                        DenySet deny_bytes, int64_t exp_ns) {
  std::shared_ptr<Snapshot> snap;
  {
    std::lock_guard<std::mutex> lk(S->mu);
    auto it = S->snaps.find(snap_id);
    if (it == S->snaps.end()) return false;
    snap = it->second;
  }
  if (fc_idx < 0 || (size_t)fc_idx >= snap->fcs.size()) return false;
  FastConfig& fc = snap->fcs[fc_idx];
  if (src_idx < 0 || (size_t)src_idx >= fc.sources.size()) return false;
  CredSource& src = fc.sources[src_idx];
  if (!src.dyn) return false;
  auto sp = std::make_shared<const std::vector<FastPlan>>(std::move(plans));
  std::shared_ptr<const std::string> ok;
  if (!ok_bytes.empty())
    ok = std::make_shared<const std::string>(std::move(ok_bytes));
  std::shared_ptr<const DenySet> deny;
  if (!deny_bytes.empty())
    deny = std::make_shared<const DenySet>(std::move(deny_bytes));
  {
    std::lock_guard<std::mutex> vlk(snap->var_mu);
    auto it = src.dyn_variants.find(cred);
    if (it == src.dyn_variants.end() &&
        src.dyn_variants.size() >= DYN_VARIANT_CAP) {
      // sweep expired entries once; if still full, the slow lane keeps
      // serving this token (correct, just not fast)
      int64_t now = now_realtime_ns();
      for (auto sit = src.dyn_variants.begin(); sit != src.dyn_variants.end();)
        sit = sit->second.exp_ns <= now ? src.dyn_variants.erase(sit)
                                        : std::next(sit);
      if (src.dyn_variants.size() >= DYN_VARIANT_CAP) return false;
      it = src.dyn_variants.end();
    }
    if (it != src.dyn_variants.end())
      it->second = {std::move(sp), exp_ns, std::move(ok), std::move(deny)};
    else
      src.dyn_variants.emplace(
          std::move(cred),
          CredSource::DynVar{std::move(sp), exp_ns, std::move(ok),
                             std::move(deny)});
  }
  S->n_dyn_add.fetch_add(1, std::memory_order_relaxed);
  return true;
}

static void complete_slow(Server* S, uint64_t req_id, const char* msg, size_t n,
                          int grpc_status) {
  SlowPending sp;
  {
    std::lock_guard<std::mutex> lk(S->mu);
    auto it = S->slow_pending.find(req_id);
    if (it == S->slow_pending.end()) return;
    sp = it->second;
    S->slow_pending.erase(it);
  }
  bool was_empty;
  {
    std::lock_guard<std::mutex> lk(S->done_mu);
    was_empty = S->done_q.empty();
    S->done_q.push_back({sp.conn_id, sp.stream_id, std::string(msg, n),
                         grpc_status, now_mono_ns()});
  }
  // coalesce wakes: drain_done swaps the WHOLE queue under done_mu, so a
  // non-empty observation means a wake is already owed — the eventfd
  // write per completion was a measurable share of the slow lane's budget
  if (was_empty) wake_epoll(S);
}

// batch form: the Python slow lane buffers finished responses and a
// dedicated completer thread lands N of them in two lock rounds + at most
// one wake — per-response mutex/wake traffic was ~35µs of contended wall
// on the asyncio thread
struct SlowDone { uint64_t req_id; std::string msg; int grpc_status; };

static void complete_slow_many(Server* S, std::vector<SlowDone>& items) {
  std::deque<Done> dones;
  const int64_t t_now = now_mono_ns();
  {
    std::lock_guard<std::mutex> lk(S->mu);
    for (SlowDone& sd : items) {
      auto it = S->slow_pending.find(sd.req_id);
      if (it == S->slow_pending.end()) continue;
      dones.push_back({it->second.conn_id, it->second.stream_id,
                       std::move(sd.msg), sd.grpc_status, t_now});
      S->slow_pending.erase(it);
    }
  }
  if (dones.empty()) return;
  bool was_empty;
  {
    std::lock_guard<std::mutex> lk(S->done_mu);
    was_empty = S->done_q.empty();
    for (Done& d : dones) S->done_q.push_back(std::move(d));
  }
  if (was_empty) wake_epoll(S);
}

}  // namespace fe
