// Native batch encoder: the CPU half of the hot path.
//
// Replaces compiler/encode.py's per-request Python loops (selector walk,
// gjson-String render, intern lookup, tensor scatter) with a multithreaded
// C++ pass over a batch of Authorization-JSON documents.  Semantics must be
// bit-identical to the Python encoder (the reference behavior is gjson
// String()/Array() — ref: pkg/jsonexp/expressions.go:59-96,
// pkg/json/json.go); tests/test_torch_native_encoder.py runs the
// differential.  pymod.cpp includes this file as one translation unit.
//
// C ABI (also callable through ctypes):
//   atpu_policy_new(...)  -> opaque Policy*
//   atpu_policy_free(p)
//   atpu_encode(...)      -> n_cpu_tasks >= 0, or <0 => caller falls back
//
// Only plain dot-path selectors are resolved here ("key" segments — the
// overwhelming majority); attrs with gjson-extended selectors (#, queries,
// @modifiers) are flagged complex by the wrapper and finished in Python.
//
// Build: g++ -O2 -shared -fPIC -pthread -std=c++17 encoder.cpp -o libatpuenc.so

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// op codes — must match authorino_tpu_torch/compiler/compile.py
enum {
  OP_EQ = 0, OP_NEQ = 1, OP_INCL = 2, OP_EXCL = 3,
  OP_CPU = 4, OP_ERROR = 5, OP_TREE_CPU = 6, OP_REGEX_DFA = 7,
};
constexpr int32_t UNSEEN = -2;

// ---------------------------------------------------------------------------
// interner: open-addressing read-only hash table (string -> id)
// ---------------------------------------------------------------------------
struct Interner {
  struct Slot { const char* p; int32_t len; int32_t id; };
  std::vector<Slot> slots;
  uint64_t mask = 0;

  static uint64_t hash(const char* s, size_t n) {
    uint64_t h = 1469598103934665603ull;  // FNV-1a
    for (size_t i = 0; i < n; ++i) { h ^= (uint8_t)s[i]; h *= 1099511628211ull; }
    return h;
  }

  void build(const char* blob, const int64_t* offs, const int32_t* ids, int32_t n) {
    size_t cap = 16;
    while (cap < (size_t)n * 2) cap <<= 1;
    slots.assign(cap, Slot{nullptr, 0, UNSEEN});
    mask = cap - 1;
    for (int32_t i = 0; i < n; ++i) {
      const char* p = blob + offs[i];
      int32_t len = (int32_t)(offs[i + 1] - offs[i]);
      uint64_t h = hash(p, (size_t)len) & mask;
      while (slots[h].p != nullptr) h = (h + 1) & mask;
      slots[h] = Slot{p, len, ids[i]};
    }
  }

  int32_t lookup(const char* s, size_t n) const {
    uint64_t h = hash(s, n) & mask;
    for (;;) {
      const Slot& sl = slots[h];
      if (sl.p == nullptr) return UNSEEN;
      if ((size_t)sl.len == n && memcmp(sl.p, s, n) == 0) return sl.id;
      h = (h + 1) & mask;
    }
  }
};

// ---------------------------------------------------------------------------
// JSON DOM (arena) — parses json.dumps output plus NaN/Infinity tokens
// ---------------------------------------------------------------------------
enum VType : uint8_t { V_NULL, V_FALSE, V_TRUE, V_INT, V_DBL, V_STR, V_ARR, V_OBJ };

struct Node {
  uint8_t type;
  uint8_t key_decoded;   // key lives in decode arena (had escapes)
  uint8_t str_decoded;   // string/int-token arena flag
  int32_t nchildren;
  int64_t str_off; int32_t str_len;   // V_STR text / V_INT raw token
  int64_t key_off; int32_t key_len;   // object-member key
  double dbl;
  int32_t first_child;   // node index, -1 none
  int32_t next_sibling;  // node index, -1 none
};

struct Doc {
  std::vector<Node>* nodes;
  std::string* decode;     // decoded (escaped) strings
  const char* blob;        // raw json text

  const char* str(const Node& n) const { return (n.str_decoded ? decode->data() : blob) + n.str_off; }
  const char* key(const Node& n) const { return (n.key_decoded ? decode->data() : blob) + n.key_off; }
};

struct Parser {
  const char* p;
  const char* end;
  std::vector<Node>& nodes;
  std::string& decode;
  const char* blob;
  bool ok = true;

  void skip_ws() { while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p; }

  // returns node index or -1
  int32_t parse_value() {
    skip_ws();
    if (p >= end) { ok = false; return -1; }
    char c = *p;
    if (c == '{') return parse_obj();
    if (c == '[') return parse_arr();
    if (c == '"') return parse_str();
    if (c == 't') { return lit("true", V_TRUE); }
    if (c == 'f') { return lit("false", V_FALSE); }
    if (c == 'n') { return lit("null", V_NULL); }
    if (c == 'N') { return lit_dbl("NaN", NAN); }
    if (c == 'I') { return lit_dbl("Infinity", INFINITY); }
    if (c == '-' && p + 1 < end && p[1] == 'I') { return lit_dbl("-Infinity", -INFINITY); }
    return parse_num();
  }

  int32_t lit(const char* s, uint8_t t) {
    size_t n = strlen(s);
    if ((size_t)(end - p) < n || memcmp(p, s, n) != 0) { ok = false; return -1; }
    p += n;
    return push(t);
  }
  int32_t lit_dbl(const char* s, double v) {
    size_t n = strlen(s);
    if ((size_t)(end - p) < n || memcmp(p, s, n) != 0) { ok = false; return -1; }
    p += n;
    int32_t i = push(V_DBL);
    nodes[i].dbl = v;
    return i;
  }

  int32_t push(uint8_t t) {
    Node n{};
    n.type = t;
    n.first_child = -1;
    n.next_sibling = -1;
    nodes.push_back(n);
    return (int32_t)nodes.size() - 1;
  }

  int32_t parse_num() {
    const char* start = p;
    if (p < end && *p == '-') ++p;
    bool is_int = true;
    while (p < end && ((*p >= '0' && *p <= '9'))) ++p;
    if (p < end && *p == '.') { is_int = false; ++p; while (p < end && *p >= '0' && *p <= '9') ++p; }
    if (p < end && (*p == 'e' || *p == 'E')) {
      is_int = false; ++p;
      if (p < end && (*p == '+' || *p == '-')) ++p;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p == start || (*start == '-' && p == start + 1)) { ok = false; return -1; }
    int32_t i;
    if (is_int) {
      // big ints render as their own token (Python str(int) == token for
      // canonical JSON ints); "-0" is the one non-canonical case
      i = push(V_INT);
      if (p - start == 2 && start[0] == '-' && start[1] == '0') {
        nodes[i].str_off = start + 1 - blob;  // "-0" -> "0"
        nodes[i].str_len = 1;
      } else {
        nodes[i].str_off = start - blob;
        nodes[i].str_len = (int32_t)(p - start);
      }
      nodes[i].str_decoded = 0;
    } else {
      double v = strtod(start, nullptr);
      i = push(V_DBL);
      nodes[i].dbl = v;
    }
    return i;
  }

  // decode a JSON string starting at '"'; returns (off, len, decoded_flag)
  bool scan_string(int64_t* off, int32_t* len, uint8_t* decoded) {
    ++p;  // opening quote
    const char* start = p;
    bool has_escape = false;
    while (p < end && *p != '"') {
      if (*p == '\\') { has_escape = true; ++p; if (p >= end) return false; }
      ++p;
    }
    if (p >= end) return false;
    if (!has_escape) {
      *off = start - blob;
      *len = (int32_t)(p - start);
      *decoded = 0;
      ++p;
      return true;
    }
    size_t out_start = decode.size();
    const char* q = start;
    while (q < p) {
      if (*q != '\\') { decode.push_back(*q++); continue; }
      ++q;
      switch (*q) {
        case '"': decode.push_back('"'); ++q; break;
        case '\\': decode.push_back('\\'); ++q; break;
        case '/': decode.push_back('/'); ++q; break;
        case 'b': decode.push_back('\b'); ++q; break;
        case 'f': decode.push_back('\f'); ++q; break;
        case 'n': decode.push_back('\n'); ++q; break;
        case 'r': decode.push_back('\r'); ++q; break;
        case 't': decode.push_back('\t'); ++q; break;
        case 'u': {
          ++q;
          if (p - q < 4) return false;
          uint32_t cp = 0;
          for (int k = 0; k < 4; ++k) {
            char h = q[k]; cp <<= 4;
            if (h >= '0' && h <= '9') cp |= h - '0';
            else if (h >= 'a' && h <= 'f') cp |= h - 'a' + 10;
            else if (h >= 'A' && h <= 'F') cp |= h - 'A' + 10;
            else return false;
          }
          q += 4;
          if (cp >= 0xD800 && cp <= 0xDBFF && p - q >= 6 && q[0] == '\\' && q[1] == 'u') {
            uint32_t lo = 0;
            bool okp = true;
            for (int k = 0; k < 4; ++k) {
              char h = q[2 + k]; lo <<= 4;
              if (h >= '0' && h <= '9') lo |= h - '0';
              else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
              else { okp = false; break; }
            }
            if (okp && lo >= 0xDC00 && lo <= 0xDFFF) {
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              q += 6;
            }
          }
          // UTF-8 encode
          if (cp < 0x80) decode.push_back((char)cp);
          else if (cp < 0x800) {
            decode.push_back((char)(0xC0 | (cp >> 6)));
            decode.push_back((char)(0x80 | (cp & 0x3F)));
          } else if (cp < 0x10000) {
            decode.push_back((char)(0xE0 | (cp >> 12)));
            decode.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
            decode.push_back((char)(0x80 | (cp & 0x3F)));
          } else {
            decode.push_back((char)(0xF0 | (cp >> 18)));
            decode.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
            decode.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
            decode.push_back((char)(0x80 | (cp & 0x3F)));
          }
          break;
        }
        default: return false;
      }
    }
    *off = (int64_t)out_start;
    *len = (int32_t)(decode.size() - out_start);
    *decoded = 1;
    ++p;
    return true;
  }

  int32_t parse_str() {
    int64_t off; int32_t len; uint8_t dec;
    if (!scan_string(&off, &len, &dec)) { ok = false; return -1; }
    int32_t i = push(V_STR);
    nodes[i].str_off = off;
    nodes[i].str_len = len;
    nodes[i].str_decoded = dec;
    return i;
  }

  int32_t parse_arr() {
    ++p;
    int32_t self = push(V_ARR);
    skip_ws();
    if (p < end && *p == ']') { ++p; return self; }
    int32_t prev = -1, count = 0;
    for (;;) {
      int32_t child = parse_value();
      if (!ok) return -1;
      if (prev < 0) nodes[self].first_child = child; else nodes[prev].next_sibling = child;
      prev = child;
      ++count;
      skip_ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == ']') { ++p; break; }
      ok = false; return -1;
    }
    nodes[self].nchildren = count;
    return self;
  }

  int32_t parse_obj() {
    ++p;
    int32_t self = push(V_OBJ);
    skip_ws();
    if (p < end && *p == '}') { ++p; return self; }
    int32_t prev = -1, count = 0;
    for (;;) {
      skip_ws();
      if (p >= end || *p != '"') { ok = false; return -1; }
      int64_t koff; int32_t klen; uint8_t kdec;
      if (!scan_string(&koff, &klen, &kdec)) { ok = false; return -1; }
      skip_ws();
      if (p >= end || *p != ':') { ok = false; return -1; }
      ++p;
      int32_t child = parse_value();
      if (!ok) return -1;
      nodes[child].key_off = koff;
      nodes[child].key_len = klen;
      nodes[child].key_decoded = kdec;
      if (prev < 0) nodes[self].first_child = child; else nodes[prev].next_sibling = child;
      prev = child;
      ++count;
      skip_ws();
      if (p < end && *p == ',') { ++p; continue; }
      if (p < end && *p == '}') { ++p; break; }
      ok = false; return -1;
    }
    nodes[self].nchildren = count;
    return self;
  }
};

// ---------------------------------------------------------------------------
// rendering (gjson String() semantics, matching compiler/encode.py::_render)
// ---------------------------------------------------------------------------

// Python repr(float) equivalent: shortest round-trip digits, fixed form for
// -4 <= exp10 < 16, else scientific with >=2 exponent digits
void repr_double(double v, std::string& out) {
  if (std::isnan(v)) { out += "nan"; return; }
  if (std::isinf(v)) { out += v > 0 ? "inf" : "-inf"; return; }
  char buf[64];
  auto res = std::to_chars(buf, buf + sizeof buf, v, std::chars_format::scientific);
  // buf: "-d.ddddde±XX" (shortest mantissa)
  char* e = buf;
  while (e < res.ptr && *e != 'e') ++e;
  int exp10 = (int)strtol(e + 1, nullptr, 10);
  std::string mant(buf, e - buf);   // like "-1.2345" or "5"
  bool neg = !mant.empty() && mant[0] == '-';
  if (neg) mant.erase(0, 1);
  std::string digits;
  for (char c : mant) if (c != '.') digits.push_back(c);
  while (digits.size() > 1 && digits.back() == '0') digits.pop_back();
  if (neg) out.push_back('-');
  if (exp10 >= 16 || exp10 < -4) {
    out.push_back(digits[0]);
    if (digits.size() > 1) { out.push_back('.'); out.append(digits, 1, std::string::npos); }
    char eb[16];
    snprintf(eb, sizeof eb, "e%+03d", exp10);
    out += eb;
  } else if (exp10 >= 0) {
    size_t ip = (size_t)exp10 + 1;
    if (digits.size() <= ip) {
      out += digits;
      out.append(ip - digits.size(), '0');
      out += ".0";
    } else {
      out.append(digits, 0, ip);
      out.push_back('.');
      out.append(digits, ip, std::string::npos);
    }
  } else {
    out += "0.";
    out.append((size_t)(-exp10 - 1), '0');
    out += digits;
  }
}

// gjson number String(): int-like floats render as integers
void num_str(double v, std::string& out) {
  if (std::isnan(v) || std::isinf(v)) { repr_double(v, out); return; }
  if (v == std::floor(v) && std::fabs(v) < 1e16) {
    char buf[32];
    auto res = std::to_chars(buf, buf + sizeof buf, (long long)v);
    out.append(buf, res.ptr - buf);
    return;
  }
  repr_double(v, out);
}

void escape_json(const char* s, int32_t n, std::string& out) {
  out.push_back('"');
  for (int32_t i = 0; i < n; ++i) {
    unsigned char c = (unsigned char)s[i];
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\b': out += "\\b"; break;
      case '\f': out += "\\f"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char buf[8];
          snprintf(buf, sizeof buf, "\\u%04x", c);
          out += buf;
        } else {
          out.push_back((char)c);  // ensure_ascii=False: UTF-8 passthrough
        }
    }
  }
  out.push_back('"');
}

// compact raw-JSON dump (json.dumps(v, separators=(",",":"), ensure_ascii=False))
void dump_json(const Doc& d, const Node& n, std::string& out) {
  switch (n.type) {
    case V_NULL: out += "null"; break;
    case V_TRUE: out += "true"; break;
    case V_FALSE: out += "false"; break;
    case V_INT: out.append(d.str(n), n.str_len); break;
    case V_DBL:
      if (std::isnan(n.dbl)) out += "NaN";
      else if (std::isinf(n.dbl)) out += n.dbl > 0 ? "Infinity" : "-Infinity";
      else if (n.dbl == std::floor(n.dbl) && std::fabs(n.dbl) < 1e16) {
        // json.dumps uses repr: 2.0 -> "2.0", -0.0 -> "-0.0"
        if (n.dbl == 0.0 && std::signbit(n.dbl)) out.push_back('-');
        char buf[32];
        auto res = std::to_chars(buf, buf + sizeof buf, (long long)n.dbl);
        out.append(buf, res.ptr - buf);
        out += ".0";
      } else repr_double(n.dbl, out);
      break;
    case V_STR: escape_json(d.str(n), n.str_len, out); break;
    case V_ARR: {
      out.push_back('[');
      bool first = true;
      for (int32_t c = n.first_child; c >= 0; c = (*d.nodes)[c].next_sibling) {
        if (!first) out.push_back(',');
        first = false;
        dump_json(d, (*d.nodes)[c], out);
      }
      out.push_back(']');
      break;
    }
    case V_OBJ: {
      out.push_back('{');
      bool first = true;
      for (int32_t c = n.first_child; c >= 0; c = (*d.nodes)[c].next_sibling) {
        if (!first) out.push_back(',');
        first = false;
        const Node& ch = (*d.nodes)[c];
        escape_json(d.key(ch), ch.key_len, out);
        out.push_back(':');
        dump_json(d, ch, out);
      }
      out.push_back('}');
      break;
    }
  }
}

// render = gjson String() of a resolved value (encode.py::_render)
void render(const Doc& d, int32_t node_idx, std::string& out) {
  if (node_idx < 0) return;  // missing -> ""
  const Node& n = (*d.nodes)[node_idx];
  switch (n.type) {
    case V_NULL: break;      // "" like missing
    case V_TRUE: out += "true"; break;
    case V_FALSE: out += "false"; break;
    case V_INT: out.append(d.str(n), n.str_len); break;
    case V_DBL: num_str(n.dbl, out); break;
    case V_STR: out.append(d.str(n), n.str_len); break;
    default: dump_json(d, n, out); break;
  }
}

// ---------------------------------------------------------------------------
// policy tables
// ---------------------------------------------------------------------------
struct Policy {
  Interner interner;
  std::string strings;                 // owned copy of all table strings
  int32_t n_attrs = 0, n_leaves = 0, n_configs = 0;
  int32_t members_k = 0, dfa_value_bytes = 0, n_byte_attrs = 0;
  std::vector<std::pair<int64_t, int32_t>> seg_views;  // (off,len) into strings
  std::vector<int32_t> attr_seg_offs;   // [n_attrs+1]
  std::vector<uint8_t> attr_complex;    // [n_attrs]
  std::vector<int32_t> attr_byte_slot;  // [n_attrs]
  std::vector<int32_t> leaf_op, leaf_attr, leaf_const;
  std::vector<int32_t> cfg_attr_offs, cfg_attr_idx;
  std::vector<int32_t> cfg_cpu_offs, cfg_cpu_idx;
};

struct Task { int32_t r, leaf; int32_t val_len; std::string val; };
// val_len: >=0 rendered string present; -1 tree-eval in Python; -2 full
// Python fallback for this (doc, leaf)

// walk a plain dot-path; returns node index or -1 (missing)
int32_t walk(const Doc& d, int32_t root, const Policy& p, int32_t attr) {
  int32_t cur = root;
  for (int32_t s = p.attr_seg_offs[attr]; s < p.attr_seg_offs[attr + 1]; ++s) {
    if (cur < 0) return -1;
    const Node& n = (*d.nodes)[cur];
    const char* kp = p.strings.data() + p.seg_views[s].first;
    int32_t klen = p.seg_views[s].second;
    if (n.type == V_OBJ) {
      int32_t found = -1;
      for (int32_t c = n.first_child; c >= 0; c = (*d.nodes)[c].next_sibling) {
        const Node& ch = (*d.nodes)[c];
        if (ch.key_len == klen && memcmp(d.key(ch), kp, (size_t)klen) == 0) { found = c; break; }
      }
      cur = found;
    } else if (n.type == V_ARR) {
      // match encode.py fast resolver: int(k), only non-negative in range;
      // Python int() tolerates surrounding whitespace and a leading sign
      const char* q = kp; const char* qe = kp + klen;
      while (q < qe && (*q == ' ' || *q == '\t')) ++q;
      while (qe > q && (qe[-1] == ' ' || qe[-1] == '\t')) --qe;
      bool neg = false;
      if (q < qe && (*q == '+' || *q == '-')) { neg = (*q == '-'); ++q; }
      if (q == qe) return -1;
      int64_t idx = 0;
      for (; q < qe; ++q) {
        if (*q < '0' || *q > '9') return -1;
        idx = idx * 10 + (*q - '0');
        if (idx > n.nchildren) break;
      }
      if (neg || idx >= n.nchildren) return -1;
      int32_t c = n.first_child;
      for (int64_t i = 0; i < idx; ++i) c = (*d.nodes)[c].next_sibling;
      cur = c;
    } else {
      return -1;
    }
  }
  return cur;
}

struct ThreadScratch {
  std::vector<Node> nodes;
  std::string decode;
  std::vector<int32_t> attr_epoch;
  std::vector<int32_t> attr_node;        // resolved node per attr (epoch-gated)
  std::vector<std::string> attr_rendered;
  std::vector<std::vector<int32_t>> attr_elem_ids;  // full membership ids
  std::vector<Task> tasks;
};

// shared CPU-leaf pass: identical for the JSON-DOM and PyObject front-ends
// (encode.py :205-241 semantics)
inline void process_cpu_leaves(
    const Policy* p, int32_t r, int32_t row,
    const std::vector<int32_t>& attr_epoch,
    const std::vector<std::string>& attr_rendered,
    const std::vector<std::vector<int32_t>>& attr_elem_ids,
    int32_t A, int32_t L, int32_t NB,
    const uint8_t* byte_ovf, const uint8_t* overflow,
    uint8_t* cpu_lane, std::vector<Task>& tasks) {
  for (int32_t li = p->cfg_cpu_offs[row]; li < p->cfg_cpu_offs[row + 1]; ++li) {
    int32_t leaf = p->cfg_cpu_idx[li];
    int32_t op = p->leaf_op[leaf];
    if (op == OP_ERROR) continue;
    if (op == OP_TREE_CPU) {
      tasks.push_back(Task{r, leaf, -1, {}});
      continue;
    }
    int32_t attr = p->leaf_attr[leaf];
    if (p->attr_complex[attr]) {
      tasks.push_back(Task{r, leaf, -2, {}});
      continue;
    }
    bool have = attr_epoch[attr] == r;
    if (op == OP_REGEX_DFA) {
      int32_t slot = p->attr_byte_slot[attr];
      if (slot >= 0 && byte_ovf[(int64_t)r * NB + slot]) {
        std::string v = have ? attr_rendered[attr] : std::string();
        tasks.push_back(Task{r, leaf, (int32_t)v.size(), std::move(v)});
      }
    } else if (op == OP_CPU) {
      std::string v = have ? attr_rendered[attr] : std::string();
      tasks.push_back(Task{r, leaf, (int32_t)v.size(), std::move(v)});
    } else if (op == OP_INCL || op == OP_EXCL) {
      if (overflow[(int64_t)r * A + attr]) {
        bool member = false;
        if (have) {
          for (int32_t eid : attr_elem_ids[attr])
            if (eid == p->leaf_const[leaf]) { member = true; break; }
        }
        cpu_lane[(int64_t)r * L + leaf] = (op == OP_INCL) ? member : !member;
      }
    }
  }
}

// merge per-source task lists into the flat output arrays; returns n_tasks
// or -1 on capacity overflow (caller falls back to the Python encoder)
inline int64_t merge_tasks(
    std::vector<Task>* lists, int n_lists,
    int32_t* task_r, int32_t* task_leaf, int64_t* task_val_off, int32_t* task_val_len,
    int32_t max_tasks, char* task_arena, int64_t arena_cap) {
  int64_t n_tasks = 0, arena_used = 0;
  for (int t = 0; t < n_lists; ++t) {
    for (Task& tk : lists[t]) {
      if (n_tasks >= max_tasks) return -1;
      if (tk.val_len > 0 && arena_used + tk.val_len > arena_cap) return -1;
      task_r[n_tasks] = tk.r;
      task_leaf[n_tasks] = tk.leaf;
      task_val_len[n_tasks] = tk.val_len;
      if (tk.val_len > 0) {
        memcpy(task_arena + arena_used, tk.val.data(), (size_t)tk.val_len);
        task_val_off[n_tasks] = arena_used;
        arena_used += tk.val_len;
      } else {
        task_val_off[n_tasks] = 0;
      }
      ++n_tasks;
    }
  }
  return n_tasks;
}

}  // namespace

extern "C" {

Policy* atpu_policy_new(
    const char* intern_blob, const int64_t* intern_offs, const int32_t* intern_ids, int32_t n_intern,
    int32_t n_attrs,
    const char* seg_blob, const int64_t* seg_offs, int32_t n_segs,
    const int32_t* attr_seg_offs,
    const uint8_t* attr_complex,
    const int32_t* attr_byte_slot,
    int32_t n_leaves,
    const int32_t* leaf_op, const int32_t* leaf_attr, const int32_t* leaf_const,
    int32_t n_configs,
    const int32_t* cfg_attr_offs, const int32_t* cfg_attr_idx,
    const int32_t* cfg_cpu_offs, const int32_t* cfg_cpu_idx,
    int32_t members_k, int32_t dfa_value_bytes, int32_t n_byte_attrs) {
  Policy* p = new Policy();
  // own copies of the intern blob + segment strings so numpy temporaries can die
  int64_t intern_total = intern_offs[n_intern];
  int64_t seg_total = seg_offs[n_segs];
  p->strings.reserve((size_t)(intern_total + seg_total));
  p->strings.append(intern_blob, (size_t)intern_total);
  p->strings.append(seg_blob, (size_t)seg_total);
  {
    std::vector<int64_t> offs(n_intern + 1);
    for (int32_t i = 0; i <= n_intern; ++i) offs[i] = intern_offs[i];
    p->interner.build(p->strings.data(), offs.data(), intern_ids, n_intern);
  }
  p->seg_views.resize(n_segs);
  for (int32_t i = 0; i < n_segs; ++i)
    p->seg_views[i] = {intern_total + seg_offs[i], (int32_t)(seg_offs[i + 1] - seg_offs[i])};
  p->n_attrs = n_attrs;
  p->attr_seg_offs.assign(attr_seg_offs, attr_seg_offs + n_attrs + 1);
  p->attr_complex.assign(attr_complex, attr_complex + n_attrs);
  p->attr_byte_slot.assign(attr_byte_slot, attr_byte_slot + n_attrs);
  p->n_leaves = n_leaves;
  p->leaf_op.assign(leaf_op, leaf_op + n_leaves);
  p->leaf_attr.assign(leaf_attr, leaf_attr + n_leaves);
  p->leaf_const.assign(leaf_const, leaf_const + n_leaves);
  p->n_configs = n_configs;
  p->cfg_attr_offs.assign(cfg_attr_offs, cfg_attr_offs + n_configs + 1);
  p->cfg_attr_idx.assign(cfg_attr_idx, cfg_attr_idx + cfg_attr_offs[n_configs]);
  p->cfg_cpu_offs.assign(cfg_cpu_offs, cfg_cpu_offs + n_configs + 1);
  p->cfg_cpu_idx.assign(cfg_cpu_idx, cfg_cpu_idx + cfg_cpu_offs[n_configs]);
  p->members_k = members_k;
  p->dfa_value_bytes = dfa_value_bytes;
  p->n_byte_attrs = n_byte_attrs;
  return p;
}

void atpu_policy_free(Policy* p) { delete p; }

// id stores go through store_id so the wire buffers can be int16 when the
// interner fits (compiler/pack.py wire_dtype) — halves the dominant tensors
static inline void store_id(void* base, int64_t idx, int32_t v, int elem16) {
  if (elem16) ((int16_t*)base)[idx] = (int16_t)v;
  else ((int32_t*)base)[idx] = v;
}

int64_t atpu_encode(
    const Policy* p,
    const char* json_blob, const int64_t* doc_offs, int32_t n_docs,
    const int32_t* config_rows,
    int32_t A, int32_t K, int32_t L, int32_t NB, int32_t DVB,
    void* attrs_val, void* attrs_members, uint8_t* overflow,
    uint8_t* cpu_lane, uint8_t* attr_bytes, uint8_t* byte_ovf,
    int32_t* task_r, int32_t* task_leaf, int64_t* task_val_off, int32_t* task_val_len,
    int32_t max_tasks, char* task_arena, int64_t arena_cap,
    int32_t n_threads, int32_t elem16) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_docs) n_threads = n_docs > 0 ? n_docs : 1;

  std::vector<ThreadScratch> scratch(n_threads);
  std::vector<std::thread> threads;
  std::vector<int8_t> failed(n_threads, 0);

  auto work = [&](int t) {
    ThreadScratch& sc = scratch[t];
    sc.attr_epoch.assign(A, -1);
    sc.attr_node.assign(A, -1);
    sc.attr_rendered.resize(A);
    sc.attr_elem_ids.resize(A);
    int32_t lo = (int32_t)((int64_t)n_docs * t / n_threads);
    int32_t hi = (int32_t)((int64_t)n_docs * (t + 1) / n_threads);
    std::string tmp;
    for (int32_t r = lo; r < hi; ++r) {
      sc.nodes.clear();
      sc.decode.clear();
      const char* dstart = json_blob + doc_offs[r];
      const char* dend = json_blob + doc_offs[r + 1];
      Parser ps{dstart, dend, sc.nodes, sc.decode, json_blob};
      int32_t root = ps.parse_value();
      if (!ps.ok) { failed[t] = 1; return; }
      Doc doc{&sc.nodes, &sc.decode, json_blob};
      int32_t row = config_rows[r];

      // ---- resolve + scatter each attr this config references ----
      for (int32_t ai = p->cfg_attr_offs[row]; ai < p->cfg_attr_offs[row + 1]; ++ai) {
        int32_t attr = p->cfg_attr_idx[ai];
        if (p->attr_complex[attr]) continue;  // finished in Python
        int32_t node = walk(doc, root, *p, attr);
        sc.attr_epoch[attr] = r;
        sc.attr_node[attr] = node;
        std::string& rendered = sc.attr_rendered[attr];
        rendered.clear();
        render(doc, node, rendered);
        int32_t vid = p->interner.lookup(rendered.data(), rendered.size());
        store_id(attrs_val, (int64_t)r * A + attr, vid, elem16);
        int32_t slot = p->attr_byte_slot[attr];
        if (slot >= 0) {
          if ((int64_t)rendered.size() > DVB ||
              memchr(rendered.data(), 0, rendered.size()) != nullptr) {
            byte_ovf[(int64_t)r * NB + slot] = 1;
          } else if (!rendered.empty()) {
            memcpy(attr_bytes + ((int64_t)r * NB + slot) * DVB, rendered.data(), rendered.size());
          }
        }
        // membership (gjson Array() semantics)
        std::vector<int32_t>& elems = sc.attr_elem_ids[attr];
        elems.clear();
        const Node& n = sc.nodes[node < 0 ? 0 : node];
        if (node >= 0 && n.type == V_ARR) {
          int32_t k = 0;
          for (int32_t c = n.first_child; c >= 0; c = sc.nodes[c].next_sibling, ++k) {
            tmp.clear();
            render(doc, c, tmp);
            int32_t eid = p->interner.lookup(tmp.data(), tmp.size());
            elems.push_back(eid);
            if (k < K) store_id(attrs_members, ((int64_t)r * A + attr) * K + k, eid, elem16);
          }
          if ((int32_t)elems.size() > K) overflow[(int64_t)r * A + attr] = 1;
        } else if (node >= 0 && n.type != V_NULL) {
          store_id(attrs_members, ((int64_t)r * A + attr) * K, vid, elem16);
          elems.push_back(vid);
        }
      }

      // ---- CPU-lane leaves ----
      process_cpu_leaves(p, r, row, sc.attr_epoch, sc.attr_rendered,
                         sc.attr_elem_ids, A, L, NB, byte_ovf, overflow,
                         cpu_lane, sc.tasks);
    }
  };

  if (n_threads == 1) {
    work(0);
  } else {
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  for (int t = 0; t < n_threads; ++t)
    if (failed[t]) return -2;  // parse failure -> caller falls back

  // ---- merge per-thread task lists ----
  std::vector<std::vector<Task>> lists;
  lists.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) lists.push_back(std::move(scratch[t].tasks));
  return merge_tasks(lists.data(), n_threads, task_r, task_leaf, task_val_off,
                     task_val_len, max_tasks, task_arena, arena_cap);
}

}  // extern "C"
