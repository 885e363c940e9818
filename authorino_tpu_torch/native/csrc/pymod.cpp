// CPython extension front-end for the native batch encoder and the native
// gRPC frontend (frontend.cpp, the fe_* functions).
//
// Adds a direct PyObject-walk encode path: resolves selectors over the
// Authorization-JSON dicts in place (no json.dumps → parse round-trip),
// renders with the same gjson-String semantics, and scatters into the numpy
// buffers.  Holds the GIL (it touches Python objects); the JSON-blob path in
// encoder.cpp stays available for GIL-free multithreaded encoding on
// many-core hosts.  Both share Policy/Interner/render/leaf-pass code — this
// file #includes encoder.cpp as a single translation unit.
//
// Build (one shared object, importable AND ctypes-loadable; native/__init__.py
// does this at first use):
//   g++ -O2 -std=c++17 -shared -fPIC -pthread -I$(python-include) \
//       pymod.cpp -ldl -o _atpuenc_torch.so

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "encoder.cpp"
#include "frontend.cpp"

namespace {

PyObject* g_json_dumps = nullptr;   // json.dumps
PyObject* g_dumps_kwargs = nullptr; // {"separators": (",", ":"), "ensure_ascii": False}

void policy_capsule_free(PyObject* cap) {
  Policy* p = (Policy*)PyCapsule_GetPointer(cap, "atpu.Policy");
  delete p;
}

// render a Python value with compiler/encode.py::_render semantics.
// returns false if a Python error occurred (non-serializable nested value).
bool render_py(PyObject* v, std::string& out) {
  if (v == nullptr || v == Py_None) return true;  // ""
  if (PyUnicode_Check(v)) {
    Py_ssize_t n;
    const char* s = PyUnicode_AsUTF8AndSize(v, &n);
    if (s == nullptr) return false;
    out.append(s, (size_t)n);
    return true;
  }
  if (PyBool_Check(v)) {  // before PyLong: bool subclasses int
    out += (v == Py_True) ? "true" : "false";
    return true;
  }
  if (PyLong_Check(v)) {
    int overflow_flag = 0;
    long long ll = PyLong_AsLongLongAndOverflow(v, &overflow_flag);
    if (!overflow_flag && !(ll == -1 && PyErr_Occurred())) {
      char buf[32];
      auto res = std::to_chars(buf, buf + sizeof buf, ll);
      out.append(buf, res.ptr - buf);
      return true;
    }
    PyErr_Clear();
    PyObject* s = PyObject_Str(v);  // big ints
    if (s == nullptr) return false;
    Py_ssize_t n;
    const char* cs = PyUnicode_AsUTF8AndSize(s, &n);
    if (cs == nullptr) { Py_DECREF(s); return false; }
    out.append(cs, (size_t)n);
    Py_DECREF(s);
    return true;
  }
  if (PyFloat_Check(v)) {
    num_str(PyFloat_AS_DOUBLE(v), out);
    return true;
  }
  // dict/list/other → compact raw JSON via the real json.dumps (exact parity
  // with authjson.selector.to_raw_json by construction)
  PyObject* args = PyTuple_Pack(1, v);
  if (args == nullptr) return false;
  PyObject* s = PyObject_Call(g_json_dumps, args, g_dumps_kwargs);
  Py_DECREF(args);
  if (s == nullptr) return false;
  Py_ssize_t n;
  const char* cs = PyUnicode_AsUTF8AndSize(s, &n);
  if (cs == nullptr) { Py_DECREF(s); return false; }
  out.append(cs, (size_t)n);
  Py_DECREF(s);
  return true;
}

// walk a plain dot-path over Python dicts/lists; returns borrowed ref or
// nullptr for missing.  seg_objs are pre-built PyUnicode keys (hash cached).
PyObject* walk_py(PyObject* doc, const Policy* p, PyObject* seg_objs, int32_t attr) {
  PyObject* cur = doc;
  for (int32_t s = p->attr_seg_offs[attr]; s < p->attr_seg_offs[attr + 1]; ++s) {
    if (cur == nullptr) return nullptr;
    if (PyDict_Check(cur)) {
      cur = PyDict_GetItem(cur, PyTuple_GET_ITEM(seg_objs, s));  // borrowed
    } else if (PyList_Check(cur)) {
      const char* kp = p->strings.data() + p->seg_views[s].first;
      int32_t klen = p->seg_views[s].second;
      const char* q = kp; const char* qe = kp + klen;
      while (q < qe && (*q == ' ' || *q == '\t')) ++q;
      while (qe > q && (qe[-1] == ' ' || qe[-1] == '\t')) --qe;
      bool neg = false;
      if (q < qe && (*q == '+' || *q == '-')) { neg = (*q == '-'); ++q; }
      if (q == qe) return nullptr;
      Py_ssize_t len = PyList_GET_SIZE(cur);
      int64_t idx = 0;
      for (; q < qe; ++q) {
        if (*q < '0' || *q > '9') return nullptr;
        idx = idx * 10 + (*q - '0');
        if (idx > len) break;
      }
      if (neg || idx >= len || q != qe) {
        // re-check: digits ran clean only if q reached qe
        if (q != qe) return nullptr;
        return nullptr;
      }
      cur = PyList_GET_ITEM(cur, (Py_ssize_t)idx);
    } else {
      return nullptr;
    }
  }
  return cur;
}

// encode_docs(policy_capsule, seg_objs, docs, rows_addr, n_docs,
//             A, K, L, NB, DVB,
//             attrs_val, attrs_members, overflow, cpu_lane, attr_bytes, byte_ovf,
//             task_r, task_leaf, task_val_off, task_val_len, max_tasks,
//             arena_addr, arena_cap, elem16)
//             (all *_addr are numpy .ctypes.data ints; elem16: id buffers
//              are int16 when the interner fits — see pack.wire_dtype)
PyObject* encode_docs(PyObject*, PyObject* args) {
  PyObject* cap; PyObject* seg_objs; PyObject* docs;
  unsigned long long rows_a, av_a, am_a, ov_a, cl_a, ab_a, bo_a;
  unsigned long long tr_a, tl_a, to_a, tv_a, arena_a;
  int n_docs, A, K, L, NB, DVB, max_tasks, elem16;
  long long arena_cap;
  if (!PyArg_ParseTuple(
          args, "OOOKiiiiiiKKKKKKKKKKiKLi",
          &cap, &seg_objs, &docs, &rows_a, &n_docs, &A, &K, &L, &NB, &DVB,
          &av_a, &am_a, &ov_a, &cl_a, &ab_a, &bo_a,
          &tr_a, &tl_a, &to_a, &tv_a, &max_tasks, &arena_a, &arena_cap,
          &elem16))
    return nullptr;
  Policy* p = (Policy*)PyCapsule_GetPointer(cap, "atpu.Policy");
  if (p == nullptr) return nullptr;
  const int32_t* rows = (const int32_t*)rows_a;
  void* attrs_val = (void*)av_a;
  void* attrs_members = (void*)am_a;
  uint8_t* overflow = (uint8_t*)ov_a;
  uint8_t* cpu_lane = (uint8_t*)cl_a;
  uint8_t* attr_bytes = (uint8_t*)ab_a;
  uint8_t* byte_ovf = (uint8_t*)bo_a;

  std::vector<int32_t> attr_epoch((size_t)A, -1);
  std::vector<std::string> attr_rendered((size_t)A);
  std::vector<std::vector<int32_t>> attr_elem_ids((size_t)A);
  std::vector<Task> tasks;
  std::string tmp;

  for (int32_t r = 0; r < n_docs; ++r) {
    PyObject* doc = PyList_GET_ITEM(docs, r);
    int32_t row = rows[r];
    for (int32_t ai = p->cfg_attr_offs[row]; ai < p->cfg_attr_offs[row + 1]; ++ai) {
      int32_t attr = p->cfg_attr_idx[ai];
      if (p->attr_complex[attr]) continue;
      PyObject* v = walk_py(doc, p, seg_objs, attr);
      attr_epoch[attr] = r;
      std::string& rendered = attr_rendered[attr];
      rendered.clear();
      if (!render_py(v, rendered)) return nullptr;
      int32_t vid = p->interner.lookup(rendered.data(), rendered.size());
      store_id(attrs_val, (int64_t)r * A + attr, vid, elem16);
      int32_t slot = p->attr_byte_slot[attr];
      if (slot >= 0) {
        if ((int64_t)rendered.size() > DVB ||
            memchr(rendered.data(), 0, rendered.size()) != nullptr) {
          byte_ovf[(int64_t)r * NB + slot] = 1;
        } else if (!rendered.empty()) {
          memcpy(attr_bytes + ((int64_t)r * NB + slot) * DVB, rendered.data(),
                 rendered.size());
        }
      }
      std::vector<int32_t>& elems = attr_elem_ids[attr];
      elems.clear();
      if (v != nullptr && PyList_Check(v)) {
        Py_ssize_t n = PyList_GET_SIZE(v);
        for (Py_ssize_t k = 0; k < n; ++k) {
          tmp.clear();
          if (!render_py(PyList_GET_ITEM(v, k), tmp)) return nullptr;
          int32_t eid = p->interner.lookup(tmp.data(), tmp.size());
          elems.push_back(eid);
          if (k < K) store_id(attrs_members, ((int64_t)r * A + attr) * K + k, eid, elem16);
        }
        if ((int64_t)n > K) overflow[(int64_t)r * A + attr] = 1;
      } else if (v != nullptr && v != Py_None) {
        store_id(attrs_members, ((int64_t)r * A + attr) * K, vid, elem16);
        elems.push_back(vid);
      }
    }
    process_cpu_leaves(p, r, row, attr_epoch, attr_rendered, attr_elem_ids,
                       A, L, NB, byte_ovf, overflow, cpu_lane, tasks);
  }

  int64_t n_tasks = merge_tasks(&tasks, 1, (int32_t*)tr_a, (int32_t*)tl_a,
                                (int64_t*)to_a, (int32_t*)tv_a, max_tasks,
                                (char*)arena_a, arena_cap);
  return PyLong_FromLongLong(n_tasks);
}

// policy_new_py(intern_blob, intern_offs_addr, intern_ids_addr, n_intern,
//               n_attrs, seg_blob, seg_offs_addr, n_segs, attr_seg_offs_addr,
//               attr_complex_addr, attr_byte_slot_addr,
//               n_leaves, leaf_op_addr, leaf_attr_addr, leaf_const_addr,
//               n_configs, cfg_attr_offs_addr, cfg_attr_idx_addr,
//               cfg_cpu_offs_addr, cfg_cpu_idx_addr, members_k, dvb, nb)
PyObject* policy_new_py(PyObject*, PyObject* args) {
  Py_buffer intern_blob, seg_blob;
  unsigned long long io_a, ii_a, so_a, aso_a, ac_a, abs_a;
  unsigned long long lo_a, la_a, lc_a, cao_a, cai_a, cco_a, cci_a;
  int n_intern, n_attrs, n_segs, n_leaves, n_configs, members_k, dvb, nb;
  if (!PyArg_ParseTuple(
          args, "y*KKiiy*KiKKKiKKKiKKKKiii",
          &intern_blob, &io_a, &ii_a, &n_intern,
          &n_attrs, &seg_blob, &so_a, &n_segs, &aso_a, &ac_a, &abs_a,
          &n_leaves, &lo_a, &la_a, &lc_a,
          &n_configs, &cao_a, &cai_a, &cco_a, &cci_a,
          &members_k, &dvb, &nb))
    return nullptr;
  Policy* p = atpu_policy_new(
      (const char*)intern_blob.buf, (const int64_t*)io_a, (const int32_t*)ii_a,
      n_intern, n_attrs, (const char*)seg_blob.buf, (const int64_t*)so_a,
      n_segs, (const int32_t*)aso_a, (const uint8_t*)ac_a, (const int32_t*)abs_a,
      n_leaves, (const int32_t*)lo_a, (const int32_t*)la_a, (const int32_t*)lc_a,
      n_configs, (const int32_t*)cao_a, (const int32_t*)cai_a,
      (const int32_t*)cco_a, (const int32_t*)cci_a, members_k, dvb, nb);
  PyBuffer_Release(&intern_blob);
  PyBuffer_Release(&seg_blob);
  return PyCapsule_New(p, "atpu.Policy", policy_capsule_free);
}

// encode_json_py(policy_capsule, blob, doc_offs_addr, n_docs, rows_addr,
//                A, K, L, NB, DVB, <6 out addrs>, <4 task addrs>, max_tasks,
//                arena_addr, arena_cap, n_threads, elem16)
// GIL released around the C encode (threaded path for many-core hosts).
PyObject* encode_json_py(PyObject*, PyObject* args) {
  PyObject* cap; Py_buffer blob;
  unsigned long long do_a, rows_a, av_a, am_a, ov_a, cl_a, ab_a, bo_a;
  unsigned long long tr_a, tl_a, to_a, tv_a, arena_a;
  int n_docs, A, K, L, NB, DVB, max_tasks, n_threads, elem16;
  long long arena_cap;
  if (!PyArg_ParseTuple(
          args, "Oy*KiKiiiiiKKKKKKKKKKiKLii",
          &cap, &blob, &do_a, &n_docs, &rows_a, &A, &K, &L, &NB, &DVB,
          &av_a, &am_a, &ov_a, &cl_a, &ab_a, &bo_a,
          &tr_a, &tl_a, &to_a, &tv_a, &max_tasks, &arena_a, &arena_cap,
          &n_threads, &elem16))
    return nullptr;
  Policy* p = (Policy*)PyCapsule_GetPointer(cap, "atpu.Policy");
  if (p == nullptr) { PyBuffer_Release(&blob); return nullptr; }
  int64_t rc;
  Py_BEGIN_ALLOW_THREADS
  rc = atpu_encode(p, (const char*)blob.buf, (const int64_t*)do_a, n_docs,
                   (const int32_t*)rows_a, A, K, L, NB, DVB,
                   (void*)av_a, (void*)am_a, (uint8_t*)ov_a,
                   (uint8_t*)cl_a, (uint8_t*)ab_a, (uint8_t*)bo_a,
                   (int32_t*)tr_a, (int32_t*)tl_a, (int64_t*)to_a,
                   (int32_t*)tv_a, max_tasks, (char*)arena_a, arena_cap,
                   n_threads, elem16);
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&blob);
  return PyLong_FromLongLong(rc);
}

// ---------------------------------------------------------------------------
// native gRPC frontend (frontend.cpp)
// ---------------------------------------------------------------------------

static long dict_int(PyObject* d, const char* k, long dflt = 0) {
  PyObject* v = PyDict_GetItemString(d, k);
  return v ? PyLong_AsLong(v) : dflt;
}

static unsigned long long dict_addr(PyObject* d, const char* k) {
  PyObject* v = PyDict_GetItemString(d, k);
  return v ? PyLong_AsUnsignedLongLong(v) : 0;
}

static bool dict_bytes(PyObject* d, const char* k, std::string& out) {
  PyObject* v = PyDict_GetItemString(d, k);
  if (v == nullptr || !PyBytes_Check(v)) return false;
  out.assign(PyBytes_AS_STRING(v), (size_t)PyBytes_GET_SIZE(v));
  return true;
}

// list of bytes → DenySet (a missing key leaves `out` empty)
static bool deny_set(PyObject* lst, fe::DenySet& out) {
  if (lst == nullptr) return true;
  if (!PyList_Check(lst)) {
    PyErr_SetString(PyExc_TypeError, "a deny set must be a list of bytes");
    return false;
  }
  for (Py_ssize_t j = 0; j < PyList_GET_SIZE(lst); ++j) {
    PyObject* b = PyList_GET_ITEM(lst, j);
    if (!PyBytes_Check(b)) {
      PyErr_SetString(PyExc_TypeError, "a deny set must be a list of bytes");
      return false;
    }
    out.emplace_back(PyBytes_AS_STRING(b), (size_t)PyBytes_GET_SIZE(b));
  }
  return true;
}

static bool dict_str(PyObject* d, const char* k, std::string& out) {
  PyObject* v = PyDict_GetItemString(d, k);
  if (v == nullptr || !PyUnicode_Check(v)) return false;
  Py_ssize_t n;
  const char* s = PyUnicode_AsUTF8AndSize(v, &n);
  if (s == nullptr) return false;
  out.assign(s, (size_t)n);
  return true;
}

// plan tuple list (runtime/native_frontend.py plan format) → FastPlan vector
static bool parse_plans(PyObject* plans, std::vector<fe::FastPlan>& out,
                        bool* needs_split) {
  for (Py_ssize_t j = 0; plans != nullptr && j < PyList_GET_SIZE(plans); ++j) {
    PyObject* t = PyList_GET_ITEM(plans, j);
    fe::FastPlan pl;
    pl.attr = (int32_t)PyLong_AsLong(PyTuple_GET_ITEM(t, 0));
    pl.kind = (int)PyLong_AsLong(PyTuple_GET_ITEM(t, 1));
    Py_ssize_t kn;
    const char* ks = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(t, 2), &kn);
    if (ks == nullptr) return false;
    pl.key.assign(ks, (size_t)kn);
    pl.const_vid = (int32_t)PyLong_AsLong(PyTuple_GET_ITEM(t, 3));
    pl.const_missing = PyObject_IsTrue(PyTuple_GET_ITEM(t, 4)) == 1;
    PyObject* mems = PyTuple_GET_ITEM(t, 5);
    for (Py_ssize_t m = 0; m < PyList_GET_SIZE(mems); ++m)
      pl.const_members.push_back((int32_t)PyLong_AsLong(PyList_GET_ITEM(mems, m)));
    PyObject* cb = PyTuple_GET_ITEM(t, 6);
    pl.const_bytes.assign(PyBytes_AS_STRING(cb), (size_t)PyBytes_GET_SIZE(cb));
    pl.const_byte_ovf = PyObject_IsTrue(PyTuple_GET_ITEM(t, 7)) == 1;
    if (needs_split && (pl.kind == fe::K_URL_PATH || pl.kind == fe::K_QUERY))
      *needs_split = true;
    out.push_back(std::move(pl));
  }
  return true;
}

// fe_start(port, bmax, nslots, window_us, slow_cap, health_bytes, any_addr) -> 0
PyObject* fe_start_py(PyObject*, PyObject* args) {
  int port, bmax, nslots, any_addr = 0;
  long window_us, slow_cap;
  Py_buffer health;
  if (!PyArg_ParseTuple(args, "iiilly*|i", &port, &bmax, &nslots, &window_us,
                        &slow_cap, &health, &any_addr))
    return nullptr;
  if (fe::g_srv != nullptr) {
    PyBuffer_Release(&health);
    PyErr_SetString(PyExc_RuntimeError, "frontend already started");
    return nullptr;
  }
  fe::Server* S = new fe::Server();
  S->port = port;
  S->any_addr = any_addr != 0;
  S->bmax = bmax;
  S->nslots = nslots;
  S->window_us = window_us;
  S->slow_cap = (size_t)slow_cap;
  S->health_msg.assign((const char*)health.buf, (size_t)health.len);
  PyBuffer_Release(&health);
  int rc = fe::server_start(S);
  if (rc != 0) {
    delete S;
    return PyLong_FromLong(rc);
  }
  fe::g_srv = S;
  return PyLong_FromLong(0);
}

PyObject* fe_port_py(PyObject*, PyObject*) {
  return PyLong_FromLong(fe::g_srv ? fe::g_srv->bound_port : -1);
}

PyObject* fe_stop_py(PyObject*, PyObject*) {
  fe::Server* S = fe::g_srv;
  if (S != nullptr) {
    Py_BEGIN_ALLOW_THREADS
    fe::server_stop(S);
    Py_END_ALLOW_THREADS
    fe::g_srv = nullptr;
    // leak the Server struct intentionally: Python threads may still be
    // inside fe_wait_* draining the final STOPPED event
  }
  Py_RETURN_NONE;
}

// fe_swap(spec_dict) -> 0; spec described in runtime/native_frontend.py
PyObject* fe_swap_py(PyObject*, PyObject* args) {
  PyObject* d;
  if (!PyArg_ParseTuple(args, "O!", &PyDict_Type, &d)) return nullptr;
  fe::Server* S = fe::g_srv;
  if (S == nullptr) {
    PyErr_SetString(PyExc_RuntimeError, "frontend not started");
    return nullptr;
  }
  auto snap = std::make_shared<fe::Snapshot>();
  snap->id = dict_int(d, "snap_id");
  PyObject* cap = PyDict_GetItemString(d, "policy");
  if (cap != nullptr && cap != Py_None) {
    Policy* p = (Policy*)PyCapsule_GetPointer(cap, "atpu.Policy");
    if (p == nullptr) return nullptr;
    snap->interner = &p->interner;
  }
  snap->A = (int)dict_int(d, "A");
  snap->M = (int)dict_int(d, "M");
  snap->K = (int)dict_int(d, "K");
  snap->C = (int)dict_int(d, "C");
  snap->NB = (int)dict_int(d, "NB");
  snap->DVB = (int)dict_int(d, "DVB");
  snap->elem16 = dict_int(d, "elem16") != 0;
  snap->trace_every = dict_int(d, "trace_every", 0);
  snap->S = (int)dict_int(d, "S", 1);
  if (snap->S < 1) snap->S = 1;
  const long SA = (long)snap->S * snap->A;
  const int32_t* ams = (const int32_t*)dict_addr(d, "attr_member_slot_addr");
  const int32_t* abs_v = (const int32_t*)dict_addr(d, "attr_byte_slot_addr");
  if (SA > 0 && ams != nullptr)
    snap->attr_member_slot.assign(ams, ams + SA);
  if (SA > 0 && abs_v != nullptr)
    snap->attr_byte_slot_v.assign(abs_v, abs_v + SA);
  snap->attr_member_slot.resize(SA, -1);
  snap->attr_byte_slot_v.resize(SA, -1);
  // dfa_R counts TOTAL stacked rows (S*R for sharded corpora); attr_dfas
  // rows arrive globalized by the Python side
  long dfa_R = dict_int(d, "dfa_R");
  snap->dfa_S = (int)dict_int(d, "dfa_S");
  if (dfa_R > 0 && snap->dfa_S > 0) {
    const uint8_t* tr = (const uint8_t*)dict_addr(d, "dfa_trans_addr");
    const uint8_t* ac = (const uint8_t*)dict_addr(d, "dfa_accept_addr");
    snap->dfa_trans.assign(tr, tr + (size_t)dfa_R * snap->dfa_S * 256);
    snap->dfa_accept.assign(ac, ac + (size_t)dfa_R * snap->dfa_S);
  }
  snap->attr_dfas.resize(SA);
  PyObject* adfas = PyDict_GetItemString(d, "attr_dfas");
  if (adfas != nullptr) {
    for (Py_ssize_t a = 0; a < PyList_GET_SIZE(adfas) && a < SA; ++a) {
      PyObject* lst = PyList_GET_ITEM(adfas, a);
      for (Py_ssize_t j = 0; j < PyList_GET_SIZE(lst); ++j) {
        PyObject* t = PyList_GET_ITEM(lst, j);
        snap->attr_dfas[a].push_back(
            {(int32_t)PyLong_AsLong(PyTuple_GET_ITEM(t, 0)),
             (int32_t)PyLong_AsLong(PyTuple_GET_ITEM(t, 1))});
      }
    }
  }
  if (!dict_bytes(d, "invalid", snap->invalid_msg) ||
      !dict_bytes(d, "notfound", snap->notfound_msg) ||
      !dict_bytes(d, "health", snap->health_msg) ||
      !dict_bytes(d, "unavailable", snap->unavailable_msg)) {
    PyErr_SetString(PyExc_ValueError, "swap spec missing response templates");
    return nullptr;
  }
  PyObject* fcs = PyDict_GetItemString(d, "fcs");
  for (Py_ssize_t i = 0; fcs != nullptr && i < PyList_GET_SIZE(fcs); ++i) {
    PyObject* f = PyList_GET_ITEM(fcs, i);
    fe::FastConfig fc;
    fc.row = (int32_t)dict_int(f, "row");
    fc.shard = (int32_t)dict_int(f, "shard", 0);
    fc.has_batch = dict_int(f, "has_batch", 1) != 0;
    fc.hybrid = dict_int(f, "hybrid", 0) != 0;
    dict_bytes(f, "ok", fc.ok_msg);
    if (!deny_set(PyDict_GetItemString(f, "deny"), fc.deny)) return nullptr;
    if (fc.deny.empty()) fc.deny.emplace_back();
    if (!parse_plans(PyDict_GetItemString(f, "plans"), fc.plans, &fc.needs_split))
      return nullptr;
    dict_str(f, "ns", fc.ns);
    dict_str(f, "name", fc.name);
    PyObject* srcs = PyDict_GetItemString(f, "sources");
    for (Py_ssize_t j = 0; srcs != nullptr && j < PyList_GET_SIZE(srcs); ++j) {
      PyObject* sd = PyList_GET_ITEM(srcs, j);
      fe::CredSource src;
      src.cred_kind = (int)dict_int(sd, "cred_kind", 0);
      src.dyn = dict_int(sd, "dyn", 0) != 0;
      dict_str(sd, "cred_key", src.cred_key);
      PyObject* vars = PyDict_GetItemString(sd, "variants");
      for (Py_ssize_t k = 0; vars != nullptr && k < PyList_GET_SIZE(vars); ++k) {
        // (key_bytes, plans, ok_bytes, [deny bytes]) — empty = config
        // default
        PyObject* kv = PyList_GET_ITEM(vars, k);
        PyObject* kb = PyTuple_GET_ITEM(kv, 0);
        PyObject* okb = PyTuple_GET_SIZE(kv) > 2 ? PyTuple_GET_ITEM(kv, 2) : nullptr;
        PyObject* dnb = PyTuple_GET_SIZE(kv) > 3 ? PyTuple_GET_ITEM(kv, 3) : nullptr;
        if (!PyBytes_Check(kb) || (okb != nullptr && !PyBytes_Check(okb))) {
          PyErr_SetString(PyExc_TypeError, "variant key/ok must be bytes");
          return nullptr;
        }
        fe::DenySet dset;
        if (!deny_set(dnb, dset)) return nullptr;
        std::vector<fe::FastPlan> vp;
        if (!parse_plans(PyTuple_GET_ITEM(kv, 1), vp, nullptr)) return nullptr;
        int32_t vid = (int32_t)src.var_plans.size();
        src.var_plans.push_back(std::move(vp));
        int32_t ok_idx = -1;
        if (okb != nullptr && PyBytes_GET_SIZE(okb) > 0) {
          ok_idx = (int32_t)src.var_oks.size();
          src.var_oks.emplace_back(PyBytes_AS_STRING(okb),
                                   (size_t)PyBytes_GET_SIZE(okb));
        }
        int32_t deny_idx = -1;
        if (!dset.empty()) {
          deny_idx = (int32_t)src.var_denies.size();
          src.var_denies.push_back(std::move(dset));
        }
        src.variants[std::string(PyBytes_AS_STRING(kb),
                                 (size_t)PyBytes_GET_SIZE(kb))] = {
            vid, INT64_MAX, ok_idx, deny_idx};
      }
      fc.sources.push_back(std::move(src));
    }
    PyObject* umsgs = PyDict_GetItemString(f, "unauth_msgs");
    for (Py_ssize_t j = 0; umsgs != nullptr && j < PyList_GET_SIZE(umsgs); ++j) {
      PyObject* b = PyList_GET_ITEM(umsgs, j);
      if (!PyBytes_Check(b)) {
        PyErr_SetString(PyExc_TypeError, "unauth template must be bytes");
        return nullptr;
      }
      fc.unauth_msgs.emplace_back(PyBytes_AS_STRING(b),
                                  (size_t)PyBytes_GET_SIZE(b));
    }
    if (!fc.sources.empty()) {
      size_t n_static = 0;
      for (const auto& s : fc.sources) n_static += s.dyn ? 0 : 1;
      if (fc.unauth_msgs.size() != ((size_t)1 << n_static)) {
        PyErr_SetString(PyExc_ValueError,
                        "unauth_msgs must cover every static-extraction mask");
        return nullptr;
      }
    }
    snap->fcs.push_back(std::move(fc));
  }
  snap->fc_counts.reset(new std::atomic<uint64_t>[snap->fcs.size() * 3 + 1]());
  snap->fc_durs.reset(
      new std::atomic<uint64_t>[snap->fcs.size() * fe::DUR_STRIDE + 1]());
  PyObject* hosts = PyDict_GetItemString(d, "hosts");
  for (Py_ssize_t i = 0; hosts != nullptr && i < PyList_GET_SIZE(hosts); ++i) {
    PyObject* t = PyList_GET_ITEM(hosts, i);
    Py_ssize_t hn;
    const char* hs = PyUnicode_AsUTF8AndSize(PyTuple_GET_ITEM(t, 0), &hn);
    if (hs == nullptr) return nullptr;
    snap->host_map[std::string(hs, (size_t)hn)] =
        (int32_t)PyLong_AsLong(PyTuple_GET_ITEM(t, 1));
  }
  PyObject* slots = PyDict_GetItemString(d, "slots");
  for (Py_ssize_t i = 0; slots != nullptr && i < PyList_GET_SIZE(slots); ++i) {
    PyObject* s = PyList_GET_ITEM(slots, i);
    fe::Slot sl;
    sl.attrs_val = (char*)dict_addr(s, "attrs_val");
    sl.members = (char*)dict_addr(s, "members");
    sl.cpu_dense = (uint8_t*)dict_addr(s, "cpu_dense");
    sl.config_id = (int32_t*)dict_addr(s, "config_id");
    sl.shard_of = (int32_t*)dict_addr(s, "shard_of");
    sl.attr_bytes = (uint8_t*)dict_addr(s, "attr_bytes");
    sl.byte_ovf = (uint8_t*)dict_addr(s, "byte_ovf");
    snap->slots.push_back(sl);
    snap->free_slots.push_back((int)i);
  }
  snap->slot_entries.resize(snap->slots.size());
  snap->slot_count.resize(snap->slots.size(), 0);
  snap->slot_flush_ns.resize(snap->slots.size(), 0);

  std::vector<int64_t> retired;
  {
    std::lock_guard<std::mutex> lk(S->mu);
    S->snaps[snap->id] = snap;
    S->cur = snap;
    fe::maybe_retire_locked(S, retired);
  }
  fe::emit_retired(S, retired);
  return PyLong_FromLong(0);
}

// fe_wait_batch(timeout_ms) -> (kind, a, b, c)
PyObject* fe_wait_batch_py(PyObject*, PyObject* args) {
  long timeout_ms;
  if (!PyArg_ParseTuple(args, "l", &timeout_ms)) return nullptr;
  fe::Server* S = fe::g_srv;
  if (S == nullptr) return Py_BuildValue("(iLLL)", (int)fe::EV_STOPPED, 0LL, 0LL, 0LL);
  fe::Event ev = {fe::EV_TIMEOUT, 0, 0, 0};
  Py_BEGIN_ALLOW_THREADS {
    std::unique_lock<std::mutex> lk(S->batch_mu);
    if (S->batch_events.empty())
      S->batch_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                           [&] { return !S->batch_events.empty(); });
    if (!S->batch_events.empty()) {
      ev = S->batch_events.front();
      S->batch_events.pop_front();
    }
  }
  Py_END_ALLOW_THREADS
  return Py_BuildValue("(iLLL)", ev.kind, (long long)ev.a, (long long)ev.b,
                       (long long)ev.c);
}

// fe_take_slow(timeout_ms, max_n) -> list[(req_id, bytes)]
PyObject* fe_take_slow_py(PyObject*, PyObject* args) {
  long timeout_ms;
  int max_n;
  if (!PyArg_ParseTuple(args, "li", &timeout_ms, &max_n)) return nullptr;
  fe::Server* S = fe::g_srv;
  if (S == nullptr) return PyList_New(0);
  std::vector<fe::SlowReq> reqs;
  Py_BEGIN_ALLOW_THREADS {
    std::unique_lock<std::mutex> lk(S->slow_mu);
    if (S->slow_q.empty())
      S->slow_cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                          [&] { return !S->slow_q.empty() || !S->running.load(); });
    while (!S->slow_q.empty() && (int)reqs.size() < max_n) {
      reqs.push_back(std::move(S->slow_q.front()));
      S->slow_q.pop_front();
    }
  }
  Py_END_ALLOW_THREADS
  PyObject* out = PyList_New((Py_ssize_t)reqs.size());
  for (size_t i = 0; i < reqs.size(); ++i) {
    PyObject* b = PyBytes_FromStringAndSize(reqs[i].bytes.data(),
                                            (Py_ssize_t)reqs[i].bytes.size());
    PyList_SET_ITEM(out, (Py_ssize_t)i,
                    Py_BuildValue("(KN)", (unsigned long long)reqs[i].id, b));
  }
  return out;
}

// fe_complete_batch(snap_id, slot, verdict_addr)
PyObject* fe_complete_batch_py(PyObject*, PyObject* args) {
  long long snap_id;
  int slot;
  unsigned long long verdict_a;
  if (!PyArg_ParseTuple(args, "LiK", &snap_id, &slot, &verdict_a)) return nullptr;
  fe::Server* S = fe::g_srv;
  if (S != nullptr) {
    Py_BEGIN_ALLOW_THREADS
    fe::complete_batch(S, snap_id, slot, (const uint8_t*)verdict_a);
    Py_END_ALLOW_THREADS
  }
  Py_RETURN_NONE;
}

// fe_complete_slow(req_id, resp_bytes, grpc_status)
PyObject* fe_complete_slow_py(PyObject*, PyObject* args) {
  unsigned long long req_id;
  Py_buffer resp;
  int grpc_status;
  if (!PyArg_ParseTuple(args, "Ky*i", &req_id, &resp, &grpc_status)) return nullptr;
  fe::Server* S = fe::g_srv;
  if (S != nullptr) {
    // complete_slow contends on the server mutex with the epoll thread —
    // release the GIL so that wait never blocks the Python slow lane
    Py_BEGIN_ALLOW_THREADS
    fe::complete_slow(S, req_id, (const char*)resp.buf, (size_t)resp.len, grpc_status);
    Py_END_ALLOW_THREADS
  }
  PyBuffer_Release(&resp);
  Py_RETURN_NONE;
}

// fe_complete_slow_many([(req_id, resp_bytes, grpc_status), ...]) — batch
// completion: copies the payloads under the GIL, lands them all in two
// lock rounds with the GIL released
PyObject* fe_complete_slow_many_py(PyObject*, PyObject* args) {
  PyObject* lst;
  if (!PyArg_ParseTuple(args, "O!", &PyList_Type, &lst)) return nullptr;
  std::vector<fe::SlowDone> items;
  items.reserve((size_t)PyList_GET_SIZE(lst));
  for (Py_ssize_t i = 0; i < PyList_GET_SIZE(lst); ++i) {
    PyObject* t = PyList_GET_ITEM(lst, i);
    unsigned long long req_id;
    Py_buffer resp;
    int grpc_status;
    if (!PyArg_ParseTuple(t, "Ky*i", &req_id, &resp, &grpc_status))
      return nullptr;
    items.push_back({req_id, std::string((const char*)resp.buf,
                                         (size_t)resp.len), grpc_status});
    PyBuffer_Release(&resp);
  }
  fe::Server* S = fe::g_srv;
  if (S != nullptr && !items.empty()) {
    Py_BEGIN_ALLOW_THREADS
    fe::complete_slow_many(S, items);
    Py_END_ALLOW_THREADS
  }
  Py_RETURN_NONE;
}

// fe_add_variant(snap_id, fc_idx, src_idx, cred_bytes, plans, ok_bytes,
// [deny bytes], exp_ns) -> bool — register a runtime plan variant
// (verified-credential cache entry) for one identity source.  Empty ok
// bytes or deny list = the config's defaults.
PyObject* fe_add_variant_py(PyObject*, PyObject* args) {
  long long snap_id, exp_ns;
  int fc_idx, src_idx;
  Py_buffer cred, okb;
  PyObject *plans, *dnl;
  if (!PyArg_ParseTuple(args, "Liiy*O!y*O!L", &snap_id, &fc_idx, &src_idx,
                        &cred, &PyList_Type, &plans, &okb, &PyList_Type, &dnl,
                        &exp_ns))
    return nullptr;
  fe::Server* S = fe::g_srv;
  std::vector<fe::FastPlan> vp;
  fe::DenySet dns;
  bool parsed = S != nullptr && parse_plans(plans, vp, nullptr) &&
                deny_set(dnl, dns);
  std::string cs((const char*)cred.buf, (size_t)cred.len);
  std::string oks((const char*)okb.buf, (size_t)okb.len);
  PyBuffer_Release(&cred);
  PyBuffer_Release(&okb);
  if (S == nullptr) Py_RETURN_FALSE;
  if (!parsed) return nullptr;
  bool ok;
  Py_BEGIN_ALLOW_THREADS
  ok = fe::add_variant(S, snap_id, fc_idx, src_idx, std::move(cs),
                       std::move(vp), std::move(oks), std::move(dns), exp_ns);
  Py_END_ALLOW_THREADS
  return PyBool_FromLong(ok ? 1 : 0);
}

// fe_drain_fc_counts() -> list[(ns, name, ok, unauth_missing, unauth_invalid)]
// — per-authconfig direct decisions since the last drain (the dispatcher
// folds them into the pipeline's Prometheus series)
PyObject* fe_drain_fc_counts_py(PyObject*, PyObject*) {
  fe::Server* S = fe::g_srv;
  PyObject* out = PyList_New(0);
  if (S == nullptr || out == nullptr) return out;
  std::unordered_map<std::string, std::array<uint64_t, 3>> agg;
  Py_BEGIN_ALLOW_THREADS
  fe::drain_fc_counts(S, agg);
  Py_END_ALLOW_THREADS
  for (auto& kv : agg) {
    size_t sep = kv.first.find('\x1f');
    if (sep == std::string::npos) continue;
    PyObject* t = Py_BuildValue(
        "(s#s#KKK)", kv.first.data(), (Py_ssize_t)sep, kv.first.data() + sep + 1,
        (Py_ssize_t)(kv.first.size() - sep - 1),
        (unsigned long long)kv.second[0], (unsigned long long)kv.second[1],
        (unsigned long long)kv.second[2]);
    if (t == nullptr) { Py_DECREF(out); return nullptr; }
    PyList_Append(out, t);
    Py_DECREF(t);
  }
  return out;
}

// fe_drain_durations() -> list[(ns, name, [15 bucket counts], sum_ns)] —
// per-authconfig request-duration histogram increments since the last
// drain; the dispatcher folds them into
// auth_server_authconfig_duration_seconds (same buckets as prometheus
// defaults, non-cumulative per-le counts)
PyObject* fe_drain_durations_py(PyObject*, PyObject*) {
  fe::Server* S = fe::g_srv;
  PyObject* out = PyList_New(0);
  if (S == nullptr || out == nullptr) return out;
  std::unordered_map<std::string, std::array<uint64_t, fe::DUR_STRIDE>> agg;
  Py_BEGIN_ALLOW_THREADS
  fe::drain_durations(S, agg);
  Py_END_ALLOW_THREADS
  for (auto& kv : agg) {
    size_t sep = kv.first.find('\x1f');
    if (sep == std::string::npos) continue;
    PyObject* buckets = PyList_New(fe::N_DUR_BUCKETS);
    if (buckets == nullptr) { Py_DECREF(out); return nullptr; }
    for (int k = 0; k < fe::N_DUR_BUCKETS; ++k)
      PyList_SET_ITEM(buckets, k, PyLong_FromUnsignedLongLong(kv.second[k]));
    PyObject* t = Py_BuildValue(
        "(s#s#NK)", kv.first.data(), (Py_ssize_t)sep, kv.first.data() + sep + 1,
        (Py_ssize_t)(kv.first.size() - sep - 1), buckets,
        (unsigned long long)kv.second[fe::N_DUR_BUCKETS]);
    if (t == nullptr) { Py_DECREF(out); return nullptr; }
    PyList_Append(out, t);
    Py_DECREF(t);
  }
  return out;
}

// fe_stage_hist() -> {"wait": [...], "exec": [...], "respond": [...],
// "bounds_ns": [...]} — drains (resets) the on-box per-request stage
// histograms: queue-wait (encode→flush), execute (flush→complete),
// respond (complete→HTTP/2 submit)
PyObject* fe_stage_hist_py(PyObject*, PyObject*) {
  fe::Server* S = fe::g_srv;
  PyObject* d = PyDict_New();
  if (S == nullptr || d == nullptr) return d;
  auto dump = [&](const char* key, std::atomic<uint64_t>* arr) {
    PyObject* l = PyList_New(fe::N_STAGE_BUCKETS);
    for (int i = 0; i < fe::N_STAGE_BUCKETS; ++i)
      PyList_SET_ITEM(l, i, PyLong_FromUnsignedLongLong(arr[i].exchange(0)));
    PyDict_SetItemString(d, key, l);
    Py_DECREF(l);
  };
  dump("wait", S->stage_wait);
  dump("exec", S->stage_exec);
  dump("respond", S->stage_respond);
  PyObject* b = PyList_New(fe::N_STAGE_BUCKETS - 1);
  for (int i = 0; i < fe::N_STAGE_BUCKETS - 1; ++i)
    PyList_SET_ITEM(b, i, PyLong_FromLongLong(fe::STAGE_BOUNDS_NS[i]));
  PyDict_SetItemString(d, "bounds_ns", b);
  Py_DECREF(b);
  return d;
}

PyObject* fe_stats_py(PyObject*, PyObject*) {
  fe::Server* S = fe::g_srv;
  PyObject* d = PyDict_New();
  if (S == nullptr) return d;
  auto put = [&](const char* k, uint64_t v) {
    PyObject* o = PyLong_FromUnsignedLongLong(v);
    PyDict_SetItemString(d, k, o);
    Py_DECREF(o);
  };
  put("fast", S->n_fast.load());
  put("slow", S->n_slow.load());
  put("notfound", S->n_notfound.load());
  put("invalid", S->n_invalid.load());
  put("health", S->n_health.load());
  put("allowed", S->n_allowed.load());
  put("denied", S->n_denied.load());
  put("dfa_overflow", S->n_dfa_ovf.load());
  put("slow_shed", S->n_slow_shed.load());
  put("parse_errors", S->n_parse_err.load());
  put("connections", S->n_conns.load());
  put("unauth", S->n_unauth.load());
  put("direct_ok", S->n_direct_ok.load());
  put("dyn_hit", S->n_dyn_hit.load());
  put("dyn_miss", S->n_dyn_miss.load());
  put("dyn_add", S->n_dyn_add.load());
  put("trace_sampled", S->n_trace_sampled.load());
  put("hybrid", S->n_hybrid.load());
  put("unavailable", S->n_unavailable.load());
  put("drain_refused", S->n_drain_refused.load());
  {
    uint64_t batches, filling, done_queued;
    fe::pending_work(S, batches, filling, done_queued);
    put("batches_pending", batches);
    put("filling", filling);
    put("done_queued", done_queued);
  }
  {
    // live backlog gauges (not counters): queued + in-pipeline slow work
    size_t pending, queued;
    {
      std::lock_guard<std::mutex> lk(S->mu);
      pending = S->slow_pending.size();
    }
    {
      std::lock_guard<std::mutex> lk(S->slow_mu);
      queued = S->slow_q.size();
    }
    put("slow_pending", pending);
    put("slow_queued", queued);
  }
  return d;
}


// fe_drain() — begin the graceful drain (see server_drain)
PyObject* fe_drain_py(PyObject*, PyObject*) {
  fe::Server* S = fe::g_srv;
  if (S != nullptr) fe::server_drain(S);
  Py_RETURN_NONE;
}

// fe_nghttp2_path() -> str — the libnghttp2 file the loader opened ("" when
// the library is absent: fe_start then returns -1)
PyObject* fe_nghttp2_path_py(PyObject*, PyObject*) {
  std::string p = ng::path();
  return PyUnicode_FromStringAndSize(p.data(), (Py_ssize_t)p.size());
}

PyMethodDef methods[] = {
    {"policy_new", policy_new_py, METH_VARARGS, "build native policy tables"},
    {"encode_docs", encode_docs, METH_VARARGS, "encode a batch of dict docs"},
    {"encode_json", encode_json_py, METH_VARARGS, "encode a JSON-blob batch"},
    {"fe_start", fe_start_py, METH_VARARGS, "start the native gRPC frontend"},
    {"fe_stop", fe_stop_py, METH_NOARGS, "stop the native gRPC frontend"},
    {"fe_port", fe_port_py, METH_NOARGS, "bound port of the frontend"},
    {"fe_swap", fe_swap_py, METH_VARARGS, "swap the frontend snapshot"},
    {"fe_wait_batch", fe_wait_batch_py, METH_VARARGS, "wait for a batch event"},
    {"fe_take_slow", fe_take_slow_py, METH_VARARGS, "take queued slow-lane requests"},
    {"fe_complete_batch", fe_complete_batch_py, METH_VARARGS, "complete a batch"},
    {"fe_complete_slow", fe_complete_slow_py, METH_VARARGS, "complete a slow request"},
    {"fe_complete_slow_many", fe_complete_slow_many_py, METH_VARARGS,
     "complete a batch of slow requests"},
    {"fe_add_variant", fe_add_variant_py, METH_VARARGS,
     "register a runtime credential plan variant"},
    {"fe_stats", fe_stats_py, METH_NOARGS, "frontend counters"},
    {"fe_drain_fc_counts", fe_drain_fc_counts_py, METH_NOARGS,
     "drain per-authconfig direct-decision counters"},
    {"fe_drain_durations", fe_drain_durations_py, METH_NOARGS,
     "drain per-authconfig duration histograms"},
    {"fe_stage_hist", fe_stage_hist_py, METH_NOARGS,
     "drain the on-box per-request stage histograms"},
    {"fe_drain", fe_drain_py, METH_NOARGS,
     "refuse new Check() streams and flush the filling batch"},
    {"fe_nghttp2_path", fe_nghttp2_path_py, METH_NOARGS,
     "the libnghttp2 file the frontend loads"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_atpuenc_torch",
                      "native batch encoder", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__atpuenc_torch(void) {
  PyObject* json_mod = PyImport_ImportModule("json");
  if (json_mod == nullptr) return nullptr;
  g_json_dumps = PyObject_GetAttrString(json_mod, "dumps");
  Py_DECREF(json_mod);
  if (g_json_dumps == nullptr) return nullptr;
  g_dumps_kwargs = Py_BuildValue("{s:(s,s),s:O}", "separators", ",", ":",
                                 "ensure_ascii", Py_False);
  if (g_dumps_kwargs == nullptr) return nullptr;
  return PyModule_Create(&module);
}
