// CPython extension front-end for the native batch encoder.
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
//       pymod.cpp -o _atpuenc_torch.so

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include "encoder.cpp"

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

PyMethodDef methods[] = {
    {"policy_new", policy_new_py, METH_VARARGS, "build native policy tables"},
    {"encode_docs", encode_docs, METH_VARARGS, "encode a batch of dict docs"},
    {"encode_json", encode_json_py, METH_VARARGS, "encode a JSON-blob batch"},
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
