// The port's copy of roaringbitmap_tpu/native/ext.cpp, compiled in one
// translation unit with this directory's kernels.cpp and imported as
// roaringbitmap_tpu_torch.native._rb_ext by native/__init__.py.
//
// CPython extension wrapper over the L0 kernels (kernels.cpp).
//
// The ctypes bindings cost ~4-13 us per call (ndpointer validation +
// argument marshalling + output copies) — more than the kernels themselves
// on container-sized inputs, which is exactly the CPU fast path's regime.
// This module exposes the same entry points through the CPython/numpy C
// API at ~0.2-0.4 us per call. native/__init__.py prefers it when it
// builds, falling back to ctypes, then numpy.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include "kernels.cpp"  // single TU: reuse the extern "C" kernels directly

namespace {

// Borrowed, validated views ------------------------------------------------

static bool as_u16(PyObject* o, const in_u16** p, int32_t* n) {
  PyArrayObject* a = reinterpret_cast<PyArrayObject*>(o);
  if (!PyArray_Check(o) || PyArray_TYPE(a) != NPY_UINT16 ||
      !PyArray_IS_C_CONTIGUOUS(a) || PyArray_NDIM(a) != 1) {
    PyErr_SetString(PyExc_TypeError, "expected C-contiguous 1-D uint16 array");
    return false;
  }
  *p = static_cast<const in_u16*>(PyArray_DATA(a));
  *n = static_cast<int32_t>(PyArray_DIM(a, 0));
  return true;
}

static bool as_u64(PyObject* o, const in_u64** p, int64_t* n) {
  PyArrayObject* a = reinterpret_cast<PyArrayObject*>(o);
  if (!PyArray_Check(o) || PyArray_TYPE(a) != NPY_UINT64 ||
      !PyArray_IS_C_CONTIGUOUS(a) || PyArray_NDIM(a) != 1) {
    PyErr_SetString(PyExc_TypeError, "expected C-contiguous 1-D uint64 array");
    return false;
  }
  *p = static_cast<const in_u64*>(PyArray_DATA(a));
  *n = PyArray_DIM(a, 0);
  return true;
}

static PyObject* new_u16(npy_intp n) {
  return PyArray_SimpleNew(1, &n, NPY_UINT16);
}

// Sorted-set algebra -------------------------------------------------------

typedef int32_t (*setop_fn)(const in_u16*, int32_t, const in_u16*, int32_t,
                            uint16_t*);

// output capacity regimes: intersect <= min(na, nb); union/xor <= na + nb;
// difference (a \ b) <= na
enum CapMode { CAP_MIN = 0, CAP_SUM = 1, CAP_FIRST = 2 };

template <setop_fn FN, CapMode CAP>
static PyObject* setop(PyObject*, PyObject* args) {
  PyObject *ao, *bo;
  if (!PyArg_ParseTuple(args, "OO", &ao, &bo)) return nullptr;
  const uint16_t *a, *b;
  int32_t na, nb;
  if (!as_u16(ao, &a, &na) || !as_u16(bo, &b, &nb)) return nullptr;
  npy_intp cap = CAP == CAP_SUM   ? (npy_intp)na + nb
                 : CAP == CAP_FIRST ? (npy_intp)na
                                    : (npy_intp)(na < nb ? na : nb);
  PyObject* out = new_u16(cap);
  if (!out) return nullptr;
  int32_t n = FN(a, na, b, nb,
                 static_cast<uint16_t*>(PyArray_DATA((PyArrayObject*)out)));
  // shrink in place: resize to the produced length (refcount is 1)
  PyArray_Dims d;
  npy_intp len = n;
  d.ptr = &len;
  d.len = 1;
  PyObject* ok = PyArray_Resize((PyArrayObject*)out, &d, 0, NPY_CORDER);
  if (!ok) {
    Py_DECREF(out);
    return nullptr;
  }
  Py_DECREF(ok);
  return out;
}

static PyObject* intersect_cardinality(PyObject*, PyObject* args) {
  PyObject *ao, *bo;
  if (!PyArg_ParseTuple(args, "OO", &ao, &bo)) return nullptr;
  const uint16_t *a, *b;
  int32_t na, nb;
  if (!as_u16(ao, &a, &na) || !as_u16(bo, &b, &nb)) return nullptr;
  return PyLong_FromLong(rb_intersect_card_u16(a, na, b, nb));
}

static PyObject* advance_until(PyObject*, PyObject* args) {
  PyObject* ao;
  int pos, minv;
  if (!PyArg_ParseTuple(args, "Oii", &ao, &pos, &minv)) return nullptr;
  const in_u16* a;
  int32_t na;
  if (!as_u16(ao, &a, &na)) return nullptr;
  return PyLong_FromLong(rb_advance_until(a, na, pos, (uint16_t)minv));
}

static PyObject* contains_many(PyObject*, PyObject* args) {
  PyObject *so, *qo;
  if (!PyArg_ParseTuple(args, "OO", &so, &qo)) return nullptr;
  const uint16_t *s, *q;
  int32_t ns, nq;
  if (!as_u16(so, &s, &ns) || !as_u16(qo, &q, &nq)) return nullptr;
  npy_intp n = nq;
  PyObject* out = PyArray_SimpleNew(1, &n, NPY_BOOL);
  if (!out) return nullptr;
  rb_contains_many_u16(s, ns, q, nq,
                       static_cast<uint8_t*>(PyArray_DATA((PyArrayObject*)out)));
  return out;
}

// Scalar point-probe fast paths --------------------------------------------
// One C call does the whole membership test (search + compare + boolean),
// so the Python side pays a single frame instead of search-then-numpy-index.
// These exist purely for per-call latency (simplebenchmark contains row;
// Util.java:697 unsignedBinarySearch serves this role in the JVM).

static PyObject* contains_u16(PyObject*, PyObject* args) {
  PyObject* ao;
  int x;
  if (!PyArg_ParseTuple(args, "Oi", &ao, &x)) return nullptr;
  const in_u16* a;
  int32_t na;
  if (!as_u16(ao, &a, &na)) return nullptr;
  int32_t i = rb_advance_until(a, na, -1, (uint16_t)x);
  if (i < na && a[i] == (uint16_t)x) Py_RETURN_TRUE;
  Py_RETURN_FALSE;
}

static PyObject* word_bit(PyObject*, PyObject* args) {
  PyObject* wo;
  int x;
  if (!PyArg_ParseTuple(args, "Oi", &wo, &x)) return nullptr;
  const in_u64* w;
  int64_t nw;
  if (!as_u64(wo, &w, &nw)) return nullptr;
  int64_t idx = (int64_t)((uint32_t)x >> 6);
  if (idx >= nw) {
    PyErr_SetString(PyExc_IndexError, "bit index beyond word array");
    return nullptr;
  }
  if ((w[idx] >> (x & 63)) & 1) Py_RETURN_TRUE;
  Py_RETURN_FALSE;
}

static PyObject* run_contains(PyObject*, PyObject* args) {
  PyObject *so, *lo;
  int x;
  if (!PyArg_ParseTuple(args, "OOi", &so, &lo, &x)) return nullptr;
  const uint16_t *s, *l;
  int32_t ns, nl;
  if (!as_u16(so, &s, &ns) || !as_u16(lo, &l, &nl)) return nullptr;
  if (ns != nl) {
    PyErr_SetString(PyExc_ValueError, "starts/lengths size mismatch");
    return nullptr;
  }
  int32_t i = rb_advance_until(s, ns, -1, (uint16_t)x);  // first start >= x
  if (i < ns && s[i] == (uint16_t)x) Py_RETURN_TRUE;
  if (i == 0) Py_RETURN_FALSE;
  if ((uint16_t)x - s[i - 1] <= l[i - 1]) Py_RETURN_TRUE;
  Py_RETURN_FALSE;
}

// Word-level kernels -------------------------------------------------------

static PyObject* cardinality_of_words(PyObject*, PyObject* args) {
  PyObject* wo;
  if (!PyArg_ParseTuple(args, "O", &wo)) return nullptr;
  const in_u64* w;
  int64_t n;
  if (!as_u64(wo, &w, &n)) return nullptr;
  return PyLong_FromLongLong(rb_popcount_words(w, n));
}

static PyObject* words_from_values(PyObject*, PyObject* args) {
  PyObject* vo;
  int n_words;
  if (!PyArg_ParseTuple(args, "Oi", &vo, &n_words)) return nullptr;
  const in_u16* v;
  int32_t nv;
  if (!as_u16(vo, &v, &nv)) return nullptr;
  npy_intp n = n_words;
  PyObject* out = PyArray_ZEROS(1, &n, NPY_UINT64, 0);
  if (!out) return nullptr;
  rb_words_from_values(v, nv,
                       static_cast<uint64_t*>(PyArray_DATA((PyArrayObject*)out)));
  return out;
}

static PyObject* values_from_words(PyObject*, PyObject* args) {
  PyObject* wo;
  if (!PyArg_ParseTuple(args, "O", &wo)) return nullptr;
  const in_u64* w;
  int64_t n;
  if (!as_u64(wo, &w, &n)) return nullptr;
  npy_intp card = rb_popcount_words(w, n);
  PyObject* out = new_u16(card);
  if (!out) return nullptr;
  rb_values_from_words(w, (int32_t)n,
                       static_cast<uint16_t*>(PyArray_DATA((PyArrayObject*)out)));
  return out;
}

static PyObject* num_runs_in_words(PyObject*, PyObject* args) {
  PyObject* wo;
  if (!PyArg_ParseTuple(args, "O", &wo)) return nullptr;
  const in_u64* w;
  int64_t n;
  if (!as_u64(wo, &w, &n)) return nullptr;
  return PyLong_FromLong(rb_num_runs_words(w, (int32_t)n));
}

static PyObject* select_in_words(PyObject*, PyObject* args) {
  PyObject* wo;
  int j;
  if (!PyArg_ParseTuple(args, "Oi", &wo, &j)) return nullptr;
  const in_u64* w;
  int64_t n;
  if (!as_u64(wo, &w, &n)) return nullptr;
  int32_t r = rb_select_words(w, (int32_t)n, j);
  if (r < 0) {
    PyErr_SetString(PyExc_IndexError, "select out of range");
    return nullptr;
  }
  return PyLong_FromLong(r);
}

static PyObject* cardinality_in_range(PyObject*, PyObject* args) {
  PyObject* wo;
  int start, end;
  if (!PyArg_ParseTuple(args, "Oii", &wo, &start, &end)) return nullptr;
  const in_u64* w;
  int64_t n;
  if (!as_u64(wo, &w, &n)) return nullptr;
  return PyLong_FromLongLong(rb_cardinality_in_range(w, start, end));
}

// Deserialization validators (single pass, no temporaries) ----------------

static PyObject* is_strictly_increasing(PyObject*, PyObject* args) {
  PyObject* vo;
  if (!PyArg_ParseTuple(args, "O", &vo)) return nullptr;
  const in_u16* v;
  int32_t n;
  if (!as_u16(vo, &v, &n)) return nullptr;
  for (int32_t i = 1; i < n; ++i)
    if (v[i] <= v[i - 1]) Py_RETURN_FALSE;
  Py_RETURN_TRUE;
}

static PyObject* runs_valid(PyObject*, PyObject* args) {
  // interleaved (start, length) pairs: sorted, disjoint, non-touching,
  // ends within the 2^16 universe (serialization.py's run checks)
  PyObject* po;
  if (!PyArg_ParseTuple(args, "O", &po)) return nullptr;
  const in_u16* p;
  int32_t n2;
  if (!as_u16(po, &p, &n2)) return nullptr;
  if (n2 % 2) {
    PyErr_SetString(PyExc_ValueError, "odd-length pair array");
    return nullptr;
  }
  int32_t prev_end = -1;
  for (int32_t i = 0; i < n2 / 2; ++i) {
    int32_t s = p[2 * i];
    int32_t e = s + p[2 * i + 1];
    if (s <= prev_end || e > 0xFFFF) Py_RETURN_FALSE;
    prev_end = e;
  }
  Py_RETURN_TRUE;
}

static PyMethodDef Methods[] = {
    {"intersect_sorted", setop<rb_intersect_u16, CAP_MIN>, METH_VARARGS, nullptr},
    {"merge_sorted_unique", setop<rb_union_u16, CAP_SUM>, METH_VARARGS, nullptr},
    {"difference_sorted", setop<rb_difference_u16, CAP_FIRST>, METH_VARARGS, nullptr},
    {"xor_sorted", setop<rb_xor_u16, CAP_SUM>, METH_VARARGS, nullptr},
    {"intersect_cardinality", intersect_cardinality, METH_VARARGS, nullptr},
    {"advance_until", advance_until, METH_VARARGS, nullptr},
    {"contains_many", contains_many, METH_VARARGS, nullptr},
    {"contains_u16", contains_u16, METH_VARARGS, nullptr},
    {"word_bit", word_bit, METH_VARARGS, nullptr},
    {"run_contains", run_contains, METH_VARARGS, nullptr},
    {"cardinality_of_words", cardinality_of_words, METH_VARARGS, nullptr},
    {"words_from_values", words_from_values, METH_VARARGS, nullptr},
    {"values_from_words", values_from_words, METH_VARARGS, nullptr},
    {"num_runs_in_words", num_runs_in_words, METH_VARARGS, nullptr},
    {"select_in_words", select_in_words, METH_VARARGS, nullptr},
    {"cardinality_in_range", cardinality_in_range, METH_VARARGS, nullptr},
    {"is_strictly_increasing", is_strictly_increasing, METH_VARARGS, nullptr},
    {"runs_valid", runs_valid, METH_VARARGS, nullptr},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef Module = {PyModuleDef_HEAD_INIT, "_rb_ext",
                                    "CPython fast path over the L0 kernels",
                                    -1, Methods};

}  // namespace

PyMODINIT_FUNC PyInit__rb_ext(void) {
  import_array();
  return PyModule_Create(&Module);
}
