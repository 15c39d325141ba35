// _tbt_core_torch: the PyTorch port's copy of csrc/pymodule.cc. It differs
// from csrc/ only where the copy is tied to its package (each such line is
// marked "port:"): the module and type names, and the Python modules it
// imports. Built at first use by runtime/native_build.py.
//
// _tbt_core: CPython bindings for the native runtime (reference components
// N2/N9, /root/reference/nest/nest/nest_pybind.cc + src/cc/libtorchbeast.cc
// — written against the raw CPython/numpy C API since pybind11 is not in
// this image).
//
// Exposes BatchingQueue, DynamicBatcher (+Batch), ActorPool. Conversions:
//   python -> C++: dict/list/tuple -> Nest, numpy array -> Array wrapping
//     the numpy buffer zero-copy (a shared_ptr owner decrefs under the GIL)
//   C++ -> python: Array -> numpy array wrapping the C++ buffer zero-copy
//     (a capsule owner keeps the shared_ptr alive)
// All blocking calls release the GIL, so C++ actor threads and Python
// inference/learner threads interleave freely.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>
#include <numpy/arrayscalars.h>

#include <memory>
#include <string>
#include <vector>

#include "actor_pool.h"
#include "env_server.h"
#include "queues.h"
#include "routing.h"
#include "shm.h"

namespace {

using tbt::Array;
using tbt::ArrayNest;
using tbt::DType;

PyObject* ClosedBatchingQueueError;
PyObject* AsyncErrorError;
PyObject* ShedErrorError;

// ---------------------------------------------------------------- dtypes
// bfloat16 (wire code 12, csrc/array.h kBF16) is a numpy USER dtype
// registered by ml_dtypes (a jax dependency), so its type number is
// dynamic — resolved once, under the GIL. -1 = ml_dtypes unavailable:
// converting a bf16 array then fails loudly instead of mislabeling it.
int bf16_typenum = -1;
bool bf16_resolved = false;

int resolve_bf16_typenum() {
  if (bf16_resolved) return bf16_typenum;
  bf16_resolved = true;
  PyObject* mod = PyImport_ImportModule("ml_dtypes");
  if (!mod) {
    PyErr_Clear();
    return bf16_typenum;
  }
  PyObject* bf = PyObject_GetAttrString(mod, "bfloat16");
  Py_DECREF(mod);
  if (!bf) {
    PyErr_Clear();
    return bf16_typenum;
  }
  PyArray_Descr* descr = nullptr;
  if (PyArray_DescrConverter(bf, &descr) && descr) {
    bf16_typenum = descr->type_num;
    Py_DECREF(descr);
  } else {
    PyErr_Clear();
  }
  Py_DECREF(bf);
  return bf16_typenum;
}

int dtype_to_npy(DType d) {
  switch (d) {
    case DType::kU8: return NPY_UINT8;
    case DType::kI8: return NPY_INT8;
    case DType::kI32: return NPY_INT32;
    case DType::kI64: return NPY_INT64;
    case DType::kF32: return NPY_FLOAT32;
    case DType::kF64: return NPY_FLOAT64;
    case DType::kBool: return NPY_BOOL;
    case DType::kU16: return NPY_UINT16;
    case DType::kI16: return NPY_INT16;
    case DType::kU32: return NPY_UINT32;
    case DType::kU64: return NPY_UINT64;
    case DType::kF16: return NPY_FLOAT16;
    case DType::kBF16: return resolve_bf16_typenum();
  }
  return -1;
}

bool npy_to_dtype(int npy, DType* out) {
  switch (npy) {
    case NPY_UINT8: *out = DType::kU8; return true;
    case NPY_INT8: *out = DType::kI8; return true;
    case NPY_INT32: *out = DType::kI32; return true;
    case NPY_INT64: *out = DType::kI64; return true;
    case NPY_FLOAT32: *out = DType::kF32; return true;
    case NPY_FLOAT64: *out = DType::kF64; return true;
    case NPY_BOOL: *out = DType::kBool; return true;
    case NPY_UINT16: *out = DType::kU16; return true;
    case NPY_INT16: *out = DType::kI16; return true;
    case NPY_UINT32: *out = DType::kU32; return true;
    case NPY_UINT64: *out = DType::kU64; return true;
    case NPY_FLOAT16: *out = DType::kF16; return true;
    default:
      if (npy >= 0 && npy == resolve_bf16_typenum()) {
        *out = DType::kBF16;
        return true;
      }
      return false;
  }
}

// ------------------------------------------------- python -> C++ nest
// Decref-under-GIL owner for buffers borrowed from numpy.
std::shared_ptr<void> py_owner(PyObject* obj) {
  Py_INCREF(obj);
  return std::shared_ptr<void>(obj, [](void* p) {
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_DECREF(static_cast<PyObject*>(p));
    PyGILState_Release(gil);
  });
}

bool nest_from_py(PyObject* obj, ArrayNest* out) {
  if (PyDict_Check(obj)) {
    ArrayNest::Dict dict;
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(obj, &pos, &key, &value)) {
      if (!PyUnicode_Check(key)) {
        PyErr_SetString(PyExc_TypeError, "nest dict keys must be str");
        return false;
      }
      ArrayNest sub;
      if (!nest_from_py(value, &sub)) return false;
      dict.emplace(PyUnicode_AsUTF8(key), std::move(sub));
    }
    *out = ArrayNest(std::move(dict));
    return true;
  }
  if (PyList_Check(obj) || PyTuple_Check(obj)) {
    PyObject* seq = PySequence_Fast(obj, "expected sequence");
    if (!seq) return false;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    ArrayNest::List list;
    list.reserve(n);
    for (Py_ssize_t i = 0; i < n; ++i) {
      ArrayNest sub;
      if (!nest_from_py(PySequence_Fast_GET_ITEM(seq, i), &sub)) {
        Py_DECREF(seq);
        return false;
      }
      list.push_back(std::move(sub));
    }
    Py_DECREF(seq);
    *out = ArrayNest(std::move(list));
    return true;
  }
  // Leaf: coerce to a C-contiguous numpy array, zero-copy when possible.
  PyArrayObject* arr = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OF(obj, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
  if (!arr) return false;
  DType dtype;
  if (!npy_to_dtype(PyArray_TYPE(arr), &dtype)) {
    PyErr_Format(PyExc_TypeError, "unsupported array dtype %d",
                 PyArray_TYPE(arr));
    Py_DECREF(arr);
    return false;
  }
  std::vector<int64_t> shape(PyArray_NDIM(arr));
  for (int i = 0; i < PyArray_NDIM(arr); ++i) shape[i] = PyArray_DIM(arr, i);
  *out = ArrayNest(Array(dtype, std::move(shape), PyArray_DATA(arr),
                         py_owner(reinterpret_cast<PyObject*>(arr))));
  Py_DECREF(arr);
  return true;
}

// ------------------------------------------------- C++ -> python nest
PyObject* array_to_py(const Array& a) {
  std::vector<npy_intp> dims(a.shape().begin(), a.shape().end());
  // The capsule keeps a heap-allocated Array (sharing the buffer) alive.
  Array* keeper = new Array(a);
  PyObject* capsule = PyCapsule_New(
      keeper, nullptr,
      [](PyObject* cap) {
        delete static_cast<Array*>(PyCapsule_GetPointer(cap, nullptr));
      });
  if (!capsule) {
    delete keeper;
    return nullptr;
  }
  PyObject* arr = PyArray_SimpleNewFromData(
      static_cast<int>(dims.size()), dims.data(), dtype_to_npy(a.dtype()),
      const_cast<uint8_t*>(keeper->data()));
  if (!arr) {
    Py_DECREF(capsule);
    return nullptr;
  }
  if (PyArray_SetBaseObject(reinterpret_cast<PyArrayObject*>(arr), capsule) <
      0) {
    Py_DECREF(arr);
    return nullptr;
  }
  return arr;
}

PyObject* nest_to_py(const ArrayNest& nest) {
  if (nest.is_leaf()) return array_to_py(nest.leaf());
  if (nest.is_list()) {
    PyObject* tuple = PyTuple_New(nest.list().size());
    if (!tuple) return nullptr;
    for (size_t i = 0; i < nest.list().size(); ++i) {
      PyObject* item = nest_to_py(nest.list()[i]);
      if (!item) {
        Py_DECREF(tuple);
        return nullptr;
      }
      PyTuple_SET_ITEM(tuple, i, item);
    }
    return tuple;
  }
  PyObject* dict = PyDict_New();
  if (!dict) return nullptr;
  for (const auto& [key, sub] : nest.dict()) {
    PyObject* item = nest_to_py(sub);
    if (!item || PyDict_SetItemString(dict, key.c_str(), item) < 0) {
      Py_XDECREF(item);
      Py_DECREF(dict);
      return nullptr;
    }
    Py_DECREF(item);
  }
  return dict;
}

void set_py_error();

// ------------------------------------------------- telemetry snapshots
// HistSnapshot -> {"count", "total", "total_sq", "min", "max",
// "buckets": {index: count}} — the shape runtime/native.py's fold feeds
// into telemetry.metrics.Histogram.observe_aggregate (same log-bucket
// geometry; csrc/queues.h telemetry_bucket_index).
PyObject* hist_to_py(const tbt::HistSnapshot& h) {
  PyObject* buckets = PyDict_New();
  if (!buckets) return nullptr;
  for (const auto& [index, count] : h.buckets) {
    PyObject* key = PyLong_FromLong(index);
    PyObject* value = PyLong_FromLongLong(count);
    if (!key || !value || PyDict_SetItem(buckets, key, value) < 0) {
      Py_XDECREF(key);
      Py_XDECREF(value);
      Py_DECREF(buckets);
      return nullptr;
    }
    Py_DECREF(key);
    Py_DECREF(value);
  }
  return Py_BuildValue("{s:L,s:d,s:d,s:d,s:d,s:N}", "count", h.count,
                       "total", h.total, "total_sq", h.total_sq, "min",
                       h.min, "max", h.max, "buckets", buckets);
}

// ------------------------------------------------- wire value <-> python
// Full-fidelity converters between Python values and wire::ValueNest —
// scalars stay scalars (unlike the ArrayNest converters, which coerce
// everything to arrays). Powers the _tbt_core.wire_encode/wire_decode
// cross-language codec pins (tests/test_native.py) and the handshake-free
// bench helpers.
bool py_to_value(PyObject* obj, tbt::wire::ValueNest* out) {
  namespace wire = tbt::wire;
  // Ordering matches wire.py _encode_value: None, bool BEFORE int,
  // int, float, str, ndarray, list/tuple, dict.
  if (obj == Py_None) {
    *out = wire::ValueNest(wire::Value{});
    return true;
  }
  if (PyBool_Check(obj) || PyArray_IsScalar(obj, Bool)) {
    wire::Value v;
    v.kind = wire::Value::Kind::kBool;
    v.b = PyObject_IsTrue(obj) == 1;
    *out = wire::ValueNest(std::move(v));
    return true;
  }
  if ((PyLong_Check(obj) || PyArray_IsScalar(obj, Integer)) &&
      !PyArray_Check(obj)) {
    long long x = PyLong_Check(obj) ? PyLong_AsLongLong(obj) : 0;
    if (!PyLong_Check(obj)) {
      PyObject* as_int = PyNumber_Long(obj);
      if (!as_int) return false;
      x = PyLong_AsLongLong(as_int);
      Py_DECREF(as_int);
    }
    if (PyErr_Occurred()) return false;
    *out = wire::ValueNest(wire::Value::of_int(x));
    return true;
  }
  if (PyFloat_Check(obj) || PyArray_IsScalar(obj, Floating)) {
    double x = PyFloat_Check(obj) ? PyFloat_AsDouble(obj) : 0.0;
    if (!PyFloat_Check(obj)) {
      PyObject* as_float = PyNumber_Float(obj);
      if (!as_float) return false;
      x = PyFloat_AsDouble(as_float);
      Py_DECREF(as_float);
    }
    if (PyErr_Occurred()) return false;
    wire::Value v;
    v.kind = wire::Value::Kind::kFloat;
    v.f = x;
    *out = wire::ValueNest(std::move(v));
    return true;
  }
  if (PyUnicode_Check(obj)) {
    const char* s = PyUnicode_AsUTF8(obj);
    if (!s) return false;
    *out = wire::ValueNest(wire::Value::of_string(s));
    return true;
  }
  if (PyArray_Check(obj)) {
    PyArrayObject* arr = reinterpret_cast<PyArrayObject*>(
        PyArray_FROM_OF(obj, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
    if (!arr) return false;
    DType dtype;
    if (!npy_to_dtype(PyArray_TYPE(arr), &dtype)) {
      PyErr_Format(PyExc_TypeError, "unsupported array dtype %d",
                   PyArray_TYPE(arr));
      Py_DECREF(arr);
      return false;
    }
    std::vector<int64_t> shape(PyArray_NDIM(arr));
    for (int i = 0; i < PyArray_NDIM(arr); ++i)
      shape[i] = PyArray_DIM(arr, i);
    // Deep copy: wire values may outlive the GIL scope.
    Array a(dtype, std::move(shape));
    std::memcpy(a.mutable_data(), PyArray_DATA(arr), a.nbytes());
    Py_DECREF(arr);
    *out = wire::ValueNest(wire::Value::of(std::move(a)));
    return true;
  }
  if (PyList_Check(obj) || PyTuple_Check(obj)) {
    PyObject* seq = PySequence_Fast(obj, "expected sequence");
    if (!seq) return false;
    wire::ValueNest::List list;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    list.reserve(n);
    for (Py_ssize_t i = 0; i < n; ++i) {
      wire::ValueNest sub;
      if (!py_to_value(PySequence_Fast_GET_ITEM(seq, i), &sub)) {
        Py_DECREF(seq);
        return false;
      }
      list.push_back(std::move(sub));
    }
    Py_DECREF(seq);
    *out = wire::ValueNest(std::move(list));
    return true;
  }
  if (PyDict_Check(obj)) {
    wire::ValueNest::Dict dict;
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(obj, &pos, &key, &value)) {
      PyObject* key_str = PyObject_Str(key);
      if (!key_str) return false;
      wire::ValueNest sub;
      if (!py_to_value(value, &sub)) {
        Py_DECREF(key_str);
        return false;
      }
      const char* key_utf8 = PyUnicode_AsUTF8(key_str);
      if (!key_utf8) {  // e.g. lone surrogates: raises, returns NULL
        Py_DECREF(key_str);
        return false;
      }
      dict.emplace(key_utf8, std::move(sub));
      Py_DECREF(key_str);
    }
    *out = wire::ValueNest(std::move(dict));
    return true;
  }
  PyErr_Format(PyExc_TypeError, "cannot serialize %s to the wire",
               Py_TYPE(obj)->tp_name);
  return false;
}

PyObject* array_to_py(const Array& a);

PyObject* value_to_py(const tbt::wire::ValueNest& nest) {
  namespace wire = tbt::wire;
  if (nest.is_leaf()) {
    const wire::Value& v = nest.leaf();
    switch (v.kind) {
      case wire::Value::Kind::kNone:
        Py_RETURN_NONE;
      case wire::Value::Kind::kBool:
        return PyBool_FromLong(v.b);
      case wire::Value::Kind::kInt:
        return PyLong_FromLongLong(v.i);
      case wire::Value::Kind::kFloat:
        return PyFloat_FromDouble(v.f);
      case wire::Value::Kind::kString:
        return PyUnicode_FromStringAndSize(v.s.data(), v.s.size());
      case wire::Value::Kind::kArray:
        return array_to_py(v.array);
    }
    PyErr_SetString(PyExc_RuntimeError, "bad wire value kind");
    return nullptr;
  }
  if (nest.is_list()) {
    // Lists, matching wire.py decode (nest_to_py uses tuples).
    PyObject* list = PyList_New(nest.list().size());
    if (!list) return nullptr;
    for (size_t i = 0; i < nest.list().size(); ++i) {
      PyObject* item = value_to_py(nest.list()[i]);
      if (!item) {
        Py_DECREF(list);
        return nullptr;
      }
      PyList_SET_ITEM(list, i, item);
    }
    return list;
  }
  PyObject* dict = PyDict_New();
  if (!dict) return nullptr;
  for (const auto& [key, sub] : nest.dict()) {
    PyObject* item = value_to_py(sub);
    if (!item || PyDict_SetItemString(dict, key.c_str(), item) < 0) {
      Py_XDECREF(item);
      Py_DECREF(dict);
      return nullptr;
    }
    Py_DECREF(item);
  }
  return dict;
}

// Run fn with the GIL released, catching C++ exceptions INSIDE the no-GIL
// region (an exception unwinding past Py_END_ALLOW_THREADS would skip the
// GIL re-acquire and corrupt the interpreter). Returns false with the
// Python error set on failure.
template <typename F>
bool call_nogil(F&& fn) {
  std::exception_ptr err;
  Py_BEGIN_ALLOW_THREADS
  try {
    fn();
  } catch (...) {
    err = std::current_exception();
  }
  Py_END_ALLOW_THREADS
  if (err) {
    try {
      std::rethrow_exception(err);
    } catch (...) {
      set_py_error();
    }
    return false;
  }
  return true;
}

// Translate in-flight C++ exceptions to Python exceptions.
void set_py_error() {
  try {
    throw;
  } catch (const tbt::ClosedBatchingQueue& e) {
    PyErr_SetString(ClosedBatchingQueueError, e.what());
  } catch (const tbt::QueueStopped&) {
    PyErr_SetNone(PyExc_StopIteration);
  } catch (const tbt::ShedError& e) {
    // Before AsyncError (its base): the typed shed reply must reach
    // Python as the retryable ShedError, not a generic batch failure.
    PyErr_SetString(ShedErrorError, e.what());
  } catch (const tbt::AsyncError& e) {
    PyErr_SetString(AsyncErrorError, e.what());
  } catch (const std::invalid_argument& e) {
    PyErr_SetString(PyExc_ValueError, e.what());
  } catch (const std::out_of_range& e) {
    PyErr_SetString(PyExc_IndexError, e.what());
  } catch (const std::exception& e) {
    PyErr_SetString(PyExc_RuntimeError, e.what());
  } catch (...) {
    PyErr_SetString(PyExc_RuntimeError, "unknown C++ exception");
  }
}

// ---------------------------------------------------------------- Queue
using LearnerQueue = tbt::ActorPool::LearnerQueue;

struct PyBatchingQueue {
  PyObject_HEAD
  std::shared_ptr<LearnerQueue> queue;
};

struct PyDynamicBatcher {
  PyObject_HEAD
  std::shared_ptr<tbt::DynamicBatcher> batcher;
};

struct PyBatch {
  PyObject_HEAD
  std::unique_ptr<tbt::DynamicBatcher::Batch> batch;
};

struct PyActorPool {
  PyObject_HEAD
  std::shared_ptr<tbt::ActorPool> pool;
};

struct PySliceRouter {
  PyObject_HEAD
  std::shared_ptr<tbt::SliceRouter> router;
};

struct PyReplicaRouter {
  PyObject_HEAD
  std::shared_ptr<tbt::ReplicaRouter> router;
};

extern PyTypeObject PyDynamicBatcherType;
extern PyTypeObject PySliceRouterType;
extern PyTypeObject PyReplicaRouterType;

// Any native InferenceClient the pool (or a router) can serve through:
// a plain batcher, a slice fan-out, or a replica/central pair. Raises
// TypeError (returns nullptr) for anything else.
std::shared_ptr<tbt::InferenceClient> client_from(PyObject* obj,
                                                  const char* param) {
  if (PyObject_TypeCheck(obj, &PyDynamicBatcherType))
    return reinterpret_cast<PyDynamicBatcher*>(obj)->batcher;
  if (PyObject_TypeCheck(obj, &PySliceRouterType))
    return reinterpret_cast<PySliceRouter*>(obj)->router;
  if (PyObject_TypeCheck(obj, &PyReplicaRouterType))
    return reinterpret_cast<PyReplicaRouter*>(obj)->router;
  PyErr_Format(PyExc_TypeError,
               "%s must be a DynamicBatcher, SliceRouter or ReplicaRouter",
               param);
  return nullptr;
}

extern PyTypeObject PyBatchType;

// --- BatchingQueue
int queue_init(PyBatchingQueue* self, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {"batch_dim",      "minimum_batch_size",
                                 "maximum_batch_size", "timeout_ms",
                                 "maximum_queue_size", "check_inputs",
                                 nullptr};
  long long batch_dim = 0, min_bs = 1;
  PyObject *max_bs_obj = Py_None, *timeout_obj = Py_None,
           *max_queue_obj = Py_None;
  int check_inputs = 1;
  if (!PyArg_ParseTupleAndKeywords(
          args, kwargs, "|LLOOOp", const_cast<char**>(kwlist), &batch_dim,
          &min_bs, &max_bs_obj, &timeout_obj, &max_queue_obj, &check_inputs))
    return -1;
  try {
    int64_t max_bs = max_bs_obj == Py_None
                         ? std::numeric_limits<int64_t>::max()
                         : PyLong_AsLongLong(max_bs_obj);
    std::optional<int64_t> timeout_ms, max_queue;
    if (timeout_obj != Py_None)
      timeout_ms = static_cast<int64_t>(PyFloat_AsDouble(timeout_obj));
    if (max_queue_obj != Py_None)
      max_queue = PyLong_AsLongLong(max_queue_obj);
    if (PyErr_Occurred()) return -1;
    self->queue = std::make_shared<LearnerQueue>(
        batch_dim, min_bs, max_bs, timeout_ms, max_queue, check_inputs != 0);
    return 0;
  } catch (...) {
    set_py_error();
    return -1;
  }
}

PyObject* queue_enqueue(PyBatchingQueue* self, PyObject* arg) {
  ArrayNest nest;
  if (!nest_from_py(arg, &nest)) return nullptr;
  auto queue = self->queue;
  if (!call_nogil([&] { queue->enqueue(std::move(nest), 0); }))
    return nullptr;
  Py_RETURN_NONE;
}

PyObject* queue_dequeue_many(PyBatchingQueue* self, PyObject*) {
  std::pair<ArrayNest, std::vector<int>> result;
  auto queue = self->queue;
  if (!call_nogil([&] { result = queue->dequeue_many(); })) return nullptr;
  PyObject* nest = nest_to_py(result.first);
  if (!nest) return nullptr;
  return Py_BuildValue("(Nn)", nest,
                       static_cast<Py_ssize_t>(result.second.size()));
}

// Raw-item intake for the host BatchArena (runtime/queues.py contract):
// one FIFO (inputs, rows) pair, blocking; StopIteration once closed —
// what lets --superstep_k > 1 drain native rollouts straight into the
// preallocated [K, T+1, B, ...] arena columns.
PyObject* queue_dequeue_item(PyBatchingQueue* self, PyObject*) {
  std::pair<ArrayNest, int64_t> result;
  auto queue = self->queue;
  if (!call_nogil([&] { result = queue->dequeue_item(); })) return nullptr;
  PyObject* nest = nest_to_py(result.first);
  if (!nest) return nullptr;
  return Py_BuildValue("(NL)", nest,
                       static_cast<long long>(result.second));
}

PyObject* queue_telemetry(PyBatchingQueue* self, PyObject*) {
  auto queue = self->queue;
  tbt::HistSnapshot wait = queue->dequeue_wait_snapshot(/*reset=*/true);
  tbt::HistSnapshot sizes = queue->batch_size_snapshot(/*reset=*/true);
  PyObject* wait_py = hist_to_py(wait);
  if (!wait_py) return nullptr;
  PyObject* sizes_py = hist_to_py(sizes);
  if (!sizes_py) {
    Py_DECREF(wait_py);
    return nullptr;
  }
  return Py_BuildValue("{s:L,s:L,s:N,s:N}", "items_in",
                       static_cast<long long>(queue->num_enqueued()),
                       "depth", static_cast<long long>(queue->size()),
                       "dequeue_wait_s", wait_py, "batch_size", sizes_py);
}

PyObject* queue_close(PyBatchingQueue* self, PyObject*) {
  try {
    self->queue->close();
  } catch (...) {
    set_py_error();
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* queue_size(PyBatchingQueue* self, PyObject*) {
  return PyLong_FromLongLong(self->queue->size());
}

PyObject* queue_is_closed(PyBatchingQueue* self, PyObject*) {
  return PyBool_FromLong(self->queue->is_closed());
}

PyObject* queue_iter(PyObject* self) {
  Py_INCREF(self);
  return self;
}

PyObject* queue_iternext(PyBatchingQueue* self) {
  std::pair<ArrayNest, std::vector<int>> result;
  auto queue = self->queue;
  if (!call_nogil([&] { result = queue->dequeue_many(); })) return nullptr;
  return nest_to_py(result.first);
}

void queue_dealloc(PyBatchingQueue* self) {
  self->queue.~shared_ptr();
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* queue_new(PyTypeObject* type, PyObject*, PyObject*) {
  PyBatchingQueue* self =
      reinterpret_cast<PyBatchingQueue*>(type->tp_alloc(type, 0));
  if (self) new (&self->queue) std::shared_ptr<LearnerQueue>();
  return reinterpret_cast<PyObject*>(self);
}

PyMethodDef queue_methods[] = {
    {"enqueue", reinterpret_cast<PyCFunction>(queue_enqueue), METH_O, nullptr},
    {"dequeue_many", reinterpret_cast<PyCFunction>(queue_dequeue_many),
     METH_NOARGS, nullptr},
    {"dequeue_item", reinterpret_cast<PyCFunction>(queue_dequeue_item),
     METH_NOARGS, nullptr},
    {"telemetry", reinterpret_cast<PyCFunction>(queue_telemetry),
     METH_NOARGS, nullptr},
    {"close", reinterpret_cast<PyCFunction>(queue_close), METH_NOARGS,
     nullptr},
    {"size", reinterpret_cast<PyCFunction>(queue_size), METH_NOARGS, nullptr},
    {"is_closed", reinterpret_cast<PyCFunction>(queue_is_closed), METH_NOARGS,
     nullptr},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject PyBatchingQueueType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// --- Batch
PyObject* batch_get_inputs(PyBatch* self, PyObject*) {
  if (!self->batch) {
    PyErr_SetString(PyExc_RuntimeError, "Batch already consumed");
    return nullptr;
  }
  return nest_to_py(self->batch->inputs());
}

PyObject* batch_set_outputs(PyBatch* self, PyObject* arg) {
  if (!self->batch) {
    PyErr_SetString(PyExc_RuntimeError, "Batch already consumed");
    return nullptr;
  }
  ArrayNest nest;
  if (!nest_from_py(arg, &nest)) return nullptr;
  try {
    // Deep-copy outputs: promises may outlive the numpy arrays.
    ArrayNest owned = nest.map([](const Array& a) { return a.clone(); });
    self->batch->set_outputs(owned);
  } catch (...) {
    set_py_error();
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* batch_fail(PyBatch* self, PyObject* arg) {
  if (!self->batch) Py_RETURN_NONE;
  const char* message = PyUnicode_Check(arg) ? PyUnicode_AsUTF8(arg)
                                             : "inference failed";
  self->batch->fail(message ? message : "inference failed");
  Py_RETURN_NONE;
}

Py_ssize_t batch_len(PyBatch* self) {
  return self->batch ? static_cast<Py_ssize_t>(self->batch->size()) : 0;
}

void batch_dealloc(PyBatch* self) {
  self->batch.~unique_ptr();
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyMethodDef batch_methods[] = {
    {"get_inputs", reinterpret_cast<PyCFunction>(batch_get_inputs),
     METH_NOARGS, nullptr},
    {"set_outputs", reinterpret_cast<PyCFunction>(batch_set_outputs), METH_O,
     nullptr},
    {"fail", reinterpret_cast<PyCFunction>(batch_fail), METH_O, nullptr},
    {nullptr, nullptr, 0, nullptr}};

PySequenceMethods batch_as_sequence = {
    reinterpret_cast<lenfunc>(batch_len),  // sq_length
};

PyTypeObject PyBatchType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// --- DynamicBatcher
int batcher_init(PyDynamicBatcher* self, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {"batch_dim", "minimum_batch_size",
                                 "maximum_batch_size", "timeout_ms",
                                 "shed_max_queue_depth",
                                 "request_deadline_ms", "slo_target_ms",
                                 "continuous", nullptr};
  long long batch_dim = 1, min_bs = 1;
  PyObject *max_bs_obj = Py_None, *timeout_obj = Py_None;
  PyObject *shed_depth_obj = Py_None, *deadline_obj = Py_None,
           *slo_obj = Py_None;
  int continuous = 0;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "|LLOOOOOp",
                                   const_cast<char**>(kwlist), &batch_dim,
                                   &min_bs, &max_bs_obj, &timeout_obj,
                                   &shed_depth_obj, &deadline_obj, &slo_obj,
                                   &continuous))
    return -1;
  try {
    int64_t max_bs = max_bs_obj == Py_None
                         ? std::numeric_limits<int64_t>::max()
                         : PyLong_AsLongLong(max_bs_obj);
    std::optional<int64_t> timeout_ms;
    if (timeout_obj != Py_None)
      timeout_ms = static_cast<int64_t>(PyFloat_AsDouble(timeout_obj));
    // Admission-gate kwargs (ISSUE 14); None / <= 0 disarm each gate.
    std::optional<int64_t> shed_depth;
    if (shed_depth_obj != Py_None) {
      long long depth = PyLong_AsLongLong(shed_depth_obj);
      if (depth > 0) shed_depth = depth;
    }
    std::optional<double> deadline_ms;
    if (deadline_obj != Py_None) {
      double v = PyFloat_AsDouble(deadline_obj);
      if (v > 0) deadline_ms = v;
    }
    std::optional<double> slo_ms;
    if (slo_obj != Py_None) {
      double v = PyFloat_AsDouble(slo_obj);
      if (v > 0) slo_ms = v;
    }
    if (PyErr_Occurred()) return -1;
    self->batcher = std::make_shared<tbt::DynamicBatcher>(
        batch_dim, min_bs, max_bs, timeout_ms, shed_depth, deadline_ms,
        slo_ms, continuous != 0);
    return 0;
  } catch (...) {
    set_py_error();
    return -1;
  }
}

PyObject* batcher_compute(PyDynamicBatcher* self, PyObject* arg) {
  ArrayNest nest;
  if (!nest_from_py(arg, &nest)) return nullptr;
  ArrayNest result;
  auto batcher = self->batcher;
  if (!call_nogil([&] { result = batcher->compute(std::move(nest)); }))
    return nullptr;
  return nest_to_py(result);
}

PyObject* batcher_iternext(PyDynamicBatcher* self) {
  std::unique_ptr<tbt::DynamicBatcher::Batch> batch;
  auto batcher = self->batcher;
  if (!call_nogil([&] { batch = batcher->get_batch(); })) return nullptr;
  PyBatch* out =
      reinterpret_cast<PyBatch*>(PyBatchType.tp_alloc(&PyBatchType, 0));
  if (!out) return nullptr;
  new (&out->batch)
      std::unique_ptr<tbt::DynamicBatcher::Batch>(std::move(batch));
  return reinterpret_cast<PyObject*>(out);
}

PyObject* batcher_close(PyDynamicBatcher* self, PyObject*) {
  try {
    self->batcher->close();
  } catch (...) {
    set_py_error();
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyObject* batcher_size(PyDynamicBatcher* self, PyObject*) {
  return PyLong_FromLongLong(self->batcher->size());
}

PyObject* batcher_is_closed(PyDynamicBatcher* self, PyObject*) {
  return PyBool_FromLong(self->batcher->is_closed());
}

// Interval snapshot of the per-request stage stamps (enqueue -> batch ->
// reply) — resets the accumulators, so each call returns THIS interval's
// aggregates for the driver's monitor-tick fold (runtime/native.py).
PyObject* batcher_telemetry(PyDynamicBatcher* self, PyObject*) {
  auto telemetry = self->batcher->telemetry();
  tbt::HistSnapshot wait = telemetry->request_wait_s.snapshot(true);
  tbt::HistSnapshot rtt = telemetry->request_rtt_s.snapshot(true);
  tbt::HistSnapshot sizes = telemetry->batch_size.snapshot(true);
  tbt::HistSnapshot delay = telemetry->queue_delay_s.snapshot(true);
  PyObject* wait_py = hist_to_py(wait);
  PyObject* rtt_py = wait_py ? hist_to_py(rtt) : nullptr;
  PyObject* sizes_py = rtt_py ? hist_to_py(sizes) : nullptr;
  PyObject* delay_py = sizes_py ? hist_to_py(delay) : nullptr;
  if (!delay_py) {
    Py_XDECREF(wait_py);
    Py_XDECREF(rtt_py);
    Py_XDECREF(sizes_py);
    return nullptr;
  }
  return Py_BuildValue(
      "{s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:N,s:N,s:N,s:N}", "batches",
      static_cast<long long>(telemetry->batches.load()), "rows",
      static_cast<long long>(telemetry->rows.load()), "admitted",
      static_cast<long long>(telemetry->admitted.load()), "shed",
      static_cast<long long>(telemetry->shed.load()), "expired",
      static_cast<long long>(telemetry->expired.load()), "slo_breaches",
      static_cast<long long>(telemetry->slo_breaches.load()), "rolled",
      static_cast<long long>(telemetry->rolled.load()),
      "request_wait_s", wait_py, "request_rtt_s", rtt_py, "batch_size",
      sizes_py, "queue_delay_s", delay_py);
}

// Drain the sampled (enqueued, batched, replied) stamp triples (ISSUE
// 12): {"now": <steady-clock seconds>, "spans": [(e, b, r), ...]}.
// "now" lets the Python fold rebase the steady-clock stamps onto its
// perf_counter timebase before emitting tracer spans.
PyObject* batcher_trace_spans(PyDynamicBatcher* self, PyObject*) {
  auto telemetry = self->batcher->telemetry();
  std::vector<std::array<double, 3>> spans;
  {
    std::lock_guard<std::mutex> lock(telemetry->trace_mu);
    spans.swap(telemetry->trace_spans);
  }
  double now = std::chrono::duration<double>(
                   std::chrono::steady_clock::now().time_since_epoch())
                   .count();
  PyObject* list = PyList_New(static_cast<Py_ssize_t>(spans.size()));
  if (!list) return nullptr;
  for (size_t i = 0; i < spans.size(); ++i) {
    PyObject* t =
        Py_BuildValue("(ddd)", spans[i][0], spans[i][1], spans[i][2]);
    if (!t) {
      Py_DECREF(list);
      return nullptr;
    }
    PyList_SET_ITEM(list, static_cast<Py_ssize_t>(i), t);
  }
  return Py_BuildValue("{s:d,s:N}", "now", now, "spans", list);
}

void batcher_dealloc(PyDynamicBatcher* self) {
  self->batcher.~shared_ptr();
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* batcher_new(PyTypeObject* type, PyObject*, PyObject*) {
  PyDynamicBatcher* self =
      reinterpret_cast<PyDynamicBatcher*>(type->tp_alloc(type, 0));
  if (self) new (&self->batcher) std::shared_ptr<tbt::DynamicBatcher>();
  return reinterpret_cast<PyObject*>(self);
}

PyMethodDef batcher_methods[] = {
    {"compute", reinterpret_cast<PyCFunction>(batcher_compute), METH_O,
     nullptr},
    {"telemetry", reinterpret_cast<PyCFunction>(batcher_telemetry),
     METH_NOARGS, nullptr},
    {"trace_spans", reinterpret_cast<PyCFunction>(batcher_trace_spans),
     METH_NOARGS, nullptr},
    {"close", reinterpret_cast<PyCFunction>(batcher_close), METH_NOARGS,
     nullptr},
    {"size", reinterpret_cast<PyCFunction>(batcher_size), METH_NOARGS,
     nullptr},
    {"is_closed", reinterpret_cast<PyCFunction>(batcher_is_closed),
     METH_NOARGS, nullptr},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject PyDynamicBatcherType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// --- SliceRouter (ISSUE 16): slot-hash fan-out over per-slice batchers.
// The router only holds shared_ptrs to the slices' C++ objects, so the
// Python batcher wrappers need not outlive it.
int slice_router_init(PySliceRouter* self, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {"slices", nullptr};
  PyObject* slices_obj;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "O",
                                   const_cast<char**>(kwlist), &slices_obj))
    return -1;
  PyObject* seq = PySequence_Fast(slices_obj, "slices must be a sequence");
  if (!seq) return -1;
  std::vector<std::shared_ptr<tbt::InferenceClient>> slices;
  for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); ++i) {
    auto client = client_from(PySequence_Fast_GET_ITEM(seq, i), "slices[i]");
    if (!client) {
      Py_DECREF(seq);
      return -1;
    }
    slices.push_back(std::move(client));
  }
  Py_DECREF(seq);
  try {
    self->router = std::make_shared<tbt::SliceRouter>(std::move(slices));
    return 0;
  } catch (...) {
    set_py_error();
    return -1;
  }
}

PyObject* slice_router_compute(PySliceRouter* self, PyObject* arg) {
  ArrayNest nest;
  if (!nest_from_py(arg, &nest)) return nullptr;
  ArrayNest result;
  auto router = self->router;
  if (!call_nogil([&] { result = router->compute(std::move(nest)); }))
    return nullptr;
  return nest_to_py(result);
}

// Cumulative per-slice routed counts: {"requests": [c0, c1, ...]}. The
// driver folds deltas into "inference.slice.<i>.requests" (the series
// name the Python SliceRouter publishes — pinned by ROUTE-PARITY).
PyObject* slice_router_telemetry(PySliceRouter* self, PyObject*) {
  std::vector<int64_t> counts = self->router->request_counts();
  PyObject* list = PyList_New(static_cast<Py_ssize_t>(counts.size()));
  if (!list) return nullptr;
  for (size_t i = 0; i < counts.size(); ++i) {
    PyObject* n = PyLong_FromLongLong(counts[i]);
    if (!n) {
      Py_DECREF(list);
      return nullptr;
    }
    PyList_SET_ITEM(list, static_cast<Py_ssize_t>(i), n);
  }
  return Py_BuildValue("{s:N}", "requests", list);
}

PyObject* slice_router_n_slices(PySliceRouter* self, PyObject*) {
  return PyLong_FromLongLong(self->router->n_slices());
}

PyObject* slice_router_close(PySliceRouter* self, PyObject*) {
  auto router = self->router;
  if (!call_nogil([&] { router->close(); })) return nullptr;
  Py_RETURN_NONE;
}

PyObject* slice_router_size(PySliceRouter* self, PyObject*) {
  return PyLong_FromLongLong(self->router->size());
}

PyObject* slice_router_is_closed(PySliceRouter* self, PyObject*) {
  return PyBool_FromLong(self->router->is_closed());
}

void slice_router_dealloc(PySliceRouter* self) {
  self->router.~shared_ptr();
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* slice_router_new(PyTypeObject* type, PyObject*, PyObject*) {
  PySliceRouter* self =
      reinterpret_cast<PySliceRouter*>(type->tp_alloc(type, 0));
  if (self) new (&self->router) std::shared_ptr<tbt::SliceRouter>();
  return reinterpret_cast<PyObject*>(self);
}

PyMethodDef slice_router_methods[] = {
    {"compute", reinterpret_cast<PyCFunction>(slice_router_compute), METH_O,
     nullptr},
    {"telemetry", reinterpret_cast<PyCFunction>(slice_router_telemetry),
     METH_NOARGS, nullptr},
    {"n_slices", reinterpret_cast<PyCFunction>(slice_router_n_slices),
     METH_NOARGS, nullptr},
    {"close", reinterpret_cast<PyCFunction>(slice_router_close), METH_NOARGS,
     nullptr},
    {"size", reinterpret_cast<PyCFunction>(slice_router_size), METH_NOARGS,
     nullptr},
    {"is_closed", reinterpret_cast<PyCFunction>(slice_router_is_closed),
     METH_NOARGS, nullptr},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject PySliceRouterType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// --- ReplicaRouter (ISSUE 16): replica-first with central fallback.
// Health is pushed from the Python serving hooks via set_serving() — the
// actor threads never take the GIL to route.
int replica_router_init(PyReplicaRouter* self, PyObject* args,
                        PyObject* kwargs) {
  static const char* kwlist[] = {"central", "replica", nullptr};
  PyObject *central_obj, *replica_obj;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "OO",
                                   const_cast<char**>(kwlist), &central_obj,
                                   &replica_obj))
    return -1;
  auto central = client_from(central_obj, "central");
  if (!central) return -1;
  auto replica = client_from(replica_obj, "replica");
  if (!replica) return -1;
  try {
    self->router = std::make_shared<tbt::ReplicaRouter>(std::move(central),
                                                        std::move(replica));
    return 0;
  } catch (...) {
    set_py_error();
    return -1;
  }
}

PyObject* replica_router_compute(PyReplicaRouter* self, PyObject* arg) {
  ArrayNest nest;
  if (!nest_from_py(arg, &nest)) return nullptr;
  ArrayNest result;
  auto router = self->router;
  if (!call_nogil([&] { result = router->compute(std::move(nest)); }))
    return nullptr;
  return nest_to_py(result);
}

PyObject* replica_router_set_serving(PyReplicaRouter* self, PyObject* arg) {
  int truth = PyObject_IsTrue(arg);
  if (truth < 0) return nullptr;
  self->router->set_serving(truth == 1);
  Py_RETURN_NONE;
}

PyObject* replica_router_serving(PyReplicaRouter* self, PyObject*) {
  return PyBool_FromLong(self->router->serving());
}

PyObject* replica_router_telemetry(PyReplicaRouter* self, PyObject*) {
  return Py_BuildValue(
      "{s:L,s:L}", "replica_requests",
      static_cast<long long>(self->router->replica_requests()),
      "central_requests",
      static_cast<long long>(self->router->central_requests()));
}

PyObject* replica_router_close(PyReplicaRouter* self, PyObject*) {
  auto router = self->router;
  if (!call_nogil([&] { router->close(); })) return nullptr;
  Py_RETURN_NONE;
}

PyObject* replica_router_size(PyReplicaRouter* self, PyObject*) {
  return PyLong_FromLongLong(self->router->size());
}

PyObject* replica_router_is_closed(PyReplicaRouter* self, PyObject*) {
  return PyBool_FromLong(self->router->is_closed());
}

void replica_router_dealloc(PyReplicaRouter* self) {
  self->router.~shared_ptr();
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* replica_router_new(PyTypeObject* type, PyObject*, PyObject*) {
  PyReplicaRouter* self =
      reinterpret_cast<PyReplicaRouter*>(type->tp_alloc(type, 0));
  if (self) new (&self->router) std::shared_ptr<tbt::ReplicaRouter>();
  return reinterpret_cast<PyObject*>(self);
}

PyMethodDef replica_router_methods[] = {
    {"compute", reinterpret_cast<PyCFunction>(replica_router_compute),
     METH_O, nullptr},
    {"set_serving", reinterpret_cast<PyCFunction>(replica_router_set_serving),
     METH_O, nullptr},
    {"serving", reinterpret_cast<PyCFunction>(replica_router_serving),
     METH_NOARGS, nullptr},
    {"telemetry", reinterpret_cast<PyCFunction>(replica_router_telemetry),
     METH_NOARGS, nullptr},
    {"close", reinterpret_cast<PyCFunction>(replica_router_close),
     METH_NOARGS, nullptr},
    {"size", reinterpret_cast<PyCFunction>(replica_router_size), METH_NOARGS,
     nullptr},
    {"is_closed", reinterpret_cast<PyCFunction>(replica_router_is_closed),
     METH_NOARGS, nullptr},
    {nullptr, nullptr, 0, nullptr}};

PyTypeObject PyReplicaRouterType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// --- ActorPool

// Slot hooks (slot framing, ISSUE 9): the C++ loops drive the SAME
// Python DeviceStateTable the Python pool uses, taking the GIL only at
// stream (re)connect (reset) and once per unroll boundary (read_slot) —
// never per step. Conversion borrows the returned numpy buffers
// refcounted (py_owner), so no copy is paid either. Errors cross the
// boundary TYPED (throw_py_error_typed): a StateTablePoisonedError
// becomes tbt::StateTableError so the actor rides its budgeted retry
// path while the supervisor rebuilds, instead of retiring (ISSUE 12).
[[noreturn]] void throw_py_error();
[[noreturn]] void throw_py_error_typed();

tbt::ActorPool::SlotHook make_slot_reset(std::shared_ptr<void> table_ref) {
  return [table_ref](int64_t slot) -> ArrayNest {
    PyGILState_STATE gil = PyGILState_Ensure();
    ArrayNest out;
    try {
      PyObject* table = static_cast<PyObject*>(table_ref.get());
      PyObject* ids = Py_BuildValue("[L]", static_cast<long long>(slot));
      if (!ids) throw_py_error_typed();
      PyObject* r = PyObject_CallMethod(table, "reset", "O", ids);
      Py_DECREF(ids);
      if (!r) throw_py_error_typed();
      Py_DECREF(r);
      PyObject* initial =
          PyObject_GetAttrString(table, "initial_state_host");
      if (!initial) throw_py_error_typed();
      ArrayNest nest;
      bool ok = nest_from_py(initial, &nest);
      Py_DECREF(initial);
      if (!ok) throw_py_error_typed();
      out = std::move(nest);
    } catch (...) {
      PyGILState_Release(gil);
      throw;
    }
    PyGILState_Release(gil);
    return out;
  };
}

tbt::ActorPool::SlotHook make_slot_read(std::shared_ptr<void> table_ref) {
  return [table_ref](int64_t slot) -> ArrayNest {
    PyGILState_STATE gil = PyGILState_Ensure();
    ArrayNest out;
    try {
      PyObject* table = static_cast<PyObject*>(table_ref.get());
      PyObject* piece = PyObject_CallMethod(
          table, "read_slot", "L", static_cast<long long>(slot));
      if (!piece) throw_py_error_typed();
      ArrayNest nest;
      bool ok = nest_from_py(piece, &nest);
      Py_DECREF(piece);
      if (!ok) throw_py_error_typed();
      out = std::move(nest);
    } catch (...) {
      PyGILState_Release(gil);
      throw;
    }
    PyGILState_Release(gil);
    return out;
  };
}

int pool_init(PyActorPool* self, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {
      "unroll_length",     "learner_queue", "inference_batcher",
      "env_server_addresses", "initial_agent_state", "connect_timeout_s",
      "max_reconnects", "state_table", "max_frame_bytes", "fault_hooks",
      "record_policy_lag", nullptr};
  long long unroll_length = 0, max_reconnects = 0;
  PyObject *queue_obj, *batcher_obj, *addresses_obj, *state_obj;
  PyObject* table_obj = Py_None;
  PyObject* max_frame_obj = Py_None;
  double connect_timeout_s = 600;
  int fault_hooks = 0;
  int record_policy_lag = 0;
  // inference_batcher is any native InferenceClient (DynamicBatcher,
  // SliceRouter, ReplicaRouter) — dispatched by client_from below, so
  // the pool serves through whatever topology the driver assembled.
  if (!PyArg_ParseTupleAndKeywords(
          args, kwargs, "LO!OOO|dLOOpp", const_cast<char**>(kwlist),
          &unroll_length, &PyBatchingQueueType, &queue_obj,
          &batcher_obj, &addresses_obj, &state_obj,
          &connect_timeout_s, &max_reconnects, &table_obj, &max_frame_obj,
          &fault_hooks, &record_policy_lag))
    return -1;
  std::shared_ptr<tbt::InferenceClient> batcher =
      client_from(batcher_obj, "inference_batcher");
  if (!batcher) return -1;
  std::vector<std::string> addresses;
  PyObject* seq = PySequence_Fast(addresses_obj, "addresses must be a sequence");
  if (!seq) return -1;
  for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); ++i) {
    PyObject* item = PySequence_Fast_GET_ITEM(seq, i);
    if (!PyUnicode_Check(item)) {
      Py_DECREF(seq);
      PyErr_SetString(PyExc_TypeError, "addresses must be strings");
      return -1;
    }
    addresses.push_back(PyUnicode_AsUTF8(item));
  }
  Py_DECREF(seq);
  size_t max_frame_bytes = tbt::wire::kMaxFrameBytes;
  if (max_frame_obj != Py_None) {
    long long n = PyLong_AsLongLong(max_frame_obj);
    if (PyErr_Occurred()) return -1;
    // Honor any explicit value, like wire._frame_limit: 0 (or negative,
    // clamped to 0 here) rejects every frame, surfacing the
    // misconfiguration instead of silently running with the default.
    max_frame_bytes = n > 0 ? static_cast<size_t>(n) : 0;
  }
  ArrayNest state;
  if (!nest_from_py(state_obj, &state)) return -1;
  try {
    // Deep-copy the state: actor threads use it GIL-free.
    ArrayNest owned = state.map([](const Array& a) { return a.clone(); });
    bool use_slots = table_obj != Py_None;
    tbt::ActorPool::SlotHook slot_reset, slot_read;
    if (use_slots) {
      // Same guard as the Python pool (actor_pool.py): actor i owns
      // slot i, so an undersized table would silently alias slots
      // (jax gather clamps / scatter drops out-of-bounds indices).
      PyObject* num_slots_obj = PyObject_GetAttrString(table_obj, "num_slots");
      if (!num_slots_obj) return -1;
      long long num_slots = PyLong_AsLongLong(num_slots_obj);
      Py_DECREF(num_slots_obj);
      if (PyErr_Occurred()) return -1;
      if (num_slots < static_cast<long long>(addresses.size())) {
        PyErr_Format(PyExc_ValueError,
                     "state table has %lld slots for %zd actors", num_slots,
                     addresses.size());
        return -1;
      }
      // The hooks share one owning reference to the table, dropped
      // (under the GIL) when the pool itself is destroyed.
      std::shared_ptr<void> table_ref = py_owner(table_obj);
      slot_reset = make_slot_reset(table_ref);
      slot_read = make_slot_read(table_ref);
    }
    self->pool = std::make_shared<tbt::ActorPool>(
        unroll_length,
        reinterpret_cast<PyBatchingQueue*>(queue_obj)->queue,
        std::move(batcher),
        std::move(addresses), std::move(owned), connect_timeout_s,
        max_reconnects, use_slots, std::move(slot_reset),
        std::move(slot_read), max_frame_bytes, fault_hooks != 0,
        record_policy_lag != 0);
    return 0;
  } catch (...) {
    set_py_error();
    return -1;
  }
}

PyObject* pool_run(PyActorPool* self, PyObject*) {
  auto pool = self->pool;
  if (!call_nogil([&] { pool->run(); })) return nullptr;
  Py_RETURN_NONE;
}

PyObject* pool_count(PyActorPool* self, PyObject*) {
  return PyLong_FromLongLong(self->pool->count());
}

PyObject* pool_reconnect_count(PyActorPool* self, PyObject*) {
  return PyLong_FromLongLong(self->pool->reconnect_count());
}

PyObject* pool_live_actors(PyActorPool* self, PyObject*) {
  return PyLong_FromLongLong(self->pool->live_actors());
}

// Retired-actor error messages, oldest first — the same `.errors`
// surface the Python pool exposes (strings here: the C++ exceptions
// have no Python identity), read by the driver's health monitor.
PyObject* pool_errors_getter(PyActorPool* self, void*) {
  std::vector<std::string> msgs = self->pool->error_messages();
  PyObject* list = PyList_New(static_cast<Py_ssize_t>(msgs.size()));
  if (!list) return nullptr;
  for (size_t i = 0; i < msgs.size(); ++i) {
    PyObject* s =
        PyUnicode_FromStringAndSize(msgs[i].data(), msgs[i].size());
    if (!s) {
      Py_DECREF(list);
      return nullptr;
    }
    PyList_SET_ITEM(list, static_cast<Py_ssize_t>(i), s);
  }
  return list;
}

// --- chaos entry points (resilience/chaos.py ChaosController, native
// path): each returns True when the fault observably landed, False when
// the target is momentarily un-injectable (the controller retries on a
// later tick, keeping injected counts exact). ValueError when the pool
// was built without fault_hooks=True — a miswired driver should fail
// loudly, not silently abandon every fault.
tbt::FaultHooks* pool_hooks_or_raise(PyActorPool* self) {
  tbt::FaultHooks* hooks = self->pool->fault_hooks();
  if (!hooks)
    PyErr_SetString(PyExc_ValueError,
                    "ActorPool was built without fault_hooks=True");
  return hooks;
}

PyObject* pool_chaos_sever(PyActorPool* self, PyObject* arg) {
  long long actor = PyLong_AsLongLong(arg);
  if (PyErr_Occurred()) return nullptr;
  tbt::FaultHooks* hooks = pool_hooks_or_raise(self);
  if (!hooks) return nullptr;
  bool ok = false;
  if (!call_nogil([&] { ok = hooks->sever(actor); })) return nullptr;
  return PyBool_FromLong(ok);
}

PyObject* pool_chaos_window(PyActorPool* self, PyObject* args,
                            PyObject* kwargs) {
  static const char* kwlist[] = {"actor", "kind", "duration_s", "delay_s",
                                 nullptr};
  long long actor = 0;
  const char* kind = nullptr;
  double duration_s = 1.0, delay_s = 0.05;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "Ls|dd",
                                   const_cast<char**>(kwlist), &actor,
                                   &kind, &duration_s, &delay_s))
    return nullptr;
  bool is_delay;
  if (std::strcmp(kind, "transport_delay") == 0) {
    is_delay = true;
  } else if (std::strcmp(kind, "transport_blackhole") == 0) {
    is_delay = false;
  } else {
    PyErr_Format(PyExc_ValueError, "unknown window kind %s", kind);
    return nullptr;
  }
  tbt::FaultHooks* hooks = pool_hooks_or_raise(self);
  if (!hooks) return nullptr;
  bool ok = false;
  if (!call_nogil(
          [&] { ok = hooks->arm_window(actor, is_delay, duration_s,
                                       delay_s); }))
    return nullptr;
  return PyBool_FromLong(ok);
}

PyObject* pool_chaos_corrupt_ring(PyActorPool* self, PyObject* args,
                                  PyObject* kwargs) {
  static const char* kwlist[] = {"actor", "header", nullptr};
  long long actor = 0;
  int header = 1;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "L|p",
                                   const_cast<char**>(kwlist), &actor,
                                   &header))
    return nullptr;
  tbt::FaultHooks* hooks = pool_hooks_or_raise(self);
  if (!hooks) return nullptr;
  bool ok = false;
  if (!call_nogil(
          [&] { ok = hooks->corrupt_recv_ring(actor, header != 0); }))
    return nullptr;
  return PyBool_FromLong(ok);
}

// Cumulative wire/step counters — the driver folds tick deltas into the
// telemetry registry (runtime/native.py NativeTelemetryFolder).
PyObject* pool_telemetry(PyActorPool* self, PyObject*) {
  tbt::ActorPool::Telemetry t = self->pool->telemetry();
  return Py_BuildValue(
      "{s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L,s:L}", "env_steps",
      static_cast<long long>(t.env_steps), "connects",
      static_cast<long long>(t.connects), "reconnects",
      static_cast<long long>(t.reconnects), "batch_retries",
      static_cast<long long>(t.batch_retries), "shed_resubmits",
      static_cast<long long>(t.shed_resubmits), "bytes_up",
      static_cast<long long>(t.bytes_up), "bytes_down",
      static_cast<long long>(t.bytes_down), "ring_doorbell_waits",
      static_cast<long long>(t.ring_doorbell_waits), "ring_recheck_wakeups",
      static_cast<long long>(t.ring_recheck_wakeups));
}

PyObject* pool_first_error_message(PyActorPool* self, PyObject*) {
  std::string msg = self->pool->first_error_message();
  if (msg.empty()) Py_RETURN_NONE;
  return PyUnicode_FromString(msg.c_str());
}

void pool_dealloc(PyActorPool* self) {
  self->pool.~shared_ptr();
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* pool_new(PyTypeObject* type, PyObject*, PyObject*) {
  PyActorPool* self = reinterpret_cast<PyActorPool*>(type->tp_alloc(type, 0));
  if (self) new (&self->pool) std::shared_ptr<tbt::ActorPool>();
  return reinterpret_cast<PyObject*>(self);
}

PyMethodDef pool_methods[] = {
    {"run", reinterpret_cast<PyCFunction>(pool_run), METH_NOARGS, nullptr},
    {"count", reinterpret_cast<PyCFunction>(pool_count), METH_NOARGS,
     nullptr},
    {"first_error_message",
     reinterpret_cast<PyCFunction>(pool_first_error_message), METH_NOARGS,
     nullptr},
    {"reconnect_count", reinterpret_cast<PyCFunction>(pool_reconnect_count),
     METH_NOARGS, nullptr},
    {"live_actors", reinterpret_cast<PyCFunction>(pool_live_actors),
     METH_NOARGS, nullptr},
    {"chaos_sever", reinterpret_cast<PyCFunction>(pool_chaos_sever),
     METH_O, nullptr},
    {"chaos_window",
     reinterpret_cast<PyCFunction>(
         reinterpret_cast<void (*)()>(pool_chaos_window)),
     METH_VARARGS | METH_KEYWORDS, nullptr},
    {"chaos_corrupt_ring",
     reinterpret_cast<PyCFunction>(
         reinterpret_cast<void (*)()>(pool_chaos_corrupt_ring)),
     METH_VARARGS | METH_KEYWORDS, nullptr},
    {"telemetry", reinterpret_cast<PyCFunction>(pool_telemetry),
     METH_NOARGS, nullptr},
    {nullptr, nullptr, 0, nullptr}};

PyGetSetDef pool_getset[] = {
    {"errors", reinterpret_cast<getter>(pool_errors_getter), nullptr,
     nullptr, nullptr},
    {nullptr, nullptr, nullptr, nullptr, nullptr}};

PyTypeObject PyActorPoolType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// --- EnvServer
// C++ socket/threading mechanics (csrc/env_server.h) + Python hooks that
// take the GIL only around env calls, mirroring the reference's embedding
// of Python envs in a C++ gRPC server (rpcenv.cc:36-156, GIL handling at
// 47/95). Wraps each raw env in the same torchbeast_tpu Environment
// adapter the Python server uses, so episode accounting and auto-reset
// semantics are literally shared code.

namespace wire = tbt::wire;

// RAII GIL for hook bodies running on C++ server threads.
struct GILGuard {
  PyGILState_STATE state;
  GILGuard() : state(PyGILState_Ensure()) {}
  ~GILGuard() { PyGILState_Release(state); }
};

// RAII owned reference: decrefs on every exit path (hook bodies throw
// through C++ exceptions, which would skip manual Py_DECREFs).
struct PyRef {
  PyObject* p;
  explicit PyRef(PyObject* p) : p(p) {}
  ~PyRef() { Py_XDECREF(p); }
  PyRef(const PyRef&) = delete;
  PyRef& operator=(const PyRef&) = delete;
  explicit operator bool() const { return p != nullptr; }
};

// Fetch + clear the pending Python error; returns "Type: message" and
// reports the exception type's name through *type_name.
std::string fetch_py_error(std::string* type_name) {
  PyObject *ptype = nullptr, *pvalue = nullptr, *ptraceback = nullptr;
  PyErr_Fetch(&ptype, &pvalue, &ptraceback);
  std::string msg = "python error";
  if (ptype) {
    PyObject* name = PyObject_GetAttrString(ptype, "__name__");
    if (name && PyUnicode_Check(name)) {
      msg = PyUnicode_AsUTF8(name);
      *type_name = msg;
    }
    Py_XDECREF(name);
  }
  if (pvalue) {
    PyObject* str = PyObject_Str(pvalue);
    if (str && PyUnicode_Check(str)) {
      msg += ": ";
      msg += PyUnicode_AsUTF8(str);
    }
    Py_XDECREF(str);
  }
  Py_XDECREF(ptype);
  Py_XDECREF(pvalue);
  Py_XDECREF(ptraceback);
  PyErr_Clear();
  return msg;
}

// Raise the pending Python error as a C++ exception (the server reports
// it to the client as an error frame).
[[noreturn]] void throw_py_error() {
  std::string type_name;
  throw std::runtime_error(fetch_py_error(&type_name));
}

// Slot-hook variant (ISSUE 12): the DeviceStateTable's typed poison
// error crosses the GIL boundary as tbt::StateTableError so the C++
// actor loop distinguishes "the table is mid-rebuild, retry under
// budget" from a real actor bug (csrc/actor_pool.h guarded_loop).
[[noreturn]] void throw_py_error_typed() {
  std::string type_name;
  std::string msg = fetch_py_error(&type_name);
  if (type_name == "StateTablePoisonedError")
    throw tbt::StateTableError(msg);
  throw std::runtime_error(msg);
}

// Copy a numpy-coercible Python value into an owned wire Array (a deep
// copy: the result outlives the GIL scope, so it must not borrow numpy
// buffers the way nest_from_py does).
Array array_copy_from_py(PyObject* obj) {
  PyArrayObject* arr = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OF(obj, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED));
  if (!arr) throw_py_error();
  DType dtype;
  if (!npy_to_dtype(PyArray_TYPE(arr), &dtype)) {
    int t = PyArray_TYPE(arr);
    Py_DECREF(arr);
    throw std::invalid_argument("unsupported step dtype " +
                                std::to_string(t));
  }
  std::vector<int64_t> shape(PyArray_NDIM(arr));
  for (int i = 0; i < PyArray_NDIM(arr); ++i) shape[i] = PyArray_DIM(arr, i);
  Array out(dtype, std::move(shape));
  std::memcpy(out.mutable_data(), PyArray_DATA(arr), out.nbytes());
  Py_DECREF(arr);
  return out;
}

// Step dict (from Environment.initial()/step()) -> wire message. Adds
// type="step" and, when non-negative, num_actions (the initial Step
// doubles as the env spec, matching runtime/env_server.py).
// Borrows `dict` (caller keeps ownership; safe against throws).
wire::ValueNest step_to_wire(PyObject* dict, int64_t num_actions) {
  if (!PyDict_Check(dict)) {
    throw std::invalid_argument("env step must return a dict");
  }
  wire::ValueNest::Dict out;
  out.emplace("type", wire::ValueNest(wire::Value::of_string("step")));
  if (num_actions >= 0)
    out.emplace("num_actions",
                wire::ValueNest(wire::Value::of_int(num_actions)));
  PyObject *key, *value;
  Py_ssize_t pos = 0;
  while (PyDict_Next(dict, &pos, &key, &value)) {
    if (!PyUnicode_Check(key))
      throw std::invalid_argument("step dict keys must be str");
    out.emplace(PyUnicode_AsUTF8(key),
                wire::ValueNest(wire::Value::of(array_copy_from_py(value))));
  }
  return wire::ValueNest(std::move(out));
}

int64_t action_from_wire(const wire::ValueNest& msg) {
  if (!msg.is_dict()) throw std::invalid_argument("expected action dict");
  const auto& dict = msg.dict();
  auto type_it = dict.find("type");
  if (type_it == dict.end() || !type_it->second.is_leaf() ||
      type_it->second.leaf().kind != wire::Value::Kind::kString ||
      type_it->second.leaf().s != "action")
    throw std::invalid_argument("expected an action message");
  auto it = dict.find("action");
  if (it == dict.end() || !it->second.is_leaf())
    throw std::invalid_argument("action message missing 'action'");
  const wire::Value& v = it->second.leaf();
  if (v.kind == wire::Value::Kind::kInt) return v.i;
  if (v.kind == wire::Value::Kind::kArray) {
    const Array& a = v.array;
    if (a.numel() != 1)
      throw std::invalid_argument("action array must have one element");
    switch (a.dtype()) {
      case DType::kI32:
        return *reinterpret_cast<const int32_t*>(a.data());
      case DType::kI64:
        return *reinterpret_cast<const int64_t*>(a.data());
      default:
        throw std::invalid_argument("action array must be int32/int64");
    }
  }
  throw std::invalid_argument("action must be an int");
}

// Per-stream Python state: the Environment adapter instance.
struct PyStreamState {
  PyObject* env = nullptr;
};

tbt::StreamHooks make_py_hooks(PyObject* env_init) {
  auto state = std::make_shared<PyStreamState>();
  tbt::StreamHooks hooks;
  hooks.initial = [env_init, state]() -> wire::ValueNest {
    GILGuard gil;
    PyObject* raw = PyObject_CallNoArgs(env_init);
    if (!raw) throw_py_error();
    // port: the port's envs, not the JAX package's.
    PyObject* envs_mod = PyImport_ImportModule("torchbeast_tpu_torch.envs");
    if (!envs_mod) {
      Py_DECREF(raw);
      throw_py_error();
    }
    PyObject* na =
        PyObject_CallMethod(envs_mod, "num_actions_of", "O", raw);
    Py_DECREF(envs_mod);
    if (!na) {
      Py_DECREF(raw);
      throw_py_error();
    }
    int64_t num_actions = PyLong_AsLongLong(na);
    Py_DECREF(na);
    // port: the port's Environment adapter, not the JAX package's.
    PyObject* env_mod =
        PyImport_ImportModule("torchbeast_tpu_torch.envs.environment");
    if (!env_mod) {
      Py_DECREF(raw);
      throw_py_error();
    }
    PyObject* env =
        PyObject_CallMethod(env_mod, "Environment", "O", raw);
    Py_DECREF(env_mod);
    Py_DECREF(raw);
    if (!env) throw_py_error();
    state->env = env;
    PyRef step(PyObject_CallMethod(env, "initial", nullptr));
    if (!step) throw_py_error();
    return step_to_wire(step.p, num_actions);
  };
  hooks.step = [state](const wire::ValueNest& msg) -> wire::ValueNest {
    int64_t action = action_from_wire(msg);  // no GIL needed
    GILGuard gil;
    PyRef step(PyObject_CallMethod(
        state->env, "step", "L", static_cast<long long>(action)));
    if (!step) throw_py_error();
    return step_to_wire(step.p, -1);
  };
  hooks.close = [state] {
    if (!state->env) return;
    GILGuard gil;
    PyObject* r = PyObject_CallMethod(state->env, "close", nullptr);
    if (r)
      Py_DECREF(r);
    else
      PyErr_Clear();
    Py_DECREF(state->env);
    state->env = nullptr;
  };
  return hooks;
}

struct PyEnvServer {
  PyObject_HEAD
  std::shared_ptr<tbt::EnvServer> server;
  PyObject* env_init;
};

PyTypeObject PyEnvServerType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

int env_server_init(PyEnvServer* self, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {"env_init", "address", nullptr};
  PyObject* env_init;
  const char* address;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "Os",
                                   const_cast<char**>(kwlist), &env_init,
                                   &address))
    return -1;
  if (!PyCallable_Check(env_init)) {
    PyErr_SetString(PyExc_TypeError, "env_init must be callable");
    return -1;
  }
  Py_INCREF(env_init);
  self->env_init = env_init;
  try {
    self->server = std::make_shared<tbt::EnvServer>(
        address, [env_init] { return make_py_hooks(env_init); });
    return 0;
  } catch (...) {
    set_py_error();
    return -1;
  }
}

PyObject* env_server_run(PyEnvServer* self, PyObject*) {
  auto server = self->server;
  if (!call_nogil([&] { server->run(); })) return nullptr;
  // run() returns after stop(); make sure stream threads are gone before
  // the caller proceeds to tear anything down.
  if (!call_nogil([&] { server->join_all(); })) return nullptr;
  Py_RETURN_NONE;
}

PyObject* env_server_stop(PyEnvServer* self, PyObject*) {
  auto server = self->server;
  if (!call_nogil([&] { server->stop(); })) return nullptr;
  Py_RETURN_NONE;
}

void env_server_dealloc(PyEnvServer* self) {
  // EnvServer's destructor stops and JOINS stream threads, whose hooks
  // take the GIL — joining while holding it would deadlock.
  auto release = [&] { self->server.reset(); };
  if (self->server) call_nogil(release);
  self->server.~shared_ptr();
  Py_XDECREF(self->env_init);
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* env_server_new(PyTypeObject* type, PyObject*, PyObject*) {
  PyEnvServer* self =
      reinterpret_cast<PyEnvServer*>(type->tp_alloc(type, 0));
  if (self) {
    new (&self->server) std::shared_ptr<tbt::EnvServer>();
    self->env_init = nullptr;
  }
  return reinterpret_cast<PyObject*>(self);
}

PyMethodDef env_server_methods[] = {
    {"run", reinterpret_cast<PyCFunction>(env_server_run), METH_NOARGS,
     nullptr},
    {"stop", reinterpret_cast<PyCFunction>(env_server_stop), METH_NOARGS,
     nullptr},
    {nullptr, nullptr, 0, nullptr}};

// ------------------------------------------------- module functions
// Cross-language codec pins: encode/decode through the C++ wire codec,
// full frame bytes (u32 header included). tests/test_native.py asserts
// wire_encode(x) == wire.encode(x) and wire.decode round-trips both
// ways, which pins tags/dtypes/layout in ANGER (beastlint WIRE-PARITY
// pins them textually).
PyObject* py_wire_encode(PyObject*, PyObject* arg) {
  tbt::wire::ValueNest value;
  if (!py_to_value(arg, &value)) return nullptr;
  try {
    std::vector<uint8_t> framed = tbt::wire::encode(value);
    return PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(framed.data()),
        static_cast<Py_ssize_t>(framed.size()));
  } catch (...) {
    set_py_error();
    return nullptr;
  }
}

PyObject* py_wire_decode(PyObject*, PyObject* arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_CONTIG_RO) != 0) return nullptr;
  PyObject* out = nullptr;
  try {
    const uint8_t* data = static_cast<const uint8_t*>(view.buf);
    size_t size = static_cast<size_t>(view.len);
    if (size < 4) throw tbt::wire::WireError("wire: truncated frame");
    uint32_t length = tbt::shm::load_u32le(data);
    if (length != size - 4)
      throw tbt::wire::WireError("wire: frame length mismatch");
    // Deep-copy into an owned buffer so decoded arrays outlive `arg`.
    auto payload = std::make_shared<std::vector<uint8_t>>(
        data + 4, data + size);
    tbt::wire::ValueNest value =
        tbt::wire::decode(payload->data(), payload->size(), payload);
    out = value_to_py(value);
  } catch (...) {
    set_py_error();
  }
  PyBuffer_Release(&view);
  return out;
}

// Native-transport RTT bench (benchmarks/wire_bench.py native rows): the
// C++ client stack end to end — connect (tcp/unix/shm incl. handshake),
// read the initial step, then action-down/step-up round trips for
// `seconds`, entirely GIL-free. Returns (iters, elapsed_s).
PyObject* py_bench_client_rtt(PyObject*, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {"address", "seconds", "warmup", nullptr};
  const char* address;
  double seconds = 1.0;
  long long warmup = 50;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "s|dL",
                                   const_cast<char**>(kwlist), &address,
                                   &seconds, &warmup))
    return nullptr;
  long long iters = 0;
  double elapsed = 0.0;
  bool ok = call_nogil([&] {
    auto t = tbt::shm::connect_transport(address, 30.0);
    t->recv();  // initial step
    tbt::wire::ValueNest::Dict action;
    action.emplace("type",
                   tbt::wire::ValueNest(tbt::wire::Value::of_string("action")));
    action.emplace("action",
                   tbt::wire::ValueNest(tbt::wire::Value::of_int(1)));
    tbt::wire::ValueNest action_msg(std::move(action));
    for (long long i = 0; i < warmup; ++i) {
      t->send(action_msg);
      t->recv();
    }
    auto t0 = std::chrono::steady_clock::now();
    auto deadline = t0 + std::chrono::duration_cast<
                             std::chrono::steady_clock::duration>(
                             std::chrono::duration<double>(seconds));
    while (std::chrono::steady_clock::now() < deadline) {
      t->send(action_msg);
      t->recv();
      ++iters;
    }
    elapsed = std::chrono::duration<double>(
                  std::chrono::steady_clock::now() - t0)
                  .count();
    t->unlink_segments();
    t->close();
  });
  if (!ok) return nullptr;
  return Py_BuildValue("(Ld)", iters, elapsed);
}

// Adaptive-recheck policy simulator (tests/test_native.py): drive the
// C++ AdaptiveRecheck with a sequence of wait outcomes (truthy = ended
// by the recheck timeout) and return the bound (ms) after each record —
// pins the tighten/relax behavior without standing up a live ring.
PyObject* py_adaptive_recheck_sim(PyObject*, PyObject* arg) {
  PyObject* seq = PySequence_Fast(arg, "expected a sequence of outcomes");
  if (!seq) return nullptr;
  tbt::shm::AdaptiveRecheck policy;
  Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
  PyObject* out = PyList_New(n);
  if (!out) {
    Py_DECREF(seq);
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    int truth = PyObject_IsTrue(PySequence_Fast_GET_ITEM(seq, i));
    if (truth < 0) {
      Py_DECREF(seq);
      Py_DECREF(out);
      return nullptr;
    }
    policy.record(truth == 1);
    PyObject* bound = PyLong_FromLong(policy.bound_ms());
    if (!bound) {
      Py_DECREF(seq);
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, i, bound);
  }
  Py_DECREF(seq);
  return out;
}

// Routing-hash pins (ISSUE 16): the C++ splitmix64 finalizer and the
// slot->slice map, exposed so tests/test_native_routing.py can assert
// bit-identity against runtime/placement.py _mix64 in ANGER (beastlint
// ROUTE-PARITY pins the constants textually).
PyObject* py_splitmix64(PyObject*, PyObject* arg) {
  // Mask conversion wraps negatives mod 2^64 — Python's `& (2**64-1)`.
  unsigned long long x = PyLong_AsUnsignedLongLongMask(arg);
  if (PyErr_Occurred()) return nullptr;
  return PyLong_FromUnsignedLongLong(tbt::splitmix64(x));
}

PyObject* py_slice_for_slot(PyObject*, PyObject* args, PyObject* kwargs) {
  static const char* kwlist[] = {"slot", "n_slices", nullptr};
  long long slot = 0, n_slices = 0;
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "LL",
                                   const_cast<char**>(kwlist), &slot,
                                   &n_slices))
    return nullptr;
  try {
    return PyLong_FromLongLong(tbt::slice_for_slot(slot, n_slices));
  } catch (...) {
    set_py_error();
    return nullptr;
  }
}

// ---------------------------------------------------------------- module
PyMethodDef module_functions[] = {
    {"wire_encode", reinterpret_cast<PyCFunction>(py_wire_encode), METH_O,
     nullptr},
    {"wire_decode", reinterpret_cast<PyCFunction>(py_wire_decode), METH_O,
     nullptr},
    {"adaptive_recheck_sim",
     reinterpret_cast<PyCFunction>(py_adaptive_recheck_sim), METH_O,
     nullptr},
    {"bench_client_rtt",
     reinterpret_cast<PyCFunction>(
         reinterpret_cast<void (*)()>(py_bench_client_rtt)),
     METH_VARARGS | METH_KEYWORDS, nullptr},
    {"splitmix64", reinterpret_cast<PyCFunction>(py_splitmix64), METH_O,
     nullptr},
    {"slice_for_slot",
     reinterpret_cast<PyCFunction>(
         reinterpret_cast<void (*)()>(py_slice_for_slot)),
     METH_VARARGS | METH_KEYWORDS, nullptr},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef module_def = {
    // port: the module's own name, so it loads beside csrc/'s _tbt_core.
    PyModuleDef_HEAD_INIT, "_tbt_core_torch",
    "Native runtime core (queues, dynamic batcher, actor pool)", -1,
    module_functions,
};

void init_type(PyTypeObject* type, const char* name, size_t basicsize,
               newfunc tp_new, initproc tp_init, destructor tp_dealloc,
               PyMethodDef* methods, getiterfunc tp_iter,
               iternextfunc tp_iternext, PySequenceMethods* as_seq) {
  type->tp_name = name;
  type->tp_basicsize = static_cast<Py_ssize_t>(basicsize);
  type->tp_flags = Py_TPFLAGS_DEFAULT;
  type->tp_new = tp_new;
  type->tp_init = tp_init;
  type->tp_dealloc = tp_dealloc;
  type->tp_methods = methods;
  type->tp_iter = tp_iter;
  type->tp_iternext = tp_iternext;
  type->tp_as_sequence = as_seq;
}

}  // namespace

// port: the init symbol of the module name above.
PyMODINIT_FUNC PyInit__tbt_core_torch(void) {
  import_array();

  // port: "_tbt_core_torch." type names.
  init_type(&PyBatchingQueueType, "_tbt_core_torch.BatchingQueue",
            sizeof(PyBatchingQueue), queue_new,
            reinterpret_cast<initproc>(queue_init),
            reinterpret_cast<destructor>(queue_dealloc), queue_methods,
            queue_iter, reinterpret_cast<iternextfunc>(queue_iternext),
            nullptr);
  // port: "_tbt_core_torch." type names.
  init_type(&PyBatchType, "_tbt_core_torch.Batch", sizeof(PyBatch), nullptr,
            nullptr, reinterpret_cast<destructor>(batch_dealloc),
            batch_methods, nullptr, nullptr, &batch_as_sequence);
  // port: "_tbt_core_torch." type names.
  init_type(&PyDynamicBatcherType, "_tbt_core_torch.DynamicBatcher",
            sizeof(PyDynamicBatcher), batcher_new,
            reinterpret_cast<initproc>(batcher_init),
            reinterpret_cast<destructor>(batcher_dealloc), batcher_methods,
            queue_iter, reinterpret_cast<iternextfunc>(batcher_iternext),
            nullptr);
  // port: "_tbt_core_torch." type names.
  init_type(&PySliceRouterType, "_tbt_core_torch.SliceRouter",
            sizeof(PySliceRouter), slice_router_new,
            reinterpret_cast<initproc>(slice_router_init),
            reinterpret_cast<destructor>(slice_router_dealloc),
            slice_router_methods, nullptr, nullptr, nullptr);
  // port: "_tbt_core_torch." type names.
  init_type(&PyReplicaRouterType, "_tbt_core_torch.ReplicaRouter",
            sizeof(PyReplicaRouter), replica_router_new,
            reinterpret_cast<initproc>(replica_router_init),
            reinterpret_cast<destructor>(replica_router_dealloc),
            replica_router_methods, nullptr, nullptr, nullptr);
  // port: "_tbt_core_torch." type names.
  init_type(&PyActorPoolType, "_tbt_core_torch.ActorPool", sizeof(PyActorPool),
            pool_new, reinterpret_cast<initproc>(pool_init),
            reinterpret_cast<destructor>(pool_dealloc), pool_methods, nullptr,
            nullptr, nullptr);
  PyActorPoolType.tp_getset = pool_getset;
  // port: "_tbt_core_torch." type names.
  init_type(&PyEnvServerType, "_tbt_core_torch.EnvServer", sizeof(PyEnvServer),
            env_server_new, reinterpret_cast<initproc>(env_server_init),
            reinterpret_cast<destructor>(env_server_dealloc),
            env_server_methods, nullptr, nullptr, nullptr);

  if (PyType_Ready(&PyBatchingQueueType) < 0 ||
      PyType_Ready(&PyBatchType) < 0 ||
      PyType_Ready(&PyDynamicBatcherType) < 0 ||
      PyType_Ready(&PySliceRouterType) < 0 ||
      PyType_Ready(&PyReplicaRouterType) < 0 ||
      PyType_Ready(&PyActorPoolType) < 0 ||
      PyType_Ready(&PyEnvServerType) < 0)
    return nullptr;

  PyObject* module = PyModule_Create(&module_def);
  if (!module) return nullptr;

  // port: "_tbt_core_torch." exception names (and below, ShedError).
  ClosedBatchingQueueError = PyErr_NewException(
      "_tbt_core_torch.ClosedBatchingQueue", PyExc_RuntimeError, nullptr);
  AsyncErrorError = PyErr_NewException("_tbt_core_torch.AsyncError",
                                       PyExc_RuntimeError, nullptr);
  // ShedError bases: the C++ AsyncError twin AND (when importable) the
  // Python runtime's typed ShedError, so `except ShedError` in
  // torchbeast_tpu code catches sheds from either runtime with one
  // clause. The extension stays importable standalone (tests build it
  // without the package on sys.path) — the extra base is best-effort.
  {
    PyObject* bases = nullptr;
    // port: the port's ShedError, not the JAX package's.
    PyObject* mod =
        PyImport_ImportModule("torchbeast_tpu_torch.runtime.errors");
    if (mod) {
      PyObject* py_shed = PyObject_GetAttrString(mod, "ShedError");
      Py_DECREF(mod);
      if (py_shed) {
        bases = PyTuple_Pack(2, AsyncErrorError, py_shed);
        Py_DECREF(py_shed);
      }
    }
    if (!bases) {
      PyErr_Clear();
      bases = PyTuple_Pack(1, AsyncErrorError);
    }
    ShedErrorError =
        PyErr_NewException("_tbt_core_torch.ShedError", bases, nullptr);
    Py_XDECREF(bases);
  }

  Py_INCREF(&PyBatchingQueueType);
  Py_INCREF(&PyBatchType);
  Py_INCREF(&PyDynamicBatcherType);
  Py_INCREF(&PySliceRouterType);
  Py_INCREF(&PyReplicaRouterType);
  Py_INCREF(&PyActorPoolType);
  PyModule_AddObject(module, "BatchingQueue",
                     reinterpret_cast<PyObject*>(&PyBatchingQueueType));
  PyModule_AddObject(module, "Batch",
                     reinterpret_cast<PyObject*>(&PyBatchType));
  PyModule_AddObject(module, "DynamicBatcher",
                     reinterpret_cast<PyObject*>(&PyDynamicBatcherType));
  PyModule_AddObject(module, "SliceRouter",
                     reinterpret_cast<PyObject*>(&PySliceRouterType));
  PyModule_AddObject(module, "ReplicaRouter",
                     reinterpret_cast<PyObject*>(&PyReplicaRouterType));
  PyModule_AddObject(module, "ActorPool",
                     reinterpret_cast<PyObject*>(&PyActorPoolType));
  Py_INCREF(&PyEnvServerType);
  PyModule_AddObject(module, "EnvServer",
                     reinterpret_cast<PyObject*>(&PyEnvServerType));
  PyModule_AddObject(module, "ClosedBatchingQueue", ClosedBatchingQueueError);
  PyModule_AddObject(module, "AsyncError", AsyncErrorError);
  PyModule_AddObject(module, "ShedError", ShedErrorError);
  // Extension API generation (runtime/native.py REQUIRED_API_VERSION):
  // 1 = the ISSUE 14 shed protocol; 2 = the ISSUE 16 serving plane
  // (routers, continuous batching, record_policy_lag). The default-on
  // native runtime refuses stale builds instead of silently serving
  // central-only without admission control.
  PyModule_AddIntConstant(module, "API_VERSION", 2);
  return module;
}
