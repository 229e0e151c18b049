// mv_capi: the C ABI of multiverso_tpu_torch (libmultiverso.so).
//
// The reference's C API surface (ref: include/multiverso/c_api.h
// MV_Init/MV_Barrier/MV_NewArrayTable/... and src/c_api.cpp), so that FFI
// clients (the Lua binding in examples/lua/multiverso.lua, or any C
// program) can drive the port. The runtime is Python and PyTorch, so this
// shim embeds (or attaches to) a CPython interpreter and forwards through
// multiverso_tpu_torch/c_api_support.py, passing raw buffers as integer
// addresses for zero-copy numpy views.
//
// Build: python -m multiverso_tpu_torch.native.capi (g++ at first use into
// build/torch_native/; prints the directory that holds libmultiverso.so).
// When loaded from inside a running Python process (ctypes, the tests),
// the shim attaches to the existing interpreter instead of starting one.

#include <Python.h>

#include <cstdarg>
#include <cstdint>
#include <cstdio>

namespace {

PyObject* g_support = nullptr;  // the c_api_support module
bool g_owns_interpreter = false;

struct Gil {
  PyGILState_STATE state;
  Gil() : state(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state); }
};

bool ensure_support() {
  if (g_support != nullptr) return true;
  g_support = PyImport_ImportModule("multiverso_tpu_torch.c_api_support");
  if (g_support == nullptr) {
    PyErr_Print();
    return false;
  }
  return true;
}

// Call a support function with a printf-style arg format; prints + clears
// Python errors (the C ABI has no error channel, matching the reference).
PyObject* call(const char* name, const char* fmt, ...) {
  Gil gil;
  if (!ensure_support()) return nullptr;
  va_list args;
  va_start(args, fmt);
  PyObject* callable = PyObject_GetAttrString(g_support, name);
  if (callable == nullptr) {
    va_end(args);
    PyErr_Print();
    return nullptr;
  }
  PyObject* py_args = Py_VaBuildValue(fmt, args);
  va_end(args);
  PyObject* result =
      py_args ? PyObject_CallObject(callable, py_args) : nullptr;
  Py_XDECREF(py_args);
  Py_DECREF(callable);
  if (result == nullptr) PyErr_Print();
  return result;
}

int64_t call_i64(const char* name, const char* fmt, ...) {
  Gil gil;
  if (!ensure_support()) return -1;
  va_list args;
  va_start(args, fmt);
  PyObject* callable = PyObject_GetAttrString(g_support, name);
  if (callable == nullptr) {
    va_end(args);
    PyErr_Print();
    return -1;
  }
  PyObject* py_args = Py_VaBuildValue(fmt, args);
  va_end(args);
  PyObject* result =
      py_args ? PyObject_CallObject(callable, py_args) : nullptr;
  Py_XDECREF(py_args);
  Py_DECREF(callable);
  if (result == nullptr) {
    PyErr_Print();
    return -1;
  }
  int64_t out = PyLong_AsLongLong(result);
  Py_DECREF(result);
  return out;
}

}  // namespace

extern "C" {

typedef void* TableHandler;

void MV_Init(int* /*argc*/, char** /*argv*/) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_owns_interpreter = true;
  }
  Py_XDECREF(call("init", "()"));
}

void MV_ShutDown() {
  Py_XDECREF(call("shutdown", "()"));
  if (g_owns_interpreter) {
    Gil gil;
    Py_XDECREF(g_support);
    g_support = nullptr;
  }
}

void MV_Barrier() { Py_XDECREF(call("barrier", "()")); }

int MV_NumWorkers() {
  return static_cast<int>(call_i64("num_workers", "()"));
}

int MV_WorkerId() { return static_cast<int>(call_i64("worker_id", "()")); }

int MV_ServerId() { return static_cast<int>(call_i64("server_id", "()")); }

// ---- Array table --------------------------------------------------------

void MV_NewArrayTable(int size, TableHandler* out) {
  *out = reinterpret_cast<TableHandler>(
      call_i64("new_array_table", "(i)", size));
}

void MV_GetArrayTable(TableHandler handler, float* data, int size) {
  Py_XDECREF(call("array_get", "(LLi)",
                  reinterpret_cast<int64_t>(handler),
                  reinterpret_cast<int64_t>(data), size));
}

void MV_AddArrayTable(TableHandler handler, float* data, int size) {
  Py_XDECREF(call("array_add", "(LLii)",
                  reinterpret_cast<int64_t>(handler),
                  reinterpret_cast<int64_t>(data), size, 1));
}

void MV_AddAsyncArrayTable(TableHandler handler, float* data, int size) {
  Py_XDECREF(call("array_add", "(LLii)",
                  reinterpret_cast<int64_t>(handler),
                  reinterpret_cast<int64_t>(data), size, 0));
}

// Async-plane tables, beyond the reference C API (which reached only the
// sync tables): every process owns a row shard served by its PSService;
// adds and gets are uncoordinated and ride the native C++ transport where
// libmv_ps builds. The accessors below work on these handles unchanged.

void MV_NewAsyncArrayTable(int size, TableHandler* out) {
  *out = reinterpret_cast<TableHandler>(
      call_i64("new_async_array_table", "(i)", size));
}

void MV_NewAsyncMatrixTable(int num_row, int num_col, TableHandler* out) {
  *out = reinterpret_cast<TableHandler>(
      call_i64("new_async_matrix_table", "(ii)", num_row, num_col));
}

// ---- Matrix table -------------------------------------------------------

void MV_NewMatrixTable(int num_row, int num_col, TableHandler* out) {
  *out = reinterpret_cast<TableHandler>(
      call_i64("new_matrix_table", "(ii)", num_row, num_col));
}

void MV_GetMatrixTableAll(TableHandler handler, float* data, int size) {
  Py_XDECREF(call("matrix_get_all", "(LLi)",
                  reinterpret_cast<int64_t>(handler),
                  reinterpret_cast<int64_t>(data), size));
}

void MV_AddMatrixTableAll(TableHandler handler, float* data, int size) {
  Py_XDECREF(call("matrix_add_all", "(LLii)",
                  reinterpret_cast<int64_t>(handler),
                  reinterpret_cast<int64_t>(data), size, 1));
}

void MV_AddAsyncMatrixTableAll(TableHandler handler, float* data, int size) {
  Py_XDECREF(call("matrix_add_all", "(LLii)",
                  reinterpret_cast<int64_t>(handler),
                  reinterpret_cast<int64_t>(data), size, 0));
}

void MV_GetMatrixTableByRows(TableHandler handler, float* data, int size,
                             int row_ids[], int row_ids_n) {
  Py_XDECREF(call("matrix_get_rows", "(LLiLi)",
                  reinterpret_cast<int64_t>(handler),
                  reinterpret_cast<int64_t>(data), size,
                  reinterpret_cast<int64_t>(row_ids), row_ids_n));
}

void MV_AddMatrixTableByRows(TableHandler handler, float* data, int size,
                             int row_ids[], int row_ids_n) {
  Py_XDECREF(call("matrix_add_rows", "(LLiLii)",
                  reinterpret_cast<int64_t>(handler),
                  reinterpret_cast<int64_t>(data), size,
                  reinterpret_cast<int64_t>(row_ids), row_ids_n, 1));
}

void MV_AddAsyncMatrixTableByRows(TableHandler handler, float* data,
                                  int size, int row_ids[], int row_ids_n) {
  Py_XDECREF(call("matrix_add_rows", "(LLiLii)",
                  reinterpret_cast<int64_t>(handler),
                  reinterpret_cast<int64_t>(data), size,
                  reinterpret_cast<int64_t>(row_ids), row_ids_n, 0));
}

}  // extern "C"
