// The C ABI of the PyTorch port's MSM (the port's copy of
// native/tpu_msm_embed.cpp, the JAX package's).
//
// A host written in C, C++, Swift or Rust links
// libtpu_msm_torch_embed.so, calls tpu_msm_init() once, then runs the MSM
// through tpu_msm_best() on wire-format byte buffers. The library embeds
// CPython and forwards to tpu_msm_torch.bindings.embed, which owns the wire
// format (see that module for the layout). The entry points, their
// arguments and their return codes are the JAX package's, so a host
// switches between the two by linking the other library.
//
// A Python exception (no CUDA device, a malformed buffer) is printed and
// comes back as a negative return code; the MSM never moves to the CPU.
//
// Thread-safety: every entry point takes the GIL, so concurrent callers
// run one at a time.
//
// Build: tpu_msm_torch._build.build_embed() (g++ with python3-config's
// --includes and --embed --ldflags) -> build/tpu_msm_torch/
// libtpu_msm_torch_embed.so and the smoke host program test_embed (this
// directory's test_embed_main.c).

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>

namespace {
PyObject* g_embed_module = nullptr;  // tpu_msm_torch.bindings.embed, owned ref
PyThreadState* g_main_tstate = nullptr;
std::mutex g_init_mutex;  // serializes first-time init across host threads
}  // namespace

extern "C" {

// Initialize the embedded interpreter and import the MSM module.
// Returns 0 on success, negative on failure. Idempotent and thread-safe.
int tpu_msm_init(void) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_embed_module != nullptr) return 0;
  // Only release the GIL at the end if WE created the interpreter: a host
  // that already embeds CPython legitimately holds the GIL on entry, and
  // stealing it (PyEval_SaveThread) would crash the host on return.
  const bool we_initialized = !Py_IsInitialized();
  if (we_initialized) {
    Py_InitializeEx(0);  // no signal handlers: the host owns signals
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* mod = PyImport_ImportModule("tpu_msm_torch.bindings.embed");
  if (mod == nullptr) {
    PyErr_Print();
    PyGILState_Release(gil);
    return -1;
  }
  g_embed_module = mod;
  PyGILState_Release(gil);
  // Release the GIL we implicitly hold after Py_InitializeEx so host
  // threads can call in (each entry point re-acquires via PyGILState).
  if (we_initialized && g_main_tstate == nullptr && PyGILState_Check()) {
    g_main_tstate = PyEval_SaveThread();
  }
  return 0;
}

// Adaptive MSM over wire-format buffers (see tpu_msm_torch/bindings/embed.py):
//   scalars: n*32 bytes LE standard-form Fr (< r)
//   points:  n*64 bytes LE Montgomery affine x||y; (0,0) = infinity
//   out:     64 bytes LE standard-form affine result; (0,0) = infinity
// Returns 0 on success, -1 not initialized, -2 python-side error.
int tpu_msm_best(const uint8_t* scalars, const uint8_t* points, size_t n,
                 uint8_t out[64]) {
  if (g_embed_module == nullptr) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = 0;
  PyObject* res = nullptr;
  PyObject* s = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(scalars), static_cast<Py_ssize_t>(n * 32));
  PyObject* p = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(points), static_cast<Py_ssize_t>(n * 64));
  if (s != nullptr && p != nullptr) {
    res = PyObject_CallMethod(g_embed_module, "msm_best_wire", "OO", s, p);
  }
  if (res == nullptr || !PyBytes_Check(res) || PyBytes_Size(res) != 64) {
    if (PyErr_Occurred()) PyErr_Print();
    rc = -2;
  } else {
    std::memcpy(out, PyBytes_AsString(res), 64);
  }
  Py_XDECREF(res);
  Py_XDECREF(p);
  Py_XDECREF(s);
  PyGILState_Release(gil);
  return rc;
}

// Benchmark hook: the fixture instance of 2^log_n points, mean
// milliseconds of msm_best over `iters` runs written to *ms_out. Returns 0
// on success, -1 not initialized, -2 python-side error.
int tpu_msm_benchmark(uint32_t log_n, uint32_t iters, double* ms_out) {
  if (g_embed_module == nullptr) return -1;
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = 0;
  PyObject* res = PyObject_CallMethod(g_embed_module, "benchmark_msm_best",
                                      "II", log_n, iters);
  if (res == nullptr) {
    PyErr_Print();
    rc = -2;
  } else {
    *ms_out = PyFloat_AsDouble(res);
    if (PyErr_Occurred()) {
      PyErr_Print();
      rc = -2;
    }
  }
  Py_XDECREF(res);
  PyGILState_Release(gil);
  return rc;
}

// Drop the module reference (the interpreter stays up: finalizing CPython
// with live CUDA state is not supported; hosts should simply exit). Safe to
// call more than once.
void tpu_msm_shutdown(void) {
  if (g_embed_module == nullptr) return;
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_CLEAR(g_embed_module);
  PyGILState_Release(gil);
}

}  // extern "C"
