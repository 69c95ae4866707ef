// The port's reverse shim (built as build/native_torch/libec_jax.so, the
// name the native registry loads for "--plugin jax"): a dlopen-able
// native EC plugin that embeds CPython and forwards the vtable to the
// port's torch plugin (ceph_tpu_torch.interop.ec_shim). Lets the native
// harness (ec_bench, or any consumer of the __erasure_code_init
// contract) drive the port's plugin, and on the card its gf_encode
// kernel, exactly like a C plugin.
//
// The port's copy of native/ec/plugin_jax_shim.cc, which imports the
// reference's module by name; this one imports the port's, and pins no
// platform (the profile's device key picks the device).
//
// ref: the role of src/erasure-code/ErasureCodePlugin.cc
// __erasure_code_init; SURVEY.md §7 step 6 (the "reverse shim" build
// plan step).
//
// Interpreter lifecycle: initialized lazily on the first create();
// never finalized (plugin .so lifetime == process lifetime, like the
// reference's load-once registry). If the host process already runs
// Python (e.g. a ctypes consumer inside pytest), the existing
// interpreter is reused via PyGILState.

#include <Python.h>

#include <dlfcn.h>

#include <cstdlib>
#include <string>

#include "plugin.h"

namespace {

struct TorchBackend {
  PyObject* handle;  // the Python ErasureCodeInterface instance
  int k, m;
};

PyObject* g_mod = nullptr;  // ceph_tpu_torch.interop.ec_shim, for life

bool ensure_interp() {
  if (Py_IsInitialized()) return true;
  Py_InitializeEx(0);
  if (!Py_IsInitialized()) return false;
  // Release the GIL the init left us holding so every entry point can
  // use the uniform PyGILState_Ensure/Release pairing.
  PyEval_SaveThread();
  return true;
}

std::string repo_root() {
  // <repo>/build/native_torch/libec_jax.so -> <repo>. dli_fname can be
  // RELATIVE (it echoes the dlopen argument), so resolve it first.
  Dl_info info;
  if (dladdr(reinterpret_cast<void*>(&ensure_interp), &info) &&
      info.dli_fname) {
    char abs[4096];
    if (realpath(info.dli_fname, abs)) {
      std::string p = abs;
      for (int i = 0; i < 3; ++i) {
        auto cut = p.rfind('/');
        if (cut == std::string::npos) return ".";
        p.erase(cut);
      }
      if (!p.empty()) return p;
    }
  }
  return ".";
}

// GIL must be held.
PyObject* shim_module() {
  if (g_mod) return g_mod;
  // Bootstrap import paths: the embedded interpreter resolves its
  // prefix from libpython, not from any active virtualenv, so (a) the
  // repo root (for ceph_tpu_torch) and (b) $VIRTUAL_ENV's site-packages
  // (for torch/numpy when ec_bench runs inside a venv) must be added by
  // hand.
  std::string root = repo_root();
  std::string esc;  // escape for a double-quoted Python literal
  for (char c : root) {
    if (c == '\\' || c == '"') esc += '\\';
    esc += c;
  }
  std::string boot =
      "import os, site, sys\n"
      "sys.path.insert(0, os.path.abspath(" +
      std::string("\"") + esc + "\"))\n" +
      "venv = os.environ.get('VIRTUAL_ENV')\n"
      "if venv:\n"
      "    d = os.path.join(venv, 'lib',\n"
      "                     'python%d.%d' % sys.version_info[:2],\n"
      "                     'site-packages')\n"
      "    if os.path.isdir(d):\n"
      "        site.addsitedir(d)\n";
  if (PyRun_SimpleString(boot.c_str()) != 0) PyErr_Print();
  g_mod = PyImport_ImportModule("ceph_tpu_torch.interop.ec_shim");
  if (!g_mod) PyErr_Print();
  return g_mod;
}

ec_backend_t* torch_create(const char* profile) {
  if (!ensure_interp()) return nullptr;
  PyGILState_STATE g = PyGILState_Ensure();
  TorchBackend* be = nullptr;
  PyObject* mod = shim_module();
  if (mod) {
    PyObject* h =
        PyObject_CallMethod(mod, "create", "s", profile ? profile : "");
    if (h) {
      PyObject* kk = PyObject_GetAttrString(h, "k");
      PyObject* mm = PyObject_GetAttrString(h, "m");
      if (kk && mm) {
        be = new TorchBackend{h, static_cast<int>(PyLong_AsLong(kk)),
                            static_cast<int>(PyLong_AsLong(mm))};
      } else {
        Py_DECREF(h);
      }
      Py_XDECREF(kk);
      Py_XDECREF(mm);
    } else {
      PyErr_Print();
    }
  }
  PyGILState_Release(g);
  return reinterpret_cast<ec_backend_t*>(be);
}

void torch_destroy(ec_backend_t* b) {
  auto* be = reinterpret_cast<TorchBackend*>(b);
  if (!be) return;
  PyGILState_STATE g = PyGILState_Ensure();
  Py_XDECREF(be->handle);
  PyGILState_Release(g);
  delete be;
}

int torch_k(ec_backend_t* b) { return reinterpret_cast<TorchBackend*>(b)->k; }
int torch_m(ec_backend_t* b) { return reinterpret_cast<TorchBackend*>(b)->m; }

int torch_encode(ec_backend_t* b, const uint8_t* data, uint8_t* parity,
               size_t chunk) {
  auto* be = reinterpret_cast<TorchBackend*>(b);
  PyGILState_STATE g = PyGILState_Ensure();
  int rc = -1;
  PyObject* mod = shim_module();
  PyObject* dmv = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<uint8_t*>(data)),
      static_cast<Py_ssize_t>(be->k * chunk), PyBUF_READ);
  PyObject* pmv = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(parity),
      static_cast<Py_ssize_t>(be->m * chunk), PyBUF_WRITE);
  if (mod && dmv && pmv) {
    PyObject* r = PyObject_CallMethod(mod, "encode", "OOOn", be->handle,
                                      dmv, pmv,
                                      static_cast<Py_ssize_t>(chunk));
    if (r) {
      rc = static_cast<int>(PyLong_AsLong(r));
      Py_DECREF(r);
    } else {
      PyErr_Print();
    }
  }
  Py_XDECREF(dmv);
  Py_XDECREF(pmv);
  PyGILState_Release(g);
  return rc;
}

int torch_decode(ec_backend_t* b, const int* avail, int n_avail,
               const int* want, int n_want, const uint8_t* chunks,
               uint8_t* out, size_t chunk) {
  auto* be = reinterpret_cast<TorchBackend*>(b);
  PyGILState_STATE g = PyGILState_Ensure();
  int rc = -1;
  PyObject* mod = shim_module();
  PyObject* al = PyList_New(n_avail);
  PyObject* wl = PyList_New(n_want);
  for (int i = 0; al && i < n_avail; ++i)
    PyList_SET_ITEM(al, i, PyLong_FromLong(avail[i]));
  for (int i = 0; wl && i < n_want; ++i)
    PyList_SET_ITEM(wl, i, PyLong_FromLong(want[i]));
  PyObject* cmv = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<uint8_t*>(chunks)),
      static_cast<Py_ssize_t>(static_cast<size_t>(n_avail) * chunk),
      PyBUF_READ);
  PyObject* omv = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(out),
      static_cast<Py_ssize_t>(static_cast<size_t>(n_want) * chunk),
      PyBUF_WRITE);
  if (mod && al && wl && cmv && omv) {
    PyObject* r = PyObject_CallMethod(mod, "decode", "OOOOOn", be->handle,
                                      al, wl, cmv, omv,
                                      static_cast<Py_ssize_t>(chunk));
    if (r) {
      rc = static_cast<int>(PyLong_AsLong(r));
      Py_DECREF(r);
    } else {
      PyErr_Print();
    }
  }
  Py_XDECREF(al);
  Py_XDECREF(wl);
  Py_XDECREF(cmv);
  Py_XDECREF(omv);
  PyGILState_Release(g);
  return rc;
}

const ec_plugin_vtable_t kVtable = {torch_create, torch_destroy,
                                    torch_k,      torch_m,
                                    torch_encode, torch_decode};

}  // namespace

extern "C" int __erasure_code_init(const char* plugin_name) {
  return ec_plugin_register(plugin_name ? plugin_name : "jax", &kVtable);
}
