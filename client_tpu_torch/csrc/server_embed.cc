// CPython-embedding implementation of server_embed.h for the PyTorch port.
//
// The logic of native/src/server_embed.cc, hosting the port's server
// instead: its models run on the card inside the hosting process. Built by
// client_tpu_torch/native_build.py (g++ against this interpreter's
// Python.h and libpython).
//
// Design: one embedded interpreter, initialized once; every API call takes
// the GIL (PyGILState_Ensure) and calls a function in
// client_tpu_torch.server.embed, converting results to C buffers the caller
// frees with ctpu_embed_free(). No Python object outlives a call except
// the cached module reference. Two hosting modes: a plain C/C++/Java
// process (the shim creates the interpreter and releases its GIL after the
// import) or a Python process that dlopened the library (the shim only
// takes the GIL).
//
// Reference parity: the tritonserver C API surface java-api-bindings wraps
// (TRITONSERVER_ServerNew / InferenceRequest / ...) maps here to
// create/infer/metadata/load/unload/destroy with the v2 body contract
// replacing the C tensor-attribute calls — the embedding host reuses the
// same marshaling code every client in this repo already has.

#include "client_tpu/server_embed.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::mutex g_init_mutex;
bool g_initialized = false;
PyObject* g_embed_module = nullptr;  // client_tpu_torch.server.embed
PyThreadState* g_main_tstate = nullptr;

char* DupString(const std::string& s) {
  char* out = static_cast<char*>(std::malloc(s.size() + 1));
  if (out != nullptr) std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

void SetError(char** error, const std::string& message) {
  if (error != nullptr) *error = DupString(message);
}

// Fetch the pending Python exception as "Type: message" (GIL held).
std::string FetchPyError() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  std::string message = "python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) message = c;
      Py_DECREF(s);
    }
  }
  if (type != nullptr) {
    PyObject* n = PyObject_GetAttrString(type, "__name__");
    if (n != nullptr) {
      const char* c = PyUnicode_AsUTF8(n);
      if (c != nullptr) message = std::string(c) + ": " + message;
      Py_DECREF(n);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  return message;
}

// RAII GIL acquisition for API calls (interpreter must be initialized).
class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

// Call embed.<fn>(*args); returns new reference or nullptr (error set).
PyObject* CallEmbed(const char* fn, PyObject* args) {
  PyObject* callable = PyObject_GetAttrString(g_embed_module, fn);
  if (callable == nullptr) return nullptr;
  PyObject* result = PyObject_CallObject(callable, args);
  Py_DECREF(callable);
  return result;
}

}  // namespace

extern "C" {

int ctpu_embed_init(const char* repo_path, char** error) {
  std::lock_guard<std::mutex> lock(g_init_mutex);
  if (g_initialized) return 0;
  // Two hosting modes: a plain C/C++/Java process (we own the interpreter)
  // or a Python process that dlopened this library (we must not re-init and
  // must take the GIL before touching anything).
  bool created = false;
  if (!Py_IsInitialized()) {
    PyConfig config;
    PyConfig_InitPythonConfig(&config);
    PyStatus status = Py_InitializeFromConfig(&config);
    PyConfig_Clear(&config);
    if (PyStatus_Exception(status)) {
      SetError(error, std::string("interpreter init failed: ") +
                          (status.err_msg != nullptr ? status.err_msg : "?"));
      return 1;
    }
    created = true;
  }
  {
    PyGILState_STATE st = PyGILState_Ensure();
    if (repo_path != nullptr && repo_path[0] != '\0') {
      PyObject* sys_path = PySys_GetObject("path");  // borrowed
      PyObject* p = PyUnicode_FromString(repo_path);
      if (sys_path != nullptr && p != nullptr) PyList_Insert(sys_path, 0, p);
      Py_XDECREF(p);
    }
    g_embed_module = PyImport_ImportModule("client_tpu_torch.server.embed");
    const bool import_failed = g_embed_module == nullptr;
    if (import_failed) {
      SetError(error, "import client_tpu_torch.server.embed failed: " +
                          FetchPyError());
    }
    PyGILState_Release(st);
    if (import_failed) {
      if (created) {
        // release the init thread's GIL even on failure: a retry (or any
        // other caller) must be able to PyGILState_Ensure, not deadlock
        g_main_tstate = PyEval_SaveThread();
      }
      return 1;
    }
  }
  if (created) {
    // we initialized in this thread and still hold its GIL: release it so
    // ctpu_embed_* can PyGILState_Ensure from any thread
    g_main_tstate = PyEval_SaveThread();
  }
  g_initialized = true;
  return 0;
}

int64_t ctpu_embed_server_create(const char* options_json, char** error) {
  if (!g_initialized) {
    int rc = ctpu_embed_init(nullptr, error);
    if (rc != 0) return 0;
  }
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(s)", options_json != nullptr ? options_json : "");
  PyObject* result = CallEmbed("create", args);
  Py_XDECREF(args);
  if (result == nullptr) {
    SetError(error, FetchPyError());
    return 0;
  }
  int64_t handle = PyLong_AsLongLong(result);
  Py_DECREF(result);
  if (handle <= 0) {
    PyErr_Clear();  // a stale pending exception would poison the next call
    SetError(error, "embed.create returned an invalid handle");
    return 0;
  }
  return handle;
}

int ctpu_embed_infer(
    int64_t server, const char* model_name, const char* model_version,
    const uint8_t* body, size_t body_len, int64_t header_length,
    uint8_t** response, size_t* response_len, int64_t* response_header_len,
    char** error) {
  if (!g_initialized) {
    SetError(error, "not initialized");
    return 1;
  }
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(Lssy#L)", static_cast<long long>(server),
      model_name != nullptr ? model_name : "",
      model_version != nullptr ? model_version : "",
      reinterpret_cast<const char*>(body), static_cast<Py_ssize_t>(body_len),
      static_cast<long long>(header_length));
  PyObject* result = args != nullptr ? CallEmbed("infer", args) : nullptr;
  Py_XDECREF(args);
  if (result == nullptr) {
    SetError(error, FetchPyError());
    return 1;
  }
  // result: (bytes, header_len)
  PyObject* payload = PyTuple_GetItem(result, 0);    // borrowed
  PyObject* header_len = PyTuple_GetItem(result, 1); // borrowed
  if (payload == nullptr || header_len == nullptr) {
    PyErr_Clear();  // IndexError/SystemError from GetItem must not leak
    Py_DECREF(result);
    SetError(error, "embed.infer returned a malformed tuple");
    return 1;
  }
  char* data = nullptr;
  Py_ssize_t size = 0;
  if (PyBytes_AsStringAndSize(payload, &data, &size) != 0) {
    Py_DECREF(result);
    SetError(error, FetchPyError());
    return 1;
  }
  int64_t hlen = PyLong_AsLongLong(header_len);
  if (hlen == -1 && PyErr_Occurred()) {
    PyErr_Clear();
    Py_DECREF(result);
    SetError(error, "embed.infer returned a non-integer header length");
    return 1;
  }
  uint8_t* out = static_cast<uint8_t*>(std::malloc(size > 0 ? size : 1));
  if (out == nullptr) {
    Py_DECREF(result);
    SetError(error, "out of memory copying response");
    return 1;
  }
  std::memcpy(out, data, size);
  *response = out;
  *response_len = static_cast<size_t>(size);
  *response_header_len = hlen;
  Py_DECREF(result);
  return 0;
}

namespace {

// Shared shape of the JSON-returning admin calls.
int JsonCall(const char* fn, PyObject* args, char** json, char** error) {
  Gil gil;
  PyObject* result = args != nullptr ? CallEmbed(fn, args) : nullptr;
  Py_XDECREF(args);
  if (result == nullptr) {
    SetError(error, FetchPyError());
    return 1;
  }
  char* data = nullptr;
  Py_ssize_t size = 0;
  if (PyBytes_AsStringAndSize(result, &data, &size) != 0) {
    Py_DECREF(result);
    SetError(error, FetchPyError());
    return 1;
  }
  char* out = static_cast<char*>(std::malloc(size + 1));
  if (out == nullptr) {
    Py_DECREF(result);
    SetError(error, "out of memory copying json");
    return 1;
  }
  std::memcpy(out, data, size);
  out[size] = '\0';
  *json = out;
  Py_DECREF(result);
  return 0;
}

}  // namespace

int ctpu_embed_metadata(
    int64_t server, const char* model_name, char** json, char** error) {
  if (!g_initialized) {
    SetError(error, "not initialized");
    return 1;
  }
  Gil gil_for_build;  // Py_BuildValue needs the GIL too
  PyObject* args = Py_BuildValue(
      "(Ls)", static_cast<long long>(server),
      model_name != nullptr ? model_name : "");
  return JsonCall("metadata_json", args, json, error);
}

int ctpu_embed_repository_index(int64_t server, char** json, char** error) {
  if (!g_initialized) {
    SetError(error, "not initialized");
    return 1;
  }
  Gil gil_for_build;
  PyObject* args = Py_BuildValue("(L)", static_cast<long long>(server));
  return JsonCall("repository_index_json", args, json, error);
}

int ctpu_embed_statistics(
    int64_t server, const char* model_name, char** json, char** error) {
  if (!g_initialized) {
    SetError(error, "not initialized");
    return 1;
  }
  Gil gil_for_build;
  PyObject* args = Py_BuildValue(
      "(Ls)", static_cast<long long>(server),
      model_name != nullptr ? model_name : "");
  return JsonCall("statistics_json", args, json, error);
}

namespace {

// Shared shape of the None-returning lifecycle calls.
int VoidCall(const char* fn, PyObject* args, char** error) {
  Gil gil;
  PyObject* result = args != nullptr ? CallEmbed(fn, args) : nullptr;
  Py_XDECREF(args);
  if (result == nullptr) {
    SetError(error, FetchPyError());
    return 1;
  }
  Py_DECREF(result);
  return 0;
}

}  // namespace

int ctpu_embed_load_model(
    int64_t server, const char* model_name, const char* config_json,
    char** error) {
  if (!g_initialized) {
    SetError(error, "not initialized");
    return 1;
  }
  Gil gil_for_build;
  PyObject* args = Py_BuildValue(
      "(Lss)", static_cast<long long>(server),
      model_name != nullptr ? model_name : "",
      config_json != nullptr ? config_json : "");
  return VoidCall("load_model", args, error);
}

int ctpu_embed_unload_model(
    int64_t server, const char* model_name, char** error) {
  if (!g_initialized) {
    SetError(error, "not initialized");
    return 1;
  }
  Gil gil_for_build;
  PyObject* args = Py_BuildValue(
      "(Ls)", static_cast<long long>(server),
      model_name != nullptr ? model_name : "");
  return VoidCall("unload_model", args, error);
}

int ctpu_embed_start_http(int64_t server, int* port, char** error) {
  if (!g_initialized) {
    SetError(error, "not initialized");
    return 1;
  }
  Gil gil;
  PyObject* args = Py_BuildValue(
      "(Li)", static_cast<long long>(server), port != nullptr ? *port : 0);
  PyObject* result = args != nullptr ? CallEmbed("start_http", args) : nullptr;
  Py_XDECREF(args);
  if (result == nullptr) {
    SetError(error, FetchPyError());
    return 1;
  }
  if (port != nullptr) *port = static_cast<int>(PyLong_AsLong(result));
  Py_DECREF(result);
  return 0;
}

int ctpu_embed_server_destroy(int64_t server, char** error) {
  if (!g_initialized) {
    SetError(error, "not initialized");
    return 1;
  }
  Gil gil;
  PyObject* args = Py_BuildValue("(L)", static_cast<long long>(server));
  return VoidCall("destroy", args, error);
}

void ctpu_embed_free(void* ptr) { std::free(ptr); }

}  // extern "C"
