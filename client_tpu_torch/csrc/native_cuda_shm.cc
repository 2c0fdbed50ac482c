// cuda shared-memory registration for the native clients' flat C API.
//
// native/src/c_api.cc exposes the tpu registration of both C++ clients and
// the cuda unregister (ctpu_unregister_shm(..., "cuda", ...)), but not the
// cuda registration, which the port's servers need: they serve the
// systemsharedmemory and cudasharedmemory routes only. The C++ classes have
// it (InferenceServerHttpClient / InferenceServerGrpcClient::
// RegisterCudaSharedMemory); these two entry points call it, linked into
// the same library as c_api.cc. The raw handle is the base64 descriptor of
// a host window (ctpu_shm_raw_handle, or the port's
// utils.cuda_shared_memory.get_raw_handle). A failure's message is read with
// ctpu_torch_last_error (c_api.cc keeps its own message where this file
// cannot reach it).

#include <string>

#include "client_tpu/common.h"
#include "client_tpu/grpc_client.h"
#include "client_tpu/http_client.h"

namespace {

thread_local std::string g_last_error;

int SetError(const client_tpu::Error& err) {
  if (err.IsOk()) return 0;
  g_last_error = err.Message();
  return -1;
}

}  // namespace

extern "C" {

const char* ctpu_torch_last_error() { return g_last_error.c_str(); }

int ctpu_torch_register_cuda_shm(
    void* client, const char* name, const char* raw_handle_b64, int device_id,
    unsigned long long byte_size) {
  return SetError(
      static_cast<client_tpu::InferenceServerHttpClient*>(client)
          ->RegisterCudaSharedMemory(name, raw_handle_b64, device_id, byte_size));
}

int ctpu_torch_grpc_register_cuda_shm(
    void* client, const char* name, const char* raw_handle_b64, int device_id,
    unsigned long long byte_size) {
  return SetError(
      static_cast<client_tpu::InferenceServerGrpcClient*>(client)
          ->RegisterCudaSharedMemory(name, raw_handle_b64, device_id, byte_size));
}

}  // extern "C"
