// Launches of the kernels of bitonic.cu as torch operators:
//   ga_torch::sort_rows(Tensor key, Tensor(a!) out, int rows, int top, int block_keys) -> ()
//   ga_torch::chunk_sort(Tensor key, Tensor(a!) out, int n_keys, int top, int block_keys) -> ()
//   ga_torch::finish(Tensor key, Tensor(a!) out, int n_chunks, int chunk, int size,
//                    int per_thread) -> ()
//   ga_torch::big_ce(Tensor key, Tensor(a!) out, int n, int d, int size) -> ()
//   ga_torch::bitonic_max_shared_keys() -> int
//   ga_torch::finish_shared_launch_bytes(int chunk, int per_thread) -> int
//
// Host C++ against torch's headers, compiled by csrc/build.py in one nvcc
// call with bitonic.cu into one library, loaded with torch.ops.load_library.
// An operator only launches: the Python wrappers (ops/bitonic_cuda.py) check
// the keys, allocate the output (or pass the keys as their own output) and
// count the launch.  Here the keys' card is made current and the C launcher
// of bitonic.cu runs on torch's current stream of that card; an error it
// returns raises.

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <c10/util/Exception.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

#include <cstdint>

extern "C" int bitonic_max_shared_keys();
extern "C" int sort_rows_launch(const void* in, void* out, long long rows, int top,
                                int block_keys, void* stream);
extern "C" int chunk_sort_launch(const void* in, void* out, unsigned long long n_keys, int top,
                                 int block_keys, void* stream);
extern "C" int finish_launch(const void* in, void* out, long long n_chunks, int chunk,
                             unsigned long long size, int per_thread, void* stream);
extern "C" long long finish_shared_launch_bytes(int chunk, int per_thread);
extern "C" int big_ce_launch(const void* in, void* out, unsigned long long n,
                             unsigned long long d, unsigned long long size, void* stream);

namespace {

void check_launch(int err, const char* kernel) {
  TORCH_CHECK(err == 0, kernel, " kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

void* current_stream() { return c10::cuda::getCurrentCUDAStream().stream(); }

void sort_rows(const at::Tensor& key, at::Tensor& out, int64_t rows, int64_t top,
               int64_t block_keys) {
  const c10::cuda::CUDAGuard guard(key.device());
  check_launch(sort_rows_launch(key.const_data_ptr(), out.mutable_data_ptr(), rows,
                                static_cast<int>(top), static_cast<int>(block_keys),
                                current_stream()),
               "sort_rows");
}

void chunk_sort(const at::Tensor& key, at::Tensor& out, int64_t n_keys, int64_t top,
                int64_t block_keys) {
  const c10::cuda::CUDAGuard guard(key.device());
  check_launch(chunk_sort_launch(key.const_data_ptr(), out.mutable_data_ptr(),
                                 static_cast<unsigned long long>(n_keys), static_cast<int>(top),
                                 static_cast<int>(block_keys), current_stream()),
               "chunk_sort");
}

void finish(const at::Tensor& key, at::Tensor& out, int64_t n_chunks, int64_t chunk,
            int64_t size, int64_t per_thread) {
  const c10::cuda::CUDAGuard guard(key.device());
  check_launch(finish_launch(key.const_data_ptr(), out.mutable_data_ptr(), n_chunks,
                             static_cast<int>(chunk), static_cast<unsigned long long>(size),
                             static_cast<int>(per_thread), current_stream()),
               "finish");
}

void big_ce(const at::Tensor& key, at::Tensor& out, int64_t n, int64_t d, int64_t size) {
  const c10::cuda::CUDAGuard guard(key.device());
  check_launch(big_ce_launch(key.const_data_ptr(), out.mutable_data_ptr(),
                             static_cast<unsigned long long>(n), static_cast<unsigned long long>(d),
                             static_cast<unsigned long long>(size), current_stream()),
               "big_ce");
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(ga_torch, m) {
  m.def("sort_rows(Tensor key, Tensor(a!) out, int rows, int top, int block_keys) -> ()");
  m.def("chunk_sort(Tensor key, Tensor(a!) out, int n_keys, int top, int block_keys) -> ()");
  m.def("finish(Tensor key, Tensor(a!) out, int n_chunks, int chunk, int size, "
        "int per_thread) -> ()");
  m.def("big_ce(Tensor key, Tensor(a!) out, int n, int d, int size) -> ()");
  m.def("bitonic_max_shared_keys() -> int",
        []() -> int64_t { return bitonic_max_shared_keys(); });
  m.def("finish_shared_launch_bytes(int chunk, int per_thread) -> int",
        [](int64_t chunk, int64_t per_thread) -> int64_t {
          return finish_shared_launch_bytes(static_cast<int>(chunk),
                                            static_cast<int>(per_thread));
        });
}

TORCH_LIBRARY_IMPL(ga_torch, CUDA, m) {
  m.impl("sort_rows", &sort_rows);
  m.impl("chunk_sort", &chunk_sort);
  m.impl("finish", &finish);
  m.impl("big_ce", &big_ce);
}
