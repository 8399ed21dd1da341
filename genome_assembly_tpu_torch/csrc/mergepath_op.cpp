// Launches of the merge-path kernels (mergepath.cu) as torch operators:
//   ga_torch::local_merge(Tensor key, Tensor(a!) out, int n_chunks, int chunk, int base_run,
//                         int top, int per_thread) -> ()
//   ga_torch::merge_pass(Tensor key, Tensor(a!) out, Tensor a0, Tensor b0, int n_tiles,
//                        int tile, int run, int per_thread) -> ()
//   ga_torch::merge_splits(Tensor key, Tensor(a!) a0, Tensor(b!) b0, Tensor(c!) aend,
//                          Tensor(d!) bend, int n_tiles, int tile, int run) -> ()
//   ga_torch::mergepath_max_chunk_keys() -> int
//   ga_torch::mergepath_max_tile_keys() -> int
//
// Host C++ against torch's headers, compiled by csrc/build.py in one nvcc
// call with mergepath.cu into one library, loaded with
// torch.ops.load_library.  An operator only launches: the Python wrappers
// (ops/mergepath_cuda.py) check the tensors, allocate the outputs and count
// the launch.  Here the keys' card is made current and the C launcher of
// mergepath.cu runs on torch's current stream of that card; an error it
// returns raises.

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <c10/util/Exception.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

#include <cstdint>

extern "C" int mergepath_max_chunk_keys();
extern "C" int mergepath_max_tile_keys();
extern "C" int local_merge_launch(const void* in, void* out, long long n_chunks, int chunk,
                                  int base_run, int top, int per_thread, void* stream);
extern "C" int merge_pass_launch(const void* in, void* out, const void* a0, const void* b0,
                                 long long n_tiles, int tile, unsigned long long run,
                                 int per_thread, void* stream);
extern "C" int merge_splits_launch(const void* key, void* a0, void* b0, void* aend, void* bend,
                                   long long n_tiles, int tile, unsigned long long run,
                                   void* stream);

namespace {

void check_launch(int err, const char* kernel) {
  TORCH_CHECK(err == 0, kernel, " kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

void* current_stream() { return c10::cuda::getCurrentCUDAStream().stream(); }

void local_merge(const at::Tensor& key, at::Tensor& out, int64_t n_chunks, int64_t chunk,
                 int64_t base_run, int64_t top, int64_t per_thread) {
  const c10::cuda::CUDAGuard guard(key.device());
  check_launch(local_merge_launch(key.const_data_ptr(), out.mutable_data_ptr(), n_chunks,
                                  static_cast<int>(chunk), static_cast<int>(base_run),
                                  static_cast<int>(top), static_cast<int>(per_thread),
                                  current_stream()),
               "local_merge");
}

void merge_pass(const at::Tensor& key, at::Tensor& out, const at::Tensor& a0,
                const at::Tensor& b0, int64_t n_tiles, int64_t tile, int64_t run,
                int64_t per_thread) {
  const c10::cuda::CUDAGuard guard(key.device());
  check_launch(merge_pass_launch(key.const_data_ptr(), out.mutable_data_ptr(),
                                 a0.const_data_ptr(), b0.const_data_ptr(), n_tiles,
                                 static_cast<int>(tile), static_cast<unsigned long long>(run),
                                 static_cast<int>(per_thread), current_stream()),
               "merge_pass");
}

void merge_splits(const at::Tensor& key, at::Tensor& a0, at::Tensor& b0, at::Tensor& aend,
                  at::Tensor& bend, int64_t n_tiles, int64_t tile, int64_t run) {
  const c10::cuda::CUDAGuard guard(key.device());
  check_launch(merge_splits_launch(key.const_data_ptr(), a0.mutable_data_ptr(),
                                   b0.mutable_data_ptr(), aend.mutable_data_ptr(),
                                   bend.mutable_data_ptr(), n_tiles, static_cast<int>(tile),
                                   static_cast<unsigned long long>(run), current_stream()),
               "merge_splits");
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(ga_torch, m) {
  m.def("local_merge(Tensor key, Tensor(a!) out, int n_chunks, int chunk, int base_run, "
        "int top, int per_thread) -> ()");
  m.def("merge_pass(Tensor key, Tensor(a!) out, Tensor a0, Tensor b0, int n_tiles, int tile, "
        "int run, int per_thread) -> ()");
  m.def("merge_splits(Tensor key, Tensor(a!) a0, Tensor(b!) b0, Tensor(c!) aend, "
        "Tensor(d!) bend, int n_tiles, int tile, int run) -> ()");
  m.def("mergepath_max_chunk_keys() -> int",
        []() -> int64_t { return mergepath_max_chunk_keys(); });
  m.def("mergepath_max_tile_keys() -> int",
        []() -> int64_t { return mergepath_max_tile_keys(); });
}

TORCH_LIBRARY_IMPL(ga_torch, CUDA, m) {
  m.impl("local_merge", &local_merge);
  m.impl("merge_pass", &merge_pass);
  m.impl("merge_splits", &merge_splits);
}
