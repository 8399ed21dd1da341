// Launch of the fused scan (fast_scan.cu) as torch operators:
//   ga_torch::fast_scan(Tensor codes, Tensor lengths, Tensor(a!) mmer, Tensor(b!) kmer,
//                       Tensor(c!) valid, int batch, int max_len, int k, int m) -> ()
//   ga_torch::fast_scan_max_len() -> int
//
// Host C++ against torch's headers, compiled by csrc/build.py in one nvcc
// call with fast_scan.cu into one library, loaded with
// torch.ops.load_library.  The operator only launches: the Python wrapper
// (ops/minimizer_cuda.py) checks the tensors, allocates the outputs and
// counts the launch.  Here the tensors' card is made current and the C
// launcher of fast_scan.cu runs on torch's current stream of that card; an
// error it returns raises.

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <c10/util/Exception.h>
#include <cuda_runtime_api.h>
#include <torch/library.h>

#include <cstdint>

extern "C" int fast_scan_launch(const void* codes, const void* lengths, void* mmer_out,
                                void* key_out, void* valid_out, int batch, int max_len, int k,
                                int m, void* stream);
extern "C" int fast_scan_max_len();

namespace {

void fast_scan(const at::Tensor& codes, const at::Tensor& lengths, at::Tensor& mmer,
               at::Tensor& kmer, at::Tensor& valid, int64_t batch, int64_t max_len, int64_t k,
               int64_t m) {
  const c10::cuda::CUDAGuard guard(codes.device());
  const int err = fast_scan_launch(
      codes.const_data_ptr(), lengths.const_data_ptr(), mmer.mutable_data_ptr(),
      kmer.mutable_data_ptr(), valid.mutable_data_ptr(), static_cast<int>(batch),
      static_cast<int>(max_len), static_cast<int>(k), static_cast<int>(m),
      c10::cuda::getCurrentCUDAStream().stream());
  TORCH_CHECK(err == 0, "fast_scan kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(ga_torch, m) {
  m.def("fast_scan(Tensor codes, Tensor lengths, Tensor(a!) mmer, Tensor(b!) kmer, "
        "Tensor(c!) valid, int batch, int max_len, int k, int m) -> ()");
  m.def("fast_scan_max_len() -> int", []() -> int64_t { return fast_scan_max_len(); });
}

TORCH_LIBRARY_IMPL(ga_torch, CUDA, m) { m.impl("fast_scan", &fast_scan); }
