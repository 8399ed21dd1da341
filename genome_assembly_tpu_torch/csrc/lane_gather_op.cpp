// Host path of the row-wise lane gather (lane_gather.cu) as a torch operator:
// ga_torch::lane_gather(Tensor x, Tensor idx) -> Tensor.
//
// Host C++ against torch's headers, compiled by csrc/build.py in one nvcc
// call with lane_gather.cu into one library, loaded with
// torch.ops.load_library.  A call from Python crosses into C++ once, through
// torch's dispatcher; the checks, the output's allocation, the card's current
// stream and the launch all run here.  The kernel and its plain C launcher
// stay in lane_gather.cu.
//
// The CUDA kernel of the operator refuses what the launcher does not take
// (ValueError or TypeError in Python) and launches on torch's current stream
// of the tensors' card, under a guard that makes that card current.  It
// allocates only its output, does not synchronise and does not read the
// indices back: an index outside its row gives 0 (the Python dispatcher
// ops/lane_gather.lane_gather refuses such indices before it calls this).
// The CPU kernel refuses CPU tensors with a ValueError, so that a CPU call
// fails as a refusal and not as a missing kernel.
//
// Also registered: lane_gather_launch_count() -> int, the launches since
// the library was loaded or the count was reset (one a launch and nowhere
// else), lane_gather_reset_launch_count(), and
// lane_gather_max_staged_cols(int elem_bytes) -> int.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <c10/util/Exception.h>
#include <torch/library.h>

#include <array>
#include <atomic>
#include <cstdint>

extern "C" int lane_gather_launch(const void* x, const void* idx, void* out, long long rows,
                                  int cols, int elem_bytes, int sms, void* stream);
extern "C" long long lane_gather_max_staged_cols(int elem_bytes);

namespace {

std::atomic<int64_t> launches{0};

// What the gather takes, whatever the device: 2-d arrays of one shape on one
// device, int32 values with int32 indices or int64 with int64.
void check(const at::Tensor& x, const at::Tensor& idx) {
  TORCH_CHECK_VALUE(x.dim() == 2 && idx.sizes() == x.sizes(),
                    "lane_gather needs x and idx of one [rows, cols] shape, got ", x.sizes(),
                    " and ", idx.sizes());
  const auto xt = x.scalar_type();
  const auto it = idx.scalar_type();
  TORCH_CHECK_TYPE((xt == at::kInt && it == at::kInt) || (xt == at::kLong && it == at::kLong),
                   "lane_gather takes int32 values with int32 indices or int64 with int64, got ",
                   xt, " and ", it);
  TORCH_CHECK_VALUE(x.device() == idx.device(), "lane_gather needs x and idx on one device, got ",
                    x.device(), " and ", idx.device());
}

// The multiprocessors of a card, read at its first launch.
int multiprocessors(c10::DeviceIndex card) {
  static std::array<std::atomic<int>, C10_COMPILE_TIME_MAX_GPUS> cache{};
  int sms = cache[card].load(std::memory_order_relaxed);
  if (sms == 0) {
    C10_CUDA_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, card));
    cache[card].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

at::Tensor lane_gather_cuda(const at::Tensor& x, const at::Tensor& idx) {
  check(x, idx);
  TORCH_CHECK_VALUE(x.is_cuda(), "lane_gather_cuda needs CUDA tensors, got ", x.device());
  TORCH_CHECK_VALUE(x.is_contiguous() && idx.is_contiguous(),
                    "lane_gather_cuda needs contiguous tensors");
  const int64_t rows = x.size(0);
  const int64_t cols = x.size(1);
  TORCH_CHECK_VALUE(rows >= 1 && cols >= 1 && cols < (int64_t{1} << 31),
                    "lane_gather_cuda takes rows >= 1 and 1 <= cols < 2^31, got ", x.sizes());
  const c10::DeviceIndex card = x.device().index();
  const c10::cuda::CUDAGuard guard(card);
  at::Tensor out = at::empty_like(x);
  const int err = lane_gather_launch(x.const_data_ptr(), idx.const_data_ptr(),
                                     out.mutable_data_ptr(), rows, static_cast<int>(cols),
                                     static_cast<int>(x.element_size()), multiprocessors(card),
                                     c10::cuda::getCurrentCUDAStream(card).stream());
  TORCH_CHECK(err == 0, "lane_gather kernel launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(err)));
  launches.fetch_add(1, std::memory_order_relaxed);
  return out;
}

at::Tensor lane_gather_cpu(const at::Tensor& x, const at::Tensor& idx) {
  check(x, idx);
  C10_THROW_ERROR(ValueError, c10::str("lane_gather_cuda needs CUDA tensors, got ", x.device()));
}

}  // namespace

TORCH_LIBRARY_FRAGMENT(ga_torch, m) {
  m.def("lane_gather(Tensor x, Tensor idx) -> Tensor");
  m.def("lane_gather_launch_count() -> int",
        []() -> int64_t { return launches.load(std::memory_order_relaxed); });
  m.def("lane_gather_reset_launch_count() -> ()",
        []() { launches.store(0, std::memory_order_relaxed); });
  m.def("lane_gather_max_staged_cols(int elem_bytes) -> int",
        [](int64_t elem_bytes) -> int64_t {
          return lane_gather_max_staged_cols(static_cast<int>(elem_bytes));
        });
}

TORCH_LIBRARY_IMPL(ga_torch, CUDA, m) { m.impl("lane_gather", &lane_gather_cuda); }

TORCH_LIBRARY_IMPL(ga_torch, CPU, m) { m.impl("lane_gather", &lane_gather_cpu); }
