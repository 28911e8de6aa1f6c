// CUDA kernel and XLA FFI handler for the batched band-local yama DP.
// One warp per problem (yama_dp.cuh); a block holds up to four warps.
//
// Operands (leading dim B = problems in the launch):
//   cstat int32 (B, 12, ncol)   column statistics, ncol = n_pad + 1
//   rstat int32 (B, nrow, 16)   row statistics + LB/RB, nrow = m_pad + 1
//   mnkl  int32 (B, 4)          M, N, K, L (M = 0 marks a padding slot)
// Results:
//   out   uint8 (B, 4 + nscript)  op count + packed edit script
//   flags uint8 (B, nrow, wcap)   traceback flags (scratch)
// Attributes: go, ge (gap open / extend).
#include <cuda_runtime.h>

#include <string>

#define MZ_HD __device__
#include "yama_dp.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

struct CudaWarp {
  __device__ int lane() const { return threadIdx.x & 31; }
  __device__ int32_t shfl_up(int32_t v, int d) const {
    return __shfl_up_sync(0xffffffffu, v, d);
  }
  __device__ int32_t shfl(int32_t v, int src) const {
    return __shfl_sync(0xffffffffu, v, src);
  }
  __device__ void sync() const { __syncwarp(); }
};

__global__ void yama_dp_kernel(const int32_t* __restrict__ cstat,
                               const int32_t* __restrict__ rstat,
                               const int32_t* __restrict__ mnkl,
                               uint8_t* out, uint8_t* flags, int B, int nrow,
                               int ncol, int outw, int wcap, int32_t go,
                               int32_t ge) {
  extern __shared__ int32_t smem[];
  const int wib = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + wib;
  if (b >= B) return;
  mzdp::Problem p;
  p.cstat = cstat + (size_t)b * mzdp::NCSTAT * ncol;
  p.rstat = rstat + (size_t)b * nrow * mzdp::NRSTAT;
  p.flags = flags + (size_t)b * nrow * wcap;
  p.out = out + (size_t)b * outw;
  p.ncol = ncol;
  p.wcap = wcap;
  p.nscript = outw - 4;
  p.M = mnkl[4 * b];
  p.N = mnkl[4 * b + 1];
  p.K = mnkl[4 * b + 2];
  p.L = mnkl[4 * b + 3];
  CudaWarp w;
  mzdp::yama_warp(p, smem + (size_t)wib * 6 * wcap, w, go, ge);
}

ffi::Error YamaDpImpl(cudaStream_t stream, ffi::Buffer<ffi::S32> cstat,
                      ffi::Buffer<ffi::S32> rstat, ffi::Buffer<ffi::S32> mnkl,
                      ffi::ResultBuffer<ffi::U8> out,
                      ffi::ResultBuffer<ffi::U8> flags, int32_t go,
                      int32_t ge) {
  const auto cd = cstat.dimensions();
  const auto rd = rstat.dimensions();
  const auto od = out->dimensions();
  const auto fd = flags->dimensions();
  if (cd.size() != 3 || rd.size() != 3 || od.size() != 2 || fd.size() != 3)
    return ffi::Error::InvalidArgument("mz_yama_dp: bad operand ranks");
  const int B = (int)cd[0], ncol = (int)cd[2], nrow = (int)rd[1];
  const int outw = (int)od[1], wcap = (int)fd[2];
  if (cd[1] != mzdp::NCSTAT || rd[0] != B || rd[2] != mzdp::NRSTAT ||
      od[0] != B || fd[0] != B || fd[1] != nrow ||
      mnkl.element_count() != (size_t)4 * B || outw < 4 || wcap < 32 ||
      (wcap & (wcap - 1)) != 0)
    return ffi::Error::InvalidArgument("mz_yama_dp: bad operand shapes");
  if (B == 0) return ffi::Error::Success();
  const size_t per_warp = (size_t)6 * wcap * sizeof(int32_t);
  int wpb = (int)((48 * 1024) / per_warp);
  wpb = wpb < 1 ? 1 : (wpb > 4 ? 4 : wpb);
  const int grid = (B + wpb - 1) / wpb;
  yama_dp_kernel<<<grid, 32 * wpb, wpb * per_warp, stream>>>(
      cstat.typed_data(), rstat.typed_data(), mnkl.typed_data(),
      out->typed_data(), flags->typed_data(), B, nrow, ncol, outw, wcap, go,
      ge);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("mz_yama_dp: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(MzYamaDp, YamaDpImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::U8>>()
                                  .Attr<int32_t>("go")
                                  .Attr<int32_t>("ge"));
