// K4: the ADMM shrink step, out = sign(x) * max(|x| - t, 0), elementwise.
//
// Replaces the Pallas TPU kernel src/repro/kernels/soft_threshold.py::
// _soft_threshold_kernel (wrapper soft_threshold_pallas).  x is f32 and
// contiguous, of shape (..., r, c) or (c,); t is one scalar, passed by
// value, or one threshold per leading index and column, a contiguous
// (..., 1, c) row (the scan solver shrinks by 1/rho per machine and column).
//
// What bounds it on an H100: one read and one write of x, 6.4 MB at the
// scan's (20, 200, 200), about 2 us at 3.35 TB/s, so its device work is
// smaller than a launch from Python.  The design keeps the device side to
// one pass of 16-byte accesses and the host side to one C call:
//   * each thread shrinks four consecutive floats as a float4 when c % 4 == 0
//     and x, out and t are 16-byte aligned (the four then share one row of
//     t, read as a float4 through the read-only cache; t is 16 KB at the
//     scan's shape); a scalar path takes every other shape;
//   * the column comes from 32-bit unsigned division (numel < 2^31 is
//     checked by the wrapper), a grid-stride loop over a grid of at most
//     two waves of 132 SMs x 8 blocks;
//   * the arithmetic is the plain version's, operation for operation
//     (torch.sign(x) * torch.clamp_min(|x| - t, 0)), so the result is bit
//     for bit the same, NaN included: sign is 0 for +-0 and NaN, and the
//     clamp keeps a NaN, where fmaxf would drop it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 2 * 132 * 8;

__device__ __forceinline__ float shrink(float x, float t) {
  const float sign = (float)((0.f < x) - (x < 0.f));
  const float v = __fsub_rn(fabsf(x), t);
  const float mag = v != v ? v : fmaxf(v, 0.f);
  return __fmul_rn(sign, mag);
}

// Four floats a thread: x, out and t are 16-byte aligned and c % 4 == 0.
template <bool kPerColumn>
__global__ void __launch_bounds__(kThreads)
soft_threshold_kernel_vec4(const float4* __restrict__ x, const float* __restrict__ t,
                           float4* __restrict__ out, float t_scalar, unsigned n4, unsigned c,
                           unsigned rc) {
  for (unsigned v = blockIdx.x * kThreads + threadIdx.x; v < n4; v += gridDim.x * kThreads) {
    const float4 a = x[v];
    float4 tt = make_float4(t_scalar, t_scalar, t_scalar, t_scalar);
    if (kPerColumn) {
      const unsigned e = 4 * v;
      tt = __ldg(reinterpret_cast<const float4*>(t + (e / rc) * c + e % c));
    }
    out[v] = make_float4(shrink(a.x, tt.x), shrink(a.y, tt.y), shrink(a.z, tt.z),
                         shrink(a.w, tt.w));
  }
}

template <bool kPerColumn>
__global__ void __launch_bounds__(kThreads)
soft_threshold_kernel(const float* __restrict__ x, const float* __restrict__ t,
                      float* __restrict__ out, float t_scalar, unsigned n, unsigned c,
                      unsigned rc) {
  for (unsigned e = blockIdx.x * kThreads + threadIdx.x; e < n; e += gridDim.x * kThreads)
    out[e] = shrink(x[e], kPerColumn ? __ldg(t + (e / rc) * c + e % c) : t_scalar);
}

unsigned blocks(unsigned work) {
  const unsigned b = (work + kThreads - 1) / kThreads;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

}  // namespace

// x, out: numel floats; t: null for the scalar t_scalar, else the (batch, c)
// per-column thresholds; element e of x is in column e % c of matrix e / rc.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int soft_threshold_launch(const float* x, const float* t, float* out, float t_scalar,
                                     int numel, int c, int rc, cudaStream_t stream) {
  if (numel < 0 || c < 1 || rc < c) return (int)cudaErrorInvalidValue;
  if (numel == 0) return 0;
  const bool per_column = t != nullptr;
  const bool vec = c % 4 == 0 &&
                   (((uintptr_t)x | (uintptr_t)out | (uintptr_t)t) & 15) == 0;
  const unsigned n = numel;
  if (vec) {
    const auto* x4 = reinterpret_cast<const float4*>(x);
    auto* out4 = reinterpret_cast<float4*>(out);
    if (per_column)
      soft_threshold_kernel_vec4<true><<<blocks(n / 4), kThreads, 0, stream>>>(
          x4, t, out4, t_scalar, n / 4, c, rc);
    else
      soft_threshold_kernel_vec4<false><<<blocks(n / 4), kThreads, 0, stream>>>(
          x4, t, out4, t_scalar, n / 4, c, rc);
  } else if (per_column) {
    soft_threshold_kernel<true><<<blocks(n), kThreads, 0, stream>>>(x, t, out, t_scalar, n, c,
                                                                   rc);
  } else {
    soft_threshold_kernel<false><<<blocks(n), kThreads, 0, stream>>>(x, t, out, t_scalar, n, c,
                                                                    rc);
  }
  return (int)cudaGetLastError();
}
