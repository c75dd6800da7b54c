// K1: mean-centered Gram matrix (X - mu)^T (X - mu) for a batch of machines.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram.py::_gram_kernel
// (wrapper gram_pallas).  One launch covers every machine: x (m, n, d),
// mu (m, d) -> out (m, d, d), all f32 and contiguous.
//
// What bounds it on an H100: at the paper's shapes (n = 250, d = 200) the
// work is ~2e8 FMA-operations over ~7 MB moved, a few microseconds either
// way, so launch latency dominates.  The design is a plain shared-memory
// tiled product on the FP32 CUDA cores (no tensor cores: TF32 would break
// the repo's 1e-5 pins):
//   * grid (d/64, d/64, m); a block owns one 64x64 output tile of one
//     machine and only tiles on or above the diagonal run -- each writes its
//     tile and the mirrored one, so the result is exactly symmetric;
//   * the n axis is a loop inside the block (the TPU's innermost sequential
//     grid axis): 32-row slabs of the centered columns are staged in shared
//     memory, centering fused into the load as on the TPU;
//   * ragged n and d are masked in the load (zeros) instead of the TPU
//     wrapper's mu-padding, and masked in the store;
//   * each of the 256 threads accumulates a 4x4 micro-tile with fmaf over n
//     in order, so a diagonal tile's (i, j) and (j, i) are bit-identical.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kSlab = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x, const float* __restrict__ mu,
            float* __restrict__ out, int n, int d) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bi > bj) return;  // the mirror of an upper tile
  const size_t mach = blockIdx.z;
  x += mach * n * d;
  mu += mach * d;
  out += mach * d * d;

  __shared__ __align__(16) float xi[kSlab][kTile];
  __shared__ __align__(16) float xj[kSlab][kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int i0 = bi * kTile, j0 = bj * kTile;
  float acc[4][4] = {};

  for (int n0 = 0; n0 < n; n0 += kSlab) {
    for (int e = threadIdx.x; e < kSlab * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile, row = n0 + r;
      const int ci = i0 + c, cj = j0 + c;
      const float* xr = x + (size_t)row * d;
      xi[r][c] = (row < n && ci < d) ? __fsub_rn(xr[ci], mu[ci]) : 0.f;
      xj[r][c] = (row < n && cj < d) ? __fsub_rn(xr[cj], mu[cj]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kSlab; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&xi[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&xj[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty * 4 + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx * 4 + v;
      if (i < d && j < d) {
        out[(size_t)i * d + j] = acc[u][v];
        if (bi != bj) out[(size_t)j * d + i] = acc[u][v];
      }
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gram_launch(const float* x, const float* mu, float* out,
                           int m, int n, int d, cudaStream_t stream) {
  const int nb = (d + kTile - 1) / kTile;
  gram_kernel<<<dim3(nb, nb, m), kThreads, 0, stream>>>(x, mu, out, n, d);
  return (int)cudaGetLastError();
}
