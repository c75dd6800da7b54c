// K1: mean-centered Gram matrix (X - mu)^T (X - mu) for a batch of machines.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram.py::_gram_kernel
// (wrapper gram_pallas).  One launch covers every machine: x (m, n, d),
// mu (m, d) -> out (m, d, d), all f32 and contiguous.
//
// What bounds it on an H100: at the paper's shapes (m = 20, n = 250,
// d = 200) the work is ~2e8 FMA-operations over ~7 MB moved, a few
// microseconds either way, so what counts is keeping every SM busy and the
// loads in flight.  The design, on the FP32 CUDA cores (no tensor cores:
// TF32 would break the repo's 1e-5 pins):
//   * a 32x32 output tile per block, and only the tiles on or above the
//     diagonal are launched: a linear block index maps to (bi, bj), bi <= bj
//     (28 tiles x 20 machines = 560 blocks of 64 threads at d = 200, ~4 per
//     SM, with 2.5% of the FMAs on padding).  An off-diagonal block writes
//     its tile and the mirrored one;
//   * the n axis is a loop inside the block (the TPU's innermost sequential
//     grid axis), over 32-row slabs that cp.async stages into three shared
//     buffers, so the copies of slabs s + 1 and s + 2 run while the FMAs
//     work on slab s, with one __syncthreads a slab (16-byte copies when
//     d % 4 == 0, 4-byte ones otherwise).  Ragged d is zero-filled by the
//     copies and masked in the store; rows past n are skipped;
//   * centering is fused: each thread loads the 4 + 4 entries of mu its
//     micro-tile needs into registers once, and subtracts them from the
//     slab values it reads, so no pass over the shared slab centres it;
//   * each thread sums a 4x4 micro-tile with fmaf over n in order, never
//     split, so an entry's value does not depend on its tile, and (i, j)
//     and (j, i) are bit-identical: the output is exactly symmetric.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kSlab = 32;
constexpr int kStages = 3;    // slabs in flight: s + 1 and s + 2 copy while s computes
constexpr int kThreads = 64;  // 8 x 8 threads, each a 4 x 4 micro-tile

template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned smem = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int src_bytes = valid ? 4 * kVec : 0;  // 0: the copy writes zeros
  if (kVec == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem), "l"(src),
                 "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kVec floats per copy: 4 when d % 4 == 0 and x and out are 16-byte aligned, else 1.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
gram_kernel(const float* __restrict__ x, const float* __restrict__ mu,
            float* __restrict__ out, int n, int d, int nb) {
  // upper-triangle tile blockIdx.x, row-major over (bi, bj) with bi <= bj
  int bi = 0, rem = blockIdx.x;
  while (rem >= nb - bi) {
    rem -= nb - bi;
    ++bi;
  }
  const int bj = bi + rem;
  const bool diag = bi == bj;
  const size_t mach = blockIdx.y;
  x += mach * n * d;
  mu += mach * d;
  out += mach * d * d;
  const int ci = bi * kTile, cj = bj * kTile;  // the tile's first row and column

  // [stage][operand i or j][row][column]; a diagonal tile copies operand i only
  __shared__ __align__(16) float slab[kStages][2][kSlab][kTile];
  constexpr int kRowChunks = kTile / kVec;
  constexpr int kChunks = kSlab * kRowChunks;  // per operand and slab
  const int tid = threadIdx.x, chunks = (diag ? 1 : 2) * kChunks;
  // copies slab s into a stage: thread tid takes chunks tid, tid + kThreads, ...;
  // a slab past the end commits an empty group, so every thread counts groups alike
  auto load = [&](int s, int stage) {
    if (s * kSlab < n) {
      for (int e = tid; e < chunks; e += kThreads) {
        const int op = e / kChunks, r = e % kChunks / kRowChunks;
        const int cc = e % kRowChunks * kVec, row = s * kSlab + r, col = (op ? cj : ci) + cc;
        const bool valid = row < n && col < d;
        cp_async<kVec>(&slab[stage][op][r][cc], valid ? x + (size_t)row * d + col : x, valid);
      }
    }
    cp_async_commit();
  };

  // this thread's micro-tile: rows i..i+3 and columns j..j+3 of the output,
  // centred with its own mu slices, held in registers
  const int i = ci + tid / 8 * 4, j = cj + tid % 8 * 4;
  float mi[4], mj[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    mi[u] = i + u < d ? mu[i + u] : 0.f;
    mj[u] = j + u < d ? mu[j + u] : 0.f;
  }
  float acc[4][4] = {};
  auto fma_row = [&](const float (*a)[kTile], const float (*b)[kTile], int r) {
    const float4 a4 = *reinterpret_cast<const float4*>(&a[r][i - ci]);
    const float4 b4 = *reinterpret_cast<const float4*>(&b[r][j - cj]);
    const float av[4] = {__fsub_rn(a4.x, mi[0]), __fsub_rn(a4.y, mi[1]),
                         __fsub_rn(a4.z, mi[2]), __fsub_rn(a4.w, mi[3])};
    const float bv[4] = {__fsub_rn(b4.x, mj[0]), __fsub_rn(b4.y, mj[1]),
                         __fsub_rn(b4.z, mj[2]), __fsub_rn(b4.w, mj[3])};
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
  };

  const int slabs = (n + kSlab - 1) / kSlab;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load(s, s);
  for (int s = 0; s < slabs; ++s) {
    const int stage = s % kStages;
    cp_async_wait<kStages - 2>();  // this thread's copies of slab s have landed
    // every thread's have, and every thread is done with slab s - 1, whose
    // stage the next copy overwrites
    __syncthreads();
    load(s + kStages - 1, (s + kStages - 1) % kStages);
    const float(*a)[kTile] = slab[stage][0];
    const float(*b)[kTile] = slab[stage][diag ? 0 : 1];
    const int rows = n - s * kSlab;  // the copies zero-fill rows past n: skip them
    if (rows >= kSlab) {
#pragma unroll 8
      for (int r = 0; r < kSlab; ++r) fma_row(a, b, r);
    } else {
      for (int r = 0; r < rows; ++r) fma_row(a, b, r);
    }
  }

  if (kVec == 4) {
    // d % 4 == 0: a 4-float run starting at a multiple of 4 is all in or all out
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u < d && j < d)
        *reinterpret_cast<float4*>(out + (size_t)(i + u) * d + j) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    if (!diag)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (j + v < d && i < d)
          *reinterpret_cast<float4*>(out + (size_t)(j + v) * d + i) =
              make_float4(acc[0][v], acc[1][v], acc[2][v], acc[3][v]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (i + u < d && j + v < d) {
          out[(size_t)(i + u) * d + j + v] = acc[u][v];
          if (!diag) out[(size_t)(j + v) * d + i + u] = acc[u][v];
        }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int gram_launch(const float* x, const float* mu, float* out, int m, int n, int d,
                           cudaStream_t stream) {
  if (m < 1 || n < 1 || d < 1 || m > 65535) return (int)cudaErrorInvalidValue;
  const int nb = (d + kTile - 1) / kTile;
  const dim3 grid(nb * (nb + 1) / 2, m);
  if (d % 4 == 0 && (((uintptr_t)x | (uintptr_t)out) & 15) == 0)
    gram_kernel<4><<<grid, kThreads, 0, stream>>>(x, mu, out, n, d, nb);
  else
    gram_kernel<1><<<grid, kThreads, 0, stream>>>(x, mu, out, n, d, nb);
  return (int)cudaGetLastError();
}
