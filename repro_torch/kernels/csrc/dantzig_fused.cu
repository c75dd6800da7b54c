// K2: the whole fixed-iteration, cold-start two-block ADMM Dantzig/CLIME
// solve for a batch of machines, in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dantzig_fused.py::
// _fused_admm_kernel (+ _admm_iteration; the fixed branch of
// dantzig_fused_pallas).  Per machine: A (the PSD matrix), its eigenvectors
// Q, inv = 1/(L^2+1), right-hand sides b (d, k), and per-column lam and rho.
// Each iteration is four (d,d)x(d,bk) products, the solve
// Q diag(inv) Q^T, alpha over-relaxation, a box clip to +-lam and a shrink
// by 1/rho.
//
// What bounds it on an H100: the four products, 8 d^2 k FLOP per iteration
// per machine, on the FP32 CUDA cores (TF32 is off: it would break the
// repo's 1e-5 pins).  At the paper's CLIME shape (m = 20, d = k = 200, 500
// iterations) that is 6.4e11 FLOP, about 10 ms at the data sheet's
// 67 TFLOP/s.  Device-memory traffic is negligible; what the design must
// manage instead is on-chip capacity and the re-reads of A and Q.
//
// Design:
//   * grid (column blocks, machines).  A block owns bk columns of one
//     machine and runs every iteration inside the kernel, as the TPU kernel
//     does per grid step; nothing crosses blocks, so there is no
//     cross-block reduction and no ordering assumption.
//   * the (d, W) state -- z, w, u1, u2, b and two product buffers -- lives in
//     shared memory (7 d W floats; W is the compile-time column tile >= bk).
//     A and Q do not fit beside it (2 d^2 floats = 320 KB at d = 200 against
//     227 KB), so they stream from L2 on every iteration: three (m, d, d)
//     operands of 3.2 MB at the paper's shape sit in the 50 MB L2.
//   * every product is written as out[i, c] = sum_kk Mt[kk, i] in[kk, c] so
//     that a warp reads one row of Mt with 32 consecutive addresses: Mt is
//     A^T for A, Q for Q^T, and Q^T for Q (the wrapper passes A^T and Q^T
//     made once per factor).  The in[kk, :] operand is a shared-memory
//     broadcast.
//   * each thread accumulates an R x C micro-tile with fmaf over kk in
//     order, the same chain in every template, and the elementwise update
//     uses __fadd_rn/__fmul_rn (never contracted), so a column's result
//     does not depend on bk, on the tile width, or on whether it sits in the
//     ragged tail block: it is bit-identical.  The tail is masked in the
//     kernel: columns past k load b = 0, lam = 1, rho = 1, stay exactly 0
//     and are never stored.
//   * the elementwise update is fused into the epilogue of the fourth
//     product, which also writes the next iteration's z + b - u1; four
//     __syncthreads per iteration.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float shrink(float x, float t) {
  const float mag = fmaxf(__fsub_rn(fabsf(x), t), 0.f);
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return __fmul_rn(s, mag);
}

// out[i, c] = sum_kk mt[kk * d + i] * in[kk * W + c] for i < d, c < W; each
// result goes to epi(i, c, value).  Threads: RG row groups x CG column groups.
template <int C, int CG, class Epi>
__device__ __forceinline__ void product(const float* __restrict__ mt,
                                        const float* in, int d, Epi epi) {
  constexpr int W = C * CG;
  constexpr int RG = kThreads / CG;
  constexpr int R = CG == 1 ? 1 : 4;
  const int rg = threadIdx.x % RG;
  const int c0 = (threadIdx.x / RG) * C;
  for (int base = 0; base < d; base += RG * R) {
    int rows[R];
    float acc[R][C];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      rows[r] = min(base + rg + r * RG, d - 1);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
    }
#pragma unroll 4
    for (int kk = 0; kk < d; ++kk) {
      const float* mrow = mt + (size_t)kk * d;
      float mv[R], iv[C];
#pragma unroll
      for (int r = 0; r < R; ++r) mv[r] = __ldg(mrow + rows[r]);
#pragma unroll
      for (int c = 0; c < C; ++c) iv[c] = in[kk * W + c0 + c];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = fmaf(mv[r], iv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = base + rg + r * RG;
      if (i < d) {
#pragma unroll
        for (int c = 0; c < C; ++c) epi(i, c0 + c, acc[r][c]);
      }
    }
  }
}

template <int C, int CG>
__global__ void __launch_bounds__(kThreads)
fused_admm_kernel(const float* __restrict__ at, const float* __restrict__ q,
                  const float* __restrict__ qt, const float* __restrict__ inv,
                  const float* __restrict__ b, const float* __restrict__ lam,
                  const float* __restrict__ rho, float* __restrict__ out,
                  int d, int k, int bk, int iters, float alpha, float one_minus_alpha) {
  constexpr int W = C * CG;
  extern __shared__ __align__(16) float smem[];
  const size_t mach = blockIdx.y;
  const int col0 = blockIdx.x * bk;
  const int ncol = min(bk, k - col0);
  const size_t dd = (size_t)d * d;
  at += mach * dd;
  q += mach * dd;
  qt += mach * dd;
  inv += mach * d;
  b += mach * d * k;
  out += mach * d * k;
  lam += mach * k;
  rho += mach * k;

  const int dw = d * W;
  float* z = smem;
  float* w = z + dw;
  float* u1 = w + dw;
  float* u2 = u1 + dw;
  float* bs = u2 + dw;
  float* buf0 = bs + dw;
  float* buf1 = buf0 + dw;
  float* lam_s = buf1 + dw;
  float* irho_s = lam_s + W;

  for (int e = threadIdx.x; e < dw; e += kThreads) {
    const int i = e / W, c = e % W;
    const float bv = c < ncol ? b[(size_t)i * k + col0 + c] : 0.f;
    bs[e] = bv;
    buf0[e] = bv;  // z + b - u1 with the zero cold-start state
    z[e] = 0.f;
    w[e] = 0.f;
    u1[e] = 0.f;
    u2[e] = 0.f;
  }
  for (int c = threadIdx.x; c < W; c += kThreads) {
    const bool live = c < ncol;
    lam_s[c] = live ? lam[col0 + c] : 1.f;
    irho_s[c] = 1.f / (live ? rho[col0 + c] : 1.f);
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // p = A (z + b - u1) + (w - u2)
    product<C, CG>(at, buf0, d, [&](int i, int c, float acc) {
      const int e = i * W + c;
      buf1[e] = __fadd_rn(acc, __fsub_rn(w[e], u2[e]));
    });
    __syncthreads();
    // s = inv * (Q^T p)
    product<C, CG>(q, buf1, d, [&](int i, int c, float acc) {
      buf0[i * W + c] = __fmul_rn(inv[i], acc);
    });
    __syncthreads();
    // beta = Q s
    product<C, CG>(qt, buf0, d, [&](int i, int c, float acc) {
      buf1[i * W + c] = acc;
    });
    __syncthreads();
    // ab = A beta, then the over-relaxed clip / shrink / dual update
    product<C, CG>(at, buf1, d, [&](int i, int c, float ab) {
      const int e = i * W + c;
      const float zo = z[e], wo = w[e], bb = bs[e], u1o = u1[e], u2o = u2[e];
      const float beta = buf1[e];
      const float ab_r = __fadd_rn(__fmul_rn(alpha, ab),
                                   __fmul_rn(one_minus_alpha, __fadd_rn(zo, bb)));
      const float beta_r = __fadd_rn(__fmul_rn(alpha, beta), __fmul_rn(one_minus_alpha, wo));
      const float lm = lam_s[c];
      const float zn = fminf(fmaxf(__fadd_rn(__fsub_rn(ab_r, bb), u1o), -lm), lm);
      const float wn = shrink(__fadd_rn(beta_r, u2o), irho_s[c]);
      const float u1n = __fsub_rn(__fsub_rn(__fadd_rn(u1o, ab_r), zn), bb);
      const float u2n = __fsub_rn(__fadd_rn(u2o, beta_r), wn);
      z[e] = zn;
      w[e] = wn;
      u1[e] = u1n;
      u2[e] = u2n;
      buf0[e] = __fsub_rn(__fadd_rn(zn, bb), u1n);
    });
    __syncthreads();
  }

  for (int e = threadIdx.x; e < dw; e += kThreads) {
    const int i = e / W, c = e % W;
    if (c < ncol) out[(size_t)i * k + col0 + c] = w[e];
  }
}

template <int C, int CG>
int launch(const float* at, const float* q, const float* qt, const float* inv,
           const float* b, const float* lam, const float* rho, float* out, int m,
           int d, int k, int bk, int iters, float alpha, float one_minus_alpha,
           cudaStream_t stream) {
  constexpr int W = C * CG;
  const size_t smem = sizeof(float) * ((size_t)7 * d * W + 2 * W);
  auto kernel = fused_admm_kernel<C, CG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((k + bk - 1) / bk, m);
  kernel<<<grid, kThreads, smem, stream>>>(at, q, qt, inv, b, lam, rho, out, d, k, bk,
                                           iters, alpha, one_minus_alpha);
  return (int)cudaGetLastError();
}

}  // namespace

// width is the compile-time column tile (>= bk); the Python blocking model
// (repro_torch/kernels/dantzig_fused.py) picks it.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int dantzig_fused_launch(const float* at, const float* q, const float* qt,
                                    const float* inv, const float* b, const float* lam,
                                    const float* rho, float* out, int m, int d, int k,
                                    int bk, int width, int iters, float alpha,
                                    float one_minus_alpha, cudaStream_t stream) {
  if (bk < 1 || bk > width) return (int)cudaErrorInvalidValue;
#define FUSED_CASE(WIDTH, C, CG)                                                   \
  case WIDTH:                                                                      \
    return launch<C, CG>(at, q, qt, inv, b, lam, rho, out, m, d, k, bk, iters,    \
                         alpha, one_minus_alpha, stream);
  switch (width) {
    FUSED_CASE(1, 1, 1)
    FUSED_CASE(8, 2, 4)
    FUSED_CASE(16, 4, 4)
    FUSED_CASE(24, 6, 4)
    FUSED_CASE(32, 8, 4)
    FUSED_CASE(40, 10, 4)
    FUSED_CASE(48, 12, 4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FUSED_CASE
}
