// K2 and K3: the whole two-block ADMM Dantzig/CLIME solve for a batch of
// machines, in one launch.
//
// K2 replaces the Pallas TPU kernel src/repro/kernels/dantzig_fused.py::
// _fused_admm_kernel (+ _admm_iteration; the fixed branch of
// dantzig_fused_pallas): a fixed number of iterations from the zero state.
// K3 replaces _fused_admm_state_kernel: the same iteration from a warm
// AdmmState (z, w, u1, u2) read from and written back to device memory, and,
// with a tolerance, check_every-iteration chunks gated by the block's max
// scaled residual, capped at exactly max_iters.  Both are instantiations of
// one kernel template (kState), so K3 at tol = None from the zero state is K2
// bit for bit.
//
// Per machine: A (the PSD matrix), its eigenvectors Q, inv = 1/(L^2+1),
// right-hand sides b (d, k), and per-column lam and rho.  Each iteration is
// four (d,d)x(d,bk) products, the solve Q diag(inv) Q^T, alpha
// over-relaxation, a box clip to +-lam and a shrink by 1/rho.
//
// What bounds it on an H100: the four products, 8 d^2 k FLOP per iteration
// per machine, on the FP32 CUDA cores (TF32 is off: it would break the
// repo's 1e-5 pins).  At the paper's CLIME shape (m = 20, d = k = 200, 500
// iterations) that is 6.4e11 FLOP, about 10 ms at the data sheet's
// 67 TFLOP/s.  K3's residual check adds five products per chunk (one beta
// solve and A dz; the next chunk's first iteration computes the same beta and
// A beta again, so the function itself needs only A dz there), and its state
// I/O 8 m d k floats, 25.6 MB at that shape:
// device-memory traffic stays negligible; what the design must manage
// instead is on-chip capacity and the re-reads of A and Q.
//
// Design:
//   * grid (column blocks, machines).  A block owns bk columns of one
//     machine and runs every iteration inside the kernel, as the TPU kernel
//     does per grid step; nothing crosses blocks, so there is no
//     cross-block reduction and no ordering assumption.  K3's gate is per
//     block, as on the TPU: the whole block stops together.
//   * the (d, W) state -- z, w, u1, u2, b and two product buffers -- lives in
//     shared memory (7 d W floats; W is the compile-time column tile >= bk).
//     A and Q do not fit beside it (2 d^2 floats = 320 KB at d = 200 against
//     227 KB), so they stream from L2 on every iteration: three (m, d, d)
//     operands of 3.2 MB at the paper's shape sit in the 50 MB L2.
//   * K3 keeps no extra (d, W) arrays for the deltas dz, dw of a chunk's last
//     iteration: that iteration stores A beta in a product buffer and runs
//     the update as a separate pass, which then overwrites the two product
//     buffers with dz and dw.  So K3 fits the same 40-column tile as K2 at
//     d = 200 (5 blocks of 40 for k = 200), with one more per-column row
//     (rho, for the dual residual) and a small reduction scratch.
//   * every product is written as out[i, c] = sum_kk Mt[kk, i] in[kk, c] so
//     that a warp reads one row of Mt with 32 consecutive addresses: Mt is
//     A^T for A, Q for Q^T, and Q^T for Q (the wrapper passes A^T and Q^T
//     made once per factor).  The in[kk, :] operand is a shared-memory
//     broadcast.
//   * each thread accumulates an R x C micro-tile with fmaf over kk in
//     order, the same chain in every template.  The products wait on L2
//     (a machine's block streams A and Q row by row), so narrow tiles give
//     each thread one row (R = 1, CG = 1): the k = 8 direction fold then
//     issues one L2 load per kk step and thread, as the k = 1 solve does,
//     where four rows per thread took four times as long.  The chain is
//     the same for every tile, and the elementwise update uses
//     __fadd_rn/__fmul_rn (never contracted), so a column's result does
//     not depend on bk, on the tile width, or on whether it sits in the
//     ragged tail block: it is bit-identical.  The tail is masked in the
//     kernel: columns past k load b = 0, lam = 1, rho = 1 and a zero state,
//     stay exactly 0, add nothing to the residual and are never stored.
//   * the elementwise update is fused into the epilogue of the fourth
//     product, which also writes the next iteration's z + b - u1; four
//     __syncthreads per iteration.
//   * the residual gate: every thread folds its entries into a running max
//     that keeps NaN (as jnp.max does), then a warp-shuffle and
//     shared-memory reduction gives every thread the same value, so all
//     threads take the same exit decision and none is left waiting at a
//     __syncthreads.  A NaN residual ends the loop (res > tol is false).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float shrink(float x, float t) {
  const float mag = fmaxf(__fsub_rn(fabsf(x), t), 0.f);
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  return __fmul_rn(s, mag);
}

// max that keeps NaN, like jnp.maximum (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
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

// One machine's read-only operands, offset to that machine.
struct Operands {
  const float* at;
  const float* q;
  const float* qt;
  const float* inv;
};

// The block's shared-memory arrays: (d, W) each, then per-column rows.
struct Smem {
  float *z, *w, *u1, *u2, *bs, *buf0, *buf1;
  float *lam, *irho, *rho;
};

struct Update {
  float z, w, u1, u2;
};

// The over-relaxed clip / shrink / dual update of one entry, given A beta.
__device__ __forceinline__ Update admm_update(const Smem& s, int e, int c, float ab,
                                              float alpha, float one_minus_alpha) {
  const float zo = s.z[e], wo = s.w[e], bb = s.bs[e], u1o = s.u1[e], u2o = s.u2[e];
  const float beta = s.buf1[e];
  const float ab_r = __fadd_rn(__fmul_rn(alpha, ab),
                               __fmul_rn(one_minus_alpha, __fadd_rn(zo, bb)));
  const float beta_r = __fadd_rn(__fmul_rn(alpha, beta), __fmul_rn(one_minus_alpha, wo));
  const float lm = s.lam[c];
  Update u;
  u.z = fminf(fmaxf(__fadd_rn(__fsub_rn(ab_r, bb), u1o), -lm), lm);
  u.w = shrink(__fadd_rn(beta_r, u2o), s.irho[c]);
  u.u1 = __fsub_rn(__fsub_rn(__fadd_rn(u1o, ab_r), u.z), bb);
  u.u2 = __fsub_rn(__fadd_rn(u2o, beta_r), u.w);
  return u;
}

// buf1 = beta = Q diag(inv) Q^T (A buf0 + (w - u2)), with buf0 = z + b - u1
// on entry; buf0 is scratch afterwards.
template <int C, int CG>
__device__ __forceinline__ void beta_solve(const Operands& g, const Smem& s, int d) {
  constexpr int W = C * CG;
  product<C, CG>(g.at, s.buf0, d, [&](int i, int c, float acc) {
    const int e = i * W + c;
    s.buf1[e] = __fadd_rn(acc, __fsub_rn(s.w[e], s.u2[e]));
  });
  __syncthreads();
  product<C, CG>(g.q, s.buf1, d, [&](int i, int c, float acc) {
    s.buf0[i * W + c] = __fmul_rn(g.inv[i], acc);
  });
  __syncthreads();
  product<C, CG>(g.qt, s.buf0, d, [&](int i, int c, float acc) {
    s.buf1[i * W + c] = acc;
  });
  __syncthreads();
}

// One ADMM iteration.  Without kDeltas the update is fused into the A beta
// product and buf0 ends as the next iteration's z + b - u1; with kDeltas
// (a chunk's last iteration) buf0 ends as dz and buf1 as dw.
template <int C, int CG, bool kDeltas>
__device__ __forceinline__ void iteration(const Operands& g, const Smem& s, int d,
                                          float alpha, float one_minus_alpha) {
  constexpr int W = C * CG;
  beta_solve<C, CG>(g, s, d);
  if (!kDeltas) {
    product<C, CG>(g.at, s.buf1, d, [&](int i, int c, float ab) {
      const int e = i * W + c;
      const Update u = admm_update(s, e, c, ab, alpha, one_minus_alpha);
      s.z[e] = u.z;
      s.w[e] = u.w;
      s.u1[e] = u.u1;
      s.u2[e] = u.u2;
      s.buf0[e] = __fsub_rn(__fadd_rn(u.z, s.bs[e]), u.u1);
    });
    __syncthreads();
    return;
  }
  product<C, CG>(g.at, s.buf1, d, [&](int i, int c, float ab) { s.buf0[i * W + c] = ab; });
  __syncthreads();
  for (int e = threadIdx.x; e < d * W; e += kThreads) {
    const float zo = s.z[e], wo = s.w[e];
    const Update u = admm_update(s, e, e % W, s.buf0[e], alpha, one_minus_alpha);
    s.z[e] = u.z;
    s.w[e] = u.w;
    s.u1[e] = u.u1;
    s.u2[e] = u.u2;
    s.buf0[e] = __fsub_rn(u.z, zo);
    s.buf1[e] = __fsub_rn(u.w, wo);
  }
  __syncthreads();
}

__device__ __forceinline__ void next_input(const Smem& s, int dw) {
  for (int e = threadIdx.x; e < dw; e += kThreads)
    s.buf0[e] = __fsub_rn(__fadd_rn(s.z[e], s.bs[e]), s.u1[e]);
  __syncthreads();
}

// The block's max scaled residual after a chunk, the same in every thread:
// max(max |A beta - z - b|, max |beta - w|, max_c rho_c |A dz + dw|_c) over
// the live columns, with dz in buf0 and dw in buf1 on entry.  Leaves buf0 =
// z + b - u1 for the next chunk.
template <int C, int CG>
__device__ float residual(const Operands& g, const Smem& s, int d, int ncol, float* red) {
  constexpr int W = C * CG;
  float local = 0.f;
  product<C, CG>(g.at, s.buf0, d, [&](int i, int c, float adz) {
    if (c < ncol)
      local = max_nan(local, __fmul_rn(s.rho[c], fabsf(__fadd_rn(adz, s.buf1[i * W + c]))));
  });
  __syncthreads();
  next_input(s, d * W);
  beta_solve<C, CG>(g, s, d);
  product<C, CG>(g.at, s.buf1, d, [&](int i, int c, float ab) {
    if (c < ncol) {
      const int e = i * W + c;
      local = max_nan(local, fabsf(__fsub_rn(__fsub_rn(ab, s.z[e]), s.bs[e])));
      local = max_nan(local, fabsf(__fsub_rn(s.buf1[e], s.w[e])));
    }
  });
  __syncthreads();
  next_input(s, d * W);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    local = max_nan(local, __shfl_xor_sync(0xffffffffu, local, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = local;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = red[0];
    for (int i = 1; i < kWarps; ++i) r = max_nan(r, red[i]);
    red[kWarps] = r;
  }
  __syncthreads();
  return red[kWarps];
}

// K3's warm state in and out, (m, d, k) each, and the (m, blocks) counts.
// The *0 inputs are null for a cold start from the zero state.
struct StateIO {
  const float* z0;
  const float* w0;
  const float* u10;
  const float* u20;
  float* z;
  float* u1;
  float* u2;
  int* iters;
};

template <bool kState>
__host__ __device__ constexpr size_t smem_floats(int d, int width) {
  return (size_t)7 * d * width + (kState ? 3 * width + kWarps + 1 : 2 * width);
}

template <int C, int CG, bool kState>
__global__ void __launch_bounds__(kThreads)
fused_admm_kernel(const float* __restrict__ at, const float* __restrict__ q,
                  const float* __restrict__ qt, const float* __restrict__ inv,
                  const float* __restrict__ b, const float* __restrict__ lam,
                  const float* __restrict__ rho, float* __restrict__ out, StateIO io,
                  int d, int k, int bk, int iters, float alpha, float one_minus_alpha,
                  int has_tol, float tol, int check_every) {
  constexpr int W = C * CG;
  extern __shared__ __align__(16) float smem[];
  const size_t mach = blockIdx.y;
  const int col0 = blockIdx.x * bk;
  const int ncol = min(bk, k - col0);
  const size_t dd = (size_t)d * d;
  const Operands g{at + mach * dd, q + mach * dd, qt + mach * dd, inv + mach * d};
  const size_t cols = mach * d * k;
  b += cols;
  out += cols;
  lam += mach * k;
  rho += mach * k;

  const int dw = d * W;
  Smem s;
  s.z = smem;
  s.w = s.z + dw;
  s.u1 = s.w + dw;
  s.u2 = s.u1 + dw;
  s.bs = s.u2 + dw;
  s.buf0 = s.bs + dw;
  s.buf1 = s.buf0 + dw;
  s.lam = s.buf1 + dw;
  s.irho = s.lam + W;
  s.rho = kState ? s.irho + W : nullptr;
  float* red = kState ? s.rho + W : nullptr;

  const bool warm = kState && io.z0 != nullptr;
  for (int e = threadIdx.x; e < dw; e += kThreads) {
    const int i = e / W, c = e % W;
    const bool live = c < ncol;
    const size_t at_g = (size_t)i * k + col0 + c;
    const float bv = live ? b[at_g] : 0.f;
    s.bs[e] = bv;
    if (warm) {
      const float zv = live ? io.z0[cols + at_g] : 0.f;
      const float u1v = live ? io.u10[cols + at_g] : 0.f;
      s.z[e] = zv;
      s.w[e] = live ? io.w0[cols + at_g] : 0.f;
      s.u1[e] = u1v;
      s.u2[e] = live ? io.u20[cols + at_g] : 0.f;
      s.buf0[e] = __fsub_rn(__fadd_rn(zv, bv), u1v);
    } else {
      s.buf0[e] = bv;  // z + b - u1 with the zero cold-start state
      s.z[e] = 0.f;
      s.w[e] = 0.f;
      s.u1[e] = 0.f;
      s.u2[e] = 0.f;
    }
  }
  for (int c = threadIdx.x; c < W; c += kThreads) {
    const bool live = c < ncol;
    const float r = live ? rho[col0 + c] : 1.f;
    s.lam[c] = live ? lam[col0 + c] : 1.f;
    s.irho[c] = 1.f / r;
    if (kState) s.rho[c] = r;
  }
  __syncthreads();

  int it = 0;
  if (!kState || !has_tol) {
    for (; it < iters; ++it) iteration<C, CG, false>(g, s, d, alpha, one_minus_alpha);
  } else {
    // chunks of check_every iterations, the last one clamped so the cap is
    // exactly iters; res is block-uniform, so every thread leaves together
    float res = __int_as_float(0x7f800000);  // +inf
    while (it < iters && res > tol) {
      const int n = min(check_every, iters - it);
      for (int j = 0; j + 1 < n; ++j) iteration<C, CG, false>(g, s, d, alpha, one_minus_alpha);
      iteration<C, CG, true>(g, s, d, alpha, one_minus_alpha);
      it += n;
      if (it >= iters) break;  // capped: the check would not change the outcome
      res = residual<C, CG>(g, s, d, ncol, red);
    }
  }

  for (int e = threadIdx.x; e < dw; e += kThreads) {
    const int i = e / W, c = e % W;
    if (c < ncol) {
      const size_t at_g = (size_t)i * k + col0 + c;
      out[at_g] = s.w[e];
      if (kState) {
        io.z[cols + at_g] = s.z[e];
        io.u1[cols + at_g] = s.u1[e];
        io.u2[cols + at_g] = s.u2[e];
      }
    }
  }
  if (kState && threadIdx.x == 0) io.iters[mach * gridDim.x + blockIdx.x] = it;
}

template <int C, int CG, bool kState>
int launch(const float* at, const float* q, const float* qt, const float* inv,
           const float* b, const float* lam, const float* rho, float* out, StateIO io,
           int m, int d, int k, int bk, int iters, float alpha, float one_minus_alpha,
           int has_tol, float tol, int check_every, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<kState>(d, C * CG);
  auto kernel = fused_admm_kernel<C, CG, kState>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((k + bk - 1) / bk, m);
  kernel<<<grid, kThreads, smem, stream>>>(at, q, qt, inv, b, lam, rho, out, io, d, k, bk,
                                           iters, alpha, one_minus_alpha, has_tol, tol,
                                           check_every);
  return (int)cudaGetLastError();
}

template <bool kState>
int dispatch(const float* at, const float* q, const float* qt, const float* inv,
             const float* b, const float* lam, const float* rho, float* out, StateIO io,
             int m, int d, int k, int bk, int width, int iters, float alpha,
             float one_minus_alpha, int has_tol, float tol, int check_every,
             cudaStream_t stream) {
  if (bk < 1 || bk > width) return (int)cudaErrorInvalidValue;
#define FUSED_CASE(WIDTH, C, CG)                                                       \
  case WIDTH:                                                                          \
    return launch<C, CG, kState>(at, q, qt, inv, b, lam, rho, out, io, m, d, k, bk,    \
                                 iters, alpha, one_minus_alpha, has_tol, tol,          \
                                 check_every, stream);
  switch (width) {
    FUSED_CASE(1, 1, 1)
    FUSED_CASE(8, 8, 1)
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

}  // namespace

// The launchers.  width is the compile-time column tile (>= bk); the Python
// blocking model (repro_torch/kernels/dantzig_fused.py) picks it and sizes
// the shared memory with the same formula as smem_floats.  Each returns
// cudaGetLastError() after the launch (0 on success).

// K2: iters iterations from the zero state; writes w (m, d, k).
extern "C" int dantzig_fused_launch(const float* at, const float* q, const float* qt,
                                    const float* inv, const float* b, const float* lam,
                                    const float* rho, float* out, int m, int d, int k,
                                    int bk, int width, int iters, float alpha,
                                    float one_minus_alpha, cudaStream_t stream) {
  return dispatch<false>(at, q, qt, inv, b, lam, rho, out, StateIO{}, m, d, k, bk, width,
                         iters, alpha, one_minus_alpha, 0, 0.f, 1, stream);
}

// K3: from the warm state (z0, w0, u10, u20; all null for the zero state),
// max_iters iterations, or with has_tol the residual-gated chunks; writes
// the final state (w, z, u1, u2: (m, d, k)) and the executed iterations of
// every (machine, block), iters_out (m, blocks) int32.
extern "C" int dantzig_fused_state_launch(
    const float* at, const float* q, const float* qt, const float* inv, const float* b,
    const float* lam, const float* rho, const float* z0, const float* w0,
    const float* u10, const float* u20, float* w, float* z, float* u1, float* u2,
    int* iters_out, int m, int d, int k, int bk, int width, int max_iters, float alpha,
    float one_minus_alpha, int has_tol, float tol, int check_every, cudaStream_t stream) {
  if (has_tol && check_every < 1) return (int)cudaErrorInvalidValue;
  const bool warm = z0 != nullptr;
  if (warm != (w0 != nullptr) || warm != (u10 != nullptr) || warm != (u20 != nullptr))
    return (int)cudaErrorInvalidValue;
  const StateIO io{z0, w0, u10, u20, z, u1, u2, iters_out};
  return dispatch<true>(at, q, qt, inv, b, lam, rho, w, io, m, d, k, bk, width, max_iters,
                        alpha, one_minus_alpha, has_tol, tol, check_every, stream);
}
