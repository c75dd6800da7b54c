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
// one template (kState), so K3 at tol = None from the zero state is K2 bit
// for bit.
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
// I/O 8 m d k floats: device-memory traffic stays negligible.  What the
// design must manage is on-chip capacity, the latency of each product's
// in-order sums, and the SMs a launch fills.
//
// Every output entry of a product is one fmaf chain over kk in order,
//   out[i, c] = sum_kk M[i, kk] in[kk, c],
// in both templates below, and the elementwise update uses
// __fadd_rn/__fmul_rn (never contracted).  So a column's result depends on
// neither the column blocking, the tile, the cluster size nor the template:
// the two templates are bit-identical, and a column in the ragged tail block
// equals the same column in a full one.  The tail is masked: columns past k
// load b = 0, lam = 1, rho = 1 and a zero state, stay exactly 0, add nothing
// to the residual and are never stored.  The column blocks (bk columns, in a
// compile-time tile of width W >= bk) come from the Python blocking model,
// which is the same for both templates, so K3's gate groups -- the columns
// that stop together -- do not depend on the template.
//
// Two templates; the Python cluster model (repro_torch/kernels/
// dantzig_fused.py, pick_cluster_size) chooses one per launch shape and
// passes it as `cluster`, and a launch never switches on failure:
//
// THE CLUSTER TEMPLATE (cluster = CS >= 2; d = 200 and every shape whose
// slices fit).  One thread-block cluster of CS blocks per (machine, column
// block), launched by cudaLaunchKernelEx.
//   * The CS blocks split the d output rows: block r owns rows
//     [r rb, r rb + rb), rb = ceil(d / CS), and keeps, for the whole solve,
//     its row slices of the three product matrices resident in shared
//     memory: A[i, kk], Q[kk, i] (the Q^T product) and Q[i, kk] (the Q
//     product) for its rows i, loaded once with 4-byte cp.async copies that
//     also transpose, so the wrapper passes A and Q as they are.  No product
//     touches L2 after that.
//   * Two full (d, W) buffers hold each product's input and output.  A block
//     computes its rows for all W columns from its slices and the full input,
//     and writes its (rb, W) result into the other buffer of every block of
//     the cluster with st.async stores, which count their bytes on that
//     buffer's mbarrier in the receiving block.  A block starts a product
//     once its input buffer's mbarrier has seen all d W entries arrive.  That
//     is the only synchronisation per product: a block receives a fill only
//     after every block has finished the product before, the last to read the
//     buffer being filled.  (The first version synchronised with a cluster
//     barrier per product, which nvcc precedes with a GPU-scope fence; it
//     was slower at three of the four main shapes; PERF.md has the times.)
//   * A thread owns one fixed micro-tile of its block's rows for the whole
//     solve, and its entries' state z, w, u1, u2, b (and K3's dw) live in its
//     registers, with its columns' lam, 1/rho, rho and its rows' inv.  Two
//     tiles, the first whose tiles all get one of the 256 threads:
//       kRow, 1 x 1, up to 16 columns (k = 1, the lambda path's k = 8 fold):
//       row-major slices and column-major buffers, so a 16-byte load brings
//       four kk of each operand and the in-order chain's latency sets the
//       pace (d dependent fmaf per product);
//       kBlock, 2 x 4 (the CLIME block): kk-major slices and row-major
//       buffers, one 8-byte and one 16-byte shared load per 8 FMAs, 2-row
//       groups fastest across threads.  Shared-memory loads set its pace:
//       3 bytes per FMA against an SM's 128 bytes and 128 FMAs a cycle.
//       Larger tiles load less per FMA but leave too few warps to hide the
//       loads' latency at ~50 rows a block; they ran slower in the design
//       runs.
//     Rows past the block's slice are masked, not clamped: no entry is
//     computed twice.
//   * K3's gate: each block reduces its residual max (warp shuffles, then
//     shared memory) and writes it into a slot of every block's shared
//     memory; after a cluster barrier each block folds the CS values in rank
//     order, so every thread of the cluster takes the same exit; a NaN
//     residual ends the loop (res > tol is false).  The count of a
//     (machine, block) is written once, by the cluster's rank 0.
//   * The first iteration's input z + b - u1 is read by every block, for all
//     rows, from device memory; afterwards each block reads and writes only
//     its own rows' state.
//
// THE STREAMED TEMPLATE (cluster = 0; where the slices do not fit a block
// even at CS = 16: d >= 545 at k = 1).
//   * grid (column blocks, machines), one block of 256 threads per
//     (machine, column block), nothing shared across blocks; A, A^T-major Q
//     and Q^T stream from L2 on every product: the wrapper passes A^T and
//     Q^T, made once per call, so that a warp reads one row of Mt with 32
//     consecutive addresses;
//   * a thread owns rows t, t + 256, ... and all W columns of each, so each
//     element of Mt is fetched from L2 once per block and product and feeds
//     W FMAs: 4 / W bytes of L2 an FMA (1/6 at W = 24; the first port's
//     8-column tile read 1/2).  A thread computes two of its rows at once
//     (W <= 24) and keeps 8 loads of Mt in flight ahead of its FMAs (32 at
//     W = 1), a ring of registers; rows past d are clamped to d - 1
//     (recomputed, never stored);
//   * shared memory holds only the two (d, W) product buffers and the
//     per-column lam, 1/rho (K3: rho, a reduction scratch): 4 (2 d W + 2 W)
//     bytes, so W = 24 fits at d = 1,000 (192 KB);
//   * the state z, w, u1, u2 and b lives in device memory, in a scratch the
//     wrapper allocates: five (W, d) column-major slabs per (machine, column
//     block), entry (i, c) at c d + i, so a warp's 32 rows are one 128-byte
//     line.  Only the thread that owns an entry touches it: w - u2 in the
//     first product's epilogue, the update in the fourth's, ~11 accesses an
//     entry an iteration (11 d W floats against the 4 d^2 the products
//     stream), with evict-first loads and stores so that they do not push the
//     matrices out of L2.  The kernel fills the slabs itself (b, the zero or
//     warm state) and writes w (K3: z, u1, u2) out at the end;
//   * the update is fused into the fourth product's epilogue; four
//     __syncthreads per iteration; K3 keeps its chunk deltas dz, dw in the
//     two product buffers.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// ---- the streamed template -------------------------------------------------

// The product's register tiling, from timings on the card at d = 1,000
// (PERF.md): a thread computes kRows rows of its tile at once (two, where
// their 2 W accumulators fit beside the rest), and its loads of Mt run
// ahead_rows rows ahead of its FMAs (32 at W = 1, whose single FMA a load
// hides nothing, else 8).
template <int W>
__host__ __device__ constexpr int rows_at_once() { return W <= 24 ? 2 : 1; }
template <int W>
__host__ __device__ constexpr int ahead_rows() { return W == 1 ? 32 : 8; }

// W floats of a product buffer's row, in 16-byte shared loads where W allows
template <int W>
__device__ __forceinline__ void load_row(const float* p, float (&v)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int c = 0; c < W; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + c);
      v[c] = x.x, v[c + 1] = x.y, v[c + 2] = x.z, v[c + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < W; ++c) v[c] = p[c];
  }
}

// out[i, c] = sum_kk mt[kk * d + i] * in[kk * W + c] for i < d, c < W; each
// result goes to epi(i, c, value).  Thread t owns rows t, t + kThreads, ... and
// all W columns of each, kRows rows at once, so the block loads each element
// of Mt once a product and each load feeds W FMAs; a warp's load is one
// 128-byte line of a row of Mt.  Rows past d load row d - 1 and are never
// stored.
template <int W, class Epi>
__device__ __forceinline__ void product(const float* __restrict__ mt, const float* in, int d,
                                        Epi epi) {
  constexpr int kAhead = ahead_rows<W>();
  constexpr int kRows = rows_at_once<W>();
  for (int base = 0; base < d; base += kRows * kThreads) {
    const float* mp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      mp[r] = mt + min(base + (int)threadIdx.x + r * kThreads, d - 1);
    auto row = [&](int r, int kk) { return __ldg(mp[r] + (size_t)min(kk, d - 1) * d); };
    float acc[kRows][W], ahead[kAhead][kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < W; ++c) acc[r][c] = 0.f;
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
#pragma unroll
      for (int r = 0; r < kRows; ++r) ahead[u][r] = row(r, u);
    // the FMAs of row kk, whose loads sit in slot; the slot then loads row kk + kAhead
    auto step = [&](int kk, float (&slot)[kRows]) {
      float iv[W], mv[kRows];
      load_row<W>(in + kk * W, iv);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        mv[r] = slot[r];
        slot[r] = row(r, kk + kAhead);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < W; ++c) acc[r][c] = fmaf(mv[r], iv[c], acc[r][c]);
    };
    int kk = 0;
    for (; kk + kAhead <= d; kk += kAhead) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) step(kk + u, ahead[u]);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (kk + u < d) step(kk + u, ahead[u]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = base + threadIdx.x + r * kThreads;
      if (i < d) {
#pragma unroll
        for (int c = 0; c < W; ++c) epi(i, c, acc[r][c]);
      }
    }
  }
}

// f(i, c) on every entry the thread owns in product: rows threadIdx.x +
// kThreads j, every column
template <int W, class F>
__device__ __forceinline__ void each_entry(int d, F f) {
  for (int i = threadIdx.x; i < d; i += kThreads)
    for (int c = 0; c < W; ++c) f(i, c);
}

// One machine's read-only operands, offset to that machine.
struct Operands {
  const float* at;
  const float* q;
  const float* qt;
  const float* inv;
};

// The block's state in device memory: five (W, d) column-major slabs of the
// launch's scratch, entry (i, c) at c d + i, so a warp's 32 rows are one
// 128-byte line.  Only the thread that owns an entry touches it.
struct State {
  float *z, *w, *u1, *u2, *b;
};
constexpr int kStateSlabs = 5;

// The block's shared memory: the two (d, W) product buffers, row-major, and
// per-column rows.
struct Smem {
  float *buf0, *buf1;
  float *lam, *irho, *rho;
};

// The state's loads and stores are evict-first (ld/st.global.cs), so that they
// do not push A^T, Q and Q^T out of L2.
__device__ __forceinline__ float ld_state(const float* p) { return __ldcs(p); }
__device__ __forceinline__ void st_state(float* p, float v) { __stcs(p, v); }

struct Entry {
  float z, w, u1, u2, b;
};

__device__ __forceinline__ Entry load_entry(const State& st, size_t e) {
  return {ld_state(st.z + e), ld_state(st.w + e), ld_state(st.u1 + e), ld_state(st.u2 + e),
          ld_state(st.b + e)};
}

// b is written once, in the prologue
__device__ __forceinline__ void store_entry(const State& st, size_t e, const Entry& v) {
  st_state(st.z + e, v.z);
  st_state(st.w + e, v.w);
  st_state(st.u1 + e, v.u1);
  st_state(st.u2 + e, v.u2);
}

// The over-relaxed clip / shrink / dual update of one entry o, given A beta
// and beta.
__device__ __forceinline__ Entry admm_update(const Entry& o, float ab, float beta, float lm,
                                             float irho, float alpha, float one_minus_alpha) {
  const float ab_r = __fadd_rn(__fmul_rn(alpha, ab),
                               __fmul_rn(one_minus_alpha, __fadd_rn(o.z, o.b)));
  const float beta_r = __fadd_rn(__fmul_rn(alpha, beta), __fmul_rn(one_minus_alpha, o.w));
  Entry u;
  u.z = fminf(fmaxf(__fadd_rn(__fsub_rn(ab_r, o.b), o.u1), -lm), lm);
  u.w = shrink(__fadd_rn(beta_r, o.u2), irho);
  u.u1 = __fsub_rn(__fsub_rn(__fadd_rn(o.u1, ab_r), u.z), o.b);
  u.u2 = __fsub_rn(__fadd_rn(o.u2, beta_r), u.w);
  u.b = o.b;
  return u;
}

__device__ __forceinline__ size_t slab_at(int d, int i, int c) { return (size_t)c * d + i; }

// buf1 = beta = Q diag(inv) Q^T (A buf0 + (w - u2)), with buf0 = z + b - u1
// on entry; buf0 is scratch afterwards.
template <int W>
__device__ __forceinline__ void beta_solve(const Operands& g, const State& st, const Smem& s,
                                           int d) {
  product<W>(g.at, s.buf0, d, [&](int i, int c, float acc) {
    const size_t e = slab_at(d, i, c);
    s.buf1[i * W + c] = __fadd_rn(acc, __fsub_rn(ld_state(st.w + e), ld_state(st.u2 + e)));
  });
  __syncthreads();
  product<W>(g.q, s.buf1, d, [&](int i, int c, float acc) {
    s.buf0[i * W + c] = __fmul_rn(g.inv[i], acc);
  });
  __syncthreads();
  product<W>(g.qt, s.buf0, d, [&](int i, int c, float acc) { s.buf1[i * W + c] = acc; });
  __syncthreads();
}

// One ADMM iteration.  Without kDeltas the update is fused into the A beta
// product and buf0 ends as the next iteration's z + b - u1; with kDeltas
// (a chunk's last iteration) buf0 ends as dz and buf1 as dw.
template <int W, bool kDeltas>
__device__ __forceinline__ void iteration(const Operands& g, const State& st, const Smem& s,
                                          int d, float alpha, float one_minus_alpha) {
  beta_solve<W>(g, st, s, d);
  if (!kDeltas) {
    product<W>(g.at, s.buf1, d, [&](int i, int c, float ab) {
      const size_t e = slab_at(d, i, c);
      const Entry u = admm_update(load_entry(st, e), ab, s.buf1[i * W + c], s.lam[c],
                                  s.irho[c], alpha, one_minus_alpha);
      store_entry(st, e, u);
      s.buf0[i * W + c] = __fsub_rn(__fadd_rn(u.z, u.b), u.u1);
    });
    __syncthreads();
    return;
  }
  product<W>(g.at, s.buf1, d, [&](int i, int c, float ab) { s.buf0[i * W + c] = ab; });
  __syncthreads();
  each_entry<W>(d, [&](int i, int c) {
    const size_t e = slab_at(d, i, c);
    const int x = i * W + c;
    const Entry o = load_entry(st, e);
    const Entry u = admm_update(o, s.buf0[x], s.buf1[x], s.lam[c], s.irho[c], alpha,
                                one_minus_alpha);
    store_entry(st, e, u);
    s.buf0[x] = __fsub_rn(u.z, o.z);
    s.buf1[x] = __fsub_rn(u.w, o.w);
  });
  __syncthreads();
}

template <int W>
__device__ __forceinline__ void next_input(const State& st, const Smem& s, int d) {
  each_entry<W>(d, [&](int i, int c) {
    const size_t e = slab_at(d, i, c);
    s.buf0[i * W + c] =
        __fsub_rn(__fadd_rn(ld_state(st.z + e), ld_state(st.b + e)), ld_state(st.u1 + e));
  });
  __syncthreads();
}

// The block's max scaled residual after a chunk, the same in every thread:
// max(max |A beta - z - b|, max |beta - w|, max_c rho_c |A dz + dw|_c) over
// the live columns, with dz in buf0 and dw in buf1 on entry.  Leaves buf0 =
// z + b - u1 for the next chunk.
template <int W>
__device__ float residual(const Operands& g, const State& st, const Smem& s, int d, int ncol,
                          float* red) {
  float local = 0.f;
  product<W>(g.at, s.buf0, d, [&](int i, int c, float adz) {
    if (c < ncol)
      local = max_nan(local, __fmul_rn(s.rho[c], fabsf(__fadd_rn(adz, s.buf1[i * W + c]))));
  });
  __syncthreads();
  next_input<W>(st, s, d);
  beta_solve<W>(g, st, s, d);
  product<W>(g.at, s.buf1, d, [&](int i, int c, float ab) {
    if (c < ncol) {
      const size_t e = slab_at(d, i, c);
      local = max_nan(local,
                      fabsf(__fsub_rn(__fsub_rn(ab, ld_state(st.z + e)), ld_state(st.b + e))));
      local = max_nan(local, fabsf(__fsub_rn(s.buf1[i * W + c], ld_state(st.w + e))));
    }
  });
  __syncthreads();
  next_input<W>(st, s, d);
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
  return (size_t)2 * d * width + (kState ? 3 * width + kWarps + 1 : 2 * width);
}

template <int W, bool kState>
__global__ void __launch_bounds__(kThreads)
fused_admm_kernel(const float* __restrict__ at, const float* __restrict__ q,
                  const float* __restrict__ qt, const float* __restrict__ inv,
                  const float* __restrict__ b, const float* __restrict__ lam,
                  const float* __restrict__ rho, float* __restrict__ out,
                  float* __restrict__ scratch, StateIO io, int d, int k, int bk, int iters,
                  float alpha, float one_minus_alpha, int has_tol, float tol, int check_every) {
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

  const size_t dw = (size_t)d * W;
  float* slab = scratch + (mach * gridDim.x + blockIdx.x) * kStateSlabs * dw;
  const State st{slab, slab + dw, slab + 2 * dw, slab + 3 * dw, slab + 4 * dw};
  Smem s;
  s.buf0 = smem;
  s.buf1 = s.buf0 + dw;
  s.lam = s.buf1 + dw;
  s.irho = s.lam + W;
  s.rho = kState ? s.irho + W : nullptr;
  float* red = kState ? s.rho + W : nullptr;

  // the state slabs: b and the zero or warm state, past the live columns 0;
  // and the first input z + b - u1
  const bool warm = kState && io.z0 != nullptr;
  each_entry<W>(d, [&](int i, int c) {
    const bool live = c < ncol;
    const size_t at_g = (size_t)i * k + col0 + c;
    const bool in = warm && live;
    Entry v;
    v.b = live ? b[at_g] : 0.f;
    v.z = in ? io.z0[cols + at_g] : 0.f;
    v.w = in ? io.w0[cols + at_g] : 0.f;
    v.u1 = in ? io.u10[cols + at_g] : 0.f;
    v.u2 = in ? io.u20[cols + at_g] : 0.f;
    const size_t e = slab_at(d, i, c);
    store_entry(st, e, v);
    st_state(st.b + e, v.b);
    // z + b - u1 with the zero cold-start state is b
    s.buf0[i * W + c] = warm ? __fsub_rn(__fadd_rn(v.z, v.b), v.u1) : v.b;
  });
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
    for (; it < iters; ++it) iteration<W, false>(g, st, s, d, alpha, one_minus_alpha);
  } else {
    // chunks of check_every iterations, the last one clamped so the cap is
    // exactly iters; res is block-uniform, so every thread leaves together
    float res = __int_as_float(0x7f800000);  // +inf
    while (it < iters && res > tol) {
      const int n = min(check_every, iters - it);
      for (int j = 0; j + 1 < n; ++j) iteration<W, false>(g, st, s, d, alpha, one_minus_alpha);
      iteration<W, true>(g, st, s, d, alpha, one_minus_alpha);
      it += n;
      if (it >= iters) break;  // capped: the check would not change the outcome
      res = residual<W>(g, st, s, d, ncol, red);
    }
  }

  each_entry<W>(d, [&](int i, int c) {
    if (c >= ncol) return;
    const size_t at_g = (size_t)i * k + col0 + c;
    const size_t e = slab_at(d, i, c);
    out[at_g] = ld_state(st.w + e);
    if (kState) {
      io.z[cols + at_g] = ld_state(st.z + e);
      io.u1[cols + at_g] = ld_state(st.u1 + e);
      io.u2[cols + at_g] = ld_state(st.u2 + e);
    }
  });
  if (kState && threadIdx.x == 0) io.iters[mach * gridDim.x + blockIdx.x] = it;
}

template <int W, bool kState>
int launch_streamed(const float* at, const float* q, const float* qt, const float* inv,
                    const float* b, const float* lam, const float* rho, float* out,
                    float* scratch, StateIO io, int m, int d, int k, int bk, int iters,
                    float alpha, float one_minus_alpha, int has_tol, float tol, int check_every,
                    cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<kState>(d, W);
  auto kernel = fused_admm_kernel<W, kState>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((k + bk - 1) / bk, m);
  kernel<<<grid, kThreads, smem, stream>>>(at, q, qt, inv, b, lam, rho, out, scratch, io, d, k,
                                           bk, iters, alpha, one_minus_alpha, has_tol, tol,
                                           check_every);
  return (int)cudaGetLastError();
}

template <bool kState>
int dispatch_streamed(const float* at, const float* q, const float* qt, const float* inv,
                      const float* b, const float* lam, const float* rho, float* out,
                      float* scratch, StateIO io, int m, int d, int k, int bk, int width,
                      int iters, float alpha, float one_minus_alpha, int has_tol, float tol,
                      int check_every, cudaStream_t stream) {
  if (bk < 1 || bk > width) return (int)cudaErrorInvalidValue;
#define FUSED_CASE(WIDTH)                                                                    \
  case WIDTH:                                                                                \
    return launch_streamed<WIDTH, kState>(at, q, qt, inv, b, lam, rho, out, scratch, io, m, d, \
                                          k, bk, iters, alpha, one_minus_alpha, has_tol, tol, \
                                          check_every, stream);
  switch (width) {
    FUSED_CASE(1)
    FUSED_CASE(8)
    FUSED_CASE(16)
    FUSED_CASE(24)
    FUSED_CASE(32)
    FUSED_CASE(40)
    FUSED_CASE(48)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FUSED_CASE
}

// ---- the cluster template -------------------------------------------------

constexpr int kMaxCluster = 16;

// n floats rounded up to whole 16-byte chunks, so every array starts aligned
__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// output rows per block of a cluster of cs
__host__ __device__ constexpr int slice_rows(int d, int cs) { return (d + cs - 1) / cs; }

// The two micro-tiles.  kRow (1 x 1, up to 16 columns): a thread owns one
// entry; the resident slices are row-major, M[il][kk], with a row stride of
// an odd number of 16-byte chunks (conflict-free 16-byte loads across rows),
// and the product buffers column-major, in[c][kk], so one 16-byte load brings
// four kk of each operand.  kBlock (2 x 4): a thread owns 2 rows x 4
// columns; the slices are kk-major, M[kk][il], and the buffers row-major,
// in[kk][c], so one 8-byte and one 16-byte load feed 8 FMAs.  tile_kind
// takes kRow where its tiles fit the block's threads, else kBlock, else none.
enum TileKind { kNone = 0, kRow = 1, kBlock = 2 };

__host__ __device__ constexpr int tile_kind(int d, int width, int cs) {
  return (width <= 16 && slice_rows(d, cs) * width <= kThreads) ? kRow
         : (width % 4 == 0 && (slice_rows(d, cs) + 1) / 2 * (width / 4) <= kThreads)
             ? kBlock
             : kNone;
}

// the resident slices' stride: kRow per row (kk), kBlock per kk (rows)
__host__ __device__ constexpr int slice_stride(int d, int cs, int kind) {
  return kind == kRow ? round4(d) + ((round4(d) / 4) % 2 == 0 ? 4 : 0)
                      : (slice_rows(d, cs) + 1) / 2 * 2;
}

__host__ __device__ constexpr int slice_floats(int d, int cs, int kind) {
  return kind == kRow ? slice_rows(d, cs) * slice_stride(d, cs, kind)
                      : round4(d * slice_stride(d, cs, kind));
}

__host__ __device__ constexpr int buffer_floats(int d, int width, int kind) {
  return kind == kRow ? width * round4(d) : round4(d * width);
}

// three resident slices, two product buffers, and K3's reduction scratch: a
// partial per warp and one value per cluster block (the two mbarriers are
// static shared memory)
template <bool kState>
__host__ __device__ constexpr size_t cluster_smem_floats(int d, int width, int cs, int kind) {
  return 3 * (size_t)slice_floats(d, cs, kind) + 2 * (size_t)buffer_floats(d, width, kind) +
         (kState ? round4(kWarps + kMaxCluster) : 0);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// the same shared-memory address in cluster block `rank`
__device__ __forceinline__ unsigned peer_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

// the one arrival of a phase, with the bytes the phase waits for
__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 st, [%0], "
      "%1;\n}" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
      "p, [%0], %1;\n @!p bra WAIT_%=;\n}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// a store into another block's shared memory that counts its bytes on that
// block's mbarrier
__device__ __forceinline__ void st_async(unsigned a, const float (&v)[1], unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];" ::"r"(a),
      "f"(v[0]), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void st_async(unsigned a, const float (&v)[4], unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(a),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void load(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    static_assert(N == 2, "micro-tiles load 2 or 4 floats");
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x, v[1] = x.y;
  }
}

// acc = sum_kk M[rl0 + r, kk] in[kk, c0 + c] from the resident slice sm (stride
// sp) and the input buffer in: one in-order fmaf chain per entry, the
// streamed template's chain
template <int kKind>
__device__ __forceinline__ void tile_product(const float* sm, int sp, const float* in, int w,
                                             int dp, int d, int rl0, int c0,
                                             float (&acc)[kKind == kRow ? 1 : 2]
                                                        [kKind == kRow ? 1 : 4]) {
  if constexpr (kKind == kRow) {
    const float* mp = sm + rl0 * sp;
    const float* ip = in + c0 * dp;
    float a = 0.f;
    int kk = 0;
#pragma unroll 10
    for (; kk + 4 <= d; kk += 4) {
      const float4 m = *reinterpret_cast<const float4*>(mp + kk);
      const float4 x = *reinterpret_cast<const float4*>(ip + kk);
      a = fmaf(m.x, x.x, a);
      a = fmaf(m.y, x.y, a);
      a = fmaf(m.z, x.z, a);
      a = fmaf(m.w, x.w, a);
    }
    for (; kk < d; ++kk) a = fmaf(mp[kk], ip[kk], a);
    acc[0][0] = a;
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    const float* mp = sm + rl0;
    const float* ip = in + c0;
#pragma unroll 4
    for (int kk = 0; kk < d; ++kk, mp += sp, ip += w) {
      float mv[2], iv[4];
      load<2>(mp, mv);
      load<4>(ip, iv);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(mv[r], iv[c], acc[r][c]);
    }
  }
}

// One block an SM is the design point at the CLIME shape (the slices fill
// the shared memory); with this hint nvcc schedules every product's loads
// further ahead: the k = 1 solve ran 1.9x faster on the card (PERF.md).
template <int kKind, bool kState>
__global__ void __launch_bounds__(kThreads, 1)
cluster_fused_admm_kernel(const float* __restrict__ a, const float* __restrict__ q,
                          const float* __restrict__ inv, const float* __restrict__ b,
                          const float* __restrict__ lam, const float* __restrict__ rho,
                          float* __restrict__ out, StateIO io, int d, int k, int bk, int w,
                          int iters, float alpha, float one_minus_alpha, int has_tol, float tol,
                          int check_every) {
  constexpr int R = kKind == kRow ? 1 : 2;
  constexpr int C = kKind == kRow ? 1 : 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const size_t mach = blockIdx.y;
  const int blk = blockIdx.x / cs;
  const int col0 = blk * bk;
  const int ncol = min(bk, k - col0);
  const int rb = slice_rows(d, cs);
  const int row0 = rank * rb;
  const int nrows = max(0, min(rb, d - row0));
  const size_t dd = (size_t)d * d;
  a += mach * dd;
  q += mach * dd;
  inv += mach * d;
  const size_t cols = mach * d * k;
  b += cols;
  out += cols;
  lam += mach * k;
  rho += mach * k;

  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) unsigned long long bars[2];  // a fill of each product buffer
  const int slice = slice_floats(d, cs, kKind);
  const int sp = slice_stride(d, cs, kKind);
  const int dp = round4(d);
  const int bsize = buffer_floats(d, w, kKind);
  float* sa = smem;        // A's rows:   kRow sa[il sp + kk], kBlock sa[kk sp + il] = A[row0 + il, kk]
  float* sq = sa + slice;  // Q's columns (the Q^T product): Q[kk, row0 + il]
  float* sqt = sq + slice; // Q's rows (the Q product):      Q[row0 + il, kk]
  float* bufs = sqt + slice;  // two product buffers of bsize
  float* red = bufs + 2 * bsize;
  // entry (i, c) of a product buffer
  auto cell = [&](int i, int c) { return kKind == kRow ? c * dp + i : i * w + c; };
  auto slot = [&](int il, int kk) { return kKind == kRow ? il * sp + kk : kk * sp + il; };

  // the resident slices; the copy does the transposes
  for (int e = threadIdx.x; e < nrows * d; e += kThreads) {
    const int il = e / d, kk = e % d;
    const size_t g = (size_t)(row0 + il) * d + kk;
    cp_async4(sa + slot(il, kk), a + g);
    cp_async4(sqt + slot(il, kk), q + g);
  }
  for (int e = threadIdx.x; e < nrows * d; e += kThreads) {
    const int kk = e / nrows, il = e % nrows;
    cp_async4(sq + slot(il, kk), q + (size_t)kk * d + row0 + il);
  }
  if constexpr (kKind == kBlock) {  // the odd row of the last 2-row tile
    const int pad = sp - nrows;
    for (int e = threadIdx.x; e < pad * d; e += kThreads) {
      const int s = slot(nrows + e % pad, e / pad);
      sa[s] = 0.f;
      sq[s] = 0.f;
      sqt[s] = 0.f;
    }
  }

  // the first input z + b - u1, every row, from device memory
  const bool warm = kState && io.z0 != nullptr;
  for (int e = threadIdx.x; e < d * w; e += kThreads) {
    const int i = e / w, c = e % w;
    float v = 0.f;
    if (c < ncol) {
      const size_t g = (size_t)i * k + col0 + c;
      v = b[g];
      if (warm) v = __fsub_rn(__fadd_rn(io.z0[cols + g], v), io.u10[cols + g]);
    }
    bufs[cell(i, c)] = v;
  }

  // the thread's micro-tile: kRow rows fastest, one entry; kBlock 2-row
  // groups fastest, 2 x 4 entries
  const int t = threadIdx.x;
  const int groups = kKind == kRow ? rb : (rb + 1) / 2;
  const int rl0 = (t % groups) * R;
  const int c0 = (t / groups) * C;
  const bool active = t < groups * (w / C) && rl0 < nrows;
  float z[R][C], wv[R][C], u1[R][C], u2[R][C], bv[R][C], dw[R][C];
  float lm[C], irho[C], rh[C], iv[R];
  bool live[R];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const bool lc = active && c0 + c < ncol;
    const float r = lc ? rho[col0 + c0 + c] : 1.f;
    lm[c] = lc ? lam[col0 + c0 + c] : 1.f;
    irho[c] = 1.f / r;
    rh[c] = r;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    live[r] = active && rl0 + r < nrows;
    const int i = row0 + rl0 + r;
    iv[r] = live[r] ? inv[i] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const bool on = live[r] && c0 + c < ncol;
      const size_t g = (size_t)i * k + col0 + c0 + c;
      bv[r][c] = on ? b[g] : 0.f;
      z[r][c] = on && warm ? io.z0[cols + g] : 0.f;
      wv[r][c] = on && warm ? io.w0[cols + g] : 0.f;
      u1[r][c] = on && warm ? io.u10[cols + g] : 0.f;
      u2[r][c] = on && warm ? io.u20[cols + g] : 0.f;
      dw[r][c] = 0.f;
    }
  }
  const unsigned bar0 = smem_addr(&bars[0]);  // buffer j's at bar0 + 8 j
  if (t == 0) {
    bar_init(bar0);
    bar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cp_async_wait_all();
  cluster.sync();  // every block's slices, buffers and barriers ready

  // Stages: each product reads buffer cur and writes its results, from every
  // block, into buffer cur ^ 1 of every block.  A block waits for a buffer's
  // fill on that buffer's mbarrier, which counts the bytes the st.async
  // stores deliver: all d x w entries.  Receiving a fill means every block
  // has finished the stage before it, which read the buffer the next stage
  // writes, so no further barrier is needed.
  const unsigned bytes = (unsigned)(d * w) * 4u;
  int cur = 0;
  unsigned parity = 0;  // bit j: the parity of buffer j's next fill
  bool filled = true;   // buffer 0 holds the first input already
  auto wait_input = [&]() {
    if (!filled) {
      bar_wait(bar0 + 8 * cur, (parity >> cur) & 1u);
      parity ^= 1u << cur;
    }
    filled = false;
  };
  // row rl0 + r of the tile, C columns, into the output buffer of every block
  auto push = [&](int r, const float (&v)[C]) {
    const int o = cur ^ 1;
    const unsigned dst = smem_addr(bufs + o * bsize + cell(row0 + rl0 + r, c0));
    const unsigned bar = bar0 + 8 * o;
    for (int p = 0; p < cs; ++p) st_async(peer_addr(dst, p), v, peer_addr(bar, p));
  };
  // one product from the resident slice sm; epi(acc, in) consumes the tile
  auto stage = [&](const float* sm, auto epi) {
    wait_input();
    if (t == 0) bar_expect(bar0 + 8 * (cur ^ 1), bytes);
    const float* in = bufs + cur * bsize;
    if (active) {
      float acc[R][C];
      tile_product<kKind>(sm, sp, in, w, dp, d, rl0, c0, acc);
      epi(acc, in);
    }
    cur ^= 1;
  };
  auto next_input = [&](int r, float (&v)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = __fsub_rn(__fadd_rn(z[r][c], bv[r][c]), u1[r][c]);
  };
  // beta = Q diag(inv) Q^T (A x + (w - u2)), x = z + b - u1 the input
  auto beta_solve = [&]() {
    stage(sa, [&](float (&acc)[R][C], const float*) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
        float v[C];
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = __fadd_rn(acc[r][c], __fsub_rn(wv[r][c], u2[r][c]));
        push(r, v);
      }
    });
    stage(sq, [&](float (&acc)[R][C], const float*) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
        float v[C];
#pragma unroll
        for (int c = 0; c < C; ++c) v[c] = __fmul_rn(iv[r], acc[r][c]);
        push(r, v);
      }
    });
    stage(sqt, [&](float (&acc)[R][C], const float*) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (live[r]) push(r, acc[r]);
    });
  };
  // The over-relaxed clip / shrink / dual update of the tile from ab = A beta,
  // with beta in the input buffer, in the epilogue of the A beta product.
  // Its output is the next input z + b - u1, or with deltas (a chunk's last
  // iteration) dz, with dw kept in registers.
  auto update = [&](float (&ab)[R][C], bool deltas) {
    const float* beta = bufs + cur * bsize;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!live[r]) continue;
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float zo = z[r][c], wo = wv[r][c], bb = bv[r][c], u1o = u1[r][c];
        const float u2o = u2[r][c];
        const float ab_r = __fadd_rn(__fmul_rn(alpha, ab[r][c]),
                                     __fmul_rn(one_minus_alpha, __fadd_rn(zo, bb)));
        const float beta_r = __fadd_rn(__fmul_rn(alpha, beta[cell(row0 + rl0 + r, c0 + c)]),
                                       __fmul_rn(one_minus_alpha, wo));
        z[r][c] = fminf(fmaxf(__fadd_rn(__fsub_rn(ab_r, bb), u1o), -lm[c]), lm[c]);
        wv[r][c] = shrink(__fadd_rn(beta_r, u2o), irho[c]);
        u1[r][c] = __fsub_rn(__fsub_rn(__fadd_rn(u1o, ab_r), z[r][c]), bb);
        u2[r][c] = __fsub_rn(__fadd_rn(u2o, beta_r), wv[r][c]);
        if (kState && deltas) {
          v[c] = __fsub_rn(z[r][c], zo);
          dw[r][c] = __fsub_rn(wv[r][c], wo);
        } else {
          v[c] = __fsub_rn(__fadd_rn(z[r][c], bb), u1[r][c]);
        }
      }
      push(r, v);
    }
  };
  // One ADMM iteration.
  auto iteration = [&](bool deltas) {
    beta_solve();
    stage(sa, [&](float (&acc)[R][C], const float*) { update(acc, deltas); });
  };
  // K3's A beta product after a residual check, left pending: held = A beta,
  // which is, bit for bit, the next chunk's first A beta.  Completed by
  // update(held, ...) or by passing z + b - u1 on, then cur ^= 1.
  float held[R][C];
  auto ab_product = [&]() {
    wait_input();
    if (t == 0) bar_expect(bar0 + 8 * (cur ^ 1), bytes);
    if (active) tile_product<kKind>(sa, sp, bufs + cur * bsize, w, dp, d, rl0, c0, held);
  };
  // The cluster's max scaled residual after a chunk, the same in every
  // thread of every block: max(max |A beta - z - b|, max |beta - w|,
  // max_c rho_c |A dz + dw|_c) over the live entries, with dz the input.
  // The A dz product passes z + b - u1 on; the A beta product is left
  // pending (ab_product).
  auto residual = [&]() -> float {
    float local = 0.f;
    stage(sa, [&](float (&acc)[R][C], const float*) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
#pragma unroll
        for (int c = 0; c < C; ++c)
          if (c0 + c < ncol)
            local = max_nan(local, __fmul_rn(rh[c], fabsf(__fadd_rn(acc[r][c], dw[r][c]))));
        float v[C];
        next_input(r, v);
        push(r, v);
      }
    });
    beta_solve();
    ab_product();
    const float* beta = bufs + cur * bsize;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!live[r]) continue;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c0 + c < ncol) {
          local = max_nan(local, fabsf(__fsub_rn(__fsub_rn(held[r][c], z[r][c]), bv[r][c])));
          local = max_nan(local,
                          fabsf(__fsub_rn(beta[cell(row0 + rl0 + r, c0 + c)], wv[r][c])));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      local = max_nan(local, __shfl_xor_sync(0xffffffffu, local, off));
    if (t % 32 == 0) red[t / 32] = local;
    __syncthreads();
    if (t == 0) {
      float r = red[0];
      for (int i = 1; i < kWarps; ++i) r = max_nan(r, red[i]);
      for (int p = 0; p < cs; ++p) cluster.map_shared_rank(red, p)[kWarps + rank] = r;
    }
    cluster.sync();
    float res = red[kWarps];
    for (int p = 1; p < cs; ++p) res = max_nan(res, red[kWarps + p]);
    return res;
  };

  int it = 0;
  if (!kState || !has_tol) {
    for (; it < iters; ++it) iteration(false);
  } else {
    // chunks of check_every iterations, the last one clamped so the cap is
    // exactly iters; res is cluster-uniform, so every thread leaves together.
    // After a check the next chunk's first iteration starts from the held
    // A beta.
    float res = __int_as_float(0x7f800000);  // +inf
    bool pending = false;
    while (it < iters && res > tol) {
      const int n = min(check_every, iters - it);
      for (int j = 0; j < n; ++j) {
        if (!pending) {
          iteration(j + 1 == n);
          continue;
        }
        if (active) update(held, j + 1 == n);
        cur ^= 1;
        pending = false;
      }
      it += n;
      if (it >= iters) break;  // capped: the check would not change the outcome
      res = residual();
      pending = true;
    }
    if (pending) {  // the check ended the loop: pass z + b - u1 on
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!live[r]) continue;
        float v[C];
        next_input(r, v);
        push(r, v);
      }
      cur ^= 1;
    }
  }
  // the last stage's stores have landed before any block may leave
  wait_input();
  cluster.sync();

#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!live[r] || c0 + c >= ncol) continue;
      const size_t g = (size_t)(row0 + rl0 + r) * k + col0 + c0 + c;
      out[g] = wv[r][c];
      if (kState) {
        io.z[cols + g] = z[r][c];
        io.u1[cols + g] = u1[r][c];
        io.u2[cols + g] = u2[r][c];
      }
    }
  if (kState && rank == 0 && t == 0) io.iters[mach * (gridDim.x / cs) + blk] = it;
}

using ClusterKernel = void (*)(const float*, const float*, const float*, const float*,
                               const float*, const float*, float*, StateIO, int, int, int, int,
                               int, float, float, int, float, int);

// The kernel of a cluster launch and its dynamic shared memory, after setting
// the kernel's attributes; cudaErrorInvalidValue where the shape has no
// cluster of cs (no micro-tile whose tiles all get a thread).
template <bool kState>
cudaError_t cluster_kernel(int d, int width, int cs, size_t* smem, ClusterKernel* kernel) {
  const int kind = cs < 2 || cs > kMaxCluster ? kNone : tile_kind(d, width, cs);
  if (kind == kNone) return cudaErrorInvalidValue;
  *smem = sizeof(float) * cluster_smem_floats<kState>(d, width, cs, kind);
  *kernel = kind == kRow ? cluster_fused_admm_kernel<kRow, kState>
                         : cluster_fused_admm_kernel<kBlock, kState>;
  cudaError_t err =
      cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err == cudaSuccess && cs > 8)
    err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem, int cs, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kState>
int launch_cluster(const float* a, const float* q, const float* inv, const float* b,
                   const float* lam, const float* rho, float* out, StateIO io, int m, int d,
                   int k, int bk, int width, int cs, int iters, float alpha,
                   float one_minus_alpha, int has_tol, float tol, int check_every,
                   cudaStream_t stream) {
  size_t smem = 0;
  ClusterKernel kernel = nullptr;
  cudaError_t err = cluster_kernel<kState>(d, width, cs, &smem, &kernel);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(cs * ((k + bk - 1) / bk), m), smem, cs, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, a, q, inv, b, lam, rho, out, io, d, k, bk, width,
                           iters, alpha, one_minus_alpha, has_tol, tol, check_every);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <bool kState>
int cluster_info(int d, int width, int cs, int* info) {
  size_t smem = 0;
  ClusterKernel kernel = nullptr;
  cudaError_t err = cluster_kernel<kState>(d, width, cs, &smem, &kernel);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(cs), smem, cs, nullptr, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  info[0] = clusters;
  info[1] = (int)smem;
  info[2] = fa.numRegs;
  info[3] = (int)fa.localSizeBytes;
  info[4] = tile_kind(d, width, cs);
  return 0;
}

}  // namespace

// The launchers.  width is the compile-time column tile (>= bk) and cluster
// the template: CS >= 2 blocks per cluster, or 0 for the streamed template,
// which alone reads at = A^T and qt = Q^T and keeps its state in scratch,
// kStateSlabs d width floats per (machine, column block) (all three null for
// a cluster launch).  The Python models (repro_torch/kernels/dantzig_fused.py) pick bk, width and
// cluster and size the shared memory with the same formulas as smem_floats
// and cluster_smem_floats.  Each returns the launch's cudaError (0 on
// success).

// K2: iters iterations from the zero state; writes w (m, d, k).
extern "C" int dantzig_fused_launch(const float* a, const float* q, const float* at,
                                    const float* qt, const float* inv, const float* b,
                                    const float* lam, const float* rho, float* out,
                                    float* scratch, int m, int d, int k, int bk, int width,
                                    int cluster, int iters, float alpha, float one_minus_alpha,
                                    cudaStream_t stream) {
  if (bk < 1 || bk > width) return (int)cudaErrorInvalidValue;
  if (cluster > 0)
    return launch_cluster<false>(a, q, inv, b, lam, rho, out, StateIO{}, m, d, k, bk, width,
                                 cluster, iters, alpha, one_minus_alpha, 0, 0.f, 1, stream);
  if (at == nullptr || qt == nullptr || scratch == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch_streamed<false>(at, q, qt, inv, b, lam, rho, out, scratch, StateIO{}, m, d, k,
                                  bk, width, iters, alpha, one_minus_alpha, 0, 0.f, 1, stream);
}

// K3: from the warm state (z0, w0, u10, u20; all null for the zero state),
// max_iters iterations, or with has_tol the residual-gated chunks; writes
// the final state (w, z, u1, u2: (m, d, k)) and the executed iterations of
// every (machine, block), iters_out (m, blocks) int32.
extern "C" int dantzig_fused_state_launch(
    const float* a, const float* q, const float* at, const float* qt, const float* inv,
    const float* b, const float* lam, const float* rho, const float* z0, const float* w0,
    const float* u10, const float* u20, float* w, float* z, float* u1, float* u2,
    int* iters_out, float* scratch, int m, int d, int k, int bk, int width, int cluster,
    int max_iters,
    float alpha, float one_minus_alpha, int has_tol, float tol, int check_every,
    cudaStream_t stream) {
  if (has_tol && check_every < 1) return (int)cudaErrorInvalidValue;
  if (bk < 1 || bk > width) return (int)cudaErrorInvalidValue;
  const bool warm = z0 != nullptr;
  if (warm != (w0 != nullptr) || warm != (u10 != nullptr) || warm != (u20 != nullptr))
    return (int)cudaErrorInvalidValue;
  const StateIO io{z0, w0, u10, u20, z, u1, u2, iters_out};
  if (cluster > 0)
    return launch_cluster<true>(a, q, inv, b, lam, rho, w, io, m, d, k, bk, width, cluster,
                                max_iters, alpha, one_minus_alpha, has_tol, tol, check_every,
                                stream);
  if (at == nullptr || qt == nullptr || scratch == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch_streamed<true>(at, q, qt, inv, b, lam, rho, w, scratch, io, m, d, k, bk,
                                 width, max_iters, alpha, one_minus_alpha, has_tol, tol,
                                 check_every, stream);
}

// What a cluster launch of this shape gets on the card: info[0] the
// clusters that can be resident at once (cudaOccupancyMaxActiveClusters),
// info[1] the dynamic shared memory per block in bytes, info[2] registers
// per thread, info[3] local (spilled) bytes per thread, info[4] the
// micro-tile (1: 1 x 1, 2: 2 x 4).  K3 with state_io.
extern "C" int dantzig_fused_cluster_info(int d, int width, int cluster, int state_io,
                                          int* info) {
  return state_io ? cluster_info<true>(d, width, cluster, info)
                  : cluster_info<false>(d, width, cluster, info);
}
