// NMPC feedback for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel.  The JAX package leaves the NMPC's feedback
// (control/nmpc.py::_feedback_matfree over ops/qp.py::box_qp_pncg_op) to
// XLA, which fuses it on the TPU; run eagerly in PyTorch the same
// function is about 4,700 small launches a call, the larger part of the
// tracking tick at one robot and at fleet width.  This kernel is that
// function in one launch.
//
// What it computes, per lane (the plain version is
// control/nmpc.py::_feedback_matfree, the CPU path and the tests' twin):
// the separable factors of the condensing map (alpha, beta: prefix sums
// of the transition Jacobians' a02, a12; a_off: the defects carried
// through them from x_est - x_traj[0]); the decayed stage weights
// q_i = q_diag exp(-i/N s_x) (0 at stage 0, the last stage's at stage N),
// r_j = r_diag exp(-j/N s_u); the QP's gradient g = C'Q(x + a_off - x_ref)
// + R(u - u_ref) and diagonal diag(C'QC + R); the box QP on du by
// projected Newton, qp_iters outer iterations of cg_iters Jacobi-
// preconditioned CG trips on the free set (Tikhonov reg) and a projected
// line search over {1, a*, 1/2, 1/8}, first minimum taken if it lowers
// the objective; and the expansion x_new = x + C du + a_off,
// u_new = u + du.  The Hessian C'QC + R is applied matrix-free: C p is
// five exclusive prefix sums over the stages, C'y five exclusive suffix
// sums.  Same iteration counts, same guards (|x| <= 1e-30 -> 1e-30),
// same free-set rule and preconditioner as the plain version; the order
// of the sums and FMA contraction differ from it, nothing else.
//
// What bounds it on this card.  A lane's problem is a few hundred floats
// (N = 50: 100 variables) and about 3.3e5 operations, 4 x 20 Hessian
// applications of ten scans each; its inputs and outputs are about 5.3 KB.
// At 16384 lanes that is ~0.08 ms of f32 operations and ~0.03 ms of
// bytes.  Each lane is a chain of ~80 dependent Hessian applications and
// ~200 dependent dot products, so one lane is latency bound and many
// lanes are bound by the SM's issue of shuffles and FMAs.
//
// The design:
// * One warp a lane, kWarpsPerBlock lanes a block.  Thread t holds the
//   K consecutive stages t*K .. t*K + K-1 (K = ceil((N+1)/32), a template
//   parameter in 1..4, so N <= 127): state stage s (0..N) and input
//   stage s (0..N-1) share the index.  Every per-stage quantity (the
//   factors, the weights, the QP's vectors) stays in registers for the
//   whole solve; nothing is written to memory before the outputs.
// * A prefix (suffix) sum is a sequential sum over the thread's K stages,
//   a Hillis-Steele scan of the thread totals with __shfl_up_sync
//   (__shfl_down_sync), and a sequential pass that hands each stage its
//   exclusive sum.  The five columns of a scan share its shuffles.
// * A dot product is the thread's partial sum and an xor butterfly, which
//   leaves the same bits in every thread (a + b == b + a), so every
//   thread holds the CG's alpha, beta and the line search's values and
//   the warp takes every branch together.  No shared memory, no barrier.
// * The kernel allocates nothing and never synchronises the host; the
//   weights and iteration counts are launch arguments.  It can be
//   captured in a CUDA graph.

#include <cuda_runtime.h>

#include <type_traits>

// One instantiation a library: the scalar type and K come from the build
// flags (the wrapper builds the library of each (dtype, K) it launches,
// so a process compiles only what it runs).
#ifndef FEEDBACK_SCALAR
#define FEEDBACK_SCALAR float
#endif
#ifndef FEEDBACK_K
#define FEEDBACK_K 2
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxK = 4;

// the input tensors, in the order of the wrapper's pointer array
enum Input {
  kXTraj,  // (B, N+1, 3)
  kUTraj,  // (B, N, 2)
  kXInt,   // (B, N, 3)
  kA02,    // (B, N)
  kA12,    // (B, N)
  kB0,     // (B, N, 2)
  kB1,     // (B, N, 2)
  kB2,     // (B, N, 2)
  kXEst,   // (B, 3)
  kRefX,   // (B, 3, N+1)
  kRefU,   // (B, 2, ref_u_cols), columns 0..N-1 read
  kInputs
};

// the scalar arguments, in the order of the wrapper's double array
enum ScalarArg {
  kQ0, kQ1, kQ2, kR0, kR1, kStateScaling, kInputScaling, kUMin, kUMax, kReg,
  kScalars
};

struct Params {
  const void* in[kInputs];
  long long lane_stride[kInputs];  // elements between lanes; rows packed
  void* x_new;                     // (B, N+1, 3) out
  void* u_new;                     // (B, N, 2) out
  double s[kScalars];
  int qp_iters, cg_iters, B, N, ref_u_cols;
};

__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }

// the QP's guard of a denominator (ops/qp.py::_safe)
template <typename T>
__device__ __forceinline__ T safe(T x) {
  return fabs(x) > T(1e-30) ? x : T(1e-30);
}

// min(max(x, lo), hi) that keeps a NaN, as torch.minimum / maximum do
template <typename T>
__device__ __forceinline__ T clamp_box(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(kAll, v, m);
  return v;
}

// c[k][m] <- sum of column m over the stages before lane*K + k
template <typename T, int K, int M>
__device__ __forceinline__ void excl_prefix(T (&c)[K][M], int lane) {
  T run[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    run[m] = c[0][m];
#pragma unroll
    for (int k = 1; k < K; ++k) run[m] += c[k][m];
  }
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const T o = __shfl_up_sync(kAll, run[m], d);
      if (lane >= d) run[m] += o;
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const T o = __shfl_up_sync(kAll, run[m], 1);
    run[m] = lane == 0 ? T(0) : o;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const T x = c[k][m];
      c[k][m] = run[m];
      run[m] += x;
    }
  }
}

// c[k][m] <- sum of column m over the stages after lane*K + k
template <typename T, int K, int M>
__device__ __forceinline__ void excl_suffix(T (&c)[K][M], int lane) {
  T run[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    run[m] = c[K - 1][m];
#pragma unroll
    for (int k = K - 2; k >= 0; --k) run[m] += c[k][m];
  }
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const T o = __shfl_down_sync(kAll, run[m], d);
      if (lane + d < kWarp) run[m] += o;
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const T o = __shfl_down_sync(kAll, run[m], 1);
    run[m] = lane == kWarp - 1 ? T(0) : o;
  }
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const T x = c[k][m];
      c[k][m] = run[m];
      run[m] += x;
    }
  }
}

// the separable factors of the condensing map and the stage weights of
// one lane, for this thread's stages (zero where a stage does not exist)
template <typename T, int K>
struct Lane {
  T b0[K][2], b1[K][2], b2[K][2];
  T al[K], be[K];  // alpha_s, beta_s (state stage s)
  T ac[K], bc[K];  // alpha_{s+1}, beta_{s+1} (input stage s)
  T q[K][3];       // state weights
  T r[K][2];       // input weights
};

template <typename T, int K>
__device__ __forceinline__ T dot(const T (&a)[K][2], const T (&b)[K][2]) {
  T s = a[0][0] * b[0][0];
  s += a[0][1] * b[0][1];
#pragma unroll
  for (int k = 1; k < K; ++k) {
    s += a[k][0] * b[k][0];
    s += a[k][1] * b[k][1];
  }
  return warp_sum(s);
}

// rows = C p at the state stages (plain: _tri_cmat)
template <typename T, int K>
__device__ __forceinline__ void cmat(const Lane<T, K>& L, const T (&p)[K][2],
                                     T (&rows)[K][3], int lane) {
  T c[K][5];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T u = L.b0[k][0] * p[k][0] + L.b0[k][1] * p[k][1];
    const T v = L.b1[k][0] * p[k][0] + L.b1[k][1] * p[k][1];
    const T w = L.b2[k][0] * p[k][0] + L.b2[k][1] * p[k][1];
    c[k][0] = u;
    c[k][1] = v;
    c[k][2] = w;
    c[k][3] = L.ac[k] * w;
    c[k][4] = L.bc[k] * w;
  }
  excl_prefix<T, K, 5>(c, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    rows[k][0] = c[k][0] + L.al[k] * c[k][2] - c[k][3];
    rows[k][1] = c[k][1] + L.be[k] * c[k][2] - c[k][4];
    rows[k][2] = c[k][2];
  }
}

// out = C'y at the input stages (plain: _tri_ctmat)
template <typename T, int K>
__device__ __forceinline__ void ctmat(const Lane<T, K>& L, const T (&y)[K][3],
                                      T (&out)[K][2], int lane) {
  T c[K][5];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    c[k][0] = y[k][0];
    c[k][1] = y[k][1];
    c[k][2] = y[k][2];
    c[k][3] = L.al[k] * y[k][0];
    c[k][4] = L.be[k] * y[k][1];
  }
  excl_suffix<T, K, 5>(c, lane);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T t = c[k][3] + c[k][4] + c[k][2] - L.ac[k] * c[k][0]
                - L.bc[k] * c[k][1];
#pragma unroll
    for (int m = 0; m < 2; ++m)
      out[k][m] = L.b0[k][m] * c[k][0] + L.b1[k][m] * c[k][1]
                  + L.b2[k][m] * t;
  }
}

// out = (C'QC + R) p
template <typename T, int K>
__device__ __forceinline__ void hess(const Lane<T, K>& L, const T (&p)[K][2],
                                     T (&out)[K][2], int lane) {
  T y[K][3];
  cmat(L, p, y, lane);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c) y[k][c] = L.q[k][c] * y[k][c];
  ctmat(L, y, out, lane);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int m = 0; m < 2; ++m) out[k][m] += L.r[k][m] * p[k][m];
}

template <typename T, int K>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    nmpc_feedback_kernel(const Params P) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long b =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= P.B) return;  // the whole warp leaves together
  const int N = P.N;
  const T* in[kInputs];
#pragma unroll
  for (int i = 0; i < kInputs; ++i)
    in[i] = static_cast<const T*>(P.in[i]) + b * P.lane_stride[i];
  const T* xt = in[kXTraj];

  Lane<T, K> L;
  T x0[K][3], u0[K][2], aoff[K][3], xr[K][3], ur[K][2], d[K][3];
  T a02[K], a12[K];
  T dx0[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) dx0[c] = in[kXEst][c] - xt[c];

  // ---- loads ----
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = lane * K + k;
    const bool st = s <= N, inp = s < N;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      x0[k][c] = st ? xt[s * 3 + c] : T(0);
      xr[k][c] = st ? in[kRefX][c * (N + 1) + s] : T(0);
      d[k][c] = inp ? in[kXInt][s * 3 + c] - xt[(s + 1) * 3 + c] : T(0);
    }
    a02[k] = inp ? in[kA02][s] : T(0);
    a12[k] = inp ? in[kA12][s] : T(0);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      L.b0[k][m] = inp ? in[kB0][s * 2 + m] : T(0);
      L.b1[k][m] = inp ? in[kB1][s * 2 + m] : T(0);
      L.b2[k][m] = inp ? in[kB2][s * 2 + m] : T(0);
      u0[k][m] = inp ? in[kUTraj][s * 2 + m] : T(0);
      ur[k][m] = inp ? in[kRefU][m * P.ref_u_cols + s] : T(0);
    }
  }

  // ---- the factors (plain: _tri_ops_factors) ----
  {
    T c[K][3];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      c[k][0] = a02[k];
      c[k][1] = a12[k];
      c[k][2] = d[k][2];
    }
    excl_prefix<T, K, 3>(c, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      L.al[k] = c[k][0];
      L.be[k] = c[k][1];
      aoff[k][2] = dx0[2] + c[k][2];
    }
    // alpha_{s+1}: the next stage's, the next thread's first for the last
    const T al_next = __shfl_down_sync(kAll, L.al[0], 1);
    const T be_next = __shfl_down_sync(kAll, L.be[0], 1);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) {
      L.ac[k] = L.al[k + 1];
      L.bc[k] = L.be[k + 1];
    }
    L.ac[K - 1] = al_next;
    L.bc[K - 1] = be_next;

    T e[K][2];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      e[k][0] = d[k][0] + a02[k] * aoff[k][2];
      e[k][1] = d[k][1] + a12[k] * aoff[k][2];
    }
    excl_prefix<T, K, 2>(e, lane);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      aoff[k][0] = dx0[0] + e[k][0];
      aoff[k][1] = dx0[1] + e[k][1];
    }
  }

  // ---- stage weights (plain: stage_weights and _feedback_matfree's q) --
  {
    const T n = T(N);
    const T sx = T(P.s[kStateScaling]), su = T(P.s[kInputScaling]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = lane * K + k;
      const int i = s < N - 1 ? s : N - 1;  // stage N takes N-1's decay
      const T ex = exp_t((-T(i) / n) * sx);
      const T eu = exp_t((-T(s) / n) * su);
      const bool weighted = s >= 1 && s <= N;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        L.q[k][c] = weighted ? T(P.s[kQ0 + c]) * ex : T(0);
#pragma unroll
      for (int m = 0; m < 2; ++m)
        L.r[k][m] = s < N ? T(P.s[kR0 + m]) * eu : T(0);
    }
  }

  // ---- gradient and diagonal (plain: g, _tri_diag_h) ----
  T g[K][2], dH[K][2];
  {
    T y[K][3];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        y[k][c] = L.q[k][c] * (x0[k][c] + aoff[k][c] - xr[k][c]);
    ctmat(L, y, g, lane);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int m = 0; m < 2; ++m) g[k][m] += L.r[k][m] * (u0[k][m] - ur[k][m]);

    T c[K][7];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T q0 = L.q[k][0], q1 = L.q[k][1];
      c[k][0] = q0;
      c[k][1] = q0 * L.al[k];
      c[k][2] = q0 * L.al[k] * L.al[k];
      c[k][3] = q1;
      c[k][4] = q1 * L.be[k];
      c[k][5] = q1 * L.be[k] * L.be[k];
      c[k][6] = L.q[k][2];
    }
    excl_suffix<T, K, 7>(c, lane);
    const T reg = T(P.s[kReg]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T s0 = c[k][0], s0a = c[k][1], s0a2 = c[k][2];
      const T s1 = c[k][3], s1b = c[k][4], s1b2 = c[k][5], s2 = c[k][6];
      const T a = L.ac[k], be = L.bc[k];
      const T c0x = s0a - a * s0;
      const T c0xx = s0a2 - T(2) * a * s0a + a * a * s0;
      const T c1x = s1b - be * s1;
      const T c1xx = s1b2 - T(2) * be * s1b + be * be * s1;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const T b0 = L.b0[k][m], b1 = L.b1[k][m], b2 = L.b2[k][m];
        const T dd = b0 * b0 * s0 + T(2) * b0 * b2 * c0x + b1 * b1 * s1
                     + T(2) * b1 * b2 * c1x + b2 * b2 * (c0xx + c1xx + s2);
        dH[k][m] = dd + L.r[k][m] + reg;
      }
    }
  }

  // ---- the box QP (plain: ops/qp.py::box_qp_pncg_op) ----
  const T reg = T(P.s[kReg]);
  const T umin = T(P.s[kUMin]), umax = T(P.s[kUMax]);
  T z[K][2], lb[K][2], ub[K][2];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool inp = lane * K + k < N;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      lb[k][m] = inp ? umin - u0[k][m] : T(0);
      ub[k][m] = inp ? umax - u0[k][m] : T(0);
      z[k][m] = clamp_box(T(0), lb[k][m], ub[k][m]);
    }
  }

  for (int it = 0; it < P.qp_iters; ++it) {
    T grad[K][2];
    bool fr[K][2];
    hess(L, z, grad, lane);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        grad[k][m] += g[k][m];
        const bool at_lb = z[k][m] <= lb[k][m] && grad[k][m] > T(0);
        const bool at_ub = z[k][m] >= ub[k][m] && grad[k][m] < T(0);
        fr[k][m] = !(at_lb || at_ub);
      }

    // Jacobi-preconditioned CG on the free set
    T x[K][2], hx[K][2], res[K][2], pd[K][2], mi[K][2];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool inp = lane * K + k < N;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        x[k][m] = T(0);
        hx[k][m] = T(0);
        res[k][m] = fr[k][m] ? -grad[k][m] : T(0);
        mi[k][m] = inp ? (fr[k][m] ? T(1) / dH[k][m] : T(1)) : T(0);
        pd[k][m] = mi[k][m] * res[k][m];
      }
    }
    T rz = dot(res, pd);
    for (int j = 0; j < P.cg_iters; ++j) {
      T fp[K][2], ap[K][2];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int m = 0; m < 2; ++m) fp[k][m] = fr[k][m] ? pd[k][m] : T(0);
      hess(L, fp, ap, lane);
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          ap[k][m] = (fr[k][m] ? ap[k][m] : pd[k][m]) + reg * pd[k][m];
      const T alpha = rz / safe(dot(pd, ap));
      T zn[K][2];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          x[k][m] += alpha * pd[k][m];
          hx[k][m] += alpha * ap[k][m];
          res[k][m] -= alpha * ap[k][m];
          zn[k][m] = mi[k][m] * res[k][m];
        }
      const T rz_new = dot(res, zn);
      const T beta = rz_new / safe(rz);
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int m = 0; m < 2; ++m) pd[k][m] = zn[k][m] + beta * pd[k][m];
      rz = rz_new;
    }

    // projected line search over {1, a*, 1/2, 1/8}: the first minimum of
    // the exact change of the objective, taken if it is negative (a NaN
    // counts as the minimum, as torch.argmin takes it)
    const T gtdz = dot(grad, x);
    T a_star = -gtdz / safe(dot(x, hx));
    a_star = a_star < T(0) ? T(0) : (a_star > T(1) ? T(1) : a_star);
    T best = T(0), zb[K][2];
#pragma unroll 1
    for (int cand = 0; cand < 4; ++cand) {
      const T a = cand == 0   ? T(1)
                  : cand == 1 ? a_star
                  : cand == 2 ? T(0.5)
                              : T(0.125);
      T zt[K][2], dv[K][2], hd[K][2];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          zt[k][m] = clamp_box(z[k][m] + a * x[k][m], lb[k][m], ub[k][m]);
          dv[k][m] = zt[k][m] - z[k][m];
        }
      hess(L, dv, hd, lane);
      const T dfs = dot(grad, dv) + T(0.5) * dot(dv, hd);
      if (cand == 0 || (best == best && (dfs < best || dfs != dfs))) {
        best = dfs;
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
          for (int m = 0; m < 2; ++m) zb[k][m] = zt[k][m];
      }
    }
    if (best < T(0)) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int m = 0; m < 2; ++m) z[k][m] = zb[k][m];
    }
  }

  // ---- expansion ----
  T rows[K][3];
  cmat(L, z, rows, lane);
  T* xn = static_cast<T*>(P.x_new) + b * (N + 1) * 3;
  T* un = static_cast<T*>(P.u_new) + b * N * 2;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = lane * K + k;
    if (s <= N) {
#pragma unroll
      for (int c = 0; c < 3; ++c)
        xn[s * 3 + c] = x0[k][c] + rows[k][c] + aoff[k][c];
    }
    if (s < N) {
#pragma unroll
      for (int m = 0; m < 2; ++m) un[s * 2 + m] = u0[k][m] + z[k][m];
    }
  }
}

using Scalar = FEEDBACK_SCALAR;
constexpr int kK = FEEDBACK_K;
constexpr int kDtype = std::is_same<Scalar, double>::value ? 1 : 0;
static_assert(std::is_same<Scalar, float>::value || kDtype == 1,
              "FEEDBACK_SCALAR must be float or double");
static_assert(kK >= 1 && kK <= kMaxK, "FEEDBACK_K must be 1..4");

// whether this library's instantiation runs dtype at horizon N
bool instantiated(int dtype, int N) {
  return N >= 1 && dtype == kDtype && (N + 1 + kWarp - 1) / kWarp == kK;
}

}  // namespace

extern "C" {

// Launch the feedback of B lanes with horizon N on `stream`.
// inputs: kInputs device pointers in the order of `Input`, each lane's
// rows packed, lane_strides their lane strides in elements; x_new
// (B, N+1, 3) and u_new (B, N, 2) packed outputs; scalars: kScalars
// doubles in the order of `ScalarArg`; dtype 0 float, 1 double.  Returns
// the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// for a dtype or horizon this library does not instantiate.
int nmpc_feedback_launch(const void* const* inputs,
                         const long long* lane_strides, void* x_new,
                         void* u_new, const double* scalars, int qp_iters,
                         int cg_iters, int B, int N, int ref_u_cols,
                         int dtype, void* stream) {
  if (!instantiated(dtype, N)) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  Params p;
  for (int i = 0; i < kInputs; ++i) {
    p.in[i] = inputs[i];
    p.lane_stride[i] = lane_strides[i];
  }
  p.x_new = x_new;
  p.u_new = u_new;
  for (int i = 0; i < kScalars; ++i) p.s[i] = scalars[i];
  p.qp_iters = qp_iters;
  p.cg_iters = cg_iters;
  p.B = B;
  p.N = N;
  p.ref_u_cols = ref_u_cols;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  nmpc_feedback_kernel<Scalar, kK>
      <<<blocks, kWarp * kWarpsPerBlock, 0,
         reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// What the runtime reports for this library's instantiation: out[0]
// resident blocks per SM, out[1] registers per thread, out[2] threads per
// block, out[3] lanes per block, out[4] spilled (local) bytes per thread.
// Returns a cudaError_t.
int nmpc_feedback_occupancy(int* out) {
  const void* f =
      reinterpret_cast<const void*>(nmpc_feedback_kernel<Scalar, kK>);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, f, kWarp * kWarpsPerBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = kWarp * kWarpsPerBlock;
  out[3] = kWarpsPerBlock;
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

const char* nmpc_feedback_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
