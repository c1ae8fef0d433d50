// The ADMM steps of the OSQP-style QP solver for Hopper (sm_90a), plain C
// interface.
//
// Replaces no Pallas kernel.  The JAX package's ops/qp.py::
// qp_admm_general is plain jnp, which XLA fuses on the TPU; run eagerly
// in PyTorch, each of its steps is a chain of about 29 library calls
// (two matrix-vector products with A, two batched triangular solves,
// elementwise updates), so one robot's LTV-MPC tick (3 passes of 150
// steps) is about 13,000 launches, and at fleet width every step reads
// each lane's dense factor and constraint matrix from memory again.
// This kernel runs all the steps of one pass in one launch.
//
// What it computes, per lane (the plain version is ops/qp.py::
// admm_steps, the eager loop of qp_admm_general, the CPU path and the
// tests' twin), from the lower Cholesky factor L of K = H + sigma I +
// A' diag(rho) A that the caller computed:
//   rho_r = rho * 1e3 on equality rows (|ub - lb| < 1e-12), else rho
//   x = x0 (or 0), z = clip(A x, lb, ub), y = 0, then `iters` times:
//     rhs = (sigma x - g) + A'(rho z - y)
//     xt  = L'^-1 L^-1 rhs               (two triangular solves)
//     zt  = A xt
//     x   = alpha xt + (1 - alpha) x
//     zr  = alpha zt + (1 - alpha) z
//     zn  = clip(zr + y / rho, lb, ub)
//     y   = y + rho (zr - zn);  z = zn
// and writes x and y once.  The same operations in the same order as the
// plain loop, except: a product with A sums over A's pattern, and a solve
// over L's row envelope (row i from its first column f_i, the first
// nonzero of row i of K's pattern: Cholesky makes no entry left of it,
// so the entries skipped are exact zeros), in increasing index from 0;
// a solve divides by the diagonal as a product with its reciprocal,
// taken once a pass (no inverse of L is formed); products and sums may
// contract to fused multiply-adds.  Both patterns come with the launch
// (the wrapper's AdmmPattern); a dense one covers every entry.
//
// What bounds it on this card.  At the LTV-MPC's shape (n = 145
// variables, m = 201 rows, 484 entries of A, 4,627 of L's envelope) a
// step is about 10,000 multiply-adds and a lane's factor and A are 20 KB
// in float32: the bytes, read once a pass, and the operations are far
// below the card's rates.  What bounds it is latency: each solve is a
// chain of n dependent columns (the next unknown needs the last one's
// update), so one step is two chains of 145 links, each a multiply, a
// shuffle and a fused multiply-add.  At fleet width the card holds as
// many lanes at once as the SMs' shared memory and registers allow, and
// their chains overlap.
//
// The design:
// * One launch shape for every lane count.  A shape of one warp a lane
//   (each thread five rows, the off-diagonal updates on the one warp's
//   chain) measured slower than a warp for each 32 rows at both of the
//   cells' widths: 5.96 against 3.06 ms a pass at B=1 and 42.3 against
//   24.0 ms at B=4096 (dense packed L, float32, H100 SXM at 700 W).
//   Solving two columns a shuffle (each thread keeping a copy of the
//   next row) measured slower too: 56 registers, 7 lanes an SM, 3.40
//   against 2.02 ms a pass at B=1 and 18.9 against 11.2 ms at B=4096.
// * One lane a block of W = ceil(n / 32) warps, thread t of warp w
//   owning variable 32 w + t (its x, g, the diagonal's reciprocal and
//   the start of its row of L) and constraint rows tid, tid + 32 W, ...
//   (their z, y, lb, ub, rho), all in registers.  L's envelope, packed
//   by rows, A's entries in the pattern's row order, one vector of
//   max(m, n) and each row's (first column, offset) live in shared
//   memory for the whole pass.  Nothing is written to global memory
//   before the outputs.
// * A solve goes by blocks of 32 columns, block b owned by warp b.  The
//   owner solves its diagonal block column by column: the owner of row
//   j forms the unknown, a shuffle hands it to the warp, the threads
//   below it update their rows.  Each thread reads its entry of L
//   before the shuffle (in the backward solve, from the row's offset
//   read a column ahead) and nothing is stored inside the loop, so that
//   a column's chain is a product, a shuffle and a fused multiply-add.
//   The owner then publishes the block's 32 unknowns in shared memory;
//   after a barrier the warps below (above, in the backward solve)
//   update their rows with them, so that the next block's owner waits
//   for its own 32 updates only, and the other warps' updates run
//   beside its solve.  Each row accumulates its updates in increasing
//   column order (decreasing in the backward solve).
// * The products with A and A' go by rows and by columns of A's pattern
//   (CSR and CSC index arrays in global memory, read through the cache;
//   the CSC entries point into the CSR order of the values).
// * The kernel allocates nothing and never synchronises the host; the
//   scalars and counts are launch arguments.  It can be captured in a
//   CUDA graph.

#include <cuda_runtime.h>

#include <type_traits>

// One instantiation a library: the scalar type, the warps of a lane
// (W = ceil(n / 32)) and the constraint rows of a thread
// (MS = ceil(m / (32 W))) come from the build flags.
#ifndef ADMM_SCALAR
#define ADMM_SCALAR float
#endif
#ifndef ADMM_W
#define ADMM_W 5
#endif
#ifndef ADMM_MS
#define ADMM_MS 2
#endif

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
// dynamic shared memory a block may take on this card
constexpr int kMaxSharedBytes = 227 * 1024;

// the input tensors, in the order of the wrapper's pointer array
enum Input {
  kL,    // (B, n, n) lower factor, rows or columns packed (l_colmajor)
  kA,    // (B, m, n) rows packed
  kG,    // (B, n)
  kLb,   // (B, m)
  kUb,   // (B, m)
  kX0,   // (B, n) warm start, or null for zeros
  kInputs
};

// the pattern's index arrays (int32), in the order of the wrapper's array
enum Pattern {
  kRowPtr,  // (m + 1) CSR row starts of A
  kColIdx,  // (nnz) column of each entry, CSR order
  kEntRow,  // (nnz) row of each entry, CSR order
  kColPtr,  // (n + 1) CSC column starts
  kCscPos,  // (nnz) CSR position of each CSC entry
  kCscRow,  // (nnz) row of each CSC entry
  kLFirst,  // (n) first column of row i of L's envelope
  kLStart,  // (n + 1) where row i's entries left of the diagonal start
  kPatterns
};

struct Params {
  const void* in[kInputs];
  long long lane_stride[kInputs];  // elements between lanes
  const int* pat[kPatterns];
  void* x_out;  // (B, n)
  void* y_out;  // (B, m)
  double rho, sigma, alpha;
  int l_colmajor, iters, B, n, m, nnz, l_entries;
};

// min(max(x, lo), hi) that keeps a NaN, as torch.minimum / maximum do
template <typename T>
__device__ __forceinline__ T clamp_box(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// the shared memory of one lane's values: L's envelope, A's entries and
// a vector, rounded up to 8 bytes
template <typename T>
__host__ __device__ long long values_bytes(int n, int m, int nnz,
                                           int l_entries) {
  const long long vec = m > n ? m : n;
  const long long b = static_cast<long long>(sizeof(T))
                      * (static_cast<long long>(l_entries) + nnz + vec);
  return (b + 7) / 8 * 8;
}

// ... and all of it, with the rows' (first column, offset) pairs
template <typename T>
long long lane_bytes(int n, int m, int nnz, int l_entries) {
  return values_bytes<T>(n, m, nnz, l_entries) + 8LL * (n + 1);
}

template <typename T, int W, int MS>
__global__ void __launch_bounds__(kWarp * W) qp_admm_kernel(const Params P) {
  constexpr int kThreads = kWarp * W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = P.n, m = P.m, nnz = P.nnz;
  T* Lp = reinterpret_cast<T*>(smem_raw);
  T* Av = Lp + P.l_entries;
  T* buf = Av + nnz;
  // rows[j + 1] = (first column, offset in Lp) of row j of L; rows[0] a
  // sentinel that no thread uses
  int2* rows = reinterpret_cast<int2*>(
      smem_raw + values_bytes<T>(n, m, nnz, P.l_entries));

  const int tid = threadIdx.x, w = tid >> 5, t = tid & (kWarp - 1);
  const long long b = blockIdx.x;
  const T* L = static_cast<const T*>(P.in[kL]) + b * P.lane_stride[kL];
  const T* A = static_cast<const T*>(P.in[kA]) + b * P.lane_stride[kA];
  const T* G = static_cast<const T*>(P.in[kG]) + b * P.lane_stride[kG];
  const T* LB = static_cast<const T*>(P.in[kLb]) + b * P.lane_stride[kLb];
  const T* UB = static_cast<const T*>(P.in[kUb]) + b * P.lane_stride[kUb];
  const T* X0 = P.in[kX0] == nullptr
                    ? nullptr
                    : static_cast<const T*>(P.in[kX0]) + b * P.lane_stride[kX0];
  const int* __restrict__ row_ptr = P.pat[kRowPtr];
  const int* __restrict__ col_idx = P.pat[kColIdx];
  const int* __restrict__ ent_row = P.pat[kEntRow];
  const int* __restrict__ col_ptr = P.pat[kColPtr];
  const int* __restrict__ csc_pos = P.pat[kCscPos];
  const int* __restrict__ csc_row = P.pat[kCscRow];
  const int* __restrict__ l_first = P.pat[kLFirst];
  const int* __restrict__ l_start = P.pat[kLStart];

  // ---- this thread's variable i and constraint rows tid + 32 W k ----
  const int i = tid;
  const bool own = i < n;
  const int fi = own ? l_first[i] : 0;   // row i of L holds columns fi..i
  const int ri = own ? l_start[i] - fi : 0;  // (i, j) at Lp[ri + j]

  // ---- load once a pass: L's envelope by rows, A's entries ----
  if (own) rows[i + 1] = make_int2(fi, ri);
  if (tid == 0) rows[0] = make_int2(n, 0);
  {
    const long long rs = P.l_colmajor ? 1 : n, cs = P.l_colmajor ? n : 1;
    // warp w loads rows w, w + W, ...; its threads the row's columns
    for (int r = w; r < n; r += W) {
      const int f = l_first[r], o = l_start[r] - f;
      for (int j = f + t; j < r; j += kWarp) Lp[o + j] = L[r * rs + j * cs];
    }
    constexpr int kU = 4;  // loads in flight a thread
    for (int p0 = tid; p0 < nnz; p0 += kU * kThreads) {
      T v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int p = p0 + u * kThreads;
        v[u] = p < nnz ? A[ent_row[p] * n + col_idx[p]] : T(0);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int p = p0 + u * kThreads;
        if (p < nnz) Av[p] = v[u];
      }
    }
  }
  const T rinv = own ? T(1) / L[i * (n + 1)] : T(0);  // either layout
  const T g = own ? G[i] : T(0);
  T x = own && X0 != nullptr ? X0[i] : T(0);
  T z[MS], y[MS], lb[MS], ub[MS], rho[MS];
  const T rho_lo = T(P.rho), rho_hi = T(P.rho * 1e3);
#pragma unroll
  for (int k = 0; k < MS; ++k) {
    const int r = tid + kThreads * k;
    const bool on = r < m;
    lb[k] = on ? LB[r] : T(0);
    ub[k] = on ? UB[r] : T(0);
    rho[k] = fabs(ub[k] - lb[k]) < T(1e-12) ? rho_hi : rho_lo;
    y[k] = T(0);
  }
  const T sigma = T(P.sigma), alpha = T(P.alpha), oma = T(1.0 - P.alpha);

  // zt = A buf, for this thread's constraint rows
  auto a_times_buf = [&](T (&zt)[MS]) {
#pragma unroll
    for (int k = 0; k < MS; ++k) {
      const int r = tid + kThreads * k;
      T acc = T(0);
      if (r < m) {
        const int end = row_ptr[r + 1];
#pragma unroll 4
        for (int p = row_ptr[r]; p < end; ++p) acc += Av[p] * buf[col_idx[p]];
      }
      zt[k] = acc;
    }
  };

  // z = clip(A x, lb, ub)
  if (own) buf[i] = x;
  __syncthreads();
  {
    T zt[MS];
    a_times_buf(zt);
#pragma unroll
    for (int k = 0; k < MS; ++k) z[k] = clamp_box(zt[k], lb[k], ub[k]);
  }

  for (int it = 0; it < P.iters; ++it) {
    __syncthreads();  // every read of buf is done
    // q = rho z - y
#pragma unroll
    for (int k = 0; k < MS; ++k) {
      const int r = tid + kThreads * k;
      if (r < m) buf[r] = rho[k] * z[k] - y[k];
    }
    __syncthreads();
    // rhs = (sigma x - g) + A'q
    T bv;
    {
      T acc = T(0);
      if (own) {
        const int end = col_ptr[i + 1];
#pragma unroll 4
        for (int k = col_ptr[i]; k < end; ++k)
          acc += Av[csc_pos[k]] * buf[csc_row[k]];
      }
      bv = (sigma * x - g) + acc;
    }
    __syncthreads();  // buf now carries the solves' unknowns

    // ---- forward solve L w = rhs ----
#pragma unroll
    for (int jb = 0; jb < W; ++jb) {
      const int j0 = kWarp * jb;
      const int cols = n - j0 < kWarp ? n - j0 : kWarp;
      if (w == jb) {
        for (int c = 0; c < cols; ++c) {
          const int j = j0 + c;
          // L's entry is read before the shuffle, off the chain
          const bool use = t > c && own && j >= fi;
          const T l = use ? Lp[ri + j] : T(0);
          const T wj = __shfl_sync(kAll, bv * rinv, c);
          if (t == c) bv = wj;
          if (use) bv -= l * wj;
        }
        if (t < cols) buf[j0 + t] = bv;  // the block's unknowns
      }
      if (W > 1) {
        __syncthreads();
        if (w > jb && own) {  // rows below the block
          const int c0 = fi > j0 ? fi - j0 : 0;
#pragma unroll 4
          for (int c = c0; c < cols; ++c) bv -= Lp[ri + j0 + c] * buf[j0 + c];
        }
      }
    }

    // ---- backward solve L' xt = w ----
#pragma unroll
    for (int jb = W - 1; jb >= 0; --jb) {
      const int j0 = kWarp * jb;
      const int cols = n - j0 < kWarp ? n - j0 : kWarp;
      if (w == jb) {
        // row j of L holds this thread's entry (j, i) at Lp[r_j + i]; the
        // next row's (f, r) is read a column ahead
        int2 row = rows[j0 + cols];
        for (int c = cols - 1; c >= 0; --c) {
          const int2 next = rows[j0 + c];
          const bool use = t < c && i >= row.x;
          const T l = use ? Lp[row.y + i] : T(0);
          const T xj = __shfl_sync(kAll, bv * rinv, c);
          if (t == c) bv = xj;
          if (use) bv -= l * xj;
          row = next;
        }
        if (t < cols) buf[j0 + t] = bv;  // the block's unknowns: xt
      }
      if (W > 1) {
        __syncthreads();
        if (w < jb) {  // rows above the block
#pragma unroll 4
          for (int c = cols - 1; c >= 0; --c) {
            const int2 row = rows[j0 + c + 1];
            if (i >= row.x) bv -= Lp[row.y + i] * buf[j0 + c];
          }
        }
      }
    }
    __syncthreads();  // buf holds xt

    // ---- zt = A xt and the relaxed updates ----
    {
      T zt[MS];
      a_times_buf(zt);
#pragma unroll
      for (int k = 0; k < MS; ++k) {
        const T zr = alpha * zt[k] + oma * z[k];
        const T zn = clamp_box(zr + y[k] / rho[k], lb[k], ub[k]);
        y[k] = y[k] + rho[k] * (zr - zn);
        z[k] = zn;
      }
    }
    x = alpha * bv + oma * x;
  }

  // ---- write once ----
  if (own) static_cast<T*>(P.x_out)[b * n + i] = x;
#pragma unroll
  for (int k = 0; k < MS; ++k) {
    const int r = tid + kThreads * k;
    if (r < m) static_cast<T*>(P.y_out)[b * m + r] = y[k];
  }
}

using Scalar = ADMM_SCALAR;
constexpr int kW = ADMM_W;
constexpr int kMS = ADMM_MS;
constexpr int kDtype = std::is_same<Scalar, double>::value ? 1 : 0;
static_assert(std::is_same<Scalar, float>::value || kDtype == 1,
              "ADMM_SCALAR must be float or double");
static_assert(kW >= 1 && kW <= 8, "ADMM_W must be 1..8 (n <= 256)");
static_assert(kMS >= 1, "ADMM_MS must be at least 1");

constexpr auto kKernel = qp_admm_kernel<Scalar, kW, kMS>;

// whether this library's instantiation runs dtype at n variables and m
// rows
bool instantiated(int dtype, int n, int m) {
  return n >= 1 && m >= 1 && dtype == kDtype
         && (n + kWarp - 1) / kWarp == kW
         && (m + kWarp * kW - 1) / (kWarp * kW) == kMS;
}

bool shared_allowed = false;

cudaError_t allow_shared() {
  if (shared_allowed) return cudaSuccess;
  const void* f = reinterpret_cast<const void*>(kKernel);
  cudaError_t err = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(f, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  shared_allowed = true;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Run `iters` ADMM steps of B lanes on `stream`, one block a lane.
// inputs: kInputs device pointers in the order of `Input` (x0 may be
// null), lane_strides their lane strides in elements; l_colmajor: 1 if
// each lane's L is stored by columns, 0 by rows; pattern: kPatterns int32
// device arrays in the order of `Pattern`, l_entries the size of L's
// envelope left of the diagonal; x_out (B, n) and y_out (B, m) packed
// outputs; dtype 0 float, 1 double.  Returns the cudaError_t of the
// launch (0 on success); cudaErrorInvalidValue for a dtype or shape this
// library does not instantiate or a lane that does not fit in a block's
// shared memory.
int qp_admm_launch(const void* const* inputs, const long long* lane_strides,
                   int l_colmajor, const int* const* pattern, void* x_out,
                   void* y_out, double rho, double sigma, double alpha,
                   int iters, int B, int n, int m, int nnz, int l_entries,
                   int dtype, void* stream) {
  if (!instantiated(dtype, n, m) || nnz < 0 || l_entries < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = lane_bytes<Scalar>(n, m, nnz, l_entries);
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaError_t err = allow_shared();
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  for (int k = 0; k < kInputs; ++k) {
    p.in[k] = inputs[k];
    p.lane_stride[k] = lane_strides[k];
  }
  for (int k = 0; k < kPatterns; ++k) p.pat[k] = pattern[k];
  p.x_out = x_out;
  p.y_out = y_out;
  p.rho = rho;
  p.sigma = sigma;
  p.alpha = alpha;
  p.l_colmajor = l_colmajor;
  p.iters = iters;
  p.B = B;
  p.n = n;
  p.m = m;
  p.nnz = nnz;
  p.l_entries = l_entries;
  kKernel<<<B, kWarp * kW, static_cast<size_t>(bytes),
            reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// What the runtime reports for this library's instantiation at a lane of
// n variables, m rows, nnz entries of A and l_entries of L's envelope:
// out[0] resident blocks (lanes) per SM, out[1] registers per thread,
// out[2] threads per block, out[3] shared bytes per block, out[4] spilled
// (local) bytes per thread.  Returns a cudaError_t.
int qp_admm_occupancy(int n, int m, int nnz, int l_entries, int* out) {
  const long long bytes = lane_bytes<Scalar>(n, m, nnz, l_entries);
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_shared();
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* f = reinterpret_cast<const void*>(kKernel);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, f, kWarp * kW, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = kWarp * kW;
  out[3] = static_cast<int>(bytes);
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

const char* qp_admm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
