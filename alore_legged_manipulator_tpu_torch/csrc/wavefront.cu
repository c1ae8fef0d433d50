// Octile wavefront kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of the JAX package,
// alore_legged_manipulator_tpu/ops/wavefront_pallas.py:
//   K1  wavefront_packed_pallas      (_wavefront_packed_kernel, :183-260)
//   K2  octile_distance_field_pallas (_wavefront_kernel, :172-180)
// One source; the template flag PACKED adds K1's policy pass to K2.
//
// What it computes, per lane: the octile distance-to-goal field of an
// (H, W) grid by early-exit Jacobi min-plus relaxation (at most H + W
// sweeps), and for K1 the packed int32 word per cell -- bits 0-2 the
// greedy move (strict <, first minimum in move order), bit 3 stuck,
// bit 4 at goal, bit 5 disconnected, bits 6+ the straight run length
// min(true run, 16).
//
// Layout: one thread block per lane, 1024 threads, each thread owning
// a strided set of cells.  The lane's grid lives in DYNAMIC shared
// memory for every sweep: two f32 field buffers (Jacobi double buffer),
// one byte of blocked flag and one byte of per-move invalid bits (out
// of grid OR the diagonal corner rule, hoisted out of the sweeps) --
// 10 bytes per cell, 64,000 B at 80x80 and 100,000 B at 100x100, both
// above the 48 KB static limit, so the launch opts in with
// cudaFuncSetAttribute.  Grids above 227 KB are refused (the wrapper
// raises before launching).  Device memory is touched once: the inputs
// are read into shared memory and the outputs written at the end.
//
// Bound on this card: every sweep reads 9 field values per cell from
// shared memory, so the time is bounded below by
//   sweeps x H*W x 9 x 4 B / (shared-memory bandwidth),
// H100 SXM: 132 SMs x 128 B/clock x 1.98 GHz = 33.4 TB/s.  A lane runs
// as one block on one SM, so the per-SM rate (253 GB/s) bounds a lane
// and 132 lanes run at once.  The design keeps the whole relaxation in
// shared memory (no device-memory traffic per sweep) and ends at the
// first sweep that changes nothing (__syncthreads_or vote).
//
// Bit exactness with the JAX package: the minimum is grouped before the
// add, min(d, min4_straight + 1, min4_diag + (float)sqrt(2)) (min-then-add
// is exact in f32 because rounding is monotone); non-free cells are set
// to 1e9f; in the policy pass an out-of-grid candidate is 1e9f + w,
// which rounds to 1e9f, and a corner-blocked one is exactly 1e9f.
// Build without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e9f;
constexpr float kSq2 = 1.4142135623730951f;
constexpr int kThreads = 1024;
constexpr int kRunCap = 16;

__constant__ int kDx[8] = {1, -1, 0, 0, 1, 1, -1, -1};
__constant__ int kDy[8] = {0, 0, 1, -1, 1, -1, 1, -1};

template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
wavefront_kernel(const uint8_t* __restrict__ blocked,
                 const float* __restrict__ dist0,
                 float* __restrict__ dist_out,
                 int32_t* __restrict__ packed_out,
                 int32_t* __restrict__ sweeps_out,
                 int H, int W, int n_iters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = H * W;
  float* buf0 = reinterpret_cast<float*>(smem);
  float* buf1 = buf0 + HW;
  uint8_t* blk = reinterpret_cast<uint8_t*>(buf1 + HW);
  uint8_t* inv = blk + HW;

  const size_t base = static_cast<size_t>(blockIdx.x) * HW;
  const int tid = threadIdx.x;

  for (int c = tid; c < HW; c += kThreads) {
    blk[c] = blocked[base + c] != 0;
    buf0[c] = dist0[base + c];
  }
  __syncthreads();

  // per-move invalid bits: out of grid, or (diagonals) both orthogonal
  // step cells blocked, with cells past the border counting as blocked
  for (int c = tid; c < HW; c += kThreads) {
    const int i = c / W, j = c - (c / W) * W;
    uint8_t bits = 0;
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int dx = kDx[m], dy = kDy[m];
      const int ni = i + dx, nj = j + dy;
      bool bad = ni < 0 || ni >= H || nj < 0 || nj >= W;
      if (dx != 0 && dy != 0) {
        const bool o1 = (ni < 0 || ni >= H) ? true : blk[ni * W + j] != 0;
        const bool o2 = (nj < 0 || nj >= W) ? true : blk[i * W + nj] != 0;
        bad = bad || (o1 && o2);
      }
      bits |= static_cast<uint8_t>(bad) << m;
    }
    inv[c] = bits;
  }
  __syncthreads();

  float* cur = buf0;
  float* nxt = buf1;
  int sweeps = 0;
  for (int it = 0; it < n_iters; ++it) {
    int changed = 0;
    for (int c = tid; c < HW; c += kThreads) {
      const uint8_t bits = inv[c];
      const float d = cur[c];
      float ms = kBig, mo = kBig;
      // out-of-grid neighbours are never read: their invalid bit is set
      if (!(bits & 1)) ms = fminf(ms, cur[c + W]);
      if (!(bits & 2)) ms = fminf(ms, cur[c - W]);
      if (!(bits & 4)) ms = fminf(ms, cur[c + 1]);
      if (!(bits & 8)) ms = fminf(ms, cur[c - 1]);
      if (!(bits & 16)) mo = fminf(mo, cur[c + W + 1]);
      if (!(bits & 32)) mo = fminf(mo, cur[c + W - 1]);
      if (!(bits & 64)) mo = fminf(mo, cur[c - W + 1]);
      if (!(bits & 128)) mo = fminf(mo, cur[c - W - 1]);
      float best = fminf(d, fminf(__fadd_rn(ms, 1.0f), __fadd_rn(mo, kSq2)));
      if (blk[c]) best = kBig;
      nxt[c] = best;
      changed |= best < d;
    }
    const int any = __syncthreads_or(changed);
    float* t = cur;
    cur = nxt;
    nxt = t;
    ++sweeps;
    if (!any) break;
  }

  for (int c = tid; c < HW; c += kThreads) dist_out[base + c] = cur[c];
  if (tid == 0 && sweeps_out != nullptr) sweeps_out[blockIdx.x] = sweeps;

  if constexpr (PACKED) {
    // policy + flags into the free buffer (reused as int32 storage)
    int32_t* pol = reinterpret_cast<int32_t*>(nxt);
    for (int c = tid; c < HW; c += kThreads) {
      const int i = c / W, j = c - (c / W) * W;
      const uint8_t bits = inv[c];
      const float d = cur[c];
      float best_sc = 0.0f;
      int best_mv = 0;
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int ni = i + kDx[m], nj = j + kDy[m];
        const float w = (m < 4) ? 1.0f : kSq2;
        const bool in = ni >= 0 && ni < H && nj >= 0 && nj < W;
        float cand = __fadd_rn(in ? cur[ni * W + nj] : kBig, w);
        if (bits & (1u << m)) cand = kBig;
        if (m == 0) {
          best_sc = cand;
        } else if (cand < best_sc) {
          best_sc = cand;
          best_mv = m;
        }
      }
      const int flags = (static_cast<int>(best_sc >= kBig) << 3) |
                        (static_cast<int>(d <= 0.0f) << 4) |
                        (static_cast<int>(d >= kBig) << 5);
      pol[c] = best_mv | flags;
    }
    __syncthreads();
    // run length: walk the policy direction while cells keep the same
    // move and are not done, at most 16 cells (the JAX kernel's chain
    // doubling gives exactly min(true run, 16))
    for (int c = tid; c < HW; c += kThreads) {
      const int v = pol[c];
      const int mv = v & 7;
      int run = 0;
      if ((v & 0x38) == 0) {
        int i = c / W, j = c - (c / W) * W;
        while (run < kRunCap && i >= 0 && i < H && j >= 0 && j < W &&
               pol[i * W + j] == mv) {
          ++run;
          i += kDx[mv];
          j += kDy[mv];
        }
      }
      packed_out[base + c] = v | (run << 6);
    }
  }
}

// Shared memory a lane needs: two f32 fields, blocked and invalid bytes.
size_t smem_bytes(int H, int W) { return 10 * static_cast<size_t>(H) * W; }

}  // namespace

extern "C" {

// Launch K1 (packed != 0) or K2 on `stream` for B lanes.  blocked: (B,H,W)
// uint8 0/1; dist0: (B,H,W) f32; dist: (B,H,W) f32 out; packed: (B,H,W)
// int32 out (ignored for K2); sweeps: (B,) int32 out or null.  Returns
// the cudaError_t of the launch (0 on success).
int wavefront_launch(const void* blocked, const void* dist0, void* dist,
                     void* packed, void* sweeps, int B, int H, int W,
                     int n_iters, int packed_flag, void* stream) {
  const size_t smem = smem_bytes(H, W);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (packed_flag) {
    err = cudaFuncSetAttribute(wavefront_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    wavefront_kernel<true><<<B, kThreads, smem, s>>>(
        static_cast<const uint8_t*>(blocked), static_cast<const float*>(dist0),
        static_cast<float*>(dist), static_cast<int32_t*>(packed),
        static_cast<int32_t*>(sweeps), H, W, n_iters);
  } else {
    err = cudaFuncSetAttribute(wavefront_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    wavefront_kernel<false><<<B, kThreads, smem, s>>>(
        static_cast<const uint8_t*>(blocked), static_cast<const float*>(dist0),
        static_cast<float*>(dist), nullptr, static_cast<int32_t*>(sweeps), H,
        W, n_iters);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* wavefront_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
