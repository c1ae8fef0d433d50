// Octile wavefront kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of the JAX package,
// alore_legged_manipulator_tpu/ops/wavefront_pallas.py:
//   K1  wavefront_packed_pallas      (_wavefront_packed_kernel, :183-260)
//   K2  octile_distance_field_pallas (_wavefront_kernel, :172-180)
// One source; the template flag PACKED adds K1's policy pass to K2, the
// template parameter S is the strip length (below).
//
// What it computes, per lane: the octile distance-to-goal field of an
// (H, W) grid by early-exit Jacobi min-plus relaxation (at most n_iters
// sweeps, H + W by default), and for K1 the packed int32 word per cell --
// bits 0-2 the greedy move (strict <, first minimum in move order), bit 3
// stuck, bit 4 at goal, bit 5 disconnected, bits 6+ the straight run
// length min(true run, 16).  The start field is made here: 0 at the
// lane's goal cell if that cell is free, 1e9f elsewhere.  A negative goal
// index counts from the end once (-1 is the last row or column, as numpy
// indexing does); a goal that is still outside the grid sets no cell, so
// the field stays 1e9f everywhere and nothing is written out of bounds.
//
// What bounds it on this card.  The arithmetic is tiny (about 10 f32
// operations per cell per sweep) and device memory is touched once, so
// the limit is what the SM can dispatch in a sweep, times a chain of up to
// H + W sweeps that each end in a block-wide barrier.  Minimum, select,
// compare and bit tests run on the half-rate pipe of the SM (16 lanes a
// scheduler), so they, not the adds or the shared-memory loads, set a
// sweep's time: about 10 such instructions per cell that tests its masks,
// 4 per cell that need not.  A lane is one thread block on one SM.  The
// design cuts what a sweep costs and how many cells a sweep visits:
//
// * Register strips.  A thread owns S contiguous cells of one row.  The
//   strip's field values and one byte of mask bits per cell (bits 0-3 the
//   corner rule of the four diagonal moves, bit 4 the cell blocked; four
//   cells a register, built once from the blocked bits of the three
//   rows; the byte lets one R2P instruction set a cell's five predicates)
//   stay in registers for the whole relaxation.  Shared memory holds only
//   the f32 field, double buffered, with a border of 1e9f cells: one row
//   above and below, 4 floats left and at least 4 right of every row, so
//   that strips start 16-byte aligned and an out-of-grid neighbour reads
//   as 1e9f without a test (1e9f + 1 and 1e9f + sqrt(2) round to 1e9f).
//   Columns between W and the end of the last strip count as blocked.  A
//   sweep reads the rows above and below as float4 plus two border cells
//   each, and one cell left and right: S/2 + 6 loads for S cells in
//   place of 9 per cell, and no branch per neighbour: minimums predicated
//   on the mask bits.  Minimums of three use the integer min3 of the DPX
//   set, exact here because the field is non-negative.  A warp whose
//   recomputing strips have no blocked cell and no forbidden diagonal (the
//   common case on a map of few thick obstacles) votes itself onto a path
//   without mask tests that also shares the minimum of the cells above
//   and below a column between the three cells that use it (a build with
//   -DWAVEFRONT_NO_CLEAN leaves that path out, to measure it: it is worth
//   9% to 18% on the mission's map and costs up to 5% on random obstacles,
//   where no warp can take it).  Whether a
//   strip changed is the sum of its decreases (adds run on the full-rate
//   pipe), not a compare per cell.
// * Active-front sweeps.  One changed bit per strip, one 32-bit word per
//   row, in three rotating buffers (read: set in the last sweep; write:
//   set in this sweep with atomicOr; clear: zeroed for the next).  A thread
//   recomputes its strip only if its own bit or one of the up to 8
//   neighbouring strips' bits was set in the sweep before; otherwise its
//   registers and both field buffers already hold the sweep's result (its
//   own strip did not change in the last sweep, so the stale buffer holds
//   the same values).  This is exact for Jacobi: a cell's new value is a
//   function of its 3x3 neighbourhood in the previous field.  The start
//   field flags only the goal's strip, since an all-1e9f neighbourhood
//   maps to 1e9f.  Warps without a flagged strip skip their loads and go to
//   the barrier.  A warp is 32 consecutive rows of one strip column.  A
//   strip recomputes in a minority of its lane's sweeps and a warp in
//   about twice that share (a build with -DWAVEFRONT_PROFILE counts
//   both), so about half the lanes of a recomputing warp idle.  Patches of
//   16 rows by 2 strips as warps were tried: they changed the time by a few
//   per cent either way over the maps measured and were left out.
// * The sweep stays synchronous (Jacobi).  An in-place sweep reaches the
//   same fixed point but not the same field when n_iters cuts the
//   relaxation short, and not the same sweep count; both are part of the
//   function here.  The block-wide vote (__syncthreads_or) ends a lane at
//   the first sweep that changes nothing, one barrier a sweep.
// * The run length is the JAX kernel's chain doubling (spans 1, 2, 4, 8)
//   over the packed words, ping-ponged between the two field buffers: four
//   independent loads a cell in place of a dependent walk of up to 16.
//
// Residency.  Every instantiation is bounded to 64 registers
// (__launch_bounds__(1024)).  With many lanes the wrapper takes S = 20
// where it pads a row no more than 8 would: 80x80 runs 320 threads
// and 61,336 B a block, 3 blocks an SM (shared memory and registers both
// allow 3); 100x100 runs 512 threads (500 used) and 89,352 B, 2 blocks an
// SM.  This half-width block with long strips was taken over 800 or 1000
// threads with S = 8 or 10, which at 64 registers leave room for one
// block; measured at 4096 lanes it is the faster (80x80: 1.5 ms against
// 2.0 ms with S = 8).  With no more lanes than two per SM every lane is
// resident anyway, and the wrapper takes the shortest such strip (S = 8 at
// 80x80, 800 threads, one block an SM): more threads then shorten the one
// lane's sweep (64 lanes: 0.07 ms against 0.10 ms with S = 20).  S = 28
// serves grids that need more than 1024 threads otherwise (up to
// 161x161; a lane needs 8 B per bordered cell plus 12 B per bordered row,
// at most 232,448 B).  ptxas: 49-51 registers and no spill at S = 8, 64
// with 16-24 B of spill at S = 20 and 88-112 B at S = 28 (CUDA 12.8).  wavefront_occupancy reports what
// cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor
// give per instantiation and grid.
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
constexpr int kMaxThreads = 1024;
constexpr int kRunCap = 16;
constexpr int kPad = 4;  // border floats left and right of a row

__constant__ int kDx[8] = {1, -1, 0, 0, 1, 1, -1, -1};
__constant__ int kDy[8] = {0, 0, 1, -1, 1, -1, 1, -1};

// Geometry of one lane's block: strips a row, row pitch in floats, rows
// with border, threads (whole warps) and dynamic shared memory in bytes.
struct Geometry {
  int ns, pitch, rows, threads;
  size_t smem;
};

constexpr size_t kMaxSmem = 232448;

size_t smem_for(int rows, int pitch) {
  return static_cast<size_t>(rows) * (2 * pitch * 4 + 3 * 4);
}

Geometry geometry(int H, int W, int S) {
  Geometry g;
  g.ns = (W + S - 1) / S;
  g.rows = H + 2;
  g.pitch = g.ns * S + 2 * kPad;
  // consecutive threads own the same strip of consecutive rows: a pitch
  // of 4 mod 8 floats spreads the float4 loads of 8 of them over all 32
  // banks; taken where the wider rows still fit
  if (g.pitch % 8 == 0 && smem_for(g.rows, g.pitch + 4) <= kMaxSmem)
    g.pitch += 4;
  g.threads = ((H * g.ns + 31) / 32) * 32;
  g.smem = smem_for(g.rows, g.pitch);
  return g;
}

// Minimum of three field values.  The field holds only non-negative,
// non-NaN floats, whose order is that of their bit patterns as integers,
// so Hopper's three-input integer minimum gives the f32 minimum exactly.
__device__ __forceinline__ float min3(float a, float b, float c) {
  return __int_as_float(
      __vimin3_s32(__float_as_int(a), __float_as_int(b), __float_as_int(c)));
}

// Calls f(k, me, left, right, up-left, up, up-right, down-left, down,
// down-right) for the S cells of the strip at `off` in the bordered field
// `cur`, in ascending k.  `me`, `left` and `right` within the strip come
// from the registers v as they were before the call of f for that cell
// (f may overwrite v[k]); the rows above and below come from shared
// memory as float4 plus the two border cells.
template <int S, typename F>
__device__ __forceinline__ void visit_strip(const float* cur, int off,
                                            int pitch, float (&v)[S], F&& f) {
  const float* cu = cur + off - pitch;
  const float* cd = cur + off + pitch;
  float ul = cu[-1], dl = cd[-1];
  float4 uc = *reinterpret_cast<const float4*>(cu);
  float4 dc = *reinterpret_cast<const float4*>(cd);
  float prev = cur[off - 1];
  const float right = cur[off + S];
#pragma unroll
  for (int q = 0; q < S / 4; ++q) {
    float4 un4 = uc, dn4 = dc;
    float un, dn;
    if (q + 1 < S / 4) {
      un4 = *reinterpret_cast<const float4*>(cu + 4 * (q + 1));
      dn4 = *reinterpret_cast<const float4*>(cd + 4 * (q + 1));
      un = un4.x;
      dn = dn4.x;
    } else {
      un = cu[S];
      dn = cd[S];
    }
    const float uu[6] = {ul, uc.x, uc.y, uc.z, uc.w, un};
    const float dd[6] = {dl, dc.x, dc.y, dc.z, dc.w, dn};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int k = 4 * q + t;
      const float me = v[k];
      const float nx = (k + 1 < S) ? v[k + 1] : right;
      f(k, me, prev, nx, uu[t], uu[t + 1], uu[t + 2], dd[t], dd[t + 1],
        dd[t + 2]);
      prev = me;
    }
    ul = uc.w;
    dl = dc.w;
    uc = un4;
    dc = dn4;
  }
}

// One sweep of a strip whose cells are all free and have no forbidden
// diagonal: no mask tests, and the minimum of the cells above and below
// a column is taken once and shared by the three cells that use it.
// Returns the sum of the decreases (positive iff a cell changed).
template <int S>
__device__ __forceinline__ float relax_clean(const float* cur, int off,
                                             int pitch, float (&v)[S]) {
  const float* cu = cur + off - pitch;
  const float* cd = cur + off + pitch;
  float c[S + 2];  // c[j + 1]: min(above, below) of column j0 + j
  c[0] = fminf(cu[-1], cd[-1]);
  c[S + 1] = fminf(cu[S], cd[S]);
#pragma unroll
  for (int q = 0; q < S / 4; ++q) {
    const float4 a = *reinterpret_cast<const float4*>(cu + 4 * q);
    const float4 b = *reinterpret_cast<const float4*>(cd + 4 * q);
    c[4 * q + 1] = fminf(a.x, b.x);
    c[4 * q + 2] = fminf(a.y, b.y);
    c[4 * q + 3] = fminf(a.z, b.z);
    c[4 * q + 4] = fminf(a.w, b.w);
  }
  float prev = cur[off - 1];
  const float right = cur[off + S];
  float drop = 0.0f;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const float me = v[k];
    const float nx = (k + 1 < S) ? v[k + 1] : right;
    const float ms = min3(c[k + 1], prev, nx);
    const float mo = fminf(c[k], c[k + 2]);
    const float best = min3(me, __fadd_rn(ms, 1.0f), __fadd_rn(mo, kSq2));
    drop += me - best;
    prev = me;
    v[k] = best;
  }
  return drop;
}

template <int S, bool PACKED>
__global__ void __launch_bounds__(kMaxThreads)
wavefront_kernel(const uint8_t* __restrict__ blocked,
                 const int32_t* __restrict__ goal,
                 float* __restrict__ dist_out,
                 int32_t* __restrict__ packed_out,
                 int32_t* __restrict__ sweeps_out,
                 int32_t* __restrict__ profile_out,
                 int H, int W, int NS, int P, int n_iters) {
  static_assert(S % 4 == 0 && S + 2 <= 32, "strip length");
  // two bordered fields of R x P floats, then 3 x R flag words
  extern __shared__ __align__(16) float fld[];
  const int HW = H * W;
  const int R = H + 2;
  const int FS = R * P;
  uint32_t* flags = reinterpret_cast<uint32_t*>(fld + 2 * FS);

  // a warp is 32 consecutive rows of one strip column
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int strip = tid / H;
  const int row = tid - strip * H;
  const bool live = strip < NS;
  const int j0 = strip * S;
  // first cell of the strip in a bordered field
  const int off = (row + 1) * P + kPad + j0;
  const size_t base = static_cast<size_t>(blockIdx.x) * HW;

  // ---- blocked bits: one word per strip, border words all ones ----
  uint32_t* bits = reinterpret_cast<uint32_t*>(fld + FS);  // R x (NS + 2)
  const int BW = NS + 2;
  for (int c = tid; c < R * BW; c += T) bits[c] = 0xffffffffu;
  uint32_t own = 0;
  if (live) {
    const uint8_t* src = blocked + base + static_cast<size_t>(row) * W;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int j = j0 + k;
      const bool b = (j >= W) ? true : (src[j] != 0);
      own |= static_cast<uint32_t>(b) << k;
    }
  }
  __syncthreads();
  if (live) bits[(row + 1) * BW + strip + 1] = own;
  __syncthreads();

  // One byte of mask bits per cell, four cells a register: bits 0-3 the
  // corner rule of the four diagonal moves (both orthogonal step cells
  // blocked, cells past the border counting as blocked), bit 4 the cell
  // itself blocked.
  uint32_t mk[S / 4];
#pragma unroll
  for (int q = 0; q < S / 4; ++q) mk[q] = 0u;
  uint32_t mb = 0;
  if (live) {
    auto rowmask = [&](int r) -> uint32_t {  // bit 0 is column j0 - 1
      const uint32_t* w = bits + r * BW + strip;
      return ((w[0] >> (S - 1)) & 1u) | (w[1] << 1) | ((w[2] & 1u) << (S + 1));
    };
    const uint32_t U = rowmask(row), M = rowmask(row + 1), D = rowmask(row + 2);
    mb = M >> 1;
    const uint32_t i4 = (D >> 1) & (M >> 2);  // (+1,+1): (i+1, j), (i, j+1)
    const uint32_t i5 = (D >> 1) & M;         // (+1,-1): (i+1, j), (i, j-1)
    const uint32_t i6 = (U >> 1) & (M >> 2);  // (-1,+1)
    const uint32_t i7 = (U >> 1) & M;         // (-1,-1)
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const uint32_t byte = ((i4 >> k) & 1u) | (((i5 >> k) & 1u) << 1) |
                            (((i6 >> k) & 1u) << 2) | (((i7 >> k) & 1u) << 3) |
                            (((mb >> k) & 1u) << 4);
      mk[k >> 2] |= byte << (8 * (k & 3));
    }
  }
  // a strip without a blocked cell and without a forbidden diagonal can
  // take the sweep without mask tests
  uint32_t any_mask = 0u;
#pragma unroll
  for (int q = 0; q < S / 4; ++q) any_mask |= mk[q];
  const bool clean = any_mask == 0u;
  __syncthreads();

  // ---- start field: 1e9f everywhere (border included), 0 at the goal ----
  for (int c = tid; c < 2 * FS; c += T) fld[c] = kBig;
  for (int c = tid; c < 3 * R; c += T) flags[c] = 0u;
#ifdef WAVEFRONT_PROFILE
  __shared__ int prof[3];  // strip-sweeps, warp-sweeps, clean warp-sweeps
  if (tid < 3) prof[tid] = 0;
#endif
  float v[S];
#pragma unroll
  for (int k = 0; k < S; ++k) v[k] = kBig;
  int gi = goal[2 * blockIdx.x], gj = goal[2 * blockIdx.x + 1];
  if (gi < 0) gi += H;
  if (gj < 0) gj += W;
  const bool goal_mine = live && gi == row && gj >= j0 && gj < j0 + S &&
                         gj < W && gj >= 0;
  __syncthreads();
  if (goal_mine) {
    const int gk = gj - j0;
    if (!((mb >> gk) & 1u)) {
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (k == gk) v[k] = 0.0f;
      fld[off + gk] = 0.0f;
      fld[FS + off + gk] = 0.0f;
      flags[row + 1] = 1u << (strip + 1);
    }
  }
  __syncthreads();

  // ---- relaxation ----
  int cur = 0, nxt = FS;            // offsets of the two fields in fld
  int fr = 0, fw = R, fc = 2 * R;   // flag words: set in the last sweep,
                                    // set in this one, zeroed for the next
  int sweeps = 0;
  for (int it = 0; it < n_iters; ++it) {
    float drop = 0.0f;  // sum of this strip's decreases in this sweep
    if (live) {
      // bit s + 1 of a row's word is strip s: bits strip .. strip + 2 are
      // the strips left of, at and right of this one
      const uint32_t nb = (flags[fr + row] | flags[fr + row + 1] |
                           flags[fr + row + 2]) >> strip;
      if (strip == 0) flags[fc + row + 1] = 0u;
      if (nb & 7u) {
        // the warp's threads that recompute take one path together: the
        // masked one is right for every strip
#ifdef WAVEFRONT_NO_CLEAN
        const bool warp_clean = false;
#else
        const bool warp_clean = __all_sync(__activemask(), clean);
#endif
#ifdef WAVEFRONT_PROFILE
        {
          const unsigned act = __activemask();
          if ((tid & 31) == __ffs(act) - 1) {
            atomicAdd(&prof[0], __popc(act));
            atomicAdd(&prof[1], 1);
            atomicAdd(&prof[2], warp_clean ? 1 : 0);
          }
        }
#endif
        if (warp_clean) {
          drop = relax_clean<S>(fld + cur, off, P, v);
        } else {
          visit_strip<S>(fld + cur, off, P, v,
                         [&](int k, float me, float lf, float rt, float ul,
                             float up, float ur, float dl, float dn, float dr) {
            const uint32_t b = mk[k >> 2] >> (8 * (k & 3));
            const float ms = fminf(min3(dn, up, rt), lf);
            float mo = kBig;
            if (!(b & 1u)) mo = fminf(mo, dr);
            if (!(b & 2u)) mo = fminf(mo, dl);
            if (!(b & 4u)) mo = fminf(mo, ur);
            if (!(b & 8u)) mo = fminf(mo, ul);
            float best = min3(me, __fadd_rn(ms, 1.0f), __fadd_rn(mo, kSq2));
            if (b & 16u) best = kBig;
            drop += me - best;
            v[k] = best;
          });
        }
        float4* dst = reinterpret_cast<float4*>(fld + nxt + off);
#pragma unroll
        for (int q = 0; q < S / 4; ++q)
          dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                               v[4 * q + 3]);
        if (drop > 0.0f) atomicOr(&flags[fw + row + 1], 1u << (strip + 1));
      }
    }
    const int any = __syncthreads_or(drop > 0.0f);
    const int t = cur;
    cur = nxt;
    nxt = t;
    const int ft = fr;
    fr = fw;
    fw = fc;
    fc = ft;
    ++sweeps;
    if (!any) break;
  }

  // fld + cur holds the whole final field; write it out coalesced
  const float* fin = fld + cur;
  for (int c = tid; c < HW; c += T) {
    const int i = c / W, j = c - (c / W) * W;
    dist_out[base + c] = fin[(i + 1) * P + kPad + j];
  }
  if (tid == 0 && sweeps_out != nullptr) sweeps_out[blockIdx.x] = sweeps;
#ifdef WAVEFRONT_PROFILE
  // per lane: strips that recomputed and warps that had one, summed over
  // the sweeps; of those warps, the ones on the path without mask tests;
  // live strips and warps of the block
  if (tid == 0 && profile_out != nullptr) {
    int32_t* o = profile_out + 5 * blockIdx.x;
    o[0] = prof[0];
    o[1] = prof[1];
    o[2] = prof[2];
    o[3] = H * NS;
    o[4] = T / 32;
  }
#endif

  if constexpr (PACKED) {
    // policy + flags into the free buffer (reused as int32 storage)
    int32_t* pol = reinterpret_cast<int32_t*>(fld + nxt);
    int32_t word[S];
    if (live) {
      visit_strip<S>(fin, off, P, v,
                     [&](int k, float me, float lf, float rt, float ul,
                         float up, float ur, float dl, float dn, float dr) {
        // move order: (+1,0) (-1,0) (0,+1) (0,-1) (+1,+1) (+1,-1) (-1,+1)
        // (-1,-1), first index the row
        const uint32_t b = mk[k >> 2] >> (8 * (k & 3));
        float best_sc = __fadd_rn(dn, 1.0f);
        int best_mv = 0;
        auto take = [&](float cand, int m) {
          if (cand < best_sc) {
            best_sc = cand;
            best_mv = m;
          }
        };
        take(__fadd_rn(up, 1.0f), 1);
        take(__fadd_rn(rt, 1.0f), 2);
        take(__fadd_rn(lf, 1.0f), 3);
        take((b & 1u) ? kBig : __fadd_rn(dr, kSq2), 4);
        take((b & 2u) ? kBig : __fadd_rn(dl, kSq2), 5);
        take((b & 4u) ? kBig : __fadd_rn(ur, kSq2), 6);
        take((b & 8u) ? kBig : __fadd_rn(ul, kSq2), 7);
        const int flg = (static_cast<int>(best_sc >= kBig) << 3) |
                        (static_cast<int>(me <= 0.0f) << 4) |
                        (static_cast<int>(me >= kBig) << 5);
        // a cell that is not done starts a run of one
        word[k] = best_mv | flg | (flg == 0 ? 1 << 6 : 0);
      });
      int4* dst = reinterpret_cast<int4*>(pol + off);
#pragma unroll
      for (int q = 0; q < S / 4; ++q)
        dst[q] = make_int4(word[4 * q], word[4 * q + 1], word[4 * q + 2],
                           word[4 * q + 3]);
    }
    // run length min(true run, 16) by the JAX kernel's chain doubling:
    // entering the level of span s a cell holds L = min(true run, s) in
    // bits 6+ of its word; a cell with L == s adds the L of the cell s
    // steps ahead if that one keeps the same move and is not done.  The
    // words ping-pong between the two buffers, one barrier a level.
    int32_t* src = pol;
    int32_t* dst = reinterpret_cast<int32_t*>(fld + cur);
    __syncthreads();
#pragma unroll 1
    for (int span = 1; span < kRunCap; span *= 2) {
      if (live) {
#pragma unroll
        for (int k = 0; k < S; ++k) {
          const int w = word[k];
          if ((w >> 6) == span) {
            const int mv = w & 7;
            const int ni = row + span * kDx[mv];
            const int nj = j0 + k + span * kDy[mv];
            if (ni >= 0 && ni < H && nj >= 0 && nj < W) {
              const int nw = src[(ni + 1) * P + kPad + nj];
              if ((nw & 63) == mv) word[k] = w + (nw & ~63);
            }
          }
        }
        int4* out = reinterpret_cast<int4*>(dst + off);
#pragma unroll
        for (int q = 0; q < S / 4; ++q)
          out[q] = make_int4(word[4 * q], word[4 * q + 1], word[4 * q + 2],
                             word[4 * q + 3]);
      }
      __syncthreads();
      int32_t* t = src;
      src = dst;
      dst = t;
    }
    for (int c = tid; c < HW; c += T) {
      const int i = c / W, j = c - (c / W) * W;
      packed_out[base + c] = src[(i + 1) * P + kPad + j];
    }
  }
}

using KernelFn = void (*)(const uint8_t*, const int32_t*, float*, int32_t*,
                          int32_t*, int32_t*, int, int, int, int, int);

// The instantiation for strip length S, or null if there is none.
KernelFn kernel_for(int S, bool packed) {
  switch (S) {
    case 8:
      return packed ? wavefront_kernel<8, true> : wavefront_kernel<8, false>;
    case 20:
      return packed ? wavefront_kernel<20, true> : wavefront_kernel<20, false>;
    case 28:
      return packed ? wavefront_kernel<28, true> : wavefront_kernel<28, false>;
    default:
      return nullptr;
  }
}

}  // namespace

extern "C" {

// Launch K1 (packed != 0) or K2 on `stream` for B lanes with strips of S
// cells.  blocked: (B,H,W) uint8 0/1; goal: (B,2) int32; dist: (B,H,W) f32
// out; packed: (B,H,W) int32 out (ignored for K2); sweeps: (B,) int32 out
// or null; profile: (B,5) int32 out or null, written only by a build with
// -DWAVEFRONT_PROFILE.  Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for a strip length without an instantiation or a
// block of more than 1024 threads.
int wavefront_launch(const void* blocked, const void* goal, void* dist,
                     void* packed, void* sweeps, void* profile, int B, int H,
                     int W, int S, int n_iters, int packed_flag,
                     void* stream) {
  KernelFn fn = kernel_for(S, packed_flag != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(H, W, S);
  if (g.threads > kMaxThreads || g.ns + 2 > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<B, g.threads, g.smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocked), static_cast<const int32_t*>(goal),
      static_cast<float*>(dist),
      packed_flag ? static_cast<int32_t*>(packed) : nullptr,
      static_cast<int32_t*>(sweeps), static_cast<int32_t*>(profile), H, W,
      g.ns, g.pitch, n_iters);
  return static_cast<int>(cudaGetLastError());
}

// What the runtime reports for one instantiation at one grid size:
// out[0] resident blocks per SM, out[1] registers per thread, out[2]
// threads per block, out[3] dynamic shared memory per block in bytes,
// out[4] spilled (local) bytes per thread.  Returns a cudaError_t.
int wavefront_occupancy(int H, int W, int S, int packed_flag, int* out) {
  KernelFn fn = kernel_for(S, packed_flag != 0);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(H, W, S);
  const void* f = reinterpret_cast<const void*>(fn);
  cudaError_t err = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(g.smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, f);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, g.threads,
                                                      g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = g.threads;
  out[3] = static_cast<int>(g.smem);
  out[4] = static_cast<int>(attr.localSizeBytes);
  return 0;
}

const char* wavefront_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
