// Shear-rotate fan projector kernels for Hopper (sm_90a): the rotate stage
// (K4), its exact adjoint (K5) and the fused A^T A G-contraction (K6) of
// ShearFanProjector (trips_tpu_torch/operators/shear_kernels.py holds the
// wrappers and the plain PyTorch versions they are tested against).
//
// Canvas conventions: C x C canvases, row i, column j, C-contiguous. Per
// view a, kx/fx (na, C) hold the integer and fractional x-shift of each
// row, ky/fy (na, C) the y-shift of each column, kq (na,) the quarter turn.
// One shear along a line with shift (k, f) is
//
//   out(c) = (1 - f) * in((c + k) mod C) + f * in((c + k + 1) mod C)
//
// K4 (replaces rotate_all_pallas, trips_tpu/operators/pallas_shear.py:99):
// quarter canvas kq[a] -> x-shear, y-shear, x-shear -> (na, C, C), rounded
// once to the output type. The TPU kernel keeps a whole canvas in VMEM and
// rolls it three times; a 640 KB f32 canvas does not fit a block's shared
// memory here. Its bound on this card is bytes: the (na, C, C) canvases
// written once (19.2 MB in bf16 at C = 400, 60 views: 6 us at 3.35 TB/s),
// the quarter canvases (1.9 MB) read from L2. What costs is the gathers'
// index work: the three shears compose to 8 gathers per output.
//
// The staged tile: one block per (view, TY x TX output tile). An output row
// i reads the stage-2 row at columns (j + kx[i]) and one to the right; over
// a tile those are one window of W2 columns (TX + 1 + the spread of kx over
// the tile's rows). Window column c reads stage-1 rows i + ky[c] and one
// below: TY + 1 rows per window column, R1 rows in all (TY + 1 + the spread
// of ky over the window). The block loads one 16-byte record per window
// row and column into shared memory, computes the window's stage-1 values
// (2-tap gathers from the quarter canvas in L2, a thread's issued
// together), then each thread the stage-2 values and the outputs of its
// kRows x kVec patch, one vector store per row: ~2.3 canvas reads and
// ~1.25 stage-2 blends per output instead of 8 and 2. rotate_plan
// (operators/shear_kernels.py) makes the window sizes, each tile's start
// and the shifts reduced mod C once per shift set in Python, so the kernel
// computes no % and no window; it refuses a plan it cannot run.
//
// K5 (replaces rotate_all_adjoint_pallas, pallas_shear.py:122): the exact
// transpose, out(c) = (1 - f) * g((c - k) mod C) + f * g((c - k - 1) mod C)
// per stage, stages in reverse order. With k' = -k - 1 that reads columns
// c + k' and c + k' + 1 with the weights turned round, so K5 runs K4's tile
// routine on g[a] with the plan's shifts (-k - 1) mod C and blends
// (1 - f) * hi + f * lo. The TPU carries each quarter's sum across a
// sequential grid. Here a block owns one tile and a chunk of one quarter's
// views (the plan's order) and adds them in registers in that order:
// deterministic, no atomics, no cluster, no view of another quarter
// visited. Each chunk writes a float32 partial plane, and a second pass
// sums a quarter's planes in chunk order. Chunks of 4 views are taken: on
// an H100 (700 W) they ran 0.070-0.076 ms against 0.107-0.121 for a whole
// quarter per block (written directly, no second pass) at 16x64 tiles,
// where quarter 1's 29 views in one block set the tail.
// Bound: the (na, C, C) cotangents read once (19.2 MB in bf16).
//
// Where the time goes (timed at the K4/K5 redesign on copies of this file
// with parts patched out, CHANGES.md; an H100 at 700 W, bf16, the plans
// taken):
// of K4's 0.058 ms, stage 1 takes 0.030 (0.011 of it the gathers), stages
// 2 and 3 0.010, the shift records 0.006, launch and stores 0.011; of K5's
// 0.077, stage 1 0.042 (0.025 the gathers, 0.011 the row records'
// dependent loads), stages 2 and 3 0.012, the shift records (once per
// view) 0.012, launch, stores and the second pass 0.010. Mapping stage 1's
// lanes along one canvas row (coalesced gathers, three forms) ran slower
// in every form: a lane per value, its gathers issued together, is kept.
//
// K6 (replaces gcontract_ata_pallas, pallas_shear.py:183): with R (na, C*C)
// and G (C*C, p_pad) in one storage type T,
//
//   U   = R . G                 f32 sums, then rounded to T
//   out = U . G^T               f32 sums, float32 out
//
// Work: 2 x 2 x na x C*C x p_pad flops (14.7 GFLOP at C = 400, 60 views,
// p_pad = 384) against G (123 MB in bf16), R (19 MB) and out (38 MB): with
// bf16 operands on the tensor cores the kernel is bound by bytes (54 us at
// 3.35 TB/s against 15 us of arithmetic at 989 TFLOP/s). So:
//
// - bf16 G: both products on wgmma, fed by TMA through rings of shared-
//   memory stages (one producer warp issues the loads, consumer
//   warpgroups the wgmmas), M = 64 views per tile (rows na..63 are TMA's
//   zero fill and never stored). The first product streams G as an
//   MN-major B operand (detectors contiguous), split over the C*C axis so
//   that every SM has a chunk; float32 partials are summed in a fixed
//   order (deterministic) and U is rounded to bf16. The second product
//   keeps U (64 x p_pad) resident in shared memory and streams G as a
//   K-major B operand.
// - float32 G: products as accurate as float32 need 3xTF32 (each operand
//   split into a TF32 high and low part, hi.hi + hi.lo + lo.hi), on wgmma
//   with A in registers, split there: TF32 wgmma reads a shared-memory
//   operand only K-major, so the first product runs transposed (U^T =
//   G^T . R^T, the G tile as A) and the second takes U as A. Same
//   chunking and order as the bf16 path.
//
// G is read twice per call (once per product). Reading it once, as the TPU
// kernel streams it, would need the 38 MB f32 output resident across
// detector tiles, more than the card's on-chip memory; instead the second
// product walks each chunk backward, so its first reads hit the rows of G
// the first product left in L2 (50 MB). Deviation: at 256x256/60 views the
// TPU plan falls back to a bf16 cross-tile accumulator for lack of VMEM;
// this kernel always sums in float32 across the whole detector axis.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

enum Kind { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float ld(const float* p, size_t k) {
  return __ldg(p + k);
}
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t k) {
  return __bfloat162float(p[k]);
}
__device__ __forceinline__ void st(float* p, size_t k, float v) { p[k] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t k, float v) {
  p[k] = __float2bfloat16(v);
}

// ---- K4 and K5: the staged tile ---------------------------------------------
constexpr int kVec = 4;              // neighbouring outputs per thread and row
constexpr int kRows = 2;             // output rows per thread
constexpr int kSeg = 4;              // stage-1 rows per thread and column
constexpr int kRotMaxThreads = 512;
// dynamic shared memory a block may have: 227 KB less 1 KB for K5's
// static view list
constexpr int kSmemMax = 231424;

// The plan's sizes: canvas C, tile TY x TX, window columns W2, stage-1 rows
// R1 (rotate_plan in operators/shear_kernels.py).
struct Dims {
  int C, ty, tx, w2, r1;
};

// Words per stage-1 row: window column t sits at (t % 4) Q + t / 4, Q the
// least >= ceil(W2 / 4) with Q = 8 mod 32, so that 32 neighbouring columns
// (stage 1's lanes) and columns 4 apart (stage 3's lanes) fall in distinct
// banks.
__host__ __device__ inline int rotate_quarter(int w2) {
  const int q = (w2 + 3) / 4;
  return q + ((8 - q % 32) + 32) % 32;
}

// 32-bit words of shared memory one tile takes (rotate_plan's smem_bytes is
// four times this).
__host__ __device__ inline long long rotate_smem_words(int ty, int w2,
                                                       int r1) {
  return 4LL * r1 + 4LL * w2 + 2LL * ty +
         (ty + 1LL) * 4 * rotate_quarter(w2);
}

struct Tile {
  int4* rw;   // [R1] row window: row * C, its x-shift, blend (bits)
  int4* cw;   // [W2] window column: canvas column, its row offset dy, blend
  int2* tr;   // [TY] output row: window column of its first tap minus its
              //      column in the tile, blend
  float* s1;  // [(TY + 1) x 4Q] stage 1: row u of window column t at
              //      u 4Q + (t % 4) Q + t / 4
  int q;
};

__device__ __forceinline__ Tile carve(float* p, const Dims& d) {
  Tile s;
  s.rw = reinterpret_cast<int4*>(p);
  s.cw = reinterpret_cast<int4*>(p + 4 * d.r1);
  s.tr = reinterpret_cast<int2*>(p + 4 * (d.r1 + d.w2));
  s.s1 = p + 4 * (d.r1 + d.w2) + 2 * d.ty;
  s.q = rotate_quarter(d.w2);
  return s;
}

// a - C if a >= C; a + C if a < 0 (a in (-C, 2C)).
__device__ __forceinline__ int fold(int a, int C) {
  return a >= C ? a - C : (a < 0 ? a + C : a);
}

// One 2-tap blend of the taps at c + k (lo) and c + k + 1 (hi), the
// expression of the plain versions: K4 (1 - f) in(c + k) + f in(c + k + 1);
// K5, whose plan shifts are k' = -k - 1, (1 - f) g(c - k) + f g(c - k - 1).
template <bool ADJ>
__device__ __forceinline__ float blend(float f, float lo, float hi) {
  return ADJ ? (1.f - f) * hi + f * lo : (1.f - f) * lo + f * hi;
}

// The tile routine of K4 and K5: one view's TY x TX tile at (i0, j0) of
// `src` (one C x C canvas) through the three shears, with the view's plan
// shifts kx, ky (reduced mod C) and blends fx, fy; (xs, ys) are the tile's
// first window column and first window row from the plan. Thread (r, jl)
// gets outputs (i0 + r + m, j0 + jl + q) in v[m][q]. Starts with a barrier,
// so a loop over views may call it again. What it costs is instructions
// per output (the header's ablations), hence no % and one shared-memory
// record per line of shifts.
template <bool ADJ, typename IT>
__device__ __forceinline__ void tile_view(
    const IT* __restrict__ src, const int* __restrict__ kxa,
    const float* __restrict__ fxa, const int* __restrict__ kya,
    const float* __restrict__ fya, int xs, int ys, int i0, int j0,
    const Dims& d, const Tile& s, int r, int jl,
    float (&v)[kRows][kVec]) {
  const int tid = threadIdx.x, nt = blockDim.x, C = d.C;
  __syncthreads();  // the last view's stage 3 is done with shared memory
  // the row window, the window columns and the tile's rows, in one pass,
  // each part starting on a warp
  const int p1 = (d.r1 + 31) & ~31, p2 = p1 + ((d.w2 + 31) & ~31);
  for (int e = tid; e < p2 + d.ty; e += nt) {
    if (e < p1) {
      if (e < d.r1) {
        int w = ys + e;
        while (w >= C) w -= C;
        s.rw[e] = make_int4(w * C, kxa[w], __float_as_int(fxa[w]), 0);
      }
    } else if (e < p2) {
      const int t = e - p1;
      if (t < d.w2) {
        int c = xs + t;
        while (c >= C) c -= C;
        s.cw[t] = make_int4(c, fold(i0 + kya[c] - ys, C),
                            __float_as_int(fya[c]), 0);
      }
    } else {
      const int m = e - p2, i = i0 + m;
      // rows past the canvas: computed, not stored
      s.tr[m] = i < C ? make_int2(fold(j0 + kxa[i] - xs, C),
                                  __float_as_int(fxa[i]))
                      : make_int2(0, 0);
    }
  }
  __syncthreads();
  // stage 1: row u of window column t is window row dy[t] + u, its x-shear
  // read at column col[t] + kx (and the next) from `src`; a thread takes
  // kSeg rows of one column, its gathers issued together
  const int segs = (d.ty + kSeg) / kSeg, row4 = 4 * s.q;
  for (int e = tid; e < segs * d.w2; e += nt) {
    const int g = e / d.w2, t = e - g * d.w2, u0 = g * kSeg;
    const int4 cw = s.cw[t];
    float* out1 = s.s1 + (t & 3) * s.q + (t >> 2);
    float lo[kSeg], hi[kSeg], f[kSeg];
#pragma unroll
    for (int m = 0; m < kSeg; ++m) {
      if (u0 + m > d.ty) break;
      const int4 rw = s.rw[cw.y + u0 + m];
      int cc = cw.x + rw.y;
      if (cc >= C) cc -= C;
      const int c2 = cc + 1 == C ? 0 : cc + 1;
      const IT* p = src + rw.x;
      lo[m] = ld(p, cc);
      hi[m] = ld(p, c2);
      f[m] = __int_as_float(rw.z);
    }
#pragma unroll
    for (int m = 0; m < kSeg; ++m) {
      if (u0 + m > d.ty) break;
      out1[(u0 + m) * row4] = blend<ADJ>(f[m], lo[m], hi[m]);
    }
  }
  __syncthreads();
  // stages 2 and 3: output (r, jl + q) reads the stage-2 values of window
  // columns jl + q + dk[r] and the next, each a blend of stage-1 rows r and
  // r + 1 of its column
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const int2 tr = s.tr[r + m];
    const float f3 = __int_as_float(tr.y);
    const float* a1 = s.s1 + (r + m) * row4;
    float s2[kVec + 1];
#pragma unroll
    for (int q = 0; q <= kVec; ++q) {
      const int t = jl + q + tr.x;
      const int at = (t & 3) * s.q + (t >> 2);
      s2[q] = blend<ADJ>(__int_as_float(s.cw[t].z), a1[at], a1[at + row4]);
    }
#pragma unroll
    for (int q = 0; q < kVec; ++q) v[m][q] = blend<ADJ>(f3, s2[q], s2[q + 1]);
  }
}

__device__ __forceinline__ void st_vec(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st_vec(__nv_bfloat16* p,
                                       const float (&v)[kVec]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 w;
  w.x = *reinterpret_cast<uint32_t*>(&a);
  w.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = w;
}

// Thread (r, jl)'s outputs at canvas rows i .. i + kRows - 1, columns
// j .. j + kVec - 1 of `plane`: vector stores where C keeps them aligned,
// else one by one.
template <typename T>
__device__ __forceinline__ void store_tile(T* plane, int i, int j,
                                           const float (&v)[kRows][kVec],
                                           int C) {
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    if (i + m >= C || j >= C) return;
    T* p = plane + static_cast<size_t>(i + m) * C + j;
    if (C % kVec == 0) {
      st_vec(p, v[m]);
    } else {
#pragma unroll
      for (int q = 0; q < kVec; ++q)
        if (j + q < C) st(p, q, v[m][q]);
    }
  }
}

// Thread t's first output row and column in a tile of TX columns.
__device__ __forceinline__ int2 thread_spot(int tx) {
  const int per_row = tx / kVec;
  const int rp = threadIdx.x / per_row;
  return make_int2(rp * kRows, (threadIdx.x - rp * per_row) * kVec);
}

// K4: grid (tiles, na), TY * TX / (kVec kRows) threads; block (tile, a)
// rotates view a's tile from quarter kq[a]. starts (na, tiles) holds
// (xs, ys); kx, ky the plan's shifts.
template <typename OT>
__global__ void __launch_bounds__(kRotMaxThreads)
    rotate_tile_kernel(const float* __restrict__ Q, const int* __restrict__ kx,
                       const float* __restrict__ fx,
                       const int* __restrict__ ky,
                       const float* __restrict__ fy,
                       const int* __restrict__ kq,
                       const int2* __restrict__ starts, OT* __restrict__ out,
                       Dims d, int ntx) {
  extern __shared__ float smem[];
  const Tile s = carve(smem, d);
  const int a = blockIdx.y, C = d.C, tyi = blockIdx.x / ntx;
  const int i0 = tyi * d.ty, j0 = (blockIdx.x - tyi * ntx) * d.tx;
  const int2 rj = thread_spot(d.tx);
  const int2 at = starts[static_cast<size_t>(a) * gridDim.x + blockIdx.x];
  const size_t off = static_cast<size_t>(a) * C;
  float v[kRows][kVec];
  tile_view<false>(Q + static_cast<size_t>(kq[a]) * C * C, kx + off,
                   fx + off, ky + off, fy + off, at.x, at.y, i0, j0, d, s,
                   rj.x, rj.y, v);
  store_tile(out + off * C, i0 + rj.x, j0 + rj.y, v, C);
}

// K5: grid (tiles, chunks); chunk c = (first, count, slot) takes views
// order[first .. first + count) (all of one quarter) in that order, sums
// the tile in registers and writes it to plane `slot` of dst once. starts
// (na, tiles) holds the transposed chain's (xs, ys); kx, ky the plan's
// shifts (-k - 1 reduced mod C).
template <typename IT>
__global__ void __launch_bounds__(kRotMaxThreads)
    rotate_adj_tile_kernel(const IT* __restrict__ Gc,
                           const int* __restrict__ kx,
                           const float* __restrict__ fx,
                           const int* __restrict__ ky,
                           const float* __restrict__ fy,
                           const int* __restrict__ order,
                           const int* __restrict__ chunks,
                           const int2* __restrict__ starts,
                           float* __restrict__ dst, Dims d, int ntx) {
  extern __shared__ float smem[];
  const Tile s = carve(smem, d);
  const int C = d.C, tyi = blockIdx.x / ntx;
  const int i0 = tyi * d.ty, j0 = (blockIdx.x - tyi * ntx) * d.tx;
  const int2 rj = thread_spot(d.tx);
  const int* ch = chunks + 3 * blockIdx.y;
  __shared__ int3 views[32];  // (a, xs, ys) of up to 32 views of the chunk
  float acc[kRows][kVec] = {};
  for (int n0 = 0; n0 < ch[1]; n0 += 32) {
    const int nv = min(32, ch[1] - n0);
    __syncthreads();  // the last group's views are read
    if (threadIdx.x < nv) {
      const int a = order[ch[0] + n0 + threadIdx.x];
      const int2 at =
          starts[static_cast<size_t>(a) * gridDim.x + blockIdx.x];
      views[threadIdx.x] = make_int3(a, at.x, at.y);
    }
    __syncthreads();
    for (int n = 0; n < nv; ++n) {
      const int3 w = views[n];
      const size_t off = static_cast<size_t>(w.x) * C;
      float v[kRows][kVec];
      tile_view<true>(Gc + off * C, kx + off, fx + off, ky + off, fy + off,
                      w.y, w.z, i0, j0, d, s, rj.x, rj.y, v);
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int q = 0; q < kVec; ++q) acc[m][q] += v[m][q];
    }
  }
  store_tile(dst + static_cast<size_t>(ch[2]) * C * C, i0 + rj.x, j0 + rj.y,
             acc, C);
}

// K5's second pass: out[z] = sum of the partial planes
// qfirst[z] .. qfirst[z + 1] - 1, in that order (zero for none). grid
// (ceil(C*C / 256), 3).
__global__ void rotate_adj_reduce(const float* __restrict__ P,
                                  const int* __restrict__ qfirst,
                                  float* __restrict__ out, int CC) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x, z = blockIdx.y;
  if (e >= CC) return;
  float v = 0.f;
  for (int c = qfirst[z]; c < qfirst[z + 1]; ++c)
    v += P[static_cast<size_t>(c) * CC + e];
  out[static_cast<size_t>(z) * CC + e] = v;
}

// ---- K6 -------------------------------------------------------------------
// Both products take the views in tiles of 64 (blockIdx.y) and split the
// C*C axis K into nsplit chunks of `chunk` rows (a multiple of 64), one
// chunk per block (blockIdx.x): the first product writes one float32
// partial (64 x N) per chunk, ata_reduce_kernel sums the partials in chunk
// order and rounds U to T, and the second product walks the same chunk's
// output columns from its end back to its start, so it first reads the
// rows of G that the first product read last and L2 still holds.
constexpr int kKTile = 64;  // k rows per stage; output columns per tile

// -- bf16 G: wgmma fed by TMA -----------------------------------------------
// One stage of the first product: the R box (64 views x 64 k, K-major) and
// up to six G boxes (64 k x 64 detectors each, detectors contiguous: an
// MN-major B operand), each box 8 KB, 128-byte swizzled as TMA writes it.
constexpr int kBox = 8192;
constexpr int kP1Boxes = 6;   // 384 detectors per block (blockIdx.z)
constexpr int kP1Stages = 3;
constexpr int kP1Stage = (1 + kP1Boxes) * kBox;
constexpr int kP2Stages = 8;  // second product: one G box per stage
constexpr int kAlign = 1024;    // swizzle atoms are 1024-byte aligned

// D (64 x 192, f32) += A (64 x 16, K-major) . B (16 x 192, MN-major), bf16
// operands in shared memory; thread t of the warpgroup holds rows
// 16 (t / 32) + (t % 32) / 4 (+ 8) and columns 8 j + 2 (t % 4) (+ 1) of each
// n8 chunk j, in d[4 j .. 4 j + 3].
__device__ __forceinline__ void wgmma_m64n192_mnb(float (&d)[96], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db));
}

// D (64 x 64, f32) += A (64 x 16, K-major) . B (16 x 64, K-major), the same
// fragment layout.
__device__ __forceinline__ void wgmma_m64n64_kb(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// D (64 x 64, f32) += A (64 x 8, registers: a[0..3] at rows g, g + 8 and
// columns q, q + 4 of the warp's 16 rows) . B (8 x 64, K-major, shared
// memory), tf32 operands (float32 bit patterns with the low 13 mantissa
// bits ignored).
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  const uint32_t a = hopper::smem_addr(p);
  return p + ((kAlign - (a % kAlign)) % kAlign);
}

// First product, bf16: P[s, a, d] = sum over k in chunk s of R[a, k] G[k, d].
// grid (nsplit, ceil(na / 64), ceil(N / 384)); 2 consumer warpgroups (192
// detectors each) and one producer warp.
__global__ void __launch_bounds__(288)
    ata_p1_wgmma(const __grid_constant__ CUtensorMap mR,
                 const __grid_constant__ CUtensorMap mG,
                 float* __restrict__ P, int na, int K, int N, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = align_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kP1Stages * kP1Stage);
  uint64_t* empty = full + kP1Stages;
  const int kb = blockIdx.x * chunk, a0 = blockIdx.y * 64;
  const int n0 = blockIdx.z * kP1Boxes * 64;
  const int nk = (min(K, kb + chunk) - kb + kKTile - 1) / kKTile;
  const int nbox = min(kP1Boxes, (N - n0 + 63) / 64);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kP1Stages; ++s) {
      hopper::bar_init(&full[s], 1);
      hopper::bar_init(&empty[s], (nbox + 2) / 3);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (wg == 2) {  // producer warp
    if (threadIdx.x == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kP1Stages;
        if (kt >= kP1Stages)
          hopper::bar_wait(&empty[s], ((kt / kP1Stages) - 1) & 1);
        uint8_t* st = tiles + s * kP1Stage;
        const int k = kb + kt * kKTile;
        hopper::bar_expect_tx(&full[s], (1 + nbox) * kBox);
        hopper::tma_load_2d(st, &mR, &full[s], k, a0);
        for (int j = 0; j < nbox; ++j)
          hopper::tma_load_2d(st + (1 + j) * kBox, &mG, &full[s],
                              n0 + 64 * j, k);
      }
    }
    return;
  }
  if (3 * wg >= nbox) return;  // no detectors for this warpgroup
  float acc[96];
#pragma unroll
  for (int i = 0; i < 96; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kP1Stages;
    hopper::bar_wait(&full[s], (kt / kP1Stages) & 1);
    const uint8_t* st = tiles + s * kP1Stage;
    hopper::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t da = hopper::desc_sw128(st + ks * 32, 16, 1024);
      const uint64_t db = hopper::desc_sw128(
          st + (1 + 3 * wg) * kBox + ks * 2048, kBox, 1024);
      wgmma_m64n192_mnb(acc, da, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    if (threadIdx.x % 128 == 0) hopper::bar_arrive(&empty[s]);
  }
  const int t = threadIdx.x % 128;
  const int r = a0 + 16 * (t / 32) + (t % 32) / 4;
  float* Ps = P + static_cast<size_t>(blockIdx.x) * na * N;
#pragma unroll
  for (int j = 0; j < 24; ++j) {
    const int d = n0 + 192 * wg + 8 * j + 2 * (t % 4);
    if (d >= N) continue;
    if (r < na)
      *reinterpret_cast<float2*>(Ps + static_cast<size_t>(r) * N + d) =
          make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < na)
      *reinterpret_cast<float2*>(Ps + static_cast<size_t>(r + 8) * N + d) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// Second product, bf16: out[a, k] = sum over d of U[a, d] G[k, d] for k in
// chunk blockIdx.x, 64 columns per tile from the chunk's end back to its
// start. U (64 x N, K-major) stays in shared memory; G boxes (64 k x 64
// detectors, K-major) stream through an 8-stage ring. grid (nsplit,
// ceil(na / 64)); one consumer warpgroup and one producer warp.
__global__ void __launch_bounds__(160)
    ata_p2_wgmma(const __grid_constant__ CUtensorMap mU,
                 const __grid_constant__ CUtensorMap mG,
                 float* __restrict__ out, int na, int K, int N, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = align_smem(smem_raw);
  const int nub = N / 64;
  uint8_t* ring = tiles + nub * kBox;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kP2Stages * kBox);
  uint64_t* empty = full + kP2Stages;
  uint64_t* ubar = empty + kP2Stages;
  const int kb = blockIdx.x * chunk, a0 = blockIdx.y * 64;
  const int nt = (min(K, kb + chunk) - kb + kKTile - 1) / kKTile;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kP2Stages; ++s) {
      hopper::bar_init(&full[s], 1);
      hopper::bar_init(&empty[s], 1);
    }
    hopper::bar_init(ubar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128) {  // producer warp
    if (threadIdx.x == 128) {
      hopper::bar_expect_tx(ubar, nub * kBox);
      for (int j = 0; j < nub; ++j)
        hopper::tma_load_2d(tiles + j * kBox, &mU, ubar, 64 * j, a0);
      int it = 0;
      for (int tile = nt - 1; tile >= 0; --tile) {
        for (int j = 0; j < nub; ++j, ++it) {
          const int s = it % kP2Stages;
          if (it >= kP2Stages)
            hopper::bar_wait(&empty[s], ((it / kP2Stages) - 1) & 1);
          hopper::bar_expect_tx(&full[s], kBox);
          hopper::tma_load_2d(ring + s * kBox, &mG, &full[s], 64 * j,
                              kb + tile * kKTile);
        }
      }
    }
    return;
  }
  hopper::bar_wait(ubar, 0);
  const int t = threadIdx.x;
  const int r = a0 + 16 * (t / 32) + (t % 32) / 4;
  int it = 0;
  for (int tile = nt - 1; tile >= 0; --tile) {
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int j = 0; j < nub; ++j, ++it) {
      const int s = it % kP2Stages;
      hopper::bar_wait(&full[s], (it / kP2Stages) & 1);
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t da =
            hopper::desc_sw128(tiles + j * kBox + ks * 32, 16, 1024);
        const uint64_t db =
            hopper::desc_sw128(ring + s * kBox + ks * 32, 16, 1024);
        wgmma_m64n64_kb(acc, da, db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      if (t == 0) hopper::bar_arrive(&empty[s]);
    }
    const int k0 = kb + tile * kKTile;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + 8 * j + 2 * (t % 4);
      if (k >= K) continue;
      if (r < na)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * K + k) =
            make_float2(acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < na)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r + 8) * K + k) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// -- float32 G: 3xTF32 on wgmma -----------------------------------------------
// x = hi + lo with hi = tf32(x), lo = tf32(x - hi); a b = hi_a hi_b +
// hi_a lo_b + lo_a hi_b up to lo_a lo_b (2^-22 relative). TF32 wgmma reads
// a shared-memory operand only K-major, and in U = R . G the G tile is not
// (its detectors are contiguous), so the first product runs transposed,
// U^T = G^T . R^T: A is a G tile that each thread loads from shared memory
// into registers (any layout loads) and splits there, B is the R box
// (K-major: k is contiguous in R's rows), split in shared memory into its
// high part (in place) and low part (a second buffer). Each k32 stage's sum
// joins a float32 running sum, so the long sums over k round as float32
// adds do (a whole chunk in the tensor core's accumulator was off by
// 8.8e-6 at random G on an H100, against 1.1e-6).
constexpr int kF32Box = 64 * 32 * 4;  // 64 rows of 32 float32 (128 B), 8 KB
constexpr int kGBox = 32 * 32 * 4;    // 32 k x 32 detectors, 4 KB
constexpr int kP1F32WG = 2;  // consumer warpgroups of the first product
constexpr int kP1F32MT = 3;  // m64 tiles (64 detectors) per warpgroup
constexpr int kP1F32Det = 64 * kP1F32MT * kP1F32WG;  // 384 per block
constexpr int kP1F32Boxes = kP1F32Det / 32;
constexpr int kP1F32Stage = 2 * kF32Box + kP1F32Boxes * kGBox;  // 64 KB
constexpr int kP1F32Stages = 3;
constexpr int kP1F32Consumers = 128 * kP1F32WG;
constexpr int kP1F32Threads = kP1F32Consumers + 32;

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// An A fragment (4 values) split into hi and lo.
struct Split4 {
  uint32_t hi[4], lo[4];
  Split4() = default;
  __device__ __forceinline__ explicit Split4(const float* v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
  }
};

// Split a 128-byte-swizzled float32 box in shared memory: its TF32 high
// part in place, its low part at the same offsets in `lo`; threads
// [0, nthreads) share the work. The caller fences and syncs.
__device__ __forceinline__ void split_box(uint8_t* hi, uint8_t* lo,
                                          int bytes, int tid, int nthreads) {
  float4* h4 = reinterpret_cast<float4*>(hi);
  float4* l4 = reinterpret_cast<float4*>(lo);
  for (int e = tid; e < bytes / 16; e += nthreads) {
    float4 v = h4[e], w;
    float* vv = &v.x;
    float* ww = &w.x;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t h, l;
      split_tf32(vv[c], h, l);
      vv[c] = __uint_as_float(h);
      ww[c] = __uint_as_float(l);
    }
    h4[e] = v;
    l4[e] = w;
  }
}

// Byte offset of float x of row r in a box of 32-float rows, 128-byte
// swizzled as TMA writes it (16-byte chunk index XOR r mod 8).
__device__ __forceinline__ int sw128_f32(int r, int x) {
  return r * 128 + ((((x >> 2) ^ r) & 7) << 4) + ((x & 3) << 2);
}

// First product, float32: P[s, a, d] = sum over k in chunk s of R[a, k]
// G[k, d]. grid (nsplit, ceil(na / 64), ceil(N / 384)); consumer warpgroup
// wg owns kP1F32MT m64 tiles (64 detectors each) of the block's 384, and a
// producer warp streams each k32 stage (the R box, 64 views x 32 k, and 12
// G boxes, 32 k x 32 detectors) through a 3-stage ring.
//
// Row m of an m64 tile is a detector of our choosing: warp w's rows g and
// g + 8 (g = lane / 4) are the adjacent detectors 2P, 2P + 1 of G box w / 2,
// so one 8-byte load gives both, and P spreads a half-warp's 16 loads over
// all 8 swizzled 16-byte chunks of a row pair (no bank conflict).
__global__ void __launch_bounds__(kP1F32Threads, 1)
    ata_p1_tf32(const __grid_constant__ CUtensorMap mR,
                const __grid_constant__ CUtensorMap mG,
                float* __restrict__ P, int na, int K, int N, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_smem(smem_raw);  // [stage][R hi, R lo, 12 G boxes]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kP1F32Stages * kP1F32Stage);
  uint64_t* empty = full + kP1F32Stages;
  const int kb = blockIdx.x * chunk, a0 = blockIdx.y * 64;
  const int n0 = blockIdx.z * kP1F32Det;
  const int nk = (min(K, kb + chunk) - kb + 31) / 32;
  const int nbox = min(kP1F32Boxes, (N - n0 + 31) / 32);
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kP1F32Stages; ++s) {
      hopper::bar_init(&full[s], 1);
      hopper::bar_init(&empty[s], kP1F32WG);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (wg == kP1F32WG) {  // producer warp
    if (threadIdx.x == kP1F32Consumers) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kP1F32Stages;
        if (kt >= kP1F32Stages)
          hopper::bar_wait(&empty[s], ((kt / kP1F32Stages) - 1) & 1);
        uint8_t* st = ring + s * kP1F32Stage;
        const int k = kb + kt * 32;
        hopper::bar_expect_tx(&full[s], kF32Box + nbox * kGBox);
        hopper::tma_load_2d(st, &mR, &full[s], k, a0);
        for (int b = 0; b < nbox; ++b)
          hopper::tma_load_2d(st + 2 * kF32Box + b * kGBox, &mG, &full[s],
                              n0 + 32 * b, k);
      }
    }
    return;
  }
  const int t = threadIdx.x % 128, w = t / 32, g = (t % 32) / 4, q = t % 4;
  const int pair = 2 * (4 * ((g >> 1) & 1) + 2 * (w & 1) + (g >> 2)) + (g & 1);
  // this warpgroup's m64 tiles that hold detectors below N
  const int ntile = min(kP1F32MT, max(0, nbox - 2 * kP1F32MT * wg) / 2);
  float acc[kP1F32MT][32];
#pragma unroll
  for (int m = 0; m < kP1F32MT; ++m)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[m][e] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kP1F32Stages;
    uint8_t* rhi = ring + s * kP1F32Stage;
    uint8_t* rlo = rhi + kF32Box;
    hopper::bar_wait(&full[s], (kt / kP1F32Stages) & 1);
    split_box(rhi, rlo, kF32Box, threadIdx.x, kP1F32Consumers);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" ::"n"(kP1F32Consumers) : "memory");
#pragma unroll
    for (int m = 0; m < kP1F32MT; ++m) {
      if (m >= ntile) break;
      const uint8_t* gb = rhi + 2 * kF32Box +
                          (2 * kP1F32MT * wg + 2 * m + w / 2) * kGBox;
      float part[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) part[e] = 0.f;
      // one k8 step per wgmma group: its A registers are all that stays
      // live beside the sums (more steps per group spilled, and ran slower)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const float2 u = *reinterpret_cast<const float2*>(
            gb + sw128_f32(8 * ks + q, 2 * pair));
        const float2 v = *reinterpret_cast<const float2*>(
            gb + sw128_f32(8 * ks + q + 4, 2 * pair));
        const float f[4] = {u.x, u.y, v.x, v.y};
        const Split4 a(f);
        hopper::wgmma_fence();
        const uint64_t dh = hopper::desc_sw128(rhi + ks * 32, 16, 1024);
        const uint64_t dl = hopper::desc_sw128(rlo + ks * 32, 16, 1024);
        wgmma_m64n64k8_tf32(part, a.lo, dh);
        wgmma_m64n64k8_tf32(part, a.hi, dl);
        wgmma_m64n64k8_tf32(part, a.hi, dh);
        hopper::wgmma_commit();
        hopper::wgmma_wait0();
        hopper::fence_regs(part);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[m][e] += part[e];
    }
    if (t == 0) hopper::bar_arrive(&empty[s]);
  }
  // D row g is detector 2 pair, row g + 8 is 2 pair + 1; column 8 j + 2 q
  // (+ 1) is view a0 + 8 j + 2 q (+ 1)
  float* Ps = P + static_cast<size_t>(blockIdx.x) * na * N;
#pragma unroll
  for (int m = 0; m < kP1F32MT; ++m) {
    if (m >= ntile) break;
    const int d = n0 + 64 * (kP1F32MT * wg + m) + 32 * (w / 2) + 2 * pair;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int a = a0 + 8 * j + 2 * q;
      if (a < na)
        *reinterpret_cast<float2*>(Ps + static_cast<size_t>(a) * N + d) =
            make_float2(acc[m][4 * j], acc[m][4 * j + 2]);
      if (a + 1 < na)
        *reinterpret_cast<float2*>(Ps + static_cast<size_t>(a + 1) * N + d) =
            make_float2(acc[m][4 * j + 1], acc[m][4 * j + 3]);
    }
  }
}

// Second product, float32, on wgmma: out[a, k] = sum over d of U[a, d]
// G[k, d] for the 64-column tiles of chunk blockIdx.x, tile nt - 1 - z -
// kP2Split i in block z (from the chunk's end back to its start). The
// producer warp streams G boxes (64 k x 32 detectors, K-major, 128-byte
// swizzled) through a ring; the consumer warpgroup splits each box into
// its TF32 high part (in place) and low part (a second buffer), reads its
// A fragments of U from L2 and splits them in registers, and runs the
// three products of each k8 step. One box's sums (4 k8 steps) add to the
// running sum in float32. grid (nsplit, ceil(na / 64), kP2Split), 160
// threads, three blocks per SM (at most 128 registers): with nsplit at
// most the SM count the grid is one wave, and three warpgroups per SM
// overlap one another's split, wgmma and wait (two per SM ran 1.3x slower
// on an H100).
constexpr int kP2F32Stages = 4;
constexpr int kP2Split = 3;  // blocks per chunk

__global__ void __launch_bounds__(160, 3)
    ata_p2_tf32(const __grid_constant__ CUtensorMap mG,
                const float* __restrict__ U, float* __restrict__ out, int na,
                int K, int N, int chunk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = align_smem(smem_raw);  // [stage][hi box, lo box]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kP2F32Stages * 2 * kF32Box);
  uint64_t* empty = full + kP2F32Stages;
  const int kb = blockIdx.x * chunk, ke = min(K, kb + chunk);
  const int a0 = blockIdx.y * 64, z = blockIdx.z;
  const int nt = (ke - kb + kKTile - 1) / kKTile, nd = N / 32;
  const int mine = nt > z ? (nt - 1 - z) / kP2Split + 1 : 0;
  auto k0_of = [&](int i) {
    return kb + (nt - 1 - z - kP2Split * i) * kKTile;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kP2F32Stages; ++s) {
      hopper::bar_init(&full[s], 1);
      hopper::bar_init(&empty[s], 1);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128) {  // producer warp
    if (threadIdx.x == 128) {
      int it = 0;
      for (int i = 0; i < mine; ++i) {
        for (int j = 0; j < nd; ++j, ++it) {
          const int s = it % kP2F32Stages;
          if (it >= kP2F32Stages)
            hopper::bar_wait(&empty[s], ((it / kP2F32Stages) - 1) & 1);
          hopper::bar_expect_tx(&full[s], kF32Box);
          hopper::tma_load_2d(ring + s * 2 * kF32Box, &mG, &full[s], 32 * j,
                              k0_of(i));
        }
      }
    }
    return;
  }
  const int t = threadIdx.x, g = (t % 32) / 4, q = t % 4;
  const int r = a0 + 16 * (t / 32) + g;  // and r + 8
  const float* u0 = U + static_cast<size_t>(min(r, na - 1)) * N;
  const float* u8 = U + static_cast<size_t>(min(r + 8, na - 1)) * N;
  const bool ok0 = r < na, ok8 = r + 8 < na;
  // this thread's A values of U for the 32 detectors of box j (fetched a
  // box ahead, so their L2 latency overlaps the previous box's work)
  auto fetch = [&](int j, float (&v)[16]) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int d = 32 * j + 8 * ks + q;
      v[4 * ks] = ok0 ? __ldg(u0 + d) : 0.f;
      v[4 * ks + 1] = ok8 ? __ldg(u8 + d) : 0.f;
      v[4 * ks + 2] = ok0 ? __ldg(u0 + d + 4) : 0.f;
      v[4 * ks + 3] = ok8 ? __ldg(u8 + d + 4) : 0.f;
    }
  };
  float next[16];
  fetch(0, next);
  int it = 0;
  for (int i = 0; i < mine; ++i) {
    float acc[32], part[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    for (int j = 0; j < nd; ++j, ++it) {
      const int s = it % kP2F32Stages;
      uint8_t* hi = ring + s * 2 * kF32Box;
      uint8_t* lo = hi + kF32Box;
      Split4 a[4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) a[ks] = Split4(next + 4 * ks);
      fetch(j + 1 < nd ? j + 1 : 0, next);
      hopper::bar_wait(&full[s], (it / kP2F32Stages) & 1);
      split_box(hi, lo, kF32Box, t, 128);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync 1, 128;\n" ::: "memory");
#pragma unroll
      for (int e = 0; e < 32; ++e) part[e] = 0.f;
      hopper::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t dh = hopper::desc_sw128(hi + ks * 32, 16, 1024);
        const uint64_t dl = hopper::desc_sw128(lo + ks * 32, 16, 1024);
        wgmma_m64n64k8_tf32(part, a[ks].lo, dh);
        wgmma_m64n64k8_tf32(part, a[ks].hi, dl);
        wgmma_m64n64k8_tf32(part, a[ks].hi, dh);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait0();
      hopper::fence_regs(part);
      if (t == 0) hopper::bar_arrive(&empty[s]);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] += part[e];
    }
    const int k0 = k0_of(i);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int k = k0 + 8 * jn + 2 * q;
      if (k >= ke) continue;
      if (ok0)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r) * K + k) =
            make_float2(acc[4 * jn], acc[4 * jn + 1]);
      if (ok8)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(r + 8) * K + k) =
            make_float2(acc[4 * jn + 2], acc[4 * jn + 3]);
    }
  }
}

// U[a, d] = sum over s of P[s, a, d] in order s = 0, 1, ..., rounded to T.
template <typename T>
__global__ void ata_reduce_kernel(const float* __restrict__ P,
                                  T* __restrict__ U, int n, int nsplit) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float v = 0.f;
  for (int s = 0; s < nsplit; ++s) v += P[static_cast<size_t>(s) * n + e];
  st(U, e, v);
}

int set_smem(const void* fn, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

int launch_ata_bf16(const void* R, const void* G, float* P, void* U,
                    float* out, int na, int K, int N, int nsplit, int chunk,
                    cudaStream_t stream) {
  CUtensorMap mR, mG, mU;
  const uint32_t box[2] = {64, 64};
  const uint64_t dR[2] = {static_cast<uint64_t>(K),
                          static_cast<uint64_t>(na)};
  const uint64_t dG[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const uint64_t dU[2] = {static_cast<uint64_t>(N),
                          static_cast<uint64_t>(na)};
  const auto bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int err = hopper::tensor_map(&mR, R, bf, 2, 2, dR, box, sw);
  if (!err) err = hopper::tensor_map(&mG, G, bf, 2, 2, dG, box, sw);
  if (!err) err = hopper::tensor_map(&mU, U, bf, 2, 2, dU, box, sw);
  if (err) return err;
  const int mt = (na + 63) / 64;
  const int s1 = kAlign + kP1Stages * kP1Stage + 2 * kP1Stages * 8;
  const int s2 = kAlign + (N / 64 + kP2Stages) * kBox + (2 * kP2Stages + 1) * 8;
  if ((err = set_smem(reinterpret_cast<const void*>(ata_p1_wgmma), s1)))
    return err;
  if ((err = set_smem(reinterpret_cast<const void*>(ata_p2_wgmma), s2)))
    return err;
  ata_p1_wgmma<<<dim3(nsplit, mt, (N + 383) / 384), 288, s1, stream>>>(
      mR, mG, P, na, K, N, chunk);
  const int n = na * N;
  ata_reduce_kernel<__nv_bfloat16><<<(n + 255) / 256, 256, 0, stream>>>(
      P, static_cast<__nv_bfloat16*>(U), n, nsplit);
  ata_p2_wgmma<<<dim3(nsplit, mt), 160, s2, stream>>>(mU, mG, out, na, K, N,
                                                       chunk);
  return 0;
}

int launch_ata_f32(const float* R, const float* G, float* P, float* U,
                   float* out, int na, int K, int N, int nsplit, int chunk,
                   cudaStream_t stream) {
  CUtensorMap mR, mG1, mG;
  const uint32_t box[2] = {32, 64}, gbox[2] = {32, 32};
  const uint64_t dR[2] = {static_cast<uint64_t>(K),
                          static_cast<uint64_t>(na)};
  const uint64_t dG[2] = {static_cast<uint64_t>(N), static_cast<uint64_t>(K)};
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  int err = hopper::tensor_map(&mR, R, f32, 4, 2, dR, box, sw);
  if (!err) err = hopper::tensor_map(&mG1, G, f32, 4, 2, dG, gbox, sw);
  if (!err) err = hopper::tensor_map(&mG, G, f32, 4, 2, dG, box, sw);
  if (err) return err;
  const int mt = (na + 63) / 64;
  const int s1 = kAlign + kP1F32Stages * kP1F32Stage + 2 * kP1F32Stages * 8;
  const int s2 = kAlign + kP2F32Stages * 2 * kF32Box + 2 * kP2F32Stages * 8;
  if ((err = set_smem(reinterpret_cast<const void*>(ata_p1_tf32), s1)))
    return err;
  if ((err = set_smem(reinterpret_cast<const void*>(ata_p2_tf32), s2)))
    return err;
  ata_p1_tf32<<<dim3(nsplit, mt, (N + kP1F32Det - 1) / kP1F32Det),
                kP1F32Threads, s1, stream>>>(mR, mG1, P, na, K, N, chunk);
  const int n = na * N;
  ata_reduce_kernel<float><<<(n + 255) / 256, 256, 0, stream>>>(P, U, n,
                                                                nsplit);
  ata_p2_tf32<<<dim3(nsplit, mt, kP2Split), 160, s2, stream>>>(
      mG, U, out, na, K, N, chunk);
  return 0;
}

// Checks a rotate plan's sizes (cudaErrorInvalidValue for one the kernels
// cannot run) and lets `fn` take its shared memory: -> error, threads and
// bytes per block, tiles per canvas.
int rotate_setup(const void* fn, const Dims& d, int* threads, int* bytes,
                 int* tiles) {
  if (d.C < 1 || d.ty < kRows || d.ty % kRows || d.tx < kVec ||
      d.tx % kVec || d.w2 < d.tx + 1 || d.r1 < d.ty + 1 ||
      static_cast<long long>(d.C) * d.C >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long th = static_cast<long long>(d.ty) * d.tx / (kVec * kRows);
  const long long words = rotate_smem_words(d.ty, d.w2, d.r1);
  if (th < 32 || th > kRotMaxThreads || 4 * words > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  *threads = static_cast<int>(th);
  *bytes = static_cast<int>(4 * words);
  *tiles = ((d.C + d.ty - 1) / d.ty) * ((d.C + d.tx - 1) / d.tx);
  return *bytes > 48 * 1024 ? set_smem(fn, *bytes) : 0;
}

template <typename OT>
int launch_rotate(const float* Q, const int* kx, const float* fx,
                  const int* ky, const float* fy, const int* kq,
                  const int2* starts, OT* out, int na, const Dims& d,
                  cudaStream_t s) {
  const void* fn = reinterpret_cast<const void*>(rotate_tile_kernel<OT>);
  int threads, bytes, tiles;
  if (const int err = rotate_setup(fn, d, &threads, &bytes, &tiles))
    return err;
  rotate_tile_kernel<OT><<<dim3(tiles, na), threads, bytes, s>>>(
      Q, kx, fx, ky, fy, kq, starts, out, d, (d.C + d.tx - 1) / d.tx);
  return 0;
}

template <typename IT>
int launch_rotate_adj(const IT* Gc, const int* kx, const float* fx,
                      const int* ky, const float* fy, const int* order,
                      const int* chunks, const int2* starts,
                      const int* qfirst, float* partials, float* out,
                      int nchunks, const Dims& d, cudaStream_t s) {
  const void* fn = reinterpret_cast<const void*>(rotate_adj_tile_kernel<IT>);
  int threads, bytes, tiles;
  if (const int err = rotate_setup(fn, d, &threads, &bytes, &tiles))
    return err;
  if (nchunks < 0 || partials == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nchunks)  // none: every quarter has no view, the second pass zeroes
    rotate_adj_tile_kernel<IT><<<dim3(tiles, nchunks), threads, bytes, s>>>(
        Gc, kx, fx, ky, fy, order, chunks, starts, partials, d,
        (d.C + d.tx - 1) / d.tx);
  const int CC = d.C * d.C;
  rotate_adj_reduce<<<dim3((CC + 255) / 256, 3), 256, 0, s>>>(
      partials, qfirst, out, CC);
  return 0;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`,
// allocates nothing and returns cudaGetLastError() after its launches.
// kind: 0 float32, 1 bfloat16 (K4: the output; K5: the input; K6: R and G).
extern "C" {

// K4 with rotate_plan's shifts kx, ky (int32 (na, C), reduced mod C), starts
// (na, tiles, 2) and sizes.
int trips_shear_rotate(int kind, const void* Q, const void* kx,
                       const void* fx, const void* ky, const void* fy,
                       const void* kq, const void* starts, void* out, int na,
                       int C, int ty, int tx, int w2, int r1, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const Dims d{C, ty, tx, w2, r1};
  const auto* q = static_cast<const float*>(Q);
  const auto* ikx = static_cast<const int*>(kx);
  const auto* ffx = static_cast<const float*>(fx);
  const auto* iky = static_cast<const int*>(ky);
  const auto* ffy = static_cast<const float*>(fy);
  const auto* ikq = static_cast<const int*>(kq);
  const auto* st = static_cast<const int2*>(starts);
  int err;
  switch (kind) {
    case kF32:
      err = launch_rotate(q, ikx, ffx, iky, ffy, ikq, st,
                          static_cast<float*>(out), na, d, s);
      break;
    case kBF16:
      err = launch_rotate(q, ikx, ffx, iky, ffy, ikq, st,
                          static_cast<__nv_bfloat16*>(out), na, d, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

// K5 with rotate_plan's shifts kx, ky (-k - 1 reduced mod C), view order
// (na,), chunks (nchunks, 3) of (first, count, slot), starts (na, tiles, 2)
// and qfirst (4,); partials (nchunks, C, C) float32 scratch.
int trips_shear_rotate_adj(int kind, const void* Gc, const void* kx,
                           const void* fx, const void* ky, const void* fy,
                           const void* order, const void* chunks,
                           const void* starts, const void* qfirst,
                           void* partials, void* out, int C, int nchunks,
                           int ty, int tx, int w2, int r1, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const Dims d{C, ty, tx, w2, r1};
  const auto* ikx = static_cast<const int*>(kx);
  const auto* ffx = static_cast<const float*>(fx);
  const auto* iky = static_cast<const int*>(ky);
  const auto* ffy = static_cast<const float*>(fy);
  const auto* ord = static_cast<const int*>(order);
  const auto* ch = static_cast<const int*>(chunks);
  const auto* st = static_cast<const int2*>(starts);
  const auto* qf = static_cast<const int*>(qfirst);
  auto* P = static_cast<float*>(partials);
  auto* o = static_cast<float*>(out);
  int err;
  switch (kind) {
    case kF32:
      err = launch_rotate_adj(static_cast<const float*>(Gc), ikx, ffx, iky,
                              ffy, ord, ch, st, qf, P, o, nchunks, d, s);
      break;
    case kBF16:
      err = launch_rotate_adj(static_cast<const __nv_bfloat16*>(Gc), ikx, ffx,
                              iky, ffy, ord, ch, st, qf, P, o, nchunks, d, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

// Rows of G per K6 tile: a chunk of the split is a multiple of this.
int trips_shear_ata_k_tile() { return kKTile; }

// R (na, K), G (K, N); scratch P (nsplit, na, N) float32 and U (na, N) in
// the type of G; out (na, K) float32. K is split into nsplit chunks of
// `chunk` rows (a multiple of trips_shear_ata_k_tile()), the last one
// ending at K. K must be a multiple of 8 and N of 64 (for bfloat16 at
// most 1024).
int trips_shear_ata(int kind, const void* R, const void* G, void* P, void* U,
                    void* out, int na, int K, int N, int nsplit, int chunk,
                    void* stream) {
  if (na < 1 || K < 1 || K % 8 || N < 64 || N % 64 || chunk < kKTile ||
      chunk % kKTile || nsplit < 1 ||
      static_cast<long long>(nsplit - 1) * chunk >= K ||
      static_cast<long long>(nsplit) * chunk < K)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<float*>(P);
  auto* o = static_cast<float*>(out);
  int err;
  switch (kind) {
    case kF32:
      err = launch_ata_f32(static_cast<const float*>(R),
                           static_cast<const float*>(G), p,
                           static_cast<float*>(U), o, na, K, N, nsplit, chunk,
                           s);
      break;
    case kBF16:
      err = launch_ata_bf16(R, G, p, U, o, na, K, N, nsplit, chunk, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

}  // extern "C"
