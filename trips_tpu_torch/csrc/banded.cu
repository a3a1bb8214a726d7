// Banded projector kernels for Hopper (sm_90a): forward (K2), adjoint (K3)
// and fused normal apply A^T A (K1) over the buckets of the shear-packed
// band format (trips_tpu_torch/sparse/banded_kernels.py holds the wrappers,
// their launch plans and the plain PyTorch versions they are tested
// against).
//
// Format, per angle a of a bucket (W: (na, T, n, p_pad), S: (na, n),
// Pm: (na, G, p_pad), all C-contiguous; gsize = n / G):
//
//   column(a, t, i, d) = (S[a, i] + Pm[a, i / gsize, d] + t) mod n
//   y[a, d]            = sum_{t, i} W[a, t, i, d] * X[i, column(a, t, i, d)]
//
// The TPU kernels these replace (trips_tpu/sparse/pallas_banded_kernel.py:
// _fwd_call, _adj_call, _ata_call) realise the column selection with
// per-row lane rolls and one-hot matmuls on the MXU. On this card the
// selection is one computed index per (t, i, d) and a gather from X, which
// lives in L2 (n * n * 4 bytes: 256 KB at n = 256). Weights are the f32
// product of the stored value and, for int8 storage, the angle's scale:
// the same arithmetic as the dequantize-then-apply oracle
// (trips_tpu/sparse/banded.py: dequant_slab, apply_group_xla, wrap=True).
//
// Bound: the weight stream. Every stored weight K2 and K3 read is read once
// per apply against 2 flops, so they are memory-bound (the f32 pack of
// tomo256x60, 226 MB, takes 67.5 us at 3.35 TB/s). K1 (4 flops a weight)
// reads only the spans that hold its nonzero weights (49 MB of that pack,
// 116 MB of the dynamic pack's 1125): their rows lie a tap's plane apart
// and copy at 1.0-1.5 TB/s on an H100, about half of K1's time; its
// gathers and int64 atomics (one per nonzero weight) take most of the
// rest (PERF.md, section 6). Threads
// that each walk their weights from device memory with one load in flight
// are bound by latency instead: one block per (angle, 32 detectors) kept
// ~0.4 MB in flight, a fifth of what 3.35 TB/s needs at ~0.6 us latency,
// in one launch per bucket of about one wave. So the three kernels share
// one design:
//
// - All buckets of an apply go in one launch (at most kMaxBuckets): the
//   blocks of later waves load while earlier ones compute.
// - A (bucket, angle a, DET detectors) tile's n lines are split over
//   `parts` consecutive blocks, part r taking lines [r * lines,
//   (r + 1) * lines). 256 threads: lane = detector, 256 / DET slices over
//   the lines.
// - K2 and K3: each block moves its weight slab W[a, :, lines, d0 .. d0 +
//   DET - 1] (T x L x DET values, L = the bucket's chunk_lines; 18 to 36
//   KB by the plan, so six to eight blocks share an SM) into shared memory
//   with TMA, in one load when its lines fit, else chunk by chunk, and reads
//   it there. Zero weights gather and add nothing, but are loaded.
// - K1 loads and walks only each line's tap span: the taps from the first
//   to the last that hold a nonzero weight in any of the tile's DET
//   detectors (spans[b][g, d0 / DET, i] = first tap | taps << 16, made once
//   per pack from its stored bytes by the wrapper, sparse/banded_kernels.py
//   pack_spans). The pack's rows outside the spans (90% of the dynamic
//   pack's bytes, 78% of tomo256x60's f32 pack) are never read. A block
//   scans its lines' span lengths into offsets and copies the spans' (tap,
//   line) rows, DET values each, with 16-byte cp.async, packed one after
//   another into shared memory (span_rows rows; lines whose spans do not
//   fit are taken in chunks of whole lines; a block of more than 256 lines,
//   n > 4096 at 16 parts, takes them in passes of 256, each scanned and
//   chunked alone), each row with its line and its column before the
//   predictor (rinfo). A line with an empty span (a padded angle's, or one
//   its rays miss) costs nothing but its entry.
//   Its threads then walk rows, not lines (row r by line slice r mod 256 /
//   DET): a span holds two or three rows on average, so a thread's gathers
//   of consecutive rows are in flight together and the slices share the
//   rows evenly.
//
// K2 (fwd_kernel) sums its partial y over the block's lines; the parts of
//   a tile form a thread block cluster and rank 0 sums their partials
//   through distributed shared memory in rank order (deterministic) and
//   writes them to row aidx[a] of the (rows, p) sinogram, d < p.
// K3 (adj_kernel) reads y[d] from row aidx[a] of the sinogram (0 for
//   d >= p) and back-projects it from the slab into the image. Its parts
//   are independent blocks, not a cluster.
// K1 (ata_kernel) runs K2's stage on its spans, sums y across the cluster
//   so that every rank holds it, then K3's stage from the same shared
//   memory. When the rank's spans took several chunks (or passes), stage 2
//   walks them backward and reloads all but the last, from L2 if it still
//   holds them. Each thread adds its rows in row order, so stage 1's float32
//   sums, and the output, are the same bits from run to run.
//
// Back-projection in fixed point (K1, K3). Every term v = w y[d] lands in
// the image with a global atomic, so the order of the adds is the
// scheduler's. The adds are integer: each term is scaled by 2^e, rounded
// to int64 and added with red.global.add.u64 into an int64 image zeroed
// once per apply; integer addition is associative, so the image is the
// same bits whatever the order, and one last pass (fixed_to_float) writes
// float(acc 2^-e). The terms are exact products of the float32 weight
// and y[d] in double (24 + 24 bits), so no product overflows; rounding to
// the 2^-e grid is the only rounding before the output's own.
//   e, per frame: the wrapper passes the frame's bound B on |out| per unit
// of input (sparse/banded_kernels.py pack_bound: K3 the largest column
// abs-sum of the frame's matrix, K1 that times the largest row abs-sum,
// since stage 1's |y[d]| is at most the row's abs-sum times max|X|) and
// max|input| as a device reduction. With m = B max|input| < 2^k,
// e = 61 - k: every partial sum stays below 2^62 (the float32 y of K1
// exceeds its exact bound by far less than the factor 2 kept), the int64
// cannot overflow while every term is finite, and entry j's error is at
// most N_j 2^(k-62) for its N_j terms, against a float32 half-unit of at
// least 2^(k-41) for every entry above 2^-16 of m: N_j 2^-21 of it (N_j is
// a few hundred). m = 0 gives a zero image; a non-finite m (a NaN or an
// inf in the input) gives an image of NaN, never a silent zero. So does a
// finite X whose stage-1 y overflows float32 in K1 (possible once the row
// bound times max|X| passes FLT_MAX, while m, in double, stays finite):
// the block that meets it sets the frame's flag, one int64 per frame
// after the nf images in acc, and fixed_to_float writes NaN there.
// A bucket with cols = 1 drives the transposed image XT and adds its
// image transposed (K1, K3 through strides).
//
// Frames. One launch applies the buckets to nf frames: the images X, XT
// and the K1/K3 output are (nf, n, n), the sinogram (nf, rows, p). A
// bucket's pack either holds one stack per frame, (nf * na) angles with
// frame f's at f * na .. (the dynamic operators' frame-varying geometry),
// or one stack that every frame shares (frame angle stride fa = 0: a
// shared-geometry block diagonal, or the columns of a matmat). This is
// the JAX package's jax.vmap of _fwd_call, _adj_call and _ata_call over
// frames (trips_tpu/sparse/dynamic_banded.py:158-192): here the frame is
// one more index of the grid, innermost, so the blocks that read one
// shared slab run together and find it in L2. Angle ids are rows of the
// frame's own sinogram; an id outside [0, rows) (the dynamic pack's padded
// angles carry id `rows`) writes and reads nothing.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <cstdint>
#include <algorithm>
#include <cstring>
#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBuckets = 16;  // most buckets per launch
constexpr int kThreads = 256;    // DET lanes x kThreads / DET line slices
constexpr int kMaxCluster = 16;  // beyond the portable 8 (Hopper has it)
constexpr int kSmemMax = 227 * 1024;  // dynamic shared memory per block
constexpr int kMaxLines = kThreads;   // K1: most lines of a block's pass

enum WeightKind { kF32 = 0, kBF16 = 1, kInt8 = 2 };
enum Op { kFwd = 0, kAdj = 1, kAta = 2 };

// Stored weight in shared memory -> f32; int8 is scaled by the angle's
// scale.
__device__ __forceinline__ float slab_weight(const float* W, size_t k, float) {
  return W[k];
}
__device__ __forceinline__ float slab_weight(const __nv_bfloat16* W, size_t k,
                                             float) {
  return __bfloat162float(W[k]);
}
__device__ __forceinline__ float slab_weight(const int8_t* W, size_t k,
                                             float sc) {
  return static_cast<float>(W[k]) * sc;
}

// (s + pm) mod n in [0, n) for any int32 s, pm: S is stored raw and n need
// not be a power of two (nx = 300 pads to n = 384), so no bit mask.
__device__ __forceinline__ int wrap_col(int s, int pm, int n) {
  int c = (s % n + pm % n) % n;
  return c < 0 ? c + n : c;
}

struct Buckets {
  CUtensorMap map[kMaxBuckets];   // K2, K3: W (p_pad, n, na T), boxes
                                  // {DET, L, Tb}
  const void* W[kMaxBuckets];     // K1: W itself
  const int* spans[kMaxBuckets];  // K1: (angles, p_pad / DET, n) tap spans
  const int* S[kMaxBuckets];
  const int* Pm[kMaxBuckets];
  const float* scales[kMaxBuckets];
  const int* aidx[kMaxBuckets];  // K2, K3: sinogram row of each angle
  int T[kMaxBuckets], L[kMaxBuckets], Tb[kMaxBuckets];
  int fa[kMaxBuckets];          // frame f's angle a is pack angle f fa + a
  int cols[kMaxBuckets];        // 1: drives XT, adds its image transposed
  int start[kMaxBuckets + 1];   // first block of each bucket
  int nb;
};

struct Args {
  const float* in;   // X (n, n); K3: the (rows, p) sinogram
  const float* inT;  // X transposed, for the cols buckets (K1, K2)
  float* out;        // K2: the (rows, p) sinogram; K1, K3: (n, n)
  int p, rows, n, p_pad, G, parts, lines;
  int span_rows;     // K1: (tap, line) rows of DET weights a block holds
  int nf;            // frames: in, inT and out hold nf of the above
  // K1, K3: the int64 image (nf, n, n) and one flag per frame after it,
  // zeroed; max|in| of each frame (nf,); the bound of frame f at
  // bound[f * bstride]
  unsigned long long* acc;
  const float* amax;
  const double* bound;
  int bstride;
};

// The fixed-point scale of frame f (see the header): 1 with e set when its
// terms add, 0 when m = 0 (a zero image), -1 when m is not finite.
__device__ __forceinline__ int fixed_scale(const Args& A, int f, int* e) {
  const double m =
      A.bound[static_cast<size_t>(f) * A.bstride] * static_cast<double>(A.amax[f]);
  *e = 0;
  if (!(m <= DBL_MAX)) return -1;  // NaN or inf
  if (m == 0.0) return 0;
  int k;
  frexp(m, &k);  // m < 2^k
  *e = 61 - k;
  return 1;
}

// One block's share of a (bucket, frame, angle, DET detectors) tile; g is
// the angle's index in the bucket's pack.
struct Tile {
  int b, f, g, d0, part, i0, i1, nchunks, T, L, Tb;
  float sc;
  const int* Sa;
  const int* Pma;
};

template <int DET>
__device__ __forceinline__ Tile tile_of(const Buckets& B, const Args& A) {
  Tile t;
  int b = 0;
  while (b + 1 < B.nb && static_cast<int>(blockIdx.x) >= B.start[b + 1]) ++b;
  const int k = static_cast<int>(blockIdx.x) - B.start[b];
  const int tile = k / A.parts, dchunks = (A.p_pad + DET - 1) / DET;
  const int ad = tile / A.nf;  // (angle, detector chunk); frame innermost
  t.b = b;
  t.part = k % A.parts;  // the cluster rank where the parts are a cluster
  t.f = tile % A.nf;
  t.g = t.f * B.fa[b] + ad / dchunks;
  t.d0 = (ad % dchunks) * DET;
  t.T = B.T[b];
  t.L = B.L[b];
  t.Tb = B.Tb[b];
  t.i0 = t.part * A.lines;
  t.i1 = min(A.n, t.i0 + A.lines);
  t.nchunks = t.i1 > t.i0 ? (t.i1 - t.i0 + t.L - 1) / t.L : 0;
  t.sc = B.scales[b] ? B.scales[b][t.g] : 1.f;
  t.Sa = B.S[b] + static_cast<size_t>(t.g) * A.n;
  t.Pma = B.Pm[b] + static_cast<size_t>(t.g) * A.G * A.p_pad;
  return t;
}

__device__ __forceinline__ void init_bar(uint64_t* bar) {
  if (threadIdx.x == 0) {
    hopper::bar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
}

// TMA: chunk c of the block's slab (all taps of lines i0 + c L ..) into
// shared memory; every thread waits for it.
template <typename WT, int DET>
__device__ __forceinline__ void load_chunk(uint8_t* smem, const Buckets& B,
                                           const Tile& t, uint64_t* bar,
                                           uint32_t& phase, int c) {
  const size_t tstride = static_cast<size_t>(t.L) * DET;
  if (threadIdx.x == 0) {
    hopper::bar_expect_tx(bar, t.T * tstride * sizeof(WT));
    for (int t0 = 0; t0 < t.T; t0 += t.Tb) {
      hopper::tma_load_3d(smem + t0 * tstride * sizeof(WT), &B.map[t.b], bar,
                          t.d0, t.i0 + c * t.L, t.g * t.T + t0);
    }
  }
  hopper::bar_wait(bar, phase);
  phase ^= 1;
}

// Stage 1 on chunk c: this thread's lines (il = slice, slice + 256 / DET,
// ...) and all taps, added to acc.
template <typename WT, int DET>
__device__ __forceinline__ float fwd_chunk(const WT* slab, const float* Xb,
                                           const Tile& t, const Args& A,
                                           int c, int lane, int slice, int d,
                                           float acc) {
  constexpr int kSl = kThreads / DET;
  const size_t tstride = static_cast<size_t>(t.L) * DET;
  const int n = A.n, gsize = n / A.G;
  const int ib = t.i0 + c * t.L, nl = min(t.L, t.i1 - ib);
  for (int il = slice; il < nl; il += kSl) {
    const int i = ib + il;
    const float* xi = Xb + static_cast<size_t>(i) * n;
    int col = wrap_col(t.Sa[i], t.Pma[(i / gsize) * A.p_pad + d], n);
    const WT* w = slab + il * DET + lane;
#pragma unroll 4
    for (int tt = 0; tt < t.T; ++tt) {
      const float wv = slab_weight(w, tt * tstride, t.sc);
      if (wv != 0.f) acc += wv * xi[col];
      if (++col == n) col = 0;
    }
  }
  return acc;
}

// Stage 2 on chunk c: back-project ys = y[d] 2^e from this thread's lines
// into the int64 image with integer atomics; image element (line i, column
// col) at acc[i * ri + col * ci].
template <typename WT, int DET>
__device__ __forceinline__ void adj_chunk(const WT* slab,
                                          unsigned long long* acc, size_t ri,
                                          size_t ci, const Tile& t,
                                          const Args& A, int c, int lane,
                                          int slice, int d, double ys) {
  constexpr int kSl = kThreads / DET;
  const size_t tstride = static_cast<size_t>(t.L) * DET;
  const int n = A.n, gsize = n / A.G;
  const int ib = t.i0 + c * t.L, nl = min(t.L, t.i1 - ib);
  for (int il = slice; il < nl; il += kSl) {
    const int i = ib + il;
    unsigned long long* oi = acc + i * ri;
    int col = wrap_col(t.Sa[i], t.Pma[(i / gsize) * A.p_pad + d], n);
    const WT* w = slab + il * DET + lane;
#pragma unroll 4
    for (int tt = 0; tt < t.T; ++tt) {
      const float wv = slab_weight(w, tt * tstride, t.sc);
      if (wv != 0.f) {
        const long long q = __double2ll_rn(static_cast<double>(wv) * ys);
        if (q) atomicAdd(oi + col * ci, static_cast<unsigned long long>(q));
      }
      if (++col == n) col = 0;
    }
  }
}

// out = float(acc 2^-e) per frame; NaN where the frame's scale is not
// finite or its flag is set (see the header).
__global__ void __launch_bounds__(kThreads)
    fixed_to_float(const Args A) {
  const size_t img = static_cast<size_t>(A.n) * A.n;
  const size_t total = img * A.nf;
  const long long* acc = reinterpret_cast<const long long*>(A.acc);
  for (size_t k = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       k < total; k += static_cast<size_t>(gridDim.x) * kThreads) {
    int e = 0;
    const int f = static_cast<int>(k / img);
    const int s = acc[total + f] ? -1 : fixed_scale(A, f, &e);
    A.out[k] = s > 0 ? static_cast<float>(static_cast<double>(acc[k]) *
                                          scalbn(1.0, -e))
               : s == 0 ? 0.f
                        : __int_as_float(0x7fc00000);
  }
}

// The block's y partials, summed over its line slices in slice order;
// valid in the threads of slice 0.
template <int DET>
__device__ __forceinline__ float sum_slices(float acc,
                                            float (*part)[DET], int lane,
                                            int slice) {
  constexpr int kSl = kThreads / DET;
  part[slice][lane] = acc;
  __syncthreads();
  float v = 0.f;
  if (slice == 0) {
    for (int k = 0; k < kSl; ++k) v += part[k][lane];
  }
  return v;
}

template <typename WT, int DET>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const __grid_constant__ Buckets B, const Args A) {
  constexpr int kSl = kThreads / DET;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WT* slab = reinterpret_cast<const WT*>(smem_raw);
  __shared__ float part[kSl][DET];
  __shared__ float ypart[DET];
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const Tile t = tile_of<DET>(B, A);
  const int lane = threadIdx.x % DET, slice = threadIdx.x / DET;
  const int d = min(t.d0 + lane, A.p_pad - 1);
  const size_t img = static_cast<size_t>(A.n) * A.n;
  const float* Xb = (B.cols[t.b] ? A.inT : A.in) + t.f * img;
  init_bar(&bar);
  uint32_t phase = 0;
  float acc = 0.f;
  for (int c = 0; c < t.nchunks; ++c) {
    if (c > 0) __syncthreads();  // every thread is done with chunk c - 1
    load_chunk<WT, DET>(smem_raw, B, t, &bar, phase, c);
    acc = fwd_chunk<WT, DET>(slab, Xb, t, A, c, lane, slice, d, acc);
  }
  const float v = sum_slices<DET>(acc, part, lane, slice);
  if (slice == 0) ypart[lane] = v;
  cluster.sync();
  if (t.part == 0 && slice == 0) {
    float y = 0.f;
    for (int r = 0; r < A.parts; ++r)
      y += cluster.map_shared_rank(ypart, r)[lane];
    const int row = B.aidx[t.b][t.g], dd = t.d0 + lane;
    if (dd < A.p && row >= 0 && row < A.rows)
      A.out[(static_cast<size_t>(t.f) * A.rows + row) * A.p + dd] = y;
  }
  cluster.sync();  // no block leaves while rank 0 reads its ypart
}

template <typename WT, int DET>
__global__ void __launch_bounds__(kThreads)
    adj_kernel(const __grid_constant__ Buckets B, const Args A) {
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WT* slab = reinterpret_cast<const WT*>(smem_raw);
  __shared__ uint64_t bar;
  const Tile t = tile_of<DET>(B, A);
  const int lane = threadIdx.x % DET, slice = threadIdx.x / DET;
  const int dd = t.d0 + lane, d = min(dd, A.p_pad - 1);
  const int row = B.aidx[t.b][t.g];
  const float yd =
      dd < A.p && row >= 0 && row < A.rows
          ? A.in[(static_cast<size_t>(t.f) * A.rows + row) * A.p + dd]
          : 0.f;
  const size_t ri = B.cols[t.b] ? 1 : A.n, ci = B.cols[t.b] ? A.n : 1;
  unsigned long long* acc = A.acc + t.f * static_cast<size_t>(A.n) * A.n;
  int e;
  if (fixed_scale(A, t.f, &e) <= 0) return;  // the whole block: no terms
  const double ys = static_cast<double>(yd) * scalbn(1.0, e);
  init_bar(&bar);
  uint32_t phase = 0;
  for (int c = 0; c < t.nchunks; ++c) {
    if (c > 0) __syncthreads();
    load_chunk<WT, DET>(smem_raw, B, t, &bar, phase, c);
    if (yd != 0.f)
      adj_chunk<WT, DET>(slab, acc, ri, ci, t, A, c, lane, slice, d, ys);
  }
}

// K1's table of the lines of a block's pass (il = i - i0, i0 the pass's
// first line): the first tap of each line's span, where its rows start
// among the pass's packed rows, its shear S mod n, and the chunks of whole
// lines that fit span_rows rows.
struct SpanLines {
  int off[kMaxLines + 1];           // rows of the lines before il
  int s[kMaxLines];                 // S[i] mod n
  unsigned short lo[kMaxLines];     // first tap of line il's span
  short first[kMaxLines + 1];       // chunk c: lines [first[c], first[c + 1])
  int b0, b1;                       // the block's lines [b0, b1)
  int warp_sum[kThreads / 32];
  int nchunks;
};

// The line groups (of n / G lines, one predictor row each) that the lines
// of a block's pass can meet: K1 keeps their predictors, mod n, in shared
// memory.
__device__ __host__ __forceinline__ int pm_groups(const Args& A) {
  const int lines = A.lines < kMaxLines ? A.lines : kMaxLines;
  const int most = (lines - 1) / (A.n / A.G) + 2;
  return most < A.G ? most : A.G;
}

// Read the spans and shears of the pass t's lines and fill sl. Chunk c
// takes the lines whose last row falls in [c step, (c + 1) step), step =
// span_rows - T + 1: a chunk then holds at most span_rows rows, and, as no
// span is longer than T <= step, every chunk holds a line. All the lines
// in one chunk when their rows fit.
template <int DET>
__device__ __forceinline__ void span_lines(SpanLines& sl, const Buckets& B,
                                           const Args& A, const Tile& t) {
  const int nl = max(0, t.i1 - t.i0), il = threadIdx.x;
  const int wl = threadIdx.x % 32, w = threadIdx.x / 32;
  constexpr int kWarps = kThreads / 32;
  const int n = A.n;
  int cnt = 0;
  if (il < nl) {
    const int dchunks = (A.p_pad + DET - 1) / DET;
    const int sp = B.spans[t.b][(static_cast<size_t>(t.g) * dchunks +
                                 t.d0 / DET) * n + t.i0 + il];
    sl.lo[il] = static_cast<unsigned short>(sp & 0xffff);
    sl.s[il] = wrap_col(t.Sa[t.i0 + il], 0, n);
    cnt = sp >> 16;
  }
  int x = cnt;  // inclusive scan over the block
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (wl >= o) x += y;
  }
  if (wl == 31) sl.warp_sum[w] = x;
  __syncthreads();
  if (w == 0) {
    int v = wl < kWarps ? sl.warp_sum[wl] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, o);
      if (wl >= o) v += y;
    }
    if (wl < kWarps) sl.warp_sum[wl] = v;
  }
  __syncthreads();
  const int end = x + (w ? sl.warp_sum[w - 1] : 0);
  const int total = sl.warp_sum[kWarps - 1];
  const int step = A.span_rows - t.T + 1;
  const bool one = total <= A.span_rows;
  const int c = one ? 0 : max(0, (end - 1) / step);
  const int cprev = one ? 0 : max(0, (end - cnt - 1) / step);
  if (il < nl) {
    sl.off[il + 1] = end;
    if (il == 0 || cprev != c) sl.first[c] = static_cast<short>(il);
    if (il == nl - 1) {
      sl.nchunks = c + 1;
      sl.first[c + 1] = static_cast<short>(nl);
    }
  }
  if (il == 0) {
    sl.off[0] = 0;
    if (nl == 0) {  // a part past the last line: one empty chunk
      sl.nchunks = 1;
      sl.first[0] = sl.first[1] = 0;
    }
  }
  __syncthreads();
}

// Chunk c's spans into shared memory, packed: line il's k-th tap at row
// r = off[il] - off[first[c]] + k, and beside it rinfo[r] = il | (il's
// line group among the pass's) << 8 | ((S[i] + tap) mod n) << 16. A warp
// copies a line's rows, 16 bytes a thread; a row's detectors past p_pad
// are zero-filled. With pm (the first chunk loaded of a pass), while its
// copies fly, pmt[k DET + lane] gets Pm of the pass's k-th line group at
// detector d0 + lane, mod n. Every thread waits for all of it. -> the
// chunk's rows.
template <typename WT, int DET>
__device__ __forceinline__ int load_spans(uint8_t* smem, int* rinfo,
                                          int* pmt, const Buckets& B,
                                          const Args& A, const Tile& t,
                                          const SpanLines& sl, int c,
                                          bool pm) {
  constexpr int kRow = DET * static_cast<int>(sizeof(WT));
  constexpr int kPieces = kRow / 16, kPer = 16 / static_cast<int>(sizeof(WT));
  const int n = A.n, gsize = n / A.G, g0 = t.i0 / gsize;
  const size_t tap = static_cast<size_t>(n) * A.p_pad;
  const WT* W0 = static_cast<const WT*>(B.W[t.b]) +
                 (static_cast<size_t>(t.g) * t.T * n + t.i0) * A.p_pad +
                 t.d0;
  const int inside = min(DET, A.p_pad - t.d0) * static_cast<int>(sizeof(WT));
  const int a = sl.first[c], b = sl.first[c + 1], base = sl.off[a];
  const int wl = threadIdx.x % 32;
  for (int il = a + static_cast<int>(threadIdx.x) / 32; il < b;
       il += kThreads / 32) {
    const int r0 = sl.off[il] - base, cnt = sl.off[il + 1] - sl.off[il];
    const int lo = sl.lo[il];
    const WT* src = W0 + lo * tap + static_cast<size_t>(il) * A.p_pad;
    uint8_t* dst = smem + static_cast<size_t>(r0) * kRow;
    for (int q = wl; q < cnt * kPieces; q += 32) {
      const int k = q / kPieces, pc = q % kPieces;
      const bool in = pc * 16 < inside;
      hopper::cp_async16(dst + k * kRow + pc * 16,
                         in ? src + k * tap + pc * kPer : src, in ? 16 : 0);
    }
    const unsigned info = il | ((t.i0 + il) / gsize - g0) << 8;
    for (int k = wl; k < cnt; k += 32)
      rinfo[r0 + k] = static_cast<int>(
          info | static_cast<unsigned>((sl.s[il] + lo + k) % n) << 16);
  }
  if (pm) {
    for (int k = threadIdx.x; k < pm_groups(A) * DET; k += kThreads) {
      const int grp = min(g0 + k / DET, A.G - 1);
      const int d = min(t.d0 + k % DET, A.p_pad - 1);
      pmt[k] = wrap_col(t.Pma[grp * A.p_pad + d], 0, n);
    }
  }
  hopper::cp_async_wait_all();
  __syncthreads();
  return sl.off[b] - base;
}

// Stage 1 on a chunk of nrows packed rows: this thread's rows (r = slice,
// slice + 256 / DET, ...), added to acc in row order. No branch on the
// weight: the gathers of consecutive rows are in flight together.
template <typename WT, int DET>
__device__ __forceinline__ float fwd_rows(const WT* slab, const int* rinfo,
                                          const int* pmt, int nrows,
                                          const float* Xb, const Tile& t,
                                          const Args& A, int lane, int slice,
                                          float acc) {
  constexpr int kSl = kThreads / DET;
  const int n = A.n;
#pragma unroll 4
  for (int r = slice; r < nrows; r += kSl) {
    const float wv = slab_weight(slab, static_cast<size_t>(r) * DET + lane,
                                 t.sc);
    const unsigned info = static_cast<unsigned>(rinfo[r]);
    int col = (info >> 16) + pmt[((info >> 8) & 0xff) * DET + lane];
    if (col >= n) col -= n;
    const size_t i = static_cast<size_t>(t.i0 + (info & 0xff));
    const float xv = wv != 0.f ? Xb[i * n + col] : 0.f;
    acc = wv != 0.f ? fmaf(wv, xv, acc) : acc;
  }
  return acc;
}

// Stage 2 on a chunk: back-project ys = y[d] 2^e over this thread's rows
// into the int64 image (element (line i, column col) at acc[i ri + col
// ci]).
template <typename WT, int DET>
__device__ __forceinline__ void adj_rows(const WT* slab, const int* rinfo,
                                         const int* pmt, int nrows,
                                         unsigned long long* acc, size_t ri,
                                         size_t ci, const Tile& t,
                                         const Args& A, int lane, int slice,
                                         double ys) {
  constexpr int kSl = kThreads / DET;
  const int n = A.n;
#pragma unroll 4
  for (int r = slice; r < nrows; r += kSl) {
    const float wv = slab_weight(slab, static_cast<size_t>(r) * DET + lane,
                                 t.sc);
    if (wv == 0.f) continue;
    const unsigned info = static_cast<unsigned>(rinfo[r]);
    int col = (info >> 16) + pmt[((info >> 8) & 0xff) * DET + lane];
    if (col >= n) col -= n;
    const size_t i = static_cast<size_t>(t.i0 + (info & 0xff));
    const long long q = __double2ll_rn(static_cast<double>(wv) * ys);
    if (q) atomicAdd(acc + i * ri + col * ci,
                     static_cast<unsigned long long>(q));
  }
}

// 6 blocks an SM (40 registers a thread): capped at 32 the span walk
// spills and runs 3% slower on an H100 (PERF.md, section 6); the shared
// memory of the plan's slab lets 6 blocks share an SM too. PASSES: the
// blocks have more than kMaxLines lines (n > 4096 at 16 parts); only then
// does the kernel hold the passes' state, which spills 24 bytes at 40
// registers and ran 2-3% slower on the benchmark's packs
template <typename WT, int DET, bool PASSES>
__global__ void __launch_bounds__(kThreads, 6)
    ata_kernel(const __grid_constant__ Buckets B, const Args A) {
  constexpr int kSl = kThreads / DET;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // dynamic: span_rows rows of DET weights, their rinfo, the predictors
  const WT* slab = reinterpret_cast<const WT*>(smem_raw);
  int* rinfo = reinterpret_cast<int*>(
      smem_raw + static_cast<size_t>(A.span_rows) * DET * sizeof(WT));
  int* pmt = rinfo + A.span_rows;
  __shared__ float part[kSl][DET];
  __shared__ float ypart[DET];
  __shared__ SpanLines sl;
  cg::cluster_group cluster = cg::this_cluster();
  // t's lines [i0, i1) are those of the pass in shared memory: the block
  // takes its lines (kept in sl, not in registers) in passes of at most
  // kMaxLines, one a thread of span_lines; a block of at most kMaxLines
  // lines makes one pass
  Tile t = tile_of<DET>(B, A);
  if (PASSES) {
    if (threadIdx.x == 0) {
      sl.b0 = t.i0;
      sl.b1 = t.i1;
    }
    t.i1 = min(t.i1, t.i0 + kMaxLines);
  }
  const int lane = threadIdx.x % DET, slice = threadIdx.x / DET;
  const size_t img = static_cast<size_t>(A.n) * A.n;
  const float* Xb = (B.cols[t.b] ? A.inT : A.in) + t.f * img;
  unsigned long long* fixed = A.acc + t.f * img;
  const size_t ri = B.cols[t.b] ? 1 : A.n, ci = B.cols[t.b] ? A.n : 1;
  int e;
  const bool live = fixed_scale(A, t.f, &e) > 0;  // the same for the block
  // stage 1, pass by pass
  float acc = 0.f;
  int nrows = 0;
  for (;;) {
    span_lines<DET>(sl, B, A, t);
    const int nchunks = sl.nchunks;
    for (int c = 0; c < nchunks; ++c) {
      if (c > 0) __syncthreads();
      nrows = load_spans<WT, DET>(smem_raw, rinfo, pmt, B, A, t, sl, c,
                                  c == 0);
      acc = fwd_rows<WT, DET>(slab, rinfo, pmt, nrows, Xb, t, A, lane,
                              slice, acc);
    }
    if (!PASSES || t.i0 + kMaxLines >= sl.b1) break;  // the last pass
    __syncthreads();
    t.i0 += kMaxLines;
    t.i1 = min(sl.b1, t.i0 + kMaxLines);
  }
  const float v = sum_slices<DET>(acc, part, lane, slice);
  if (slice == 0) ypart[lane] = v;
  cluster.sync();
  float yd = 0.f;
  for (int r = 0; r < A.parts; ++r)
    yd += cluster.map_shared_rank(ypart, r)[lane];
  // done reading the other blocks' ypart; the matching wait is at the end,
  // so no block leaves while another still reads its ypart, and stage 2
  // does not wait for the slowest rank
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  // stage 2; a y that overflowed float32 flags the frame (see the header)
  if (live && !isfinite(yd))
    atomicOr(A.acc + A.nf * img + t.f, 1ull);
  const double ys = static_cast<double>(yd) * scalbn(1.0, e);
  // stage 2, the passes and their chunks backward: the last pass's last
  // chunk is still in shared memory, every other is loaded again (a pass
  // before the last with its predictors)
  while (live) {
    const int nchunks = sl.nchunks;
    for (int c = nchunks - 1; c >= 0; --c) {
      const bool again = PASSES && t.i0 + kMaxLines < sl.b1;  // not last
      if (again || c < nchunks - 1) {
        __syncthreads();
        nrows = load_spans<WT, DET>(smem_raw, rinfo, pmt, B, A, t, sl, c,
                                    again && c == nchunks - 1);
      }
      adj_rows<WT, DET>(slab, rinfo, pmt, nrows, fixed, ri, ci, t, A, lane,
                        slice, ys);
    }
    if (!PASSES || t.i0 <= sl.b0) break;  // the first pass
    __syncthreads();
    t.i1 = t.i0;
    t.i0 -= kMaxLines;
    span_lines<DET>(sl, B, A, t);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename WT>
struct TmaType;
template <>
struct TmaType<float> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct TmaType<int8_t> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// The plan's numbers come from the wrapper (banded_kernels.launch_plan);
// the shared memory and each TMA load's byte count follow from them here,
// so a plan the kernel cannot run is refused, never run.
template <typename WT, int DET>
int launch(int op, int nb, const void* const* W, const void* const* S,
           const void* const* Pm, const void* const* scales,
           const void* const* aidx, const void* const* spans, const int* na,
           const int* T, const int* L, const int* Tb, const int* cols,
           const int* fa, const Args& A, int finish, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const bool cluster = op != kAdj;  // K3's parts need no shared memory
  if (op < kFwd || op > kAta || nb < 1 || nb > kMaxBuckets || A.parts < 1 ||
      (cluster && A.parts > kMaxCluster) || A.lines < 1 || A.G < 1 ||
      A.n % A.G || static_cast<long long>(A.parts) * A.lines < A.n ||
      A.nf < 1)
    return bad;
  if (op != kFwd && (!A.acc || !A.amax || !A.bound || A.bstride < 0))
    return bad;
  if (op != kAta && (!aidx || A.p < 1 || A.p > A.p_pad || A.rows < 1))
    return bad;
  if (op == kAta && (!spans || A.span_rows < 1 || A.n > 0xffff))
    return bad;
  Buckets B;
  std::memset(&B, 0, sizeof(B));
  B.nb = nb;
  long long blocks = 0, smem = 0;
  for (int k = 0; k < nb; ++k) {
    if (na[k] < 1 || T[k] < 1 || fa[k] < 0 || (op != kAta && !aidx[k]))
      return bad;
    // the pack holds (nf - 1) fa + na angles: one stack per frame, or one;
    // TMA coordinates are int32
    const long long angles =
        static_cast<long long>(A.nf - 1) * fa[k] + na[k];
    if (angles * T[k] > 0x7fffffff) return bad;
    if (op == kAta) {
      // every span (at most T rows) fits twice (span_lines' chunks); a
      // first tap fits 16 bits
      if (!spans[k] || T[k] > 0xffff || A.span_rows < 2 * T[k]) return bad;
      B.W[k] = W[k];
      B.spans[k] = static_cast<const int*>(spans[k]);
      B.L[k] = B.Tb[k] = 1;  // no chunks of L lines nor boxes in K1
      smem = std::max(smem, static_cast<long long>(A.span_rows) *
                                (DET * static_cast<long long>(sizeof(WT)) +
                                 4) +
                                pm_groups(A) * DET * 4LL);
    } else {
      if (L[k] < 1 || L[k] > 256 || Tb[k] < 1 || Tb[k] > 256 || T[k] % Tb[k])
        return bad;
      smem = std::max(smem, static_cast<long long>(T[k]) * L[k] * DET *
                                static_cast<long long>(sizeof(WT)));
      const uint64_t dims[3] = {static_cast<uint64_t>(A.p_pad),
                                static_cast<uint64_t>(A.n),
                                static_cast<uint64_t>(angles) * T[k]};
      const uint32_t box[3] = {DET, static_cast<uint32_t>(L[k]),
                               static_cast<uint32_t>(Tb[k])};
      const int err = hopper::tensor_map(&B.map[k], W[k], TmaType<WT>::value,
                                         sizeof(WT), 3, dims, box,
                                         CU_TENSOR_MAP_SWIZZLE_NONE);
      if (err) return err;
      B.L[k] = L[k];
      B.Tb[k] = Tb[k];
    }
    B.S[k] = static_cast<const int*>(S[k]);
    B.Pm[k] = static_cast<const int*>(Pm[k]);
    B.scales[k] = static_cast<const float*>(scales[k]);
    B.aidx[k] = op != kAta ? static_cast<const int*>(aidx[k]) : nullptr;
    B.T[k] = T[k];
    B.cols[k] = cols[k];
    B.fa[k] = fa[k];
    B.start[k] = static_cast<int>(blocks);
    blocks += static_cast<long long>(A.parts) * ((A.p_pad + DET - 1) / DET) *
              na[k] * A.nf;
    if (blocks > 0x7fffffff) return bad;
  }
  if (smem > kSmemMax) return bad;
  B.start[nb] = static_cast<int>(blocks);
  void (*kern)(Buckets, Args) =
      op == kFwd               ? &fwd_kernel<WT, DET>
      : op == kAdj             ? &adj_kernel<WT, DET>
      : A.lines > kMaxLines    ? &ata_kernel<WT, DET, true>
                               : &ata_kernel<WT, DET, false>;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (!err && cluster)
    err = static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, A.parts > 8));
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = A.parts;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 1 : 0;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, kern, B, A));
  if (err || op == kFwd || !finish) return err;
  const long long total = static_cast<long long>(A.n) * A.n * A.nf;
  const int grid = static_cast<int>(
      std::min<long long>((total + kThreads - 1) / kThreads, 132 * 16));
  fixed_to_float<<<grid, kThreads, 0, stream>>>(A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). The kernel launches on
// `stream`, allocates nothing and returns cudaGetLastError() after the
// launch.
extern "C" {

int trips_banded_max_buckets() { return kMaxBuckets; }

// One launch of K2 (op 0), K3 (op 1) or K1 (op 2) over nb (at most
// trips_banded_max_buckets()) buckets of one pack, one storage kind (kind:
// 0 float32, 1 bfloat16, 2 int8). Per bucket k: its W, S, Pm, scales (null
// unless int8), angle ids aidx (int32 (na,), the sinogram row of each
// angle; K2 and K3 only), tap spans (K1 only: int32 (angles, p_pad / det
// rounded up, n), first tap | taps << 16 of each (angle, det detectors,
// line), see the header), na (angles per frame), T, and from its plan
// (sparse/banded_kernels.py launch_plan; K2 and K3 only) lines per chunk L
// and taps per TMA box Tb (a divisor of T); cols[k] = 1 drives XT (inT)
// and adds its image transposed; fa[k] its frame angle stride (na[k] where
// W, S, Pm, scales, aidx and spans hold nf stacks of na[k] angles, 0 where
// the frames share one). Shared by all: the detectors per tile det (32 or
// 64), the parts that split a tile's lines (a cluster for K1 and K2),
// lines per part, K1's span_rows (the (tap, line) rows a block holds in
// shared memory, at least 2 T), and the frames nf.
// K2: in X, inT XT (nf, n, n), out the (nf, rows, p) float32 sinogram
//     (frame f's angle a writes row aidx[k][f fa + a] of frame f's
//     sinogram, detectors d < p, if that id lies in [0, rows)).
// K3: in the (nf, rows, p) sinogram, out the (nf, n, n) images.
// K1: in X, inT, out the (nf, n, n) images; aidx, L, Tb, p, rows unused.
// K2 and K3 ignore spans and span_rows.
// K1 and K3 add into acc, the int64 (nf, n, n) image followed by nf
// flags (nf n n + nf entries), zeroed before the first of an apply's
// launches; amax holds max|in| of each frame (nf,)
// float32, bound the frames' bounds (float64; frame f's at f bstride;
// see the header). The launch with finish = 1 (the apply's last) then
// writes out from acc. K2 ignores acc, amax, bound, bstride and finish.
int trips_banded(int op, int kind, int nb, const void* const* W,
                 const void* const* S, const void* const* Pm,
                 const void* const* scales, const void* const* aidx,
                 const void* const* spans, const int* na, const int* T,
                 const int* L, const int* Tb, const int* cols, const int* fa,
                 const void* in, const void* inT, void* out, int p, int rows,
                 int n, int p_pad, int G, int det, int parts, int lines,
                 int span_rows, int nf, void* acc, const void* amax,
                 const void* bound, int bstride, int finish, void* stream) {
  const Args A = {static_cast<const float*>(in),
                  static_cast<const float*>(inT), static_cast<float*>(out),
                  p, rows, n, p_pad, G, parts, lines, span_rows, nf,
                  static_cast<unsigned long long*>(acc),
                  static_cast<const float*>(amax),
                  static_cast<const double*>(bound), bstride};
  auto go = [&](auto tag) {
    using WT = decltype(tag);
    auto run = [&](auto det_tag) {
      return launch<WT, decltype(det_tag)::value>(
          op, nb, W, S, Pm, scales, aidx, spans, na, T, L, Tb, cols, fa, A,
          finish,
          static_cast<cudaStream_t>(stream));
    };
    if (det == 32) return run(std::integral_constant<int, 32>{});
    if (det == 64) return run(std::integral_constant<int, 64>{});
    return static_cast<int>(cudaErrorInvalidValue);
  };
  int err;
  switch (kind) {
    case kF32: err = go(float{}); break;
    case kBF16: err = go(__nv_bfloat16{}); break;
    case kInt8: err = go(int8_t{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return err ? err : static_cast<int>(cudaGetLastError());
}

}  // extern "C"
