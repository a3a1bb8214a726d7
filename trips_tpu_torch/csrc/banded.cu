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
// Bound: the weight stream. Every stored weight is read once per apply
// against 2 flops (4 for K1), so all three kernels are memory-bound (the
// f32 pack of tomo256x60, 226 MB, takes 67.5 us at 3.35 TB/s). Threads
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
// - Each block moves its weight slab W[a, :, lines, d0 .. d0 + DET - 1]
//   (T x L x DET values, L = the bucket's chunk_lines; 18 to 36 KB by
//   the plan, so six to eight blocks share an SM) into shared memory with
//   TMA, in one load when its lines fit, else chunk by chunk, and reads it
//   there. Zero weights (91% of the pack) gather and add nothing.
//
// K2 (fwd_kernel) sums its partial y over the block's lines; the parts of
//   a tile form a thread block cluster and rank 0 sums their partials
//   through distributed shared memory in rank order (deterministic) and
//   writes them to row aidx[a] of the (rows, p) sinogram, d < p.
// K3 (adj_kernel) reads y[d] from row aidx[a] of the sinogram (0 for
//   d >= p) and back-projects it from the slab with global atomics into
//   the image, zeroed once per apply (last bits vary run to run). Its parts
//   are independent blocks, not a cluster.
// K1 (ata_kernel) runs K2's stage, sums y across the cluster so that
//   every rank holds it, then K3's stage from the same slab. When the
//   rank's lines took several chunks, stage 2 walks them backward and
//   reloads all but the last, from L2 if it still holds them.
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
  CUtensorMap map[kMaxBuckets];  // W (p_pad, n, na T) boxes {DET, L, Tb}
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
  float* out;        // K2: the (rows, p) sinogram; K1, K3: (n, n), zeroed
  int p, rows, n, p_pad, G, parts, lines;
  int nf;            // frames: in, inT and out hold nf of the above
};

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

// Stage 2 on chunk c: back-project yd from this thread's lines with global
// atomics; image element (line i, column col) at out[i * ri + col * ci].
template <typename WT, int DET>
__device__ __forceinline__ void adj_chunk(const WT* slab, float* out,
                                          size_t ri, size_t ci, const Tile& t,
                                          const Args& A, int c, int lane,
                                          int slice, int d, float yd) {
  constexpr int kSl = kThreads / DET;
  const size_t tstride = static_cast<size_t>(t.L) * DET;
  const int n = A.n, gsize = n / A.G;
  const int ib = t.i0 + c * t.L, nl = min(t.L, t.i1 - ib);
  for (int il = slice; il < nl; il += kSl) {
    const int i = ib + il;
    float* oi = out + i * ri;
    int col = wrap_col(t.Sa[i], t.Pma[(i / gsize) * A.p_pad + d], n);
    const WT* w = slab + il * DET + lane;
#pragma unroll 4
    for (int tt = 0; tt < t.T; ++tt) {
      const float v = slab_weight(w, tt * tstride, t.sc) * yd;
      if (v != 0.f) atomicAdd(oi + col * ci, v);
      if (++col == n) col = 0;
    }
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
  float* out = A.out + t.f * static_cast<size_t>(A.n) * A.n;
  init_bar(&bar);
  uint32_t phase = 0;
  for (int c = 0; c < t.nchunks; ++c) {
    if (c > 0) __syncthreads();
    load_chunk<WT, DET>(smem_raw, B, t, &bar, phase, c);
    if (yd != 0.f)
      adj_chunk<WT, DET>(slab, out, ri, ci, t, A, c, lane, slice, d, yd);
  }
}

template <typename WT, int DET>
__global__ void __launch_bounds__(kThreads)
    ata_kernel(const __grid_constant__ Buckets B, const Args A) {
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
  float* out = A.out + t.f * img;
  const size_t ri = B.cols[t.b] ? 1 : A.n, ci = B.cols[t.b] ? A.n : 1;
  init_bar(&bar);
  uint32_t phase = 0;
  // stage 1
  float acc = 0.f;
  for (int c = 0; c < t.nchunks; ++c) {
    if (c > 0) __syncthreads();
    load_chunk<WT, DET>(smem_raw, B, t, &bar, phase, c);
    acc = fwd_chunk<WT, DET>(slab, Xb, t, A, c, lane, slice, d, acc);
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
  // stage 2
  for (int c = t.nchunks - 1; c >= 0; --c) {
    if (c < t.nchunks - 1) {
      __syncthreads();
      load_chunk<WT, DET>(smem_raw, B, t, &bar, phase, c);
    }
    adj_chunk<WT, DET>(slab, out, ri, ci, t, A, c, lane, slice, d, yd);
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
           const void* const* aidx, const int* na, const int* T,
           const int* L, const int* Tb, const int* cols, const int* fa,
           const Args& A, cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  const bool cluster = op != kAdj;  // K3's parts need no shared memory
  if (op < kFwd || op > kAta || nb < 1 || nb > kMaxBuckets || A.parts < 1 ||
      (cluster && A.parts > kMaxCluster) || A.lines < 1 || A.G < 1 ||
      A.n % A.G || static_cast<long long>(A.parts) * A.lines < A.n ||
      A.nf < 1)
    return bad;
  if (op != kAta && (!aidx || A.p < 1 || A.p > A.p_pad || A.rows < 1))
    return bad;
  Buckets B;
  std::memset(&B, 0, sizeof(B));
  B.nb = nb;
  long long blocks = 0, smem = 0;
  for (int k = 0; k < nb; ++k) {
    if (na[k] < 1 || T[k] < 1 || L[k] < 1 || L[k] > 256 || Tb[k] < 1 ||
        Tb[k] > 256 || T[k] % Tb[k] || fa[k] < 0 ||
        (op != kAta && !aidx[k]))
      return bad;
    // the pack holds (nf - 1) fa + na angles: one stack per frame, or one;
    // TMA coordinates are int32
    const long long angles =
        static_cast<long long>(A.nf - 1) * fa[k] + na[k];
    if (angles * T[k] > 0x7fffffff) return bad;
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
    B.S[k] = static_cast<const int*>(S[k]);
    B.Pm[k] = static_cast<const int*>(Pm[k]);
    B.scales[k] = static_cast<const float*>(scales[k]);
    B.aidx[k] = op != kAta ? static_cast<const int*>(aidx[k]) : nullptr;
    B.T[k] = T[k];
    B.L[k] = L[k];
    B.Tb[k] = Tb[k];
    B.cols[k] = cols[k];
    B.fa[k] = fa[k];
    B.start[k] = static_cast<int>(blocks);
    blocks += static_cast<long long>(A.parts) * ((A.p_pad + DET - 1) / DET) *
              na[k] * A.nf;
    if (blocks > 0x7fffffff) return bad;
  }
  if (smem > kSmemMax) return bad;
  B.start[nb] = static_cast<int>(blocks);
  void (*kern)(Buckets, Args) = op == kFwd   ? &fwd_kernel<WT, DET>
                                : op == kAdj ? &adj_kernel<WT, DET>
                                             : &ata_kernel<WT, DET>;
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
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kern, B, A));
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
// angle; K2 and K3 only), na (angles per frame), T, and from its plan
// (sparse/banded_kernels.py launch_plan) lines per chunk L and taps per
// TMA box Tb (a divisor of T); cols[k] = 1 drives XT (inT) and adds its
// image transposed; fa[k] its frame angle stride (na[k] where W, S, Pm,
// scales and aidx hold nf stacks of na[k] angles, 0 where the frames share
// one). Shared by all: the detectors per tile det (32 or 64), the parts
// that split a tile's lines (a cluster for K1 and K2), lines per part, and
// the frames nf.
// K2: in X, inT XT (nf, n, n), out the (nf, rows, p) float32 sinogram
//     (frame f's angle a writes row aidx[k][f fa + a] of frame f's
//     sinogram, detectors d < p, if that id lies in [0, rows)).
// K3: in the (nf, rows, p) sinogram, out the (nf, n, n) images, zeroed.
// K1: in X, inT, out the (nf, n, n) images, zeroed; aidx, p, rows unused.
int trips_banded(int op, int kind, int nb, const void* const* W,
                 const void* const* S, const void* const* Pm,
                 const void* const* scales, const void* const* aidx,
                 const int* na, const int* T, const int* L, const int* Tb,
                 const int* cols, const int* fa, const void* in,
                 const void* inT, void* out, int p, int rows, int n,
                 int p_pad, int G, int det, int parts, int lines, int nf,
                 void* stream) {
  const Args A = {static_cast<const float*>(in),
                  static_cast<const float*>(inT), static_cast<float*>(out),
                  p, rows, n, p_pad, G, parts, lines, nf};
  auto go = [&](auto tag) {
    using WT = decltype(tag);
    auto run = [&](auto det_tag) {
      return launch<WT, decltype(det_tag)::value>(
          op, nb, W, S, Pm, scales, aidx, na, T, L, Tb, cols, fa, A,
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
