// Banded projector kernels for Hopper (sm_90a): forward (K2), adjoint (K3)
// and fused normal apply A^T A (K1) of one bucket of the shear-packed band
// format (trips_tpu_torch/sparse/banded_kernels.py holds the wrappers and the
// plain PyTorch versions they are tested against).
//
// Format, per angle a of the bucket (W: (na, T, n, p_pad), S: (na, n),
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
// against 2 flops, so all three kernels are memory-bound (the f32 pack of
// tomo256x60, 226 MB, takes 67.5 us at 3.35 TB/s). K2 and K3: threads run
// along the detector axis d, so each warp reads 32 consecutive weights of
// one (t, i) row; no index data is streamed beyond S and Pm. Forward sums
// are reduced inside the block in a fixed order (deterministic); K3's
// adjoint sums use shared-memory atomics, so their last bits vary.
//
// K1 (replaces _ata_call / _ata_kernel, pallas_banded_kernel.py:402-460)
// was, like K2, bound by latency, not bytes: one 1024-thread block per
// (angle, 32 detectors) with one 4-byte weight load in flight per thread
// keeps ~0.4 MB in flight, a fifth of what 3.35 TB/s needs at ~0.6 us
// latency, and it read the weights twice. Now the lines of a tile are split
// over a thread block cluster, and each block moves its weight slab (at
// most 36 KB) into shared memory with one TMA load, about six blocks per
// SM, reads it there for both stages, sums y across the cluster through
// distributed shared memory in rank order (deterministic), and
// back-projects with global atomics (last bits vary run to run). All
// buckets of an apply go in one launch.
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

constexpr int kLanes = 32;     // detectors per forward block (one warp)
constexpr int kSlices = 32;    // line slices per forward block (blockDim.y)
constexpr int kAdjThreads = 256;
// K1: 256 threads, a tile of DET detectors (32 or 64, the wrapper's plan)
// x kAtaThreads / DET line slices
constexpr int kAtaBuckets = 16;  // K1: most buckets per launch
constexpr int kAtaThreads = 256;
constexpr int kSmemMax = 227 * 1024;  // dynamic shared memory per block

enum WeightKind { kF32 = 0, kBF16 = 1, kInt8 = 2 };

// Stored weight -> f32; int8 storage is scaled by the angle's scale.
__device__ __forceinline__ float weight(const float* W, size_t k, float) {
  return __ldg(W + k);
}
__device__ __forceinline__ float weight(const __nv_bfloat16* W, size_t k,
                                        float) {
  return __bfloat162float(W[k]);
}
__device__ __forceinline__ float weight(const int8_t* W, size_t k, float sc) {
  return static_cast<float>(W[k]) * sc;
}

// The same from K1's shared-memory slab (no read-only global path).
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

// Partial forward sum of detector d of one angle over the lines
// i = slice, slice + kSlices, ... and all taps.
template <typename WT>
__device__ float fwd_partial(const float* __restrict__ X,
                             const WT* __restrict__ Wa,
                             const int* __restrict__ Sa,
                             const int* __restrict__ Pma, float sc, int T,
                             int n, int p_pad, int gsize, int d, int slice) {
  const size_t tstride = static_cast<size_t>(n) * p_pad;
  float acc = 0.f;
  for (int i = slice; i < n; i += kSlices) {
    const float* xi = X + static_cast<size_t>(i) * n;
    const size_t wi = static_cast<size_t>(i) * p_pad + d;
    int c = wrap_col(Sa[i], Pma[(i / gsize) * p_pad + d], n);
    for (int t = 0; t < T; ++t) {
      acc += weight(Wa, wi + t * tstride, sc) * xi[c];
      if (++c == n) c = 0;
    }
  }
  return acc;
}

// Sum the kSlices partials of each lane in a fixed order; the result is
// valid in the threads with threadIdx.y == 0.
__device__ __forceinline__ float reduce_slices(float v,
                                               float (*part)[kLanes]) {
  part[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.y == 0) {
    for (int k = 0; k < kSlices; ++k) s += part[k][threadIdx.x];
  }
  return s;
}

// K2: grid (na, p_pad / kLanes), block (kLanes, kSlices). Each output is
// written once by one thread.
template <typename WT>
__global__ void __launch_bounds__(kLanes * kSlices)
    fwd_kernel(const float* __restrict__ X, const WT* __restrict__ W,
               const int* __restrict__ S, const int* __restrict__ Pm,
               const float* __restrict__ scales, float* __restrict__ Y,
               int T, int n, int p_pad, int G) {
  __shared__ float part[kSlices][kLanes];
  const int a = blockIdx.x;
  const int d = blockIdx.y * kLanes + threadIdx.x;
  const float sc = scales ? scales[a] : 1.f;
  const float v = fwd_partial(
      X, W + static_cast<size_t>(a) * T * n * p_pad,
      S + static_cast<size_t>(a) * n, Pm + static_cast<size_t>(a) * G * p_pad,
      sc, T, n, p_pad, n / G, d, threadIdx.y);
  const float s = reduce_slices(v, part);
  if (threadIdx.y == 0) Y[static_cast<size_t>(a) * p_pad + d] = s;
}

// K3: one block per image line i; the line's n outputs accumulate in shared
// memory over all angles and taps, then the block writes its row once.
template <typename WT>
__global__ void __launch_bounds__(kAdjThreads)
    adj_kernel(const float* __restrict__ Y, const WT* __restrict__ W,
               const int* __restrict__ S, const int* __restrict__ Pm,
               const float* __restrict__ scales, float* __restrict__ out,
               int na, int T, int n, int p_pad, int G) {
  extern __shared__ float row[];
  const int i = blockIdx.x;
  const int g = i / (n / G);
  const size_t tstride = static_cast<size_t>(n) * p_pad;
  for (int c = threadIdx.x; c < n; c += blockDim.x) row[c] = 0.f;
  __syncthreads();
  for (int a = 0; a < na; ++a) {
    const float sc = scales ? scales[a] : 1.f;
    const int s = S[static_cast<size_t>(a) * n + i];
    const WT* Wai = W + (static_cast<size_t>(a) * T * n + i) * p_pad;
    const int* pm = Pm + (static_cast<size_t>(a) * G + g) * p_pad;
    const float* ya = Y + static_cast<size_t>(a) * p_pad;
    for (int d = threadIdx.x; d < p_pad; d += blockDim.x) {
      const float yd = ya[d];
      int c = wrap_col(s, pm[d], n);
      for (int t = 0; t < T; ++t) {
        const float v = weight(Wai, d + t * tstride, sc) * yd;
        if (v != 0.f) atomicAdd(&row[c], v);
        if (++c == n) c = 0;
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    out[static_cast<size_t>(i) * n + c] = row[c];
  }
}

// K1: one launch for all buckets of an apply (at most kAtaBuckets). Each
// (bucket, angle a, D detectors) tile, D = DET, is a cluster of
// cs consecutive blocks along x that split its n drive lines, rank r taking
// lines [r * lines, (r + 1) * lines); cs is up to 16 (clusters beyond the
// portable 8 are allowed on Hopper). 256 threads: lane = detector, 256 / D
// slices over the lines.
//
// 1. TMA loads the block's weight slab W[a, :, lines, d0 .. d0 + D - 1]
//    into shared memory, T x L x D values (L = the bucket's chunk_lines; one
//    load when the rank's lines fit, else chunk by chunk).
// 2. Stage 1 sums the block's partial y[d] from the slab; zero weights
//    (91% of the pack) gather nothing from X.
// 3. The cs partials are summed through distributed shared memory in rank
//    order, so every block holds the same y (deterministic).
// 4. Stage 2 back-projects y from the same slab with global atomics,
//    skipping zeros. When the rank's lines took several chunks, stage 2
//    walks them backward and reloads all but the last, from L2 if it
//    still holds them.
//
// One launch, not one per bucket: a bucket's tiles fill the card about
// once, so per-bucket launches ran every block's load, then every block's
// arithmetic, in lockstep; across buckets the blocks of later waves load
// while earlier ones compute.
struct AtaBuckets {
  CUtensorMap map[kAtaBuckets];  // W (p_pad, n, na T) boxes {DET, L, Tb}
  const int* S[kAtaBuckets];
  const int* Pm[kAtaBuckets];
  const float* scales[kAtaBuckets];
  int T[kAtaBuckets], L[kAtaBuckets], Tb[kAtaBuckets];
  int cols[kAtaBuckets];  // 1: drives the transposed image, adds transposed
  int start[kAtaBuckets + 1];   // first block of each bucket
  int nb;
};

template <typename WT, int DET>
__global__ void __launch_bounds__(kAtaThreads)
    ata_kernel(const __grid_constant__ AtaBuckets B,
               const float* __restrict__ X, const float* __restrict__ XT,
               float* __restrict__ out, int n, int p_pad, int G, int lines) {
  constexpr int kDet = DET, kSl = kAtaThreads / kDet;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const WT* slab = reinterpret_cast<const WT*>(smem_raw);
  __shared__ float part[kSl][kDet];
  __shared__ float ypart[kDet];
  __shared__ uint64_t bar;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  int b = 0;
  while (b + 1 < B.nb && static_cast<int>(blockIdx.x) >= B.start[b + 1]) ++b;
  const int tile = (static_cast<int>(blockIdx.x) - B.start[b]) / cs;
  const int dchunks = (p_pad + kDet - 1) / kDet;
  const int a = tile / dchunks, d0 = (tile % dchunks) * kDet;
  const int T = B.T[b], L = B.L[b], Tb = B.Tb[b];
  const float* Xb = B.cols[b] ? XT : X;
  // image element (line i, column c) of this bucket at out[i * ri + c * ci]
  const size_t ri = B.cols[b] ? 1 : n, ci = B.cols[b] ? n : 1;
  const CUtensorMap* mW = &B.map[b];
  const int lane = threadIdx.x % kDet, slice = threadIdx.x / kDet;
  const int d = min(d0 + lane, p_pad - 1), gsize = n / G;
  const int i0 = rank * lines, i1 = min(n, i0 + lines);
  const int nchunks = i1 > i0 ? (i1 - i0 + L - 1) / L : 0;
  const float sc = B.scales[b] ? B.scales[b][a] : 1.f;
  const int* Sa = B.S[b] + static_cast<size_t>(a) * n;
  const int* Pma = B.Pm[b] + static_cast<size_t>(a) * G * p_pad;
  const size_t tstride = static_cast<size_t>(L) * kDet;
  if (threadIdx.x == 0) {
    hopper::bar_init(&bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  uint32_t phase = 0;
  auto load = [&](int c) {
    if (threadIdx.x == 0) {
      hopper::bar_expect_tx(&bar, T * tstride * sizeof(WT));
      for (int t0 = 0; t0 < T; t0 += Tb) {
        hopper::tma_load_3d(smem_raw + t0 * tstride * sizeof(WT), mW, &bar,
                            d0, i0 + c * L, a * T + t0);
      }
    }
    hopper::bar_wait(&bar, phase);
    phase ^= 1;
  };
  // stage 1
  float acc = 0.f;
  for (int c = 0; c < nchunks; ++c) {
    if (c > 0) __syncthreads();  // every thread is done with chunk c - 1
    load(c);
    const int ib = i0 + c * L, nl = min(L, i1 - ib);
    for (int il = slice; il < nl; il += kSl) {
      const int i = ib + il;
      const float* xi = Xb + static_cast<size_t>(i) * n;
      int col = wrap_col(Sa[i], Pma[(i / gsize) * p_pad + d], n);
      const WT* w = slab + il * kDet + lane;
#pragma unroll 4
      for (int t = 0; t < T; ++t) {
        const float wv = slab_weight(w, t * tstride, sc);
        if (wv != 0.f) acc += wv * xi[col];
        if (++col == n) col = 0;
      }
    }
  }
  part[slice][lane] = acc;
  __syncthreads();
  if (slice == 0) {
    float v = 0.f;
    for (int k = 0; k < kSl; ++k) v += part[k][lane];
    ypart[lane] = v;
  }
  cluster.sync();
  float yd = 0.f;
  for (int r = 0; r < cs; ++r) yd += cluster.map_shared_rank(ypart, r)[lane];
  // done reading the other blocks' ypart; the matching wait is at the end,
  // so no block leaves while another still reads its ypart, and stage 2
  // does not wait for the slowest rank
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  // stage 2
  for (int c = nchunks - 1; c >= 0; --c) {
    if (c < nchunks - 1) {
      __syncthreads();
      load(c);
    }
    const int ib = i0 + c * L, nl = min(L, i1 - ib);
    for (int il = slice; il < nl; il += kSl) {
      const int i = ib + il;
      float* oi = out + i * ri;
      int col = wrap_col(Sa[i], Pma[(i / gsize) * p_pad + d], n);
      const WT* w = slab + il * kDet + lane;
#pragma unroll 4
      for (int t = 0; t < T; ++t) {
        const float v = slab_weight(w, t * tstride, sc) * yd;
        if (v != 0.f) atomicAdd(oi + col * ci, v);
        if (++col == n) col = 0;
      }
    }
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

// The plan's numbers come from the wrapper (banded_kernels.ata_plan); the
// shared memory and each TMA load's byte count follow from them here, so
// a plan the kernel cannot run is refused, never run.
template <typename WT, int DET>
int launch_ata(int nb, const void* const* W, const void* const* S,
               const void* const* Pm, const void* const* scales,
               const int* na, const int* T, const int* L, const int* Tb,
               const int* cols, const float* X, const float* XT, float* out,
               int n, int p_pad, int G, int cs, int lines,
               cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nb < 1 || nb > kAtaBuckets || cs < 1 || cs > 16 || lines < 1 ||
      static_cast<long long>(cs) * lines < n)
    return bad;
  AtaBuckets B;
  std::memset(&B, 0, sizeof(B));
  B.nb = nb;
  int blocks = 0;
  long long smem = 0;
  for (int k = 0; k < nb; ++k) {
    if (T[k] < 1 || L[k] < 1 || L[k] > 256 || Tb[k] < 1 || Tb[k] > 256 ||
        T[k] % Tb[k])
      return bad;
    smem = std::max(smem, static_cast<long long>(T[k]) * L[k] * DET *
                              static_cast<long long>(sizeof(WT)));
    const uint64_t dims[3] = {static_cast<uint64_t>(p_pad),
                              static_cast<uint64_t>(n),
                              static_cast<uint64_t>(na[k]) * T[k]};
    const uint32_t box[3] = {DET, static_cast<uint32_t>(L[k]),
                             static_cast<uint32_t>(Tb[k])};
    const int err = hopper::tensor_map(&B.map[k], W[k], TmaType<WT>::value,
                                       sizeof(WT), 3, dims, box,
                                       CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err) return err;
    B.S[k] = static_cast<const int*>(S[k]);
    B.Pm[k] = static_cast<const int*>(Pm[k]);
    B.scales[k] = static_cast<const float*>(scales[k]);
    B.T[k] = T[k];
    B.L[k] = L[k];
    B.Tb[k] = Tb[k];
    B.cols[k] = cols[k];
    B.start[k] = blocks;
    blocks += cs * ((p_pad + DET - 1) / DET) * na[k];
  }
  if (smem > kSmemMax) return bad;
  B.start[nb] = blocks;
  int err = static_cast<int>(cudaFuncSetAttribute(
      ata_kernel<WT, DET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  // clusters of 16 blocks are beyond the portable 8 (Hopper has them)
  if (!err)
    err = static_cast<int>(cudaFuncSetAttribute(
        ata_kernel<WT, DET>, cudaFuncAttributeNonPortableClusterSizeAllowed,
        cs > 8));
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kAtaThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, ata_kernel<WT, DET>, B, X,
                                             XT, out, n, p_pad, G, lines));
}

template <typename WT>
void launch(int op, const float* in, const void* W, const int* S,
            const int* Pm, const float* scales, float* out, int na, int T,
            int n, int p_pad, int G, cudaStream_t stream) {
  const WT* w = static_cast<const WT*>(W);
  if (op == 2) {
    adj_kernel<WT><<<n, kAdjThreads, n * sizeof(float), stream>>>(
        in, w, S, Pm, scales, out, na, T, n, p_pad, G);
    return;
  }
  fwd_kernel<WT><<<dim3(na, p_pad / kLanes), dim3(kLanes, kSlices), 0,
                   stream>>>(in, w, S, Pm, scales, out, T, n, p_pad, G);
}

int dispatch(int op, int kind, const void* in, const void* W, const void* S,
             const void* Pm, const void* scales, void* out, int na, int T,
             int n, int p_pad, int G, void* stream) {
  auto args = [&](auto tag) {
    using WT = decltype(tag);
    launch<WT>(op, static_cast<const float*>(in), W,
               static_cast<const int*>(S), static_cast<const int*>(Pm),
               static_cast<const float*>(scales), static_cast<float*>(out),
               na, T, n, p_pad, G, static_cast<cudaStream_t>(stream));
  };
  switch (kind) {
    case kF32: args(float{}); break;
    case kBF16: args(__nv_bfloat16{}); break;
    case kInt8: args(int8_t{}); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`,
// allocates nothing and returns cudaGetLastError() after the launch.
// kind: 0 float32, 1 bfloat16, 2 int8 (scales: (na,) float32, else null).
extern "C" {

// K1 over nb (at most trips_banded_ata_max_buckets()) buckets of one pack
// (one storage kind) in one launch: per bucket k its W, S, Pm, scales (null
// unless int8), na, T, and from its plan (sparse/banded_kernels.py
// ata_plan) lines per chunk L and taps per TMA box Tb (a divisor of T);
// cols[k] = 1 drives XT and adds its image transposed. Shared by all: the
// detectors per tile det (32 or 64), the cluster size cs and lines per
// rank. out is (n, n) float32 and must be zeroed.
int trips_banded_ata_max_buckets() { return kAtaBuckets; }

int trips_banded_ata(int kind, int nb, const void* const* W,
                     const void* const* S, const void* const* Pm,
                     const void* const* scales, const int* na, const int* T,
                     const int* L, const int* Tb, const int* cols,
                     const void* X, const void* XT, void* out, int n,
                     int p_pad, int G, int det, int cs, int lines,
                     void* stream) {
  auto go = [&](auto tag) {
    using WT = decltype(tag);
    auto run = [&](auto det_tag) {
      return launch_ata<WT, decltype(det_tag)::value>(
          nb, W, S, Pm, scales, na, T, L, Tb, cols,
          static_cast<const float*>(X), static_cast<const float*>(XT),
          static_cast<float*>(out), n, p_pad, G, cs, lines,
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

int trips_banded_fwd(int kind, const void* X, const void* W, const void* S,
                     const void* Pm, const void* scales, void* Y, int na,
                     int T, int n, int p_pad, int G, void* stream) {
  return dispatch(1, kind, X, W, S, Pm, scales, Y, na, T, n, p_pad, G,
                  stream);
}

int trips_banded_adj(int kind, const void* Y, const void* W, const void* S,
                     const void* Pm, const void* scales, void* out, int na,
                     int T, int n, int p_pad, int G, void* stream) {
  return dispatch(2, kind, Y, W, S, Pm, scales, out, na, T, n, p_pad, G,
                  stream);
}

}  // extern "C"
