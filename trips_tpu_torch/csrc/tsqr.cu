// R-only tall-skinny QR (TSQR) for Hopper (sm_90a): the k x k upper
// triangle R of a Householder QR of diag(w) X, X an m x k row-major panel
// with m >> k (trips_tpu_torch/sparse/tall_qr.py holds the wrapper, its
// launch plan and the plain PyTorch version it is tested against).
//
// It replaces no TPU kernel: the JAX package leaves this QR to
// jnp.linalg.qr (trips_tpu/solvers/mmgks.py:91-92), which cuSOLVER runs on
// this card as an unblocked geqr2 at ~600x the time of one read of the
// panel. MMGKS needs only R (its projections come from R of the panel with
// the data columns appended), so no Q is formed.
//
// Bound: one read of the panel (1.6M x 23 float32, 149 MB: 45 us at
// 3.35 TB/s). The arithmetic, ~2k^2 flops a row, is small, but every
// Householder reflection is a reduction over rows followed by an update
// that depends on it, so the cost is the synchronization per reflection.
// The design keeps that synchronization inside one warp:
//
// - fold(R, X): R <- the R factor of [R; X] for a warp-private k x k
//   triangle R and up to 128 rows X in shared memory, by k structured
//   reflections (reflection j touches R's row j and X's column j only:
//   LAPACK larfg semantics, a zero column below R gives tau = 0). A lane
//   owns 4 rows; each reduction over rows is 4 products in registers and
//   one butterfly of shuffles (every lane gets the same bits), with 4
//   columns' butterflies interleaved. No block barrier per reflection.
// - Leaf (tsqr_geqrf, every block): a block owns a contiguous range of
//   rows; its warps take tiles of tile_rows rows round robin, copy each
//   into shared memory with cp.async (any k: 4- or 8-byte copies, so no
//   alignment is asked of the panel), scale the rows by w, and fold the
//   tile into their own triangle. The block then merges its warps'
//   triangles (merge_warps), each fold taking up to 128 / k triangles
//   stacked as rows, in a fixed tree.
// - Tree (the same launch): each block writes its triangle to `leaves`
//   and takes a ticket (zeroed on the stream before the launch); the last
//   block to finish reads the leaves as a (blocks k) x k panel, runs the
//   leaf routine on it and writes R with zeros below the diagonal.
//
// Every sum runs in an order fixed by the plan (m, k, the block and warp
// counts), never by the scheduler, so R repeats to the bit from run to
// run. Shared memory: the warps' triangles, then their tiles, each row
// padded to an odd stride (k | 1) so that lanes reading one column of
// their rows hit distinct banks, for 4- and 8-byte elements alike.
// float and double; k <= 128. No overflow guard: sums of squares in T.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The kernel's shape (sparse/tall_qr.py FOLD_ROWS, MAX_WARPS). A merge
// folds a whole k x k triangle as one fold's rows, so k <= kFoldRows. The
// plan's shared memory is the wrapper's to size; the device refuses more
// than a block may have at cudaFuncSetAttribute.
constexpr int kRho = 4;                 // rows a lane owns in a fold
constexpr int kFoldRows = 32 * kRho;    // rows one fold takes
constexpr int kU = 4;                   // columns reduced together
constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(B)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// R <- R factor of [R; X] (one warp). R: k x k at row stride ks, upper
// triangular. X: n <= kFoldRows rows of k, row r at
// (r / grp) * gstride + (r % grp) * ks (grp = n: one tile; grp = k: stacked
// triangles gstride apart). X is overwritten.
template <typename T>
__device__ void fold(T* __restrict__ R, T* __restrict__ X, int n, int k,
                     int ks, int grp, int gstride) {
  const int lane = threadIdx.x & 31;
  int off[kRho];
  bool live[kRho];
#pragma unroll
  for (int q = 0; q < kRho; ++q) {
    const int r = lane + 32 * q;
    live[q] = r < n;
    off[q] = live[q] ? (r / grp) * gstride + (r % grp) * ks : 0;
  }
  for (int j = 0; j < k; ++j) {
    T u[kRho];
    T s = T(0);
#pragma unroll
    for (int q = 0; q < kRho; ++q) {
      u[q] = live[q] ? X[off[q] + j] : T(0);
      s = fma(u[q], u[q], s);
    }
    const T sigma = warp_sum(s);  // the same bits in every lane
    if (sigma == T(0)) continue;  // tau = 0: H = I
    T* Rj = R + j * ks;
    const T alpha = Rj[j];
    const T nrm = sqrt(fma(alpha, alpha, sigma));
    const T beta = alpha < T(0) ? nrm : -nrm;
    const T tau = (beta - alpha) / beta;
    const T scale = T(1) / (alpha - beta);
#pragma unroll
    for (int q = 0; q < kRho; ++q) u[q] *= scale;
    // w_c = R[j][c] + u . X[:, c]; R[j][c] -= tau w_c; X[:, c] -= tau w_c u
    for (int c0 = j + 1; c0 < k; c0 += kU) {
      T p[kU], rv[kU], xv[kU][kRho];
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        const int c = c0 + i < k ? c0 + i : c0;
        rv[i] = Rj[c];  // every lane reads before lane 0 writes (shuffles)
        T a = T(0);
#pragma unroll
        for (int q = 0; q < kRho; ++q) {
          xv[i][q] = live[q] ? X[off[q] + c] : T(0);
          a = fma(u[q], xv[i][q], a);
        }
        p[i] = a;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int i = 0; i < kU; ++i) p[i] += __shfl_xor_sync(kFull, p[i], o);
      }
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        const int c = c0 + i;
        if (c < k) {
          const T tw = tau * (rv[i] + p[i]);
#pragma unroll
          for (int q = 0; q < kRho; ++q) {
            if (live[q]) X[off[q] + c] = fma(-tw, u[q], xv[i][q]);
          }
          if (lane == 0) Rj[c] = rv[i] - tw;
        }
      }
    }
    if (lane == 0) Rj[j] = beta;
  }
  __syncwarp();
}

// Copy rows [0, n) of the row-major src (n x k) into the tile (row stride
// ks) and scale row r by w[r] (w null: no scaling). One warp.
template <typename T>
__device__ void load_tile(T* __restrict__ tile, const T* __restrict__ src,
                          const T* __restrict__ w, int n, int k, int ks) {
  const int lane = threadIdx.x & 31;
  const int total = n * k, dr = 32 / k, dc = 32 % k;
  int r = lane / k, c = lane % k;
#pragma unroll 4
  for (int e = lane; e < total; e += 32) {
    cp_async<sizeof(T)>(tile + r * ks + c, src + e);
    r += dr;
    c += dc;
    if (c >= k) {
      c -= k;
      ++r;
    }
  }
  cp_async_wait_all();
  __syncwarp();
  if (w != nullptr) {
#pragma unroll
    for (int q = 0; q < kRho; ++q) {
      const int rr = lane + 32 * q;
      if (rr < n) {
        const T s = w[rr];
        T* row = tile + rr * ks;
#pragma unroll 4
        for (int cc = 0; cc < k; ++cc) row[cc] *= s;
      }
    }
    __syncwarp();
  }
}

// Fold the warps' triangles (tri + w k ks, w < nw) into warp 0's: at each
// level the triangles left (s apart) go in groups of g + 1, the first
// folding the next g stacked as one panel of rows.
template <typename T>
__device__ void merge_warps(T* tri, int nw, int k, int ks) {
  const int warp = threadIdx.x >> 5;
  const int g = kFoldRows / k > 1 ? kFoldRows / k : 1;
  for (int s = 1; s < nw; s *= g + 1) {
    const int span = s * (g + 1);
    if (warp % span == 0) {
      const int left = (nw - 1 - warp) / s;
      const int nsrc = left < g ? left : g;
      if (nsrc > 0) {
        fold(tri + warp * k * ks, tri + (warp + s) * k * ks, nsrc * k, k, ks,
             k, s * k * ks);
      }
    }
    __syncthreads();
  }
}

// The block's triangle of rows [lo, hi) of src (weights w or none), left
// in tri (warp 0's slot).
template <typename T>
__device__ void block_r(T* sm, const T* src, const T* w, long long lo,
                        long long hi, int k, int ks, int tile_rows) {
  const int nw = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  T* mine = sm + warp * k * ks;
  T* tile = sm + nw * k * ks + warp * tile_rows * ks;
  for (int i = lane; i < k * ks; i += 32) mine[i] = T(0);
  __syncwarp();
  for (long long r0 = lo + static_cast<long long>(warp) * tile_rows; r0 < hi;
       r0 += static_cast<long long>(nw) * tile_rows) {
    const int n = static_cast<int>(hi - r0 < tile_rows ? hi - r0 : tile_rows);
    load_tile(tile, src + r0 * k, w == nullptr ? nullptr : w + r0, n, k, ks);
    fold(mine, tile, n, k, ks, n, 0);
  }
  __syncthreads();
  merge_warps(sm, nw, k, ks);
}

template <typename T>
__device__ void store_r(T* __restrict__ out, const T* __restrict__ tri, int k,
                        int ks) {
  for (int i = threadIdx.x; i < k * k; i += blockDim.x) {
    out[i] = tri[(i / k) * ks + i % k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    tsqr_geqrf(const T* __restrict__ X, const T* __restrict__ w,
               T* __restrict__ R, T* leaves, unsigned* ticket, long long m,
               int k, int tile_rows, long long rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool last;
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int ks = k | 1;
  const long long lo = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long hi = lo + rows_per_block < m ? lo + rows_per_block : m;
  block_r(sm, X, w, lo, hi, k, ks, tile_rows);
  if (gridDim.x == 1) {
    store_r(R, sm, k, ks);
    return;
  }
  store_r(leaves + static_cast<long long>(blockIdx.x) * k * k, sm, k, ks);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  block_r(sm, static_cast<const T*>(leaves), static_cast<const T*>(nullptr),
          0, static_cast<long long>(gridDim.x) * k, k, ks, tile_rows);
  store_r(R, sm, k, ks);
}

template <typename T>
int launch(const void* X, const void* w, void* R, void* work, long long m,
           int k, int tile_rows, int warps, int blocks,
           long long rows_per_block, cudaStream_t stream) {
  const int ks = k | 1;
  const long long smem = static_cast<long long>(warps) * (k + tile_rows) *
                         ks * static_cast<long long>(sizeof(T));
  if (k < 1 || k > kFoldRows || tile_rows < 1 || tile_rows > kFoldRows ||
      warps < 1 || warps > kMaxWarps || blocks < 1 || smem > INT32_MAX ||
      rows_per_block < 1 || (blocks > 1 && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  T* leaves = static_cast<T*>(work);
  unsigned* ticket = nullptr;
  if (blocks > 1) {
    ticket = reinterpret_cast<unsigned*>(
        leaves + static_cast<long long>(blocks) * k * k);
    const cudaError_t e = cudaMemsetAsync(ticket, 0, sizeof(unsigned),
                                          stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      tsqr_geqrf<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  tsqr_geqrf<T><<<blocks, warps * 32, static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(X), static_cast<const T*>(w), static_cast<T*>(R),
      leaves, ticket, m, k, tile_rows, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// R (k x k, row-major, zeros below the diagonal) of diag(w) X for the
// row-major m x k panel X (w: m weights or null); kind 0 float, 1 double.
// The plan (sparse/tall_qr.py plan): rows per tile (<= 128), warps per
// block (<= 16), blocks, rows per block (blocks x rows_per_block >= m).
// With blocks > 1, work holds blocks k k + 1 elements: the leaves, then
// the ticket (zeroed here, on the stream).
int trips_tsqr(int kind, const void* X, const void* w, void* R, void* work,
               long long m, int k, int tile_rows, int warps, int blocks,
               long long rows_per_block, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0:
      return launch<float>(X, w, R, work, m, k, tile_rows, warps, blocks,
                           rows_per_block, s);
    case 1:
      return launch<double>(X, w, R, work, m, k, tile_rows, warps, blocks,
                            rows_per_block, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
