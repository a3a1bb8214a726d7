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
// K4 (replaces rotate_all_pallas, trips_tpu/operators/pallas_shear.py:98):
// quarter canvas kq[a] -> x-shear, y-shear, x-shear -> (na, C, C), rounded
// once to the output type. The TPU kernel keeps a whole canvas in VMEM and
// rolls it three times; a 640 KB f32 canvas does not fit a block's shared
// memory here. The three shears compose to an 8-tap gather from the
// quarter canvas (2 taps per shear), so each thread evaluates one output
// directly: the three quarter canvases (1.9 MB at C = 400) stay in L2 and
// nothing intermediate reaches device memory. Bound: L2 gather latency
// and the (na, C, C) output write; each output costs 8 gathers and 14
// flops.
//
// K5 (replaces rotate_all_adjoint_pallas, pallas_shear.py:121): the exact
// transpose, out(c) = (1 - f) * g((c - k) mod C) + f * g((c - k - 1) mod C)
// per stage, stages in reverse order: again an 8-tap gather per view. The
// TPU carries each quarter's sum across a sequential grid; here one thread
// owns one output of one quarter canvas and loops over the views of that
// quarter in order, so the sum is deterministic and needs no atomics. The
// output is float32. Bound: the gathers from the (na, C, C) cotangents
// (19.2 MB in bf16 at 256x256/60 views), read once each from HBM.
//
// K6 (replaces gcontract_ata_pallas, pallas_shear.py:181): with R (na, C*C)
// and G (C*C, p_pad) in one storage type T,
//
//   U   = R . G                 f32 sums, then rounded to T
//   out = U . G^T               f32 sums, float32 out
//
// Two SIMT float32 tile products (64 views x 128 columns per block, 4 x 8
// outputs per thread, 32-deep shared-memory steps). The first product has
// only na x p_pad outputs, each a dot of length C*C, so its K axis is split
// over blocks into float32 partials that a second kernel sums in a fixed
// order (deterministic). The third kernel parallelises over C*C. Bound:
// arithmetic (2 x 7.4 GFLOP per apply at 256x256/60 views against 123 MB of
// bf16 G, ~120 flop/byte) on the float32 SIMT pipes: no tensor cores yet.
// G is read once per product (twice per apply); the TPU kernel streams it
// once per apply. Deviation: at 256x256/60 views the TPU plan falls back
// to a bf16 cross-tile accumulator for lack of VMEM; this kernel always
// sums in float32 across the whole detector axis.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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
// v rounded to T and back (the rounding of U to the G type)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// (j + k) mod C in [0, C) for j in [0, C) and any int k.
__device__ __forceinline__ int wrap(int j, int k, int C) {
  int c = j + k % C;
  if (c < 0) c += C;
  if (c >= C) c -= C;
  return c;
}
__device__ __forceinline__ int inc(int c, int C) {
  return c + 1 == C ? 0 : c + 1;
}
__device__ __forceinline__ int dec(int c, int C) {
  return c == 0 ? C - 1 : c - 1;
}

constexpr int kTileX = 32;  // canvas columns per rotate block
constexpr int kTileY = 8;   // canvas rows per rotate block

// K4: grid (ceil(C / 32), ceil(C / 8), na), block (32, 8); one output each.
template <typename OT>
__global__ void __launch_bounds__(kTileX * kTileY)
    rotate_kernel(const float* __restrict__ Q, const int* __restrict__ kx,
                  const float* __restrict__ fx, const int* __restrict__ ky,
                  const float* __restrict__ fy, const int* __restrict__ kq,
                  OT* __restrict__ out, int C) {
  const int a = blockIdx.z;
  const int j = blockIdx.x * kTileX + threadIdx.x;
  const int i = blockIdx.y * kTileY + threadIdx.y;
  if (i >= C || j >= C) return;
  const float* q = Q + static_cast<size_t>(kq[a]) * C * C;
  const int* kxa = kx + static_cast<size_t>(a) * C;
  const float* fxa = fx + static_cast<size_t>(a) * C;
  const int* kya = ky + static_cast<size_t>(a) * C;
  const float* fya = fy + static_cast<size_t>(a) * C;
  // third shear (x, row i) reads columns c0, c0 + 1 of the second stage
  const float f3 = fxa[i];
  const int c0 = wrap(j, kxa[i], C);
  float s2[2];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int col = t ? inc(c0, C) : c0;
    // second shear (y, column col) reads rows r0, r0 + 1 of the first stage
    const float f2 = fya[col];
    const int r0 = wrap(i, kya[col], C);
    float s1[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int row = u ? inc(r0, C) : r0;
      // first shear (x, row `row`) reads the quarter canvas
      const float f1 = fxa[row];
      const int cc = wrap(col, kxa[row], C);
      const float* qr = q + static_cast<size_t>(row) * C;
      s1[u] = (1.f - f1) * ld(qr, cc) + f1 * ld(qr, inc(cc, C));
    }
    s2[t] = (1.f - f2) * s1[0] + f2 * s1[1];
  }
  st(out, (static_cast<size_t>(a) * C + i) * C + j,
     (1.f - f3) * s2[0] + f3 * s2[1]);
}

// K5: grid (ceil(C / 32), ceil(C / 8), 3), block (32, 8). Thread (r, c) of
// quarter z sums the transposed chain over the views with kq[a] == z, in
// view order, and writes its float32 output once.
template <typename IT>
__global__ void __launch_bounds__(kTileX * kTileY)
    rotate_adj_kernel(const IT* __restrict__ Gc, const int* __restrict__ kx,
                      const float* __restrict__ fx, const int* __restrict__ ky,
                      const float* __restrict__ fy, const int* __restrict__ kq,
                      float* __restrict__ out, int na, int C) {
  const int z = blockIdx.z;
  const int c = blockIdx.x * kTileX + threadIdx.x;
  const int r = blockIdx.y * kTileY + threadIdx.y;
  if (r >= C || c >= C) return;
  float acc = 0.f;
  for (int a = 0; a < na; ++a) {
    if (kq[a] != z) continue;
    const IT* g = Gc + static_cast<size_t>(a) * C * C;
    const int* kxa = kx + static_cast<size_t>(a) * C;
    const float* fxa = fx + static_cast<size_t>(a) * C;
    const int* kya = ky + static_cast<size_t>(a) * C;
    const float* fya = fy + static_cast<size_t>(a) * C;
    // transpose of the first x-shear (row r) reads columns m, m - 1
    const float f3 = fxa[r];
    const int m = wrap(c, -kxa[r], C);
    float s2[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int col = t ? dec(m, C) : m;
      // transpose of the y-shear (column col) reads rows rr, rr - 1
      const float f2 = fya[col];
      const int rr = wrap(r, -kya[col], C);
      float s1[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int row = u ? dec(rr, C) : rr;
        // transpose of the last x-shear (row `row`) reads the cotangent
        const float f1 = fxa[row];
        const int cc = wrap(col, -kxa[row], C);
        const IT* gr = g + static_cast<size_t>(row) * C;
        s1[u] = (1.f - f1) * ld(gr, cc) + f1 * ld(gr, dec(cc, C));
      }
      s2[t] = (1.f - f2) * s1[0] + f2 * s1[1];
    }
    acc += (1.f - f3) * s2[0] + f3 * s2[1];
  }
  out[(static_cast<size_t>(z) * C + r) * C + c] = acc;
}

// ---- K6: tile products -----------------------------------------------------
constexpr int kTM = 64;    // views per block
constexpr int kTN = 128;   // output columns per block
constexpr int kTK = 32;    // depth of one shared-memory step
constexpr int kThreads = 256;
// thread (ty, tx) = (tid / 16, tid % 16) owns rows ty + 16 * i (i < 4) and
// columns tx + 16 * j (j < 8) of the block tile: neighbouring threads read
// neighbouring shared words.

// rows padded by one word: the tile loads write along kk, and an odd row
// stride keeps those stores free of bank conflicts
struct Tile {
  float a[kTK][kTM + 1];
  float b[kTK][kTN + 1];
};

__device__ __forceinline__ void tile_fma(const Tile& s, float (&acc)[4][8]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int kk = 0; kk < kTK; ++kk) {
    float av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = s.a[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = s.b[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// First product, split over K: P[s, a, d] = sum over k in chunk s of
// R[a, k] * G[k, d]. grid (ceil(N / 128), nsplit, ceil(na / 64)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ata_partial_kernel(const T* __restrict__ R, const T* __restrict__ G,
                       float* __restrict__ P, int na, int K, int N,
                       int chunk) {
  __shared__ Tile s;
  const int d0 = blockIdx.x * kTN;
  const int a0 = blockIdx.z * kTM;
  const int kb = blockIdx.y * chunk;
  const int ke = min(K, kb + chunk);
  float acc[4][8] = {};
  for (int k0 = kb; k0 < ke; k0 += kTK) {
    // R tile: kTK contiguous k per view
    for (int e = threadIdx.x; e < kTK * kTM; e += kThreads) {
      const int kk = e % kTK, a = a0 + e / kTK, k = k0 + kk;
      s.a[kk][e / kTK] =
          (a < na && k < ke) ? ld(R, static_cast<size_t>(a) * K + k) : 0.f;
    }
    // G tile: kTN contiguous d per k
    for (int e = threadIdx.x; e < kTK * kTN; e += kThreads) {
      const int kk = e / kTN, d = d0 + e % kTN, k = k0 + kk;
      s.b[kk][e % kTN] =
          (d < N && k < ke) ? ld(G, static_cast<size_t>(k) * N + d) : 0.f;
    }
    __syncthreads();
    tile_fma(s, acc);
    __syncthreads();
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float* Ps = P + static_cast<size_t>(blockIdx.y) * na * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + tx + 16 * j;
      if (a < na && d < N) Ps[static_cast<size_t>(a) * N + d] = acc[i][j];
    }
  }
}

// U[a, d] = sum over s of P[s, a, d] in order s = 0, 1, ..., rounded to T.
template <typename T>
__global__ void ata_reduce_kernel(const float* __restrict__ P,
                                  float* __restrict__ U, int n, int nsplit) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float v = 0.f;
  for (int s = 0; s < nsplit; ++s) v += P[static_cast<size_t>(s) * n + e];
  U[e] = round_to(v, static_cast<const T*>(nullptr));
}

// Second product: out[a, k] = sum over d of U[a, d] * G[k, d].
// grid (ceil(K / 128), ceil(na / 64)).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ata_back_kernel(const float* __restrict__ U, const T* __restrict__ G,
                    float* __restrict__ out, int na, int K, int N) {
  __shared__ Tile s;
  const int k0 = blockIdx.x * kTN;
  const int a0 = blockIdx.y * kTM;
  float acc[4][8] = {};
  for (int d0 = 0; d0 < N; d0 += kTK) {
    for (int e = threadIdx.x; e < kTK * kTM; e += kThreads) {
      const int dd = e % kTK, a = a0 + e / kTK, d = d0 + dd;
      s.a[dd][e / kTK] =
          (a < na && d < N) ? U[static_cast<size_t>(a) * N + d] : 0.f;
    }
    // G tile: kTK contiguous d per output column k
    for (int e = threadIdx.x; e < kTK * kTN; e += kThreads) {
      const int dd = e % kTK, k = k0 + e / kTK, d = d0 + dd;
      s.b[dd][e / kTK] =
          (k < K && d < N) ? ld(G, static_cast<size_t>(k) * N + d) : 0.f;
    }
    __syncthreads();
    tile_fma(s, acc);
    __syncthreads();
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + tx + 16 * j;
      if (a < na && k < K) out[static_cast<size_t>(a) * K + k] = acc[i][j];
    }
  }
}

template <typename T>
void launch_ata(const void* R, const void* G, float* P, float* U, float* out,
                int na, int K, int N, int nsplit, int chunk,
                cudaStream_t stream) {
  const T* r = static_cast<const T*>(R);
  const T* g = static_cast<const T*>(G);
  const int mt = (na + kTM - 1) / kTM;
  ata_partial_kernel<T><<<dim3((N + kTN - 1) / kTN, nsplit, mt), kThreads, 0,
                          stream>>>(r, g, P, na, K, N, chunk);
  const int n = na * N;
  ata_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(P, U, n, nsplit);
  ata_back_kernel<T><<<dim3((K + kTN - 1) / kTN, mt), kThreads, 0, stream>>>(
      U, g, out, na, K, N);
}

dim3 canvas_grid(int C, int z) {
  return dim3((C + kTileX - 1) / kTileX, (C + kTileY - 1) / kTileY, z);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`,
// allocates nothing and returns cudaGetLastError() after its launches.
// kind: 0 float32, 1 bfloat16 (K4: the output; K5: the input; K6: R and G).
extern "C" {

int trips_shear_rotate(int kind, const void* Q, const void* kx,
                       const void* fx, const void* ky, const void* fy,
                       const void* kq, void* out, int na, int C,
                       void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 block(kTileX, kTileY);
  const auto* q = static_cast<const float*>(Q);
  const auto* ikx = static_cast<const int*>(kx);
  const auto* ffx = static_cast<const float*>(fx);
  const auto* iky = static_cast<const int*>(ky);
  const auto* ffy = static_cast<const float*>(fy);
  const auto* ikq = static_cast<const int*>(kq);
  switch (kind) {
    case kF32:
      rotate_kernel<float><<<canvas_grid(C, na), block, 0, s>>>(
          q, ikx, ffx, iky, ffy, ikq, static_cast<float*>(out), C);
      break;
    case kBF16:
      rotate_kernel<__nv_bfloat16><<<canvas_grid(C, na), block, 0, s>>>(
          q, ikx, ffx, iky, ffy, ikq, static_cast<__nv_bfloat16*>(out), C);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int trips_shear_rotate_adj(int kind, const void* Gc, const void* kx,
                           const void* fx, const void* ky, const void* fy,
                           const void* kq, void* out, int na, int C,
                           void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 block(kTileX, kTileY);
  const auto* ikx = static_cast<const int*>(kx);
  const auto* ffx = static_cast<const float*>(fx);
  const auto* iky = static_cast<const int*>(ky);
  const auto* ffy = static_cast<const float*>(fy);
  const auto* ikq = static_cast<const int*>(kq);
  auto* o = static_cast<float*>(out);
  switch (kind) {
    case kF32:
      rotate_adj_kernel<float><<<canvas_grid(C, 3), block, 0, s>>>(
          static_cast<const float*>(Gc), ikx, ffx, iky, ffy, ikq, o, na, C);
      break;
    case kBF16:
      rotate_adj_kernel<__nv_bfloat16><<<canvas_grid(C, 3), block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(Gc), ikx, ffx, iky, ffy, ikq, o,
          na, C);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// R (na, K), G (K, N); scratch P (nsplit, na, N) and U (na, N) float32;
// out (na, K) float32. K is split into nsplit chunks of `chunk` (a
// multiple of 32) for the first product.
int trips_shear_ata(int kind, const void* R, const void* G, void* P, void* U,
                    void* out, int na, int K, int N, int nsplit, int chunk,
                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* p = static_cast<float*>(P);
  auto* u = static_cast<float*>(U);
  auto* o = static_cast<float*>(out);
  switch (kind) {
    case kF32:
      launch_ata<float>(R, G, p, u, o, na, K, N, nsplit, chunk, s);
      break;
    case kBF16:
      launch_ata<__nv_bfloat16>(R, G, p, u, o, na, K, N, nsplit, chunk, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
