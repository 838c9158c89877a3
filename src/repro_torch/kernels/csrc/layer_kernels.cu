// Hand-written Hopper (sm_90a) kernel of one layer op: the CUDA
// counterpart of the Pallas TPU kernel of RMSNorm (attention is in
// flash_f32.cu and flash_wgmma.cu, gru_sequence in gru_kernels.cu).
//
//   layer_rmsnorm         <- src/repro/kernels/rmsnorm.py::rmsnorm
//
// Plain C entry point, bound with ctypes in repro_torch/kernels/
// rmsnorm.py. It launches on the caller's stream and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shape it does not
// take). Inputs are float32 or bfloat16 (the `bf16` flag); all math is
// float32 and every output is rounded once, to the input's type.
//
// rmsnorm. It is bound by bytes: N d (in + out bytes) + 4 d over 3.35
// TB/s. So x is read once, with 16-byte loads (8 bf16 or 4 f32 a lane),
// and the row stays in registers from the sum of squares to the scale;
// the output goes out in 16-byte stores, and g (float32) sits in registers
// across every row a warp or block walks (grid-stride, as many blocks as
// the card holds). Route, by d, dtype and alignment: 16 vectors a row or
// fewer, 16 lanes a row (qk-norm's d = 128 bf16: two rows a warp); up to
// 10 vectors a lane, a warp a row (d <= 2560 bf16, d_model's width);
// up to 8 vectors a thread, a block of 256 a row, still one read; a row
// that is not a whole number of vectors, a tensor not 16-byte aligned, or
// a wider row takes the scalar kernels (a warp a row up to d = 1024, a
// block above, the row read a second time from L1/L2). The arithmetic is
// the same on every route: the f32 sum of squares (fmaf), 1 / sqrt(mean +
// eps) with the correctly rounded __fsqrt_rn and an IEEE division (rsqrtf
// is not correctly rounded), and x * r * g in float32, rounded once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <class T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// rmsnorm
// ---------------------------------------------------------------------------

constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
  return 1.0f / __fsqrt_rn(__fadd_rn(__fdiv_rn(ss, (float)d), eps));
}

// The vector route: x read once with 16-byte loads (8 bf16 or 4 f32 a
// lane), the row kept in registers from the sum of squares to the scale,
// out written with 16-byte stores, g held in registers (float32) across
// every row the lane's warp or block walks.
template <class T>
constexpr int kVec = 16 / (int)sizeof(T);
constexpr int kVecThreads = 128;   // warp route: 4 warps a block
constexpr int kWarpVecs = 10;      // vectors a lane holds, warp route
constexpr int kBlockVecs = 8;      // vectors a thread holds, block route

// unpack / pack: a 16-byte vector <-> its float32 values (4: float32, 8:
// bf16, rounded once on the way back)
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// g's vectors c0, c0 + step, ... (NV of them, those below nvec) into
// registers, float32
template <class T, int NV>
__device__ __forceinline__ void load_g(const float* __restrict__ g, int c0,
                                       int step, int nvec,
                                       float (&gr)[NV][kVec<T>]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = c0 + step * i;
    if (c < nvec) {
#pragma unroll
      for (int u = 0; u < kVec<T>; u += 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(
            g + (long long)c * kVec<T> + u));
        gr[i][u] = q.x;
        gr[i][u + 1] = q.y;
        gr[i][u + 2] = q.z;
        gr[i][u + 3] = q.w;
      }
    }
  }
}

// One row's vectors c0, c0 + step, ... : load all, then the partial sum
// of squares (fmaf in element order, as the scalar route)
template <class T, int NV>
__device__ __forceinline__ float load_row(const T* __restrict__ xr, int c0,
                                          int step, int nvec, bool live,
                                          uint4 (&xv)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = c0 + step * i;
    if (live && c < nvec)
      xv[i] = __ldg(reinterpret_cast<const uint4*>(xr) + c);
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = c0 + step * i;
    if (live && c < nvec) {
      float f[kVec<T>];
      unpack(xv[i], f);
#pragma unroll
      for (int u = 0; u < kVec<T>; ++u) ss = fmaf(f[u], f[u], ss);
    }
  }
  return ss;
}

template <class T, int NV>
__device__ __forceinline__ void store_row(T* __restrict__ orow, int c0,
                                          int step, int nvec, bool live,
                                          const uint4 (&xv)[NV],
                                          const float (&gr)[NV][kVec<T>],
                                          float r) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = c0 + step * i;
    if (live && c < nvec) {
      float f[kVec<T>];
      unpack(xv[i], f);
#pragma unroll
      for (int u = 0; u < kVec<T>; ++u)
        f[u] = __fmul_rn(__fmul_rn(f[u], r), gr[i][u]);
      reinterpret_cast<uint4*>(orow)[c] = pack(f);
    }
  }
}

// LPR lanes a row (32 / LPR rows a warp at a time), NV vectors a lane;
// warps walk the rows grid-stride
template <class T, int LPR, int NV>
__global__ void __launch_bounds__(kVecThreads)
rmsnorm_vec_warp_kernel(const T* __restrict__ x, const float* __restrict__ g,
                        T* __restrict__ out, long long N, int d, float eps) {
  constexpr int kRows = 32 / LPR;        // rows a warp takes at a time
  const int lane = threadIdx.x % 32, li = lane % LPR;
  const int nvec = d / kVec<T>;
  float gr[NV][kVec<T>];
  load_g<T, NV>(g, li, LPR, nvec, gr);
  const long long warps = (long long)gridDim.x * (kVecThreads / 32);
  for (long long r0 = ((long long)blockIdx.x * (kVecThreads / 32) +
                       threadIdx.x / 32) * kRows;
       r0 < N; r0 += warps * kRows) {    // warp-uniform: shuffles stay full
    const long long row = r0 + lane / LPR;
    const bool live = row < N;
    uint4 xv[NV];
    float ss = load_row<T, NV>(x + row * d, li, LPR, nvec, live, xv);
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    store_row<T, NV>(out + row * d, li, LPR, nvec, live, xv, gr,
                     inv_rms(ss, d, eps));
  }
}

// rows above the warp route's registers: a block a row, NV vectors a
// thread, still one read; blocks walk the rows grid-stride
template <class T, int NV>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_vec_block_kernel(const T* __restrict__ x, const float* __restrict__ g,
                         T* __restrict__ out, long long N, int d, float eps) {
  __shared__ float part[2][kNormWarps];  // by row parity: one barrier a row
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nvec = d / kVec<T>;
  float gr[NV][kVec<T>];
  load_g<T, NV>(g, threadIdx.x, kNormThreads, nvec, gr);
  int par = 0;
  for (long long row = blockIdx.x; row < N; row += gridDim.x, par ^= 1) {
    uint4 xv[NV];
    float ss = warp_sum(load_row<T, NV>(x + row * d, threadIdx.x,
                                        kNormThreads, nvec, true, xv));
    if (lane == 0) part[par][warp] = ss;
    __syncthreads();
    ss = warp_sum(lane < kNormWarps ? part[par][lane] : 0.0f);
    store_row<T, NV>(out + row * d, threadIdx.x, kNormThreads, nvec, true,
                     xv, gr, inv_rms(ss, d, eps));
  }
}

// The scalar route, for a row that is not a whole number of 16-byte
// vectors, a tensor that is not 16-byte aligned, or a row above the block
// route's registers: scalar loads, the row read twice (the second time
// from L1/L2).
// d <= 1024: one warp per row, kNormWarps rows per block
template <class T>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ g,
                    T* __restrict__ out, long long N, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kNormWarps + threadIdx.x / 32;
  if (row >= N) return;                  // the whole warp leaves together
  const T* xr = x + row * d;
  float ss = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
  const float r = inv_rms(warp_sum(ss), d, eps);
  T* orow = out + row * d;
  for (int c = lane; c < d; c += 32)
    orow[c] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(xr[c]), r), g[c]));
}

// d > 1024: one block per row
template <class T>
__global__ void __launch_bounds__(kNormThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const float* __restrict__ g,
                     T* __restrict__ out, int d, float eps) {
  __shared__ float part[kNormWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const T* xr = x + (long long)blockIdx.x * d;
  float ss = 0.0f;
  for (int c = threadIdx.x; c < d; c += kNormThreads) {
    const float v = to_f32(xr[c]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  ss = lane < kNormWarps ? part[lane] : 0.0f;
  const float r = inv_rms(warp_sum(ss), d, eps);
  T* orow = out + (long long)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += kNormThreads)
    orow[c] = from_f32<T>(__fmul_rn(__fmul_rn(to_f32(xr[c]), r), g[c]));
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  return n;
}

// a grid-stride launch: as many blocks as the card holds at once, or fewer
// when there are fewer rows
template <class K>
unsigned resident_grid(K kernel, int threads, long long blocks_needed) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const long long most = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  return (unsigned)(blocks_needed < most ? blocks_needed : most);
}

template <class T, int LPR, int NV>
int launch_vec_warp(const void* x, const float* g, void* out, long long N,
                    long long d, float eps, cudaStream_t stream) {
  auto k = rmsnorm_vec_warp_kernel<T, LPR, NV>;
  static const unsigned most = resident_grid(k, kVecThreads, 1LL << 30);
  const long long rows = (kVecThreads / 32) * (32 / LPR);  // a block at a time
  const long long need = (N + rows - 1) / rows;
  const unsigned grid = need < most ? (unsigned)need : most;
  k<<<grid, kVecThreads, 0, stream>>>((const T*)x, g, (T*)out, N, (int)d,
                                      eps);
  return (int)cudaGetLastError();
}

template <class T, int NV>
int launch_vec_block(const void* x, const float* g, void* out, long long N,
                     long long d, float eps, cudaStream_t stream) {
  auto k = rmsnorm_vec_block_kernel<T, NV>;
  static const unsigned most = resident_grid(k, kNormThreads, 1LL << 30);
  const unsigned grid = N < most ? (unsigned)N : most;
  k<<<grid, kNormThreads, 0, stream>>>((const T*)x, g, (T*)out, N, (int)d,
                                       eps);
  return (int)cudaGetLastError();
}

// The route is a function of d, the dtype and the pointers' alignment:
// 16 or fewer vectors a row: 16 lanes a row; up to 32 kWarpVecs: a warp a
// row; up to kNormThreads kBlockVecs: a block a row; else (or unaligned)
// the scalar route.
template <class T>
int launch_rmsnorm(const void* x, const float* g, void* out, long long N,
                   long long d, float eps, cudaStream_t stream) {
  const long long nvec = d / kVec<T>;
  const bool vec = d % kVec<T> == 0 &&
                   ((uintptr_t)x | (uintptr_t)g | (uintptr_t)out) % 16 == 0;
  if (vec && nvec <= 16)
    return launch_vec_warp<T, 16, 1>(x, g, out, N, d, eps, stream);
  if (vec && nvec <= 32 * kWarpVecs) {
    switch ((nvec + 31) / 32) {
#define RMS_WARP(n) \
  case n: return launch_vec_warp<T, 32, n>(x, g, out, N, d, eps, stream);
      RMS_WARP(1) RMS_WARP(2) RMS_WARP(3) RMS_WARP(4) RMS_WARP(5)
      RMS_WARP(6) RMS_WARP(7) RMS_WARP(8) RMS_WARP(9) RMS_WARP(10)
#undef RMS_WARP
    }
  }
  if (vec && nvec <= kNormThreads * kBlockVecs) {
    switch ((nvec + kNormThreads - 1) / kNormThreads) {
#define RMS_BLOCK(n) \
  case n: return launch_vec_block<T, n>(x, g, out, N, d, eps, stream);
      RMS_BLOCK(1) RMS_BLOCK(2) RMS_BLOCK(3) RMS_BLOCK(4) RMS_BLOCK(5)
      RMS_BLOCK(6) RMS_BLOCK(7) RMS_BLOCK(8)
#undef RMS_BLOCK
    }
  }
  if (d <= 1024) {
    const long long grid = (N + kNormWarps - 1) / kNormWarps;
    rmsnorm_warp_kernel<T><<<(unsigned)grid, kNormThreads, 0, stream>>>(
        (const T*)x, g, (T*)out, N, (int)d, eps);
  } else {
    rmsnorm_block_kernel<T><<<(unsigned)N, kNormThreads, 0, stream>>>(
        (const T*)x, g, (T*)out, (int)d, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int layer_rmsnorm(const void* x, const float* g, void* out, long long N,
                  long long d, float eps, int bf16, void* stream) {
  if (N < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_rmsnorm<__nv_bfloat16>(x, g, out, N, d, eps, s)
              : launch_rmsnorm<float>(x, g, out, N, d, eps, s);
}

}  // extern "C"
