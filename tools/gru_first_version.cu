// The first CUDA body of gru_sequence, kept as it stood before the
// kernel was redesigned (csrc/gru_kernels.cu): a block of 256 threads owns
// 8 batch rows, a thread one of the 3H gate columns, x_t @ wx and h @ wh
// in one chain a tick, weights in shared memory when they fit. It is not
// built into the port's library: tools/gru_ablation.py builds it on its
// own so that one run times it beside the redesign. Entry point as it
// was (layer_gru_sequence(x, wx, wh, b, h0, hs, B, T, D, H, bf16,
// stream)).
//
// gru_sequence. On the TPU the grid walks T in order on one core with h in
// VMEM scratch. Here a block owns kGruRows batch rows and T is a loop
// inside it; h stays in shared memory in float32 for the whole sequence,
// and wx, wh sit in shared memory beside it when they fit (95 KB at the
// traffic AIP's D = 40, H = 64), else they are read through L2. A thread
// owns one of the 3H gate columns and computes both products x_t @ wx and
// h @ wh for all rows of the tile, so each weight is read once per tile
// per tick. What bounds it: the T dependent ticks, each two K-long FMA
// chains and two block barriers -- latency, far above both the bytes
// bound and the operations bound; more rows per card (batch) are free
// until the blocks fill the 132 SMs. The gates are gates.cuh's, shared
// with the IALS kernels, so the kernel differs from its plain version
// only in the order of the matrix-product sums. For bf16, hs is written
// in bf16 while h carries on in float32, as in the Pallas kernel.
//

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gates.cuh"

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

constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
// ---------------------------------------------------------------------------
// gru_sequence
// ---------------------------------------------------------------------------

constexpr int kGruRows = 8;        // batch rows per block
constexpr int kGruThreads = 256;

template <class T, bool kSmemW>
__global__ void __launch_bounds__(kGruThreads)
gru_sequence_kernel(const T* __restrict__ x, const float* __restrict__ wx,
                    const float* __restrict__ wh, const float* __restrict__ b,
                    const float* __restrict__ h0, T* __restrict__ hs, int B,
                    int T_, int D, int H) {
  extern __shared__ float smem[];
  const int G3 = 3 * H;
  const int row0 = blockIdx.x * kGruRows;
  const int nrows = min(kGruRows, B - row0);
  float* h = smem;                       // (kGruRows, H) float32 state
  float* xt = h + kGruRows * H;          // (kGruRows, D) this tick's input
  float* gx = xt + kGruRows * D;         // (kGruRows, 3H) x_t @ wx + b
  float* gh = gx + kGruRows * G3;        // (kGruRows, 3H) h @ wh
  const float* WX = wx;
  const float* WH = wh;
  if (kSmemW) {
    float* wxs = gh + kGruRows * G3;     // (D, 3H)
    float* whs = wxs + D * G3;           // (H, 3H)
    for (int i = threadIdx.x; i < D * G3; i += blockDim.x) wxs[i] = wx[i];
    for (int i = threadIdx.x; i < H * G3; i += blockDim.x) whs[i] = wh[i];
    WX = wxs;
    WH = whs;
  }
  for (int i = threadIdx.x; i < kGruRows * H; i += blockDim.x) {
    const int r = i / H;
    h[i] = r < nrows ? h0[(size_t)(row0 + r) * H + i % H] : 0.0f;
  }
  for (int t = 0; t < T_; ++t) {
    for (int i = threadIdx.x; i < kGruRows * D; i += blockDim.x) {
      const int r = i / D;
      xt[i] = r < nrows
          ? to_f32(x[((size_t)(row0 + r) * T_ + t) * D + i % D]) : 0.0f;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < G3; c += blockDim.x) {
      float ax[kGruRows], ah[kGruRows];
#pragma unroll
      for (int r = 0; r < kGruRows; ++r) ax[r] = ah[r] = 0.0f;
      for (int k = 0; k < D; ++k) {
        const float w = WX[k * G3 + c];
#pragma unroll
        for (int r = 0; r < kGruRows; ++r)
          ax[r] = fmaf(xt[r * D + k], w, ax[r]);
      }
      for (int k = 0; k < H; ++k) {
        const float w = WH[k * G3 + c];
#pragma unroll
        for (int r = 0; r < kGruRows; ++r)
          ah[r] = fmaf(h[r * H + k], w, ah[r]);
      }
      const float bc = b[c];
#pragma unroll
      for (int r = 0; r < kGruRows; ++r) {
        gx[r * G3 + c] = __fadd_rn(ax[r], bc);
        gh[r * G3 + c] = ah[r];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kGruRows * H; i += blockDim.x) {
      const int r = i / H, j = i % H;
      const float* gxr = gx + r * G3;
      const float* ghr = gh + r * G3;
      const float hn = gru_gate(gxr[j], gxr[H + j], gxr[2 * H + j], ghr[j],
                                ghr[H + j], ghr[2 * H + j], h[i]);
      h[i] = hn;
      if (r < nrows)
        hs[((size_t)(row0 + r) * T_ + t) * H + j] = from_f32<T>(hn);
    }
    __syncthreads();
  }
}

template <class T>
int launch_gru(const void* x, const float* wx, const float* wh,
               const float* b, const float* h0, void* hs, long long B,
               long long T_, long long D, long long H, cudaStream_t stream) {
  const long long G3 = 3 * H;
  const long long state = 4 * kGruRows * (H + D + 2 * G3);
  const long long weights = 4 * (D + H) * G3;
  if (state > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool in_smem = state + weights <= kMaxSmem;
  const int bytes = (int)(in_smem ? state + weights : state);
  auto k = in_smem ? &gru_sequence_kernel<T, true>
                   : &gru_sequence_kernel<T, false>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((B + kGruRows - 1) / kGruRows);
  k<<<grid, kGruThreads, bytes, stream>>>(
      (const T*)x, wx, wh, b, h0, (T*)hs, (int)B, (int)T_, (int)D, (int)H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int layer_gru_sequence(const void* x, const float* wx, const float* wh,
                       const float* b, const float* h0, void* hs, long long B,
                       long long T, long long D, long long H, int bf16,
                       void* stream) {
  if (B < 1 || T < 1 || D < 1 || H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_gru<__nv_bfloat16>(x, wx, wh, b, h0, hs, B, T, D, H, s)
              : launch_gru<float>(x, wx, wh, b, h0, hs, B, T, D, H, s);
}

}  // extern "C"
