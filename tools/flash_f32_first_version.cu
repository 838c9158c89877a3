// The first CUDA body of the float32 flash-attention kernel, kept as it
// stood before the kernel was redesigned (csrc/flash_f32.cu): one block of
// 256 threads per (batch*head, 64-row query tile), 64-key tiles loaded by
// scalar synchronous loads between block barriers, a thread's 4 x 4 score
// tile fed by scalar shared loads, the mask test on every score. It is not
// built into the port's library: tools/flash_f32_ablation.py builds it on
// its own so that one run times it beside the redesign. Entry point as it
// was (layer_flash_attention(args, bf16, stream)); it reads the FlashArgs
// fields it knew and ignores the plan.
//
// flash_attention, the CUDA-core kernel. It takes float32 inputs and the
// widths the tensor-core kernel (flash_wgmma.cu) does not: the route is
// flash_attention.py::tensor_core_route, a pure function of dtype, D and
// Dv (bf16 with D and Dv multiples of 16 up to 256 go to the tensor
// cores). One block per (batch*head, 64-row query tile), walking
// 64-key tiles through shared memory in float32 (q pre-scaled, as the
// Pallas kernel does `q * scale` before q k^T), with m, l and acc in
// registers: a thread owns 4 query rows x 4 keys of the score tile and the
// same 4 rows x Dv/16 columns of acc, so the row statistics never leave
// the thread's half-warp (shuffle reductions). Semantics are the
// reference's exactly: causal mask q_idx >= k_idx with no offset, masked
// scores -1e30, p = 0 where s <= -1e30 / 2, alpha = exp(m_prev - m_new),
// out = acc / max(l, 1e-20); expf, not __expf. Tiles wholly above the
// diagonal are skipped (they would change nothing), and the tiles with
// the most keys are scheduled first. Strides over (batch, head, row) and
// a KV-group factor let the GQA wrapper pass (B, T, H, D) and (B, S, KH,
// D) tensors in place, without repeating KV heads. What bounds it on this
// card: operations (4 T S D per head, half of it under the causal mask)
// on the CUDA cores in float32 (67 TFLOP/s). D and Dv up to 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_args.cuh"

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
// flash_attention
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kFlashThreads = 256; // 16 row groups x 16 column lanes
constexpr int kLdp = kBK + 1;      // padded row stride of the p tile
constexpr float kNegInf = -1e30f;  // the reference's mask value

template <class T, int kDvPer>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const FlashArgs a) {
  extern __shared__ float smem[];
  const int D = (int)a.D, Dv = (int)a.Dv, T_ = (int)a.T, S = (int)a.S;
  const int ldq = D + 1;               // padded: no bank conflicts on rows
  const int ldv = 16 * kDvPer;         // Dv rounded up; pad columns are 0
  float* qs = smem;                    // (kBQ, ldq) scaled q tile
  float* ks = qs + kBQ * ldq;          // (kBK, ldq) key tile
  float* vs = ks + kBK * ldq;          // (kBK, ldv) value tile
  float* ps = vs + kBK * ldv;          // (kBQ, kLdp) probability tile
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int nq = (T_ + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;   // longest tiles first
  const long long bh = blockIdx.y;
  const long long bb = bh / a.nh, hh = bh % a.nh, kh = hh / a.group;
  const T* q = (const T*)a.q + bb * a.q_sb + hh * a.q_sh;
  const T* k = (const T*)a.k + bb * a.k_sb + kh * a.k_sh;
  const T* v = (const T*)a.v + bb * a.v_sb + kh * a.v_sh;
  T* o = (T*)a.o + bb * a.o_sb + hh * a.o_sh;
  const float scale = (float)a.scale;
  const bool causal = a.causal != 0;

  for (int i = tid; i < kBQ * D; i += kFlashThreads) {
    const int r = i / D, c = i % D;
    qs[r * ldq + c] = q0 + r < T_
        ? __fmul_rn(to_f32(q[(q0 + r) * a.q_st + c]), scale) : 0.0f;
  }
  float m[4], l[4], acc[4][kDvPer];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kDvPer; ++j) acc[i][j] = 0.0f;
  }
  // keys past the last query row of the tile are all masked: skip them
  const int kend = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                   // the previous tile is consumed
    for (int i = tid; i < kBK * D; i += kFlashThreads) {
      const int r = i / D, c = i % D;
      ks[r * ldq + c] = k0 + r < S ? to_f32(k[(k0 + r) * a.k_ss + c]) : 0.0f;
    }
    for (int i = tid; i < kBK * ldv; i += kFlashThreads) {
      const int r = i / ldv, c = i % ldv;
      vs[i] = (k0 + r < S && c < Dv) ? to_f32(v[(k0 + r) * a.v_ss + c])
                                     : 0.0f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * ldq + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ldq + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= S || (causal && row < col)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)     // the row's 16 lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] <= kNegInf / 2 ? 0.0f : expf(s[i][j] - m_new);
        ps[(4 * ty + i) * kLdp + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o_);
      const float alpha = expf(m[i] - m_new);
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDvPer; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha);
    }
    __syncthreads();                   // the p tile is complete
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * kLdp + kk];
#pragma unroll
      for (int j = 0; j < kDvPer; ++j) {
        const float vv = vs[kk * ldv + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= T_) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < kDvPer; ++j) {
      const int col = tx + 16 * j;
      if (col < Dv)
        o[row * a.o_st + col] = from_f32<T>(__fdiv_rn(acc[i][j], den));
    }
  }
}

template <class T, int kDvPer>
int launch_flash_dv(const FlashArgs& a, cudaStream_t stream) {
  const long long ldq = a.D + 1, ldv = 16 * kDvPer;
  const long long bytes = 4 * (2 * kBK * ldq + kBK * ldv + kBQ * kLdp);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto k = flash_kernel<T, kDvPer>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((a.T + kBQ - 1) / kBQ), (unsigned)a.nbh);
  k<<<grid, kFlashThreads, (int)bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class T>
int launch_flash(const FlashArgs& a, cudaStream_t stream) {
  if (a.Dv <= 16) return launch_flash_dv<T, 1>(a, stream);
  if (a.Dv <= 32) return launch_flash_dv<T, 2>(a, stream);
  if (a.Dv <= 64) return launch_flash_dv<T, 4>(a, stream);
  if (a.Dv <= 128) return launch_flash_dv<T, 8>(a, stream);
  return launch_flash_dv<T, 16>(a, stream);
}

}  // namespace

extern "C" {

int layer_flash_attention(const FlashArgs* a, int bf16, void* stream) {
  if (a->nbh < 1 || a->T < 1 || a->S < 1 || a->D < 1 || a->D > 256 ||
      a->Dv < 1 || a->Dv > 256 || a->nh < 1 || a->group < 1 ||
      a->nh % a->group != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_flash<__nv_bfloat16>(*a, s) : launch_flash<float>(*a, s);
}

}  // extern "C"
