// Hand-written Hopper (sm_90a) kernel: the flash-attention forward on the
// CUDA cores in float32, the counterpart of the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (and, through
// strides, the GQA wrapper kernels/ops.py::flash_attention_mha) for
// float32 inputs and for bf16 at head widths off the tensor-core kernel's
// steps of 16 (flash_wgmma.cu takes the rest; the route is
// flash_attention.py::tensor_core_route).
//
//   layer_flash_attention <- flash_attention.py::flash_attention
//
// Plain C entry point bound with ctypes in repro_torch/kernels/
// flash_attention.py; it launches on the caller's stream by the plan of
// flash_attention.py::f32_plan (the FlashArgs f32_* fields) and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan or shape it does
// not take (it never adapts one).
//
// What bounds it on this card: operations, 4 T S D per head (half of them
// under the causal mask) at the CUDA cores' float32 rate (67 TFLOP/s). The
// design keeps the FMA pipes, not the shared-memory pipe or the copies,
// the limit:
//  - A block owns 128 query rows and walks key tiles of 64 with 8 warps
//    of 16 rows (f32_plan; 64 rows, 32-key tiles and 8 warps of 8 rows
//    above D or Dv = 128, or where 128-row blocks would leave SMs idle,
//    two blocks an SM). A warp owns its rows, so the probabilities it
//    writes to shared memory are read back by that warp alone
//    (__syncwarp), and a tile needs one block barrier.
//  - A lane owns a register tile of 8 rows x 4 keys of the scores (4 x 2
//    in 64-row blocks) and the same rows x Dv/16 columns of the output.
//    q k^T runs over d in 16-byte vectors: per 4 d-steps 8 vector loads
//    of q (two rows a warp, one wavefront each) and 4 of k (16 rows, two
//    wavefronts) feed 128 FMAs, 8 warp FMAs a wavefront; p v per key: two
//    vector loads of p (one wavefront each) and Dv/64 of v (two each)
//    feed 8 Dv/16 FMAs, 10.7 at Dv = 128. Tiles sit row-major in shared
//    memory with a row stride of an odd number of 16-byte vectors, so the
//    rows a load touches fall on distinct banks; a warp's rows interleave
//    its two row groups.
//  - K and V tiles come through a ring of 2 or 3 stages by cp.async (16
//    bytes, zero-filled past S): the copy of tile t + stages - 1 is issued
//    after tile t's barrier and runs under tile t's products. A copy that
//    cannot run asynchronously (bf16, converted to float32 on the way; a
//    width or stride off 16 bytes; a misaligned view) is staged by plain
//    loads in the same place of the ring: never another kernel.
//  - The mask test runs on the tiles that cross the diagonal or S only;
//    tiles wholly above the diagonal are skipped, and so is a warp whose
//    rows all lie above a tile. Blocks with the most tiles start first.
//  - Registers hold m, l and the output; the row statistics stay within
//    a row group's 16 lanes (shuffle reductions in a fixed order).
// Semantics are the reference's: q scaled before q k^T with __fmul_rn (as
// the Pallas kernel does), causal mask q_idx >= k_idx with no offset,
// masked scores -1e30 with p = 0 under them, alpha = exp(m_prev - m_new),
// l = l alpha + sum p, out = acc / max(l, 1e-20) rounded once to q's
// dtype. The exponentials are __expf, faster than expf:
// tools/flash_f32_ablation.py times both and holds the kernel within 2e-5
// of the plain version at every float32 case of chip_smoke.py. Strides
// over (batch, head, row) and a KV-group factor let the GQA wrapper pass
// (B, T, H, D) and (B, S, KH, D) tensors in place. D and Dv up to 256.
//
// Ablation builds (tools/flash_f32_ablation.py): FLASH_F32_SCALAR_LOADS
// (the tiles read by scalar shared loads), FLASH_F32_SYNC_LOADS (plain
// loads for every copy), FLASH_F32_MASK_ALWAYS (the mask test on every
// tile), FLASH_F32_EXPF (expf), FLASH_F32_NO_PRODUCTS (both products
// taken out: the floor), FLASH_F32_TIMELINE (clock64 sums per phase of
// warp 0 of each block, written to FlashArgs::marks) and FLASH_F32_WARPS16
// (also 128 rows on 16 warps, a lane 4 x 4 scores: slower, and it spills).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_args.cuh"

namespace {

constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kChunk = 32;         // keys of the p tile a warp writes at once
constexpr int kMarks = 8;          // timeline phases

#ifdef FLASH_F32_EXPF
#define FLASH_EXP expf
#else
#define FLASH_EXP __expf
#endif

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

// Row stride (floats) of a q or k tile: D in whole 16-byte vectors, made
// an odd number of them (flash_attention.py::qk_stride)
__host__ __device__ inline int qk_stride(int D) {
  const int s = (D + 3) & ~3;
  return (s / 4) % 2 ? s : s + 4;
}

// Dynamic shared bytes: the q tile, the ring of (K tile, V tile) stages
// and the p chunk (flash_attention.py::f32_smem)
__host__ __device__ inline long long f32_smem_bytes(int BQ, int BK, int DVP,
                                                    int D, int NS) {
  const long long ld = qk_stride(D);
  return 4LL * (BQ * ld + NS * (BK * ld + (long long)BK * DVP) +
                kChunk * (BQ + 4));
}

// four consecutive floats of a tile (16-byte aligned)
__device__ __forceinline__ float4 lds4(const float* p) {
#ifdef FLASH_F32_SCALAR_LOADS
  float4 r;
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(r.x) : "r"(a));
  asm volatile("ld.shared.f32 %0, [%1+4];" : "=f"(r.y) : "r"(a));
  asm volatile("ld.shared.f32 %0, [%1+8];" : "=f"(r.z) : "r"(a));
  asm volatile("ld.shared.f32 %0, [%1+12];" : "=f"(r.w) : "r"(a));
  return r;
#else
  return *reinterpret_cast<const float4*>(p);
#endif
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [r0, r0 + n) of a row-major global matrix (row stride ld_g
// elements, `width` columns, `valid` rows) into shared rows of stride ld_s
// floats: by cp.async (float32, 16-byte rows; rows past `valid` zero-
// filled) or by plain loads (converted to float32; zeros past `valid` and
// in the columns [width, wpad)).
template <class T, int NT>
__device__ __forceinline__ void stage_rows(float* dst, int ld_s,
                                           const T* src, long long ld_g,
                                           int r0, int n, int valid,
                                           int width, int wpad, bool async) {
  if (async) {
    const int vecs = width / 4;
    // a thread keeps one 16-byte column and walks rows NT / vecs apart
    // where the rows divide the block; else it walks the vectors
    if (NT % vecs == 0) {
      const int c = threadIdx.x % vecs;
      for (int r = threadIdx.x / vecs; r < n; r += NT / vecs) {
        const bool ok = r0 + r < valid;
        cp_async16(dst + r * ld_s + 4 * c,
                   ok ? static_cast<const void*>(src + (r0 + r) * ld_g + 4 * c)
                      : static_cast<const void*>(src),
                   ok);
      }
    } else {
      for (int i = threadIdx.x; i < n * vecs; i += NT) {
        const int r = i / vecs, c = i - r * vecs;
        const bool ok = r0 + r < valid;
        cp_async16(dst + r * ld_s + 4 * c,
                   ok ? static_cast<const void*>(src + (r0 + r) * ld_g +
                                                 4 * c)
                      : static_cast<const void*>(src),
                   ok);
      }
    }
  } else {
    for (int i = threadIdx.x; i < n * wpad; i += NT) {
      const int r = i / wpad, c = i - r * wpad;
      dst[r * ld_s + c] = r0 + r < valid && c < width
                              ? to_f32(src[(r0 + r) * ld_g + c]) : 0.0f;
    }
  }
}

#ifdef FLASH_F32_TIMELINE
#define FLASH_MARK(i)                   \
  do {                                  \
    if (threadIdx.x == 0) {             \
      const long long now_ = clock64(); \
      tl_sum[i] += now_ - tl_last;      \
      tl_last = now_;                   \
    }                                   \
  } while (0)
#else
#define FLASH_MARK(i) \
  do {                \
  } while (0)
#endif

// One block: BQ query rows of one (batch, head), NT threads (NT / 32 warps
// of BQ / (NT / 32) rows), key tiles of BK, Dv padded to DVP = 64 VV.
template <class T, int BQ, int BK, int NT, int VV>
__global__ void __launch_bounds__(NT, BQ == 64 ? 2 : 1)
flash_f32_kernel(const FlashArgs a, int async) {
  constexpr int NW = NT / 32;       // warps
  constexpr int WR = BQ / NW;       // rows of a warp
  constexpr int TR = WR / 2;        // rows of a lane: two row groups a warp
  constexpr int TK = BK / 16;       // keys of a lane: 16 column groups
  constexpr int TV = 4 * VV;        // output columns of a lane
  constexpr int DVP = 64 * VV;
  constexpr int ldp = BQ + 4;       // row stride of the p chunk
  static_assert(TR % 4 == 0 && TK % 2 == 0 && BK % kChunk == 0, "tile");
  extern __shared__ __align__(16) float smem[];
#ifdef FLASH_F32_TIMELINE
  long long tl_sum[kMarks] = {};
  long long tl_last = clock64();
#endif
  const int D = (int)a.D, Dv = (int)a.Dv, T_ = (int)a.T, S = (int)a.S;
  const int NS = (int)a.f32_stages;
  const int D4 = (D + 3) / 4, ldq = qk_stride(D);
  const int stage = BK * ldq + BK * DVP;   // floats of one ring stage
  float* qs = smem;                         // (BQ, ldq) scaled q
  float* ring = qs + BQ * ldq;              // NS x [(BK, ldq) k, (BK, DVP) v]
  float* ps = ring + NS * stage;            // (kChunk, ldp) p, key-major
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / 16, cg = lane % 16;
  const int nq = (T_ + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.y) * BQ;   // most tiles first
  const long long bh = blockIdx.x;
  const long long bb = bh / a.nh, hh = bh % a.nh, kh = hh / a.group;
  const T* q = (const T*)a.q + bb * a.q_sb + hh * a.q_sh;
  const T* k = (const T*)a.k + bb * a.k_sb + kh * a.k_sh;
  const T* v = (const T*)a.v + bb * a.v_sb + kh * a.v_sh;
  T* o = (T*)a.o + bb * a.o_sb + hh * a.o_sh;
  const bool causal = a.causal != 0;
  // keys past the block's last row are all masked: those tiles are skipped
  const int kend = causal ? min(S, q0 + BQ) : S;
  const int ntiles = (kend + BK - 1) / BK;
  // the lane's rows: wrow0 + rg + 2 ii (ii < TR); its p slots slot0 + ii
  const int wrow0 = warp * WR;
  const int slot0 = wrow0 + rg * TR;

  auto stage_tile = [&](int t) {
    float* ks = ring + (t % NS) * stage;
    stage_rows<T, NT>(ks, ldq, k, a.k_ss, t * BK, BK, S, D, 4 * D4,
                      async != 0);
    stage_rows<T, NT>(ks + BK * ldq, DVP, v, a.v_ss, t * BK, BK, S, Dv, DVP,
                      async != 0);
  };
  // the copies write v's columns [0, Dv) only: the pad columns are zero
  if (async && Dv < DVP)
    for (int i = tid; i < NS * BK * DVP; i += NT) {
      const int c = i % DVP;
      if (c >= Dv) ring[(i / (BK * DVP)) * stage + BK * ldq + i % (BK * DVP)]
          = 0.0f;
    }
  for (int t = 0; t < NS - 1; ++t) {
    if (t < ntiles) stage_tile(t);
    cp_async_commit();
  }
  const float scale = (float)a.scale;
  for (int i = tid; i < BQ * 4 * D4; i += NT) {
    const int r = i / (4 * D4), c = i - r * (4 * D4);
    qs[r * ldq + c] = q0 + r < T_ && c < D
        ? __fmul_rn(to_f32(q[(q0 + r) * a.q_st + c]), scale) : 0.0f;
  }
  float m[TR], l[TR], acc[TR][TV];
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < TV; ++j) acc[i][j] = 0.0f;
  }
  FLASH_MARK(7);

  for (int t = 0; t < ntiles; ++t) {
    // tile t has landed (this thread's copies), then the barrier: every
    // thread's copies are visible and tile t - 1 is consumed, so its
    // stage takes the copy of tile t + NS - 1
    if (NS == 3) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    FLASH_MARK(0);
    if (t + NS - 1 < ntiles) stage_tile(t + NS - 1);
    cp_async_commit();
    FLASH_MARK(1);
    const int k0 = t * BK;
    // a warp whose rows all lie above this tile's first key: every p is 0
    if (causal && k0 > q0 + wrow0 + WR - 1) continue;
    const float* ks = ring + (t % NS) * stage;
    const float* vs = ks + BK * ldq;

    // s = q k^T over d in 16-byte vectors, d in order
    float s[TR][TK];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < TK; ++j) s[i][j] = 0.0f;
#ifndef FLASH_F32_NO_PRODUCTS
    const float* qrow = qs + (wrow0 + rg) * ldq;
    const float* krow = ks + cg * ldq;
#pragma unroll 8
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 kv[TK];
#pragma unroll
      for (int j = 0; j < TK; ++j) kv[j] = lds4(krow + 16 * j * ldq + 4 * d4);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float4 qv = lds4(qrow + 2 * i * ldq + 4 * d4);
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
#endif
    FLASH_MARK(2);

    // the mask, on a tile that crosses the diagonal or S only; the online
    // softmax over the row's 16 lanes
#ifdef FLASH_F32_MASK_ALWAYS
    const bool edge = true;
#else
    const bool edge = (causal && k0 + BK - 1 > q0) || k0 + BK > S;
#endif
    if (edge) {
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int row = q0 + wrow0 + rg + 2 * i;
#pragma unroll
        for (int j = 0; j < TK; ++j) {
          const int col = k0 + cg + 16 * j;
          if (col >= S || (causal && row < col)) s[i][j] = kNegInf;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < TR; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < TK; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
      const float m_new = fmaxf(m[i], mx);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < TK; ++j) {
        const float p = edge && s[i][j] <= kNegInf / 2
                            ? 0.0f : FLASH_EXP(s[i][j] - m_new);
        s[i][j] = p;
        psum += p;
      }
#pragma unroll
      for (int o_ = 8; o_ > 0; o_ >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, o_);
      const float alpha = FLASH_EXP(m[i] - m_new);
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < TV; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha);
    }
    FLASH_MARK(3);

    // o += p v, kChunk keys at a time through the warp's p slots
#pragma unroll
    for (int c = 0; c < TK / 2; ++c) {
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < TR; i += 4)
          *reinterpret_cast<float4*>(ps + (cg + 16 * h) * ldp + slot0 + i) =
              make_float4(s[i][2 * c + h], s[i + 1][2 * c + h],
                          s[i + 2][2 * c + h], s[i + 3][2 * c + h]);
      __syncwarp();
#ifndef FLASH_F32_NO_PRODUCTS
      const float* vrow = vs + c * kChunk * DVP + 4 * cg;
#pragma unroll 8
      for (int kk = 0; kk < kChunk; ++kk) {
        float pv[TR];
#pragma unroll
        for (int i = 0; i < TR; i += 4) {
          const float4 x = lds4(ps + kk * ldp + slot0 + i);
          pv[i] = x.x;
          pv[i + 1] = x.y;
          pv[i + 2] = x.z;
          pv[i + 3] = x.w;
        }
#pragma unroll
        for (int u = 0; u < VV; ++u) {
          const float4 x = lds4(vrow + kk * DVP + 64 * u);
#pragma unroll
          for (int i = 0; i < TR; ++i) {
            acc[i][4 * u] = fmaf(pv[i], x.x, acc[i][4 * u]);
            acc[i][4 * u + 1] = fmaf(pv[i], x.y, acc[i][4 * u + 1]);
            acc[i][4 * u + 2] = fmaf(pv[i], x.z, acc[i][4 * u + 2]);
            acc[i][4 * u + 3] = fmaf(pv[i], x.w, acc[i][4 * u + 3]);
          }
        }
      }
#endif
    }
    FLASH_MARK(4);
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int row = q0 + wrow0 + rg + 2 * i;
    if (row >= T_) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int u = 0; u < VV; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * cg + 64 * u + e;
        if (col < Dv)
          o[row * a.o_st + col] = from_f32<T>(__fdiv_rn(acc[i][4 * u + e],
                                                        den));
      }
  }
#ifdef FLASH_F32_TIMELINE
  FLASH_MARK(5);
  if (threadIdx.x == 0 && a.marks != nullptr) {
    long long* out = static_cast<long long*>(a.marks) +
        ((long long)blockIdx.y * gridDim.x + blockIdx.x) * kMarks;
    for (int i = 0; i < kMarks; ++i) out[i] = tl_sum[i];
  }
#endif
}

bool aligned16(const void* p, long long sb, long long sh, long long sr) {
  return ((uintptr_t)p % 16 == 0) && sb % 4 == 0 && sh % 4 == 0 &&
         sr % 4 == 0;
}

template <class T, int BQ, int BK, int NT, int VV>
int launch_cfg(const FlashArgs& a, cudaStream_t stream) {
  const long long smem =
      f32_smem_bytes(BQ, BK, 64 * VV, (int)a.D, (int)a.f32_stages);
  if (smem != a.f32_smem || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  auto k = flash_f32_kernel<T, BQ, BK, NT, VV>;
  static int raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || smem > raised[dev]) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev] = (int)smem;
  }
  // cp.async moves whole 16-byte float32 vectors: widths, strides and
  // bases in 16-byte steps; anything else is staged by plain loads
#ifdef FLASH_F32_SYNC_LOADS
  const bool async = false;
#else
  const bool async = sizeof(T) == 4 && a.D % 4 == 0 && a.Dv % 4 == 0 &&
                     aligned16(a.k, a.k_sb, a.k_sh, a.k_ss) &&
                     aligned16(a.v, a.v_sb, a.v_sh, a.v_ss);
#endif
  const long long nq = (a.T + BQ - 1) / BQ;
  if (nq > 65535) return (int)cudaErrorInvalidValue;   // the grid's y
  const dim3 grid((unsigned)a.nbh, (unsigned)nq);
  k<<<grid, NT, (size_t)smem, stream>>>(a, (int)async);
  return (int)cudaGetLastError();
}

template <class T, int BQ, int BK, int NT, int MAXVV>
int launch_vv(const FlashArgs& a, cudaStream_t s) {
  switch ((a.Dv + 63) / 64) {
    case 1: return launch_cfg<T, BQ, BK, NT, 1>(a, s);
    case 2: return launch_cfg<T, BQ, BK, NT, 2>(a, s);
    case 3:
      if constexpr (MAXVV >= 3) return launch_cfg<T, BQ, BK, NT, 3>(a, s);
      break;
    case 4:
      if constexpr (MAXVV >= 4) return launch_cfg<T, BQ, BK, NT, 4>(a, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// The plans f32_plan gives (F32_CONFIGS there): (rows, keys, threads);
// FLASH_F32_WARPS16 builds 128 rows on 512 threads too (the ablation)
template <class T>
int launch_plan(const FlashArgs& a, cudaStream_t s) {
  const long long r = a.f32_rows, kk = a.f32_keys, nt = a.f32_threads;
  if (a.f32_stages < 2 || a.f32_stages > 3) return (int)cudaErrorInvalidValue;
#ifdef FLASH_F32_WARPS16
  if (r == 128 && kk == 64 && nt == 512)
    return launch_vv<T, 128, 64, 512, 2>(a, s);
#endif
  if (r == 128 && kk == 64 && nt == 256)
    return launch_vv<T, 128, 64, 256, 2>(a, s);
  if (r == 64 && kk == 32 && nt == 256)
    return launch_vv<T, 64, 32, 256, 4>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int layer_flash_attention(const FlashArgs* a, int bf16, void* stream) {
  if (a->nbh < 1 || a->T < 1 || a->S < 1 || a->D < 1 || a->D > 256 ||
      a->Dv < 1 || a->Dv > 256 || a->nh < 1 || a->group < 1 ||
      a->nh % a->group != 0 || a->nbh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_plan<__nv_bfloat16>(*a, s) : launch_plan<float>(*a, s);
}

int layer_flash_args_size(void) { return (int)sizeof(FlashArgs); }

}  // extern "C"
