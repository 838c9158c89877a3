// The first CUDA body of aip_step (one GRU AIP tick), kept as it stood
// before the tick moved onto the horizon kernel's GRU role
// (csrc/ials_kernels.cu::step_kernel): one block of 128 threads per 16
// lanes of one agent, all state in shared memory, each small GEMM giving a
// thread one output column and reading every weight with __ldg inside its
// K loop, so each k-step waits on L2. It is not built into the port's
// library: tools/rollout_ablation.py builds it on its own so that one run
// times it beside the redesign. Entry point as it was
// (ials_aip_step(args, stream)); it reads the IalsArgs fields it knew and
// ignores the launch plan.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gates.cuh"
#include "ials_args.cuh"

namespace {

constexpr int kThreads = 128;   // threads per block
constexpr int kRows = 16;       // simulation lanes per block (one agent)


// numerics shared with repro_torch/nn/act.py: fast_tanh, fast_sigmoid and
// the GRU gate update live in gates.cuh

__device__ __forceinline__ float uniform_from_bits(int bits) {
  return (float)(((uint32_t)bits) >> 8) * (1.0f / 16777216.0f);
}

enum Act { kNone = 0, kRelu = 1, kFastTanh = 2, kTanh = 3 };

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.0f);
    case kFastTanh: return fast_tanh(v);
    case kTanh: return tanhf(v);
    default: return v;
  }
}

// y[r][c] = act(sum_k x[r][k] * W[k][c] (+ bias[c])) for the kRows rows of
// the tile. x, y in shared memory (row strides ldx, ldy); W (K, N) and
// bias in global memory. A thread owns one column and R rows: it loads
// each weight once and applies it to its R rows.
template <int R>
__device__ void gemm_rows(const float* x, int ldx, const float* __restrict__ W,
                          const float* __restrict__ bias, int K, int N,
                          float* y, int ldy, int act) {
  constexpr int G = kRows / R;
  for (int item = threadIdx.x; item < N * G; item += blockDim.x) {
    const int c = item % N;
    const int g = item / N;
    const float* xr = x + g * R * ldx;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float w = __ldg(W + (size_t)k * N + c);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(xr[r * ldx + k], w, acc[r]);
    }
    const float bb = bias != nullptr ? __ldg(bias + c) : 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = bias != nullptr ? __fadd_rn(acc[r], bb) : acc[r];
      y[(g * R + r) * ldy + c] = activate(v, act);
    }
  }
}

__device__ void gemm(const float* x, int ldx, const float* W,
                     const float* bias, int K, int N, float* y, int ldy,
                     int act) {
  const int groups = kThreads / N;   // row groups that fit the block
  if (groups >= 16) gemm_rows<1>(x, ldx, W, bias, K, N, y, ldy, act);
  else if (groups >= 8) gemm_rows<2>(x, ldx, W, bias, K, N, y, ldy, act);
  else if (groups >= 4) gemm_rows<4>(x, ldx, W, bias, K, N, y, ldy, act);
  else if (groups >= 2) gemm_rows<8>(x, ldx, W, bias, K, N, y, ldy, act);
  else gemm_rows<16>(x, ldx, W, bias, K, N, y, ldy, act);
}

// ---------------------------------------------------------------------------
// The GRU AIP cell of the first body (aip_step.py::_gru_cell) on the tile
// in shared memory: d (kRows, D) -> h update, u (kRows, M). The caller
// has synchronised d; the cell ends synchronised.
// ---------------------------------------------------------------------------

struct Scratch {        // regions of the dynamic shared buffer
  float* h;             // AIP state
  float* c1;            // gx
  float* c2;            // gh
  float* d;
  float* logits;
  float* u;
};

__device__ void sample_u(const IalsArgs& p, Scratch& sc, const int* bits_row0,
                         int nvalid, long long bits_stride) {
  const int M = (int)p.M;
  for (int i = threadIdx.x; i < kRows * M; i += blockDim.x) {
    const int r = i / M, m = i % M;
    float u = 0.0f;
    if (r < nvalid) {
      const float pr = fast_sigmoid(sc.logits[i]);
      u = uniform_from_bits(bits_row0[r * bits_stride + m]) < pr ? 1.0f : 0.0f;
    }
    sc.u[i] = u;
  }
}

struct GruCell {
  // aw = wx (A, D, 3H), wh (A, H, 3H), b (A, 3H), hw (A, H, M), hb (A, M)
  static __device__ void step(const IalsArgs& p, int agent, Scratch& sc,
                              const int* bits_row0, int nvalid,
                              long long bits_stride) {
    const int D = (int)p.D, H = (int)p.H, M = (int)p.M, G3 = 3 * H;
    const float* wx = p.aw[0] + (size_t)agent * D * G3;
    const float* wh = p.aw[1] + (size_t)agent * H * G3;
    const float* b = p.aw[2] + (size_t)agent * G3;
    const float* hw = p.aw[3] + (size_t)agent * H * M;
    const float* hb = p.aw[4] + (size_t)agent * M;
    float* h = sc.h;
    gemm(sc.d, D, wx, b, D, G3, sc.c1, G3, kNone);     // gx = d @ wx + b
    gemm(h, H, wh, nullptr, H, G3, sc.c2, G3, kNone);  // gh = h @ wh
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
      const int r = i / H, j = i % H;
      const float* gx = sc.c1 + r * G3;
      const float* gh = sc.c2 + r * G3;
      h[i] = gru_gate(gx[j], gx[H + j], gx[2 * H + j], gh[j], gh[H + j],
                      gh[2 * H + j], h[i]);
    }
    __syncthreads();
    gemm(h, H, hw, hb, H, M, sc.logits, M, kNone);
    __syncthreads();
    sample_u(p, sc, bits_row0, nvalid, bits_stride);
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// shared-memory layout of a rollout block
// ---------------------------------------------------------------------------

struct Layout {
  int s0, c1, c2, d, logits, u;               // GRU AIP state and scratch
  int ints;                                   // int region (LS state, a)
  int total_bytes;
};

Layout make_layout(const IalsArgs& p) {
  Layout l{};
  const int R = kRows;
  const int c = 3 * (int)p.H;
  int off = 0;
  auto take = [&](int n) { int o = off; off += n; return o; };
  l.s0 = take(R * (int)p.H);
  l.c1 = take(R * c);
  l.c2 = take(R * c);
  l.d = take(R * (int)p.D);
  l.logits = take(R * (int)p.M);
  l.u = take(R * (int)p.M);
  l.ints = off;
  const int n_ints = R * (5 + 2);   // the traffic LS's 5 state ints
  l.total_bytes = (off + n_ints) * (int)sizeof(float);
  return l;
}

// ---------------------------------------------------------------------------
// one fused GRU AIP tick (aip_step.py::_aip_step_kernel): grid (row tiles,
// agents); d (B, A, D), h (B, A, H), bits (B, A, M), stacked weights.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
aip_step_kernel(IalsArgs p, Layout lay) {
  extern __shared__ float smem[];
  const int agent = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const long long left = p.B - b0;
  const int nvalid = left < kRows ? (int)left : kRows;
  const int A = (int)p.A, D = (int)p.D, H = (int)p.H, M = (int)p.M;
  Scratch sc{smem + lay.s0, smem + lay.c1, smem + lay.c2, smem + lay.d,
             smem + lay.logits, smem + lay.u};
  for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
    const int r = i / D;
    sc.d[i] = r < nvalid ? p.d[((long long)(b0 + r) * A + agent) * D + i % D]
                         : 0.0f;
  }
  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    const int r = i / H;
    sc.h[i] = r < nvalid
                     ? p.h[((long long)(b0 + r) * A + agent) * H + i % H]
                     : 0.0f;
  }
  __syncthreads();
  GruCell::step(p, agent, sc, p.bits + ((long long)b0 * A + agent) * M,
                nvalid, (long long)A * M);
  for (int i = threadIdx.x; i < nvalid * H; i += blockDim.x) {
    const int r = i / H;
    p.h2[((long long)(b0 + r) * A + agent) * H + i % H] = sc.h[i];
  }
  for (int i = threadIdx.x; i < nvalid * M; i += blockDim.x) {
    const int r = i / M;
    const long long o = ((long long)(b0 + r) * A + agent) * M + i % M;
    p.logits[o] = sc.logits[i];
    p.u[o] = sc.u[i];
  }
}

}  // namespace

extern "C" {

int ials_aip_step(const IalsArgs* args, void* stream) {
  const Layout lay = make_layout(*args);
  cudaError_t e = cudaFuncSetAttribute(
      aip_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.total_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((args->B + kRows - 1) / kRows), (unsigned)args->A);
  aip_step_kernel<<<grid, kThreads, lay.total_bytes, (cudaStream_t)stream>>>(
      *args, lay);
  return (int)cudaGetLastError();
}

}  // extern "C"
