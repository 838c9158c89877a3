// Hand-written Hopper (sm_90a) kernels of the serving tier: the CUDA
// counterparts of the two serving Pallas TPU kernels in
// src/repro/kernels/aip_step.py.
//
//   ials_serve_forward       <- aip_step.py::serve_forward (masked slot)
//   ials_serve_forward_multi <- aip_step.py::serve_forward_multi (N policies)
//
// What they compute (aip_step.py::_serve_forward_kernel and
// _serve_forward_multi_kernel over _policy_cell): frames (B, S) f32 with
// the slot's B lanes, mask (B,), pidx (B,) or null, weights stacked over
// n_pol policies (w1 (N, S, Hp), b1 (N, Hp), w2 (N, Hp, Hp), b2 (N, Hp),
// the fused [pi|v] head (N, Hp, n_act + 1) and its bias) -> logits_out
// (B, n_act), v_out (B,): gate(x @ w1 + b1), gate(h @ w2 + b2), then the
// head; lanes that are masked off or whose pidx lies outside [0, N) are
// written exactly 0.0 here, inside the kernel.
//
// Bound. 2*(S*Hp + Hp*Hp + Hp*(n_act+1)) FLOPs a routed lane (44,032 at
// the traffic widths S = 41, Hp = 128, two actions): at a 128-lane slot
// the bound is ~0.1 us of operations or bytes, far below one launch. What
// costs the time is latency: every output is one dependent chain of S +
// Hp + Hp fmaf steps. The first version (one block per 16 lanes, weights
// read with __ldg inside that chain, the policies of a tile run one after
// another) waited on L2 at every step, on 8 of 132 SMs.
//
// Design.
//  - Weights in shared memory, staged by bulk asynchronous copies: [w1;
//    w2] of one policy is read as one stream of D + Hp rows of Hp floats,
//    cut into K-chunks of serve_chunk_rows rows (at most 32 KB) that
//    cycle through a ring of serve_stages buffers, each completing on an
//    mbarrier; one thread of the last warp issues every copy
//    (cp.async.bulk, no tensor map: a run of rows of a row-major matrix
//    is contiguous). At the traffic widths every chunk fits, so the whole
//    policy is in flight before the first FMA and layer 2's chunks land
//    while layer 1 computes; at the warehouse widths beside a 32-lane
//    tile (w1 alone is 148 KB) the ring refills a stage as soon as every
//    thread is done with it. The head (Hp x (n_act+1)) has a buffer and
//    barrier of its own. A piece that is not 16-byte aligned and sized
//    (rows whose width is not a multiple of 4 floats, an unaligned base)
//    is staged by plain loads instead: serve_flags says which.
//  - A grid that fills the SMs: a tile is serve_lanes lanes (2-32, about
//    64 tiles a slot), so a 128-lane slot makes 64 blocks a policy;
//    large slots take 32 lanes a tile, so each block stages its weights
//    once for many lanes.
//  - One block per (lane tile, policy) while that grid fits one wave of
//    the card: the grid's y axis is the policy. Block (t, n) compacts the
//    lanes of tile t that route to n with one warp's ballot and runs the
//    three products over those rows only; block (t, 0) writes the zeros
//    of the tile's masked and unroutable lanes. With no lane routed to n,
//    a block returns before it stages anything. With one policy
//    (serve_forward) every block stages at its start, before it reads
//    its lanes. A block walks policies n, n + gridDim.y, ...: past one
//    wave (4096 lanes, 4 policies) the plan gives each tile one block
//    that walks them all.
//  - A thread owns a register tile of serve_rows_per_thread rows (up to
//    8) by serve_cols_per_thread consecutive columns: one column unless
//    the block would need more than 512 threads. At each k, one vector
//    load of W[k][c0..] from shared memory (consecutive threads on
//    consecutive banks) and one of the activations, stored transposed
//    (k-major) so a thread's rows are consecutive (a broadcast to the
//    warp). More warps hide more of the loads' latency: one column a
//    thread beat four on the card.
// Where the time goes now (tools/serve_ablation.py, clock64 marks inside
// the kernel, traffic S = 128): the tile's mask, frames and first chunk
// arrive, then each step of a chain costs ~30 cycles of shared-load
// latency; the weights' bytes are not the limit.
// Bitwise contracts (docs/ARCHITECTURE.md §8): every output is one
// sequential fmaf chain over k = 0 .. K-1 from 0.0, then __fadd_rn(acc,
// bias), then the gate -- the order of ials_kernels.cu's gemm_rows, which
// the first version of this kernel used -- whatever the row, tile, chunk
// or policy count. So a lane's outputs are bitwise independent of the
// other lanes (pad contents, position), bitwise the single-policy launch's
// for its own checkpoint, and bitwise the first version's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gates.cuh"
#include "ials_args.cuh"
#include "smem.cuh"

namespace {

constexpr int kMaxLanes = 32;      // lanes per tile: one warp's ballot
constexpr int kMaxThreads = 512;
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr int kMaxDevices = 64;
constexpr int kRingBulk = 1;       // serve_flags bits
constexpr int kHeadBulk = 2;

enum Gate { kFastTanh = 0, kTanh = 1 };

__device__ __forceinline__ float gate_of(float v, int gate) {
  return gate == kFastTanh ? fast_tanh(v) : tanhf(v);
}

__device__ __forceinline__ int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// The block's dynamic shared memory, in the order and sizes of
// aip_step.py::serve_plan (each region rounded up to 16 bytes).
struct ServeSmem {
  uint64_t* bar;   // ring stages, then the head
  int* lane;       // the tile's compacted lanes, then their count
  float* ring;     // stages x chunk_rows x Hp
  float* head;     // Hp x NH
  float* xraw;     // R x (D | 1): the tile's frames, rows padded to an odd
                   // stride so a gather down a column meets no conflict
  float* xT;       // D x R, k-major: the routed lanes' frames, compacted
  float* h1T;      // Hp x R
  float* h2T;      // Hp x R
  int bytes;
};

__device__ __forceinline__ ServeSmem serve_smem(unsigned char* base, int R,
                                                int D, int Hp, int NH,
                                                int kc, int ns) {
  ServeSmem m;
  int off = 0;
  auto take = [&](int bytes) {
    unsigned char* p = base + off;
    off += round16(bytes);
    return p;
  };
  m.bar = reinterpret_cast<uint64_t*>(take(8 * (ns + 1)));
  m.lane = reinterpret_cast<int*>(take(4 * (R + 1)));
  m.ring = reinterpret_cast<float*>(take(4 * ns * kc * Hp));
  m.head = reinterpret_cast<float*>(take(4 * Hp * NH));
  m.xraw = reinterpret_cast<float*>(take(4 * (D | 1) * R));
  m.xT = reinterpret_cast<float*>(take(4 * D * R));
  m.h1T = reinterpret_cast<float*>(take(4 * Hp * R));
  m.h2T = reinterpret_cast<float*>(take(4 * Hp * R));
  m.bytes = off;
  return m;
}

// one policy's [w1; w2] as a stream of D + Hp rows, chunked into a ring
struct Ring {
  const float* w1;   // (D, Hp) of this policy
  const float* w2;   // (Hp, Hp)
  float* stage0;
  uint64_t* bar;
  int D, Hp, kc, ns, nchunks;
  unsigned q0;       // chunks this block staged for earlier policies
  bool bulk;
};

// Chunk j of the stream into its stage, by one thread: one or two bulk
// copies (the chunk may straddle w1 and w2) on the stage's barrier.
__device__ __forceinline__ void stage_bulk(const Ring& rg, int j) {
  const int a = j * rg.kc, b = min(a + rg.kc, rg.D + rg.Hp);
  const unsigned s = (rg.q0 + j) % rg.ns;
  float* dst = rg.stage0 + (size_t)s * rg.kc * rg.Hp;
  const uint32_t row = 4u * rg.Hp;
  mbar_expect_tx(&rg.bar[s], (b - a) * row);
  if (a < rg.D)
    bulk_copy(dst, rg.w1 + (size_t)a * rg.Hp, (min(b, rg.D) - a) * row,
              &rg.bar[s]);
  const int a2 = max(a, rg.D);
  if (a2 < b)
    bulk_copy(dst + (size_t)(a2 - a) * rg.Hp,
              rg.w2 + (size_t)(a2 - rg.D) * rg.Hp, (b - a2) * row,
              &rg.bar[s]);
}

// The same chunk by plain loads of every thread (unaligned pieces); the
// caller publishes it with a block barrier.
__device__ __forceinline__ void stage_plain(const Ring& rg, int j) {
  const int a = j * rg.kc, b = min(a + rg.kc, rg.D + rg.Hp);
  const unsigned s = (rg.q0 + j) % rg.ns;
  float* dst = rg.stage0 + (size_t)s * rg.kc * rg.Hp;
  const int n1 = rg.D * rg.Hp;
  for (int i = threadIdx.x; i < (b - a) * rg.Hp; i += blockDim.x) {
    const int v = a * rg.Hp + i;
    dst[i] = v < n1 ? __ldg(rg.w1 + v) : __ldg(rg.w2 + (v - n1));
  }
}

// acc[c][r] = fmaf(act[k][r], w[k][c], acc[c][r]) for k = 0 .. len-1, in
// order: a register tile of CP columns (consecutive, from w with row
// stride ldw) by RP rows (consecutive, from the transposed activations
// act with row stride lda). Each k costs one vector load of w and one of
// act for CP * RP FMAs; the pointers step, so the loop is loads and FMAs.
template <int RP, int CP>
__device__ __forceinline__ void chain(float (&acc)[CP][RP], const float* w,
                                      int ldw, const float* act, int lda,
                                      int len) {
#pragma unroll 4
  for (int k = 0; k < len; ++k) {
    float wk[CP], v[RP];
    load_vec<CP>(wk, w);
    load_vec<RP>(v, act);
#pragma unroll
    for (int c = 0; c < CP; ++c)
#pragma unroll
      for (int r = 0; r < RP; ++r) acc[c][r] = fmaf(v[r], wk[c], acc[c][r]);
    w += ldw;
    act += lda;
  }
}

// One layer's chains over stream rows [vr0, vr0 + K) from the ring, act
// (K x R, k-major) -> acc, for the CP columns from c0 and the RP rows
// from g * RP. Every thread of the block runs the loop (it holds the
// block barriers); `on` says whether it computes.
template <int RP, int CP>
__device__ __forceinline__ void ring_layer(float (&acc)[CP][RP],
                                           const Ring& rg, int vr0, int K,
                                           const float* act, int R, int c0,
                                           int g, bool on, bool issuer) {
  for (int k = 0; k < K;) {
    const int vr = vr0 + k;
    const int j = vr / rg.kc, off = vr - j * rg.kc;
    const int len = min(K - k, rg.kc - off);
    const unsigned q = rg.q0 + j;
    const unsigned s = q % rg.ns;
    if (rg.bulk) mbar_wait(&rg.bar[s], (q / rg.ns) & 1);
    const float* w = rg.stage0 + ((int)s * rg.kc + off) * rg.Hp + c0;
    if (on) chain<RP, CP>(acc, w, rg.Hp, act + k * R + g * RP, R, len);
    k += len;
    if ((off + len == rg.kc || vr + len == rg.D + rg.Hp) &&
        j + rg.ns < rg.nchunks) {
      // chunk j is consumed: once every thread is past it, its stage
      // takes chunk j + ns
      __syncthreads();
      if (rg.bulk) {
        if (issuer) stage_bulk(rg, j + rg.ns);
      } else {
        stage_plain(rg, j + rg.ns);
        __syncthreads();
      }
    }
  }
}

// gate(acc + b) into this thread's tile of outT (Hp x R, k-major for the
// next layer): RP rows of each of the CP columns from c0, one vector store
// a column where RP allows
template <int RP, int CP>
__device__ __forceinline__ void store_layer(float* outT, int R, int c0, int g,
                                            const float (&acc)[CP][RP],
                                            const float (&b)[CP], int gate) {
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    float v[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r)
      v[r] = gate_of(__fadd_rn(acc[c][r], b[c]), gate);
    float* o = outT + (c0 + c) * R + g * RP;
    if constexpr (RP == 1) {
      o[0] = v[0];
    } else if constexpr (RP == 2) {
      *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
    } else {
#pragma unroll
      for (int i = 0; i < RP / 4; ++i)
        reinterpret_cast<float4*>(o)[i] =
            make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
    }
  }
}

template <int RP, int CP>
__device__ __forceinline__ void zero(float (&acc)[CP][RP]) {
#pragma unroll
  for (int c = 0; c < CP; ++c)
#pragma unroll
    for (int r = 0; r < RP; ++r) acc[c][r] = 0.0f;
}

template <int RP, int CP>
__global__ void __launch_bounds__(kMaxThreads, 1)
serve_kernel(IalsArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int B = (int)p.B, D = (int)p.S, Hp = (int)p.Hp;
  const int NA = (int)p.n_act, NH = NA + 1, N = (int)p.n_pol;
  const int R = (int)p.serve_lanes, kc = (int)p.serve_chunk_rows;
  const int ns = (int)p.serve_stages;
  const int gate = p.fast_gates ? kFastTanh : kTanh;
  const ServeSmem sm = serve_smem(smem_raw, R, D, Hp, NH, kc, ns);
  uint32_t dyn;
  asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
  if ((uint32_t)sm.bytes > dyn) __trap();   // plan and kernel disagree

  const int tid = threadIdx.x;
  // one thread of the last warp issues every bulk copy, so that warp 0's
  // reads of the tile's mask and policies are not queued behind them
  const bool issuer = tid == (int)blockDim.x - 32;
  const int G = R / RP;                       // row groups
  // layers 1-2: thread -> (columns c0 .. c0 + CP-1, row group g); the
  // head: (column ch, row group gh)
  const int c0 = tid % (Hp / CP) * CP, g = tid / (Hp / CP);
  const int ch = tid % NH, gh = tid / NH;
  const long long row0 = (long long)blockIdx.x * R;
  const int nrows = (int)min((long long)R, (long long)B - row0);
  const bool ring_bulk = (p.serve_flags & kRingBulk) != 0;
  const bool head_bulk = (p.serve_flags & kHeadBulk) != 0;
  const int nchunks = (D + Hp + kc - 1) / kc;
  const int first = min(ns, nchunks);
  unsigned q0 = 0, head_uses = 0;
  auto ring_of = [&](int n) {
    return Ring{p.pw[0] + (size_t)n * D * Hp, p.pw[2] + (size_t)n * Hp * Hp,
                sm.ring, sm.bar, D, Hp, kc, ns, nchunks, q0, ring_bulk};
  };
  // the issuer starts staging a policy's weights: the first chunks of
  // [w1; w2] and the head, all in flight at once
  auto stage_first = [&](int n) {
    if (!issuer) return;
    const Ring rg = ring_of(n);
    if (ring_bulk)
      for (int j = 0; j < first; ++j) stage_bulk(rg, j);
    if (head_bulk) {
      mbar_expect_tx(&sm.bar[ns], 4u * Hp * NH);
      bulk_copy(sm.head, p.pw[4] + (size_t)n * Hp * NH, 4u * Hp * NH,
                &sm.bar[ns]);
    }
  };
  if (issuer) {
    for (int s = 0; s <= ns; ++s) mbar_init(&sm.bar[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // with one policy, every block stages before anything else
  const bool early = N == 1;
  if (early) stage_first(0);

  // meanwhile: warp 0 reads the tile's mask and policy indices (lane r of
  // the warp holds row r), and the tile's first policy block writes 0.0
  // for the lanes that no policy answers; every thread loads the tile's
  // frames (R consecutive rows of frames0: one contiguous run), eight
  // loads in flight a thread
  int mk = 0, pq = 0;
  if (tid < nrows) {
    mk = p.mask[row0 + tid];
    pq = p.pidx != nullptr ? p.pidx[row0 + tid] : 0;
    if (blockIdx.y == 0 && (mk == 0 || pq < 0 || pq >= N)) {
      for (int j = 0; j < NA; ++j) p.logits_out[(row0 + tid) * NA + j] = 0.0f;
      p.v_out[row0 + tid] = 0.0f;
    }
  }
  const int Dx = D | 1;
  {
    const float* src = p.frames0 + row0 * D;
    const int n = nrows * D;
    for (int i0 = tid; i0 < n; i0 += 8 * (int)blockDim.x) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * (int)blockDim.x;
        v[u] = i < n ? __ldg(src + i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * (int)blockDim.x;
        if (i < n) sm.xraw[i / D * Dx + i % D] = v[u];
      }
    }
  }

  for (int n = blockIdx.y; n < N; n += gridDim.y) {
    if (n != (int)blockIdx.y)
      __syncthreads();   // the previous policy is done with every buffer
    if (tid < 32) {      // compact the lanes of the tile that route to n
      const unsigned ballot = __ballot_sync(0xffffffffu, mk != 0 && pq == n);
      if (mk != 0 && pq == n)
        sm.lane[__popc(ballot & ((1u << tid) - 1u))] = tid;
      if (tid == 0) sm.lane[R] = __popc(ballot);
    }
    float b1[CP], b2[CP];
#pragma unroll
    for (int c = 0; c < CP; ++c) {
      b1[c] = g < G ? __ldg(p.pw[1] + (size_t)n * Hp + c0 + c) : 0.0f;
      b2[c] = g < G ? __ldg(p.pw[3] + (size_t)n * Hp + c0 + c) : 0.0f;
    }
    const float hb = gh < G ? __ldg(p.pw[5] + (size_t)n * NH + ch) : 0.0f;
    __syncthreads();     // lanes and frames are in
    const Ring rg = ring_of(n);
    const int m = sm.lane[R];
    // block-uniform: with nothing routed to n, a block moves on before it
    // stages anything, or once what it staged early has landed
    if (m == 0) {
      if (early && ring_bulk)
        for (int j = 0; j < first; ++j) mbar_wait(&sm.bar[j], 0);
      if (early && head_bulk) mbar_wait(&sm.bar[ns], 0);
      continue;
    }
    if (!early) stage_first(n);
    // only the row groups that hold routed lanes compute
    const bool on = g < G && g * RP < m;
    const bool on_h = gh < G && gh * RP < m;
    if (!ring_bulk)
      for (int j = 0; j < first; ++j) stage_plain(rg, j);
    if (!head_bulk)
      for (int i = tid; i < Hp * NH; i += blockDim.x)
        sm.head[i] = __ldg(p.pw[4] + (size_t)n * Hp * NH + i);
    // the routed lanes' frames, compacted and k-major; rows past m zero
    for (int i = tid; i < R * D; i += blockDim.x) {
      const int k = i / R, r = i % R;
      sm.xT[i] = r < m ? sm.xraw[sm.lane[r] * Dx + k] : 0.0f;
    }
    __syncthreads();

    float acc[CP][RP];
    zero(acc);
    ring_layer<RP, CP>(acc, rg, 0, D, sm.xT, R, c0, g, on, issuer);
    if (on) store_layer<RP, CP>(sm.h1T, R, c0, g, acc, b1, gate);
    __syncthreads();
    zero(acc);
    ring_layer<RP, CP>(acc, rg, D, Hp, sm.h1T, R, c0, g, on, issuer);
    if (on) store_layer<RP, CP>(sm.h2T, R, c0, g, acc, b2, gate);
    __syncthreads();

    if (head_bulk) mbar_wait(&sm.bar[ns], head_uses & 1);
    if (on_h) {
      float hacc[1][RP];
      zero(hacc);
      chain<RP, 1>(hacc, sm.head + ch, NH, sm.h2T + gh * RP, R, Hp);
#pragma unroll
      for (int r = 0; r < RP; ++r) {
        const int i = gh * RP + r;
        if (i >= m) break;
        const long long lane = row0 + sm.lane[i];
        const float v = __fadd_rn(hacc[0][r], hb);
        if (ch < NA) p.logits_out[lane * NA + ch] = v;
        else p.v_out[lane] = v;
      }
    }
    q0 += nchunks;
    ++head_uses;
  }
}

// the launch, with the shared-memory attribute raised once per kernel,
// device and size
template <int RP, int CP>
int launch_tile(const IalsArgs* a, cudaStream_t stream) {
  static int raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices || a->serve_smem > raised[dev]) {
    e = cudaFuncSetAttribute(serve_kernel<RP, CP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)a->serve_smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) raised[dev] = (int)a->serve_smem;
  }
  const long long R = a->serve_lanes;
  const dim3 grid((unsigned)((a->B + R - 1) / R),
                  (unsigned)a->serve_policy_blocks);
  serve_kernel<RP, CP><<<grid, (unsigned)a->serve_threads,
                         (size_t)a->serve_smem, stream>>>(*a);
  return (int)cudaGetLastError();
}

// A plan the kernel cannot run is refused, never adapted: the plan is
// aip_step.py::serve_plan's, and the wrapper raises on the error.
int launch_serve(const IalsArgs* a, void* stream) {
  const long long R = a->serve_lanes, RP = a->serve_rows_per_thread;
  const long long CP = a->serve_cols_per_thread;
  const long long G = RP > 0 ? R / RP : 0;
  const long long NH = a->n_act + 1;
  if (a->B < 1 || a->n_pol < 1 || a->S < 1 || a->Hp < 1 || a->n_act < 1 ||
      R < 1 || R > kMaxLanes || RP < 1 || R % RP != 0 || CP < 1 ||
      a->Hp % CP != 0 || a->serve_threads > kMaxThreads ||
      a->serve_threads % 32 != 0 || a->serve_threads < a->Hp / CP * G ||
      a->serve_threads < NH * G || a->serve_smem > kMaxSmem ||
      a->serve_chunk_rows < 1 || a->serve_stages < 1 ||
      a->serve_policy_blocks < 1 || a->serve_policy_blocks > 65535 ||
      a->serve_policy_blocks > a->n_pol)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (RP * 10 + CP) {
    case 11: return launch_tile<1, 1>(a, s);
    case 12: return launch_tile<1, 2>(a, s);
    case 14: return launch_tile<1, 4>(a, s);
    case 21: return launch_tile<2, 1>(a, s);
    case 22: return launch_tile<2, 2>(a, s);
    case 24: return launch_tile<2, 4>(a, s);
    case 41: return launch_tile<4, 1>(a, s);
    case 42: return launch_tile<4, 2>(a, s);
    case 44: return launch_tile<4, 4>(a, s);
    case 81: return launch_tile<8, 1>(a, s);
    case 82: return launch_tile<8, 2>(a, s);
    case 84: return launch_tile<8, 4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int ials_serve_forward(const IalsArgs* args, void* stream) {
  if (args->n_pol != 1 || args->pidx != nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_serve(args, stream);
}

int ials_serve_forward_multi(const IalsArgs* args, void* stream) {
  if (args->pidx == nullptr) return (int)cudaErrorInvalidValue;
  return launch_serve(args, stream);
}

}  // extern "C"
