// The first CUDA body of the IALS kernels, kept as it stood before the
// horizon kernels of fnn_rollout and policy_rollout were redesigned
// (one block of 128 threads per 16 lanes of one agent, every weight read
// with __ldg inside each product's K loop), so that
// tools/rollout_ablation.py can time it beside the redesign in the same
// run. It is not built into the port's library.

// Hand-written Hopper (sm_90a) kernels of the IALS training path: the
// CUDA counterparts of four Pallas TPU kernels in
// src/repro/kernels/aip_step.py (the two serving kernels of that file are
// in serve_kernels.cu).
//
//   ials_aip_step            <- aip_step.py::aip_step (one GRU AIP tick)
//   ials_aip_rollout_multi   <- aip_step.py::aip_rollout_multi (GRU horizon)
//   ials_fnn_rollout         <- aip_step.py::fnn_rollout (FNN horizon)
//   ials_policy_rollout_gru  <- aip_step.py::policy_rollout (kind="gru")
//   ials_policy_rollout_fnn  <- aip_step.py::policy_rollout (kind="fnn")
//
// One source holds the shared device code, templated over the AIP cell
// (GruCell / FnnCell) and the local-simulator domain (TrafficDomain):
// uniform_from_bits, the three cells of
// aip_step.py:73-135, and the traffic functor (dset, tick, obs) that the
// Pallas kernels trace from envs/traffic.py. Plain C entry points take
// one IalsArgs struct (ials_args.cuh: every field 8 bytes, mirrored by
// ctypes in repro_torch/kernels/aip_step.py), launch on the caller's stream and
// return cudaGetLastError(). The rational gates and the GRU gate update
// come from gates.cuh, shared with layer_kernels.cu's gru_sequence.
//
// Design (first version, simply right). The Pallas grid (A*nB, T) runs T
// in order on one TPU core with state in VMEM scratch. Here the lane
// blocks become CUDA blocks of kRows simulation lanes of ONE agent (the
// agent is blockIdx.x / blocks_per_agent, so it indexes its own stacked
// weights), and T becomes a loop inside the block. The tile's LS state,
// AIP state and policy frame stack stay in shared memory for the whole
// horizon; only the streamed inputs (actions or Gumbel noise, bits, done,
// reset states) and the per-tick outputs touch device memory. Each small
// GEMM splits its output columns over the threads; a thread keeps one
// weight in a register and applies it to the rows of the tile, so every
// weight is read once per tile per tick through __ldg (the weights,
// 99 KB FNN + 87 KB policy, stay L2-resident).
//
// Work per lane-tick (fp32 FLOPs at the slice's widths: obs 41, policy
// hidden 128, two actions; AIP hidden 64, d-set 40, M = 4, FNN stack 8):
//   policy forward  2*(41*128 + 128*128 + 128*3) = 44,032
//   FNN AIP         2*(320*64 + 64*64 + 64*4)    = 49,664
//   GRU AIP         2*(40*192 + 64*192 + 64*4)   = 40,448
// Bytes streamed per lane-tick: rollout 4 (action) + 16 (bits) in, 4
// (reward) out; policy_rollout 8 (gumbel) + 16 (bits) + 4 (done) + 164
// (reset LS leaves) in, 164 (x) + 4 (a) + 8 (logits) + 4 (v) + 4 (r) out.
// At ~250 FLOP per byte these are far above the card's fp32 ridge (67
// TFLOP/s over 3.35 TB/s = 20 FLOP/B): the bound is operations, and in
// practice the latency of T dependent ticks, each a chain of K-long FMA
// loops and block barriers. Keeping every state on chip is what this
// design does about it; spreading a tick over more threads (or tensor
// cores) is later work.
//
// Arithmetic is fp32 throughout. Elementwise gate math uses the _rn
// intrinsics so the compiler contracts nothing and it rounds exactly as
// torch's elementwise ops; only the GEMM reduction order differs from
// the plain PyTorch version.

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
// the traffic local simulator as a device functor (envs/traffic.py
// make_batched_local_traffic_env): leaf 0 = lanes (L, 4, lane_len) int32
// occupancy, leaf 1 = phase (L,) int32. In shared memory each road lane is
// a lane_len-bit mask (bit c = cell c, the stop line is the top bit).
// ---------------------------------------------------------------------------

struct TrafficDomain {
  static constexpr int kStateInts = 5;   // 4 lane masks + phase
  int lane_len;
  int ext;                               // 8-bit u_t (ext_influence)

  __device__ void load(const int* const* leaves, long long lane,
                       int* st) const {
    const int* lanes = leaves[0] + lane * 4 * lane_len;
    for (int dir = 0; dir < 4; ++dir) {
      int m = 0;
      for (int c = 0; c < lane_len; ++c)
        if (lanes[dir * lane_len + c] != 0) m |= 1 << c;
      st[dir] = m;
    }
    st[4] = leaves[1][lane];
  }

  __device__ void store(int* const* leaves, long long lane,
                        const int* st) const {
    int* lanes = leaves[0] + lane * 4 * lane_len;
    for (int dir = 0; dir < 4; ++dir)
      for (int c = 0; c < lane_len; ++c)
        lanes[dir * lane_len + c] = (st[dir] >> c) & 1;
    leaves[1][lane] = st[4];
  }

  // d_t = the 4*lane_len occupancy bits, direction-major
  __device__ float dset_at(const int* st, int k) const {
    return (float)((st[k / lane_len] >> (k % lane_len)) & 1);
  }

  // obs = occupancy bits then the phase
  __device__ float obs_at(const int* st, int k) const {
    return k < 4 * lane_len ? dset_at(st, k) : (float)st[4];
  }

  // the transition + reward core (rollout_tick): returns the reward
  __device__ float tick(int* st, int action, const float* u,
                        const void* const* noise, long long noise_idx) const {
    (void)noise;
    (void)noise_idx;
    const int full = (1 << lane_len) - 1;
    const bool ns = action == 0;
    int n_cars = 0, n_moved = 0;
    for (int dir = 0; dir < 4; ++dir) {
      const int occ = st[dir];
      bool can_cross = dir < 2 ? ns : !ns;
      if (ext && u[4 + dir] != 0.0f) can_cross = false;
      // suffix-OR of free cells: bit c = some cell >= c is free
      int suf = ~occ & full;
      suf |= suf >> 1;
      suf |= suf >> 2;
      suf |= suf >> 4;
      suf |= suf >> 8;
      suf |= suf >> 16;
      const int gap = suf >> 1;        // a free cell strictly ahead
      const int moved = occ & (gap | (can_cross ? full : 0));
      int nw = (occ & ~moved) | ((moved << 1) & full);
      if (u[dir] != 0.0f && (nw & 1) == 0) nw |= 1;   // injection
      n_cars += __popc(occ);
      n_moved += __popc(moved);
      st[dir] = nw;
    }
    st[4] = action;
    return n_cars > 0 ? __fdiv_rn((float)n_moved, (float)n_cars) : 1.0f;
  }
};

// ---------------------------------------------------------------------------
// AIP cells (aip_step.py::_gru_cell / _fnn_cell). Each works on the tile
// in shared memory: d (kRows, D) -> state update, u (kRows, M). The caller
// has synchronised d; the cell ends synchronised.
// ---------------------------------------------------------------------------

struct Scratch {        // float offsets into the dynamic shared buffer
  float* s[2];          // AIP state (ping-pong for the FNN shift)
  float* c1;            // GRU gx / FNN h1
  float* c2;            // GRU gh / FNN h2
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
  static __device__ int state_dim(const IalsArgs& p) { return (int)p.H; }

  static __device__ void step(const IalsArgs& p, int agent, Scratch& sc,
                              int& cur, const int* bits_row0, int nvalid,
                              long long bits_stride) {
    const int D = (int)p.D, H = (int)p.H, M = (int)p.M, G3 = 3 * H;
    const float* wx = p.aw[0] + (size_t)agent * D * G3;
    const float* wh = p.aw[1] + (size_t)agent * H * G3;
    const float* b = p.aw[2] + (size_t)agent * G3;
    const float* hw = p.aw[3] + (size_t)agent * H * M;
    const float* hb = p.aw[4] + (size_t)agent * M;
    float* h = sc.s[cur];
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

struct FnnCell {
  // aw = w1 (A, SD, K), b1 (A, K), w2 (A, K, K), b2 (A, K), hw (A, K, M),
  // hb (A, M); the state is the flat (stack * D) frame buffer
  static __device__ int state_dim(const IalsArgs& p) {
    return (int)(p.stack * p.D);
  }

  static __device__ void step(const IalsArgs& p, int agent, Scratch& sc,
                              int& cur, const int* bits_row0, int nvalid,
                              long long bits_stride) {
    const int D = (int)p.D, K = (int)p.H, M = (int)p.M;
    const int SD = (int)(p.stack * p.D);
    const float* w1 = p.aw[0] + (size_t)agent * SD * K;
    const float* b1 = p.aw[1] + (size_t)agent * K;
    const float* w2 = p.aw[2] + (size_t)agent * K * K;
    const float* b2 = p.aw[3] + (size_t)agent * K;
    const float* hw = p.aw[4] + (size_t)agent * K * M;
    const float* hb = p.aw[5] + (size_t)agent * M;
    const float* src = sc.s[cur];
    float* buf = sc.s[cur ^ 1];
    for (int i = threadIdx.x; i < kRows * SD; i += blockDim.x) {
      const int r = i / SD, j = i % SD;
      buf[i] = j < SD - D ? src[r * SD + j + D] : sc.d[r * D + j - (SD - D)];
    }
    cur ^= 1;
    __syncthreads();
    gemm(buf, SD, w1, b1, SD, K, sc.c1, K, kRelu);
    __syncthreads();
    gemm(sc.c1, K, w2, b2, K, K, sc.c2, K, kRelu);
    __syncthreads();
    gemm(sc.c2, K, hw, hb, K, M, sc.logits, M, kNone);
    __syncthreads();
    sample_u(p, sc, bits_row0, nvalid, bits_stride);
    __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// shared-memory layout of a rollout block
// ---------------------------------------------------------------------------

struct Layout {
  int s0, s1, c1, c2, d, logits, u;           // AIP part
  int f0, f1, ph1, ph2, pout, obs;            // policy part
  int ints;                                   // int region (LS state, a)
  int total_bytes;
};

Layout make_layout(const IalsArgs& p, bool fnn, bool policy) {
  Layout l{};
  const int R = kRows;
  const int SD = fnn ? (int)(p.stack * p.D) : (int)p.H;
  const int c = fnn ? (int)p.H : 3 * (int)p.H;
  int off = 0;
  auto take = [&](int n) { int o = off; off += n; return o; };
  l.s0 = take(R * SD);
  l.s1 = fnn ? take(R * SD) : l.s0;
  l.c1 = take(R * c);
  l.c2 = take(R * c);
  l.d = take(R * (int)p.D);
  l.logits = take(R * (int)p.M);
  l.u = take(R * (int)p.M);
  if (policy) {
    l.f0 = take(R * (int)p.S);
    l.f1 = take(R * (int)p.S);
    l.ph1 = take(R * (int)p.Hp);
    l.ph2 = take(R * (int)p.Hp);
    l.pout = take(R * (int)(p.n_act + 1));
    l.obs = take(R * (int)p.obs_dim);
  }
  l.ints = off;
  const int n_ints = R * (TrafficDomain::kStateInts + 2);
  l.total_bytes = (off + n_ints) * (int)sizeof(float);
  return l;
}

struct Tile {
  int agent, b0, nvalid;
  long long lane0;       // global lane index of row 0 (agent-major a*B + b)
};

__device__ Tile tile_of_block(const IalsArgs& p) {
  const int per_agent = (int)((p.B + kRows - 1) / kRows);
  Tile t;
  t.agent = blockIdx.x / per_agent;
  t.b0 = (blockIdx.x % per_agent) * kRows;
  const long long left = p.B - t.b0;
  t.nvalid = left < kRows ? (int)left : kRows;
  t.lane0 = (long long)t.agent * p.B + t.b0;
  return t;
}

template <class Domain>
__device__ void load_states(const IalsArgs& p, const Domain& dom,
                            const Tile& tile, float* s, int SD, int* ls) {
  for (int i = threadIdx.x; i < kRows * SD; i += blockDim.x) {
    const int r = i / SD;
    s[i] = r < tile.nvalid ? p.s0[(tile.lane0 + r) * SD + i % SD] : 0.0f;
  }
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    int* st = ls + r * Domain::kStateInts;
    if (r < tile.nvalid) {
      dom.load(p.ls_in, tile.lane0 + r, st);
    } else {
      for (int k = 0; k < Domain::kStateInts; ++k) st[k] = 0;
    }
  }
}

template <class Domain>
__device__ void store_states(const IalsArgs& p, const Domain& dom,
                             const Tile& tile, const float* s, int SD,
                             const int* ls) {
  for (int i = threadIdx.x; i < tile.nvalid * SD; i += blockDim.x)
    p.s_out[(tile.lane0 + i / SD) * SD + i % SD] = s[i];
  for (int r = threadIdx.x; r < tile.nvalid; r += blockDim.x)
    dom.store(p.ls_out, tile.lane0 + r, ls + r * Domain::kStateInts);
}

// ---------------------------------------------------------------------------
// whole-horizon IALS rollout (aip_step.py::_rollout_kernel): per tick
// d_t = dset(ls), AIP cell + Bernoulli draw, LS tick + reward.
// ---------------------------------------------------------------------------

template <class Cell, class Domain>
__global__ void __launch_bounds__(kThreads)
rollout_kernel(IalsArgs p, Layout lay, Domain dom) {
  extern __shared__ float smem[];
  const Tile tile = tile_of_block(p);
  const long long L = p.A * p.B;
  const int SD = Cell::state_dim(p), D = (int)p.D, M = (int)p.M;
  Scratch sc{{smem + lay.s0, smem + lay.s1}, smem + lay.c1, smem + lay.c2,
             smem + lay.d, smem + lay.logits, smem + lay.u};
  int* ls = reinterpret_cast<int*>(smem + lay.ints);
  int* act = ls + kRows * Domain::kStateInts;
  int cur = 0;
  load_states(p, dom, tile, sc.s[0], SD, ls);
  __syncthreads();
  for (long long t = 0; t < p.T; ++t) {
    for (int r = threadIdx.x; r < kRows; r += blockDim.x)
      act[r] = r < tile.nvalid ? p.actions[t * L + tile.lane0 + r] : 0;
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * D; i += blockDim.x)
      sc.d[i] = dom.dset_at(ls + (i / D) * Domain::kStateInts, i % D);
    __syncthreads();
    Cell::step(p, tile.agent, sc, cur, p.bits + (t * L + tile.lane0) * M,
               tile.nvalid, M);
    for (int r = threadIdx.x; r < tile.nvalid; r += blockDim.x) {
      const float rew = dom.tick(ls + r * Domain::kStateInts, act[r],
                                 sc.u + r * M, p.noise, t * L + tile.lane0 + r);
      p.rew_out[t * L + tile.lane0 + r] = rew;
    }
    __syncthreads();
  }
  store_states(p, dom, tile, sc.s[cur], SD, ls);
}

// ---------------------------------------------------------------------------
// actor-in-the-loop rollout (aip_step.py::_policy_rollout_kernel): per
// tick policy forward on the frame stack -> Gumbel-argmax action -> AIP
// cell + draw -> LS tick + reward -> obs refills the frame stack -> the
// streamed done merges in the streamed reset state (AIP state zeroed).
// ---------------------------------------------------------------------------

template <class Cell, class Domain>
__global__ void __launch_bounds__(kThreads)
policy_rollout_kernel(IalsArgs p, Layout lay, Domain dom) {
  extern __shared__ float smem[];
  const Tile tile = tile_of_block(p);
  const long long L = p.A * p.B;
  const int SD = Cell::state_dim(p), D = (int)p.D, M = (int)p.M;
  const int S = (int)p.S, Hp = (int)p.Hp, NA = (int)p.n_act, NH = NA + 1;
  const int d_obs = (int)p.obs_dim;
  const int gate = p.fast_gates ? kFastTanh : kTanh;
  Scratch sc{{smem + lay.s0, smem + lay.s1}, smem + lay.c1, smem + lay.c2,
             smem + lay.d, smem + lay.logits, smem + lay.u};
  float* fr[2] = {smem + lay.f0, smem + lay.f1};
  float* ph1 = smem + lay.ph1;
  float* ph2 = smem + lay.ph2;
  float* pout = smem + lay.pout;
  float* obs = smem + lay.obs;
  int* ls = reinterpret_cast<int*>(smem + lay.ints);
  int* act = ls + kRows * Domain::kStateInts;
  int* dn = act + kRows;
  int cur = 0, fc = 0;
  load_states(p, dom, tile, sc.s[0], SD, ls);
  for (int i = threadIdx.x; i < kRows * S; i += blockDim.x) {
    const int r = i / S;
    fr[0][i] = r < tile.nvalid ? p.frames0[(tile.lane0 + r) * S + i % S]
                               : 0.0f;
  }
  __syncthreads();
  for (long long t = 0; t < p.T; ++t) {
    const long long row0 = t * L + tile.lane0;   // stream row of tile row 0
    const float* x = fr[fc];
    // policy forward: two gated layers, then the fused [pi|v] head
    gemm(x, S, p.pw[0], p.pw[1], S, Hp, ph1, Hp, gate);
    __syncthreads();
    gemm(ph1, Hp, p.pw[2], p.pw[3], Hp, Hp, ph2, Hp, gate);
    __syncthreads();
    gemm(ph2, Hp, p.pw[4], p.pw[5], Hp, NH, pout, NH, kNone);
    __syncthreads();
    for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
      int best = 0;
      if (r < tile.nvalid) {
        const float* g = p.gumbel + (row0 + r) * NA;
        float bv = __fadd_rn(pout[r * NH], g[0]);
        for (int j = 1; j < NA; ++j) {
          const float v = __fadd_rn(pout[r * NH + j], g[j]);
          if (v > bv) { bv = v; best = j; }
        }
        p.a_out[row0 + r] = best;
        p.v_out[row0 + r] = pout[r * NH + NA];
        dn[r] = p.done[row0 + r];
      } else {
        dn[r] = 0;
      }
      act[r] = best;
    }
    __syncthreads();   // dset may read the action
    for (int i = threadIdx.x; i < tile.nvalid * S; i += blockDim.x)
      p.x_out[row0 * S + i] = x[i];
    for (int i = threadIdx.x; i < tile.nvalid * NA; i += blockDim.x)
      p.logits_out[row0 * NA + i] = pout[(i / NA) * NH + i % NA];
    for (int i = threadIdx.x; i < kRows * D; i += blockDim.x)
      sc.d[i] = dom.dset_at(ls + (i / D) * Domain::kStateInts, i % D);
    __syncthreads();
    Cell::step(p, tile.agent, sc, cur, p.bits + row0 * M, tile.nvalid, M);
    for (int r = threadIdx.x; r < tile.nvalid; r += blockDim.x) {
      int* st = ls + r * Domain::kStateInts;
      p.rew_out[row0 + r] = dom.tick(st, act[r], sc.u + r * M, p.noise,
                                     row0 + r);
      if (dn[r]) {
        const int* rl[kMaxLeaves];
        for (int k = 0; k < kMaxLeaves; ++k) rl[k] = p.reset_ls[k];
        // the reset leaves are (T, L, ...): lane index t*L + lane
        dom.load(rl, row0 + r, st);
      }
    }
    __syncthreads();
    float* s = sc.s[cur];
    for (int i = threadIdx.x; i < kRows * SD; i += blockDim.x)
      if (dn[i / SD]) s[i] = 0.0f;
    for (int i = threadIdx.x; i < kRows * d_obs; i += blockDim.x)
      obs[i] = dom.obs_at(ls + (i / d_obs) * Domain::kStateInts, i % d_obs);
    __syncthreads();
    float* nx = fr[fc ^ 1];
    for (int i = threadIdx.x; i < kRows * S; i += blockDim.x) {
      const int r = i / S, j = i % S;
      nx[i] = j >= S - d_obs ? obs[r * d_obs + j - (S - d_obs)]
                             : (dn[r] ? 0.0f : x[r * S + j + d_obs]);
    }
    fc ^= 1;
    __syncthreads();
  }
  store_states(p, dom, tile, sc.s[cur], SD, ls);
  for (int i = threadIdx.x; i < tile.nvalid * S; i += blockDim.x)
    p.frames_out[tile.lane0 * S + i] = fr[fc][i];
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
  Scratch sc{{smem + lay.s0, smem + lay.s1}, smem + lay.c1, smem + lay.c2,
             smem + lay.d, smem + lay.logits, smem + lay.u};
  for (int i = threadIdx.x; i < kRows * D; i += blockDim.x) {
    const int r = i / D;
    sc.d[i] = r < nvalid ? p.d[((long long)(b0 + r) * A + agent) * D + i % D]
                         : 0.0f;
  }
  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    const int r = i / H;
    sc.s[0][i] = r < nvalid
                     ? p.h[((long long)(b0 + r) * A + agent) * H + i % H]
                     : 0.0f;
  }
  __syncthreads();
  int cur = 0;
  GruCell::step(p, agent, sc, cur, p.bits + ((long long)b0 * A + agent) * M,
                nvalid, (long long)A * M);
  for (int i = threadIdx.x; i < nvalid * H; i += blockDim.x) {
    const int r = i / H;
    p.h2[((long long)(b0 + r) * A + agent) * H + i % H] = sc.s[0][i];
  }
  for (int i = threadIdx.x; i < nvalid * M; i += blockDim.x) {
    const int r = i / M;
    const long long o = ((long long)(b0 + r) * A + agent) * M + i % M;
    p.logits[o] = sc.logits[i];
    p.u[o] = sc.u[i];
  }
}

dim3 rollout_grid(const IalsArgs& p) {
  return dim3((unsigned)(p.A * ((p.B + kRows - 1) / kRows)));
}

TrafficDomain traffic_of(const IalsArgs& p) {
  TrafficDomain dom;
  dom.lane_len = (int)p.lane_len;
  dom.ext = (int)p.ext_influence;
  return dom;
}

template <class Cell>
int launch_rollout(const IalsArgs* args, void* stream, bool fnn) {
  if (args->domain != 0) return (int)cudaErrorInvalidValue;
  const Layout lay = make_layout(*args, fnn, false);
  auto k = rollout_kernel<Cell, TrafficDomain>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total_bytes);
  if (e != cudaSuccess) return (int)e;
  k<<<rollout_grid(*args), kThreads, lay.total_bytes,
      (cudaStream_t)stream>>>(*args, lay, traffic_of(*args));
  return (int)cudaGetLastError();
}

template <class Cell>
int launch_policy_rollout(const IalsArgs* args, void* stream, bool fnn) {
  if (args->domain != 0) return (int)cudaErrorInvalidValue;
  const Layout lay = make_layout(*args, fnn, true);
  auto k = policy_rollout_kernel<Cell, TrafficDomain>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total_bytes);
  if (e != cudaSuccess) return (int)e;
  k<<<rollout_grid(*args), kThreads, lay.total_bytes,
      (cudaStream_t)stream>>>(*args, lay, traffic_of(*args));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ials_aip_step(const IalsArgs* args, void* stream) {
  const Layout lay = make_layout(*args, false, false);
  cudaError_t e = cudaFuncSetAttribute(
      aip_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      lay.total_bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((args->B + kRows - 1) / kRows), (unsigned)args->A);
  aip_step_kernel<<<grid, kThreads, lay.total_bytes, (cudaStream_t)stream>>>(
      *args, lay);
  return (int)cudaGetLastError();
}

int ials_aip_rollout_multi(const IalsArgs* args, void* stream) {
  return launch_rollout<GruCell>(args, stream, false);
}

int ials_fnn_rollout(const IalsArgs* args, void* stream) {
  return launch_rollout<FnnCell>(args, stream, true);
}

int ials_policy_rollout_gru(const IalsArgs* args, void* stream) {
  return launch_policy_rollout<GruCell>(args, stream, false);
}

int ials_policy_rollout_fnn(const IalsArgs* args, void* stream) {
  return launch_policy_rollout<FnnCell>(args, stream, true);
}

int ials_args_size(void) { return (int)sizeof(IalsArgs); }

}  // extern "C"
