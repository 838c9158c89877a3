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
// One source holds the shared device code, templated over the local-
// simulator domain: uniform_from_bits, the AIP cells of
// aip_step.py:73-135, and the two functors (dset, tick, obs) that the
// Pallas kernels trace from envs/traffic.py and envs/warehouse.py
// (TrafficDomain, WarehouseDomain; each instantiated explicitly). Plain C entry points take
// one IalsArgs struct (ials_args.cuh: every field 8 bytes, mirrored by
// ctypes in repro_torch/kernels/aip_step.py), launch on the caller's stream and
// return cudaGetLastError(). The rational gates and the GRU gate update
// come from gates.cuh, shared with layer_kernels.cu's gru_sequence.
//
// Work per lane-tick (fp32 FLOPs at the traffic widths: obs 41, policy
// hidden 128, two actions; AIP hidden 64, d-set 40, M = 4, FNN stack 8;
// the warehouse's: 8 frames of 37, five actions, d-set 24, M = 12):
//   policy forward  2*(41*128 + 128*128 + 128*3) = 44,032  (wh 110,080)
//   FNN AIP         2*(320*64 + 64*64 + 64*4)    = 49,664  (wh  34,304)
//   GRU AIP         2*(40*192 + 64*192 + 64*4)   = 40,448  (wh  35,328)
// At ~250 FLOP per streamed byte these are far above the card's fp32
// ridge (20 FLOP/B), but the ticks depend on one another: the real bound
// is T times the critical path of one tick.
//
// aip_rollout_multi (the GRU cell, actions streamed), fnn_rollout (the
// FNN cell, actions streamed) and policy_rollout (either cell, the
// policy in the loop) run the horizon kernel (horizon_kernel, launch
// plan aip_step.py::rollout_plan); aip_step runs its GRU role for one
// tick (step_kernel, the same plan):
//  - Weights on chip for the whole horizon: each CTA stages its role's
//    weights into shared memory once, by bulk asynchronous copies on an
//    mbarrier (plain loads for a piece that is not 16-byte aligned), and
//    no product reads global memory after that.
//  - Two roles: the policy (forward, Gumbel-argmax, frames) and the AIP
//    and LS (dset, AIP cell and draw, LS tick, resets). With the policy
//    the plan puts them on the two CTAs of a cluster (the policy's 89 KB
//    and the FNN AIP's 100 KB do not fit one SM beside the state); for
//    traffic they run the tick's two products side by side, since its
//    dset does not read the action, and meet twice a tick at a cluster
//    barrier: the action goes to the LS CTA's shared memory, the next
//    observation to the policy CTA's (distributed shared memory,
//    map_shared_rank). The warehouse's dset reads the action
//    (kDsetReadsAction), so there the first barrier comes between the
//    argmax and the dset, and the roles take turns.
//  - A tile is roll_lanes lanes, the fewest whose grid the card holds at
//    once (fewer lanes, shorter ticks): one lane a tile at the main
//    path's A = 1, B = 16 (16 clusters), 4 at A = 25, B = 16 (100
//    clusters with the policy, 100 CTAs without: aip_rollout_multi);
//    without the policy two CTAs of 8 or more lanes share an SM where
//    they fit (8 lanes, 200 CTAs at A = 25, B = 64).
//  - A product spreads over the block's 256 threads (512 at 32 lanes):
//    item = (column, row group of up to 4 rows, K-part); a thread's chain
//    runs its K-part with up to 4 independent accumulators, one shared
//    weight load (no bank conflict) and one broadcast vector load of the
//    k-major activations a step. Narrow products (the heads) are cut into
//    up to 16 K-parts, summed afterwards in part order, so a launch
//    repeats bitwise. Item coordinates come from a float-reciprocal
//    divider and shifts (lanes are a power of two), not integer division.
//  - Streamed inputs of a tick (done, bits, Gumbel noise, actions) are
//    loaded at the tick's start and used after the products.
//  - The FNN's frame stack is a ring in shared memory (the new d-set
//    overwrites the oldest frame), not a shifted copy.
// Where a tick's time goes: tools/rollout_ablation.py (clock64 marks
// per phase, weights from L2, no products, other plans).
//
// Arithmetic is fp32 throughout. Elementwise gate math uses the _rn
// intrinsics so the compiler contracts nothing and it rounds exactly as
// torch's elementwise ops; only the GEMM reduction order differs from
// the plain PyTorch version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gates.cuh"
#include "ials_args.cuh"
#include "smem.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// the traffic local simulator as a device functor (envs/traffic.py
// make_batched_local_traffic_env): leaf 0 = lanes (L, 4, lane_len) int32
// occupancy, leaf 1 = phase (L,) int32. In shared memory each road lane is
// a lane_len-bit mask (bit c = cell c, the stop line is the top bit).
// ---------------------------------------------------------------------------

struct TrafficDomain {
  static constexpr int kStateInts = 5;   // 4 lane masks + phase
  static constexpr bool kDsetReadsAction = false;
  int lane_len;
  int ext;                               // 8-bit u_t (ext_influence)

  // the widths the functor computes: d-set 4 * lane_len, obs + phase,
  // u_t 4 (8) bits; lane masks fit an int
  bool valid(const IalsArgs& p, bool policy) const {
    return lane_len >= 1 && lane_len <= 30 && p.D == 4 * lane_len &&
           p.M == (ext ? 8 : 4) && (!policy || p.obs_dim == p.D + 1);
  }

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

  // d_t = the 4*lane_len occupancy bits, direction-major (no action)
  __device__ float dset_at(const int* st, int action, int k) const {
    (void)action;
    return (float)((st[k / lane_len] >> (k % lane_len)) & 1);
  }

  // obs = occupancy bits then the phase
  __device__ float obs_at(const int* st, int k) const {
    return k < 4 * lane_len ? dset_at(st, 0, k) : (float)st[4];
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

TrafficDomain traffic_of(const IalsArgs& p) {
  TrafficDomain dom;
  dom.lane_len = (int)p.lane_len;
  dom.ext = (int)p.ext_influence;
  return dom;
}

// ---------------------------------------------------------------------------
// the warehouse local simulator as a device functor (envs/warehouse.py
// make_batched_local_warehouse_env, the counterpart of the reference's
// rollout_tick / dset_fn / obs_fn traced into a Pallas body): leaf 0 = pos
// (L, 2) int32 (row, column in the region), leaf 1 = items (L, 12) int32
// (age + 1 of each item cell's item, 0 = none); one noise leaf, the spawn
// draws (T, L, 12) int32. In shared memory a lane is its row, its column,
// then the 12 ages. Item cell i is (row, column) by the iota rule of the
// reference's _at_item_mask_k: groups of three per edge (top, bottom,
// left, right), no table.
// ---------------------------------------------------------------------------

struct WarehouseDomain {
  static constexpr int kStateInts = 14;  // row, column, 12 ages
  // the d-set's "at an item cell after the move" reads this tick's action
  static constexpr bool kDsetReadsAction = true;
  int side;          // the region's side
  int max_age;
  int vanish_after;  // > 0: an item vanishes after this many ticks (§5.4)

  // the widths the functor computes: d-set 24, obs side^2 + 12, u_t 12
  bool valid(const IalsArgs& p, bool policy) const {
    return side >= 2 && max_age >= 1 && vanish_after >= 0 && p.D == 24 &&
           p.M == 12 && p.noise[0] != nullptr &&
           (!policy || p.obs_dim == side * side + 12);
  }

  __device__ __forceinline__ bool at_item(int r, int c, int i) const {
    const int g = i / 3, w = i - 3 * (i / 3);
    const int ir = g == 0 ? 0 : (g == 1 ? side - 1 : w + 1);
    const int ic = g == 2 ? 0 : (g == 3 ? side - 1 : w + 1);
    return ir == r && ic == c;
  }

  // clip(pos + move(action)): 1 up (-row), 2 down, 3 left, 4 right
  __device__ __forceinline__ void moved(const int* st, int action, int& r,
                                        int& c) const {
    const int dr = action == 1 ? -1 : (action == 2 ? 1 : 0);
    const int dc = action == 3 ? -1 : (action == 4 ? 1 : 0);
    r = min(max(st[0] + dr, 0), side - 1);
    c = min(max(st[1] + dc, 0), side - 1);
  }

  __device__ void load(const int* const* leaves, long long lane,
                       int* st) const {
    st[0] = leaves[0][lane * 2];
    st[1] = leaves[0][lane * 2 + 1];
    for (int i = 0; i < 12; ++i) st[2 + i] = leaves[1][lane * 12 + i];
  }

  __device__ void store(int* const* leaves, long long lane,
                        const int* st) const {
    leaves[0][lane * 2] = st[0];
    leaves[0][lane * 2 + 1] = st[1];
    for (int i = 0; i < 12; ++i) leaves[1][lane * 12 + i] = st[2 + i];
  }

  // d_t = the 12 item bits, then "at item cell i before or after the move"
  __device__ float dset_at(const int* st, int action, int k) const {
    if (k < 12) return st[2 + k] > 0 ? 1.0f : 0.0f;
    int r, c;
    moved(st, action, r, c);
    return at_item(st[0], st[1], k - 12) || at_item(r, c, k - 12) ? 1.0f
                                                                  : 0.0f;
  }

  // obs = the one-hot of the position (side^2 cells), then the item bits
  __device__ float obs_at(const int* st, int k) const {
    const int n = side * side;
    if (k < n) return k / side == st[0] && k % side == st[1] ? 1.0f : 0.0f;
    return st[2 + k - n] > 0 ? 1.0f : 0.0f;
  }

  // the transition + reward core (rollout_tick): move, pick up, age,
  // vanish, spawn from this lane's row of the noise leaf -> the reward
  __device__ float tick(int* st, int action, const float* u,
                        const void* const* noise, long long noise_idx) const {
    const int* spawn = static_cast<const int*>(noise[0]) + noise_idx * 12;
    int r, c;
    moved(st, action, r, c);
    int picked = 0;
    for (int i = 0; i < 12; ++i) {
      const int age = st[2 + i];
      const bool at = at_item(r, c, i);
      if (at && age > 0) ++picked;
      int a = at || u[i] > 0.5f ? 0 : age;
      a = a > 0 ? min(a + 1, max_age) : 0;
      if (vanish_after > 0 && a > vanish_after) a = 0;
      if (a == 0 && spawn[i] != 0) a = 1;
      st[2 + i] = a;
    }
    st[0] = r;
    st[1] = c;
    return (float)picked;
  }
};

WarehouseDomain warehouse_of(const IalsArgs& p) {
  WarehouseDomain dom;
  dom.side = (int)p.region;
  dom.max_age = (int)p.max_age;
  dom.vanish_after = (int)p.vanish_after;
  return dom;
}

// ---------------------------------------------------------------------------
// The horizon kernels of aip_rollout_multi, fnn_rollout and policy_rollout:
// weights staged on chip once a launch, a tick spread over the block, the
// policy and the AIP on two CTAs of a cluster. See the design note at the
// top of this file; the launch plan is aip_step.py::rollout_plan.
// ---------------------------------------------------------------------------

constexpr int kRollMaxThreads = 512;
constexpr int kRollMaxSplit = 16;
constexpr int kRollMaxSmem = 232448;
constexpr int kRollMaxDevices = 64;

__host__ __device__ __forceinline__ int round16(int bytes) {
  return (bytes + 15) & ~15;
}

__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

// Byte offsets of a CTA's dynamic shared memory, per role, in the order
// and sizes of aip_step.py::roll_smem: the policy role (rank 0 of a
// cluster of two) from its base, the AIP role (rank 1) from its; with
// one CTA a tile the AIP role's base follows the policy role's bytes.
struct RollLayout {
  int pbar, pw[6], fr, h1, h2, pout, obs, gum, pdn, ppart, pol_bytes;
  int ebar, aw[6], state, d, c1, c2, lg, u, ls, act, edn, epart, aip_bytes;
  int n_aw;
};

__host__ __device__ inline int roll_part(const IalsArgs& p, int i, int N) {
  return p.roll_split[i] > 1 ? (int)p.roll_split[i] * N * (int)p.roll_lanes
                             : 0;
}

__host__ __device__ inline RollLayout roll_layout(const IalsArgs& p,
                                                  bool fnn, bool policy,
                                                  int SI) {
  RollLayout l{};
  const int R = (int)p.roll_lanes, D = (int)p.D, H = (int)p.H;
  const int M = (int)p.M, S = (int)p.S, Hp = (int)p.Hp;
  const int NA = (int)p.n_act, NH = NA + 1;
  int off = 0;
  auto take = [&](int floats) {
    const int o = off;
    off += round16(4 * floats);
    return o;
  };
  if (policy) {
    l.pbar = take(4);
    const int pieces[6] = {S * Hp, Hp, Hp * Hp, Hp, Hp * NH, NH};
    for (int i = 0; i < 6; ++i) l.pw[i] = take(pieces[i]);
    l.fr = take(2 * S * R);
    l.h1 = take(Hp * R);
    l.h2 = take(Hp * R);
    l.pout = take(NH * R);
    l.obs = take((int)p.obs_dim * R);
    l.gum = take(R * NA);
    l.pdn = take(R);
    int part = 0;
    const int pn[3] = {Hp, Hp, NH};
    for (int i = 0; i < 3; ++i) part = imax(part, roll_part(p, i, pn[i]));
    l.ppart = take(part);
    l.pol_bytes = off;
  }
  off = 0;
  l.ebar = take(4);
  const int SD = (int)(p.stack * p.D), G3 = 3 * H;
  if (fnn) {
    const int pieces[6] = {SD * H, H, H * H, H, H * M, M};
    l.n_aw = 6;
    for (int i = 0; i < 6; ++i) l.aw[i] = take(pieces[i]);
    l.state = take(SD * R);
    l.d = take(0);
    l.c1 = take(H * R);
    l.c2 = take(H * R);
  } else {
    const int pieces[5] = {D * G3, H * G3, G3, H * M, M};
    l.n_aw = 5;
    for (int i = 0; i < 5; ++i) l.aw[i] = take(pieces[i]);
    l.state = take(H * R);
    l.d = take(D * R);
    l.c1 = take(G3 * R);
    l.c2 = take(G3 * R);
  }
  l.lg = take(M * R);
  l.u = take(R * M);
  l.ls = take(R * SI);
  l.act = take(R);
  l.edn = take(R);
  const int N34 = fnn ? H : G3;
  const int p3 = roll_part(p, 3, N34), p4 = roll_part(p, 4, N34);
  const int p5 = roll_part(p, 5, M);
  l.epart = take(fnn ? imax(imax(p3, p4), p5) : imax(p3 + p4, p5));
  l.aip_bytes = off;
  return l;
}

// x / d for 0 <= x < 2^22 by a float reciprocal and one fix-up (the
// estimate is within one of the quotient there): the items' coordinates
// without the ~20-instruction integer division
struct FastDiv {
  int d;
  float inv;
  __device__ explicit FastDiv(int d_) : d(d_), inv(1.0f / (float)d_) {}
  __device__ __forceinline__ int div(int x) const {
#ifdef IALS_ROLL_PLAIN_DIV
    return x / d;
#else
    int q = (int)((float)x * inv);
    const int r = x - q * d;
    if (r >= d) ++q;
    else if (r < 0) --q;
    return q;
#endif
  }
};

// One product y = act(x @ W + b) over the tile's R rows, activations
// k-major: x^T (K x R) and y^T (N x R). x may be a ring of nseg segments
// of seg rows: logical row k sits in physical segment (head + k / seg) %
// nseg (the FNN's frame stack; one segment otherwise). With KS > 1 the K
// range is cut into KS parts whose partial sums go to part (KS x N x R)
// and are summed in part order by prod_finish. W is in shared memory (in
// the IALS_STEP_FROM_GLOBAL build, with ldg, in global memory: each chain
// loads its part's weights before its FMAs, chain_rows_ldg).
struct Prod {
  const float* W;   // K x N, row-major
  const float* b;   // N, or null
  int K, N, KS, act;
  const float* x;
  int seg, nseg, head;
  float* y;
  float* part;
#ifdef IALS_STEP_FROM_GLOBAL
  bool ldg = false;
#endif
};

// acc[r] = fmaf(x[k][r], w[k], acc[r]) for k in order: one shared load of
// the weight (consecutive threads, consecutive columns: no conflict) and
// one vector load of RP activations (the same for the warp: a broadcast)
template <int RP>
__device__ __forceinline__ void chain_rows(float (&acc)[RP], const float* w,
                                           int ldw, const float* x, int R,
                                           int len) {
#pragma unroll 4
  for (int k = 0; k < len; ++k) {
    const float wk = *w;
    float v[RP];
    load_vec<RP>(v, x);
#pragma unroll
    for (int r = 0; r < RP; ++r) acc[r] = fmaf(v[r], wk, acc[r]);
    w += ldw;
    x += R;
  }
}

#ifdef IALS_STEP_FROM_GLOBAL
// chain_rows with the weights in global memory: the loads of up to
// kLdgBatch steps are all issued before their FMAs, so a part of that many
// steps waits on one round trip to L2 or DRAM, not one a step. The same
// sums in the same order as chain_rows.
constexpr int kLdgBatch = 32;
template <int RP>
__device__ __forceinline__ void chain_rows_ldg(float (&acc)[RP],
                                               const float* __restrict__ w,
                                               int ldw, const float* x, int R,
                                               int len) {
  for (int k0 = 0; k0 < len; k0 += kLdgBatch) {
    const int n = min(kLdgBatch, len - k0);
    // unconditional loads (a step past the part re-reads its last weight):
    // no branch between them, so all are in flight before the first FMA
    float wk[kLdgBatch];
#pragma unroll
    for (int j = 0; j < kLdgBatch; ++j)
      wk[j] = __ldg(w + (size_t)(k0 + min(j, n - 1)) * ldw);
#pragma unroll
    for (int j = 0; j < kLdgBatch; ++j) {
      if (j < n) {
        float v[RP];
        load_vec<RP>(v, x + (size_t)(k0 + j) * R);
#pragma unroll
        for (int r = 0; r < RP; ++r) acc[r] = fmaf(v[r], wk[j], acc[r]);
      }
    }
  }
}
#endif

// The items of one product: item i -> column i % N, row group (i / N) %
// G, part i / (N G); each thread walks items i = tid, tid + nthreads, ...
// (aip_step.py::rollout_items enumerates the same).
template <int RP>
__device__ void gemm_items(const Prod& q, int R) {
  const int G = R / RP;   // a power of two
  const int items = G * q.N * q.KS;
  const int kl = (q.K + q.KS - 1) / q.KS;
  const FastDiv byN(q.N), byNG(q.N * G), bySeg(q.seg);
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int c = byN.div(it);
    const int n = it - c * q.N, g = c & (G - 1), part = byNG.div(it);
    const int k0 = min(q.K, part * kl), k1 = min(q.K, k0 + kl);
    float acc[RP];
#pragma unroll
    for (int r = 0; r < RP; ++r) acc[r] = 0.0f;
#ifndef IALS_ROLL_NO_PRODUCTS
    for (int k = k0; k < k1;) {
      const int s = bySeg.div(k), e = min(k1, (s + 1) * q.seg);
      const int phys = q.head + s >= q.nseg ? q.head + s - q.nseg
                                            : q.head + s;
      const float* x = q.x + ((size_t)phys * q.seg + (k - s * q.seg)) * R +
                       g * RP;
#ifdef IALS_STEP_FROM_GLOBAL
      if (q.ldg)
        chain_rows_ldg<RP>(acc, q.W + (size_t)k * q.N + n, q.N, x, R, e - k);
      else
#endif
        chain_rows<RP>(acc, q.W + (size_t)k * q.N + n, q.N, x, R, e - k);
      k = e;
    }
#endif
    if (q.KS == 1) {
      const float bb = q.b != nullptr ? q.b[n] : 0.0f;
#pragma unroll
      for (int r = 0; r < RP; ++r)
        q.y[n * R + g * RP + r] =
            activate(q.b != nullptr ? __fadd_rn(acc[r], bb) : acc[r], q.act);
    } else {
#pragma unroll
      for (int r = 0; r < RP; ++r)
        q.part[((size_t)part * q.N + n) * R + g * RP + r] = acc[r];
    }
  }
}

__device__ __forceinline__ void prod_items(const Prod& q, int R, int RP) {
  if (RP == 4) gemm_items<4>(q, R);
  else if (RP == 2) gemm_items<2>(q, R);
  else gemm_items<1>(q, R);
}

// y = act(part[0] + part[1] + ... + b), the parts summed in order
__device__ void prod_finish(const Prod& q, int R) {
  const int lgR = 31 - __clz(R);
  for (int i = threadIdx.x; i < q.N * R; i += blockDim.x) {
    float s = q.part[i];
    for (int j = 1; j < q.KS; ++j)
      s = __fadd_rn(s, q.part[(size_t)j * q.N * R + i]);
    q.y[i] =
        activate(q.b != nullptr ? __fadd_rn(s, q.b[i >> lgR]) : s, q.act);
  }
}

// one product with its block barriers: the items, then (KS > 1) the sums
__device__ void prod_run(const Prod& q, int R, int RP) {
  prod_items(q, R, RP);
  __syncthreads();
  if (q.KS > 1) {
    prod_finish(q, R);
    __syncthreads();
  }
}

// The GRU role's cell over the tile's R lanes, activations k-major: gx =
// d @ wx + b and gh = h @ wh side by side (their K-parts summed in part
// order), the gate update of h^T in place, then logits = h @ hw + hb.
// w: wx, wh, b, hw, hb in shared memory (kFromGlobal: in global, the
// IALS_STEP_FROM_GLOBAL build's step). Starts after a block barrier that
// published d^T and h^T; ends with one.
template <bool kFromGlobal = false>
__device__ void gru_cell(const IalsArgs& p, const float* const* w,
                         const float* dT, float* hT, float* c1T, float* c2T,
                         float* lgT, float* epart, int R, int RP) {
  const int D = (int)p.D, H = (int)p.H, M = (int)p.M, G3 = 3 * H;
  const int lgR = 31 - __clz(R), mR = R - 1;
  Prod gx{w[0], w[2], D, G3, (int)p.roll_split[3], kNone, dT, D, 1, 0, c1T,
          epart};
  Prod gh{w[1], nullptr, H, G3, (int)p.roll_split[4], kNone, hT, H, 1, 0,
          c2T, epart + roll_part(p, 3, G3)};
  Prod lg{w[3], w[4], H, M, (int)p.roll_split[5], kNone, hT, H, 1, 0, lgT,
          epart};
#ifdef IALS_STEP_FROM_GLOBAL
  gx.ldg = gh.ldg = lg.ldg = kFromGlobal;
#endif
  prod_items(gx, R, RP);
  prod_items(gh, R, RP);
  __syncthreads();
  if (gx.KS > 1 || gh.KS > 1) {
    if (gx.KS > 1) prod_finish(gx, R);
    if (gh.KS > 1) prod_finish(gh, R);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < H * R; i += blockDim.x) {
    const int j = i >> lgR, r = i & mR;
    hT[i] = gru_gate(c1T[i], c1T[(H + j) * R + r], c1T[(2 * H + j) * R + r],
                     c2T[i], c2T[(H + j) * R + r], c2T[(2 * H + j) * R + r],
                     hT[i]);
  }
  __syncthreads();
  prod_run(lg, R, RP);
}

__device__ __forceinline__ bool bulk_ok(const float* src, int n) {
  return ((uintptr_t)src & 15) == 0 && (4 * n) % 16 == 0;
}

// Stage np weight pieces (src global, dst shared, n floats each) on
// `bar`: thread 0 issues a bulk copy for each piece whose base and size
// are 16-byte multiples; every thread copies the others by plain loads.
// The caller waits on the barrier (parity 0), then a block barrier.
__device__ void stage_pieces(float* const* dst, const float* const* src,
                             const int* n, int np, uint64_t* bar) {
  if (threadIdx.x == 0) {
    uint32_t bytes = 0;
    for (int i = 0; i < np; ++i)
      if (bulk_ok(src[i], n[i])) bytes += 4u * n[i];
    mbar_expect_tx(bar, bytes);
    for (int i = 0; i < np; ++i)
      if (bulk_ok(src[i], n[i]) && n[i] > 0)
        bulk_copy(dst[i], src[i], 4u * n[i], bar);
  }
  for (int i = 0; i < np; ++i) {
    if (bulk_ok(src[i], n[i])) continue;
    for (int j = threadIdx.x; j < n[i]; j += blockDim.x)
      dst[i][j] = __ldg(src[i] + j);
  }
}

#ifdef IALS_ROLL_TIMELINE
// clock64 marks: thread 0 of each CTA adds the cycles since the last mark
// to phase i; the sums go to the int64 buffer behind p.h2 at the end
#define ROLL_MARK(i)                    \
  do {                                  \
    if (threadIdx.x == 0) {             \
      const long long now_ = clock64(); \
      tl_sum[i] += now_ - tl_last;      \
      tl_last = now_;                   \
    }                                   \
  } while (0)
#else
#define ROLL_MARK(i) \
  do {               \
  } while (0)
#endif

__device__ __forceinline__ void cross_sync(int C) {
  if (C == 2) cooperative_groups::this_cluster().sync();
  else __syncthreads();
}

template <bool kFnn, bool kPolicy, class Domain>
__global__ void __launch_bounds__(kRollMaxThreads, 1)
horizon_kernel(IalsArgs p, Domain dom) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
#ifdef IALS_ROLL_TIMELINE
  long long tl_sum[16] = {};
  long long tl_last = clock64();
#endif
  const RollLayout lay = roll_layout(p, kFnn, kPolicy, Domain::kStateInts);
  const int C = (int)p.roll_cluster;
  const int rank = (int)(blockIdx.x % C);
  const bool doP = kPolicy && (C == 1 || rank == 0);
  const bool doE = !kPolicy || C == 1 || rank == 1;
  {
    uint32_t dyn;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
    const int need = C == 2 ? (doP ? lay.pol_bytes : lay.aip_bytes)
                            : lay.pol_bytes + lay.aip_bytes;
    if ((uint32_t)need > dyn) __trap();   // plan and kernel disagree
  }
  unsigned char* pb = smem_raw;
  unsigned char* eb = smem_raw + (C == 1 ? lay.pol_bytes : 0);
  auto pf = [&](int off) { return reinterpret_cast<float*>(pb + off); };
  auto ef = [&](int off) { return reinterpret_cast<float*>(eb + off); };

  const int R = (int)p.roll_lanes, RP = (int)p.roll_rows_per_thread;
  const int lgR = 31 - __clz(R), mR = R - 1;   // R is a power of two
  const long long B = p.B, L = p.A * p.B;
  const int per_agent = (int)((B + R - 1) / R);
  const int tile = (int)(blockIdx.x / C);
  const int agent = tile / per_agent;
  const int b0 = (tile % per_agent) * R;
  const int nvalid = (int)min((long long)R, B - b0);
  const long long lane0 = (long long)agent * B + b0;
  const int tid = threadIdx.x;
  const int D = (int)p.D, H = (int)p.H, M = (int)p.M;
  const int SI = Domain::kStateInts;
  const int stack = kFnn ? (int)p.stack : 1;
  const int SD = kFnn ? stack * D : H;
  const int S = (int)p.S, Hp = (int)p.Hp, NA = (int)p.n_act, NH = NA + 1;
  const int d_obs = (int)p.obs_dim;
  const int gate = p.fast_gates ? kFastTanh : kTanh;
  const FastDiv byS(kPolicy ? S : 1), byNA(kPolicy ? NA : 1);

  // the policy role's buffers
  float* pw[6];
  for (int i = 0; i < 6; ++i) pw[i] = pf(lay.pw[i]);
  float* fr[2] = {pf(lay.fr), pf(lay.fr) + S * R};
  float* h1T = pf(lay.h1);
  float* h2T = pf(lay.h2);
  float* poutT = pf(lay.pout);
  float* obsT = pf(lay.obs);
  float* gum = pf(lay.gum);
  int* pdn = reinterpret_cast<int*>(pb + lay.pdn);
  float* ppart = pf(lay.ppart);
  uint64_t* pbar = reinterpret_cast<uint64_t*>(pb + lay.pbar);
  // the AIP role's
  float* aw[6];
  for (int i = 0; i < 6; ++i) aw[i] = ef(lay.aw[i]);
  float* state = ef(lay.state);   // FNN: the frame ring; GRU: h^T
  float* dT = ef(lay.d);
  float* c1T = ef(lay.c1);
  float* c2T = ef(lay.c2);
  float* lgT = ef(lay.lg);
  float* u = ef(lay.u);
  int* ls = reinterpret_cast<int*>(eb + lay.ls);
  int* act = reinterpret_cast<int*>(eb + lay.act);
  int* edn = reinterpret_cast<int*>(eb + lay.edn);
  float* epart = ef(lay.epart);
  uint64_t* ebar = reinterpret_cast<uint64_t*>(eb + lay.ebar);
  // where the action and the next observation go: the other CTA's
  // shared memory (distributed shared memory) in a cluster of two
  int* act_dst = act;
  float* obs_dst = obsT;
  if (C == 2) {
    cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
    if (doP)
      act_dst = cl.map_shared_rank(
          reinterpret_cast<int*>(smem_raw + lay.act), 1);
    if (doE)
      obs_dst = cl.map_shared_rank(
          reinterpret_cast<float*>(smem_raw + lay.obs), 0);
  }
  int na[6];   // the AIP pieces' floats
  {
    const int G3 = 3 * H;
    const int fnn_n[6] = {SD * H, H, H * H, H, H * M, M};
    const int gru_n[6] = {D * G3, H * G3, G3, H * M, M, 0};
    for (int i = 0; i < 6; ++i) na[i] = kFnn ? fnn_n[i] : gru_n[i];
  }
  const float* aw_src[6];
  for (int i = 0; i < 6; ++i)
    aw_src[i] = i < lay.n_aw ? p.aw[i] + (size_t)agent * na[i] : nullptr;
  // the weights the products read: staged (the design), or from global
  // memory in the ablation build that measures what staging saves
  const float* pwr[6];
  const float* awr[6];
  for (int i = 0; i < 6; ++i) {
#ifdef IALS_ROLL_WEIGHTS_FROM_L2
    pwr[i] = p.pw[i];
    awr[i] = aw_src[i];
#else
    pwr[i] = pw[i];
    awr[i] = aw[i];
#endif
  }

  // ---- prologue: weights staged once, states in -------------------------
  if (tid == 0) {
    if (doP) mbar_init(pbar, 1);
    if (doE) mbar_init(ebar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (doP) {
    const int n[6] = {S * Hp, Hp, Hp * Hp, Hp, Hp * NH, NH};
    stage_pieces(pw, p.pw, n, 6, pbar);
  }
  if (doE) {
    stage_pieces(aw, aw_src, na, lay.n_aw, ebar);
    // LS state (lane-major ints) and the AIP state (k-major; the FNN's
    // frames in logical order, ring head 0); pad lanes zero
    for (int r = tid; r < R; r += blockDim.x) {
      int* st = ls + r * SI;
      if (r < nvalid) {
        dom.load(p.ls_in, lane0 + r, st);
      } else {
        for (int k = 0; k < SI; ++k) st[k] = 0;
      }
    }
    for (int i = tid; i < R * SD; i += blockDim.x) {
      const int r = i / SD, k = i % SD;
      state[k * R + r] = r < nvalid ? p.s0[(lane0 + r) * SD + k] : 0.0f;
    }
  }
  if (doP) {
    for (int i = tid; i < R * S; i += blockDim.x) {
      const int r = i / S, k = i % S;
      fr[0][k * R + r] = r < nvalid ? p.frames0[(lane0 + r) * S + k] : 0.0f;
    }
  }
  if (doP) mbar_wait(pbar, 0);
  if (doE) mbar_wait(ebar, 0);
  __syncthreads();
  // both CTAs of a cluster are running before either writes to the other
  if (C == 2) cooperative_groups::this_cluster().sync();
  ROLL_MARK(0);

  int head = 0, fc = 0;
  for (long long t = 0; t < p.T; ++t) {
    const long long row0 = t * L + lane0;   // stream row of tile row 0
    // the tick's streamed inputs, loaded now and used later
    const int dv = kPolicy && tid < nvalid ? __ldg(p.done + row0 + tid) : 0;
    int bv = 0, av = 0;
    float gv = 0.0f;
    if (doE && tid < nvalid * M) bv = __ldg(p.bits + row0 * M + tid);
    if (!kPolicy && tid < nvalid) av = __ldg(p.actions + row0 + tid);
    if (doP && tid < nvalid * NA) gv = __ldg(p.gumbel + row0 * NA + tid);

    if (doP) {
      // policy forward: two gated layers, then the fused [pi|v] head
      const float* x = fr[fc];
      prod_run(Prod{pwr[0], pwr[1], S, Hp, (int)p.roll_split[0], gate, x, S,
                    1, 0, h1T, ppart}, R, RP);
      ROLL_MARK(1);
      prod_run(Prod{pwr[2], pwr[3], Hp, Hp, (int)p.roll_split[1], gate, h1T,
                    Hp, 1, 0, h2T, ppart}, R, RP);
      ROLL_MARK(2);
      if (tid < R * NA) gum[tid] = gv;
      if (tid < R) pdn[tid] = dv;
      prod_run(Prod{pwr[4], pwr[5], Hp, NH, (int)p.roll_split[2], kNone, h2T,
                    Hp, 1, 0, poutT, ppart}, R, RP);
      ROLL_MARK(3);
      // Gumbel-argmax (the first of equal maxima), the streamed outputs
      if (tid < nvalid) {
        int best = 0;
        float top = __fadd_rn(poutT[tid], gum[tid * NA]);
        for (int j = 1; j < NA; ++j) {
          const float v = __fadd_rn(poutT[j * R + tid], gum[tid * NA + j]);
          if (v > top) {
            top = v;
            best = j;
          }
        }
        p.a_out[row0 + tid] = best;
        p.v_out[row0 + tid] = poutT[NA * R + tid];
        act_dst[tid] = best;
      }
      for (int i = tid; i < nvalid * NA; i += blockDim.x) {
        const int r = byNA.div(i);
        p.logits_out[row0 * NA + i] = poutT[(i - r * NA) * R + r];
      }
      for (int i = tid; i < nvalid * S; i += blockDim.x) {
        const int r = byS.div(i);
        p.x_out[row0 * S + i] = x[(i - r * S) * R + r];
      }
      ROLL_MARK(4);
    }
    if (Domain::kDsetReadsAction) {
      // the d-set reads this tick's action: the AIP role waits for it (with
      // the policy, for the argmax: both CTAs of a cluster meet here, so
      // the tick's two roles no longer overlap)
      if (kPolicy) {
        cross_sync(C);
      } else {
        if (tid < R) act[tid] = av;
        __syncthreads();
      }
      ROLL_MARK(13);
    }
    if (doE) {
      // d_t = dset(ls, a): into the FNN's ring (the oldest frame's slot) or
      // dT
      for (int i = tid; i < D * R; i += blockDim.x) {
        const int k = i >> lgR, r = i & mR;
        const float v = dom.dset_at(ls + r * SI,
                                    Domain::kDsetReadsAction ? act[r] : 0, k);
        if (kFnn) state[(head * D + k) * R + r] = v;
        else dT[i] = v;
      }
      if (kFnn) head = head + 1 == stack ? 0 : head + 1;
      __syncthreads();
      ROLL_MARK(5);
      if (kFnn) {
        prod_run(Prod{awr[0], awr[1], SD, H, (int)p.roll_split[3], kRelu,
                      state, D, stack, head, c1T, epart}, R, RP);
        prod_run(Prod{awr[2], awr[3], H, H, (int)p.roll_split[4], kRelu, c1T,
                      H, 1, 0, c2T, epart}, R, RP);
        prod_run(Prod{awr[4], awr[5], H, M, (int)p.roll_split[5], kNone, c2T,
                      H, 1, 0, lgT, epart}, R, RP);
      } else {
        gru_cell(p, awr, dT, state, c1T, c2T, lgT, epart, R, RP);
      }
      ROLL_MARK(6);
      // the Bernoulli draw of u: thread i = r * M + m
      if (tid < R * M) {
        const int r = tid / M, m = tid % M;
        float uu = 0.0f;
        if (r < nvalid)
          uu = uniform_from_bits(bv) < fast_sigmoid(lgT[m * R + r]) ? 1.0f
                                                                     : 0.0f;
        u[tid] = uu;
      }
      if (!kPolicy && !Domain::kDsetReadsAction && tid < R) act[tid] = av;
      ROLL_MARK(7);
    }
    // the action has reached the LS, u is drawn (where the d-set read the
    // action, the cluster met before it: only the AIP role's block waits)
    if (Domain::kDsetReadsAction && kPolicy) {
      if (doE) __syncthreads();
    } else {
      cross_sync(C);
    }
    ROLL_MARK(8);
    if (doE) {
      // LS tick and reward; the streamed done merges in the reset state
      if (tid < nvalid) {
        int* st = ls + tid * SI;
        p.rew_out[row0 + tid] =
            dom.tick(st, act[tid], u + tid * M, p.noise, row0 + tid);
        if (kPolicy) {
          edn[tid] = dv;
          if (dv) {
            const int* rl[kMaxLeaves];
            for (int k = 0; k < kMaxLeaves; ++k) rl[k] = p.reset_ls[k];
            // the reset leaves are (T, L, ...): lane index t*L + lane
            dom.load(rl, row0 + tid, st);
          }
        }
      }
      __syncthreads();
      ROLL_MARK(9);
      if (kPolicy) {
        // a reset lane's AIP state back to zeros; the next observation
        // to the policy's frames
        for (int i = tid; i < SD * R; i += blockDim.x)
          if (edn[i & mR]) state[i] = 0.0f;
        for (int i = tid; i < d_obs * R; i += blockDim.x) {
          const int k = i >> lgR, r = i & mR;
          obs_dst[i] = dom.obs_at(ls + r * SI, k);
        }
      }
      ROLL_MARK(10);
    }
    if (kPolicy) {
      cross_sync(C);   // the observation has reached the policy
      ROLL_MARK(11);
    }
    if (doP) {
      // the frame stack shifts by one observation; a reset lane restarts
      // from zeros and its reset observation
      const float* x = fr[fc];
      float* nx = fr[fc ^ 1];
      for (int i = tid; i < S * R; i += blockDim.x) {
        const int k = i >> lgR, r = i & mR;
        nx[i] = k >= S - d_obs ? obsT[(k - (S - d_obs)) * R + r]
                               : (pdn[r] ? 0.0f : x[(k + d_obs) * R + r]);
      }
      fc ^= 1;
      __syncthreads();
      ROLL_MARK(12);
    }
  }

  // ---- epilogue: final states out ----------------------------------------
  if (doE) {
    for (int r = tid; r < nvalid; r += blockDim.x)
      dom.store(p.ls_out, lane0 + r, ls + r * SI);
    for (int i = tid; i < nvalid * SD; i += blockDim.x) {
      const int r = i / SD, k = i % SD;
      int phys = k;
      if (kFnn) {
        const int j = k / D;
        const int s = head + j >= stack ? head + j - stack : head + j;
        phys = s * D + k % D;
      }
      p.s_out[(lane0 + r) * SD + k] = state[phys * R + r];
    }
  }
  if (doP) {
    for (int i = tid; i < nvalid * S; i += blockDim.x) {
      const int r = i / S, k = i % S;
      p.frames_out[(lane0 + r) * S + k] = fr[fc][k * R + r];
    }
  }
#ifdef IALS_ROLL_TIMELINE
  if (tid == 0)
    for (int i = 0; i < 16; ++i)
      reinterpret_cast<long long*>(p.h2)[blockIdx.x * 16 + i] = tl_sum[i];
#endif
}

// ---------------------------------------------------------------------------
// One GRU AIP tick (aip_step.py::aip_step): the horizon kernel's GRU role
// for a single tick, by the plan of rollout_plan(A, B, widths, "gru",
// false) (aip_step.py::step_plan), so a step and a one-tick rollout take
// the same K-parts and sum in the same order. What differs: d and h come
// from the batch-major (B, A, .) inputs, there is no LS tick, and h2,
// logits and u go back in that layout. The weights are staged into
// shared memory by bulk copies, as the horizon does, while d and h load;
// IALS_STEP_FROM_GLOBAL builds the other way, the products reading the
// weights from global memory with each chain's loads in flight together
// (chain_rows_ldg): tools/rollout_ablation.py aip_step times both, and
// staging is the faster at every shape it runs.
// ---------------------------------------------------------------------------

// The tile's rows of the batch-major d (width D) and h (width H), element
// row(r) * width + k, into the k-major tiles d^T and h^T, zeros past
// nvalid: a thread's loads of both (up to kLoadBatch) are all issued
// before its stores, so the tile waits on one round trip to memory
constexpr int kLoadBatch = 8;
template <class RowFn>
__device__ __forceinline__ void load_dh(float* dT, const float* d, int D,
                                        float* hT, const float* h, int H,
                                        int R, int nvalid, RowFn row) {
  const int nd = R * D, n = nd + R * H;
  for (int i0 = threadIdx.x; i0 < n; i0 += kLoadBatch * blockDim.x) {
    float v[kLoadBatch];
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      const bool isd = i < nd;
      const int w = isd ? D : H, e = isd ? i : i - nd, r = e / w;
      v[j] = i < n && r < nvalid
                 ? __ldg((isd ? d : h) + row(r) * w + (e - r * w)) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kLoadBatch; ++j) {
      const int i = i0 + j * blockDim.x;
      const bool isd = i < nd;
      const int w = isd ? D : H, e = isd ? i : i - nd, r = e / w;
      if (i < n) (isd ? dT : hT)[(e - r * w) * R + r] = v[j];
    }
  }
}

__global__ void __launch_bounds__(kRollMaxThreads, 1)
step_kernel(IalsArgs p, TrafficDomain) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
#ifdef IALS_ROLL_TIMELINE
  long long tl_sum[16] = {};
  long long tl_last = clock64();
#endif
  const RollLayout lay = roll_layout(p, false, false,
                                     TrafficDomain::kStateInts);
  {
    uint32_t dyn;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
    if ((uint32_t)lay.aip_bytes > dyn) __trap();   // plan and kernel disagree
  }
  auto ef = [&](int off) { return reinterpret_cast<float*>(smem_raw + off); };
  const int R = (int)p.roll_lanes, RP = (int)p.roll_rows_per_thread;
  const int A = (int)p.A, D = (int)p.D, H = (int)p.H, M = (int)p.M;
  const long long B = p.B;
  const int per_agent = (int)((B + R - 1) / R);
  const int agent = (int)blockIdx.x / per_agent;
  const int b0 = ((int)blockIdx.x % per_agent) * R;
  const int nvalid = (int)min((long long)R, B - b0);
  const int tid = threadIdx.x;
  // lane r of the tile is row (b0 + r) * A + agent of the (B, A, .) inputs
  auto row = [&](int r) { return (long long)(b0 + r) * A + agent; };
  float* hT = ef(lay.state);
  float* dT = ef(lay.d);
  const int n[5] = {D * 3 * H, H * 3 * H, 3 * H, H * M, M};
  const float* w[5];
  for (int i = 0; i < 5; ++i) w[i] = p.aw[i] + (size_t)agent * n[i];
#ifndef IALS_STEP_FROM_GLOBAL
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + lay.ebar);
  float* aw[5];
  for (int i = 0; i < 5; ++i) aw[i] = ef(lay.aw[i]);
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stage_pieces(aw, w, n, 5, bar);
  for (int i = 0; i < 5; ++i) w[i] = aw[i];
#endif
  const int br = tid / M, bm = tid - br * M;   // the draw: thread r M + m
  const int bv = tid < nvalid * M ? __ldg(p.bits + row(br) * M + bm) : 0;
  load_dh(dT, p.d, D, hT, p.h, H, R, nvalid, row);
  ROLL_MARK(0);
#ifndef IALS_STEP_FROM_GLOBAL
  mbar_wait(bar, 0);
  constexpr bool kFromGlobal = false;
#else
  constexpr bool kFromGlobal = true;
#endif
  __syncthreads();
  ROLL_MARK(1);
  gru_cell<kFromGlobal>(p, w, dT, hT, ef(lay.c1), ef(lay.c2), ef(lay.lg),
                        ef(lay.epart), R, RP);
  ROLL_MARK(2);
  if (tid < nvalid * M) {
    const float lg = ef(lay.lg)[bm * R + br];
    const long long o = row(br) * M + bm;
    p.logits[o] = lg;
    p.u[o] = uniform_from_bits(bv) < fast_sigmoid(lg) ? 1.0f : 0.0f;
  }
  for (int i = tid; i < nvalid * H; i += blockDim.x) {
    const int r = i / H, k = i - r * H;
    p.h2[row(r) * H + k] = hT[k * R + r];
  }
#ifdef IALS_ROLL_TIMELINE
  // the sums go to the int64 buffer behind p.frames_out (a step has none)
  ROLL_MARK(3);
  if (tid == 0)
    for (int i = 0; i < 16; ++i)
      reinterpret_cast<long long*>(p.frames_out)[blockIdx.x * 16 + i] =
          tl_sum[i];
#endif
}

// A plan the kernel cannot run is refused, never adapted: the plan is
// aip_step.py::rollout_plan's, and the wrapper raises on the error. kStep
// launches step_kernel (the GRU role, one tick, no LS) on the plan of the
// GRU horizon without the policy; otherwise the horizon kernel carries the
// LS functor dom.
template <bool kFnn, bool kPolicy, bool kStep, class Domain>
int launch_roll(const IalsArgs* a, void* stream, const Domain& dom) {
  const long long R = a->roll_lanes, C = a->roll_cluster;
  const long long nt = a->roll_threads;
  bool ok = (R == 1 || R == 2 || R == 4 || R == 8 || R == 16 || R == 32) &&
            a->roll_rows_per_thread == (R < 4 ? R : 4) &&
            (C == 1 || (kPolicy && C == 2)) && nt % 32 == 0 && nt >= 32 &&
            nt <= kRollMaxThreads && nt >= R * a->M && nt >= R &&
            (!kPolicy || (nt >= R * a->n_act && a->n_act >= 1 &&
                          a->obs_dim >= 1 && a->obs_dim <= a->S)) &&
            a->A >= 1 && a->B >= 1 && a->D >= 1 && a->H >= 1 && a->M >= 1 &&
            (!kFnn || a->stack >= 1) && a->roll_smem <= kRollMaxSmem &&
            a->T >= 0;
  for (int i = 0; i < 6; ++i)
    ok = ok && a->roll_split[i] >= 1 && a->roll_split[i] <= kRollMaxSplit;
  if (!kStep) ok = ok && dom.valid(*a, kPolicy);
  if (!ok) return (int)cudaErrorInvalidValue;
  const RollLayout lay = roll_layout(*a, kFnn, kPolicy, Domain::kStateInts);
  const int need = C == 2 ? imax(lay.pol_bytes, lay.aip_bytes)
                          : lay.pol_bytes + lay.aip_bytes;
  if (need > a->roll_smem) return (int)cudaErrorInvalidValue;
  void (*k)(IalsArgs, Domain) = horizon_kernel<kFnn, kPolicy, Domain>;
  if constexpr (kStep) k = step_kernel;
  static int raised[kRollMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kRollMaxDevices || a->roll_smem > raised[dev]) {
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)a->roll_smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < kRollMaxDevices) raised[dev] = (int)a->roll_smem;
  }
  const long long tiles = a->A * ((a->B + R - 1) / R);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * C));
  cfg.blockDim = dim3((unsigned)nt);
  cfg.dynamicSmemBytes = (size_t)a->roll_smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k, *a, dom);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// one explicit instantiation per LS domain (IalsArgs::domain: 0 traffic,
// 1 warehouse); any other domain is refused. The step has no LS.
template <bool kFnn, bool kPolicy, bool kStep = false>
int launch_horizon(const IalsArgs* a, void* stream) {
  if (a->domain == 0)
    return launch_roll<kFnn, kPolicy, kStep>(a, stream, traffic_of(*a));
  if constexpr (!kStep) {
    if (a->domain == 1)
      return launch_roll<kFnn, kPolicy, false>(a, stream, warehouse_of(*a));
  }
  return (int)cudaErrorInvalidValue;
}
}  // namespace

extern "C" {

int ials_aip_step(const IalsArgs* args, void* stream) {
  return launch_horizon<false, false, true>(args, stream);
}

int ials_aip_rollout_multi(const IalsArgs* args, void* stream) {
  return launch_horizon<false, false>(args, stream);
}

int ials_fnn_rollout(const IalsArgs* args, void* stream) {
  return launch_horizon<true, false>(args, stream);
}

int ials_policy_rollout_gru(const IalsArgs* args, void* stream) {
  return launch_horizon<false, true>(args, stream);
}

int ials_policy_rollout_fnn(const IalsArgs* args, void* stream) {
  return launch_horizon<true, true>(args, stream);
}

int ials_args_size(void) { return (int)sizeof(IalsArgs); }

}  // extern "C"
