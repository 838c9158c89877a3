// Hand-written Hopper (sm_90a) kernel of the fused GRU sequence: the CUDA
// counterpart of the Pallas TPU kernel src/repro/kernels/gru.py::
// gru_sequence (its body gru.py:26-47, wrapper gru.py:50-78).
//
//   gru_sequence_run <- gru.py::gru_sequence
//
// What it computes: x (B, T, D) float32 or bfloat16, wx (D, 3H), wh (H,
// 3H), b (3H,), h0 (B, H) in float32, gate-major [r|z|n] -> hs (B, T, H)
// in x's dtype: per tick gx = x_t @ wx + b, gh = h @ wh, then gates.cuh's
// gru_gate (the rational gates shared with the IALS kernels); h carries
// on in float32 and hs is rounded once to x's dtype. Plain C entry point,
// bound with ctypes in repro_torch/kernels/gru.py, launched by the plan
// of gru.py::gru_plan (which it refuses, never adapts, if it cannot run
// it) on the caller's stream; returns cudaGetLastError().
//
// What bounds it on this card. The operations are 2 B T (D + H) 3H (5.2
// GFLOP at the traffic AIP's widths, B = 1024, T = 128, D = 40, H = 64:
// 0.078 ms at 67 TFLOP/s), the bytes far less; but the T ticks depend on
// one another, so the time is T times one tick on the SMs that hold the
// rows. The first version (tools/gru_first_version.cu) spent 5.7 us a
// tick there: x_t loaded at the tick's start, x_t @ wx in the same
// 104-step chain as h @ wh, 9 scalar shared loads for 8 FMAs, 192 of 256
// threads at work, three block barriers. Inside a tick the SM's
// shared-memory pipe and its issue slots are the limit: every lane reads
// the activations it multiplies (a 16-byte load costs a quarter warp a
// cycle, broadcast or not), and the part sums cross lanes by shuffles on
// the same pipe (tools/gru_ablation.py).
//
// Design.
//  - A tile is `rows` (R in {1, 2, 4, 8}) batch rows, the fewest whose
//    grid fits one wave of the 132 SMs: 8 at B = 1024 (128 blocks).
//  - A thread owns U hidden units (`units_per_thread`, 1 but in an
//    ablation) and one K-part p of `parts` (P): the r, z and n columns
//    of its unit over the part's k-steps of both products, for all R
//    rows of the tile. P consecutive lanes of a warp hold the P parts of
//    a unit; H x P threads, every one at work (512 at H = 64, P = 8).
//  - Weights in registers (route "registers", H and D up to 64): each
//    thread loads its 3 x (KH + KX) weights once a launch (KH = 8 steps
//    of h @ wh, zeros past H; KX = ceil(D / P) steps of x @ wx, a
//    compile-time count, so that no step is wasted). The loops are fully
//    unrolled, without a branch, so their loads run ahead of the FMAs. A
//    k-step is two 16-byte broadcast loads of the tile's 8 activations
//    (stored k-major, h^T and x^T) feeding 24 FMAs. Wider layers take
//    route "l2": the same body, each weight read through L1/L2 at its
//    k-step, units in passes of at most 512 / P threads.
//  - The P parts are summed across the lanes by shuffles, in a fixed tree
//    (part p with p + P/2, then with p + P/4, ...), halving the rows each
//    lane keeps on the way (a reduce-scatter), so afterwards a lane holds
//    the three full sums of its unit's rows (R / P of them) and runs
//    their gate update in registers: no shared partial sums, no barrier
//    for them, and every launch adds in the same order (repeats bitwise).
//  - x @ wx + b off the recurrence: it does not depend on h, so a tick
//    runs h @ wh, its sums and the gates first, then gx of the next tick,
//    kept in registers (route "l2" computes gx in its own tick, first).
//    x_{t+2} is loaded into registers at the start of tick t and stored
//    to a ring of three x^T buffers at its end, so no tick waits on
//    device memory.
//  - One block barrier a tick: the new h goes to the other of two h^T
//    buffers, whose K-parts sit a bank group apart (part_stride), each
//    part's rows in the order its lanes keep them in the sum (Reduce).
// Ablation builds (tools/gru_ablation.py): GRU_X_IN_CHAIN computes gx of
// tick t in tick t, before h @ wh, as route "l2" does; GRU_SCALAR_READS
// reads the activations one float at a time; GRU_X_PADDED walks KH steps
// of x @ wx too (the extra ones against zero weights); GRU_UNITS=2 gives a
// thread two units (256 threads; the plan's units_per_thread says so);
// GRU_REG_PARTS=4 with GRU_REG_STEPS=16 holds the weights over 4 parts
// (256 threads; the plan's parts say so) (all five give the kernel's
// bits but the last, whose sums run in another order); GRU_NO_PRODUCTS
// leaves the products out (timing only: the floor of a tick);
// GRU_TIMELINE sums clock64() cycles per phase of a tick on thread 0 of
// block 0 (gru_timeline_read).
//
// Arithmetic is float32 throughout: each part's products are one fmaf
// chain in k order, the parts are summed with __fadd_rn, the bias is
// added after the sum (as x @ wx + b rounds), and the gates round as
// torch's elementwise ops (gates.cuh). Only the order of the matrix
// products' sums differs from the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gates.cuh"
#include "smem.cuh"

// The one argument of the entry point, mirrored by ctypes in
// repro_torch/kernels/gru.py::GruArgs (every field 8 bytes); at file
// scope, so that the C entry point taking it keeps external linkage. The
// plan's fields are gru.py::gru_plan's.
struct GruArgs {
  const void* x;       // (B, T, D) float32 or bfloat16
  const float* wx;     // (D, 3H)
  const float* wh;     // (H, 3H)
  const float* b;      // (3H,)
  const float* h0;     // (B, H)
  void* hs;            // (B, T, H) in x's dtype
  long long B, T, D, H, bf16;
  long long rows, parts, units_per_thread, units, threads, route, smem;
};

namespace {

constexpr int kGruMaxSmem = 232448;   // dynamic shared bytes a block may use
constexpr int kGruPrefetch = 2;       // x elements a thread carries a tick
#ifdef GRU_REG_PARTS
constexpr int kRegParts = GRU_REG_PARTS;   // route "registers": P
constexpr int kRegSteps = GRU_REG_STEPS;   //   k-steps a part holds
#else
constexpr int kRegParts = 8;
constexpr int kRegSteps = 8;
#endif
#ifdef GRU_UNITS
constexpr int kRegUnits = GRU_UNITS;  //   units a thread (an ablation)
#else
constexpr int kRegUnits = 1;          //   units a thread
#endif

// threads a block of each route may have (its __launch_bounds__)
__host__ __device__ constexpr int max_threads(bool reg, int U) {
  return reg && (U == 2 || kRegParts < 8) ? 256 : 512;
}

__host__ __device__ inline int ceil_div(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

// Floats from one K-part's first k-row of h^T or x^T to the next part's:
// the part's kl k-rows of R floats, rounded up to 32 words, plus one
// vector (4 floats, or R below 4), so that the P parts' broadcast loads of
// one k-step fall on distinct banks (without it they all hit the same
// four and every 16-byte load of a quarter warp is replayed P times).
__host__ __device__ inline long long part_stride(long long kl, long long R) {
  return (kl * R + 31) / 32 * 32 + (R < 4 ? R : 4);
}

// k-rows a part of h^T spans: its ceil(H / P) k-steps, or on route
// "registers" the kRegSteps its unrolled loop walks (zeros past H)
__host__ __device__ inline long long h_rows(long long H, long long P,
                                            bool reg) {
  return reg ? kRegSteps : ceil_div(H, P);
}

// Floats of a block's shared memory: h^T (two buffers of P parts), x^T
// (a ring of three buffers of P parts of ceil(D / P) k-rows);
// gru.py::gru_smem computes the same.
__host__ __device__ inline long long gru_smem_floats(long long R, long long P,
                                                     long long D, long long H,
                                                     bool reg) {
  return 2 * P * part_stride(h_rows(H, P, reg), R) +
         3 * P * part_stride(ceil_div(D, P), R);
}

// The R activations of one k-row, as 16-byte vector loads (GRU_SCALAR_READS:
// one float at a time)
template <int R>
__device__ __forceinline__ void load_act(float (&v)[R], const float* a) {
#ifdef GRU_SCALAR_READS
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = a[r];
#else
  load_vec<R>(v, a);
#endif
}

// acc[c][r] = sum over the part's k of act[k][r] * W[k][column c], one
// fmaf chain per (c, r) in k order, for the G = 3U columns of the lane's
// units. `act` points at the part's first k-row of the k-major
// activations (row stride R). Route "registers" (STEPS > 0): the weights
// w[c][i], all STEPS steps unrolled, no branch. Route "l2" (STEPS == 0,
// G == 3): kv steps with each weight read from global memory (wg at the
// part's first k-row, column j; kv 0 for a pad lane).
template <int R, int G, int KW, int STEPS>
__device__ __forceinline__ void part_product(float (&acc)[G][R],
                                             const float* act,
                                             const float (&w)[G][KW],
                                             const float* wg, int ldw,
                                             int H, int kv) {
#pragma unroll
  for (int c = 0; c < G; ++c)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[c][r] = 0.0f;
  if constexpr (STEPS > 0) {
    (void)wg;
    (void)kv;   // the part's own steps (read by GRU_X_PADDED only)
#ifndef GRU_NO_PRODUCTS
#pragma unroll
    for (int i = 0; i < STEPS; ++i) {
      float v[R];
#ifdef GRU_X_PADDED
      // the padded steps reread the part's last row (times zero weights),
      // as many loads as rows of zeros would cost
      load_act<R>(v, act + min(i, kv - 1) * R);
#else
      load_act<R>(v, act + i * R);
#endif
#pragma unroll
      for (int c = 0; c < G; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[c][r] = fmaf(v[r], w[c][i], acc[c][r]);
    }
#endif
  } else {
    static_assert(G == 3, "route l2 gives a thread one unit");
    (void)w;
#ifdef GRU_NO_PRODUCTS
    kv = 0;
#endif
#pragma unroll 2
    for (int i = 0; i < kv; ++i) {
      float v[R];
      load_act<R>(v, act + i * R);
      const float* wk = wg + (size_t)i * ldw;
      const float wv[3] = {__ldg(wk), __ldg(wk + H), __ldg(wk + 2 * H)};
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[c][r] = fmaf(v[r], wv[c], acc[c][r]);
    }
  }
}

// The sum over the P lanes of a unit group (lanes p ^ M, M = P/2, P/4,
// ..., 1): while a lane holds N > 1 rows it keeps half (the upper half
// where bit M of p is set) and adds the partner's copy of that half; with
// one row left the partners exchange and both add (x + y == y + x
// bitwise). A lane ends with the full sums of rows [row0, row0 + R/P)
// (one row when P > R) in a[.][0 ...]; every sum is the tree (p +
// p^(P/2)) + ... Each part's lanes read their rows in the order
// row ^ row0 (the kernel's layout of h^T and x^T), so the half a lane
// keeps is always a[.][0, N/2) and the partner's copy of it its
// a[.][N/2, N): no select.
template <int G, int R, int N, int M>
struct Reduce {
  static __device__ __forceinline__ void run(float (&a)[G][R]) {
    if constexpr (M > 0) {
      if constexpr (N > 1) {
        constexpr int half = N / 2;
#pragma unroll
        for (int c = 0; c < G; ++c)
#pragma unroll
          for (int i = 0; i < half; ++i)
            a[c][i] = __fadd_rn(
                a[c][i], __shfl_xor_sync(0xffffffffu, a[c][half + i], M));
        Reduce<G, R, half, M / 2>::run(a);
      } else {
#pragma unroll
        for (int c = 0; c < G; ++c)
          a[c][0] = __fadd_rn(a[c][0],
                              __shfl_xor_sync(0xffffffffu, a[c][0], M));
        Reduce<G, R, 1, M / 2>::run(a);
      }
    }
  }
};

#ifdef GRU_TIMELINE
// phase sums of thread 0 of block 0, in cycles, by mark: 0 prologue, 1 x
// prefetch issue, 2 h @ wh, 3 its sum over parts, 6 gates and stores, 4
// x @ wx of the next tick and its sum (5: of this tick, before h @ wh, on
// route "l2" and with GRU_X_IN_CHAIN), 7 x store, 8 barrier
__device__ long long gru_timeline_cycles[16];
#define GRU_MARK(i)                     \
  do {                                  \
    if (tl_on) {                        \
      const long long now_ = clock64(); \
      tl_sum[i] += now_ - tl_last;      \
      tl_last = now_;                   \
    }                                   \
  } while (0)
#else
#define GRU_MARK(i) \
  do {              \
  } while (0)
#endif

__device__ __forceinline__ float load_x(const GruArgs& a, size_t i) {
  return a.bf16 ? __bfloat162float(
                      reinterpret_cast<const __nv_bfloat16*>(a.x)[i])
                : reinterpret_cast<const float*>(a.x)[i];
}

// The kernel. Route "registers": P = kRegParts, U = kRegUnits, KX the
// x @ wx steps of a part (ceil(D / P)); route "l2": KX == 0, U == 1.
template <int R, int P, int U, int KX>
__global__ void __launch_bounds__(max_threads(KX > 0, U), 1)
gru_seq_kernel(GruArgs a) {
  constexpr bool kReg = KX > 0;
  constexpr int G = 3 * U;                   // columns a lane multiplies
  constexpr int KH = kReg ? kRegSteps : 1;   // register weights a column
#ifdef GRU_X_PADDED
  constexpr int KXS = kReg ? KH : 0;         // x steps walked (ablation)
#else
  constexpr int KXS = kReg ? KX : 0;
#endif
  constexpr int KXR = KXS > 0 ? KXS : 1;     // x weights a column
  constexpr int NR = R >= P ? R / P : 1;     // rows a lane owns
  constexpr int DUP = R >= P ? 1 : P / R;    // lanes that share them
  extern __shared__ __align__(16) float smem[];
#ifdef GRU_TIMELINE
  const bool tl_on = threadIdx.x == 0 && blockIdx.x == 0;
  long long tl_sum[16] = {};
  long long tl_last = clock64();
#endif
  const int H = (int)a.H, D = (int)a.D, T = (int)a.T, G3 = 3 * H;
  const int klh = ceil_div(H, P), klx = ceil_div(D, P);
  const int PSh = (int)part_stride(h_rows(H, P, kReg), R);
  const int PSx = (int)part_stride(klx, R);
  const int HB = P * PSh, XB = P * PSx;   // floats of an h^T, x^T buffer
  {
    uint32_t dyn;
    asm("mov.u32 %0, %%dynamic_smem_size;" : "=r"(dyn));
    if (4 * gru_smem_floats(R, P, D, H, kReg) > dyn) __trap();   // plan
  }
  // h^T buffer s at hT + s * HB, x^T ring slot s at xT + s * XB
  float* hT = smem;
  float* xT = smem + 2 * HB;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int p = tid % P, ju = tid / P;      // part, unit group
  const int units = (int)a.units;           // units a pass
  const int passes = ceil_div(H, units);
  const int b0 = blockIdx.x * R;
  const int nvalid = min((long long)R, a.B - b0);
  const int row0 = (p / DUP) * NR;
  const bool writer = p % DUP == 0;
  // where (k-row k, row r) of h^T or x^T sits: part k / kl, its k-row,
  // and row r at r ^ the first row the part's lanes keep (Reduce)
  auto at = [&](int k, int r, int kl, int stride) {
    const int part = k / kl;
    return part * stride + (k - part * kl) * R + (r ^ ((part / DUP) * NR));
  };

  // ---- prologue: zeros (pad rows and k-steps stay zero), h0, x_0, x_1 --
  for (int i = tid; i < (int)gru_smem_floats(R, P, D, H, kReg);
       i += nthreads)
    smem[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < nvalid * H; i += nthreads) {
    const int r = i / H, k = i - r * H;
    hT[at(k, r, klh, PSh)] = a.h0[(size_t)(b0 + r) * H + k];
  }
  const int nx = nvalid * D;
  for (int t = 0; t < min(T, 2); ++t)
    for (int i = tid; i < nx; i += nthreads) {
      const int r = i / D, k = i - r * D;
      xT[t * XB + at(k, r, klx, PSx)] =
          load_x(a, ((size_t)(b0 + r) * T + t) * D + k);
    }
  // this thread's weights and biases (route "registers": one pass, the
  // units U ju + u); zeros past H and D
  float whr[G][KH], wxr[G][KXR], bias[G];
#pragma unroll
  for (int c = 0; c < G; ++c) {
    const int j = U * ju + c / 3, col = (c % 3) * H + j;
    bias[c] = kReg && j < H ? a.b[col] : 0.0f;
#pragma unroll
    for (int i = 0; i < KH; ++i) {
      const int k = p * klh + i;
      whr[c][i] = kReg && j < H && i < klh && k < H
                      ? a.wh[(size_t)k * G3 + col] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < KXR; ++i) {
      const int k = p * klx + i;
      wxr[c][i] = kReg && j < H && i < klx && k < D
                      ? a.wx[(size_t)k * G3 + col] : 0.0f;
    }
  }
  __syncthreads();

  // gx = x @ wx + b of the lane's units (from j0) for the x^T in ring
  // slot `slot`: the part's products, summed over the parts, the bias
  // added -> the lane's rows in out
  auto gx_of = [&](int slot, int j0, float (&out)[G][NR]) {
    const bool real = ju < units && j0 < H;
    const int jc = real ? j0 : 0, kx0 = p * klx;
    float ax[G][R];
    part_product<R, G, KXR, KXS>(
        ax, xT + slot * XB + p * PSx, wxr, a.wx + (size_t)kx0 * G3 + jc,
        G3, H, kReg ? klx : (real ? max(0, min(klx, D - kx0)) : 0));
    Reduce<G, R, R, P / 2>::run(ax);
#pragma unroll
    for (int c = 0; c < G; ++c)
#pragma unroll
      for (int i = 0; i < NR; ++i)
        out[c][i] = __fadd_rn(ax[c][i],
                              kReg ? bias[c] : __ldg(a.b + c * H + jc));
  };
#ifdef GRU_X_IN_CHAIN
  constexpr bool kAhead = false;
#else
  constexpr bool kAhead = kReg;   // gx computed a tick ahead
#endif
  float gxr[G][NR];   // route "registers": gx of the coming tick
  if constexpr (kAhead) gx_of(0, U * ju, gxr);

  // ---- the ticks ---------------------------------------------------------
  GRU_MARK(0);
  int xc = 0;   // ring slot of x_t
  // the x elements this thread carries each tick: where each sits in a
  // ring slot and in x at tick 0 (-1: none), worked out once
  int xs_off[kGruPrefetch];
  size_t xg_off[kGruPrefetch];
#pragma unroll
  for (int q = 0; q < kGruPrefetch; ++q) {
    const int i = tid + q * nthreads;
    const int r = i / D, k = i - r * D;
    xs_off[q] = i < nx ? at(k, r, klx, PSx) : -1;
    xg_off[q] = (size_t)(b0 + r) * T * D + k;
  }
  float xv[kGruPrefetch];
  for (int t = 0; t < T; ++t) {
    const float* hc = hT + (t & 1) * HB;
    float* hn = hT + ((t + 1) & 1) * HB;
    const int x1 = xc == 2 ? 0 : xc + 1, x2 = x1 == 2 ? 0 : x1 + 1;
    float* xn = xT + x2 * XB;   // where x_{t+2} goes
    // x_{t+2}: loads issued now, stored at the tick's end (past a fixed
    // count a thread, stored at once: that ring slot was last read in
    // tick t - 1)
    const bool fetch = t + 2 < T;
#pragma unroll
    for (int q = 0; q < kGruPrefetch; ++q) {
      xv[q] = 0.0f;
      if (fetch && xs_off[q] >= 0)
        xv[q] = load_x(a, xg_off[q] + (size_t)(t + 2) * D);
    }
    if (fetch)
      for (int i = tid + kGruPrefetch * nthreads; i < nx; i += nthreads) {
        const int r = i / D, k = i - r * D;
        xn[at(k, r, klx, PSx)] =
            load_x(a, ((size_t)(b0 + r) * T + t + 2) * D + k);
      }
    GRU_MARK(1);
    for (int pass = 0; pass < passes; ++pass) {
      const int j0 = pass * units + U * ju;   // the lane's first unit
      const bool real = ju < units && j0 < H;
      const int kh0 = p * klh;
      float gx[G][NR];   // gx of this tick
      if constexpr (kAhead) {
#pragma unroll
        for (int c = 0; c < G; ++c)
#pragma unroll
          for (int i = 0; i < NR; ++i) gx[c][i] = gxr[c][i];
      } else {
        gx_of(xc, j0, gx);
        GRU_MARK(5);
      }
      float ah[G][R];
      part_product<R, G, KH, kReg ? KH : 0>(
          ah, hc + p * PSh, whr, a.wh + (size_t)kh0 * G3 + (real ? j0 : 0),
          G3, H, kReg ? KH : (real ? max(0, min(klh, H - kh0)) : 0));
      GRU_MARK(2);
      Reduce<G, R, R, P / 2>::run(ah);
      GRU_MARK(3);
      // the gate updates of the lane's units and rows, in registers; a pad
      // lane computes on unit 0 and writes nothing
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u;
        const bool own = real && writer && j < H;
#pragma unroll
        for (int i = 0; i < NR; ++i) {
          const int r = row0 + i;
          const int pos = at(own ? j : 0, r, klh, PSh);
          const float h = gru_gate(gx[3 * u][i], gx[3 * u + 1][i],
                                   gx[3 * u + 2][i], ah[3 * u][i],
                                   ah[3 * u + 1][i], ah[3 * u + 2][i],
                                   hc[pos]);
          if (own) hn[pos] = h;
          if (own && r < nvalid) {
            const size_t o = ((size_t)(b0 + r) * T + t) * H + j;
            if (a.bf16)
              reinterpret_cast<__nv_bfloat16*>(a.hs)[o] =
                  __float2bfloat16_rn(h);
            else
              reinterpret_cast<float*>(a.hs)[o] = h;
          }
        }
      }
      GRU_MARK(6);
      if constexpr (kAhead) {
        // x_{t+1} @ wx + b, independent of h: after the gates in program
        // order, so that its loads and FMAs fill their latency
        gx_of(x1, j0, gxr);
        GRU_MARK(4);
      }
    }
#pragma unroll
    for (int q = 0; q < kGruPrefetch; ++q)
      if (fetch && xs_off[q] >= 0) xn[xs_off[q]] = xv[q];
    xc = x1;
    GRU_MARK(7);
    __syncthreads();
    GRU_MARK(8);
  }
#ifdef GRU_TIMELINE
  if (tl_on)
    for (int i = 0; i < 16; ++i) gru_timeline_cycles[i] = tl_sum[i];
#endif
}

using GruKernel = void (*)(GruArgs);

// route "registers": one instantiation per rows a tile and x @ wx steps
template <int R, int KX>
GruKernel reg_kernel() {
  if constexpr (KX <= kRegSteps)
    return &gru_seq_kernel<R, kRegParts, kRegUnits, KX>;
  else
    return nullptr;
}

template <int R>
GruKernel pick_registers(long long kx) {
  switch (kx) {
    case 1: return reg_kernel<R, 1>();
    case 2: return reg_kernel<R, 2>();
    case 3: return reg_kernel<R, 3>();
    case 4: return reg_kernel<R, 4>();
    case 5: return reg_kernel<R, 5>();
    case 6: return reg_kernel<R, 6>();
    case 7: return reg_kernel<R, 7>();
    case 8: return reg_kernel<R, 8>();
    case 9: return reg_kernel<R, 9>();
    case 10: return reg_kernel<R, 10>();
    case 11: return reg_kernel<R, 11>();
    case 12: return reg_kernel<R, 12>();
    case 13: return reg_kernel<R, 13>();
    case 14: return reg_kernel<R, 14>();
    case 15: return reg_kernel<R, 15>();
    case 16: return reg_kernel<R, 16>();
    default: return nullptr;
  }
}

// route "l2": one per rows a tile and parts
template <int R>
GruKernel pick_l2(long long P) {
  switch (P) {
    case 1: return &gru_seq_kernel<R, 1, 1, 0>;
    case 2: return &gru_seq_kernel<R, 2, 1, 0>;
    case 4: return &gru_seq_kernel<R, 4, 1, 0>;
    case 8: return &gru_seq_kernel<R, 8, 1, 0>;
    default: return nullptr;
  }
}

template <int R>
GruKernel pick_route(const GruArgs& a) {
  return a.route == 0 ? pick_registers<R>(ceil_div(a.D, a.parts))
                      : pick_l2<R>(a.parts);
}

GruKernel pick_kernel(const GruArgs& a) {
  switch (a.rows) {
    case 1: return pick_route<1>(a);
    case 2: return pick_route<2>(a);
    case 4: return pick_route<4>(a);
    case 8: return pick_route<8>(a);
    default: return nullptr;
  }
}

bool pow2_upto8(long long v) { return v == 1 || v == 2 || v == 4 || v == 8; }

// The plan is gru.py::gru_plan's; one this body cannot run is refused.
bool plan_ok(const GruArgs& a) {
  const long long P = a.parts, H = a.H, D = a.D, U = a.units_per_thread;
  const bool reg = a.route == 0;
  if (a.B < 1 || a.T < 1 || D < 1 || H < 1 || !pow2_upto8(a.rows) ||
      !pow2_upto8(P) || (a.route != 0 && a.route != 1))
    return false;
  if (reg ? (P != kRegParts || U != kRegUnits || a.units != H ||
             ceil_div(H, P) > kRegSteps || ceil_div(D, P) > kRegSteps)
          : (U != 1 || a.units < 1 || a.units > H))
    return false;
  return a.threads == 32 * ceil_div(ceil_div(a.units, U) * P, 32) &&
         a.threads <= max_threads(reg, (int)U) &&
         a.smem == 4 * gru_smem_floats(a.rows, P, D, H, reg) &&
         a.smem <= kGruMaxSmem;
}

}  // namespace

extern "C" {

int gru_sequence_run(const GruArgs* a, void* stream) {
  if (!plan_ok(*a)) return (int)cudaErrorInvalidValue;
  const GruKernel k = pick_kernel(*a);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  if (a->smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)a->smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned grid = (unsigned)((a->B + a->rows - 1) / a->rows);
  k<<<grid, (unsigned)a->threads, (size_t)a->smem, (cudaStream_t)stream>>>(
      *a);
  return (int)cudaGetLastError();
}

int gru_args_size(void) { return (int)sizeof(GruArgs); }

#ifdef GRU_TIMELINE
// the phase sums of the last launch (the ablation build's own entry)
int gru_timeline_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, gru_timeline_cycles,
                                   sizeof(gru_timeline_cycles));
}
#endif

}  // extern "C"
