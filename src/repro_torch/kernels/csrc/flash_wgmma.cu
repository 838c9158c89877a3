// Hand-written Hopper (sm_90a) flash-attention forward on the tensor cores:
// the bf16 route of the CUDA counterpart of
//
//   src/repro/kernels/flash_attention.py::flash_attention (the Pallas TPU
//   kernel) and, through strides, its GQA wrapper
//   src/repro/kernels/ops.py::flash_attention_mha.
//
// Plain C entry point layer_flash_attention_tc, bound with ctypes in
// repro_torch/kernels/flash_attention.py; it launches on the caller's
// stream and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// shape it does not take, or for a tensor map cuTensorMapEncodeTiled
// refuses).
//
// Routing (flash_attention.py::tensor_core_route, a pure function of dtype
// and widths): bf16 inputs with D and Dv multiples of 16 up to 256 take
// this kernel; float32 inputs and every other width take the CUDA-core
// kernel of layer_kernels.cu. A refused launch raises; nothing falls back.
//
// Semantics are the reference's: s = (q k^T) * scale in f32 (the plain
// version's order: bf16 products are exact in f32, so this differs from
// the Pallas kernel's `q * scale` first by f32 rounding only), causal mask
// q_idx >= k_idx with no offset, masked scores -1e30, p = 0 where s <=
// -1e30 / 2, alpha = exp(m_prev - m_new) with expf, l summed from the f32
// p, out = acc / max(l, 1e-20) rounded once to bf16. Keys past S are
// masked the same way, and rows past T are never stored.
//
// What bounds it on this card: operations, 4 T S D per head (half under
// the causal mask) at the bf16 tensor-core rate (989 TFLOP/s dense); at
// qwen3_4b widths the bytes' bound is 5.5x below it. The kernel's own work is
// 1.5x the function's (P V twice, below), and the softmax's f32 ALU work
// (an accurate expf per score) competes with it. The design:
//  - one block per (batch, query head, 128-row query tile): two consumer
//    warpgroups own 64 rows each and run wgmma; a producer warpgroup, of
//    which one thread starts every copy with TMA (cp.async.bulk.tensor),
//    gives its registers to the consumers (setmaxnreg 24 / 240: ptxas
//    allocates up to 240 in the consumer code);
//  - K and V tiles of BK keys come through a ring of up to 4 stages in
//    shared memory with full/empty mbarriers, each tile as 64-column boxes
//    with 128-byte swizzle, the layout wgmma's descriptors read. BK is 64
//    (32 at Dv > 128): O, S and P of one tile live at once in a
//    consumer's registers, and ptxas held the consumers near 168 of them
//    (96 and 128 keys spilled). Query head h reads KV head
//    h / group in place through 4-D tensor maps over (column, row, head,
//    batch), built on the host from FlashArgs' strides; TMA fills rows
//    past T or S with zeros;
//  - S = Q K^T is wgmma with both operands in shared memory (K-major) into
//    f32 registers; the row max and sum live in the accumulator's quad of
//    threads (two shuffles);
//  - P V runs twice on the tensor cores: p (f32) is split into hi =
//    bf16(p) and lo = bf16(p - hi), both register-A wgmmas against V
//    (N-major: the transpose bit) into the one f32 O accumulator. A single
//    bf16 rounding of p moves outputs by up to 0.0078 at T = 1024 (four
//    bf16 ulps of a value near 0.3), past the 1e-4 + one-ulp tolerance
//    against the f32-p reference; the split leaves about 2^-17 of p,
//    below the output's own rounding;
//  - overlap: a consumer starts S_j and P_{j-1} V_{j-1} together and runs
//    the softmax of S_j while P_{j-1} V_{j-1} is still on the tensor
//    cores, and beside the other consumer's products. The mask test is
//    skipped where every row max of the warp is a real score (expf then
//    gives the masked scores 0 exactly);
//  - causal: tiles wholly above the diagonal are never loaded, only the
//    tiles the diagonal crosses are masked, and the longest query tiles
//    are scheduled first (grid y reversed, every head's tile in one wave).

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_args.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kBox = 64;           // bf16 columns per TMA box (128 bytes)
constexpr int kLine = 128;         // bytes per box row
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of `bar` with this parity has completed. A wait
// that never ends (a protocol fault) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (spin == (1u << 28)) __trap();
  }
}

// One box of a 4-D tensor map (column, row, head, batch) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), swizzle mode 1.
// K-major (Q, K): rows are 128-byte lines, 8-row groups 1024 bytes apart
// (SBO); a k16 step inside the 64-column box adds 32 bytes to the start.
// N-major (V): LBO steps from one 64-column box to the next along N, SBO
// from one 8-key group to the next along K.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// S += Q K^T for a tile of N keys (the kernel takes N = 64, or 32 at Dv >
// 128; 96 and 128 are there for tools/flash_tc_ablation.py): the first
// k-step writes D without reading it, the rest add to it
template <int N, bool kFirst>
__device__ __forceinline__ void mma_qk(float (&d)[N / 2], uint64_t da,
                                       uint64_t db) {
  if constexpr (N == 32 && kFirst) wgmma_ss_n32_first(d, da, db);
  else if constexpr (N == 32) wgmma_ss_n32(d, da, db, 1);
  else if constexpr (N == 64 && kFirst) wgmma_ss_n64_first(d, da, db);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, 1);
  else if constexpr (N == 96 && kFirst) wgmma_ss_n96_first(d, da, db);
  else if constexpr (N == 96) wgmma_ss_n96(d, da, db, 1);
  else if constexpr (kFirst) wgmma_ss_n128_first(d, da, db);
  else wgmma_ss_n128(d, da, db, 1);
}

template <int N>
__device__ __forceinline__ void mma_pv(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

struct TcArgs {
  void* o;
  long long o_sb, o_sh, o_st;
  int nh, group, T, S, Dv, causal;
  float scale;
};

constexpr int kConsumers = 2;      // consumer warpgroups, 64 query rows each
constexpr int kBQ = 64 * kConsumers;
constexpr int kThreads = 128 * (kConsumers + 1);   // + the producer warpgroup

// head widths padded to DP, DVP (multiples of 64), BK keys per tile; the
// K/V ring takes as many stages (up to 4) as shared memory holds
template <int DP, int DVP, int BK>
struct TcShape {
  static constexpr int kQBytes = kBQ * DP * 2;
  static constexpr int kKBytes = BK * DP * 2;
  static constexpr int kVBytes = BK * DVP * 2;
  static constexpr int kStage = kKBytes + kVBytes;
  // slack to put the tiles on a 1024-byte boundary, and the barriers
  static constexpr int kFree = kMaxSmem - kQBytes - 1024 - 8 * 9;
  static constexpr int kStages = kFree / kStage < 4 ? kFree / kStage : 4;
  static constexpr int kBarOff = kQBytes + kStages * kStage;
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
};

// S = Q K^T into sc: DP / 16 k-steps, both operands K-major; started and
// committed, not waited for. sc's old values are dead: the first k-step
// only writes it
template <int DP, int BK>
__device__ __forceinline__ void start_qk(float (&sc)[BK / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t step = (kk % 4) * 32;
    const uint64_t da =
        make_desc(q_addr + (kk / 4) * kBQ * kLine + step, 16, 1024);
    const uint64_t db =
        make_desc(k_addr + (kk / 4) * BK * kLine + step, 16, 1024);
    if (kk == 0) mma_qk<BK, true>(sc, da, db);
    else mma_qk<BK, false>(sc, da, db);
  }
  wgmma_commit();
}

// O += P_hi V + P_lo V: BK / 16 k-steps, V N-major (LBO: the next 64-column
// box); started and committed, not waited for
template <int DVP, int BK>
__device__ __forceinline__ void start_pv(float (&o)[DVP / 2],
                                         const uint32_t (&phi)[BK / 16][4],
                                         const uint32_t (&plo)[BK / 16][4],
                                         uint32_t v_addr) {
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = make_desc(v_addr + kk * 16 * kLine, BK * kLine, 1024);
    mma_pv<DVP>(o, phi[kk], db);
    mma_pv<DVP>(o, plo[kk], db);
  }
  wgmma_commit();
}

// The online softmax of one key tile on the accumulator fragment, in two
// steps. This thread holds rows row0 and row0 + 8, columns k0 + 8 c + cq +
// {0, 1}. exp_scores: scale and mask the scores, take the new row max,
// leave p = exp(s - m_new) in sc (0 under the mask), add p into l and
// return alpha = exp(m_prev - m_new) through `al`. split_p: p into its
// bf16 A fragments, hi and lo.
template <int BK>
__device__ __forceinline__ void exp_scores(float (&sc)[BK / 2], float (&m)[2],
                                           float (&l)[2], float (&al)[2],
                                           float scale, bool masked,
                                           bool causal, int k0, int S,
                                           int row0, int cq) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {            // r / 2: row, r % 2: column
      float v = __fmul_rn(sc[4 * c + r], scale);
      if (masked) {
        const int col = k0 + 8 * c + cq + r % 2;
        if (col >= S || (causal && col > row0 + 8 * (r / 2))) v = kNegInf;
      }
      sc[4 * c + r] = v;
      mx[r / 2] = fmaxf(mx[r / 2], v);
    }
  }
  float mn[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) mn[i] = fmaxf(m[i], quad_max(mx[i]));
  if (__all_sync(0xffffffffu, mn[0] > kNegInf / 4 && mn[1] > kNegInf / 4)) {
    // every row of the warp holds a real score: a masked x <= -1e30 / 2
    // gives expf(x - m_new) = 0 exactly, as the rule asks, with no test
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sc[4 * c + r] = expf(sc[4 * c + r] - mn[r / 2]);
        ps[r / 2] += sc[4 * c + r];
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = sc[4 * c + r];
        sc[4 * c + r] = x <= kNegInf / 2 ? 0.0f : expf(x - mn[r / 2]);
        ps[r / 2] += sc[4 * c + r];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    al[i] = expf(m[i] - mn[i]);
    l[i] = __fadd_rn(__fmul_rn(l[i], al[i]), quad_sum(ps[i]));
    m[i] = mn[i];
  }
}

// A fragment of k-step c / 2: registers 0, 1 hold columns 0-7 of rows
// row0, row0 + 8; registers 2, 3 columns 8-15
template <int BK>
__device__ __forceinline__ void split_p(const float (&sc)[BK / 2],
                                        uint32_t (&phi)[BK / 16][4],
                                        uint32_t (&plo)[BK / 16][4]) {
#pragma unroll
  for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float p0 = sc[4 * c + 2 * i], p1 = sc[4 * c + 2 * i + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
      phi[c / 2][(c % 2) * 2 + i] = *reinterpret_cast<const uint32_t*>(&hi);
      plo[c / 2][(c % 2) * 2 + i] =
          pack_bf16(p0 - __low2float(hi), p1 - __high2float(hi));
    }
  }
}

// o *= alpha, row by row
template <int DVP>
__device__ __forceinline__ void rescale(float (&o)[DVP / 2],
                                        const float (&al)[2]) {
#pragma unroll
  for (int c = 0; c < DVP / 8; ++c)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      o[4 * c + r] = __fmul_rn(o[4 * c + r], al[r / 2]);
}

template <int DP, int DVP, int BK>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const TcArgs a) {
  using Sh = TcShape<DP, DVP, BK>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  uint8_t* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = base;                        // DP/64 boxes of (kBQ, 64)
  uint8_t* ring = base + Sh::kQBytes;        // stage s: K then V boxes
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + Sh::kBarOff);
  uint64_t* q_full = bars;
  constexpr int kStages = Sh::kStages;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // longest first
  const int b = bh / a.nh, h = bh % a.nh, kh = h / a.group;
  // keys past the tile's last query row are all masked: never loaded
  const int kend = a.causal ? min(a.S, q0 + kBQ) : a.S;
  const int nkv = (kend + BK - 1) / BK;
  // the role index, provably warp-uniform (a shuffle)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer warpgroup: gives its registers to the consumers; one
    // thread starts every copy, the rest leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(q_full, Sh::kQBytes);
#pragma unroll
      for (int c = 0; c < DP / kBox; ++c)
        tma_load(qs + c * kBQ * kLine, &tq, q_full, c * kBox, q0, h, b);
      for (int j = 0; j < nkv; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        uint8_t* kt = ring + s * Sh::kStage;
        uint8_t* vt = kt + Sh::kKBytes;
        mbar_expect_tx(&full[s], Sh::kStage);
#pragma unroll
        for (int c = 0; c < DP / kBox; ++c)
          tma_load(kt + c * BK * kLine, &tk, &full[s], c * kBox, j * BK, kh,
                   b);
#pragma unroll
        for (int c = 0; c < DVP / kBox; ++c)
          tma_load(vt + c * BK * kLine, &tv, &full[s], c * kBox, j * BK, kh,
                   b);
      }
    }
  } else {
    // consumer warpgroup wg: query rows q0 + 64 wg .. + 63. S_0; then for
    // each key tile j >= 1, S_j and P_{j-1} V_{j-1} started together, the
    // softmax of S_j running while P_{j-1} V_{j-1} is still on the tensor
    // cores; last, P V of the last tile. O, S_j and P_{j-1} live at once.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
    const int cq = 2 * (lane % 4);     // first column of each 8-column group
    const float scale = a.scale;
    const bool causal = a.causal != 0;
    float o[DVP / 2], sc[BK / 2], al[2];
#pragma unroll
    for (int i = 0; i < DVP / 2; ++i) o[i] = 0.0f;
    uint32_t phi[BK / 16][4], plo[BK / 16][4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    const uint32_t q_addr = smem_addr(qs) + 64 * wg * kLine;
    const uint32_t ring_addr = smem_addr(ring);
    auto k_addr = [&](int j) {
      return ring_addr + (j % kStages) * Sh::kStage;
    };
    // the diagonal, or keys past S, cross tile j: mask it
    auto softmax = [&](int j) {
      const bool masked = (j + 1) * BK > a.S ||
                          (causal && (j + 1) * BK - 1 > q0 + 64 * wg);
      exp_scores<BK>(sc, m, l, al, scale, masked, causal, j * BK, a.S, row0,
                     cq);
    };
    auto release = [&](int j) {       // this warp is done with tile j
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
    };

    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    start_qk<DP, BK>(sc, q_addr, k_addr(0));
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
    split_p<BK>(sc, phi, plo);
    for (int j = 1; j < nkv; ++j) {
      mbar_wait(&full[j % kStages], (j / kStages) & 1);
      start_qk<DP, BK>(sc, q_addr, k_addr(j));
      start_pv<DVP, BK>(o, phi, plo, k_addr(j - 1) + Sh::kKBytes);
      wgmma_wait<1>();                      // S_j is in
      fence_regs(sc);
      softmax(j);
      wgmma_wait<0>();                      // P_{j-1} V_{j-1} is in
      fence_regs(o);
      release(j - 1);
      rescale<DVP>(o, al);
      split_p<BK>(sc, phi, plo);
    }
    start_pv<DVP, BK>(o, phi, plo, k_addr(nkv - 1) + Sh::kKBytes);
    wgmma_wait<0>();
    fence_regs(o);
    release(nkv - 1);

    const float d0 = fmaxf(l[0], 1e-20f), d1 = fmaxf(l[1], 1e-20f);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb +
                        h * a.o_sh;
#pragma unroll
    for (int c = 0; c < DVP / 8; ++c) {
      const int col = 8 * c + cq;
      if (col >= a.Dv) continue;           // Dv % 16 == 0: pairs stay whole
      if (row0 < a.T)
        *reinterpret_cast<__nv_bfloat162*>(ob + row0 * a.o_st + col) =
            __floats2bfloat162_rn(__fdiv_rn(o[4 * c], d0),
                                  __fdiv_rn(o[4 * c + 1], d0));
      if (row0 + 8 < a.T)
        *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * a.o_st + col) =
            __floats2bfloat162_rn(__fdiv_rn(o[4 * c + 2], d1),
                                  __fdiv_rn(o[4 * c + 3], d1));
    }
  }
}

// ---------------------------------------------------------------------------
// host side: tensor maps and launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (the CUDA library
// it has already loaded), so that this library needs no -lcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A bf16 tensor (batch, head, row, col) with element strides over (row,
// head, batch), as a 4-D tensor map (col, row, head, batch) read in boxes
// of (64, box_rows, 1, 1) with 128-byte swizzle; out-of-bounds reads are
// zeros. TMA wants every stride a non-zero multiple of 16 bytes: an axis
// of extent 1 is never stepped, so it gets the packed stride.
int encode(CUtensorMap* map, const void* ptr, long long cols,
           long long rows, long long heads, long long batch, long long s_row,
           long long s_head, long long s_batch, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const long long given[3] = {s_row, s_head, s_batch};
  cuuint64_t strides[3];
  long long prev = 1, prev_ext = cols;
  for (int i = 0; i < 3; ++i) {
    const long long ext = (long long)dims[i + 1];
    const long long s = ext == 1 ? prev * prev_ext : given[i];
    if (s < 1 || (2 * s) % 16 != 0) return (int)cudaErrorInvalidValue;
    strides[i] = (cuuint64_t)(2 * s);
    prev = s;
    prev_ext = ext;
  }
  const cuuint32_t box[4] = {(cuuint32_t)kBox, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DP, int DVP>
int launch_tc(const FlashArgs& a, cudaStream_t stream) {
  constexpr int BK = DVP <= 128 ? 64 : 32;
  using Sh = TcShape<DP, DVP, BK>;
  static_assert(Sh::kStages >= 2 && Sh::kSmem <= kMaxSmem,
                "tiles exceed shared memory");
  const long long nq = (a.T + kBQ - 1) / kBQ;
  if (nq > 65535 || a.nbh > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long B = a.nbh / a.nh, KH = a.nh / a.group;
  CUtensorMap tq, tk, tv;
  int e = encode(&tq, a.q, a.D, a.T, a.nh, B, a.q_st, a.q_sh, a.q_sb, kBQ);
  if (e == 0)
    e = encode(&tk, a.k, a.D, a.S, KH, B, a.k_ss, a.k_sh, a.k_sb, BK);
  if (e == 0)
    e = encode(&tv, a.v, a.Dv, a.S, KH, B, a.v_ss, a.v_sh, a.v_sb, BK);
  if (e != 0) return e;
  const TcArgs t{a.o, a.o_sb, a.o_sh, a.o_st, (int)a.nh, (int)a.group,
                 (int)a.T, (int)a.S, (int)a.Dv, (int)a.causal,
                 (float)a.scale};
  auto k = flash_tc_kernel<DP, DVP, BK>;
  const cudaError_t se = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::kSmem);
  if (se != cudaSuccess) return (int)se;
  const dim3 grid((unsigned)a.nbh, (unsigned)nq);
  k<<<grid, kThreads, Sh::kSmem, stream>>>(tq, tk, tv, t);
  return (int)cudaGetLastError();
}

// head widths in steps of 16 up to 256, padded to 64, 128 or 256
int padded(long long d) { return d <= 64 ? 64 : d <= 128 ? 128 : 256; }

}  // namespace

extern "C" {

// bf16 q, k, v, o; D and Dv multiples of 16 in [16, 256]
int layer_flash_attention_tc(const FlashArgs* a, void* stream) {
  if (a->nbh < 1 || a->T < 1 || a->S < 1 || a->D < 16 || a->D > 256 ||
      a->D % 16 != 0 || a->Dv < 16 || a->Dv > 256 || a->Dv % 16 != 0 ||
      a->nh < 1 || a->group < 1 || a->nh % a->group != 0 ||
      a->nbh % a->nh != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int dp = padded(a->D), dv = padded(a->Dv);
#define FLASH_TC_WIDTHS(X, Y) \
  if (dp == X && dv == Y) return launch_tc<X, Y>(*a, s);
  FLASH_TC_WIDTHS(64, 64) FLASH_TC_WIDTHS(64, 128) FLASH_TC_WIDTHS(64, 256)
  FLASH_TC_WIDTHS(128, 64) FLASH_TC_WIDTHS(128, 128) FLASH_TC_WIDTHS(128, 256)
  FLASH_TC_WIDTHS(256, 64) FLASH_TC_WIDTHS(256, 128) FLASH_TC_WIDTHS(256, 256)
#undef FLASH_TC_WIDTHS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
