// Blocked online-softmax attention for prefill (causal and/or sliding
// window, grouped-query) on Hopper's tensor cores: bf16 in, wgmma for both
// products, TMA for every tile, hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (pallas_call at flash_attention.py:118, body _kernel at :35) for bf16
// inputs at head_dim 64, 128, 160 and 224; f32 inputs and other head dims take
// flash_attention.cu (the route rule is flash_attention.py::flash_route).
// It computes what that kernel computes: for each (batch b, query head h)
// the f32 scores q.k * scale (1/sqrt(hd) unless the caller gives another:
// zamba2's (hd/2)^-1/2), -1e30 where masked (ragged tail,
// causal bound col <= row, window bound col > row - window), an online
// softmax with m, l and the output accumulator in f32 and p forced to 0
// where masked, and out = acc / l, or zeros for a row whose l stays 0.
// Query head h reads KV head h / (H / KV): K and V are never repeated.
//
// One rounding differs from the Pallas kernel: P is rounded to bf16 before
// the P.V product (wgmma takes bf16 operands).  That is the rounding the
// reference's repro/kernels/ref.py oracle applies (it casts the weights to
// q's dtype before P.V); the bf16 tolerance covers it.
//
// Layouts (kernel layout, any strides that TMA takes): q (B, H, S, hd),
// k/v (B, KV, T, hd), out (B, H, S, hd), bf16.  Each tensor is described to
// TMA by a 4-D tensor map over (hd, rows, heads, batch) built from its
// strides, so the model's transposed (B, S, H, hd) views are read and
// written in place.  The wrapper checks TMA's conditions (16-byte aligned
// base, strides that are multiples of 16 bytes, unit stride on hd).
//
// Design, for this card:
//   * a block takes 64 query rows per consumer warpgroup of one (b, h):
//     two consumers (128 rows) at hd 128, three (192 rows) at hd 64, and
//     one producer warpgroup whose one thread issues the TMA loads;
//     setmaxnreg moves registers from the producer to the consumers;
//   * Q is loaded once per block by TMA; K and V tiles of 128 keys stream
//     through a ring of STAGES shared-memory stages with full/empty
//     mbarriers, so the producer keeps loads in flight while the consumers
//     compute;
//   * every tile lands with the 128-byte swizzle that the wgmma descriptors
//     expect: rows of 64 bf16 (one swizzle atom), so hd = 128 is two atoms
//     along the contraction axis; hd = 160 is two such atoms and a tail atom
//     of 32 columns with the 64-byte swizzle (below);
//   * S = Q.K^T is wgmma m64n128k16 from shared memory (both K-major); the
//     online softmax runs on the f32 accumulator in registers (a row lives
//     in the 4 lanes of a quad); P is rounded to bf16 in registers and is
//     the A operand of O += P.V, wgmma m64n{hd}k16 with V read MN-major;
//     the consumers take turns to issue S (named barriers), so one's
//     softmax overlaps the next one's product on the tensor cores;
//   * key tiles wholly above the causal diagonal or wholly before the
//     window are never loaded (exact: in the Pallas arithmetic such a tile
//     leaves m, l and acc unchanged); the mask is computed only on tiles
//     that cross a boundary;
//   * the ragged tail needs no fallback: rows and keys past S and T arrive
//     as TMA's zero fill, keys past T are masked, and the TMA store of the
//     output clips rows past S;
//   * the grid puts the query-tile index on its slowest axis, last tile
//     first, so the heaviest causal tiles start in the first wave.
//
// hd 160 (pixtral-12b, stablelm-12b).  160 columns are 2.5 atoms of the
// 128-byte swizzle.  Padding to three atoms (192 columns) would make a Q
// tile of 128 rows 48 KB and a K or V tile of 128 keys 48 KB: 48 + 2 * 96 =
// 240 KB for two stages, over the 227 KB a block may have.  So each tile is
// cut into two 128-byte-swizzle atoms (columns 0-127, boxes of 64 columns)
// and a tail atom of columns 128-159 whose 64-byte rows take the 64-byte
// swizzle (a second tensor map per tensor, boxes of 32 columns, XOR of the
// 16-byte chunk with bits 7-8 of the address; descriptors of layout type
// B64, 512 bytes between 8-row groups).  A Q tile is then 40 KB and a K or
// V tile 40 KB: 40 + 2 * 80 = 200 KB, hd 128's pipeline (two consumers, 128
// keys a tile, two stages) unchanged.  S = Q.K^T takes 10 k-steps of 16:
// 8 over the full atoms, 2 over the tail.  O += P.V is m64n128k16 over the
// full atoms plus m64n32k16 over the tail, so the 64 x 160 f32 accumulator
// is 64 + 16 registers a thread beside S's 64 and P's 32; the consumers get
// 240 registers (the producer 24).  The epilogue writes the tail columns
// with the 64-byte pattern and stores them as a third box.
//
// hd 224 (zamba2-7b's shared attention).  Three 128-byte-swizzle atoms and
// the same 32-column tail atom.  A Q tile of 128 rows and a K or V tile of
// 128 keys are 56 KB each: 56 + 2 * 112 = 280 KB for two stages, so the
// ring has one stage (168 KB), and the producer loads a tile once both
// consumers have released the last; the loads then no longer overlap the
// products.  S = Q.K^T takes 14 k-steps (12 over the atoms, 2 over the
// tail); O += P.V is m64n128k16 over the first two atoms, m64n64k16 over
// the third and m64n32k16 over the tail, so the 64 x 224 f32 accumulator is
// 64 + 32 + 16 registers beside S's 64 and P's 32.
//
// What bounds it on this card.  At yi-9b's prefill launch (B 8, H 32,
// KV 4, S 1024, hd 128, causal) the causal dot products are 68.7 GFLOP:
// 0.069 ms at the bf16 tensor-core rate, against 0.045 ms for q, k, v and
// out at 3.35 TB/s, so operations bound it.  At pixtral-12b's (B 8, H 32,
// KV 8, S 2048, hd 160) they are 343.6 GFLOP: 0.348 ms, against 0.063 ms
// of bytes; operations again.  The n32 tail product runs the tensor cores
// at a narrower width than the n128 one.  Left for later: a consumer
// waits for its own S before its softmax (no overlap with its next
// tile's product inside a warpgroup), and no block is persistent.
//
// The PTX helpers and the tensor-map encoder are in hopper.cuh.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BK = 128;                 // keys per tile
constexpr int KV_ATOM = BK * 128;       // one 64-column swizzle atom of a K or V tile
constexpr int TAIL_ROW = 64;            // bytes of a row of the 32-column tail atom
constexpr int WG_ROW_BYTES = 64 * 128;  // a consumer's 64 rows inside a Q atom
constexpr float NEG = -1e30f;           // the running max's floor, as the Pallas mask value
constexpr float LOG2E = 1.4426950408889634f;

// named barriers between two consumer warpgroups (256 threads): one waits,
// the other arrives
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// hd 64: three consumer warpgroups (192 query rows) and a 3-stage ring;
// hd 128 and 160: two consumers (128 rows), 2 stages; hd 224: two
// consumers, 1 stage.  setmaxnreg splits the 64K registers of the SM
// between the producer and the consumers.  Each tile is ATOMS
// 128-byte-swizzle atoms of 64 columns, then (hd 160, 224) a tail atom of
// TAIL = 32 columns with the 64-byte swizzle.
template <int HD>
struct Tiles {
  static constexpr int ATOMS = HD / 64;                  // 128-byte swizzle atoms along hd
  static constexpr int TAIL = HD % 64;                   // columns of the tail atom
  static_assert(TAIL == 0 || TAIL == 32, "hd is 64, 128, 160 or 224");
  static constexpr int NWG = HD == 64 ? 3 : 2;           // consumer warpgroups
  static constexpr int BQ = 64 * NWG;                    // query rows per block
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int PRODUCER_REGS = HD == 128 ? 40 : 24;
  static constexpr int CONSUMER_REGS = HD == 64 ? 160 : HD == 128 ? 232 : 240;
  static constexpr int STAGES = HD == 64 ? 3 : HD == 224 ? 1 : 2;  // K/V ring depth
  static constexpr int Q_ATOM = BQ * 128;                // one swizzle atom of the Q tile
  static constexpr int Q_TAIL = ATOMS * Q_ATOM;          // the Q tile's tail atom
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int KV_TAIL = ATOMS * KV_ATOM;        // a K or V tile's tail atom
  static constexpr int KV_BYTES = BK * HD * 2;           // one K or V tile of BK keys
  static constexpr int BAR_OFFSET = Q_BYTES + STAGES * 2 * KV_BYTES;
  // + the mbarriers, + slack to align the base to the swizzle's 1024 bytes
  static constexpr int SMEM = BAR_OFFSET + 8 * (2 * STAGES + 1) + 1024;
  static_assert(SMEM <= 232448, "shared memory");
  // every atom starts on the 128-byte swizzle's 1024-byte period
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "atom alignment");
  static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 128 * NWG <= 65536, "register file");
};

// the key tiles [k_first, k_first + n * BK) that hold an unmasked entry for
// some row q0 .. min(q0 + BQ, S) - 1 of the block
__device__ __forceinline__ void key_tiles(int q0, int BQ, int S, int Tk, int causal,
                                          int has_window, int window, int& k_first, int& n) {
  int k_end = Tk;
  if (causal) k_end = min(k_end, min(q0 + BQ, S));
  k_first = has_window ? max(0, q0 - window + 1) / BK * BK : 0;
  n = k_end > k_first ? (k_end - k_first + BK - 1) / BK : 0;
}

template <int HD>
__global__ void __launch_bounds__(Tiles<HD>::THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_o,
                             const __grid_constant__ CUtensorMap tm_qt,
                             const __grid_constant__ CUtensorMap tm_kt,
                             const __grid_constant__ CUtensorMap tm_vt,
                             const __grid_constant__ CUtensorMap tm_ot, int H, int KV, int S,
                             int Tk, int causal, int has_window, int window, float scale_log2) {
  // tm_qt .. tm_ot: the tail atom's maps (32-column boxes, 64-byte swizzle),
  // read only where TAIL > 0
  using C = Tiles<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bars = base + C::BAR_OFFSET;
  auto k_s = [&](int s) { return base + C::Q_BYTES + s * 2 * C::KV_BYTES; };
  auto v_s = [&](int s) { return base + C::Q_BYTES + s * 2 * C::KV_BYTES + C::KV_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };
  const uint32_t q_bar = bars + 16 * C::STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::BQ;  // the heaviest causal tiles first
  const int kvh = h / (H / KV);
  int k_first, n_tiles;
  key_tiles(q0, C::BQ, S, Tk, causal, has_window, window, k_first, n_tiles);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * C::NWG);  // every consumer thread releases the stage
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < C::ATOMS; ++a)
        tma_load(q_s + a * C::Q_ATOM, &tm_q, q_bar, 64 * a, q0, h, b);
      if constexpr (C::TAIL > 0) tma_load(q_s + C::Q_TAIL, &tm_qt, q_bar, 64 * C::ATOMS, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % C::STAGES;
        mbar_wait(empty(s), ((i / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::KV_BYTES);
        const int k0 = k_first + i * BK;
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a) {
          tma_load(k_s(s) + a * KV_ATOM, &tm_k, full(s), 64 * a, k0, kvh, b);
          tma_load(v_s(s) + a * KV_ATOM, &tm_v, full(s), 64 * a, k0, kvh, b);
        }
        if constexpr (C::TAIL > 0) {
          tma_load(k_s(s) + C::KV_TAIL, &tm_kt, full(s), 64 * C::ATOMS, k0, kvh, b);
          tma_load(v_s(s) + C::KV_TAIL, &tm_vt, full(s), 64 * C::ATOMS, k0, kvh, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each -------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::CONSUMER_REGS));
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int warp = t / 32, lane = t % 32;
    const int r0 = q0 + 64 * cw;                 // the consumer's first row
    const int ra = warp * 16 + lane / 4;         // local rows of the thread: ra, ra + 8
    const int col_l = 2 * (lane % 4);            // its first column in each 8-column block
    const uint32_t q_wg = q_s + cw * WG_ROW_BYTES;
    const uint32_t q_wg_t = q_s + C::Q_TAIL + cw * 64 * TAIL_ROW;  // its rows in the tail atom

    auto visible = [&](int row, int col) {
      return col < Tk && (!causal || col <= row) && (!has_window || col > row - window);
    };

    // the accumulator: columns 0 .. 64 ATOMS - 1 in o, the tail's in o_t
    float o[32 * C::ATOMS], o_t[C::TAIL > 0 ? C::TAIL / 2 : 1];
#pragma unroll
    for (int i = 0; i < 32 * C::ATOMS; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::TAIL / 2; ++i) o_t[i] = 0.f;
    float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;

    mbar_wait(q_bar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % C::STAGES;
      const int k0 = k_first + i * BK;
      mbar_wait(full(s), (i / C::STAGES) & 1);

      // S = Q K^T (64 x BK, f32).  The consumers take turns to issue it, in
      // order cw = 0, 1, .. (a token passed by named barriers 4 + cw), so
      // one's softmax runs while the next one's product is on the tensor
      // cores.  Consumer 0 holds the token for the first tile; the last
      // consumer passes none after the last tile.
      if (cw > 0 || i > 0) named_sync(4 + cw);
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * C::ATOMS; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss_n128(sc, smem_desc(q_wg + (kk / 4) * C::Q_ATOM + off, 16, 1024),
                      smem_desc(k_s(s) + (kk / 4) * KV_ATOM + off, 16, 1024), kk > 0);
      }
      // the tail's k-steps: 64-byte rows, 8-row groups 512 bytes apart
#pragma unroll
      for (int kk = 0; kk < C::TAIL / 16; ++kk)
        wgmma_ss_n128(sc, smem_desc_b64(q_wg_t + kk * 32, 16, 512),
                      smem_desc_b64(k_s(s) + C::KV_TAIL + kk * 32, 16, 512), 1);
      wgmma_commit();
      if (cw < C::NWG - 1 || i < n_tiles - 1) named_arrive(4 + (cw + 1) % C::NWG);
      wgmma_wait_all();

      // online softmax on the accumulator: entry 4j + e is row ra + 8 (e / 2),
      // column 8j + col_l + e % 2; a row's entries live in the 4 lanes of a
      // quad.  Masked scores become -inf on the tiles that cross a boundary;
      // with m floored at -1e30 their p = 2^(-inf) is exactly 0, as the
      // Pallas kernel forces it.
      if (k0 + BK > Tk || (causal && k0 + BK - 1 > r0) ||
          (has_window && k0 <= r0 + 63 - window)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!visible(r0 + ra + 8 * (e / 2), k0 + 8 * j + col_l + e % 2))
              sc[4 * j + e] = -INFINITY;
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x < 4; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
      }
      // m in units of log2: scores times scale * log2(e)
      const float mn_a = fmaxf(m_a, mx_a * scale_log2), mn_b = fmaxf(m_b, mx_b * scale_log2);
      const float al_a = ex2(m_a - mn_a), al_b = ex2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;

      // P, rounded to bf16 in the register layout of wgmma's A operand:
      // k-slice kk takes column blocks 2kk (regs 0, 1) and 2kk + 1 (regs 2, 3)
      uint32_t p[BK / 16][4];
      float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = ex2(fmaf(sc[4 * j], scale_log2, -mn_a));
        const float p1 = ex2(fmaf(sc[4 * j + 1], scale_log2, -mn_a));
        const float p2 = ex2(fmaf(sc[4 * j + 2], scale_log2, -mn_b));
        const float p3 = ex2(fmaf(sc[4 * j + 3], scale_log2, -mn_b));
        rs_a += p0 + p1;
        rs_b += p2 + p3;
        p[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
        p[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
      }
      l_a = l_a * al_a + rs_a;
      l_b = l_b * al_b + rs_b;
#pragma unroll
      for (int j = 0; j < 8 * C::ATOMS; ++j) {
        o[4 * j] *= al_a;
        o[4 * j + 1] *= al_a;
        o[4 * j + 2] *= al_b;
        o[4 * j + 3] *= al_b;
      }
#pragma unroll
      for (int j = 0; j < C::TAIL / 8; ++j) {
        o_t[4 * j] *= al_a;
        o_t[4 * j + 1] *= al_a;
        o_t[4 * j + 2] *= al_b;
        o_t[4 * j + 3] *= al_b;
      }

      // O += P V (64 x HD, f32); V's rows are keys, read MN-major: 16 keys
      // per k-slice (2048 bytes), the hd atoms KV_ATOM apart; the tail's
      // 16 keys are 1024 bytes, one 32-column atom
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = smem_desc(v_s(s) + kk * 16 * 128, KV_ATOM, 1024);
        if constexpr (C::ATOMS == 3) {
          wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o), p[kk], dv);
          wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(o + 64), p[kk],
                       smem_desc(v_s(s) + 2 * KV_ATOM + kk * 16 * 128, KV_ATOM, 1024));
        } else if constexpr (C::ATOMS == 2) {
          wgmma_rs_n128(o, p[kk], dv);
        } else {
          wgmma_rs_n64(o, p[kk], dv);
        }
        if constexpr (C::TAIL > 0)
          wgmma_rs_n32(o_t, p[kk],
                       smem_desc_b64(v_s(s) + C::KV_TAIL + kk * 16 * TAIL_ROW, BK * TAIL_ROW, 512));
      }
      wgmma_commit();
      wgmma_wait_all();
      mbar_arrive(empty(s));
    }

    // out = acc / l (zeros where l = 0), through this consumer's Q rows in
    // shared memory (same swizzle) and a TMA store that clips rows past S
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
    }
    if (r0 < S) {
      const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
      const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
#pragma unroll
      for (int j = 0; j < 8 * C::ATOMS; ++j) {
        const uint32_t atom = q_wg + (j / 8) * C::Q_ATOM + col_l * 2;
        const uint32_t at_a = atom + ra * 128 + (((j % 8) ^ (ra % 8)) * 16);
        const uint32_t at_b = atom + (ra + 8) * 128 + (((j % 8) ^ ((ra + 8) % 8)) * 16);
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at_a),
                     "r"(pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a)) : "memory");
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at_b),
                     "r"(pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b)) : "memory");
      }
      // the tail: 64-byte rows, chunk j of row r at chunk j ^ ((r / 2) % 4)
#pragma unroll
      for (int j = 0; j < C::TAIL / 8; ++j) {
        const uint32_t at_a = q_wg_t + ra * TAIL_ROW + ((j ^ ((ra / 2) % 4)) * 16) + col_l * 2;
        const uint32_t at_b =
            q_wg_t + (ra + 8) * TAIL_ROW + ((j ^ (((ra + 8) / 2) % 4)) * 16) + col_l * 2;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at_a),
                     "r"(pack_bf16(o_t[4 * j] * inv_a, o_t[4 * j + 1] * inv_a)) : "memory");
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at_b),
                     "r"(pack_bf16(o_t[4 * j + 2] * inv_b, o_t[4 * j + 3] * inv_b)) : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
      if (t == 0) {
#pragma unroll
        for (int a = 0; a < C::ATOMS; ++a)
          tma_store(&tm_o, q_wg + a * C::Q_ATOM, 64 * a, r0, h, b);
        if constexpr (C::TAIL > 0) tma_store(&tm_ot, q_wg_t, 64 * C::ATOMS, r0, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

// ---- host side ----------------------------------------------------------------

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV, int S,
           int Tk, const long long* st, int causal, int has_window, int window, float scale,
           cudaStream_t stream) {
  using C = Tiles<HD>;
  CUtensorMap tq, tk, tv, to;
  int err;
  if ((err = make_map(&tq, q, HD, S, H, B, st, C::BQ)) != 0) return err;
  if ((err = make_map(&tk, k, HD, Tk, KV, B, st + 3, BK)) != 0) return err;
  if ((err = make_map(&tv, v, HD, Tk, KV, B, st + 6, BK)) != 0) return err;
  if ((err = make_map(&to, out, HD, S, H, B, st + 9, 64)) != 0) return err;
  CUtensorMap tqt = tq, tkt = tk, tvt = tv, tot = to;  // unread without a tail
  if constexpr (C::TAIL > 0) {
    constexpr CUtensorMapSwizzle SW64 = CU_TENSOR_MAP_SWIZZLE_64B;
    if ((err = make_map(&tqt, q, HD, S, H, B, st, C::BQ, C::TAIL, SW64)) != 0) return err;
    if ((err = make_map(&tkt, k, HD, Tk, KV, B, st + 3, BK, C::TAIL, SW64)) != 0) return err;
    if ((err = make_map(&tvt, v, HD, Tk, KV, B, st + 6, BK, C::TAIL, SW64)) != 0) return err;
    if ((err = make_map(&tot, out, HD, S, H, B, st + 9, 64, C::TAIL, SW64)) != 0) return err;
  }
  auto kernel = flash_attention_wgmma_kernel<HD>;
  // the opt-in holds for the function as loaded on the current device only,
  // so it is granted on every launch (no flag shared by devices or threads)
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (S + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(tq, tk, tv, to, tqt, tkt, tvt, tot, H, KV, S, Tk,
                                             causal, has_window, window, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; hd 64, 128, 160 or 224.  strides: 12 element strides, in order q (b, h,
// s), k (b, kv, t), v (b, kv, t), out (b, h, s), each a multiple of 8 (16
// bytes); the last axis of every tensor has unit stride and every base is
// 16-byte aligned.  The wrapper guarantees these, H % KV == 0 and T > 0.
// Returns a cudaError_t, or ERR_NO_ENCODE / ERR_ENCODE (0 = launched).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* out, int B, int H, int KV, int S, int T,
                                            int hd, const long long* strides, int causal,
                                            int has_window, int window, float scale,
                                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(q, k, v, out, B, H, KV, S, T, strides, causal, has_window, window, scale, s);
  if (hd == 128)
    return launch<128>(q, k, v, out, B, H, KV, S, T, strides, causal, has_window, window, scale,
                       s);
  if (hd == 160)
    return launch<160>(q, k, v, out, B, H, KV, S, T, strides, causal, has_window, window, scale,
                       s);
  if (hd == 224)
    return launch<224>(q, k, v, out, B, H, KV, S, T, strides, causal, has_window, window, scale,
                       s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_wgmma_error_string(int err) {
  return hopper::error_string(err);
}
