// Mamba-2 chunked SSD scan on Hopper's tensor cores: bf16 in, wgmma for all
// four products, TMA for x, B and C, hand-written for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (pallas_call
// at ssd_scan.py:84, body _kernel at :27) for bf16 inputs at head dim
// P = 64, state N = 64 or 128 and chunk Q = 128; f32 inputs and other
// shapes take ssd_scan.cu (the route rule is ssd_scan.py::ssd_route).  Per
// (batch b, head h) it walks the chunks of Q tokens with an (N x P) f32
// state carried across them:
//   cs      = cumsum(dt * A)                               (f32, per chunk)
//   W[i][j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j        for j <= i, else 0
//   y_i     = exp(cs_i) * (C_i . state)  +  sum_j W[i][j] x_j
//   state   = exp(cs_Q) * state  +  sum_j B_j (exp(cs_Q - cs_j) dt_j x_j)^T
// Like ssd_scan.cu it reads SSM group g = h / (H / G) of B and C by
// index, takes a ragged last chunk as dt = x = B = C = 0 (TMA's zero fill
// past S; dt loaded as 0), starts from a given initial state h0
// (B, H, N, P) f32 (zero where h0 is null) and optionally writes the final
// state (B, H, N, P) in f32.
//
// Roundings.  wgmma takes bf16 operands.  C.B^T multiplies the bf16 inputs
// exactly and sums in f32.  Three operands are f32 values that the
// products need in bf16: W, the carried state (for C.state) and
// x_j * exp(cs_Q - cs_j) dt_j (for the state update).  Each is split into
// two bf16 terms, hi = bf16(a) and lo = bf16(a - hi), and multiplied as
// two products summed in f32, so each is represented to ~2^-16 of its
// value.  Mamba-2's own GPU kernels round such operands once; at the test
// distributions (x, B, C standard normal) one rounding of W alone moves y
// near 0 by about the whole bf16 bound of 0.02 that this route is held to
// (tests/test_kernels.py's), an error that scales with the terms of the
// sum and not with y, while the split keeps y within one bf16 step of the
// f32 form and the final state within the f32 bound.  The split costs one
// more product of each kind on the tensor cores, which are not what bounds
// this kernel (below).
// The carried state itself stays f32, in the wgmma accumulator registers.
//
// Layouts (kernel layout): x (B, H, S, P), Bm/Cm (B, G, S, N) and y
// (B, H, S, P) bf16 with unit stride on the last axis; dt (B, H, S) bf16,
// any strides (the model's dt has stride H along S, which TMA cannot read:
// the producer loads it by plain loads); A (H,) f32.  x, Bm and Cm are
// described to TMA by 4-D maps over (cols, rows, heads, batch) built from
// their strides, so the model's transposed (B, S, H, P) / (B, S, G, N)
// views are read in place; the wrapper checks TMA's conditions (16-byte
// aligned base, strides that are multiples of 16 bytes) and raises when
// they fail.  y is written from registers, two bf16 at a time.
//
// Design, for this card:
//   * one block per (b, h), the chunk axis a loop inside it, and one
//     producer warp; at N = 64 one consumer warpgroup (160 threads, two
//     blocks per SM), at N = 128 two (288 threads, one block per SM, which
//     the shared memory allows), each taking one 64-row half of the
//     chunk's y and one 64-column half of the state, so that a chunk's
//     dependent products run as two shorter chains;
//   * the producer's elected lane keeps the TMA loads of the next chunk's
//     x, B and C tiles in flight through a ring of STAGES = 2 stages
//     (full/empty mbarriers) while the consumers compute this one; its 32
//     lanes load the chunk's dt, scan cs = cumsum(dt * A) and write per
//     token cs log2(e), dt, exp(cs) and exp(cs_Q - cs) dt into the stage,
//     so loads, the scan and those exponentials overlap the products;
//   * tiles are bf16 with the 128-byte swizzle that the wgmma descriptors
//     expect: rows of 64 bf16 (one atom), N = 128 as two atoms along N;
//   * C.state: the state's hi and then lo terms go to one bf16 buffer in
//     shared memory ([p][n], K-major for the B operand; each warpgroup
//     writes its columns), each followed by wgmma m64n64 over the chunk's
//     64-row halves (both, or the warpgroup's own); the rows are then
//     scaled by exp(cs_i) in the accumulator, and W.x accumulates on top;
//   * C.B^T: wgmma m64n64 from shared memory per (row half, 64-column
//     piece), only the pieces at or left of the diagonal; W is formed on
//     the f32 accumulator and rounded into the register layout of wgmma's
//     A operand, with one exponential per column pair of the thread's two
//     rows where the whole 8-column block lies left of the warp's rows (the
//     second row's decay is the first's times exp(cs_ib - cs_ia) <= 1) and
//     none where it lies right of them; W.x: wgmma m64n64 with W from
//     registers and x read MN-major from its tile;
//   * the state update is a product over the chunk's tokens with M = P:
//     state^T (P x N) += (x * w)^T B, the A operand loaded from the x tile
//     by ldmatrix.trans and scaled in registers, B read MN-major; so the
//     state^T lives in the accumulator registers for the whole sequence
//     (at N = 128, its two 64-column halves in the two warpgroups);
//   * shared memory: 111.6 KB at N = 64 (two blocks per SM), 185.4 KB at
//     N = 128.
//
// What bounds it on this card.  At zamba2-1.2b's prefill launch (B 8,
// H 64, S 2048, P 64, N 64, G 1) the function reads ~140 MB and writes
// ~142 MB (0.085 ms at 3.35 TB/s) and needs ~34 GFLOP for the causal
// products (0.035 ms at the bf16 tensor-core rate; the split's extra
// products ~1.5x that): bytes bound it.  What sets this kernel's pace is
// the chain of dependent products inside each chunk and the 16 chunks of a
// head in order; left for later: C.B^T once per group (all heads share it
// at G = 1), and splitting a head's chunks over blocks with a state pass.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int Q = 128;                 // tokens per chunk
constexpr int P = 64;                  // head dim
constexpr int STAGES = 2;
constexpr int ATOM = Q * 128;          // one 64-column swizzle atom of a Q-row tile
constexpr int VEC_BYTES = 4 * Q * 4;   // per token of a chunk: cs2, dt, exp(cs), w; f32
constexpr float LOG2E = 1.4426950408889634f;

template <int N>
struct Layout {
  static constexpr int NA = N / 64;                        // atoms along N
  static constexpr int X_OFF = 0;
  static constexpr int B_OFF = ATOM;
  static constexpr int C_OFF = ATOM * (1 + NA);
  static constexpr int VEC_OFF = ATOM * (1 + 2 * NA);
  static constexpr int STAGE = VEC_OFF + VEC_BYTES;        // a multiple of 1024
  static constexpr int S_ATOM = P * 128;                   // one atom of the [p][n] state
  static constexpr int S_OFF = STAGES * STAGE;
  static constexpr int BAR_OFF = S_OFF + NA * S_ATOM;
  static constexpr int SMEM = BAR_OFF + 8 * 2 * STAGES + 1024;  // + slack to align to 1024
  static constexpr uint32_t TX = ATOM * (1 + 2 * NA);      // TMA bytes per stage
  static constexpr int MIN_BLOCKS = N == 64 ? 2 : 1;       // blocks per SM the smem allows
  // consumer warpgroups: at N = 64 one (two blocks share an SM); at N = 128
  // two, each taking one 64-row half of the chunk's y and one 64-column
  // half of the state (one block fills an SM's shared memory)
  static constexpr int NWG = N == 64 ? 1 : 2;
  static constexpr int THREADS = 128 * NWG + 32;           // + the producer warp
  static constexpr int HALVES = 2 / NWG;                   // row halves per warpgroup
  static constexpr int NS = N / NWG;                       // state columns per warpgroup
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// all consumer threads (one barrier id, not the producer warp)
template <int NWG>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * NWG) : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return __bfloat1622float2(h);
}

// a (two values) as hi = bf16(a) and lo = bf16(a - hi), packed in pairs
__device__ __forceinline__ void split2(float a0, float a1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a0, a1);
  const float2 h = unpack_bf16(hi);
  lo = pack_bf16(a0 - h.x, a1 - h.y);
}

// descriptors of the K-major operands: rows `row0..` of a Q-row tile (A = C
// or B = B^T in C.B^T), k-slice kk of the N contraction
__device__ __forceinline__ uint64_t desc_rows(uint32_t tile, int row0, int kk) {
  return smem_desc(tile + (kk / 4) * ATOM + row0 * 128 + (kk % 4) * 32, 16, 1024);
}

template <int N>
__global__ void __launch_bounds__(Layout<N>::THREADS, Layout<N>::MIN_BLOCKS)
ssd_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_b,
                      const __grid_constant__ CUtensorMap tm_c,
                      const __nv_bfloat16* __restrict__ dt, const float* __restrict__ A,
                      __nv_bfloat16* __restrict__ y, float* __restrict__ final_state,
                      const float* __restrict__ h0, int H, int G, int S, long long dsb, long long dsh, long long dss,
                      long long ysb, long long ysh, long long yss) {
  using Lt = Layout<N>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  auto stage = [&](int s) { return base + s * Lt::STAGE; };
  auto vec = [&](int s) { return reinterpret_cast<float*>(gbase + s * Lt::STAGE + Lt::VEC_OFF); };
  const uint32_t s_state = base + Lt::S_OFF;
  const uint32_t bars = base + Lt::BAR_OFF;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int nc = (S + Q - 1) / Q;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);    // the producer warp's lanes (dt, cs written)
      mbar_init(empty(s), 128 * Lt::NWG);  // every consumer thread releases the stage
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * Lt::NWG) {
    // ---- producer warp: TMA for x, B, C; dt and cs by its 32 lanes -----------
    const int lane = threadIdx.x - 128 * Lt::NWG;
    const float a = A[h];
    const __nv_bfloat16* db = dt + b * dsb + h * dsh;
    for (int c = 0; c < nc; ++c) {
      const int s = c % STAGES;
      mbar_wait(empty(s), ((c / STAGES) & 1) ^ 1);
      if (lane == 0) {
        mbar_add_tx(full(s), Lt::TX);
        tma_load(stage(s) + Lt::X_OFF, &tm_x, full(s), 0, c * Q, h, b);
#pragma unroll
        for (int at = 0; at < Lt::NA; ++at) {
          tma_load(stage(s) + Lt::B_OFF + at * ATOM, &tm_b, full(s), 64 * at, c * Q, g, b);
          tma_load(stage(s) + Lt::C_OFF + at * ATOM, &tm_c, full(s), 64 * at, c * Q, g, b);
        }
      }
      // cs = cumsum(dt * a) over the chunk: 4 positions per lane, then a scan
      float d[4], loc[4], run = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int pos = c * Q + 4 * lane + u;
        d[u] = pos < S ? __bfloat162float(db[pos * dss]) : 0.f;
        run += d[u] * a;
        loc[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const float excl = incl - run;
      const float total = __shfl_sync(0xffffffffu, incl, 31);  // cs at the chunk's end
      float* v = vec(s);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float cs = excl + loc[u];
        v[4 * lane + u] = cs * LOG2E;                                  // cs2 = cs log2(e)
        v[Q + 4 * lane + u] = d[u];                                    // dt
        v[2 * Q + 4 * lane + u] = ex2(cs * LOG2E);                     // exp(cs)
        v[3 * Q + 4 * lane + u] = ex2((total - cs) * LOG2E) * d[u];    // exp(cs_Q - cs) dt
      }
      mbar_arrive(full(s));
    }
    return;
  }

  // ---- consumer warpgroups ---------------------------------------------------------
  constexpr int NS = Lt::NS, HALVES = Lt::HALVES;
  const int cw = threadIdx.x / 128;     // the consumer warpgroup
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int ra = warp * 16 + lane / 4;  // accumulator rows of the thread: ra, ra + 8
  const int cq = 2 * (lane % 4);        // its first column in each 8-column block
  const int n0 = NS * cw;               // the warpgroup's first state column
  constexpr int NK = N / 16;            // k-slices of the N contraction
  // the chunk's row half of the warpgroup's hl-th y accumulator
  auto half_of = [&](int hl) { return Lt::NWG == 1 ? hl : cw; };

  // state^T (P x NS columns from n0), f32, the update's accumulator: h0's
  // entries in the accumulator's layout (as the final state is written), or 0
  float st[NS / 2];
  if (h0 != nullptr) {
    const float* hs = h0 + ((size_t)b * H + h) * N * P;
#pragma unroll
    for (int jb = 0; jb < NS / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[4 * jb + e] = hs[(n0 + 8 * jb + cq + e % 2) * P + ra + 8 * (e / 2)];
  } else {
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) st[i] = 0.f;
  }

  // the state's hi or lo term into the [p][n] buffer, bf16, swizzled; each
  // warpgroup writes its own columns
  auto put_state = [&](bool lo) {
#pragma unroll
    for (int jb = 0; jb < NS / 8; ++jb) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = ra + 8 * half;
        const float a0 = st[4 * jb + 2 * half], a1 = st[4 * jb + 2 * half + 1];
        uint32_t hi, lw;
        split2(a0, a1, hi, lw);
        const int n = n0 + 8 * jb;
        const uint32_t at = s_state + (n / 64) * Lt::S_ATOM + p * 128 +
                            ((((n % 64) / 8) ^ (p % 8)) * 16) + cq * 2;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(at), "r"(lo ? lw : hi) : "memory");
      }
    }
    fence_async_smem();
    consumers_sync<Lt::NWG>();
  };

  for (int c = 0; c < nc; ++c) {
    const int s = c % STAGES;
    mbar_wait(full(s), (c / STAGES) & 1);
    const uint32_t xs = stage(s) + Lt::X_OFF, bs = stage(s) + Lt::B_OFF,
                   cs_t = stage(s) + Lt::C_OFF;
    const float* cs2 = vec(s);        // cs log2(e)
    const float* dtv = cs2 + Q;       // dt
    const float* ecs = cs2 + 2 * Q;   // exp(cs)
    const float* wdt = cs2 + 3 * Q;   // exp(cs_Q - cs) dt
    const int c0 = c * Q;
    const int valid = min(Q, S - c0);

    // ---- y = exp(cs_i) (C_i . state) + sum_j W[i][j] x_j, per 64-row half ----
    float acc[HALVES][32];
#pragma unroll
    for (int hl = 0; hl < HALVES; ++hl)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hl][i] = 0.f;
    // the state is zero before the first chunk unless h0 is given; then
    // the first chunk's C.state runs from h0's hi + lo terms, as every
    // later chunk's from the carried state
    if (c > 0 || h0 != nullptr) {
#pragma unroll
      for (int term = 0; term < 2; ++term) {
        put_state(term == 1);
        wgmma_fence();
#pragma unroll
        for (int hl = 0; hl < HALVES; ++hl)
#pragma unroll
          for (int kk = 0; kk < NK; ++kk)
            wgmma_ss_n64(acc[hl], desc_rows(cs_t, 64 * half_of(hl), kk),
                         smem_desc(s_state + (kk / 4) * Lt::S_ATOM + (kk % 4) * 32, 16, 1024), 1);
        wgmma_commit();
        wgmma_wait_all();
        consumers_sync<Lt::NWG>();  // every product has read the buffer before it is rewritten
      }
#pragma unroll
      for (int hl = 0; hl < HALVES; ++hl) {
        const int hf = half_of(hl);
        const float ea = ecs[64 * hf + ra], eb = ecs[64 * hf + ra + 8];
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          acc[hl][4 * jb] *= ea;
          acc[hl][4 * jb + 1] *= ea;
          acc[hl][4 * jb + 2] *= eb;
          acc[hl][4 * jb + 3] *= eb;
        }
      }
    }

#pragma unroll
    for (int hl = 0; hl < HALVES; ++hl) {
      const int hf = half_of(hl);
      const int ia = 64 * hf + ra, ib = ia + 8;  // the thread's chunk rows
      const float csa = cs2[ia], csb = cs2[ib];
      const float fab = ex2(csb - csa);  // exp(cs_ib - cs_ia) <= 1
#pragma unroll
      for (int jp = 0; jp <= hf; ++jp) {  // 64-column pieces at or left of the diagonal
        float cb[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
          wgmma_ss_n64(cb, desc_rows(cs_t, 64 * hf, kk), desc_rows(bs, 64 * jp, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        // W on the accumulator, split into the A operand's register layout:
        // k-slice kk takes column blocks 2kk (regs 0, 1) and 2kk + 1 (2, 3).
        // Per 8-column block, uniform over the warp (rows 16 warp .. + 15):
        // wholly below the warp's rows, exp(cs_ib - cs_j) is exp(cs_ia -
        // cs_j) exp(cs_ib - cs_ia), both factors <= 1 (one exp for two);
        // wholly above them, W is 0; on the diagonal, each entry's own exp.
        uint32_t whi[4][4], wlo[4][4];
#pragma unroll
        for (int jb = 0; jb < 8; ++jb) {
          const int j0 = 64 * jp + 8 * jb + cq;
          const int blk = 64 * jp + 8 * jb;           // the block's first column
          const int row0 = 64 * hf + 16 * warp;       // the warp's first row
          float w[4];
          if (blk + 8 <= row0) {
            const float2 cj = *reinterpret_cast<const float2*>(cs2 + j0);
            const float2 dj = *reinterpret_cast<const float2*>(dtv + j0);
            const float e0 = ex2(csa - cj.x) * dj.x, e1 = ex2(csa - cj.y) * dj.y;
            w[0] = cb[4 * jb] * e0;
            w[1] = cb[4 * jb + 1] * e1;
            w[2] = cb[4 * jb + 2] * (e0 * fab);
            w[3] = cb[4 * jb + 3] * (e1 * fab);
          } else if (blk >= row0 + 16) {
            w[0] = w[1] = w[2] = w[3] = 0.f;
          } else {
            const float2 cj = *reinterpret_cast<const float2*>(cs2 + j0);
            const float2 dj = *reinterpret_cast<const float2*>(dtv + j0);
            w[0] = j0 <= ia ? cb[4 * jb] * (ex2(csa - cj.x) * dj.x) : 0.f;
            w[1] = j0 + 1 <= ia ? cb[4 * jb + 1] * (ex2(csa - cj.y) * dj.y) : 0.f;
            w[2] = j0 <= ib ? cb[4 * jb + 2] * (ex2(csb - cj.x) * dj.x) : 0.f;
            w[3] = j0 + 1 <= ib ? cb[4 * jb + 3] * (ex2(csb - cj.y) * dj.y) : 0.f;
          }
          split2(w[0], w[1], whi[jb / 2][2 * (jb % 2)], wlo[jb / 2][2 * (jb % 2)]);
          split2(w[2], w[3], whi[jb / 2][2 * (jb % 2) + 1], wlo[jb / 2][2 * (jb % 2) + 1]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t dx = smem_desc(xs + (4 * jp + kk) * 16 * 128, ATOM, 1024);
          wgmma_rs_n64(acc[hl], whi[kk], dx);
          wgmma_rs_n64(acc[hl], wlo[kk], dx);
        }
        wgmma_commit();
        wgmma_wait_all();
      }
      // y rows of this half, two bf16 at a time; rows past S are not written
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int r = e2 ? ib : ia;
        if (r < valid) {
          __nv_bfloat16* yrow = y + b * ysb + h * ysh + (c0 + r) * yss;
#pragma unroll
          for (int jb = 0; jb < 8; ++jb)
            *reinterpret_cast<uint32_t*>(yrow + 8 * jb + cq) =
                pack_bf16(acc[hl][4 * jb + 2 * e2], acc[hl][4 * jb + 2 * e2 + 1]);
        }
      }
    }

    // ---- state^T = exp(cs_Q) state^T + sum_j (x_j w_j)^T B_j, w_j =
    //      exp(cs_Q - cs_j) dt_j: the A operand by ldmatrix.trans of x ------------
    const float decay = ecs[Q - 1];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) st[i] *= decay;
    uint32_t ahi[8][4], alo[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int mi = lane / 8;
      const int row = 16 * kk + 8 * (mi / 2) + lane % 8;  // x row (token) of this lane's address
      const int chunk = 2 * warp + (mi % 2);              // its 16-byte column chunk (p / 8)
      uint32_t xr[4];
      ldmatrix_x4_trans(xr, xs + row * 128 + ((chunk ^ (row & 7)) * 16));
      const int j = 16 * kk + cq;  // regs 0, 1: tokens j, j + 1; regs 2, 3: j + 8, j + 9
      const float2 wa = *reinterpret_cast<const float2*>(wdt + j);
      const float2 wb = *reinterpret_cast<const float2*>(wdt + j + 8);
      const float w0 = wa.x, w1 = wa.y, w8 = wb.x, w9 = wb.y;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 xv = unpack_bf16(xr[r]);
        split2(xv.x * (r < 2 ? w0 : w8), xv.y * (r < 2 ? w1 : w9), ahi[kk][r], alo[kk][r]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      // B's columns n0 .. n0 + NS (whole atoms), rows kk * 16 ..
      const uint64_t db = smem_desc(bs + (n0 / 64) * ATOM + kk * 16 * 128, ATOM, 1024);
      if constexpr (NS == 64) {
        wgmma_rs_n64(st, ahi[kk], db);
        wgmma_rs_n64(st, alo[kk], db);
      } else {
        wgmma_rs_n128(st, ahi[kk], db);
        wgmma_rs_n128(st, alo[kk], db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    mbar_arrive(empty(s));
  }

  if (final_state != nullptr) {
    float* fs = final_state + ((size_t)b * H + h) * N * P;
#pragma unroll
    for (int jb = 0; jb < NS / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fs[(n0 + 8 * jb + cq + e % 2) * P + ra + 8 * (e / 2)] = st[4 * jb + e];
  }
}

template <int N>
int launch(const void* x, const void* dt, const float* A, const void* Bm, const void* Cm,
           void* y, float* final_state, const float* h0, int B, int H, int G, int S,
           const long long* st, cudaStream_t stream) {
  using Lt = Layout<N>;
  CUtensorMap tx, tb, tc;
  int err;
  if ((err = make_map(&tx, x, P, S, H, B, st, Q)) != 0) return err;
  if ((err = make_map(&tb, Bm, N, S, G, B, st + 6, Q)) != 0) return err;
  if ((err = make_map(&tc, Cm, N, S, G, B, st + 9, Q)) != 0) return err;
  auto kernel = ssd_scan_wgmma_kernel<N>;
  // the opt-in holds for the function as loaded on the current device only,
  // so it is granted on every launch (no flag shared by devices or threads)
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lt::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B);
  kernel<<<grid, Lt::THREADS, Lt::SMEM, stream>>>(
      tx, tb, tc, static_cast<const __nv_bfloat16*>(dt), A, static_cast<__nv_bfloat16*>(y),
      final_state, h0, H, G, S, st[3], st[4], st[5], st[12], st[13], st[14]);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 only; P = 64, chunk 128, N = 64 or 128.  strides: 15 element
// strides, in order x (b, h, s), dt (b, h, s), Bm (b, g, s), Cm (b, g, s),
// y (b, h, s); those of x, Bm and Cm are multiples of 8 (16 bytes) with
// 16-byte aligned bases, those of y even with a 4-byte aligned base; the
// last axis of x, Bm, Cm and y has unit stride.  final_state and the
// initial state h0 are (B, H, N, P) f32 contiguous, or null (h0 null: a
// zero initial state).  The wrapper guarantees these,
// H % G == 0 and S > 0.  Returns a cudaError_t, or ERR_NO_ENCODE /
// ERR_ENCODE (0 = launched).
extern "C" int ssd_scan_wgmma_launch(const void* x, const void* dt, const void* A,
                                     const void* Bm, const void* Cm, void* y, void* final_state,
                                     const void* h0, int B, int H, int G, int S, int N,
                                     const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  float* fin = static_cast<float*>(final_state);
  const float* init = static_cast<const float*>(h0);
  if (N == 64) return launch<64>(x, dt, Af, Bm, Cm, y, fin, init, B, H, G, S, strides, s);
  if (N == 128) return launch<128>(x, dt, Af, Bm, Cm, y, fin, init, B, H, G, S, strides, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* ssd_scan_wgmma_error_string(int err) {
  return hopper::error_string(err);
}
