// GUS greedy assignment (the paper's Algorithm 1) for a batch of frames,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/gus_pallas.py::gus_assign_pallas
// (pallas_call at gus_pallas.py:155, body _gus_kernel at :60): Eq. 1 utility,
// hard feasibility and the sequential greedy over N requests, each step a
// masked argmax over the (M, L) candidate slab under the depleting per-server
// compute (gamma) and uplink (eta) budgets.  It also returns each frame's
// committed per-server loads, summed in request order (see below).
//
// What bounds it on the card.  Every input byte is read once: per frame
// N*M*L*17 B (acc, ctime, v, u as f32 plus avail as u8) + N*20 B of request
// rows + M*8 B of budgets, and the outputs written once — 0.68 ms at the
// dense fleet's window (B 5120, N 256, M = L = 10) at 3.35 TB/s.  Each frame
// is one dependent chain of N argmax steps, each step's budget commit landing
// before the next step's test, so the design takes every device-memory
// access, and every operation that does not depend on the budgets, off that
// chain, and runs enough chains side by side to keep the memory busy.
//
// Design: one block per frame (one call launches this one kernel; no scratch
// in device memory, no atomics), three roles over one ring of STAGES stages in
// shared memory, each stage a tile of TR request rows.  The launcher picks TR
// (at most MAX_TILE) so that MIN_BLOCKS blocks share an SM — 10 rows at the
// fleets' M*L = 100 — and fewer for wider rows; a frame's last tile holds the
// N % TR rows left.
//   * Producer (warp 1): lane 0 bulk-copies (cp.async.bulk, completing on
//     the stage's mbarrier) the 16-byte aligned interior of the tile's acc,
//     ctime, v, u and avail.  A row's avail is M*L bytes, which need be
//     neither a multiple of 16 nor aligned at row i, so each array's ragged
//     head and tail (< 16 bytes each) are copied by the warp's lanes, one
//     element a lane, and lane k copies row k's cover, A, C, w_a and w_c;
//     these loads are issued before the producer waits for the stage, then
//     all 32 lanes arrive.  Every later read is a plain shared-memory load.
//   * Score (warps 2 .. 1 + SCORE_WARPS, the tile's cells spread over all
//     their lanes): the utility us op for op (below) and the static
//     feasibility avail && acc >= A && ctime <= C, folded into one ordered
//     uint32 key per cell, written over the cell's acc: 0 where the cell is
//     infeasible or us <= NEG (it is never picked), else us's sign-flipped
//     bits with -0 folded onto +0, so that a > b iff key(a) > key(b) and equal
//     floats have equal keys.  A row with a usable cell is marked usable.
//   * Chain (warp 0).  A row that is not usable (every padding row) is
//     dropped at once, with no warp operation.  Otherwise lane i takes cells
//     i, i + 32, .. (4 a lane, unrolled, for rows of up to SMALL_CELLS): key,
//     v and u from shared memory, the budget test v <= gamma[j] && (j == s ||
//     u <= eta[s]), and keeps its best key (the first on ties).  Two warp
//     reductions (redux.sync) find the largest key and then the lowest flat
//     index j*L + l holding it; the request is served iff that key is not 0.
//     The winner's v, u and j reach every lane by __shfl_sync from the lane
//     that holds them.  No device-memory access sits on the chain: lane k
//     keeps row k's (j, l), and the tile's outputs leave by one coalesced
//     store when the chain is done with it.
//   * Budgets: with M <= 32 (the fleets' M = 10 and 21), lane m holds
//     gamma[m], eta[m] and the committed loads w[m], c[m] in registers;
//     gamma[j] and eta[s] reach every lane by __shfl_sync.  With M > 32 they
//     live in shared memory, lane 0 commits between two __syncwarp.
//
// Width limit.  A stage must hold at least one row (17 B a cell), STAGES
// times, beside 16 B a server of budgets: rows of at most MAX_CELLS = 4096
// cells and MAX_SERVERS = 1024 servers, which the wrapper (kernels/gus.py)
// refuses before the launch; the fleets build rows of 100-210 cells.
//
// Bit-parity hazards, each handled explicitly:
//   * FMA contraction: us = w_a*acc_term + w_c*time_term must be two rounded
//     products and one rounded add.  The utility uses __fmul_rn/__fadd_rn/
//     __fsub_rn, which the compiler never contracts, and the library is
//     built with --fmad=false as well.  Never --use_fast_math.
//   * Division: (acc - A)/max_as and (C - ctime)/max_cs are IEEE divisions
//     (__fdiv_rn), as in the reference.
//   * Sentinel: the reference scores a masked candidate NEG = -1e30 and
//     serves a request iff its best score is > NEG.  So a feasible cell with
//     us <= NEG is never picked: it gets key 0 with the infeasible ones.
//   * Tie-breaking: among equal scores the lowest flat index j*L + l wins
//     (the reference's first-occurrence argmax).  Each lane scans its flats
//     in increasing order and replaces only on a strictly greater key; the
//     second reduction takes the lowest flat among the lanes holding the
//     largest key.  -0 and +0 share a key.  NaN scores are not handled, as in
//     the reference (whose backends differ on them).
//   * Relaxed budgets: Happy-* passes gamma/eta = +inf; v <= inf holds and
//     inf + (-v) stays inf.
//   * Budget commit: gamma[j] + (-v) and eta[s] + (-u), rounded adds, as the
//     reference's .at[].add of the negated cost, on register or shared copies.
//   * Committed loads: the congested fleet's backlog update needs
//     w[j] = sum of served v and c[s] = sum of offloaded u.  An atomicAdd
//     sums in no fixed order, and a 1-ulp change in the backlog can flip a
//     later greedy decision, so the chain adds them at each commit, in
//     request order, the order of the reference's sequential scatter-add.
//   * N = 0: the wrapper returns empty outputs without a launch.
//   * 64-bit offsets: B*N*M*L reaches ~1.3e8 at the fleet window.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int STAGES = 3;
constexpr int SCORE_WARPS = 3;
constexpr int THREADS = 32 * (2 + SCORE_WARPS);
constexpr int MIN_BLOCKS = 4;   // blocks per SM the tile size aims for
constexpr int MAX_TILE = 16;    // rows per tile; <= 32, since lane k keeps row k's outputs
constexpr int SMALL_CELLS = 128;  // rows up to this width: 4 cells a lane, unrolled
constexpr int MAX_CELLS = 4096;
constexpr int MAX_SERVERS = 1024;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ERR_TOO_WIDE = 10003;  // a request row is wider than the kernel takes

__host__ __device__ __forceinline__ size_t pad16(size_t n) { return (n + 15) & ~size_t(15); }

// The layout of one block's shared memory for tiles of `tr` rows of `ml`
// cells and `m` servers.  Each bulk-copied array of a stage has 16 bytes of
// slack: its region starts at the 16-byte boundary at or below the tile's
// first byte in device memory, so the bulk copy of the aligned interior lands
// at the same offset as in device memory.
struct Layout {
  size_t f32_cells, u8_cells, row, stage, scratch, bars, total;

  __host__ __device__ Layout(int tr, int ml, int m) {
    f32_cells = pad16((size_t)tr * ml * 4) + 16;
    u8_cells = pad16((size_t)tr * ml) + 16;
    row = pad16((size_t)tr * 4);
    // acc (then the keys), ctime, v, u, avail; cover, A, C, w_a, w_c, usable
    stage = 4 * f32_cells + u8_cells + 6 * row;
    scratch = STAGES * stage;  // budgets and loads (M > 32)
    bars = scratch + pad16((size_t)4 * m * 4);
    total = bars + 8 * 3 * STAGES;
  }
};

// One bulk-copied array of a staged tile: elements [e0, e1) of `g` live in
// the stage region `r`, the byte at device address x at r[x - lo16].
template <typename T>
struct Tile {
  uint8_t* r;
  uint64_t lo, hi;  // byte addresses of the tile's elements

  __device__ Tile(const T* g, uint8_t* r_, uint64_t e0, uint64_t e1)
      : r(r_), lo(reinterpret_cast<uint64_t>(g + e0)), hi(reinterpret_cast<uint64_t>(g + e1)) {}
  __device__ uint64_t lo16() const { return lo & ~uint64_t(15); }
  // [a, bnd): the 16-byte aligned interior, bulk-copied
  __device__ uint64_t a() const { return (lo + 15) & ~uint64_t(15); }
  __device__ uint64_t bnd() const {
    const uint64_t x = hi & ~uint64_t(15);
    return x > a() ? x : a();
  }
  __device__ uint32_t bulk_bytes() const { return (uint32_t)(bnd() - a()); }
  __device__ void copy(uint32_t bar) const {
    if (bnd() > a())
      bulk_load(smem_u32(r + (a() - lo16())), reinterpret_cast<const void*>(a()), bulk_bytes(), bar);
  }
  // The ragged head [lo, min(a, hi)) and tail [bnd, hi), each < 16 bytes:
  // lane i copies element i of each, loading (load_ends) before storing
  // (store_ends), so that all arrays' loads are in flight together.
  struct Ends {
    T h, t;
  };
  __device__ uint64_t head(int lane) const { return lo + (uint64_t)lane * sizeof(T); }
  __device__ uint64_t tail(int lane) const { return bnd() + (uint64_t)lane * sizeof(T); }
  __device__ bool in_head(uint64_t x) const { return x < a() && x < hi; }
  __device__ Ends load_ends(int lane) const {
    Ends e{};
    const uint64_t x = head(lane), y = tail(lane);
    if (in_head(x)) e.h = *reinterpret_cast<const T*>(x);
    if (y < hi) e.t = *reinterpret_cast<const T*>(y);
    return e;
  }
  __device__ void store_ends(const Ends& e, int lane) const {
    const uint64_t x = head(lane), y = tail(lane);
    if (in_head(x)) *reinterpret_cast<T*>(r + (x - lo16())) = e.h;
    if (y < hi) *reinterpret_cast<T*>(r + (y - lo16())) = e.t;
  }
  // the tile's elements in shared memory: at()[e - e0]
  __device__ __forceinline__ T* at() const { return reinterpret_cast<T*>(r + (lo - lo16())); }
};

// order this thread's generic-proxy writes to shared memory before later
// bulk copies (async proxy) into the same bytes, which a later tile's copy
// may overwrite once the barriers have passed the stage on
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ unsigned score_key(float x) {
  unsigned b = __float_as_uint(x);
  if ((b << 1) == 0) b = 0;  // -0 and +0 compare equal: one key
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The chain's budgets and committed loads: in lane registers (REG, M <= 32)
// or in shared memory.
template <bool REG>
struct Budgets {
  float g, e, w, c;  // lane m's gamma[m], eta[m], w[m], c[m] (REG)
  float* s;          // gamma, eta, w, c in shared memory, M each (!REG)
  int lane, M;

  __device__ Budgets(const float* gamma, const float* eta, int M_, float* smem, int lane_)
      : g(0.f), e(0.f), w(0.f), c(0.f), s(smem), lane(lane_), M(M_) {
    if (REG) {
      if (lane < M) {
        g = gamma[lane];
        e = eta[lane];
      }
    } else {
      for (int m = lane; m < M; m += 32) {
        s[m] = gamma[m];
        s[M + m] = eta[m];
        s[2 * M + m] = 0.f;
        s[3 * M + m] = 0.f;
      }
      __syncwarp();
    }
  }
  // every lane calls these, with its own j (gamma) or the request's s (eta)
  __device__ __forceinline__ float gamma_of(int j) const {
    return REG ? __shfl_sync(FULL, g, j) : s[j];
  }
  __device__ __forceinline__ float eta_of(int sv) const {
    return REG ? __shfl_sync(FULL, e, sv) : s[M + sv];
  }
  // a uniform call: the same arguments in every lane
  __device__ __forceinline__ void commit(int j, int sv, float vv, float uu) {
    const bool offl = j != sv;
    if (REG) {
      if (lane == j) {
        g = __fadd_rn(g, -vv);
        w = __fadd_rn(w, vv);
      }
      if (offl && lane == sv) {
        e = __fadd_rn(e, -uu);
        c = __fadd_rn(c, uu);
      }
    } else {
      __syncwarp();  // every lane has read this step's budgets
      if (lane == 0) {
        s[j] = __fadd_rn(s[j], -vv);
        s[2 * M + j] = __fadd_rn(s[2 * M + j], vv);
        if (offl) {
          s[M + sv] = __fadd_rn(s[M + sv], -uu);
          s[3 * M + sv] = __fadd_rn(s[3 * M + sv], uu);
        }
      }
      __syncwarp();
    }
  }
  __device__ void store(float* out_w, float* out_c) const {
    if (REG) {
      if (lane < M) {
        out_w[lane] = w;
        out_c[lane] = c;
      }
    } else {
      for (int m = lane; m < M; m += 32) {
        out_w[m] = s[2 * M + m];
        out_c[m] = s[3 * M + m];
      }
    }
  }
};

// REG: budgets in lane registers (M <= 32).  SMALL: rows of at most
// SMALL_CELLS cells, each lane's 4 cells loaded and tested unrolled.
template <bool REG, bool SMALL>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gus_assign_kernel(
    const int32_t* __restrict__ cover, const float* __restrict__ A,
    const float* __restrict__ C, const float* __restrict__ w_a,
    const float* __restrict__ w_c, const float* __restrict__ acc,
    const float* __restrict__ ctime, const float* __restrict__ v,
    const float* __restrict__ u, const uint8_t* __restrict__ avail,
    const float* __restrict__ gamma, const float* __restrict__ eta,
    const float* __restrict__ max_as, const float* __restrict__ max_cs,
    int32_t* __restrict__ out_j, int32_t* __restrict__ out_l,
    float* __restrict__ out_w, float* __restrict__ out_c,
    int N, int M, int L, int tr) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ML = M * L;
  const Layout lay(tr, ML, M);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (N + tr - 1) / tr;
  const uint32_t bars = smem_u32(smem + lay.bars);
  auto full = [&](int s) { return bars + 8 * s; };                  // the tile has landed
  auto scored = [&](int s) { return bars + 8 * (STAGES + s); };     // its keys are written
  auto empty = [&](int s) { return bars + 8 * (2 * STAGES + s); };  // the chain is done with it

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 32);
      mbar_init(scored(s), 32 * SCORE_WARPS);
      mbar_init(empty(s), 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the arrays of tile t in stage s: the frame's rows [r0, r0 + n) (n < tr
  // only for a frame's last tile)
  struct Tiles {
    Tile<float> acc, ctime, v, u;
    Tile<uint8_t> avail;
    int32_t* cover;
    float *A, *C, *wa, *wc;
    int32_t* usable;  // whether the row has a usable cell
    uint64_t r0;
    int n;
  };
  auto tile = [&](int t) {
    const int n = min(tr, N - t * tr);
    const uint64_t r0 = (uint64_t)b * N + (uint64_t)t * tr;
    const uint64_t c0 = r0 * ML, c1 = (r0 + n) * ML;
    uint8_t* st = smem + (size_t)(t % STAGES) * lay.stage;
    uint8_t* rows = st + 4 * lay.f32_cells + lay.u8_cells;
    return Tiles{Tile<float>(acc, st, c0, c1),
                 Tile<float>(ctime, st + lay.f32_cells, c0, c1),
                 Tile<float>(v, st + 2 * lay.f32_cells, c0, c1),
                 Tile<float>(u, st + 3 * lay.f32_cells, c0, c1),
                 Tile<uint8_t>(avail, st + 4 * lay.f32_cells, c0, c1),
                 reinterpret_cast<int32_t*>(rows),
                 reinterpret_cast<float*>(rows + lay.row),
                 reinterpret_cast<float*>(rows + 2 * lay.row),
                 reinterpret_cast<float*>(rows + 3 * lay.row),
                 reinterpret_cast<float*>(rows + 4 * lay.row),
                 reinterpret_cast<int32_t*>(rows + 5 * lay.row), r0, n};
  };

  if (warp == 1) {
    // ---- producer -------------------------------------------------------------
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const Tiles tl = tile(t);
      // lane k < n loads row k's scalars, every lane its elements of the
      // cells' ragged ends: all loads in flight before the stage is free
      const bool has_row = lane < tl.n;
      const uint64_t row = tl.r0 + lane;
      int32_t r_cover = 0;
      float r_A = 0.f, r_C = 0.f, r_wa = 0.f, r_wc = 0.f;
      if (has_row) {
        r_cover = cover[row];
        r_A = A[row];
        r_C = C[row];
        r_wa = w_a[row];
        r_wc = w_c[row];
      }
      const auto e0 = tl.acc.load_ends(lane);
      const auto e1 = tl.ctime.load_ends(lane);
      const auto e2 = tl.v.load_ends(lane);
      const auto e3 = tl.u.load_ends(lane);
      const auto e4 = tl.avail.load_ends(lane);
      mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
      const uint32_t bar = full(s);
      if (lane == 0) {
        mbar_add_tx(bar, tl.acc.bulk_bytes() + tl.ctime.bulk_bytes() + tl.v.bulk_bytes() +
                             tl.u.bulk_bytes() + tl.avail.bulk_bytes());
        tl.acc.copy(bar);
        tl.ctime.copy(bar);
        tl.v.copy(bar);
        tl.u.copy(bar);
        tl.avail.copy(bar);
      }
      tl.acc.store_ends(e0, lane);
      tl.ctime.store_ends(e1, lane);
      tl.v.store_ends(e2, lane);
      tl.u.store_ends(e3, lane);
      tl.avail.store_ends(e4, lane);
      if (has_row) {
        tl.cover[lane] = r_cover;
        tl.A[lane] = r_A;
        tl.C[lane] = r_C;
        tl.wa[lane] = r_wa;
        tl.wc[lane] = r_wc;
        tl.usable[lane] = 0;
      }
      fence_proxy_async();
      mbar_arrive(bar);  // after the lane's plain copies (release)
    }
    return;
  }

  if (warp >= 2) {
    // ---- score: the tile's cells, spread over the SCORE_WARPS warps -----------
    constexpr int ST = 32 * SCORE_WARPS;
    const int tid = threadIdx.x - 64;
    const float mas = max_as[b], mcs = max_cs[b];
    // cell e = k*ML + f of a tile, stepped by ST, not divided
    const int k_tid = tid / ML, f_tid = tid % ML, k_step = ST / ML, f_step = ST % ML;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(full(s), (t / STAGES) & 1);
      const Tiles tl = tile(t);
      uint32_t* keys = reinterpret_cast<uint32_t*>(tl.acc.at());  // over acc
      const float* t_ct = tl.ctime.at();
      const uint8_t* t_av = tl.avail.at();
      const int n_cells = tl.n * ML;
      int k = k_tid, f = f_tid;
#pragma unroll 4
      for (int e = tid; e < n_cells; e += ST) {
        const float Ai = tl.A[k], Ci = tl.C[k];
        const float a = __uint_as_float(keys[e]);
        const float ct = t_ct[e];
        const float acc_term = __fdiv_rn(__fsub_rn(a, Ai), mas);
        const float time_term = __fdiv_rn(__fsub_rn(Ci, ct), mcs);
        const float us = __fadd_rn(__fmul_rn(tl.wa[k], acc_term), __fmul_rn(tl.wc[k], time_term));
        const bool ok = t_av[e] != 0 && a >= Ai && ct <= Ci && us > NEG;
        keys[e] = ok ? score_key(us) : 0u;
        if (ok) tl.usable[k] = 1;
        k += k_step;
        f += f_step;
        if (f >= ML) {
          f -= ML;
          ++k;
        }
      }
      fence_proxy_async();
      mbar_arrive(scored(s));
    }
    return;
  }

  // ---- the chain (warp 0) ----------------------------------------------------------
  Budgets<REG> bud(gamma + (size_t)b * M, eta + (size_t)b * M, M,
                   reinterpret_cast<float*>(smem + lay.scratch), lane);
  // (j, l) of the lane's cells lane, lane + 32, ..: stepped, not divided
  const int j_lane = lane / L, l_lane = lane % L, j_step = 32 / L, l_step = 32 % L;
  const int n_q = SMALL ? SMALL_CELLS / 32 : (ML + 31) / 32;  // cells per lane

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(full(s), (t / STAGES) & 1);
    mbar_wait(scored(s), (t / STAGES) & 1);
    const Tiles tl = tile(t);
    const uint32_t* keys = reinterpret_cast<const uint32_t*>(tl.acc.at());
    const float* t_v = tl.v.at();
    const float* t_u = tl.u.at();
    int my_j = -1, my_l = -1;  // lane k: row k's assignment
    for (int k = 0; k < tl.n; ++k) {
      int jw = -1, lw = -1;
      if (tl.usable[k] != 0) {  // else nothing can serve the row
        const int sv = tl.cover[k];
        const float eta_s = bud.eta_of(sv);
        const size_t c0 = (size_t)k * ML;
        unsigned best = 0u, best_f = 0xffffffffu;
        float best_v = 0.f, best_u = 0.f;
        int best_j = 0;
        int j = j_lane, l = l_lane;
#pragma unroll
        for (int q = 0; q < n_q; ++q) {
          const int f = lane + 32 * q;
          const bool in = f < ML;
          const size_t e = c0 + (in ? f : 0);
          const unsigned key = keys[e];
          const float vv = t_v[e], uu = t_u[e];
          const float gj = bud.gamma_of(in ? j : 0);
          const bool ok = in && vv <= gj && (j == sv || uu <= eta_s);
          if (ok && key > best) {
            best = key;
            best_f = (unsigned)f;
            best_v = vv;
            best_u = uu;
            best_j = j;
          }
          j += j_step;
          l += l_step;
          if (l >= L) {
            l -= L;
            ++j;
          }
        }
        const unsigned top = __reduce_max_sync(FULL, best);
        if (top != 0u) {
          const unsigned flat = __reduce_min_sync(FULL, best == top ? best_f : 0xffffffffu);
          const int src = (int)(flat & 31u);
          const float vv = __shfl_sync(FULL, best_v, src);
          const float uu = __shfl_sync(FULL, best_u, src);
          jw = __shfl_sync(FULL, best_j, src);
          lw = (int)flat - jw * L;
          bud.commit(jw, sv, vv, uu);
        }
      }
      if (lane == k) {
        my_j = jw;
        my_l = lw;
      }
    }
    if (lane < tl.n) {
      out_j[tl.r0 + lane] = my_j;
      out_l[tl.r0 + lane] = my_l;
    }
    __syncwarp();
    mbar_arrive(empty(s));
  }
  bud.store(out_w + (size_t)b * M, out_c + (size_t)b * M);
}

template <bool REG, bool SMALL>
int launch(const void* const* p, int B, int N, int M, int L, int tr, size_t smem,
           cudaStream_t stream) {
  const void* kernel = (const void*)gus_assign_kernel<REG, SMALL>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  gus_assign_kernel<REG, SMALL><<<B, THREADS, smem, stream>>>(
      (const int32_t*)p[0], (const float*)p[1], (const float*)p[2], (const float*)p[3],
      (const float*)p[4], (const float*)p[5], (const float*)p[6], (const float*)p[7],
      (const float*)p[8], (const uint8_t*)p[9], (const float*)p[10], (const float*)p[11],
      (const float*)p[12], (const float*)p[13], (int32_t*)p[14], (int32_t*)p[15],
      (float*)p[16], (float*)p[17], N, M, L, tr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// ERR_TOO_WIDE when a request row is wider than the kernel takes.  The caller
// has checked shapes, dtypes and contiguity and made sure B > 0 and N > 0.
int gus_assign_launch(
    const void* cover, const void* A, const void* C, const void* w_a,
    const void* w_c, const void* acc, const void* ctime, const void* v,
    const void* u, const void* avail, const void* gamma, const void* eta,
    const void* max_as, const void* max_cs, void* out_j, void* out_l,
    void* out_w, void* out_c, int B, int N, int M, int L, void* stream) {
  const int ML = M * L;
  if (ML > MAX_CELLS || M > MAX_SERVERS) return ERR_TOO_WIDE;
  int dev = 0, max_smem = 0, sm_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  // the largest tile with which MIN_BLOCKS blocks share an SM (1 KB of each
  // block's share is the system's), else the largest one block can hold
  const size_t share = (size_t)sm_smem / MIN_BLOCKS - 1024;
  int tr = MAX_TILE;
  while (tr > 1 && Layout(tr, ML, M).total > share) --tr;
  if (Layout(tr, ML, M).total > share)
    while (tr > 1 && Layout(tr, ML, M).total > (size_t)max_smem) --tr;
  const size_t smem = Layout(tr, ML, M).total;
  if (smem > (size_t)max_smem) return ERR_TOO_WIDE;
  const void* const p[18] = {cover, A, C, w_a, w_c, acc, ctime, v, u, avail,
                             gamma, eta, max_as, max_cs, out_j, out_l, out_w, out_c};
  cudaStream_t st = (cudaStream_t)stream;
  const bool reg = M <= 32, small = ML <= SMALL_CELLS;
  if (reg) return small ? launch<true, true>(p, B, N, M, L, tr, smem, st)
                        : launch<true, false>(p, B, N, M, L, tr, smem, st);
  return small ? launch<false, true>(p, B, N, M, L, tr, smem, st)
               : launch<false, false>(p, B, N, M, L, tr, smem, st);
}

const char* gus_error_string(int err) {
  if (err == ERR_TOO_WIDE)
    return "a request row is wider than the kernel takes (M * L <= 4096 cells, M <= 1024)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
