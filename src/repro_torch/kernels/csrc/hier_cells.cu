// Hierarchical class allocator (analytic chunk greedy over QoS classes) for
// a batch of frames, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/hier_pallas.py::hier_cells_pallas
// (pallas_call at hier_pallas.py:178, body _hier_kernel at :61).  Per frame
// it walks the C classes in order, carrying the per-server compute (gamma)
// and uplink (eta) budgets across them.  Per class it repeats: a masked
// argmax over the class's M*L cells, an analytic chunk
// t = min(rem, floor(gamma[j] / v), floor(eta[s] / u)), and the budget
// commit — until the class is exhausted or nothing fits.  Outputs are the
// fixed-shape cell tensors take[b, c, j, l] (members placed on (j, l)) and
// start[b, c, j, l] (their first member offset), and optionally the
// frame's committed per-server loads, summed in a fixed order (below).
//
// What bounds it on the card.  Every input byte is read once: per frame
// C*M*L*13 B (us, v, u as f32, feas as u8) + C*8 B (cover, count) + M*8 B,
// and the outputs written once — a byte bound well under a millisecond at
// the fleet's city-scale shapes.  What sets the pace is the chain: each
// frame is one dependent chain of C classes, each of one or more chunk
// steps, and each step's budget commit must land before the next step's
// feasibility test.  So the design takes every device-memory access off
// that chain and keeps each step short.
//
// Design: one block per frame (one call launches this one kernel), three
// roles over one ring of STAGES stages in shared memory, each stage a tile
// of TC classes (16 at M*L = 210; fewer when a row is wider; the last tile
// of a frame holds the C % TC classes left, so C need not be a multiple).
//   * Producer (warp 1, one elected lane): stages each tile's us, v, u,
//     feas rows, cover and count by bulk copies (cp.async.bulk, completing
//     on the stage's mbarrier), STAGES - 1 tiles ahead of the chain.  A
//     bulk copy needs 16-byte aligned addresses and sizes, which a tile of
//     an arbitrary frame need not have: it takes the aligned interior of
//     each array's byte range, and the lane copies the ragged head and
//     tail (< 16 bytes each) itself before it arrives on the barrier, so
//     every later read is a plain shared-memory load.
//   * Summary (warps 2 .. 1 + SUMMARY_WARPS, one class per warp at a
//     time): for each server j, the smallest v and the smallest u among the
//     class's usable cells on j (feas && us > NEG), +inf where there is
//     none.
//   * Chain (warp 0).  Per class it first tests the summary: lane j checks
//     whether server j's smallest v fits gamma[j] and, off the class's own
//     server s, its smallest u fits eta[s].  A cell can pass the budget
//     test only where this holds, so when no lane passes, the class can
//     place nobody and ends — exactly what the full argmax would find (its
//     best score would be NEG), at the cost of one load and one vote; that
//     is the common case once a city-scale frame has spent its budgets.
//     Otherwise the step loop runs the argmax over the class's cells from
//     shared memory (lane i taking cells i, i + 32, ..), with the winner
//     found by two warp reductions (redux.sync): the largest score, then
//     the lowest flat index holding it.  Scores are compared as ordered
//     unsigned keys (sign-flipped bits, -0 folded onto +0 so that equal
//     floats give equal keys); NaN scores are not handled, as in the
//     reference.  No device-memory load sits on the chain: take and start
//     are written by fire-and-forget stores (a cell's take once, when the
//     walk leaves it).
//   * Budgets: with M <= 32 (the fleet's M = 21), lane m holds gamma[m] and
//     eta[m] in registers; gamma[j] reaches every lane by one __shfl_sync,
//     and the class's eta[s] is a register copy that lane s takes back when
//     the class ends.  This keeps the step free of shared-memory round
//     trips and of the __syncwarp pairs that a shared copy needs between a
//     read and lane 0's commit.  With M > 32 the budgets live in shared
//     memory, behind those __syncwarp pairs.
//
// Bit-parity hazards, each handled explicitly (the f32 op sequence of the
// reference's NumPy oracle, XLA scan and Pallas kernel is the contract):
//   * chunk size: cap_g = floor(gamma[j] / v) when v > 0, else the
//     remainder; cap_e = floor(eta[s] / u) when offloaded and u > 0, else
//     the remainder; t = int(min(rem, min(cap_g, cap_e))).  The min against
//     the remainder comes before the int cast (overflow guard for tiny
//     costs).  IEEE division (__fdiv_rn), library built with --fmad=false.
//   * commit: gamma[j] + (-(f32(t) * v)) and eta[s] + (-(f32(t) * u)) when
//     offloaded — rounded product, rounded add (__fmul_rn/__fadd_rn).
//   * argmax: sentinel NEG = -1e30; a cell is usable iff its score is >
//     NEG; among equal scores the lowest flat j*L + l wins.
//   * a class with count <= 0 (padding) or no usable cell never touches the
//     budgets; a chunk of t < 1 ends the class.
//   * re-picks: a cell, once left, is never picked again in its class (its
//     score is fixed and budgets only shrink, so it left because it failed
//     the test, and fails it from then on); a re-pick is always of the
//     previous cell, whose take the chain keeps in a register.
//   * committed loads (congestion on): w[j] adds f32(take) * v over classes
//     in order and, within a class, over l; c_load[cover[c]] adds each
//     class's sum of f32(take) * u over its cells in row-major (j, l)
//     order, in class order.  Lane 0 of the chain sorts the class's few
//     cells by flat index and adds them — the order of the plain PyTorch
//     version, on any device.  Atomics would add in no fixed order.
//   * 64-bit offsets: B*C*M*L reaches ~1.6e8 at city-scale windows.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int STAGES = 3;
constexpr int SUMMARY_WARPS = 4;
constexpr int THREADS = 32 * (2 + SUMMARY_WARPS);
constexpr int MAX_TILE = 16;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int ERR_TOO_WIDE = 10003;  // a frame row does not fit shared memory

__host__ __device__ __forceinline__ size_t pad16(size_t n) { return (n + 15) & ~size_t(15); }

// The layout of one block's shared memory for tiles of `tc` classes of
// `ml` cells and `m` servers.  Each array of a stage has 16 bytes of slack:
// its region starts at the 16-byte boundary at or below the tile's first
// byte in device memory, so the bulk copy of the aligned interior lands at
// the same offset as in device memory.
struct Layout {
  size_t f32_cells, u8_cells, i32_rows, summary, stage, scratch, bars, total;

  __host__ __device__ Layout(int tc, int ml, int m) {
    f32_cells = pad16((size_t)tc * ml * 4) + 16;
    u8_cells = pad16((size_t)tc * ml) + 16;
    i32_rows = pad16((size_t)tc * 4) + 16;
    summary = pad16((size_t)tc * m * 8);
    // us, v, u, feas, cover, count, then the summaries
    stage = 3 * f32_cells + u8_cells + 2 * i32_rows + summary;
    // chain scratch: gamma, eta (M > 32), w, c_load, and the class's cells
    // (flat, take, v, u) for the committed loads
    scratch = STAGES * stage;
    bars = scratch + pad16((size_t)4 * m * 4 + (size_t)4 * ml * 4);
    total = bars + 8 * 3 * STAGES;
  }
};

// One array of a staged tile: elements [e0, e1) of `g` live in the stage
// region `r`, the byte at device address x at r[x - lo16].
template <typename T>
struct Tile {
  uint8_t* r;
  uint64_t lo, hi, lo16, a, bnd;  // byte addresses; [a, bnd): the bulk-copied interior

  __device__ Tile(const T* g, uint8_t* r_, uint64_t e0, uint64_t e1) : r(r_) {
    lo = reinterpret_cast<uint64_t>(g + e0);
    hi = reinterpret_cast<uint64_t>(g + e1);
    lo16 = lo & ~uint64_t(15);
    a = (lo + 15) & ~uint64_t(15);
    bnd = hi & ~uint64_t(15);
    if (bnd < a) bnd = a;
  }
  __device__ uint32_t bulk_bytes() const { return (uint32_t)(bnd - a); }
  // the producer: the ragged head and tail by plain loads (stage_ends),
  // the interior by one bulk copy completing on `bar` (copy)
  __device__ void stage_ends() const {
    for (uint64_t x = lo; x < hi && x < a; ++x) r[x - lo16] = *reinterpret_cast<const uint8_t*>(x);
    for (uint64_t x = bnd > a ? bnd : a; x < hi; ++x)
      r[x - lo16] = *reinterpret_cast<const uint8_t*>(x);
  }
  __device__ void copy(uint32_t bar) const {
    if (bnd > a)
      bulk_load(smem_u32(r + (a - lo16)), reinterpret_cast<const void*>(a), bulk_bytes(), bar);
  }
  // the tile's elements in shared memory: at()[e - e0]
  __device__ __forceinline__ const T* at() const {
    return reinterpret_cast<const T*>(r + (lo - lo16));
  }
};

__device__ __forceinline__ unsigned score_key(float x) {
  unsigned b = __float_as_uint(x);
  if ((b << 1) == 0) b = 0;  // -0 and +0 compare equal: one key
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The budgets of the chain: in lane registers (REG, M <= 32) or in shared
// memory.
template <bool REG>
struct Budgets {
  float g_reg, e_reg;  // lane m's gamma[m], eta[m] (REG)
  float* g_s;          // gamma, eta in shared memory (!REG)
  float* e_s;
  int lane;

  __device__ void load(const float* gamma, const float* eta, int M, float* smem) {
    if (REG) {
      g_reg = lane < M ? gamma[lane] : 0.f;
      e_reg = lane < M ? eta[lane] : 0.f;
    } else {
      g_s = smem;
      e_s = smem + M;
      for (int m = lane; m < M; m += 32) {
        g_s[m] = gamma[m];
        e_s[m] = eta[m];
      }
      __syncwarp();
    }
  }
  // every lane calls these with its own j (gamma) or the class's s (eta)
  __device__ __forceinline__ float gamma_of(int j) const {
    return REG ? __shfl_sync(FULL, g_reg, j) : g_s[j];
  }
  __device__ __forceinline__ float eta_of(int s) const {
    return REG ? __shfl_sync(FULL, e_reg, s) : e_s[s];
  }
  // whether server j's smallest costs fit its budgets for some j: a cell
  // can pass the budget test only where this holds at its server
  __device__ __forceinline__ bool any_fits(const float2* summ, int s, float eta_s, int M) const {
    bool ok = false;
    if (REG) {
      ok = lane < M && summ[lane].x <= g_reg && (lane == s || summ[lane].y <= eta_s);
    } else {
      for (int j = lane; j < M; j += 32)
        ok = ok || (summ[j].x <= g_s[j] && (j == s || summ[j].y <= eta_s));
    }
    return __any_sync(FULL, ok);
  }
  // uniform calls: the same j / s and value in every lane
  __device__ __forceinline__ void set_gamma(int j, float g) {
    if (REG) {
      if (lane == j) g_reg = g;
    } else {
      __syncwarp();  // every lane has read this step's gamma
      if (lane == 0) g_s[j] = g;
      __syncwarp();
    }
  }
  __device__ __forceinline__ void set_eta(int s, float e) {
    if (REG) {
      if (lane == s) e_reg = e;
    } else {
      __syncwarp();
      if (lane == 0) e_s[s] = e;
      __syncwarp();
    }
  }
};

template <bool REG>
__global__ void __launch_bounds__(THREADS, 1)
hier_cells_kernel(
    const float* __restrict__ us, const uint8_t* __restrict__ feas,
    const float* __restrict__ v, const float* __restrict__ u,
    const int32_t* __restrict__ cover, const int32_t* __restrict__ count,
    const float* __restrict__ gamma, const float* __restrict__ eta,
    int32_t* __restrict__ take, int32_t* __restrict__ start,
    float* __restrict__ out_w, float* __restrict__ out_c,
    int C, int M, int L, int tc, int with_loads) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ML = M * L;
  const Layout lay(tc, ML, M);
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_tiles = (C + tc - 1) / tc;
  const uint32_t bars = smem_u32(smem + lay.bars);
  auto full = [&](int s) { return bars + 8 * s; };                 // the tile has landed
  auto summed = [&](int s) { return bars + 8 * (STAGES + s); };    // its summaries are written
  auto empty = [&](int s) { return bars + 8 * (2 * STAGES + s); }; // the chain is done with it

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(summed(s), 32 * SUMMARY_WARPS);
      mbar_init(empty(s), 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the arrays of tile t in stage s: rows [r0, r0 + n) of the frame's
  // classes (n < tc only for a frame's last tile)
  const uint64_t row_b = (uint64_t)b * C;
  struct Tiles {
    Tile<float> us, v, u;
    Tile<uint8_t> feas;
    Tile<int32_t> cover, count;
    float2* summ;
    int n;
  };
  auto tile = [&](int t) {
    const int s = t % STAGES;
    const int n = min(tc, C - t * tc);
    const uint64_t r0 = row_b + (uint64_t)t * tc, r1 = r0 + n;
    uint8_t* st = smem + (size_t)s * lay.stage;
    uint8_t* p_feas = st + 3 * lay.f32_cells;
    uint8_t* p_cover = p_feas + lay.u8_cells;
    return Tiles{Tile<float>(us, st, r0 * ML, r1 * ML),
                 Tile<float>(v, st + lay.f32_cells, r0 * ML, r1 * ML),
                 Tile<float>(u, st + 2 * lay.f32_cells, r0 * ML, r1 * ML),
                 Tile<uint8_t>(feas, p_feas, r0 * ML, r1 * ML),
                 Tile<int32_t>(cover, p_cover, r0, r1),
                 Tile<int32_t>(count, p_cover + lay.i32_rows, r0, r1),
                 reinterpret_cast<float2*>(p_cover + 2 * lay.i32_rows), n};
  };

  if (warp == 1) {
    // ---- producer: one lane keeps the bulk copies in flight -------------------
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
        const Tiles tl = tile(t);
        const uint32_t bar = full(s);
        tl.us.stage_ends();
        tl.v.stage_ends();
        tl.u.stage_ends();
        tl.feas.stage_ends();
        tl.cover.stage_ends();
        tl.count.stage_ends();
        // arrive after the plain copies (release), expecting the bulk bytes
        mbar_expect_tx(bar, tl.us.bulk_bytes() + tl.v.bulk_bytes() + tl.u.bulk_bytes() +
                                tl.feas.bulk_bytes() + tl.cover.bulk_bytes() +
                                tl.count.bulk_bytes());
        tl.us.copy(bar);
        tl.v.copy(bar);
        tl.u.copy(bar);
        tl.feas.copy(bar);
        tl.cover.copy(bar);
        tl.count.copy(bar);
      }
    }
    return;
  }

  if (warp >= 2) {
    // ---- summary: per class and server, the smallest usable v and u ---------
    const int sw = warp - 2;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      mbar_wait(full(s), (t / STAGES) & 1);
      const Tiles tl = tile(t);
      const float* t_us = tl.us.at();
      const float* t_v = tl.v.at();
      const float* t_u = tl.u.at();
      const uint8_t* t_feas = tl.feas.at();
      const int32_t* t_count = tl.count.at();
      for (int k = sw; k < tl.n; k += SUMMARY_WARPS) {
        if (t_count[k] <= 0) continue;  // padding: the chain skips it
        for (int j = lane; j < M; j += 32) {
          float vm = INFINITY, um = INFINITY;
          const size_t c0 = (size_t)k * ML + (size_t)j * L;
          for (int l = 0; l < L; ++l) {
            if (t_feas[c0 + l] != 0 && t_us[c0 + l] > NEG) {
              vm = fminf(vm, t_v[c0 + l]);
              um = fminf(um, t_u[c0 + l]);
            }
          }
          tl.summ[(size_t)k * M + j] = make_float2(vm, um);
        }
      }
      mbar_arrive(summed(s));
    }
    return;
  }

  // ---- the chain (warp 0) ----------------------------------------------------------
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch);
  float* wl = scratch + 2 * M;  // committed compute (with loads)
  float* cl = wl + M;           // committed uplink
  int* cells = reinterpret_cast<int*>(cl + M);  // the class's cells: flat, take, v, u
  int* tks = cells + ML;
  float* cv = reinterpret_cast<float*>(tks + ML);
  float* cu = cv + ML;
  Budgets<REG> bud;
  bud.lane = lane;
  bud.load(gamma + (size_t)b * M, eta + (size_t)b * M, M, scratch);
  if (with_loads) {
    for (int m = lane; m < M; m += 32) wl[m] = cl[m] = 0.f;
    __syncwarp();
  }
  // (j, l) of the lane's cells lane, lane + 32, ..: stepped, not divided
  const int j_lane = lane / L, l_lane = lane % L, j_step = 32 / L, l_step = 32 % L;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(full(s), (t / STAGES) & 1);
    mbar_wait(summed(s), (t / STAGES) & 1);
    const Tiles tl = tile(t);
    const float* t_us = tl.us.at();
    const float* t_v = tl.v.at();
    const float* t_u = tl.u.at();
    const uint8_t* t_feas = tl.feas.at();
    const int32_t* t_cover = tl.cover.at();
    const int32_t* t_count = tl.count.at();
    for (int k = 0; k < tl.n; ++k) {
      const int cnt = t_count[k];
      if (cnt <= 0) continue;  // padding
      const int cls = t_cover[k];
      float eta_s = bud.eta_of(cls);
      if (!bud.any_fits(tl.summ + (size_t)k * M, cls, eta_s, M)) continue;
      const size_t c0 = (size_t)k * ML;
      const size_t base = (row_b + (size_t)t * tc + k) * (size_t)ML;
      int rem = cnt, used = 0;
      int cur = -1, cur_take = 0;  // the cell being filled and its take
      int n_cells = 0;             // with loads: cells listed so far (lane 0)
      while (true) {
        unsigned best = 0, best_f = 0xffffffffu;
        int j = j_lane, l = l_lane;
        for (int f = lane; f - lane < ML; f += 32) {
          const bool in = f < ML;
          const size_t e = c0 + (in ? f : 0);
          const float sc = t_us[e], vv = t_v[e], uu = t_u[e];
          const bool fe = t_feas[e] != 0;
          const float g = bud.gamma_of(in ? j : 0);
          const bool ok = in && fe && sc > NEG && vv <= g && (j == cls || uu <= eta_s);
          const unsigned key = ok ? score_key(sc) : 0u;
          if (key > best) {
            best = key;
            best_f = (unsigned)f;
          }
          j += j_step;
          l += l_step;
          if (l >= L) {
            l -= L;
            ++j;
          }
        }
        const unsigned top = __reduce_max_sync(FULL, best);
        if (top == 0) break;  // nothing usable: the class ends
        const int flat = (int)__reduce_min_sync(FULL, best == top ? best_f : 0xffffffffu);
        const float vv = t_v[c0 + flat], uv = t_u[c0 + flat];
        const int jw = flat / L;
        const bool offl = jw != cls;
        const float g_j = bud.gamma_of(jw);
        const float rem_f = (float)rem;
        const float cap_g = vv > 0.0f ? floorf(__fdiv_rn(g_j, vv)) : rem_f;
        const float cap_e = (offl && uv > 0.0f) ? floorf(__fdiv_rn(eta_s, uv)) : rem_f;
        const int tk = (int)fminf(rem_f, fminf(cap_g, cap_e));
        if (tk < 1) break;  // float edge: the cell passed the test but fits none
        const float tf = (float)tk;
        bud.set_gamma(jw, __fadd_rn(g_j, -__fmul_rn(tf, vv)));
        if (offl) eta_s = __fadd_rn(eta_s, -__fmul_rn(tf, uv));
        if (flat == cur) {
          cur_take += tk;  // a re-pick: always the cell being filled
        } else {
          if (lane == 0) {
            if (cur >= 0) take[base + cur] = cur_take;
            start[base + flat] = used;
            if (with_loads) {
              if (n_cells > 0) tks[n_cells - 1] = cur_take;
              cells[n_cells] = flat;
              cv[n_cells] = vv;
              cu[n_cells] = uv;
              ++n_cells;
            }
          }
          cur = flat;
          cur_take = tk;
        }
        used += tk;
        rem -= tk;
        if (rem <= 0) break;
      }
      bud.set_eta(cls, eta_s);
      if (cur >= 0 && lane == 0) {
        take[base + cur] = cur_take;
        if (with_loads) {
          tks[n_cells - 1] = cur_take;
          for (int i = 1; i < n_cells; ++i) {  // insertion sort by flat index
            const int f = cells[i], tt = tks[i];
            const float a = cv[i], c = cu[i];
            int q = i - 1;
            while (q >= 0 && cells[q] > f) {
              cells[q + 1] = cells[q];
              tks[q + 1] = tks[q];
              cv[q + 1] = cv[q];
              cu[q + 1] = cu[q];
              --q;
            }
            cells[q + 1] = f;
            tks[q + 1] = tt;
            cv[q + 1] = a;
            cu[q + 1] = c;
          }
          float sc = 0.0f;
          for (int i = 0; i < n_cells; ++i) {
            const float tf = (float)tks[i];
            const int jj = cells[i] / L;
            wl[jj] = __fadd_rn(wl[jj], __fmul_rn(tf, cv[i]));
            sc = __fadd_rn(sc, __fmul_rn(tf, cu[i]));
          }
          cl[cls] = __fadd_rn(cl[cls], sc);
        }
      }
      if (with_loads) __syncwarp();
    }
    __syncwarp();
    mbar_arrive(empty(s));
  }

  if (with_loads) {
    __syncwarp();
    for (int m = lane; m < M; m += 32) {
      out_w[(size_t)b * M + m] = wl[m];
      out_c[(size_t)b * M + m] = cl[m];
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched), or
// ERR_TOO_WIDE when one class row does not fit shared memory.  The caller
// has checked shapes, dtypes and contiguity, zeroed the outputs and made
// sure B > 0 and C > 0.
int hier_cells_launch(
    const void* us, const void* feas, const void* v, const void* u,
    const void* cover, const void* count, const void* gamma, const void* eta,
    void* take, void* start, void* out_w, void* out_c,
    int B, int C, int M, int L, int with_loads, void* stream) {
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int ML = M * L;
  int tc = MAX_TILE;
  while (tc > 1 && Layout(tc, ML, M).total > (size_t)max_smem) --tc;
  const size_t smem = Layout(tc, ML, M).total;
  if (smem > (size_t)max_smem) return ERR_TOO_WIDE;
  const bool reg = M <= 32;
  const void* kernel =
      reg ? (const void*)hier_cells_kernel<true> : (const void*)hier_cells_kernel<false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (reg)
    hier_cells_kernel<true><<<B, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)us, (const uint8_t*)feas, (const float*)v, (const float*)u,
        (const int32_t*)cover, (const int32_t*)count, (const float*)gamma, (const float*)eta,
        (int32_t*)take, (int32_t*)start, (float*)out_w, (float*)out_c, C, M, L, tc, with_loads);
  else
    hier_cells_kernel<false><<<B, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)us, (const uint8_t*)feas, (const float*)v, (const float*)u,
        (const int32_t*)cover, (const int32_t*)count, (const float*)gamma, (const float*)eta,
        (int32_t*)take, (int32_t*)start, (float*)out_w, (float*)out_c, C, M, L, tc, with_loads);
  return (int)cudaGetLastError();
}

const char* hier_error_string(int err) {
  if (err == ERR_TOO_WIDE) return "one class row (M * L cells) does not fit shared memory";
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
