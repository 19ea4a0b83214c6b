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
// and the outputs written once, C*M*L*8 B (take, start) — a byte bound of
// milliseconds at the fleet's city-scale shapes.  That bound is far from
// what sets the pace: each frame is one dependent chain of C classes, each
// of one or more chunk steps, and each step's budget commit must land
// before the next step's feasibility test.  A frame's latency is (number of
// chunk steps) x (cell loads + warp reduction + commit), and a launch holds
// only as many frames as the fleet's replications x window frames.  The
// design keeps each step short:
//   * one warp per frame, FRAMES_PER_BLOCK frames per block;
//   * a step's M*L cells are read coalesced (lane f, f+32, ...), each lane
//     keeps its best (score, flat) with the cell's costs, a butterfly
//     shuffle picks the winner, and the winner's costs come from its lane
//     by one shuffle — no shared-memory round trip, no __syncthreads;
//   * gamma/eta live in shared memory, written only by lane 0 and fenced
//     with __syncwarp;
//   * take/start are not read back: a cell, once left, is never picked
//     again in that class (budgets only shrink and its score is fixed), so
//     lane 0 keeps the class's cells and running takes in shared memory and
//     writes each take once when the class ends.  The outputs arrive zeroed.
// Prefetching the next class's row during the current reduction, skipping
// all-infeasible classes early and a compact output are later work.
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
//   * argmax: sentinel NEG = -1e30; a cell is usable iff the best score is
//     > NEG; among equal scores the lowest flat j*L + l wins (lane scan in
//     increasing order replacing only on a strictly greater score; the
//     shuffle prefers the lower flat on equal scores).
//   * a class with count <= 0 (padding) or no usable cell never touches the
//     budgets; a chunk of t < 1 ends the class.
//   * committed loads (congestion on): w[j] adds f32(take) * v over classes
//     in order and, within a class, over l; c_load[cover[c]] adds each
//     class's sum of f32(take) * u over its cells in row-major (j, l)
//     order, in class order.  Lane 0 sorts the class's few cells by flat
//     index and adds them — the order of the plain PyTorch version, on any
//     device.  Atomics would add in no fixed order.
//   * 64-bit offsets: B*C*M*L reaches ~1.6e8 at city-scale windows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FRAMES_PER_BLOCK = 4;
constexpr float NEG = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__global__ void __launch_bounds__(FRAMES_PER_BLOCK * 32)
hier_cells_kernel(
    const float* __restrict__ us, const uint8_t* __restrict__ feas,
    const float* __restrict__ v, const float* __restrict__ u,
    const int32_t* __restrict__ cover, const int32_t* __restrict__ count,
    const float* __restrict__ gamma, const float* __restrict__ eta,
    int32_t* __restrict__ take, int32_t* __restrict__ start,
    float* __restrict__ out_w, float* __restrict__ out_c,
    int B, int C, int M, int L, int with_loads) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * FRAMES_PER_BLOCK + warp;
  if (b >= B) return;  // whole warp leaves; the block never synchronises

  const int ML = M * L;
  float* gam = smem + (size_t)warp * (4 * M + 2 * ML);  // remaining compute
  float* et = gam + M;                                  // remaining uplink
  float* wl = et + M;                                   // committed compute
  float* cl = wl + M;                                   // committed uplink
  int* cells = reinterpret_cast<int*>(cl + M);          // class's cells, pick order
  int* tks = cells + ML;                                // their running take
  for (int m = lane; m < M; m += 32) {
    gam[m] = gamma[(size_t)b * M + m];
    et[m] = eta[(size_t)b * M + m];
    wl[m] = 0.0f;
    cl[m] = 0.0f;
  }
  __syncwarp();

  for (int c = 0; c < C; ++c) {
    const size_t row = (size_t)b * C + c;
    const int cnt = count[row];
    if (cnt <= 0) continue;  // padding row (uniform across the warp)
    const int s = cover[row];
    const size_t base = row * (size_t)ML;
    int rem = cnt;
    int used = 0;
    int n_cells = 0;  // meaningful in lane 0 only
    while (true) {
      const float eta_s = et[s];
      float best = -INFINITY;
      int best_f = 0x7fffffff;
      float best_v = 0.0f, best_u = 0.0f;
      for (int f = lane; f < ML; f += 32) {
        const int j = f / L;
        const float vv = v[base + f];
        const float uu = u[base + f];
        const bool ok = feas[base + f] != 0 && vv <= gam[j] && (j == s || uu <= eta_s);
        const float score = ok ? us[base + f] : NEG;
        if (score > best) {
          best = score;
          best_f = f;
          best_v = vv;
          best_u = uu;
        }
      }
      const float my_v = best_v, my_u = best_u;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(FULL_MASK, best, off);
        const int of = __shfl_xor_sync(FULL_MASK, best_f, off);
        if (ob > best || (ob == best && of < best_f)) {
          best = ob;
          best_f = of;
        }
      }
      if (!(best > NEG)) break;  // nothing usable: the class ends
      // the winner is lane (best_f % 32)'s own best cell
      const float vv = __shfl_sync(FULL_MASK, my_v, best_f & 31);
      const float uv = __shfl_sync(FULL_MASK, my_u, best_f & 31);
      const int j = best_f / L;
      const bool offl = j != s;
      const float rem_f = (float)rem;
      const float g_j = gam[j];
      const float cap_g = vv > 0.0f ? floorf(__fdiv_rn(g_j, vv)) : rem_f;
      const float cap_e = (offl && uv > 0.0f) ? floorf(__fdiv_rn(eta_s, uv)) : rem_f;
      const float t_f = fminf(rem_f, fminf(cap_g, cap_e));
      const int t = (int)t_f;
      if (t < 1) break;  // float edge: the cell passed the test but fits none
      __syncwarp();      // every lane has read this step's budgets
      if (lane == 0) {
        const float tf = (float)t;
        gam[j] = __fadd_rn(g_j, -__fmul_rn(tf, vv));
        if (offl) et[s] = __fadd_rn(eta_s, -__fmul_rn(tf, uv));
        if (n_cells > 0 && cells[n_cells - 1] == best_f) {
          tks[n_cells - 1] += t;  // a re-pick: always the previous cell
        } else if (n_cells < ML) {
          cells[n_cells] = best_f;
          tks[n_cells] = t;
          start[base + best_f] = used;
          ++n_cells;
        }
      }
      used += t;
      rem -= t;
      __syncwarp();  // lane 0's commit is visible to the next step
      if (rem <= 0) break;
    }

    if (lane == 0 && n_cells > 0) {
      for (int i = 0; i < n_cells; ++i) take[base + cells[i]] = tks[i];
      if (with_loads) {
        for (int i = 1; i < n_cells; ++i) {  // insertion sort by flat index
          const int f = cells[i], t = tks[i];
          int k = i - 1;
          while (k >= 0 && cells[k] > f) {
            cells[k + 1] = cells[k];
            tks[k + 1] = tks[k];
            --k;
          }
          cells[k + 1] = f;
          tks[k + 1] = t;
        }
        float sc = 0.0f;
        for (int i = 0; i < n_cells; ++i) {
          const int f = cells[i];
          const float tf = (float)tks[i];
          const int j = f / L;
          wl[j] = __fadd_rn(wl[j], __fmul_rn(tf, v[base + f]));
          sc = __fadd_rn(sc, __fmul_rn(tf, u[base + f]));
        }
        cl[s] = __fadd_rn(cl[s], sc);
      }
    }
    __syncwarp();
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

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller has checked shapes, dtypes and contiguity, zeroed the outputs and
// made sure B > 0 and C > 0.
int hier_cells_launch(
    const void* us, const void* feas, const void* v, const void* u,
    const void* cover, const void* count, const void* gamma, const void* eta,
    void* take, void* start, void* out_w, void* out_c,
    int B, int C, int M, int L, int with_loads, void* stream) {
  const size_t smem = (size_t)FRAMES_PER_BLOCK * (4 * M + 2 * M * L) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hier_cells_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + FRAMES_PER_BLOCK - 1) / FRAMES_PER_BLOCK;
  hier_cells_kernel<<<grid, FRAMES_PER_BLOCK * 32, smem, (cudaStream_t)stream>>>(
      (const float*)us, (const uint8_t*)feas, (const float*)v, (const float*)u,
      (const int32_t*)cover, (const int32_t*)count, (const float*)gamma,
      (const float*)eta, (int32_t*)take, (int32_t*)start, (float*)out_w,
      (float*)out_c, B, C, M, L, with_loads);
  return (int)cudaGetLastError();
}

const char* hier_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
