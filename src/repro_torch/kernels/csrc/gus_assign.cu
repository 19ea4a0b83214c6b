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
// What bounds it on the card.  Every candidate byte is read exactly once:
// per frame N*M*L*17 B (acc, ctime, v, u as f32 plus avail as u8) + N*20 B
// of request rows + M*8 B of budgets, at 3.35 TB/s.  That bound is far from
// what sets the pace today: each frame is a dependent chain of N argmax
// steps, and each step's budget update must land before the next step's
// feasibility test, so a frame's latency is N times (row load + warp
// reduction).  The design keeps that chain short and hides it with
// parallelism across frames:
//   * one warp per frame, FRAMES_PER_BLOCK frames per block,
//     grid = ceil(B / FRAMES_PER_BLOCK);
//   * a step's M*L candidates are read coalesced (lane f, f+32, ...), each
//     lane keeps its best (score, flat) pair, and a butterfly shuffle picks
//     the winner — no shared-memory round trip and no __syncthreads;
//   * gamma/eta (and the load accumulators) live in shared memory, written
//     only by lane 0 and fenced with __syncwarp;
//   * the (N, M, L) slab is not staged: at fleet shapes it is ~435 KB per
//     frame, above shared memory, and each byte is read once anyway.
// Overlapping the next row's loads with the current reduction, or staging
// rows with cp.async/TMA, is later work.
//
// Bit-parity hazards, each handled explicitly:
//   * FMA contraction: us = w_a*acc_term + w_c*time_term must be two rounded
//     products and one rounded add.  The utility uses __fmul_rn/__fadd_rn/
//     __fsub_rn, which the compiler never contracts, and the library is
//     built with --fmad=false as well.  Never --use_fast_math.
//   * Division: (acc - A)/max_as and (C - ctime)/max_cs are IEEE divisions
//     (__fdiv_rn), as in the reference.
//   * Sentinel: masked candidates score NEG = -1e30; a request is served iff
//     the best score is > NEG.
//   * Tie-breaking: among equal scores the lowest flat index j*L + l wins
//     (the reference's first-occurrence argmax).  Each lane scans its flats
//     in increasing order and replaces only on a strictly greater score; the
//     shuffle prefers the lower flat on equal scores.  Ties happen on
//     padding rows and on quantized QoS.
//   * Relaxed budgets: Happy-* passes gamma/eta = +inf; v <= inf holds and
//     inf + (-v) stays inf.
//   * Budget commit: gamma[j] + (-v) and eta[s] + (-u), rounded adds, as the
//     reference's .at[].add of the negated cost.
//   * Committed loads: the congested fleet's backlog update needs
//     w[j] = sum of served v and c[s] = sum of offloaded u.  An atomicAdd
//     sums in no fixed order, and a 1-ulp change in the backlog can flip a
//     later greedy decision, so lane 0 accumulates them here in request
//     order, the order of the reference's sequential scatter-add.
//   * N = 0: the wrapper returns empty outputs without a launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FRAMES_PER_BLOCK = 4;
constexpr float NEG = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

__global__ void __launch_bounds__(FRAMES_PER_BLOCK * 32)
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
    int B, int N, int M, int L) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * FRAMES_PER_BLOCK + warp;
  if (b >= B) return;  // whole warp leaves; the block never synchronises

  float* gam = smem + (size_t)warp * 4 * M;  // remaining compute budget
  float* et = gam + M;                       // remaining uplink budget
  float* wl = et + M;                        // committed compute, request order
  float* cl = wl + M;                        // committed uplink, request order
  for (int m = lane; m < M; m += 32) {
    gam[m] = gamma[(size_t)b * M + m];
    et[m] = eta[(size_t)b * M + m];
    wl[m] = 0.0f;
    cl[m] = 0.0f;
  }
  __syncwarp();

  const int ML = M * L;
  const float mas = max_as[b];
  const float mcs = max_cs[b];
  for (int i = 0; i < N; ++i) {
    const size_t row = (size_t)b * N + i;
    const int s = cover[row];
    const float Ai = A[row];
    const float Ci = C[row];
    const float wa = w_a[row];
    const float wc = w_c[row];
    const float eta_s = et[s];
    const size_t base = row * ML;

    float best = -INFINITY;
    int best_f = 0x7fffffff;
    for (int f = lane; f < ML; f += 32) {
      const int j = f / L;
      const float a = acc[base + f];
      const float ct = ctime[base + f];
      const float vv = v[base + f];
      const float uu = u[base + f];
      const bool placed = avail[base + f] != 0;
      const float acc_term = __fdiv_rn(__fsub_rn(a, Ai), mas);
      const float time_term = __fdiv_rn(__fsub_rn(Ci, ct), mcs);
      const float us = __fadd_rn(__fmul_rn(wa, acc_term), __fmul_rn(wc, time_term));
      const bool ok = placed && (a >= Ai) && (ct <= Ci) && (vv <= gam[j]) &&
                      (j == s || uu <= eta_s);
      const float score = ok ? us : NEG;
      if (score > best) {
        best = score;
        best_f = f;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(FULL_MASK, best, off);
      const int of = __shfl_xor_sync(FULL_MASK, best_f, off);
      if (ob > best || (ob == best && of < best_f)) {
        best = ob;
        best_f = of;
      }
    }

    if (lane == 0) {
      int oj = -1, ol = -1;
      if (best > NEG) {
        oj = best_f / L;
        ol = best_f - oj * L;
        const float vv = v[base + best_f];
        gam[oj] = __fadd_rn(gam[oj], -vv);
        wl[oj] = __fadd_rn(wl[oj], vv);
        if (oj != s) {
          const float uu = u[base + best_f];
          et[s] = __fadd_rn(et[s], -uu);
          cl[s] = __fadd_rn(cl[s], uu);
        }
      }
      out_j[row] = oj;
      out_l[row] = ol;
    }
    __syncwarp();  // lane 0's budget commit is visible to the next step
  }

  for (int m = lane; m < M; m += 32) {
    out_w[(size_t)b * M + m] = wl[m];
    out_c[(size_t)b * M + m] = cl[m];
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).  The
// caller has checked shapes, dtypes, contiguity and that N > 0.
int gus_assign_launch(
    const void* cover, const void* A, const void* C, const void* w_a,
    const void* w_c, const void* acc, const void* ctime, const void* v,
    const void* u, const void* avail, const void* gamma, const void* eta,
    const void* max_as, const void* max_cs, void* out_j, void* out_l,
    void* out_w, void* out_c, int B, int N, int M, int L, void* stream) {
  const size_t smem = (size_t)FRAMES_PER_BLOCK * 4 * M * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gus_assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + FRAMES_PER_BLOCK - 1) / FRAMES_PER_BLOCK;
  gus_assign_kernel<<<grid, FRAMES_PER_BLOCK * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)cover, (const float*)A, (const float*)C, (const float*)w_a,
      (const float*)w_c, (const float*)acc, (const float*)ctime, (const float*)v,
      (const float*)u, (const uint8_t*)avail, (const float*)gamma,
      (const float*)eta, (const float*)max_as, (const float*)max_cs,
      (int32_t*)out_j, (int32_t*)out_l, (float*)out_w, (float*)out_c, B, N, M, L);
  return (int)cudaGetLastError();
}

const char* gus_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
