// Mamba-2 chunked SSD scan (state-space duality), hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (pallas_call
// at ssd_scan.py:84, body _kernel at :27) for f32 inputs and for the shapes
// that the tensor-core route (ssd_scan_wgmma.cu: bf16 at P 64, N 64/128,
// chunk 128) does not take; ssd_scan.py::ssd_route picks the route.  It
// computes what that kernel computes, chunk by chunk of Q tokens, with an
// (N x P) f32 state carried across chunks:
//   cs      = cumsum(dt * A)                               (f32, per chunk)
//   W[i][j] = (C_i . B_j) * exp(cs_i - cs_j) * dt_j        for j <= i, else 0
//   y_i     = sum_j W[i][j] x_j  +  exp(cs_i) * (C_i . state)
//   state   = exp(cs_Q) * state  +  sum_j B_j (exp(cs_Q - cs_j) dt_j) x_j^T
// Inputs are read in their type (f32 or bf16) and all arithmetic is f32; y
// is written in x's type.  Beyond the Pallas kernel it
//   * reads SSM group g = h / (H / G) of B and C by index: the groups are
//     never repeated over heads;
//   * handles a ragged last chunk itself: positions past S are staged as
//     dt = x = B = C = 0, which is the reference's right-padding rule
//     (ssd_reference) and leaves y at real positions and the state exact;
//   * starts from a given initial state h0 (B, H, N, P) f32 (the
//     reference's initial_state; apply_mamba's ssm_state), or from a zero
//     state where h0 is null, and optionally writes out the final state
//     (B, H, N, P) in f32, so that prefill runs on the kernel too.
//
// Layouts (kernel layout, any strides, unit stride on the last axis of x,
// B, C and y): x (B, H, S, P), dt (B, H, S) (any strides), A (H,) f32,
// Bm/Cm (B, G, S, N), y (B, H, S, P); the initial and the final state
// (B, H, N, P) f32 contiguous.
// The model passes transposed views of its (B, S, H, P) / (B, S, G, N)
// activations, so nothing is copied to change the layout.
//
// Design (simple and right first):
//   * one block of 256 threads per (b, h); the chunk axis is a loop inside
//     the block, which takes the place of the Pallas grid's sequential axis,
//     and the state lives in shared memory for the whole sequence;
//   * each chunk stages x (Q x P), B and C (Q x N, pitch N + 4 so that the
//     float4 reads along N are free of bank conflicts) and dt as f32; warp 0
//     computes the cumulative sum and the decay vectors;
//   * the Q x Q weights W are built in row tiles of 32 rows (32 x Q in
//     shared memory instead of Q x Q): thread (ty, tx) owns rows 4 ty + r
//     (r < 4) and columns tx + 32 k; only columns left of the tile's
//     diagonal block are computed (the causal mask makes the rest 0); the
//     same thread then owns rows 4 ty + r and columns tx + 32 k of y;
//   * the state update gives each thread rows ty + 8 i of the state and
//     columns tx + 32 k, updated in place after every y row of the chunk has
//     read the old state.
// Shared memory at Q = 128, N = 128, P = 64: 219 KB (one block per SM); at
// N = 64: 137 KB.
//
// What bounds it on this card.  At zamba2-1.2b's prefill launch (B 8,
// H 64, S 2048, P 64, N 64, G 1, bf16) the function reads ~140 MB and
// writes ~142 MB (0.085 ms at 3.35 TB/s) and needs ~34 GFLOP for the
// causal products (0.035 ms at the bf16 tensor-core rate): bytes bound it.
// This kernel does its products in f32 on the CUDA cores with operands in
// shared memory, one block per SM, so it is far from that bound; bf16 at
// the serving models' shapes takes the tensor-core route instead.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int RT = 32;        // rows of one W tile (8 warps x 4 rows)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// acc[r][k] = C_{irow[r]} . B_{tx + 32 k} for k < KN (the tile's columns up
// to its diagonal block); rows and columns past Q are clamped to Q - 1 and
// masked by the caller.
template <int KN>
__device__ __forceinline__ void w_dots(const float* Cs, const float* Bs, int NP, int N, int Q,
                                       const int (&irow)[4], int tx, float (&acc)[4][4]) {
  int jcol[KN];
#pragma unroll
  for (int k = 0; k < KN; ++k) jcol[k] = min(tx + 32 * k, Q - 1);
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[rr][k] = 0.f;
  for (int n = 0; n < N; n += 4) {
    float4 cv[4], bv[KN];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) cv[rr] = *reinterpret_cast<const float4*>(Cs + irow[rr] * NP + n);
#pragma unroll
    for (int k = 0; k < KN; ++k) bv[k] = *reinterpret_cast<const float4*>(Bs + jcol[k] * NP + n);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int k = 0; k < KN; ++k) acc[rr][k] += dot4(cv[rr], bv[k]);
  }
}

// NPJ: 32-column groups of the head dimension (P <= 32 * NPJ).  The shared
// memory allows one block per SM at the main paths' shapes; the launch
// bound says so, which lets ptxas give each thread more registers (it
// otherwise settles for fewer, and the kernel runs slower).
template <typename T, int NPJ>
__global__ void __launch_bounds__(THREADS, 1)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt, const float* __restrict__ A,
                const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ final_state, const float* __restrict__ h0,
                int H, int G, int S, int P, int N, int Q,
                long long xsb, long long xsh, long long xss,
                long long dsb, long long dsh, long long dss,
                long long bsb, long long bsg, long long bss,
                long long csb, long long csg, long long css,
                long long ysb, long long ysh, long long yss) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int NP = N + 4;          // pitch of B and C rows
  float* Xs = smem;              // Q x P
  float* Bs = Xs + Q * P;        // Q x NP
  float* Cs = Bs + Q * NP;       // Q x NP
  float* St = Cs + Q * NP;       // N x P, the carried state
  float* Ws = St + N * P;        // RT x Q, one row tile of W
  float* dts = Ws + RT * Q;      // Q: dt
  float* cs = dts + Q;           // Q: cumsum(dt * A)
  float* ecs = cs + Q;           // Q: exp(cs)
  float* wdt = ecs + Q;          // Q: exp(cs_Q - cs) * dt
  float* tot = wdt + Q;          // exp(cs_Q)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int ty = tid >> 5, tx = tid & 31;
  const float a = A[h];

  const T* xb = x + b * xsb + h * xsh;
  const T* db = dt + b * dsb + h * dsh;
  const T* bb = Bm + b * bsb + g * bsg;
  const T* cb = Cm + b * csb + g * csg;
  T* yb = y + b * ysb + h * ysh;
  const long long sbase = ((long long)b * H + h) * N * P;

  for (int e = tid; e < N * P; e += THREADS) St[e] = h0 != nullptr ? h0[sbase + e] : 0.f;

  int pc[NPJ];
  bool pok[NPJ];
#pragma unroll
  for (int k = 0; k < NPJ; ++k) {
    pok[k] = tx + 32 * k < P;
    pc[k] = pok[k] ? tx + 32 * k : 0;
  }

  const int nc = (S + Q - 1) / Q;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * Q;
    const int valid = min(Q, S - c0);
    __syncthreads();  // the previous chunk's state update no longer reads Xs, Bs

    // ---- stage the chunk (rows past S are zeros: the ragged tail) ----------
    for (int e = tid; e < Q * P; e += THREADS) {
      const int r = e / P, col = e - r * P;
      Xs[e] = r < valid ? to_f(xb[(c0 + r) * xss + col]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += THREADS) {
      const int r = e / N, col = e - r * N;
      Bs[r * NP + col] = r < valid ? to_f(bb[(c0 + r) * bss + col]) : 0.f;
      Cs[r * NP + col] = r < valid ? to_f(cb[(c0 + r) * css + col]) : 0.f;
    }
    for (int r = tid; r < Q; r += THREADS) dts[r] = r < valid ? to_f(db[(c0 + r) * dss]) : 0.f;
    __syncthreads();

    // ---- warp 0: cs = cumsum(dt * A) and the decay vectors ------------------
    if (ty == 0) {
      const int per = (Q + 31) / 32;  // <= 4 positions per lane
      float loc[4];
      float run = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = tx * per + u;
        run += (u < per && idx < Q) ? dts[idx] * a : 0.f;
        loc[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(FULL, incl, o);
        if (tx >= o) incl += t;
      }
      const float excl = incl - run;
      const float total = __shfl_sync(FULL, incl, 31);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int idx = tx * per + u;
        if (u < per && idx < Q) {
          const float v = excl + loc[u];
          cs[idx] = v;
          ecs[idx] = expf(v);
          wdt[idx] = expf(total - v) * dts[idx];
        }
      }
      if (tx == 0) tot[0] = expf(total);
    }
    __syncthreads();

    // ---- y, one tile of 32 rows at a time ----------------------------------
    for (int r0 = 0; r0 < Q; r0 += RT) {
      const int jend = min(Q, r0 + RT);  // columns left of (or in) the diagonal block
      const int kn = (jend + 31) / 32;
      int irow[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) irow[rr] = min(r0 + 4 * ty + rr, Q - 1);

      {  // W rows of the tile: (C_i . B_j) exp(cs_i - cs_j) dt_j, 0 above the diagonal
        float acc[4][4];
        switch (kn) {
          case 1: w_dots<1>(Cs, Bs, NP, N, Q, irow, tx, acc); break;
          case 2: w_dots<2>(Cs, Bs, NP, N, Q, irow, tx, acc); break;
          case 3: w_dots<3>(Cs, Bs, NP, N, Q, irow, tx, acc); break;
          default: w_dots<4>(Cs, Bs, NP, N, Q, irow, tx, acc); break;
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i = r0 + 4 * ty + rr;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int j = tx + 32 * k;
            if (k < kn && j < jend)
              Ws[(4 * ty + rr) * Q + j] =
                  (i < Q && j <= i) ? acc[rr][k] * expf(cs[i] - cs[j]) * dts[j] : 0.f;
          }
        }
      }
      __syncthreads();

      {  // y_i = sum_j W[i][j] x_j + exp(cs_i) (C_i . state)
        float intra[4][NPJ], inter[4][NPJ];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr)
#pragma unroll
          for (int k = 0; k < NPJ; ++k) intra[rr][k] = inter[rr][k] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            cv[rr] = *reinterpret_cast<const float4*>(Cs + irow[rr] * NP + n);
#pragma unroll
          for (int k = 0; k < NPJ; ++k) {
            const float4 sv = make_float4(St[n * P + pc[k]], St[(n + 1) * P + pc[k]],
                                          St[(n + 2) * P + pc[k]], St[(n + 3) * P + pc[k]]);
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) inter[rr][k] += dot4(cv[rr], sv);
          }
        }
        for (int j = 0; j < jend; j += 4) {
          float4 wv[4];
#pragma unroll
          for (int rr = 0; rr < 4; ++rr)
            wv[rr] = *reinterpret_cast<const float4*>(Ws + (4 * ty + rr) * Q + j);
#pragma unroll
          for (int k = 0; k < NPJ; ++k) {
            const float4 xv = make_float4(Xs[j * P + pc[k]], Xs[(j + 1) * P + pc[k]],
                                          Xs[(j + 2) * P + pc[k]], Xs[(j + 3) * P + pc[k]]);
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) intra[rr][k] += dot4(wv[rr], xv);
          }
        }
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          const int i = r0 + 4 * ty + rr;
          if (i >= valid) continue;
          T* yrow = yb + (c0 + i) * yss;
#pragma unroll
          for (int k = 0; k < NPJ; ++k)
            if (pok[k]) yrow[pc[k]] = from_f<T>(intra[rr][k] + ecs[i] * inter[rr][k]);
        }
      }
      __syncthreads();  // the next tile rewrites Ws
    }

    // ---- state = exp(cs_Q) state + sum_j B_j (exp(cs_Q - cs_j) dt_j) x_j^T --
    {
      float acc[16][NPJ];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int k = 0; k < NPJ; ++k) acc[i][k] = 0.f;
      // rows past `valid` have dt = 0 and x = 0: they add exactly nothing
      for (int j = 0; j < valid; ++j) {
        const float w = wdt[j];
        float xv[NPJ];
#pragma unroll
        for (int k = 0; k < NPJ; ++k) xv[k] = Xs[j * P + pc[k]];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int n = ty + 8 * i;
          if (n < N) {
            const float bw = Bs[j * NP + n] * w;
#pragma unroll
            for (int k = 0; k < NPJ; ++k) acc[i][k] += bw * xv[k];
          }
        }
      }
      const float decay = tot[0];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int n = ty + 8 * i;
        if (n >= N) continue;
#pragma unroll
        for (int k = 0; k < NPJ; ++k)
          if (pok[k]) St[n * P + pc[k]] = decay * St[n * P + pc[k]] + acc[i][k];
      }
    }
  }

  if (final_state != nullptr) {
    __syncthreads();
    for (int e = tid; e < N * P; e += THREADS) final_state[sbase + e] = St[e];
  }
}

size_t smem_bytes(int P, int N, int Q) {
  return sizeof(float) *
         ((size_t)Q * P + 2 * (size_t)Q * (N + 4) + (size_t)N * P + (size_t)RT * Q + 4 * (size_t)Q + 4);
}

template <typename T, int NPJ>
int launch(const void* x, const void* dt, const float* A, const void* Bm, const void* Cm,
           void* y, float* final_state, const float* h0, int B, int H, int G, int S, int P,
           int N, int Q, const long long* st, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T, NPJ>;
  const size_t smem = smem_bytes(P, N, Q);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), final_state, h0, H, G, S, P, N, Q,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
      st[12], st[13], st[14]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* dt, const float* A, const void* Bm, const void* Cm,
             void* y, float* final_state, const float* h0, int B, int H, int G, int S, int P,
             int N, int Q, const long long* st, cudaStream_t stream) {
  if (P <= 32)
    return launch<T, 1>(x, dt, A, Bm, Cm, y, final_state, h0, B, H, G, S, P, N, Q, st, stream);
  return launch<T, 2>(x, dt, A, Bm, Cm, y, final_state, h0, B, H, G, S, P, N, Q, st, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, Bm, Cm and y share it).  strides:
// 15 element strides, in order x (b, h, s), dt (b, h, s), Bm (b, g, s),
// Cm (b, g, s), y (b, h, s).  final_state and the initial state h0 are
// (B, H, N, P) f32 contiguous, or null (h0 null: a zero initial state).  The wrapper guarantees H % G == 0, P <= 64,
// N <= 128 with N % 4 == 0, 4 <= Q <= 128 with Q % 4 == 0, and a unit
// stride on the last axis of x, Bm, Cm and y.  Returns a cudaError_t
// (0 = launched).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A, const void* Bm,
                               const void* Cm, void* y, void* final_state, const void* h0,
                               int dtype, int B,
                               int H, int G, int S, int P, int N, int Q,
                               const long long* strides, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* Af = static_cast<const float*>(A);
  float* fin = static_cast<float*>(final_state);
  const float* init = static_cast<const float*>(h0);
  if (dtype == 0)
    return dispatch<float>(x, dt, Af, Bm, Cm, y, fin, init, B, H, G, S, P, N, Q, strides, s);
  return dispatch<__nv_bfloat16>(x, dt, Af, Bm, Cm, y, fin, init, B, H, G, S, P, N, Q, strides,
                                 s);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
