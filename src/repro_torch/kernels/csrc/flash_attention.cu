// Blocked online-softmax attention for prefill (causal and/or sliding
// window, grouped-query), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (pallas_call at flash_attention.py:118, body _kernel at :35).  It computes
// what that kernel computes: for each (batch b, query head h) the f32 scores
// q.k * (1/sqrt(hd)) (scaled after the dot), -1e30 where masked (ragged tail,
// causal bound col <= row, window bound col > row - window), a running max m,
// denominator l and accumulator acc in f32 with p forced to 0 where masked,
// and out = acc / l, or zeros for a row whose l stays 0.  Query head h reads
// KV head h / (H / KV) directly: K and V are never repeated.
//
// Layouts (kernel layout, any strides, unit stride on the last axis):
// q (B, H, S, hd), k/v (B, KV, T, hd), out (B, H, S, hd) in q's type; f32
// or bf16 in, f32 statistics.  The model passes transposed views of its
// (B, S, H, hd) activations, so nothing is copied to change the layout.
//
// Design (simple and right first):
//   * one block of 128 threads per (b, h, tile of BQ = 64 query rows); the
//     key axis is a loop inside the block over tiles of BK = 32 rows, which
//     takes the place of the Pallas grid's sequential key axis;
//   * the Q tile and each K/V tile are staged in shared memory as f32
//     (16-byte loads when the strides allow); thread (ty, tx) owns query
//     rows ty + 16 i (i < 4) and, for the scores, key columns tx + 8 j
//     (j < 4); the 8 lanes of a row reduce its max and sum by shuffles;
//   * p goes through shared memory to the P.V product, where the thread
//     owns columns 4 tx + 32 jj (+0..3) of its 4 rows; m, l, acc stay in
//     registers for the whole key loop;
//   * key tiles wholly above the causal diagonal or wholly before the
//     window are skipped.  That is exact: in the Pallas arithmetic a fully
//     masked tile leaves m, l and acc unchanged (p = 0, alpha = exp(0) = 1).
//
// What bounds it on this card.  At the serving path's prefill shape (B 8,
// H 32, KV 4, S 1024, hd 128, bf16, causal) the work is 68.7 GFLOP of
// causal dot products, 0.069 ms at the bf16 tensor-core rate, against
// 151 MB of q, k, v and out (0.045 ms at 3.35 TB/s): operations bound it.
// This kernel does its products in f32 on the CUDA cores (67 TFLOP/s peak,
// and less here: each 4-wide product step reads its operands from shared
// memory), so it is far from that bound.  Left on the table: wgmma on bf16
// tiles fed by TMA, a ring of K/V stages so loads overlap the math,
// warp-specialised producers, and a persistent schedule that balances the
// causal triangle across SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 32;        // key rows per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column lanes
constexpr int ROWS = 4;       // query rows per thread (ty + 16 i)
constexpr int COLS = 4;       // score columns per thread (tx + 8 j)
constexpr int PP = BK + 4;    // pitch of the P tile (float4 reads along keys)
constexpr float NEG = -1e30f;

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

// Stage `rows` rows of `hd` elements into shared memory as f32 with row
// pitch `pitch`: row r is read from src + r * stride; rows >= valid are
// zero (the ragged tail: garbage there would poison acc through 0 * NaN).
// With 16-byte loads, each thread first issues up to BATCH loads and only
// then converts and stores them, so a tile costs one round trip to memory
// per BATCH loads instead of one per load.
template <typename T>
__device__ void stage(float* dst, int pitch, const T* src, long long stride,
                      int rows, int valid, int hd, bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int BATCH = 8;
  if (vec) {
    const int chunks = hd / V;
    const int total = rows * chunks;
    for (int base = threadIdx.x; base < total; base += BATCH * blockDim.x) {
      uint4 raw[BATCH];
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int e = base + i * blockDim.x;
        const int r = e / chunks, c = (e - r * chunks) * V;
        raw[i] = e < total && r < valid
                     ? *reinterpret_cast<const uint4*>(src + r * stride + c)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < BATCH; ++i) {
        const int e = base + i * blockDim.x;
        if (e < total) {
          const int r = e / chunks, c = (e - r * chunks) * V;
          const T* x = reinterpret_cast<const T*>(&raw[i]);
          float* d = dst + r * pitch + c;
#pragma unroll
          for (int j = 0; j < V; ++j) d[j] = to_f(x[j]);
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
      const int r = e / hd, c = e - r * hd;
      dst[r * pitch + c] = r < valid ? to_f(src[r * stride + c]) : 0.f;
    }
  }
}

// NJ: 32-column groups of the head dimension (hd <= 32 * NJ)
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int H, int KV, int S, int Tk, int hd,
                       long long qsb, long long qsh, long long qss,
                       long long ksb, long long ksh, long long kst,
                       long long vsb, long long vsh, long long vst,
                       long long osb, long long osh, long long oss,
                       int causal, int has_window, int window, float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int QP = hd + 4;  // pitch of Q and K tiles (float4 reads, no bank conflict)
  float* Qs = smem;
  float* Ks = Qs + BQ * QP;
  float* Vs = Ks + BK * QP;
  float* Ps = Vs + BK * hd;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + kvh * ksh;
  const T* vb = v + b * vsb + kvh * vsh;

  stage(Qs, QP, qb + q0 * qss, qss, BQ, min(BQ, S - q0), hd, vec);

  float m[ROWS], l[ROWS], acc[ROWS][NJ * 4];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ * 4; ++c) acc[i][c] = 0.f;
  }

  // key tiles that can hold an unmasked entry for some row of this block
  int k_end = Tk;
  if (causal) k_end = min(k_end, min(q0 + BQ, S));
  int k_begin = 0;
  if (has_window) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    const int kvalid = min(BK, Tk - k0);
    stage(Ks, QP, kb + k0 * kst, kst, BK, kvalid, hd, vec);
    stage(Vs, hd, vb + k0 * vst, vst, BK, kvalid, hd, vec);
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      float4 qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * QP + d);
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * j) * QP + d);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z +
                     qv[i].w * kv[j].w;
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[COLS];
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = k0 + tx + 8 * j;
        ok[j] = row < S && col < Tk && (!causal || col <= row) &&
                (!has_window || col > row - window);
        s[i][j] = ok[j] ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * PP + tx + 8 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NJ * 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int c = 0; c < BK; c += 4) {
      float4 pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int d = 4 * tx + 32 * jj;
          if (d < hd) {
            const float4 vv = *reinterpret_cast<const float4*>(Vs + (c + cc) * hd + d);
#pragma unroll
            for (int i = 0; i < ROWS; ++i) {
              const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
              acc[i][4 * jj + 0] += p * vv.x;
              acc[i][4 * jj + 1] += p * vv.y;
              acc[i][4 * jj + 2] += p * vv.z;
              acc[i][4 * jj + 3] += p * vv.w;
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float safe = l[i] > 0.f ? l[i] : 1.f;
    T* o = out + b * osb + h * osh + row * oss;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int d = 4 * tx + 32 * jj;
      if (d < hd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[d + e] = from_f<T>(acc[i][4 * jj + e] / safe);
      }
    }
  }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
           int S, int Tk, int hd, const long long* st, int causal, int has_window,
           int window, float scale, int vec, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, NJ>;
  const size_t smem = sizeof(float) * (size_t)(BQ * (hd + 4) + BK * (hd + 4) + BK * hd + BQ * PP);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, KV, S, Tk, hd, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], causal, has_window, window, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
             int S, int Tk, int hd, const long long* st, int causal, int has_window,
             int window, float scale, int vec, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 1>(q, k, v, out, B, H, KV, S, Tk, hd, st, causal, has_window, window, scale, vec, stream);
  if (hd <= 64)
    return launch<T, 2>(q, k, v, out, B, H, KV, S, Tk, hd, st, causal, has_window, window, scale, vec, stream);
  if (hd <= 128)
    return launch<T, 4>(q, k, v, out, B, H, KV, S, Tk, hd, st, causal, has_window, window, scale, vec, stream);
  return launch<T, 8>(q, k, v, out, B, H, KV, S, Tk, hd, st, causal, has_window, window, scale, vec, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, in order
// q (b, h, s), k (b, kv, t), v (b, kv, t), out (b, h, s); the last axis of
// every tensor has unit stride.  The wrapper guarantees hd % 4 == 0,
// hd <= 256, H % KV == 0, and vec only when every row start is 16-byte
// aligned.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int dtype, int B, int H, int KV, int S, int T, int hd,
                                      const long long* strides, int causal, int has_window,
                                      int window, float scale, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, B, H, KV, S, T, hd, strides, causal, has_window, window, scale, vec, s);
  return dispatch<__nv_bfloat16>(q, k, v, out, B, H, KV, S, T, hd, strides, causal, has_window, window, scale, vec, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
