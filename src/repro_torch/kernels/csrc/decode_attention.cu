// One-token grouped-query attention over a KV cache with a validity mask,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (pallas_call at decode_attention.py:91, body _kernel at :35).  It computes
// what that kernel computes: for each (batch b, KV group g) the rep query
// heads of the group against the group's cache rows, f32 scores
// q.k * (1/sqrt(hd)) (scaled after the dot), -1e30 where valid[b, t] is
// false, an online softmax in f32 with p forced to 0 at invalid positions,
// and out = acc / l, or zeros for a head whose l stays 0 (no valid
// position at all).
//
// Layouts (kernel layout, any strides, unit stride on the last axis):
// q (B, KV, rep, hd), k/v (B, KV, T, hd), valid (B, T) as bytes, out
// (B, KV, rep, hd) in q's type.  The model passes the layer's slice of its
// (L, B, W, KV, hd) ring-buffer cache as a transposed view, so no decode
// step copies the cache; valid may be broadcast over B (stride 0).
//
// Design (simple and right first), as the Pallas kernel's point is: one
// block of 256 threads per (b, g) serves all rep query heads of the group
// from each K/V tile it reads, so the cache streams through the card once
// per step and not rep times.  The block walks T in tiles of 64 positions:
//   * the K and V tiles are staged in shared memory as f32 (16-byte loads
//     when the strides allow), the group's queries once at the start;
//   * scores: thread t owns position t % 64 and heads t / 64 + 4 i, with
//     the 4-wide dot product read from shared memory;
//   * softmax: warp w updates heads w + 8 i (each lane two positions,
//     shuffle max and sum), writing p back and the rescale alpha beside it;
//   * P.V: thread t owns 4-wide column chunks of the (rep, hd) output;
//     the accumulators stay in registers for the whole walk.
//
// What bounds it on this card.  At the serving path's decode shape (B 8,
// KV 4, rep 8, hd 128, T 1056, bf16) the step must read 17.3 MB of K and V
// once: 0.0052 ms at 3.35 TB/s; its 0.14 GFLOP are nothing.  Left on the
// table: the grid has only B * KV = 32 blocks for 132 SMs, so at most a
// quarter of the card streams the cache (split-K over T with a second
// combine pass, "flash-decoding", is the fix, later); each tile's loads are
// batched but wait for the previous tile's math (no cp.async/TMA ring to
// overlap them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 64;          // cache positions per tile
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / TB;  // head groups of the score phase
constexpr int MAX_REP = 32;     // query heads per KV group
constexpr int MAX_CHUNKS = 4;   // float4 output chunks per thread: rep * hd <= 4096
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
// zero (positions past T: garbage there would poison acc through 0 * NaN).
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

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ valid,
                        T* __restrict__ out, int rep, int Tk, int hd,
                        long long qsb, long long qsg, long long qsr,
                        long long ksb, long long ksg, long long kst,
                        long long vsb, long long vsg, long long vst,
                        long long msb, long long mst,
                        long long osb, long long osg, long long osr,
                        float scale, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int KP = hd + 4;  // pitch of the K tile (float4 reads, no bank conflict)
  float* Qs = smem;                // (rep, hd)
  float* Ks = Qs + rep * hd;       // (TB, KP)
  float* Vs = Ks + TB * KP;        // (TB, hd)
  float* Ss = Vs + TB * hd;        // (rep, TB): scores, then p
  float* Ms = Ss + rep * TB;       // running max per head
  float* Ls = Ms + rep;            // running denominator per head
  float* As = Ls + rep;            // this tile's rescale per head
  int* Vld = reinterpret_cast<int*>(As + rep);  // (TB,) validity of the tile

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int chunks = hd / 4;
  const int n_out = rep * chunks;

  const T* kb = k + b * ksb + g * ksg;
  const T* vb = v + b * vsb + g * vsg;
  const uint8_t* mb = valid + b * msb;

  stage(Qs, hd, q + b * qsb + g * qsg, qsr, rep, rep, hd, vec);
  for (int r = tid; r < rep; r += THREADS) {
    Ms[r] = NEG;
    Ls[r] = 0.f;
  }
  float4 acc[MAX_CHUNKS];
#pragma unroll
  for (int a = 0; a < MAX_CHUNKS; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int col = tid % TB;   // score phase: the position this thread owns
  const int rh = tid / TB;    // and its first head (heads rh + GROUPS i)

  for (int t0 = 0; t0 < Tk; t0 += TB) {
    __syncthreads();  // the previous tile's K, V and p are no longer read
    const int tvalid = min(TB, Tk - t0);
    stage(Ks, KP, kb + t0 * kst, kst, TB, tvalid, hd, vec);
    stage(Vs, hd, vb + t0 * vst, vst, TB, tvalid, hd, vec);
    for (int c = tid; c < TB; c += THREADS)
      Vld[c] = (c < tvalid) && mb[(t0 + c) * mst] != 0;
    __syncthreads();

    float s[MAX_REP / GROUPS];
#pragma unroll
    for (int i = 0; i < MAX_REP / GROUPS; ++i) s[i] = 0.f;
    for (int d = 0; d < hd; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(Ks + col * KP + d);
#pragma unroll
      for (int i = 0; i < MAX_REP / GROUPS; ++i) {
        const int r = rh + GROUPS * i;
        if (r < rep) {
          const float4 qv = *reinterpret_cast<const float4*>(Qs + r * hd + d);
          s[i] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
        }
      }
    }
    const bool ok = Vld[col] != 0;
#pragma unroll
    for (int i = 0; i < MAX_REP / GROUPS; ++i) {
      const int r = rh + GROUPS * i;
      if (r < rep) Ss[r * TB + col] = ok ? s[i] * scale : NEG;
    }
    __syncthreads();

    for (int r = warp; r < rep; r += THREADS / 32) {
      float* row = Ss + r * TB;
      const float s0 = row[lane], s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = Vld[lane] ? expf(s0 - m_new) : 0.f;
      const float p1 = Vld[lane + 32] ? expf(s1 - m_new) : 0.f;
      row[lane] = p0;
      row[lane + 32] = p1;
      float rs = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        Ls[r] = Ls[r] * alpha + rs;
        Ms[r] = m_new;
        As[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < MAX_CHUNKS; ++a) {
      const int idx = tid + THREADS * a;
      if (idx < n_out) {
        const int r = idx / chunks, d = 4 * (idx - r * chunks);
        const float alpha = As[r];
        float4 o = acc[a];
        o.x *= alpha;
        o.y *= alpha;
        o.z *= alpha;
        o.w *= alpha;
        const float* prow = Ss + r * TB;
        for (int c = 0; c < tvalid; ++c) {
          const float p = prow[c];
          const float4 vv = *reinterpret_cast<const float4*>(Vs + c * hd + d);
          o.x += p * vv.x;
          o.y += p * vv.y;
          o.z += p * vv.z;
          o.w += p * vv.w;
        }
        acc[a] = o;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int a = 0; a < MAX_CHUNKS; ++a) {
    const int idx = tid + THREADS * a;
    if (idx < n_out) {
      const int r = idx / chunks, d = 4 * (idx - r * chunks);
      const float l = Ls[r];
      const float safe = l > 0.f ? l : 1.f;
      T* o = out + b * osb + g * osg + r * osr + d;
      o[0] = from_f<T>(acc[a].x / safe);
      o[1] = from_f<T>(acc[a].y / safe);
      o[2] = from_f<T>(acc[a].z / safe);
      o[3] = from_f<T>(acc[a].w / safe);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           int B, int KV, int rep, int Tk, int hd, const long long* st, float scale, int vec,
           cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T>;
  const size_t smem = sizeof(float) * (size_t)(rep * hd + TB * (hd + 4) + TB * hd +
                                               rep * TB + 3 * rep + TB);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KV, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), rep, Tk, hd, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12],
      st[13], scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 14 element strides, in order
// q (b, g, r), k (b, g, t), v (b, g, t), valid (b, t), out (b, g, r); the
// last axis of q, k, v and out has unit stride.  The wrapper guarantees
// hd % 4 == 0, hd <= 256, rep <= 32, rep * hd <= 4096, and vec only when
// every row start is 16-byte aligned.  Returns a cudaError_t (0 = launched).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* valid, void* out, int dtype, int B, int KV,
                                       int rep, int T, int hd, const long long* strides,
                                       float scale, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, valid, out, B, KV, rep, T, hd, strides, scale, vec, s);
  return launch<__nv_bfloat16>(q, k, v, valid, out, B, KV, rep, T, hd, strides, scale, vec, s);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
