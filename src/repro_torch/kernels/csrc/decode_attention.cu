// One-token grouped-query attention over a KV cache with a validity mask,
// as split-K flash-decoding, hand-written for Hopper (sm_90a).
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
// Design.  The cache axis T is cut into n_split spans of `span` positions
// (a multiple of the 64-position tile; the wrapper picks n_split so that
// the grid (KV, n_split, B) fills two waves of the card's SMs).  Block
// (g, split, b) serves all rep query heads of group g from each K/V tile
// it reads, so the cache streams through the card once per step:
//   * K and V tiles stream as the cache's own type (bf16 or f32) through a
//     ring of 2 shared-memory stages filled by cp.async (16-byte copies,
//     zero fill past the span), so a tile's loads overlap the math on the
//     tile before it; values turn into f32 in registers;
//   * scores: 4 threads share each of the tile's 64 positions, each over
//     every 4th 16-byte chunk of hd, and compute the partial dot products of
//     all rep heads from one conversion of the K chunk; the softmax adds
//     the 4 partial sums in a fixed order;
//   * softmax: warp w updates heads w + 8 i (shuffle max and sum) and
//     writes p position-major;
//   * P.V: a thread serves up to 8 heads x 4 columns of the (rep, hd)
//     output from one conversion of the V chunk, over every n_par-th
//     position of the tile (n_par threads share a slot when the output has
//     few slots, e.g. rep 1); the f32 accumulators stay in registers for
//     the whole span, and the n_par partial sums are added in a fixed
//     order at the end;
//   * with one span the block writes out = acc / l.  With more, it writes
//     its f32 partials (m, l, acc) to scratch; the last block of the group
//     to finish (found by a counter that it resets to 0) combines the
//     spans in span order, so the result does not change from run to run
//     (no float atomics): M = max m_s, L = sum l_s e^(m_s - M), out =
//     sum acc_s e^(m_s - M) / L.  A span with no valid position holds
//     m = -1e30, l = 0, acc = 0 and drops out exactly (its weight is
//     e^(-1e30 - M) = 0); a head with no valid position anywhere gets zeros.
//   One launch per call: decode is host-bound, so no second kernel.
//
// What bounds it on this card.  At yi-9b's decode launch (B 8, KV 4,
// rep 8, hd 128, T 1056, bf16) the step must read 17.3 MB of K and V once:
// 0.0052 ms at 3.35 TB/s; its 0.14 GFLOP are nothing.  The 32 groups are
// cut into 9 spans of 128 positions: 288 blocks for 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 64;          // cache positions per tile
constexpr int THREADS = 256;
constexpr int MAX_CHUNKS = 4;   // float4 output chunks per thread: rep * hd <= 4096
constexpr int HSPLIT = THREADS / TB;  // threads sharing a position's dot products
constexpr float NEG = -1e30f;

// heads a P.V thread serves from one V chunk: 1, 4 or 8, the fewest that
// hold rep (up to 8), so a group of one head keeps few registers
__host__ __device__ __forceinline__ int heads_per_slot(int rep) {
  return rep <= 1 ? 1 : rep <= 4 ? 4 : 8;
}
__host__ __device__ __forceinline__ size_t kv_bytes(int stages, size_t elt, int rep, int hd);

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

// four consecutive elements of shared memory as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy cache rows t0 .. t0 + TB - 1 (positions >= t_end as zeros: garbage
// there would poison acc through 0 * NaN) into a stage of row pitch
// `pitch` elements, `nch` chunks of 16 bytes per row.  With `vec`, every
// chunk is one cp.async; otherwise plain element copies, zero past hd.
template <typename T>
__device__ __forceinline__ void issue_tile(T* dst, int pitch, const T* src, long long stride,
                                           int t0, int t_end, int hd, int nch, bool vec) {
  constexpr int V = 16 / sizeof(T);
  for (int e = threadIdx.x; e < TB * nch; e += THREADS) {
    const int r = e / nch, c = e - r * nch;
    const bool in = t0 + r < t_end;
    T* d = dst + r * pitch + c * V;
    const T* s = src + (in ? (long long)(t0 + r) * stride + c * V : 0);
    if (vec) {
      cp_async16(d, s, in ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) d[j] = in && c * V + j < hd ? s[j] : from_f<T>(0.f);
    }
  }
}

// the threads of the P.V phase per output slot (a power of two, at most a
// tile): slots of up to heads_per_slot heads x 4 columns, n_par threads per slot
__host__ __device__ __forceinline__ int pv_slots(int rep, int hd) {
  const int hg = heads_per_slot(rep);
  return (rep + hg - 1) / hg * (hd / 4);
}
__host__ __device__ __forceinline__ int pv_par(int rep, int hd) {
  const int slots = pv_slots(rep, hd);
  int n_par = 1;
  while (2 * n_par * slots <= THREADS && 2 * n_par <= TB) n_par *= 2;
  return n_par;
}

// at least two blocks per SM (128 registers a thread, which every instantiation
// fits unspilled), four for one head per slot (64 registers: the rep-1 kernel
// streams more of the cache at once)
template <typename T, int STAGES, int HG>
__global__ void __launch_bounds__(THREADS, HG == 1 ? 4 : 2)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const uint8_t* __restrict__ valid,
                        T* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ counters, int rep, int Tk, int hd, int span,
                        long long qsb, long long qsg, long long qsr,
                        long long ksb, long long ksg, long long kst,
                        long long vsb, long long vsg, long long vst,
                        long long msb, long long mst,
                        long long osb, long long osg, long long osr,
                        float scale, int vec) {
  constexpr int V = 16 / sizeof(T);
  const int nch = (hd + V - 1) / V;  // 16-byte chunks of a row
  const int hdq = nch * V;           // hd rounded up to whole chunks
  const int pitch = hdq + V;         // K/V row pitch: 16-byte reads free of bank conflicts
  const int rp = (rep + HG - 1) / HG * HG;  // heads of a P row, whole head groups
  const int slots = pv_slots(rep, hd), n_par = pv_par(rep, hd);
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // (rep, hdq) f32
  // STAGES x {K, V} tiles (TB, pitch); after the walk, the P.V partial sums
  T* KVs = reinterpret_cast<T*>(Qs + rep * hdq);
  float* Ss = reinterpret_cast<float*>(reinterpret_cast<char*>(KVs) +
                                       kv_bytes(STAGES, sizeof(T), rep, hd));
  float* Ps = Ss + HSPLIT * rep * TB;  // (TB, rp): p, position-major
  float* Ms = Ps + TB * rp;            // running max per head
  float* Ls = Ms + rep;                // running denominator per head
  float* As = Ls + rep;                // this tile's rescale per head
  int* Vld = reinterpret_cast<int*>(As + rep);  // (TB,) validity of the tile
  __shared__ int last_block;

  // the group is the grid's fastest axis: blocks that run together read the
  // same positions of neighbouring heads, which lie side by side in the cache
  const int g = blockIdx.x, split = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int chunks = hd / 4;
  const int n_out = rep * chunks;
  const int t_begin = split * span;
  const int t_end = min(Tk, t_begin + span);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + TB - 1) / TB : 0;

  const T* kb = k + b * ksb + g * ksg;
  const T* vb = v + b * vsb + g * vsg;
  const uint8_t* mb = valid + b * msb;
  auto k_stage = [&](int s) { return KVs + (2 * s) * TB * pitch; };
  auto v_stage = [&](int s) { return KVs + (2 * s + 1) * TB * pitch; };

  // the ring's first STAGES - 1 tiles, one cp.async group each
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) {
      issue_tile(k_stage(s), pitch, kb, kst, t_begin + s * TB, t_end, hd, nch, vec);
      issue_tile(v_stage(s), pitch, vb, vst, t_begin + s * TB, t_end, hd, nch, vec);
    }
    cp_async_commit();
  }

  const T* qb = q + b * qsb + g * qsg;
  for (int e = tid; e < rep * hdq; e += THREADS) {
    const int r = e / hdq, d = e - r * hdq;
    Qs[e] = d < hd ? to_f(qb[r * qsr + d]) : 0.f;
  }
  for (int e = tid; e < TB * rp; e += THREADS) Ps[e] = 0.f;  // heads past rep stay 0
  for (int r = tid; r < rep; r += THREADS) {
    Ms[r] = NEG;
    Ls[r] = 0.f;
  }

  // score phase: this thread's position and its chunks hpart + HSPLIT c,
  // for every head
  const int col = tid % TB, hpart = tid / TB;
  // P.V phase: this thread's slot (HG heads from head hg0, columns d0..d0+3)
  // and its first position of each tile
  const bool pv = tid < slots * n_par;
  const int slot = tid % slots, c_first = tid / slots;
  const int hg0 = slot / chunks * HG, d0 = 4 * (slot % chunks);
  float4 acc[HG];
#pragma unroll
  for (int j = 0; j < HG; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  // the validity of the next tile's positions, loaded a tile ahead
  int vnext = tid < TB && t_begin + tid < t_end ? mb[(long long)(t_begin + tid) * mst] != 0 : 0;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int t0 = t_begin + i * TB;
    {
      const int ahead = i + STAGES - 1;  // into the stage tile i - 1 used
      if (ahead < n_tiles) {
        issue_tile(k_stage(ahead % STAGES), pitch, kb, kst, t_begin + ahead * TB, t_end, hd, nch,
                   vec);
        issue_tile(v_stage(ahead % STAGES), pitch, vb, vst, t_begin + ahead * TB, t_end, hd, nch,
                   vec);
      }
      cp_async_commit();
    }
    cp_async_wait<STAGES - 1>();  // this thread's copies of tile i have landed
    if (tid < TB) {
      Vld[tid] = vnext;
      const int tn = t0 + TB + tid;
      vnext = tn < t_end ? mb[(long long)tn * mst] != 0 : 0;
    }
    __syncthreads();  // every thread's copies of tile i, and its validity, are visible
    const T* Ks = k_stage(s);
    const T* Vs = v_stage(s);

    // partial scores over this thread's chunks, HG heads at a time: the K
    // chunk is converted once for all of them
    for (int h0 = 0; h0 < rep; h0 += HG) {
      float sc[HG];
#pragma unroll
      for (int j = 0; j < HG; ++j) sc[j] = 0.f;
      for (int c = hpart; c < nch; c += HSPLIT) {
        float kf[V];
        if constexpr (V == 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(Ks + col * pitch + c * V);
          const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(h2[e]);
            kf[2 * e] = f.x;
            kf[2 * e + 1] = f.y;
          }
        } else {
          const float4 f = *reinterpret_cast<const float4*>(Ks + col * pitch + c * V);
          kf[0] = f.x;
          kf[1] = f.y;
          kf[2] = f.z;
          kf[3] = f.w;
        }
#pragma unroll
        for (int j = 0; j < HG; ++j) {
          if (h0 + j < rep) {
            const float* qr = Qs + (h0 + j) * hdq + c * V;
#pragma unroll
            for (int e = 0; e < V; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              sc[j] = fmaf(qv.x, kf[e], sc[j]);
              sc[j] = fmaf(qv.y, kf[e + 1], sc[j]);
              sc[j] = fmaf(qv.z, kf[e + 2], sc[j]);
              sc[j] = fmaf(qv.w, kf[e + 3], sc[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < HG; ++j)
        if (h0 + j < rep) Ss[(hpart * rep + h0 + j) * TB + col] = sc[j];
    }
    __syncthreads();

    // softmax: warp w takes heads w + 8 i, adding the partial scores in order
    for (int r = warp; r < rep; r += THREADS / 32) {
      float s0 = Ss[r * TB + lane], s1 = Ss[r * TB + lane + 32];
#pragma unroll
      for (int h = 1; h < HSPLIT; ++h) {
        s0 += Ss[(h * rep + r) * TB + lane];
        s1 += Ss[(h * rep + r) * TB + lane + 32];
      }
      const bool ok0 = Vld[lane] != 0, ok1 = Vld[lane + 32] != 0;
      s0 = ok0 ? s0 * scale : NEG;
      s1 = ok1 ? s1 * scale : NEG;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = Ms[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      Ps[lane * rp + r] = p0;
      Ps[(lane + 32) * rp + r] = p1;
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

    // P.V: the V chunk is converted once for the slot's HG heads
    if (pv) {
      const int tvalid = min(TB, t_end - t0);
#pragma unroll
      for (int j = 0; j < HG; ++j) {
        const float alpha = hg0 + j < rep ? As[hg0 + j] : 1.f;
        acc[j].x *= alpha;
        acc[j].y *= alpha;
        acc[j].z *= alpha;
        acc[j].w *= alpha;
      }
      for (int c = c_first; c < tvalid; c += n_par) {
        const float4 vv = load4(Vs + c * pitch + d0);
        float pj[HG];
#pragma unroll
        for (int j = 0; j < HG; j += 4 > HG ? 1 : 4) {
          if constexpr (HG >= 4) {
            const float4 pa = *reinterpret_cast<const float4*>(Ps + c * rp + hg0 + j);
            pj[j] = pa.x;
            pj[j + 1] = pa.y;
            pj[j + 2] = pa.z;
            pj[j + 3] = pa.w;
          } else {
            pj[j] = Ps[c * rp + hg0 + j];
          }
        }
#pragma unroll
        for (int j = 0; j < HG; ++j) {
          acc[j].x = fmaf(pj[j], vv.x, acc[j].x);
          acc[j].y = fmaf(pj[j], vv.y, acc[j].y);
          acc[j].z = fmaf(pj[j], vv.z, acc[j].z);
          acc[j].w = fmaf(pj[j], vv.w, acc[j].w);
        }
      }
    }
    __syncthreads();  // tile i's stage, scores, p and validity are no longer read
  }
  cp_async_wait<0>();
  __syncthreads();  // Ms, Ls of a block with no tile; the K/V stages are free

  if (n_par > 1) {
    // the n_par partial sums of each slot, added in order of their first position
    float4* red = reinterpret_cast<float4*>(KVs);
    if (pv) {
#pragma unroll
      for (int j = 0; j < HG; ++j) red[(c_first * slots + slot) * HG + j] = acc[j];
    }
    __syncthreads();
    if (tid < slots) {
      for (int c = 1; c < n_par; ++c) {
#pragma unroll
        for (int j = 0; j < HG; ++j) {
          const float4 x = red[(c * slots + slot) * HG + j];
          acc[j].x += x.x;
          acc[j].y += x.y;
          acc[j].z += x.z;
          acc[j].w += x.w;
        }
      }
    }
  }

  const long long group = (long long)b * gridDim.x + g;
  if (n_split == 1) {
    if (tid < slots) {
#pragma unroll
      for (int j = 0; j < HG; ++j) {
        const int r = hg0 + j;
        if (r < rep) {
          const float l = Ls[r];
          const float inv = l > 0.f ? 1.f / l : 0.f;
          T* o = out + b * osb + g * osg + r * osr + d0;
          o[0] = from_f<T>(acc[j].x * inv);
          o[1] = from_f<T>(acc[j].y * inv);
          o[2] = from_f<T>(acc[j].z * inv);
          o[3] = from_f<T>(acc[j].w * inv);
        }
      }
    }
    return;
  }

  // partials of this span: acc (groups, n_split, rep, hd), then m and l
  // (groups, n_split, 2, rep)
  float* part_ml = part + (long long)gridDim.z * gridDim.x * n_split * rep * hd;
  float* my_acc = part + (group * n_split + split) * rep * hd;
  float* my_ml = part_ml + (group * n_split + split) * 2 * rep;
  for (int r = tid; r < rep; r += THREADS) {
    my_ml[r] = Ms[r];
    my_ml[rep + r] = Ls[r];
  }
  if (tid < slots) {
#pragma unroll
    for (int j = 0; j < HG; ++j)
      if (hg0 + j < rep) *reinterpret_cast<float4*>(my_acc + (hg0 + j) * hd + d0) = acc[j];
  }
  __threadfence();  // the partials are visible device-wide before the count
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(counters + group, 1);
    last_block = done == n_split - 1;
    if (last_block) counters[group] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // the last block of the group combines the spans in span order
  const float* accs = part + group * n_split * rep * hd;
  const float* mls = part_ml + group * n_split * 2 * rep;
#pragma unroll
  for (int a = 0; a < MAX_CHUNKS; ++a) {
    const int idx = tid + THREADS * a;
    if (idx < n_out) {
      const int r = idx / chunks, d = 4 * (idx - r * chunks);
      float M = NEG;
      for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, __ldcg(mls + sp * 2 * rep + r));
      float L = 0.f;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int sp = 0; sp < n_split; ++sp) {
        const float w = expf(__ldcg(mls + sp * 2 * rep + r) - M);
        L += __ldcg(mls + sp * 2 * rep + rep + r) * w;
        const float4 x =
            __ldcg(reinterpret_cast<const float4*>(accs + (sp * rep + r) * hd + d));
        o.x += x.x * w;
        o.y += x.y * w;
        o.z += x.z * w;
        o.w += x.w * w;
      }
      const float inv = L > 0.f ? 1.f / L : 0.f;
      T* dst = out + b * osb + g * osg + r * osr + d;
      dst[0] = from_f<T>(o.x * inv);
      dst[1] = from_f<T>(o.y * inv);
      dst[2] = from_f<T>(o.z * inv);
      dst[3] = from_f<T>(o.w * inv);
    }
  }
}

// shared memory of a block: Q, then the K/V ring (or, after the walk, the
// P.V partial sums, whichever is larger), partial scores, p, statistics
__host__ __device__ __forceinline__ size_t kv_bytes(int stages, size_t elt, int rep, int hd) {
  const int V = 16 / (int)elt;
  const int hdq = (hd + V - 1) / V * V;
  const size_t ring = elt * (size_t)stages * 2 * TB * (hdq + V);
  const size_t red =
      sizeof(float4) * (size_t)pv_par(rep, hd) * pv_slots(rep, hd) * heads_per_slot(rep);
  return ring > red ? ring : red;
}

size_t smem_bytes(int stages, size_t elt, int rep, int hd) {
  const int V = 16 / (int)elt;
  const int hdq = (hd + V - 1) / V * V;
  const int hg = heads_per_slot(rep);
  const int rp = (rep + hg - 1) / hg * hg;
  return sizeof(float) * (size_t)rep * hdq + kv_bytes(stages, elt, rep, hd) +
         sizeof(float) * ((size_t)HSPLIT * rep * TB + (size_t)TB * rp + 3 * rep) +
         sizeof(int) * TB;
}

template <typename T, int STAGES, int HG>
int launch_stages(const void* q, const void* k, const void* v, const void* valid, void* out,
                  void* part, void* counters, int B, int KV, int rep, int Tk, int hd, int span,
                  int n_split, const long long* st, float scale, int vec, size_t smem,
                  cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, STAGES, HG>;
  static size_t smem_set = 0;  // the opt-in already granted to this instantiation
  if (smem > smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid(KV, n_split, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int*>(counters), rep, Tk, hd, span, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13], scale, vec);
  return (int)cudaGetLastError();
}

template <typename T, int STAGES>
int launch_heads(const void* q, const void* k, const void* v, const void* valid, void* out,
                 void* part, void* counters, int B, int KV, int rep, int Tk, int hd, int span,
                 int n_split, const long long* st, float scale, int vec, size_t smem,
                 cudaStream_t stream) {
  switch (heads_per_slot(rep)) {
    case 1:
      return launch_stages<T, STAGES, 1>(q, k, v, valid, out, part, counters, B, KV, rep, Tk,
                                         hd, span, n_split, st, scale, vec, smem, stream);
    case 4:
      return launch_stages<T, STAGES, 4>(q, k, v, valid, out, part, counters, B, KV, rep, Tk,
                                         hd, span, n_split, st, scale, vec, smem, stream);
  }
  return launch_stages<T, STAGES, 8>(q, k, v, valid, out, part, counters, B, KV, rep, Tk, hd,
                                     span, n_split, st, scale, vec, smem, stream);
}

// a ring of 2 stages, or 1 where 2 do not fit the card's shared memory
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, void* part,
           void* counters, int B, int KV, int rep, int Tk, int hd, int span, int n_split,
           const long long* st, float scale, int vec, cudaStream_t stream) {
  static int limit = 0;  // the card's opt-in shared memory per block, less the static part
  if (limit == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaError_t err =
        cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    limit -= 16;
  }
  const size_t s2 = smem_bytes(2, sizeof(T), rep, hd);
  if (s2 <= (size_t)limit)
    return launch_heads<T, 2>(q, k, v, valid, out, part, counters, B, KV, rep, Tk, hd, span,
                              n_split, st, scale, vec, s2, stream);
  return launch_heads<T, 1>(q, k, v, valid, out, part, counters, B, KV, rep, Tk, hd, span,
                            n_split, st, scale, vec, smem_bytes(1, sizeof(T), rep, hd), stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 14 element strides, in order
// q (b, g, r), k (b, g, t), v (b, g, t), valid (b, t), out (b, g, r); the
// last axis of q, k, v and out has unit stride.  The wrapper guarantees
// hd % 4 == 0, hd <= 256, rep <= 32, rep * hd <= 4096, vec only when every
// row start is 16-byte aligned and hd a whole number of 16-byte chunks,
// n_split spans of `span` positions (a multiple of 64) covering T, and,
// when n_split > 1, f32 scratch `part` of B * KV * n_split * rep * (hd + 2)
// elements and B * KV int32 `counters` that are 0 (the kernel leaves them
// 0 again).  Returns a cudaError_t (0 =
// launched).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* valid, void* out, void* part,
                                       void* counters, int dtype, int B, int KV, int rep, int T,
                                       int hd, int span, int n_split,
                                       const long long* strides, float scale, int vec,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, valid, out, part, counters, B, KV, rep, T, hd, span, n_split,
                         strides, scale, vec, s);
  return launch<__nv_bfloat16>(q, k, v, valid, out, part, counters, B, KV, rep, T, hd, span,
                               n_split, strides, scale, vec, s);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
