// Mamba-2's depthwise causal conv with its bias and SiLU, in one pass over
// xBC, hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this conv with jnp
// (repro/models/ssm.py::_causal_conv) and has no Pallas kernel for it.  It
// exists because the port's eager form of the same expression (a zero pad,
// a cat, W tap products over strided slices, Python's sum, the bias add and
// F.silu) makes about 12 passes over a (B, S, Ch) tensor in every Mamba-2
// layer: 39% of mamba2-130m's serving prefill on the card, the largest
// share of either benchmark cell.
//
// What it computes, rounded where the eager expression rounds:
//   xp    = [prefix; x]   (prefix: the conv state (B, W-1, Ch), or zeros)
//   c_s   = r(...r(r(0 + r(xp[s] w_0)) + r(xp[s+1] w_1))... + r(xp[s+W-1] w_{W-1}))
//   out_s = r(silu(r(c_s + bias)))   silu(y) = y / (1 + expf(-y)) in f32,
//                                    as PyTorch's CUDA SiLU computes it
//   state = the last W-1 rows of xp
// r() rounds to the activation type (bf16 or f32), to nearest even, as
// PyTorch rounds its f32 result of each bf16 product and sum.  The kernel
// computes each product and sum in the type's own arithmetic, rounded once
// (bf16 two lanes an instruction), which gives the same bits: a bf16
// product is exact in f32, and a bf16 sum that f32 rounds lies within
// 2^-16 of an operand, far from a bf16 midpoint.  The library is built with
// --fmad=false and the products and sums are explicit, so nothing
// contracts: before the SiLU the result is the eager expression's bit for
// bit, and after it within one step of the type (the expf of two builds
// may differ in its last bit).
//
// Layouts: x (B, S, Ch) and the prefix (B, W-1, Ch) read through their
// strides (unit stride on the channels): the model passes the in_proj
// output's slice, and nothing is copied.  w (W, Ch) and bias (Ch)
// contiguous; out (B, S, Ch) and state (B, W-1, Ch) contiguous, in x's type.
//
// What bounds it on this card: bytes.  Each input row is read once and each
// output row written once, 2 Ch elements a token (7 168 B at mamba2-130m's
// Ch 1 792 in bf16: 0.274 ms at 3.35 TB/s for a batch of 32 x 4 000
// tokens), against ~3 W flops an element.
//
// Design.  Each thread owns one 16-byte vector of channels (8 bf16 or 4 f32)
// and walks a tile of TILE consecutive positions, keeping the last W-1 input
// rows in registers, so each row is read once, plus a W-1-row halo per tile
// (3/64 at W 4).  It loads UNROLL rows before it computes any of them, so
// each SM keeps tens of KB of loads in flight; the weights and the bias stay
// in registers, in the activation type.  Per bf16 channel pair a position
// costs W mul.bf16x2 and W + 1 add.bf16x2 and the SiLU's two f32 expf and
// divisions, so the instruction rate stays under the memory time.
// A block spans the channels (224 threads cover 1 792 bf16),
// and the grid is (channel blocks, tiles, B): 2 016 blocks at B 32, S 4 000.
// The block of the last tile writes the new state from its window.  The
// window in registers is built for W 4 (a template argument), the width of
// every published Mamba-2 configuration; any other W takes a kernel that
// reads each output's W rows anew (through L1).  A Ch that is not a
// multiple of the vector, or a base or row stride that is not 16-byte
// aligned, takes the same kernels one element a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;         // positions a thread walks
constexpr int UNROLL = 4;        // rows loaded before they are computed
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float silu_f(float y) { return y / (1.0f + expf(-y)); }

// How V elements of T are held and computed: packs P of the type's own
// arithmetic, each product and sum rounded once (bf16 two lanes a pack on
// the vector path); the SiLU in f32.
template <typename T, int V>
struct Ops;

template <int V>
struct Ops<float, V> {
  using P = float;
  static constexpr int N = V;
  static __device__ __forceinline__ P mul(P a, P b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ P add(P a, P b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ P zero() { return 0.0f; }
  static __device__ __forceinline__ P silu(P y) { return silu_f(y); }
};

template <>
struct Ops<__nv_bfloat16, 1> {
  using P = __nv_bfloat16;
  static constexpr int N = 1;
  static __device__ __forceinline__ P mul(P a, P b) { return __hmul(a, b); }
  static __device__ __forceinline__ P add(P a, P b) { return __hadd(a, b); }
  static __device__ __forceinline__ P zero() { return __float2bfloat16_rn(0.0f); }
  static __device__ __forceinline__ P silu(P y) {
    return __float2bfloat16_rn(silu_f(__bfloat162float(y)));
  }
};

template <>
struct Ops<__nv_bfloat16, 8> {
  using P = __nv_bfloat162;
  static constexpr int N = 4;
  static __device__ __forceinline__ P mul(P a, P b) { return __hmul2(a, b); }
  static __device__ __forceinline__ P add(P a, P b) { return __hadd2(a, b); }
  static __device__ __forceinline__ P zero() { return __float2bfloat162_rn(0.0f); }
  static __device__ __forceinline__ P silu(P y) {
    const float2 f = __bfloat1622float2(y);
    return __floats2bfloat162_rn(silu_f(f.x), silu_f(f.y));
  }
};

// V elements of T as one load or store (16 bytes on the vector path)
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  typename Ops<T, V>::P p[Ops<T, V>::N];
};

struct Args {
  const void* x;
  const void* w;
  const void* bias;
  const void* prefix;  // null: zeros
  void* out;
  void* state;         // null: not asked for
  int B, S, Ch, W;
  long long xb, xs;    // x's element strides over B and S
  long long pb, ps;    // the prefix's
  int act;             // 1: SiLU after the bias
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const void* base, long long at) {
  return *reinterpret_cast<const Vec<T, V>*>(static_cast<const T*>(base) + at);
}

// Python's sum of the taps: acc starts at 0 and takes r(acc + r(x w)).
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> zeros() {
  Vec<T, V> z;
#pragma unroll
  for (int q = 0; q < Ops<T, V>::N; ++q) z.p[q] = Ops<T, V>::zero();
  return z;
}

template <typename T, int V>
__device__ __forceinline__ void tap(Vec<T, V>& acc, const Vec<T, V>& x, const Vec<T, V>& w) {
  using O = Ops<T, V>;
#pragma unroll
  for (int q = 0; q < O::N; ++q) acc.p[q] = O::add(acc.p[q], O::mul(x.p[q], w.p[q]));
}

// Row r of xp, channels [c, c + V) of sequence b, r counted from x's first
// row: r < 0 is the prefix's row W - 1 + r, zeros without a prefix.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_row(const Args& a, int b, int r, int c) {
  if (r >= 0) return load<T, V>(a.x, b * a.xb + r * a.xs + c);
  if (a.prefix) return load<T, V>(a.prefix, b * a.pb + (a.W - 1 + r) * a.ps + c);
  return zeros<T, V>();
}

// The bias add, then the SiLU where asked.
template <typename T, int V>
__device__ __forceinline__ void finish(Vec<T, V>& acc, const Vec<T, V>& bias, int act) {
  using O = Ops<T, V>;
#pragma unroll
  for (int q = 0; q < O::N; ++q) {
    const typename O::P y = O::add(acc.p[q], bias.p[q]);
    acc.p[q] = act ? O::silu(y) : y;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(void* base, long long at, const Vec<T, V>& o) {
  *reinterpret_cast<Vec<T, V>*>(static_cast<T*>(base) + at) = o;
}

// W taps known at compile time (W - 1 <= UNROLL): the window in registers.
// Instantiated for the published width alone (launch()).
template <typename T, int V, int W>
__global__ void __launch_bounds__(MAX_THREADS) causal_conv_kernel(Args a) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c >= a.Ch) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * TILE;
  const int t1 = min(t0 + TILE, a.S);
  const long long out0 = (long long)b * a.S * a.Ch + c;
  Vec<T, V> wt[W];
#pragma unroll
  for (int i = 0; i < W; ++i) wt[i] = load<T, V>(a.w, (long long)i * a.Ch + c);
  const Vec<T, V> bias = load<T, V>(a.bias, c);
  constexpr int H = W > 1 ? W - 1 : 1;
  Vec<T, V> hist[H];  // rows s - W + 1 .. s - 1 before position s
#pragma unroll
  for (int i = 0; i < W - 1; ++i) hist[i] = load_row<T, V>(a, b, t0 - (W - 1) + i, c);

  int s = t0;
  for (; s + UNROLL <= t1; s += UNROLL) {
    Vec<T, V> nxt[UNROLL];
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) nxt[k] = load_row<T, V>(a, b, s + k, c);
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      Vec<T, V> acc = zeros<T, V>();
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int r = k + i;  // row r of hist ++ nxt
        tap(acc, r < W - 1 ? hist[r < W - 1 ? r : 0] : nxt[r < W - 1 ? 0 : r - (W - 1)], wt[i]);
      }
      finish(acc, bias, a.act);
      store(a.out, out0 + (long long)(s + k) * a.Ch, acc);
    }
#pragma unroll
    for (int i = 0; i < W - 1; ++i) hist[i] = nxt[UNROLL - (W - 1) + i];
  }
  for (; s < t1; ++s) {  // the tile's ragged end, one position at a time
    const Vec<T, V> cur = load_row<T, V>(a, b, s, c);
    Vec<T, V> acc = zeros<T, V>();
#pragma unroll
    for (int i = 0; i < W; ++i) tap(acc, i < W - 1 ? hist[i < W - 1 ? i : 0] : cur, wt[i]);
    finish(acc, bias, a.act);
    store(a.out, out0 + (long long)s * a.Ch, acc);
#pragma unroll
    for (int i = 0; i + 1 < W - 1; ++i) hist[i] = hist[i + 1];
    if (W > 1) hist[H - 1] = cur;
  }
  if (a.state && t1 == a.S) {  // the window now holds rows S - W + 1 .. S - 1
#pragma unroll
    for (int i = 0; i < W - 1; ++i)
      store(a.state, ((long long)b * (W - 1) + i) * a.Ch + c, hist[i]);
  }
}

// Any W: each output reads its W rows anew (the earlier ones from L1).
template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS) causal_conv_any_kernel(Args a) {
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (c >= a.Ch) return;
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * TILE;
  const int t1 = min(t0 + TILE, a.S);
  const Vec<T, V> bias = load<T, V>(a.bias, c);
  for (int s = t0; s < t1; ++s) {
    Vec<T, V> acc = zeros<T, V>();
    for (int i = 0; i < a.W; ++i)
      tap(acc, load_row<T, V>(a, b, s - (a.W - 1) + i, c),
          load<T, V>(a.w, (long long)i * a.Ch + c));
    finish(acc, bias, a.act);
    store(a.out, ((long long)b * a.S + s) * a.Ch + c, acc);
  }
  if (a.state && t1 == a.S)
    for (int i = 0; i < a.W - 1; ++i)
      store(a.state, ((long long)b * (a.W - 1) + i) * a.Ch + c,
            load_row<T, V>(a, b, a.S - (a.W - 1) + i, c));
}

template <typename T, int V>
int launch(const Args& a, cudaStream_t stream) {
  const int chunks = (a.Ch + V - 1) / V;
  const int threads = min(MAX_THREADS, (chunks + 31) / 32 * 32);
  const dim3 grid((chunks + threads - 1) / threads, (a.S + TILE - 1) / TILE, a.B);
  if (a.W == 4)
    causal_conv_kernel<T, V, 4><<<grid, threads, 0, stream>>>(a);
  else
    causal_conv_any_kernel<T, V><<<grid, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, the prefix (null: zeros), out and state (null: not written) as above;
// dtype 0 = f32, 1 = bf16; strides = x's (B, S) then the prefix's (B, S)
// element strides; vec = 1 where every row the kernel reads or writes
// starts on a 16-byte boundary and Ch is a multiple of the vector; act = 1
// for the SiLU.  Returns a cudaError_t (0 = launched).
extern "C" int causal_conv_launch(const void* x, const void* w, const void* bias,
                                  const void* prefix, void* out, void* state, int dtype, int B,
                                  int S, int Ch, int W, const long long* strides, int vec,
                                  int act, void* stream) {
  const Args a{x, w, bias, prefix, out, state, B, S, Ch, W,
               strides[0], strides[1], strides[2], strides[3], act};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return vec ? launch<float, 4>(a, s) : launch<float, 1>(a, s);
  return vec ? launch<__nv_bfloat16, 8>(a, s) : launch<__nv_bfloat16, 1>(a, s);
}

extern "C" const char* causal_conv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
