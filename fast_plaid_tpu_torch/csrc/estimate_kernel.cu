// Segmented per-slot estimates for the budgeted PLAID candidate path (stage 4).
//
// Replaces: fast_plaid_tpu/ops/estimate_kernel.py:_kernel (Pallas, TPU), wrapper
// segmented_estimate. For slot i of the pid-sorted row b:
//
//   out[b, i] = sum_q max_{j in [i, end of i's equal-pid run)} table[b, own[b, j], q]
//
// which at each run head is the candidate's per-query-token estimate; the caller
// masks the other slots. The TPU kernel built the gathered rows with a one-hot
// matmul and carried partial runs right to left across its sequential grid; both
// are artifacts of that machine and are not carried over.
//
// What bounds it on the H100: memory. Each slot reads two int32 (pid, own) and
// writes one float32, 12 bytes, against a handful of max/add operations; the
// [C, Q] bf16 table is read once per row (a few KB to tens of KB). At the main
// path (B 256, W 12,152, Q 32) that is ~41 MB, 0.012 ms at 3.35 TB/s. What
// must not bound it is run length: every row ends in one run of sentinel slots
// that can span most of the row.
//
// Design: one launch, one block per row; the block walks the row right to left
// in tiles of 2,048 slots, thread t owning 8 consecutive slots. A slot's value
// is its table row, Q bf16 kept as bf16x2 words (a max is exact in bf16), read
// as 16-byte vectors through the read-only cache (the row's table, reused by
// every slot, stays in L1/L2; no shared-memory copy and no size limit). The
// suffix max is a segmented scan with (flag, vector) pairs, flag = "a run ends
// in this span": each thread folds its 8 slots, a warp combines its lanes with
// shuffles, the 8 warps meet through shared memory, and the value at the tile's
// first slot carries into the next tile to the left. A second pass over the
// thread's slots (table rows again, cache hits) writes each slot's Q-sum in
// float32. pid and own load as int4 and out stores as float4 where the row
// width allows. Owner indices outside [0, C) are clamped. The output equals
// the plain reference at every slot, not only at heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = 8;                    // slots per thread
constexpr int kTileSlots = kThreads * kPer;  // slots per tile
constexpr int kMaxVec = 16;                // 16-byte vectors per table row: Q <= 128
constexpr unsigned kNegInf2 = 0xFF80FF80u;  // two bf16 -inf

template <int NV>
struct Vec {
  uint4 v[NV];
};

template <int NV>
__device__ __forceinline__ void set_neg(Vec<NV>& a) {
#pragma unroll
  for (int j = 0; j < NV; ++j) a.v[j] = make_uint4(kNegInf2, kNegInf2, kNegInf2, kNegInf2);
}

__device__ __forceinline__ unsigned hmax2(unsigned a, unsigned b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  __nv_bfloat162 m = __hmax2(x, y);
  return *reinterpret_cast<unsigned*>(&m);
}

template <int NV>
__device__ __forceinline__ void vmax(Vec<NV>& a, const Vec<NV>& b) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    a.v[j].x = hmax2(a.v[j].x, b.v[j].x);
    a.v[j].y = hmax2(a.v[j].y, b.v[j].y);
    a.v[j].z = hmax2(a.v[j].z, b.v[j].z);
    a.v[j].w = hmax2(a.v[j].w, b.v[j].w);
  }
}

// The suffix value at the start of a span (flag f: a run ends inside it; v:
// its own suffix value) from the value c just right of it: c <- f ? v : max(v, c).
template <int NV>
__device__ __forceinline__ void fold(Vec<NV>& c, bool f, const Vec<NV>& v) {
  if (f) {
    c = v;
  } else {
    vmax(c, v);
  }
}

template <int NV>
__device__ __forceinline__ void load_row(Vec<NV>& a, const uint4* __restrict__ tbl, int o) {
#pragma unroll
  for (int j = 0; j < NV; ++j) a.v[j] = __ldg(tbl + o * NV + j);
}

template <int NV>
__device__ __forceinline__ void shfl_down(Vec<NV>& out, const Vec<NV>& a, int off) {
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    out.v[j].x = __shfl_down_sync(0xffffffffu, a.v[j].x, off);
    out.v[j].y = __shfl_down_sync(0xffffffffu, a.v[j].y, off);
    out.v[j].z = __shfl_down_sync(0xffffffffu, a.v[j].z, off);
    out.v[j].w = __shfl_down_sync(0xffffffffu, a.v[j].w, off);
  }
}

__device__ __forceinline__ float sum2(unsigned w, int q, int Q) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w));
  return (q < Q ? f.x : 0.f) + (q + 1 < Q ? f.y : 0.f);
}

template <int NV>
__device__ __forceinline__ float qsum(const Vec<NV>& a, int Q) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    s += sum2(a.v[j].x, 8 * j, Q);
    s += sum2(a.v[j].y, 8 * j + 2, Q);
    s += sum2(a.v[j].z, 8 * j + 4, Q);
    s += sum2(a.v[j].w, 8 * j + 6, Q);
  }
  return s;
}

// table: [B, C, NV * 8] bf16 (the wrapper pads Q with zeros); Q the real width.
template <int NV>
__global__ void __launch_bounds__(kThreads)
estimate_kernel(const int32_t* __restrict__ pid, const int32_t* __restrict__ own,
                const __nv_bfloat16* __restrict__ table, float* __restrict__ out, int W, int C,
                int Q) {
  __shared__ Vec<NV> agg_v[kWarps];
  __shared__ int agg_f[kWarps];
  __shared__ Vec<NV> carry[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * W;
  const uint4* tbl = reinterpret_cast<const uint4*>(table) +
                     static_cast<long long>(blockIdx.x) * C * NV;
  const bool vec_ok = (W % 4) == 0;
  if (tid == 0) set_neg(carry[0]);
  __syncthreads();

  const int n_tiles = (W + kTileSlots - 1) / kTileSlots;
  int par = 0;
  for (int k = n_tiles - 1; k >= 0; --k, par ^= 1) {
    const int base = k * kTileSlots + tid * kPer;
    int p[kPer], o[kPer];
    if (vec_ok && base + kPer <= W) {
      const int4* pv = reinterpret_cast<const int4*>(pid + row + base);
      const int4* ov = reinterpret_cast<const int4*>(own + row + base);
      const int4 p0 = __ldg(pv), p1 = __ldg(pv + 1), o0 = __ldg(ov), o1 = __ldg(ov + 1);
      p[0] = p0.x; p[1] = p0.y; p[2] = p0.z; p[3] = p0.w;
      p[4] = p1.x; p[5] = p1.y; p[6] = p1.z; p[7] = p1.w;
      o[0] = o0.x; o[1] = o0.y; o[2] = o0.z; o[3] = o0.w;
      o[4] = o1.x; o[5] = o1.y; o[6] = o1.z; o[7] = o1.w;
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const bool in = base + i < W;
        p[i] = in ? __ldg(pid + row + base + i) : 0;
        o[i] = in ? __ldg(own + row + base + i) : 0;
      }
    }
    const int next = base + kPer < W ? __ldg(pid + row + base + kPer) : 0;
    // f[i]: a run ends at slot i (or the slot lies past the row).
    bool f[kPer];
    bool any_f = false;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int idx = base + i;
      const int pn = i + 1 < kPer ? p[i + 1] : next;
      f[i] = idx >= W - 1 || p[i] != pn;
      any_f |= f[i];
      o[i] = min(max(o[i], 0), C - 1);
    }
    // Pass 1: this thread's (F, V): the suffix value at its first slot within
    // its own 8 slots.
    Vec<NV> V, t;
    set_neg(V);
#pragma unroll
    for (int i = kPer - 1; i >= 0; --i) {
      if (base + i < W) {
        load_row(t, tbl, o[i]);
        fold(V, f[i], t);
      } else {
        set_neg(V);
      }
    }
    // Lanes to the right, inclusive: (F, V) of lanes [lane, 31].
    bool F = any_f;
    for (int off = 1; off < 32; off <<= 1) {
      Vec<NV> r;
      shfl_down(r, V, off);
      const bool fr = __shfl_down_sync(0xffffffffu, static_cast<int>(F), off);
      if (lane + off < 32) {
        if (!F) vmax(V, r);
        F |= fr;
      }
    }
    Vec<NV> X;
    shfl_down(X, V, 1);
    const bool fx = __shfl_down_sync(0xffffffffu, static_cast<int>(F), 1);
    if (lane == 0) {
      agg_v[warp] = V;
      agg_f[warp] = F;
    }
    __syncthreads();
    // The suffix value just right of this thread's span.
    Vec<NV> c = carry[par];
    for (int w = kWarps - 1; w > warp; --w) fold(c, agg_f[w], agg_v[w]);
    if (lane < 31) fold(c, fx, X);
    // Pass 2: each slot's suffix value, summed over Q.
    float s[kPer];
#pragma unroll
    for (int i = kPer - 1; i >= 0; --i) {
      if (base + i < W) {
        load_row(t, tbl, o[i]);
        fold(c, f[i], t);
        s[i] = qsum(c, Q);
      } else {
        set_neg(c);
        s[i] = 0.f;
      }
    }
    if (vec_ok && base + kPer <= W) {
      float4* ov = reinterpret_cast<float4*>(out + row + base);
      ov[0] = make_float4(s[0], s[1], s[2], s[3]);
      ov[1] = make_float4(s[4], s[5], s[6], s[7]);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        if (base + i < W) out[row + base + i] = s[i];
      }
    }
    if (tid == 0) carry[par ^ 1] = c;  // the value at the tile's first slot
    __syncthreads();
  }
}

template <int NV>
int launch(const void* pid, const void* own, const void* table, void* out, int B, int W, int C,
           int Q, cudaStream_t s) {
  estimate_kernel<NV><<<B, kThreads, 0, s>>>(
      static_cast<const int32_t*>(pid), static_cast<const int32_t*>(own),
      static_cast<const __nv_bfloat16*>(table), static_cast<float*>(out), W, C, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fp_segmented_estimate_max_q() { return 8 * kMaxVec; }

// pid, own: [B, W] int32; table: [B, C, Qp] bf16 with Qp = 8 * v, v the
// smallest power of two with 8 * v >= Q (columns past Q are ignored); out:
// [B, W] float32. Pointers 16-byte aligned. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int fp_segmented_estimate(const void* pid, const void* own, const void* table,
                                     void* out, int B, int W, int C, int Q, void* stream) {
  if (B == 0 || W == 0) return 0;
  if (Q < 1 || Q > 8 * kMaxVec || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 8) return launch<1>(pid, own, table, out, B, W, C, Q, s);
  if (Q <= 16) return launch<2>(pid, own, table, out, B, W, C, Q, s);
  if (Q <= 32) return launch<4>(pid, own, table, out, B, W, C, Q, s);
  if (Q <= 64) return launch<8>(pid, own, table, out, B, W, C, Q, s);
  return launch<16>(pid, own, table, out, B, W, C, Q, s);
}
