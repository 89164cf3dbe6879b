// Fused candidate gather + 4-bit dequantization + MaxSim over the q4 prefilter
// cache (the q4 tier's stage 6 and the low_memory prefilter).
//
// Replaces: fast_plaid_tpu/ops/rerank_kernel.py:_q4_kernel (Pallas, TPU), wrapper
// maxsim_q4_gather_scores. For query row b and candidate r, with
// p = clip(pid[b, r], 0, n_docs - 1) and caph = doc_cap / 2:
//
//   out[b, r] = scale[p] * sum_q max_{t < len[b, r]} <level(p, t), queries[b, q]>
//
// where level(p, t) is the low nibble of packed row p * caph + t for t < caph
// and the high nibble of row p * caph + t - caph for t >= caph, each minus 8
// (ops/q4cache.py token-pair packing). Levels -7..7 are exact in bf16; the
// contraction runs in bf16 with float32 accumulation. len <= 0 scores -inf.
//
// What bounds it on the H100: memory. A candidate moves min(len, caph) * D
// bytes (10 KB at doc_cap 160, D 128), a quarter of the bf16 cache row, for
// 2 * len * Q * D flops: ~128 flops a byte, still under the card's ~295 bf16
// flops a byte.
//
// Design: that of csrc/rerank_kernel.cu. One block of 8 warps per (query row b,
// group of kCandPerBlock candidates); q_b sits in shared memory; a two-stage
// cp.async ring streams candidate r + 1's packed rows (only the first
// min(len, caph)) while candidate r is worked on. The block dequantizes the
// packed rows into one bf16 [doc_cap, D] tile in document token order (low
// plane to rows t, high plane to rows t + caph, only rows below len written),
// so the rest is the bf16 kernel's: wmma 16x16x16 tiles into a shared
// [doc_cap, Q] score tile, a masked max over the first len rows per query
// token, the sum over query tokens, and the per-document scale in the epilogue.
// Max-combining the two planes (the Pallas kernel) and taking the max over the
// reassembled token order are the same reduction. TMA, wgmma and deeper
// pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCandPerBlock = 16;

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem_ptr) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_ptr));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Layout {
  int lda;   // bf16 row stride of the q and document tiles (D + 8)
  int qp;    // Q rounded up to 16
  int capp;  // doc_cap rounded up to 16 (rows of the bf16 tile)
  int lds;   // float row stride of the score tile (qp + 4)
  size_t q_off, pk_off, pk_bytes, a_off, s_off, red_off, total;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline Layout make_layout(int caph, int D, int Q) {
  Layout l;
  l.lda = D + 8;
  l.qp = (Q + 15) / 16 * 16;
  l.capp = (2 * caph + 15) / 16 * 16;
  l.lds = l.qp + 4;
  l.q_off = 0;
  l.pk_off = align128(static_cast<size_t>(l.qp) * l.lda * 2);
  l.pk_bytes = align128(static_cast<size_t>(caph) * D);
  l.a_off = l.pk_off + 2 * l.pk_bytes;
  l.s_off = l.a_off + align128(static_cast<size_t>(l.capp) * l.lda * 2);
  l.red_off = l.s_off + align128(static_cast<size_t>(l.capp) * l.lds * 4);
  l.total = l.red_off + align128(kWarps * sizeof(float));
  return l;
}

// Four packed bytes -> four bf16 levels of one plane, as two bf16 pairs.
__device__ __forceinline__ void dequant4(uint32_t w, int shift, __nv_bfloat162* dst) {
  const int b0 = static_cast<int>((w >> shift) & 15u) - 8;
  const int b1 = static_cast<int>((w >> (shift + 8)) & 15u) - 8;
  const int b2 = static_cast<int>((w >> (shift + 16)) & 15u) - 8;
  const int b3 = static_cast<int>((w >> (shift + 24)) & 15u) - 8;
  dst[0] = __floats2bfloat162_rn(static_cast<float>(b0), static_cast<float>(b1));
  dst[1] = __floats2bfloat162_rn(static_cast<float>(b2), static_cast<float>(b3));
}

__global__ void __launch_bounds__(kThreads)
maxsim_q4_gather_kernel(const uint8_t* __restrict__ emb_q4, const float* __restrict__ scale,
                        int n_docs, int caph, int D, const int32_t* __restrict__ pids,
                        const int32_t* __restrict__ lens,
                        const __nv_bfloat16* __restrict__ queries, int R, int Q,
                        float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(caph, D, Q);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q_off);
  uint8_t* pk0 = smem + L.pk_off;
  uint8_t* pk1 = smem + L.pk_off + L.pk_bytes;
  __nv_bfloat16* A = reinterpret_cast<__nv_bfloat16*>(smem + L.a_off);
  float* S = reinterpret_cast<float*>(smem + L.s_off);
  float* red = reinterpret_cast<float*>(smem + L.red_off);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kCandPerBlock;
  const int r1 = min(r0 + kCandPerBlock, R);
  const int doc_cap = 2 * caph;
  const int qvecs = D / 8;    // 16-byte vectors per bf16 query row
  const int pvecs = D / 16;   // 16-byte vectors per packed row

  for (int idx = tid; idx < L.qp * qvecs; idx += kThreads) {
    const int row = idx / qvecs, c8 = idx % qvecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < Q) {
      v = reinterpret_cast<const uint4*>(
          queries + (static_cast<int64_t>(b) * Q + row) * D)[c8];
    }
    *reinterpret_cast<uint4*>(qs + row * L.lda + c8 * 8) = v;
  }

  auto doc_of = [&](int r) -> int64_t {
    const int32_t pid = pids[static_cast<int64_t>(b) * R + r];
    return static_cast<int64_t>(min(max(static_cast<int>(pid), 0), n_docs - 1));
  };
  auto valid_len = [&](int r) -> int {
    return min(max(static_cast<int>(lens[static_cast<int64_t>(b) * R + r]), 0), doc_cap);
  };
  auto issue = [&](int r, uint8_t* buf) {
    const int rows = min(valid_len(r), caph);
    const uint8_t* src = emb_q4 + doc_of(r) * caph * static_cast<int64_t>(D);
    for (int c = tid; c < rows * pvecs; c += kThreads) {
      cp_async16(buf + c * 16, src + static_cast<int64_t>(c) * 16);
    }
  };

  if (r0 < r1) issue(r0, pk0);
  cp_async_commit();
  const int n_qt = L.qp / 16;
  for (int r = r0; r < r1; ++r) {
    const int cur = (r - r0) & 1;
    if (r + 1 < r1) issue(r + 1, cur ? pk0 : pk1);
    cp_async_commit();
    cp_async_wait_prev();  // candidate r's packed rows have landed (this thread's)
    __syncthreads();       // ... and everyone's, and q_b on the first pass

    const int n = valid_len(r);
    if (n == 0) {
      if (tid == 0) out[static_cast<int64_t>(b) * R + r] = -INFINITY;
    } else {
      // Dequantize: packed row t -> bf16 rows t (low plane) and t + caph (high
      // plane, only where t + caph < n). 16 packed bytes per thread step.
      const uint8_t* pk = cur ? pk1 : pk0;
      const int rows = min(n, caph);
      for (int c = tid; c < rows * pvecs; c += kThreads) {
        const int row = c / pvecs, c16 = c % pvecs;
        const uint4 v = *reinterpret_cast<const uint4*>(pk + c * 16);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
        __align__(16) __nv_bfloat162 lo[8];
        __align__(16) __nv_bfloat162 hi[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dequant4(w[i], 0, lo + 2 * i);
          dequant4(w[i], 4, hi + 2 * i);
        }
        uint4* dl = reinterpret_cast<uint4*>(A + row * L.lda + c16 * 16);
        dl[0] = reinterpret_cast<const uint4*>(lo)[0];
        dl[1] = reinterpret_cast<const uint4*>(lo)[1];
        if (row + caph < n) {
          uint4* dh = reinterpret_cast<uint4*>(A + (row + caph) * L.lda + c16 * 16);
          dh[0] = reinterpret_cast<const uint4*>(hi)[0];
          dh[1] = reinterpret_cast<const uint4*>(hi)[1];
        }
      }
      __syncthreads();
      const int tiles = ((n + 15) / 16) * n_qt;
      for (int tile = warp; tile < tiles; tile += kWarps) {
        const int mt = tile / n_qt, nt = tile % n_qt;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int kk = 0; kk < D; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, A + mt * 16 * L.lda + kk, L.lda);
          wmma::load_matrix_sync(fb, qs + nt * 16 * L.lda + kk, L.lda);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(S + mt * 16 * L.lds + nt * 16, acc, L.lds,
                                wmma::mem_row_major);
      }
      __syncthreads();
      // Rows t >= n of the bf16 tile and of the score tile hold stale data and
      // are never read: the loop below stops at n.
      float part = 0.f;
      for (int q = warp; q < Q; q += kWarps) {
        float mx = -INFINITY;
        for (int t = lane; t < n; t += 32) mx = fmaxf(mx, S[t * L.lds + q]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        part += mx;
      }
      if (lane == 0) red[warp] = part;
      __syncthreads();
      if (tid == 0) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[w];
        out[static_cast<int64_t>(b) * R + r] = s * scale[doc_of(r)];
      }
    }
    __syncthreads();  // buffers, A, S and red are reused by the next candidate
  }
}

}  // namespace

// Shared-memory bytes one block needs for this shape (the wrapper checks it).
extern "C" long long fp_maxsim_q4_gather_smem_bytes(int caph, int D, int Q) {
  return static_cast<long long>(make_layout(caph, D, Q).total);
}

// emb_q4: [n_docs * caph, D] uint8; scale: [n_docs] float32; pids, lens: [B, R]
// int32; queries: [B, Q, D] bf16; out: [B, R] float32. D a multiple of 16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fp_maxsim_q4_gather(const void* emb_q4, const void* scale, int n_docs,
                                   int caph, int D, const void* pids, const void* lens,
                                   const void* queries, int B, int R, int Q, void* out,
                                   void* stream) {
  if (B == 0 || R == 0) return 0;
  const size_t smem = make_layout(caph, D, Q).total;
  cudaError_t err = cudaFuncSetAttribute(maxsim_q4_gather_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + kCandPerBlock - 1) / kCandPerBlock, B);
  maxsim_q4_gather_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(emb_q4), static_cast<const float*>(scale), n_docs, caph,
      D, static_cast<const int32_t*>(pids), static_cast<const int32_t*>(lens),
      static_cast<const __nv_bfloat16*>(queries), R, Q, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
