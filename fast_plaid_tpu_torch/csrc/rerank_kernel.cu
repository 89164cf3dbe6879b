// Fused candidate gather + exact MaxSim over the bf16 corpus cache (stage 6).
//
// Replaces: fast_plaid_tpu/ops/rerank_kernel.py:_kernel (Pallas, TPU), wrapper
// maxsim_gather_scores. For query row b and candidate r:
//
//   out[b, r] = sum_q max_{t < len[b, r]} <emb[pid[b, r], t, :], queries[b, q, :]>
//
// with bf16 inputs and float32 accumulation; a candidate whose length is 0, or
// whose pid lies outside [0, n_rows), scores -inf and its row is never read
// (out-of-range pids are treated as empty, not clamped). Rows past len are not
// zero in the cache (padded codes decompress to a real vector), so the max is
// masked by len.
//
// What bounds it on the H100: memory. Each candidate moves len * D * 2 bytes
// (up to 40 KB at doc_cap 160, D 128) for 2 * len * Q * D flops, about 32 flops
// a byte against the card's ~295 bf16 flops a byte: at B = 256, R = 2048 a
// query tile reads ~21 GB, ~6 ms at 3.35 TB/s, while its ~0.34 TFLOP take
// ~0.35 ms of tensor-core time.
//
// Design: one block of 8 warps per (query row b, group of kCandPerBlock
// candidates). The block stages q_b [Q, D] in shared memory once, then walks its
// candidates with a two-stage cp.async ring: candidate r + 1's rows (only the
// first len of them) stream into one buffer while candidate r is contracted from
// the other. The [len, D] x [D, Q] product runs on the tensor cores through
// nvcuda::wmma 16x16x16 bf16 tiles with float32 accumulators, stored to a shared
// [doc_cap, Q] score tile; warps then take the masked max over tokens per query
// token and the block sums over query tokens. Only [B, R] floats are written.
// TMA, wgmma and deeper pipelining are later work.

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
  int lds;   // float row stride of the score tile (qp + 4)
  size_t q_off, buf_off, buf_bytes, s_off, red_off, total;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline Layout make_layout(int doc_cap, int D, int Q) {
  Layout l;
  l.lda = D + 8;
  l.qp = (Q + 15) / 16 * 16;
  l.lds = l.qp + 4;
  l.q_off = 0;
  l.buf_off = align128(static_cast<size_t>(l.qp) * l.lda * 2);
  l.buf_bytes = align128(static_cast<size_t>(doc_cap) * l.lda * 2);
  l.s_off = l.buf_off + 2 * l.buf_bytes;
  l.red_off = l.s_off + align128(static_cast<size_t>(doc_cap) * l.lds * 4);
  l.total = l.red_off + align128(kWarps * sizeof(float));
  return l;
}

__global__ void __launch_bounds__(kThreads)
maxsim_gather_kernel(const __nv_bfloat16* __restrict__ emb, int n_rows, int doc_cap,
                     int D, const int32_t* __restrict__ pids,
                     const int32_t* __restrict__ lens,
                     const __nv_bfloat16* __restrict__ queries, int R, int Q,
                     float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(doc_cap, D, Q);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q_off);
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem + L.buf_off);
  __nv_bfloat16* buf1 = reinterpret_cast<__nv_bfloat16*>(smem + L.buf_off + L.buf_bytes);
  float* S = reinterpret_cast<float*>(smem + L.s_off);
  float* red = reinterpret_cast<float*>(smem + L.red_off);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kCandPerBlock;
  const int r1 = min(r0 + kCandPerBlock, R);
  const int vecs = D / 8;  // 16-byte vectors per row

  // q_b -> shared, zero rows Q..qp-1.
  for (int idx = tid; idx < L.qp * vecs; idx += kThreads) {
    const int row = idx / vecs, c8 = idx % vecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < Q) {
      v = reinterpret_cast<const uint4*>(
          queries + (static_cast<int64_t>(b) * Q + row) * D)[c8];
    }
    *reinterpret_cast<uint4*>(qs + row * L.lda + c8 * 8) = v;
  }

  auto valid_len = [&](int r) -> int {
    const int64_t k = static_cast<int64_t>(b) * R + r;
    const int32_t pid = pids[k];
    if (pid < 0 || pid >= n_rows) return 0;
    return min(max(static_cast<int>(lens[k]), 0), doc_cap);
  };
  auto issue = [&](int r, __nv_bfloat16* buf) {
    const int n = valid_len(r);
    if (n == 0) return;
    const int64_t pid = pids[static_cast<int64_t>(b) * R + r];
    const __nv_bfloat16* src = emb + pid * doc_cap * static_cast<int64_t>(D);
    for (int c = tid; c < n * vecs; c += kThreads) {
      const int row = c / vecs, c8 = c % vecs;
      cp_async16(buf + row * L.lda + c8 * 8, src + static_cast<int64_t>(row) * D + c8 * 8);
    }
  };

  if (r0 < r1) issue(r0, buf0);
  cp_async_commit();
  const int n_qt = L.qp / 16;
  for (int r = r0; r < r1; ++r) {
    const int cur = (r - r0) & 1;
    if (r + 1 < r1) issue(r + 1, cur ? buf0 : buf1);
    cp_async_commit();
    cp_async_wait_prev();  // candidate r's rows have landed (this thread's copies)
    __syncthreads();       // ... and everyone's, and q_b on the first pass

    const int n = valid_len(r);
    if (n == 0) {
      if (tid == 0) out[static_cast<int64_t>(b) * R + r] = -INFINITY;
    } else {
      const __nv_bfloat16* A = cur ? buf1 : buf0;
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
      // Rows t >= n of the score tile hold garbage (stale or unloaded rows)
      // and are never read: the loop below stops at n.
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
        out[static_cast<int64_t>(b) * R + r] = s;
      }
    }
    __syncthreads();  // buffers, S and red are reused by the next candidate
  }
}

}  // namespace

// Shared-memory bytes one block needs for this shape (the wrapper checks it).
extern "C" long long fp_maxsim_gather_smem_bytes(int doc_cap, int D, int Q) {
  return static_cast<long long>(make_layout(doc_cap, D, Q).total);
}

// emb: [n_rows, doc_cap, D] bf16; pids, lens: [B, R] int32; queries: [B, Q, D]
// bf16; out: [B, R] float32. doc_cap and D multiples of 16. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int fp_maxsim_gather(const void* emb, int n_rows, int doc_cap, int D,
                                const void* pids, const void* lens,
                                const void* queries, int B, int R, int Q, void* out,
                                void* stream) {
  if (B == 0 || R == 0) return 0;
  const size_t smem = make_layout(doc_cap, D, Q).total;
  cudaError_t err = cudaFuncSetAttribute(maxsim_gather_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((R + kCandPerBlock - 1) / kCandPerBlock, B);
  maxsim_gather_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(emb), n_rows, doc_cap, D,
      static_cast<const int32_t*>(pids), static_cast<const int32_t*>(lens),
      static_cast<const __nv_bfloat16*>(queries), R, Q, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
