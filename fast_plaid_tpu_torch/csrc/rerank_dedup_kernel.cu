// Deduplicated fused rerank: one read of each candidate row per (document,
// group of at most G requesting queries), over the bf16 corpus cache (stage 6).
//
// Replaces: fast_plaid_tpu/ops/rerank_dedup.py:_dedup_kernel (Pallas, TPU),
// wrapper maxsim_gather_scores_dedup. ops/rerank_dedup.py's group_pool sorts the
// [B, R] rerank pool by pid and cuts each pid's run of requesters into entries
// of at most G; this kernel scores entry e's row against each of its cnt[e]
// requesters:
//
//   out[e, j] = sum_q max_{t < len[e]} <emb[pid[e], t, :], queries[qidx[e, j], q, :]>
//
// for j < cnt[e], bf16 inputs and float32 accumulation. An entry of length 0, or
// whose pid lies outside [0, n_rows), scores -inf for its live slots without a
// read; slots j >= cnt[e] and entries >= *n_entries are never written (the
// wrapper scatters only live slots back to [B, R]). The Pallas kernel sums over
// Q with a 0/1 matmul and clamps -inf at -1e30 (TPU workarounds); here each
// requester's sum is a plain loop over its Q column maxima.
//
// What bounds it on the H100: memory, as the per-query kernel, but on fewer
// rows. At B 256, R 2048 over 57,640 rows the per-query kernel reads 524,288
// candidate rows (~16 GB); the tile holds at most B*R/G + Np = 123,176 entries.
// The requesters' query blocks (Q x D bf16, 8 KB each) come from the tile's
// 2 MB of queries, which stay in L2.
//
// Design: that of csrc/rerank_kernel.cu, with entries in place of candidates.
// One block of 8 warps walks kEntPerBlock consecutive entries with a two-stage
// cp.async ring (entry e + 1's first len rows stream in while entry e is
// contracted). Blocks whose first entry lies at or past *n_entries (read on the
// device: the entry count is data dependent) return at once. A warp owns one
// 16-column tile of one requester's query tokens: it loads that tile's D/16
// wmma B fragments from global memory (L2) into registers once, then walks the
// row's 16-token M tiles (split across warps when cnt is small), reducing each
// 16x16 f32 product tile through a per-warp shared scratch into running column
// maxima, masked by len. Column maxima of the entry meet in shared memory
// (atomic float max: order-free, so deterministic); thread j then sums
// requester j's Q maxima. TMA, wgmma and deeper pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kEntPerBlock = 8;
constexpr int kScrLd = 20;  // float row stride of a warp's 16x16 scratch tile

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

// Float max through integer atomics; the target starts at -inf.
__device__ __forceinline__ void atomic_max_f(float* addr, float v) {
  if (v >= 0.f) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

struct Layout {
  int lda;  // bf16 row stride of the document tiles (D + 8)
  size_t buf_off, buf_bytes, scr_off, col_off, total;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

__host__ __device__ inline Layout make_layout(int doc_cap, int D, int Q, int G) {
  Layout l;
  l.lda = D + 8;
  l.buf_off = 0;
  l.buf_bytes = align128(static_cast<size_t>((doc_cap + 15) / 16 * 16) * l.lda * 2);
  l.scr_off = 2 * l.buf_bytes;
  l.col_off = l.scr_off + align128(static_cast<size_t>(kWarps) * 16 * kScrLd * 4);
  l.total = l.col_off + align128(static_cast<size_t>(G) * Q * 4);
  return l;
}

template <int KT>  // KT = D / 16
__global__ void __launch_bounds__(kThreads, 2)
maxsim_dedup_kernel(const __nv_bfloat16* __restrict__ emb, int n_rows, int doc_cap,
                    const int32_t* __restrict__ epid, const int32_t* __restrict__ elen,
                    const int32_t* __restrict__ ecnt, const int32_t* __restrict__ eqidx,
                    const int32_t* __restrict__ n_entries, int E,
                    const __nv_bfloat16* __restrict__ queries, int Q, int G,
                    float* __restrict__ out) {
  constexpr int D = KT * 16;
  const int n_ent = min(*n_entries, E);
  const int e0 = blockIdx.x * kEntPerBlock;
  if (e0 >= n_ent) return;  // padding entries cost one read of the count
  const int e1 = min(e0 + kEntPerBlock, n_ent);

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(doc_cap, D, Q, G);
  __nv_bfloat16* buf0 = reinterpret_cast<__nv_bfloat16*>(smem + L.buf_off);
  __nv_bfloat16* buf1 = reinterpret_cast<__nv_bfloat16*>(smem + L.buf_off + L.buf_bytes);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* scr = reinterpret_cast<float*>(smem + L.scr_off) + warp * 16 * kScrLd;
  float* colmax = reinterpret_cast<float*>(smem + L.col_off);
  constexpr int vecs = D / 8;  // 16-byte vectors per row

  auto valid_len = [&](int e) -> int {
    const int32_t pid = epid[e];
    if (pid < 0 || pid >= n_rows) return 0;
    return min(max(static_cast<int>(elen[e]), 0), doc_cap);
  };
  auto issue = [&](int e, __nv_bfloat16* buf) {
    const int n = valid_len(e);
    if (n == 0) return;
    const __nv_bfloat16* src = emb + static_cast<int64_t>(epid[e]) * doc_cap * D;
    for (int c = tid; c < n * vecs; c += kThreads) {
      const int row = c / vecs, c8 = c % vecs;
      cp_async16(buf + row * L.lda + c8 * 8, src + static_cast<int64_t>(row) * D + c8 * 8);
    }
  };

  issue(e0, buf0);
  cp_async_commit();
  const int qt = Q / 16;  // 16-column tiles per requester
  for (int e = e0; e < e1; ++e) {
    const int cur = (e - e0) & 1;
    if (e + 1 < e1) issue(e + 1, cur ? buf0 : buf1);
    cp_async_commit();
    const int n = valid_len(e);
    const int cnt = min(max(static_cast<int>(ecnt[e]), 0), G);
    for (int i = tid; i < cnt * Q; i += kThreads) colmax[i] = -INFINITY;
    cp_async_wait_prev();  // entry e's rows have landed (this thread's copies)
    __syncthreads();       // ... and everyone's, and colmax is reset

    if (n == 0) {
      if (tid < cnt) out[static_cast<int64_t>(e) * G + tid] = -INFINITY;
    } else {
      const __nv_bfloat16* A = cur ? buf1 : buf0;
      const int n_ct = cnt * qt;
      const int n_mt = (n + 15) / 16;
      const int groups = max(1, kWarps / max(n_ct, 1));  // M-tile split when cnt is small
      for (int it = warp; it < n_ct * groups; it += kWarps) {
        const int ct = it / groups, grp = it % groups;
        if (grp >= n_mt) continue;
        const int j = ct / qt, c = ct % qt;
        const int64_t qi = eqidx[static_cast<int64_t>(e) * G + j];
        const __nv_bfloat16* qb = queries + (qi * Q + c * 16) * D;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb[KT];
#pragma unroll
        for (int k = 0; k < KT; ++k) wmma::load_matrix_sync(fb[k], qb + k * 16, D);
        float cm = -INFINITY;
        for (int mt = grp; mt < n_mt; mt += groups) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
          wmma::fill_fragment(acc, 0.0f);
#pragma unroll
          for (int k = 0; k < KT; ++k) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
            wmma::load_matrix_sync(fa, A + mt * 16 * L.lda + k * 16, L.lda);
            wmma::mma_sync(acc, fa, fb[k], acc);
          }
          wmma::store_matrix_sync(scr, acc, kScrLd, wmma::mem_row_major);
          __syncwarp();
          // Lanes 0-15 take rows 0-7 of column lane, lanes 16-31 rows 8-15.
          const int col = lane & 15, half = lane >> 4;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int row = half * 8 + i;
            if (mt * 16 + row < n) cm = fmaxf(cm, scr[row * kScrLd + col]);
          }
          __syncwarp();
        }
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, 16));
        if (lane < 16) atomic_max_f(&colmax[ct * 16 + lane], cm);
      }
      __syncthreads();
      if (tid < cnt) {
        float s = 0.f;
        for (int x = 0; x < Q; ++x) s += colmax[tid * Q + x];
        out[static_cast<int64_t>(e) * G + tid] = s;
      }
    }
    __syncthreads();  // buffers and colmax are reused by the next entry
  }
}

template <int KT>
int launch(const void* emb, int n_rows, int doc_cap, const void* epid, const void* elen,
           const void* ecnt, const void* eqidx, const void* n_entries, int E,
           const void* queries, int Q, int G, void* out, cudaStream_t stream) {
  const size_t smem = make_layout(doc_cap, KT * 16, Q, G).total;
  cudaError_t err = cudaFuncSetAttribute(maxsim_dedup_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (E + kEntPerBlock - 1) / kEntPerBlock;
  maxsim_dedup_kernel<KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(emb), n_rows, doc_cap,
      static_cast<const int32_t*>(epid), static_cast<const int32_t*>(elen),
      static_cast<const int32_t*>(ecnt), static_cast<const int32_t*>(eqidx),
      static_cast<const int32_t*>(n_entries), E,
      static_cast<const __nv_bfloat16*>(queries), Q, G, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block needs for this shape (the wrapper checks it).
extern "C" long long fp_maxsim_dedup_smem_bytes(int doc_cap, int D, int Q, int G) {
  return static_cast<long long>(make_layout(doc_cap, D, Q, G).total);
}

// emb: [n_rows, doc_cap, D] bf16; epid, elen, ecnt: [E] int32; eqidx: [E, G] int32
// (query rows of `queries`); n_entries: one int32 on the device; queries:
// [B * Q, D] bf16; out: [E, G] float32. D 128 or 256, Q a multiple of 16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fp_maxsim_dedup(const void* emb, int n_rows, int doc_cap, int D,
                               const void* epid, const void* elen, const void* ecnt,
                               const void* eqidx, const void* n_entries, int E,
                               const void* queries, int Q, int G, void* out, void* stream) {
  if (E == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<8>(emb, n_rows, doc_cap, epid, elen, ecnt, eqidx, n_entries, E, queries,
                     Q, G, out, s);
  if (D == 256)
    return launch<16>(emb, n_rows, doc_cap, epid, elen, ecnt, eqidx, n_entries, E, queries,
                      Q, G, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
