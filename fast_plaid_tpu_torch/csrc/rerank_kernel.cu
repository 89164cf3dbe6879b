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
// What bounds it on the H100: memory. The function needs each distinct
// candidate row once: at the main path's pool (B 256, R 2048, lengths 80..160,
// Q 32, D 128, 57,638 documents) about 1.77 GB, 0.53 ms at 3.35 TB/s, against
// ~515 GFLOP of products, 0.52 ms at 989 TFLOP/s. Read per slot (no reuse
// across query rows) the rows are 16.1 GB, 4.8 ms. The first design (one block
// per 16 candidates, four block barriers and a shared f32 score tile per
// candidate, shared memory growing with doc_cap) took 17.9 ms and refused
// doc_cap above 320.
//
// Design: the streaming core of csrc/maxsim_stream.cuh. Producer warps copy a
// candidate's first len rows, 64 at a time, with one cp.async.bulk per row
// into a 3-4 stage ring per consumer warp (rows padded to 2D + 16 bytes, so
// ldmatrix reads them without bank conflicts); shared memory depends on D and
// Q only, never on doc_cap. Consumer warps run mma.sync m16n8k16 with the A
// fragments from ldmatrix and the query fragments as 32-bit loads from the
// span's shared query block, mask rows past len in registers and keep the max
// per query token across tiles. The tensor cores are not the limit: a tile's
// 128 mma.sync take a few hundred cycles of an SM sub-partition against the
// ~1,100 cycles an SM's share of HBM needs to bring the tile's 16 KB.

#include "maxsim_stream.cuh"

namespace {

using namespace fp_stream;

// Four consumer warps: at D 128 their 3-stage rings fill shared memory.
constexpr int kMaxWarps = 4;

template <int NT>
__global__ void __launch_bounds__(64 * kMaxWarps, 1)
maxsim_gather_kernel(const __nv_bfloat16* __restrict__ emb, int n_rows, int doc_cap, int D,
                     const int32_t* __restrict__ pids, const int32_t* __restrict__ lens,
                     const __nv_bfloat16* __restrict__ queries, int B, int R, int Q,
                     float* __restrict__ out, Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  init_block(smem, L);
  const int warp = threadIdx.x >> 5;
  auto rows_of = [=](int pid, int len, long long* doc) -> int {
    *doc = pid;
    if (pid < 0 || pid >= n_rows) return 0;
    return min(max(len, 0), doc_cap);
  };
  if (warp >= L.warps) {
    const Source src{reinterpret_cast<const unsigned char*>(emb), doc_cap, D * 2};
    produce(smem, L, warp - L.warps, src, pids, lens, queries, B, R, Q, D, rows_of);
  } else {
    auto tile = [&](const unsigned char* A, const unsigned char* qs, int t0, int rows, int,
                    float (*mx)[2]) {
      bf16_tile<NT>(A, qs, L.q_stride, L.a_stride, D, t0, rows, mx);
    };
    auto finish = [](long long, float s) { return s; };
    consume<NT>(smem, L, warp, pids, lens, B, R, Q, out, rows_of, tile, finish);
  }
}

bool layout_for(int D, int Q, Layout* L) {
  return choose_layout(Q, 2 * D + 16, 2 * D + 16, kMaxWarps, L);
}

template <int NT>
int launch(const void* emb, int n_rows, int doc_cap, int D, const void* pids, const void* lens,
           const void* queries, int B, int R, int Q, void* out, cudaStream_t stream,
           const Layout& L) {
  auto kernel = maxsim_gather_kernel<NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int span = kSpanPerWarp * L.warps;
  const int n_spans = B * ((R + span - 1) / span);
  int status = 0;
  const int grid = grid_size(kernel, 64 * L.warps, L.total, n_spans, &status);
  if (status != 0) return status;
  kernel<<<grid, 64 * L.warps, L.total, stream>>>(
      static_cast<const __nv_bfloat16*>(emb), n_rows, doc_cap, D,
      static_cast<const int32_t*>(pids), static_cast<const int32_t*>(lens),
      static_cast<const __nv_bfloat16*>(queries), B, R, Q, static_cast<float*>(out), L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block uses for D and Q (<= 64), or -1 if no plan
// fits. It does not depend on doc_cap.
extern "C" long long fp_maxsim_gather_smem_bytes(int D, int Q) {
  Layout L;
  return layout_for(D, Q, &L) ? static_cast<long long>(L.total) : -1;
}

// emb: [n_rows, doc_cap, D] bf16; pids, lens: [B, R] int32; queries: [B, Q, D]
// bf16 with 1 <= Q <= 64; out: [B, R] float32. D a multiple of 16, pointers
// 16-byte aligned. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fp_maxsim_gather(const void* emb, int n_rows, int doc_cap, int D,
                                const void* pids, const void* lens, const void* queries,
                                int B, int R, int Q, void* out, void* stream) {
  if (B == 0 || R == 0) return 0;
  Layout L;
  if (Q < 1 || Q > kMaxQ || D % 16 || !layout_for(D, Q, &L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tiles_for(Q)) {
    case 1: return launch<1>(emb, n_rows, doc_cap, D, pids, lens, queries, B, R, Q, out, s, L);
    case 2: return launch<2>(emb, n_rows, doc_cap, D, pids, lens, queries, B, R, Q, out, s, L);
    case 4: return launch<4>(emb, n_rows, doc_cap, D, pids, lens, queries, B, R, Q, out, s, L);
    default: return launch<8>(emb, n_rows, doc_cap, D, pids, lens, queries, B, R, Q, out, s, L);
  }
}
