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
// What bounds it on the H100: memory. A candidate needs min(len, caph) packed
// rows of D bytes, a quarter of its bf16 rows. At the main path's pool (B 256,
// R 2048, lengths 80..160, caph 80, Q 32, D 128, 57,638 documents) each
// distinct packed row once is ~0.59 GB (0.18 ms at 3.35 TB/s) against ~515
// GFLOP (0.52 ms at 989 TFLOP/s), so the products set the bound; read per slot
// the packed rows are 5.37 GB (1.6 ms). The first design (one block per 16
// candidates, the packed rows dequantized into a bf16 tile in shared memory,
// five block barriers a candidate, shared memory growing with doc_cap) took
// 12.7 ms and refused doc_cap above about 400.
//
// Design: the streaming core of csrc/maxsim_stream.cuh with packed tiles: the
// producer copies a candidate's first min(len, caph) packed rows, 64 at a
// time, into padded rows of D + 16 bytes. Each packed tile feeds two products
// into the same running max (order does not matter to a max): the low nibbles
// give tokens t0 + i (valid where t0 + i < len), the high nibbles tokens
// t0 + i + caph (valid where t0 + i + caph < len; skipped when no row is).
// Consumers dequantize in registers straight into the mma.sync A fragments:
// a 32-bit load of 4 packed bytes, then per bf16 pair one shift, one
// mask-and-or (0x4300 | n is the bf16 value 128 + n) and one bf16x2 fma that
// subtracts 136, giving n - 8 exactly. The k order inside each 16-wide step
// is permuted (bytes 4t, 4t+2 feed k slots 2t, 2t+1 and bytes 4t+1, 4t+3
// slots 2t+8, 2t+9); the wrapper hands the queries permuted the same way
// within each group of 4 dimensions (0, 2, 1, 3), so a query fragment is one
// 64-bit load. No bf16 tile is written to shared memory. Eight consumer
// warps (two an SM sub-partition) hide the load -> dequantize -> mma
// latency. The per-document scale multiplies the sum in the epilogue.

#include "maxsim_stream.cuh"

namespace {

using namespace fp_stream;

// Eight consumer warps (two an SM sub-partition, to hide the dequantize ->
// mma latency) in 2-stage rings of packed tiles; 512 threads leave 128
// registers a thread, so each pass holds at most 32 accumulators.
constexpr int kMaxWarps = 8;

// bf16 pair of nibbles `shift` and `shift + 16` of w, each minus 8: one
// shift, one mask-and-or (0x4300 | n is the bf16 value 128 + n), one fma.
__device__ __forceinline__ uint32_t levels(uint32_t w, int shift) {
  const uint32_t v = ((w >> shift) & 0x000F000Fu) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;  // 1 * (128 + n) - 136
}

// Fold one packed [64, D] tile (packed rows t0.., tokens t0.. and t0 + caph..)
// into the running maxima of the NT * 8 query columns.
template <int NT>
__device__ __forceinline__ void q4_tile(const unsigned char* A, const unsigned char* qs,
                                        const Layout& L, int D, int caph, int t0, int rows,
                                        int n_tok, float (*mx)[2]) {
  constexpr int MS = NT <= 2 ? 4 : NT == 4 ? 2 : 1;  // m16 slices per pass
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int KT = D / 16;
#pragma unroll
  for (int plane = 0; plane < 2; ++plane) {
    const int lim = plane == 0 ? rows - t0 : n_tok - caph - t0;  // valid rows of the plane
    const int shift = 4 * plane;
#pragma unroll
    for (int mp = 0; mp < 4 / MS; ++mp) {
      if (mp * MS * 16 >= lim) break;
      float acc[MS][NT][4];
#pragma unroll
      for (int m = 0; m < MS; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll 2
      for (int kb = 0; kb < KT; ++kb) {
        uint2 bq[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          bq[j] = *reinterpret_cast<const uint2*>(qs + (j * 8 + g) * L.q_stride + kb * 32 + t * 8);
        }
#pragma unroll
        for (int m = 0; m < MS; ++m) {
          const int m16 = (mp * MS + m) * 16;
          if (m16 < lim) {
            const unsigned char* ar = A + (m16 + g) * L.a_stride + kb * 16 + t * 4;
            const uint32_t w0 = *reinterpret_cast<const uint32_t*>(ar) >> shift;
            const uint32_t w1 = *reinterpret_cast<const uint32_t*>(ar + 8 * L.a_stride) >> shift;
            // Bytes 4t..4t+3 give k slots (2t, 2t+1) = bytes (0, 2) and
            // (2t+8, 2t+9) = bytes (1, 3); the queries come permuted to match.
            const uint32_t a[4] = {levels(w0, 0), levels(w1, 0), levels(w0, 8), levels(w1, 8)};
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_bf16(acc[m][j], a, bq[j].x, bq[j].y);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MS; ++m) fold_max<NT>(mx, acc[m], (mp * MS + m) * 16 + g, lim);
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(64 * kMaxWarps, 1)
maxsim_q4_gather_kernel(const uint8_t* __restrict__ emb_q4, const float* __restrict__ scale,
                        int n_docs, int caph, int D, const int32_t* __restrict__ pids,
                        const int32_t* __restrict__ lens,
                        const __nv_bfloat16* __restrict__ queries, int B, int R, int Q,
                        float* __restrict__ out, Layout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  init_block(smem, L);
  const int warp = threadIdx.x >> 5;
  auto rows_of = [=](int pid, int len, long long* doc) -> int {
    *doc = min(max(pid, 0), n_docs - 1);
    return min(max(len, 0), caph);
  };
  if (warp >= L.warps) {
    const Source src{emb_q4, caph, D};
    produce(smem, L, warp - L.warps, src, pids, lens, queries, B, R, Q, D, rows_of);
  } else {
    auto tile = [&](const unsigned char* A, const unsigned char* qs, int t0, int rows, int len,
                    float (*mx)[2]) {
      q4_tile<NT>(A, qs, L, D, caph, t0, rows, min(len, 2 * caph), mx);
    };
    auto finish = [=](long long doc, float s) { return s * scale[doc]; };
    consume<NT>(smem, L, warp, pids, lens, B, R, Q, out, rows_of, tile, finish);
  }
}

bool layout_for(int D, int Q, Layout* L) {
  return choose_layout(Q, 2 * D + 32, D + 16, kMaxWarps, L);
}

template <int NT>
int launch(const void* emb_q4, const void* scale, int n_docs, int caph, int D, const void* pids,
           const void* lens, const void* queries, int B, int R, int Q, void* out,
           cudaStream_t stream, const Layout& L) {
  auto kernel = maxsim_q4_gather_kernel<NT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int span = kSpanPerWarp * L.warps;
  const int n_spans = B * ((R + span - 1) / span);
  int status = 0;
  const int grid = grid_size(kernel, 64 * L.warps, L.total, n_spans, &status);
  if (status != 0) return status;
  kernel<<<grid, 64 * L.warps, L.total, stream>>>(
      static_cast<const uint8_t*>(emb_q4), static_cast<const float*>(scale), n_docs, caph, D,
      static_cast<const int32_t*>(pids), static_cast<const int32_t*>(lens),
      static_cast<const __nv_bfloat16*>(queries), B, R, Q, static_cast<float*>(out), L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block uses for D and Q (<= 64), or -1 if no plan
// fits. It does not depend on doc_cap.
extern "C" long long fp_maxsim_q4_gather_smem_bytes(int D, int Q) {
  Layout L;
  return layout_for(D, Q, &L) ? static_cast<long long>(L.total) : -1;
}

// emb_q4: [n_docs * caph, D] uint8; scale: [n_docs] float32; pids, lens: [B, R]
// int32; queries: [B, Q, D] bf16 with 1 <= Q <= 64, each group of 4
// dimensions in the order (0, 2, 1, 3); out: [B, R] float32. D a
// multiple of 16, pointers 16-byte aligned. Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int fp_maxsim_q4_gather(const void* emb_q4, const void* scale, int n_docs,
                                   int caph, int D, const void* pids, const void* lens,
                                   const void* queries, int B, int R, int Q, void* out,
                                   void* stream) {
  if (B == 0 || R == 0) return 0;
  Layout L;
  if (Q < 1 || Q > kMaxQ || D % 16 || caph < 1 || !layout_for(D, Q, &L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tiles_for(Q)) {
    case 1:
      return launch<1>(emb_q4, scale, n_docs, caph, D, pids, lens, queries, B, R, Q, out, s, L);
    case 2:
      return launch<2>(emb_q4, scale, n_docs, caph, D, pids, lens, queries, B, R, Q, out, s, L);
    case 4:
      return launch<4>(emb_q4, scale, n_docs, caph, D, pids, lens, queries, B, R, Q, out, s, L);
    default:
      return launch<8>(emb_q4, scale, n_docs, caph, D, pids, lens, queries, B, R, Q, out, s, L);
  }
}
