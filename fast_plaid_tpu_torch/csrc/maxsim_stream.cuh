// The streaming core shared by the rerank kernels (csrc/rerank_kernel.cu over
// the bf16 corpus cache, csrc/q4_rerank_kernel.cu over the 4-bit token-pair
// cache, and, for its barriers, copies and bf16 tile, csrc/rerank_dedup_kernel.cu;
// its TMA and wgmma helpers at the end serve the dedup kernel and
// csrc/probe_kernel.cu):
// a candidate's rows stream through shared memory in fixed tiles of kTile rows,
// so shared memory does not depend on doc_cap, and each candidate's MaxSim
// stays in registers.
//
// Block: W consumer warps (warps 0..W-1) and W producer warps (W..2W-1).
// Producer warp W + c feeds consumer warp c only, through c's own ring of S
// stages (one full/empty mbarrier pair per stage); its 32 lanes issue one
// cp.async.bulk per row (rows are contiguous in the cache, and a row copy
// lands in a padded row so the consumer's fragment loads are bank-conflict
// free), and only the rows below the candidate's length are copied. The
// persistent grid walks spans of 32 * W candidates of one query row in
// query-row-major order; candidate l * W + c of a span belongs to pair c.
// The query row's [Q, D] bf16 block sits in one of two shared buffers (its
// own full/empty pair, loaded by producer warp W), so it changes once a span.
//
// A consumer warp computes [64, D] x [D, Q] on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulators in registers), masks rows past
// the length to -inf in registers and folds them into a running max per query
// token; at the candidate's end a few shuffles give the max over rows and the
// sum over query tokens, and lane 0 stores one float. No score tile goes to
// shared memory and no candidate costs a block-wide barrier.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace fp_stream {

constexpr int kTile = 64;             // rows of one ring stage
constexpr int kSpanPerWarp = 32;      // candidates of a span per consumer warp
constexpr int kMaxQ = 64;             // query tokens per launch (wrappers chunk)
constexpr int kMaxSmem = 232448;      // dynamic shared memory a block may use

// Shared-memory plan of one block. Every offset is in bytes.
struct Layout {
  int warps;        // consumer warps W (as many producer warps)
  int stages;       // ring stages per consumer warp
  int q_rows;       // rows of a query buffer (Q rounded up to the n-tiles)
  int q_stride;     // bytes per query-buffer row
  int a_stride;     // bytes per ring row
  int q_bytes;      // bytes of one query buffer
  int stage_bytes;  // bytes of one ring stage
  int q_off, ring_off, bar_off, total;
};

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// n-tiles of 8 query tokens the kernel is instantiated for.
__host__ __device__ inline int n_tiles_for(int q) {
  return q <= 8 ? 1 : q <= 16 ? 2 : q <= 32 ? 4 : 8;
}

inline Layout make_layout(int warps, int stages, int q, int q_stride, int a_stride) {
  Layout l;
  l.warps = warps;
  l.stages = stages;
  l.q_rows = 8 * n_tiles_for(q);
  l.q_stride = q_stride;
  l.a_stride = a_stride;
  l.q_bytes = align128(l.q_rows * q_stride);
  l.stage_bytes = align128(kTile * a_stride);
  l.q_off = 0;
  l.ring_off = 2 * l.q_bytes;
  l.bar_off = l.ring_off + warps * stages * l.stage_bytes;
  l.total = l.bar_off + (2 * warps * stages + 4) * 8;
  return l;
}

// The widest (warps, stages) plan with at most `max_warps` consumer warps
// that fits one block's shared memory; the plan depends on D and Q only.
// Returns false when none fits.
inline bool choose_layout(int q, int q_stride, int a_stride, int max_warps, Layout* out) {
  static const int kPlans[][2] = {{8, 3}, {8, 2}, {4, 4}, {4, 3}, {4, 2},
                                  {2, 4}, {2, 3}, {2, 2}, {1, 2}};
  for (const auto& p : kPlans) {
    if (p[0] > max_warps) continue;
    const Layout l = make_layout(p[0], p[1], q, q_stride, a_stride);
    if (l.total <= kMaxSmem) {
      *out = l;
      return true;
    }
  }
  return false;
}

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One contiguous global -> shared copy, completing on `bar` by bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(ptr)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- the pipeline -----------------------------------------------------------

// Where a candidate's rows come from: document `doc` owns rows
// [doc * doc_rows, doc * doc_rows + rows) of a [*, row_bytes] array.
struct Source {
  const unsigned char* base;
  long long doc_rows;
  int row_bytes;
};

struct Barriers {
  uint64_t* full;   // [W * S]
  uint64_t* empty;  // [W * S]
  uint64_t* qfull;  // [2]
  uint64_t* qempty; // [2]
};

__device__ __forceinline__ Barriers barriers(unsigned char* smem, const Layout& L) {
  uint64_t* b = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  const int n = L.warps * L.stages;
  return {b, b + n, b + 2 * n, b + 2 * n + 2};
}

// Zero the query buffers (rows past Q stay zero), then set up the barriers.
// Every thread of the block calls this once.
__device__ __forceinline__ void init_block(unsigned char* smem, const Layout& L) {
  uint4* q = reinterpret_cast<uint4*>(smem + L.q_off);
  for (int i = threadIdx.x; i < 2 * L.q_bytes / 16; i += blockDim.x) q[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    const Barriers br = barriers(smem, L);
    for (int i = 0; i < L.warps * L.stages; ++i) {
      bar_init(&br.full[i], 1);
      bar_init(&br.empty[i], 1);
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(&br.qfull[i], 1);
      bar_init(&br.qempty[i], L.warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The persistent walk: span s covers query row s / per_row and candidates
// [(s % per_row) * span, + span).
struct Walk {
  int R, span, per_row, n_spans;
  __device__ __forceinline__ Walk(int B, int R_, int W) : R(R_), span(kSpanPerWarp * W) {
    per_row = (R + span - 1) / span;
    n_spans = B * per_row;
  }
};

// Producer warp for consumer warp c. `rows_of(pid, len, &doc)` gives the rows
// the candidate needs (0 for an empty one) and the document to read.
template <typename RowsOf>
__device__ __forceinline__ void produce(unsigned char* smem, const Layout& L, int c,
                                        const Source& src, const int32_t* __restrict__ pids,
                                        const int32_t* __restrict__ lens,
                                        const __nv_bfloat16* __restrict__ queries, int B,
                                        int R, int Q, int D, RowsOf rows_of) {
  const int lane = threadIdx.x & 31;
  const Barriers br = barriers(smem, L);
  const Walk wk(B, R, L.warps);
  const int S = L.stages;
  unsigned char* ring = smem + L.ring_off + c * S * L.stage_bytes;
  int kt = 0;  // tiles produced for this consumer so far
  int it = 0;
  for (int s = blockIdx.x; s < wk.n_spans; s += gridDim.x, ++it) {
    const int b = s / wk.per_row;
    const int r0 = (s % wk.per_row) * wk.span;
    if (c == 0) {  // the span's query block, for every consumer
      const int qb = it & 1;
      if (lane == 0) {
        bar_wait(&br.qempty[qb], ((it >> 1) & 1) ^ 1);
        bar_arrive_tx(&br.qfull[qb], static_cast<uint32_t>(Q) * D * 2);
      }
      __syncwarp();
      unsigned char* qdst = smem + L.q_off + qb * L.q_bytes;
      for (int row = lane; row < Q; row += 32) {
        bulk_copy(qdst + row * L.q_stride, queries + (static_cast<long long>(b) * Q + row) * D,
                  D * 2, &br.qfull[qb]);
      }
    }
    const int idx = r0 + lane * L.warps + c;
    int pid = 0, len = 0;
    if (idx < R) {
      pid = pids[static_cast<long long>(b) * R + idx];
      len = lens[static_cast<long long>(b) * R + idx];
    }
    for (int l = 0; l < 32; ++l) {
      long long doc;
      const int rows = rows_of(__shfl_sync(0xffffffffu, pid, l), __shfl_sync(0xffffffffu, len, l),
                               &doc);
      for (int t0 = 0; t0 < rows; t0 += kTile, ++kt) {
        const int st = kt % S;
        const int n = min(kTile, rows - t0);
        if (lane == 0) {
          bar_wait(&br.empty[c * S + st], ((kt / S) & 1) ^ 1);
          bar_arrive_tx(&br.full[c * S + st], static_cast<uint32_t>(n) * src.row_bytes);
        }
        __syncwarp();
        unsigned char* dst = ring + st * L.stage_bytes;
        const unsigned char* from =
            src.base + (doc * src.doc_rows + t0) * static_cast<long long>(src.row_bytes);
        for (int r = lane; r < n; r += 32) {
          bulk_copy(dst + r * L.a_stride, from + static_cast<long long>(r) * src.row_bytes,
                    src.row_bytes, &br.full[c * S + st]);
        }
      }
    }
  }
}

// Running max of column pair (2t, 2t + 1) of each n-tile over the rows a
// thread holds, one accumulator tile at a time: c0, c1 sit on row `row0`,
// c2, c3 on row0 + 8; a row at or past `lim` is masked.
template <int NT>
__device__ __forceinline__ void fold_max(float (*mx)[2], const float (*acc)[4], int row0,
                                         int lim) {
  const bool v0 = row0 < lim, v1 = row0 + 8 < lim;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx[j][0] = fmaxf(mx[j][0], v0 ? acc[j][0] : -INFINITY);
    mx[j][1] = fmaxf(mx[j][1], v0 ? acc[j][1] : -INFINITY);
    mx[j][0] = fmaxf(mx[j][0], v1 ? acc[j][2] : -INFINITY);
    mx[j][1] = fmaxf(mx[j][1], v1 ? acc[j][3] : -INFINITY);
  }
}

// Max over the warp's rows of every query token, then the sum over the first
// Q tokens; the result is valid in every lane.
template <int NT>
__device__ __forceinline__ float column_max_sum(float (*mx)[2], int Q) {
  const int t = threadIdx.x & 3;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = mx[j][h];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      if (j * 8 + 2 * t + h < Q) s += v;
    }
  }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s;
}

// Fold one [64, D] bf16 row tile (rows t0.., the first `rows - t0` valid, at
// `a_stride` bytes a row) against a [NT * 8, D] bf16 query block (rows at
// `q_stride` bytes) into the running maxima of the NT * 8 query columns.
// Used by the bf16 per-query kernel and the dedup kernel.
template <int NT>
__device__ __forceinline__ void bf16_tile(const unsigned char* A, const unsigned char* qs,
                                          int q_stride, int a_stride, int D, int t0, int rows,
                                          float (*mx)[2]) {
  constexpr int MS = NT <= 4 ? 4 : 2;  // m16 slices per pass (accumulator registers)
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lim = rows - t0;  // valid rows of this tile
  const int KT = D / 16;
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
      uint32_t bq[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned char* qrow = qs + (j * 8 + g) * q_stride + kb * 32 + t * 4;
        bq[j][0] = *reinterpret_cast<const uint32_t*>(qrow);
        bq[j][1] = *reinterpret_cast<const uint32_t*>(qrow + 16);
      }
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        const int m16 = (mp * MS + m) * 16;
        if (m16 < lim) {
          uint32_t a[4];
          ldmatrix_x4(a, A + (m16 + (lane & 15)) * a_stride + kb * 32 + (lane >> 4) * 16);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_bf16(acc[m][j], a, bq[j][0], bq[j][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MS; ++m) fold_max<NT>(mx, acc[m], (mp * MS + m) * 16 + g, lim);
  }
}

// Consumer warp c: for every candidate of its spans, `tile(stage, query
// buffer, tile start, rows, len, mx)` folds each tile into the running
// maxima; `finish(doc, sum)` gives the stored value. `rows_of` must be the
// producer's. An empty candidate (no rows) stores -inf.
template <int NT, typename RowsOf, typename Tile, typename Finish>
__device__ __forceinline__ void consume(unsigned char* smem, const Layout& L, int c,
                                        const int32_t* __restrict__ pids,
                                        const int32_t* __restrict__ lens, int B, int R, int Q,
                                        float* __restrict__ out, RowsOf rows_of, Tile tile,
                                        Finish finish) {
  const int lane = threadIdx.x & 31;
  const Barriers br = barriers(smem, L);
  const Walk wk(B, R, L.warps);
  const int S = L.stages;
  const unsigned char* ring = smem + L.ring_off + c * S * L.stage_bytes;
  int kt = 0;
  int it = 0;
  for (int s = blockIdx.x; s < wk.n_spans; s += gridDim.x, ++it) {
    const int b = s / wk.per_row;
    const int r0 = (s % wk.per_row) * wk.span;
    const int qb = it & 1;
    bar_wait(&br.qfull[qb], (it >> 1) & 1);
    const unsigned char* qs = smem + L.q_off + qb * L.q_bytes;
    const int idx = r0 + lane * L.warps + c;
    int pid = 0, len = 0;
    if (idx < R) {
      pid = pids[static_cast<long long>(b) * R + idx];
      len = lens[static_cast<long long>(b) * R + idx];
    }
    for (int l = 0; l < 32; ++l) {
      const int r = r0 + l * L.warps + c;
      if (r >= R) break;
      const int p = __shfl_sync(0xffffffffu, pid, l);
      const int n_len = __shfl_sync(0xffffffffu, len, l);
      long long doc;
      const int rows = rows_of(p, n_len, &doc);
      float total = -INFINITY;
      if (rows > 0) {
        float mx[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) mx[j][0] = mx[j][1] = -INFINITY;
        for (int t0 = 0; t0 < rows; t0 += kTile, ++kt) {
          const int st = kt % S;
          bar_wait(&br.full[c * S + st], (kt / S) & 1);
          tile(ring + st * L.stage_bytes, qs, t0, rows, n_len, mx);
          __syncwarp();
          if (lane == 0) bar_arrive(&br.empty[c * S + st]);
        }
        total = finish(doc, column_max_sum<NT>(mx, Q));
      }
      if (lane == 0) out[static_cast<long long>(b) * R + r] = total;
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&br.qempty[qb]);
  }
}

// ---- TMA and wgmma (the dedup and probe kernels) ----------------------------

constexpr int kSwz = 64;  // bf16 columns of one 128-byte swizzle span

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int col, int row,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// Descriptor of a K-major operand in 128-byte swizzle: rows of 128 bytes,
// 8-row atoms 1024 bytes apart; a k16 step within the span adds 32 bytes.
__device__ __forceinline__ uint64_t swz_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// d (64 f32 a thread) = (scale_d ? d : 0) + A x B^T over k16: A [64, 16] and
// B [128, 16], both K-major in shared memory behind 128-byte-swizzle descriptors.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Pin the accumulators at this point of the program: the compiler does not
// know that wgmma writes them asynchronously, so reads stay after the wait.
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A 2D [rows, cols] bf16 tensor map with [box_rows, 64] boxes, 128-byte swizzle.
inline bool make_map(CUtensorMap* m, const void* base, long long rows, int cols, int box_rows) {
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(kSwz), static_cast<cuuint32_t>(box_rows)};
  cuuint32_t elem[2] = {1, 1};
  return cuTensorMapEncodeTiled(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Blocks of a persistent grid: one per unit of work (span, entry), at most
// what fits on the card at `threads` threads and `smem` bytes a block.
template <typename Kernel>
inline int grid_size(Kernel kernel, int threads, int smem, int n_work, int* err) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  *err = static_cast<int>(e);
  if (e != cudaSuccess) return 0;
  return std::max(1, std::min(n_work, sms * std::max(per_sm, 1)));
}

}  // namespace fp_stream
