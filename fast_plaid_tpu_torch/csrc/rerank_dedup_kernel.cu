// Deduplicated fused rerank: one read of each candidate row per (document,
// group of at most G requesting queries), over the bf16 corpus cache (stage 6).
//
// Replaces: fast_plaid_tpu/ops/rerank_dedup.py:_dedup_kernel (Pallas, TPU),
// wrapper maxsim_gather_scores_dedup. ops/rerank_dedup.py sorts the [B, R]
// rerank pool by pid (`order`: sorted position -> flat slot b * R + r) and cuts
// each pid's run of requesters into entries of at most G; entry e spans sorted
// positions [bounds[e], bounds[e + 1]). For each requester slot s of entry e
// (its query row s / R), with the entry's document and length those of its
// first slot:
//
//   out[s] = sum_q max_{t < len} <emb[pid, t, :], queries[s / R, q, :]>
//
// bf16 inputs, float32 accumulation; -inf where the entry's length is 0 or
// the slot's own length is <= 0. pids are clamped to [0, n_rows), as the JAX
// wrapper clamps its entry pids. Slots are written straight into the [B, R]
// output: no [E, G] score table and no gather back. The Pallas kernel sums over
// Q with a 0/1 matmul and clamps -inf at -1e30 (TPU workarounds); here each
// requester's sum is a short loop over its Q column maxima.
//
// What bounds it on the H100: the tensor cores. At the main path's pool (B 256,
// R 2048, Q 32, D 128, lengths 80..160 over 57,640 rows) the function is ~515
// GFLOP, 0.52 ms at 989 TFLOP/s, against 1.77 GB of distinct rows, 0.53 ms at
// 3.35 TB/s; the requesters' query blocks add one 8 KB block per slot (4.3 GB
// a tile, from L2). mma.sync does not reach that rate here: a streaming
// mma.sync design (a requester a warp, a cp.async.bulk per row) ran at ~170
// TFLOP/s at best on an H100, bound by instruction throughput and latency.
//
// Design: warpgroup MMA fed by TMA. A block holds one producer warp and one or
// two consumer warpgroups; a persistent grid walks the live entries (their
// count read on the device) with a stride of the grid, so the entries of one
// popular pid run at the same time on neighbouring blocks and its rows come
// from L2 after the first read. For an entry the producer loads, with one TMA
// copy per 64-column half and 128-byte swizzle, each requester's [Q, D] query
// block into a query area ([rows = requesters x Q rounded to 8, D], up to 128
// rows per warpgroup; double-buffered where it fits) and then the entry's
// first len rows as [64, D] tiles into a ring of stages (OOB rows zero-filled,
// rows past len masked). A D that is not a multiple of 64 takes ceil(D / 64)
// halves, the last one partly past the tensor's columns: TMA fills those
// columns with zeros in the query area and in every row tile alike, and their
// products add exact zeros to the float32 sums. Each consumer warpgroup runs
// wgmma m64n128k16 over the tile against its 128 query columns (4 requesters
// at Q 32), keeps the length-masked running max in registers, and at the
// entry's end takes the max over the four warps' rows through a small shared
// scratch and sums each requester's Q columns. Past D 384 the query area
// does not fit a block, and the pass's query rows stream with each row tile
// instead, 128 columns at a time (`WIDE`). Shared memory depends on D and Q
// only, never on doc_cap; entries with more requesters than a pass takes run
// several passes over their rows. Q above 64 runs in chunks whose scores
// the wrapper adds.

#include "maxsim_stream.cuh"

namespace {

using namespace fp_stream;

constexpr int kWgCols = 128;   // query columns of a consumer warpgroup (wgmma N)
constexpr int kMaxWgs = 2;
constexpr int kHalfBytes = kTile * 128;  // one [64 rows, 64 columns] bf16 tile

// Shared-memory plan of one block. Every offset is in bytes from a 1024-byte
// aligned base (the swizzle pattern follows address bits). Where the whole
// [rows, D] query area fits (D up to 384), it is loaded once per pass and a
// stage holds one [64, D] row tile; past that ("wide"), a stage holds a chunk
// of `kh` 64-column halves of the row tile and of the pass's query rows.
struct DLayout {
  int wgs;          // consumer warpgroups
  int stages;       // ring stages
  int q_bufs;       // query areas (0 when wide)
  int wide;         // queries stream with the row tiles, chunk by chunk
  int kh;           // 64-column halves a stage holds
  int chunks;       // stages per row tile (halves / kh)
  int qp;           // query columns a requester takes (Q rounded up to 8)
  int per_wg;       // requesters a warpgroup scores in one pass (kWgCols / qp)
  int halves;       // ceil(D / 64)
  int a_bytes;      // the row part of a stage: kh [64, 64] halves
  int stage_bytes;  // a_bytes, plus the query chunk when wide
  int q_half;       // one 64-column half of query rows: wgs * 128 rows * 128 B
  int q_bytes;      // one query area (0 when wide)
  int ring_off, scr_off, bar_off, total;
};

DLayout make_dlayout(int wgs, int stages, int q_bufs, int wide, int q, int D) {
  DLayout l;
  l.wgs = wgs;
  l.stages = stages;
  l.q_bufs = wide ? 0 : q_bufs;
  l.wide = wide;
  l.qp = (q + 7) / 8 * 8;
  l.per_wg = kWgCols / l.qp;
  l.halves = (D + kSwz - 1) / kSwz;
  l.kh = wide ? (l.halves % 2 ? 1 : 2) : l.halves;
  l.chunks = l.halves / l.kh;
  l.q_half = wgs * kWgCols * 128;
  l.a_bytes = l.kh * kHalfBytes;
  l.stage_bytes = l.a_bytes + (wide ? l.kh * l.q_half : 0);
  l.q_bytes = wide ? 0 : l.halves * l.q_half;
  l.ring_off = l.q_bufs * l.q_bytes;
  l.scr_off = l.ring_off + stages * l.stage_bytes;
  l.bar_off = l.scr_off + wgs * 5 * kWgCols * 4;
  l.total = l.bar_off + (2 * stages + 2 * l.q_bufs) * 8 + 1024;  // + alignment slack
  return l;
}

// The widest plan that fits one block; it depends on D and Q only.
bool choose_dlayout(int q, int D, DLayout* out) {
  static const int kPlans[][4] = {  // (warpgroups, stages, query areas, wide)
      {2, 5, 2, 0}, {2, 4, 2, 0}, {2, 3, 2, 0}, {2, 2, 2, 0}, {2, 4, 1, 0}, {2, 3, 1, 0},
      {2, 2, 1, 0}, {1, 4, 2, 0}, {1, 3, 2, 0}, {1, 2, 2, 0}, {1, 3, 1, 0}, {1, 2, 1, 0},
      {2, 3, 0, 1}, {2, 2, 0, 1}, {1, 3, 0, 1}, {1, 2, 0, 1}};
  if (q < 1 || q > kMaxQ || D < 16 || D % 16) return false;
  for (const auto& p : kPlans) {
    const DLayout l = make_dlayout(p[0], p[1], p[2], p[3], q, D);
    if (l.total <= kMaxSmem && (l.wide || l.halves <= 6)) {
      *out = l;
      return true;
    }
  }
  return false;
}

__device__ __forceinline__ void wg_bar(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(128) : "memory");
}

// acc (+)= A x B^T over KH 64-column halves: A at `a` ([64 rows, 64] halves
// kHalfBytes apart), B at `b` ([128 rows, 64] halves `b_half` apart). One
// wgmma group, waited for: a second group in flight (two accumulator sets,
// ping-pong) ran slower on an H100, register-bound at 9 warps a block.
template <int KH>
__device__ __forceinline__ void wgmma_halves(float* acc, const unsigned char* a,
                                             const unsigned char* b, int b_half,
                                             bool accumulate) {
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < 4 * KH; ++k) {
    wgmma_m64n128k16(acc, swz_desc(a + (k >> 2) * kHalfBytes + (k & 3) * 32),
                     swz_desc(b + (k >> 2) * b_half + (k & 3) * 32), accumulate || k > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
}

struct Entry {
  int start, cnt, rows, doc;
};

// Entry e's sorted span, its document (clamped) and the rows it needs.
__device__ __forceinline__ Entry entry_at(int e, const int32_t* __restrict__ bounds,
                                          const int32_t* __restrict__ order,
                                          const int32_t* __restrict__ pids,
                                          const int32_t* __restrict__ lens, int n_rows,
                                          int doc_cap) {
  Entry en;
  en.start = bounds[e];
  en.cnt = bounds[e + 1] - en.start;
  const int s0 = order[en.start];
  en.doc = min(max(static_cast<int>(pids[s0]), 0), n_rows - 1);
  en.rows = min(max(static_cast<int>(lens[s0]), 0), doc_cap);
  return en;
}

// Every warp walks the block's entries in batches of 32: lane l loads the
// metadata of the batch's l-th entry, and `body` gets them one at a time.
template <typename Body>
__device__ __forceinline__ void walk_entries(int n_ent, const int32_t* __restrict__ bounds,
                                             const int32_t* __restrict__ order,
                                             const int32_t* __restrict__ pids,
                                             const int32_t* __restrict__ lens, int n_rows,
                                             int doc_cap, Body body) {
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x;
  for (int eb = blockIdx.x; eb < n_ent; eb += 32 * stride) {
    const int e = eb + lane * stride;
    Entry my{0, 0, 0, 0};
    if (e < n_ent) my = entry_at(e, bounds, order, pids, lens, n_rows, doc_cap);
    const int n_here = min(32, (n_ent - eb + stride - 1) / stride);
    for (int l = 0; l < n_here; ++l) {
      Entry en;
      en.start = __shfl_sync(0xffffffffu, my.start, l);
      en.cnt = __shfl_sync(0xffffffffu, my.cnt, l);
      en.rows = __shfl_sync(0xffffffffu, my.rows, l);
      en.doc = __shfl_sync(0xffffffffu, my.doc, l);
      body(en);
    }
  }
}

// KH: 64-column halves a stage holds; WIDE: queries stream with the stages.
template <int KH, bool WIDE>
__global__ void __launch_bounds__(32 * (4 * kMaxWgs + 1), 1)
maxsim_dedup_kernel(const __grid_constant__ CUtensorMap tm_emb,
                    const __grid_constant__ CUtensorMap tm_q, int n_rows, int doc_cap,
                    const int32_t* __restrict__ pids, const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ order, const int32_t* __restrict__ bounds,
                    const int32_t* __restrict__ n_entries, int E, int R, int Q,
                    float* __restrict__ out, DLayout L) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const int S = L.stages, QB = L.q_bufs;
  const int per_pass = L.wgs * L.per_wg;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + S;
  uint64_t* qfull = empty + S;
  uint64_t* qempty = qfull + QB;
  float* scr = reinterpret_cast<float*>(smem + L.scr_off);
  unsigned char* ring = smem + L.ring_off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_cons_warps = 4 * L.wgs;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], n_cons_warps);
    }
    for (int i = 0; i < QB; ++i) {
      bar_init(&qfull[i], 1);
      bar_init(&qempty[i], n_cons_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_ent = min(*n_entries, E);
  const int chunks = WIDE ? L.chunks : 1;
  const uint32_t q_tx = static_cast<uint32_t>(Q) * 128;  // one [Q, 64] query half
  int kt = 0;  // ring stages so far
  int it = 0;  // passes so far (query areas)

  if (warp == n_cons_warps) {  // producer
    walk_entries(n_ent, bounds, order, pids, lens, n_rows, doc_cap, [&](const Entry& en) {
      const int row0 = en.doc * doc_cap;
      for (int p0 = 0; p0 < en.cnt; p0 += per_pass) {
        const int nreq = min(per_pass, en.cnt - p0);
        const int b = lane < nreq ? order[en.start + p0 + lane] / R : 0;
        // Where requester `lane`'s query rows go within a query half.
        const int q_row = (lane / L.per_wg) * kWgCols + (lane % L.per_wg) * L.qp;
        if (!WIDE) {
          const int qb = it % QB;
          if (lane == 0) {
            bar_wait(&qempty[qb], ((it / QB) & 1) ^ 1);
            bar_arrive_tx(&qfull[qb], en.rows > 0 ? nreq * L.halves * q_tx : 0);
          }
          __syncwarp();
          if (en.rows > 0 && lane < nreq) {
            unsigned char* qa = smem + qb * L.q_bytes + q_row * 128;
            for (int h = 0; h < L.halves; ++h) {
              tma_load_2d(qa + h * L.q_half, &tm_q, h * kSwz, b * Q, &qfull[qb]);
            }
          }
          ++it;
        }
        for (int t0 = 0; t0 < en.rows; t0 += kTile) {
          for (int c = 0; c < chunks; ++c, ++kt) {
            const int st = kt % S;
            unsigned char* dst = ring + st * L.stage_bytes;
            if (lane == 0) {
              bar_wait(&empty[st], ((kt / S) & 1) ^ 1);
              bar_arrive_tx(&full[st], L.a_bytes + (WIDE ? nreq * KH * q_tx : 0));
              for (int h = 0; h < KH; ++h) {
                tma_load_2d(dst + h * kHalfBytes, &tm_emb, (c * KH + h) * kSwz, row0 + t0,
                            &full[st]);
              }
            }
            __syncwarp();
            if (WIDE && lane < nreq) {
              for (int h = 0; h < KH; ++h) {
                tma_load_2d(dst + L.a_bytes + h * L.q_half + q_row * 128, &tm_q,
                            (c * KH + h) * kSwz, b * Q, &full[st]);
              }
            }
          }
        }
      }
    });
  } else {  // consumer warpgroup wg, warp w4 of it
    const int wg = warp >> 2, w4 = warp & 3, tw = threadIdx.x & 127;
    const int g = lane >> 2;
    walk_entries(n_ent, bounds, order, pids, lens, n_rows, doc_cap, [&](const Entry& en) {
      for (int p0 = 0; p0 < en.cnt; p0 += per_pass) {
        const int r0 = p0 + wg * L.per_wg;  // this warpgroup's first requester
        const bool mine = r0 < en.cnt;
        const bool active = mine && en.rows > 0;
        const int r = r0 + tw;
        const bool own = mine && tw < L.per_wg && r < en.cnt;
        const int slot = own ? order[en.start + r] : 0;
        const int slot_len = own ? lens[slot] : 0;
        const int qb = WIDE ? 0 : it % QB;
        if (!WIDE) bar_wait(&qfull[qb], (it / QB) & 1);
        const unsigned char* qa = smem + qb * L.q_bytes + wg * kWgCols * 128;
        float mx[16][2];
#pragma unroll
        for (int j = 0; j < 16; ++j) mx[j][0] = mx[j][1] = -INFINITY;
        for (int t0 = 0; t0 < en.rows; t0 += kTile) {
          float acc[64];
          for (int c = 0; c < chunks; ++c, ++kt) {
            const int st = kt % S;
            bar_wait(&full[st], (kt / S) & 1);
            if (active) {
              const unsigned char* a = ring + st * L.stage_bytes;
              const unsigned char* bq = WIDE ? a + L.a_bytes + wg * kWgCols * 128 : qa;
              wgmma_halves<KH>(acc, a, bq, L.q_half, c > 0);
            }
            __syncwarp();
            if (lane == 0) bar_arrive(&empty[st]);
          }
          if (active) {
            fold_max<16>(mx, reinterpret_cast<const float(*)[4]>(acc), w4 * 16 + g,
                         en.rows - t0);
          }
        }
        if (!WIDE) {
          __syncwarp();
          if (lane == 0) bar_arrive(&qempty[qb]);
          ++it;
        }
        if (active) {
          // Max over this warp's 16 rows, then over the warpgroup's 4 warps,
          // then each requester's sum over its Q columns.
          float* sw = scr + wg * 5 * kWgCols;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v = mx[j][h];
              v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
              v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
              v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
              if (g == 0) sw[w4 * kWgCols + j * 8 + 2 * lane + h] = v;
            }
          }
          wg_bar(1 + wg);
          sw[4 * kWgCols + tw] = fmaxf(fmaxf(sw[tw], sw[kWgCols + tw]),
                                       fmaxf(sw[2 * kWgCols + tw], sw[3 * kWgCols + tw]));
          wg_bar(1 + wg);
          if (own) {
            const float* cm = sw + 4 * kWgCols + tw * L.qp;
            float s = 0.f;
#pragma unroll 8
            for (int c = 0; c < Q; ++c) s += cm[c];
            out[slot] = slot_len > 0 ? s : -INFINITY;
          }
        } else if (own) {
          out[slot] = -INFINITY;  // an empty entry
        }
      }
    });
  }
}

template <int KH, bool WIDE>
int launch(const CUtensorMap& tm_emb, const CUtensorMap& tm_q, int n_rows, int doc_cap,
           const void* pids, const void* lens, const void* order, const void* bounds,
           const void* n_entries, int E, int R, int Q, void* out, cudaStream_t stream,
           const DLayout& L) {
  auto kernel = maxsim_dedup_kernel<KH, WIDE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 32 * (4 * L.wgs + 1);
  int status = 0;
  const int grid = grid_size(kernel, threads, L.total, E, &status);
  if (status != 0) return status;
  kernel<<<grid, threads, L.total, stream>>>(
      tm_emb, tm_q, n_rows, doc_cap, static_cast<const int32_t*>(pids),
      static_cast<const int32_t*>(lens), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(bounds), static_cast<const int32_t*>(n_entries), E, R, Q,
      static_cast<float*>(out), L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one block uses for D and Q (<= 64), or -1 if no plan
// fits (D must be a multiple of 16; any such D has one). It does not depend
// on doc_cap.
extern "C" long long fp_maxsim_dedup_smem_bytes(int D, int Q) {
  DLayout L;
  return choose_dlayout(Q, D, &L) ? static_cast<long long>(L.total) : -1;
}

// emb: [n_rows, doc_cap, D] bf16 with n_rows * doc_cap < 2^31; pids, lens: [n]
// int32 (the flat [B, R] pool); order: [n] int32, the pool's slots sorted by
// pid; bounds: [E + 1] int32 entry spans over `order`; n_entries: one int32 on
// the device (<= E); queries: [B * Q, D] bf16 with 1 <= Q <= 64; out: [n]
// float32, written at every slot of a live entry. D a multiple of 16, pointers
// 16-byte aligned. Returns a CUDA error code (0 on success).
extern "C" int fp_maxsim_dedup(const void* emb, int n_rows, int doc_cap, int D, const void* pids,
                               const void* lens, const void* order, const void* bounds,
                               const void* n_entries, int E, int B, int R, const void* queries,
                               int Q, void* out, void* stream) {
  if (E == 0) return 0;
  DLayout L;
  if (n_rows < 1 || doc_cap < 1 || !choose_dlayout(Q, D, &L)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm_emb, tm_q;
  if (!make_map(&tm_emb, emb, static_cast<long long>(n_rows) * doc_cap, D, kTile) ||
      !make_map(&tm_q, queries, static_cast<long long>(B) * Q, D, Q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L.wide) {
    return L.kh == 2 ? launch<2, true>(tm_emb, tm_q, n_rows, doc_cap, pids, lens, order, bounds,
                                       n_entries, E, R, Q, out, s, L)
                     : launch<1, true>(tm_emb, tm_q, n_rows, doc_cap, pids, lens, order, bounds,
                                       n_entries, E, R, Q, out, s, L);
  }
  switch (L.kh) {
#define FP_DEDUP_CASE(K)                                                                      \
  case K:                                                                                    \
    return launch<K, false>(tm_emb, tm_q, n_rows, doc_cap, pids, lens, order, bounds, n_entries, \
                            E, R, Q, out, s, L);
    FP_DEDUP_CASE(1)
    FP_DEDUP_CASE(2)
    FP_DEDUP_CASE(3)
    FP_DEDUP_CASE(4)
    FP_DEDUP_CASE(5)
    FP_DEDUP_CASE(6)
#undef FP_DEDUP_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
