// Stages 1-2 of the search cascade in one kernel: the IVF probe, each
// query-token row's k best centroid cells, straight from the bf16 products.
//
// Replaces no Pallas kernel. The JAX package scores query tokens against the
// centroids with an XLA dot and takes `approx_max_k`
// (fast_plaid_tpu/search/engine.py). The port's plain version
// (ops/probe_kernel.py: probe_table + torch.topk) writes a [N, Kp] float32
// table (1.07 GB at N 8,192, Kp 32,768), casts it to bf16, masks it into a
// second table and runs torch.topk over that: 5.7 ms a call on an H100, on
// every search. This kernel writes no table.
//
// Contract, the plain version's: score[n, c] = bf16(sum_d bf16(q[n, d]) *
// cent[c, d]) with float32 sums (cent is bf16 already); columns c >= k_real
// are excluded; a row whose float32 query is all zeros has no cell; each
// row's k best come out descending, ties to the lower cell, which is the set
// torch.topk keeps (the wrapper then orders exact ties as torch.topk does).
// A slot with no cell (an all-zero row, or k > k_real) holds -inf and the
// cell Kp.
//
// What bounds it on the H100: operations. N x k_real x D x 2 = 68.7 GFLOP at
// N 8,192, k_real 32,768, D 128: 0.069 ms at 989 TFLOP/s (bf16), against 4 MB
// of float32 queries and 8 MB of bf16 centroids (0.004 ms at 3.35 TB/s).
//
// Design: a block owns 128 query rows (two consumer warpgroups of 64) and one
// of S splits of the centroid axis, S chosen so that the blocks fill the SMs
// once. The consumers round the block's float32 rows to bf16 into
// 128-byte-swizzled shared memory once, taking each row's nonzero flag from
// the same load; a producer warp streams [128, D] bf16 centroid tiles by TMA
// through a ring of mbarrier stages. Each consumer warpgroup runs wgmma
// m64n128k16 into float32 registers, which leaves each thread two rows x 32
// columns of the tile. Per row a thread keeps its running top-K as 32-bit
// keys, the bf16 score's order-preserving bits above the negated column
// within the split, so one unsigned compare orders by score and then by the
// lower cell. A value goes on only where its bf16 reaches the k-th best of
// the row's quad (the 4 threads that share it): one float compare a value
// makes a mask, and one short loop over its bits, rarely long once a few
// tiles are in, inserts. The loop's body appears once: an epilogue unrolled
// over the 64 values ran at 0.49-0.61 ms on an H100, whatever its test, and
// this one at 0.23, against 0.10 for the wgmma pipeline alone. A row with no
// query takes no values (its zero scores would all tie the threshold). At
// the split's end the quad merges its four lists by shuffles and writes
// 64-bit keys; a second small kernel merges the S lists of each row and
// writes the k best.

#include "maxsim_stream.cuh"

namespace {

using namespace fp_stream;

constexpr int kWgs = 2;                      // consumer warpgroups of a block
constexpr int kRowsPerBlock = kWgs * 64;     // query rows of a block
constexpr int kCols = 128;                   // centroids of a tile (wgmma N)
constexpr int kAHalf = 64 * 128;             // [64 rows, 64 columns] bf16
constexpr int kBHalf = kCols * 128;          // [128 rows, 64 columns] bf16
constexpr int kMaxSpan = 65536;              // columns of a split: 16 bits of key
constexpr int kMaxSplits = 64;
constexpr int kMaxK = 32;
constexpr int kThreads = 32 * (4 * kWgs + 1);

using u64 = unsigned long long;

// Shared-memory plan of one block, in bytes from a 1024-byte aligned base.
struct PLayout {
  int kh;           // 64-column halves of a row: ceil(D / 64)
  int stages;       // ring stages
  int stage_bytes;  // kh [128, 64] centroid halves
  int ring_off;     // after the query area, kWgs * kh [64, 64] halves
  int ok_off;       // kRowsPerBlock int flags: the row's query is not all zero
  int bar_off;
  int total;
};

bool make_playout(int D, PLayout* out) {
  if (D < 16 || D > 4 * kSwz || D % 16) return false;
  PLayout l;
  l.kh = (D + kSwz - 1) / kSwz;
  l.stage_bytes = l.kh * kBHalf;
  l.ring_off = kWgs * l.kh * kAHalf;
  for (int s = 6; s >= 2; --s) {
    l.stages = s;
    l.ok_off = l.ring_off + s * l.stage_bytes;
    l.bar_off = l.ok_off + kRowsPerBlock * 4;
    l.total = l.bar_off + 2 * s * 8 + 1024;  // + alignment slack
    if (l.total <= kMaxSmem) {
      *out = l;
      return true;
    }
  }
  return false;
}

// The launch: S splits of `span` columns each (a whole number of tiles, at
// most kMaxSpan), and a top-K list of K >= k entries (8, 16 or 32).
struct Plan {
  int splits, span, K;
  PLayout L;
};

bool make_plan(int N, int D, int k_real, int k, Plan* p) {
  if (N < 1 || k_real < 1 || k < 1 || k > kMaxK || !make_playout(D, &p->L)) return false;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return false;
  }
  const int row_blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  const int tiles = (k_real + kCols - 1) / kCols;
  int s = std::max(1, std::min(sms / row_blocks, kMaxSplits));
  s = std::min(std::max(s, (k_real + kMaxSpan - 1) / kMaxSpan), tiles);
  const int per = (tiles + s - 1) / s;  // every split gets at least one tile
  p->splits = (tiles + per - 1) / per;
  p->span = per * kCols;
  p->K = k <= 8 ? 8 : k <= 16 ? 16 : 32;
  return p->span <= kMaxSpan;
}

// Order-preserving 16 bits of bf16(v), rounded to nearest even; -0 ranks as
// +0, as a float compare has it.
__device__ __forceinline__ uint32_t bf16_ord(float v) {
  uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  if (b == 0x8000u) b = 0;
  return b ^ ((b & 0x8000u) ? 0xFFFFu : 0x8000u);
}

// bf16(lo) in the low half, bf16(hi) in the high half, rounded to nearest even.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

__device__ __forceinline__ uint16_t ord_bf16(uint32_t o) {
  return static_cast<uint16_t>((o & 0x8000u) ? (o & 0x7FFFu) : (~o & 0xFFFFu));
}

// x into the descending list (x > list[K - 1]); the last entry drops out.
template <int K, typename T>
__device__ __forceinline__ void insert(T (&list)[K], T x) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const T hi = list[j] > x ? list[j] : x;
    x = list[j] > x ? x : list[j];
    list[j] = hi;
  }
}

// The four lists of a quad (lanes 4i..4i+3, one row) merged into each lane:
// for two descending lists a and b, max(a[j], b[K-1-j]) holds the top K of
// both as a bitonic sequence, which the half-cleaners sort descending.
template <int K>
__device__ __forceinline__ void quad_merge(uint32_t (&list)[K]) {
#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    uint32_t other[K];
#pragma unroll
    for (int j = 0; j < K; ++j) other[j] = __shfl_xor_sync(0xffffffffu, list[j], d);
#pragma unroll
    for (int j = 0; j < K; ++j) list[j] = max(list[j], other[K - 1 - j]);
#pragma unroll
    for (int s = K / 2; s >= 1; s >>= 1) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if ((j & s) == 0) {
          const uint32_t hi = max(list[j], list[j + s]);
          list[j + s] = min(list[j], list[j + s]);
          list[j] = hi;
        }
      }
    }
  }
}

// The float32 just below every value whose bf16 has order bits >= thr: the
// bf16 before it (-inf where thr admits everything; +0's predecessor is the
// negative denormal nearest zero, -0 having no order bits of its own).
__device__ __forceinline__ float below(uint32_t thr) {
  if (thr <= 0x80u) return -INFINITY;
  const uint32_t prev = thr - 1 == 0x7FFFu ? 0x7FFEu : thr - 1;
  return __uint_as_float(static_cast<uint32_t>(ord_bf16(prev)) << 16);
}

// Row h's value m (0..31) of an accumulator tile: acc[4 (m / 2) + 2 h + m % 2],
// the tile's column 8 (m / 2) + 2 qd + m % 2, picked by a tree of selects so
// that the caller's loop over the values that pass stays one short body.
__device__ __forceinline__ float pick(const float* acc, int h, int m) {
  float a[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    a[i] = (m & 16) ? acc[4 * ((i + 16) >> 1) + 2 * h + (i & 1)]
                    : acc[4 * (i >> 1) + 2 * h + (i & 1)];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = (m & 8) ? a[i + 8] : a[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = (m & 4) ? a[i + 4] : a[i];
  a[0] = (m & 2) ? a[2] : a[0];
  a[1] = (m & 2) ? a[3] : a[1];
  return (m & 1) ? a[1] : a[0];
}

// One accumulator tile into the thread's two row lists; `base` is the tile's
// first column within the split, valid[h] the thread's values of row h that
// lie before the split's end (none for a row with no query: its zeros would
// all tie). A value goes on only if its bf16 reaches the quad's k-th
// best: one float compare a value builds the mask of those, and the loop
// over its bits, short and rarely long once a few tiles are in, builds the
// keys and inserts them.
template <int K>
__device__ __forceinline__ void fold_tile(const float* acc, uint32_t (&top)[2][K],
                                          const uint32_t (&thr)[2], int base,
                                          const uint32_t (&valid)[2], int qd) {
  const uint32_t col_key = 0xFFFFu - static_cast<uint32_t>(base + 2 * qd);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lo = below(thr[h]);
    uint32_t mask = 0;
#pragma unroll
    for (int m = 0; m < 32; ++m) {
      mask |= acc[4 * (m >> 1) + 2 * h + (m & 1)] > lo ? 1u << m : 0u;
    }
    mask &= valid[h];
    while (mask) {
      const int m = __ffs(mask) - 1;
      mask &= mask - 1;
      const uint32_t key =
          (bf16_ord(pick(acc, h, m)) << 16) | (col_key - (8 * (m >> 1) + (m & 1)));
      if (key > top[h][K - 1] && (key >> 16) >= thr[h]) insert(top[h], key);
    }
  }
}

// The thread's values (bit m: column 8 (m / 2) + 2 qd + m % 2) below lim.
__device__ __forceinline__ uint32_t valid_mask(int lim, int qd) {
  if (lim >= kCols) return 0xFFFFFFFFu;
  uint32_t v = 0;
  for (int m = 0; m < 32; ++m) v |= 8 * (m >> 1) + 2 * qd + (m & 1) < lim ? 1u << m : 0u;
  return v;
}

template <int K>
__global__ void __launch_bounds__(kThreads, 1)
probe_topk_kernel(const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ q, int N,
                  int D, int k_real, int span, int splits, u64* __restrict__ part, PLayout L) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  uint64_t* empty = full + L.stages;
  int* ok = reinterpret_cast<int*>(smem + L.ok_off);
  unsigned char* ring = smem + L.ring_off;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x % splits;
  const int row0 = (blockIdx.x / splits) * kRowsPerBlock;
  const int col0 = split * span;
  const int n_cols = min(span, k_real - col0);
  const int n_tiles = (n_cols + kCols - 1) / kCols;
  const int S = L.stages;
  if (threadIdx.x < kRowsPerBlock) ok[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], 4 * kWgs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWgs) {  // producer
    if (lane == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % S;
        unsigned char* dst = ring + st * L.stage_bytes;
        bar_wait(&empty[st], ((t / S) & 1) ^ 1);
        bar_arrive_tx(&full[st], L.stage_bytes);
        for (int h = 0; h < L.kh; ++h) {
          tma_load_2d(dst + h * kBHalf, &tm_c, h * kSwz, col0 + t * kCols, &full[st]);
        }
      }
    }
    return;
  }

  // The block's query rows, float32 -> bf16, as kWgs [64, kh * 64] A operands
  // (128-byte swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8)); the
  // columns past D and the rows past N are zero, so every k16 step counts.
  const int chunks = L.kh * 8;  // 16-byte chunks (8 bf16) of an A row
  for (int i = threadIdx.x; i < kRowsPerBlock * chunks; i += 32 * 4 * kWgs) {
    const int r = i / chunks, c = i % chunks;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (row0 + r < N && c * 8 < D) {
      const float4* src =
          reinterpret_cast<const float4*>(q + static_cast<long long>(row0 + r) * D + c * 8);
      a = src[0];
      b = src[1];
      if (a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f || b.x != 0.f || b.y != 0.f ||
          b.z != 0.f || b.w != 0.f) {
        ok[r] = 1;
      }
    }
    const int wr = r & 63, h = c >> 3;
    unsigned char* dst = smem + ((r >> 6) * L.kh + h) * kAHalf + wr * 128 +
                         (((c & 7) ^ (wr & 7)) * 16);
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w),
                                                pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync 1, %0;\n" ::"r"(32 * 4 * kWgs) : "memory");

  const int wg = warp >> 2, w4 = warp & 3, g = lane >> 2, qd = lane & 3;
  const int r_lo = wg * 64 + w4 * 16 + g;  // the block rows of the thread: r_lo, r_lo + 8
  const bool live[2] = {ok[r_lo] != 0, ok[r_lo + 8] != 0};
  const unsigned char* a_op = smem + wg * L.kh * kAHalf;
  uint32_t top[2][K];
#pragma unroll
  for (int j = 0; j < K; ++j) top[0][j] = top[1][j] = 0;
  uint32_t thr[2] = {0, 0};
  float acc[64];
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % S;
    bar_wait(&full[st], (t / S) & 1);
    const unsigned char* b_op = ring + st * L.stage_bytes;
    __syncwarp();
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    for (int h = 0; h < L.kh; ++h) {  // 64-column halves, four k16 steps each
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_m64n128k16(acc, swz_desc(a_op + h * kAHalf + k * 32),
                         swz_desc(b_op + h * kBHalf + k * 32), h > 0 || k > 0);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);
    const int base = t * kCols;
    const uint32_t vm = valid_mask(n_cols - base, qd);
    const uint32_t valid[2] = {live[0] ? vm : 0u, live[1] ? vm : 0u};
    fold_tile<K>(acc, top, thr, base, valid, qd);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the quad's k-th best so far
      uint32_t u = top[h][K - 1] >> 16;
      u = max(u, __shfl_xor_sync(0xffffffffu, u, 1));
      u = max(u, __shfl_xor_sync(0xffffffffu, u, 2));
      thr[h] = u;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) quad_merge<K>(top[h]);
  if (qd == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_lo + 8 * h;
      if (row0 + r >= N) continue;
      u64* dst = part + (static_cast<long long>(split) * N + row0 + r) * K;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const uint32_t key = top[h][j];
        const uint32_t col = static_cast<uint32_t>(col0) + 0xFFFFu - (key & 0xFFFFu);
        dst[j] = (live[h] && key) ? (static_cast<u64>(key >> 16) << 32) | (0xFFFFFFFFu - col) : 0ull;
      }
    }
  }
}

// Row n's S lists (64-bit keys: score bits above the negated cell, 0 for
// none) into its k best: bf16 scores and int32 cells, -inf and kp for none.
template <int K>
__global__ void probe_merge_kernel(const u64* __restrict__ part, int N, int splits, int k, int kp,
                                   uint16_t* __restrict__ scores, int32_t* __restrict__ cells) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  u64 top[K];
#pragma unroll
  for (int j = 0; j < K; ++j) top[j] = 0;
  for (int s = 0; s < splits; ++s) {
    const u64* src = part + (static_cast<long long>(s) * N + row) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const u64 x = src[j];
      if (x <= top[K - 1]) break;  // a split's list descends
      insert(top, x);
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {
      const u64 x = top[j];
      const long long o = static_cast<long long>(row) * k + j;
      scores[o] = x ? ord_bf16(static_cast<uint32_t>(x >> 32)) : uint16_t(0xFF80);  // -inf
      cells[o] = x ? static_cast<int32_t>(0xFFFFFFFFu - static_cast<uint32_t>(x)) : kp;
    }
  }
}

template <int K>
int launch(const CUtensorMap& tm, const void* q, int N, int D, int kp, int k_real, int k,
           const Plan& p, void* scratch, void* scores, void* cells, cudaStream_t stream) {
  auto kernel = probe_topk_kernel<K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (N + kRowsPerBlock - 1) / kRowsPerBlock;
  kernel<<<row_blocks * p.splits, kThreads, p.L.total, stream>>>(
      tm, static_cast<const float*>(q), N, D, k_real, p.span, p.splits,
      static_cast<u64*>(scratch), p.L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_merge_kernel<K><<<(N + 127) / 128, 128, 0, stream>>>(
      static_cast<const u64*>(scratch), N, p.splits, k, kp, static_cast<uint16_t*>(scores),
      static_cast<int32_t*>(cells));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the scratch `fp_probe_topk` needs for N rows, width D, k_real
// columns and k, on the current device; -1 where the kernel does not take the
// shape (D a multiple of 16 in [16, 256], 1 <= k <= 32).
extern "C" long long fp_probe_scratch_bytes(int N, int D, int k_real, int k) {
  Plan p;
  if (!make_plan(N, D, k_real, k, &p)) return -1;
  return static_cast<long long>(p.splits) * N * p.K * 8;
}

// queries: [N, D] float32; centroids: [Kp, D] bf16, k_real <= Kp columns
// probed; scratch: fp_probe_scratch_bytes bytes; scores: [N, k] bf16 and
// cells: [N, k] int32, written. Pointers 16-byte aligned. Returns a CUDA
// error code (0 on success).
extern "C" int fp_probe_topk(const void* queries, int N, int D, const void* centroids, int Kp,
                             int k_real, int k, void* scratch, void* scores, void* cells,
                             void* stream) {
  Plan p;
  if (k_real > Kp || !make_plan(N, D, k_real, k, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tm;
  if (!make_map(&tm, centroids, Kp, D, kCols)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.K) {
    case 8: return launch<8>(tm, queries, N, D, Kp, k_real, k, p, scratch, scores, cells, s);
    case 16: return launch<16>(tm, queries, N, D, Kp, k_real, k, p, scratch, scores, cells, s);
    default: return launch<32>(tm, queries, N, D, Kp, k_real, k, p, scratch, scores, cells, s);
  }
}
