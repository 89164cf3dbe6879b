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
// [C, Q] bf16 table is a few KB per row and lives in shared memory. What must
// not bound it is run length: real runs are short (at most C slots, an IVF list
// holds a document once per cell), but every row ends in one run of sentinel
// slots that can span most of the row, and a walk from every slot to the end of
// its run would cost O(run^2) there.
//
// Design: each row is cut into chunks of kChunk slots, one warp per chunk, lane l
// owning query tokens q = l, l + 32, .... Two launches:
//   1. summary: each warp takes the per-token max over its chunk's leading run
//      (the slots equal to the chunk's first pid) and notes whether that run
//      fills the whole chunk;
//   2. output: each warp walks its chunk right to left with a per-token running
//      max that resets where the pid changes, after seeding it with the
//      summaries of the following chunks the chunk's last run reaches into.
// Each slot is read a bounded number of times, however long its run; a run
// crossing many chunks costs one summary read per chunk crossed. The output
// equals the plain reference at every slot, not only at heads. Owner indices
// outside [0, C) are clamped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 128;   // slots per warp
constexpr int kMaxQWords = 4; // Q <= 32 * kMaxQWords

// Row b's [C, Q] bf16 table into shared memory.
__device__ __forceinline__ const __nv_bfloat16* stage_table(
    unsigned char* smem_raw, const __nv_bfloat16* table, int b, int C, int Q) {
  __nv_bfloat16* tbl = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const __nv_bfloat16* tb = table + static_cast<int64_t>(b) * C * Q;
  for (int i = threadIdx.x; i < C * Q; i += blockDim.x) tbl[i] = tb[i];
  __syncthreads();
  return tbl;
}

__device__ __forceinline__ void max_row(float (&m)[kMaxQWords], const __nv_bfloat16* tbl,
                                        int32_t own, int C, int Q, int lane) {
  const int o = min(max(static_cast<int>(own), 0), C - 1);
  const __nv_bfloat16* tr = tbl + o * Q;
#pragma unroll
  for (int k = 0; k < kMaxQWords; ++k) {
    const int q = lane + 32 * k;
    if (q < Q) m[k] = fmaxf(m[k], __bfloat162float(tr[q]));
  }
}

// Launch 1: per chunk, the per-token max over its leading run, and whether
// that run covers the whole chunk.
__global__ void __launch_bounds__(kThreads)
estimate_summary_kernel(const int32_t* __restrict__ pid, const int32_t* __restrict__ own,
                        const __nv_bfloat16* __restrict__ table, float* __restrict__ head_max,
                        int32_t* __restrict__ whole, int W, int C, int Q, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  const __nv_bfloat16* tbl = stage_table(smem_raw, table, b, C, Q);
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;
  const int64_t row = static_cast<int64_t>(b) * W;
  const int start = chunk * kChunk;
  const int end = min(start + kChunk, W);
  const int32_t p = pid[row + start];
  float m[kMaxQWords];
#pragma unroll
  for (int k = 0; k < kMaxQWords; ++k) m[k] = -INFINITY;
  int j = start;
  for (; j < end && pid[row + j] == p; ++j) max_row(m, tbl, own[row + j], C, Q, lane);
  float* hm = head_max + (static_cast<int64_t>(b) * n_chunks + chunk) * Q;
#pragma unroll
  for (int k = 0; k < kMaxQWords; ++k) {
    if (lane + 32 * k < Q) hm[lane + 32 * k] = m[k];
  }
  if (lane == 0) whole[static_cast<int64_t>(b) * n_chunks + chunk] = (j == end);
}

// Launch 2: right-to-left running max within each chunk, seeded from the
// summaries of the chunks its last run continues into.
__global__ void __launch_bounds__(kThreads)
estimate_output_kernel(const int32_t* __restrict__ pid, const int32_t* __restrict__ own,
                       const __nv_bfloat16* __restrict__ table,
                       const float* __restrict__ head_max, const int32_t* __restrict__ whole,
                       float* __restrict__ out, int W, int C, int Q, int n_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.y;
  const __nv_bfloat16* tbl = stage_table(smem_raw, table, b, C, Q);
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (chunk >= n_chunks) return;
  const int64_t row = static_cast<int64_t>(b) * W;
  const int start = chunk * kChunk;
  const int end = min(start + kChunk, W);

  float m[kMaxQWords];
#pragma unroll
  for (int k = 0; k < kMaxQWords; ++k) m[k] = -INFINITY;
  int32_t cur = pid[row + end - 1];
  for (int c = chunk + 1; c < n_chunks && pid[row + c * kChunk] == cur; ++c) {
    const float* hm = head_max + (static_cast<int64_t>(b) * n_chunks + c) * Q;
#pragma unroll
    for (int k = 0; k < kMaxQWords; ++k) {
      if (lane + 32 * k < Q) m[k] = fmaxf(m[k], hm[lane + 32 * k]);
    }
    if (!whole[static_cast<int64_t>(b) * n_chunks + c]) break;
  }
  for (int i = end - 1; i >= start; --i) {
    const int32_t p = pid[row + i];
    if (p != cur) {
      cur = p;
#pragma unroll
      for (int k = 0; k < kMaxQWords; ++k) m[k] = -INFINITY;
    }
    max_row(m, tbl, own[row + i], C, Q, lane);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxQWords; ++k) {
      if (lane + 32 * k < Q) s += m[k];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) out[row + i] = s;
  }
}

}  // namespace

extern "C" int fp_segmented_estimate_max_q() { return 32 * kMaxQWords; }

// Float32 scratch the wrapper allocates: head_max [B, n_chunks, Q] followed by
// whole [B, n_chunks] (int32), in 4-byte words.
extern "C" long long fp_segmented_estimate_scratch_words(int B, int W, int Q) {
  const long long n_chunks = (W + kChunk - 1) / kChunk;
  return static_cast<long long>(B) * n_chunks * (Q + 1);
}

// pid, own: [B, W] int32; table: [B, C, Q] bf16; scratch: see above;
// out: [B, W] float32. Returns cudaGetLastError() after the launches.
extern "C" int fp_segmented_estimate(const void* pid, const void* own, const void* table,
                                     void* scratch, void* out, int B, int W, int C, int Q,
                                     void* stream) {
  if (B == 0 || W == 0) return 0;
  const int n_chunks = (W + kChunk - 1) / kChunk;
  const size_t smem = static_cast<size_t>(C) * Q * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(estimate_summary_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(estimate_output_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  float* head_max = static_cast<float*>(scratch);
  int32_t* whole = reinterpret_cast<int32_t*>(head_max + static_cast<int64_t>(B) * n_chunks * Q);
  const dim3 grid((n_chunks + kWarps - 1) / kWarps, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* pid_p = static_cast<const int32_t*>(pid);
  const int32_t* own_p = static_cast<const int32_t*>(own);
  const __nv_bfloat16* tbl_p = static_cast<const __nv_bfloat16*>(table);
  estimate_summary_kernel<<<grid, kThreads, smem, s>>>(pid_p, own_p, tbl_p, head_max, whole, W,
                                                       C, Q, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  estimate_output_kernel<<<grid, kThreads, smem, s>>>(pid_p, own_p, tbl_p, head_max, whole,
                                                      static_cast<float*>(out), W, C, Q,
                                                      n_chunks);
  return static_cast<int>(cudaGetLastError());
}
