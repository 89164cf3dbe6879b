// fastplaid_native: host-side native kernels (C ABI, loaded via ctypes).
//
// The port's own copy of fast_plaid_tpu/native/fastplaid_native.cpp, with
// the same C ABI. The device math lives in PyTorch and the CUDA kernels of
// csrc/; this library owns two host-side data-plane steps:
//   * IVF construction: dedup of (cell, pid) pairs + CSR assembly
//     (index/ivf.py::build_ivf, for builds of at least 1M codes)
//   * the jagged token-window row gather of the low_memory path
//     (search/searcher.py::host_gather_rows, padded, and ::_pack_rows,
//     packed), written straight into the caller's (pinned) buffer
//
// Built at first use by native/__init__.py
// (g++ -O3 -march=native -shared -fPIC -std=c++17 -pthread).
//
// Two changes from the JAX package's copy, both measured on the H100
// machine's host (PERF.md, tools/native_host_bench.py) and both giving the
// same bytes:
//   * fp_build_ivf counts instead of sorting. Documents are scanned in pid
//     order, so within a cell the pids arrive ascending and a repeat of the
//     same (cell, pid) pair is always the cell's last entry: one pass counts
//     each cell's distinct pids, a second scatters them (O(tokens + K), where
//     the sort of (cell, pid) keys was O(tokens log tokens) and lost to
//     numpy's np.unique).
//   * fp_gather_windows_u8 starts one thread per MiB of output, at most
//     FP_MAX_THREADS, and the calling thread works too: a small gather spawns
//     no thread, and callers that gather at once (one thread a shard) do not
//     each start 16.
// Beside them, fp_gather_windows_packed_u8 (no JAX counterpart) writes the
// same windows packed: each one's valid rows at a row the caller gives.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#ifndef FP_MAX_THREADS
#define FP_MAX_THREADS 8
#endif

extern "C" {

// ---------------------------------------------------------------------------
// IVF construction.
//
// codes:        [total_tokens] int32 centroid id per token (document order)
// doc_lengths:  [n_docs] int64 tokens per document (summing to total_tokens)
// Returns the number of unique (cell, pid) pairs, or -1 if a code lies
// outside [0, n_partitions). Two-call protocol: first call with
// ivf_out == nullptr to get the size, then allocate and call again.
// ivf_out:          [n_pairs] int32 pids grouped by cell, pid-ascending
// ivf_lengths_out:  [n_partitions] int64
// ---------------------------------------------------------------------------
int64_t fp_build_ivf(const int32_t* codes, int64_t total_tokens,
                     const int64_t* doc_lengths, int64_t n_docs,
                     int64_t n_partitions, int32_t* ivf_out,
                     int64_t* ivf_lengths_out) {
  const size_t k = static_cast<size_t>(n_partitions);
  std::vector<int64_t> count(k, 0);
  std::vector<int64_t> last(k, -1);  // the last pid entered in each cell
  int64_t t = 0;
  for (int64_t pid = 0; pid < n_docs; ++pid) {
    const int64_t end = std::min(t + std::max<int64_t>(doc_lengths[pid], 0), total_tokens);
    for (; t < end; ++t) {
      const int64_t cell = codes[t];
      if (cell < 0 || cell >= n_partitions) return -1;
      if (last[cell] != pid) {
        last[cell] = pid;
        ++count[cell];
      }
    }
  }
  int64_t n_pairs = 0;
  for (size_t c = 0; c < k; ++c) n_pairs += count[c];
  if (ivf_out == nullptr) return n_pairs;

  std::vector<int64_t> pos(k);
  int64_t offset = 0;
  for (size_t c = 0; c < k; ++c) {
    ivf_lengths_out[c] = count[c];
    pos[c] = offset;
    offset += count[c];
    last[c] = -1;
  }
  t = 0;
  for (int64_t pid = 0; pid < n_docs; ++pid) {
    const int64_t end = std::min(t + std::max<int64_t>(doc_lengths[pid], 0), total_tokens);
    for (; t < end; ++t) {
      const int64_t cell = codes[t];
      if (last[cell] != pid) {
        last[cell] = pid;
        ivf_out[pos[cell]++] = static_cast<int32_t>(pid);
      }
    }
  }
  return n_pairs;
}

// ---------------------------------------------------------------------------
// Jagged row gather (multi-threaded memcpy).
//
// Window w is min(max(lengths[w], 0), doc_cap) rows of row_bytes each from
// src, from its start clamped to [0, n_rows); rows past the end of src are
// zero. One thread per MiB written, at most FP_MAX_THREADS, the caller's
// included.
// indices: [n_windows] int64 start row per window
// lengths: [n_windows] int32 valid rows per window
// out_rows == nullptr: out is [n_windows * doc_cap * row_bytes] bytes, window w
//   at row w * doc_cap, zero-filled to doc_cap rows (the padded layout).
// out_rows != nullptr: [n_windows] int64, window w's rows go to rows
//   [out_rows[w], out_rows[w] + its length) of out and nothing else is
//   written (the packed layout).
// ---------------------------------------------------------------------------
static void gather_windows(const uint8_t* src, int64_t n_rows, int64_t row_bytes,
                           const int64_t* indices, const int32_t* lengths,
                           const int64_t* out_rows, int64_t n_windows,
                           int64_t doc_cap, uint8_t* out) {
  auto valid_of = [&](int64_t w) {
    return std::min<int64_t>(std::max<int32_t>(lengths[w], 0), doc_cap);
  };
  int64_t total = n_windows * doc_cap * row_bytes;
  if (out_rows != nullptr) {
    total = 0;
    for (int64_t w = 0; w < n_windows; ++w) total += valid_of(w) * row_bytes;
  }
  const int hw = std::max(1, static_cast<int>(std::thread::hardware_concurrency()));
  const int n_threads = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>({static_cast<int64_t>(std::min(hw, FP_MAX_THREADS)),
                            total >> 20})));
  std::atomic<int64_t> next{0};
  const int64_t block = std::max<int64_t>(1, n_windows / (n_threads * 8));

  auto worker = [&]() {
    for (;;) {
      const int64_t start = next.fetch_add(block);
      if (start >= n_windows) break;
      const int64_t end = std::min(start + block, n_windows);
      for (int64_t w = start; w < end; ++w) {
        const int64_t base = std::min(std::max<int64_t>(indices[w], 0),
                                      std::max<int64_t>(n_rows - 1, 0));
        const int64_t valid = valid_of(w);
        const int64_t avail = std::max<int64_t>(0, std::min<int64_t>(valid, n_rows - base));
        const int64_t fill = out_rows == nullptr ? doc_cap : valid;
        uint8_t* dst = out + (out_rows == nullptr ? w * doc_cap : out_rows[w]) * row_bytes;
        if (avail > 0) {
          std::memcpy(dst, src + base * row_bytes,
                      static_cast<size_t>(avail * row_bytes));
        }
        if (avail < fill) {
          std::memset(dst + avail * row_bytes, 0,
                      static_cast<size_t>((fill - avail) * row_bytes));
        }
      }
    }
  };

  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(n_threads - 1));
  for (int i = 1; i < n_threads; ++i) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
}

// The padded layout: out [n_windows * doc_cap * row_bytes] bytes.
void fp_gather_windows_u8(const uint8_t* src, int64_t n_rows,
                          int64_t row_bytes, const int64_t* indices,
                          const int32_t* lengths, int64_t n_windows,
                          int64_t doc_cap, uint8_t* out) {
  gather_windows(src, n_rows, row_bytes, indices, lengths, nullptr, n_windows,
                 doc_cap, out);
}

// The packed layout: window w at row out_rows[w] of out, its valid rows only
// (search/searcher.py::_pack_rows copies each distinct document of a pool
// once, back to back).
void fp_gather_windows_packed_u8(const uint8_t* src, int64_t n_rows,
                                 int64_t row_bytes, const int64_t* indices,
                                 const int32_t* lengths, const int64_t* out_rows,
                                 int64_t n_windows, int64_t doc_cap, uint8_t* out) {
  gather_windows(src, n_rows, row_bytes, indices, lengths, out_rows, n_windows,
                 doc_cap, out);
}

}  // extern "C"
