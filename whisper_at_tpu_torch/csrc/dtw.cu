// K6: dynamic time warping of word timing, the cost recurrence and its
// trace, over a batch of cost matrices.
//
// Replaces whisper_at_tpu/ops/dtw_pallas.py::_dtw_device (Pallas, TPU), which
// skews one [N, M] matrix over anti-diagonals and runs each diagonal as one
// vector step with the whole cost and trace in VMEM. Here:
//   * one block per matrix g of a batch x [G, N_max, M] fp32 with its own
//     valid row count n[g], so a batch of windows is one launch;
//   * thread i owns DP row i (N_max + 1 <= 511 rows, one block of at most
//     512 threads); the cost of three anti-diagonals rotates through shared
//     memory, indexed by i, with one __syncthreads() per diagonal;
//   * each thread stages the next CHUNK inputs of its own row into shared
//     memory once every CHUNK diagonals (its row is read left to right, one
//     element per diagonal), so the global loads of a chunk are in flight
//     together and the diagonal loop reads only shared memory;
//   * the trace is written skewed as int8, trace[g, i + j, i], so the stores
//     of one diagonal are contiguous; the host backtrace reads this layout
//     directly. The cost matrix never leaves the chip: no caller reads it.
// Cells: (0, 0) costs 0; every cell on diagonals 0 and 1 has trace -1; a
// border cell (i == 0 or j == 0) on a later diagonal costs +inf and has
// trace 2, as in the TPU kernel; an interior cell takes the cheapest of
// diagonal (i-1, j-1), up (i-1, j), left (i, j-1) under strict <, ties going
// diagonal, then up, then left, and adds x[i-1, j-1]. Cells outside
// [0, n[g]] x [0, M] cost +inf and have trace -1; no valid cell reads them.
// T, the type the costs are summed in, is float or double.
//
// What bounds it on the H100: not the bytes. One matrix of 448 x 1500 fp32
// is 2.7 MB in and 0.9 MB of trace out, about 1 microsecond at 3.35 TB/s,
// and ~5 operations a cell. The floor is the dependency chain: N + M - 1
// diagonal steps, each a shared-memory round trip and a block barrier. The
// design keeps that chain free of global-memory latency; the matrices of a
// batch run side by side on separate SMs.
#include "common.cuh"

namespace {

constexpr int CHUNK = 16;  // inputs of its row a thread stages at a time

template <typename T>
__global__ void dtw_kernel(const float* __restrict__ x, const int* __restrict__ n,
                           int8_t* __restrict__ trace, int N_max, int M, int K, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cost = reinterpret_cast<T*>(smem_raw);                   // [3][W]
  float* xs = reinterpret_cast<float*>(cost + 3 * W);          // [W][CHUNK + 1]

  const int g = blockIdx.x, i = threadIdx.x;
  const int ng = min(n[g], N_max);  // a count past N_max must not read past x
  const float* xrow = x + ((size_t)g * N_max + (i > 0 ? i - 1 : 0)) * M;
  float* stage = xs + i * (CHUNK + 1);
  int8_t* tg = trace + (size_t)g * K * W;
  const T inf = static_cast<T>(INFINITY);

  for (int k = 0; k < K; ++k) {
    if (k % CHUNK == 0 && i >= 1 && i <= ng) {
      for (int c = 0; c < CHUNK; ++c) {
        const int j = k + c - i;  // column of this row on diagonal k + c
        if (j >= 1 && j <= M) stage[c] = xrow[j - 1];
      }
    }
    T* d0 = cost + (k % 3) * W;        // diagonal k
    T* d1 = cost + ((k + 2) % 3) * W;  // diagonal k - 1
    T* d2 = cost + ((k + 1) % 3) * W;  // diagonal k - 2
    if (i < W) {
      const int j = k - i;
      T c = inf;
      int8_t t = -1;
      if (k < 2) {
        if (k == 0 && i == 0) c = static_cast<T>(0);
      } else if (j >= 0 && j <= M && i <= ng) {
        const T c0 = i > 0 ? d2[i - 1] : inf;  // diagonal (i-1, j-1)
        const T c1 = i > 0 ? d1[i - 1] : inf;  // up       (i-1, j)
        const T c2 = d1[i];                    // left     (i, j-1)
        T best;
        if (c0 < c1 && c0 < c2) {
          t = 0;
          best = c0;
        } else if (c1 < c0 && c1 < c2) {
          t = 1;
          best = c1;
        } else {
          t = 2;
          best = c2;
        }
        const T xv = (i == 0 || j == 0) ? inf : static_cast<T>(stage[k % CHUNK]);
        c = xv + best;
      }
      d0[i] = c;
      tg[(size_t)k * W + i] = t;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* x, const void* n, void* trace, int G, int N_max, int M, void* stream) {
  const int W = N_max + 1, K = N_max + M + 1;
  const int threads = (W + 31) / 32 * 32;
  const size_t smem = 3 * W * sizeof(T) + (size_t)W * (CHUNK + 1) * sizeof(float);
  dtw_kernel<T><<<G, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(n),
      static_cast<int8_t*>(trace), N_max, M, K, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [G, N_max, M] fp32; n [G] int32 (counts past N_max act as N_max); trace
// [G, N_max + M + 1, N_max + 1] int8. N_max + 1 <= 512 keeps one block of at
// most 512 threads and its shared memory (3 W sizeof(T) + 68 W bytes) under
// 48 KB. double_acc selects the type the costs are summed in.
extern "C" int dtw_trace(const void* x, const void* n, void* trace, int G, int N_max, int M,
                         int double_acc, void* stream) {
  return double_acc ? launch<double>(x, n, trace, G, N_max, M, stream)
                    : launch<float>(x, n, trace, G, N_max, M, stream);
}
