// K6: dynamic time warping of word timing, the cost recurrence and its
// trace, over a batch of cost matrices.
//
// Replaces whisper_at_tpu/ops/dtw_pallas.py::_dtw_device (Pallas, TPU), which
// skews one [N, M] matrix over anti-diagonals and runs each diagonal as one
// vector step with the whole cost and trace in VMEM.
//
// Cells: (0, 0) costs 0; every cell on diagonals 0 and 1 has trace -1; a
// border cell (i == 0 or j == 0) on a later diagonal costs +inf and has
// trace 2, as in the TPU kernel; an interior cell takes the cheapest of
// diagonal (i-1, j-1), up (i-1, j), left (i, j-1) under strict <, ties going
// diagonal, then up, then left, and adds x[i-1, j-1]. Cells outside
// [0, n[g]] x [0, M] cost +inf and have trace -1; no valid cell reads them.
// T, the type the costs are summed in, is float or double. The trace is
// written skewed as int8, trace[g, i + j, i]; the host backtrace reads this
// layout directly. The cost matrix never leaves the chip: no caller reads it.
//
// What bounds it on the H100: not the bytes. One matrix of 448 x 1500 fp32
// is 2.7 MB in and 0.9 MB of trace out, about 1 microsecond at 3.35 TB/s.
// The recurrence is serial: N + M - 1 dependent steps, each one add and a
// three-way compare-select in T, plus a shuffle where the step crosses
// rows. That chain is the floor (chip_smoke.py measures one step's latency
// and prints it beside the byte bound).
//
// Design: DP rows on lanes, costs in registers; one block per matrix g of a
// batch x [G, N_max, M] fp32 with its own valid row count n[g] (more than
// eight warps' rows: two blocks of a cluster, eight warps or fewer each).
//  - Lane l of warp w owns DP row i = 32 w + l. At the warp's step s it
//    computes column j = s - l, so the 32 trace bytes of a warp's step lie
//    side by side (diagonal k = 32 w + s). The up neighbour (i-1, j) is lane
//    l-1's cost of the step before (one __shfl_up_sync, two for double), the
//    diagonal (i-1, j-1) is the up value the lane received a step earlier,
//    the left (i, j-1) its own previous cost. No block barrier runs per step.
//  - Warps are chained, not barriered: lane 31 of warp w writes its costs
//    into a ring of RING columns in warp w + 1's shared memory and arrives
//    on an mbarrier every H = 16 steps; warp w + 1 waits on it (try_wait,
//    which suspends instead of spinning) before it reads a hand-over, and
//    publishes what it has read in a count that keeps warp w from
//    overwriting an unread column. Warp w + 1 runs about H + 32 steps
//    behind warp w. Across the two blocks of a cluster the same goes through
//    distributed shared memory at cluster scope. Warps whose rows are all
//    past n[g] only write their trace rows' -1.
//  - The inputs are staged ahead of use: each warp's 32 rows of x come in
//    TMA boxes of 32 columns, D tiles ahead of the wave, into a ring of D + 2
//    tiles [32 rows][32 columns] with an mbarrier each; lane l reads
//    (l, s - l - 1), whose bank is (s - l - 1) mod 32, distinct across the
//    warp. A block of 32 steps loads its inputs first, converted and set to
//    +inf outside the valid cells, and stores its trace bytes after its last
//    step.
//  - The three compares are strict and in the order above, so ties and NaNs
//    go as in the plain version (no min() of two neighbours first).
//  - Nothing splits a warp between its shuffles: the choice is by selects,
//    the stores are predicated instructions, and every condition that holds
//    for a whole warp comes from a vote. Where the compiler cannot see the
//    warp whole it guards each shuffle with a costly collective sequence.
// Tried on the way, each slower or no faster on an NVIDIA H100 80GB HBM3 at
// 700 W: branches for the choice and around the stores; 4-byte cp.async
// tile loads by every lane (TMA boxes took them off the lanes); spinning on
// a shared counter for each hand-over (it held up the other warps' shuffles);
// a block of 16 warps with 128 registers a thread for over 8 warps' rows
// (about as fast as the cluster of two); the choice in explicit predicate
// logic; the next block's loads and the previous block's trace stores spread
// over the steps. One row a lane: with R rows a lane the steps shrink to
// M + N / R but each step's chain grows by R - 1 compare-select-adds, a loss
// where M >> N. Hand-overs of 8 and of 32 steps (float64, tools/time_k6_k9.py
// while the length was a launch argument): 0.1398-0.1407 and 0.1328-0.1329 ms
// at [6, 97, 1500], 0.2917-0.2925 and 0.2551-0.2566 ms at [1, 448, 1500],
// against 0.1314-0.1324 and 0.2538-0.2547 ms with H = 16.
#include "hopper.cuh"

namespace {

constexpr int RING = 128;   // columns of a warp's hand-over ring
constexpr int H = 16;       // steps between a warp's hand-overs to the next
constexpr int TILE = 1024;  // floats of a staged tile: 32 rows x 32 columns
constexpr unsigned FULL = 0xffffffffu;
static_assert(RING % H == 0 && 32 % H == 0, "a block of 32 steps is whole hand-overs");

// Between the warps of a matrix, which may lie in two blocks of a cluster:
// a warp's hand-overs are written into its consumer's block, its
// back-pressure count into its producer's. Within a block they take
// shared-memory operations of block scope; across the two blocks,
// shared::cluster addresses (map_rank) and cluster scope, which cost more,
// so each warp takes the cross-block forms only where its neighbour lies in
// the other block (CROSS).
template <bool CROSS>
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  if constexpr (CROSS)
    asm volatile("ld.acquire.cluster.shared::cta.b32 %0, [%1];\n"
                 : "=r"(v)
                 : "r"(smem_u32(p))
                 : "memory");
  else
    asm volatile("ld.acquire.cta.shared::cta.b32 %0, [%1];\n"
                 : "=r"(v)
                 : "r"(smem_u32(p))
                 : "memory");
  return v;
}

// the count at `addr` (a cluster address where CROSS) = v with release
// semantics where pred holds, as a predicated instruction (no branch: see
// store_pred)
template <bool CROSS>
__device__ __forceinline__ void st_release(uint32_t addr, int v, bool pred) {
  if constexpr (CROSS)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
        "@p st.release.cluster.shared::cluster.b32 [%0], %1;\n}\n" ::"r"(addr),
        "r"(v), "r"(static_cast<int>(pred))
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
        "@p st.release.cta.shared::cta.b32 [%0], %1;\n}\n" ::"r"(addr),
        "r"(v), "r"(static_cast<int>(pred))
        : "memory");
}

// A whole warp waits, by a vote, so that the compiler sees it converged
// after the wait (a split warp's next shuffles would be guarded at a high
// cost); a wait of over 2^31 clocks (~1 s) traps, so a lost hand-over or copy
// fails the launch instead of hanging the card.
// ... until *p >= want (the back-pressure count, which rarely holds a warp)
template <bool CROSS>
__device__ __forceinline__ void wait_at_least(const int* p, int want) {
  const uint32_t start = static_cast<uint32_t>(clock());
  while (!__all_sync(FULL, ld_acquire<CROSS>(p) >= want))
    if (__any_sync(FULL, static_cast<uint32_t>(clock()) - start > (1u << 31))) __trap();
}

template <bool CROSS>
__device__ __forceinline__ bool try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  if constexpr (CROSS)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  return done != 0;
}

// ... until the barrier's phase of this parity has completed; try_wait
// suspends the thread for a while instead of spinning on shared memory
template <bool CROSS>
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  const uint32_t start = static_cast<uint32_t>(clock());
  while (!__all_sync(FULL, try_wait<CROSS>(bar, parity)))
    if (__any_sync(FULL, static_cast<uint32_t>(clock()) - start > (1u << 31))) __trap();
}

// one arrival on the barrier at `addr` (a cluster address where CROSS) where
// pred holds, releasing this thread's writes
template <bool CROSS>
__device__ __forceinline__ void arrive_pred(uint32_t addr, bool pred) {
  if constexpr (CROSS)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
        "@p mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n}\n" ::"r"(addr),
        "r"(static_cast<int>(pred))
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
        "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(addr),
        "r"(static_cast<int>(pred))
        : "memory");
}

// Stores made only where pred holds, as predicated instructions: a branch
// around a store splits the warp, and the compiler then guards the next
// shuffles against a split warp at a high cost.
__device__ __forceinline__ void store_pred(int8_t* p, int v, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.global.b8 [%0], %1;\n}\n" ::"l"(p),
      "r"(v), "r"(static_cast<int>(pred)));
}

// a cost into the ring at `addr` (a cluster address where CROSS)
template <bool CROSS, typename T>
__device__ __forceinline__ void store_ring(uint32_t addr, T v, bool pred) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "float or double");
  if constexpr (CROSS && sizeof(T) == 8)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.shared::cluster.f64 [%0], %1;\n}\n" ::
            "r"(addr),
        "d"(v), "r"(static_cast<int>(pred))
        : "memory");
  else if constexpr (CROSS)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.shared::cluster.f32 [%0], %1;\n}\n" ::
            "r"(addr),
        "f"(v), "r"(static_cast<int>(pred))
        : "memory");
  else if constexpr (sizeof(T) == 8)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.shared.f64 [%0], %1;\n}\n" ::"r"(addr),
        "d"(v), "r"(static_cast<int>(pred))
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.shared.f32 [%0], %1;\n}\n" ::"r"(addr),
        "f"(v), "r"(static_cast<int>(pred))
        : "memory");
}

// what one warp carries from step to step
template <typename T>
struct Wave {
  T c_prev;   // own cost of the previous step: the left neighbour (i, j - 1)
  T up_prev;  // up value of the previous step: the diagonal (i - 1, j - 1)
};

// How a hand-over of C steps runs: EDGE, the general form (any cell may lie
// outside the matrix or on its border); FIRST, the same with the fixed
// cells of diagonals 0 and 1 (warp 0's first hand-over); INTERIOR, every
// lane's columns in 1 .. M (trace rows in range), which needs no per-step
// bounds: a lane's row is valid or not for the whole hand-over.
enum Mode { EDGE, FIRST, INTERIOR };

// What a warp's wave needs: its place, its matrix, its tiles and its
// neighbours' rings, barriers and counts (out_*: in its consumer's block,
// out_cons: in its producer's; cluster addresses where that lies in the
// other block of the cluster).
struct Warp {
  int l, i, w, wl, ng, g, k0, M, W, K;
  bool consumer, producer, warp0;
  const float* tiles;
  uint32_t tile_bar, full_bar, edge_in, out_edge, out_full, out_cons;
  int* cons;
  int8_t* tg;
};

// C steps s0 .. s0 + C - 1 of one warp, in hand-overs of H. xa / xb: the
// lane's row in the tiles holding columns >= qcol and < qcol. The ring is
// indexed by the producing lane's step s (column s - 31), so a hand-over's
// slots are contiguous; barrier b of RING / H counts the producer's
// hand-overs of steps b H .. b H + H - 1 (mod RING).
template <typename T, int C, Mode MODE, bool CROSS_IN, bool CROSS_OUT>
__device__ __forceinline__ void steps(Wave<T>& v, const Warp& a, int s0, const float* xa,
                                      const float* xb, int qcol, const T* in_edge,
                                      uint32_t (&tb)[C / 4]) {
  constexpr int NB = RING / H;
  const int l = a.l, i = a.i, ng = a.ng, M = a.M;
  const T inf = static_cast<T>(INFINITY);
  // the loads first, and the inputs converted, +inf on the borders and
  // outside the valid cells: an invalid cell's neighbours are invalid or on
  // the borders, so it comes to +inf without a select on the chain (only
  // column -1 of the invalid cells is read by a valid one). A load after a
  // store of the trace or the ring could not be issued before that store,
  // which waits on the chain.
  T xin[C];  // the lane's inputs
#pragma unroll
  for (int e = 0; e < C; ++e) {
    const int j = s0 + e - l, cc = j - 1;
    const float x = (cc >= qcol ? xa : xb)[cc & 31];
    const bool valid = (MODE == INTERIOR || static_cast<unsigned>(j) <= static_cast<unsigned>(M))
                       && i <= ng;
    xin[e] = (i == 0 || (MODE != INTERIOR && j <= 0) || !valid) ? inf : static_cast<T>(x);
  }
  const uint32_t ring = a.out_edge + sizeof(T) * (s0 & (RING - 1));
#pragma unroll
  for (int h = 0; h < C / H; ++h) {
    const int s1 = s0 + h * H;
    if (a.consumer && s1 <= M) {  // the producer's hand-over holding column s1 + H - 1
      const int c = min(s1 + H + 30, M + 31) / H;
      wait_phase<CROSS_IN>(a.full_bar + 8 * (c % NB), (c / NB) & 1);
    }
    T ext[H];  // lane 0's up neighbours from the previous warp
#pragma unroll
    for (int e = 0; e < H; ++e) {
      const int s = s1 + e;
      const T edge = in_edge[(s + 31) & (RING - 1)];  // in bounds whatever s: no branch
      ext[e] = (a.consumer && (MODE == INTERIOR || s <= M)) ? edge : inf;
    }
#pragma unroll
    for (int f = 0; f < H; ++f) {
      const int e = h * H + f, s = s1 + f, j = s - l;
      const T sh = __shfl_up_sync(FULL, v.c_prev, 1);
      const T up = l == 0 ? ext[f] : sh;
      const T diag = v.up_prev, left = v.c_prev;
      // selects, not branches: lanes that chose differently must not diverge
      const bool take_diag = diag < up && diag < left;
      const bool take_up = up < diag && up < left;
      const T best = take_diag ? diag : take_up ? up : left;
      T c = xin[e] + best;
      int t = take_diag ? 0 : take_up ? 1 : 2;
      if constexpr (MODE == INTERIOR) {
        if (i > ng) t = -1;
        store_ring<CROSS_OUT>(ring + sizeof(T) * e, c, a.producer && l == 31);
      } else {
        if (!(static_cast<unsigned>(j) <= static_cast<unsigned>(M) && i <= ng)) t = -1;
        if (MODE == FIRST && s < 2) {
          c = (s == 0 && i == 0) ? static_cast<T>(0) : inf;
          t = -1;
        }
        store_ring<CROSS_OUT>(ring + sizeof(T) * e, c,
                              a.producer && l == 31 &&
                                  static_cast<unsigned>(j) <= static_cast<unsigned>(M));
      }
      const uint32_t byte = static_cast<uint32_t>(t & 0xff) << (8 * (e & 3));
      tb[e >> 2] = (e & 3) ? tb[e >> 2] | byte : byte;
      v.up_prev = up;
      v.c_prev = c;
    }
    // every hand-over arrives once, so its barrier's phases count them
    arrive_pred<CROSS_OUT>(a.out_full + 8 * ((s1 / H) % NB), a.producer && l == 31);
  }
}

// the trace bytes of steps s0 .. s0 + C - 1 (tb: four a register), stored
// after the last of them: a store among the steps delays the next step's
// shuffle
template <int C>
__device__ __forceinline__ void store_trace(const uint32_t (&tb)[C / 4], int8_t* tg, int s0,
                                            int k0, int i, int W, int K) {
  int8_t* tp = tg + (size_t)(k0 + s0) * W + i;
#pragma unroll
  for (int e = 0; e < C; ++e, tp += W)
    store_pred(tp, static_cast<int>(tb[e >> 2] >> (8 * (e & 3))) & 0xff,
               i < W && k0 + s0 + e < K);
}

constexpr int MAXW = 8;  // warps of a block: 255 registers a thread
constexpr int D = 2;     // tiles loaded ahead
constexpr int NSLOT = D + 2;

// per warp, in dynamic shared memory: the ring [RING] of T its producer
// writes, the tiles [NSLOT][32][32] fp32 (TMA boxes), the tiles' barriers
// [NSLOT] and the ring's [RING / H], and the back-pressure count its
// consumer writes
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int warps) {
  return (size_t)warps * (RING * sizeof(T) + NSLOT * TILE * sizeof(float) +
                          8 * (NSLOT + RING / H) + sizeof(int));
}


// The warp's whole wave, in hand-overs of H steps (computed C = 32 at a
// time). CROSS_IN / CROSS_OUT: its producer / consumer lies in the other
// block of the cluster.
template <typename T, bool CROSS_IN, bool CROSS_OUT>
__device__ __forceinline__ void wave(const Warp& a, const CUtensorMap* xmap) {
  constexpr int C = 32;
  const int l = a.l, k0 = a.k0, M = a.M;
  const int S = (M + 32 + C - 1) / C * C;  // steps until row 32 w + 31 passes column M
  // tile p: columns 32 p .. 32 p + 31 of x rows 32 w - 1 .. 32 w + 30 (DP
  // rows 32 w .. 32 w + 31), one TMA box; rows and columns outside x read 0
  auto load_tile = [&](int p) {
    if (l == 0) {
      const uint32_t bar = a.tile_bar + 8 * (p % NSLOT);
      mbar_expect_tx(bar, TILE * sizeof(float));
      tma_load(smem_u32(a.tiles + (p % NSLOT) * TILE), xmap, 32 * p, k0 - 1, a.g, bar);
    }
  };
  if (l == 0) tma_prefetch_map(xmap);
#pragma unroll
  for (int p = 0; p < D; ++p) load_tile(p);

  const T* in_edge = reinterpret_cast<const T*>(__cvta_shared_to_generic(a.edge_in));
  Wave<T> v{static_cast<T>(INFINITY), static_cast<T>(INFINITY)};
  for (int s0 = 0; s0 < S; s0 += C) {  // a block of 32 steps reads tiles q - 1 and q
    const int q = s0 >> 5;
    __syncwarp();  // every lane is done with tile q - 2, whose slot tile q + D takes
    load_tile(q + D);
    wait_phase<false>(a.tile_bar + 8 * (q % NSLOT), (q / NSLOT) & 1);
    const float* xa = a.tiles + (q % NSLOT) * TILE + 32 * l;
    const float* xb = a.tiles + ((q + NSLOT - 1) % NSLOT) * TILE + 32 * l;
    if (a.producer) {  // the columns these steps write replace ones RING older
      const int top = min(s0 + C - 32, M);
      if (top >= RING) wait_at_least<CROSS_OUT>(a.cons, top - RING + 1);
    }
    uint32_t tb[C / 4];  // the steps' trace bytes
    if (s0 >= 32 && s0 + C - 1 <= M)
      steps<T, C, INTERIOR, CROSS_IN, CROSS_OUT>(v, a, s0, xa, xb, s0, in_edge, tb);
    else if (a.warp0 && s0 == 0)
      steps<T, C, FIRST, CROSS_IN, CROSS_OUT>(v, a, s0, xa, xb, s0, in_edge, tb);
    else
      steps<T, C, EDGE, CROSS_IN, CROSS_OUT>(v, a, s0, xa, xb, s0, in_edge, tb);
    store_trace<C>(tb, a.tg, s0, k0, a.i, a.W, a.K);
    st_release<CROSS_IN>(a.out_cons, min(s0 + C, M + 1), a.consumer && l == 0);
  }
}

// CL: the blocks of a cluster that share one matrix, MAXW warps or fewer
// each (up to 8 warps one block, up to 16 two, on two SMs)
template <typename T, int CL>
__global__ void __launch_bounds__(MAXW * 32, 1)
    dtw_kernel(const __grid_constant__ CUtensorMap xmap, const int* __restrict__ n,
               int8_t* __restrict__ trace, int N_max, int M, int K, int W) {
  constexpr int NB = RING / H;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int bw = blockDim.x >> 5;  // warps of a block
  T* edge = reinterpret_cast<T*>(smem_raw);                        // [bw][RING]
  float* xs = reinterpret_cast<float*>(edge + bw * RING);          // [bw][NSLOT][TILE]
  const uint32_t bars = smem_u32(xs + (size_t)bw * NSLOT * TILE);  // [bw][NSLOT + NB]
  int* cons = reinterpret_cast<int*>(xs + (size_t)bw * NSLOT * TILE) + 2 * bw * (NSLOT + NB);

  Warp a;
  const int rank = CL > 1 ? static_cast<int>(cluster_rank()) : 0;
  a.g = blockIdx.x / CL, a.wl = threadIdx.x >> 5, a.l = threadIdx.x & 31;
  a.w = rank * bw + a.wl;  // the warp's place in the matrix
  a.i = 32 * a.w + a.l;
  a.ng = min(n[a.g], N_max);  // a count past N_max must not read past x
  a.M = M, a.W = W, a.K = K, a.k0 = 32 * a.w;  // k0: the diagonal of the warp's step 0
  a.tg = trace + (size_t)a.g * K * W;
  a.tile_bar = bars + 8 * a.wl * (NSLOT + NB), a.full_bar = a.tile_bar + 8 * NSLOT;
  if (a.l == 0) {
    for (int b = 0; b < NSLOT + NB; ++b) mbar_init(a.tile_bar + 8 * b, 1);
    cons[a.wl] = 0;
    mbar_fence_init();
  }
  if (CL > 1) {  // every block's barriers exist before another writes to them
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  // what holds for a whole warp is taken by a vote, so that the compiler
  // knows each branch on it below keeps the warp whole
  const int active = a.ng < 0 ? 0 : min(CL * bw, a.ng / 32 + 1);  // warps with a valid row
  const int S = (M + 63) / 32 * 32;  // as in wave
  const int i = a.i, k0 = a.k0;
  if (__all_sync(FULL, a.w >= active)) {
    for (int k = 0; k < K; ++k) store_pred(a.tg + (size_t)k * W + i, -1, i < W);
  } else {
    for (int k = 0; k < min(k0, K); ++k) store_pred(a.tg + (size_t)k * W + i, -1, i < W);
    for (int k = k0 + S; k < K; ++k) store_pred(a.tg + (size_t)k * W + i, -1, i < W);
    a.consumer = __all_sync(FULL, a.w > 0), a.producer = __all_sync(FULL, a.w + 1 < active);
    a.warp0 = __all_sync(FULL, a.w == 0);
    // the neighbours' places: warp w + 1 (consumer) and w - 1 (producer)
    const int wc = (a.w + 1) % bw, rc = min((a.w + 1) / bw, CL - 1);
    const int wp = a.consumer ? (a.w - 1) % bw : a.wl;
    const int rp = a.consumer ? (a.w - 1) / bw : rank;
    const bool cross_out = __all_sync(FULL, CL > 1 && a.producer && rc != rank);
    const bool cross_in = __all_sync(FULL, CL > 1 && a.consumer && rp != rank);
    a.tiles = xs + (size_t)a.wl * NSLOT * TILE;
    a.cons = cons + a.wl;
    a.edge_in = smem_u32(edge + a.wl * RING);
    a.out_edge = smem_u32(edge + wc * RING);
    a.out_full = bars + 8 * (wc * (NSLOT + NB) + NSLOT);
    a.out_cons = smem_u32(cons + wp);
    if (cross_out) a.out_edge = map_rank(a.out_edge, rc), a.out_full = map_rank(a.out_full, rc);
    if (cross_in) a.out_cons = map_rank(a.out_cons, rp);
    if (CL > 1 && cross_out)
      wave<T, false, true>(a, &xmap);
    else if (CL > 1 && cross_in)
      wave<T, true, false>(a, &xmap);
    else
      wave<T, false, false>(a, &xmap);
  }
  if (CL > 1) {  // no block leaves while another may still write to it
    cluster_arrive();
    cluster_wait();
  }
}

template <typename T, int CL>
int launch_cfg(const CUtensorMap& xmap, const void* n, void* trace, int G, int N_max, int M,
               int bw, cudaStream_t stream) {
  auto kernel = dtw_kernel<T, CL>;
  const size_t smem = smem_bytes<T>(bw);
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G * CL);
  cfg.blockDim = dim3(bw * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = CL > 1 ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, xmap, static_cast<const int*>(n),
                         static_cast<int8_t*>(trace), N_max, M, N_max + M + 1, N_max + 1);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

static_assert(smem_bytes<double>(MAXW) <= 227 * 1024, "a block's rings and tiles fit");

// up to MAXW warps a matrix: one block; more: two blocks of a cluster
template <typename T>
int launch(const CUtensorMap& xmap, const void* n, void* trace, int G, int N_max, int M,
           cudaStream_t stream) {
  const int nwarps = (N_max + 1 + 31) / 32;
  return nwarps <= MAXW
             ? launch_cfg<T, 1>(xmap, n, trace, G, N_max, M, nwarps, stream)
             : launch_cfg<T, 2>(xmap, n, trace, G, N_max, M, (nwarps + 1) / 2, stream);
}

// The chain floor's unit: one warp runs `iters` steps of the recurrence
// with the inputs off the chain, each step's cost feeding the next step's
// compares; with SHUFFLE the up neighbour also comes from lane l - 1 as in
// the kernel (a step that crosses rows), else from a register (a step along
// a row). The caller times the launch; out[0] is written only so that the
// chain is not removed as dead code.
template <typename T, bool SHUFFLE>
__global__ void step_chain(const float* __restrict__ seed, long long* __restrict__ out,
                           int iters) {
  const int l = threadIdx.x;
  T c = seed[l], up_prev = seed[32 + l];
  const T ext = seed[64 + l], xv = seed[96 + l];
  for (int it = 0; it < iters; ++it) {
    T up = ext;
    if (SHUFFLE) {
      const T sh = __shfl_up_sync(FULL, c, 1);
      up = l == 0 ? ext : sh;
    }
    const T diag = up_prev, left = c;
    const T best = (diag < up && diag < left) ? diag : (up < diag && up < left) ? up : left;
    up_prev = up;
    c = xv + best;
  }
  if (c == static_cast<T>(-1.25e-7)) out[0] = 1;  // keeps the chain live
}

}  // namespace

// seed [128] fp32, out [1] int64: `iters` dependent steps of one warp in the
// sum type (double_acc), crossing rows by a shuffle or not; the caller times
// the launch.
extern "C" int dtw_step_chain(const void* seed, void* out, int iters, int double_acc,
                              int shuffle, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sd = static_cast<const float*>(seed);
  long long* o = static_cast<long long*>(out);
  if (double_acc && shuffle)
    step_chain<double, true><<<1, 32, 0, st>>>(sd, o, iters);
  else if (double_acc)
    step_chain<double, false><<<1, 32, 0, st>>>(sd, o, iters);
  else if (shuffle)
    step_chain<float, true><<<1, 32, 0, st>>>(sd, o, iters);
  else
    step_chain<float, false><<<1, 32, 0, st>>>(sd, o, iters);
  return static_cast<int>(cudaGetLastError());
}

// x [G, N_max, ld] fp32 (ld >= M a multiple of 4: the copy engine's row
// stride is a whole 16-byte unit; columns >= M are not read); n [G] int32
// (counts past N_max act as N_max); trace [G, N_max + M + 1, N_max + 1]
// int8. 1 <= N_max <= 511 (at most 16 warps, one block a matrix), M >= 1.
// double_acc selects the type the costs are summed in.
extern "C" int dtw_trace(const void* x, const void* n, void* trace, int G, int N_max, int M,
                         int ld, int double_acc, void* stream) {
  if (G < 1 || N_max < 1 || N_max > 511 || M < 1 || ld < M || ld % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn;
  const cudaError_t e = encode_function(&fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap xmap;
  const int rc = encode_3d(fn, &xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, ld, N_max, G, 32, 32,
                           CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B);
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return double_acc ? launch<double>(xmap, n, trace, G, N_max, M, st)
                    : launch<float>(xmap, n, trace, G, N_max, M, st);
}
