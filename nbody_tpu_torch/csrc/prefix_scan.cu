// Double-float prefix table of the Barnes-Hut build for Hopper (sm_90a),
// bound through a plain C interface (ctypes; see nbody_tpu_torch/ops/_build.py).
//
// prefix_table  replaces no Pallas kernel: the JAX package builds the table
//     with lax.associative_scan and a TwoSum combiner
//     (nbody_tpu/ops/tree.py:235-258), which the port's plain twin
//     (ops/prefix_scan.py prefix_table_plain) runs as a Hillis-Steele scan,
//     ~175 eager launches a table at 100k rows.  It takes the sorted
//     per-particle values vals [N, K] (K <= 4, float or double, row-major)
//     and writes out [N + 1, 8]: row 0 zero, row i + 1 the sum of rows
//     0..i as a hi + lo pair a column (hi in columns 0..K-1, lo in
//     K..2K-1), zeros after.  The build reads range sums off it as
//     (hi_e - hi_s) + (lo_e - lo_s), so every partial has to be accurate to
//     ~2^-46 of its size in f32: a plain running sum would put ~ulp(total)
//     on every range.
//
//     What bounds it on the card: bytes (each input row read twice, each
//     output row written once: ~6.4 MB and ~2 us at 100k rows, K = 4, f32),
//     and, at the build's sizes, the launches.  The design:
//       - reduce, then scan, three launches a table (one up to 1024 rows):
//         tile_total_kernel sums each tile, tile_offset_kernel (one block)
//         turns the tile totals into exclusive offsets, scan_kernel scans
//         each tile from its offset;
//       - a tile is 1024 rows (256 threads, 4 consecutive rows each); above
//         32768 tiles a block walks several such sub-tiles, carrying the
//         running sum, so the offsets' block never takes more than 32
//         totals a thread;
//       - a thread carries its rows sequentially, a warp scans its threads'
//         totals by shuffles, and the first warp scans the warps' totals:
//         a chain of a few dozen adds from any row to its partial;
//       - every add is a double-float add built from error-free
//         transformations (TwoSum of the two hi and of the two lo words,
//         two renormalisations: QD's accurate add), so its error is ~2^-47
//         of its result in f32 whatever the order.
//     Deterministic: each add happens in an order fixed by the shapes, with
//     no atomics and no look-back, so the same input gives the same bits
//     on every run (a refresh of the tree at the build's positions equals
//     the build).  Its bits differ from the twin's, whose log-step order it
//     does not follow; both are within a few 2^-48 of the exact sums.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                       // a scan or reduce block
constexpr int kRows = 4;                            // rows a thread carries
constexpr int kTile = kThreads * kRows;             // 1024 rows a sub-tile
constexpr int kWarps = kThreads / 32;
constexpr int kOffsetThreads = 1024;                // the offsets' block
constexpr int kTotalsPerThread = 32;
constexpr long long kMaxTiles =
    static_cast<long long>(kOffsetThreads) * kTotalsPerThread;  // 32768

template <typename T>
struct DF {
  T hi, lo;
};

// s + e == a + b exactly
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  const T z = s - a;
  e = (a - (s - z)) + (b - z);
}

// s + e == a + b exactly, for |a| >= |b| (or a == 0)
template <typename T>
__device__ __forceinline__ void fast_two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  e = b - (s - a);
}

template <typename T>
__device__ __forceinline__ DF<T> df_add(DF<T> a, DF<T> b) {
  T s, e, t, f;
  two_sum(a.hi, b.hi, s, e);
  two_sum(a.lo, b.lo, t, f);
  e += t;
  fast_two_sum(s, e, s, e);
  e += f;
  fast_two_sum(s, e, s, e);
  return {s, e};
}

template <typename T, int K>
struct Row {
  DF<T> c[K];
};

template <typename T, int K>
__device__ __forceinline__ Row<T, K> row_zero() {
  Row<T, K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) r.c[k] = {T(0), T(0)};
  return r;
}

template <typename T, int K>
__device__ __forceinline__ Row<T, K> row_add(const Row<T, K>& a,
                                             const Row<T, K>& b) {
  Row<T, K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) r.c[k] = df_add(a.c[k], b.c[k]);
  return r;
}

template <typename T, int K>
__device__ __forceinline__ Row<T, K> row_shfl_up(const Row<T, K>& a, int d) {
  Row<T, K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    r.c[k].hi = __shfl_up_sync(0xffffffffu, a.c[k].hi, d);
    r.c[k].lo = __shfl_up_sync(0xffffffffu, a.c[k].lo, d);
  }
  return r;
}

template <typename T, int K>
__device__ __forceinline__ Row<T, K> row_shfl_down(const Row<T, K>& a,
                                                   int d) {
  Row<T, K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    r.c[k].hi = __shfl_down_sync(0xffffffffu, a.c[k].hi, d);
    r.c[k].lo = __shfl_down_sync(0xffffffffu, a.c[k].lo, d);
  }
  return r;
}

// Row i of vals as a double-float row (zero past n).
template <typename T, int K>
__device__ __forceinline__ Row<T, K> load_row(const T* __restrict__ vals,
                                              long long i, long long n) {
  Row<T, K> r;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    r.c[k] = {i < n ? vals[i * K + k] : T(0), T(0)};
  }
  return r;
}

// Inclusive scan of a row over the warp's lanes (lane order).
template <typename T, int K>
__device__ __forceinline__ Row<T, K> warp_inclusive(Row<T, K> x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Row<T, K> y = row_shfl_up(x, d);
    if (lane >= d) x = row_add(y, x);
  }
  return x;
}

// Exclusive scan of one row a thread over a block of W full warps: returns
// this thread's exclusive prefix and sets `total` to the block's sum (the
// same bits in every thread).  `smem` holds W + 1 rows.
template <typename T, int K, int W>
__device__ Row<T, K> block_exclusive(const Row<T, K>& x, Row<T, K>* smem,
                                     Row<T, K>& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Row<T, K> inc = warp_inclusive(x);
  Row<T, K> exc = row_shfl_up(inc, 1);
  if (lane == 0) exc = row_zero<T, K>();
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Row<T, K> w = lane < W ? smem[lane] : row_zero<T, K>();
    const Row<T, K> winc = warp_inclusive(w);
    Row<T, K> wexc = row_shfl_up(winc, 1);
    if (lane == 0) wexc = row_zero<T, K>();
    __syncwarp();
    if (lane < W) smem[lane] = wexc;
    if (lane == W - 1) smem[W] = winc;
  }
  __syncthreads();
  const Row<T, K> before = warp == 0 ? exc : row_add(smem[warp], exc);
  total = smem[W];
  __syncthreads();  // smem is free again on return
  return before;
}

// Sum of one row a thread over the block, in a fixed tree order; valid in
// thread 0.  `smem` holds kWarps rows.
template <typename T, int K>
__device__ Row<T, K> block_sum(Row<T, K> x, Row<T, K>* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = row_add(x, row_shfl_down(x, d));
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kWarps ? smem[lane] : row_zero<T, K>();
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x = row_add(x, row_shfl_down(x, d));
  }
  __syncthreads();
  return x;
}

// 1. The sum of each tile of `per` sub-tiles (rows [b * per * kTile, ...)).
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    tile_total_kernel(const T* __restrict__ vals, long long n, int per,
                      Row<T, K>* __restrict__ totals) {
  __shared__ Row<T, K> smem[kWarps];
  const long long first = static_cast<long long>(blockIdx.x) * per * kTile;
  Row<T, K> tile = row_zero<T, K>();
  for (int s = 0; s < per; ++s) {
    const long long row0 = first + static_cast<long long>(s) * kTile +
                           threadIdx.x * kRows;
    if (first + static_cast<long long>(s) * kTile >= n) break;  // block-wide
    Row<T, K> mine = row_zero<T, K>();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      mine = row_add(mine, load_row<T, K>(vals, row0 + j, n));
    }
    const Row<T, K> sub = block_sum(mine, smem);
    if (threadIdx.x == 0) tile = row_add(tile, sub);
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = tile;
}

// 2. Exclusive offsets of the `tiles` tile totals, in one block: each thread
// carries a run of consecutive totals.
template <typename T, int K>
__global__ void __launch_bounds__(kOffsetThreads)
    tile_offset_kernel(const Row<T, K>* __restrict__ totals, int tiles,
                       Row<T, K>* __restrict__ offsets) {
  __shared__ Row<T, K> smem[kOffsetThreads / 32 + 1];
  const int per = (tiles + kOffsetThreads - 1) / kOffsetThreads;
  const int first = threadIdx.x * per;
  const int last = min(first + per, tiles);
  Row<T, K> run = row_zero<T, K>();
  for (int t = first; t < last; ++t) run = row_add(run, totals[t]);
  Row<T, K> total;
  Row<T, K> base =
      block_exclusive<T, K, kOffsetThreads / 32>(run, smem, total);
  for (int t = first; t < last; ++t) {
    offsets[t] = base;
    base = row_add(base, totals[t]);
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  float4* d = reinterpret_cast<float4*>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(double* dst, const double (&v)[8]) {
  double2* d = reinterpret_cast<double2*>(dst);
  d[0] = make_double2(v[0], v[1]);
  d[1] = make_double2(v[2], v[3]);
  d[2] = make_double2(v[4], v[5]);
  d[3] = make_double2(v[6], v[7]);
}

// Table row `r` (8 values of T, 16-byte aligned): the hi words, the lo words,
// zeros after.
template <typename T, int K>
__device__ __forceinline__ void store_row(T* __restrict__ out, long long r,
                                          const Row<T, K>& p) {
  T v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = p.c[k].hi;
    v[K + k] = p.c[k].lo;
  }
  store8(out + r * 8, v);
}

// 3. Each tile's partials from its offset (none: zero), sub-tile by
// sub-tile; block 0 also writes the zero row.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ vals, long long n, int per,
                const Row<T, K>* __restrict__ offsets, T* __restrict__ out) {
  __shared__ Row<T, K> smem[kWarps + 1];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    store_row<T, K>(out, 0, row_zero<T, K>());
  }
  const long long first = static_cast<long long>(blockIdx.x) * per * kTile;
  Row<T, K> carry =
      offsets != nullptr ? offsets[blockIdx.x] : row_zero<T, K>();
  for (int s = 0; s < per; ++s) {
    const long long row0 = first + static_cast<long long>(s) * kTile +
                           threadIdx.x * kRows;
    if (first + static_cast<long long>(s) * kTile >= n) break;  // block-wide
    Row<T, K> inc[kRows];
    inc[0] = load_row<T, K>(vals, row0, n);
#pragma unroll
    for (int j = 1; j < kRows; ++j) {
      inc[j] = row_add(inc[j - 1], load_row<T, K>(vals, row0 + j, n));
    }
    Row<T, K> total;
    const Row<T, K> before =
        block_exclusive<T, K, kWarps>(inc[kRows - 1], smem, total);
    const Row<T, K> base = row_add(carry, before);
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (row0 + j < n) store_row<T, K>(out, row0 + j + 1,
                                        row_add(base, inc[j]));
    }
    carry = row_add(carry, total);
  }
}

// Sub-tiles a tile, and tiles, for n rows.
void plan(long long n, int& per, int& tiles) {
  const long long subs = n > 0 ? (n + kTile - 1) / kTile : 1;
  const long long p = (subs + kMaxTiles - 1) / kMaxTiles;
  per = static_cast<int>(p);
  tiles = static_cast<int>((subs + p - 1) / p);
}

template <typename T, int K>
int launch(const T* vals, long long n, T* out, T* scratch, cudaStream_t s) {
  int per, tiles;
  plan(n, per, tiles);
  if (tiles == 1) {
    scan_kernel<T, K><<<1, kThreads, 0, s>>>(vals, n, per, nullptr, out);
    return static_cast<int>(cudaGetLastError());
  }
  auto* totals = reinterpret_cast<Row<T, K>*>(scratch);
  Row<T, K>* offsets = totals + tiles;
  tile_total_kernel<T, K><<<tiles, kThreads, 0, s>>>(vals, n, per, totals);
  tile_offset_kernel<T, K><<<1, kOffsetThreads, 0, s>>>(totals, tiles,
                                                        offsets);
  scan_kernel<T, K><<<tiles, kThreads, 0, s>>>(vals, n, per, offsets, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* vals, long long n, int k, void* out, void* scratch,
             cudaStream_t s) {
  const T* v = static_cast<const T*>(vals);
  T* o = static_cast<T*>(out);
  T* w = static_cast<T*>(scratch);
  switch (k) {
    case 1: return launch<T, 1>(v, n, o, w, s);
    case 2: return launch<T, 2>(v, n, o, w, s);
    case 3: return launch<T, 3>(v, n, o, w, s);
    case 4: return launch<T, 4>(v, n, o, w, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

// Elements of the table's element type the scratch of an n-row, k-column
// call needs (tile totals and offsets; 0 for a one-tile call).
long long nbody_prefix_scratch(long long n, int k) {
  int per, tiles;
  plan(n, per, tiles);
  return tiles == 1 ? 0 : 2LL * tiles * k * 2;
}

// vals [n, k] (k in 1..4) -> out [n + 1, 8], both of float (dbl = 0) or
// double (dbl = 1), contiguous, out 16-byte aligned; scratch holds
// nbody_prefix_scratch(n, k) elements.  0 <= n < 2^31.
int nbody_prefix_table(const void* vals, long long n, int k, int dbl,
                       void* out, void* scratch, void* stream) {
  if (n < 0 || n >= (1LL << 31) || k < 1 || k > 4 ||
      (reinterpret_cast<unsigned long long>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dbl ? dispatch<double>(vals, n, k, out, scratch, s)
             : dispatch<float>(vals, n, k, out, scratch, s);
}

}  // extern "C"
