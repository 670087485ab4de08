// Direct-sum gravity kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see nbody_tpu_torch/ops/_build.py).
//
// All compute, for every target i,
//     a_i = G * sum_j m_j (p_j - p_i) / (|p_j - p_i|^2 + eps^2)^{3/2}
// in fp32, with m_j = 0 for dead and padding sources.  A self or coincident
// pair has d = 0 and so contributes exactly 0.  Each kernel is specialised
// on eps (softened.cuh): the r2 > 0 ? r2 : 1 guard runs only at eps = 0.
//
// K2  acc_targets_kernel + sym_reduce_kernel  replace
//     nbody_tpu/ops/pairwise.py pairwise_acc_pallas_targets (and
//     pairwise_acc_pallas, the K = N case; body _kernel): K targets x N
//     sources, one direction.  The TPU kernel carries each target tile's
//     sum across a sequential grid dimension over source tiles; here the
//     source range is cut into `splits` chunks of `chunk` sources (a
//     multiple of the 128-source stage), one per blockIdx.y, so that a few
//     thousand targets (the sampled oracle of the bh checks) still give
//     a thousand blocks.  Each (target block, chunk) block writes its
//     chunk's sums to a [splits, batch, 3] scratch, and sym_reduce_kernel
//     adds the chunks in order and applies G (one chunk: the block writes
//     G * sum itself).  Targets go through in batches (65536 from the
//     wrapper), so the scratch stays the same size at any N or K.  No
//     atomics: runs are bit-reproducible.
//
//     Summation order: a target adds each 128-source stage of its chunk in
//     order j into a sum that starts from zero, adds the stage sums in
//     order, and the chunks are added in order.  (One chain over a whole
//     chunk grows its rounding error with the chunk's length; with the
//     stage sums the 4096 x 2^20 oracle stays within 1e-4 of a float64
//     sum, max-row over mean row, as chip_smoke.py phase 6 checks.)  The
//     chunk plan (ops/pairwise.py targets_launch) is a function of N alone,
//     so a target's sum does not depend on K or on its place in the target
//     set: a sampled-target call is bitwise equal to the matching rows of
//     the full call.
//
//     A block of kTargetsThreads (64) threads holds kTargetsPerThread (4)
//     targets a thread (rows r0 + t + q * kTargetsThreads) in registers, so
//     one broadcast LDS.128 of a staged source (x, y, z, m) serves four
//     pairs (one and two targets a thread, and 128 or 256 threads a block,
//     measured slower: PERF.md).  The sources are packed once a call into
//     a float4 [splits * chunk, 4] scratch (pack_sources_kernel; the [N, 3]
//     rows are 12 bytes wide, too narrow for a 16-byte cp.async), zero-mass
//     pads past N, so every stage is whole; they arrive through cp.async
//     in a ring of kStages stages, kStages - 1 in flight while one is
//     evaluated, one barrier a stage.  Idle lanes past K load row K - 1 and write nothing.
//
// K1  acc_sym_tiles_kernel + sym_reduce_kernel  replace
//     nbody_tpu/ops/pairwise.py pairwise_acc_pallas_sym (_kernel_sym):
//     Newton's third law, each unordered pair evaluated once.  The TPU
//     kernel carries the mirrored column sums in one VMEM accumulator across
//     a sequential grid; blocks on the card run in parallel and in no order,
//     so here each block owns one lower-triangle tile pair (bi, bj), bj <= bi,
//     of 256 x 256 particles and writes its two partial sums to a separate
//     slot of a [nt, N, 3] buffer (nt = N / 256, nbody_sym_tile()):
//         partial[bj][rows of tile bi] = row sums (force on the targets)
//         partial[bi][cols of tile bj] = -sum_i m_i ir3 d (force on the
//                                        sources), only when bj < bi
//     Diagonal tiles are evaluated in one direction.  Every slot is written
//     exactly once, so the buffer needs no clearing, and sym_reduce_kernel
//     then adds the nt partials of each particle in the fixed order
//     b = 0..nt-1.  No atomics: runs are bit-reproducible.
//
//     Inside a tile pair every lane holds eight target rows of tile bi in
//     registers (lane l: rows l, l + 32, ..., l + 224), so each of the 8
//     warps holds all 256 rows, and warp w takes the 32 columns
//     [32w, 32w + 32) of tile bj.  A packet (x, y, z, m, column sums) for
//     one column rotates around the warp with __shfl_sync: after 32 steps
//     each column has met all 256 rows and is back at its home lane with its
//     column sum, which goes straight to its slot.  The warps' row sums are
//     added in warp order through shared memory.
//
//     Summation order: a column's sum runs over the 256 rows in rotation
//     order (step, then row r); a row's partial is the 8 warps' sums of 32
//     columns each, added in warp order; the reduction adds the N / 256
//     tile partials in tile order.
//
// K5  acc_sym_tiles_kernel<8> + sym_reduce_kernel, batched over groups,
//     replace nbody_tpu/ops/group_force.py group_self_force_pallas
//     (_self_kernel_sym): each Barnes-Hut group against ITSELF, each
//     unordered pair once (BHConfig.near_sym).  The rows are the group's
//     8-wide target rows (x, y, z, m, idx, 0, 0, 0) [G, B, 8] and the
//     weights its window-masked source masses msrc [G, B], in both
//     directions: the row sum of target i takes msrc[j], the mirrored column
//     sum of source j takes msrc[i] (a masked particle still feels a covered
//     one, through the covered one's column).  That is K1 on (rows, msrc)
//     with a grid dimension over groups: blockIdx.y picks the group, whose
//     rows, weights, [nt, B, 3] partial slots and outputs sit at fixed
//     offsets.  The TPU kernel's band classification of 512 x 1024 tiles
//     existed for its sequential grid and VMEM; here every group is K1's
//     lower triangle of 256 x 256 tile pairs.  Scratch: G * B/256 * B * 3
//     floats (0.4 GB at the 1M tier, G = 128, B = 8192).
//
// What bounds them on the card: instruction issue, not bytes.  A tile pair
// of K1 reads 8 KB and evaluates 32768 unordered pairs; a 2 KB stage of K2
// serves kTargetsRows targets; the MUFU rsqrt (16 a clock per SM) is one
// in every ~13-18 instructions.  The specialisation on eps (softened.cuh)
// leaves out the r == 0 guard and rsqrtf's subnormal scaling at eps > 0:
// K2 then issues 12 FP32 instructions and one MUFU a pair, and a quarter
// of a shared load (SASS: scripts/torch_kernel_profile.py; PERF.md).  K1 and K5
// keep theirs few with eight rows a lane, so one rotation of the 7-float
// packet serves eight pairs (7/8 shuffle a pair): 16 FP32 instructions and
// one MUFU a pair.  Each K1 block holds 256 rows of positions, masses and
// sums in registers (two blocks an SM).  The 256-wide tiles keep the
// partial buffer to 2 * nt * N * 12 bytes of traffic (0.4 GB at N =
// 65536), about a twentieth of K1's time with its reduction.

#include <cuda_runtime.h>
#include <stddef.h>

#include "softened.cuh"

namespace {

constexpr int kStage = 128;            // K2: sources a stage (2 KB)
constexpr int kStages = 4;             // K2: the ring; kStages - 1 in flight
constexpr int kUnroll = 32;            // K2: sources of one unrolled step
constexpr int kTargetsThreads = 64;    // K2: threads a block
constexpr int kTargetsPerThread = 4;   // K2: targets a thread
constexpr int kTargetsRows =           // K2: targets a block
    kTargetsPerThread * kTargetsThreads;
constexpr int kSymTile = 256;         // K1: rows = cols of a tile pair
constexpr int kSymRows = kSymTile / 32;   // K1: rows per lane (all of bi's)
constexpr int kSymWarps = kSymTile / 32;  // K1: warps, 32 columns each
constexpr int kSymThreads = 32 * kSymWarps;  // = kSymTile: a row each to add
static_assert(kSymThreads == kSymTile, "one thread per row in the row sums");
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cp_async16(float4* dst, const float4* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// K2's packed sources: (x, y, z, m) for j < n, and zero-mass pads up to
// len at kFar, where |d|^2 overflows, 1/r^3 is 0 and a pad adds exactly 0
// to any target (a pad at the origin would overflow 1/r^3 at eps = 0 for a
// target within ~1e-13 of it, and 0 * inf is NaN).
constexpr float kFar = 1e30f;

__global__ void pack_sources_kernel(const float* __restrict__ pos,
                                    const float* __restrict__ mass, int n,
                                    int len, float4* __restrict__ src) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= len) return;
  src[j] = j < n ? make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2],
                               mass[j])
                 : make_float4(kFar, kFar, kFar, 0.f);
}

// One block: kTargetsRows targets against the packed sources of chunk
// blockIdx.y, [chunk * y, chunk * (y + 1)).  One chunk (gridDim.y == 1):
// out [k, 3] gets G * sum; several: out is the [gridDim.y, k, 3] scratch
// and gets the chunk's sum.
template <bool kSoft>
__global__ void __launch_bounds__(kTargetsThreads)
acc_targets_kernel(const float* __restrict__ pos_t, int k,
                   const float4* __restrict__ src, int chunk, float eps2,
                   float g, float* __restrict__ out) {
  __shared__ float4 ring[kStages][kStage];
  constexpr int kT = kTargetsPerThread;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kTargetsRows;
  float xi[kT], yi[kT], zi[kT], ax[kT], ay[kT], az[kT];
#pragma unroll
  for (int q = 0; q < kT; ++q) {
    const int i = min(r0 + t + q * kTargetsThreads, k - 1);
    xi[q] = pos_t[3 * i];
    yi[q] = pos_t[3 * i + 1];
    zi[q] = pos_t[3 * i + 2];
    ax[q] = ay[q] = az[q] = 0.f;
  }
  src += static_cast<size_t>(blockIdx.y) * chunk;
  const int stages = chunk / kStage;
  auto fetch = [&](int st) {
    for (int c = t; c < kStage; c += kTargetsThreads) {
      cp_async16(&ring[st % kStages][c], src + st * kStage + c);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < stages) fetch(st);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kStages - 2>();
    // stage st has arrived for every thread's copies, and every thread is
    // done with stage st - 1, whose slot the next fetch overwrites
    __syncthreads();
    if (st + kStages - 1 < stages) fetch(st + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::);
    const float4* b = ring[st % kStages];
    float sx[kT], sy[kT], sz[kT];
#pragma unroll
    for (int q = 0; q < kT; ++q) sx[q] = sy[q] = sz[q] = 0.f;
#pragma unroll kUnroll
    for (int r = 0; r < kStage; ++r) {
      const float4 s = b[r];
#pragma unroll
      for (int q = 0; q < kT; ++q) {
        const float dx = s.x - xi[q], dy = s.y - yi[q], dz = s.z - zi[q];
        const float w = nbody::softened_ir3<kSoft>(dx, dy, dz, eps2) * s.w;
        sx[q] = fmaf(w, dx, sx[q]);
        sy[q] = fmaf(w, dy, sy[q]);
        sz[q] = fmaf(w, dz, sz[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kT; ++q) {
      ax[q] += sx[q];
      ay[q] += sy[q];
      az[q] += sz[q];
    }
  }
  const float scale = gridDim.y == 1 ? g : 1.f;
  float* dst = out + static_cast<size_t>(blockIdx.y) * k * 3;
#pragma unroll
  for (int q = 0; q < kT; ++q) {
    const int i = r0 + t + q * kTargetsThreads;
    if (i < k) {
      dst[3 * i] = ax[q] * scale;
      dst[3 * i + 1] = ay[q] * scale;
      dst[3 * i + 2] = az[q] * scale;
    }
  }
}

// kStride: floats between two particles' rows in `pos` (3 for K1's [N, 3]
// positions, 8 for K5's [G, B, 8] group rows).  blockIdx.y is the group
// (always 0 for K1): group g's n rows, n weights and nt * n * 3 partial
// floats follow group g - 1's.  kSoft: softened.cuh.
template <int kStride, bool kSoft>
__global__ void __launch_bounds__(kSymThreads, 2)
acc_sym_tiles_kernel(const float* __restrict__ pos,
                     const float* __restrict__ mass, int n, float eps2,
                     float* __restrict__ partial) {
  __shared__ float rowsum[kSymWarps][3][kSymTile];
  const size_t grp = blockIdx.y;
  const size_t nt_all = (n + kSymTile - 1) / kSymTile;
  pos += grp * n * kStride;
  mass += grp * n;
  partial += grp * nt_all * 3 * n;

  // blockIdx.x enumerates the lower triangle row by row: p = bi(bi+1)/2 + bj
  const long long p = blockIdx.x;
  int bi = static_cast<int>((sqrt(8.0 * static_cast<double>(p) + 1.0) - 1.0) * 0.5);
  while (static_cast<long long>(bi) * (bi + 1) / 2 > p) --bi;
  while (static_cast<long long>(bi + 1) * (bi + 2) / 2 <= p) ++bi;
  const int bj = static_cast<int>(p - static_cast<long long>(bi) * (bi + 1) / 2);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t slot = static_cast<size_t>(3) * n;  // floats per partial slot

  // rows past n carry zero mass at the origin: they add nothing to any
  // column and their row sums are not written
  float xi[kSymRows], yi[kSymRows], zi[kSymRows], mi[kSymRows];
  float ax[kSymRows], ay[kSymRows], az[kSymRows];
#pragma unroll
  for (int r = 0; r < kSymRows; ++r) {
    const int row = bi * kSymTile + r * 32 + lane;
    const bool ok = row < n;
    xi[r] = ok ? pos[kStride * row] : 0.f;
    yi[r] = ok ? pos[kStride * row + 1] : 0.f;
    zi[r] = ok ? pos[kStride * row + 2] : 0.f;
    mi[r] = ok ? mass[row] : 0.f;
    ax[r] = ay[r] = az[r] = 0.f;
  }
  // this lane's home column of the warp's 32
  const int j = bj * kSymTile + warp * 32 + lane;
  const bool jok = j < n;
  float xj = jok ? pos[kStride * j] : 0.f;
  float yj = jok ? pos[kStride * j + 1] : 0.f;
  float zj = jok ? pos[kStride * j + 2] : 0.f;
  float mj = jok ? mass[j] : 0.f;
  const int from = (lane + 1) & 31;  // the packet moves one lane down a step

  if (bi == bj) {
    // diagonal tile: every ordered pair of it is native here, one direction
#pragma unroll 1
    for (int step = 0; step < 32; ++step) {
#pragma unroll
      for (int r = 0; r < kSymRows; ++r) {
        const float dx = xj - xi[r], dy = yj - yi[r], dz = zj - zi[r];
        const float w = nbody::softened_ir3<kSoft>(dx, dy, dz, eps2) * mj;
        ax[r] = fmaf(w, dx, ax[r]);
        ay[r] = fmaf(w, dy, ay[r]);
        az[r] = fmaf(w, dz, az[r]);
      }
      xj = __shfl_sync(kFullMask, xj, from);
      yj = __shfl_sync(kFullMask, yj, from);
      zj = __shfl_sync(kFullMask, zj, from);
      mj = __shfl_sync(kFullMask, mj, from);
    }
  } else {
    // strictly below the diagonal: one evaluation serves both directions
    float cx = 0.f, cy = 0.f, cz = 0.f;
#pragma unroll 1
    for (int step = 0; step < 32; ++step) {
#pragma unroll
      for (int r = 0; r < kSymRows; ++r) {
        const float dx = xj - xi[r], dy = yj - yi[r], dz = zj - zi[r];
        const float ir3 = nbody::softened_ir3<kSoft>(dx, dy, dz, eps2);
        const float w = ir3 * mj;
        ax[r] = fmaf(w, dx, ax[r]);
        ay[r] = fmaf(w, dy, ay[r]);
        az[r] = fmaf(w, dz, az[r]);
        const float wc = ir3 * mi[r];
        cx = fmaf(-wc, dx, cx);
        cy = fmaf(-wc, dy, cy);
        cz = fmaf(-wc, dz, cz);
      }
      // after 32 steps the packet is home, its column sum complete
      xj = __shfl_sync(kFullMask, xj, from);
      yj = __shfl_sync(kFullMask, yj, from);
      zj = __shfl_sync(kFullMask, zj, from);
      mj = __shfl_sync(kFullMask, mj, from);
      cx = __shfl_sync(kFullMask, cx, from);
      cy = __shfl_sync(kFullMask, cy, from);
      cz = __shfl_sync(kFullMask, cz, from);
    }
    if (jok) {
      float* dst = partial + static_cast<size_t>(bi) * slot + 3 * j;
      dst[0] = cx;
      dst[1] = cy;
      dst[2] = cz;
    }
  }

  // row sums: each warp's over its 32 columns, added in warp order
#pragma unroll
  for (int r = 0; r < kSymRows; ++r) {
    rowsum[warp][0][r * 32 + lane] = ax[r];
    rowsum[warp][1][r * 32 + lane] = ay[r];
    rowsum[warp][2][r * 32 + lane] = az[r];
  }
  __syncthreads();
  const int t = threadIdx.x;
  const int row = bi * kSymTile + t;
  if (row < n) {
    float* dst = partial + static_cast<size_t>(bj) * slot + 3 * row;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float s = rowsum[0][d][t];
#pragma unroll
      for (int w = 1; w < kSymWarps; ++w) s += rowsum[w][d][t];
      dst[d] = s;
    }
  }
}

// blockIdx.y is the group, as in acc_sym_tiles_kernel.
__global__ void sym_reduce_kernel(const float* __restrict__ partial, int n,
                                  int nt, float g, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t slot = static_cast<size_t>(3) * n;
  if (e >= 3 * n) return;
  partial += static_cast<size_t>(blockIdx.y) * nt * slot;
  out += static_cast<size_t>(blockIdx.y) * slot;
  float s = 0.f;
  for (int b = 0; b < nt; ++b) s += partial[static_cast<size_t>(b) * slot + e];
  out[e] = s * g;
}

// K1 (kStride 3, one group) and K5 (kStride 8, G groups): the tile pairs,
// then the ordered reduction of every particle's nt partials.
template <int kStride>
int launch_sym(const float* pos, const float* mass, int groups, int n,
               float eps2, float g, float* partial, long long partial_len,
               float* out, void* stream) {
  if (n <= 0 || groups <= 0 || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nt = (n + kSymTile - 1) / kSymTile;
  if (groups * nt * 3 * n > partial_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(nt * (nt + 1) / 2), groups);
  if (nbody::softened(eps2)) {
    acc_sym_tiles_kernel<kStride, true><<<grid, kSymThreads, 0, s>>>(
        pos, mass, n, eps2, partial);
  } else {
    acc_sym_tiles_kernel<kStride, false><<<grid, kSymThreads, 0, s>>>(
        pos, mass, n, eps2, partial);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_reduce_kernel<<<dim3((3 * n + 255) / 256, groups), 256, 0, s>>>(
      partial, n, static_cast<int>(nt), g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

// K2: pos_t [k, 3] targets, pos [n, 3] / mass [n] sources, out [k, 3].
// The plan (ops/pairwise.py targets_launch): `splits` chunks of `chunk`
// sources (a multiple of 128) that cover [0, n), none of them empty.
// Scratch: src4 holds splits * chunk * 4 floats and, above one chunk,
// partial holds the [splits, batch, 3] partial sums of a batch of targets,
// batch = partial_len / (3 * splits): the targets go through in batches of
// that many, each chunked and then reduced.
int nbody_acc_targets(const float* pos_t, int k, const float* pos,
                      const float* mass, int n, int chunk, int splits,
                      float eps2, float g, float* src4, long long src4_len,
                      float* partial, long long partial_len, float* out,
                      void* stream) {
  const long long padded = static_cast<long long>(chunk) * splits;
  const long long batch =
      splits > 1 ? partial_len / (3LL * splits) : static_cast<long long>(k);
  if (k <= 0 || n <= 0 || chunk <= 0 || chunk % kStage != 0 ||
      splits <= 0 || splits > 65535 || padded < n ||
      padded - chunk >= n || padded > 0x7fffffffLL ||
      4 * padded > src4_len || src4 == nullptr ||
      reinterpret_cast<size_t>(src4) % 16 != 0 ||
      (splits > 1 && (partial == nullptr || batch < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* src = reinterpret_cast<float4*>(src4);
  const int len = static_cast<int>(padded);
  pack_sources_kernel<<<(len + 255) / 256, 256, 0, s>>>(pos, mass, n, len,
                                                        src);
  const bool soft = nbody::softened(eps2);
  for (int k0 = 0; k0 < k; k0 += static_cast<int>(batch)) {
    const int kk = static_cast<int>(
        batch < k - k0 ? batch : static_cast<long long>(k - k0));
    const dim3 grid((kk + kTargetsRows - 1) / kTargetsRows, splits);
    const float* tgt = pos_t + 3LL * k0;
    float* dst = splits > 1 ? partial : out + 3LL * k0;
    if (soft) {
      acc_targets_kernel<true><<<grid, kTargetsThreads, 0, s>>>(
          tgt, kk, src, chunk, eps2, g, dst);
    } else {
      acc_targets_kernel<false><<<grid, kTargetsThreads, 0, s>>>(
          tgt, kk, src, chunk, eps2, g, dst);
    }
    if (splits > 1) {
      sym_reduce_kernel<<<dim3((3 * kk + 255) / 256, 1), 256, 0, s>>>(
          partial, kk, splits, g, out + 3LL * k0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int nbody_sym_tile(void) { return kSymTile; }

int nbody_acc_sym(const float* pos, const float* mass, int n, float eps2,
                  float g, float* partial, long long partial_len, float* out,
                  void* stream) {
  return launch_sym<3>(pos, mass, 1, n, eps2, g, partial, partial_len, out,
                       stream);
}

// K5: tgt8 [G, B, 8] rows, msrc [G, B] weights, partial [G, B/256, B, 3],
// out [G, B, 3].
int nbody_self_force(const float* tgt8, const float* msrc, int G, int B,
                     float eps2, float g, float* partial,
                     long long partial_len, float* out, void* stream) {
  return launch_sym<8>(tgt8, msrc, G, B, eps2, g, partial, partial_len, out,
                       stream);
}

const char* nbody_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
