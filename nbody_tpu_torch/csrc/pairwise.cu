// Direct-sum gravity kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see nbody_tpu_torch/ops/_build.py).
//
// All compute, for every target i,
//     a_i = G * sum_j m_j (p_j - p_i) / (|p_j - p_i|^2 + eps^2)^{3/2}
// in fp32, with m_j = 0 for dead and padding sources.  A self or coincident
// pair has d = 0 and so contributes exactly 0.  K2 applies the guard
// r2 > 0 ? r2 : 1 always (with eps > 0 it never fires); K1 and K5 are
// specialised on eps and apply it only at eps = 0 (softened.cuh).
//
// K2  acc_targets_kernel  replaces nbody_tpu/ops/pairwise.py
//     pairwise_acc_pallas_targets (and pairwise_acc_pallas, the K = N case):
//     K targets x N sources, one direction.  One thread owns one target in
//     registers; the block walks the sources in order, staging 128 of them
//     at a time in shared memory as float4 (x, y, z, m).  Every target adds
//     its sources in the same order j = 0..N-1 whatever its place in the
//     target set, so a sampled-target call is bitwise equal to the matching
//     rows of the full call.
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
// of K1 reads 8 KB and evaluates 32768 unordered pairs; the MUFU rsqrt (16 a
// clock per SM) is one in every ~18 instructions.  K2 issues ~21
// instructions a pair (SASS: scripts/torch_kernel_profile.py; PERF.md).
// K1 and K5 keep theirs few: eight rows a lane let one rotation of the
// 7-float packet serve eight pairs (7/8 shuffle a pair), and the
// specialisation on eps (softened.cuh) leaves out the r == 0 guard and
// rsqrtf's subnormal scaling at eps > 0: 16 FP32 instructions and one MUFU
// a pair.  Each block holds 256 rows of positions, masses and sums in
// registers (two blocks an SM).  The 256-wide tiles keep the partial
// buffer to 2 * nt * N * 12 bytes of traffic (0.4 GB at N = 65536), about
// a twentieth of K1's time with its reduction.

#include <cuda_runtime.h>
#include <stddef.h>

#include "softened.cuh"

namespace {

constexpr int kTargetsThreads = 128;  // K2: targets per block
constexpr int kSymTile = 256;         // K1: rows = cols of a tile pair
constexpr int kSymRows = kSymTile / 32;   // K1: rows per lane (all of bi's)
constexpr int kSymWarps = kSymTile / 32;  // K1: warps, 32 columns each
constexpr int kSymThreads = 32 * kSymWarps;  // = kSymTile: a row each to add
static_assert(kSymThreads == kSymTile, "one thread per row in the row sums");
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float inv_r3(float dx, float dy, float dz,
                                        float eps2) {
  float r2 = dx * dx + dy * dy + dz * dz + eps2;
  r2 = r2 > 0.f ? r2 : 1.f;
  const float ir = rsqrtf(r2);
  return ir * ir * ir;
}

__global__ void __launch_bounds__(kTargetsThreads)
acc_targets_kernel(const float* __restrict__ pos_t, int k,
                   const float* __restrict__ pos,
                   const float* __restrict__ mass, int n, float eps2, float g,
                   float* __restrict__ out) {
  __shared__ float4 src[kTargetsThreads];
  const int i = blockIdx.x * kTargetsThreads + threadIdx.x;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  if (i < k) {
    xi = pos_t[3 * i];
    yi = pos_t[3 * i + 1];
    zi = pos_t[3 * i + 2];
  }
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < n; base += kTargetsThreads) {
    const int j = base + threadIdx.x;
    if (j < n) {
      src[threadIdx.x] =
          make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], mass[j]);
    }
    __syncthreads();
    const int cnt = min(kTargetsThreads, n - base);
    for (int t = 0; t < cnt; ++t) {
      const float4 s = src[t];
      const float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
      const float w = inv_r3(dx, dy, dz, eps2) * s.w;
      ax = fmaf(w, dx, ax);
      ay = fmaf(w, dy, ay);
      az = fmaf(w, dz, az);
    }
    __syncthreads();
  }
  if (i < k) {
    out[3 * i] = ax * g;
    out[3 * i + 1] = ay * g;
    out[3 * i + 2] = az * g;
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

int nbody_acc_targets(const float* pos_t, int k, const float* pos,
                      const float* mass, int n, float eps2, float g,
                      float* out, void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (k + kTargetsThreads - 1) / kTargetsThreads;
  acc_targets_kernel<<<blocks, kTargetsThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pos_t, k, pos, mass, n, eps2, g, out);
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
