// Direct-sum gravity kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see nbody_tpu_torch/ops/_build.py).
//
// Both compute, for every target i,
//     a_i = G * sum_j m_j (p_j - p_i) / (|p_j - p_i|^2 + eps^2)^{3/2}
// in fp32, with m_j = 0 for dead and padding sources.  A self or coincident
// pair has d = 0 and so contributes exactly 0; the guard r2 > 0 ? r2 : 1
// keeps rsqrt finite for it when eps = 0 (with eps > 0 it never fires, so it
// is applied always instead of being a separate kernel variant).
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
//     of 128 x 128 particles and writes its two partial sums to a separate
//     slot of a [nt, N, 3] buffer:
//         partial[bj][rows of tile bi] = row sums (force on the targets)
//         partial[bi][cols of tile bj] = -sum_i m_i ir3 d (force on the
//                                        sources), only when bj < bi
//     Diagonal tiles are evaluated in one direction.  Every slot is written
//     exactly once, so the buffer needs no clearing, and sym_reduce_kernel
//     then adds the nt partials of each particle in the fixed order
//     b = 0..nt-1.  No atomics: runs are bit-reproducible.
//
//     Inside an off-diagonal tile pair a lane owns two target rows in
//     registers, and a packet (x, y, z, m, column sums) for one source column
//     rotates around the warp with __shfl_sync: after 32 steps each column
//     has met all 64 rows of the warp and is back at its home lane, with its
//     column sum accumulated in registers.  The warps' column sums are then
//     added in warp order through shared memory.
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
//     lower triangle of 128 x 128 tile pairs.  Scratch: G * B/128 * B * 3
//     floats (0.8 GB at the 1M tier, G = 128, B = 8192).
//
// What bounds them on the card: not bytes.  A tile pair reads 4 KB and
// performs 16384 pair evaluations.  K2 is bound by FP32 instruction
// throughput (about 14 FP32 instructions a pair) beside the MUFU rsqrt (16
// a clock per SM).  K1 spends about 17 FP32 instructions a pair for two
// ordered pairs, and 7 warp shuffles per 64 pairs, so FP32 throughput stays
// the bound.  The partial buffer of K1 adds 2 * nt * N * 12 bytes of traffic
// (0.8 GB at N = 65536), a small share of the kernel's time; making these
// fast (register blocking, fewer partials, persistent blocks) is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTargetsThreads = 128;          // K2: targets per block
constexpr int kSymTile = 128;                 // K1: rows = cols of a tile pair
constexpr int kSymWarps = 2;                  // K1: warps per block
constexpr int kSymRows = kSymTile / (32 * kSymWarps);  // K1: rows per lane
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
// floats follow group g - 1's.
template <int kStride>
__global__ void __launch_bounds__(kSymWarps * 32)
acc_sym_tiles_kernel(const float* __restrict__ pos,
                     const float* __restrict__ mass, int n, float eps2,
                     float* __restrict__ partial) {
  __shared__ float4 src[kSymTile];                  // diagonal tiles
  __shared__ float colsum[kSymWarps][kSymTile][3];  // off-diagonal tiles
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

  int row[kSymRows];
  float xi[kSymRows], yi[kSymRows], zi[kSymRows], mi[kSymRows];
  float ax[kSymRows], ay[kSymRows], az[kSymRows];
#pragma unroll
  for (int r = 0; r < kSymRows; ++r) {
    row[r] = bi * kSymTile + (warp * kSymRows + r) * 32 + lane;
    const bool ok = row[r] < n;
    xi[r] = ok ? pos[kStride * row[r]] : 0.f;
    yi[r] = ok ? pos[kStride * row[r] + 1] : 0.f;
    zi[r] = ok ? pos[kStride * row[r] + 2] : 0.f;
    mi[r] = ok ? mass[row[r]] : 0.f;
    ax[r] = ay[r] = az[r] = 0.f;
  }

  if (bi == bj) {
    // diagonal tile: every ordered pair of it is native here, one direction
    for (int t = threadIdx.x; t < kSymTile; t += kSymWarps * 32) {
      const int j = bj * kSymTile + t;
      src[t] = j < n ? make_float4(pos[kStride * j], pos[kStride * j + 1],
                                   pos[kStride * j + 2], mass[j])
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();
    const int cnt = min(kSymTile, n - bj * kSymTile);
    for (int t = 0; t < cnt; ++t) {
      const float4 s = src[t];
#pragma unroll
      for (int r = 0; r < kSymRows; ++r) {
        const float dx = s.x - xi[r], dy = s.y - yi[r], dz = s.z - zi[r];
        const float w = inv_r3(dx, dy, dz, eps2) * s.w;
        ax[r] = fmaf(w, dx, ax[r]);
        ay[r] = fmaf(w, dy, ay[r]);
        az[r] = fmaf(w, dz, az[r]);
      }
    }
  } else {
    // strictly below the diagonal: one evaluation serves both directions
    for (int c = 0; c < kSymTile / 32; ++c) {
      const int j = bj * kSymTile + c * 32 + lane;
      const bool ok = j < n;
      float xj = ok ? pos[kStride * j] : 0.f;
      float yj = ok ? pos[kStride * j + 1] : 0.f;
      float zj = ok ? pos[kStride * j + 2] : 0.f;
      float mj = ok ? mass[j] : 0.f;
      float cx = 0.f, cy = 0.f, cz = 0.f;
#pragma unroll 4
      for (int step = 0; step < 32; ++step) {
#pragma unroll
        for (int r = 0; r < kSymRows; ++r) {
          const float dx = xj - xi[r], dy = yj - yi[r], dz = zj - zi[r];
          const float ir3 = inv_r3(dx, dy, dz, eps2);
          const float w = ir3 * mj;
          ax[r] = fmaf(w, dx, ax[r]);
          ay[r] = fmaf(w, dy, ay[r]);
          az[r] = fmaf(w, dz, az[r]);
          const float wc = ir3 * mi[r];
          cx = fmaf(-wc, dx, cx);
          cy = fmaf(-wc, dy, cy);
          cz = fmaf(-wc, dz, cz);
        }
        // rotate the column packet one lane down; after 32 steps it is home
        const int from = (lane + 1) & 31;
        xj = __shfl_sync(kFullMask, xj, from);
        yj = __shfl_sync(kFullMask, yj, from);
        zj = __shfl_sync(kFullMask, zj, from);
        mj = __shfl_sync(kFullMask, mj, from);
        cx = __shfl_sync(kFullMask, cx, from);
        cy = __shfl_sync(kFullMask, cy, from);
        cz = __shfl_sync(kFullMask, cz, from);
      }
      colsum[warp][c * 32 + lane][0] = cx;
      colsum[warp][c * 32 + lane][1] = cy;
      colsum[warp][c * 32 + lane][2] = cz;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < kSymTile; t += kSymWarps * 32) {
      const int j = bj * kSymTile + t;
      if (j < n) {
        float* dst = partial + static_cast<size_t>(bi) * slot + 3 * j;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          float s = 0.f;
#pragma unroll
          for (int w = 0; w < kSymWarps; ++w) s += colsum[w][t][d];
          dst[d] = s;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kSymRows; ++r) {
    if (row[r] < n) {
      float* dst = partial + static_cast<size_t>(bj) * slot + 3 * row[r];
      dst[0] = ax[r];
      dst[1] = ay[r];
      dst[2] = az[r];
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
  const long long pairs = nt * (nt + 1) / 2;
  acc_sym_tiles_kernel<kStride>
      <<<dim3(static_cast<unsigned>(pairs), groups), kSymWarps * 32, 0, s>>>(
          pos, mass, n, eps2, partial);
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

// K5: tgt8 [G, B, 8] rows, msrc [G, B] weights, partial [G, B/128, B, 3],
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
