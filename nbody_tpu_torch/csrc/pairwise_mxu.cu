// Norm-trick all-pairs gravity for Hopper (sm_90a), bound through a plain C
// interface (ctypes; see nbody_tpu_torch/ops/_build.py).
//
// K6  acc_mxu_kernel  replaces nbody_tpu/ops/pairwise.py
//     pairwise_acc_pallas_mxu (kernel _kernel_mxu): the direct sum over
//     Morton-sorted particles with r^2 from the norm trick about an anchor
//     shared by one (target tile, source tile) pair,
//         c     = (p[I * tile_i] + p[J * tile_j]) / 2
//         r^2   = |p_i - c|^2 + |p_j - c|^2 - 2 (p_i - c).(p_j - c) + eps^2
//         A     = sum_{j in J} s_ij [p_j - c, 1],  s_ij = m_j / r^3
//         a_i  += A_xyz - (p_i - c) A_1          (source tiles J in order)
//     with a pair skipped when j == i or r^2 <= 0, and G applied at the end.
//     The anchor grid (tile_i x tile_j, 512 x 1024 after the shrink rule of
//     the TPU wrapper) is part of what the function computes: the rounding
//     of the norm trick depends on it.  So the kernel takes tile_i and
//     tile_j as the caller's grid, whatever its own block shape, as K3
//     takes the block-dual mask grid.
//
// Structure: one block per `rows` consecutive targets (128, or a divisor of
// tile_i: every row of a block lies in one target tile I), one thread per
// target.  The block streams the sources `rows` at a time through shared
// memory; the staging thread of source j already subtracts j's anchor (its
// tile J against the block's tile I) and forms |p_j - c|^2, so a pair costs
// the cross product, r^2, one rsqrt and four accumulations.  A staged chunk
// is split where J changes; there each thread folds its tile sum A into its
// total and re-centres its own row on the next anchor.  Each chunk's part of
// A, then each J tile's A, starts from zero and is added once, in order (J
// tiles in the TPU kernel's grid order).  No atomics: runs are
// bit-reproducible.
//
// Full fp32 on the CUDA cores.  The TPU kernel ran its two products on the
// MXU at HIGHEST precision; tensor-core TF32 or bf16 products are wrong for
// r^2 (the cancellation of the norm trick magnifies their rounding), and a
// 3xTF32 split that keeps fp32 accuracy is later work.
//
// What bounds it on the card: FP32 instruction issue, not bytes (a staged
// chunk of 128 sources, 2.5 KB, serves 128 x 128 pairs at ~22 operations and
// one MUFU rsqrt each; the explicitly rounded r^2 costs two operations a pair
// over a contracted one).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMxuThreads = 128;  // most targets per block = sources per stage

// The norm-trick terms are formed with explicitly rounded operations, never
// contracted into FMAs: the same sequence of roundings as the plain twin's
// element-wise torch ops (ops/pairwise.py pairwise_acc_mxu_plain), so the
// kernel and the twin see the same r^2 and differ only in how the sums
// are ordered.  The cancellation in r^2 would magnify any other difference.
__device__ __forceinline__ float anchor(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__global__ void __launch_bounds__(kMxuThreads)
acc_mxu_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
               int n, int tile_i, int tile_j, float eps2, float g,
               float* __restrict__ out) {
  __shared__ float4 src[kMxuThreads];  // (p_j - c, |p_j - c|^2)
  __shared__ float src_m[kMxuThreads];
  const int rows = blockDim.x;
  const int t = threadIdx.x;
  const int i = blockIdx.x * rows + t;
  const bool active = i < n;
  // the block's target tile I and its anchor row
  const int i0 = (blockIdx.x * rows / tile_i) * tile_i;
  const float ax = pos[3 * i0], ay = pos[3 * i0 + 1], az = pos[3 * i0 + 2];
  const float xi = active ? pos[3 * i] : 0.f;
  const float yi = active ? pos[3 * i + 1] : 0.f;
  const float zi = active ? pos[3 * i + 2] : 0.f;

  float ox = 0.f, oy = 0.f, oz = 0.f;        // the total
  float sx = 0.f, sy = 0.f, sz = 0.f, s1 = 0.f;  // this J tile's A
  float px = 0.f, py = 0.f, pz = 0.f, n2i = 0.f;  // p_i - c, |p_i - c|^2
  int cur = -1;                               // the J tile being summed

  for (int base = 0; base < n; base += rows) {
    const int cnt = min(rows, n - base);
    if (t < cnt) {
      const int j = base + t;
      const int j0 = (j / tile_j) * tile_j;
      const float qx = pos[3 * j] - anchor(ax, pos[3 * j0]);
      const float qy = pos[3 * j + 1] - anchor(ay, pos[3 * j0 + 1]);
      const float qz = pos[3 * j + 2] - anchor(az, pos[3 * j0 + 2]);
      src[t] = make_float4(qx, qy, qz, dot3(qx, qy, qz, qx, qy, qz));
      src_m[t] = mass[j];
    }
    __syncthreads();
    int k = 0;
    while (k < cnt) {
      const int tile = (base + k) / tile_j;
      const int end = min(cnt, (tile + 1) * tile_j - base);
      if (tile != cur) {
        if (cur >= 0) {
          ox += sx - px * s1;
          oy += sy - py * s1;
          oz += sz - pz * s1;
        }
        cur = tile;
        sx = sy = sz = s1 = 0.f;
        const int j0 = tile * tile_j;
        px = xi - anchor(ax, pos[3 * j0]);
        py = yi - anchor(ay, pos[3 * j0 + 1]);
        pz = zi - anchor(az, pos[3 * j0 + 2]);
        n2i = dot3(px, py, pz, px, py, pz);
      }
      // this segment's partial sum starts from zero and joins the tile's
      // once (a two-level sum: its rounding grows with 128 + tile_j / 128
      // terms, not tile_j, before the fold's cancellation magnifies it)
      float cx = 0.f, cy = 0.f, cz = 0.f, c1 = 0.f;
      for (; k < end; ++k) {
        const float4 q = src[k];
        const float cross = dot3(px, py, pz, q.x, q.y, q.z);
        const float r2 = __fadd_rn(
            __fsub_rn(__fadd_rn(n2i, q.w), __fmul_rn(2.f, cross)), eps2);
        const bool skip = (base + k == i) || (r2 <= 0.f);
        const float ir = rsqrtf(skip ? 1.f : r2);
        const float s = skip ? 0.f : ir * ir * ir * src_m[k];
        cx = fmaf(s, q.x, cx);
        cy = fmaf(s, q.y, cy);
        cz = fmaf(s, q.z, cz);
        c1 += s;
      }
      sx += cx;
      sy += cy;
      sz += cz;
      s1 += c1;
    }
    __syncthreads();
  }
  if (active) {
    ox += sx - px * s1;
    oy += sy - py * s1;
    oz += sz - pz * s1;
    out[3 * i] = ox * g;
    out[3 * i + 1] = oy * g;
    out[3 * i + 2] = oz * g;
  }
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 = launched).  pos [n, 3], mass [n], out [n, 3];
// tile_i and tile_j divide n; `rows` (the block's targets) divides tile_i,
// or tile_i == n.
int nbody_acc_mxu(const float* pos, const float* mass, int n, int tile_i,
                  int tile_j, int rows, float eps2, float g, float* out,
                  void* stream) {
  if (n <= 0 || tile_i <= 0 || tile_j <= 0 || n % tile_i != 0 ||
      n % tile_j != 0 || rows <= 0 || rows > kMxuThreads ||
      (tile_i % rows != 0 && tile_i != n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  acc_mxu_kernel<<<(n + rows - 1) / rows, rows, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      pos, mass, n, tile_i, tile_j, eps2, g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
