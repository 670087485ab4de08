// Barnes-Hut group-force kernels for Hopper (sm_90a), bound through a plain
// C interface (ctypes; see nbody_tpu_torch/ops/_build.py).
//
// Each BH group's B targets are evaluated against that group's assembled
// source slab.  Targets are 8-wide rows (x, y, z, m, idx, 0, 0, 0) [G, B, 8].
//
// K3  group_force_kernel  replaces nbody_tpu/ops/group_force.py
//     group_force_pallas (kernels _kernel and _kernel_masked):
//         a_i = G * sum_j m_j d_ij / (|d_ij|^2 + eps^2)^{3/2}
//     over 8-wide source rows [G, S, 8] (window, near and, for monopole
//     runs, accepted-node rows).  The masked variant takes the block-dual
//     mask [G, B/TI, S/tile] (bytes) and skips every (target, source) pair
//     whose entry mask[g, row / TI, col / tile] is set: those pairs ride the
//     source tile's quadrupole (K4) instead.  TI and tile are the grid the
//     mask was built on; the lookup is per row and per column, so any TI
//     and tile that divide B and S work with this kernel's own blocks.
//
// K4  quad_force_kernel  replaces nbody_tpu/ops/group_force.py
//     quad_force_pallas (kernel _quad_kernel):
//         a = G [ M e/r^3 - Q e/r^5 + 5/2 (e^T Q e) e/r^7 ]
//     over 16-wide traceless-quadrupole rows (x, y, z, M, Qxx, Qyy, Qzz,
//     Qxy, Qxz, Qyz, 0...) [G, A, 16].
//
// Structure (both): one block per (128-target chunk, group), one thread per
// target holding it in registers; the block streams the group's source rows
// through shared memory 128 at a time, loading only the columns the force
// law reads (x, y, z, m: one float4; K4 adds the six Q columns).  A staged
// chunk whose masses are all zero is skipped (__syncthreads_or): slabs are
// prefix-compacted and mostly padding at their caps.  Skipping zero-mass
// rows changes no bit of the result, so a slab padded with empty tiles
// gives bitwise the same forces.  Every target adds each chunk's sources in
// order into a partial sum that starts from zero, adds the partials in chunk
// order (a two-level sum: its rounding grows with 128 + S/128 terms, not S)
// and multiplies by G at the end, as the TPU wrappers do: no atomics, so
// runs are bit-reproducible.
//
// No self-pair index test: a self or coincident pair has d = 0 and adds
// exactly 0 once r^2 == 0 is replaced by 1.  The guard is applied always
// (with eps > 0 it never fires); the TPU's lax.cond split on eps, its
// (1, 128) VMEM scalar row and its (8, 128)-expanded mask are gone.
//
// What bounds them on the card: FP32 instruction issue, not bytes.  A staged
// chunk of 128 rows (2 KB for K3, 5 KB for K4) serves 128 x 128 pair
// evaluations; K3 spends ~14 FP32 instructions and one MUFU rsqrt a pair,
// K4 ~40 and a double-precision rsqrt.  At the 1M bh tier K3 evaluates
// ~1e10 pairs a step.  Register blocking (several targets a thread) and
// wider staging are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;  // targets per block = source rows per stage

__global__ void __launch_bounds__(kThreads)
group_force_kernel(const float* __restrict__ tgt8,
                   const float* __restrict__ slab,
                   const unsigned char* __restrict__ mask, int B, int S,
                   int ti, int tile, int st, float eps2, float g,
                   float* __restrict__ out) {
  __shared__ float4 src[kThreads];
  const int grp = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < B;
  const float* t = tgt8 + (static_cast<size_t>(grp) * B + (active ? row : 0)) * 8;
  const float xi = t[0], yi = t[1], zi = t[2];
  const float* rows = slab + static_cast<size_t>(grp) * S * 8;
  // this target's row of the mask: one byte per source tile
  const unsigned char* mrow =
      mask == nullptr
          ? nullptr
          : mask + (static_cast<size_t>(grp) * (B / ti) + (active ? row : 0) / ti) * st;

  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < S; base += kThreads) {
    const int cnt = min(kThreads, S - base);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (static_cast<int>(threadIdx.x) < cnt) {
      v = *reinterpret_cast<const float4*>(
          rows + static_cast<size_t>(base + threadIdx.x) * 8);
    }
    src[threadIdx.x] = v;
    if (__syncthreads_or(v.w != 0.f)) {
      // the chunk's partial sum starts from zero and joins the total once
      float cx = 0.f, cy = 0.f, cz = 0.f;
      // split the chunk at source-tile boundaries: each segment has one mask
      // entry for this target
      int j = 0;
      while (j < cnt) {
        const int col = base + j;
        const int end = min(cnt, (col / tile + 1) * tile - base);
        if (mrow == nullptr || mrow[col / tile] == 0) {
          for (int k = j; k < end; ++k) {
            const float4 s = src[k];
            const float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
            float r2 = dx * dx + dy * dy + dz * dz + eps2;
            r2 = r2 > 0.f ? r2 : 1.f;
            const float ir = rsqrtf(r2);
            const float w = ir * ir * ir * s.w;
            cx = fmaf(w, dx, cx);
            cy = fmaf(w, dy, cy);
            cz = fmaf(w, dz, cz);
          }
        }
        j = end;
      }
      ax += cx;
      ay += cy;
      az += cz;
    }
    __syncthreads();
  }
  if (active) {
    float* o = out + (static_cast<size_t>(grp) * B + row) * 3;
    o[0] = ax * g;
    o[1] = ay * g;
    o[2] = az * g;
  }
}

__global__ void __launch_bounds__(kThreads)
quad_force_kernel(const float* __restrict__ tgt8,
                  const float* __restrict__ qslab, int B, int A, float eps2,
                  float g, float* __restrict__ out) {
  __shared__ float4 s_pm[kThreads];  // x, y, z, M
  __shared__ float4 s_q0[kThreads];  // Qxx, Qyy, Qzz, Qxy
  __shared__ float2 s_q1[kThreads];  // Qxz, Qyz
  const int grp = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < B;
  const float* t = tgt8 + (static_cast<size_t>(grp) * B + (active ? row : 0)) * 8;
  const float xi = t[0], yi = t[1], zi = t[2];
  const float* rows = qslab + static_cast<size_t>(grp) * A * 16;

  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int base = 0; base < A; base += kThreads) {
    const int cnt = min(kThreads, A - base);
    float4 pm = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 q0 = pm;
    float2 q1 = make_float2(0.f, 0.f);
    if (static_cast<int>(threadIdx.x) < cnt) {
      const float* r = rows + static_cast<size_t>(base + threadIdx.x) * 16;
      pm = *reinterpret_cast<const float4*>(r);
      q0 = *reinterpret_cast<const float4*>(r + 4);
      q1 = *reinterpret_cast<const float2*>(r + 8);
    }
    s_pm[threadIdx.x] = pm;
    s_q0[threadIdx.x] = q0;
    s_q1[threadIdx.x] = q1;
    if (__syncthreads_or(pm.w != 0.f)) {
      float cx = 0.f, cy = 0.f, cz = 0.f;  // the chunk's partial sum
      for (int k = 0; k < cnt; ++k) {
        const float4 s = s_pm[k];
        const float4 qa = s_q0[k];
        const float2 qb = s_q1[k];
        const float ex = s.x - xi, ey = s.y - yi, ez = s.z - zi;
        float r2 = ex * ex + ey * ey + ez * ez + eps2;
        const bool ok = r2 > 0.f;
        r2 = ok ? r2 : 1.f;
        // 1/r correctly rounded (double-precision rsqrt): the quadrupole
        // terms raise it to the 7th power, which multiplies the 2-ulp error
        // of rsqrtf seven-fold
        const float ir = static_cast<float>(rsqrt(static_cast<double>(r2)));
        const float ir2 = ir * ir;
        const float ir3 = ir2 * ir;
        float ir5 = ir3 * ir2;
        const float ir7 = ir5 * ir2;
        // Q = [[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]]
        const float ux = qa.x * ex + qa.w * ey + qb.x * ez;
        const float uy = qa.w * ex + qa.y * ey + qb.y * ez;
        const float uz = qb.x * ex + qb.y * ey + qa.z * ez;
        const float qe = ex * ux + ey * uy + ez * uz;
        float w = s.w * ir3 + 2.5f * qe * ir7;
        if (!ok) {
          w = 0.f;
          ir5 = 0.f;
        }
        cx += w * ex - ir5 * ux;
        cy += w * ey - ir5 * uy;
        cz += w * ez - ir5 * uz;
      }
      ax += cx;
      ay += cy;
      az += cz;
    }
    __syncthreads();
  }
  if (active) {
    float* o = out + (static_cast<size_t>(grp) * B + row) * 3;
    o[0] = ax * g;
    o[1] = ay * g;
    o[2] = az * g;
  }
}

bool grid_ok(int G, int B) { return G > 0 && G <= 65535 && B > 0; }

}  // namespace

extern "C" {

// Each entry point launches on `stream`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 = launched).

int nbody_group_force(const float* tgt8, const float* slab,
                      const unsigned char* mask, int G, int B, int S, int ti,
                      int tile, int st, float eps2, float g, float* out,
                      void* stream) {
  if (!grid_ok(G, B) || S <= 0 || tile <= 0 || S % tile != 0 || ti <= 0 ||
      B % ti != 0 || (mask != nullptr && st != S / tile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((B + kThreads - 1) / kThreads, G);
  group_force_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tgt8, slab, mask, B, S, ti, tile, st, eps2, g, out);
  return static_cast<int>(cudaGetLastError());
}

int nbody_quad_force(const float* tgt8, const float* qslab, int G, int B,
                     int A, float eps2, float g, float* out, void* stream) {
  if (!grid_ok(G, B) || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kThreads - 1) / kThreads, G);
  quad_force_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tgt8, qslab, B, A, eps2, g, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
