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
//     mask was built on; tile is a multiple of the 128-row stage, so a
//     stage lies in one source tile and the lookup is one byte per (target
//     row, stage), whatever TI is.
//
//     What bounds it on the card: instruction issue.  A stage of 128 rows
//     (2 KB) serves 128 x 128 pair evaluations, so bytes are no limit, and
//     the MUFU rsqrt (16 a clock per SM) is one in every ~14 instructions.
//     The design keeps the instructions a pair few (SASS:
//     scripts/torch_kernel_profile.py; PERF.md):
//       - it is specialised on eps (softened.cuh): at eps > 0 the r == 0
//         guard and rsqrtf's subnormal scaling, five FP32 instructions a
//         pair, are left out, and eps^2 seeds the first FMA of r^2: 12
//         FP32, one MUFU and one broadcast shared load a pair;
//       - each stage is a fully unrolled loop of fixed length (128; the
//         slab's tail is zero-filled, and zero-mass rows add exactly 0), so
//         no loop control runs per pair;
//       - the mask is looked up once per (target, stage), and a masked
//         stage is skipped whole: the mask's source tile is a multiple of
//         the stage, so a stage lies in one tile;
//       - the next stage is fetched with cp.async into the other half of a
//         double buffer while this one is evaluated.
//     One target a thread: holding 2, 4 or 8 targets a thread (one shared
//     load for several pairs) measured slower on the card at both main-path
//     shapes, as the registers it takes cut the resident warps.
//     A stage whose masses are all zero is skipped (__syncthreads_or):
//     slabs are prefix-compacted and mostly padding at their caps; skipping
//     zero-mass rows changes no bit, so a slab padded with empty tiles gives
//     bitwise the same forces.
//
//     Summation order: every target adds each stage's sources in order into
//     a partial that starts from zero, and adds the partials in stage order
//     (a two-level sum: its rounding grows with 128 + S/128 terms, not S),
//     then multiplies by G.  No atomics: runs are bit-reproducible.
//
// K4  quad_force_kernel  replaces nbody_tpu/ops/group_force.py
//     quad_force_pallas (kernel _quad_kernel):
//         a = G [ M e/r^3 - Q e/r^5 + 5/2 (e^T Q e) e/r^7 ]
//     over 16-wide traceless-quadrupole rows (x, y, z, M, Qxx, Qyy, Qzz,
//     Qxy, Qxz, Qyz, 0...) [G, A, 16].  One block per (128-target chunk,
//     group), one thread per target; the block streams the source rows
//     through shared memory 128 at a time (x, y, z, M and the six Q
//     columns), skips zero-mass stages and adds two-level sums as K3 does.
//     What bounds it: FP32 issue (~40 instructions a pair) and its
//     double-precision rsqrt: 1/r correctly rounded, because the
//     quadrupole terms raise it to the 7th power.
//
// No self-pair index test in either: a self or coincident pair has d = 0
// and adds exactly 0 (softened.cuh); the TPU's lax.cond split on eps, its
// (1, 128) VMEM scalar row and its (8, 128)-expanded mask are gone.

#include <cuda_runtime.h>
#include <stddef.h>

#include "softened.cuh"

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kChunk = 128;    // source rows per stage, one copied a thread
static_assert(kThreads == kChunk, "each thread stages one source row");

__device__ __forceinline__ void cp_async16(float4* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage source rows [base, base + kChunk) of a group's slab: (x, y, z, m),
// zero-filled past S.
__device__ __forceinline__ void stage_rows(float4* dst, const float* rows,
                                           int base, int S) {
  const int j = base + static_cast<int>(threadIdx.x);
  cp_async16(dst + threadIdx.x,
             rows + static_cast<size_t>(j < S ? j : S - 1) * 8,
             j < S ? 16 : 0);
}

// One thread per target row; one block: kThreads rows of group blockIdx.y.
template <bool kSoft, bool kMasked>
__global__ void __launch_bounds__(kThreads)
group_force_kernel(const float* __restrict__ tgt8,
                   const float* __restrict__ slab,
                   const unsigned char* __restrict__ mask, int B, int S,
                   int ti, int tile, int st, float eps2, float g,
                   float* __restrict__ out) {
  __shared__ float4 stage[2][kChunk];
  const int grp = blockIdx.y;
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool active = row < B;
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
  if (active) {
    t = *reinterpret_cast<const float4*>(
        tgt8 + (static_cast<size_t>(grp) * B + row) * 8);
  }
  const float xi = t.x, yi = t.y, zi = t.z;
  // this target's row of the mask: one byte per source tile
  const unsigned char* mrow =
      kMasked ? mask + (static_cast<size_t>(grp) * (B / ti) +
                        (active ? row : 0) / ti) * st
              : nullptr;
  const float* rows = slab + static_cast<size_t>(grp) * S * 8;
  const int chunks = (S + kChunk - 1) / kChunk;
  stage_rows(stage[0], rows, 0, S);
  cp_async_commit();
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_all();
    const float4* src = stage[c & 1];
    // the barrier that publishes stage c also tells whether it has mass,
    // and that every thread is done with stage c - 1, whose buffer the
    // next fetch overwrites
    const bool live = __syncthreads_or(src[threadIdx.x].w != 0.f);
    if (c + 1 < chunks) {
      stage_rows(stage[(c + 1) & 1], rows, (c + 1) * kChunk, S);
    }
    cp_async_commit();
    if (!live || (kMasked && mrow[c * kChunk / tile] != 0)) continue;
    // the stage's partial sum starts from zero and joins the total once
    float cx = 0.f, cy = 0.f, cz = 0.f;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const float4 s = src[k];
      const float dx = s.x - xi, dy = s.y - yi, dz = s.z - zi;
      const float w = nbody::softened_ir3<kSoft>(dx, dy, dz, eps2) * s.w;
      cx = fmaf(w, dx, cx);
      cy = fmaf(w, dy, cy);
      cz = fmaf(w, dz, cz);
    }
    ax += cx;
    ay += cy;
    az += cz;
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

int nbody_k3_stage(void) { return kChunk; }

// K3.  A masked call needs tile to be a multiple of the 128-row stage.
int nbody_group_force(const float* tgt8, const float* slab,
                      const unsigned char* mask, int G, int B, int S, int ti,
                      int tile, int st, float eps2, float g, float* out,
                      void* stream) {
  if (!grid_ok(G, B) || S <= 0 || tile <= 0 || S % tile != 0 || ti <= 0 ||
      B % ti != 0 ||
      (mask != nullptr && (st != S / tile || tile % kChunk != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kThreads - 1) / kThreads, G);
  const bool soft = nbody::softened(eps2);
  if (mask != nullptr) {
    if (soft) {
      group_force_kernel<true, true><<<grid, kThreads, 0, s>>>(
          tgt8, slab, mask, B, S, ti, tile, st, eps2, g, out);
    } else {
      group_force_kernel<false, true><<<grid, kThreads, 0, s>>>(
          tgt8, slab, mask, B, S, ti, tile, st, eps2, g, out);
    }
  } else if (soft) {
    group_force_kernel<true, false><<<grid, kThreads, 0, s>>>(
        tgt8, slab, mask, B, S, ti, tile, st, eps2, g, out);
  } else {
    group_force_kernel<false, false><<<grid, kThreads, 0, s>>>(
        tgt8, slab, mask, B, S, ti, tile, st, eps2, g, out);
  }
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
