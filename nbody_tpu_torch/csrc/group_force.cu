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
//     Qxy, Qxz, Qyz, 0...) [G, A, 16].  One block per (256-target chunk,
//     group), two targets a thread: one staged row feeds two pairs (on the
//     1M shapes 0.41 ms, against 0.49 with one and 0.42 with four, whose
//     registers cost resident warps; PERF.md).
//
//     What bounds it on the card: FP32 issue, ~40 FP32 instructions a pair
//     against one MUFU rsqrt and three broadcast shared loads.  The design:
//       - 1/r in f32 (rsqrt_rn): the MUFU estimate and one correction,
//         which give the bits of the twin's (float)rsqrt((double)r^2) for
//         all but a few positive normal floats and never differ by more
//         than 1 ulp (nbody_rsqrt_sweep; PERF.md): the quadrupole terms
//         raise 1/r to the 7th power, which multiplies rsqrtf's 2-ulp
//         error seven-fold, and the double rsqrt it replaces ran on the
//         FP64 pipe (half the FP32 rate) with two conversions;
//       - specialised on eps as K3 is: at eps^2 >= FLT_MIN no r == 0 guard
//         and eps^2 seeds the first FMA of r^2; eps = 0 keeps the guard;
//       - each 128-row stage is evaluated up to its last massive row,
//         rounded up to an unrolled sub-chunk of 8 rows (four ballots a
//         warp find it): zero-mass rows carry Q = 0 and add exactly +-0,
//         so no output bit moves, and a stage with no mass is skipped;
//       - the rows (x, y, z, M and the six Q, 48 bytes) arrive by cp.async
//         into a double buffer while the stage before is evaluated: one
//         barrier a stage.
//     Summation order as K3: each stage's partial from zero, the partials
//     in stage order.

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

// 1/r in f32 with the bits of (float)rsqrt((double)x) for (nearly) every
// positive normal x: the MUFU estimate y (rsqrt.approx, ~2^-22.9 relative
// error), then one correction from the residual e = 1 - x y^2, formed
// without cancellation (x y = h + hl exactly, by an FMA), and
// y (1 + e/2 + 3e^2/8) rounded once by the last FMA.  Seven FP32
// instructions beside the MUFU, where the double rsqrt took the FP64 pipe
// (half the FP32 rate) and two conversions.  nbody_rsqrt_sweep counts the
// positive normal floats where the two differ.
__device__ __forceinline__ float rsqrt_rn(float x) {
  const float y = nbody::rsqrt_ftz(x);
  const float h = x * y;
  const float hl = fmaf(x, y, -h);
  const float e = fmaf(-y, hl, fmaf(-y, h, 1.f));
  return fmaf(y * fmaf(0.375f, e, 0.5f), e, y);
}

constexpr int kQuadUnroll = 8;   // rows of an unrolled sub-chunk
constexpr int kQuadTargets = 2;  // targets a thread

// Stage quadrupole rows [base, base + kChunk) of a group's slab: the first
// 48 bytes of each 64-byte row (x, y, z, M | Qxx, Qyy, Qzz, Qxy | Qxz, Qyz,
// 0, 0), zero-filled past A.
__device__ __forceinline__ void stage_quad(float4 (*dst)[kChunk],
                                           const float* rows, int base,
                                           int A) {
  const int j = base + static_cast<int>(threadIdx.x);
  const float* r = rows + static_cast<size_t>(j < A ? j : A - 1) * 16;
  const int bytes = j < A ? 16 : 0;
#pragma unroll
  for (int c = 0; c < 3; ++c) cp_async16(&dst[c][threadIdx.x], r + 4 * c, bytes);
}

// The rows of a staged chunk that can add anything: up to its last massive
// row, rounded up to the unroll width (0: the chunk has no mass).  Each
// warp reads the chunk's 128 masses itself (four ballots), so no barrier
// is needed beyond the one that published the chunk.
__device__ __forceinline__ int live_rows(const float4* pm) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  int last = -1;
#pragma unroll
  for (int w = 0; w < kChunk / 32; ++w) {
    const unsigned b = __ballot_sync(0xffffffffu, pm[w * 32 + lane].w != 0.f);
    if (b) last = w * 32 + 31 - __clz(b);
  }
  return (last + kQuadUnroll) / kQuadUnroll * kQuadUnroll;
}

// kQuadTargets targets a thread (rows t, t + kThreads, ...), one block:
// kThreads * kQuadTargets targets of group blockIdx.y.
template <bool kSoft>
__global__ void __launch_bounds__(kThreads)
quad_force_kernel(const float* __restrict__ tgt8,
                  const float* __restrict__ qslab, int B, int A, float eps2,
                  float g, float* __restrict__ out) {
  // [buffer][x y z M | Qxx Qyy Qzz Qxy | Qxz Qyz 0 0][row]
  __shared__ float4 stage[2][3][kChunk];
  const int grp = blockIdx.y;
  constexpr int kT = kQuadTargets;
  const int row0 = blockIdx.x * kThreads * kT + threadIdx.x;
  float xi[kT], yi[kT], zi[kT], ax[kT], ay[kT], az[kT];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const int row = min(row0 + t * kThreads, B - 1);
    const float4 p = *reinterpret_cast<const float4*>(
        tgt8 + (static_cast<size_t>(grp) * B + row) * 8);
    xi[t] = p.x;
    yi[t] = p.y;
    zi[t] = p.z;
    ax[t] = ay[t] = az[t] = 0.f;
  }
  const float* rows = qslab + static_cast<size_t>(grp) * A * 16;
  const int chunks = (A + kChunk - 1) / kChunk;
  stage_quad(stage[0], rows, 0, A);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_all();
    // publishes chunk c; every thread is done with chunk c - 1, whose
    // buffer the next fetch overwrites
    __syncthreads();
    const float4* pm = stage[c & 1][0];
    const float4* qa = stage[c & 1][1];
    const float4* qb = stage[c & 1][2];
    const int live = live_rows(pm);
    if (c + 1 < chunks) stage_quad(stage[(c + 1) & 1], rows, (c + 1) * kChunk, A);
    cp_async_commit();
    // zero-mass rows carry Q = 0 and add exactly +-0: the chunk's sum stops
    // at its last massive row (a chunk with none is skipped whole)
    float cx[kT], cy[kT], cz[kT];  // the chunk's partial sums, from zero
#pragma unroll
    for (int t = 0; t < kT; ++t) cx[t] = cy[t] = cz[t] = 0.f;
    for (int k0 = 0; k0 < live; k0 += kQuadUnroll) {
#pragma unroll
      for (int k = k0; k < k0 + kQuadUnroll; ++k) {
        const float4 s = pm[k];
        const float4 q0 = qa[k];  // Qxx, Qyy, Qzz, Qxy
        const float2 q1 = make_float2(qb[k].x, qb[k].y);  // Qxz, Qyz
#pragma unroll
        for (int t = 0; t < kT; ++t) {
          const float ex = s.x - xi[t], ey = s.y - yi[t], ez = s.z - zi[t];
          const float r2 = fmaf(ez, ez, fmaf(ey, ey, fmaf(ex, ex, eps2)));
          // at eps = 0, r^2 below FLT_MIN sends 1/r^3 to infinity whatever
          // 1/r's bits; r^2 == 0 (a coincident row) adds nothing
          const float ir = rsqrt_rn(kSoft ? r2 : fmaxf(r2, FLT_MIN));
          const float ir2 = ir * ir;
          const float ir3 = ir2 * ir;
          float ir5 = ir3 * ir2;
          const float ir7 = ir5 * ir2;
          // Q = [[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]]
          const float ux = q0.x * ex + q0.w * ey + q1.x * ez;
          const float uy = q0.w * ex + q0.y * ey + q1.y * ez;
          const float uz = q1.x * ex + q1.y * ey + q0.z * ez;
          const float qe = ex * ux + ey * uy + ez * uz;
          float w = s.w * ir3 + 2.5f * qe * ir7;
          if (!kSoft && !(r2 > 0.f)) {
            w = 0.f;
            ir5 = 0.f;
          }
          cx[t] += w * ex - ir5 * ux;
          cy[t] += w * ey - ir5 * uy;
          cz[t] += w * ez - ir5 * uz;
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      ax[t] += cx[t];
      ay[t] += cy[t];
      az[t] += cz[t];
    }
  }
#pragma unroll
  for (int t = 0; t < kT; ++t) {
    const int row = row0 + t * kThreads;
    if (row < B) {
      float* o = out + (static_cast<size_t>(grp) * B + row) * 3;
      o[0] = ax[t] * g;
      o[1] = ay[t] * g;
      o[2] = az[t] * g;
    }
  }
}

// Counts the positive normal floats x where rsqrt_rn(x) differs from
// (float)rsqrt((double)x), and the largest difference in ulps.
__global__ void rsqrt_sweep_kernel(unsigned long long* out) {
  constexpr unsigned kLo = 0x00800000u, kHi = 0x7f800000u;
  unsigned long long bad = 0;
  unsigned worst = 0;
  for (unsigned b = kLo + blockIdx.x * blockDim.x + threadIdx.x; b < kHi;
       b += gridDim.x * blockDim.x) {
    const float x = __uint_as_float(b);
    const int got = __float_as_int(rsqrt_rn(x));
    const int ref = __float_as_int(static_cast<float>(
        rsqrt(static_cast<double>(x))));
    if (got != ref) {
      ++bad;
      worst = max(worst, static_cast<unsigned>(abs(got - ref)));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    bad += __shfl_down_sync(0xffffffffu, bad, o);
    worst = max(worst, __shfl_down_sync(0xffffffffu, worst, o));
  }
  if ((threadIdx.x & 31) == 0 && bad) {
    atomicAdd(out, bad);
    atomicMax(out + 1, static_cast<unsigned long long>(worst));
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

int nbody_k4_unroll(void) { return kQuadUnroll; }

int nbody_quad_force(const float* tgt8, const float* qslab, int G, int B,
                     int A, float eps2, float g, float* out, void* stream) {
  if (!grid_ok(G, B) || A <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int kRows = kThreads * kQuadTargets;
  const dim3 grid((B + kRows - 1) / kRows, G);
  if (nbody::softened(eps2)) {
    quad_force_kernel<true><<<grid, kThreads, 0, s>>>(
        tgt8, qslab, B, A, eps2, g, out);
  } else {
    quad_force_kernel<false><<<grid, kThreads, 0, s>>>(
        tgt8, qslab, B, A, eps2, g, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// Test entry: out[0] = mismatches, out[1] = the largest in ulps (zeroed
// here on `stream`).
int nbody_rsqrt_sweep(unsigned long long* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(out, 0, 2 * sizeof(unsigned long long), s);
  rsqrt_sweep_kernel<<<132 * 16, 256, 0, s>>>(out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
