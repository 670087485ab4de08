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
//     tile_j as the caller's grid, whatever its own block shape.
//
// What bounds it on the card: FP32 instruction issue, not bytes (a staged
// chunk of 128 sources, 2.5 KB, serves 512 targets).  The design keeps the
// instructions a pair few:
//   - four targets a thread, all the rows of a block in one target tile I,
//     so they share the anchor of each source tile J: one staged source
//     row (p_j - c, |p_j - c|^2, m_j: two broadcast shared loads) feeds
//     four pairs;
//   - each 128-source stage runs a loop of fixed length (unrolled 16 deep:
//     fully unrolled, 512 pair bodies would overflow the instruction
//     cache); tile_j is a multiple of the stage, so a stage lies in one J
//     tile and no pair tests where J changes;
//   - the j == i test runs only in the stages that hold the block's own
//     rows (a separate, guarded loop); every other stage has no index
//     compare;
//   - specialised on eps (softened.cuh): at eps^2 >= FLT_MIN the rsqrt is
//     the MUFU instruction alone (any r^2 below FLT_MIN sends 1/r^3 to
//     infinity on either path, so flushing it changes no result); eps = 0
//     keeps rsqrtf;
//   - the next stage's raw rows arrive by cp.async while this one is
//     evaluated;
//   - the source range (whole J tiles) is split over a second grid
//     dimension, so that 128 target blocks at N = 65536 become enough to
//     fill 132 SMs; each split writes its folded partial sum to a scratch
//     slot [split, N, 3], and a second pass adds the slots in split order
//     and applies G.
// A pair costs the cross product (5), r^2 (3), the rsqrt, the r^2 <= 0
// guard (2, in both eps instances: the norm trick's cancellation can push
// r^2 to or below 0 at eps > 0), s = m / r^3 (3) and four sums (4).
//
// The norm-trick terms are formed with explicitly rounded operations, never
// contracted into FMAs: the same sequence of roundings as the plain twin's
// element-wise torch ops (ops/pairwise.py pairwise_acc_mxu_plain), so the
// kernel and the twin see the same r^2 and differ only in how the sums are
// ordered.  The cancellation in r^2 would magnify any other difference.
// (n2_i + n2_j) - 2 cross is one FMA: 2 cross is exact, so the fold changes
// no bit.  Contracting the cross product into FMAs as well (two FP32
// instructions a pair fewer, 6% faster) put the kernel more than 1e-3 from
// its twin in the worst row of N <= 4096 discs, so it is not done.
//
// Summation order: each stage's part of A starts from zero and joins its J
// tile's A once; each J tile's A is folded into the split's total in tile
// order; the splits are added in order.  No atomics: runs are
// bit-reproducible.
//
// Full fp32 on the CUDA cores.  The TPU kernel ran its two products on the
// MXU at HIGHEST precision; on Hopper only the 3-wide cross product and the
// 4-wide accumulation could move to the tensor cores, TF32 or bf16 products
// are wrong for r^2 (the cancellation of the norm trick magnifies their
// rounding), and a 3xTF32 split costs about what it would save.

#include <cuda_runtime.h>
#include <stddef.h>

#include "softened.cuh"

namespace {

constexpr int kStage = 128;   // sources per stage
constexpr int kR = 4;         // targets a thread
constexpr int kMaxThreads = 128;
constexpr int kUnroll = 16;   // sources of one unrolled step

__device__ __forceinline__ float anchor(float a, float b) {
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

// cp.async of `bytes` (0-16; the rest of the 16 zero-filled) from src.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}

// Raw sources [base, base + cnt): 3 * kStage position floats and kStage
// masses, copied 16 bytes at a time by the block's threads (pos and mass
// are 16-byte aligned; base is a multiple of kStage), zero-filled past cnt.
struct Raw {
  float p[3 * kStage];
  float m[kStage];
};

__device__ __forceinline__ void fetch(Raw* dst, const float* pos,
                                      const float* mass, int base, int cnt) {
  constexpr int kPos = 3 * kStage / 4, kAll = kPos + kStage / 4;
  for (int c = threadIdx.x; c < kAll; c += blockDim.x) {
    const bool is_pos = c < kPos;
    const int f = is_pos ? 4 * c : 4 * (c - kPos);  // first float of chunk
    const int have = (is_pos ? 3 * cnt : cnt) - f;
    const int bytes = 4 * max(0, min(4, have));
    const float* src = is_pos ? pos + 3 * static_cast<size_t>(base) + f
                              : mass + base + f;
    cp_async16(is_pos ? dst->p + f : dst->m + f, bytes ? src : pos, bytes);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// s = m / r^3, or 0 where r^2 <= 0 (a NaN r^2 stays NaN, as in the twin)
template <bool kSoft>
__device__ __forceinline__ float weight(float r2, float m) {
  const float ir = kSoft ? nbody::rsqrt_ftz(r2) : rsqrtf(r2);
  const float s = ir * ir * ir * m;
  return r2 <= 0.f ? 0.f : s;
}

struct Targets {
  float px[kR], py[kR], pz[kR], n2[kR];  // p_i - c, |p_i - c|^2
  float cx[kR], cy[kR], cz[kR], c1[kR];  // this stage's part of A
};

template <bool kSoft, bool kDiag>
__device__ __forceinline__ void pair(Targets& T, const float4 q, float m,
                                     float eps2, int t, int j, int row) {
  const float cross = dot3(T.px[t], T.py[t], T.pz[t], q.x, q.y, q.z);
  const float r2 =
      __fadd_rn(fmaf(-2.f, cross, __fadd_rn(T.n2[t], q.w)), eps2);
  float s = weight<kSoft>(r2, m);
  if (kDiag && j == row) s = 0.f;
  T.cx[t] = fmaf(s, q.x, T.cx[t]);
  T.cy[t] = fmaf(s, q.y, T.cy[t]);
  T.cz[t] = fmaf(s, q.z, T.cz[t]);
  T.c1[t] += s;
}

// One block: kR * blockDim.x targets (rows r0 + t + k * blockDim.x), all in
// one target tile, against the source tiles of split blockIdx.y.
template <bool kSoft>
__global__ void __launch_bounds__(kMaxThreads)
acc_mxu_kernel(const float* __restrict__ pos, const float* __restrict__ mass,
               int n, int tile_i, int tile_j, int tiles_per_split, float eps2,
               float g, float* __restrict__ out) {
  __shared__ __align__(16) Raw raw[2];
  __shared__ float4 src[kStage];  // (p_j - c, |p_j - c|^2)
  __shared__ float src_m[kStage];
  const int nt = blockDim.x;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * nt * kR;
  // the block's target tile I and its anchor row
  const int i0 = (r0 / tile_i) * tile_i;
  const float ax = pos[3 * i0], ay = pos[3 * i0 + 1], az = pos[3 * i0 + 2];
  float xi[kR], yi[kR], zi[kR], ox[kR], oy[kR], oz[kR];
  float sx[kR], sy[kR], sz[kR], s1[kR];  // this J tile's A
  Targets T;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int i = min(r0 + t + k * nt, n - 1);
    xi[k] = pos[3 * i];
    yi[k] = pos[3 * i + 1];
    zi[k] = pos[3 * i + 2];
    ox[k] = oy[k] = oz[k] = 0.f;
  }
  const int j_begin = blockIdx.y * tiles_per_split * tile_j;
  const int j_end = min(n, j_begin + tiles_per_split * tile_j);
  const int rows_end = r0 + nt * kR;
  fetch(&raw[0], pos, mass, j_begin, min(kStage, j_end - j_begin));
  for (int base = j_begin, st = 0; base < j_end; base += kStage, ++st) {
    const int cnt = min(kStage, j_end - base);
    const int j0 = (base / tile_j) * tile_j;
    const float cx0 = anchor(ax, pos[3 * j0]);
    const float cy0 = anchor(ay, pos[3 * j0 + 1]);
    const float cz0 = anchor(az, pos[3 * j0 + 2]);
    if (base == j0) {  // a new J tile: re-centre the targets on its anchor
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        T.px[k] = xi[k] - cx0;
        T.py[k] = yi[k] - cy0;
        T.pz[k] = zi[k] - cz0;
        T.n2[k] = dot3(T.px[k], T.py[k], T.pz[k], T.px[k], T.py[k], T.pz[k]);
        sx[k] = sy[k] = sz[k] = s1[k] = 0.f;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // raw stage st has arrived; every thread is done with src (stage
    // st - 1) and with raw[(st + 1) & 1] (recentred in stage st - 1)
    __syncthreads();
    const Raw& rw = raw[st & 1];
    for (int r = t; r < cnt; r += nt) {
      const float qx = rw.p[3 * r] - cx0;
      const float qy = rw.p[3 * r + 1] - cy0;
      const float qz = rw.p[3 * r + 2] - cz0;
      src[r] = make_float4(qx, qy, qz, dot3(qx, qy, qz, qx, qy, qz));
      src_m[r] = rw.m[r];
    }
    if (base + kStage < j_end) {
      fetch(&raw[(st + 1) & 1], pos, mass, base + kStage,
            min(kStage, j_end - base - kStage));
    }
    __syncthreads();  // src published
#pragma unroll
    for (int k = 0; k < kR; ++k) T.cx[k] = T.cy[k] = T.cz[k] = T.c1[k] = 0.f;
    if (base < rows_end && r0 < base + cnt) {
      // the stage holds some of the block's own rows: the j == i test
#pragma unroll 1
      for (int r = 0; r < cnt; ++r) {
        const float4 q = src[r];
        const float m = src_m[r];
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          pair<kSoft, true>(T, q, m, eps2, k, base + r, r0 + t + k * nt);
        }
      }
    } else {
      // a whole stage (cnt == kStage whenever N >= kStage)
#pragma unroll kUnroll
      for (int r = 0; r < kStage; ++r) {
        const float4 q = src[r];
        const float m = src_m[r];
#pragma unroll
        for (int k = 0; k < kR; ++k) pair<kSoft, false>(T, q, m, eps2, k, 0, 0);
      }
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      sx[k] += T.cx[k];
      sy[k] += T.cy[k];
      sz[k] += T.cz[k];
      s1[k] += T.c1[k];
    }
    if (base + kStage >= j0 + tile_j || base + kStage >= j_end) {
      // the J tile is complete: fold it into the total
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        ox[k] += sx[k] - T.px[k] * s1[k];
        oy[k] += sy[k] - T.py[k] * s1[k];
        oz[k] += sz[k] - T.pz[k] * s1[k];
      }
    }
  }
  // one split: the result; several: this split's slot of the partials
  const bool whole = gridDim.y == 1;
  float* dst = out + static_cast<size_t>(blockIdx.y) * n * 3;
  const float scale = whole ? g : 1.f;
#pragma unroll
  for (int k = 0; k < kR; ++k) {
    const int i = r0 + t + k * nt;
    if (i < n) {
      dst[3 * i] = ox[k] * scale;
      dst[3 * i + 1] = oy[k] * scale;
      dst[3 * i + 2] = oz[k] * scale;
    }
  }
}

// out = G * sum of the splits' partials [splits, n * 3], in split order.
__global__ void mxu_reduce_kernel(const float* __restrict__ partial,
                                  int splits, int len, float g,
                                  float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= len) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += partial[static_cast<size_t>(s) * len + e];
  out[e] = acc * g;
}

}  // namespace

extern "C" {

// Launches on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (0 = launched).  pos [n, 3], mass [n] (16-byte
// aligned), out [n, 3]; tile_i and tile_j divide n; tile_j is a multiple of
// the stage (128) unless n < 128; a block holds threads * 4 targets, which
// divides tile_i unless tile_i == n; `splits` divides n / tile_j, and above
// one split `partial` holds [splits, n, 3] floats.
int nbody_acc_mxu(const float* pos, const float* mass, int n, int tile_i,
                  int tile_j, int threads, int splits, float eps2, float g,
                  float* partial, float* out, void* stream) {
  const int rows = threads * kR;
  if (n <= 0 || tile_i <= 0 || tile_j <= 0 || n % tile_i != 0 ||
      n % tile_j != 0 || (n >= kStage && tile_j % kStage != 0) ||
      threads <= 0 || threads > kMaxThreads ||
      (tile_i % rows != 0 && tile_i != n) || splits <= 0 ||
      (n / tile_j) % splits != 0 || (splits > 1 && partial == nullptr) ||
      reinterpret_cast<size_t>(pos) % 16 != 0 ||
      reinterpret_cast<size_t>(mass) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + rows - 1) / rows, splits);
  const int tps = n / tile_j / splits;
  float* dst = splits > 1 ? partial : out;
  if (nbody::softened(eps2)) {
    acc_mxu_kernel<true><<<grid, threads, 0, s>>>(pos, mass, n, tile_i,
                                                   tile_j, tps, eps2, g, dst);
  } else {
    acc_mxu_kernel<false><<<grid, threads, 0, s>>>(pos, mass, n, tile_i,
                                                    tile_j, tps, eps2, g, dst);
  }
  if (splits > 1) {
    const int len = 3 * n;
    mxu_reduce_kernel<<<(len + 255) / 256, 256, 0, s>>>(partial, splits, len,
                                                        g, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
