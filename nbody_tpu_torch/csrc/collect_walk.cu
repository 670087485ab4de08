// The Barnes-Hut collect walk's dense levels for Hopper (sm_90a), bound
// through a plain C interface (ctypes; see nbody_tpu_torch/ops/_build.py).
//
// group_collect  replaces no Pallas kernel: the JAX package's collect walk
//     (nbody_tpu/ops/traversal.py:1124-1526) is jnp, vmapped over groups,
//     and the port's plain twin (ops/traversal.py _collect_dense) runs it as
//     a few dozen eager ops a level for all groups at once: ~600 launches a
//     walk at 100k rows, where the device work behind them is a [25, 2048]
//     frontier.  At 2^23 rows a card (profile 'domain') the twin's FP32 box
//     tests over [1024, 16384] frontiers against 128 subgroup boxes, and its
//     temporaries, take ~340 ms.
//
//     What bounds it on the card: at 100k the launch (one a walk); at 2^23
//     rows a card the box tests, S of them a visited cell (~12 FP32
//     operations each) for ~10^4 cells a group, and the table rows the
//     frontier gathers (32 bytes a cell).  The design:
//       - one block owns one group: its S subgroup boxes sit in shared
//         memory, its frontier (the kept parents of the level, in frontier
//         order) double-buffers in shared memory, and it walks every dense
//         level from start_level to max_level in one launch;
//       - a level's frontier is only the children of the kept parents (the
//         twin's invalid slots touch nothing), taken by the block's threads
//         in rounds of one slot a thread;
//       - every decision the twin makes with cumsum is an order-preserving
//         prefix: the parent cap, the near and far budgets, the trash-row
//         pushes into the multipole and fallback slabs.  One block-wide
//         inclusive scan a round (a second and a third at the leaf level)
//         over the round's flags, plus the level's running totals, gives
//         each slot the twin's integers: the overflow, spill and drop ranks
//         follow from the expand and accept ranks in closed form;
//       - the window coverage is the twin's integer diff array: atomic adds
//         (exact in any order), then a block scan for the mask;
//       - the float tests repeat the twin's operations in its order with
//         round-to-nearest intrinsics, so no multiply-add is contracted:
//         com = S / m, the clamped box distance summed x, y, z, its minimum
//         over the boxes, Barnes' offset test and cell_w2 < thr * rmin2.
//     Every caps, level count, branch, row format and budget comes in as a
//     parameter: the 100k tier and profile 'domain' run the same code.
//     With refined levels the kernel stops at the leaf level and hands its
//     slabs, offsets, counters, diff array, boxes and descend list to the
//     plain refined loop.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 16;

// counts rows of the [kCounts, G] int32 output
enum {
  kAcceptDropped = 0,
  kFrontierFallback,
  kNearFallback,
  kFbSpill,
  kMonoOff,
  kFbOff,
  kWstart,
  kCounts
};

template <typename T>
struct Params {
  const T* table[kMaxLevels];  // level_table[l]: [branch^l, 8] contiguous
  int parent_cap[kMaxLevels];  // l < L: kept parents a group for level l+1
  const T* gpos;               // [G, B, 3] by the strides below
  long long gpos_g, gpos_b, gpos_c;
  const T* gmass;              // [G, B]
  long long gmass_g, gmass_b;
  const int* gidx;             // [G, B]: only column 0 is read
  long long gidx_g;
  const T* width;              // 0-d: the tree box's width
  const T* grid_min;           // [dim] accept_offset only
  const T* grid_width;         // 0-d accept_offset only
  const int* refine_slot_leaf; // [branch^L] with refined levels
  double thr;                  // accept_margin * theta2, rounded to T
  int G, B, S, L, start_level, dim, wide, sliding, accept_offset;
  int n_total, W, window_pad;
  int A, FB, NC, NPC;
  int local, local_lo, local_hi, FC, FPC;
  int rf_parent_cap;           // 0: no refined levels
  int max_parents;
  T* mono;                     // [G, A + 1, 8]
  T* fb;                       // [G, FB + 1, 8]
  int* near_ids;               // [G, NC]
  bool* near_valid;
  int* far_ids;                // [G, FC] with local
  bool* far_valid;
  int* rids;                   // [G, rf_parent_cap * branch] with refined
  bool* rvalid;
  int* delta;                  // [G, W + 1]
  bool* wmask;                 // [G, W], or null: the refined loop's
  T* center;                   // [G, 3]
  T* boxes;                    // [2, G, S, 3] (gc, gh) with refined, or null
  int* counts;                 // [kCounts, G]
};

// round-to-nearest arithmetic: never contracted into a multiply-add
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float sqr(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double sqr(double a) { return __dsqrt_rn(a); }

template <typename T> __device__ __forceinline__ T big();
template <> __device__ __forceinline__ float big<float>() { return 3.402823466e38f; }
template <> __device__ __forceinline__ double big<double>() {
  return 1.7976931348623157e308;
}
template <typename T> __device__ __forceinline__ T inf() {
  return static_cast<T>(__int_as_float(0x7f800000));
}
template <typename T> __device__ __forceinline__ T lo_of(T a, T b) { return b < a ? b : a; }
template <typename T> __device__ __forceinline__ T hi_of(T a, T b) { return b > a ? b : a; }

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ int4 shfl_up4(int4 v, int d) {
  return make_int4(__shfl_up_sync(0xffffffffu, v.x, d),
                   __shfl_up_sync(0xffffffffu, v.y, d),
                   __shfl_up_sync(0xffffffffu, v.z, d),
                   __shfl_up_sync(0xffffffffu, v.w, d));
}

// Inclusive scan of one int4 a thread over the block, in thread order;
// `total` gets the block's sum in every thread.  `sm` holds kWarps int4.
__device__ int4 block_scan(int4 v, int4* sm, int4& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int4 y = shfl_up4(v, d);
    if (lane >= d) v = add4(v, y);
  }
  if (lane == 31) sm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int4 w = lane < kWarps ? sm[lane] : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int4 y = shfl_up4(w, d);
      if (lane >= d) w = add4(w, y);
    }
    if (lane < kWarps) sm[lane] = w;
  }
  __syncthreads();
  const int4 before = warp > 0 ? sm[warp - 1] : make_int4(0, 0, 0, 0);
  total = sm[kWarps - 1];
  __syncthreads();  // sm is free again on return
  return add4(before, v);
}

// Morton decode: the axis grid index of a level's cell id (3D: every 3rd
// bit from `axis`, 2D: every 2nd), as morton.decode3 / decode2.
__device__ __forceinline__ unsigned squash3(unsigned v) {
  v &= 0x09249249u;
  v = (v | (v >> 2)) & 0x030C30C3u;
  v = (v | (v >> 4)) & 0x0300F00Fu;
  v = (v | (v >> 8)) & 0x030000FFu;
  v = (v | (v >> 16)) & 0x000003FFu;
  return v;
}
__device__ __forceinline__ unsigned squash2(unsigned v) {
  v &= 0x55555555u;
  v = (v | (v >> 1)) & 0x33333333u;
  v = (v | (v >> 2)) & 0x0F0F0F0Fu;
  v = (v | (v >> 4)) & 0x00FF00FFu;
  v = (v | (v >> 8)) & 0x0000FFFFu;
  return v;
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, T a, T b, T c, T d, T e, T f,
                                       T g, T h) {
  dst[0] = a; dst[1] = b; dst[2] = c; dst[3] = d;
  dst[4] = e; dst[5] = f; dst[6] = g; dst[7] = h;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) collect_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int4 scan_sm[kWarps];
  __shared__ T red_lo[kWarps][3], red_hi[kWarps][3];
  __shared__ int red_any[kWarps];
  __shared__ int ws_sm;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = blockIdx.x;
  const int S = p.S;
  const int W = p.W;
  const int branch = 1 << p.dim;
  T* gcx = reinterpret_cast<T*>(smem_raw);
  T* gcy = gcx + S;
  T* gcz = gcy + S;
  T* ghx = gcz + S;
  T* ghy = ghx + S;
  T* ghz = ghy + S;
  int* par_a = reinterpret_cast<int*>(ghz + S);
  int* par_b = par_a + p.max_parents;

  int* delta = p.delta + static_cast<long long>(g) * (W + 1);
  for (int j = tid; j <= W; j += kThreads) delta[j] = 0;

  // -- subgroup boxes over alive members, the group frame, the window ------
  const T BIG = big<T>();
  const int per = p.B / S;
  const T* gpos = p.gpos + static_cast<long long>(g) * p.gpos_g;
  const T* gmass = p.gmass + static_cast<long long>(g) * p.gmass_g;
  T wlo[3] = {BIG, BIG, BIG}, whi[3] = {-BIG, -BIG, -BIG};
  int wany = 0;
  for (int s = warp; s < S; s += kWarps) {
    T lo[3] = {BIG, BIG, BIG}, hi[3] = {-BIG, -BIG, -BIG};
    bool any = false;
    for (int j = lane; j < per; j += 32) {
      const long long b = static_cast<long long>(s) * per + j;
      if (gmass[b * p.gmass_b] > T(0)) {
        any = true;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const T x = gpos[b * p.gpos_b + c * p.gpos_c];
          lo[c] = lo_of(lo[c], x);
          hi[c] = hi_of(hi[c], x);
        }
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = lo_of(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], d));
        hi[c] = hi_of(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], d));
      }
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) {
      T c_[3], h_[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        wlo[c] = lo_of(wlo[c], lo[c]);
        whi[c] = hi_of(whi[c], hi[c]);
        // an empty subgroup: a point box parked far outside the domain
        const T l = any ? lo[c] : T(1e30);
        const T h = any ? hi[c] : T(1e30);
        c_[c] = mul(T(0.5), add(l, h));
        h_[c] = mul(T(0.5), sub(h, l));
      }
      wany |= any;
      gcx[s] = c_[0]; gcy[s] = c_[1]; gcz[s] = c_[2];
      ghx[s] = h_[0]; ghy[s] = h_[1]; ghz[s] = h_[2];
      if (p.boxes != nullptr) {
        const long long gs = static_cast<long long>(p.G) * S * 3;
        T* bc = p.boxes + (static_cast<long long>(g) * S + s) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          bc[c] = c_[c];
          bc[gs + c] = h_[c];
        }
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      red_lo[warp][c] = wlo[c];
      red_hi[warp][c] = whi[c];
    }
    red_any[warp] = wany;
  }
  __syncthreads();
  if (tid == 0) {
    int any = 0;
    T lo[3] = {BIG, BIG, BIG}, hi[3] = {-BIG, -BIG, -BIG};
    for (int w = 0; w < kWarps; ++w) {
      any |= red_any[w];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = lo_of(lo[c], red_lo[w][c]);
        hi[c] = hi_of(hi[c], red_hi[w][c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p.center[static_cast<long long>(g) * 3 + c] =
          any ? mul(T(0.5), add(lo[c], hi[c])) : T(0);
    }
    int ws = p.gidx[static_cast<long long>(g) * p.gidx_g] - p.window_pad;
    if (!p.sliding) {
      const int top = p.n_total - W > 0 ? p.n_total - W : 0;
      ws = ws < 0 ? 0 : ws;
      ws = ws > top ? top : ws;
    }
    ws_sm = ws;
  }
  __syncthreads();
  const int ws = ws_sm;
  const int we = ws + W;

  const T thr = static_cast<T>(p.thr);
  const T width = *p.width;
  T gmin[3] = {T(0), T(0), T(0)};
  T gwidth = T(0);
  if (p.accept_offset) {
    for (int c = 0; c < p.dim; ++c) gmin[c] = p.grid_min[c];
    gwidth = *p.grid_width;
  }

  // -- the dense levels ----------------------------------------------------
  int* par_in = par_a;
  int* par_out = par_b;
  int npar = 0;
  int mono_off = 0, fb_off = 0;
  int a_dropped = 0, f_fallback = 0, n_fallback = 0, fb_spill = 0;
  int n_near = 0, n_far = 0, n_desc = 0;
  const long long mono_g = static_cast<long long>(g) * (p.A + 1) * 8;
  const long long fb_g = static_cast<long long>(g) * (p.FB + 1) * 8;

  for (int l = p.start_level; l <= p.L; ++l) {
    const bool leaf = l == p.L;
    const bool first = l == p.start_level;
    const int n_slots = first ? (1 << (p.dim * l)) : npar * branch;
    const T* table = p.table[l];
    const T wl = dvd(width, static_cast<T>(1 << l));
    const T cw2 = mul(wl, wl);
    const T cwo = p.accept_offset ? dvd(gwidth, static_cast<T>(1 << l)) : T(0);
    const T lf = static_cast<T>(l);
    const int pc = leaf ? 0 : p.parent_cap[l];
    // the level's running totals (ranks are inclusive)
    int c_exp = 0, c_acc = 0, c_ovf = 0, c_desc = 0;
    int c_ncnt = 0, c_nc = 0, c_fcnt = 0, c_fc = 0, c_inl = 0, c_inf = 0;
    const int mono0 = mono_off, fb0 = fb_off;

    for (int base = 0; base < n_slots; base += kThreads) {
      const int i = base + tid;
      const bool act = i < n_slots;
      int id = 0;
      bool acc = false, expand = false;
      T r[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
      T cx = T(0), cy = T(0), cz = T(0);
      int cs = 0, ce = 0;
      if (act) {
        id = first ? i : (par_in[i >> p.dim] << p.dim) + (i & (branch - 1));
        const T* row = table + static_cast<long long>(id) * 8;
#pragma unroll
        for (int k = 0; k < 6; ++k) r[k] = row[k];
        if (p.wide) {
          const int s_hi = static_cast<int>(row[4]);
          const int s_lo = static_cast<int>(row[5]);
          const int e_hi = static_cast<int>(row[6]);
          const int e_lo = static_cast<int>(row[7]);
          cs = (s_hi << 12) | s_lo;
          ce = (e_hi << 12) | e_lo;
        } else {
          cs = static_cast<int>(r[4]);
          ce = static_cast<int>(r[5]);
        }
        const T m = r[0];
        if (m > T(0)) {
          cx = dvd(r[1], m);
          cy = dvd(r[2], m);
          cz = dvd(r[3], m);
          if (cs >= ws && ce <= we) {  // covered: summed by the window
            atomicAdd(delta + (cs - ws), 1);
            atomicAdd(delta + (ce - ws), -1);
          } else {
            T r2 = inf<T>();  // the empty subgroups' 1e30 boxes give inf
            for (int s = 0; s < S; ++s) {
              T dx = sub(fabs(sub(cx, gcx[s])), ghx[s]);
              T dy = sub(fabs(sub(cy, gcy[s])), ghy[s]);
              T dz = sub(fabs(sub(cz, gcz[s])), ghz[s]);
              dx = dx > T(0) ? dx : T(0);
              dy = dy > T(0) ? dy : T(0);
              dz = dz > T(0) ? dz : T(0);
              const T d2 = add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz));
              r2 = lo_of(r2, d2);
            }
            if (p.accept_offset) {
              // Barnes' modified test: the distance less the COM's offset
              // from its cell's centre
              const unsigned code = static_cast<unsigned>(id);
              const T com[3] = {cx, cy, cz};
              T off2 = T(0);
              for (int c = 0; c < p.dim; ++c) {
                const unsigned a = p.dim == 3 ? squash3(code >> c)
                                              : squash2(code >> c);
                const T ctr = add(gmin[c],
                                  mul(add(static_cast<T>(a), T(0.5)), cwo));
                const T d = sub(com[c], ctr);
                off2 = c == 0 ? mul(d, d) : add(off2, mul(d, d));
              }
              T reach = sub(sqr(r2), sqr(off2));
              reach = reach > T(0) ? reach : T(0);
              r2 = mul(reach, reach);
            }
            acc = cw2 < mul(thr, r2);
            expand = !acc;
          }
        }
      }

      // the fallback push of an overflowed cell (o_incl: the level's
      // overflows up to this slot), its spill past fb_cap into the
      // multipole slab, and the accepted cells (a_incl: the level's
      // accepts up to this slot) after the level's spill so far
      auto push = [&](bool ovf, int o_incl, int a_incl) {
        const int room = p.FB - fb0;
        const int d_incl = o_incl > room ? o_incl - room : 0;
        bool spill = false;
        if (ovf) {
          const int slot = fb0 + o_incl - 1;
          if (slot < p.FB) {
            store8(p.fb + fb_g + static_cast<long long>(slot) * 8, r[0], r[1],
                   r[2], r[3], r[4], r[5], lf, static_cast<T>(id));
          } else {
            spill = true;
          }
        }
        if (acc || spill) {
          const int slot = mono0 + a_incl + d_incl - 1;
          if (slot < p.A) {
            store8(p.mono + mono_g + static_cast<long long>(slot) * 8, cx, cy,
                   cz, r[0], T(-1), spill ? T(-1) : lf, static_cast<T>(id),
                   lf);
          }
        }
      };

      if (!leaf) {
        // cells that would expand past the parent cap degrade to
        // self-excluded monopoles
        int4 tot;
        const int4 inc = block_scan(make_int4(expand, acc, 0, 0), scan_sm, tot);
        const int e = c_exp + inc.x;
        if (expand && e <= pc) par_out[e - 1] = id;
        push(expand && e > pc, e > pc ? e - pc : 0, c_acc + inc.y);
        c_exp += tot.x;
        c_acc += tot.y;
      } else {
        // refined descent: flagged cells past the refined frontier keep the
        // unrefined path
        bool desc = false;
        if (p.rf_parent_cap > 0) {
          const int rb = expand ? p.refine_slot_leaf[id] : -1;
          int4 tot;
          const int4 inc = block_scan(make_int4(rb >= 0, 0, 0, 0), scan_sm,
                                      tot);
          const int d = c_desc + inc.x;
          if (rb >= 0 && d <= p.rf_parent_cap) {
            desc = true;
            const long long at =
                (static_cast<long long>(g) * p.rf_parent_cap + d - 1) * branch;
            for (int k = 0; k < branch; ++k) {
              p.rids[at + k] = rb * branch + k;
              p.rvalid[at + k] = true;
            }
          }
          c_desc += tot.x;
        }
        const bool e2 = expand && !desc;
        // near and far budgets: order-preserving prefixes of the particle
        // and cell counts; a domain walk's cells outside the rank's slab
        // take the far ones
        const bool is_local =
            !p.local || (cs >= p.local_lo && ce <= p.local_hi);
        const bool el = e2 && is_local;
        const bool ef = e2 && !is_local;
        const int cnt = ce - cs;
        int4 tot;
        int4 inc = block_scan(make_int4(el ? cnt : 0, el, ef ? cnt : 0, ef),
                              scan_sm, tot);
        const bool in_l = el && c_ncnt + inc.x <= p.NPC && c_nc + inc.y <= p.NC;
        const bool in_f = ef && c_fcnt + inc.z <= p.FPC && c_fc + inc.w <= p.FC;
        const bool ovf = e2 && !in_l && !in_f;
        c_ncnt += tot.x;
        c_nc += tot.y;
        c_fcnt += tot.z;
        c_fc += tot.w;
        inc = block_scan(make_int4(in_l, in_f, ovf, acc), scan_sm, tot);
        if (in_l) {
          p.near_ids[static_cast<long long>(g) * p.NC + c_inl + inc.x - 1] = id;
        }
        if (in_f) {
          p.far_ids[static_cast<long long>(g) * p.FC + c_inf + inc.y - 1] = id;
        }
        push(ovf, c_ovf + inc.z, c_acc + inc.w);
        c_inl += tot.x;
        c_inf += tot.y;
        c_ovf += tot.z;
        c_acc += tot.w;
      }
    }
    if (!leaf) c_ovf = c_exp > pc ? c_exp - pc : 0;

    // the level's pushes, as the twin's _push_rows offsets and drop counts
    const int fb_room = p.FB - fb0;
    const int spilled = c_ovf > fb_room ? c_ovf - fb_room : 0;
    fb_off = fb0 + c_ovf < p.FB ? fb0 + c_ovf : p.FB;
    fb_spill += spilled;
    const int pushed = c_acc + spilled;
    const int mono_room = p.A - mono0;
    a_dropped += pushed > mono_room ? pushed - mono_room : 0;
    mono_off = mono0 + pushed < p.A ? mono0 + pushed : p.A;
    if (leaf) {
      n_fallback = c_ovf;
      n_near = c_inl;
      n_far = c_inf;
      n_desc = c_desc < p.rf_parent_cap ? c_desc : p.rf_parent_cap;
    } else {
      f_fallback += c_ovf;
      npar = c_exp < pc ? c_exp : pc;
      int* t = par_in;
      par_in = par_out;
      par_out = t;
    }
    __syncthreads();  // the new frontier is complete
  }

  // -- tails: zero rows and ids past each list, as the twin's zero slabs ---
  for (long long j = static_cast<long long>(mono_off) * 8 + tid;
       j < static_cast<long long>(p.A) * 8; j += kThreads) {
    p.mono[mono_g + j] = T(0);
  }
  for (long long j = static_cast<long long>(fb_off) * 8 + tid;
       j < static_cast<long long>(p.FB) * 8; j += kThreads) {
    p.fb[fb_g + j] = T(0);
  }
  for (int j = tid; j < p.NC; j += kThreads) {
    const long long k = static_cast<long long>(g) * p.NC + j;
    if (j >= n_near) p.near_ids[k] = 0;
    p.near_valid[k] = j < n_near;
  }
  if (p.local) {
    for (int j = tid; j < p.FC; j += kThreads) {
      const long long k = static_cast<long long>(g) * p.FC + j;
      if (j >= n_far) p.far_ids[k] = 0;
      p.far_valid[k] = j < n_far;
    }
  }
  if (p.rf_parent_cap > 0) {
    const int n = p.rf_parent_cap * branch;
    for (int j = n_desc * branch + tid; j < n; j += kThreads) {
      const long long k = static_cast<long long>(g) * n + j;
      p.rids[k] = j & (branch - 1);
      p.rvalid[k] = false;
    }
  }
  if (tid == 0) {
    const int c[kCounts] = {a_dropped, f_fallback, n_fallback, fb_spill,
                            mono_off, fb_off, ws};
    for (int k = 0; k < kCounts; ++k) {
      p.counts[static_cast<long long>(k) * p.G + g] = c[k];
    }
  }
  if (p.wmask == nullptr) return;

  // -- the window mask: the diff array's prefix > 0 ------------------------
  __syncthreads();  // every coverage update is in
  const int chunk = (W + kThreads - 1) / kThreads;
  const int j0 = tid * chunk;
  const int j1 = j0 + chunk < W ? j0 + chunk : W;
  int run = 0;
  for (int j = j0; j < j1; ++j) run += delta[j];
  int4 tot;
  const int4 inc = block_scan(make_int4(run, 0, 0, 0), scan_sm, tot);
  run = inc.x - run;
  bool* wm = p.wmask + static_cast<long long>(g) * W;
  for (int j = j0; j < j1; ++j) {
    run += delta[j];
    wm[j] = run > 0;
  }
}

template <typename T>
int launch(const void* params, int smem, void* stream) {
  const Params<T>& p = *static_cast<const Params<T>*>(params);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        collect_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  collect_kernel<T><<<p.G, kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Bytes of the Params struct of float (dbl = 0) or double (dbl = 1), so the
// wrapper can check the layout it packs.
int nbody_collect_params_bytes(int dbl) {
  return dbl ? static_cast<int>(sizeof(Params<double>))
             : static_cast<int>(sizeof(Params<float>));
}

// One launch of G blocks over `params` (a Params<float> or Params<double>
// as packed by ops/collect_walk.py), with `smem` bytes of dynamic shared
// memory (the boxes and the frontier's two buffers).  Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
int nbody_group_collect(const void* params, int dbl, int smem, void* stream) {
  return dbl ? launch<double>(params, smem, stream)
             : launch<float>(params, smem, stream);
}

}  // extern "C"
