// Plane-sweep kernels for Hopper (sm_90a): one projection and tap code,
// three modes.
//
// Replaces:
//   pair mode     -> deep3d_aerial_tpu/ops/pallas_sweep.py:_sweep_corr_kernel
//                    (entry sweep_corr_chunk_pallas, which the AdaMVS pair
//                    branch, models/adamvs.py:_pair_volumes_pallas, maps over
//                    views and chunks of 8 planes; here one launch builds
//                    every view's whole volume)
//   cost mode     -> deep3d_aerial_tpu/ops/pallas_sweep.py:_sweep_cost_kernel,
//                    mode='corr' (entry sweep_cost_chunk_prepared; every
//                    AdaMVS stage's cost chunk, models/cascade.py:_pallas_chunk_costs)
//   variance mode -> the same TPU kernel, mode='variance' (every MSREDNet
//                    stage's cost chunk; oracle models/cascade.py:variance_cost_plane)
//
// pair:     out[v,k,y,x] = mean_c ref[y,x,c] * warp(src_v, k)[y,x,c]
// cost:     out[k,c,y,x] = sum_v w_v[y,x] * ref[y,x,c] * warp(src_v, k)[y,x,c]
//                          / (sum_v w_v[y,x] + 1e-5)
// variance: out[k,c,y,x] = E[f^2] - E[f]^2 over f in {ref[y,x,c]} and the
//                          V values warp(src_v, k)[y,x,c] (n = V + 1, no weights)
// warp(src, k)[y,x] is the bilinear sample of src [H,W,C] at the projection
// of ref pixel (x, y) at depth depths[k,y,x] through rows 0-2 of the view's
// [4, 4] rel (src_P @ inv(ref_P)); each of the 4 taps is zeroed on its own
// when it falls outside the image, and a point at or behind the source
// camera (z <= 1e-6) samples nothing.
//
// What bounds it on an H100. The unique bytes (the inputs read once, the
// output written once) set the bound, but the taps repeat them: per
// (plane, pixel, view) 4 taps of C contiguous floats (32-128 B), which
// neighbouring planes and pixels share, served by L1 and L2. On the card
// the limit is instruction issue and latency: the projection of one
// (plane, pixel, view) -- the p = ray * d + t chain, two IEEE divisions,
// floors, tap validity -- costs ~60 instructions, as much as gathering 8
// channels, and with the projection compiled out a stage-3 cost chunk takes
// about half its time (scripts/sweep_probe.py, variant nodesc).
//
// Design:
// - Each (plane, pixel, view) is projected once, into a tap descriptor:
//   the offset of an in-image 2x2 block of source pixels and its 4 weights.
//   The plain version's taps (x0, y0) .. (x1, y1), each zeroed on its own
//   outside the image, map onto the block at (x0, y0) clamped to
//   [0, W-2] x [0, H-2]: an outside tap gets weight 0, an in-image tap
//   keeps its own weight (the same product) at its own position. So no tap
//   load has a branch, and every load reads the image. No source windows:
//   a tap may land anywhere in the source.
// - From C = 16 on (the lane-per-quad kernels), a block owns a row segment
//   of NPIX = 256 / G ref pixels and KT planes (8 in pair and cost modes,
//   4 in variance mode); G = C/4 neighbouring lanes
//   per pixel each hold one float4 channel quad, so one tap of one pixel is
//   one contiguous C x 4-byte run read by G lanes. Views are the outer
//   loop: lane q of a pixel describes planes q, q+G, ... of the view into
//   shared memory, then every lane gathers its quad of the KT planes (their
//   taps issued back to back, neighbouring planes' footprints overlapping
//   in L1). Each plane's [C, NPIX] tile is staged through shared memory so
//   a warp writes 128-byte runs along x of the [K, C, H, W] output. The
//   pair mode sums its lanes' products over the pixel's G lanes with a
//   shuffle reduce-scatter (each lane ends with KT/G planes' totals).
// - At C = 8 (the *_wide kernels; 2 lanes a pixel would project twice or
//   exchange descriptors for little), one thread takes a pixel: it projects
//   each (plane, view) and gathers both quads of each tap; consecutive
//   threads are consecutive pixels, so each channel's stores are 128-byte
//   runs.
// - One-thread-per-pixel blocks take 8 planes (a sweep chunk), fewer where
//   that would leave the grid under kMinBlocks blocks (the small stages).
//   Lane-per-quad blocks take a fixed number of planes a mode (see
//   kCostPlanes).
// - Channel counts: instances for C = 4 (one lane a pixel in pair mode,
//   the *_wide kernels in cost and variance modes), 8, 16, 32 and 64
//   (G = 16 lanes a pixel, 16 pixels a block; the pair mode takes 16
//   planes a block there, one plane's total a lane after the
//   reduce-scatter). Any other C (the feature widths 4b, 2b, b of a base
//   width b that is not a power of two) goes to the *_any kernels: one
//   thread a pixel, C a runtime value and every channel a scalar load, so
//   any C and any alignment of a pixel's channels; cost and variance split
//   the channels into chunks of kAnyChannels (blockIdx.z), the pair mode
//   sums every channel of a pixel in its thread. They project as the other
//   kernels do and are the slow path by design (a quad is four loads).
// - The projection uses round-to-nearest intrinsics, so no product and sum
//   is fused into an FMA: the coordinates round exactly as the plain PyTorch
//   chain's (ops/warp.py) do. Sums over views stay in view order, and
//   there are no atomics: the same bits on every run.
// - Offsets are 64-bit (the 1856x2752 frame); ragged edges are masked.
// - bfloat16 mode (the *_bf16 entries; the JAX package's dtype=bfloat16):
//   the features are read as they are, 2 bytes a channel (a quad is one
//   8-byte load), upcast in registers; taps, products, weights and
//   variance run in float32 exactly as in the float32 mode, and the output
//   is rounded to bfloat16 once, where it is stored. Projections, depths
//   and weights stay float32. This halves the feature and output bytes of
//   the bound.
// - Compensated projection (the *_comp entries, in float32 and bfloat16;
//   DENSEMATCH.warp_precision 'compensated', the JAX package's
//   sweep_coordinates(highp=True), deep3d_aerial_tpu/ops/warp.py:45-89 and
//   :130-198): one template flag on the projection. Each value is an
//   unevaluated (hi, lo) float32 pair (double-single, Dekker/Knuth): the
//   ray r0*x + r1*y + r2 once per (pixel, view), then per (plane, pixel,
//   view) p = ray * d + t and one compensated division per coordinate,
//   where the float32 mode projects. Every op is a round-to-nearest
//   intrinsic, as in the plain chain (ops/warp.py), so the error-free
//   transformations stay error-free (an FMA inside a split, a product or
//   a sum would change the low word). Taps, weights, channel reduction
//   and output are the float32 mode's. The chain costs ~200 operations
//   and four divisions a projection against ~10 and two, and the
//   projection already bounds the sweeps' issue, so this mode is the
//   slower one by design. The one-thread-per-pixel kernels walk planes
//   outside views: they keep each view's double-single ray in dynamic
//   shared memory ([V][6][kThreads] floats, each thread its own column)
//   instead of recomputing it per plane.

#include <cuda_runtime.h>

#include <type_traits>

#include "bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBadSize = 10001;      // H or W below 2, C below 1, or H*W*C >= 2^31
constexpr int kTooManyViews = 10002; // compensated rays of V views over shared memory
// shared memory a block may take on an H100 (the compensated ray cache)
constexpr int kMaxSharedBytes = 232448;
// Cost and variance take one lane per channel quad from C = kQuadLanesFrom
// on, one thread per pixel below it (the *_wide kernels).
constexpr int kQuadLanesFrom = 16;
// Planes a lane-per-quad cost or variance block takes. On an H100
// (scripts/sweep_probe.py, variant swap) 8 cost planes were 5-8% faster
// than 4 at 96x128 C32 and at the 1856x2752 frame's 464x688 C32 and
// 928x1376 C16 stages (3% slower at 192x256 C16); variance keeps two sums
// a plane and was 19-44% slower at 8 than at 4.
constexpr int kCostPlanes = 8;
constexpr int kVarPlanes = 4;
// Blocks per grid below which a one-thread-per-pixel block takes fewer
// planes (more threads in flight on a small stage).
constexpr long long kMinBlocks = 1024;
// Blocks per SM the register budget must allow (at most 85 registers a
// thread on the lane-per-quad kernels, 64 on the one-thread-per-pixel ones).
constexpr int kBlocksPerSM = 3;
constexpr int kBlocksPerSMWide = 4;

// The block's row segment and this lane's pixel and channel quad.
template <int C>
struct Tile {
  static constexpr int G = C / 4;
  static constexpr int NPIX = kThreads / G;
  // shared-memory row stride of a [C, NPIX] plane tile: the pad makes the
  // lanes' quad writes (rows 4q..4q+3, column p) hit distinct banks (at
  // G = 16 two lanes share one: a warp holds 32 lanes of 2 pixels)
  static constexpr int S = NPIX + (G <= 8 ? 8 / G : 1);
  int y, x0;  // the segment's row and first column
  int p, q;   // this lane's pixel in the segment and channel quad
  int x;      // its column, clamped into the image (lanes past the right
              // edge compute a copy of the last pixel and store nothing)
  __device__ __forceinline__ explicit Tile(int W) {
    const int tiles_x = (W + NPIX - 1) / NPIX;
    y = blockIdx.x / tiles_x;
    x0 = (blockIdx.x % tiles_x) * NPIX;
    p = threadIdx.x / G;
    q = threadIdx.x % G;
    x = min(x0 + p, W - 1);
  }
};

// A quad of 4 channels of a feature of type T: float4 (float32) or uint2
// (bfloat16), read as float32.
template <class T>
using Quad = typename std::conditional<std::is_same<T, float>::value, float4, uint2>::type;

__device__ __forceinline__ float4 quad(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float4 quad(const uint2* p) {
  const uint2 u = __ldg(p);
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}

// Double-single arithmetic: a value is hi + lo, two float32 words. The
// helpers are ops/warp.py's (_two_sum .. _ds_div), op by op, each op
// rounded once.
struct DS {
  float hi, lo;
};

__device__ __forceinline__ DS two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb))};
}

// Veltkamp split of a float32 into two 12-bit halves (2^12 + 1)
__device__ __forceinline__ DS split(float a) {
  const float c = __fmul_rn(a, 4097.f);
  const float hi = __fsub_rn(c, __fsub_rn(c, a));
  return {hi, __fsub_rn(a, hi)};
}

// a * b = p + e exactly: ((ah*bh - p) + ah*bl + al*bh) + al*bl
__device__ __forceinline__ DS two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  const DS x = split(a), y = split(b);
  float e = __fsub_rn(__fmul_rn(x.hi, y.hi), p);
  e = __fadd_rn(e, __fmul_rn(x.hi, y.lo));
  e = __fadd_rn(e, __fmul_rn(x.lo, y.hi));
  return {p, __fadd_rn(e, __fmul_rn(x.lo, y.lo))};
}

__device__ __forceinline__ DS ds_add(DS x, DS y) {
  const DS s = two_sum(x.hi, y.hi);
  return two_sum(s.hi, __fadd_rn(__fadd_rn(s.lo, x.lo), y.lo));
}

__device__ __forceinline__ DS ds_mul(DS x, DS y) {
  const DS p = two_prod(x.hi, y.hi);
  return two_sum(p.hi, __fadd_rn(__fadd_rn(p.lo, __fmul_rn(x.hi, y.lo)),
                                 __fmul_rn(x.lo, y.hi)));
}

// (x.hi + x.lo) / (z.hi + z.lo): the quotient and one correction from the
// residual x - q*z, evaluated in double-single
__device__ __forceinline__ float ds_div(DS x, DS z) {
  const float q = __fdiv_rn(x.hi, z.hi);
  const DS qz = ds_mul(DS{q, 0.f}, z);
  const DS r = ds_add(x, DS{-qz.hi, -qz.lo});
  return __fadd_rn(q, __fdiv_rn(__fadd_rn(r.hi, r.lo), z.hi));
}

// Rows 0-2 of a view's rel (its [4, 4] matrix, 16-byte aligned rows)
// applied to ref pixel (px, py): p(d) = r * d + t. The compensated
// projection keeps r in double-single (RayDS).
struct Ray {
  float r[3], t[3];
};
struct RayDS {
  DS r[3];
  float t[3];
};
template <bool Comp>
using RayOf = typename std::conditional<Comp, RayDS, Ray>::type;

template <bool Comp>
__device__ __forceinline__ RayOf<Comp> make_ray(const float* __restrict__ rel,
                                                float px, float py) {
  RayOf<Comp> g;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float4 m = __ldg(reinterpret_cast<const float4*>(rel) + a);
    if constexpr (Comp) {
      g.r[a] = ds_add(ds_add(ds_mul(DS{px, 0.f}, DS{m.x, 0.f}),
                             ds_mul(DS{py, 0.f}, DS{m.y, 0.f})),
                      DS{m.z, 0.f});
    } else {
      g.r[a] = __fadd_rn(__fadd_rn(__fmul_rn(m.x, px), __fmul_rn(m.y, py)), m.z);
    }
    g.t[a] = m.w;
  }
  return g;
}

// The source coordinates (xs, ys) of ref pixel (ray g) at depth d; a point
// at or behind the source camera (z <= 1e-6) gets -1e9 (no tap).
__device__ __forceinline__ void project(const Ray& g, float d, float& xs, float& ys) {
  float p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = __fadd_rn(__fmul_rn(g.r[a], d), g.t[a]);
  const float z = p[2];
  const float sz = fabsf(z) < 1e-8f ? 1e-8f : z;
  xs = __fdiv_rn(p[0], sz);
  ys = __fdiv_rn(p[1], sz);
  if (!(z > 1e-6f)) {
    xs = -1e9f;
    ys = -1e9f;
  }
}

// The compensated chain, in ops/warp.py's guard order: |zhi| < 1e-8 takes
// the safe z (1e-8, 0), z = zhi + zlo decides "behind".
__device__ __forceinline__ void project(const RayDS& g, float d, float& xs, float& ys) {
  DS p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = ds_add(ds_mul(g.r[a], DS{d, 0.f}), DS{g.t[a], 0.f});
  const float z = __fadd_rn(p[2].hi, p[2].lo);
  const bool bad = fabsf(p[2].hi) < 1e-8f;
  const DS sz = {bad ? 1e-8f : p[2].hi, bad ? 0.f : p[2].lo};
  xs = ds_div(p[0], sz);
  ys = ds_div(p[1], sz);
  if (!(z > 1e-6f)) {
    xs = -1e9f;
    ys = -1e9f;
  }
}

// The one-thread-per-pixel kernels' rays: with Comp, computed once per
// view into `cache` ([V][6][kThreads] floats of dynamic shared memory,
// this thread's column) and read back per plane; else made per plane
// from the rel, as the float32 projection always did.
template <bool Comp>
__device__ __forceinline__ void cache_rays(float* cache, const float* __restrict__ rels,
                                           int V, float px, float py) {
  if constexpr (Comp) {
    for (int v = 0; v < V; ++v) {
      const RayDS g = make_ray<true>(rels + 16 * v, px, py);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cache[(v * 6 + 2 * a) * kThreads + threadIdx.x] = g.r[a].hi;
        cache[(v * 6 + 2 * a + 1) * kThreads + threadIdx.x] = g.r[a].lo;
      }
    }
  }
}

template <bool Comp>
__device__ __forceinline__ RayOf<Comp> view_ray(const float* cache,
                                                const float* __restrict__ rels, int v,
                                                float px, float py) {
  if constexpr (Comp) {
    RayDS g;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      g.r[a] = DS{cache[(v * 6 + 2 * a) * kThreads + threadIdx.x],
                  cache[(v * 6 + 2 * a + 1) * kThreads + threadIdx.x]};
      g.t[a] = __ldg(rels + 16 * v + 4 * a + 3);
    }
    return g;
  } else {
    return make_ray<false>(rels + 16 * v, px, py);
  }
}

inline long long ray_cache_bytes(int V) {
  return (long long)V * 6 * kThreads * (long long)sizeof(float);
}

// The block's tap descriptors of one view: for each (plane j, pixel p) the
// float4 offset of the top-left tap of the in-image 2x2 block, and the
// weights of its 4 taps in the order (x, y) (x+1, y) (x, y+1) (x+1, y+1).
template <int KT, int NPIX>
struct Descs {
  float4 w[KT][NPIX];
  int off[KT][NPIX];
};

// The descriptor of ref pixel (ray g, Ray or RayDS) at depth d, G quads a
// source pixel (see the design note above). Needs H, W >= 2.
template <class R>
__device__ __forceinline__ void describe(const R& g, float d, int H, int W,
                                         int G, int& off, float4& w) {
  float xs, ys;
  project(g, d, xs, ys);
  const float x0 = floorf(xs), y0 = floorf(ys);
  const float fx = __fsub_rn(xs, x0), fy = __fsub_rn(ys, y0);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  // clamped in float first: a coordinate far outside the image (or NaN)
  // never reaches an int conversion, and -2 / W mean "no tap in the image"
  const int xi = (int)fminf(fmaxf(x0, -2.f), (float)W);
  const int yi = (int)fminf(fmaxf(y0, -2.f), (float)H);
  const int xb = min(max(xi, 0), W - 2), yb = min(max(yi, 0), H - 2);
  const float ax0 = xi == xb ? gx : (xi == xb - 1 ? fx : 0.f);
  const float ax1 = xi == xb ? fx : (xi == xb + 1 ? gx : 0.f);
  const float ay0 = yi == yb ? gy : (yi == yb - 1 ? fy : 0.f);
  const float ay1 = yi == yb ? fy : (yi == yb + 1 ? gy : 0.f);
  w = make_float4(__fmul_rn(ax0, ay0), __fmul_rn(ax1, ay0),
                  __fmul_rn(ax0, ay1), __fmul_rn(ax1, ay1));
  off = (yb * W + xb) * G;
}

// This lane's channel quad of the bilinear sample: the 4 taps of the block
// at `off` (srcq: the view's source image at this lane's quad; rowq: quads
// per source row), summed in the plain version's tap order.
template <int G, class Q>
__device__ __forceinline__ float4 gather(const Q* __restrict__ srcq,
                                         int off, float4 w, int rowq) {
  const Q* b = srcq + off;
  const float4 v0 = quad(b), v1 = quad(b + G);
  const float4 v2 = quad(b + rowq), v3 = quad(b + rowq + G);
  float4 r;
  r.x = fmaf(v3.x, w.w, fmaf(v2.x, w.z, fmaf(v1.x, w.y, v0.x * w.x)));
  r.y = fmaf(v3.y, w.w, fmaf(v2.y, w.z, fmaf(v1.y, w.y, v0.y * w.x)));
  r.z = fmaf(v3.z, w.w, fmaf(v2.z, w.z, fmaf(v1.z, w.y, v0.z * w.x)));
  r.w = fmaf(v3.w, w.w, fmaf(v2.w, w.z, fmaf(v1.w, w.y, v0.w * w.x)));
  return r;
}

// Lane q of a pixel describes planes j = jj * G + q of its view (each
// (pixel, plane, view) is projected once, not once per quad); __syncwarp
// suffices, since a pixel's G lanes share a warp.
template <int C, int KT, class R>
__device__ __forceinline__ void describe_view(Descs<KT, Tile<C>::NPIX>& ds,
                                              const Tile<C>& t, const R& g,
                                              const float* d, int H, int W) {
  constexpr int G = Tile<C>::G, KPL = (KT + G - 1) / G;
  __syncwarp();  // the previous view's descriptors are read
#pragma unroll
  for (int jj = 0; jj < KPL; ++jj) {
    const int j = jj * G + t.q;
    if (KT % G == 0 || j < KT) {
      int off;
      float4 w;
      describe(g, d[jj], H, W, G, off, w);
      ds.off[j][t.p] = off;
      ds.w[j][t.p] = w;
    }
  }
  __syncwarp();
}

// This lane's depths of the planes it describes (a plane past K repeats
// plane K-1; its output is not stored).
template <int C, int KT>
__device__ __forceinline__ void lane_depths(float* d, const Tile<C>& t,
                                            const float* __restrict__ depths,
                                            int k0, int K, long long HW,
                                            long long pix) {
  constexpr int G = Tile<C>::G, KPL = (KT + G - 1) / G;
#pragma unroll
  for (int jj = 0; jj < KPL; ++jj)
    d[jj] = __ldg(depths + min(k0 + min(jj * G + t.q, KT - 1), K - 1) * HW + pix);
}

// Plane k of the block's output, out_k[c, y, x0 + i] for every channel,
// through the shared-memory tile `buf` (one __syncthreads; the caller
// alternates two buffers, so a buffer is rewritten only after every lane
// has passed the barrier that followed its last read).
template <int C, class T>
__device__ __forceinline__ void store_plane(float* buf, float4 v,
                                            const Tile<C>& t,
                                            T* __restrict__ out_k,
                                            long long HW, int W, bool live) {
  constexpr int NPIX = Tile<C>::NPIX, S = Tile<C>::S;
  buf[(4 * t.q + 0) * S + t.p] = v.x;
  buf[(4 * t.q + 1) * S + t.p] = v.y;
  buf[(4 * t.q + 2) * S + t.p] = v.z;
  buf[(4 * t.q + 3) * S + t.p] = v.w;
  __syncthreads();
  if (!live) return;
  T* row = out_k + (long long)t.y * W + t.x0;
#pragma unroll
  for (int r = 0; r < C * NPIX / kThreads; ++r) {
    const int e = r * kThreads + threadIdx.x;
    const int c = e / NPIX, i = e % NPIX;
    if (t.x0 + i < W) row[c * HW + i] = from_f32<T>(buf[c * S + i]);
  }
}

// Sums a[0..KT) over a pixel's G lanes (lanes q of one pixel are
// neighbours) in log2(G) butterfly steps, each halving what a lane keeps:
// lane q ends with the totals of planes q * KT/G + i in a[i], i < KT/G.
template <int KT, int G>
__device__ __forceinline__ void reduce_scatter(float* a, int q) {
  int n = KT;
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const bool up = (q & o) != 0;
    n >>= 1;
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      if (i < n) {
        const float send = up ? a[i] : a[i + n];
        const float keep = up ? a[i + n] : a[i];
        a[i] = keep + __shfl_xor_sync(0xffffffffu, send, o, G);
      }
    }
  }
}

template <int C, int KT, class T, bool Comp>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
sweep_pair_kernel(const T* __restrict__ ref, const T* __restrict__ srcs,
                  const float* __restrict__ rels, const float* __restrict__ depths,
                  T* __restrict__ out, int V, int D, int H, int W) {
  constexpr int G = Tile<C>::G, NPIX = Tile<C>::NPIX, KPL = (KT + G - 1) / G;
  static_assert(KT % G == 0, "each lane keeps KT / G planes' totals");
  __shared__ Descs<KT, NPIX> ds;
  __shared__ float tile[KT][NPIX];
  const Tile<C> t(W);
  const int groups = (D + KT - 1) / KT;
  const int v = blockIdx.y / groups, k0 = (blockIdx.y % groups) * KT;
  const long long HW = (long long)H * W;
  const long long pix = (long long)t.y * W + t.x;
  const float4 rv = quad(reinterpret_cast<const Quad<T>*>(ref + pix * C) + t.q);
  float d[KPL];
  lane_depths<C, KT>(d, t, depths, k0, D, HW, pix);
  describe_view<C, KT>(ds, t, make_ray<Comp>(rels + 16 * v, (float)t.x, (float)t.y),
                       d, H, W);
  const Quad<T>* src = reinterpret_cast<const Quad<T>*>(srcs) + (long long)v * HW * G + t.q;
  float dot[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const float4 s = gather<G>(src, ds.off[j][t.p], ds.w[j][t.p], W * G);
    dot[j] = s.x * rv.x + s.y * rv.y + s.z * rv.z + s.w * rv.w;
  }
  reduce_scatter<KT, G>(dot, t.q);
#pragma unroll
  for (int i = 0; i < KT / G; ++i) tile[t.q * (KT / G) + i][t.p] = dot[i] / (float)C;
  __syncthreads();
  T* base = out + ((long long)v * D + k0) * HW + (long long)t.y * W + t.x0;
#pragma unroll
  for (int r = 0; r < KT * NPIX / kThreads; ++r) {
    const int e = r * kThreads + threadIdx.x;
    const int j = e / NPIX, i = e % NPIX;
    if (k0 + j < D && t.x0 + i < W) base[j * HW + i] = from_f32<T>(tile[j][i]);
  }
}

template <int C, class T, bool Comp>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
sweep_cost_kernel(const T* __restrict__ ref, const T* __restrict__ srcs,
                  const float* __restrict__ rels, const float* __restrict__ depths,
                  const float* __restrict__ weights, T* __restrict__ out,
                  int V, int K, int H, int W) {
  constexpr int G = Tile<C>::G, NPIX = Tile<C>::NPIX, KT = kCostPlanes;
  constexpr int KPL = (KT + G - 1) / G;
  __shared__ Descs<KT, NPIX> ds;
  __shared__ float tile[2][C * Tile<C>::S];
  const Tile<C> t(W);
  const int k0 = blockIdx.y * KT;
  const long long HW = (long long)H * W;
  const long long pix = (long long)t.y * W + t.x;
  float d[KPL];
  lane_depths<C, KT>(d, t, depths, k0, K, HW, pix);
  const float4 rv = quad(reinterpret_cast<const Quad<T>*>(ref + pix * C) + t.q);
  float4 acc[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  float wsum = 0.f;
  for (int v = 0; v < V; ++v) {
    describe_view<C, KT>(ds, t, make_ray<Comp>(rels + 16 * v, (float)t.x, (float)t.y),
                         d, H, W);
    const float wv = __ldg(weights + v * HW + pix);
    const Quad<T>* src = reinterpret_cast<const Quad<T>*>(srcs) + (long long)v * HW * G + t.q;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float4 s = gather<G>(src, ds.off[j][t.p], ds.w[j][t.p], W * G);
      acc[j].x += (s.x * rv.x) * wv;
      acc[j].y += (s.y * rv.y) * wv;
      acc[j].z += (s.z * rv.z) * wv;
      acc[j].w += (s.w * rv.w) * wv;
    }
    wsum += wv;
  }
  const float denom = wsum + 1e-5f;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const float4 o = make_float4(acc[j].x / denom, acc[j].y / denom,
                                 acc[j].z / denom, acc[j].w / denom);
    store_plane<C, T>(tile[j & 1], o, t, out + (long long)(k0 + j) * C * HW, HW, W,
                      k0 + j < K);
  }
}

template <int C, class T, bool Comp>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
sweep_var_kernel(const T* __restrict__ ref, const T* __restrict__ srcs,
                 const float* __restrict__ rels, const float* __restrict__ depths,
                 T* __restrict__ out, int V, int K, int H, int W) {
  constexpr int G = Tile<C>::G, NPIX = Tile<C>::NPIX, KT = kVarPlanes;
  constexpr int KPL = (KT + G - 1) / G;
  __shared__ Descs<KT, NPIX> ds;
  __shared__ float tile[2][C * Tile<C>::S];
  const Tile<C> t(W);
  const int k0 = blockIdx.y * KT;
  const long long HW = (long long)H * W;
  const long long pix = (long long)t.y * W + t.x;
  float d[KPL];
  lane_depths<C, KT>(d, t, depths, k0, K, HW, pix);
  const float4 rv = quad(reinterpret_cast<const Quad<T>*>(ref + pix * C) + t.q);
  // s: ref + sum of the warps, sq: ref^2 + sum of their squares
  float4 s[KT], sq[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    s[j] = rv;
    sq[j] = make_float4(rv.x * rv.x, rv.y * rv.y, rv.z * rv.z, rv.w * rv.w);
  }
  for (int v = 0; v < V; ++v) {
    describe_view<C, KT>(ds, t, make_ray<Comp>(rels + 16 * v, (float)t.x, (float)t.y),
                         d, H, W);
    const Quad<T>* src = reinterpret_cast<const Quad<T>*>(srcs) + (long long)v * HW * G + t.q;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const float4 w = gather<G>(src, ds.off[j][t.p], ds.w[j][t.p], W * G);
      s[j].x += w.x; s[j].y += w.y; s[j].z += w.z; s[j].w += w.w;
      sq[j].x += w.x * w.x; sq[j].y += w.y * w.y;
      sq[j].z += w.z * w.z; sq[j].w += w.w * w.w;
    }
  }
  const float n = (float)(V + 1);
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    const float mx = s[j].x / n, my = s[j].y / n, mz = s[j].z / n, mw = s[j].w / n;
    const float4 o = make_float4(sq[j].x / n - mx * mx, sq[j].y / n - my * my,
                                 sq[j].z / n - mz * mz, sq[j].w / n - mw * mw);
    store_plane<C, T>(tile[j & 1], o, t, out + (long long)(k0 + j) * C * HW, HW, W,
                      k0 + j < K);
  }
}

// Cost and variance with one thread per pixel for small C: the thread
// projects each (plane, view) once and gathers all G quads of each tap
// itself. A block covers kThreads consecutive pixels of the flattened
// image (x fastest, so the stores of a channel are 128-byte runs) and
// walks planes k0 .. k1-1.
template <int C, class T, bool Comp>
__global__ void __launch_bounds__(kThreads, kBlocksPerSMWide)
sweep_cost_wide_kernel(const T* __restrict__ ref, const T* __restrict__ srcs,
                       const float* __restrict__ rels, const float* __restrict__ depths,
                       const float* __restrict__ weights, T* __restrict__ out,
                       int V, int K, int H, int W, int KB) {
  constexpr int G = C / 4;
  const long long HW = (long long)H * W;
  const long long at = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = at < HW;
  const long long pix = live ? at : HW - 1;
  const int y = (int)(pix / W), x = (int)(pix % W);
  float4 rv[G];
#pragma unroll
  for (int q = 0; q < G; ++q) rv[q] = quad(reinterpret_cast<const Quad<T>*>(ref + pix * C) + q);
  float wsum = 0.f;
  for (int v = 0; v < V; ++v) wsum += __ldg(weights + v * HW + pix);
  const float denom = wsum + 1e-5f;
  extern __shared__ float rays[];
  cache_rays<Comp>(rays, rels, V, (float)x, (float)y);
  const Quad<T>* src = reinterpret_cast<const Quad<T>*>(srcs);
  const int k0 = blockIdx.y * KB, k1 = min(K, k0 + KB);
  for (int k = k0; k < k1; ++k) {
    const float d = __ldg(depths + k * HW + pix);
    float4 acc[G];
#pragma unroll
    for (int q = 0; q < G; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int v = 0; v < V; ++v) {
      int off;
      float4 w;
      describe(view_ray<Comp>(rays, rels, v, (float)x, (float)y), d, H, W, G, off, w);
      const float wv = __ldg(weights + v * HW + pix);
      const Quad<T>* sv = src + v * HW * G;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float4 s = gather<G>(sv + q, off, w, W * G);
        acc[q].x += (s.x * rv[q].x) * wv;
        acc[q].y += (s.y * rv[q].y) * wv;
        acc[q].z += (s.z * rv[q].z) * wv;
        acc[q].w += (s.w * rv[q].w) * wv;
      }
    }
    if (!live) continue;
    T* o = out + (long long)k * C * HW + pix;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      o[(4 * q + 0) * HW] = from_f32<T>(acc[q].x / denom);
      o[(4 * q + 1) * HW] = from_f32<T>(acc[q].y / denom);
      o[(4 * q + 2) * HW] = from_f32<T>(acc[q].z / denom);
      o[(4 * q + 3) * HW] = from_f32<T>(acc[q].w / denom);
    }
  }
}

template <int C, class T, bool Comp>
__global__ void __launch_bounds__(kThreads, kBlocksPerSMWide)
sweep_var_wide_kernel(const T* __restrict__ ref, const T* __restrict__ srcs,
                      const float* __restrict__ rels, const float* __restrict__ depths,
                      T* __restrict__ out, int V, int K, int H, int W, int KB) {
  constexpr int G = C / 4;
  const long long HW = (long long)H * W;
  const long long at = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = at < HW;
  const long long pix = live ? at : HW - 1;
  const int y = (int)(pix / W), x = (int)(pix % W);
  float4 rv[G];
#pragma unroll
  for (int q = 0; q < G; ++q) rv[q] = quad(reinterpret_cast<const Quad<T>*>(ref + pix * C) + q);
  const float n = (float)(V + 1);
  extern __shared__ float rays[];
  cache_rays<Comp>(rays, rels, V, (float)x, (float)y);
  const Quad<T>* src = reinterpret_cast<const Quad<T>*>(srcs);
  const int k0 = blockIdx.y * KB, k1 = min(K, k0 + KB);
  for (int k = k0; k < k1; ++k) {
    const float d = __ldg(depths + k * HW + pix);
    // s: ref + sum of the warps, sq: ref^2 + sum of their squares
    float4 s[G], sq[G];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      s[q] = rv[q];
      sq[q] = make_float4(rv[q].x * rv[q].x, rv[q].y * rv[q].y,
                          rv[q].z * rv[q].z, rv[q].w * rv[q].w);
    }
#pragma unroll 4
    for (int v = 0; v < V; ++v) {
      int off;
      float4 w;
      describe(view_ray<Comp>(rays, rels, v, (float)x, (float)y), d, H, W, G, off, w);
      const Quad<T>* sv = src + v * HW * G;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float4 u = gather<G>(sv + q, off, w, W * G);
        s[q].x += u.x; s[q].y += u.y; s[q].z += u.z; s[q].w += u.w;
        sq[q].x += u.x * u.x; sq[q].y += u.y * u.y;
        sq[q].z += u.z * u.z; sq[q].w += u.w * u.w;
      }
    }
    if (!live) continue;
    T* o = out + (long long)k * C * HW + pix;
#pragma unroll
    for (int q = 0; q < G; ++q) {
      const float mx = s[q].x / n, my = s[q].y / n, mz = s[q].z / n, mw = s[q].w / n;
      o[(4 * q + 0) * HW] = from_f32<T>(sq[q].x / n - mx * mx);
      o[(4 * q + 1) * HW] = from_f32<T>(sq[q].y / n - my * my);
      o[(4 * q + 2) * HW] = from_f32<T>(sq[q].z / n - mz * mz);
      o[(4 * q + 3) * HW] = from_f32<T>(sq[q].w / n - mw * mw);
    }
  }
}

// The *_any kernels: a runtime channel count C, every channel a scalar
// load (so no alignment of a pixel's channels is needed), one thread a
// pixel; the tap sum is gather()'s, channel by channel.
constexpr int kAnyChannels = 16;  // channels a cost or variance thread keeps

template <class T>
__device__ __forceinline__ float scalar(const T* p) { return to_f32(__ldg(p)); }

template <class T>
__device__ __forceinline__ float gather1(const T* __restrict__ b, float4 w, int C, int row) {
  const float v0 = scalar(b), v1 = scalar(b + C), v2 = scalar(b + row), v3 = scalar(b + row + C);
  return fmaf(v3, w.w, fmaf(v2, w.z, fmaf(v1, w.y, v0 * w.x)));
}

// pair mode: out[v, k] for view v = blockIdx.z, planes blockIdx.y * KB ..
template <class T, bool Comp>
__global__ void __launch_bounds__(kThreads, kBlocksPerSMWide)
sweep_pair_any_kernel(const T* __restrict__ ref, const T* __restrict__ srcs,
                      const float* __restrict__ rels, const float* __restrict__ depths,
                      T* __restrict__ out, int D, int H, int W, int C, int KB) {
  const long long HW = (long long)H * W;
  const long long at = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (at >= HW) return;
  const int y = (int)(at / W), x = (int)(at % W), v = blockIdx.z;
  const RayOf<Comp> g = make_ray<Comp>(rels + 16 * v, (float)x, (float)y);
  const T* rp = ref + at * C;
  const T* sv = srcs + (long long)v * HW * C;
  const int k0 = blockIdx.y * KB, k1 = min(D, k0 + KB);
  for (int k = k0; k < k1; ++k) {
    int off;
    float4 w;
    describe(g, __ldg(depths + k * HW + at), H, W, C, off, w);
    float dot = 0.f;
    for (int c = 0; c < C; ++c) dot += gather1(sv + off + c, w, C, W * C) * scalar(rp + c);
    out[((long long)v * D + k) * HW + at] = from_f32<T>(dot / (float)C);
  }
}

// cost (Var = false) and variance (Var = true) modes: channels
// blockIdx.z * kAnyChannels .. of planes blockIdx.y * KB ..
template <bool Var, class T, bool Comp>
__global__ void __launch_bounds__(kThreads, kBlocksPerSMWide)
sweep_any_kernel(const T* __restrict__ ref, const T* __restrict__ srcs,
                 const float* __restrict__ rels, const float* __restrict__ depths,
                 const float* __restrict__ weights, T* __restrict__ out, int V, int K, int H,
                 int W, int C, int KB) {
  constexpr int N = kAnyChannels;
  const long long HW = (long long)H * W;
  const long long at = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = at < HW;
  const long long pix = live ? at : HW - 1;
  const int y = (int)(pix / W), x = (int)(pix % W);
  const int c0 = blockIdx.z * N, nc = min(N, C - c0);
  float rv[N];
#pragma unroll
  for (int c = 0; c < N; ++c) rv[c] = c < nc ? scalar(ref + pix * C + c0 + c) : 0.f;
  float wsum = 0.f;
  if constexpr (!Var)
    for (int v = 0; v < V; ++v) wsum += __ldg(weights + v * HW + pix);
  const float denom = wsum + 1e-5f, n = (float)(V + 1);
  extern __shared__ float rays[];
  cache_rays<Comp>(rays, rels, V, (float)x, (float)y);
  const int k0 = blockIdx.y * KB, k1 = min(K, k0 + KB);
  for (int k = k0; k < k1; ++k) {
    const float d = __ldg(depths + k * HW + pix);
    // cost: the weighted sums; variance: s = ref + the warps, sq = their squares
    float s[N], sq[N];
#pragma unroll
    for (int c = 0; c < N; ++c) {
      s[c] = Var ? rv[c] : 0.f;
      sq[c] = rv[c] * rv[c];
    }
    for (int v = 0; v < V; ++v) {
      int off;
      float4 w;
      describe(view_ray<Comp>(rays, rels, v, (float)x, (float)y), d, H, W, C, off, w);
      const T* b = srcs + (long long)v * HW * C + off + c0;
      const float wv = Var ? 0.f : __ldg(weights + v * HW + pix);
#pragma unroll
      for (int c = 0; c < N; ++c) {
        if (c < nc) {  // predicated, so s and sq stay in registers
          const float u = gather1(b + c, w, C, W * C);
          if constexpr (Var) {
            s[c] += u;
            sq[c] += u * u;
          } else {
            s[c] += (u * rv[c]) * wv;
          }
        }
      }
    }
    if (!live) continue;
    T* o = out + ((long long)k * C + c0) * HW + pix;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (c < nc) {
        if constexpr (Var) {
          const float m = s[c] / n;
          o[c * HW] = from_f32<T>(sq[c] / n - m * m);
        } else {
          o[c * HW] = from_f32<T>(s[c] / denom);
        }
      }
    }
  }
}

template <int C>
inline unsigned tiles_for(int H, int W) {
  return (unsigned)H * (unsigned)((W + Tile<C>::NPIX - 1) / Tile<C>::NPIX);
}

inline unsigned wide_blocks(int H, int W) {
  return (unsigned)(((long long)H * W + kThreads - 1) / kThreads);
}

// Planes per one-thread-per-pixel block: 8 (a sweep chunk), halved while
// the grid would have fewer than kMinBlocks blocks (more threads in flight
// on a small stage).
inline int planes_per_block(unsigned blocks, int K) {
  int kb = 8;
  while (kb > 1 && (long long)blocks * ((K + kb - 1) / kb) < kMinBlocks) kb /= 2;
  return kb;
}

template <int C, int KT, class T, bool Comp>
void launch_pair(const T* ref, const T* srcs, const float* rels,
                 const float* depths, T* out, int V, int D, int H, int W,
                 cudaStream_t s) {
  const dim3 grid(tiles_for<C>(H, W), (unsigned)(V * ((D + KT - 1) / KT)));
  sweep_pair_kernel<C, KT, T, Comp><<<grid, kThreads, 0, s>>>(ref, srcs, rels, depths, out,
                                                              V, D, H, W);
}

// Dynamic shared memory of a one-thread-per-pixel kernel: the compensated
// rays of V views, or none. Returns a CUDA error, or kTooManyViews.
template <class Kernel>
int wide_shared(Kernel kernel, bool comp, int V, size_t& bytes) {
  bytes = 0;
  if (!comp) return 0;
  const long long b = ray_cache_bytes(V);
  if (b > kMaxSharedBytes) return kTooManyViews;
  bytes = (size_t)b;
  if (b <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)b);
}

template <int C, class T, bool Comp>
int launch_cost(const T* ref, const T* srcs, const float* rels,
                const float* depths, const float* weights, T* out, int V,
                int K, int H, int W, cudaStream_t s) {
  if constexpr (C < kQuadLanesFrom) {
    const unsigned blocks = wide_blocks(H, W);
    const int kb = planes_per_block(blocks, K);
    size_t smem;
    const int rc = wide_shared(sweep_cost_wide_kernel<C, T, Comp>, Comp, V, smem);
    if (rc != 0) return rc;
    sweep_cost_wide_kernel<C, T, Comp><<<dim3(blocks, (K + kb - 1) / kb), kThreads, smem, s>>>(
        ref, srcs, rels, depths, weights, out, V, K, H, W, kb);
  } else {
    const dim3 grid(tiles_for<C>(H, W), (K + kCostPlanes - 1) / kCostPlanes);
    sweep_cost_kernel<C, T, Comp><<<grid, kThreads, 0, s>>>(ref, srcs, rels, depths,
                                                            weights, out, V, K, H, W);
  }
  return 0;
}

template <int C, class T, bool Comp>
int launch_var(const T* ref, const T* srcs, const float* rels,
               const float* depths, T* out, int V, int K, int H, int W,
               cudaStream_t s) {
  if constexpr (C < kQuadLanesFrom) {
    const unsigned blocks = wide_blocks(H, W);
    const int kb = planes_per_block(blocks, K);
    size_t smem;
    const int rc = wide_shared(sweep_var_wide_kernel<C, T, Comp>, Comp, V, smem);
    if (rc != 0) return rc;
    sweep_var_wide_kernel<C, T, Comp><<<dim3(blocks, (K + kb - 1) / kb), kThreads, smem, s>>>(
        ref, srcs, rels, depths, out, V, K, H, W, kb);
  } else {
    const dim3 grid(tiles_for<C>(H, W), (K + kVarPlanes - 1) / kVarPlanes);
    sweep_var_kernel<C, T, Comp><<<grid, kThreads, 0, s>>>(ref, srcs, rels, depths, out, V,
                                                           K, H, W);
  }
  return 0;
}

// The *_any kernels' launches (any C): planes per block as the
// one-thread-per-pixel kernels', counting the channel chunks' blocks.
template <class T, bool Comp>
void launch_pair_any(const T* ref, const T* srcs, const float* rels, const float* depths,
                     T* out, int V, int D, int H, int W, int C, cudaStream_t s) {
  const unsigned blocks = wide_blocks(H, W);
  const int kb = planes_per_block(blocks * (unsigned)V, D);
  sweep_pair_any_kernel<T, Comp><<<dim3(blocks, (D + kb - 1) / kb, V), kThreads, 0, s>>>(
      ref, srcs, rels, depths, out, D, H, W, C, kb);
}

template <bool Var, class T, bool Comp>
int launch_any(const T* ref, const T* srcs, const float* rels, const float* depths,
               const float* weights, T* out, int V, int K, int H, int W, int C,
               cudaStream_t s) {
  const unsigned blocks = wide_blocks(H, W), chunks = (C + kAnyChannels - 1) / kAnyChannels;
  const int kb = planes_per_block(blocks * chunks, K);
  size_t smem;
  const int rc = wide_shared(sweep_any_kernel<Var, T, Comp>, Comp, V, smem);
  if (rc != 0) return rc;
  sweep_any_kernel<Var, T, Comp><<<dim3(blocks, (K + kb - 1) / kb, chunks), kThreads, smem, s>>>(
      ref, srcs, rels, depths, weights, out, V, K, H, W, C, kb);
  return 0;
}

inline bool bad_size(int H, int W, int C) {
  return H < 2 || W < 2 || C < 1 || (long long)H * W * C >= (1LL << 31);
}

// The entries of one feature type T (float or bfloat16 bits) and one
// projection (Comp: compensated).
template <class T, bool Comp>
int corr_entry(const T* ref, const T* srcs, const float* rels, const float* depths,
               T* out, int V, int D, int H, int W, int C, void* stream) {
  if ((long long)V * D * H * W == 0) return 0;
  if (bad_size(H, W, C)) return kBadSize;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 4: launch_pair<4, 4, T, Comp>(ref, srcs, rels, depths, out, V, D, H, W, s); break;
    case 8: launch_pair<8, 8, T, Comp>(ref, srcs, rels, depths, out, V, D, H, W, s); break;
    case 16: launch_pair<16, 8, T, Comp>(ref, srcs, rels, depths, out, V, D, H, W, s); break;
    case 32: launch_pair<32, 8, T, Comp>(ref, srcs, rels, depths, out, V, D, H, W, s); break;
    case 64: launch_pair<64, 16, T, Comp>(ref, srcs, rels, depths, out, V, D, H, W, s); break;
    default: launch_pair_any<T, Comp>(ref, srcs, rels, depths, out, V, D, H, W, C, s);
  }
  return (int)cudaGetLastError();
}

template <class T, bool Comp>
int cost_entry(const T* ref, const T* srcs, const float* rels, const float* depths,
               const float* weights, T* out, int V, int K, int H, int W, int C,
               void* stream) {
  if ((long long)K * H * W == 0) return 0;
  if (bad_size(H, W, C)) return kBadSize;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  switch (C) {
    case 4: rc = launch_cost<4, T, Comp>(ref, srcs, rels, depths, weights, out, V, K, H, W, s); break;
    case 8: rc = launch_cost<8, T, Comp>(ref, srcs, rels, depths, weights, out, V, K, H, W, s); break;
    case 16: rc = launch_cost<16, T, Comp>(ref, srcs, rels, depths, weights, out, V, K, H, W, s); break;
    case 32: rc = launch_cost<32, T, Comp>(ref, srcs, rels, depths, weights, out, V, K, H, W, s); break;
    case 64: rc = launch_cost<64, T, Comp>(ref, srcs, rels, depths, weights, out, V, K, H, W, s); break;
    default: rc = launch_any<false, T, Comp>(ref, srcs, rels, depths, weights, out, V, K, H, W, C, s);
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}

template <class T, bool Comp>
int var_entry(const T* ref, const T* srcs, const float* rels, const float* depths,
              T* out, int V, int K, int H, int W, int C, void* stream) {
  if ((long long)K * H * W == 0) return 0;
  if (bad_size(H, W, C)) return kBadSize;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  switch (C) {
    case 4: rc = launch_var<4, T, Comp>(ref, srcs, rels, depths, out, V, K, H, W, s); break;
    case 8: rc = launch_var<8, T, Comp>(ref, srcs, rels, depths, out, V, K, H, W, s); break;
    case 16: rc = launch_var<16, T, Comp>(ref, srcs, rels, depths, out, V, K, H, W, s); break;
    case 32: rc = launch_var<32, T, Comp>(ref, srcs, rels, depths, out, V, K, H, W, s); break;
    case 64: rc = launch_var<64, T, Comp>(ref, srcs, rels, depths, out, V, K, H, W, s); break;
    default: rc = launch_any<true, T, Comp>(ref, srcs, rels, depths, nullptr, out, V, K, H, W, C, s);
  }
  return rc != 0 ? rc : (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* error_string(int code) {
  if (code == kBadSize) return "unsupported size (take H, W >= 2, C >= 1 and H*W*C < 2^31)";
  if (code == kTooManyViews)
    return "too many source views for the compensated projection's ray cache "
           "(take V <= 37)";
  return cudaGetErrorString((cudaError_t)code);
}

// The entries, sweep_<mode>_<f32|bf16>[_comp]: ref, srcs and out in float32
// or bfloat16, the rest float32; _comp takes the compensated projection.
//   pair mode (K1)      sweep_corr: ref [H,W,C], srcs [V,H,W,C], rels [V,4,4],
//                       depths [D,H,W] -> out [V,D,H,W], every view's volume
//                       in one launch
//   cost mode (K2)      sweep_cost: ... depths [K,H,W], weights [V,H,W]
//                       -> out [K,C,H,W]
//   variance mode (K2v) sweep_var: ... depths [K,H,W] -> out [K,C,H,W]
#define SWEEP_ENTRIES(SUFFIX, T, COMP)                                               \
  extern "C" int sweep_corr_##SUFFIX(const T* ref, const T* srcs, const float* rels,  \
                                     const float* depths, T* out, int V, int D,     \
                                     int H, int W, int C, void* stream) {           \
    return corr_entry<T, COMP>(ref, srcs, rels, depths, out, V, D, H, W, C, stream); \
  }                                                                                 \
  extern "C" int sweep_cost_##SUFFIX(const T* ref, const T* srcs, const float* rels,  \
                                     const float* depths, const float* weights,     \
                                     T* out, int V, int K, int H, int W, int C,     \
                                     void* stream) {                                \
    return cost_entry<T, COMP>(ref, srcs, rels, depths, weights, out, V, K, H, W, C,  \
                               stream);                                             \
  }                                                                                 \
  extern "C" int sweep_var_##SUFFIX(const T* ref, const T* srcs, const float* rels,   \
                                    const float* depths, T* out, int V, int K,      \
                                    int H, int W, int C, void* stream) {            \
    return var_entry<T, COMP>(ref, srcs, rels, depths, out, V, K, H, W, C, stream);  \
  }

SWEEP_ENTRIES(f32, float, false)
SWEEP_ENTRIES(bf16, bf16_t, false)
SWEEP_ENTRIES(f32_comp, float, true)
SWEEP_ENTRIES(bf16_comp, bf16_t, true)
