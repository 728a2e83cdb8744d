// Plane-sweep kernels for Hopper (sm_90a): one projection and tap code,
// three modes.
//
// Replaces:
//   pair mode     -> deep3d_aerial_tpu/ops/pallas_sweep.py:_sweep_corr_kernel
//                    (entry sweep_corr_chunk_pallas; the AdaMVS stage-1 pair
//                    volumes, models/adamvs.py:_pair_volumes_pallas)
//   cost mode     -> deep3d_aerial_tpu/ops/pallas_sweep.py:_sweep_cost_kernel,
//                    mode='corr' (entry sweep_cost_chunk_prepared; every
//                    AdaMVS stage's cost chunk, models/cascade.py:_pallas_chunk_costs)
//   variance mode -> the same TPU kernel, mode='variance' (every MSREDNet
//                    stage's cost chunk; oracle models/cascade.py:variance_cost_plane)
//
// pair:     out[k,y,x]   = mean_c ref[y,x,c] * warp(src, k)[y,x,c]
// cost:     out[k,c,y,x] = sum_v w_v[y,x] * ref[y,x,c] * warp(src_v, k)[y,x,c]
//                          / (sum_v w_v[y,x] + 1e-5)
// variance: out[k,c,y,x] = E[f^2] - E[f]^2 over f in {ref[y,x,c]} and the
//                          V values warp(src_v, k)[y,x,c] (n = V + 1, no weights)
// warp(src, k)[y,x] is the bilinear sample of src [H,W,C] at the projection
// of ref pixel (x, y) at depth depths[k,y,x] through the view's 12 rel
// scalars (rows 0-2 of src_P @ inv(ref_P)); each of the 4 taps is zeroed on
// its own when it falls outside the image, and a point at or behind the
// source camera (z <= 1e-6) samples nothing.
//
// What bounds it on an H100: bytes. Per (plane, pixel, view) the kernel does
// ~12 flops of geometry and 8 per channel, against 4 taps of C contiguous
// floats (32-128 B each) -- far below the card's ~20 flop/byte balance point.
// The unique bytes are the inputs read once plus the output written once;
// the tap reads themselves repeat across planes and neighbouring pixels and
// are served by L1/L2 (a stage's source features are at most 4 x 5.1 Mpx x
// 8 ch x 4 B = 653 MB at 1856x2752, and 6.3 MB at 384x512 stage 1).
//
// Design: one thread per (plane k, ref pixel), 256 threads a block, x the
// fastest index so a warp covers 32 neighbouring ref pixels whose taps land
// on neighbouring source pixels. Features are channels-last, so one tap is
// C/4 16-byte loads of one contiguous run. The sums over C and over views
// stay in registers; no [V,K,H,W,C] warp buffer exists and only the output
// reaches device memory (the variance mode keeps its sum and sum of
// squares per channel the same way). No source windows: a tap may land anywhere in the
// source image (the TPU kernel's windows and coverage flag are what made it
// miss at 1856x2752). The projection uses round-to-nearest intrinsics so no
// product and sum is fused into an FMA: the coordinates round exactly as the
// plain PyTorch chain's (ops/warp.py) do.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnsupported = 10000;  // channel count without an instance

struct Taps {
  const float* p[4];   // tap rows (nullptr: outside the image)
  float w[4];          // bilinear weights, order (x0,y0) (x1,y0) (x0,y1) (x1,y1)
};

__device__ __forceinline__ Taps project_taps(const float* __restrict__ rel,
                                             const float* __restrict__ src,
                                             int C, int H, int W,
                                             float px, float py, float d) {
  float p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ray = __fadd_rn(__fadd_rn(__fmul_rn(rel[4 * a], px),
                                          __fmul_rn(rel[4 * a + 1], py)),
                                rel[4 * a + 2]);
    p[a] = __fadd_rn(__fmul_rn(ray, d), rel[4 * a + 3]);
  }
  const float z = p[2];
  const float sz = fabsf(z) < 1e-8f ? 1e-8f : z;
  float xs = __fdiv_rn(p[0], sz);
  float ys = __fdiv_rn(p[1], sz);
  if (!(z > 1e-6f)) {
    xs = -1e9f;
    ys = -1e9f;
  }
  const float x0 = floorf(xs), y0 = floorf(ys);
  const float fx = __fsub_rn(xs, x0), fy = __fsub_rn(ys, y0);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  // validity in float: a coordinate far outside the image never reaches
  // an int conversion
  const bool vx0 = x0 >= 0.f && x0 <= (float)(W - 1);
  const bool vx1 = x0 >= -1.f && x0 <= (float)(W - 2);
  const bool vy0 = y0 >= 0.f && y0 <= (float)(H - 1);
  const bool vy1 = y0 >= -1.f && y0 <= (float)(H - 2);
  const int ix = vx0 || vx1 ? (int)x0 : 0;
  const int iy = vy0 || vy1 ? (int)y0 : 0;
  Taps t;
  t.p[0] = vx0 && vy0 ? src + ((long long)iy * W + ix) * C : nullptr;
  t.p[1] = vx1 && vy0 ? src + ((long long)iy * W + ix + 1) * C : nullptr;
  t.p[2] = vx0 && vy1 ? src + ((long long)(iy + 1) * W + ix) * C : nullptr;
  t.p[3] = vx1 && vy1 ? src + ((long long)(iy + 1) * W + ix + 1) * C : nullptr;
  t.w[0] = __fmul_rn(gx, gy);
  t.w[1] = __fmul_rn(fx, gy);
  t.w[2] = __fmul_rn(gx, fy);
  t.w[3] = __fmul_rn(fx, fy);
  return t;
}

// The warped value of channels [c, c+4), summed in the plain version's
// order (tap 0 + tap 1 + tap 2 + tap 3), each product rounded on its own.
__device__ __forceinline__ float4 sample4(const Taps& t, int c) {
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (t.p[j] == nullptr) continue;
    const float4 v = __ldg(reinterpret_cast<const float4*>(t.p[j] + c));
    s.x = __fadd_rn(s.x, __fmul_rn(v.x, t.w[j]));
    s.y = __fadd_rn(s.y, __fmul_rn(v.y, t.w[j]));
    s.z = __fadd_rn(s.z, __fmul_rn(v.z, t.w[j]));
    s.w = __fadd_rn(s.w, __fmul_rn(v.w, t.w[j]));
  }
  return s;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
sweep_pair_kernel(const float* __restrict__ ref, const float* __restrict__ src,
                  const float* __restrict__ rel, const float* __restrict__ depths,
                  float* __restrict__ out, int K, int H, int W) {
  const long long HW = (long long)H * W;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)K * HW) return;
  const long long pix = idx % HW;
  const int y = (int)(pix / W), x = (int)(pix % W);
  const Taps t = project_taps(rel, src, C, H, W, (float)x, (float)y,
                              depths[idx]);
  const float* r = ref + pix * C;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < C; c += 4) {
    const float4 s = sample4(t, c);
    const float4 rv = __ldg(reinterpret_cast<const float4*>(r + c));
    acc += s.x * rv.x + s.y * rv.y + s.z * rv.z + s.w * rv.w;
  }
  out[idx] = acc / (float)C;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
sweep_cost_kernel(const float* __restrict__ ref, const float* __restrict__ srcs,
                  const float* __restrict__ rels, const float* __restrict__ depths,
                  const float* __restrict__ weights, float* __restrict__ out,
                  int V, int K, int H, int W) {
  const long long HW = (long long)H * W;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)K * HW) return;
  const long long pix = idx % HW;
  const int k = (int)(idx / HW);
  const int y = (int)(pix / W), x = (int)(pix % W);
  const float d = depths[idx];

  float rv[C];
#pragma unroll
  for (int c = 0; c < C; c += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(ref + pix * C + c));
    rv[c] = v.x; rv[c + 1] = v.y; rv[c + 2] = v.z; rv[c + 3] = v.w;
  }
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.f;
  float wsum = 0.f;
  for (int v = 0; v < V; ++v) {
    const float wv = weights[(long long)v * HW + pix];
    const Taps t = project_taps(rels + 12 * v, srcs + (long long)v * HW * C,
                                C, H, W, (float)x, (float)y, d);
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 s = sample4(t, c);
      acc[c] += (s.x * rv[c]) * wv;
      acc[c + 1] += (s.y * rv[c + 1]) * wv;
      acc[c + 2] += (s.z * rv[c + 2]) * wv;
      acc[c + 3] += (s.w * rv[c + 3]) * wv;
    }
    wsum += wv;
  }
  const float denom = wsum + 1e-5f;
  float* o = out + (long long)k * C * HW + pix;
#pragma unroll
  for (int c = 0; c < C; ++c) o[(long long)c * HW] = acc[c] / denom;
}

template <int C>
__global__ void __launch_bounds__(kThreads)
sweep_var_kernel(const float* __restrict__ ref, const float* __restrict__ srcs,
                 const float* __restrict__ rels, const float* __restrict__ depths,
                 float* __restrict__ out, int V, int K, int H, int W) {
  const long long HW = (long long)H * W;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (long long)K * HW) return;
  const long long pix = idx % HW;
  const int k = (int)(idx / HW);
  const int y = (int)(pix / W), x = (int)(pix % W);
  const float d = depths[idx];

  // s: ref + sum of the warps, q: ref^2 + sum of their squares
  float s[C], q[C];
#pragma unroll
  for (int c = 0; c < C; c += 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(ref + pix * C + c));
    s[c] = v.x; s[c + 1] = v.y; s[c + 2] = v.z; s[c + 3] = v.w;
    q[c] = v.x * v.x; q[c + 1] = v.y * v.y;
    q[c + 2] = v.z * v.z; q[c + 3] = v.w * v.w;
  }
  for (int v = 0; v < V; ++v) {
    const Taps t = project_taps(rels + 12 * v, srcs + (long long)v * HW * C,
                                C, H, W, (float)x, (float)y, d);
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const float4 w = sample4(t, c);
      s[c] += w.x; s[c + 1] += w.y; s[c + 2] += w.z; s[c + 3] += w.w;
      q[c] += w.x * w.x; q[c + 1] += w.y * w.y;
      q[c + 2] += w.z * w.z; q[c + 3] += w.w * w.w;
    }
  }
  const float n = (float)(V + 1);
  float* o = out + (long long)k * C * HW + pix;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float mean = s[c] / n;
    o[(long long)c * HW] = q[c] / n - mean * mean;
  }
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" const char* error_string(int code) {
  if (code == kUnsupported) return "unsupported channel count (take 8, 16 or 32)";
  return cudaGetErrorString((cudaError_t)code);
}

// Pair mode (K1). ref/src [H,W,C], rel [12], depths [K,H,W] -> out [K,H,W].
extern "C" int sweep_corr_f32(const float* ref, const float* src,
                              const float* rel, const float* depths,
                              float* out, int K, int H, int W, int C,
                              void* stream) {
  const long long n = (long long)K * H * W;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 8: sweep_pair_kernel<8><<<blocks_for(n), kThreads, 0, s>>>(ref, src, rel, depths, out, K, H, W); break;
    case 16: sweep_pair_kernel<16><<<blocks_for(n), kThreads, 0, s>>>(ref, src, rel, depths, out, K, H, W); break;
    case 32: sweep_pair_kernel<32><<<blocks_for(n), kThreads, 0, s>>>(ref, src, rel, depths, out, K, H, W); break;
    default: return kUnsupported;
  }
  return (int)cudaGetLastError();
}

// Cost mode (K2). ref [H,W,C], srcs [V,H,W,C], rels [V,12], depths [K,H,W],
// weights [V,H,W] -> out [K,C,H,W].
extern "C" int sweep_cost_f32(const float* ref, const float* srcs,
                              const float* rels, const float* depths,
                              const float* weights, float* out, int V, int K,
                              int H, int W, int C, void* stream) {
  const long long n = (long long)K * H * W;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 8: sweep_cost_kernel<8><<<blocks_for(n), kThreads, 0, s>>>(ref, srcs, rels, depths, weights, out, V, K, H, W); break;
    case 16: sweep_cost_kernel<16><<<blocks_for(n), kThreads, 0, s>>>(ref, srcs, rels, depths, weights, out, V, K, H, W); break;
    case 32: sweep_cost_kernel<32><<<blocks_for(n), kThreads, 0, s>>>(ref, srcs, rels, depths, weights, out, V, K, H, W); break;
    default: return kUnsupported;
  }
  return (int)cudaGetLastError();
}

// Variance mode (K2v). ref [H,W,C], srcs [V,H,W,C], rels [V,12],
// depths [K,H,W] -> out [K,C,H,W].
extern "C" int sweep_var_f32(const float* ref, const float* srcs,
                             const float* rels, const float* depths, float* out,
                             int V, int K, int H, int W, int C, void* stream) {
  const long long n = (long long)K * H * W;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 8: sweep_var_kernel<8><<<blocks_for(n), kThreads, 0, s>>>(ref, srcs, rels, depths, out, V, K, H, W); break;
    case 16: sweep_var_kernel<16><<<blocks_for(n), kThreads, 0, s>>>(ref, srcs, rels, depths, out, V, K, H, W); break;
    case 32: sweep_var_kernel<32><<<blocks_for(n), kThreads, 0, s>>>(ref, srcs, rels, depths, out, V, K, H, W); break;
    default: return kUnsupported;
  }
  return (int)cudaGetLastError();
}
