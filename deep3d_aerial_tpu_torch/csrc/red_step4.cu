// One RedStep4 recurrent-regularizer step (K4) and the channel-first 3x3
// convolution template it is built from (K5), for Hopper (sm_90a).
//
// Replaces:
//   K4 -> deep3d_aerial_tpu/ops/pallas_red4.py:_red4_kernel (entries
//         red_step4_fused and red_step4_tiled; caller models/cost_reg.py
//         RedStep4._pallas_path): one depth plane of the MSREDNet 4-level
//         ConvGRU encoder-decoder.
//   K5 -> deep3d_aerial_tpu/ops/pallas_cf_conv.py:_k_same, _k_down, _k_up
//         (entry cf_conv3x3): a channel-first 3x3 conv [Ci,H,W] ->
//         [Co,H,W] ('same'), [Co,ceil(H/2),ceil(W/2)] ('down', stride 2) or
//         [Co,2H,2W] ('up', stride-2 transposed), + bias, optional ReLU.
//
// The step (cost [Cin,H,W], states h1 [8,H,W], h2 [16,H/2,W/2],
// h3 [32,H/4,W/4], h4 [64,H/8,W/8], H and W multiples of 8):
//   neg = -cost (folded into the packed weights of its three consumers)
//   d1 = relu(down(neg)), d2 = relu(down(d1)), d3 = relu(down(d2))
//   h_l' = NormGRU_l(x_l, h_l) with x = (neg, d1, d2, d3):
//     g = conv([x, h]); r = sigmoid(GN_r(g[:C])); u = sigmoid(GN_u(g[C:]))
//     o = tanh(GN_o(conv([x, r*h]))); h' = u*h + (1-u)*o
//   u3 = relu(up(h4')), u2 = relu(up(u3 + h3')), u1 = relu(up(u2 + h2'))
//   score = conv(u1 + h1')
// GN is GroupNorm with ONE group: statistics over the whole (C, H, W) part
// of the plane, eps 1e-6, variance E[x^2] - E[x]^2 clamped at 0, the scale
// folded into the inverse deviation (the JAX package's order). The convs
// use the JAX package's 'SAME' geometry: a stride-2 conv pads (total // 2)
// on the low side (0 on an even side); the stride-2 transposed conv is
// PyTorch's conv_transpose2d (stride 2, no padding) on the bridge's flipped
// kernel, cropped to 2n.
//
// Launches per step: 19 -- 15 of the conv template (3 down, 4 gates, 4
// candidate, 3 up, score), 2 GroupNorm finalizes (r/u of every level, then
// o of every level) and 2 pointwise passes over all four levels (r*h, then
// the state update). The gates and candidate convs write per-block partial
// (sum, sum of squares) of each GroupNorm part in their epilogue; the
// finalize kernel reduces them in a fixed order (no atomics), so a plane
// gives the same bits from run to run.
//
// What bounds it on an H100: operations. A step is ~31 kflop per full-res
// pixel against ~150 B of cost, state and score traffic, so on fp32 CUDA
// cores (67 TFLOP/s) it sits far above the 3.35 TB/s memory line (384x512
// Cin 8: 6.14 GFLOP, bound 0.092 ms). Design for that in this first
// version: one thread per output pixel, a block of 128 pixels times a tile
// of T <= 32 output channels (blockIdx.y), so at most 32 accumulators live
// in registers whatever the layer's width (gru4's gates are 128 -> 128).
// The tile's weights are staged through shared memory 16 input channels
// at a time (16*9*32 floats, 18 KB: a whole 128x9x128 layer, 590 KB, does
// not fit a block's 227 KB), read as float4 broadcasts, so every input
// value loaded feeds T FMAs. A block walks its input channels in series,
// so on the small deep levels (CI 64-128 over a few hundred pixels) the
// time is that walk's latency: each input channel's 9 tap loads are
// issued together, predicated rather than branched around. Small levels
// (stage 1's level 3 is 12x16 pixels) take T = 8 when the grid would
// otherwise not cover two blocks per SM.
// Static shared memory stays under 48 KB, so no launch needs the dynamic
// shared-memory attribute. Tensor cores (TF32/bf16 wgmma) and fewer, fused
// launches are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // output pixels per conv block
constexpr int kChunk = 16;      // input channels per shared-memory weight stage
constexpr int kPointThreads = 256;
constexpr int kBadShape = 10001;
constexpr int kBadParams = 10002;
constexpr float kEps = 1e-6f;
constexpr int kHidden[4] = {8, 16, 32, 64};

enum Geom { kSame = 0, kDown = 1, kUp = 2 };

struct ConvArgs {
  const float* a;     // [CA, Hi, Wi]
  const float* b;     // concat: [CB, Hi, Wi] after a; sum: [CA, Hi, Wi] added to a
  const float* w;     // [CI][3][3][CO], CI = CA (sum) or CA + CB (concat)
  const float* bias;  // [CO]
  float* out;         // [CO, Ho, Wo]
  float* partial;     // per block (sum, sum of squares) x 2 GN parts, or null
  int CA, CB, CO, Hi, Wi, Ho, Wo, pad_y, pad_x;
  int sum_b, relu;
  int part;           // output channels per GroupNorm part (with partial)
};

template <int GEOM>
__device__ __forceinline__ int tap_in(int o, int k, int pad, int n) {
  int i;
  if (GEOM == kSame) {
    i = o + k - 1;
  } else if (GEOM == kDown) {
    i = 2 * o + k - pad;
  } else {  // output o = 2 i + k
    const int t = o - k;
    if (t < 0 || (t & 1)) return -1;
    i = t >> 1;
  }
  return i >= 0 && i < n ? i : -1;
}

template <int T>
__device__ __forceinline__ void fma_row(float (&acc)[T], float xv, const float* wr) {
  if constexpr (T % 4 == 0) {
#pragma unroll
    for (int t = 0; t < T; t += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(wr + t);
      acc[t] = fmaf(xv, w4.x, acc[t]);
      acc[t + 1] = fmaf(xv, w4.y, acc[t + 1]);
      acc[t + 2] = fmaf(xv, w4.z, acc[t + 2]);
      acc[t + 3] = fmaf(xv, w4.w, acc[t + 3]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) acc[t] = fmaf(xv, wr[t], acc[t]);
  }
}

// K5: output pixel blockIdx.x * kThreads + threadIdx.x, output channels
// [blockIdx.y * T, blockIdx.y * T + T).
template <int GEOM, int T>
__global__ void __launch_bounds__(kThreads) cf_conv_kernel(ConvArgs p) {
  __shared__ __align__(16) float ws[kChunk * 9 * T];
  __shared__ float red[kThreads / 32][4];
  const int CI = p.sum_b ? p.CA : p.CA + p.CB;
  const int co0 = blockIdx.y * T;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  const bool live = idx < p.Ho * p.Wo;
  const int oy = live ? idx / p.Wo : 0, ox = live ? idx - oy * p.Wo : 0;
  const long long HWi = (long long)p.Hi * p.Wi;

  int off[9];  // input offset of each tap, -1 outside the input
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    const int iy = tap_in<GEOM>(oy, ky, p.pad_y, p.Hi);
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      const int ix = tap_in<GEOM>(ox, kx, p.pad_x, p.Wi);
      off[ky * 3 + kx] = iy < 0 || ix < 0 ? -1 : iy * p.Wi + ix;
    }
  }

  float acc[T];
#pragma unroll
  for (int t = 0; t < T; ++t) acc[t] = 0.f;

  for (int ci0 = 0; ci0 < CI; ci0 += kChunk) {
    __syncthreads();  // the previous chunk's weights are consumed
    for (int i = threadIdx.x; i < kChunk * 9 * T; i += kThreads) {
      const int t = i % T, r = i / T;  // r = local channel * 9 + tap
      const int ci = ci0 + r / 9, co = co0 + t;
      ws[i] = ci < CI && co < p.CO
                  ? __ldg(p.w + ((long long)ci * 9 + r % 9) * p.CO + co) : 0.f;
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll
    for (int cl = 0; cl < kChunk; ++cl) {
      const int ci = ci0 + cl;
      if (ci >= CI) break;
      const float* src = ci < p.CA ? p.a + ci * HWi : p.b + (ci - p.CA) * HWi;
      // the 9 taps' loads are predicated, not branched around, so they
      // issue together; a tap outside the input reads 0, and an FMA with 0
      // leaves the sum exactly as skipping it would
      float xv[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        xv[tap] = off[tap] >= 0 ? __ldg(src + off[tap]) : 0.f;
      if (p.sum_b) {
        const float* add = p.b + ci * HWi;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
          xv[tap] += off[tap] >= 0 ? __ldg(add + off[tap]) : 0.f;
      }
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        fma_row<T>(acc, xv[tap], ws + (cl * 9 + tap) * T);
    }
  }

  const long long HWo = (long long)p.Ho * p.Wo;
  // (sum, sum of squares) of the (at most two) GN parts this tile touches
  float st0 = 0.f, sq0 = 0.f, st1 = 0.f, sq1 = 0.f;
  const int part0 = p.partial != nullptr ? co0 / p.part : 0;
  if (live) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int co = co0 + t;
      if (co >= p.CO) break;
      float v = acc[t] + __ldg(p.bias + co);
      if (p.relu) v = fmaxf(v, 0.f);
      p.out[co * HWo + idx] = v;
      if (p.partial != nullptr) {
        if (co / p.part == part0) {
          st0 += v; sq0 += v * v;
        } else {
          st1 += v; sq1 += v * v;
        }
      }
    }
  }
  if (p.partial == nullptr) return;  // uniform over the block
  float vals[4] = {st0, sq0, st1, sq1};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v = vals[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
    p.partial[((long long)blockIdx.y * gridDim.x + blockIdx.x) * 4 + threadIdx.x] = s;
  }
}

struct Tiling {
  int T, nbx, nty;
};

// Streaming multiprocessors of the current device (132 on an H100 SXM),
// read once per device; 0 if the query fails (the tile then stays wide).
inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cached[dev] = n;
  }
  return cached[dev];
}

// Output-channel tile: the layer's width up to 32, and 8 when the grid
// would not give every SM two blocks. The scratch plan and the launches
// read the same SM count, so their partial-sum layouts agree.
inline Tiling tiling(int CO, long long npix) {
  int T = CO == 1 ? 1 : CO <= 8 ? 8 : CO <= 16 ? 16 : 32;
  const int nbx = (int)((npix + kThreads - 1) / kThreads);
  if (T > 8 && (long long)nbx * ((CO + T - 1) / T) < 2LL * sm_count()) T = 8;
  return {T, nbx, (CO + T - 1) / T};
}

template <int GEOM>
void launch_geom(const ConvArgs& p, const Tiling& tl, cudaStream_t s) {
  const dim3 grid(tl.nbx, tl.nty);
  switch (tl.T) {
    case 1: cf_conv_kernel<GEOM, 1><<<grid, kThreads, 0, s>>>(p); break;
    case 8: cf_conv_kernel<GEOM, 8><<<grid, kThreads, 0, s>>>(p); break;
    case 16: cf_conv_kernel<GEOM, 16><<<grid, kThreads, 0, s>>>(p); break;
    default: cf_conv_kernel<GEOM, 32><<<grid, kThreads, 0, s>>>(p); break;
  }
}

// 'SAME' low-side padding (TensorFlow's rule) of a stride-2 3x3 conv over n
inline int same_pad_lo(int n) {
  const int out = (n + 1) / 2;
  const int total = (out - 1) * 2 + 3 - n;
  return total > 0 ? total / 2 : 0;
}

ConvArgs conv_args(const float* a, int CA, const float* b, int CB, int sum_b,
                   const float* w, int CO, int Hi, int Wi, int geom,
                   float* out, int relu, float* partial = nullptr, int part = 0) {
  ConvArgs p;
  p.a = a; p.b = b; p.w = w; p.out = out; p.partial = partial;
  p.CA = CA; p.CB = CB; p.CO = CO; p.sum_b = sum_b; p.relu = relu;
  p.part = part;
  p.Hi = Hi; p.Wi = Wi;
  p.Ho = geom == kUp ? 2 * Hi : geom == kDown ? (Hi + 1) / 2 : Hi;
  p.Wo = geom == kUp ? 2 * Wi : geom == kDown ? (Wi + 1) / 2 : Wi;
  p.pad_y = same_pad_lo(Hi); p.pad_x = same_pad_lo(Wi);
  const int CI = sum_b ? CA : CA + CB;
  p.bias = w + (long long)CI * 9 * CO;
  return p;
}

cudaError_t conv(const ConvArgs& p, int geom, cudaStream_t s) {
  const Tiling tl = tiling(p.CO, (long long)p.Ho * p.Wo);
  if (tl.nbx == 0) return cudaSuccess;
  if (geom == kSame) launch_geom<kSame>(p, tl, s);
  else if (geom == kDown) launch_geom<kDown>(p, tl, s);
  else launch_geom<kUp>(p, tl, s);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GroupNorm statistics and the pointwise GRU passes
// ---------------------------------------------------------------------------

struct GnJob {
  const float* partial;  // the conv's [nty][nbx][4] block partials
  float* stats;          // -> (mean, inverse deviation)
  int nbx, T, part, p;   // tiling, channels per part, this part's index
  double count;          // elements of the part: part * H * W
};

struct GnJobs {
  GnJob j[8];
};

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// One block per GN part: the part's block partials summed in a fixed order.
__global__ void __launch_bounds__(256) gn_finalize_kernel(GnJobs jobs) {
  const GnJob jb = jobs.j[blockIdx.x];
  const int y_lo = jb.p * jb.part / jb.T;
  const int y_hi = ((jb.p + 1) * jb.part - 1) / jb.T;
  const long long n = (long long)(y_hi - y_lo + 1) * jb.nbx;
  double s = 0.0, q = 0.0;
  for (long long e = threadIdx.x; e < n; e += blockDim.x) {
    const int y = y_lo + (int)(e / jb.nbx);
    const int x = (int)(e % jb.nbx);
    const int l = jb.p - y * jb.T / jb.part;  // which of the tile's 2 parts
    const float* pp = jb.partial + ((long long)y * jb.nbx + x) * 4 + 2 * l;
    s += pp[0];
    q += pp[1];
  }
  __shared__ double rs[256], rq[256];
  rs[threadIdx.x] = s;
  rq[threadIdx.x] = q;
  __syncthreads();
  for (int o = blockDim.x / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) {
      rs[threadIdx.x] += rs[threadIdx.x + o];
      rq[threadIdx.x] += rq[threadIdx.x + o];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const double mean = rs[0] / jb.count;
    const double var = fmax(rq[0] / jb.count - mean * mean, 0.0);
    jb.stats[0] = (float)mean;
    jb.stats[1] = (float)(1.0 / sqrt(var + (double)kEps));
  }
}

struct Level {
  const float* gp;  // gates pre-activation [2C, H, W] (r, then u)
  const float* h;   // state [C, H, W]
  const float* cp;  // candidate pre-activation [C, H, W]
  const float* gn;  // rn.w, rn.b, un.w, un.b, on.w, on.b, each [C]
  const float* st;  // (mean, inv) of r, u, o
  float* out;       // r*h (reset pass) or h' (update pass)
  int C;
  int HW;
};

struct Levels {
  Level l[4];
  long long start[5];  // first flat element of each level; start[4] = total
};

__device__ __forceinline__ float gn_apply(float x, const float* st, float w, float b) {
  return (x - st[0]) * (st[1] * w) + b;
}

// r*h with r = sigmoid(GN_r(g[:C])), all four levels in one launch
__global__ void __launch_bounds__(kPointThreads) gru_reset_kernel(Levels L) {
  const long long e = (long long)blockIdx.x * kPointThreads + threadIdx.x;
  if (e >= L.start[4]) return;
  int l = 0;
  while (e >= L.start[l + 1]) ++l;
  const Level& v = L.l[l];
  const int i = (int)(e - L.start[l]);
  const int c = i / v.HW;
  const float r = sigmoidf_(gn_apply(v.gp[i], v.st, v.gn[c], v.gn[v.C + c]));
  v.out[i] = r * v.h[i];
}

// h' = u*h + (1-u)*tanh(GN_o(cp)) with u = sigmoid(GN_u(g[C:]))
__global__ void __launch_bounds__(kPointThreads) gru_update_kernel(Levels L) {
  const long long e = (long long)blockIdx.x * kPointThreads + threadIdx.x;
  if (e >= L.start[4]) return;
  int l = 0;
  while (e >= L.start[l + 1]) ++l;
  const Level& v = L.l[l];
  const int i = (int)(e - L.start[l]);  // a level holds < 2^31 elements
  const int C = v.C;
  const int c = i / v.HW;
  const float u = sigmoidf_(gn_apply(v.gp[(long long)C * v.HW + i], v.st + 2,
                                     v.gn[2 * C + c], v.gn[3 * C + c]));
  const float o = tanhf(gn_apply(v.cp[i], v.st + 4, v.gn[4 * C + c],
                                 v.gn[5 * C + c]));
  const float h = v.h[i];
  v.out[i] = u * h + (1.f - u) * o;
}

// ---------------------------------------------------------------------------
// the step: packed parameters and scratch layout
// ---------------------------------------------------------------------------

constexpr int kLayers = 15;

// (in, out) channels of the packed layers, in packing order: conv1-3,
// gates/cand of gru1-4, upconv3/2/1, out2d
inline void layer_shapes(int Cin, int ci[kLayers], int co[kLayers]) {
  const int s[kLayers][2] = {
      {Cin, 16}, {16, 32}, {32, 64},
      {Cin + 8, 16}, {Cin + 8, 8}, {32, 32}, {32, 16},
      {64, 64}, {64, 32}, {128, 128}, {128, 64},
      {64, 32}, {32, 16}, {16, 8}, {8, 1}};
  for (int i = 0; i < kLayers; ++i) {
    ci[i] = s[i][0];
    co[i] = s[i][1];
  }
}

long long param_floats(int Cin, const float* base, const float* w[kLayers],
                       const float** gn) {
  int ci[kLayers], co[kLayers];
  layer_shapes(Cin, ci, co);
  long long off = 0;
  for (int i = 0; i < kLayers; ++i) {
    if (w != nullptr) w[i] = base + off;
    off += (long long)ci[i] * 9 * co[i] + co[i];
  }
  if (gn != nullptr) *gn = base + off;
  return off + 6 * (8 + 16 + 32 + 64);
}

struct Plan {
  int H[4], W[4];
  long long P[4];
  long long d[3], gp[4], rh[4], cp[4], u[3], pg[4], pc[4], stats, total;
};

inline long long partial_floats(int CO, long long npix) {
  const Tiling t = tiling(CO, npix);
  return 4LL * t.nbx * t.nty;
}

Plan plan(int H, int W) {
  Plan q;
  long long off = 0;
  auto take = [&off](long long n) {
    const long long o = off;
    off += (n + 31) / 32 * 32;  // 128-byte aligned pieces
    return o;
  };
  for (int l = 0; l < 4; ++l) {
    q.H[l] = H >> l;
    q.W[l] = W >> l;
    q.P[l] = (long long)q.H[l] * q.W[l];
  }
  for (int l = 0; l < 3; ++l) q.d[l] = take((16LL << l) * q.P[l + 1]);
  for (int l = 0; l < 4; ++l) {
    const int C = kHidden[l];
    q.gp[l] = take(2LL * C * q.P[l]);
    q.rh[l] = take((long long)C * q.P[l]);
    q.cp[l] = take((long long)C * q.P[l]);
    q.pg[l] = take(partial_floats(2 * C, q.P[l]));
    q.pc[l] = take(partial_floats(C, q.P[l]));
  }
  for (int l = 0; l < 3; ++l) q.u[l] = take((long long)kHidden[l] * q.P[l]);  // u1, u2, u3
  q.stats = take(24);
  q.total = off;
  return q;
}

#define RS4_CHECK(expr)                    \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

}  // namespace

extern "C" const char* error_string(int code) {
  if (code == kBadShape) return "RedStep4 needs H and W that are multiples of 8";
  if (code == kBadParams) return "bad conv mode or channel count";
  return cudaGetErrorString((cudaError_t)code);
}

// K5 on its own. x [Ci,H,W], w packed [Ci][3][3][Co], b [Co]; mode 0 'same'
// -> out [Co,H,W], 1 'down' -> [Co,ceil(H/2),ceil(W/2)], 2 'up' -> [Co,2H,2W].
extern "C" int cf_conv3x3_f32(const float* x, const float* w, const float* b,
                              int Ci, int Co, int H, int W, int mode, int relu,
                              float* out, void* stream) {
  if (mode < kSame || mode > kUp || Ci < 1 || Co < 1) return kBadParams;
  ConvArgs p = conv_args(x, Ci, nullptr, 0, 0, w, Co, H, W, mode, out, relu);
  p.bias = b;
  return (int)conv(p, mode, (cudaStream_t)stream);
}

// Floats of the packed parameter buffer red_step4_f32 reads.
extern "C" long long red_step4_param_floats(int Cin) {
  return param_floats(Cin, nullptr, nullptr, nullptr);
}

// Floats of the scratch buffer red_step4_f32 needs at H x W.
extern "C" long long red_step4_scratch_floats(int H, int W) {
  return plan(H, W).total;
}

// One RedStep4 step. cost [Cin,H,W], states h1 [8,H,W] .. h4 [64,H/8,W/8];
// params packed as red_step4_param_floats describes (each layer
// [ci][ky][kx][co] then bias; the cost's negation folded in; then the GN
// vectors per level). Writes score [H,W] and the new states; the inputs are
// not modified. *conv_launches receives the launches of the conv template.
extern "C" int red_step4_f32(const float* cost, int Cin, const float* s1,
                             const float* s2, const float* s3, const float* s4,
                             const float* params, float* score, float* h1n,
                             float* h2n, float* h3n, float* h4n, float* scratch,
                             int H, int W, int* conv_launches, void* stream) {
  *conv_launches = 0;
  if (H % 8 || W % 8 || H <= 0 || W <= 0) return kBadShape;
  if (Cin < 1) return kBadParams;
  cudaStream_t s = (cudaStream_t)stream;
  const float* w[kLayers];
  const float* gn;
  param_floats(Cin, params, w, &gn);
  const Plan q = plan(H, W);
  float* d[3] = {scratch + q.d[0], scratch + q.d[1], scratch + q.d[2]};
  const float* h[4] = {s1, s2, s3, s4};
  float* hn[4] = {h1n, h2n, h3n, h4n};
  float* stats = scratch + q.stats;
  int n = 0;

  // encoder: three stride-2 convs on -cost
  const float* x[4] = {cost, d[0], d[1], d[2]};
  const int xc[4] = {Cin, 16, 32, 64};
  for (int l = 0; l < 3; ++l) {
    RS4_CHECK(conv(conv_args(x[l], xc[l], nullptr, 0, 0, w[l], 16 << l, q.H[l],
                             q.W[l], kDown, d[l], 1), kDown, s));
    ++n;
  }
  // gates of every level, with their GN partials
  GnJobs gj;
  for (int l = 0; l < 4; ++l) {
    const int C = kHidden[l];
    RS4_CHECK(conv(conv_args(x[l], xc[l], h[l], C, 0, w[3 + 2 * l], 2 * C,
                             q.H[l], q.W[l], kSame, scratch + q.gp[l], 0,
                             scratch + q.pg[l], C), kSame, s));
    ++n;
    const Tiling tl = tiling(2 * C, q.P[l]);
    for (int part = 0; part < 2; ++part) {
      gj.j[2 * l + part] = {scratch + q.pg[l], stats + 6 * l + 2 * part, tl.nbx,
                            tl.T, C, part, (double)C * q.P[l]};
    }
  }
  gn_finalize_kernel<<<8, 256, 0, s>>>(gj);
  RS4_CHECK(cudaGetLastError());

  Levels L;
  long long total = 0;
  for (int l = 0; l < 4; ++l) {
    const int C = kHidden[l];
    L.l[l] = {scratch + q.gp[l], h[l], scratch + q.cp[l], gn, stats + 6 * l,
              scratch + q.rh[l], C, (int)q.P[l]};
    gn += 6 * C;
    L.start[l] = total;
    total += (long long)C * q.P[l];
  }
  L.start[4] = total;
  const unsigned pblocks = (unsigned)((total + kPointThreads - 1) / kPointThreads);
  gru_reset_kernel<<<pblocks, kPointThreads, 0, s>>>(L);
  RS4_CHECK(cudaGetLastError());

  // candidates of every level on [x, r*h], with their GN partials
  GnJobs cj;
  for (int l = 0; l < 4; ++l) {
    const int C = kHidden[l];
    RS4_CHECK(conv(conv_args(x[l], xc[l], scratch + q.rh[l], C, 0, w[4 + 2 * l],
                             C, q.H[l], q.W[l], kSame, scratch + q.cp[l], 0,
                             scratch + q.pc[l], C), kSame, s));
    ++n;
    const Tiling tl = tiling(C, q.P[l]);
    cj.j[l] = {scratch + q.pc[l], stats + 6 * l + 4, tl.nbx, tl.T, C, 0,
               (double)C * q.P[l]};
  }
  gn_finalize_kernel<<<4, 256, 0, s>>>(cj);
  RS4_CHECK(cudaGetLastError());

  for (int l = 0; l < 4; ++l) L.l[l].out = hn[l];
  gru_update_kernel<<<pblocks, kPointThreads, 0, s>>>(L);
  RS4_CHECK(cudaGetLastError());

  // decoder: each transposed conv reads its skip sum on load
  float* u1 = scratch + q.u[0];
  float* u2 = scratch + q.u[1];
  float* u3 = scratch + q.u[2];
  RS4_CHECK(conv(conv_args(hn[3], 64, nullptr, 0, 0, w[11], 32, q.H[3], q.W[3],
                           kUp, u3, 1), kUp, s));
  RS4_CHECK(conv(conv_args(u3, 32, hn[2], 32, 1, w[12], 16, q.H[2], q.W[2],
                           kUp, u2, 1), kUp, s));
  RS4_CHECK(conv(conv_args(u2, 16, hn[1], 16, 1, w[13], 8, q.H[1], q.W[1],
                           kUp, u1, 1), kUp, s));
  RS4_CHECK(conv(conv_args(u1, 8, hn[0], 8, 1, w[14], 1, q.H[0], q.W[0],
                           kSame, score, 0), kSame, s));
  n += 4;
  *conv_launches = n;
  return 0;
}
