// One RedStep2 recurrent-regularizer step for Hopper (sm_90a).
//
// Replaces deep3d_aerial_tpu/ops/pallas_red.py:_red_kernel (entries
// red_step2_fused and red_step2_tiled; caller models/cost_reg.py
// RedStep2._pallas_path): one depth plane of the AdaMVS 2-level ConvGRU
// regularizer,
//   x1 = relu(conv3x3(cost) + b)                       [8, H, W]
//   s1' = ConvGRU8(x1, s1)                             [8, H, W]
//   x2 = relu(conv3x3 stride 2 (s1') + b)              [16, H2, W2]
//   s2' = ConvGRU16(x2, s2)                            [16, H2, W2]
//   f  = relu(convT3x3 stride 2 (s2') + b + s1')       [8, H, W]
//   score = convT3x3 stride 2 (f) + b    if up         [2H, 2W]
//           conv3x3(f) + b               otherwise     [H, W]
// with ConvGRU(x, h): r, u = sigmoid(conv([x, h])), c = tanh(conv([x, r*h])),
// h' = u*h + (1-u)*c, and the JAX package's 'SAME' geometry: a stride-2 conv pads
// (pad_lo, rest) with pad_lo = total // 2 (0 on an even side), and the
// stride-2 transposed conv is PyTorch's conv_transpose2d (stride 2, no
// padding) on the bridge's flipped kernel, cropped to 2n.
//
// Launches: 8 per step (conv1, gates1, cand1, conv2, gates2, cand2, upconv1,
// score), all of one templated direct-convolution kernel with a fused
// epilogue: bias+ReLU, GRU gates (writes r*h and u), GRU update
// (tanh + blend), or skip-add+ReLU.
//
// What bounds it on an H100: operations. A step is ~16 kflop per full-res
// pixel (Cin=8; 18 kflop at Cin=32) against ~130 B of state, cost and score
// traffic per pixel, so on fp32 CUDA cores (67 TFLOP/s) it sits well above
// the 3.35 TB/s memory line. Design for that in this first version: the
// layer's weights (at most 32*9*32 floats, 37 KB) sit in shared memory and
// are read as broadcasts, each thread owns one output pixel and keeps all
// its output channels in registers, so every input value loaded feeds CO
// FMAs; intermediates between the 8 launches stay in L2 at the main path's
// sizes. Tensor cores (TF32/bf16 wgmma) and fusing launches are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnsupported = 10000;  // cost channel count without an instance

enum Geom { kS1 = 0, kS2 = 1, kT2 = 2 };
enum Epi { kBias = 0, kBiasRelu = 1, kGates = 2, kGru = 3, kSkipRelu = 4 };

struct ConvArgs {
  const float* a;     // [CA, Hi, Wi]
  const float* b;     // [CB, Hi, Wi] (second half of the concatenated input)
  const float* w;     // [CA+CB][3][3][CO] then bias [CO]
  const float* aux0;  // epilogue input: h (gates), u (gru), skip (skip_relu)
  const float* aux1;  // epilogue input: h (gru)
  float* out0;
  float* out1;
  int Hi, Wi, Ho, Wo, pad_y, pad_x;
};

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

template <int GEOM>
__device__ __forceinline__ bool tap_index(int o, int k, int pad, int n, int& i) {
  if (GEOM == kS1) {
    i = o + k - 1;
  } else if (GEOM == kS2) {
    i = 2 * o + k - pad;
  } else {  // output o = 2 i + k
    const int t = o - k;
    if (t < 0 || (t & 1)) return false;
    i = t >> 1;
  }
  return i >= 0 && i < n;
}

template <int CA, int CB, int CO, int GEOM, int EPI>
__global__ void __launch_bounds__(kThreads) conv3x3_kernel(ConvArgs p) {
  constexpr int CI = CA + CB;
  constexpr int NW = CI * 9 * CO + CO;
  extern __shared__ float ws[];
  for (int i = threadIdx.x; i < NW; i += kThreads) ws[i] = p.w[i];
  __syncthreads();

  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= p.Ho * p.Wo) return;
  const int oy = idx / p.Wo, ox = idx - oy * p.Wo;
  const long long HWi = (long long)p.Hi * p.Wi;

  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;

#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    int iy;
    if (!tap_index<GEOM>(oy, ky, p.pad_y, p.Hi, iy)) continue;
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      int ix;
      if (!tap_index<GEOM>(ox, kx, p.pad_x, p.Wi, ix)) continue;
      const long long off = (long long)iy * p.Wi + ix;
#pragma unroll
      for (int ci = 0; ci < CI; ++ci) {
        const float xv = ci < CA ? __ldg(p.a + ci * HWi + off)
                                 : __ldg(p.b + (ci - CA) * HWi + off);
        const float* wr = ws + ((ci * 3 + ky) * 3 + kx) * CO;
#pragma unroll
        for (int co = 0; co < CO; ++co) acc[co] = fmaf(xv, wr[co], acc[co]);
      }
    }
  }

  const float* bias = ws + CI * 9 * CO;
  const long long HWo = (long long)p.Ho * p.Wo;
#pragma unroll
  for (int co = 0; co < CO; ++co) {
    const float v = acc[co] + bias[co];
    if (EPI == kBias) {
      p.out0[co * HWo + idx] = v;
    } else if (EPI == kBiasRelu) {
      p.out0[co * HWo + idx] = fmaxf(v, 0.f);
    } else if (EPI == kGates) {
      constexpr int HID = CO / 2;
      const float g = sigmoidf(v);
      if (co < HID) {
        p.out0[co * HWo + idx] = g * p.aux0[co * HWo + idx];  // r * h
      } else {
        p.out1[(co - HID) * HWo + idx] = g;                   // u
      }
    } else if (EPI == kGru) {
      const float c = tanhf(v);
      const float u = p.aux0[co * HWo + idx];
      const float h = p.aux1[co * HWo + idx];
      p.out0[co * HWo + idx] = u * h + (1.f - u) * c;
    } else {  // kSkipRelu
      p.out0[co * HWo + idx] = fmaxf(v + p.aux0[co * HWo + idx], 0.f);
    }
  }
}

template <int CA, int CB, int CO, int GEOM, int EPI>
cudaError_t launch(const ConvArgs& p, cudaStream_t s) {
  constexpr int NW = (CA + CB) * 9 * CO + CO;
  const int n = p.Ho * p.Wo;
  if (n == 0) return cudaSuccess;
  conv3x3_kernel<CA, CB, CO, GEOM, EPI>
      <<<(n + kThreads - 1) / kThreads, kThreads, NW * sizeof(float), s>>>(p);
  return cudaGetLastError();
}

// 'SAME' low-side padding (TensorFlow's rule) of a stride-2 3x3 conv over n -> ceil(n/2)
inline int same_pad_lo(int n) {
  const int out = (n + 1) / 2;
  const int total = (out - 1) * 2 + 3 - n;
  return total > 0 ? total / 2 : 0;
}

ConvArgs args(const float* a, const float* b, const float* w, int Hi, int Wi,
              int Ho, int Wo, float* out0, float* out1 = nullptr,
              const float* aux0 = nullptr, const float* aux1 = nullptr) {
  ConvArgs p;
  p.a = a; p.b = b; p.w = w; p.aux0 = aux0; p.aux1 = aux1;
  p.out0 = out0; p.out1 = out1;
  p.Hi = Hi; p.Wi = Wi; p.Ho = Ho; p.Wo = Wo;
  p.pad_y = same_pad_lo(Hi); p.pad_x = same_pad_lo(Wi);
  return p;
}

#define RS2_CHECK(expr)                    \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

}  // namespace

extern "C" const char* error_string(int code) {
  if (code == kUnsupported) return "unsupported cost channel count (take 8, 16 or 32)";
  return cudaGetErrorString((cudaError_t)code);
}

// One RedStep2 step. cost [Cin,H,W], s1 [8,H,W], s2 [16,H2,W2] with
// H2 = ceil(H/2), W2 = ceil(W/2). Weights are packed [ci][ky][kx][co] + bias.
// scratch holds 32*H*W + 48*H2*W2 floats. Writes score ([2H,2W] if up else
// [H,W]), s1_out and s2_out; the inputs are not modified.
extern "C" int red_step2_f32(const float* cost, int Cin, const float* s1,
                             const float* s2, const float* w_conv1,
                             const float* w_gates1, const float* w_cand1,
                             const float* w_conv2, const float* w_gates2,
                             const float* w_cand2, const float* w_up1,
                             const float* w_score, float* score, float* s1_out,
                             float* s2_out, float* scratch, int H, int W,
                             int up, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int H2 = (H + 1) / 2, W2 = (W + 1) / 2;
  const long long HW = (long long)H * W, HW2 = (long long)H2 * W2;
  float* x1 = scratch;
  float* rh1 = x1 + 8 * HW;
  float* u1 = rh1 + 8 * HW;
  float* fused = u1 + 8 * HW;
  float* x2 = fused + 8 * HW;
  float* rh2 = x2 + 16 * HW2;
  float* u2 = rh2 + 16 * HW2;

  const ConvArgs c1 = args(cost, nullptr, w_conv1, H, W, H, W, x1);
  switch (Cin) {
    case 8: RS2_CHECK((launch<8, 0, 8, kS1, kBiasRelu>(c1, s))); break;
    case 16: RS2_CHECK((launch<16, 0, 8, kS1, kBiasRelu>(c1, s))); break;
    case 32: RS2_CHECK((launch<32, 0, 8, kS1, kBiasRelu>(c1, s))); break;
    default: return kUnsupported;
  }
  RS2_CHECK((launch<8, 8, 16, kS1, kGates>(
      args(x1, s1, w_gates1, H, W, H, W, rh1, u1, s1), s)));
  RS2_CHECK((launch<8, 8, 8, kS1, kGru>(
      args(x1, rh1, w_cand1, H, W, H, W, s1_out, nullptr, u1, s1), s)));
  RS2_CHECK((launch<8, 0, 16, kS2, kBiasRelu>(
      args(s1_out, nullptr, w_conv2, H, W, H2, W2, x2), s)));
  RS2_CHECK((launch<16, 16, 32, kS1, kGates>(
      args(x2, s2, w_gates2, H2, W2, H2, W2, rh2, u2, s2), s)));
  RS2_CHECK((launch<16, 16, 16, kS1, kGru>(
      args(x2, rh2, w_cand2, H2, W2, H2, W2, s2_out, nullptr, u2, s2), s)));
  RS2_CHECK((launch<16, 0, 8, kT2, kSkipRelu>(
      args(s2_out, nullptr, w_up1, H2, W2, H, W, fused, nullptr, s1_out), s)));
  if (up) {
    RS2_CHECK((launch<8, 0, 1, kT2, kBias>(
        args(fused, nullptr, w_score, H, W, 2 * H, 2 * W, score), s)));
  } else {
    RS2_CHECK((launch<8, 0, 1, kS1, kBias>(
        args(fused, nullptr, w_score, H, W, H, W, score), s)));
  }
  return 0;
}
