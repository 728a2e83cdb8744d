// One RedStep2 recurrent-regularizer step (K3) for Hopper (sm_90a), with
// the online-softmax update of the streaming sweep folded into its score
// pass.
//
// Replaces deep3d_aerial_tpu/ops/pallas_red.py:_red_kernel (entries
// red_step2_fused and red_step2_tiled; caller models/cost_reg.py
// RedStep2._pallas_path), and the OnlineSoftmaxState.update that the JAX
// package's scan body (models/cascade.py) fuses after it: one depth plane of
// the AdaMVS 2-level ConvGRU regularizer,
//   x1 = relu(conv3x3(cost) + b)                       [8, H, W]
//   s1' = ConvGRU8(x1, s1)                             [8, H, W]
//   x2 = relu(conv3x3 stride 2 (s1') + b)              [16, H2, W2]
//   s2' = ConvGRU16(x2, s2)                            [16, H2, W2]
//   f  = relu(convT3x3 stride 2 (s2') + b + s1')       [8, H, W]
//   score = convT3x3 stride 2 (f) + b    if up         [2H, 2W]
//           conv3x3(f) + b               otherwise     [H, W]
// then, per score pixel, m' = max(m, score), scale = exp(m - m'),
// e = exp(score - m'), s' = s*scale + e, acc' = acc*scale + e*dv,
// pmax' = max(pmax*scale, e) (OnlineSoftmaxState.update's order, expf, no
// contraction). ConvGRU(x, h): r, u = sigmoid(conv([x, h])),
// c = tanh(conv([x, r*h])), h' = u*h + (1-u)*c. H2 = ceil(H/2); the JAX
// package's 'SAME' geometry: a stride-2 conv pads (total // 2) on the low
// side (0 on an even side); the stride-2 transposed conv is PyTorch's
// conv_transpose2d (stride 2, no padding) on the flipped kernel, cropped.
//
// What bounds it on an H100: operations. A step is ~16-18 kflop per
// full-res pixel against ~160 B of cost, state and softmax traffic; done
// fp32-exact on the tensor cores (3xTF32: 495 / 3 TFLOP/s) the 384x512
// Cin 8 step's 3.2 GFLOP take 0.019 ms, above its ~0.010 ms of memory
// traffic (bfloat16 mode: 0.003 ms of MMAs, ~0.006 ms of traffic). What
// holds it back in practice is instruction issue and latency, not the
// tensor cores: with the MMAs compiled out a launch keeps
// 70-99% of its time (scripts/red_step2_probe.py). The design:
//   - Three launches a step, one per level, each owning spatial tiles and
//     keeping every intermediate in shared memory; only s1' and s2' reach
//     device memory (the score too, when the caller asks for it):
//       L1 (full res):  x1, the gates (r*h1, u1) and the candidate -> s1'
//       L2 (half res):  x2 from s1', the gates, the candidate -> s2'
//       L3 (full res):  f from s2' and s1', the score on the CUDA cores
//                       (one output channel cannot feed an n8 fragment),
//                       the softmax update in place
//   - Tile and halo: a tile of T output pixels recomputes its inputs over
//     a ring: L1 stages cost and s1 over a 3-px ring, x1 is computed over
//     2 px, the gates over 1 px; L2 stages s2 over 2 half-res px and s1'
//     over the matching full-res window (2 * rows + 1); L3 stages s1' over
//     1 px and s2' over the half-res rows the transposed conv reads. A 32 x
//     32 tile recomputes x1 1.27x and the gates 1.13x.
//   - Convs on the tensor cores: an implicit GEMM per conv, M = the
//     region's pixels (flattened, 16 per m16 fragment, read from shared
//     memory at each tap's offset), N = output channels (n8 fragments),
//     K = 8 input channels x 9 taps a chunk; mma.sync m16n8k8 TF32 with
//     every operand split hi + lo (3xTF32, the TPU kernel's 'f32x3'). The
//     weights are split once, at pack time, in B-fragment order
//     (ops/red_step2.py:pack_params) and stay resident in shared memory:
//     each block loads its level's weights once (L2's are 120 KB, so the
//     kernels take dynamic shared memory above 48 KB) and then walks over
//     tiles (persistent blocks, min(tiles, SMs x resident blocks)). The
//     transposed conv runs by output phase: each parity reads its own
//     1, 2, 2 or 4 taps.
//   - Filling the card: each level takes the largest of its tile sizes
//     whose tiles give every SM a block (L1 also wants its last wave of
//     blocks at least half full): 96x128 stage 1 runs 132 tiles of 8 x 12
//     at full res and of 4 x 6 at half res, its decoder 192 of 8 x 8;
//     384x512 runs 16 x 32 and 16 x 16; the 1856x2752 frame's L1 32 x 32.
//     A conv's work is dealt to the warps (16 a block, or 8 where two
//     blocks an SM take every tile at once) in items of 16 or 32 pixels x
//     8 to 32 output channels: the fewest instructions per MMA that still
//     give every warp an item.
//   - Channel planes in shared memory are padded to 8 mod 32 words, so the
//     4 channels of an A fragment land 8 banks apart.
//   - Any cost width Cin: the cost's channels are staged as planes of 8
//     (a Cin that is not a multiple of 8 gets zero planes up to the next
//     one, and pack_params zero weights for them: pack_frags pads). Up to
//     32 channels L1 stages the whole cost once; above 32 (AdaMVS at a base
//     width above 8: Cin = 4b, 2b, b) its Chunked instance stages the cost
//     32 channels at a time into the same planes and runs conv1's k-steps
//     over each chunk, adding each chunk's sums into x1 before the bias and
//     ReLU of the last; the weights of every chunk stay resident. Up to 32
//     channels the single-pass instance runs (no slower than the kernel
//     before the chunks at Cin 8, 16, 32, paired on an H100:
//     scripts/red_step2_probe.py --parent).
// No float atomics; every sum runs in an order fixed by the layer shapes
// and the device's SM count (chunk, then tap, then the fragment's K), so a
// plane gives the same bits from run to run.
//
// bfloat16 mode (red_step2_bf16; the JAX package's dtype=bfloat16, its
// kernel's precision='bf16'): cost, states and score in bfloat16 in device
// memory, upcast as they are staged; the intermediates stay float32 in
// shared memory, as the TPU kernel's scratch does. Each product is one
// mma.sync m16n8k16 bf16 (float32 sums) over 16 input channels (two of the
// float32 mode's 8-channel chunks; the second is zero past the layer) in
// place of 3xTF32's three m16n8k8 per 8: the A fragment's channel pairs
// are rounded to bfloat16 as they are read, and the weights are packed
// once as bfloat16 B fragments (ops/cf_conv.py:pack_frags_bf16). Values
// round to bfloat16 where `_red_kernel` rounds them: the operands of each
// product, the transposed conv's output (up1 + bias), the score, and the
// new states as they are stored. The skip sum f = relu(up1 + s1') takes s1'
// before its rounding, as the TPU kernel reads it from its float32
// scratch: L1 writes a float32 copy of s1' for L3. The score runs on the
// CUDA cores on the rounded f and weights, and the softmax fold stays
// float32.

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "bf16.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kFrag = 128;           // floats of one packed (chunk, tap, n8) fragment
constexpr int kFragB = 64;           // words of one bfloat16 (chunk of 16, tap, n8) fragment
constexpr int kSmemMax = 232448;     // bytes of shared memory a block may use
constexpr int kBadArgs = 10001;
// cost channels L1 stages at once: above this, conv1 runs in chunks
constexpr int kCostChunk = 32;
// threads a block: 16 warps for the two GRU levels (one block an SM, held
// there by its registers and shared memory) unless 8-warp blocks, two to
// an SM, take all the tiles in one wave; 8 for the decoder, whose smaller
// blocks share an SM two at a time and hide each other's copies
constexpr int kGruThreads = 512;
constexpr int kDecThreads = 256;

// Packed weights (ops/red_step2.py:pack_params), three sections, each
// layer as its fragments then its bias (padded to 8):
//   L1: conv1 [Cin8 -> 8] (Cin8: Cin rounded up to a multiple of 8),
//       gates1 [16 -> 16], cand1 [16 -> 8]
//   L2: conv2 [8 -> 16], gates2 [32 -> 32], cand2 [32 -> 16]
//   L3: upconv1 [16 -> 8], then the score conv [8][3][3] and its bias
//       (padded to 8), read on the CUDA cores
// (bfloat16 fragments: per 16 input channels (zero-padded) 9 taps x co/8
// fragments x 64 words)
__host__ __device__ constexpr int frag_floats(int ci, int co, bool b16) {
  return b16 ? (ci + 15) / 16 * 16 * co * 9 / 2 : ci * co * 18;
}
__host__ __device__ constexpr int pad8(int cin) { return (cin + 7) / 8 * 8; }
__host__ __device__ constexpr int w1_floats(int cin, bool b16) {
  return frag_floats(pad8(cin), 8, b16) + 8 + frag_floats(16, 16, b16) + 16 +
         frag_floats(16, 8, b16) + 8;
}
// L1's cost planes: the whole (padded) cost up to kCostChunk channels, one
// chunk above; at least 16, since they take r*h1 and u1 after conv1
__host__ __device__ constexpr int cost_planes(int cin) {
  return pad8(cin) > kCostChunk ? kCostChunk : pad8(cin) > 16 ? pad8(cin) : 16;
}
__host__ __device__ constexpr int w2_floats(bool b16) {
  return frag_floats(8, 16, b16) + 16 + frag_floats(32, 32, b16) + 32 +
         frag_floats(32, 16, b16) + 16;
}
__host__ __device__ constexpr int w3_floats(bool b16) {
  return frag_floats(16, 8, b16) + 8 + 72 + 8;
}

// Tile sizes (rows, columns), largest first: L1 and L3 at full res, L2 at
// half res (a size whose shared memory exceeds a block's is passed over).
// Widths of 24, 12 and 6 make 132 tiles (one per SM of an H100) of the
// stage shapes 96x128 and 192x256 and of their half-res levels, so the GRU
// levels run there in one wave; the decoder, two blocks an SM, takes 192.
// L3's tiles are even-sized, so they start on even rows and columns.
constexpr int kMaxOpts = 7;
struct TileOpts {
  int n;
  int hw[kMaxOpts][2];
};
constexpr TileOpts kL1Tiles = {7, {{32, 32}, {16, 32}, {16, 24}, {16, 16}, {8, 16}, {8, 12},
                                   {8, 8}}};
constexpr TileOpts kL2Tiles = {7, {{16, 16}, {8, 16}, {8, 12}, {8, 8}, {4, 8}, {4, 6}, {4, 4}}};
constexpr TileOpts kL3Tiles = {4, {{16, 32}, {16, 16}, {8, 16}, {8, 8}}};

// a channel plane of n floats, padded to 8 mod 32 words
__host__ __device__ constexpr int plane(int n) { return ((n - 8 + 31) / 32) * 32 + 8; }

// copy slots per thread of a window of n floats (at the fewest threads)
constexpr int slots(int n) { return (n + kDecThreads - 1) / kDecThreads; }
constexpr int kSlots1 = slots((32 + 6) * (32 + 6));                 // L1 frame
constexpr int kSlotsH = slots((16 + 4) * (16 + 4));                 // L2 half frame
constexpr int kSlotsS = slots((2 * (16 + 4) + 1) * (2 * (16 + 4) + 1));  // L2 s1' window
constexpr int kSlotsF = slots((16 + 2) * (32 + 2));                 // L3 f window
constexpr int kSlotsG = slots((16 / 2 + 3) * (32 / 2 + 3));         // L3 s2' window

// shared-memory floats of each level at a tile size
__host__ __device__ constexpr int l1_floats(int th, int tw, int cin, bool b16) {
  return w1_floats(cin, b16) + (cost_planes(cin) + 16) * plane((th + 6) * (tw + 6));
}
__host__ __device__ constexpr int l2_floats(int th, int tw, bool b16) {
  return w2_floats(b16) + 32 * plane((th + 4) * (tw + 4)) +
         (8 * plane((2 * th + 9) * (2 * tw + 9)) > 32 * plane((th + 4) * (tw + 4))
              ? 8 * plane((2 * th + 9) * (2 * tw + 9))
              : 32 * plane((th + 4) * (tw + 4)));
}
__host__ __device__ constexpr int l3_floats(int th, int tw, bool b16) {
  return w3_floats(b16) + 8 * plane((th + 2) * (tw + 2)) +
         16 * plane((th / 2 + 3) * (tw / 2 + 3));
}
static_assert(l1_floats(16, 32, 32, false) * 4 <= kSmemMax, "L1 tile too large at Cin 32");
static_assert(l1_floats(32, 32, 16, false) * 4 <= kSmemMax, "L1 tile too large at Cin 16");
static_assert(l1_floats(16, 32, 64, false) * 4 <= kSmemMax, "L1 tile too large at Cin 64");
static_assert(l2_floats(16, 16, false) * 4 <= kSmemMax, "L2 tile too large");

// (the tensors' pointers carry bfloat16 bits in the bfloat16 mode, all but
// the softmax state, dv and s1f)
struct Step {
  const float* cost;  // [Cin, H, W]
  const float* s1;    // [8, H, W]
  const float* s2;    // [16, H2, W2]
  const float* w1;    // packed sections
  const float* w2;
  const float* w3;
  float* s1o;         // [8, H, W]
  float* s2o;         // [16, H2, W2]
  float* s1f;         // bfloat16 mode: s1' in float32 [8, H, W], for L3
  float* score;       // [2H, 2W] if up else [H, W], or null
  float* m;           // softmax state at the score's shape, or null
  float* s;
  float* acc;
  float* pmax;
  const float* dv;    // the plane's depth at the score's shape
  int Cin, H, W, H2, W2, pad_y, pad_x, up;
};

struct Tiling {
  int th, tw, tiles_x, ntiles;
};

// Where an output pixel of a conv lies: `a` its input's shared-memory
// offset at the tap origin (clamped inside for a pixel past the region),
// `o` its frame position, (y, x) its image row and column, `ok` whether it
// is one of the region's pixels.
struct Loc {
  int a, o, y, x;
  bool ok;
};

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// The weights of a level into shared memory (n floats, a multiple of 4).
__device__ __forceinline__ void load_weights(float* dst, const float* src, int n) {
  for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) cp_async16(dst + i, src + i, 16);
}

// Channels [0, nch) of a [nch, H, W] tensor, window rows [y0, y0 + R) x
// columns [x0, x0 + C), into planes of `cs` floats (row pitch C); zeros
// outside the image, and in planes [nch, npl) (a width padded to 8). Each
// thread's window positions are worked out once. B16: the tensor is
// bfloat16, upcast with plain loads (cp.async copies 4 bytes at least).
template <int S, bool B16>
__device__ __forceinline__ void load_window(float* dst, int cs, const float* src, int H, int W,
                                            int nch, int y0, int x0, int R, int C,
                                            int npl = 0) {
  const long long HW = (long long)H * W;
  int spos[S], goff[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int idx = threadIdx.x + k * blockDim.x;
    const int r = idx / C, c = idx - r * C;
    const int iy = y0 + r, ix = x0 + c;
    spos[k] = idx < R * C ? idx : -1;
    goff[k] = iy >= 0 && iy < H && ix >= 0 && ix < W ? iy * W + ix : -1;
  }
#pragma unroll 1
  for (int ch = nch; ch < npl; ++ch)
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (spos[k] >= 0) dst[ch * cs + spos[k]] = 0.f;
  if constexpr (B16) {
    const bf16_t* sb = reinterpret_cast<const bf16_t*>(src);
#pragma unroll 1
    for (int ch = 0; ch < nch; ++ch) {
      const bf16_t* sc = sb + ch * HW;
#pragma unroll
      for (int k = 0; k < S; ++k)
        if (spos[k] >= 0) dst[ch * cs + spos[k]] = goff[k] >= 0 ? bf2f(__ldg(sc + goff[k])) : 0.f;
    }
    return;
  }
#pragma unroll 1
  for (int ch = 0; ch < nch; ++ch) {
    const float* sc = src + ch * HW;
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (spos[k] >= 0)
        cp_async4(dst + ch * cs + spos[k], goff[k] >= 0 ? sc + goff[k] : src, goff[k] >= 0);
  }
}

// One 3x3 conv on the tensor cores. The output pixels are flattened into
// m16 fragments; the work is dealt to the block's warps in items of MI
// fragments x NFI n8 fragments of output channels (of the layer's nfr),
// the MI fragments' MMAs interleaved. loc(p) places output pixel p (any p:
// Loc); tap(mf, j, d) says whether tap j (ky * 3 + kx) applies to fragment
// mf (the same for the MI fragments of an item) and sets its offset d;
// chunk(k) is the plane of the first of input chunk k's 8 channels (planes
// `cs` apart); epi(loc, co, v) gets every output element of the mfrags
// fragments.
//   float32 (3xTF32): w the layer's packed fragments ([chunk][tap][nfr]
//   [128]); the three products of 3xTF32 go to three sums (no MMA waits on
//   another's result within a tap), each run chunk by chunk, tap by tap,
//   whatever MI and NFI are, and added as hi*hi + (lo*hi + hi*lo).
//   B16: one mma.sync m16n8k16 bf16 a tap over 16 input channels, the
//   8-channel chunks 2k and 2k+1 (zero past the layer); the A fragment's
//   channel pairs (2t, 2t+1) of each chunk are read from the float32
//   planes and rounded to bfloat16 as they are packed; w the layer's
//   bfloat16 fragments ([chunk of 16][tap][nfr][64 words]).
template <bool B16, int MI, int NFI, class Place, class Tap, class Chunk, class Epi>
__device__ __forceinline__ void conv_items(int mfrags, int nfr, int nchunks, int cs,
                                           const float* w, Place loc, Tap tap, Chunk chunk,
                                           Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mgroups = (mfrags + MI - 1) / MI, ngroups = nfr / NFI;
#pragma unroll 1
  for (int it = warp; it < mgroups * ngroups; it += nwarps) {
    const int mg = it / ngroups, nf0 = (it - mg * ngroups) * NFI, mf0 = mg * MI;
    int oa[MI], ob[MI];  // the pixels' input offsets (placed again for the epilogue)
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      oa[i] = loc((mf0 + i) * 16 + g).a;
      ob[i] = loc((mf0 + i) * 16 + g + 8).a;
    }
    // three independent sums: hi*hi, lo*hi and hi*lo (B16: the first only)
    float acc[MI][NFI][4], alh[MI][NFI][4], ahl[MI][NFI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int n = 0; n < NFI; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][n][q] = alh[i][n][q] = ahl[i][n][q] = 0.f;
    if constexpr (B16) {
      const uint32_t* wu = reinterpret_cast<const uint32_t*>(w);
#pragma unroll 1
      for (int k = 0; k < (nchunks + 1) / 2; ++k) {
        const bool two = 2 * k + 1 < nchunks;
        const float* c0 = chunk(2 * k) + 2 * t * cs;
        const float* c1 = two ? chunk(2 * k + 1) + 2 * t * cs : c0;
        const uint32_t* wk = wu + ((long long)k * 9 * nfr + nf0) * kFragB + lane * 2;
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          int d = 0;
          if (!tap(mf0, j, d)) continue;
          uint2 b[NFI];
#pragma unroll
          for (int n = 0; n < NFI; ++n)
            b[n] = *reinterpret_cast<const uint2*>(wk + (j * nfr + n) * kFragB);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            // A: (pixel g, channels 2t, 2t+1), (g + 8, ..), then 2t+8, 2t+9
            const float *pa = c0 + oa[i] + d, *pb = c0 + ob[i] + d;
            const float *qa = c1 + oa[i] + d, *qb = c1 + ob[i] + d;
            const uint32_t a[4] = {pack_bf16x2(pa[0], pa[cs]), pack_bf16x2(pb[0], pb[cs]),
                                   two ? pack_bf16x2(qa[0], qa[cs]) : 0u,
                                   two ? pack_bf16x2(qb[0], qb[cs]) : 0u};
#pragma unroll
            for (int n = 0; n < NFI; ++n) mma_bf16(acc[i][n], a, b[n].x, b[n].y);
          }
        }
      }
    } else {
#pragma unroll 1
      for (int k = 0; k < nchunks; ++k) {
        const float* in = chunk(k) + t * cs;
        const float* wk = w + ((long long)k * 9 * nfr + nf0) * kFrag + lane * 4;
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          int d = 0;
          if (!tap(mf0, j, d)) continue;
          float4 b[NFI];
#pragma unroll
          for (int n = 0; n < NFI; ++n)
            b[n] = *reinterpret_cast<const float4*>(wk + (j * nfr + n) * kFrag);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            // A: (pixel g, channel t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
            const float* pa = in + oa[i] + d;
            const float* pb = in + ob[i] + d;
            const float x[4] = {pa[0], pb[0], pa[4 * cs], pb[4 * cs]};
            uint32_t ah[4], al[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) split_tf32(x[q], ah[q], al[q]);
#pragma unroll
            for (int n = 0; n < NFI; ++n) {
              const uint32_t bh0 = __float_as_uint(b[n].x), bh1 = __float_as_uint(b[n].y);
              const uint32_t bl0 = __float_as_uint(b[n].z), bl1 = __float_as_uint(b[n].w);
              mma_tf32(alh[i][n], al, bh0, bh1);
              mma_tf32(ahl[i][n], ah, bl0, bl1);
              mma_tf32(acc[i][n], ah, bh0, bh1);
            }
          }
        }
      }
    }
    // C: (pixel g, channel 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const Loc la = loc((mf0 + i) * 16 + g), lb = loc((mf0 + i) * 16 + g + 8);
#pragma unroll
      for (int n = 0; n < NFI; ++n) {
        const int co = (nf0 + n) * 8 + 2 * t;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[q] = B16 ? acc[i][n][q] : acc[i][n][q] + (alh[i][n][q] + ahl[i][n][q]);
        if (la.ok) {
          epi(la, co, v[0]);
          epi(la, co + 1, v[1]);
        }
        if (lb.ok) {
          epi(lb, co, v[2]);
          epi(lb, co + 1, v[3]);
        }
      }
    }
  }
}

// conv_items with the item shape picked for the work at hand: the
// cheapest in instructions per MMA that still gives every warp an item,
// else one fragment by one n8 fragment (the most items). An A fragment
// (4 loads, 4 splits) costs ~7x a B fragment (one 16-byte load), so the
// order is 1 x 4, 2 x 2, 1 x 2, 2 x 1.
template <bool B16, class Place, class Tap, class Chunk, class Epi>
__device__ __forceinline__ void conv_mma(int mfrags, int nfr, int nchunks, int cs,
                                         const float* w, Place loc, Tap tap, Chunk chunk,
                                         Epi epi) {
  const int pairs = (mfrags + 1) / 2, nwarps = blockDim.x >> 5;
  if (nfr % 4 == 0 && mfrags * (nfr / 4) >= nwarps)
    conv_items<B16, 1, 4>(mfrags, nfr, nchunks, cs, w, loc, tap, chunk, epi);
  else if (nfr % 2 == 0 && pairs * (nfr / 2) >= nwarps)
    conv_items<B16, 2, 2>(mfrags, nfr, nchunks, cs, w, loc, tap, chunk, epi);
  else if (nfr % 2 == 0 && mfrags * (nfr / 2) >= nwarps)
    conv_items<B16, 1, 2>(mfrags, nfr, nchunks, cs, w, loc, tap, chunk, epi);
  else if (pairs * nfr >= nwarps)
    conv_items<B16, 2, 1>(mfrags, nfr, nchunks, cs, w, loc, tap, chunk, epi);
  else
    conv_items<B16, 1, 1>(mfrags, nfr, nchunks, cs, w, loc, tap, chunk, epi);
}

// The output region of a stride-1 conv over a frame of FR x FC (row
// pitch FC) at image origin (fy, fx): the frame less a ring of k.
struct Ring {
  int rw, k, pitch, m, fy, fx;
  __device__ Ring(int FR, int FC, int k_, int fy_, int fx_)
      : rw(FC - 2 * k_), k(k_), pitch(FC), m((FR - 2 * k_) * (FC - 2 * k_)), fy(fy_), fx(fx_) {}
  __device__ int frags() const { return (m + 15) / 16; }
  __device__ Loc loc(int p) const {
    Loc l;
    l.ok = p < m;
    const int q = l.ok ? p : m - 1;
    const int r = q / rw, c = q - r * rw;
    l.o = l.a = (r + k) * pitch + c + k;
    l.y = fy + r + k;
    l.x = fx + c + k;
    return l;
  }
};

// L1: x1, the gates and the candidate of the full-res GRU over a tile of
// s1'. Frame: the tile + a 3-px ring, origin (y0 - 3, x0 - 3). Chunked
// (a cost of more than kCostChunk channels): conv1 over the cost's chunks.
template <bool B16, bool Chunked>
__global__ void __launch_bounds__(kGruThreads) red2_level1_kernel(const __grid_constant__ Step p,
                                                                  const Tiling t) {
  extern __shared__ __align__(16) float smem[];
  const int Cin = p.Cin, C8 = pad8(Cin);
  const int nw = w1_floats(Cin, B16);
  const int FR = t.th + 6, FC = t.tw + 6, CS = plane(FR * FC);
  const long long HW = (long long)p.H * p.W;
  float* wts = smem;
  float* cst = smem + nw;                    // cost (a chunk of it); then r*h1 | u1
  float* x1 = cst + cost_planes(Cin) * CS;
  float* h1 = x1 + 8 * CS;
  float* rh = cst;
  float* u1 = cst + 8 * CS;
  const float* wc = wts;
  const float* bc = wc + frag_floats(C8, 8, B16);
  const float* wg = bc + 8;
  const float* bg = wg + frag_floats(16, 16, B16);
  const float* wd = bg + 16;
  const float* bd = wd + frag_floats(16, 8, B16);
  load_weights(wts, p.w1, nw);
  cp_async_commit();

  auto tap = [FC](int, int j, int& d) {
    d = (j / 3 - 1) * FC + (j % 3 - 1);
    return true;
  };
#pragma unroll 1
  for (int tile = blockIdx.x; tile < t.ntiles; tile += gridDim.x) {
    const int fy = (tile / t.tiles_x) * t.th - 3, fx = (tile % t.tiles_x) * t.tw - 3;
    const Ring r1(FR, FC, 1, fy, fx), r2(FR, FC, 2, fy, fx), r3(FR, FC, 3, fy, fx);
    // x1 = relu(conv1(cost) + b) over the 2-px ring (0 outside the image:
    // the GRU convs pad x1 with zeros)
    if constexpr (!Chunked) {
      load_window<kSlots1, B16>(cst, CS, p.cost, p.H, p.W, Cin, fy, fx, FR, FC, C8);
      load_window<kSlots1, B16>(h1, CS, p.s1, p.H, p.W, 8, fy, fx, FR, FC);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      conv_mma<B16>(r1.frags(), 1, C8 / 8, CS, wc, [&](int q) { return r1.loc(q); }, tap,
               [&](int k) { return cst + k * 8 * CS; },
               [&](const Loc& l, int co, float v) {
                 const bool in = l.y >= 0 && l.y < p.H && l.x >= 0 && l.x < p.W;
                 x1[co * CS + l.o] = in ? fmaxf(v + bc[co], 0.f) : 0.f;
               });
    } else {
      // the cost's chunks of kCostChunk channels, each chunk's sums into
      // x1, the bias and ReLU after the last
      load_window<kSlots1, B16>(h1, CS, p.s1, p.H, p.W, 8, fy, fx, FR, FC);
#pragma unroll 1
      for (int c0 = 0; c0 < C8; c0 += kCostChunk) {
        const int npl = min(kCostChunk, C8 - c0);
        const bool last = c0 + kCostChunk >= C8;
        if (c0 > 0) __syncthreads();  // the previous chunk's planes are read
        const float* src = B16 ? reinterpret_cast<const float*>(
                                     reinterpret_cast<const bf16_t*>(p.cost) + c0 * HW)
                               : p.cost + c0 * HW;
        load_window<kSlots1, B16>(cst, CS, src, p.H, p.W, min(npl, Cin - c0), fy, fx, FR,
                                  FC, npl);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        conv_mma<B16>(r1.frags(), 1, npl / 8, CS, wc + frag_floats(c0, 8, B16),
                 [&](int q) { return r1.loc(q); }, tap, [&](int k) { return cst + k * 8 * CS; },
                 [&](const Loc& l, int co, float v) {
                   float& o = x1[co * CS + l.o];
                   const float sum = c0 == 0 ? v : o + v;
                   if (!last) {
                     o = sum;
                     return;
                   }
                   const bool in = l.y >= 0 && l.y < p.H && l.x >= 0 && l.x < p.W;
                   o = in ? fmaxf(sum + bc[co], 0.f) : 0.f;
                 });
      }
    }
    __syncthreads();

    // gates over the 1-px ring: r*h1 (0 outside the image, where h1 is 0)
    // and u1; the cost planes are free now
    conv_mma<B16>(r2.frags(), 2, 2, CS, wg, [&](int q) { return r2.loc(q); }, tap,
             [&](int k) { return k == 0 ? x1 : h1; },
             [&](const Loc& l, int co, float v) {
               const float gv = sigmoidf(v + bg[co]);
               if (co < 8) rh[co * CS + l.o] = gv * h1[co * CS + l.o];
               else u1[(co - 8) * CS + l.o] = gv;
             });
    __syncthreads();

    // candidate over the tile -> s1' = u1*h1 + (1-u1)*tanh(.)
    conv_mma<B16>(r3.frags(), 1, 2, CS, wd, [&](int q) { return r3.loc(q); }, tap,
             [&](int k) { return k == 0 ? x1 : rh; },
             [&](const Loc& l, int co, float v) {
               if (l.y >= p.H || l.x >= p.W) return;
               const int o = co * CS + l.o;
               const float u = u1[o], h = h1[o];
               const float r = u * h + (1.f - u) * tanhf(v + bd[co]);
               const long long e = (long long)co * p.H * p.W + l.y * p.W + l.x;
               if constexpr (B16) {
                 reinterpret_cast<bf16_t*>(p.s1o)[e] = f2bf(r);
                 p.s1f[e] = r;
               } else {
                 p.s1o[e] = r;
               }
             });
    __syncthreads();  // the next tile's copies overwrite the planes
  }
}

// L2: x2, the gates and the candidate of the half-res GRU over a tile of
// s2'. Frame: the tile + a 2-px ring at half res, origin (q0y - 2, q0x - 2);
// s1' over the full-res window that frame's x2 reads (2 * rows + 1).
template <bool B16>
__global__ void __launch_bounds__(kGruThreads) red2_level2_kernel(const __grid_constant__ Step p,
                                                                  const Tiling t) {
  extern __shared__ __align__(16) float smem[];
  const int FR = t.th + 4, FC = t.tw + 4, CS = plane(FR * FC);
  const int SR = 2 * FR + 1, SC = 2 * FC + 1, CSS = plane(SR * SC);
  float* wts = smem;
  float* x2 = smem + w2_floats(B16);
  float* h2 = x2 + 16 * CS;
  float* un = h2 + 16 * CS;  // s1' window; then r*h2 | u2
  float* rh = un;
  float* u2 = un + 16 * CS;
  const float* wc = wts;
  const float* bc = wc + frag_floats(8, 16, B16);
  const float* wg = bc + 16;
  const float* bg = wg + frag_floats(32, 32, B16);
  const float* wd = bg + 32;
  const float* bd = wd + frag_floats(32, 16, B16);
  load_weights(wts, p.w2, w2_floats(B16));
  cp_async_commit();

  auto tap = [FC](int, int j, int& d) {
    d = (j / 3 - 1) * FC + (j % 3 - 1);
    return true;
  };
#pragma unroll 1
  for (int tile = blockIdx.x; tile < t.ntiles; tile += gridDim.x) {
    const int fy = (tile / t.tiles_x) * t.th - 2, fx = (tile % t.tiles_x) * t.tw - 2;
    const Ring r0(FR, FC, 0, fy, fx), r1(FR, FC, 1, fy, fx), r2(FR, FC, 2, fy, fx);
    load_window<kSlotsS, B16>(un, CSS, p.s1o, p.H, p.W, 8, 2 * fy - p.pad_y,
                              2 * fx - p.pad_x, SR, SC);
    load_window<kSlotsH, B16>(h2, CS, p.s2, p.H2, p.W2, 16, fy, fx, FR, FC);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // x2 = relu(conv2 stride 2 (s1') + b) over the whole frame: frame
    // pixel (r, c) reads window (2r + ky, 2c + kx)
    conv_mma<B16>(r0.frags(), 2, 1, CSS, wc,
             [&](int q) {
               Loc l = r0.loc(q);
               const int r = l.y - fy, c = l.x - fx;
               l.a = 2 * r * SC + 2 * c;
               return l;
             },
             [SC](int, int j, int& d) {
               d = (j / 3) * SC + j % 3;
               return true;
             },
             [&](int) { return un; },
             [&](const Loc& l, int co, float v) {
               const bool in = l.y >= 0 && l.y < p.H2 && l.x >= 0 && l.x < p.W2;
               x2[co * CS + l.o] = in ? fmaxf(v + bc[co], 0.f) : 0.f;
             });
    __syncthreads();

    // gates over the 1-px ring: r*h2 and u2 (the s1' window is free now)
    conv_mma<B16>(r1.frags(), 4, 4, CS, wg, [&](int q) { return r1.loc(q); }, tap,
             [&](int k) { return k < 2 ? x2 + k * 8 * CS : h2 + (k - 2) * 8 * CS; },
             [&](const Loc& l, int co, float v) {
               const float gv = sigmoidf(v + bg[co]);
               if (co < 16) rh[co * CS + l.o] = gv * h2[co * CS + l.o];
               else u2[(co - 16) * CS + l.o] = gv;
             });
    __syncthreads();

    // candidate over the tile -> s2'
    conv_mma<B16>(r2.frags(), 2, 4, CS, wd, [&](int q) { return r2.loc(q); }, tap,
             [&](int k) { return k < 2 ? x2 + k * 8 * CS : rh + (k - 2) * 8 * CS; },
             [&](const Loc& l, int co, float v) {
               if (l.y >= p.H2 || l.x >= p.W2) return;
               const int o = co * CS + l.o;
               const float u = u2[o], h = h2[o];
               const float r = u * h + (1.f - u) * tanhf(v + bd[co]);
               const long long e = (long long)co * p.H2 * p.W2 + l.y * p.W2 + l.x;
               if constexpr (B16) reinterpret_cast<bf16_t*>(p.s2o)[e] = f2bf(r);
               else p.s2o[e] = r;
             });
    __syncthreads();
  }
}

// L3: f = relu(upconv1(s2') + b + s1') over a full-res tile + 1-px ring
// (origin (y0 - 1, x0 - 1)), the score over the tile, the softmax update.
// s2' window: half-res rows from y0/2 - 2, th/2 + 3 of them (the rows the
// transposed conv reads for f's rows y0 - 1 .. y0 + th).
template <bool B16>
__global__ void __launch_bounds__(kDecThreads, 2) red2_level3_kernel(const __grid_constant__ Step p,
                                                                     const Tiling t) {
  extern __shared__ __align__(16) float smem[];
  const int FR = t.th + 2, FC = t.tw + 2, CS = plane(FR * FC);
  const int HR = t.th / 2 + 3, HC = t.tw / 2 + 3, CSH = plane(HR * HC);
  float* wts = smem;
  float* f = smem + w3_floats(B16);  // s1', then f in place
  float* g2 = f + 8 * CS;
  const float* wu = wts;
  const float* bu = wu + frag_floats(16, 8, B16);
  const float* ws = bu + 8;  // [8][3][3], then the bias
  load_weights(wts, p.w3, w3_floats(B16));
  // the score conv reads f rounded to bfloat16 in the bfloat16 mode
  auto fr = [](float x) {
    if constexpr (B16) return bf16_round(x);
    else return x;
  };
  cp_async_commit();

  // upconv1 by output phase: frame pixel (r, c) = (2a + ry, 2b + rx); the
  // phase grids are PA x PB, each padded to an even count of m16
  // fragments, so no item of two fragments spans two phases
  const int PA = FR / 2, PB = FC / 2, MP = PA * PB, fpp = 2 * ((MP + 31) / 32);
  const int SH = p.up ? 2 * p.H : p.H, SW = p.up ? 2 * p.W : p.W;
  const int sth = p.up ? 2 * t.th : t.th, stw = p.up ? 2 * t.tw : t.tw;
  bool first = true;
  float wr[72];  // the score weights, in registers once they have arrived
#pragma unroll 1
  for (int tile = blockIdx.x; tile < t.ntiles; tile += gridDim.x) {
    const int y0 = (tile / t.tiles_x) * t.th, x0 = (tile % t.tiles_x) * t.tw;
    // s1' as float32: in the bfloat16 mode its copy before rounding
    load_window<kSlotsF, false>(f, CS, B16 ? p.s1f : p.s1o, p.H, p.W, 8, y0 - 1, x0 - 1, FR,
                                FC);
    load_window<kSlotsG, B16>(g2, CSH, p.s2o, p.H2, p.W2, 16, y0 / 2 - 2, x0 / 2 - 2, HR, HC);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (first) {
#pragma unroll
      for (int i = 0; i < 72; ++i) wr[i] = ws[i];
      first = false;
    }

    // Y = y0 - 1 + r with y0 even: Y is even where r is odd. Output Y takes
    // the taps ky = Y (mod 2), input row (Y - ky) / 2, window row
    // a + (ry + 3 - ky) / 2; columns alike.
    conv_mma<B16>(4 * fpp, 1, 2, CSH, wu,
             [&](int q) {
               const int ph = q / (16 * fpp);
               const int e = q - ph * 16 * fpp;
               Loc l;
               l.ok = e < MP;
               const int ee = l.ok ? e : MP - 1;
               const int a = ee / PB, b = ee - a * PB;
               const int r = 2 * a + (ph >> 1), c = 2 * b + (ph & 1);
               l.a = a * HC + b;
               l.o = r * FC + c;
               l.y = y0 - 1 + r;
               l.x = x0 - 1 + c;
               return l;
             },
             [&](int mf, int j, int& d) {
               const int ph = mf / fpp, ry = ph >> 1, rx = ph & 1;
               const int ky = j / 3, kx = j % 3;
               if ((ky & 1) != 1 - ry || (kx & 1) != 1 - rx) return false;
               d = ((ry + 3 - ky) >> 1) * HC + ((rx + 3 - kx) >> 1);
               return true;
             },
             [&](int k) { return g2 + k * 8 * CSH; },
             [&](const Loc& l, int co, float v) {
               const bool in = l.y >= 0 && l.y < p.H && l.x >= 0 && l.x < p.W;
               const int o = co * CS + l.o;
               // up1 + bias, rounded in the bfloat16 mode (the TPU kernel
               // selects its phases with bfloat16 one-hot products)
               f[o] = in ? fmaxf(fr(v + bu[co]) + f[o], 0.f) : 0.f;
             });
    __syncthreads();

    // the score on the CUDA cores, then the softmax update in place
    const int sy0 = p.up ? 2 * y0 : y0, sx0 = p.up ? 2 * x0 : x0;
#pragma unroll 1
    for (int idx = threadIdx.x; idx < sth * stw; idx += blockDim.x) {
      const int ys = sy0 + idx / stw, xs = sx0 + idx % stw;
      if (ys >= SH || xs >= SW) continue;
      float v = 0.f;
      if (p.up) {  // score (ys, xs) = 2 * f(i, j) + (ky, kx)
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          if ((ys - ky) & 1) continue;
          const int r = ((ys - ky) >> 1) - y0 + 1;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            if ((xs - kx) & 1) continue;
            const float* fo = f + r * FC + ((xs - kx) >> 1) - x0 + 1;
#pragma unroll
            for (int ci = 0; ci < 8; ++ci) v = fmaf(wr[(ci * 3 + ky) * 3 + kx], fr(fo[ci * CS]), v);
          }
        }
      } else {
        const float* fo = f + (ys - y0) * FC + xs - x0;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky)
#pragma unroll
          for (int kx = 0; kx < 3; ++kx)
#pragma unroll
            for (int ci = 0; ci < 8; ++ci)
              v = fmaf(wr[(ci * 3 + ky) * 3 + kx], fr(fo[ci * CS + ky * FC + kx]), v);
      }
      v = fr(v + ws[72]);
      const long long o = (long long)ys * SW + xs;
      if (p.score) {
        if constexpr (B16) reinterpret_cast<bf16_t*>(p.score)[o] = f2bf(v);
        else p.score[o] = v;
      }
      if (p.m) {
        const float m = p.m[o], mn = fmaxf(m, v);
        const float scale = expf(m - mn), e = expf(v - mn);
        p.m[o] = mn;
        p.s[o] = __fadd_rn(__fmul_rn(p.s[o], scale), e);
        p.acc[o] = __fadd_rn(__fmul_rn(p.acc[o], scale), __fmul_rn(e, p.dv[o]));
        p.pmax[o] = fmaxf(__fmul_rn(p.pmax[o], scale), e);
      }
    }
    __syncthreads();
  }
}

// 'SAME' low-side padding (TensorFlow's rule) of a stride-2 3x3 conv over n -> ceil(n/2)
inline int same_pad_lo(int n) {
  const int out = (n + 1) / 2;
  const int total = (out - 1) * 2 + 3 - n;
  return total > 0 ? total / 2 : 0;
}

using Kernel = void (*)(Step, Tiling);

// Blocks of a kernel one SM holds at once with `threads` threads and
// `bytes` of dynamic shared memory, asked once per device, kernel and shape
// (the kernel's dynamic shared-memory limit is raised first).
int resident(Kernel k, int threads, int bytes) {
  static std::mutex mu;
  static std::map<std::tuple<int, std::uintptr_t, int, int>, int> cached;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  const auto key = std::make_tuple(dev, reinterpret_cast<std::uintptr_t>(k), threads, bytes);
  const std::lock_guard<std::mutex> lock(mu);
  const auto it = cached.find(key);
  if (it != cached.end()) return it->second;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax) !=
      cudaSuccess)
    return 1;
  int got = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, k, threads, bytes);
  return cached[key] = got > 0 ? got : 1;
}

// Per level, whether a tiling's last wave of blocks must be at least half
// full: L1 at 384x512 takes 79 us in 384 tiles of 16 x 32 against 88 in
// 192 of 32 x 32 (1.45 waves); L2 and L3 run faster in their larger tiles
// all the same (69 against 78 us, 38 against 45: scripts/red_step2_probe.py).
constexpr bool kFullWaves[3] = {true, false, false};

// Launch a level over an h x w output: the largest tile size whose tiles
// give every SM a block (and, where the level asks, leave the last wave
// of blocks at least half full), else the smallest; persistent blocks of
// `threads`, or of kDecThreads where only those take every tile at once.
template <class Bytes>
cudaError_t launch(Kernel k, int level, int threads, const TileOpts& opts, int h, int w,
                   Bytes bytes, const Step& p, cudaStream_t s) {
  const int sms = sm_count() > 0 ? sm_count() : 132;
  int opt = 0;
  Tiling t{};
  long long cap = 0;
  for (opt = 0; opt < opts.n; ++opt) {
    t.th = opts.hw[opt][0];
    t.tw = opts.hw[opt][1];
    if (bytes(t.th, t.tw) * (int)sizeof(float) > kSmemMax) continue;
    t.tiles_x = (w + t.tw - 1) / t.tw;
    t.ntiles = ((h + t.th - 1) / t.th) * t.tiles_x;
    cap = (long long)sms * resident(k, threads, bytes(t.th, t.tw) * (int)sizeof(float));
    const long long last = t.ntiles % cap;
    if ((t.ntiles >= sms && (!kFullWaves[level] || last == 0 || 2 * last >= cap)) ||
        opt == opts.n - 1)
      break;
  }
  const int nbytes = bytes(t.th, t.tw) * (int)sizeof(float);
  if (threads != kDecThreads && t.ntiles > cap) {
    const long long half = (long long)sms * resident(k, kDecThreads, nbytes);
    if (t.ntiles <= half) {
      threads = kDecThreads;
      cap = half;
    }
  }
  const int grid = (int)(t.ntiles < cap ? t.ntiles : cap);
  k<<<grid, threads, nbytes, s>>>(p, t);
  return cudaGetLastError();
}

#define RS2_CHECK(expr)                    \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

}  // namespace

extern "C" const char* error_string(int code) {
  if (code == kBadArgs) return "bad arguments (sizes, or neither a score nor a softmax state)";
  return cudaGetErrorString((cudaError_t)code);
}

// Floats of the packed weights (ops/red_step2.py:pack_params) at Cin, for
// red_step2_f32 (bf16 = 0) or red_step2_bf16 (bf16 = 1).
extern "C" long long red_step2_param_floats(int Cin, int bf16) {
  return w1_floats(Cin, bf16) + w2_floats(bf16) + w3_floats(bf16);
}

namespace {

// One step in 3 launches, either mode (see red_step2_f32).
template <bool B16>
int step(const float* cost, int Cin, const float* s1, const float* s2, const float* w,
         float* s1_out, float* s2_out, float* s1f, float* score, float* m, float* s,
         float* acc, float* pmax, const float* dv, int H, int W, int up, void* stream) {
  if (Cin < 1 || H <= 0 || W <= 0 || (!score && !m) || (m && (!s || !acc || !pmax || !dv)) ||
      (B16 && !s1f))
    return kBadArgs;
  cudaStream_t st = (cudaStream_t)stream;
  Step p;
  p.cost = cost; p.s1 = s1; p.s2 = s2;
  p.w1 = w; p.w2 = w + w1_floats(Cin, B16); p.w3 = p.w2 + w2_floats(B16);
  p.s1o = s1_out; p.s2o = s2_out; p.s1f = s1f; p.score = score;
  p.m = m; p.s = s; p.acc = acc; p.pmax = pmax; p.dv = dv;
  p.Cin = Cin; p.H = H; p.W = W; p.H2 = (H + 1) / 2; p.W2 = (W + 1) / 2;
  p.pad_y = same_pad_lo(H); p.pad_x = same_pad_lo(W); p.up = up ? 1 : 0;
  RS2_CHECK(launch(pad8(Cin) > kCostChunk ? red2_level1_kernel<B16, true>
                                           : red2_level1_kernel<B16, false>,
                   0, kGruThreads, kL1Tiles, H, W,
                   [Cin](int th, int tw) { return l1_floats(th, tw, Cin, B16); }, p, st));
  RS2_CHECK(launch(red2_level2_kernel<B16>, 1, kGruThreads, kL2Tiles, p.H2, p.W2,
                   [](int th, int tw) { return l2_floats(th, tw, B16); }, p, st));
  RS2_CHECK(launch(red2_level3_kernel<B16>, 2, kDecThreads, kL3Tiles, H, W,
                   [](int th, int tw) { return l3_floats(th, tw, B16); }, p, st));
  return 0;
}

}  // namespace

// One RedStep2 step in 3 launches. cost [Cin,H,W], s1 [8,H,W], s2
// [16,H2,W2] with H2 = ceil(H/2), W2 = ceil(W/2); w the packed weights
// (16-byte aligned). Writes s1_out and s2_out; then, at the score's shape
// ([2H,2W] if up else [H,W]), the score when `score` is given, and the
// online-softmax update of (m, s, acc, pmax) in place with the plane's
// depth dv when `m` is given. The inputs are not modified.
extern "C" int red_step2_f32(const float* cost, int Cin, const float* s1, const float* s2,
                             const float* w, float* s1_out, float* s2_out, float* score,
                             float* m, float* s, float* acc, float* pmax, const float* dv,
                             int H, int W, int up, void* stream) {
  return step<false>(cost, Cin, s1, s2, w, s1_out, s2_out, nullptr, score, m, s, acc, pmax,
                     dv, H, W, up, stream);
}

// The bfloat16 mode: cost, s1, s2, s1_out, s2_out and the score in
// bfloat16, w packed with bfloat16 fragments (pack_params(..., bfloat16)),
// s1f [8,H,W] float32 scratch (s1' before its rounding); the softmax state
// and dv float32.
extern "C" int red_step2_bf16(const void* cost, int Cin, const void* s1, const void* s2,
                              const float* w, void* s1_out, void* s2_out, float* s1f,
                              void* score, float* m, float* s, float* acc, float* pmax,
                              const float* dv, int H, int W, int up, void* stream) {
  return step<true>(static_cast<const float*>(cost), Cin, static_cast<const float*>(s1),
                    static_cast<const float*>(s2), w, static_cast<float*>(s1_out),
                    static_cast<float*>(s2_out), s1f, static_cast<float*>(score), m, s, acc,
                    pmax, dv, H, W, up, stream);
}
