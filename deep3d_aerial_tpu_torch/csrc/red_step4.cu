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
// What bounds it on an H100: operations. A step is ~31 kflop per full-res
// pixel against ~150 B of cost, state and score traffic. Done fp32-exact on
// the tensor cores (3xTF32: 495 / 3 = 165 TFLOP/s) the 384x512 Cin 8 step's
// 6.14 GFLOP take 0.037 ms, still above its 0.011 ms of memory traffic; in
// the bfloat16 mode (989 TFLOP/s) 0.006 ms, about its halved traffic. The
// step takes ~0.45 ms either way: instruction issue and latency bound it.
//
// K5, the conv template, is an implicit GEMM on the tensor cores: M = output
// pixels, N = output channels, K = input channels x taps, with no im2col in
// device memory.
//   - Tile: a block of 4 warps owns 16 output channels (two n8 fragments)
//     over a tile of rows x 16 pixels; a warp owns 2 rows (two m16
//     fragments, 16 pixels of a row each). Its A fragments are read from
//     the input's halo tile in shared memory at each tap's offset (the
//     halo's channel planes are padded to 8 mod 32 words, so a fragment
//     load hits 32 banks); its B fragments are one 16-byte load per lane
//     from weights packed in fragment order.
//   - 3xTF32: mma.sync m16n8k8 TF32 with every operand split hi + lo and
//     hi*hi + hi*lo + lo*hi summed in fp32 (the TPU kernel's 'f32x3' MXU
//     precision). The weights are split once, when they are packed
//     (ops/cf_conv.py:pack_weight); the inputs when a fragment is built.
//   - Staging: cp.async fills a 3-stage ring, one stage per 8 input
//     channels (halo tile + the stage's weights), so two chunks are in
//     flight while the MMAs run on a third. Stages above 48 KB take the
//     dynamic shared-memory attribute, set once per device.
//   - Split input channels where the grid is small. A tile (8 rows x 16
//     pixels x 16 channels) reads its weights from L2 once per 128 pixels;
//     the deep levels' weights (gru4's 128 -> 128: 1.2 MB as hi + lo)
//     dwarf their inputs, so tiles stay whole. While a layer's tiles
//     would not give every SM 4 blocks, S blocks split its input
//     channels: each leaves its sums in scratch, and the tile's last
//     split to finish (an integer ticket per tile) adds the S sums in
//     split order and runs the epilogue. Only where one split per chunk
//     still leaves an SM idle do a block's warps split the taps too (2
//     or 4 ways, tile rows 8 -> 4 -> 2), their sums added in shared
//     memory in warp order. No float atomics: the order of every sum is
//     fixed.
//   - Transposed conv by output phase: a block covers one of the four
//     output parities, which reads only its own 1, 2, 2 or 4 taps.
//   - Epilogue: bias, optional ReLU, the block's GroupNorm (sum, sum of
//     squares) partials in a fixed order; a concatenated second input
//     (GRU) or a summed one (decoder skips, added from a second halo) on
//     load.
//   - One launch runs up to four such convolutions from a problem table
//     indexed by blockIdx, each with as many blocks as its tiles: a level's
//     share of the grid follows its work, the deepest level first.
//
// bfloat16 mode (the *_bf16 entries; the JAX package's dtype=bfloat16,
// precision='bf16'): the template's bfloat16 instance takes 16 input
// channels a stage, staged as 8 planes of channel pairs (two bfloat16 in
// a word), so an A fragment is the same 4 words a lane reads in float32
// and feeds one mma.sync m16n8k16 bf16 (float32 sums) where 3xTF32 issues
// three m16n8k8; the B fragments are packed once in bfloat16
// (ops/cf_conv.py:pack_frags_bf16), one 8-byte load a lane. The halo is
// read from device memory with plain loads (cp.async copies 4 bytes at
// least; a pair comes from two channel planes). A second (summed) input is
// added in float32 and the sum rounded to bfloat16, as the TPU kernel
// rounds a product's operands. Every buffer of the step is bfloat16 as the
// TPU kernel's scratch is (cost, states, d1-d3, the gates' and
// candidates' pre-activations, r*h, the decoder's outputs, the score): an
// output rounds once, after bias and ReLU; the GroupNorm partials are
// taken from the float32 values before they round, and the statistics,
// the GroupNorms and the GRU's pointwise arithmetic run in float32.
//
// Launches per step: 11 -- conv1, conv2, conv3 (down), the gates of all
// four levels (one grouped launch), the reset pass (r*h), the candidates
// of all four levels (grouped), the update pass (h'), upconv3, upconv2,
// upconv1 and the score; 9 of them are the conv template. The reset pass
// reduces the gates' GroupNorm partials itself (every block the same sums
// in the same order, in double; block 0 keeps the r/u statistics for the
// update pass), and the update pass reduces the candidates' partials. No
// float atomics anywhere (the K splits' tickets are integers, back at 0
// when a launch ends), and every sum runs in an order fixed by the shapes
// and the device's SM count, so a plane gives the same bits from run to
// run.

#include <cuda_runtime.h>

#include <cstdint>

#include "bf16.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMI = 2;            // m16 fragments (tile rows) per warp
constexpr int kNF = 2;            // n8 fragments per block
constexpr int kBN = 8 * kNF;      // output channels per block
constexpr int kTW = 16;           // tile width: one m16 fragment
constexpr int kCC = 8;            // channel planes per stage: 8 channels (one k8 step a
                                  // tap), or in bfloat16 8 pairs (16 channels, one k16)
constexpr int kStages = 3;
constexpr int kMaxRows = kMI * kWarps;  // tile rows when the warps do not split K
constexpr int kFrag = 128;        // floats of one packed (chunk, tap, n8) fragment
constexpr int kFragB = 64;        // words of one bfloat16 (chunk, tap, n8) fragment
// input channels a stage, words of one fragment and weight words per stage
__host__ __device__ constexpr int chans(bool b16) { return b16 ? 2 * kCC : kCC; }
__host__ __device__ constexpr int frag_words(bool b16) { return b16 ? kFragB : kFrag; }
__host__ __device__ constexpr int weight_words(bool b16) { return 9 * kNF * frag_words(b16); }
constexpr int kVals = kMI * kNF * 4;    // accumulators per thread
constexpr int kMaxProblems = 4;
constexpr int kPointThreads = 256;
constexpr int kBadShape = 10001;
constexpr int kBadParams = 10002;
constexpr float kEps = 1e-6f;
constexpr int kHidden[4] = {8, 16, 32, 64};

enum Geom { kSame = 0, kDown = 1, kUp = 2 };

// Input halo of a tile of R output rows x 16: rows and stored columns.
//   same: rows R + 2, columns x0-4 .. x0+19 (x0-1 .. x0+16 are read)
//   down: rows 2R + 1, columns 2x0-pad .. +32, stored even columns (17)
//         then odd (16), so a fragment's lanes read consecutive words
//   up:   rows R + 1, columns x0-4 .. x0+15 (a phase reads i and i-1)
// 'same' and 'up' rows start 16-byte aligned, so where the input's width
// is a multiple of 4 a row is copied in 16-byte pieces.
template <int G>
struct Halo {
  static constexpr int kCols = G == kSame ? kTW + 8 : G == kDown ? 2 * kTW + 1 : kTW + 4;
  static constexpr bool kVec = G != kDown;
  static constexpr int kPieces = kCols / 4;  // 16-byte pieces of a row (kVec)
  static constexpr int kMaxR = G == kSame ? kMaxRows + 2 : G == kDown ? 2 * kMaxRows + 1
                                                                      : kMaxRows + 1;
  // channel planes padded to 8 mod 32 words: the 4 channels of a fragment
  // load land 8 banks apart
  static constexpr int kPlane = ((kMaxR * kCols - 8 + 31) / 32) * 32 + 8;
  static constexpr int kIn = kCC * kPlane;
};

template <int G, bool B16>
__host__ __device__ constexpr int stage_floats(int sum) {
  return weight_words(B16) + Halo<G>::kIn * (sum ? 2 : 1);
}

// Tensors are float32, or bfloat16 in the bfloat16 instances (their
// pointers then carry bfloat16 bits; the weights are packed words).
struct Problem {
  const float* a;     // [CA, Hi, Wi]
  const float* b;     // concat: [CB, Hi, Wi] after a; sum: [CA, Hi, Wi] added to a
  const float* w;     // packed fragments (ops/cf_conv.py:pack_weight)
  const float* bias;  // [CO]
  float* out;         // [CO, Ho, Wo]
  float* partial;     // per tile (sum, sum of squares) x 2 GN parts, or null
  int CA, CB, CI, CO, Hi, Wi, Ho, Wo, pad_y, pad_x;
  int sum_b, relu;
  int vec;            // rows in 16-byte pieces (not 'down'; width % 4 == 0, aligned)
  int part;           // output channels per GroupNorm part (with partial)
  int ks, rows;       // warps splitting K; output rows per tile
  int S, cps;         // blocks splitting K (a tile's splits), chunks per split
  int tiles_x, tiles_y, ntiles, phases, tiles, nblocks, first_block;
  float* spart;       // S > 1: each block's sums, [nblocks][kThreads][kVals]
  int* ticket;        // S > 1: per tile, splits done (0 between launches)
};

struct Problems {
  Problem p[kMaxProblems];
  int n;
  int sum;            // any problem sums a second input: a second halo per stage
};

// K5. Block -> (problem, K split, n tile, phase, tile row, tile column),
// the K splits of a tile side by side, then its n tiles, so that blocks
// reading one halo run together.
template <int G, bool B16>
__global__ void __launch_bounds__(kThreads) conv_mma_kernel(const __grid_constant__ Problems P) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps][4];
  using HL = Halo<G>;
  constexpr int kCols = HL::kCols, kPlane = HL::kPlane;
  constexpr int kFW = frag_words(B16), kWF = weight_words(B16), kCh = chans(B16);

  int pi = 0;
#pragma unroll
  for (int i = 1; i < kMaxProblems; ++i)
    if (i < P.n && (int)blockIdx.x >= P.p[i].first_block) pi = i;
  const Problem& p = P.p[pi];
  const int lb = blockIdx.x - p.first_block;
  const int sk = lb % p.S, tile = lb / p.S;  // a tile's K splits side by side
  const int nt = tile % p.ntiles;
  int rest = tile / p.ntiles;
  const int ph = rest % p.phases;
  rest /= p.phases;
  const int tx = rest % p.tiles_x, ty = rest / p.tiles_x;
  const int py = ph >> 1, px = ph & 1;      // 'up': the output parity
  const int y0 = ty * p.rows, x0 = tx * kTW;  // 'up': in the phase's sub-image
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int kg = warp & (p.ks - 1), wm = warp / p.ks;  // ks is 1, 2 or 4
  const int nfr = (p.CO + 7) >> 3;          // n8 fragments of the packed layer
  const int nf_act = min(kNF, nfr - nt * kNF);
  const int n0 = nt * kBN;

  int iy0, ix0, hrows;
  if (G == kSame) {
    iy0 = y0 - 1; ix0 = x0 - 4; hrows = p.rows + 2;
  } else if (G == kDown) {
    iy0 = 2 * y0 - p.pad_y; ix0 = 2 * x0 - p.pad_x; hrows = 2 * p.rows + 1;
  } else {
    iy0 = y0 - 1; ix0 = x0 - 4; hrows = p.rows + 1;
  }
  const int sfl = stage_floats<G, B16>(P.sum);
  const long long HWi = (long long)p.Hi * p.Wi;
  const int nchunks = (p.CI + kCh - 1) / kCh;
  const int c0 = sk * p.cps, c1 = min(nchunks, c0 + p.cps);  // this split's chunks

  // Each thread's copies, the same in every channel and chunk, worked out
  // once: halo slots (shared-memory position or -1 past the halo; offset
  // in the input plane or -1 outside the image) and weight pieces (offset
  // in the chunk's fragments or -1 for a fragment past the layer).
  constexpr int kSlots = (HL::kMaxR * kCols + kThreads - 1) / kThreads;
  constexpr int kFP = kFW / 4;            // 16-byte pieces of a fragment
  constexpr int kWPieces = 9 * kNF * kFP;  // 16-byte pieces of a stage's weights
  constexpr int kWSlots = (kWPieces + kThreads - 1) / kThreads;
  constexpr int kVSlots = HL::kVec ? (HL::kMaxR * HL::kPieces + kThreads - 1) / kThreads : 1;
  const bool vec = HL::kVec && !B16 && p.vec;
  int spos[kSlots], goff[kSlots], woff[kWSlots], vpos[kVSlots], voff[kVSlots], vbytes[kVSlots];
#pragma unroll
  for (int k = 0; k < kVSlots; ++k) {  // 16-byte pieces: ix is a multiple of 4
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / HL::kPieces, q = idx - r * HL::kPieces;
    const int iy = iy0 + r, ix = ix0 + 4 * q;
    const int n = iy < 0 || iy >= p.Hi || ix < 0 ? 0 : max(0, min(4, p.Wi - ix));
    vpos[k] = idx < hrows * HL::kPieces ? r * kCols + 4 * q : -1;
    voff[k] = n > 0 ? iy * p.Wi + ix : 0;
    vbytes[k] = 4 * n;
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int idx = threadIdx.x + k * kThreads;
    const int r = idx / kCols, xc = idx - r * kCols;
    const int iy = iy0 + r, ix = ix0 + xc;
    const int col = G == kDown ? ((xc & 1) ? 17 + (xc >> 1) : (xc >> 1)) : xc;
    spos[k] = idx < hrows * kCols ? r * kCols + col : -1;
    goff[k] = iy >= 0 && iy < p.Hi && ix >= 0 && ix < p.Wi ? iy * p.Wi + ix : -1;
  }
#pragma unroll
  for (int k = 0; k < kWSlots; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int nf = (e / kFP) % kNF, tap = (e / kFP) / kNF;
    woff[k] = e < kWPieces && nf < nf_act ? (tap * nfr + nf) * kFW + (e % kFP) * 4 : -1;
  }

  auto load = [&](int chunk, int s) {
    float* st = smem + s * sfl;
    const float* wsrc = p.w + ((long long)chunk * 9 * nfr + nt * kNF) * kFW;
#pragma unroll
    for (int k = 0; k < kWSlots; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < kWPieces) cp_async16(st + e * 4, woff[k] >= 0 ? wsrc + woff[k] : p.w, woff[k] >= 0 ? 16 : 0);
    }
    float* in = st + kWF;
    if constexpr (B16) {
      // plane c holds channels (2c, 2c+1) of the chunk's 16, a pair a word
      const bf16_t* pa = reinterpret_cast<const bf16_t*>(p.a);
      const bf16_t* pb = reinterpret_cast<const bf16_t*>(p.b);
      uint32_t* iu = reinterpret_cast<uint32_t*>(in);
      auto chan = [&](int ci) -> const bf16_t* {  // a channel's plane, null past the layer
        return ci >= p.CI ? nullptr : ci < p.CA ? pa + ci * HWi : pb + (ci - p.CA) * HWi;
      };
      auto chan2 = [&](int ci) -> const bf16_t* {  // the summed input's channel
        return p.sum_b && ci < p.CI ? pb + ci * HWi : nullptr;
      };
#pragma unroll 1
      for (int c = 0; c < kCC; ++c) {
        const int ci = chunk * kCh + 2 * c;
        const bf16_t *s0 = chan(ci), *s1 = chan(ci + 1);
        const bf16_t *t0 = chan2(ci), *t1 = chan2(ci + 1);
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          if (spos[k] < 0) continue;
          const int o = goff[k];
          const uint32_t lo = s0 && o >= 0 ? __ldg(s0 + o) : 0u;
          const uint32_t hi = s1 && o >= 0 ? __ldg(s1 + o) : 0u;
          iu[c * kPlane + spos[k]] = lo | (hi << 16);
          if (P.sum) {
            const uint32_t lo2 = t0 && o >= 0 ? __ldg(t0 + o) : 0u;
            const uint32_t hi2 = t1 && o >= 0 ? __ldg(t1 + o) : 0u;
            iu[HL::kIn + c * kPlane + spos[k]] = lo2 | (hi2 << 16);
          }
        }
      }
      return;
    }
#pragma unroll 2
    for (int c = 0; c < kCC; ++c) {
      const int ci = chunk * kCC + c;
      const bool live = ci < p.CI;
      const float* src = !live ? p.a : ci < p.CA ? p.a + ci * HWi : p.b + (ci - p.CA) * HWi;
      const bool live2 = live && p.sum_b;
      const float* src2 = live2 ? p.b + ci * HWi : p.a;
      if (vec) {
#pragma unroll
        for (int k = 0; k < kVSlots; ++k) {
          if (vpos[k] < 0) continue;
          cp_async16(in + c * kPlane + vpos[k], src + voff[k], live ? vbytes[k] : 0);
          if (P.sum)
            cp_async16(in + HL::kIn + c * kPlane + vpos[k], src2 + voff[k], live2 ? vbytes[k] : 0);
        }
        continue;
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (spos[k] < 0) continue;
        const bool ok = live && goff[k] >= 0;
        cp_async4(in + c * kPlane + spos[k], ok ? src + goff[k] : p.a, ok);
        if (P.sum) {
          const bool ok2 = live2 && goff[k] >= 0;
          cp_async4(in + HL::kIn + c * kPlane + spos[k], ok2 ? src2 + goff[k] : p.a, ok2);
        }
      }
    }
  };

  float acc[kMI][kNF][4], acl[kMI][kNF][4];
#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][nf][j] = acl[mi][nf][j] = 0.f;

  // the lane's A element (channel tq, pixel g) of the warp's first row
  const int abase = tq * kPlane + wm * kMI * (G == kDown ? 2 : 1) * kCols + g;
  const int ksm = p.ks - 1;
  const bool sum2 = P.sum;

#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (c0 + s < c1) load(c0 + s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int c = c0; c < c1; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c arrived; everyone is done with chunk c - 1
    {
      const int nc = c + kStages - 1;
      if (nc < c1) load(nc, (nc - c0) % kStages);
      cp_async_commit();
    }
    const float* st = smem + ((c - c0) % kStages) * sfl;
    const float* in = st + kWF + abase;
    // taps: 9 ('same', 'down'; halo offsets known at compile time), or
    // the phase's 1, 2, 2 or 4 of (jy, jx) in {0,1}^2 ('up'); the k-th
    // tap a block reads goes to the warps with kg = k mod ks
    constexpr int kJ = G == kUp ? 4 : 9;
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      int tap, ord, roff, coff;
      bool on = true;
      if (G == kUp) {
        const int jy = j >> 1, jx = j & 1;
        on = (!py || !jy) && (!px || !jx);
        ord = jy * (px ? 1 : 2) + jx;
        tap = (py ? 1 : 2 * jy) * 3 + (px ? 1 : 2 * jx);
        roff = jy ? 0 : 1;  // ky = 2 reads input row Y - 1, the halo's row rl
        coff = jx ? 3 : 4;  // kx = 2 reads input column X - 1
      } else {
        const int ky = j / 3, kx = j % 3;
        ord = tap = j;
        roff = ky;
        coff = G == kSame ? kx + 3 : (kx & 1) ? 17 : (kx >> 1);
      }
      if (!on || (ord & ksm) != kg) continue;
      if constexpr (B16) {
        // A: pair planes tq and tq + 4 at pixels g and g + 8 (channels 2tq,
        // 2tq+1 and 2tq+8, 2tq+9 of the chunk); B: one 8-byte load a lane
        const uint32_t* iu = reinterpret_cast<const uint32_t*>(in);
        uint2 bw[kNF];
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf)
          if (nf < nf_act)
            bw[nf] = *reinterpret_cast<const uint2*>(st + ((tap * kNF + nf) * 32 + lane) * 2);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi) {
          const int o = ((G == kDown ? 2 * mi : mi) + roff) * kCols + coff;
          uint32_t x[4] = {iu[o], iu[o + 8], iu[o + 4 * kPlane], iu[o + 4 * kPlane + 8]};
          if (sum2) {
            const uint32_t* i2 = iu + HL::kIn;
            x[0] = add_bf16x2(x[0], i2[o]);
            x[1] = add_bf16x2(x[1], i2[o + 8]);
            x[2] = add_bf16x2(x[2], i2[o + 4 * kPlane]);
            x[3] = add_bf16x2(x[3], i2[o + 4 * kPlane + 8]);
          }
#pragma unroll
          for (int nf = 0; nf < kNF; ++nf)
            if (nf < nf_act) mma_bf16(acc[mi][nf], x, bw[nf].x, bw[nf].y);
        }
        continue;
      }
      float4 bw[kNF];
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf)
        if (nf < nf_act)
          bw[nf] = *reinterpret_cast<const float4*>(st + ((tap * kNF + nf) * 32 + lane) * 4);
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        // halo row of output row mi (pixel g + 8 is 8 words on in every mode)
        const int o = ((G == kDown ? 2 * mi : mi) + roff) * kCols + coff;
        float x[4] = {in[o], in[o + 8], in[o + 4 * kPlane], in[o + 4 * kPlane + 8]};
        if (sum2) {
          const float* in2 = in + HL::kIn;
          x[0] += in2[o]; x[1] += in2[o + 8];
          x[2] += in2[o + 4 * kPlane]; x[3] += in2[o + 4 * kPlane + 8];
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(x[q], ah[q], al[q]);
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf) {
          if (nf < nf_act) {
            const uint32_t bh0 = __float_as_uint(bw[nf].x), bh1 = __float_as_uint(bw[nf].y);
            const uint32_t bl0 = __float_as_uint(bw[nf].z), bl1 = __float_as_uint(bw[nf].w);
            mma_tf32(acl[mi][nf], al, bh0, bh1);
            mma_tf32(acl[mi][nf], ah, bl0, bl1);
            mma_tf32(acc[mi][nf], ah, bh0, bh1);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the split-K partial sums next

#pragma unroll
  for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][nf][j] += acl[mi][nf][j];
  if (p.ks > 1) {  // uniform over the block
    if (kg > 0) {
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            smem[(warp * kVals + (mi * kNF + nf) * 4 + j) * 32 + lane] = acc[mi][nf][j];
    }
    __syncthreads();
    if (kg == 0) {
      for (int k = 1; k < p.ks; ++k) {  // the split's warps in a fixed order
        const int wsrc = warp + k;
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[mi][nf][j] += smem[(wsrc * kVals + (mi * kNF + nf) * 4 + j) * 32 + lane];
      }
    }
  }
  if (p.S > 1) {  // uniform over the block
    // every split leaves its sums; the last to finish adds all S of them
    // in split order (its own from registers: the same bits) and goes on
    // to the epilogue, so the order does not depend on who came last
    __shared__ int last;
    float4* mine = reinterpret_cast<float4*>(p.spart + ((long long)lb * kThreads + threadIdx.x) * kVals);
    if (kg == 0) {
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf)
          mine[mi * kNF + nf] = make_float4(acc[mi][nf][0], acc[mi][nf][1], acc[mi][nf][2],
                                            acc[mi][nf][3]);
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(p.ticket + tile, 1) == p.S - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (kg == 0) {
      float sum[kMI][kNF][4];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
          for (int j = 0; j < 4; ++j) sum[mi][nf][j] = 0.f;
      for (int s = 0; s < p.S; ++s) {
        const float4* other = reinterpret_cast<const float4*>(
            p.spart + (((long long)tile * p.S + s) * kThreads + threadIdx.x) * kVals);
#pragma unroll
        for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
          for (int nf = 0; nf < kNF; ++nf) {
            float4 v;
            if (s == sk) v = make_float4(acc[mi][nf][0], acc[mi][nf][1], acc[mi][nf][2], acc[mi][nf][3]);
            else v = __ldcg(other + mi * kNF + nf);
            sum[mi][nf][0] += v.x; sum[mi][nf][1] += v.y;
            sum[mi][nf][2] += v.z; sum[mi][nf][3] += v.w;
          }
      }
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mi][nf][j] = sum[mi][nf][j];
    }
    if (threadIdx.x == 0) p.ticket[tile] = 0;  // ready for the next launch
  }

  // epilogue: C fragment element j is pixel g (j < 2) or g + 8, channel
  // 2 tq + (j & 1) of its n8 fragment
  const long long HWo = (long long)p.Ho * p.Wo;
  const int Hs = G == kUp ? p.Hi : p.Ho, Ws = G == kUp ? p.Wi : p.Wo;
  const int part0 = p.partial != nullptr ? n0 / p.part : 0;
  float st0 = 0.f, sq0 = 0.f, st1 = 0.f, sq1 = 0.f;
  if (kg == 0) {
#pragma unroll
    for (int mi = 0; mi < kMI; ++mi) {
      const int Y = y0 + wm * kMI + mi;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int X = x0 + g + 8 * half;
        if (Y >= Hs || X >= Ws) continue;
        const int oy = G == kUp ? 2 * Y + py : Y, ox = G == kUp ? 2 * X + px : X;
        const long long pix = (long long)oy * p.Wo + ox;
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int co = n0 + nf * 8 + 2 * tq + jj;
            if (co >= p.CO) continue;
            float v = acc[mi][nf][half * 2 + jj] + __ldg(p.bias + co);
            if (p.relu) v = fmaxf(v, 0.f);
            if constexpr (B16) reinterpret_cast<bf16_t*>(p.out)[co * HWo + pix] = f2bf(v);
            else p.out[co * HWo + pix] = v;
            if (p.partial != nullptr) {
              if (co / p.part == part0) {
                st0 += v; sq0 += v * v;
              } else {
                st1 += v; sq1 += v * v;
              }
            }
          }
        }
      }
    }
  }
  if (p.partial == nullptr) return;  // uniform over the block
  float vals[4] = {st0, sq0, st1, sq1};
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
    for (int w = 0; w < kWarps; ++w) s += red[w][threadIdx.x];
    p.partial[(long long)tile * 4 + threadIdx.x] = s;
  }
}

// Dynamic shared memory above 48 KB needs the attribute, set once per
// device and kernel to the most the kernel can ask for.
template <int G, bool B16>
cudaError_t allow_smem() {
  static bool done[64] = {false};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(conv_mma_kernel<G, B16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kStages * stage_floats<G, B16>(1) * (int)sizeof(float));
  if (e == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return e;
}

// Blocks of the conv template one SM holds at once (shared memory and
// registers), per instance (geometry, float32 or bfloat16) and second-halo
// flag, read once per device.
template <int G, bool B16>
int occupancy(int sum) {
  int got = 0;
  if (allow_smem<G, B16>() == cudaSuccess)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &got, conv_mma_kernel<G, B16>, kThreads,
        kStages * stage_floats<G, B16>(sum) * (int)sizeof(float));
  return got;
}

template <bool B16>
int resident(int geom, int sum) {
  static int cached[64][3][2] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  int& n = cached[dev][geom][sum];
  if (n == 0) {
    const int got = geom == kSame ? occupancy<kSame, B16>(sum)
                    : geom == kDown ? occupancy<kDown, B16>(sum) : occupancy<kUp, B16>(sum);
    n = got > 0 ? got : 1;
  }
  return n;
}

// The tiling of one conv. A tile is 8 rows x 16 pixels x 16 channels, so
// every block reads its weights for 128 pixels. Blocks split the input
// channels (S splits of cps chunks each) where that shortens the launch:
// S is chosen for the least waves x (cps + 2), the waves counted over the
// blocks the device holds at once and 2 standing for a block's fixed cost
// in chunks (staging the first chunk, the epilogue, the split's sum).
// Splitting over blocks keeps the tile, where splitting over a block's
// warps shrinks it and so multiplies the weight traffic; only where one
// split per chunk still leaves an SM without a block do the warps split K
// too (2, then 4 ways; tile rows 8 -> 4 -> 2). The scratch plan and the
// launches read the same device, so their layouts agree.
struct Tile {
  int ks, rows, S, cps, tiles_x, tiles_y, ntiles, phases, tiles, nblocks;
};

template <bool B16>
Tile tile_for(int geom, int sum, int CI, int CO, int Hs, int Ws) {
  Tile t;
  t.phases = geom == kUp ? 4 : 1;
  t.ntiles = (CO + kBN - 1) / kBN;
  t.tiles_x = (Ws + kTW - 1) / kTW;
  const int nchunks = (CI + chans(B16) - 1) / chans(B16);
  const long long sms = sm_count() > 0 ? sm_count() : 1;
  const long long cap = sms * resident<B16>(geom, sum);
  for (int ks = 1;; ks *= 2) {
    t.ks = ks;
    t.rows = kMaxRows / ks;
    t.tiles_y = (Hs + t.rows - 1) / t.rows;
    t.tiles = t.tiles_y * t.tiles_x * t.ntiles * t.phases;
    long long best = -1;
    for (int cps = nchunks; cps >= 1; --cps) {
      const int S = (nchunks + cps - 1) / cps;
      const long long waves = ((long long)t.tiles * S + cap - 1) / cap;
      const long long cost = waves * (cps + 2);
      if (best < 0 || cost < best) {
        best = cost;
        t.S = S;
        t.cps = cps;
      }
    }
    t.nblocks = t.tiles * t.S;
    if (ks == kWarps || (long long)t.tiles * nchunks >= sms) break;
  }
  return t;
}

// Scratch of a launch's K splits: floats of block sums, tickets
inline void split_need(const Tile& t, long long* floats, long long* tickets) {
  if (t.S > 1) {
    *floats += (long long)t.nblocks * kThreads * kVals;
    *tickets += t.tiles;
  }
}

// 'SAME' low-side padding (TensorFlow's rule) of a stride-2 3x3 conv over n
inline int same_pad_lo(int n) {
  const int out = (n + 1) / 2;
  const int total = (out - 1) * 2 + 3 - n;
  return total > 0 ? total / 2 : 0;
}

template <bool B16>
Problem problem(const float* a, int CA, const float* b, int CB, int sum_b,
                const float* w, const float* bias, int CO, int Hi, int Wi,
                int geom, float* out, int relu, float* partial = nullptr,
                int part = 0) {
  Problem p = {};
  p.a = a; p.b = b; p.w = w; p.bias = bias; p.out = out; p.partial = partial;
  p.CA = CA; p.CB = CB; p.CI = sum_b ? CA : CA + CB; p.CO = CO;
  p.sum_b = sum_b; p.relu = relu; p.part = part;
  p.Hi = Hi; p.Wi = Wi;
  p.Ho = geom == kUp ? 2 * Hi : geom == kDown ? (Hi + 1) / 2 : Hi;
  p.Wo = geom == kUp ? 2 * Wi : geom == kDown ? (Wi + 1) / 2 : Wi;
  p.pad_y = same_pad_lo(Hi); p.pad_x = same_pad_lo(Wi);
  p.vec = geom != kDown && Wi % 4 == 0 && (uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0;
  const Tile t = tile_for<B16>(geom, sum_b, p.CI, CO, geom == kUp ? Hi : p.Ho,
                              geom == kUp ? Wi : p.Wo);
  p.ks = t.ks; p.rows = t.rows; p.S = t.S; p.cps = t.cps;
  p.tiles_x = t.tiles_x; p.tiles_y = t.tiles_y; p.ntiles = t.ntiles;
  p.phases = t.phases; p.tiles = t.tiles; p.nblocks = t.nblocks;
  return p;
}

template <int G, bool B16>
cudaError_t launch_geom(const Problems& P, int nblocks, cudaStream_t s) {
  const cudaError_t e = allow_smem<G, B16>();
  if (e != cudaSuccess) return e;
  const int bytes = kStages * stage_floats<G, B16>(P.sum) * (int)sizeof(float);
  conv_mma_kernel<G, B16><<<nblocks, kThreads, bytes, s>>>(P);
  return cudaGetLastError();
}

// One launch of the conv template over up to kMaxProblems convs of one
// geometry, in the order given (put the deepest first: its blocks are the
// longest and start first). `split` and `tickets` hold the K splits'
// scratch (split_need of the launch's tilings; the tickets all 0).
template <bool B16>
cudaError_t convs(int geom, const Problem* ps, int n, float* split, int* tickets,
                  cudaStream_t s) {
  Problems P = {};
  P.n = n;
  int first = 0;
  for (int i = 0; i < n; ++i) {
    P.p[i] = ps[i];
    P.p[i].first_block = first;
    first += ps[i].nblocks;
    P.sum |= ps[i].sum_b;
    if (ps[i].S > 1) {
      P.p[i].spart = split;
      P.p[i].ticket = tickets;
      split += (long long)ps[i].nblocks * kThreads * kVals;
      tickets += ps[i].tiles;
    }
  }
  if (first == 0) return cudaSuccess;
  if (geom == kSame) return launch_geom<kSame, B16>(P, first, s);
  if (geom == kDown) return launch_geom<kDown, B16>(P, first, s);
  return launch_geom<kUp, B16>(P, first, s);
}

// ---------------------------------------------------------------------------
// the GRU's pointwise passes, each reducing the GroupNorm partials it needs
// ---------------------------------------------------------------------------

// (the tensors in bfloat16 in the bfloat16 instances, as Problem's)
struct GruLevel {
  const float* gp;  // gates pre-activation [2C, H, W] (r, then u)
  const float* h;   // state [C, H, W]
  const float* cp;  // candidate pre-activation [C, H, W]
  const float* gn;  // rn.w, rn.b, un.w, un.b, on.w, on.b, each [C]
  const float* pg;  // the gates conv's tile partials [nbg][4]
  const float* pc;  // the candidate conv's tile partials [nbc][4]
  float* out;       // r*h (reset pass) or h' (update pass)
  int C, HW, nbg, ntg, nbc, ntc;
};

struct GruLevels {
  GruLevel l[4];
  long long start[5];  // first flat element of each level; start[4] = total
  float* stats;        // per level (mean, inverse deviation) of r, u, o
};

__device__ __forceinline__ float sigmoidf_(float x) { return 1.f / (1.f + expf(-x)); }

// element i of a step tensor as float32, and a float32 stored into one
template <bool B16>
__device__ __forceinline__ float ld_el(const float* p, long long i) {
  if constexpr (B16) return bf2f(reinterpret_cast<const bf16_t*>(p)[i]);
  else return p[i];
}
template <bool B16>
__device__ __forceinline__ void st_el(float* p, long long i, float v) {
  if constexpr (B16) reinterpret_cast<bf16_t*>(p)[i] = f2bf(v);
  else p[i] = v;
}

__device__ __forceinline__ float gn_apply(float x, const float* st, float w, float b) {
  return (x - st[0]) * (st[1] * w) + b;
}

// The statistics of every level's GroupNorm parts of the gates (cand =
// false: r and u) or of the candidates (cand = true: o), into st[l][0..5]
// at (r, u, o). Each thread adds every blockDim-th tile partial in double,
// then the warps and the block in a fixed order: every block of a pass gets
// the same bits.
__device__ void reduce_stats(const GruLevels& L, bool cand, float (*st)[6]) {
  double v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = 0.0;
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const GruLevel& lv = L.l[l];
    const float* pp = cand ? lv.pc : lv.pg;
    const int nb = cand ? lv.nbc : lv.nbg, ntl = cand ? lv.ntc : lv.ntg;
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      const float* q = pp + (long long)b * 4;
      // a block's first channel is in part p0; slot 1 holds part p0 + 1
      if (((b % ntl) * kBN) / lv.C == 0) {
        v[4 * l] += q[0]; v[4 * l + 1] += q[1];
        v[4 * l + 2] += q[2]; v[4 * l + 3] += q[3];
      } else {
        v[4 * l + 2] += q[0]; v[4 * l + 3] += q[1];
      }
    }
  }
  __shared__ double rs[kPointThreads / 32][16];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    double x = v[i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) rs[warp][i] = x;
  }
  __syncthreads();
  if (threadIdx.x < 8) {  // (level, part): 4 x (first, second)
    const int l = threadIdx.x >> 1, k = threadIdx.x & 1;
    double s = 0.0, q = 0.0;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) {
      s += rs[w][4 * l + 2 * k];
      q += rs[w][4 * l + 2 * k + 1];
    }
    const double count = (double)L.l[l].C * L.l[l].HW;
    const double mean = s / count;
    const double var = fmax(q / count - mean * mean, 0.0);
    const int slot = cand ? 4 : 2 * k;
    if (!cand || k == 0) {
      st[l][slot] = (float)mean;
      st[l][slot + 1] = (float)(1.0 / sqrt(var + (double)kEps));
    }
  }
  __syncthreads();
}

// r*h with r = sigmoid(GN_r(g[:C])), all four levels in one launch; block 0
// keeps the r/u statistics for the update pass
template <bool B16>
__global__ void __launch_bounds__(kPointThreads) gru_reset_kernel(const __grid_constant__ GruLevels L) {
  __shared__ float stat[4][6];
  reduce_stats(L, false, stat);
  if (blockIdx.x == 0 && threadIdx.x < 16)
    L.stats[(threadIdx.x >> 2) * 6 + (threadIdx.x & 3)] = stat[threadIdx.x >> 2][threadIdx.x & 3];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < L.start[4];
       e += stride) {
    int l = 0;
    while (e >= L.start[l + 1]) ++l;
    const GruLevel& v = L.l[l];
    const int i = (int)(e - L.start[l]);  // a level holds < 2^31 elements
    const int c = i / v.HW;
    const float r = sigmoidf_(gn_apply(ld_el<B16>(v.gp, i), stat[l], v.gn[c], v.gn[v.C + c]));
    st_el<B16>(v.out, i, r * ld_el<B16>(v.h, i));
  }
}

// h' = u*h + (1-u)*tanh(GN_o(cp)) with u = sigmoid(GN_u(g[C:]))
template <bool B16>
__global__ void __launch_bounds__(kPointThreads) gru_update_kernel(const __grid_constant__ GruLevels L) {
  __shared__ float stat[4][6];
  reduce_stats(L, true, stat);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < L.start[4];
       e += stride) {
    int l = 0;
    while (e >= L.start[l + 1]) ++l;
    const GruLevel& v = L.l[l];
    const int i = (int)(e - L.start[l]);
    const int C = v.C;
    const int c = i / v.HW;
    const float u = sigmoidf_(gn_apply(ld_el<B16>(v.gp, (long long)C * v.HW + i),
                                       L.stats + 6 * l + 2, v.gn[2 * C + c], v.gn[3 * C + c]));
    const float o = tanhf(gn_apply(ld_el<B16>(v.cp, i), stat[l] + 4, v.gn[4 * C + c],
                                   v.gn[5 * C + c]));
    const float h = ld_el<B16>(v.h, i);
    st_el<B16>(v.out, i, u * h + (1.f - u) * o);
  }
}

// ---------------------------------------------------------------------------
// the step: packed parameters and scratch layout
// ---------------------------------------------------------------------------

constexpr int kLayers = 15;

inline int r8(int n) { return (n + 7) / 8 * 8; }

// Floats of one packed conv layer: (Ci/8 chunks) x 9 taps x (Co/8 n8
// fragments) x 32 lanes x (b0, b1) x (hi, lo), channels rounded up to 8;
// in bfloat16, (Ci/16 chunks) x 9 x (Co/8) x 32 lanes x 4 bfloat16.
inline long long frag_floats(int ci, int co, bool b16) {
  return b16 ? (long long)((ci + 15) / 16 * 16) * r8(co) * 9 / 2 : (long long)r8(ci) * r8(co) * 18;
}

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

// each layer: its fragments, then its bias padded to a multiple of 8 (so
// every layer's fragments start 32-byte aligned); then the GN vectors
long long param_floats(int Cin, bool b16, const float* base, const float* w[kLayers],
                       const float* bias[kLayers], const float** gn) {
  int ci[kLayers], co[kLayers];
  layer_shapes(Cin, ci, co);
  long long off = 0;
  for (int i = 0; i < kLayers; ++i) {
    if (w != nullptr) w[i] = base + off;
    off += frag_floats(ci[i], co[i], b16);
    if (bias != nullptr) bias[i] = base + off;
    off += r8(co[i]);
  }
  if (gn != nullptr) *gn = base + off;
  return off + 6 * (8 + 16 + 32 + 64);
}

struct Plan {
  int H[4], W[4];
  long long P[4];
  long long d[3], gp[4], rh[4], cp[4], u[3], pg[4], pc[4], stats, split, total;
  long long tickets;  // the K splits' tickets, in their own zeroed buffer
};

template <bool B16>
Plan plan(int Cin, int H, int W) {
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
  // the conv-template launches' tilings, in red_step4_f32's order: the K
  // splits' scratch serves one launch at a time, so it is their largest
  const int xc[4] = {Cin, 16, 32, 64};
  Tile down[3], gates[4], cands[4], dec[4];
  for (int l = 0; l < 3; ++l)
    down[l] = tile_for<B16>(kDown, 0, xc[l], 16 << l, q.H[l + 1], q.W[l + 1]);
  for (int l = 0; l < 4; ++l) {
    gates[l] = tile_for<B16>(kSame, 0, xc[l] + kHidden[l], 2 * kHidden[l], q.H[l], q.W[l]);
    cands[l] = tile_for<B16>(kSame, 0, xc[l] + kHidden[l], kHidden[l], q.H[l], q.W[l]);
  }
  dec[0] = tile_for<B16>(kUp, 0, 64, 32, q.H[3], q.W[3]);
  dec[1] = tile_for<B16>(kUp, 1, 32, 16, q.H[2], q.W[2]);
  dec[2] = tile_for<B16>(kUp, 1, 16, 8, q.H[1], q.W[1]);
  dec[3] = tile_for<B16>(kSame, 1, 8, 1, q.H[0], q.W[0]);
  long long split = 0;
  q.tickets = 0;
  auto need = [&](const Tile* ts, int n) {
    long long f = 0, t = 0;
    for (int i = 0; i < n; ++i) split_need(ts[i], &f, &t);
    split = f > split ? f : split;
    q.tickets = t > q.tickets ? t : q.tickets;
  };
  for (int l = 0; l < 3; ++l) need(down + l, 1);
  need(gates, 4);
  need(cands, 4);
  for (int i = 0; i < 4; ++i) need(dec + i, 1);

  for (int l = 0; l < 3; ++l) q.d[l] = take((16LL << l) * q.P[l + 1]);
  for (int l = 0; l < 4; ++l) {
    const int C = kHidden[l];
    q.gp[l] = take(2LL * C * q.P[l]);
    q.rh[l] = take((long long)C * q.P[l]);
    q.cp[l] = take((long long)C * q.P[l]);
    q.pg[l] = take(4LL * gates[l].tiles);
    q.pc[l] = take(4LL * cands[l].tiles);
  }
  for (int l = 0; l < 3; ++l) q.u[l] = take((long long)kHidden[l] * q.P[l]);  // u1, u2, u3
  q.stats = take(24);
  q.split = take(split);
  q.total = off;
  return q;
}

inline unsigned point_blocks(long long total) {
  const long long need = (total + kPointThreads - 1) / kPointThreads;
  const long long cap = 4LL * (sm_count() > 0 ? sm_count() : 132);
  return (unsigned)(need < cap ? need : cap);
}

#define RS4_CHECK(expr)                    \
  do {                                     \
    const cudaError_t e_ = (expr);         \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

}  // namespace

extern "C" const char* error_string(int code) {
  if (code == kBadShape) return "RedStep4 needs H and W that are multiples of 8";
  if (code == kBadParams) return "bad conv mode, channel count or weight alignment";
  return cudaGetErrorString((cudaError_t)code);
}

template <bool B16>
Tile conv_tile(int Ci, int Co, int H, int W, int mode) {
  const bool up = mode == kUp;
  return tile_for<B16>(mode, 0, Ci, Co, up ? H : mode == kDown ? (H + 1) / 2 : H,
                       up ? W : mode == kDown ? (W + 1) / 2 : W);
}

template <bool B16>
int conv3x3(const float* x, const float* w, const float* b, int Ci, int Co, int H, int W,
            int mode, int relu, float* out, float* scratch, int* tickets, void* stream) {
  if (mode < kSame || mode > kUp || Ci < 1 || Co < 1 || (uintptr_t)w % 16) return kBadParams;
  const Problem p = problem<B16>(x, Ci, nullptr, 0, 0, w, b, Co, H, W, mode, out, relu);
  return (int)convs<B16>(mode, &p, 1, scratch, tickets, (cudaStream_t)stream);
}

// One RedStep4 step of either type (see red_step4_f32).
template <bool B16>
int step(const float* cost, int Cin, const float* s1, const float* s2, const float* s3,
         const float* s4, const float* params, float* score, float* h1n, float* h2n,
         float* h3n, float* h4n, float* scratch, int* tickets, int H, int W,
         int* conv_launches, void* stream) {
  *conv_launches = 0;
  if (H % 8 || W % 8 || H <= 0 || W <= 0) return kBadShape;
  if (Cin < 1 || (uintptr_t)params % 16) return kBadParams;
  cudaStream_t s = (cudaStream_t)stream;
  const float* w[kLayers];
  const float* bias[kLayers];
  const float* gn;
  param_floats(Cin, B16, params, w, bias, &gn);
  const Plan q = plan<B16>(Cin, H, W);
  float* split = scratch + q.split;
  float* d[3] = {scratch + q.d[0], scratch + q.d[1], scratch + q.d[2]};
  const float* h[4] = {s1, s2, s3, s4};
  float* hn[4] = {h1n, h2n, h3n, h4n};
  int n = 0;

  // encoder: three stride-2 convs on -cost
  const float* x[4] = {cost, d[0], d[1], d[2]};
  const int xc[4] = {Cin, 16, 32, 64};
  for (int l = 0; l < 3; ++l) {
    const Problem p = problem<B16>(x[l], xc[l], nullptr, 0, 0, w[l], bias[l], 16 << l,
                                   q.H[l], q.W[l], kDown, d[l], 1);
    RS4_CHECK(convs<B16>(kDown, &p, 1, split, tickets, s));
    ++n;
  }
  // gates of every level in one launch, deepest first, with GN partials
  Problem gates[4], cands[4];
  for (int i = 0; i < 4; ++i) {
    const int l = 3 - i, C = kHidden[l];
    gates[i] = problem<B16>(x[l], xc[l], h[l], C, 0, w[3 + 2 * l], bias[3 + 2 * l], 2 * C,
                            q.H[l], q.W[l], kSame, scratch + q.gp[l], 0, scratch + q.pg[l], C);
  }
  RS4_CHECK(convs<B16>(kSame, gates, 4, split, tickets, s));
  ++n;

  GruLevels L;
  long long total = 0;
  for (int l = 0; l < 4; ++l) {
    const int C = kHidden[l];
    const Problem& gl = gates[3 - l];
    L.l[l] = {scratch + q.gp[l], h[l], scratch + q.cp[l], gn, scratch + q.pg[l],
              scratch + q.pc[l], scratch + q.rh[l], C, (int)q.P[l], gl.tiles,
              gl.ntiles, 0, 1};
    gn += 6 * C;
    L.start[l] = total;
    total += (long long)C * q.P[l];
  }
  L.start[4] = total;
  L.stats = scratch + q.stats;
  const unsigned pblocks = point_blocks(total);
  gru_reset_kernel<B16><<<pblocks, kPointThreads, 0, s>>>(L);
  RS4_CHECK(cudaGetLastError());

  // candidates of every level on [x, r*h], one launch, with GN partials
  for (int i = 0; i < 4; ++i) {
    const int l = 3 - i, C = kHidden[l];
    cands[i] = problem<B16>(x[l], xc[l], scratch + q.rh[l], C, 0, w[4 + 2 * l],
                            bias[4 + 2 * l], C, q.H[l], q.W[l], kSame, scratch + q.cp[l], 0,
                            scratch + q.pc[l], C);
  }
  RS4_CHECK(convs<B16>(kSame, cands, 4, split, tickets, s));
  ++n;

  for (int l = 0; l < 4; ++l) {
    L.l[l].out = hn[l];
    L.l[l].nbc = cands[3 - l].tiles;
    L.l[l].ntc = cands[3 - l].ntiles;
  }
  gru_update_kernel<B16><<<pblocks, kPointThreads, 0, s>>>(L);
  RS4_CHECK(cudaGetLastError());

  // decoder: each transposed conv reads its skip sum on load
  float* u1 = scratch + q.u[0];
  float* u2 = scratch + q.u[1];
  float* u3 = scratch + q.u[2];
  const Problem dec[4] = {
      problem<B16>(hn[3], 64, nullptr, 0, 0, w[11], bias[11], 32, q.H[3], q.W[3], kUp, u3, 1),
      problem<B16>(u3, 32, hn[2], 32, 1, w[12], bias[12], 16, q.H[2], q.W[2], kUp, u2, 1),
      problem<B16>(u2, 16, hn[1], 16, 1, w[13], bias[13], 8, q.H[1], q.W[1], kUp, u1, 1),
      problem<B16>(u1, 8, hn[0], 8, 1, w[14], bias[14], 1, q.H[0], q.W[0], kSame, score, 0)};
  for (int i = 0; i < 4; ++i) {
    RS4_CHECK(convs<B16>(i < 3 ? kUp : kSame, dec + i, 1, split, tickets, s));
    ++n;
  }
  *conv_launches = n;
  return 0;
}

// K5 on its own. x [Ci,H,W], w packed fragments (ops/cf_conv.py:pack_weight,
// 16-byte aligned), b [Co]; mode 0 'same' -> out [Co,H,W], 1 'down' ->
// [Co,ceil(H/2),ceil(W/2)], 2 'up' -> [Co,2H,2W]. scratch and tickets (all
// 0, and left so) as cf_conv3x3_scratch_floats and cf_conv3x3_tickets say.
extern "C" int cf_conv3x3_f32(const float* x, const float* w, const float* b,
                              int Ci, int Co, int H, int W, int mode, int relu,
                              float* out, float* scratch, int* tickets, void* stream) {
  return conv3x3<false>(x, w, b, Ci, Co, H, W, mode, relu, out, scratch, tickets, stream);
}

// The bfloat16 mode: x and out in bfloat16, w the bfloat16 fragments
// (ops/cf_conv.py:pack_frags_bf16), b float32.
extern "C" int cf_conv3x3_bf16(const void* x, const float* w, const float* b,
                               int Ci, int Co, int H, int W, int mode, int relu,
                               void* out, float* scratch, int* tickets, void* stream) {
  return conv3x3<true>(static_cast<const float*>(x), w, b, Ci, Co, H, W, mode, relu,
                       static_cast<float*>(out), scratch, tickets, stream);
}

extern "C" long long cf_conv3x3_scratch_floats(int Ci, int Co, int H, int W, int mode,
                                               int bf16) {
  long long f = 0, t = 0;
  split_need(bf16 ? conv_tile<true>(Ci, Co, H, W, mode) : conv_tile<false>(Ci, Co, H, W, mode),
             &f, &t);
  return f;
}

extern "C" long long cf_conv3x3_tickets(int Ci, int Co, int H, int W, int mode, int bf16) {
  long long f = 0, t = 0;
  split_need(bf16 ? conv_tile<true>(Ci, Co, H, W, mode) : conv_tile<false>(Ci, Co, H, W, mode),
             &f, &t);
  return t;
}

// Floats of the packed parameter buffer red_step4_f32 (bf16 = 0) or
// red_step4_bf16 (bf16 = 1) reads.
extern "C" long long red_step4_param_floats(int Cin, int bf16) {
  return param_floats(Cin, bf16 != 0, nullptr, nullptr, nullptr, nullptr);
}

// Floats of the scratch buffer a step needs at Cin x H x W (bfloat16
// buffers take the same slots).
extern "C" long long red_step4_scratch_floats(int Cin, int H, int W, int bf16) {
  return bf16 ? plan<true>(Cin, H, W).total : plan<false>(Cin, H, W).total;
}

// Tickets (ints, all 0, and left so) a step needs at Cin x H x W.
extern "C" long long red_step4_tickets(int Cin, int H, int W, int bf16) {
  return bf16 ? plan<true>(Cin, H, W).tickets : plan<false>(Cin, H, W).tickets;
}

// One RedStep4 step. cost [Cin,H,W], states h1 [8,H,W] .. h4 [64,H/8,W/8];
// params packed as red_step4_param_floats describes (ops/red_step4.py:
// pack_params: each layer's fragments then its padded bias, the cost's
// negation folded in; then the GN vectors per level), 16-byte aligned.
// Writes score [H,W] and the new states; the inputs are not modified.
// *conv_launches receives the launches of the conv template (9 of the
// step's 11).
extern "C" int red_step4_f32(const float* cost, int Cin, const float* s1,
                             const float* s2, const float* s3, const float* s4,
                             const float* params, float* score, float* h1n,
                             float* h2n, float* h3n, float* h4n, float* scratch,
                             int* tickets, int H, int W, int* conv_launches,
                             void* stream) {
  return step<false>(cost, Cin, s1, s2, s3, s4, params, score, h1n, h2n, h3n, h4n, scratch,
                     tickets, H, W, conv_launches, stream);
}

// The bfloat16 mode: cost, states and score in bfloat16, params packed with
// bfloat16 fragments (pack_params(..., torch.bfloat16)).
extern "C" int red_step4_bf16(const void* cost, int Cin, const void* s1, const void* s2,
                              const void* s3, const void* s4, const float* params,
                              void* score, void* h1n, void* h2n, void* h3n, void* h4n,
                              float* scratch, int* tickets, int H, int W,
                              int* conv_launches, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto g = [](void* p) { return static_cast<float*>(p); };
  return step<true>(f(cost), Cin, f(s1), f(s2), f(s3), f(s4), params, g(score), g(h1n),
                    g(h2n), g(h3n), g(h4n), scratch, tickets, H, W, conv_launches, stream);
}
