// One output tile of ConvTranspose2d(k=4, s=2, p=1) + per-channel affine +
// activation, shared by the three generator kernels (cuda_convt.cu,
// cuda_gen.cu, cuda_gen2.cu).
//
// Math (phase decomposition, as in tpugan/ops/pallas_convt.py): the stride-2
// output splits into 4 parity phases (di, dj); phase (di, dj) at coarse
// position (i, j) is
//
//   out[2i+di, 2j+dj, :] = sum over 2x2 taps t of x[i+oh_t, j+ow_t, :] @ W[kh_t, kw_t]
//
// with (k, o) from TAPS[d] = {0: [(1,0), (3,-1)], 1: [(0,1), (2,0)]}.  One
// phase is an implicit GEMM: rows m = coarse positions (image, i, j), columns
// = output channels, depth = 4 taps x Cin.  A tap that falls outside the
// input is a zero row of A (a bounds test, not a padded copy).
//
// A tile is BM x BN, computed by 4 warps with bf16 WMMA (16x16x16, fp32
// accumulate).  Per tile the block first writes a row table to shared memory:
// for each row, the element offset of its input pixel for each of the 4 taps
// (-1 when outside) and the offset of its output pixel.  The depth loop then
// stages A (BM x 32) and B (32 x BN) through shared memory; the epilogue
// writes the fp32 accumulators to shared memory (aliasing A/B), applies
// y*a[c] + b[c] and the activation, and stores to the output layout.
//
// Activations are addressed through `Layout`, so the same tile serves the
// full-resolution NHWC layout (per-layer kernel, megakernel v1) and the
// phase-separated layout of megakernel v2.
#pragma once

#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace tg {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // 4 warps per block
constexpr int kBK = 32;        // depth (input channels) staged per step

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kTanh = 3 };

__device__ __forceinline__ float apply_act(float y, int act, float leak) {
  switch (act) {
    case kRelu: return y > 0.f ? y : 0.f;
    case kLeaky: return y > 0.f ? y : y * leak;
    case kTanh: return tanhf(y);
    default: return y;
  }
}

// An activation tensor of `nimg` images, full resolution hs x ws, c channels.
// kind 0: NHWC (img, h, w, c).  kind 1: phase-separated (P, P, img, bh, bw, c)
// with h = bh * P + oh; the base grid is hs / P.
struct Layout {
  int kind;
  int nimg, hs, ws, c, p;
  __device__ __forceinline__ long long offset(int img, int h, int w) const {
    if (kind == 0) return ((long long)(img * hs + h) * ws + w) * c;
    const int bh = h / p, oh = h - bh * p, bw = w / p, ow = w - bw * p;
    const int base_h = hs / p, base_w = ws / p;
    return ((((long long)(oh * p + ow) * nimg + img) * base_h + bh) * base_w
            + bw) * c;
  }
};

__device__ __forceinline__ void tap(int d, int t, int& k, int& o) {
  // TAPS[d][t]
  if (d == 0) { k = t ? 3 : 1; o = t ? -1 : 0; }
  else { k = t ? 2 : 0; o = t ? 0 : 1; }
}

__device__ __forceinline__ void store_val(bf16* p, float v, bool) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_val(float* p, float v, bool round_bf16) {
  *p = round_bf16 ? __bfloat162float(__float2bfloat16(v)) : v;
}

using AccFrag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// One kBK-deep step of a tile: warp (wm, wn) multiplies its FM x FN 16x16
// fragments of the staged A (row-major, stride LDA) and B (kBK rows, stride
// LDB) into acc.  Shared by the ConvT tile below and conv_tile.cuh.
template <int FM, int FN, int LDA, int LDB>
__device__ __forceinline__ void mma_step(AccFrag (&acc)[FM][FN], const bf16* As,
                                         const bf16* Bs, int wm, int wn) {
  using namespace nvcuda;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
      wmma::load_matrix_sync(fa[fm], As + (wm * FM + fm) * 16 * LDA + kk, LDA);
#pragma unroll
    for (int fn = 0; fn < FN; ++fn)
      wmma::load_matrix_sync(fb[fn], Bs + kk * LDB + (wn * FN + fn) * 16, LDB);
#pragma unroll
    for (int fm = 0; fm < FM; ++fm)
#pragma unroll
      for (int fn = 0; fn < FN; ++fn)
        wmma::mma_sync(acc[fm][fn], fa[fm], fb[fn], acc[fm][fn]);
  }
}

// Zero a warp's accumulators.
template <int FM, int FN>
__device__ __forceinline__ void zero_acc(AccFrag (&acc)[FM][FN]) {
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) nvcuda::wmma::fill_fragment(acc[fm][fn], 0.f);
}

// Store warp (wm, wn)'s fp32 sums into the tile Cs (row-major, stride LDC).
template <int FM, int FN, int LDC>
__device__ __forceinline__ void store_acc(float* Cs, const AccFrag (&acc)[FM][FN],
                                          int wm, int wn) {
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn)
      nvcuda::wmma::store_matrix_sync(
          Cs + (wm * FM + fm) * 16 * LDC + (wn * FN + fn) * 16, acc[fm][fn], LDC,
          nvcuda::wmma::mem_row_major);
}

// Shared memory one tile needs, for the largest configuration below.
constexpr int kSmemBytes = 32768;

// One layer of the generator as the tile routine sees it.
struct ConvT {
  const bf16* x;        // input activation (layout `in`), bf16
  const bf16* w;        // (4, 4, cin, cout) bf16, HWIO, unflipped
  const float* a;       // (cout,) scale
  const float* b;       // (cout,) shift
  int cin, cout;
  int h, w_;            // input spatial size (coarse grid of the output)
  int act;
  float leak;
  bool round_bf16;      // float output rounded through bf16 first
};

// Compute tile (m0, n0) of phase (di, dj).  Rows are coarse positions of
// images [0, nimg): m = (img * h + i) * w_ + j.  Input image `img` is image
// in_img0 + img of layout `in`; its output is image out_img0 + img of `out`.
// Must be called by all kThreads threads of the block.
template <int WM, int WN, int FM, int FN, typename OutT>
__device__ void convt_tile(const ConvT& L, int di, int dj, int m0, int n0,
                           int nimg, Layout in, int in_img0, Layout out,
                           int out_img0, OutT* y, unsigned char* smem) {
  constexpr int BM = WM * FM * 16;
  constexpr int BN = WN * FN * 16;
  constexpr int LDA = kBK + 8;   // bf16 elements; multiple of 8
  constexpr int LDB = BN + 8;
  constexpr int LDC = BN + 4;    // float elements; multiple of 4
  static_assert(WM * WN == kThreads / 32, "4 warps per tile");
  static_assert(BM * 5 * 8 + (BM * LDA + kBK * LDB) * 2 <= kSmemBytes, "smem");
  static_assert(BM * 5 * 8 + BM * LDC * 4 <= kSmemBytes, "smem");

  long long* rows = reinterpret_cast<long long*>(smem);  // [5][BM]
  unsigned char* tiles = smem + BM * 5 * 8;               // 128-byte aligned
  bf16* As = reinterpret_cast<bf16*>(tiles);
  bf16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(tiles);            // aliases As/Bs

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int hw = L.h * L.w_;
  const int M = nimg * hw;

  for (int r = tid; r < BM; r += kThreads) {
    const int m = m0 + r;
    if (m < M) {
      const int img = m / hw, rem = m - img * hw;
      const int i = rem / L.w_, j = rem - i * L.w_;
      for (int t = 0; t < 4; ++t) {
        int kh, oh, kw, ow;
        tap(di, t >> 1, kh, oh);
        tap(dj, t & 1, kw, ow);
        const int ih = i + oh, iw = j + ow;
        rows[t * BM + r] = (ih >= 0 && ih < L.h && iw >= 0 && iw < L.w_)
                               ? in.offset(in_img0 + img, ih, iw) : -1;
      }
      rows[4 * BM + r] = out.offset(out_img0 + img, 2 * i + di, 2 * j + dj);
    } else {
      for (int t = 0; t < 5; ++t) rows[t * BM + r] = -1;
    }
  }
  __syncthreads();

  AccFrag acc[FM][FN];
  zero_acc(acc);

  for (int t = 0; t < 4; ++t) {
    int kh, oh, kw, ow;
    tap(di, t >> 1, kh, oh);
    tap(dj, t & 1, kw, ow);
    const bf16* wt = L.w + (long long)(kh * 4 + kw) * L.cin * L.cout;
    for (int c0 = 0; c0 < L.cin; c0 += kBK) {
      for (int e = tid; e < BM * kBK; e += kThreads) {
        const int r = e / kBK, k = e - r * kBK;
        const long long off = rows[t * BM + r];
        As[r * LDA + k] = (off >= 0 && c0 + k < L.cin)
                              ? L.x[off + c0 + k] : __float2bfloat16(0.f);
      }
      for (int e = tid; e < kBK * BN; e += kThreads) {
        const int k = e / BN, n = e - k * BN;
        Bs[k * LDB + n] = (c0 + k < L.cin && n0 + n < L.cout)
                              ? wt[(long long)(c0 + k) * L.cout + n0 + n]
                              : __float2bfloat16(0.f);
      }
      __syncthreads();
      mma_step<FM, FN, LDA, LDB>(acc, As, Bs, wm, wn);
      __syncthreads();
    }
  }

  store_acc<FM, FN, LDC>(Cs, acc, wm, wn);
  __syncthreads();

  for (int e = tid; e < BM * BN; e += kThreads) {
    const int r = e / BN, c = e - r * BN;
    const int n = n0 + c;
    const long long off = rows[4 * BM + r];
    if (off >= 0 && n < L.cout) {
      const float v = apply_act(Cs[r * LDC + c] * L.a[n] + L.b[n], L.act, L.leak);
      store_val(y + off + n, v, L.round_bf16);
    }
  }
  __syncthreads();
}

// Tile shapes: 64x64 (the general case), 16x256 (few rows: the first layers
// of one image), 256x16 (few channels: the final RGB layer).
enum TileCfg { kSquare = 0, kWide = 1, kTall = 2 };

__host__ __device__ inline int tile_bm(int cfg) {
  return cfg == kSquare ? 64 : (cfg == kWide ? 16 : 256);
}
__host__ __device__ inline int tile_bn(int cfg) {
  return cfg == kSquare ? 64 : (cfg == kWide ? 256 : 16);
}
__host__ __device__ inline int pick_cfg(int rows, int cout) {
  if (cout <= 16) return kTall;
  if (rows <= 16) return kWide;
  return kSquare;
}

template <typename OutT>
__device__ void convt_tile_cfg(int cfg, const ConvT& L, int di, int dj,
                               int m0, int n0, int nimg, Layout in, int in_img0,
                               Layout out, int out_img0, OutT* y,
                               unsigned char* smem) {
  if (cfg == kSquare)
    convt_tile<2, 2, 2, 2>(L, di, dj, m0, n0, nimg, in, in_img0, out, out_img0, y, smem);
  else if (cfg == kWide)
    convt_tile<1, 4, 1, 4>(L, di, dj, m0, n0, nimg, in, in_img0, out, out_img0, y, smem);
  else
    convt_tile<4, 1, 4, 1>(L, di, dj, m0, n0, nimg, in, in_img0, out, out_img0, y, smem);
}

// A whole layer for images [0, nimg) of one block: every tile of every phase,
// in turn.
template <typename OutT>
__device__ void convt_layer(const ConvT& L, int nimg, Layout in, int in_img0,
                            Layout out, int out_img0, OutT* y,
                            unsigned char* smem) {
  const int M = nimg * L.h * L.w_;
  const int cfg = pick_cfg(M, L.cout);
  const int bm = tile_bm(cfg), bn = tile_bn(cfg);
  for (int ph = 0; ph < 4; ++ph)
    for (int m0 = 0; m0 < M; m0 += bm)
      for (int n0 = 0; n0 < L.cout; n0 += bn)
        convt_tile_cfg(cfg, L, ph >> 1, ph & 1, m0, n0, nimg, in, in_img0, out,
                       out_img0, y, smem);
}

// The generator head for images [0, nimg) of one block:
// relu((z @ wh) * ah + bh) with bf16 operands and fp32 sums, reshaped to
// (s0, s0, c0) per image (the order of tpugan's GHead) and stored as bf16.
// It is under 1% of the generator's operations, so plain FMAs do it.
__device__ inline void gen_head(const bf16* z, int nz, const bf16* wh,
                                const float* ah, const float* bh, int s0,
                                int c0, int nimg, Layout out, bf16* y) {
  const int N = s0 * s0 * c0;
  for (int e = threadIdx.x; e < nimg * N; e += kThreads) {
    const int img = e / N, n = e - img * N;
    float acc = 0.f;
    for (int k = 0; k < nz; ++k)
      acc += __bfloat162float(z[img * nz + k]) *
             __bfloat162float(wh[(long long)k * N + n]);
    const float v = fmaxf(acc * ah[n] + bh[n], 0.f);
    const int p = n / c0, c = n - p * c0;
    const int i = p / s0, j = p - i * s0;
    y[out.offset(img, i, j) + c] = __float2bfloat16(v);
  }
  __syncthreads();
}

constexpr int kMaxLayers = 8;

// A folded eval-mode generator (ops/cuda_gen.fold_generator) and its buffers.
struct Gen {
  const bf16* z;            // (n, nz) bf16
  const bf16* wh;           // (nz, s0*s0*c0) bf16
  const float* ah;          // (s0*s0*c0,)
  const float* bh;
  int nz, s0, c0, n_layers;
  const bf16* w[kMaxLayers];  // (4, 4, cin, cout) bf16 per ConvT layer
  const float* a[kMaxLayers];
  const float* b[kMaxLayers];
  int cout[kMaxLayers];
  bf16* ws;                 // workspace: 2 buffers of ws_elems per block
  long long ws_elems;
  float* y;                 // output, layout given by `kind` (see gen_forward)
  int n, bt;
};

// The whole generator for images [blockIdx.x * bt, + bt): head, then every
// ConvT layer, ping-ponging bf16 activations between the block's two
// workspace buffers (global memory) with a barrier between
// layers.  kind 0 keeps full-resolution NHWC between layers and writes y as
// (n, S, S, C) with the final tanh rounded through bf16 (megakernel v1);
// kind 1 keeps the phase-separated layout (P, P, bt, base, base, C) and
// writes y as (P, P, n, base, base, C) in fp32 (megakernel v2).
__device__ inline void gen_forward(const Gen& G, int kind, unsigned char* smem) {
  const int img0 = blockIdx.x * G.bt;
  const int nimg = min(G.bt, G.n - img0);
  bf16* src = G.ws + (long long)blockIdx.x * 2 * G.ws_elems;
  bf16* dst = src + G.ws_elems;
  int hs = G.s0, cin = G.c0, p = 1;
  gen_head(G.z + (long long)img0 * G.nz, G.nz, G.wh, G.ah, G.bh, G.s0, G.c0,
           nimg, Layout{kind, G.bt, hs, hs, cin, p}, src);
  for (int l = 0; l < G.n_layers; ++l) {
    const bool last = l == G.n_layers - 1;
    ConvT L;
    L.x = src;
    L.w = G.w[l];
    L.a = G.a[l];
    L.b = G.b[l];
    L.cin = cin;
    L.cout = G.cout[l];
    L.h = hs;
    L.w_ = hs;
    L.act = last ? kTanh : kRelu;
    L.leak = 0.f;
    L.round_bf16 = kind == 0;
    const Layout in{kind, G.bt, hs, hs, cin, p};
    if (last) {
      const Layout out{kind, G.n, 2 * hs, 2 * hs, L.cout, 2 * p};
      convt_layer<float>(L, nimg, in, 0, out, img0, G.y, smem);
    } else {
      const Layout out{kind, G.bt, 2 * hs, 2 * hs, L.cout, 2 * p};
      convt_layer<bf16>(L, nimg, in, 0, out, 0, dst, smem);
      bf16* t = src;
      src = dst;
      dst = t;
    }
    __syncthreads();
    hs *= 2;
    p *= 2;
    cin = L.cout;
  }
}

// Host side: launch gen_kernel over ceil(n / bt) blocks.
template <typename Kernel>
inline int launch_gen(Kernel kernel, const void* z, int nz, const void* wh,
                      const float* ah, const float* bh, int s0, int c0,
                      int n_layers, const void* const* ws, const float* const* as,
                      const float* const* bs, const int* couts, void* work,
                      long long ws_elems, float* y, int n, int bt,
                      void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || bt < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Gen G;
  G.z = static_cast<const bf16*>(z);
  G.wh = static_cast<const bf16*>(wh);
  G.ah = ah;
  G.bh = bh;
  G.nz = nz;
  G.s0 = s0;
  G.c0 = c0;
  G.n_layers = n_layers;
  for (int l = 0; l < kMaxLayers; ++l) {
    const bool on = l < n_layers;
    G.w[l] = on ? static_cast<const bf16*>(ws[l]) : nullptr;
    G.a[l] = on ? as[l] : nullptr;
    G.b[l] = on ? bs[l] : nullptr;
    G.cout[l] = on ? couts[l] : 0;
  }
  G.ws = static_cast<bf16*>(work);
  G.ws_elems = ws_elems;
  G.y = y;
  G.n = n;
  G.bt = bt;
  const int blocks = (n + bt - 1) / bt;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tg
