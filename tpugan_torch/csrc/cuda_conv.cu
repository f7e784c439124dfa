// Fused Conv2d(k=4, s=2, p=1) + per-channel affine + activation.
//
// Replaces: tpugan/ops/pallas_conv.py `_kernel` / `_dispatch`
// (`conv_affine_act`, and the bare hook `conv2d`).
//
// What bounds it on an H100: at the discriminator's shapes (batch 128,
// 64x64x3 -> 4x4x512) the three wide layers do 8.6 GFLOP each at 340 to
// 1,000 operations per byte, above the 295 where the tensor cores, not the
// memory, are the limit: bf16 tensor-core throughput (989 TFLOP/s dense).
// The first layer (Cin = 3: 0.8 GFLOP on 3.1 MB in, 16.8 MB out) is bound
// by its bytes.
//
// What the design does about it, by shape (tg_conv_affine_act_plan states
// the rule; the wrapper pads the wide path's operands):
//
//   - conv_act_wide (Cin a multiple of 64, the wide layers): the conv tile
//     of conv_sm90.cuh, shared with the conv + BN-statistics kernel (TMA
//     through a 5-D parity view of x into a swizzled ring, one producer
//     warp, two wgmma consumer warpgroups, 128 x 64 or 128 x 128 tiles,
//     split-K over a cluster where the plan splits), with convt_wide's
//     epilogue: act(acc * a[c] + b[c]) in registers, then 16-byte row
//     vectors through shared memory, in bf16 or fp32.
//   - conv_act_narrow (Cin <= 16, the RGB layer): padding Cin to 64 would
//     read and write 21x x's bytes, and TMA cannot fetch a 6-byte pixel as a
//     box row.  Persistent blocks walk 128-position tiles; each tile's haloed
//     input window, bn x (2 bh + 2) x (2 bw + 2) x Cin, comes into shared
//     memory by plain loads, and the threads gather each row's 16 Cin-deep
//     patch (48 at Cin = 3) into K-major, 128-byte-swizzled A stages of 64,
//     zero beyond the depth.  The whole weight (depth rounded up to 64 x
//     Cout rounded up to 64) stays in shared memory as N-major boxes, so a
//     tile is ceil(16 Cin / 64) m64n64k16 wgmma stages of four per 64
//     output channels, with the wide kernel's epilogue.
//
// fp32 operands (train.precision="fp32"): tg_conv_affine_act_f32 runs the
// conv on the FFMA mainloop of igemm_f32.cuh (any Cin and Cout, operands
// as they are) with the same affine + activation epilogue.
#include <cuda_runtime.h>

#include <algorithm>

#include "conv_sm90.cuh"
#include "igemm_f32.cuh"

namespace {

using namespace tg::sm90;

template <int BN, int STAGES, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
conv_act_wide(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap, Conv L,
              const float* a, const float* b, int act, float leak, OutT* y) {
  const ConvRing<BN, STAGES> R{smem_base()};
  const int tiles_n = (L.cout + BN - 1) / BN;
  const int tm = blockIdx.x / tiles_n, n0 = (blockIdx.x - tm * tiles_n) * BN;
  int img0, i0, j0;
  L.box.origin(tm, img0, i0, j0);
  if (threadIdx.x == 0) R.init();
  __syncthreads();

  float acc[BN / 2];
  if (!conv_tile<BN, STAGES>(xmap, wmap, L, R, n0, img0, i0, j0, acc)) return;

  const int wg = threadIdx.x >> 7;
  affine_act<BN>(acc, n0, a, b, L.cout, act, leak);
  named_sync(1, kConsumers);  // every product is done: the ring is free
  float* stage = reinterpret_cast<float*>(R.base) + wg * kStageFloats<BN>;
  const int ho = L.box.h, wo = L.box.w;
  store_tile<BN>(acc, stage, y, n0, L.cout, wg, [&](int r) -> long long {
    int im, ii, jj;
    if (!L.box.at(64 * wg + r, img0, i0, j0, im, ii, jj)) return -1;
    return ((static_cast<long long>(im) * ho + ii) * wo + jj) * L.cout;
  });
}

constexpr int kNarrowMaxCin = 16;    // depth 16 Cin <= 256: 4 A stages
constexpr int kNarrowMaxCout = 128;  // weight <= 4 x 2 boxes of 8 KB
constexpr int kBBox = kBK * kRowBytes;  // N-major B: 64 depth x 64 columns

// The narrow layer: x (n, h, w, cin) bf16, w (4, 4, cin, ldb) bf16, both
// read by plain loads (no alignment asked).
struct ConvN {
  Box box;      // the output grid (n, h/2, w/2)
  int in_h, in_w;  // the input's size
  int cin, cout, ldb;
  int ks;       // A stages: ceil(16 cin / 64)
  int nch;      // 64-column chunks: ceil(cout / 64)
  int win_h, win_w;  // the input window of a tile: 2 bh + 2, 2 bw + 2
  const tg::sm90::bf16* x;
  const tg::sm90::bf16* w;
  const float* a;
  const float* b;
  int act;
  float leak;
};

// Shared memory of a narrow block: the weight (ks x nch boxes), the A
// stages (ks x 16 KB), the gather's offset tables (a row's window offset,
// a depth column's offset from it), then the input window, which the
// epilogue's staging tile reuses once the tile is gathered.
struct NarrowSmem {
  int a, rofs, kofs, win, bytes;
};

inline NarrowSmem narrow_smem(const ConvN& L) {
  NarrowSmem m;
  m.a = L.ks * L.nch * kBBox;
  m.rofs = m.a + L.ks * kATile;
  m.kofs = m.rofs + kBM * 4;
  m.win = m.kofs + L.ks * kBK * 4;
  const int win = L.box.bn * L.win_h * L.win_w * L.cin * 2;
  m.bytes = m.win + std::max((win + 15) / 16 * 16, 2 * kStageFloats<64> * 4);
  return m;
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
conv_act_narrow(ConvN L, NarrowSmem m, OutT* y) {
  using bf = tg::sm90::bf16;
  unsigned char* base = smem_base();
  unsigned char* bs = base;             // [ks][nch] N-major 64 x 64 boxes
  unsigned char* as = base + m.a;       // [ks] K-major 128 x 64 stages
  int* rofs = reinterpret_cast<int*>(base + m.rofs);
  int* kofs = reinterpret_cast<int*>(base + m.kofs);
  bf* win = reinterpret_cast<bf*>(base + m.win);
  const int tid = threadIdx.x;
  const int depth = 16 * L.cin;

  // the weight: B[k][n] = w[k * ldb + n] (k = tap * cin + c is the HWIO
  // order), zero past the depth and past Cout; box (s, h) holds depth rows
  // 64 s .. and columns 64 h .., 16-byte chunk q of row kr at q ^ (kr % 8)
  for (int e = tid; e < L.ks * L.nch * kBK * 8; e += kThreads) {
    const int box = e >> 9, kr = (e >> 3) & 63, q = e & 7;
    const int s = box / L.nch, h = box - s * L.nch;
    const int k = s * kBK + kr, n0 = h * kBK + q * 8;
    __align__(16) bf v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = (k < depth && n0 + i < L.cout)
                 ? L.w[static_cast<long long>(k) * L.ldb + n0 + i]
                 : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(bs + box * kBBox + kr * kRowBytes +
                              ((q ^ (kr & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
  // the gather's tables, the same for every tile (one box shape): row r's
  // patch starts at window element rofs[r] and depth k = tap * cin + c
  // lies kofs[k] on; -1 past the box's rows or the depth
  const int bh = L.box.bh, bw = L.box.bw, ho = L.box.h, wo = L.box.w;
  for (int r = tid; r < kBM; r += kThreads) {
    const int pb = bh * bw, nl = r / pb, rr = r - nl * pb;
    const int il = rr / bw, jl = rr - il * bw;
    rofs[r] = r < L.box.rows()
                  ? ((nl * L.win_h + 2 * il) * L.win_w + 2 * jl) * L.cin
                  : -1;
  }
  for (int k = tid; k < L.ks * kBK; k += kThreads) {
    const int tp = k / L.cin, c = k - tp * L.cin;
    kofs[k] = k < depth ? ((tp >> 2) * L.win_w + (tp & 3)) * L.cin + c : -1;
  }

  const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int rows = L.box.bn * L.win_h, seg = L.win_w * L.cin;
  for (int t = blockIdx.x; t < L.box.tiles(); t += gridDim.x) {
    int img0, i0, j0;
    L.box.origin(t, img0, i0, j0);
    __syncthreads();  // the last tile's products and gather are done

    // the haloed input window, zero outside the images: a warp a window
    // row (seg contiguous elements of x from column 2 j0 - 1), elements lo
    // .. hi of it inside the image; loads first, then stores, so that each
    // thread has several loads in flight
    constexpr int kUnroll = 8;
    const int c0 = 2 * j0 - 1;
    const int lo = c0 < 0 ? L.cin : 0;
    const int hi = min(seg, (L.in_w - c0) * L.cin);
    for (int row = warp; row < rows; row += kThreads / 32) {
      const int nl = row / L.win_h, img = img0 + nl;
      const int ih = 2 * i0 - 1 + row - nl * L.win_h;
      const bool inside = img < L.box.n && ih >= 0 && ih < L.in_h;
      const bf* src =
          inside ? L.x + ((static_cast<long long>(img) * L.in_h + ih) *
                              L.in_w + c0) * L.cin
                 : L.x;
      bf* dst = win + row * seg;
      for (int q0 = lane; q0 < seg; q0 += 32 * kUnroll) {
        bf v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int q = q0 + 32 * u;
          v[u] = inside && q >= lo && q < hi ? src[q] : __float2bfloat16(0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (q0 + 32 * u < seg) dst[q0 + 32 * u] = v[u];
      }
    }
    __syncthreads();

    // gather: row r's depth k into 16-byte chunks of 8 columns
    for (int e = tid; e < L.ks * kBM * 8; e += kThreads) {
      const int s = e / (kBM * 8), rem = e - s * (kBM * 8);
      const int r = rem >> 3, q = rem & 7, ro = rofs[r];
      __align__(16) bf v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ko = kofs[s * kBK + q * 8 + i];
        v[i] = ro >= 0 && ko >= 0 ? win[ro + ko] : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(as + s * kATile + r * kRowBytes +
                                ((q ^ (r & 7)) << 4)) =
          *reinterpret_cast<const uint4*>(v);
    }
    fence_async_shared();  // the gathered stages (and weight) for wgmma
    __syncthreads();
    if (tid >= kConsumers) continue;

    float* stage = reinterpret_cast<float*>(base + m.win) +
                   wg * kStageFloats<64>;  // the window is gathered
    for (int h = 0; h < L.nch; ++h) {
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
      fence_acc(acc);
      wgmma_fence();
      for (int s = 0; s < L.ks; ++s)
        mma_stage<64>(acc, desc_kmajor(as + s * kATile + wg * (kATile / 2)),
                      desc_nmajor(bs + (s * L.nch + h) * kBBox));
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<0>();
      fence_acc(acc);
      affine_act<64>(acc, h * kBK, L.a, L.b, L.cout, L.act, L.leak);
      if (h > 0) named_sync(2 + wg, 128);  // the last chunk's stage is read
      store_tile<64>(acc, stage, y, h * kBK, L.cout, wg,
                     [&](int r) -> long long {
                       int im, ii, jj;
                       if (!L.box.at(64 * wg + r, img0, i0, j0, im, ii, jj))
                         return -1;
                       return ((static_cast<long long>(im) * ho + ii) * wo +
                               jj) * L.cout;
                     });
    }
  }
}

template <typename OutT>
int run(const void* x, const void* wt, const float* a, const float* b,
        void* y, int n, int h, int w, int cin, int cout, int ldb, int act,
        float leak, int splits, cudaStream_t s) {
  OutT* out = static_cast<OutT*>(y);
  cudaError_t e;
  if (cin % kBK == 0) {
    Conv L;
    CUtensorMap xmap, wmap;
    if (!make_conv(x, wt, n, h, w, cin, cout, ldb, splits, &L, &xmap, &wmap))
      return static_cast<int>(cudaErrorInvalidValue);
    e = conv_tile_n(cout) == 128
            ? launch_conv<128, 3>(conv_act_wide<128, 3, OutT>, L, splits, s,
                                  xmap, wmap, L, a, b, act, leak, out)
            : launch_conv<64, 4>(conv_act_wide<64, 4, OutT>, L, splits, s,
                                 xmap, wmap, L, a, b, act, leak, out);
  } else {
    if (cin > kNarrowMaxCin || cout > kNarrowMaxCout || ldb < cout ||
        n < 1 || h < 2 || w < 2 || h % 2 || w % 2)
      return static_cast<int>(cudaErrorInvalidValue);
    ConvN L;
    L.box = make_box(n, h / 2, w / 2);
    L.in_h = h;
    L.in_w = w;
    L.cin = cin;
    L.cout = cout;
    L.ldb = ldb;
    L.ks = (16 * cin + kBK - 1) / kBK;
    L.nch = (cout + kBK - 1) / kBK;
    L.win_h = 2 * L.box.bh + 2;
    L.win_w = 2 * L.box.bw + 2;
    L.x = static_cast<const tg::sm90::bf16*>(x);
    L.w = static_cast<const tg::sm90::bf16*>(wt);
    L.a = a;
    L.b = b;
    L.act = act;
    L.leak = leak;
    const NarrowSmem m = narrow_smem(L);
    const int smem = m.bytes + 1024;
    int resident = 0;
    e = kernel_setup(reinterpret_cast<const void*>(conv_act_narrow<OutT>),
                     smem, &resident);
    if (e != cudaSuccess) return static_cast<int>(e);
    // persistent: as many blocks as fit on the card at once
    const int blocks = std::min(L.box.tiles(), resident);
    e = launch(conv_act_narrow<OutT>, dim3(blocks), smem, 1, s, L, m, out);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan of a layer of an (n, h, w, cin) input and cout channels, on a
// card of `sms` multiprocessors: plan[0] = the path, 1 narrow (cin <=
// kNarrowMaxCin with cout <= kNarrowMaxCout: x and w taken as they are) or
// 0 wide (cin zero-padded to a multiple of 64 by the caller); plan[1] = the
// tiles of the output grid (make_box); plan[2] = the blocks that split each
// tile's depth (conv_plan on the padded cin; 1 on the narrow path).
extern "C" void tg_conv_affine_act_plan(int n, int h, int w, int cin,
                                        int cout, int sms, int* plan) {
  plan[0] = cin <= kNarrowMaxCin && cout <= kNarrowMaxCout;
  if (plan[0]) {
    plan[1] = make_box(n, h / 2, w / 2).tiles();
    plan[2] = 1;
  } else {
    conv_plan(n, h, w, (cin + kBK - 1) / kBK * kBK, cout, sms, plan + 1);
  }
}

// x (n, h, w, cin) bf16, wt (4, 4, cin, ldb) bf16 (ldb >= cout), a/b
// (cout,) f32 -> y (n, h/2, w/2, cout) bf16 (out_f32 = 0) or f32
// (out_f32 = 1), as tg_conv_affine_act_plan's path takes them: cin % 64 ==
// 0 runs the wide kernel (x and wt 16-byte aligned, ldb % 8 == 0; its
// depth split is the plan's for the current card), cin <= 16 with cout <=
// 128 the narrow one.
extern "C" int tg_conv_affine_act(const void* x, const void* wt,
                                  const float* a, const float* b, void* y,
                                  int n, int h, int w, int cin, int cout,
                                  int ldb, int act, float leak, int out_f32,
                                  void* stream) {
  if (cin < 1 || cout < 1) return static_cast<int>(cudaErrorInvalidValue);
  int plan[3] = {0, 0, 1};
  if (cin % kBK == 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    tg_conv_affine_act_plan(n, h, w, cin, cout, sms, plan);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? run<float>(x, wt, a, b, y, n, h, w, cin, cout, ldb, act,
                              leak, plan[2], s)
                 : run<tg::sm90::bf16>(x, wt, a, b, y, n, h, w, cin, cout,
                                       ldb, act, leak, plan[2], s);
}

// x (n, h, w, cin) fp32, wt (4, 4, cin, ldb) fp32 (ldb >= cout; any cin and
// cout >= 1, any alignment), a/b (cout,) f32 -> y (n, h/2, w/2, cout) bf16
// (out_f32 = 0) or f32 (out_f32 = 1): fp32 products, fp32 sums.
extern "C" int tg_conv_affine_act_f32(const float* x, const float* wt,
                                      const float* a, const float* b, void* y,
                                      int n, int h, int w, int cin, int cout,
                                      int ldb, int act, float leak,
                                      int out_f32, void* stream) {
  if (h < 2 || w < 2 || h % 2 || w % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const tg::f32::Gemm G = tg::f32::conv_gemm(x, wt, n, h, w, cin, cout, ldb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_f32 ? tg::f32::run_affine_act(G, 1, a, b, act, leak,
                                        static_cast<float*>(y), s)
              : tg::f32::run_affine_act(G, 1, a, b, act, leak,
                                        static_cast<tg::sm90::bf16*>(y), s));
}
