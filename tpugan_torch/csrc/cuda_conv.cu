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
// fp32 operands (train.precision="fp32"; pallas_conv.py:86 `_dispatch` on
// fp32 x and w, whose jnp.dot takes them with fp32 sums).  What bounds it:
// the wide layers' products (25.8 GFLOP over the D's three at batch 128),
// which no tensor-core type takes as fp32 (FFMA, 67 TFLOP/s: 0.385 ms at
// best), and the RGB layer's bytes (39.8 MB in and out at batch 128, fp32
// out: 0.012 ms at 3.35 TB/s).  What the design does about it: both
// tiles run on the tensor cores in three TF32 passes over split operands
// (each operand big + small; big x big + big x small + small x big summed
// in fp32 carry ~22 bits an operand, under fp32's sum-order noise), as
// kernels 1 and 5 do, the route decided by the wrapper before the launch
// (ops/cuda_conv.py f32_path):
//
//   - tg_conv_affine_act_tf32 (Cin a multiple of 32): conv_act_wide on
//     kernel 5's fp32 conv tile (conv_sm90.cuh with kF32: x by TMA through
//     the parity view, 32 channels a stage, its rows split in registers;
//     B from the weight split once a call into its two parts, K-major, by
//     split_weight_tf32; every 4 stages' sums added in fp32, consume_f32),
//     planned by conv_plan_f32 (64-wide tiles where 128-wide ones would
//     fill at most half the card, at most 2 blocks a tile), one block an
//     SM; the affine and the activation after the cluster's rank-ordered
//     reduction: the same bits on every run.  A bound of 0.156 ms for the
//     three wide layers at batch 128.
//   - conv_act_narrow_tf32 (Cin <= 16, Cout <= 128: the RGB layers):
//     conv_act_narrow's walk on fp32: the haloed window by plain loads,
//     the gather into fp32 A stages of 32 channels (128-byte rows, the
//     swizzle load_split_a reads, zero past the 16 Cin depth), each stage
//     split in registers and multiplied in three passes against the
//     weight split by the block into shared memory, K-major (tf32 wgmma
//     reads B K-major only).  Towards its bytes bound: x crosses L2 once a
//     tile (the window, with a 2-row and 2-column halo), the output
//     leaves once as 16-byte row vectors, and at Cin <= 4 (two stages:
//     the whole split weight stays in shared memory, loaded once a block)
//     with Cout <= 64 two persistent blocks share an SM, so one block's
//     window loads, gather and stores run under the other's products.  At
//     Cin 5 to 16 the weight does not fit beside the window: the block
//     takes one stage at a time, the weight's stage split anew each tile,
//     and the stages' products are added in fp32.
//
// Shapes neither tile takes (16 < Cin, Cin not a multiple of 32) run
// tg_conv_affine_act_f32, the FFMA mainloop of igemm_f32.cuh (any Cin and
// Cout, operands as they are) with the same affine + activation epilogue.
#include <cuda_runtime.h>

#include <algorithm>

#include "conv_sm90.cuh"
#include "igemm_f32.cuh"

namespace {

using namespace tg::sm90;

// kF32: fp32 x and the split weight's map (make_conv_tf32), one block an
// SM (its ring fills the SM's shared memory).
template <int BN, int STAGES, typename OutT, bool kF32 = false>
__global__ void __launch_bounds__(kThreads, kF32 ? 1 : 2)
conv_act_wide(const __grid_constant__ CUtensorMap xmap,
              const __grid_constant__ CUtensorMap wmap, Conv L,
              const float* a, const float* b, int act, float leak, OutT* y) {
  const ConvRing<BN, STAGES, kF32> R{smem_base()};
  const int tiles_n = (L.cout + BN - 1) / BN;
  const int tm = blockIdx.x / tiles_n, n0 = (blockIdx.x - tm * tiles_n) * BN;
  int img0, i0, j0;
  L.box.origin(tm, img0, i0, j0);
  if (threadIdx.x == 0) R.init();
  __syncthreads();

  float acc[BN / 2];
  if (!conv_tile<BN, STAGES, kF32>(xmap, wmap, L, R, n0, img0, i0, j0, acc))
    return;

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
// fp32: K-major B of one part, 64 columns x 32 depth; the stages of 32
// channels a block holds at once: all of them up to 2 (Cin <= 4), else 1
constexpr int kB32Box = 64 * kRowBytes;
constexpr int kNarrowHeld32 = 2;

// The narrow layer: x (n, h, w, cin) and w (4, 4, cin, ldb) of T (bf16 or
// fp32), both read by plain loads (no alignment asked).
template <typename T>
struct ConvN {
  static constexpr int kChan = kRowBytes / sizeof(T);  // channels a stage
  Box box;      // the output grid (n, h/2, w/2)
  int in_h, in_w;  // the input's size
  int cin, cout, ldb;
  int ks;       // A stages: ceil(16 cin / kChan)
  int nch;      // 64-column chunks: ceil(cout / 64)
  int win_h, win_w;  // the input window of a tile: 2 bh + 2, 2 bw + 2
  const T* x;
  const T* w;
  const float* a;
  const float* b;
  int act;
  float leak;
  // A stages in shared memory at once
  __host__ __device__ int held() const {
    return sizeof(T) == 2 || ks <= kNarrowHeld32 ? ks : 1;
  }
};

// Shared memory of a narrow block: the weight (the held stages' boxes),
// the A stages it holds (16 KB each), the gather's offset tables (a row's
// window offset, a depth column's offset from it), then the input window,
// which the epilogue's staging tile reuses once the tile is gathered.
struct NarrowSmem {
  int a, rofs, kofs, win, bytes;
};

template <typename T>
inline NarrowSmem narrow_smem(const ConvN<T>& L) {
  const int held = L.held();
  NarrowSmem m;
  m.a = held * L.nch * (sizeof(T) == 2 ? kBBox : 2 * kB32Box);
  m.rofs = m.a + held * kATile;
  m.kofs = m.rofs + kBM * 4;
  m.win = m.kofs + L.ks * ConvN<T>::kChan * 4;
  const int win = L.box.bn * L.win_h * L.win_w * L.cin * sizeof(T);
  m.bytes = m.win + std::max((win + 15) / 16 * 16, 2 * kStageFloats<64> * 4);
  return m;
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ tg::sm90::bf16 zero_of<tg::sm90::bf16>() {
  return __float2bfloat16(0.f);
}

// The gather's tables, the same for every tile (one box shape): row r's
// patch starts at window element rofs[r] and depth k = tap * cin + c lies
// kofs[k] on; -1 past the box's rows or the depth.  By every thread.
template <typename T>
__device__ __forceinline__ void narrow_tables(const ConvN<T>& L, int* rofs,
                                              int* kofs) {
  const int depth = 16 * L.cin, bh = L.box.bh, bw = L.box.bw;
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int pb = bh * bw, nl = r / pb, rr = r - nl * pb;
    const int il = rr / bw, jl = rr - il * bw;
    rofs[r] = r < L.box.rows()
                  ? ((nl * L.win_h + 2 * il) * L.win_w + 2 * jl) * L.cin
                  : -1;
  }
  for (int k = threadIdx.x; k < L.ks * ConvN<T>::kChan; k += kThreads) {
    const int tp = k / L.cin, c = k - tp * L.cin;
    kofs[k] = k < depth ? ((tp >> 2) * L.win_w + (tp & 3)) * L.cin + c : -1;
  }
}

// The haloed input window of the tile at (img0, i0, j0), zero outside the
// images: a warp a window row (seg contiguous elements of x from column
// 2 j0 - 1), elements lo .. hi of it inside the image; loads first, then
// stores, so that each thread has several loads in flight.  By every
// thread.
template <typename T>
__device__ __forceinline__ void narrow_window(const ConvN<T>& L, T* win,
                                              int img0, int i0, int j0) {
  constexpr int kUnroll = 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = L.box.bn * L.win_h, seg = L.win_w * L.cin;
  const int c0 = 2 * j0 - 1;
  const int lo = c0 < 0 ? L.cin : 0;
  const int hi = min(seg, (L.in_w - c0) * L.cin);
  for (int row = warp; row < rows; row += kThreads / 32) {
    const int nl = row / L.win_h, img = img0 + nl;
    const int ih = 2 * i0 - 1 + row - nl * L.win_h;
    const bool inside = img < L.box.n && ih >= 0 && ih < L.in_h;
    const T* src =
        inside ? L.x + ((static_cast<long long>(img) * L.in_h + ih) *
                            L.in_w + c0) * L.cin
               : L.x;
    T* dst = win + row * seg;
    for (int q0 = lane; q0 < seg; q0 += 32 * kUnroll) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + 32 * u;
        v[u] = inside && q >= lo && q < hi ? src[q] : zero_of<T>();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (q0 + 32 * u < seg) dst[q0 + 32 * u] = v[u];
    }
  }
}

// Gather A stages s0 .. s0 + n - 1 of the tile from its window into `as`
// (stage s0 + i at as + i kATile): row r's depth in 16-byte chunks of
// 16 / sizeof(T) channels, chunk q of row r at q ^ (r % 8) (K-major, the
// 128-byte swizzle).  By every thread.
template <typename T>
__device__ __forceinline__ void narrow_gather(const ConvN<T>& L, const T* win,
                                              const int* rofs,
                                              const int* kofs,
                                              unsigned char* as, int s0,
                                              int n) {
  constexpr int kPer = 16 / sizeof(T);
  for (int e = threadIdx.x; e < n * kBM * 8; e += kThreads) {
    const int s = e / (kBM * 8), rem = e - s * (kBM * 8);
    const int r = rem >> 3, q = rem & 7, ro = rofs[r];
    __align__(16) T v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int ko = kofs[(s0 + s) * ConvN<T>::kChan + q * kPer + i];
      v[i] = ro >= 0 && ko >= 0 ? win[ro + ko] : zero_of<T>();
    }
    *reinterpret_cast<uint4*>(as + s * kATile + r * kRowBytes +
                              ((q ^ (r & 7)) << 4)) =
        *reinterpret_cast<const uint4*>(v);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
conv_act_narrow(ConvN<tg::sm90::bf16> L, NarrowSmem m, OutT* y) {
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
  narrow_tables(L, rofs, kofs);

  const int wg = tid >> 7;
  const int ho = L.box.h, wo = L.box.w;
  for (int t = blockIdx.x; t < L.box.tiles(); t += gridDim.x) {
    int img0, i0, j0;
    L.box.origin(t, img0, i0, j0);
    __syncthreads();  // the last tile's products and gather are done
    narrow_window(L, win, img0, i0, j0);
    __syncthreads();
    narrow_gather(L, win, rofs, kofs, as, 0, L.ks);
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

// Stages s0 .. s0 + n - 1 of the fp32 weight as the narrow TF32 tile's B
// in bs: box 2 ((s - s0) nch + h) + q is part q (the TF32 part, the rest)
// of stage s and columns 64 h .., 64 K-major rows (output channels) of 32
// depth with the 128-byte swizzle (chunk q of row n at q ^ (n % 8)), zero
// past the depth and Cout.  By every thread; reads along Cout.
__device__ __forceinline__ void narrow_weight_split(const ConvN<float>& L,
                                                    unsigned char* bs,
                                                    int s0, int n) {
  const int depth = 16 * L.cin;
  for (int e = threadIdx.x; e < n * L.nch * 64 * kBK32; e += kThreads) {
    const int c = e & 63, k = (e >> 6) & 31, sh = e >> 11;
    const int s = sh / L.nch, h = sh - s * L.nch;
    const int kd = (s0 + s) * kBK32 + k, col = h * 64 + c;
    const float v = kd < depth && col < L.cout
                        ? L.w[static_cast<long long>(kd) * L.ldb + col]
                        : 0.f;
    const float big = tf32_rna(v);
    unsigned char* p = bs + 2 * sh * kB32Box + c * kRowBytes +
                       (((k >> 2) ^ (c & 7)) << 4) + (k & 3) * 4;
    *reinterpret_cast<float*>(p) = big;
    *reinterpret_cast<float*>(p + kB32Box) = tf32_rna(v - big);
  }
}

// One A stage at `a` times the B boxes at `b` (the TF32 part, the rest
// kB32Box on) into this warpgroup's 64 x 64 part: split in registers, three
// passes, every product done on return.
__device__ __forceinline__ void narrow_stage_tf32(float (&part)[32],
                                                  const unsigned char* a,
                                                  const unsigned char* b,
                                                  int r0, bool add) {
  uint32_t big[4][4], small[4][4];
  load_split_a(a, r0, r0 + 8, big, small);
  fence_acc(part);
  fence_frag(big);
  fence_frag(small);
  wgmma_fence();
  mma_stage_3xtf32<64>(part, big, small, desc_kmajor(b),
                       desc_kmajor(b + kB32Box), add);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(part);
  fence_frag(big);
  fence_frag(small);
}

// The narrow layer on fp32 operands.  kOneStage = false (ks <= 2): the
// block holds every stage, the weight split once a block, two blocks an
// SM; true: one stage at a time (the window fills the shared memory), the
// stage's weight split anew each tile, each stage's products added into
// the running sums in fp32.
template <bool kOneStage, typename OutT>
__global__ void __launch_bounds__(kThreads, kOneStage ? 1 : 2)
conv_act_narrow_tf32(ConvN<float> L, NarrowSmem m, OutT* y) {
  unsigned char* base = smem_base();
  unsigned char* bs = base;        // [held][nch][2] K-major 64 x 32 boxes
  unsigned char* as = base + m.a;  // [held] K-major 128 x 32 fp32 stages
  int* rofs = reinterpret_cast<int*>(base + m.rofs);
  int* kofs = reinterpret_cast<int*>(base + m.kofs);
  float* win = reinterpret_cast<float*>(base + m.win);
  const int tid = threadIdx.x;

  if constexpr (!kOneStage) narrow_weight_split(L, bs, 0, L.ks);
  narrow_tables(L, rofs, kofs);

  const int wg = tid >> 7, lane = tid & 31;
  const int r0 = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
  const int ho = L.box.h, wo = L.box.w;
  for (int t = blockIdx.x; t < L.box.tiles(); t += gridDim.x) {
    int img0, i0, j0;
    L.box.origin(t, img0, i0, j0);
    auto off = [&](int r) -> long long {
      int im, ii, jj;
      if (!L.box.at(64 * wg + r, img0, i0, j0, im, ii, jj)) return -1;
      return ((static_cast<long long>(im) * ho + ii) * wo + jj) * L.cout;
    };
    __syncthreads();  // the last tile's products and epilogue are done
    narrow_window(L, win, img0, i0, j0);
    __syncthreads();
    // the epilogue's staging reuses the window once every stage is gathered
    float* stage = win + wg * kStageFloats<64>;
    if constexpr (!kOneStage) {
      narrow_gather(L, win, rofs, kofs, as, 0, L.ks);
      fence_async_shared();  // the gathered stages (and weight) for wgmma
      __syncthreads();
      if (tid >= kConsumers) continue;
      for (int h = 0; h < L.nch; ++h) {
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        for (int s = 0; s < L.ks; ++s)
          narrow_stage_tf32(acc, as + s * kATile,
                            bs + 2 * (s * L.nch + h) * kB32Box, r0, s > 0);
        affine_act<64>(acc, h * 64, L.a, L.b, L.cout, L.act, L.leak);
        if (h > 0) named_sync(2 + wg, 128);  // the last chunk's stage is read
        store_tile<64>(acc, stage, y, h * 64, L.cout, wg, off);
      }
    } else {
      float acc[kNarrowMaxCout / 64][32];
#pragma unroll
      for (int h = 0; h < kNarrowMaxCout / 64; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
      for (int s = 0; s < L.ks; ++s) {
        if (s > 0) __syncthreads();  // stage s - 1's products are done
        narrow_weight_split(L, bs, s, 1);
        narrow_gather(L, win, rofs, kofs, as, s, 1);
        fence_async_shared();
        __syncthreads();
        if (tid >= kConsumers) continue;
#pragma unroll
        for (int h = 0; h < kNarrowMaxCout / 64; ++h) {
          if (h >= L.nch) break;
          float part[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) part[i] = 0.f;
          narrow_stage_tf32(part, as, bs + 2 * h * kB32Box, r0, false);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[h][i] += part[i];
        }
      }
      if (tid >= kConsumers) continue;
#pragma unroll
      for (int h = 0; h < kNarrowMaxCout / 64; ++h) {
        if (h >= L.nch) break;
        affine_act<64>(acc[h], h * 64, L.a, L.b, L.cout, L.act, L.leak);
        if (h > 0) named_sync(2 + wg, 128);  // the last chunk's stage is read
        store_tile<64>(acc[h], stage, y, h * 64, L.cout, wg, off);
      }
    }
  }
}

// The narrow layer of an (n, h, w, cin) input; false on a shape the
// narrow tiles do not take.
template <typename T>
bool make_narrow(const void* x, const void* wt, const float* a,
                 const float* b, int n, int h, int w, int cin, int cout,
                 int ldb, int act, float leak, ConvN<T>* L) {
  if (cin < 1 || cin > kNarrowMaxCin || cout < 1 || cout > kNarrowMaxCout ||
      ldb < cout || n < 1 || h < 2 || w < 2 || h % 2 || w % 2)
    return false;
  L->box = make_box(n, h / 2, w / 2);
  L->in_h = h;
  L->in_w = w;
  L->cin = cin;
  L->cout = cout;
  L->ldb = ldb;
  L->ks = (16 * cin + ConvN<T>::kChan - 1) / ConvN<T>::kChan;
  L->nch = (cout + 63) / 64;
  L->win_h = 2 * L->box.bh + 2;
  L->win_w = 2 * L->box.bw + 2;
  L->x = static_cast<const T*>(x);
  L->w = static_cast<const T*>(wt);
  L->a = a;
  L->b = b;
  L->act = act;
  L->leak = leak;
  return true;
}

// Launch a narrow kernel persistently: as many blocks as fit on the card
// at once, each walking tiles.
template <typename T, typename OutT>
cudaError_t launch_narrow(void (*kernel)(ConvN<T>, NarrowSmem, OutT*),
                          const ConvN<T>& L, OutT* y, cudaStream_t s) {
  const NarrowSmem m = narrow_smem(L);
  const int smem = m.bytes + 1024;
  int resident = 0;
  cudaError_t e = kernel_setup(reinterpret_cast<const void*>(kernel), smem,
                               &resident);
  if (e != cudaSuccess) return e;
  return launch(kernel, dim3(std::min(L.box.tiles(), resident)), smem, 1, s,
                L, m, y);
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
    ConvN<tg::sm90::bf16> L;
    if (!make_narrow(x, wt, a, b, n, h, w, cin, cout, ldb, act, leak, &L))
      return static_cast<int>(cudaErrorInvalidValue);
    e = launch_narrow(conv_act_narrow<OutT>, L, out, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
cudaError_t launch_tf32(const CUtensorMap& xmap, const CUtensorMap& wmap,
                        const Conv& L, int splits, int bn, const float* a,
                        const float* b, int act, float leak, OutT* y,
                        cudaStream_t s) {
  return bn == 128
             ? launch_conv<128, 4, true>(conv_act_wide<128, 4, OutT, true>, L,
                                         splits, s, xmap, wmap, L, a, b, act,
                                         leak, y)
             : launch_conv<64, 6, true>(conv_act_wide<64, 6, OutT, true>, L,
                                        splits, s, xmap, wmap, L, a, b, act,
                                        leak, y);
}

template <typename OutT>
cudaError_t run_narrow_tf32(const ConvN<float>& L, OutT* y, cudaStream_t s) {
  return L.ks <= kNarrowHeld32
             ? launch_narrow(conv_act_narrow_tf32<false, OutT>, L, y, s)
             : launch_narrow(conv_act_narrow_tf32<true, OutT>, L, y, s);
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

// The plan of tg_conv_affine_act_tf32 on an (n, h, w, cin) input with cin
// % 32 == 0 (conv_plan_f32): plan[0] = the tiles of the output grid,
// plan[1] = the blocks that split each tile's depth, plan[2] = the tile's
// width.
extern "C" void tg_conv_affine_act_tf32_plan(int n, int h, int w, int cin,
                                             int cout, int sms, int* plan) {
  conv_plan_f32(n, h, w, cin, cout, sms, plan);
}

// x (n, h, w, cin) fp32 with cin % 32 == 0, 16-byte aligned; wt (4, 4, cin,
// ldb) fp32 (ldb >= cout, any alignment); ws: scratch of 32 cin * cout
// floats (the split weight); a/b (cout,) f32 -> y (n, h/2, w/2, cout) bf16
// (out_f32 = 0) or f32 (out_f32 = 1): fp32 products by three TF32 passes,
// fp32 sums; splits and the tile width bn (64 or 128) from
// tg_conv_affine_act_tf32_plan (a measurement may set splits to another of
// 1, 2 or 4 dividing the depth of 16 cin / 32 stages).
extern "C" int tg_conv_affine_act_tf32(const float* x, const float* wt,
                                       float* ws, const float* a,
                                       const float* b, void* y, int n, int h,
                                       int w, int cin, int cout, int ldb,
                                       int act, float leak, int out_f32,
                                       int splits, int bn, void* stream) {
  Conv L;
  CUtensorMap xmap, wmap;
  if ((bn != 64 && bn != 128) || ldb < cout ||
      !make_conv_tf32(x, ws, n, h, w, cin, cout, splits, bn, &L, &xmap,
                      &wmap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_split_weight(wt, 16 * cin, cout, ldb, ws, s);
  if (e == cudaSuccess)
    e = out_f32 ? launch_tf32(xmap, wmap, L, splits, bn, a, b, act, leak,
                              static_cast<float*>(y), s)
                : launch_tf32(xmap, wmap, L, splits, bn, a, b, act, leak,
                              static_cast<tg::sm90::bf16*>(y), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// x (n, h, w, cin) fp32 with 1 <= cin <= 16, wt (4, 4, cin, ldb) fp32
// (cout <= ldb, cout <= 128; both any alignment), a/b (cout,) f32 -> y (n,
// h/2, w/2, cout) bf16 (out_f32 = 0) or f32 (out_f32 = 1): fp32 products by
// three TF32 passes on the narrow tile, fp32 sums.
extern "C" int tg_conv_affine_act_tf32_narrow(const float* x, const float* wt,
                                              const float* a, const float* b,
                                              void* y, int n, int h, int w,
                                              int cin, int cout, int ldb,
                                              int act, float leak,
                                              int out_f32, void* stream) {
  ConvN<float> L;
  if (!make_narrow(x, wt, a, b, n, h, w, cin, cout, ldb, act, leak, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      out_f32 ? run_narrow_tf32(L, static_cast<float*>(y), s)
              : run_narrow_tf32(L, static_cast<tg::sm90::bf16*>(y), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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
