// One output tile of the strided Conv2d(k=4, s=2, p=1), shared by the two
// discriminator kernels (cuda_conv.cu, cuda_conv_stats.cu).
//
// Math: out[img, i, j, :] = sum over taps (kh, kw) of
//   x[img, 2i+kh-1, 2j+kw-1, :] @ W[kh, kw]
// as one implicit GEMM: rows m = output positions (img, i, j), columns =
// output channels, depth k = tap * Cin + ci with tap = kh * 4 + kw, so the
// HWIO weight (4, 4, Cin, Cout) is already the (16 Cin, Cout) B matrix.
//
// Per tile the block first writes a row table to shared memory: for each row
// and each of the 16 taps, the element offset of its input pixel, or -1
// outside the image, so the zero padding is a bounds test and the parity
// planes the TPU kernel builds outside its kernel are address arithmetic.
// The depth loop stages A (BM x 32) and B (32 x BN) through shared memory and
// multiplies with bf16 WMMA (16x16x16, fp32 accumulate; the step and the
// accumulator store are convt_tile.cuh's mma_step/store_acc); a 32-deep step that
// runs past the depth (Cin = 3: depth 48) is zero-filled.  Where Cin is a
// multiple of 32 a step lies inside one tap and each row's 32 channels are
// 64 contiguous bytes, staged with 16-byte loads; likewise B rows when Cout is
// a multiple of 8.  The tile ends with the fp32 sums in shared memory, for
// the caller's epilogue.
#pragma once

#include <stdint.h>

#include "convt_tile.cuh"

namespace tg {

// One Conv(4, 2, 1) layer: x (n, h, w_, cin) NHWC bf16, h and w_ even;
// w (4, 4, cin, cout) HWIO bf16.  Output (n, h/2, w_/2, cout).
struct Conv421 {
  const bf16* x;
  const bf16* w;
  int n, h, w_, cin, cout;
  bool vec_a;  // cin % kBK == 0 and x 16-byte aligned
  bool vec_b;  // cout % 8 == 0 and w 16-byte aligned
};

constexpr int kCBM = 64;   // tile rows (output positions)
constexpr int kCBN = 64;   // tile columns (output channels)
constexpr int kCLDA = kBK + 8;
constexpr int kCLDB = kCBN + 8;
constexpr int kCLDC = kCBN + 4;
constexpr int kConvRowBytes = 16 * kCBM * 8;
constexpr int kConvTileBytes = kCBM * kCLDC * 4;  // >= A + B staging
constexpr int kConvSmemBytes = kConvRowBytes + kConvTileBytes;
static_assert((kCBM * kCLDA + kBK * kCLDB) * 2 <= kConvTileBytes, "smem");

inline Conv421 make_conv421(const void* x, const void* w, int n, int h,
                            int wd, int cin, int cout) {
  Conv421 L;
  L.x = static_cast<const bf16*>(x);
  L.w = static_cast<const bf16*>(w);
  L.n = n;
  L.h = h;
  L.w_ = wd;
  L.cin = cin;
  L.cout = cout;
  L.vec_a = cin % kBK == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  L.vec_b = cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  return L;
}

inline bool conv421_ok(int n, int h, int w, int cin, int cout) {
  return n >= 1 && h >= 2 && w >= 2 && h % 2 == 0 && w % 2 == 0 && cin >= 1 &&
         cout >= 1;
}

__host__ __device__ inline int conv421_rows(const Conv421& L) {
  return L.n * (L.h / 2) * (L.w_ / 2);
}

// Compute tile (m0, n0); returns the fp32 sums, (kCBM x kCLDC) in shared
// memory, valid until the caller's next __syncthreads.  Must be called by
// all kThreads threads of the block.
__device__ inline const float* conv421_tile(const Conv421& L, int m0, int n0,
                                            unsigned char* smem) {
  constexpr int WN = 2, FM = 2, FN = 2;  // 2x2 warps, 32x32 each
  long long* rows = reinterpret_cast<long long*>(smem);  // [16][kCBM]
  unsigned char* tiles = smem + kConvRowBytes;
  bf16* As = reinterpret_cast<bf16*>(tiles);
  bf16* Bs = As + kCBM * kCLDA;
  float* Cs = reinterpret_cast<float*>(tiles);  // aliases As/Bs

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int ho = L.h / 2, wo = L.w_ / 2, hw = ho * wo;
  const int M = conv421_rows(L);

  for (int e = tid; e < 16 * kCBM; e += kThreads) {
    const int t = e / kCBM, r = e - t * kCBM;
    const int m = m0 + r;
    long long off = -1;
    if (m < M) {
      const int img = m / hw, rem = m - img * hw;
      const int i = rem / wo, j = rem - i * wo;
      const int ih = 2 * i + (t >> 2) - 1, iw = 2 * j + (t & 3) - 1;
      if (ih >= 0 && ih < L.h && iw >= 0 && iw < L.w_)
        off = ((long long)(img * L.h + ih) * L.w_ + iw) * L.cin;
    }
    rows[e] = off;
  }
  __syncthreads();

  AccFrag acc[FM][FN];
  zero_acc(acc);

  const int K = 16 * L.cin;
  const bf16 zero = __float2bfloat16(0.f);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    if (L.vec_a) {
      // the whole step lies in tap t, channels c0 .. c0+31
      const int t = k0 / L.cin, c0 = k0 - t * L.cin;
      for (int e = tid; e < kCBM * (kBK / 8); e += kThreads) {
        const int r = e / (kBK / 8), q = e - r * (kBK / 8);
        const long long off = rows[t * kCBM + r];
        uint4 v = make_uint4(0, 0, 0, 0);
        if (off >= 0) v = *reinterpret_cast<const uint4*>(L.x + off + c0 + q * 8);
        *reinterpret_cast<uint4*>(As + r * kCLDA + q * 8) = v;
      }
    } else {
      for (int e = tid; e < kCBM * kBK; e += kThreads) {
        const int r = e / kBK, kk = e - r * kBK, k = k0 + kk;
        bf16 v = zero;
        if (k < K) {
          const int t = k / L.cin, c = k - t * L.cin;
          const long long off = rows[t * kCBM + r];
          if (off >= 0) v = L.x[off + c];
        }
        As[r * kCLDA + kk] = v;
      }
    }
    if (L.vec_b) {
      for (int e = tid; e < kBK * (kCBN / 8); e += kThreads) {
        const int kk = e / (kCBN / 8), q = e - kk * (kCBN / 8);
        const int k = k0 + kk, n = n0 + q * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (k < K && n < L.cout)
          v = *reinterpret_cast<const uint4*>(L.w + (long long)k * L.cout + n);
        *reinterpret_cast<uint4*>(Bs + kk * kCLDB + q * 8) = v;
      }
    } else {
      for (int e = tid; e < kBK * kCBN; e += kThreads) {
        const int kk = e / kCBN, c = e - kk * kCBN;
        const int k = k0 + kk, n = n0 + c;
        Bs[kk * kCLDB + c] =
            (k < K && n < L.cout) ? L.w[(long long)k * L.cout + n] : zero;
      }
    }
    __syncthreads();
    mma_step<FM, FN, kCLDA, kCLDB>(acc, As, Bs, wm, wn);
    __syncthreads();
  }

  store_acc<FM, FN, kCLDC>(Cs, acc, wm, wn);
  __syncthreads();
  return Cs;
}

}  // namespace tg
