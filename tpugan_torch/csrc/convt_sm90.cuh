// ConvTranspose2d(k=4, s=2, p=1) tiles on the Hopper mainloop, shared by the
// per-layer kernels (cuda_convt.cu) and the persistent generator walk
// (gen_sm90.cuh): the tap tables, the producer's copies of a wide tile (one
// parity phase, one tap x 64 channels a stage; on fp32 operands one tap x
// 32 channels), and the four-phase narrow tile for few output channels
// (its weight in shared memory, its products over the 9 shifted windows,
// its pixel-major write-out, shared with the fp32 narrow tile).
#pragma once

#include "igemm_sm90.cuh"

namespace tg {
namespace sm90 {

// TAPS[d][t] of ops/kernel_common.py: output parity d reads kernel row k at
// input offset o.
__device__ __forceinline__ void tap(int d, int t, int& k, int& o) {
  if (d == 0) {
    k = t ? 3 : 1;
    o = t ? -1 : 0;
  } else {
    k = t ? 2 : 0;
    o = t ? 0 : 1;
  }
}

// The kernel row of parity d that reads input offset o, or -1.
__device__ __forceinline__ int tap_at(int d, int o) {
  if (d == 0) return o == 0 ? 1 : (o == -1 ? 3 : -1);
  return o == 1 ? 0 : (o == 0 ? 2 : -1);
}

// The copies of stage k (tap k / kc, channels (k % kc) * 64 ..) of a wide
// tile of phase (di, dj) at box origin (img0, i0, j0): the tap's shifted box
// of x (a 4-D map (cin, w, h, n)) into slot a, and nb 64-column boxes of the
// weight rows, from column n0, into slot b.
__device__ __forceinline__ void convt_wide_load(
    unsigned char* a, unsigned char* b, const CUtensorMap* xmap,
    const CUtensorMap* wmap, uint64_t* bar, int k, int kc, int cin, int di,
    int dj, int img0, int i0, int j0, int n0, int nb) {
  const int t = k / kc, c = (k - t * kc) * kBK;
  int kh, oh, kw, ow;
  tap(di, t >> 1, kh, oh);
  tap(dj, t & 1, kw, ow);
  tma_4d(a, xmap, bar, c, j0 + ow, i0 + oh, img0);
  const int row = (kh * 4 + kw) * cin + c;
  for (int h = 0; h < nb; ++h)
    tma_2d(b + h * kBK * kRowBytes, wmap, bar, n0 + h * kBK, row);
}

// The copies of stage k of a wide tile on fp32 operands (tap k / kc,
// channels (k % kc) * 32 ..): the tap's shifted box of fp32 x into slot a,
// and the split weight's two planes (a 3-D map over (2, cout, 16 cin),
// boxes of bn rows from row n0) into b and b + bn rows.
__device__ __forceinline__ void convt_tf32_load(
    unsigned char* a, unsigned char* b, const CUtensorMap* xmap,
    const CUtensorMap* wmap, uint64_t* bar, int k, int kc, int cin, int di,
    int dj, int img0, int i0, int j0, int n0, int bn) {
  const int t = k / kc, c = (k - t * kc) * kBK32;
  int kh, oh, kw, ow;
  tap(di, t >> 1, kh, oh);
  tap(dj, t & 1, kw, ow);
  tma_4d(a, xmap, bar, c, j0 + ow, i0 + oh, img0);
  const int row = (kh * 4 + kw) * cin + c;
  tma_3d(b, wmap, bar, row, n0, 0);
  tma_3d(b + bn * kRowBytes, wmap, bar, row, n0, 1);
}

constexpr int kAtom = 8 * kRowBytes;  // narrow B of one (tap, chunk): 1 KB
constexpr int kNarrowStage = kBM * 4 * 8 * 4;  // narrow epilogue tile, 16 KB

// A narrow layer's weight (4, 4, cin, ldb) into bs as [16 taps][kc chunks]
// K-major atoms, Cout padded to 8 with zeros, with the 128-byte swizzle
// (16-byte chunk k / 8 of row n at chunk (k / 8) ^ n); by `threads` threads
// from `tid`.  The caller fences (fence_async_shared) and synchronises.
__device__ __forceinline__ void narrow_weight(unsigned char* bs,
                                              const bf16* w, int kc, int cin,
                                              int cout, int ldb, int tid,
                                              int threads) {
  for (int e = tid; e < 16 * kc * 512; e += threads) {
    const int atom = e >> 9, k = (e >> 3) & 63, n = e & 7;
    const int t = atom / kc, c = (atom - t * kc) * kBK + k;
    bf16 v = __float2bfloat16(0.f);
    if (n < cout && c < cin)
      v = w[(static_cast<long long>(t) * cin + c) * ldb + n];
    *reinterpret_cast<bf16*>(bs + atom * kAtom + n * kRowBytes +
                             (((k >> 3) ^ n) << 4) + (k & 7) * 2) = v;
  }
}

// The copy of stage k of a narrow tile: window s = k / kc of the 9 shifted
// windows (s = 3 (oh + 1) + (ow + 1)), channel chunk k % kc.
__device__ __forceinline__ void narrow_load(unsigned char* a,
                                            const CUtensorMap* xmap,
                                            uint64_t* bar, int k, int kc,
                                            int img0, int i0, int j0) {
  const int s = k / kc, c = (k - s * kc) * kBK;
  tma_4d(a, xmap, bar, c, j0 + s % 3 - 1, i0 + s / 3 - 1, img0);
}

// The products of stage k of a narrow tile: window s times every (phase,
// tap) that reads it, m64n8k16 against the weight atoms in bs; acc[p] is
// phase p = 2 di + dj.
__device__ __forceinline__ void narrow_mma(float (&acc)[4][4], uint64_t da,
                                           const unsigned char* bs, int k,
                                           int kc) {
  const int s = k / kc, ch = k - s * kc;
  const int oh = s / 3 - 1, ow = s % 3 - 1;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int kh = tap_at(p >> 1, oh), kw = tap_at(p & 1, ow);
    if (kh >= 0 && kw >= 0) {
      const uint64_t db = desc_kmajor(bs + ((kh * 4 + kw) * kc + ch) * kAtom);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_m64n8<0>(acc[p], da + 2 * kk, db + 2 * kk);
    }
  }
}

// v rounded to the nearest bf16 (ties to even), kept as a float.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The write-out of a narrow tile's staged outputs st ([row][phase][8
// channels]) by the 256 consumer threads: the tile's output pixels
// pixel-major, consecutive threads on consecutive elements; pixel(img, H,
// W) is the element offset of output pixel (H, W) of image img.
template <typename OutT, class Pixel>
__device__ __forceinline__ void narrow_write(const float* st, const Box& box,
                                             int img0, int i0, int j0,
                                             int cout, OutT* y, Pixel pixel) {
  // out pixel (2 i + di, 2 j + dj) of the tile, channels innermost
  const int bh = box.bh, bw = box.bw;
  const int row_elems = 2 * bw * cout, img_elems = 2 * bh * row_elems;
  for (int e = threadIdx.x; e < box.bn * img_elems; e += kConsumers) {
    const int nl = e / img_elems, rem = e - nl * img_elems;
    const int oy = rem / row_elems, rem2 = rem - oy * row_elems;
    const int ox = rem2 / cout, ch = rem2 - ox * cout;
    const int img = img0 + nl, i = i0 + (oy >> 1), j = j0 + (ox >> 1);
    if (img < box.n && i < box.h && j < box.w) {
      const int r = (nl * bh + (oy >> 1)) * bw + (ox >> 1);
      const int p = 2 * (oy & 1) + (ox & 1);
      store1(y + pixel(img, 2 * i0 + oy, 2 * j0 + ox) + ch,
             st[(r * 4 + p) * 8 + ch]);
    }
  }
}

// A narrow tile's epilogue, by the 256 consumer threads: affine + activation
// of acc into st ([row][phase][8 channels], kNarrowStage bytes), each value
// rounded to bf16 first where kRoundBf16 (an fp32 output holding bf16
// values), then narrow_write.
template <typename OutT, bool kRoundBf16 = false, class Pixel>
__device__ __forceinline__ void narrow_store(
    const float (&acc)[4][4], float* st, const Box& box, int img0, int i0,
    int j0, const float* a, const float* b, int cout, int act, float leak,
    OutT* y, Pixel pixel) {
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int wp = t >> 5, lane = t & 31;
  const int c = 2 * (lane & 3);  // this thread's two columns
  const float a0 = c < cout ? a[c] : 0.f, b0 = c < cout ? b[c] : 0.f;
  const float a1 = c + 1 < cout ? a[c + 1] : 0.f;
  const float b1 = c + 1 < cout ? b[c + 1] : 0.f;
  named_sync(1, kConsumers);  // the last tile's write-out has read st
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 64 * wg + frag_row(wp, lane, e);
      const float v =
          (e & 1) ? fmaf(acc[p][e], a1, b1) : fmaf(acc[p][e], a0, b0);
      const float o = apply_act(v, act, leak);
      st[(r * 4 + p) * 8 + c + (e & 1)] = kRoundBf16 ? round_bf16(o) : o;
    }
  named_sync(1, kConsumers);
  narrow_write(st, box, img0, i0, j0, cout, y, pixel);
}

// The epilogue of a narrow tile on fp32 operands, whose m64n16 sums hold
// column 4 p + o for phase p and channel o < 4: affine + activation into
// st, then narrow_write.
template <typename OutT, class Pixel>
__device__ __forceinline__ void narrow16_store(
    const float (&acc)[8], float* st, const Box& box, int img0, int i0,
    int j0, const float* a, const float* b, int cout, int act, float leak,
    OutT* y, Pixel pixel) {
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int wp = t >> 5, lane = t & 31;
  named_sync(1, kConsumers);  // the last tile's write-out has read st
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int r = 64 * wg + frag_row(wp, lane, e), col = frag_col(lane, e);
    const int p = col >> 2, o = col & 3;
    if (o < cout)
      st[(r * 4 + p) * 8 + o] =
          apply_act(fmaf(acc[e], a[o], b[o]), act, leak);
  }
  named_sync(1, kConsumers);
  narrow_write(st, box, img0, i0, j0, cout, y, pixel);
}

}  // namespace sm90
}  // namespace tg
