// Fused ConvTranspose2d(k=4, s=2, p=1) + per-channel affine + activation.
//
// Replaces: tpugan/ops/pallas_convt.py `_kernel` / `_dispatch`
// (`convt_affine_act`, and the bare hook `conv_transpose2d`).
//
// What bounds it on an H100: at the generator's wide layers (batch 256, Cin
// and Cout 64..512) a layer does 2*N*H*W*16*Cin*Cout operations on a few MB,
// far above the 295 operations per byte where the tensor cores, not the
// memory, become the limit: bf16 tensor-core throughput (989 TFLOP/s
// dense).  The final RGB layer (Cout = 3) does 1.6 GFLOP on 40 MB: bytes.
//
// What the design does about it: the transpose conv is four dense implicit
// GEMMs, one per output parity phase (rows = coarse positions, depth = 4
// taps x Cin), so no multiply is spent on the zeros a dilated-input
// lowering inserts.  Both kernels run on the Hopper mainloop of
// igemm_sm90.cuh (TMA into a swizzled shared-memory ring, one producer
// warp, two wgmma consumer warpgroups):
//
//   - convt_wide (Cout > 8): one block is a 128 x BN tile of one phase
//     (grid y = phase); each stage is one tap x 64 channels, the tap's
//     shift the TMA box's start.  The four phases' blocks re-read their
//     shifted windows of x, which L2 absorbs; holding all four phases'
//     accumulators in one block would not fit the registers at BN = 128.
//     The epilogue applies y * a[c] + b[c] and the activation to the
//     accumulators in registers and leaves through shared memory as 16-byte
//     row vectors into the interleaved (N, 2H, 2W, Cout) layout.
//   - convt_narrow (Cout <= 8, the RGB layer): one block computes all four
//     phases of 128 coarse positions.  Each of the 9 distinct shifted
//     windows of x is loaded once and multiplied by every (phase, tap) that
//     reads it (16 products over 9 windows) with m64n8k16 wgmma, B padded
//     to 8 columns in shared memory, where the whole weight stays.  The
//     output tile is written pixel-major, consecutive threads on
//     consecutive bytes.  The blocks are persistent (as many as fit on the
//     card, each walking tiles), so the weight is staged once a block and
//     the ring loads the next tile's windows during an epilogue.
#include <cuda_runtime.h>

#include <algorithm>

#include "igemm_sm90.cuh"

namespace {

using namespace tg::sm90;

// One layer as the kernels see it: x (n, h, w, cin) bf16 with cin % 8 == 0;
// w (4, 4, cin, ldb) bf16 HWIO; a, b (cout,) f32.
struct ConvT {
  Box box;  // the input grid: one GEMM row per coarse position
  int cin, kc, cout, ldb;
  const float* a;
  const float* b;
  int act;
  float leak;
};

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

template <int BN, int STAGES>
using WideRing = Ring<STAGES, BN * kRowBytes>;

template <int BN, int STAGES, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
convt_wide(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap wmap, ConvT L, OutT* y) {
  const WideRing<BN, STAGES> R{smem_base()};
  const int tiles_n = (L.cout + BN - 1) / BN;
  const int tm = blockIdx.x / tiles_n, n0 = (blockIdx.x - tm * tiles_n) * BN;
  const int di = blockIdx.y >> 1, dj = blockIdx.y & 1;
  int img0, i0, j0;
  L.box.origin(tm, img0, i0, j0);
  const int steps = 4 * L.kc;
  if (threadIdx.x == 0) R.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const uint32_t bytes = (L.box.rows() + BN) * kRowBytes;
      produce(R, 0, steps, bytes, [&](int k, int slot, uint64_t* bar) {
        const int t = k / L.kc, c = (k - t * L.kc) * kBK;
        int kh, oh, kw, ow;
        tap(di, t >> 1, kh, oh);
        tap(dj, t & 1, kw, ow);
        tma_4d(R.a(slot), &xmap, bar, c, j0 + ow, i0 + oh, img0);
        const int row = (kh * 4 + kw) * L.cin + c;
#pragma unroll
        for (int h = 0; h < BN / kBK; ++h)
          tma_2d(R.b(slot) + h * kBK * kRowBytes, &wmap, bar, n0 + h * kBK,
                 row);
      });
    }
    return;
  }

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  consume(R, 0, steps, acc, [&](int, int slot) {
    mma_stage<BN>(acc, desc_kmajor(R.a(slot) + wg * (kATile / 2)),
                  desc_nmajor(R.b(slot)));
  });

  // epilogue: affine + activation in registers, a and b once per column
#pragma unroll
  for (int jb = 0; jb < BN / 8; ++jb) {
    const int c = n0 + 8 * jb + 2 * (lane & 3);
    const float a0 = c < L.cout ? L.a[c] : 0.f, b0 = c < L.cout ? L.b[c] : 0.f;
    const float a1 = c + 1 < L.cout ? L.a[c + 1] : 0.f;
    const float b1 = c + 1 < L.cout ? L.b[c + 1] : 0.f;
    acc[4 * jb] = apply_act(fmaf(acc[4 * jb], a0, b0), L.act, L.leak);
    acc[4 * jb + 1] = apply_act(fmaf(acc[4 * jb + 1], a1, b1), L.act, L.leak);
    acc[4 * jb + 2] = apply_act(fmaf(acc[4 * jb + 2], a0, b0), L.act, L.leak);
    acc[4 * jb + 3] = apply_act(fmaf(acc[4 * jb + 3], a1, b1), L.act, L.leak);
  }
  named_sync(1, kConsumers);  // every product is done: the ring is free
  float* stage = reinterpret_cast<float*>(R.base) + wg * kStageFloats<BN>;
  const int h2 = 2 * L.box.h, w2 = 2 * L.box.w;
  store_tile<BN>(acc, stage, y, n0, L.cout, wg, [&](int r) -> long long {
    int img, i, j;
    if (!L.box.at(64 * wg + r, img0, i0, j0, img, i, j)) return -1;
    return ((static_cast<long long>(img) * h2 + 2 * i + di) * w2 + 2 * j +
            dj) * L.cout;
  });
}

constexpr int kNarrowStages = 4;
constexpr int kNarrowMaxChunks = 8;  // the whole weight in shared memory
constexpr int kAtom = 8 * kRowBytes;  // B of one (tap, chunk): 8 x 64, 1 KB
constexpr int kNarrowStage = kBM * 4 * 8 * 4;  // epilogue tile, 16 KB
using NarrowRing = Ring<kNarrowStages, 0>;

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
convt_narrow(const __grid_constant__ CUtensorMap xmap, ConvT L,
             const tg::sm90::bf16* w, OutT* y) {
  unsigned char* bs = smem_base();  // [16 taps][kc] K-major atoms
  float* st = reinterpret_cast<float*>(bs + 16 * L.kc * kAtom);
  const NarrowRing R{bs + 16 * L.kc * kAtom + kNarrowStage};

  // the weight, Cout padded to 8 with zeros, K-major with the 128-byte
  // swizzle (16-byte chunk k / 8 of row n at chunk (k / 8) ^ n)
  for (int e = threadIdx.x; e < 16 * L.kc * 512; e += kThreads) {
    const int atom = e >> 9, k = (e >> 3) & 63, n = e & 7;
    const int t = atom / L.kc, c = (atom - t * L.kc) * kBK + k;
    tg::sm90::bf16 v = __float2bfloat16(0.f);
    if (n < L.cout && c < L.cin)
      v = w[(static_cast<long long>(t) * L.cin + c) * L.ldb + n];
    *reinterpret_cast<tg::sm90::bf16*>(bs + atom * kAtom + n * kRowBytes +
                                       (((k >> 3) ^ n) << 4) + (k & 7) * 2) = v;
  }
  fence_async_shared();
  if (threadIdx.x == 0) R.init();
  __syncthreads();

  // the block's tiles: blockIdx.x, + gridDim.x, ...; the ring runs on from
  // one tile to the next, so the next tile's windows load during this
  // tile's epilogue
  const int steps = 9 * L.kc;  // window s = 3 (oh + 1) + (ow + 1), chunk
  const int tiles = (L.box.tiles() - blockIdx.x + gridDim.x - 1) / gridDim.x;
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      for (int it = 0; it < tiles; ++it) {
        int img0, i0, j0;
        L.box.origin(blockIdx.x + it * gridDim.x, img0, i0, j0);
        produce(R, it * steps, steps, L.box.rows() * kRowBytes,
                [&](int k, int slot, uint64_t* bar) {
                  const int s = k / L.kc, c = (k - s * L.kc) * kBK;
                  tma_4d(R.a(slot), &xmap, bar, c, j0 + s % 3 - 1,
                         i0 + s / 3 - 1, img0);
                });
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int wp = t >> 5, lane = t & 31;
  // affine per channel: this thread's two columns
  const int c = 2 * (lane & 3);
  const float a0 = c < L.cout ? L.a[c] : 0.f, b0 = c < L.cout ? L.b[c] : 0.f;
  const float a1 = c + 1 < L.cout ? L.a[c + 1] : 0.f;
  const float b1 = c + 1 < L.cout ? L.b[c + 1] : 0.f;
  const int bh = L.box.bh, bw = L.box.bw, cout = L.cout;
  const int row_elems = 2 * bw * cout, img_elems = 2 * bh * row_elems;
  const int h2 = 2 * L.box.h, w2 = 2 * L.box.w;
  for (int it = 0; it < tiles; ++it) {
    int img0, i0, j0;
    L.box.origin(blockIdx.x + it * gridDim.x, img0, i0, j0);
    float acc[4][4];  // phase p = 2 di + dj
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;
    consume(R, it * steps, steps, acc, [&](int k, int slot) {
      const int s = k / L.kc, ch = k - s * L.kc;
      const int oh = s / 3 - 1, ow = s % 3 - 1;
      const uint64_t da = desc_kmajor(R.a(slot) + wg * (kATile / 2));
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int kh = tap_at(p >> 1, oh), kw = tap_at(p & 1, ow);
        if (kh >= 0 && kw >= 0) {
          const uint64_t db =
              desc_kmajor(bs + ((kh * 4 + kw) * L.kc + ch) * kAtom);
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_m64n8<0>(acc[p], da + 2 * kk, db + 2 * kk);
        }
      }
    });

    // affine + activation in registers; stage [row][phase][8 channels]
    named_sync(1, kConsumers);  // the last tile's write-out has read st
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 64 * wg + frag_row(wp, lane, e);
        const float v = (e & 1) ? fmaf(acc[p][e], a1, b1)
                                : fmaf(acc[p][e], a0, b0);
        st[(r * 4 + p) * 8 + c + (e & 1)] = apply_act(v, L.act, L.leak);
      }
    named_sync(1, kConsumers);

    // out pixel (2 i + di, 2 j + dj) of the tile, channels innermost
    for (int e = threadIdx.x; e < L.box.bn * img_elems; e += kConsumers) {
      const int nl = e / img_elems, rem = e - nl * img_elems;
      const int oy = rem / row_elems, rem2 = rem - oy * row_elems;
      const int ox = rem2 / cout, ch = rem2 - ox * cout;
      const int img = img0 + nl, i = i0 + (oy >> 1), j = j0 + (ox >> 1);
      if (img < L.box.n && i < L.box.h && j < L.box.w) {
        const int r = (nl * bh + (oy >> 1)) * bw + (ox >> 1);
        const int p = 2 * (oy & 1) + (ox & 1);
        store1(y + ((static_cast<long long>(img) * h2 + 2 * i0 + oy) * w2 +
                    2 * j0 + ox) * cout + ch,
               st[(r * 4 + p) * 8 + ch]);
      }
    }
  }
}

template <typename OutT>
int run(const void* x, const void* wt, const float* a, const float* b,
        void* y, int n, int h, int w, int cin, int cout, int ldb, int act,
        float leak, cudaStream_t s) {
  ConvT L;
  L.box = make_box(n, h, w);
  L.cin = cin;
  L.kc = (cin + kBK - 1) / kBK;
  L.cout = cout;
  L.ldb = ldb;
  L.a = a;
  L.b = b;
  L.act = act;
  L.leak = leak;
  CUtensorMap xmap, wmap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {2ull * cin, 2ull * cin * w,
                                 2ull * cin * w * h};
  const cuuint32_t box[4] = {kBK, static_cast<cuuint32_t>(L.box.bw),
                             static_cast<cuuint32_t>(L.box.bh),
                             static_cast<cuuint32_t>(L.box.bn)};
  if (!encode_bf16(&xmap, x, 4, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  OutT* out = static_cast<OutT*>(y);
  cudaError_t e;
  if (cout <= 8 && L.kc <= kNarrowMaxChunks) {
    // persistent: as many blocks as fit on the card at once
    const int smem =
        16 * L.kc * kAtom + kNarrowStage + NarrowRing::kBytes + 1024;
    int resident = 0;
    e = kernel_setup(reinterpret_cast<const void*>(convt_narrow<OutT>), smem,
                     &resident);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int blocks = std::min(L.box.tiles(), resident);
    e = launch(convt_narrow<OutT>, dim3(blocks), smem, 1, s, xmap, L,
               static_cast<const tg::sm90::bf16*>(wt), out);
  } else {
    if (ldb % 8 != 0 || ldb < cout ||
        !encode_weight(&wmap, wt, 16ll * cin, ldb))
      return static_cast<int>(cudaErrorInvalidValue);
    if (cout >= 128) {
      constexpr int BN = 128, ST = 3;
      e = launch(convt_wide<BN, ST, OutT>,
                 dim3(L.box.tiles() * ((cout + BN - 1) / BN), 4),
                 WideRing<BN, ST>::kBytes + 1024, 1, s, xmap, wmap, L, out);
    } else {
      constexpr int BN = 64, ST = 4;
      e = launch(convt_wide<BN, ST, OutT>,
                 dim3(L.box.tiles() * ((cout + BN - 1) / BN), 4),
                 WideRing<BN, ST>::kBytes + 1024, 1, s, xmap, wmap, L, out);
    }
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (n, h, w, cin) bf16 with cin % 8 == 0, 16-byte aligned; wt (4, 4, cin,
// ldb) bf16 (ldb >= cout; ldb % 8 == 0 and 16-byte aligned unless cout <= 8
// and cin <= 512), a/b (cout,) f32; y (n, 2h, 2w, cout) bf16 (out_f32 = 0)
// or f32 (out_f32 = 1).
extern "C" int tg_convt_affine_act(const void* x, const void* wt,
                                   const float* a, const float* b, void* y,
                                   int n, int h, int w, int cin, int cout,
                                   int ldb, int act, float leak, int out_f32,
                                   void* stream) {
  if (n < 1 || h < 1 || w < 1 || cin < 8 || cin % 8 != 0 || cout < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? run<float>(x, wt, a, b, y, n, h, w, cin, cout, ldb, act,
                              leak, s)
                 : run<tg::sm90::bf16>(x, wt, a, b, y, n, h, w, cin, cout,
                                       ldb, act, leak, s);
}
