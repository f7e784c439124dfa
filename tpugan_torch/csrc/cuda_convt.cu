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
// warp, two wgmma consumer warpgroups), with the tiles of convt_sm90.cuh
// that megakernel v2 shares:
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
//
// fp32 operands (train.precision="fp32"): tg_convt_affine_act_f32 runs the
// same four phase GEMMs on the FFMA mainloop of igemm_f32.cuh (one launch,
// a grid row per phase; any Cin and Cout, operands as they are) with the
// same affine + activation epilogue.
#include <cuda_runtime.h>

#include <algorithm>

#include "convt_sm90.cuh"
#include "igemm_f32.cuh"

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
        convt_wide_load(R.a(slot), R.b(slot), &xmap, &wmap, bar, k, L.kc,
                        L.cin, di, dj, img0, i0, j0, n0, BN / kBK);
      });
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  consume(R, 0, steps, acc, [&](int, int slot) {
    mma_stage<BN>(acc, desc_kmajor(R.a(slot) + wg * (kATile / 2)),
                  desc_nmajor(R.b(slot)));
  });

  // epilogue: affine + activation in registers, a and b once per column
  affine_act<BN>(acc, n0, L.a, L.b, L.cout, L.act, L.leak);
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
using NarrowRing = Ring<kNarrowStages, 0>;

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
convt_narrow(const __grid_constant__ CUtensorMap xmap, ConvT L,
             const tg::sm90::bf16* w, OutT* y) {
  unsigned char* bs = smem_base();  // [16 taps][kc] K-major atoms
  float* st = reinterpret_cast<float*>(bs + 16 * L.kc * kAtom);
  const NarrowRing R{bs + 16 * L.kc * kAtom + kNarrowStage};

  narrow_weight(bs, w, L.kc, L.cin, L.cout, L.ldb, threadIdx.x, kThreads);
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
                  narrow_load(R.a(slot), &xmap, bar, k, L.kc, img0, i0, j0);
                });
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  const int h2 = 2 * L.box.h, w2 = 2 * L.box.w, cout = L.cout;
  for (int it = 0; it < tiles; ++it) {
    int img0, i0, j0;
    L.box.origin(blockIdx.x + it * gridDim.x, img0, i0, j0);
    float acc[4][4];  // phase p = 2 di + dj
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;
    consume(R, it * steps, steps, acc, [&](int k, int slot) {
      narrow_mma(acc, desc_kmajor(R.a(slot) + wg * (kATile / 2)), bs, k,
                 L.kc);
    });
    narrow_store(acc, st, L.box, img0, i0, j0, L.a, L.b, cout, L.act, L.leak,
                 y, [&](int img, int oy, int ox) -> long long {
                   return ((static_cast<long long>(img) * h2 + oy) * w2 +
                           ox) * cout;
                 });
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

// x (n, h, w, cin) fp32, wt (4, 4, cin, ldb) fp32 (ldb >= cout; any cin and
// cout >= 1, any alignment), a/b (cout,) f32 -> y (n, 2h, 2w, cout) bf16
// (out_f32 = 0) or f32 (out_f32 = 1): fp32 products, fp32 sums.
extern "C" int tg_convt_affine_act_f32(const float* x, const float* wt,
                                       const float* a, const float* b,
                                       void* y, int n, int h, int w, int cin,
                                       int cout, int ldb, int act, float leak,
                                       int out_f32, void* stream) {
  const tg::f32::Gemm G = tg::f32::convt_gemm(x, wt, n, h, w, cin, cout, ldb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      out_f32 ? tg::f32::run_affine_act(G, 4, a, b, act, leak,
                                        static_cast<float*>(y), s)
              : tg::f32::run_affine_act(G, 4, a, b, act, leak,
                                        static_cast<tg::sm90::bf16*>(y), s));
}
