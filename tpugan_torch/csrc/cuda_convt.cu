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
// fp32 operands (train.precision="fp32"): the same function on fp32 x and
// w with fp32 sums (tpugan/ops/pallas_convt.py:108 `_dispatch` on fp32
// operands).  What bounds it: the products of the generator's wide layers
// (53.1 GFLOP over the four layers at batch 256), which no tensor-core type
// takes as fp32 (FFMA on the CUDA cores: 0.79 ms at 67 TFLOP/s), and the
// RGB layer's ~80 MB of bytes.  What the design does about it:
// tg_convt_affine_act_tf32 runs the products on the tensor cores in three
// TF32 passes over split operands (each operand big + small; big x big +
// big x small + small x big summed in fp32 carry ~22 bits an operand,
// under fp32's sum-order noise; a bound of 0.322 ms), one launch for the
// four phases as before:
//
//   - convt_tf32 (Cout > 4): convt_wide at 32 fp32 channels a stage, its A
//     rows split in registers (consume_f32: every 4 stages' sums added into
//     the running sums in fp32, as the tensor cores' accumulation
//     truncates), B from the weight split once a call into its two parts,
//     K-major (split_weight_tf32; tf32 wgmma reads B K-major only).  A
//     tile's four phases are neighbours in the grid, so they share their
//     windows of x in L2.
//   - convt_narrow_tf32 (Cout <= 4: the RGB and grey layers, Cin <= 64):
//     one block computes all four phases of a box as one GEMM of 16
//     columns over 9 windows x Cin (see there), x crossing L2 once a chunk
//     through the box's halo, the weight split into shared memory by the
//     block; persistent blocks.
//
// Shapes the route does not take (Cin not a multiple of 32) run
// tg_convt_affine_act_f32, the same four phase GEMMs on the FFMA mainloop
// of igemm_f32.cuh (a grid row per phase; any Cin and Cout, operands as
// they are) with the same affine + activation epilogue.
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

// The wide tile on fp32 operands: a 128 x BN tile of one phase (phase =
// blockIdx.x % 4, so a tile's four phases run side by side), one tap x 32
// channels a stage in three TF32 passes (consume_f32); the epilogue of
// convt_wide.
template <int BN, int STAGES, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
convt_tf32(const __grid_constant__ CUtensorMap xmap,
           const __grid_constant__ CUtensorMap wmap, ConvT L, OutT* y) {
  const Ring<STAGES, kF32BTile<BN>> R{smem_base()};
  const int tiles_n = (L.cout + BN - 1) / BN;
  const int ph = blockIdx.x & 3, rest = blockIdx.x >> 2;
  const int tm = rest / tiles_n, n0 = (rest - tm * tiles_n) * BN;
  const int di = ph >> 1, dj = ph & 1;
  int img0, i0, j0;
  L.box.origin(tm, img0, i0, j0);
  const int steps = 4 * L.kc;
  if (threadIdx.x == 0) R.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const uint32_t bytes = (L.box.rows() + 2 * BN) * kRowBytes;
      produce(R, 0, steps, bytes, [&](int k, int slot, uint64_t* bar) {
        convt_tf32_load(R.a(slot), R.b(slot), &xmap, &wmap, bar, k, L.kc,
                        L.cin, di, dj, img0, i0, j0, n0, BN);
      });
    }
    return;
  }

  const int wg = threadIdx.x >> 7;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  consume_f32<BN>(R, 0, steps, acc, wg);

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

// The narrow tile on fp32 operands (Cout <= 4: the RGB and grey layers):
// one block computes all four phases of a box of 128 coarse positions as
// one GEMM of 16 columns (column 4 p + o: phase p, channel o) and depth 9
// windows x Cin.  Window s = 3 (oh + 1) + (ow + 1) is x shifted by (oh,
// ow), and meets the taps of every phase that reads it (B is zero where a
// phase does not).  A stage is one 32-channel chunk of the box's halo (bn x
// (bh + 2) x (bw + 2) positions), one TMA load; the nine windows are row
// offsets into it, read into registers and split there, so x crosses L2
// once a chunk and not 16 times.  The split weight in that layout stays in
// shared memory (built once a block from w: no split pass), and the blocks
// are persistent, the ring running on from one tile to the next.
constexpr int kF32NarrowCout = 4;
constexpr int kF32NarrowChunks = 2;  // Cin <= 64: B is 36 KB a chunk
constexpr int kHaloMaxRows = 320;    // a 40 KB slot
constexpr int kHaloStages = 3;
constexpr int kWinAtom = 16 * kRowBytes;  // B of (window, chunk, part): 2 KB

__host__ __device__ inline int halo_rows(const Box& b) {
  return b.bn * (b.bh + 2) * (b.bw + 2);
}
__host__ __device__ inline int halo_slot(const Box& b) {
  return (halo_rows(b) * kRowBytes + 1023) / 1024 * 1024;
}

// w (4, 4, cin, ldb) fp32 as the narrow tile's B in bs: atom (s kc + c) 2
// + q is part q (TF32 part, rest) of window s and chunk c, 16 K-major rows
// (column 4 p + o) of 32 channels with the 128-byte swizzle; zero where
// phase p does not read window s or o >= cout.  By every thread.
__device__ __forceinline__ void narrow_weight_tf32(unsigned char* bs,
                                                   const float* w, int kc,
                                                   int cin, int cout,
                                                   int ldb) {
  for (int e = threadIdx.x; e < 9 * kc * 16 * kBK32; e += kThreads) {
    const int k = e & 31, n = (e >> 5) & 15, sc = e >> 9;
    const int s = sc / kc, c = sc - s * kc, p = n >> 2, o = n & 3;
    const int kh = tap_at(p >> 1, s / 3 - 1), kw = tap_at(p & 1, s % 3 - 1);
    float v = 0.f;
    if (kh >= 0 && kw >= 0 && o < cout)
      v = w[(static_cast<long long>(kh * 4 + kw) * cin + c * kBK32 + k) *
                ldb + o];
    const float big = tf32_rna(v);
    const int off = n * kRowBytes + (((k >> 2) ^ (n & 7)) << 4) + (k & 3) * 4;
    *reinterpret_cast<float*>(bs + 2 * sc * kWinAtom + off) = big;
    *reinterpret_cast<float*>(bs + (2 * sc + 1) * kWinAtom + off) =
        tf32_rna(v - big);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
convt_narrow_tf32(const __grid_constant__ CUtensorMap xmap, ConvT L,
                  const float* w, OutT* y) {
  const Box& B = L.box;
  unsigned char* bs = smem_base();  // [9 windows][kc chunks][2 parts]
  float* st = reinterpret_cast<float*>(bs + 18 * L.kc * kWinAtom);
  unsigned char* ring = bs + 18 * L.kc * kWinAtom + kNarrowStage;
  const int slot_bytes = halo_slot(B);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kHaloStages *
                                               slot_bytes);
  uint64_t* empty = full + kHaloStages;

  narrow_weight_tf32(bs, w, L.kc, L.cin, L.cout, L.ldb);
  fence_async_shared();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kHaloStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the block's tiles: blockIdx.x, + gridDim.x, ...; stage k = the k-th
  // (tile, chunk) of the block
  const int tiles = (B.tiles() - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int hw = B.bw + 2;
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      for (int it = 0, k = 0; it < tiles; ++it) {
        int img0, i0, j0;
        B.origin(blockIdx.x + it * gridDim.x, img0, i0, j0);
        for (int c = 0; c < L.kc; ++c, ++k) {
          const int slot = k % kHaloStages;
          mbar_wait(empty + slot, ((k / kHaloStages) & 1) ^ 1);
          mbar_expect_tx(full + slot, halo_rows(B) * kRowBytes);
          tma_4d(ring + slot * slot_bytes, &xmap, full + slot, c * kBK32,
                 j0 - 1, i0 - 1, img0);
        }
      }
    }
    return;
  }

  // this thread's fragment rows r0 and r0 + 8 as rows of the halo at window
  // (0, 0); rows past the box read its first interior row (never stored)
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int r0 = 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  int base[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = r0 + 8 * q, pb = B.bh * B.bw;
    const int a = r / pb, i = (r - a * pb) / B.bw, j = r - a * pb - i * B.bw;
    base[q] = r < B.rows() ? (a * (B.bh + 2) + i + 1) * hw + j + 1 : hw + 1;
  }
  const int h2 = 2 * B.h, w2 = 2 * B.w, cout = L.cout;
  for (int it = 0, k = 0; it < tiles; ++it) {
    int img0, i0, j0;
    B.origin(blockIdx.x + it * gridDim.x, img0, i0, j0);
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int c = 0; c < L.kc; ++c, ++k) {
      const int slot = k % kHaloStages;
      mbar_wait(full + slot, (k / kHaloStages) & 1);
      const unsigned char* a = ring + slot * slot_bytes;
      // the nine windows, two in flight: window s sums into part[s % 2],
      // added into acc (FADD) once its products are done
      float part[2][8];
      uint32_t big[2][4][4], small[2][4][4];
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const int q = s & 1, off = (s / 3 - 1) * hw + s % 3 - 1;
        load_split_a(a, base[0] + off, base[1] + off, big[q], small[q]);
        const unsigned char* b = bs + 2 * (s * L.kc + c) * kWinAtom;
        fence_acc(part[q]);
        fence_frag(big[q]);
        fence_frag(small[q]);
        wgmma_fence();
        mma_stage_3xtf32<16>(part[q], big[q], small[q], desc_kmajor(b),
                             desc_kmajor(b + kWinAtom));
        wgmma_commit();
        fence_acc(part[q]);
        wgmma_wait<1>();
        if (s > 0) {
          fence_acc(part[q ^ 1]);
          fence_frag(big[q ^ 1]);
          fence_frag(small[q ^ 1]);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] += part[q ^ 1][e];
        }
      }
      wgmma_wait<0>();
      fence_acc(part[0]);
      fence_frag(big[0]);
      fence_frag(small[0]);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += part[0][e];
      if (lane == 0) mbar_arrive(empty + slot);
    }
    narrow16_store(acc, st, B, img0, i0, j0, L.a, L.b, cout, L.act, L.leak,
                   y, [&](int img, int oy, int ox) -> long long {
                     return ((static_cast<long long>(img) * h2 + oy) * w2 +
                             ox) * cout;
                   });
  }
}

template <int BN, int STAGES, typename OutT>
cudaError_t launch_tf32(const CUtensorMap& xmap, const CUtensorMap& wmap,
                        const ConvT& L, OutT* y, cudaStream_t s) {
  const int grid = 4 * L.box.tiles() * ((L.cout + BN - 1) / BN);
  return launch(convt_tf32<BN, STAGES, OutT>, dim3(grid),
                Ring<STAGES, kF32BTile<BN>>::kBytes + 1024, 1, s, xmap, wmap,
                L, y);
}

// The wide fp32 tile's width: 128 from Cout 128 up, 64 above 8, else 8.
inline int tf32_tile_n(int cout) {
  return cout >= 128 ? 128 : (cout > 8 ? 64 : 8);
}

template <typename OutT>
int run_tf32(const float* x, const float* wt, float* ws, const float* a,
             const float* b, void* y, int n, int h, int w, int cin, int cout,
             int ldb, int act, float leak, cudaStream_t s) {
  if (n < 1 || h < 1 || w < 1 || cin < kBK32 || cin % kBK32 != 0 ||
      cout < 1 || ldb < cout)
    return static_cast<int>(cudaErrorInvalidValue);
  ConvT L;
  L.box = make_box(n, h, w);
  L.cin = cin;
  L.kc = cin / kBK32;
  L.cout = cout;
  L.ldb = ldb;
  L.a = a;
  L.b = b;
  L.act = act;
  L.leak = leak;
  // the narrow tile's halo box, or the wide tile's box, of x
  const bool narrow = cout <= kF32NarrowCout && L.kc <= kF32NarrowChunks &&
                      halo_rows(L.box) <= kHaloMaxRows;
  const int halo = narrow ? 2 : 0;
  CUtensorMap xmap, wmap;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[3] = {4ull * cin, 4ull * cin * w,
                                 4ull * cin * w * h};
  const cuuint32_t box[4] = {kBK32,
                             static_cast<cuuint32_t>(L.box.bw + halo),
                             static_cast<cuuint32_t>(L.box.bh + halo),
                             static_cast<cuuint32_t>(L.box.bn)};
  if (!encode_f32(&xmap, x, 4, dims, strides, box))
    return static_cast<int>(cudaErrorInvalidValue);
  OutT* out = static_cast<OutT*>(y);
  cudaError_t e;
  if (narrow) {
    // persistent: as many blocks as fit on the card at once
    const int smem = 18 * L.kc * kWinAtom + kNarrowStage +
                     kHaloStages * (halo_slot(L.box) + 16) + 1024;
    int resident = 0;
    e = kernel_setup(reinterpret_cast<const void*>(convt_narrow_tf32<OutT>),
                     smem, &resident);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = launch(convt_narrow_tf32<OutT>,
               dim3(std::min(L.box.tiles(), resident)), smem, 1, s, xmap, L,
               wt, out);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  const int bn = tf32_tile_n(cout);
  if (!encode_weight_tf32(&wmap, ws, 16ll * cin, cout, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  e = launch_split_weight(wt, 16 * cin, cout, ldb, ws, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bn == 128)
    e = launch_tf32<128, 4>(xmap, wmap, L, out, s);
  else if (bn == 64)
    e = launch_tf32<64, 6>(xmap, wmap, L, out, s);
  else
    e = launch_tf32<8, 8>(xmap, wmap, L, out, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
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

// x (n, h, w, cin) fp32 with cin % 32 == 0, 16-byte aligned; wt (4, 4, cin,
// ldb) fp32 (ldb >= cout, any alignment); ws: scratch of 32 cin * cout
// floats (the split weight); a/b (cout,) f32 -> y (n, 2h, 2w, cout) bf16
// (out_f32 = 0) or f32 (out_f32 = 1): fp32 products by three TF32 passes,
// fp32 sums.
extern "C" int tg_convt_affine_act_tf32(const float* x, const float* wt,
                                        float* ws, const float* a,
                                        const float* b, void* y, int n, int h,
                                        int w, int cin, int cout, int ldb,
                                        int act, float leak, int out_f32,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_f32 ? run_tf32<float>(x, wt, ws, a, b, y, n, h, w, cin, cout,
                                   ldb, act, leak, s)
                 : run_tf32<tg::sm90::bf16>(x, wt, ws, a, b, y, n, h, w, cin,
                                            cout, ldb, act, leak, s);
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
