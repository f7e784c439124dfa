// The strided Conv2d(k=4, s=2, p=1) tile on the Hopper mainloop, shared by
// the eval-mode conv + affine + activation (cuda_conv.cu) and the conv +
// BN-statistics kernel (cuda_conv_stats.cu), which differ only in their
// epilogues: the layer's plan (box tiling, tile width, split-K), the tensor
// map of x, and the tile itself (producer, consumers, and the split-K
// park / add over a cluster).
//
// Rows are output positions, depth is 16 taps x Cin, one tap x 64 channels
// a stage.  The stride-2 gather is a 5-D tensor map of x (N, H/2, 2, W/2,
// 2 Cin): tap (kh, kw) reads parity p = (kh + 1) % 2 at row offset
// (kh - 1 - p) / 2 (likewise kw), so every stage is one TMA box whose start
// is the tap's shift and whose zero fill outside the tensor is the padding.
//
// A layer with too few tiles to fill the card (the D's last one: 2,048
// rows, depth 4,096, 64 tiles) splits its depth over a cluster of 2 (or,
// for tiny grids, 4) blocks (conv_plan, at the card's SM count): each
// computes its share, parks its accumulators in its own shared memory, and
// block 0 of the cluster adds the others' in rank order through distributed
// shared memory before its epilogue: the same bits on every run.
//
// fp32 operands (kF32: both kernels' wide TF32 route) take the same tile
// at 32 channels a stage: x through the same parity view in fp32, B from
// the weight split into its TF32 part and the rest, K-major
// (split_weight_tf32), each stage's A split in registers and multiplied in
// three TF32 passes (consume_f32).
#pragma once

#include "igemm_sm90.cuh"

namespace tg {
namespace sm90 {

// A tile's width: 128 output channels (3 stages) from Cout 128 up, else 64
// (4 stages).
constexpr int conv_tile_n(int cout) { return cout >= 128 ? 128 : 64; }

// Blocks of a cluster that share one tile's depth of `steps` stages:
// doubled while the doubled launch still has at most one block per SM (the
// cluster's reduction costs more than a second wave of blocks saves), each
// keeps at least 8 stages, and at most `most` (4) share a tile.
inline int conv_split_k(int blocks, int steps, int sms, int most = 4) {
  int splits = 1;
  while (2 * blocks * splits <= sms && splits < most &&
         steps % (2 * splits) == 0 && steps / (2 * splits) >= 8)
    splits *= 2;
  return splits;
}

// Channels of a stage: 64 bf16 or 32 fp32, a 128-byte row.
template <bool kF32>
constexpr int kConvChan = kF32 ? kBK32 : kBK;

// The plan of a launch on an (n, h, w, cin) input with cin % 64 == 0, on a
// card of `sms` multiprocessors: plan[0] = tiles_m, the boxes of the output
// grid (make_box); plan[1] = the blocks that split each tile's depth.
inline void conv_plan(int n, int h, int w, int cin, int cout, int sms,
                      int* plan) {
  const int tiles_m = make_box(n, h / 2, w / 2).tiles();
  const int tn = conv_tile_n(cout);
  plan[0] = tiles_m;
  plan[1] = conv_split_k(tiles_m * ((cout + tn - 1) / tn), 16 * (cin / kBK),
                         sms);
}

// conv_plan on fp32 operands (cin % 32 == 0), whose block fills an SM's
// shared memory: a stage holds 32 channels; at most 2 blocks split a tile
// (a cluster of 4 such blocks ran in two waves on an H100: kernel 5's
// last layer at batch 64, 0.1176 ms split 4 against 0.1083 split 2); and
// plan[2] = the tile's width, 64 where 128-wide tiles split in 2 would
// fill at most half the card (that layer: 0.0813 ms at 64, 0.1085 at 128).
inline void conv_plan_f32(int n, int h, int w, int cin, int cout, int sms,
                          int* plan) {
  const int tiles_m = make_box(n, h / 2, w / 2).tiles();
  int tn = conv_tile_n(cout);
  if (tn == 128 && 4 * tiles_m * ((cout + 127) / 128) <= sms) tn = 64;
  plan[0] = tiles_m;
  plan[1] = conv_split_k(tiles_m * ((cout + tn - 1) / tn),
                         16 * (cin / kBK32), sms, 2);
  plan[2] = tn;
}

// x (n, h, w, cin) bf16 with cin % 64 == 0; w (4, 4, cin, ldb) bf16 HWIO.
struct Conv {
  Box box;  // the output grid (n, h/2, w/2)
  int cin, kc, cout;
  int steps;  // of one block: 16 kc / splits
};

// The layer and x's map (n, h, w, cin) for stages of `chan` channels of
// `es`-byte elements, split over `splits` blocks a tile; false on a shape
// the kernels do not take (cin % chan, odd sizes, a split that does not
// divide the depth) or a map the driver refuses.
inline bool make_conv_x(const void* x, CUtensorMapDataType type, int es,
                        int chan, int n, int h, int w, int cin, int cout,
                        int splits, Conv* L, CUtensorMap* xmap) {
  const int steps = 16 * (cin / chan);
  if (n < 1 || h < 2 || w < 2 || h % 2 || w % 2 || cin < chan ||
      cin % chan || cout < 1 || (splits != 1 && splits != 2 && splits != 4) ||
      steps % splits)
    return false;
  L->box = make_box(n, h / 2, w / 2);
  L->cin = cin;
  L->kc = cin / chan;
  L->cout = cout;
  L->steps = steps / splits;
  // x as (n, h/2, 2, w/2, 2 cin), innermost first
  const cuuint64_t c = static_cast<cuuint64_t>(es) * cin;
  const cuuint64_t dims[5] = {2ull * cin, static_cast<cuuint64_t>(w / 2), 2,
                              static_cast<cuuint64_t>(h / 2),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[4] = {2 * c, c * w, 2 * c * w, c * w * h};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(chan),
                             static_cast<cuuint32_t>(L->box.bw), 1,
                             static_cast<cuuint32_t>(L->box.bh),
                             static_cast<cuuint32_t>(L->box.bn)};
  return encode_map(xmap, type, x, 5, dims, strides, box);
}

// The layer and its tensor maps for x (n, h, w, cin) bf16 and the weight
// (4, 4, cin, ldb); false also where ldb < cout or ldb % 8.
inline bool make_conv(const void* x, const void* wt, int n, int h, int w,
                      int cin, int cout, int ldb, int splits, Conv* L,
                      CUtensorMap* xmap, CUtensorMap* wmap) {
  return ldb >= cout && ldb % 8 == 0 &&
         make_conv_x(x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, kBK, n, h, w,
                     cin, cout, splits, L, xmap) &&
         encode_weight(wmap, wt, 16ll * cin, ldb);
}

// The same for x fp32 and the split weight ws (2, cout, 16 cin) of
// split_weight_tf32, read in boxes of bn channels.
inline bool make_conv_tf32(const float* x, const float* ws, int n, int h,
                           int w, int cin, int cout, int splits, int bn,
                           Conv* L, CUtensorMap* xmap, CUtensorMap* wmap) {
  return make_conv_x(x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, kBK32, n, h, w,
                     cin, cout, splits, L, xmap) &&
         encode_weight_tf32(wmap, ws, 16ll * cin, cout, bn);
}

template <int BN, int STAGES, bool kF32 = false>
using ConvRing =
    Ring<STAGES, (kF32 ? kF32BTile<BN> : BN * kRowBytes)>;

__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The tile of output columns n0 .. n0 + BN - 1 at box origin (img0, i0, j0),
// stages blockIdx.z * L.steps .. of the depth, by every thread of the block
// (the ring initialised and synchronised): the producer thread issues the
// copies, the consumer warpgroups the products into acc (this warpgroup's
// 64 rows), and across a cluster of gridDim.z > 1 blocks block 0 adds the
// others' sums in rank order.  True for the threads that hold the finished
// sums (the consumers of block 0 of the cluster): they run the epilogue,
// after a named_sync(1, kConsumers) before reusing the ring.  kF32: fp32 x
// and the split weight's map (make_conv_tf32).
template <int BN, int STAGES, bool kF32 = false>
__device__ __forceinline__ bool conv_tile(
    const CUtensorMap& xmap, const CUtensorMap& wmap, const Conv& L,
    const ConvRing<BN, STAGES, kF32>& R, int n0, int img0, int i0, int j0,
    float (&acc)[BN / 2]) {
  const int split = blockIdx.z, splits = gridDim.z;
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const uint32_t bytes = (L.box.rows() + (kF32 ? 2 : 1) * BN) * kRowBytes;
      const int s0 = split * L.steps;
      produce(R, 0, L.steps, bytes, [&](int k, int slot, uint64_t* bar) {
        const int s = s0 + k, t = s / L.kc;
        const int c = (s - t * L.kc) * kConvChan<kF32>;
        const int kh = t >> 2, kw = t & 3;
        const int oi = (kh - 1) >> 1, p = kh - 1 - 2 * oi;
        const int oj = (kw - 1) >> 1, q = kw - 1 - 2 * oj;
        tma_5d(R.a(slot), &xmap, bar, q * L.cin + c, j0 + oj, p, i0 + oi,
               img0);
        if constexpr (kF32) {
          unsigned char* b = R.b(slot);
          tma_3d(b, &wmap, bar, t * L.cin + c, n0, 0);
          tma_3d(b + BN * kRowBytes, &wmap, bar, t * L.cin + c, n0, 1);
        } else {
#pragma unroll
          for (int h = 0; h < BN / kBK; ++h)
            tma_2d(R.b(slot) + h * kBK * kRowBytes, &wmap, bar,
                   n0 + h * kBK, t * L.cin + c);
        }
      });
    }
    __syncwarp();
  } else {
    if constexpr (kF32)
      consume_f32<BN>(R, 0, L.steps, acc, wg);
    else
      consume(R, 0, L.steps, acc, [&](int, int slot) {
        mma_stage<BN>(acc, desc_kmajor(R.a(slot) + wg * (kATile / 2)),
                      desc_nmajor(R.b(slot)));
      });
  }

  if (splits > 1) {
    // split-K: park, then block 0 adds the others' sums in rank order
    float4* park = reinterpret_cast<float4*>(R.base);  // [BN / 8][256]
    if (threadIdx.x < kConsumers) {
      named_sync(1, kConsumers);  // both warpgroups' products are done
#pragma unroll
      for (int q = 0; q < BN / 8; ++q)
        park[q * kConsumers + threadIdx.x] = make_float4(
            acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
    }
    cluster_sync();
    if (split == 0 && threadIdx.x < kConsumers) {
      for (int r = 1; r < splits; ++r) {
        const uint32_t base = map_rank(park + threadIdx.x, r);
#pragma unroll
        for (int q = 0; q < BN / 8; ++q) {
          const float4 v = ld_cluster4(base + q * kConsumers * 16);
          acc[4 * q] += v.x;
          acc[4 * q + 1] += v.y;
          acc[4 * q + 2] += v.z;
          acc[4 * q + 3] += v.w;
        }
      }
    }
    cluster_sync();  // the others' shared memory stays until block 0 read it
  }
  return split == 0 && threadIdx.x < kConsumers;
}

// Launch kernel<BN, STAGES> over the layer's tiles x `splits` (a cluster of
// `splits` blocks along z per tile).
template <int BN, int STAGES, bool kF32 = false, typename... Params,
          typename... Args>
inline cudaError_t launch_conv(void (*kernel)(Params...), const Conv& L,
                               int splits, cudaStream_t s, Args... args) {
  const dim3 grid(L.box.tiles() * ((L.cout + BN - 1) / BN), 1, splits);
  return launch(kernel, grid, ConvRing<BN, STAGES, kF32>::kBytes + 1024,
                splits, s, args...);
}

}  // namespace sm90
}  // namespace tg
