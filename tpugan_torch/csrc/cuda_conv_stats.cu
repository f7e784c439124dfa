// Conv2d(k=4, s=2, p=1) plus its per-channel batch statistics in one pass
// over the activation.
//
// Replaces: tpugan/ops/pallas_conv_stats.py `_kernel` / `_dispatch`
// (`conv_stats`, the forward of `conv_bn_stats`).
//
// What bounds it on an H100: the conv's products (the three BN layers of
// the 64 px discriminator at batch 128 are 8.6 GFLOP each, 340 to 1,000
// operations per byte: bf16 tensor-core throughput).  The statistics add 3
// operations per output element and 2 * Cout floats of output.
//
// What the design does about it: the Hopper mainloop of igemm_sm90.cuh
// (TMA into a swizzled shared-memory ring, one producer warp, two wgmma
// consumer warpgroups, a 128 x BN tile).  Rows are output positions, depth
// is 16 taps x Cin, one tap x 64 channels a stage.  The stride-2 gather is
// a 5-D tensor map of x (N, H/2, 2, W/2, 2 Cin): tap (kh, kw) reads parity
// p = (kh + 1) % 2 at row offset (kh - 1 - p) / 2 (likewise kw), so every
// stage is one TMA box whose start is the tap's shift and whose zero fill
// outside the tensor is the padding.
//
// The epilogue takes each tile's per-channel partial sums of y and y^2 from
// the fp32 accumulators in registers (before y is rounded to bf16, as the
// TPU kernel takes them): over each thread's rows, then by warp shuffles,
// then across the 8 warps through shared memory, always in the same order;
// and writes y through shared memory as 16-byte row vectors.  A second
// kernel sums the tiles' partials per channel in a fixed order (in double)
// and writes the mean and the biased variance E[y^2] - mean^2, clamped at 0.
// No atomics: the result is the same bits on every run.
//
// A layer with too few tiles to fill the card (the last one: 2,048 rows,
// depth 4,096, 64 tiles) splits its depth over a cluster of 2 (or, for
// tiny grids, 4) blocks (tg_conv_stats_plan, at the card's SM count): each
// computes its share, parks its accumulators in its own shared memory, and
// block 0 of the cluster adds the others' in rank order through distributed
// shared memory before its epilogue.  Still two launches, still the same
// bits on every run.
#include <cuda_runtime.h>

#include "igemm_sm90.cuh"

namespace {

using namespace tg::sm90;

constexpr int kReduceThreads = 256;

// A tile's width: 128 output channels (3 stages) from Cout 128 up, else 64
// (4 stages).
constexpr int tile_n(int cout) { return cout >= 128 ? 128 : 64; }

// Blocks of a cluster that share one tile's depth of `steps` stages:
// doubled while the doubled launch still has at most one block per SM (the
// cluster's reduction costs more than a second wave of blocks saves), each
// keeps at least 8 stages, and at most 4 share a tile.
int split_k(int blocks, int steps, int sms) {
  int splits = 1;
  while (2 * blocks * splits <= sms && splits < 4 &&
         steps % (2 * splits) == 0 && steps / (2 * splits) >= 8)
    splits *= 2;
  return splits;
}

// x (n, h, w, cin) bf16 with cin % 64 == 0; w (4, 4, cin, ldb) bf16 HWIO.
struct Conv {
  Box box;  // the output grid (n, h/2, w/2)
  int cin, kc, cout;
  int steps;  // of one block: 16 kc / splits
};

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

template <int BN, int STAGES>
using StatsRing = Ring<STAGES, BN * kRowBytes>;

template <int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
conv_stats_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, Conv L,
                  tg::sm90::bf16* y, float* part) {
  const StatsRing<BN, STAGES> R{smem_base()};
  const int tiles_n = (L.cout + BN - 1) / BN, tiles_m = L.box.tiles();
  const int tm = blockIdx.x / tiles_n, n0 = (blockIdx.x - tm * tiles_n) * BN;
  const int split = blockIdx.z, splits = gridDim.z;
  int img0, i0, j0;
  L.box.origin(tm, img0, i0, j0);
  if (threadIdx.x == 0) R.init();
  __syncthreads();

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      const uint32_t bytes = (L.box.rows() + BN) * kRowBytes;
      const int s0 = split * L.steps;
      produce(R, 0, L.steps, bytes, [&](int k, int slot, uint64_t* bar) {
        const int s = s0 + k, t = s / L.kc, c = (s - t * L.kc) * kBK;
        const int kh = t >> 2, kw = t & 3;
        const int oi = (kh - 1) >> 1, p = kh - 1 - 2 * oi;
        const int oj = (kw - 1) >> 1, q = kw - 1 - 2 * oj;
        tma_5d(R.a(slot), &xmap, bar, q * L.cin + c, j0 + oj, p, i0 + oi,
               img0);
#pragma unroll
        for (int h = 0; h < BN / kBK; ++h)
          tma_2d(R.b(slot) + h * kBK * kRowBytes, &wmap, bar, n0 + h * kBK,
                 t * L.cin + c);
      });
    }
    __syncwarp();
  } else {
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
  if (split != 0 || threadIdx.x >= kConsumers) return;

  // per-channel partial sums of this tile's valid rows
  const int t = threadIdx.x & 127, wp = threadIdx.x >> 5;
  const int r0 = 64 * wg + frag_row(t >> 5, lane, 0);
  int img, i, j;
  const bool va = L.box.at(r0, img0, i0, j0, img, i, j);
  const bool vb = L.box.at(r0 + 8, img0, i0, j0, img, i, j);
  named_sync(1, kConsumers);  // every product is done: the ring is free
  float* red = reinterpret_cast<float*>(R.base) + 2 * kStageFloats<BN>;
#pragma unroll
  for (int jb = 0; jb < BN / 8; ++jb) {
    float v[4] = {0.f, 0.f, 0.f, 0.f};  // s0, s1, q0, q1
    if (va) {
      v[0] = acc[4 * jb];
      v[1] = acc[4 * jb + 1];
      v[2] = v[0] * v[0];
      v[3] = v[1] * v[1];
    }
    if (vb) {
      const float u0 = acc[4 * jb + 2], u1 = acc[4 * jb + 3];
      v[0] += u0;
      v[1] += u1;
      v[2] = fmaf(u0, u0, v[2]);
      v[3] = fmaf(u1, u1, v[3]);
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    if (lane < 4) {
      const int c = 8 * jb + 2 * lane;
      red[wp * BN + c] = v[0];
      red[wp * BN + c + 1] = v[1];
      red[(kConsumerWarps + wp) * BN + c] = v[2];
      red[(kConsumerWarps + wp) * BN + c + 1] = v[3];
    }
  }
  named_sync(1, kConsumers);
  if (threadIdx.x < BN && n0 + threadIdx.x < L.cout) {
    float s = 0.f, q = 0.f;
    for (int w = 0; w < kConsumerWarps; ++w) {
      s += red[w * BN + threadIdx.x];
      q += red[(kConsumerWarps + w) * BN + threadIdx.x];
    }
    const long long n = n0 + threadIdx.x;
    part[n * tiles_m + tm] = s;
    part[(L.cout + n) * tiles_m + tm] = q;
  }

  const int ho = L.box.h, wo = L.box.w;
  float* stage = reinterpret_cast<float*>(R.base) + wg * kStageFloats<BN>;
  store_tile<BN>(acc, stage, y, n0, L.cout, wg, [&](int r) -> long long {
    int im, ii, jj;
    if (!L.box.at(64 * wg + r, img0, i0, j0, im, ii, jj)) return -1;
    return ((static_cast<long long>(im) * ho + ii) * wo + jj) * L.cout;
  });
}

// One block per channel: sum its tiles' partials in a fixed order, then
// mean and biased variance over `count` rows.
__global__ void __launch_bounds__(kReduceThreads)
stats_reduce_kernel(const float* part, int tiles_m, int cout, double count,
                    float* stats) {
  __shared__ double sh[2][kReduceThreads];
  const int n = blockIdx.x, tid = threadIdx.x;
  const float* ps = part + static_cast<long long>(n) * tiles_m;
  const float* pq = part + (static_cast<long long>(cout) + n) * tiles_m;
  double s = 0.0, q = 0.0;
  for (int t = tid; t < tiles_m; t += kReduceThreads) {
    s += ps[t];
    q += pq[t];
  }
  sh[0][tid] = s;
  sh[1][tid] = q;
  __syncthreads();
  for (int st = kReduceThreads / 2; st > 0; st >>= 1) {
    if (tid < st) {
      sh[0][tid] += sh[0][tid + st];
      sh[1][tid] += sh[1][tid + st];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const double mean = sh[0][0] / count;
    const double var = sh[1][0] / count - mean * mean;
    stats[n] = static_cast<float>(mean);
    stats[cout + n] = static_cast<float>(var > 0.0 ? var : 0.0);
  }
}

template <int BN, int STAGES>
cudaError_t launch_conv(const CUtensorMap& xmap, const CUtensorMap& wmap,
                        const Conv& L, int splits, void* y, float* part,
                        cudaStream_t s) {
  const dim3 grid(L.box.tiles() * ((L.cout + BN - 1) / BN), 1, splits);
  return launch(conv_stats_kernel<BN, STAGES>, grid,
                StatsRing<BN, STAGES>::kBytes + 1024, splits, s, xmap, wmap,
                L, static_cast<tg::sm90::bf16*>(y), part);
}

}  // namespace

// The plan of a launch on an (n, h, w, cin) input with cin % 64 == 0, on a
// card of `sms` multiprocessors: plan[0] = tiles_m, the boxes of the output
// grid (make_box), for the caller's scratch of 2 * cout * tiles_m floats;
// plan[1] = the blocks that split each tile's depth (split_k).
extern "C" void tg_conv_stats_plan(int n, int h, int w, int cin, int cout,
                                   int sms, int* plan) {
  const int tiles_m = make_box(n, h / 2, w / 2).tiles();
  const int tn = tile_n(cout);
  plan[0] = tiles_m;
  plan[1] = split_k(tiles_m * ((cout + tn - 1) / tn), 16 * (cin / kBK), sms);
}

// x (n, h, w, cin) bf16 with cin % 64 == 0, wt (4, 4, cin, ldb) bf16 with
// ldb % 8 == 0, ldb >= cout, both 16-byte aligned -> y (n, h/2, w/2, cout)
// bf16, stats (2, cout) f32 = (mean, biased var); part: scratch of
// 2 * cout * tiles_m floats, and `splits`, from tg_conv_stats_plan (a
// measurement may set splits to another of 1, 2 or 4 dividing the depth of
// 16 cin / 64 stages).
extern "C" int tg_conv_stats(const void* x, const void* wt, void* y,
                             float* part, float* stats, int n, int h, int w,
                             int cin, int cout, int ldb, int splits,
                             int tiles_m, void* stream) {
  const int steps = 16 * (cin / kBK);
  if (n < 1 || h < 2 || w < 2 || h % 2 || w % 2 || cin < kBK ||
      cin % kBK || cout < 1 || ldb < cout || ldb % 8 ||
      (splits != 1 && splits != 2 && splits != 4) || steps % splits)
    return static_cast<int>(cudaErrorInvalidValue);
  Conv L;
  L.box = make_box(n, h / 2, w / 2);
  L.cin = cin;
  L.kc = cin / kBK;
  L.cout = cout;
  L.steps = steps / splits;
  if (tiles_m != L.box.tiles()) return static_cast<int>(cudaErrorInvalidValue);
  // x as (n, h/2, 2, w/2, 2 cin), innermost first
  CUtensorMap xmap, wmap;
  const cuuint64_t dims[5] = {2ull * cin, static_cast<cuuint64_t>(w / 2), 2,
                              static_cast<cuuint64_t>(h / 2),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[4] = {4ull * cin, 2ull * cin * w, 4ull * cin * w,
                                 2ull * cin * w * h};
  const cuuint32_t box[5] = {kBK, static_cast<cuuint32_t>(L.box.bw), 1,
                             static_cast<cuuint32_t>(L.box.bh),
                             static_cast<cuuint32_t>(L.box.bn)};
  if (!encode_bf16(&xmap, x, 5, dims, strides, box) ||
      !encode_weight(&wmap, wt, 16ll * cin, ldb))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = tile_n(cout) == 128
                      ? launch_conv<128, 3>(xmap, wmap, L, splits, y, part, s)
                      : launch_conv<64, 4>(xmap, wmap, L, splits, y, part, s);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stats_reduce_kernel<<<cout, kReduceThreads, 0, s>>>(
      part, tiles_m, cout, static_cast<double>(n) * (h / 2) * (w / 2), stats);
  return static_cast<int>(cudaGetLastError());
}
