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
// What the design does about it: the conv tile of conv_sm90.cuh on the
// Hopper mainloop of igemm_sm90.cuh (TMA into a swizzled shared-memory
// ring, one producer warp, two wgmma consumer warpgroups, a 128 x BN tile;
// x through a 5-D parity view, so a tap's shift is the TMA box's start and
// its zero fill the padding), shared with the eval-mode conv (cuda_conv.cu).
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
// A layer with too few tiles to fill the card splits its depth over a
// cluster (conv_sm90.cuh, planned by tg_conv_stats_plan at the card's SM
// count), reduced in rank order: still two launches, still the same bits on
// every run.
//
// fp32 operands (train.precision="fp32"): the same function on fp32 x and
// w with fp32 sums (tpugan/ops/pallas_conv_stats.py:95 `_dispatch` on fp32
// operands).  What bounds it: the products of the D's BN layers (Cin 64 to
// 256; 25.8 GFLOP over the three at batch 128).  No tensor-core type holds
// an fp32 operand, and on the CUDA cores (FFMA, 67 TFLOP/s) they take
// 0.385 ms at best.  What the design does about it: tg_conv_stats_tf32
// runs them on the tensor cores in three TF32 passes over split operands
// (each operand big + small; big x big + big x small + small x big summed
// in fp32 carry ~22 bits an operand, under fp32's sum-order noise), at 165
// TFLOP/s of fp32 products, a bound of 0.156 ms at batch 128.  It is this
// file's kernel on the same conv tile (conv_sm90.cuh with kF32: x by TMA
// through the parity view in fp32, 32 channels a stage, its rows split in
// registers; B from the weight split once a call into its two parts,
// K-major, by split_weight_tf32, 8.4 MB at most), with the same epilogue
// (partials from the fp32 accumulators, y written in fp32), the same
// split-K over a cluster (at most 2 blocks a tile) and the same reduce:
// still the same bits on every run.  The tensor cores' accumulation
// truncates, so every 4 stages' sums are added into the running sums in
// fp32 (consume_f32).  Shapes the route does not take (Cin not a multiple
// of 32) run tg_conv_stats_f32, the FFMA mainloop of igemm_f32.cuh:
// per-channel partial sums over each thread's rows, then across the tile's
// row threads through shared memory in a fixed order, and the same reduce
// kernel.
#include <cuda_runtime.h>

#include <type_traits>

#include "conv_sm90.cuh"
#include "igemm_f32.cuh"

namespace {

using namespace tg::sm90;

constexpr int kReduceThreads = 256;

// kF32: fp32 x and y, the split weight's map (make_conv_tf32).
template <int BN, int STAGES, bool kF32 = false>
__global__ void __launch_bounds__(kThreads, kF32 ? 1 : 2)
conv_stats_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap wmap, Conv L,
                  std::conditional_t<kF32, float, tg::sm90::bf16>* y,
                  float* part) {
  const ConvRing<BN, STAGES, kF32> R{smem_base()};
  const int tiles_n = (L.cout + BN - 1) / BN, tiles_m = L.box.tiles();
  const int tm = blockIdx.x / tiles_n, n0 = (blockIdx.x - tm * tiles_n) * BN;
  int img0, i0, j0;
  L.box.origin(tm, img0, i0, j0);
  if (threadIdx.x == 0) R.init();
  __syncthreads();

  float acc[BN / 2];
  if (!conv_tile<BN, STAGES, kF32>(xmap, wmap, L, R, n0, img0, i0, j0, acc))
    return;

  // per-channel partial sums of this tile's valid rows
  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
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

// The fp32 conv tile and its per-channel partial sums, as conv_stats_kernel
// writes them: part[c * tiles_m + tm] (sums of y) and part[(cout + c) *
// tiles_m + tm] (of y^2) over the tile's valid rows.
template <class T, bool VA, bool VB>
__global__ void __launch_bounds__(tg::f32::kThreads)
conv_stats_f32_kernel(tg::f32::Gemm G, float* y, float* part) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tiles_n = (G.cout + T::BN - 1) / T::BN;
  const int tiles_m = (G.rows + T::BM - 1) / T::BM;
  const int tm = blockIdx.x / tiles_n, n0 = (blockIdx.x - tm * tiles_n) * T::BN;
  float acc[T::TM][T::TN];
  tg::f32::gemm_tile<T, VA, VB>(G, 0, tm * T::BM, n0, smem, acc);

  constexpr int TR = tg::f32::kThreads / T::TC;
  const int tr = threadIdx.x / T::TC, tc = threadIdx.x % T::TC;
  float s[T::TN], q[T::TN];
#pragma unroll
  for (int j = 0; j < T::TN; ++j) s[j] = q[j] = 0.f;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = tm * T::BM + tr * T::TM + i;
    if (r >= G.rows) continue;
    float* row = y + static_cast<long long>(r) * G.cout;
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int n = n0 + tc * T::TN + j;
      const float v = acc[i][j];
      s[j] += v;
      q[j] = fmaf(v, v, q[j]);
      if (n < G.cout) row[n] = v;
    }
  }
  // the row threads' sums, added in order of their rows
  float* red = smem;  // [2][TR][BN]: the mainloop's buffers are free
#pragma unroll
  for (int j = 0; j < T::TN; ++j) {
    red[tr * T::BN + tc * T::TN + j] = s[j];
    red[(TR + tr) * T::BN + tc * T::TN + j] = q[j];
  }
  __syncthreads();
  const int n = n0 + threadIdx.x;
  if (threadIdx.x < T::BN && n < G.cout) {
    float sn = 0.f, qn = 0.f;
    for (int r = 0; r < TR; ++r) {
      sn += red[r * T::BN + threadIdx.x];
      qn += red[(TR + r) * T::BN + threadIdx.x];
    }
    part[static_cast<long long>(n) * tiles_m + tm] = sn;
    part[static_cast<long long>(G.cout + n) * tiles_m + tm] = qn;
  }
}

}  // namespace

// The plan of a launch on an (n, h, w, cin) input with cin % 64 == 0, on a
// card of `sms` multiprocessors (conv_plan): plan[0] = tiles_m, the boxes
// of the output grid, for the caller's scratch of 2 * cout * tiles_m
// floats; plan[1] = the blocks that split each tile's depth.
extern "C" void tg_conv_stats_plan(int n, int h, int w, int cin, int cout,
                                   int sms, int* plan) {
  conv_plan(n, h, w, cin, cout, sms, plan);
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
  Conv L;
  CUtensorMap xmap, wmap;
  if (!make_conv(x, wt, n, h, w, cin, cout, ldb, splits, &L, &xmap, &wmap) ||
      tiles_m != L.box.tiles())
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tg::sm90::bf16* yb = static_cast<tg::sm90::bf16*>(y);
  cudaError_t e =
      conv_tile_n(cout) == 128
          ? launch_conv<128, 3>(conv_stats_kernel<128, 3>, L, splits, s, xmap,
                                wmap, L, yb, part)
          : launch_conv<64, 4>(conv_stats_kernel<64, 4>, L, splits, s, xmap,
                               wmap, L, yb, part);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stats_reduce_kernel<<<cout, kReduceThreads, 0, s>>>(
      part, tiles_m, cout, static_cast<double>(n) * (h / 2) * (w / 2), stats);
  return static_cast<int>(cudaGetLastError());
}

// The plan of tg_conv_stats_tf32 on an (n, h, w, cin) input with cin % 32
// == 0 (conv_plan_f32): plan[0] = tiles_m, plan[1] = splits, plan[2] =
// the tile's width.
extern "C" void tg_conv_stats_tf32_plan(int n, int h, int w, int cin,
                                        int cout, int sms, int* plan) {
  conv_plan_f32(n, h, w, cin, cout, sms, plan);
}

// x (n, h, w, cin) fp32 with cin % 32 == 0, 16-byte aligned; wt (4, 4, cin,
// ldb) fp32 (ldb >= cout, any alignment) -> y (n, h/2, w/2, cout) fp32,
// stats (2, cout) f32 = (mean, biased var), by three TF32 passes; ws:
// scratch of 32 cin * cout floats (the split weight), part: of 2 * cout
// * tiles_m floats; tiles_m, splits and the tile width bn (64 or 128) from
// tg_conv_stats_tf32_plan (a measurement may set splits to another of 1, 2
// or 4 dividing the depth of 16 cin / 32 stages).
extern "C" int tg_conv_stats_tf32(const float* x, const float* wt, float* ws,
                                  float* y, float* part, float* stats, int n,
                                  int h, int w, int cin, int cout, int ldb,
                                  int splits, int tiles_m, int bn,
                                  void* stream) {
  Conv L;
  CUtensorMap xmap, wmap;
  if ((bn != 64 && bn != 128) || ldb < cout ||
      !make_conv_tf32(x, ws, n, h, w, cin, cout, splits, bn, &L, &xmap,
                      &wmap) ||
      tiles_m != L.box.tiles())
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_split_weight(wt, 16 * cin, cout, ldb, ws, s);
  if (e == cudaSuccess)
    e = bn == 128 ? launch_conv<128, 4, true>(conv_stats_kernel<128, 4, true>,
                                              L, splits, s, xmap, wmap, L, y,
                                              part)
                  : launch_conv<64, 6, true>(conv_stats_kernel<64, 6, true>, L,
                                             splits, s, xmap, wmap, L, y,
                                             part);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  stats_reduce_kernel<<<cout, kReduceThreads, 0, s>>>(
      part, tiles_m, cout, static_cast<double>(n) * (h / 2) * (w / 2), stats);
  return static_cast<int>(cudaGetLastError());
}

// The row tiles of tg_conv_stats_f32 on an (n, h, w, cin) input with cout
// channels: the caller's scratch holds 2 * cout * tiles floats.
extern "C" int tg_conv_stats_f32_tiles(int n, int h, int w, int cout) {
  return tg::f32::tiles_m(n * (h / 2) * (w / 2), cout);
}

// x (n, h, w, cin) fp32, wt (4, 4, cin, ldb) fp32 (ldb >= cout; any cin and
// cout >= 1, any alignment) -> y (n, h/2, w/2, cout) fp32, stats (2, cout)
// f32 = (mean, biased var); part: scratch of 2 * cout * tiles_m floats,
// tiles_m from tg_conv_stats_f32_tiles.
extern "C" int tg_conv_stats_f32(const float* x, const float* wt, float* y,
                                 float* part, float* stats, int n, int h,
                                 int w, int cin, int cout, int ldb,
                                 int tiles_m, void* stream) {
  const tg::f32::Gemm G = tg::f32::conv_gemm(x, wt, n, h, w, cin, cout, ldb);
  if (h < 2 || w < 2 || h % 2 || w % 2 || !tg::f32::valid(G) ||
      tiles_m != tg::f32::tiles_m(G.rows, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = tg::f32::dispatch(
      G, [&](auto tile, auto va, auto vb) -> cudaError_t {
        using T = decltype(tile);
        constexpr bool VA = decltype(va)::value, VB = decltype(vb)::value;
        const int grid = tiles_m * ((cout + T::BN - 1) / T::BN);
        conv_stats_f32_kernel<T, VA, VB>
            <<<grid, tg::f32::kThreads, T::kBytes, s>>>(G, y, part);
        return cudaGetLastError();
      });
  if (e != cudaSuccess) return static_cast<int>(e);
  stats_reduce_kernel<<<cout, kReduceThreads, 0, s>>>(
      part, tiles_m, cout, static_cast<double>(n) * (h / 2) * (w / 2), stats);
  return static_cast<int>(cudaGetLastError());
}
