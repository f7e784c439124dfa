// Conv2d(k=4, s=2, p=1) plus its per-channel batch statistics in one pass
// over the activation.
//
// Replaces: tpugan/ops/pallas_conv_stats.py `_kernel` / `_dispatch`
// (`conv_stats`, the forward of `conv_bn_stats`).
//
// What bounds it on an H100: the conv's products, as in cuda_conv.cu (the
// three BN layers of the 64 px discriminator at batch 128 are 8.6 GFLOP
// each, 340 to 1,000 operations per byte: bf16 tensor-core throughput).  The
// statistics add 3 operations per output element and 2 * Cout floats of
// output.
//
// What the design does about it: the conv tile of conv_tile.cuh; its
// epilogue writes y and, from the same fp32 sums (before y is rounded to
// bf16, as the TPU kernel takes them), each tile's per-channel partial sums
// of y and y^2, so y is never read back to reduce the statistics.  Blocks run
// in no order, so the partials go to a scratch array (2, Cout, tiles) and a
// second kernel sums them per channel in a fixed order (in double) and
// writes the mean and the biased variance E[y^2] - mean^2, clamped at 0.  No
// atomics: the result is the same bits on every run, as the seeded JAX runs
// are reproducible.
#include <cuda_runtime.h>

#include "conv_tile.cuh"

namespace {

constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(tg::kThreads)
conv_stats_kernel(tg::Conv421 L, tg::bf16* y, float* part, int tiles_m,
                  int tiles_n) {
  __shared__ __align__(128) unsigned char smem[tg::kConvSmemBytes];
  const int tile = blockIdx.x;
  const int tm = tile / tiles_n;
  const int m0 = tm * tg::kCBM;
  const int n0 = (tile % tiles_n) * tg::kCBN;
  const float* Cs = tg::conv421_tile(L, m0, n0, smem);
  const int M = tg::conv421_rows(L);
  for (int e = threadIdx.x; e < tg::kCBM * tg::kCBN; e += tg::kThreads) {
    const int r = e / tg::kCBN, c = e - r * tg::kCBN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < L.cout)
      y[(long long)m * L.cout + n] = __float2bfloat16(Cs[r * tg::kCLDC + c]);
  }
  const int rows = min(tg::kCBM, M - m0);
  for (int c = threadIdx.x; c < tg::kCBN; c += tg::kThreads) {
    const int n = n0 + c;
    if (n < L.cout) {
      float s = 0.f, q = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float v = Cs[r * tg::kCLDC + c];
        s += v;
        q = fmaf(v, v, q);
      }
      part[(long long)n * tiles_m + tm] = s;
      part[((long long)L.cout + n) * tiles_m + tm] = q;
    }
  }
}

// One block per channel: sum its tiles' partials in a fixed order, then
// mean and biased variance over `count` rows.
__global__ void __launch_bounds__(kReduceThreads)
stats_reduce_kernel(const float* part, int tiles_m, int cout, double count,
                    float* stats) {
  __shared__ double sh[2][kReduceThreads];
  const int n = blockIdx.x, tid = threadIdx.x;
  const float* ps = part + (long long)n * tiles_m;
  const float* pq = part + ((long long)cout + n) * tiles_m;
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

}  // namespace

// Rows of one tile of the partial-sum scratch: the caller allocates
// 2 * cout * ceil(n * h/2 * w/2 / tg_conv_stats_tile_rows()) floats.
extern "C" int tg_conv_stats_tile_rows() { return tg::kCBM; }

// x (n, h, w, cin) bf16, wt (4, 4, cin, cout) bf16 -> y (n, h/2, w/2, cout)
// bf16, stats (2, cout) f32 = (mean, biased var); part: scratch of
// 2 * cout * tiles_m floats.
extern "C" int tg_conv_stats(const void* x, const void* wt, void* y,
                             float* part, float* stats, int n, int h, int w,
                             int cin, int cout, int tiles_m, void* stream) {
  if (!tg::conv421_ok(n, h, w, cin, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  const tg::Conv421 L = tg::make_conv421(x, wt, n, h, w, cin, cout);
  const int M = tg::conv421_rows(L);
  if (tiles_m != (M + tg::kCBM - 1) / tg::kCBM)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_n = (cout + tg::kCBN - 1) / tg::kCBN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  conv_stats_kernel<<<tiles_m * tiles_n, tg::kThreads, 0, s>>>(
      L, static_cast<tg::bf16*>(y), part, tiles_m, tiles_n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_reduce_kernel<<<cout, kReduceThreads, 0, s>>>(
      part, tiles_m, cout, static_cast<double>(M), stats);
  return static_cast<int>(cudaGetLastError());
}
