// Fused Conv2d(k=4, s=2, p=1) + per-channel affine + activation.
//
// Replaces: tpugan/ops/pallas_conv.py `_kernel` / `_dispatch`
// (`conv_affine_act`, and the bare hook `conv2d`).
//
// What bounds it on an H100: at the discriminator's shapes (batch 128,
// 64x64x3 -> 4x4x512) a layer does 2 * rows * 16 * Cin * Cout operations on a
// few MB; the three wide layers run at 340 to 1,000 operations per byte,
// above the 295 where the tensor cores, not the memory, are the limit, so
// they are bound by bf16 tensor-core throughput (989 TFLOP/s dense).  The
// first layer (Cin = 3, about 40 operations per byte) is bound by its bytes.
//
// What the design does about it: one implicit GEMM (conv_tile.cuh) with the
// products on the tensor cores (bf16 WMMA, fp32 accumulate) and no copy of
// the input: the TPU kernel's parity planes and zero padding become a row
// table of offsets.  The BN affine and the activation run in the epilogue, so
// the layer's output is written once.  A block computes one 64x64 tile; this
// first version stages operands through shared memory with no pipelining;
// wgmma and TMA are later work.
#include <cuda_runtime.h>

#include "conv_tile.cuh"

namespace {

template <typename OutT>
__global__ void __launch_bounds__(tg::kThreads)
conv_kernel(tg::Conv421 L, const float* a, const float* b, int act,
            float leak, OutT* y, int tiles_n) {
  __shared__ __align__(128) unsigned char smem[tg::kConvSmemBytes];
  const int tile = blockIdx.x;
  const int m0 = (tile / tiles_n) * tg::kCBM;
  const int n0 = (tile % tiles_n) * tg::kCBN;
  const float* Cs = tg::conv421_tile(L, m0, n0, smem);
  const int M = tg::conv421_rows(L);
  for (int e = threadIdx.x; e < tg::kCBM * tg::kCBN; e += tg::kThreads) {
    const int r = e / tg::kCBN, c = e - r * tg::kCBN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < L.cout) {
      const float v = tg::apply_act(Cs[r * tg::kCLDC + c] * a[n] + b[n], act, leak);
      tg::store_val(y + (long long)m * L.cout + n, v, false);
    }
  }
}

}  // namespace

// x (n, h, w, cin) bf16, wt (4, 4, cin, cout) bf16, a/b (cout,) f32,
// y (n, h/2, w/2, cout) bf16 (out_f32 = 0) or f32 (out_f32 = 1).
extern "C" int tg_conv_affine_act(const void* x, const void* wt,
                                  const float* a, const float* b, void* y,
                                  int n, int h, int w, int cin, int cout,
                                  int act, float leak, int out_f32,
                                  void* stream) {
  if (!tg::conv421_ok(n, h, w, cin, cout))
    return static_cast<int>(cudaErrorInvalidValue);
  const tg::Conv421 L = tg::make_conv421(x, wt, n, h, w, cin, cout);
  const int M = tg::conv421_rows(L);
  const int tiles_m = (M + tg::kCBM - 1) / tg::kCBM;
  const int tiles_n = (cout + tg::kCBN - 1) / tg::kCBN;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    conv_kernel<float><<<tiles_m * tiles_n, tg::kThreads, 0, s>>>(
        L, a, b, act, leak, static_cast<float*>(y), tiles_n);
  else
    conv_kernel<tg::bf16><<<tiles_m * tiles_n, tg::kThreads, 0, s>>>(
        L, a, b, act, leak, static_cast<tg::bf16*>(y), tiles_n);
  return static_cast<int>(cudaGetLastError());
}
