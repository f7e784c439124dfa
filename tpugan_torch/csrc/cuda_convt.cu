// Fused ConvTranspose2d(k=4, s=2, p=1) + per-channel affine + activation.
//
// Replaces: tpugan/ops/pallas_convt.py `_kernel` / `_dispatch`
// (`convt_affine_act`, and the bare hook `conv_transpose2d`).
//
// What bounds it on an H100: at the generator's shapes (batch 256, Cin and
// Cout 64..512) a layer does 2*N*H*W*16*Cin*Cout operations on a few MB of
// input, far above the 295 operations per byte where the tensor cores, not
// the memory, become the limit.  So the bound is bf16 tensor-core throughput
// (989 TFLOP/s dense).
//
// What the design does about it: the transpose conv runs as four dense
// implicit GEMMs (one per output parity phase), so no multiply is spent on
// the zeros a dilated-input lowering inserts; products run on the tensor
// cores (bf16 WMMA, fp32 accumulate); the BN affine and the activation are
// applied in the epilogue, so the layer's output is written once.  A block
// computes one 64x64 tile (256x16 when Cout <= 16) of one phase.  This first
// version stages operands through shared memory with plain loads and no
// pipelining; wgmma and TMA are later work.
#include <cuda_runtime.h>

#include "convt_tile.cuh"

namespace {

template <typename OutT>
__global__ void __launch_bounds__(tg::kThreads)
convt_kernel(tg::ConvT L, int n, tg::Layout in, tg::Layout out, OutT* y,
             int cfg, int tiles_n) {
  __shared__ __align__(128) unsigned char smem[tg::kSmemBytes];
  const int tile = blockIdx.x;
  const int m0 = (tile / tiles_n) * tg::tile_bm(cfg);
  const int n0 = (tile % tiles_n) * tg::tile_bn(cfg);
  const int ph = blockIdx.y;
  tg::convt_tile_cfg(cfg, L, ph >> 1, ph & 1, m0, n0, n, in, 0, out, 0, y, smem);
}

}  // namespace

// x (n, h, w, cin) bf16, wt (4, 4, cin, cout) bf16, a/b (cout,) f32,
// y (n, 2h, 2w, cout) bf16 (out_f32 = 0) or f32 (out_f32 = 1).
extern "C" int tg_convt_affine_act(const void* x, const void* wt,
                                   const float* a, const float* b, void* y,
                                   int n, int h, int w, int cin, int cout,
                                   int act, float leak, int out_f32,
                                   void* stream) {
  tg::ConvT L;
  L.x = static_cast<const tg::bf16*>(x);
  L.w = static_cast<const tg::bf16*>(wt);
  L.a = a;
  L.b = b;
  L.cin = cin;
  L.cout = cout;
  L.h = h;
  L.w_ = w;
  L.act = act;
  L.leak = leak;
  L.round_bf16 = false;
  const tg::Layout in{0, n, h, w, cin, 1};
  const tg::Layout out{0, n, 2 * h, 2 * w, cout, 1};
  const int M = n * h * w;
  const int cfg = cout <= 16 ? tg::kTall : tg::kSquare;
  const int tiles_m = (M + tg::tile_bm(cfg) - 1) / tg::tile_bm(cfg);
  const int tiles_n = (cout + tg::tile_bn(cfg) - 1) / tg::tile_bn(cfg);
  const dim3 grid(tiles_m * tiles_n, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    convt_kernel<float><<<grid, tg::kThreads, 0, s>>>(
        L, n, in, out, static_cast<float*>(y), cfg, tiles_n);
  else
    convt_kernel<tg::bf16><<<grid, tg::kThreads, 0, s>>>(
        L, n, in, out, static_cast<tg::bf16*>(y), cfg, tiles_n);
  return static_cast<int>(cudaGetLastError());
}
