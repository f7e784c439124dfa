// Whole eval-mode generator in one launch, phase-separated layout between
// layers (megakernel v2).
//
// Replaces: tpugan/ops/pallas_gen2.py `_mega_kernel2` / `_call2`
// (`generator_forward`, helpers `_convt_block_phase`, `_shift_phase`,
// `_pad_base`).
//
// What bounds it on an H100: the same work as v1 (cuda_gen.cu): 209 MFLOP
// per 64 px image at full width on 7 MB of bf16 weights, so bf16
// tensor-core throughput (989 TFLOP/s) is the bound.
//
// What the design does about it: as v1 (one block per bt images, layers
// looped in the block, activations ping-ponging through a
// per-block workspace, WMMA tiles from convt_tile.cuh), but each activation
// is stored phase-separated, (P, P, bt, base, base, C) with full-resolution
// h = b * P + o, as the TPU kernel keeps it.  On the TPU that layout spared
// Mosaic its relayouts; here it only changes the address arithmetic of the
// tile's row table, so v1 and v2 share one tile routine.  The kernel writes
// the final image phase-separated, (P, P, n, base, base, C) in fp32; the one
// depth-to-space runs outside the kernel (ops/cuda_gen2.py), as on the TPU.
#include <cuda_runtime.h>

#include "convt_tile.cuh"

namespace {

__global__ void __launch_bounds__(tg::kThreads) gen2_kernel(tg::Gen G) {
  __shared__ __align__(128) unsigned char smem[tg::kSmemBytes];
  tg::gen_forward(G, 1, smem);
}

}  // namespace

extern "C" int tg_gen2_forward(const void* z, int nz, const void* wh,
                               const float* ah, const float* bh, int s0, int c0,
                               int n_layers, const void* const* ws,
                               const float* const* as, const float* const* bs,
                               const int* couts, void* work, long long ws_elems,
                               float* y, int n, int bt, void* stream) {
  return tg::launch_gen(gen2_kernel, z, nz, wh, ah, bh, s0, c0, n_layers, ws,
                        as, bs, couts, work, ws_elems, y, n, bt, stream);
}
