// Whole eval-mode generator in one launch, full-resolution NHWC between
// layers (megakernel v1).
//
// Replaces: tpugan/ops/pallas_gen.py `_mega_kernel` / `_call`
// (`generator_forward`, helper `_convt_block`).
//
// What bounds it on an H100: one 64 px generator forward at full width is
// 104.6 M multiply-adds per image (209 MFLOP), on 7 MB of bf16 weights, so
// at batch 256 (53.6 GFLOP) the bound is bf16 tensor-core throughput, about
// 54 us at 989 TFLOP/s; the bytes (weights once, z in, image out) take far
// less.
//
// What the design does about it: one block per image (bt images per block),
// layers looped inside the block with a barrier between them.  An image's
// activations do not fit shared memory (32x32x64 bf16 is 128 KiB at 64 px;
// one 128 px layer is 512 KiB), so they ping-pong through a per-block
// workspace in global memory (2 x 128 KiB per image at 64 px: 64 MiB for a
// batch of 256, about the size of the 50 MB L2); shared memory holds only
// the operand tiles of the WMMA tensor-core tile routine (convt_tile.cuh).
// One launch replaces one per layer; the cost is that one block runs a
// whole image, so a batch below the SM count leaves SMs idle, and a layer's
// four phases run one after another inside the block.
#include <cuda_runtime.h>

#include "convt_tile.cuh"

namespace {

__global__ void __launch_bounds__(tg::kThreads) gen_kernel(tg::Gen G) {
  __shared__ __align__(128) unsigned char smem[tg::kSmemBytes];
  tg::gen_forward(G, 0, smem);
}

}  // namespace

extern "C" int tg_gen_forward(const void* z, int nz, const void* wh,
                              const float* ah, const float* bh, int s0, int c0,
                              int n_layers, const void* const* ws,
                              const float* const* as, const float* const* bs,
                              const int* couts, void* work, long long ws_elems,
                              float* y, int n, int bt, void* stream) {
  return tg::launch_gen(gen_kernel, z, nz, wh, ah, bh, s0, c0, n_layers, ws,
                        as, bs, couts, work, ws_elems, y, n, bt, stream);
}
