// Whole eval-mode generator in one persistent launch, the image at full
// resolution, NHWC, rounded to bf16 (megakernel v1).
//
// Replaces: tpugan/ops/pallas_gen.py `_mega_kernel` / `_call`
// (`generator_forward`, helper `_convt_block`).
//
// What bounds it on an H100: bf16 tensor-core throughput, 0.054 ms at batch
// 256, 64 px (gen_sm90.cuh).
//
// What the design does about it: the persistent walk of gen_sm90.cuh that
// megakernel v2 runs, with one difference, in the last layer's epilogue:
// each image value is rounded to the nearest bf16 after the tanh (as the
// TPU kernel rounds its image) and stored as fp32 straight into y (n, S, S,
// C), the NHWC address the inner layers take.  No depth-to-space, no cast
// launch.  The activations between layers are bf16 NHWC in both kernels,
// as the TPU v1 keeps them, so v1's image is v2's, rounded, bit for bit.
#include "gen_sm90.cuh"

using tg::gen::kNhwcBf16;

extern "C" int tg_gen_resident(int* resident) {
  return tg::gen::gen_resident<kNhwcBf16>(resident);
}

extern "C" void tg_gen_plan(int n, int ldz, int s0, int c0, int n_layers,
                            const int* couts, int resident, int* out) {
  tg::gen::gen_plan_out(n, ldz, s0, c0, n_layers, couts, resident, out);
}

// As tg_gen2_forward (gen_sm90.cuh, gen_forward), y (n, S, S, cout) f32.
extern "C" int tg_gen_forward(const void* z, int nz, int ldz, const void* wh,
                              const float* ah, const float* bh, int s0,
                              int c0, int n_layers, const void* const* ws,
                              const float* const* as, const float* const* bs,
                              const int* couts, const int* ldbs, void* work,
                              long long ws_elems, void* sync,
                              long long* stamps, float* y, int n,
                              void* stream) {
  return tg::gen::gen_forward<kNhwcBf16>(z, nz, ldz, wh, ah, bh, s0, c0,
                                         n_layers, ws, as, bs, couts, ldbs,
                                         work, ws_elems, sync, stamps, y, n,
                                         stream);
}
