// Whole eval-mode generator in one persistent launch (megakernel v2).
//
// Replaces: tpugan/ops/pallas_gen2.py `_mega_kernel2` / `_call2`
// (`generator_forward`, helpers `_convt_block_phase`, `_shift_phase`,
// `_pad_base`).
//
// What bounds it on an H100: bf16 tensor-core throughput, 0.054 ms at batch
// 256, 64 px (gen_sm90.cuh).
//
// What the design does about it: the persistent walk of gen_sm90.cuh, with
// the image in fp32, unrounded, in the phase-separated (P, P, n, base,
// base, C) layout that the wrapper's one depth-to-space reads
// (ops/cuda_gen2.py), as on the TPU.
#include "gen_sm90.cuh"

using tg::gen::kPhased;

extern "C" int tg_gen2_resident(int* resident) {
  return tg::gen::gen_resident<kPhased>(resident);
}

extern "C" void tg_gen2_plan(int n, int ldz, int s0, int c0, int n_layers,
                             const int* couts, int resident, int* out) {
  tg::gen::gen_plan_out(n, ldz, s0, c0, n_layers, couts, resident, out);
}

extern "C" int tg_gen2_forward(const void* z, int nz, int ldz, const void* wh,
                               const float* ah, const float* bh, int s0,
                               int c0, int n_layers, const void* const* ws,
                               const float* const* as, const float* const* bs,
                               const int* couts, const int* ldbs, void* work,
                               long long ws_elems, void* sync,
                               long long* stamps, float* y, int n,
                               void* stream) {
  return tg::gen::gen_forward<kPhased>(z, nz, ldz, wh, ah, bh, s0, c0,
                                       n_layers, ws, as, bs, couts, ldbs,
                                       work, ws_elems, sync, stamps, y, n,
                                       stream);
}
