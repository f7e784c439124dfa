// The whole eval-mode generator as one persistent launch on the Hopper
// mainloop: the walk shared by megakernel v2 (cuda_gen2.cu, the image in
// the phase-separated layout) and megakernel v1 (cuda_gen.cu, the image at
// full resolution, NHWC, each value rounded to bf16).
//
// What bounds it on an H100: 209 MFLOP per 64 px image at full width (53.5
// GFLOP at batch 256) on 7 MB of bf16 weights: bf16 tensor-core throughput
// (989 TFLOP/s), 0.054 ms at batch 256.
//
// What the design does about it: one cooperative launch of as many blocks
// as the card holds at once (2 a SM), each a persistent worker on the
// Hopper mainloop of igemm_sm90.cuh (TMA into a swizzled ring, one
// producer warp, two wgmma consumer warpgroups).  The blocks walk the
// layers in order; a layer is a set of tiles spread over the whole grid
// (tile t to block t mod grid), with a grid-wide barrier between layers:
//
//   - the head, relu((z @ wh) * ah + bh): a 128-image x 128-column GEMM tile
//     (z, its columns padded to a multiple of 8, and wh by TMA);
//   - a wide ConvT layer (Cout > 8): convt_wide's tile (convt_sm90.cuh), one
//     (128-row box, parity phase, 64 or 128 columns) at a time;
//   - a narrow one (Cout <= 8, the RGB layer): convt_narrow's four-phase
//     tile, its weight in the ring's B slots (unused by its copies).
//
// The ring's stage count and parity run on from tile to tile and layer to
// layer, so the next tile's copies load during an epilogue.  Activations go
// between layers as bf16 NHWC through two workspace buffers: the same
// function as the TPU kernels (v2 rounds them to bf16 as matmul operands,
// v1 between layers).  A wide tile's epilogue applies the affine and
// activation in registers and writes each warp's rows through its own 1 KB
// of shared memory as 16-byte vectors.  The image goes in fp32 straight to
// its place, by the kernel's Image parameter:
//
//   - kPhased (v2): unrounded, in the phase-separated (P, P, n, base, base,
//     C) layout (h = b * P + o) that the wrapper's one depth-to-space reads
//     (ops/cuda_gen2.py), as on the TPU;
//   - kNhwcBf16 (v1): (n, S, S, C), the NHWC address inner layers take,
//     each value rounded to the nearest bf16 after the tanh, as the TPU v1
//     rounds its image to bf16.  Everything else is the same code, so v1's
//     image is v2's, depth-to-space and rounded, bit for bit.
//
// Where trouble lies, and what the source does about it:
//
//   1. Proxies: the epilogues write a layer with generic stores and the
//      next layer reads it by TMA (the async proxy).  Every writer issues
//      fence.proxy.async.global after its stores, before the barrier; the
//      producer again after the barrier, before its first copy.
//   2. The grid barrier is a counter in device memory, zeroed by the
//      wrapper's memset before the launch: a release add, an acquire spin,
//      layer l's barrier complete at (l + 1) x grid arrivals.  A wait of
//      seconds traps, so a fault fails the launch instead of hanging it.
//      The launch is cooperative: a grid that cannot be co-resident is
//      refused, never run.
//   3. Every layer's tensor maps are encoded on the host before the launch
//      (the workspace addresses are known) and passed __grid_constant__.
//   4. Batch invariance (the Sampler's contract): no split-K, and every
//      output sums its depth in one order (stage by stage, k16 slice by
//      slice), whatever tile holds its row and whatever the grid's size.
//   5. Mixed tiles: shared memory fits the largest (the ring of 3 x 32 KB
//      plus 8 KB of row staging), registers the widest (64 fp32
//      accumulators); __launch_bounds__ asks for 2 blocks a SM.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

#include "convt_sm90.cuh"

namespace tg {
namespace gen {

using namespace tg::sm90;
using bf = tg::sm90::bf16;

constexpr int kMaxLayers = 8;  // ConvT layers: ops/cuda_gen.MAX_LAYERS
constexpr int kStages = 3;
constexpr int kBTileMax = 128 * kRowBytes;  // B of a 128-column tile
using GenRing = Ring<kStages, kBTileMax>;
constexpr int kRowPitch = kRowBytes + 16;  // staged row, off bank conflicts
constexpr int kWarpStage = 8 * kRowPitch;  // 8 rows a warp
constexpr int kSmem = GenRing::kBytes + kConsumerWarps * kWarpStage + 1024;
// a narrow layer's weight (16 taps x kc chunks of 1 KB) and its epilogue
// tile live in the ring's B slots, which its copies do not use
constexpr int kNarrowMaxChunks = 2;
static_assert(16 * kNarrowMaxChunks * kAtom + kNarrowStage <=
                  kStages * kBTileMax,
              "a narrow layer fits the ring's B slots");

enum Kind { kHead = 0, kWide = 1, kNarrow = 2 };

// The image's layout and values: v2's and v1's (the file's header).
enum Image { kPhased = 0, kNhwcBf16 = 1 };

// One layer of the walk.  Head: rows are images (tiles of kBM), depth cin =
// z's padded width, cout = s0 * s0 * c0 columns.  ConvT: box is the input
// grid, one row per coarse position.
struct Layer {
  int kind, bn;  // bn: a tile's columns (head, wide)
  int tiles_n, tiles, steps;
  Box box;
  int cin, kc, cout, ldb;
  const float* a;
  const float* b;
  const bf* w;  // narrow: the weight, read by plain loads
  void* y;      // bf16 NHWC, or (last layer) the fp32 image
  int act;
};

struct Gen {
  int layers;  // the head + the ConvT layers
  int n, s0, log2p;
  unsigned* sync;  // the grid barrier's counter
  // where the time goes, read by the stamped instantiation only: each
  // block's %globaltimer (ns) at its start [0], as it finishes layer l's
  // tiles [2 l + 1] and as it leaves the layer's grid barrier [2 l + 2];
  // [.][block]
  long long* stamps;
  Layer L[kMaxLayers + 1];
};

struct Maps {
  CUtensorMap x[kMaxLayers + 1];  // head: z; ConvT: its input activation
  CUtensorMap w[kMaxLayers + 1];  // head: wh; wide: the weight
};

// The walk: each layer's kind, tile width, tiles and stages a tile, for n
// images; returns the most tiles of any layer.  couts: the ConvT layers'.
inline int gen_plan(int n, int ldz, int s0, int c0, int n_layers,
                    const int* couts, Layer* L) {
  Layer& H = L[0];
  H.kind = kHead;
  H.cin = ldz;
  H.kc = (ldz + kBK - 1) / kBK;
  H.cout = H.ldb = s0 * s0 * c0;
  H.bn = H.cout >= 128 ? 128 : 64;
  H.tiles_n = (H.cout + H.bn - 1) / H.bn;
  H.tiles = (n + kBM - 1) / kBM * H.tiles_n;
  H.steps = H.kc;
  int most = H.tiles, hs = s0, cin = c0;
  for (int l = 1; l <= n_layers; ++l) {
    Layer& Y = L[l];
    Y.box = make_box(n, hs, hs);
    Y.cin = cin;
    Y.kc = (cin + kBK - 1) / kBK;
    Y.cout = couts[l - 1];
    if (Y.cout <= 8 && Y.kc <= kNarrowMaxChunks) {
      Y.kind = kNarrow;
      Y.bn = 8;
      Y.tiles_n = 1;
      Y.tiles = Y.box.tiles();
      Y.steps = 9 * Y.kc;
    } else {
      Y.kind = kWide;
      Y.bn = Y.cout >= 128 ? 128 : 64;
      Y.tiles_n = (Y.cout + Y.bn - 1) / Y.bn;
      Y.tiles = 4 * Y.box.tiles() * Y.tiles_n;
      Y.steps = 4 * Y.kc;
    }
    most = std::max(most, Y.tiles);
    hs *= 2;
    cin = Y.cout;
  }
  return most;
}

// A wide tile t: (box tile, phase, column tile), the column tile innermost
// and the four phases of a box next to each other (they read one window).
__device__ __forceinline__ void wide_tile(const Layer& L, int t, int& n0,
                                          int& di, int& dj, int& img0,
                                          int& i0, int& j0) {
  const int per_box = 4 * L.tiles_n, tm = t / per_box;
  const int rem = t - tm * per_box, ph = rem / L.tiles_n;
  n0 = (rem - ph * L.tiles_n) * L.bn;
  di = ph >> 1;
  dj = ph & 1;
  L.box.origin(tm, img0, i0, j0);
}

// The element offset of output pixel (H, W) of image img, c channels: NHWC
// of size x size inside the net and for v1's image, the phased layout for
// v2's.
template <int kImage>
__device__ __forceinline__ long long out_pixel(const Gen& G, bool last,
                                               int size, int c, int img,
                                               int H, int W) {
  if (kImage == kNhwcBf16 || !last)
    return ((static_cast<long long>(img) * size + H) * size + W) * c;
  const int p = (1 << G.log2p) - 1;
  const int ph = ((H & p) << G.log2p) + (W & p);
  return (((static_cast<long long>(ph) * G.n + img) * G.s0 + (H >> G.log2p)) *
              G.s0 + (W >> G.log2p)) * c;
}

// Element i of a 16-byte vector of OutT, without taking its address (which
// would move the vector to local memory).
template <typename OutT>
__device__ __forceinline__ OutT vector_elem(const uint4& v, int i) {
  const int k = i * static_cast<int>(sizeof(OutT)) / 4;
  const uint32_t u = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  if constexpr (sizeof(OutT) == 2)
    return __ushort_as_bfloat16(static_cast<unsigned short>(u >> (16 * (i & 1))));
  else
    return __uint_as_float(u);
}

__device__ __forceinline__ void store2(unsigned char* p, float u, float v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(u, v);
}

__device__ __forceinline__ void store2f(unsigned char* p, float u, float v) {
  *reinterpret_cast<float2*>(p) = make_float2(u, v);
}

// Write a warpgroup's 64 x BN tile (the accumulators, after the epilogue's
// arithmetic): row r (0..63) to y + off(r) + n0 .., columns < cout only;
// off(r) < 0 skips the row.  Each warp stages its 16 rows, 8 at a time and
// one 128-byte column chunk at a time, in its own kWarpStage bytes `ws`,
// and writes them as 16-byte vectors (element by element where cout is not
// a multiple of a vector), so the ring takes the next tile's copies
// meanwhile.
template <int BN, typename OutT, class Off>
__device__ __forceinline__ void store_rows(const float (&acc)[BN / 2],
                                           unsigned char* ws, OutT* y,
                                           int n0, int cout, Off off) {
  constexpr int CW = kRowBytes / sizeof(OutT);  // columns a chunk
  constexpr int VE = 16 / sizeof(OutT);         // elements a vector
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const bool vec = cout % VE == 0;
#pragma unroll
  for (int cc = 0; cc < BN / CW; ++cc) {
    if (n0 + cc * CW >= cout) break;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      __syncwarp();  // the last round's vectors are read
#pragma unroll
      for (int g = 0; g < CW / 8; ++g) {
        const int e = 4 * (cc * (CW / 8) + g) + 2 * hf;  // frag_row / col
        unsigned char* p = ws + (lane >> 2) * kRowPitch +
                           (8 * g + 2 * (lane & 3)) * sizeof(OutT);
        if constexpr (sizeof(OutT) == 2)
          store2(p, acc[e], acc[e + 1]);
        else
          store2f(p, acc[e], acc[e + 1]);
      }
      __syncwarp();
#pragma unroll
      for (int v = lane; v < 64; v += 32) {
        const int rr = v >> 3, q = v & 7;
        const long long o = off(16 * w + 8 * hf + rr);
        const int c0 = n0 + cc * CW + q * VE;
        if (o < 0 || c0 >= cout) continue;
        const uint4 val =
            *reinterpret_cast<const uint4*>(ws + rr * kRowPitch + q * 16);
        if (vec) {
          *reinterpret_cast<uint4*>(y + o + c0) = val;
        } else {
          for (int i = 0; i < VE && c0 + i < cout; ++i)
            y[o + c0 + i] = vector_elem<OutT>(val, i);
        }
      }
    }
  }
}

// The producer thread: the copies of this block's tiles of layer l, from
// ring position k.
__device__ __forceinline__ void produce_layer(const GenRing& R,
                                              const Maps& M, const Layer& L,
                                              int l, int k) {
  const CUtensorMap* xm = &M.x[l];
  const CUtensorMap* wm = &M.w[l];
  for (int t = blockIdx.x; t < L.tiles; t += gridDim.x, k += L.steps) {
    if (L.kind == kHead) {
      const int tm = t / L.tiles_n, n0 = (t - tm * L.tiles_n) * L.bn;
      produce(R, k, L.steps, (kBM + L.bn) * kRowBytes,
              [&](int s, int slot, uint64_t* bar) {
                tma_2d(R.a(slot), xm, bar, s * kBK, tm * kBM);
                for (int h = 0; h < L.bn / kBK; ++h)
                  tma_2d(R.b(slot) + h * kBK * kRowBytes, wm, bar,
                         n0 + h * kBK, s * kBK);
              });
    } else if (L.kind == kWide) {
      int n0, di, dj, img0, i0, j0;
      wide_tile(L, t, n0, di, dj, img0, i0, j0);
      produce(R, k, L.steps, (L.box.rows() + L.bn) * kRowBytes,
              [&](int s, int slot, uint64_t* bar) {
                convt_wide_load(R.a(slot), R.b(slot), xm, wm, bar, s, L.kc,
                                L.cin, di, dj, img0, i0, j0, n0,
                                L.bn / kBK);
              });
    } else {
      int img0, i0, j0;
      L.box.origin(t, img0, i0, j0);
      produce(R, k, L.steps, L.box.rows() * kRowBytes,
              [&](int s, int slot, uint64_t* bar) {
                narrow_load(R.a(slot), xm, bar, s, L.kc, img0, i0, j0);
              });
    }
  }
}

// A consumer warpgroup: this block's head or wide tiles of a layer of BN
// columns, from ring position k; epilogue act(acc * a + b) into OutT (fp32
// at the last layer only: the image).
template <int kImage, int BN, typename OutT>
__device__ __forceinline__ void consume_gemm(const GenRing& R, const Gen& G,
                                             const Layer& L, bool last,
                                             int k, unsigned char* ws) {
  const int wg = threadIdx.x >> 7;
  OutT* y = static_cast<OutT*>(L.y);
  for (int t = blockIdx.x; t < L.tiles; t += gridDim.x, k += L.steps) {
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    consume(R, k, L.steps, acc, [&](int, int slot) {
      mma_stage<BN>(acc, desc_kmajor(R.a(slot) + wg * (kATile / 2)),
                    desc_nmajor(R.b(slot)));
    });
    if (L.kind == kHead) {
      const int tm = t / L.tiles_n, n0 = (t - tm * L.tiles_n) * BN;
      const int m0 = tm * kBM + 64 * wg;
      affine_act<BN>(acc, n0, L.a, L.b, L.cout, L.act, 0.f);
      store_rows<BN>(acc, ws, y, n0, L.cout, [&](int r) -> long long {
        return m0 + r < G.n ? static_cast<long long>(m0 + r) * L.cout : -1;
      });
    } else {
      int n0, di, dj, img0, i0, j0;
      wide_tile(L, t, n0, di, dj, img0, i0, j0);
      affine_act<BN>(acc, n0, L.a, L.b, L.cout, L.act, 0.f);
      if constexpr (kImage == kNhwcBf16 && sizeof(OutT) == 4) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = round_bf16(acc[i]);
      }
      const int size = 2 * L.box.h;
      store_rows<BN>(acc, ws, y, n0, L.cout, [&](int r) -> long long {
        int img, i, j;
        if (!L.box.at(64 * wg + r, img0, i0, j0, img, i, j)) return -1;
        return out_pixel<kImage>(G, last, size, L.cout, img, 2 * i + di,
                                 2 * j + dj);
      });
    }
  }
}

// The consumer warpgroups: this block's narrow tiles of a layer, from ring
// position k; the weight is in the ring's B slots, the epilogue tile after
// it.
template <int kImage, typename OutT>
__device__ __forceinline__ void consume_narrow(const GenRing& R,
                                               const Gen& G, const Layer& L,
                                               bool last, int k) {
  constexpr bool kRound = kImage == kNhwcBf16 && sizeof(OutT) == 4;
  const unsigned char* bs = R.b(0);
  float* st = reinterpret_cast<float*>(R.b(0) + 16 * L.kc * kAtom);
  const int wg = threadIdx.x >> 7, size = 2 * L.box.h;
  for (int t = blockIdx.x; t < L.tiles; t += gridDim.x, k += L.steps) {
    int img0, i0, j0;
    L.box.origin(t, img0, i0, j0);
    float acc[4][4];  // phase p = 2 di + dj
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][e] = 0.f;
    consume(R, k, L.steps, acc, [&](int s, int slot) {
      narrow_mma(acc, desc_kmajor(R.a(slot) + wg * (kATile / 2)), bs, s,
                 L.kc);
    });
    narrow_store<OutT, kRound>(
        acc, st, L.box, img0, i0, j0, L.a, L.b, L.cout, L.act, 0.f,
        static_cast<OutT*>(L.y), [&](int img, int H, int W) -> long long {
          return out_pixel<kImage>(G, last, size, L.cout, img, H, W);
        });
  }
}

// Thread 0: arrive at the grid barrier and wait until `target` blocks
// have: layer l's barrier completes at (l + 1) x gridDim.x arrivals of the
// counter.  The block synchronises around it.
__device__ __forceinline__ void grid_wait(unsigned* count, unsigned target) {
  __threadfence();
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count)
               : "memory");
  long long start = 0;
  for (;;) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(count)
                 : "memory");
    if (v >= target) break;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
  __threadfence();
}

// Measurement only: compiled into the stamped instantiation, which the
// entry launches when it is given stamps; the serving kernel has none.
template <bool kStamps>
__device__ __forceinline__ void stamp(const Gen& G, int at) {
  if constexpr (kStamps) {
    if (threadIdx.x != 0) return;
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    G.stamps[at * gridDim.x + blockIdx.x] = t;
  }
}

template <int kImage, bool kStamps>
__global__ void __launch_bounds__(kThreads, 2)
gen_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Gen G) {
  unsigned char* base = smem_base();
  const GenRing R{base};
  unsigned char* ws = base + GenRing::kBytes + (threadIdx.x >> 5) * kWarpStage;
  stamp<kStamps>(G, 0);
  if (threadIdx.x == 0) R.init();
  __syncthreads();

  int k = 0;  // the ring position, the same sequence in every role
  for (int l = 0; l < G.layers; ++l) {
    const Layer& L = G.L[l];
    const bool last = l == G.layers - 1;
    if (L.kind == kNarrow) {  // its weight into the (drained) B slots
      narrow_weight(R.b(0), L.w, L.kc, L.cin, L.cout, L.ldb, threadIdx.x,
                    kThreads);
      fence_async_shared();
      __syncthreads();
    }
    if (threadIdx.x >= kConsumers) {
      if (threadIdx.x == kConsumers) {
        fence_async_global();  // the last layer's stores before these copies
        produce_layer(R, maps, L, l, k);
      }
      __syncwarp();
    } else {
      if (L.kind == kNarrow) {
        if (last) consume_narrow<kImage, float>(R, G, L, last, k);
        else consume_narrow<kImage, bf>(R, G, L, last, k);
      } else if (L.bn == 128) {
        if (last) consume_gemm<kImage, 128, float>(R, G, L, last, k, ws);
        else consume_gemm<kImage, 128, bf>(R, G, L, last, k, ws);
      } else {
        if (last) consume_gemm<kImage, 64, float>(R, G, L, last, k, ws);
        else consume_gemm<kImage, 64, bf>(R, G, L, last, k, ws);
      }
    }
    if (blockIdx.x < L.tiles)
      k += (L.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * L.steps;
    __syncthreads();  // the block's tiles of layer l are done
    stamp<kStamps>(G, 2 * l + 1);
    if (threadIdx.x < kConsumers) {
      fence_async_global();  // this thread's stores before the next copies
      fence_async_shared();  // and its shared-memory writes before TMA's
    }
    __syncthreads();
    if (!last && threadIdx.x == 0) grid_wait(G.sync, (l + 1) * gridDim.x);
    __syncthreads();
    stamp<kStamps>(G, 2 * l + 2);
  }
}

// ------------------------------------------------------------------- host

// The blocks of the kernel the current card holds at once (2 a SM asked):
// the persistent grid's upper bound.
template <int kImage>
inline int gen_resident(int* resident) {
  return static_cast<int>(
      kernel_setup(reinterpret_cast<const void*>(gen_kernel<kImage, false>),
                   kSmem, resident));
}

// The walk for n images on a card that holds `resident` blocks: out[0] =
// the grid (resident, or fewer where no layer has that many tiles), then
// for the head and each ConvT layer: kind (0 head, 1 wide, 2 narrow), tile
// columns, tiles, stages a tile.
inline void gen_plan_out(int n, int ldz, int s0, int c0, int n_layers,
                         const int* couts, int resident, int* out) {
  Layer L[kMaxLayers + 1];
  const int most = gen_plan(n, ldz, s0, c0, n_layers, couts, L);
  out[0] = std::min(resident, most);
  for (int l = 0; l <= n_layers; ++l) {
    int* o = out + 1 + 4 * l;
    o[0] = L[l].kind;
    o[1] = L[l].bn;
    o[2] = L[l].tiles;
    o[3] = L[l].steps;
  }
}

// z (n, ldz) bf16 (columns nz.. zero), wh (nz, s0 s0 c0) bf16, ah/bh
// (s0 s0 c0,) f32; per ConvT layer w (4, 4, cin, ldb) bf16, a/b (cout,)
// f32, with c0 and every inner cout a multiple of 8 and ldb % 8 == 0 where
// a layer is wide; work: 2 n ws_elems bf16 (ws_elems: the largest
// activation of one image but the last); sync: 4 bytes; -> y, f32: (P, P,
// n, s0, s0, cout), P = 2^n_layers (kPhased), or (n, S, S, cout), S = s0 P
// (kNhwcBf16).  Every pointer TMA reads (z, wh, work, a wide w) 16-byte
// aligned.  stamps: null (the serving kernel), or (2 n_layers + 3) x grid
// int64 for Gen::stamps, which launches the stamped instantiation instead
// (a measurement's).
template <int kImage>
inline int gen_forward(const void* z, int nz, int ldz, const void* wh,
                       const float* ah, const float* bh, int s0, int c0,
                       int n_layers, const void* const* ws,
                       const float* const* as, const float* const* bs,
                       const int* couts, const int* ldbs, void* work,
                       long long ws_elems, void* sync, long long* stamps,
                       float* y, int n, void* stream) {
  if (n < 1 || nz < 1 || ldz < nz || ldz % 8 || s0 < 1 || c0 < 8 || c0 % 8 ||
      n_layers < 1 || n_layers > kMaxLayers)
    return static_cast<int>(cudaErrorInvalidValue);
  Gen G;
  std::memset(&G, 0, sizeof(G));
  Maps M;
  std::memset(&M, 0, sizeof(M));
  G.layers = n_layers + 1;
  G.n = n;
  G.s0 = s0;
  G.log2p = n_layers;
  G.sync = static_cast<unsigned*>(sync);
  G.stamps = stamps;
  const int most = gen_plan(n, ldz, s0, c0, n_layers, couts, G.L);
  bf* buf[2] = {static_cast<bf*>(work), static_cast<bf*>(work) + n * ws_elems};

  Layer& H = G.L[0];
  H.a = ah;
  H.b = bh;
  H.y = buf[0];
  H.act = kRelu;
  const cuuint64_t zdims[2] = {static_cast<cuuint64_t>(ldz),
                               static_cast<cuuint64_t>(n)};
  const cuuint64_t zstrides[1] = {2ull * ldz};
  const cuuint32_t zbox[2] = {kBK, kBM};
  if (!encode_bf16(&M.x[0], z, 2, zdims, zstrides, zbox) ||
      !encode_weight(&M.w[0], wh, nz, H.cout))
    return static_cast<int>(cudaErrorInvalidValue);
  int hs = s0;
  for (int l = 1; l <= n_layers; ++l) {
    Layer& Y = G.L[l];
    const bool last = l == n_layers;
    if (Y.cout < 1 || (!last && Y.cout % 8) || ldbs[l - 1] < Y.cout)
      return static_cast<int>(cudaErrorInvalidValue);
    Y.ldb = ldbs[l - 1];
    Y.w = static_cast<const bf*>(ws[l - 1]);
    Y.a = as[l - 1];
    Y.b = bs[l - 1];
    Y.act = last ? kTanh : kRelu;
    Y.y = last ? static_cast<void*>(y) : static_cast<void*>(buf[l & 1]);
    const cuuint64_t dims[4] = {
        static_cast<cuuint64_t>(Y.cin), static_cast<cuuint64_t>(hs),
        static_cast<cuuint64_t>(hs), static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[3] = {2ull * Y.cin, 2ull * Y.cin * hs,
                                   2ull * Y.cin * hs * hs};
    const cuuint32_t box[4] = {kBK, static_cast<cuuint32_t>(Y.box.bw),
                               static_cast<cuuint32_t>(Y.box.bh),
                               static_cast<cuuint32_t>(Y.box.bn)};
    if (!encode_bf16(&M.x[l], buf[(l - 1) & 1], 4, dims, strides, box) ||
        (Y.kind == kWide &&
         (Y.ldb % 8 || !encode_weight(&M.w[l], Y.w, 16ll * Y.cin, Y.ldb))))
      return static_cast<int>(cudaErrorInvalidValue);
    hs *= 2;
  }

  // both instantiations cap their registers at 2 blocks a SM: the stamped
  // one runs the serving kernel's grid
  int resident = 0;
  cudaError_t e = kernel_setup(
      reinterpret_cast<const void*>(gen_kernel<kImage, false>), kSmem,
      &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(std::min(resident, most));
  e = cudaMemsetAsync(sync, 0, sizeof(unsigned), s);
  if (e == cudaSuccess)
    e = stamps ? launch_ex(gen_kernel<kImage, true>, grid, kSmem, 1, true, s,
                           M, G)
               : launch_ex(gen_kernel<kImage, false>, grid, kSmem, 1, true,
                           s, M, G);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gen
}  // namespace tg
