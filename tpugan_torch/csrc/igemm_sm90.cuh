// Hopper (sm_90a) implicit-GEMM mainloop shared by the k4/s2/p1 conv and
// ConvT kernels (cuda_conv_stats.cu, cuda_convt.cu).
//
// A block computes a tile of kBM = 128 rows of an implicit GEMM whose depth
// is walked in stages of one tap x 64 channels (128-byte rows):
//
//   - Rows are the positions of a box of the grid (bn images x bh x bw, see
//     Box), so a tap's shift is the box's start coordinate in a TMA tensor
//     map of x, and TMA's zero fill of coordinates outside the tensor is
//     the conv's zero padding: no row table, no bounds tests.
//   - A (128 rows x 64 channels, K-major) and B (64 depth rows x BN output
//     channels of the HWIO weight, N-major) arrive by TMA, with the 128-byte
//     swizzle the wgmma descriptors name, into a ring of STAGES slots in
//     shared memory.  One producer thread keeps the ring full; a full and an
//     empty mbarrier per slot hand it between producer and consumers.
//   - Two consumer warpgroups each multiply 64 of the rows with
//     wgmma.mma_async (bf16 operands, fp32 accumulators in registers; B is
//     read N-major through the transpose flag, not from a transposed copy).
//     One stage of products stays in flight while the next one's data
//     arrives; a slot is released when its products are done.
//
// Callers bring the per-step copies (a functor) and the epilogue, which
// takes the accumulators in registers.  Host helpers encode the tensor maps
// through the runtime's driver entry point, so no -lcuda is needed.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace tg {
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;                 // tile rows: 2 consumer warpgroups
constexpr int kBK = 64;                  // depth per stage: 64 channels
constexpr int kRowBytes = kBK * 2;       // one 128-byte swizzle row
constexpr int kATile = kBM * kRowBytes;  // 16 KB
constexpr int kConsumers = 256;          // threads of the 2 consumer groups
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kConsumerWarps = kConsumers / 32;

enum Act { kNone = 0, kRelu = 1, kLeaky = 2, kTanh = 3 };

__device__ __forceinline__ float apply_act(float y, int act, float leak) {
  switch (act) {
    case kRelu: return y > 0.f ? y : 0.f;
    case kLeaky: return y > 0.f ? y : y * leak;
    case kTanh: return tanhf(y);
    default: return y;
  }
}

// ---------------------------------------------------------------- geometry

// A box of a grid of n images x h x w positions: bn images x bh x bw
// positions, at most kBM rows, row r = (image * bh + i) * bw + j inside the
// box.  Tile t of the grid is the box at (n0, i0, j0); rows past the grid's
// edge (or past rows()) are computed on whatever the slot holds and masked.
struct Box {
  int n, h, w;
  int bn, bh, bw;
  int tn, th, tw;
  __host__ __device__ int rows() const { return bn * bh * bw; }
  __host__ __device__ int tiles() const { return tn * th * tw; }
  __device__ void origin(int t, int& n0, int& i0, int& j0) const {
    const int a = t / (th * tw), rem = t - a * th * tw, b = rem / tw;
    n0 = a * bn;
    i0 = b * bh;
    j0 = (rem - b * tw) * bw;
  }
  __device__ bool at(int r, int n0, int i0, int j0, int& img, int& i,
                     int& j) const {
    const int pb = bh * bw, a = r / pb, rem = r - a * pb, b = rem / bw;
    img = n0 + a;
    i = i0 + b;
    j = j0 + rem - b * bw;
    return r < rows() && img < n && i < h && j < w;
  }
};

inline Box make_box(int n, int h, int w) {
  Box B;
  B.n = n;
  B.h = h;
  B.w = w;
  B.bw = w < kBM ? w : kBM;
  B.bh = h < kBM / B.bw ? h : kBM / B.bw;
  B.bn = n < kBM / (B.bw * B.bh) ? n : kBM / (B.bw * B.bh);
  B.tn = (n + B.bn - 1) / B.bn;
  B.th = (h + B.bh - 1) / B.bh;
  B.tw = (w + B.bw - 1) / B.bw;
  return B;
}

// ----------------------------------------------------------------- PTX bits

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase differs from `parity`.  A wait that has
// not ended after ~2^34 cycles (seconds; a stage takes microseconds) is a
// fault in the ring: trap, so that the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_5d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1, int c2,
                                       int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 = B128.
__device__ __forceinline__ uint64_t desc_b128(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// K-major A or B (rows of 64 channels, 8-row groups 1024 bytes apart); the
// next 16-deep slice starts 32 bytes on (descriptor + 2).
__device__ __forceinline__ uint64_t desc_kmajor(const void* p) {
  return desc_b128(p, 16, 1024);
}

// N-major B as TMA writes it: boxes of 64 depth rows x 64 channels, 8-row
// groups 1024 bytes apart (SBO), 64-channel boxes 8192 bytes apart (LBO);
// the next 16-deep slice starts 2048 bytes on (descriptor + 128).
__device__ __forceinline__ uint64_t desc_nmajor(const void* p) {
  return desc_b128(p, kBK * kRowBytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin accumulator registers around asynchronous wgmma: their uses cannot be
// moved across the fence.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int P, int R>
__device__ __forceinline__ void fence_acc(float (&d)[P][R]) {
#pragma unroll
  for (int p = 0; p < P; ++p) fence_acc(d[p]);
}

// m64nNk16, bf16 x bf16 -> f32, D += A * B; kTransB = 1 reads B N-major.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n8(float (&d)[4], uint64_t da,
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3},"
      " %4, %5, p, 1, 1, 0, %7;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTransB));
}

// One 64-deep stage of a 64 x BN product: 4 wgmma k16 slices, A K-major
// and B N-major.
template <int BN>
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2], uint64_t da,
                                          uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    if constexpr (BN == 128)
      wgmma_m64n128<1>(acc, da + 2 * kk, db + 128 * kk);
    else
      wgmma_m64n64<1>(acc, da + 2 * kk, db + 128 * kk);
  }
}

// ------------------------------------------------------------------- ring

// Shared memory of a ring: STAGES A slots (kATile each), STAGES B slots
// (kBTile each, 0 when B is not in the ring), then the barriers.
template <int STAGES, int kBTile>
struct Ring {
  static constexpr int kB = STAGES * kATile;
  static constexpr int kBar = kB + STAGES * kBTile;
  static constexpr int kBytes = kBar + 2 * STAGES * 8;
  unsigned char* base;
  __device__ unsigned char* a(int slot) const { return base + slot * kATile; }
  __device__ unsigned char* b(int slot) const {
    return base + kB + slot * kBTile;
  }
  __device__ uint64_t* full(int slot) const {
    return reinterpret_cast<uint64_t*>(base + kBar) + slot;
  }
  __device__ uint64_t* empty(int slot) const {
    return reinterpret_cast<uint64_t*>(base + kBar) + STAGES + slot;
  }
  // One thread: full barriers take the producer's arrival (plus the copies'
  // bytes), empty ones an arrival from each consumer warp.
  __device__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerWarps);
    }
    fence_barrier_init();
  }
};

// The dynamic shared memory, rounded up to 1024 bytes (the 128-byte
// swizzle's period); launches ask for kBytes + 1024.
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ __align__(128) unsigned char dyn_smem[];
  const uint32_t a = smem_u32(dyn_smem);
  return dyn_smem + (((a + 1023) & ~1023u) - a);
}

// The producer: for the n steps of a tile that start at ring position k0
// (the steps of the block's earlier tiles), wait for each slot to be free,
// arm its full barrier with the stage's bytes and issue the copies:
// load(step of the tile, slot, bar).  Called by one thread.
template <int STAGES, int kBTile, class Load>
__device__ __forceinline__ void produce(const Ring<STAGES, kBTile>& R, int k0,
                                        int n, uint32_t bytes, Load load) {
  for (int k = k0; k < k0 + n; ++k) {
    const int slot = k % STAGES;
    mbar_wait(R.empty(slot), ((k / STAGES) & 1) ^ 1);
    mbar_expect_tx(R.full(slot), bytes);
    load(k - k0, slot, R.full(slot));
  }
}

// A consumer warpgroup, for the same n steps from ring position k0: wait
// for each slot's data, issue the step's products (mma(step of the tile,
// slot), asynchronous), and release the slot of the step before once its
// products are done.  Ends with every product complete and every slot
// released.  acc is the warpgroup's accumulators, pinned around each stage.
template <int STAGES, int kBTile, class Acc, class Mma>
__device__ __forceinline__ void consume(const Ring<STAGES, kBTile>& R, int k0,
                                        int n, Acc& acc, Mma mma) {
  const bool leader = (threadIdx.x & 31) == 0;
  for (int k = k0; k < k0 + n; ++k) {
    const int slot = k % STAGES;
    mbar_wait(R.full(slot), (k / STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
    mma(k - k0, slot);
    wgmma_commit();
    fence_acc(acc);
    wgmma_wait<1>();
    fence_acc(acc);
    if (k > k0 && leader) mbar_arrive(R.empty((k - 1) % STAGES));
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (n > 0 && leader) mbar_arrive(R.empty((k0 + n - 1) % STAGES));
}

// ------------------------------------------------------------- epilogue

// The accumulator fragment of m64nN: element e of thread `lane` in warp `w`
// (of its warpgroup) is row 16 w + lane / 4 + 8 ((e / 2) & 1), column
// 8 (e / 4) + 2 (lane % 4) + (e & 1).
__device__ __forceinline__ int frag_row(int w, int lane, int e) {
  return 16 * w + (lane >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int lane, int e) {
  return 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  __align__(16) bf16 h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16(v[i]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

// Floats of one warpgroup's staging tile in store_tile.
template <int BN>
constexpr int kStageFloats = 64 * (BN + 4);

// Stage a warpgroup's 64 x BN fp32 tile (the accumulators, already through
// the caller's epilogue arithmetic) in shared memory and write it out: row
// r (0..63 of the warpgroup) goes to y + off(r) + n0 .. n0 + BN - 1, columns
// < cout only; off(r) < 0 skips the row.  Rows leave as 16-byte vectors when
// cout % 8 == 0 (y, from torch.empty, is aligned), else element by element.
// `stage` holds 64 x (BN + 4) floats for this warpgroup; the caller has
// synchronised the consumers so that nothing else reads it.
template <int BN, typename OutT, class Off>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           float* stage, OutT* y, int n0,
                                           int cout, int wg, Off off) {
  constexpr int LD = BN + 4;
  const int t = threadIdx.x & 127, w = t >> 5, lane = t & 31;
#pragma unroll
  for (int e = 0; e < BN / 2; e += 2) {
    const int r = frag_row(w, lane, e), c = frag_col(lane, e);
    *reinterpret_cast<float2*>(stage + r * LD + c) =
        make_float2(acc[e], acc[e + 1]);
  }
  named_sync(2 + wg, 128);
  if (cout % 8 == 0) {
    for (int q = t; q < 64 * (BN / 8); q += 128) {
      const int r = q / (BN / 8), c = (q - r * (BN / 8)) * 8;
      const long long o = off(r);
      if (o >= 0 && n0 + c < cout) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = stage[r * LD + c + i];
        store8(y + o + n0 + c, v);
      }
    }
  } else {
    for (int q = t; q < 64 * BN; q += 128) {
      const int r = q / BN, c = q - r * BN;
      const long long o = off(r);
      if (o >= 0 && n0 + c < cout) store1(y + o + n0 + c, stage[r * LD + c]);
    }
  }
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map with the 128-byte swizzle and zero fill outside the
// tensor: dims and box innermost first, strides in bytes of dims 1.. .
// Returns false if the driver refuses it.
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box) {
  const EncodeTiled fn = encode_fn();
  if (!fn) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The HWIO weight as the (rows = 16 Cin, ldb) B matrix, 64 x 64 boxes.
inline bool encode_weight(CUtensorMap* map, const void* w, long long rows,
                          int ldb) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(ldb),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldb) * 2};
  const cuuint32_t box[2] = {kBK, kBK};
  return encode_bf16(map, w, 2, dims, strides, box);
}

// The host work a launch needs once per kernel, device and dynamic shared
// memory size, done at the first launch and remembered: the attribute call
// that allows `smem` bytes, and the blocks of kThreads the card holds at
// once (`resident`, for a persistent grid; may be null).  The train step is
// bound by the host's launches, so no launch repeats it.
inline cudaError_t kernel_setup(const void* kernel, int smem, int* resident) {
  struct Seen {
    const void* kernel;
    int dev, smem, resident;
  };
  constexpr int kMaxSeen = 64;
  static Seen seen[kMaxSeen];
  static int count = 0;
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < count; ++i) {
    const Seen& s = seen[i];
    if (s.kernel == kernel && s.dev == dev && s.smem == smem) {
      if (resident) *resident = s.resident;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return e;
  const Seen s{kernel, dev, smem, (per_sm > 1 ? per_sm : 1) * sms};
  if (count < kMaxSeen) seen[count++] = s;
  if (resident) *resident = s.resident;
  return cudaSuccess;
}

// Launch `kernel` on grid x block kThreads with `smem` dynamic bytes, as a
// cluster of `cluster_z` blocks along z (1: no cluster).
template <typename... Params, typename... Args>
inline cudaError_t launch(void (*kernel)(Params...), dim3 grid, int smem,
                          int cluster_z, cudaStream_t stream, Args... args) {
  cudaError_t e =
      kernel_setup(reinterpret_cast<const void*>(kernel), smem, nullptr);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster_z;
  cfg.attrs = attr;
  cfg.numAttrs = cluster_z > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
}

}  // namespace sm90
}  // namespace tg
