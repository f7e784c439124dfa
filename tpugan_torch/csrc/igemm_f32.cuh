// Implicit-GEMM mainloop for fp32 operands with fp32 sums on the CUDA
// cores (FFMA).  It serves the fp32 shapes that the three-pass TF32
// routes on the Hopper mainloop (igemm_sm90.cuh, consume_f32) do not take:
// Cin not a multiple of 32 (32 fp32 channels fill a stage's 128-byte row
// there) in the conv + BN statistics (cuda_conv_stats.cu) and the ConvT
// (cuda_convt.cu), and in the k4/s2/p1 conv (cuda_conv.cu) Cin above 16
// as well (its narrow TF32 tile takes Cin <= 16).
//
// Replaces: the fp32 function of tpugan/ops/pallas_conv.py, and of
// pallas_conv_stats.py and pallas_convt.py at those shapes, whose jnp.dot
// takes operands of the input's dtype (fp32 under train.precision="fp32")
// with fp32 sums.
//
// What bounds it on an H100: FFMA on the CUDA cores, 67 TFLOP/s.  A
// tensor-core path computes the same function to fp32's own accuracy (three
// TF32 passes over operands split into big + small, as the two TF32 routes
// do, at 165 TFLOP/s of fp32 products); this loop stays for the shapes
// not moved there (Cin not a multiple of 32: kernels 1 and 5 at the small
// test nets' narrow layers, kernel 4 only above Cin 16), which are small.
//
// What the design does about it (simple; the wide shapes moved to the
// tensor cores instead): a block of 256 threads computes a BM x BN tile of
// an implicit GEMM whose rows are the positions of a grid, whose depth is
// taps x Cin (k = t Cin + c: the HWIO weight's row order) and whose
// columns are output channels.  Each stage of kBK = 16 depth rows is
// gathered from x and w by cp.async into shared memory, double buffered,
// so the next stage's copies run while this one is multiplied; the copies
// zero-fill outside the image (the conv's padding), past the depth and
// past Cout, 16 bytes a copy where Cin (for x) or Cout (for w) is a
// multiple of 4, else 4 bytes.  Each thread holds a TM x TN register tile
// of accumulators and sums its depth in order with FFMA, reading A and B
// from shared memory as float4 along the depth: the same bits on every
// run, no atomics.
//
// A launch covers `groups` GEMMs of one shape (blockIdx.y): the conv is one
// (16 taps at stride 2), the ConvT four, one per output parity phase (4
// taps each, so no multiply is spent on a dilated input's zeros).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "igemm_sm90.cuh"  // apply_act, the activation codes, bf16

namespace tg {
namespace f32 {

constexpr int kThreads = 256;
constexpr int kBK = 16;  // depth rows a stage

// One launch's GEMMs.  Row r of group g is position (img, i, j) of the
// (n, gh, gw) grid; its tap t reads x at (img, i * stride + dh, j * stride
// + dw) and weight rows wt * cin .. (tap()); its output goes to (img, i *
// up + oy, j * up + ox) of the (n, gh * up, gw * up, cout) result, (oy,
// ox) = (0, 0) for the conv and the phase (g / 2, g % 2) for the ConvT.
struct Gemm {
  const float* x;  // (n, h, wd, cin)
  const float* w;  // (16 cin, ldb): HWIO rows
  int n, h, wd, cin;
  int gh, gw, rows;  // rows = n gh gw
  int stride, depth;  // depth = taps cin: 16 cin (conv), 4 cin (ConvT)
  int cout, ldb, up;
  int convt;  // 0: the conv (one group of 16 taps); 1: the ConvT's phases
};

// Tap t of group g: its input offset (dh, dw) and its weight tap wt = 4 kh
// + kw.  The conv's tap (kh, kw) = (t / 4, t % 4) reads offset (kh - 1, kw
// - 1).  The ConvT's output parity d reads kernel row k = 1 - d + 2 a at
// input offset o = d - a for a = 0, 1 (ops/kernel_common.TAPS: d = 0 takes
// (1, 0), (3, -1); d = 1 takes (0, 1), (2, 0)); likewise the columns.
__device__ __forceinline__ void tap(const Gemm& G, int g, int t, int& dh,
                                    int& dw, int& wt) {
  if (G.convt) {
    const int di = g >> 1, dj = g & 1, a = t >> 1, b = t & 1;
    dh = di - a;
    dw = dj - b;
    wt = 4 * (1 - di + 2 * a) + 1 - dj + 2 * b;
  } else {
    dh = (t >> 2) - 1;
    dw = (t & 3) - 1;
    wt = t;
  }
}

// The tile of a launch: BM x BN outputs a block, TM x TN a thread.
template <int BM_, int BN_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int TC = BN / TN;         // threads across the columns
  static constexpr int LDA = kBK + 4;        // A rows, 16-byte aligned
  static_assert((BM / TM) * TC == kThreads, "a register tile a thread");
  static constexpr int kFloats = 2 * BM * LDA + 2 * kBK * BN;
  static constexpr int kBytes = kFloats * 4;
};
using Wide = Tile<128, 64, 8, 4>;   // Cout > 8
using Narrow = Tile<256, 8, 8, 1>;  // Cout <= 8: the RGB layers

// ------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tg::sm90::smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tg::sm90::smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ------------------------------------------------------------- mainloop

// The sums of the block's tile: rows row0 .. row0 + BM - 1 of group g,
// columns n0 .. n0 + BN - 1; this thread's are rows row0 + tr TM + i,
// columns n0 + tc TN + j (tr = tid / TC, tc = tid % TC).  VA: x's copies
// are 16 bytes (cin % 4 == 0, x 16-byte aligned); VB: w's (cout % 4 ==
// 0, ldb % 4 == 0, w 16-byte aligned).  Ends with a __syncthreads(): the
// caller may reuse `smem`.
template <class T, bool VA, bool VB>
__device__ __forceinline__ void gemm_tile(const Gemm& G, int g, int row0,
                                          int n0, float* smem,
                                          float (&acc)[T::TM][T::TN]) {
  constexpr int AV = VA ? 4 : 1;               // floats an A copy
  constexpr int KQ = kBK / AV;                 // A copies along a row
  constexpr int RSTEP = kThreads / KQ;         // rows between a thread's
  constexpr int NA = T::BM / RSTEP;            // A copies a thread, a stage
  constexpr int BV = VB ? 4 : 1;
  constexpr int NQ = T::BN / BV;               // B copies along a row
  static_assert(T::BM % RSTEP == 0, "A copies split evenly");
  float* As = smem;                            // [2][BM][LDA]
  float* Bs = smem + 2 * T::BM * T::LDA;       // [2][kBK][BN]
  const int tid = threadIdx.x;
  const int kq = tid % KQ, rl0 = tid / KQ;

  // this thread's A rows: the image's first input row (img h), and the
  // grid position's input origin; -1 past the grid
  int rimg[NA], riy[NA], rix[NA];
  const int per = G.gh * G.gw;
#pragma unroll
  for (int u = 0; u < NA; ++u) {
    const int r = row0 + rl0 + u * RSTEP;
    if (r < G.rows) {
      const int img = r / per, rem = r - img * per, i = rem / G.gw;
      rimg[u] = img * G.h;
      riy[u] = i * G.stride;
      rix[u] = (rem - i * G.gw) * G.stride;
    } else {
      rimg[u] = -1;
      riy[u] = rix[u] = 0;
    }
  }

  auto load = [&](int s, int buf) {
    const int k0 = s * kBK;
    // A: this thread's depth column is the same for all its rows
    {
      const int k = k0 + kq * AV;
      const bool kv = k < G.depth;
      const int t = kv ? k / G.cin : 0, c = k - t * G.cin;
      int dh, dw, wt;
      tap(G, g, t, dh, dw, wt);
      float* dst = As + buf * T::BM * T::LDA + rl0 * T::LDA + kq * AV;
#pragma unroll
      for (int u = 0; u < NA; ++u) {
        const int iy = riy[u] + dh, ix = rix[u] + dw;
        const bool ok = kv && rimg[u] >= 0 && iy >= 0 && iy < G.h &&
                        ix >= 0 && ix < G.wd;
        const float* src =
            ok ? G.x + (static_cast<long long>(rimg[u] + iy) * G.wd + ix) *
                           G.cin + c
               : G.x;
        if (VA)
          cp16(dst + u * RSTEP * T::LDA, src, ok);
        else
          cp4(dst + u * RSTEP * T::LDA, src, ok);
      }
    }
    // B: kBK rows of the weight's tap rows, columns n0 ..
    for (int e = tid; e < kBK * NQ; e += kThreads) {
      const int kk = e / NQ, nq = e - kk * NQ;
      const int k = k0 + kk, n = n0 + nq * BV;
      const bool ok = k < G.depth && n < G.cout;
      const int t = ok ? k / G.cin : 0, c = k - t * G.cin;
      int dh, dw, wt;
      tap(G, g, t, dh, dw, wt);
      const float* src =
          ok ? G.w + static_cast<long long>(wt * G.cin + c) * G.ldb + n
             : G.w;
      float* dst = Bs + buf * kBK * T::BN + kk * T::BN + nq * BV;
      if (VB)
        cp16(dst, src, ok);
      else
        cp4(dst, src, ok);
    }
  };

  const int tr = tid / T::TC, tc = tid % T::TC;
#pragma unroll
  for (int i = 0; i < T::TM; ++i)
#pragma unroll
    for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.f;

  const int stages = (G.depth + kBK - 1) / kBK;
  load(0, 0);
  cp_commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) load(s + 1, (s + 1) & 1);
    cp_commit();  // an empty group past the last stage keeps the count
    cp_wait_all_but_one();  // stage s has landed (this thread's copies)
    __syncthreads();        // ... and every thread's
    const float* A = As + (s & 1) * T::BM * T::LDA + tr * T::TM * T::LDA;
    const float* B = Bs + (s & 1) * kBK * T::BN + tc * T::TN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[T::TM];
#pragma unroll
      for (int i = 0; i < T::TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(A + i * T::LDA + kk);
      float b[4][T::TN];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (T::TN == 4) {
          const float4 v =
              *reinterpret_cast<const float4*>(B + (kk + q) * T::BN);
          b[q][0] = v.x;
          b[q][1] = v.y;
          b[q][2] = v.z;
          b[q][3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < T::TN; ++j) b[q][j] = B[(kk + q) * T::BN + j];
        }
      }
#pragma unroll
      for (int i = 0; i < T::TM; ++i) {
        const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < T::TN; ++j)
            acc[i][j] = fmaf(av[q], b[q][j], acc[i][j]);
      }
    }
    __syncthreads();  // buffer s & 1 is free for stage s + 2
  }
}

// The output element offset of row r of group g (its first channel).
__device__ __forceinline__ long long out_offset(const Gemm& G, int g, int r) {
  const int per = G.gh * G.gw, img = r / per, rem = r - img * per;
  const int i = rem / G.gw, j = rem - i * G.gw;
  const int oy = i * G.up + (G.convt ? g >> 1 : 0);
  const int ox = j * G.up + (G.convt ? g & 1 : 0);
  return ((static_cast<long long>(img) * G.gh * G.up + oy) * G.gw * G.up +
          ox) * G.cout;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(tg::sm90::bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// y = act(acc * a[c] + b[c]), in OutT (fp32 or bf16, rounded to nearest).
template <class T, bool VA, bool VB, typename OutT>
__global__ void __launch_bounds__(kThreads)
affine_act_kernel(Gemm G, const float* a, const float* b, int act,
                  float leak, OutT* y) {
  extern __shared__ float4 smem4[];
  const int tiles_n = (G.cout + T::BN - 1) / T::BN;
  const int tm = blockIdx.x / tiles_n, n0 = (blockIdx.x - tm * tiles_n) * T::BN;
  const int g = blockIdx.y;
  float acc[T::TM][T::TN];
  gemm_tile<T, VA, VB>(G, g, tm * T::BM, n0, reinterpret_cast<float*>(smem4),
                       acc);
  const int tr = threadIdx.x / T::TC, tc = threadIdx.x % T::TC;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
    const int r = tm * T::BM + tr * T::TM + i;
    if (r >= G.rows) continue;
    OutT* row = y + out_offset(G, g, r);
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int n = n0 + tc * T::TN + j;
      if (n < G.cout)
        put(row + n,
            tg::sm90::apply_act(fmaf(acc[i][j], a[n], b[n]), act, leak));
    }
  }
}

// ------------------------------------------------------------- host side

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The conv's GEMM: x (n, h, wd, cin), w (4, 4, cin, ldb); one group of 16
// taps at stride 2, tap (kh, kw) at input offset (kh - 1, kw - 1).
inline Gemm conv_gemm(const float* x, const float* w, int n, int h, int wd,
                      int cin, int cout, int ldb) {
  Gemm G{};
  G.x = x;
  G.w = w;
  G.n = n;
  G.h = h;
  G.wd = wd;
  G.cin = cin;
  G.gh = h / 2;
  G.gw = wd / 2;
  G.rows = n * G.gh * G.gw;
  G.stride = 2;
  G.depth = 16 * cin;
  G.cout = cout;
  G.ldb = ldb;
  G.up = 1;
  G.convt = 0;
  return G;
}

// The ConvT's four phase GEMMs: x (n, h, wd, cin), w (4, 4, cin, ldb);
// output parity (di, dj) is group 2 di + dj, of 4 taps (tap()).
inline Gemm convt_gemm(const float* x, const float* w, int n, int h, int wd,
                       int cin, int cout, int ldb) {
  Gemm G{};
  G.x = x;
  G.w = w;
  G.n = n;
  G.h = h;
  G.wd = wd;
  G.cin = cin;
  G.gh = h;
  G.gw = wd;
  G.rows = n * h * wd;
  G.stride = 1;
  G.depth = 4 * cin;
  G.cout = cout;
  G.ldb = ldb;
  G.up = 2;
  G.convt = 1;
  return G;
}

// The row tiles of a layer of `rows` rows and `cout` channels: a block's BM.
inline int tiles_m(int rows, int cout) {
  const int bm = cout <= Narrow::BN ? Narrow::BM : Wide::BM;
  return (rows + bm - 1) / bm;
}

// Calls f(T{}, VA, VB) (VA, VB as std::integral_constant<bool>) with the
// tile for G's Cout and the copy widths its operands allow.
template <bool VA, bool VB, class F>
inline cudaError_t with_tile(const Gemm& G, F&& f) {
  using A = std::integral_constant<bool, VA>;
  using B = std::integral_constant<bool, VB>;
  return G.cout <= Narrow::BN ? f(Narrow{}, A{}, B{}) : f(Wide{}, A{}, B{});
}

template <bool VA, class F>
inline cudaError_t with_b(const Gemm& G, F&& f) {
  return G.cout % 4 == 0 && G.ldb % 4 == 0 && aligned16(G.w)
             ? with_tile<VA, true>(G, f)
             : with_tile<VA, false>(G, f);
}

template <class F>
inline cudaError_t dispatch(const Gemm& G, F&& f) {
  return G.cin % 4 == 0 && aligned16(G.x) ? with_b<true>(G, f)
                                          : with_b<false>(G, f);
}

// Check a layer's numbers against what the kernels take.
inline bool valid(const Gemm& G) {
  return G.n >= 1 && G.h >= 1 && G.wd >= 1 && G.cin >= 1 && G.cout >= 1 &&
         G.ldb >= G.cout && G.rows >= 1 &&
         static_cast<long long>(G.n) * G.h * G.wd * G.cin < (1ll << 31);
}

// The affine + activation kernel over G's groups.
template <typename OutT>
inline cudaError_t run_affine_act(const Gemm& G, int groups, const float* a,
                                  const float* b, int act, float leak,
                                  OutT* y, cudaStream_t s) {
  if (!valid(G)) return cudaErrorInvalidValue;
  return dispatch(G, [&](auto tile, auto va, auto vb) -> cudaError_t {
    using T = decltype(tile);
    constexpr bool VA = decltype(va)::value, VB = decltype(vb)::value;
    const dim3 grid((G.rows + T::BM - 1) / T::BM *
                        ((G.cout + T::BN - 1) / T::BN),
                    groups);
    affine_act_kernel<T, VA, VB, OutT><<<grid, kThreads, T::kBytes, s>>>(
        G, a, b, act, leak, y);
    return cudaGetLastError();
  });
}

}  // namespace f32
}  // namespace tg
