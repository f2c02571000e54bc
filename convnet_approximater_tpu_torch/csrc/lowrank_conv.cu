// Scheme-1 low-rank conv for Hopper (sm_90a), NHWC, x and y float32 or bfloat16, one launch
// per call:
//
//   Z[p, (m, c)] = basis_m (*) x[b, :, :, c] at output pixel p = (b, ho, wo)   (zero padded)
//   Y[p, n]      = sum_{m, c} Z[p, (m, c)] * A_mc[m * C + c, n] + bias[n]
//
// basis_m is a kh x kw filter shared by every input channel (the separable form v[m] (x) h[m]
// is expanded to its kh x kw outer product once per weight version, by the wrapper's packing).
//
// Replaces the Pallas TPU kernel `lowrank_conv` (bodies `_lowrank_sep_kernel` and
// `_lowrank_full_kernel`) in convnet_approximater_tpu/ops/pallas/lowrank_kernels.py.  Like it,
// this kernel reads x once, writes Y once and keeps Z out of device memory; unlike its
// per-image blocking, a block owns a tile of output pixels and output channels.
//
// What bounds it on the H100: operations.  The mix is 2 P (M C) N FLOP against kh kw (M C)
// for the basis, N / (kh kw) = 8-43 times more at AlexNet's convs 2-5, and the bytes are a
// few MB.  So the design follows the mix, on the tensor cores:
//
// - A block owns BM = 128 flattened output pixels (a tile may cross image boundaries) and
//   BN output channels, with four warpgroups: two producers compute Z on the CUDA cores into
//   a shared-memory ring, two consumers (64 pixel rows each) run the mix on the tensor cores
//   from it.  setmaxnreg moves registers from the producers to the consumers' accumulators.
// - The K axis walks channel quads (4 channels) x basis slabs (MS bases): one "group" of
//   MS / 2 wgmma k-steps is one ring stage.  A stage holds the group's Z (BM rows) and its
//   weight rows (BN), each as a TF32 high and a TF32 low part, in the swizzled K-major layout
//   of wgmma: rows of RB = 128 bytes (four k-steps of 32 bytes; the fourth unused at MS = 6)
//   or 64 bytes (MS = 4), 16-byte pieces XOR-swizzled by row.  The weight comes by TMA, one
//   box of RB / 4 columns x BN rows per part that the copy swizzles, issued by one thread of
//   a producer warp that changes from group to group.
// - The x window of qpg quads is double-buffered: x's rows seen as one stack of B H rows,
//   from the tile's first pixel's first tap row, Wv columns from -pw, so that a tile which
//   straddles images reads them from one window.  One 3-d TMA copy brings it (rows outside
//   the stack and columns outside the map arrive as zeros; the quad's channels swizzled in
//   cells of 16 qpg bytes, so that 32 pixels' reads do not collide); where x's rows are not
//   16-byte aligned (C % 4 != 0) or the window exceeds a TMA box, the producers copy it by
//   cp.async instead.  A tap row in the pixel's vertical padding reads a row of zeros.
// - A producer thread owns one pixel row and two channels of the quad (the two producer
//   warpgroups split the quad), reads each tap of x once for all MS bases (the taps of
//   AlexNet's 3 x 3 and 5 x 5 bases unrolled), and writes its Z as one 16-byte piece per
//   k-step and part: K' column q of a k-step is channel q / 2 of the quad and basis q % 2 of
//   the pair.
// - The mix is 3xTF32: each k-step accumulates Z_lo A_hi + Z_hi A_lo + Z_hi A_hi in float32
//   registers (wgmma.mma_async m64nBNk8 tf32, both operands from shared memory), which keeps
//   about float32's accuracy where one TF32 product keeps three digits (the low parts need
//   no rounding of their own: wgmma reads a TF32 operand's top 19 bits).  The tensor cores'
//   accumulation truncates, so they accumulate a chain of `chain` groups, which the
//   consumers then add into a float32 sum.
// - The epilogue adds the bias and writes y (P, N) through shared memory (the idle ring) in
//   whole 128-byte lines.
// Per-shape choices (MS, BN, qpg, stages, chain and the window's rows Rw) come from the planner
// in ops/lowrank_conv.py.
//
// bfloat16 (lowrank_conv_bf16): the kernel is templated on the element type T of x and y.  The
// x window in shared memory stays float32, in the layout above: the producers fill it from bf16
// x by plain loads, converting each value (exactly) on the way in, and arrive on the window's
// mbarrier themselves, so Z, the 3xTF32 mix and the float32 sums are the float32 kernel's.  The
// epilogue rounds each result to bf16 once (__float2bfloat16_rn) as it writes y.  The weights
// and taps stay float32 (the wrapper packs them so).
//
// The C entry point launches on the caller's stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() of the launch (0 on success).  A tile whose rows
// the planner's window would not hold traps.  The mbarrier, TMA and tensor-map helpers live
// in tma_ring.cuh.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

namespace {

constexpr int kConsumers = 256;                // two warpgroups, 64 pixel rows each
constexpr int kProducers = 256;                // two warpgroups, a pixel row and 2 channels each
constexpr int kThreads = kConsumers + kProducers;
constexpr int kConsumerRegs = 168;  // setmaxnreg: 256 x 168 + 256 x 88 = 512 x 128, the launch's
constexpr int kProducerRegs = 88;
constexpr int kBM = 128;                       // output pixels of a tile
constexpr int kStageLd = 40;                   // epilogue staging row stride in floats
constexpr int kStageBytes = 8 * 16 * kStageLd * 4;
constexpr int kSmemMax = 232448;               // dynamic shared memory a block may use

struct Conv {
  int B, H, W, C, N, kh, kw, sh, sw, ph, pw, Ho, Wo;
  int Wv;         // columns of a window row
  int Rw;         // window rows a tile holds
  int qpg;        // channel quads per window
  int nquads;     // ceil(C / 4)
  int nslab, Mp;  // basis slabs of MS bases, Mp = nslab MS
  int Kp;         // K' = 4 nquads Mp
  int stages;
  int chain;      // groups the tensor cores accumulate before the float32 sum takes them
  int P;          // B Ho Wo
  int vec;        // C % 4 == 0 and x 16-byte aligned: 16-byte copies
  int xtma;       // the windows come by TMA (vec, Wv <= 256, Rw <= 256)
  int zsh, zmask; // the window swizzle: 16-byte piece ^= (cell >> zsh) & zmask
};

// wgmma m64nNk8 f32 (+)= tf32 x tf32, both operands from shared-memory descriptors;
// acc_in = 0 overwrites the accumulators instead of adding to them
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int acc_in) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc_in));
  }
};

template <>
struct WgmmaTf32<96> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int acc_in) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "l"(da), "l"(db), "r"(acc_in));
  }
};

template <>
struct WgmmaTf32<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int acc_in) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc_in));
  }
};

// Rows of RB bytes: 128 (four k-steps) or 64 (two), swizzled in 16-byte pieces.
template <int MS>
__host__ __device__ constexpr int row_bytes() {
  return MS == 4 ? 64 : 128;
}

// wgmma descriptor of a K-major operand in RB-byte swizzled rows: 8-row groups 8 RB bytes
// apart, the leading offset unused (1), layout B128 or B64.
template <int RB>
__device__ __forceinline__ uint64_t desc_swizzled(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(8 * RB >> 4) << 32) | ((RB == 128 ? 1ull : 2ull) << 62);
}

// The byte offset of 16-byte piece c of row r in RB-byte swizzled rows (the pattern a TMA
// copy with the same swizzle writes and wgmma reads).
template <int RB>
__device__ __forceinline__ int swizzled(int r, int c) {
  return r * RB + ((c ^ (RB == 128 ? r & 7 : (r >> 1) & 3)) << 4);
}

// v rounded to TF32, to nearest with ties away from zero (the bits of cvt.rna.tf32.f32): half
// an ulp onto the magnitude, then truncate.  inf and NaN keep their bits.
__device__ __forceinline__ uint32_t to_tf32(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x7F800000u) == 0x7F800000u ? b : (b + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Byte offset of the 16-byte piece of quad `ql` of window cell f (row r Wv + column c): cells of
// 16 qpg bytes, the piece XOR-swizzled as a TMA copy with the window's swizzle leaves it.
__device__ __forceinline__ int window_at(int f, int ql, const Conv& s) {
  return f * 16 * s.qpg + ((ql ^ ((f >> s.zsh) & s.zmask)) << 4);
}

// The cp.async copy of the x window of channel quads [q0, q0 + qpg) that a TMA copy would
// make: window row r is row vbase + r of x's stack of B H rows, column c is column c - pw; zero
// outside x and past C.  Each producer thread then arrives on `bar` when its copies land.
// `t` is the calling producer thread (0 .. kProducers - 1).  bf16 x is read by plain loads and
// converted into the same float32 window; each thread arrives once its stores are made.
__device__ __forceinline__ void load_window(uint8_t* dst, const __nv_bfloat16* __restrict__ x,
                                            const Conv& s, int vbase, int q0, int t,
                                            uint32_t bar) {
  const int total = s.qpg * s.Rw * s.Wv;
  for (int idx = t; idx < total; idx += kProducers) {
    const int ql = idx % s.qpg;
    const int f = idx / s.qpg;
    const int v = vbase + f / s.Wv, win = f % s.Wv - s.pw;
    const int c = 4 * (q0 + ql);
    const bool ok = (unsigned)v < (unsigned)(s.B * s.H) && (unsigned)win < (unsigned)s.W;
    const __nv_bfloat16* src = x + (ok ? ((int64_t)v * s.W + win) * s.C + c : 0);
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = ok && c + i < s.C ? __bfloat162float(src[i]) : 0.f;
    *reinterpret_cast<float4*>(dst + window_at(f, ql, s)) = make_float4(e[0], e[1], e[2], e[3]);
  }
  mbar_arrive(bar);
}

__device__ __forceinline__ void load_window(uint8_t* dst, const float* __restrict__ x,
                                            const Conv& s, int vbase, int q0, int t,
                                            uint32_t bar) {
  const int total = s.qpg * s.Rw * s.Wv;
  for (int idx = t; idx < total; idx += kProducers) {
    const int ql = idx % s.qpg;  // quads fastest: neighbouring threads read neighbouring bytes
    const int f = idx / s.qpg;
    const int v = vbase + f / s.Wv, win = f % s.Wv - s.pw;
    const int c = 4 * (q0 + ql);
    const bool ok = (unsigned)v < (unsigned)(s.B * s.H) && (unsigned)win < (unsigned)s.W;
    const float* src = ok ? x + ((int64_t)v * s.W + win) * s.C + c : x;
    float* d = reinterpret_cast<float*>(dst + window_at(f, ql, s));
    if (s.vec) {
      cp_async16(d, src, ok && c < s.C ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool oke = ok && c + e < s.C;
        cp_async4(d + e, oke ? src + e : x, oke ? 4 : 0);
      }
    }
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

template <int MS>
__device__ __forceinline__ void load_taps(const float* p, float (&t)[MS]) {
  if constexpr (MS % 4 == 0) {
#pragma unroll
    for (int q = 0; q < MS / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      t[4 * q] = f.x, t[4 * q + 1] = f.y, t[4 * q + 2] = f.z, t[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < MS / 2; ++q) {
      const float2 f = reinterpret_cast<const float2*>(p)[q];
      t[2 * q] = f.x, t[2 * q + 1] = f.y;
    }
  }
}

// Z of one group for one pixel row, two channels (c, c + 1) of the quad and all MS bases of the
// slab, written as TF32 high and low parts: for k-step ss, the 16-byte piece 2 ss + c / 2
// (c basis 2ss, c basis 2ss + 1, c + 1 basis 2ss, c + 1 basis 2ss + 1) of this row.  `wb` is
// the quad's window buffer and `ql` the quad in it; tap (i, j) of this pixel is window cell
// cell0 + i Wv + j, or zero_cell + j where image row h0 + i is padding; `tp` holds the slab's
// taps (tap (i, j) at (i kw + j) Mp).  KH, KW > 0 unroll the taps (AlexNet's 3 x 3 and 5 x 5,
// so that their loads issue ahead of the FMAs); 0 takes kh, kw at run time.
template <int MS, int KH, int KW>
__device__ __forceinline__ void produce_z(const uint8_t* wb, int ql, int cell0, int zero_cell,
                                          int h0, const float* tp, int kh, int kw, int Mp,
                                          const Conv& s, uint8_t* zhi, uint8_t* zlo, int row,
                                          int half) {
  constexpr int RB = row_bytes<MS>();
  if (KH > 0) kh = KH, kw = KW;
  float za[MS], zb[MS];
#pragma unroll
  for (int m = 0; m < MS; ++m) za[m] = zb[m] = 0.f;
#pragma unroll
  for (int i = 0; i < (KH > 0 ? KH : kh); ++i) {
    const int f = (unsigned)(h0 + i) < (unsigned)s.H ? cell0 + i * s.Wv : zero_cell;
#pragma unroll
    for (int j = 0; j < (KW > 0 ? KW : kw); ++j) {
      const float2 xv =
          *reinterpret_cast<const float2*>(wb + window_at(f + j, ql, s) + 8 * half);
      float tv[MS];
      load_taps<MS>(tp + (i * kw + j) * Mp, tv);
#pragma unroll
      for (int m = 0; m < MS; ++m) {
        za[m] = fmaf(tv[m], xv.x, za[m]);
        zb[m] = fmaf(tv[m], xv.y, zb[m]);
      }
    }
  }
#pragma unroll
  for (int ss = 0; ss < MS / 2; ++ss) {
    const float v[4] = {za[2 * ss], za[2 * ss + 1], zb[2 * ss], zb[2 * ss + 1]};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      h[e] = to_tf32(v[e]);
      l[e] = __float_as_uint(__fsub_rn(v[e], __uint_as_float(h[e])));
    }
    const int at = swizzled<RB>(row, 2 * ss + half);
    *reinterpret_cast<uint4*>(zhi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(zlo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

template <int MS, int BN, typename T>
__global__ void __launch_bounds__(kThreads, 1)
lowrank_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap lmap,
               const __grid_constant__ CUtensorMap xmap, const T* __restrict__ x,
               const float* __restrict__ taps,
               const float* __restrict__ bias, T* __restrict__ y, const Conv s) {
  constexpr int H2 = MS / 2;               // k-steps of a group
  constexpr int RB = row_bytes<MS>();
  constexpr int kZPart = kBM * RB;         // a stage: Z high, Z low, weight high, weight low
  constexpr int kWPart = BN * RB;
  constexpr int kStage = 2 * (kZPart + kWPart);
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int row_b = 16 * s.qpg * s.Wv;               // bytes of a window row
  const int win_b = (s.Rw * row_b + 1023) & ~1023;    // of a window buffer, aligned for its swizzle
  uint8_t* win = ring + s.stages * kStage;            // two buffers, then a row of zeros
  const int ntaps = s.kh * s.kw;
  float* tap_s = reinterpret_cast<float*>(win + 2 * win_b + ((row_b + 1023) & ~1023));
  const uint32_t full = smem_u32(tap_s + ((ntaps * s.Mp + 3) & ~3)), empty = full + 8 * s.stages;
  const uint32_t wfull = empty + 8 * s.stages, wempty = wfull + 16;  // per window buffer

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;
  const int HW = s.Ho * s.Wo;
  // the tile's first window row: its first pixel's first tap row in x's stack of B H rows
  const int vbase = (m0 / HW) * s.H + ((m0 % HW) / s.Wo) * s.sh - s.ph;
  const int G = s.nquads * s.nslab;  // groups of the K walk
  const int nwin = (s.nquads + s.qpg - 1) / s.qpg;
  for (int i = tid; i < ntaps * s.Mp; i += kThreads) tap_s[i] = taps[i];
  for (int i = tid; i < row_b / 16; i += kThreads)
    reinterpret_cast<uint4*>(win + 2 * win_b)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(full + 8 * i, kProducers / 32 + 1);  // the producer warps and the weight's TMA
      mbar_init(empty + 8 * i, kConsumers / 32);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(wfull + 8 * i, s.xtma ? 1 : kProducers);  // the TMA's issuer, or every copier
      mbar_init(wempty + 8 * i, kProducers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int pl = min(m0 + kBM, s.P) - 1;  // the window must hold the tile's last pixel's taps
    if ((pl / HW) * s.H + ((pl % HW) / s.Wo) * s.sh - s.ph + s.kh - vbase > s.Rw) __trap();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producers: x windows, Z, and the weight's TMA
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int t = tid - kConsumers, row = t % kBM, half = t / kBM;  // pixel row, channel pair
    const int p = min(m0 + row, s.P - 1);  // rows past P compute a copy, never written
    const int b = p / HW, r = p % HW, ho = r / s.Wo, wo = r % s.Wo;
    const int h0 = ho * s.sh - s.ph;                               // its first tap row, in its image
    const int cell0 = (b * s.H + h0 - vbase) * s.Wv + wo * s.sw;   // the window cell of tap (0, 0)
    const int gpw = s.qpg * s.nslab;  // groups per window
    auto fetch = [&](int w) {         // window w into buffer w % 2, by a thread of warp w % 8
      uint8_t* dst = win + (w & 1) * win_b;
      if (s.xtma) {
        if (t == 32 * (w % (kProducers / 32))) {
          mbar_expect_tx(wfull + 8 * (w & 1), s.Rw * row_b);
          tma_load_3d(smem_u32(dst), &xmap, wfull + 8 * (w & 1), 4 * s.qpg * w, -s.pw, vbase);
        }
      } else {
        load_window(dst, x, s, vbase, w * s.qpg, t, wfull + 8 * (w & 1));
      }
    };
    fetch(0);
    if (nwin > 1) fetch(1);
    for (int g = 0; g < G; ++g) {
      const int w = g / gpw;
      if (g % gpw == 0) mbar_wait(wfull + 8 * (w & 1), (w >> 1) & 1);
      const int slot = g % s.stages;
      uint8_t* stage = ring + slot * kStage;
      mbar_wait(empty + 8 * slot, ((g / s.stages) & 1) ^ 1);
      if (t == 32 * (g % (kProducers / 32))) {  // the group's weight rows, by one thread of a
        // warp that changes with the group, so that no warp waits out every TMA issue
        mbar_expect_tx(full + 8 * slot, 2 * kWPart);
        const uint32_t wh = smem_u32(stage + 2 * kZPart);
        tma_load_2d(wh, &hmap, full + 8 * slot, g * H2 * 8, n0);
        tma_load_2d(wh + kWPart, &lmap, full + 8 * slot, g * H2 * 8, n0);
      }
      const int ql = g / s.nslab % s.qpg, slab = g % s.nslab;
      const uint8_t* wb = win + (w & 1) * win_b;
      const int zc = (2 - (w & 1)) * win_b / (16 * s.qpg) + wo * s.sw;  // the zero row, from wb
      const float* tp = tap_s + slab * MS;
      if (s.kh == 3 && s.kw == 3)
        produce_z<MS, 3, 3>(wb, ql, cell0, zc, h0, tp, 3, 3, s.Mp, s, stage, stage + kZPart, row,
                            half);
      else if (s.kh == 5 && s.kw == 5)
        produce_z<MS, 5, 5>(wb, ql, cell0, zc, h0, tp, 5, 5, s.Mp, s, stage, stage + kZPart, row,
                            half);
      else
        produce_z<MS, 0, 0>(wb, ql, cell0, zc, h0, tp, s.kh, s.kw, s.Mp, s, stage,
                            stage + kZPart, row, half);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the wgmma's reads
      __syncwarp();
      if (t % 32 == 0) mbar_arrive(full + 8 * slot);
      if (g % gpw == gpw - 1 || g == G - 1) {  // done with window w: its buffer takes w + 2
        if (t % 32 == 0) mbar_arrive(wempty + 8 * (w & 1));
        if (w + 2 < nwin) {
          if (s.xtma ? t == 32 * ((w + 2) % (kProducers / 32)) : true)
            mbar_wait(wempty + 8 * (w & 1), (w >> 1) & 1);
          fetch(w + 2);
        }
      }
    }
    return;
  }

  // the consumers: chains of groups on the tensor cores, each added into sum in float32
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = tid / 32, lane = tid % 32, wg = tid / 128;
  float acc[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = sum[i] = 0.f;
  int released = 0;
  for (int g = 0; g < G; ++g) {
    const int slot = g % s.stages;
    mbar_wait(full + 8 * slot, (g / s.stages) & 1);
    const uint32_t zh = smem_u32(ring + slot * kStage) + wg * (64 * RB);  // this warpgroup's rows
    const uint32_t wh = smem_u32(ring + slot * kStage + 2 * kZPart);
    fence_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ss = 0; ss < H2; ++ss) {
      const uint64_t a_hi = desc_swizzled<RB>(zh + 32 * ss);
      const uint64_t a_lo = desc_swizzled<RB>(zh + kZPart + 32 * ss);
      const uint64_t b_hi = desc_swizzled<RB>(wh + 32 * ss);
      const uint64_t b_lo = desc_swizzled<RB>(wh + kWPart + 32 * ss);
      WgmmaTf32<BN>::mma(acc, a_lo, b_hi, ss == 0 && g % s.chain == 0 ? 0 : 1);
      WgmmaTf32<BN>::mma(acc, a_hi, b_lo, 1);
      WgmmaTf32<BN>::mma(acc, a_hi, b_hi, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs(acc);
    int done = g;  // groups whose wgmmas completed
    if ((g + 1) % s.chain == 0 || g + 1 == G) {  // g ends a chain
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sum[i] += acc[i];
      done = g + 1;
    }
    for (; released < done; ++released)
      if (lane == 0) mbar_arrive(empty + 8 * (released % s.stages));
  }

  // epilogue: sum[4j + 2h + e] is (row lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e) of this
  // warp's 16 rows; each 16 x 32 block goes through shared memory (the ring, now idle) to
  // whole lines of y
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
  float* stage = reinterpret_cast<float*>(ring) + warp * 16 * kStageLd;
  const int r_base = m0 + wg * 64 + (warp % 4) * 16;
#pragma unroll
  for (int cc = 0; cc < BN / 32; ++cc) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = j * 8 + (lane % 4) * 2;
      const int n = n0 + cc * 32 + cl;
      const float b0 = n < s.N ? bias[n] : 0.f, b1 = n + 1 < s.N ? bias[n + 1] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = (cc * 4 + j) * 4 + 2 * h;
        *reinterpret_cast<float2*>(&stage[(lane / 4 + 8 * h) * kStageLd + cl]) =
            make_float2(sum[d] + b0, sum[d + 1] + b1);
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = lane + 32 * i;
      const int r = idx / 8, c = (idx % 8) * 4;
      const int p = r_base + r;
      const int n = n0 + cc * 32 + c;
      if (p < s.P && n < s.N) {
        const float4 v = *reinterpret_cast<const float4*>(&stage[r * kStageLd + c]);
        T* dst = y + (int64_t)p * s.N + n;
        if ((s.N & 3) == 0) {
          store4(dst, v);
        } else {
          store1(dst, v.x);
          if (n + 1 < s.N) store1(dst + 1, v.y);
          if (n + 2 < s.N) store1(dst + 2, v.z);
          if (n + 3 < s.N) store1(dst + 3, v.w);
        }
      }
    }
    __syncwarp();
  }
}

// x viewed as (B H rows, W, C) with boxes of (Rw rows, Wv columns, 4 qpg channels), the
// channels swizzled as the producers read them; a box past x's edges is filled with zeros.
bool make_window_map(CUtensorMap* map, const float* x, const Conv& s) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)s.C, (cuuint64_t)s.W, (cuuint64_t)s.B * s.H};
  const cuuint64_t strides[2] = {(cuuint64_t)s.C * 4, (cuuint64_t)s.W * s.C * 4};
  const cuuint32_t box[3] = {(cuuint32_t)(4 * s.qpg), (cuuint32_t)s.Wv, (cuuint32_t)s.Rw};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = s.qpg == 8   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : s.qpg == 4 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : s.qpg == 2 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                  : CU_TENSOR_MAP_SWIZZLE_NONE;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(x), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

int stage_bytes(int ms, int bn) { return 2 * (ms == 4 ? 64 : 128) * (kBM + bn); }

int smem_bytes(int ms, int bn, int stages, int qpg, int rw, int wv, int ntaps, int mp) {
  const int row_b = 16 * qpg * wv;
  return 1024 + stages * stage_bytes(ms, bn) + 2 * ((rw * row_b + 1023) & ~1023) +
         ((row_b + 1023) & ~1023) + 4 * ((ntaps * mp + 3) & ~3) + 16 * stages + 32;
}

template <int MS, int BN, typename T>
int launch(const CUtensorMap& hmap, const CUtensorMap& lmap, const CUtensorMap& xmap,
           const T* x, const float* taps, const float* bias, T* y, const Conv& s,
           int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(lowrank_kernel<MS, BN, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s.P + kBM - 1) / kBM, (s.N + BN - 1) / BN);
  lowrank_kernel<MS, BN, T><<<grid, kThreads, smem, stream>>>(hmap, lmap, xmap, x, taps, bias,
                                                              y, s);
  return static_cast<int>(cudaGetLastError());
}

// One call of either type: the checks, the tensor maps and the instantiation the plan names.
template <typename T>
int run(const T* x, const float* w, const float* taps, const float* bias, T* y, int B, int H,
        int W, int C, int N, int ms, int nslab, int kh, int kw, int sh, int sw, int ph, int pw,
        int bn, int qpg, int rw, int stages, int chain, void* stream_handle) {
  Conv s;
  s.B = B; s.H = H; s.W = W; s.C = C; s.N = N;
  s.kh = kh; s.kw = kw; s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw;
  s.Ho = sh > 0 ? (H + 2 * ph - kh) / sh + 1 : 0;
  s.Wo = sw > 0 ? (W + 2 * pw - kw) / sw + 1 : 0;
  s.Wv = (s.Wo - 1) * sw + kw;
  s.Rw = rw; s.qpg = qpg;
  s.nquads = (C + 3) / 4;
  s.nslab = nslab; s.Mp = ms * nslab;
  s.Kp = 4 * s.nquads * s.Mp;
  s.stages = stages;
  s.chain = chain;
  const int64_t P = (int64_t)B * s.Ho * s.Wo;
  s.P = (int)P;
  s.vec = sizeof(T) == 4 && C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  s.xtma = s.vec && s.Wv <= 256 && rw <= 256;
  s.zsh = qpg == 8 ? 0 : qpg == 4 ? 1 : 2;  // 128-, 64- or 32-byte swizzle; none for one quad
  s.zmask = qpg == 8 ? 7 : qpg == 4 ? 3 : qpg == 2 ? 1 : 0;
  const int smem = smem_bytes(ms, bn, stages, qpg, rw, s.Wv, kh * kw, s.Mp);
  if (B < 1 || C < 1 || N < 1 || s.Ho < 1 || s.Wo < 1 || nslab < 1 || stages < 2 || chain < 1 ||
      (qpg != 1 && qpg != 2 && qpg != 4 && qpg != 8) || rw < kh ||
      P + kBM > INT32_MAX || smem > kSmemMax || stages * stage_bytes(ms, bn) < kStageBytes ||
      (N + bn - 1) / bn > 65535 || (int64_t)B * H + rw > INT32_MAX ||
      (int64_t)(rw + 2) * 16 * qpg * s.Wv > INT32_MAX || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rb = ms == 4 ? 64 : 128;
  const CUtensorMapSwizzle swizzle = rb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap hmap, lmap, xmap;
  if (!make_map(&hmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, 4, N, s.Kp, bn, rb / 4, swizzle) ||
      !make_map(&lmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w + (int64_t)N * s.Kp, 4, N, s.Kp, bn,
                rb / 4, swizzle) ||
      (s.xtma && !make_window_map(&xmap, reinterpret_cast<const float*>(x), s)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
#define LOWRANK_LAUNCH(MS_, BN_)                                                 \
  if (ms == MS_ && bn == BN_)                                                    \
    return launch<MS_, BN_, T>(hmap, lmap, xmap, x, taps, bias, y, s, smem, stream);
  LOWRANK_LAUNCH(8, 128)
  LOWRANK_LAUNCH(8, 96)
  LOWRANK_LAUNCH(8, 64)
  LOWRANK_LAUNCH(6, 128)
  LOWRANK_LAUNCH(6, 96)
  LOWRANK_LAUNCH(6, 64)
  LOWRANK_LAUNCH(4, 128)
  LOWRANK_LAUNCH(4, 96)
  LOWRANK_LAUNCH(4, 64)
#undef LOWRANK_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The shared memory (bytes) a launch with this plan asks for; the planner's check.
extern "C" int lowrank_conv_smem_bytes(int ms, int bn, int stages, int qpg, int rw, int wv,
                                       int ntaps, int mp) {
  return smem_bytes(ms, bn, stages, qpg, rw, wv, ntaps, mp);
}

// x (B, H, W, C); w (2, N, Kp): A^T's TF32 high and low parts, K' = 4 ceil(C / 4) Mp columns in
// the kernel's order (ops/lowrank_conv.py: pack_kernel_weights); taps (kh kw, Mp): tap (i, j)
// of basis m at (i kw + j) Mp + m; bias (N,); y (B, Ho, Wo, N).  ms bases a slab, nslab slabs;
// bn, qpg, rw, stages and chain from the planner.
extern "C" int lowrank_conv_f32(const float* x, const float* w, const float* taps,
                                const float* bias, float* y, int B, int H, int W, int C, int N,
                                int ms, int nslab, int kh, int kw, int sh, int sw, int ph,
                                int pw, int bn, int qpg, int rw, int stages, int chain,
                                void* stream_handle) {
  return run(x, w, taps, bias, y, B, H, W, C, N, ms, nslab, kh, kw, sh, sw, ph, pw, bn, qpg, rw,
             stages, chain, stream_handle);
}

// x and y bf16; w, taps and bias float32.
extern "C" int lowrank_conv_bf16(const __nv_bfloat16* x, const float* w, const float* taps,
                                 const float* bias, __nv_bfloat16* y, int B, int H, int W, int C,
                                 int N, int ms, int nslab, int kh, int kw, int sh, int sw, int ph,
                                 int pw, int bn, int qpg, int rw, int stages, int chain,
                                 void* stream_handle) {
  return run(x, w, taps, bias, y, B, H, W, C, N, ms, nslab, kh, kw, sh, sw, ph, pw, bn, qpg, rw,
             stages, chain, stream_handle);
}
