// Fused activation quantize + int8 matrix product for Hopper (sm_90a):
//
//   y[m, n] = f32(sum_k q(x[m, k]) w[n, k]) * (a * w_scale[n]) + bias[n]
//   q(v)    = clip(rint(v / a), -127, 127) as int8,  a = *a_scale
//
// x is (M, Kx) float32 or bfloat16 (16-byte aligned rows, Kx a multiple of 4 or 8: the wrapper
// pads a ragged K), y (M, N) of x's type, w the int8 weight packed as (N, Kp), K zero-padded
// to Kp, a multiple of 32; the sums are exact in int32.  Replaces the Pallas TPU kernel `pallas_qmatmul` / `_qmm_kernel` in
// scripts/exp_pallas_qmatmul.py, the fused form of the JAX package's QuantLinear
// (layers/quant.py).  Like it, this kernel quantizes x on its way into the product, so the
// float32 activation is read once and no int8 copy of it reaches device memory.
//
// What bounds it on the H100: bytes.  At the 13 shapes of int8 ConvNeXt-T, reading 4 M K
// bytes of x and writing 4 M N bytes of y at 3.35 TB/s takes 2x (stage 4) to 15x (stage 1)
// longer than the 2 M N K int8 operations at 1,979 TOP/s.  So the design keeps many bytes
// in flight and touches x once:
//
// - A block owns a BM-row tile (BM = 128 where x is wide against N and M is large, else 64)
//   and a run of `ntpb` BN-column tiles.  Its 256 consumer threads (two warpgroups) quantize
//   the x tile once into an int8 panel in shared memory and walk the column tiles against
//   it.  Where a block takes a single column tile (N split over blocks to fill 132 SMs, as
//   at M = 3136 and M = 64, each split quantizing its own copy), or the panel would not fit
//   beside the rings, it keeps a ring of `ra` 128-byte K chunks instead.
// - One producer thread keeps TMA copies in flight through two mbarrier rings: `sx` stages
//   of float32 x boxes (BM rows x 32 floats) and `sb` stages of int8 weight boxes (BN rows
//   x 128 bytes, 128-byte swizzled by the copy, so that the packed (N, Kp) layout stays
//   row-major and qmatmul_ref reads it as it is).
// - The products are wgmma.mma_async m64nBNWk32 s8 x s8 -> s32, both operands K-major from
//   shared memory through 128-byte-swizzle descriptors; the consumers write the quantized
//   panel through the generic proxy, so fence.proxy.async and a barrier precede the wgmma
//   that reads it.  With BM = 128 each warpgroup takes 64 rows and all BN columns; with
//   BM = 64 both take the same rows and half the columns each.
// - The epilogue stages each warp's 16 x 32 tile in shared memory and writes y in whole
//   128-byte lines (float4 per thread).
// Per-shape choices (BM, BNW, ntpb, ra, sx, sb) come from the planner in ops/qmatmul.py.
//
// Numbers: the division gives IEEE's bits (__fdiv_rn, or a branch-free path with the same
// bits: see quant4) and rint rounds half to even, as torch.round does; the epilogue
// converts the int32 sum once (round to nearest), then multiplies by the f32 product
// a * w_scale[n] and adds the bias, each step rounded on its own (__fmul_rn / __fadd_rn: no
// contraction into an FMA), so the result equals the plain version's bits.
//
// bfloat16 (qmatmul_bf16): the kernel is templated on the element type T of x and y.  An x box
// is BM rows x 32 bf16 (64 bytes a row, one wgmma k-step as in float32), under a BFLOAT16
// tensor map; each consumer reads its groups of 4 values as 8 bytes and converts them to
// float32, which is exact, so the quantize (and its quotient's bits) is the float32 one.  The
// epilogue computes y in float32 as before and rounds each value to bf16 once
// (__float2bfloat16_rn, to nearest even) as it writes the staged lines, which is the plain
// version's `.to(torch.bfloat16)` of its float32 y: the bits still agree.  The x ring's shared
// memory is planned at 4 bytes an element either way, so one plan serves both types.
//
// The C entry point launches on the caller's stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() of the launch (0 on success).  The tensor maps
// are encoded on the host through the driver entry point, so the library needs no -lcuda.
// A wait on an mbarrier that does not complete within about 10 s traps instead of hanging.
// The mbarrier, TMA, descriptor and tensor-map helpers live in tma_ring.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tma_ring.cuh"

namespace {

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kChunk = 128;                // K bytes of a panel chunk / weight box row
constexpr int kXCols = 32;                 // values of an x box row: one wgmma k-step
constexpr int kStageLd = 40;               // epilogue staging row stride in floats
constexpr int kStageBytes = 8 * 16 * kStageLd * 4;
constexpr int kSmemMax = 232448;           // dynamic shared memory a block may use

template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  static __device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, %48, %49, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
        : "l"(da), "l"(db), "r"(acc));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int* d, uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(acc));
  }
};

// q(v) = clip(rint(v / a), -127, 127) of four values, as int8 bytes packed low to high.
//
// __fdiv_rn expands to a branch per element (its slow path), which keeps the compiler from
// interleaving the divisions of a thread; the quantize then bounds the kernel.  So `fast`
// takes a branch-free path where it is exact: r = 1/a correctly rounded (__frcp_rn, once
// per thread), q0 = v r, then two residual corrections q' = q + (v - a q) r with the
// residual exact in an FMA.  After the first correction q is within one ulp of v / a, and
// by Markstein's theorem the second gives the correctly rounded quotient, __fdiv_rn's
// bits, as long as nothing overflows or underflows: the caller asks for it only when
// 2^-60 <= a <= 2^60 and every |v| <= 2^60 (a tiny quotient rounds to 0 either way).
// Anything else (NaN, inf, huge values) takes __fdiv_rn.  The clamp comes before the
// rounding (the same integers), and adding 1.5 * 2^23 rounds to nearest even and leaves
// the integer's two's-complement byte in the low bits.
__device__ __forceinline__ uint32_t to_byte(float q) {
  return __float_as_uint(__fadd_rn(fminf(fmaxf(q, -127.f), 127.f), 12582912.f));
}

__device__ __forceinline__ int quant4(float4 v, float a, float r, bool fast) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  uint32_t b[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (fast) {
      float q = __fmul_rn(f[i], r);
      q = __fmaf_rn(__fmaf_rn(-a, q, f[i]), r, q);
      q = __fmaf_rn(__fmaf_rn(-a, q, f[i]), r, q);
      b[i] = to_byte(q);
    } else {
      b[i] = to_byte(rintf(__fdiv_rn(f[i], a)));
    }
  }
  return static_cast<int>(
      __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410));
}

__device__ __forceinline__ bool in_fast_range(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))) <= 0x1p60f;
}

// Values 4 i .. 4 i + 3 of a staged x box as float32 (bf16 converted exactly).
__device__ __forceinline__ float4 load4(const float* xs, int i) {
  return reinterpret_cast<const float4*>(xs)[i];
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* xs, int i) {
  const uint2 u = reinterpret_cast<const uint2*>(xs)[i];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// The byte offset of (row r, byte kb of the chunk) in a 128-byte-swizzled panel chunk.
__device__ __forceinline__ int swz(int r, int kb) {
  return r * kChunk + ((((kb >> 4) ^ (r & 7)) << 4) | (kb & 15));
}

template <int BM, int BNW, typename T>
__global__ void __launch_bounds__(kThreads, 1)
qmatmul_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
               const float* __restrict__ a_scale, const float* __restrict__ w_scale,
               const float* __restrict__ bias, T* __restrict__ y, int M, int N, int Kx,
               int Kp, int n_tiles, int ntpb, int ra, int sx, int sb) {
  constexpr int BN = BM == 128 ? BNW : 2 * BNW;
  constexpr int kSlot = BM * kChunk;
  constexpr int kBStage = BN * kChunk;
  constexpr int kXStage = BM * kXCols * sizeof(T);
  constexpr int kXVecs = BM * kXCols / 4 / kConsumers;  // groups of 4 values of an x box per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* A = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* B = A + ra * kSlot;
  uint8_t* U = B + sb * kBStage;  // the x ring, then the epilogue staging
  const int u_bytes = sx * kXStage > kStageBytes ? sx * kXStage : kStageBytes;
  const uint32_t xf = smem_u32(U + u_bytes), xe = xf + 8 * sx, bf = xe + 8 * sx,
                 be = bf + 8 * sb;

  const int tid = threadIdx.x;
  const int Kc = (Kp + kChunk - 1) / kChunk;
  const int nt0 = blockIdx.x * ntpb;
  const int nt_count = min(ntpb, n_tiles - nt0);
  const int m0 = blockIdx.y * BM;
  if (tid == 0) {
    for (int i = 0; i < sx; ++i) {
      mbar_init(xf + 8 * i, 1);
      mbar_init(xe + 8 * i, kConsumers / 32);
    }
    for (int i = 0; i < sb; ++i) {
      mbar_init(bf + 8 * i, 1);
      mbar_init(be + 8 * i, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer: TMA copies in the order the consumers take them
    if (tid == kConsumers) {
      int xi = 0, bi = 0;
      for (int t = 0; t < nt_count; ++t) {
        for (int kc = 0; kc < Kc; ++kc) {
          const int steps = min(4, (Kp - kc * kChunk) / 32);
          for (int s = 0; t == 0 && s < steps; ++s) {
            const int k = kc * kChunk + s * kXCols;
            if (k >= Kx) break;  // the consumers zero the rest of the chunk
            const int st = xi % sx;
            mbar_wait(xe + 8 * st, ((xi / sx) & 1) ^ 1);
            mbar_expect_tx(xf + 8 * st, kXStage);
            tma_load_2d(smem_u32(U + st * kXStage), &xmap, xf + 8 * st, k, m0);
            ++xi;
          }
          const int st = bi % sb;
          mbar_wait(be + 8 * st, ((bi / sb) & 1) ^ 1);
          mbar_expect_tx(bf + 8 * st, kBStage);
          tma_load_2d(smem_u32(B + st * kBStage), &wmap, bf + 8 * st, kc * kChunk,
                      (nt0 + t) * BN);
          ++bi;
        }
      }
    }
    return;
  }

  const float a = *a_scale;
  const float r = __frcp_rn(a);
  const bool a_fast = a >= 0x1p-60f && a <= 0x1p60f;
  const int warp = tid / 32, lane = tid % 32, wg = tid / 128;
  const int row_off = BM == 128 ? 64 * wg : 0;   // this warpgroup's rows of the tile
  const int col_off = BM == 128 ? 0 : BNW * wg;  // and its columns
  int acc[BNW / 2];
  int xi = 0, bi = 0;
  for (int t = 0; t < nt_count; ++t) {
    for (int kc = 0; kc < Kc; ++kc) {
      const int steps = min(4, (Kp - kc * kChunk) / 32);
      uint8_t* slot = A + (kc % ra) * kSlot;
      if (t == 0) {  // quantize the x chunk into the panel (or the ring's slot)
        for (int s = 0; s < steps; ++s) {
          const int k = kc * kChunk + s * kXCols;
          if (k < Kx) {
            const int st = xi % sx;
            mbar_wait(xf + 8 * st, (xi / sx) & 1);
            const T* xs = reinterpret_cast<const T*>(U + st * kXStage);
            float4 xv[kXVecs];
            bool fast = a_fast;
#pragma unroll
            for (int i = 0; i < kXVecs; ++i) {
              xv[i] = load4(xs, tid + kConsumers * i);
              fast = fast && in_fast_range(xv[i]);
            }
            int words[kXVecs];
            if (fast) {
#pragma unroll
              for (int i = 0; i < kXVecs; ++i) words[i] = quant4(xv[i], a, r, true);
            } else {
#pragma unroll
              for (int i = 0; i < kXVecs; ++i) words[i] = quant4(xv[i], a, r, false);
            }
            __syncwarp();
            if (lane == 0) mbar_arrive(xe + 8 * st);
            ++xi;
#pragma unroll
            for (int i = 0; i < kXVecs; ++i) {
              const int idx = tid + kConsumers * i;
              *reinterpret_cast<int*>(slot + swz(idx >> 3, s * kXCols + (idx & 7) * 4)) =
                  words[i];
            }
          } else {
#pragma unroll
            for (int i = 0; i < kXVecs; ++i) {
              const int idx = tid + kConsumers * i;
              *reinterpret_cast<int*>(slot + swz(idx >> 3, s * kXCols + (idx & 7) * 4)) = 0;
            }
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
      }
      const int st = bi % sb;
      mbar_wait(bf + 8 * st, (bi / sb) & 1);
      const uint32_t a_base = smem_u32(slot) + row_off * kChunk;
      const uint32_t b_base = smem_u32(B + st * kBStage) + col_off * kChunk;
      fence_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int s = 0; s < steps; ++s)
        Wgmma<BNW>::mma(acc, desc_b128(a_base + 32 * s), desc_b128(b_base + 32 * s),
                        (kc | s) != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(be + 8 * st);
      ++bi;
    }

    // epilogue: d[4j + 2h + e] is (row lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e) of
    // this warp's 16 rows; each 16 x CW block goes through shared memory to whole lines
    constexpr int CW = BNW < 32 ? BNW : 32;
    float* stage = reinterpret_cast<float*>(U) + warp * 16 * kStageLd;
    const int64_t m_base = static_cast<int64_t>(m0) + row_off + (warp % 4) * 16;
    const int n_base = (nt0 + t) * BN + col_off;
#pragma unroll
    for (int cc = 0; cc < BNW / CW; ++cc) {
#pragma unroll
      for (int j = 0; j < CW / 8; ++j) {
        const int cl = j * 8 + (lane & 3) * 2;
        const int n = n_base + cc * CW + cl;
        float sc[2], bs[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = n + e < N;
          sc[e] = ok ? __fmul_rn(a, w_scale[n + e]) : 0.f;
          bs[e] = ok && bias != nullptr ? bias[n + e] : 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int d = (cc * (CW / 8) + j) * 4 + 2 * h;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = __fmul_rn(__int2float_rn(acc[d + e]), sc[e]);
            if (bias != nullptr) v[e] = __fadd_rn(v[e], bs[e]);
          }
          *reinterpret_cast<float2*>(&stage[((lane >> 2) + 8 * h) * kStageLd + cl]) =
              make_float2(v[0], v[1]);
        }
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 16 * CW / 4 / 32; ++i) {
        const int idx = lane + 32 * i;
        const int r = idx / (CW / 4), c = (idx % (CW / 4)) * 4;
        const int64_t m = m_base + r;
        const int n = n_base + cc * CW + c;
        if (m < M && n < N) {
          const float4 v = *reinterpret_cast<const float4*>(&stage[r * kStageLd + c]);
          T* dst = y + m * N + n;
          if ((N & 3) == 0) {
            store4(dst, v);
          } else {
            store1(dst, v.x);
            if (n + 1 < N) store1(dst + 1, v.y);
            if (n + 2 < N) store1(dst + 2, v.z);
            if (n + 3 < N) store1(dst + 3, v.w);
          }
        }
      }
      __syncwarp();
    }
  }
}

int smem_bytes(int bm, int bn, int ra, int sx, int sb) {
  const int x_ring = sx * bm * kXCols * 4;
  return 1024 + ra * bm * kChunk + sb * bn * kChunk +
         (x_ring > kStageBytes ? x_ring : kStageBytes) + 16 * (sx + sb);
}

template <int BM, int BNW, typename T>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* a_scale,
           const float* w_scale, const float* bias, T* y, int M, int N, int Kx, int Kp,
           int ntpb, int ra, int sx, int sb, cudaStream_t stream) {
  constexpr int BN = BM == 128 ? BNW : 2 * BNW;
  const int n_tiles = (N + BN - 1) / BN;
  const int smem = smem_bytes(BM, BN, ra, sx, sb);
  cudaError_t err = cudaFuncSetAttribute(qmatmul_kernel<BM, BNW, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_tiles + ntpb - 1) / ntpb, (M + BM - 1) / BM);
  qmatmul_kernel<BM, BNW, T><<<grid, kThreads, smem, stream>>>(
      xmap, wmap, a_scale, w_scale, bias, y, M, N, Kx, Kp, n_tiles, ntpb, ra, sx, sb);
  return static_cast<int>(cudaGetLastError());
}

// x (M, Kx) of type T, y (M, N) of type T; everything else as qmatmul_f32 takes it.
template <typename T>
int run(const T* x, const int8_t* w, const float* a_scale, const float* w_scale,
        const float* bias, T* y, int M, int Kx, int Kp, int N, int bm, int bnw, int ntpb, int ra,
        int sx, int sb, void* stream_handle) {
  const int bn = bm == 128 ? bnw : 2 * bnw;
  const int Kc = (Kp + kChunk - 1) / kChunk;
  if (Kp % 32 != 0 || Kp < Kx || Kx % (16 / sizeof(T)) != 0 || M < 1 || N < 1 || ntpb < 1 ||
      sx < 1 || sb < 1 || ra < 1 || ra > Kc || (ra < Kc && (ra < 2 || ntpb != 1)) ||
      smem_bytes(bm, bn, ra, sx, sb) > kSmemMax ||
      (M + bm - 1) / bm > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  if (!make_map(&xmap,
                sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                x, sizeof(T), M, Kx, bm, kXCols, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 1, N, Kp, bn, kChunk,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
#define QMM_LAUNCH(BM_, BNW_)                                                                \
  if (bm == BM_ && bnw == BNW_)                                                              \
    return launch<BM_, BNW_, T>(xmap, wmap, a_scale, w_scale, bias, y, M, N, Kx, Kp, ntpb,  \
                                ra, sx, sb, stream);
  QMM_LAUNCH(128, 128)
  QMM_LAUNCH(128, 96)
  QMM_LAUNCH(128, 64)
  QMM_LAUNCH(64, 128)
  QMM_LAUNCH(64, 96)
  QMM_LAUNCH(64, 64)
  QMM_LAUNCH(64, 32)
  QMM_LAUNCH(64, 16)
  QMM_LAUNCH(64, 8)
#undef QMM_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The shared memory (bytes) a launch with this plan asks for; the planner's check.
extern "C" int qmatmul_smem_bytes(int bm, int bnw, int ra, int sx, int sb) {
  return smem_bytes(bm, bm == 128 ? bnw : 2 * bnw, ra, sx, sb);
}

extern "C" int qmatmul_f32(const float* x, const int8_t* w, const float* a_scale,
                           const float* w_scale, const float* bias, float* y, int M, int Kx,
                           int Kp, int N, int bm, int bnw, int ntpb, int ra, int sx, int sb,
                           void* stream_handle) {
  return run(x, w, a_scale, w_scale, bias, y, M, Kx, Kp, N, bm, bnw, ntpb, ra, sx, sb,
             stream_handle);
}

// x (M, Kx) and y (M, N) bf16, Kx a multiple of 8.
extern "C" int qmatmul_bf16(const __nv_bfloat16* x, const int8_t* w, const float* a_scale,
                            const float* w_scale, const float* bias, __nv_bfloat16* y, int M,
                            int Kx, int Kp, int N, int bm, int bnw, int ntpb, int ra, int sx,
                            int sb, void* stream_handle) {
  return run(x, w, a_scale, w_scale, bias, y, M, Kx, Kp, N, bm, bnw, ntpb, ra, sx, sb,
             stream_handle);
}
