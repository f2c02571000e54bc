// Fused activation quantize + int8 matrix product for Hopper (sm_90a):
//
//   y[m, n] = f32(sum_k q(x[m, k]) w[n, k]) * (a * w_scale[n]) + bias[n]
//   q(v)    = clip(rint(v / a), -127, 127) as int8,  a = *a_scale
//
// x is (M, K) float32, w the int8 weight packed as (N, Kp) with K zero-padded to Kp, a
// multiple of 32; the sums are exact in int32.  Replaces the Pallas TPU kernel
// `pallas_qmatmul` / `_qmm_kernel` in scripts/exp_pallas_qmatmul.py, the fused form of
// the JAX package's QuantLinear (layers/quant.py).  Like it, this kernel quantizes x on
// its way into the product, so the float32 activation is read once and no int8 copy of
// it is written.
//
// Layout: a 128 x 128 output tile per block of 8 warps (4 along M x 2 along N, 32 x 64
// each), K staged through shared memory 32 at a time.  Each step reads a 128 x 32 float32
// tile of x (one float4 per thread and pass, 8 threads per row: coalesced), quantizes it
// in registers and stores it as int8; the weight tile is one 16-byte load per thread.  The
// next step's loads are issued before this step's products, so they are in flight while
// the tensor cores run.  Products are mma.sync m16n8k32 s8 x s8 -> s32 (row-major A,
// column-major B: w's (N, Kp) rows are B's columns).  Shared rows are padded to 48 bytes,
// which makes the fragment loads free of bank conflicts.
//
// Numbers: the division is IEEE (__fdiv_rn) and rint rounds half to even, as jnp.round
// and torch.round do; the epilogue converts the int32 sum once (round to nearest), then
// multiplies by the f32 product a * w_scale[n] and adds the bias, each step rounded on its
// own (__fmul_rn / __fadd_rn: no contraction into an FMA), so the result equals the plain
// version's bit for bit.
//
// What bounds it on the H100: bytes, at the shapes of int8 ConvNeXt-T.  2 M N K int8
// operations at 1,979 TOP/s take a fraction of the time that reading 4 M K bytes and
// writing 4 M N bytes of float32 take at 3.35 TB/s (about 15x at pwconv1 of stage 1).  The
// design reads x once per 128 output columns (L2 catches the re-reads of a row tile, whose
// column blocks run next to each other) and writes y once, straight from the accumulator
// fragments.  wgmma with a TMA-fed pipeline, and an int8 or bf16 output, are later steps.
//
// The C entry point launches on the caller's stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() of the launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 32;
constexpr int kRow = kBK + 16;  // shared row stride in bytes: conflict-free fragment loads
constexpr int kThreads = 256;

__device__ __forceinline__ int quant4(float4 v, float a) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  uint32_t packed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float q = rintf(__fdiv_rn(f[i], a));
    q = fminf(fmaxf(q, -127.f), 127.f);
    packed |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(q) << (8 * i);
  }
  return (int)packed;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The float32 x tile and the int8 w tile of step k0 into registers: x pass p covers
// rows p*32 .. p*32+31, thread -> (row xr, k xk .. xk+3); w thread -> (row wr, k wk .. wk+15).
__device__ __forceinline__ void load_tiles(float4 (&xv)[4], int4& wv, const float* x,
                                           const int8_t* w, int64_t m0, int n0, int k0,
                                           int64_t M, int K, int Kp, int N, int vec, int xr,
                                           int xk, int wr, int wk) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int64_t m = m0 + p * 32 + xr;
    const int k = k0 + xk;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < M) {
      const float* src = x + m * K + k;
      if (vec && k + 3 < K) {
        v = *reinterpret_cast<const float4*>(src);
      } else {
        if (k < K) v.x = src[0];
        if (k + 1 < K) v.y = src[1];
        if (k + 2 < K) v.z = src[2];
        if (k + 3 < K) v.w = src[3];
      }
    }
    xv[p] = v;
  }
  const int n = n0 + wr;
  wv = n < N ? *reinterpret_cast<const int4*>(w + (int64_t)n * Kp + k0 + wk)
             : make_int4(0, 0, 0, 0);
}

__global__ void __launch_bounds__(kThreads)
qmatmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ a_scale, const float* __restrict__ w_scale,
               const float* __restrict__ bias, float* __restrict__ y,
               int64_t M, int K, int Kp, int N, int vec) {
  __shared__ __align__(16) int8_t As[kBM * kRow];
  __shared__ __align__(16) int8_t Bs[kBN * kRow];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;  // mma fragment row group and thread in group
  const int wm = warp % 4, wn = warp / 4;
  const int n0 = blockIdx.x * kBN;
  const int64_t m0 = (int64_t)blockIdx.y * kBM;
  const float a = *a_scale;

  const int xr = tid / 8, xk = (tid % 8) * 4;  // this thread's x and w tile places
  const int wr = tid / 2, wk = (tid % 2) * 16;

  float4 xv[4];
  int4 wv;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  load_tiles(xv, wv, x, w, m0, n0, 0, M, K, Kp, N, vec, xr, xk, wr, wk);
  for (int k0 = 0; k0 < Kp; k0 += kBK) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      *reinterpret_cast<int*>(&As[(p * 32 + xr) * kRow + xk]) = quant4(xv[p], a);
    *reinterpret_cast<int4*>(&Bs[wr * kRow + wk]) = wv;
    __syncthreads();
    if (k0 + kBK < Kp)
      load_tiles(xv, wv, x, w, m0, n0, k0 + kBK, M, K, Kp, N, vec, xr, xk, wr, wk);

    int af[2][4], bf[8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* r0 = &As[(wm * 32 + i * 16 + g) * kRow + t4 * 4];
      const int8_t* r1 = r0 + 8 * kRow;
      af[i][0] = *reinterpret_cast<const int*>(r0);
      af[i][1] = *reinterpret_cast<const int*>(r1);
      af[i][2] = *reinterpret_cast<const int*>(r0 + 16);
      af[i][3] = *reinterpret_cast<const int*>(r1 + 16);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int8_t* r = &Bs[(wn * 64 + j * 8 + g) * kRow + t4 * 4];
      bf[j][0] = *reinterpret_cast<const int*>(r);
      bf[j][1] = *reinterpret_cast<const int*>(r + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    __syncthreads();
  }

  // epilogue: c0, c1 at (row g, cols 2 t4, 2 t4 + 1); c2, c3 at row g + 8
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + wn * 64 + j * 8 + t4 * 2;
    float sc[2], bi[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool ok = n + e < N;
      sc[e] = ok ? __fmul_rn(a, w_scale[n + e]) : 0.f;
      bi[e] = ok && bias != nullptr ? bias[n + e] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t m = m0 + wm * 32 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          v[e] = __fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), sc[e]);
          if (bias != nullptr) v[e] = __fadd_rn(v[e], bi[e]);
        }
        float* dst = y + m * N + n;
        if (n + 1 < N && (N % 2) == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          if (n < N) dst[0] = v[0];
          if (n + 1 < N) dst[1] = v[1];
        }
      }
    }
  }
}

}  // namespace

extern "C" int qmatmul_f32(const float* x, const int8_t* w, const float* a_scale,
                           const float* w_scale, const float* bias, float* y, int64_t M, int K,
                           int Kp, int N, int vec, void* stream_handle) {
  if (Kp % kBK != 0 || Kp < K) return (int)cudaErrorInvalidValue;
  const int64_t m_blocks = (M + kBM - 1) / kBM;
  if (m_blocks > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const dim3 grid((unsigned)((N + kBN - 1) / kBN), (unsigned)m_blocks);
  qmatmul_kernel<<<grid, kThreads, 0, stream>>>(x, w, a_scale, w_scale, bias, y, M, K, Kp, N,
                                                vec);
  return (int)cudaGetLastError();
}
