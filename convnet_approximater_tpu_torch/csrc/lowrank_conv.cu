// Scheme-1 low-rank conv for Hopper (sm_90a), float32, NHWC:
//
//   Z[b, ho, wo, m, c] = basis_m (*) x[b, :, :, c]     (strided, zero padded)
//   Y[b, ho, wo, n]    = sum_{m, c} Z[b, ho, wo, m, c] * A_mc[m * C + c, n] + bias[n]
//
// basis_m is either a separable pair, horizontal taps h[m] (kw) then vertical
// taps v[m] (kh), or a full kh x kw filter bases[m]; the M bases are shared by
// every input channel.
//
// Replaces the Pallas TPU kernel `lowrank_conv` (bodies `_lowrank_sep_kernel` and
// `_lowrank_full_kernel`) in convnet_approximater_tpu/ops/pallas/lowrank_kernels.py.
// That kernel keeps one image and its Z map in VMEM and so reads x once and writes
// Y once.  This first version is two launches over device memory instead:
//
//   1. basis_kernel  Z = the M basis convs of x, written as (B, Ho, Wo, M, C) scratch,
//                    channels fastest, so the rows of Z are the GEMM's rows
//   2. mix_kernel    Y = Z . A_mc + bias, a shared-memory tiled f32 GEMM on the CUDA
//                    cores, the bias in its epilogue
//
// What bounds it on the H100: operations.  The mix is 2 (B Ho Wo)(M C) N FLOP
// against (B H W C + B Ho Wo N) * 4 bytes of input and output, hundreds of FLOP per
// byte: AlexNet's convs 2-5 at b=64, 224^2 are 41 GFLOP (0.6 ms at the 67 TFLOP/s
// f32 peak outside the tensor cores) against about 40 MB (12 us at 3.35 TB/s).
// What the simple design costs: Z goes through device memory (95.6 MB written and
// read again for conv 2 at b=64), and the mix runs on the CUDA cores in f32, not on
// the tensor cores.  Computing Z tiles straight into shared memory in front of the
// mix, and the mix on wgmma, are the next steps.
//
// Pass order: the separable body runs the horizontal pass first, then the vertical
// one, as the TPU kernel does; each pass strides its own axis.  A thread computes
// one (b, ho, wo, c) for up to kMChunk bases at once, so it reads each tap of x once
// per chunk; a warp reads 32 neighbouring channels (coalesced).
//
// The C entry point launches on the caller's stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() of the first failing launch (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;
constexpr int kMChunk = 8;

struct ConvShape {
  int B, H, W, C, M, kh, kw, sh, sw, ph, pw, Ho, Wo;
};

// One thread per (b, ho, wo, c); `bases` is null for the separable body.
__global__ void __launch_bounds__(kThreads)
basis_kernel(const float* __restrict__ x, const float* __restrict__ v,
             const float* __restrict__ h, const float* __restrict__ bases,
             float* __restrict__ z, ConvShape s) {
  const int64_t n = (int64_t)s.B * s.Ho * s.Wo * s.C;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % s.C);
    int64_t r = idx / s.C;
    const int wo = (int)(r % s.Wo);
    r /= s.Wo;
    const int ho = (int)(r % s.Ho);
    const int64_t b = r / s.Ho;
    const int h0 = ho * s.sh - s.ph;
    const int w0 = wo * s.sw - s.pw;
    float* zp = z + ((b * s.Ho + ho) * s.Wo + wo) * (int64_t)s.M * s.C + c;
    for (int m0 = 0; m0 < s.M; m0 += kMChunk) {
      float acc[kMChunk];
#pragma unroll
      for (int q = 0; q < kMChunk; ++q) acc[q] = 0.f;
      for (int i = 0; i < s.kh; ++i) {
        const int hh = h0 + i;
        if (hh < 0 || hh >= s.H) continue;  // a zero row adds nothing in either body
        const float* row = x + (b * s.H + hh) * (int64_t)s.W * s.C + c;
        if (bases != nullptr) {
          for (int j = 0; j < s.kw; ++j) {
            const int ww = w0 + j;
            if (ww < 0 || ww >= s.W) continue;
            const float xv = row[(int64_t)ww * s.C];
#pragma unroll
            for (int q = 0; q < kMChunk; ++q)
              if (m0 + q < s.M) acc[q] += bases[((m0 + q) * s.kh + i) * s.kw + j] * xv;
          }
        } else {
          float t[kMChunk];
#pragma unroll
          for (int q = 0; q < kMChunk; ++q) t[q] = 0.f;
          for (int j = 0; j < s.kw; ++j) {
            const int ww = w0 + j;
            if (ww < 0 || ww >= s.W) continue;
            const float xv = row[(int64_t)ww * s.C];
#pragma unroll
            for (int q = 0; q < kMChunk; ++q)
              if (m0 + q < s.M) t[q] += h[(m0 + q) * s.kw + j] * xv;
          }
#pragma unroll
          for (int q = 0; q < kMChunk; ++q)
            if (m0 + q < s.M) acc[q] += v[(m0 + q) * s.kh + i] * t[q];
        }
      }
#pragma unroll
      for (int q = 0; q < kMChunk; ++q)
        if (m0 + q < s.M) zp[(int64_t)(m0 + q) * s.C] = acc[q];
    }
  }
}

// Y[p, n] = sum_k Z[p, k] A[k, n] + bias[n], Z (P, K) and Y (P, N) row-major.
// A 128 x 64 output tile per block of 256 threads, 8 x 4 results per thread (rows
// ty * 8 + i, columns tx * 4 + j), the reduction axis staged through shared memory
// 16 at a time; Z's tile is stored transposed so that a thread reads its 8 rows and
// 4 columns as float4s.
constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kPadM = kBM + 4;  // keeps float4 alignment, halves bank conflicts on the store

__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* __restrict__ z, const float* __restrict__ a,
           const float* __restrict__ bias, float* __restrict__ y, int64_t P, int K, int N) {
  __shared__ __align__(16) float As[kBK][kPadM];
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < K; kb += kBK) {
#pragma unroll
    for (int q = 0; q < (kBM * kBK) / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int row = e / kBK;
      const int col = e % kBK;
      const int64_t m = m0 + row;
      const int k = kb + col;
      As[col][row] = (m < P && k < K) ? z[m * K + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < (kBK * kBN) / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int row = e / kBN;
      const int col = e % kBN;
      const int k = kb + row;
      const int nn = n0 + col;
      Bs[row][col] = (k < K && nn < N) ? a[(int64_t)k * N + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float br[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t m = m0 + ty * 8 + i;
    if (m >= P) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (nn < N) y[m * N + nn] = acc[i][j] + bias[nn];
    }
  }
}

int grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// x (B, H, W, C); v (M, kh) and h (M, kw), or bases (M, kh, kw) with v = h = null;
// a (M * C, N) with rows m * C + c; bias (N,); z (B, Ho, Wo, M, C) scratch;
// y (B, Ho, Wo, N).
extern "C" int lowrank_conv_f32(const float* x, const float* v, const float* h,
                                const float* bases, const float* a, const float* bias,
                                float* z, float* y, int B, int H, int W, int C, int M, int N,
                                int kh, int kw, int sh, int sw, int ph, int pw,
                                void* stream_handle) {
  ConvShape s;
  s.B = B; s.H = H; s.W = W; s.C = C; s.M = M;
  s.kh = kh; s.kw = kw; s.sh = sh; s.sw = sw; s.ph = ph; s.pw = pw;
  s.Ho = (H + 2 * ph - kh) / sh + 1;
  s.Wo = (W + 2 * pw - kw) / sw + 1;
  if (s.Ho < 1 || s.Wo < 1 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (bases == nullptr && (v == nullptr || h == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int64_t n = (int64_t)B * s.Ho * s.Wo * C;
  cudaError_t err;

  basis_kernel<<<grid_for(n), kThreads, 0, stream>>>(x, v, h, bases, z, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t P = (int64_t)B * s.Ho * s.Wo;
  const dim3 mix_grid((unsigned)((P + kBM - 1) / kBM), (unsigned)((N + kBN - 1) / kBN));
  mix_kernel<<<mix_grid, kThreads, 0, stream>>>(z, a, bias, y, P, M * C, N);
  return (int)cudaGetLastError();
}
