// Fused MSCA block for Hopper (sm_90a), float32, NHWC:
//
//   out = x * (Wm . fix(bank(dw_k0(x) + b0)) + bm)
//   bank(a) = sum_br [vconv_k(hconv_k(a) + b1) + b2]  (+ a when `identity`)
//   fix     = FixPaddingBias: res[0] on the top min(H, p) rows, res[1] aligned
//             to the last row on the bottom min(H, p) rows; both where they overlap.
//
// Replaces the Pallas TPU kernel `msca_fused` / `_msca_fused_kernel` in
// convnet_approximater_tpu/ops/pallas/msca_kernels.py.  That kernel holds a whole
// (H, W, C) image in VMEM; a Hopper block has at most 227 KB of shared memory, less
// than one 56x56x32 f32 image with its halos, so this version is four launches over
// device memory instead of one pass over a resident image:
//
//   1. conv0_kernel  a0   = dw_k0(x) + b0
//   2. hpass_kernel  t[b] = hconv_k(a0) + b1[b]                  (every branch)
//   3. vpass_kernel  attn = [a0] + sum_b (vconv_k(t[b]) + b2[b]) + fix
//   4. mix_kernel    out  = x * (attn . Wm + bm)                 (tiled C x C product)
//
// Launches 2 and 3 are the strip bank of strip_bank.cuh, which only this file includes
// (its notes give the thread layout and the border semantics); conv0 is laid out the
// same way, one thread per output element with channels fastest.
//
// What bounds it on the H100: bytes.  The depthwise work is 2 * (k0^2 + 2 sum k)
// FLOP per element against 4-byte reads and writes, far below the ~20 FLOP/byte at
// which f32 CUDA cores, let alone the 295 FLOP/byte of the tensor cores, become the
// limit.  The scratch buffers a0, t and attn cost (4 + 2 nb) extra tensor passes;
// keeping them on chip (row tiles with halos of k0/2 and k_max/2) and moving the
// channel mix to wgmma are the next steps.
//
// The C entry point launches on the caller's stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() of the first failing launch (0 on success).

#include "strip_bank.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
conv0_kernel(const float* __restrict__ x, const float* __restrict__ w0,
             const float* __restrict__ b0, float* __restrict__ a0,
             int B, int H, int W, int C, int k0) {
  const int64_t n = (int64_t)B * H * W * C;
  const int p0 = k0 / 2;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    int64_t r = idx / C;
    const int w = (int)(r % W);
    r /= W;
    const int h = (int)(r % H);
    const int64_t b = r / H;
    float acc = b0[c];
    for (int i = 0; i < k0; ++i) {
      const int hh = h + i - p0;
      if (hh < 0 || hh >= H) continue;
      const float* row = x + (b * H + hh) * (int64_t)W * C + c;
      const float* wrow = w0 + (int64_t)i * k0 * C + c;
      for (int j = 0; j < k0; ++j) {
        const int ww = w + j - p0;
        if (ww < 0 || ww >= W) continue;
        acc += wrow[(int64_t)j * C] * row[(int64_t)ww * C];
      }
    }
    a0[idx] = acc;
  }
}

// out[m, n] = x[m, n] * (sum_k attn[m, k] wm[k, n] + bm[n]) over M = B*H*W pixels.
// A 64 x 64 output tile per block of 256 threads, 4 x 4 results per thread, the
// C (reduction) axis staged through shared memory 16 at a time.
constexpr int kTM = 64;
constexpr int kTN = 64;
constexpr int kTK = 16;

__global__ void __launch_bounds__(kThreads)
mix_kernel(const float* __restrict__ attn, const float* __restrict__ wm,
           const float* __restrict__ bm, const float* __restrict__ x,
           float* __restrict__ out, int64_t M, int C) {
  __shared__ float As[kTK][kTM + 1];
  __shared__ float Bs[kTK][kTN];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t m0 = (int64_t)blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < C; kb += kTK) {
#pragma unroll
    for (int q = 0; q < (kTM * kTK) / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int row = e / kTK;
      const int col = e % kTK;
      const int64_t m = m0 + row;
      const int k = kb + col;
      As[col][row] = (m < M && k < C) ? attn[m * C + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < (kTK * kTN) / kThreads; ++q) {
      const int e = tid + q * kThreads;
      const int row = e / kTN;
      const int col = e % kTN;
      const int k = kb + row;
      const int nn = n0 + col;
      Bs[row][col] = (k < C && nn < C) ? wm[(int64_t)k * C + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx + 16 * j;
      if (nn >= C) continue;
      const int64_t o = m * C + nn;
      out[o] = x[o] * (acc[i][j] + bm[nn]);
    }
  }
}

}  // namespace

extern "C" int msca_fused_f32(const float* x, const float* w0, const float* b0,
                              const float* w1, const float* b1, const float* w2,
                              const float* b2, const float* wm, const float* bm,
                              const float* res, float* a0, float* t, float* attn,
                              float* out, int B, int H, int W, int C, int k0, int nb,
                              int k_max, const int* ks, int identity, int fix_p,
                              void* stream_handle) {
  BankShape bank;
  if (!make_bank(nb, k_max, ks, &bank)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int64_t n = (int64_t)B * H * W * C;
  cudaError_t err;

  conv0_kernel<<<grid_for(n), kThreads, 0, stream>>>(x, w0, b0, a0, B, H, W, C, k0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  hpass_kernel<<<grid_for(nb * n), kThreads, 0, stream>>>(a0, w1, b1, t, B, H, W, C, bank);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  vpass_kernel<<<grid_for(n), kThreads, 0, stream>>>(a0, t, w2, b2, res, attn, B, H, W, C,
                                                     bank, identity, fix_p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t M = (int64_t)B * H * W;
  const dim3 mix_grid((unsigned)((M + kTM - 1) / kTM), (unsigned)((C + kTN - 1) / kTN));
  mix_kernel<<<mix_grid, kThreads, 0, stream>>>(attn, wm, bm, x, out, M, C);
  return (int)cudaGetLastError();
}
