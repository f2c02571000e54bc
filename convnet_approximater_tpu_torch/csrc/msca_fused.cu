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
// Each depthwise launch is one thread per output element with channels fastest, so
// a warp reads 32 neighbouring channels of one pixel (coalesced); the halo taps are
// re-read through L1/L2.  Zero padding is a bounds test per tap, which also gives the
// border semantics MscaRep's algebra relies on: b1 is added after the horizontal pass
// and before the zero-padded vertical pass, so rows outside the map hold 0, not b1.
// Each branch loops over its own k taps only; shorter branches are zero-embedded at
// the centre of k_max in the packed (nb, k_max, C) tap arrays.
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

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxBranches = 8;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 1 << 20;

struct BankShape {
  int nb;
  int k_max;
  int ks[kMaxBranches];
};

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

__global__ void __launch_bounds__(kThreads)
hpass_kernel(const float* __restrict__ a0, const float* __restrict__ w1,
             const float* __restrict__ b1, float* __restrict__ t,
             int B, int H, int W, int C, BankShape bank) {
  const int64_t n = (int64_t)B * H * W * C;
  const int ph = bank.k_max / 2;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < bank.nb * n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int br = (int)(idx / n);
    const int64_t e = idx - br * n;
    const int c = (int)(e % C);
    const int w = (int)((e / C) % W);
    const int k = bank.ks[br];
    const int off = (bank.k_max - k) / 2;
    const float* row = a0 + (e - (int64_t)w * C);  // (b, h, 0, c)
    const float* taps = w1 + (int64_t)br * bank.k_max * C + c;
    float acc = b1[br * C + c];
    for (int j = off; j < off + k; ++j) {
      const int ww = w + j - ph;
      if (ww < 0 || ww >= W) continue;
      acc += taps[(int64_t)j * C] * row[(int64_t)ww * C];
    }
    t[idx] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
vpass_kernel(const float* __restrict__ a0, const float* __restrict__ t,
             const float* __restrict__ w2, const float* __restrict__ b2,
             const float* __restrict__ res, float* __restrict__ attn,
             int B, int H, int W, int C, BankShape bank, int identity, int fix_p) {
  const int64_t n = (int64_t)B * H * W * C;
  const int pv = bank.k_max / 2;
  const int p2 = fix_p < H ? fix_p : H;
  const int64_t row_stride = (int64_t)W * C;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    const int h = (int)((idx / row_stride) % H);
    float acc = identity ? a0[idx] : 0.f;
    for (int br = 0; br < bank.nb; ++br) {
      const int k = bank.ks[br];
      const int off = (bank.k_max - k) / 2;
      const float* col = t + br * n + (idx - h * row_stride);  // (br, b, 0, w, c)
      const float* taps = w2 + (int64_t)br * bank.k_max * C + c;
      float s = b2[br * C + c];
      for (int i = off; i < off + k; ++i) {
        const int hh = h + i - pv;
        if (hh < 0 || hh >= H) continue;
        s += taps[(int64_t)i * C] * col[hh * row_stride];
      }
      acc += s;
    }
    if (fix_p > 0) {
      // res is (2, fix_p, C): top strip from row 0 down, bottom strip ending at row H-1
      if (h < p2) acc += res[(int64_t)h * C + c];
      if (h >= H - p2) acc += res[(int64_t)(2 * fix_p - H + h) * C + c];
    }
    attn[idx] = acc;
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

int grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" int msca_fused_f32(const float* x, const float* w0, const float* b0,
                              const float* w1, const float* b1, const float* w2,
                              const float* b2, const float* wm, const float* bm,
                              const float* res, float* a0, float* t, float* attn,
                              float* out, int B, int H, int W, int C, int k0, int nb,
                              int k_max, const int* ks, int identity, int fix_p,
                              void* stream_handle) {
  if (nb < 1 || nb > kMaxBranches) return (int)cudaErrorInvalidValue;
  BankShape bank;
  bank.nb = nb;
  bank.k_max = k_max;
  for (int i = 0; i < kMaxBranches; ++i) bank.ks[i] = i < nb ? ks[i] : 0;
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
