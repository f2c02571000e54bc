// The strip-conv bank on NHWC float32, the two middle launches of msca_fused.cu (its only
// includer; parallel_cascade.cu runs its bank in one launch of its own):
//
//   bank(a) = sum_br [vconv_k(hconv_k(a) + b1) + b2]  (+ a when `identity`)
//
// as two launches over a (nb, B, H, W, C) scratch t:
//
//   hpass_kernel  t[br] = hconv_k(a) + b1[br]                      (every branch)
//   vpass_kernel  out   = [a] + sum_br (vconv_k(t[br]) + b2[br]) + fix
//
// Each launch is one thread per output element with channels fastest, so a warp reads
// 32 neighbouring channels of one pixel (coalesced); the halo taps are re-read through
// L1/L2.  Zero padding is a bounds test per tap, which also gives the border semantics
// MscaRep's algebra relies on: b1 is added after the horizontal pass and before the
// zero-padded vertical pass, so rows outside the map hold 0, not b1.  Each branch loops
// over its own k taps only; shorter branches are zero-embedded at the centre of k_max in
// the packed (nb, k_max, C) tap arrays.  `fix` is FixPaddingBias: res (2, fix_p, C),
// res[0] on the top min(H, fix_p) rows, res[1] aligned to the last row on the bottom
// min(H, fix_p) rows, both where they overlap; fix_p = 0 adds nothing and res may be null.
//
// Each sum starts at its bias and adds the taps in order, every product and every sum
// rounded on its own (__fmul_rn / __fadd_rn: no contraction into an FMA), so the bank
// gives the bits of a plain version that adds the same terms in the same order
// (ops/parallel_cascade.py::parallel_cascade_ref).  The passes are bound by bytes, so
// the extra instructions cost no time.

#pragma once

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

// BankShape from the caller's arrays; false when nb is out of range.
inline bool make_bank(int nb, int k_max, const int* ks, BankShape* bank) {
  if (nb < 1 || nb > kMaxBranches) return false;
  bank->nb = nb;
  bank->k_max = k_max;
  for (int i = 0; i < kMaxBranches; ++i) bank->ks[i] = i < nb ? ks[i] : 0;
  return true;
}

inline int grid_for(int64_t work) {
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
hpass_kernel(const float* __restrict__ a, const float* __restrict__ w1,
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
    const float* row = a + (e - (int64_t)w * C);  // (b, h, 0, c)
    const float* taps = w1 + (int64_t)br * bank.k_max * C + c;
    float acc = b1[br * C + c];
    for (int j = off; j < off + k; ++j) {
      const int ww = w + j - ph;
      if (ww < 0 || ww >= W) continue;
      acc = __fadd_rn(acc, __fmul_rn(taps[(int64_t)j * C], row[(int64_t)ww * C]));
    }
    t[idx] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
vpass_kernel(const float* __restrict__ a, const float* __restrict__ t,
             const float* __restrict__ w2, const float* __restrict__ b2,
             const float* __restrict__ res, float* __restrict__ out,
             int B, int H, int W, int C, BankShape bank, int identity, int fix_p) {
  const int64_t n = (int64_t)B * H * W * C;
  const int pv = bank.k_max / 2;
  const int p2 = fix_p < H ? fix_p : H;
  const int64_t row_stride = (int64_t)W * C;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(idx % C);
    const int h = (int)((idx / row_stride) % H);
    float acc = identity ? a[idx] : 0.f;
    for (int br = 0; br < bank.nb; ++br) {
      const int k = bank.ks[br];
      const int off = (bank.k_max - k) / 2;
      const float* col = t + br * n + (idx - h * row_stride);  // (br, b, 0, w, c)
      const float* taps = w2 + (int64_t)br * bank.k_max * C + c;
      float s = b2[br * C + c];
      for (int i = off; i < off + k; ++i) {
        const int hh = h + i - pv;
        if (hh < 0 || hh >= H) continue;
        s = __fadd_rn(s, __fmul_rn(taps[(int64_t)i * C], col[hh * row_stride]));
      }
      acc += s;
    }
    if (fix_p > 0) {
      // res is (2, fix_p, C): top strip from row 0 down, bottom strip ending at row H-1
      if (h < p2) acc += res[(int64_t)h * C + c];
      if (h >= H - p2) acc += res[(int64_t)(2 * fix_p - H + h) * C + c];
    }
    out[idx] = acc;
  }
}

}  // namespace
