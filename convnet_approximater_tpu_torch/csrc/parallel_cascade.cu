// The strip-conv bank alone for Hopper (sm_90a), float32, NHWC:
//
//   out = sum_br [vconv_k(hconv_k(x) + b1) + b2]  (+ x when `identity`)
//
// Replaces the Pallas TPU kernel `parallel_cascade` / `_parallel_cascade_kernel` in
// convnet_approximater_tpu/ops/pallas/msca_kernels.py.  That kernel holds a whole
// (H, W, C) image in VMEM and runs both passes of every branch on it; a Hopper block has
// at most 227 KB of shared memory, less than one 56x56x96 f32 image, so this first
// version is the two launches of strip_bank.cuh over device memory:
//
//   1. hpass_kernel  t[br] = hconv_k(x) + b1[br]                 (every branch)
//   2. vpass_kernel  out   = [x] + sum_br (vconv_k(t[br]) + b2[br])
//
// The border semantics are those of the module path: b1 is added after the horizontal
// pass and before the zero-padded vertical pass, so rows outside the map hold 0, not b1.
//
// What bounds it on the H100: bytes.  A branch of k taps is 4k + 2 FLOP per element
// against a 4-byte read of x and a 4-byte write of out: 3.75 FLOP/byte at ConvNeXt's
// k = 7, rank 1, far below the ~20 FLOP/byte at which the f32 CUDA cores become the
// limit.  The (nb, B, H, W, C) scratch t costs 2 nb extra passes over the map on top of
// the 2 the function needs; keeping t on chip (row tiles with a k/2-row halo, the
// horizontal pass into shared memory, the vertical pass from it) is the next step.
//
// The C entry point launches on the caller's stream, does not synchronise, allocates
// nothing and returns cudaGetLastError() of the first failing launch (0 on success).

#include "strip_bank.cuh"

extern "C" int parallel_cascade_f32(const float* x, const float* w1, const float* b1,
                                    const float* w2, const float* b2, float* t, float* out,
                                    int B, int H, int W, int C, int nb, int k_max,
                                    const int* ks, int identity, void* stream_handle) {
  BankShape bank;
  if (!make_bank(nb, k_max, ks, &bank)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const int64_t n = (int64_t)B * H * W * C;
  cudaError_t err;

  hpass_kernel<<<grid_for(nb * n), kThreads, 0, stream>>>(x, w1, b1, t, B, H, W, C, bank);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  vpass_kernel<<<grid_for(n), kThreads, 0, stream>>>(x, t, w2, b2, nullptr, out, B, H, W, C,
                                                     bank, identity, 0);
  return (int)cudaGetLastError();
}
