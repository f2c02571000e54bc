// Pieces shared by the kernels that march down a band of rows of an NHWC map of float32 or
// bfloat16 (parallel_cascade.cu, msca_fused.cu): the block's tile of the map, cp.async, and
// the element loads and stores that convert to and from the float32 the kernels compute in.
//
// A block owns 32 channels (one per lane, so every warp access is 128 contiguous bytes), a
// tile of tw columns and a band of rows of one image.  Divisions happen once per block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;  // channels per block, one per lane

// What a block owns: image b, rows [h0, h1), columns from w0, channel c = c0 + lane.
struct Tile {
  int64_t image;  // b * H
  int h0, h1, w0, c;
  bool c_ok;
};

__device__ __forceinline__ Tile tile_of(int H, int C, int tw, int rows, int bands, int ntiles,
                                        int nchunks) {
  int blk = blockIdx.x;  // band fastest, then column tile, channel chunk, image
  const int band = blk % bands;
  blk /= bands;
  const int tile = blk % ntiles;
  blk /= ntiles;
  const int chunk = blk % nchunks;
  Tile t;
  t.image = (int64_t)(blk / nchunks) * H;
  t.h0 = band * rows;
  t.h1 = min(H, t.h0 + rows);
  t.w0 = tile * tw;
  t.c = chunk * kLanes + (threadIdx.x & 31);
  t.c_ok = t.c < C;
  return t;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// dst and src 16-byte aligned
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// An element of x as float32 (exact), and a float32 result stored as the map's type (bfloat16
// rounded to nearest even, once).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace
