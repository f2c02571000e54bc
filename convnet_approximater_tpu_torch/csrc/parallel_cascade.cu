// The strip-conv bank alone for Hopper (sm_90a), NHWC, x and out float32 or bfloat16:
//
//   out = sum_br [vconv_k(hconv_k(x) + b1) + b2]  (+ x when `identity`)
//
// Replaces the Pallas TPU kernel `parallel_cascade` / `_parallel_cascade_kernel` in
// convnet_approximater_tpu/ops/pallas/msca_kernels.py.  That kernel holds a whole (H, W, C)
// image in VMEM and runs both passes of every branch on it; a Hopper block has at most
// 227 KB of shared memory, less than one 56x56x96 f32 image, so this kernel marches down a
// column strip instead.
//
// What bounds it on the H100: bytes.  A branch of k taps is 4k + 2 FLOP per element against
// a 4-byte read of x and a 4-byte write of out: 3.75 FLOP/byte at ConvNeXt's k = 7, rank 1,
// far below the ~20 FLOP/byte at which the f32 CUDA cores become the limit.  So the design
// moves each byte of the function once and keeps the horizontal result on chip:
//
//   - One launch, no scratch in device memory.  A block owns 32 channels (one per lane, so
//     every warp access is 128 contiguous bytes) x a tile of tw columns x a band of rows of
//     one image, and walks down the band.  Each input row is staged once in shared memory
//     with its k_max/2-column side halo, and every branch's horizontal pass reads it there.
//     Only the band's k_max/2-row top and bottom halo and the tile's side halo are read
//     twice (through L2).
//   - Loads in flight: input rows go into a ring of kStages row buffers by cp.async, the
//     next rows in flight while the current one is computed; kStages * (tw + k_max - 1) *
//     128 B of shared memory (13 KB at k = 7, tw = 28; 13 KB at k = 21, tw = 14).
//   - Two kernels keep the horizontal result on chip.  `uniform_kernel` takes the banks whose
//     branches all have k = k_max (every bank the configs build: k = 5, 7 or 21, one or two
//     branches) with K, the branch count and the columns per thread G as template
//     parameters: the taps sit in registers, each thread reads its G + K - 1 staged inputs
//     once per row for all branches, and the vertical pass is K running sums per column and
//     branch in registers (the row loop is unrolled by K, so each sum has a fixed register),
//     one block barrier per row.  `ring_kernel` takes any other bank (branches of different
//     k, up to kMaxBranches): the horizontal results go into a ring of k_max rows per branch
//     in shared memory, nb * k_max * tw * 128 B (64.5 KB for MSCA's 7/11/21 bank at tw = 8),
//     and each output row gathers its taps from there; the ceiling nb * k_max <=
//     kMaxBankRows keeps that ring, the staged rows and the taps inside 227 KB.
//   - 32-bit index arithmetic, per row; divisions only per block.
//   - Tensor cores do not apply: a depthwise conv has no reduction over channels, so there
//     is no matrix product to hand them.
//
// The bits are those of the plain version (ops/parallel_cascade.py::parallel_cascade_ref):
// each horizontal sum starts at b1 and adds its taps left to right, each vertical sum starts
// at b2 and adds its taps top to bottom (the running sums receive the rows in that order),
// the branches add to x (identity) or to 0 in order, every product and every sum rounded on
// its own (__fmul_rn / __fadd_rn: no FMA).  Columns outside the map are staged as zeros (the
// plain version's zero padding, w * 0 added), and rows of the horizontal result outside the
// map are 0, not b1, as MscaRep's border algebra requires.  In `ring_kernel` each branch
// loops over its own k taps only; shorter branches are zero-embedded at the centre of k_max
// in the packed (nb, k_max, C) tap arrays.
//
// bfloat16 (parallel_cascade_bf16): the kernels are templated on the element type T of x and
// out.  Staging converts each bf16 input to float32 (exact) as it lands in the float32 row
// buffers, with a plain load instead of cp.async (a lane's channel is 2 bytes, below cp.async's
// 4), so everything after it is the float32 kernel; the identity term is converted the same
// way, and the output is rounded to bf16 once at the store (__float2bfloat16_rn, to nearest
// even), which is the plain version's `.to(torch.bfloat16)` of its float32 result: the bits
// still agree.  The taps and biases stay float32 (the wrapper packs them so).
//
// The C entry point launches on the caller's stream, does not synchronise, allocates nothing
// and returns cudaGetLastError() after the launch (0 on success), or cudaErrorInvalidValue
// for a bank it does not take.

#include "row_march.cuh"

namespace {

constexpr int kMaxBranches = 8;
constexpr int kMaxBankRows = 128;    // nb * k_max; MAX_BANK_ROWS in ops/parallel_cascade.py
constexpr int kStages = 3;           // staged input rows
constexpr int kMaxWarps = 8;         // columns per tile <= kMaxWarps * G
constexpr int kTargetBlocks = 512;   // split the rows into bands up to this many blocks

struct Bank {
  int nb;
  int k_max;
  int ks[kMaxBranches];
};

// Stage input row r, columns w0 - P .. w0 - P + xw - 1 (zeros outside the map), into the
// float32 buffer `dst` ([xw][32]); a row outside the map stages nothing.  One cp.async group
// (empty for bf16, whose inputs are converted by plain loads).
template <typename T>
__device__ __forceinline__ void stage_row(float* dst, const T* __restrict__ x, const Tile& t,
                                          int r, int H, int W, int C, int P, int xw) {
  if (r >= 0 && r < H) {
    const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const T* src = x + (t.image + r) * W * C + t.c;
    for (int col = threadIdx.x >> 5; col < xw; col += nwarps) {
      const int ww = t.w0 - P + col;
      if (t.c_ok && ww >= 0 && ww < W) {
        if constexpr (sizeof(T) == 4)
          cp_async4(dst + col * kLanes + lane, src + ww * C);
        else
          dst[col * kLanes + lane] = to_f32(src[ww * C]);
      } else {
        dst[col * kLanes + lane] = 0.f;
      }
    }
  }
  cp_async_commit();
}

// Banks whose nb = NB branches all have k = K; each thread computes G neighbouring columns
// of its channel.
template <int K, int NB, int G, typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
uniform_kernel(const T* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, T* __restrict__ out,
               int H, int W, int C, int identity,
               int tw, int rows, int bands, int ntiles, int nchunks) {
  constexpr int P = K / 2, XN = G + K - 1;
  extern __shared__ float xs[];  // [kStages][xw][32]
  const int lane = threadIdx.x & 31, col0 = (threadIdx.x >> 5) * G;
  const int xw = (blockDim.x >> 5) * G + K - 1;
  const Tile t = tile_of(H, C, tw, rows, bands, ntiles, nchunks);

  float wh[NB][K], wv[NB][K], bh[NB], bv[NB];
#pragma unroll
  for (int br = 0; br < NB; ++br) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      wh[br][j] = t.c_ok ? w1[(br * K + j) * C + t.c] : 0.f;
      wv[br][j] = t.c_ok ? w2[(br * K + j) * C + t.c] : 0.f;
    }
    bh[br] = t.c_ok ? b1[br * C + t.c] : 0.f;
    bv[br] = t.c_ok ? b2[br * C + t.c] : 0.f;
  }
  // acc[br][(o - r0) mod K][q]: the vertical sum of output row o, column col0 + q
  float acc[NB][K][G];
#pragma unroll
  for (int br = 0; br < NB; ++br)
#pragma unroll
    for (int s = 0; s < K; ++s)
#pragma unroll
      for (int q = 0; q < G; ++q) acc[br][s][q] = 0.f;

  const int r0 = t.h0 - P, r1 = t.h1 + P;  // rows of the horizontal result the band needs
  for (int s = 0; s < kStages - 1; ++s) stage_row(xs + s * xw * kLanes, x, t, r0 + s, H, W, C, P, xw);
  int stage = 0;  // buffer of row r
  for (int base = r0; base < r1; base += K) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      const int r = base + u;
      if (r >= r1) break;
      cp_async_wait<kStages - 2>();  // row r has landed
      __syncthreads();               // ...for every thread; row r - 1's buffer is free
      const int prev = stage == 0 ? kStages - 1 : stage - 1;
      if (r + kStages - 1 < r1)
        stage_row(xs + prev * xw * kLanes, x, t, r + kStages - 1, H, W, C, P, xw);
      else
        cp_async_commit();  // one group per row keeps the wait above exact
      float xv[XN];
      const float* xp = xs + (stage * xw + col0) * kLanes + lane;
#pragma unroll
      for (int i = 0; i < XN; ++i) xv[i] = xp[i * kLanes];
      stage = stage + 1 == kStages ? 0 : stage + 1;

      const bool inside = r >= 0 && r < H;
#pragma unroll
      for (int br = 0; br < NB; ++br) {
#pragma unroll
        for (int q = 0; q < G; ++q) {
          float h = bh[br];
#pragma unroll
          for (int j = 0; j < K; ++j) h = __fadd_rn(h, __fmul_rn(wh[br][j], xv[q + j]));
          if (!inside) h = 0.f;
          // row r is tap i of output row r + P - i, whose sum sits in slot (u + P - i) mod K
#pragma unroll
          for (int i = 0; i < K; ++i) {
            float& a = acc[br][(u + P - i + K) % K][q];
            a = __fadd_rn(i == 0 ? bv[br] : a, __fmul_rn(wv[br][i], h));
          }
        }
      }

      const int o = r - P;  // its sum took its last tap with row r
      if (o < t.h0) continue;
      const T* xo = x + (t.image + o) * W * C + t.c;
      T* dst = out + (t.image + o) * W * C + t.c;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int col = col0 + q, ww = t.w0 + col;
        if (!t.c_ok || col >= tw || ww >= W) continue;
        float y = identity ? to_f32(xo[ww * C]) : 0.f;
#pragma unroll
        for (int br = 0; br < NB; ++br) y = __fadd_rn(y, acc[br][(u - P + K) % K][q]);
        store(dst + ww * C, y);
      }
    }
  }
}

// Any bank: branches of their own k <= k_max, the horizontal results in a shared-memory ring
// of k_max rows per branch.  One column per thread.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
ring_kernel(const T* __restrict__ x, const float* __restrict__ w1,
            const float* __restrict__ b1, const float* __restrict__ w2,
            const float* __restrict__ b2, T* __restrict__ out,
            int H, int W, int C, Bank bank, int identity,
            int tw, int rows, int bands, int ntiles, int nchunks) {
  extern __shared__ float smem[];
  const int K = bank.k_max, P = K / 2, nb = bank.nb;
  const int lane = threadIdx.x & 31, col = threadIdx.x >> 5, twp = blockDim.x >> 5;
  const int xw = twp + K - 1;
  const Tile t = tile_of(H, C, tw, rows, bands, ntiles, nchunks);

  float* w1s = smem;                        // [nb][K][32]
  float* w2s = w1s + nb * K * kLanes;       // [nb][K][32]
  float* b1s = w2s + nb * K * kLanes;       // [nb][32]
  float* b2s = b1s + nb * kLanes;           // [nb][32]
  float* xs = b2s + nb * kLanes;            // [kStages][xw][32]
  float* hr = xs + kStages * xw * kLanes;   // [nb][K][twp][32], ring slot = row mod K
  const int c0 = t.c - lane;
  for (int i = threadIdx.x; i < nb * K * kLanes; i += blockDim.x) {
    const int cc = c0 + (i & 31), src = (i >> 5) * C + cc;  // (br * K + j) * C + cc
    w1s[i] = cc < C ? w1[src] : 0.f;
    w2s[i] = cc < C ? w2[src] : 0.f;
  }
  for (int i = threadIdx.x; i < nb * kLanes; i += blockDim.x) {
    const int cc = c0 + (i & 31), src = (i >> 5) * C + cc;
    b1s[i] = cc < C ? b1[src] : 0.f;
    b2s[i] = cc < C ? b2[src] : 0.f;
  }

  const int r0 = t.h0 - P, r1 = t.h1 + P;
  for (int s = 0; s < kStages; ++s) stage_row(xs + s * xw * kLanes, x, t, r0 + s, H, W, C, P, xw);
  for (int r = r0, stage = 0; r < r1; ++r, stage = stage + 1 == kStages ? 0 : stage + 1) {
    cp_async_wait<kStages - 1>();  // row r has landed
    __syncthreads();               // ...for every thread; the ring slot is free again

    // horizontal pass of row r, every branch, into ring slot r mod K
    const bool inside = r >= 0 && r < H;
    const int slot = (r % K + K) % K;
    const float* xp = xs + (stage * xw + col) * kLanes + lane;
    for (int br = 0; br < nb; ++br) {
      const int k = bank.ks[br], off = (K - k) / 2;
      float h = 0.f;
      if (inside) {
        const float* wt = w1s + br * K * kLanes + lane;
        h = b1s[br * kLanes + lane];
        for (int j = off; j < off + k; ++j)
          h = __fadd_rn(h, __fmul_rn(wt[j * kLanes], xp[j * kLanes]));
      }
      hr[((br * K + slot) * twp + col) * kLanes + lane] = h;
    }
    __syncthreads();  // row r's ring slot is written; its staging buffer is free
    if (r + kStages < r1)
      stage_row(xs + stage * xw * kLanes, x, t, r + kStages, H, W, C, P, xw);
    else
      cp_async_commit();  // one group per row keeps the wait above exact

    // vertical pass: output row o = r - P once the ring holds rows o - P .. o + P
    const int o = r - P, ww = t.w0 + col;
    if (o < t.h0 || !t.c_ok || col >= tw || ww >= W) continue;
    float y = identity ? to_f32(x[(t.image + o) * W * C + ww * C + t.c]) : 0.f;
    for (int br = 0; br < nb; ++br) {
      const int k = bank.ks[br], off = (K - k) / 2;
      const float* wt = w2s + br * K * kLanes + lane;
      const float* hb = hr + (br * K * twp + col) * kLanes + lane;
      float s = b2s[br * kLanes + lane];
      int sl = ((o - P + off) % K + K) % K;
      for (int i = off; i < off + k; ++i) {
        s = __fadd_rn(s, __fmul_rn(wt[i * kLanes], hb[sl * twp * kLanes]));
        sl = sl + 1 == K ? 0 : sl + 1;
      }
      y = __fadd_rn(y, s);
    }
    store(out + (t.image + o) * W * C + ww * C + t.c, y);
  }
}

struct Grid {
  int tw, warps, ntiles, nchunks, rows, bands;
  int64_t blocks;
};

// Tiles of at most kMaxWarps * g columns, split evenly over W; then the rows split into bands
// while the grid is short of blocks and a band stays at least max(8, 2P) rows, so that the
// recomputed halo stays a minor share.
inline Grid grid_for(int B, int H, int W, int C, int K, int g) {
  Grid d;
  d.ntiles = cdiv(W, kMaxWarps * g);
  d.tw = cdiv(W, d.ntiles);
  d.warps = cdiv(d.tw, g);
  d.nchunks = cdiv(C, kLanes);
  const int64_t base = (int64_t)B * d.nchunks * d.ntiles;
  const int min_rows = K - 1 > 8 ? K - 1 : 8;
  int bands = 1;
  while (base * bands < kTargetBlocks && cdiv(H, bands + 1) >= min_rows) ++bands;
  d.rows = cdiv(H, bands);
  d.bands = cdiv(H, d.rows);
  d.blocks = base * d.bands;
  return d;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, const Grid& d, size_t smem, cudaStream_t stream,
                   Args... args) {
  if (d.blocks > INT32_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)d.blocks, d.warps * 32, smem, stream>>>(
      args..., d.tw, d.rows, d.bands, d.ntiles, d.nchunks);
  return cudaGetLastError();
}

template <int K, int NB, int G, typename T>
cudaError_t launch_uniform(const T* x, const float* w1, const float* b1, const float* w2,
                           const float* b2, T* out, int B, int H, int W, int C,
                           int identity, cudaStream_t stream) {
  const Grid d = grid_for(B, H, W, C, K, G);
  const size_t smem = sizeof(float) * kLanes * kStages * (d.warps * G + K - 1);
  return launch(uniform_kernel<K, NB, G, T>, d, smem, stream, x, w1, b1, w2, b2, out, H, W, C,
                identity);
}

template <typename T>
int run(const T* x, const float* w1, const float* b1, const float* w2, const float* b2, T* out,
        int B, int H, int W, int C, int nb, int k_max, const int* ks, int identity,
        void* stream_handle) {
  if (nb < 1 || nb > kMaxBranches || k_max < 1 || k_max % 2 == 0 || nb * k_max > kMaxBankRows ||
      B < 1 || H < 1 || W < 1 || C < 1 || (int64_t)W * C > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  Bank bank{};
  bank.nb = nb;
  bank.k_max = k_max;
  bool uniform = true;
  for (int i = 0; i < nb; ++i) {
    if (ks[i] < 1 || ks[i] > k_max || (k_max - ks[i]) % 2) return (int)cudaErrorInvalidValue;
    bank.ks[i] = ks[i];
    uniform = uniform && ks[i] == k_max;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  if (uniform) {  // the configs' banks
    if (k_max == 7 && nb == 1)
      return (int)launch_uniform<7, 1, 4>(x, w1, b1, w2, b2, out, B, H, W, C, identity, stream);
    if (k_max == 7 && nb == 2)
      return (int)launch_uniform<7, 2, 4>(x, w1, b1, w2, b2, out, B, H, W, C, identity, stream);
    if (k_max == 5 && nb == 1)
      return (int)launch_uniform<5, 1, 4>(x, w1, b1, w2, b2, out, B, H, W, C, identity, stream);
    if (k_max == 21 && nb == 1)
      return (int)launch_uniform<21, 1, 2>(x, w1, b1, w2, b2, out, B, H, W, C, identity, stream);
  }
  const Grid d = grid_for(B, H, W, C, k_max, 1);
  // taps and biases, staged rows, ring: at most 214 KB at nb * k_max = kMaxBankRows
  const size_t smem = sizeof(float) * kLanes *
                      ((size_t)2 * nb * k_max + 2 * nb + (size_t)kStages * (d.warps + k_max - 1) +
                       (size_t)nb * k_max * d.warps);
  return (int)launch(ring_kernel<T>, d, smem, stream, x, w1, b1, w2, b2, out, H, W, C, bank,
                     identity);
}

}  // namespace

extern "C" int parallel_cascade_f32(const float* x, const float* w1, const float* b1,
                                    const float* w2, const float* b2, float* out,
                                    int B, int H, int W, int C, int nb, int k_max,
                                    const int* ks, int identity, void* stream_handle) {
  return run(x, w1, b1, w2, b2, out, B, H, W, C, nb, k_max, ks, identity, stream_handle);
}

extern "C" int parallel_cascade_bf16(const __nv_bfloat16* x, const float* w1, const float* b1,
                                     const float* w2, const float* b2, __nv_bfloat16* out,
                                     int B, int H, int W, int C, int nb, int k_max,
                                     const int* ks, int identity, void* stream_handle) {
  return run(x, w1, b1, w2, b2, out, B, H, W, C, nb, k_max, ks, identity, stream_handle);
}
