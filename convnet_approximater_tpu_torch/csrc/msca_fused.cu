// Fused MSCA block for Hopper (sm_90a), NHWC, x and out float32 or bfloat16:
//
//   out = x * (Wm . fix(bank(dw_k0(x) + b0)) + bm)
//   bank(a) = sum_br [vconv_k(hconv_k(a) + b1) + b2]  (+ a when `identity`)
//   fix     = FixPaddingBias: res[0] on the top min(H, p) rows, res[1] aligned
//             to the last row on the bottom min(H, p) rows; both where they overlap.
//
// Replaces the Pallas TPU kernel `msca_fused` / `_msca_fused_kernel` in
// convnet_approximater_tpu/ops/pallas/msca_kernels.py.  That kernel holds a whole (H, W, C)
// image in VMEM; a Hopper block has at most 227 KB of shared memory, less than one 56x56x32
// f32 image with its halos, so this version marches down a band of rows instead.
//
// What bounds it on the H100: operations.  Per element the depthwise chain is 2 k0^2 + 4 sum k
// FLOP (134 at d1+fix) and the mix 2 C, against 8 bytes of x read and out written, so at
// MSCAN-t's shapes the bound is the operations at 67 TFLOP/s (PERF.md).  The design keeps
// every intermediate on chip and every operation on the f32 cores, and moves each byte of the
// function about once:
//
//   1. march_kernel<21, 5, 4>: attn = fix(bank(dw_k0(x) + b0)), one launch, for MSCAN-t's
//      banks (k0 = 5, k_max = 21: the dense 7/11/21 bank, d1+fix, MscaRep's decompositions;
//      shorter banks with k0 = 5 zero-embedded at the centre of 21).  A block owns 32 channels
//      (one per lane: every warp access is 128 contiguous bytes), a tile of tw <= 8 G columns
//      and a band of rows of one image, and walks down the band one row r at a time:
//        - x rows arrive by cp.async into a ring of k0 + kAhead rows in shared memory
//          (kAhead rows in flight while the current one is computed), with a side halo of
//          k_max/2 + k0/2 columns;
//        - the k0 x k0 conv0 writes a0 row r across the tile and its k_max/2 side halo into
//          shared memory (zero outside the map: the horizontal pass zero-pads a0);
//        - every branch's horizontal pass reads that a0 row there, b1 added;
//        - the vertical pass is K running sums per column, in registers, shared by all
//          branches: row r is tap K-1-m of the sum of output row r - P + m, and the sums
//          shift down by one register per row;
//        - the identity (a0 at the output row) enters the running sum of row r, b2 starts
//          each sum, and the fix is added as an output row completes.
//      Rows outside the map hold 0 in the horizontal result (not b1): such a step computes
//      nothing.  Neither a0 nor the horizontal result reaches device memory; the band's
//      k0/2 + k_max/2 rows of halo at each edge and the tile's side halo are recomputed.
//      Every other bank and conv0 that MSCA can fuse (any odd k0, k_max up to 127) takes
//      march_any_kernel instead: the same march with k0 and K = k_max read at run time, conv0
//      read from x through the read-only cache, and the running sums in shared memory.  No
//      configuration of the repo runs it; it keeps every block on the kernel.
//   2. mix_kernel: out = x * (attn . Wm + bm), a SIMT tile product over all C channels of a
//      pixel (128 pixels x TN outputs per block), x, bm and the gate in its epilogue.
//
// Why two launches and not the mix as the march's epilogue: the mix reduces over all C
// channels of a pixel, so one launch needs a block that owns all C channels of a band, with
// C / 32 channel groups of warps marching in lock step and sharing each completed attn row in
// shared memory: 5-8 x the registers and x rings of a block at C = 160-256, one block per SM
// where the grid is already short of blocks.  What the second launch costs is the attn
// scratch, one write and one read of B H W C floats: 324 MB per d1+fix forward, 0.097 ms at
// 3.35 TB/s, against 0.5 ms of the mix's own time per forward (PERF.md).  The choice rests on
// that estimate: no one-launch variant was built or timed.
//
// Measured, the march is bound by its instruction issue, not by its FMAs: each row also costs
// the staging, the shift of the running sums, the output row's stores and two barriers, and
// with one or two blocks per SM there are few warps to hide their latency (PERF.md).
//
// Sums are fused multiply-adds (fmaf) in any convenient order: the kernel is held to 1e-5
// relative error against its plain version, which runs cuDNN's convolutions.  32-bit index
// arithmetic inside a row; divisions only per block.  The plan (kernel, tile, bands) comes from
// ops/msca_fused.py::plan; msca_fused_smem_bytes gives this file's shared memory for it.
//
// bfloat16 (msca_fused_bf16): both kernels are templated on the element type T of x and out.
// The march's x ring holds T, so a bf16 row is staged by 16-byte cp.async of 8 channels a lane
// (C % 8 == 0, x 16-byte aligned; else plain 2-byte copies) and converted to float32 (exact)
// as conv0 reads it; the ring's shared memory is planned at 4 bytes an element either way, so
// one plan serves both types.  attn between the two launches stays float32, as the TPU kernel
// never rounds it; the mix reads bf16 x, computes in float32 and rounds its output to bf16
// once (__float2bfloat16_rn).  The taps and the mix weight stay float32 (the wrapper packs
// them so).
//
// The C entry point launches on the caller's stream, does not synchronise, allocates nothing
// and returns cudaGetLastError() of the first failing launch (0 on success), or
// cudaErrorInvalidValue for a plan it does not take.

#include "row_march.cuh"

namespace {

constexpr int kMaxBranches = 8;
constexpr int kMaxWarps = 8;      // warps per march block
constexpr int kRun = 8;           // conv0 columns per thread and run
constexpr int kAhead = 4;         // x rows in flight ahead of the row conv0 needs last
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may use

__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// a0 columns per row the block computes: the warps' G-column groups plus K - 1 of halo
__host__ __device__ inline int a0_width(int K, int G, int warps) {
  return round_up(warps * G + K - 1, kRun);
}

// march_kernel<K, K0, G> (its only instantiation) and march_any_kernel, told apart by G
constexpr int kFastK = 21, kFastK0 = 5, kFastG = 4;

int smem_bytes(int K, int k0, int nb, int G, int warps, int tw) {
  if (G == kFastG) {
    const int aw = a0_width(K, G, warps), xw = aw + k0 - 1;
    // taps wh, wv [nb][K][32]; b1 [nb][32]; w0 [k0 k0][32]; a0 row [aw][32];
    // x ring [k0 + kAhead][xw][32]
    return (int)sizeof(float) * kLanes * (2 * nb * K + nb + k0 * k0 + aw + (k0 + kAhead) * xw);
  }
  // march_any_kernel: taps wh, wv [nb][K][32]; b1 [nb][32]; a0 row [tw + K - 1][32];
  // running sums [K][tw][32]
  return (int)sizeof(float) * kLanes * (2 * nb * K + nb + tw + K - 1 + K * tw);
}

// Stage x row r, columns x_left .. x_left + xw - 1, into its ring slot r mod xr; zeros outside
// the map (rows and columns) and for channels past C.  One cp.async group.  Where C is a
// multiple of V = 16 / sizeof(T) (and x 16-byte aligned: `vec`), each lane copies 16 bytes (V
// channels: 4 float32 or 8 bf16), so a warp stages 32 / V columns at once.  Otherwise float32
// copies 4 bytes a lane by cp.async and bf16 its 2 bytes by a plain load.
template <typename T>
__device__ __forceinline__ void stage_x_row(T* xs, const T* __restrict__ x, const Tile& t,
                                            int r, int H, int W, int C, int x_left, int xw,
                                            int xr, int vec) {
  constexpr int V = 16 / sizeof(T), L = kLanes / V;  // channels a lane, lanes a column
  T* dst = xs + ((r % xr + xr) % xr) * xw * kLanes;
  const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const bool row_ok = r >= 0 && r < H;
  if (vec) {
    const int quad = (lane % L) * V, cc = t.c - lane + quad;  // channels cc .. cc + V - 1
    const T* src = x + (row_ok ? (t.image + r) * W * C + cc : 0);
    for (int col = (threadIdx.x >> 5) * V + lane / L; col < xw; col += nwarps * V) {
      const int ww = x_left + col;
      T* d = dst + col * kLanes + quad;
      if (row_ok && cc < C && ww >= 0 && ww < W)
        cp_async16(reinterpret_cast<float*>(d), reinterpret_cast<const float*>(src + ww * C));
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const T* src = x + (row_ok && t.c_ok ? (t.image + r) * W * C + t.c : 0);
    for (int col = threadIdx.x >> 5; col < xw; col += nwarps) {
      const int ww = x_left + col;
      T* d = dst + col * kLanes + lane;
      if (row_ok && t.c_ok && ww >= 0 && ww < W) {
        if constexpr (sizeof(T) == 4)
          cp_async4(reinterpret_cast<float*>(d), reinterpret_cast<const float*>(src + ww * C));
        else
          *d = src[ww * C];
      } else {
        store(d, 0.f);
      }
    }
  }
  cp_async_commit();
}

// One march over a band.  K: the bank's tap count (k_max <= K, zero-embedded at the centre);
// K0: conv0's size; G: output columns per thread.  Every tap is read from shared memory, so the
// registers hold the running sums and little else.  Instantiated once, at MSCAN-t's banks.
template <int K, int K0, int G, typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
march_kernel(const T* __restrict__ x, const float* __restrict__ w0,
             const float* __restrict__ b0, const float* __restrict__ w1,
             const float* __restrict__ b1, const float* __restrict__ w2,
             const float* __restrict__ b2, const float* __restrict__ res,
             float* __restrict__ attn, int H, int W, int C, int nb, int k_max, int identity,
             int fix_p, int tw, int rows, int bands, int ntiles, int nchunks, int vec) {
  constexpr int P = K / 2, p0 = K0 / 2, xr = K0 + kAhead;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int aw = a0_width(K, G, nwarps), xw = aw + K0 - 1;
  const Tile t = tile_of(H, C, tw, rows, bands, ntiles, nchunks);

  extern __shared__ float smem[];
  float* whs = smem;                    // [nb][K][32]
  float* wvs = whs + nb * K * kLanes;   // [nb][K][32]
  float* b1s = wvs + nb * K * kLanes;   // [nb][32]
  float* w0s = b1s + nb * kLanes;       // [k0 k0][32]
  float* a0s = w0s + K0 * K0 * kLanes;  // [aw][32]: a0 at columns w0 - P + i
  T* xs = reinterpret_cast<T*>(a0s + aw * kLanes);  // [K0 + kAhead][xw][32]: x at columns
                                                    // w0 - P - p0 + i

  const int c0 = t.c - lane, d = (K - k_max) / 2;
  for (int i = threadIdx.x; i < nb * K * kLanes; i += blockDim.x) {
    const int cc = c0 + (i & 31), br = (i >> 5) / K, j = (i >> 5) % K - d;
    const bool ok = cc < C && j >= 0 && j < k_max;
    const int src = (br * k_max + j) * C + cc;
    whs[i] = ok ? w1[src] : 0.f;
    wvs[i] = ok ? w2[src] : 0.f;
  }
  for (int i = threadIdx.x; i < nb * kLanes; i += blockDim.x) {
    const int cc = c0 + (i & 31);
    b1s[i] = cc < C ? b1[(i >> 5) * C + cc] : 0.f;
  }
  for (int i = threadIdx.x; i < K0 * K0 * kLanes; i += blockDim.x) {
    const int cc = c0 + (i & 31);
    w0s[i] = cc < C ? w0[(i >> 5) * C + cc] : 0.f;
  }
  float bsum = 0.f, bias0 = 0.f;
  if (t.c_ok) {
    bias0 = b0[t.c];
    for (int br = 0; br < nb; ++br) bsum += b2[br * C + t.c];
  }
  // acc[m][q]: the running sum of output row r - P + m at column col0 + q, while row r is
  // marched; it shifts down by one row after each row
  float acc[K][G];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int q = 0; q < G; ++q) acc[s][q] = bsum;

  const int col0 = warp * G, x_left = t.w0 - P - p0;
  const int p2 = fix_p < H ? fix_p : H;
  // rows of the horizontal result the band needs: [h0 - P, h1 + P); those in the map
  // [rb, re_in) are computed, the rest are 0
  const int rb = max(t.h0 - P, 0), re = t.h1 + P, re_in = min(t.h1 + P, H);
  // x rows rb - p0 .. rb + p0 + kAhead - 1 in flight, one cp.async group each
  for (int s = 0; s < K0 + kAhead - 1; ++s)
    stage_x_row(xs, x, t, rb - p0 + s, H, W, C, x_left, xw, xr, vec);

  for (int r = rb; r < re; ++r) {
    if (r < re_in) {
      cp_async_wait<kAhead - 1>();  // x rows r - p0 .. r + p0 have landed
      __syncthreads();  // ...for every thread; row r - p0 - 1's slot and a0s are free
      if (r + kAhead < re_in)
        stage_x_row(xs, x, t, r + p0 + kAhead, H, W, C, x_left, xw, xr, vec);
      else
        cp_async_commit();  // one group per row keeps the wait above exact

      // conv0: a0 row r, runs of kRun columns
      const int slot0 = ((r - p0) % xr + xr) % xr;
      for (int n = warp; n < aw / kRun; n += nwarps) {
        const int cb = n * kRun;
        float a[kRun];
#pragma unroll
        for (int q = 0; q < kRun; ++q) a[q] = bias0;
        int sl = slot0;
#pragma unroll
        for (int i = 0; i < K0; ++i) {
          const T* xp = xs + (sl * xw + cb) * kLanes + lane;
          float win[kRun + K0 - 1];
#pragma unroll
          for (int s = 0; s < kRun + K0 - 1; ++s) win[s] = to_f32(xp[s * kLanes]);
#pragma unroll
          for (int j = 0; j < K0; ++j) {
            const float w = w0s[(i * K0 + j) * kLanes + lane];
#pragma unroll
            for (int q = 0; q < kRun; ++q) a[q] = fmaf(w, win[q + j], a[q]);
          }
          sl = sl + 1 == xr ? 0 : sl + 1;
        }
#pragma unroll
        for (int q = 0; q < kRun; ++q) {
          const int ww = t.w0 - P + cb + q;
          a0s[(cb + q) * kLanes + lane] = ww >= 0 && ww < W ? a[q] : 0.f;
        }
      }
      __syncthreads();  // a0 row r is in shared memory

      const float* ap = a0s + col0 * kLanes + lane;
      for (int br = 0; br < nb; ++br) {
        const float* wh = whs + br * K * kLanes + lane;
        const float* wv = wvs + br * K * kLanes + lane;
        float h[G];
#pragma unroll
        for (int q = 0; q < G; ++q) h[q] = b1s[br * kLanes + lane];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const float w = wh[j * kLanes];
#pragma unroll
          for (int q = 0; q < G; ++q) h[q] = fmaf(w, ap[(q + j) * kLanes], h[q]);
        }
        // row r is tap K - 1 - m of output row r - P + m
#pragma unroll
        for (int m = 0; m < K; ++m) {
          const float w = wv[(K - 1 - m) * kLanes];
#pragma unroll
          for (int q = 0; q < G; ++q) acc[m][q] = fmaf(w, h[q], acc[m][q]);
        }
      }
      if (identity) {
#pragma unroll
        for (int q = 0; q < G; ++q) acc[P][q] += ap[(q + P) * kLanes];
      }
    }

    // output row o = r - P took its last tap with row r
    const int o = r - P;
    if (o >= t.h0 && t.c_ok) {
      float fix = 0.f;
      if (o < p2) fix += res[o * C + t.c];
      if (o >= H - p2) fix += res[(2 * fix_p - H + o) * C + t.c];
      float* dst = attn + (t.image + o) * W * C + t.c;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int col = col0 + q;
        if (col < tw && t.w0 + col < W) dst[(t.w0 + col) * C] = acc[0][q] + fix;
      }
    }
    // shift: the sum of row r - P + m + 1 moves to acc[m]; acc[K - 1] starts row r + P + 1,
    // whose first tap is the next row
#pragma unroll
    for (int s = 0; s + 1 < K; ++s)
#pragma unroll
      for (int q = 0; q < G; ++q) acc[s][q] = acc[s + 1][q];
#pragma unroll
    for (int q = 0; q < G; ++q) acc[K - 1][q] = bsum;
  }
}

// The march for every other bank and conv0: any odd k0 (read at run time) and K = k_max taps
// (any bank that packed() admits: nb <= 8, nb k_max <= 128), tw columns per block, each warp
// taking every nwarps-th column.  conv0 reads x through the read-only cache rather than a staged
// ring, so shared memory does not grow with k0; the running sums live in a ring of K rows in
// shared memory (output row o in slot o mod K), so K need not be known to the compiler.  Rows
// outside the map, the identity, b2 and the fix as in march_kernel.
template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
march_any_kernel(const T* __restrict__ x, const float* __restrict__ w0,
                 const float* __restrict__ b0, const float* __restrict__ w1,
                 const float* __restrict__ b1, const float* __restrict__ w2,
                 const float* __restrict__ b2, const float* __restrict__ res,
                 float* __restrict__ attn, int H, int W, int C, int k0, int nb, int K,
                 int identity, int fix_p, int tw, int rows, int bands, int ntiles, int nchunks) {
  const int P = K / 2, p0 = k0 / 2, aw = tw + K - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const Tile t = tile_of(H, C, tw, rows, bands, ntiles, nchunks);

  extern __shared__ float smem[];
  float* whs = smem;                   // [nb][K][32]
  float* wvs = whs + nb * K * kLanes;  // [nb][K][32]
  float* b1s = wvs + nb * K * kLanes;  // [nb][32]
  float* a0s = b1s + nb * kLanes;      // [aw][32]: a0 at columns w0 - P + i
  float* accs = a0s + aw * kLanes;     // [K][tw][32]: the running sum of output row o in slot o mod K

  const int c0 = t.c - lane;
  for (int i = threadIdx.x; i < nb * K * kLanes; i += blockDim.x) {
    const int cc = c0 + (i & 31), src = (i >> 5) * C + cc;
    whs[i] = cc < C ? w1[src] : 0.f;
    wvs[i] = cc < C ? w2[src] : 0.f;
  }
  for (int i = threadIdx.x; i < nb * kLanes; i += blockDim.x) {
    const int cc = c0 + (i & 31);
    b1s[i] = cc < C ? b1[(i >> 5) * C + cc] : 0.f;
  }
  float bsum = 0.f, bias0 = 0.f;
  if (t.c_ok) {
    bias0 = b0[t.c];
    for (int br = 0; br < nb; ++br) bsum += b2[br * C + t.c];
  }
  for (int i = threadIdx.x; i < K * tw * kLanes; i += blockDim.x) accs[i] = bsum;  // lane i & 31

  const int p2 = fix_p < H ? fix_p : H;
  const int rb = max(t.h0 - P, 0), re = t.h1 + P, re_in = min(t.h1 + P, H);
  for (int r = rb; r < re; ++r) {
    if (r < re_in) {
      __syncthreads();  // the taps are staged, and every warp is done with a0 row r - 1
      // conv0: a0 row r, zero outside the map
      for (int i = warp; i < aw; i += nwarps) {
        const int ww = t.w0 - P + i;
        float a = 0.f;
        if (t.c_ok && ww >= 0 && ww < W) {
          a = bias0;
          for (int di = 0; di < k0; ++di) {
            const int rr = r - p0 + di;
            if (rr < 0 || rr >= H) continue;
            const T* xrow = x + (t.image + rr) * W * C + t.c;
            const float* wrow = w0 + di * k0 * C + t.c;
            for (int dj = 0; dj < k0; ++dj) {
              const int wc = ww - p0 + dj;
              if (wc >= 0 && wc < W) a = fmaf(__ldg(wrow + dj * C), to_f32(__ldg(xrow + wc * C)), a);
            }
          }
        }
        a0s[i * kLanes + lane] = a;
      }
      __syncthreads();  // a0 row r is in shared memory

      for (int col = warp; col < tw; col += nwarps) {
        const float* ap = a0s + col * kLanes + lane;
        float h[kMaxBranches];
#pragma unroll
        for (int br = 0; br < kMaxBranches; ++br) {
          if (br >= nb) break;
          const float* wh = whs + br * K * kLanes + lane;
          float v = b1s[br * kLanes + lane];
          for (int j = 0; j < K; ++j) v = fmaf(wh[j * kLanes], ap[j * kLanes], v);
          h[br] = v;
        }
        // row r is tap K - 1 - m of output row r - P + m, whose slot is (r - P + m) mod K
        int slot = (r - P + K) % K;
        for (int m = 0; m < K; ++m) {
          float* sp = accs + (slot * tw + col) * kLanes + lane;
          float v = *sp;
#pragma unroll
          for (int br = 0; br < kMaxBranches; ++br) {
            if (br >= nb) break;
            v = fmaf(wvs[(br * K + K - 1 - m) * kLanes + lane], h[br], v);
          }
          if (identity && m == P) v += ap[P * kLanes];
          *sp = v;
          slot = slot + 1 == K ? 0 : slot + 1;
        }
      }
    }

    // output row o = r - P took its last tap with row r; its slot starts row o + K
    const int o = r - P, so = (o + K) % K;
    for (int col = warp; col < tw; col += nwarps) {
      float* sp = accs + (so * tw + col) * kLanes + lane;
      if (o >= t.h0 && t.c_ok && t.w0 + col < W) {
        float fix = 0.f;
        if (o < p2) fix += res[o * C + t.c];
        if (o >= H - p2) fix += res[(2 * fix_p - H + o) * C + t.c];
        attn[((t.image + o) * W + t.w0 + col) * C + t.c] = *sp + fix;
      }
      *sp = bsum;
    }
  }
}

// out[m, n] = x[m, n] * (sum_k attn[m, k] wm[k, n] + bm[n]) over M = B H W pixels.  A block
// of 256 threads (8 across the outputs, 32 across the pixels) computes 128 pixels x TN
// outputs, 4 x TN/8 neighbours per thread, so that each step of the reduction reads its
// operands from shared memory as 16-byte vectors; the C (reduction) axis is staged 16 at a
// time (as float4 where C is a multiple of 4).
constexpr int kMixThreads = 256;
constexpr int kTM = 128;
constexpr int kTK = 16;

template <int TN, typename T>
__global__ void __launch_bounds__(kMixThreads)
mix_kernel(const float* __restrict__ attn, const float* __restrict__ wm,
           const float* __restrict__ bm, const T* __restrict__ x,
           T* __restrict__ out, int M, int C) {
  constexpr int NX = 8, RN = TN / NX, NY = kMixThreads / NX, RM = kTM / NY;
  static_assert(RN % 4 == 0 && kTM % NY == 0, "tile");
  __shared__ __align__(16) float As[kTK][kTM + 4];  // As[k][m]
  __shared__ __align__(16) float Bs[kTK][TN];      // Bs[k][n]
  const int tid = threadIdx.x, tx = tid % NX, ty = tid / NX;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * TN;
  const bool vec = C % 4 == 0;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < C; kb += kTK) {
    if (vec) {
      for (int e = tid; e < kTM * kTK / 4; e += kMixThreads) {
        const int row = e / (kTK / 4), k = kb + (e % (kTK / 4)) * 4, m = m0 + row;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < M && k < C) v = *reinterpret_cast<const float4*>(attn + (int64_t)m * C + k);
        As[k - kb][row] = v.x;
        As[k - kb + 1][row] = v.y;
        As[k - kb + 2][row] = v.z;
        As[k - kb + 3][row] = v.w;
      }
    } else {
      for (int e = tid; e < kTM * kTK; e += kMixThreads) {
        const int row = e / kTK, col = e % kTK, m = m0 + row, k = kb + col;
        As[col][row] = m < M && k < C ? attn[(int64_t)m * C + k] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < kTK * TN / kMixThreads; ++q) {
      const int e = tid + q * kMixThreads, row = e / TN, col = e % TN;
      const int k = kb + row, n = n0 + col;
      Bs[row][col] = k < C && n < C ? wm[k * C + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[kk][ty * RM + i];
#pragma unroll
      for (int j = 0; j < RN; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[kk][tx * RN + j]);
        b[j] = v.x;
        b[j + 1] = v.y;
        b[j + 2] = v.z;
        b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty * RM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + tx * RN + j;
      if (n >= C) continue;
      const int64_t o = (int64_t)m * C + n;
      store(out + o, to_f32(x[o]) * (acc[i][j] + bm[n]));
    }
  }
}

}  // namespace

extern "C" int msca_fused_smem_bytes(int K, int k0, int nb, int G, int warps, int tw) {
  return smem_bytes(K, k0, nb, G, warps, tw);
}

namespace {

// G = 4: march_kernel<21, 5, 4> (K = 21, k0 = 5, k_max <= 21 zero-embedded); G = 1:
// march_any_kernel (K = k_max).  ops/msca_fused.py::plan chooses.
template <typename T>
int run(const T* x, const float* w0, const float* b0, const float* w1, const float* b1,
        const float* w2, const float* b2, const float* wm, const float* bm, const float* res,
        float* attn, T* out, int B, int H, int W, int C, int k0, int nb, int k_max, int identity,
        int fix_p, int K, int G, int warps, int tw, int ntiles, int rows, int bands, int mix_tn,
        void* stream_handle) {
  const bool fast = G == kFastG;
  if ((fast ? K != kFastK || k0 != kFastK0 || warps * G < tw : G != 1 || K != k_max) ||
      nb < 1 || nb > kMaxBranches || k_max < 1 || k_max > K || (K - k_max) % 2 || k0 < 1 ||
      k0 % 2 == 0 || B < 1 || H < 1 || W < 1 || C < 1 || warps < 1 || warps > kMaxWarps ||
      tw < 1 || ntiles * tw < W || rows < 1 || bands * rows < H ||
      (fix_p > 0) != (res != nullptr) || (int64_t)W * C > INT32_MAX ||
      (int64_t)B * H * W > INT32_MAX || (mix_tn != 32 && mix_tn != 64))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(K, k0, nb, G, warps, tw);
  const int64_t blocks = (int64_t)B * cdiv(C, kLanes) * ntiles * bands;
  if (smem > kSmemMax || blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_handle);
  const void* march = fast ? (const void*)march_kernel<kFastK, kFastK0, kFastG, T>
                           : (const void*)march_any_kernel<T>;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(march, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
          cudaSuccess)
    return (int)err;
  if (fast)
    march_kernel<kFastK, kFastK0, kFastG, T><<<(unsigned)blocks, warps * 32, smem, stream>>>(
        x, w0, b0, w1, b1, w2, b2, res, attn, H, W, C, nb, k_max, identity, fix_p, tw, rows,
        bands, ntiles, cdiv(C, kLanes),
        C % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0);
  else
    march_any_kernel<T><<<(unsigned)blocks, warps * 32, smem, stream>>>(
        x, w0, b0, w1, b1, w2, b2, res, attn, H, W, C, k0, nb, K, identity, fix_p, tw, rows,
        bands, ntiles, cdiv(C, kLanes));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int M = B * H * W;
  const dim3 grid((unsigned)cdiv(M, kTM), (unsigned)cdiv(C, mix_tn));
  if (mix_tn == 64)
    mix_kernel<64, T><<<grid, kMixThreads, 0, stream>>>(attn, wm, bm, x, out, M, C);
  else
    mix_kernel<32, T><<<grid, kMixThreads, 0, stream>>>(attn, wm, bm, x, out, M, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int msca_fused_f32(const float* x, const float* w0, const float* b0,
                              const float* w1, const float* b1, const float* w2,
                              const float* b2, const float* wm, const float* bm,
                              const float* res, float* attn, float* out, int B, int H, int W,
                              int C, int k0, int nb, int k_max, int identity, int fix_p, int K,
                              int G, int warps, int tw, int ntiles, int rows, int bands,
                              int mix_tn, void* stream_handle) {
  return run(x, w0, b0, w1, b1, w2, b2, wm, bm, res, attn, out, B, H, W, C, k0, nb, k_max,
             identity, fix_p, K, G, warps, tw, ntiles, rows, bands, mix_tn, stream_handle);
}

// x and out bf16; attn, the taps and the mix weight float32.
extern "C" int msca_fused_bf16(const __nv_bfloat16* x, const float* w0, const float* b0,
                               const float* w1, const float* b1, const float* w2,
                               const float* b2, const float* wm, const float* bm,
                               const float* res, float* attn, __nv_bfloat16* out, int B, int H,
                               int W, int C, int k0, int nb, int k_max, int identity, int fix_p,
                               int K, int G, int warps, int tw, int ntiles, int rows, int bands,
                               int mix_tn, void* stream_handle) {
  return run(x, w0, b0, w1, b1, w2, b2, wm, bm, res, attn, out, B, H, W, C, k0, nb, k_max,
             identity, fix_p, K, G, warps, tw, ntiles, rows, bands, mix_tn, stream_handle);
}
