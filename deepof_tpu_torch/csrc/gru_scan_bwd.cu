// Backward of the fused bidirectional masked GRU layer (gru_scan.cu), for
// Hopper (sm_90a): the serial part of the layer's gradient.
//
// No TPU kernel to translate: the JAX package's Pallas GRU
// (deepof_tpu/ops/pallas_gru.py gru_scan_pallas) is forward-only, and JAX
// trains through flax nn.scan (deepof_tpu/models/blocks.py:65-89), whose
// backward XLA derives. This kernel is that derivative written out.
//
// Forward, for stream b and direction d at a step t (flax GRUCell gates:
// r and z have input-side biases only, b_hn sits inside r * (...)):
//   g  = x_t W_i + b_i,   hg = h W_h,   h = the carry the step starts from
//   r  = sigmoid(g_r + hg_r),  z = sigmoid(g_z + hg_z)
//   n  = tanh(g_n + r * (hg_n + b_hn)),  h' = (1 - z) n + z h
// and a masked step keeps the carry and outputs 0. Walking each
// direction's processing order backwards from dh = dfin, at a valid step
//   dh~   = dh + dout_t
//   da_n  = dh~ (1 - z) (1 - n^2)          (gradient of g_n)
//   dHn   = da_n r                         (gradient of hg_n + b_hn)
//   da_r  = da_n (hg_n + b_hn) r (1 - r)   (of g_r and of hg_r)
//   da_z  = dh~ (h - n) z (1 - z)          (of g_z and of hg_z)
//   dh    = z dh~ + [da_r | da_z | dHn] W_h^T
// and at a masked step dh passes through unchanged and the step's gate
// gradients are 0. The kernel writes dG = [da_r | da_z | da_n] (B, T, D, 3H)
// and dHn (B, T, D, H); the wrapper (ops/gru_kernels.py) forms
// dx = sum_d dG_d W_i,d^T, dW_i = x^T dG, db_i = sum dG,
// dW_h = h^T [da_r | da_z | dHn] and db_hn = sum dHn as matrix products
// over all stream-steps. r, z, n are recomputed from x, the weights and the
// carries `hs` (B, T, D, H) that the forward launch stored in training
// mode, with the forward kernel's SFU gate functions.
//
// Design. The forward's ownership: a CTA owns a tile of S streams and both
// directions, a lane owns one hidden unit j of one direction of one stream
// (a group of G >= H lanes per stream-direction). Each step a lane
// recomputes its unit's three gate sums (x_t and the carry h read as
// broadcasts, its columns of W_i and W_h through L1), forms its unit's
// gradients, and publishes (da_r, da_z, dHn)_j in shared memory,
// double-buffered by step parity; after one __syncwarp (__syncthreads
// when a group spans warps, H > 32) it reads all H units' values against
// row j of W_h to form dh for the step before. Row j is read from a
// transposed copy of W_h (D, 3H, H) that the wrapper passes, where it is a
// column, so that the lanes of a group read consecutive floats (from W_h
// itself, lanes 3H floats apart, each such load of a warp touches 16 or
// more cache lines). The grid is persistent.
// FP32 FMAs, no tensor cores.
//
// Bound on this card. Per valid stream-step and direction the kernel
// does the forward's projections again, 6H(F + H) FLOP, plus the carry
// gradient's 6H^2 and ~20H of gate algebra, and moves x (4F bytes a
// stream-step), the carries and the output gradient (4H each) and its
// outputs dG and dHn (16H). At the training widths (F, H) = (16, 16),
// (32, 8), (8, 8) that is 9-12 FLOP a byte, under the ~20 FLOP/B ridge of
// 67 TFLOP/s over 3.35 TB/s: bytes bound them, the dG store most of all;
// at H = 128 operations do. The T serial steps, each a chain of
// dependent loads, FMAs and one barrier, keep the kernel far from either
// bound (PERF.md); the next designs (weights in registers, dW reduced in
// the kernel, the LayerNorm's backward fused) are in ROADMAP queue 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TARGET_THREADS = 128;
constexpr int MAX_HIDDEN = 128;
constexpr int MAX_THREADS = 2 * MAX_HIDDEN;

struct Params {
  const float* x;              // (B, T, F)
  const unsigned char* mask;   // (B, T)
  const float* wi;             // (D, F, 3H)
  const float* bi;             // (D, 3H)
  const float* wh;             // (D, H, 3H)
  const float* wht;            // (D, 3H, H): W_h transposed
  const float* bhn;            // (D, H)
  const float* hs;             // (B, T, D, H): the carry each step starts from
  const float* dout;           // (B, T, D, H) or null (final carries only)
  const float* dfin;           // (B, D, H) or null
  float* dg;                   // (B, T, D, 3H)
  float* dhn;                  // (B, T, D, H)
  int B, T, F, H, D, G, S, rev_mask;
};

// The forward kernel's gate functions (gru_scan.cu), so that the recomputed
// r, z, n are the ones the forward used.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_sfu(float x) {
  return 2.0f * sigmoid(2.0f * x) - 1.0f;
}

__global__ void __launch_bounds__(MAX_THREADS) gru_bwd_kernel(Params p) {
  // (2 parities, S streams, D directions, 3 gates, G units)
  extern __shared__ __align__(16) float ex[];
  const int T = p.T, F = p.F, H = p.H, D = p.D, G = p.G, S = p.S;
  const int H3 = 3 * H, DH = D * H;

  // Lane (q, d, j) owns unit j of direction d of stream q of the tile.
  const int tid = threadIdx.x;
  const int q = tid / (D * G);
  const int d = (tid - q * D * G) / G;
  const int j = tid - q * D * G - d * G;
  const bool unit = j < H;
  const int jj = unit ? j : 0;  // idle lanes read unit 0's weights, write nothing
  const bool rev = (p.rev_mask >> d) & 1;

  const float* wid = p.wi + (size_t)d * F * H3 + jj;   // column j of W_i,d
  const float* whd = p.wh + (size_t)d * H * H3 + jj;   // column j of W_h,d
  const float* whrow = p.wht + (size_t)d * H3 * H + jj;  // row j of W_h,d, H floats apart
  const float bir = p.bi[d * H3 + jj];
  const float biz = p.bi[d * H3 + H + jj];
  const float bin = p.bi[d * H3 + 2 * H + jj];
  const float bhn = p.bhn[d * H + jj];

  const int ntiles = (p.B + S - 1) / S;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile * S + q;
    const bool live = b < p.B;
    const int bc = live ? b : 0;  // idle slots of a ragged tile read stream 0
    const float* xb = p.x + (size_t)bc * T * F;
    const unsigned char* mb = p.mask + (size_t)bc * T;
    float dh = (p.dfin != nullptr && unit) ? p.dfin[(size_t)bc * DH + d * H + j] : 0.0f;

    for (int step = T - 1; step >= 0; --step) {
      const int t = rev ? T - 1 - step : step;
      const bool m = mb[t] != 0;
      const size_t row = ((size_t)bc * T + t) * D + d;  // (b, t, d)
      const float* hp = p.hs + row * H;
      float* exs = ex + (((size_t)(step & 1) * S + q) * D + d) * 3 * G;
      float dar = 0.0f, daz = 0.0f, dan = 0.0f, dhn = 0.0f, z = 0.0f, dht = dh;
      if (m) {
        float gr = bir, gz = biz, gn = bin;
        const float* xr = xb + (size_t)t * F;
#pragma unroll 4
        for (int k = 0; k < F; ++k) {
          const float v = __ldg(xr + k);
          const float* w = wid + (size_t)k * H3;
          gr = fmaf(v, __ldg(w), gr);
          gz = fmaf(v, __ldg(w + H), gz);
          gn = fmaf(v, __ldg(w + 2 * H), gn);
        }
        float hr = 0.0f, hz = 0.0f, hn = bhn;
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
          const float v = __ldg(hp + k);
          const float* w = whd + (size_t)k * H3;
          hr = fmaf(v, __ldg(w), hr);
          hz = fmaf(v, __ldg(w + H), hz);
          hn = fmaf(v, __ldg(w + 2 * H), hn);
        }
        const float r = sigmoid(gr + hr);
        z = sigmoid(gz + hz);
        const float n = tanh_sfu(gn + r * hn);
        if (p.dout != nullptr) dht += __ldg(p.dout + row * H + jj);
        dan = dht * (1.0f - z) * (1.0f - n * n);
        dhn = dan * r;
        dar = dan * hn * r * (1.0f - r);
        daz = dht * (__ldg(hp + jj) - n) * z * (1.0f - z);
      }
      if (unit) {
        exs[j] = dar;
        exs[G + j] = daz;
        exs[2 * G + j] = dhn;
        if (live) {
          float* dgr = p.dg + row * H3;
          dgr[j] = dar;
          dgr[H + j] = daz;
          dgr[2 * H + j] = dan;
          p.dhn[row * H + j] = dhn;
        }
      }
      if (G <= 32) {
        __syncwarp();
      } else {
        __syncthreads();
      }
      if (m) {
        // dh for the step before: z dh~ plus the three gates' recurrent
        // gradients against row j of W_h.
        float acc = z * dht;
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
          acc = fmaf(exs[k], __ldg(whrow + (size_t)k * H), acc);
          acc = fmaf(exs[G + k], __ldg(whrow + (size_t)(H + k) * H), acc);
          acc = fmaf(exs[2 * G + k], __ldg(whrow + (size_t)(2 * H + k) * H), acc);
        }
        dh = acc;
      }
    }
    // Every lane has read the last step's buffer before the next tile's
    // first step writes it again.
    __syncthreads();
  }
}

struct Plan {
  int G, S, threads;
  size_t smem;
};

Plan plan(int H, int D) {
  Plan pl;
  // A group of G lanes per stream-direction: a power of two inside a warp,
  // or whole warps above H = 32 (as the forward's).
  int g = 1;
  while (g < H) g *= 2;
  pl.G = g <= 32 ? g : (H + 31) / 32 * 32;
  pl.S = TARGET_THREADS / (D * pl.G) > 0 ? TARGET_THREADS / (D * pl.G) : 1;
  pl.threads = pl.S * D * pl.G;
  pl.smem = (size_t)2 * pl.S * D * 3 * pl.G * sizeof(float);
  return pl;
}

bool valid(int B, int T, int F, int H, int D) {
  return H >= 1 && H <= MAX_HIDDEN && D >= 1 && D <= 2 && B >= 1 && T >= 1 && F >= 1;
}

}  // namespace

// The launch the wrapper makes for this shape: streams per CTA, threads per
// CTA, shared-memory bytes per CTA, CTAs resident per SM. Returns a CUDA
// error code.
extern "C" int gru_scan_bwd_config(int T, int F, int H, int D, int* info) {
  if (!valid(1, T, F, H, D)) return (int)cudaErrorInvalidValue;
  const Plan pl = plan(H, D);
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_bwd_kernel, pl.threads, pl.smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = pl.S;
  info[1] = pl.threads;
  info[2] = (int)pl.smem;
  info[3] = per_sm;
  return 0;
}

// Launches on `stream` without synchronising; returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int gru_scan_bwd_launch(
    const float* x, const unsigned char* mask, const float* wi, const float* bi,
    const float* wh, const float* wht, const float* bhn, const float* hs, const float* dout,
    const float* dfin, float* dg, float* dhn, int B, int T, int F, int H, int D,
    int rev_mask, void* stream) {
  if (!valid(B, T, F, H, D)) return (int)cudaErrorInvalidValue;
  const Plan pl = plan(H, D);
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gru_bwd_kernel, pl.threads, pl.smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (B + pl.S - 1) / pl.S;
  const int grid = ntiles < per_sm * sms ? ntiles : per_sm * sms;

  Params p;
  p.x = x; p.mask = mask; p.wi = wi; p.bi = bi; p.wh = wh; p.wht = wht; p.bhn = bhn;
  p.hs = hs; p.dout = dout; p.dfin = dfin; p.dg = dg; p.dhn = dhn;
  p.B = B; p.T = T; p.F = F; p.H = H; p.D = D; p.G = pl.G; p.S = pl.S;
  p.rev_mask = rev_mask;
  gru_bwd_kernel<<<grid, pl.threads, pl.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
