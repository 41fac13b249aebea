// Masked GRU recurrence with flax GRUCell math, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepof_tpu/ops/pallas_gru.py gru_scan_pallas
// (Pallas body _gru_kernel, pallas_call at :100), which MaskedGRU
// (deepof_tpu/models/blocks.py:49-63) runs behind DEEPOF_TPU_GRU_PALLAS=1.
//
// For every stream b and direction d, over t:
//   g  = xg[b, t, d, :]        input projection x W_i + b_i (one GEMM
//                              outside the kernel, as on the TPU)
//   hg = h W_h[d]              W_h = [W_hr | W_hz | W_hn], (H, 3H)
//   r  = sigmoid(g_r + hg_r),  z = sigmoid(g_z + hg_z)
//   n  = tanh(g_n + r * (hg_n + b_hn[d]))
//   h' = (1 - z) * n + z * h
// A masked step keeps the carry and writes 0. Direction d walks t backwards
// when bit d of rev_mask is set, which equals MaskedGRU's flip, scan, flip
// (blocks.py:40-42, 61-62). Both directions of a BiGRU run in one launch
// and write straight into the (B, T, D*H) concatenation; the final carries
// go to (B, D*H).
//
// Design. blockIdx.y picks the direction; the block holds that direction's
// W_h and b_hn in shared memory and loops over T inside the kernel. A group
// of G lanes (a power of two, inside one warp) owns one stream: each lane
// owns UNITS hidden units and keeps their three gate sums in registers, and
// the group shares the carry through shared memory, synchronised with
// __syncwarp. G = 2 at H = 8, 4 at H = 16, 32 at H = 128 (one warp per
// stream). expf and tanhf, no fast math.
//
// Bound on this card: bytes at the serving path's widths (H = 8, 16): each
// stream-step reads 3H floats of xg and writes H outputs for 6H^2 FLOP,
// about 3 FLOP per byte against the card's ~20 (FP32, no tensor cores)
// ridge. The least time is (xg + mask + outputs + final carries) bytes over
// 3.35 TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int UNITS = 4;
constexpr int THREADS = 256;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void gru_scan_kernel(
    const float* __restrict__ xg, const unsigned char* __restrict__ mask,
    const float* __restrict__ wh, const float* __restrict__ bhn,
    float* __restrict__ out, float* __restrict__ fin,
    int B, int T, int D, int H, int G, int rev_mask) {
  extern __shared__ float smem[];
  const int d = blockIdx.y;
  const int H3 = 3 * H;
  float* s_w = smem;          // (H, 3H)
  float* s_b = s_w + H * H3;  // (H,)
  float* s_h = s_b + H;       // (streams per block, H)

  const float* w_src = wh + (size_t)d * H * H3;
  for (int k = threadIdx.x; k < H * H3; k += blockDim.x) s_w[k] = w_src[k];
  for (int k = threadIdx.x; k < H; k += blockDim.x) s_b[k] = bhn[d * H + k];

  const int local = threadIdx.x / G;
  const int j = threadIdx.x - local * G;
  const int b = blockIdx.x * (blockDim.x / G) + local;
  const bool active = b < B;
  const int u0 = j * UNITS;
  float* h = s_h + local * H;
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    if (u0 + u < H) h[u0 + u] = 0.0f;
  }
  __syncthreads();

  const bool rev = (rev_mask >> d) & 1;
  for (int step = 0; step < T; ++step) {
    const int t = rev ? T - 1 - step : step;
    float ar[UNITS], az[UNITS], an[UNITS];
#pragma unroll
    for (int u = 0; u < UNITS; ++u) ar[u] = az[u] = an[u] = 0.0f;
    for (int k = 0; k < H; ++k) {
      const float hk = h[k];
      const float* wk = s_w + k * H3 + u0;
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        if (u0 + u < H) {
          ar[u] += hk * wk[u];
          az[u] += hk * wk[H + u];
          an[u] += hk * wk[2 * H + u];
        }
      }
    }

    float h_next[UNITS];
    if (active) {
      const bool m = mask[(size_t)b * T + t] != 0;
      const size_t row = ((size_t)b * T + t) * D + d;
      const float* g = xg + row * H3;
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int k = u0 + u;
        if (k < H) {
          const float r = sigmoid(g[k] + ar[u]);
          const float z = sigmoid(g[H + k] + az[u]);
          const float n = tanhf(g[2 * H + k] + r * (an[u] + s_b[k]));
          const float hc = h[k];
          const float hn = (1.0f - z) * n + z * hc;
          h_next[u] = m ? hn : hc;
          out[row * H + k] = m ? hn : 0.0f;
        }
      }
    }
    __syncwarp();  // every lane of the group has read the old carry
    if (active) {
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        if (u0 + u < H) h[u0 + u] = h_next[u];
      }
    }
    __syncwarp();  // the new carry is visible to the whole group
  }

  if (active) {
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      if (u0 + u < H) fin[((size_t)b * D + d) * H + u0 + u] = h[u0 + u];
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError(),
// or cudaErrorInvalidValue for a width the kernel does not take.
extern "C" int gru_scan_launch(
    const float* xg, const unsigned char* mask, const float* wh,
    const float* bhn, float* out, float* fin,
    int B, int T, int D, int H, int rev_mask, void* stream) {
  if (H < 1 || H > 32 * UNITS || D < 1 || D > 2 || B < 1 || T < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int G = 1;
  while (G * UNITS < H) G *= 2;
  const int streams_per_block = THREADS / G;
  const size_t smem =
      ((size_t)H * 3 * H + H + (size_t)streams_per_block * H) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((B + streams_per_block - 1) / streams_per_block, D);
  gru_scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      xg, mask, wh, bhn, out, fin, B, T, D, H, G, rev_mask);
  return (int)cudaGetLastError();
}
