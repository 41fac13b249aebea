// Stride-1 window gather with the standardisation affine fused in, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel deepof_tpu/ops/pallas_kernels.py
// window_gather_standardize (Pallas body _window_kernel, pallas_call at
// :111). Oracle there: window_gather_standardize_xla.
//
//   out[i, w, c] = (feats[i + w, c] - mu[c]) * (1 / sd[c]),  i < n_windows
//
// Design. The TPU kernel DMAs one overlapping row block into VMEM and
// slices every window out of it. Here each thread block owns `wpb`
// consecutive windows: it stages the wpb + window - 1 rows they share in
// shared memory once, then writes the windows row by row, one warp per
// output row with the feature index fastest, so a warp's stores cover
// consecutive addresses. The block masks the ragged tail itself (the last
// block may hold fewer than wpb windows). The affine is always applied,
// even for mu = 0, sd = 1.
//
// Bound on this card: bytes. The output is `window` times the input, so the
// least time is the output bytes (plus the input once) over 3.35 TB/s.
// wpb is chosen by the wrapper to give every SM at least two blocks; the
// halo rows a block re-reads cost a fraction of the input, which is itself
// 1/window of the traffic.

#include <cuda_runtime.h>

__global__ void window_gather_kernel(
    const float* __restrict__ feats, const float* __restrict__ mu,
    const float* __restrict__ sd, float* __restrict__ out,
    int f, int window, int n_windows, int wpb) {
  extern __shared__ float smem[];
  float* s_mu = smem;
  float* s_inv = smem + f;
  float* s_rows = smem + 2 * f;

  const int w0 = blockIdx.x * wpb;
  const int nw = min(wpb, n_windows - w0);
  const int rows = nw + window - 1;
  const float* src = feats + (size_t)w0 * f;

  for (int k = threadIdx.x; k < f; k += blockDim.x) {
    s_mu[k] = mu[k];
    s_inv[k] = 1.0f / sd[k];
  }
  for (int k = threadIdx.x; k < rows * f; k += blockDim.x) {
    s_rows[k] = src[k];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  float* dst = out + (size_t)w0 * window * f;
  for (int r = warp; r < nw * window; r += n_warps) {
    const int i = r / window;
    const int w = r - i * window;
    const float* s = s_rows + (size_t)(i + w) * f;
    float* d = dst + (size_t)r * f;
    for (int c = lane; c < f; c += 32) {
      d[c] = (s[c] - s_mu[c]) * s_inv[c];
    }
  }
}

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int window_gather_launch(
    const float* feats, const float* mu, const float* sd, float* out,
    int f, int window, int n_windows, int wpb, void* stream) {
  const size_t smem = (size_t)(2 * f + (wpb + window - 1) * f) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        window_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n_windows + wpb - 1) / wpb;
  window_gather_kernel<<<blocks, 256, smem, (cudaStream_t)stream>>>(
      feats, mu, sd, out, f, window, n_windows, wpb);
  return (int)cudaGetLastError();
}
