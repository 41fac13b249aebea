// Kalman filter + Rauch-Tung-Striebel smoother of every channel of a (T, C)
// float32 block, for Hopper (sm_90a): the serial part of full imputation.
//
// No TPU kernel to translate: the JAX package runs _kalman_rts_1d
// (deepof_tpu/ops/imputation.py:44-86) as two lax.scans over frames that
// XLA compiles, vmapped over the channels. The model is a constant-velocity
// walk with dt = 1: F = [[1, 1], [0, 1]], Q = [[0.25, 0.5], [0.5, 1]] x
// 0.01, R = 0.1, P0 = 1000 I, and the first measurement broadcast into
// both position and velocity (the reference's quirk). Forward, for t >= 1:
//   x_pred = F x,   P_pred = F P F^T + Q
//   k = P_pred[:, 0] / (P_pred[0, 0] + R)
//   x = x_pred + k (z_t - x_pred[0]),   P = P_pred - k (x) P_pred[0, :]
// backward, for t = T-2 .. 0, from the last filtered state:
//   C_t = (P_filt[t] F^T) inv2(P_pred[t+1])      (inv2: adjugate / det)
//   x_s[t] = x_filt[t] + C_t (x_s[t+1] - F x_filt[t])
// and the output is x_s[:, 0]. Every operation rounds as XLA's CPU
// program of the JAX scan does, written out with the round-to-nearest
// intrinsics (the compiler contracts nothing else): its 2 x 2 products
// as fma(a_i1, b_1j, a_i0 b_0j), a - b c as fma(-b, c, a), a + b c as
// fma(b, c, a). On this model's first steps (P0 = 1000) inv2 cancels
// badly, so any other rounding moves the output by ~1e-3; with these
// the plain version (ops/kalman_kernels.py) equals the JAX scan bit for
// bit on the CPU.
//
// Design. The covariances and both gains do not depend on the data, so
// the launch computes them once for every channel, in three kernels:
//   kalman_covariances, one thread: the chain of T filter steps (two
//     divisions a step, for k), storing P_pred[t] and P_filt[t] in a
//     (T, 8) workspace and k_t in floats 4-5 of the (T, 8) gains;
//   kalman_smoother_gains, a thread a step: C_t from P_filt[t] and
//     P_pred[t+1] (its four divisions off the chain) into floats 0-3;
//   kalman_channels, a thread a channel, serial in T: the forward pass reads
//     z row by row (neighbouring threads, neighbouring channels: coalesced),
//     keeps x in registers and stores x_filt[t] as a float2 in a (T, C)
//     workspace; the backward pass reads x_filt and C_t in reverse,
//     recomputes F x_filt[t] (exact: one addition) and writes the smoothed
//     position. Each pass walks T in tiles whose loads (z and k; x_filt and
//     C) are all issued before the tile's dependent steps, so that a load's
//     latency is paid once a tile and not once a step.
// The reference's smoothed covariance never reaches x and is not computed.
//
// Bound on this card. The function reads z once and writes the output
// once: 8 T C bytes, ~10 MB at (45,000, 28), ~3 us at 3.35 TB/s; its ~20
// FP32 operations a channel-step are fewer still. Neither binds: the
// covariances are a chain of T steps with a division each, and each
// channel a chain of 2 T dependent steps, so a launch takes ~T x a step's
// latency whatever C is. Cutting the chains (a parallel-in-time affine
// scan over T) is the next design (ROADMAP queue 2).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rn_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }

constexpr int kFwdTile = 32;  // forward steps a tile: 32 z + 64 k floats in registers
constexpr int kBwdTile = 16;  // backward steps a tile: 16 float2 x_filt + 16 float4 C

// The filter's covariances and gains, one thread: cov[t] = (P_pred[t],
// P_filt[t]) row-major, gains[t] floats 4-5 = k_t (t >= 1).
__global__ void kalman_covariances(float* __restrict__ cov, float* __restrict__ gains, int t_len) {
    const float q00 = 0.0025f, q01 = 0.005f, q11 = 0.01f;  // float32 of [[0.25, 0.5], [0.5, 1]] x 0.01
    const float r = 0.1f;
    float f00 = 1000.0f, f01 = 0.0f, f10 = 0.0f, f11 = 1000.0f;  // P_filt[0] = P0
    *reinterpret_cast<float4*>(cov + 4) = make_float4(f00, f01, f10, f11);
    for (int t = 1; t < t_len; ++t) {
        // F P: [[P00 + P10, P01 + P11], [P10, P11]]; (F P) F^T adds its columns.
        const float a00 = rn_add(f00, f10), a01 = rn_add(f01, f11);
        const float p00 = rn_add(rn_add(a00, a01), q00), p01 = rn_add(a01, q01);
        const float p10 = rn_add(rn_add(f10, f11), q01), p11 = rn_add(f11, q11);
        const float s = rn_add(p00, r);
        const float k0 = rn_div(p00, s), k1 = rn_div(p10, s);
        f00 = rn_fma(-k0, p00, p00);
        f01 = rn_fma(-k0, p01, p01);
        f10 = rn_fma(-k1, p00, p10);
        f11 = rn_fma(-k1, p01, p11);
        float4* row = reinterpret_cast<float4*>(cov + (size_t)t * 8);
        row[0] = make_float4(p00, p01, p10, p11);
        row[1] = make_float4(f00, f01, f10, f11);
        *reinterpret_cast<float2*>(gains + (size_t)t * 8 + 4) = make_float2(k0, k1);
    }
}

// The smoother's gain of step t: (P_filt[t] F^T) inv2(P_pred[t+1]), into
// gains[t] floats 0-3 (t <= T-2).
__global__ void kalman_smoother_gains(const float* __restrict__ cov, float* __restrict__ gains, int t_len) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= t_len - 1) return;
    const float4 f = *reinterpret_cast<const float4*>(cov + (size_t)t * 8 + 4);
    const float4 p = *reinterpret_cast<const float4*>(cov + (size_t)(t + 1) * 8);
    const float b00 = rn_add(f.x, f.y), b01 = f.y, b10 = rn_add(f.z, f.w), b11 = f.w;
    const float det = rn_fma(p.x, p.w, -rn_mul(p.y, p.z));
    const float i00 = rn_div(p.w, det), i01 = rn_div(-p.y, det), i10 = rn_div(-p.z, det), i11 = rn_div(p.x, det);
    *reinterpret_cast<float4*>(gains + (size_t)t * 8) = make_float4(
        rn_fma(b01, i10, rn_mul(b00, i00)), rn_fma(b01, i11, rn_mul(b00, i01)),
        rn_fma(b11, i10, rn_mul(b10, i00)), rn_fma(b11, i11, rn_mul(b10, i01)));
}

__global__ void __launch_bounds__(kThreads) kalman_channels(
    const float* __restrict__ z, const float* __restrict__ gains, float2* __restrict__ x_filt,
    float* __restrict__ out, int t_len, int channels) {
    const int c = blockIdx.x * kThreads + threadIdx.x;
    if (c >= channels) return;
    float x0 = z[c], x1 = x0;
    x_filt[c] = make_float2(x0, x1);
    for (int base = 1; base < t_len; base += kFwdTile) {
        float zt[kFwdTile];
        float2 k[kFwdTile];
#pragma unroll
        for (int i = 0; i < kFwdTile; ++i) {
            const int t = base + i;
            if (t < t_len) {
                zt[i] = z[(size_t)t * channels + c];
                k[i] = *reinterpret_cast<const float2*>(gains + (size_t)t * 8 + 4);
            }
        }
#pragma unroll
        for (int i = 0; i < kFwdTile; ++i) {
            const int t = base + i;
            if (t < t_len) {
                const float xp0 = rn_add(x0, x1);  // F x
                const float innov = rn_sub(zt[i], xp0);
                x0 = rn_fma(k[i].x, innov, xp0);
                x1 = rn_fma(k[i].y, innov, x1);
                x_filt[(size_t)t * channels + c] = make_float2(x0, x1);
            }
        }
    }
    out[(size_t)(t_len - 1) * channels + c] = x0;
    for (int top = t_len - 2; top >= 0; top -= kBwdTile) {
        float4 g[kBwdTile];
        float2 xf[kBwdTile];
#pragma unroll
        for (int i = 0; i < kBwdTile; ++i) {
            const int t = top - i;
            if (t >= 0) {
                g[i] = *reinterpret_cast<const float4*>(gains + (size_t)t * 8);
                xf[i] = x_filt[(size_t)t * channels + c];
            }
        }
#pragma unroll
        for (int i = 0; i < kBwdTile; ++i) {
            const int t = top - i;
            if (t >= 0) {
                // x_s[t+1] - F x_filt[t]
                const float d0 = rn_sub(x0, rn_add(xf[i].x, xf[i].y)), d1 = rn_sub(x1, xf[i].y);
                x0 = rn_add(xf[i].x, rn_fma(g[i].y, d1, rn_mul(g[i].x, d0)));
                x1 = rn_add(xf[i].y, rn_fma(g[i].w, d1, rn_mul(g[i].z, d0)));
                out[(size_t)t * channels + c] = x0;
            }
        }
    }
}

}  // namespace

// z (t_len, channels) -> out (t_len, channels), float32, contiguous, on the
// stream's device; cov and gains (t_len, 8) and x_filt (t_len, channels,
// 2) float32 workspaces. Returns the CUDA error of the launches (0 when all
// three were taken).
extern "C" int kalman_rts_launch(const float* z, float* out, float* cov, float* gains, float* x_filt,
                                 int t_len, int channels, void* stream) {
    if (t_len <= 0 || channels <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    kalman_covariances<<<1, 1, 0, s>>>(cov, gains, t_len);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    if (t_len > 1) {
        kalman_smoother_gains<<<(t_len - 1 + kThreads - 1) / kThreads, kThreads, 0, s>>>(cov, gains, t_len);
        err = (int)cudaGetLastError();
        if (err != 0) return err;
    }
    kalman_channels<<<(channels + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        z, gains, reinterpret_cast<float2*>(x_filt), out, t_len, channels);
    return (int)cudaGetLastError();
}
