// Log-space forward and backward recursions of a hidden Markov model, for
// Hopper (sm_90a): the serial part of the HMM's forward-backward.
//
// No TPU kernel to translate: the JAX package runs the recursions as two
// lax.scans over frames that XLA compiles (deepof_tpu/msm.py:39-78,
// _forward_backward), vmapped over sequences. For N sequences of T frames
// and K states, from the log emissions log_b (N, T, K), log_pi (K,) and
// log_a (K, K):
//   log_alpha[0]    = log_pi + log_b[0]
//   log_alpha[t, j] = log_b[t, j] + LSE_i(log_alpha[t-1, i] + log_a[i, j])
//   log_beta[T-1]   = 0
//   log_beta[t, i]  = LSE_j(log_a[i, j] + (log_b[t+1, j] + log_beta[t+1, j]))
// where LSE is jax.scipy.special.logsumexp's: m = max (0 where the max is
// not finite), then log(sum exp(v - m)) + m. float32 throughout, as the
// JAX package keeps them. The wrapper (ops/hmm_kernels.py) forms the state
// posteriors, the summed transition posteriors and the log-likelihood from
// the two outputs with plain tensor ops.
//
// Design. One CTA of two warps a sequence: warp 0 runs the forward
// recursion, warp 1 the backward one, independently. Lane j owns state j
// (K <= 32, a template parameter, one instantiation each): in the forward
// warp it keeps column j of log_a in registers, in the backward warp row
// j. Each step a lane reads the K previous values by __shfl_sync
// broadcasts, adds its column (row), takes the max and the sum of expf as
// trees and one logf, and stores its one value; the next step's log_b is
// loaded a step ahead so that its latency hides behind the arithmetic.
// Lanes j >= K repeat state 0's work and store nothing. With K a runtime
// bound instead, every step would issue all 32 states' predicated
// instructions.
//
// Bound on this card. Each pass reads log_b once and writes one (N, T, K)
// output: 8NTK bytes, ~6.5 MB at (3, 26,976, 10), ~2 us at 3.35 TB/s; the
// ~4K FP32 operations a state-step are fewer still. Neither binds: each
// sequence is a chain of T dependent log-sum-exps (a round of shuffles, a
// log2(K)-deep max, the exponentials, a log2(K)-deep sum, a log), a few
// hundred cycles a step, so a pass takes ~T x that whatever N is, and only
// N sequences (x 2 warps) are in flight on 132 SMs. Cutting the chain (a
// parallel-in-time scan over T) is the next design (ROADMAP queue 2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxStates = 32;
constexpr unsigned kFull = 0xffffffffu;

// max-shifted log(sum(exp(v))) as jax.scipy.special.logsumexp takes it,
// its max and its sum each a tree over the K values (the max is exact in
// any order; the sum's order is the kernel's own).
template <int K>
__device__ __forceinline__ float lse(const float (&v)[K]) {
    float w[K];
#pragma unroll
    for (int i = 0; i < K; ++i) w[i] = v[i];
#pragma unroll
    for (int s = 1; s < K; s *= 2)
#pragma unroll
        for (int i = 0; i + s < K; i += 2 * s) w[i] = fmaxf(w[i], w[i + s]);
    const float m = isfinite(w[0]) ? w[0] : 0.0f;
#pragma unroll
    for (int i = 0; i < K; ++i) w[i] = expf(v[i] - m);
#pragma unroll
    for (int s = 1; s < K; s *= 2)
#pragma unroll
        for (int i = 0; i + s < K; i += 2 * s) w[i] += w[i + s];
    return logf(w[0]) + m;
}

// K states, a compile-time constant, so that the per-step arrays live in
// registers and no instruction is spent on states that do not exist.
template <int K>
__global__ void __launch_bounds__(64) hmm_scan_kernel(
    const float* __restrict__ log_b, const float* __restrict__ log_pi, const float* __restrict__ log_a,
    float* __restrict__ log_alpha, float* __restrict__ log_beta, int t_len) {
    const int lane = threadIdx.x & 31;
    const bool forward = threadIdx.x < 32;
    const bool own = lane < K;
    const int j = own ? lane : 0;  // lanes past K mirror state 0 and store nothing
    const size_t base = (size_t)blockIdx.x * (size_t)t_len * K;
    const float* lb = log_b + base;
    float v[K];
    float a[K];  // column j of log_a (forward) or row j (backward)
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = forward ? log_a[i * K + j] : log_a[j * K + i];

    if (forward) {
        float* out = log_alpha + base;
        float prev = log_pi[j] + lb[j];
        if (own) out[j] = prev;
        float next_b = t_len > 1 ? lb[K + j] : 0.0f;
        for (int t = 1; t < t_len; ++t) {
            const float cur_b = next_b;
            if (t + 1 < t_len) next_b = lb[(size_t)(t + 1) * K + j];
#pragma unroll
            for (int i = 0; i < K; ++i) v[i] = __shfl_sync(kFull, prev, i) + a[i];
            prev = cur_b + lse<K>(v);
            if (own) out[(size_t)t * K + j] = prev;
        }
    } else {
        float* out = log_beta + base;
        float beta = 0.0f;
        if (own) out[(size_t)(t_len - 1) * K + j] = 0.0f;
        float next_b = t_len > 1 ? lb[(size_t)(t_len - 1) * K + j] : 0.0f;
        for (int t = t_len - 2; t >= 0; --t) {
            const float w = next_b + beta;  // log_b[t+1, j] + log_beta[t+1, j]
            next_b = lb[(size_t)t * K + j];
#pragma unroll
            for (int i = 0; i < K; ++i) v[i] = a[i] + __shfl_sync(kFull, w, i);
            beta = lse<K>(v);
            if (own) out[(size_t)t * K + j] = beta;
        }
    }
}

template <int K>
int launch_k(const float* log_b, const float* log_pi, const float* log_a, float* log_alpha, float* log_beta,
             int n, int t_len, int k, cudaStream_t stream) {
    if (k != K) return launch_k<K - 1>(log_b, log_pi, log_a, log_alpha, log_beta, n, t_len, k, stream);
    hmm_scan_kernel<K><<<n, 64, 0, stream>>>(log_b, log_pi, log_a, log_alpha, log_beta, t_len);
    return (int)cudaGetLastError();
}

template <>
int launch_k<0>(const float*, const float*, const float*, float*, float*, int, int, int, cudaStream_t) {
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// log_b (n, t_len, k), log_pi (k,), log_a (k, k) -> log_alpha, log_beta
// (n, t_len, k); float32, contiguous, on the stream's device. Returns the
// CUDA error of the launch (0 when it was taken).
extern "C" int hmm_scan_launch(const float* log_b, const float* log_pi, const float* log_a, float* log_alpha,
                               float* log_beta, int n, int t_len, int k, void* stream) {
    if (n <= 0 || t_len <= 0) return 0;
    if (k < 1 || k > kMaxStates) return (int)cudaErrorInvalidValue;
    return launch_k<kMaxStates>(log_b, log_pi, log_a, log_alpha, log_beta, n, t_len, k, (cudaStream_t)stream);
}
