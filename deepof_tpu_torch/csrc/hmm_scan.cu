// Log-space forward and backward recursions of a hidden Markov model, for
// Hopper (sm_90a): the serial part of the HMM's forward-backward, as a
// chunked parallel-in-time scan.
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
// Both recursions are products in the log semiring (a (x) b = LSE of sums)
// with the matrices M_t[i, j] = log_a[i, j] + log_b[t, j], t = 1..T-1:
//   alpha_t = alpha_{t-1} (x) M_t,   beta_{t-1} = M_t (x) beta_t.
// One serial chain of T log-sum-exps a sequence and direction left 130 of
// 132 SMs idle at the cohort's 3 sequences. The scan cuts it: M_1..M_{T-1}
// fall into C chunks of L matrices, chunk c holding M_{1+cL}..M_{min(cL+L,
// T-1)}, with transfer matrix P_c, their product. Then
//   alpha_{cL} = alpha_0 (x) P_0 (x) ... (x) P_{c-1},
//   beta_{cL}  = P_c (x) ... (x) P_{C-1} (x) beta_{T-1},
// so one product serves both directions. Three launches:
//  1. (parallel over sequences and chunks) P_c, row i being the forward
//     recursion over the chunk started from state i alone: lane (row,
//     state) of a warp, 32 / K rows a warp, up to 4 warps a CTA. Each row
//     is max-normalised before every step, its offset summed apart, so
//     that the stored P'_c (max 0 a row) and the offsets stay small
//     numbers in float32.
//  2. (a warp a sequence and direction, serial over chunks) the start
//     vectors alpha_{cL} and the end vectors beta_{min(cL+L, T-1)}: C steps
//     of one K-wide log-sum-exp a lane against a column (row) of P'_c.
//  3. (a CTA of two warps a sequence and chunk, parallel) each chunk's
//     frames rerun from its start vector with the original recursion,
//     writing log_alpha and log_beta.
// Where T - 1 <= L there is one chunk: passes 1 and 2 write only the start
// vectors, and pass 3 is the plain chain. The chunk starts round
// differently from the one chain (its products are summed in another
// order), within float32's rounding of the recursions.
//
// Within every chain: lane j owns state j (K <= 32, a template parameter,
// one instantiation each); a step reads the K values it needs by
// __shfl_sync, adds its column (row) of log_a kept in registers, takes the
// max and the sum of expf as trees and one logf; the next step's log_b is
// loaded a step ahead. Lanes past the states mirror a valid one and store
// nothing.
//
// Chunk length. L = ceil(sqrt((T-1) / 2)), at least 32, balances the
// chunks' chains (passes 1 and 3, L steps each) against the carry (pass 2,
// (T-1) / L steps).
//
// Chunk or not. Pass 1 runs K rows of the recursion over every frame, so
// the scan does ~(K + 2) / 2 times the serial chain's work, and where N
// and K are large that work, not the chain, sets the time. Timed on an
// NVIDIA H100 80GB HBM3 at 700 W (scripts/torch_hmm_plan.py, both routes
// at N 1-128, K 2-32, T 1,000-45,000): the scan costs ~2.35 ns of an SM
// for each frame, sequence, state and warp of passes 1 and 3 (WPC + 2
// warps a chunk), N T (WPC + 2) K 2.35 ns / SMs in all, and the serial
// chain ~(120 + 10 K) ns a frame whatever N. `chunked` takes the scan
// where its cost is the smaller: on 132 SMs N <= 22 at K 32, 30 at K 25,
// 40 at K 20, 98 at K 16, 205 at K 10. The measured break-even lies at or
// above each of these (N ~25 at K 32, ~31 at K 25, ~57 at K 20).
//
// Bound on this card. log_b is read once and the outputs are two (N, T, K)
// tensors: 12NTK bytes, ~9.7 MB at (3, 26,976, 10), ~3 us at 3.35 TB/s.
// The function's own operations are ~5K a state-step for each recursion,
// 2NTK(5K + 2): ~0.2 GFLOP there, ~3 us at 67 TFLOP/s. The chunk
// products add ~7K^2 a state-step (K rows, each normalised), the scan's
// own work, not the function's. What holds the scan above either is each
// pass's chain of dependent log-sum-exps (a round of shuffles, a
// log2(K)-deep max, the exponentials, a log2(K)-deep sum, a log), L + L +
// C steps in all, and pass 1's K-fold work where N K is large.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxStates = 32;
constexpr int kMinChunk = 32;
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

// The tree max of K values, 0 where it is not finite (lse's shift).
template <int K>
__device__ __forceinline__ float shift_of(const float (&v)[K]) {
    float w[K];
#pragma unroll
    for (int i = 0; i < K; ++i) w[i] = v[i];
#pragma unroll
    for (int s = 1; s < K; s *= 2)
#pragma unroll
        for (int i = 0; i + s < K; i += 2 * s) w[i] = fmaxf(w[i], w[i + s]);
    return isfinite(w[0]) ? w[0] : 0.0f;
}

struct Chunks {
    int L, C;
};

// Whether N sequences of K states take the chunked scan (else one chunk:
// the serial chain): the cost model of the note above, in units of 0.01 ns.
__host__ __device__ __forceinline__ bool chunked(int n, int k, int sms) {
    const int rpw = 32 / k, wpc = (k + rpw - 1) / rpw;  // RowPlan<K>'s RPW and WPC
    return (long long)n * (wpc + 2) * k * 235 <= (long long)sms * (12000 + 1000 * k);
}

__host__ __device__ __forceinline__ Chunks chunks(int n, int t_len, int k, int sms) {
    Chunks ch;
    const int steps = t_len - 1;  // the matrices M_1..M_{T-1}
    ch.L = steps > 0 ? steps : 1;
    if (steps > 0 && chunked(n, k, sms)) {
        const int L = (int)ceil(sqrt(steps / 2.0));
        ch.L = L < kMinChunk ? kMinChunk : L;
        ch.L = ch.L < steps ? ch.L : steps;
    }
    ch.C = steps > 0 ? (steps + ch.L - 1) / ch.L : 1;
    return ch;
}

// Scratch, in floats: P'_c (N, C, K, K), its row offsets (N, C, K), the
// forward start vectors alpha_{cL} (N, C, K), the backward end vectors
// (N, C + 1, K).
struct Scratch {
    float *pn, *off, *start, *end;
};

__host__ __device__ __forceinline__ size_t scratch_floats(int n, int k, int c) {
    return (size_t)n * ((size_t)c * (k * k + 2 * k) + (size_t)(c + 1) * k);
}

__host__ __device__ __forceinline__ Scratch carve(float* base, int n, int k, int c) {
    Scratch s;
    s.pn = base;
    s.off = s.pn + (size_t)n * c * k * k;
    s.start = s.off + (size_t)n * c * k;
    s.end = s.start + (size_t)n * c * k;
    return s;
}

// Pass 1's CTAs: RPW rows a warp, CW warps a CTA, GROUPS CTAs a chunk.
template <int K>
struct RowPlan {
    static constexpr int RPW = 32 / K;
    static constexpr int WPC = (K + RPW - 1) / RPW;  // warps a chunk
    static constexpr int CW = WPC < 4 ? WPC : 4;
    static constexpr int GROUPS = (WPC + CW - 1) / CW;
};

// Pass 1: rows of chunk blockIdx.y / GROUPS of sequence blockIdx.x. Lane
// (il, j) of warp w carries state j of row i = (group CW + w) RPW + il.
template <int K>
__global__ void __launch_bounds__(128) hmm_chunk_products(
    const float* __restrict__ log_b, const float* __restrict__ log_a, float* scratch, int n, int t_len, int L, int C) {
    if (C < 2) return;  // one chunk: no product is needed
    using RP = RowPlan<K>;
    const Scratch sc = carve(scratch, n, K, C);
    const int seq = blockIdx.x, c = blockIdx.y / RP::GROUPS, group = blockIdx.y % RP::GROUPS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const bool lane_ok = lane < RP::RPW * K;
    const int il = lane_ok ? lane / K : 0;
    const int j = lane_ok ? lane % K : 0;
    const int row = (group * RP::CW + warp) * RP::RPW + il;
    const bool own = lane_ok && row < K;
    const int i = row < K ? row : K - 1;  // rows past K mirror the last and store nothing
    const int lo = 1 + c * L;
    const int hi = min(lo + L, t_len);
    const float* lb = log_b + (size_t)seq * t_len * K;
    float a[K];  // column j of log_a
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = log_a[k * K + j];
    float val = log_a[i * K + j] + lb[(size_t)lo * K + j];
    float off = 0.0f;
    float next_b = lo + 1 < hi ? lb[(size_t)(lo + 1) * K + j] : 0.0f;
    float v[K];
    for (int t = lo + 1; t < hi; ++t) {
        const float cur_b = next_b;
        if (t + 1 < hi) next_b = lb[(size_t)(t + 1) * K + j];
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = __shfl_sync(kFull, val, il * K + k);
        const float m = shift_of<K>(v);
        off += m;
#pragma unroll
        for (int k = 0; k < K; ++k) v[k] = (v[k] - m) + a[k];
        val = cur_b + lse<K>(v);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = __shfl_sync(kFull, val, il * K + k);
    const float m = shift_of<K>(v);
    if (own) {
        const size_t pc = (size_t)seq * C + c;
        sc.pn[(pc * K + i) * K + j] = val - m;
        if (j == 0) sc.off[pc * K + i] = off + m;
    }
}

// Pass 2: sequence blockIdx.x; warp 0 carries alpha over the chunks, warp 1
// beta back over them.
template <int K>
__global__ void __launch_bounds__(64) hmm_chunk_carry(
    const float* __restrict__ log_b, const float* __restrict__ log_pi, float* scratch, int n, int t_len, int C) {
    const Scratch sc = carve(scratch, n, K, C);
    const int seq = blockIdx.x;
    const int lane = threadIdx.x & 31;
    const bool own = lane < K;
    const int j = own ? lane : 0;
    const size_t pc0 = (size_t)seq * C;
    float v[K], p[K], np[K];
    if (threadIdx.x < 32) {
        float s = log_pi[j] + log_b[(size_t)seq * t_len * K + j];
        if (own) sc.start[pc0 * K + j] = s;
        if (C > 1) {
#pragma unroll
            for (int i = 0; i < K; ++i) np[i] = sc.pn[(pc0 * K + i) * K + j];  // column j of P'_0
        }
        float noff = C > 1 ? sc.off[pc0 * K + j] : 0.0f;
        for (int c = 0; c + 1 < C; ++c) {
#pragma unroll
            for (int i = 0; i < K; ++i) p[i] = np[i];
            const float w = s + noff;  // alpha_{cL}[j] + the offset of row j
            if (c + 2 < C) {
#pragma unroll
                for (int i = 0; i < K; ++i) np[i] = sc.pn[((pc0 + c + 1) * K + i) * K + j];
                noff = sc.off[(pc0 + c + 1) * K + j];
            }
#pragma unroll
            for (int i = 0; i < K; ++i) v[i] = __shfl_sync(kFull, w, i) + p[i];
            s = lse<K>(v);
            if (own) sc.start[(pc0 + c + 1) * K + j] = s;
        }
    } else {
        float e = 0.0f;  // beta_{T-1}
        if (own) sc.end[((size_t)seq * (C + 1) + C) * K + j] = 0.0f;
        if (C > 1) {
#pragma unroll
            for (int i = 0; i < K; ++i) np[i] = sc.pn[((pc0 + C - 1) * K + j) * K + i];  // row j of P'_{C-1}
        }
        float noff = C > 1 ? sc.off[(pc0 + C - 1) * K + j] : 0.0f;
        for (int c = C - 1; c >= 1; --c) {
#pragma unroll
            for (int i = 0; i < K; ++i) p[i] = np[i];
            const float off = noff;
            if (c - 1 >= 1) {
#pragma unroll
                for (int i = 0; i < K; ++i) np[i] = sc.pn[((pc0 + c - 1) * K + j) * K + i];
                noff = sc.off[(pc0 + c - 1) * K + j];
            }
#pragma unroll
            for (int i = 0; i < K; ++i) v[i] = p[i] + __shfl_sync(kFull, e, i);
            e = off + lse<K>(v);
            if (own) sc.end[((size_t)seq * (C + 1) + c) * K + j] = e;
        }
    }
}

// Pass 3: chunk blockIdx.y of sequence blockIdx.x; warp 0 writes its
// alphas, warp 1 its betas, each from the vector pass 2 left.
template <int K>
__global__ void __launch_bounds__(64) hmm_chunk_rerun(
    const float* __restrict__ log_b, const float* __restrict__ log_a, float* __restrict__ log_alpha,
    float* __restrict__ log_beta, const float* scratch, int n, int t_len, int L, int C) {
    const Scratch sc = carve(const_cast<float*>(scratch), n, K, C);
    const int seq = blockIdx.x, c = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const bool forward = threadIdx.x < 32;
    const bool own = lane < K;
    const int j = own ? lane : 0;  // lanes past K mirror state 0 and store nothing
    const size_t base = (size_t)seq * (size_t)t_len * K;
    const float* lb = log_b + base;
    float v[K];
    float a[K];  // column j of log_a (forward) or row j (backward)
#pragma unroll
    for (int i = 0; i < K; ++i) a[i] = forward ? log_a[i * K + j] : log_a[j * K + i];

    if (forward) {
        float* out = log_alpha + base;
        const int lo = 1 + c * L, hi = min(lo + L, t_len);
        float prev = sc.start[((size_t)seq * C + c) * K + j];
        if (c == 0 && own) out[j] = prev;
        float next_b = lo < hi ? lb[(size_t)lo * K + j] : 0.0f;
        for (int t = lo; t < hi; ++t) {
            const float cur_b = next_b;
            if (t + 1 < hi) next_b = lb[(size_t)(t + 1) * K + j];
#pragma unroll
            for (int i = 0; i < K; ++i) v[i] = __shfl_sync(kFull, prev, i) + a[i];
            prev = cur_b + lse<K>(v);
            if (own) out[(size_t)t * K + j] = prev;
        }
    } else {
        float* out = log_beta + base;
        const int top = min(c * L + L, t_len - 1);  // beta_top is the chunk's end vector
        float beta = sc.end[((size_t)seq * (C + 1) + c + 1) * K + j];
        if (c == C - 1 && own) out[(size_t)(t_len - 1) * K + j] = 0.0f;
        float next_b = top >= 1 ? lb[(size_t)top * K + j] : 0.0f;
        for (int t = top - 1; t >= c * L; --t) {
            const float w = next_b + beta;  // log_b[t+1, j] + log_beta[t+1, j]
            next_b = lb[(size_t)t * K + j];
#pragma unroll
            for (int i = 0; i < K; ++i) v[i] = a[i] + __shfl_sync(kFull, w, i);
            beta = lse<K>(v);
            if (own) out[(size_t)t * K + j] = beta;
        }
    }
}

int sm_count(int* sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    return (int)err;
}

template <int K>
int launch_k(const float* log_b, const float* log_pi, const float* log_a, float* log_alpha, float* log_beta,
             float* scratch, int n, int t_len, int k, Chunks ch, cudaStream_t stream) {
    if (k != K) return launch_k<K - 1>(log_b, log_pi, log_a, log_alpha, log_beta, scratch, n, t_len, k, ch, stream);
    using RP = RowPlan<K>;
    hmm_chunk_products<K><<<dim3(n, ch.C * RP::GROUPS), 32 * RP::CW, 0, stream>>>(log_b, log_a, scratch, n, t_len,
                                                                                ch.L, ch.C);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    hmm_chunk_carry<K><<<n, 64, 0, stream>>>(log_b, log_pi, scratch, n, t_len, ch.C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    hmm_chunk_rerun<K><<<dim3(n, ch.C), 64, 0, stream>>>(log_b, log_a, log_alpha, log_beta, scratch, n, t_len, ch.L, ch.C);
    return (int)cudaGetLastError();
}

template <>
int launch_k<0>(const float*, const float*, const float*, float*, float*, float*, int, int, int, Chunks, cudaStream_t) {
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// The scan's plan on the current device: info = {chunk length L, chunks C,
// scratch floats}. Returns a CUDA error code.
extern "C" int hmm_scan_config(int n, int t_len, int k, long long* info) {
    if (n <= 0 || t_len <= 0 || k < 1 || k > kMaxStates) return (int)cudaErrorInvalidValue;
    int sms = 0;
    const int err = sm_count(&sms);
    if (err != 0) return err;
    const Chunks ch = chunks(n, t_len, k, sms);
    info[0] = ch.L;
    info[1] = ch.C;
    info[2] = (long long)scratch_floats(n, k, ch.C);
    return 0;
}

// log_b (n, t_len, k), log_pi (k,), log_a (k, k) -> log_alpha, log_beta
// (n, t_len, k); float32, contiguous, on the stream's device; `scratch`
// holds the floats hmm_scan_config reports. Three launches, no
// synchronisation. Returns the CUDA error of the launches (0 when they
// were taken).
extern "C" int hmm_scan_launch(const float* log_b, const float* log_pi, const float* log_a, float* log_alpha,
                               float* log_beta, float* scratch, int n, int t_len, int k, void* stream) {
    if (n <= 0 || t_len <= 0) return 0;
    if (k < 1 || k > kMaxStates) return (int)cudaErrorInvalidValue;
    int sms = 0;
    const int err = sm_count(&sms);
    if (err != 0) return err;
    return launch_k<kMaxStates>(log_b, log_pi, log_a, log_alpha, log_beta, scratch, n, t_len, k,
                                chunks(n, t_len, k, sms), (cudaStream_t)stream);
}
