// Kalman filter + Rauch-Tung-Striebel smoother of every channel of a (T, C)
// float32 block, for Hopper (sm_90a): the serial part of full imputation,
// as a chunked parallel-in-time scan.
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
// and the output is x_s[:, 0]. Every operation of the chains rounds as
// XLA's CPU program of the JAX scan does, written out with the
// round-to-nearest intrinsics (the compiler contracts nothing else): its
// 2 x 2 products as fma(a_i1, b_1j, a_i0 b_0j), a - b c as fma(-b, c, a),
// a + b c as fma(b, c, a). On this model's first steps (P0 = 1000) inv2
// cancels badly, so any other rounding of the gains moves the output by
// ~1e-3; with these the plain version (ops/kalman_kernels.py) equals the
// JAX scan bit for bit on the CPU.
//
// The gains, from the covariance chain's period. The covariances and both
// gains do not depend on the data, and the float32 chain of filter
// covariances revisits a state within a few dozen steps (on this model
// P_filt[28] has the bits of P_filt[26]): a deterministic recursion that
// revisits a state repeats from there with that period, so every later
// row of the gains is a copy of a row inside the first period. A warp
// (kalman_period) runs the chain: lane 0 takes 32 steps (two divisions
// each), then each lane compares one of their states with the kHistory
// before it, bit for bit, and the first repeat ends the chain (at step 28
// here: one block); it writes the rows it reached and (first, lag), and
// without a repeat it runs to T, as the chain always did. Comparing in
// parallel, between blocks, keeps the comparisons off the chain. A thread
// a step (kalman_fill) then writes row t of the (T, 8) gains, C_t in
// floats 0-3 and k_t in floats 4-5, from the rows of the state equal to
// P_filt[t] (and P_filt[t-1]), with the chain's own operations: the same
// bits as a chain run to T.
//
// The filter and the smoother, chunked. Given the gains, a filter step is
// the affine map x <- A_t x + k_t z_t, A_t = (I - k_t e0^T) F, and a
// smoother step x <- C_t x + (x_f - C_t F x_f). Past the transient both
// matrices have eigenvalues 0.620 +- 0.263i (modulus 0.674 a step), so
// each map forgets its start fast. The T - 1 steps of each pass fall into
// n chunks of L (filter chunk c: steps 1 + cL .. min(cL + L, T - 1), from
// x_filt[cL]; smoother chunk c: steps min(cL + L, T - 1) - 1 .. cL, from
// x_s[min(cL + L, T - 1)]). Each pass is three launches:
//  1. offsets (parallel over channels x chunks): each chunk walked from a
//     zero start with the serial step, which gives the affine offset of
//     the chunk's map; one more CTA a chunk forms the chunk's 2 x 2
//     transfer matrix (the product of its A_t or C_t, once for every
//     channel), each lane of a warp multiplying a run of the chunk's
//     steps, a tree of shuffles the lanes' products;
//  2. carry (a warp a channel): the start of every chunk, x <- M_c x + o_c
//     over the chunks from x_filt[0] = (z_0, z_0) forward and from
//     x_filt[T-1] backward, as a scan: each lane composes the affine maps
//     of a run of chunks, a shuffle scan composes the runs before it, and
//     each lane walks its run from there;
//  3. rerun (parallel over channels x chunks): each chunk walked from its
//     start with the serial step's exact arithmetic, writing x_filt (the
//     filter) or the smoothed positions (the smoother).
// A rerun differs from the one serial chain only through its start, whose
// few ulp of difference the contraction shrinks by 0.674 a step. No
// atomics: two calls give equal bits. Where T - 1 <= L there is one chunk
// and the reruns alone run: the serial chain. The chunk products shrink
// like 0.674^L (~5e-17 at L 95, ~1e-33 at L 190) and may underflow to
// zero, harmlessly.
//
// A walk is a chain of dependent steps whose loads do not depend on it: a
// CTA stages its chunk's gains (k_t or C_t, the same for every channel) in
// shared memory first, and each thread loads its z (or x_filt) a tile of
// 32 steps ahead of the tile it steps through, so that the loads' latency
// hides behind the chain; the map lanes load a tile of 8 steps, the carry
// lanes 16 chunks, before stepping through them.
//
// Bound on this card. The function reads z once and writes the output
// once: 8 T C bytes, ~10 MB at (45,000, 28), ~3 us at 3.35 TB/s; its ~20
// FP32 operations a channel-step are fewer still. The algorithm moves
// more: z read twice, x_filt (8 T C bytes) written once and read twice,
// the gains written once and read four times, ~36 T C + 80 T bytes (~14 us
// there at 3.35 TB/s). Neither binds: what sets the time is the chains of
// dependent steps, 32 of the covariances, then ~2 (L + L) a channel
// (offsets and rerun of each pass, the carry's scan ~2 n / 32 + 5 more),
// ~440 at (45,000, 28) with L 95 instead of the 2 T = 90,000 of one
// thread a channel, each step's latency (a tile's loads and the
// shared-memory gains partly exposed), and eight launches, each a few us
// from launch to its last CTA's end however little it does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHistory = 8;     // filter covariances compared for a repeat
constexpr int kPeriodBlock = 32;  // covariance steps between two comparisons
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFillThreads = 256;
constexpr int kCarryThreads = 128;  // 4 channels a CTA, a warp each
constexpr int kMaxChunkThreads = 128;
constexpr int kFwdTile = 32;    // filter steps a tile: z of this tile and the next in registers
constexpr int kBwdTile = 32;    // smoother steps a tile: x_filt of this tile and the next
constexpr int kMapTile = 8;     // a map lane's steps a tile
constexpr int kCarryTile = 16;  // a carry lane's chunk maps a tile
constexpr int kMaxChunk = 2048;    // steps a chunk: its C_t fill 32 KB of shared memory
constexpr int kMaxChunks = 65535;  // gridDim.y

__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rn_fma(float a, float b, float c) { return __fmaf_rn(a, b, c); }

__device__ __forceinline__ bool same_bits(float4 a, float4 b) {
    return __float_as_uint(a.x) == __float_as_uint(b.x) && __float_as_uint(a.y) == __float_as_uint(b.y) &&
           __float_as_uint(a.z) == __float_as_uint(b.z) && __float_as_uint(a.w) == __float_as_uint(b.w);
}

// The chain of filter covariances, a warp: lane 0 runs the chain a block of
// kPeriodBlock steps at a time, storing cov[t] = (P_pred[t], P_filt[t])
// row-major and P_filt[t] in shared memory; then lane i compares the
// block's state i with the kHistory states before it, bit for bit, and
// the first repeat in the block ends the chain. period = (first, lag):
// P_filt[first + lag] has the bits of P_filt[first] (lag 0 and first = T:
// no repeat within T). The rows past the repeat that its block computed
// are written too; nothing reads them.
__global__ void __launch_bounds__(kWarp) kalman_period(float* __restrict__ cov, int* __restrict__ period,
                                                       int t_len) {
    __shared__ float4 states[kHistory + kPeriodBlock];  // P_filt[base - kHistory .. base + kPeriodBlock - 1]
    const float q00 = 0.0025f, q01 = 0.005f, q11 = 0.01f;  // float32 of [[0.25, 0.5], [0.5, 1]] x 0.01
    const float r = 0.1f;
    const int lane = threadIdx.x;
    float4 f = make_float4(1000.0f, 0.0f, 0.0f, 1000.0f);  // P_filt[0] = P0
    if (lane == 0) {
        reinterpret_cast<float4*>(cov)[1] = f;
        states[kHistory - 1] = f;
    }
    int first = t_len, lag = 0;
    for (int base = 1; base < t_len; base += kPeriodBlock) {
        const int end = min(base + kPeriodBlock, t_len);
        if (lane == 0) {
            for (int t = base; t < end; ++t) {
                // F P: [[P00 + P10, P01 + P11], [P10, P11]]; (F P) F^T adds its columns.
                const float a00 = rn_add(f.x, f.z), a01 = rn_add(f.y, f.w);
                const float p00 = rn_add(rn_add(a00, a01), q00), p01 = rn_add(a01, q01);
                const float p10 = rn_add(rn_add(f.z, f.w), q01), p11 = rn_add(f.w, q11);
                const float s = rn_add(p00, r);
                const float k0 = rn_div(p00, s), k1 = rn_div(p10, s);
                f = make_float4(rn_fma(-k0, p00, p00), rn_fma(-k0, p01, p01), rn_fma(-k1, p00, p10),
                                rn_fma(-k1, p01, p11));
                float4* row = reinterpret_cast<float4*>(cov + (size_t)t * 8);
                row[0] = make_float4(p00, p01, p10, p11);
                row[1] = f;
                states[kHistory + t - base] = f;
            }
        }
        __syncwarp();
        const int t = base + lane;
        int hit = 0;
        if (t < end) {
            const float4 mine = states[kHistory + lane];
            for (int g = 1; g <= kHistory && t - g >= 0; ++g) {
                if (same_bits(mine, states[kHistory + lane - g])) {
                    hit = g;
                    break;
                }
            }
        }
        const unsigned hits = __ballot_sync(kFull, hit != 0);
        if (hits != 0) {
            const int i = __ffs(hits) - 1;
            lag = __shfl_sync(kFull, hit, i);
            first = base + i - lag;
            break;
        }
        if (lane < kHistory) states[lane] = states[kPeriodBlock + lane];  // the block's last kHistory states
        __syncwarp();
    }
    if (lane == 0) {
        period[0] = first;
        period[1] = lag;
    }
}

// The row of cov whose P_filt has the bits of P_filt[u].
__device__ __forceinline__ int filt_row(int u, int first, int lag) {
    return u < first ? u : first + (u - first) % lag;
}

// Row t of the gains: C_t = (P_filt[t] F^T) inv2(P_pred[t+1]) in floats
// 0-3 (t <= T-2), k_t from P_pred[t] in floats 4-5 (t >= 1), each from
// the rows of the chain that hold the same states.
__global__ void __launch_bounds__(kFillThreads) kalman_fill(
    const float* __restrict__ cov, const int* __restrict__ period, float* __restrict__ gains, int t_len) {
    const int t = blockIdx.x * kFillThreads + threadIdx.x;
    if (t >= t_len) return;
    const int first = period[0], lag = period[1];
    float4 c = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float2 k = make_float2(0.0f, 0.0f);
    if (t + 1 < t_len) {
        const int i = filt_row(t, first, lag);
        const float4 f = *reinterpret_cast<const float4*>(cov + (size_t)i * 8 + 4);
        const float4 p = *reinterpret_cast<const float4*>(cov + (size_t)(i + 1) * 8);
        const float b00 = rn_add(f.x, f.y), b01 = f.y, b10 = rn_add(f.z, f.w), b11 = f.w;
        const float det = rn_fma(p.x, p.w, -rn_mul(p.y, p.z));
        const float i00 = rn_div(p.w, det), i01 = rn_div(-p.y, det), i10 = rn_div(-p.z, det),
                    i11 = rn_div(p.x, det);
        c = make_float4(rn_fma(b01, i10, rn_mul(b00, i00)), rn_fma(b01, i11, rn_mul(b00, i01)),
                        rn_fma(b11, i10, rn_mul(b10, i00)), rn_fma(b11, i11, rn_mul(b10, i01)));
    }
    if (t >= 1) {
        const int i = filt_row(t - 1, first, lag);
        const float4 p = *reinterpret_cast<const float4*>(cov + (size_t)(i + 1) * 8);
        const float s = rn_add(p.x, 0.1f);
        k = make_float2(rn_div(p.x, s), rn_div(p.z, s));
    }
    float4* row = reinterpret_cast<float4*>(gains + (size_t)t * 8);
    row[0] = c;
    row[1] = make_float4(k.x, k.y, 0.0f, 0.0f);
}

// The serial filter step and smoother step, with the JAX scan's rounding.
__device__ __forceinline__ void filter_step(float& x0, float& x1, float z, float2 k) {
    const float xp0 = rn_add(x0, x1);  // F x
    const float innov = rn_sub(z, xp0);
    x0 = rn_fma(k.x, innov, xp0);
    x1 = rn_fma(k.y, innov, x1);
}

__device__ __forceinline__ void smoother_step(float& x0, float& x1, float2 xf, float4 g) {
    // x_s[t+1] - F x_filt[t]
    const float d0 = rn_sub(x0, rn_add(xf.x, xf.y)), d1 = rn_sub(x1, xf.y);
    x0 = rn_add(xf.x, rn_fma(g.y, d1, rn_mul(g.x, d0)));
    x1 = rn_add(xf.y, rn_fma(g.w, d1, rn_mul(g.z, d0)));
}

// 2 x 2 matrices as float4 (m00, m01, m10, m11) and the affine maps of the
// chunks; their rounding is the scan's own (the reruns repeat the chain's).
__device__ __forceinline__ float4 mat_mul(float4 a, float4 b) {
    return make_float4(fmaf(a.y, b.z, a.x * b.x), fmaf(a.y, b.w, a.x * b.y), fmaf(a.w, b.z, a.z * b.x),
                       fmaf(a.w, b.w, a.z * b.y));
}

__device__ __forceinline__ float2 mat_vec_add(float4 a, float2 x, float2 o) {  // a x + o
    return make_float2(fmaf(a.y, x.y, fmaf(a.x, x.x, o.x)), fmaf(a.w, x.y, fmaf(a.z, x.x, o.y)));
}

__device__ __forceinline__ float4 shfl_down4(float4 v, int s) {
    return make_float4(__shfl_down_sync(kFull, v.x, s), __shfl_down_sync(kFull, v.y, s),
                       __shfl_down_sync(kFull, v.z, s), __shfl_down_sync(kFull, v.w, s));
}

__device__ __forceinline__ float4 shfl_up4(float4 v, int s) {
    return make_float4(__shfl_up_sync(kFull, v.x, s), __shfl_up_sync(kFull, v.y, s), __shfl_up_sync(kFull, v.z, s),
                       __shfl_up_sync(kFull, v.w, s));
}

__device__ __forceinline__ float2 shfl_up2(float2 v, int s) {
    return make_float2(__shfl_up_sync(kFull, v.x, s), __shfl_up_sync(kFull, v.y, s));
}

// A filter step's matrix A_t = (I - k e0^T) F = [[1 - k0, 1 - k0], [-k1, 1 - k1]].
__device__ __forceinline__ float4 filter_matrix(float2 k) {
    const float a = 1.0f - k.x;
    return make_float4(a, a, -k.y, 1.0f - k.y);
}

// The transfer matrix of a chunk's steps [lo, hi), by warp 0 of the CTA:
// the filter's A_{hi-1} .. A_lo, the smoother's C_lo .. C_{hi-1}. Each
// lane multiplies a run of ceil((hi - lo) / 32) steps, then a tree of
// shuffles multiplies the lanes' products in order.
template <bool kFilter>
__device__ __forceinline__ void chunk_map(const float* __restrict__ gains, int lo, int hi, float4* dst) {
    const int lane = threadIdx.x;
    const int per = (hi - lo + kWarp - 1) / kWarp;
    const int a = min(lo + lane * per, hi), b = min(a + per, hi);
    float4 p = make_float4(1.0f, 0.0f, 0.0f, 1.0f);
    for (int base = a; base < b; base += kMapTile) {
        float4 m[kMapTile];
#pragma unroll
        for (int i = 0; i < kMapTile; ++i) {
            const int t = base + i < b ? base + i : a;
            m[i] = kFilter ? filter_matrix(*reinterpret_cast<const float2*>(gains + (size_t)t * 8 + 4))
                           : *reinterpret_cast<const float4*>(gains + (size_t)t * 8);
        }
#pragma unroll
        for (int i = 0; i < kMapTile; ++i)
            if (base + i < b) p = kFilter ? mat_mul(m[i], p) : mat_mul(p, m[i]);
    }
#pragma unroll
    for (int s = 1; s < kWarp; s *= 2) {
        const float4 q = shfl_down4(p, s);
        if ((lane & (2 * s - 1)) == 0) p = kFilter ? mat_mul(q, p) : mat_mul(p, q);
    }
    if (lane == 0) *dst = p;
}

struct Grid {
    int threads, blocks_x;  // a chunk's channels: blocks_x CTAs of `threads`
};

__host__ __forceinline__ Grid channel_grid(int channels) {
    Grid g;
    g.threads = ((channels + kWarp - 1) / kWarp) * kWarp;
    g.threads = g.threads < kMaxChunkThreads ? g.threads : kMaxChunkThreads;
    g.blocks_x = (channels + g.threads - 1) / g.threads;
    return g;
}

// The filter's walk over steps [lo, hi) of chunk blockIdx.y, a thread a
// channel, its k_t staged in shared memory and z loaded a tile ahead.
// kRerun: from the chunk's start (chunk 0 from (z_0, z_0)), writing
// x_filt; else from zero, writing the chunk's offset, while the row's
// last CTA forms the chunk's transfer matrix instead.
template <bool kRerun>
__global__ void __launch_bounds__(kMaxChunkThreads) kalman_filter_walk(
    const float* __restrict__ z, const float* __restrict__ gains, float* __restrict__ maps,
    const float2* __restrict__ start, float2* __restrict__ x_filt, float2* __restrict__ off, int t_len,
    int channels, int L) {
    extern __shared__ float2 ks[];  // k_lo .. k_{hi-1}
    const int chunk = blockIdx.y;
    const int lo = 1 + chunk * L, hi = min(lo + L, t_len);
    if (!kRerun && blockIdx.x == gridDim.x - 1) {
        if (threadIdx.x < kWarp) chunk_map<true>(gains, lo, hi, reinterpret_cast<float4*>(maps + (size_t)chunk * 8));
        return;
    }
    // The start and the first tile are loaded before the gains are staged,
    // so that the loads' latencies overlap.
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const bool own = c < channels;
    float cur[kFwdTile];
#pragma unroll
    for (int i = 0; i < kFwdTile; ++i) cur[i] = own && lo + i < hi ? z[(size_t)(lo + i) * channels + c] : 0.0f;
    float x0 = 0.0f, x1 = 0.0f;
    if (kRerun && own) {
        if (chunk == 0) {
            x0 = x1 = z[c];
            x_filt[c] = make_float2(x0, x1);
        } else {
            const float2 s = start[(size_t)chunk * channels + c];
            x0 = s.x, x1 = s.y;
        }
    }
    for (int i = threadIdx.x; i < hi - lo; i += blockDim.x)
        ks[i] = *reinterpret_cast<const float2*>(gains + (size_t)(lo + i) * 8 + 4);
    __syncthreads();
    if (!own) return;
    for (int base = lo; base < hi; base += kFwdTile) {
        float next[kFwdTile];
#pragma unroll
        for (int i = 0; i < kFwdTile; ++i) {
            const int t = base + kFwdTile + i;
            next[i] = t < hi ? z[(size_t)t * channels + c] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kFwdTile; ++i) {
            const int t = base + i;
            if (t < hi) {
                filter_step(x0, x1, cur[i], ks[t - lo]);
                if (kRerun) x_filt[(size_t)t * channels + c] = make_float2(x0, x1);
            }
        }
#pragma unroll
        for (int i = 0; i < kFwdTile; ++i) cur[i] = next[i];
    }
    if (!kRerun) off[(size_t)chunk * channels + c] = make_float2(x0, x1);
}

// The smoother's walk over steps top-1 down to lo of chunk blockIdx.y
// (kRerun) or blockIdx.y + 1 (offsets: chunks 1 .. n-1), its C_t staged in
// shared memory and x_filt loaded a tile ahead. kRerun: from the chunk's
// start (the last chunk from x_filt[T-1]), writing the smoothed positions;
// else from zero, writing the chunk's offset, while the row's last CTA
// forms the chunk's transfer matrix instead.
template <bool kRerun>
__global__ void __launch_bounds__(kMaxChunkThreads) kalman_smoother_walk(
    const float* __restrict__ gains, const float2* __restrict__ x_filt, float* __restrict__ maps,
    const float2* __restrict__ start, float* __restrict__ out, float2* __restrict__ off, int t_len, int channels,
    int L, int n) {
    extern __shared__ float4 cs[];  // C_lo .. C_{top-1}
    const int chunk = kRerun ? blockIdx.y : blockIdx.y + 1;
    const int lo = chunk * L, top = min(lo + L, t_len - 1);
    if (!kRerun && blockIdx.x == gridDim.x - 1) {
        if (threadIdx.x < kWarp)
            chunk_map<false>(gains, lo, top, reinterpret_cast<float4*>(maps + (size_t)chunk * 8 + 4));
        return;
    }
    // The start and the first tile are loaded before the gains are staged,
    // so that the loads' latencies overlap.
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const bool own = c < channels;
    float x0 = 0.0f, x1 = 0.0f;
    if (kRerun && own) {
        const float2 s = chunk == n - 1 ? x_filt[(size_t)(t_len - 1) * channels + c]
                                        : start[(size_t)chunk * channels + c];
        x0 = s.x, x1 = s.y;
        if (chunk == n - 1) out[(size_t)(t_len - 1) * channels + c] = x0;
    }
    float2 cur[kBwdTile];
#pragma unroll
    for (int i = 0; i < kBwdTile; ++i)
        cur[i] = own && top - 1 - i >= lo ? x_filt[(size_t)(top - 1 - i) * channels + c] : make_float2(0.0f, 0.0f);
    for (int i = threadIdx.x; i < top - lo; i += blockDim.x)
        cs[i] = *reinterpret_cast<const float4*>(gains + (size_t)(lo + i) * 8);
    __syncthreads();
    if (!own) return;
    for (int base = top - 1; base >= lo; base -= kBwdTile) {
        float2 next[kBwdTile];
#pragma unroll
        for (int i = 0; i < kBwdTile; ++i) {
            const int t = base - kBwdTile - i;
            next[i] = t >= lo ? x_filt[(size_t)t * channels + c] : make_float2(0.0f, 0.0f);
        }
#pragma unroll
        for (int i = 0; i < kBwdTile; ++i) {
            const int t = base - i;
            if (t >= lo) {
                smoother_step(x0, x1, cur[i], cs[t - lo]);
                if (kRerun) out[(size_t)t * channels + c] = x0;
            }
        }
#pragma unroll
        for (int i = 0; i < kBwdTile; ++i) cur[i] = next[i];
    }
    if (!kRerun) off[(size_t)chunk * channels + c] = make_float2(x0, x1);
}

// Pass 2, a warp a channel: the chunk starts, x <- M_j x + o_j over the
// n - 1 chunk maps in order (the filter: j = 0 .. n-2 from (z_0, z_0),
// writing the start of chunk j + 1; the smoother: j = n-1 .. 1 from
// x_filt[T-1], writing the start of chunk j - 1). Each lane composes the
// maps of a run of ceil((n - 1) / 32) steps, a shuffle scan composes the
// runs before each lane's, and each lane walks its run from there.
template <bool kFilter>
__global__ void __launch_bounds__(kCarryThreads) kalman_carry(
    const float* __restrict__ z, const float2* __restrict__ x_filt, const float* __restrict__ maps,
    const float2* __restrict__ off, float2* __restrict__ start, int t_len, int channels, int n) {
    const int c = (blockIdx.x * kCarryThreads + threadIdx.x) / kWarp;
    const int lane = threadIdx.x % kWarp;
    if (c >= channels) return;  // whole warps
    const int steps = n - 1, per = (steps + kWarp - 1) / kWarp;
    const int a = min(lane * per, steps), b = min(a + per, steps);
    const int map_at = kFilter ? 0 : 4;
    auto chunk_of = [&](int s) { return kFilter ? s : n - 1 - s; };
    float4 g = make_float4(1.0f, 0.0f, 0.0f, 1.0f);
    float2 h = make_float2(0.0f, 0.0f);
    for (int base = a; base < b; base += kCarryTile) {
        float4 m[kCarryTile];
        float2 o[kCarryTile];
#pragma unroll
        for (int i = 0; i < kCarryTile; ++i) {
            const int j = chunk_of(base + i < b ? base + i : a);
            m[i] = *reinterpret_cast<const float4*>(maps + (size_t)j * 8 + map_at);
            o[i] = off[(size_t)j * channels + c];
        }
#pragma unroll
        for (int i = 0; i < kCarryTile; ++i) {
            if (base + i < b) {
                h = mat_vec_add(m[i], h, o[i]);
                g = mat_mul(m[i], g);
            }
        }
    }
#pragma unroll
    for (int s = 1; s < kWarp; s *= 2) {  // inclusive scan: lanes 0 .. lane, the later on the left
        const float4 g2 = shfl_up4(g, s);
        const float2 h2 = shfl_up2(h, s);
        if (lane >= s) {
            h = mat_vec_add(g, h2, h);
            g = mat_mul(g, g2);
        }
    }
    float4 ge = shfl_up4(g, 1);
    float2 he = shfl_up2(h, 1);
    float2 x = kFilter ? make_float2(z[c], z[c]) : x_filt[(size_t)(t_len - 1) * channels + c];
    if (lane > 0) x = mat_vec_add(ge, x, he);
    for (int base = a; base < b; base += kCarryTile) {
        float4 m[kCarryTile];
        float2 o[kCarryTile];
#pragma unroll
        for (int i = 0; i < kCarryTile; ++i) {
            const int j = chunk_of(base + i < b ? base + i : a);
            m[i] = *reinterpret_cast<const float4*>(maps + (size_t)j * 8 + map_at);
            o[i] = off[(size_t)j * channels + c];
        }
#pragma unroll
        for (int i = 0; i < kCarryTile; ++i) {
            if (base + i < b) {
                x = mat_vec_add(m[i], x, o[i]);
                start[(size_t)(kFilter ? chunk_of(base + i) + 1 : chunk_of(base + i) - 1) * channels + c] = x;
            }
        }
    }
}

}  // namespace

// z (t_len, channels) -> out (t_len, channels), float32, contiguous, on the
// stream's device, with chunks of `chunk` <= kMaxChunk steps
// (ops/kalman_kernels.py's kalman_rts_config). Workspaces, float32 unless
// said: cov and gains (t_len, 8), maps (n, 8), x_filt (t_len, channels,
// 2), off and start (n, channels, 2), period 2 ints, n = ceil((t_len - 1)
// / chunk) (1 where t_len = 1). Eight launches (four where n = 1), no
// synchronisation. Returns the CUDA error of the first launch not taken
// (0 when all were).
extern "C" int kalman_rts_launch(const float* z, float* out, float* cov, float* gains, float* maps, float* x_filt,
                                 float* off, float* start, int* period, int t_len, int channels, int chunk,
                                 void* stream) {
    if (t_len <= 0 || channels <= 0) return 0;
    if (chunk <= 0 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
    const int n = t_len > 1 ? (t_len - 1 + chunk - 1) / chunk : 1;
    if (n > kMaxChunks) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    float2* xf = reinterpret_cast<float2*>(x_filt);
    float2* of = reinterpret_cast<float2*>(off);
    float2* st = reinterpret_cast<float2*>(start);
    const Grid g = channel_grid(channels);
    const int carry_blocks = (channels * kWarp + kCarryThreads - 1) / kCarryThreads;
    const size_t k_bytes = (size_t)chunk * sizeof(float2), c_bytes = (size_t)chunk * sizeof(float4);

    kalman_period<<<1, kWarp, 0, s>>>(cov, period, t_len);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    kalman_fill<<<(t_len + kFillThreads - 1) / kFillThreads, kFillThreads, 0, s>>>(cov, period, gains, t_len);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    if (n > 1) {
        kalman_filter_walk<false><<<dim3(g.blocks_x + 1, n - 1), g.threads, k_bytes, s>>>(z, gains, maps, st, xf, of,
                                                                                       t_len, channels, chunk);
        if ((err = (int)cudaGetLastError()) != 0) return err;
        kalman_carry<true><<<carry_blocks, kCarryThreads, 0, s>>>(z, xf, maps, of, st, t_len, channels, n);
        if ((err = (int)cudaGetLastError()) != 0) return err;
    }
    kalman_filter_walk<true><<<dim3(g.blocks_x, n), g.threads, k_bytes, s>>>(z, gains, maps, st, xf, of, t_len,
                                                                           channels, chunk);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    if (n > 1) {
        kalman_smoother_walk<false><<<dim3(g.blocks_x + 1, n - 1), g.threads, c_bytes, s>>>(
            gains, xf, maps, st, out, of, t_len, channels, chunk, n);
        if ((err = (int)cudaGetLastError()) != 0) return err;
        kalman_carry<false><<<carry_blocks, kCarryThreads, 0, s>>>(z, xf, maps, of, st, t_len, channels, n);
        if ((err = (int)cudaGetLastError()) != 0) return err;
    }
    kalman_smoother_walk<true><<<dim3(g.blocks_x, n), g.threads, c_bytes, s>>>(gains, xf, maps, st, out, of, t_len,
                                                                             channels, chunk, n);
    return (int)cudaGetLastError();
}
