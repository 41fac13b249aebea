// The gradient-boosted tree fit's three hot loops, for Hopper (sm_90a):
// per-node histograms, the best split of each node, and the ensemble's raw
// predictions (wrapper: ops/gbm_kernels.py; estimator: gbm.py).
//
// No TPU kernel to translate: the JAX package fits sklearn's
// HistGradientBoostingClassifier on the host (deepof_tpu/posthoc.py:932).
// The port restates it, and these kernels keep sklearn's order of float
// additions, so that a fit gives sklearn's trees and two fits on the card
// give the same bits (float atomics would add in another order every run).
//
// gbm_histograms: for each task (tree, node, slot), the float64 sums of the
// float32 gradients g and hessians h (n, K) and the row count in every
// (feature, bin) of the uint8 bins (F, n), written to pool[slot] (F, 256,
// 3). A row belongs to the node that node_ids[tree, row] names. A CTA is a
// task and 8 features, a warp a feature. The warp walks the rows in chunks
// of 32 in ascending order; lanes of one bin find each other with
// __match_any_sync, and the lowest of them adds the group's values in lane
// order into the warp's bins in shared memory. So each bin's sum is taken
// in ascending row order, as sklearn's _build_histogram takes it. Bound:
// bytes (each node row's bin, g and h read once; the histogram written
// once); the rows of other nodes are skipped a 32-row chunk at a time by
// their node ids.
//
// gbm_best_split: for each task, sklearn's Splitter.find_node_split with
// no monotonic or interaction constraints: every feature's bins scanned left
// to right (missing values right) and, where the feature has missing values,
// right to left (missing values left), the cumulative sums taken in scan
// order, sklearn's continue / break rules on min_samples_leaf and
// min_hessian_to_split, its gain (splitting.pyx _split_gain, no FMA: the
// products and sums round apart as the Cython's do), the first bin of the
// largest gain in scan order, and across features the first of the largest.
// A root task forms its node's sums from feature 0's bins in numpy's
// pairwise order (sklearn sums the histogram with numpy). A CTA is a task
// and 64 features, a thread a feature; each CTA leaves its best in scratch,
// and the task's last CTA to finish (a ticket counter) reduces them in
// feature order, so the result does not depend on which CTA ends last.
// Bound: bytes (one read of the task's histograms).
//
// gbm_predict: a thread a (row, class): the row down every tree of its
// class, iteration by iteration, each leaf value added to the float64 raw
// prediction in that order (sklearn's _raw_predict). NaN goes where the
// split sent missing values, else left iff x <= threshold. Bound: bytes
// (the rows' features and raw predictions, the node records).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kHistWarps = 8;
constexpr int kSplitThreads = 64;
constexpr int kPredictThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRecord = 14;
constexpr int kNode = 5;

__global__ void __launch_bounds__(kHistWarps * 32)
gbm_histograms_kernel(const uint8_t* __restrict__ bins, const float* __restrict__ g, const float* __restrict__ h,
                      const int* __restrict__ node_ids, const int* __restrict__ tasks, double* __restrict__ pool,
                      int n, int nf, int k) {
    __shared__ double sum_g[kHistWarps][kBins];
    __shared__ double sum_h[kHistWarps][kBins];
    __shared__ unsigned int count[kHistWarps][kBins];
    __shared__ float stage_g[kHistWarps][32];
    __shared__ float stage_h[kHistWarps][32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int task = blockIdx.y;
    const int tree = tasks[3 * task], node = tasks[3 * task + 1], slot = tasks[3 * task + 2];
    const int f = blockIdx.x * kHistWarps + warp;
    if (f >= nf) return;  // the whole warp; no CTA-wide barrier follows
    for (int b = lane; b < kBins; b += 32) {
        sum_g[warp][b] = 0.0;
        sum_h[warp][b] = 0.0;
        count[warp][b] = 0u;
    }
    __syncwarp();
    const int* ids = node_ids + (size_t)tree * n;
    const uint8_t* col = bins + (size_t)f * n;
    for (int base = 0; base < n; base += 32) {
        const int row = base + lane;
        const bool valid = row < n && ids[row] == node;
        if (!__ballot_sync(kFull, valid)) continue;
        int b = 0;
        float gv = 0.f, hv = 0.f;
        if (valid) {
            b = col[row];
            gv = g[(size_t)row * k + tree];
            hv = h[(size_t)row * k + tree];
        }
        stage_g[warp][lane] = gv;
        stage_h[warp][lane] = hv;
        const unsigned peers = __match_any_sync(kFull, valid ? (unsigned)b : (unsigned)(kBins + lane));
        __syncwarp();
        if (valid && __ffs(peers) - 1 == lane) {
            double ag = sum_g[warp][b], ah = sum_h[warp][b];
            unsigned m = peers;
            while (m) {
                const int j = __ffs(m) - 1;
                ag += (double)stage_g[warp][j];
                ah += (double)stage_h[warp][j];
                m &= m - 1;
            }
            sum_g[warp][b] = ag;
            sum_h[warp][b] = ah;
            count[warp][b] += __popc(peers);
        }
        __syncwarp();
    }
    double* out = pool + ((size_t)slot * nf + f) * kBins * 3;
    for (int b = lane; b < kBins; b += 32) {
        out[3 * b] = sum_g[warp][b];
        out[3 * b + 1] = sum_h[warp][b];
        out[3 * b + 2] = (double)count[warp][b];
    }
}

__device__ __forceinline__ double node_value(double sum_g, double sum_h, double l2) {
    return __ddiv_rn(-sum_g, __dadd_rn(__dadd_rn(sum_h, l2), 1e-15));
}

__device__ __forceinline__ double split_gain(double gl, double hl, double gr, double hr, double loss_node, double l2) {
    const double gain = __dsub_rn(loss_node, __dmul_rn(gl, node_value(gl, hl, l2)));
    return __dsub_rn(gain, __dmul_rn(gr, node_value(gr, hr, l2)));
}

// numpy's pairwise sum of 256 values at stride 3: halves of 128, each by
// eight accumulators combined ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)).
__device__ double pairwise_256(const double* v) {
    double halves[2];
    for (int half = 0; half < 2; ++half) {
        const double* a = v + half * 128 * 3;
        double r[8];
        for (int j = 0; j < 8; ++j) r[j] = a[3 * j];
        for (int i = 8; i < 128; i += 8)
            for (int j = 0; j < 8; ++j) r[j] = __dadd_rn(r[j], a[3 * (i + j)]);
        halves[half] = __dadd_rn(__dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3])),
                                 __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7])));
    }
    return __dadd_rn(halves[0], halves[1]);
}

// A feature's (or a block's) best split; the doubles a block leaves for
// the task's last block.
struct Best {
    double gain, gl, hl;
    int feature, bin, missing_left;
    unsigned int nl;
};
constexpr int kBestDoubles = 7;

__device__ __forceinline__ bool better(const Best& c, const Best& w) {
    // The first of the largest gain: strict, or equal at a lower feature.
    if (c.feature < 0) return false;
    return w.feature < 0 || c.gain > w.gain || (c.gain == w.gain && c.feature < w.feature);
}

__device__ Best feature_best(const double* hf, int nbnm, bool has_missing, unsigned int n, double sg, double sh,
                             double loss_node, unsigned int msl, double min_hessian, double l2, int f) {
    Best best;
    best.gain = -1.0;
    best.gl = best.hl = 0.0;
    best.feature = f;
    best.bin = 0;
    best.missing_left = 0;
    best.nl = 0u;
    // Left to right; missing values go right.
    const int end = nbnm - 1 + (has_missing ? 1 : 0);
    double gl = 0.0, hl = 0.0;
    unsigned int nl = 0u;
    for (int b = 0; b < end; ++b) {
        nl += (unsigned int)hf[3 * b + 2];
        const unsigned int nr = n - nl;
        hl = __dadd_rn(hl, hf[3 * b + 1]);
        const double hr = __dsub_rn(sh, hl);
        gl = __dadd_rn(gl, hf[3 * b]);
        const double gr = __dsub_rn(sg, gl);
        if (nl < msl) continue;
        if (nr < msl) break;
        if (hl < min_hessian) continue;
        if (hr < min_hessian) break;
        const double gain = split_gain(gl, hl, gr, hr, loss_node, l2);
        if (gain > best.gain && gain > 0.0) {
            best.gain = gain;
            best.bin = b;
            best.missing_left = 0;
            best.gl = gl;
            best.hl = hl;
            best.nl = nl;
        }
    }
    // Right to left; missing values go left.
    if (has_missing && nbnm >= 2) {
        double gr = 0.0, hr = 0.0;
        unsigned int nr = 0u;
        for (int b = nbnm - 2; b >= 0; --b) {
            const double* hb = hf + 3 * (b + 1);
            nr += (unsigned int)hb[2];
            const unsigned int nl2 = n - nr;
            hr = __dadd_rn(hr, hb[1]);
            const double hl2 = __dsub_rn(sh, hr);
            gr = __dadd_rn(gr, hb[0]);
            const double gl2 = __dsub_rn(sg, gr);
            if (nr < msl) continue;
            if (nl2 < msl) break;
            if (hr < min_hessian) continue;
            if (hl2 < min_hessian) break;
            const double gain = split_gain(gl2, hl2, gr, hr, loss_node, l2);
            if (gain > best.gain && gain > 0.0) {
                best.gain = gain;
                best.bin = b;
                best.missing_left = 1;
                best.gl = gl2;
                best.hl = hl2;
                best.nl = nl2;
            }
        }
    }
    return best;
}

// grid (feature blocks, tasks): a thread a feature; thread 0 keeps the
// block's best in scratch, and the task's last block to finish (a ticket
// on counters[task], reset to 0 after) reduces the blocks in block order
// and writes the record.
__global__ void __launch_bounds__(kSplitThreads)
gbm_best_split_kernel(const double* __restrict__ pool, const int* __restrict__ slots, const double* __restrict__ nodes,
                      const int* __restrict__ nbnm, const uint8_t* __restrict__ has_missing,
                      double* __restrict__ records, double* scratch, unsigned int* counters, int nf,
                      unsigned int msl, double min_hessian, double l2) {
    __shared__ double node_sums[2];
    __shared__ Best best[kSplitThreads];
    __shared__ bool last;
    const int task = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, tid = threadIdx.x;
    const double* hist = pool + (size_t)slots[task] * nf * kBins * 3;
    const double* nd = nodes + (size_t)task * kNode;
    if (tid == 0) {
        if (nd[4] > 0.0) {
            node_sums[0] = pairwise_256(hist);
            node_sums[1] = pairwise_256(hist + 1);
        } else {
            node_sums[0] = nd[1];
            node_sums[1] = nd[2];
        }
    }
    __syncthreads();
    const unsigned int n = (unsigned int)nd[0];
    const double sg = node_sums[0], sh = node_sums[1];
    const double loss_node = __dmul_rn(sg, nd[3]);
    const int f = blk * kSplitThreads + tid;
    if (f < nf) {
        best[tid] = feature_best(hist + (size_t)f * kBins * 3, nbnm[f], has_missing[f] != 0, n, sg, sh, loss_node,
                                 msl, min_hessian, l2, f);
    } else {
        best[tid].feature = -1;
    }
    __syncthreads();
    if (tid == 0) {
        Best w = best[0];
        for (int i = 1; i < kSplitThreads; ++i)
            if (better(best[i], w)) w = best[i];
        double* mine = scratch + ((size_t)task * nblk + blk) * kBestDoubles;
        mine[0] = w.gain;
        mine[1] = w.gl;
        mine[2] = w.hl;
        mine[3] = (double)w.feature;
        mine[4] = (double)w.bin;
        mine[5] = (double)w.missing_left;
        mine[6] = (double)w.nl;
        __threadfence();
        last = atomicAdd(counters + task, 1u) == (unsigned int)(nblk - 1);
    }
    __syncthreads();
    if (!last || tid != 0) return;
    __threadfence();
    Best w;
    w.feature = -1;
    for (int b = 0; b < nblk; ++b) {
        const double* s = scratch + ((size_t)task * nblk + b) * kBestDoubles;
        Best c;
        c.gain = __ldcg(s);
        c.gl = __ldcg(s + 1);
        c.hl = __ldcg(s + 2);
        c.feature = (int)__ldcg(s + 3);
        c.bin = (int)__ldcg(s + 4);
        c.missing_left = (int)__ldcg(s + 5);
        c.nl = (unsigned int)__ldcg(s + 6);
        if (better(c, w)) w = c;
    }
    counters[task] = 0u;
    double* rec = records + (size_t)task * kRecord;
    const double gr = __dsub_rn(sg, w.gl), hr = __dsub_rn(sh, w.hl);
    rec[0] = w.gain;
    rec[1] = (double)w.feature;
    rec[2] = (double)w.bin;
    rec[3] = (double)w.missing_left;
    rec[4] = w.gl;
    rec[5] = w.hl;
    rec[6] = (double)w.nl;
    rec[7] = gr;
    rec[8] = hr;
    rec[9] = (double)(n - w.nl);
    rec[10] = node_value(w.gl, w.hl, l2);
    rec[11] = node_value(gr, hr, l2);
    rec[12] = sg;
    rec[13] = sh;
}

__global__ void __launch_bounds__(kPredictThreads)
gbm_predict_kernel(const double* __restrict__ x, const int* __restrict__ feature, const double* __restrict__ threshold,
                   const uint8_t* __restrict__ missing_left, const int* __restrict__ left, const int* __restrict__ right,
                   const double* __restrict__ value, const int* __restrict__ roots, double* __restrict__ raw, int m,
                   int nf, int k, int n_iter) {
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= (long long)m * k) return;
    const int row = (int)(idx / k), c = (int)(idx % k);
    const double* xr = x + (size_t)row * nf;
    double r = raw[idx];
    for (int it = 0; it < n_iter; ++it) {
        int node = roots[it * k + c];
        int l = left[node];
        while (l >= 0) {
            const double v = xr[feature[node]];
            const bool go_left = isnan(v) ? missing_left[node] != 0 : v <= threshold[node];
            node = go_left ? l : right[node];
            l = left[node];
        }
        r = __dadd_rn(r, value[node]);
    }
    raw[idx] = r;
}

}  // namespace

// bins (nf, n) uint8, g / h (n, k) float32, node_ids (k, n) int32, tasks
// (t, 3) int32 (tree, node, slot) -> pool[slot] (nf, 256, 3) float64.
extern "C" int gbm_histograms_launch(const uint8_t* bins, const float* g, const float* h, const int* node_ids,
                                     const int* tasks, double* pool, int n, int nf, int k, int t, void* stream) {
    if (t <= 0 || nf <= 0) return 0;
    if (t > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((nf + kHistWarps - 1) / kHistWarps, t);
    gbm_histograms_kernel<<<grid, kHistWarps * 32, 0, (cudaStream_t)stream>>>(bins, g, h, node_ids, tasks, pool, n,
                                                                                nf, k);
    return (int)cudaGetLastError();
}

// pool (S, nf, 256, 3), slots (t,), nodes (t, 5), nbnm (nf,) int32,
// has_missing (nf,) uint8 -> records (t, 14) float64. scratch holds
// t * ceil(nf / 64) * 7 doubles; counters (t,) start at 0 and end at 0.
extern "C" int gbm_best_split_launch(const double* pool, const int* slots, const double* nodes, const int* nbnm,
                                     const uint8_t* has_missing, double* records, double* scratch,
                                     unsigned int* counters, int nf, int t, int msl, double min_hessian, double l2,
                                     void* stream) {
    if (t <= 0) return 0;
    if (nf <= 0 || msl < 0 || t > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((nf + kSplitThreads - 1) / kSplitThreads, t);
    gbm_best_split_kernel<<<grid, kSplitThreads, 0, (cudaStream_t)stream>>>(
        pool, slots, nodes, nbnm, has_missing, records, scratch, counters, nf, (unsigned int)msl, min_hessian, l2);
    return (int)cudaGetLastError();
}

// x (m, nf) float64, the flat node arrays, roots (n_iter * k,) -> raw (m, k)
// += each tree's leaf value, iteration by iteration.
extern "C" int gbm_predict_launch(const double* x, const int* feature, const double* threshold,
                                  const uint8_t* missing_left, const int* left, const int* right, const double* value,
                                  const int* roots, double* raw, int m, int nf, int k, int n_iter, void* stream) {
    if (m <= 0 || k <= 0 || n_iter <= 0) return 0;
    const long long work = (long long)m * k;
    const unsigned int blocks = (unsigned int)((work + kPredictThreads - 1) / kPredictThreads);
    gbm_predict_kernel<<<blocks, kPredictThreads, 0, (cudaStream_t)stream>>>(x, feature, threshold, missing_left, left,
                                                                              right, value, roots, raw, m, nf, k,
                                                                              n_iter);
    return (int)cudaGetLastError();
}
