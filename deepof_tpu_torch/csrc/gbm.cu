// The gradient-boosted tree fit's three hot loops, for Hopper (sm_90a):
// per-node histograms, the best split of each node, and the ensemble's raw
// predictions (wrapper: ops/gbm_kernels.py; estimator: gbm.py).
//
// No TPU kernel to translate: the JAX package fits sklearn's
// HistGradientBoostingClassifier on the host (deepof_tpu/posthoc.py:932).
// The port restates it, and these kernels keep sklearn's order of float
// additions, so that a fit gives sklearn's trees and two fits on the card
// give the same bits: no float atomics, no bin's rows split into partial
// sums, no parallel prefix scan.
//
// gbm_histograms: for each task (tree, node, slot, parent), the float64
// sums of the float32 gradients g and hessians h (K, n) and the row count
// in every (feature, bin) of the uint8 bins (n, Fp) (row-major, Fp a
// multiple of 16), written to pool[slot] (F, 256, 3); where parent >= 0,
// pool[parent] then becomes pool[parent] - pool[slot], one subtraction a
// value (sklearn's _subtract_histograms: the larger child from its parent
// and its smaller sibling). A row belongs to the node that
// node_ids[tree, row] names.
//   A CTA is a task and 16 features, a warp a feature (512 threads, ~104 KB
// of shared memory, two CTAs a SM). The CTA walks the tree's node ids once,
// 512 a stage, a thread each: a ballot and a prefix count over the warps
// compact the node's rows of the stage in ascending order, and each of
// those rows' g, h (from the (K, n) copy, one tree's values contiguous) and
// 16 bins (one 16-byte slice of its row) are copied into shared memory with
// cp.async, once for all 16 feature warps. Two stage buffers: the next
// stage's ids are tested and its copies started before this stage is
// added. Route chosen: the node ids, not sklearn's per-tree partition of
// row indices kept by _apply_splits: the ids are 4 bytes a row, read once a
// CTA from L2, where a stable partition would need launches of its own
// every round, and the bins of a node's rows are gathered either way.
//   Each feature warp adds the staged rows into its bins 32 at a time, in
// row order: lanes of one bin find each other with __match_any_sync, and
// the lowest adds the group's values in lane order into the warp's (g, h)
// pairs in shared memory, so each bin's sum is taken in ascending row
// order, as sklearn's _build_histogram takes it. (Lane-owned bins, each
// lane walking every staged row for the bins b with b % 32 == lane, were
// timed against this: 3.9x slower at the roots, 2.7x at a mid round, 7%
// faster at a deep one; PERF.md.) The epilogue writes the 16
// features' histograms and, with a parent, its subtraction. Bound: bytes
// (the node rows' bins, g and h read once, the histograms written once,
// the parent's read and written once). What holds it back (PERF.md): the
// adds, ~110 SM cycles a 32-row step (the model gave ~25 for the bins'
// shared-memory read-modify-writes), and for a small node the ~53 stages
// a CTA walks whatever the node's size.
//
// gbm_best_split: for each task, sklearn's Splitter.find_node_split with
// no monotonic or interaction constraints: every feature's bins scanned left
// to right (missing values right) and, where the feature has missing values,
// right to left (missing values left), the cumulative sums taken serially
// in scan order, sklearn's continue / break rules on min_samples_leaf and
// min_hessian_to_split, its gain (splitting.pyx _split_gain, no FMA: the
// products and sums round apart as the Cython's do), the first bin of the
// largest gain in scan order, the right-to-left scan winning only where its
// gain is strictly larger, and across features the first of the largest.
// A root task forms its node's sums from feature 0's bins in numpy's
// pairwise order (sklearn sums the histogram with numpy), by a warp.
//   A CTA is a task and 8 features (128 threads, ~40 KB of shared memory,
// five CTAs a SM, so the fit's 10 tasks of ~500 features run in one wave).
// All threads stage the 8 histograms in shared memory with coalesced loads
// ((g, h) pairs and integer counts, 16 bytes between features so that the
// scans at one bin hit distinct banks); then one thread a (feature,
// direction) scans from there. Warp shuffles merge each feature's two
// directions and reduce the 8 features; each CTA leaves its best in
// scratch, and the task's last CTA to finish (a ticket counter) reduces
// them with shuffles. Every reduction takes the largest gain, ties to the
// lower feature: a total order over finite gains (a gain is formed only
// where both hessian sums reach min_hessian_to_split > 0), so the result
// does not depend on the order of the reduction or on which CTA ends
// last. Bound: bytes (one read of the task's histograms). What holds it
// back (PERF.md): each scan step's two float64 divisions, serial in its
// thread.
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
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRecord = 14;
constexpr int kNode = 5;
constexpr int kTask = 4;
constexpr int kPredictThreads = 256;

// --------------------------------------------------------------------------
// gbm_histograms
// --------------------------------------------------------------------------

constexpr int kHistFeatures = 16;                  // a CTA's features, a warp each
constexpr int kHistThreads = kHistFeatures * 32;   // 512
constexpr int kStage = kHistThreads;               // node ids a stage tests, a thread each
constexpr int kBinWords = kHistFeatures / 4;       // a staged row's 16 bins as 4 words

struct HistSmem {
    double2 sums[kHistFeatures][kBins];         // (sum g, sum h) of each bin
    unsigned int count[kHistFeatures][kBins];
    float2 gh[2][kStage];                       // staged rows' (g, h), two buffers
    uint32_t bins[2][kStage][kBinWords];        // staged rows' bins, words swizzled
    int warp_rows[2][kHistFeatures];            // node rows of each warp's ids
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Word q of staged row i sits at q ^ ((i >> 3) & 3): a warp reading one
// feature's bin of 32 consecutive rows then hits 32 distinct banks.
__device__ __forceinline__ int bin_word(int i, int q) { return q ^ ((i >> 3) & 3); }

__device__ __forceinline__ unsigned staged_bin(const HistSmem& sm, int buf, int i, int w) {
    return (sm.bins[buf][i][bin_word(i, w >> 2)] >> (8 * (w & 3))) & 0xffu;
}

// Tests this thread's node id (of row `base + threadIdx.x`), compacts the
// stage's rows of `node` into buffer `buf` in ascending order and starts
// their copies. Returns the stage's count of node rows (every thread).
__device__ __forceinline__ int stage_rows(HistSmem& sm, int buf, int base, int id, int node, const uint8_t* bins,
                                          const float* g, const float* h, int fp, int group) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const bool member = id == node;
    const unsigned ballot = __ballot_sync(kFull, member);
    if (lane == 0) sm.warp_rows[buf][warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kHistFeatures; ++w) {
        const int c = sm.warp_rows[buf][w];
        before += w < warp ? c : 0;
        total += c;
    }
    if (member) {
        const int pos = before + __popc(ballot & ((1u << lane) - 1u));
        const int row = base + threadIdx.x;
        cp_async4(&sm.gh[buf][pos].x, g + row);
        cp_async4(&sm.gh[buf][pos].y, h + row);
        const uint8_t* src = bins + (size_t)row * fp + group * kHistFeatures;
#pragma unroll
        for (int q = 0; q < kBinWords; ++q) cp_async4(&sm.bins[buf][pos][bin_word(pos, q)], src + 4 * q);
    }
    return total;
}

// Warp w adds the `rows` staged rows of buffer `buf` into feature w's bins,
// each bin's rows in ascending order.
__device__ __forceinline__ void add_rows(HistSmem& sm, int buf, int rows, int w) {
    const int lane = threadIdx.x & 31;
    double2* sums = sm.sums[w];
    unsigned int* count = sm.count[w];
    for (int base = 0; base < rows; base += 32) {
        const int i = base + lane;
        const bool valid = i < rows;
        const unsigned b = valid ? staged_bin(sm, buf, i, w) : (unsigned)(kBins + lane);
        const unsigned peers = __match_any_sync(kFull, b);
        if (valid && (peers & ((1u << lane) - 1u)) == 0u) {  // the lowest lane of its bin
            double2 s = sums[b];
            unsigned m = peers;
            do {
                const float2 v = sm.gh[buf][base + __ffs(m) - 1];
                s.x = __dadd_rn(s.x, (double)v.x);
                s.y = __dadd_rn(s.y, (double)v.y);
                m &= m - 1u;
            } while (m);
            sums[b] = s;
            count[b] += (unsigned)__popc(peers);
        }
        __syncwarp();  // the next group's lowest lane may be another lane
    }
}

// grid (feature groups of 16, tasks); tasks (t, 4): tree, node, slot,
// parent slot (-1: none).
__global__ void __launch_bounds__(kHistThreads, 2)
gbm_histograms_kernel(const uint8_t* __restrict__ bins, const float* __restrict__ g, const float* __restrict__ h,
                      const int* __restrict__ node_ids, const int* __restrict__ tasks, double* pool, int n, int nf,
                      int fp) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    HistSmem& sm = *reinterpret_cast<HistSmem*>(smem_raw);
    const int warp = threadIdx.x >> 5;
    const int group = blockIdx.x;
    const int* td = tasks + kTask * blockIdx.y;
    const int tree = td[0], node = td[1], slot = td[2], parent = td[3];
    for (int i = threadIdx.x; i < kHistFeatures * kBins; i += kHistThreads) {
        (&sm.sums[0][0])[i] = make_double2(0.0, 0.0);
        (&sm.count[0][0])[i] = 0u;
    }
    const int* ids = node_ids + (size_t)tree * n;
    const float* gt = g + (size_t)tree * n;
    const float* ht = h + (size_t)tree * n;
    const int stages = (n + kStage - 1) / kStage;
    auto id_of = [&](int s) {
        const int row = s * kStage + (int)threadIdx.x;
        return row < n ? __ldg(ids + row) : -1;
    };
    int id = id_of(0);
    int rows = stage_rows(sm, 0, 0, id, node, bins, gt, ht, fp, group);
    cp_async_commit();
    if (stages > 1) id = id_of(1);
    const bool active = group * kHistFeatures + warp < nf;
    for (int s = 0; s < stages; ++s) {
        const int buf = s & 1;
        int next = 0;
        if (s + 1 < stages) {
            next = stage_rows(sm, buf ^ 1, (s + 1) * kStage, id, node, bins, gt, ht, fp, group);
            if (s + 2 < stages) id = id_of(s + 2);
        }
        cp_async_commit();
        cp_async_wait<1>();  // this stage's copies (the next stage's may still fly)
        __syncthreads();
        if (active && rows > 0) add_rows(sm, buf, rows, warp);
        __syncthreads();  // the buffer is refilled two stages on
        rows = next;
    }
    cp_async_wait<0>();
    double* out = pool + (size_t)slot * nf * kBins * 3;
    double* par = parent >= 0 ? pool + (size_t)parent * nf * kBins * 3 : nullptr;
    for (int i = threadIdx.x; i < kHistFeatures * kBins; i += kHistThreads) {
        const int f = group * kHistFeatures + i / kBins;
        if (f >= nf) break;
        const double2 s = (&sm.sums[0][0])[i];
        const double c = (double)(&sm.count[0][0])[i];
        const size_t at = ((size_t)f * kBins + (i & (kBins - 1))) * 3;
        out[at] = s.x;
        out[at + 1] = s.y;
        out[at + 2] = c;
        if (par) {
            par[at] = __dsub_rn(par[at], s.x);
            par[at + 1] = __dsub_rn(par[at + 1], s.y);
            par[at + 2] = __dsub_rn(par[at + 2], c);
        }
    }
}

// --------------------------------------------------------------------------
// gbm_best_split
// --------------------------------------------------------------------------

constexpr int kSplitFeatures = 8;     // a CTA's features, two scan threads each
constexpr int kSplitThreads = 128;    // all stage; the first 2 * kSplitFeatures scan
constexpr int kStagedPerThread = kSplitFeatures * kBins / kSplitThreads;
constexpr int kSplitBlocksPerSM = 5;  // ~40 KB of shared memory each

struct StagedFeature {
    double2 gh[kBins];  // (sum g, sum h)
    unsigned int count[kBins];
    unsigned int pad[4];  // 16 bytes apart: one bin of 8 features in 8 bank groups
};

struct SplitSmem {
    StagedFeature feat[kSplitFeatures];
    double node_sums[2];
};

__device__ __forceinline__ double node_value(double sum_g, double sum_h, double l2) {
    return __ddiv_rn(-sum_g, __dadd_rn(__dadd_rn(sum_h, l2), 1e-15));
}

__device__ __forceinline__ double split_gain(double gl, double hl, double gr, double hr, double loss_node, double l2) {
    const double gain = __dsub_rn(loss_node, __dmul_rn(gl, node_value(gl, hl, l2)));
    return __dsub_rn(gain, __dmul_rn(gr, node_value(gr, hr, l2)));
}

// A scan's (a feature's, a CTA's) best split; the doubles a CTA leaves for
// the task's last CTA.
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

__device__ __forceinline__ Best shfl_best(const Best& b, int lane_or_mask, bool xor_lanes) {
    Best o;
#define GBM_SHFL(field)                                                                         \
    o.field = xor_lanes ? __shfl_xor_sync(kFull, b.field, lane_or_mask)                        \
                        : __shfl_down_sync(kFull, b.field, lane_or_mask)
    GBM_SHFL(gain);
    GBM_SHFL(gl);
    GBM_SHFL(hl);
    GBM_SHFL(feature);
    GBM_SHFL(bin);
    GBM_SHFL(missing_left);
    GBM_SHFL(nl);
#undef GBM_SHFL
    return o;
}

// One direction's serial scan of a staged feature: left to right over bins
// [0, nbnm - 1 + has_missing) with missing values right, or right to left
// over bins nbnm - 2 .. 0 with missing values left (features with missing
// values only). gain -1: no bin satisfies the rules.
__device__ __forceinline__ Best scan(const StagedFeature& hf, bool right_to_left, int nbnm, bool has_missing,
                                     unsigned int n, double sg, double sh, double loss_node, unsigned int msl,
                                     double min_hessian, double l2, int f) {
    Best best;
    best.gain = -1.0;
    best.gl = best.hl = 0.0;
    best.feature = f;
    best.bin = 0;
    best.missing_left = right_to_left ? 1 : 0;
    best.nl = 0u;
    if (!right_to_left) {
        const int end = nbnm - 1 + (has_missing ? 1 : 0);
        double gl = 0.0, hl = 0.0;
        unsigned int nl = 0u;
        for (int b = 0; b < end; ++b) {
            nl += hf.count[b];
            const unsigned int nr = n - nl;
            const double2 v = hf.gh[b];
            hl = __dadd_rn(hl, v.y);
            const double hr = __dsub_rn(sh, hl);
            gl = __dadd_rn(gl, v.x);
            const double gr = __dsub_rn(sg, gl);
            if (nl < msl) continue;
            if (nr < msl) break;
            if (hl < min_hessian) continue;
            if (hr < min_hessian) break;
            const double gain = split_gain(gl, hl, gr, hr, loss_node, l2);
            if (gain > best.gain && gain > 0.0) {
                best.gain = gain;
                best.bin = b;
                best.gl = gl;
                best.hl = hl;
                best.nl = nl;
            }
        }
    } else if (has_missing && nbnm >= 2) {
        double gr = 0.0, hr = 0.0;
        unsigned int nr = 0u;
        for (int b = nbnm - 2; b >= 0; --b) {
            nr += hf.count[b + 1];
            const unsigned int nl = n - nr;
            const double2 v = hf.gh[b + 1];
            hr = __dadd_rn(hr, v.y);
            const double hl = __dsub_rn(sh, hr);
            gr = __dadd_rn(gr, v.x);
            const double gl = __dsub_rn(sg, gr);
            if (nr < msl) continue;
            if (nl < msl) break;
            if (hr < min_hessian) continue;
            if (hl < min_hessian) break;
            const double gain = split_gain(gl, hl, gr, hr, loss_node, l2);
            if (gain > best.gain && gain > 0.0) {
                best.gain = gain;
                best.bin = b;
                best.gl = gl;
                best.hl = hl;
                best.nl = nl;
            }
        }
    }
    return best;
}

// grid (feature blocks, tasks): a thread a (feature, direction). The task's
// last block to finish (a ticket on counters[task], reset to 0 after)
// reduces the blocks' bests and writes the record.
__global__ void __launch_bounds__(kSplitThreads, kSplitBlocksPerSM)
gbm_best_split_kernel(const double* __restrict__ pool, const int* __restrict__ slots, const double* __restrict__ nodes,
                      const int* __restrict__ nbnm, const uint8_t* __restrict__ has_missing,
                      double* __restrict__ records, double* scratch, unsigned int* counters, int nf,
                      unsigned int msl, double min_hessian, double l2) {
    __shared__ SplitSmem sm;
    const int task = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, tid = threadIdx.x, lane = tid & 31;
    const double* hist = pool + (size_t)slots[task] * nf * kBins * 3;
    const double* nd = nodes + (size_t)task * kNode;
    const int f0 = blk * kSplitFeatures;
#pragma unroll
    for (int k0 = 0; k0 < kStagedPerThread; k0 += 4) {
        double v[4][3];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int i = tid + (k0 + k) * kSplitThreads;
            const bool in = f0 + i / kBins < nf;
            const double* src = hist + ((size_t)f0 * kBins + i) * 3;
            v[k][0] = in ? __ldg(src) : 0.0;
            v[k][1] = in ? __ldg(src + 1) : 0.0;
            v[k][2] = in ? __ldg(src + 2) : 0.0;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int i = tid + (k0 + k) * kSplitThreads;
            StagedFeature& sf = sm.feat[i / kBins];
            sf.gh[i % kBins] = make_double2(v[k][0], v[k][1]);
            sf.count[i % kBins] = (unsigned int)v[k][2];
        }
    }
    if (tid >> 5 == 1) {
        if (nd[4] > 0.0) {
            const int comp = lane >> 4, half = (lane >> 3) & 1, j = lane & 7;
            const double* v = hist + (size_t)(half * 128 + j) * 3 + comp;
            double r = __ldg(v);
#pragma unroll
            for (int i = 1; i < 16; ++i) r = __dadd_rn(r, __ldg(v + 24 * i));
            r = __dadd_rn(r, __shfl_xor_sync(kFull, r, 1));
            r = __dadd_rn(r, __shfl_xor_sync(kFull, r, 2));
            r = __dadd_rn(r, __shfl_xor_sync(kFull, r, 4));
            r = __dadd_rn(r, __shfl_xor_sync(kFull, r, 8));
            if ((lane & 15) == 0) sm.node_sums[comp] = r;
        } else if (lane < 2) {
            sm.node_sums[lane] = nd[1 + lane];
        }
    }
    __syncthreads();
    if (tid >= 32) return;
    const unsigned int n = (unsigned int)nd[0];
    const double sg = sm.node_sums[0], sh = sm.node_sums[1];
    const double loss_node = __dmul_rn(sg, nd[3]);
    const int fl = lane & (kSplitFeatures - 1), f = f0 + fl;
    Best best;
    if (lane < 2 * kSplitFeatures && f < nf) {
        best = scan(sm.feat[fl], lane >= kSplitFeatures, nbnm[f], has_missing[f] != 0, n, sg, sh, loss_node, msl,
                    min_hessian, l2, f);
    } else {
        best.gain = -1.0;
        best.gl = best.hl = 0.0;
        best.feature = -1;
        best.bin = best.missing_left = 0;
        best.nl = 0u;
    }
    __syncwarp();
    const Best rl = shfl_best(best, kSplitFeatures, false);
    if (lane < kSplitFeatures && rl.feature >= 0 && rl.gain > best.gain) best = rl;
    for (int m = kSplitFeatures / 2; m > 0; m >>= 1) {
        const Best c = shfl_best(best, m, true);
        if (better(c, best)) best = c;
    }
    unsigned int last = 0u;
    if (lane == 0) {
        double* mine = scratch + ((size_t)task * nblk + blk) * kBestDoubles;
        mine[0] = best.gain;
        mine[1] = best.gl;
        mine[2] = best.hl;
        mine[3] = (double)best.feature;
        mine[4] = (double)best.bin;
        mine[5] = (double)best.missing_left;
        mine[6] = (double)best.nl;
        __threadfence();
        last = atomicAdd(counters + task, 1u) == (unsigned int)(nblk - 1) ? 1u : 0u;
    }
    if (!__shfl_sync(kFull, last, 0)) return;
    __threadfence();
    Best w;
    w.gain = -1.0;
    w.gl = w.hl = 0.0;
    w.feature = -1;
    w.bin = w.missing_left = 0;
    w.nl = 0u;
    for (int b = lane; b < nblk; b += 32) {
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
    for (int m = 16; m > 0; m >>= 1) {
        const Best c = shfl_best(w, m, true);
        if (better(c, w)) w = c;
    }
    if (lane != 0) return;
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

// --------------------------------------------------------------------------
// gbm_predict
// --------------------------------------------------------------------------

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

// bins (n, fp) uint8 (fp a multiple of 16, 16-byte aligned), g / h (k, n)
// float32, node_ids (k, n) int32, tasks (t, 4) int32 (tree, node, slot,
// parent or -1) -> pool[slot] (nf, 256, 3) float64, and pool[parent] -=
// pool[slot].
extern "C" int gbm_histograms_launch(const uint8_t* bins, const float* g, const float* h, const int* node_ids,
                                     const int* tasks, double* pool, int n, int nf, int fp, int t, void* stream) {
    if (t <= 0 || nf <= 0 || n <= 0) return 0;
    if (t > 65535 || fp % kHistFeatures != 0 || nf > fp || ((uintptr_t)bins & 15u) != 0u)
        return (int)cudaErrorInvalidValue;
    static bool configured = false;  // the opt-in above 48 KB of shared memory
    const int bytes = (int)sizeof(HistSmem);
    if (!configured) {
        cudaError_t err =
            cudaFuncSetAttribute(gbm_histograms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err == cudaSuccess)  // two CTAs a SM
            err = cudaFuncSetAttribute(gbm_histograms_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    const dim3 grid((nf + kHistFeatures - 1) / kHistFeatures, t);
    gbm_histograms_kernel<<<grid, kHistThreads, bytes, (cudaStream_t)stream>>>(bins, g, h, node_ids, tasks, pool, n,
                                                                                nf, fp);
    return (int)cudaGetLastError();
}

// pool (S, nf, 256, 3), slots (t,), nodes (t, 5), nbnm (nf,) int32,
// has_missing (nf,) uint8 -> records (t, 14) float64. scratch holds
// t * ceil(nf / 8) * 7 doubles; counters (t,) start at 0 and end at 0.
extern "C" int gbm_best_split_launch(const double* pool, const int* slots, const double* nodes, const int* nbnm,
                                     const uint8_t* has_missing, double* records, double* scratch,
                                     unsigned int* counters, int nf, int t, int msl, double min_hessian, double l2,
                                     void* stream) {
    if (t <= 0) return 0;
    if (nf <= 0 || msl < 0 || t > 65535) return (int)cudaErrorInvalidValue;
    static bool configured = false;  // five CTAs a SM
    if (!configured) {
        const cudaError_t err = cudaFuncSetAttribute(
            gbm_best_split_kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    const dim3 grid((nf + kSplitFeatures - 1) / kSplitFeatures, t);
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
