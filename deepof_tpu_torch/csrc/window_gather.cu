// Stride-1 windows of a frame, standardised and written straight in the
// encoder's stream layout, for Hopper (sm_90a). One launch writes every
// stream tensor of a block of windows (the node and the edge streams).
//
// Replaces the TPU kernel deepof_tpu/ops/pallas_kernels.py
// window_gather_standardize (:65, Pallas body _window_kernel, pallas_call
// at :111; oracle window_gather_standardize_xla), together with what the
// JAX package does with its output before the encoder's first conv: the
// column gathers, the stack of the x / y / speed slices and the
// tf_style_group_reshape (deepof_tpu/models/encoders.py:69-70).
//
// For rows (R, F), n = R - W + 1 windows, and each column table t of shape
// (G, K):
//   out_t[i*G + g, w, j] = (rows[i + w, c] - mu[c]) * (1 / sd[c]),
//   c = cols_t[g, j]
// Stream i*G + g is window-major: window i's streams are one contiguous run
// of P = G*W*K floats. A single table 0..F-1 (G = 1, K = F) is the plain
// (n, W, F) window gather, window_gather_standardize.
//
// Design.
//   * Ownership. The grid holds CTAS_PER_SM CTAs for every SM (fewer where
//     shared memory does not allow it); CTA b owns the
//     windows [b*n/grid, (b+1)*n/grid), a balanced share, and walks it in
//     chunks of at most `chunk` windows, as many as its shared memory holds.
//   * Rows staged once. A chunk's windows share chunk + W - 1 rows, one
//     contiguous run of the frame: one TMA bulk copy (cp.async.bulk on an
//     mbarrier) brings it to shared memory when it starts 16-byte aligned
//     and its length is a multiple of 16 bytes (F % 4 == 0), else plain
//     coalesced loads. The affine is applied to the staged rows in place,
//     once per element, not once per output: the same float operations as
//     the plain version, so the results are equal bit for bit.
//   * Contiguous stores. A chunk's share of each output is one contiguous
//     run of chunk*P floats (8,400 bytes a window for the serving node
//     table, 3,200 for the edge table). Threads walk it in linear order, a
//     float4 each: where P % 4 == 0 every float4 lies inside one window and
//     reads its four source offsets as one int4 from a per-window offset
//     table (offset w*F + c of output element (g, w, j)), built once per
//     CTA in shared memory, so the store loop does no division. Other P
//     take a scalar head and tail and float4 stores with a per-element
//     wrap.
//   * Index arithmetic. The offset tables are built with the width K a
//     template argument for the serving widths K = 3 (nodes) and K = 1
//     (edges), generic K for the rest.
//
// Bound on this card: bytes. Each output float is written once and each
// row read once: at the serving block (4,120 rows x 116 -> nodes
// (114,688, 25, 3) + edges (131,072, 25, 1)) 49.4 MB over 3.35 TB/s,
// 0.0148 ms. The halo rows a chunk re-reads (W - 1 a chunk, from L2) and
// the offset tables add no device-memory traffic to speak of; the design
// keeps the stores wide and contiguous and the SMs busy with several CTAs
// each, so that the staging of one CTA hides under the stores of another.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TABLES = 4;
constexpr int MAX_COLS = 768;  // columns of all tables of one launch
constexpr int CTAS_PER_SM = 4;

enum Mode { SCALAR = 0, VEC = 1 };

struct Params {
  const float* rows;
  const float* mu;
  const float* sd;
  float* out[MAX_TABLES];
  int g[MAX_TABLES], k[MAX_TABLES];
  int col0[MAX_TABLES];  // first column of table t in cols
  int off0[MAX_TABLES];  // first int of table t's offsets in shared memory
  int n_tables;
  int F, W, n, chunk;
  int s_rows, s_off;  // byte offsets of the staged rows and the offset tables
  int cols[MAX_COLS];
};

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) & ~size_t(15); }

// Shared memory, in bytes from the base: the mbarrier, mu, 1 / sd, the
// staged rows, the offset tables.
__host__ __device__ inline size_t rows_offset(int F) { return round16(16 + (size_t)8 * F); }
__host__ __device__ inline size_t offsets_offset(int F, int W, int chunk) {
  return round16(rows_offset(F) + (size_t)(chunk + W - 1) * F * 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// off[(g*W + w)*K + j] = w*F + cols[g*K + j]: the staged-row offset of
// output element (g, w, j) of a window, relative to the window's first row.
template <int KT>
__device__ void build_offsets(int* off, const int* cols, int G, int k, int W, int F) {
  const int K = KT > 0 ? KT : k;
  for (int gj = threadIdx.x; gj < G * K; gj += THREADS) {
    const int c = cols[gj];
    const int g = gj / K;
    int* o = off + g * W * K + (gj - g * K);
    for (int w = 0; w < W; ++w) o[w * K] = w * F + c;
  }
}

// P % 4 == 0: float4 j of the run is elements 4j..4j+3 of one window.
__device__ __forceinline__ void store_vec(const float* S, const int* off, int F, int P, int cnt, float* out) {
  const int P4 = P >> 2;
  const int n4 = cnt * P4;
  const int di = THREADS / P4, dr = THREADS - di * P4;
  int i = threadIdx.x / P4;
  int r4 = threadIdx.x - i * P4;
  float4* dst = reinterpret_cast<float4*>(out);
  for (int q = threadIdx.x; q < n4; q += THREADS) {
    const float* s = S + i * F;
    const int4 o = reinterpret_cast<const int4*>(off)[r4];
    dst[q] = make_float4(s[o.x], s[o.y], s[o.z], s[o.w]);
    r4 += dr;
    i += di;
    if (r4 >= P4) {
      r4 -= P4;
      ++i;
    }
  }
}

// Any P: elements [e0, e0 + cnt*P) of the table (16-byte aligned), a
// scalar head and tail around float4 stores.
__device__ void store_any(const float* S, const int* off, int F, int P, int cnt, float* table, long long e0) {
  const long long e1 = e0 + (long long)cnt * P;
  const long long a0 = ((e0 + 3) & ~3LL) < e1 ? ((e0 + 3) & ~3LL) : e1;
  const long long a1 = (e1 & ~3LL) > a0 ? (e1 & ~3LL) : a0;
  const int head = (int)(a0 - e0), tail = (int)(e1 - a1);
  for (int u = threadIdx.x; u < head + tail; u += THREADS) {
    const int le = u < head ? u : (int)(a1 - e0) + (u - head);
    const int i = le / P, r = le - i * P;
    table[e0 + le] = S[i * F + off[r]];
  }
  for (long long q = a0 / 4 + threadIdx.x; q < a1 / 4; q += THREADS) {
    const int le = (int)(4 * q - e0);
    int i = le / P, r = le - i * P;
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = S[i * F + off[r]];
      if (++r == P) {
        r = 0;
        ++i;
      }
    }
    reinterpret_cast<float4*>(table)[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS) window_streams_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int F = p.F, W = p.W, tid = threadIdx.x;
  float* s_mu = reinterpret_cast<float*>(smem + 16);
  float* s_inv = s_mu + F;
  float* S = reinterpret_cast<float*>(smem + p.s_rows);
  int* s_off = reinterpret_cast<int*>(smem + p.s_off);

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int c = tid; c < F; c += THREADS) {
    s_mu[c] = p.mu[c];
    s_inv[c] = 1.0f / p.sd[c];
  }
  __syncthreads();

  const int w_begin = (int)((long long)blockIdx.x * p.n / gridDim.x);
  const int w_end = (int)((long long)(blockIdx.x + 1) * p.n / gridDim.x);
  // Column of a thread's first staged element, and the step between its
  // elements, so that the affine needs no division per element.
  const int c0 = tid % F, step = THREADS % F;
  unsigned phase = 0;
  for (int start = w_begin; start < w_end; start += p.chunk) {
    const int cnt = min(p.chunk, w_end - start);
    const int n_el = (cnt + W - 1) * F;
    const float* src = p.rows + (size_t)start * F;
    const unsigned bytes = (unsigned)n_el * 4u;
    const bool tma = ((uintptr_t)src & 15) == 0 && (bytes & 15) == 0;
    if (tma && tid == 0) {
      mbar_expect_tx(bar, bytes);
      bulk_load(S, src, bytes, bar);
    }
    if (start == w_begin) {
      // Under the first copy.
      for (int t = 0; t < p.n_tables; ++t) {
        int* off = s_off + p.off0[t];
        const int* cols = p.cols + p.col0[t];
        if (p.k[t] == 3) {
          build_offsets<3>(off, cols, p.g[t], 3, W, F);
        } else if (p.k[t] == 1) {
          build_offsets<1>(off, cols, p.g[t], 1, W, F);
        } else {
          build_offsets<0>(off, cols, p.g[t], p.k[t], W, F);
        }
      }
    }
    int c = c0;
    if (tma) {
      mbar_wait(bar, phase);
      phase ^= 1u;
      for (int e = tid; e < n_el; e += THREADS) {
        S[e] = (S[e] - s_mu[c]) * s_inv[c];
        c += step;
        if (c >= F) c -= F;
      }
    } else {
      for (int e = tid; e < n_el; e += THREADS) {
        S[e] = (__ldg(src + e) - s_mu[c]) * s_inv[c];
        c += step;
        if (c >= F) c -= F;
      }
    }
    __syncthreads();

    for (int t = 0; t < p.n_tables; ++t) {
      const int P = p.g[t] * W * p.k[t];
      const int* off = s_off + p.off0[t];
      if constexpr (MODE == VEC) {
        store_vec(S, off, F, P, cnt, p.out[t] + (size_t)start * P);
      } else {
        store_any(S, off, F, P, cnt, p.out[t], (long long)start * P);
      }
    }
    // The next chunk's copy overwrites the staged rows: order this chunk's
    // reads and writes of them (generic proxy) before it (async proxy).
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
  }
}

struct Plan {
  void (*kernel)(Params);
  int mode, grid, chunk, per_sm;
  size_t smem;
};

// Fills p's shapes and shared-memory layout and chooses the launch. Returns
// a CUDA error code: cudaErrorInvalidValue for a shape the kernel does not
// take (more than MAX_TABLES tables or MAX_COLS columns, or rows that do not
// fit in shared memory even one window a chunk).
int plan(int R, int F, int W, int n_tables, const int* gk, Params& p, Plan& pl) {
  if (F < 1 || W < 1 || R < W || n_tables < 1 || n_tables > MAX_TABLES) return (int)cudaErrorInvalidValue;
  int n_cols = 0, n_off = 0, most_p = 1;
  bool p4 = true;
  for (int t = 0; t < n_tables; ++t) {
    const int G = gk[2 * t], K = gk[2 * t + 1];
    if (G < 1 || K < 1) return (int)cudaErrorInvalidValue;
    const long long P = (long long)G * W * K;
    if (P > (1 << 24)) return (int)cudaErrorInvalidValue;
    p.g[t] = G;
    p.k[t] = K;
    p.col0[t] = n_cols;
    p.off0[t] = n_off;
    n_cols += G * K;
    n_off += (int)((P + 3) & ~3LL);  // int4-aligned tables
    p4 = p4 && P % 4 == 0;
    most_p = P > most_p ? (int)P : most_p;
  }
  if (n_cols > MAX_COLS) return (int)cudaErrorInvalidValue;
  p.n_tables = n_tables;
  p.F = F;
  p.W = W;
  p.n = R - W + 1;

  pl.mode = p4 ? VEC : SCALAR;
  pl.kernel = p4 ? window_streams_kernel<VEC> : window_streams_kernel<SCALAR>;

  int dev = 0, sms = 0, optin = 0, per_sm_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&per_sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return (int)err;

  const int cps = CTAS_PER_SM;
  const long long grid0 = p.n < (long long)sms * cps ? p.n : (long long)sms * cps;
  const long long share = (p.n + grid0 - 1) / grid0;
  // The most windows a chunk may hold within `budget` bytes of shared memory.
  const size_t fixed = rows_offset(F) + (size_t)n_off * 4 + 16;  // 16: rounding slack
  auto most = [&](long long budget) {
    return budget > (long long)fixed ? (long long)((budget - fixed) / ((size_t)F * 4)) - (W - 1) : 0LL;
  };
  long long cap = most((long long)per_sm_smem / cps - 1024);  // 1 KB reserved a CTA
  if (cap < 1) cap = most(optin);
  if (cap < 1) return (int)cudaErrorInvalidValue;
  if (cap > INT_MAX / most_p) cap = INT_MAX / most_p;  // a chunk's elements index as int
  pl.chunk = (int)(share < cap ? share : cap);
  pl.smem = offsets_offset(F, W, pl.chunk) + (size_t)n_off * 4;
  p.chunk = pl.chunk;
  p.s_rows = (int)rows_offset(F);
  p.s_off = (int)offsets_offset(F, W, pl.chunk);

  err = cudaFuncSetAttribute(pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&pl.per_sm, pl.kernel, THREADS, pl.smem);
  if (err != cudaSuccess) return (int)err;
  if (pl.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * (pl.per_sm < cps ? pl.per_sm : cps);
  pl.grid = (int)(p.n < resident ? p.n : resident);
  return 0;
}

}  // namespace

// The launch window_streams_launch makes for this shape. gk holds (G, K)
// per table. info: mode (0 scalar, 1 float4), CTAs in the grid, windows per
// chunk, threads per CTA, shared-memory bytes per CTA, CTAs resident per
// SM. Returns a CUDA error code.
extern "C" int window_streams_config(int R, int F, int W, int n_tables, const int* gk, int* info) {
  Params p;
  Plan pl;
  const int err = plan(R, F, W, n_tables, gk, p, pl);
  if (err != 0) return err;
  info[0] = pl.mode;
  info[1] = pl.grid;
  info[2] = pl.chunk;
  info[3] = THREADS;
  info[4] = (int)pl.smem;
  info[5] = pl.per_sm;
  return 0;
}

// Launches on `stream` without synchronising; returns cudaGetLastError(),
// or the error of the plan. rows (R, F), mu and sd (F,) float32 on the
// card; gk holds (G, K) per table; cols the tables' columns,
// concatenated; outs one (n*G, W, K) float32 output per table, 16-byte
// aligned.
extern "C" int window_streams_launch(const float* rows, const float* mu, const float* sd, int R, int F, int W,
                                     int n_tables, const int* gk, const int* cols, float* const* outs,
                                     void* stream) {
  Params p;
  Plan pl;
  for (int t = 0; t < n_tables && t < MAX_TABLES; ++t) {
    if ((uintptr_t)outs[t] % 16 != 0) return (int)cudaErrorMisalignedAddress;
  }
  const int err = plan(R, F, W, n_tables, gk, p, pl);
  if (err != 0) return err;
  p.rows = rows;
  p.mu = mu;
  p.sd = sd;
  int c = 0;
  for (int t = 0; t < n_tables; ++t) {
    p.out[t] = outs[t];
    for (int j = 0; j < p.g[t] * p.k[t]; ++j, ++c) p.cols[c] = cols[c];
  }
  pl.kernel<<<pl.grid, THREADS, pl.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
