// Fused bidirectional masked GRU layer with flax GRUCell math, for Hopper
// (sm_90a): optional LayerNorm of the input rows, the input projection and
// the recurrence in one kernel.
//
// Replaces the TPU kernel deepof_tpu/ops/pallas_gru.py gru_scan_pallas
// (:55, Pallas body _gru_kernel, pallas_call at :100), input projection
// (:91) included, which MaskedGRU (deepof_tpu/models/blocks.py:49-63) runs
// behind DEEPOF_TPU_GRU_PALLAS=1. The optional LayerNorm is the
// RecurrentBlock's LayerNorm_0 (blocks.py:141), folded into the second
// BiGRU that is its only consumer.
//
// For every stream b and direction d, over t:
//   xn = LayerNorm(x[b, t]) if gamma is given (flax: ddof 0, eps inside
//        the root), else x[b, t]
//   g  = xn W_i[d] + b_i[d]    W_i = [W_ir | W_iz | W_in], (F, 3H)
//   hg = h W_h[d]              W_h = [W_hr | W_hz | W_hn], (H, 3H)
//   r  = sigmoid(g_r + hg_r),  z = sigmoid(g_z + hg_z)
//   n  = tanh(g_n + r * (hg_n + b_hn[d]))
//   h' = (1 - z) * n + z * h
// A masked step keeps the carry and writes 0. Direction d walks t
// backwards when bit d of rev_mask is set (MaskedGRU's flip, scan, flip).
// Outputs (B, T, D*H) are the directions concatenated; `out` may be null,
// and then only the final carries (B, D*H) are written. For training,
// `hs` (B, T, D*H) receives the carry each step starts from (the zero
// state at a direction's first step), one store per lane and step, which
// the backward kernel (gru_scan_bwd.cu) reads; serving passes null.
//
// Design. A CTA owns a tile of S consecutive streams and both directions.
// One lane owns one hidden unit of one direction of P streams (a group of
// G >= H lanes per stream-direction): it computes its unit's three gate
// sums from the tile's rows and the shared carry, so the gate math is done
// once per unit. The projection of step t + 1 is computed in step t,
// beside the carry's chain. The carry goes through shared memory,
// double-buffered by step parity, with one __syncwarp per step
// (__syncthreads when a group spans warps, H > 32). The grid is persistent
// (as many CTAs as fit on the SMs), each CTA walking over tiles. Two
// routes, chosen by shape:
//   * registers, at a RecurrentBlock's widths (F, H) = (2d, 2d) and
//     (4d, d) for d = 4 and 8 (latent 4 and 8; latent 8 serves), where
//     the tile's rows fit in shared memory (T up to ~450 at latent 8).
//     Each lane holds its unit's columns of W_i and W_h (3(F + H) floats)
//     for the whole run. The tile's x rows, one contiguous run of S*T*F
//     floats (x must be 16-byte aligned), are staged by one TMA bulk copy
//     (cp.async.bulk, completed on an mbarrier) into two buffers, so that
//     the next tile's copy runs under this tile's recurrence. The
//     LayerNorm runs on the staged rows in place, once per row for both
//     directions. x and h are read as broadcast float4. Outputs are
//     staged in shared memory and leave as contiguous float4 rows of the
//     whole tile.
//   * L1, every other shape, H up to 128, any T: weight columns read with
//     __ldg, which L1 and L2 keep, each load serving the eight streams a
//     lane carries. x, the mask and the outputs stay in global memory
//     (x read as float4 where F % 4 == 0), so that shared memory holds
//     little and registers bound the CTAs an SM holds. The LayerNorm's
//     row statistics are computed once per row into shared memory at the
//     start of a tile (per lane and step where a tile's do not fit, T
//     above ~3,500), and applied as the projection reads the row.
// FP32 FMAs throughout (no TF32, no tensor cores); the gates' exponentials
// and reciprocals on the SFU. Registers, not shared memory, bound the
// CTAs an SM holds on the register route too (3 at ~168 registers a lane).
//
// Bound on this card: FP32 operations at the serving widths. Per
// stream-step and direction, 6H(F + H) FLOP of projections against 4F
// bytes of input (and 4H of output): ~48 FLOP per byte at F = H = 16,
// above the ~20 FLOP/B ridge of 67 TFLOP/s over 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TARGET_THREADS = 128;
constexpr int MAX_HIDDEN = 128;
// The L1 route may need 2 * MAX_HIDDEN threads for one stream.
constexpr int MAX_THREADS = 2 * MAX_HIDDEN;
constexpr size_t SMEM_LIMIT = 232448;  // 227 KB a block on sm_90


struct Params {
  const float* x;
  const unsigned char* mask;
  const float* wi;
  const float* bi;
  const float* wh;
  const float* bhn;
  const float* gamma;  // null: no LayerNorm
  const float* beta;
  float eps;
  float* out;  // null: final carries only
  float* fin;
  float* hs;  // null: no carry store
  int B, T, F, H, D, G, S, rev_mask;
  int vec;    // L1 route: x, gamma and beta read as float4
  int stats;  // L1 route with a LayerNorm: row statistics in shared memory
};

// Shared-memory layout, in bytes from the base: two mbarriers, two x
// tiles, the output tile, two carry buffers, the mask tile (staged, on the
// register route), the row statistics (L1 route with a LayerNorm).
struct Layout {
  size_t x0, x1, o, h, m, st, total;
};

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) & ~size_t(3); }

__host__ __device__ inline Layout layout(int S, int T, int F, int H, int D, int G, bool outputs, bool staged,
                                         bool stats) {
  Layout l;
  const size_t xt = staged ? round4((size_t)S * T * F) * 4 : 0;
  l.x0 = 16;
  l.x1 = l.x0 + xt;
  l.o = l.x1 + xt;
  l.h = l.o + (outputs && staged ? round4((size_t)S * T * D * H) * 4 : 0);
  l.m = l.h + (size_t)2 * S * D * G * 4;
  l.st = l.m + (staged ? round4((size_t)S * T) : 0);
  l.total = l.st + (stats ? (size_t)S * T * 8 : 0);
  return l;
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

// The gates from the SFU's exp2 and reciprocal (ex2.approx and rcp.approx,
// a few ulp each): absolute errors of ~1e-7 in r, z and n, where expf,
// an IEEE division and tanhf cost ~60 instructions a unit and step.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_sfu(float x) {
  return 2.0f * sigmoid(2.0f * x) - 1.0f;
}

// The flax LayerNorm's mean and 1 / sqrt(var + eps) of one row of x in
// global memory, in two passes.
__device__ __forceinline__ void row_stats(const float* xr, int F, bool vec, float eps, float& mean, float& inv) {
  float sum = 0.0f, sq = 0.0f;
  if (vec) {
    for (int k = 0; k < F; k += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr + k));
      sum += (v.x + v.y) + (v.z + v.w);
    }
    mean = sum / F;
    for (int k = 0; k < F; k += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr + k));
      const float a = v.x - mean, b = v.y - mean, c = v.z - mean, e = v.w - mean;
      sq += (a * a + b * b) + (c * c + e * e);
    }
  } else {
    for (int k = 0; k < F; ++k) sum += __ldg(xr + k);
    mean = sum / F;
    for (int k = 0; k < F; ++k) {
      const float c = __ldg(xr + k) - mean;
      sq += c * c;
    }
  }
  inv = 1.0f / sqrtf(sq / F + eps);
}

// FT, HT > 0: the register route for that (F, H), staged; 0, 0: the L1
// route. P streams a lane.
template <int FT, int HT, int P>
__global__ void __launch_bounds__(FT > 0 ? TARGET_THREADS : MAX_THREADS) gru_layer_kernel(Params p) {
  constexpr bool REG = FT > 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.T, D = p.D, G = p.G, S = p.S;
  const int F = REG ? FT : p.F;
  const int H = REG ? HT : p.H;
  const int H3 = 3 * H, DH = D * H;
  const bool outputs = p.out != nullptr;
  const bool norm = p.gamma != nullptr;
  const bool vec = !REG && p.vec != 0;
  const bool pre = !REG && norm && p.stats != 0;
  const bool hvec = !REG && H % 4 == 0;
  const Layout lay = layout(S, T, F, H, D, G, outputs, REG, pre);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* obuf = reinterpret_cast<float*>(smem + lay.o);
  float* hbuf = reinterpret_cast<float*>(smem + lay.h);
  unsigned char* mbuf = smem + lay.m;
  float* stbuf = reinterpret_cast<float*>(smem + lay.st);  // (S, T) x (mean, inv)

  // Lane (q, d, j) owns unit j of direction d of streams q + i * S / P.
  const int tid = threadIdx.x;
  const int q = tid / (D * G);
  const int d = (tid - q * D * G) / G;
  const int j = tid - q * D * G - d * G;
  const int stride = S / P;
  const bool unit = j < H;
  const int jj = unit ? j : 0;  // idle lanes read unit 0's weights
  const bool rev = (p.rev_mask >> d) & 1;

  const float* wid = p.wi + (size_t)d * F * H3 + jj;
  const float* whd = p.wh + (size_t)d * H * H3 + jj;
  const float bir = p.bi[d * H3 + jj];
  const float biz = p.bi[d * H3 + H + jj];
  const float bin = p.bi[d * H3 + 2 * H + jj];
  const float bhn = p.bhn[d * H + jj];
  float wir[REG ? FT : 1], wiz[REG ? FT : 1], win[REG ? FT : 1];
  float whr[REG ? HT : 1], whz[REG ? HT : 1], whn[REG ? HT : 1];
  if constexpr (REG) {
#pragma unroll
    for (int k = 0; k < FT; ++k) {
      wir[k] = wid[k * H3];
      wiz[k] = wid[k * H3 + H];
      win[k] = wid[k * H3 + 2 * H];
    }
#pragma unroll
    for (int k = 0; k < HT; ++k) {
      whr[k] = whd[k * H3];
      whz[k] = whd[k * H3 + H];
      whn[k] = whd[k * H3 + 2 * H];
    }
  }

  if (REG && tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int ntiles = (p.B + S - 1) / S;
  // One bulk copy a tile: every tile starts at a multiple of T*F floats,
  // and T*F is a multiple of 4 at the register route's widths.
  auto issue = [&](int tile, int buf) {
    if (tid != 0) return;
    const int s0 = tile * S;
    const unsigned bytes = min(S, p.B - s0) * T * F * 4;
    float* dst = reinterpret_cast<float*>(smem + (buf ? lay.x1 : lay.x0));
    mbar_expect_tx(&bars[buf], bytes);
    bulk_load(dst, p.x + (size_t)s0 * T * F, bytes, &bars[buf]);
  };

  int tile = blockIdx.x;
  if (REG && tile < ntiles) issue(tile, 0);
  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const int s0 = tile * S;
    const int ns = min(S, p.B - s0);
    // The tile's x rows, mask rows and outputs: staged in shared memory on
    // the register route, in place in global memory on the L1 route.
    const float* xb;
    const unsigned char* mb;
    float* ob;
    if constexpr (REG) {
      const int buf = it & 1;
      const int next = tile + gridDim.x;
      if (next < ntiles) issue(next, buf ^ 1);
      mbar_wait(&bars[buf], (it >> 1) & 1);
      float* xt = reinterpret_cast<float*>(smem + (buf ? lay.x1 : lay.x0));
      for (int i = tid; i < ns * T; i += blockDim.x) mbuf[i] = p.mask[(size_t)s0 * T + i];
      __syncthreads();  // the mask tile is in
      if (norm) {
        // Two passes over each row, shared by both directions. Thread `row`
        // walks its row from element row % F on, so that the threads of a
        // warp, whose rows lie F floats apart, read different banks.
        for (int row = tid; row < ns * T; row += blockDim.x) {
          float* xr = xt + (size_t)row * F;
          const int k0 = row % F;
          float sum = 0.0f;
          for (int i = 0, k = k0; i < F; ++i, k = k + 1 == F ? 0 : k + 1) sum += xr[k];
          const float mean = sum / F;
          float sq = 0.0f;
          for (int i = 0, k = k0; i < F; ++i, k = k + 1 == F ? 0 : k + 1) {
            const float c = xr[k] - mean;
            sq += c * c;
          }
          const float inv = 1.0f / sqrtf(sq / F + p.eps);
          for (int i = 0, k = k0; i < F; ++i, k = k + 1 == F ? 0 : k + 1)
            xr[k] = (xr[k] - mean) * inv * __ldg(p.gamma + k) + __ldg(p.beta + k);
        }
      }
      xb = xt;
      mb = mbuf;
      ob = obuf;
    } else {
      xb = p.x + (size_t)s0 * T * F;
      mb = p.mask + (size_t)s0 * T;
      ob = outputs ? p.out + (size_t)s0 * T * DH : nullptr;
      if (pre) {
        for (int row = tid; row < ns * T; row += blockDim.x)
          row_stats(xb + (size_t)row * F, F, vec, p.eps, stbuf[2 * row], stbuf[2 * row + 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (unit) hbuf[((size_t)(q + i * stride) * D + d) * G + j] = 0.0f;
    }
    __syncthreads();

    // Idle streams of a ragged tile read stream 0 and write nothing.
    const float* xs[P];
    const unsigned char* ms[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int sc = q + i * stride < ns ? q + i * stride : 0;
      xs[i] = xb + (size_t)sc * T * F;
      ms[i] = mb + (size_t)sc * T;
    }
    // Input projection of row t of every stream slot: independent of the
    // carry. On the L1 route each weight load serves the P slots.
    auto xproj = [&](int t, float* ar, float* az, float* an) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        ar[i] = bir; az[i] = biz; an[i] = bin;
      }
      if constexpr (REG) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          const float* xr = xs[i] + (size_t)t * F;
#pragma unroll
          for (int k = 0; k < FT; k += 4) {
            const float4 v = *reinterpret_cast<const float4*>(xr + k);
            ar[i] = fmaf(v.x, wir[k], ar[i]); az[i] = fmaf(v.x, wiz[k], az[i]); an[i] = fmaf(v.x, win[k], an[i]);
            ar[i] = fmaf(v.y, wir[k + 1], ar[i]); az[i] = fmaf(v.y, wiz[k + 1], az[i]); an[i] = fmaf(v.y, win[k + 1], an[i]);
            ar[i] = fmaf(v.z, wir[k + 2], ar[i]); az[i] = fmaf(v.z, wiz[k + 2], az[i]); an[i] = fmaf(v.z, win[k + 2], an[i]);
            ar[i] = fmaf(v.w, wir[k + 3], ar[i]); az[i] = fmaf(v.w, wiz[k + 3], az[i]); an[i] = fmaf(v.w, win[k + 3], an[i]);
          }
        }
      } else {
        float mean[P], inv[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          mean[i] = 0.0f;
          inv[i] = 1.0f;
          if (pre) {
            const float* st = stbuf + 2 * ((size_t)(q + i * stride < ns ? q + i * stride : 0) * T + t);
            mean[i] = st[0];
            inv[i] = st[1];
          } else if (norm) {
            row_stats(xs[i] + (size_t)t * F, F, vec, p.eps, mean[i], inv[i]);
          }
        }
        // Column k's weights against the P slots' (normalised) x[t, k].
        auto acc = [&](int k, const float* v) {
          const float* w = wid + (size_t)k * H3;
          const float wr = __ldg(w), wz = __ldg(w + H), wn = __ldg(w + 2 * H);
#pragma unroll
          for (int i = 0; i < P; ++i) {
            ar[i] = fmaf(v[i], wr, ar[i]);
            az[i] = fmaf(v[i], wz, az[i]);
            an[i] = fmaf(v[i], wn, an[i]);
          }
        };
        if (vec) {
          for (int k = 0; k < F; k += 4) {
            float v0[P], v1[P], v2[P], v3[P];
#pragma unroll
            for (int i = 0; i < P; ++i) {
              const float4 u = __ldg(reinterpret_cast<const float4*>(xs[i] + (size_t)t * F + k));
              v0[i] = u.x; v1[i] = u.y; v2[i] = u.z; v3[i] = u.w;
            }
            if (norm) {
              const float4 g = __ldg(reinterpret_cast<const float4*>(p.gamma + k));
              const float4 b = __ldg(reinterpret_cast<const float4*>(p.beta + k));
#pragma unroll
              for (int i = 0; i < P; ++i) {
                v0[i] = (v0[i] - mean[i]) * inv[i] * g.x + b.x;
                v1[i] = (v1[i] - mean[i]) * inv[i] * g.y + b.y;
                v2[i] = (v2[i] - mean[i]) * inv[i] * g.z + b.z;
                v3[i] = (v3[i] - mean[i]) * inv[i] * g.w + b.w;
              }
            }
            acc(k, v0); acc(k + 1, v1); acc(k + 2, v2); acc(k + 3, v3);
          }
        } else {
          for (int k = 0; k < F; ++k) {
            float v[P];
#pragma unroll
            for (int i = 0; i < P; ++i) v[i] = __ldg(xs[i] + (size_t)t * F + k);
            if (norm) {
              const float g = __ldg(p.gamma + k), b = __ldg(p.beta + k);
#pragma unroll
              for (int i = 0; i < P; ++i) v[i] = (v[i] - mean[i]) * inv[i] * g + b;
            }
            acc(k, v);
          }
        }
      }
    };
    float h[P], ar[P], az[P], an[P];
#pragma unroll
    for (int i = 0; i < P; ++i) h[i] = 0.0f;
    xproj(rev ? T - 1 : 0, ar, az, an);
    for (int step = 0; step < T; ++step) {
      const int t = rev ? T - 1 - step : step;
      // The next step's projection (the last step recomputes its own) has
      // no branch, so that it fills the latency of this step's gates.
      const int step1 = step + 1 < T ? step + 1 : step;
      const int t1 = rev ? T - 1 - step1 : step1;
      // All reads of the step before any write: the carry and output
      // stores could alias them as far as the compiler knows.
      float gr[P], gz[P], gn[P], nr[P], nz[P], nn[P];
      const float* hr[P];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        hr[i] = hbuf + (((size_t)(step & 1) * S + q + i * stride) * D + d) * G;
        gr[i] = 0.0f; gz[i] = 0.0f; gn[i] = bhn;
      }
      if constexpr (REG) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
#pragma unroll
          for (int k = 0; k < HT; k += 4) {
            const float4 v = *reinterpret_cast<const float4*>(hr[i] + k);
            gr[i] = fmaf(v.x, whr[k], gr[i]); gz[i] = fmaf(v.x, whz[k], gz[i]); gn[i] = fmaf(v.x, whn[k], gn[i]);
            gr[i] = fmaf(v.y, whr[k + 1], gr[i]); gz[i] = fmaf(v.y, whz[k + 1], gz[i]); gn[i] = fmaf(v.y, whn[k + 1], gn[i]);
            gr[i] = fmaf(v.z, whr[k + 2], gr[i]); gz[i] = fmaf(v.z, whz[k + 2], gz[i]); gn[i] = fmaf(v.z, whn[k + 2], gn[i]);
            gr[i] = fmaf(v.w, whr[k + 3], gr[i]); gz[i] = fmaf(v.w, whz[k + 3], gz[i]); gn[i] = fmaf(v.w, whn[k + 3], gn[i]);
          }
        }
      } else {
        // Column k of W_h against the P slots' carry unit k.
        auto hacc = [&](int k, const float* v) {
          const float* w = whd + (size_t)k * H3;
          const float wr = __ldg(w), wz = __ldg(w + H), wn = __ldg(w + 2 * H);
#pragma unroll
          for (int i = 0; i < P; ++i) {
            gr[i] = fmaf(v[i], wr, gr[i]);
            gz[i] = fmaf(v[i], wz, gz[i]);
            gn[i] = fmaf(v[i], wn, gn[i]);
          }
        };
        if (hvec) {
          for (int k = 0; k < H; k += 4) {
            float v0[P], v1[P], v2[P], v3[P];
#pragma unroll
            for (int i = 0; i < P; ++i) {
              const float4 u = *reinterpret_cast<const float4*>(hr[i] + k);
              v0[i] = u.x; v1[i] = u.y; v2[i] = u.z; v3[i] = u.w;
            }
            hacc(k, v0); hacc(k + 1, v1); hacc(k + 2, v2); hacc(k + 3, v3);
          }
        } else {
          for (int k = 0; k < H; ++k) {
            float v[P];
#pragma unroll
            for (int i = 0; i < P; ++i) v[i] = hr[i][k];
            hacc(k, v);
          }
        }
      }
      xproj(t1, nr, nz, nn);
      bool m[P];
#pragma unroll
      for (int i = 0; i < P; ++i) m[i] = ms[i][t] != 0;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int si = q + i * stride;
        const float r = sigmoid(ar[i] + gr[i]);
        const float z = sigmoid(az[i] + gz[i]);
        const float n = tanh_sfu(an[i] + r * gn[i]);
        const float hn = (1.0f - z) * n + z * h[i];
        if (unit) {
          if (p.hs != nullptr && si < ns) p.hs[((size_t)(s0 + si) * T + t) * DH + d * H + j] = h[i];
          h[i] = m[i] ? hn : h[i];
          hbuf[(((size_t)((step + 1) & 1) * S + si) * D + d) * G + j] = h[i];
          if (outputs && si < ns) ob[((size_t)si * T + t) * DH + d * H + j] = m[i] ? hn : 0.0f;
        }
        ar[i] = nr[i]; az[i] = nz[i]; an[i] = nn[i];
      }
      if (G <= 32) {
        __syncwarp();
      } else {
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int si = q + i * stride;
      if (unit && si < ns) p.fin[(size_t)(s0 + si) * DH + d * H + j] = h[i];
    }
    if (REG) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // x, carry and output tiles are read

    if (REG && outputs) {
      const size_t n = (size_t)ns * T * DH;
      float* dst = p.out + (size_t)s0 * T * DH;
      if ((T * DH) % 4 == 0) {
        for (size_t i = tid; i < n / 4; i += blockDim.x)
          reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(obuf)[i];
      } else {
        for (size_t i = tid; i < n; i += blockDim.x) dst[i] = obuf[i];
      }
    }
  }
}

struct Plan {
  void (*kernel)(Params);
  int route;  // 1: register weights, staged; 0: L1 weights
  int P, G, S, threads, stats;
  size_t smem;
};

Plan plan(int T, int F, int H, int D, bool outputs, bool norm, bool aligned) {
  Plan pl;
  pl.kernel = nullptr;
  pl.route = 1;
  pl.stats = 0;
  if (!aligned) {
    // The register route's bulk copies need a 16-byte aligned x.
  } else if (F == 8 && H == 8) {
    // Two streams a lane (0.32 against 0.34 ms with one, H100).
    pl.kernel = gru_layer_kernel<8, 8, 2>;
    pl.P = 2;
  } else if (F == 16 && H == 4) {
    // One (0.21 against 0.29 ms with two, H100).
    pl.kernel = gru_layer_kernel<16, 4, 1>;
    pl.P = 1;
  } else if (F == 16 && H == 16) {
    // Two streams a lane: one lane's weights serve both, and their
    // independent chains overlap (0.86 against 0.91 ms with one, H100).
    pl.kernel = gru_layer_kernel<16, 16, 2>;
    pl.P = 2;
  } else if (F == 32 && H == 8) {
    // One: a second stream's registers would leave two CTAs an SM, not
    // three (0.64 against 0.56 ms, H100).
    pl.kernel = gru_layer_kernel<32, 8, 1>;
    pl.P = 1;
  }
  // A group of G lanes per stream-direction: a power of two inside a warp,
  // or whole warps above H = 32.
  int g = 1;
  while (g < H) g *= 2;
  pl.G = g <= 32 ? g : (H + 31) / 32 * 32;
  // Lane groups a CTA holds: `most`, halved until its shared memory (the
  // staged tiles on the register route, the row statistics on the L1
  // route) fits; 0 if none does.
  const int most = TARGET_THREADS / (D * pl.G) > 0 ? TARGET_THREADS / (D * pl.G) : 1;
  auto fit = [&](int P, bool staged, bool stats) {
    int slots = most;
    while (slots > 0 && layout(slots * P, T, F, H, D, pl.G, outputs, staged, stats).total > SMEM_LIMIT) slots /= 2;
    return slots;
  };
  int slots = pl.kernel != nullptr ? fit(pl.P, true, false) : 0;
  if (slots == 0) {
    // Eight streams a lane: each weight read through L1 serves eight FMAs
    // (latent 64's first BiGRU over 114,688 streams: 80.7 against 126.2 ms
    // with four, H100).
    pl.kernel = gru_layer_kernel<0, 0, 8>;
    pl.route = 0;
    pl.P = 8;
    slots = norm ? fit(pl.P, false, true) : 0;
    pl.stats = slots > 0;
    if (slots == 0) slots = most;
  }
  pl.S = slots * pl.P;
  pl.threads = slots * D * pl.G;
  pl.smem = layout(pl.S, T, F, H, D, pl.G, outputs, pl.route == 1, pl.stats != 0).total;
  return pl;
}

bool valid(int B, int T, int F, int H, int D) {
  return H >= 1 && H <= MAX_HIDDEN && D >= 1 && D <= 2 && B >= 1 && T >= 1 && F >= 1;
}

}  // namespace

// The launch the wrapper would make for this shape, x 16-byte aligned:
// route (1 registers, staged; 0 L1), streams per CTA, threads per CTA,
// shared-memory bytes per CTA, CTAs resident per SM. Returns a CUDA error
// code.
extern "C" int gru_scan_config(int T, int F, int H, int D, int outputs, int norm, int* info) {
  if (!valid(1, T, F, H, D)) return (int)cudaErrorInvalidValue;
  const Plan pl = plan(T, F, H, D, outputs != 0, norm != 0, true);
  cudaError_t err = cudaFuncSetAttribute(pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pl.kernel, pl.threads, pl.smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = pl.route;
  info[1] = pl.S;
  info[2] = pl.threads;
  info[3] = (int)pl.smem;
  info[4] = per_sm;
  return 0;
}

// Launches on `stream` without synchronising; returns cudaGetLastError(),
// or cudaErrorInvalidValue for a shape the kernel does not take (H above
// 128, D above 2).
extern "C" int gru_scan_launch(
    const float* x, const unsigned char* mask, const float* wi, const float* bi,
    const float* wh, const float* bhn, const float* gamma, const float* beta,
    float eps, float* out, float* fin, float* hs, int B, int T, int F, int H, int D,
    int rev_mask, void* stream) {
  if (!valid(B, T, F, H, D)) return (int)cudaErrorInvalidValue;
  const bool aligned = (uintptr_t)x % 16 == 0;
  const Plan pl = plan(T, F, H, D, out != nullptr, gamma != nullptr, aligned);
  cudaError_t err = cudaFuncSetAttribute(pl.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pl.kernel, pl.threads, pl.smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cudaGetDevice(&dev);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (B + pl.S - 1) / pl.S;
  const int grid = ntiles < per_sm * sms ? ntiles : per_sm * sms;

  Params p;
  p.x = x; p.mask = mask; p.wi = wi; p.bi = bi; p.wh = wh; p.bhn = bhn;
  p.gamma = gamma; p.beta = beta; p.eps = eps; p.out = out; p.fin = fin; p.hs = hs;
  p.B = B; p.T = T; p.F = F; p.H = H; p.D = D; p.G = pl.G; p.S = pl.S;
  p.rev_mask = rev_mask;
  p.stats = pl.stats;
  // float4 rows: every row starts at a multiple of F floats.
  p.vec = aligned && F % 4 == 0 &&
          (gamma == nullptr || ((uintptr_t)gamma % 16 == 0 && (uintptr_t)beta % 16 == 0));
  pl.kernel<<<grid, pl.threads, pl.smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
