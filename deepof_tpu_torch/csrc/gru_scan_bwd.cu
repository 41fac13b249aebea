// Backward of the fused bidirectional masked GRU layer (gru_scan.cu), for
// Hopper (sm_90a): the layer's input, weight and bias gradients in one
// kernel, from the carries the forward stored.
//
// No TPU kernel to translate: the JAX package's Pallas GRU
// (deepof_tpu/ops/pallas_gru.py gru_scan_pallas) is forward-only, and JAX
// trains through flax nn.scan (deepof_tpu/models/blocks.py:65-89), whose
// backward XLA derives. This kernel is that derivative written out.
//
// Forward, for stream b and direction d at a step t (flax GRUCell gates:
// r and z have input-side biases only, b_hn sits inside r * (...)):
//   g  = x_t W_i + b_i,   hg = h W_h,   h = the carry the step starts from
//   r  = sigmoid(g_r + hg_r),  z = sigmoid(g_z + hg_z)
//   n  = tanh(g_n + r * (hg_n + b_hn)),  h' = (1 - z) n + z h
// and a masked step keeps the carry and outputs 0. Walking each
// direction's processing order backwards from dh = dfin, at a valid step
//   dh~   = dh + dout_t
//   da_n  = dh~ (1 - z) (1 - n^2)          (gradient of g_n)
//   dHn   = da_n r                         (gradient of hg_n + b_hn)
//   da_r  = da_n (hg_n + b_hn) r (1 - r)   (of g_r and of hg_r)
//   da_z  = dh~ (h - n) z (1 - z)          (of g_z and of hg_z)
//   dh    = z dh~ + [da_r | da_z | dHn] W_h^T
// and at a masked step dh passes through unchanged and the step's gate
// gradients are 0. With dG = [da_r | da_z | da_n] and dG' = [da_r | da_z |
// dHn], the layer's gradients are sums over stream-steps:
//   dx_t = sum_d dG_d,t W_i,d^T,  dW_i = sum x_t (x) dG,  db_i = sum dG,
//   dW_h = sum h (x) dG',  db_hn = sum dHn.
// r, z, n are recomputed from x, the weights and the carries `hs` (B, T,
// D, H) that the forward launch stored in training mode, with the forward
// kernel's SFU gate functions. The gate gradients never leave the SM.
//
// Design. A CTA owns a tile of S streams and both directions (a persistent
// grid walks the tiles) and takes each direction's backward walk in chunks
// of TC steps; step u of a walk is frame T-1-u of a forward direction and
// frame u of a reverse one. A chunk's (stream, direction, step) slots live
// in shared memory. Per chunk, four phases between barriers:
//  A1. (all threads) x_t, the carry h and dout of every slot are copied
//     in with cp.async, all in flight at once, and the step masks read;
//     each slot's operand row is [x | 1 | 0.. | h | 1 | 0..] (the constant
//     entries written once).
//  A2. (all threads, parallel over steps) each unit recomputes the gates
//     of UG steps at once (each weight load serving the UG steps) and
//     stores the five coefficients that turn dh~ into the gate gradients
//     (all 0 at a masked step).
//  B. (the serial lanes: lane (q, d, j) owns unit j of direction d of
//     stream q, a group of G >= H lanes per stream-direction) the chain:
//     dh~, the four gate gradients, published to shared memory as the
//     slot's row [da_n | da_r | da_z | dHn] (dG is its first three blocks,
//     dG' its last three), one __syncwarp (a named barrier of the serial
//     threads where a group spans warps, H > 32), and dh for the next step
//     from dG' against row j of W_h. Where the weights and the
//     accumulators fit STAGE_MAX every phase reads the weights from shared
//     memory, W_h's rows padded by a float; else from global memory, row j
//     of W_h as a column of the transposed copy `wht` that the wrapper
//     passes, so that a group's lanes read consecutive floats. Only this
//     phase is serial.
//  C. (all threads) the weight gradients: per direction the outer products
//     [x | 1] (x) dG and [h | 1] (x) dG' summed over the chunk's slots, a
//     thread taking 4 x 4 tiles of them (two float4 loads for 16 FMAs)
//     from the CTA's accumulators and back: in shared memory over all its
//     tiles and chunks where they fit STAGE_MAX, else (wide F or H) in
//     the CTA's slice of the partials buffer in global memory. Registers
//     hold no accumulator between phases, so that more CTAs fit an SM.
//     Then dx, items of up to 4 steps x 4 features: a frame whose two
//     directions' steps fall in one chunk is summed there (direction 0,
//     then 1) and stored; else the first chunk to reach it stores its
//     direction's share and the second adds its own to it (the same CTA,
//     after its barriers).
// The second launch adds the CTAs' weight partials in CTA order (a fixed
// tree of 8 groups a column) into dW_i, db_i, dW_h, db_hn. No float
// atomics: two calls on the same inputs give the same bits. FP32 FMAs, no
// tensor cores.
//
// Plan. Where the lanes of a stream-direction fit a warp (H <= 32), S =
// SERIAL_MAX / (D G) streams (every thread of a 128-thread CTA a serial
// lane), halved while the tiles would not cover the SMs (S = 1-2 at the
// decoder's 256 streams; then 128 threads still serve phases A and C);
// above H = 32 a CTA is one stream's D groups of whole warps. The walk is
// cut into the fewest equal chunks whose slots fit SMEM_BUDGET. The rows
// in shared memory are padded and their blocks skewed (the weights' rows by
// a float; the blocks of gradient, coefficient and dout rows; the operand
// rows) so that a warp's lanes meet no bank conflict at the training
// widths: at the encoder's 7,168-8,192 streams shared-memory traffic, not
// latency, is what the phases wait for (PERF.md).
//
// Bound on this card. Per valid stream-step and direction: the recomputed
// projections 6H(F + H) FLOP, the carry gradient 6H^2 and ~20H of gate
// algebra, and 6HF for dx, 6HF for dW_i and 6H^2 for dW_h; the bytes are
// x, the carries, the output gradient and the weights read once, dx and
// the weight gradients written once. At the training widths (F, H) =
// (16, 16), (32, 8), (8, 8) that is ~20-45 FLOP a byte, above the ~20
// FLOP/B ridge of 67 TFLOP/s over 3.35 TB/s: operations bound it. The T
// serial steps of phase B, a chain of shared-memory round trips and FMAs
// with a barrier a step, keep it from the bound (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <array>
#include <mutex>
#include <vector>

namespace {

constexpr int MAX_HIDDEN = 128;
constexpr int MAX_THREADS = 2 * MAX_HIDDEN;
constexpr int SERIAL_MAX = 128;     // serial lanes a CTA where H <= 32
constexpr int MIN_THREADS = 128;    // threads of phases A and C where the serial lanes are fewer
constexpr int UG = 4;               // steps a phase A2 item recomputes, sharing its weight loads
constexpr int STAGE_MAX = 48 * 1024;  // weight and accumulator bytes kept in shared memory
// Floats between consecutive (stream, direction) blocks of gradient rows,
// so that rows of different blocks fall in different banks (a block's
// rows are a multiple of 32 floats long at the training widths).
constexpr int GRAD_SKEW = 4;
constexpr int SMEM_BUDGET = 56 * 1024;
constexpr int NCOEF = 5;            // c_n, c_h, c_r, c_z, z
constexpr int REDUCE_GROUPS = 8;

struct Params {
  const float* x;              // (B, T, F)
  const unsigned char* mask;   // (B, T)
  const float* wi;             // (D, F, 3H)
  const float* bi;             // (D, 3H)
  const float* wh;             // (D, H, 3H)
  const float* wht;            // (D, 3H, H): W_h transposed
  const float* bhn;            // (D, H)
  const float* hs;             // (B, T, D, H): the carry each step starts from
  const float* dout;           // (B, T, D, H) or null (final carries only)
  const float* dfin;           // (B, D, H) or null
  float* dx;                   // (B, T, F)
  float* part;                 // (grid, D, R1 + R2, C3): the CTAs' weight-gradient partials
  int B, T, F, H, D, G, S, TC, rev_mask;
  int serial;                  // threads of phase B: S D G rounded up to a warp
  int R1, R2, H4, C3;          // rows of [x | 1] and [h | 1]; H and 3H rounded up to 4
  int n_tiles;                 // 4 x 4 accumulator tiles
  int staged;                  // whether the weights and accumulators sit in shared memory
};

// The forward kernel's gate functions (gru_scan.cu), so that the recomputed
// r, z, n are the ones the forward used.
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

__device__ __forceinline__ float tanh_sfu(float x) {
  return 2.0f * sigmoid(2.0f * x) - 1.0f;
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) / 4 * 4; }

// Floats a slot holds in each region; every region a multiple of 4.
struct Layout {
  int ops, grad, coef, dout;
};

__host__ __device__ __forceinline__ Layout layout(int F, int H) {
  Layout l;
  l.ops = round4(F + 1) + round4(H + 1);
  if (l.ops % 8 == 0) l.ops += 4;  // UG rows apart: other banks in phase A2
  l.grad = 4 * round4(H);
  l.coef = round4(NCOEF * H);
  l.dout = round4(H);
  return l;
}

// Floats of a (stream, direction) block of TC coefficient or dout rows: a
// multiple of 32 and then G more, so that the groups of a warp (serial
// lanes of other blocks) read other banks in phase B.
__host__ __device__ __forceinline__ int block_floats(int tc_floats, int G) {
  return (tc_floats + 31) / 32 * 32 + G % 32;
}

// Frame of backward-walk step u of direction d: a forward direction is
// walked from its last frame, a reverse one from its first.
__device__ __forceinline__ int frame(const Params& p, int d, int u) {
  return ((p.rev_mask >> d) & 1) ? u : p.T - 1 - u;
}

// Accumulator tile -> direction, first row and first column of the
// partials, and the offset of its four gradient columns in a slot's row.
__device__ __forceinline__ void tile_at(const Params& p, int tile, int& d, int& r0, int& c0, int& g_off) {
  const int ct_n = p.C3 / 4, rt_n = (p.R1 + p.R2) / 4;
  d = tile / (rt_n * ct_n);
  const int rem = tile - d * rt_n * ct_n;
  r0 = rem / ct_n * 4;
  c0 = (rem % ct_n) * 4;
  g_off = (r0 < p.R1 ? 0 : p.H4) + c0;  // dG = blocks 0-2, dG' = blocks 1-3
}

// Phase C2's products: o[r][k] += dG of step u_r of direction de (slots
// from slot0) against column k0 + k of W_i,de, over the 3H gate columns.
// Rows take steps v0 + r, or, with `uo`, step uo[r] where mode[r] == 1
// (the other direction's step at the same frame; other rows add nothing).
template <int RB>
__device__ __forceinline__ void dx_rows(const Params& p, const float* wi, const float* grad, const Layout& L,
                                        int slot0, int v0, int tc, int de, int k0, const int* uo,
                                        float (&o)[RB][4], const int* mode = nullptr) {
  const int F = p.F, H = p.H, H3 = 3 * H, H4 = p.H4;
  const float* gp[RB];
  float f[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int u = uo != nullptr ? uo[r] : min(v0 + r, tc - 1);
    gp[r] = grad + (size_t)(slot0 + u) * L.grad + slot0 / p.TC * GRAD_SKEW;
    f[r] = (mode == nullptr || mode[r] == 1) ? 1.0f : 0.0f;
  }
  const int WSi = p.staged ? H3 + 1 : H3;
  const float* wd = wi + (size_t)de * F * WSi;
#pragma unroll
  for (int gate = 0; gate < 3; ++gate) {
    const int blk = gate == 2 ? 0 : gate + 1;  // da_n is block 0, da_r 1, da_z 2
#pragma unroll 2
    for (int jn = 0; jn < H; ++jn) {
      const int c = gate * H + jn;
      float w[4], g[RB];
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = wd[(size_t)min(k0 + k, F - 1) * WSi + c];
#pragma unroll
      for (int r = 0; r < RB; ++r) g[r] = f[r] * gp[r][blk * H4 + jn];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) o[r][k] = fmaf(g[r], w[k], o[r][k]);
    }
  }
}

// Phase C2: dx for the chunk's steps, an item RB steps x 4 features of one
// stream-direction. Per row: its frame, the other direction's step there,
// and whether the row sums both directions (mode 1: the other direction's
// step is in this chunk; direction 0's row sums, direction 1's skips, -1),
// stores its own share (0: the other direction reaches the frame in a later
// chunk) or adds its share to the stored one (2: in an earlier chunk, of
// this CTA, behind its barriers).
template <int RB>
__device__ __forceinline__ void dx_items(const Params& p, const float* wi, const float* grad, const Layout& L,
                                         int b0, int nq, int u0, int tc, int tid, int nthreads) {
  const int T = p.T, F = p.F, D = p.D, TC = p.TC;
  const int vt_n = (tc + RB - 1) / RB, kt_n = (F + 3) / 4;
  for (int item = tid; item < nq * D * vt_n * kt_n; item += nthreads) {
    const int kt = item % kt_n;
    int rest = item / kt_n;
    const int vt = rest % vt_n;
    rest /= vt_n;
    const int dd = rest % D, qq = rest / D;
    const int od = D - 1 - dd;  // the other direction (itself where D = 1)
    const int k0 = kt * 4, v0 = vt * RB;
    int t_r[RB], uo[RB], mode[RB];
    bool both = false, any = false;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int u = min(v0 + r, tc - 1);
      t_r[r] = frame(p, dd, u0 + u);
      const int other = ((p.rev_mask >> od) & 1) ? t_r[r] : T - 1 - t_r[r];
      uo[r] = min(max(other - u0, 0), tc - 1);
      if (D == 1) mode[r] = 0;
      else if (other >= u0 && other < u0 + tc) mode[r] = dd == 0 ? 1 : -1;
      else mode[r] = other < u0 ? 2 : 0;
      both = both || (mode[r] == 1 && v0 + r < tc);
      any = any || (mode[r] >= 0 && v0 + r < tc);
    }
    if (!any) continue;
    float o[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) o[r][k] = 0.0f;
    dx_rows<RB>(p, wi, grad, L, (qq * D + dd) * TC, v0, tc, dd, k0, nullptr, o);
    if (both) dx_rows<RB>(p, wi, grad, L, (qq * D + od) * TC, 0, tc, od, k0, uo, o, mode);
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (v0 + r >= tc || mode[r] < 0) continue;
      float* row = p.dx + ((size_t)(b0 + qq) * T + t_r[r]) * F;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k0 + k < F) row[k0 + k] = mode[r] == 2 ? row[k0 + k] + o[r][k] : o[r][k];
    }
  }
}

// kStaged: the weights and the accumulators sit in shared memory (known to
// the compiler, so that their loads are shared-memory loads), else in
// global memory.
template <bool kStaged>
__global__ void __launch_bounds__(MAX_THREADS, 2) gru_bwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int T = p.T, F = p.F, H = p.H, D = p.D, G = p.G, S = p.S, TC = p.TC, H4 = p.H4;
  const int H3 = 3 * H, DH = D * H;
  const Layout L = layout(F, H);
  const int n_slots = S * D * TC;  // slot (q, d, u) at (q D + d) TC + u
  const int n_acc = D * (p.R1 + p.R2) * p.C3;
  const int WS = kStaged ? H3 + 1 : H3;  // row stride of W_i and W_h: padded in shared memory
  float* ops = smem + (kStaged ? round4(D * F * WS) + round4(D * H * WS) : 0);
  const int CB = block_floats(TC * L.coef, G), DB = block_floats(TC * L.dout, G);
  float* grad = ops + (size_t)n_slots * L.ops;
  float* coef = grad + (size_t)n_slots * L.grad + S * D * GRAD_SKEW;  // block qd at qd CB
  float* dbuf = coef + (size_t)S * D * CB;                             // block qd at qd DB
  float* mbuf = dbuf + (size_t)S * D * DB;
  // The weight-gradient accumulators: in shared memory after the slots, or
  // (wide F or H) the CTA's slice of the partials.
  float* accbuf = kStaged ? mbuf + round4(n_slots) : p.part + (size_t)blockIdx.x * n_acc;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // Serial lane (q, d, j): unit j of direction d of stream q; lanes past S
  // streams (a plan that halved S) are idle.
  const bool serial = tid < p.serial;
  const int q = tid / (D * G);
  const int d = (tid - q * D * G) / G;
  const int j = tid - q * D * G - d * G;
  const bool unit = serial && q < S && j < H;
  const int jj = unit ? j : 0;
  // The weights: staged in shared memory, the rows of W_i and W_h padded by
  // one float so that phase A2 (lanes reading a row's consecutive columns),
  // phase B (lanes reading column c of consecutive rows of W_h) and phase
  // C2 (column c of rows 4 apart of W_i) take no bank conflicts;
  // else read from global memory, phase B reading row j of W_h as a column
  // of its transposed copy.
  const float* wi = kStaged ? smem : p.wi;
  const float* wh = kStaged ? smem + round4(D * F * WS) : p.wh;
  if (kStaged) {
    for (int idx = tid; idx < D * F * H3; idx += nthreads) smem[idx / H3 * WS + idx % H3] = p.wi[idx];
    float* s_wh = smem + round4(D * F * WS);
    for (int idx = tid; idx < D * H * H3; idx += nthreads) s_wh[idx / H3 * WS + idx % H3] = p.wh[idx];
  }
  const float* whrow = kStaged ? wh + ((size_t)d * H + jj) * WS : p.wht + (size_t)d * H3 * H + jj;
  const int wstep = kStaged ? 1 : H;  // floats between W_h[d][j][c] and [c + 1] at whrow

  // The constant entries (the operand rows' ones and zero padding, the
  // gradient rows' padding) and the accumulators' zeros.
  for (int idx = tid; idx < n_slots * L.ops; idx += nthreads) {
    const int r = idx % L.ops;
    if (r >= F && (r < p.R1 || r >= p.R1 + H)) ops[idx] = (r == F || r == p.R1 + H) ? 1.0f : 0.0f;
  }
  for (int idx = tid; idx < n_slots * L.grad; idx += nthreads)
    if (idx % H4 >= H) grad[idx + idx / (TC * L.grad) * GRAD_SKEW] = 0.0f;
  for (int idx = tid; idx < n_acc; idx += nthreads) accbuf[idx] = 0.0f;

  // Phase A1's copies: VW floats each (16 bytes where F and H allow).
  const int VW = (F % 4 == 0 && H % 4 == 0) ? 4 : 1;
  const int fv = F / VW, hv = H / VW;
  const int per_slot_copy = fv + hv + (p.dout != nullptr ? hv : 0);

  const int ntiles = (p.B + S - 1) / S;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b0 = tile * S;
    const int nq = min(S, p.B - b0);
    const int bq = b0 + (q < nq ? q : 0);
    float dh = (p.dfin != nullptr && unit && q < nq) ? p.dfin[(size_t)bq * DH + d * H + j] : 0.0f;
    for (int u0 = 0; u0 < T; u0 += TC) {
      const int tc = min(TC, T - u0);
      __syncthreads();  // the last chunk's phase C has read the buffers
      // Phase A1: x, h and dout in flight at once; the masks.
      const int n_copy = nq * D * tc * per_slot_copy;
      for (int idx = tid; idx < n_copy; idx += nthreads) {
        const int e = idx % per_slot_copy, pair = idx / per_slot_copy;
        const int u = pair % tc, qd = pair / tc;
        const int dd = qd % D;
        const size_t row = (size_t)(b0 + qd / D) * T + frame(p, dd, u0 + u);
        const int slot = qd * TC + u;
        float* dst;
        const float* src;
        if (e < fv) {
          dst = ops + (size_t)slot * L.ops + e * VW;
          src = p.x + row * F + e * VW;
        } else if (e < fv + hv) {
          dst = ops + (size_t)slot * L.ops + p.R1 + (e - fv) * VW;
          src = p.hs + (row * D + dd) * H + (e - fv) * VW;
        } else {
          dst = dbuf + (size_t)qd * DB + u * L.dout + (e - fv - hv) * VW;
          src = p.dout + (row * D + dd) * H + (e - fv - hv) * VW;
        }
        const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(dst));
        if (VW == 4) {
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sa), "l"(src) : "memory");
        } else {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(sa), "l"(src) : "memory");
        }
      }
      for (int idx = tid; idx < S * D * tc; idx += nthreads) {
        const int u = idx % tc, qd = idx / tc;
        const int qq = qd / D;
        mbuf[qd * TC + u] = (qq < nq && p.mask[(size_t)(b0 + qq) * T + frame(p, qd % D, u0 + u)]) ? 1.0f : 0.0f;
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      // Phase A2: each (stream-direction, unit, group of UG steps)
      // recomputes the gates, each weight load serving the UG steps.
      const int ug_n = (tc + UG - 1) / UG;
      for (int idx = tid; idx < S * D * ug_n * H; idx += nthreads) {
        const int jn = idx % H, pair = idx / H;
        const int ug = pair % ug_n, qd = pair / ug_n;
        const int dd = qd % D;
        const int slot0 = qd * TC + ug * UG;
        const int ns = min(UG, tc - ug * UG);
        const float* wid = wi + (size_t)dd * F * WS + jn;
        const float* whd = wh + (size_t)dd * H * WS + jn;
        const float br = __ldg(p.bi + dd * H3 + jn), bz = __ldg(p.bi + dd * H3 + H + jn);
        const float bn = __ldg(p.bi + dd * H3 + 2 * H + jn), bh = __ldg(p.bhn + dd * H + jn);
        float ar[UG], az[UG], gn[UG], hn[UG];
#pragma unroll
        for (int s = 0; s < UG; ++s) { ar[s] = br; az[s] = bz; gn[s] = bn; hn[s] = bh; }
        const float* op = ops + (size_t)slot0 * L.ops;
#pragma unroll 2
        for (int k = 0; k < F; ++k) {
          const float* w = wid + (size_t)k * WS;
          const float wr = w[0], wz = w[H], wn = w[2 * H];
#pragma unroll
          for (int s = 0; s < UG; ++s) {
            const float v = op[(size_t)s * L.ops + k];
            ar[s] = fmaf(v, wr, ar[s]);
            az[s] = fmaf(v, wz, az[s]);
            gn[s] = fmaf(v, wn, gn[s]);
          }
        }
        const float* hp = op + p.R1;
#pragma unroll 2
        for (int k = 0; k < H; ++k) {
          const float* w = whd + (size_t)k * WS;
          const float wr = w[0], wz = w[H], wn = w[2 * H];
#pragma unroll
          for (int s = 0; s < UG; ++s) {
            const float v = hp[(size_t)s * L.ops + k];
            ar[s] = fmaf(v, wr, ar[s]);
            az[s] = fmaf(v, wz, az[s]);
            hn[s] = fmaf(v, wn, hn[s]);
          }
        }
#pragma unroll
        for (int s = 0; s < UG; ++s) {
          if (s >= ns) break;
          const int slot = slot0 + s;
          float* cf = coef + (size_t)qd * CB + (ug * UG + s) * L.coef + jn;
          if (mbuf[slot] == 0.0f) {
#pragma unroll
            for (int k = 0; k < NCOEF; ++k) cf[k * H] = 0.0f;
            continue;
          }
          const float r = sigmoid(ar[s]);
          const float z = sigmoid(az[s]);
          const float n = tanh_sfu(gn[s] + r * hn[s]);
          const float cn = (1.0f - z) * (1.0f - n * n);
          cf[0] = cn;                                                  // da_n = dh~ c_n
          cf[H] = cn * r;                                              // dHn
          cf[2 * H] = cn * hn[s] * r * (1.0f - r);                     // da_r
          cf[3 * H] = (hp[(size_t)s * L.ops + jn] - n) * z * (1.0f - z);  // da_z
          cf[4 * H] = z;
        }
      }
      __syncthreads();
      // Phase B: the serial chain.
      if (serial) {
        const bool live = unit && q < nq;
        const int slot0 = ((q < S ? q : 0) * D + d) * TC;
        for (int u = 0; u < tc; ++u) {
          const int slot = slot0 + u;
          const float* cf = coef + (size_t)(slot0 / TC) * CB + u * L.coef + jj;
          const bool m = mbuf[slot] != 0.0f;
          const float dht = (m && p.dout != nullptr) ? dh + dbuf[(size_t)(slot0 / TC) * DB + u * L.dout + jj] : dh;
          float* g = grad + (size_t)slot * L.grad + (slot0 / TC) * GRAD_SKEW;
          if (live) {
            g[j] = dht * cf[0];               // block 0: da_n
            g[H4 + j] = dht * cf[2 * H];      // block 1: da_r
            g[2 * H4 + j] = dht * cf[3 * H];  // block 2: da_z
            g[3 * H4 + j] = dht * cf[H];      // block 3: dHn
          }
          if (G <= 32) {
            __syncwarp();
          } else {  // the serial threads only: phases A and C may have more
            asm volatile("bar.sync 1, %0;" ::"r"(p.serial) : "memory");
          }
          // dh for the step before: z dh~ plus dG' against row j of W_h; a
          // masked step keeps dh.
          if (m) {
            const float* gh = g + H4;
            float a0 = cf[4 * H] * dht, a1 = 0.0f, a2 = 0.0f;
#pragma unroll 4
            for (int k = 0; k < H; ++k) {
              a0 = fmaf(gh[k], whrow[(size_t)k * wstep], a0);
              a1 = fmaf(gh[H4 + k], whrow[(size_t)(H + k) * wstep], a1);
              a2 = fmaf(gh[2 * H4 + k], whrow[(size_t)(2 * H + k) * wstep], a2);
            }
            dh = a0 + (a1 + a2);
          }
        }
      }
      __syncthreads();
      // Phase C1: the weight gradients, each thread's tiles read from the
      // accumulators, summed over the chunk's slots, written back.
      for (int t_i = tid; t_i < p.n_tiles; t_i += nthreads) {
        int dd, r0, c0, g_off;
        tile_at(p, t_i, dd, r0, c0, g_off);
        float* at = accbuf + ((size_t)dd * (p.R1 + p.R2) + r0) * p.C3 + c0;
        float acc[16];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(at + (size_t)r * p.C3);
          acc[4 * r] = v.x; acc[4 * r + 1] = v.y; acc[4 * r + 2] = v.z; acc[4 * r + 3] = v.w;
        }
        for (int qq = 0; qq < nq; ++qq) {
          const int slot0 = (qq * D + dd) * TC;
#pragma unroll 2
          for (int u = 0; u < tc; ++u) {
            const float4 a = *reinterpret_cast<const float4*>(ops + (size_t)(slot0 + u) * L.ops + r0);
            const float4 g = *reinterpret_cast<const float4*>(grad + (size_t)(slot0 + u) * L.grad +
                                                               (qq * D + dd) * GRAD_SKEW + g_off);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[4 * r + c] = fmaf(av[r], gv[c], acc[4 * r + c]);
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(at + (size_t)r * p.C3) =
              make_float4(acc[4 * r], acc[4 * r + 1], acc[4 * r + 2], acc[4 * r + 3]);
      }
      // Phase C2: dx, items of RB steps x 4 features: the largest RB (4 or
      // 2) whose items still give every thread one (larger items load less
      // a product), else 1.
      const int per_rows = nq * D * ((F + 3) / 4);
      if (per_rows * ((tc + 3) / 4) >= nthreads) {
        dx_items<4>(p, wi, grad, L, b0, nq, u0, tc, tid, nthreads);
      } else if (per_rows * ((tc + 1) / 2) >= nthreads) {
        dx_items<2>(p, wi, grad, L, b0, nq, u0, tc, tid, nthreads);
      } else {
        dx_items<1>(p, wi, grad, L, b0, nq, u0, tc, tid, nthreads);
      }
    }
  }
  if (kStaged) {
    __syncthreads();
    float* dst = p.part + (size_t)blockIdx.x * n_acc;
    for (int idx = tid; idx < n_acc; idx += nthreads) dst[idx] = accbuf[idx];
  }
}

// The second launch: 32 weight-gradient entries a CTA, each added over the
// CTAs' partials (REDUCE_GROUPS warps, warp w taking partials w, w + 8,
// ..., then the groups added in a fixed tree).
__global__ void __launch_bounds__(32 * REDUCE_GROUPS) gru_bwd_reduce(
    const float* __restrict__ part, int n_parts, int D, int F, int H, int R1, int R2, int H4, int C3,
    float* __restrict__ wout) {
  __shared__ float sums[REDUCE_GROUPS][32];
  const int H3 = 3 * H;
  const int n1 = D * F * H3, n2 = D * H3, n3 = D * H * H3, n4 = D * H;
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const bool valid = e < n1 + n2 + n3 + n4;
  // wout = [dW_i (D, F, 3H) | db_i (D, 3H) | dW_h (D, H, 3H) | db_hn (D, H)]:
  // entry -> (direction, partials row, gate, unit). The partials' columns
  // are blocks of H4: dG's rows (x, 1) hold [n | r | z], dG''s (h, 1) [r | z | hn].
  size_t idx = 0;
  if (valid) {
    int d, row, col;
    if (e < n1 + n2) {
      const bool bias = e >= n1;
      const int f = bias ? e - n1 : e;
      d = bias ? f / H3 : f / (F * H3);
      const int c = f % H3;
      row = bias ? F : (f % (F * H3)) / H3;
      const int gate = c / H;
      col = (gate == 2 ? 0 : gate + 1) * H4 + c % H;
    } else if (e < n1 + n2 + n3) {
      const int f = e - n1 - n2;
      d = f / (H * H3);
      const int c = f % H3;
      row = R1 + (f % (H * H3)) / H3;
      col = (c / H) * H4 + c % H;
    } else {
      const int f = e - n1 - n2 - n3;
      d = f / H;
      row = R1 + H;
      col = 2 * H4 + f % H;
    }
    idx = ((size_t)d * (R1 + R2) + row) * C3 + col;
  }
  const size_t stride = (size_t)D * (R1 + R2) * C3;
  float s = 0.0f;
  if (valid)
    for (int k = grp; k < n_parts; k += REDUCE_GROUPS) s += part[(size_t)k * stride + idx];
  sums[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && valid) {
    float t[REDUCE_GROUPS];
#pragma unroll
    for (int g = 0; g < REDUCE_GROUPS; ++g) t[g] = sums[g][lane];
#pragma unroll
    for (int w = 1; w < REDUCE_GROUPS; w *= 2)
#pragma unroll
      for (int g = 0; g + w < REDUCE_GROUPS; g += 2 * w) t[g] += t[g + w];
    wout[e] = t[0];
  }
}

struct Plan {
  int G, S, serial, threads, TC, per_sm, grid, staged, n_tiles;
  int R1, R2, H4, C3;
  size_t smem, part_floats;
};

bool valid(int B, int T, int F, int H, int D) {
  return H >= 1 && H <= MAX_HIDDEN && D >= 1 && D <= 2 && B >= 1 && T >= 1 && F >= 1;
}

// CTAs of the kernel resident per SM for a CTA shape, queried once per
// device and shape (the query costs more than a launch); the first query
// on a device also lets the kernel's CTAs take SMEM_BUDGET of dynamic
// shared memory.
int resident(int dev, bool staged, int threads, size_t smem, int* per_sm) {
  static std::mutex mu;
  static std::vector<std::array<long long, 5>> known;  // (device, staged, threads, smem, CTAs per SM)
  static std::vector<int> opted;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& k : known)
    if (k[0] == dev && k[1] == staged && k[2] == threads && k[3] == (long long)smem) {
      *per_sm = (int)k[4];
      return 0;
    }
  cudaError_t err = cudaSuccess;
  if (std::find(opted.begin(), opted.end(), dev) == opted.end()) {
    err = cudaFuncSetAttribute(gru_bwd_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BUDGET);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(gru_bwd_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BUDGET);
    if (err != cudaSuccess) return (int)err;
    opted.push_back(dev);
  }
  err = staged ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, gru_bwd_kernel<true>, threads, smem)
               : cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, gru_bwd_kernel<false>, threads, smem);
  if (err != cudaSuccess) return (int)err;
  known.push_back({dev, staged, threads, (long long)smem, *per_sm});
  return 0;
}

int plan(int B, int T, int F, int H, int D, Plan& pl) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int g = 1;
  while (g < H) g *= 2;
  if (g <= 32) {
    pl.G = g;
    pl.S = SERIAL_MAX / (D * g) > 1 ? SERIAL_MAX / (D * g) : 1;
    while (pl.S > 1 && (B + pl.S - 1) / pl.S < sms) pl.S /= 2;
  } else {
    pl.G = (H + 31) / 32 * 32;
    pl.S = 1;
  }
  pl.serial = (pl.S * D * pl.G + 31) / 32 * 32;
  pl.threads = pl.serial > MIN_THREADS ? pl.serial : MIN_THREADS;
  pl.R1 = round4(F + 1);
  pl.R2 = round4(H + 1);
  pl.H4 = round4(H);
  pl.C3 = 3 * pl.H4;
  pl.n_tiles = D * (pl.R1 + pl.R2) / 4 * (pl.C3 / 4);
  const size_t acc_bytes = (size_t)D * (pl.R1 + pl.R2) * pl.C3 * sizeof(float);
  const size_t w_bytes = (size_t)(round4(D * F * (3 * H + 1)) + round4(D * H * (3 * H + 1))) * sizeof(float);
  pl.staged = acc_bytes + w_bytes <= (size_t)STAGE_MAX;
  const Layout L = layout(F, H);
  // A chunk of tc steps: the slots' rows, the coefficient and dout blocks,
  // the masks (rounded up to 4), the gradient blocks' skew; the staged
  // weights and accumulators.
  const int sd = pl.S * D;
  auto smem_of = [&](int tc) {
    const size_t floats = (size_t)sd * tc * (L.ops + L.grad) + (size_t)sd * GRAD_SKEW +
                          (size_t)sd * (block_floats(tc * L.coef, pl.G) + block_floats(tc * L.dout, pl.G)) +
                          round4(sd * tc);
    return floats * sizeof(float) + (pl.staged ? acc_bytes + w_bytes : 0);
  };
  int fit = T;
  while (fit > 0 && smem_of(fit) > (size_t)SMEM_BUDGET) --fit;
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (T + fit - 1) / fit;
  pl.TC = (T + chunks - 1) / chunks;
  pl.smem = smem_of(pl.TC);
  err = (cudaError_t)resident(dev, pl.staged, pl.threads, pl.smem, &pl.per_sm);
  if (err != cudaSuccess) return (int)err;
  if (pl.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ntiles = (B + pl.S - 1) / pl.S;
  pl.grid = ntiles < pl.per_sm * sms ? ntiles : pl.per_sm * sms;
  pl.part_floats = (size_t)pl.grid * D * (pl.R1 + pl.R2) * pl.C3;
  return 0;
}

}  // namespace

// The launch plan for this shape on the current device: info = {streams
// per CTA, threads per CTA, shared-memory bytes per CTA, CTAs resident per
// SM, CTAs launched, steps a chunk, chunks a walk, the scratch floats (the
// CTAs' partials), the threads of the serial phase, whether the weights
// and the weight-gradient accumulators are staged in shared memory (else
// the launch reads `wht`, W_h transposed, and accumulates into the CTA's
// partial in global memory)}. Returns a CUDA error code.
extern "C" int gru_scan_bwd_config(int B, int T, int F, int H, int D, long long* info) {
  if (!valid(B, T, F, H, D)) return (int)cudaErrorInvalidValue;
  Plan pl;
  const int err = plan(B, T, F, H, D, pl);
  if (err != 0) return err;
  info[0] = pl.S;
  info[1] = pl.threads;
  info[2] = (long long)pl.smem;
  info[3] = pl.per_sm;
  info[4] = pl.grid;
  info[5] = pl.TC;
  info[6] = (T + pl.TC - 1) / pl.TC;
  info[7] = (long long)pl.part_floats;
  info[8] = pl.serial;
  info[9] = pl.staged;
  return 0;
}

// Two launches on `stream`, without synchronising: the kernel, then the
// reduction of its partials into wout = [dW_i (D, F, 3H) | db_i (D, 3H) |
// dW_h (D, H, 3H) | db_hn (D, H)]. `scratch` holds the floats
// gru_scan_bwd_config reports. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int gru_scan_bwd_launch(
    const float* x, const unsigned char* mask, const float* wi, const float* bi,
    const float* wh, const float* wht, const float* bhn, const float* hs, const float* dout,
    const float* dfin, float* dx, float* wout, float* scratch, int B, int T, int F, int H, int D,
    int rev_mask, void* stream) {
  if (!valid(B, T, F, H, D)) return (int)cudaErrorInvalidValue;
  Plan pl;
  const int err = plan(B, T, F, H, D, pl);
  if (err != 0) return err;
  Params p;
  p.x = x; p.mask = mask; p.wi = wi; p.bi = bi; p.wh = wh; p.wht = wht; p.bhn = bhn;
  p.hs = hs; p.dout = dout; p.dfin = dfin; p.dx = dx; p.part = scratch;
  p.B = B; p.T = T; p.F = F; p.H = H; p.D = D; p.G = pl.G; p.S = pl.S; p.TC = pl.TC; p.serial = pl.serial;
  p.rev_mask = rev_mask;
  p.R1 = pl.R1; p.R2 = pl.R2; p.H4 = pl.H4; p.C3 = pl.C3;
  p.n_tiles = pl.n_tiles; p.staged = pl.staged;
  const cudaStream_t st = (cudaStream_t)stream;
  if (pl.staged) {
    gru_bwd_kernel<true><<<pl.grid, pl.threads, pl.smem, st>>>(p);
  } else {
    gru_bwd_kernel<false><<<pl.grid, pl.threads, pl.smem, st>>>(p);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_w = D * (F * 3 * H + 3 * H + H * 3 * H + H);
  gru_bwd_reduce<<<(n_w + 31) / 32, 32 * REDUCE_GROUPS, 0, st>>>(scratch, pl.grid, D, F, H, pl.R1, pl.R2, pl.H4,
                                                                  pl.C3, wout);
  return (int)cudaGetLastError();
}
