// Per-tile front-to-back alpha blending of depth-sorted Gaussian entries:
// the forward (K1), the forward with per-entry touch counts (K3), and the
// back-to-front replay backward (K2). Version 2; version 1, the first simple
// design, is kept as a yardstick in csrc/blend_v1.cu.
//
// Replaces the Pallas kernels of monogs_dev_tpu/ops/blend_pallas.py:
//   K1  _blend_fwd_kernel (emit_touch=False), via blend_tiles_pallas
//   K3  _blend_fwd_kernel (emit_touch=True),  via blend_tiles_pallas_touch
//   K2  _blend_bwd_kernel, via _bwd_rule
//
// props is (T, L, 10) float32 with the columns [mu_x, mu_y, conic_a,
// conic_b, conic_c, r, g, b, opacity, z]. Semantics (shared with the plain
// version in ops/blend.py):
//   power = -0.5 * (a dx^2 + c dy^2) - b dx dy,  alpha = min(clamp, o e^power)
//   alpha = 0 where power > 0 or alpha < alpha_min
//   an entry contributes while the exclusive transmittance T >= t_min; its
//   weight is alpha * T. A pixel stops multiplying once T < t_min: nothing
//   after that point can contribute, so the outputs do not change, and its
//   final transmittance stays >= t_min * (1 - clamp), far from underflow.
// The forward saves per pixel the final T and the number of entries it
// multiplied in (n_done); the backward divides (1 - alpha) back out of T over
// exactly those entries.
//
// What bounds it on an H100: the instruction rate of the (entry, pixel)
// pairs each tile evaluates (an expf and ~25 flops each in the forward, ~60
// flops and a share of the per-entry warp reductions in the backward), and
// the latency of each pair's dependent chain where a tile holds few
// entries. Reads are one pass over props (24.6 MB at VGA, L = 512), far
// under the instruction time. Design:
//  - one block per tile, one thread per pixel: a warp covers a 16 x 2 strip
//    of a 16 x 16 tile. (Two pixels per thread, which shares each staged
//    read and each warp reduction over 64 pixels, halves the warps an SM
//    holds for 1,200 VGA tiles; on the card it was slower on every prop
//    set for K1 and no faster for K2: PERF.md, Findings.)
//  - entries are staged through shared memory in batches, padded to 12
//    floats and read as three float4, double-buffered with cp.async (batch
//    k + 1 is in flight while batch k is blended);
//  - alpha is computed by one function (entry_alpha) with every operation
//    rounded as written (__fmul_rn/__fadd_rn/__fsub_rn, expf), so it rounds
//    exactly as in the plain version in all three kernels: touch counts
//    match it bit for bit and K2 divides out exactly the factors K1
//    multiplied in. The file is compiled without -fmad=false, so the
//    accumulations and the gradients contract to FMA;
//  - a warp passes over the entries whose reach (the box outside which
//    alpha is below alpha_min, with wide margins; entry_reach, computed once
//    per staged entry into the two pad floats) misses its strip: alpha
//    would be 0 at all its pixels, so only n_done moves. The warp ballots
//    32 entries at a time and walks the set bits only, so an entry it
//    passes over costs it no instruction of its own;
//  - the forward stops a warp once all its pixels are saturated (tested
//    every 32 entries), and the tile once all its warps are
//    (__syncthreads_count at each batch end);
//  - K2 also passes over the entries that no pixel of the warp multiplied
//    in, and skips the gradient of an entry when no lane has alpha > 0 for
//    it (exact: alpha = 0 gives a zero gradient and leaves T and S
//    unchanged). It sums the 10 gradient columns over the warp with 12
//    shuffles (warp_sum10, in place of ten 5-shuffle trees) and writes one
//    row per warp to shared memory; the block adds the warps' rows once per
//    batch, in a fixed order (no atomics: deterministic), and writes d_props
//    coalesced. The divisions by (1 - alpha) stay IEEE.
// Not tensor cores: no product of the blend fits them at fp32 accuracy. The
// conic power as a rank-6 TF32 product (the kernel lab's mxu form) would put
// ~1e-3 relative error into power, breaking the 3e-5 colour tolerance and
// the equality of touch counts.

#include <cuda_runtime.h>

namespace {

constexpr int D = 10;            // props columns
constexpr int DS = 12;           // an entry's floats in shared memory (3 x float4)
constexpr int FWD_BATCH = 128;   // entries staged per batch in K1/K3
constexpr int BWD_BATCH = 64;    // entries staged per batch in K2
constexpr int MAX_THREADS = 1024;
// registers per thread: 40 lets 6 blocks of 256 threads share an SM (no
// spills in K1/K3), 48 lets K2 hold 5 (no spills; ptxas picks 55 unbounded)
constexpr int FWD_REGS = 40;
constexpr int BWD_REGS = 48;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying entries [0, n) of src (stride D floats) into dst (stride DS);
// the caller commits. Columns 10 and 11 are filled by `stage_reach`.
__device__ __forceinline__ void stage(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int e = i / D;
    cp_async4(dst + e * DS + (i - e * D), src + i);
  }
}

// Half-widths (rx, ry) of the box around an entry's mean outside which its
// alpha is 0 at every pixel: alpha >= alpha_min needs o e^power >= alpha_min,
// i.e. d^T [[a, b], [b, c]] d <= tau = 2 ln(o / alpha_min), an ellipse of
// half-widths sqrt(tau c / det) and sqrt(tau a / det). The margins (tau up
// by 1%, det down by 1e-3 of |a c| + b^2, widths up by 0.1% and 0.01 px)
// lie far above the roundings of the kernels' power and of these fast
// intrinsics, so skipping a pixel outside the box changes nothing. -inf: the
// entry reaches no pixel (o < alpha_min, so alpha = min(clamp, o e^power) <=
// o is cut); +inf or NaN: no bound (a conic that is not positive definite or
// too elongated, NaN inputs), and nothing is skipped.
__device__ __forceinline__ float2 entry_reach(float ca, float cb, float cc, float op,
                                              float alpha_min) {
  const float inf = __int_as_float(0x7f800000);
  if (op < alpha_min) return make_float2(-inf, -inf);
  const float tau = 2.02f * __logf(__fdividef(op, alpha_min)) + 1e-3f;
  const float det_lo = ca * cc - cb * cb - 1e-3f * (fabsf(ca * cc) + cb * cb);
  if (!(alpha_min > 0.0f && ca > 0.0f && cc > 0.0f && det_lo > 0.0f && tau > 0.0f))
    return make_float2(inf, inf);
  const float s = __fdividef(tau, det_lo);
  const float x = s * cc, y = s * ca;
  return make_float2(1.001f * x * rsqrtf(x) + 0.01f, 1.001f * y * rsqrtf(y) + 0.01f);
}

// Fill columns 10, 11 of the staged rows [0, n) with their entries' reach,
// read from global memory (src, stride D), so that the batch need not have
// landed; the next __syncthreads publishes them.
__device__ __forceinline__ void stage_reach(float* dst, const float* __restrict__ src, int n,
                                            float alpha_min) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* e = src + i * D;
    const float2 r = entry_reach(__ldg(e + 2), __ldg(e + 3), __ldg(e + 4), __ldg(e + 8),
                                 alpha_min);
    dst[i * DS + 10] = r.x;
    dst[i * DS + 11] = r.y;
  }
}

// The rectangle of pixel centres a warp covers: (centre x, centre y,
// half-width, half-height); warp-uniform.
__device__ __forceinline__ float4 warp_strip(int x, int y) {
  const int x_lo = __reduce_min_sync(FULL, x), x_hi = __reduce_max_sync(FULL, x);
  const int y_lo = __reduce_min_sync(FULL, y), y_hi = __reduce_max_sync(FULL, y);
  return make_float4(0.5f * (x_lo + x_hi), 0.5f * (y_lo + y_hi), 0.5f * (x_hi - x_lo),
                     0.5f * (y_hi - y_lo));
}

// true if the entry (e0 = [mu_x, mu_y, ..], e2 = [.., .., rx, ry]) reaches no
// pixel of the strip: its alpha is 0 at all of them
__device__ __forceinline__ bool misses(const float4& strip, const float4& e0, const float4& e2) {
  return fabsf(e0.x - strip.x) - strip.z > e2.z || fabsf(e0.y - strip.y) - strip.w > e2.w;
}

// alpha of the entry (conic ca, cb, cc; opacity op) at offset (dx, dy) from
// its mean, and G = e^power. Every operation is rounded as written, in the
// plain version's order, so the three kernels and the plain version agree on
// alpha bit for bit (FMA contraction would change its last bits).
__device__ __forceinline__ float entry_alpha(float ca, float cb, float cc, float op, float dx,
                                             float dy, float alpha_clamp, float alpha_min,
                                             float* G) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx), __fmul_rn(__fmul_rn(cc, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
  *G = expf(power);
  float a = fminf(alpha_clamp, __fmul_rn(op, *G));
  if (power > 0.0f || a < alpha_min) a = 0.0f;
  return a;
}

struct FwdPixel {
  float T = 1.0f, cr = 0.0f, cg = 0.0f, cb = 0.0f, dz = 0.0f, wa = 0.0f;
  int nd = 0;
  bool done = false;
};

// one entry (e0 = [mu_x, mu_y, ca, cb], e1 = [cc, r, g, b], e2 = [o, z, rx, ry])
// blended into a pixel that is not done; returns 1 if it touched the pixel
__device__ __forceinline__ int fwd_step(FwdPixel& px, const float4& e0, const float4& e1,
                                        const float4& e2, float dx, float dy, int idx,
                                        float alpha_clamp, float alpha_min, float t_min) {
  float G;
  const float a = entry_alpha(e0.z, e0.w, e1.x, e2.x, dx, dy, alpha_clamp, alpha_min, &G);
  const float w = a * px.T;
  px.cr += w * e1.y;
  px.cg += w * e1.z;
  px.cb += w * e1.w;
  px.dz += w * e2.y;
  px.wa += w;
  px.T = __fmul_rn(px.T, __fsub_rn(1.0f, a));
  px.nd = idx + 1;
  px.done = px.T < t_min;
  return a >= alpha_min;
}

template <bool TOUCH>
__global__ void __maxnreg__(FWD_REGS)
    blend_fwd_kernel_v2(const float* __restrict__ props, const int* __restrict__ counts,
                        int l_max, int tx_n, int tile_w, int tile_h, float alpha_clamp,
                        float alpha_min, float t_min, float* __restrict__ color,
                        float* __restrict__ depth, float* __restrict__ alpha_out,
                        float* __restrict__ t_final, int* __restrict__ n_done,
                        int* __restrict__ touch) {
  extern __shared__ float4 smem4[];
  float* staged = reinterpret_cast<float*>(smem4);                        // [2][FWD_BATCH][DS]
  int* warp_touch = reinterpret_cast<int*>(staged + 2 * FWD_BATCH * DS);  // [warps][FWD_BATCH]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = P >> 5;
  const int count = counts[t];
  const int ix = (t % tx_n) * tile_w + p % tile_w, iy = (t / tx_n) * tile_h + p / tile_w;
  const float px = static_cast<float>(ix), py = static_cast<float>(iy);
  const float4 strip = warp_strip(ix, iy);
  const float* tp = props + static_cast<size_t>(t) * l_max * D;

  if (TOUCH)
    for (int i = p; i < n_warps * FWD_BATCH; i += P) warp_touch[i] = 0;
  FwdPixel pix;

  if (count > 0) stage(staged, tp, min(FWD_BATCH, count));
  cp_async_commit();
  for (int base = 0, k = 0; base < count; base += FWD_BATCH, ++k) {
    const int nb = min(FWD_BATCH, count - base);
    const int next = base + FWD_BATCH;
    float* buf = staged + (k & 1) * FWD_BATCH * DS;
    if (next < count)
      stage(staged + ((k + 1) & 1) * FWD_BATCH * DS, tp + next * D, min(FWD_BATCH, count - next));
    cp_async_commit();
    stage_reach(buf, tp + base * D, nb, alpha_min);
    cp_async_wait<1>();  // batch k has landed (for this thread's copies) ...
    __syncthreads();     // ... and for everyone's, with its reach
    const float4* eb = reinterpret_cast<const float4*>(buf);
    // The entries that reach the warp's strip, 32 at a time as a ballot;
    // the others have alpha 0 at all its pixels and are passed over: only
    // n_done moves past them (below), and the warp's touch count stays 0.
    // The warp stops at the first 32 entries that find it saturated (a
    // test per entry would lengthen every entry's dependent chain).
    for (int j0 = 0; j0 < nb; j0 += 32) {
      if (__all_sync(FULL, pix.done)) break;  // warp-uniform
      const int jl = j0 + lane;
      unsigned reach = __ballot_sync(FULL, jl < nb && !misses(strip, eb[3 * jl], eb[3 * jl + 2]));
      while (reach) {
        const int j = j0 + __ffs(reach) - 1;
        reach &= reach - 1;
        const float4 e0 = eb[3 * j], e1 = eb[3 * j + 1], e2 = eb[3 * j + 2];
        int hit = 0;
        if (!pix.done)
          hit = fwd_step(pix, e0, e1, e2, __fsub_rn(px, e0.x), __fsub_rn(py, e0.y), base + j,
                         alpha_clamp, alpha_min, t_min);
        if (TOUCH) {
          const int s = __reduce_add_sync(FULL, hit);
          if (lane == 0) warp_touch[warp * FWD_BATCH + j] = s;
        }
      }
    }
    if (!pix.done) pix.nd = base + nb;  // an open pixel multiplied in the whole batch
    // every warp is past batch k: its buffer may be restaged, its counts read
    const int open = __syncthreads_count(!pix.done);
    if (TOUCH) {
      for (int i = p; i < nb; i += P) {
        int s = 0;
        for (int w = 0; w < n_warps; ++w) {
          s += warp_touch[w * FWD_BATCH + i];
          warp_touch[w * FWD_BATCH + i] = 0;
        }
        touch[static_cast<size_t>(t) * l_max + base + i] = s;
      }
    }
    if (open == 0) break;  // tile saturated
  }
  cp_async_wait<0>();

  const size_t o = static_cast<size_t>(t) * P + p;
  color[static_cast<size_t>(t) * 3 * P + p] = pix.cr;
  color[static_cast<size_t>(t) * 3 * P + P + p] = pix.cg;
  color[static_cast<size_t>(t) * 3 * P + 2 * P + p] = pix.cb;
  depth[o] = pix.dz;
  alpha_out[o] = pix.wa;
  t_final[o] = pix.T;
  n_done[o] = pix.nd;
}

// Sums each of the 10 values over the warp's 32 lanes with 12 shuffles: at
// each step the lanes `lane` and `lane ^ m` (m = 16, 8, 4, 2) split the
// values each holds, each keeps one half and adds its partner's copy of it
// (5, 3, 2, 1 values; an odd count leaves one slot empty on one side); a
// last shuffle adds lane ^ 1. Even lane l then holds the warp sum of column
// sum10_column(l), or nothing (-1); odd lanes repeat their even neighbour.
__device__ __forceinline__ float warp_sum10(const float (&v)[D], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float u[5];
#pragma unroll
  for (int s = 0; s < 5; ++s)  // columns 0-4 (b4 = 0) or 5-9 (b4 = 1)
    u[s] = (b4 ? v[s + 5] : v[s]) + __shfl_xor_sync(FULL, b4 ? v[s] : v[s + 5], 16);
  float w[3];  // u slots {0, 1, 2} (b3 = 0) or {3, 4, -} (b3 = 1)
  w[0] = (b3 ? u[3] : u[0]) + __shfl_xor_sync(FULL, b3 ? u[0] : u[3], 8);
  w[1] = (b3 ? u[4] : u[1]) + __shfl_xor_sync(FULL, b3 ? u[1] : u[4], 8);
  w[2] = (b3 ? 0.0f : u[2]) + __shfl_xor_sync(FULL, b3 ? u[2] : 0.0f, 8);
  float x[2];  // w slots {0, 1} (b2 = 0) or {2, -} (b2 = 1)
  x[0] = (b2 ? w[2] : w[0]) + __shfl_xor_sync(FULL, b2 ? w[0] : w[2], 4);
  x[1] = (b2 ? 0.0f : w[1]) + __shfl_xor_sync(FULL, b2 ? w[1] : 0.0f, 4);
  float y = (b1 ? x[1] : x[0]) + __shfl_xor_sync(FULL, b1 ? x[0] : x[1], 2);
  return y + __shfl_xor_sync(FULL, y, 1);
}

// the column whose warp sum warp_sum10 leaves in `lane`, or -1
__device__ __forceinline__ int sum10_column(int lane) {
  const int b1 = (lane >> 1) & 1, b2 = (lane >> 2) & 1, b3 = (lane >> 3) & 1, b4 = lane >> 4;
  if ((lane & 1) || (b2 && b1)) return -1;
  const int w_slot = b2 ? 2 : b1;
  if (b3 && w_slot == 2) return -1;
  return 5 * b4 + (b3 ? 3 + w_slot : w_slot);
}

struct BwdPixel {
  float T, S = 0.0f;  // transmittance after the entries still to replay; S = sum of later w (f . g)
  float gr, gg, gb, gd, ga;
  int nd;
};

// the gradient of one entry (alpha a > 0, G = e^power) at a pixel, added to
// v (the props columns), as the replay steps back over it
__device__ __forceinline__ void bwd_step(BwdPixel& px, float (&v)[D], const float4& e0,
                                         const float4& e1, const float4& e2, float dx, float dy,
                                         float a, float G, float alpha_clamp) {
  const float om = __fsub_rn(1.0f, a);
  const float T_ex = px.T / om;  // transmittance before this entry
  const float w = a * T_ex;
  const float dl_dw = e1.y * px.gr + e1.z * px.gg + e1.w * px.gb + e2.y * px.gd + px.ga;
  if (a < alpha_clamp) {
    const float d_alpha = T_ex * dl_dw - px.S / om;
    const float d_pow = d_alpha * a;
    v[0] += d_pow * (e0.z * dx + e0.w * dy);
    v[1] += d_pow * (e1.x * dy + e0.w * dx);
    v[2] += d_pow * (-0.5f * dx * dx);
    v[3] += d_pow * (-dx * dy);
    v[4] += d_pow * (-0.5f * dy * dy);
    v[8] += d_alpha * G;
  }
  v[5] += w * px.gr;
  v[6] += w * px.gg;
  v[7] += w * px.gb;
  v[9] += w * px.gd;
  px.S += w * dl_dw;
  px.T = T_ex;
}

__global__ void __maxnreg__(BWD_REGS)
    blend_bwd_kernel_v2(const float* __restrict__ props, int l_max, int tx_n, int tile_w,
                        int tile_h, float alpha_clamp, float alpha_min,
                        const float* __restrict__ t_final, const int* __restrict__ n_done,
                        const float* __restrict__ g_color, const float* __restrict__ g_depth,
                        const float* __restrict__ g_alpha, float* __restrict__ d_props) {
  extern __shared__ float4 smem4[];
  __shared__ int s_nd[MAX_THREADS / 32];
  float* staged = reinterpret_cast<float*>(smem4);  // [2][BWD_BATCH][DS]
  float* rows = staged + 2 * BWD_BATCH * DS;         // [warps][BWD_BATCH][D] per-warp sums
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = P >> 5;
  const int column = sum10_column(lane);
  const int ix = (t % tx_n) * tile_w + p % tile_w, iy = (t / tx_n) * tile_h + p / tile_w;
  const float px = static_cast<float>(ix), py = static_cast<float>(iy);
  const float4 strip = warp_strip(ix, iy);
  const float* tp = props + static_cast<size_t>(t) * l_max * D;
  float* dp = d_props + static_cast<size_t>(t) * l_max * D;

  const size_t o = static_cast<size_t>(t) * P + p;
  BwdPixel pix;
  pix.nd = n_done[o];
  pix.T = t_final[o];
  pix.gr = g_color[static_cast<size_t>(t) * 3 * P + p];
  pix.gg = g_color[static_cast<size_t>(t) * 3 * P + P + p];
  pix.gb = g_color[static_cast<size_t>(t) * 3 * P + 2 * P + p];
  pix.gd = g_depth[o];
  pix.ga = g_alpha[o];
  const int nd_warp = __reduce_max_sync(FULL, pix.nd);
  if (lane == 0) s_nd[warp] = nd_warp;
  __syncthreads();
  int nd_max = 0;
  for (int w = 0; w < n_warps; ++w) nd_max = max(nd_max, s_nd[w]);

  if (nd_max > 0) stage(staged, tp + max(0, nd_max - BWD_BATCH) * D, min(BWD_BATCH, nd_max));
  cp_async_commit();
  float* row = rows + warp * BWD_BATCH * D;
  for (int end = nd_max, k = 0; end > 0; end -= BWD_BATCH, ++k) {
    const int base = max(0, end - BWD_BATCH);
    const int nb = end - base;
    float* buf = staged + (k & 1) * BWD_BATCH * DS;
    if (base > 0) {
      const int prev = max(0, base - BWD_BATCH);
      stage(staged + ((k + 1) & 1) * BWD_BATCH * DS, tp + prev * D, base - prev);
    }
    cp_async_commit();
    stage_reach(buf, tp + base * D, nb, alpha_min);
    cp_async_wait<1>();
    __syncthreads();
    const float4* eb = reinterpret_cast<const float4*>(buf);
    for (int i = lane; i < nb * D; i += 32) row[i] = 0.0f;
    __syncwarp();
    // Back to front over the entries that some pixel of the warp multiplied
    // in and that reach its strip, 32 at a time as a ballot; the others add
    // nothing (alpha 0 at all its pixels) and leave T and S as they are.
    for (int j0 = ((nb - 1) / 32) * 32; j0 >= 0; j0 -= 32) {
      const int jl = j0 + lane;
      unsigned need = __ballot_sync(FULL, jl < nb && base + jl < nd_warp &&
                                              !misses(strip, eb[3 * jl], eb[3 * jl + 2]));
      while (need) {
        const int b = 31 - __clz(need);
        need ^= 1u << b;
        const int j = j0 + b;
        const float4 e0 = eb[3 * j], e1 = eb[3 * j + 1], e2 = eb[3 * j + 2];
        const float dx = __fsub_rn(px, e0.x), dy = __fsub_rn(py, e0.y);
        float a = 0.0f, G = 0.0f;
        if (base + j < pix.nd)
          a = entry_alpha(e0.z, e0.w, e1.x, e2.x, dx, dy, alpha_clamp, alpha_min, &G);
        if (__any_sync(FULL, a > 0.0f)) {  // warp-uniform
          float v[D];
#pragma unroll
          for (int c = 0; c < D; ++c) v[c] = 0.0f;
          if (a > 0.0f) bwd_step(pix, v, e0, e1, e2, dx, dy, a, G, alpha_clamp);
          const float sum = warp_sum10(v, lane);
          if (column >= 0) row[j * D + column] = sum;
        }
      }
    }
    __syncthreads();  // every warp's row of batch k is written
    for (int i = p; i < nb * D; i += P) {
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w) s += rows[w * BWD_BATCH * D + i];
      dp[base * D + i] = s;
    }
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" {

int blend_fwd(const float* props, const int* counts, int n_tiles, int l_max, int tx_n,
              int tile_w, int tile_h, float alpha_clamp, float alpha_min, float t_min,
              float* color, float* depth, float* alpha, float* t_final, int* n_done,
              int* touch, void* stream) {
  const int P = tile_w * tile_h;
  size_t smem = 2 * FWD_BATCH * DS * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    if (touch != nullptr) {
      smem += (P / 32) * FWD_BATCH * sizeof(int);
      blend_fwd_kernel_v2<true><<<n_tiles, P, smem, s>>>(
          props, counts, l_max, tx_n, tile_w, tile_h, alpha_clamp, alpha_min, t_min, color,
          depth, alpha, t_final, n_done, touch);
    } else {
      blend_fwd_kernel_v2<false><<<n_tiles, P, smem, s>>>(
          props, counts, l_max, tx_n, tile_w, tile_h, alpha_clamp, alpha_min, t_min, color,
          depth, alpha, t_final, n_done, nullptr);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int blend_bwd(const float* props, int n_tiles, int l_max, int tx_n, int tile_w, int tile_h,
              float alpha_clamp, float alpha_min, const float* t_final, const int* n_done,
              const float* g_color, const float* g_depth, const float* g_alpha,
              float* d_props, void* stream) {
  const int P = tile_w * tile_h;
  const size_t smem = (2 * BWD_BATCH * DS + (P / 32) * BWD_BATCH * D) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024)  // tiles over 512 pixels: more than the default dynamic limit
    cudaFuncSetAttribute(blend_bwd_kernel_v2, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  if (n_tiles > 0) {
    blend_bwd_kernel_v2<<<n_tiles, P, smem, s>>>(
        props, l_max, tx_n, tile_w, tile_h, alpha_clamp, alpha_min, t_final, n_done, g_color,
        g_depth, g_alpha, d_props);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
