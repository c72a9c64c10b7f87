// The blend-kernel lab, version 2: alternative arithmetic forms of the
// per-tile forward blend (L1) and the moments form of its backward (L2),
// designed for Hopper. Version 1, the first simple design, is kept as a
// yardstick in csrc/blend_lab_v1.cu.
//
// Replaces the Pallas kernels of tools/kernel_lab.py:
//   L1  variant_blend (kernel factories _make_kernel, _make_storew_kernel,
//       _make_pair2_kernel; variants nocond, acc8, trimat, mxu, lean,
//       storew, pairN)
//   L2  moments_bwd
//
// Layout as in blend.cu: one block per tile (pairN: N tiles), one thread per
// pixel (tile_w * tile_h threads, a multiple of 32), props (T, L, 10) float32
// with the columns [mu_x, mu_y, conic_a, conic_b, conic_c, r, g, b, opacity,
// z], entries in depth order.
//
// The functions are those of the plain versions in ops/blend_lab.py:
// L1 computes color (T,3,P), depth (T,P) and alpha (T,P) over the entries
// [0, 32 * ceil(count / 32)) of each tile (pairN: the largest such range of
// its N tiles), in chunks of 32 with no mask, so the props past `count` must
// be zero (what the binning's gather gives); rows past L read as zero. Within
// a chunk t_in = t_run * (exclusive product over the chunk), or in log space
// (trimat) t_run * exp(inclusive log-sum - log1p(-alpha)); an entry adds
// weight alpha * t_in while t_in >= t_min; t_run takes the chunk's product at
// its end. The forms: power direct (dx, dy) or as rank-6 coefficients against
// the tile-local monomials [lx^2, lx ly, ly^2, lx, ly, 1] (mxu, lean);
// transmittance as a product or in log space (trimat); weighted sums in
// registers or from weights staged in shared memory and contracted against
// [r, g, b, z, 1] afterwards (lean: 32 entries at a time, storew: 64). acc8
// runs nocond's code (it differs only in the TPU's sublane partial sums).
// L2 is the props gradient of the blend from K1's residuals (t_final, n_done
// per pixel), with the per-entry pixel reductions taken as moments against
// the tile-centred basis [1, bx, by, bx^2, bx by, by^2] (d_power), the sum of
// d_opacity, and w against [gD, gC0, gC1, gC2]; d_mean and d_conic follow
// from the moments in fp64 (kernel_lab.py:562-581).
//
// What bounds them on an H100: the instruction rate of the (entry, pixel)
// pairs whose alpha is not 0 (an expf and ~30 flops each in L1, ~60 and a
// share of the per-entry warp reduction in L2), and the latency of each
// pair's dependent chain; reads are one pass over props. Version 1 evaluated
// every pair up to the tile's last chunk (L1) or last multiplied-in entry
// (L2), with -fmad=false throughout, and L2 held 129 KB of shared memory per
// block (one block of 8 warps per SM) and finished every chunk in 32 threads.
// Version 2 takes over what made blend.cu's version 2 fast:
//  - entries are staged through shared memory in batches, padded to 12
//    floats and read as three float4, double-buffered with cp.async; the
//    two pad floats hold the entry's reach (entry_reach: the box outside
//    which alpha < alpha_min), computed from global memory while the batch
//    lands. The rank-6 forms stage their six coefficients beside it;
//  - each warp ballots 32 entries at a time against its 16 x 2 strip and
//    walks only the entries that reach it (pairN: a ballot per tile, the N
//    tiles' walks interleaved as independent instruction streams);
//  - power, alpha and the transmittance updates are rounded by hand
//    (__fmul_rn / __fadd_rn / __fsub_rn, expf, log1pf, IEEE divisions), in
//    the plain version's order, so they round exactly as there; the file is
//    compiled without -fmad=false, so the sums and gradients contract to FMA.
// Both skips are exact for L1's outputs. An entry that misses the strip has
// alpha 0 at all its pixels: it multiplies the chunk product by exactly 1.0
// (adds log1pf(-0) = 0 in log space) and adds no weight. Once a pixel's
// t_run * (chunk product) < t_min, every later t_in is below t_min too (the
// factors are <= 1 and rounding is monotone), so all its later weights are 0:
// the pixel stops, tested once per 32-entry chunk (a vote per warp and, at
// each batch end, per tile). In log space the exclusive sum is recomputed as
// (inclusive - log1pf) and may come back up by an ulp of a chunk's log-sum
// (|sum| <= 32 x 4.61 at alpha's 0.99 clamp: < 2e-5 relative in t_in), so a
// trimat pixel stops only once t_run < t_min (1 - 1e-3).
// The reach box is derived from the direct power. The rank-6 power rounds
// otherwise: its terms are ~ca (|m| + 22)^2 for a mean at |m| pixels from the
// strip (the tile's monomials reach 15 px, its corner 22 px from any strip
// pixel), so its absolute error is ~4 eps ca (|m| + 22)^2, 1.5e-4 at ca = 1
// and |m| = 3 (the box edge of an opaque 1 px footprint). The box's margins
// (tau +1%, det -1e-3 (|ac| + b^2), widths x1.001 + 0.01 px) move the power at
// its edge by at least 0.005 tau + 0.01 sqrt(ca tau) >= 0.03 at ca = 1; the
// error reaches that margin only at ca ~ 8e4 (footprints of 0.004 px, which
// the projection's 0.3 px low-pass rules out). tests/test_torch_blend.py
// holds a plain twin of entry_reach against both power forms on the lab
// scene and on edge inputs.
//
// L2's pixel pass is K2 version 2's replay (transmittance divided out entry
// by entry, IEEE, over exactly the n_done entries K1 multiplied in; skip of
// the entries no lane multiplied in, that miss the strip, or whose alpha is
// 0 at every lane). Each lane forms its pixel's 11 moment terms for the entry
// as fp32 products (bx, by are half-integers: their products are exact), the
// warp sums them with 13 shuffles (warp_sum, the transposed reduction of
// blend.cu's warp_sum10 for any count) into one row per warp, and the block
// combines the warps' rows in a fixed order in fp64 once per batch of 64
// entries, four threads per entry deriving d_mean and d_conic in fp64
// (deterministic: no atomics). Accuracy: the conic gradients are small
// differences of large moments (d_cb = -(Sxy - my Sx - mx Sy + mx my S0));
// the basis centred on the tile keeps the terms small, a 5-level shuffle tree
// has an error bound ~2.5x version 1's Kahan sums over 32 pixels, and the
// fp64 combination adds none; chip_smoke.py counts the entries outside
// tolerance against float64 autograd for both versions in the same run.
// storew's staged weights are 64 x P floats (64 KB at 256 pixels); it stages
// its entries in batches of 64 (6 KB), 70 KB a block, so an SM holds 3.

#include <cuda_runtime.h>

namespace {

constexpr int D = 10;            // props columns
constexpr int DS = 12;           // an entry's floats in shared memory (3 x float4)
constexpr int CS = 8;            // a rank-6 entry's coefficient floats (2 x float4)
constexpr int CHUNK = 32;        // L1's chunk: one ballot word
constexpr int NMOM = 11;         // L2's moments per entry
constexpr int BWD_BATCH = 64;    // entries staged per batch in L2
constexpr int MAX_THREADS = 1024;
// registers per thread: 40 lets 6 blocks of 256 threads share an SM (as K1);
// pairN holds N tiles' sums; L2 at 48 (as K2, 5 blocks an SM) spills 28
// bytes of its 11 moment terms and still ran faster than at 56 (4 blocks,
// 40 bytes) or 64 (PERF.md, Findings)
constexpr int FWD_REGS = 40;
constexpr int PAIR_REGS = 64;
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

// The helpers below are those of blend.cu (version 2 of K1-K3), which this
// file does not include so that each source builds on its own.

// Half-widths (rx, ry) of the box around an entry's mean outside which its
// alpha is 0 at every pixel: alpha >= alpha_min needs o e^power >= alpha_min,
// i.e. d^T [[a, b], [b, c]] d <= tau = 2 ln(o / alpha_min), an ellipse of
// half-widths sqrt(tau c / det) and sqrt(tau a / det), with margins (tau up
// by 1%, det down by 1e-3 of |a c| + b^2, widths up by 0.1% and 0.01 px). -inf:
// the entry reaches no pixel (o < alpha_min); +inf or NaN: no bound, nothing
// is skipped. ops/blend.py::entry_reach_reference is its plain twin.
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

// The rank-6 coefficients [ca/2, cb, cc/2, c3, c4, c5] of the staged rows
// [0, n) against the tile-local monomials (origin ox, oy), rounded in the
// plain version's order (ops/blend_lab.py::_chunk_alpha), from global memory.
__device__ __forceinline__ void stage_coefs(float* dst, const float* __restrict__ src, int n,
                                            float ox, float oy) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float* e = src + i * D;
    const float mx = __fsub_rn(__ldg(e), ox), my = __fsub_rn(__ldg(e + 1), oy);
    const float ca = __ldg(e + 2), cb = __ldg(e + 3), cc = __ldg(e + 4);
    const float c0 = __fmul_rn(0.5f, ca), c2 = __fmul_rn(0.5f, cc);
    const float c3 = -__fadd_rn(__fmul_rn(ca, mx), __fmul_rn(cb, my));
    const float c4 = -__fadd_rn(__fmul_rn(cb, mx), __fmul_rn(cc, my));
    const float c5 = __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(c0, mx), mx),
                                         __fmul_rn(__fmul_rn(cb, mx), my)),
                               __fmul_rn(__fmul_rn(c2, my), my));
    float4* c = reinterpret_cast<float4*>(dst + i * CS);
    c[0] = make_float4(c0, cb, c2, c3);
    c[1] = make_float4(c4, c5, 0.0f, 0.0f);
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

// alpha from the power (min(clamp, o e^power), cut at power > 0 or below
// alpha_min), with G = e^power; rounded as written
__device__ __forceinline__ float alpha_of(float power, float op, float alpha_clamp,
                                          float alpha_min, float* G) {
  *G = expf(power);
  float a = fminf(alpha_clamp, __fmul_rn(op, *G));
  if (power > 0.0f || a < alpha_min) a = 0.0f;
  return a;
}

// the direct power at offset (dx, dy) from the mean, in the plain version's order
__device__ __forceinline__ float direct_power(float ca, float cb, float cc, float dx, float dy) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx), __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
}

// the rank-6 power from the staged coefficients (c0 = [ca/2, cb, cc/2, c3],
// c1 = [c4, c5, -, -]) at tile-local (lx, ly), monomials m = lx^2, lx ly, ly^2
__device__ __forceinline__ float rank6_power(const float4& c0, const float4& c1, float m0,
                                             float m1, float m2, float lx, float ly) {
  float q = __fadd_rn(__fmul_rn(c0.x, m0), __fmul_rn(c0.y, m1));
  q = __fadd_rn(q, __fmul_rn(c0.z, m2));
  q = __fadd_rn(q, __fmul_rn(c0.w, lx));
  q = __fadd_rn(q, __fmul_rn(c1.x, ly));
  return -__fadd_rn(q, c1.y);
}

// ---------------------------------------------------------------- L1

// one tile's state at one pixel
struct LabPixel {
  float t_run = 1.0f;  // transmittance at the chunk's start
  float tr;            // chunk product (or inclusive log-sum, trimat) so far
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, dz = 0.0f, wa = 0.0f;
  bool done = false;
};

template <bool RANK6, bool LOGT, int STAGE, int NT, int BATCH>
__device__ __forceinline__ void lab_fwd(const float* __restrict__ props,
                                        const int* __restrict__ counts, int l_max, int tx_n,
                                        int tile_w, int tile_h, float alpha_clamp,
                                        float alpha_min, float t_min,
                                        float* __restrict__ color, float* __restrict__ depth,
                                        float* __restrict__ alpha_out) {
  static_assert(!(RANK6 || STAGE) || NT == 1, "rank-6 and staged forms run one tile a block");
  static_assert(BATCH % CHUNK == 0 && (STAGE == 0 || BATCH % STAGE == 0), "batch layout");
  extern __shared__ float4 smem4[];
  float* staged = reinterpret_cast<float*>(smem4);  // [2][NT][BATCH][DS]
  float* coefs = staged + 2 * NT * BATCH * DS;      // [BATCH][CS] (rank-6)
  float* sw = coefs + (RANK6 ? BATCH * CS : 0);     // [STAGE][P] weights (staged forms)
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int lane = p & 31;
  const int t0 = blockIdx.x * NT;
  const int lxi = p % tile_w, lyi = p / tile_w;
  const float lx = static_cast<float>(lxi), ly = static_cast<float>(lyi);
  const float m0 = lx * lx, m1 = lx * ly, m2 = ly * ly;  // exact: small integers
  const float4 strip0 = warp_strip(lxi, lyi);          // tile-local
  const float t_stop = LOGT ? t_min * (1.0f - 1e-3f) : t_min;
  float ox[NT], oy[NT];
  LabPixel pix[NT];
  int n_chunks = 0;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    ox[i] = static_cast<float>(((t0 + i) % tx_n) * tile_w);
    oy[i] = static_cast<float>(((t0 + i) / tx_n) * tile_h);
    n_chunks = max(n_chunks, (counts[t0 + i] + CHUNK - 1) / CHUNK);
  }
  const int n_ent = min(n_chunks * CHUNK, l_max);  // rows past L are zero: factor 1

  auto stage_batch = [&](float* buf, int base, int nb) {
#pragma unroll
    for (int i = 0; i < NT; ++i)
      stage(buf + i * BATCH * DS, props + (static_cast<size_t>(t0 + i) * l_max + base) * D, nb);
  };
  if (n_ent > 0) stage_batch(staged, 0, min(BATCH, n_ent));
  cp_async_commit();
  for (int base = 0, k = 0; base < n_ent; base += BATCH, ++k) {
    const int nb = min(BATCH, n_ent - base);
    const int next = base + BATCH;
    float* buf = staged + (k & 1) * NT * BATCH * DS;
    if (next < n_ent) stage_batch(staged + ((k + 1) & 1) * NT * BATCH * DS, next,
                                  min(BATCH, n_ent - next));
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const float* src = props + (static_cast<size_t>(t0 + i) * l_max + base) * D;
      stage_reach(buf + i * BATCH * DS, src, nb, alpha_min);
      if constexpr (RANK6) stage_coefs(coefs, src, nb, ox[i], oy[i]);
    }
    cp_async_wait<1>();  // batch k has landed (for this thread's copies) ...
    __syncthreads();     // ... and for everyone's, with its reach and coefficients
    const float4* cf = reinterpret_cast<const float4*>(coefs);
    bool all_done = true;
#pragma unroll
    for (int i = 0; i < NT; ++i) all_done = all_done && pix[i].done;
    bool warp_done = __all_sync(FULL, all_done);
    unsigned long long walked = 0;  // staged forms: the ballots since the last contraction
    for (int j0 = 0; j0 < nb && !warp_done; j0 += CHUNK) {
      const int jl = j0 + lane;
      unsigned reach[NT];
      unsigned any = 0;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        const float4* eb = reinterpret_cast<const float4*>(buf + i * BATCH * DS);
        const float4 strip = make_float4(strip0.x + ox[i], strip0.y + oy[i], strip0.z, strip0.w);
        reach[i] = __ballot_sync(FULL, jl < nb && !misses(strip, eb[3 * jl], eb[3 * jl + 2]));
        any |= reach[i];
        pix[i].tr = LOGT ? 0.0f : 1.0f;
      }
      if constexpr (STAGE > 0) walked |= static_cast<unsigned long long>(reach[0]) << (j0 % STAGE);
      // the entries that reach the strip, in order; the N tiles' walks interleaved
      while (any) {
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          if (!reach[i]) continue;  // warp-uniform
          const int j = j0 + __ffs(reach[i]) - 1;
          reach[i] &= reach[i] - 1;
          LabPixel& px = pix[i];
          if (px.done) {
            if constexpr (STAGE > 0) sw[(j % STAGE) * P + p] = 0.0f;
            continue;
          }
          const float4* eb = reinterpret_cast<const float4*>(buf + i * BATCH * DS);
          const float4 e0 = eb[3 * j], e1 = eb[3 * j + 1], e2 = eb[3 * j + 2];
          float power;
          if constexpr (RANK6) {
            power = rank6_power(cf[2 * j], cf[2 * j + 1], m0, m1, m2, lx, ly);
          } else {
            power = direct_power(e0.z, e0.w, e1.x, __fsub_rn(ox[i] + lx, e0.x),
                                 __fsub_rn(oy[i] + ly, e0.y));
          }
          float G;
          const float a = alpha_of(power, e2.x, alpha_clamp, alpha_min, &G);
          float t_in;
          if constexpr (LOGT) {
            const float lom = log1pf(-a);
            px.tr = __fadd_rn(px.tr, lom);
            t_in = __fmul_rn(px.t_run, expf(__fsub_rn(px.tr, lom)));
          } else {
            t_in = __fmul_rn(px.t_run, px.tr);
            px.tr = __fmul_rn(px.tr, __fsub_rn(1.0f, a));
          }
          const float w = t_in >= t_min ? __fmul_rn(a, t_in) : 0.0f;
          if constexpr (STAGE > 0) {
            sw[(j % STAGE) * P + p] = w;
          } else {
            px.cr += w * e1.y;
            px.cg += w * e1.z;
            px.cb += w * e1.w;
            px.dz += w * e2.y;
            px.wa += w;
          }
        }
        any = 0;
#pragma unroll
        for (int i = 0; i < NT; ++i) any |= reach[i];
      }
      // the chunk's end: t_run takes its product; the saturation vote
      all_done = true;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        LabPixel& px = pix[i];
        if (!px.done) {
          px.t_run = __fmul_rn(px.t_run, LOGT ? expf(px.tr) : px.tr);
          px.done = px.t_run < t_stop;
        }
        all_done = all_done && px.done;
      }
      warp_done = __all_sync(FULL, all_done);
      if constexpr (STAGE > 0) {
        // contract the staged weights against [r, g, b, z, 1] once STAGE
        // entries are staged, at the batch's end, or when the warp stops;
        // each thread reads only its own pixel's weights, over the same bits
        if (warp_done || j0 + CHUNK >= nb || (j0 + CHUNK) % STAGE == 0) {
          const float4* eb = reinterpret_cast<const float4*>(buf);
          const int s0 = j0 - j0 % STAGE;
          LabPixel& px = pix[0];
          while (walked) {
            const int j = s0 + __ffsll(static_cast<long long>(walked)) - 1;
            walked &= walked - 1;
            const float w = sw[(j % STAGE) * P + p];
            const float4 e1 = eb[3 * j + 1], e2 = eb[3 * j + 2];
            px.cr += w * e1.y;
            px.cg += w * e1.z;
            px.cb += w * e1.w;
            px.dz += w * e2.y;
            px.wa += w;
          }
        }
      }
    }
    // every warp is past batch k: its buffers may be restaged
    all_done = true;
#pragma unroll
    for (int i = 0; i < NT; ++i) all_done = all_done && pix[i].done;
    if (__syncthreads_count(!all_done) == 0) break;  // the tiles are saturated
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const size_t t = static_cast<size_t>(t0 + i);
    color[t * 3 * P + p] = pix[i].cr;
    color[t * 3 * P + P + p] = pix[i].cg;
    color[t * 3 * P + 2 * P + p] = pix[i].cb;
    depth[t * P + p] = pix[i].dz;
    alpha_out[t * P + p] = pix[i].wa;
  }
}

#define LAB_FWD_PARAMS                                                                     \
  const float *__restrict__ props, const int *__restrict__ counts, int l_max, int tx_n,   \
      int tile_w, int tile_h, float alpha_clamp, float alpha_min, float t_min,            \
      float *__restrict__ color, float *__restrict__ depth, float *__restrict__ alpha_out
#define LAB_FWD_ARGS \
  props, counts, l_max, tx_n, tile_w, tile_h, alpha_clamp, alpha_min, t_min, color, depth, alpha_out

// one tile a block: nocond/acc8, trimat, mxu, lean, storew
template <bool RANK6, bool LOGT, int STAGE, int BATCH>
__global__ void __maxnreg__(FWD_REGS) lab_fwd_kernel(LAB_FWD_PARAMS) {
  lab_fwd<RANK6, LOGT, STAGE, 1, BATCH>(LAB_FWD_ARGS);
}

// N tiles a block: pair2, pair4
template <int NT>
__global__ void __maxnreg__(PAIR_REGS) lab_fwd_pair_kernel(LAB_FWD_PARAMS) {
  lab_fwd<false, false, 0, NT, 64>(LAB_FWD_ARGS);
}

template <bool RANK6, int STAGE, int NT, int BATCH, typename Kernel>
int launch_fwd(Kernel kernel, const float* props, const int* counts, int n_tiles, int l_max,
               int tx_n, int tile_w, int tile_h, float alpha_clamp, float alpha_min,
               float t_min, float* color, float* depth, float* alpha, cudaStream_t s) {
  const int P = tile_w * tile_h;
  const size_t smem = sizeof(float) * (static_cast<size_t>(2) * NT * BATCH * DS +
                                       (RANK6 ? BATCH * CS : 0) + static_cast<size_t>(STAGE) * P);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_tiles / NT, P, smem, s>>>(props, counts, l_max, tx_n, tile_w, tile_h, alpha_clamp,
                                       alpha_min, t_min, color, depth, alpha);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- L2

// Sums each of the N values over the warp's 32 lanes by a transposed
// reduction (blend.cu's warp_sum10 for any N up to 16): at the level of lane
// mask M (16, 8, 4, 2) the lanes `lane` and `lane ^ M` split the values each
// holds, each keeps one half (the lane with bit M the upper) and adds its
// partner's copy of it; a last shuffle adds lane ^ 1. Even lanes then hold
// the warp sum of column warp_column<N>(lane), odd lanes repeat it. 11 values
// take 13 shuffles.
template <int N, int M = 16>
__device__ __forceinline__ float warp_sum(const float (&v)[N], int lane) {
  constexpr int H = (N + 1) / 2;
  const bool hi = lane & M;
  float u[H];
#pragma unroll
  for (int s = 0; s < H; ++s) {
    const float lo_v = v[s];
    const float hi_v = s + H < N ? v[(s + H) % N] : 0.0f;  // past N: a padding slot
    u[s] = (hi ? hi_v : lo_v) + __shfl_xor_sync(FULL, hi ? lo_v : hi_v, M);
  }
  if constexpr (M == 2) {
    static_assert(H == 1, "warp_sum takes at most 16 values");
    return u[0] + __shfl_xor_sync(FULL, u[0], 1);
  } else {
    return warp_sum<H, M / 2>(u, lane);
  }
}

// the column (below N) whose sum warp_sum<N, M> leaves in `lane`, or -1 for
// a padding slot
template <int N, int M = 16>
__device__ __forceinline__ int warp_sum_slot(int lane) {
  constexpr int H = (N + 1) / 2;
  int sub = 0;
  if constexpr (M > 2) sub = warp_sum_slot<H, M / 2>(lane);
  if (sub < 0) return -1;
  const int col = (lane & M ? H : 0) + sub;
  return col < N ? col : -1;
}

// the column an even lane writes after warp_sum<N>; -1 for odd lanes
template <int N>
__device__ __forceinline__ int warp_column(int lane) {
  return (lane & 1) ? -1 : warp_sum_slot<N>(lane);
}

struct MomPixel {
  float T, S = 0.0f;  // transmittance after the entries still to replay; S = sum of later w (f . g)
  float gr, gg, gb, gd, ga;
  int nd;
};

// the moment terms of one entry (alpha a > 0, G = e^power) at a pixel of
// tile-centred basis (bx, by), as the replay steps back over it
__device__ __forceinline__ void moments_step(MomPixel& px, float (&v)[NMOM], const float4& e1,
                                             const float4& e2, float bx, float by, float a,
                                             float G, float alpha_clamp) {
  const float om = __fsub_rn(1.0f, a);
  const float T_ex = px.T / om;  // transmittance before this entry
  const float w = a * T_ex;
  const float dl_dw = e1.y * px.gr + e1.z * px.gg + e1.w * px.gb + e2.y * px.gd + px.ga;
  if (a < alpha_clamp) {
    const float d_alpha = T_ex * dl_dw - px.S / om;
    const float d_pow = d_alpha * a;
    v[0] = d_pow;
    v[1] = d_pow * bx;
    v[2] = d_pow * by;
    v[3] = d_pow * (bx * bx);
    v[4] = d_pow * (bx * by);
    v[5] = d_pow * (by * by);
    v[6] = d_alpha * G;
  }
  v[7] = w * px.gd;
  v[8] = w * px.gr;
  v[9] = w * px.gg;
  v[10] = w * px.gb;
  px.S += w * dl_dw;
  px.T = T_ex;
}

// d_props of one entry (`part` 0-3 of its columns) from its moments, summed
// over the warps' rows (row stride BWD_BATCH * NMOM) in a fixed order in fp64
__device__ __forceinline__ void moments_derive(const float* __restrict__ rows, int n_warps,
                                               const float* __restrict__ e, float* __restrict__ d,
                                               double cx, double cy, int part) {
  auto M = [&](int c) {
    double s = 0.0;
    for (int w = 0; w < n_warps; ++w) s += static_cast<double>(rows[w * BWD_BATCH * NMOM + c]);
    return s;
  };
  // the mean in the basis' frame, and the conic
  const double mx = static_cast<double>(__ldg(e)) - cx;
  const double my = static_cast<double>(__ldg(e + 1)) - cy;
  const double ca = __ldg(e + 2), cb = __ldg(e + 3), cc = __ldg(e + 4);
  if (part == 0) {
    const double S0 = M(0), Sx = M(1), Sy = M(2);
    d[0] = static_cast<float>(ca * (Sx - mx * S0) + cb * (Sy - my * S0));
    d[1] = static_cast<float>(cc * (Sy - my * S0) + cb * (Sx - mx * S0));
  } else if (part == 1) {
    const double S0 = M(0), Sx = M(1), Sy = M(2), Sxx = M(3), Sxy = M(4);
    d[2] = static_cast<float>(-0.5 * (Sxx - 2.0 * mx * Sx + mx * mx * S0));
    d[3] = static_cast<float>(-(Sxy - my * Sx - mx * Sy + mx * my * S0));
  } else if (part == 2) {
    const double S0 = M(0), Sy = M(2), Syy = M(5);
    d[4] = static_cast<float>(-0.5 * (Syy - 2.0 * my * Sy + my * my * S0));
    d[9] = static_cast<float>(M(7));
  } else {
    d[5] = static_cast<float>(M(8));
    d[6] = static_cast<float>(M(9));
    d[7] = static_cast<float>(M(10));
    d[8] = static_cast<float>(M(6));
  }
}

__global__ void __maxnreg__(BWD_REGS)
    lab_moments_bwd_kernel(const float* __restrict__ props, int l_max, int tx_n, int tile_w,
                           int tile_h, float alpha_clamp, float alpha_min,
                           const float* __restrict__ t_final, const int* __restrict__ n_done,
                           const float* __restrict__ g_color, const float* __restrict__ g_depth,
                           const float* __restrict__ g_alpha, float* __restrict__ d_props) {
  extern __shared__ float4 smem4[];
  __shared__ int s_nd[MAX_THREADS / 32];
  float* staged = reinterpret_cast<float*>(smem4);  // [2][BWD_BATCH][DS]
  float* rows = staged + 2 * BWD_BATCH * DS;         // [warps][BWD_BATCH][NMOM] per-warp sums
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = P >> 5;
  const int column = warp_column<NMOM>(lane);
  const int ix = (t % tx_n) * tile_w + p % tile_w, iy = (t / tx_n) * tile_h + p / tile_w;
  const float px = static_cast<float>(ix), py = static_cast<float>(iy);
  const float4 strip = warp_strip(ix, iy);
  // the basis' origin (the tile's centre) and this pixel's half-integer coordinates in it
  const float hx = 0.5f * static_cast<float>(tile_w - 1), hy = 0.5f * static_cast<float>(tile_h - 1);
  const float bx = static_cast<float>(p % tile_w) - hx, by = static_cast<float>(p / tile_w) - hy;
  const double cx = static_cast<double>((t % tx_n) * tile_w) + hx;
  const double cy = static_cast<double>((t / tx_n) * tile_h) + hy;
  const float* tp = props + static_cast<size_t>(t) * l_max * D;
  float* dp = d_props + static_cast<size_t>(t) * l_max * D;

  const size_t o = static_cast<size_t>(t) * P + p;
  MomPixel pix;
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
  float* row = rows + warp * BWD_BATCH * NMOM;
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
    for (int i = lane; i < nb * NMOM; i += 32) row[i] = 0.0f;
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
        float a = 0.0f, G = 0.0f;
        if (base + j < pix.nd)
          a = alpha_of(direct_power(e0.z, e0.w, e1.x, __fsub_rn(px, e0.x), __fsub_rn(py, e0.y)),
                       e2.x, alpha_clamp, alpha_min, &G);
        if (__any_sync(FULL, a > 0.0f)) {  // warp-uniform
          float v[NMOM];
#pragma unroll
          for (int c = 0; c < NMOM; ++c) v[c] = 0.0f;
          if (a > 0.0f) moments_step(pix, v, e1, e2, bx, by, a, G, alpha_clamp);
          const float sum = warp_sum(v, lane);
          if (column >= 0) row[j * NMOM + column] = sum;
        }
      }
    }
    __syncthreads();  // every warp's row of batch k is written
    // four threads an entry derive its d_props from the rows; the entry's
    // mean and conic are read from global memory (its staged copy may be
    // restaged while a slower thread still derives)
    for (int i = p; i < 4 * BWD_BATCH; i += P) {
      const int j = i % BWD_BATCH;
      if (j < nb)
        moments_derive(rows + j * NMOM, n_warps, tp + (base + j) * D, dp + (base + j) * D, cx,
                       cy, i / BWD_BATCH);
    }
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" {

// variant: 0 nocond/acc8, 1 trimat, 2 mxu, 3 lean, 4 storew, 5 pair2, 6 pair4
int lab_blend_fwd(int variant, const float* props, const int* counts, int n_tiles, int l_max,
                  int tx_n, int tile_w, int tile_h, float alpha_clamp, float alpha_min,
                  float t_min, float* color, float* depth, float* alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
#define LAB_ARGS props, counts, n_tiles, l_max, tx_n, tile_w, tile_h, alpha_clamp, alpha_min, \
                 t_min, color, depth, alpha, s
  switch (variant) {
    case 0: return launch_fwd<false, 0, 1, 128>(lab_fwd_kernel<false, false, 0, 128>, LAB_ARGS);
    case 1: return launch_fwd<false, 0, 1, 128>(lab_fwd_kernel<false, true, 0, 128>, LAB_ARGS);
    case 2: return launch_fwd<true, 0, 1, 128>(lab_fwd_kernel<true, false, 0, 128>, LAB_ARGS);
    case 3: return launch_fwd<true, 32, 1, 128>(lab_fwd_kernel<true, false, 32, 128>, LAB_ARGS);
    case 4: return launch_fwd<false, 64, 1, 64>(lab_fwd_kernel<false, false, 64, 64>, LAB_ARGS);
    case 5: return launch_fwd<false, 0, 2, 64>(lab_fwd_pair_kernel<2>, LAB_ARGS);
    case 6: return launch_fwd<false, 0, 4, 64>(lab_fwd_pair_kernel<4>, LAB_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAB_ARGS
}

int lab_moments_bwd(const float* props, int n_tiles, int l_max, int tx_n, int tile_w, int tile_h,
                    float alpha_clamp, float alpha_min, const float* t_final, const int* n_done,
                    const float* g_color, const float* g_depth, const float* g_alpha,
                    float* d_props, void* stream) {
  const int P = tile_w * tile_h;
  const size_t smem = (2 * BWD_BATCH * DS + (P / 32) * BWD_BATCH * NMOM) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lab_moments_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lab_moments_bwd_kernel<<<n_tiles, P, smem, s>>>(props, l_max, tx_n, tile_w, tile_h,
                                                  alpha_clamp, alpha_min, t_final, n_done,
                                                  g_color, g_depth, g_alpha, d_props);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
