// The blend-kernel lab: alternative arithmetic forms of the per-tile forward
// blend (L1) and the moments form of its backward (L2).
//
// Replaces the Pallas kernels of tools/kernel_lab.py:
//   L1  variant_blend (kernel factories _make_kernel, _make_storew_kernel,
//       _make_pair2_kernel; variants nocond, acc8, trimat, mxu, lean,
//       storew, pairN)
//   L2  moments_bwd
//
// Layout as in blend.cu: one thread per pixel of a tile (tile_w * tile_h
// threads, a multiple of 32), props (T, L, 10) float32 with the columns
// [mu_x, mu_y, conic_a, conic_b, conic_c, r, g, b, opacity, z]. Entries are
// processed in chunks of CHUNK = 32 in depth order.
//
// L1 computes color (T,3,P), depth (T,P) and alpha (T,P) over the entries
// [0, 32 * ceil(count / 32)) of each tile, with no early exit and no mask:
// like the TPU variants, it reads whole chunks past `count`, so the props
// there must be zero (what the binning's gather gives). Rows past L read as
// zero. One kernel, templated on three choices:
//   power form     direct dx, dy (nocond, acc8, trimat, storew, pairN), or
//                  rank-6 coefficients of the conic quadratic against the
//                  tile-local pixel monomials [lx^2, lx ly, ly^2, lx, ly, 1]
//                  (mxu, lean; kernel_lab.py _chunk_coefs/_pixel_monomials);
//   transmittance  a running product (all but trimat), or log space,
//                  exp(sum log1p(-alpha)) (trimat);
//   accumulation   per-pixel registers, or weights staged in shared memory
//                  and contracted against [r, g, b, z, 1] once per staged
//                  batch (lean: 32 entries, storew: 64). The TPU storew keeps
//                  a whole-tile (L, P) weight buffer, 512 KB at L = 512; a
//                  block has at most 227 KB of shared memory, so here the
//                  weights are staged and contracted per batch of entries.
// acc8 differs from nocond only in the TPU's sublane partial sums and runs
// nocond's code. pairN runs N tiles per block, each thread one pixel of each
// of the N tiles, as N interleaved independent instruction streams (the
// second stream the TPU variant wanted); the N tiles share the larger chunk
// count, which the zero props past `count` make harmless.
// Within a chunk the transmittance is the chunk-start value times the
// exclusive product over the chunk (t_in = t_run * excl), as in the TPU
// variants; an entry contributes while t_in >= t_min.
//
// L2 is K2's gradient with the per-entry pixel reductions done as moments:
// per chunk, walking the chunks back to front, each thread forms its pixel's
// column of A = [d_power; d_opa_px; w] (3 x 32 values) and stores it to
// shared memory; the block then reduces A against the tile-local pixel basis
// [1, lx, ly, lx^2, lx ly, ly^2, gD, gC0..2] in fp32, and d_mean and d_conic
// follow from the moments (kernel_lab.py:562-581). Only the 11 moments the
// gradient reads are formed: the six geometric ones of d_power, the sum of
// d_opa_px, and w against the four cotangent rows. The conic gradients
// cancel: d_cb = -(Sxy - my Sx - mx Sy + mx my S0) is small where the
// moments are large, so plain fp32 sums of 256 mixed-sign products lose it
// (up to 3e-4 absolute on values of 1e-2 on the lab scene, outside K2's
// tolerance). Three choices keep it: the basis is centred on the tile (lx,
// ly in [-7.5, 7.5] for 16 px, so the terms and mx, my stay small); each
// moment is summed with Kahan compensation (fp32 products, compensated fp32
// adds); and the 32 threads that finish a chunk combine the segments'
// (sum, compensation) pairs and derive d_mean and d_conic in fp64, since a
// moment rounded to fp32 still loses d_cb of a wide footprint
// (|mx my S0| >> |d_cb|). It reads K1's
// residuals (t_final and n_done per pixel), not the TPU lab's tfinal/neff,
// and recovers the transmittance at a chunk's start by the same divide-out
// as the Pallas backward (t_start = t_after / incl_last, kernel_lab.py:533).
// The entries a pixel replays are exactly the n_done it multiplied in the
// forward, so the divisor never underflows (K1 stops multiplying once
// T < t_min). The function is the same: d_props for the given props and
// cotangents.
//
// What bounds them on an H100: the (entry, pixel) pairs of a tile, an expf
// and ~20 flops each in L1 (a log1pf and a second expf in trimat), ~40 flops
// plus 11 FFMA moments in L2; reads are one pass over props. So they are
// bound by issue rate, not by device memory. The designs keep per-pixel
// state in registers and read each entry once per block from shared memory.
// This file is compiled with blend.cu, -fmad=false, so that power, alpha and
// the transmittance round as in the plain versions (ops/blend_lab.py), which
// evaluate the same expressions in the same order.

#include <cuda_runtime.h>

namespace {

constexpr int D = 10;
constexpr int CHUNK = 32;
constexpr int APAD = CHUNK + 1;  // row stride of the staged A columns
constexpr int NMOM = 11;         // moments per entry

// s + x with the lost low-order part carried in c (Kahan): the sum is s - c
__device__ __forceinline__ void kahan_add(float& s, float& c, float x) {
  const float y = x - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// ---------------------------------------------------------------- L1

template <bool RANK6, bool LOGT, int STAGE, int NT>
__global__ void lab_fwd_kernel(const float* __restrict__ props,
                               const int* __restrict__ counts, int l_max,
                               int tx_n, int tile_w, int tile_h,
                               float alpha_clamp, float alpha_min, float t_min,
                               float* __restrict__ color,
                               float* __restrict__ depth,
                               float* __restrict__ alpha_out) {
  constexpr int BATCH = STAGE > CHUNK ? STAGE : CHUNK;
  extern __shared__ float smem[];
  const int P = blockDim.x;
  float* sp = smem;                       // [NT][BATCH][D] staged entries
  float* sc = sp + NT * BATCH * D;        // [NT][BATCH][6] rank-6 coefficients
  float* sw = sc + (RANK6 ? NT * BATCH * 6 : 0);  // [STAGE][P] weights
  const int p = threadIdx.x;
  const int lxi = p % tile_w, lyi = p / tile_w;
  const float lx = static_cast<float>(lxi), ly = static_cast<float>(lyi);
  const float m0 = lx * lx, m1 = lx * ly, m2 = ly * ly;

  const int t0 = blockIdx.x * NT;  // this block's first tile
  float ox[NT], oy[NT], t_run[NT];
  float acc[NT][5];
  int n_chunks = 0;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    ox[i] = static_cast<float>(((t0 + i) % tx_n) * tile_w);
    oy[i] = static_cast<float>(((t0 + i) / tx_n) * tile_h);
    n_chunks = max(n_chunks, (counts[t0 + i] + CHUNK - 1) / CHUNK);
    t_run[i] = 1.0f;
#pragma unroll
    for (int k = 0; k < 5; ++k) acc[i][k] = 0.0f;
  }
  const int n_ent = n_chunks * CHUNK;

  for (int b0 = 0; b0 < n_ent; b0 += BATCH) {
    const int nb = min(BATCH, n_ent - b0);
    __syncthreads();  // the previous batch is consumed
    for (int x = p; x < NT * nb * D; x += P) {
      const int i = x / (nb * D), r = x % (nb * D);
      const int e = b0 + r / D;
      sp[(i * BATCH) * D + r] =
          e < l_max ? props[(static_cast<size_t>(t0 + i) * l_max + b0) * D + r] : 0.0f;
    }
    __syncthreads();
    if (RANK6) {
      for (int x = p; x < NT * nb; x += P) {
        const int i = x / nb, j = x % nb;
        const float* e = sp + (i * BATCH + j) * D;
        const float mx = e[0] - ox[i], my = e[1] - oy[i];
        const float ca = e[2], cb = e[3], cc = e[4];
        float* c = sc + (i * BATCH + j) * 6;
        c[0] = 0.5f * ca;
        c[1] = cb;
        c[2] = 0.5f * cc;
        c[3] = -(ca * mx + cb * my);
        c[4] = -(cb * mx + cc * my);
        c[5] = 0.5f * ca * mx * mx + cb * mx * my + 0.5f * cc * my * my;
      }
      __syncthreads();
    }
    for (int c0 = 0; c0 < nb; c0 += CHUNK) {
      float tr[NT];  // exclusive product, or inclusive log-sum, in the chunk
#pragma unroll
      for (int i = 0; i < NT; ++i) tr[i] = LOGT ? 0.0f : 1.0f;
#pragma unroll 4
      for (int j = c0; j < c0 + CHUNK; ++j) {
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          const float* e = sp + (i * BATCH + j) * D;
          float power;
          if (RANK6) {
            const float* c = sc + (i * BATCH + j) * 6;
            power = -(c[0] * m0 + c[1] * m1 + c[2] * m2 + c[3] * lx + c[4] * ly + c[5]);
          } else {
            const float dx = (ox[i] + lx) - e[0];
            const float dy = (oy[i] + ly) - e[1];
            power = -0.5f * (e[2] * dx * dx + e[4] * dy * dy) - e[3] * dx * dy;
          }
          float a = fminf(alpha_clamp, e[8] * expf(power));
          if (power > 0.0f || a < alpha_min) a = 0.0f;
          float t_in;
          if (LOGT) {
            const float lom = log1pf(-a);
            tr[i] = tr[i] + lom;
            t_in = t_run[i] * expf(tr[i] - lom);
          } else {
            t_in = t_run[i] * tr[i];
            tr[i] = tr[i] * (1.0f - a);
          }
          const float w = t_in >= t_min ? a * t_in : 0.0f;
          if (STAGE > 0) {
            sw[j * P + p] = w;
          } else {
            acc[i][0] += w * e[5];
            acc[i][1] += w * e[6];
            acc[i][2] += w * e[7];
            acc[i][3] += w * e[9];
            acc[i][4] += w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < NT; ++i) t_run[i] = t_run[i] * (LOGT ? expf(tr[i]) : tr[i]);
    }
    if (STAGE > 0) {
      // contract the staged weights of this batch against [r, g, b, z, 1];
      // each thread reads only its own pixel's column
      for (int j = 0; j < nb; ++j) {
        const float* e = sp + j * D;
        const float w = sw[j * P + p];
        acc[0][0] += w * e[5];
        acc[0][1] += w * e[6];
        acc[0][2] += w * e[7];
        acc[0][3] += w * e[9];
        acc[0][4] += w;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const size_t t = static_cast<size_t>(t0 + i);
    color[t * 3 * P + p] = acc[i][0];
    color[t * 3 * P + P + p] = acc[i][1];
    color[t * 3 * P + 2 * P + p] = acc[i][2];
    depth[t * P + p] = acc[i][3];
    alpha_out[t * P + p] = acc[i][4];
  }
}

template <bool RANK6, bool LOGT, int STAGE, int NT>
int launch_fwd(const float* props, const int* counts, int n_tiles, int l_max,
               int tx_n, int tile_w, int tile_h, float alpha_clamp,
               float alpha_min, float t_min, float* color, float* depth,
               float* alpha, cudaStream_t s) {
  constexpr int BATCH = STAGE > CHUNK ? STAGE : CHUNK;
  const int P = tile_w * tile_h;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(NT) * BATCH * (D + (RANK6 ? 6 : 0)) +
       static_cast<size_t>(STAGE) * P);
  auto kernel = lab_fwd_kernel<RANK6, LOGT, STAGE, NT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_tiles / NT, P, smem, s>>>(props, counts, l_max, tx_n, tile_w,
                                       tile_h, alpha_clamp, alpha_min, t_min,
                                       color, depth, alpha);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- L2

__global__ void lab_moments_bwd_kernel(
    const float* __restrict__ props, int l_max, int tile_w,
    float alpha_clamp, float alpha_min, const float* __restrict__ t_final,
    const int* __restrict__ n_done, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, const float* __restrict__ g_alpha,
    float* __restrict__ d_props, int tx_n, int tile_h) {
  extern __shared__ float smem[];
  __shared__ int s_nd_max;
  const int P = blockDim.x;
  const int n_seg = P / CHUNK;
  float* sA = smem;                         // [3][P][APAD]: d_power, d_opa_px, w
  float* sbasis = sA + 3 * P * APAD;        // [4][P]: gD, gC0, gC1, gC2
  float* spart = sbasis + 4 * P;            // [n_seg][CHUNK][2 NMOM] sums, compensations
  float* sp = spart + n_seg * CHUNK * 2 * NMOM;  // [CHUNK][D] staged entries
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float lx = static_cast<float>(p % tile_w);
  const float ly = static_cast<float>(p / tile_w);
  const float ox = static_cast<float>((t % tx_n) * tile_w);
  const float oy = static_cast<float>((t / tx_n) * tile_h);
  const float cx = 0.5f * static_cast<float>(tile_w - 1);  // the basis' origin
  const float cy = 0.5f * static_cast<float>(tile_h - 1);
  const float* tp = props + static_cast<size_t>(t) * l_max * D;
  float* dp = d_props + static_cast<size_t>(t) * l_max * D;

  const size_t o = static_cast<size_t>(t) * P + p;
  const int nd = n_done[o];
  float T = t_final[o];
  const float gr = g_color[static_cast<size_t>(t) * 3 * P + p];
  const float gg = g_color[static_cast<size_t>(t) * 3 * P + P + p];
  const float gb = g_color[static_cast<size_t>(t) * 3 * P + 2 * P + p];
  const float gd = g_depth[o];
  const float ga = g_alpha[o];
  sbasis[p] = gd;
  sbasis[P + p] = gr;
  sbasis[2 * P + p] = gg;
  sbasis[3 * P + p] = gb;
  float s_wsum = 0.0f;  // sum over later chunks of w (f . g)

  if (p == 0) s_nd_max = 0;
  __syncthreads();
  atomicMax(&s_nd_max, nd);
  __syncthreads();
  const int n_chunks = (s_nd_max + CHUNK - 1) / CHUNK;
  float* A_pow = sA;
  float* A_opa = sA + P * APAD;
  float* A_w = sA + 2 * P * APAD;

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int base = k * CHUNK;
    __syncthreads();  // the previous chunk's staged entries are consumed
    for (int x = p; x < CHUNK * D; x += P) {
      sp[x] = base + x / D < l_max ? tp[base * D + x] : 0.0f;
    }
    __syncthreads();

    // this pixel's column of A: forward over the chunk for the exclusive
    // products, divide-out for the chunk-start transmittance, then back to
    // front for the suffix sums
    float a[CHUNK], ex[CHUNK];
    float inc = 1.0f;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) {
      float al = 0.0f;
      if (base + j < nd) {
        const float* e = sp + j * D;
        const float dx = (ox + lx) - e[0];
        const float dy = (oy + ly) - e[1];
        const float power = -0.5f * (e[2] * dx * dx + e[4] * dy * dy) - e[3] * dx * dy;
        al = fminf(alpha_clamp, e[8] * expf(power));
        if (power > 0.0f || al < alpha_min) al = 0.0f;
      }
      a[j] = al;
      ex[j] = inc;
      inc = inc * (1.0f - al);
    }
    const float t_start = T / inc;
    float suff = 0.0f;
#pragma unroll
    for (int j = CHUNK - 1; j >= 0; --j) {
      const float* e = sp + j * D;
      const float al = a[j];
      const bool used = base + j < nd;
      const float t_in = t_start * ex[j];
      const float w = used ? al * t_in : 0.0f;
      const float dl = e[5] * gr + e[6] * gg + e[7] * gb + e[9] * gd + ga;
      const float S = suff + s_wsum;
      const float om = 1.0f - al;
      const float d_alpha = (used && al > 0.0f) ? t_in * dl - S / om : 0.0f;
      const float G = e[8] > 0.0f ? al / fmaxf(e[8], 1e-12f) : 0.0f;
      const bool nc = al < alpha_clamp;
      A_pow[p * APAD + j] = nc ? d_alpha * al : 0.0f;
      A_opa[p * APAD + j] = nc ? d_alpha * G : 0.0f;
      A_w[p * APAD + j] = w;
      suff += w * dl;
    }
    s_wsum += suff;
    T = t_start;
    __syncthreads();

    // moments: warp s reduces its 32 pixels for all 32 entries (lane = entry)
    {
      const int j = p % CHUNK, s = p / CHUNK;
      float m[NMOM], mc[NMOM];
#pragma unroll
      for (int c = 0; c < NMOM; ++c) m[c] = mc[c] = 0.0f;
      for (int q = s * CHUNK; q < (s + 1) * CHUNK; ++q) {
        const float qx = static_cast<float>(q % tile_w) - cx;
        const float qy = static_cast<float>(q / tile_w) - cy;
        const float dpw = A_pow[q * APAD + j];
        const float dop = A_opa[q * APAD + j];
        const float w = A_w[q * APAD + j];
        kahan_add(m[0], mc[0], dpw);
        kahan_add(m[1], mc[1], dpw * qx);
        kahan_add(m[2], mc[2], dpw * qy);
        kahan_add(m[3], mc[3], dpw * (qx * qx));
        kahan_add(m[4], mc[4], dpw * (qx * qy));
        kahan_add(m[5], mc[5], dpw * (qy * qy));
        kahan_add(m[6], mc[6], dop);
        kahan_add(m[7], mc[7], w * sbasis[q]);
        kahan_add(m[8], mc[8], w * sbasis[P + q]);
        kahan_add(m[9], mc[9], w * sbasis[2 * P + q]);
        kahan_add(m[10], mc[10], w * sbasis[3 * P + q]);
      }
      float* out = spart + (s * CHUNK + j) * 2 * NMOM;
#pragma unroll
      for (int c = 0; c < NMOM; ++c) {
        out[c] = m[c];
        out[NMOM + c] = mc[c];
      }
    }
    __syncthreads();
    if (p < CHUNK && base + p < l_max) {
      double M[NMOM];
#pragma unroll
      for (int c = 0; c < NMOM; ++c) {
        double v = 0.0;
        for (int s = 0; s < n_seg; ++s) {
          const float* part = spart + (s * CHUNK + p) * 2 * NMOM;
          v += static_cast<double>(part[c]) - static_cast<double>(part[NMOM + c]);
        }
        M[c] = v;
      }
      const float* e = sp + p * D;
      // the mean in the basis' frame, and the conic, in fp64
      const double mx = static_cast<double>(e[0] - (ox + cx));
      const double my = static_cast<double>(e[1] - (oy + cy));
      const double ca = e[2], cb = e[3], cc = e[4];
      const double S0 = M[0], Sx = M[1], Sy = M[2], Sxx = M[3], Sxy = M[4], Syy = M[5];
      float* d = dp + static_cast<size_t>(base + p) * D;
      d[0] = static_cast<float>(ca * (Sx - mx * S0) + cb * (Sy - my * S0));
      d[1] = static_cast<float>(cc * (Sy - my * S0) + cb * (Sx - mx * S0));
      d[2] = static_cast<float>(-0.5 * (Sxx - 2.0 * mx * Sx + mx * mx * S0));
      d[3] = static_cast<float>(-(Sxy - my * Sx - mx * Sy + mx * my * S0));
      d[4] = static_cast<float>(-0.5 * (Syy - 2.0 * my * Sy + my * my * S0));
      d[5] = static_cast<float>(M[8]);
      d[6] = static_cast<float>(M[9]);
      d[7] = static_cast<float>(M[10]);
      d[8] = static_cast<float>(M[6]);
      d[9] = static_cast<float>(M[7]);
    }
  }
}

}  // namespace

extern "C" {

// variant: 0 nocond/acc8, 1 trimat, 2 mxu, 3 lean, 4 storew, 5 pair2, 6 pair4
int lab_blend_fwd(int variant, const float* props, const int* counts,
                  int n_tiles, int l_max, int tx_n, int tile_w, int tile_h,
                  float alpha_clamp, float alpha_min, float t_min,
                  float* color, float* depth, float* alpha, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
#define LAB_ARGS props, counts, n_tiles, l_max, tx_n, tile_w, tile_h, \
                 alpha_clamp, alpha_min, t_min, color, depth, alpha, s
  switch (variant) {
    case 0: return launch_fwd<false, false, 0, 1>(LAB_ARGS);
    case 1: return launch_fwd<false, true, 0, 1>(LAB_ARGS);
    case 2: return launch_fwd<true, false, 0, 1>(LAB_ARGS);
    case 3: return launch_fwd<true, false, 32, 1>(LAB_ARGS);
    case 4: return launch_fwd<false, false, 64, 1>(LAB_ARGS);
    case 5: return launch_fwd<false, false, 0, 2>(LAB_ARGS);
    case 6: return launch_fwd<false, false, 0, 4>(LAB_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LAB_ARGS
}

int lab_moments_bwd(const float* props, int n_tiles, int l_max, int tx_n,
                    int tile_w, int tile_h, float alpha_clamp, float alpha_min,
                    const float* t_final, const int* n_done,
                    const float* g_color, const float* g_depth,
                    const float* g_alpha, float* d_props, void* stream) {
  const int P = tile_w * tile_h;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(3) * P * APAD + 4 * P + (P / CHUNK) * CHUNK * 2 * NMOM + CHUNK * D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lab_moments_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lab_moments_bwd_kernel<<<n_tiles, P, smem, s>>>(
      props, l_max, tile_w, alpha_clamp, alpha_min, t_final, n_done, g_color,
      g_depth, g_alpha, d_props, tx_n, tile_h);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
