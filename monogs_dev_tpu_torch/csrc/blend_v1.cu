// Version 1 of the blend kernels K1, K3 and K2: the first, simple design,
// kept only as the yardstick that version 2 (csrc/blend.cu) is timed and
// checked against, in turns in one run (chip_smoke.py's timing phase,
// tests/test_torch_gpu.py). No path of the system launches it. Entry points
// blend_fwd_v1 and blend_bwd_v1 take the same arguments as blend.cu's
// blend_fwd and blend_bwd.
//
// Replaces, like version 2, the Pallas kernels of
// monogs_dev_tpu/ops/blend_pallas.py:
//   K1  _blend_fwd_kernel (emit_touch=False), via blend_tiles_pallas
//   K3  _blend_fwd_kernel (emit_touch=True),  via blend_tiles_pallas_touch
//   K2  _blend_bwd_kernel, via _bwd_rule
//
// Layout: one block per tile, one thread per pixel (tile_w * tile_h threads,
// a multiple of 32). Entries are staged through shared memory in batches of
// one entry per thread, in depth order. props is (T, L, 10) float32 with the
// columns [mu_x, mu_y, conic_a, conic_b, conic_c, r, g, b, opacity, z].
// Per-entry gradients are summed over each warp by ten shuffle trees and
// added to shared memory with atomics. This file is compiled with
// -fmad=false so that alpha is computed with the same roundings as the plain
// version (touch counts then match it bit for bit on the card). Semantics:
// as csrc/blend.cu.

#include <cuda_runtime.h>

namespace {

constexpr int D = 10;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float entry_power(const float* e, float dx, float dy) {
  return -0.5f * (e[2] * dx * dx + e[4] * dy * dy) - e[3] * dx * dy;
}

template <bool TOUCH>
__global__ void blend_fwd_kernel(const float* __restrict__ props,
                                 const int* __restrict__ counts, int l_max,
                                 int tx_n, int tile_w, int tile_h,
                                 float alpha_clamp, float alpha_min,
                                 float t_min, float* __restrict__ color,
                                 float* __restrict__ depth,
                                 float* __restrict__ alpha_out,
                                 float* __restrict__ t_final,
                                 int* __restrict__ n_done,
                                 int* __restrict__ touch) {
  extern __shared__ float smem[];
  const int P = blockDim.x;
  float* sp = smem;                                       // [P][D]
  int* stouch = reinterpret_cast<int*>(smem + P * D);     // [P]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int count = counts[t];
  const float px = static_cast<float>((t % tx_n) * tile_w + p % tile_w);
  const float py = static_cast<float>((t / tx_n) * tile_h + p / tile_w);
  const float* tp = props + static_cast<size_t>(t) * l_max * D;

  float T = 1.0f;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, dz = 0.0f, wa = 0.0f;
  int nd = 0;
  bool done = false;

  for (int base = 0; base < count; base += P) {
    if (__syncthreads_count(!done) == 0) break;  // tile saturated
    const int nb = min(P, count - base);
    for (int i = p; i < nb * D; i += P) sp[i] = tp[base * D + i];
    if (TOUCH) stouch[p] = 0;
    __syncthreads();
    for (int j = 0; j < nb; ++j) {
      if (__all_sync(FULL, done)) break;  // warp-uniform
      int hit = 0;
      if (!done) {
        const float* e = sp + j * D;
        const float dx = px - e[0];
        const float dy = py - e[1];
        const float power = entry_power(e, dx, dy);
        float a = fminf(alpha_clamp, e[8] * expf(power));
        if (power > 0.0f || a < alpha_min) a = 0.0f;
        const float w = a * T;
        cr += w * e[5];
        cg += w * e[6];
        cb += w * e[7];
        dz += w * e[9];
        wa += w;
        if (TOUCH) hit = a >= alpha_min;
        T = T * (1.0f - a);
        nd = base + j + 1;
        done = T < t_min;
      }
      if (TOUCH) {
        const unsigned b = __ballot_sync(FULL, hit);
        if ((p & 31) == 0 && b) atomicAdd(&stouch[j], __popc(b));
      }
    }
    __syncthreads();
    if (TOUCH && p < nb) touch[static_cast<size_t>(t) * l_max + base + p] = stouch[p];
  }

  const size_t o = static_cast<size_t>(t) * P + p;
  color[static_cast<size_t>(t) * 3 * P + p] = cr;
  color[static_cast<size_t>(t) * 3 * P + P + p] = cg;
  color[static_cast<size_t>(t) * 3 * P + 2 * P + p] = cb;
  depth[o] = dz;
  alpha_out[o] = wa;
  t_final[o] = T;
  n_done[o] = nd;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

__global__ void blend_bwd_kernel(const float* __restrict__ props, int l_max,
                                 int tx_n, int tile_w, int tile_h,
                                 float alpha_clamp, float alpha_min,
                                 const float* __restrict__ t_final,
                                 const int* __restrict__ n_done,
                                 const float* __restrict__ g_color,
                                 const float* __restrict__ g_depth,
                                 const float* __restrict__ g_alpha,
                                 float* __restrict__ d_props) {
  extern __shared__ float smem[];
  __shared__ int s_nd_max;
  const int P = blockDim.x;
  float* sp = smem;           // [P][D] staged entries
  float* sg = smem + P * D;   // [P][D] per-entry gradient sums
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const float px = static_cast<float>((t % tx_n) * tile_w + p % tile_w);
  const float py = static_cast<float>((t / tx_n) * tile_h + p / tile_w);
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
  float S = 0.0f;  // sum over later contributing entries of w_j (f_j . g)

  if (p == 0) s_nd_max = 0;
  __syncthreads();
  atomicMax(&s_nd_max, nd);
  __syncthreads();
  const int nd_max = s_nd_max;

  for (int end = nd_max; end > 0; end -= P) {
    const int base = max(0, end - P);
    const int nb = end - base;
    for (int i = p; i < nb * D; i += P) {
      sp[i] = tp[base * D + i];
      sg[i] = 0.0f;
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      const bool act = base + j < nd;
      if (!__any_sync(FULL, act)) continue;  // warp-uniform
      float v[D];
#pragma unroll
      for (int k = 0; k < D; ++k) v[k] = 0.0f;
      if (act) {
        const float* e = sp + j * D;
        const float dx = px - e[0];
        const float dy = py - e[1];
        const float power = entry_power(e, dx, dy);
        const float G = expf(power);
        float a = fminf(alpha_clamp, e[8] * G);
        if (power > 0.0f || a < alpha_min) a = 0.0f;
        const float om = 1.0f - a;
        const float T_ex = T / om;  // transmittance before this entry
        const float w = a * T_ex;
        const float dl_dw = e[5] * gr + e[6] * gg + e[7] * gb + e[9] * gd + ga;
        if (a > 0.0f && a < alpha_clamp) {
          const float d_alpha = T_ex * dl_dw - S / om;
          const float d_pow = d_alpha * a;
          v[0] = d_pow * (e[2] * dx + e[3] * dy);
          v[1] = d_pow * (e[4] * dy + e[3] * dx);
          v[2] = d_pow * (-0.5f * dx * dx);
          v[3] = d_pow * (-dx * dy);
          v[4] = d_pow * (-0.5f * dy * dy);
          v[8] = d_alpha * G;
        }
        v[5] = w * gr;
        v[6] = w * gg;
        v[7] = w * gb;
        v[9] = w * gd;
        S += w * dl_dw;
        T = T_ex;
      }
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float s = warp_sum(v[k]);
        if ((p & 31) == 0 && s != 0.0f) atomicAdd(&sg[j * D + k], s);
      }
    }
    __syncthreads();
    for (int i = p; i < nb * D; i += P) dp[base * D + i] = sg[i];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int blend_fwd_v1(const float* props, const int* counts, int n_tiles, int l_max,
                 int tx_n, int tile_w, int tile_h, float alpha_clamp,
                 float alpha_min, float t_min, float* color, float* depth,
                 float* alpha, float* t_final, int* n_done, int* touch,
                 void* stream) {
  const int P = tile_w * tile_h;
  const size_t smem = static_cast<size_t>(P) * (D + 1) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    if (touch != nullptr) {
      blend_fwd_kernel<true><<<n_tiles, P, smem, s>>>(
          props, counts, l_max, tx_n, tile_w, tile_h, alpha_clamp, alpha_min,
          t_min, color, depth, alpha, t_final, n_done, touch);
    } else {
      blend_fwd_kernel<false><<<n_tiles, P, smem, s>>>(
          props, counts, l_max, tx_n, tile_w, tile_h, alpha_clamp, alpha_min,
          t_min, color, depth, alpha, t_final, n_done, nullptr);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int blend_bwd_v1(const float* props, int n_tiles, int l_max, int tx_n,
                 int tile_w, int tile_h, float alpha_clamp, float alpha_min,
                 const float* t_final, const int* n_done, const float* g_color,
                 const float* g_depth, const float* g_alpha, float* d_props,
                 void* stream) {
  const int P = tile_w * tile_h;
  const size_t smem = static_cast<size_t>(P) * 2 * D * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles > 0) {
    blend_bwd_kernel<<<n_tiles, P, smem, s>>>(
        props, l_max, tx_n, tile_w, tile_h, alpha_clamp, alpha_min, t_final,
        n_done, g_color, g_depth, g_alpha, d_props);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
