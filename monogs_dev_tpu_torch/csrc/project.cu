// The Gaussian projection's forward (P1) and its pose gradient (P2), for
// the calls of ops/project.py::project_gaussians whose map fields ask for no
// gradient, at degree-0 colour (the tracker's iterations and rebins, renders
// under no_grad, mapping's binnings).
//
// Replaces no Pallas kernel: the JAX package's projection
// (monogs_dev_tpu/ops/project.py) is jnp that XLA fuses into a handful of
// fusions. Eager PyTorch runs the same composition as ~250 elementwise ops,
// and autograd's backward as ~300 more plus one reduction over the rows for
// each broadcast entry of the pose; these two kernels do for the port what
// that fusion did.
//
// P1, one thread per row, all in registers: the NaN/Inf/overflow quarantine
// of `sanitize_params` (no host constant), the camera transform and the znear
// test, means2d = f x/z + c - 0.5, the 1.3x tan-FoV clamp, the 3D covariance
// from the normalised quaternion and the clipped log-scales,
// J W cov W^T J^T + 0.3, det and the conic, radius = ceil(3 sqrt(lambda_max))
// with the 0.1 floor, valid, the degree-0 colour and the masked sigmoid
// opacity. The pose comes in as a device (4, 4) tensor (no host read) and
// the intrinsics as arguments. Every operation of the row rounds as written,
// in the eager composition's order (__fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn,
// __fsqrt_rn, 1/z as torch's reciprocal, a clamp that passes NaN), so the
// outputs equal the eager path's: the discrete ones (radius, valid, in
// front, det > 0) decide the binning, and the continuous ones the tile
// lists' depth order.
//
// P2, the pose gradient: from the upstream gradients of means2d, conic and
// depth (colour and opacity do not depend on the pose at degree 0: their
// gradients are not passed in), each thread recomputes its row's forward
// with P1's code (no saved per-row intermediates) and forms its
// contribution to dL/dR (9) and dL/dt (3), following autograd of the eager
// composition at the edges: a clamp passes the gradient on its closed
// interval, where(in_front)/where(det > 0) select, ceil and radius give
// zero, and the numerators of the conic take their gradient divided by the
// selected denominator (1 where det <= 0). The 12 values are summed in fp64
// over each warp by shuffles and over the block's warps in a fixed order,
// one partial row per block; a second pass, one block, adds the partial rows
// in a fixed order in fp64. No atomics: the gradient is deterministic.
//
// What bounds them on an H100: bytes. P1 reads ~60 B a row (xyz 12, log
// scales 12, quaternion 16, opacity 4, f_dc 12, active 1, f_rest where the
// map has it) and writes ~50 B (means2d 8, conic 12, colour 12, opacity 4,
// depth 4, radius 4, valid 1); P2 reads the same ~60 B and the upstream 24 B
// a row and writes 96 B a block. ~200 flops a row in P1 and ~400 in P2 sit
// far under the card's rate, so one pass over the rows with nothing of the
// row's chain leaving registers is the design; at the tracker's row counts
// (a few thousand to 65,536 rows, 0.2-7 MB) the launch and the tail of one
// wave, not the bytes, set the time.

#include <cuda_runtime.h>

namespace {

constexpr int NG = 12;           // pose gradient entries a row: dR (row-major 3x3), dt (3)
constexpr int MAX_WARPS = 32;    // warps of the largest block
constexpr unsigned FULL = 0xffffffffu;
constexpr float SH_C0 = 0.28209479177387814f;

struct Cam {
  float fx, fy, cx, cy, znear, limx, limy, scale_modifier;
  int isotropic;
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp: NaN passes through (fminf/fmaxf alone would drop it)
__device__ __forceinline__ float torch_clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float torch_clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// a + b + c as torch evaluates it: (a + b) + c
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return add_rn(add_rn(a, b), c);
}

// One row's forward, with the intermediates P2 needs.
struct RowFwd {
  float X, Y, Z;                          // sanitized mean
  float x, y, z;                          // camera frame
  bool ok, in_front, det_ok;
  float zs, iz, iz2, u, v, uc, vc, tx, ty;
  float j00, j02, j11, j12;
  float m[9];                             // R cov, row-major
  float vw00, vw01, vw02, vw11, vw12, vw22;
  float a, b, c, det, ds;
  float op_logit, dc0, dc1, dc2;          // sanitized
};

__device__ __forceinline__ bool finite3(const float* p) {
  return isfinite(p[0]) && isfinite(p[1]) && isfinite(p[2]);
}

// The eager composition of ops/project.py::project_gaussians for row i,
// rounding each operation as torch does (see the note at the top).
__device__ __forceinline__ RowFwd project_row(const float* __restrict__ T,
                                              const float* __restrict__ xyz,
                                              const float* __restrict__ log_scales,
                                              const float* __restrict__ quats,
                                              const float* __restrict__ opacity_logit,
                                              const float* __restrict__ f_dc,
                                              const float* __restrict__ f_rest, int n_rest,
                                              const Cam& cam, int i) {
  RowFwd r;
  const float* p = xyz + 3 * i;
  const float* ls = log_scales + 3 * i;
  const float* q = quats + 4 * i;
  const float* dc = f_dc + 3 * i;
  float X = p[0], Y = p[1], Z = p[2];
  float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  float ol = opacity_logit[i];
  bool ok = finite3(p) && finite3(ls) && isfinite(qw) && isfinite(qx) && isfinite(qy) &&
            isfinite(qz) && isfinite(ol) && finite3(dc);
  for (int k = 0; k < n_rest; ++k) ok = ok && isfinite(f_rest[static_cast<size_t>(i) * n_rest + k]);
  ok = ok && fmaxf(fabsf(X), fmaxf(fabsf(Y), fabsf(Z))) < 1e6f;
  // torch.linalg.norm over the 4 entries: one lane each, a shuffle tree
  // with the offset decreasing (2, then 1)
  float qn = __fsqrt_rn(add_rn(add_rn(mul_rn(qw, qw), mul_rn(qy, qy)),
                               add_rn(mul_rn(qx, qx), mul_rn(qz, qz))));
  ok = ok && qn > 1e-3f;
  float l0, l1, l2;
  if (ok) {
    l0 = torch_clamp(ls[0], -20.0f, 8.0f);
    l1 = torch_clamp(ls[1], -20.0f, 8.0f);
    l2 = torch_clamp(ls[2], -20.0f, 8.0f);
    r.dc0 = dc[0];
    r.dc1 = dc[1];
    r.dc2 = dc[2];
  } else {  // the quarantine's inert row
    X = Y = Z = 0.0f;
    l0 = l1 = l2 = -10.0f;
    qw = 1.0f;
    qx = qy = qz = 0.0f;
    qn = 1.0f;
    ol = -10.0f;
    r.dc0 = r.dc1 = r.dc2 = 0.0f;
  }
  if (cam.isotropic) l1 = l2 = l0;
  r.ok = ok;
  r.X = X;
  r.Y = Y;
  r.Z = Z;
  r.op_logit = ol;

  const float R00 = T[0], R01 = T[1], R02 = T[2], t0 = T[3];
  const float R10 = T[4], R11 = T[5], R12 = T[6], t1 = T[7];
  const float R20 = T[8], R21 = T[9], R22 = T[10], t2 = T[11];
  r.x = add_rn(sum3(mul_rn(R00, X), mul_rn(R01, Y), mul_rn(R02, Z)), t0);
  r.y = add_rn(sum3(mul_rn(R10, X), mul_rn(R11, Y), mul_rn(R12, Z)), t1);
  r.z = add_rn(sum3(mul_rn(R20, X), mul_rn(R21, Y), mul_rn(R22, Z)), t2);
  r.in_front = r.z > cam.znear;
  r.zs = r.in_front ? r.z : 1.0f;
  r.iz = div_rn(1.0f, r.zs);
  r.u = mul_rn(r.x, r.iz);
  r.v = mul_rn(r.y, r.iz);
  r.uc = torch_clamp(r.u, -cam.limx, cam.limx);
  r.vc = torch_clamp(r.v, -cam.limy, cam.limy);
  r.tx = mul_rn(r.uc, r.zs);
  r.ty = mul_rn(r.vc, r.zs);
  r.iz2 = mul_rn(r.iz, r.iz);
  r.j00 = mul_rn(cam.fx, r.iz);
  r.j02 = mul_rn(mul_rn(-cam.fx, r.tx), r.iz2);
  r.j11 = mul_rn(cam.fy, r.iz);
  r.j12 = mul_rn(mul_rn(-cam.fy, r.ty), r.iz2);

  // 3D covariance: R_q diag(s^2) R_q^T, upper triangle
  const float s0 = mul_rn(expf(l0), cam.scale_modifier);
  const float s1 = mul_rn(expf(l1), cam.scale_modifier);
  const float s2 = mul_rn(expf(l2), cam.scale_modifier);
  const float nq = torch_clamp_min(qn, 1e-12f);
  const float w = div_rn(qw, nq), x = div_rn(qx, nq), y = div_rn(qy, nq), z = div_rn(qz, nq);
  const float r00 = sub_rn(1.0f, mul_rn(2.0f, add_rn(mul_rn(y, y), mul_rn(z, z))));
  const float r01 = mul_rn(2.0f, sub_rn(mul_rn(x, y), mul_rn(w, z)));
  const float r02 = mul_rn(2.0f, add_rn(mul_rn(x, z), mul_rn(w, y)));
  const float r10 = mul_rn(2.0f, add_rn(mul_rn(x, y), mul_rn(w, z)));
  const float r11 = sub_rn(1.0f, mul_rn(2.0f, add_rn(mul_rn(x, x), mul_rn(z, z))));
  const float r12 = mul_rn(2.0f, sub_rn(mul_rn(y, z), mul_rn(w, x)));
  const float r20 = mul_rn(2.0f, sub_rn(mul_rn(x, z), mul_rn(w, y)));
  const float r21 = mul_rn(2.0f, add_rn(mul_rn(y, z), mul_rn(w, x)));
  const float r22 = sub_rn(1.0f, mul_rn(2.0f, add_rn(mul_rn(x, x), mul_rn(y, y))));
  const float ss0 = mul_rn(s0, s0), ss1 = mul_rn(s1, s1), ss2 = mul_rn(s2, s2);
  const float c00 = sum3(mul_rn(mul_rn(r00, r00), ss0), mul_rn(mul_rn(r01, r01), ss1),
                         mul_rn(mul_rn(r02, r02), ss2));
  const float c01 = sum3(mul_rn(mul_rn(r00, r10), ss0), mul_rn(mul_rn(r01, r11), ss1),
                         mul_rn(mul_rn(r02, r12), ss2));
  const float c02 = sum3(mul_rn(mul_rn(r00, r20), ss0), mul_rn(mul_rn(r01, r21), ss1),
                         mul_rn(mul_rn(r02, r22), ss2));
  const float c11 = sum3(mul_rn(mul_rn(r10, r10), ss0), mul_rn(mul_rn(r11, r11), ss1),
                         mul_rn(mul_rn(r12, r12), ss2));
  const float c12 = sum3(mul_rn(mul_rn(r10, r20), ss0), mul_rn(mul_rn(r11, r21), ss1),
                         mul_rn(mul_rn(r12, r22), ss2));
  const float c22 = sum3(mul_rn(mul_rn(r20, r20), ss0), mul_rn(mul_rn(r21, r21), ss1),
                         mul_rn(mul_rn(r22, r22), ss2));

  // M = R cov; VW = M R^T (upper triangle)
  const float Rm[9] = {R00, R01, R02, R10, R11, R12, R20, R21, R22};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float a0 = Rm[3 * k], a1 = Rm[3 * k + 1], a2 = Rm[3 * k + 2];
    r.m[3 * k] = sum3(mul_rn(a0, c00), mul_rn(a1, c01), mul_rn(a2, c02));
    r.m[3 * k + 1] = sum3(mul_rn(a0, c01), mul_rn(a1, c11), mul_rn(a2, c12));
    r.m[3 * k + 2] = sum3(mul_rn(a0, c02), mul_rn(a1, c12), mul_rn(a2, c22));
  }
  r.vw00 = sum3(mul_rn(r.m[0], R00), mul_rn(r.m[1], R01), mul_rn(r.m[2], R02));
  r.vw01 = sum3(mul_rn(r.m[0], R10), mul_rn(r.m[1], R11), mul_rn(r.m[2], R12));
  r.vw02 = sum3(mul_rn(r.m[0], R20), mul_rn(r.m[1], R21), mul_rn(r.m[2], R22));
  r.vw11 = sum3(mul_rn(r.m[3], R10), mul_rn(r.m[4], R11), mul_rn(r.m[5], R12));
  r.vw12 = sum3(mul_rn(r.m[3], R20), mul_rn(r.m[4], R21), mul_rn(r.m[5], R22));
  r.vw22 = sum3(mul_rn(r.m[6], R20), mul_rn(r.m[7], R21), mul_rn(r.m[8], R22));

  const float j00 = r.j00, j02 = r.j02, j11 = r.j11, j12 = r.j12;
  const float a = sum3(mul_rn(mul_rn(j00, j00), r.vw00),
                       mul_rn(mul_rn(mul_rn(2.0f, j00), j02), r.vw02),
                       mul_rn(mul_rn(j02, j02), r.vw22));
  const float b = add_rn(sum3(mul_rn(mul_rn(j00, j11), r.vw01), mul_rn(mul_rn(j00, j12), r.vw02),
                              mul_rn(mul_rn(j02, j11), r.vw12)),
                         mul_rn(mul_rn(j02, j12), r.vw22));
  const float c = sum3(mul_rn(mul_rn(j11, j11), r.vw11),
                       mul_rn(mul_rn(mul_rn(2.0f, j11), j12), r.vw12),
                       mul_rn(mul_rn(j12, j12), r.vw22));
  r.a = add_rn(a, 0.3f);
  r.b = b;
  r.c = add_rn(c, 0.3f);
  r.det = sub_rn(mul_rn(r.a, r.c), mul_rn(r.b, r.b));
  r.det_ok = r.det > 0.0f;
  r.ds = r.det_ok ? r.det : 1.0f;
  return r;
}

__global__ void project_fwd_kernel(const float* __restrict__ T, const float* __restrict__ xyz,
                                   const float* __restrict__ log_scales,
                                   const float* __restrict__ quats,
                                   const float* __restrict__ opacity_logit,
                                   const float* __restrict__ f_dc,
                                   const float* __restrict__ f_rest, int n_rest,
                                   const unsigned char* __restrict__ active, int n, Cam cam,
                                   float* __restrict__ means2d, float* __restrict__ conic,
                                   float* __restrict__ color, float* __restrict__ opacity,
                                   float* __restrict__ depth, float* __restrict__ radii,
                                   unsigned char* __restrict__ valid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const RowFwd r = project_row(T, xyz, log_scales, quats, opacity_logit, f_dc, f_rest, n_rest,
                               cam, i);
  means2d[2 * i] = sub_rn(add_rn(mul_rn(mul_rn(cam.fx, r.x), r.iz), cam.cx), 0.5f);
  means2d[2 * i + 1] = sub_rn(add_rn(mul_rn(mul_rn(cam.fy, r.y), r.iz), cam.cy), 0.5f);
  conic[3 * i] = div_rn(r.c, r.ds);
  conic[3 * i + 1] = div_rn(-r.b, r.ds);
  conic[3 * i + 2] = div_rn(r.a, r.ds);
  const float mid = mul_rn(0.5f, add_rn(r.a, r.c));
  const float lam =
      add_rn(mid, __fsqrt_rn(torch_clamp_min(sub_rn(mul_rn(mid, mid), r.det), 0.1f)));
  const bool ok_row = active[i] != 0 && r.ok && r.in_front && r.det_ok;
  radii[i] = ok_row ? ceilf(mul_rn(3.0f, __fsqrt_rn(lam))) : 0.0f;
  valid[i] = ok_row;
  color[3 * i] = torch_clamp_min(add_rn(mul_rn(SH_C0, r.dc0), 0.5f), 0.0f);
  color[3 * i + 1] = torch_clamp_min(add_rn(mul_rn(SH_C0, r.dc1), 0.5f), 0.0f);
  color[3 * i + 2] = torch_clamp_min(add_rn(mul_rn(SH_C0, r.dc2), 0.5f), 0.0f);
  opacity[i] = ok_row ? div_rn(1.0f, add_rn(1.0f, expf(-r.op_logit))) : 0.0f;
  depth[i] = r.z;
}

// Row i's dL/dR (row-major) and dL/dt from the upstream gradients (each
// pointer may be null: a zero gradient).
__device__ __forceinline__ void pose_grad_row(const RowFwd& r, const Cam& cam,
                                              const float* __restrict__ g_means2d,
                                              const float* __restrict__ g_conic,
                                              const float* __restrict__ g_depth, int i,
                                              float* g) {
  const float gmx = g_means2d ? g_means2d[2 * i] : 0.0f;
  const float gmy = g_means2d ? g_means2d[2 * i + 1] : 0.0f;
  const float g0 = g_conic ? g_conic[3 * i] : 0.0f;
  const float g1 = g_conic ? g_conic[3 * i + 1] : 0.0f;
  const float g2 = g_conic ? g_conic[3 * i + 2] : 0.0f;
  const float gz = g_depth ? g_depth[i] : 0.0f;
  const float fx = cam.fx, fy = cam.fy;

  // conic = (c, -b, a) / ds; ds = det where det > 0, else the constant 1
  const float ids = 1.0f / r.ds;
  float da = g2 * ids, db = -g1 * ids, dc = g0 * ids;
  if (r.det_ok) {
    const float ddet = -(g0 * r.c - g1 * r.b + g2 * r.a) * ids * ids;
    da += ddet * r.c;
    dc += ddet * r.a;
    db -= 2.0f * r.b * ddet;
  }
  // (a, b, c) -> J entries and VW
  const float j00 = r.j00, j02 = r.j02, j11 = r.j11, j12 = r.j12;
  const float dj00 = 2.0f * da * (j00 * r.vw00 + j02 * r.vw02) + db * (j11 * r.vw01 + j12 * r.vw02);
  const float dj02 = 2.0f * da * (j00 * r.vw02 + j02 * r.vw22) + db * (j11 * r.vw12 + j12 * r.vw22);
  const float dj11 = db * (j00 * r.vw01 + j02 * r.vw12) + 2.0f * dc * (j11 * r.vw11 + j12 * r.vw12);
  const float dj12 = db * (j00 * r.vw02 + j02 * r.vw22) + 2.0f * dc * (j11 * r.vw12 + j12 * r.vw22);
  // S = G + G^T for G the gradient of the six VW entries; dL/dR += S (R cov)
  const float s00 = 2.0f * da * j00 * j00;
  const float s11 = 2.0f * dc * j11 * j11;
  const float s22 = 2.0f * (da * j02 * j02 + db * j02 * j12 + dc * j12 * j12);
  const float s01 = db * j00 * j11;
  const float s02 = 2.0f * da * j00 * j02 + db * j00 * j12;
  const float s12 = db * j02 * j11 + 2.0f * dc * j11 * j12;
  const float S[9] = {s00, s01, s02, s01, s11, s12, s02, s12, s22};
#pragma unroll
  for (int row = 0; row < 3; ++row)
#pragma unroll
    for (int col = 0; col < 3; ++col)
      g[3 * row + col] = S[3 * row] * r.m[col] + S[3 * row + 1] * r.m[3 + col] +
                         S[3 * row + 2] * r.m[6 + col];

  // J entries -> x, y, z through 1/z_safe and the clamped t_x, t_y
  float diz = fx * dj00 + fy * dj11;
  const float diz2 = -fx * r.tx * dj02 - fy * r.ty * dj12;
  const float dtx = -fx * r.iz2 * dj02, dty = -fy * r.iz2 * dj12;
  diz += 2.0f * r.iz * diz2;
  float dzs = r.uc * dtx + r.vc * dty;
  const float du = (r.u >= -cam.limx && r.u <= cam.limx) ? r.zs * dtx : 0.0f;
  const float dv = (r.v >= -cam.limy && r.v <= cam.limy) ? r.zs * dty : 0.0f;
  float dx = r.iz * du, dy = r.iz * dv;
  diz += r.x * du + r.y * dv;
  // means2d = f x / z_safe + c - 0.5
  dx += fx * r.iz * gmx;
  dy += fy * r.iz * gmy;
  diz += fx * r.x * gmx + fy * r.y * gmy;
  dzs -= r.iz * r.iz * diz;
  const float dz = gz + (r.in_front ? dzs : 0.0f);
  // (x, y, z) = R p + t
  g[0] += dx * r.X; g[1] += dx * r.Y; g[2] += dx * r.Z;
  g[3] += dy * r.X; g[4] += dy * r.Y; g[5] += dy * r.Z;
  g[6] += dz * r.X; g[7] += dz * r.Y; g[8] += dz * r.Z;
  g[9] = dx;
  g[10] = dy;
  g[11] = dz;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// Pass 1 of P2: one partial row of NG sums per block.
__global__ void project_bwd_pose_kernel(const float* __restrict__ T, const float* __restrict__ xyz,
                                        const float* __restrict__ log_scales,
                                        const float* __restrict__ quats,
                                        const float* __restrict__ opacity_logit,
                                        const float* __restrict__ f_dc,
                                        const float* __restrict__ f_rest, int n_rest, int n,
                                        Cam cam, const float* __restrict__ g_means2d,
                                        const float* __restrict__ g_conic,
                                        const float* __restrict__ g_depth,
                                        double* __restrict__ partial) {
  __shared__ double warp_rows[MAX_WARPS][NG];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  float g[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) g[k] = 0.0f;
  if (i < n) {
    const RowFwd r = project_row(T, xyz, log_scales, quats, opacity_logit, f_dc, f_rest, n_rest,
                                 cam, i);
    pose_grad_row(r, cam, g_means2d, g_conic, g_depth, i, g);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    const double s = warp_sum(static_cast<double>(g[k]));
    if (lane == 0) warp_rows[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < NG) {
    double s = 0.0;
    for (int w = 0; w < (blockDim.x >> 5); ++w) s += warp_rows[w][threadIdx.x];
    partial[static_cast<size_t>(blockIdx.x) * NG + threadIdx.x] = s;
  }
}

// Pass 2 of P2: one block of NG warps; warp k adds column k of the partial
// rows (lane l takes rows l, l + 32, ... in order, then a fixed shuffle
// tree) and writes entry k of dL/dT (4, 4): dR in the top-left 3x3, dt in
// the last column, the bottom row zero.
__global__ void project_bwd_pose_sum_kernel(const double* __restrict__ partial, int n_blocks,
                                            float* __restrict__ dT) {
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  double s = 0.0;
  for (int b = lane; b < n_blocks; b += 32) s += partial[static_cast<size_t>(b) * NG + k];
  s = warp_sum(s);
  if (lane == 0) dT[k < 9 ? (k / 3) * 4 + k % 3 : (k - 9) * 4 + 3] = static_cast<float>(s);
  if (threadIdx.x < 4) dT[12 + threadIdx.x] = 0.0f;
}

Cam make_cam(float fx, float fy, float cx, float cy, float znear, float limx, float limy,
             float scale_modifier, int isotropic) {
  Cam cam;
  cam.fx = fx;
  cam.fy = fy;
  cam.cx = cx;
  cam.cy = cy;
  cam.znear = znear;
  cam.limx = limx;
  cam.limy = limy;
  cam.scale_modifier = scale_modifier;
  cam.isotropic = isotropic;
  return cam;
}

}  // namespace

extern "C" {

// P1. `threads` rows a block (the wrappers pass 256); returns the CUDA
// error of the launch (0: launched).
int project_fwd(const float* T, const float* xyz, const float* log_scales, const float* quats,
                const float* opacity_logit, const float* f_dc, const float* f_rest, int n_rest,
                const unsigned char* active, int n, float fx, float fy, float cx, float cy,
                float znear, float limx, float limy, float scale_modifier, int isotropic,
                int threads, float* means2d, float* conic, float* color, float* opacity,
                float* depth, float* radii, unsigned char* valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cam cam = make_cam(fx, fy, cx, cy, znear, limx, limy, scale_modifier, isotropic);
  if (n > 0) {
    project_fwd_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
        T, xyz, log_scales, quats, opacity_logit, f_dc, f_rest, n_rest, active, n, cam, means2d,
        conic, color, opacity, depth, radii, valid);
  }
  return static_cast<int>(cudaGetLastError());
}

// P2: both passes. `partial` holds ceil(n / threads) rows of NG doubles;
// g_means2d, g_conic, g_depth may be null. `threads` is a multiple of 32.
int project_bwd_pose(const float* T, const float* xyz, const float* log_scales,
                     const float* quats, const float* opacity_logit, const float* f_dc,
                     const float* f_rest, int n_rest, int n, float fx, float fy, float cx,
                     float cy, float znear, float limx, float limy, float scale_modifier,
                     int isotropic, int threads, const float* g_means2d, const float* g_conic,
                     const float* g_depth, double* partial, float* dT, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cam cam = make_cam(fx, fy, cx, cy, znear, limx, limy, scale_modifier, isotropic);
  const int n_blocks = (n + threads - 1) / threads;
  if (n > 0) {
    project_bwd_pose_kernel<<<n_blocks, threads, 0, s>>>(
        T, xyz, log_scales, quats, opacity_logit, f_dc, f_rest, n_rest, n, cam, g_means2d,
        g_conic, g_depth, partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  project_bwd_pose_sum_kernel<<<1, NG * 32, 0, s>>>(partial, n_blocks, dT);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
