// P1 on Hopper: the 3DGS projection and the packing of K1's field row.
// Forward: means, quats, scales, opacities and RGB of N gaussians -> the
// (N, 10) field row [mx, my, conic a b c, opacity, r, g, b, depth], the
// geometric radius (0 where culled) and binning's cull radius. Backward:
// the field row's gradient -> the gradients of means, quats, scales,
// opacities, RGB and the screen-space probe.
//
// Replaces no TPU kernel: the JAX package projects in plain jnp
// (horizongs_tpu/ops/projection.py `project_3dgs`, packed by the JAX
// package's ops/raster_pallas.py and ops/raster_fields.py), which XLA
// fuses. In the
// port the same function in plain PyTorch (ops/projection.project_3dgs,
// the cull of ops/project3d.py and a cat) is about 200 elementwise kernels
// over row-sized tensors, many on strided columns, and its backward about
// 190 autograd nodes, most of them zero-filling a whole (N, 3, 3) or (N, 3)
// gradient to write one column into it. This pair does each direction in
// one pass. ops/project3d.py keeps the plain path as the CPU path and the
// oracle.
//
// Forward arithmetic: the plain path's, operation by operation, each
// rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn, so that nvcc contracts nothing into an FMA), on the card's
// float32 as PyTorch's elementwise kernels compute it:
//   * a Python scalar s in an operation is (float)s; x / s for such a
//     scalar is x * (float)(1.0 / s) (ATen's division by a CPU scalar, its
//     reciprocal taken in double), and s / t is reciprocal(t) * s
//     (`Tensor.__rtruediv__`);
//   * |q| is torch.linalg.norm's reduction over the 4 components: the
//     squares summed as (q0^2 + q2^2) + (q1^2 + q3^2), then sqrt;
//   * torch.clamp keeps a NaN; log and ceil are the math library's logf
//     and ceilf, as ATen's.
// So the fields, radii and cull radii equal the plain path's on the card
// bit for bit.
//
// Backward: the forward recomputed from the inputs (the same rounded
// operations, so every mask falls where the forward's did), then the
// chain rule with autograd's semantics of the plain path: no gradient
// through z where near < z < far fails (zs = 1 there), none through
// det where det <= 0 (det_safe = 1), none through x / z outside
// [-lim, lim] (torch.clamp's subgradient is 1 at the bounds), none
// through |q| below 1e-12 (clamp_min), the depth column's gradient into z
// for every row, and nothing from the radii (ceil). Opacity, RGB and the
// probe's gradients are columns 5, 6-8 and 0-1 of the field gradient,
// written contiguous.
//
// What bounds it: bytes. The forward reads 56 B a row (means 12, quats
// 16, scales 12, opacity 4, RGB 12; the probe 8 more where given) and
// writes 48 (the 40 B field row, two radii); the backward reads 40 B of
// field gradient and 40 B of inputs and writes 56 (8 more for the
// probe). At 10,035,200 rows that is 1.04 / 1.37 GB, 0.31 / 0.41 ms at
// 3.35 TB/s. The arithmetic a row is about 150 / 300 FP32 operations
// with a dozen correctly rounded divisions, a few square roots and a log.
// Design: one thread a row, 128 rows a block. Rows of 12 and 40 bytes go
// through shared memory, so that each global load and store is a 16-byte
// vector from consecutive threads (a scalar loop where a base pointer is
// not 16-byte aligned); 16-byte (quats, their gradient) and 8-byte (the
// probe) rows go straight between registers and memory as one vector, 4-
// byte rows as one word. The camera (18 floats, with the frustum clamp)
// sits in shared memory, computed once a block. Each block's loads wait
// at one barrier, so it takes many resident blocks to keep the memory
// busy: the registers are capped for 16 blocks a SM in the forward (32
// registers) and 7 in the backward (72), which ptxas meets with a few
// dozen bytes of spill; on the H100 at 10,035,200 rows that ran the
// forward in 0.395 ms and the backward in 0.663 ms, against 0.81 / 0.96
// ms uncapped at 256 threads a block.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
// blocks resident per SM that each kernel's register budget is cut for
constexpr int kFwdBlocks = 16;
constexpr int kBwdBlocks = 7;

// the plain path's constants, as float32 takes each Python scalar
constexpr float kNear = static_cast<float>(0.01);
constexpr float kFar = static_cast<float>(1e10);
constexpr float kEps2d = static_cast<float>(0.3);
constexpr float kFovClamp = static_cast<float>(1.3);
constexpr float kRadicandMin = static_cast<float>(0.01);
constexpr float kNormMin = static_cast<float>(1e-12);
constexpr float kOpacityMin = static_cast<float>(1e-12);
constexpr float kCutoff = static_cast<float>(1.0 / 255.0);
constexpr float kInvCutoff = static_cast<float>(1.0 / (1.0 / 255.0));
constexpr float kThird = static_cast<float>(1.0 / 3.0);

__device__ __forceinline__ float rmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float radd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float rsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float rdiv(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.clamp_min / torch.clamp: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v < lo ? lo : v;
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct Camera {
  float w[9];      // viewmat[:3, :3], row major
  float t[3];      // viewmat[:3, 3]
  float fx, fy, cx, cy;
  float lim_x, lim_y;
};

// The block's camera, in shared memory: thread 0 fills it, before the
// barrier that ends the block's loads.
__device__ __forceinline__ void load_camera(Camera& c,
                                            const float* __restrict__ viewmat,
                                            const float* __restrict__ k,
                                            int width, int height) {
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.w[3 * i + j] = __ldg(viewmat + 4 * i + j);
    c.t[i] = __ldg(viewmat + 4 * i + 3);
  }
  c.fx = __ldg(k + 0);
  c.fy = __ldg(k + 4);
  c.cx = __ldg(k + 2);
  c.cy = __ldg(k + 5);
  // tan_fov = 0.5 * size / f, evaluated as reciprocal(f) * (0.5 * size)
  const float tan_x = rmul(rdiv(1.0f, c.fx), static_cast<float>(0.5 * width));
  const float tan_y = rmul(rdiv(1.0f, c.fy), static_cast<float>(0.5 * height));
  c.lim_x = rmul(tan_x, kFovClamp);
  c.lim_y = rmul(tan_y, kFovClamp);
}

// What the field row and the backward need of one projected row, computed
// with the plain path's rounded operations.
struct Row {
  float x, y, z, zs;
  bool z_ok;              // near < z < far
  float norm, norm_c;     // |q| and clamp_min(|q|, 1e-12)
  float qn[4];            // q / norm_c (w, x, y, z)
  float wr[9];            // (W R)[i][k], before the scales
  float m[9];             // (W R S)[i][k]
  float ux, uy;           // x / zs, y / zs before the clamp
  float clx, cly;         // after it
  float tx, ty, rz, rz2;
  float j00, j02, j11, j12;
  float v0[3], v1[3];
  float a, b, c, det, det_safe;
  bool det_ok;
  float conic[3];
};

__device__ __forceinline__ void project_row(const Camera& cam, float m0,
                                            float m1, float m2, float4 q,
                                            float s0, float s1, float s2,
                                            Row& r) {
  // p_cam = W @ mean + t, each row summed left to right
  const float mv[3] = {m0, m1, m2};
  float p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = radd(radd(radd(rmul(cam.w[3 * i], mv[0]), rmul(cam.w[3 * i + 1], mv[1])),
                   rmul(cam.w[3 * i + 2], mv[2])),
               cam.t[i]);
  }
  r.x = p[0];
  r.y = p[1];
  r.z = p[2];
  r.z_ok = (r.z > kNear) & (r.z < kFar);
  r.zs = r.z_ok ? r.z : 1.0f;

  // normalize_quat and quat_to_rotmat
  r.norm = __fsqrt_rn(radd(radd(rmul(q.x, q.x), rmul(q.z, q.z)),
                          radd(rmul(q.y, q.y), rmul(q.w, q.w))));
  r.norm_c = clamp_min(r.norm, kNormMin);
  const float w = rdiv(q.x, r.norm_c), x = rdiv(q.y, r.norm_c),
              y = rdiv(q.z, r.norm_c), z = rdiv(q.w, r.norm_c);
  r.qn[0] = w;
  r.qn[1] = x;
  r.qn[2] = y;
  r.qn[3] = z;
  float rot[9];
  rot[0] = rsub(1.0f, rmul(2.0f, radd(rmul(y, y), rmul(z, z))));
  rot[1] = rmul(2.0f, rsub(rmul(x, y), rmul(w, z)));
  rot[2] = rmul(2.0f, radd(rmul(x, z), rmul(w, y)));
  rot[3] = rmul(2.0f, radd(rmul(x, y), rmul(w, z)));
  rot[4] = rsub(1.0f, rmul(2.0f, radd(rmul(x, x), rmul(z, z))));
  rot[5] = rmul(2.0f, rsub(rmul(y, z), rmul(w, x)));
  rot[6] = rmul(2.0f, rsub(rmul(x, z), rmul(w, y)));
  rot[7] = rmul(2.0f, radd(rmul(y, z), rmul(w, x)));
  rot[8] = rsub(1.0f, rmul(2.0f, radd(rmul(x, x), rmul(y, y))));

  // (W R)[i][k] * scales[k]
  const float sv[3] = {s0, s1, s2};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r.wr[3 * i + k] =
          radd(radd(rmul(cam.w[3 * i], rot[k]), rmul(cam.w[3 * i + 1], rot[3 + k])),
              rmul(cam.w[3 * i + 2], rot[6 + k]));
      r.m[3 * i + k] = rmul(r.wr[3 * i + k], sv[k]);
    }
  }

  // the frustum-clamped Jacobian
  r.ux = rdiv(r.x, r.zs);
  r.uy = rdiv(r.y, r.zs);
  r.clx = clamp(r.ux, -cam.lim_x, cam.lim_x);
  r.cly = clamp(r.uy, -cam.lim_y, cam.lim_y);
  r.tx = rmul(r.zs, r.clx);
  r.ty = rmul(r.zs, r.cly);
  r.rz = rdiv(1.0f, r.zs);
  r.rz2 = rmul(r.rz, r.rz);
  r.j00 = rmul(cam.fx, r.rz);
  r.j02 = rmul(rmul(-cam.fx, r.tx), r.rz2);
  r.j11 = rmul(cam.fy, r.rz);
  r.j12 = rmul(rmul(-cam.fy, r.ty), r.rz2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.v0[k] = radd(rmul(r.j00, r.m[k]), rmul(r.j02, r.m[6 + k]));
    r.v1[k] = radd(rmul(r.j11, r.m[3 + k]), rmul(r.j12, r.m[6 + k]));
  }
  r.a = radd(radd(radd(rmul(r.v0[0], r.v0[0]), rmul(r.v0[1], r.v0[1])),
                rmul(r.v0[2], r.v0[2])),
            kEps2d);
  r.b = radd(radd(rmul(r.v0[0], r.v1[0]), rmul(r.v0[1], r.v1[1])),
            rmul(r.v0[2], r.v1[2]));
  r.c = radd(radd(radd(rmul(r.v1[0], r.v1[0]), rmul(r.v1[1], r.v1[1])),
                rmul(r.v1[2], r.v1[2])),
            kEps2d);
  r.det = rsub(rmul(r.a, r.c), rmul(r.b, r.b));
  r.det_ok = r.det > 0.0f;
  r.det_safe = r.det_ok ? r.det : 1.0f;
  r.conic[0] = rdiv(r.c, r.det_safe);
  r.conic[1] = rdiv(-r.b, r.det_safe);
  r.conic[2] = rdiv(r.a, r.det_safe);
}

// Copies `rows` rows of `W` floats, from row `row0` of `src`, into `dst`
// (dense, W floats a row), as 16-byte vectors where `src` allows.
template <int W>
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          float* dst, long long row0,
                                          int rows) {
  const float* g = src + row0 * W;
  const int count = rows * W;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int n4 = count >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < n4; i += kThreads) d4[i] = __ldg(g4 + i);
    done = n4 << 2;
  }
  for (int i = done + threadIdx.x; i < count; i += kThreads) dst[i] = __ldg(g + i);
}

// Writes `rows` rows of `W` floats from row `row0` on of `dst`; element j
// of row i comes from src[i * S + O + j] in shared memory.
template <int W, int S, int O>
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float* src, long long row0,
                                           int rows) {
  float* g = dst + row0 * W;
  const int count = rows * W;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int n4 = count >> 2;
    float4* g4 = reinterpret_cast<float4*>(g);
    for (int i = threadIdx.x; i < n4; i += kThreads) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * i + e;
        v[e] = src[(j / W) * S + O + j % W];
      }
      g4[i] = make_float4(v[0], v[1], v[2], v[3]);
    }
    done = n4 << 2;
  }
  for (int j = done + threadIdx.x; j < count; j += kThreads)
    g[j] = src[(j / W) * S + O + j % W];
}

__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        long long i, bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const float4*>(p) + i);
  p += 4 * i;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ void store4(float* __restrict__ p, long long i,
                                       bool aligned, float4 v) {
  if (aligned) {
    reinterpret_cast<float4*>(p)[i] = v;
    return;
  }
  p += 4 * i;
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
  p[3] = v.w;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

__device__ __forceinline__ float2 load2(const float* __restrict__ p,
                                        long long i) {
  if (aligned8(p)) return __ldg(reinterpret_cast<const float2*>(p) + i);
  return make_float2(__ldg(p + 2 * i), __ldg(p + 2 * i + 1));
}

__device__ __forceinline__ void store2(float* __restrict__ p, long long i,
                                       float2 v) {
  if (aligned8(p)) {
    reinterpret_cast<float2*>(p)[i] = v;
    return;
  }
  p[2 * i] = v.x;
  p[2 * i + 1] = v.y;
}

__global__ void __launch_bounds__(kThreads, kFwdBlocks)
project3d_fwd_kernel(const float* __restrict__ means,
                     const float* __restrict__ quats,
                     const float* __restrict__ scales,
                     const float* __restrict__ opacities,
                     const float* __restrict__ rgb,
                     const float* __restrict__ probe,
                     const float* __restrict__ viewmat,
                     const float* __restrict__ k, int width, int height,
                     long long n, float* __restrict__ fields,
                     float* __restrict__ radii, float* __restrict__ cull) {
  __shared__ __align__(16) float s_means[kThreads * 3];
  __shared__ __align__(16) float s_scales[kThreads * 3];
  __shared__ __align__(16) float s_rgb[kThreads * 3];
  __shared__ __align__(16) float s_fields[kThreads * 10];
  __shared__ Camera cam;
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(n - row0 < kThreads ? n - row0 : kThreads);
  load_rows<3>(means, s_means, row0, rows);
  load_rows<3>(scales, s_scales, row0, rows);
  if (rgb != nullptr) load_rows<3>(rgb, s_rgb, row0, rows);
  load_camera(cam, viewmat, k, width, height);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    const long long i = row0 + t;
    Row r;
    project_row(cam, s_means[3 * t], s_means[3 * t + 1], s_means[3 * t + 2],
                load4(quats, i, aligned16(quats)), s_scales[3 * t],
                s_scales[3 * t + 1], s_scales[3 * t + 2], r);
    const float op = __ldg(opacities + i);

    // radius = ceil(3 sqrt(max eigenvalue)), the radicand clipped at 0.01
    const float mid = rmul(0.5f, radd(r.a, r.c));
    const float lam = radd(
        mid, __fsqrt_rn(clamp_min(rsub(rmul(mid, mid), r.det), kRadicandMin)));
    const float radius = ceilf(rmul(3.0f, __fsqrt_rn(clamp_min(lam, 0.0f))));
    const float mean_x = radd(rmul(rmul(cam.fx, r.x), r.rz), cam.cx);
    const float mean_y = radd(rmul(rmul(cam.fy, r.y), r.rz), cam.cy);
    const bool valid = r.z_ok & r.det_ok & (radius > 0.0f) &
                       (radd(mean_x, radius) > 0.0f) &
                       (rsub(mean_x, radius) < static_cast<float>(width)) &
                       (radd(mean_y, radius) > 0.0f) &
                       (rsub(mean_y, radius) < static_cast<float>(height));
    const float rad = valid ? radius : 0.0f;

    // binning's cull radius r sqrt(2 ln(op / cutoff)) / 3, 0 below the cutoff
    const float inner =
        rmul(2.0f, logf(rmul(clamp_min(op, kOpacityMin), kInvCutoff)));
    const float root = inner > 0.0f ? __fsqrt_rn(inner) : 0.0f;
    const float cr = rmul(rad, rmul(root, kThird));
    radii[i] = rad;
    cull[i] = op >= kCutoff ? cr : 0.0f;

    float px = mean_x, py = mean_y;
    if (probe != nullptr) {
      const float2 pr = load2(probe, i);
      px = radd(px, pr.x);
      py = radd(py, pr.y);
    }
    float* f = s_fields + 10 * t;
    f[0] = px;
    f[1] = py;
    f[2] = r.conic[0];
    f[3] = r.conic[1];
    f[4] = r.conic[2];
    f[5] = op;
    f[6] = rgb != nullptr ? s_rgb[3 * t] : 0.0f;
    f[7] = rgb != nullptr ? s_rgb[3 * t + 1] : 0.0f;
    f[8] = rgb != nullptr ? s_rgb[3 * t + 2] : 0.0f;
    f[9] = r.z;
  }
  __syncthreads();
  store_rows<10, 10, 0>(fields, s_fields, row0, rows);
}

__global__ void __launch_bounds__(kThreads, kBwdBlocks)
project3d_bwd_kernel(const float* __restrict__ means,
                     const float* __restrict__ quats,
                     const float* __restrict__ scales,
                     const float* __restrict__ viewmat,
                     const float* __restrict__ k, int width, int height,
                     long long n, const float* __restrict__ d_fields,
                     float* __restrict__ d_means, float* __restrict__ d_quats,
                     float* __restrict__ d_scales,
                     float* __restrict__ d_opacities,
                     float* __restrict__ d_rgb, float* __restrict__ d_probe) {
  __shared__ __align__(16) float s_g[kThreads * 10];
  __shared__ __align__(16) float s_means[kThreads * 3];   // then d_means
  __shared__ __align__(16) float s_scales[kThreads * 3];  // then d_scales
  __shared__ Camera cam;
  const long long row0 = static_cast<long long>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(n - row0 < kThreads ? n - row0 : kThreads);
  load_rows<10>(d_fields, s_g, row0, rows);
  load_rows<3>(means, s_means, row0, rows);
  load_rows<3>(scales, s_scales, row0, rows);
  load_camera(cam, viewmat, k, width, height);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    const long long i = row0 + t;
    const float4 q = load4(quats, i, aligned16(quats));
    const float sv[3] = {s_scales[3 * t], s_scales[3 * t + 1],
                         s_scales[3 * t + 2]};
    Row r;
    project_row(cam, s_means[3 * t], s_means[3 * t + 1], s_means[3 * t + 2],
                q, sv[0], sv[1], sv[2], r);
    const float* g = s_g + 10 * t;

    // conic = (c, -b, a) / det_safe; det_safe = det where det > 0
    const float inv = 1.0f / r.det_safe;
    float da = g[4] * inv, db = -g[3] * inv, dc = g[2] * inv;
    if (r.det_ok) {
      const float ddet =
          -(g[2] * r.conic[0] + g[3] * r.conic[1] + g[4] * r.conic[2]) * inv;
      da += ddet * r.c;
      dc += ddet * r.a;
      db -= 2.0f * r.b * ddet;
    }
    // a = v0.v0 + eps, b = v0.v1, c = v1.v1 + eps
    float dv0[3], dv1[3];
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      dv0[kk] = 2.0f * r.v0[kk] * da + r.v1[kk] * db;
      dv1[kk] = 2.0f * r.v1[kk] * dc + r.v0[kk] * db;
    }
    // v0 = j00 M0 + j02 M2, v1 = j11 M1 + j12 M2
    float dj00 = 0.0f, dj02 = 0.0f, dj11 = 0.0f, dj12 = 0.0f, dm[9];
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      dj00 += dv0[kk] * r.m[kk];
      dj02 += dv0[kk] * r.m[6 + kk];
      dj11 += dv1[kk] * r.m[3 + kk];
      dj12 += dv1[kk] * r.m[6 + kk];
      dm[kk] = r.j00 * dv0[kk];
      dm[3 + kk] = r.j11 * dv1[kk];
      dm[6 + kk] = r.j02 * dv0[kk] + r.j12 * dv1[kk];
    }
    // the Jacobian and the means: mx = fx x rz + cx, my = fy y rz + cy
    const float gmx = g[0], gmy = g[1];
    float dx = cam.fx * r.rz * gmx, dy = cam.fy * r.rz * gmy;
    float drz = cam.fx * dj00 + cam.fy * dj11 + cam.fx * r.x * gmx +
                cam.fy * r.y * gmy;
    const float dtx = -cam.fx * r.rz2 * dj02, dty = -cam.fy * r.rz2 * dj12;
    const float drz2 = -cam.fx * r.tx * dj02 - cam.fy * r.ty * dj12;
    drz += 2.0f * r.rz * drz2;
    // rz = 1 / zs; tx = zs clamp(x / zs), no gradient through the clamp
    // outside [-lim, lim]
    float dzs = -r.rz2 * drz + r.clx * dtx + r.cly * dty;
    const float dux =
        (r.ux >= -cam.lim_x && r.ux <= cam.lim_x) ? r.zs * dtx : 0.0f;
    const float duy =
        (r.uy >= -cam.lim_y && r.uy <= cam.lim_y) ? r.zs * dty : 0.0f;
    dx += dux * r.rz;
    dy += duy * r.rz;
    dzs -= (dux * r.ux + duy * r.uy) * r.rz;
    // zs = z where near < z < far; the depth column is z on every row
    const float dz = g[9] + (r.z_ok ? dzs : 0.0f);
    const float dp[3] = {dx, dy, dz};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      s_means[3 * t + j] = cam.w[j] * dp[0] + cam.w[3 + j] * dp[1] +
                           cam.w[6 + j] * dp[2];
    }

    // M = (W R) S
    float dr[9];
#pragma unroll
    for (int kk = 0; kk < 3; ++kk) {
      s_scales[3 * t + kk] = dm[kk] * r.wr[kk] + dm[3 + kk] * r.wr[3 + kk] +
                             dm[6 + kk] * r.wr[6 + kk];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        dr[3 * j + kk] = sv[kk] * (cam.w[j] * dm[kk] + cam.w[3 + j] * dm[3 + kk] +
                                   cam.w[6 + j] * dm[6 + kk]);
      }
    }
    // R of the normalized quaternion (w, x, y, z)
    const float w = r.qn[0], x = r.qn[1], y = r.qn[2], z = r.qn[3];
    const float dw = 2.0f * (-z * dr[1] + y * dr[2] + z * dr[3] - x * dr[5] -
                             y * dr[6] + x * dr[7]);
    const float dqx =
        2.0f * (y * dr[1] + z * dr[2] + y * dr[3] - 2.0f * x * dr[4] -
                w * dr[5] + z * dr[6] + w * dr[7] - 2.0f * x * dr[8]);
    const float dqy =
        2.0f * (-2.0f * y * dr[0] + x * dr[1] + w * dr[2] + x * dr[3] +
                z * dr[5] - w * dr[6] + z * dr[7] - 2.0f * y * dr[8]);
    const float dqz =
        2.0f * (-2.0f * z * dr[0] - w * dr[1] + x * dr[2] + w * dr[3] -
                2.0f * z * dr[4] + y * dr[5] + x * dr[6] + y * dr[7]);
    // qn = q / clamp_min(|q|, 1e-12)
    const float inv_nc = 1.0f / r.norm_c;
    float4 dq = make_float4(dw * inv_nc, dqx * inv_nc, dqy * inv_nc,
                            dqz * inv_nc);
    if (r.norm >= kNormMin) {
      const float dot = dw * q.x + dqx * q.y + dqy * q.z + dqz * q.w;
      const float s = -dot * inv_nc * inv_nc * inv_nc;
      dq.x += q.x * s;
      dq.y += q.y * s;
      dq.z += q.z * s;
      dq.w += q.w * s;
    }
    store4(d_quats, i, aligned16(d_quats), dq);
    if (d_opacities != nullptr) d_opacities[i] = g[5];
    if (d_probe != nullptr) store2(d_probe, i, make_float2(gmx, gmy));
  }
  __syncthreads();
  store_rows<3, 3, 0>(d_means, s_means, row0, rows);
  store_rows<3, 3, 0>(d_scales, s_scales, row0, rows);
  if (d_rgb != nullptr) store_rows<3, 10, 6>(d_rgb, s_g, row0, rows);
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

// Forward over n rows on `stream`: means (n, 3), quats (n, 4), scales
// (n, 3), opacities (n,), rgb (n, 3) or null (zeros in the field row),
// probe (n, 2) or null, viewmat (4, 4), K (3, 3), all float32, contiguous
// and on the card; writes fields (n, 10), radii (n,) and cull (n,).
// Returns cudaGetLastError() as an int (0 = launched); n == 0 launches
// nothing.
extern "C" int project3d_fwd(const float* means, const float* quats,
                             const float* scales, const float* opacities,
                             const float* rgb, const float* probe,
                             const float* viewmat, const float* k, int width,
                             int height, long long n, float* fields,
                             float* radii, float* cull, void* stream) {
  if (n <= 0) return 0;
  project3d_fwd_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      means, quats, scales, opacities, rgb, probe, viewmat, k, width, height,
      n, fields, radii, cull);
  return static_cast<int>(cudaGetLastError());
}

// Backward over n rows on `stream`: the forward's means, quats, scales,
// viewmat, K, width and height, and d_fields (n, 10); writes d_means
// (n, 3), d_quats (n, 4), d_scales (n, 3) and, where not null,
// d_opacities (n,), d_rgb (n, 3) and d_probe (n, 2). Returns
// cudaGetLastError() as an int; n == 0 launches nothing.
extern "C" int project3d_bwd(const float* means, const float* quats,
                             const float* scales, const float* viewmat,
                             const float* k, int width, int height,
                             long long n, const float* d_fields,
                             float* d_means, float* d_quats, float* d_scales,
                             float* d_opacities, float* d_rgb, float* d_probe,
                             void* stream) {
  if (n <= 0) return 0;
  project3d_bwd_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      means, quats, scales, viewmat, k, width, height, n, d_fields, d_means,
      d_quats, d_scales, d_opacities, d_rgb, d_probe);
  return static_cast<int>(cudaGetLastError());
}
