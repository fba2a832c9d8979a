// Dense ICP's fetch: every sampled depth point moved by the pose, read
// against the TSDF slots of the submap atlas (or the monolithic volume)
// in place, and turned into its Gauss-Newton residual, gradient and
// robust weight, in one launch.
//
// Replaces no TPU kernel: the JAX package left its ICP
// (kbslam/mapping/icp.py) to XLA. The port's first version was plain
// torch (kbslam_torch/ops/icp.py keeps it as the twin): each solve copied
// its K slots into a fresh [K, V] tensor with an "unobserved" sentinel
// (about 10 GB of traffic for three 512^3 slots), and each of its nine
// fetches was ~150 small kernels.
//
// Per point p of the strided depth image (camera frame), at the pose
// (q, t), it computes what the twin's ``_residuals`` over
// ``fetch_reference`` computes on the card, operation for operation:
//
//   X = quat_rotate(q, p) + t
//   for k = 0..K-1, newest slot first: X_l = (X - t_k) R_k, or X when
//     the call has no anchors; the 2x2x2 corners around X_l in slot
//     slots[k]; the slot is valid iff all 8 lie inside the grid and are
//     observed (weight > 0: what the twin's sentinel encodes, a fused
//     tsdf lying in [-1, 1]); the first valid slot gives phi, the
//     trilinear tsdf, and grad, its analytic gradient from the same
//     corners, rotated to the world (grad R_k^T)
//   r = phi * truncation, g = grad * truncation,
//   w = min(huber / max(|r|, 1e-12), 1), wv = valid ? w : 0, valid =
//   some slot valid && ok[p] && |phi| < 0.999.
//
// The Gauss-Newton normal equations, the damped solve and the pose
// update stay in torch (ops/icp.py ``_gn_align``), as the twin runs them.
//
// Bit for bit: the dense benchmark cell's ICP refine amplifies a
// difference in the last bits of its sums to millimetres over its 8
// trips (the plane it sees leaves three directions to the damping), so
// the card's solve has to give the twin's bits, not nearly them. Every
// operation here is therefore one rounding of the twin's: each torch
// elementwise kernel is one float32 operation (written with the _rn
// intrinsics, which the compiler never fuses), a torch cross product is
// a*b - c*d with the first product fused (fmaf), a [.., 3] x [3, 3]
// matmul is an fmaf chain over k = 0, 1, 2, a sum over a short last axis
// is a shuffle tree, a division by a Python float h is a product by
// the double 1 / h rounded to float32, and a Python float over a tensor
// is the tensor's reciprocal times the float (torch's __rtruediv__).
// These are torch's CUDA kernels as they stand, not a contract:
// tests/test_torch_cuda.py holds the kernel's outputs, and the solve,
// equal to the twin's on the card, and fails where a torch release
// rounds otherwise.
//
// What bounds it on the H100: latency, not bytes. A fetch reads 8
// corners' tsdf and weight of 19,200 points in at most 3 slots (3.7 MB)
// and writes 19,200 x 33 bytes: ~1.3 us at 3.35 TB/s. But each point's
// reads are scattered 4-byte loads behind the dependent pose transform,
// and a launch costs a few microseconds. The design: no repack (the
// corners are read straight from tsdf[slots[k]] and weight[slots[k]]);
// a point stops at its first valid slot, so most points read one slot,
// not three; a slot's 16 loads are issued together; one point per
// thread, so there is no reduction and no atomic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

struct Grid {
    int nx, ny, nz;
    float ox, oy, oz;
    float inv_h;   // (float)(1.0 / voxel_size), as torch's division rounds it
};

// a * b - c * d as torch's cross kernel rounds it: the first product fused
__device__ __forceinline__ float mul_sub(float a, float b, float c, float d) {
    return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
    out[0] = mul_sub(a[1], b[2], a[2], b[1]);
    out[1] = mul_sub(a[2], b[0], a[0], b[2]);
    out[2] = mul_sub(a[0], b[1], a[1], b[0]);
}

// sum_k a[k] * B[k * sk], as a torch matmul with an inner size of 3
// rounds it
__device__ __forceinline__ float dot3(const float a[3], const float* B,
                                      int sk) {
    return __fmaf_rn(a[2], B[2 * sk], __fmaf_rn(a[1], B[sk],
                                                __fmul_rn(a[0], B[0])));
}

// A torch sum over a last axis of N = 4 or 8 elements on the card: N
// lanes, each with one element, folded by shuffles down at offsets N/2,
// ..., 2, 1 (ATen/native/cuda/Reduce.cuh block_x_reduce)
template <int N>
__device__ __forceinline__ float sum_last_axis(float v[N]) {
#pragma unroll
    for (int offset = N / 2; offset > 0; offset /= 2)
#pragma unroll
        for (int i = 0; i < offset; ++i) v[i] = __fadd_rn(v[i], v[i + offset]);
    return v[0];
}

// Trilinear tsdf and its gradient at the local point xl in one slot;
// false where a corner lies outside the grid or is unobserved.
__device__ __forceinline__ bool trilinear(const float* __restrict__ tsdf,
                                          const float* __restrict__ weight,
                                          const Grid& g, const float xl[3],
                                          float* phi, float grad[3]) {
    const int n[3] = {g.nx, g.ny, g.nz};
    const float o[3] = {g.ox, g.oy, g.oz};
    int i0[3];
    float f[3];
    for (int a = 0; a < 3; ++a) {
        const float c = __fsub_rn(__fmul_rn(__fsub_rn(xl[a], o[a]), g.inv_h),
                                  0.5f);
        const float fl = floorf(c);
        if (!(fl >= 0.0f && fl <= static_cast<float>(n[a] - 2))) return false;
        i0[a] = static_cast<int>(fl);
        f[a] = __fsub_rn(c, fl);
    }
    const int base = (i0[0] * g.ny + i0[1]) * g.nz + i0[2];
    float c[8], w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {     // bit 2 -> +x, bit 1 -> +y, bit 0 -> +z
        const int off = ((k >> 2) * g.ny + ((k >> 1) & 1)) * g.nz + (k & 1);
        w[k] = __ldg(weight + base + off);
        c[k] = __ldg(tsdf + base + off);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k)
        if (!(w[k] > 0.0f)) return false;
    const float wx[2] = {__fsub_rn(1.0f, f[0]), f[0]},
                wy[2] = {__fsub_rn(1.0f, f[1]), f[1]},
                wz[2] = {__fsub_rn(1.0f, f[2]), f[2]};
    float terms[8], dx[4], dy[4], dz[4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const float wk = __fmul_rn(__fmul_rn(wx[k >> 2], wy[(k >> 1) & 1]),
                                   wz[k & 1]);
        terms[k] = __fmul_rn(c[k], wk);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            dx[2 * i + j] = __fmul_rn(
                __fsub_rn(c[4 + 2 * i + j], c[2 * i + j]),
                __fmul_rn(wy[i], wz[j]));
            dy[2 * i + j] = __fmul_rn(
                __fsub_rn(c[4 * i + 2 + j], c[4 * i + j]),
                __fmul_rn(wx[i], wz[j]));
            dz[2 * i + j] = __fmul_rn(__fsub_rn(c[4 * i + 2 * j + 1],
                                                c[4 * i + 2 * j]),
                                      __fmul_rn(wx[i], wy[j]));
        }
    }
    *phi = sum_last_axis<8>(terms);
    grad[0] = __fmul_rn(sum_last_axis<4>(dx), g.inv_h);
    grad[1] = __fmul_rn(sum_last_axis<4>(dy), g.inv_h);
    grad[2] = __fmul_rn(sum_last_axis<4>(dz), g.inv_h);
    return true;
}

__global__ void __launch_bounds__(kThreads) icp_fetch_kernel(
        const float* __restrict__ tsdf, const float* __restrict__ weight,
        int ring, long long slot_stride, const int* __restrict__ slots, int K,
        const float* __restrict__ anchor_R, const float* __restrict__ anchor_t,
        const float* __restrict__ points, const bool* __restrict__ ok, int P,
        const float* __restrict__ q, const float* __restrict__ t, Grid grid,
        float truncation, float huber, float* __restrict__ X_out,
        float* __restrict__ r_out, float* __restrict__ g_out,
        float* __restrict__ wv_out, bool* __restrict__ valid_out) {
    const int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= P) return;
    // X = v + 2 (w (u x v) + u x (u x v)) + t, u = q[1:4], w = q[0]
    const float u[3] = {q[1], q[2], q[3]};
    const float v[3] = {points[3 * p], points[3 * p + 1], points[3 * p + 2]};
    float uv[3], uuv[3], X[3];
    cross(u, v, uv);
    cross(u, uv, uuv);
    for (int a = 0; a < 3; ++a) {
        const float s = __fmul_rn(2.0f, __fadd_rn(__fmul_rn(q[0], uv[a]),
                                                  uuv[a]));
        X[a] = __fadd_rn(__fadd_rn(v[a], s), t[a]);
    }
    float phi = 0.0f, gw[3] = {0.0f, 0.0f, 0.0f};
    bool found = false;
    for (int k = 0; k < K && !found; ++k) {
        const int slot = slots[k];
        if (slot < 0 || slot >= ring) continue;
        const float* R = anchor_R == nullptr ? nullptr : anchor_R + 9 * k;
        float xl[3] = {X[0], X[1], X[2]}, grad[3];
        if (R != nullptr) {                    // X_l = (X - t_k) R_k
            const float d[3] = {__fsub_rn(X[0], anchor_t[3 * k]),
                                __fsub_rn(X[1], anchor_t[3 * k + 1]),
                                __fsub_rn(X[2], anchor_t[3 * k + 2])};
            for (int j = 0; j < 3; ++j) xl[j] = dot3(d, R + j, 3);
        }
        found = trilinear(tsdf + slot * slot_stride,
                          weight + slot * slot_stride, grid, xl, &phi, grad);
        if (!found) continue;
        for (int i = 0; i < 3; ++i)            // to the world: grad R_k^T
            gw[i] = R == nullptr ? grad[i] : dot3(grad, R + 3 * i, 1);
    }
    // phi and gw stay 0 where no slot is valid; the twin sums the chosen
    // slot's values with zeros, so -0 becomes +0
    phi = __fadd_rn(phi, 0.0f);
    const bool valid = found && ok[p] && fabsf(phi) < 0.999f;
    const float r = __fmul_rn(phi, truncation);
    const float w = fminf(__fmul_rn(__frcp_rn(fmaxf(fabsf(r), 1e-12f)), huber),
                          1.0f);
    for (int a = 0; a < 3; ++a) {
        X_out[3 * p + a] = X[a];
        g_out[3 * p + a] = __fmul_rn(__fadd_rn(gw[a], 0.0f), truncation);
    }
    r_out[p] = r;
    wv_out[p] = valid ? w : 0.0f;
    valid_out[p] = valid;
}

}  // namespace

extern "C" {

// One fetch of every point at the pose (q [4], t [3]), writing X [P, 3],
// r [P], g [P, 3], wv [P] and valid [P]. The corners of slot slots[k]
// start at tsdf + slots[k] * slot_stride (and weight); a slot outside
// [0, ring) is never valid. anchor_R [K, 3, 3] (row-major) and anchor_t
// [K, 3] re-pose slot k, or are both null: the points are then read in
// world coordinates. Launches on `stream` (a cudaStream_t); returns
// cudaGetLastError().
int kbslam_icp_fetch(const float* tsdf, const float* weight, int ring,
                     long long slot_stride, const int* slots, int K,
                     const float* anchor_R, const float* anchor_t,
                     const float* points, const bool* ok, int P,
                     const float* q, const float* t, int nx, int ny, int nz,
                     float ox, float oy, float oz, float inv_h,
                     float truncation, float huber, float* X_out,
                     float* r_out, float* g_out, float* wv_out,
                     bool* valid_out, void* stream) {
    const Grid grid{nx, ny, nz, ox, oy, oz, inv_h};
    const int blocks = (P + kThreads - 1) / kThreads;
    const auto st = static_cast<cudaStream_t>(stream);
    icp_fetch_kernel<<<blocks, kThreads, 0, st>>>(
        tsdf, weight, ring, slot_stride, slots, K, anchor_R, anchor_t, points,
        ok, P, q, t, grid, truncation, huber, X_out, r_out, g_out, wv_out,
        valid_out);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
