// The pose heads after their linear layers, forward and backward, by hand for
// Hopper (sm_90a): one launch each.
//
// Replaces no TPU kernel: the JAX package leaves this arithmetic to XLA, which
// fuses it. It was added because the port ran it as PyTorch ops on tensors of
// (64, 4) to (64, 68, 4) f32, about 1,000 launch-bound kernels a training
// step (346 in the forward, the rest autograd's), about 17% of the step on the
// H100.
//
// What it computes (models/posenet.py:NetworkWithPointHead._heads_fused;
// kernels/heads.py holds the plain version and derives the backward), per
// sample b from the head linears' f32 outputs:
//   u = (z_q[0..2], smoothclip0(z_q[3])), q = u / max(|u|, 1e-6);
//   for each offset (local_pose_offset, _kpts) and p its row set_id[b] (row 0
//   without ids): rotation q (sin(p1/2), 0, 0, cos(p1/2)), scale
//   size * smoothclip0(p3), position xy + rotate(q, (0, p1, p2))[:2] * scale;
//   the box from z_box; the keypoints l_i = keypts_i + sum_k shape_k E[k, i]
//   (68 x 3, full f32), rotated by the second offset's rotation, scaled by its
//   scale, shifted in xy by its position; with uncertainty the two
//   lower-triangular scales from their necks and, once a call, the three
//   diagonal scale vectors. smoothclip0 is elu + 1 (expm1 at and below 0, as
//   PyTorch's elu), rotate(q, p) the vector part of q (p, 0) conj(q).
// The backward recomputes these from the inputs (nothing is saved but the
// inputs) and takes the gradients back through them: for r = u v (Hamilton),
// dL/du = dr conj(v) and dL/dv = conj(u) dr.
//
// What bounds it on the H100: the launch. A call reads ~42 KB that every
// sample shares (the blend's 50 x 204 eigenvectors, the keypoints) and moves
// ~1.3 KB a sample forward, ~2.5 KB backward: about 0.04 us at 3.35 TB/s at
// B = 64; the blend is 10,200 multiply-adds a sample. What the design does:
//   - one CTA of 128 threads a sample: threads 0-67 a keypoint each (warps
//     0-2); the last warp's lanes 0-3 take the rotation, position and offsets,
//     the two triangular scales and the box at the same time. B = 64 takes
//     half the SMs, B = 512 all of them;
//   - a sample's intermediates stay in registers and shared memory; only the
//     inputs, the outputs and, backward, 32 bytes a sample of the offsets'
//     gradient shares touch device memory; E is read through L1/L2 (__ldg),
//     a warp's loads on consecutive words;
//   - the 68 keypoints' shares of the rotation's, scale's and position's
//     gradients are summed by a shuffle tree a warp and then the 3 warps in
//     order; the shape gradient (50 dot products over 204 values) by a warp
//     a parameter over consecutive words;
//   - the offsets' gradients are sums over the samples that chose a row: each
//     CTA writes its sample's share, and the CTA that takes the last ticket
//     (an integer atomic) sums them, a warp a row, lanes over the samples,
//     then a shuffle tree: a fixed order and no float atomics, so the same
//     inputs give the same bits. It also takes the diagonal scales'
//     gradients. The forward zeroes the ticket; the last CTA zeroes it again.
// A set_id outside [0, rows) makes that sample's outputs NaN and its share
// count for no row.

#include <initializer_list>

#include "nntc_kernels.h"

namespace {

namespace S = nntc_heads;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPoints = 68, kEig = 50, kCoords = 3 * kPoints;
constexpr int kPointWarps = (kPoints + 31) / 32;  // 3; the last warp takes the scalar heads
constexpr int kPose = kPointWarps * 32;          // lane 0 of the last warp: rotation, position, offsets
constexpr int kTrilRot = kPose + 1, kTrilCoord = kPose + 2, kBox = kPose + 3;
constexpr int kPartial = 8;  // a sample's share: 4 of local_pose_offset's row, 4 of _kpts's
constexpr float kQuatEps = 1.0e-6f, kScaleEps = 1.0e-6f;

struct Slots {
    void* p[S::count];
};

__device__ __forceinline__ const float* in(const Slots& s, int i) { return static_cast<const float*>(s.p[i]); }
__device__ __forceinline__ float* out(const Slots& s, int i) { return static_cast<float*>(s.p[i]); }

struct Quat {
    float x, y, z, w;
};

// Hamilton product, as ops/quaternion.py:mult writes it (real part last).
__device__ __forceinline__ Quat qmul(const Quat& u, const Quat& v) {
    return {u.w * v.x + u.x * v.w + u.y * v.z - u.z * v.y, u.w * v.y - u.x * v.z + u.y * v.w + u.z * v.x,
            u.w * v.z + u.x * v.y - u.y * v.x + u.z * v.w, u.w * v.w - u.x * v.x - u.y * v.y - u.z * v.z};
}
__device__ __forceinline__ Quat qconj(const Quat& q) { return {-q.x, -q.y, -q.z, q.w}; }
__device__ __forceinline__ Quat qadd(const Quat& a, const Quat& b) { return {a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w}; }
__device__ __forceinline__ Quat load4(const float* p) { return {p[0], p[1], p[2], p[3]}; }
__device__ __forceinline__ Quat load4_or_zero(const float* p) { return p ? load4(p) : Quat{0.f, 0.f, 0.f, 0.f}; }
__device__ __forceinline__ void store4(float* p, const Quat& q) {
    p[0] = q.x;
    p[1] = q.y;
    p[2] = q.z;
    p[3] = q.w;
}

__device__ __forceinline__ float smoothclip0(float x) { return (x <= 0.f ? expm1f(x) : x) + 1.f; }
__device__ __forceinline__ float dsmoothclip0(float x) { return x <= 0.f ? expf(x) : 1.f; }

// The lane-0 sum of v over the warp, in a fixed tree order.
__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// A sample's rotation and position before the offsets.
struct Head {
    Quat u, q;
    float norm, x, y, size;
};

__device__ Head head(const Slots& s, int b) {
    const float* z = in(s, S::quat) + 4 * b;
    Head h;
    h.u = {z[0], z[1], z[2], smoothclip0(z[3])};
    h.norm = sqrtf(h.u.x * h.u.x + h.u.y * h.u.y + h.u.z * h.u.z + h.u.w * h.u.w);
    const float d = fmaxf(h.norm, kQuatEps);
    h.q = {h.u.x / d, h.u.y / d, h.u.z / d, h.u.w / d};
    h.x = in(s, S::xy)[2 * b];
    h.y = in(s, S::xy)[2 * b + 1];
    h.size = smoothclip0(in(s, S::size)[b]);
    return h;
}

// The row of offset `which` that sample b chose, NaN for an id out of range.
__device__ Quat offset_row(const Slots& s, int which, int b, int rows) {
    const int* ids = static_cast<const int*>(s.p[S::set_id]);
    const int r = ids ? ids[b] : 0;
    if (r < 0 || r >= rows) {
        const float nan = __int_as_float(0x7fffffff);
        return {nan, nan, nan, nan};
    }
    return load4(in(s, which) + 4 * r);
}

// components.offset_pose for one sample, with what its backward needs.
struct Offset {
    Quat o, transl, a, pos, rot;  // the x rotation, (0, p1, p2, 0), q transl, a conj(q), q o
    float scale_factor, scale, x, y;
};

__device__ Offset offset_pose(const Head& h, const Quat& p) {
    Offset f;
    const float half = 0.5f * p.y;
    f.o = {sinf(half), 0.f, 0.f, cosf(half)};
    f.transl = {0.f, p.y, p.z, 0.f};
    f.scale_factor = smoothclip0(p.w);
    f.scale = h.size * f.scale_factor;
    f.rot = qmul(h.q, f.o);
    f.a = qmul(h.q, f.transl);
    f.pos = qmul(f.a, qconj(h.q));
    f.x = f.pos.x * f.scale + h.x;
    f.y = f.pos.y * f.scale + h.y;
    return f;
}

// Adds the gradient of offset_pose's outputs (rotation drot, position gx, gy,
// scale gs) to those of q and of (x, y, size); returns the row's share.
__device__ Quat offset_pose_backward(const Head& h, const Offset& f, const Quat& p, const Quat& drot, float gx,
                                     float gy, float gs, Quat& dq, float& dx, float& dy, float& dsize) {
    const float dscale = gs + gx * f.pos.x + gy * f.pos.y;
    dx += gx;
    dy += gy;
    dsize += dscale * f.scale_factor;
    const Quat dpos = {gx * f.scale, gy * f.scale, 0.f, 0.f};
    const Quat da = qmul(dpos, h.q);
    const Quat dtransl = qmul(qconj(h.q), da);
    const Quat dO = qmul(qconj(h.q), drot);
    dq = qadd(dq, qadd(qadd(qmul(da, qconj(f.transl)), qmul(qconj(dpos), f.a)), qmul(drot, qconj(f.o))));
    return {0.f, dtransl.y + 0.5f * (dO.x * f.o.w - dO.w * f.o.x), dtransl.z,
            dscale * h.size * dsmoothclip0(p.w)};
}

// nll.triangular_scale(3, y, min_diag) of one sample into m (3, 3).
__device__ void triangular_scale(const float* y, const float* min_diag, float* m) {
    const float mult = smoothclip0(y[0]);
    float z[6];
    for (int j = 0; j < 6; ++j) z[j] = mult * (j < 3 ? smoothclip0(y[1 + j]) : y[1 + j]) + min_diag[j];
    const float lower[9] = {z[0], 0.f, 0.f, z[3], z[1], 0.f, z[4], z[5], z[2]};
    for (int j = 0; j < 9; ++j) m[j] = lower[j];
}

__device__ void triangular_scale_backward(const float* y, const float* dm, float* dy) {
    const float mult = smoothclip0(y[0]);
    float dz[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (dm) {
        dz[0] = dm[0], dz[1] = dm[4], dz[2] = dm[8], dz[3] = dm[3], dz[4] = dm[6], dz[5] = dm[7];
    }
    float dmult = 0.f;
    for (int j = 0; j < 6; ++j) {
        const float v = y[1 + j];
        dmult += dz[j] * (j < 3 ? smoothclip0(v) : v);
        dy[1 + j] = dz[j] * mult * (j < 3 ? dsmoothclip0(v) : 1.f);
    }
    dy[0] = dmult * dsmoothclip0(y[0]);
}

// nll.diagonal_scale(h, 1e-6), n values, by the CTA's threads.
__device__ void diagonal_scale(const float* h, float* s, int n) {
    for (int i = threadIdx.x; i < n; i += kThreads) s[i] = smoothclip0(h[0]) * smoothclip0(h[1 + i]) + kScaleEps;
}

__device__ void diagonal_scale_backward(const float* h, const float* ds, float* dh, int n) {
    const float mult = smoothclip0(h[0]);
    for (int i = threadIdx.x; i < n; i += kThreads) dh[1 + i] = ds ? ds[i] * mult * dsmoothclip0(h[1 + i]) : 0.f;
    if (threadIdx.x == kThreads - 1) {
        float acc = 0.f;
        if (ds)
            for (int i = 0; i < n; ++i) acc += ds[i] * smoothclip0(h[1 + i]);
        dh[0] = acc * dsmoothclip0(h[0]);
    }
}

// Keypoint t of sample b before the pose: keypts_t + sum_k shape_k E[k, t].
__device__ __forceinline__ void blend(const Slots& s, const float* shape, int t, float l[3]) {
    const float* e = in(s, S::keyeigvecs) + 3 * t;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 10
    for (int k = 0; k < kEig; ++k, e += kCoords) {
        const float z = shape[k];
        a0 += z * __ldg(e);
        a1 += z * __ldg(e + 1);
        a2 += z * __ldg(e + 2);
    }
    const float* kp = in(s, S::keypts) + 3 * t;
    l[0] = a0 + kp[0];
    l[1] = a1 + kp[1];
    l[2] = a2 + kp[2];
}

// The keypoints' pose, which the last warp hands to the keypoint warps.
struct Posed {
    Quat q;
    float x, y, scale;
};

__global__ void __launch_bounds__(kThreads) nntc_pose_heads_forward_kernel(Slots s, int rows) {
    __shared__ float shape[kEig];
    __shared__ Posed posed;
    const int b = blockIdx.x, t = threadIdx.x;
    if (t < kEig) shape[t] = in(s, S::shape)[kEig * b + t];
    if (t == kPose) {
        const Head h = head(s, b);
        const Offset f = offset_pose(h, offset_row(s, S::offset, b, rows));
        const Offset k = offset_pose(h, offset_row(s, S::offset_kpts, b, rows));
        store4(out(s, S::rot) + 4 * b, f.rot);
        store4(out(s, S::unnormalized_quat) + 4 * b, h.u);
        float* c = out(s, S::coord) + 3 * b;
        c[0] = f.x, c[1] = f.y, c[2] = f.scale;
        posed = {k.rot, k.x, k.y, k.scale};
    } else if (t == kTrilRot && s.p[S::neck_rot]) {
        triangular_scale(in(s, S::neck_rot) + 7 * b, in(s, S::min_diag_rot), out(s, S::pose_scales_tril) + 9 * b);
    } else if (t == kTrilCoord && s.p[S::neck_coord]) {
        triangular_scale(in(s, S::neck_coord) + 7 * b, in(s, S::min_diag_coord), out(s, S::coord_scales) + 9 * b);
    } else if (t == kBox) {
        const float* z = in(s, S::box) + 4 * b;
        const float sx = smoothclip0(z[2]), sy = smoothclip0(z[3]);
        float* r = out(s, S::roi) + 4 * b;
        r[0] = z[0] - sx, r[1] = z[1] - sy, r[2] = z[0] + sx, r[3] = z[1] + sy;
    }
    __syncthreads();
    if (t < kPoints) {
        float l[3];
        blend(s, shape, t, l);
        const Quat r = qmul(qmul(posed.q, {l[0], l[1], l[2], 0.f}), qconj(posed.q));
        float* pt = out(s, S::pt3d_68) + kCoords * b + 3 * t;
        pt[0] = r.x * posed.scale + posed.x;
        pt[1] = r.y * posed.scale + posed.y;
        pt[2] = r.z * posed.scale;
    }
    if (b == 0) {
        if (s.p[S::hidden_roi]) {
            diagonal_scale(in(s, S::hidden_roi), out(s, S::roi_scales), 4);
            diagonal_scale(in(s, S::hidden_pt3d), out(s, S::pt3d_68_scales), kPoints);
            diagonal_scale(in(s, S::hidden_shape), out(s, S::shapeparam_scales), kEig);
        }
        if (t == 0 && s.p[S::ticket]) *static_cast<int*>(s.p[S::ticket]) = 0;
    }
}

__global__ void __launch_bounds__(kThreads) nntc_pose_heads_backward_kernel(Slots s, int rows) {
    constexpr int kSums = 7;  // the keypoints' shares: the rotation's 4, the scale's, the position's 2
    __shared__ float shape[kEig];
    __shared__ float dlocal[kCoords];
    __shared__ float sums[kPointWarps][kSums];
    __shared__ Posed posed;
    __shared__ bool last;
    const int b = blockIdx.x, t = threadIdx.x, warp = t / 32, lane = t % 32;
    if (t < kEig) shape[t] = in(s, S::shape)[kEig * b + t];
    Head h;
    Offset f, k;
    Quat p, pk;
    if (t == kPose) {
        h = head(s, b);
        p = offset_row(s, S::offset, b, rows);
        pk = offset_row(s, S::offset_kpts, b, rows);
        f = offset_pose(h, p);
        k = offset_pose(h, pk);
        posed = {k.rot, k.x, k.y, k.scale};
    } else if (t == kTrilRot && s.p[S::neck_rot]) {
        triangular_scale_backward(in(s, S::neck_rot) + 7 * b,
                                  s.p[S::g_pose_scales_tril] ? in(s, S::g_pose_scales_tril) + 9 * b : nullptr,
                                  out(s, S::d_neck_rot) + 7 * b);
    } else if (t == kTrilCoord && s.p[S::neck_coord]) {
        triangular_scale_backward(in(s, S::neck_coord) + 7 * b,
                                  s.p[S::g_coord_scales] ? in(s, S::g_coord_scales) + 9 * b : nullptr,
                                  out(s, S::d_neck_coord) + 7 * b);
    } else if (t == kBox) {
        const float* z = in(s, S::box) + 4 * b;
        const Quat g = load4_or_zero(s.p[S::g_roi] ? in(s, S::g_roi) + 4 * b : nullptr);
        float* d = out(s, S::d_box) + 4 * b;
        d[0] = g.x + g.z, d[1] = g.y + g.w;
        d[2] = (g.z - g.x) * dsmoothclip0(z[2]), d[3] = (g.w - g.y) * dsmoothclip0(z[3]);
    }
    __syncthreads();

    // Keypoint t: pt = rotate(q_k, l) * scale + (x, y, 0) taken back to l, q_k, scale and (x, y).
    if (warp < kPointWarps) {
        float v[kSums] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (t < kPoints) {
            float l[3];
            blend(s, shape, t, l);
            const float* gp = s.p[S::g_pt3d_68] ? in(s, S::g_pt3d_68) + kCoords * b + 3 * t : nullptr;
            const float g0 = gp ? gp[0] : 0.f, g1 = gp ? gp[1] : 0.f, g2 = gp ? gp[2] : 0.f;
            const Quat L = {l[0], l[1], l[2], 0.f};
            const Quat a = qmul(posed.q, L);
            const Quat r = qmul(a, qconj(posed.q));
            const Quat dr = {g0 * posed.scale, g1 * posed.scale, g2 * posed.scale, 0.f};
            const Quat da = qmul(dr, posed.q);
            const Quat dq = qadd(qmul(da, qconj(L)), qmul(qconj(dr), a));
            const Quat dl = qmul(qconj(posed.q), da);
            dlocal[3 * t] = dl.x, dlocal[3 * t + 1] = dl.y, dlocal[3 * t + 2] = dl.z;
            v[0] = dq.x, v[1] = dq.y, v[2] = dq.z, v[3] = dq.w;
            v[4] = g0 * r.x + g1 * r.y + g2 * r.z;
            v[5] = g0, v[6] = g1;
        }
        for (int j = 0; j < kSums; ++j) {
            const float total = warp_sum(v[j]);
            if (lane == 0) sums[warp][j] = total;
        }
    }
    __syncthreads();

    if (warp < kPointWarps) {  // d shape_k = sum_i dlocal_i E[k, i], a warp a parameter
        const float* e = in(s, S::keyeigvecs);
        for (int j = warp; j < kEig; j += kPointWarps) {
            float acc = 0.f;
            for (int i = lane; i < kCoords; i += 32) acc += dlocal[i] * __ldg(e + kCoords * j + i);
            acc = warp_sum(acc);
            if (lane == 0) out(s, S::d_shape)[kEig * b + j] = acc;
        }
    } else if (t == kPose) {
        float g[kSums];
        for (int j = 0; j < kSums; ++j) {
            g[j] = 0.f;
            for (int w = 0; w < kPointWarps; ++w) g[j] += sums[w][j];
        }
        Quat dq = {0.f, 0.f, 0.f, 0.f};
        float dx = 0.f, dy = 0.f, dsize = 0.f;
        const Quat share_k = offset_pose_backward(h, k, pk, {g[0], g[1], g[2], g[3]}, g[5], g[6], g[4], dq, dx, dy,
                                                  dsize);
        const float* gc = s.p[S::g_coord] ? in(s, S::g_coord) + 3 * b : nullptr;
        const Quat share = offset_pose_backward(h, f, p, load4_or_zero(s.p[S::g_rot] ? in(s, S::g_rot) + 4 * b : nullptr),
                                                gc ? gc[0] : 0.f, gc ? gc[1] : 0.f, gc ? gc[2] : 0.f, dq, dx, dy, dsize);
        // q = u / max(|u|, eps): clamp passes the gradient where |u| >= eps
        Quat du;
        if (h.norm >= kQuatEps) {
            const float qd = h.q.x * dq.x + h.q.y * dq.y + h.q.z * dq.z + h.q.w * dq.w;
            du = {(dq.x - h.q.x * qd) / h.norm, (dq.y - h.q.y * qd) / h.norm, (dq.z - h.q.z * qd) / h.norm,
                  (dq.w - h.q.w * qd) / h.norm};
        } else {
            du = {dq.x / kQuatEps, dq.y / kQuatEps, dq.z / kQuatEps, dq.w / kQuatEps};
        }
        du = qadd(du, load4_or_zero(s.p[S::g_unnormalized_quat] ? in(s, S::g_unnormalized_quat) + 4 * b : nullptr));
        du.w *= dsmoothclip0(in(s, S::quat)[4 * b + 3]);
        store4(out(s, S::d_quat) + 4 * b, du);
        out(s, S::d_xy)[2 * b] = dx;
        out(s, S::d_xy)[2 * b + 1] = dy;
        out(s, S::d_size)[b] = dsize * dsmoothclip0(in(s, S::size)[b]);
        float* share_out = out(s, S::partial) + kPartial * b;
        store4(share_out, share);
        store4(share_out + 4, share_k);
    }

    // The last CTA to finish sums the shares into the rows' gradients.
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(static_cast<int*>(s.p[S::ticket]), 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int* ids = static_cast<const int*>(s.p[S::set_id]);
    const float* partial = in(s, S::partial);
    for (int r = warp; r < rows; r += kWarps) {
        float acc[kPartial] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int i = lane; i < (int)gridDim.x; i += 32) {
            if ((ids ? ids[i] : 0) != r) continue;
            for (int j = 0; j < kPartial; ++j) acc[j] += __ldcg(partial + kPartial * i + j);
        }
        for (int j = 0; j < kPartial; ++j) {
            const float total = warp_sum(acc[j]);
            if (lane == 0) out(s, j < 4 ? S::d_offset : S::d_offset_kpts)[4 * r + j % 4] = total;
        }
    }
    if (s.p[S::hidden_roi]) {
        diagonal_scale_backward(in(s, S::hidden_roi), in(s, S::g_roi_scales), out(s, S::d_hidden_roi), 4);
        diagonal_scale_backward(in(s, S::hidden_pt3d), in(s, S::g_pt3d_68_scales), out(s, S::d_hidden_pt3d), kPoints);
        diagonal_scale_backward(in(s, S::hidden_shape), in(s, S::g_shapeparam_scales), out(s, S::d_hidden_shape),
                                kEig);
    }
    if (t == 0) *static_cast<int*>(s.p[S::ticket]) = 0;
}

bool filled(const Slots& s, std::initializer_list<int> slots) {
    for (int i : slots)
        if (!s.p[i]) return false;
    return true;
}

bool scales_consistent(const Slots& s, std::initializer_list<int> slots) {
    int n = 0;
    for (int i : slots) n += s.p[i] != nullptr;
    return n == 0 || n == (int)slots.size();
}

}  // namespace

cudaError_t nntc_pose_heads_forward(void* const* slots, int B, int rows, cudaStream_t stream) {
    Slots s;
    for (int i = 0; i < S::count; ++i) s.p[i] = slots[i];
    if (B < 1 || rows < 1 ||
        !filled(s, {S::quat, S::xy, S::size, S::box, S::shape, S::offset, S::offset_kpts, S::keypts, S::keyeigvecs,
                    S::rot, S::unnormalized_quat, S::coord, S::roi, S::pt3d_68}) ||
        !scales_consistent(s, {S::neck_rot, S::neck_coord, S::min_diag_rot, S::min_diag_coord, S::hidden_roi,
                               S::hidden_pt3d, S::hidden_shape, S::pose_scales_tril, S::coord_scales, S::roi_scales,
                               S::pt3d_68_scales, S::shapeparam_scales}))
        return cudaErrorInvalidValue;
    nntc_pose_heads_forward_kernel<<<B, kThreads, 0, stream>>>(s, rows);
    return cudaGetLastError();
}

cudaError_t nntc_pose_heads_backward(void* const* slots, int B, int rows, cudaStream_t stream) {
    Slots s;
    for (int i = 0; i < S::count; ++i) s.p[i] = slots[i];
    if (B < 1 || rows < 1 ||
        !filled(s, {S::quat, S::xy, S::size, S::box, S::shape, S::offset, S::offset_kpts, S::keypts, S::keyeigvecs,
                    S::d_quat, S::d_xy, S::d_size, S::d_box, S::d_shape, S::d_offset, S::d_offset_kpts, S::partial,
                    S::ticket}) ||
        !scales_consistent(s, {S::neck_rot, S::neck_coord, S::min_diag_rot, S::min_diag_coord, S::hidden_roi,
                               S::hidden_pt3d, S::hidden_shape, S::d_neck_rot, S::d_neck_coord, S::d_hidden_roi,
                               S::d_hidden_pt3d, S::d_hidden_shape}))
        return cudaErrorInvalidValue;
    nntc_pose_heads_backward_kernel<<<B, kThreads, 0, stream>>>(s, rows);
    return cudaGetLastError();
}
