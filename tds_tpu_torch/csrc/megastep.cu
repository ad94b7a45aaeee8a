// The whole laikago control step, sim_step, fused into one kernel launch:
// one thread per environment. Built by tds_tpu_torch/envs/fused_step.py
// (through tds_tpu_torch/utils/cuda_build.py) with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmegastep.so megastep.cu
// and called through the plain C functions at the bottom (ctypes).
//
// Replaces the TPU kernel tools/pallas_megastep_experiment.py
// main.<locals>.kernel (launched by pl.pallas_call at :90), which traced
// LocomotionEnv.sim_step over a (block, dof) state tile with the model's
// constants closure-converted into operands. Here the operands are the
// StepParams tensors of envs/fused_step.py (pack_step_params), read-only
// and the same for every thread, so L1 broadcasts them; each thread reads
// its q, qd and action rows once and writes q and qd once. Per step:
//
//   PD on the compact pose vector (control/pd.py pd_tau)
//   -> forward kinematics (dynamics/kinematics.py fk_links)
//   -> articulated-body factor (forward_dynamics.py aba_factor)
//   -> bias and forward sweeps (forward_dynamics_from_kin)
//   -> qd += qdd dt (integrator.py integrate_euler_qdd)
//   -> plane-sphere candidates (collision/narrowphase.py plane_sphere)
//   -> point Jacobians (dynamics/jacobian.py point_jacobian_kin)
//   -> the 3*NC contact rows J, M^-1 J^T row by row (minv_mul)
//   -> Delassus A = J M^-1 J^T + cfm I -> PGS (pgs_sweep.cuh, as K1)
//   -> qd -= p M^-1 J^T (contact/mlcp.py resolve_collision, body b)
//   -> q += qd dt (integrate_q).
//
// The ground plane is body a (no DoF) and the robot body b, so the
// relative velocity is -J qd, the normal on b is minus the plane's normal
// and the impulse is subtracted. A toe off the ground has its rows scaled
// by the collision mask 0: its A row is cfm on the diagonal and 0
// elsewhere and its b is 0, so its x is exactly 0.
//
// Templates: T (float and double; the double instance holds the card to
// the CPU at 1e-9), the link count NL, the DoF count ND and the contact
// count NC; (22, 18, 4) is laikago's, the only instance. Joint types:
// fixed, prismatic x/y/z/axis and revolute x/y/z/axis (model/joints.py).
//
// What bounds it on an H100: operations. The step needs about 2.2e4 flops
// per env with four toes down (chip_smoke.py counts them on the plain
// version with utils/op_count.py), most of them the 12 M^-1 sweeps,
// against ~0.3 KB of state in and out per env. This kernel does more: it
// runs every row over every link and multiplies the zero entries of the
// joint frames and subspaces.
//
// Design (first version: simple and right): the per-link state (X_parent,
// X_world, v, c, pA, the articulated inertia blocks, U, 1/D) lives in
// per-thread arrays, which the compiler places in local memory
// (several KB per env, coalesced across a warp because every thread walks
// the same links in step); the link loops stay rolled (#pragma unroll 1)
// over the packed topology tables so that nvcc's time and the code size
// stay small, and only the 3- and 6-wide inner products unroll.

#include <cuda_runtime.h>

#include "pgs_sweep.cuh"

// Pointers to the StepParams tensors, in the order of its fields
// (envs/fused_step.py POINTER_FIELDS), then its two integer fields. Outside
// the unnamed namespace: the C entry points take it, so it needs external
// linkage.
struct StepOperands {
  const void* joint_types;
  const void* parents;
  const void* q_offsets;
  const void* qd_offsets;
  const void* pd_q;
  const void* x_t_pos;
  const void* x_t_rot;
  const void* subspaces;
  const void* mass;
  const void* com;
  const void* inertia;
  const void* stiffness;
  const void* damping;
  const void* base_pos;
  const void* base_rot;
  const void* gravity;
  const void* kp;
  const void* kd;
  const void* max_force;
  const void* action_limit;
  const void* initial_poses;
  const void* dt;
  const void* sphere_links;
  const void* sphere_offsets;
  const void* sphere_radii;
  const void* plane_normal;
  const void* plane_constant;
  const void* friction;
  const void* restitution;
  const void* erp;
  const void* cfm;
  int pgs_iterations;
  int num_friction_dir;
};

namespace {

enum JointType : int {
  kFixed = -1,
  kPrismaticX = 0,
  kPrismaticY = 1,
  kPrismaticZ = 2,
  kPrismaticAxis = 3,
  kRevoluteX = 4,
  kRevoluteY = 5,
  kRevoluteZ = 6,
  kRevoluteAxis = 7,
};

template <typename T>
struct Model {
  const int* joint_types;
  const int* parents;
  const int* q_offsets;
  const int* qd_offsets;
  const int* pd_q;
  const T* x_t_pos;
  const T* x_t_rot;
  const T* subspaces;
  const T* mass;
  const T* com;
  const T* inertia;
  const T* stiffness;
  const T* damping;
  const T* base_pos;
  const T* base_rot;
  const T* gravity;
  const T* kp;
  const T* kd;
  const T* max_force;
  const T* action_limit;
  const T* initial_poses;
  const T* dt;
  const int* sphere_links;
  const T* sphere_offsets;
  const T* sphere_radii;
  const T* plane_normal;
  const T* plane_constant;
  const T* friction;
  const T* restitution;
  const T* erp;
  const T* cfm;
  int pgs_iterations;
  int num_pd;
};

__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ double sin_(double x) { return sin(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }
__device__ __forceinline__ double cos_(double x) { return cos(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

// -- 3-vectors and 3x3 matrices (row-major, rotations child -> parent) ----
template <typename T>
__device__ __forceinline__ void matvec(const T* r, const T* v, T* out) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = r[3 * k] * v[0] + r[3 * k + 1] * v[1] + r[3 * k + 2] * v[2];
}

template <typename T>
__device__ __forceinline__ void mattvec(const T* r, const T* v, T* out) {
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = r[k] * v[0] + r[3 + k] * v[1] + r[6 + k] * v[2];
}

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ T dot6(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] + a[4] * b[4] + a[5] * b[5];
}

// out = a b, or a b^T with transpose_b
template <typename T, bool transpose_b = false>
__device__ __forceinline__ void matmul(const T* a, const T* b, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < 3; ++k) acc += a[3 * i + k] * (transpose_b ? b[3 * j + k] : b[3 * k + j]);
      out[3 * i + j] = acc;
    }
  }
}

// -- spatial algebra (algebra/transform.py, spatial.py, inertia.py) -------
// motion [w, v] -> [R^T w, R^T (v - p x w)]
template <typename T>
__device__ __forceinline__ void motion_to_child(const T* r, const T* p, const T* m, T* out) {
  T pxw[3], d[3];
  cross(p, m, pxw);
#pragma unroll
  for (int k = 0; k < 3; ++k) d[k] = m[3 + k] - pxw[k];
  mattvec(r, m, out);
  mattvec(r, d, out + 3);
}

// motion [w, v] -> [R w, R v + p x (R w)]
template <typename T>
__device__ __forceinline__ void motion_to_parent(const T* r, const T* p, const T* m, T* out) {
  T rv[3], pxw[3];
  matvec(r, m, out);
  matvec(r, m + 3, rv);
  cross(p, out, pxw);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 + k] = rv[k] + pxw[k];
}

// out += force [n, f] -> [R n + p x (R f), R f]
template <typename T>
__device__ __forceinline__ void add_force_to_parent(const T* r, const T* p, const T* f, T* out) {
  T rn[3], rf[3], pxf[3];
  matvec(r, f, rn);
  matvec(r, f + 3, rf);
  cross(p, rf, pxf);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[k] += rn[k] + pxf[k];
    out[3 + k] += rf[k];
  }
}

// motion x motion: [wa x wb, wa x vb + va x wb]
template <typename T>
__device__ __forceinline__ void cross_mm(const T* a, const T* b, T* out) {
  T t1[3], t2[3];
  cross(a, b, out);
  cross(a, b + 3, t1);
  cross(a + 3, b, t2);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[3 + k] = t1[k] + t2[k];
}

// motion x* force: [w x n + v x f, w x f]
template <typename T>
__device__ __forceinline__ void cross_mf(const T* a, const T* f, T* out) {
  T t1[3], t2[3];
  cross(a, f, t1);
  cross(a + 3, f + 3, t2);
  cross(a, f + 3, out + 3);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = t1[k] + t2[k];
}

// articulated inertia [[I, H], [H^T, M]] times motion [w, v]
template <typename T>
__device__ __forceinline__ void abi_mul_motion(const T* I, const T* H, const T* M, const T* m, T* out) {
  T t1[3], t2[3], t3[3], t4[3];
  matvec(I, m, t1);
  matvec(H, m + 3, t2);
  matvec(M, m + 3, t3);
  mattvec(H, m, t4);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[k] = t1[k] + t2[k];
    out[3 + k] = t3[k] + t4[k];
  }
}

// parent blocks += X^T I^A X (Transform.abi_to_parent):
//   M' = R M R^T, H' = R H R^T + px M', I' = R I R^T - hp px + px hp^T - px M' px
template <typename T>
__device__ void add_abi_to_parent(const T* r, const T* p, const T* I, const T* H, const T* M,
                                  T* pI, T* pH, T* pM) {
  T tmp[9], mp[9], hp[9], ip[9], px[9], t2[9];
  px[0] = T(0); px[1] = -p[2]; px[2] = p[1];
  px[3] = p[2]; px[4] = T(0); px[5] = -p[0];
  px[6] = -p[1]; px[7] = p[0]; px[8] = T(0);
  matmul(r, M, tmp);
  matmul<T, true>(tmp, r, mp);
  matmul(r, H, tmp);
  matmul<T, true>(tmp, r, hp);
  matmul(r, I, tmp);
  matmul<T, true>(tmp, r, ip);
  // ip - hp px + px hp^T
  matmul(hp, px, tmp);
  matmul<T, true>(px, hp, t2);
#pragma unroll
  for (int k = 0; k < 9; ++k) ip[k] = ip[k] - tmp[k] + t2[k];
  // - px mp px
  matmul(px, mp, tmp);
  matmul(tmp, px, t2);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    pI[k] += ip[k] - t2[k];
    pH[k] += hp[k] + tmp[k];
    pM[k] += mp[k];
  }
}

// rotation of a revolute joint by `angle` (model/joints.py jcalc_transform)
template <typename T>
__device__ void joint_rotation(int jt, const T* s, T angle, T* r) {
  if (jt == kRevoluteAxis) {
    // quaternion.from_axis_angle(axis / |axis|, angle), then to_matrix with
    // its 2 / |q|^2 normalization
    const T norm = sqrt_(s[0] * s[0] + s[1] * s[1] + s[2] * s[2]);
    const T half = T(0.5) * angle;
    const T sh = sin_(half);
    const T x = s[0] / norm * sh, y = s[1] / norm * sh, z = s[2] / norm * sh, w = cos_(half);
    const T sc = T(2) / (x * x + y * y + z * z + w * w);
    const T xs = x * sc, ys = y * sc, zs = z * sc;
    const T wx = w * xs, wy = w * ys, wz = w * zs;
    const T xx = x * xs, xy = x * ys, xz = x * zs;
    const T yy = y * ys, yz = y * zs, zz = z * zs;
    r[0] = T(1) - (yy + zz); r[1] = xy - wz; r[2] = xz + wy;
    r[3] = xy + wz; r[4] = T(1) - (xx + zz); r[5] = yz - wx;
    r[6] = xz - wy; r[7] = yz + wx; r[8] = T(1) - (xx + yy);
    return;
  }
  const T c = cos_(angle), sn = sin_(angle);
#pragma unroll
  for (int k = 0; k < 9; ++k) r[k] = T(0);
  if (jt == kRevoluteX) {
    r[0] = T(1); r[4] = c; r[5] = -sn; r[7] = sn; r[8] = c;
  } else if (jt == kRevoluteY) {
    r[0] = c; r[2] = sn; r[4] = T(1); r[6] = -sn; r[8] = c;
  } else {
    r[0] = c; r[1] = -sn; r[3] = sn; r[4] = c; r[8] = T(1);
  }
}

template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// per-link state of one env
template <typename T>
struct Link {
  T xp_r[9], xp_p[3];  // X_parent
  T xw_r[9], xw_p[3];  // X_world
  T v[6], c[6], pa[6];  // velocity, velocity-product acceleration, bias force
  T I[9], H[9], M[9];   // articulated inertia I^A, then I^a after the factor
  T u[6], d_inv;        // U = I^A S, 1/D (0 for fixed joints)
  T u_bias;             // tau - S^T p^A of the current sweep
  T acc[6];             // spatial acceleration of the current forward sweep
};

// the contact MLCP in per-thread arrays, for pgs_sweeps
template <typename T, int NR, int NC>
struct LocalProblem {
  const T* a_;  // (NR, NR) row-major
  const T* b_;
  const T* lo_;
  const T* hi_;
  __device__ T a(int i, int j) const { return a_[i * NR + j]; }
  __device__ T b(int i) const { return b_[i]; }
  __device__ T lo(int i) const { return lo_[i]; }
  __device__ T hi(int i) const { return hi_[i]; }
  // rows [normals | friction 1 | friction 2]: a friction row's bounds
  // scale with its contact's normal impulse
  __device__ int dep(int i) const { return i < NC ? -1 : i % NC; }
};

template <typename T, int NL, int ND, int NC>
__global__ void __launch_bounds__(128)
megastep_kernel(const Model<T> m, const T* __restrict__ q_in, const T* __restrict__ qd_in,
                const T* __restrict__ action, T* __restrict__ q_out, T* __restrict__ qd_out,
                int batch) {
  constexpr int NR = 3 * NC;
  const long long env = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= batch) return;

  T q[ND], qd[ND], tau[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    q[k] = q_in[env * ND + k];
    qd[k] = qd_in[env * ND + k];
    tau[k] = T(0);
  }
  const T dt = m.dt[0];

  // -- PD on the compact pose vector; tau is zero on the passive joints --
  {
    const T limit = m.action_limit[0], kp = m.kp[0], kd = m.kd[0], max_force = m.max_force[0];
#pragma unroll 1
    for (int k = 0; k < m.num_pd; ++k) {
      const T target = m.initial_poses[k] + clip(action[env * m.num_pd + k], -limit, limit);
      const int slot = m.pd_q[k];  // q, qd and tau share the layout
      tau[slot] = clip(kp * (target - q[slot]) + kd * (T(0) - qd[slot]), -max_force, max_force);
    }
  }

  // -- forward kinematics ---------------------------------------------------
  Link<T> links[NL];
  T base_r[9], base_p[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) base_r[k] = m.base_rot[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) base_p[k] = m.base_pos[k];

#pragma unroll 1
  for (int i = 0; i < NL; ++i) {
    Link<T>& l = links[i];
    const int jt = m.joint_types[i];
    const int parent = m.parents[i];
    const T* s = m.subspaces + 6 * i;
    const T* xt_r = m.x_t_rot + 9 * i;
    const T* xt_p = m.x_t_pos + 3 * i;
    T qi = T(0), qdi = T(0);
    if (jt != kFixed) {
      qi = q[m.q_offsets[i]];
      qdi = qd[m.qd_offsets[i]];
    }
    // X_parent = X_T X_J(q)
    if (jt == kFixed || jt >= kRevoluteX) {
#pragma unroll
      for (int k = 0; k < 3; ++k) l.xp_p[k] = xt_p[k];
      if (jt == kFixed) {
#pragma unroll
        for (int k = 0; k < 9; ++k) l.xp_r[k] = xt_r[k];
      } else {
        T rj[9];
        joint_rotation(jt, s, qi, rj);
        matmul(xt_r, rj, l.xp_r);
      }
    } else {  // prismatic: translate by S_lin q along the joint frame
      T d[3], rd[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = s[3 + k] * qi;
      matvec(xt_r, d, rd);
#pragma unroll
      for (int k = 0; k < 3; ++k) l.xp_p[k] = xt_p[k] + rd[k];
#pragma unroll
      for (int k = 0; k < 9; ++k) l.xp_r[k] = xt_r[k];
    }
    // X_world = X_world(parent) X_parent
    {
      const T* pr = parent >= 0 ? links[parent].xw_r : base_r;
      const T* pp = parent >= 0 ? links[parent].xw_p : base_p;
      T rp[3];
      matvec(pr, l.xp_p, rp);
#pragma unroll
      for (int k = 0; k < 3; ++k) l.xw_p[k] = pp[k] + rp[k];
      matmul(pr, l.xp_r, l.xw_r);
    }
    // rigid-body inertia as articulated blocks: I, H = h x, M = m 1
    {
      const T* h = m.com + 3 * i;
      const T mass = m.mass[i];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        l.I[k] = m.inertia[9 * i + k];
        l.M[k] = (k % 4 == 0) ? mass : T(0);
      }
      l.H[0] = T(0); l.H[1] = -h[2]; l.H[2] = h[1];
      l.H[3] = h[2]; l.H[4] = T(0); l.H[5] = -h[0];
      l.H[6] = -h[1]; l.H[7] = h[0]; l.H[8] = T(0);
    }
    // v = X v(parent) + S qd, c = v x S qd (0 for a fixed joint)
    if (parent >= 0) {
      motion_to_child(l.xp_r, l.xp_p, links[parent].v, l.v);
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k) l.v[k] = T(0);
    }
    if (jt != kFixed) {
      T vj[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) vj[k] = s[k] * qdi;
#pragma unroll
      for (int k = 0; k < 6; ++k) l.v[k] += vj[k];
      cross_mm(l.v, vj, l.c);
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k) l.c[k] = T(0);
    }
    T iv[6];
    abi_mul_motion(l.I, l.H, l.M, l.v, iv);
    cross_mf(l.v, iv, l.pa);
  }

  // -- articulated-body factor: backward inertia sweep ---------------------
#pragma unroll 1
  for (int i = NL - 1; i >= 0; --i) {
    Link<T>& l = links[i];
    const int jt = m.joint_types[i];
    const int parent = m.parents[i];
    const T* s = m.subspaces + 6 * i;
    abi_mul_motion(l.I, l.H, l.M, s, l.u);
    if (jt == kFixed) {
      l.d_inv = T(0);
    } else {
      l.d_inv = T(1) / dot6(s, l.u);
      T ud[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) ud[k] = l.u[k] * l.d_inv;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          l.I[3 * a + b] -= l.u[a] * ud[b];
          l.H[3 * a + b] -= l.u[a] * ud[3 + b];
          l.M[3 * a + b] -= l.u[3 + a] * ud[3 + b];
        }
      }
    }
    if (parent >= 0) {
      Link<T>& lp = links[parent];
      add_abi_to_parent(l.xp_r, l.xp_p, l.I, l.H, l.M, lp.I, lp.H, lp.M);
    }
  }

  // -- bias sweep: p^A, u = tau - k q - d qd - S^T p^A ------------------------
#pragma unroll 1
  for (int i = NL - 1; i >= 0; --i) {
    Link<T>& l = links[i];
    const int jt = m.joint_types[i];
    const int parent = m.parents[i];
    T pa[6];
    abi_mul_motion(l.I, l.H, l.M, l.c, pa);
#pragma unroll
    for (int k = 0; k < 6; ++k) pa[k] += l.pa[k];
    if (jt != kFixed) {
      const T* s = m.subspaces + 6 * i;
      const int qo = m.q_offsets[i], vo = m.qd_offsets[i];
      const T tau_l = tau[vo] - m.stiffness[i] * q[qo] - m.damping[i] * qd[vo];
      const T u_b = tau_l - dot6(s, l.pa);
      const T scale = u_b * l.d_inv;
#pragma unroll
      for (int k = 0; k < 6; ++k) pa[k] += l.u[k] * scale;
      l.u_bias = u_b;
    }
    if (parent >= 0) add_force_to_parent(l.xp_r, l.xp_p, pa, links[parent].pa);
  }

  // -- forward sweep from the base acceleration -g; qd += qdd dt -------------
  {
    T base_acc[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      base_acc[k] = T(0);
      base_acc[3 + k] = -m.gravity[k];
    }
#pragma unroll 1
    for (int i = 0; i < NL; ++i) {
      Link<T>& l = links[i];
      const int jt = m.joint_types[i];
      const int parent = m.parents[i];
      motion_to_child(l.xp_r, l.xp_p, parent >= 0 ? links[parent].acc : base_acc, l.acc);
#pragma unroll
      for (int k = 0; k < 6; ++k) l.acc[k] += l.c[k];
      if (jt != kFixed) {
        const T* s = m.subspaces + 6 * i;
        const T qdd = l.d_inv * (l.u_bias - dot6(l.u, l.acc));
        const int vo = m.qd_offsets[i];
        qd[vo] = qd[vo] + qdd * dt;
#pragma unroll
        for (int k = 0; k < 6; ++k) l.acc[k] += s[k] * qdd;
      }
    }
  }

  // -- contact rows: plane-sphere candidates and point Jacobians ------------
  T J[NR][ND], rhs[NR], lo[NR], hi[NR];
  {
    T n_b[3], fr1[3], fr2[3];  // normal on b = -plane normal, its plane space
#pragma unroll
    for (int k = 0; k < 3; ++k) n_b[k] = -m.plane_normal[k];
    {
      // normalized, branch-free plane_space (contact/mlcp.py)
      const T n_sqr = n_b[2] * n_b[2];
      const bool mostly_z = n_sqr > T(0.5);
      T a = n_b[1] * n_b[1] + (mostly_z ? n_sqr : n_b[0] * n_b[0]);
      a = a > T(1e-30) ? a : T(1e-30);
      const T kk = T(1) / sqrt_(a);
      fr1[0] = mostly_z ? T(0) : -n_b[1] * kk;
      fr1[1] = mostly_z ? -n_b[2] * kk : n_b[0] * kk;
      fr1[2] = mostly_z ? n_b[1] * kk : T(0);
      cross(n_b, fr1, fr2);
    }
    const T erp = m.erp[0];
#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      const int link = m.sphere_links[c];
      const T radius = m.sphere_radii[c];
      T pos[3], point[3];
      matvec(links[link].xw_r, m.sphere_offsets + 3 * c, pos);
#pragma unroll
      for (int k = 0; k < 3; ++k) pos[k] += links[link].xw_p[k];
      const T distance = dot3(pos, m.plane_normal) - m.plane_constant[0] - radius;
#pragma unroll
      for (int k = 0; k < 3; ++k) point[k] = pos[k] - radius * m.plane_normal[k];
      const T col = distance < T(0) ? T(1) : T(0);

      T jac[3][ND];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
#pragma unroll
        for (int k = 0; k < ND; ++k) jac[d][k] = T(0);
      }
#pragma unroll 1
      for (int i = link; i >= 0; i = m.parents[i]) {
        if (m.joint_types[i] == kFixed) continue;
        T st[6], pxw[3];
        motion_to_parent(links[i].xw_r, links[i].xw_p, m.subspaces + 6 * i, st);
        cross(point, st, pxw);
        const int vo = m.qd_offsets[i];
#pragma unroll
        for (int d = 0; d < 3; ++d) jac[d][vo] = st[3 + d] - pxw[d];
      }
      T rel_vel[3];  // -J_b qd_b
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < ND; ++k) acc += jac[d][k] * qd[k];
        rel_vel[d] = -acc;
      }
      T dirs[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dirs[0][k] = n_b[k] * col;
        dirs[1][k] = fr1[k] * col;
        dirs[2][k] = fr2[k] * col;
      }
      const T vn = dot3(n_b, rel_vel);
      rhs[c] = (-(T(1) + m.restitution[c]) * vn - erp * distance / dt) * col;
      rhs[NC + c] = -dot3(dirs[1], rel_vel);
      rhs[2 * NC + c] = -dot3(dirs[2], rel_vel);
      const T mu = m.friction[c];
      lo[c] = T(0);
      hi[c] = T(1e5);
      lo[NC + c] = lo[2 * NC + c] = -mu;
      hi[NC + c] = hi[2 * NC + c] = mu;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
#pragma unroll
        for (int k = 0; k < ND; ++k) {
          J[r * NC + c][k] = jac[0][k] * dirs[r][0] + jac[1][k] * dirs[r][1] + jac[2][k] * dirs[r][2];
        }
      }
    }
  }

  // -- M^-1 J^T, one row at a time: ABA sweeps at zero velocity and gravity -
  T JM[NR][ND];
#pragma unroll 1
  for (int r = 0; r < NR; ++r) {
#pragma unroll 1
    for (int i = 0; i < NL; ++i) {
#pragma unroll
      for (int k = 0; k < 6; ++k) links[i].pa[k] = T(0);
    }
#pragma unroll 1
    for (int i = NL - 1; i >= 0; --i) {
      Link<T>& l = links[i];
      const int parent = m.parents[i];
      T pa[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) pa[k] = l.pa[k];
      if (m.joint_types[i] != kFixed) {
        const T u_b = J[r][m.qd_offsets[i]] - dot6(m.subspaces + 6 * i, l.pa);
        const T scale = u_b * l.d_inv;
#pragma unroll
        for (int k = 0; k < 6; ++k) pa[k] += l.u[k] * scale;
        l.u_bias = u_b;
      }
      if (parent >= 0) add_force_to_parent(l.xp_r, l.xp_p, pa, links[parent].pa);
    }
    const T zero[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll 1
    for (int i = 0; i < NL; ++i) {
      Link<T>& l = links[i];
      const int parent = m.parents[i];
      motion_to_child(l.xp_r, l.xp_p, parent >= 0 ? links[parent].acc : zero, l.acc);
      if (m.joint_types[i] != kFixed) {
        const T* s = m.subspaces + 6 * i;
        const T x = l.d_inv * (l.u_bias - dot6(l.u, l.acc));
        JM[r][m.qd_offsets[i]] = x;
#pragma unroll
        for (int k = 0; k < 6; ++k) l.acc[k] += s[k] * x;
      }
    }
  }

  // -- Delassus matrix, PGS, impulse -----------------------------------------
  T A[NR][NR];
  {
    const T cfm = m.cfm[0];
#pragma unroll 1
    for (int r = 0; r < NR; ++r) {
#pragma unroll 1
      for (int c = 0; c < NR; ++c) {
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < ND; ++k) acc += J[r][k] * JM[c][k];
        A[r][c] = r == c ? acc + cfm : acc;
      }
    }
  }
  T x[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) x[r] = T(0);
  const LocalProblem<T, NR, NC> problem{&A[0][0], rhs, lo, hi};
  pgs_sweeps<T, NR>(x, problem, m.pgs_iterations);

#pragma unroll
  for (int k = 0; k < ND; ++k) {
    T impulse = T(0);
#pragma unroll
    for (int r = 0; r < NR; ++r) impulse += x[r] * JM[r][k];
    const T v = qd[k] - impulse;
    qd_out[env * ND + k] = v;
    q_out[env * ND + k] = q[k] + v * dt;
  }
}

template <typename T>
Model<T> typed(const StepOperands& o, int num_pd) {
  return Model<T>{
      static_cast<const int*>(o.joint_types), static_cast<const int*>(o.parents),
      static_cast<const int*>(o.q_offsets), static_cast<const int*>(o.qd_offsets),
      static_cast<const int*>(o.pd_q), static_cast<const T*>(o.x_t_pos),
      static_cast<const T*>(o.x_t_rot), static_cast<const T*>(o.subspaces),
      static_cast<const T*>(o.mass), static_cast<const T*>(o.com),
      static_cast<const T*>(o.inertia), static_cast<const T*>(o.stiffness),
      static_cast<const T*>(o.damping), static_cast<const T*>(o.base_pos),
      static_cast<const T*>(o.base_rot), static_cast<const T*>(o.gravity),
      static_cast<const T*>(o.kp), static_cast<const T*>(o.kd),
      static_cast<const T*>(o.max_force), static_cast<const T*>(o.action_limit),
      static_cast<const T*>(o.initial_poses), static_cast<const T*>(o.dt),
      static_cast<const int*>(o.sphere_links), static_cast<const T*>(o.sphere_offsets),
      static_cast<const T*>(o.sphere_radii), static_cast<const T*>(o.plane_normal),
      static_cast<const T*>(o.plane_constant), static_cast<const T*>(o.friction),
      static_cast<const T*>(o.restitution), static_cast<const T*>(o.erp),
      static_cast<const T*>(o.cfm), o.pgs_iterations, num_pd};
}

template <typename T>
int launch(const StepOperands* ops, const void* q, const void* qd, const void* action, void* q_out,
           void* qd_out, int batch, int num_links, int dof, int num_contacts, int num_pd,
           void* stream) {
  constexpr int kThreads = 128;
  const int blocks = (batch + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ops->num_friction_dir != 2 || num_pd > dof) return static_cast<int>(cudaErrorInvalidValue);
  const Model<T> m = typed<T>(*ops, num_pd);
  if (num_links == 22 && dof == 18 && num_contacts == 4) {
    megastep_kernel<T, 22, 18, 4><<<blocks, kThreads, 0, s>>>(
        m, static_cast<const T*>(q), static_cast<const T*>(qd), static_cast<const T*>(action),
        static_cast<T*>(q_out), static_cast<T*>(qd_out), batch);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, qd, q_out, qd_out (B, dof) and action (B, num_pd), contiguous, on the
// current device; ops points to host memory holding the StepParams
// pointers. Launches on `stream` without synchronising and returns
// cudaGetLastError() (0 when the launch was accepted), or
// cudaErrorInvalidValue for a shape with no instance.
extern "C" int tds_megastep_f32(const StepOperands* ops, const void* q, const void* qd,
                                const void* action, void* q_out, void* qd_out, int batch,
                                int num_links, int dof, int num_contacts, int num_pd,
                                void* stream) {
  return launch<float>(ops, q, qd, action, q_out, qd_out, batch, num_links, dof, num_contacts,
                       num_pd, stream);
}

extern "C" int tds_megastep_f64(const StepOperands* ops, const void* q, const void* qd,
                                const void* action, void* q_out, void* qd_out, int batch,
                                int num_links, int dof, int num_contacts, int num_pd,
                                void* stream) {
  return launch<double>(ops, q, qd, action, q_out, qd_out, batch, num_links, dof, num_contacts,
                        num_pd, stream);
}
