// The whole laikago control step, sim_step, fused into one kernel launch:
// one group of G lanes (a half-warp at G = 16) per environment. Built by
// tds_tpu_torch/envs/fused_step.py (through tds_tpu_torch/utils/cuda_build.py)
// with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmegastep.so megastep.cu
// and called through the plain C functions at the bottom (ctypes).
//
// Replaces the TPU kernel tools/pallas_megastep_experiment.py
// main.<locals>.kernel (launched by pl.pallas_call at :90), which traced
// LocomotionEnv.sim_step over a (block, dof) state tile with the model's
// constants closure-converted into operands. Here the operands are the
// StepParams tensors of envs/fused_step.py (pack_step_params), read-only
// and the same for every env, so L1 serves them; each group reads its
// env's q, qd and action rows once and writes q and qd once. Per step:
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
// the CPU at 1e-9), the link count NL, the DoF count ND, the contact count
// NC and the lanes per env G; (22, 18, 4) at G = 16 is laikago's, the only
// instance. Joint types: fixed, prismatic x/y/z/axis and revolute
// x/y/z/axis (model/joints.py).
//
// What bounds it on an H100: operations. The step needs about 2.2e4 flops
// per env with four toes down (chip_smoke.py counts them on the plain
// version with utils/op_count.py), most of them the 12 M^-1 sweeps,
// against ~0.3 KB of state in and out per env.
//
// Design. The first version ran one thread per env over the whole step:
// 16384 threads, one 4-warp block on each of 128 SMs, so no scheduler had
// a second warp to switch to, and the per-link state lived in a 9.9 KB
// per-thread stack in local memory (746 us at B = 16384 on an H100 80GB
// HBM3). Here:
// - a group of G lanes serves one env, 128 / G envs per 128-thread block,
//   so B = 16384 runs 262,144 threads at G = 16 and several blocks stay
//   resident per SM (G = 8 was no faster and G = 32 1.8x slower on an
//   H100: PERF.md);
// - the per-link state that several lanes read later (X_parent, c, the
//   FK bias force, S in world coordinates, U, 1/D, the bias u) and the
//   contact rows J and M^-1 J^T live in shared memory, one region per env
//   at an odd stride (so the two envs of a warp do not share banks), the
//   contact rows over the sweeps' values, which are dead by then (5.2 KB
//   per env in float); the working vectors of a lane live in registers,
//   and nothing is indexed dynamically in registers, so nothing goes to
//   local memory (ptxas reports no stack frame in float; in double, 40
//   bytes for the called slow argument reduction of sin and cos);
// - the phases spread over the lanes by the schedule tables of
//   pack_step_params: the chain from the root to the branch link, the
//   subtrees (each a chain) hanging from it, and each sphere's path to the
//   root. The joint transforms X_parent(q) run one link per lane; the walk
//   that composes X_world and v, the forward sweep and qd += qdd dt run one
//   lane per subtree, each lane walking the chain first with its state in
//   registers (lane 0 stores the chain's values); what a link's own X_world
//   and v give (c, the bias force, S in world coordinates, the sphere
//   candidates) runs one link per lane again; the factor and bias sweeps
//   run one lane per subtree from its tip, then lane 0 down the chain, the
//   branch link summing its subtrees' articulated inertias and forces from
//   shared memory; the 12 contact rows run one per lane: the point Jacobian and
//   the backward M^-1 sweep walk only the sphere's path (p^A in
//   registers), the forward sweep the chain and then each subtree from the
//   branch link's acceleration; Delassus row r is built on lane r; PGS is
//   K1's lane-parallel sweep; the impulse and q, qd updates run one DoF
//   per lane;
// - the products with a joint frame's rotation are skipped where it is the
//   identity (prismatic and fixed joints in unrotated frames: 7 of
//   laikago's 22 links), where they are exact copies;
// - __syncwarp() separates a phase that writes shared memory from the
//   lanes that read it; a group past the end of the batch computes on the
//   last env's state (every lane must reach the shuffles of the sweep) and
//   stores nothing.
//
// PHASE_END(k) marks the end of the kernel's k-th phase. It is empty unless
// MEGASTEP_PHASE_CUTS is defined, as megastep_phases.cu does for
// tools/megastep_phases.py: the kernel then returns after phase k once
// tds_megastep_set_stop(k) has set k > 0.

#include <cuda_runtime.h>

#include <mutex>
#include <set>
#include <utility>

#include "pgs_sweep.cuh"

#ifdef MEGASTEP_PHASE_CUTS
__constant__ int g_stop;
extern "C" int tds_megastep_set_stop(int k) {
  return static_cast<int>(cudaMemcpyToSymbol(g_stop, &k, sizeof(int)));
}
#define PHASE_END(k) \
  if (g_stop == (k)) return
#else
#define PHASE_END(k) ((void)0)
#endif

// Pointers to the StepParams tensors, in the order of its fields
// (envs/fused_step.py POINTER_FIELDS), then its integer fields and the
// schedule tables' sizes. Outside the unnamed namespace: the C entry points
// take it, so it needs external linkage.
struct StepOperands {
  const void* joint_types;
  const void* parents;
  const void* q_offsets;
  const void* qd_offsets;
  const void* pd_q;
  const void* chain;
  const void* subtrees;
  const void* sphere_paths;
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
  int num_chain;
  int num_subtrees;
  int path_length;
};

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 16;  // the lanes per env G of the instances

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
  const int* chain;         // (num_chain,) links from the root to the branch link
  const int* subtrees;      // (num_subtrees, 2) [start, end) of each chain hanging from it
  const int* sphere_paths;  // (NC, path_length) links from the sphere's to the root, -1 padded
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
  int num_chain;
  int num_subtrees;
  int path_length;
};

// One env's region of shared memory, in units of T: what lives through the
// whole step, then a scratch area that holds the dynamics sweeps' values
// until the forward sweep and the contact rows after it. The slots carry
// the articulated inertia (I, H, M: 27) and bias force (6) that a link adds
// to its parent: one per subtree, for the links of that subtree's lane, and
// one for the chain.
template <int NL, int ND, int NC>
struct Region {
  static constexpr int NR = 3 * NC;
  static constexpr int kQ = 0;                 // q (ND)
  static constexpr int kQd = kQ + ND;          // qd (ND), qd + qdd dt after the forward sweep
  static constexpr int kTau = kQd + ND;        // PD torques (ND)
  static constexpr int kX = kTau + ND;         // X_parent per link: R (9), p (3)
  static constexpr int kIdent = kX + 12 * NL;  // 1 where X_parent's rotation is the identity, else 0
  static constexpr int kU = kIdent + NL;       // U = I^A S per link (6)
  static constexpr int kDinv = kU + 6 * NL;    // 1/D per link (0 for fixed joints)
  static constexpr int kSt = kDinv + NL;       // S in world coordinates per link (6)
  static constexpr int kDist = kSt + 6 * NL;   // sphere-plane distances (NC)
  static constexpr int kPoint = kDist + NC;    // world points on the spheres nearest the plane (NC, 3)
  static constexpr int kScratch = kPoint + 3 * NC;
  // until the forward sweep
  static constexpr int kC = kScratch;          // c = v x S qd per link (6)
  static constexpr int kPa = kC + 6 * NL;      // FK bias force v x* I v per link (6)
  static constexpr int kUb = kPa + 6 * NL;     // tau - S^T p^A per link
  static constexpr int kSlots = kUb + NL;      // (num_subtrees + 1) slots
  static constexpr int kSlot = 33;
  static constexpr int kXw = kUb;              // during FK, over u and the slots: X_world (12), v (6)
  // from the contact rows on
  static constexpr int kJ = kScratch;          // contact rows J (NR, ND)
  static constexpr int kJm = kJ + NR * ND;     // M^-1 J^T rows (NR, ND)
  // an odd stride, so that the envs of a warp start on different banks
  __host__ __device__ static int stride(int num_subtrees) {
    int n = kSlots + kSlot * (num_subtrees + 1);
    n = n > kXw + 18 * NL ? n : kXw + 18 * NL;
    n = n > kJm + NR * ND ? n : kJm + NR * ND;
    return n | 1;
  }
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

template <typename T, int K>
__device__ __forceinline__ void copy(const T* from, T* to) {
#pragma unroll
  for (int k = 0; k < K; ++k) to[k] = from[k];
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

// force [n, f] -> [R n + p x (R f), R f]
template <typename T>
__device__ __forceinline__ void force_to_parent(const T* r, const T* p, const T* f, T* out) {
  T rn[3], pxf[3];
  matvec(r, f, rn);
  matvec(r, f + 3, out + 3);
  cross(p, out + 3, pxf);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = rn[k] + pxf[k];
}

// The same three through a stored X_parent (R, then p) whose rotation is
// the identity where `ident` holds: the products with R are then exact
// copies, and are skipped.
template <typename T>
__device__ __forceinline__ void motion_to_child(const T* x, bool ident, const T* m, T* out) {
  if (!ident) {
    motion_to_child(x, x + 9, m, out);
    return;
  }
  T pxw[3];
  cross(x + 9, m, pxw);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[k] = m[k];
    out[3 + k] = m[3 + k] - pxw[k];
  }
}

template <typename T>
__device__ __forceinline__ void force_to_parent(const T* x, bool ident, const T* f, T* out) {
  if (!ident) {
    force_to_parent(x, x + 9, f, out);
    return;
  }
  T pxf[3];
  cross(x + 9, f + 3, pxf);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    out[k] = f[k] + pxf[k];
    out[3 + k] = f[3 + k];
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

// out = X^T I^A X, the blocks a child adds to its parent (Transform.abi_to_parent):
//   M' = R M R^T, H' = R H R^T + px M', I' = R I R^T - hp px + px hp^T - px M' px;
// with `ident` (R = 1) the rotated blocks are the blocks themselves
template <typename T>
__device__ __forceinline__ void abi_to_parent(const T* r, const T* p, bool ident, const T* I, const T* H,
                                              const T* M, T* out) {
  T tmp[9], mp[9], hp[9], ip[9], px[9], t2[9];
  px[0] = T(0); px[1] = -p[2]; px[2] = p[1];
  px[3] = p[2]; px[4] = T(0); px[5] = -p[0];
  px[6] = -p[1]; px[7] = p[0]; px[8] = T(0);
  if (ident) {
    copy<T, 9>(M, mp);
    copy<T, 9>(H, hp);
    copy<T, 9>(I, ip);
  } else {
    matmul(r, M, tmp);
    matmul<T, true>(tmp, r, mp);
    matmul(r, H, tmp);
    matmul<T, true>(tmp, r, hp);
    matmul(r, I, tmp);
    matmul<T, true>(tmp, r, ip);
  }
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
    out[k] = ip[k] - t2[k];
    out[9 + k] = hp[k] + tmp[k];
    out[18 + k] = mp[k];
  }
}

// rotation of a revolute joint by `angle` (model/joints.py jcalc_transform)
template <typename T>
__device__ __forceinline__ void joint_rotation(int jt, const T* s, T angle, T* r) {
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

// rigid-body inertia of link i as articulated blocks: I, H = h x, M = m 1
template <typename T>
__device__ __forceinline__ void rigid_inertia(const Model<T>& m, int i, T* I, T* H, T* M) {
  const T* h = m.com + 3 * i;
  const T mass = m.mass[i];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    I[k] = m.inertia[9 * i + k];
    M[k] = (k % 4 == 0) ? mass : T(0);
  }
  H[0] = T(0); H[1] = -h[2]; H[2] = h[1];
  H[3] = h[2]; H[4] = T(0); H[5] = -h[0];
  H[6] = -h[1]; H[7] = h[0]; H[8] = T(0);
}

// -- the phases, per link ------------------------------------------------
// X_parent = X_T X_J(q) of link i, and whether its rotation is the
// identity (a fixed or prismatic joint in an unrotated frame), to the region.
template <typename T, int NL, int ND, int NC>
__device__ __forceinline__ void joint_transform(const Model<T>& m, int i, T* s) {
  using R = Region<NL, ND, NC>;
  const int jt = m.joint_types[i];
  const T* sv = m.subspaces + 6 * i;
  const T* xt_r = m.x_t_rot + 9 * i;
  const T* xt_p = m.x_t_pos + 3 * i;
  const T qi = jt != kFixed ? s[R::kQ + m.q_offsets[i]] : T(0);
  T xr[9], xp[3];
  bool ident = false;
  if (jt == kFixed || jt >= kRevoluteX) {
    copy<T, 3>(xt_p, xp);
    if (jt == kFixed) {
      copy<T, 9>(xt_r, xr);
      ident = true;
    } else {
      T rj[9];
      joint_rotation(jt, sv, qi, rj);
      matmul(xt_r, rj, xr);
    }
  } else {  // prismatic: translate by S_lin q along the joint frame
    T d[3], rd[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) d[k] = sv[3 + k] * qi;
    matvec(xt_r, d, rd);
#pragma unroll
    for (int k = 0; k < 3; ++k) xp[k] = xt_p[k] + rd[k];
    copy<T, 9>(xt_r, xr);
    ident = true;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) ident = ident && xr[k] == ((k % 4 == 0) ? T(1) : T(0));
  copy<T, 9>(xr, s + R::kX + 12 * i);
  copy<T, 3>(xp, s + R::kX + 12 * i + 9);
  s[R::kIdent + i] = ident ? T(1) : T(0);
}

// Forward kinematics of link i from its parent's world transform and
// velocity, which (xw_r, xw_p, v) hold on entry and link i's on return;
// with `store`, link i's are written to the region.
template <typename T, int NL, int ND, int NC>
__device__ __forceinline__ void fk_link(const Model<T>& m, int i, T* xw_r, T* xw_p, T* v, T* s, bool store) {
  using R = Region<NL, ND, NC>;
  const T* x = s + R::kX + 12 * i;
  const bool ident = s[R::kIdent + i] != T(0);
  // X_world = X_world(parent) X_parent
  {
    T rp[3];
    matvec(xw_r, x + 9, rp);
    if (!ident) {
      T rw[9];
      matmul(xw_r, x, rw);
      copy<T, 9>(rw, xw_r);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) xw_p[k] += rp[k];
  }
  // v = X v(parent) + S qd
  T vn[6];
  if (m.parents[i] >= 0) {
    motion_to_child(x, ident, v, vn);
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) vn[k] = T(0);
  }
  if (m.joint_types[i] != kFixed) {
    const T qdi = s[R::kQd + m.qd_offsets[i]];
    const T* sv = m.subspaces + 6 * i;
#pragma unroll
    for (int k = 0; k < 6; ++k) vn[k] += sv[k] * qdi;
  }
  copy<T, 6>(vn, v);
  if (store) {
    T* out = s + R::kXw + 18 * i;
    copy<T, 9>(xw_r, out);
    copy<T, 3>(xw_p, out + 9);
    copy<T, 6>(v, out + 12);
  }
}

// What FK gives link i from its own X_world and v: c = v x S qd (0 for a
// fixed joint), the bias force v x* I v, S in world coordinates and the
// candidates of the spheres on link i (sphere_links: the NC spheres' links).
template <typename T, int NL, int ND, int NC>
__device__ __forceinline__ void link_terms(const Model<T>& m, int i, const int (&sphere_links)[NC], T* s) {
  using R = Region<NL, ND, NC>;
  const T* xw = s + R::kXw + 18 * i;
  const T* v = xw + 12;
  const T* sv = m.subspaces + 6 * i;
  T c[6];
  if (m.joint_types[i] != kFixed) {
    const T qdi = s[R::kQd + m.qd_offsets[i]];
    T vj[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) vj[k] = sv[k] * qdi;
    cross_mm(v, vj, c);
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) c[k] = T(0);
  }
  T I[9], H[9], M[9], iv[6], pa[6], st[6];
  rigid_inertia(m, i, I, H, M);
  abi_mul_motion(I, H, M, v, iv);
  cross_mf(v, iv, pa);
  motion_to_parent(xw, xw + 9, sv, st);
  copy<T, 6>(c, s + R::kC + 6 * i);
  copy<T, 6>(pa, s + R::kPa + 6 * i);
  copy<T, 6>(st, s + R::kSt + 6 * i);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (sphere_links[k] != i) continue;
    const T radius = m.sphere_radii[k];
    T pos[3];
    matvec(xw, m.sphere_offsets + 3 * k, pos);
#pragma unroll
    for (int d = 0; d < 3; ++d) pos[d] += xw[9 + d];
    s[R::kDist + k] = dot3(pos, m.plane_normal) - m.plane_constant[0] - radius;
#pragma unroll
    for (int d = 0; d < 3; ++d) s[R::kPoint + 3 * k + d] = pos[d] - radius * m.plane_normal[d];
  }
}

// Factor and bias sweeps at link i: I^A = rigid + the n_in slots at `in`
// (added last first, the order in which the plain sweep adds a link's
// children), p^A = FK bias force + their forces; writes U, 1/D and
// u = tau - k q - d qd - S^T p^A to the region and what link i adds to its
// parent (X^T I^a X and X^* p^a) to `out`, which may be `in`.
template <typename T, int NL, int ND, int NC>
__device__ __forceinline__ void factor_link(const Model<T>& m, int i, T* s, const T* in, int n_in, T* out) {
  using R = Region<NL, ND, NC>;
  T I[9], H[9], M[9], pacc[6];
  rigid_inertia(m, i, I, H, M);
  copy<T, 6>(s + R::kPa + 6 * i, pacc);
#pragma unroll 1
  for (int n = n_in - 1; n >= 0; --n) {
    const T* slot = in + R::kSlot * n;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      I[k] += slot[k];
      H[k] += slot[9 + k];
      M[k] += slot[18 + k];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) pacc[k] += slot[27 + k];
  }
  const int jt = m.joint_types[i];
  const T* sv = m.subspaces + 6 * i;
  T u[6], d_inv = T(0);
  abi_mul_motion(I, H, M, sv, u);
  if (jt != kFixed) {
    d_inv = T(1) / dot6(sv, u);
    T ud[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) ud[k] = u[k] * d_inv;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        I[3 * a + b] -= u[a] * ud[b];
        H[3 * a + b] -= u[a] * ud[3 + b];
        M[3 * a + b] -= u[3 + a] * ud[3 + b];
      }
    }
  }
  copy<T, 6>(u, s + R::kU + 6 * i);
  s[R::kDinv + i] = d_inv;
  // p^a = p^A + I^a c (+ U u / D)
  T pa[6];
  abi_mul_motion(I, H, M, s + R::kC + 6 * i, pa);
#pragma unroll
  for (int k = 0; k < 6; ++k) pa[k] += pacc[k];
  if (jt != kFixed) {
    const int qo = m.q_offsets[i], vo = m.qd_offsets[i];
    const T tau_l = s[R::kTau + vo] - m.stiffness[i] * s[R::kQ + qo] - m.damping[i] * s[R::kQd + vo];
    const T u_b = tau_l - dot6(sv, pacc);
    const T scale = u_b * d_inv;
#pragma unroll
    for (int k = 0; k < 6; ++k) pa[k] += u[k] * scale;
    s[R::kUb + i] = u_b;
  }
  if (m.parents[i] >= 0) {
    const T* x = s + R::kX + 12 * i;
    const bool ident = s[R::kIdent + i] != T(0);
    T slot[33];
    abi_to_parent(x, x + 9, ident, I, H, M, slot);
    force_to_parent(x, ident, pa, slot + 27);
    copy<T, 33>(slot, out);
  }
}

// Forward sweep at link i from its parent's acceleration in `acc`, which
// holds link i's on return: qdd = (u - U^T a) / D; with `store`, qd += qdd dt.
template <typename T, int NL, int ND, int NC>
__device__ __forceinline__ void forward_link(const Model<T>& m, int i, T* s, T* acc, T dt, bool store) {
  using R = Region<NL, ND, NC>;
  T a[6];
  motion_to_child(s + R::kX + 12 * i, s[R::kIdent + i] != T(0), acc, a);
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] += s[R::kC + 6 * i + k];
  if (m.joint_types[i] != kFixed) {
    const T qdd = s[R::kDinv + i] * (s[R::kUb + i] - dot6(s + R::kU + 6 * i, a));
    if (store) {
      const int vo = m.qd_offsets[i];
      s[R::kQd + vo] = s[R::kQd + vo] + qdd * dt;
    }
    const T* sv = m.subspaces + 6 * i;
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] += sv[k] * qdd;
  }
  copy<T, 6>(a, acc);
}

// Forward M^-1 sweep of one contact row at link i: `row` holds the row's
// u at each DoF on entry (0 off the row's path) and x = (u - U^T a) / D on
// return.
template <typename T, int NL, int ND, int NC>
__device__ __forceinline__ void minv_forward_link(const Model<T>& m, int i, const T* s, T* acc, T* row) {
  using R = Region<NL, ND, NC>;
  T a[6];
  motion_to_child(s + R::kX + 12 * i, s[R::kIdent + i] != T(0), acc, a);
  if (m.joint_types[i] != kFixed) {
    const int vo = m.qd_offsets[i];
    const T xi = s[R::kDinv + i] * (row[vo] - dot6(s + R::kU + 6 * i, a));
    row[vo] = xi;
    const T* sv = m.subspaces + 6 * i;
#pragma unroll
    for (int k = 0; k < 6; ++k) a[k] += sv[k] * xi;
  }
  copy<T, 6>(a, acc);
}

template <typename T, int NL, int ND, int NC, int G>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 4 ? 5 : 3)
megastep_kernel(const Model<T> m, const T* __restrict__ q_in, const T* __restrict__ qd_in,
                const T* __restrict__ action, T* __restrict__ q_out, T* __restrict__ qd_out,
                int batch) {
  using R = Region<NL, ND, NC>;
  constexpr int NR = R::NR;
  static_assert(NR <= G, "one contact row per lane");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % G;
  const int group = threadIdx.x / G;
  const long long env = (long long)blockIdx.x * (kThreads / G) + group;
  const bool active = env < batch;
  const long long e = active ? env : batch - 1;  // a valid env to read from
  const int ns = m.num_subtrees;
  const int walkers = ns > 0 ? ns : 1;
  T* s = reinterpret_cast<T*>(smem) + group * R::stride(ns);
  const T dt = m.dt[0];

  // -- q, qd; PD on the compact pose vector; tau is zero on the passive joints
  for (int k = lane; k < ND; k += G) {
    s[R::kQ + k] = q_in[e * ND + k];
    s[R::kQd + k] = qd_in[e * ND + k];
    s[R::kTau + k] = T(0);
  }
  __syncwarp();
  PHASE_END(1);
  {
    const T limit = m.action_limit[0], kp = m.kp[0], kd = m.kd[0], max_force = m.max_force[0];
    for (int k = lane; k < m.num_pd; k += G) {
      const T target = m.initial_poses[k] + clip(action[e * m.num_pd + k], -limit, limit);
      const int slot = m.pd_q[k];  // q, qd and tau share the layout
      s[R::kTau + slot] =
          clip(kp * (target - s[R::kQ + slot]) + kd * (T(0) - s[R::kQd + slot]), -max_force, max_force);
    }
  }
  __syncwarp();
  PHASE_END(2);

  // -- forward kinematics: X_parent of each link on its own lane, then lane w
  // walks the chain and subtree w, composing the transforms and velocities
  for (int i = lane; i < NL; i += G) joint_transform<T, NL, ND, NC>(m, i, s);
  __syncwarp();
  PHASE_END(3);
  if (lane < walkers) {
    T xw_r[9], xw_p[3], v[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
    copy<T, 9>(m.base_rot, xw_r);
    copy<T, 3>(m.base_pos, xw_p);
#pragma unroll 1
    for (int k = 0; k < m.num_chain; ++k) fk_link<T, NL, ND, NC>(m, m.chain[k], xw_r, xw_p, v, s, lane == 0);
    if (ns > 0) {
#pragma unroll 1
      for (int i = m.subtrees[2 * lane]; i < m.subtrees[2 * lane + 1]; ++i)
        fk_link<T, NL, ND, NC>(m, i, xw_r, xw_p, v, s, true);
    }
  }
  __syncwarp();
  PHASE_END(4);
  {
    int sphere_links[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) sphere_links[k] = m.sphere_links[k];
    for (int i = lane; i < NL; i += G) link_terms<T, NL, ND, NC>(m, i, sphere_links, s);
  }
  __syncwarp();
  PHASE_END(5);

  // -- factor and bias sweeps: each subtree from its tip, then the chain ---
  T* slots = s + R::kSlots;
  if (lane < ns) {
    T* slot = slots + R::kSlot * lane;
#pragma unroll
    for (int k = 0; k < R::kSlot; ++k) slot[k] = T(0);
#pragma unroll 1
    for (int i = m.subtrees[2 * lane + 1] - 1; i >= m.subtrees[2 * lane]; --i)
      factor_link<T, NL, ND, NC>(m, i, s, slot, 1, slot);
  }
  __syncwarp();
  PHASE_END(6);
  if (lane == 0) {
    T* chain_slot = slots + R::kSlot * ns;
    // the branch link adds its subtrees' slots, every other chain link its child's
    factor_link<T, NL, ND, NC>(m, m.chain[m.num_chain - 1], s, slots, ns, chain_slot);
#pragma unroll 1
    for (int k = m.num_chain - 2; k >= 0; --k) factor_link<T, NL, ND, NC>(m, m.chain[k], s, chain_slot, 1, chain_slot);
  }
  __syncwarp();
  PHASE_END(7);

  // -- forward sweep from the base acceleration -g; qd += qdd dt -------------
  if (lane < walkers) {
    T acc[6];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      acc[k] = T(0);
      acc[3 + k] = -m.gravity[k];
    }
#pragma unroll 1
    for (int k = 0; k < m.num_chain; ++k) forward_link<T, NL, ND, NC>(m, m.chain[k], s, acc, dt, lane == 0);
    if (ns > 0) {
#pragma unroll 1
      for (int i = m.subtrees[2 * lane]; i < m.subtrees[2 * lane + 1]; ++i)
        forward_link<T, NL, ND, NC>(m, i, s, acc, dt, true);
    }
  }
  __syncwarp();
  PHASE_END(8);

  // -- contact rows, one per lane: rows [normals | friction 1 | friction 2] --
  // lanes past the rows carry a dummy row for the sweep (a = 1, b = lo = hi = 0)
  LaneRow<T, NR> row;
#pragma unroll
  for (int k = 0; k < NR; ++k) row.a[k] = T(1);
  row.b = row.lo = row.hi = T(0);
  row.dep = -1;
  const int contact = lane % NC, kind = lane / NC;
  T* j_row = s + R::kJ + ND * lane;
  T* jm_row = s + R::kJm + ND * lane;
  const int* path = m.sphere_paths + m.path_length * contact;
  if (lane < NR) {
    // the normal on b = -plane normal, its normalized, branch-free plane space
    T n_b[3], fr1[3], fr2[3], dir[3], point[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) n_b[k] = -m.plane_normal[k];
    {
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
    const T distance = s[R::kDist + contact];
    const T col = distance < T(0) ? T(1) : T(0);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // selected element by element: a pointer chosen at run time would
      // move the three arrays to local memory
      dir[k] = (kind == 0 ? n_b[k] : (kind == 1 ? fr1[k] : fr2[k])) * col;
      point[k] = s[R::kPoint + 3 * contact + k];
    }
#pragma unroll 1
    for (int k = 0; k < ND; ++k) {
      j_row[k] = T(0);
      jm_row[k] = T(0);
    }
    // the point Jacobian's columns along the sphere's path; J qd
    T jqd[3] = {T(0), T(0), T(0)};
#pragma unroll 1
    for (int k = 0; k < m.path_length; ++k) {
      const int i = path[k];
      if (i < 0) break;
      if (m.joint_types[i] == kFixed) continue;
      const T* st = s + R::kSt + 6 * i;
      T pxw[3], jc[3];
      cross(point, st, pxw);
#pragma unroll
      for (int dd = 0; dd < 3; ++dd) jc[dd] = st[3 + dd] - pxw[dd];
      const int vo = m.qd_offsets[i];
      j_row[vo] = jc[0] * dir[0] + jc[1] * dir[1] + jc[2] * dir[2];
      const T qdv = s[R::kQd + vo];
#pragma unroll
      for (int dd = 0; dd < 3; ++dd) jqd[dd] += jc[dd] * qdv;
    }
    T rel_vel[3];  // -J_b qd_b
#pragma unroll
    for (int k = 0; k < 3; ++k) rel_vel[k] = -jqd[k];
    if (kind == 0) {
      const T vn = dot3(n_b, rel_vel);
      row.b = (-(T(1) + m.restitution[contact]) * vn - m.erp[0] * distance / dt) * col;
      row.lo = T(0);
      row.hi = T(1e5);
    } else {
      const T mu = m.friction[contact];
      row.b = -dot3(dir, rel_vel);
      row.lo = -mu;
      row.hi = mu;
      row.dep = contact;  // a friction row's bounds scale with its normal's impulse
    }

    // M^-1 J^T row: backward along the path with p^A in registers (the
    // links off it carry no force), jm_row holding u at each DoF ...
    T pa[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll 1
    for (int k = 0; k < m.path_length; ++k) {
      const int i = path[k];
      if (i < 0) break;
      if (m.joint_types[i] != kFixed) {
        const int vo = m.qd_offsets[i];
        const T u_b = j_row[vo] - dot6(m.subspaces + 6 * i, pa);
        const T scale = u_b * s[R::kDinv + i];
#pragma unroll
        for (int c = 0; c < 6; ++c) pa[c] += s[R::kU + 6 * i + c] * scale;
        jm_row[vo] = u_b;
      }
      if (m.parents[i] >= 0) {
        T f[6];
        force_to_parent(s + R::kX + 12 * i, s[R::kIdent + i] != T(0), pa, f);
        copy<T, 6>(f, pa);
      }
    }
    // ... then forward over the chain and every subtree from zero
    T acc[6] = {T(0), T(0), T(0), T(0), T(0), T(0)};
#pragma unroll 1
    for (int k = 0; k < m.num_chain; ++k) minv_forward_link<T, NL, ND, NC>(m, m.chain[k], s, acc, jm_row);
    T branch_acc[6];
    copy<T, 6>(acc, branch_acc);
#pragma unroll 1
    for (int w = 0; w < ns; ++w) {
      copy<T, 6>(branch_acc, acc);
#pragma unroll 1
      for (int i = m.subtrees[2 * w]; i < m.subtrees[2 * w + 1]; ++i)
        minv_forward_link<T, NL, ND, NC>(m, i, s, acc, jm_row);
    }
  }
  __syncwarp();
  PHASE_END(9);

  // -- Delassus row r = J_r (M^-1 J^T)^T + cfm e_r, then PGS over the group --
  // J_r is 0 off the sphere's path: the sum runs over the path's DoFs from
  // the root down, in increasing DoF order as the dense sum would
  if (lane < NR) {
    T acc[NR];
#pragma unroll
    for (int c = 0; c < NR; ++c) acc[c] = T(0);
#pragma unroll 1
    for (int k = m.path_length - 1; k >= 0; --k) {
      const int i = path[k];
      if (i < 0 || m.joint_types[i] == kFixed) continue;
      const int vo = m.qd_offsets[i];
      const T jr = j_row[vo];
#pragma unroll
      for (int c = 0; c < NR; ++c) acc[c] += jr * s[R::kJm + ND * c + vo];
    }
    const T cfm = m.cfm[0];
#pragma unroll
    for (int c = 0; c < NR; ++c) row.a[c] = c == lane ? acc[c] + cfm : acc[c];
  }
  T x[NR];
  pgs_sweeps<T, NR, G>(x, row, m.pgs_iterations);
  PHASE_END(10);

  // -- impulse qd -= x M^-1 J^T, q += qd dt, one DoF per lane ----------------
  for (int k = lane; k < ND; k += G) {
    T impulse = T(0);
#pragma unroll
    for (int r = 0; r < NR; ++r) impulse += x[r] * s[R::kJm + ND * r + k];
    const T v = s[R::kQd + k] - impulse;
    if (active) {
      qd_out[e * ND + k] = v;
      q_out[e * ND + k] = s[R::kQ + k] + v * dt;
    }
  }
}

template <typename T>
Model<T> typed(const StepOperands& o, int num_pd) {
  return Model<T>{
      static_cast<const int*>(o.joint_types), static_cast<const int*>(o.parents),
      static_cast<const int*>(o.q_offsets), static_cast<const int*>(o.qd_offsets),
      static_cast<const int*>(o.pd_q), static_cast<const int*>(o.chain),
      static_cast<const int*>(o.subtrees), static_cast<const int*>(o.sphere_paths),
      static_cast<const T*>(o.x_t_pos), static_cast<const T*>(o.x_t_rot),
      static_cast<const T*>(o.subspaces), static_cast<const T*>(o.mass),
      static_cast<const T*>(o.com), static_cast<const T*>(o.inertia),
      static_cast<const T*>(o.stiffness), static_cast<const T*>(o.damping),
      static_cast<const T*>(o.base_pos), static_cast<const T*>(o.base_rot),
      static_cast<const T*>(o.gravity), static_cast<const T*>(o.kp),
      static_cast<const T*>(o.kd), static_cast<const T*>(o.max_force),
      static_cast<const T*>(o.action_limit), static_cast<const T*>(o.initial_poses),
      static_cast<const T*>(o.dt), static_cast<const int*>(o.sphere_links),
      static_cast<const T*>(o.sphere_offsets), static_cast<const T*>(o.sphere_radii),
      static_cast<const T*>(o.plane_normal), static_cast<const T*>(o.plane_constant),
      static_cast<const T*>(o.friction), static_cast<const T*>(o.restitution),
      static_cast<const T*>(o.erp), static_cast<const T*>(o.cfm),
      o.pgs_iterations, num_pd, o.num_chain, o.num_subtrees, o.path_length};
}

// the kernel of an instance, or nullptr: (22, 18, 4)
template <typename T>
const void* kernel_for(int num_links, int dof, int num_contacts) {
  if (num_links != 22 || dof != 18 || num_contacts != 4) return nullptr;
  return reinterpret_cast<const void*>(&megastep_kernel<T, 22, 18, 4, kLanes>);
}

size_t smem_bytes(int num_subtrees, size_t elt) {
  return static_cast<size_t>(kThreads / kLanes) * Region<22, 18, 4>::stride(num_subtrees) * elt;
}

// Raises a kernel's dynamic shared memory limit to `most` bytes, once per
// kernel and device. The first launch sets it, outside any graph capture
// when the launch is a graph's warm-up, so that no captured launch calls
// cudaFuncSetAttribute.
cudaError_t allow_smem(const void* fn, size_t most) {
  static std::mutex mutex;
  static std::set<std::pair<const void*, int>> done;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mutex);
  if (done.count({fn, device})) return cudaSuccess;
  if (most > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(most));
    if (err != cudaSuccess) return err;
  }
  done.insert({fn, device});
  return cudaSuccess;
}

template <typename T>
int launch(const StepOperands* ops, const void* q, const void* qd, const void* action, void* q_out,
           void* qd_out, int batch, int num_links, int dof, int num_contacts, int num_pd,
           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* fn = kernel_for<T>(num_links, dof, num_contacts);
  const int walkers = ops->num_subtrees > 0 ? ops->num_subtrees : 1;
  if (fn == nullptr || ops->num_friction_dir != 2 || num_pd > dof || walkers > kLanes ||
      ops->num_chain < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(ops->num_subtrees, sizeof(T));
  // what the widest tree needs: the stride grows with the subtrees
  const cudaError_t err = allow_smem(fn, smem_bytes(kLanes, sizeof(T)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Model<T> m = typed<T>(*ops, num_pd);
  const int envs = kThreads / kLanes;
  const int blocks = (batch + envs - 1) / envs;
  const T* qt = static_cast<const T*>(q);
  const T* qdt = static_cast<const T*>(qd);
  const T* at = static_cast<const T*>(action);
  T* qo = static_cast<T*>(q_out);
  T* qdo = static_cast<T*>(qd_out);
  megastep_kernel<T, 22, 18, 4, kLanes><<<blocks, kThreads, smem, s>>>(m, qt, qdt, at, qo, qdo, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, qd, q_out, qd_out (B, dof) and action (B, num_pd), contiguous, on the
// current device; ops points to host memory holding the StepParams
// pointers. Launches on `stream` without synchronising and returns cudaGetLastError() (0 when
// the launch was accepted), or cudaErrorInvalidValue for a shape with no
// instance.
extern "C" int tds_megastep_f32(const StepOperands* ops, const void* q, const void* qd,
                                const void* action, void* q_out, void* qd_out, int batch,
                                int num_links, int dof, int num_contacts, int num_pd, void* stream) {
  return launch<float>(ops, q, qd, action, q_out, qd_out, batch, num_links, dof, num_contacts,
                       num_pd, stream);
}

extern "C" int tds_megastep_f64(const StepOperands* ops, const void* q, const void* qd,
                                const void* action, void* q_out, void* qd_out, int batch,
                                int num_links, int dof, int num_contacts, int num_pd, void* stream) {
  return launch<double>(ops, q, qd, action, q_out, qd_out, batch, num_links, dof, num_contacts,
                        num_pd, stream);
}

// The launch shape of an instance in float32 (f64 = 0) or float64
// (f64 = 1) for a model with num_subtrees subtrees, on the current device:
// out[0] lanes per env, out[1] envs per block, out[2] threads per block,
// out[3] shared memory per block (bytes), out[4] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[5] registers per
// thread and out[6] local memory per thread (bytes; stack frame and
// spills), both from cudaFuncGetAttributes. Returns a cudaError_t.
extern "C" int tds_megastep_launch_shape(int f64, int num_links, int dof, int num_contacts,
                                         int num_subtrees, int* out) {
  const void* fn = f64 ? kernel_for<double>(num_links, dof, num_contacts)
                       : kernel_for<float>(num_links, dof, num_contacts);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(num_subtrees, f64 ? sizeof(double) : sizeof(float));
  cudaError_t err = allow_smem(fn, smem_bytes(kLanes, f64 ? sizeof(double) : sizeof(float)));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kLanes;
  out[1] = kThreads / kLanes;
  out[2] = kThreads;
  out[3] = static_cast<int>(smem);
  out[4] = blocks;
  out[5] = attr.numRegs;
  out[6] = static_cast<int>(attr.localSizeBytes);
  return 0;
}
