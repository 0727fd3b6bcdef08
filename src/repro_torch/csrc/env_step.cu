// Batched Ant-lite physics: lane n runs cost[n] substeps of the contact,
// joint and torso update, with its reward accumulated on top of reward0.
//
// Replaces the TPU kernel src/repro/kernels/env_step/kernel.py
// env_substep_batch (_env_kernel_masked, and _env_kernel when cost is
// NULL: every lane runs n_sub substeps from a zero reward).
//
// What bounds it: one launch per recv over a (N, 28) f32 state; at
// N = 4096 it reads and writes about 1.1 MB, a third of a microsecond
// of HBM time, far less than the launch itself.  What is left after the
// launch is latency: up to 9 substeps of a long dependent chain (8 cosf,
// each many instructions, and no fused multiply-add).  A thread per lane
// left most of the card idle (32 blocks of 4 warps at N = 4096) and each
// instruction waiting on the one before it.
//
// Design: a lane is spread over a group of kGroup = 8 threads of one
// warp, blocks of kThreads = 128 (ops.py::env_step_plan): of groups of
// 1, 4 and 8 threads in blocks of 64, 128 and 256 it was the fastest, 64
// tying (PERF.md).
//   - Thread j owns joint j, its q, qd and action in registers for all
//     substeps, and leg l is the pair (2l, 2l + 1): the hip thread takes
//     cosf(hip), the knee thread cosf(hip + knee), the hip reaching it by
//     shuffle; the pair swaps the two terms and both form the leg's drop,
//     foot height and contact.
//   - Every thread of the group keeps a replica of the torso (pos, vel,
//     rot, ang) and the reward, which is cheap, and gathers the four
//     legs' thrust and normal terms from their hip threads by shuffle and
//     their contacts by one ballot, so it forms thrust, normal and the
//     asymmetry itself.  No shuffle crosses a group, whose threads share
//     one lane and so one trip count: the shuffles name the group's
//     threads only, and a group past the last lane leaves before any.
//   - The control cost depends on the action alone: formed once, before
//     the loop, from the same products added in the same order.
//   - Loads and stores are spread over the group: thread j reads and
//     writes q[j] and qd[j] (32 contiguous bytes a group each), the
//     torso is read by every thread and written by thread i % 8.
// What remains is one substep's dependent chain, about 0.39 us, nearly
// the same with a thread a lane and at half the lanes; both threads of a
// pair holding the leg's joints (no shuffle of the hip), and issuing the
// next substep's cosines before the torso update, measured no faster
// (PERF.md).
//
// Arithmetic follows src/repro_torch/kernels/env_step/ref.py op for op:
// every sum is gathered term by term and added left to right (no
// shuffle tree), and the library is built with -fmad=false so no
// multiply-add is fused, which keeps the kernel bitwise equal to the
// plain version on the card.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kStateDim = 28;
constexpr int kJoints = 8;
constexpr int kLegs = 4;
constexpr int kTorso = 12;        // pos, vel, rot, ang
constexpr float kDt = 0.01f;
constexpr int kGroup = 8;          // threads a lane: thread j, joint j
constexpr int kThreads = 128;      // a block's threads

__global__ void __launch_bounds__(kThreads)
    env_step_kernel(const float* __restrict__ state,
                    const float* __restrict__ action,
                    const int* __restrict__ cost,
                    const float* __restrict__ reward0,
                    float* __restrict__ out_state,
                    float* __restrict__ out_reward, int n, int n_sub) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int lane = tid / kGroup, t = tid % kGroup;
  if (lane >= n) return;                 // the whole group leaves
  const int first = (threadIdx.x & 31) & ~(kGroup - 1);   // in the warp
  const unsigned group = ((1u << kGroup) - 1u) << first;
  const bool knee = t & 1;

  const float* s = state + (size_t)lane * kStateDim;
  float pos[3], vel[3], rot[3], ang[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pos[i] = s[i];
    vel[i] = s[3 + i];
    rot[i] = s[6 + i];
    ang[i] = s[9 + i];
  }
  float q = s[12 + t], qd = s[20 + t];
  const float a =
      fminf(fmaxf(action[(size_t)lane * kJoints + t], -1.0f), 1.0f);
  float reward = reward0 ? reward0[lane] : 0.0f;
  int steps = cost ? cost[lane] : n_sub;
  if (steps > n_sub) steps = n_sub;

  // control cost: joint j's a * a from its thread, added in joint order
  float sq = __shfl_sync(group, a * a, 0, kGroup);
#pragma unroll
  for (int j = 1; j < kJoints; ++j)
    sq = sq + __shfl_sync(group, a * a, j, kGroup);
  const float ctrl = 0.5f * sq * kDt;

  for (int it = 0; it < steps; ++it) {
    // contact model on the PRE-update state: this thread's leg
    const float other = __shfl_xor_sync(group, q, 1);
    const float c = 0.2f * cosf(knee ? other + q : q);
    const float c_other = __shfl_xor_sync(group, c, 1);
    const float drop = knee ? c_other + c : c + c_other;
    const float foot_h = pos[2] - drop;
    const bool hit = foot_h < 0.05f;
    const float contact = hit ? 1.0f : 0.0f;
    const float push = contact * (-qd);   // right on the hip thread
    const float press = contact * fmaxf(0.05f - foot_h, 0.0f);

    // the four legs from their hip threads, in leg order
    const unsigned hits = __ballot_sync(group, hit);
    float legs[kLegs], thrust = 0.0f, normal = 0.0f;
#pragma unroll
    for (int leg = 0; leg < kLegs; ++leg) {
      legs[leg] = (hits >> (first + 2 * leg) & 1u) ? 1.0f : 0.0f;
      const float p = __shfl_sync(group, push, 2 * leg, kGroup);
      const float r = __shfl_sync(group, press, 2 * leg, kGroup);
      thrust = leg == 0 ? p : thrust + p;
      normal = leg == 0 ? r : normal + r;
    }
    thrust = thrust * 0.08f;
    normal = normal * 120.0f;

    // joint dynamics: torque - spring - damping
    const float qdd = 18.0f * a - 4.0f * q - 1.2f * qd;
    qd = qd + kDt * qdd;
    q = fminf(fmaxf(q + kDt * qd, -1.2f), 1.2f);

    const float acc[3] = {thrust, 0.0f, -9.81f + normal};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      vel[i] = (vel[i] + kDt * acc[i]) * 0.995f;
      pos[i] = pos[i] + kDt * vel[i];
    }
    pos[2] = fmaxf(pos[2], 0.1f);

    const float asym = legs[0] + legs[1] - legs[2] - legs[3];
    const float torque[3] = {0.4f * asym, 0.2f * asym, 0.0f};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ang[i] = (ang[i] + kDt * torque[i]) * 0.98f;
      rot[i] = rot[i] + kDt * ang[i];
    }

    const float fwd = vel[0] * kDt * 20.0f;
    reward = ((reward + fwd) - ctrl) + kDt;
  }

  float* o = out_state + (size_t)lane * kStateDim;
  const float torso[kTorso] = {pos[0], pos[1], pos[2], vel[0], vel[1],
                               vel[2], rot[0], rot[1], rot[2], ang[0],
                               ang[1], ang[2]};
#pragma unroll
  for (int i = 0; i < kTorso; ++i)
    if (i % kGroup == t) o[i] = torso[i];
  o[12 + t] = q;
  o[20 + t] = qd;
  if (t == 0) out_reward[lane] = reward;
}

}  // namespace

// state (n, 28), action (n, 8) f32, cost (n,) int32 or NULL, reward0
// (n,) f32 or NULL, out_state (n, 28), out_reward (n,); all dense.  Each
// lane takes kGroup threads of one warp, in `blocks` blocks of kThreads
// that must cover all n * kGroup (ops.py::env_step_plan).
extern "C" int env_step_launch(const void* state, const void* action,
                               const void* cost, const void* reward0,
                               void* out_state, void* out_reward, int n,
                               int n_sub, int blocks, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (blocks < 1 || n > INT_MAX / kGroup ||
      (long long)blocks * kThreads < (long long)n * kGroup ||
      (long long)blocks * kThreads > INT_MAX)
    return (int)cudaErrorInvalidValue;
  env_step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)state, (const float*)action, (const int*)cost,
      (const float*)reward0, (float*)out_state, (float*)out_reward, n, n_sub);
  return (int)cudaGetLastError();
}
