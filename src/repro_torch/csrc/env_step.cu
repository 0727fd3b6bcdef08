// Batched Ant-lite physics: lane n runs cost[n] substeps of the contact,
// joint and torso update, with its reward accumulated on top of reward0.
//
// Replaces the TPU kernel src/repro/kernels/env_step/kernel.py
// env_substep_batch (_env_kernel_masked, and _env_kernel when cost is
// NULL: every lane runs n_sub substeps from a zero reward).
//
// What bounds it: one launch per recv over a (N, 28) f32 state; at
// N = 4096 it reads and writes about 1.1 MB, a third of a microsecond
// of HBM time, far less than the launch itself, so it is bound by launch
// latency.  The design keeps every lane's 28 state floats, 8 actions and
// its reward in registers for all its substeps: one thread per lane,
// the state read once and written once, no intermediate ever leaves the
// thread.  The loop runs exactly cost[n] substeps (the plain version's
// masked select reaches the same values).
//
// Arithmetic follows src/repro_torch/kernels/env_step/ref.py op for op,
// sums left to right; the library is built with -fmad=false so no
// multiply-add is fused, which keeps the kernel bitwise equal to the
// plain version on the card.
#include <cuda_runtime.h>

namespace {

constexpr int kStateDim = 28;
constexpr int kJoints = 8;
constexpr float kDt = 0.01f;

__global__ void env_step_kernel(const float* __restrict__ state,
                                const float* __restrict__ action,
                                const int* __restrict__ cost,
                                const float* __restrict__ reward0,
                                float* __restrict__ out_state,
                                float* __restrict__ out_reward,
                                int n, int n_sub) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n) return;
  const float* s = state + (size_t)lane * kStateDim;
  float pos[3], vel[3], rot[3], ang[3], q[kJoints], qd[kJoints], a[kJoints];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pos[i] = s[i];
    vel[i] = s[3 + i];
    rot[i] = s[6 + i];
    ang[i] = s[9 + i];
  }
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    q[j] = s[12 + j];
    qd[j] = s[20 + j];
    a[j] = fminf(fmaxf(action[(size_t)lane * kJoints + j], -1.0f), 1.0f);
  }
  float reward = reward0 ? reward0[lane] : 0.0f;
  int steps = cost ? cost[lane] : n_sub;
  if (steps > n_sub) steps = n_sub;

  for (int it = 0; it < steps; ++it) {
    // contact model on the PRE-update state
    float contact[4], foot_h[4];
#pragma unroll
    for (int leg = 0; leg < 4; ++leg) {
      const float hip = q[2 * leg], knee = q[2 * leg + 1];
      const float drop = 0.2f * cosf(hip) + 0.2f * cosf(hip + knee);
      foot_h[leg] = pos[2] - drop;
      contact[leg] = foot_h[leg] < 0.05f ? 1.0f : 0.0f;
    }
    float thrust = contact[0] * (-qd[0]);
#pragma unroll
    for (int leg = 1; leg < 4; ++leg) thrust = thrust + contact[leg] * (-qd[2 * leg]);
    thrust = thrust * 0.08f;
    float normal = contact[0] * fmaxf(0.05f - foot_h[0], 0.0f);
#pragma unroll
    for (int leg = 1; leg < 4; ++leg)
      normal = normal + contact[leg] * fmaxf(0.05f - foot_h[leg], 0.0f);
    normal = normal * 120.0f;

    // joint dynamics: torque - spring - damping
#pragma unroll
    for (int j = 0; j < kJoints; ++j) {
      const float qdd = 18.0f * a[j] - 4.0f * q[j] - 1.2f * qd[j];
      qd[j] = qd[j] + kDt * qdd;
      q[j] = fminf(fmaxf(q[j] + kDt * qd[j], -1.2f), 1.2f);
    }

    const float acc[3] = {thrust, 0.0f, -9.81f + normal};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      vel[i] = (vel[i] + kDt * acc[i]) * 0.995f;
      pos[i] = pos[i] + kDt * vel[i];
    }
    pos[2] = fmaxf(pos[2], 0.1f);

    const float asym = contact[0] + contact[1] - contact[2] - contact[3];
    const float torque[3] = {0.4f * asym, 0.2f * asym, 0.0f};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ang[i] = (ang[i] + kDt * torque[i]) * 0.98f;
      rot[i] = rot[i] + kDt * ang[i];
    }

    const float fwd = vel[0] * kDt * 20.0f;
    float sq = a[0] * a[0];
#pragma unroll
    for (int j = 1; j < kJoints; ++j) sq = sq + a[j] * a[j];
    const float ctrl = 0.5f * sq * kDt;
    reward = ((reward + fwd) - ctrl) + kDt;
  }

  float* o = out_state + (size_t)lane * kStateDim;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = pos[i];
    o[3 + i] = vel[i];
    o[6 + i] = rot[i];
    o[9 + i] = ang[i];
  }
#pragma unroll
  for (int j = 0; j < kJoints; ++j) {
    o[12 + j] = q[j];
    o[20 + j] = qd[j];
  }
  out_reward[lane] = reward;
}

}  // namespace

extern "C" int env_step_launch(const void* state, const void* action,
                               const void* cost, const void* reward0,
                               void* out_state, void* out_reward, int n,
                               int n_sub, void* stream) {
  if (n > 0) {
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    env_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)state, (const float*)action, (const int*)cost,
        (const float*)reward0, (float*)out_state, (float*)out_reward, n,
        n_sub);
  }
  return (int)cudaGetLastError();
}
