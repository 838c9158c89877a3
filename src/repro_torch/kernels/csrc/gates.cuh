// The rational gates and the GRU gate update, shared by every kernel that
// runs a GRU cell (ials_kernels.cu: the AIP tick and rollouts;
// layer_kernels.cu: gru_sequence), so that all of them round the gates
// the same way. Counterparts of repro_torch/nn/act.py::fast_tanh /
// fast_sigmoid and of the cell body of repro_torch/nn/rnn.py::gru_cell.
//
// Elementwise math uses the _rn intrinsics, so the compiler contracts
// nothing into an FMA and each step rounds exactly as torch's elementwise
// ops do: a kernel differs from its plain version only in the order of
// its matrix-product sums.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float fast_tanh(float x) {
  const float c = 4.97178686f;
  x = fminf(fmaxf(x, -c), c);
  const float x2 = __fmul_rn(x, x);
  const float num = __fmul_rn(
      x, __fadd_rn(135135.0f,
                   __fmul_rn(x2, __fadd_rn(17325.0f,
                                           __fmul_rn(x2, __fadd_rn(378.0f,
                                                                   x2))))));
  const float den = __fadd_rn(
      135135.0f,
      __fmul_rn(x2, __fadd_rn(62370.0f,
                              __fmul_rn(x2, __fadd_rn(3150.0f,
                                                      __fmul_rn(x2,
                                                                28.0f))))));
  return __fdiv_rn(num, den);
}

__device__ __forceinline__ float fast_sigmoid(float x) {
  return __fmul_rn(0.5f, __fadd_rn(fast_tanh(__fmul_rn(0.5f, x)), 1.0f));
}

// One hidden unit of the GRU cell, gate-major [r|z|n]: gx = x @ wx + b and
// gh = h @ wh at this unit's three columns, h its old value -> new h.
__device__ __forceinline__ float gru_gate(float gx_r, float gx_z, float gx_n,
                                          float gh_r, float gh_z, float gh_n,
                                          float h) {
  const float r = fast_sigmoid(__fadd_rn(gx_r, gh_r));
  const float z = fast_sigmoid(__fadd_rn(gx_z, gh_z));
  const float n = fast_tanh(__fadd_rn(gx_n, __fmul_rn(r, gh_n)));
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, z), n), __fmul_rn(z, h));
}

}  // namespace
