// The argument block of both flash-attention entry points
// (layer_kernels.cu::layer_flash_attention, the CUDA-core kernel, and
// flash_wgmma.cu::layer_flash_attention_tc, the tensor-core one), mirrored
// field for field by repro_torch/kernels/flash_attention.py::FlashArgs
// (every field 8 bytes). Batch index bh = b * nh + h; the KV head of query
// head h is h / group; element strides over (batch, head, row), the last
// axis contiguous.
#pragma once

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long nbh, nh, group, T, S, D, Dv, causal;
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_st;
  double scale;
};
