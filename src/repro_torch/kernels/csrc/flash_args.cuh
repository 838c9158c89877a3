// The argument block of both flash-attention entry points
// (flash_f32.cu::layer_flash_attention, the CUDA-core kernel, and
// flash_wgmma.cu::layer_flash_attention_tc, the tensor-core one), mirrored
// field for field by repro_torch/kernels/flash_attention.py::FlashArgs
// (every field 8 bytes). Batch index bh = b * nh + h; the KV head of query
// head h is h / group; element strides over (batch, head, row), the last
// axis contiguous. The f32_* fields carry the CUDA-core kernel's launch
// plan (flash_attention.py::f32_plan; the tensor-core kernel ignores
// them); marks, when not null, takes the clock64 sums of that kernel's
// timeline build (tools/flash_f32_ablation.py).
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
  long long f32_rows, f32_keys, f32_threads, f32_stages, f32_smem;
  void* marks;
};
