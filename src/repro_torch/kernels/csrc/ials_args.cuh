// The one argument of every entry point of ials_kernels.cu and
// serve_kernels.cu, mirrored field for field by
// repro_torch/kernels/aip_step.py::IalsArgs. Every field is 8 bytes, so
// the two layouts cannot disagree on padding; ials_args_size() lets the
// Python side check the size at load time.
#pragma once

constexpr int kMaxLeaves = 4;

struct IalsArgs {
  const int* ls_in[kMaxLeaves];      // LS leaves (L, ...) int32
  int* ls_out[kMaxLeaves];
  const int* reset_ls[kMaxLeaves];   // (T, L, ...) streamed reset leaves
  const void* noise[kMaxLeaves];     // (T, L, ...) LS noise, int32 (traffic
                                     // none; warehouse the spawns)
  const float* s0;                   // (L, SD) AIP state
  float* s_out;
  const float* frames0;              // (L, S) policy frame stack
  float* frames_out;
  const float* aw[6];                // stacked (A, ...) AIP weights
  const float* pw[6];                // w1, b1, w2, b2, [pi|v] w, [pi|v] b
  const int* actions;                // (T, L)
  const int* bits;                   // (T, L, M) uint32 bits as int32
  const float* gumbel;               // (T, L, NA)
  const int* done;                   // (T, L)
  float* x_out;                      // (T, L, S)
  int* a_out;                        // (T, L)
  float* logits_out;                 // (T, L, NA)
  float* v_out;                      // (T, L)
  float* rew_out;                    // (T, L)
  const float* d;                    // aip_step: (B, A, D)
  const float* h;                    //           (B, A, H)
  float* h2;
  float* logits;                     //           (B, A, M)
  float* u;
  const int* mask;                   // serve: (B,) lane validity
  const int* pidx;                   // serve_multi: (B,) policy per lane
  long long T, A, B, D, H, M, stack, S, obs_dim, Hp, n_act;
  // the LS device functor (0 traffic, 1 warehouse) and its constants:
  // traffic's lane length and 8-bit u_t, the warehouse's region side,
  // max_age and vanish_after
  long long domain, lane_len, ext_influence, region, max_age, vanish_after;
  long long fast_gates, n_pol;
  // the serving launch plan (aip_step.py::serve_plan): lanes per tile,
  // rows and columns of a thread's register tile, K-chunk rows, ring
  // stages, threads per block, dynamic shared bytes, blocks on the policy
  // axis, which weight pieces go by bulk copy (bit 0: [w1; w2] ring, bit
  // 1: the head)
  long long serve_lanes, serve_rows_per_thread, serve_cols_per_thread;
  long long serve_chunk_rows, serve_stages, serve_threads, serve_smem;
  long long serve_policy_blocks, serve_flags;
  // the horizon kernels' launch plan (aip_step.py::rollout_plan): lanes a
  // tile, rows of a thread's register tile, CTAs a tile (1, or 2: the
  // policy on rank 0, the AIP and LS on rank 1), threads per CTA,
  // dynamic shared bytes, K-parts of the six products (policy l1, l2,
  // head; AIP l1 / gx, l2 / gh, head)
  long long roll_lanes, roll_rows_per_thread, roll_cluster, roll_threads;
  long long roll_smem;
  long long roll_split[6];
};
