// B5 without probabilities on Hopper (sm_90a): wgmma, TMA and an online
// softmax, bf16 at head width 64.
//
// Replaces vitx/kernels/flash_attention.py::_fwd_kernel in its no-probs
// mode (launched by _fwd; entry flash_attention) for bf16 q, k, v with
// D = 64, the head width of every model the port runs: q, k, v (B, H, T,
// 64), q unscaled -> o (B, H, T, 64) bf16 and, for the backward, the row
// statistics stats (2, B, H, T) fp32: the row max m of the logits and
// linv = 1 / l. The probs modes, fp32 and other D keep attention_fwd.cuh
// (flash_attention_fwd.cu). The body, its function and its one moved
// rounding point are in attention_fwd_sm90.cuh, which K1 (mha_block.cu)
// runs too.
//
// What bounds it on the H100: 4*B*H*T^2*D operations against 4*B*H*T*D
// bf16 elements in and out -- T/2 operations a byte against the card's
// ridge of ~295, so at T = 577 the two bounds are within 2 % (bytes
// 0.045 ms, operations 0.044 ms at (32, 16, 577, 64)); past T ~ 600 the
// tensor cores bound it, and with them the exp of every logit. The
// earlier kernel made two passes over the keys (m, then l and o:
// 6*B*H*T^2*D operations), staged every product's fp32 result through
// shared memory and loaded tiles with ordinary loads; this one makes one
// pass with the tiles arriving by TMA and every product on wgmma.

#include "attention_fwd_sm90.cuh"

// q, k, v, o: bf16 (B, H, T, 64) views whose element strides are
// views[0..11] = (sb, sh, st) of q, k, v, o, each a multiple of 8, the last
// dim contiguous, pointers 16-byte aligned. stats: null, or (2, B*H*T) fp32.
// Returns 0, the CUDA error of the launch, or a tensor-map code of sm90.cuh.
extern "C" int vitx_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                       float* stats, const long long* views, int B, int H,
                                       int T, void* stream) {
  using namespace vitx;
  const void* in[3] = {q, k, v};
  FwdArgs a = {};
  a.o = static_cast<bf16*>(o);
  a.o_sb = views[9]; a.o_sh = views[10]; a.o_st = views[11];
  a.stats = stats;
  a.H = H; a.T = T;
  a.scale = 0.125f;   // 1 / sqrt(64)
  return launch_attention_fwd_sm90<false>(in, views, a, B,
                                         static_cast<cudaStream_t>(stream));
}
