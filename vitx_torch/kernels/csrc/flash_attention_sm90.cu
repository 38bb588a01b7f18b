// B5 on Hopper (sm_90a): wgmma, TMA and an online softmax, bf16 at head
// widths 32, 64 and 128, without probabilities and in its two probability
// modes.
//
// Replaces vitx/kernels/flash_attention.py::_fwd_kernel (launched by _fwd;
// entries flash_attention, flash_attention_with_probs and
// flash_attention_with_mean_probs) for bf16 q, k, v: q, k, v (B, H, T, D),
// q unscaled -> o (B, H, T, D) bf16 and
//   - without probabilities (entry vitx_attention_fwd_sm90; D 32, 64 or
//     128: MAE's decoder, the ViT-B/L family, huge14 and base16_hd128),
//     for the backward, the row statistics stats (2, B, H, T) fp32: the
//     row max m of the logits and linv = 1 / l;
//   - with them (entry vitx_attention_fwd_probs_sm90, the same widths: the
//     attention maps and rollout of every bf16 preset), probs: (B, H, T, T)
//     fp32 in the full mode, the head mean (B, T, T) fp32 in the mean mode.
//     The body writes the statistics into the caller's scratch, then
//     attention_probs_sm90.cuh recomputes s = q k^T from the same tiles and
//     writes p = exp(s - m) * linv (the mean: summed over the heads in
//     order, / H) -- B7's head-mean pass on B5's own q and k, and the same
//     pass one head a block for the full mode. At D 32 and 128 both round
//     qs = cast(q * scale) into their q tiles first, so the pass's logits
//     are the body's.
// fp32 and other D keep attention_fwd.cuh (flash_attention_fwd.cu). The
// body, its function and its one moved rounding point are in
// attention_fwd_sm90.cuh, which K1 (mha_block.cu) runs too; o is the
// body's in every mode, so the probability modes' o equals the no-probs
// o bit for bit.
//
// What bounds it on the H100: without probs, 4*B*H*T^2*D operations
// against 4*B*H*T*D bf16 elements in and out -- T/2 operations a byte
// against the card's ridge of ~295, so at T = 577 the two bounds are
// within 2 % (bytes 0.045 ms, operations 0.044 ms at (32, 16, 577, 64));
// past T ~ 600 the tensor cores bound it, and with them the exp of every
// logit. The full probabilities add B*H*T^2 fp32 (4 bytes per 4*D
// operations): bytes bound that mode. The head mean adds H times fewer
// bytes and stays near the ridge. The earlier kernel made two passes over
// the keys (m, then l and o: 6*B*H*T^2*D operations) and a third for the
// probabilities, staged every product's fp32 result through shared memory
// and loaded tiles with ordinary loads; this one makes one pass with the
// tiles arriving by TMA and every product on wgmma, and the probability
// pass one more product per head.

#include "attention_fwd_sm90.cuh"
#include "attention_probs_sm90.cuh"

// q, k, v, o: bf16 (B, H, T, D) views, D 32, 64 or 128, whose element
// strides are views[0..11] = (sb, sh, st) of q, k, v, o, each a multiple of
// 8, the last dim contiguous, pointers 16-byte aligned. stats: null, or
// (2, B*H*T) fp32. Returns 0, the CUDA error of the launch, a tensor-map
// code of sm90.cuh, or ERR_ROUTE for another D.
extern "C" int vitx_attention_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                                       float* stats, const long long* views, int B, int H,
                                       int T, int D, void* stream) {
  using namespace vitx;
  const void* in[3] = {q, k, v};
  FwdArgs a = {};
  a.o = static_cast<bf16*>(o);
  a.o_sb = views[9]; a.o_sh = views[10]; a.o_st = views[11];
  a.stats = stats;
  a.H = H; a.T = T;
  a.scale = sm90::attention_scale(D);
  return launch_attention_fwd_sm90<false>(in, views, a, B, D,
                                         static_cast<cudaStream_t>(stream));
}

// q, k, v, o: bf16 (B, H, T, D) contiguous, D 32, 64 or 128, pointers
// 16-byte aligned, B * H at most 65535. stats: (2, B*H*T) fp32 scratch
// (the body writes it, the pass reads it). mode: 1 full (probs (B, H, T,
// T) fp32), 2 head mean (probs (B, T, T) fp32). Returns 0, the first CUDA
// error of the two launches, a tensor-map code of sm90.cuh, or ERR_ROUTE
// for another mode or D.
extern "C" int vitx_attention_fwd_probs_sm90(const void* q, const void* k, const void* v,
                                             void* o, float* stats, float* probs, int mode,
                                             int B, int H, int T, int D, void* stream) {
  using namespace vitx;
  constexpr int FULL = 1, MEAN = 2;   // flash_attention.py's PROBS_MODES
  if (mode != FULL && mode != MEAN) return sm90::ERR_ROUTE;
  if (D != 32 && D != 64 && D != 128) return sm90::ERR_ROUTE;
  if ((long long)B * H > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long TD = (long long)T * D, HTD = H * TD;
  const long long views[9] = {HTD, TD, D, HTD, TD, D, HTD, TD, D};
  const void* in[3] = {q, k, v};
  FwdArgs a = {};
  a.o = static_cast<bf16*>(o);
  a.o_sb = HTD; a.o_sh = TD; a.o_st = D;
  a.stats = stats;
  a.H = H; a.T = T;
  a.scale = sm90::attention_scale(D);
  const int err = launch_attention_fwd_sm90<false>(in, views, a, B, D, s);
  if (err != 0) return err;
  if (mode == MEAN)
    return launch_attention_probs_sm90<true>(q, k, stats, probs, B, H, T, D, a.scale, s);
  return launch_attention_probs_sm90<false>(q, k, stats, probs, B, H, T, D, a.scale, s);
}
