// B5: the attention forward for Hopper (sm_90a), with optional
// probabilities.
//
// Replaces vitx/kernels/flash_attention.py::_fwd_kernel (launched by _fwd;
// entries flash_attention, flash_attention_with_probs and
// flash_attention_with_mean_probs): q, k, v (B, H, T, D), q unscaled ->
// o (B, H, T, D) in the input dtype, and with mode 1 probs (B, H, T, T)
// fp32, with mode 2 the head mean (B, T, T) fp32. The body is
// attention_fwd.cuh, which K1 and B7 run too: qs = cast(q * scale); fp32
// logits, p = exp(s - max) and l in fp32; o = cast(p) v / l, the division
// after the product; probs = p / l; the mean sum_h(p / l) / H in head
// order (flash_attention.py:102-157).
//
// What bounds it on the H100: without probs, 4*B*H*T^2*D operations
// against 4*B*H*T*D elements in and out, ~T/2 operations per byte in bf16
// -- at T = 577 just under the card's ridge (~295), so bytes bound it by
// 2 %; with full probs the (B, H, T, T) fp32
// write (4 bytes per 4*D operations) bounds it by bytes; the head mean
// writes H times less and is bound by operations again. The TPU kernel
// holds a head's whole key block in VMEM and pads T > 1024 to a multiple
// of 128 with keys masked at -1e30 (flash_attention.py:110-112, 177-188);
// here key/value chunks of 64 rows stream through shared memory, the
// ragged tail is masked in the kernel, and any T runs unpadded. The
// probabilities cost a third pass that recomputes q k^T (l is known only
// after the whole key row); that trades operations, which are cheap here,
// for the bytes of rewriting an unnormalised (T, T) block.

#include "attention_fwd.cuh"

namespace vitx {

template <typename T>
cudaError_t run_fwd(const void* q, const void* k, const void* v, void* o, float* probs,
                    int mode, int B, int H, int T_, int D, cudaStream_t s) {
  AttnArgs a = {};
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.o_sb = (long long)H * T_ * D; a.o_sh = (long long)T_ * D; a.o_st = D;
  a.probs = probs;
  a.B = B; a.H = H; a.T = T_; a.D = D;
  a.q_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));  // 1.0 / D**0.5
  if (mode == PROBS_FULL) return launch_attention<T, PROBS_FULL>(a, s);
  if (mode == PROBS_MEAN) return launch_attention<T, PROBS_MEAN>(a, s);
  return launch_attention<T, PROBS_NONE>(a, s);
}

}  // namespace vitx

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: (B, H, T, D) contiguous,
// D <= 256. mode: 0 none (probs may be null), 1 full (probs B*H*T*T fp32),
// 2 head mean (probs B*T*T fp32). Returns the CUDA error of the launch (0
// when it was accepted).
extern "C" int vitx_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                  void* o, float* probs, int mode, int B, int H, int T,
                                  int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = vitx::run_fwd<vitx::bf16>(q, k, v, o, probs, mode, B, H, T, D, s);
  else
    err = vitx::run_fwd<float>(q, k, v, o, probs, mode, B, H, T, D, s);
  return static_cast<int>(err);
}
