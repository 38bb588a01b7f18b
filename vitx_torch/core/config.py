"""Model configuration of the PyTorch port.

A copy of ``vitx/core/config.py`` (the JAX package is not imported here):
the same fields, defaults, ``__post_init__`` checks, presets and JSON form,
so a config written by either package loads in the other. Only the dtype
names map to ``torch`` dtypes.

Fields that mean nothing to an eager PyTorch forward are accepted and
ignored: ``scan_unroll`` (the port runs the blocks as a Python loop, with
no scan to unroll) and ``sp``/``ep`` (sharding annotations). ``remat`` is
activation checkpointing per block where autograd records the blocks
(``vitx_torch.nn.vit.run_blocks``): "block" recomputes each block in the
backward, "dots" keeps the 2-D products' outputs, "save_stash" keeps K1's
stash and recomputes the MLP half, "none" keeps every activation. ``attn_impl``/``fuse_mha``/``fuse_mlp`` keep their meaning:
on a CUDA device "auto" and "on" select the Hopper kernels of
``vitx_torch.kernels`` (see ``vitx_torch.nn.vit._use_fused_mha``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Hyperparameters of a ViT classifier (frozen, hashable)."""

    # --- shape of the problem ---
    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    num_classes: int = 1000

    # --- transformer ---
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    # Reference encoder blocks use ReLU (transformer.py:55-60); standard ViT
    # uses GELU. Parity presets set "relu"; perf presets "gelu_tanh";
    # "swiglu" = the gated FFN (Shazeer 2020 / EVA-02): hidden =
    # SiLU(x@w1 + b1) * (x@w3 + b3) with an extra per-block gate projection
    # w3 (params/FLOPs grow by one up-projection — FLOP-match by choosing a
    # smaller mlp_ratio). Composed XLA path (the gate multiply fuses into
    # the up-projections); the fused Linear->act->Linear kernel is
    # auto-disabled.
    mlp_act: str = "gelu"
    # Reference attention has NO QKV bias (transformer.py:12-17) but DOES have
    # an output-projection bias (transformer.py:38).
    qkv_bias: bool = False
    proj_bias: bool = True
    # QK-Norm (ViT-22B, Dehghani et al. 2023): LayerNorm (learned scale, no
    # bias) applied per-head to the query and key projections before the
    # logit dot product — bounds attention logits and removes the loss
    # divergences seen when scaling ViTs (their §3.2, "uncontrolled growth
    # of attention logits"). Normalized q/k still feed the flash kernel;
    # the fused MHA block kernel (which computes QKV in-kernel) falls back
    # to the composed path.
    qk_norm: bool = False
    dropout: float = 0.0
    # Stochastic depth (DeiT recipe): max residual-branch drop rate, scaled
    # linearly from 0 at the first block to this value at the last.
    drop_path: float = 0.0
    # LayerScale (CaiT, Touvron et al. 2021 "Going deeper with image
    # transformers"): a learned per-channel diagonal gain on each residual
    # branch output — x + ls1*MHA(LN1 x); x + ls2*MLP(LN2 x) — initialized
    # to a small constant so deep encoders start near-identity and train
    # stably (the paper's fix for depth > 18). 0.0 = off (no ls leaves).
    # Typical inits: 1e-1 (depth <= 18), 1e-5 (24), 1e-6 (36). Applied
    # OUTSIDE the fused MHA/MLP kernels (one elementwise multiply that XLA
    # fuses into the residual add), so every kernel path is unchanged.
    layerscale_init: float = 0.0
    # Patch dropout (Liu et al. 2022 "PatchDropout"; FLIP, Li et al. 2023):
    # during TRAINING, each sample keeps only a random subset of its patch
    # tokens — the encoder runs on num_patches - floor(num_patches *
    # patch_drop) patches (a STATIC count, so shapes stay compile-time
    # fixed), cutting encoder matmul FLOPs ~linearly and attention FLOPs
    # quadratically. Prefix (CLS/distill) and register tokens are always
    # kept; inference always runs the full token set. 0 = off; FLIP found
    # 0.5 loses little accuracy at scale.
    patch_drop: float = 0.0

    # --- positional information ---
    # "learned": a trained (1, pos_len, E) table added to the prefix+patch
    #   tokens (the reference's nn.Parameter, vit.py:35-38). The default;
    #   every parity/interop path assumes it.
    # "sincos2d": the FIXED 2D sine-cosine table (MAE, He et al. 2022
    #   Appendix A; same math as the original "Attention is All You Need"
    #   encoding, factorized row x column with E/2 dims per axis). Not a
    #   parameter — computed from the grid geometry at trace time (XLA
    #   constant-folds it), so there is no pos_embed leaf, nothing to
    #   checkpoint, and retargeting image_size/patch_size regenerates the
    #   right table for free. Prefix (CLS/distill) rows are zero.
    # "rope": 2D AXIAL rotary embeddings (RoPE; EVA-02 / Heo et al. 2024
    #   "Rotary Position Embedding for Vision Transformer"): nothing is
    #   added to the tokens — every attention layer rotates q and k by
    #   position-dependent angles (first half of head_dim by the patch ROW,
    #   second half by the COLUMN), making attention logits depend on
    #   RELATIVE offsets only. Position information reaches every layer
    #   (additive tables decay through the residual stream) and resolution
    #   retargeting regenerates angles exactly. Prefix/register tokens get
    #   zero angles (identity rotation). Runs the composed-QKV attention
    #   path (rotation happens between the QKV projection and the flash
    #   kernel, which stays enabled); the fused LN->QKV->attn kernel
    #   computes QKV in-kernel and is auto-disabled.
    pos_embed: str = "learned"
    # RoPE frequency base: angle(i) = pos * base**(-4i/head_dim) per axis.
    # 100.0 (EVA-02's choice for image grids) — grids are ~14-24 positions,
    # not thousands of text tokens, so a much shorter wavelength ladder
    # than the LLM 10000 default.
    rope_base: float = 100.0

    # --- stem ---
    # "patch": space-to-depth + matmul patchify (the reference's Conv2d
    #   stride=patch, vit.py:20-30, in MXU form).
    # "conv": convolutional stem ("Early convolutions help transformers see
    #   better", Xiao et al. 2021): log2(patch_size) 3x3 stride-2 convs
    #   (channels doubling to embed_dim, GELU between) + a 1x1 projection.
    #   Requires patch_size to be a power of two.
    stem: str = "patch"

    # --- classifier head ---
    # "reference": Linear(E,4E) -> GELU -> LayerNorm(4E) -> Linear(4E,classes)
    #   (the reference's unusual head, vit.py:69-74).
    # "standard": LayerNorm(E) -> Linear(E, classes) (vanilla ViT).
    # "map": multihead attention pooling (Zhai et al. 2022 "Scaling Vision
    #   Transformers" / ViT-22B): a learned probe token cross-attends to
    #   the encoder output (registers excluded), a pre-LN MLP residual
    #   refines it, then LN -> Linear classifies — the big-ViT head that
    #   replaces the CLS token's role (the CLS token may still exist; MAP
    #   simply pools over it like any other token).
    head_type: str = "reference"
    # Which vector feeds the reference/standard head: "cls" (token 0 — the
    # reference semantics) or "gap" (mean over the patch tokens, the
    # MAE-fine-tune pooling; prefix/register tokens excluded). Ignored by
    # head_type="map" (it pools by attention).
    global_pool: str = "cls"
    # Vanilla ViT has a final encoder LayerNorm; the reference omits it
    # (vit.py:77-80). Parity presets keep False.
    final_norm: bool = False
    # DeiT distillation token (Touvron et al. 2021, "distillation through
    # attention"): a second learned token prepended after CLS with its own
    # linear head. Training: CE on the CLS head + distillation loss on the
    # distill head (vitx/train/distill.py); inference: the two heads'
    # logits are averaged. The distill head is always the standard
    # LN->Linear form (DeiT), independent of head_type.
    distill_token: bool = False
    # Register tokens (Darcet et al. 2023, "Vision Transformers Need
    # Registers"): extra learned tokens that participate in attention but
    # are never read by any head — they absorb the high-norm "artifact"
    # tokens and clean up attention/rollout maps. Appended AFTER the patch
    # tokens with no positional embedding (attention is permutation-
    # equivariant, so tail placement is equivalent to the paper's and keeps
    # every prefix/pos-embed index unchanged). Typical: 4.
    num_registers: int = 0
    # Token merging (ToMe, Bolya et al. 2023): merge the tome_r most
    # similar patch-token pairs per block at INFERENCE — block l runs on
    # seq_len - l*tome_r tokens, trading a small accuracy delta for large
    # throughput (vitx/nn/tome.py; forward-only; training/probs paths
    # ignore it). 0 = off. Works on any trained checkpoint unchanged.
    # Also accepts a PER-BLOCK schedule (tuple of ints, one per block —
    # the paper's decreasing-schedule variant): e.g. on ViT-B/16 @224,
    # (23, 23, 22) + nine zeros merges down to exactly 128 tokens by block
    # 3, after which every T x T attention tile is lane-exact on TPU (a
    # constant r=13 leaves every block's scores padded to 256 lanes).
    tome_r: Any = 0
    # Apply ToMe during TRAINING too (Bolya et al. 2023 §4): the train step
    # runs the merging encoder (gradients flow through the size-weighted
    # merges; the pair matching is non-differentiable routing, like
    # pooling), cutting train FLOPs the same way patch_drop does but
    # keeping inference/eval semantics identical to the eval-time ToMe
    # path. Requires tome_r; excluded with patch_drop (two token-subset
    # mechanisms) and distill_token (forward_heads runs the full-token
    # encoder).
    tome_train: bool = False

    # LoRA adapters (Hu et al. 2021): rank-r low-rank deltas on the block
    # weight matrices, trained with the base weights FROZEN — the
    # parameter-efficient fine-tune path (pairs with --init-from). 0 = off.
    # Targets: "attn" adapts wqkv + wo (the paper's choice), "all" also
    # adapts the MLP's w1/w2. The merged weight is w + (alpha/rank) * A @ B,
    # folded per-layer inside the encoder scan (cheap: an (E, r) x (r, ...)
    # matmul per target per block) so every forward path — fused kernels,
    # rollout, ToMe, saliency — sees ordinary dense weights. Fold the
    # adapters into a plain checkpoint with vitx.nn.lora.merge_lora_params.
    lora_rank: int = 0
    lora_alpha: float = 0.0      # 0.0 -> defaults to lora_rank (scale 1)
    lora_targets: str = "attn"

    # Soft Mixture-of-Experts MLPs (Soft-MoE, Puigcerver et al. 2023): the
    # LAST ``moe_block_count`` blocks replace their dense MLP with a soft
    # mixture of ``moe_experts`` expert MLPs. Each expert processes
    # ``moe_slot_count`` slots; every slot is a learned SOFT (convex)
    # combination of all tokens, and every token's output is a soft
    # combination of all slot outputs — fully differentiable, no token
    # dropping, no load-balancing loss, and (critically for TPU) every
    # shape is static: the whole layer is five einsums + two softmaxes,
    # so XLA tiles it straight onto the MXU. Parameter count scales with
    # moe_experts while per-token FLOPs stay roughly constant (set by the
    # total slot count). 0 = off (dense MLPs everywhere).
    moe_experts: int = 0
    # How many FINAL blocks are MoE blocks (the paper's "last half"
    # placement). 0 with moe_experts > 0 -> depth // 2.
    moe_blocks: int = 0
    # Slots per expert. 0 -> max(1, seq_len // moe_experts) (total slots ~=
    # sequence length, the paper's FLOP-matched default).
    moe_slots: int = 0
    # Expert parallelism (sharding annotation, like ``sp``): shard the
    # expert dimension of the MoE weights and slot activations over the
    # mesh's ``expert`` axis (vitx/parallel/mesh.py::make_mesh(ep=...)).
    # The batch is sharded over data x expert outside the MoE layers; XLA
    # inserts the dp<->ep all-to-alls at the slot einsums. Set via
    # make_parallel_*_step(ep=True) / --ep; requires an expert mesh axis.
    ep: bool = False

    layer_norm_eps: float = 1e-5  # torch nn.LayerNorm default, for parity

    # Sequence parallelism (Megatron-LM SP, Korthikanti et al. 2022): under
    # a tensor-parallel mesh, keep the residual stream SHARDED over the
    # token dim on the model axis between blocks — the LN/residual segments
    # that tp otherwise replicates run (and store activations) at 1/tp, and
    # XLA turns the out-projection all-reduce into reduce-scatter +
    # all-gather pairs at the matmul boundaries. Pure sharding annotation
    # (with_sharding_constraint on the block carriers, vit.py::run_blocks);
    # numerics are unchanged. Set via make_parallel_*_step(sp=True) /
    # --sp; requires a (data, model) mesh context — not a single-device
    # flag.
    sp: bool = False

    # --- reference-semantics mode ---
    # "corrected": CLS prepended, attention scaled by 1/sqrt(head_dim) (the
    #   notebook/C semantics; what every preset uses).
    # "bug_exact": reproduce the reference train.py model EXACTLY so its
    #   trained checkpoints give identical predictions — CLS APPENDED while
    #   the head reads token 0 (vit.py:41 vs :80), attention logits
    #   *multiplied* by sqrt(head_dim) (transformer.py:24), and a
    #   per-batch-slot CLS honored when the imported checkpoint carries one
    #   (vit.py:31-33). Forces the composed attention path (the kernels
    #   implement the corrected scale).
    parity: str = "corrected"

    # --- numerics ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # --- kernels ---
    # "auto" / "flash": the fused kernels on a CUDA device, the plain torch
    # versions on the CPU; on the composed path the flash-attention kernel
    # (always for "flash", for "auto" on CUDA at D >= 32 and T >= 128).
    # "reference" / "xla": the composed path with the plain attention.
    attn_impl: str = "auto"
    # Fused LN->QKV->attention->proj block kernel
    # (vitx_torch/kernels/mha_block.py). "auto": on for CUDA tensors when
    # attn_impl is "auto" or "flash" and no full probs are requested (head-
    # mean probs take its B7 form); "on"/"off": force.
    fuse_mha: str = "auto"
    # Fused LN->Linear->act->Linear MLP kernel
    # (vitx_torch/kernels/mlp_block.py), same semantics as fuse_mha.
    fuse_mlp: str = "auto"

    # --- memory (training; kept for config compatibility) ---
    remat: str = "block"

    # Encoder scan unroll factor in the JAX package; ignored by the port.
    scan_unroll: int = 1

    # --- initialization ---
    init_std: float = 0.02  # trunc-normal std for weights / cls / pos embeddings
    seed: int = 0

    def __post_init__(self):
        if self.image_size % self.patch_size != 0:
            raise ValueError(
                f"image_size {self.image_size} not divisible by patch_size "
                f"{self.patch_size}"
            )
        if self.embed_dim % self.num_heads != 0:
            raise ValueError(
                f"embed_dim {self.embed_dim} not divisible by num_heads "
                f"{self.num_heads}"
            )
        if self.mlp_act not in ("gelu", "gelu_tanh", "relu", "swiglu"):
            raise ValueError(f"unknown mlp_act {self.mlp_act!r}")
        if self.mlp_act == "swiglu":
            # SwiGLU (Shazeer 2020; EVA-02's FFN): hidden =
            # SiLU(x@w1) * (x@w3) — an extra (E, M) gate projection per
            # block (params/FLOPs grow by one up-projection; pick a smaller
            # mlp_ratio to FLOP-match, the paper uses 2/3 * 4E).
            if self.parity == "bug_exact":
                raise ValueError(
                    "mlp_act='swiglu' is a beyond-reference extension; "
                    "bug_exact parity reproduces the reference model, "
                    "whose FeedForward is Linear->act->Linear")
            if self.moe_experts:
                raise ValueError(
                    "mlp_act='swiglu' + moe_experts is unsupported: the "
                    "Soft-MoE expert MLPs are ungated Linear->act->Linear")
            if self.fuse_mlp == "on":
                raise ValueError(
                    "fuse_mlp='on' + mlp_act='swiglu' is unsupported: the "
                    "fused kernel computes Linear->act->Linear; leave "
                    "fuse_mlp='auto' (swiglu auto-routes to the composed "
                    "path)")
        if self.head_type not in ("reference", "standard", "map"):
            raise ValueError(f"unknown head_type {self.head_type!r}")
        if self.global_pool not in ("cls", "gap"):
            raise ValueError(f"unknown global_pool {self.global_pool!r}")
        if self.parity == "bug_exact" and (self.head_type == "map"
                                           or self.global_pool != "cls"):
            raise ValueError(
                "bug_exact parity reproduces the reference model: its head "
                "reads token 0 (vit.py:80) — head_type='map' and "
                "global_pool='gap' are beyond-reference extensions")
        if self.pos_embed not in ("learned", "sincos2d", "rope"):
            raise ValueError(f"unknown pos_embed {self.pos_embed!r}; "
                             "have 'learned', 'sincos2d', 'rope'")
        if self.pos_embed != "learned":
            if self.parity == "bug_exact":
                raise ValueError(
                    "pos_embed is a beyond-reference extension; bug_exact "
                    "parity reproduces the reference model, which has a "
                    "learned positional table (vit.py:35-38)")
            if self.pos_embed == "sincos2d" and self.embed_dim % 4:
                raise ValueError(
                    "pos_embed='sincos2d' factorizes embed_dim into "
                    "row/column sin+cos quarters — embed_dim must be "
                    f"divisible by 4, got {self.embed_dim}")
            if self.pos_embed == "rope":
                if self.head_dim % 4:
                    raise ValueError(
                        "pos_embed='rope' splits head_dim into row/column "
                        "rotation-pair quarters — head_dim must be "
                        f"divisible by 4, got {self.head_dim}")
                if self.tome_r:
                    raise ValueError(
                        "tome_r + pos_embed='rope' is unsupported: merged "
                        "tokens have no single grid position to rotate by")
                if self.patch_drop:
                    raise ValueError(
                        "patch_drop + pos_embed='rope' is unsupported: the "
                        "per-sample token subset would need per-sample "
                        "rotation tables")
                if self.fuse_mha == "on":
                    raise ValueError(
                        "fuse_mha='on' + pos_embed='rope' is unsupported: "
                        "the fused block kernel computes QKV in-kernel with "
                        "no rotation; leave fuse_mha='auto' (rope "
                        "auto-routes to the composed path, flash kernel "
                        "still enabled)")
        if self.rope_base <= 1.0:
            raise ValueError(f"rope_base must be > 1, got {self.rope_base}")
        if self.stem not in ("patch", "conv"):
            raise ValueError(f"unknown stem {self.stem!r}")
        if self.stem == "conv" and (
                self.patch_size < 2
                or self.patch_size & (self.patch_size - 1)):
            raise ValueError("stem='conv' needs a power-of-two patch_size, "
                             f"got {self.patch_size}")
        if self.remat not in ("block", "dots", "save_stash", "none"):
            raise ValueError(f"unknown remat {self.remat!r}")
        if self.fuse_mha not in ("auto", "on", "off"):
            raise ValueError(f"unknown fuse_mha {self.fuse_mha!r}")
        if self.fuse_mlp not in ("auto", "on", "off"):
            raise ValueError(f"unknown fuse_mlp {self.fuse_mlp!r}")
        if self.parity not in ("corrected", "bug_exact"):
            raise ValueError(f"unknown parity {self.parity!r}")
        if self.distill_token and self.parity == "bug_exact":
            raise ValueError(
                "distill_token is a beyond-reference extension; bug_exact "
                "parity reproduces the reference model, which has no "
                "distillation token")
        if self.num_registers < 0:
            raise ValueError(f"num_registers must be >= 0, "
                             f"got {self.num_registers}")
        if self.num_registers and self.parity == "bug_exact":
            raise ValueError(
                "num_registers is a beyond-reference extension; bug_exact "
                "parity reproduces the reference model, which has no "
                "register tokens")
        if self.qk_norm and self.parity == "bug_exact":
            raise ValueError(
                "qk_norm is a beyond-reference extension; bug_exact parity "
                "reproduces the reference model, which has no QK-Norm")
        if self.layerscale_init < 0.0:
            raise ValueError(
                f"layerscale_init must be >= 0, got {self.layerscale_init}")
        if self.layerscale_init and self.parity == "bug_exact":
            raise ValueError(
                "layerscale_init is a beyond-reference extension; bug_exact "
                "parity reproduces the reference model, which has no "
                "LayerScale")
        if not 0.0 <= self.patch_drop < 1.0:
            raise ValueError(
                f"patch_drop must be in [0, 1), got {self.patch_drop}")
        if self.patch_drop and self.parity == "bug_exact":
            raise ValueError(
                "patch_drop is a beyond-reference extension; bug_exact "
                "parity reproduces the reference model, which has no "
                "patch dropout")
        if self.lora_rank < 0:
            raise ValueError(f"lora_rank must be >= 0, got {self.lora_rank}")
        if self.lora_targets not in ("attn", "all"):
            raise ValueError(f"unknown lora_targets {self.lora_targets!r}; "
                             "have 'attn', 'all'")
        if self.lora_rank and self.parity == "bug_exact":
            raise ValueError(
                "lora_rank is a beyond-reference extension; bug_exact "
                "parity reproduces the reference model, which has no "
                "LoRA adapters")
        if self.moe_experts < 0 or self.moe_blocks < 0 or self.moe_slots < 0:
            raise ValueError("moe_experts/moe_blocks/moe_slots must be >= 0")
        if self.moe_blocks and not self.moe_experts:
            raise ValueError("moe_blocks > 0 needs moe_experts > 0")
        if self.moe_experts:
            if self.parity == "bug_exact":
                raise ValueError(
                    "moe_experts is a beyond-reference extension; bug_exact "
                    "parity reproduces the reference model, which has no "
                    "MoE blocks")
            if self.lora_rank:
                raise ValueError("moe_experts + lora_rank is unsupported: "
                                 "LoRA adapters target the dense block "
                                 "weights only")
            if self.moe_blocks > self.depth:
                raise ValueError(
                    f"moe_blocks {self.moe_blocks} exceeds depth {self.depth}")
        if self.tome_r and self.moe_experts:
            raise ValueError(
                "tome_r + moe_experts is unsupported: the ToMe encoder "
                "runs the dense per-block path and has no soft-MoE MLP")
        if isinstance(self.tome_r, (list, tuple)):
            # normalize: JSON round-trips tuples as lists; an all-zero
            # schedule is just "off" (and must not be truthy at call sites)
            sched = tuple(int(r) for r in self.tome_r)
            if len(sched) > self.depth:
                raise ValueError(
                    f"a tome_r schedule has at most one entry per block "
                    f"(depth={self.depth}), got {len(sched)}")
            sched += (0,) * (self.depth - len(sched))  # tail: no merging
            if any(r < 0 for r in sched):
                raise ValueError(f"tome_r schedule entries must be >= 0, "
                                 f"got {sched}")
            object.__setattr__(self, "tome_r",
                               sched if any(sched) else 0)
        elif self.tome_r < 0:
            raise ValueError(f"tome_r must be >= 0, got {self.tome_r}")
        if self.tome_r:
            if self.parity == "bug_exact":
                raise ValueError("tome_r is a beyond-reference extension; "
                                 "bug_exact parity has no token merging")
            if self.qk_norm:
                raise ValueError(
                    "tome_r + qk_norm is unsupported: the ToMe encoder "
                    "(incl. its fused kernel) computes attention without "
                    "the per-head q/k LayerNorm and would silently change "
                    "the model")
            # every merging block needs >= 2*r patch tokens left to split
            # its A/B sets (for constant r this is the paper's
            # r <= N // (depth + 1) bound)
            remaining = self.num_patches
            for l, r in enumerate(self.tome_schedule):
                if r and not r <= remaining // 2:
                    raise ValueError(
                        f"tome_r schedule exhausts the patch tokens: block "
                        f"{l} merges r={r} with {remaining} patches left "
                        f"(needs r <= {remaining // 2})")
                remaining -= r
        if self.tome_train:
            if not self.tome_r:
                raise ValueError("tome_train requires tome_r (a constant "
                                 "or per-block schedule) to be set")
            if self.patch_drop:
                raise ValueError(
                    "tome_train + patch_drop is unsupported: both are "
                    "train-time token-subset mechanisms — pick one")
            if self.distill_token:
                raise ValueError(
                    "tome_train + distill_token is unsupported: the "
                    "distillation step (forward_heads) runs the full-token "
                    "encoder")
    # -- derived --
    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def num_prefix_tokens(self) -> int:
        """Special tokens before the patches: CLS (+ distill token)."""
        return 2 if self.distill_token else 1

    @property
    def pos_len(self) -> int:
        """Tokens carrying positional embeddings: prefix + patches
        (register tokens get none — Darcet et al. 2023 semantics)."""
        return self.num_patches + self.num_prefix_tokens

    @property
    def seq_len(self) -> int:
        """Tokens through the encoder: patches + CLS (+ distill token)
        (+ register tokens at the tail)."""
        return self.num_patches + self.num_prefix_tokens + self.num_registers

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def patch_keep_count(self) -> int:
        """Patch tokens kept per sample under patch_drop (static; the full
        num_patches when patch_drop is 0)."""
        return self.num_patches - int(self.num_patches * self.patch_drop)

    @property
    def tome_schedule(self) -> tuple:
        """Per-block ToMe merge counts, as a depth-length tuple (constant
        ``tome_r`` broadcast; explicit schedules returned as-is)."""
        if isinstance(self.tome_r, tuple):
            return self.tome_r
        return (self.tome_r,) * self.depth

    @property
    def moe_block_count(self) -> int:
        """MoE blocks at the END of the encoder (0 when MoE is off)."""
        if not self.moe_experts:
            return 0
        return self.moe_blocks if self.moe_blocks else self.depth // 2

    @property
    def dense_block_count(self) -> int:
        """Leading dense blocks (== depth when MoE is off)."""
        return self.depth - self.moe_block_count

    @property
    def moe_slot_count(self) -> int:
        """Slots per expert (paper default: total slots ~= seq_len)."""
        if not self.moe_experts:
            return 0
        if self.moe_slots:
            return self.moe_slots
        return max(1, self.seq_len // self.moe_experts)

    @property
    def lora_scale(self) -> float:
        """The adapter scale alpha/rank (alpha defaults to rank -> 1.0)."""
        if not self.lora_rank:
            return 0.0
        alpha = self.lora_alpha if self.lora_alpha else float(self.lora_rank)
        return alpha / self.lora_rank

    @property
    def mlp_dim(self) -> int:
        return self.embed_dim * self.mlp_ratio

    def cdtype(self):
        return _DTYPES[self.compute_dtype]

    def pdtype(self):
        return _DTYPES[self.param_dtype]

    # -- serialization (fulfils the reference's own JSON-config TODO,
    #    train.py:124-125) --
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ViTConfig":
        return cls(**json.loads(s))

    def replace(self, **kw: Any) -> "ViTConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets. The five BASELINE.json benchmark configs plus both hyperparameter
# sets that appear in the reference.
# ---------------------------------------------------------------------------

PRESETS: dict[str, ViTConfig] = {
    # The same presets as vitx/core/config.py (its comments carry the
    # reasons for each knob). BASELINE.json config 1: ViT-Tiny, 64x64.
    "tiny": ViTConfig(
        image_size=64, patch_size=8, num_classes=4,
        embed_dim=64, depth=4, num_heads=4, remat="none",
    ),
    # BASELINE.json config 2: ViT-Small/16 @224.
    "small16": ViTConfig(
        image_size=224, patch_size=16, num_classes=4,
        embed_dim=384, depth=12, num_heads=6,
        remat="none", scan_unroll=12, mlp_act="gelu_tanh",
    ),
    # BASELINE.json configs 3/4: ViT-Base/16 @224 -- the port's main path.
    "base16": ViTConfig(
        image_size=224, patch_size=16, num_classes=1000,
        embed_dim=768, depth=12, num_heads=12,
        remat="none", scan_unroll=12, mlp_act="gelu_tanh",
    ),
    # ViT-Base/16 with 6 heads of D=128: same params and FLOPs as base16.
    "base16_hd128": ViTConfig(
        image_size=224, patch_size=16, num_classes=1000,
        embed_dim=768, depth=12, num_heads=6,
        remat="none", scan_unroll=12, mlp_act="gelu_tanh",
    ),
    # BASELINE.json config 5: ViT-Large/16 @384.
    "large16_384": ViTConfig(
        image_size=384, patch_size=16, num_classes=1000,
        embed_dim=1024, depth=24, num_heads=16,
        mlp_act="gelu_tanh",
    ),
    # ViT-Huge/14 @224 with 10 heads of D=128.
    "huge14": ViTConfig(
        image_size=224, patch_size=14, num_classes=1000,
        embed_dim=1280, depth=32, num_heads=10,
        mlp_act="gelu_tanh",
    ),
    # The reference's train.py __main__ config (train.py:126-139).
    "reference_train": ViTConfig(
        image_size=256, patch_size=16, num_classes=10,
        embed_dim=4, depth=4, num_heads=4,
        mlp_act="relu", dropout=0.2,
        compute_dtype="float32",
    ),
    # The reference notebook config (vit.ipynb cells 17, 26).
    "reference_notebook": ViTConfig(
        image_size=256, patch_size=16, num_classes=10,
        embed_dim=8, depth=8, num_heads=8,
        mlp_act="relu", dropout=0.2,
        compute_dtype="float32",
    ),
}


def get_config(name: str, **overrides: Any) -> ViTConfig:
    """Look up a preset by name, with keyword overrides."""
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg
