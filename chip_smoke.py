#!/usr/bin/env python3
"""Drive the PyTorch port (vitx_torch) on one CUDA card and check it.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; a phase that fails raises and the script exits non-zero:

1. device  -- a CUDA device is present; prints its name and power limit as
              ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. build   -- builds every kernel from the sources in the checkout
              (vitx_torch/kernels/csrc, one nvcc per source, in parallel)
              and counts, per sm90 kernel (SM90_SOURCES: the sm90 GEMM and
              B5's sm90 body as mha_block.cu and mlp_block.cu build them,
              the body at each head width, 32, 64 and 128, with and without
              its KBIAS flag, the probability pass in its
              head-mean (B7's, B5's mean mode) and full (B5's full mode)
              instantiations at each width, B8's, B5's and B2's sm90
              kernels, B2's two at each width), the wgmma
              (HGMMA), TMA (UTMALDG) and wgmma-wait
              instructions in its SASS (cuobjdump -sass); each must have
              wgmma and TMA. B12's multi-leaf kernel must have no wgmma.
              The body without the key bias and the head-mean pass (at
              each width) must be the same instructions in mha_block's
              library as in flash_attention_sm90's.
3. kernels -- K1 (fused MHA block) and K2 (fused MLP block) at ViT-B/16
              shapes, batch 8 and 32, against their plain torch versions
              on the same card: float32 within 1e-4 relative, bfloat16 within
              BF16_TOL (see below), all three activations. K1 and K2 on
              their sm90 route (bf16: the sm90 GEMM, K1's attention on B5's
              sm90 body) with every stash output (q, k, v, o_all, the
              attention's statistics, hp) at base16 b8, a ragged M (3 x
              197), tiny's widths, large16_384's and the small16 recipe's
              (b128 and a ragged 3 x 197: E 384, 6 heads, M 1536, QKV N
              1152 and N 384 against 256-wide tiles), launches_sm90 one a
              call, twice bit for bit, and the earlier route (gemm_kernel,
              attention_fwd.cuh) on the same inputs; B7 and B8 on both
              routes likewise (B7 in bf16 at D 32, 64 and 128 on the sm90
              attention and its head-mean pass, launches_attn_sm90 one a
              call, its out
              bit-equal to K1's on K1's full route, its probabilities within
              PROBS_BF16_TOL of the plain version's). B5 (attention
              forward) in its three modes at (2, 16, 577, 64), (2, 12, 197,
              64) and (1, 16, 1100, 64) -- without probs in bf16 its sm90
              kernel, with the row statistics it writes for the backward
              (STATS_TOL), twice bit for bit, and the earlier kernel on
              the same inputs; in bf16 its two probability modes on the
              sm90 route (the body, then the probability pass), also at
              a ragged (2, 4, 65, 64), (2, 4, 65, 128) and (2, 4, 65,
              32), at MAE's decoder's width (8, 16, 197, 32) and, the
              head mean, at the rollout's (32, 16, 577, 64): o within
              BF16_TOL and
              bit-equal to the no-probs sm90 o, the probabilities within
              PROBS_BF16_TOL, launches_sm90 one a call, twice bit for
              bit, the full mode's head mean within HEAD_MEAN_TOL of the
              mean mode's, and the earlier kernel on the same inputs;
              B7 (block with head-mean probs),
              K1 and K2 (gelu_tanh) at large16_384 block shapes, batch 2
              and 8, float32 and bfloat16, and in bfloat16 at huge14's
              (8, 257, 1280), 10 heads, and base16_hd128's (8, 197, 768),
              6 heads, both D 128; B5's head mean and B7 twice,
              bit for bit; probability rows summing to 1 within 1e-5.
              B8 (the ToMe block, with a random QKV bias and log_size in
              [0, log 40]) against its plain version at the base16 r=13
              server's blocks (32, 197) first, (32, 119) and (32, 54)
              last, and at (8, 197), (8, 41), (2, 13); at large16_384's
              (8, 577), (8, 416), B9's range, and (8, 48), the last r=23
              block: float32 1e-4, bfloat16 BF16_TOL -- in bf16 on the
              sm90 attention (launches_attn_sm90 one a call), and on its
              GEMM-only route (the sm90 GEMM with attention_fwd.cuh) and
              the earlier kernels on the same inputs; k_mean twice, bit for
              bit; with zero biases its out equal to K1's on K1's full
              route, bit for bit.
              K2 at the r=13 server's first and last MLP shapes,
              (32, 184) and (32, 41). B10 (fused_layer_norm and
              fused_add_layer_norm) against their plain version at E
              64, 100, 768, 1024, 3072 and R 1, 394, 50432 rows, float32
              1e-4 and bfloat16 BF16_TOL, on the one-pass route where
              ln_fwd_route gives it (launches_onepass one a call) and the
              earlier kernel on the same inputs; the add variant's sum
              equal to x + r bit for bit; each twice, bit for bit.
              The sm90 attention at head widths 32 and 128 (bf16): B5
              without probs at huge14's (8, 10, 257, 128) and MAE's
              decoder's (128, 16, 197, 32), o and its row statistics
              against plain, twice bit for bit, the earlier kernel beside
              it, and at (8, 10, 257, 128) its probability modes on the
              sm90 route as above; B2 at the same shapes and at B6's
              (4, 10, 1025, 128), twice bit for bit, with strided do, o
              and dqkv, the earlier kernel beside it; K1 with its stash
              (K1's attention on the sm90 body, launches_attn_sm90 one a
              call) at huge14's (32, 257, 1280) and MAE's decoder's (128,
              197, 512); B8 at base16_hd128's (8, 197, 768), 6 heads of D
              128, and at MAE's decoder width (8, 197, 512), 16 heads of
              D 32.
4. grad    -- the training kernels at ViT-B/16 shapes (T 197) against
              their plain versions: batch 8 in float32 (1e-4) and bfloat16,
              and the train main path's batch 128 in bfloat16, and the
              small16 recipe's (128, 197, 384), 6 heads, in bfloat16: B2
              (attention backward), B3 (LayerNorm backward at E 768 and the
              head's 3072, at E 384 and 1536, on its one-pass route, twice
              bit for bit, and its
              earlier kernel on the same inputs), the K1 and K2 stashes, and
              torch.autograd.grad
              through both fused blocks on the card against the plain
              versions' on the CPU (batches up to 8; larger ones against
              the plain versions' on the card); B12 (AdamW) bit for bit against its
              plain version: the one-leaf kernel on a base16 leaf, the
              multi-leaf kernel over every base16 leaf (one launch) and
              over ragged views at element offsets 0-2 with fp32 and bf16
              gradients (one launch per dtype). B2 is
              given the forward's o and row statistics and called twice,
              bit for bit; in bf16 at D 64 that is its sm90 kernel, also
              on do and o in the fused block's (B, T, H, D) layouts
              writing into one (B, T, 3, H, D) buffer, bit for bit, and
              the earlier kernel is held on the same inputs. B2 and B3
              also at Grad-CAM's large16_384 shapes (T 577, E 1024 and the
              head's 4096), batch 1 and 8, float32 and bfloat16. Past T =
              1024, where vitx runs its q-chunked backward B6: the
              stashes, B2, B3 and autograd through both blocks at (2,
              1025, 768), float32 and bfloat16, and at the fine-tune main
              path's own (32, 1025, 768) in bfloat16; B2 at (1, 16, 1100,
              64), (1, 12, 2048, 64) and, in float32, (32, 12, 1025, 64);
              the fused_layer_norm entries' backward (B11, through B3)
              against ln_bwd_plain on the 2-D view at (2, 1025, 768) and
              (256, 197, 768); float32 and bfloat16. B8 under grad as the
              recipe's ToMe-train step runs it (the kernel forward,
              composed_tome's backward with B3 for its LayerNorm; x and
              the weights requiring grad, the zero QKV bias and log_size
              not, k_mean's cotangent zero) at (128, 197, 384) and
              (128, 162, 384), 6 heads: in bf16 against composed_tome's
              autograd on the card (GRAD_BF16_TOL), in float32 against
              the CPU (1e-4); one B8 and one B3 launch a call.
5. forward -- the base16 forward (depth 12, bf16) at batch 8 on the card
              against the port's plain forward on the CPU with the same
              weights (relative error < 0.05 on the logits); exactly 12 K1
              and 12 K2 launches per forward, all on the sm90 route.
6. serve   -- main path 1: an InferenceServer for base16 at batch 32
              answers 64 requests from 8 threads; each top-k must equal a
              direct forward of the same images at the same batch shape.
7. train   -- (a) base16 at depth 2, batch 4, float32: one train_step on
              the card against the same step on the CPU from the same
              params (loss, grad_norm and gradients within 1e-4; each
              param within 1e-4 lr of the gap its gradient's error
              allows). (b) main path 2: full base16 in bf16 at batch 128
              on SyntheticDataset batches: 20 train_steps with
              make_optimizer(lr=1e-4), then 5 with fused=True, on one
              repeated batch; the loss must be finite and fall, the
              launches per step must be K1 12 (all on its sm90 route),
              B2 12 (all on its sm90 route), B3 25 (all on its one-pass
              route), K2 0 and B12's
              multi-leaf kernel one per fused step and gradient dtype
              (its one-leaf kernel 0); one eval_step.
8. explain -- main path 3, large16_384 (ViT-L/16 at 384², T 577) at full
              width and depth, bf16, random weights from seed 0: (a)
              forward_with_rollout at batch 8 on the kernels against the
              same call with attn_impl="reference", fuse_mha="off",
              fuse_mlp="off" (no kernel) on the card: logits and rollout
              weights within 0.05, launches B7 24 (all on its sm90
              attention), K2 24, K1 0, B5 0;
              grad_cam at batch 8 against the same route (heatmap and
              logits within GRADCAM_TOL; that route's only launches are
              B3's LayerNorm backwards); (b) forward_with_attn(
              probs_mode="full") at batch 2: B5 24 (its sm90 route 24),
              K2 24, logits and probs against the same reference route
              (no launches);
              (b') with fuse_mha="off" at batch 8: the forward (B5 without
              probs in every block, on its sm90 route) and Grad-CAM
              through it (B5's sm90 forward with its statistics, B2's
              sm90 backward) against the reference route;
              (e) the model with QKV biases (a random bias from seed 0)
              at batch 8: forward_with_rollout and forward_with_attn(
              probs_mode="mean") through the composed block in every
              layer against the reference route (EXPLAIN_TOL), launches
              B5's head mean 24 (its sm90 route 24), K2 24, K1 0, B7 0;
              (c) a depth-2 float32 copy, card against CPU (1e-4):
              rollout, Grad-CAM, and with fuse_mha="off" the forward (B5
              without probs) and forward_with_attn("mean") (B5 head
              mean); (d) an InferenceServer with its HTTP front end
              answering 16 /explain requests (rollout and gradcam, with
              and without class) from 4 threads, then 3 of each method
              one at a time (service time alone), each equal to a direct
              call, with the launches Grad-CAM's routing gives.
9. tome    -- main path 4, ToMe token merging at full width and depth,
              random weights from seed 0: (a) base16 tome_r=13 at batch
              8, bf16, on the kernels: finite logits, launches B8 12 (its
              sm90 attention 12), K2 12, nothing else; reported, not held
              to a bar: the logits' distance from the kernel-free route
              (fuse_mha="off", fuse_mlp="off") and how many images the two
              routes partition alike (bf16 rounding tips near-tie merges);
              (a')
              the same model in float32 at batch 2, card against the
              CPU's plain versions: logits 1e-4, the merges' sources
              equal; (b) lossless: base16 fp32 batch 2, a constant image
              and zero pos_embed, ToMe logits equal to full-token logits
              within 1e-4; (c), (c') large16_384 tome_r=23 as (a), (a'),
              B8 24 (sm90 attention 24), K2 24; (d) a depth-2 fp32 large16_384 copy with a
              random QKV bias at tome_r=(65, 64) as (a'); (e) an
              InferenceServer for base16 tome_r=13 at batch 32 answering
              64 requests from 8 threads, each top-k equal to a direct
              ToMe forward.
10. finetune -- main path 5, ViT-B/16 fine-tuned at 512² (T 1025): (a)
              a seed-0 base16 224² export (the .npz --export-vit writes)
              read into the 512² config on the card and on the CPU, its
              positional grid resized (1e-6); (b) its first two blocks
              in float32, batch 2: one train_step card vs CPU as train
              (a), the param element that sets param_gap's worst named
              in worst_at; (c) the main path: full base16 at 512² in bf16,
              batch 32 on SyntheticDataset(image_size=512) batches, 10 steps
              on one repeated batch, the loss finite and falling, the
              launches per step K1 12, B2 12 (sm90 12), B3 25, K2 0; one
              eval_step; (d) fused_add_layer_norm then fused_layer_norm
              at the fine-tune's tokens with their gradients, against
              the plain version, launches B10 1 + 1, B3 2.
11. recipe -- main paths 6-8, CONVERGENCE.md's ViT-S/16 recipe and its
              two variants: (a) small16 at depth 2 in float32, card vs CPU
              from the same params: the first step as train (a) (gradients
              1e-4, params within param_gap's allowance), then two epochs
              of Trainer (cosine, EMA, wd_exclude, clipping, no
              augmentation): every step's loss and grad_norm within 1e-4,
              val accuracies equal, the params and the EMA within
              RECIPE_PARAM_BAR (0.05) of the peak lr; (b) the recipe at small16's full
              width and depth (bf16, b128) through
              vitx_torch.cli.train.main on procedural:1024,256 with
              --device-cache --randaug 5 --ema-decay 0.999 --wd-exclude
              --early-stop 10 --schedule cosine, 3 epochs; cut to size:
              the split (1024 + 256, not 12800 + 2560), --warmup-steps 10
              (not 300), --log-every 4, 3 epochs. Launches asserted: per
              step K1 12, B2 12 (all sm90), B3 25 (all one-pass), K2 0,
              B12 0; per eval batch K1 12 and K2 12 (sm90); finite losses
              whose last 4 fall below the first 4; three .ckpt files whose
              meta names ema_decay and the schedule. (c) the CLI's 3-epoch
              trainer stopped after 2 epochs (its cosine's horizon is
              --epochs x the epoch's steps), then a call with --epochs 3
              on the same directory: its last checkpoint equal to (b)'s
              bit for bit. (d) vitx_torch.cli.eval on (b)'s
              directory reports exactly the val accuracy the trainer
              logged. (e) load_server on (b)'s last .ckpt (the EMA shadow)
              answers 32 requests from 4 threads, top-1 equal to direct
              forwards on the EMA params, launches as a forward's. (f)
              times beside nvidia-smi's name and power limit: img/s per
              epoch, the preprocessing's share of a step (CUDA events
              around preprocess and train_step over an epoch), the
              profiler's device busy share over the next epoch, launches
              a step, eval img/s. (g) ToMe-train (--tome-r to128
              --tome-train: (35, 34)) and (h) patch drop (--patch-drop
              0.5: T 99), the flags of examples/convergence.py's VARIANTS,
              each first as (a) at depth 2 (g: the merges' sources equal
              on the first batch; h: the noise drawn alike on both
              devices), then through vitx_torch.cli.train.main as (b),
              3 epochs. Launches asserted: (g) per step B8 12 (sm90 and
              sm90 attention 12), B3 25, K1, B2, K2, B12 0, per (merged)
              eval batch B8 12 and K2 12; (h) as (b). Losses fall; the
              .ckpt meta names the variant. (g) only: vitx_torch.cli.eval
              on its .ckpt runs every token by default (K1 and K2 12 a
              batch), its accuracy equal to direct eval_step calls, and
              with --tome-r to128 merges (B8 and K2 12 a batch), its
              accuracy the one the trainer logged; a server from the
              .ckpt as (e). Then each variant's times as (f).
12. transfer -- main path 7, training and transfer fine-tuning on image
              data from disk: (a) a CIFAR-10 copy in the torchvision
              layout (5 x 256 + 256 seeded images, each class a colour
              behind the noise) trains base16 at 224² (the pipeline
              resizes 32²) bf16 b128 for one epoch through
              vitx_torch.cli.train.main --data cifar10:DIR, launches as
              the recipe's (K1 12, B2 12, B3 25 a step; K1 and K2 12 an
              eval batch); (b) vitx_torch.cli.pack --data
              procedural:256,64 --format raw --image-size 384 (10
              classes), and write_shards of its first 4 classes (no PIL);
              (c) the train CLI's trainer (build_trainer) fine-tunes
              base16 at 384² (T 577) b32 from (a)'s .ckpt (--init-from,
              transfer_params) for one epoch on each: every grafted leaf
              bit-equal to the source's, pos_embed within 1e-6 of
              resize_pos_embed of its table on the CPU, no leaf fresh on
              the 10-class shards and exactly the head's class-sized
              leaves on the 4-class ones, finite losses, launches a step
              K1 12, B2 12 (sm90), B3 25 (one-pass), B12 0; (d) the same
              transfer on the card and on the CPU, then its first step at
              depth 2 fp32, card vs CPU, as train (a); (e)
              vitx_torch.cli.eval on (c)'s .ckpt equals the logged
              accuracy, and on one shard directory counts the classes
              split_indices gives; (f) (c)'s params through a reference
              .pt: load_reference_pt bit-equal, cli.eval --predict and a
              server's top-1 equal to direct calls, --init-from the .pt
              equal to transfer_params; (g) a Training/Testing folder of
              256 + 64 256² PNG images in 4 classes (the brain-tumour
              layout) fine-tuned as (c) on --data folder:DIR (PIL decodes
              and resizes to 384² on the host), the eval CLI's accuracy
              the logged one. The times phase adds (h): the fine-tune
              step at 384² b32, the loader alone (raw shards, the CIFAR
              copy, the PNG folder; 8 threads), the host's cores; each
              source's epochs through Trainer.fit, in a process of their
              own started after the kernel rows, on two routes in turns --
              prefetch (the trainer's device_prefetch: pinned copies on a
              copy stream) and sync (a pageable upload on the step's
              stream as the loop reaches the batch); the raw shards over a
              window of 64 steps (their 256 images read 8 times; 16 under
              the profiler), with a host read every step and with one
              every 64: img/s, the fill (the time to the first batch) and
              the steady img/s after it, one batch's placement by each
              route, the busy share and the host-to-device copies by stream,
              with the ms a kernel of another stream overlapped (the
              prefetched copies must not be on the step's stream), the
              pinned pool after each prefetched epoch; a prefetched epoch
              of the raw shards
              and the same epoch from the same state by this script's
              loop over Trainer._step with a pageable upload end with
              params equal bit for bit; and K1 with its stash, B2 and B3
              at T 577 as more "shapes" of their rows.
13. pretrained -- main path 10, fine-tuning from public pretrained ViTs
              on the CIFAR-10 copy (5 x 128 + 128 images): (a) timm,
              HF and DeiT-distilled ViT-B/16 state dicts drawn from a
              seed, imported (QKV biases, erf GELU, eps 1e-6 / 1e-12, T
              197 / 198) and run at b64: bf16 (B5 and K2 12 each)
              against the CPU's fp32 forward on two rows, fp32 against a
              module-by-module timm / HF ViT in torch.nn; a base16 .ckpt
              trained one epoch at b128 through cli.train.main; (b) LoRA
              rank 8 from it at b128 (K1 12, B2 12, B3 24 a step: the
              first block's LN1 asks for no gradient) and from the timm
              import via --config-json (B5 for K1); (c) --llrd 0.65
              --accum-steps 2 --mixup-alpha 0.8 --cutmix-alpha 1.0 at b64
              micro-batches, and --freeze-backbone at b128 (K1 without
              its stash, B3 1 a step), a frozen step timed beside a full
              one; (d) small16 with the distillation token (T 198) at
              b128 from the base16 .ckpt, soft and hard (the teacher's K1
              and K2, the student's with their stashes, B2, B3 26 a
              step); every run two epochs through build_trainer, its
              launches asserted and printed a step, its losses finite and
              falling, frozen leaves bit-unchanged and the rest moved;
              the depth-2 fp32 copies of (b)-(d), card vs CPU, as train
              (a) (the distillation's with B12 on the card); (e) the eval
              CLI and a server on the LoRA (merged) and distill-token
              .ckpts, top-1 equal to direct calls, the merged LoRA
              forward within BF16_TOL of the adapted; (f) csrc/vitc.c and
              trainc.c built with gcc: the port's fp32 tiny forward on
              the card within 1e-4 of vitc's, one train step of
              trainc's case within its test's bars.
14. families -- main path 11, vitx's other model families: (a) the conv
              stem, 4 registers, the MAP head, sincos2d, RoPE, Soft-MoE
              (2 experts over the last block) and registers + MAP +
              sincos2d, each at base16's width, depth 2, fp32, batch 4:
              the forward and one train step card vs CPU as train (a);
              (b) vitx's bench 10, base16 with Soft-MoE blocks (8
              experts over the last 6, 24 slots an expert, 290.4 M
              params) in bf16: the forward's launches (K1 12, K2 6, all
              sm90), its b4 logits against the CPU's plain forward
              (EXPLAIN_TOL), the forward at b256 (CUDA events, median of
              10) and the fused train step at b128 (median of 5 after 1
              warm-up; K1 12, B2 12, B3 25, B12 1 a step), the step's
              profiler split and the mixtures' share of it (one MoE
              block's mixture forward and backward, CUDA events, times
              6); (c) the other families at base16's width and depth,
              bf16 b32: the forward on the kernels against the
              kernel-free route on the card (EXPLAIN_TOL; K1 12 -- B5 12
              for RoPE -- and K2 12), and RoPE's train step (B5 12, B2
              12, B3 25); (d) the train CLI at small16 on
              procedural:512,128, 2 epochs at b128: --moe-experts 8
              --moe-blocks 6 and --num-registers 4 --head-type map
              --pos-embed sincos2d, launches exact, losses falling; the
              eval CLI on each .ckpt equal to the trainer's accuracy; the
              MoE model's .quant.npz and .pt2 (from eval
              --export-quantized / --export-pt2) within 2e-2 of its
              eager forward with equal top-1, and a server on its .ckpt
              as recipe (e); eval --patch-size 8 on the patch-16
              registers model equal to direct calls on
              resize_patch_embed's params at 112²; (e) rollout and
              Grad-CAM at b8 on (b)'s MoE model and (c)'s registers
              model against the kernel-free route (EXPLAIN_TOL,
              GRADCAM_TOL), launches exact. Its launches, (b) to (e), are
              the kernels line's "families" path.
15. optim  -- main path 12, vitx's remaining training knobs: (a) base16
              at depth 2, fp32, batch 4: SGD, Lion, Adafactor, AdamW with
              a bf16 first moment, SAM (rho 0.05), the multi-label BCE
              loss on SyntheticMultiLabelDataset batches and class-weighted
              CE, three steps each on the card and on the CPU from the
              same state: loss and grad_norm within FP32_TOL, the
              gradients the optimizer was fed within FP32_TOL, the first
              step's params within param_gap's allowance (Adafactor's
              aside) and every step's within 1e-4 lr, 1e-6 of the update
              and an ulp of the CPU's update of the card's gradients
              (replay_gap); each remat mode with dropout and
              drop-path 0.1 from a card generator against "none" (1e-6;
              bit for bit said), then without dropout one step card vs
              CPU; (b) base16 bf16 at b128, one step of AdamW (B12),
              AdamW with a bf16 first moment, SGD, Lion, Adafactor, SAM,
              BCE and remat block, dots and save_stash: the median of 5
              after a warm-up by CUDA events, launches exact (K1 12, 24
              under block and dots; B2 12 and B3 25, twice under SAM; B12
              1 on fused AdamW, else 0) and the peak memory per remat
              mode (block and save_stash below none); (c) the CLIs:
              small16 train --optimizer adafactor --steps-per-dispatch 4
              with profile_epoch 0, its trace holding K1's and B2's sm90
              kernels; tiny train --data synthetic-ml --loss bce, eval on
              it (its mAP the trainer's), eval --soup of it and a nudged
              copy (the report of their averaged params);
              tune --mode train --remat none,block,save_stash at base16
              b64; bench 1 with its dispatch rows k 1, 4, 16 (16
              iterations, 2 repeats). Launches of
              (b) and (c) exact; they are the kernels line's "optim"
              path.
16. pretrain -- main path 13, vitx's self-supervised pretraining (MAE,
              DINO, SimCLR; every block K1 and K2 with their stashes under
              grad, B2, B3): (a) each family at base16's widths, depth 2
              (MAE's decoder 512 x 2 x 16: D 32), fp32, batch 4 (DINO 2
              images, 2 locals), card vs CPU from the same state with the
              same draws: loss, monitors and every gradient within 1e-4,
              one step's params within param_gap's allowance, DINO's
              teacher and centre, its prototypes frozen and pinned; (b)
              each at full width in bf16 (MAE b128 with the 512 x 8 x 16
              decoder, DINO b32 with 2 x 224² + 6 x 96² views and 4096
              prototypes, SimCLR b128): the loss on its first rows (8, 4,
              8) against the CPU's fp32 at the same weights (0.05), ten
              steps on one batch with the same draws (MAE's and SimCLR's
              losses fall, DINO's finite with the teacher's entropy in (0,
              log K]), six more, the median of the last 5 by CUDA events,
              the peak memory of a fresh state's step, launches exact (a
              step: MAE K1 and K2 20, B2 20, B3 42; DINO K1 and K2 36,
              the teacher's 12 without stash, B2 24, B3 50; SimCLR K1
              and K2 12, B2 12, B3 25; every K1 and B2 on the sm90
              attention, MAE's decoder's at D 32 too); (c) K1 with
              its stash, K2 with its stash, B2 and B3 at MAE's decoder
              (128, 197, 512), 16 heads of D 32 (the sm90 GEMM with the
              sm90 attention, B2's sm90 kernel), K1 with its stash, B2 (its
              sm90 kernel in bf16) and B3 at MAE's visible tokens (128,
              50, 768) and DINO's locals (192, 37, 768), against their
              plain versions in fp32 (1e-4) and bf16 (BF16_TOL), each
              twice bit for bit, then their times as more "shapes" of the
              kernels line's rows; (d) cli.pretrain on tiny
              (procedural:256,64, b64) for each method, 2 epochs then a
              resume to 3, launches exact, the export equal to the last
              .ckpt's encoder (the teacher's for DINO); cli.train
              --init-from the MAE export for an epoch (launches exact) and
              cli.probe on it. Its launches, (b) and (d), are the kernels
              line's "pretrain" path.
17. parallel -- main path 14, data, ZeRO, tensor, sequence and expert
              parallelism (vitx_torch.parallel) in rank processes that
              share the card (gloo, by the backend rule, printed): (a) at
              base16's widths, depth 2, fp32, b8 global: dp2, zero1,
              zero2, zero3, tp2 with sp and ep2 (8 experts over the last
              block), each one step on two ranks against one process on
              the CPU from the same weights: loss, grad_norm and every
              reduced gradient within FP32_TOL, the params within
              param_gap's allowance; (b) at full width in bf16, b128
              global, fused AdamW: the same six runs (ep2 on bench 10's
              Soft-MoE ViT-B), one warm-up and 3 steps on one batch: the
              first step's loss and grad_norm within PARALLEL_TOL of one
              process's step on the card, the losses falling, each rank's
              step ms (host clock around synchronised steps, median of 3)
              and peak memory beside one process's, launches exact in
              every rank (K1 12, B2 12, B3 25, B12 1 a step; B5 in K1's
              place under tp, the composed path as vitx); (c) K1 and K2
              with their stashes, B2 and B3 at a dp 2 rank's (64, 197,
              768) and an MAE rank's (64, 50, 768) in fp32 and bf16, and
              B12 over rank 0's ZeRO-1 slices of base16, against their
              plain versions, each twice bit for bit, then their times as
              more "shapes" of the kernels line's rows; (d) nccl with one
              rank (a card of its own): its dp 1 step of the depth-2 bf16
              copy bit for bit one process's; (e) python -m
              vitx_torch.parallel.dryrun 4 on the card, its line with
              vitx's pipeline keys (GPipe and 1F1B at 2 data x 2 stage;
              pp x tp, which takes 8 ranks, nan as vitx prints it), run
              after (c) beside (a)'s and (b)'s checks and (d), which time
              nothing. Rank
              0's launches of (b) are the kernels line's "parallel" path.
18. pipeline -- main path 15, pipeline parallelism (GPipe and 1F1B,
              vitx_torch.parallel.pipeline) in rank processes that share
              the card (gloo): first a probe of dist.send/recv on CUDA
              tensors in two ranks of its own, printed (the handoff is
              a broadcast over the link's two-rank group on every
              backend, whatever it prints); (a) at base16's widths, depth 2, fp32, b8 global in
              2 microbatches a data row, on four ranks: GPipe and 1F1B on
              (2 data x 2 stage), 1F1B on (1 data x 2 stage x 2 model),
              each one step against one process on the CPU from the same
              weights: loss, grad_norm and every reduced gradient within
              FP32_TOL (the prediction, 5e-6, printed beside), the params
              within param_gap's allowance, B5 launched in every pp x tp
              rank (its local heads: T 197, D 64, vitx's rule); (b) at
              full width in bf16 (depth 12, 6 + 6 blocks), b128 global in
              4 microbatches of 32 on (1 data x 2 stage), fused AdamW:
              GPipe, then 1F1B, one warm-up and 3 steps on one batch: the
              first step's loss and grad_norm within PARALLEL_TOL of one
              process's step on the card, each rank's step ms (host clock
              around synchronised steps, median of 3), peak memory and
              held stage inputs, launches exact in each rank (K1 and K2
              with their stashes 24, B2 24, B3 48 and the head's 4 on the
              last stage, B12 1 a step; 1F1B's stage 0 K1 and K2 24 more
              without stash); (c) K1 with and without its stash, K2 with
              its stash, B2 and B3 at a microbatch's (32, 197, 768) in bf16
              and B5 at pp x tp's local heads (32, 6, 197, 64) bf16 and
              (4, 6, 197, 64) fp32, B12 over a (b) rank's update leaves
              (6 of the 12 blocks, the other leaves whole; fp32 and bf16
              gradients), against their plain versions, each
              twice bit for bit, then their times as more "shapes" of the
              kernels line's rows; (d) python -m vitx_torch.cli.serve
              --preset base16 --dp 2 (batch 8): two ranks answer six
              requests over HTTP with a direct forward's top-1, and stop
              on SIGINT. (b)'s launches, both ranks', are the kernels
              line's "pipeline" path.
19. compose -- main path 16, the last compositions: ToMe's merging
              encoder on a tensor-parallel mesh (its split route, and B8
              and K2 over gathered weights) and fused blocks (K1, K2)
              under sequence and expert parallelism, in rank processes
              that share the card (gloo): (a) at base16's widths, depth
              2, fp32, b8 global, one step each against one process on
              the CPU from the same weights (loss, grad_norm and every
              reduced gradient within FP32_TOL, the params within
              param_gap's allowance): tp2 ToMe-train r=13 split and with
              fuse_mha = fuse_mlp = "on", tp2 + sp with both "on" (two
              ranks), tp2 x ep2 with fuse_mha "on" on the Soft-MoE copy
              (four ranks); (b) at full width in bf16, one warm-up and 3
              calls each: the base16 r=13 eval at b64 on tp2 by the split
              route (no kernel: vitx's XLA route) and the gathered one
              (B8 and K2 12 a call), the ToMe-train step at b32 on tp2
              with fuse_mha "on" (B8 12, B3 25, B12 1 a step), base16 at
              tp2 + sp with both "on" at b32 (K1 and K2 with their
              stashes 12, B2 12, B3 25, B12 1) and bench 10's Soft-MoE
              ViT-B at tp2 x ep2 with fuse_mha "on" at b32 (K1 12, B2 12,
              B3 25, B12 1): the first loss (and grad_norm) within
              PARALLEL_TOL of one process's on the card, launches exact in
              every rank, the eval's merges bit for bit the same on every
              rank, each rank's call ms and peak memory (a shared card,
              not scaling); (c) B8 at merged lengths (32, 184, 768) and
              (32, 54, 768), K1 and K2 with their stashes at a tp + sp
              rank's gathered (32, 197, 768), against their plain
              versions in bf16, each twice bit for bit, then their times
              as more "shapes" of the kernels line's rows. Every rank's
              launches of (b) are the kernels line's "compose" path.
20. artifacts -- main path 8, the model shipped (base16 bf16 at full
              width): (a) an int8 .quant.npz of the params, about 1/4 of
              their fp32 bytes, quantization_error at most 1/254, a
              server on it answering 32 requests with the top-1 of direct
              forwards on the dequantized params; (b) a symbolic-batch
              torch.export program made on the card, saved, loaded and
              called at batch 1, 8 and 256: K1 and K2 12 launches each a
              call (all sm90), logits within BF16_TOL of the eager forward
              with equal top-1, b256 timed against eager in turns; (c) a
              ToMe r=13 program pinned at b32: B8 and K2 12 a call; (d) a
              QKV-bias program: B5 12 a call (sm90), K2 12; (e) a .pt2
              server, top-1 equal to direct forwards, /explain refused;
              (f) depth 2 fp32, card vs CPU: forward_features (both pools)
              within 1e-4 and the probe CLI on a .quant.npz over
              procedural:128,64, reports and features alike. Its
              launches are the kernels line's "export" path.
21. bench  -- main path 9, vitx's bench configurations on the card: K1
              (with and without its stash), K2, B2 and B3 at huge14's
              shapes (E 1280, 10 heads of D 128: the sm90 GEMM and the
              sm90 attention at D 128) held to their plain versions in
              bf16, then vitx_torch.cli.bench configs 3, 7 and 13 (the
              last the "huge14" path: its launches asserted), the
              "huge14_explain" path at full depth (launches asserted):
              forward_with_rollout at b8, B7 on the sm90 attention and
              its head-mean pass at D 128 in all 32 blocks,
              forward_with_attn("full") at b2, B5's full mode on its sm90
              route, and a server's /explain?method=rollout, 4 requests
              equal to direct calls; the rollout's rows summing to 1,
              within EXPLAIN_TOL of B7 on its GEMM-only route and, at
              depth 2, of the CPU's fp32 forward, the attention maps
              within EXPLAIN_TOL of the earlier kernel's, the rollout on
              both routes timed in turns and profiled; bench 13's
              forward b32 and train step b8 under the profiler, split
              by kernel, then
              vitx_torch.cli.tune --mode infer on base16 at 64, 128 and
              256 with no error row.
22. times  -- CUDA-event medians: the base16 forward at batch 256 bf16
              (img/s), the train step at batch 128 bf16 (img/s), the
              large16_384 rollout forward at batch 32 bf16 (img/s), the
              same with QKV biases and forward_with_attn("full") at
              batch 2 (these two also with B5's probability modes on the
              earlier kernel, in turns, as was_ms_runs), the ToMe forward at
              base16 b256 (r=13 and (35, 34)) and large16_384 b32 (r=23
              and (65, 64 x 6)), each with a torch.profiler split (ToMe:
              r=13 and r=23); for each kernel its time, its bound, its
              plain version's time and one PyTorch library call of the
              same function where there is one, at the shapes of those
              paths (B8 at base16's first and last r=13 blocks, and at
              large16_384's T 577 and 416, where vitx takes B9); the
              fine-tune step at batch 32 (img/s, profiler split), B2 at
              its (32, 12, 1025, 64), B6's range, B3 at (32, 1025, 768) and
              on the 2-D view of base16's b256 tokens, B11's function (each
              under its row's "shapes"), and B10's rows there. B3 and
              B10's two variants have two rows each: *_onepass, the
              wrapper's one-pass route, with the earlier kernel's time of
              the same call as was_ms, and the plain name, that earlier
              kernel through its launcher (route 0). B5's probability
              modes likewise: *_sm90 the wrapper's sm90 route, the plain
              name the earlier kernel (_launch_probs(route=0)). B7's sm90
              row carries its GEMM-only route (the sm90 GEMM with
              attention_fwd.cuh) as was_ms. B2, B5 without
              probs, K1, K2, B7 and B8 have two rows each: the sm90 route
              (attention_bwd_sm90, flash_attention_sm90,
              fused_mha_block_sm90, ...; the blocks' sm90 rows carry the
              earlier route's time of the same call as was_ms, B8's that of
              its GEMM-only route, the sm90 GEMM with attention_fwd.cuh)
              and the earlier kernel on the same bf16 inputs through its
              launcher
              (attention_bwd, flash_attention, fused_mha_block, ...),
              which the wrappers keep for fp32 and shapes the sm90 route
              cannot take. B12 has two rows over every leaf of the base16
              state: fused_adamw_, a launch per leaf, and
              fused_adamw_multi_, the train step's one launch, with the
              former's time as was_ms. After the recipe, the rows take
              more "shapes" at its variants' own: B8 at the ToMe-train
              step's (128, 197, 384), K1 with its stash (the sm90 row) and
              B2 at the patch-drop step's T 99 (small16, 6 heads); and a
              block's attention half under grad at (128, 197) and (128,
              128): B8 with its composed backward against K1 with its
              stash then B2 and B3, forward and backward apart. After the
              bench phase, K1's and K2's rows at huge14's (32, 257, 1280)
              (K1's sm90 row with its GEMM-only route, the sm90 GEMM with
              attention_fwd.cuh, as was_ms), B2's two rows at (8, 10, 257,
              128) and B6's range (4, 10, 1025, 128), B5's two at (32, 10,
              257, 128), B8's at base16_hd128's (32, 197, 768) and B3's at
              (8, 257, 1280), B5's probability modes at (2, 10, 257, 128)
              (full) and (8, 10, 257, 128) (mean) and B7's two rows at
              huge14's rollout (8, 257, 1280) and base16_hd128's (32,
              197, 768), as more "shapes"; and the pretrain phase's
              (c): K1's sm90 row at (128, 197, 512) (D 32, was_ms its
              GEMM-only route), (128, 50, 768) and (192, 37, 768), K2's at
              (128, 197, 512), M 2048, B2's two rows and B5's two at (128,
              16, 197, 32), B2's sm90 row at
              (128, 12, 50, 64) and (192, 12, 37, 64), and B3's one-pass
              row at (128, 197, 512) and (128, 50, 768); and the parallel
              phase's (c): K1's sm90 row at a dp 2 rank's (64, 197, 768),
              B2's sm90 row at (64, 12, 197, 64), B3's one-pass row at
              (64, 197, 768) and B12's multi-leaf row over rank 0's ZeRO-1
              slices of base16 (45.6 M elements); and the pipeline phase's
              (c): K1's sm90 row with and without its stash and K2's with
              its stash at a microbatch's (32, 197, 768), B2's sm90 row at
              (32, 12, 197, 64), B3's one-pass row at (32, 197, 768) and
              B5's sm90 row at pp x tp's (32, 6, 197, 64); and the compose
              phase's (c): B8's two rows at the merged (32, 184, 768) and
              (32, 54, 768), K1's and K2's sm90 rows with their stashes
              at a tp + sp rank's gathered (32, 197, 768).

Each main path runs with the kernels' launch counts set to 0 just before
it and read just after. ``attention_bwd``, ``flash_attention`` and the
blocks' rows count every launch of their wrappers; ``attention_bwd_sm90``,
``flash_attention_sm90`` and the blocks' ``*_sm90`` rows read the
wrappers' ``launches_sm90``, the launches on the sm90 route, and the
``*_onepass`` rows B3's and B10's ``launches_onepass`` (COUNTERS); B7's and B8's
launches on the sm90 attention are counted beside them (EXTRA_COUNTERS)
and reported in their sm90 rows.
Each phase's end is printed on the script's clock (``{"phase": ...,
"ended_at_s": ...}``; ``times`` ends at the ``total`` line), and every
phase line carries ``t_s``, that clock when it was printed. The last
lines are one JSON
object listing the kernels and, last, ``{"ok": true, "device": {...}}``.
``--phases`` runs a subset (``device,build,grad`` is the quick check
after editing a kernel); a subset never prints the ok line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

# bf16 kernel vs plain: both accumulate in fp32 but in another order, which
# flips the bf16 rounding of a few intermediates (h, q|k|v, p, o, hp, ha;
# qs, cast(pu), do/l, e; dx) by one ulp (2**-8 relative); a few such flips
# bound the output error by a few ulps of its largest element.
BF16_TOL = 2e-2
# bf16 gradients through a whole block, card vs CPU: five casts in a chain
# (do, dq|dk|dv, dh, dx and the weights' grads) compound those flips
GRAD_BF16_TOL = 5e-2
FP32_TOL = 1e-4
# the sm90 forward's row statistics against attention_stats_plain: both
# from the same bf16 q and k in fp32, summed in another order, and exp
# through exp2 on the card
STATS_TOL = 1e-4
# B5's probabilities in bf16: kernel and plain read the same bf16 q and k
# and differ only in the fp32 order of the logits' sums
PROBS_BF16_TOL = 1e-3
# the explain path on the kernels against the kernel-free route on the
# card, bf16: the repo's bf16 parity bar (tests/test_parity_torch.py:80)
EXPLAIN_TOL = 0.05
# the bf16 Grad-CAM heatmap against the reference route: a gradient through
# the last block (GRAD_BF16_TOL's chain of casts) times the tokens entering
# it, summed over the channels
GRADCAM_TOL = GRAD_BF16_TOL
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
PROFILE_LEAD = 1024           # spin kernels that open profile_call's window
PROFILE_LEAD_KEPT = 960       # of them a window must keep to be read
PROFILE_TRIES = 2             # windows profile_call traces at most
PHASES = ("device", "build", "kernels", "grad", "forward", "serve", "train",
          "explain", "tome", "finetune", "recipe", "transfer", "pretrained",
          "families", "optim", "pretrain", "parallel", "pipeline",
          "compose", "artifacts", "bench", "times")

KERNELS = {
    "fused_mha_block": {
        "source": "vitx_torch/kernels/csrc/mha_block.cu",
        "replaces": "vitx/kernels/mha_block.py:46",
        "tpu_kernel": "vitx/kernels/mha_block.py::_kernel",
    },
    "fused_mlp_block": {
        "source": "vitx_torch/kernels/csrc/mlp_block.cu",
        "replaces": "vitx/kernels/mlp_block.py:67",
        "tpu_kernel": "vitx/kernels/mlp_block.py::_kernel",
    },
    # the sm90 route of K1, K2, B7 and B8 (bf16, E a multiple of 8): their
    # projections on gemm_sm90.cuh, K1's, B7's and B8's attention at D 32,
    # 64 and 128 on attention_fwd_sm90.cuh (counted in launches_attn_sm90,
    # EXTRA_COUNTERS); counted in the wrappers' launches_sm90
    # (COUNTERS), while the rows above count every launch, both routes
    "fused_mha_block_sm90": {
        "source": "vitx_torch/kernels/csrc/mha_block.cu",
        "headers": ["vitx_torch/kernels/csrc/gemm_sm90.cuh",
                    "vitx_torch/kernels/csrc/attention_fwd_sm90.cuh"],
        "replaces": "vitx/kernels/mha_block.py:46",
        "tpu_kernel": "vitx/kernels/mha_block.py::_kernel",
    },
    "fused_mlp_block_sm90": {
        "source": "vitx_torch/kernels/csrc/mlp_block.cu",
        "headers": ["vitx_torch/kernels/csrc/gemm_sm90.cuh"],
        "replaces": "vitx/kernels/mlp_block.py:67",
        "tpu_kernel": "vitx/kernels/mlp_block.py::_kernel",
    },
    "attention_bwd": {
        "source": "vitx_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "vitx/kernels/flash_attention.py:287",
        "tpu_kernel": "vitx/kernels/flash_attention.py::_bwd_kernel_nq1",
        # B6, the q-chunked backward vitx runs past T = 1024: the same
        # function, which this kernel computes at every T
        "also_replaces": "vitx/kernels/flash_attention.py:238",
        "also_tpu_kernel": "vitx/kernels/flash_attention.py::_bwd_kernel",
    },
    # the sm90 route of attention_bwd (bf16, D 32, 64, 128): counted in
    # attention_bwd.launches_sm90 (COUNTERS), while attention_bwd counts
    # every launch of the wrapper, both routes, as before
    "attention_bwd_sm90": {
        "source": "vitx_torch/kernels/csrc/attention_bwd_sm90.cu",
        "replaces": "vitx/kernels/flash_attention.py:287",
        "tpu_kernel": "vitx/kernels/flash_attention.py::_bwd_kernel_nq1",
        "also_replaces": "vitx/kernels/flash_attention.py:238",
        "also_tpu_kernel": "vitx/kernels/flash_attention.py::_bwd_kernel",
    },
    "ln_bwd": {
        "source": "vitx_torch/kernels/csrc/layer_norm_bwd.cu",
        "replaces": "vitx/kernels/layer_norm.py:173",
        "tpu_kernel": "vitx/kernels/layer_norm.py::_ln_bwd3_kernel",
        # B11, the fused_layer_norm entries' backward: B3's function on
        # the 2-D (R, E) view, which ln_bwd takes at any rank
        "also_replaces": "vitx/kernels/layer_norm.py:114",
        "also_tpu_kernel": "vitx/kernels/layer_norm.py::_ln_bwd_kernel",
    },
    # B3's one-pass route (E a multiple of the 16-byte vector, at most
    # 4096): counted in ln_bwd.launches_onepass (COUNTERS), while ln_bwd
    # counts every launch, both routes
    "ln_bwd_onepass": {
        "source": "vitx_torch/kernels/csrc/layer_norm_bwd.cu",
        "replaces": "vitx/kernels/layer_norm.py:173",
        "tpu_kernel": "vitx/kernels/layer_norm.py::_ln_bwd3_kernel",
        "also_replaces": "vitx/kernels/layer_norm.py:114",
        "also_tpu_kernel": "vitx/kernels/layer_norm.py::_ln_bwd_kernel",
    },
    "fused_layer_norm": {
        "source": "vitx_torch/kernels/csrc/layer_norm_fwd.cu",
        "replaces": "vitx/kernels/layer_norm.py:59",
        "tpu_kernel": "vitx/kernels/layer_norm.py::_ln_kernel (plain)",
    },
    "fused_add_layer_norm": {
        "source": "vitx_torch/kernels/csrc/layer_norm_fwd.cu",
        "replaces": "vitx/kernels/layer_norm.py:59",
        "tpu_kernel": "vitx/kernels/layer_norm.py::_ln_kernel (with_add)",
    },
    # B10's one-pass route (E a multiple of the 16-byte vector, at most
    # 4096): counted in the entries' launches_onepass (COUNTERS), while the
    # two rows above count every launch, both routes
    "fused_layer_norm_onepass": {
        "source": "vitx_torch/kernels/csrc/layer_norm_fwd.cu",
        "replaces": "vitx/kernels/layer_norm.py:59",
        "tpu_kernel": "vitx/kernels/layer_norm.py::_ln_kernel (plain)",
    },
    "fused_add_layer_norm_onepass": {
        "source": "vitx_torch/kernels/csrc/layer_norm_fwd.cu",
        "replaces": "vitx/kernels/layer_norm.py:59",
        "tpu_kernel": "vitx/kernels/layer_norm.py::_ln_kernel (with_add)",
    },
    "fused_adamw_": {
        "source": "vitx_torch/kernels/csrc/adamw.cu",
        "replaces": "vitx/kernels/adamw.py:56",
        "tpu_kernel": "vitx/kernels/adamw.py::_kernel",
    },
    # B12 over every leaf of a step, one launch per gradient dtype
    # (adamw_multi_kernel): what AdamW.update(fused=True) runs
    "fused_adamw_multi_": {
        "source": "vitx_torch/kernels/csrc/adamw.cu",
        "replaces": "vitx/kernels/adamw.py:56",
        "tpu_kernel": "vitx/kernels/adamw.py::_kernel",
    },
    "flash_attention": {
        "source": "vitx_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "vitx/kernels/flash_attention.py:132",
        "tpu_kernel": "vitx/kernels/flash_attention.py::_fwd_kernel "
                      "(no probs)",
    },
    "flash_attention_sm90": {
        "source": "vitx_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "vitx/kernels/flash_attention.py:132",
        "tpu_kernel": "vitx/kernels/flash_attention.py::_fwd_kernel "
                      "(no probs, bf16 at D 32, 64, 128)",
    },
    "flash_attention_with_probs": {
        "source": "vitx_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "vitx/kernels/flash_attention.py:132",
        "tpu_kernel": "vitx/kernels/flash_attention.py::_fwd_kernel "
                      "(full probs)",
    },
    "flash_attention_with_mean_probs": {
        "source": "vitx_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "vitx/kernels/flash_attention.py:132",
        "tpu_kernel": "vitx/kernels/flash_attention.py::_fwd_kernel "
                      "(head-mean probs)",
    },
    # B5's probability modes on the sm90 route (bf16 at D 32, 64 and 128,
    # contiguous planes): the body, then the probability pass; counted in the
    # wrappers' launches_sm90 (COUNTERS), while the two rows above count
    # every launch, both routes
    "flash_attention_with_probs_sm90": {
        "source": "vitx_torch/kernels/csrc/flash_attention_sm90.cu",
        "headers": ["vitx_torch/kernels/csrc/attention_fwd_sm90.cuh",
                    "vitx_torch/kernels/csrc/attention_probs_sm90.cuh"],
        "replaces": "vitx/kernels/flash_attention.py:132",
        "tpu_kernel": "vitx/kernels/flash_attention.py::_fwd_kernel "
                      "(full probs, bf16 at D 32, 64, 128)",
    },
    "flash_attention_with_mean_probs_sm90": {
        "source": "vitx_torch/kernels/csrc/flash_attention_sm90.cu",
        "headers": ["vitx_torch/kernels/csrc/attention_fwd_sm90.cuh",
                    "vitx_torch/kernels/csrc/attention_probs_sm90.cuh"],
        "replaces": "vitx/kernels/flash_attention.py:132",
        "tpu_kernel": "vitx/kernels/flash_attention.py::_fwd_kernel "
                      "(head-mean probs, bf16 at D 32, 64, 128)",
    },
    "fused_mha_block_with_mean_probs": {
        "source": "vitx_torch/kernels/csrc/mha_block.cu",
        "replaces": "vitx/kernels/mha_block.py:174",
        "tpu_kernel": "vitx/kernels/mha_block.py::_kernel_hchunk "
                      "(mean probs)",
    },
    "fused_mha_block_tome": {
        "source": "vitx_torch/kernels/csrc/mha_block.cu",
        "replaces": "vitx/kernels/mha_block.py:507",
        "tpu_kernel": "vitx/kernels/mha_block.py::_kernel_tome",
        # B9 is B8 cut into head chunks only for the TPU's VMEM: the entry
        # vitx_mha_block_tome computes its function at every T
        "also_replaces": "vitx/kernels/mha_block.py:686",
        "also_tpu_kernel": "vitx/kernels/mha_block.py::_kernel_hchunk_tome",
    },
    "fused_mha_block_with_mean_probs_sm90": {
        "source": "vitx_torch/kernels/csrc/mha_block.cu",
        "headers": ["vitx_torch/kernels/csrc/gemm_sm90.cuh",
                    "vitx_torch/kernels/csrc/attention_fwd_sm90.cuh",
                    "vitx_torch/kernels/csrc/attention_probs_sm90.cuh"],
        "replaces": "vitx/kernels/mha_block.py:174",
        "tpu_kernel": "vitx/kernels/mha_block.py::_kernel_hchunk "
                      "(mean probs)",
    },
    "fused_mha_block_tome_sm90": {
        "source": "vitx_torch/kernels/csrc/mha_block.cu",
        "headers": ["vitx_torch/kernels/csrc/gemm_sm90.cuh",
                    "vitx_torch/kernels/csrc/attention_fwd_sm90.cuh"],
        "replaces": "vitx/kernels/mha_block.py:507",
        "tpu_kernel": "vitx/kernels/mha_block.py::_kernel_tome",
        "also_replaces": "vitx/kernels/mha_block.py:686",
        "also_tpu_kernel": "vitx/kernels/mha_block.py::_kernel_hchunk_tome",
    },
}
# the rows of the blocks' sm90 route, by the wrapper's own name
BLOCK_SM90 = {"fused_mha_block": "fused_mha_block_sm90",
              "fused_mlp_block": "fused_mlp_block_sm90",
              "fused_mha_block_with_mean_probs":
                  "fused_mha_block_with_mean_probs_sm90",
              "fused_mha_block_tome": "fused_mha_block_tome_sm90"}
# rows whose count is a second counter of another wrapper: name ->
# (wrapper, attribute)
COUNTERS = {"attention_bwd_sm90": ("attention_bwd", "launches_sm90"),
            "flash_attention_sm90": ("flash_attention", "launches_sm90"),
            "flash_attention_with_probs_sm90": ("flash_attention_with_probs",
                                                "launches_sm90"),
            "flash_attention_with_mean_probs_sm90": (
                "flash_attention_with_mean_probs", "launches_sm90"),
            "ln_bwd_onepass": ("ln_bwd", "launches_onepass"),
            "fused_layer_norm_onepass": ("fused_layer_norm",
                                         "launches_onepass"),
            "fused_add_layer_norm_onepass": ("fused_add_layer_norm",
                                             "launches_onepass"),
            **{row: (name, "launches_sm90")
               for name, row in BLOCK_SM90.items()}}
# counts that are no row of their own, read and expected beside the rows':
# K1's, B7's and B8's launches whose attention ran on the sm90 body (B7's
# with its head-mean pass, B8's in the body's KBIAS form)
EXTRA_COUNTERS = {"fused_mha_block_attn_sm90":
                  ("fused_mha_block", "launches_attn_sm90"),
                  "fused_mha_block_with_mean_probs_attn_sm90":
                  ("fused_mha_block_with_mean_probs", "launches_attn_sm90"),
                  "fused_mha_block_tome_attn_sm90":
                  ("fused_mha_block_tome", "launches_attn_sm90")}
# the blocks whose attention can take the sm90 body, by their extra counter
ATTN_SM90_COUNTERS = {"fused_mha_block": "fused_mha_block_attn_sm90",
                      "fused_mha_block_with_mean_probs":
                      "fused_mha_block_with_mean_probs_attn_sm90",
                      "fused_mha_block_tome": "fused_mha_block_tome_attn_sm90"}
# the sources whose SASS the build phase reads, and the sm90 kernels each
# must hold: the wgmma (HGMMA) and TMA (UTMALDG) instructions that show
# they reach the tensor cores' asynchronous path. mha_block and mlp_block
# also hold the earlier kernels (ln_stats_kernel, gemm_kernel,
# attention_kernel, head_mean_kernel), which use neither and are not read.
# A kernel named with its template arguments is that instantiation
# (attention_fwd_sm90<128, 2, true>: B8's KBIAS body at head width 128;
# dq_kernel_sm90<32, 2>: B2's launch A at 32); a bare name sums them all.
# attention_probs_sm90<D, true> is the head-mean probability pass at head
# width D (B7's in mha_block, B5's mean mode in flash_attention_sm90),
# <D, false> B5's full mode
SM90_WIDTHS = (32, 64, 128)    # the head widths of the sm90 body, pass and B2
SM90_SOURCES = {"flash_attention_sm90": (
                    *(f"attention_fwd_sm90<{d}, 2, false>"
                      for d in SM90_WIDTHS),
                    *(f"attention_probs_sm90<{d}, {mean}>"
                      for mean in ("true", "false") for d in SM90_WIDTHS)),
                "attention_bwd_sm90": (
                    *(f"{k}<{d}, 2>" for k in ("dq_kernel_sm90",
                                               "dkdv_kernel_sm90")
                      for d in SM90_WIDTHS),),
                "mha_block": ("gemm_sm90_kernel",
                              *(f"attention_fwd_sm90<{d}, 2, {kb}>"
                                for kb in ("false", "true")
                                for d in SM90_WIDTHS),
                              *(f"attention_probs_sm90<{d}, true>"
                                for d in SM90_WIDTHS)),
                "mlp_block": ("gemm_sm90_kernel",)}
# kernels whose SASS is read and must hold no wgmma: B12's multi-leaf
# update streams bytes and does no matrix product
NO_WGMMA_SOURCES = {"adamw": ("adamw_multi_kernel",)}
NO_LIBRARY = ("no single PyTorch call returns attention probabilities "
              "(scaled_dot_product_attention returns only the output)")
NO_ADD_LIBRARY = ("no single PyTorch call adds a residual and normalises "
                  "(F.layer_norm takes one input)")
BUILD = Path(__file__).resolve().parent / "build"


T_START = time.perf_counter()


def emit(obj) -> None:
    """Prints ``obj`` as one JSON line; a phase's line carries ``t_s``, the
    script's clock when it was printed."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T_START, 2)}
    print(json.dumps(obj), flush=True)


def rel_err(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` calls, each timed with
    CUDA events after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def block_inputs(B, T, E, H, M, dtype, seed, device):
    """Seeded inputs of one block at (B, T, E), weights in ``dtype``, drawn
    on the card (the same values whatever ``device`` they are placed on)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    D = E // H

    def t(shape, scale, dt=dtype, shift=0.0):
        a = torch.randn(shape, generator=gen, device="cuda")
        return (shift + scale * a).to(device=device, dtype=dt)

    f32 = torch.float32
    x = t((B, T, E), 1.0)
    mha = dict(wqkv=t((E, 3, H, D), 0.03), wo=t((E, E), 0.03),
               bo=t((E,), 0.1, f32), g=t((E,), 0.1, f32, 1.0),
               b=t((E,), 0.1, f32))
    mlp = dict(w1=t((E, M), 0.03), b1=t((M,), 0.1, f32), w2=t((M, E), 0.03),
               b2=t((E,), 0.1, f32), g=t((E,), 0.1, f32, 1.0),
               b=t((E,), 0.1, f32))
    return x, mha, mlp


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build():
    from vitx_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    for name, log in _build.build_log.items():
        func = ""
        for line in log["ptxas"].splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1] if "'" in line else ""
            elif "registers" in line or "spill" in line:
                print(f"ptxas {name} {func}: {line.strip()}")
    emit({"phase": "build", "seconds": round(seconds, 2),
          "per_source_s": {n: round(v["seconds"], 2)
                           for n, v in _build.build_log.items()}})
    from concurrent.futures import ThreadPoolExecutor

    names = (*SM90_SOURCES, *NO_WGMMA_SOURCES)
    with ThreadPoolExecutor(len(names)) as pool:   # one cuobjdump each
        funcs = dict(zip(names, pool.map(
            lambda n: sass_functions(_build._target(n)), names)))
    counts_ = {name: sass_counts(f) for name, f in funcs.items()}
    sass = {name: {kern: sass_of(counts_[name], kern) for kern in wanted}
            for name, wanted in SM90_SOURCES.items()}
    emit({"phase": "build", "check": "SASS of the sm90 kernels: wgmma "
          "(HGMMA) and TMA (UTMALDG) or other async copies (UBLKCP, LDGSTS) "
          "per kernel, and wgmma waits (WARPGROUP.DEPBAR: one per HGMMA "
          "would mean ptxas serialised them); attention_fwd_sm90<D, 2, "
          "true> is B8's KBIAS instantiation at head width D, "
          "attention_probs_sm90<D, true> the head-mean probability pass at "
          "head width D (B7's, B5's mean mode), <D, false> B5's full mode",
          "sass": sass})
    for name, wanted in SM90_SOURCES.items():
        for kern in wanted:
            n = sass[name].get(kern)
            if n is None or not n["HGMMA"] or not (
                    n["UTMALDG"] + n["UBLKCP"] + n["LDGSTS"]):
                raise AssertionError(f"{name}: {kern} is missing or has no "
                                     f"wgmma or no async copy in its SASS: "
                                     f"{n}")
    plain = {name: {kern: sass_of(counts_[name], kern) for kern in wanted}
             for name, wanted in NO_WGMMA_SOURCES.items()}
    emit({"phase": "build", "check": "SASS of B12's multi-leaf kernel "
          "(both gradient dtypes): HGMMA, UTMALDG and WARPGROUP.DEPBAR "
          "expected 0 -- it streams 16-byte vectors through ordinary "
          "loads and does no matrix product", "sass": plain})
    for name, wanted in NO_WGMMA_SOURCES.items():
        for kern in wanted:
            n = plain[name][kern]
            if n is None or n["HGMMA"] or n["WARPGROUP.DEPBAR"]:
                raise AssertionError(f"{name}: {kern} is missing or holds "
                                     f"wgmma: {n}")
    # the body without the key bias and the head-mean pass (at each width)
    # are one code in both sources: K1's and B7's copies (mha_block) and
    # B5's (flash_attention_sm90), instruction for instruction, so the
    # KBIAS flag and the full mode's instantiation leave them as they were
    for kern in (*(f"attention_fwd_sm90<{d}, 2, false>" for d in SM90_WIDTHS),
                 *(f"attention_probs_sm90<{d}, true>" for d in SM90_WIDTHS)):
        same = (funcs["mha_block"].get(kern)
                == funcs["flash_attention_sm90"].get(kern))
        emit({"phase": "build", "check": f"{kern}: mha_block's SASS equal "
              f"to flash_attention_sm90's", "equal": same,
              "instructions": len(funcs["mha_block"].get(kern) or [])})
        if not same:
            raise AssertionError(f"{kern} differs between mha_block and "
                                 f"flash_attention_sm90")


SASS_OPS = ("HGMMA", "UTMALDG", "UBLKCP", "LDGSTS", "WARPGROUP.DEPBAR")


def sass_functions(so: Path) -> dict:
    """{kernel: its SASS lines} of a built library, from ``cuobjdump
    -sass`` (the CUDA toolkit's, beside nvcc). A kernel templated on
    integer or bool literals only is named with them
    (``attention_fwd_sm90<2, true>``), any other by its bare name (its
    instantiations' lines joined)."""
    import re

    from vitx_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    funcs, kern = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            m = re.search(r"_ZN4vitx(\d+)", mangled)
            if m:
                end = m.end() + int(m.group(1))
                kern = mangled[m.end():end]
                t = re.match(r"I((?:L[a-z]\d+E)+)E", mangled[end:])
                if t:
                    args = re.findall(r"L([a-z])(\d+)E", t.group(1))
                    kern += "<" + ", ".join(
                        ({"0": "false", "1": "true"}[v] if ty == "b" else v)
                        for ty, v in args) + ">"
            else:
                kern = mangled
            funcs.setdefault(kern, [])
        elif kern is not None:
            funcs[kern].append(" ".join(line.split()))
    return funcs


def sass_counts(funcs: dict) -> dict:
    """{kernel: {instruction: count}} of SASS_OPS in ``sass_functions``'
    kernels."""
    return {kern: {op: sum(op in line for line in lines) for op in SASS_OPS}
            for kern, lines in funcs.items()}


def sass_of(counts_: dict, kern: str):
    """``kern``'s counts: its own, or, for a bare name, the sum over its
    instantiations; None where the library has no such kernel."""
    hits = [c for k, c in counts_.items()
            if k == kern or ("<" not in kern and k.startswith(kern + "<"))]
    if not hits:
        return None
    return {op: sum(c[op] for c in hits) for op in SASS_OPS}


def phase_kernels(errs: dict):
    T, E, H = 197, 768, 12
    # batch 8, and batch 32: the shape the serve phase gives the kernels
    for B in (8, 32):
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            check_block(B, T, E, H, dtype, tol, errs)
    # K1 and K2 on the sm90 route with every stash output, and on the
    # earlier route on the same inputs: base16 at batch 8, a ragged M (3 x
    # 197 rows), tiny's widths (QKV N 192, the MLP's 256), large16_384's
    # (E 1024, M 4096) and the small16 recipe's (E 384, 6 heads, M 1536:
    # QKV N 1152, the out-projection's and W2's N 384 against 256-wide
    # tiles) at its batch 128 and a ragged M, and the transfer fine-tune's
    # base16 at 384² (T 577) batch 32
    for shape in ((8, 197, 768, 12), (3, 197, 768, 12), (2, 65, 64, 4),
                  (8, 577, 1024, 16), (128, 197, 384, 6), (3, 197, 384, 6),
                  (32, 577, 768, 12)):
        check_blocks_sm90(*shape, errs)
    # B5 at the rollout's heads, base16's, and past T = 1024
    for shape in ((2, 16, 577, 64), (2, 12, 197, 64), (1, 16, 1100, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            check_flash(shape, dtype, errs)
    # B5's probability modes on the sm90 route at a ragged T (65: a last
    # key tile of one key, one query tile's rows mostly past T) at each
    # head width, the head mean at the rollout's batch 32, and both modes
    # at MAE's decoder's width (8, 16, 197, 32)
    for shape, modes in (((2, 4, 65, 64), ("full", "mean")),
                         ((32, 16, 577, 64), ("mean",)),
                         ((2, 4, 65, 128), ("full", "mean")),
                         ((2, 4, 65, 32), ("full", "mean")),
                         ((8, 16, 197, 32), ("full", "mean"))):
        q, k, v = (seeded(shape, s, 1.5, dtype=torch.bfloat16)
                   for s in (34, 35, 36))
        check_probs_sm90(q, k, v, errs if shape[0] in (8, 32) else None,
                         {"shape": list(shape), "dtype": "torch.bfloat16"},
                         modes)
        del q, k, v
    # B7 and K1 at large16_384 block shapes; B7 at huge14's (8, 257, 1280),
    # 10 heads, and base16_hd128's (8, 197, 768), 6 heads, both D 128
    for B in (2, 8):
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            check_mean_probs_block(B, 577, 1024, 16, dtype, tol, errs)
    for shape in ((8, 257, 1280, 10), (8, 197, 768, 6)):
        check_mean_probs_block(*shape, torch.bfloat16, BF16_TOL, errs)
    # B8 where the base16 r=13 server runs it (batch 32; T 197 the first
    # block, 54 the last, 119 between), at batch 8 and small T; at
    # large16_384's early ToMe blocks, the range of B9 (T 577 .. 416), and
    # its last r=23 block (T 48)
    for shape in ((32, 197, 768, 12), (32, 119, 768, 12), (32, 54, 768, 12),
                  (8, 197, 768, 12), (8, 41, 768, 12), (2, 13, 768, 12),
                  (8, 577, 1024, 16), (8, 416, 1024, 16), (8, 48, 1024, 16)):
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            check_tome_block(*shape, dtype, tol, errs)
    # K2 at the r=13 server's first and last MLP shapes (41 tokens leave
    # the last block)
    for T in (184, 41):
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            check_block(32, T, E, H, dtype, tol, errs, mha=False)
    # the sm90 attention at head widths 128 (huge14, base16_hd128) and 32
    # (MAE's decoder): B5 and B2 at their main paths' shapes (B5 at D 128
    # with its probability modes, D 32's above), B2 also in B6's range, K1
    # with its stash, B8 (its KBIAS body)
    check_flash((8, 10, 257, 128), torch.bfloat16, errs)
    check_flash((128, 16, 197, 32), torch.bfloat16, errs, probs=False)
    for shape in ((8, 10, 257, 128), (128, 16, 197, 32), (4, 10, 1025, 128)):
        check_attention_bwd(shape, torch.bfloat16, BF16_TOL, errs, "kernels")
    for shape in ((32, 257, 1280, 10), (128, 197, 512, 16)):
        check_blocks_sm90(*shape, errs)
    for shape in ((8, 197, 768, 6), (8, 197, 512, 16)):
        check_tome_block(*shape, torch.bfloat16, BF16_TOL, errs)
    # B10 at widths off and on the 16-byte vectors (64, 100), the models'
    # (768, 1024) and the reference head's (3072); one row, the two
    # sequences of a base16 server batch, and base16's b256 tokens
    for E_ in (64, 100, 768, 1024, 3072):
        for R in (1, 394, 256 * 197):
            for dtype in (torch.float32, torch.bfloat16):
                check_layer_norm_fwd(R, E_, dtype, errs)
    emit({"phase": "kernels", "check": "fused_layer_norm and "
          "fused_add_layer_norm twice bit for bit, the add variant's sum "
          "equal to x + r, at every shape above; the one-pass route where "
          "ln_fwd_route gives it (every shape but bf16 at E 100), the "
          "earlier kernel beside it on the same inputs"})


def check_layer_norm_fwd(R, E, dtype, errs: dict) -> None:
    """B10 in both variants against ``layer_norm_fwd_plain`` on (R, E):
    the wrappers' route (the one-pass route where ``ln_fwd_route`` gives
    it, counted in launches_onepass one a call) and the earlier kernel on
    the same inputs through its launcher (route 0); the add variant's sum
    equal to the plain sum bit for bit on both; each variant twice, bit
    for bit."""
    import importlib

    from vitx_torch.kernels import (fused_add_layer_norm, fused_layer_norm,
                                    layer_norm_fwd_plain)

    tln = importlib.import_module("vitx_torch.kernels.layer_norm")
    bf = dtype == torch.bfloat16
    tol = BF16_TOL if bf else FP32_TOL
    x = seeded((R, E), 80 + E, 3.0, 0.5, dtype=dtype)
    r = seeded((R, E), 81 + E, 1.0, dtype=dtype)
    sc, bi = seeded((E,), 82, 0.1, 1.0), seeded((E,), 83, 0.1)
    route = tln.ln_fwd_route(dtype, E, (x, r, sc, bi))
    onepass = route == tln.LN_ROUTE_ONEPASS
    info = {"shape": [R, E], "dtype": str(dtype), "route": route}
    main = bf and (R, E) == (256 * 197, 768)      # the timed shape
    fast = "_onepass" if onepass else ""
    n = (fused_layer_norm.launches_onepass,
         fused_add_layer_norm.launches_onepass)
    y = fused_layer_norm(x, sc, bi)
    s, ya = fused_add_layer_norm(x, r, sc, bi)
    torch.cuda.synchronize()
    got = (fused_layer_norm.launches_onepass - n[0],
           fused_add_layer_norm.launches_onepass - n[1])
    if got != (int(onepass), int(onepass)):
        raise AssertionError(f"B10 {info}: {got} one-pass launches")
    ref_y = layer_norm_fwd_plain(x, sc, bi)
    check("kernels", f"fused_layer_norm{fast}", y, ref_y, tol,
          errs if main else None, f"fused_layer_norm{fast}", **info)
    ref_s, ref_ya = layer_norm_fwd_plain(x, sc, bi, r)
    check("kernels", f"fused_add_layer_norm{fast} (sum, y)", (s, ya),
          (ref_s, ref_ya), tol, errs if main else None,
          f"fused_add_layer_norm{fast}", **info)
    if not torch.equal(s, ref_s):
        raise AssertionError(f"B10 {info}: the sum differs from x + r")
    if not (torch.equal(fused_layer_norm(x, sc, bi), y)
            and torch.equal(fused_add_layer_norm(x, r, sc, bi)[1], ya)):
        raise AssertionError(f"B10 {info}: two calls differ")
    if onepass:   # the earlier kernel on the same inputs
        was_y = tln._launch_fwd(x, None, sc, bi, 1e-5, route=0)[0]
        was_ya, was_s, _ = tln._launch_fwd(x, r, sc, bi, 1e-5, route=0)
        check("kernels", "fused_layer_norm (the earlier kernel)", was_y,
              ref_y, tol, errs if main else None, "fused_layer_norm",
              **info)
        check("kernels", "fused_add_layer_norm (the earlier kernel) (sum, "
              "y)", (was_s, was_ya), (ref_s, ref_ya), tol,
              errs if main else None, "fused_add_layer_norm", **info)
        if not torch.equal(was_s, ref_s):
            raise AssertionError(f"B10 {info}: the earlier kernel's sum "
                                 f"differs from x + r")


def check_rows(what: str, probs, **info) -> None:
    """Each row of a probability tensor sums to 1 within 1e-5."""
    dev = float((probs.double().sum(-1) - 1.0).abs().max())
    emit({"phase": "kernels", "check": f"{what} row sums", "max_dev": dev,
          "tol": 1e-5, **info})
    if dev > 1e-5:
        raise AssertionError(f"{what} {info}: rows sum to 1 +- {dev}")


def check_flash(shape, dtype, errs: dict, probs: bool = True) -> None:
    """B5 in each mode against ``flash_attention_fwd_plain``; the head
    mean twice, bit for bit. In bf16 at D 32, 64 and 128 every mode is on
    its sm90 route: ``check_flash_sm90`` and (with ``probs``)
    ``check_probs_sm90`` hold them; fp32 and other D keep the earlier
    kernel, launches_sm90 unmoved."""
    from vitx_torch.kernels import (flash_attention,
                                    flash_attention_fwd_plain,
                                    flash_attention_with_mean_probs,
                                    flash_attention_with_probs)

    bf = dtype == torch.bfloat16
    q, k, v = (seeded(shape, s, 1.5, dtype=dtype) for s in (31, 32, 33))
    info = {"shape": list(shape), "dtype": str(dtype)}
    if bf and shape[3] in SM90_WIDTHS:
        main = shape[3] != 64 or (shape[1] == 16 and shape[2] == 577)
        check_flash_sm90(q, k, v, errs if main else None, info)
        if probs:
            check_probs_sm90(q, k, v, errs if main else None, info)
        return
    tol, ptol = (BF16_TOL, PROBS_BF16_TOL) if bf else (FP32_TOL, FP32_TOL)
    for name, fn, mode in (
            ("flash_attention", flash_attention, None),
            ("flash_attention_with_probs", flash_attention_with_probs,
             "full"),
            ("flash_attention_with_mean_probs",
             flash_attention_with_mean_probs, "mean")):
        n90 = fn.launches_sm90
        out = fn(q, k, v)
        torch.cuda.synchronize()
        if fn.launches_sm90 != n90:
            raise AssertionError(f"{name} {info}: took the sm90 route")
        ref = flash_attention_fwd_plain(q, k, v, mode)
        if mode is None:
            check("kernels", name, out, ref, tol, None, **info)
            continue
        check("kernels", f"{name} o", out[0], ref[0], tol, None, **info)
        check("kernels", f"{name} probs", out[1], ref[1], ptol, None,
              **info)
        check_rows(name, out[1], **info)
        if mode == "mean" and not torch.equal(fn(q, k, v)[1], out[1]):
            raise AssertionError(f"{name} {info}: two calls differ")
        del out, ref


# the full mode's head mean (summed in head order, / H) against the mean
# mode's probabilities on the same inputs: the two differ by the fp32
# rounding of each head's product exp(s - m) * linv, which the mean mode
# fuses into its sum
HEAD_MEAN_TOL = 1e-6


def check_probs_sm90(q, k, v, errs, info, modes=("full", "mean")) -> None:
    """B5's probability ``modes`` on their sm90 route (bf16, D 32, 64 or
    128): o
    within BF16_TOL and the probabilities within PROBS_BF16_TOL of the
    plain version, rows summing to 1 within 1e-5, launches_sm90 one a call,
    twice bit for bit, o bit-equal to ``flash_attention``'s sm90 o; the
    full mode's head mean within HEAD_MEAN_TOL of the mean mode's; the
    earlier kernel (attention_fwd.cuh) on the same inputs through
    ``_launch_probs(route=0)``."""
    from vitx_torch.kernels import (flash_attention,
                                    flash_attention_fwd_plain,
                                    flash_attention_with_mean_probs,
                                    flash_attention_with_probs)

    tflash = attention_module()
    o90 = flash_attention(q, k, v)
    fns = {"full": ("flash_attention_with_probs", flash_attention_with_probs),
           "mean": ("flash_attention_with_mean_probs",
                    flash_attention_with_mean_probs)}
    probs = {}
    for mode in modes:
        name, fn = fns[mode]
        n, n90 = fn.launches, fn.launches_sm90
        out = fn(q, k, v)
        torch.cuda.synchronize()
        if (fn.launches, fn.launches_sm90) != (n + 1, n90 + 1):
            raise AssertionError(f"{name} {info}: not one launch on the "
                                 f"sm90 route")
        ref = flash_attention_fwd_plain(q, k, v, mode)
        key = f"{name}_sm90"
        check("kernels", f"{key} o", out[0], ref[0], BF16_TOL, errs, key,
              **info)
        check("kernels", f"{key} probs", out[1], ref[1], PROBS_BF16_TOL,
              errs, key, **info)
        check_rows(key, out[1], **info)
        again = fn(q, k, v)
        if not (torch.equal(again[0], out[0])
                and torch.equal(again[1], out[1])):
            raise AssertionError(f"{key} {info}: two calls differ")
        if not torch.equal(out[0], o90):
            raise AssertionError(f"{key} {info}: o differs from "
                                 f"flash_attention's sm90 o")
        del again
        was = tflash._launch_probs(q, k, v, mode, route=0)
        check("kernels", f"{name} (the earlier kernel) o", was[0], ref[0],
              BF16_TOL, errs, name, **info)
        check("kernels", f"{name} (the earlier kernel) probs", was[1],
              ref[1], PROBS_BF16_TOL, errs, name, **info)
        del was, ref
        probs[mode] = out[1]
        del out
    if len(probs) == 2:
        full = probs["full"]
        acc = full[:, 0]
        for h in range(1, full.shape[1]):
            acc = acc + full[:, h]
        err = card_rel_err(acc / full.shape[1], probs["mean"])
        emit({"phase": "kernels", "check": "the full mode's head mean (head "
              "order, / H) vs the mean mode's probabilities, sm90 route",
              "rel_err": err, "tol": HEAD_MEAN_TOL, **info})
        if err > HEAD_MEAN_TOL:
            raise AssertionError(f"B5 {info}: the full mode's head mean is "
                                 f"{err} from the mean mode's")
    emit({"phase": "kernels", "check": "B5's probability modes on the sm90 "
          "route: launches_sm90 one a call, twice bit for bit, o bit-equal "
          "to flash_attention's sm90 o", "modes": list(modes), **info})


def check_flash_sm90(q, k, v, errs, info) -> None:
    """B5 without probs on its sm90 route: o and the row statistics it
    writes for the backward against their plain versions, twice, bit for
    bit; the earlier kernel on the same bf16 inputs through its
    launcher."""
    from vitx_torch.kernels import (attention_stats_plain, flash_attention,
                                    flash_attention_fwd_plain)

    tflash = attention_module()
    n90 = flash_attention.launches_sm90
    o, stats = tflash._fwd(q, k, v, None, flash_attention, want_stats=True)
    torch.cuda.synchronize()
    if flash_attention.launches_sm90 != n90 + 1:
        raise AssertionError(f"flash_attention {info}: not on the sm90 route")
    ref = flash_attention_fwd_plain(q, k, v)
    check("kernels", "flash_attention_sm90", o, ref, BF16_TOL, errs,
          "flash_attention_sm90", **info)
    check("kernels", "flash_attention_sm90 stats (m, 1/l)", tuple(stats),
          tuple(attention_stats_plain(q, k)), STATS_TOL, **info)
    o2, stats2 = tflash._fwd(q, k, v, None, flash_attention, want_stats=True)
    if not (torch.equal(o, o2) and torch.equal(stats, stats2)):
        raise AssertionError(f"flash_attention_sm90 {info}: two calls differ")
    check("kernels", "flash_attention (the earlier kernel)",
          tflash._fwd_wmma(q, k, v, None), ref, BF16_TOL, errs,
          "flash_attention", **info)


def check_mean_probs_block(B, T, E, H, dtype, tol, errs: dict) -> None:
    """B7 against ``mha_block_mean_probs_plain`` (out and probs within
    ``tol``; on the sm90 attention and its head-mean pass where
    ``mha_route`` gives it, launches_attn_sm90 one a call) and, in bf16,
    its probabilities against the plain head mean of its own q and k within
    PROBS_BF16_TOL; K1
    against ``mha_block_plain`` and K2 (gelu_tanh, width 4E) against
    ``mlp_block_plain`` at (B, T, E); in bf16 also B7 on its GEMM-only route (the
    sm90 GEMM with attention_fwd.cuh) and on the earlier kernels, same
    inputs; B7 twice, bit for bit; its out bit-equal to K1's on K1's own
    route (in bf16 at D 32, 64 and 128 the same GEMMs and sm90 attention
    body, which B7 must take there)."""
    from vitx_torch.kernels import (flash_attention_fwd_plain,
                                    fused_mha_block,
                                    fused_mha_block_with_mean_probs,
                                    fused_mlp_block,
                                    mha_block_mean_probs_plain,
                                    mha_block_plain, mlp_block_plain)

    tmha = block_module()
    x, mha, mlp = block_inputs(B, T, E, H, 4 * E, dtype, 40 + B, "cuda")
    info = {"batch": B, "shape": [B, T, E], "dtype": str(dtype)}
    bf = dtype == torch.bfloat16
    route = tmha.mha_route(dtype, E, H, tensors=(x, mha["wqkv"], mha["wo"]))
    if bf and E // H in SM90_WIDTHS and not route & tmha.ROUTE_ATTN_SM90:
        raise AssertionError(f"B7 {info}: route {route} leaves the sm90 "
                             f"attention")
    n90 = fused_mha_block_with_mean_probs.launches_attn_sm90
    out = fused_mha_block_with_mean_probs(x, **mha)
    torch.cuda.synchronize()
    attn90 = fused_mha_block_with_mean_probs.launches_attn_sm90 - n90
    if attn90 != bool(route & tmha.ROUTE_ATTN_SM90):
        raise AssertionError(f"B7 {info}: {attn90} sm90 attention launches "
                             f"on route {route}")
    ref = mha_block_mean_probs_plain(x, **mha)
    key = "fused_mha_block_with_mean_probs_sm90"
    check("kernels", "fused_mha_block_with_mean_probs (out, probs)", out,
          ref, tol, errs if bf else None, key, route=route, **info)
    # the probabilities from the kernel's own q and k against B5's plain
    # head mean of them: the attention and the pass alone, without the
    # projections' bf16 roundings, which move q and k by an ulp here and
    # there on either side
    _, probs, q, k, v, _ = tmha._launch_mean_probs(x, **mha, eps=1e-5)
    check("kernels", "fused_mha_block_with_mean_probs probs vs the plain "
          "head mean of its own q and k", probs,
          flash_attention_fwd_plain(q, k, v, "mean")[1],
          PROBS_BF16_TOL if bf else tol, route=route, **info)
    if not torch.equal(probs, out[1]):
        raise AssertionError(f"B7 {info}: launcher and wrapper differ")
    del probs, q, k, v
    if bf:   # the GEMM-only route and the earlier kernels, same inputs
        for what, r, k in (
                ("the GEMM-only route: the sm90 GEMM with attention_fwd.cuh",
                 tmha.ROUTE_GEMM_SM90, None),
                ("the earlier kernels: gemm_kernel and attention_fwd.cuh", 0,
                 "fused_mha_block_with_mean_probs")):
            was = tmha._launch_mean_probs(x, **mha, eps=1e-5, route=r)
            check("kernels", f"fused_mha_block_with_mean_probs, {what} (out, "
                  f"probs)", was[:2], ref, tol, errs if k else None, k,
                  **info)
            del was
    check_rows("fused_mha_block_with_mean_probs", out[1], **info)
    again = fused_mha_block_with_mean_probs(x, **mha)
    if not (torch.equal(again[1], out[1]) and torch.equal(again[0], out[0])):
        raise AssertionError(f"B7 {info}: two calls differ")
    del again
    k1 = fused_mha_block(x, **mha)
    torch.cuda.synchronize()
    if not torch.equal(k1, out[0]):
        raise AssertionError(f"B7 {info}: out differs from K1's on K1's "
                             f"route")
    emit({"phase": "kernels", "check": "fused_mha_block_with_mean_probs "
          "twice bit for bit; out bit-equal to K1's on K1's own route",
          "route": route, "attn_sm90_launches": attn90, **info})
    check("kernels", "fused_mha_block", k1, mha_block_plain(x, **mha), tol,
          errs if bf else None, "fused_mha_block_sm90", **info)
    k2 = fused_mlp_block(x, **mlp, act="gelu_tanh")
    torch.cuda.synchronize()
    check("kernels", "fused_mlp_block", k2,
          mlp_block_plain(x, **mlp, act="gelu_tanh"), tol,
          errs if bf else None, "fused_mlp_block_sm90", act="gelu_tanh",
          **info)


def tome_inputs(B, T, E, H, dtype, seed, device="cuda"):
    """x and B8's other inputs at (B, T, E): random nonzero bqkv, and
    log_size in [0, log 40] (tokens standing for 1 to 40 originals, as
    large16_384's last ToMe blocks reach: a row's max moves between key
    tiles, so the sm90 body's rescale runs)."""
    x, mha, _ = block_inputs(B, T, E, H, E, dtype, seed, device)
    rng = np.random.default_rng(seed + 1)
    sizes = 1.0 + 39.0 * rng.random((B, T))
    tome = dict(mha, bqkv=seeded((3, H, E // H), seed + 2, 0.1,
                                 device=device),
                log_size=torch.from_numpy(np.log(sizes).astype(np.float32))
                .to(device))
    return x, tome


def check_tome_block(B, T, E, H, dtype, tol, errs: dict) -> None:
    """B8 against ``mha_block_tome_plain`` (out and k_mean): the wrapper's
    route (in bf16 at D 64 the sm90 GEMM and the KBIAS sm90 attention,
    counted in launches_attn_sm90), and in bf16 the GEMM-only route (the
    sm90 GEMM with attention_fwd.cuh) and the earlier kernels (route 0) on
    the same
    inputs; k_mean twice, bit for bit; with zero bqkv and log_size, its out
    equal to K1's on K1's own full route bit for bit."""
    from vitx_torch.kernels import fused_mha_block_tome, mha_block_tome_plain

    tmha = block_module()
    x, tm = tome_inputs(B, T, E, H, dtype, 60 + T)
    info = {"batch": B, "shape": [B, T, E], "dtype": str(dtype)}
    bf = dtype == torch.bfloat16
    route = tmha.mha_route(dtype, E, H, tensors=(x, tm["wqkv"], tm["wo"]))
    n90 = fused_mha_block_tome.launches_attn_sm90
    out = fused_mha_block_tome(x, **tm)
    torch.cuda.synchronize()
    attn90 = fused_mha_block_tome.launches_attn_sm90 - n90
    if attn90 != bool(route & tmha.ROUTE_ATTN_SM90):
        raise AssertionError(f"B8 {info}: {attn90} sm90 attention launches "
                             f"on route {route}")
    ref = mha_block_tome_plain(x, **tm)
    check("kernels", "fused_mha_block_tome (out, k_mean)", out, ref, tol,
          errs if bf else None, "fused_mha_block_tome_sm90", route=route,
          **info)
    if bf:   # the GEMM-only route and the earlier kernels, same inputs
        check("kernels", "fused_mha_block_tome, the earlier route: the "
              "sm90 GEMM with attention_fwd.cuh (out, k_mean)",
              tome_earlier(x, tm, route=tmha.ROUTE_GEMM_SM90), ref, tol,
              **info)
        check("kernels", "fused_mha_block_tome, the earlier kernels: "
              "gemm_kernel and attention_fwd.cuh (out, k_mean)",
              tome_earlier(x, tm), ref, tol, errs, "fused_mha_block_tome",
              **info)
    if not torch.equal(fused_mha_block_tome(x, **tm)[1], out[1]):
        raise AssertionError(f"B8 {info}: two calls' k_mean differ")
    zero = dict(tm, bqkv=torch.zeros_like(tm["bqkv"]),
                log_size=torch.zeros_like(tm["log_size"]))
    # K1 on its own full route: in bf16 at D 32, 64 and 128 the same sm90
    # GEMM and attention body, without the key bias
    st = torch.empty((2, B, H, T), dtype=torch.float32, device="cuda")
    k1, *_, k1_route = tmha._launch(x, tm["wqkv"], tm["wo"], tm["bo"],
                                    tm["g"], tm["b"], 1e-5, extra=(st,))
    if k1_route != route:
        raise AssertionError(f"B8 {info}: route {route}, K1's {k1_route}")
    if not torch.equal(fused_mha_block_tome(x, **zero)[0], k1):
        raise AssertionError(f"B8 {info}: zero biases differ from K1")
    emit({"phase": "kernels", "check": "fused_mha_block_tome k_mean "
          "bit-identical twice; zero biases bit-equal to K1 on K1's full "
          "route", "route": route, "attn_sm90_launches": attn90, **info})


def block_module():
    """``vitx_torch.kernels.mha_block`` (the package exports functions of
    the blocks' names), for the earlier route's launcher."""
    import importlib

    return importlib.import_module("vitx_torch.kernels.mha_block")


def tome_earlier(x, tm, eps=1e-5, route=0):
    """B8 on an earlier route through its launcher -> (out, k_mean): the
    earlier kernels (gemm_kernel, attention_fwd.cuh) by default, the
    GEMM-only route (the sm90 GEMM, attention_fwd.cuh) with ``route``
    ROUTE_GEMM_SM90; counts nothing."""
    k_mean = torch.empty((*x.shape[:2], tm["wqkv"].shape[3]), dtype=x.dtype,
                         device=x.device)
    out = block_module()._launch(
        x, tm["wqkv"], tm["wo"], tm["bo"], tm["g"], tm["b"], eps,
        "mha_block_tome", (tm["bqkv"], tm["log_size"], k_mean),
        route=route)[0]
    return out, k_mean


def check_blocks_sm90(B, T, E, H, errs: dict) -> None:
    """K1 and K2 in bf16 on the sm90 route against their plain versions at
    (B, T, E), every stash output: K1's out, q, k, v, o_all and, at D 32,
    64 and 128 where B5's sm90 body writes them (launches_attn_sm90 one a
    call), the attention's statistics (against attention_stats_plain on
    the kernel's own q and k, STATS_TOL); K2's out and hp in its three
    activations. Each call adds one to launches_sm90 and gives the same
    bits twice. The earlier route (gemm_kernel,
    attention_fwd.cuh) on the same inputs through the launchers, against
    the same plain versions."""
    import importlib

    from vitx_torch.kernels import (attention_stats_plain, fused_mha_block,
                                    fused_mlp_block, mha_block_plain,
                                    mlp_block_plain)

    tmha = block_module()
    tmlp = importlib.import_module("vitx_torch.kernels.mlp_block")
    bf = torch.bfloat16
    x, mha, mlp = block_inputs(B, T, E, H, 4 * E, bf, 70 + B, "cuda")
    info = {"shape": [B, T, E], "heads": H, "dtype": str(bf)}
    n90 = fused_mha_block.launches_sm90
    a90 = fused_mha_block.launches_attn_sm90
    got = tmha._forward(x, **mha, eps=1e-5)
    torch.cuda.synchronize()
    if fused_mha_block.launches_sm90 != n90 + 1:
        raise AssertionError(f"K1 {info}: not on the sm90 route")
    if fused_mha_block.launches_attn_sm90 != a90 + (E // H in SM90_WIDTHS):
        raise AssertionError(f"K1 {info}: its attention's route is not "
                             f"mha_route's")
    ref = mha_block_plain(x, **mha, stash=True)
    check("kernels", "fused_mha_block sm90 route (out, q, k, v, o_all)",
          got[:5], ref, BF16_TOL, errs, "fused_mha_block_sm90", **info)
    if E // H in SM90_WIDTHS:
        check("kernels", "fused_mha_block sm90 route: attention stats (m, "
              "1/l)", tuple(got[5]), tuple(attention_stats_plain(got[1],
                                                                 got[2])),
              STATS_TOL, **info)
    again = tmha._forward(x, **mha, eps=1e-5)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"K1 sm90 {info}: two calls differ")
    st = torch.empty((2, B, H, T), dtype=torch.float32, device="cuda")
    was = tmha._launch(x, **mha, eps=1e-5, extra=(st,), route=0)
    check("kernels", "fused_mha_block earlier route (out, q, k, v, o_all)",
          was[:5], ref, BF16_TOL, errs, "fused_mha_block", **info)
    del got, again, was, ref
    for act in ("gelu", "gelu_tanh", "relu"):
        n90 = fused_mlp_block.launches_sm90
        got = fused_mlp_block(x, **mlp, act=act, stash=True)
        torch.cuda.synchronize()
        if fused_mlp_block.launches_sm90 != n90 + 1:
            raise AssertionError(f"K2 {info}: not on the sm90 route")
        ref = mlp_block_plain(x, **mlp, act=act, stash=True)
        check("kernels", "fused_mlp_block sm90 route (out, hp)", got, ref,
              BF16_TOL, errs, "fused_mlp_block_sm90", act=act, **info)
        again = fused_mlp_block(x, **mlp, act=act, stash=True)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"K2 sm90 {info} {act}: two calls differ")
        was = tmlp._launch(x, **mlp, act=act, eps=1e-5, stash=True,
                           route=0)[:2]
        check("kernels", "fused_mlp_block earlier route (out, hp)", was, ref,
              BF16_TOL, errs, "fused_mlp_block", act=act, **info)
    emit({"phase": "kernels", "check": "K1 and K2 sm90 route twice bit for "
          "bit, launches_sm90 one a call", **info})


def check_block(B, T, E, H, dtype, tol, errs: dict, mha: bool = True):
    """K1 (unless ``mha`` is False) and K2 in its three activations
    against their plain versions at (B, T, E)."""
    from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    x, attn, mlp = block_inputs(B, T, E, H, 4 * E, dtype, B, "cuda")
    runs = [("fused_mha_block", None, lambda: fused_mha_block(x, **attn),
             lambda: mha_block_plain(x, **attn))] if mha else []
    for act in ("gelu", "gelu_tanh", "relu"):
        runs.append(("fused_mlp_block", act,
                     lambda a=act: fused_mlp_block(x, **mlp, act=a),
                     lambda a=act: mlp_block_plain(x, **mlp, act=a)))
    for name, act, kern, plain in runs:
        out = kern()
        torch.cuda.synchronize()
        # bf16 at these widths is the sm90 route: its row keeps the error
        check("kernels", name, out, plain(), tol,
              errs if dtype == torch.bfloat16 and act in (None, "gelu_tanh")
              else None, BLOCK_SM90[name], act=act, batch=B, T=T,
              dtype=str(dtype))


def wrappers() -> dict:
    """name -> (wrapper, the attribute that counts its launches), for the
    rows and EXTRA_COUNTERS."""
    import vitx_torch.kernels as k

    every = {**COUNTERS, **EXTRA_COUNTERS}
    return {name: (getattr(k, every.get(name, (name,))[0]),
                   every.get(name, (name, "launches"))[1])
            for name in (*KERNELS, *EXTRA_COUNTERS)}


def reset_counts():
    for fn, attr in wrappers().values():
        setattr(fn, attr, 0)


def counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in wrappers().items()}


def launches_of(**per: int) -> dict:
    """A launch count for every kernel and extra counter: ``per``'s, else
    0; B3's and B10's one-pass rows, unless given, their wrappers' counts:
    every LayerNorm of the paths has E 768, 1024, 3072 or 4096, which the
    one-pass routes take in both dtypes (``ln_bwd_route``,
    ``ln_fwd_route``)."""
    for name in ("ln_bwd", "fused_layer_norm", "fused_add_layer_norm"):
        per.setdefault(f"{name}_onepass", per.get(name, 0))
    return {name: per.get(name, 0) for name in (*KERNELS, *EXTRA_COUNTERS)}


def gemm_sm90(cfg) -> tuple:
    """(K1/B7/B8, K2): whether ``cfg``'s block kernels run their products on
    the sm90 GEMM, by the wrappers' own route rules (``mha_route``,
    ``mlp_route``: bf16, E and the MLP's width multiples of 8)."""
    import importlib

    mha = importlib.import_module("vitx_torch.kernels.mha_block")
    mlp = importlib.import_module("vitx_torch.kernels.mlp_block")
    dt, E = cfg.cdtype(), cfg.embed_dim
    return (bool(mha.mha_route(dt, E, cfg.num_heads) & mha.ROUTE_GEMM_SM90),
            bool(mlp.mlp_route(dt, E, cfg.mlp_dim)))


def block_launches(cfg, **per: int) -> dict:
    """``launches_of(**per)`` plus, for each block kernel in ``per``, its
    sm90 row (BLOCK_SM90) with the same count where ``cfg`` takes the sm90
    GEMM, else 0; and K1's, B7's and B8's sm90 attention launches, where
    ``cfg`` takes that attention (``attn_sm90``)."""
    mha90, mlp90 = gemm_sm90(cfg)
    sm90_rows = {BLOCK_SM90[k]: n * (mlp90 if k == "fused_mlp_block"
                                     else mha90)
                 for k, n in per.items() if k in BLOCK_SM90}
    for block, extra in ATTN_SM90_COUNTERS.items():
        sm90_rows[extra] = per.get(block, 0) * attn_sm90(cfg)
    return launches_of(**per, **sm90_rows)


def attn_sm90(cfg) -> bool:
    """Whether the blocks' attention (K1, B7 and B8) runs on the sm90 body
    for ``cfg``, by their route rule (``mha_route``: bf16 at D 32, 64 or
    128; B7's head-mean pass after it)."""
    import importlib

    mha = importlib.import_module("vitx_torch.kernels.mha_block")
    return bool(mha.mha_route(cfg.cdtype(), cfg.embed_dim, cfg.num_heads)
                & mha.ROUTE_ATTN_SM90)


def attention_launches(cfg, n: int) -> dict:
    """``n`` attention halves: K1, or on RoPE's composed path B5 without
    probs (its sm90 route in bf16 at D 64)."""
    if cfg.pos_embed == "rope":
        return {"flash_attention": n, "flash_attention_sm90": n * sm90(cfg)}
    return {"fused_mha_block": n}


def forward_launches(cfg, forwards: int) -> dict:
    """Inference launches: one K1 per block (B8 with ``cfg.tome_r``, B5 on
    RoPE's composed path) and one K2 per dense block (a Soft-MoE block's
    MLP is its mixture of products), on the sm90 routes where ``cfg``
    takes them, nothing else."""
    n = cfg.depth * forwards
    attn = ({"fused_mha_block_tome": n} if cfg.tome_r
            else attention_launches(cfg, n))
    return block_launches(cfg, **attn,
                          fused_mlp_block=cfg.dense_block_count * forwards)


def check(phase: str, what: str, out, ref, tol: float,
          errs: dict | None = None, key: str | None = None, **info) -> None:
    """Emit one comparison of ``out`` with ``ref`` (tensors or sequences
    of them, compared on their device, or on the CPU where they differ)
    and raise past ``tol``; ``errs[key]`` keeps the largest absolute
    error."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    refs = ref if isinstance(ref, (tuple, list)) else (ref,)
    rel = abs_err = 0.0
    finite = True
    for o, r in zip(outs, refs):
        o, r = o.detach().float(), r.detach().float()
        if o.device != r.device:
            o, r = o.cpu(), r.cpu()
        finite = finite and bool(torch.isfinite(o).all())
        rel = max(rel, rel_err(o, r))
        abs_err = max(abs_err, float((o - r).abs().max()))
    emit({"phase": phase, "check": what, "rel_err": rel,
          "max_abs_err": abs_err, "tol": tol, **info})
    if not (finite and rel <= tol):
        raise AssertionError(f"{what} {info}: rel err {rel} > {tol}")
    if errs is not None and key is not None:
        errs[key] = max(errs.get(key, 0.0), abs_err)


def seeded(shape, seed, scale=1.0, shift=0.0, dtype=torch.float32,
           device="cuda"):
    """shift + scale * N(0, 1) of ``shape``, drawn on the card from
    ``seed`` (the same values whatever ``device`` it is placed on)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    a = torch.randn(shape, generator=gen, device="cuda")
    return (shift + scale * a).to(device=device, dtype=dtype)


def check_attention_bwd(shape, dtype, tol, errs: dict,
                        phase: str = "grad") -> None:
    """B2's kernel at (B, H, T, D) against ``attention_bwd_plain``, given
    the forward's o and row statistics (their plain versions), twice, bit
    for bit. In bf16 at D 64 that is the sm90 kernel; the earlier kernel,
    which serves fp32 and other D, is held there too through its launcher,
    and the sm90 kernel once more on do and o in the fused block's
    (B, T, H, D) layouts, writing into one (B, T, 3, H, D) buffer."""
    from vitx_torch.kernels import (attention_bwd, attention_bwd_plain,
                                    attention_stats_plain,
                                    flash_attention_fwd_plain)

    q, k, v = (seeded(shape, s, 1.5, dtype=dtype) for s in (1, 2, 3))
    do = seeded(shape, 4, 0.1, dtype=dtype)
    o, stats = flash_attention_fwd_plain(q, k, v), attention_stats_plain(q, k)
    n90 = attention_bwd.launches_sm90
    out = attention_bwd(q, k, v, do, o, stats)
    torch.cuda.synchronize()
    on_sm90 = attention_bwd.launches_sm90 > n90
    name = "attention_bwd_sm90" if on_sm90 else "attention_bwd"
    bf = dtype == torch.bfloat16
    ref = attention_bwd_plain(q, k, v, do)
    info = {"shape": list(shape), "dtype": str(dtype)}
    check(phase, name, out, ref, tol, errs if bf else None, name, **info)
    again = attention_bwd(q, k, v, do, o, stats)
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{name} {info}: two calls differ")
    if on_sm90:
        tflash = attention_module()
        check(phase, "attention_bwd (the earlier kernel)",
              tflash._bwd_wmma(q, k, v, do), ref, tol, errs,
              "attention_bwd", **info)
        B, H, T, D = shape
        buf = torch.empty((B, T, 3, H, D), dtype=dtype, device="cuda")
        views = tuple(buf[:, :, i].transpose(1, 2) for i in range(3))
        attention_bwd(q, k, v, do.transpose(1, 2).contiguous().transpose(
            1, 2), o.transpose(1, 2).contiguous().transpose(1, 2), stats,
            out=views)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(views, out)):
            raise AssertionError(f"{name} {info}: strided do, o and dqkv "
                                 f"differ from the contiguous call")


def attention_module():
    """``vitx_torch.kernels.flash_attention`` (the package exports a
    function of the same name), for the earlier kernels' launchers."""
    import importlib

    return importlib.import_module("vitx_torch.kernels.flash_attention")


def check_entries_backward(shape, dtype, tol, errs: dict) -> None:
    """B11 through B3: autograd through ``fused_layer_norm`` and
    ``fused_add_layer_norm`` on the card against ``ln_bwd_plain`` on the
    2-D view; the add variant's dx, the sum's cotangent added, the same
    for x and r."""
    from vitx_torch.kernels import (fused_add_layer_norm, fused_layer_norm,
                                    ln_bwd_plain)

    E = shape[-1]
    bf = dtype == torch.bfloat16
    x = seeded(shape, 90, 2.0, 0.5, dtype=dtype)
    r = seeded(shape, 91, 1.0, dtype=dtype)
    dy, ds = (seeded(shape, s, 0.1, dtype=dtype) for s in (92, 93))
    sc, bi = seeded((E,), 94, 0.1, 1.0), seeded((E,), 95, 0.1)
    info = {"shape": list(shape), "dtype": str(dtype)}
    ts = [t.detach().requires_grad_() for t in (x, sc, bi)]
    grads = torch.autograd.grad(fused_layer_norm(*ts), ts, dy)
    torch.cuda.synchronize()
    dx, dsc, dbi = ln_bwd_plain(x.reshape(-1, E), sc, dy.reshape(-1, E))
    check("grad", "fused_layer_norm backward (dx, dscale, dbias)", grads,
          (dx.reshape(shape), dsc, dbi), tol, errs if bf else None,
          "ln_bwd_onepass", **info)
    ta = [t.detach().requires_grad_() for t in (x, r, sc, bi)]
    s, y = fused_add_layer_norm(*ta)
    grads = torch.autograd.grad((s, y), ta, (ds, dy))
    torch.cuda.synchronize()
    if not torch.equal(grads[0], grads[1]):
        raise AssertionError(f"B11 {info}: dx and dr differ")
    dx, dsc, dbi = ln_bwd_plain(s.detach().reshape(-1, E), sc,
                                dy.reshape(-1, E))
    check("grad", "fused_add_layer_norm backward (dx, dscale, dbias)",
          grads[1:], (dx.reshape(shape) + ds, dsc, dbi), tol,
          errs if bf else None, "ln_bwd_onepass", **info)


def check_backward_kernels(B, T, E, H, dtype, tol, errs: dict,
                           phase: str = "grad"):
    """B2 at (B, H, T, E / H) and B3 at (B, T, E) and the head's (B, 4E)
    against their plain versions in ``dtype``: B3 through ``ln_bwd`` on
    the route ``ln_bwd_route`` gives the width (one-pass up to E 4096,
    launches_onepass one a call), twice bit for bit, and its earlier
    kernel on the same inputs through the launcher."""
    import importlib

    from vitx_torch.kernels import ln_bwd, ln_bwd_plain

    tln = importlib.import_module("vitx_torch.kernels.layer_norm")
    bf = dtype == torch.bfloat16
    info = {"dtype": str(dtype), "batch": B}
    check_attention_bwd((B, H, T, E // H), dtype, tol, errs, phase)
    for shape in ((B, T, E), (B, 4 * E)):
        x = seeded(shape, 5, 2.0, 0.5, dtype=dtype)
        dy = seeded(shape, 6, 0.1, dtype=dtype)
        sc = seeded(shape[-1:], 7, 0.1, 1.0)
        En = shape[-1]
        onepass = tln.ln_bwd_route(dtype, En, (x, dy)) != 0
        name = "ln_bwd_onepass" if onepass else "ln_bwd"
        n1 = ln_bwd.launches_onepass
        out = ln_bwd(x, sc, dy)
        torch.cuda.synchronize()
        if (ln_bwd.launches_onepass == n1 + 1) != onepass:
            raise AssertionError(f"ln_bwd {shape} {dtype}: one-pass route "
                                 f"taken {not onepass}")
        ref = ln_bwd_plain(x, sc, dy)
        check(phase, f"ln_bwd, the wrapper's route ({name})", out, ref, tol,
              errs if bf else None, name, shape=list(shape), **info)
        bitwise(phase, f"ln_bwd ({name}), twice", ln_bwd(x, sc, dy), out,
                shape=list(shape), **info)
        if onepass:
            was = tln._launch(x.reshape(-1, En), sc, dy.reshape(-1, En),
                              1e-5, 0)
            check(phase, "ln_bwd, the earlier kernel",
                  (was[0].reshape(shape), *was[1:]), ref, tol,
                  errs if bf else None, "ln_bwd", shape=list(shape), **info)


# batches up to this hold autograd through the fused blocks against the
# CPU; larger ones against the plain versions' autograd on the card
GRAD_CPU_MAX_B = 8


def check_training_kernels(B, T, E, H, dtype, tol, gtol, errs: dict):
    """``check_backward_kernels``, the K1 and K2 stashes and autograd
    through both blocks at (B, T, E) in ``dtype``: against the plain
    versions on the CPU up to GRAD_CPU_MAX_B, on the card past it."""
    from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    info = {"dtype": str(dtype), "batch": B}
    check_backward_kernels(B, T, E, H, dtype, tol, errs)
    x, mha, mlp = block_inputs(B, T, E, H, 4 * E, dtype, 8, "cuda")
    out = fused_mha_block(x, **mha, stash=True)
    torch.cuda.synchronize()
    check("grad", "fused_mha_block stash (out, q, k, v, o_all)", out,
          mha_block_plain(x, **mha, stash=True), tol, **info)
    out = fused_mlp_block(x, **mlp, act="gelu_tanh", stash=True)
    torch.cuda.synchronize()
    check("grad", "fused_mlp_block stash (out, hp)", out,
          mlp_block_plain(x, **mlp, act="gelu_tanh", stash=True), tol,
          **info)
    del out
    dout = seeded((B, T, E), 9, 0.1, dtype=dtype)
    on_cpu = B <= GRAD_CPU_MAX_B
    for name, fn, plain, args in (
            ("fused_mha_block", fused_mha_block, mha_block_plain, mha),
            ("fused_mlp_block",
             lambda x, **a: fused_mlp_block(x, **a, act="gelu_tanh"),
             lambda x, **a: mlp_block_plain(x, **a, act="gelu_tanh"),
             mlp)):
        card = [x, *args.values()]
        dev = "cpu" if on_cpu else "cuda"
        ref = [t.detach().to(dev) for t in card]
        grads = []
        for f, ts, d in ((fn, card, dout), (plain, ref, dout.to(dev))):
            ts = [t.detach().requires_grad_() for t in ts]
            y = f(ts[0], **dict(zip(args, ts[1:])))
            grads.append(torch.autograd.grad(y, ts, d))
        torch.cuda.synchronize()
        against = "CPU" if on_cpu else "the plain versions on the card"
        check("grad", f"{name} autograd.grad, card vs {against}", grads[0],
              grads[1], gtol, **info)


def check_tome_autograd(B, T, E, H, dtype, tol, errs: dict) -> None:
    """B8 under grad as a ToMe-train step runs it: autograd through
    ``fused_mha_block_tome`` (the kernel forward, ``composed_tome``'s
    backward on autograd's thread, its LayerNorm's backward B3) with x and
    the weights requiring grad, the zero QKV bias and log_size not, and
    k_mean's cotangent zero (it feeds only the merge's selection). In bf16
    against ``composed_tome``'s own autograd on the card (out within
    BF16_TOL, gradients within ``tol``); in fp32 against the same on the
    CPU (plain versions). One B8 and one B3 launch a call."""
    from vitx_torch.kernels import (composed_tome, fused_mha_block_tome,
                                    ln_bwd)

    x, tm = tome_inputs(B, T, E, H, dtype, 80 + T)
    tm = dict(tm, bqkv=torch.zeros_like(tm["bqkv"]))
    names = ("x", "wqkv", "wo", "bo", "g", "b")
    w_out = seeded((B, T, E), 81 + T, 0.1, dtype=dtype)
    info = {"shape": [B, T, E], "heads": H, "dtype": str(dtype)}

    def grads_of(fn, device):
        ins = {k: (x if k == "x" else tm[k]).detach().to(device)
               .requires_grad_() for k in names}
        rest = {k: tm[k].to(device) for k in ("bqkv", "log_size")}
        out, k_mean = fn(ins["x"], ins["wqkv"], rest["bqkv"], ins["wo"],
                         ins["bo"], ins["g"], ins["b"], rest["log_size"])
        loss = (out.float() * w_out.to(device).float()).sum()
        return out.detach(), k_mean.detach(), torch.autograd.grad(
            loss, list(ins.values()))

    n8, n3 = fused_mha_block_tome.launches, ln_bwd.launches
    out, k_mean, grads = grads_of(fused_mha_block_tome, "cuda")
    torch.cuda.synchronize()
    got = (fused_mha_block_tome.launches - n8, ln_bwd.launches - n3)
    if got != (1, 1):
        raise AssertionError(f"B8 autograd {info}: launches (B8, B3) {got}")
    ref_dev = "cuda" if dtype == torch.bfloat16 else "cpu"
    r_out, r_km, r_grads = grads_of(composed_tome, ref_dev)
    against = ("composed_tome's autograd on the card"
               if ref_dev == "cuda" else "the CPU's plain versions")
    check("grad", f"fused_mha_block_tome forward (out, k_mean) vs "
          f"{against}", (out, k_mean), (r_out, r_km),
          BF16_TOL if dtype == torch.bfloat16 else FP32_TOL, **info)
    check("grad", f"fused_mha_block_tome autograd.grad ({', '.join(names)}) "
          f"vs {against}", grads, r_grads, tol, **info)


def phase_grad(errs: dict):
    from vitx_torch.kernels import adamw_plain, fused_adamw_

    E = 768
    # batch 8 in both dtypes, and the train main path's batch 128 in bf16
    for B, dtype, tol, gtol in ((8, torch.float32, FP32_TOL, FP32_TOL),
                                (8, torch.bfloat16, BF16_TOL, GRAD_BF16_TOL),
                                (128, torch.bfloat16, BF16_TOL,
                                 GRAD_BF16_TOL)):
        check_training_kernels(B, 197, E, 12, dtype, tol, gtol, errs)
    # the small16 recipe's train step: B2 at (128, 6, 197, 64), B3 at
    # (128, 197, 384) and the head's (128, 1536), the stashes and autograd
    # through both blocks
    check_training_kernels(128, 197, 384, 6, torch.bfloat16, BF16_TOL,
                           GRAD_BF16_TOL, errs)
    # the recipe's ToMe-train step: B8 under grad at its first two blocks'
    # tokens ((35, 34) merges: T 197, then 162), in bf16 against the
    # composed path's autograd, in fp32 against the CPU
    for T in (197, 162):
        check_tome_autograd(128, T, 384, 6, torch.bfloat16, GRAD_BF16_TOL,
                            errs)
        check_tome_autograd(128, T, 384, 6, torch.float32, FP32_TOL, errs)
    # B2 and B3 at Grad-CAM's large16_384 shapes: batch 1 (served) and 8
    for B in (1, 8):
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            check_backward_kernels(B, 577, 1024, 16, dtype, tol, errs)
    # past T = 1024, where vitx runs its q-chunked backward B6: the
    # fine-tune's tokens (T 1025) at batch 2 in both dtypes, with K1 and
    # K2's stash and autograd (B2 at (2, 12, 1025, 64) among them); B2 at a
    # ragged T of large16's heads and at T 2048; and B11, the
    # fused_layer_norm entries' backward, at batch 2 of T 1025 and at
    # base16's b256 rows
    for dtype, tol, gtol in ((torch.float32, FP32_TOL, FP32_TOL),
                             (torch.bfloat16, BF16_TOL, GRAD_BF16_TOL)):
        check_training_kernels(2, 1025, E, 12, dtype, tol, gtol, errs)
        for shape in ((1, 16, 1100, 64), (1, 12, 2048, 64)):
            check_attention_bwd(shape, dtype, tol, errs)
        for shape in ((2, 1025, E), (256, 197, E)):
            check_entries_backward(shape, dtype, tol, errs)
    # the fine-tune main path's own shapes, bf16 batch 32: K1's stash and
    # autograd through both blocks, B2 at (32, 12, 1025, 64) and B3 at
    # (32, 1025, 768) and the head's (32, 3072); B2 there in fp32 as well
    t0 = time.perf_counter()
    check_training_kernels(32, 1025, E, 12, torch.bfloat16, BF16_TOL,
                           GRAD_BF16_TOL, errs)
    check_attention_bwd((32, 12, 1025, 64), torch.float32, FP32_TOL, errs)
    emit({"phase": "grad", "part": "fine-tune shapes, batch 32",
          "seconds": time.perf_counter() - t0})
    # the transfer fine-tune's step, base16 at 384² (T 577) bf16 batch 32:
    # K1's stash, B2 at (32, 12, 577, 64), B3 at (32, 577, 768) and the
    # head's (32, 3072), autograd through both blocks
    t0 = time.perf_counter()
    check_training_kernels(32, 577, E, 12, torch.bfloat16, BF16_TOL,
                           GRAD_BF16_TOL, errs)
    emit({"phase": "grad", "part": "transfer shapes, T 577 batch 32",
          "seconds": time.perf_counter() - t0})
    # B12 on a base16 leaf (the stacked block W1), float32 and bf16 grads
    shape = (12, E, 4 * E)
    kw = dict(lr=1e-4, c1=0.271, c2=0.002997, b1=0.9, b2=0.999, eps=1e-8,
              wd=1e-4)
    for gdt in (torch.float32, torch.bfloat16):
        p = seeded(shape, 10, 0.02)
        g = seeded(shape, 11, 1e-3, dtype=gdt)
        mu = seeded(shape, 12, 1e-4)
        nu = seeded(shape, 13, 1e-6).abs()
        ref = adamw_plain(p, g, mu, nu, **kw)
        fused_adamw_(p, g, mu, nu, **kw)
        torch.cuda.synchronize()
        check("grad", "fused_adamw_ (p, mu, nu)", (p, mu, nu), ref,
              FP32_TOL, errs, "fused_adamw_", grad_dtype=str(gdt),
              elements=p.numel())
        bitwise("grad", "fused_adamw_ (p, mu, nu)", (p, mu, nu), ref)
    del p, g, mu, nu, ref
    check_adamw_multi(kw, errs)


def bitwise(phase: str, what: str, out, ref, **info) -> None:
    """Raise unless ``out`` and ``ref`` (sequences of tensors) agree bit
    for bit."""
    same = all(torch.equal(o, r) for o, r in zip(out, ref))
    emit({"phase": phase, "check": f"{what} bit for bit", "equal": same,
          **info})
    if not same:
        raise AssertionError(f"{what} {info}: not bit-identical")


def hold_adamw_multi(phase: str, what: str, ps, gs, mus, nus, kw,
                     errs: dict | None = None, **info) -> None:
    """B12's multi-leaf kernel over the leaves (ps, gs, mus, nus) against
    adamw_multi_plain on the same inputs: within FP32_TOL, then bit for
    bit, in one launch. Updates ps, mus and nus in place."""
    from vitx_torch.kernels import adamw_multi_plain, fused_adamw_multi_

    ref = adamw_multi_plain(ps, gs, mus, nus, **kw)
    n0 = fused_adamw_multi_.launches
    fused_adamw_multi_(ps, gs, mus, nus, **kw)
    torch.cuda.synchronize()
    got = fused_adamw_multi_.launches - n0
    info = {**info, "leaves": len(ps),
            "elements": sum(t.numel() for t in ps),
            "largest_leaf": max(t.numel() for t in ps), "launches": got}
    out, want = [*ps, *mus, *nus], [*ref[0], *ref[1], *ref[2]]
    check(phase, f"fused_adamw_multi_ (p, mu, nu), {what}", out, want,
          FP32_TOL, errs, "fused_adamw_multi_", **info)
    bitwise(phase, f"fused_adamw_multi_, {what}", out, want, **info)
    if got != 1:
        raise AssertionError(f"fused_adamw_multi_ {what} {info}: {got} "
                             f"launches, expected 1")


def check_adamw_multi(kw, errs: dict) -> None:
    """B12's multi-leaf kernel against adamw_multi_plain, bit for bit, one
    launch per call: every leaf of the base16 state, with fp32 and with
    bf16 gradients; then leaves of ragged sizes as views at element
    offsets 0-2 (scalar heads and tails, and pointers not co-aligned),
    with fp32 and bf16 gradients together: one launch per dtype."""
    import vitx_torch
    from vitx_torch.kernels import adamw_multi_plain, fused_adamw_multi_
    from vitx_torch.nn.vit import init_params
    from vitx_torch.train.step import leaves

    ps = leaves(init_params(0, vitx_torch.get_config("base16")))
    gen = torch.Generator("cuda").manual_seed(30)

    def rand(t, scale):
        return torch.randn(t.shape, device="cuda", generator=gen) * scale

    for gdt in (torch.float32, torch.bfloat16):
        gs = [rand(t, 1e-3).to(gdt) for t in ps]
        mus = [rand(t, 1e-4) for t in ps]
        nus = [rand(t, 1e-6).abs() for t in ps]
        hold_adamw_multi("grad", "every base16 leaf", ps, gs, mus, nus, kw,
                         errs, grad_dtype=str(gdt))
        del gs, mus, nus
    del ps
    sizes = (1, 3, 5, 1025, 65536 + 5, 3 * 768 * 768)
    for off in (0, 1, 2):
        def leaf(i, m, seed, scale, dtype=torch.float32, o=off):
            return seeded((m + 4,), seed + i, scale, dtype=dtype)[o:o + m]
        ps = [leaf(i, m, 200, 0.02) for i, m in enumerate(sizes)]
        # alternate leaves' gradients bf16, at another offset
        gs = [leaf(i, m, 210, 1e-3, torch.bfloat16 if i % 2 else
                   torch.float32, (off + i) % 3) for i, m in enumerate(sizes)]
        mus = [leaf(i, m, 220, 1e-4) for i, m in enumerate(sizes)]
        nus = [leaf(i, m, 230, 1e-6).abs() for i, m in enumerate(sizes)]
        ref = adamw_multi_plain(ps, gs, mus, nus, **kw)
        n0 = fused_adamw_multi_.launches
        fused_adamw_multi_(ps, gs, mus, nus, **kw)
        torch.cuda.synchronize()
        got = fused_adamw_multi_.launches - n0
        bitwise("grad", "fused_adamw_multi_, ragged views", [*ps, *mus, *nus],
                [*ref[0], *ref[1], *ref[2]], offset=off, sizes=list(sizes),
                launches=got)
        if got != 2:
            raise AssertionError(f"fused_adamw_multi_ at offset {off}: {got} "
                                 f"launches, expected 2 (fp32 and bf16 "
                                 f"gradients)")


def phase_forward(cfg, params):
    from vitx_torch import forward
    from vitx_torch.nn.vit import params_to

    rng = np.random.default_rng(1)
    images = rng.standard_normal(
        (8, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    reset_counts()
    logits = forward(params, images, cfg)
    torch.cuda.synchronize()
    n = counts()
    if n != forward_launches(cfg, 1):
        raise AssertionError(f"launches per forward {n}, expected "
                             f"{forward_launches(cfg, 1)}")
    t0 = time.perf_counter()
    ref = forward(params_to(params, "cpu"), images, cfg, device="cpu")
    cpu_s = time.perf_counter() - t0
    err = rel_err(logits.cpu(), ref)
    emit({"phase": "forward", "shape": list(logits.shape), "rel_err": err,
          "launches": n, "cpu_plain_s": round(cpu_s, 2)})
    if not (logits.shape == (8, cfg.num_classes)
            and torch.isfinite(logits).all() and err < 0.05):
        raise AssertionError(f"forward vs plain: rel err {err}")


def concurrent_predict(srv, imgs, threads: int = 8,
                       what: str = "serve") -> list:
    """Every image of ``imgs`` through ``srv.predict``, from ``threads``
    client threads."""
    results = [None] * len(imgs)

    def client(c):
        for i in range(c, len(imgs), threads):
            results[i] = srv.predict(imgs[i])

    pool = [threading.Thread(target=client, args=(c,))
            for c in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=600)
    if any(t.is_alive() for t in pool):
        raise AssertionError(f"{what}: clients did not finish")
    return results


def phase_serve(cfg, params, phase: str = "serve") -> dict:
    from vitx_torch import forward
    from vitx_torch.serve import InferenceServer

    rng = np.random.default_rng(2)
    imgs = rng.standard_normal(
        (64, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    reset_counts()
    with InferenceServer(params, cfg, batch_size=32, top_k=5,
                         max_delay_ms=20.0) as srv:
        results = concurrent_predict(srv, imgs, what=phase)
        stats = srv.stats.summary()
    launches = counts()
    forwards = 1 + stats["batches"]            # the warm-up, then batches
    expect_launches(f"{phase}: server", launches,
                    forward_launches(cfg, forwards))
    for lo in (0, 32):
        logits = forward(params, imgs[lo:lo + 32], cfg)
        probs, classes = torch.topk(torch.softmax(logits.float(), -1), 5)
        for i in range(32):
            got = results[lo + i]
            if got["classes"] != classes[i].tolist():
                raise AssertionError(f"request {lo + i}: served "
                                     f"{got['classes']}, direct "
                                     f"{classes[i].tolist()}")
            np.testing.assert_allclose(got["probs"], probs[i].cpu().numpy(),
                                       rtol=1e-6, atol=1e-9)
    if stats["requests"] != 64:
        raise AssertionError(f"stats count {stats['requests']} requests")
    emit({"phase": phase, "part": f"server, tome_r={cfg.tome_r}",
          "stats": stats, "launches": launches})
    return launches


def synthetic_batch(ds, n: int) -> dict:
    """The first ``n`` examples of a SyntheticDataset, stacked as vitx's
    BatchLoader stacks them: uint8 NHWC images and int32 labels."""
    ex = [ds.get_example(i) for i in range(n)]
    return {"image": np.stack([e[0] for e in ex]),
            "label": np.array([e[1] for e in ex], np.int32)}


def sm90(cfg) -> bool:
    """Whether ``cfg``'s attention forward (with or without
    probabilities) and its backward take the sm90 kernels: bf16 at head
    width 32, 64 or 128 (``vitx_torch.kernels.flash_attention.sm90_route``).
    """
    return cfg.compute_dtype == "bfloat16" and cfg.head_dim in SM90_WIDTHS


def head_lns(cfg) -> int:
    """The head's LayerNorms: the MAP head's input, MLP and output norms;
    one for the reference and standard heads."""
    return 3 if cfg.head_type == "map" else 1


def attention_passes(cfg) -> int:
    """The forward passes of a block's attention half in a train step: two
    where ``cfg.remat`` recomputes it in the backward ("block", "dots";
    "save_stash" off K1's route, where it keeps no stash), else one."""
    if cfg.remat in ("block", "dots"):
        return 2
    return 2 if cfg.remat == "save_stash" and cfg.pos_embed == "rope" else 1


def expected_train_launches(cfg, steps: int, fused_steps: int,
                            grad_dtypes: int = 1, passes: int = 1) -> dict:
    """Launches per the code's routing: one K1 (B5 on RoPE's composed
    path) and one B2 per block, B2 on its sm90 route in bf16 at D 64; B3
    for LN1 (inside K1's backward, or the composed path's add-LayerNorm)
    and LN2 of every block (a Soft-MoE block's too), the head's
    LayerNorms and the final norm; K2 off under grad (fuse_mlp "auto");
    B12's multi-leaf kernel once per gradient dtype in the fused steps,
    its one-leaf kernel never. ``cfg.remat`` runs K1 again in the
    backward (``attention_passes``); ``passes`` forward and backward
    passes a step (SAM's 2) multiply all but B12."""
    b3 = 2 * cfg.depth + head_lns(cfg) + int(cfg.final_norm)
    n = cfg.depth * steps * passes
    return block_launches(cfg, **attention_launches(
                              cfg, n * attention_passes(cfg)),
                          attention_bwd=n,
                          attention_bwd_sm90=n * sm90(cfg),
                          ln_bwd=b3 * steps * passes,
                          fused_adamw_multi_=grad_dtypes * fused_steps)


def leaf_names(tree, prefix: str = "") -> list:
    """The "a/b/c" paths of ``leaves(tree)``, in its order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def param_gap(gc, gh, pc, ph, lr: float, eps: float, names) -> dict:
    """Hold the params after one Adam step from zero moments on the card
    (``pc``, gradients ``gc``) to those on the CPU (``ph``, ``gh``).

    That step moves an element by lr * (u(g) + wd * p), u(g) = g / (|g| +
    eps). With d the leaf's largest gradient difference, the two moves
    differ by at most lr * (u(|g| + d) + u(|g|)) in any case, and by at most
    lr * eps * d / (|g| - d + eps)**2 where |g| > d (mean value theorem).
    Each element is held to the smaller of the two, plus 1e-4 lr for the
    update's rounding and one ulp of the new param. ``worst`` is the
    largest gap over its allowance, ``worst_at`` the element that sets it:
    its leaf (named by ``names``) and index, both gradients, d, the margin
    |g| - d, and the allowance's three terms. ``loose_share`` is the share
    of elements whose allowance exceeds lr / 2 (a sign the two steps may
    not share)."""
    worst, loose, total, at = 0.0, 0, 0, {}
    for name, a, b, p_card, p_host in zip(names, gc, gh, pc, ph):
        d = float((a - b).abs().max())
        g = b.abs()
        bound = (g + d) / (g + d + eps) + g / (g + eps)
        mvt = eps * d / (g - d + eps) ** 2
        bound = torch.where(g > d, torch.minimum(bound, mvt), bound)
        size = p_host.abs()
        ulp = torch.nextafter(size, torch.full_like(size, np.inf)) - size
        allow = lr * (1e-4 + bound) + ulp
        gap = (p_card - p_host).abs()
        ratio = (gap / allow).reshape(-1)
        i = int(ratio.argmax())
        if float(ratio[i]) > worst:
            worst = float(ratio[i])
            at = {"leaf": name, "index": [int(j) for j in np.unravel_index(
                      i, tuple(g.shape))],
                  "grad_cpu": float(b.reshape(-1)[i]),
                  "grad_card": float(a.reshape(-1)[i]), "leaf_grad_gap": d,
                  "grad_margin": float(g.reshape(-1)[i]) - d,
                  "param_gap": float(gap.reshape(-1)[i]),
                  "allow_rounding": lr * 1e-4,
                  "allow_step": lr * float(bound.reshape(-1)[i]),
                  "allow_ulp": float(ulp.reshape(-1)[i])}
        loose += int((bound > 0.5).sum())
        total += g.numel()
    return {"worst": worst, "worst_at": at, "loose_share": loose / total,
            "elements": total}


def check_step_card_vs_cpu(phase, part, cfg, card, host, batch, lr,
                           seed=None) -> None:
    """One fp32 train_step of ``cfg`` from the same params on the card and
    on the CPU (plain versions): the loss, grad_norm and the gradients of
    the step's loss agree to FP32_TOL of each leaf's largest; each param
    within its ``param_gap`` allowance. The steps update both trees. With
    ``seed``, the loss and the step each get a generator seeded with it
    (patch dropout, under ``host_drawn_patch_noise``)."""
    from vitx_torch.train import TrainState, make_optimizer, train_step
    from vitx_torch.train.step import leaves, loss_fn, tree_map

    opt = make_optimizer(lr=lr)
    out = []
    for params, dev in ((card, "cuda"), (host, "cpu")):
        def gen():
            return (None if seed is None else
                    torch.Generator(device=dev).manual_seed(seed))

        t0 = time.perf_counter()
        req = tree_map(lambda t: t.detach().requires_grad_(), params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        grads = torch.autograd.grad(loss_fn(req, b, cfg, gen())[0],
                                    leaves(req))
        state = TrainState(0, params, opt.init(params))
        state, m = train_step(state, batch, gen(), cfg=cfg, optimizer=opt,
                              device=dev)
        out.append(([g.cpu() for g in grads], [t.cpu() for t in
                                                leaves(state.params)],
                    {k: float(v) for k, v in m.items()},
                    time.perf_counter() - t0))
    (gc, pc, mc, card_s), (gh, ph, mh, cpu_s) = out
    errs = {k: abs(mc[k] - mh[k]) / abs(mh[k]) for k in ("loss", "grad_norm")}
    errs["grads"] = max(rel_err(a, b) for a, b in zip(gc, gh))
    p_err = param_gap(gc, gh, pc, ph, lr, opt.eps, leaf_names(host))
    emit({"phase": phase, "part": part, "card": mc, "cpu": mh,
          "rel_err": errs, "params": p_err, "tol": FP32_TOL,
          "card_s": card_s, "cpu_s": cpu_s})
    if not (max(errs.values()) <= FP32_TOL and p_err["worst"] <= 1.0):
        raise AssertionError(f"{part}: {errs}, {p_err}")


def phase_train(ds) -> tuple:
    """(a) one fp32 step at depth 2, card vs CPU; (b) the bf16 main path.
    Returns (the main path's launches, its state, its batch, the step)."""
    import vitx_torch
    from vitx_torch.nn.vit import init_params, params_to
    from vitx_torch.train import (create_train_state, eval_step,
                                  make_optimizer, make_train_step)
    from vitx_torch.train.step import leaves

    # (a) base16 at depth 2, batch 4, fp32: card against CPU
    cfg2 = vitx_torch.get_config("base16", depth=2, compute_dtype="float32")
    host = init_params(1, cfg2, device="cpu")
    check_step_card_vs_cpu("train", "a: base16 depth 2 fp32, card vs CPU",
                           cfg2, params_to(host, "cuda"), host,
                           synthetic_batch(ds, 4), 1e-4)

    # (b) the main path: full base16, bf16, batch 128
    cfg = vitx_torch.get_config("base16")
    batch = synthetic_batch(ds, 128)
    opt = make_optimizer(lr=1e-4)
    fused = make_optimizer(lr=1e-4, fused=True)
    state = create_train_state(0, cfg, opt)
    step, fused_step = (make_train_step(cfg, o) for o in (opt, fused))
    # the gradients take their params' dtypes
    grad_dtypes = len({t.dtype for t in leaves(state.params)})
    losses = []
    reset_counts()
    t0 = time.perf_counter()
    for i in range(25):
        state, m = (step if i < 20 else fused_step)(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    losses = [float(v) for v in losses]
    expect = expected_train_launches(cfg, 25, 5, grad_dtypes)
    cm, eval_loss = eval_step(state.params, batch, cfg=cfg)
    emit({"phase": "train", "part": "b: base16 bf16 batch 128, 20 + 5 "
          "fused steps", "losses": losses, "launches": launches,
          "expected": expect, "wall_s": wall, "eval_loss": float(eval_loss),
          "eval_accuracy": float(cm.diagonal().sum()) / float(cm.sum())})
    if launches != expect:
        raise AssertionError(f"train launches {launches}, expected {expect}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and min(losses[-5:]) < min(losses[:5])):
        raise AssertionError(f"train loss did not fall: {losses}")
    if int(cm.sum()) != 128 or not np.isfinite(float(eval_loss)):
        raise AssertionError(f"eval_step: {int(cm.sum())} rows counted, "
                             f"loss {float(eval_loss)}")
    return launches, state, batch, step


def export_vit(params, path) -> None:
    """``params`` as vitx's ``--export-vit`` writes them: a bare ``.npz``
    of flat "a/b/c" keys (``vitx/cli/pretrain.py:286-288``)."""
    flat = {}

    def walk(node, prefix):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key], f"{prefix}{key}/")
            else:
                flat[prefix + key] = node[key].detach().cpu().numpy()

    walk(params, "")
    np.savez(path, **flat)


def phase_finetune(ds) -> tuple:
    """Main path 5: ViT-B/16 fine-tuned at 512² (T 1025) from a 224²
    export. (a) the export read into the 512² config on the card and on
    the CPU; (b) depth 2 fp32, card vs CPU; (c) the main path, full base16
    bf16 at batch 32; (d) the fused_layer_norm entries, forward and
    backward, on the fine-tune's tokens. Returns ((c) and (d)'s launches,
    the config, the state, the batch, the step)."""
    import tempfile
    import warnings

    import vitx_torch
    from vitx_torch import (fused_add_layer_norm, fused_layer_norm,
                            layer_norm_fwd_plain, params_from_jax)
    from vitx_torch.nn.vit import init_params
    from vitx_torch.train import (TrainState, eval_step, make_optimizer,
                                  make_train_step)

    src = vitx_torch.get_config("base16")
    cfg = src.replace(image_size=512)

    # (a) a seed-0 base16 224² export, read into the 512² config
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        path = Path(tmp) / "base16_224.npz"
        export_vit(init_params(0, src, device="cpu"), path)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            card = params_from_jax(path, cfg)
            host = params_from_jax(path, cfg, device="cpu")
    notes = sorted({str(w.message).split(": ", 1)[1] for w in caught})
    gap = float((card["pos_embed"].cpu() - host["pos_embed"]).abs().max())
    emit({"phase": "finetune", "part": "a: base16 224² export read into "
          "512², card vs CPU", "warnings": notes, "pos_embed_gap": gap,
          "shape": list(card["pos_embed"].shape), "tol": 1e-6})
    if (notes != ["pos_embed resized from 197 to 1025 positions (grid "
                  "32x32)"] or gap > 1e-6
            or card["pos_embed"].shape != (1, cfg.pos_len, cfg.embed_dim)):
        raise AssertionError(f"(a) export read: {notes}, gap {gap}")

    # (b) depth 2 fp32, batch 2, T 1025: card against CPU, the first two
    # blocks of the export
    cfg2 = cfg.replace(depth=2, compute_dtype="float32")
    check_step_card_vs_cpu("finetune", "b: base16 512² depth 2 fp32 b2, "
                           "card vs CPU", cfg2, first_blocks(card),
                           first_blocks(host), synthetic_batch(ds, 2), 1e-4)
    del host

    # (c) the main path: full base16 at 512², bf16, batch 32, one batch
    # repeated for 10 steps
    batch = synthetic_batch(ds, 32)
    opt = make_optimizer(lr=1e-4)
    state = TrainState(0, card, opt.init(card))
    step = make_train_step(cfg, opt)
    losses = []
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    losses = [float(v) for v in losses]
    expect = expected_train_launches(cfg, 10, 0)
    cm, eval_loss = eval_step(state.params, batch, cfg=cfg)
    emit({"phase": "finetune", "part": "c: base16 512² bf16 batch 32, 10 "
          "steps", "losses": losses, "launches": got, "expected": expect,
          "wall_s": wall, "eval_loss": float(eval_loss)})
    expect_launches("(c) fine-tune steps", got, expect)
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and min(losses[-3:]) < min(losses[:3])):
        raise AssertionError(f"fine-tune loss did not fall: {losses}")
    if int(cm.sum()) != 32 or not np.isfinite(float(eval_loss)):
        raise AssertionError(f"eval_step: {int(cm.sum())} rows counted, "
                             f"loss {float(eval_loss)}")

    # (d) the public entries on the fine-tune's tokens: the pre-LN
    # residual pattern s, h = x + r, LN(x + r), a second LN of h, and the
    # gradients of every input
    shape = (32, cfg.seq_len, cfg.embed_dim)
    bf = torch.bfloat16
    x = seeded(shape, 96, 1.0, dtype=bf).requires_grad_()
    r = seeded(shape, 97, 0.1, dtype=bf).requires_grad_()
    lnp = [seeded((cfg.embed_dim,), 98 + i, 0.1, 1.0 if i % 2 == 0 else 0.0)
           .requires_grad_() for i in range(4)]
    snap = counts()
    s, h = fused_add_layer_norm(x, r, lnp[0], lnp[1])
    y = fused_layer_norm(h, lnp[2], lnp[3])
    grads = torch.autograd.grad(y.float().square().mean() + s.float().mean(),
                                [x, r, *lnp])
    torch.cuda.synchronize()
    got_d = delta(snap)
    expect_launches("(d) entries", got_d, launches_of(
        fused_add_layer_norm=1, fused_layer_norm=1, ln_bwd=2))
    with torch.no_grad():
        ref_s, ref_h = layer_norm_fwd_plain(x, lnp[0], lnp[1], r)
        ref_y = layer_norm_fwd_plain(ref_h, lnp[2], lnp[3])
    check("finetune", "d: fused_add_layer_norm then fused_layer_norm at "
          "(32, 1025, 768) bf16 vs plain", (s, h, y), (ref_s, ref_h, ref_y),
          BF16_TOL, launches=got_d)
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("(d) entries: gradients not finite")
    del x, r, s, h, y, grads
    return add_launches(got, got_d), cfg, state, batch, step


# the small16 recipe of CONVERGENCE.md without ToMe-train: the train CLI's
# flags; the cuts for a card run are its split (1024 + 256 images, not
# 12800 + 2560), --warmup-steps 10 (not 300: 24 steps in all) and 3 epochs
RECIPE_DATA = "procedural:1024,256"
RECIPE_ARGS = ["--preset", "small16", "--data", RECIPE_DATA,
               "--device-cache", "--batch-size", "128", "--lr", "3e-4",
               "--schedule", "cosine", "--warmup-steps", "10",
               "--weight-decay", "0.05", "--wd-exclude", "--randaug", "5",
               "--ema-decay", "0.999", "--early-stop", "10", "--seed", "0",
               "--log-every", "4"]
RECIPE_EPOCHS, RECIPE_TRAIN, RECIPE_VAL = 3, 1024, 256
# CONVERGENCE.md's two other variants of the recipe, with the flags of
# examples/convergence.py:51-55 (VARIANTS), and the phase's part for each
RECIPE_VARIANTS = {"tome": ("g", ["--tome-r", "to128", "--tome-train"]),
                   "pdrop": ("h", ["--patch-drop", "0.5"])}
# the recipe's main paths, by the name their launches are reported under
RECIPE_PATHS = ("recipe", *(f"recipe_{v}" for v in RECIPE_VARIANTS))
# recipe (a)'s params and EMA after 8 steps, card vs CPU, in units of the
# peak lr: the bar tests/test_torch_train.py holds a trajectory to
RECIPE_PARAM_BAR = 0.05


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run_cli(main_fn, argv) -> dict:
    """``main_fn(argv)`` with its printed lines passed on; its last line
    (a JSON object) returned. A non-zero exit raises."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    text = buf.getvalue()
    print(text, end="", flush=True)
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__} {argv}: exit {rc}")
    return json.loads(text.strip().splitlines()[-1])


def read_scalars(log_dir: Path, tag: str) -> list:
    """(step, value) of ``tag`` as the trainer's ScalarWriter logged it:
    its scalars.jsonl, or its TensorBoard events where tensorboard
    imports."""
    jsonl = log_dir / "scalars.jsonl"
    if jsonl.exists():
        rows = [json.loads(x) for x in jsonl.read_text().splitlines()]
        return [(r["step"], r["value"]) for r in rows if r["tag"] == tag]
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return [(e.step, e.value) for e in acc.Scalars(tag)]


def ckpt_leaves(path) -> list:
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]


def recipe_step_launches(cfg, steps: int, eval_batches: int) -> dict:
    """A recipe run's launches: per train step K1 and B2 in every block
    (sm90 in bf16 at D 64) and B3 for both LayerNorms of every block and
    the reference head's; per eval batch K1 and K2 in every block; B12
    never (the EMA and wd_exclude keep the plain update, vitx's rule).
    Patch dropout changes the tokens, not the launches. Under
    ``tome_train`` B8 takes K1's place in the step (its backward is the
    composed path's, whose LayerNorm runs B3; no B2) and in the eval
    batches, which merge."""
    b3 = 2 * cfg.depth + (cfg.head_type == "reference") + int(cfg.final_norm)
    if cfg.tome_train:
        return block_launches(
            cfg, fused_mha_block_tome=cfg.depth * (steps + eval_batches),
            fused_mlp_block=cfg.depth * eval_batches, ln_bwd=b3 * steps)
    return block_launches(
        cfg, fused_mha_block=cfg.depth * (steps + eval_batches),
        fused_mlp_block=cfg.depth * eval_batches,
        attention_bwd=cfg.depth * steps,
        attention_bwd_sm90=cfg.depth * steps * sm90(cfg),
        ln_bwd=b3 * steps)


class LossRecorder:
    """A Trainer mixin that keeps every flushed (loss, grad_norm)."""

    def _flush(self, pending, writer):
        self.__dict__.setdefault("recorded", []).extend(
            (float(m["loss"]), float(m["grad_norm"])) for _, m in pending)
        return super()._flush(pending, writer)


@contextlib.contextmanager
def host_drawn_patch_noise():
    """Patch dropout's noise drawn on the CPU from the seed of the step's
    generator, then moved to the tokens' device: the same kept tokens on
    the card and on the CPU, whose generators draw different streams (the
    trainer seeds each step's generator alike on every device)."""
    import vitx_torch.nn.vit as tvit

    orig = tvit._patch_drop

    def drop(x, cfg, gen=None, noise=None):
        host = torch.Generator().manual_seed(gen.initial_seed())
        noise = torch.rand((x.shape[0], cfg.num_patches), generator=host)
        return orig(x, cfg, noise=noise.to(x.device))

    tvit._patch_drop = drop
    try:
        yield
    finally:
        tvit._patch_drop = orig


def recipe_card_vs_cpu(root: Path, variant: str | None = None) -> None:
    """(a) small16 at depth 2, fp32, card against CPU (plain versions)
    from the same params: the first step as train (a) holds it
    (``check_step_card_vs_cpu``: gradients within FP32_TOL, params within
    ``param_gap``'s allowance), then two epochs of Trainer with the
    recipe's optimizer (cosine, EMA, wd_exclude) and clipping, no
    augmentation: every step's loss and grad_norm within FP32_TOL, val
    accuracies equal, the params and the EMA within RECIPE_PARAM_BAR.
    ``param_gap`` bounds one Adam step from zero moments; past it the
    moments carry each step's gradient error into the next update, so the
    run is held as ``tests/test_torch_train.py`` holds a trajectory: in
    units of the step size. ``variant`` "tome" trains through ToMe at the
    recipe's (35, 34) schedule, its merges' sources first held equal on
    the first batch; "pdrop" drops half the patches, the noise drawn alike
    on both devices (``host_drawn_patch_noise``)."""
    import vitx_torch
    from vitx_torch.data import BatchLoader, ProceduralShapes, make_preprocess
    from vitx_torch.nn.tome import aligned_schedule, encode_tome
    from vitx_torch.nn.vit import init_params, params_to
    from vitx_torch.train.step import tree_map

    cfg = vitx_torch.get_config("small16", depth=2, compute_dtype="float32",
                                num_classes=10)
    part = "a" if variant is None else RECIPE_VARIANTS[variant][0] + "/a"
    what = f"{part}: small16 depth 2 fp32" + {
        None: "", "tome": ", tome_train (35, 34)",
        "pdrop": ", patch_drop 0.5"}[variant]
    if variant == "tome":
        cfg = cfg.replace(tome_r=aligned_schedule(cfg, 128), tome_train=True)
    elif variant == "pdrop":
        cfg = cfg.replace(patch_drop=0.5)
    train_ds = ProceduralShapes(num_examples=32, seed=0)
    val_ds = ProceduralShapes(num_examples=16, seed=1)
    host = init_params(1, cfg, device="cpu")
    pre = make_preprocess(out_size=224, mean=(0.5,) * 3, std=(0.5,) * 3,
                          random_flip=False)
    lr, steps = 3e-4, 8
    first = next(iter(BatchLoader(train_ds, 8, shuffle=True, seed=0)))
    first["image"] = pre(torch.from_numpy(first["image"]), None,
                         train=False).numpy()
    if variant == "tome":
        with torch.no_grad():
            src = [encode_tome(params_to(host, dev), torch.from_numpy(
                first["image"]).to(dev), cfg, return_sources=True)[1].cpu()
                for dev in ("cuda", "cpu")]
        same = torch.equal(*src)
        emit({"phase": "recipe", "part": f"{what}: the merges' sources on "
              "the first batch, card vs CPU", "schedule": cfg.tome_r,
              "equal": same})
        if not same:
            raise AssertionError(f"recipe {part}: the card merges other "
                                 f"tokens than the CPU")
    with host_drawn_patch_noise():
        check_step_card_vs_cpu("recipe", f"{what}, the first step, card vs "
                               "CPU", cfg, params_to(host, "cuda"),
                               tree_map(torch.clone, host), first, lr,
                               seed=0 if variant == "pdrop" else None)
        recipe_trainers_card_vs_cpu(root, cfg, host, what, train_ds, val_ds,
                                    pre, lr, steps)


def recipe_trainers_card_vs_cpu(root, cfg, host, what, train_ds, val_ds,
                                pre, lr, steps) -> None:
    """Two epochs of the recipe's Trainer from ``host`` on the card and on
    the CPU, held as ``recipe_card_vs_cpu`` says."""
    from vitx_torch.data import BatchLoader
    from vitx_torch.nn.vit import params_to
    from vitx_torch.train import TrainState, make_optimizer, warmup_cosine
    from vitx_torch.train.loop import Trainer, TrainerConfig
    from vitx_torch.train.step import leaves

    sched = warmup_cosine(lr, steps, 2)
    runs = {}
    for dev in ("cuda", "cpu"):
        params = params_to(host, dev)
        opt = make_optimizer(lr=lr, schedule=sched, weight_decay=0.05,
                             grad_clip=1.0, ema_decay=0.9, wd_exclude=True)
        tcfg = TrainerConfig(epochs=2, lr=lr, weight_decay=0.05,
                             wd_exclude=True, grad_clip=1.0, ema_decay=0.9,
                             log_every=1, checkpoint_dir=str(root / dev))
        tr = type("Recording", (LossRecorder, Trainer), {})(
            cfg, tcfg, preprocess=pre, optimizer=opt, lr_schedule=sched,
            init_state=TrainState(0, params, opt.init(params)), device=dev)
        t0 = time.perf_counter()
        hist = tr.fit(BatchLoader(train_ds, 8, shuffle=True, seed=0),
                      BatchLoader(val_ds, 8))
        runs[dev] = (tr, hist, time.perf_counter() - t0)
    (card, hc, card_s), (cpu, hh, cpu_s) = runs["cuda"], runs["cpu"]
    lc, lh = np.array(card.recorded), np.array(cpu.recorded)
    step_err = float((np.abs(lc - lh) / np.abs(lh)).max())
    accs = [[h["val_accuracy"] for h in hist] for hist in (hc, hh)]
    names = leaf_names(host)
    gaps = {}
    for tree, a, b in (("params", card.state.params, cpu.state.params),
                       ("ema", card.state.opt_state.ema,
                        cpu.state.opt_state.ema)):
        per_leaf = [float((x.cpu() - y).abs().max())
                    for x, y in zip(leaves(a), leaves(b))]
        i = int(np.argmax(per_leaf))
        gaps[tree] = {"max_abs": per_leaf[i], "leaf": names[i],
                      "in_lr": per_leaf[i] / lr}
    emit({"phase": "recipe", "part": f"{what}, two epochs of Trainer, "
          "card vs CPU", "steps": len(lc),
          "loss_grad_norm_rel_err": step_err, "val_accuracy": accs,
          "losses_card": lc[:, 0].tolist(), "gaps": gaps,
          "param_bar": RECIPE_PARAM_BAR * lr, "tol": FP32_TOL,
          "card_s": card_s, "cpu_s": cpu_s})
    if not (len(lc) == len(lh) == steps and step_err <= FP32_TOL
            and accs[0] == accs[1]
            and all(g["max_abs"] <= RECIPE_PARAM_BAR * lr
                    for g in gaps.values())):
        raise AssertionError(f"recipe {what}: steps {step_err}, accs "
                             f"{accs}, gaps {gaps}")


def recipe_times(args: list, cfg, what: str = "recipe") -> None:
    """(f) The recipe's times on this card (``args``: the train CLI's, a
    variant's flags included; ``cfg`` the config they train): the
    preprocessing's share of a step (CUDA events around ``preprocess`` and
    around ``train_step``, one epoch), the profiler's device busy share
    over the next epoch, the eval's img/s."""
    import vitx_torch.cli.train as train_cli

    parser = train_cli.build_argparser()
    tr, train_loader, eval_loader = train_cli.build_trainer(
        parser.parse_args(args + ["--epochs", "2"]), parser)
    pre, step = tr.preprocess, tr.train_step
    events = {"preprocess": [], "train_step": []}

    def timed(name, fn):
        def call(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            events[name].append((start, end))
            return out
        return call

    tr.preprocess = timed("preprocess", pre)
    tr.train_step = timed("train_step", step)
    t0 = time.perf_counter()
    tr._train_epoch(train_loader, 0, None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = {k: sum(s.elapsed_time(e) for s, e in v) for k, v in events.items()}
    tr.preprocess, tr.train_step = pre, step
    busy_ms = profile_call(f"{what} train epoch ({RECIPE_TRAIN // 128} "
                           "steps)",
                           lambda: tr._train_epoch(train_loader, 1, None),
                           top=16)
    t0 = time.perf_counter()
    em = tr.evaluate(eval_loader)
    eval_s = time.perf_counter() - t0
    # (b) asserted its launches equal to these
    per_step = {k: v for k, v in recipe_step_launches(cfg, 1, 0).items()
                if v}
    per_eval = {k: v for k, v in recipe_step_launches(cfg, 0, 1).items()
                if v}
    emit({"phase": "times", "what": what, "card": smi(),
          "epoch_wall_s": wall, "img_per_s": RECIPE_TRAIN / wall,
          "steps": len(events["train_step"]),
          "preprocess_ms": ms["preprocess"],
          "train_step_ms": ms["train_step"],
          "preprocess_share": ms["preprocess"] / (ms["preprocess"]
                                                  + ms["train_step"]),
          "epoch_device_ms": busy_ms,
          "eval_img_per_s": RECIPE_VAL / eval_s, "eval_s": eval_s,
          "eval_accuracy": em["accuracy"], "launches_per_step": per_step,
          "launches_per_eval_batch": per_eval})


def phase_recipe() -> dict:
    """Main path 6, CONVERGENCE.md's ViT-S/16 recipe and its variants:
    (a) card vs CPU at depth 2 (``recipe_card_vs_cpu``); (b) the recipe at
    small16's full width and depth through ``vitx_torch.cli.train.main``,
    3 epochs, launches asserted; (c) a resume: 2 epochs, then ``--epochs
    3`` on the same directory, equal to (b) bit for bit; (d) the eval CLI
    on (b)'s directory reports the accuracy the trainer logged; (e) a
    server from (b)'s last .ckpt answers 32 requests as direct calls on
    the EMA params do (``serve_ckpt``); (f) times (``recipe_times``);
    (g) and (h) the ToMe-train and patch-drop variants
    (``recipe_variant``). Returns the launches of (b), (g) and (h) by
    path name ("recipe", "recipe_tome", "recipe_pdrop")."""
    import os
    import shutil

    import vitx_torch.cli.eval as eval_cli
    import vitx_torch.cli.train as train_cli
    from vitx_torch.data.procedural import ProceduralShapes
    from vitx_torch.train import checkpoint as ckpt

    root = BUILD / "recipe"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    os.environ.setdefault("VITX_PROC_CACHE", str(BUILD / "procdata"))
    recipe_card_vs_cpu(root / "a")

    # (b) the recipe at full small16
    t0 = time.perf_counter()
    for n, seed in ((RECIPE_TRAIN, 0), (RECIPE_VAL, 1)):   # the disk cache
        ProceduralShapes(num_examples=n, seed=seed,
                         cache_dir=os.environ["VITX_PROC_CACHE"]
                         ).materialize()
    gen_s = time.perf_counter() - t0
    b_dir, logs = root / "b", root / "b_logs"
    reset_counts()
    t0 = time.perf_counter()
    final = run_cli(train_cli.main, RECIPE_ARGS + [
        "--epochs", str(RECIPE_EPOCHS), "--checkpoint-dir", str(b_dir),
        "--log-dir", str(logs)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    cfg = ckpt.resolve_artifact_config(b_dir, None, "small16")
    steps = RECIPE_EPOCHS * (RECIPE_TRAIN // 128)
    eval_batches = RECIPE_EPOCHS * (RECIPE_VAL // 128)
    expect = recipe_step_launches(cfg, steps, eval_batches)
    losses = [v for _, v in read_scalars(logs, "Loss/train_batch")]
    rates = [v for _, v in read_scalars(logs, "Throughput/images_per_sec")]
    val = [v for _, v in read_scalars(logs, "val?acc")]
    metas = [ckpt.peek_meta(b_dir / f"{e}.ckpt")
             for e in range(RECIPE_EPOCHS)]
    emit({"phase": "recipe", "part": "b: small16 bf16 b128, the recipe "
          "through vitx_torch.cli.train.main", "card": smi(),
          "argv": RECIPE_ARGS, "epochs": RECIPE_EPOCHS,
          "cuts": {"split": RECIPE_DATA, "warmup_steps": 10,
                   "epochs": RECIPE_EPOCHS, "log_every": 4},
          "generate_s": gen_s, "wall_s": wall, "launches": launches,
          "expected": expect, "losses": losses, "val_accuracy": val,
          "img_per_s_by_epoch": rates,
          "steady_img_per_s": statistics.mean(rates[1:]), "final": final})
    expect_launches("recipe (b)", launches, expect)
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if not (len(losses) == steps and np.all(np.isfinite(losses))
            and last < first):
        raise AssertionError(f"recipe (b): losses {losses}")
    for m in metas:
        if not (m["ema_decay"] == 0.999 and m["schedule"]
                and m["config"]["embed_dim"] == 384):
            raise AssertionError(f"recipe (b): checkpoint meta {m}")

    # (c) resume: the CLI's 3-epoch trainer stopped after 2 epochs (a
    # second call with --epochs 2 would anneal the cosine over 16 steps,
    # not 24: its horizon is --epochs x the epoch's steps, vitx's rule),
    # then --epochs 3 on the same directory
    import dataclasses

    c_dir = root / "c"
    parser = train_cli.build_argparser()
    tr, train_loader, eval_loader = train_cli.build_trainer(
        parser.parse_args(RECIPE_ARGS + ["--epochs", str(RECIPE_EPOCHS),
                                         "--checkpoint-dir", str(c_dir)]),
        parser)
    tr.tcfg = dataclasses.replace(tr.tcfg, epochs=RECIPE_EPOCHS - 1)
    tr.fit(train_loader, eval_loader)
    del tr, train_loader, eval_loader
    run_cli(train_cli.main, RECIPE_ARGS + ["--epochs", str(RECIPE_EPOCHS),
                                           "--checkpoint-dir", str(c_dir)])
    last_ckpt = f"{RECIPE_EPOCHS - 1}.ckpt"
    got, want = ckpt_leaves(c_dir / last_ckpt), ckpt_leaves(b_dir / last_ckpt)
    differ = [i for i, (a, b) in enumerate(zip(got, want))
              if not np.array_equal(a, b)]
    meta_c = ckpt.peek_meta(c_dir / last_ckpt)
    emit({"phase": "recipe", "part": "c: 2 of 3 epochs, then a resumed "
          "call with --epochs 3, vs (b)",
          "leaves": len(want), "differ": differ[:20],
          "max_abs_gap": max((float(np.abs(got[i] - want[i]).max())
                              for i in differ), default=0.0),
          "step": meta_c["step"]})
    if differ or meta_c["step"] != steps or len(got) != len(want):
        raise AssertionError(f"recipe (c): leaves {differ[:20]} differ "
                             f"from the uninterrupted run")

    # (d) the eval CLI on (b)'s directory
    report = run_cli(eval_cli.main, [
        "--preset", "small16", "--checkpoint", str(b_dir), "--data",
        RECIPE_DATA, "--batch-size", "128"])
    emit({"phase": "recipe", "part": "d: vitx_torch.cli.eval on (b)",
          "accuracy": report["accuracy"], "logged": val[-1],
          "epoch": report["epoch"]})
    if not (report["accuracy"] == val[-1] == final["val_accuracy"]
            and report["epoch"] == RECIPE_EPOCHS - 1
            and report["num_examples"] == RECIPE_VAL):
        raise AssertionError(f"recipe (d): eval {report}, logged {val}")

    # (e) a server from the last .ckpt: the EMA shadow
    ema, _ = ckpt.restore_eval_params(b_dir / last_ckpt, cfg)
    serve_ckpt("e", b_dir / last_ckpt, cfg, ema)

    # (f) times
    recipe_times(RECIPE_ARGS, cfg)
    out = {"recipe": launches}
    # (g), (h): the recipe's ToMe-train and patch-drop variants
    for name in RECIPE_VARIANTS:
        out[f"recipe_{name}"] = recipe_variant(root, name)
    return out


def serve_ckpt(part: str, path: Path, cfg, ema, imgs=None,
               phase: str = "recipe") -> dict:
    """``load_server`` on the artifact ``path`` answers 32 requests from 4
    threads: top-1 equal to direct forwards on ``ema`` (the params it must
    serve bit for bit: the run's EMA shadow for a .ckpt, a LoRA run's
    merged weights), launches as a forward's, which it returns.
    ``imgs``: 32 preprocessed float32 images, by default the procedural
    val split's first at 224²."""
    from vitx_torch import forward
    from vitx_torch.serve import load_server
    from vitx_torch.train.step import leaves

    if imgs is None:
        imgs = serve_images()
    reset_counts()
    with load_server(path, cfg, batch_size=32, top_k=5,
                     max_delay_ms=20.0) as srv:
        results = concurrent_predict(srv, imgs, threads=4,
                                     what=f"{phase} ({part})")
        stats = srv.stats.summary()
        same = all(torch.equal(a, b) for a, b in zip(
            leaves(srv._params), leaves(ema)))
    served = counts()
    expect_launches(f"{phase} ({part}): server", served,
                    forward_launches(cfg, 1 + stats["batches"]))
    direct = forward(ema, imgs, cfg).argmax(-1).tolist()
    top1 = [r["classes"][0] for r in results]
    emit({"phase": phase, "part": f"{part}: load_server on "
          f"{path.parent.name}/{path.name}, 32 requests from 4 threads",
          "stats": stats, "launches": served, "top1_equal": top1 == direct,
          "serves_params": same})
    if top1 != direct or not same:
        raise AssertionError(f"{phase} ({part}): served {top1}, direct "
                             f"{direct}, params served {same}")
    return served


def direct_accuracy(params, cfg) -> float:
    """The val split's accuracy by direct ``eval_step`` calls at batch 128,
    the eval CLI's preprocessing (normalise, no flips)."""
    import os

    from vitx_torch.data import BatchLoader, make_preprocess
    from vitx_torch.data.procedural import ProceduralShapes
    from vitx_torch.metrics import confusion_to_metrics
    from vitx_torch.train.step import eval_step

    ds = ProceduralShapes(num_examples=RECIPE_VAL, seed=1,
                          cache_dir=os.environ["VITX_PROC_CACHE"])
    pre = make_preprocess(out_size=224, mean=(0.5,) * 3, std=(0.5,) * 3,
                          random_flip=False)
    cm = None
    for b in BatchLoader(ds, 128):
        img = pre(torch.from_numpy(b["image"]).cuda(), None, train=False)
        c, _ = eval_step(params, {"image": img, "label": b["label"],
                                  "mask": b["mask"]}, cfg=cfg)
        cm = c if cm is None else cm + c
    return float(confusion_to_metrics(cm)["accuracy"])


def recipe_variant(root: Path, name: str) -> dict:
    """(g) ToMe-train, (h) patch drop: the recipe with the variant's flags
    (``RECIPE_VARIANTS``), first card vs CPU at depth 2
    (``recipe_card_vs_cpu``), then at small16's full width and depth
    through ``vitx_torch.cli.train.main`` for RECIPE_EPOCHS epochs, its
    launches asserted (``recipe_step_launches``), its losses falling, its
    checkpoints' meta naming the variant. (g) only: ``cli.eval`` on the
    .ckpt runs every token by default (K1 and K2 a block), its accuracy
    that of direct calls, and merges with ``--tome-r to128`` (B8 and K2
    a block), its accuracy the one the trainer logged; a server from the
    .ckpt answers as direct calls do. Then the times (``recipe_times``).
    Returns the run's launches."""
    import vitx_torch.cli.eval as eval_cli
    import vitx_torch.cli.train as train_cli
    from vitx_torch.core.config import ViTConfig
    from vitx_torch.nn.tome import aligned_schedule
    from vitx_torch.train import checkpoint as ckpt

    part, flags = RECIPE_VARIANTS[name]
    recipe_card_vs_cpu(root / f"{part}_a", name)
    v_dir, logs = root / part, root / f"{part}_logs"
    reset_counts()
    t0 = time.perf_counter()
    final = run_cli(train_cli.main, RECIPE_ARGS + flags + [
        "--epochs", str(RECIPE_EPOCHS), "--checkpoint-dir", str(v_dir),
        "--log-dir", str(logs)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    metas = [ckpt.peek_meta(v_dir / f"{e}.ckpt")
             for e in range(RECIPE_EPOCHS)]
    cfg = ViTConfig.from_json(json.dumps(metas[-1]["config"]))
    steps = RECIPE_EPOCHS * (RECIPE_TRAIN // 128)
    eval_batches = RECIPE_EPOCHS * (RECIPE_VAL // 128)
    expect = recipe_step_launches(cfg, steps, eval_batches)
    losses = [v for _, v in read_scalars(logs, "Loss/train_batch")]
    rates = [v for _, v in read_scalars(logs, "Throughput/images_per_sec")]
    val = [v for _, v in read_scalars(logs, "val?acc")]
    emit({"phase": "recipe", "part": f"{part}: small16 bf16 b128, the "
          f"recipe with {' '.join(flags)} through vitx_torch.cli.train.main",
          "card": smi(), "argv": RECIPE_ARGS + flags,
          "epochs": RECIPE_EPOCHS, "tome_r": cfg.tome_r,
          "patch_keep": cfg.patch_keep_count, "wall_s": wall,
          "launches": launches, "expected": expect, "losses": losses,
          "val_accuracy": val, "img_per_s_by_epoch": rates,
          "steady_img_per_s": statistics.mean(rates[1:]), "final": final})
    expect_launches(f"recipe ({part})", launches, expect)
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    if not (len(losses) == steps and np.all(np.isfinite(losses))
            and last < first):
        raise AssertionError(f"recipe ({part}): losses {losses}")
    if name == "tome":
        want = aligned_schedule(cfg.replace(tome_r=0, tome_train=False), 128)
        named = cfg.tome_train and cfg.tome_schedule[:len(want)] == want
    else:
        named = cfg.patch_drop == 0.5 and not cfg.tome_r
    for m in metas:
        if not (named and m["ema_decay"] == 0.999 and m["schedule"]
                and m["config"] == metas[-1]["config"]):
            raise AssertionError(f"recipe ({part}): checkpoint meta {m}")
    if name != "tome":
        recipe_times(RECIPE_ARGS + flags, cfg, f"recipe_{name}")
        return launches

    # the eval CLI: every token by default, merged with --tome-r to128
    last_ckpt = v_dir / f"{RECIPE_EPOCHS - 1}.ckpt"
    full = ckpt.resolve_artifact_config(v_dir, None, "small16")
    ema, _ = ckpt.restore_eval_params(last_ckpt, full)
    argv = ["--preset", "small16", "--checkpoint", str(v_dir), "--data",
            RECIPE_DATA, "--batch-size", "128"]
    batches = RECIPE_VAL // 128
    reports = {}
    for merged, extra in ((False, []), (True, ["--tome-r", "to128"])):
        reset_counts()
        reports[merged] = run_cli(eval_cli.main, argv + extra)
        expect_launches(f"recipe ({part}): cli.eval {' '.join(extra)}",
                        counts(), forward_launches(
                            cfg if merged else full, batches))
    direct = direct_accuracy(ema, full)
    emit({"phase": "recipe", "part": f"{part}: vitx_torch.cli.eval on "
          "the ToMe-train .ckpt, every token and --tome-r to128",
          "full_token": reports[False]["accuracy"], "direct": direct,
          "merged": reports[True]["accuracy"], "logged": val[-1],
          "epoch": reports[True]["epoch"]})
    if not (reports[False]["accuracy"] == direct
            and reports[True]["accuracy"] == val[-1]
            == final["val_accuracy"] and not full.tome_r
            and reports[True]["epoch"] == RECIPE_EPOCHS - 1):
        raise AssertionError(f"recipe ({part}): eval {reports}, direct "
                             f"{direct}, logged {val}")
    serve_ckpt(part, last_ckpt, full, ema)
    recipe_times(RECIPE_ARGS + flags, cfg, f"recipe_{name}")
    return launches


# the transfer path: pre-training on a CIFAR-10 copy at 224², then
# fine-tuning base16 from its .ckpt at 384² (T 577) on packed shards. The
# cuts: CIFAR-10 5 x 256 + 256 images (from 5 x 10000 + 10000),
# procedural:256,64 for the shards (from 12800 + 2560), one epoch each.
TRANSFER_CIFAR = 256              # images per CIFAR batch file
TRANSFER_SPLIT = (256, 64)        # the packed shards' train, val images
TRANSFER_DATA = "procedural:{},{}".format(*TRANSFER_SPLIT)
TRANSFER_FOUR = 4                 # the second fine-tune's classes


def write_cifar_copy(root: Path, n: int, seed: int = 0) -> None:
    """CIFAR-10 in the torchvision layout under ``root``
    (``cifar-10-batches-py/data_batch_1..5``, ``test_batch``: protocol-2
    pickles of {b"data": (n, 3072) uint8 planes, b"labels": [...]}),
    seeded; each class is a colour of its own behind the noise, so the
    labels can be learned."""
    import pickle

    rng = np.random.default_rng(seed)
    palette = rng.integers(40, 216, (10, 3)).astype(np.float32)
    d = root / "cifar-10-batches-py"
    d.mkdir(parents=True, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        labels = rng.integers(0, 10, n)
        img = palette[labels][:, :, None, None] + rng.normal(
            0.0, 32.0, (n, 3, 32, 32))
        with open(d / name, "wb") as f:
            pickle.dump({b"data": np.clip(img, 0, 255).astype(
                np.uint8).reshape(n, 3072), b"labels": labels.tolist()}, f,
                protocol=2)


class ClassSubset:
    """The examples of ``ds`` whose label is below ``n``: a dataset of its
    first ``n`` classes."""

    def __init__(self, ds, n: int):
        self.ds, self.idx = ds, np.flatnonzero(ds.labels < n)
        self.classes = list(ds.classes[:n])
        self.labels = ds.labels[self.idx]

    def __len__(self):
        return len(self.idx)

    def get_example(self, i: int):
        return self.ds.get_example(int(self.idx[i]))


TRANSFER_FOLDER = (256, 64)       # PNG images in Training/, Testing/
FOLDER_CLASSES = ("glioma", "meningioma", "notumor", "pituitary")


def write_png_folder(root: Path, seed: int = 1) -> None:
    """The brain-tumour layout under ``root``: ``Training/<class>/`` and
    ``Testing/<class>/`` hold TRANSFER_FOLDER 256² RGB PNG images, seeded;
    each class a tint of its own under a smooth random field and a little
    noise. The arrays are drawn in order, the PNGs encoded by 8 threads."""
    import concurrent.futures as cf

    from PIL import Image

    rng = np.random.default_rng(seed)
    tint = rng.integers(60, 196, (len(FOLDER_CLASSES), 3))
    jobs = []
    for split, n in zip(("Training", "Testing"), TRANSFER_FOLDER):
        for c in FOLDER_CLASSES:
            (root / split / c).mkdir(parents=True)
        for i, k in enumerate(rng.integers(0, len(FOLDER_CLASSES), n)):
            field = np.kron(rng.normal(0.0, 40.0, (16, 16, 3)),
                            np.ones((16, 16, 1)))
            img = tint[k] + field + rng.normal(0.0, 8.0, (256, 256, 3))
            jobs.append((np.clip(img, 0, 255).astype(np.uint8),
                         root / split / FOLDER_CLASSES[k] / f"{i:05d}.png"))
    with cf.ThreadPoolExecutor(8) as pool:
        for f in [pool.submit(Image.fromarray(a).save, p) for a, p in jobs]:
            f.result()


def first_blocks(params: dict, n: int = 2) -> dict:
    """``params`` with only its first ``n`` encoder blocks."""
    return dict(params, blocks={k: v[:n].clone()
                                for k, v in params["blocks"].items()})


def transfer_args(src, data: str, out: Path | None, logs: Path | None,
                  epochs: int = 1) -> list:
    """The train CLI's flags of a transfer fine-tune of base16 at 384²
    b32 from ``src``."""
    argv = ["--preset", "base16", "--image-size", "384", "--init-from",
            str(src), "--data", data, "--batch-size", "32", "--epochs",
            str(epochs), "--seed", "0", "--log-every", "1"]
    if out is not None:
        argv += ["--checkpoint-dir", str(out)]
    if logs is not None:
        argv += ["--log-dir", str(logs)]
    return argv


def build_quietly(argv):
    """``build_trainer`` on ``argv`` -> (trainer, train loader, eval
    loader, the warnings it raised)."""
    import warnings

    import vitx_torch.cli.train as train_cli

    parser = train_cli.build_argparser()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        built = train_cli.build_trainer(parser.parse_args(argv), parser)
    return (*built, [str(w.message) for w in caught])


def transfer_fine_tune(part: str, src: Path, data: str, root: Path,
                       want_fresh: list) -> tuple:
    """(c): the train CLI's trainer (``build_trainer``) fine-tunes base16
    at 384² b32 from the 224² .ckpt ``src`` on ``data`` for one epoch.
    Its initial params: every grafted leaf bit-equal to the source's eval
    params, pos_embed within 1e-6 of ``resize_pos_embed`` of the source's
    table on the CPU, the leaves kept fresh exactly ``want_fresh`` (the
    transfer's one warning). Then launches a step and an eval batch as
    the recipe's, finite losses. Returns (launches, trainer, the epoch's
    history row, the checkpoint directory)."""
    from vitx_torch.interop import resize_pos_embed
    from vitx_torch.train import checkpoint as ckpt
    from vitx_torch.train.step import leaves

    out, logs = root / part, root / f"{part}_logs"
    tr, train_loader, eval_loader, notes = build_quietly(
        transfer_args(src, data, out, logs))
    cfg = tr.cfg
    src_cfg = ckpt.resolve_artifact_config(src)
    source, _ = ckpt.restore_eval_params(src, src_cfg)
    want_pe = resize_pos_embed({"pos_embed": source["pos_embed"].cpu()},
                               src_cfg, cfg)["pos_embed"]
    init = tr.state.params
    names = leaf_names(init)
    src_leaves = dict(zip(leaf_names(source), leaves(source)))
    fresh = [n for n in notes if "fresh init kept" in n]
    grafted, unequal = 0, []
    for name, leaf in zip(names, leaves(init)):
        if name == "pos_embed":
            pe_gap = float((leaf.cpu() - want_pe).abs().max())
        elif name not in want_fresh:
            grafted += 1
            if not torch.equal(leaf, src_leaves[name]):
                unequal.append(name)
    named = (fresh[0].split("fresh init kept for ")[1].split(" (")[0]
             if fresh else "[]")
    del source, src_leaves
    reset_counts()
    t0 = time.perf_counter()
    hist = tr.fit(train_loader, eval_loader)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    expect = recipe_step_launches(cfg, len(train_loader), len(eval_loader))
    losses = [v for _, v in read_scalars(logs, "Loss/train_batch")]
    emit({"phase": "transfer", "part": f"{part[0]}: base16 384² bf16 b32 "
          f"from the 224² CIFAR .ckpt on {data.split('/')[-1]}, one epoch "
          "through build_trainer", "card": smi(), "warnings": notes,
          "fresh": named, "grafted": grafted, "unequal": unequal,
          "pos_embed_gap": pe_gap, "tol": 1e-6, "T": cfg.seq_len,
          "classes": cfg.num_classes, "steps": len(train_loader),
          "eval_batches": len(eval_loader), "launches": launches,
          "expected": expect, "losses": losses, "wall_s": wall,
          "final": {k: v for k, v in hist[-1].items()
                    if isinstance(v, (int, float))}})
    expect_launches(f"transfer ({part})", launches, expect)
    if (unequal or pe_gap > 1e-6 or named != str(want_fresh)
            or len(fresh) > 1 or cfg.seq_len != 577
            or not any("pos_embed resized from 197 to 577" in n
                       for n in notes)):
        raise AssertionError(f"transfer ({part}): unequal {unequal}, gap "
                             f"{pe_gap}, fresh {named}, notes {notes}")
    if not (len(losses) == len(train_loader)
            and np.all(np.isfinite(losses))):
        raise AssertionError(f"transfer ({part}): losses {losses}")
    return launches, tr, hist[-1], out


def phase_transfer() -> tuple:
    """Main path 7, transfer: (a) base16 pre-trained at 224² b128 for one
    epoch on a CIFAR-10 copy through ``vitx_torch.cli.train.main``; (b)
    ``vitx_torch.cli.pack`` packs procedural:256,64 at 384² as raw
    shards (10 classes), ``write_shards`` a 4-class subset of them; (c)
    the fine-tune at 384² b32 from (a)'s .ckpt on each
    (``transfer_fine_tune``); (d) the transfer and its first step at depth
    2 fp32, card vs CPU; (e) the eval CLI on (c)'s .ckpt, on the val
    shards and on one shard directory (the stratified split); (f) (c)'s
    params through a reference .pt: bit-equal back, the eval CLI's and a
    server's top-1 equal to direct calls, ``--init-from`` the .pt equal
    to ``transfer_params``; (g) a PNG folder in the brain-tumour layout
    (``write_png_folder``), fine-tuned as (c), then the eval CLI on it.
    Returns (the launches of (c) and (g), and what the times need)."""
    import io
    import os
    import shutil
    import warnings

    import vitx_torch.cli.eval as eval_cli
    import vitx_torch.cli.pack as pack_cli
    import vitx_torch.cli.train as train_cli
    from vitx_torch import forward
    from vitx_torch.data import BatchLoader, make_preprocess
    from vitx_torch.data.folder import split_indices
    from vitx_torch.data.shards import ShardDataset, write_shards
    from vitx_torch.train import checkpoint as ckpt
    from vitx_torch.train.step import leaves

    root = BUILD / "transfer"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    os.environ.setdefault("VITX_PROC_CACHE", str(BUILD / "procdata"))

    # (a) pre-training on CIFAR-10 at 224², one epoch
    cifar = root / "cifar"
    write_cifar_copy(cifar, TRANSFER_CIFAR)
    a_dir, a_logs = root / "a", root / "a_logs"
    reset_counts()
    t0 = time.perf_counter()
    final = run_cli(train_cli.main, [
        "--preset", "base16", "--data", f"cifar10:{cifar}", "--epochs", "1",
        "--batch-size", "128", "--seed", "0", "--log-every", "1",
        "--checkpoint-dir", str(a_dir), "--log-dir", str(a_logs)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    src = a_dir / "0.ckpt"
    src_cfg = ckpt.resolve_artifact_config(src)
    steps, evals = 5 * TRANSFER_CIFAR // 128, TRANSFER_CIFAR // 128
    expect = recipe_step_launches(src_cfg, steps, evals)
    losses = [v for _, v in read_scalars(a_logs, "Loss/train_batch")]
    emit({"phase": "transfer", "part": "a: base16 224² bf16 b128, one "
          "epoch on a CIFAR-10 copy through vitx_torch.cli.train.main",
          "images": [5 * TRANSFER_CIFAR, TRANSFER_CIFAR], "wall_s": wall,
          "launches": got, "expected": expect, "losses": losses,
          "final": final})
    expect_launches("transfer (a)", got, expect)
    if not (src_cfg.num_classes == 10 and src_cfg.image_size == 224
            and len(losses) == steps and np.all(np.isfinite(losses))):
        raise AssertionError(f"transfer (a): {src_cfg}, losses {losses}")

    # (b) the shards: the pack CLI, then a 4-class subset by write_shards
    out, out4 = root / "shards", root / "shards4"
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pack_cli.main(["--data", TRANSFER_DATA, "--format", "raw",
                            "--image-size", "384", "--out", str(out)])
    packed = [json.loads(x) for x in buf.getvalue().splitlines()]
    pack_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for split in ("train", "val"):
        write_shards(ClassSubset(ShardDataset(out / split, test_size=None),
                                 TRANSFER_FOUR), out4 / split,
                     image_format="raw")
    sub_s = time.perf_counter() - t0
    sizes = {str(d.relative_to(root)): len(ShardDataset(d, test_size=None))
             for d in (out / "train", out / "val", out4 / "train",
                       out4 / "val")}
    emit({"phase": "transfer", "part": "b: vitx_torch.cli.pack "
          f"--data {TRANSFER_DATA} --format raw --image-size 384, and a "
          f"{TRANSFER_FOUR}-class subset by write_shards", "pack": packed,
          "pack_s": pack_s, "subset_s": sub_s, "images": sizes})
    if rc != 0 or [p["images"] for p in packed] != list(TRANSFER_SPLIT):
        raise AssertionError(f"transfer (b): pack exit {rc}, {packed}")

    # (c) the fine-tunes: the same head shape (10 classes), then a new one
    launches, tr, last, c_dir = transfer_fine_tune(
        "c10", src, f"shards:{out}", root, [])
    cfg = tr.cfg
    launches4, tr4, _, _ = transfer_fine_tune(
        "c4", src, f"shards:{out4}", root, ["head/b2", "head/w2"])
    del tr4

    # (d) the same transfer on the card and on the CPU, then its first
    # step at depth 2 in fp32
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        card = ckpt.transfer_params(src, cfg, 0)
        host = ckpt.transfer_params(src, cfg, 0, device="cpu")
    gaps = {n: float((a.cpu() - b).abs().max()) for n, a, b in zip(
        leaf_names(host), leaves(card), leaves(host))}
    off = {n: g for n, g in gaps.items() if g and n != "pos_embed"}
    emit({"phase": "transfer", "part": "d: transfer_params of (a)'s .ckpt "
          "into 384², card vs CPU", "pos_embed_gap": gaps["pos_embed"],
          "other_leaves_off": off, "tol": 1e-6})
    if off or gaps["pos_embed"] > 1e-6:
        raise AssertionError(f"transfer (d): {off}, {gaps['pos_embed']}")
    shards_train = ShardDataset(out / "train", test_size=None)
    two = [shards_train.get_example(i) for i in range(2)]
    batch = {"image": np.stack([e[0] for e in two]),
             "label": np.array([e[1] for e in two], np.int32)}
    check_step_card_vs_cpu(
        "transfer", "d: base16 384² depth 2 fp32 b2 from the transfer, card "
        "vs CPU", cfg.replace(depth=2, compute_dtype="float32"),
        first_blocks(card), first_blocks(host), batch, 1e-4)
    del card, host

    # (e) the eval CLI on (c)'s checkpoint: the val shards, then one shard
    # directory, which the stratified split divides
    argv = ["--preset", "base16", "--checkpoint", str(c_dir), "--batch-size",
            "32"]
    report = run_cli(eval_cli.main, argv + ["--data", f"shards:{out}"])
    split = run_cli(eval_cli.main, argv + ["--data",
                                           f"shards:{out / 'train'}"])
    labels = shards_train.labels
    want = np.bincount(labels[split_indices(
        labels, train=False, test_size=0.2, random_state=42)],
        minlength=10).tolist()
    got_counts = np.array(split["confusion_matrix"]).sum(axis=1).tolist()
    emit({"phase": "transfer", "part": "e: vitx_torch.cli.eval on (c)'s "
          ".ckpt, shards:OUT and shards:OUT/train", "accuracy":
          report["accuracy"], "logged": last["val_accuracy"],
          "split_counts": got_counts, "split_indices_counts": want})
    if not (report["accuracy"] == last["val_accuracy"]
            and report["num_examples"] == TRANSFER_SPLIT[1]
            and got_counts == want):
        raise AssertionError(f"transfer (e): {report}, {split}, {want}")

    # (f) the reference .pt
    params = tr.state.params
    pt, cfg_json = root / "ft.pt", root / "ft.json"
    ckpt.save_reference_pt(pt, params, cfg, epoch=0, batch_size=32)
    cfg_json.write_text(cfg.to_json())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # corrected-parity imports
        back, meta = ckpt.load_reference_pt(pt, cfg)
        differ = [n for n, a, b in zip(leaf_names(params), leaves(params),
                                       leaves(back)) if not torch.equal(a, b)]
        preds = root / "ft_preds.jsonl"
        pt_report = run_cli(eval_cli.main, [
            "--config-json", str(cfg_json), "--checkpoint", str(pt),
            "--data", f"shards:{out}", "--batch-size", "32", "--predict",
            str(preds)])
        val = ShardDataset(out / "val", test_size=None)
        pre = make_preprocess(out_size=384, mean=(0.5,) * 3, std=(0.5,) * 3,
                              random_flip=False)
        direct, imgs = [], None
        for b in BatchLoader(val, 32):
            x = pre(torch.from_numpy(b["image"]).cuda(), None, train=False)
            direct += forward(params, x, cfg).argmax(-1).tolist()
            if imgs is None:
                imgs = x.cpu().numpy()
        names = [json.loads(x)["pred"] for x in preds.read_text()
                 .splitlines()]
        cli_top1 = [val.classes.index(n) for n in names]
        serve_ckpt("f", pt, cfg, params, imgs=imgs, phase="transfer")
        tr_pt, _, _, _ = build_quietly(transfer_args(pt, f"shards:{out}",
                                                     None, None))
        want_init = ckpt.transfer_params(pt, tr_pt.cfg, 0)
    init_differ = [n for n, a, b in zip(
        leaf_names(want_init), leaves(tr_pt.state.params),
        leaves(want_init)) if not torch.equal(a, b)]
    emit({"phase": "transfer", "part": "f: (c)'s params through a "
          "reference .pt: load_reference_pt, cli.eval --predict, "
          "--init-from", "meta": meta, "differ": differ,
          "eval_top1_equal": cli_top1 == direct,
          "accuracy": pt_report["accuracy"], "init_differ": init_differ})
    if differ or cli_top1 != direct or init_differ or meta["epoch"] != 0:
        raise AssertionError(f"transfer (f): differ {differ}, eval "
                             f"{cli_top1 == direct}, init {init_differ}")
    del tr_pt, want_init

    # (g) a folder of PNG images (the brain-tumour layout), decoded and
    # resized 256² -> 384² by PIL on the host: one epoch from (a)'s .ckpt
    # (4 classes: a new head), then the eval CLI on it
    folder = root / "folder"
    t0 = time.perf_counter()
    write_png_folder(folder)
    write_s = time.perf_counter() - t0
    launches_g, tr_g, last_g, g_dir = transfer_fine_tune(
        "g", src, f"folder:{folder}", root, ["head/b2", "head/w2"])
    del tr_g
    report = run_cli(eval_cli.main, ["--preset", "base16", "--checkpoint",
                                     str(g_dir), "--data", f"folder:{folder}",
                                     "--batch-size", "32"])
    emit({"phase": "transfer", "part": "g: vitx_torch.cli.eval on the PNG "
          "folder's .ckpt", "write_s": write_s,
          "accuracy": report["accuracy"], "logged": last_g["val_accuracy"],
          "num_examples": report["num_examples"],
          "classes": list(report["per_class_f1"])})
    if not (report["accuracy"] == last_g["val_accuracy"]
            and report["num_examples"] == TRANSFER_FOLDER[1]
            and tuple(report["per_class_f1"]) == FOLDER_CLASSES):
        raise AssertionError(f"transfer (g): eval {report}, logged "
                             f"{last_g}")
    return add_launches(launches, launches4, launches_g), {
        "cifar": cifar, "shards": out, "src": src, "cfg": cfg,
        "folder": folder,
        "batch": {"image": np.stack([shards_train.get_example(i)[0]
                                     for i in range(32)]),
                  "label": shards_train.labels[:32].astype(np.int32)}}


PRETRAINED_CIFAR = 128      # images per CIFAR batch file: 640 train, 128 val
PRETRAINED_FWD_B = 64       # the imports' forward batch
PRETRAINED_CPU_ROWS = 2     # of its rows, those held to the CPU's fp32
PRETRAINED_EPOCHS = 2       # of each full-width run: 10 steps at b128


def vit_b_state_dict(seed: int, layout: str) -> dict:
    """A ViT-B/16 state dict of fp32 CPU tensors drawn from ``seed``:
    timm's ``vit_base_patch16_224`` keys (``layout="timm"``: one fused
    qkv matrix), DeiT's ``deit_base_distilled_patch16_224`` (``"deit"``:
    ``dist_token``, ``head_dist``, T 198) or HF's ``ViTForImageClassification``
    (``"hf"``: query, key and value apart). Weights N(0, 0.02), biases
    N(0, 0.02), LayerNorm scales 1 + N(0, 0.1), 1000 classes."""
    g = torch.Generator().manual_seed(seed)
    E, L, P = 768, 12, 16

    def r(*shape, base=0.0, std=0.02):
        return base + std * torch.randn(shape, generator=g)

    T = 196 + (2 if layout == "deit" else 1)
    sd = {"cls_token": r(1, 1, E), "pos_embed": r(1, T, E),
          "patch_embed.proj.weight": r(E, 3, P, P),
          "patch_embed.proj.bias": r(E), "norm.weight": r(E, base=1, std=0.1),
          "norm.bias": r(E), "head.weight": r(1000, E), "head.bias": r(1000)}
    for i in range(L):
        t = f"blocks.{i}."
        sd.update({t + "attn.qkv.weight": r(3 * E, E),
                   t + "attn.qkv.bias": r(3 * E),
                   t + "attn.proj.weight": r(E, E), t + "attn.proj.bias": r(E),
                   t + "norm1.weight": r(E, base=1, std=0.1),
                   t + "norm1.bias": r(E),
                   t + "norm2.weight": r(E, base=1, std=0.1),
                   t + "norm2.bias": r(E),
                   t + "mlp.fc1.weight": r(4 * E, E),
                   t + "mlp.fc1.bias": r(4 * E),
                   t + "mlp.fc2.weight": r(E, 4 * E),
                   t + "mlp.fc2.bias": r(E)})
    if layout == "deit":
        sd.update({"dist_token": r(1, 1, E), "head_dist.weight": r(1000, E),
                   "head_dist.bias": r(1000)})
    if layout != "hf":
        return sd
    hf = {"vit.embeddings.cls_token": sd["cls_token"],
          "vit.embeddings.position_embeddings": sd["pos_embed"],
          "vit.embeddings.patch_embeddings.projection.weight":
              sd["patch_embed.proj.weight"],
          "vit.embeddings.patch_embeddings.projection.bias":
              sd["patch_embed.proj.bias"],
          "vit.layernorm.weight": sd["norm.weight"],
          "vit.layernorm.bias": sd["norm.bias"],
          "classifier.weight": sd["head.weight"],
          "classifier.bias": sd["head.bias"]}
    for i in range(L):
        t, h = f"blocks.{i}.", f"vit.encoder.layer.{i}."
        for j, m in enumerate(("query", "key", "value")):
            hf[f"{h}attention.attention.{m}.weight"] = sd[
                t + "attn.qkv.weight"][j * E:(j + 1) * E]
            hf[f"{h}attention.attention.{m}.bias"] = sd[
                t + "attn.qkv.bias"][j * E:(j + 1) * E]
        for src, dst in (("attn.proj", "attention.output.dense"),
                         ("norm1", "layernorm_before"),
                         ("norm2", "layernorm_after"),
                         ("mlp.fc1", "intermediate.dense"),
                         ("mlp.fc2", "output.dense")):
            hf[h + dst + ".weight"] = sd[t + src + ".weight"]
            hf[h + dst + ".bias"] = sd[t + src + ".bias"]
    return hf


class RefViT(torch.nn.Module):
    """timm's or HF's ViT-B/16 written module by module in fp32 with
    ``nn.Conv2d``, ``nn.Linear``, ``nn.LayerNorm`` and ``F.gelu`` (erf),
    loaded from ``vit_b_state_dict``'s tensors, independent of the port's
    import: pre-LN blocks with the attention's q, k, v from one fused
    Linear (timm) or three (HF), the final LayerNorm, the head on the CLS
    token and, for DeiT, the mean of it and the distillation head on token
    1. Takes NCHW images, returns logits."""

    def __init__(self, sd: dict, layout: str, eps: float):
        super().__init__()
        nn = torch.nn
        E, self.H, self.layout = 768, 12, layout
        hf = layout == "hf"
        key = (lambda k: {"cls_token": "vit.embeddings.cls_token",
                          "pos_embed": "vit.embeddings.position_embeddings",
                          "patch_embed.proj": "vit.embeddings."
                          "patch_embeddings.projection",
                          "norm": "vit.layernorm",
                          "head": "classifier"}.get(k, k)) if hf else \
            (lambda k: k)
        self.proj = nn.Conv2d(3, E, 16, stride=16)
        self.blocks = nn.ModuleList()
        for _ in range(12):
            b = nn.Module()
            b.norm1, b.norm2 = nn.LayerNorm(E, eps=eps), nn.LayerNorm(E,
                                                                     eps=eps)
            if hf:
                b.q, b.k, b.v = (nn.Linear(E, E) for _ in range(3))
            else:
                b.qkv = nn.Linear(E, 3 * E)
            b.out, b.fc1, b.fc2 = (nn.Linear(E, E), nn.Linear(E, 4 * E),
                                   nn.Linear(4 * E, E))
            self.blocks.append(b)
        self.norm = nn.LayerNorm(E, eps=eps)
        self.head = nn.Linear(E, 1000)
        self.tokens = [key("cls_token")] + (["dist_token"]
                                            if layout == "deit" else [])
        self.head_dist = nn.Linear(E, 1000) if layout == "deit" else None

        def put(mod, name):
            mod.weight.data.copy_(sd[name + ".weight"])
            mod.bias.data.copy_(sd[name + ".bias"])

        with torch.no_grad():
            put(self.proj, key("patch_embed.proj"))
            put(self.norm, key("norm"))
            put(self.head, key("head"))
            if self.head_dist is not None:
                put(self.head_dist, "head_dist")
            self.prefix = nn.Parameter(torch.cat([sd[k] for k in
                                                  self.tokens], dim=1))
            self.pos = nn.Parameter(sd[key("pos_embed")].clone())
            for i, b in enumerate(self.blocks):
                if hf:
                    h = f"vit.encoder.layer.{i}."
                    for mod, m in ((b.q, "query"), (b.k, "key"),
                                   (b.v, "value")):
                        put(mod, f"{h}attention.attention.{m}")
                    for mod, m in ((b.out, "attention.output.dense"),
                                   (b.norm1, "layernorm_before"),
                                   (b.norm2, "layernorm_after"),
                                   (b.fc1, "intermediate.dense"),
                                   (b.fc2, "output.dense")):
                        put(mod, h + m)
                else:
                    t = f"blocks.{i}."
                    for mod, m in ((b.qkv, "attn.qkv"), (b.out, "attn.proj"),
                                   (b.norm1, "norm1"), (b.norm2, "norm2"),
                                   (b.fc1, "mlp.fc1"), (b.fc2, "mlp.fc2")):
                        put(mod, t + m)

    def forward(self, x):
        F = torch.nn.functional
        t = self.proj(x).flatten(2).transpose(1, 2)
        B, _, E = t.shape
        H, D = self.H, E // self.H
        t = torch.cat([self.prefix.expand(B, -1, -1), t], dim=1) + self.pos
        T = t.shape[1]
        for b in self.blocks:
            h = b.norm1(t)
            if self.layout == "hf":
                q, k, v = (m(h).reshape(B, T, H, D).transpose(1, 2)
                           for m in (b.q, b.k, b.v))
            else:
                q, k, v = b.qkv(h).reshape(B, T, 3, H, D).permute(
                    2, 0, 3, 1, 4)
            a = torch.softmax(q @ k.transpose(-1, -2) / D ** 0.5, dim=-1) @ v
            t = t + b.out(a.transpose(1, 2).reshape(B, T, E))
            t = t + b.fc2(F.gelu(b.fc1(b.norm2(t))))
        t = self.norm(t)
        logits = self.head(t[:, 0])
        if self.head_dist is not None:
            logits = 0.5 * (logits + self.head_dist(t[:, 1]))
        return logits


def pretrained_imports(errs: dict) -> tuple:
    """(a) timm ViT-B/16, HF ViT-B/16 and DeiT-B/16-distilled state dicts
    imported (``import_pretrained_state_dict``) and run at b64: bf16 on
    the card (B5 and K2 in every block), held to the CPU's fp32 plain
    forward on its first rows (EXPLAIN_TOL) and, in fp32 on the card, to
    ``RefViT`` (FP32_TOL). Returns (the bf16 forwards' launches, the timm
    config, its params on the card)."""
    from vitx_torch import forward
    from vitx_torch.interop import (import_pretrained_state_dict,
                                    vit_config_for_pretrained)
    from vitx_torch.nn.vit import params_to

    x = np.random.default_rng(11).standard_normal(
        (PRETRAINED_FWD_B, 224, 224, 3)).astype(np.float32)
    xc = torch.from_numpy(x).cuda()
    launches, keep = {k: 0 for k in (*KERNELS, *EXTRA_COUNTERS)}, None
    for layout in ("timm", "hf", "deit"):
        eps = 1e-12 if layout == "hf" else 1e-6
        cfg = vit_config_for_pretrained(
            image_size=224, patch_size=16, num_classes=1000, embed_dim=768,
            depth=12, num_heads=12, layer_norm_eps=eps,
            distill_token=layout == "deit")
        sd = vit_b_state_dict(21, layout)
        t0 = time.perf_counter()
        params = import_pretrained_state_dict(sd, cfg)
        import_s = time.perf_counter() - t0
        reset_counts()
        logits = forward(params, xc, cfg)
        torch.cuda.synchronize()
        got = counts()
        launches = add_launches(launches, got)
        expect = block_launches(cfg, flash_attention=12,
                                flash_attention_sm90=12, fused_mlp_block=12)
        expect_launches(f"pretrained (a) {layout}", got, expect)
        what = f"a: {layout} ViT-B/16 (T {cfg.seq_len}, eps {eps:g})"
        n = PRETRAINED_CPU_ROWS
        host = forward(params_to(params, "cpu"), x[:n],
                       cfg.replace(compute_dtype="float32"), device="cpu")
        check("pretrained", f"{what} bf16 b{PRETRAINED_FWD_B} on the card "
              f"vs CPU fp32 (rows 0-{n - 1})", logits[:n], host, EXPLAIN_TOL,
              import_s=import_s)
        ref = RefViT(sd, layout, eps).cuda()
        with torch.no_grad():
            want = ref(xc.permute(0, 3, 1, 2))
        got32 = forward(params, xc, cfg.replace(compute_dtype="float32"))
        check("pretrained", f"{what} fp32 on the card vs the module-by-module "
              f"{layout} ViT", got32, want, FP32_TOL, errs, "pretrained_fp32")
        del ref, want, got32, host
        if layout == "timm":
            keep = (cfg, params)
    return launches, *keep


def lora_launches(cfg, steps: int, evals: int, composed: bool) -> dict:
    """A LoRA run's launches (attention adapters): per step K1 with its
    stash (B5 on the composed path of a QKV-bias model) and B2 in every
    block; B3 for LN2 of every block, LN1 of every block but the first
    (its input and parameters are frozen: nothing asks for that
    gradient) and the head's LayerNorm. Per eval batch K1 (B5) and K2
    in every block."""
    L = cfg.depth
    b3 = (L - 1) + L + 1
    if composed:
        return block_launches(
            cfg, flash_attention=L * (steps + evals),
            flash_attention_sm90=L * (steps + evals) * sm90(cfg),
            fused_mlp_block=L * evals, attention_bwd=L * steps,
            attention_bwd_sm90=L * steps * sm90(cfg), ln_bwd=b3 * steps)
    return block_launches(
        cfg, fused_mha_block=L * (steps + evals), fused_mlp_block=L * evals,
        attention_bwd=L * steps, attention_bwd_sm90=L * steps * sm90(cfg),
        ln_bwd=b3 * steps)


def freeze_launches(cfg, steps: int, evals: int) -> dict:
    """A frozen backbone's run: the encoder records no gradient, so K1
    runs without its stash in every block of a step, no B2; B3 for the
    head's LayerNorm only. Per eval batch K1 and K2 in every block."""
    L = cfg.depth
    return block_launches(cfg, fused_mha_block=L * (steps + evals),
                          fused_mlp_block=L * evals, ln_bwd=steps)


def distill_launches(cfg, tcfg, steps: int, evals: int) -> dict:
    """A distillation run with the token: per step the teacher's K1 and
    K2 (no stash) in every block and the student's, with their stashes
    (the step runs the model's forward with fuse_mlp "auto", as vitx's
    does); B2 in every student block; B3 for LN1 (K1's backward) and LN2
    (K2's) of every block and the two heads' LayerNorms. Per eval batch
    the student's K1 and K2."""
    L, Lt = cfg.depth, tcfg.depth
    student = block_launches(cfg, fused_mha_block=L * (steps + evals),
                             fused_mlp_block=L * (steps + evals),
                             attention_bwd=L * steps,
                             attention_bwd_sm90=L * steps * sm90(cfg),
                             ln_bwd=(2 * L + 2) * steps)
    return add_launches(student, forward_launches(tcfg, steps))


def knob_run(part: str, argv: list, root: Path, expect_fn, frozen=None):
    """One full-width run of the train CLI's trainer (``build_trainer`` on
    ``argv``, then ``fit``) on the CIFAR copy: its launches against
    ``expect_fn(cfg, steps, evals)``, printed a step; finite losses whose
    last third is below the first; with ``frozen`` (a predicate on leaf
    names), those leaves bit-unchanged and every other one moved. Returns
    (launches, trainer, its checkpoint directory, wall seconds)."""
    from vitx_torch.train.step import leaves

    out, logs = root / part, root / f"{part}_logs"
    tr, train_loader, eval_loader, notes = build_quietly(
        argv + ["--checkpoint-dir", str(out), "--log-dir", str(logs),
                "--epochs", str(PRETRAINED_EPOCHS), "--seed", "0",
                "--log-every", "1"])
    names = leaf_names(tr.state.params)
    before = ([t.clone() for t in leaves(tr.state.params)]
              if frozen is not None else None)
    reset_counts()
    t0 = time.perf_counter()
    tr.fit(train_loader, eval_loader)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    steps = PRETRAINED_EPOCHS * len(train_loader)
    evals = PRETRAINED_EPOCHS * len(eval_loader)
    expect = expect_fn(tr.cfg, steps, evals)
    at_eval = expect_fn(tr.cfg, 0, evals)
    losses = [v for _, v in read_scalars(logs, "Loss/train_batch")]
    third = max(1, len(losses) // 3)
    emit({"phase": "pretrained", "part": f"{part}: {' '.join(argv)}",
          "T": tr.cfg.seq_len, "steps": steps, "eval_batches": evals,
          "launches": got, "launches_per_step": {
              k: (got[k] - at_eval[k]) / steps for k in (
                  "fused_mha_block", "fused_mlp_block", "attention_bwd",
                  "ln_bwd", "flash_attention", "fused_adamw_multi_")},
          "expected": expect, "losses": losses, "wall_s": wall,
          "warnings": notes})
    expect_launches(f"pretrained ({part})", got, expect)
    if not (len(losses) == steps and np.all(np.isfinite(losses))
            and np.mean(losses[-third:]) < np.mean(losses[:third])):
        raise AssertionError(f"pretrained ({part}): losses {losses}")
    if frozen is not None:
        moved = [n for n, a, b in zip(names, before, leaves(tr.state.params))
                 if not torch.equal(a, b)]
        wrong = [n for n in names if frozen(n) == (n in moved)]
        emit({"phase": "pretrained", "part": f"{part}: frozen leaves",
              "moved": moved, "wrong": wrong})
        if wrong:
            raise AssertionError(f"pretrained ({part}): frozen leaves "
                                 f"moved or trainable ones did not: {wrong}")
    return got, tr, out, wall


def knob_card_vs_cpu(part: str, cfg, host, batches, opt_kw, *,
                     train_filter=None, mixes=None, teacher=None,
                     lr: float = 1e-4) -> None:
    """A fine-tuning knob at depth 2 in fp32 from the same params on the
    card and on the CPU, as train (a) holds the plain step: each
    micro-batch's loss, grad_norm and gradients (of the trainable leaves)
    within FP32_TOL; the params after the update within ``param_gap``'s
    allowance of the mean gradient; frozen leaves bit-unchanged on both.
    ``mixes``: the (perm, map) of each micro-batch, fed to both devices;
    ``teacher`` (cfg, params on the CPU): a distillation step, whose
    gradients come from ``distill_loss`` on ``model_logits``' heads."""
    from vitx_torch.nn.vit import model_logits, params_to
    from vitx_torch.train import make_optimizer, train_step
    from vitx_torch.train.distill import distill_loss, distill_train_step
    from vitx_torch.train.step import (TrainState, cross_entropy_loss,
                                       leaves, loss_fn, trainable_params,
                                       tree_map)

    out = []
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.clone().to(dev), host)
        opt = make_optimizer(lr=lr, **opt_kw)
        state = TrainState(0, params, opt.init(params))
        start = [t.clone() for t in leaves(params)]
        grads, metrics = [], []
        for i, b in enumerate(batches):
            tb = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            mix = None if mixes is None else tuple(
                torch.from_numpy(np.asarray(m)).to(dev) for m in mixes[i])
            req, wrt = trainable_params(state.params, train_filter)
            if teacher is None:
                loss = loss_fn(req, tb, cfg, mix=mix,
                               mixup_alpha=0.8 if mix else None)[0]
            else:
                tcfg, tparams = teacher
                tp = params_to(tparams, dev)
                with torch.no_grad():
                    tl = model_logits(tp, tb["image"], tcfg)
                cls, dist = model_logits(req, tb["image"], cfg, heads=True)
                loss = 0.5 * cross_entropy_loss(cls, tb["label"]) + \
                    0.5 * distill_loss(dist, tl, tb["label"], alpha=1.0)
            grads.append([g.cpu() for g in torch.autograd.grad(
                loss, [t for t, w in zip(leaves(req), wrt) if w])])
            if teacher is None:
                state, m = train_step(state, b, cfg=cfg, optimizer=opt,
                                      device=dev, train_filter=train_filter,
                                      mix=mix,
                                      mixup_alpha=0.8 if mix else None)
            else:
                state, m = distill_train_step(
                    state, b, tp, cfg=cfg, teacher_cfg=tcfg, optimizer=opt,
                    alpha=0.5, tau=1.0, hard=False, device=dev)
            metrics.append({k: float(v) for k, v in m.items()})
        out.append((grads, [t.cpu() for t in leaves(state.params)],
                    [t.cpu() for t in start], metrics, wrt))
    (gc, pc, sc, mc, wrt), (gh, ph, sh, mh, _) = out
    errs = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(mc, mh))
            for k in ("loss", "grad_norm")}
    errs["grads"] = max(rel_err(a, b) for ga, gb in zip(gc, gh)
                        for a, b in zip(ga, gb))
    names = [n for n, w in zip(leaf_names(host), wrt) if w]

    def mean(gs):                     # MultiSteps' running mean
        m = gs[0]
        for k, g in enumerate(gs[1:], start=1):
            m = [a + (b - a) / (k + 1) for a, b in zip(m, g)]
        return m
    train_c = [p for p, w in zip(pc, wrt) if w]
    train_h = [p for p, w in zip(ph, wrt) if w]
    p_err = param_gap(mean(gc), mean(gh), train_c, train_h, lr, 1e-8, names)
    frozen_moved = [n for n, a, b, c, d, w in zip(leaf_names(host), pc, sc,
                                                  ph, sh, wrt)
                    if not w and not (torch.equal(a, b) and torch.equal(c, d))]
    emit({"phase": "pretrained", "part": f"{part}, card vs CPU",
          "card": mc, "cpu": mh, "rel_err": errs, "params": p_err,
          "frozen_moved": frozen_moved, "tol": FP32_TOL})
    if not (max(errs.values()) <= FP32_TOL and p_err["worst"] <= 1.0
            and not frozen_moved):
        raise AssertionError(f"pretrained {part}: {errs}, {p_err}, "
                             f"{frozen_moved}")


def with_adapters(params, seed: int):
    """``params`` with its adapters' zero B factors drawn (N(0, 0.02)), so
    that the adapters act in a forward."""
    g = torch.Generator().manual_seed(seed)
    blocks = dict(params["blocks"])
    for k in sorted(blocks):
        if k.startswith("lora_") and k.endswith("_b"):
            blocks[k] = 0.02 * torch.randn(blocks[k].shape, generator=g).to(
                blocks[k].device)
    return dict(params, blocks=blocks)


def save_params_ckpt(path_dir: Path, params, cfg) -> Path:
    """``params`` as a self-describing epoch-0 ``.ckpt`` (fresh AdamW
    moments), what ``--init-from`` and ``--distill-from`` read."""
    from vitx_torch.train import make_optimizer
    from vitx_torch.train import checkpoint as ckpt
    from vitx_torch.train.step import TrainState

    state = TrainState(0, params, make_optimizer().init(params))
    return ckpt.save_checkpoint(path_dir, ckpt.snapshot(state, False), 0,
                                meta={"config": json.loads(cfg.to_json())})


def c_oracle_on_card(root: Path, errs: dict) -> None:
    """(f) ``csrc/vitc.c`` and ``csrc/trainc.c`` built with gcc into the
    build directory; the port's fp32 forward on the card on ``tiny``
    against vitc (FP32_TOL), and one train step of
    ``tests/test_c_oracle.py``'s case (16² images, E 16, depth 2, 2
    heads; lr 1e-3, weight decay 1e-4) against trainc's: the loss within
    5e-4, the params within 5e-3 relative + 2e-5 absolute."""
    import vitx_torch
    from vitx_torch.interop import cbin
    from vitx_torch.nn.vit import init_params
    from vitx_torch.train import make_optimizer, train_step
    from vitx_torch.train.step import TrainState

    src = Path(__file__).resolve().parent / "csrc"
    out = root / "cbin"
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    vitc = cbin.build_vitc(src / "vitc.c", out / "vitc")
    trainc = cbin.build_vitc(src / "trainc.c", out / "trainc")
    build_s = time.perf_counter() - t0
    cfg = vitx_torch.get_config("tiny", compute_dtype="float32")
    params = init_params(5, cfg)
    x = np.random.default_rng(6).standard_normal(
        (4, 64, 64, 3)).astype(np.float32)
    m, i, o = out / "m.bin", out / "i.bin", out / "o.bin"
    cbin.write_model_bin(m, params, cfg)
    cbin.write_input_bin(i, x)
    cbin.run_vitc(vitc, m, i, o)
    want = torch.from_numpy(cbin.read_output_bin(o, 4, cfg.num_classes))
    got = vitx_torch.forward(params, x, cfg)
    check("pretrained", "f: tiny fp32 on the card vs vitc", got, want,
          FP32_TOL, errs, "c_oracle", build_s=build_s)
    cfg = vitx_torch.ViTConfig(image_size=16, patch_size=4, num_classes=4,
                               embed_dim=16, depth=2, num_heads=2,
                               compute_dtype="float32", mlp_act="gelu")
    params = init_params(3, cfg)
    x = np.random.default_rng(4).standard_normal(
        (4, 16, 16, 3)).astype(np.float32)
    labels = np.array([0, 3, 1, 2], np.int32)
    d, m_out, ours = out / "d.bin", out / "m_out.bin", out / "ours.bin"
    cbin.write_model_bin(m, params, cfg)
    cbin.write_train_bin(d, x, labels)
    c_loss = cbin.run_trainc(trainc, m, d, 1, 1e-3, 1e-4, m_out)[0]
    opt = make_optimizer(lr=1e-3, weight_decay=1e-4)
    state, metrics = train_step(TrainState(0, params, opt.init(params)),
                                {"image": x, "label": labels}, cfg=cfg,
                                optimizer=opt)
    cbin.write_model_bin(ours, state.params, cfg)
    a, b = cbin.read_model_bin(ours, cfg), cbin.read_model_bin(m_out, cfg)
    gap = float(np.max(np.abs(a - b) - (2e-5 + 5e-3 * np.abs(b))))
    loss_err = abs(float(metrics["loss"]) - c_loss) / abs(c_loss)
    emit({"phase": "pretrained", "part": "f: one train step of the card vs "
          "trainc", "loss": float(metrics["loss"]), "trainc_loss": c_loss,
          "loss_rel_err": loss_err, "params_over_tol": gap})
    if loss_err > 5e-4 or gap > 0:
        raise AssertionError(f"pretrained (f): loss {loss_err}, params "
                             f"{gap}")


def step_times(tr, batch, reps: int = 5) -> float:
    """Median ms of ``tr.train_step`` on ``batch`` (host clock around each
    step, synchronised)."""
    ts = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.state, _ = tr.train_step(tr.state, batch, None)
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts[1:])


def phase_pretrained(errs: dict) -> tuple:
    """Main path 10, fine-tuning from public pretrained ViTs: (a) the
    imports (``pretrained_imports``); a base16 .ckpt trained one epoch on
    a CIFAR-10 copy at b128 through the train CLI; (b) LoRA rank 8 from
    it at b128, and from the imported timm ViT-B/16 (``--config-json``);
    (c) --llrd 0.65 --accum-steps 2 --mixup-alpha 0.8 --cutmix-alpha 1.0
    at b64 micro-batches, and --freeze-backbone at b128, with a frozen
    step's time beside a full step's; (d) small16 with the distillation
    token at b128 from the base16 .ckpt, soft and hard; the depth-2 fp32
    copies of (b)-(d), card vs CPU (``knob_card_vs_cpu``); (e) the eval
    CLI and a server on the LoRA and the distill-token .ckpts, top-1
    equal to direct calls, and the merged LoRA forward within BF16_TOL of
    the adapted one; (f) the C oracle (``c_oracle_on_card``). Returns
    (the launches of (a)-(e), the times' data)."""
    import os
    import shutil
    import warnings
    from types import SimpleNamespace

    import vitx_torch
    import vitx_torch.cli.eval as eval_cli
    import vitx_torch.cli.train as train_cli
    from vitx_torch import forward
    from vitx_torch.data import CIFAR10, BatchLoader, make_preprocess
    from vitx_torch.nn.lora import merge_lora_params
    from vitx_torch.nn.vit import init_params
    from vitx_torch.train import checkpoint as ckpt
    from vitx_torch.train import make_optimizer, make_train_step
    from vitx_torch.train.step import TrainState, tree_map

    root = BUILD / "pretrained"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    os.environ.setdefault("VITX_PROC_CACHE", str(BUILD / "procdata"))
    launches, timm_cfg, timm_params = pretrained_imports(errs)
    cifar = root / "cifar"
    write_cifar_copy(cifar, PRETRAINED_CIFAR)
    data = ["--data", f"cifar10:{cifar}"]

    # the base16 source: one epoch at b128 through the train CLI
    base_dir = root / "base"
    reset_counts()
    run_cli(train_cli.main, ["--preset", "base16", *data, "--epochs", "1",
                             "--batch-size", "128", "--seed", "0",
                             "--checkpoint-dir", str(base_dir)])
    launches = add_launches(launches, counts())
    base = base_dir / "0.ckpt"
    timm_json, timm_src = root / "timm.json", root / "timm"
    # measured without remat, as before vitx's default "block" took effect
    timm_json.write_text(timm_cfg.replace(remat="none").to_json())
    save_params_ckpt(timm_src, timm_params, timm_cfg)
    del timm_params

    # (b) LoRA
    lora = ["--lora-rank", "8", "--batch-size", "128", "--lr", "1e-3", *data]
    adapted = lambda n: not n.startswith(("head/", "blocks/lora_"))
    got, tr_lora, lora_dir, _ = knob_run(
        "b1", ["--preset", "base16", "--init-from", str(base), *lora], root,
        lambda c, s, e: lora_launches(c, s, e, False), frozen=adapted)
    launches = add_launches(launches, got)
    got, tr, _, _ = knob_run(
        "b2", ["--config-json", str(timm_json), "--init-from",
               str(timm_src), *lora], root,
        lambda c, s, e: lora_launches(c, s, e, True), frozen=adapted)
    launches = add_launches(launches, got)
    del tr

    # (c) the recipe knobs, then a frozen backbone
    got, tr, _, _ = knob_run(
        "c1", ["--preset", "base16", "--init-from", str(base), "--llrd",
               "0.65", "--accum-steps", "2", "--mixup-alpha", "0.8",
               "--cutmix-alpha", "1.0", "--batch-size", "64", "--lr", "3e-4",
               *data], root,
        lambda c, s, e: recipe_step_launches(c, s, e))
    launches = add_launches(launches, got)
    del tr
    got, tr, _, _ = knob_run(
        "c2", ["--preset", "base16", "--init-from", str(base),
               "--freeze-backbone", "--batch-size", "128", "--lr", "1e-3",
               *data], root, freeze_launches,
        frozen=lambda n: not n.startswith("head/"))
    launches = add_launches(launches, got)
    pre = make_preprocess(out_size=224, mean=(0.5,) * 3, std=(0.5,) * 3,
                          random_flip=False)
    val = CIFAR10(cifar, train=False)
    b = next(iter(BatchLoader(val, 128)))
    batch = {"image": pre(torch.from_numpy(b["image"]).cuda(), None,
                          train=False), "label": torch.from_numpy(
                              b["label"]).cuda()}
    full_opt = make_optimizer(lr=1e-3)
    p = tree_map(torch.clone, tr.state.params)
    full = SimpleNamespace(state=TrainState(0, p, full_opt.init(p)),
                           train_step=make_train_step(tr.cfg, full_opt))
    q = tree_map(torch.clone, tr_lora.state.params)
    lora_step = SimpleNamespace(
        state=TrainState(0, q, tr_lora.optimizer.init(q)),
        train_step=tr_lora.train_step)
    frozen_ms = [step_times(tr, batch)]
    full_ms = [step_times(full, batch)]
    lora_ms = [step_times(lora_step, batch), step_times(lora_step, batch)]
    full_ms.append(step_times(full, batch))
    frozen_ms.append(step_times(tr, batch))
    emit({"phase": "pretrained", "part": "c2: a frozen backbone's step and "
          "a LoRA step against a full step, base16 b128 bf16, in turns "
          "(host clock, synchronised, median of 5 each)", "card": smi(),
          "frozen_ms": frozen_ms, "lora_ms": lora_ms, "full_ms": full_ms})
    del tr, full, p, lora_step, q

    # (d) distillation with the token, soft and hard
    dist = ["--preset", "small16", "--distill-token", "--distill-from",
            str(base), "--batch-size", "128", "--lr", "1e-3", *data]
    teacher_cfg = ckpt.resolve_artifact_config(base)
    got, tr_dist, dist_dir, _ = knob_run(
        "d1", dist, root,
        lambda c, s, e: distill_launches(c, teacher_cfg, s, e))
    launches = add_launches(launches, got)
    got, tr, _, _ = knob_run(
        "d2", dist + ["--distill-hard"], root,
        lambda c, s, e: distill_launches(c, teacher_cfg, s, e))
    launches = add_launches(launches, got)
    del tr

    # the depth-2 fp32 copies, card vs CPU
    b2 = {"image": batch["image"][:2].cpu().numpy(),
          "label": b["label"][:2].astype(np.int32)}
    b2b = {"image": batch["image"][2:4].cpu().numpy(),
           "label": b["label"][2:4].astype(np.int32)}
    c32 = vitx_torch.get_config("base16", depth=2, compute_dtype="float32",
                                num_classes=10)
    lc = c32.replace(lora_rank=8)
    knob_card_vs_cpu("b: LoRA rank 8, base16 depth 2 fp32 b2", lc,
                     with_adapters(init_params(1, lc, device="cpu"), 2),
                     [b2], {"trainable": "lora"}, train_filter="lora",
                     lr=1e-3)
    tc = timm_cfg.replace(depth=2, compute_dtype="float32", num_classes=10,
                          lora_rank=8)
    knob_card_vs_cpu("b: LoRA rank 8, timm ViT-B/16 depth 2 fp32 b2", tc,
                     with_adapters(init_params(3, tc, device="cpu"), 4),
                     [b2], {"trainable": "lora"}, train_filter="lora",
                     lr=1e-3)
    box = np.ones((1, 224, 224, 1), np.float32)
    box[:, 40:150, 60:170] = 0.0
    mixes = [(np.array([1, 0]), np.full((1, 224, 224, 1), 0.7, np.float32)),
             (np.array([1, 0]), box)]
    knob_card_vs_cpu("c: LLRD 0.65, accumulation 2, mixup then cutmix maps, "
                     "base16 depth 2 fp32 b2 x 2", c32,
                     init_params(1, c32, device="cpu"), [b2, b2b],
                     {"llrd": 0.65, "llrd_depth": 2, "accum_steps": 2},
                     mixes=mixes)
    knob_card_vs_cpu("c: frozen backbone, base16 depth 2 fp32 b2", c32,
                     init_params(1, c32, device="cpu"), [b2],
                     {"trainable": "head"}, train_filter="head", lr=1e-3)
    sc = vitx_torch.get_config("small16", depth=2, compute_dtype="float32",
                               num_classes=10, distill_token=True)
    knob_card_vs_cpu("d: distillation token, small16 depth 2 fp32 b2 from "
                     "a base16 depth 2 teacher, B12 on the card", sc,
                     init_params(1, sc, device="cpu"), [b2],
                     {"fused": True},
                     teacher=(c32, init_params(7, c32, device="cpu")))

    # (e) eval and serving: LoRA merged, the distill token's mean heads
    imgs = batch["image"][:32].cpu().numpy()
    for part, tr, out in (("e1", tr_lora, lora_dir), ("e2", tr_dist,
                                                      dist_dir)):
        cfg = tr.cfg
        params, mcfg = merge_lora_params(tr.state.params, cfg)
        preds = root / f"{part}_preds.jsonl"
        reset_counts()
        report = run_cli(eval_cli.main, ["--checkpoint", str(out), *data,
                                         "--batch-size", "64", "--predict",
                                         str(preds)])
        launches = add_launches(launches, counts())
        direct = []
        for vb in BatchLoader(val, 64):
            x = pre(torch.from_numpy(vb["image"]).cuda(), None, train=False)
            direct += forward(params, x, mcfg).argmax(-1).tolist()
        cli_top1 = [val.classes.index(json.loads(r)["pred"])
                    for r in preds.read_text().splitlines()]
        emit({"phase": "pretrained", "part": f"{part}: cli.eval on "
              f"{out.name}'s .ckpt", "accuracy": report["accuracy"],
              "top1_equal": cli_top1 == direct})
        if cli_top1 != direct:
            raise AssertionError(f"pretrained ({part}): eval top-1 differs")
        launches = add_launches(launches, serve_ckpt(
            part, out / f"{PRETRAINED_EPOCHS - 1}.ckpt", cfg, params,
            imgs=imgs, phase="pretrained"))
    with torch.no_grad():
        x = torch.from_numpy(imgs).cuda()
        adapted_logits = forward(tr_lora.state.params, x, tr_lora.cfg)
        merged, mcfg = merge_lora_params(tr_lora.state.params, tr_lora.cfg)
        check("pretrained", "e: the merged LoRA forward vs the adapted one, "
              "base16 bf16 b32", forward(merged, x, mcfg), adapted_logits,
              BF16_TOL)
    del tr_lora, tr_dist, merged

    # (f) the C oracle
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        c_oracle_on_card(root, errs)
    return launches, {"frozen_ms": frozen_ms, "lora_ms": lora_ms,
                      "full_ms": full_ms}


def loader_rate(ds, batch: int) -> dict:
    """``BatchLoader`` alone over ``ds`` at 8 threads, twice (the second
    with the files in the page cache): img/s."""
    from vitx_torch.data import BatchLoader

    rates = []
    for _ in range(2):
        t0 = time.perf_counter()
        n = sum(int(b["mask"].sum()) for b in BatchLoader(
            ds, batch, shuffle=True, num_threads=8))
        rates.append(n / (time.perf_counter() - t0))
    return {"img_per_s_runs": rates, "batch": batch, "threads": 8}


def pageable_route(dev):
    """The synchronous route as a ``Trainer._prefetch``: each batch
    uploaded from its pageable host arrays on the step's stream as the
    loop reaches it (``.to(dev, non_blocking=True)``: from pageable memory
    the copy waits for the stream's earlier kernels)."""
    def batches(loader):
        for b in loader:
            yield {k: torch.from_numpy(np.asarray(v)).to(dev,
                                                        non_blocking=True)
                   for k, v in b.items()}
    return batches


def stamped(route, stamps: list):
    """``route`` with the host clock appended to ``stamps`` when the loop
    first asks for a batch and at each batch it hands over."""
    def batches(loader):
        stamps.append(time.perf_counter())
        for b in route(loader):
            stamps.append(time.perf_counter())
            yield b
    return batches


class Repeated:
    """``ds`` read ``times`` over (``len`` and ``get_example``, what
    ``BatchLoader`` reads): a longer epoch from the same files."""

    def __init__(self, ds, times: int):
        self.ds, self.times = ds, times

    def __len__(self):
        return len(self.ds) * self.times

    def get_example(self, i: int):
        return self.ds.get_example(i % len(self.ds))


def copy_overlap(prof) -> dict:
    """The host-to-device copies of a finished trace by (name, stream):
    count, ms copied and ms of it overlapped by a kernel on another
    stream; and the kernels' streams with their ms (the step's stream
    holds the most)."""
    import bisect

    copies, kernels = [], []
    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() != torch.autograd.DeviceType.CUDA
                or ev.is_async()
                or ev.start_thread_id() != ev.end_thread_id()):
            continue
        name, span = ev.name(), (ev.start_ns(), ev.end_ns(),
                                 ev.device_resource_id())
        if name.startswith("Memcpy HtoD"):
            copies.append((name, span))
        elif not name.startswith(("Memcpy", "Memset")) \
                and "spin_kernel" not in name:
            kernels.append(span)
    streams: dict = {}
    for a, b, st in kernels:
        streams[st] = streams.get(st, 0.0) + (b - a) / 1e6
    others: dict = {}     # stream -> the union of the other streams' kernels

    def union_without(st):
        if st not in others:
            merged: list = []
            for x, y in sorted((x, y) for x, y, s in kernels if s != st):
                if merged and x <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], y)
                else:
                    merged.append([x, y])
            others[st] = ([x for x, _ in merged], merged)
        return others[st]
    out: dict = {}
    for name, (a, b, st) in copies:
        starts, merged = union_without(st)
        over, i = 0, max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(merged) and merged[i][0] < b:
            over += max(0, min(merged[i][1], b) - max(merged[i][0], a))
            i += 1
        row = out.setdefault(f"{name} @ stream {st}", {
            "stream": st, "count": 0, "ms": 0.0, "overlapped_ms": 0.0})
        row["count"] += 1
        row["ms"] += (b - a) / 1e6
        row["overlapped_ms"] += over / 1e6
    step_stream = max(streams, key=streams.get) if streams else None
    return {"htod": out, "kernel_ms_by_stream": streams,
            "step_stream": step_stream}


def pinned_pool() -> dict:
    """The caching host allocator's pinned bytes (``host_memory_stats``,
    where this torch has it)."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return {"pinned": "not measured"}
    return {k: v for k, v in stats().items()
            if "bytes" in k or k.startswith("num_host")}


def placement_ms(image: np.ndarray, dev, reps: int = 10) -> dict:
    """One batch's uint8 images placed on ``dev`` with the card idle, host
    clock, median of ``reps``: ``pin``, ``device_prefetch``'s numpy copy
    into pinned memory (``_pinned``, in the step loop's thread);
    ``pinned_enqueue``, the copy from it enqueued on a side stream;
    ``pageable``, the synchronous route's upload to its end on the card."""
    from vitx_torch.data import pipeline

    t, side = torch.from_numpy(image), torch.cuda.Stream(dev)
    runs: dict = {"pin": [], "pinned_enqueue": [], "pageable": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pinned = pipeline._pinned(t)
        t1 = time.perf_counter()
        with torch.cuda.stream(side):
            pinned.to(dev, non_blocking=True)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        t.to(dev, non_blocking=True)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for key, ms in (("pin", t1 - t0), ("pinned_enqueue", t2 - t1),
                        ("pageable", t4 - t3)):
            runs[key].append(ms * 1e3)
    return {"bytes": image.nbytes, **{k: statistics.median(v)
                                      for k, v in runs.items()}}


def route_epochs(what: str, argv: list, plan: tuple, check: bool = False,
                 repeat: int = 1, profile_repeat: int = 1) -> dict:
    """A train-CLI trainer on ``argv`` through ``Trainer.fit``, one epoch
    a call (no eval), on the routes its loader reaches the card by:
    ``prefetch`` (``device_prefetch``, the trainer's own) and ``sync``
    (``pageable_route``). A warm-up epoch; with ``check``, one prefetched
    epoch and the same epoch again from the same state by this script's
    own loop over ``Trainer._step`` with a pageable upload, the params
    compared bit for bit, and ``placement_ms`` on its first batch; then
    the loader reads its dataset ``repeat`` times a timed epoch and
    ``profile_repeat`` times a profiled one (a trace of 64 steps takes
    seconds to read). ``plan``: (``log_every``, None for ``argv``'s; the
    routes timed in turns, in that order; the routes profiled). A timed
    epoch, on the host clock to its end on the card: img/s, the fill (ms
    from the loop's first request to its first batch) and the steady
    img/s (the batches after the first over the time from their first to
    the epoch's end); a profiled one: the busy share and the host-to-device
    copies (``copy_overlap``)."""
    import copy

    from vitx_torch.train.step import leaves

    tr, loader, _, _ = build_quietly(argv + ["--epochs", "1"])
    dev = tr.device
    routes = {"prefetch": tr._prefetch, "sync": pageable_route(dev)}
    done = [0]

    def epoch(route, stamps=None):
        tr._prefetch = (routes[route] if stamps is None
                        else stamped(routes[route], stamps))
        tr.start_epoch = done[0]
        tr.tcfg.epochs = done[0] = done[0] + 1
        return tr.fit(loader)[-1]

    out: dict = {}
    t0 = time.perf_counter()
    epoch("prefetch")
    out["warm_epoch_s"] = time.perf_counter() - t0
    emit({"phase": "times", "what": f"{what}: built and warm",
          "warm_epoch_s": out["warm_epoch_s"]})
    t0 = time.perf_counter()
    if check:
        start = copy.deepcopy(tr.state)
        e = done[0]
        epoch("prefetch")
        got = [t.clone() for t in leaves(tr.state.params)]
        tr.state = start
        loader.set_epoch(e)
        step, sync = int(start.step), pageable_route(dev)
        for i, b in enumerate(sync(loader)):
            tr._step(b, e, step + i)
        same = [torch.equal(a, b) for a, b in zip(got,
                                                  leaves(tr.state.params))]
        out["params_equal"] = all(same)
        out["leaves_equal"] = f"{sum(same)} of {len(same)}"
        out["check_s"] = time.perf_counter() - t0
        del got, start
        out["placement_ms"] = placement_ms(np.stack([
            loader.dataset.get_example(i)[0]
            for i in range(loader.batch_size)]), dev)
    base, batch = loader.dataset, loader.batch_size

    def read(times: int) -> int:
        loader.dataset = base if times == 1 else Repeated(base, times)
        return len(loader.dataset)
    out.update(images=read(repeat), steps=len(loader),
               profiled_images=len(base) * profile_repeat, pinned_pool=[])
    for log_every, timed, profiled in plan:
        if log_every is not None:
            tr.tcfg.log_every = log_every
        got = out.setdefault(f"log_every_{tr.tcfg.log_every}", {})
        got["turns"] = list(timed)
        n = read(repeat)
        for route in timed:
            stamps: list = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch(route, stamps)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for key, value in (
                    ("img_per_s", n / (t1 - t0)),
                    ("fill_ms", (stamps[1] - stamps[0]) * 1e3),
                    ("steady_img_per_s",
                     (len(stamps) - 2) * batch / (t1 - stamps[2]))):
                got.setdefault(key, {}).setdefault(route, []).append(value)
            if route == "prefetch":
                out["pinned_pool"].append(pinned_pool())
        read(profile_repeat)
        for route in profiled:
            traces: list = []
            prof = profile_call(
                f"{what} train epoch ({route}, log every "
                f"{tr.tcfg.log_every})", lambda: epoch(route), top=12,
                wall=True, keep=traces)
            if prof is None:
                got[route] = {"busy_share": "not measured",
                              "copies": "not measured"}
                continue
            busy_ms, wall_ms = prof
            got[route] = {"profiled_epoch_s": wall_ms / 1e3,
                          "epoch_device_ms": busy_ms,
                          "busy_share": busy_ms / wall_ms,
                          "copies": copy_overlap(traces[0])}
    return out


def check_copy_streams(name: str, got: dict) -> None:
    """A source's prefetched epochs: their batches' copies (from pinned
    memory) on a stream that is not the step's, where the profiler read
    an epoch."""
    for key, runs in got.items():
        pre = (runs.get("prefetch", {}) if key.startswith("log_every_")
               else {}).get("copies", "not measured")
        if pre == "not measured":
            continue
        pinned = [row["stream"] for k, row in pre["htod"].items()
                  if "Pinned" in k]
        if not pinned or pre["step_stream"] in pinned:
            raise AssertionError(
                f"times (h) {name}, {key}: the prefetched copies "
                f"{sorted(pre['htod'])} are not on a stream of their own "
                f"(step stream {pre['step_stream']})")


def transfer_routes_child(results, src: str, shards: str, cifar: str,
                          folder: str, t_start: float) -> None:
    """(h)'s epochs in a process of their own: the profiler keeps a young
    process's windows whole. A first profiler session (seconds of
    set-up), then the epochs; their result, or the traceback, goes to
    ``results``. ``t_start``: the script's clock, so that the lines
    printed here carry its ``t_s``."""
    import traceback

    from torch.profiler import ProfilerActivity, profile

    global T_START
    T_START = t_start
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda._sleep(100)
            torch.cuda.synchronize()
        emit({"phase": "times", "what": "transfer routes: set up"})
        pair = (None, ("prefetch", "sync"), ("prefetch", "sync"))
        results.put((True, {
            "shards_raw_384_b32": route_epochs(
                "transfer shards", transfer_args(
                    src, f"shards:{shards}", None, None),
                ((1, ("prefetch", "sync", "sync", "prefetch"),
                  ("prefetch", "sync")),
                 (64, ("sync", "prefetch"), ("prefetch",))),
                check=True, repeat=8, profile_repeat=2),
            "cifar10_224_b128": route_epochs("transfer CIFAR-10", [
                "--preset", "base16", "--data", f"cifar10:{cifar}",
                "--batch-size", "128", "--seed", "0"], (pair,)),
            "folder_png_384_b32": route_epochs(
                "transfer PNG folder", transfer_args(
                    src, f"folder:{folder}", None, None), (pair,))}))
    except BaseException:
        results.put((False, traceback.format_exc()))
        raise


def transfer_routes(info: dict) -> dict:
    """Run ``transfer_routes_child`` on ``info``'s data; its result, or
    RuntimeError with its traceback. The process is joined, or stopped,
    either way."""
    import queue

    import torch.multiprocessing as mpm

    mpc = mpm.get_context("spawn")
    results = mpc.Queue()
    proc = mpc.Process(target=transfer_routes_child, daemon=True, args=(
        results, str(info["src"]), str(info["shards"]), str(info["cifar"]),
        str(info["folder"]), T_START))
    proc.start()
    deadline = time.perf_counter() + 900
    try:
        while True:
            try:
                ok, value = results.get(timeout=1.0)
                break
            except queue.Empty:
                if not proc.is_alive() or time.perf_counter() > deadline:
                    ok, value = False, (f"no result (exit code "
                                        f"{proc.exitcode})")
                    break
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()
            proc.join()
    if not ok:
        raise RuntimeError(f"times (h): the epochs' process failed:\n{value}")
    return value


def phase_transfer_times(info: dict) -> None:
    """(h) The transfer path's times on this card: the fine-tune step at
    384² b32 (CUDA events, median of 5 after 1 warm-up; profiler split),
    the loader alone for the raw shards, the CIFAR copy and the PNG
    folder (decoded and resized by PIL), the host's cores, and each
    source's epochs on the routes of ``route_epochs`` (a process of their
    own, ``transfer_routes``, started once the kernel rows are timed):
    img/s, fill and steady img/s in turns, the busy share and the
    host-to-device copies' streams and overlap of a prefetched and a
    synchronous epoch, the pinned pool; the raw shards over 64 steps (16
    under the profiler) with a host read every step and every 64, and one
    batch's placement by each route; for the raw shards the prefetched
    and the synchronous epoch from one state end with equal params, bit
    for bit, or the phase fails."""
    import os
    import warnings

    from vitx_torch.data import CIFAR10, FolderDataset
    from vitx_torch.data.shards import ShardDataset
    from vitx_torch.train import (TrainState, checkpoint, make_optimizer,
                                  make_train_step)

    cfg, batch = info["cfg"], info["batch"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = checkpoint.transfer_params(info["src"], cfg, 0)
    opt = make_optimizer(lr=1e-4)
    holder = [TrainState(0, params, opt.init(params))]
    step = make_train_step(cfg, opt)

    def one_step():
        holder[0], _ = step(holder[0], batch)

    step_ms = cuda_ms(one_step, reps=5, warmup=1)
    step_device_ms = profile_call("transfer fine-tune step 384² b32",
                                  one_step, top=16)
    del holder, params
    shards = info["shards"]
    loaders = {
        "shards_raw_384": loader_rate(
            ShardDataset(shards / "train", test_size=None), 32),
        "cifar10_32": loader_rate(CIFAR10(info["cifar"]), 128),
        "folder_png_256_to_384": loader_rate(FolderDataset(
            info["folder"] / "Training", test_size=None, image_size=384),
            32)}
    epochs = transfer_routes(info)
    emit({"phase": "times", "what": "transfer", "card": smi(),
          "host_cpus": os.cpu_count(), "finetune_step_ms": step_ms,
          "finetune_step_img_per_s": 32 / (step_ms / 1e3),
          "finetune_step_device_ms": step_device_ms or "not measured",
          "T": cfg.seq_len, "loader": loaders, "epoch": epochs})
    for name, got in epochs.items():
        check_copy_streams(name, got)
    if not epochs["shards_raw_384_b32"]["params_equal"]:
        raise AssertionError(
            "times (h): the prefetched epoch of shards_raw_384_b32 and the "
            "synchronous one from the same state end with params that "
            f"differ ({epochs['shards_raw_384_b32']['leaves_equal']} "
            "leaves equal)")


def transfer_kernel_shapes(launches: dict, errs: dict) -> dict:
    """The transfer step's kernel shapes (base16 at 384², T 577, b32,
    bf16) as more ``shapes`` of the rows: K1's sm90 row with its stash,
    B2's two rows at (32, 12, 577, 64), B3's two at (32, 577, 768).
    Returns row name -> [entries]."""
    import vitx_torch
    from vitx_torch.kernels import fused_mha_block, mha_block_plain

    c = vitx_torch.get_config("base16", image_size=384)
    B, T, E, H, D = 32, c.seq_len, c.embed_dim, c.num_heads, c.head_dim
    eps = c.layer_norm_eps
    x, mha, _ = block_inputs(B, T, E, H, c.mlp_dim, torch.bfloat16, 61,
                             "cuda")
    rows = [kernel_row(
        "fused_mha_block_sm90",
        lambda: fused_mha_block(x, **mha, eps=eps, stash=True),
        lambda: mha_block_plain(x, **mha, eps=eps, stash=True),
        sdpa_mha(x, mha, H, eps),
        2 * B * T * E * 4 * E + 4 * B * H * T * T * D, PEAK_BF16_FLOPS,
        6 * B * T * E * 2 + 4 * E * E * 2 + 3 * E * 4 + 2 * B * H * T * 4,
        launches, errs, shape=[B, T, E], stash=True)]
    del x, mha
    rows += attention_bwd_rows((B, H, T, D), 63, launches, errs)
    rows += ln_bwd_rows((B, T, E), 65, eps, launches, errs)
    torch.cuda.empty_cache()
    extra: dict = {}
    for row in rows:
        extra.setdefault(row["name"], []).append(shape_entry(row))
    return extra


def card_rel_err(a, b) -> float:
    """max |a - b| / max |b|, computed on the card (for large tensors)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-12))


def delta(before: dict) -> dict:
    """The launches since the ``counts()`` snapshot ``before``."""
    now = counts()
    return {k: now[k] - before[k] for k in now}


def expect_launches(what: str, got: dict, expect: dict) -> None:
    if got != expect:
        raise AssertionError(f"{what}: launches {got}, expected {expect}")


def rollout_launches(cfg, calls: int = 1) -> dict:
    """forward_with_rollout on the fused path: B7 in every block, K2 in
    every dense one."""
    return block_launches(
        cfg, fused_mha_block_with_mean_probs=cfg.depth * calls,
        fused_mlp_block=cfg.dense_block_count * calls)


def gradcam_launches(cfg, calls: int = 1) -> dict:
    """grad_cam: K1 in every block and K2 in every dense one; the last
    block's backward runs B2 once (on its sm90 route in bf16 at D 64) and
    B3 for LN1 (inside K1's backward) and LN2 (inside K2's, or a Soft-MoE
    block's add-LayerNorm), and B3 again for the head's LayerNorms and the
    final norm. With fuse_mha="off" B5 without probs takes K1's place in
    every block (its sm90 route likewise)."""
    b3 = 2 + head_lns(cfg) + int(cfg.final_norm)
    attn = ({"flash_attention": cfg.depth * calls,
             "flash_attention_sm90": cfg.depth * calls * sm90(cfg)}
            if cfg.fuse_mha == "off" else
            {"fused_mha_block": cfg.depth * calls})
    return block_launches(cfg, **attn,
                          fused_mlp_block=cfg.dense_block_count * calls,
                          attention_bwd=calls,
                          attention_bwd_sm90=calls * sm90(cfg),
                          ln_bwd=b3 * calls)


def add_launches(*dicts) -> dict:
    return {k: sum(d.get(k, 0) for d in dicts)
            for k in (*KERNELS, *EXTRA_COUNTERS)}


def explain_images(cfg, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def phase_explain(cfg, params) -> dict:
    """Main path 3: large16_384 explained on the card. Returns its
    launches (all four parts, the server's warm-up included; not the
    reference route's)."""
    import vitx_torch
    from vitx_torch import (forward, forward_with_attn, forward_with_rollout,
                            grad_cam)
    from vitx_torch.nn.vit import init_params, params_to

    ref_cfg = cfg.replace(attn_impl="reference", fuse_mha="off",
                          fuse_mlp="off")
    reset_counts()
    start = counts()
    expected = []

    # (a) the rollout at batch 8, kernels against the kernel-free route
    imgs = explain_images(cfg, 8, 5)
    snap = counts()
    logits, weights = forward_with_rollout(params, imgs, cfg)
    torch.cuda.synchronize()
    got = delta(snap)
    expect_launches("(a) rollout", got, rollout_launches(cfg))
    expected.append(got)
    snap = counts()
    ref_logits, ref_weights = forward_with_rollout(params, imgs, ref_cfg)
    torch.cuda.synchronize()
    expect_launches("(a) reference rollout", delta(snap), launches_of())
    errs = {"logits": card_rel_err(logits, ref_logits),
            "rollout": card_rel_err(weights, ref_weights)}
    sums = float((weights.double().sum(-1) - 1).abs().max())
    emit({"phase": "explain", "part": "a: rollout b8 bf16, kernels vs "
          "reference route", "rel_err": errs, "row_sum_dev": sums,
          "launches": got, "tol": EXPLAIN_TOL,
          "shape": list(weights.shape)})
    if not (max(errs.values()) <= EXPLAIN_TOL and sums <= 1e-4
            and weights.shape == (8, cfg.num_patches)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"(a) rollout: {errs}, row sums +- {sums}")
    del logits, weights, ref_logits, ref_weights

    # (a) Grad-CAM at batch 8, kernels against the reference route, whose
    # LayerNorm backwards are B3 as everywhere on the card; both for the
    # classes the kernels' logits pick (random weights leave near ties,
    # which the routes' bf16 rounding could break apart)
    snap = counts()
    heat, logits = grad_cam(params, imgs, cfg)
    torch.cuda.synchronize()
    got = delta(snap)
    expect_launches("(a) grad_cam", got, gradcam_launches(cfg))
    expected.append(got)
    snap = counts()
    ref_heat, ref_logits = grad_cam(params, imgs, ref_cfg,
                                    class_idx=logits.argmax(-1))
    torch.cuda.synchronize()
    ref_got = delta(snap)
    expect_launches("(a) reference grad_cam", ref_got, launches_of(
        ln_bwd=gradcam_launches(cfg)["ln_bwd"]))
    errs = {"logits": card_rel_err(logits, ref_logits),
            "heatmap": card_rel_err(heat, ref_heat)}
    cos = torch.nn.functional.cosine_similarity(heat, ref_heat, dim=-1)
    emit({"phase": "explain", "part": "a: grad_cam b8 bf16, kernels vs "
          "reference route", "rel_err": errs, "cosine": cos.tolist(),
          "launches": got,
          "reference_launches": ref_got, "tol": GRADCAM_TOL,
          "shape": list(heat.shape)})
    if not (max(errs.values()) <= GRADCAM_TOL
            and heat.shape == (8, cfg.num_patches)
            and bool(torch.isfinite(heat).all())):
        raise AssertionError(f"(a) grad_cam: {errs}")
    del heat, logits, ref_heat, ref_logits

    # (b) forward_with_attn("full") at batch 2
    imgs = explain_images(cfg, 2, 6)
    snap = counts()
    logits, probs = forward_with_attn(params, imgs, cfg)
    torch.cuda.synchronize()
    got = delta(snap)
    expect_launches("(b) forward_with_attn", got, block_launches(
        cfg, flash_attention_with_probs=cfg.depth,
        flash_attention_with_probs_sm90=cfg.depth * sm90(cfg),
        fused_mlp_block=cfg.depth))
    expected.append(got)
    snap = counts()
    ref_logits, ref_probs = forward_with_attn(params, imgs, ref_cfg)
    torch.cuda.synchronize()
    expect_launches("(b) reference forward_with_attn", delta(snap),
                    launches_of())
    errs = {"logits": card_rel_err(logits, ref_logits),
            "probs": card_rel_err(probs, ref_probs)}
    shape = (cfg.depth, 2, cfg.num_heads, cfg.seq_len, cfg.seq_len)
    emit({"phase": "explain", "part": "b: forward_with_attn full b2 bf16, "
          "kernels vs reference route", "rel_err": errs, "launches": got,
          "tol": EXPLAIN_TOL, "shape": list(probs.shape)})
    if not (max(errs.values()) <= EXPLAIN_TOL and probs.shape == shape):
        raise AssertionError(f"(b) forward_with_attn: {errs}")
    del logits, probs, ref_logits, ref_probs
    torch.cuda.empty_cache()

    # (b') the composed path (fuse_mha="off") in bf16 at batch 8: B5
    # without probs in every block, on its sm90 route; Grad-CAM through it
    # runs B5's sm90 forward with its statistics and B2's sm90 backward.
    # Both against the kernel-free route, as (a)
    off = cfg.replace(fuse_mha="off")
    imgs = explain_images(cfg, 8, 8)
    snap = counts()
    logits = forward(params, imgs, off)
    torch.cuda.synchronize()
    got = delta(snap)
    expect_launches("(b') forward, fuse_mha off", got, block_launches(
        cfg, flash_attention=cfg.depth, flash_attention_sm90=cfg.depth,
        fused_mlp_block=cfg.depth))
    expected.append(got)
    heat, cam_logits = grad_cam(params, imgs, off)
    torch.cuda.synchronize()
    got = delta(snap)
    expect_launches("(b') forward and grad_cam, fuse_mha off", got,
                    add_launches(expected[-1], gradcam_launches(off)))
    expected[-1] = got
    snap = counts()
    ref_logits = forward(params, imgs, ref_cfg)
    ref_heat, _ = grad_cam(params, imgs, ref_cfg,
                           class_idx=cam_logits.argmax(-1))
    torch.cuda.synchronize()
    ref_off = delta(snap)
    expect_launches("(b') reference forward and grad_cam", ref_off,
                    launches_of(ln_bwd=gradcam_launches(cfg)["ln_bwd"]))
    errs = {"logits": card_rel_err(logits, ref_logits),
            "heatmap": card_rel_err(heat, ref_heat)}
    emit({"phase": "explain", "part": "b': forward and grad_cam b8 bf16, "
          "fuse_mha off (B5 and B2 on their sm90 routes) vs reference "
          "route", "rel_err": errs, "launches": got,
          "tol": {"logits": EXPLAIN_TOL, "heatmap": GRADCAM_TOL}})
    if not (errs["logits"] <= EXPLAIN_TOL and errs["heatmap"] <= GRADCAM_TOL
            and bool(torch.isfinite(heat).all())):
        raise AssertionError(f"(b') fuse_mha off: {errs}")
    del logits, heat, cam_logits, ref_logits, ref_heat
    torch.cuda.empty_cache()

    # (e) the model with QKV biases (the original ViT-L/16's and timm's),
    # at full width and depth, bf16, batch 8: every block takes the
    # composed path, its attention B5's head-mean mode on the sm90 route;
    # rollout and forward_with_attn("mean") against the reference route
    expected.append(explain_qkv_bias(cfg, params, ref_cfg))

    # (c) a depth-2 float32 copy, card against CPU
    cfg2 = vitx_torch.get_config("large16_384", depth=2,
                                 compute_dtype="float32")
    off2 = cfg2.replace(fuse_mha="off")
    host = init_params(0, cfg2, device="cpu")
    card = params_to(host, "cuda")
    imgs = explain_images(cfg2, 2, 7)
    runs = (
        ("rollout", cfg2, lambda p, c, d: forward_with_rollout(
            p, imgs, c, device=d), rollout_launches(cfg2)),
        ("grad_cam", cfg2, lambda p, c, d: grad_cam(p, imgs, c, device=d),
         gradcam_launches(cfg2)),
        ("forward, fuse_mha off", off2, lambda p, c, d: forward(
            p, imgs, c, device=d), launches_of(
                flash_attention=2, fused_mlp_block=2)),
        ("forward_with_attn mean, fuse_mha off", off2,
         lambda p, c, d: forward_with_attn(p, imgs, c, probs_mode="mean",
                                           device=d),
         launches_of(flash_attention_with_mean_probs=2, fused_mlp_block=2)),
    )
    for what, c, fn, expect in runs:
        snap = counts()
        out = fn(card, c, "cuda")
        torch.cuda.synchronize()
        got = delta(snap)
        expect_launches(f"(c) {what}", got, expect)
        expected.append(got)
        check("explain", f"c: {what}, large16_384 depth 2 fp32, card vs "
              "CPU", out, fn(host, c, "cpu"), FP32_TOL, launches=got)
    del host, card

    # (d) the server's /explain, 16 requests from 4 threads
    got, *served = phase_explain_serve(cfg, params)
    expected.append(got)
    # the main path's launches: all but the reference Grad-CAMs'
    total = {k: n - ref_got[k] - ref_off[k]
             for k, n in delta(start).items()}
    expect_launches("explain phase", total, add_launches(*expected))
    verify_explains(cfg, params, *served)
    return total


def qkv_bias_model(cfg, params) -> tuple:
    """(cfg with QKV biases, ``params`` with a random bqkv from seed 0):
    the same weights plus a bias of a projection's scale in every block."""
    D = cfg.embed_dim // cfg.num_heads
    blocks = dict(params["blocks"],
                  bqkv=seeded((cfg.depth, 3, cfg.num_heads, D), 0, 0.1))
    return cfg.replace(qkv_bias=True), dict(params, blocks=blocks)


def bias_rollout_launches(cfg, calls: int = 1) -> dict:
    """forward_with_rollout (or forward_with_attn("mean")) with QKV biases:
    the composed block, B5's head mean and K2 in every block, B5 on its
    sm90 route in bf16 at D 32, 64 and 128."""
    n = cfg.depth * calls
    return block_launches(
        cfg, flash_attention_with_mean_probs=n,
        flash_attention_with_mean_probs_sm90=n * sm90(cfg),
        fused_mlp_block=n)


def explain_qkv_bias(cfg, params, ref_cfg) -> dict:
    """Explain (e): large16_384 with QKV biases, bf16, batch 8, rollout and
    forward_with_attn("mean") on the kernels against the kernel-free route
    (EXPLAIN_TOL), launches B5's head mean 24 (sm90 24), K2 24, nothing
    else. Returns the launches."""
    from vitx_torch import forward_with_attn, forward_with_rollout

    bcfg, bparams = qkv_bias_model(cfg, params)
    bref = ref_cfg.replace(qkv_bias=True)
    imgs = explain_images(cfg, 8, 11)
    snap = counts()
    logits, weights = forward_with_rollout(bparams, imgs, bcfg)
    torch.cuda.synchronize()
    got = delta(snap)
    expect_launches("(e) rollout, QKV biases", got,
                    bias_rollout_launches(bcfg))
    snap = counts()
    ref_logits, ref_weights = forward_with_rollout(bparams, imgs, bref)
    torch.cuda.synchronize()
    expect_launches("(e) reference rollout", delta(snap), launches_of())
    errs = {"logits": card_rel_err(logits, ref_logits),
            "rollout": card_rel_err(weights, ref_weights)}
    sums = float((weights.double().sum(-1) - 1).abs().max())
    emit({"phase": "explain", "part": "e: rollout b8 bf16 with QKV biases "
          "(composed path, B5's head mean), kernels vs reference route",
          "rel_err": errs, "row_sum_dev": sums, "launches": got,
          "tol": EXPLAIN_TOL, "shape": list(weights.shape)})
    if not (max(errs.values()) <= EXPLAIN_TOL and sums <= 1e-4
            and weights.shape == (8, cfg.num_patches)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"(e) rollout: {errs}, row sums +- {sums}")
    del logits, weights, ref_logits, ref_weights
    snap = counts()
    logits, probs = forward_with_attn(bparams, imgs, bcfg, probs_mode="mean")
    torch.cuda.synchronize()
    got_attn = delta(snap)
    expect_launches("(e) forward_with_attn mean, QKV biases", got_attn,
                    bias_rollout_launches(bcfg))
    snap = counts()
    ref_logits, ref_probs = forward_with_attn(bparams, imgs, bref,
                                              probs_mode="mean")
    torch.cuda.synchronize()
    expect_launches("(e) reference forward_with_attn", delta(snap),
                    launches_of())
    errs = {"logits": card_rel_err(logits, ref_logits),
            "probs": card_rel_err(probs, ref_probs)}
    shape = (cfg.depth, 8, cfg.seq_len, cfg.seq_len)
    emit({"phase": "explain", "part": "e: forward_with_attn mean b8 bf16 "
          "with QKV biases, kernels vs reference route", "rel_err": errs,
          "launches": got_attn, "tol": EXPLAIN_TOL,
          "shape": list(probs.shape)})
    if not (max(errs.values()) <= EXPLAIN_TOL and probs.shape == shape):
        raise AssertionError(f"(e) forward_with_attn mean: {errs}")
    del logits, probs, ref_logits, ref_probs, bparams
    torch.cuda.empty_cache()
    return add_launches(got, got_attn)


def phase_explain_serve(cfg, params) -> tuple:
    """(d): an InferenceServer for ``cfg`` behind its HTTP front end; 16
    /explain requests, rollout and gradcam mixed, with and without a
    class, from 4 threads. Returns (the launches, the server's warm-up
    forward included; the images, queries and answers)."""
    import io
    import urllib.request

    from vitx_torch.cli.serve import serve_in_thread
    from vitx_torch.serve import InferenceServer

    queries = []
    for i in range(16):       # 8 rollouts, 4 gradcams with a class
        if i % 2 == 0:
            queries.append(("rollout", None))
        elif i % 4 == 1:
            queries.append(("gradcam", None))
        else:
            queries.append(("gradcam", (37 * i) % cfg.num_classes))
    alone = 3                 # then each method 3 times, one at a time
    queries += [(m, None) for m in ("rollout", "gradcam")
                for _ in range(alone)]
    n = len(queries)
    imgs = explain_images(cfg, n, 8)
    results, millis = [None] * n, [0.0] * n
    snap = counts()
    with InferenceServer(params, cfg, batch_size=4, top_k=5) as srv:
        httpd, _ = serve_in_thread(srv)
        base = f"http://127.0.0.1:{httpd.server_port}/explain"

        def send(i):
            method, cls = queries[i]
            url = f"{base}?method={method}"
            if cls is not None:
                url += f"&class={cls}"
            buf = io.BytesIO()
            np.save(buf, imgs[i])
            req = urllib.request.Request(url, data=buf.getvalue(),
                                         method="POST")
            t0 = time.perf_counter()
            results[i] = json.loads(urllib.request.urlopen(
                req, timeout=600).read())
            millis[i] = (time.perf_counter() - t0) * 1e3

        try:
            threads = [threading.Thread(
                target=lambda c: [send(i) for i in range(c, 16, 4)],
                args=(c,)) for c in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=900)
            if any(t.is_alive() for t in threads):
                raise AssertionError("explain: clients did not finish")
            for i in range(16, n):
                send(i)
            if None in results:
                raise AssertionError("explain: requests went unanswered")
            stats = srv.stats.summary()
        finally:
            httpd.shutdown()
            httpd.server_close()
    got = delta(snap)
    n_roll = sum(m == "rollout" for m, _ in queries)
    expect = add_launches(forward_launches(cfg, 1),
                          rollout_launches(cfg, n_roll),
                          gradcam_launches(cfg, n - n_roll))
    expect_launches("(d) server explain", got, expect)
    if stats["explains"] != n:
        raise AssertionError(f"explain stats: {stats}")
    queued, single = {}, {}
    for method in ("rollout", "gradcam"):
        ms = sorted(m for m, (q, _) in zip(millis[:16], queries)
                    if q == method)
        queued[method] = {"n": len(ms), "p50_ms": ms[len(ms) // 2],
                          "p90_ms": ms[min(len(ms) - 1, int(0.9 * len(ms)))]}
        single[method] = {"n": alone, "median_ms": statistics.median(
            m for m, (q, _) in zip(millis[16:], queries[16:])
            if q == method)}
    emit({"phase": "explain", "part": "d: server /explain, 16 requests "
          "from 4 threads (queued: queue wait plus service), then each "
          "method alone (service time)", "latency": queued,
          "alone": single, "stats": stats, "launches": got})
    return got, imgs, queries, results


def verify_explains(cfg, params, imgs, queries, results) -> None:
    """Each served heatmap and top-k equal to a direct call of
    ``forward_with_rollout`` / ``grad_cam`` on the same image."""
    from vitx_torch import forward_with_rollout, grad_cam

    for i, (method, cls) in enumerate(queries):
        x = torch.from_numpy(imgs[i:i + 1]).cuda().to(cfg.cdtype())
        if method == "rollout":
            logits, heat = forward_with_rollout(params, x, cfg)
        else:
            heat, logits = grad_cam(params, x, cfg, class_idx=cls)
        probs, classes = torch.topk(torch.softmax(logits.float(), -1), 5)
        got = results[i]
        if (got["classes"] != classes[0].tolist()
                or got["method"] != method or got["grid"] != cfg.grid_size):
            raise AssertionError(f"explain {i} ({method}, {cls}): served "
                                 f"{got['classes']}, direct "
                                 f"{classes[0].tolist()}")
        np.testing.assert_allclose(got["probs"], probs[0].cpu().numpy(),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(got["heatmap"],
                                   heat[0].float().cpu().numpy(),
                                   rtol=1e-6, atol=1e-9)
    emit({"phase": "explain", "check": "served heatmaps and top-k equal "
          "direct calls", "requests": len(queries)})


def device_records(prof) -> dict:
    """{name: [device ms, records]} over a finished trace's device records
    (kernels, copies, sets), read from the profiler's raw records as
    ``key_averages()`` reads them (its device rows, synchronous records
    only). ``key_averages()`` itself first builds an event for every host
    record, which over a train epoch takes tens of seconds."""
    rows = {}
    for ev in prof.profiler.kineto_results.events():
        if (ev.device_type() != torch.autograd.DeviceType.CUDA
                or ev.is_async()
                or ev.start_thread_id() != ev.end_thread_id()):
            continue
        row = rows.setdefault(ev.name(), [0.0, 0])
        row[0] += (ev.end_ns() - ev.start_ns()) / 1e6
        row[1] += 1
    return rows


def profile_call(what: str, fn, top: int = 12, calls: int = 1,
                 wall: bool = False, keep: list | None = None):
    """Device time by kernel name over ``calls`` calls of ``fn``
    (torch.profiler), and the device's busy share of their wall time.
    Returns the device time a call, ms (with ``wall``: and the window's
    wall time, ms), or None where the profiler saw no device time; a
    window that was read is appended to ``keep``.

    The trace drops a window's first activity records, more of them the
    longer the process has run, and where it drops many it also shrinks
    the durations it keeps (PERF.md, Findings, PR 14): PROFILE_LEAD spin
    kernels open the window, finished before ``fn`` runs, and are left
    out of the rows. A window that kept fewer than PROFILE_LEAD_KEPT of
    them is traced again, up to PROFILE_TRIES windows in all, and reads
    as not measured if none kept enough."""
    from torch.profiler import ProfilerActivity, profile

    for tries in range(1, PROFILE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows, lead_kept = [], 0
        for key, (ms, n) in device_records(prof).items():
            if "spin_kernel" in key:
                lead_kept += n
            elif ms > 0:
                rows.append((ms, n, key[:90]))
        if lead_kept >= PROFILE_LEAD_KEPT:
            break
    else:
        rows = []
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    # a call's device time: each kernel's mean launch times its launches a
    # call
    per_call = sum(ms / n * max(1, round(n / calls)) for ms, n, _ in rows)
    emit({"phase": "profile", "what": what, "calls": calls,
          "wall_ms": wall_ms, "lead_kept": lead_kept, "tries": tries,
          "device_busy_ms": busy_ms if rows else "not measured",
          "busy_share": busy_ms / wall_ms if rows else "not measured",
          "top": [{"ms": ms, "count": n, "kernel": k}
                  for ms, n, k in rows[:top]]})
    if not rows:
        return None
    if keep is not None:
        keep.append(prof)
    return (per_call, wall_ms) if wall else per_call


def profile_window_check(what: str, fn, calls: int = 5) -> None:
    """The records the trace keeps at this point of the run of ``calls``
    calls of ``fn``: in a bare window, and in one opened by PROFILE_LEAD
    spin kernels as ``profile_call`` opens it (the spin kernels it kept
    beside)."""
    from torch.profiler import ProfilerActivity, profile

    kept = {}
    for lead in (0, PROFILE_LEAD):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        evs = device_records(prof)
        kept[lead] = [sum(n for k, (_, n) in evs.items()
                          if "spin_kernel" not in k),
                      sum(n for k, (_, n) in evs.items()
                          if "spin_kernel" in k)]
    emit({"phase": "times", "what": f"profiler window: {what}",
          "calls": calls, "kernel_records_bare": kept[0][0],
          "kernel_records_led": kept[PROFILE_LEAD][0],
          "lead": PROFILE_LEAD, "lead_records_kept": kept[PROFILE_LEAD][1]})


def phase_times(cfg, params, errs: dict, launches: dict) -> list:
    """The forward at batch 256 and the K1/K2 rows at its shapes."""
    import torch.nn.functional as F

    from vitx_torch import forward
    from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    B, E, H = 256, cfg.embed_dim, cfg.num_heads
    T, M, D = cfg.seq_len, cfg.mlp_dim, cfg.head_dim
    images = torch.randn(B, cfg.image_size, cfg.image_size, 3,
                         device="cuda", generator=torch.Generator(
                             "cuda").manual_seed(3)).to(torch.bfloat16)
    fwd_ms = cuda_ms(lambda: forward(params, images, cfg), reps=10)
    emit({"phase": "times", "what": "forward", "batch": B,
          "ms": fwd_ms, "img_per_s": B / (fwd_ms / 1000.0)})
    profile_call("forward", lambda: forward(params, images, cfg))

    x, mha, mlp = block_inputs(B, T, E, H, M, torch.bfloat16, 4, "cuda")
    bf = torch.bfloat16
    eps = cfg.layer_norm_eps
    profile_window_check("fused_mha_block b256",
                         lambda: fused_mha_block(x, **mha, eps=eps))
    w1_t, w2_t = mlp["w1"].t().contiguous(), mlp["w2"].t().contiguous()
    lib_mha = sdpa_mha(x, mha, H, eps)

    def lib_mlp():
        h = F.layer_norm(x, (E,), mlp["g"].to(bf), mlp["b"].to(bf), eps)
        h = F.gelu(F.linear(h, w1_t, mlp["b1"].to(bf)), approximate="tanh")
        return F.linear(h, w2_t, mlp["b2"].to(bf))

    item = 2
    rows = B * T
    k1_flops = 2 * rows * E * 3 * E + 2 * rows * E * E + 4 * B * H * T * T * D
    k1_bytes = 2 * rows * E * item + 4 * E * E * item + 3 * E * 4
    k2_flops = 4 * rows * E * M
    k2_bytes = 2 * rows * E * item + 2 * E * M * item + (M + 3 * E) * 4
    import importlib

    tmlp = importlib.import_module("vitx_torch.kernels.mlp_block")
    st = torch.empty((2, B, H, T), dtype=torch.float32, device="cuda")
    runs = (
        ("fused_mha_block", lambda: fused_mha_block(x, **mha, eps=eps),
         lambda: block_module()._launch(x, **mha, eps=eps, extra=(st,),
                                        route=0),
         lambda: mha_block_plain(x, **mha, eps=eps), lib_mha, k1_flops,
         k1_bytes),
        ("fused_mlp_block",
         lambda: fused_mlp_block(x, **mlp, act=cfg.mlp_act, eps=eps),
         lambda: tmlp._launch(x, **mlp, act=cfg.mlp_act, eps=eps,
                              stash=False, route=0),
         lambda: mlp_block_plain(x, **mlp, act=cfg.mlp_act, eps=eps),
         lib_mlp, k2_flops, k2_bytes))
    out = []
    for name, kern, earlier, plain, lib, flops, nbytes in runs:
        out += block_rows(name, kern, earlier, plain, lib, flops, nbytes,
                          launches, errs, shape=[B, T, E])
    return out


def block_rows(name, kern, earlier, plain, lib, flops, nbytes, launches,
               errs, was=None, was_what=None, **extra) -> list:
    """A block kernel's two rows on the same bf16 inputs: ``name``, the
    earlier route (gemm_kernel, attention_fwd.cuh) through its launcher,
    which the wrapper keeps for fp32 and shapes TMA cannot take; and its
    sm90 row, the wrapper's own call, with the earlier route's time beside
    it as ``was_ms`` -- or, given ``was`` (described by ``was_what``), that
    call's time, taken between the two rows."""
    base = kernel_row(name, earlier, plain, lib, flops, PEAK_BF16_FLOPS,
                      nbytes, launches, errs, timed="the earlier route on "
                      "bf16 through its launcher; the wrapper sends these "
                      "inputs to " + BLOCK_SM90[name], **extra)
    more = {"was_ms": base["ms"]}
    if was is not None:
        runs = [cuda_ms(was, reps=20), cuda_ms(was, reps=20)]
        more = {"was_ms": min(runs), "was": was_what, "was_ms_runs": runs,
                "earlier_kernels_ms": base["ms"]}
    now = kernel_row(BLOCK_SM90[name], kern, plain, lib, flops,
                     PEAK_BF16_FLOPS, nbytes, launches, errs, **more,
                     **extra)
    return [base, now]


def kernel_row(name, kern, plain, lib, flops, peak, nbytes, launches,
               errs, **extra) -> dict:
    """Time ``kern`` twice between two runs of ``plain`` (compare only
    within this call), and ``lib``; profile five calls of ``kern``, whose
    device time a call is ``device_ms`` (``ms`` also holds the host's time
    between the two events where the wrapper's Python outlasts the
    kernels); the bound is max(flops / peak, bytes / HBM rate)."""
    plain_ms = cuda_ms(plain, reps=3, warmup=1)
    ms = cuda_ms(kern, reps=20)
    ms2 = cuda_ms(kern, reps=20)
    plain_ms2 = cuda_ms(plain, reps=3, warmup=1)
    lib_ms = cuda_ms(lib, reps=20) if lib is not None else None
    device_ms = profile_call(name, kern, calls=5)
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound = max(t_ops, t_bytes)
    row = {"name": name, "route": "cuda", **KERNELS[name],
           "launches": launches.get(name), "max_abs_err": errs.get(name),
           "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
           "bound_ms": bound,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "share_of_bound": bound / min(ms, ms2),
           "device_share_of_bound": (bound / device_ms if device_ms
                                     else "not measured"),
           "library_ms": lib_ms, "device_ms": device_ms or "not measured",
           "flops": flops, "bytes": nbytes,
           "tflops": flops / (min(ms, ms2) * 1e-3) / 1e12, **extra}
    emit({"phase": "times", "what": name, "ms_runs": [ms, ms2],
          "plain_ms_runs": [plain_ms, plain_ms2], **row})
    return row


def attention_bwd_rows(shape, seed, launches, errs, per_step=None,
                       only=None):
    """The rows of B2's two kernels at (B, H, T, D) bf16: the earlier
    kernel through its launcher, then the sm90 kernel through
    ``attention_bwd`` with the forward's o and statistics and the former's
    time as was_ms; SDPA's backward beside both. The bound is the
    function's: q, k, v, do in, dq, dk, dv out, 10*B*H*T^2*D operations,
    whatever a kernel reads besides. ``only``: that row alone."""
    import torch.nn.functional as F

    from vitx_torch.kernels import (attention_bwd, attention_bwd_plain,
                                    attention_stats_plain,
                                    flash_attention_fwd_plain)

    B, H, T, D = shape
    bf = torch.bfloat16
    q, k, v = (seeded(shape, seed + i, 1.5, dtype=bf) for i in range(3))
    do = seeded(shape, seed + 3, 0.1, dtype=bf)
    o, st = flash_attention_fwd_plain(q, k, v), attention_stats_plain(q, k)
    qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qs, ks, vs)
    tflash = attention_module()
    per_step = per_step or {}
    rows = []
    for name, kern in (
            ("attention_bwd", lambda: tflash._bwd_wmma(q, k, v, do)),
            ("attention_bwd_sm90",
             lambda: attention_bwd(q, k, v, do, o, st))):
        if only not in (None, name):
            continue
        extra = {"per_step": per_step[name]} if name in per_step else {}
        if name == "attention_bwd":
            extra["timed"] = ("the earlier kernel on bf16 through its "
                              "launcher; the wrapper sends bf16 at D 32, 64 "
                              "and 128 to attention_bwd_sm90 and this kernel "
                              "fp32 and other D")
        elif rows:
            extra["was_ms"] = rows[-1]["ms"]
        rows.append(kernel_row(
            name, kern, lambda: attention_bwd_plain(q, k, v, do),
            lambda: torch.autograd.grad(o_lib, (qs, ks, vs), do,
                                        retain_graph=True),
            10 * B * H * T * T * D, PEAK_BF16_FLOPS, 7 * B * H * T * D * 2,
            launches, errs, shape=list(shape), **extra))
    return rows


def flash_rows(shape, seed, launches, errs) -> list:
    """B5 without probs at (B, H, T, D) bf16: the earlier kernel through
    its launcher, then the wrapper's sm90 route with the former's time as
    was_ms; SDPA beside both. Bound: q, k, v in, o out, 4*B*H*T^2*D
    operations."""
    import torch.nn.functional as F

    from vitx_torch.kernels import flash_attention, flash_attention_fwd_plain

    B, H, T, D = shape
    q, k, v = (seeded(shape, seed + i, 1.5, dtype=torch.bfloat16)
               for i in range(3))
    tflash = attention_module()
    flops, nbytes = 4 * B * H * T * T * D, 4 * B * H * T * D * 2
    was = kernel_row(
        "flash_attention", lambda: tflash._fwd_wmma(q, k, v, None),
        lambda: flash_attention_fwd_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v), flops,
        PEAK_BF16_FLOPS, nbytes, launches, errs, shape=list(shape),
        timed="the earlier kernel on bf16 through its launcher")
    now = kernel_row(
        "flash_attention_sm90", lambda: flash_attention(q, k, v),
        lambda: flash_attention_fwd_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v), flops,
        PEAK_BF16_FLOPS, nbytes, launches, errs, shape=list(shape),
        was_ms=was["ms"])
    return [was, now]


def ln_bwd_rows(shape, seed, eps, launches, errs, per_step=None,
                only=None) -> list:
    """B3's two rows on the same bf16 (..., E) inputs: ``ln_bwd``, the
    earlier kernel through its launcher (route 0: the three launches), and
    ``ln_bwd_onepass``, the wrapper's one-pass route, with the former's
    time as was_ms; F.layer_norm's backward beside both. The bound is the
    function's: x and dy read and dx written once in bf16, the fp32 scale,
    dscale and dbias. ``only="ln_bwd_onepass"``: that row alone, without
    was_ms."""
    import importlib

    import torch.nn.functional as F

    from vitx_torch.kernels import ln_bwd, ln_bwd_plain

    tln = importlib.import_module("vitx_torch.kernels.layer_norm")
    bf = torch.bfloat16
    E = shape[-1]
    n = int(np.prod(shape))
    x = seeded(shape, seed, 2.0, 0.5, dtype=bf)
    dy = seeded(shape, seed + 1, 0.1, dtype=bf)
    sc = seeded((E,), seed + 2, 0.1, 1.0)
    xs, scs = x.detach().requires_grad_(), sc.detach().to(bf).requires_grad_()
    bs = torch.zeros(E, dtype=bf, device="cuda", requires_grad=True)
    y_lib = F.layer_norm(xs, (E,), scs, bs, eps)
    per_step = per_step or {}

    def lib():
        return torch.autograd.grad(y_lib, (xs, scs, bs), dy,
                                   retain_graph=True)

    def row(name, kern, **more):
        if name in per_step:
            more["per_step"] = per_step[name]
        return kernel_row(name, kern, lambda: ln_bwd_plain(x, sc, dy, eps=eps),
                          lib, 20 * n, PEAK_FP32_FLOPS, 3 * n * 2 + 3 * E * 4,
                          launches, errs, shape=list(shape), **more)

    def onepass(**more):
        return row("ln_bwd_onepass", lambda: ln_bwd(x, sc, dy, eps=eps),
                   **more)

    if only == "ln_bwd_onepass":
        return [onepass()]
    base = row("ln_bwd", lambda: tln._launch(x.reshape(-1, E), sc,
                                             dy.reshape(-1, E), eps, 0),
               timed="the earlier kernel (three launches) on bf16 through "
                     "its launcher; the wrapper sends these inputs to "
                     "ln_bwd_onepass")
    return [base, onepass(was_ms=base["ms"])]


def phase_train_times(cfg, state, batch, step, launches: dict,
                      train_launches: dict, errs: dict) -> list:
    """The train step at batch 128 bf16 (img/s, profiler split), and the
    training kernels' rows at its shapes: B2 and B3 per call, B12 per step
    over every leaf (fused_adamw_, a launch per leaf; fused_adamw_multi_,
    the step's one launch, with the former's time as was_ms); K1 and K2
    with their stash. ``per_step`` is from the train path's launches (25
    steps, the last 5 fused)."""
    from vitx_torch.kernels import (adamw_multi_plain, fused_adamw_,
                                    fused_adamw_multi_, fused_mha_block,
                                    fused_mlp_block)
    from vitx_torch.train.step import leaves

    B = batch["image"].shape[0]
    T, E, H, D = cfg.seq_len, cfg.embed_dim, cfg.num_heads, cfg.head_dim
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch)

    step_ms = cuda_ms(one_step, reps=5, warmup=1)
    emit({"phase": "times", "what": "train_step", "batch": B,
          "ms": step_ms, "img_per_s": B / (step_ms / 1000.0)})
    profile_call("train_step", one_step, top=16)

    bf = torch.bfloat16
    rows = []
    # B2 at the step's shapes: the sm90 kernel the step runs, and the
    # earlier kernel (the fp32 / other-D route) on the same bf16 inputs
    rows += attention_bwd_rows((B, H, T, D), 21, launches, errs,
                               {name: train_launches.get(name, 0) // 25
                                for name in ("attention_bwd",
                                             "attention_bwd_sm90")})
    # B3 at a block's LayerNorm (B, T, E): its one-pass route and the
    # earlier kernel
    rows += ln_bwd_rows((B, T, E), 25, cfg.layer_norm_eps, launches, errs,
                        {name: train_launches.get(name, 0) // 25
                         for name in ("ln_bwd", "ln_bwd_onepass")})
    # B12 over every leaf of the base16 state, per step
    ps = [t.detach().clone() for t in leaves(holder[0].params)]
    gs = [torch.randn_like(t) * 1e-3 for t in ps]
    mus = [torch.zeros_like(t) for t in ps]
    nus = [torch.zeros_like(t) for t in ps]
    n = sum(t.numel() for t in ps)
    kw = dict(lr=1e-4, c1=0.1, c2=0.001, b1=0.9, b2=0.999, eps=1e-8,
              wd=1e-4)
    lib_opt = torch.optim.AdamW(
        [torch.nn.Parameter(t.clone()) for t in ps], lr=1e-4, eps=1e-8,
        weight_decay=1e-4, fused=True)
    for prm, g in zip(lib_opt.param_groups[0]["params"], gs):
        prm.grad = g

    def per_leaf():
        for a, b, c, d in zip(ps, gs, mus, nus):
            fused_adamw_(a, b, c, d, **kw)

    def plain_all():
        adamw_multi_plain(ps, gs, mus, nus, **kw)

    was = kernel_row(
        "fused_adamw_", per_leaf, plain_all, lib_opt.step,
        15 * n, PEAK_FP32_FLOPS, 7 * 4 * n, launches, errs,
        leaves=len(ps), elements=n,
        per_step=train_launches.get("fused_adamw_", 0) // 5,
        timed="a launch per leaf, the step's update before the multi-leaf "
              "kernel")
    rows += [was, kernel_row(
        "fused_adamw_multi_",
        lambda: fused_adamw_multi_(ps, gs, mus, nus, **kw), plain_all,
        lib_opt.step, 15 * n, PEAK_FP32_FLOPS, 7 * 4 * n, launches, errs,
        leaves=len(ps), elements=n, was_ms=was["ms"],
        per_step=train_launches.get("fused_adamw_multi_", 0) // 5,
        entry_ms=adamw_entry_ms(ps, gs, mus, nus, kw))]
    # K1 and K2 with their stash at the step's shapes
    x, mha, mlp = block_inputs(B, T, E, H, cfg.mlp_dim, bf, 28, "cuda")
    stash = {   # the wrappers' calls: the sm90 rows
        "fused_mha_block_sm90": cuda_ms(
            lambda: fused_mha_block(x, **mha, stash=True), reps=10),
        "fused_mlp_block_sm90": cuda_ms(
            lambda: fused_mlp_block(x, **mlp, act=cfg.mlp_act, stash=True),
            reps=10),
    }
    emit({"phase": "times", "what": "stash", "batch": B, "ms": stash})
    return rows, stash


def adamw_entry_ms(ps, gs, mus, nus, kw) -> list:
    """Two medians of B12's multi-leaf C entry alone over fp32-gradient
    leaves, its pointer table built once: the kernel without the
    wrapper's per-leaf checks in Python."""
    import ctypes

    from vitx_torch.kernels import _build

    fn = _build.entry("adamw_multi")
    ptrs = (ctypes.c_longlong * (4 * len(ps)))(
        *(t.data_ptr() for leaf in zip(ps, gs, mus, nus) for t in leaf))
    numels = (ctypes.c_longlong * len(ps))(*(t.numel() for t in ps))
    args = (0, len(ps), ctypes.addressof(ptrs), ctypes.addressof(numels),
            kw["lr"], kw["c1"], kw["c2"], kw["b1"], 1.0 - kw["b1"],
            kw["b2"], 1.0 - kw["b2"], kw["eps"], kw["wd"],
            torch.cuda.current_stream().cuda_stream)

    def call():
        _build.check("adamw_multi", fn(*args))

    return [cuda_ms(call, reps=20), cuda_ms(call, reps=20)]


def phase_explain_times(cfg, params, errs: dict, launches: dict) -> list:
    """The large16_384 rollout forward at batch 32 and forward_with_attn
    ("full") at batch 2 (CUDA events, profiler split), and rows for B5 in
    each mode and B7 at the shapes of those paths: the full probs at
    batch 2, the head mean and no probs (the composed path,
    fuse_mha="off") and B7 at batch 32."""
    import torch.nn.functional as F

    from vitx_torch import forward_with_attn, forward_with_rollout
    from vitx_torch.kernels import flash_attention, flash_attention_fwd_plain

    E, H, T, D = cfg.embed_dim, cfg.num_heads, cfg.seq_len, cfg.head_dim
    bf = torch.bfloat16
    gen = torch.Generator("cuda").manual_seed(9)
    imgs = {B: torch.randn(B, cfg.image_size, cfg.image_size, 3,
                           device="cuda", generator=gen).to(bf)
            for B in (32, 2)}
    bcfg, bparams = qkv_bias_model(cfg, params)
    for what, B, fn in (
            ("rollout_forward", 32,
             lambda: forward_with_rollout(params, imgs[32], cfg)),
            ("rollout_forward_qkv_bias", 32,
             lambda: forward_with_rollout(bparams, imgs[32], bcfg)),
            ("forward_with_attn_full", 2,
             lambda: forward_with_attn(params, imgs[2], cfg))):
        ms = cuda_ms(fn, reps=10)
        row = {"phase": "times", "what": what, "batch": B, "ms": ms,
               "img_per_s": B / (ms / 1000.0)}
        if what != "rollout_forward":
            # the same call with B5's probability modes on the earlier
            # kernel, in turns with this one
            runs, was = in_turns(fn, earlier_probs_route, ms)
            row.update(ms_runs=runs, was_ms_runs=was, was="B5's "
                       "probability modes on the earlier kernel "
                       "(attention_fwd.cuh)")
        emit(row)
        profile_call(what, fn, top=14)
    del imgs, bparams
    torch.cuda.empty_cache()

    rows = []
    q, k, v = (seeded((32, H, T, D), s, 1.5, dtype=bf) for s in (51, 52, 53))
    flops, nbytes = 4 * 32 * H * T * T * D, 4 * 32 * H * T * D * 2
    tflash = attention_module()
    # B5 without probs: the sm90 kernel the bf16 composed path runs, and
    # the earlier kernel (fp32, other D) on the same bf16 inputs
    rows.append(kernel_row(
        "flash_attention_sm90", lambda: flash_attention(q, k, v),
        lambda: flash_attention_fwd_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v), flops,
        PEAK_BF16_FLOPS, nbytes, launches, errs, shape=[32, H, T, D]))
    rows.append(kernel_row(
        "flash_attention", lambda: tflash._fwd_wmma(q, k, v, None),
        lambda: flash_attention_fwd_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v), flops,
        PEAK_BF16_FLOPS, nbytes, launches, errs, shape=[32, H, T, D],
        timed="the earlier kernel on bf16 through its launcher; the "
              "wrapper sends bf16 at D 32, 64 and 128 to "
              "flash_attention_sm90 and this kernel fp32 and other D"))
    del q, k, v
    rows += probs_rows("mean", (32, H, T, D), 51, launches, errs)
    rows += probs_rows("full", (2, H, T, D), 51, launches, errs)
    rows += b7_rows(32, T, E, H, cfg.mlp_dim, 54, launches, errs)
    rows[-1]["launches_attn_sm90"] = launches.get(
        "fused_mha_block_with_mean_probs_attn_sm90")
    return rows


def b7_rows(B, T, E, H, M, seed, launches, errs) -> list:
    """B7's two rows at (B, T, E), H heads, bf16 (``block_rows``): the
    earlier kernels through the launcher, then the wrapper's sm90 route
    with its GEMM-only route (the sm90 GEMM with attention_fwd.cuh's
    head-mean mode) as was_ms, and K1's time on the same inputs. Bound:
    vitx's operations, 2 B T E 3E + 2 B T E^2 + 4 B H T^2 D, and bytes, x
    and out, the weights, bo, g, b and the (B, T, T) fp32 probabilities."""
    from vitx_torch.kernels import (fused_mha_block,
                                    fused_mha_block_with_mean_probs,
                                    mha_block_mean_probs_plain)

    D = E // H
    x, mha, _ = block_inputs(B, T, E, H, M, torch.bfloat16, seed, "cuda")
    rows_ = B * T
    flops = (2 * rows_ * E * 3 * E + 2 * rows_ * E * E
             + 4 * B * H * T * T * D)
    nbytes = 2 * rows_ * E * 2 + 4 * E * E * 2 + 3 * E * 4 + B * T * T * 4
    k1_ms = cuda_ms(lambda: fused_mha_block(x, **mha), reps=20)
    tmha = block_module()
    return block_rows(
        "fused_mha_block_with_mean_probs",
        lambda: fused_mha_block_with_mean_probs(x, **mha),
        lambda: tmha._launch_mean_probs(x, **mha, eps=1e-5, route=0),
        lambda: mha_block_mean_probs_plain(x, **mha), None, flops, nbytes,
        launches, errs,
        was=lambda: tmha._launch_mean_probs(x, **mha, eps=1e-5,
                                            route=tmha.ROUTE_GEMM_SM90),
        was_what="the GEMM-only route: the sm90 GEMM with "
                 "attention_fwd.cuh's head-mean mode", shape=[B, T, E],
        heads=H, library_note=NO_LIBRARY, k1_ms_same_shape=k1_ms)


def probs_rows(mode, shape, seed, launches, errs) -> list:
    """B5's probability mode ``mode`` at (B, H, T, D), two rows on the
    same bf16 inputs (seeds ``seed`` .. ``seed`` + 2): the earlier kernel
    (attention_fwd.cuh) through its launcher (``_launch_probs(route=0)``),
    which the wrapper keeps for fp32 and other D; and the wrapper's call
    (the sm90 body and the probability pass, the ``_sm90`` row), with the
    former's time as was_ms. Bound: 4 B H T^2 D operations; q, k, v in, o
    and the fp32 probabilities out. No PyTorch call returns attention
    probabilities."""
    from vitx_torch.kernels import (flash_attention_fwd_plain,
                                    flash_attention_with_mean_probs,
                                    flash_attention_with_probs)

    name, fn = (("flash_attention_with_probs", flash_attention_with_probs)
                if mode == "full" else ("flash_attention_with_mean_probs",
                                        flash_attention_with_mean_probs))
    B, H, T, D = shape
    q, k, v = (seeded(shape, seed + i, 1.5, dtype=torch.bfloat16)
               for i in range(3))
    flops = 4 * B * H * T * T * D
    nbytes = (4 * B * H * T * D * 2
              + (B * H if mode == "full" else B) * T * T * 4)
    tflash = attention_module()
    shape = list(shape)

    def plain():
        return flash_attention_fwd_plain(q, k, v, mode)

    base = kernel_row(
        name, lambda: tflash._launch_probs(q, k, v, mode, route=0), plain,
        None, flops, PEAK_BF16_FLOPS, nbytes, launches, errs, shape=shape,
        library_note=NO_LIBRARY,
        timed="the earlier kernel on bf16 through its launcher (route 0); "
              f"the wrapper sends these inputs to {name}_sm90")
    return [base, kernel_row(
        f"{name}_sm90", lambda: fn(q, k, v), plain, None, flops,
        PEAK_BF16_FLOPS, nbytes, launches, errs, shape=shape,
        library_note=NO_LIBRARY, was_ms=base["ms"],
        was_device_ms=base["device_ms"])]


def tome_logits_sources(params, imgs, cfg, device):
    """``cfg``'s ToMe logits and the merges' sources on ``device``: the
    encoder and head of ``forward``, in one pass."""
    from vitx_torch import encode_tome
    from vitx_torch.nn.vit import classify, on_device

    p, x = on_device(params, imgs, device)
    with torch.inference_mode():
        tokens, src = encode_tome(p, x, cfg, return_sources=True)
        return classify(p, tokens, cfg), src


def phase_tome(cfg, params, large, large_params) -> dict:
    """Main path 4: ToMe on the card, random weights from seed 0. Returns
    the launches of all its parts (the reference routes launch
    nothing)."""
    import vitx_torch
    from vitx_torch import forward
    from vitx_torch.nn.vit import init_params, params_to

    reset_counts()
    start = counts()
    expected = []
    base13, large23 = cfg.replace(tome_r=13), large.replace(tome_r=23)

    def on_kernels(part, c, p, seed):
        """c's bf16 ToMe forward at batch 8 on the kernels: finite logits
        and the launches. Reported only: the distance from the kernel-free
        route (composed_tome, the plain MLP) on the card and how many of
        the 8 images the two partition alike; the routes round differently
        in bf16, which tips near-tie merges to other pairs, so no bar
        holds them. Returns the launches, the partitions' included."""
        ref_c = c.replace(fuse_mha="off", fuse_mlp="off")
        imgs = explain_images(c, 8, seed)
        snap = counts()
        logits = forward(p, imgs, c)
        torch.cuda.synchronize()
        got = delta(snap)
        expect_launches(part, got, forward_launches(c, 1))
        snap = counts()
        ref, ref_src = tome_logits_sources(p, imgs, ref_c, "cuda")
        torch.cuda.synchronize()
        expect_launches(f"{part} reference", delta(snap), launches_of())
        snap = counts()
        _, src = tome_logits_sources(p, imgs, c, "cuda")
        alike = int((src == ref_src).flatten(1).all(dim=1).sum())
        emit({"phase": "tome", "part": part, "launches": got,
              "rel_err_to_kernel_free_route": card_rel_err(logits, ref),
              "images_partitioned_alike": alike})
        if not (logits.shape == (8, c.num_classes)
                and bool(torch.isfinite(logits).all())):
            raise AssertionError(f"{part}: logits {logits.shape} or "
                                 "not finite")
        return add_launches(got, delta(snap))

    def against_cpu(part, c, card, host, seed):
        """c's float32 ToMe logits and sources at batch 2 on the kernels
        against the CPU's plain versions (fuse "on"): in float32 both
        routes merge the same pairs, so the logits agree within 1e-4 and
        the sources exactly. Returns the launches."""
        imgs = explain_images(c, 2, seed)
        snap = counts()
        logits, src = tome_logits_sources(card, imgs, c, "cuda")
        torch.cuda.synchronize()
        got = delta(snap)
        expect_launches(part, got, forward_launches(c, 1))
        ref, ref_src = tome_logits_sources(
            host, imgs, c.replace(fuse_mha="on", fuse_mlp="on"), "cpu")
        check("tome", part, logits, ref, FP32_TOL, launches=got,
              tokens=list(src.shape[1:]))
        if not torch.equal(src.cpu(), ref_src):
            raise AssertionError(f"{part}: the merges' sources differ")
        return got

    # (a) base16 r=13, bf16, batch 8; (a') in float32, card vs CPU
    expected.append(on_kernels(
        "a: base16 tome_r=13 b8 bf16 on the kernels", base13, params, 21))
    expected.append(against_cpu(
        "a': base16 tome_r=13 b2 fp32, card vs CPU",
        base13.replace(compute_dtype="float32"), params,
        params_to(params, "cpu"), 25))

    # (b) lossless: a constant image and zero positional embeddings make
    # every patch token identical, so merging loses nothing: the fp32
    # ToMe logits equal the full-token logits (tests/test_tome.py:36-50)
    c32 = base13.replace(compute_dtype="float32")
    flat = dict(params, pos_embed=torch.zeros_like(params["pos_embed"]))
    imgs = np.full((2, cfg.image_size, cfg.image_size, 3), 0.3, np.float32)
    snap = counts()
    merged = forward(flat, imgs, c32)
    full = forward(flat, imgs, c32.replace(tome_r=0))
    torch.cuda.synchronize()
    got = delta(snap)
    expect_launches("(b) lossless", got, add_launches(
        forward_launches(c32, 1), forward_launches(c32.replace(tome_r=0), 1)))
    expected.append(got)
    err = card_rel_err(merged, full)
    emit({"phase": "tome", "part": "b: lossless, base16 fp32 b2, constant "
          "image, zero pos_embed: ToMe vs full-token logits",
          "rel_err": err, "launches": got, "tol": FP32_TOL})
    if not err <= FP32_TOL:
        raise AssertionError(f"(b) lossless: rel err {err}")
    del flat

    # (c) large16_384 r=23, bf16, batch 8; (c') in float32, card vs CPU
    expected.append(on_kernels(
        "c: large16_384 tome_r=23 b8 bf16 on the kernels", large23,
        large_params, 22))
    expected.append(against_cpu(
        "c': large16_384 tome_r=23 b2 fp32, card vs CPU",
        large23.replace(compute_dtype="float32"), large_params,
        params_to(large_params, "cpu"), 26))

    # (d) a depth-2 fp32 large16_384 copy with a random QKV bias
    c2 = vitx_torch.get_config("large16_384", depth=2,
                               compute_dtype="float32", qkv_bias=True,
                               tome_r=(65, 64))
    host = init_params(0, c2, device="cpu")
    host["blocks"]["bqkv"] = seeded(host["blocks"]["bqkv"].shape, 23, 0.1,
                                    device="cpu")
    expected.append(against_cpu(
        "d: large16_384 depth 2 fp32, qkv_bias, tome_r=(65, 64), card vs "
        "CPU", c2, params_to(host, "cuda"), host, 24))
    del host

    total = delta(start)
    expect_launches("tome phase (a)-(d)", total, add_launches(*expected))
    # (e) the main path: an InferenceServer for base16 r=13 at batch 32
    # (phase_serve sets the counts to 0 before it and reads them after)
    return add_launches(total, phase_serve(base13, params, phase="tome"))


def tome_kernel_rows(base, large, errs: dict, launches: dict) -> list:
    """B8's rows (``tome_rows_at``), bf16: their numbers at base16's
    first r=13 block (256, 197), and under ``shapes`` those at (256, 197),
    the last block (256, 54) and large16_384's T 577 and 416 at batch 32,
    where vitx takes B9."""
    rows = [tome_rows_at(c, B, T, launches, errs)
            for c, B, T in ((base, 256, 197), (base, 256, 54),
                            (large, 32, 577), (large, 32, 416))]
    out = [dict(shapes_[0], shapes=[shape_entry(r) for r in shapes_])
           for shapes_ in zip(*rows)]
    out[1]["launches_attn_sm90"] = launches.get(
        "fused_mha_block_tome_attn_sm90")
    return out


SHAPE_KEYS = ("shape", "heads", "ms", "device_ms", "plain_ms", "library_ms",
              "bound_ms", "bound_by", "tflops", "was_ms",
              "earlier_kernels_ms")


def shape_entry(row: dict) -> dict:
    """A row's numbers at its shape, for another row's ``shapes``."""
    return {k: row[k] for k in SHAPE_KEYS if k in row}


def tome_rows_at(c, B, T, launches, errs) -> list:
    """B8's two rows (``block_rows``: the earlier kernels, and the sm90
    route with the sm90 attention, the GEMM-only route -- the sm90 GEMM
    with attention_fwd.cuh -- as its was_ms) at (B, T, ``c``'s width),
    bf16. The library call: F.layer_norm, F.linear with the QKV bias, SDPA
    with log_size as its additive mask, F.linear, and k's mean over the
    heads."""
    import torch.nn.functional as F

    from vitx_torch.kernels import fused_mha_block_tome, mha_block_tome_plain

    tmha = block_module()
    bf = torch.bfloat16
    E, H, D, eps = c.embed_dim, c.num_heads, c.head_dim, c.layer_norm_eps
    x, tm = tome_inputs(B, T, E, H, bf, 70 + T)
    wqkv_t = tm["wqkv"].reshape(E, 3 * E).t().contiguous()
    bqkv = tm["bqkv"].reshape(3 * E).to(bf)
    wo_t = tm["wo"].t().contiguous()
    mask = tm["log_size"].to(bf)[:, None, None, :]

    def lib():
        h = F.layer_norm(x, (E,), tm["g"].to(bf), tm["b"].to(bf), eps)
        q, k, v = F.linear(h, wqkv_t, bqkv).view(B, T, 3, H, D).permute(
            2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
        return (F.linear(o.transpose(1, 2).reshape(B, T, E), wo_t,
                         tm["bo"].to(bf)), k.mean(dim=1))

    flops = 2 * B * T * E * 4 * E + 4 * B * H * T * T * D
    nbytes = (2 * B * T * E * 2 + 4 * E * E * 2 + 6 * E * 4 + B * T * 4
              + B * T * D * 2)
    return block_rows(
        "fused_mha_block_tome",
        lambda: fused_mha_block_tome(x, **tm, eps=eps),
        lambda: tome_earlier(x, tm, eps),
        lambda: mha_block_tome_plain(x, **tm, eps=eps), lib, flops,
        nbytes, launches, errs,
        was=lambda: tome_earlier(x, tm, eps, route=tmha.ROUTE_GEMM_SM90),
        was_what="the GEMM-only route: the sm90 GEMM with "
                 "attention_fwd.cuh",
        shape=[B, T, E])


def sdpa_mha(x, mha, H, eps):
    """K1's function as PyTorch library calls on K1's inputs:
    F.layer_norm, F.linear, SDPA, F.linear."""
    import torch.nn.functional as F

    B, T, E = x.shape
    D, dt = E // H, x.dtype
    wqkv_t = mha["wqkv"].reshape(E, 3 * E).t().contiguous()
    wo_t = mha["wo"].t().contiguous()

    def lib():
        h = F.layer_norm(x, (E,), mha["g"].to(dt), mha["b"].to(dt), eps)
        q, k, v = F.linear(h, wqkv_t).view(B, T, 3, H, D).permute(
            2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(q, k, v)
        return F.linear(o.transpose(1, 2).reshape(B, T, E), wo_t,
                        mha["bo"].to(dt))
    return lib


def recipe_kernel_shapes(launches: dict, errs: dict) -> dict:
    """The recipe variants' own kernel shapes (small16: E 384, 6 heads of
    D 64), bf16, as more ``shapes`` of the kernels' rows: B8's two rows at
    the ToMe-train step's first block (128, 197); K1's sm90 row, the
    wrapper with its stash as the patch-drop step calls it, and B2's two
    rows at that step's T 99. Returns row name -> [entries]."""
    import vitx_torch
    from vitx_torch.kernels import fused_mha_block, mha_block_plain

    c = vitx_torch.get_config("small16")
    B, E, H, D, eps = 128, c.embed_dim, c.num_heads, c.head_dim, \
        c.layer_norm_eps
    rows = tome_rows_at(c, B, c.seq_len, launches, errs)
    T = 1 + c.replace(patch_drop=0.5).patch_keep_count
    x, mha, _ = block_inputs(B, T, E, H, c.mlp_dim, torch.bfloat16, 32,
                             "cuda")
    rows.append(kernel_row(
        "fused_mha_block_sm90",
        lambda: fused_mha_block(x, **mha, eps=eps, stash=True),
        lambda: mha_block_plain(x, **mha, eps=eps, stash=True),
        sdpa_mha(x, mha, H, eps),
        2 * B * T * E * 4 * E + 4 * B * H * T * T * D, PEAK_BF16_FLOPS,
        # x in, out and the stash's q, k, v, o_all out, the weights, the
        # row statistics
        6 * B * T * E * 2 + 4 * E * E * 2 + 3 * E * 4 + 2 * B * H * T * 4,
        launches, errs, shape=[B, T, E], stash=True))
    rows += attention_bwd_rows((B, H, T, D), 33, launches, errs)
    extra: dict = {}
    for row in rows:
        extra.setdefault(row["name"], []).append(shape_entry(row))
    for T in (c.seq_len, 128):
        attention_half_under_grad(c, B, T)
    return extra


def attention_half_under_grad(c, B, T) -> None:
    """A block's attention half under grad at (B, T, ``c``'s width), bf16,
    as the recipe's steps run it: B8 (ToMe-train: the kernel forward, then
    ``composed_tome``'s recompute and backward) against K1 with its stash
    then B2 and B3 (every other step). CUDA events around the forward with
    grad-requiring inputs, and around forward + backward; the backward is
    their difference. The profiler's device time of forward + backward."""
    from vitx_torch.kernels import fused_mha_block, fused_mha_block_tome

    E, H, eps = c.embed_dim, c.num_heads, c.layer_norm_eps
    x, tm = tome_inputs(B, T, E, H, torch.bfloat16, 90 + T)
    bqkv = torch.zeros_like(tm["bqkv"])
    dout = seeded((B, T, E), 91 + T, 0.1, dtype=torch.bfloat16)
    req = [t.detach().requires_grad_()
           for t in (x, tm["wqkv"], tm["wo"], tm["bo"], tm["g"], tm["b"])]
    out = {}
    for name, fn in (
            ("fused_mha_block_tome", lambda: fused_mha_block_tome(
                req[0], req[1], bqkv, *req[2:], tm["log_size"],
                eps=eps)[0]),
            ("fused_mha_block", lambda: fused_mha_block(*req, eps=eps))):
        def fwd_bwd():
            torch.autograd.grad(fn(), req, dout)

        fwd_ms, both_ms = cuda_ms(fn, reps=10), cuda_ms(fwd_bwd, reps=10)
        out[name] = {"forward_ms": fwd_ms, "forward_backward_ms": both_ms,
                     "backward_ms": both_ms - fwd_ms,
                     "forward_backward_device_ms": profile_call(
                         f"{name} under grad {[B, T, E]}", fwd_bwd,
                         calls=5)}
    emit({"phase": "times", "what": "attention half under grad: B8 "
          "(composed backward) vs K1 with its stash (B2, B3)",
          "card": smi(), "shape": [B, T, E], "heads": H, **out})


def phase_tome_times(cfg, params, large, large_params, errs: dict,
                     launches: dict) -> list:
    """The ToMe forward at bench configs 6 and 8's operating points
    (base16 b256 at r=13 and (35, 34); large16_384 b32 at r=23 and
    (65, 64 x 6)) in img/s, a profiler split at r=13 and r=23, and B8's
    rows (``tome_kernel_rows``). At r=13 and r=23 the same forward with
    B8 on its GEMM-only route (``gemm_only_attention_route``) in turns with
    this one (now, was, now, was), each profiled once: the device's busy
    share before and after; and B8's host time a call on both routes at a
    small shape,
    where the card waits for the host (the sm90 attention encodes three
    tensor maps a launch)."""
    from vitx_torch import forward

    gen = torch.Generator("cuda").manual_seed(15)
    for c, p, B in ((cfg.replace(tome_r=13), params, 256),
                    (cfg.replace(tome_r=(35, 34)), params, 256),
                    (large.replace(tome_r=23), large_params, 32),
                    (large.replace(tome_r=(65,) + (64,) * 6), large_params,
                     32)):
        imgs = torch.randn(B, c.image_size, c.image_size, 3, device="cuda",
                           generator=gen).to(torch.bfloat16)
        ms = cuda_ms(lambda: forward(p, imgs, c), reps=10)
        what = f"tome_forward {c.image_size} r={c.tome_r}"
        row = {"phase": "times", "what": what, "batch": B, "ms": ms,
               "img_per_s": B / (ms / 1000.0),
               "tokens_last_block": c.seq_len - sum(c.tome_schedule[:-1])}
        if isinstance(c.tome_r, int):
            profile_call(what, lambda: forward(p, imgs, c), top=16)
            runs, was = [ms], []
            for i in range(3):
                if i % 2 == 0:
                    with gemm_only_attention_route():
                        was.append(cuda_ms(lambda: forward(p, imgs, c),
                                           reps=10))
                else:
                    runs.append(cuda_ms(lambda: forward(p, imgs, c),
                                        reps=10))
            with gemm_only_attention_route():
                profile_call(f"{what}, B8 on the GEMM-only route",
                             lambda: forward(p, imgs, c), top=16)
            row.update(ms_runs=runs, was_ms_runs=was, was="B8 on the "
                       "GEMM-only route (the sm90 GEMM with "
                       "attention_fwd.cuh)")
        emit(row)
        del imgs
    torch.cuda.empty_cache()
    host = {}
    x, tm = tome_inputs(1, 48, large.embed_dim, large.num_heads,
                        torch.bfloat16, 9)
    tmha = block_module()
    now = tmha.ROUTE_GEMM_SM90 | tmha.ROUTE_ATTN_SM90
    for name, route in (("sm90 attention", now),
                        ("GEMM-only route", tmha.ROUTE_GEMM_SM90),
                        ("sm90 attention again", now)):
        for _ in range(5):
            tome_earlier(x, tm, route=route)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            tome_earlier(x, tm, route=route)
        host[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    emit({"phase": "times", "what": "B8 host time a call, us, (1, 48, "
          "1024) bf16 through the launcher (allocations, tensor maps, "
          "five launches)", "us": host})
    del x, tm
    return tome_kernel_rows(cfg, large, errs, launches)


def in_turns(fn, was_route, ms: float) -> tuple:
    """(runs, was_runs): ``fn`` timed (``ms`` its first run) in turns with
    itself under the context ``was_route`` -- now, was, now, was, the
    comparison inside one call."""
    runs, was = [ms], []
    for i in range(3):
        if i % 2 == 0:
            with was_route():
                was.append(cuda_ms(fn, reps=5))
        else:
            runs.append(cuda_ms(fn, reps=10))
    with was_route():
        was.append(cuda_ms(fn, reps=5))
    return runs, was


class earlier_probs_route:
    """A context in which B5's probability modes keep the earlier kernel
    (attention_fwd.cuh), for a comparison inside one call."""

    def __enter__(self):
        self.tflash = attention_module()
        self.saved = self.tflash.probs_route
        self.tflash.probs_route = lambda q, k, v: 0

    def __exit__(self, *exc):
        self.tflash.probs_route = self.saved


class gemm_only_attention_route:
    """A context in which the blocks' wrappers (K1, B7, B8) keep their
    attention on attention_fwd.cuh (the GEMM-only route: the sm90 GEMM, the
    earlier attention), for a comparison inside one call."""

    def __enter__(self):
        self.tmha = block_module()
        self.saved = saved = self.tmha.mha_route
        self.tmha.mha_route = lambda *a, **kw: (
            saved(*a, **kw) & ~self.tmha.ROUTE_ATTN_SM90)

    def __exit__(self, *exc):
        self.tmha.mha_route = self.saved


def phase_finetune_times(cfg, state, batch, step, launches: dict,
                         errs: dict) -> tuple:
    """The fine-tune step at batch 32 bf16 (ms, img/s, profiler split);
    B2's kernel at its attention shape (32, 12, 1025, 64), where vitx runs
    B6; B3's two rows at its tokens (32, 1025, 768); B10's two rows and
    B3's on the (R, E) view, B11's function, at base16's b256 tokens (256
    x 197, 768) bf16. Returns (B10's rows, {name: [shape entries]} for the
    rows of B2's and B3's two kernels)."""
    import importlib

    import torch.nn.functional as F

    from vitx_torch.kernels import (fused_add_layer_norm, fused_layer_norm,
                                    layer_norm_fwd_plain)

    B = batch["image"].shape[0]
    T, E, H, D = cfg.seq_len, cfg.embed_dim, cfg.num_heads, cfg.head_dim
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch)

    step_ms = cuda_ms(one_step, reps=5, warmup=1)
    emit({"phase": "times", "what": "finetune_step", "batch": B, "T": T,
          "ms": step_ms, "img_per_s": B / (step_ms / 1000.0)})
    profile_call("finetune_step", one_step, top=16)

    bf = torch.bfloat16
    keep = ("shape", "ms", "device_ms", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "tflops")
    b6 = attention_bwd_rows((B, H, T, D), 41, launches, errs)
    torch.cuda.empty_cache()

    # B3 at the fine-tune's tokens, and B11's function on the (R, E) view
    # of base16's b256 tokens
    b3 = ln_bwd_rows((B, T, E), 55, cfg.layer_norm_eps, launches, errs)
    torch.cuda.empty_cache()
    R = 256 * 197
    b11 = ln_bwd_rows((R, E), 45, cfg.layer_norm_eps, launches, errs)
    torch.cuda.empty_cache()
    x = seeded((R, E), 45, 2.0, 0.5, dtype=bf)
    r = seeded((R, E), 46, 1.0, dtype=bf)
    sc, bi = seeded((E,), 48, 0.1, 1.0), seeded((E,), 49, 0.1)
    eps = cfg.layer_norm_eps
    tln = importlib.import_module("vitx_torch.kernels.layer_norm")
    rows = []
    # B10's two variants: the earlier kernel through its launcher (route
    # 0), then the wrapper's one-pass route with that time as was_ms
    for name, wrapper, earlier, plain, lib, flops, nbytes, more in (
            ("fused_layer_norm", lambda: fused_layer_norm(x, sc, bi),
             lambda: tln._launch_fwd(x, None, sc, bi, eps, route=0),
             lambda: layer_norm_fwd_plain(x, sc, bi),
             lambda: F.layer_norm(x, (E,), sc.to(bf), bi.to(bf), eps),
             8 * R * E, 2 * R * E * 2 + 2 * E * 4, {}),
            ("fused_add_layer_norm",
             lambda: fused_add_layer_norm(x, r, sc, bi),
             lambda: tln._launch_fwd(x, r, sc, bi, eps, route=0),
             lambda: layer_norm_fwd_plain(x, sc, bi, r), None,
             9 * R * E, 4 * R * E * 2 + 2 * E * 4,
             {"library_note": NO_ADD_LIBRARY})):
        base = kernel_row(
            name, earlier, plain, lib, flops, PEAK_FP32_FLOPS, nbytes,
            launches, errs, shape=[R, E],
            timed="the earlier kernel on bf16 through its launcher (route "
                  f"0); the wrapper sends these inputs to {name}_onepass",
            **more)
        rows += [base, kernel_row(
            f"{name}_onepass", wrapper, plain, lib, flops, PEAK_FP32_FLOPS,
            nbytes, launches, errs, shape=[R, E], was_ms=base["ms"],
            was_device_ms=base["device_ms"], **more)]
    shapes = {row["name"]: [{k: row[k] for k in keep}] for row in b6}
    for row in b3 + b11:
        entry = {k: row[k] for k in (*keep, "was_ms") if k in row}
        shapes.setdefault(row["name"], []).append(entry)
    return rows, shapes


ARTIFACTS = BUILD / "artifacts"
# huge14's shapes in vitx's bench 13: inference at batch 32, the train
# step at batch 8, T 257 (16 x 16 patches of 14 and the CLS)
HUGE_B, HUGE_TRAIN_B = 32, 8
HUGE_ROLLOUT_B = 8       # huge14's explain path (huge14_explain)


def same_top1(what: str, results, logits) -> None:
    want = logits.float().argmax(-1).tolist()
    got = [r["classes"][0] for r in results]
    if got != want:
        raise AssertionError(f"{what}: served top-1 {got}, direct {want}")


def program_call(what, module, x, ref, expect, launches) -> None:
    """One call of an exported program's module on ``x`` with the counts
    set to 0 just before it: ``expect``'s launches, logits within BF16_TOL
    of ``ref`` (the eager forward) with equal top-1. Adds its launches to
    ``launches``."""
    reset_counts()
    out = module(x)
    torch.cuda.synchronize()
    got = counts()
    expect_launches(f"artifacts: {what}", got, expect)
    for k, n in got.items():
        launches[k] = launches.get(k, 0) + n
    check("artifacts", what, out, ref, BF16_TOL, batch=x.shape[0])
    if not torch.equal(out.argmax(-1), ref.float().argmax(-1)):
        raise AssertionError(f"{what}: top-1 differs from the eager forward")


def program_ops(program) -> dict:
    names = [str(n.target) for n in program.graph.nodes
             if n.op == "call_function"]
    return {n: names.count(n) for n in set(names)
            if n.startswith("vitx_torch.")}


def phase_artifacts(cfg, params) -> dict:
    """Main path 8 (module docstring): .quant.npz, .pt2 programs on the
    card, their servers, and the depth-2 fp32 features and probe, card
    vs CPU. Returns the exported programs' and their server's launches."""
    import os

    from vitx_torch import forward, forward_features
    from vitx_torch.cli import probe
    from vitx_torch.export import (export_forward, load_exported,
                                   save_exported)
    from vitx_torch.nn.vit import init_params, param_spec, params_to
    from vitx_torch.quant import (load_quantized, quantization_error,
                                  save_quantized)
    from vitx_torch.serve import load_server
    from vitx_torch.train.step import leaves

    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    S, dt = cfg.image_size, cfg.cdtype()
    imgs = np.random.default_rng(20).standard_normal(
        (256, S, S, 3)).astype(np.float32)
    x256 = torch.from_numpy(imgs).cuda().to(dt)
    card = smi()

    # (a) the int8 artifact and its server
    t0 = time.perf_counter()
    qpath = ARTIFACTS / "base16.quant.npz"
    save_quantized(qpath, params, meta={"config": json.loads(cfg.to_json()),
                                        "epoch": 0})
    save_s = time.perf_counter() - t0
    fp32 = sum(t.numel() * 4 for t in leaves(params))
    ratio = qpath.stat().st_size / fp32
    worst = max(quantization_error(params).values())
    deq, _ = load_quantized(qpath, param_spec(cfg))
    with load_server(str(qpath), cfg, batch_size=32) as srv:
        results = concurrent_predict(srv, imgs[:32], what="artifacts")
    same_top1("artifacts (a): .quant.npz server", results,
              forward(deq, x256[:32], cfg))
    emit({"phase": "artifacts", "part": "(a) .quant.npz", "bytes":
          qpath.stat().st_size, "fp32_bytes": fp32, "ratio": ratio,
          "quantization_error_max": worst, "bound": 1 / 254 + 1e-6,
          "save_s": save_s})
    if not (0.24 < ratio < 0.3 and worst <= 1 / 254 + 1e-6):
        raise AssertionError(f"artifacts (a): size ratio {ratio}, "
                             f"quantization error {worst}")
    del deq

    # (b) a symbolic-batch program made on the card, saved and loaded
    launches: dict = {}
    ppath = ARTIFACTS / "base16.pt2"
    t0 = time.perf_counter()
    nbytes = save_exported(ppath, params, cfg)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    program = load_exported(ppath)
    module = program.module()
    load_s = time.perf_counter() - t0
    ops = program_ops(program)
    if ops != {"vitx_torch.mha_block.default": cfg.depth,
               "vitx_torch.mlp_block.default": cfg.depth}:
        raise AssertionError(f"artifacts (b): the program's ops {ops}")
    for b in (1, 8, 256):
        program_call(f"(b) .pt2 b{b}", module, x256[:b],
                     forward(params, x256[:b], cfg),
                     forward_launches(cfg, 1), launches)
    runs = {"eager": [], "program": []}
    for name in ("eager", "program", "program", "eager"):
        fn = ((lambda: forward(params, x256, cfg)) if name == "eager"
              else (lambda: module(x256)))
        runs[name].append(cuda_ms(fn, reps=10))
    eager_ms, prog_ms = min(runs["eager"]), min(runs["program"])
    emit({"phase": "artifacts", "part": "(b) .pt2 symbolic batch",
          "card": card, "bytes": nbytes, "export_and_save_s": export_s,
          "load_s": load_s, "ops": ops, "b256_eager_ms": eager_ms,
          "b256_program_ms": prog_ms, "runs_ms": runs,
          "program_over_eager": prog_ms / eager_ms})

    # (c) ToMe r=13, the batch pinned at 32
    tcfg = cfg.replace(tome_r=13)
    tprog = export_forward(params, tcfg, batch_size=32)
    if program_ops(tprog)["vitx_torch.mha_block_tome.default"] != cfg.depth:
        raise AssertionError(f"artifacts (c): ops {program_ops(tprog)}")
    program_call("(c) ToMe r=13 .pt2 b32", tprog.module(), x256[:32],
                 forward(params, x256[:32], tcfg), forward_launches(tcfg, 1),
                 launches)
    del tprog

    # (d) QKV biases: the composed path, B5 in every block
    bcfg = cfg.replace(qkv_bias=True)
    L, H, D = cfg.depth, cfg.num_heads, cfg.head_dim
    bparams = {**params, "blocks": {**params["blocks"], "bqkv": seeded(
        (L, 3, H, D), 21, 0.1)}}
    bprog = export_forward(bparams, bcfg)
    program_call("(d) QKV-bias .pt2 b8", bprog.module(), x256[:8],
                 forward(bparams, x256[:8], bcfg),
                 block_launches(bcfg, flash_attention=L,
                                flash_attention_sm90=L * sm90(bcfg),
                                fused_mlp_block=L), launches)
    del bprog, bparams

    # (e) the program's server
    reset_counts()
    with load_server(str(ppath), cfg, batch_size=32) as srv:
        results = concurrent_predict(srv, imgs[32:64], what="artifacts")
        try:
            srv.explain(imgs[0])
        except RuntimeError as e:
            refused = str(e)
        else:
            raise AssertionError("artifacts (e): /explain was not refused")
        stats = srv.stats.summary()
    got = counts()
    expect_launches("artifacts (e): .pt2 server", got,
                    forward_launches(cfg, 1 + stats["batches"]))
    for k, n in got.items():
        launches[k] = launches.get(k, 0) + n
    same_top1("artifacts (e): .pt2 server", results,
              forward(params, x256[32:64], cfg))
    emit({"phase": "artifacts", "part": "(e) .pt2 server", "stats": stats,
          "explain": refused})
    del module, program

    # (f) depth 2, fp32: the features and the probe CLI, card vs CPU
    # the procedural task's 10 classes: the probe sizes the head to the data
    c2 = cfg.replace(depth=2, compute_dtype="float32", num_classes=10)
    p2 = init_params(1, c2)
    x8 = imgs[:8]
    for pool in ("cls", "gap"):
        check("artifacts", f"(f) forward_features pool={pool}, card vs CPU",
              forward_features(p2, x8, c2, pool=pool),
              forward_features(params_to(p2, "cpu"), x8, c2, pool=pool,
                               device="cpu"), FP32_TOL)
    os.environ.setdefault("VITX_PROC_CACHE", str(BUILD / "procdata"))
    art = ARTIFACTS / "depth2.quant.npz"
    save_quantized(art, p2, meta={"config": json.loads(c2.to_json())})
    argv = ["--checkpoint", str(art), "--data", "procedural:128,64",
            "--batch-size", "64", "--knn", "5"]
    reports = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        reports[dev] = run_cli(probe.main, argv + [
            "--device", dev, "--features", str(ARTIFACTS / f"{dev}.npz")])
        reports[dev]["seconds"] = time.perf_counter() - t0
    gpu, cpu = reports["cuda"], reports["cpu"]
    for k in ("pool", "dim", "num_train", "num_val", "knn_k"):
        if gpu[k] != cpu[k]:
            raise AssertionError(f"artifacts (f): probe {k} {gpu[k]} vs "
                                 f"{cpu[k]}")
    for k in ("linear_probe_train_acc", "linear_probe_val_acc",
              "knn_val_acc"):
        if abs(gpu[k] - cpu[k]) > 1 / gpu["num_val"] + 1e-9:
            raise AssertionError(f"artifacts (f): probe {k} {gpu[k]} vs "
                                 f"{cpu[k]}")
    with np.load(ARTIFACTS / "cuda.npz") as g, \
            np.load(ARTIFACTS / "cpu.npz") as c:
        for k in ("train_features", "val_features"):
            check("artifacts", f"(f) probe {k}, card vs CPU",
                  torch.from_numpy(g[k]), torch.from_numpy(c[k]), FP32_TOL)
    emit({"phase": "artifacts", "part": "(f) probe CLI", **reports})
    return launches


def phase_bench(errs: dict) -> tuple:
    """Main path 9 (module docstring). Returns bench 13's launches, the
    huge14 path, those of huge14's explain path (``huge14_explain``), and the
    block inputs K1 and K2 were held on at huge14's shapes, which
    ``huge14_kernel_shapes`` times."""
    import vitx_torch
    from vitx_torch.cli import bench, tune
    from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    huge = vitx_torch.get_config("huge14")
    B, T, E, H = HUGE_B, huge.seq_len, huge.embed_dim, huge.num_heads
    M, D, eps = huge.mlp_dim, huge.head_dim, huge.layer_norm_eps
    bf = torch.bfloat16
    x, mha, mlp = block_inputs(B, T, E, H, M, bf, 140, "cuda")
    info = {"batch": B, "T": T, "E": E, "heads": H, "head_dim": D}
    n90 = fused_mha_block.launches_sm90
    a90 = fused_mha_block.launches_attn_sm90
    check("bench", "fused_mha_block at huge14", fused_mha_block(
        x, **mha, eps=eps), mha_block_plain(x, **mha, eps=eps), BF16_TOL,
        errs, "fused_mha_block_sm90", **info)
    check("bench", "fused_mha_block stash at huge14", fused_mha_block(
        x, **mha, eps=eps, stash=True)[:5], mha_block_plain(
        x, **mha, eps=eps, stash=True), BF16_TOL, errs,
        "fused_mha_block_sm90", **info)
    check("bench", "fused_mlp_block at huge14", fused_mlp_block(
        x, **mlp, act=huge.mlp_act, eps=eps), mlp_block_plain(
        x, **mlp, act=huge.mlp_act, eps=eps), BF16_TOL, errs,
        "fused_mlp_block_sm90", M=M, **info)
    if fused_mha_block.launches_sm90 != n90 + 2:
        raise AssertionError("K1 at huge14 left the sm90 GEMM")
    if fused_mha_block.launches_attn_sm90 != a90 + 2:
        raise AssertionError("K1's attention at huge14 (D 128) left the "
                             "sm90 body")
    check_backward_kernels(HUGE_TRAIN_B, T, E, H, bf, BF16_TOL, errs,
                           phase="bench")
    torch.cuda.empty_cache()

    card = smi()
    for n in (3, 7):
        emit({"phase": "bench", "card": card, **bench.BENCHES[n]()})
    reset_counts()
    res = bench.BENCHES[13]()
    got = counts()
    forwards, steps = 1 + 3 * 10, 1 + 3 * 5   # bench_13's warm-ups + reps
    want = forward_launches(huge, forwards)
    trained = expected_train_launches(huge, steps, 0)
    # the head's LayerNorm (E 5120) is past B3's one-pass route
    trained["ln_bwd_onepass"] = 2 * huge.depth * steps
    want = {k: want[k] + trained[k] for k in want}
    expect_launches("bench 13 (huge14)", got, want)
    emit({"phase": "bench", "card": card, **res, "launches": got})
    torch.cuda.empty_cache()
    rollout = huge14_explain(huge)
    huge14_profiles(huge)

    out = BUILD / "tune.json"
    run_cli(tune.main, ["--mode", "infer", "--preset", "base16",
                        "--batches", "64,128,256", "--iters", "10",
                        "--reps", "3", "--out", str(out)])
    rows = json.loads(out.read_text())["results"]
    if any("error" in r for r in rows) or len(rows) != 3:
        raise AssertionError(f"tune: {rows}")
    return got, rollout, (x, mha, mlp)


def huge14_explain(huge) -> dict:
    """huge14's explain path at full width and depth, bf16, seed-0
    weights, its counts reset just before and read just after: (a)
    ``forward_with_rollout`` at b8 -- B7 in all 32 blocks, each on the
    sm90 attention and its head-mean pass at D 128, and K2 in each; (b)
    ``forward_with_attn("full")`` at b2 -- B5's full mode on its sm90 route
    in every block; (c) an InferenceServer's /explain?method=rollout, 4
    requests one at a time, each equal to a direct call. Then, outside the
    count: (a) with rows summing to 1, within EXPLAIN_TOL of B7 on its
    GEMM-only route (the sm90 GEMM with attention_fwd.cuh, huge14's route
    before the pass took D 128) and, at depth 2, of the CPU's fp32 plain
    forward; (b) within EXPLAIN_TOL of B5's full mode on the earlier
    kernel; (a) on both routes timed in turns (img/s) and profiled (the
    device's busy share, the split by kernel). Returns the path's
    launches."""
    from vitx_torch import forward_with_attn, forward_with_rollout
    from vitx_torch.nn.vit import init_params, params_to

    B = HUGE_ROLLOUT_B
    params = init_params(0, huge, device="cuda")
    imgs = explain_images(huge, B, 11)
    reset_counts()
    logits, weights = forward_with_rollout(params, imgs, huge)
    torch.cuda.synchronize()
    a = counts()
    expect_launches("huge14 (a) rollout b8", a, rollout_launches(huge))
    a90 = a["fused_mha_block_with_mean_probs_attn_sm90"]
    if a90 != huge.depth:
        raise AssertionError(f"huge14 rollout: B7's sm90 attention "
                             f"{a90} of {huge.depth} blocks")
    attn_logits, probs = forward_with_attn(params, imgs[:2], huge)
    torch.cuda.synchronize()
    b = delta(a)
    expect_launches("huge14 (b) forward_with_attn b2", b, block_launches(
        huge, flash_attention_with_probs=huge.depth,
        flash_attention_with_probs_sm90=huge.depth,
        fused_mlp_block=huge.depth))
    queries = [("rollout", None)] * 4
    snap = counts()
    results = serve_explains(huge, params, imgs[:4], queries)
    c = delta(snap)
    expect_launches("huge14 (c) server /explain", c, add_launches(
        forward_launches(huge, 1), rollout_launches(huge, len(queries))))
    got = counts()
    verify_explains(huge, params, imgs[:4], queries, results)

    with gemm_only_attention_route():
        was_logits, was_weights = forward_with_rollout(params, imgs, huge)
    sums = float((weights.double().sum(-1) - 1).abs().max())
    gaps = {"logits": card_rel_err(logits, was_logits),
            "rollout": card_rel_err(weights, was_weights)}
    emit({"phase": "bench", "check": "huge14 forward_with_rollout b8 bf16, "
          "B7 on the sm90 attention and pass vs its GEMM-only route",
          "rel_err": gaps, "tol": EXPLAIN_TOL, "row_sum_dev": sums,
          "attn_sm90_launches": a90, "blocks": huge.depth,
          "shape": list(weights.shape), "launches": a})
    if not (max(gaps.values()) <= EXPLAIN_TOL and sums <= 1e-4
            and weights.shape == (B, huge.num_patches)
            and bool(torch.isfinite(logits).all())):
        raise AssertionError(f"huge14 rollout: {gaps}, rows +- {sums}")
    del logits, weights, was_logits, was_weights
    with earlier_probs_route():
        ref = forward_with_attn(params, imgs[:2], huge)
    check("bench", "huge14 forward_with_attn full b2 bf16, B5's full mode "
          "on the sm90 route vs the earlier kernel", (attn_logits, probs),
          ref, EXPLAIN_TOL, launches=b)
    check_rows("huge14 forward_with_attn full", probs, batch=2)
    del attn_logits, probs, ref

    c2 = huge.replace(depth=2)
    p2 = first_blocks(params)
    card = forward_with_rollout(p2, imgs[:2], c2)
    host = forward_with_rollout(params_to(p2, "cpu"), imgs[:2],
                                c2.replace(compute_dtype="float32"),
                                device="cpu")
    check("bench", "huge14 forward_with_rollout depth 2 b2, bf16 on the "
          "card vs the CPU's fp32 plain forward", card, host, EXPLAIN_TOL)
    del p2, card, host

    x = torch.from_numpy(imgs).to("cuda", torch.bfloat16)

    def fn():
        return forward_with_rollout(params, x, huge)

    ms = cuda_ms(fn, reps=10)
    runs, was = in_turns(fn, gemm_only_attention_route, ms)
    emit({"phase": "bench", "what": "huge14 forward_with_rollout", "batch": B,
          "ms_runs": runs, "was_ms_runs": was,
          "img_per_s": B / (min(runs) / 1000.0),
          "was_img_per_s": B / (min(was) / 1000.0),
          "was": "B7 on its GEMM-only route (the sm90 GEMM with "
                 "attention_fwd.cuh)"})
    profile_call("huge14 forward_with_rollout b8", fn, top=16)
    with gemm_only_attention_route():
        profile_call("huge14 forward_with_rollout b8, B7 on its GEMM-only "
                     "route", fn, top=16)
    del params, x
    torch.cuda.empty_cache()
    return got


def serve_explains(cfg, params, imgs, queries) -> list:
    """The answers of an InferenceServer for ``cfg`` behind its HTTP front
    end to /explain with ``queries`` ((method, class or None) for each of
    ``imgs``), sent one at a time."""
    import io
    import urllib.request

    from vitx_torch.cli.serve import serve_in_thread
    from vitx_torch.serve import InferenceServer

    results = []
    with InferenceServer(params, cfg, batch_size=4, top_k=5) as srv:
        httpd, _ = serve_in_thread(srv)
        base = f"http://127.0.0.1:{httpd.server_port}/explain"
        try:
            for img, (method, cls) in zip(imgs, queries):
                url = f"{base}?method={method}"
                if cls is not None:
                    url += f"&class={cls}"
                buf = io.BytesIO()
                np.save(buf, img)
                req = urllib.request.Request(url, data=buf.getvalue(),
                                             method="POST")
                results.append(json.loads(urllib.request.urlopen(
                    req, timeout=600).read()))
        finally:
            httpd.shutdown()
            httpd.server_close()
    return results


def huge14_profiles(huge) -> None:
    """Bench 13's two calls under the profiler, split by kernel: the
    forward at b32 and, after a warm-up step, the train step at b8 (plain
    AdamW, as ``cli.bench.train_timing`` builds it)."""
    from vitx_torch.nn.vit import forward, init_params
    from vitx_torch.train.step import (create_train_state, make_optimizer,
                                       make_train_step)

    params = init_params(0, huge, device="cuda")
    x = card_images(HUGE_B, huge.image_size, 1)
    profile_call("huge14 forward b32", lambda: forward(
        params, x, huge, device="cuda"), top=16)
    del params, x
    opt = make_optimizer(lr=1e-4)
    state = create_train_state(2, huge, opt, device="cuda")
    step = make_train_step(huge, opt, device="cuda")
    batch = {"image": card_images(HUGE_TRAIN_B, huge.image_size, 3),
             "label": torch.zeros((HUGE_TRAIN_B,), dtype=torch.int32,
                                  device="cuda")}
    step(state, batch, None)
    profile_call("huge14 train step b8", lambda: step(state, batch, None),
                 top=16)
    del state, step, batch
    torch.cuda.empty_cache()


def huge14_kernel_shapes(inputs, launches: dict, errs: dict) -> dict:
    """huge14's kernel shapes (bench 13: E 1280, 10 heads of D 128, M
    5120, T 257), bf16, as more ``shapes`` of the rows: K1's and K2's two
    rows at b32 on ``inputs``, the (x, mha, mlp) ``phase_bench`` held
    them on (the earlier route, and the wrapper's: the sm90 GEMM with the
    sm90 attention at D 128, K1's GEMM-only route -- the sm90 GEMM with
    attention_fwd.cuh -- as its was_ms), B2's two rows at the train
    step's (8, 10, 257, 128) and in B6's range at (4, 10, 1025, 128),
    B5's two at the forward's (32, 10, 257, 128), B8's at base16_hd128's
    (32, 197, 768), 6 heads of D 128, B3's two at (8, 257, 1280); the
    explain path at D 128: B5's probability modes' two rows each, the full
    mode at (2, 10, 257, 128) and the mean at the rollout's (8, 10, 257,
    128), and B7's at huge14's rollout (8, 257, 1280) and base16_hd128's
    (32, 197, 768). Returns row name -> [entries]."""
    import importlib

    import torch.nn.functional as F

    import vitx_torch
    from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    c = vitx_torch.get_config("huge14")
    B, T, E, H = HUGE_B, c.seq_len, c.embed_dim, c.num_heads
    M, D, eps = c.mlp_dim, c.head_dim, c.layer_norm_eps
    bf = torch.bfloat16
    x, mha, mlp = inputs
    st = torch.empty((2, B, H, T), dtype=torch.float32, device="cuda")
    w1_t, w2_t = mlp["w1"].t().contiguous(), mlp["w2"].t().contiguous()
    tmlp = importlib.import_module("vitx_torch.kernels.mlp_block")

    def lib_mlp():
        h = F.layer_norm(x, (E,), mlp["g"].to(bf), mlp["b"].to(bf), eps)
        h = F.gelu(F.linear(h, w1_t, mlp["b1"].to(bf)), approximate="tanh")
        return F.linear(h, w2_t, mlp["b2"].to(bf))

    rows = block_rows(
        "fused_mha_block", lambda: fused_mha_block(x, **mha, eps=eps),
        lambda: block_module()._launch(x, **mha, eps=eps, extra=(st,),
                                       route=0),
        lambda: mha_block_plain(x, **mha, eps=eps), sdpa_mha(x, mha, H, eps),
        2 * B * T * E * 4 * E + 4 * B * H * T * T * D,
        2 * B * T * E * 2 + 4 * E * E * 2 + 3 * E * 4, launches, errs,
        was=lambda: block_module()._launch(
            x, **mha, eps=eps, extra=(st,),
            route=block_module().ROUTE_GEMM_SM90),
        was_what="the GEMM-only route: the sm90 GEMM with "
                 "attention_fwd.cuh", shape=[B, T, E])
    rows += block_rows(
        "fused_mlp_block",
        lambda: fused_mlp_block(x, **mlp, act=c.mlp_act, eps=eps),
        lambda: tmlp._launch(x, **mlp, act=c.mlp_act, eps=eps, stash=False,
                             route=0),
        lambda: mlp_block_plain(x, **mlp, act=c.mlp_act, eps=eps), lib_mlp,
        4 * B * T * E * M, 2 * B * T * E * 2 + 2 * E * M * 2
        + (M + 3 * E) * 4, launches, errs, shape=[B, T, E])
    del x, mha, mlp
    Bt = HUGE_TRAIN_B
    rows += attention_bwd_rows((Bt, H, T, D), 170, launches, errs)
    rows += attention_bwd_rows((4, H, 1025, D), 180, launches, errs)
    rows += flash_rows((B, H, T, D), 185, launches, errs)
    hd128 = vitx_torch.get_config("base16_hd128")
    rows += tome_rows_at(hd128, 32, 197, launches, errs)
    rows += ln_bwd_rows((Bt, T, E), 175, eps, launches, errs)
    rows += probs_rows("full", (2, H, T, D), 190, launches, errs)
    rows += probs_rows("mean", (HUGE_ROLLOUT_B, H, T, D), 190, launches, errs)
    rows += b7_rows(HUGE_ROLLOUT_B, T, E, H, M, 195, launches, errs)
    rows += b7_rows(32, hd128.seq_len, hd128.embed_dim, hd128.num_heads,
                    hd128.mlp_dim, 196, launches, errs)
    torch.cuda.empty_cache()
    extra: dict = {}
    for row in rows:
        extra.setdefault(row["name"], []).append(shape_entry(row))
    return extra


FAMILIES = {
    "conv_stem": {"stem": "conv"},
    "registers": {"num_registers": 4},
    "map_head": {"head_type": "map"},
    "sincos2d": {"pos_embed": "sincos2d"},
    "rope": {"pos_embed": "rope"},
    "soft_moe": {"moe_experts": 2, "moe_blocks": 1},
    "registers_map_sincos2d": {"num_registers": 4, "head_type": "map",
                               "pos_embed": "sincos2d"},
}
BENCH10 = {"moe_experts": 8, "moe_blocks": 6}   # vitx/cli/bench.py:371-414
FAMILY_DATA = "procedural:512,128"
FAMILY_CLI = {"moe": ["--moe-experts", "8", "--moe-blocks", "6"],
              "regmap": ["--num-registers", "4", "--head-type", "map",
                         "--pos-embed", "sincos2d"]}
FAMILY_ARTIFACT_TOL = 2e-2      # int8 weights against the eager forward


def nudged(params, seed: int):
    """A CPU parameter tree with N(0, 0.02) noise on every leaf, so that
    the zero-initialised heads and biases take part."""
    g = torch.Generator().manual_seed(seed)
    if isinstance(params, dict):
        return {k: nudged(params[k], seed + i)
                for i, k in enumerate(sorted(params))}
    return params + 0.02 * torch.randn(params.shape, generator=g).to(
        params.dtype)


def reference_route(cfg):
    """``cfg`` with no kernel in its forward: the plain attention, the
    composed blocks."""
    return cfg.replace(attn_impl="reference", fuse_mha="off", fuse_mlp="off")


def card_images(n: int, size: int, seed: int, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((n, size, size, 3), generator=g, device="cuda").to(
        dtype)


def families_card_vs_cpu(ds) -> None:
    """(a): each family at base16's width, depth 2, fp32, batch 4: the
    forward and one train step on the card against the CPU's."""
    import vitx_torch
    from vitx_torch.nn.vit import init_params, params_to

    batch = synthetic_batch(ds, 4)
    x = torch.from_numpy(batch["image"])
    for name, over in FAMILIES.items():
        cfg = vitx_torch.get_config("base16", depth=2,
                                    compute_dtype="float32", **over)
        host = nudged(init_params(1, cfg, device="cpu"), 2)
        card = params_to(host, "cuda")
        check("families", f"a: {name} depth 2 fp32 forward, card vs CPU",
              vitx_torch.forward(card, x, cfg),
              vitx_torch.forward(host, x, cfg, device="cpu"), FP32_TOL)
        check_step_card_vs_cpu("families", f"a: {name} depth 2 fp32 step, "
                               "card vs CPU", cfg, card, host, batch, 1e-4)


def moe_mlp_share(cfg, params, batch: int, step_ms: float) -> dict:
    """One MoE block's mixture forward and backward at the step's (batch,
    T, E) bf16 tokens, CUDA events, times the MoE blocks: its share of the
    step."""
    from vitx_torch.nn.moe import soft_moe_mlp
    from vitx_torch.nn.vit import unstack

    bp = {k: v.detach().requires_grad_()
          for k, v in unstack(params["moe_blocks"])[0].items()
          if k in ("phi", "router_scale", "ew1", "eb1", "ew2", "eb2")}
    h = (0.5 * torch.randn((batch, cfg.seq_len, cfg.embed_dim),
                           device="cuda")).to(torch.bfloat16)
    h.requires_grad_()
    dy = torch.randn_like(h)

    def fwd_bwd():
        out = soft_moe_mlp(h, bp, cfg)
        torch.autograd.grad(out, [h, *bp.values()], dy)

    ms = cuda_ms(fwd_bwd, reps=5)
    return {"moe_mlp_fwdbwd_ms": ms,
            "moe_mlps_in_step_ms": ms * cfg.moe_block_count,
            "moe_mlps_share": ms * cfg.moe_block_count / step_ms}


def families_bench10(ds) -> tuple:
    """(b): bench 10's Soft-MoE ViT-B at full width: launches, the b4 bf16
    logits against the CPU's plain forward, the forward at b256 and the
    fused train step at b128 timed, the step's profile and its MoE share.
    Returns (launches, cfg, params)."""
    import vitx_torch
    from vitx_torch.nn.vit import init_params, params_to
    from vitx_torch.train import TrainState, make_optimizer, make_train_step
    from vitx_torch.train.step import leaves

    cfg = vitx_torch.get_config("base16", **BENCH10)
    params = nudged(init_params(0, cfg, device="cpu"), 3)
    host = params
    params = params_to(params, "cuda")
    n_params = sum(t.numel() for t in leaves(params))
    x256 = card_images(256, cfg.image_size, 1)
    reset_counts()
    vitx_torch.forward(params, x256, cfg)
    torch.cuda.synchronize()
    fwd = counts()
    expect_launches("families (b): bench 10 forward", fwd,
                    forward_launches(cfg, 1))
    check("families", "b: bench 10 bf16 b4 logits, card vs the CPU's plain "
          "forward", vitx_torch.forward(params, x256[:4], cfg),
          vitx_torch.forward(host, x256[:4].cpu(), cfg, device="cpu"),
          EXPLAIN_TOL)
    del host
    fwd_ms = [cuda_ms(lambda: vitx_torch.forward(params, x256, cfg), reps=1,
                      warmup=0) for _ in range(10)]
    opt = make_optimizer(lr=1e-4, fused=True)
    state = TrainState(0, params, opt.init(params))
    step = make_train_step(cfg, opt)
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in synthetic_batch(ds, 128).items()}
    reset_counts()
    losses, step_ms = [], []
    for i in range(6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        end.synchronize()
        losses.append(float(m["loss"]))
        if i:
            step_ms.append(start.elapsed_time(end))
    got = counts()
    expect_launches("families (b): bench 10 train steps", got,
                    expected_train_launches(cfg, 6, 6))
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"families (b): losses {losses}")
    bench10_adamw(cfg, opt, state, batch)
    f_ms, s_ms = statistics.median(fwd_ms), statistics.median(step_ms)
    emit({"phase": "families", "part": "b: bench 10, base16 Soft-MoE "
          "8 experts x 6 blocks, bf16", "card": smi(),
          "params_millions": n_params / 1e6, "T": cfg.seq_len,
          "slots_per_expert": cfg.moe_slot_count,
          "forward_b256_ms": f_ms, "forward_b256_ms_runs": fwd_ms,
          "forward_images_per_sec": 256 / (f_ms / 1e3),
          "train_b128_ms": s_ms, "train_b128_ms_runs": step_ms,
          "train_images_per_sec": 128 / (s_ms / 1e3), "losses": losses,
          "launches_forward": fwd, "launches_6_steps": got,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          **moe_mlp_share(cfg, params, 128, s_ms)})
    profile_call("families: bench 10 train step b128",
                 lambda: step(state, batch), top=16)
    return add_launches(fwd, got), cfg, state.params


def bench10_adamw(cfg, opt, state, batch) -> None:
    """B12 at bench 10's leaf set (ew1 and ew2 at 113 M elements each): a
    copy of the state the fused steps left, one step's gradients on the
    batch, and the update the next step would make, against
    adamw_multi_plain bit for bit, in one launch."""
    from vitx_torch.train.step import leaves, loss_fn, trainable_params

    params, _ = trainable_params(state.params)
    loss_v, _ = loss_fn(params, batch, cfg)
    req = leaves(params)
    gs = [torch.zeros_like(t) if g is None else g for t, g in zip(
        req, torch.autograd.grad(loss_v, req, allow_unused=True))]
    del params, loss_v, req

    def copy(tree):
        return [t.detach().clone() for t in leaves(tree)]
    hold_adamw_multi("families", "b: bench 10's leaves after six fused "
                     "steps, this batch's gradients", copy(state.params), gs,
                     copy(state.opt_state.mu), copy(state.opt_state.nu),
                     opt.update_kw(state.opt_state.count),
                     count=state.opt_state.count)


def families_other_forwards() -> tuple:
    """(c): the other families at base16's width and depth, bf16, batch
    32: the forward on the kernels against the kernel-free route on the
    card, launches exact; RoPE's train step. Returns (launches, the
    registers model's (cfg, params))."""
    import vitx_torch
    from vitx_torch.nn.vit import init_params, params_to
    from vitx_torch.train import TrainState, make_optimizer, train_step

    x = card_images(32, 224, 2)
    launches, registers = {}, None
    for name, over in FAMILIES.items():
        if name == "soft_moe":
            continue                  # (b) runs bench 10's Soft-MoE model
        cfg = vitx_torch.get_config("base16", **over)
        params = params_to(nudged(init_params(0, cfg, device="cpu"), 4),
                           "cuda")
        reset_counts()
        out = vitx_torch.forward(params, x, cfg)
        torch.cuda.synchronize()
        got = counts()
        expect_launches(f"families (c): {name} forward", got,
                        forward_launches(cfg, 1))
        launches = add_launches(launches, got)
        check("families", f"c: {name} base16 bf16 b32 forward, kernels vs "
              "the kernel-free route", out,
              vitx_torch.forward(params, x, reference_route(cfg)),
              EXPLAIN_TOL, T=cfg.seq_len, launches=got)
        if name == "rope":
            opt = make_optimizer(lr=1e-4)
            batch = {"image": x, "label": torch.arange(
                32, device="cuda", dtype=torch.int32)}
            reset_counts()
            _, m = train_step(TrainState(0, params, opt.init(params)), batch,
                              cfg=cfg, optimizer=opt)
            torch.cuda.synchronize()
            got = counts()
            expect_launches("families (c): rope train step", got,
                            expected_train_launches(cfg, 1, 0))
            launches = add_launches(launches, got)
            emit({"phase": "families", "part": "c: rope base16 bf16 b32 "
                  "train step", "loss": float(m["loss"]), "launches": got})
            if not np.isfinite(float(m["loss"])):
                raise AssertionError(f"families (c): rope loss {m}")
        if name == "registers":
            registers = (cfg, params)
    return launches, registers


def family_eval_accuracy(params, cfg) -> float:
    """The val split of FAMILY_DATA at ``cfg``'s image size by direct
    ``eval_step`` calls at batch 128 (the eval CLI's preprocessing)."""
    from vitx_torch.cli.train import make_datasets
    from vitx_torch.data import BatchLoader, make_preprocess
    from vitx_torch.metrics import confusion_to_metrics
    from vitx_torch.train.step import eval_step

    pre = make_preprocess(out_size=cfg.image_size, mean=(0.5,) * 3,
                          std=(0.5,) * 3, random_flip=False)
    cm = None
    for b in BatchLoader(make_datasets(FAMILY_DATA, cfg, 0)[1], 128):
        img = pre(torch.from_numpy(b["image"]).cuda(), None, train=False)
        c, _ = eval_step(params, {"image": img, "label": b["label"],
                                  "mask": b["mask"]}, cfg=cfg)
        cm = c if cm is None else cm + c
    return float(confusion_to_metrics(cm)["accuracy"])


def families_cli() -> dict:
    """(d): the train CLI at small16 on FAMILY_DATA, two epochs each of a
    Soft-MoE model and a registers + MAP + sincos2d one, launches exact;
    the eval CLI on each .ckpt reports the trainer's accuracy; the MoE
    model's .quant.npz and .pt2 against its eager forward; a server on its
    .ckpt; eval --patch-size 8 on the patch-16 registers model against
    direct calls on resize_patch_embed's params. Returns the launches."""
    import os
    import shutil

    import vitx_torch.cli.eval as eval_cli
    from vitx_torch import forward
    from vitx_torch.export import load_exported
    from vitx_torch.nn.flexivit import resize_patch_embed
    from vitx_torch.nn.vit import param_spec
    from vitx_torch.quant import load_quantized
    from vitx_torch.train.checkpoint import (resolve_artifact_config,
                                             restore_eval_params)

    os.environ.setdefault("VITX_PROC_CACHE", str(BUILD / "procdata"))
    root = BUILD / "families"
    shutil.rmtree(root, ignore_errors=True)
    base = ["--preset", "small16", "--data", FAMILY_DATA, "--device-cache",
            "--batch-size", "128", "--epochs", "2", "--lr", "3e-4",
            "--seed", "0", "--log-every", "1"]
    evals = ["--data", FAMILY_DATA, "--batch-size", "128"]
    launches = {}
    for name, flags in FAMILY_CLI.items():
        ck, logs = root / name, root / f"{name}_logs"
        tr, train_loader, eval_loader, notes = build_quietly(
            base + flags + ["--checkpoint-dir", str(ck), "--log-dir",
                            str(logs)])
        reset_counts()
        t0 = time.perf_counter()
        history = tr.fit(train_loader, eval_loader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        steps, n_eval = 2 * len(train_loader), 2 * len(eval_loader)
        expect_launches(f"families (d): {name} run", got, add_launches(
            expected_train_launches(tr.cfg, steps, 0),
            forward_launches(tr.cfg, n_eval)))
        launches = add_launches(launches, got)
        losses = [v for _, v in read_scalars(logs, "Loss/train_batch")]
        logged = history[-1]["val_accuracy"]
        extra = []
        if name == "moe":
            extra = ["--export-quantized", str(root / "moe.quant.npz"),
                     "--export-pt2", str(root / "moe.pt2")]
        reset_counts()
        out = run_cli(eval_cli.main, ["--checkpoint", str(ck)] + evals +
                      extra)
        launches = add_launches(launches, counts())
        emit({"phase": "families", "part": f"d: {name}: train CLI "
              f"{' '.join(flags)}, 2 epochs, then the eval CLI",
              "T": tr.cfg.seq_len, "steps": steps, "eval_batches": n_eval,
              "launches": got, "losses": losses, "wall_s": wall,
              "val_accuracy": logged, "eval_cli_accuracy": out["accuracy"],
              "warnings": notes})
        if not (len(losses) == steps and np.all(np.isfinite(losses))
                and np.mean(losses[-steps // 2:]) < np.mean(
                    losses[:steps // 2])):
            raise AssertionError(f"families (d): {name} losses {losses}")
        if out["accuracy"] != logged:
            raise AssertionError(f"families (d): {name} eval CLI "
                                 f"{out['accuracy']}, trainer {logged}")
    # the MoE model's artifacts and server
    ck = root / "moe"
    cfg = resolve_artifact_config(str(ck), None, "small16")
    params, _ = restore_eval_params(ck, cfg)
    imgs = serve_images()
    x = torch.from_numpy(imgs).cuda()
    eager = forward(params, x, cfg)
    deq, _ = load_quantized(root / "moe.quant.npz", param_spec(cfg))
    program = load_exported(root / "moe.pt2").module()
    for what, out in ((".quant.npz", forward(deq, x, cfg)),
                      (".pt2", program(x.to(cfg.cdtype())))):
        check("families", f"d: moe {what} against the eager forward", out,
              eager, FAMILY_ARTIFACT_TOL)
        if not torch.equal(out.argmax(-1), eager.argmax(-1)):
            raise AssertionError(f"families (d): moe {what} top-1 differs")
    newest = sorted(ck.glob("*.ckpt"), key=lambda q: int(q.stem))[-1]
    launches = add_launches(launches, serve_ckpt(
        "d: moe", newest, cfg, params, imgs, phase="families"))
    # FlexiViT: the patch-16 registers model at patch 8 (input 112²)
    ck = root / "regmap"
    reset_counts()
    out = run_cli(eval_cli.main, ["--checkpoint", str(ck), "--patch-size",
                                  "8"] + evals)
    launches = add_launches(launches, counts())
    cfg = resolve_artifact_config(str(ck), None, "small16")
    params, _ = restore_eval_params(ck, cfg)
    params, cfg8 = resize_patch_embed(params, cfg, patch_size=8)
    direct = family_eval_accuracy(params, cfg8)
    emit({"phase": "families", "part": "d: eval --patch-size 8 on the "
          "patch-16 registers + MAP + sincos2d .ckpt", "image_size":
          cfg8.image_size, "eval_cli_accuracy": out["accuracy"],
          "direct_accuracy": direct})
    if out["accuracy"] != direct:
        raise AssertionError(f"families (d): --patch-size 8 "
                             f"{out['accuracy']}, direct {direct}")
    return launches


def serve_images() -> np.ndarray:
    """32 preprocessed float32 images of the procedural val split at
    224², as ``serve_ckpt`` serves them."""
    from vitx_torch.data import make_preprocess
    from vitx_torch.data.procedural import ProceduralShapes

    u8 = ProceduralShapes(num_examples=32, seed=1).materialize()[0]
    return make_preprocess(out_size=224, mean=(0.5,) * 3, std=(0.5,) * 3)(
        torch.from_numpy(u8).cuda(), None, train=False).cpu().numpy()


def families_explain(models) -> dict:
    """(e): rollout and Grad-CAM at batch 8 on bench 10's Soft-MoE model
    and the 4-registers model, on the kernels against the kernel-free
    route on the card, launches exact. Returns the launches."""
    from vitx_torch import forward_with_rollout, grad_cam

    launches = {}
    for name, cfg, params in models:
        x = card_images(8, cfg.image_size, 5)
        ref = reference_route(cfg)
        reset_counts()
        logits, w = forward_with_rollout(params, x, cfg)
        torch.cuda.synchronize()
        got = counts()
        expect_launches(f"families (e): {name} rollout", got,
                        rollout_launches(cfg))
        launches = add_launches(launches, got)
        check("families", f"e: {name} rollout b8, kernels vs the "
              "kernel-free route", (logits, w),
              forward_with_rollout(params, x, ref), EXPLAIN_TOL)
        reset_counts()
        cam, logits = grad_cam(params, x, cfg, class_idx=1)
        torch.cuda.synchronize()
        got = counts()
        expect_launches(f"families (e): {name} grad_cam", got,
                        gradcam_launches(cfg))
        launches = add_launches(launches, got)
        check("families", f"e: {name} grad_cam b8, kernels vs the "
              "kernel-free route", (cam, logits),
              grad_cam(params, x, ref, class_idx=1), GRADCAM_TOL)
    return launches


def phase_families() -> dict:
    """Main path 11 (module docstring): vitx's other model families.
    Returns the launches of parts (b) to (e)."""
    import vitx_torch
    from vitx_torch.data import SyntheticDataset

    t0 = time.perf_counter()
    ds = SyntheticDataset(num_examples=128, image_size=224,
                          num_classes=vitx_torch.get_config(
                              "base16").num_classes, seed=0)
    families_card_vs_cpu(ds)
    t_a = time.perf_counter()
    bench, cfg, params = families_bench10(ds)
    t_b = time.perf_counter()
    other, (reg_cfg, reg_params) = families_other_forwards()
    t_c = time.perf_counter()
    cli = families_cli()
    t_d = time.perf_counter()
    explain = families_explain((("soft_moe", cfg, params),
                                ("registers", reg_cfg, reg_params)))
    emit({"phase": "families", "part": "seconds", "a": t_a - t0,
          "b": t_b - t_a, "c": t_c - t_b, "d": t_d - t_c,
          "e": time.perf_counter() - t_d})
    return add_launches(bench, other, cli, explain)




# --- phase optim: vitx's remaining training knobs --------------------------

OPTIM_LR = 1e-4
# (a)'s variants: name -> (make_optimizer knobs, train_step knobs); the
# class weights are drawn in optim_card_vs_cpu
OPTIM_KNOBS = {"sgd": ({"optimizer": "sgd"}, {}),
               "lion": ({"optimizer": "lion"}, {}),
               "adafactor": ({"optimizer": "adafactor"}, {}),
               "adamw_mu_bf16": ({"mu_dtype": "bfloat16"}, {}),
               "sam": ({}, {"sam_rho": 0.05}),
               "bce": ({}, {"loss": "bce"}),
               "class_weights": ({}, {"class_weights": True})}
REMAT_MODES = ("none", "block", "dots", "save_stash")
# (b)'s variants at base16 bf16 b128: name -> (make_optimizer knobs,
# train_step knobs, remat)
OPTIM_TIMED = {"adamw": ({"fused": True}, {}, "none"),
               "adamw_mu_bf16": ({"fused": True, "mu_dtype": "bfloat16"},
                                 {}, "none"),
               "sgd": ({"optimizer": "sgd"}, {}, "none"),
               "lion": ({"optimizer": "lion"}, {}, "none"),
               "adafactor": ({"optimizer": "adafactor"}, {}, "none"),
               "sam": ({"fused": True}, {"sam_rho": 0.05}, "none"),
               "bce": ({"fused": True}, {"loss": "bce"}, "none"),
               "remat_block": ({"fused": True}, {}, "block"),
               "remat_dots": ({"fused": True}, {}, "dots"),
               "remat_save_stash": ({"fused": True}, {}, "save_stash")}
OPTIM_TIMED_B = 128


class RecordingOptimizer:
    """An optimizer that keeps a copy of the gradients each ``update`` is
    given: the ones a train step (SAM's second pass included) feeds it."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def update(self, grads, state, params):
        self.grads = [None if g is None else g.detach().clone()
                      for g in grads]
        return self.opt.update(grads, state, params)

    def __getattr__(self, name):
        return getattr(self.opt, name)


def copy_state(state, device):
    """A ``TrainState`` with every tensor copied to ``device``."""
    from vitx_torch.train.step import TrainState, tree_map

    def cp(t):
        return t.detach().to(device, copy=True)
    opt = state.opt_state
    trees = {n: tree_map(cp, getattr(opt, n))
             for n in (*opt.SLOTS, "ema", "acc")
             if getattr(opt, n) is not None}
    return TrainState(state.step, tree_map(cp, state.params),
                      opt._replace(**trees))


def replay_gap(p_card, p_ref, p_start, lr: float) -> float:
    """max over elements of |card - replay| / (1e-4 lr + 1e-6 of the
    replayed update + one ulp of the replayed param): the card's update
    against the CPU's update of the same gradients from the same state.
    The update's own share covers an Adafactor step, which can be many
    lr where a row's and a column's second moments are small against the
    leaf's mean, and whose means the card sums in another order."""
    worst = 0.0
    for a, b, p in zip(p_card, p_ref, p_start):
        size = b.abs()
        ulp = torch.nextafter(size, torch.full_like(size, np.inf)) - size
        allow = lr * 1e-4 + 1e-6 * (b - p).abs() + ulp
        worst = max(worst, float(((a - b).abs() / allow).max()))
    return worst


def optim_batches(n: int, size: int = 224, classes: int = 1000) -> tuple:
    """(single-label, multi-label) batches of ``n`` synthetic examples:
    uint8 images as the loaders give them, int32 labels, (n, classes)
    multi-hot ones for the second."""
    from vitx_torch.data import SyntheticDataset, SyntheticMultiLabelDataset

    kw = dict(num_examples=n, image_size=size, num_classes=classes, seed=0)
    ml = SyntheticMultiLabelDataset(**kw)
    ex = [ml.get_example(i) for i in range(n)]
    return (synthetic_batch(SyntheticDataset(**kw), n),
            {"image": np.stack([e[0] for e in ex]),
             "label": np.stack([e[1] for e in ex]).astype(np.int32)})


def optim_card_vs_cpu(ce, ml) -> None:
    """(a): base16 at depth 2, fp32, batch 4: each OPTIM_KNOBS variant
    three steps on the card and on the CPU, each step from the same state
    (the CPU's, copied): loss and grad_norm within FP32_TOL, the gradients
    the optimizer was fed within FP32_TOL of each leaf's largest, the
    first step's params within ``param_gap``'s allowance, and every
    step's params within 1e-4 lr, 1e-6 of the update and an ulp of the
    CPU's update of the card's gradients from the same state
    (``replay_gap``). Lion's first
    step is the sign of g, Adam's g / (|g| + eps) with eps -> 0: its
    ``param_gap`` takes eps 1e-30, so that an element whose gradient is
    within the leaf's gap of 0 may take the other sign. Adafactor's first
    step on a factored leaf is g over a rank-1 rms, whose sensitivity to
    g is not bounded by Adam's form: it is held by the replay and the
    gradients alone."""
    import vitx_torch
    from vitx_torch.nn.vit import init_params
    from vitx_torch.train import make_optimizer, train_step
    from vitx_torch.train.step import TrainState, leaves, tree_map

    cfg = vitx_torch.get_config("base16", depth=2, compute_dtype="float32")
    host0 = nudged(init_params(1, cfg, device="cpu"), 2)
    names = leaf_names(host0)
    weights = tuple(float(w) for w in np.random.default_rng(5).uniform(
        0.5, 2.0, cfg.num_classes))
    for name, (opt_kw, step_kw) in OPTIM_KNOBS.items():
        t0 = time.perf_counter()
        step_kw = dict(step_kw)
        if step_kw.get("class_weights"):
            step_kw["class_weights"] = weights
        batch = ml if step_kw.get("loss") == "bce" else ce
        opt = make_optimizer(lr=OPTIM_LR, **opt_kw)
        p = tree_map(torch.clone, host0)
        host = TrainState(0, p, opt.init(p))
        rows = []
        for i in range(3):
            start = copy_state(host, "cpu")
            card = copy_state(host, "cuda")
            rc, rh = RecordingOptimizer(opt), RecordingOptimizer(opt)
            card, mc = train_step(card, batch, cfg=cfg, optimizer=rc,
                                  device="cuda", **step_kw)
            host, mh = train_step(host, batch, cfg=cfg, optimizer=rh,
                                  device="cpu", **step_kw)
            gc = [g.cpu() for g in rc.grads]
            pc = [t.cpu() for t in leaves(card.params)]
            p0 = [t.clone() for t in leaves(start.params)]
            ref, _ = opt.update(gc, start.opt_state, start.params)
            row = {k: abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k]))
                   for k in ("loss", "grad_norm")}
            row["accuracy_gap"] = abs(float(mc["accuracy"])
                                      - float(mh["accuracy"]))
            row["grads"] = max(rel_err(a, b) for a, b in zip(gc, rh.grads))
            row["replay"] = replay_gap(pc, leaves(ref), p0, OPTIM_LR)
            if i == 0 and name != "adafactor":
                row["param_gap"] = param_gap(
                    gc, rh.grads, pc, leaves(host.params), OPTIM_LR,
                    1e-30 if name == "lion" else 1e-8, names)["worst"]
            rows.append(row)
        emit({"phase": "optim", "part": f"a: {name}, base16 depth 2 fp32 "
              "b4, 3 steps card vs CPU", "steps": rows,
              "tol": FP32_TOL, "s": time.perf_counter() - t0})
        for row in rows:
            if not (max(row["loss"], row["grad_norm"], row["grads"])
                    <= FP32_TOL and row["replay"] <= 1.0
                    and row.get("param_gap", 0.0) <= 1.0
                    and row["accuracy_gap"] <= 0.25 + 1e-6):
                raise AssertionError(f"optim (a) {name}: {rows}")


def optim_remat_on_card(ce) -> None:
    """(a) for remat: base16 at depth 2, fp32, batch 4, dropout and
    drop-path 0.1 from a card generator: each mode's loss and gradients
    within 1e-6 of "none"'s (the line says whether bit for bit) and the
    stream where "none" leaves it; then, without dropout (the card's and
    the CPU's generators draw other masks), one step of each mode card vs
    CPU (``check_step_card_vs_cpu``)."""
    import vitx_torch
    from vitx_torch.nn.vit import init_params, params_to
    from vitx_torch.train.step import leaves, loss_fn, tree_map

    cfg = vitx_torch.get_config("base16", depth=2, compute_dtype="float32",
                                dropout=0.1, drop_path=0.1)
    host = nudged(init_params(1, cfg, device="cpu"), 2)
    card = params_to(host, "cuda")
    b = {k: torch.from_numpy(v).cuda() for k, v in ce.items()}
    out = {}
    for mode in REMAT_MODES:
        gen = torch.Generator(device="cuda").manual_seed(5)
        req = tree_map(lambda t: t.detach().requires_grad_(), card)
        loss = loss_fn(req, b, cfg.replace(remat=mode), gen)[0]
        out[mode] = (loss.detach(), torch.autograd.grad(loss, leaves(req)),
                     gen.get_state())
    l0, g0, s0 = out["none"]
    for mode in REMAT_MODES[1:]:
        l1, g1, s1 = out[mode]
        err = max(abs(float(l1) - float(l0)) / abs(float(l0)),
                  max(rel_err(a, c) for a, c in zip(g1, g0)))
        bit = bool(torch.equal(l1, l0) and all(
            torch.equal(a, c) for a, c in zip(g1, g0)))
        emit({"phase": "optim", "part": f"a: remat {mode} vs none, base16 "
              "depth 2 fp32 b4, dropout and drop-path 0.1", "rel_err": err,
              "bit_equal": bit, "same_stream": bool(torch.equal(s1, s0))})
        if err > 1e-6 or not torch.equal(s1, s0):
            raise AssertionError(f"optim (a): remat {mode} {err}")
    det = cfg.replace(dropout=0.0, drop_path=0.0)
    for mode in REMAT_MODES:
        c = tree_map(torch.clone, card)
        h = tree_map(torch.clone, host)
        check_step_card_vs_cpu("optim", f"a: remat {mode} depth 2 fp32 step, "
                               "card vs CPU", det.replace(remat=mode), c, h,
                               ce, OPTIM_LR)


def optim_step_times(ce, ml) -> tuple:
    """(b): base16 bf16 at b128, each OPTIM_TIMED variant: 6 steps (the
    median of the last 5 by CUDA events), launches exact, the peak memory
    from a fresh state. Returns (launches, {variant: row})."""
    import vitx_torch
    from vitx_torch.nn.vit import init_params
    from vitx_torch.train import TrainState, make_optimizer, make_train_step
    from vitx_torch.train.step import tree_map

    base = vitx_torch.get_config("base16")
    params0 = init_params(0, base)
    batches = {k: {n: torch.from_numpy(v).cuda() for n, v in b.items()}
               for k, b in (("ce", ce), ("ml", ml))}
    card, launches, rows = smi(), {}, {}
    for name, (opt_kw, step_kw, remat) in OPTIM_TIMED.items():
        cfg = base.replace(remat=remat)
        opt = make_optimizer(lr=OPTIM_LR, **opt_kw)
        p = tree_map(torch.clone, params0)
        state = TrainState(0, p, opt.init(p))
        step = make_train_step(cfg, opt, **step_kw)
        batch = batches["ml" if step_kw.get("loss") == "bce" else "ce"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        ms, losses = [], []
        for i in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, batch)
            end.record()
            end.synchronize()
            losses.append(float(m["loss"]))
            if i:
                ms.append(start.elapsed_time(end))
        got = counts()
        fused = 6 if opt.fused else 0
        expect_launches(f"optim (b): {name}", got, expected_train_launches(
            cfg, 6, fused, passes=2 if "sam_rho" in step_kw else 1))
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"optim (b) {name}: losses {losses}")
        launches = add_launches(launches, got)
        med = statistics.median(ms)
        rows[name] = {"step_ms": med, "step_ms_runs": ms,
                      "images_per_sec": OPTIM_TIMED_B / (med / 1e3),
                      "peak_memory_gb": torch.cuda.max_memory_allocated()
                      / 1e9, "remat": remat,
                      "launches_per_step": {k: v // 6 for k, v in
                                            got.items() if v}}
        del state, step
        torch.cuda.empty_cache()
    peaks = {m: rows["adamw" if m == "none" else f"remat_{m}"][
        "peak_memory_gb"] for m in REMAT_MODES}
    emit({"phase": "optim", "part": "b: base16 bf16 b128, one step a "
          "variant", "card": card, "rows": rows,
          "peak_memory_gb_by_remat": peaks})
    for m in ("block", "save_stash"):
        if not peaks[m] < peaks["none"]:
            raise AssertionError(f"optim (b): remat {m} peaks at "
                                 f"{peaks[m]} GB, none at {peaks['none']}")
    return launches, rows


def profile_kernel_names(trace: Path) -> set:
    """The GPU kernels' names in a Chrome trace of ``torch.profiler``."""
    events = json.loads(trace.read_text())["traceEvents"]
    return {e.get("name", "") for e in events if e.get("cat") == "kernel"}


def optim_cli() -> dict:
    """(c): the CLIs. small16 on FAMILY_DATA: train --optimizer adafactor
    --steps-per-dispatch 4 with TrainerConfig.profile_epoch 0, launches
    exact, its trace holding K1's (gemm_sm90_kernel, attention_fwd_sm90)
    and B2's (dq_kernel_sm90, dkdv_kernel_sm90) kernels; tiny: train
    --data synthetic-ml --loss bce, launches exact, eval on it equal to
    the trainer's val mAP, eval --soup of it and a nudged copy of its
    params equal to the report of their averaged params; tune --mode
    train --remat
    none,block,save_stash at base16 b64; bench 1's dispatch rows. Returns
    the launches."""
    import dataclasses
    import os
    import shutil

    import vitx_torch.cli.eval as eval_cli
    from vitx_torch.cli import bench, tune
    from vitx_torch.data import SyntheticMultiLabelDataset, make_preprocess
    from vitx_torch.nn.vit import params_to
    from vitx_torch.train.checkpoint import restore_eval_params

    os.environ.setdefault("VITX_PROC_CACHE", str(BUILD / "procdata"))
    root = BUILD / "optim"
    shutil.rmtree(root, ignore_errors=True)
    launches = {}

    logs = root / "profile"
    tr, train_loader, eval_loader, _ = build_quietly(
        ["--preset", "small16", "--data", FAMILY_DATA, "--device-cache",
         "--batch-size", "128", "--epochs", "1", "--lr", "1e-4",
         "--optimizer", "adafactor", "--steps-per-dispatch", "4",
         "--seed", "0", "--log-dir", str(logs)])
    tr.tcfg = dataclasses.replace(tr.tcfg, profile_epoch=0)
    reset_counts()
    t0 = time.perf_counter()
    hist = tr.fit(train_loader, eval_loader)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    expect_launches("optim (c): adafactor k 4 run", got, add_launches(
        expected_train_launches(tr.cfg, len(train_loader), 0),
        forward_launches(tr.cfg, len(eval_loader))))
    launches = add_launches(launches, got)
    names = profile_kernel_names(logs / "profile_epoch0.json")
    want = ("gemm_sm90_kernel", "attention_fwd_sm90", "dq_kernel_sm90",
            "dkdv_kernel_sm90")
    found = {w: sorted(n for n in names if w in n)[:2] for w in want}
    emit({"phase": "optim", "part": "c: train small16 --optimizer adafactor "
          "--steps-per-dispatch 4, profile_epoch 0", "wall_s": wall,
          "loss": hist[-1]["loss"], "val_accuracy": hist[-1]["val_accuracy"],
          "kernels_in_trace": len(names), "found": found})
    if not all(found.values()) or not np.isfinite(hist[-1]["loss"]):
        raise AssertionError(f"optim (c): trace kernels {found}")

    ck = root / "ml"
    tr, train_loader, eval_loader, _ = build_quietly(
        ["--preset", "tiny", "--data", "synthetic-ml", "--loss", "bce",
         "--epochs", "1", "--batch-size", "64", "--lr", "1e-3", "--seed",
         "0", "--checkpoint-dir", str(ck)])
    reset_counts()
    hist = tr.fit(train_loader, eval_loader)
    got = counts()
    expect_launches("optim (c): bce run", got, add_launches(
        expected_train_launches(tr.cfg, len(train_loader), 0),
        forward_launches(tr.cfg, len(eval_loader))))
    launches = add_launches(launches, got)
    logged = hist[-1]["val_mAP"]
    # the soup's second ingredient: the run's params moved by N(0, 0.02)
    other = root / "ml_nudged"
    save_params_ckpt(other, params_to(nudged(params_to(
        tr.state.params, "cpu"), 7), "cuda"), tr.cfg)
    ckpts = [ck, other]
    data = ["--data", "synthetic-ml", "--batch-size", "128"]
    report = run_cli(eval_cli.main, ["--checkpoint", str(ckpts[0]), *data])
    souped = run_cli(eval_cli.main, ["--checkpoint", str(ckpts[0]),
                                     "--soup", str(ckpts[1]), *data])
    cfg = tr.cfg
    a, _ = restore_eval_params(ckpts[0], cfg)
    b, _ = restore_eval_params(ckpts[1], cfg)

    def average(x, y):
        if isinstance(x, dict):
            return {k: average(x[k], y[k]) for k in x}
        return ((x.float() + y.float()) / 2).to(x.dtype)
    mean = average(a, b)
    by_hand = eval_cli.multilabel_report(
        mean, cfg, SyntheticMultiLabelDataset(
            num_examples=512, seed=1, image_size=cfg.image_size,
            num_classes=cfg.num_classes),
        make_preprocess(out_size=cfg.image_size, mean=(0.5,) * 3,
                        std=(0.5,) * 3, random_flip=False), 128,
        torch.device("cuda"))
    emit({"phase": "optim", "part": "c: eval of a bce .ckpt and eval --soup "
          "of it and a nudged copy", "report": {k: report[k] for k in ("mAP", "f1_micro",
                                                       "f1_macro", "loss")},
          "trainer_val_mAP": logged, "soup": {k: souped[k] for k in (
              "mAP", "f1_micro", "f1_macro", "loss")}})
    keys = ("mAP", "f1_micro", "f1_macro", "accuracy", "loss")
    if abs(report["mAP"] - logged) > 1e-6 or any(
            abs(souped[k] - by_hand[k]) > 1e-6 for k in keys):
        raise AssertionError(f"optim (c): eval {report['mAP']} vs {logged};"
                             f" soup {souped} vs {by_hand}")
    del a, b, mean

    out = root / "tune.json"
    run_cli(tune.main, ["--mode", "train", "--preset", "base16",
                        "--batches", "64", "--remat", "none,block,save_stash",
                        "--iters", "3", "--reps", "2", "--out", str(out)])
    rows = json.loads(out.read_text())["results"]
    if [r.get("remat") for r in rows if "error" not in r] != [
            "none", "block", "save_stash"]:
        raise AssertionError(f"optim (c): tune rows {rows}")
    res = bench.BENCHES[1](iters=16, reps=2)
    emit({"phase": "optim", "part": "c: bench 1 with its dispatch rows",
          "card": smi(), **res})
    if not all(f"train_step_ms_k{k}" in res for k in (1, 4, 16)):
        raise AssertionError(f"optim (c): bench 1 {res}")
    torch.cuda.empty_cache()
    return launches


def phase_optim() -> dict:
    """Main path 12 (module docstring): vitx's remaining training knobs.
    Returns the launches of parts (b) and (c)."""
    t0 = time.perf_counter()
    ce, ml = optim_batches(4)
    optim_card_vs_cpu(ce, ml)
    optim_remat_on_card(ce)
    t_a = time.perf_counter()
    ce, ml = optim_batches(OPTIM_TIMED_B)
    timed, _ = optim_step_times(ce, ml)
    t_b = time.perf_counter()
    cli = optim_cli()
    emit({"phase": "optim", "part": "seconds", "a": t_a - t0,
          "b": t_b - t_a, "c": time.perf_counter() - t_b})
    return add_launches(timed, cli)



PRETRAIN_LR = 1.5e-4             # the pretrain CLI's default
PRETRAIN_B = {"mae": 128, "dino": 32, "simclr": 128}
# (b)'s rows whose bf16 loss is held to the CPU's fp32 (a cut: the CPU
# takes seconds a row at full depth)
PRETRAIN_CPU_ROWS = {"mae": 8, "dino": 4, "simclr": 8}
PRETRAIN_STEPS = 10
PRETRAIN_DATA = "procedural:256,64"
PRETRAIN_CLI_B = 64
# the bf16 loss against the CPU's fp32 at the same weights: the repo's
# bf16 parity bar (tests/test_parity_torch.py:80)
PRETRAIN_LOSS_TOL = 0.05


def pretrain_config(name: str, depth: int | None = None,
                    dtype: str = "bfloat16"):
    """A family's config at base16's width: the encoder base16 (cut to
    ``depth`` blocks), MAE's decoder 512 x 8 x 16 (``depth`` blocks),
    DINO's 2 x 224² + 6 x 96² views (2 locals at ``depth``), 4096
    prototypes, SimCLR's 2048 -> 128 head: the pretrain CLI's defaults."""
    import vitx_torch
    from vitx_torch.nn.dino import DINOConfig
    from vitx_torch.nn.mae import MAEConfig
    from vitx_torch.nn.simclr import SimCLRConfig

    kw = {} if depth is None else {"depth": depth}
    enc = vitx_torch.get_config("base16", compute_dtype=dtype, **kw)
    if name == "mae":
        return MAEConfig(encoder=enc, decoder_depth=depth or 8)
    if name == "dino":
        return DINOConfig(encoder=enc, n_local=2 if depth else 6)
    return SimCLRConfig(encoder=enc)


class Family:
    """One family's entry points over a common interface: ``state`` (a
    fresh train state on a device), ``draws`` (the step's random draws,
    from a CPU generator, so that both devices get the same),
    ``loss`` ((loss, extras) of the state's params on ``x`` with those
    draws, differentiable in ``params``) and ``step`` (one train step with
    those draws)."""

    def __init__(self, name: str, fcfg, lr: float = PRETRAIN_LR,
                 freeze_last_steps: int = 0, total_steps: int = 100):
        from vitx_torch.train import make_optimizer

        self.name, self.fcfg = name, fcfg
        self.opt = make_optimizer(lr=lr, weight_decay=0.05)
        self.freeze, self.total = freeze_last_steps, total_steps

    def state(self, seed: int, device):
        import vitx_torch.nn.dino as d
        import vitx_torch.nn.mae as m
        import vitx_torch.nn.simclr as s

        make = {"mae": m.create_mae_train_state,
                "dino": d.create_dino_train_state,
                "simclr": s.create_simclr_train_state}[self.name]
        return make(seed, self.fcfg, self.opt, device=device)

    def draws(self, x, seed: int):
        from vitx_torch.nn.dino import multi_crop_draws
        from vitx_torch.nn.simclr import simclr_view_draws

        gen = torch.Generator().manual_seed(seed)
        xc = x.cpu()
        if self.name == "mae":
            return torch.rand((x.shape[0], self.fcfg.num_patches),
                              generator=gen)
        if self.name == "dino":
            return multi_crop_draws(gen, xc, self.fcfg)
        return simclr_view_draws(gen, xc, self.fcfg)

    def loss(self, state, params, x, draws):
        from vitx_torch.nn.dino import dino_loss_fn, multi_crop
        from vitx_torch.nn.mae import mae_loss_fn
        from vitx_torch.nn.simclr import simclr_loss_fn, simclr_views

        if self.name == "mae":
            return mae_loss_fn(params, {"image": x}, self.fcfg,
                               noise=draws.to(x.device))[0], {}
        if self.name == "dino":
            g, l = multi_crop(x, self.fcfg, draws=draws)
            loss, (_, probs) = dino_loss_fn(params, state.teacher,
                                            state.center, g, l, self.fcfg)
            ent = (-(probs * torch.log(probs + 1e-12)).sum(-1)).mean()
            return loss, {"teacher_entropy": ent}
        loss, acc = simclr_loss_fn(params, simclr_views(
            x, self.fcfg, draws=draws), self.fcfg)
        return loss, {"contrast_acc": acc}

    def step(self, state, x, draws, device):
        import vitx_torch.nn.dino as d
        import vitx_torch.nn.mae as m
        import vitx_torch.nn.simclr as s

        batch = {"image": x}
        if self.name == "mae":
            return m.mae_train_step(state, batch, mcfg=self.fcfg,
                                    optimizer=self.opt, device=device,
                                    noise=draws)
        if self.name == "dino":
            return d.dino_train_step(
                state, batch, dcfg=self.fcfg, optimizer=self.opt,
                total_steps=self.total, freeze_last_steps=self.freeze,
                device=device, draws=draws)
        return s.simclr_train_step(state, batch, scfg=self.fcfg,
                                   optimizer=self.opt, device=device,
                                   draws=draws)


def pretrain_images(name: str, n: int, size: int = 224, seed: int = 0):
    """(n, size, size, 3) fp32 images on the CPU as each family's host
    pipeline gives them (``cli/pretrain.py``): SyntheticDataset's uint8
    gratings scaled to [0, 1] for DINO and SimCLR, and normalised with
    ImageNet's statistics for MAE."""
    from vitx_torch.data import SyntheticDataset
    from vitx_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD

    ds = SyntheticDataset(num_examples=n, image_size=size, seed=seed)
    x = torch.from_numpy(synthetic_batch(ds, n)["image"]).float() / 255.0
    if name == "mae":
        x = (x - torch.tensor(IMAGENET_MEAN)) / torch.tensor(IMAGENET_STD)
    return x


def copy_family_state(state, device):
    """A family's state (``TrainState`` or ``DINOState``) with every
    tensor copied to ``device``."""
    from vitx_torch.train.step import tree_map

    out = copy_state(state, device)
    if hasattr(state, "teacher"):
        return state._replace(params=out.params, opt_state=out.opt_state,
                              teacher=tree_map(lambda t: t.detach().to(
                                  device, copy=True), state.teacher),
                              center=state.center.to(device, copy=True))
    return out


# leaves whose gradient is zero but for rounding: SimCLR's batch
# standardisation of fc1's output cancels any shift of its input, so fc1's
# bias and the encoder's final-norm bias (a shift of the CLS feature) get
# none
ZERO_GRAD_LEAVES = {"simclr": ("encoder/final_norm/bias", "head/fc1/bias")}


def grads_rel_err(gc, gh, names, zero=()) -> tuple:
    """(the worst leaf's max |card - CPU| over its largest |CPU| gradient,
    that leaf's name); over the largest gradient of all leaves for the
    ``zero`` leaves, whose rounding noise has no relative error to speak
    of (tests/torch_pretrain_helpers.py::grads_close holds the CPU tests
    to vitx the same way)."""
    top = max(float(b.abs().max()) for b in gh)
    return max((float((a - b).abs().max())
                / (top if n in zero else max(float(b.abs().max()), 1e-30)), n)
               for n, a, b in zip(names, gc, gh))


def pretrain_card_vs_cpu(name: str) -> None:
    """(a): the family at base16's widths, depth 2 (MAE's decoder 512 x 2
    x 16: D 32), fp32, batch 4 (DINO 2 images: 4 global and 4 local
    views), the same params, state and draws on the card and on the CPU:
    the loss and the monitors within FP32_TOL, every leaf's gradient
    within FP32_TOL (``grads_rel_err``), then one step: the params
    within ``param_gap``'s allowance (AdamW without clipping; DINO's
    prototypes frozen for this step, their gradient zeroed and weights
    pinned on both), DINO's teacher and centre within FP32_TOL."""
    from vitx_torch.train.step import leaves, tree_map

    fam = Family(name, pretrain_config(name, depth=2, dtype="float32"),
                 lr=1e-4, freeze_last_steps=1)
    host = fam.state(1, "cpu")
    host = host._replace(params=nudged(host.params, 2))
    if name == "dino":
        host = host._replace(teacher=nudged(host.teacher, 3),
                             center=0.1 * torch.randn(
                                 fam.fcfg.out_dim,
                                 generator=torch.Generator().manual_seed(4)))
    x = pretrain_images(name, 2 if name == "dino" else 4)
    draws = fam.draws(x, 5)
    names = leaf_names(host.params)
    out = []
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        state = copy_family_state(host, dev)
        xd = x.to(dev)
        req = tree_map(lambda t: t.detach().requires_grad_(), state.params)
        loss, extra = fam.loss(state, req, xd, draws)
        grads = [g.cpu() for g in torch.autograd.grad(loss, leaves(req))]
        state, m = fam.step(state, xd, draws, dev)
        out.append((grads, state, {**{k: float(v) for k, v in m.items()},
                                   **{f"loss_fn_{k}": float(v)
                                      for k, v in extra.items()}}))
    (gc, sc, mc), (gh, sh, mh) = out
    errs = {k: abs(mc[k] - mh[k]) / max(abs(mh[k]), 1e-12) for k in mh}
    errs["grads"], worst_leaf = grads_rel_err(
        gc, gh, names, ZERO_GRAD_LEAVES.get(name, ()))
    if name == "dino":
        i = names.index("head/last")
        gc[i], gh[i] = gc[i] * 0.0, gh[i] * 0.0
        errs["teacher"] = max(rel_err(a.cpu(), b) for a, b in zip(
            leaves(sc.teacher), leaves(sh.teacher)))
        errs["center"] = rel_err(sc.center.cpu(), sh.center)
        pinned = bool(torch.equal(sc.params["head"]["last"].cpu(),
                                  host.params["head"]["last"]))
    gap = param_gap(gc, gh, [t.cpu() for t in leaves(sc.params)],
                    leaves(sh.params), 1e-4, 1e-8, names)
    emit({"phase": "pretrain", "part": f"a: {name} base16 widths depth 2 "
          "fp32, card vs CPU", "card": mc, "cpu": mh, "rel_err": errs,
          "grads_worst_leaf": worst_leaf, "params": gap, "tol": FP32_TOL,
          "s": time.perf_counter() - t0,
          **({"prototypes_pinned": pinned} if name == "dino" else {})})
    if not (max(errs.values()) <= FP32_TOL and gap["worst"] <= 1.0):
        raise AssertionError(f"pretrain (a) {name}: {errs}, {gap}")
    if name == "dino" and not pinned:
        raise AssertionError("pretrain (a) dino: the prototypes moved")


def pretrain_step_launches(fcfg, steps: int) -> dict:
    """A family's train-step launches per the code's routing, every block
    on the fused kernels with their stashes (the families keep
    fuse_mlp="auto" under grad): K1 and K2 once a block, forward only in
    DINO's teacher, their attention on the sm90 body where ``attn_sm90``
    says; B2 once a block under grad (its sm90 kernel at D 64, the
    encoder's, and at D 32, MAE's decoder's); B3 for both LayerNorms of
    every block under grad and each final norm (MAE's encoder and
    decoder; DINO's two student passes). No B12: the pretrain CLI's
    optimizer keeps the plain update (vitx's ``fused="auto"``)."""
    enc = fcfg.encoder
    L = enc.depth
    mha90, mlp90 = gemm_sm90(enc)
    if hasattr(fcfg, "decoder_cfg"):
        dec = fcfg.decoder_cfg
        Ld = dec.depth
        dmha, dmlp = gemm_sm90(dec)
        blocks = L + Ld
        per = dict(fused_mha_block=blocks, fused_mlp_block=blocks,
                   fused_mha_block_sm90=L * mha90 + Ld * dmha,
                   fused_mha_block_attn_sm90=L * attn_sm90(enc)
                   + Ld * attn_sm90(dec),
                   fused_mlp_block_sm90=L * mlp90 + Ld * dmlp,
                   attention_bwd=blocks,
                   attention_bwd_sm90=L * sm90(enc) + Ld * sm90(dec),
                   ln_bwd=2 * blocks + 2)
    else:
        passes = 2 if getattr(fcfg, "n_local", 0) else 1
        fwd = L * (passes + hasattr(fcfg, "n_local"))
        per = dict(fused_mha_block=fwd, fused_mlp_block=fwd,
                   fused_mha_block_sm90=fwd * mha90,
                   fused_mha_block_attn_sm90=fwd * attn_sm90(enc),
                   fused_mlp_block_sm90=fwd * mlp90,
                   attention_bwd=L * passes,
                   attention_bwd_sm90=L * passes * sm90(enc),
                   ln_bwd=passes * (2 * L + 1))
    return launches_of(**{k: v * steps for k, v in per.items()})


def pretrain_full_width(name: str) -> tuple:
    """(b): the family at full width and depth in bf16 at PRETRAIN_B[name]
    (MAE b128, decoder 512 x 8 x 16; DINO b32, 2 x 224² + 6 x 96², 4096
    prototypes; SimCLR b128, 256 views), seeded random weights: the bf16
    loss on the first PRETRAIN_CPU_ROWS[name] rows against the CPU's
    fp32 at the same weights and draws (PRETRAIN_LOSS_TOL); then, counted,
    PRETRAIN_STEPS steps on one batch with the same draws each step (MAE's
    and SimCLR's losses fall, DINO's stay finite with the teacher's
    entropy in (0, log K]) and 6 more, the median of the last 5 by CUDA
    events and the peak memory from a fresh state's first step; then one
    step under the profiler (its kernels by device time). Returns
    (launches, row)."""
    fam = Family(name, pretrain_config(name))
    B = PRETRAIN_B[name]
    state = fam.state(0, "cuda")
    x = pretrain_images(name, B)
    R = PRETRAIN_CPU_ROWS[name]
    draws = fam.draws(x[:R], 11)
    with torch.no_grad():
        card_loss = float(fam.loss(state, state.params, x[:R].cuda(),
                                   draws)[0])
        f32 = Family(name, pretrain_config(name, dtype="float32"))
        host = copy_family_state(state, "cpu")
        cpu_loss = float(f32.loss(host, host.params, x[:R], draws)[0])
    del host
    gap = abs(card_loss - cpu_loss) / abs(cpu_loss)
    draws = fam.draws(x, 12)
    xd = x.cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    mets, ms = [], []
    for i in range(PRETRAIN_STEPS + 6):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = fam.step(state, xd, draws, "cuda")
        end.record()
        end.synchronize()
        if i == 0:
            peak = torch.cuda.max_memory_allocated() / 1e9
        if i < PRETRAIN_STEPS:
            mets.append({k: float(v) for k, v in m.items()})
        elif i > PRETRAIN_STEPS:
            ms.append(start.elapsed_time(end))
    got = counts()
    expect = pretrain_step_launches(fam.fcfg, PRETRAIN_STEPS + 6)
    # where a step's time goes, by kernel (after the counted window)
    device_ms, wall_ms = profile_call(
        f"pretrain {name} step b{B}", lambda: fam.step(state, xd, draws,
                                                       "cuda"),
        top=16, wall=True) or ("not measured", "not measured")
    losses = [m["loss"] for m in mets]
    med = statistics.median(ms)
    row = {"batch": B, "step_ms": med, "step_ms_runs": ms,
           "profiled_device_ms": device_ms, "profiled_wall_ms": wall_ms,
           "images_per_sec": B / (med / 1e3), "peak_memory_gb": peak,
           "losses": losses, "loss_bf16_vs_cpu_fp32": {
               "card": card_loss, "cpu": cpu_loss, "rel": gap, "rows": R},
           "launches_per_step": {k: v // (PRETRAIN_STEPS + 6)
                                 for k, v in got.items() if v}}
    if name == "dino":
        row["teacher_entropy"] = [m["teacher_entropy"] for m in mets]
    if name == "simclr":
        row["contrast_acc"] = [m["contrast_acc"] for m in mets]
    emit({"phase": "pretrain", "part": f"b: {name} base16 bf16 b{B}",
          "card": smi(), **row})
    expect_launches(f"pretrain (b): {name}", got, expect)
    if gap > PRETRAIN_LOSS_TOL:
        raise AssertionError(f"pretrain (b) {name}: bf16 loss {card_loss} "
                             f"vs the CPU's fp32 {cpu_loss}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"pretrain (b) {name}: losses {losses}")
    if name == "dino":
        ents = row["teacher_entropy"]
        if not all(0.0 < e <= np.log(fam.fcfg.out_dim) + 1e-4
                   for e in ents):
            raise AssertionError(f"pretrain (b) dino: entropy {ents}")
    elif not losses[-1] < losses[0]:
        raise AssertionError(f"pretrain (b) {name}: losses {losses}")
    del state
    torch.cuda.empty_cache()
    return got, row


def check_pretrain_kernels(errs: dict) -> None:
    """(c): the kernels at the families' new shapes against their plain
    versions on the card, float32 (1e-4) and bfloat16 (BF16_TOL), each
    twice bit for bit: at MAE's decoder (128, 197, 512), 16 heads of D
    32, K1 with its stash (the sm90 GEMM in bf16 with the earlier
    attention), K2 with its stash (M 2048), B2 (its earlier kernel) and
    B3; at MAE's visible tokens (128, 50, 768) and DINO's locals (192,
    37, 768), K1 with its stash, B2 (the sm90 kernel in bf16: T under one
    64-row tile) and B3 (``check_backward_kernels``, which also holds B3
    at the (B, 4E) view)."""
    from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    for dtype in (torch.float32, torch.bfloat16):
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        bf = dtype == torch.bfloat16
        for B, T, E, H, mlp in ((128, 197, 512, 16, True),
                                (128, 50, 768, 12, False),
                                (192, 37, 768, 12, False)):
            info = {"dtype": str(dtype), "shape": [B, T, E], "heads": H}
            x, mha, mlpw = block_inputs(B, T, E, H, 4 * E, dtype, 40 + T,
                                        "cuda")
            n90 = fused_mha_block.launches_sm90
            out = fused_mha_block(x, **mha, stash=True)
            torch.cuda.synchronize()
            name = ("fused_mha_block_sm90"
                    if fused_mha_block.launches_sm90 > n90
                    else "fused_mha_block")
            check("pretrain", f"{name} with its stash (out, q, k, v, "
                  "o_all)", out, mha_block_plain(x, **mha, stash=True), tol,
                  errs if bf else None, name, **info)
            bitwise("pretrain", f"{name} with its stash, twice",
                    fused_mha_block(x, **mha, stash=True), out, **info)
            if mlp:
                n90 = fused_mlp_block.launches_sm90
                out = fused_mlp_block(x, **mlpw, act="gelu_tanh",
                                      stash=True)
                torch.cuda.synchronize()
                name = ("fused_mlp_block_sm90"
                        if fused_mlp_block.launches_sm90 > n90
                        else "fused_mlp_block")
                check("pretrain", f"{name} with its stash (out, hp)", out,
                      mlp_block_plain(x, **mlpw, act="gelu_tanh",
                                      stash=True), tol,
                      errs if bf else None, name, M=4 * E, **info)
                bitwise("pretrain", f"{name} with its stash, twice",
                        fused_mlp_block(x, **mlpw, act="gelu_tanh",
                                        stash=True), out, M=4 * E, **info)
            del x, mha, mlpw, out
            check_backward_kernels(B, T, E, H, dtype, tol, errs, "pretrain")
        torch.cuda.empty_cache()


def pretrain_kernel_shapes(launches: dict, errs: dict) -> dict:
    """The families' new kernel shapes, bf16, as more ``shapes`` of the
    rows: K1's sm90 row with its stash at MAE's decoder (128, 197, 512;
    D 32: the sm90 GEMM and the sm90 attention, its GEMM-only route --
    the sm90 GEMM with attention_fwd.cuh -- as was_ms), its visible tokens
    (128, 50, 768) and DINO's locals (192, 37, 768); B2's two rows and
    B5's two at the decoder's (128, 16, 197, 32) and B2's sm90 row at
    (128, 12, 50, 64) and (192, 12, 37, 64); K2's sm90 row with its stash
    at the decoder's (128, 197, 512), M 2048; B3's one-pass row at (128,
    197, 512) and (128, 50, 768). Library calls: SDPA compositions, SDPA,
    SDPA's backward, F.layer_norm / F.linear / GELU / F.linear,
    F.layer_norm's backward."""
    import torch.nn.functional as F

    from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    bf = torch.bfloat16
    eps = 1e-5
    rows = []
    for B, T, E, H in ((128, 197, 512, 16), (128, 50, 768, 12),
                       (192, 37, 768, 12)):
        D = E // H
        x, mha, mlp = block_inputs(B, T, E, H, 4 * E, bf, 50 + T, "cuda")
        more = {}
        if E == 512:   # D 32: the attention's earlier kernel beside it
            tmha = block_module()
            st = torch.empty((2, B, H, T), dtype=torch.float32,
                             device="cuda")
            runs = [cuda_ms(lambda: tmha._launch(
                x, **mha, eps=eps, extra=(st,),
                route=tmha.ROUTE_GEMM_SM90), reps=20) for _ in range(2)]
            more = {"was_ms": min(runs), "was_ms_runs": runs,
                    "was": "the GEMM-only route with the stash: the sm90 "
                           "GEMM with attention_fwd.cuh"}
        rows.append(kernel_row(
            "fused_mha_block_sm90",
            lambda: fused_mha_block(x, **mha, eps=eps, stash=True),
            lambda: mha_block_plain(x, **mha, eps=eps, stash=True),
            sdpa_mha(x, mha, H, eps),
            2 * B * T * E * 4 * E + 4 * B * H * T * T * D, PEAK_BF16_FLOPS,
            6 * B * T * E * 2 + 4 * E * E * 2 + 3 * E * 4
            + 2 * B * H * T * 4, launches, errs, shape=[B, T, E],
            heads=H, stash=True, **more))
        if E == 512:
            M = 4 * E
            w1t, w2t = (mlp[k].t().contiguous() for k in ("w1", "w2"))

            def lib():
                h = F.layer_norm(x, (E,), mlp["g"].to(bf), mlp["b"].to(bf),
                                 eps)
                h = F.gelu(F.linear(h, w1t, mlp["b1"].to(bf)),
                           approximate="tanh")
                return F.linear(h, w2t, mlp["b2"].to(bf))
            rows.append(kernel_row(
                "fused_mlp_block_sm90",
                lambda: fused_mlp_block(x, **mlp, act="gelu_tanh", eps=eps,
                                        stash=True),
                lambda: mlp_block_plain(x, **mlp, act="gelu_tanh", eps=eps,
                                        stash=True),
                lib, 4 * B * T * E * M, PEAK_BF16_FLOPS,
                2 * B * T * E * 2 + B * T * M * 2 + 2 * E * M * 2
                + (M + 3 * E) * 4, launches, errs, shape=[B, T, E], M=M,
                stash=True))
            rows += attention_bwd_rows((B, H, T, D), 60, launches, errs)
            rows += flash_rows((B, H, T, D), 64, launches, errs)
        else:
            rows += attention_bwd_rows((B, H, T, D), 60 + T, launches,
                                       errs, only="attention_bwd_sm90")
        if B == 128:
            rows += ln_bwd_rows((B, T, E), 65 + T, eps, launches, errs,
                                only="ln_bwd_onepass")
        del x, mha, mlp
        torch.cuda.empty_cache()
    extra: dict = {}
    for row in rows:
        extra.setdefault(row["name"], []).append(shape_entry(row))
    return extra


def pretrain_cli() -> dict:
    """(d): ``vitx_torch.cli.pretrain`` on tiny with PRETRAIN_DATA at
    b64 (4 steps an epoch), each method with the CLI's defaults: 2 epochs,
    then a rerun to 3 on the same directory (the resume message; 4 more
    steps), launches exact; the export (the teacher for DINO) read by
    ``params_from_jax``, the last ``.ckpt``'s encoder leaves equal to it;
    then ``cli.train --init-from`` the MAE export for one epoch (launches
    exact) and ``cli.probe`` on it. Returns the launches."""
    import contextlib
    import io
    import os
    import shutil

    import vitx_torch
    from vitx_torch.cli import pretrain, probe
    from vitx_torch.interop.jax_params import params_from_jax
    from vitx_torch.train.checkpoint import restore_latest
    from vitx_torch.train.step import leaf_paths, leaves

    os.environ.setdefault("VITX_PROC_CACHE", str(BUILD / "procdata"))
    root = BUILD / "pretrain"
    shutil.rmtree(root, ignore_errors=True)
    cfg = vitx_torch.get_config("tiny")
    ft_cfg = cfg.replace(final_norm=True)
    ft_json = root / "tiny_final_norm.json"
    root.mkdir(parents=True)
    ft_json.write_text(ft_cfg.to_json())
    launches, exports = {}, {}
    steps_per_epoch = int(PRETRAIN_DATA.split(":")[1].split(",")[0]) \
        // PRETRAIN_CLI_B
    for method in ("mae", "dino", "simclr"):
        ck, out = root / method, root / f"{method}.npz"
        argv = ["--preset", "tiny", "--method", method, "--data",
                PRETRAIN_DATA, "--batch-size", str(PRETRAIN_CLI_B),
                "--checkpoint-dir", str(ck)]
        # the family config the CLI builds with its default flags
        fcfg = pretrain.family_config(
            pretrain.build_argparser().parse_args(["--method", method]), cfg)
        for epochs, more in ((2, []), (3, ["--export-vit", str(out)])):
            reset_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = pretrain.main(argv + ["--epochs", str(epochs), *more])
            torch.cuda.synchronize()
            got = counts()
            text = buf.getvalue()
            print(text, end="", flush=True)
            last = json.loads(text.strip().splitlines()[-1])
            steps = steps_per_epoch * (2 if epochs == 2 else 1)
            expect_launches(f"pretrain (d): {method} --epochs {epochs}",
                            got, pretrain_step_launches(fcfg, steps))
            launches = add_launches(launches, got)
            if rc != 0 or not np.isfinite(last["loss"]):
                raise AssertionError(f"pretrain (d) {method}: {last}")
        if f"resumed {method.upper()} pretraining at epoch 2" not in text:
            raise AssertionError(f"pretrain (d) {method}: no resume")
        exported = params_from_jax(str(out), ft_cfg)
        template = Family(method, fcfg).state(0, "cuda")
        state, _ = restore_latest(ck, template, False)
        enc = (state.teacher if method == "dino" else state.params)[
            "encoder"]
        for path, t in zip(leaf_paths(enc), leaves(enc)):
            node = exported
            for k in path:
                node = node[k]
            if not torch.equal(node, t):
                raise AssertionError(f"pretrain (d) {method}: exported "
                                     f"{'/'.join(path)} differs")
        exports[method] = last
    emit({"phase": "pretrain", "part": "d: cli.pretrain tiny, each method "
          "2 epochs then a resume to 3, exports", "last": exports})

    tr, train_loader, eval_loader, _ = build_quietly(
        ["--preset", "tiny", "--data", PRETRAIN_DATA, "--batch-size",
         str(PRETRAIN_CLI_B), "--epochs", "1", "--init-from",
         str(root / "mae.npz"), "--checkpoint-dir", str(root / "ft")])
    reset_counts()
    hist = tr.fit(train_loader, eval_loader)
    torch.cuda.synchronize()
    got = counts()
    expect_launches("pretrain (d): train --init-from the MAE export", got,
                    add_launches(expected_train_launches(
                        tr.cfg, len(train_loader), 0),
                        forward_launches(tr.cfg, len(eval_loader))))
    launches = add_launches(launches, got)
    report = run_cli(probe.main, ["--checkpoint", str(root / "mae.npz"),
                                  "--config-json", str(ft_json), "--data",
                                  PRETRAIN_DATA, "--knn", "5"])
    emit({"phase": "pretrain", "part": "d: train --init-from the MAE "
          "export, 1 epoch; probe on the export",
          "loss": hist[-1]["loss"], "val_accuracy": hist[-1]["val_accuracy"],
          "final_norm": tr.cfg.final_norm, "probe": report})
    if not (tr.cfg.final_norm and np.isfinite(hist[-1]["loss"])):
        raise AssertionError(f"pretrain (d): fine-tune {hist[-1]}")
    torch.cuda.empty_cache()
    return launches


def phase_pretrain(errs: dict) -> tuple:
    """Main path 13 (module docstring): vitx's self-supervised
    pretraining. Returns (the launches of parts (b) and (d), the new
    kernel shapes' entries for the kernels line)."""
    t0 = time.perf_counter()
    for name in ("mae", "dino", "simclr"):
        pretrain_card_vs_cpu(name)
    t_a = time.perf_counter()
    launches, rows = {}, {}
    for name in ("mae", "dino", "simclr"):
        got, rows[name] = pretrain_full_width(name)
        launches = add_launches(launches, got)
    t_b = time.perf_counter()
    check_pretrain_kernels(errs)
    extra = pretrain_kernel_shapes({}, errs)
    t_c = time.perf_counter()
    launches = add_launches(launches, pretrain_cli())
    emit({"phase": "pretrain", "part": "seconds", "a": t_a - t0,
          "b": t_b - t_a, "c": t_c - t_b, "d": time.perf_counter() - t_c,
          "step_ms": {k: r["step_ms"] for k, r in rows.items()},
          "peak_memory_gb": {k: r["peak_memory_gb"] for k, r in rows.items()}})
    return launches, extra


# the sharded runs of phase parallel: name -> (dp, tp, ep, ZeRO stage, sp)
PARALLEL = {"dp2": (2, 1, 1, 0, False), "zero1": (2, 1, 1, 1, False),
            "zero2": (2, 1, 1, 2, False), "zero3": (2, 1, 1, 3, False),
            "tp2_sp": (1, 2, 1, 0, True), "ep2": (1, 1, 2, 0, False)}
PARALLEL_A_B = 8        # (a)'s global batch, depth-2 fp32 copies
PARALLEL_B = 128        # (b)'s global batch at full width, bf16
PARALLEL_STEPS = 3      # (b)'s timed steps, after one warm-up
PARALLEL_LR = 1e-4
PARALLEL_DRAW = "cuda"  # where the phase's batches are drawn (same values
                        # in every rank and in the parent)
# (b): the sharded step's loss and grad_norm against the single-process
# step on the card, bf16 (BF16_TOL: the order of the gradient sums moves
# with the ranks)
PARALLEL_TOL = BF16_TOL


def parallel_cfg(name: str, depth: int | None = None,
                 dtype: str = "bfloat16"):
    """base16 at ``dtype`` (cut to ``depth``); for ep2 bench 10's
    Soft-MoE model (8 experts over the last 6 blocks; over the last one
    at a cut depth)."""
    import vitx_torch

    kw = {"compute_dtype": dtype}
    if depth is not None:
        kw["depth"] = depth
    if name == "ep2":
        kw.update(moe_experts=8, moe_blocks=1 if depth else 6)
    return vitx_torch.get_config("base16", **kw)


def parallel_batch(n: int, seed: int, device) -> dict:
    """n images at 224² and labels, drawn on the card from ``seed`` (the
    same on every rank and in the parent), on ``device``."""
    g = torch.Generator(device=PARALLEL_DRAW).manual_seed(seed)
    x = torch.randn((n, 224, 224, 3), generator=g, device=PARALLEL_DRAW)
    y = torch.randint(0, 4, (n,), generator=g, device=PARALLEL_DRAW)
    return {"image": x.to(device), "label": y.to(torch.int32).to(device)}


def parallel_params_a(name: str, device):
    """(a)'s weights: the depth-2 fp32 copy's init, nudged (CPU draws)."""
    from vitx_torch.nn.vit import init_params
    from vitx_torch.train.step import tree_map

    host = nudged(init_params(0, parallel_cfg(name, 2, "float32"),
                              device="cpu"), 2)
    return tree_map(lambda t: t.to(device), host)


def parallel_setup(flags: tuple, mesh, params, opt, cfg):
    """-> (the rank's cfg, state, specs, grad specs) of a run whose
    ``flags`` are (dp, tp, ep, ZeRO stage, sp), as PARALLEL's."""
    from vitx_torch.parallel import sharded
    from vitx_torch.train.step import TrainState

    dp, tp, ep, zero, sp = flags
    run_cfg = sharded.ep_cfg(sharded.sp_cfg(sharded.tp_safe_cfg(
        cfg, tp > 1), tp > 1, sp), mesh, ep > 1)
    whole = TrainState(0, params, opt.init(params))
    specs = sharded.state_sharding(whole, run_cfg, mesh, tp > 1,
                                   zero in (1, 2), zero == 3, ep=ep > 1)
    gspecs = (sharded.grad_sharding(params, run_cfg, mesh, tp > 1, ep > 1)
              if zero == 2 else None)
    state = sharded.place_state(whole, run_cfg, mesh, specs=specs)
    step = sharded.make_parallel_train_step(
        run_cfg, opt, mesh, tp=tp > 1, zero1=zero in (1, 2), zero3=zero == 3,
        sp=sp, ep=ep > 1, state_shardings=specs, grad_shardings=gspecs)
    return run_cfg, state, specs, gspecs, step


def gloo_collectives(ctx) -> dict:
    """Which collectives the group's backend takes on CUDA tensors, each
    tried once on the world group: "ok" or the error it raised (the
    port's ``comm`` avoids what gloo lacks, its module doc)."""
    import torch.distributed as dist

    x = torch.arange(4, dtype=torch.float32, device=ctx.device) + ctx.rank
    two = [torch.empty(2, device=ctx.device) for _ in range(ctx.world)]
    tries = {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(ctx.world)], x),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty(2, device=ctx.device), [x[:2].clone(),
                                                x[2:].clone()]),
        "all_to_all": lambda: dist.all_to_all(two, [x[:2].clone(),
                                                    x[2:].clone()]),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
    }
    out = {}
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except RuntimeError as e:
            out[name] = str(e).splitlines()[0]
    return out


def parallel_rank(ctx, a_cases, b_cases) -> dict:
    """Phase parallel's (a) and (b) on one rank of two sharing the card
    (gloo, by the backend rule): which collectives gloo takes on CUDA
    tensors; (a) each case's reduced gradients, loss, grad_norm and
    params after one step, gathered whole (rank 0); (b) each run's losses
    and grad norms, step times, peak memory and the launches counted in
    this rank over its steps."""
    from vitx_torch.parallel import make_mesh, sharded
    from vitx_torch.train.step import (create_train_state, gradients,
                                       leaves, loss_fn, make_optimizer,
                                       trainable_params)

    out = {"a": {}, "b": {}, "backend": ctx.backend,
           "collectives": gloo_collectives(ctx)}
    for name in a_cases:
        dp, tp, ep, zero, sp = PARALLEL[name]
        mesh = make_mesh(dp, tp, ep, device=ctx.device)
        opt = make_optimizer(lr=1e-4)
        cfg, state, specs, gspecs, step = parallel_setup(
            PARALLEL[name], mesh, parallel_params_a(name, mesh.device), opt,
            parallel_cfg(name, 2, "float32"))
        batch = sharded.shard_batch(parallel_batch(PARALLEL_A_B, 7,
                                                   mesh.device), mesh)
        plan = sharded.Plan(specs, mesh, state.params, gspecs)
        p, wrt = trainable_params(state.params)
        loss_v, _ = loss_fn(sharded.forward_params(p, specs.params, mesh),
                            batch, cfg, mesh=mesh)
        grads, gs = plan.reduce(gradients(loss_v, p, wrt), wrt, final=False)
        grads = [sharded.gather_part(g, s, mesh).cpu()
                 for g, s in zip(grads, gs)]
        state, m = step(state, batch)
        whole = sharded.gather_state(state, specs, mesh)
        if ctx.rank == 0:
            out["a"][name] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "grads": [g.numpy() for g in grads],
                "params": [t.cpu().numpy() for t in leaves(whole.params)]}
        del state, whole, grads, p, loss_v
        torch.cuda.empty_cache()
    for name in b_cases:
        dp, tp, ep, zero, sp = PARALLEL[name]
        mesh = make_mesh(dp, tp, ep, device=ctx.device)
        opt = make_optimizer(lr=PARALLEL_LR, fused=True)
        base = parallel_cfg(name)
        whole = create_train_state(0, base, opt, device=mesh.device)
        cfg, state, specs, _, step = parallel_setup(
            PARALLEL[name], mesh, whole.params, opt, base)
        del whole
        torch.cuda.empty_cache()
        batch = sharded.shard_batch(parallel_batch(PARALLEL_B, 11,
                                                   mesh.device), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, norms, ms = [], [], []
        for _ in range(1 + PARALLEL_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
            norms.append(float(m["grad_norm"]))
        out["b"][name] = {
            "losses": losses, "grad_norms": norms, "warmup_ms": ms[0],
            "ms": ms[1:], "step_ms": statistics.median(ms[1:]),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts(),
            "rank_params_m": sum(t.numel() for t in leaves(state.params))
            / 1e6}
        del state, batch, m
        torch.cuda.empty_cache()
    return out


def parallel_reference_a(name: str, **over) -> dict:
    """(a)'s single-process step on the CPU: the gradients, loss,
    grad_norm and params after one plain AdamW step (``over``: the
    config's overrides)."""
    from vitx_torch.train.step import (TrainState, gradients, leaves,
                                       loss_fn, make_optimizer, train_step,
                                       trainable_params)

    cfg = parallel_cfg(name, 2, "float32").replace(**over)
    params = parallel_params_a(name, "cpu")
    batch = parallel_batch(PARALLEL_A_B, 7, "cpu")
    p, wrt = trainable_params(params)
    grads = gradients(loss_fn(p, batch, cfg)[0], p, wrt)
    opt = make_optimizer(lr=1e-4)
    state, m = train_step(TrainState(0, params, opt.init(params)), batch,
                          cfg=cfg, optimizer=opt, device="cpu")
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": grads, "params": leaves(state.params),
            "names": leaf_names(params)}


def parallel_reference_b(name: str) -> dict:
    """(b)'s single-process step on the card at the global batch: the
    first step's loss and grad_norm, the losses of 1 + PARALLEL_STEPS
    steps and the median step time after the warm-up, its peak memory."""
    from vitx_torch.train.step import (create_train_state, make_optimizer,
                                       train_step)

    cfg = parallel_cfg(name)
    opt = make_optimizer(lr=PARALLEL_LR, fused=True)
    state = create_train_state(0, cfg, opt)
    batch = parallel_batch(PARALLEL_B, 11, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms = [], [], []
    for _ in range(1 + PARALLEL_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = train_step(state, batch, cfg=cfg, optimizer=opt)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
        norms.append(float(m["grad_norm"]))
    out = {"losses": losses, "grad_norms": norms, "ms": ms[1:],
           "step_ms": statistics.median(ms[1:]),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state, batch
    torch.cuda.empty_cache()
    return out


def parallel_expected(name: str, steps: int) -> dict:
    """A rank's launches over ``steps`` (b) steps, per the code's routing:
    dp, ZeRO and ep as the single-process step at the rank's batch (K1
    12, B2 12 on its sm90 route, B3 25, B12 1 a step); tp2 with sp the
    composed block, as vitx (fuse "auto" -> "off" under tp): B5 12 on its
    sm90 route in K1's place, B2 12, B3 25, B12 1."""
    cfg = parallel_cfg(name)
    if PARALLEL[name][1] == 1:
        return expected_train_launches(cfg, steps, steps)
    n = cfg.depth * steps
    b3 = 2 * cfg.depth + head_lns(cfg) + int(cfg.final_norm)
    return block_launches(cfg, flash_attention=n,
                          flash_attention_sm90=n * sm90(cfg),
                          attention_bwd=n, attention_bwd_sm90=n * sm90(cfg),
                          ln_bwd=b3 * steps, fused_adamw_multi_=steps)


def parallel_a(got: dict) -> None:
    """(a): each sharded depth-2 fp32 run on the card against the
    single-process step on the CPU: loss, grad_norm and every gradient
    within FP32_TOL, the params after the step within ``param_gap``."""
    refs = {}
    for name, card in got.items():
        key = "ep2" if name == "ep2" else "dense"
        if key not in refs:
            refs[key] = parallel_reference_a(name)
        ref = refs[key]
        gc = [torch.from_numpy(g) for g in card["grads"]]
        errs = {k: abs(card[k] - ref[k]) / max(abs(ref[k]), 1e-12)
                for k in ("loss", "grad_norm")}
        errs["grads"], worst = grads_rel_err(gc, ref["grads"], ref["names"])
        gap = param_gap(gc, ref["grads"],
                        [torch.from_numpy(t) for t in card["params"]],
                        ref["params"], 1e-4, 1e-8, ref["names"])
        emit({"phase": "parallel", "part": f"a: {name} base16 widths depth "
              "2 fp32, 2 ranks on the card vs one process on the CPU",
              "mesh": dict(zip(("dp", "tp", "ep", "zero", "sp"),
                               PARALLEL[name])),
              "card": {k: card[k] for k in ("loss", "grad_norm")},
              "cpu": {k: ref[k] for k in ("loss", "grad_norm")},
              "rel_err": errs, "grads_worst_leaf": worst, "params": gap,
              "tol": FP32_TOL})
        if not (max(errs.values()) <= FP32_TOL and gap["worst"] <= 1.0):
            raise AssertionError(f"parallel (a) {name}: {errs}, {gap}")


def parallel_b(ranks: list, refs: dict) -> dict:
    """(b): each full-width run against the single-process card step:
    the first step's loss and grad_norm within PARALLEL_TOL, the losses
    falling over the steps, launches exact in every rank; -> rank 0's
    launches summed over the runs."""
    launches = {}
    for name in ranks[0]["b"]:
        mine = [r["b"][name] for r in ranks]
        ref = refs[PARALLEL_REF[name]]
        errs = {k: abs(mine[0][key][0] - ref[key][0]) / abs(ref[key][0])
                for k, key in (("loss", "losses"),
                               ("grad_norm", "grad_norms"))}
        expect = parallel_expected(name, 1 + PARALLEL_STEPS)
        for r, m in enumerate(mine):
            expect_launches(f"parallel (b) {name} rank {r}", m["launches"],
                            expect)
        emit({"phase": "parallel", "part": f"b: {name} full width bf16 at "
              f"b{PARALLEL_B} global, 2 ranks sharing the card (gloo)",
              "card": smi(), "mesh": dict(zip(("dp", "tp", "ep", "zero",
                                              "sp"), PARALLEL[name])),
              "losses": mine[0]["losses"], "grad_norms": mine[0][
                  "grad_norms"], "one_process": {
                      "losses": ref["losses"], "grad_norms":
                      ref["grad_norms"]}, "rel_err": errs,
              "tol": PARALLEL_TOL,
              "step_ms_per_rank": [m["step_ms"] for m in mine],
              "step_ms_runs_rank0": mine[0]["ms"],
              "warmup_ms_per_rank": [m["warmup_ms"] for m in mine],
              "peak_memory_gb_per_rank": [m["peak_memory_gb"] for m in mine],
              "rank_params_m": [m["rank_params_m"] for m in mine],
              "one_process_step_ms": ref["step_ms"],
              "one_process_peak_memory_gb": ref["peak_memory_gb"],
              "launches_per_step_rank0": {
                  k: v // (1 + PARALLEL_STEPS)
                  for k, v in mine[0]["launches"].items() if v}})
        if max(errs.values()) > PARALLEL_TOL:
            raise AssertionError(f"parallel (b) {name}: {errs}")
        for m in mine:
            if not (np.isfinite(m["losses"]).all()
                    and m["losses"][-1] < m["losses"][0]):
                raise AssertionError(f"parallel (b) {name}: losses "
                                     f"{m['losses']}")
        launches = add_launches(launches, mine[0]["launches"])
    return launches


# (b)'s runs -> the single-process step each is held to
PARALLEL_REF = {"dp2": "dense", "zero1": "dense", "zero2": "dense",
                "zero3": "dense", "tp2_sp": "dense", "ep2": "ep2"}


def rank_shards(cfg, shape: dict, specs_of):
    """Rank 0's update leaves of ``cfg`` on a mesh of ``shape`` whose
    state specs are ``specs_of(state, cfg, mesh)`` (the moments' specs,
    ``Plan.update``): owned contiguous fp32 tensors of the shapes the
    rank's B12 launch reads, drawn on the card, and those shapes."""
    from vitx_torch.parallel import Mesh, sharded
    from vitx_torch.train.step import TrainState, make_optimizer, leaves

    from vitx_torch.nn.vit import param_spec

    def meta(spec):
        return {k: meta(v) if isinstance(v, dict) else
                torch.empty(v[0], device="meta") for k, v in spec.items()}
    mesh = Mesh(shape, 0, "cuda", "gloo")
    p = meta(param_spec(cfg))
    specs = specs_of(TrainState(0, p, make_optimizer().init(p)), cfg, mesh)
    plan = sharded.Plan(specs, mesh, p)
    shapes = []
    for t, spec in zip(leaves(p), plan.update):
        shape = list(t.shape)
        for d, a in sharded.spec_dims(spec).items():
            shape[d] //= mesh.size(a)
        shapes.append(tuple(shape))
    return [seeded(s, 300 + i, 0.02) for i, s in enumerate(shapes)], shapes


def parallel_shards(cfg):
    """Rank 0's ZeRO-1 update slices of ``cfg`` at dp 2 (``rank_shards``)."""
    from vitx_torch.parallel import sharded

    return rank_shards(cfg, {"data": 2, "model": 1},
                       lambda st, c, m: sharded.state_sharding(
                           st, c, m, zero1=True))


def pipeline_shards(cfg):
    """Stage 0's update leaves of ``cfg`` on (b)'s (1 data x 2 stage)
    mesh (``rank_shards``): its half of every stacked block leaf and the
    whole of each other leaf, as each rank of (b) updates them."""
    from vitx_torch.parallel import pipeline

    return rank_shards(cfg, {"data": 1, "stage": 2},
                       pipeline.pp_state_sharding)


def check_parallel_kernels(errs: dict) -> None:
    """(c): the kernels at a rank's shapes against their plain versions,
    fp32 (FP32_TOL) and bf16 (BF16_TOL), each twice bit for bit: K1 and K2
    with their stashes, B2 and B3 at a dp 2 rank's (64, 197, 768) and at
    an MAE rank's visible tokens (64, 50, 768); B12 over rank 0's ZeRO-1
    slices of base16 at dp 2 (fp32 and bf16 gradients)."""
    from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    for dtype in (torch.float32, torch.bfloat16):
        tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
        bf = dtype == torch.bfloat16
        for B, T, E, H in ((64, 197, 768, 12), (64, 50, 768, 12)):
            info = {"dtype": str(dtype), "shape": [B, T, E], "heads": H}
            x, mha, mlpw = block_inputs(B, T, E, H, 4 * E, dtype, 80 + T,
                                        "cuda")
            for kern, plain, w, key, extra in (
                    (fused_mha_block, mha_block_plain, mha,
                     "fused_mha_block", {}),
                    (fused_mlp_block, mlp_block_plain, mlpw,
                     "fused_mlp_block", {"act": "gelu_tanh"})):
                n90 = kern.launches_sm90
                out = kern(x, **w, **extra, stash=True)
                torch.cuda.synchronize()
                name = key + ("_sm90" if kern.launches_sm90 > n90 else "")
                check("parallel", f"{name} with its stash", out,
                      plain(x, **w, **extra, stash=True), tol,
                      errs if bf else None, name, **info)
                bitwise("parallel", f"{name} with its stash, twice",
                        kern(x, **w, **extra, stash=True), out, **info)
            del x, mha, mlpw, out
            check_backward_kernels(B, T, E, H, dtype, tol, errs, "parallel")
        torch.cuda.empty_cache()
    import vitx_torch

    ps, shapes = parallel_shards(vitx_torch.get_config("base16"))
    kw = dict(lr=1e-4, c1=0.1, c2=0.001, b1=0.9, b2=0.999, eps=1e-8,
              wd=1e-4)
    for gdt in (torch.float32, torch.bfloat16):
        gs = [seeded(s, 400 + i, 1e-3, dtype=gdt)
              for i, s in enumerate(shapes)]
        mus = [seeded(s, 500 + i, 1e-4) for i, s in enumerate(shapes)]
        nus = [seeded(s, 600 + i, 1e-6).abs() for i, s in enumerate(shapes)]
        hold_adamw_multi("parallel", "rank 0's ZeRO-1 slices of base16 at "
                         "dp 2", [p.clone() for p in ps], gs, mus, nus, kw,
                         errs, grad_dtype=str(gdt))
    torch.cuda.empty_cache()


def adamw_row(shards, launches: dict, errs: dict, of: str) -> dict:
    """B12's row over a rank's update leaves (``rank_shards``), fp32
    gradients from zero moments, torch.optim.AdamW(fused=True) on the same
    leaves the library call."""
    from vitx_torch.kernels import adamw_multi_plain, fused_adamw_multi_

    ps, shapes = shards
    gs = [seeded(s, 700 + i, 1e-3) for i, s in enumerate(shapes)]
    mus = [torch.zeros_like(t) for t in ps]
    nus = [torch.zeros_like(t) for t in ps]
    n = sum(t.numel() for t in ps)
    kw = dict(lr=1e-4, c1=0.1, c2=0.001, b1=0.9, b2=0.999, eps=1e-8,
              wd=1e-4)
    lib_opt = torch.optim.AdamW(
        [torch.nn.Parameter(t.clone()) for t in ps], lr=1e-4, eps=1e-8,
        weight_decay=1e-4, fused=True)
    for prm, g in zip(lib_opt.param_groups[0]["params"], gs):
        prm.grad = g
    return kernel_row(
        "fused_adamw_multi_",
        lambda: fused_adamw_multi_(ps, gs, mus, nus, **kw),
        lambda: adamw_multi_plain(ps, gs, mus, nus, **kw), lib_opt.step,
        15 * n, PEAK_FP32_FLOPS, 7 * 4 * n, launches, errs,
        leaves=len(ps), elements=n, of=of)


def parallel_kernel_shapes(launches: dict, errs: dict) -> dict:
    """A dp 2 rank's shapes as more ``shapes`` of the rows, bf16: K1's
    sm90 row with its stash at (64, 197, 768); B2's sm90 row at (64, 12,
    197, 64); B3's one-pass row at (64, 197, 768); B12 over rank 0's
    ZeRO-1 slices of base16 (torch.optim.AdamW(fused=True) on the same
    slices the library call)."""
    import vitx_torch
    from vitx_torch.kernels import fused_mha_block, mha_block_plain

    bf = torch.bfloat16
    eps = 1e-5
    B, T, E, H = 64, 197, 768, 12
    x, mha, _ = block_inputs(B, T, E, H, 4 * E, bf, 90, "cuda")
    rows = [kernel_row(
        "fused_mha_block_sm90",
        lambda: fused_mha_block(x, **mha, eps=eps, stash=True),
        lambda: mha_block_plain(x, **mha, eps=eps, stash=True),
        sdpa_mha(x, mha, H, eps),
        2 * B * T * E * 4 * E + 4 * B * H * T * T * (E // H),
        PEAK_BF16_FLOPS, 6 * B * T * E * 2 + 4 * E * E * 2 + 3 * E * 4
        + 2 * B * H * T * 4, launches, errs, shape=[B, T, E], heads=H,
        stash=True, of="a dp 2 rank's batch")]
    del x, mha
    rows += attention_bwd_rows((B, H, T, E // H), 91, launches, errs,
                               only="attention_bwd_sm90")
    rows += ln_bwd_rows((B, T, E), 92, eps, launches, errs,
                        only="ln_bwd_onepass")
    rows.append(adamw_row(parallel_shards(vitx_torch.get_config("base16")),
                          launches, errs, "rank 0's ZeRO-1 slices of base16 "
                          "at dp 2"))
    torch.cuda.empty_cache()
    extra: dict = {}
    for row in rows:
        extra.setdefault(row["name"], []).append(shape_entry(row))
    return extra


def parallel_nccl_rank(ctx) -> dict:
    """(d) in one rank with a card of its own (nccl, by the backend rule):
    one dp 1 sharded step of the depth-2 bf16 copy at b16."""
    from vitx_torch.parallel import make_mesh, sharded
    from vitx_torch.train.step import (create_train_state, leaves,
                                       make_optimizer)

    import torch.distributed as dist

    mesh = make_mesh(1, device="cuda")
    cfg = parallel_cfg("dp2", 2)
    opt = make_optimizer(lr=PARALLEL_LR, fused=True)
    whole = create_train_state(0, cfg, opt, device=mesh.device)
    specs = sharded.state_sharding(whole, cfg, mesh)
    state = sharded.place_state(whole, cfg, mesh, specs=specs)
    step = sharded.make_parallel_train_step(cfg, opt, mesh,
                                            state_shardings=specs)
    state, m = step(state, parallel_batch(16, 13, mesh.device))
    return {"backend": dist.get_backend(), "loss": float(m["loss"]),
            "grad_norm": float(m["grad_norm"]),
            "params": [t.cpu().numpy() for t in leaves(state.params)]}


def parallel_nccl() -> None:
    """(d): nccl with one rank, its step bit for bit the single-process
    step on the card (loss, grad_norm, every param)."""
    from vitx_torch.parallel import spawn
    from vitx_torch.train.step import (create_train_state, leaves,
                                       make_optimizer, train_step)

    got = spawn(parallel_nccl_rank, 1, device="cuda")[0]
    cfg = parallel_cfg("dp2", 2)
    opt = make_optimizer(lr=PARALLEL_LR, fused=True)
    state, m = train_step(create_train_state(0, cfg, opt),
                          parallel_batch(16, 13, "cuda"), cfg=cfg,
                          optimizer=opt)
    same = (got["loss"] == float(m["loss"])
            and got["grad_norm"] == float(m["grad_norm"])
            and all(np.array_equal(a, b.cpu().numpy())
                    for a, b in zip(got["params"], leaves(state.params))))
    emit({"phase": "parallel", "part": "d: nccl, one rank, a dp 1 step of "
          "the depth-2 bf16 copy at b16 against one process", "backend":
          got["backend"], "loss": got["loss"], "grad_norm":
          got["grad_norm"], "bit_for_bit": same})
    if got["backend"] != "nccl" or not same:
        raise AssertionError(f"parallel (d): backend {got['backend']}, "
                             f"bit for bit {same}")


DRYRUN_LOG = BUILD / "dryrun"   # (e)'s stdout and stderr, .out and .err


def start_dryrun():
    """(e)'s process: ``python -m vitx_torch.parallel.dryrun 4`` on the
    card (four ranks share it: gloo), its output into DRYRUN_LOG's files
    (a pipe could fill and stall it while the caller works)."""
    DRYRUN_LOG.parent.mkdir(parents=True, exist_ok=True)
    with open(f"{DRYRUN_LOG}.out", "w") as out, \
            open(f"{DRYRUN_LOG}.err", "w") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "vitx_torch.parallel.dryrun", "4"],
            stdout=out, stderr=err, text=True,
            cwd=str(Path(__file__).resolve().parent))


def parallel_dryrun(proc) -> str:
    """(e): the ``start_dryrun`` process ``proc`` to its end (it is
    killed past 600 s), its summary line, the pipeline's keys in it: GPipe
    and 1F1B on (2 data x 2 stage); pp x tp takes 8 ranks, so its loss is
    ``nan`` at 4, as vitx prints it."""
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stdout = Path(f"{DRYRUN_LOG}.out").read_text()
    stderr = Path(f"{DRYRUN_LOG}.err").read_text()
    print(stdout, end="", flush=True)
    line = stdout.strip().splitlines()[-1] if stdout.strip() else ""
    emit({"phase": "parallel", "part": "e: python -m "
          "vitx_torch.parallel.dryrun 4", "rc": proc.returncode,
          "summary": line})
    pp_keys = ("pp_loss=", "(pipeline 2 data x 2 stage; 1f1b_loss=",
               "pp_x_tp_1f1b_loss=nan at 2 data x 2 stage x 2 model")
    if proc.returncode != 0 or not line.startswith("dryrun_multichip ok") \
            or not all(k in line for k in pp_keys) \
            or "nan" in line.replace("pp_x_tp_1f1b_loss=nan", ""):
        raise AssertionError(f"parallel (e): rc {proc.returncode}\n"
                             f"{stderr[-4000:]}")
    return line


def phase_parallel(errs: dict) -> tuple:
    """Main path 14 (module docstring): data, ZeRO, tensor, sequence and
    expert parallelism. Returns (rank 0's launches of (b), the rank
    shapes' entries for the kernels line)."""
    from vitx_torch.parallel import spawn

    t0 = time.perf_counter()
    refs = {k: parallel_reference_b(k) for k in ("dense", "ep2")
            if k in PARALLEL_REF.values()}
    t_ref = time.perf_counter()
    ranks = spawn(parallel_rank, 2, (list(PARALLEL), list(PARALLEL)),
                  device="cuda")
    t_spawn = time.perf_counter()
    check_parallel_kernels(errs)
    extra = parallel_kernel_shapes({}, errs)      # (c): times kernels
    t_c = time.perf_counter()
    # (e) runs beside the parts that time nothing -- (a)'s and (b)'s
    # holding and (d) -- on the same card and host, which changes only
    # when each finishes
    dryrun = start_dryrun()
    try:
        emit({"phase": "parallel", "backend": ranks[0]["backend"],
              "card": smi(), "collectives_on_cuda_tensors":
              ranks[0]["collectives"]})
        parallel_a(ranks[0]["a"])
        launches = parallel_b(ranks, refs)
        del ranks
        t_b = time.perf_counter()
        parallel_nccl()
        t_d = time.perf_counter()
    except BaseException:
        dryrun.kill()
        dryrun.wait()
        raise
    parallel_dryrun(dryrun)
    emit({"phase": "parallel", "part": "seconds",
          "one_process_refs": t_ref - t0, "ranks_a_b": t_spawn - t_ref,
          "c": t_c - t_spawn, "held": t_b - t_c, "d": t_d - t_b,
          "e_after_d": time.perf_counter() - t_d})
    return launches, extra


# phase pipeline: (a)'s runs -> (dp, pp, tp, schedule), four ranks each
PIPELINE_A = {"gpipe": (2, 2, 1, "gpipe"), "1f1b": (2, 2, 1, "1f1b"),
              "pp2_tp2_1f1b": (1, 2, 2, "1f1b")}
PIPELINE_A_MICRO = 2    # (a): 2 microbatches of each data row's 4 rows
PIPELINE_SCHEDULES = ("gpipe", "1f1b")   # (b), on (1 data x 2 stage)
PIPELINE_MICRO = 4      # (b): microbatches of 32 of the global 128
PIPELINE_STEPS = 3      # (b)'s timed steps, after one warm-up
PIPELINE_SERVE_B = 8    # (d): the server's batch, 4 rows a rank
PIPELINE_GRAD_PREDICTED = 5e-6   # (a)'s predicted gradient bar (PERF.md)


class CapturedUpdate:
    """An optimizer that keeps the gradients its update receives (a
    rank's reduced gradients, in leaf order) and then updates as
    ``opt``."""

    def __init__(self, opt):
        self.opt, self.grads = opt, None

    def __getattr__(self, name):
        return getattr(self.opt, name)

    def update(self, grads, *args, **kw):
        self.grads = [g.detach().clone() for g in grads]
        return self.opt.update(grads, *args, **kw)


def pipeline_p2p_rank(ctx) -> dict:
    """Point-to-point on CUDA tensors over the group's backend, once:
    rank 0 sends 0..3, rank 1 receives; -> what arrived (rank 1)."""
    import torch.distributed as dist

    x = torch.arange(4, dtype=torch.float32, device=ctx.device)
    if ctx.rank == 0:
        dist.send(x, dst=1)
        torch.cuda.synchronize()
        return {"backend": ctx.backend}
    y = torch.zeros_like(x)
    dist.recv(y, src=0)
    torch.cuda.synchronize()
    return {"backend": ctx.backend, "equal": bool(torch.equal(x, y))}


def pipeline_p2p() -> dict:
    """The probe of the phase's start: ``dist.send``/``recv`` of a CUDA
    tensor between two ranks sharing the card, in ranks of its own (a
    failure there, an error or a dead rank, is the probe's answer, not
    the phase's); the handoff is a broadcast over the link's two-rank
    group (``comm.send_stage``) whatever this prints."""
    from vitx_torch.parallel import RankError, spawn

    try:
        got = spawn(pipeline_p2p_rank, 2, device="cuda", timeout=120)
        answer = "ok" if got[1]["equal"] else "wrong values"
    except RankError as e:
        lines = [s for s in str(e).splitlines() if s.strip()]
        answer = "error: " + (lines[-1] if lines else str(e))[:300]
    return answer


def pipeline_rank_a(ctx) -> dict:
    """(a) on one of four ranks: each PIPELINE_A run, one step of the
    depth-2 fp32 copy at base16's widths on (a)'s b8 -> (rank 0) its
    loss, grad_norm, reduced gradients and params after the step,
    gathered whole; every rank its B5 (flash_attention) launches."""
    from vitx_torch.parallel import pipeline, sharded
    from vitx_torch.train.step import TrainState, leaves, make_optimizer

    out = {}
    for name, (dp, pp, tp, schedule) in PIPELINE_A.items():
        mesh = pipeline.make_pp_mesh(dp, pp, tp, device=ctx.device)
        cfg = parallel_cfg("dp2", 2, "float32")
        params = parallel_params_a("dp2", mesh.device)
        opt = CapturedUpdate(make_optimizer(lr=1e-4))
        whole = TrainState(0, params, opt.init(params))
        specs = pipeline.pp_state_sharding(whole, cfg, mesh, tp=tp > 1)
        state = sharded.place_state(whole, cfg, mesh, specs=specs)
        step = pipeline.make_pp_train_step(
            cfg, opt, mesh, n_micro=PIPELINE_A_MICRO, state_shardings=specs,
            schedule=schedule)
        batch = sharded.shard_batch(parallel_batch(PARALLEL_A_B, 7,
                                                   mesh.device), mesh)
        reset_counts()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        b5 = counts()["flash_attention"]
        plan = sharded.Plan(specs, mesh, state.params)
        grads = [sharded.gather_part(g, s, mesh).cpu()
                 for g, s in zip(opt.grads, plan.param)]
        whole = sharded.gather_state(state, specs, mesh)
        out[name] = {"b5": b5, "held": step.held}
        if ctx.rank == 0:
            out[name].update(
                loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                grads=[g.numpy() for g in grads],
                params=[t.cpu().numpy() for t in leaves(whole.params)])
        del state, whole, grads
        torch.cuda.empty_cache()
    return out


def pipeline_a(ranks: list) -> None:
    """(a): each run's step on four card ranks against one process on the
    CPU: loss, grad_norm and every reduced gradient within FP32_TOL (the
    prediction, PIPELINE_GRAD_PREDICTED, reported beside), the params
    within param_gap's allowance; pp x tp's stages on B5 (local heads, T
    197 >= 128, D 64 >= 32: vitx's rule) in every rank."""
    ref = parallel_reference_a("dp2")
    for name, card in ranks[0].items():
        gc = [torch.from_numpy(g) for g in card["grads"]]
        errs = {k: abs(card[k] - ref[k]) / max(abs(ref[k]), 1e-12)
                for k in ("loss", "grad_norm")}
        errs["grads"], worst = grads_rel_err(gc, ref["grads"], ref["names"])
        gap = param_gap(gc, ref["grads"],
                        [torch.from_numpy(t) for t in card["params"]],
                        ref["params"], 1e-4, 1e-8, ref["names"])
        dp, pp, tp, schedule = PIPELINE_A[name]
        b5 = [r[name]["b5"] for r in ranks]
        emit({"phase": "pipeline", "part": f"a: {name} base16 widths depth "
              "2 fp32, 4 ranks on the card vs one process on the CPU",
              "mesh": {"dp": dp, "pp": pp, "tp": tp, "schedule": schedule,
                       "n_micro": PIPELINE_A_MICRO},
              "card": {k: card[k] for k in ("loss", "grad_norm")},
              "cpu": {k: ref[k] for k in ("loss", "grad_norm")},
              "rel_err": errs, "grads_worst_leaf": worst, "params": gap,
              "tol": FP32_TOL, "predicted_grads": PIPELINE_GRAD_PREDICTED,
              "b5_launches_per_rank": b5,
              "held_per_rank": [r[name]["held"] for r in ranks]})
        if not (max(errs.values()) <= FP32_TOL and gap["worst"] <= 1.0):
            raise AssertionError(f"pipeline (a) {name}: {errs}, {gap}")
        if tp > 1 and min(b5) == 0:
            raise AssertionError(f"pipeline (a) {name}: B5 launches {b5}")


def pipeline_expected(cfg, schedule: str, stage: int, steps: int) -> dict:
    """A (b) rank's launches over ``steps`` steps at (1 data x 2 stage),
    per the code's routing: its 6 blocks once a microbatch under grad (K1
    and K2 with their stashes: the stages keep fuse_mlp "auto"; B2; B3
    for LN1 and LN2), the last stage's head LayerNorms (B3) a
    microbatch, B12 once a step; 1F1B's forward slots on stage 0 run K1
    and K2 once more without their stashes (the last stage's forward is
    its backward slot's recompute)."""
    per = cfg.depth // 2 * PIPELINE_MICRO * steps
    fwd = per * (2 if schedule == "1f1b" and stage == 0 else 1)
    b3 = 2 * per + (stage == 1) * (head_lns(cfg) + int(cfg.final_norm)) \
        * PIPELINE_MICRO * steps
    return block_launches(cfg, fused_mha_block=fwd, fused_mlp_block=fwd,
                          attention_bwd=per, attention_bwd_sm90=per * sm90(
                              cfg), ln_bwd=b3, fused_adamw_multi_=steps)


def pipeline_rank_b(ctx) -> dict:
    """(b) on one of two ranks, (1 data x 2 stage): base16 bf16 at full
    width, b128 global in PIPELINE_MICRO microbatches, fused AdamW, each
    schedule one warm-up and PIPELINE_STEPS steps -> its losses and grad
    norms, step ms, peak memory, launches and held inputs."""
    from vitx_torch.parallel import comm, pipeline, sharded
    from vitx_torch.train.step import (create_train_state, leaves,
                                       make_optimizer)

    out = {"backend": None}
    for schedule in PIPELINE_SCHEDULES:
        mesh = pipeline.make_pp_mesh(1, 2, device=ctx.device)
        out["backend"] = mesh.backend
        cfg = parallel_cfg("dp2")
        opt = make_optimizer(lr=PARALLEL_LR, fused=True)
        whole = create_train_state(0, cfg, opt, device=mesh.device)
        specs = pipeline.pp_state_sharding(whole, cfg, mesh)
        state = sharded.place_state(whole, cfg, mesh, specs=specs)
        del whole
        torch.cuda.empty_cache()
        step = pipeline.make_pp_train_step(
            cfg, opt, mesh, n_micro=PIPELINE_MICRO, state_shardings=specs,
            schedule=schedule)
        batch = parallel_batch(PARALLEL_B, 11, mesh.device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, norms, ms = [], [], []
        for _ in range(1 + PIPELINE_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
            norms.append(float(m["grad_norm"]))
        out[schedule] = {
            "losses": losses, "grad_norms": norms, "warmup_ms": ms[0],
            "ms": ms[1:], "step_ms": statistics.median(ms[1:]),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts(), "held": step.held, "stage": mesh.coords[
                "stage"],
            "rank_params_m": sum(t.numel() for t in leaves(state.params))
            / 1e6}
        del state, batch, m
        torch.cuda.empty_cache()
    return out


def pipeline_b(ranks: list) -> dict:
    """(b): each schedule's first step against one process's step on the
    card (loss and grad_norm within PARALLEL_TOL), launches exact in each
    rank, the losses finite; -> both ranks' launches summed over the
    schedules."""
    from vitx_torch.train.step import (create_train_state, make_optimizer,
                                       train_step)

    cfg = parallel_cfg("dp2")
    opt = make_optimizer(lr=PARALLEL_LR, fused=True)
    state = create_train_state(0, cfg, opt)
    t = time.perf_counter()
    _, m = train_step(state, parallel_batch(PARALLEL_B, 11, "cuda"),
                      cfg=cfg, optimizer=opt)
    ref = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    one_ms = 1e3 * (time.perf_counter() - t)
    del state
    torch.cuda.empty_cache()
    launches = {}
    for schedule in PIPELINE_SCHEDULES:
        mine = [r[schedule] for r in ranks]
        errs = {k: abs(mine[0][key][0] - ref[k]) / abs(ref[k])
                for k, key in (("loss", "losses"),
                               ("grad_norm", "grad_norms"))}
        for r, got in enumerate(mine):
            expect_launches(f"pipeline (b) {schedule} rank {r}",
                            got["launches"], pipeline_expected(
                                cfg, schedule, got["stage"],
                                1 + PIPELINE_STEPS))
        emit({"phase": "pipeline", "part": f"b: {schedule} base16 full "
              f"width bf16 at b{PARALLEL_B} global, {PIPELINE_MICRO} "
              "microbatches, 1 data x 2 stage ranks sharing the card",
              "card": smi(), "backend": ranks[0]["backend"],
              "losses": mine[0]["losses"],
              "grad_norms": mine[0]["grad_norms"], "one_process": ref,
              "one_process_first_step_ms": one_ms, "rel_err": errs,
              "tol": PARALLEL_TOL,
              "step_ms_per_rank": [g["step_ms"] for g in mine],
              "step_ms_runs_per_rank": [g["ms"] for g in mine],
              "warmup_ms_per_rank": [g["warmup_ms"] for g in mine],
              "peak_memory_gb_per_rank": [g["peak_memory_gb"]
                                          for g in mine],
              "held_per_rank": [g["held"] for g in mine],
              "rank_params_m": [g["rank_params_m"] for g in mine],
              "launches_per_step_per_rank": [
                  {k: v // (1 + PIPELINE_STEPS) for k, v in
                   g["launches"].items() if v} for g in mine]})
        if max(errs.values()) > PARALLEL_TOL:
            raise AssertionError(f"pipeline (b) {schedule}: {errs}")
        for got in mine:
            if not np.isfinite(got["losses"]).all():
                raise AssertionError(f"pipeline (b) {schedule}: losses "
                                     f"{got['losses']}")
            launches = add_launches(launches, got["launches"])
    return launches


def check_pipeline_kernels(errs: dict) -> None:
    """(c): the kernels at the slice's shapes against their plain versions
    in bf16 (BF16_TOL), each twice bit for bit: K1 with and without its
    stash, K2 with its stash at a (b) microbatch's (32, 197, 768); B2 at
    (32, 12, 197, 64) and B3 at (32, 197, 768) (``check_backward_
    kernels``); B5 at pp x tp's local heads, (32, 6, 197, 64) in bf16
    and (a)'s (4, 6, 197, 64) in fp32 (FP32_TOL); B12 over stage 0's
    update leaves of (b) (``pipeline_shards``: 6 of the 12 blocks and the
    other leaves whole), fp32 and bf16 gradients."""
    from vitx_torch.kernels import (flash_attention,
                                    flash_attention_fwd_plain,
                                    fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    bf = torch.bfloat16
    B, T, E, H = 32, 197, 768, 12
    info = {"dtype": str(bf), "shape": [B, T, E], "heads": H}
    x, mha, mlpw = block_inputs(B, T, E, H, 4 * E, bf, 120, "cuda")
    for kern, plain, w, key, extra, stash in (
            (fused_mha_block, mha_block_plain, mha, "fused_mha_block", {},
             True),
            (fused_mha_block, mha_block_plain, mha, "fused_mha_block", {},
             False),
            (fused_mlp_block, mlp_block_plain, mlpw, "fused_mlp_block",
             {"act": "gelu_tanh"}, True)):
        n90 = kern.launches_sm90
        out = kern(x, **w, **extra, stash=stash)
        torch.cuda.synchronize()
        name = key + ("_sm90" if kern.launches_sm90 > n90 else "")
        what = f"{name} {'with' if stash else 'without'} its stash"
        check("pipeline", what, out, plain(x, **w, **extra, stash=stash),
              BF16_TOL, errs, name, **info)
        bitwise("pipeline", f"{what}, twice",
                kern(x, **w, **extra, stash=stash), out, **info)
    del x, mha, mlpw, out
    check_backward_kernels(B, T, E, H, bf, BF16_TOL, errs, "pipeline")
    for shape, dtype, tol in (((32, 6, 197, 64), bf, BF16_TOL),
                              ((4, 6, 197, 64), torch.float32, FP32_TOL)):
        q, k, v = (seeded(shape, s, 1.5, dtype=dtype) for s in (121, 122,
                                                                 123))
        n90 = flash_attention.launches_sm90
        o = flash_attention(q, k, v)
        torch.cuda.synchronize()
        name = ("flash_attention_sm90" if flash_attention.launches_sm90
                > n90 else "flash_attention")
        info = {"dtype": str(dtype), "shape": list(shape)}
        check("pipeline", f"{name}, pp x tp's local heads", o,
              flash_attention_fwd_plain(q, k, v), tol,
              errs if dtype == bf else None, name, **info)
        bitwise("pipeline", f"{name}, twice", flash_attention(q, k, v), o,
                **info)
    del q, k, v, o
    ps, shapes = pipeline_shards(parallel_cfg("dp2"))
    kw = dict(lr=1e-4, c1=0.1, c2=0.001, b1=0.9, b2=0.999, eps=1e-8,
              wd=1e-4)
    for gdt in (torch.float32, torch.bfloat16):
        gs = [seeded(s, 400 + i, 1e-3, dtype=gdt)
              for i, s in enumerate(shapes)]
        mus = [seeded(s, 500 + i, 1e-4) for i, s in enumerate(shapes)]
        nus = [seeded(s, 600 + i, 1e-6).abs() for i, s in enumerate(shapes)]
        hold_adamw_multi("pipeline", "stage 0's leaves of base16 at pp 2",
                         [p.clone() for p in ps], gs, mus, nus, kw, errs,
                         grad_dtype=str(gdt))
    del ps, gs, mus, nus
    torch.cuda.empty_cache()


def pipeline_kernel_shapes(launches: dict, errs: dict) -> dict:
    """(c)'s shapes as more ``shapes`` of the rows, bf16: K1's sm90 row
    with and without its stash and K2's with its stash at (32, 197,
    768); B2's sm90 row at (32, 12, 197, 64); B3's one-pass row at (32,
    197, 768); B5's sm90 row at pp x tp's (32, 6, 197, 64); B12 over
    stage 0's update leaves of (b) (torch.optim.AdamW(fused=True) on the
    same leaves the library call)."""
    import torch.nn.functional as F

    from vitx_torch.kernels import (flash_attention,
                                    flash_attention_fwd_plain,
                                    fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    bf = torch.bfloat16
    eps = 1e-5
    B, T, E, H = 32, 197, 768, 12
    M = 4 * E
    of = "a pipeline microbatch of base16 b128 in 4"
    x, mha, mlpw = block_inputs(B, T, E, H, M, bf, 124, "cuda")
    rows = []
    for stash in (True, False):
        rows.append(kernel_row(
            "fused_mha_block_sm90",
            lambda s=stash: fused_mha_block(x, **mha, eps=eps, stash=s),
            lambda s=stash: mha_block_plain(x, **mha, eps=eps, stash=s),
            sdpa_mha(x, mha, H, eps),
            2 * B * T * E * 4 * E + 4 * B * H * T * T * (E // H),
            PEAK_BF16_FLOPS, 6 * B * T * E * 2 + 4 * E * E * 2 + 3 * E * 4
            + (2 * B * H * T * 4 if stash else 0), launches, errs,
            shape=[B, T, E], heads=H, stash=stash, of=of))

    w1t, w2t = (mlpw[k].t().contiguous() for k in ("w1", "w2"))

    def mlp_lib():
        h = F.layer_norm(x, (E,), mlpw["g"].to(bf), mlpw["b"].to(bf), eps)
        h = F.gelu(F.linear(h, w1t, mlpw["b1"].to(bf)), approximate="tanh")
        return F.linear(h, w2t, mlpw["b2"].to(bf))
    rows.append(kernel_row(
        "fused_mlp_block_sm90",
        lambda: fused_mlp_block(x, **mlpw, act="gelu_tanh", eps=eps,
                                stash=True),
        lambda: mlp_block_plain(x, **mlpw, act="gelu_tanh", eps=eps,
                                stash=True),
        mlp_lib, 4 * B * T * E * M, PEAK_BF16_FLOPS,
        2 * B * T * E * 2 + 2 * E * M * 2 + B * T * M * 2 + (M + 3 * E) * 4,
        launches, errs, shape=[B, T, E], M=M, stash=True, of=of))
    del x, mha, mlpw, w1t, w2t
    rows += attention_bwd_rows((B, H, T, E // H), 125, launches, errs,
                               only="attention_bwd_sm90")
    rows += ln_bwd_rows((B, T, E), 126, eps, launches, errs,
                        only="ln_bwd_onepass")
    shape = (B, H // 2, T, E // H)
    q, k, v = (seeded(shape, s, 1.5, dtype=bf) for s in (127, 128, 129))
    Bq, Hq, Tq, Dq = shape
    rows.append(kernel_row(
        "flash_attention_sm90", lambda: flash_attention(q, k, v),
        lambda: flash_attention_fwd_plain(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v),
        4 * Bq * Hq * Tq * Tq * Dq, PEAK_BF16_FLOPS,
        4 * Bq * Hq * Tq * Dq * 2, launches, errs, shape=list(shape),
        of="a pp x tp rank's local heads"))
    del q, k, v
    rows.append(adamw_row(pipeline_shards(parallel_cfg("dp2")), launches,
                          errs, "stage 0's leaves of base16 at pp 2"))
    torch.cuda.empty_cache()
    extra: dict = {}
    for row in rows:
        extra.setdefault(row["name"], []).append(shape_entry(row))
    return extra


def pipeline_serve() -> dict:
    """(d): ``python -m vitx_torch.cli.serve --preset base16 --dp 2`` on
    the card (two ranks share it: gloo) answers a few requests over HTTP
    with the top-1 of a direct forward of the same images in one
    process; SIGINT stops the server and its rank."""
    import io
    import signal
    import urllib.request

    from vitx_torch.nn.vit import forward, init_params

    import vitx_torch

    cfg = vitx_torch.get_config("base16")
    env_path = str(Path(__file__).resolve().parent)
    imgs = np.random.default_rng(31).standard_normal(
        (6, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "vitx_torch.cli.serve", "--preset", "base16",
         "--dp", "2", "--port", "0", "--batch-size",
         str(PIPELINE_SERVE_B)], cwd=env_path, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port, banner = None, ""
        for line in proc.stdout:
            if line.startswith("serving"):
                banner = line.strip()
                port = int(line.split(":")[2].split()[0])
                break
        if port is None:
            raise AssertionError(f"pipeline (d): no server\n"
                                 f"{proc.stderr.read()[-4000:]}")
        t_up = time.perf_counter() - t0
        answers = []
        for im in imgs:
            buf = io.BytesIO()
            np.save(buf, im)
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/predict", data=buf.getvalue(),
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                answers.append(json.loads(r.read()))
        proc.send_signal(signal.SIGINT)
        _, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    params = init_params(0, cfg)
    direct = forward(params, torch.from_numpy(imgs).to(cfg.cdtype()),
                     cfg).argmax(dim=-1).tolist()
    got = [a["classes"][0] for a in answers]
    emit({"phase": "pipeline", "part": "d: python -m vitx_torch.cli.serve "
          f"--preset base16 --dp 2 (batch {PIPELINE_SERVE_B})",
          "banner": banner, "rc": proc.returncode, "top1": got,
          "direct_top1": direct, "startup_s": t_up})
    if proc.returncode != 0 or got != direct:
        raise AssertionError(f"pipeline (d): rc {proc.returncode}, top-1 "
                             f"{got} vs {direct}\n{err[-4000:]}")
    return {"startup_s": t_up}


def phase_pipeline(errs: dict) -> tuple:
    """Main path 15 (module docstring): pipeline parallelism, GPipe and
    1F1B, and serving over a data mesh. Returns (both (b) ranks'
    launches, (c)'s shape entries for the kernels line)."""
    from vitx_torch.parallel import spawn

    t0 = time.perf_counter()
    p2p = pipeline_p2p()
    t_probe = time.perf_counter()
    emit({"phase": "pipeline", "p2p_on_cuda_tensors": p2p,
          "handoff_rule": "every backend: broadcast over the link's "
          "two-rank group (comm.send_stage)"})
    ranks_a = spawn(pipeline_rank_a, 4, device="cuda")
    pipeline_a(ranks_a)
    del ranks_a
    t_a = time.perf_counter()
    ranks_b = spawn(pipeline_rank_b, 2, device="cuda")
    launches = pipeline_b(ranks_b)
    del ranks_b
    t_b = time.perf_counter()
    check_pipeline_kernels(errs)
    extra = pipeline_kernel_shapes({}, errs)
    t_c = time.perf_counter()
    pipeline_serve()
    emit({"phase": "pipeline", "part": "seconds", "probe": t_probe - t0,
          "a": t_a - t_probe, "b": t_b - t_a, "c": t_c - t_b,
          "d": time.perf_counter() - t_c})
    return launches, extra


# phase compose: the runs of (a) -> ((dp, tp, ep, ZeRO stage, sp), the
# ranks, the model as parallel_cfg names it, the config's overrides): the
# merging encoder on a model axis by its split route and over gathered
# weights (B8, K2), and fused halves under sp and under tp x ep
COMPOSE = {
    "tp2_tome": ((1, 2, 1, 0, False), 2, "dp2",
                 dict(tome_r=13, tome_train=True)),
    "tp2_tome_fused": ((1, 2, 1, 0, False), 2, "dp2",
                       dict(tome_r=13, tome_train=True, fuse_mha="on",
                            fuse_mlp="on")),
    "tp2_sp_fused": ((1, 2, 1, 0, True), 2, "dp2",
                     dict(fuse_mha="on", fuse_mlp="on")),
    "tp2_ep2_fused": ((1, 2, 2, 0, False), 4, "ep2", dict(fuse_mha="on")),
}
# (b)'s runs at full width in bf16: name -> (the (a) run whose mesh and
# model it takes, "eval" or "train", the global batch, the overrides)
COMPOSE_B = {
    "tome_eval_split": ("tp2_tome", "eval", 64, dict(tome_r=13)),
    "tome_eval_gathered": ("tp2_tome", "eval", 64,
                           dict(tome_r=13, fuse_mha="on", fuse_mlp="on")),
    "tome_train_gathered": ("tp2_tome", "train", 32,
                            dict(tome_r=13, tome_train=True,
                                 fuse_mha="on")),
    "tp2_sp_fused": ("tp2_sp_fused", "train", 32,
                     dict(fuse_mha="on", fuse_mlp="on")),
    "tp2_ep2_fused": ("tp2_ep2_fused", "train", 32, dict(fuse_mha="on")),
}
COMPOSE_STEPS = 3       # (b)'s timed calls, after one warm-up


def compose_rank(ctx, a_cases, b_runs) -> dict:
    """Phase compose's (a) and (b) on one rank of those sharing the card
    (gloo): (a) each run's reduced gradients, loss, grad_norm and params
    after one step, gathered whole (rank 0); (b) each run's losses (and
    grad norms), call times, peak memory, the launches counted in this
    rank over its calls, and under ToMe the partition of the tokens its
    eval batch merged into (every rank's, to compare)."""
    from vitx_torch.nn.tome import encode_tome
    from vitx_torch.parallel import make_mesh, sharded
    from vitx_torch.train.step import (create_train_state, gradients,
                                       leaves, loss_fn, make_optimizer,
                                       trainable_params)

    out = {"a": {}, "b": {}, "backend": ctx.backend}
    for name in a_cases:
        flags, _, model, over = COMPOSE[name]
        mesh = make_mesh(*flags[:3], device=ctx.device)
        opt = make_optimizer(lr=1e-4)
        cfg, state, specs, gspecs, step = parallel_setup(
            flags, mesh, parallel_params_a(model, mesh.device), opt,
            parallel_cfg(model, 2, "float32").replace(**over))
        batch = sharded.shard_batch(parallel_batch(PARALLEL_A_B, 7,
                                                   mesh.device), mesh)
        plan = sharded.Plan(specs, mesh, state.params, gspecs)
        p, wrt = trainable_params(state.params)
        loss_v, _ = loss_fn(sharded.forward_params(p, specs.params, mesh),
                            batch, cfg, mesh=mesh)
        grads, gs = plan.reduce(gradients(loss_v, p, wrt), wrt, final=False)
        grads = [sharded.gather_part(g, s, mesh).cpu()
                 for g, s in zip(grads, gs)]
        state, m = step(state, batch)
        whole = sharded.gather_state(state, specs, mesh)
        if ctx.rank == 0:
            out["a"][name] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "grads": [g.numpy() for g in grads],
                "params": [t.cpu().numpy() for t in leaves(whole.params)]}
        del state, whole, grads, p, loss_v
        torch.cuda.empty_cache()
    for name in b_runs:
        case, kind, B, over = COMPOSE_B[name]
        flags, _, model, _ = COMPOSE[case]
        dp, tp, ep, _, sp = flags
        mesh = make_mesh(dp, tp, ep, device=ctx.device)
        opt = make_optimizer(lr=PARALLEL_LR, fused=True)
        base = parallel_cfg(model).replace(**over)
        whole = create_train_state(0, base, opt, device=mesh.device)
        cfg, state, specs, _, step = parallel_setup(flags, mesh,
                                                    whole.params, opt, base)
        del whole
        torch.cuda.empty_cache()
        batch = sharded.shard_batch(parallel_batch(B, 17, mesh.device), mesh)
        if kind == "eval":
            evaluate = sharded.make_parallel_eval_step(
                cfg, mesh, tp=tp > 1, sp=sp, ep=ep > 1,
                param_specs=specs.params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, norms, ms = [], [], []
        for _ in range(1 + COMPOSE_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if kind == "eval":
                _, loss = evaluate(state.params, batch)
            else:
                state, m = step(state, batch)
                loss = m["loss"]
                norms.append(float(m["grad_norm"]))
            losses.append(float(loss))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
        got = {"losses": losses, "grad_norms": norms, "warmup_ms": ms[0],
               "ms": ms[1:], "call_ms": statistics.median(ms[1:]),
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": counts(),
               "rank_params_m": sum(t.numel() for t in leaves(state.params))
               / 1e6}
        if kind == "eval":
            with torch.no_grad():
                _, src = encode_tome(
                    sharded.forward_params(state.params, specs.params, mesh),
                    batch["image"], cfg, return_sources=True, mesh=mesh)
            got["sources"] = src.to(torch.uint8).cpu().numpy()
        out["b"][name] = got
        del state, batch
        torch.cuda.empty_cache()
    return out


def compose_reference_b(name: str) -> dict:
    """(b)'s one-process run on the card at the global batch: its losses
    (and grad norms) over one warm-up and COMPOSE_STEPS calls, the median
    call time after the warm-up, its peak memory."""
    from vitx_torch.train.step import (create_train_state, eval_step,
                                       make_optimizer, train_step)

    case, kind, B, over = COMPOSE_B[name]
    cfg = parallel_cfg(COMPOSE[case][2]).replace(**over)
    opt = make_optimizer(lr=PARALLEL_LR, fused=True)
    state = create_train_state(0, cfg, opt)
    batch = parallel_batch(B, 17, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, ms = [], [], []
    for _ in range(1 + COMPOSE_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        if kind == "eval":
            _, loss = eval_step(state.params, batch, cfg=cfg)
        else:
            state, m = train_step(state, batch, cfg=cfg, optimizer=opt)
            loss = m["loss"]
            norms.append(float(m["grad_norm"]))
        losses.append(float(loss))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    out = {"losses": losses, "grad_norms": norms,
           "call_ms": statistics.median(ms[1:]),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state, batch
    torch.cuda.empty_cache()
    return out


def compose_a(got: dict) -> None:
    """(a): each depth-2 fp32 run on the card ranks against one process
    on the CPU from the same weights: loss, grad_norm and every gradient
    within FP32_TOL, the params within ``param_gap``'s allowance. The
    fused runs are the same function as the split ones: their reference
    is the CPU's step of the config without the fusions."""
    refs = {}
    for name, card in got.items():
        flags, world, model, over = COMPOSE[name]
        key = (model, over.get("tome_r", 0))
        if key not in refs:
            refs[key] = parallel_reference_a(
                model, **{k: v for k, v in over.items()
                          if k.startswith("tome")})
        ref = refs[key]
        gc = [torch.from_numpy(g) for g in card["grads"]]
        errs = {k: abs(card[k] - ref[k]) / max(abs(ref[k]), 1e-12)
                for k in ("loss", "grad_norm")}
        errs["grads"], worst = grads_rel_err(gc, ref["grads"], ref["names"])
        gap = param_gap(gc, ref["grads"],
                        [torch.from_numpy(t) for t in card["params"]],
                        ref["params"], 1e-4, 1e-8, ref["names"])
        emit({"phase": "compose", "part": f"a: {name} base16 widths depth "
              f"2 fp32, {world} ranks on the card vs one process on the "
              "CPU", "mesh": dict(zip(("dp", "tp", "ep", "zero", "sp"),
                                      flags)), "config": over,
              "card": {k: card[k] for k in ("loss", "grad_norm")},
              "cpu": {k: ref[k] for k in ("loss", "grad_norm")},
              "rel_err": errs, "grads_worst_leaf": worst, "params": gap,
              "tol": FP32_TOL})
        if not (max(errs.values()) <= FP32_TOL and gap["worst"] <= 1.0):
            raise AssertionError(f"compose (a) {name}: {errs}, {gap}")


def compose_expected(name: str, calls: int) -> dict:
    """A (b) rank's launches over ``calls`` calls, per the code's routing
    (base16's 12 blocks; every block's attention at D 64 in bf16, so B8's
    and K1's on the sm90 GEMM and attention, B2's on its sm90 kernel):

    - ToMe eval, split: none (``composed_tome`` and the MLP's products
      split over the heads and columns, vitx's XLA route);
    - ToMe eval, gathered: B8 and K2 once a block;
    - ToMe train, gathered attention: B8 once a block (its backward
      differentiates ``composed_tome``), B3 for LN1 in that backward and
      LN2 of the split MLP, the head's LayerNorm, B12 once;
    - tp2 + sp, both halves gathered: K1 and K2 with their stashes and B2
      once a block, B3 for both LayerNorms, the head's, B12 once;
    - tp2 x ep2, attention gathered: the single-process step's K1 12, B2
      12, B3 25 (the MLP halves split or Soft-MoE), B12 once."""
    case, kind, _, over = COMPOSE_B[name]
    cfg = parallel_cfg(COMPOSE[case][2]).replace(**over)
    n = cfg.depth * calls
    b3 = (2 * cfg.depth + head_lns(cfg) + int(cfg.final_norm)) * calls
    if name == "tome_eval_split":
        return launches_of()
    if name == "tome_eval_gathered":
        return block_launches(cfg, fused_mha_block_tome=n, fused_mlp_block=n)
    if name == "tome_train_gathered":
        return block_launches(cfg, fused_mha_block_tome=n, ln_bwd=b3,
                              fused_adamw_multi_=calls)
    if name == "tp2_sp_fused":
        return block_launches(cfg, fused_mha_block=n, fused_mlp_block=n,
                              attention_bwd=n,
                              attention_bwd_sm90=n * sm90(cfg), ln_bwd=b3,
                              fused_adamw_multi_=calls)
    return expected_train_launches(cfg, calls, calls)


def compose_b(ranks: list, refs: dict) -> dict:
    """(b): each full-width run's first loss (and grad_norm) within
    PARALLEL_TOL of one process's on the card, the losses finite, the
    launches exact in every rank, under ToMe the merges bit for bit the
    same on every rank; -> every rank's launches summed over the runs."""
    launches = {}
    for name in ranks[0]["b"]:
        mine = [r["b"][name] for r in ranks]
        ref = refs[name]
        case, kind, B, over = COMPOSE_B[name]
        keys = [("loss", "losses")] + ([("grad_norm", "grad_norms")]
                                       if kind == "train" else [])
        errs = {k: abs(mine[0][key][0] - ref[key][0]) / abs(ref[key][0])
                for k, key in keys}
        expect = compose_expected(name, 1 + COMPOSE_STEPS)
        for r, m in enumerate(mine):
            expect_launches(f"compose (b) {name} rank {r}", m["launches"],
                            expect)
        same = None
        if "sources" in mine[0]:
            same = all(np.array_equal(m["sources"], mine[0]["sources"])
                       for m in mine)
        flags = COMPOSE[case][0]
        emit({"phase": "compose", "part": f"b: {name} full width bf16 at "
              f"b{B} global, {len(mine)} ranks sharing the card (gloo)",
              "card": smi(), "kind": kind, "config": over,
              "mesh": dict(zip(("dp", "tp", "ep", "zero", "sp"), flags)),
              "losses": mine[0]["losses"],
              "grad_norms": mine[0]["grad_norms"],
              "one_process": {k: ref[k] for k in ("losses", "grad_norms")},
              "rel_err": errs, "tol": PARALLEL_TOL,
              "merges_equal_on_every_rank": same,
              "note": "shared card, not scaling",
              "call_ms_per_rank": [m["call_ms"] for m in mine],
              "call_ms_runs_per_rank": [m["ms"] for m in mine],
              "warmup_ms_per_rank": [m["warmup_ms"] for m in mine],
              "peak_memory_gb_per_rank": [m["peak_memory_gb"]
                                          for m in mine],
              "rank_params_m": [m["rank_params_m"] for m in mine],
              "one_process_call_ms": ref["call_ms"],
              "one_process_peak_memory_gb": ref["peak_memory_gb"],
              "launches_per_call_per_rank": [
                  {k: v // (1 + COMPOSE_STEPS) for k, v in
                   m["launches"].items() if v} for m in mine]})
        if max(errs.values()) > PARALLEL_TOL:
            raise AssertionError(f"compose (b) {name}: {errs}")
        if same is False:
            raise AssertionError(f"compose (b) {name}: the ranks merged "
                                 "differently")
        for m in mine:
            if not np.isfinite(m["losses"] + m["grad_norms"]).all():
                raise AssertionError(f"compose (b) {name}: losses "
                                     f"{m['losses']}")
            launches = add_launches(launches, m["launches"])
    return launches


COMPOSE_TOME_T = (184, 54)   # B8's first and last merged lengths at r=13


def check_compose_kernels(errs: dict) -> None:
    """(c): the kernels of the gathered routes at a rank's shapes against
    their plain versions in bf16 (BF16_TOL), each twice bit for bit: B8
    at the r=13 encoder's merged lengths (32, 184, 768) and (32, 54,
    768) (a random QKV bias and log_size, ``tome_inputs``), K1 and K2
    with their stashes at a tp + sp rank's gathered (32, 197, 768)."""
    from vitx_torch.kernels import (fused_mha_block, fused_mha_block_tome,
                                    fused_mlp_block, mha_block_plain,
                                    mha_block_tome_plain, mlp_block_plain)

    bf = torch.bfloat16
    B, E, H = 32, 768, 12
    for T in COMPOSE_TOME_T:
        info = {"dtype": str(bf), "shape": [B, T, E], "heads": H}
        x, tm = tome_inputs(B, T, E, H, bf, 140 + T)
        n90 = fused_mha_block_tome.launches_attn_sm90
        out = fused_mha_block_tome(x, **tm)
        torch.cuda.synchronize()
        if fused_mha_block_tome.launches_attn_sm90 != n90 + 1:
            raise AssertionError(f"compose (c) B8 {info}: not on the sm90 "
                                 "attention")
        check("compose", "fused_mha_block_tome_sm90 (out, k_mean) at a "
              "merged length", out, mha_block_tome_plain(x, **tm),
              BF16_TOL, errs, "fused_mha_block_tome_sm90", **info)
        bitwise("compose", "fused_mha_block_tome_sm90, twice",
                fused_mha_block_tome(x, **tm), out, **info)
        del x, tm, out
    T = 197
    info = {"dtype": str(bf), "shape": [B, T, E], "heads": H}
    x, mha, mlpw = block_inputs(B, T, E, H, 4 * E, bf, 150, "cuda")
    for kern, plain, w, key, extra in (
            (fused_mha_block, mha_block_plain, mha, "fused_mha_block", {}),
            (fused_mlp_block, mlp_block_plain, mlpw, "fused_mlp_block",
             {"act": "gelu_tanh"})):
        n90 = kern.launches_sm90
        out = kern(x, **w, **extra, stash=True)
        torch.cuda.synchronize()
        name = key + ("_sm90" if kern.launches_sm90 > n90 else "")
        check("compose", f"{name} with its stash", out,
              plain(x, **w, **extra, stash=True), BF16_TOL, errs, name,
              **info)
        bitwise("compose", f"{name} with its stash, twice",
                kern(x, **w, **extra, stash=True), out, **info)
    del x, mha, mlpw, out
    torch.cuda.empty_cache()


def compose_kernel_shapes(launches: dict, errs: dict) -> dict:
    """(c)'s shapes as more ``shapes`` of the rows, bf16: B8's two rows
    (``tome_rows_at``) at (32, 184, 768) and (32, 54, 768); K1's sm90 row
    with its stash and K2's with its stash at (32, 197, 768)."""
    import torch.nn.functional as F

    from vitx_torch.kernels import (fused_mha_block, fused_mlp_block,
                                    mha_block_plain, mlp_block_plain)

    c = parallel_cfg("dp2")
    rows = []
    for T in COMPOSE_TOME_T:
        rows += tome_rows_at(c, 32, T, launches, errs)
    bf = torch.bfloat16
    eps = 1e-5
    B, T, E, H = 32, 197, 768, 12
    M = 4 * E
    of = "a tp 2 + sp rank's gathered half of base16 b32"
    x, mha, mlpw = block_inputs(B, T, E, H, M, bf, 151, "cuda")
    rows.append(kernel_row(
        "fused_mha_block_sm90",
        lambda: fused_mha_block(x, **mha, eps=eps, stash=True),
        lambda: mha_block_plain(x, **mha, eps=eps, stash=True),
        sdpa_mha(x, mha, H, eps),
        2 * B * T * E * 4 * E + 4 * B * H * T * T * (E // H),
        PEAK_BF16_FLOPS, 6 * B * T * E * 2 + 4 * E * E * 2 + 3 * E * 4
        + 2 * B * H * T * 4, launches, errs, shape=[B, T, E], heads=H,
        stash=True, of=of))
    w1t, w2t = (mlpw[k].t().contiguous() for k in ("w1", "w2"))

    def mlp_lib():
        h = F.layer_norm(x, (E,), mlpw["g"].to(bf), mlpw["b"].to(bf), eps)
        h = F.gelu(F.linear(h, w1t, mlpw["b1"].to(bf)), approximate="tanh")
        return F.linear(h, w2t, mlpw["b2"].to(bf))
    rows.append(kernel_row(
        "fused_mlp_block_sm90",
        lambda: fused_mlp_block(x, **mlpw, act="gelu_tanh", eps=eps,
                                stash=True),
        lambda: mlp_block_plain(x, **mlpw, act="gelu_tanh", eps=eps,
                                stash=True),
        mlp_lib, 4 * B * T * E * M, PEAK_BF16_FLOPS,
        2 * B * T * E * 2 + 2 * E * M * 2 + B * T * M * 2 + (M + 3 * E) * 4,
        launches, errs, shape=[B, T, E], M=M, stash=True, of=of))
    del x, mha, mlpw, w1t, w2t
    torch.cuda.empty_cache()
    extra: dict = {}
    for row in rows:
        extra.setdefault(row["name"], []).append(shape_entry(row))
    return extra


def phase_compose(errs: dict) -> tuple:
    """Main path 16 (module docstring): the last compositions, ToMe's
    merging encoder on a tensor-parallel mesh and fused blocks under
    sequence and expert parallelism. Returns (every rank's launches of
    (b), (c)'s shape entries for the kernels line)."""
    from vitx_torch.parallel import spawn

    t0 = time.perf_counter()
    refs = {name: compose_reference_b(name) for name in COMPOSE_B}
    t_ref = time.perf_counter()
    ranks = {}
    for world in sorted({w for _, w, _, _ in COMPOSE.values()}):
        a = [n for n, (_, w, _, _) in COMPOSE.items() if w == world]
        b = [n for n, (case, *_) in COMPOSE_B.items()
             if COMPOSE[case][1] == world]
        ranks[world] = spawn(compose_rank, world, (a, b), device="cuda")
    t_spawn = time.perf_counter()
    emit({"phase": "compose", "backend": ranks[2][0]["backend"],
          "card": smi()})
    compose_a({k: v for r in ranks.values() for k, v in r[0]["a"].items()})
    t_a = time.perf_counter()
    launches = add_launches(*(compose_b(r, refs) for r in ranks.values()))
    del ranks
    t_b = time.perf_counter()
    check_compose_kernels(errs)
    extra = compose_kernel_shapes({}, errs)
    emit({"phase": "compose", "part": "seconds",
          "one_process_refs": t_ref - t0, "ranks_a_b": t_spawn - t_ref,
          "a": t_a - t_spawn, "b": t_b - t_a,
          "c": time.perf_counter() - t_b})
    return launches, extra


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of " + ",".join(PHASES))
    args = p.parse_args(argv)
    phases = args.phases.split(",")
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an H100")
    import vitx_torch                   # fails outside a checkout
    from vitx_torch.nn.vit import init_params

    t_start = time.perf_counter()

    def lap(name: str) -> None:
        """The script's clock when phase ``name`` ended: the phases' costs
        are the differences."""
        if name in phases:
            emit({"phase": name, "ended_at_s": time.perf_counter() - t_start})

    phase_device()

    if "build" in phases:
        phase_build()
    lap("build")
    errs: dict = {}
    if "kernels" in phases:
        phase_kernels(errs)
    lap("kernels")
    if "grad" in phases:
        phase_grad(errs)
    lap("grad")
    cfg = vitx_torch.get_config("base16")
    params = None
    if {"forward", "serve", "tome", "artifacts", "times"} & set(phases):
        params = init_params(0, cfg)
    if "forward" in phases:
        phase_forward(cfg, params)
    lap("forward")
    serve_launches, train_launches, explain_launches = {}, {}, {}
    tome_launches, finetune_launches, transfer_launches = {}, {}, {}
    recipe_launches = {path: {} for path in RECIPE_PATHS}
    train = finetune = transfer = None
    if "serve" in phases:
        serve_launches = phase_serve(cfg, params)
    lap("serve")
    if "train" in phases:
        from vitx_torch.data import SyntheticDataset

        ds = SyntheticDataset(num_examples=128, image_size=cfg.image_size,
                              num_classes=cfg.num_classes, seed=0)
        train_launches, *train = phase_train(ds)
    lap("train")
    large = large_params = None
    if {"explain", "tome"} & set(phases):
        large = vitx_torch.get_config("large16_384")
        large_params = init_params(0, large)
    if "explain" in phases:
        explain_launches = phase_explain(large, large_params)
    lap("explain")
    if "tome" in phases:
        tome_launches = phase_tome(cfg, params, large, large_params)
    lap("tome")
    if "finetune" in phases:
        from vitx_torch.data import SyntheticDataset

        ds512 = SyntheticDataset(num_examples=32, image_size=512,
                                 num_classes=cfg.num_classes, seed=0)
        finetune_launches, *finetune = phase_finetune(ds512)
    lap("finetune")
    if "recipe" in phases:
        recipe_launches = phase_recipe()
    lap("recipe")
    if "transfer" in phases:
        transfer_launches, transfer = phase_transfer()
    lap("transfer")
    pretrained_launches = {}
    if "pretrained" in phases:
        pretrained_launches, _ = phase_pretrained(errs)
    lap("pretrained")
    families_launches = {}
    if "families" in phases:
        families_launches = phase_families()
    lap("families")
    optim_launches = {}
    if "optim" in phases:
        optim_launches = phase_optim()
    lap("optim")
    pretrain_launches, pretrain_extra = {}, {}
    if "pretrain" in phases:
        pretrain_launches, pretrain_extra = phase_pretrain(errs)
    lap("pretrain")
    parallel_launches, parallel_extra = {}, {}
    if "parallel" in phases:
        parallel_launches, parallel_extra = phase_parallel(errs)
    lap("parallel")
    pipeline_launches, pipeline_extra = {}, {}
    if "pipeline" in phases:
        pipeline_launches, pipeline_extra = phase_pipeline(errs)
    lap("pipeline")
    compose_launches, compose_extra = {}, {}
    if "compose" in phases:
        compose_launches, compose_extra = phase_compose(errs)
    lap("compose")
    export_launches, huge14_launches, huge14_inputs = {}, {}, None
    explain14_launches = {}
    if "artifacts" in phases:
        export_launches = phase_artifacts(cfg, params)
    lap("artifacts")
    if "bench" in phases:
        huge14_launches, explain14_launches, huge14_inputs = phase_bench(
            errs)
    lap("bench")
    launches = add_launches(serve_launches, train_launches, explain_launches,
                            tome_launches, finetune_launches,
                            *recipe_launches.values(), transfer_launches,
                            pretrained_launches, families_launches,
                            optim_launches, pretrain_launches,
                            parallel_launches, pipeline_launches,
                            compose_launches, export_launches,
                            huge14_launches, explain14_launches)
    if "times" in phases:
        rows = phase_times(cfg, params, errs, launches)
        if tome_launches:
            rows += phase_tome_times(cfg, params, large, large_params, errs,
                                     launches)
        del params
        stash = {}
        if train:
            new_rows, stash = phase_train_times(cfg, *train, launches,
                                                  train_launches, errs)
            rows += new_rows
        del train
        if explain_launches:
            rows += phase_explain_times(large, large_params, errs, launches)
        if finetune:
            new_rows, extra = phase_finetune_times(*finetune, launches, errs)
            rows += new_rows
            for row in rows:
                if row["name"] in extra:
                    # the row's own numbers first, then those past T 1024
                    # (B6) or on the entries' 2-D view (B11)
                    row["shapes"] = [{k: row[k] for k in extra[
                        row["name"]][0]}] + extra[row["name"]]
        del finetune
        extras = []
        if recipe_launches["recipe"]:
            # the recipe variants' own shapes, after the rows' own numbers
            extras.append(recipe_kernel_shapes(launches, errs))
        if transfer:
            phase_transfer_times(transfer)
            extras.append(transfer_kernel_shapes(launches, errs))
        if huge14_launches:
            extras.append(huge14_kernel_shapes(huge14_inputs, launches,
                                               errs))
        if pretrain_extra:
            extras.append(pretrain_extra)
        if parallel_extra:
            extras.append(parallel_extra)
        if pipeline_extra:
            extras.append(pipeline_extra)
        if compose_extra:
            extras.append(compose_extra)
        del huge14_inputs
        for extra in extras:
            for row in rows:
                if row["name"] in extra:
                    row["shapes"] = (row.get("shapes")
                                     or [shape_entry(row)]) + extra[
                                         row["name"]]
        paths = {"serve": serve_launches, "train": train_launches,
                 "explain": explain_launches, "tome": tome_launches,
                 "finetune": finetune_launches, **recipe_launches,
                 "transfer": transfer_launches,
                 "pretrained": pretrained_launches,
                 "families": families_launches, "optim": optim_launches,
                 "pretrain": pretrain_launches,
                 "parallel": parallel_launches,
                 "pipeline": pipeline_launches, "compose": compose_launches,
                 "export": export_launches, "huge14": huge14_launches,
                 "huge14_explain": explain14_launches}
        for row in rows:
            row["launches_by_path"] = {path: got.get(row["name"], 0)
                                       for path, got in paths.items()}
            block = next((b for b, r in BLOCK_SM90.items()
                          if r == row["name"] and b in ATTN_SM90_COUNTERS),
                         None)
            if block is not None:   # the attention's sm90 launches
                extra = ATTN_SM90_COUNTERS[block]
                row["attn_sm90_by_path"] = {path: got.get(extra, 0)
                                            for path, got in paths.items()}
            if row["name"] in stash:
                row["stash_ms_b128"] = stash[row["name"]]
        missing = sorted(set(KERNELS) - {row["name"] for row in rows})
        if missing and phases == list(PHASES):
            raise AssertionError(f"no times row for {missing}")
        emit({"phase": "total", "wall_s": time.perf_counter() - t_start})
        emit({"kernels": rows})
    if phases != list(PHASES):
        return 0
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
