"""Masked-autoencoder (MAE) pretraining in the port.

The counterpart of ``vitx/nn/mae.py`` (He et al. 2022): a large random
share of the patches is masked, the encoder runs on the visible patches
only and a light decoder reconstructs the masked patches' pixels. The
encoder and the decoder run ``nn/vit.py::run_blocks``, so on the card
every block is K1 and K2 (with their stashes under grad: the family's
loss never switches ``fuse_mlp="auto"`` off, as vitx's never does), their
backward B2 and B3, and ``remat`` applies as in vitx. The decoder's
blocks are narrower (512 wide with 16 heads of D 32 by default): its
products take the sm90 GEMM in bf16 and its attention the earlier
kernels, which serve every head width but 64.

Randomness: ``random_masking`` draws uniform noise from a
``torch.Generator`` (it cannot match vitx's threefry stream), or takes
it as ``noise=``, so that a test can feed vitx's draws.
"""

from __future__ import annotations

import dataclasses

import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.core.draws import rand
from vitx_torch.nn.layers import dot, layer_norm, matmul32
from vitx_torch.nn.lora import lora_spec
from vitx_torch.nn.pretrain_common import (encoder_spec,
                                           encoder_to_vit_params)
from vitx_torch.nn.vit import (Params, block_spec, encoder_layers,
                               init_from_spec, patch_embed, run_blocks,
                               unstack)


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    """MAE pretraining hyperparameters (``vitx/nn/mae.py:36-89``).

    ``encoder`` is a full ViTConfig (its head is not used: MAE has no
    classification head); the decoder defaults follow He et al. 2022
    (512 wide, 8 blocks, 16 heads, 75 % masked, per-patch normalised
    pixel targets)."""

    encoder: ViTConfig
    decoder_dim: int = 512
    decoder_depth: int = 8
    decoder_heads: int = 16
    mask_ratio: float = 0.75
    norm_pix_loss: bool = True

    def __post_init__(self):
        if not 0.0 < self.mask_ratio < 1.0:
            raise ValueError(f"mask_ratio must be in (0, 1), "
                             f"got {self.mask_ratio}")
        if self.decoder_dim % self.decoder_heads:
            raise ValueError("decoder_dim not divisible by decoder_heads")
        if self.encoder.distill_token:
            raise ValueError("MAE pretraining has no distillation target; "
                             "use distill_token=False for the encoder and "
                             "enable it on the fine-tune config instead")
        if self.encoder.moe_experts:
            raise ValueError("MAE pretraining of Soft-MoE encoders is "
                             "unsupported; pretrain dense and add MoE "
                             "blocks on the fine-tune config")

    @property
    def num_patches(self) -> int:
        return self.encoder.grid_size ** 2

    @property
    def num_masked(self) -> int:
        return int(self.num_patches * self.mask_ratio)

    @property
    def num_visible(self) -> int:
        return self.num_patches - self.num_masked

    @property
    def decoder_cfg(self) -> ViTConfig:
        """The decoder blocks as a ViTConfig (what ``run_blocks`` reads)."""
        return dataclasses.replace(
            self.encoder, embed_dim=self.decoder_dim,
            depth=self.decoder_depth, num_heads=self.decoder_heads,
            dropout=0.0, drop_path=0.0)

    @property
    def patch_dim(self) -> int:
        e = self.encoder
        return e.patch_size * e.patch_size * e.num_channels


def mae_param_spec(mcfg: MAEConfig) -> dict:
    """``{"encoder", "decoder"}`` as (shape, init) leaves, vitx's tree
    (``vitx/nn/mae.py:92-125``)."""
    enc = mcfg.encoder
    dcfg = mcfg.decoder_cfg
    Ed, N = mcfg.decoder_dim, mcfg.num_patches
    dec = {
        "embed": {"kernel": ((enc.embed_dim, Ed), "normal"),
                  "bias": ((Ed,), 0.0)},
        "mask_token": ((1, 1, Ed), "normal"),
        "pos_embed": ((1, N + 1, Ed), "normal"),
        "blocks": {**block_spec(dcfg, dcfg.depth), **lora_spec(dcfg)},
        "norm": {"scale": ((Ed,), 1.0), "bias": ((Ed,), 0.0)},
        "pred": {"kernel": ((Ed, mcfg.patch_dim), "normal"),
                 "bias": ((mcfg.patch_dim,), 0.0)},
    }
    return {"encoder": encoder_spec(enc, "MAE"), "decoder": dec}


def init_mae_params(rng, mcfg: MAEConfig, *, device="cuda") -> Params:
    """The headless encoder (with its final norm) and the decoder's tree,
    on ``device`` (a CUDA device by default)."""
    return init_from_spec(rng, mae_param_spec(mcfg), mcfg.encoder, device)


def random_masking(gen, batch: int, mcfg: MAEConfig, noise=None,
                   device=None):
    """Per-sample masking with a static keep count
    (``vitx/nn/mae.py:128-143``) -> (ids_keep (B, K), ids_restore (B, N),
    mask (B, N) fp32, 1 = masked): a stable argsort of uniform noise per
    row, drawn from ``gen`` on its device, or ``noise`` (B, N) as given."""
    N, K = mcfg.num_patches, mcfg.num_visible
    if noise is None:
        noise = rand((batch, N), gen, gen.device)
    else:
        noise = torch.as_tensor(noise)
    if device is not None:
        noise = noise.to(device)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :K]
    mask = torch.ones((batch, N), dtype=torch.float32, device=noise.device)
    mask[:, :K] = 0.0
    mask = mask.gather(1, ids_restore)
    return ids_keep, ids_restore, mask


def patchify_pixels(images, cfg: ViTConfig):
    """(B, H, W, C) -> (B, N, P*P*C) in the layout ``patch_embed``
    flattens, so predictions and targets match element for element."""
    B = images.shape[0]
    P, g, C = cfg.patch_size, cfg.grid_size, cfg.num_channels
    x = images.reshape(B, g, P, g, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, g * g, P * P * C)


def unpatchify_pixels(patches, cfg: ViTConfig):
    """The inverse of ``patchify_pixels``: (B, N, P*P*C) -> (B, H, W, C)."""
    B = patches.shape[0]
    P, g, C = cfg.patch_size, cfg.grid_size, cfg.num_channels
    x = patches.reshape(B, g, g, P, P, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, g * P, g * P, C)


def _gather_tokens(x, ids):
    return x.gather(1, ids[..., None].expand(-1, -1, x.shape[2]))


def mae_encode(params: Params, images, mcfg: MAEConfig, *, ids_keep,
               rng=None, deterministic: bool = True):
    """The encoder over the visible patches only -> (B, K + 1, E), CLS
    first (``vitx/nn/mae.py:166-186``)."""
    enc_cfg = mcfg.encoder
    cdt = enc_cfg.cdtype()
    enc = params["encoder"]
    B = images.shape[0]
    pos = enc["pos_embed"].to(cdt)
    tokens = patch_embed(enc, images, enc_cfg) + pos[:, 1:]
    vis = _gather_tokens(tokens, ids_keep)
    cls = (enc["cls_token"].to(cdt) + pos[:, :1]).expand(
        B, 1, enc_cfg.embed_dim)
    x = torch.cat([cls, vis], dim=1)
    x, _ = run_blocks(encoder_layers(enc), x, enc_cfg, rng=rng,
                      deterministic=deterministic)
    fn = enc["final_norm"]
    return layer_norm(x, fn["scale"], fn["bias"], eps=enc_cfg.layer_norm_eps)


def mae_forward(params: Params, images, mcfg: MAEConfig, rng=None, *,
                deterministic: bool = False, noise=None, reduce=None):
    """The whole MAE pass -> (loss, pred (B, N, P*P*C) fp32, mask (B, N))
    (``vitx/nn/mae.py:189-237``): the loss is the mean squared error over
    the masked patches, against per-patch normalised pixels with
    ``norm_pix_loss``. ``rng`` (a ``torch.Generator`` on the images'
    device) draws the masking noise, unless ``noise`` (B, N) is given, and
    the encoder's dropout and drop-path when not ``deterministic``.
    ``reduce``: a data-parallel rank's hook for the global count of masked
    patches (``cross_entropy_loss`` takes the same)."""
    enc_cfg = mcfg.encoder
    cdt = enc_cfg.cdtype()
    dec = params["decoder"]
    B = images.shape[0]
    N, K = mcfg.num_patches, mcfg.num_visible
    ids_keep, ids_restore, mask = random_masking(rng, B, mcfg, noise,
                                                 images.device)
    x = mae_encode(params, images, mcfg, ids_keep=ids_keep,
                   rng=None if deterministic else rng,
                   deterministic=deterministic)

    # the decoder's embedding, then the mask tokens put back in place
    y = dot(x, dec["embed"]["kernel"].to(cdt)) + dec["embed"]["bias"].to(cdt)
    mask_tok = dec["mask_token"].to(cdt).expand(B, N - K, mcfg.decoder_dim)
    patches = _gather_tokens(torch.cat([y[:, 1:], mask_tok], dim=1),
                             ids_restore)
    y = torch.cat([y[:, :1], patches], dim=1) + dec["pos_embed"].to(cdt)
    y, _ = run_blocks(unstack(dec["blocks"]), y, mcfg.decoder_cfg,
                      deterministic=True)
    y = layer_norm(y, dec["norm"]["scale"], dec["norm"]["bias"],
                   eps=enc_cfg.layer_norm_eps)
    pred = matmul32(y[:, 1:], dec["pred"]["kernel"].to(cdt)) + \
        dec["pred"]["bias"].float()

    target = patchify_pixels(images.float(), enc_cfg)
    if mcfg.norm_pix_loss:
        mean = target.mean(dim=-1, keepdim=True)
        var = target.var(dim=-1, unbiased=False, keepdim=True)
        target = (target - mean) * torch.rsqrt(var + 1e-6)
    per_patch = (pred - target).square().mean(dim=-1)
    count = mask.sum() if reduce is None else reduce(mask.sum())
    loss = (per_patch * mask).sum() / count.clamp_min(1.0)
    return loss, pred, mask


def mae_loss_fn(params, batch, mcfg: MAEConfig, rng=None, noise=None,
                reduce=None):
    loss, _, _ = mae_forward(params, batch["image"], mcfg, rng, noise=noise,
                             reduce=reduce)
    return loss, ()


def mae_train_step(state, batch, rng=None, *, mcfg: MAEConfig, optimizer,
                   device="cuda", noise=None, mesh=None):
    """One MAE step (``vitx/nn/mae.py:244-268``): the loss, its gradients
    for every leaf and one optimizer update of the state, in place ->
    (state, {"loss", "grad_norm"}). ``rng`` (a ``torch.Generator`` on
    ``device``) draws the masking and the encoder's dropout, or
    ``noise`` gives the masking's draws. ``mesh``: a rank of a
    data-parallel step (``vitx_torch.parallel``; its device, its rows of
    the batch and of ``noise``, the state whole on every rank): the noise
    drawn for the global batch, the loss the mean over the global batch's
    masked patches, the gradients summed over the ranks."""
    from vitx_torch.train.step import (TrainState, _check_on, _to_device,
                                       global_norm, gradients,
                                       trainable_params)

    dev = resolve_device(device) if mesh is None else mesh.device
    if rng is None and noise is None:
        raise ValueError("the MAE step draws its masking from a "
                         "torch.Generator: pass rng (or noise)")
    _check_on(state.params, dev)
    batch = _to_device(batch, dev)
    gen, reduce = rng, None
    if mesh is not None:
        from vitx_torch.parallel import sharded

        gen, reduce = sharded.family_step_parts(rng, batch["image"].shape[0],
                                                mesh)
    params, wrt = trainable_params(state.params)
    loss, _ = mae_loss_fn(params, batch, mcfg, gen, noise, reduce)
    grads = gradients(loss, params, wrt)
    if mesh is not None:
        grads = sharded.all_reduce_grads(grads, mesh)
        loss = sharded.global_sum(loss, mesh)
        if rng is not None:
            rng.set_state(gen.get_state())
    new_params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params)
    return TrainState(state.step + 1, new_params, opt_state), {
        "loss": loss.detach(), "grad_norm": global_norm(grads)}


def make_mae_train_step(mcfg: MAEConfig, optimizer, *, device="cuda",
                        mesh=None):
    """``(state, batch, rng=None, noise=None) -> (state, metrics)`` bound
    to the config and optimizer (a plain closure: vitx jits here);
    ``mesh`` as ``mae_train_step`` takes it."""
    def step(state, batch, rng=None, noise=None):
        return mae_train_step(state, batch, rng, mcfg=mcfg,
                              optimizer=optimizer, device=device,
                              noise=noise, mesh=mesh)
    return step


def create_mae_train_state(rng, mcfg: MAEConfig, optimizer, *,
                           device="cuda"):
    from vitx_torch.train.step import TrainState

    params = init_mae_params(rng, mcfg, device=device)
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params))


def mae_to_vit_params(mae_params: Params, cfg: ViTConfig, rng, *,
                      device="cuda") -> Params:
    """A pretrained MAE encoder as a classifier tree
    (``vitx/nn/mae.py:280-293``): ``encoder_to_vit_params``."""
    return encoder_to_vit_params(mae_params["encoder"], cfg, rng, "MAE",
                                 device)

