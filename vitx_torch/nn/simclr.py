"""SimCLR contrastive pretraining in the port.

The counterpart of ``vitx/nn/simclr.py`` (Chen et al. 2020): two
augmented views of every image are pulled together and pushed apart from
every other view of the batch by the NT-Xent loss. The two views run as
one (2B, S, S, C) batch (view v of sample b at row v B + b) through the
encoder, on the card K1 and K2 with their stashes and their backward B2
and B3. The projection head standardises its hidden layer across the
batch (BatchNorm's train mode, no running moments): the anti-collapse
mechanism vitx's docstring explains. The views are DINO's builder
without solarize (``nn/dino.py::_dino_view``), with the same injected
draws.
"""

from __future__ import annotations

import dataclasses

import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD
from vitx_torch.nn.dino import _dino_view, view_draws
from vitx_torch.nn.layers import layer_norm
from vitx_torch.nn.pretrain_common import (encoder_spec,
                                           encoder_to_vit_params, gelu,
                                           l2_normalize)
from vitx_torch.nn.vit import (Params, encoder_layers, init_from_spec,
                               patch_embed, run_blocks)


@dataclasses.dataclass(frozen=True)
class SimCLRConfig:
    """SimCLR pretraining hyperparameters (``vitx/nn/simclr.py:59-107``):
    a 2-layer projection head (hidden ``proj_hidden``, output
    ``proj_dim``), temperature 0.1, the full augmentation chain with
    jitter strength 0.4."""

    encoder: ViTConfig
    proj_hidden: int = 2048
    proj_dim: int = 128
    temperature: float = 0.1
    crop_scale: tuple = (0.2, 1.0)
    color_jitter: float = 0.4
    blur_prob: float = 0.5
    mean: tuple | None = IMAGENET_MEAN
    std: tuple | None = IMAGENET_STD

    def __post_init__(self):
        e = self.encoder
        if self.temperature <= 0.0:
            raise ValueError("temperature must be positive")
        if min(self.proj_hidden, self.proj_dim) <= 0:
            raise ValueError("projection dims must be positive")
        if e.distill_token:
            raise ValueError("SimCLR pretraining has no distillation "
                             "teacher; set distill_token=False and enable "
                             "it on the fine-tune config instead")
        if e.parity == "bug_exact":
            raise ValueError("SimCLR pretraining requires the corrected "
                             "token layout (parity='fixed'); bug_exact "
                             "exists only to reproduce reference-trained "
                             "checkpoints")
        if e.moe_experts:
            raise ValueError("SimCLR pretraining of Soft-MoE encoders is "
                             "unsupported; pretrain dense and add MoE "
                             "blocks on the fine-tune config")
        if e.num_registers:
            raise ValueError("SimCLR pretraining does not thread register "
                             "tokens; pretrain with num_registers=0 and "
                             "add registers on the fine-tune config")

    # the view builder reads color_jitter, blur_prob and solarize_prob
    @property
    def solarize_prob(self):
        return 0.0


def simclr_param_spec(scfg: SimCLRConfig) -> dict:
    """``{"encoder", "head"}`` as (shape, init) leaves, vitx's tree
    (``vitx/nn/simclr.py:115-144``): fc1 with its bias, the batch norm's
    affine ``bn``, fc2 without bias."""
    E, H, D = scfg.encoder.embed_dim, scfg.proj_hidden, scfg.proj_dim
    head = {"fc1": {"kernel": ((E, H), "normal"), "bias": ((H,), 0.0)},
            "bn": {"scale": ((H,), 1.0), "bias": ((H,), 0.0)},
            "fc2": {"kernel": ((H, D), "normal")}}
    return {"encoder": encoder_spec(scfg.encoder, "SimCLR"), "head": head}


def init_simclr_params(rng, scfg: SimCLRConfig, *, device="cuda") -> Params:
    return init_from_spec(rng, simclr_param_spec(scfg), scfg.encoder, device)


def simclr_encode(params: Params, images, scfg: SimCLRConfig, *, rng=None,
                  deterministic: bool = True):
    """The encoder at the native size -> (B, E) CLS features
    (``vitx/nn/simclr.py:151-172``)."""
    cfg = scfg.encoder
    enc = params["encoder"]
    cdt = cfg.cdtype()
    B = images.shape[0]
    pos = enc["pos_embed"].to(cdt)
    tokens = patch_embed(enc, images, cfg) + pos[:, 1:]
    cls = (enc["cls_token"].to(cdt) + pos[:, :1]).expand(B, 1, cfg.embed_dim)
    x = torch.cat([cls, tokens], dim=1)
    x, _ = run_blocks(encoder_layers(enc), x, cfg, rng=rng,
                      deterministic=deterministic)
    fn = enc["final_norm"]
    x = layer_norm(x, fn["scale"], fn["bias"], eps=cfg.layer_norm_eps)
    return x[:, 0]


def simclr_project(params: Params, feats, scfg: SimCLRConfig, mesh=None):
    """(B, E) -> (B, D) L2-normalised projections in fp32
    (``vitx/nn/simclr.py:175-195``): fc1, the hidden standardised across
    the batch (biased variance, eps 1e-5) and its affine, tanh-GELU,
    fc2. ``mesh``: a data-parallel rank's rows, standardised by the global
    batch's moments (sums all-reduced both ways, vitx/nn/simclr.py:32-40)."""
    h = params["head"]
    x = feats.float() @ h["fc1"]["kernel"].float() + h["fc1"]["bias"].float()
    if mesh is not None:
        from vitx_torch.parallel import comm, sharded

        n = x.shape[0] * mesh.size(sharded.BATCH_AXES)
        mu = comm.all_reduce_sum(x.sum(dim=0, keepdim=True), mesh,
                                 sharded.BATCH_AXES) / n
        var = comm.all_reduce_sum((x - mu).square().sum(dim=0, keepdim=True),
                                  mesh, sharded.BATCH_AXES) / n
    else:
        mu = x.mean(dim=0, keepdim=True)
        var = x.var(dim=0, unbiased=False, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-5)
    x = x * h["bn"]["scale"].float() + h["bn"]["bias"].float()
    x = gelu(x) @ h["fc2"]["kernel"].float()
    return l2_normalize(x, -1)


def simclr_forward(params: Params, images, scfg: SimCLRConfig, *, rng=None,
                   deterministic: bool = True, mesh=None):
    return simclr_project(params, simclr_encode(
        params, images, scfg, rng=rng, deterministic=deterministic), scfg,
        mesh)


def simclr_view_draws(gen, images, scfg: SimCLRConfig) -> list:
    """The two views' draws (``nn/dino.py::view_draws``)."""
    B, H, W, _ = images.shape
    return [view_draws(gen, B, H, W, scfg, scale=scfg.crop_scale,
                       solarize=False) for _ in range(2)]


def simclr_views(images, scfg: SimCLRConfig, gen=None, *, draws=None):
    """[0, 1] images (B, H, W, C) -> one (2B, S, S, C) batch of two views
    (``vitx/nn/simclr.py:206-217``); ``draws`` replaces the draws from
    ``gen``."""
    if draws is None:
        draws = simclr_view_draws(gen, images, scfg)
    S = scfg.encoder.image_size
    return torch.cat([_dino_view(images, scfg, out_size=S, draws=d)
                      for d in draws], dim=0)


def nt_xent_loss(z, temperature: float):
    """NT-Xent over (2B, D) normalised projections, the positive of row b
    at B + b and back (``vitx/nn/simclr.py:220-245``) -> (loss, the share
    of rows whose positive scores highest among the non-self rows)."""
    n = z.shape[0]
    B = n // 2
    sim = (z @ z.t()) / temperature
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye, float("-inf"))
    ar = torch.arange(B, device=z.device)
    pos_idx = torch.cat([ar + B, ar])
    logp = torch.log_softmax(sim, dim=-1)
    loss = -logp.gather(1, pos_idx[:, None]).mean()
    acc = (sim.argmax(dim=-1) == pos_idx).float().mean()
    return loss, acc


def simclr_loss_fn(params, views, scfg: SimCLRConfig, rng=None, mesh=None):
    """The step's loss (``vitx/nn/simclr.py:258-261``): NT-Xent of the
    views' projections (dropout from ``rng``) -> (loss, accuracy).
    ``mesh``: a data-parallel rank's two views of its rows; NT-Xent runs
    over the global batch's projections, gathered view by view into the
    global layout (the gather's backward keeps the rank's rows: every
    rank computes the same loss), so the negatives are global."""
    z = simclr_forward(params, views, scfg, rng=rng, deterministic=False,
                       mesh=mesh)
    if mesh is not None:
        from vitx_torch.parallel import comm, sharded

        half = z.shape[0] // 2
        z = torch.cat([comm.gather_replicated(v, mesh, sharded.BATCH_AXES, 0)
                       for v in (z[:half], z[half:])], dim=0)
    return nt_xent_loss(z, scfg.temperature)


def simclr_train_step(state, batch, rng=None, *, scfg: SimCLRConfig,
                      optimizer, device="cuda", draws=None, mesh=None):
    """One SimCLR step (``vitx/nn/simclr.py:252-284``): the views, the
    fused forward, NT-Xent and one optimizer update, in place -> (state,
    {"loss", "contrast_acc", "grad_norm"}). ``rng`` (a
    ``torch.Generator`` on ``device``) draws the views and dropout;
    ``draws`` gives the views' draws. ``mesh``: a rank of a data-parallel
    step (its device, its rows of the batch and of ``draws``, the state
    whole on every rank): the draws made for the global batch, the batch
    moments and the negatives global, the gradients summed over the
    ranks."""
    from vitx_torch.train.step import (TrainState, _check_on, _to_device,
                                       global_norm, gradients,
                                       trainable_params)

    dev = resolve_device(device) if mesh is None else mesh.device
    _check_on(state.params, dev)
    batch = _to_device(batch, dev)
    gen = rng
    if mesh is not None:
        from vitx_torch.parallel import sharded

        gen, _ = sharded.family_step_parts(rng, batch["image"].shape[0],
                                           mesh)
    views = simclr_views(batch["image"].float(), scfg, gen, draws=draws)
    params, wrt = trainable_params(state.params)
    loss, acc = simclr_loss_fn(params, views, scfg, gen, mesh)
    grads = gradients(loss, params, wrt)
    if mesh is not None:
        grads = sharded.all_reduce_grads(grads, mesh)
        if rng is not None:
            rng.set_state(gen.get_state())
    new_params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params)
    return TrainState(state.step + 1, new_params, opt_state), {
        "loss": loss.detach(), "contrast_acc": acc,
        "grad_norm": global_norm(grads)}


def make_simclr_train_step(scfg: SimCLRConfig, optimizer, *, device="cuda",
                           mesh=None):
    """``(state, batch, rng=None, draws=None) -> (state, metrics)`` (a
    plain closure: vitx jits here); ``mesh`` as ``simclr_train_step``
    takes it."""
    def step(state, batch, rng=None, draws=None):
        return simclr_train_step(state, batch, rng, scfg=scfg,
                                 optimizer=optimizer, device=device,
                                 draws=draws, mesh=mesh)
    return step


def create_simclr_train_state(rng, scfg: SimCLRConfig, optimizer, *,
                              device="cuda"):
    from vitx_torch.train.step import TrainState

    params = init_simclr_params(rng, scfg, device=device)
    return TrainState(step=0, params=params,
                      opt_state=optimizer.init(params))


def simclr_to_vit_params(simclr_params: Params, cfg: ViTConfig, rng, *,
                         device="cuda") -> Params:
    """A pretrained SimCLR encoder as a classifier tree, the projection
    head dropped (``vitx/nn/simclr.py:287-305``):
    ``encoder_to_vit_params``."""
    return encoder_to_vit_params(simclr_params["encoder"], cfg, rng,
                                 "SimCLR", device)
