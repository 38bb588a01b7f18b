"""DINO self-distillation pretraining in the port.

The counterpart of ``vitx/nn/dino.py`` (Caron et al. 2021): a student
ViT matches, across augmented views, the centred and sharpened softmax
targets of an EMA teacher of itself. Multi-crop is two static sizes: the
two global views run as one (2B, S, S, C) batch and the local views as
one (n_local B, s, s, C) batch; the local grid reads the global
positional table resized in the graph (antialiased bilinear, with its
gradient). On the card the student's blocks are K1 and K2 with their
stashes, their backward B2 and B3; the teacher's forward runs under
``torch.no_grad`` (K1 and K2 without their stashes).

Randomness cannot follow vitx's threefry stream, so every draw of the
view builder is a value: ``view_draws`` draws one view's from a
``torch.Generator`` (the crop box, the flip, the jitter factors, the
``_maybe`` selects, the blur's sigma), and ``_dino_view`` /
``multi_crop`` / the step take them as ``draws=``, so that a test can
feed vitx's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import resolve_device
from vitx_torch.core.draws import rand
from vitx_torch.data.pipeline import (IMAGENET_MEAN, IMAGENET_STD,
                                      crop_resize, flip, jitter)
from vitx_torch.interop.pretrained import resize_bilinear
from vitx_torch.nn.layers import layer_norm
from vitx_torch.nn.pretrain_common import (encoder_spec,
                                           encoder_to_vit_params, gelu,
                                           l2_normalize)
from vitx_torch.nn.vit import (Params, encoder_layers, init_from_spec,
                               patch_embed, run_blocks)


@dataclasses.dataclass(frozen=True)
class DINOConfig:
    """DINO pretraining hyperparameters (``vitx/nn/dino.py:48-114``).

    ``encoder`` is a full ViTConfig at the global crop's geometry (its
    head is replaced by the projection head). Defaults follow Caron et al.
    2021's ViT recipe: 2 global and ``n_local`` local crops, 4096
    prototypes, teacher temperature 0.04, student 0.1, centre momentum
    0.9, teacher EMA 0.996 -> 1 on a cosine."""

    encoder: ViTConfig
    local_size: int = 96
    n_local: int = 6
    out_dim: int = 4096
    head_hidden: int = 2048
    head_bottleneck: int = 256
    student_temp: float = 0.1
    teacher_temp: float = 0.04
    center_momentum: float = 0.9
    momentum: float = 0.996
    norm_last_layer: bool = True
    global_scale: tuple = (0.4, 1.0)
    local_scale: tuple = (0.05, 0.4)
    color_jitter: float = 0.4
    blur_prob: float = 0.5
    solarize_prob: float = 0.2       # the second global view only
    mean: tuple | None = IMAGENET_MEAN
    std: tuple | None = IMAGENET_STD

    def __post_init__(self):
        e = self.encoder
        if self.local_size % e.patch_size:
            raise ValueError(f"local_size {self.local_size} not divisible "
                             f"by patch_size {e.patch_size}")
        if self.local_size >= e.image_size:
            raise ValueError("local crops must be smaller than global crops "
                             f"(local {self.local_size} >= global "
                             f"{e.image_size})")
        if self.n_local < 0:
            raise ValueError("n_local must be >= 0")
        if not (0.0 < self.teacher_temp and 0.0 < self.student_temp):
            raise ValueError("temperatures must be positive")
        if not 0.0 <= self.momentum <= 1.0:
            raise ValueError("teacher momentum must be in [0, 1]")
        if e.distill_token:
            raise ValueError("DINO pretraining has no distillation teacher "
                             "logits; set distill_token=False and enable it "
                             "on the fine-tune config instead")
        if e.parity == "bug_exact":
            raise ValueError("DINO pretraining requires the corrected token "
                             "layout (parity='fixed'); bug_exact exists only "
                             "to reproduce reference-trained checkpoints")
        if e.moe_experts:
            raise ValueError("DINO pretraining of Soft-MoE encoders is "
                             "unsupported; pretrain dense and add MoE "
                             "blocks on the fine-tune config")
        if e.num_registers:
            raise ValueError("DINO pretraining does not thread register "
                             "tokens; pretrain with num_registers=0 and add "
                             "registers on the fine-tune config")
        if min(self.out_dim, self.head_hidden, self.head_bottleneck) <= 0:
            raise ValueError("head dims must be positive")

    @property
    def local_cfg(self) -> ViTConfig:
        return self.encoder.replace(image_size=self.local_size)

    @property
    def n_views(self) -> int:
        return 2 + self.n_local


class DINOState(NamedTuple):
    """The train state: the student, its optimizer state, the teacher (an
    EMA of the student, the same tree) and the centre (out_dim,) fp32."""
    step: int
    params: Any
    opt_state: Any
    teacher: Any
    center: torch.Tensor


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def dino_param_spec(dcfg: DINOConfig) -> dict:
    """``{"encoder", "head"}`` as (shape, init) leaves, vitx's tree
    (``vitx/nn/dino.py:138-169``): the headless encoder and the projection
    head's three layers and its prototypes ``last`` (Bd, K)."""
    E = dcfg.encoder.embed_dim
    H, Bd, K = dcfg.head_hidden, dcfg.head_bottleneck, dcfg.out_dim
    head = {
        "fc1": {"kernel": ((E, H), "normal"), "bias": ((H,), 0.0)},
        "fc2": {"kernel": ((H, H), "normal"), "bias": ((H,), 0.0)},
        "fc3": {"kernel": ((H, Bd), "normal"), "bias": ((Bd,), 0.0)},
        "last": ((Bd, K), "normal"),
    }
    return {"encoder": encoder_spec(dcfg.encoder, "DINO"), "head": head}


def init_dino_params(rng, dcfg: DINOConfig, *, device="cuda") -> Params:
    """The headless encoder and the projection head on ``device``; the
    teacher starts as a copy (``create_dino_train_state``)."""
    return init_from_spec(rng, dino_param_spec(dcfg), dcfg.encoder, device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _resized_pos_embed(pos, grid_from: int, grid_to: int):
    """(1, N + 1, E) -> (1, n + 1, E) at another grid, the CLS row kept:
    ``jax.image.resize``'s bilinear resize (antialiased when shrinking),
    differentiable (``vitx/nn/dino.py:172-184``)."""
    if grid_from == grid_to:
        return pos
    E = pos.shape[-1]
    grid = pos[:, 1:].reshape(1, grid_from, grid_from, E)
    grid = resize_bilinear(grid, (grid_to, grid_to))
    return torch.cat([pos[:, :1], grid.reshape(1, grid_to * grid_to, E)],
                     dim=1)


def dino_encode(params: Params, images, dcfg: DINOConfig, *, rng=None,
                deterministic: bool = True):
    """The shared encoder at either crop size -> (B, E) CLS features
    (``vitx/nn/dino.py:187-213``); the size is read off ``images``, the
    global table resized for local crops."""
    size = images.shape[1]
    cfg = (dcfg.encoder if size == dcfg.encoder.image_size
           else dcfg.local_cfg)
    enc = params["encoder"]
    cdt = cfg.cdtype()
    B = images.shape[0]
    pos = _resized_pos_embed(enc["pos_embed"].float(),
                             dcfg.encoder.grid_size, cfg.grid_size).to(cdt)
    tokens = patch_embed(enc, images, cfg) + pos[:, 1:]
    cls = (enc["cls_token"].to(cdt) + pos[:, :1]).expand(B, 1, cfg.embed_dim)
    x = torch.cat([cls, tokens], dim=1)
    x, _ = run_blocks(encoder_layers(enc), x, cfg, rng=rng,
                      deterministic=deterministic)
    fn = enc["final_norm"]
    x = layer_norm(x, fn["scale"], fn["bias"], eps=cfg.layer_norm_eps)
    return x[:, 0]


def dino_head(params: Params, feats, dcfg: DINOConfig):
    """(B, E) features -> (B, K) prototype logits, all fp32
    (``vitx/nn/dino.py:216-237``): a 3-layer tanh-GELU MLP, the
    bottleneck L2-normalised, then the prototypes, column-normalised with
    ``norm_last_layer`` (weight norm with the gain frozen at 1)."""
    h = params["head"]
    x = feats.float()
    x = gelu(x @ h["fc1"]["kernel"].float() + h["fc1"]["bias"].float())
    x = gelu(x @ h["fc2"]["kernel"].float() + h["fc2"]["bias"].float())
    x = x @ h["fc3"]["kernel"].float() + h["fc3"]["bias"].float()
    x = l2_normalize(x, -1)
    last = h["last"].float()
    if dcfg.norm_last_layer:
        last = l2_normalize(last, 0)
    return x @ last


def dino_forward(params: Params, images, dcfg: DINOConfig, *, rng=None,
                 deterministic: bool = True):
    return dino_head(params, dino_encode(params, images, dcfg, rng=rng,
                                         deterministic=deterministic), dcfg)


# ---------------------------------------------------------------------------
# Multi-crop views
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ViewDraws:
    """One view's draws for a batch of B images, each a (B,) tensor: the
    crop box (y0, x0, ch, cw), the flip, the three ``_maybe`` selects
    (jitter, grayscale, blur; None where the option is off) with the
    jitter's factors (fb, fc, fs) and the blur's sigma, and the
    solarize select (None on views without it)."""
    y0: Any
    x0: Any
    ch: Any
    cw: Any
    flip: Any
    jitter: Any = None
    fb: Any = None
    fc: Any = None
    fs: Any = None
    gray: Any = None
    blur: Any = None
    sigma: Any = None
    solarize: Any = None

    def to(self, device):
        return ViewDraws(**{k: None if v is None else
                            torch.as_tensor(v).to(device)
                            for k, v in dataclasses.asdict(self).items()})


def _uniform(gen, n, lo=0.0, hi=1.0):
    return lo + (hi - lo) * rand((n,), gen, gen.device)


def view_draws(gen, B: int, H: int, W: int, cfg, *, scale,
               solarize: bool, ratio=(3 / 4, 4 / 3)) -> ViewDraws:
    """One view's draws from ``gen`` (``cfg``: a DINOConfig or
    SimCLRConfig, which give the options' probabilities), in vitx's order
    (``vitx/nn/dino.py:267-286``, ``vitx/data/pipeline.py:24-69``): the
    crop box (area, then aspect, then the corner), the flip, then each
    ``_maybe``'s select and its own draws."""
    area = _uniform(gen, B, scale[0], scale[1])
    r = torch.exp(_uniform(gen, B, math.log(ratio[0]), math.log(ratio[1])))
    ch = torch.clamp(torch.sqrt(area / r) * H, 1.0, float(H))
    cw = torch.clamp(torch.sqrt(area * r) * W, 1.0, float(W))
    d = ViewDraws(y0=_uniform(gen, B) * (H - ch), x0=_uniform(gen, B) *
                  (W - cw), ch=ch, cw=cw, flip=_uniform(gen, B) < 0.5)
    if cfg.color_jitter:
        lo, hi = 1.0 - cfg.color_jitter, 1.0 + cfg.color_jitter
        d.jitter = _uniform(gen, B) < 0.8
        d.fb, d.fc, d.fs = (_uniform(gen, B, lo, hi) for _ in range(3))
    d.gray = _uniform(gen, B) < 0.2
    if cfg.blur_prob > 0.0:
        d.blur = _uniform(gen, B) < cfg.blur_prob
        d.sigma = _uniform(gen, B, 0.1, 2.0)
    if solarize and cfg.solarize_prob > 0.0:
        d.solarize = _uniform(gen, B) < cfg.solarize_prob
    return d


def _gaussian_blur(x, sigma, taps: int = 9):
    """Per-sample separable Gaussian blur at ``sigma`` (B,) as two batched
    contractions with banded (B, n, n) matrices, their rows renormalised
    at the edges (``vitx/nn/dino.py:244-271``)."""
    _, H, W, _ = x.shape
    r = torch.arange(taps, dtype=torch.float32, device=x.device) - \
        (taps - 1) / 2.0
    k1d = torch.exp(-r.square()[None, :] / (2.0 * sigma.square()[:, None]))
    k1d = k1d / k1d.sum(dim=-1, keepdim=True)

    def band(n):
        ar = torch.arange(n, device=x.device)
        idx = ar[None, :] - ar[:, None] + (taps - 1) // 2
        valid = (idx >= 0) & (idx < taps)
        gath = k1d[:, idx.clamp(0, taps - 1)]
        gath = torch.where(valid[None], gath, torch.zeros_like(gath))
        return gath / gath.sum(dim=-1, keepdim=True)

    x = torch.einsum("bhi,biwc->bhwc", band(H), x)
    return torch.einsum("bwj,bhjc->bhwc", band(W), x)


def _maybe(keep, fx, x):
    """``fx(x)`` on the rows where ``keep`` (B,) is true, both branches
    computed (``vitx/nn/dino.py:274-282``); ``keep`` None: x as it is."""
    if keep is None:
        return x
    return torch.where(keep[:, None, None, None], fx(x), x)


def _dino_view(images, cfg, *, out_size: int, draws: ViewDraws):
    """One augmented view of [0, 1] images (``vitx/nn/dino.py:285-308``):
    random-resized crop, flip, jitter, grayscale, blur, (solarize), then
    normalise, from ``draws``."""
    d = draws.to(images.device)
    x = crop_resize(images, out_size, d.y0, d.x0, d.ch, d.cw)
    x = flip(x, d.flip)
    if cfg.color_jitter:
        fb, fc, fs = (f[:, None, None, None] for f in (d.fb, d.fc, d.fs))
        x = _maybe(d.jitter, lambda v: jitter(v, fb, fc, fs), x)
    x = _maybe(d.gray, lambda v: v.mean(dim=-1, keepdim=True).expand(
        v.shape), x)
    x = _maybe(d.blur, lambda v: _gaussian_blur(v, d.sigma), x)
    x = _maybe(d.solarize, lambda v: torch.where(v > 0.5, 1.0 - v, v), x)
    if cfg.mean is not None:
        x = ((x - torch.tensor(cfg.mean, dtype=torch.float32,
                               device=x.device))
             / torch.tensor(cfg.std, dtype=torch.float32, device=x.device))
    return x


def multi_crop_draws(gen, images, dcfg: DINOConfig) -> list:
    """The draws of every view (``view_draws``): the two global views, the
    second with solarize, then the local ones."""
    B, H, W, _ = images.shape
    return ([view_draws(gen, B, H, W, dcfg, scale=dcfg.global_scale,
                        solarize=s) for s in (False, True)]
            + [view_draws(gen, B, H, W, dcfg, scale=dcfg.local_scale,
                          solarize=False) for _ in range(dcfg.n_local)])


def multi_crop(images, dcfg: DINOConfig, gen=None, *, draws=None):
    """[0, 1] images (B, H, W, C) -> (globals (2B, S, S, C), locals
    (n_local B, s, s, C) or None) (``vitx/nn/dino.py:311-333``): view v
    of sample b at row v B + b. ``draws`` (``multi_crop_draws``' list)
    replaces the draws from ``gen``."""
    if draws is None:
        draws = multi_crop_draws(gen, images, dcfg)
    S, s = dcfg.encoder.image_size, dcfg.local_size
    gl = torch.cat([_dino_view(images, dcfg, out_size=S, draws=d)
                    for d in draws[:2]], dim=0)
    if dcfg.n_local == 0:
        return gl, None
    return gl, torch.cat([_dino_view(images, dcfg, out_size=s, draws=d)
                          for d in draws[2:]], dim=0)


# ---------------------------------------------------------------------------
# Loss and step
# ---------------------------------------------------------------------------

def dino_loss(student_logits, teacher_logits, center, dcfg: DINOConfig,
              reduce=None):
    """The cross-entropy of the teacher's targets against the student's
    predictions over every (teacher global view, student view) pair of
    different views (``vitx/nn/dino.py:340-364``). student_logits (V, B,
    K), teacher_logits (2, B, K); the targets softmax((t - center) /
    teacher_temp), without gradient. -> (loss, teacher probs).
    ``reduce``: a data-parallel rank's hook for the global batch size
    (``cross_entropy_loss`` takes the same)."""
    t = torch.softmax((teacher_logits - center[None, None, :])
                      / dcfg.teacher_temp, dim=-1).detach()
    s_logp = torch.log_softmax(student_logits / dcfg.student_temp, dim=-1)
    V = student_logits.shape[0]
    B = student_logits.shape[1]
    n = None if reduce is None else reduce(
        torch.tensor(float(B), device=student_logits.device))
    total, n_terms = 0.0, 0
    for iq in range(2):
        for v in range(V):
            if v == iq:
                continue
            ce = -(t[iq] * s_logp[v]).sum(dim=-1)
            total = total + (ce.mean() if n is None else ce.sum() / n)
            n_terms += 1
    return total / n_terms, t


def _teacher_momentum(step: int, total_steps: int, dcfg: DINOConfig) -> float:
    """The teacher EMA's momentum, base -> 1 on a cosine over the run, in
    fp32 (``vitx/nn/dino.py:371-374``)."""
    f32 = np.float32
    frac = np.clip(f32(step) / f32(max(total_steps, 1)), f32(0), f32(1))
    cos = np.cos(f32(np.pi) * frac, dtype=f32)
    return float(f32(1.0) - f32(1.0 - dcfg.momentum) * (cos + f32(1.0))
                 / f32(2.0))


def dino_loss_fn(params, teacher, center, g_crops, l_crops,
                 dcfg: DINOConfig, rng=None, reduce=None):
    """The step's loss (``vitx/nn/dino.py:390-404``): the student's
    logits over every view (globals, then locals; dropout from ``rng``)
    against the teacher's on the globals, without gradient -> (loss,
    (teacher logits (2, B, K), teacher probs))."""
    B = g_crops.shape[0] // 2
    views = [dino_forward(params, g_crops, dcfg, rng=rng,
                          deterministic=False).reshape(2, B, -1)]
    if l_crops is not None:
        views.append(dino_forward(params, l_crops, dcfg, rng=rng,
                                  deterministic=False).reshape(
                                      dcfg.n_local, B, -1))
    with torch.no_grad():
        t_g = dino_forward(teacher, g_crops, dcfg).reshape(2, B, -1)
    loss, t_probs = dino_loss(torch.cat(views, dim=0), t_g, center, dcfg,
                              reduce)
    return loss, (t_g, t_probs)


def dino_train_step(state: DINOState, batch, rng=None, *, dcfg: DINOConfig,
                    optimizer, total_steps: int, freeze_last_steps: int = 0,
                    device="cuda", draws=None, mesh=None):
    """One DINO step (``vitx/nn/dino.py:377-455``): the crops, the
    student's forwards (globals and locals) and the teacher's (globals,
    without gradient), the loss, the student's update, then the teacher's
    fp32 EMA and the centre's. For the first ``freeze_last_steps`` steps
    the prototypes' gradient is zeroed and their weights pinned (weight
    decay cannot move them either). ``rng`` (a ``torch.Generator`` on
    ``device``) draws the views and dropout; ``draws`` gives the views'
    draws. Updates the state's tensors in place -> (state, {"loss",
    "teacher_entropy", "ema_momentum", "grad_norm"}). ``mesh``: a rank of
    a data-parallel step (its device, its rows of the batch and of
    ``draws``, the state whole on every rank): the draws made for the
    global batch, the loss and the teacher's entropy means over it, the
    centre updated from its mean, the gradients summed over the ranks."""
    from vitx_torch.train.step import (_check_on, _to_device, global_norm,
                                       gradients, leaves, trainable_params)

    dev = resolve_device(device) if mesh is None else mesh.device
    _check_on(state.params, dev)
    batch = _to_device(batch, dev)
    gen, reduce = rng, None
    if mesh is not None:
        from vitx_torch.parallel import sharded

        gen, reduce = sharded.family_step_parts(rng, batch["image"].shape[0],
                                                mesh)
    g_crops, l_crops = multi_crop(batch["image"].float(), dcfg, gen,
                                  draws=draws)
    params, wrt = trainable_params(state.params)
    loss, (t_g, t_probs) = dino_loss_fn(params, state.teacher, state.center,
                                        g_crops, l_crops, dcfg, gen, reduce)
    grads = gradients(loss, params, wrt)
    if mesh is not None:
        grads = sharded.all_reduce_grads(grads, mesh)
        loss = sharded.global_sum(loss, mesh)
        if rng is not None:
            rng.set_state(gen.get_state())

    frozen = freeze_last_steps > 0 and state.step < freeze_last_steps
    last = state.params["head"]["last"]
    if frozen:
        i = next(i for i, t in enumerate(leaves(state.params)) if t is last)
        grads[i] = grads[i] * 0.0
        pinned = last.detach().clone()
    grad_norm = global_norm(grads)
    new_params, opt_state = optimizer.update(grads, state.opt_state,
                                             state.params)
    with torch.no_grad():
        if frozen:
            new_params["head"]["last"].copy_(pinned)
        m = _teacher_momentum(state.step, total_steps, dcfg)
        rest = float(np.float32(1.0) - np.float32(m))
        # m * t + (1 - m) * s in fp32, as vitx rounds it, over all leaves
        # at once (``float()`` is the leaf itself where it is fp32)
        teacher = leaves(state.teacher)
        ema = [t.float() for t in teacher]
        torch._foreach_mul_(ema, m)
        torch._foreach_add_(ema, torch._foreach_mul(
            [s.float() for s in leaves(new_params)], rest))
        for t, e in zip(teacher, ema):
            if e is not t:
                t.copy_(e)
        cm = dcfg.center_momentum
        ent = -(t_probs * torch.log(t_probs + 1e-12)).sum(dim=-1)
        if mesh is None:
            t_mean, ent = t_g.mean(dim=(0, 1)), ent.mean()
        else:
            n = sharded.global_sum(torch.tensor(
                float(ent.numel()), device=dev), mesh)
            t_mean = sharded.global_sum(t_g.sum(dim=(0, 1)), mesh) / n
            ent = sharded.global_sum(ent.sum(), mesh) / n
        center = cm * state.center + (1.0 - cm) * t_mean
    new_state = DINOState(state.step + 1, new_params, opt_state,
                          state.teacher, center)
    return new_state, {"loss": loss.detach(), "teacher_entropy": ent,
                       "ema_momentum": torch.tensor(m, dtype=torch.float32),
                       "grad_norm": grad_norm}


def make_dino_train_step(dcfg: DINOConfig, optimizer, total_steps: int,
                         freeze_last_steps: int = 0, *, device="cuda",
                         mesh=None):
    """``(state, batch, rng=None, draws=None) -> (state, metrics)`` bound
    to the config, optimizer and schedule (a plain closure: vitx jits
    here)."""
    def step(state, batch, rng=None, draws=None):
        return dino_train_step(state, batch, rng, dcfg=dcfg,
                               optimizer=optimizer, total_steps=total_steps,
                               freeze_last_steps=freeze_last_steps,
                               device=device, draws=draws, mesh=mesh)
    return step


def create_dino_train_state(rng, dcfg: DINOConfig, optimizer, *,
                            device="cuda") -> DINOState:
    """Fresh student params, the teacher a copy of them, the optimizer's
    zero state and a zero centre, on ``device``."""
    from vitx_torch.train.step import tree_map

    params = init_dino_params(rng, dcfg, device=device)
    teacher = tree_map(lambda t: t.clone(), params)
    return DINOState(step=0, params=params, opt_state=optimizer.init(params),
                     teacher=teacher,
                     center=torch.zeros(dcfg.out_dim, dtype=torch.float32,
                                        device=resolve_device(device)))


def dino_to_vit_params(dino_params: Params, cfg: ViTConfig, rng, *,
                       device="cuda") -> Params:
    """A pretrained DINO encoder (by convention the teacher: pass
    ``state.teacher``) as a classifier tree (``vitx/nn/dino.py:458-474``):
    ``encoder_to_vit_params``."""
    return encoder_to_vit_params(dino_params["encoder"], cfg, rng, "DINO",
                                 device)
