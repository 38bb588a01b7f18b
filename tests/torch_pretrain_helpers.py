"""Shared pieces of ``tests/test_torch_{mae,dino,simclr}.py``: the small
configs, numpy-drawn weights in vitx's layout, vitx's view draws as the
port's ``ViewDraws``, the Adam step allowance and the CLI's config file.

The families run at tiny's widths cut to image 32 (patch 8, a 4 x 4
grid), depth 2, fp32, with the encoder's final norm; vitx's reference
functions are jitted once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import vitx
import vitx_torch
from vitx_torch.nn.dino import ViewDraws

KW = dict(image_size=32, depth=2, compute_dtype="float32", final_norm=True)
LR = 1e-3
TOL = 1e-4
# the views, normalised: test_torch_data.py's AUG_TOL (1e-5 on [0, 1])
# over the smallest ImageNet std (0.225)
VIEW_TOL = 5e-5


def configs(**more):
    """(vitx's, the port's) tiny config cut to ``KW``."""
    kw = dict(KW, **more)
    return vitx.get_config("tiny", **kw), vitx_torch.get_config("tiny", **kw)


def draw(spec, seed=0):
    """A tree of ``spec``'s shapes drawn with numpy: each leaf its init
    value (0.02 N(0, 1) for the trunc-normal ones) plus N(0, 0.02) noise,
    so that biases and norms take part."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        shape, init = node
        base = (0.02 * rng.standard_normal(shape) if init == "normal"
                else np.full(shape, init))
        return (base + 0.02 * rng.standard_normal(shape)).astype(np.float32)
    return walk(spec)


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def flat(tree, prefix=""):
    """{"a/b": float32 array} of a nested dict of arrays or tensors."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(
                v.detach().float() if torch.is_tensor(v) else v, np.float32)
    return out


def shapes(tree, prefix=""):
    """{"a/b": shape} of a nested dict of arrays, tensors or
    ``jax.ShapeDtypeStruct``s."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def images(batch, size=32, seed=1):
    """[0, 1] images, as the families' views read them."""
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (batch, size, size, 3)).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def grads_close(tgrads: dict, jgrads, tol=TOL, zero=()):
    """Every leaf's gradient within ``tol`` of vitx's, relative to the
    leaf's largest; the ``zero`` leaves, whose gradient is zero but for
    rounding (SimCLR's batch standardisation cancels any shift of fc1's
    input: fc1's bias and the encoder's final-norm bias), relative to the
    largest gradient of all. Returns the worst."""
    jf = flat(jgrads)
    assert sorted(tgrads) == sorted(jf)
    top = max(float(np.abs(v).max()) for v in jf.values())
    errs = {k: float(np.abs(np.asarray(tgrads[k], np.float64) - jf[k]).max())
            / (top if k in zero else max(float(np.abs(jf[k]).max()), 1e-30))
            for k in jf}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst])
    return errs[worst]


def adam_step_gap(tgrads, jgrads, tparams, jparams, lr=LR, eps=1e-8):
    """The largest gap between two params after one Adam step from zero
    moments, in units of its allowance (``chip_smoke.py::param_gap``): an
    element moves by lr (u(g) + wd p), u(g) = g / (|g| + eps); with d the
    leaf's largest gradient difference the two moves differ by at most lr
    (u(|g| + d) + u(|g|)), and by lr eps d / (|g| - d + eps)**2 where |g|
    > d, plus 1e-4 lr for rounding and one ulp of the new param."""
    worst = 0.0
    for k in jgrads:
        a, b = (np.asarray(x, np.float64) for x in (tgrads[k], jgrads[k]))
        d = np.max(np.abs(a - b))
        g = np.abs(b)
        bound = (g + d) / (g + d + eps) + g / (g + eps)
        mvt = eps * d / (g - d + eps) ** 2
        bound = np.where(g > d, np.minimum(bound, mvt), bound)
        pb = np.asarray(jparams[k], np.float32)
        allow = lr * (1e-4 + bound) + np.abs(np.spacing(pb))
        gap = np.abs(np.asarray(tparams[k], np.float64) - pb)
        worst = max(worst, float(np.max(gap / allow)))
    return worst


def vitx_view_draws(key, cfg, B, H, W, *, scale, solarize):
    """The draws vitx's ``_dino_view`` takes from ``key``
    (``vitx/nn/dino.py:285-308``, ``vitx/data/pipeline.py:24-69``), as
    the port's ``ViewDraws``."""
    d = _view_draws(key, B, H, W, tuple(scale), solarize,
                    (cfg.color_jitter, cfg.blur_prob, cfg.solarize_prob))
    return ViewDraws(**{k: t(np.asarray(v).reshape(B)) for k, v in d.items()})


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def _view_draws(key, B, H, W, scale, solarize, probs):
    color_jitter, blur_prob, solarize_prob = probs
    ks = jax.random.split(key, 6)
    k1, k2, k3, k4 = jax.random.split(ks[0], 4)
    area = jax.random.uniform(k1, (B,), minval=scale[0], maxval=scale[1])
    ratio = jnp.exp(jax.random.uniform(k2, (B,), minval=jnp.log(3 / 4),
                                       maxval=jnp.log(4 / 3)))
    ch = jnp.clip(jnp.sqrt(area / ratio) * H, 1.0, float(H))
    cw = jnp.clip(jnp.sqrt(area * ratio) * W, 1.0, float(W))
    d = dict(y0=jax.random.uniform(k3, (B,)) * (H - ch),
             x0=jax.random.uniform(k4, (B,)) * (W - cw), ch=ch, cw=cw,
             flip=jax.random.bernoulli(ks[1], 0.5, (B, 1, 1, 1)))

    def keep(k, p):
        return jax.random.bernoulli(jax.random.split(k)[0], p, (B, 1, 1, 1))

    if color_jitter:
        d["jitter"] = keep(ks[2], 0.8)
        lo, hi = 1.0 - color_jitter, 1.0 + color_jitter
        f = jax.random.split(jax.random.split(ks[2])[1], 3)
        d["fb"], d["fc"], d["fs"] = (
            jax.random.uniform(k, (B, 1, 1, 1), minval=lo, maxval=hi)
            for k in f)
    d["gray"] = keep(ks[3], 0.2)
    if blur_prob > 0.0:
        d["blur"] = keep(ks[4], blur_prob)
        (k1,) = jax.random.split(jax.random.split(ks[4])[1], 1)
        d["sigma"] = jax.random.uniform(k1, (B,), minval=0.1, maxval=2.0)
    if solarize and solarize_prob > 0.0:
        d["solarize"] = keep(ks[5], solarize_prob)
    return d


class GradCapture:
    """An optimizer for vitx's steps whose "new params" are the step's
    gradients (vitx's steps take ``updates`` as the params where
    ``returns_new_params`` is set): one jit of a step gives its loss, its
    metrics and every leaf's gradient."""
    returns_new_params = True

    def init(self, params):
        return ()

    def update(self, grads, state, params=None):
        return grads, state


def adamw_update(opt):
    """vitx's optimizer ``opt`` as one jitted update: (grads, opt_state,
    params) -> (new params, new opt_state)."""
    import optax

    @jax.jit
    def run(grads, state, params):
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state
    return run


def zeros_init(monkeypatch):
    """vitx's ``init_params`` as zeros of its shapes, for the references
    whose fresh leaves (a new head, drawn from threefry) no test compares:
    vitx's eager init costs seconds a shape."""
    from vitx.nn import vit as jvit

    real = jvit.init_params

    def init(rng, cfg):
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                            jax.eval_shape(lambda r: real(r, cfg), rng))
    for mod in ("vitx.nn.vit", "vitx.nn.mae", "vitx.nn.dino",
                "vitx.nn.simclr"):
        monkeypatch.setattr(f"{mod}.init_params", init)


class TagRecorder:
    """``ScalarWriter``'s interface, recording (tag, step) pairs: the
    real one's TensorBoard writer imports tensorflow where it is
    installed (seconds), which these tests do not need."""
    tags: list = []

    def __init__(self, log_dir, flush_secs=10.0):
        TagRecorder.tags = []

    def add_scalar(self, tag, value, step):
        assert np.isfinite(float(value))
        TagRecorder.tags.append((tag, int(step)))

    def close(self):
        pass


def write_config(path, cfg) -> str:
    """The port's config as the CLIs' ``--config-json`` file."""
    path.write_text(cfg.to_json())
    return str(path)


def load_vit_init_tree(path, vcfg):
    """vitx's ``load_vit_init`` of an ``--export-vit`` file, as numpy."""
    from vitx.cli.pretrain import load_vit_init

    return jax.tree.map(np.asarray, load_vit_init(
        path, vcfg.replace(final_norm=True), jax.random.PRNGKey(0)))
