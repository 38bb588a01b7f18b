"""The pretraining families' data-parallel steps in the port against
vitx's on the CPU.

MAE, DINO and SimCLR at ``tests/torch_pretrain_helpers.py``'s widths
(tiny cut to image 32, depth 2, fp32), a global batch of 4 over two gloo
rank processes (``vitx_torch.parallel.spawn``, a ``file://`` rendezvous
under ``tmp_path``), held to vitx's steps on a dp=2 mesh of the
conftest's CPU devices (params replicated, the batch sharded over
``data``), with vitx's draws (MAE's masking noise, the views' crops)
fed to the port's ranks, each its rows: the loss and the family's
metrics and every leaf's gradient at 1e-4, the params after one AdamW
step within the Adam step's allowance. The three run in one spawn.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from vitx.nn import dino as jdino
from vitx.nn import mae as jmae
from vitx.nn import simclr as jsim
from vitx.parallel import make_mesh, shard_batch
from vitx.train import step as jstep
from vitx_torch.nn import dino as tdino
from vitx_torch.nn import mae as tmae
from vitx_torch.nn import simclr as tsim
from vitx_torch.parallel import spawn

from tests import torch_parallel_helpers as H
from tests.torch_pretrain_helpers import (LR, TOL, GradCapture,
                                          adam_step_gap, adamw_update,
                                          configs, draw, flat, grads_close,
                                          images, jtree, rel_err,
                                          vitx_view_draws)

B = 4
HEADS = {
    "mae": dict(decoder_dim=96, decoder_depth=2, decoder_heads=3),
    "dino": dict(out_dim=64, n_local=2, local_size=16, head_hidden=32,
                 head_bottleneck=16),
    "simclr": dict(proj_hidden=24, proj_dim=12),
}
TOTAL = 4
# leaves whose gradient is zero but for rounding (SimCLR's batch
# standardisation cancels a shift of fc1's input)
ZERO = {"simclr": ("encoder/final_norm/bias", "head/fc1/bias")}


def _vitx_dp_step(make_step, state, x, rng):
    """vitx's step on a dp=2 mesh: the state replicated, the batch
    sharded over ``data`` (``vitx/cli/pretrain.py:198-205``)."""
    mesh = make_mesh(dp=2, tp=1, devices=jax.devices()[:2])
    state = jax.device_put(state, NamedSharding(mesh, P()))
    return make_step(state, shard_batch({"image": jnp.asarray(x)}, mesh),
                     rng)


@functools.lru_cache(maxsize=None)
def references():
    """vitx's dp steps of the three families and the port's payloads."""
    vcfg, tcfg = configs()
    x = images(B)
    out, payloads = {}, {}
    opt = jstep.make_optimizer(lr=LR, weight_decay=0.05)
    for family in ("mae", "dino", "simclr"):
        kw = HEADS[family]
        rng = jax.random.PRNGKey({"mae": 7, "dino": 5, "simclr": 9}[family])
        if family == "mae":
            jc, tc = jmae.MAEConfig(encoder=vcfg, **kw), \
                tmae.MAEConfig(encoder=tcfg, **kw)
            params = draw(tmae.mae_param_spec(tc))
            fwd = jax.random.fold_in(rng, 0)
            r_mask, _ = jax.random.split(jax.random.fold_in(fwd, 0))
            draws = np.asarray(jax.random.uniform(r_mask, (B, tc.num_patches)))
            make = functools.partial(jmae.make_mae_train_step, jc)
            extra = {}
        elif family == "dino":
            jc, tc = jdino.DINOConfig(encoder=vcfg, **kw), \
                tdino.DINOConfig(encoder=tcfg, **kw)
            spec = tdino.dino_param_spec(tc)
            params, teacher = draw(spec, 0), draw(spec, 1)
            center = (0.1 * np.random.default_rng(2).standard_normal(
                kw["out_dim"])).astype(np.float32)
            k_crop, _ = jax.random.split(jax.random.fold_in(rng, 0))
            keys = jax.random.split(k_crop, jc.n_views)
            draws = [vitx_view_draws(keys[v], jc, B, 32, 32,
                                     scale=jc.global_scale if v < 2 else
                                     jc.local_scale, solarize=v == 1)
                     for v in range(jc.n_views)]
            make = functools.partial(
                lambda o: jdino.make_dino_train_step(jc, o, TOTAL))
            extra = dict(teacher=teacher, center=center, total_steps=TOTAL)
        else:
            jc, tc = jsim.SimCLRConfig(encoder=vcfg, **kw), \
                tsim.SimCLRConfig(encoder=tcfg, **kw)
            params = draw(tsim.simclr_param_spec(tc))
            k_view, _ = jax.random.split(jax.random.fold_in(rng, 0))
            k0, k1 = jax.random.split(k_view)
            draws = [vitx_view_draws(k, jc, B, 32, 32, scale=jc.crop_scale,
                                     solarize=False) for k in (k0, k1)]
            make = functools.partial(jsim.make_simclr_train_step, jc)
            extra = {}

        def state(o, extra=extra, params=params):
            jp = jtree(params)
            init = () if isinstance(o, GradCapture) else o.init(jp)
            if family != "dino":
                return jstep.TrainState(step=jnp.zeros((), jnp.int32),
                                        params=jp, opt_state=init)
            return jdino.DINOState(step=jnp.zeros((), jnp.int32), params=jp,
                                   opt_state=init,
                                   teacher=jtree(extra["teacher"]),
                                   center=jnp.asarray(extra["center"]))

        cap, metrics = _vitx_dp_step(make(GradCapture()),
                                     state(GradCapture()), x, rng)
        grads = jax.tree.map(np.asarray, cap.params)
        js = state(opt)
        jparams, _ = adamw_update(opt)(cap.params, js.opt_state, js.params)
        out[family] = dict(metrics={k: float(v) for k, v in metrics.items()},
                           grads=grads, params=flat(jparams))
        payloads[family] = dict(cfg=tcfg.to_json(), family_kw=kw,
                                params=params, images=x, draws=draws,
                                **extra)
    return out, payloads


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    _, payloads = references()
    rdv = tmp_path_factory.mktemp("rdv") / "store"
    return spawn(H.run_families, 2, (["mae", "dino", "simclr"], payloads),
                 device="cpu", init_method=f"file://{rdv}")[0]


@pytest.mark.parametrize("family", ["mae", "dino", "simclr"])
def test_family_dp2_matches_vitx(port, family):
    """The port's dp=2 step against vitx's: every metric vitx reports
    (loss, grad_norm; DINO's teacher entropy and momentum; SimCLR's
    contrastive accuracy) at 1e-4, every gradient at 1e-4, the params
    after one AdamW step within the step's allowance."""
    ref, _ = references()
    jm, tm = ref[family]["metrics"], port[family]["metrics"]
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert rel_err(tm[k], jm[k]) <= TOL, (k, tm[k], jm[k])
    grads_close(port[family]["grads"], ref[family]["grads"],
                zero=ZERO.get(family, ()))
    gap = adam_step_gap(port[family]["grads"], flat(ref[family]["grads"]),
                        port[family]["params"], ref[family]["params"])
    assert gap <= 1.0, gap


def test_simclr_negatives_are_global(port):
    """At dp=2 SimCLR's loss is the single-device loss of the whole batch
    (vitx pins the same, ``tests/test_simclr.py``): the port's rank-local
    NT-Xent over its own rows alone would differ."""
    ref, payloads = references()
    p = payloads["simclr"]
    import torch

    from vitx_torch.interop.jax_params import simclr_params_from_jax

    ts = tsim.SimCLRConfig(encoder=configs()[1], **HEADS["simclr"])
    params = simclr_params_from_jax(p["params"], ts, device="cpu")
    with torch.no_grad():
        views = tsim.simclr_views(torch.from_numpy(p["images"]), ts,
                                  draws=p["draws"])
        whole, _ = tsim.simclr_loss_fn(params, views, ts)
        half = [tsim.simclr_loss_fn(params, tsim.simclr_views(
            torch.from_numpy(p["images"][i:i + 2]), ts,
            draws=H._rows(p["draws"], i, 2)), ts)[0] for i in (0, 2)]
    assert rel_err(port["simclr"]["metrics"]["loss"], float(whole)) <= TOL
    assert abs(float(sum(half)) / 2 - float(whole)) > 1e-3
