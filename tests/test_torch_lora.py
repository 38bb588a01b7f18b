"""LoRA in the port (``vitx_torch.nn.lora``), on the CPU, against vitx.

At depth 2 of ``tiny`` (E 64, 4 heads) in fp32, with the adapters' B
factors filled so that they act: the parameter tree and its shapes are
vitx's; the adapted forward (attention targets, and all four) within
1e-4 of vitx's (max |a - b| over max |b|); ``merge_lora_params`` gives a
plain model whose forward is the adapted one, bit for bit; at init (B =
0) the adapted forward is the base model's bit for bit. One LoRA train
step (``train_filter="lora"`` and an optimizer of that policy) against
vitx's gradients and update (``tests/test_torch_finetune_knobs.py``'s
harness): the loss and the adapters' and heads' gradients within 1e-4,
the params in lr units, the base leaves bit-unchanged. ``.ckpt`` files of
LoRA runs cross both packages bit for bit; the Trainer writes and resumes
one, eval and serving fold the adapters in, and a reference ``.pt``
exports the merged weights.
"""

import json

import jax
import numpy as np
import pytest
import torch

import vitx
import vitx_torch
from tests.test_torch_finetune_knobs import (LR, batch,
                                             ckpt_cross_both_ways, configs,
                                             init, names, port_step_vs_vitx,
                                             rel_err)
from vitx_torch.nn.lora import has_lora, merge_block, merge_lora_params
from vitx_torch.nn.vit import model_logits
from vitx_torch.train import checkpoint as tckpt
from vitx_torch.train import loop as tloop
from vitx_torch.train import step as tstep

torch.set_num_threads(1)


def images(n=3, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, 64, 64, 3)).astype(np.float32)


@pytest.mark.parametrize("targets", ["attn", "all"])
def test_lora_tree_and_forward_match_vitx(targets):
    jcfg, tcfg = configs(lora_rank=4, lora_alpha=8.0, lora_targets=targets)
    spec = jax.eval_shape(lambda k: vitx.init_params(k, jcfg),
                          jax.random.PRNGKey(0))
    fresh = vitx_torch.init_params(0, tcfg, device="cpu")
    assert names(fresh) == ["/".join(str(k.key) for k in p) for p, _ in
                            jax.tree_util.tree_flatten_with_path(spec)[0]]
    assert [tuple(t.shape) for t in tstep.leaves(fresh)] == [
        s.shape for s in jax.tree.leaves(spec)]
    p = init(tcfg, lora_b=True)
    x = images()
    want = np.asarray(vitx.forward(p, x, jcfg))
    got = vitx_torch.forward(vitx_torch.params_from_jax(p, tcfg, "cpu"), x,
                             tcfg, device="cpu").numpy()
    assert rel_err(got, want) <= 1e-4


def test_merge_is_the_adapted_forward():
    """The merged plain model's logits equal the adapted ones bit for bit
    (the same fold, stacked or per block); the adapters change the
    function; at init (B = 0) the adapted model is the base model."""
    _, tcfg = configs(lora_rank=4, lora_targets="all")
    p = vitx_torch.params_from_jax(init(tcfg, lora_b=True), tcfg, "cpu")
    x = torch.from_numpy(images())
    with torch.no_grad():
        adapted = model_logits(p, x, tcfg)
        merged, mcfg = merge_lora_params(p, tcfg)
        assert not has_lora(merged) and has_lora(p) and mcfg.lora_rank == 0
        assert torch.equal(model_logits(merged, x, mcfg), adapted)
        base = {**p, "blocks": {k: v for k, v in p["blocks"].items()
                                if not k.startswith("lora_")}}
        assert (model_logits(base, x, mcfg) - adapted).abs().max() > 1e-4
        fresh = vitx_torch.init_params(0, tcfg, device="cpu")
        plain = {**fresh, "blocks": {k: v for k, v in fresh["blocks"].items()
                                     if not k.startswith("lora_")}}
        assert torch.equal(model_logits(fresh, x, tcfg),
                           model_logits(plain, x, mcfg))
    per_block = merge_block({k: v[1] for k, v in p["blocks"].items()}, tcfg)
    assert torch.equal(per_block["wqkv"], merged["blocks"]["wqkv"][1])


def test_lora_step_matches_vitx():
    """One step with the adapters and heads trainable: vitx's gradients
    and masked update; the base leaves unchanged bit for bit, moments only
    for the trainable leaves."""
    jcfg, tcfg = configs(lora_rank=4, lora_targets="all")
    tst = port_step_vs_vitx(jcfg, tcfg, init(tcfg, lora_b=True), batch(),
                            dict(lr=LR, trainable="lora"), "lora")
    assert all(k.startswith(("head/", "blocks/lora_"))
               for k in names(tst.opt_state.mu))


@pytest.mark.parametrize("run", ["lora", "lora_accum_cosine_ema"])
def test_lora_ckpt_cross_both_ways(tmp_path, run):
    """``.ckpt`` files of LoRA runs (masked moments; with accumulation, a
    cosine schedule and the EMA too) written by vitx and read by the port,
    and the other way, bit for bit (``ckpt_cross_both_ways``)."""
    ckpt_cross_both_ways(tmp_path, run)


def test_trainer_lora_run_eval_and_serve(tmp_path):
    """The Trainer defaults a LoRA config to ``train_filter="lora"``,
    records it in the meta, resumes from its ``.ckpt``; ``load_server``
    folds the adapters in: the same top-1 as the adapted forward; the
    reference ``.pt`` holds the merged weights and no moments."""
    from vitx_torch.data import BatchLoader, SyntheticDataset
    from vitx_torch.serve import load_server

    _, tcfg = configs(lora_rank=2)
    ds = SyntheticDataset(num_examples=16, image_size=64, num_classes=4,
                          seed=0)
    tc = tloop.TrainerConfig(epochs=1, lr=LR, checkpoint_dir=str(
        tmp_path / "ck"), log_every=1)
    tr = tloop.Trainer(tcfg, tc, device="cpu")
    start = {n: t.clone() for n, t in zip(names(tr.state.params),
                                          tstep.leaves(tr.state.params))}
    tr.fit(BatchLoader(ds, 8, shuffle=True))
    for n, t in zip(names(tr.state.params), tstep.leaves(tr.state.params)):
        frozen = not n.startswith(("head/", "blocks/lora_"))
        assert torch.equal(t, start[n]) == frozen, n
    meta = tckpt.peek_meta(tmp_path / "ck")
    assert meta["train_filter"] == "lora"
    again = tloop.Trainer(tcfg, tc, device="cpu")
    assert again.maybe_resume()["epoch"] == 0
    x = images(4)
    want = vitx_torch.forward(tr.state.params, x, tcfg, device="cpu")
    srv = load_server(tmp_path / "ck", tcfg, device="cpu", batch_size=4)
    try:
        assert srv.cfg.lora_rank == 0
        assert [srv.predict(im)["classes"][0] for im in x] == \
            want.argmax(-1).tolist()
    finally:
        srv.close()
    pt = tmp_path / "m.pt"
    tckpt.save_reference_pt(pt, tr.state.params, tcfg, epoch=0,
                            opt_state=tr.state.opt_state)
    back, _ = tckpt.load_reference_pt(pt, tcfg.replace(lora_rank=0),
                                      device="cpu")
    merged, _ = merge_lora_params(tr.state.params, tcfg)
    for a, b in zip(tstep.leaves(back), tstep.leaves(merged)):
        assert torch.equal(a, b)
    assert not torch.load(pt, weights_only=True)["optimizer_state_dict"][
        "state"]
    assert json.loads(json.dumps(meta["config"]))["lora_rank"] == 2


def test_init_lora_leaves_devices(monkeypatch):
    """The adapters' initialiser runs where ``init_params`` does: on the
    card by default (raising without one), on the CPU when asked."""
    from vitx_torch.nn.lora import init_lora_leaves, lora_spec

    cfg = vitx_torch.get_config("tiny", lora_rank=4)
    got = init_lora_leaves(0, cfg, device="cpu")
    assert sorted(got) == sorted(lora_spec(cfg))
    assert all(t.device.type == "cpu" for t in got.values())
    assert not got["lora_wqkv_b"].any() and got["lora_wqkv_a"].any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lora_leaves(0, cfg)
