"""Token merging (ToMe, Bolya et al. 2023) at inference and in training.

The counterpart of ``vitx/nn/tome.py``: between the attention and the MLP
of block ``l``, the ``cfg.tome_schedule[l]`` most similar pairs of patch
tokens are merged (a size-weighted average), so later blocks run on fewer
tokens; the attention logits take a ``log(size)`` bias per key
(proportional attention), so a merged token counts as many. Tokens stay
ordered [prefix | patches]; only patch tokens merge.

On a CUDA device each block's attention half is kernel B8
(``vitx_torch.kernels.fused_mha_block_tome``), which also returns the
head-mean key the merge reads, and its MLP half kernel K2, at whatever
token count the block has. The merge itself is plain torch, as it is XLA
in vitx: the selection by a stable sort (``jax.lax.top_k`` puts the lower
index first among equal scores; ``torch.topk`` promises no order) and the
scatter of merged tokens as fp32 one-hot products, which repeat bit for
bit where an ``index_add_`` would add duplicates with atomics.

Training through ToMe (``cfg.tome_train``, the paper's section 4) runs
the same encoder under autograd with dropout and drop-path from one
``torch.Generator``: gradients flow through the size-weighted merges, the
selection is routing and carries none. On CUDA B8's backward
differentiates ``composed_tome`` (its LayerNorm's backward B3).

On a tensor-parallel rank (``mesh=``, vitx's sharded eval and train
steps) the encoder runs vitx's two routes: with ``fuse_mha="on"`` B8
over every head on gathered weights (K2 too with ``fuse_mlp="on"``),
otherwise the Megatron split of ``composed_tome`` and the MLP.
"""

from __future__ import annotations

import torch

from vitx_torch.core.config import ViTConfig
from vitx_torch.core.device import card_routes
from vitx_torch.kernels.mha_block import composed_tome, fused_mha_block_tome
from vitx_torch.kernels.mlp_block import fused_mlp_block
from vitx_torch.nn.layers import drop_path, dropout, layer_norm, mlp
from vitx_torch.nn.vit import (ATTN_LEAVES, MLP_LEAVES, _final_norm, _tp,
                               _use_fused_mlp, drop_path_rates, embed_tokens,
                               gather_model_shards, merge_tp_lora, unstack)
from vitx_torch.parallel import comm
from vitx_torch.parallel.mesh import MODEL_AXIS


def parse_tome_r(s):
    """argparse type for ``--tome-r`` (``vitx/nn/tome.py:32-46``): a
    constant (``13``), a per-block schedule (``35,34``; shorter than the
    depth pads with zeros) or ``toN`` (``to128``), which
    ``aligned_schedule`` resolves against the model once it is known."""
    if isinstance(s, int):
        return s
    s = str(s).strip()
    if s.startswith("to") and s[2:].isdigit():
        return s
    parts = [p.strip() for p in s.split(",") if p.strip()]
    if len(parts) == 1:
        return int(parts[0])
    return tuple(int(p) for p in parts)


def aligned_schedule(cfg: ViTConfig, target_tokens: int = 128) -> tuple:
    """vitx's ``toN`` schedule (``vitx/nn/tome.py:49-79``): reach
    ``target_tokens`` tokens in all in the fewest leading blocks, spreading
    the merges evenly, with no block merging more than a third of the patch
    tokens it has left."""
    total = cfg.seq_len
    patches = cfg.num_patches
    if target_tokens >= total:
        raise ValueError(f"target_tokens={target_tokens} >= the model's "
                         f"{total} tokens — nothing to merge")
    floor = total - patches   # prefix + registers can never merge
    if target_tokens <= floor:
        raise ValueError(f"target_tokens={target_tokens} <= the "
                         f"{floor} protected (non-patch) tokens")
    needed = total - target_tokens
    for k in range(1, cfg.depth + 1):
        base, extra = divmod(needed, k)
        sched = tuple(base + (1 if l < extra else 0) for l in range(k))
        p = patches
        if all(r <= p // 3 and not (p := p - r) < 0 for r in sched):
            return sched
    raise ValueError(f"cannot reach target_tokens={target_tokens} within "
                     f"depth={cfg.depth} at <=1/3 of the patches per block")


def _use_fused_tome_attn(cfg: ViTConfig, x) -> bool:
    """vitx's rule (``vitx/nn/tome.py:82-91``) with "is this a TPU" read as
    ``card_routes`` (a CUDA device, or an export's trace). B8 takes a QKV
    bias, so, unlike K1's rule, ``bqkv`` does not force the composed
    path."""
    if cfg.parity == "bug_exact" or cfg.fuse_mha == "off":
        return False
    if cfg.fuse_mha == "on":
        return True
    return cfg.attn_impl in ("auto", "flash") and card_routes(x)


def _norm(m):
    """jnp.linalg.norm's rounding: squares in m's dtype, an fp32 sum cast
    back to m's dtype, then the root."""
    return (m * m).float().sum(dim=-1, keepdim=True).to(m.dtype).sqrt()


def _take(t, idx):
    """t[b, idx[b, i]] along dim 1, for (B, N) or (B, N, ...) tensors."""
    if t.dim() == 2:
        return t.gather(1, idx)
    return t.gather(1, idx[..., None].expand(-1, -1, *t.shape[2:]))


def merge_tokens(x, sizes, metric, r: int, n_prefix: int, n_reg: int,
                 sources=None):
    """One bipartite soft matching step (``vitx/nn/tome.py:94-182``).

    x: (B, T, E) tokens [prefix | patches | registers]; sizes: (B, T) fp32,
    the original tokens each stands for; metric: (B, T, D), the head-mean
    key; r: the tokens to remove; sources: optional (B, T, T0) map of the
    original tokens each token holds. The patch tokens split alternately
    into A (even) and B (odd); the r A tokens most similar (cosine, in
    fp32 of the metric normalised in its own dtype) to their best B match
    merge into it, size-weighted in fp32. Returns (x', sizes'), or (x',
    sizes', sources'), with T - r tokens in the same layout."""
    B, T, E = x.shape
    npatch = T - n_prefix - n_reg
    if not 0 < r <= npatch // 2:
        raise ValueError(f"tome r={r} needs 0 < r <= {npatch // 2} "
                         f"(half the {npatch} patch tokens)")
    p = slice(n_prefix, n_prefix + npatch)
    xp, sp, mp = x[:, p], sizes[:, p], metric[:, p]
    ma, mb = mp[:, 0::2], mp[:, 1::2]
    xa, xb = xp[:, 0::2], xp[:, 1::2]
    sa, sb = sp[:, 0::2], sp[:, 1::2]
    na, nb = ma.shape[1], mb.shape[1]

    ma = ma / _norm(ma).clamp_min(1e-6)
    mb = mb / _norm(mb).clamp_min(1e-6)
    scores = torch.matmul(ma.float(), mb.float().transpose(1, 2))
    best = scores.amax(dim=-1)                              # (B, na)
    dst = scores.argmax(dim=-1)                             # the first max
    # the r best A tokens, the lower index first among equal scores
    sel = torch.sort(best, dim=1, descending=True, stable=True).indices[:, :r]
    merged = torch.zeros((B, na), dtype=torch.uint8, device=x.device)
    merged.scatter_(1, sel, 1)

    dst_sel, sa_sel = dst.gather(1, sel), sa.gather(1, sel)
    onehot = torch.nn.functional.one_hot(dst_sel, nb).float()   # (B, r, nb)
    to_b = onehot.transpose(1, 2)                               # (B, nb, r)
    add_x = torch.matmul(to_b, _take(xa, sel).float() * sa_sel[..., None])
    add_s = torch.matmul(to_b, sa_sel.float()[..., None])[..., 0]
    sb_new = sb + add_s
    xb_new = ((xb.float() * sb[..., None] + add_x)
              / sb_new[..., None]).to(x.dtype)
    # the A tokens that stay, in their order (a stable sort puts them first)
    keep = torch.argsort(merged, dim=1, stable=True)[:, :na - r]

    def join(t, a, b_):
        return torch.cat([t[:, :n_prefix], a, b_, t[:, T - n_reg:T]], dim=1)

    x_out = join(x, _take(xa, keep), xb_new)
    s_out = join(sizes, sa.gather(1, keep), sb_new)
    if sources is None:
        return x_out, s_out
    srcp = sources[:, p]
    srca, srcb = srcp[:, 0::2], srcp[:, 1::2]
    srcb_new = srcb + torch.matmul(to_b, _take(srca, sel).float()).to(
        sources.dtype)
    return x_out, s_out, join(sources, _take(srca, keep), srcb_new)


def _attention(x, bp, cfg: ViTConfig, log_size, fused: bool, mesh):
    """Block ``bp``'s attention half on the tokens x -> (attn_out, the
    merge metric): B8 (``fused``) or ``composed_tome``. On a rank of a
    model axis, B8 runs every head on gathered weights (vitx's fused
    partition rule replicates them); ``composed_tome`` runs the rank's
    H/tp heads (the Megatron split): x and LN1's leaves enter through
    ``copy_to``, the partial out-projection leaves through
    ``reduce_from`` before ``bo``, and the metric, vitx's mean of the
    cast k over all H heads, is the rank's head mean summed over
    ``model`` and divided by tp."""
    dt = x.dtype
    split = _tp(mesh) and not fused
    if _tp(mesh) and fused:
        bp = gather_model_shards(bp, mesh, ATTN_LEAVES)
    H, D = bp["wqkv"].shape[-2], bp["wqkv"].shape[-1]
    bq = (bp["bqkv"].float() if "bqkv" in bp else
          torch.zeros((3, H, D), dtype=torch.float32, device=x.device))
    bo = (bp["bo"].float() if "bo" in bp and not split else
          torch.zeros(x.shape[-1], dtype=torch.float32, device=x.device))
    g, b = bp["ln1_scale"].float(), bp["ln1_bias"].float()
    if split:
        x, g, b = (comm.copy_to(t, mesh, MODEL_AXIS) for t in (x, g, b))
    out, k_mean = (fused_mha_block_tome if fused else composed_tome)(
        x, bp["wqkv"].to(dt), bq, bp["wo"].to(dt), bo, g, b, log_size,
        eps=cfg.layer_norm_eps)
    if not split:
        # on a model axis every rank runs B8 on the same bytes (x and the
        # gathered weights agree), so the metric agrees as well
        return out, k_mean
    out = comm.reduce_from(out, mesh, MODEL_AXIS)
    if "bo" in bp:
        out = out + bp["bo"].to(dt)
    # merge_tokens' indices come from the metric, so every model rank
    # must read the same bytes: the metric is the output of one
    # all-reduce, which hands every rank the same buffer (and x, the
    # other input of the merge, is built only from all-reduce outputs
    # and masks drawn alike). That costs nothing beyond the sum the mean
    # needs anyway, where broadcasting the indices would add a collective
    # and a second route through merge_tokens. Only the selection reads
    # the metric, so no gradient flows through the sum.
    k_sum = comm.all_reduce_(k_mean.detach().float().clone(), mesh,
                             MODEL_AXIS)
    return out, (k_sum / mesh.tp).to(dt)


def _mlp(x, bp, cfg: ViTConfig, fused: bool, mesh):
    """Block ``bp``'s MLP half on the merged tokens x: K2 (``fused``; on
    a rank of a model axis over gathered weights), or LN2 and the
    composed products (on such a rank split by columns and rows: the
    normalised tokens enter through ``copy_to``, the second product
    leaves through ``reduce_from`` before ``b2``)."""
    dt = x.dtype
    if fused:
        if _tp(mesh):
            bp = gather_model_shards(bp, mesh, MLP_LEAVES)
        return fused_mlp_block(
            x, bp["w1"].to(dt), bp["b1"].float(), bp["w2"].to(dt),
            bp["b2"].float(), bp["ln2_scale"].float(),
            bp["ln2_bias"].float(), act=cfg.mlp_act, eps=cfg.layer_norm_eps)
    h = layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], eps=cfg.layer_norm_eps)
    if not _tp(mesh):
        return mlp(h, bp["w1"], bp["b1"], bp["w2"], bp["b2"],
                   act=cfg.mlp_act, w3=bp.get("w3"), b3=bp.get("b3"))
    out = mlp(comm.copy_to(h, mesh, MODEL_AXIS), bp["w1"], bp["b1"],
              bp["w2"], torch.zeros_like(bp["b2"]), act=cfg.mlp_act,
              w3=bp.get("w3"), b3=bp.get("b3"))
    return comm.reduce_from(out, mesh, MODEL_AXIS) + bp["b2"].to(dt)


def encode_tome(params, images, cfg: ViTConfig,
                return_sources: bool = False, *, rng=None,
                deterministic: bool = True, mesh=None):
    """The ToMe encoder (``vitx/nn/tome.py:185-312``): images -> final
    tokens (B, T', E), and with ``return_sources`` also the (B, T', T0)
    fp32 partition of the original tokens among them.

    Block ``l``: the attention half (B8 on CUDA, else ``composed_tome``,
    by ``_use_fused_tome_attn``) on the tokens and log(sizes), the
    layer-scale multiply, ``x + attn_out``, ``merge_tokens`` with r =
    ``cfg.tome_schedule[l]``, the MLP half (K2 on CUDA), ``x + mlp_out``:
    the residual adds in vitx's order, not ``_encoder_block``'s carry.

    Training mode (``cfg.tome_train``): with a generator ``rng`` and
    ``deterministic=False``, dropout on the embedded tokens, then on each
    branch dropout and drop-path at ``linspace(0, cfg.drop_path,
    depth)[l]`` before its residual add, drawn in that order (vitx splits
    its key the same way, ``tome.py:213-256``; the streams differ).

    ``mesh``: a rank of a sharded step whose params are its shards. On a
    ``model`` axis each half runs as ``_attention`` and ``_mlp`` say, the
    stream of tokens whole and the same on every model rank (the merge
    included), its dropout and drop-path masks drawn alike on each, as
    in ``_tp_block``. ``cfg.sp`` is not read: vitx's merging encoder
    puts no sequence constraint on the tokens."""
    x = embed_tokens(params, images, cfg)
    stochastic = rng is not None and not deterministic
    if stochastic:
        x = dropout(x, cfg.dropout, rng, deterministic=False)
    B, T, E = x.shape
    dt, dev = x.dtype, x.device
    use_attn = _use_fused_tome_attn(cfg, x)
    use_mlp = _use_fused_mlp(cfg, x)
    sizes = torch.ones((B, T), dtype=torch.float32, device=dev)
    sources = (torch.eye(T, dtype=torch.float32, device=dev).expand(B, T, T)
               if return_sources else None)
    n_pre, n_reg = cfg.num_prefix_tokens, cfg.num_registers
    dp_rates = drop_path_rates(cfg, cfg.depth, not stochastic)

    def branch(out, rate):
        if not stochastic:
            return out
        out = dropout(out, cfg.dropout, rng, deterministic=False)
        if cfg.drop_path:
            out = drop_path(out, rate, rng, deterministic=False)
        return out

    for bp, r, rate in zip(unstack(params["blocks"]), cfg.tome_schedule,
                           dp_rates):
        if cfg.lora_rank:
            bp = merge_tp_lora(bp, cfg, mesh)
        attn_out, k_mean = _attention(x, bp, cfg, torch.log(sizes),
                                      use_attn, mesh)
        if "ls1" in bp:
            attn_out = attn_out * bp["ls1"].to(dt)
        x = x + branch(attn_out, rate)
        if r and sources is not None:
            x, sizes, sources = merge_tokens(x, sizes, k_mean, r, n_pre,
                                             n_reg, sources=sources)
        elif r:
            x, sizes = merge_tokens(x, sizes, k_mean, r, n_pre, n_reg)
        mlp_out = _mlp(x, bp, cfg, use_mlp, mesh)
        if "ls2" in bp:
            mlp_out = mlp_out * bp["ls2"].to(dt)
        x = x + branch(mlp_out, rate)
    x = _final_norm(params, x, cfg)
    return (x, sources) if return_sources else x


def tome_patch_assignment(sources, cfg: ViTConfig):
    """A source map from ``encode_tome(..., return_sources=True)`` ->
    (B, grid, grid) int64: for every original patch, the index of the
    final token that absorbed it (``vitx/nn/tome.py:315-325``)."""
    n_pre = cfg.num_prefix_tokens
    owner = sources[:, :, n_pre:n_pre + cfg.num_patches].argmax(dim=1)
    return owner.reshape(-1, cfg.grid_size, cfg.grid_size)
