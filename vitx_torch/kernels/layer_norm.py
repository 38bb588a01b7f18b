"""LayerNorm kernels: the backward (B3, which also serves B11) and the
forward behind the ``fused_layer_norm`` entries (B10).

- ``ln_bwd`` launches the Hopper kernel ``csrc/layer_norm_bwd.cu`` on CUDA
  tensors and runs ``ln_bwd_plain``, the same math in plain torch, on CPU
  tensors. It replaces ``vitx/kernels/layer_norm.py::_ln_bwd3_kernel``
  (entry ``ln_bwd``), which every LayerNorm backward of vitx's train step
  runs through on the TPU. vitx gates it on ``E % 128 == 0``
  (``nn/layers.py:48``), a fact of the TPU's lanes: here every width takes
  the kernel, on one of two routes chosen here in the open
  (``ln_bwd_route``): the one-pass route (x and dy read once, 16-byte
  vectors held in registers, column partials per block, then one small
  reduction launch) where E is a multiple of the 16-byte vector and at
  most 4096, the earlier three launches elsewhere.
- ``fused_layer_norm(x, scale, bias)`` and ``fused_add_layer_norm(x, r,
  scale, bias) -> (x + r, LN(x + r))`` launch ``csrc/layer_norm_fwd.cu`` on
  CUDA tensors and run ``layer_norm_fwd_plain`` on CPU tensors, any leading
  dims. They replace vitx's entries of the same names
  (``layer_norm.py:273-321``) and their kernel ``_ln_kernel`` (B10), on
  one of two routes (``ln_fwd_route``): the one-pass route (each row read
  once into registers as 16-byte vectors, the next row in flight while it
  reduces, scale and bias held in registers) on B3's rule, the earlier
  kernel (one warp walking a row three times) elsewhere. Their
  backward is vitx's ``_ln_bwd_kernel`` (B11): B3's function on the 2-D
  (R, E) view, its per-block partials summed outside, which ``ln_bwd``
  computes at any rank -- B3's kernel on CUDA. As in vitx, the model does
  not call them: its LayerNorm forward stays plain torch
  (``vitx_torch/nn/layers.py``), as vitx's stays XLA.
"""

from __future__ import annotations

import torch

from vitx_torch.kernels import _build
from vitx_torch.kernels._build import DTYPE_CODES
from vitx_torch.nn.layers import (_add_ln_forward, _AddLayerNorm,
                                  _LayerNorm, _ln_forward)

# csrc/layer_norm_bwd.cu's routes
LN_ROUTE_ONEPASS = 1
ONEPASS_MAX_E = 4096     # LN1_MAX_E
ONEPASS_MAX_NV = 4       # LN1_MAX_NV: 16-byte vectors of a row a thread holds
ONEPASS_THREADS = 256    # LN1_NT
ONEPASS_BLOCKS_PER_SM = 2
ROWS_PER_CHUNK = 64   # rows per partial column sum on the earlier route


def ln_bwd_plain(x, scale, dy, *, eps: float = 1e-5):
    """The plain torch version: fp32 two-pass statistics recomputed from x,
    ``dx = inv * (gs - mean(gs) - xhat * mean(gs * xhat))`` with
    ``gs = dy * scale``, cast to x's dtype; dscale and dbias summed over
    every leading axis in fp32 (``vitx/nn/layers.py:26-41``)."""
    x32, g32, s32 = x.float(), dy.float(), scale.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = (x32 - mean) * inv
    gs = g32 * s32
    m1 = gs.mean(dim=-1, keepdim=True)
    m2 = (gs * xhat).mean(dim=-1, keepdim=True)
    dx = (inv * (gs - m1 - xhat * m2)).to(x.dtype)
    red = tuple(range(x.dim() - 1))
    return dx, (g32 * xhat).sum(dim=red), g32.sum(dim=red)


def _check(x, scale, dy):
    if x.dim() < 2:
        raise ValueError(f"ln_bwd takes (..., E) with a leading axis, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"ln_bwd takes float32 or bfloat16, got {x.dtype}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy must be {x.dtype} {tuple(x.shape)} like x, got "
                         f"{dy.dtype} {tuple(dy.shape)}")
    E = x.shape[-1]
    if tuple(scale.shape) != (E,) or not scale.is_floating_point():
        raise ValueError(f"scale must be a float ({E},), got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    for name, t in (("scale", scale), ("dy", dy)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def ln_bwd_route(dtype, E: int, tensors=()) -> int:
    """The route of an ``ln_bwd`` launch: ``LN_ROUTE_ONEPASS`` for float32
    or bfloat16 rows whose width E is a multiple of the 16-byte vector (4
    or 8 elements) and at most ``ONEPASS_MAX_E``, ``tensors`` (x and dy)
    16-byte aligned; 0, the earlier three launches, otherwise."""
    if dtype not in DTYPE_CODES:
        return 0
    vec = 16 // (torch.finfo(dtype).bits // 8)
    ok = (E % vec == 0 and E <= ONEPASS_MAX_E
          and all(t.data_ptr() % 16 == 0 for t in tensors))
    return LN_ROUTE_ONEPASS if ok else 0


def onepass_grid(R: int, E: int, dtype, sms: int) -> dict:
    """The one-pass route's layout for R rows of width E on a card of
    ``sms`` SMs, as ``csrc/layer_norm_bwd.cu`` takes it: ``wpr`` warps a
    row (the fewest of 1, 2, 4, 8 whose threads hold a row in at most
    ``ONEPASS_MAX_NV`` 16-byte vectors each), ``nv`` vectors a thread,
    ``groups`` rows in flight a block; ``blocks`` blocks (at most
    ``ONEPASS_BLOCKS_PER_SM`` an SM) of ``rows_per_block`` contiguous rows,
    group g of a block taking its rows g, g + groups, ...."""
    vec = 16 // (torch.finfo(dtype).bits // 8)
    nvec = E // vec
    wpr = 1
    while nvec > ONEPASS_MAX_NV * 32 * wpr:
        wpr *= 2
    groups = ONEPASS_THREADS // (32 * wpr)
    blocks = max(1, min(sms * ONEPASS_BLOCKS_PER_SM, -(-R // groups)))
    rows_per_block = -(-R // blocks)
    return {"wpr": wpr, "nv": -(-nvec // (32 * wpr)), "groups": groups,
            "blocks": -(-R // rows_per_block),
            "rows_per_block": rows_per_block}


_sm_counts: dict = {}


def _sms(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _launch(x2, s, dy2, eps, route):
    """``csrc/layer_norm_bwd.cu`` on (R, E) contiguous CUDA rows and an
    fp32 scale -> (dx, dscale, dbias), on ``route``; counts nothing."""
    R, E = x2.shape
    dev = x2.device
    dx = torch.empty_like(x2)
    dscale = torch.empty(E, dtype=torch.float32, device=dev)
    dbias = torch.empty(E, dtype=torch.float32, device=dev)
    if route == LN_ROUTE_ONEPASS:
        grid = onepass_grid(R, E, x2.dtype, _sms(dev))
        blocks, rpb = grid["blocks"], grid["rows_per_block"]
        stats = None
        part = torch.empty(blocks * 2 * E, dtype=torch.float32, device=dev)
    else:
        blocks = rpb = 0
        stats = torch.empty(2 * R, dtype=torch.float32, device=dev)
        part = torch.empty(-(-R // ROWS_PER_CHUNK) * 2 * E,
                           dtype=torch.float32, device=dev)
    fn = _build.entry("layer_norm_bwd")
    with torch.cuda.device(dev):
        err = fn(DTYPE_CODES[x2.dtype], route, x2.data_ptr(), s.data_ptr(),
                 dy2.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
                 dbias.data_ptr(), None if stats is None else stats.data_ptr(),
                 part.data_ptr(), R, E, blocks, rpb, float(eps),
                 torch.cuda.current_stream().cuda_stream)
    _build.check("layer_norm_bwd", err)
    return dx, dscale, dbias


def ln_bwd(x, scale, dy, *, eps: float = 1e-5):
    """LayerNorm backward over the last axis of (..., E) x and dy (any rank
    >= 2: (B, T, E) for the blocks, (B, 4E) for the reference head).

    Returns (dx in x's dtype, dscale fp32 (E,), dbias fp32 (E,)). CUDA
    tensors go through the kernel and add one to ``ln_bwd.launches`` (and
    to ``launches_onepass`` on the one-pass route, ``ln_bwd_route``); CPU
    tensors take the plain version.
    """
    _check(x, scale, dy)
    if x.device.type == "cpu":
        return ln_bwd_plain(x, scale, dy, eps=eps)
    if not x.is_cuda:
        raise ValueError(f"ln_bwd runs on cuda or cpu, not {x.device}")
    E = x.shape[-1]
    x2 = x.reshape(-1, E).contiguous()
    dy2 = dy.reshape(-1, E).contiguous()
    route = ln_bwd_route(x.dtype, E, (x2, dy2))
    dx, dscale, dbias = _launch(x2, scale.float().contiguous(), dy2, eps,
                                route)
    ln_bwd.launches += 1
    if route == LN_ROUTE_ONEPASS:
        ln_bwd.launches_onepass += 1
    return dx.reshape(x.shape), dscale, dbias


ln_bwd.launches = 0
ln_bwd.launches_onepass = 0


# --- B10: the forward entries, and B11 through B3 ---------------------------

def layer_norm_fwd_plain(x, scale, bias, r=None, *, eps: float = 1e-5):
    """The plain torch version of B10 (``layer_norm.py:59-70``): LN(x)
    with fp32 two-pass statistics, ``((x - mean) * inv) * scale + bias``
    cast once to x's dtype; with ``r``, s = cast(fp32(x) + fp32(r)) and
    (s, LN(s)), the statistics those of the cast s. These are the model's
    own LayerNorm forwards (``vitx_torch/nn/layers.py``)."""
    if r is None:
        return _ln_forward(x, scale, bias, eps)
    return _add_ln_forward(x, r, scale, bias, eps)


def _check_fwd(x, scale, bias, r):
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"fused_layer_norm takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"x must be a non-empty (..., E), got "
                         f"{tuple(x.shape)}")
    E = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (E,) or not t.is_floating_point():
            raise ValueError(f"{name} must be a float ({E},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    if r is not None and (r.shape != x.shape or r.dtype != x.dtype):
        raise ValueError(f"r must be {x.dtype} {tuple(x.shape)} like x, got "
                         f"{r.dtype} {tuple(r.shape)}")
    for name, t in (("scale", scale), ("bias", bias), ("r", r)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def ln_fwd_route(dtype, E: int, tensors=()) -> int:
    """The route of a B10 launch: ``LN_ROUTE_ONEPASS`` on the same rule as
    ``ln_bwd_route`` -- float32 or bfloat16 rows whose width E is a
    multiple of the 16-byte vector and at most ``ONEPASS_MAX_E``, every
    tensor in ``tensors`` (x, y, scale, bias, and r and the sum) 16-byte
    aligned; 0, the earlier kernel, otherwise. Its grid is
    ``onepass_grid``'s, whose blocks do not change a bit of the result:
    each row is reduced by one row group."""
    return ln_bwd_route(dtype, E, tensors)


def _launch_fwd(x, r, scale, bias, eps, route=None):
    """``csrc/layer_norm_fwd.cu`` on contiguous CUDA (..., E) x (and r) and
    contiguous fp32 scale and bias -> (y, s or None, route): ``route``
    defaults to ``ln_fwd_route``'s; counts nothing."""
    E = x.shape[-1]
    R = x.numel() // E
    y = torch.empty_like(x)
    s = None if r is None else torch.empty_like(x)
    if route is None:
        ts = (x, y, scale, bias) if r is None else (x, y, scale, bias, r, s)
        route = ln_fwd_route(x.dtype, E, ts)
    blocks = rpb = 0
    if route == LN_ROUTE_ONEPASS:
        grid = onepass_grid(R, E, x.dtype, _sms(x.device))
        blocks, rpb = grid["blocks"], grid["rows_per_block"]
    fn = _build.entry("layer_norm_fwd")
    with torch.cuda.device(x.device):
        err = fn(DTYPE_CODES[x.dtype], route, x.data_ptr(),
                 None if r is None else r.data_ptr(), scale.data_ptr(),
                 bias.data_ptr(), None if s is None else s.data_ptr(),
                 y.data_ptr(), R, E, blocks, rpb, float(eps),
                 torch.cuda.current_stream().cuda_stream)
    _build.check("layer_norm_fwd", err)
    return y, s, route


def _f32(t):
    """t as contiguous fp32, t itself where it already is."""
    if t.dtype == torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def _b10(x, scale, bias, eps, r=None):
    """B10 on CUDA (adding one to the entry's ``launches``, and to its
    ``launches_onepass`` on the one-pass route), the plain version on the
    CPU: y, or (s, y) with ``r``. Contiguous x, r and fp32 scale and bias
    are used as they are."""
    if x.device.type == "cpu":
        return layer_norm_fwd_plain(x, scale, bias, r, eps=eps)
    if not x.is_cuda:
        raise ValueError(f"fused_layer_norm runs on cuda or cpu, not "
                         f"{x.device}")
    if not x.is_contiguous():
        x = x.contiguous()
    if r is not None and not r.is_contiguous():
        r = r.contiguous()
    y, s, route = _launch_fwd(x, r, _f32(scale), _f32(bias), eps)
    entry = fused_layer_norm if r is None else fused_add_layer_norm
    entry.launches += 1
    if route == LN_ROUTE_ONEPASS:
        entry.launches_onepass += 1
    return y if s is None else (s, y)


def _b10_add(x, r, scale, bias, eps):
    return _b10(x, scale, bias, eps, r)


# The entries' backward is the model's: ``_LayerNorm`` and ``_AddLayerNorm``
# take B10 as their forward and keep their backward, B11's function on the
# (R, E) view through ``ln_bwd`` (B3's kernel on CUDA), with dscale and
# dbias in the scale's dtype as ``layer_norm.py:285-291`` casts them; in the
# add variant the sum's cotangent joins dx, returned for x and r
# (``layer_norm.py:306-318``). ``ln_bwd`` takes a leading axis, so a 1-D x
# goes through as one row.

def fused_layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis of (..., E) x, any leading dims, in
    x's dtype; scale and bias (E,). Differentiable (B11 backward). CUDA
    tensors go through B10 and add one to ``fused_layer_norm.launches``
    (and to ``launches_onepass`` on the one-pass route, ``ln_fwd_route``);
    CPU tensors take the plain version."""
    _check_fwd(x, scale, bias, None)
    if x.dim() == 1:
        return fused_layer_norm(x[None], scale, bias, eps)[0]
    if not _build.needs_grad(x, scale, bias):
        return _b10(x, scale, bias, eps)
    return _LayerNorm.apply(x, scale, bias, float(eps), _b10)


def fused_add_layer_norm(x, r, scale, bias, eps: float = 1e-5):
    """-> (x + r, LN(x + r)) in one pass, the pre-LN residual pattern: the
    sum is cast to x's dtype and normalised as cast. Differentiable (B11
    backward). CUDA tensors go through B10 and add one to
    ``fused_add_layer_norm.launches`` (and to ``launches_onepass`` on the
    one-pass route); CPU tensors take the plain version."""
    _check_fwd(x, scale, bias, r)
    if x.dim() == 1:
        s, y = fused_add_layer_norm(x[None], r[None], scale, bias, eps)
        return s[0], y[0]
    if not _build.needs_grad(x, r, scale, bias):
        return _b10(x, scale, bias, eps, r)
    return _AddLayerNorm.apply(x, r, scale, bias, float(eps), _b10_add)


fused_layer_norm.launches = 0
fused_layer_norm.launches_onepass = 0
fused_add_layer_norm.launches = 0
fused_add_layer_norm.launches_onepass = 0
