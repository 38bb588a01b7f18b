"""Binary exchange with the C oracle (``csrc/vitc.c``, ``csrc/trainc.c``).

The counterpart of ``vitx/interop/cbin.py``, so that the port's fp32
forward and train step can be held against the C implementation as
vitx's are (``tests/test_c_oracle.py``). A ``model.bin`` is an 11-int32
little-endian header (magic 'VITC', version, image, patch, channels,
classes, embed, depth, heads, mlp_ratio, act) followed by the fp32 params
in vitc's carve order; the stacked ``wqkv`` leaf (L, E, 3, H, D) is the
(E, 3·H·D) per-layer row-major matrix vitc multiplies by, as it is. The
parameters may be tensors (on any device) or numpy arrays. The oracle is
compiled with ``gcc`` from the sources in ``csrc/``; nothing there is
edited.
"""

from __future__ import annotations

import struct
import subprocess

import numpy as np
import torch

from vitx_torch.core.config import ViTConfig

MAGIC = 0x43544956
_ACT = {"gelu": 0, "relu": 1}


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().float().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype="<f4")


def write_model_bin(path, params, cfg: ViTConfig) -> None:
    """``params`` of ``cfg`` as vitc's ``model.bin``; raises
    ``ValueError`` for every feature vitc does not implement."""
    if cfg.head_type != "reference":
        raise ValueError("vitc implements the reference head only")
    if cfg.qkv_bias:
        raise ValueError("vitc has no qkv bias")
    if cfg.final_norm:
        raise ValueError("vitc has no final norm")
    if cfg.mlp_ratio != 4:
        raise ValueError("vitc head assumes scratch >= 8E; keep mlp_ratio=4")
    if not cfg.proj_bias:
        raise ValueError("vitc's attention always adds a projection bias")
    if cfg.num_registers:
        raise ValueError("vitc has no register tokens")
    if cfg.stem != "patch":
        raise ValueError("vitc has no conv stem")
    if cfg.moe_experts:
        raise ValueError("vitc has no Soft-MoE blocks")
    if cfg.qk_norm:
        raise ValueError("vitc has no QK-Norm")
    if cfg.pos_embed != "learned":
        raise ValueError("vitc expects a learned positional table; "
                         "sincos2d/rope models have no pos_embed leaf")
    if cfg.mlp_act not in _ACT:
        raise ValueError(f"vitc implements {sorted(_ACT)} MLPs only, "
                         f"not {cfg.mlp_act!r}")
    b, h = params["blocks"], params["head"]
    order = [
        params["patch_embed"]["kernel"], params["patch_embed"]["bias"],
        _f32(params["cls_token"]).reshape(-1),
        _f32(params["pos_embed"]).reshape(cfg.seq_len, cfg.embed_dim),
        b["ln1_scale"], b["ln1_bias"], b["wqkv"], b["wo"], b["bo"],
        b["ln2_scale"], b["ln2_bias"], b["w1"], b["b1"], b["w2"], b["b2"],
        h["w1"], h["b1"], h["ln_scale"], h["ln_bias"], h["w2"], h["b2"],
    ]
    with open(path, "wb") as f:
        f.write(struct.pack(
            "<11i", MAGIC, 1, cfg.image_size, cfg.patch_size,
            cfg.num_channels, cfg.num_classes, cfg.embed_dim, cfg.depth,
            cfg.num_heads, cfg.mlp_ratio, _ACT[cfg.mlp_act]))
        for t in order:
            f.write(_f32(t).tobytes())


def write_input_bin(path, images) -> None:
    """(B, H, W, C) preprocessed images as vitc's input: int32 B, then
    the fp32 images."""
    images = _f32(images)
    with open(path, "wb") as f:
        f.write(struct.pack("<i", images.shape[0]))
        f.write(images.tobytes())


def read_output_bin(path, batch: int, classes: int) -> np.ndarray:
    """vitc's logits file -> (batch, classes) float32."""
    return np.fromfile(path, dtype="<f4").reshape(batch, classes)


def write_train_bin(path, images, labels) -> None:
    """A batch for trainc: int32 B, int32 labels, fp32 NHWC images."""
    images = _f32(images)
    labels = np.ascontiguousarray(
        labels.cpu().numpy() if torch.is_tensor(labels) else labels,
        dtype="<i4")
    with open(path, "wb") as f:
        f.write(struct.pack("<i", images.shape[0]))
        f.write(labels.tobytes())
        f.write(images.tobytes())


def read_model_bin(path, cfg: ViTConfig) -> np.ndarray:
    """A ``model.bin`` -> its flat fp32 parameter vector (past the header,
    whose 11 int32 take 11 fp32 slots)."""
    return np.fromfile(path, dtype="<f4")[11:]


def build_vitc(src, out, *, openmp: bool = False):
    """Compile ``src`` (``csrc/vitc.c`` or ``csrc/trainc.c``) with gcc
    into ``out``; returns ``out``."""
    cmd = ["gcc", "-O2", "-std=c99", "-o", str(out), str(src), "-lm"]
    if openmp:
        cmd[1:1] = ["-fopenmp", "-DOMP"]
    subprocess.run(cmd, check=True, capture_output=True)
    return out


def run_vitc(binary, model_bin, input_bin, output_bin) -> str:
    """One vitc forward; returns its standard output."""
    return subprocess.run([str(binary), str(model_bin), str(input_bin),
                           str(output_bin)], check=True, capture_output=True,
                          text=True).stdout


def run_trainc(binary, model_bin, data_bin, steps: int, lr: float,
               weight_decay: float, out_bin) -> list:
    """``steps`` AdamW steps of trainc on one batch; returns the losses it
    printed, one a step, and leaves the updated params in ``out_bin``."""
    out = subprocess.run(
        [str(binary), str(model_bin), str(data_bin), str(steps), str(lr),
         str(weight_decay), str(out_bin)], check=True, capture_output=True,
        text=True).stdout
    return [float(line.split()[-1]) for line in out.strip().splitlines()]
