"""Plain PyTorch reference of the two VPT graphs the benchmark runs: the
foundation policy (openai/Video-Pre-Training lib/policy.py
``MinecraftAgentPolicy``) and the inverse dynamics model
(``InverseActionPolicy``), written as functions of a parameter dict.

Float32, no kernels, no cache objects, no batching tricks: every layer is
one ``torch.nn.functional`` call.  Parameter names are those of the
published torch state dict, so the benchmark loads one dict into the
program and hands the same dict to these functions.  Nothing here imports
the program.

Layer equations (lib/impala_cnn.py, lib/util.py, lib/xf.py,
lib/masked_attention.py, lib/action_head.py):

* frames / 255 (the IDM first through a conv3d over time, kernel (5, 1, 1));
* Impala CNN: per stack, norm → conv 3×3 → ReLU, max-pool 3/2/1,
  GroupNorm, then blocks ``x + c1(c0(x))`` with ``c = ReLU(conv(GN(x)))``;
  flatten channel-major, LayerNorm → dense 256 → ReLU; LayerNorm → linear
  hidsize → ReLU;
* residual blocks: ``xn = LN(x)``; ``x = xn + proj(attn(xn))`` (the
  attention's residual adds the normed input, as the published code does);
  ``x = x + mlp1(ReLU(mlp0(LN(x))))``.  Attention is over the
  ``maxlen`` cached keys and the chunk, logits ``QKᵀ/d`` plus a banded
  relative bias ``Σ_n R_n · b_nd[n, offset]``; "clipped_causal" masks
  keys outside the window or across an episode start;
* policy tail: ReLU → LN → linear → ReLU → LN; the IDM: ReLU → LN (its
  ``lastlayer`` result is discarded in the published code, so it is not
  computed here);
* heads: linear / temperature → log-softmax over each action's classes;
  value: linear, de-normalised by the EWMA statistics.

Under :func:`operands_in` every product (linear, convolution, the
attention's two matmuls) takes its operands rounded to a narrower float
format, each tensor scaled to the format's range as a float8 path scales
it, and sums in float32: the lower precision a control puts in the
program's place.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

NBASIS = 10  # relative-attention basis functions (lib/xf.py:260)
LN_EPS = 1e-5
NEG_BIAS = -1e9  # additive mask, as the published attention
CNN = "net.img_process.cnn"
BLOCKS = "net.recurrent_layer.blocks"
_OPERANDS: Optional[torch.dtype] = None  # the format products' operands are rounded to (operands_in)


@contextmanager
def operands_in(dtype: torch.dtype):
    """Round every product's operands to ``dtype`` (a float8 format) while
    inside: each tensor scaled so its largest magnitude is the format's
    largest, rounded, scaled back; the sums stay float32."""
    global _OPERANDS
    before, _OPERANDS = _OPERANDS, dtype
    try:
        yield
    finally:
        _OPERANDS = before


def _r(x: torch.Tensor) -> torch.Tensor:
    if _OPERANDS is None:
        return x
    scale = x.detach().abs().amax().clamp_min(1e-30) / torch.finfo(_OPERANDS).max
    return (x / scale).to(_OPERANDS).to(x.dtype) * scale


@dataclass(frozen=True)
class Arch:
    """The shapes the reference needs, read from a configuration file's
    ``policy_kwargs`` (the published ``.model`` kwargs)."""

    hidsize: int
    heads: int
    n_blocks: int
    maxlen: int
    chans: Tuple[int, ...]
    img: Tuple[int, int]
    in_chans: int
    conv3d: Optional[dict]
    mask_style: str
    pointwise_ratio: int
    head_shapes: Tuple[Tuple[str, Tuple[int, int]], ...]  # (key, (values, classes))
    temperature: float
    value_head: bool
    nblock: int = 2
    dense_out: int = 256

    @property
    def idm(self) -> bool:
        return self.conv3d is not None

    @property
    def cnn_out(self) -> int:
        h, w = self.img
        for _ in self.chans:
            h, w = (h + 1) // 2, (w + 1) // 2
        return self.chans[-1] * h * w


def arch_from_config(config: dict) -> Arch:
    """An :class:`Arch` from a configuration file (portbench/configs)."""
    kw = config["policy_kwargs"]
    if kw.get("recurrence_type") != "transformer":
        raise ValueError("the reference covers transformer policies only")
    if (kw.get("init_norm_kwargs") or {}).get("group_norm_groups") != 1:
        raise ValueError("the reference covers GroupNorm(1) Impala stacks only")
    conv3d = kw.get("conv3d_params")
    h, w, c = kw["img_shape"]
    in_chans = int(conv3d["inchan"]) if conv3d else int(c)
    if conv3d:  # the IDM predicts the factored space: 20 binary buttons, 2 camera axes of 11 bins
        heads = (("buttons", (20, 2)), ("camera", (2, 11)))
    else:  # the hierarchical joint space: 8641 button combinations, 121 camera bins
        heads = (("buttons", (1, 8641)), ("camera", (1, 121)))
    return Arch(
        hidsize=int(kw["hidsize"]),
        heads=int(kw["attention_heads"]),
        n_blocks=int(kw["n_recurrence_layers"]),
        maxlen=int(kw["attention_memory_size"]) - int(kw["timesteps"]),
        chans=tuple(int(kw["impala_width"] * x) for x in kw["impala_chans"]),
        img=(int(h), int(w)),
        in_chans=in_chans,
        conv3d=conv3d,
        mask_style=kw.get("attention_mask_style", "clipped_causal"),
        pointwise_ratio=int(kw.get("pointwise_ratio", 4)),
        head_shapes=heads,
        temperature=float(config.get("pi_head_kwargs", {}).get("temperature", 1.0)),
        value_head=not conv3d,
    )


def param_spec(arch: Arch) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """Every parameter and buffer as (name, shape, init, scale), init one of
    "normed" (rows of L2 norm ``scale``: the published fan-in init),
    "randn" (a normal times ``scale``), "ones", "zeros"."""
    spec = []

    def fanin(name, shape, scale=1.0, norm=None, bias=False):
        if norm is not None:
            spec.append((f"{name}.norm.weight", (norm,), "ones", 1.0))
            spec.append((f"{name}.norm.bias", (norm,), "zeros", 0.0))
        spec.append((f"{name}.layer.weight", shape, "normed", scale))
        if bias or norm is None:
            spec.append((f"{name}.layer.bias", (shape[0],), "zeros", 0.0))

    def linear(name, out, inp, scale, bias=True):
        spec.append((f"{name}.weight", (out, inp), "normed", scale))
        if bias:
            spec.append((f"{name}.bias", (out,), "zeros", 0.0))

    def norm(name, size):
        spec.append((f"{name}.weight", (size,), "ones", 1.0))
        spec.append((f"{name}.bias", (size,), "zeros", 0.0))

    c = arch.in_chans
    if arch.idm:
        p = arch.conv3d
        c = int(p["outchan"])
        fanin("net.conv3d_layer", (c, arch.in_chans, *p["kernel_size"]))
    block_scale = math.sqrt(math.sqrt(len(arch.chans)) / math.sqrt(arch.nblock))
    for i, out in enumerate(arch.chans):
        s = f"{CNN}.stacks.{i}"
        fanin(f"{s}.firstconv", (out, c, 3, 3), norm=c if (i > 0 or arch.idm) else None)
        norm(f"{s}.n", out)
        for j in range(arch.nblock):
            for k in (0, 1):
                fanin(f"{s}.blocks.{j}.conv{k}", (out, out, 3, 3), block_scale, norm=out)
        c = out
    fanin(f"{CNN}.dense", (arch.dense_out, arch.cnn_out), 1.4, norm=arch.cnn_out)
    fanin("net.img_process.linear", (arch.hidsize, arch.dense_out), norm=arch.dense_out)
    e, h = arch.hidsize, arch.heads
    s_b = arch.n_blocks ** -0.5 * 2 ** -0.5  # residual init scale, two branches a block
    for k in range(arch.n_blocks):
        b = f"{BLOCKS}.{k}"
        o = f"{b}.r.orc_block"
        norm(f"{b}.pre_r_ln", e)
        linear(f"{o}.q_layer", e, e, 0.1)
        linear(f"{o}.k_layer", e, e, 0.2, bias=False)
        linear(f"{o}.v_layer", e, e, math.sqrt(s_b), bias=False)
        linear(f"{o}.proj_layer", e, e, math.sqrt(s_b))
        linear(f"{o}.r_layer", NBASIS * h, e, 0.1)
        spec.append((f"{o}.b_nd", (NBASIS, arch.maxlen), "randn", 0.2))
        fanin(f"{b}.mlp0", (e * arch.pointwise_ratio, e), norm=e)
        fanin(f"{b}.mlp1", (e, e * arch.pointwise_ratio), s_b, bias=True)
    fanin("net.lastlayer", (e, e), norm=e)
    norm("net.final_ln", e)
    for key, (values, classes) in arch.head_shapes:
        rows = values * classes
        linear(f"pi_head.{key}.linear_layer", rows, e, 0.01 * math.sqrt(min(1.0, e / rows)))
    if arch.value_head:
        linear("value_head.linear", 1, e, 1.0)
        spec.append(("value_head.normalizer.running_mean", (1,), "zeros", 0.0))
        spec.append(("value_head.normalizer.running_mean_sq", (1,), "zeros", 0.0))
        spec.append(("value_head.normalizer.debiasing_term", (), "zeros", 0.0))
    return spec


def _fanin(p, name, x, kind, act=True, padding=1):
    if f"{name}.norm.weight" in p:
        w, b = p[f"{name}.norm.weight"], p[f"{name}.norm.bias"]
        x = F.layer_norm(x, w.shape, w, b, LN_EPS) if kind == "linear" else F.group_norm(x, 1, w, b, LN_EPS)
    w, b = _r(p[f"{name}.layer.weight"]), p.get(f"{name}.layer.bias")
    x = _r(x)
    if kind == "linear":
        x = F.linear(x, w, b)
    elif kind == "conv":
        x = F.conv2d(x, w, b, padding=padding)
    else:
        x = F.conv3d(x, w, b, padding=padding)
    return F.relu(x) if act else x


def _ln(p, name, x):
    w = p[f"{name}.weight"]
    return F.layer_norm(x, w.shape, w, p[f"{name}.bias"], LN_EPS)


def impala(p: Dict[str, torch.Tensor], arch: Arch, x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) float frames → (N, 256) CNN features."""
    for i in range(len(arch.chans)):
        s = f"{CNN}.stacks.{i}"
        x = _fanin(p, f"{s}.firstconv", x, "conv")
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        x = F.group_norm(x, 1, p[f"{s}.n.weight"], p[f"{s}.n.bias"], LN_EPS)
        for j in range(arch.nblock):
            b = f"{s}.blocks.{j}"
            x = x + _fanin(p, f"{b}.conv1", _fanin(p, f"{b}.conv0", x, "conv"), "conv")
    return _fanin(p, f"{CNN}.dense", x.flatten(1), "linear")


def embed(p: Dict[str, torch.Tensor], arch: Arch, frames: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) frames, uint8 or float in [0, 255], → (B, T, hidsize)."""
    b, t = frames.shape[:2]
    x = frames.float() / 255.0
    if arch.idm:
        c = arch.conv3d
        x = _fanin(p, "net.conv3d_layer", x.permute(0, 4, 1, 2, 3), "conv3d", padding=tuple(c["padding"]))
        x = x.transpose(1, 2).flatten(0, 1)  # (B·T, C', H, W)
    else:
        x = x.flatten(0, 1).permute(0, 3, 1, 2)
    x = impala(p, arch, x)
    return _fanin(p, "net.img_process.linear", x, "linear").reshape(b, t, -1)


def initial_state(arch: Arch, batch: int, device=None) -> List[Dict[str, torch.Tensor]]:
    """Zero keys and values of ``maxlen`` past steps a block, none of them valid."""
    shape = (batch, arch.maxlen, arch.hidsize)
    return [{"k": torch.zeros(shape, device=device), "v": torch.zeros(shape, device=device),
             "valid": torch.zeros((batch, arch.maxlen), dtype=torch.bool, device=device)}
            for _ in range(arch.n_blocks)]


def _episode_mask(first: torch.Tensor, valid: torch.Tensor, maxlen: int):
    """Which of the ``maxlen`` past keys and the chunk's own keys each query
    may see, and which of the last ``maxlen`` keys stay valid after the
    chunk.  A query sees a key in its window of ``maxlen`` steps (itself
    included) that belongs to its own episode: no episode start lies after
    the key and up to the query."""
    t = first.shape[1]
    T = maxlen + t
    starts = first.long().cumsum(1)  # episode starts so far in the chunk, per step
    offset = maxlen + torch.arange(t, device=first.device)[:, None] - torch.arange(T, device=first.device)[None]
    window = (offset >= 0) & (offset < maxlen)
    past = valid[:, None, :] & (starts[:, :, None] == 0)
    own = starts[:, :, None] == starts[:, None, :]
    mask = torch.cat([past, own], dim=2) & window[None]
    last = starts[:, -1:]
    after = torch.cat([valid & (last == 0), starts == last], dim=1)  # (B, T)
    return mask, after[:, -maxlen:]


def block(p, arch: Arch, k: int, x: torch.Tensor, first: torch.Tensor, state: Dict[str, torch.Tensor]):
    """One residual block over a (B, t, E) chunk; returns (x, state after)."""
    b = f"{BLOCKS}.{k}"
    o = f"{b}.r.orc_block"
    bsz, t, e = x.shape
    h = arch.heads
    d = e // h
    xn = _ln(p, f"{b}.pre_r_ln", x)
    xr = _r(xn)
    q = F.linear(xr, _r(p[f"{o}.q_layer.weight"]), p[f"{o}.q_layer.bias"])
    keys = torch.cat([state["k"], F.linear(xr, _r(p[f"{o}.k_layer.weight"]))], dim=1)
    values = torch.cat([state["v"], F.linear(xr, _r(p[f"{o}.v_layer.weight"]))], dim=1)
    T = keys.shape[1]

    def split(z):
        return z.reshape(bsz, z.shape[1], h, d).transpose(1, 2)

    logits = _r(split(q)) @ _r(split(keys)).transpose(-1, -2) / d
    r = F.linear(xr, _r(p[f"{o}.r_layer.weight"]), p[f"{o}.r_layer.bias"]).reshape(bsz, t, h, NBASIS).transpose(1, 2)
    offset = (T - t) + torch.arange(t, device=x.device)[:, None] - torch.arange(T, device=x.device)[None]
    band = (offset >= 0) & (offset < arch.maxlen)
    table = p[f"{o}.b_nd"][:, offset.clamp(0, arch.maxlen - 1)] * band  # (n, t, T)
    logits = logits + torch.einsum("bhtn,ntT->bhtT", r, table)
    valid = state["valid"]
    if arch.mask_style == "clipped_causal":
        mask, valid = _episode_mask(first, valid, arch.maxlen)
        logits = logits + torch.where(mask[:, None], 0.0, NEG_BIAS)
    attended = (_r(torch.softmax(logits, dim=-1)) @ _r(split(values))).transpose(1, 2).reshape(bsz, t, e)
    x = xn + F.linear(_r(attended), _r(p[f"{o}.proj_layer.weight"]), p[f"{o}.proj_layer.bias"])
    x = x + _fanin(p, f"{b}.mlp1", _fanin(p, f"{b}.mlp0", x, "linear"), "linear", act=False)
    return x, {"k": keys[:, -arch.maxlen:], "v": values[:, -arch.maxlen:], "valid": valid}


def heads(p, arch: Arch, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Blocks' output → {"buttons", "camera"} log-probabilities of shape
    (B, T, values, classes), and "vpred" (B, T) for the policy."""
    x = F.relu(x)
    if not arch.idm:
        x = _fanin(p, "net.lastlayer", x, "linear")
    x = _ln(p, "net.final_ln", x)
    out = {}
    for key, shape in arch.head_shapes:
        name = f"pi_head.{key}.linear_layer"
        z = F.linear(_r(x), _r(p[f"{name}.weight"]), p[f"{name}.bias"]) / arch.temperature
        out[key] = F.log_softmax(z.reshape(*z.shape[:-1], *shape), dim=-1)
    if arch.value_head:
        raw = F.linear(_r(x), _r(p["value_head.linear.weight"]), p["value_head.linear.bias"])[..., 0]
        n = "value_head.normalizer"
        debias = p[f"{n}.debiasing_term"].clamp_min(1e-5)
        mean, mean_sq = p[f"{n}.running_mean"] / debias, p[f"{n}.running_mean_sq"] / debias
        out["vpred"] = raw * torch.sqrt((mean_sq - mean ** 2).clamp_min(1e-2)) + mean
    return out


def forward(p, arch: Arch, frames: torch.Tensor, first: torch.Tensor, state):
    """The whole graph over a (B, T) chunk from ``state``: (heads, state after)."""
    x = embed(p, arch, frames)
    state_out = []
    for k in range(arch.n_blocks):
        x, s = block(p, arch, k, x, first, state[k])
        state_out.append(s)
    return heads(p, arch, x), state_out


def action_logprob(out: Dict[str, torch.Tensor], buttons: torch.Tensor, camera: torch.Tensor) -> torch.Tensor:
    """(B, T) log-probability of the joint actions (B, T) under the policy's heads."""
    lb = out["buttons"][..., 0, :].gather(-1, buttons[..., None].long())[..., 0]
    lc = out["camera"][..., 0, :].gather(-1, camera[..., None].long())[..., 0]
    return lb + lc
