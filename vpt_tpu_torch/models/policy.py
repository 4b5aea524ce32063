"""The two VPT model graphs, the agent policy and the inverse dynamics model
(counterpart of vpt_tpu/models/policy.py; reference lib/policy.py).

Flow (policy, reference policy.py:193-218):
    uint8 frames (B, T, H, W, C) → ImgPreprocessing (/255) → ImpalaCNN →
    linear → hidsize → [pre_lstm_ln] → n × ResidualRecurrentBlock →
    ReLU → lastlayer (LN → linear → ReLU) → final LayerNorm →
    {pi_head (dict of categoricals), value_head (ScaledMSE)}

Flow (IDM, reference policy.py:374-392): a conv3d front end over
(B, C, T, H, W) before the Impala stack, unmasked attention, no value head,
and ``final_ln`` applied to the activations *before* ``lastlayer``, whose
result is computed and discarded (the reference's quirk, kept so that the
parameter exists for checkpoints).

The recurrent state (per-block KV caches and state masks, or LSTM carries;
None for ``recurrence_type="none"``) is an explicit argument and return
value, as in the JAX package.  Module and parameter names follow the
reference's torch state_dict.

``MinecraftAgentPolicy`` also has the reference API: ``embed`` and
``heads_from_recurrent`` (``forward`` is
``heads_from_recurrent(recurrent_layer(embed(img)))``),
``get_output_for_observation``, ``v`` and ``act``, with the module functions
``get_logprob_of_action`` and ``get_kl_of_action_dists``.

With ``cfg.quantize_dense`` the trunk's dense layers (the CNN → hidsize
projection ``linear``, the blocks' q/k/v/proj/r and MLPs, ``lastlayer``)
are int8 ``QuantLinear`` layers, as in the JAX package; the Impala
``dense``, the convolutions and the pi and value heads stay float.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vpt_tpu_torch.config import PolicyConfig
from vpt_tpu_torch.device import torch_dtype
from vpt_tpu_torch.models.heads import DictActionHead, HeadSpec, ScaledMSEHead, dict_kl, dict_logprob, dict_sample
from vpt_tpu_torch.models.impala import ImpalaCNN, fold_frames
from vpt_tpu_torch.models.layers import REMAT_CNN_SPAN, FanInInitLayer, LayerNorm, remat_call
from vpt_tpu_torch.models.transformer import (
    ResidualRecurrentBlocks,
    lstm_initial_state,
    masked_attention_initial_state,
    ring_initial_state,
)
from vpt_tpu_torch.utils.profiling import span

# the graphs' three parts, as spans (utils/profiling.py): every path through
# either policy (forward, and the split API that sp and pp drive) opens them
CNN_SPAN, BLOCKS_SPAN, HEADS_SPAN = "vpt_torch.policy.cnn", "vpt_torch.policy.blocks", "vpt_torch.policy.heads"


class ImgPreprocessing(nn.Module):
    """uint8 → float32, scaled by 1/255 or normalised by dataset statistics
    (reference: policy.py:21-45).  ``img_statistics`` is an npz with full
    ``mean``/``std`` images, held as the buffers ``img_mean``/``img_std``."""

    def __init__(self, scale_img: bool = True, img_statistics: Optional[str] = None, device=None):
        super().__init__()
        self.scale_img = scale_img
        self.has_stats = img_statistics is not None
        if self.has_stats:
            with np.load(img_statistics) as stats:
                mean, std = stats["mean"], stats["std"]
            self.register_buffer("img_mean", torch.as_tensor(mean, dtype=torch.float32, device=device))
            self.register_buffer("img_std", torch.as_tensor(std, dtype=torch.float32, device=device))

    def forward(self, img):
        x = img.float()
        if self.has_stats:
            return (x - self.img_mean) / self.img_std
        return x / (255.0 if self.scale_img else 1.0)


class ImgObsProcess(nn.Module):
    """ImpalaCNN followed by a linear projection to hidsize
    (reference: policy.py:48-80).

    With ``cnn_scan_chunks`` the (B·T)-folded CNN runs as a loop over that
    many frame chunks where they divide B·T (vpt_tpu/models/policy.py scans
    them); per-stack remat is then off, and with ``remat`` each chunk's whole
    CNN is recomputed in the backward instead, so the CNN's activations live
    for one chunk at a time."""

    def __init__(self, cfg: PolicyConfig, device=None):
        super().__init__()
        dtype = torch_dtype(cfg.compute_dtype)
        self.remat = cfg.remat
        self.cnn_scan_chunks = cfg.cnn_scan_chunks
        self.cnn = ImpalaCNN(
            inshape=cfg.img_shape, chans=cfg.chans, outsize=cfg.obs_processing_width,
            nblock=cfg.impala_nblock, post_pool_groups=cfg.impala_post_pool_groups,
            batch_norm=cfg.batch_norm, group_norm_groups=cfg.group_norm_groups, first_conv_norm=cfg.first_conv_norm,
            dense_layer_norm=cfg.dense_use_layer_norm, dtype=dtype, remat=cfg.remat, device=device,
        )
        self.linear = FanInInitLayer(cfg.obs_processing_width, cfg.hidsize, layer_type="linear",
                                     layer_norm=cfg.dense_use_layer_norm, dtype=dtype, device=device,
                                     quantize=cfg.quantize_dense)

    def forward(self, x):
        """(B, T, H, W, C) frames → (B, T, hidsize)."""
        return self.forward_nchw(fold_frames(x), *x.shape[:2])

    def forward_nchw(self, x: torch.Tensor, b: int, t: int) -> torch.Tensor:
        """(B·T, C, H, W) frames → (B, T, hidsize)."""
        return self.linear(self._cnn(x).reshape(b, t, -1))

    def _cnn_chunk(self, x: torch.Tensor) -> torch.Tensor:
        return self.cnn.forward_nchw(x, remat=False)

    def _cnn(self, x: torch.Tensor) -> torch.Tensor:
        chunks, n = self.cnn_scan_chunks, x.shape[0]
        if not (chunks > 1 and n % chunks == 0 and n > chunks):
            return self.cnn.forward_nchw(x)
        if self.remat:
            return torch.cat([remat_call(self._cnn_chunk, xc, span_name=REMAT_CNN_SPAN) for xc in x.chunk(chunks)])
        return torch.cat([self._cnn_chunk(xc) for xc in x.chunk(chunks)])


class MinecraftPolicy(nn.Module):
    """Latent trunk: vision → recurrence → pi/vf latents
    (reference: policy.py:83-224)."""

    def __init__(self, cfg: PolicyConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.compute_dtype)
        self.img_preprocess = ImgPreprocessing(cfg.scale_input_img, cfg.img_statistics, device)
        self.img_process = ImgObsProcess(cfg, device)
        self.pre_lstm_ln = LayerNorm(cfg.hidsize, device=device) if cfg.use_pre_lstm_ln else None
        # recurrence_type "none": no recurrent layer, the state passes through (vpt_tpu/models/policy.py)
        self.recurrent_layer = _recurrent_layer(cfg, dtype, device) if cfg.recurrence_type != "none" else None
        self.lastlayer = FanInInitLayer(cfg.hidsize, cfg.hidsize, layer_type="linear",
                                        layer_norm=cfg.dense_use_layer_norm, dtype=dtype, device=device,
                                        quantize=cfg.quantize_dense)
        self.final_ln = LayerNorm(cfg.hidsize, device=device)

    def embed(self, img):
        """Pre-recurrence trunk: preprocess → CNN → [pre_lstm_ln] latents."""
        with span(CNN_SPAN):
            x = self.img_process(self.img_preprocess(img))
            return self.pre_lstm_ln(x) if self.pre_lstm_ln is not None else x

    def recurrent(self, x, first, state):
        if self.recurrent_layer is None:
            return x, state
        with span(BLOCKS_SPAN):
            return self.recurrent_layer(x, first, state)

    def latent(self, x):
        """Post-recurrence trunk: relu → lastlayer → final_ln."""
        return self.final_ln(self.lastlayer(F.relu(x)))


class MinecraftAgentPolicy(nn.Module):
    """Trunk + action head + value head (reference: policy.py:227-269)."""

    def __init__(self, cfg: PolicyConfig, head_specs: Tuple[HeadSpec, ...],
                 temperature: float = 1.0, device=None):
        super().__init__()
        self.cfg = cfg
        self.head_specs = head_specs
        dtype = torch_dtype(cfg.compute_dtype)
        self.net = MinecraftPolicy(cfg, device)
        self.value_head = ScaledMSEHead(cfg.hidsize, output_size=1, norm_axes=2,
                                        dtype=dtype, device=device)
        self.pi_head = DictActionHead(cfg.hidsize, head_specs, temperature, dtype, device)

    def forward(self, img, first, state, action_mask: Optional[Dict] = None):
        """:param img: (B, T, H, W, C) uint8; first: (B, T) bool
        :returns: ({"pi_logits": dict, "vpred_raw": (B, T, 1), "vpred":
            denormalised (B, T, 1)}, state_out)"""
        x, state_out = self.recurrent(self.embed(img), first, state)
        return self.heads_from_recurrent(x, action_mask), state_out

    # the split points of the JAX package's pipeline-parallel step: forward
    # equals heads_from_recurrent(recurrent_layer(embed(img)))

    def embed(self, img):
        """Pre-recurrence trunk: preprocess → CNN → [pre_lstm_ln] latents."""
        return self.net.embed(img)

    def heads_from_recurrent(self, x, action_mask: Optional[Dict] = None) -> Dict:
        """Post-recurrence tail: relu → lastlayer → final_ln → heads."""
        with span(HEADS_SPAN):
            latent = self.net.latent(x)
            vpred_raw = self.value_head(latent)
            return {
                "pi_logits": self.pi_head(latent, mask=action_mask),
                "vpred_raw": vpred_raw,
                "vpred": self.value_head.denormalize(vpred_raw),
            }

    def recurrent(self, x, first, state):
        """The recurrent blocks (the state passes through where there are none)."""
        return self.net.recurrent(x, first, state)

    def embed_time_slice(self, img, time_slice: slice):
        """:meth:`embed` of the steps ``time_slice`` of a (B, T) chunk (the
        sequence-parallel split, parallel/model.py)."""
        return self.embed(img[:, time_slice])

    def get_output_for_observation(self, img, state, first):
        """(pd, denormalised value, state_out) for one observation per stream
        (reference: policy.py:287-305).  :param img: (B, H, W, C); first: (B,)"""
        out, state_out = self(img[:, None], first[:, None], state)
        pd = {k: v[:, 0] for k, v in out["pi_logits"].items()}
        return pd, out["vpred"][:, 0, 0], state_out

    def v(self, img, first, state):
        """Value prediction only (reference: policy.py:330-339)."""
        out, _ = self(img[:, None], first[:, None], state)
        return out["vpred"][:, 0, 0]

    def act(self, img, first, state, stochastic: bool = True,
            generator: Optional[torch.Generator] = None):
        """One observation per stream (reference MinecraftAgentPolicy.act,
        policy.py:307-328).

        :param img: (B, H, W, C); first: (B,)
        :returns: (action dict, state_out, {"log_prob": (B,), "vpred": (B,)})
        """
        out, state_out = self(img[:, None], first[:, None], state)
        logits = {k: v[:, 0] for k, v in out["pi_logits"].items()}
        action = dict_sample(logits, self.head_specs, deterministic=not stochastic,
                             generator=generator)
        log_prob = dict_logprob(logits, action, self.head_specs)
        return action, state_out, {"log_prob": log_prob, "vpred": out["vpred"][:, 0, 0]}


class InverseActionNet(nn.Module):
    """IDM trunk: conv3d → Impala → unmasked transformer (reference:
    policy.py:342-403)."""

    def __init__(self, cfg: PolicyConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.compute_dtype)
        self.img_preprocess = ImgPreprocessing(cfg.scale_input_img, cfg.img_statistics, device)
        self.conv3d_layer = None
        cnn_cfg = cfg
        if cfg.conv3d_params is not None:
            p = dict(cfg.conv3d_params)
            ks, pad, stride = (_triple(p.get(k, d)) for k, d in (("kernel_size", 3), ("padding", 0), ("stride", 1)))
            # the Impala stack takes the conv3d's output frames, whatever img_shape[2] says
            h, w = ((n + 2 * pad[i] - ks[i]) // stride[i] + 1 for i, n in ((1, cfg.img_shape[0]), (2, cfg.img_shape[1])))
            cnn_cfg = cfg.replace(img_shape=(h, w, int(p["outchan"])))
            # the first layer: its input is already normalised, so no norm
            # (reference: policy.py:361-372 strips the norm kwargs)
            self.conv3d_layer = FanInInitLayer(
                idm_input_shape(cfg)[2], p["outchan"], layer_type="conv3d",
                kernel_size=ks, padding=pad, stride=stride, dtype=dtype, device=device,
            )
        # the first Impala conv is normed iff a conv3d front end exists (reference: policy.py:354-359)
        self.img_process = ImgObsProcess(cnn_cfg.replace(first_conv_norm=cfg.conv3d_params is not None), device)
        self.recurrent_layer = _recurrent_layer(cfg, dtype, device)
        self.lastlayer = FanInInitLayer(cfg.hidsize, cfg.hidsize, layer_type="linear",
                                        layer_norm=cfg.dense_use_layer_norm, dtype=dtype, device=device,
                                        quantize=cfg.quantize_dense)
        self.final_ln = LayerNorm(cfg.hidsize, device=device)

    def conv3d_front(self, x: torch.Tensor):
        """Preprocessed (B, T, H, W, C) frames → the conv3d's output as
        (B·T', C', H', W') frames, and B, T'.  Time is the conv's depth axis,
        so its padding is zero at the window's edges."""
        x = self.conv3d_layer(x.permute(0, 4, 1, 2, 3))  # (B, C', T', H', W')
        return x.transpose(1, 2).flatten(0, 1), x.shape[0], x.shape[2]

    def embed(self, img: torch.Tensor, time_slice: Optional[slice] = None) -> torch.Tensor:
        """uint8 (B, T, H, W, C) → (B, T, hidsize) latents before the blocks;
        with ``time_slice``, the latents of those steps only, equal to that
        slice of the whole window's."""
        with span(CNN_SPAN):
            x = self.img_preprocess(img)
            if self.conv3d_layer is None:
                return self.img_process(x if time_slice is None else x[:, time_slice])
            if time_slice is not None:
                return self.img_process.forward_nchw(*self.conv3d_front_slice(x, time_slice))
            return self.img_process.forward_nchw(*self.conv3d_front(x))

    def conv3d_front_slice(self, x: torch.Tensor, time_slice: slice):
        """:meth:`conv3d_front`'s output frames ``time_slice`` alone, from the
        input frames the time kernel reaches: past the window's edges those
        are the conv's zero padding, elsewhere the neighbours' frames."""
        layer = self.conv3d_layer
        kt, (pt, *pad_hw), st = layer_kernel_time(layer)
        if st != 1:
            raise NotImplementedError("a time-sliced conv3d front end needs time stride 1")
        t = x.shape[1]
        lo, hi = time_slice.start - pt, time_slice.stop + kt - 1 - pt
        xs = x[:, max(lo, 0):min(hi, t)]
        xs = F.pad(xs, (0, 0, 0, 0, 0, 0, max(0, -lo), max(0, hi - t)))
        y = layer(xs.permute(0, 4, 1, 2, 3), padding=(0, *pad_hw))  # (B, C', t, H', W')
        return y.transpose(1, 2).flatten(0, 1), y.shape[0], y.shape[2]

    def tail(self, x):
        """The blocks' output → the action head's input."""
        x = F.relu(x)
        self.lastlayer(x)  # reference quirk: computed, then overwritten (policy.py:390-391)
        return self.final_ln(x)


class InverseActionPolicy(nn.Module):
    """IDM trunk + factored action head (reference: policy.py:406-467)."""

    def __init__(self, cfg: PolicyConfig, head_specs: Tuple[HeadSpec, ...],
                 temperature: float = 1.0, device=None):
        super().__init__()
        self.cfg = cfg
        self.head_specs = head_specs
        self.net = InverseActionNet(cfg, device)
        self.pi_head = DictActionHead(cfg.hidsize, head_specs, temperature, torch_dtype(cfg.compute_dtype), device)

    def forward(self, img, first, state, action_mask: Optional[Dict] = None):
        """:param img: (B, T, H, W, C) uint8 video frames; first: (B, T) bool
        :returns: ({"pi_logits": dict}, state_out)"""
        x, state_out = self.recurrent(self.net.embed(img), first, state)
        with span(HEADS_SPAN):
            return {"pi_logits": self.pi_head(self.net.tail(x), mask=action_mask)}, state_out

    def recurrent(self, x, first, state):
        with span(BLOCKS_SPAN):
            return self.net.recurrent_layer(x, first, state)

    def embed_time_slice(self, img, time_slice: slice):
        return self.net.embed(img, time_slice)

    def heads_from_recurrent(self, x):
        """The forward's tail from the blocks' output (``lastlayer``, whose
        result the forward discards, is not run)."""
        with span(HEADS_SPAN):
            return {"pi_logits": self.pi_head(self.net.final_ln(F.relu(x)))}

    def predict(self, img, first, state, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """(action, state_out, {"log_prob", "pd"}) over a frame window
        (reference: policy.py:448-464)."""
        out, state_out = self(img, first, state)
        pd = out["pi_logits"]
        action = dict_sample(pd, self.head_specs, deterministic=deterministic, generator=generator)
        return action, state_out, {"log_prob": dict_logprob(pd, action, self.head_specs), "pd": pd}


def _recurrent_layer(cfg: PolicyConfig, dtype: torch.dtype, device) -> ResidualRecurrentBlocks:
    return ResidualRecurrentBlocks(
        cfg.hidsize, cfg.timesteps, n_block=cfg.n_recurrence_layers,
        is_residual=cfg.recurrence_is_residual, recurrence_type=cfg.recurrence_type,
        use_pointwise_layer=cfg.use_pointwise_layer, pointwise_ratio=cfg.pointwise_ratio,
        pointwise_use_activation=cfg.pointwise_use_activation,
        attention_heads=cfg.attention_heads, attention_memory_size=cfg.attention_memory_size,
        attention_mask_style=cfg.attention_mask_style, dtype=dtype, remat=cfg.remat, device=device,
        quantize_dense=cfg.quantize_dense,
    )


def get_logprob_of_action(head_specs: Tuple[HeadSpec, ...], pd: Dict, action: Dict) -> torch.Tensor:
    """Log-probability of ``action`` under the distribution parameters ``pd``
    (reference: policy.py:271-279)."""
    return dict_logprob(pd, action, head_specs)


def get_kl_of_action_dists(head_specs: Tuple[HeadSpec, ...], pd1: Dict, pd2: Dict) -> torch.Tensor:
    """KL(pd1 ‖ pd2) of two action distributions (reference: policy.py:281-285)."""
    return dict_kl(pd1, pd2, head_specs)


def layer_kernel_time(layer) -> Tuple[int, Tuple[int, int, int], int]:
    """A conv3d layer's (time kernel size, (t, h, w) padding, time stride)."""
    kt = layer.layer.weight.shape[2]
    return kt, _triple(layer.padding), _triple(layer.stride)[0]


def _triple(x) -> Tuple[int, int, int]:
    return (int(x),) * 3 if isinstance(x, int) else tuple(int(v) for v in x)


def idm_input_shape(cfg: PolicyConfig) -> Tuple[int, int, int]:
    """The raw (h, w, c) video input shape of an IDM config.  In the
    reference's kwargs ``img_shape[2]`` declares the Impala stack's input,
    i.e. the conv3d's OUTPUT channels (the published 4x IDM ships
    ``img_shape=[128, 128, 128]``), not the video's."""
    h, w, c = cfg.img_shape
    if cfg.conv3d_params:
        c = int(cfg.conv3d_params.get("inchan", 3))
    return int(h), int(w), int(c)


def policy_initial_state(cfg: PolicyConfig, batchsize: int, ring: bool = False, device=None):
    """Initial recurrent state, a function of the config alone: None for
    ``recurrence_type="none"``, zero ``{"h", "c"}`` carries for an LSTM type
    (``ring`` ignored), else the attention caches; ``ring=True`` gives a
    transformer the rotating-cache state of the t=1 stepped rollout."""
    if cfg.recurrence_type == "none":
        return None
    dtype = torch_dtype(cfg.compute_dtype)
    if cfg.recurrence_type != "transformer":
        return [lstm_initial_state(batchsize, cfg.hidsize, dtype, device) for _ in range(cfg.n_recurrence_layers)]
    if ring:
        return [ring_initial_state(batchsize, cfg.maxlen, cfg.hidsize, dtype, cfg.attention_heads, device)
                for _ in range(cfg.n_recurrence_layers)]
    return [masked_attention_initial_state(batchsize, cfg.maxlen, cfg.hidsize, dtype, device)
            for _ in range(cfg.n_recurrence_layers)]
