"""Cross-framework numerical parity: run our layers and an independently
assembled torch computation on the SAME weights (through the checkpoint
converter) and compare outputs.  This is the strongest available check that
the converter's layout conventions (OI→IO, OIHW→HWIO, norm weight→scale) and
our layer semantics (norm-before-layer, bias rules, muP attention, float32
softmax islands) line up with torch — shape checks alone cannot catch a
transposed kernel.  (The published checkpoints would be the final oracle;
they are not available in this image.)
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vpt_tpu.checkpoint.torch_import import variables_to_state_dict
from vpt_tpu.models.layers import FanInInitLayer
from vpt_tpu.models.transformer import SelfAttentionLayer
from vpt_tpu.ops.masks import band_diagonal_mask

torch.set_grad_enabled(False)


def test_dense_layernorm_relu_parity():
    layer = FanInInitLayer(outchan=12, layer_type="linear", layer_norm=True)
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ours = np.asarray(layer.apply(params, jnp.asarray(x)))

    sd = variables_to_state_dict(params)
    t = torch.from_numpy(x)
    t = F.layer_norm(t, (8,), torch.from_numpy(sd["norm.weight"]), torch.from_numpy(sd["norm.bias"]), eps=1e-5)
    t = F.linear(t, torch.from_numpy(sd["layer.weight"]))
    t = F.relu(t)
    np.testing.assert_allclose(ours, t.numpy(), rtol=1e-5, atol=1e-6)


def test_conv_groupnorm_parity():
    layer = FanInInitLayer(
        outchan=6, layer_type="conv", kernel_size=(3, 3), padding=((1, 1), (1, 1)),
        group_norm_groups=1,
    )
    x = np.random.default_rng(1).normal(size=(2, 5, 7, 4)).astype(np.float32)  # NHWC
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ours = np.asarray(layer.apply(params, jnp.asarray(x)))

    sd = variables_to_state_dict(params)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW
    t = F.group_norm(t, 1, torch.from_numpy(sd["norm.weight"]), torch.from_numpy(sd["norm.bias"]), eps=1e-5)
    t = F.conv2d(t, torch.from_numpy(sd["layer.weight"]), padding=1)
    t = F.relu(t).permute(0, 2, 3, 1)
    np.testing.assert_allclose(ours, t.numpy(), rtol=1e-4, atol=1e-5)


def test_conv3d_parity():
    layer = FanInInitLayer(
        outchan=4, layer_type="conv3d", kernel_size=(5, 1, 1),
        padding=((2, 2), (0, 0), (0, 0)),
    )
    x = np.random.default_rng(2).normal(size=(1, 6, 4, 4, 3)).astype(np.float32)  # NTHWC
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ours = np.asarray(layer.apply(params, jnp.asarray(x)))

    sd = variables_to_state_dict(params)
    t = torch.from_numpy(x).permute(0, 4, 1, 2, 3)  # NCTHW
    t = F.conv3d(t, torch.from_numpy(sd["layer.weight"]), torch.from_numpy(sd["layer.bias"]), padding=(2, 0, 0))
    t = F.relu(t).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(ours, t.numpy(), rtol=1e-4, atol=1e-5)


def test_maxpool_parity():
    import flax.linen as nn

    x = np.random.default_rng(3).normal(size=(1, 9, 9, 2)).astype(np.float32)
    ours = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding=((1, 1), (1, 1))))
    t = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, stride=2, padding=1)
    np.testing.assert_allclose(ours, t.permute(0, 2, 3, 1).numpy(), rtol=1e-6)


def test_attention_layer_parity():
    """Full SelfAttentionLayer (q/k/v/proj + relattn + muP + window mask) vs a
    from-scratch torch transcription of the documented attention contract."""
    HID, HEADS, MAXLEN, T_ = 32, 4, 4, 8
    layer = SelfAttentionLayer(
        x_size=HID, heads=HEADS, maxlen=MAXLEN, relattn=True,
        use_muP_factor=True, attention_impl="xla",
    )
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, T_, HID)).astype(np.float32)
    cache = (jnp.zeros((2, MAXLEN, HID)), jnp.zeros((2, MAXLEN, HID)))
    mask = jnp.broadcast_to(band_diagonal_mask(T_, T_ + MAXLEN, MAXLEN)[None], (2, T_, T_ + MAXLEN))
    # block the (zero) cache region like a fresh episode
    mask = mask.at[:, :, :MAXLEN].set(False)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), cache, mask)
    ours, (new_k, _) = layer.apply(params, jnp.asarray(x), cache, mask)
    ours = np.asarray(ours)

    sd = {k: torch.from_numpy(v.copy()) for k, v in variables_to_state_dict(params).items()}
    xt = torch.from_numpy(x)
    q = F.linear(xt, sd["q_layer.weight"], sd["q_layer.bias"])
    k = F.linear(xt, sd["k_layer.weight"])
    v = F.linear(xt, sd["v_layer.weight"])
    k_full = torch.cat([torch.zeros(2, MAXLEN, HID), k], dim=1)
    v_full = torch.cat([torch.zeros(2, MAXLEN, HID), v], dim=1)

    def split(z, T):
        return z.view(2, T, HEADS, HID // HEADS).permute(0, 2, 1, 3)

    qh, kh, vh = split(q, T_), split(k_full, T_ + MAXLEN), split(v_full, T_ + MAXLEN)
    d = HID // HEADS
    logits = torch.einsum("bhtd,bhTd->bhtT", qh.float(), kh.float()) / d  # muP 1/d
    # relattn: R (b,t,n*h) split per head; D[n,i,j] = b_nd[n, (T-t)+i-j]
    R = F.linear(xt, sd["r_layer.weight"], sd["r_layer.bias"]).float()
    nb = sd["b_nd"].shape[0]
    Rh = R.view(2, T_, HEADS, nb).permute(0, 2, 1, 3)
    D = torch.zeros(nb, T_, T_ + MAXLEN)
    for i in range(T_):
        for j in range(T_ + MAXLEN):
            dd = MAXLEN + i - j
            if 0 <= dd < MAXLEN:
                D[:, i, j] = sd["b_nd"][:, dd]
    logits = logits + torch.einsum("bhtn,ntT->bhtT", Rh, D)
    logits = logits + torch.where(torch.from_numpy(np.array(mask))[:, None], 0.0, -1e9)
    w = torch.softmax(logits, dim=-1)
    a = torch.einsum("bhtT,bhTd->bhtd", w, vh.float())
    a = a.permute(0, 2, 1, 3).reshape(2, T_, HID)
    out = xt + F.linear(a, sd["proj_layer.weight"], sd["proj_layer.bias"])
    np.testing.assert_allclose(ours, out.numpy(), rtol=2e-4, atol=2e-5)
    # cache parity: trailing MAXLEN keys
    np.testing.assert_allclose(np.asarray(new_k), k_full[:, -MAXLEN:].numpy(), rtol=1e-5, atol=1e-6)


def test_log_softmax_temperature_parity():
    from vpt_tpu.models.heads import CategoricalActionHead, HeadSpec

    head = CategoricalActionHead(spec=HeadSpec("b", (1,), 9), temperature=2.0)
    x = np.random.default_rng(5).normal(size=(3, 6)).astype(np.float32)
    params = head.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ours = np.asarray(head.apply(params, jnp.asarray(x)))
    sd = variables_to_state_dict(params)
    t = F.linear(torch.from_numpy(x), torch.from_numpy(sd["linear_layer.weight"]),
                 torch.from_numpy(sd["linear_layer.bias"]))
    t = t.reshape(3, 1, 9) / 2.0
    t = F.log_softmax(t.float(), dim=-1)
    np.testing.assert_allclose(ours, t.numpy(), rtol=1e-5, atol=1e-6)


def test_attention_layer_parity_with_layernorm():
    """norm='layer' variant: the skip connection must carry the PRE-ln_x input
    (reference xf.py:358-360 — regression for the residual-semantics fix)."""
    HID, HEADS, MAXLEN, T_ = 32, 4, 4, 8
    layer = SelfAttentionLayer(
        x_size=HID, heads=HEADS, maxlen=MAXLEN, relattn=False,
        use_muP_factor=False, norm="layer", attention_impl="xla",
    )
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, T_, HID)).astype(np.float32)
    cache = (jnp.zeros((2, MAXLEN, HID)), jnp.zeros((2, MAXLEN, HID)))
    mask = jnp.broadcast_to(band_diagonal_mask(T_, T_ + MAXLEN, MAXLEN)[None], (2, T_, T_ + MAXLEN))
    mask = mask.at[:, :, :MAXLEN].set(False)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x), cache, mask)
    ours = np.asarray(layer.apply(params, jnp.asarray(x), cache, mask)[0])

    sd = {k: torch.from_numpy(v.copy()) for k, v in variables_to_state_dict(params).items()}
    xt = torch.from_numpy(x)
    xn = F.layer_norm(xt, (HID,), sd["ln_x.weight"], sd["ln_x.bias"], eps=1e-5)
    q = F.linear(xn, sd["q_layer.weight"], sd["q_layer.bias"])
    k = F.linear(xn, sd["k_layer.weight"])
    v = F.linear(xn, sd["v_layer.weight"])
    k_full = torch.cat([torch.zeros(2, MAXLEN, HID), k], dim=1)
    v_full = torch.cat([torch.zeros(2, MAXLEN, HID), v], dim=1)

    def split(z, T):
        return z.view(2, T, HEADS, HID // HEADS).permute(0, 2, 1, 3)

    qh, kh, vh = split(q, T_), split(k_full, T_ + MAXLEN), split(v_full, T_ + MAXLEN)
    d = HID // HEADS
    logits = torch.einsum("bhtd,bhTd->bhtT", qh.float(), kh.float()) / (d ** 0.5)
    logits = logits + torch.where(torch.from_numpy(np.array(mask))[:, None], 0.0, -1e9)
    w = torch.softmax(logits, dim=-1)
    a = torch.einsum("bhtT,bhTd->bhtd", w, vh.float()).permute(0, 2, 1, 3).reshape(2, T_, HID)
    # reference: output = x (PRE-ln) + proj(attention)
    out = xt + F.linear(a, sd["proj_layer.weight"], sd["proj_layer.bias"])
    np.testing.assert_allclose(ours, out.numpy(), rtol=2e-4, atol=2e-5)
