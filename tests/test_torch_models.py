"""Layers, Impala CNN, heads and transformer blocks of the PyTorch port
against vpt_tpu on the same weights, carried with ``from_jax_variables``
and loaded ``strict=True`` (so the port's state_dict names are the
reference's).  Float32 on the CPU; tolerance rtol 2e-4 / atol 2e-5 per
module (sums in another order).  The blocks also show stepwise = chunkwise
with mid-chunk resets and ring = linear, as tests/test_kv_cache.py and
tests/test_ring_cache.py do for the JAX package."""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.models import heads as jax_heads
from vpt_tpu.models import impala as jax_impala
from vpt_tpu.models import layers as jax_layers
from vpt_tpu.models import transformer as jax_tf
from vpt_tpu_torch.checkpoint import from_jax_variables
from vpt_tpu_torch.models import heads, impala, layers
from vpt_tpu_torch.models import transformer as tf

RTOL, ATOL = 2e-4, 2e-5
HID, HEADS, NBLOCK, MAXLEN = 32, 4, 2, 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _load(module, variables):
    module.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables)), strict=True)
    return module.eval()


def _close(got, expect, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expect), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["linear_ln", "linear_bias", "conv_gn", "conv_bias"])
def test_fan_in_init_layer(kind):
    rng = np.random.default_rng(0)
    if kind.startswith("linear"):
        x = rng.normal(size=(3, 5, 8)).astype(np.float32)
        kw = dict(layer_type="linear", layer_norm=kind == "linear_ln")
        port = layers.FanInInitLayer(8, 12, **kw)
        ref = jax_layers.FanInInitLayer(outchan=12, **kw)
        xin = _t(x)
    else:
        x = rng.normal(size=(2, 7, 6, 4)).astype(np.float32)  # NHWC for JAX
        gn = 1 if kind == "conv_gn" else None
        port = layers.FanInInitLayer(4, 6, layer_type="conv", group_norm_groups=gn)
        ref = jax_layers.FanInInitLayer(outchan=6, layer_type="conv", kernel_size=(3, 3),
                                        padding=((1, 1), (1, 1)), group_norm_groups=gn)
        xin = _t(x).permute(0, 3, 1, 2)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    expect = ref.apply(variables, jnp.asarray(x))
    got = _load(port, variables)(xin)
    if kind.startswith("conv"):
        got = got.permute(0, 2, 3, 1)
    _close(got, expect)


def test_layer_norm_and_normed_dense():
    x = np.random.default_rng(1).normal(size=(4, 16)).astype(np.float32) * 3 + 1
    ref = jax_layers.LayerNorm()
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    _close(_load(layers.LayerNorm(16), variables)(_t(x)), ref.apply(variables, jnp.asarray(x)))
    dense = jax_layers.normed_dense(8, scale=0.1)
    variables = dense.init(jax.random.PRNGKey(1), jnp.asarray(x))
    _close(_load(layers.normed_dense(16, 8, scale=0.1), variables)(_t(x)), dense.apply(variables, jnp.asarray(x)))


def test_fan_in_init_row_norms():
    w = torch.empty(6, 4, 3, 3)
    layers.fan_in_normed_(w, 0.5, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(w.flatten(1).norm(dim=1).numpy(), 0.5, rtol=1e-5)


@pytest.mark.parametrize("hw", [8, 7])
def test_impala_cnn(hw):
    x = np.random.default_rng(2).random((2, 3, hw, hw, 3)).astype(np.float32)
    ref = jax_impala.ImpalaCNN(chans=(4, 8), outsize=16, nblock=2, post_pool_groups=1,
                               group_norm_groups=1, first_conv_norm=False, dense_layer_norm=True)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    port = impala.ImpalaCNN((hw, hw, 3), chans=(4, 8), outsize=16, nblock=2, post_pool_groups=1,
                            group_norm_groups=1, first_conv_norm=False, dense_layer_norm=True)
    _close(_load(port, variables)(_t(x)), ref.apply(variables, jnp.asarray(x)))


SPECS = (heads.HeadSpec("camera", (1,), 121), heads.HeadSpec("buttons", (1,), 8641))
JAX_SPECS = tuple(jax_heads.HeadSpec(s.key, s.value_shape, s.num_actions) for s in SPECS)


@pytest.fixture(scope="module")
def head_pair():
    x = np.random.default_rng(3).normal(size=(2, 3, 16)).astype(np.float32)
    ref = jax_heads.DictActionHead(specs=JAX_SPECS, temperature=2.0)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    # sharpen the logits so the sampling checks are not decided by ties
    variables = jax.tree.map(lambda a: a * 300.0, variables)
    port = _load(heads.DictActionHead(16, SPECS, temperature=2.0), variables)
    return x, ref.apply(variables, jnp.asarray(x)), port(_t(x))


def test_dict_action_head(head_pair):
    _, expect, got = head_pair
    for s in SPECS:
        assert got[s.key].shape == (2, 3, 1, s.num_actions)
        _close(got[s.key], expect[s.key])


def test_dict_logprob_and_injected_noise_sampling(head_pair):
    _, expect, got = head_pair
    rng = np.random.default_rng(4)
    noise = {s.key: rng.random((2, 3, 1, s.num_actions)).astype(np.float32) for s in SPECS}
    sample = heads.dict_sample(got, SPECS, noise={k: _t(v) for k, v in noise.items()})
    for s in SPECS:
        u = np.maximum(noise[s.key], np.finfo(np.float32).tiny)
        ref = np.argmax(np.asarray(expect[s.key]) - np.log(-np.log(u)), axis=-1)
        np.testing.assert_array_equal(sample[s.key].numpy(), ref)
    det = heads.dict_sample(got, SPECS, deterministic=True)
    jdet = jax_heads.dict_sample(jax.random.PRNGKey(0), expect, JAX_SPECS, deterministic=True)
    for s in SPECS:
        np.testing.assert_array_equal(det[s.key].numpy(), np.asarray(jdet[s.key]))
    lp = heads.dict_logprob(got, det, SPECS)
    jlp = jax_heads.dict_logprob(expect, jdet, JAX_SPECS)
    _close(lp, jlp)
    # generator draws are reproducible
    g = lambda: torch.Generator().manual_seed(5)
    a = heads.dict_sample(got, SPECS, generator=g())
    b = heads.dict_sample(got, SPECS, generator=g())
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_scaled_mse_head_denormalize():
    x = np.random.default_rng(6).normal(size=(2, 3, 16)).astype(np.float32)
    ref = jax_heads.ScaledMSEHead(output_size=1, norm_axes=2)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": variables["params"], "stats": {
        "running_mean": jnp.asarray([0.3]), "running_mean_sq": jnp.asarray([2.0]),
        "debiasing_term": jnp.asarray(0.9)}}
    port = _load(heads.ScaledMSEHead(16), variables)
    raw = ref.apply(variables, jnp.asarray(x))
    _close(port(_t(x)), raw)
    _close(port.denormalize(port(_t(x))), ref.apply(variables, raw, method="denormalize"))


# ---------------------------------------------------------------------------
# Transformer blocks
# ---------------------------------------------------------------------------


def _jax_blocks(timesteps):
    return jax_tf.ResidualRecurrentBlocks(
        hidsize=HID, timesteps=timesteps, n_block=NBLOCK, recurrence_type="transformer",
        attention_heads=HEADS, attention_memory_size=timesteps + MAXLEN,
        attention_mask_style="clipped_causal")


def _port_blocks(timesteps, variables):
    blocks = tf.ResidualRecurrentBlocks(
        HID, timesteps, n_block=NBLOCK, recurrence_type="transformer", attention_heads=HEADS,
        attention_memory_size=timesteps + MAXLEN, attention_mask_style="clipped_causal")
    return _load(blocks, variables)


def _lin0(B=2):
    return [tf.masked_attention_initial_state(B, MAXLEN, HID, torch.float32) for _ in range(NBLOCK)]


def _ring0(B=2):
    return [tf.ring_initial_state(B, MAXLEN, HID, torch.float32, HEADS) for _ in range(NBLOCK)]


def _steps(blocks, x, first, state):
    outs = []
    for i in range(x.shape[1]):
        o, state = blocks(x[:, i:i + 1], first[:, i:i + 1], state)
        outs.append(o)
    return torch.cat(outs, dim=1), state


@pytest.fixture(scope="module")
def block_setup():
    T = 8
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3 * T, HID)).astype(np.float32)
    first = np.zeros((2, 3 * T), bool)
    first[:, 0] = True
    first[0, 5] = True    # mid-chunk reset, stream 0
    first[1, 11] = True   # mid-chunk reset in the second chunk, stream 1
    first[0, 16] = True   # reset at a chunk start
    ref = _jax_blocks(T)
    state0 = [jax_tf.masked_attention_initial_state(2, MAXLEN, HID, jnp.float32) for _ in range(NBLOCK)]
    variables = jax.jit(ref.init)(jax.random.PRNGKey(0), jnp.asarray(x[:, :T]), jnp.asarray(first[:, :T]), state0)
    return T, x, first, ref, state0, variables


@torch.no_grad()
def test_blocks_chunkwise_match_jax_across_chunks(block_setup):
    T, x, first, ref, jstate, variables = block_setup
    port, state = _port_blocks(T, variables), _lin0()
    apply = jax.jit(ref.apply)
    for c in range(3):
        sl = slice(c * T, (c + 1) * T)
        expect, jstate = apply(variables, jnp.asarray(x[:, sl]), jnp.asarray(first[:, sl]), jstate)
        got, state = port(_t(x[:, sl]), _t(first[:, sl]), state)
        _close(got, expect)
        for s, js in zip(state, jstate):
            np.testing.assert_array_equal(s["state_mask"].numpy(), np.asarray(js["state_mask"]))
            _close(s["k"], js["k"])


@torch.no_grad()
def test_blocks_stepwise_equals_chunkwise(block_setup):
    T, x, first, _, _, variables = block_setup
    chunk, step = _port_blocks(T, variables), _port_blocks(1, variables)
    out_chunk, s_chunk = chunk(_t(x[:, :2 * T]), _t(first[:, :2 * T]), _lin0())
    out_chunk2, s_chunk = chunk(_t(x[:, 2 * T:]), _t(first[:, 2 * T:]), s_chunk)
    out_steps, s_steps = _steps(step, _t(x), _t(first), _lin0())
    # a 2T chunk, then a T chunk on its carried state, against 3T single steps
    _close(torch.cat([out_chunk, out_chunk2], dim=1), out_steps.numpy())
    for a, b in zip(s_chunk, s_steps):
        np.testing.assert_array_equal(a["state_mask"].numpy(), b["state_mask"].numpy())
        _close(a["k"], b["k"].numpy())


@torch.no_grad()
def test_ring_equals_linear_and_matches_jax_ring(block_setup):
    T, x, first, _, _, variables = block_setup
    step = _port_blocks(1, variables)
    out_lin, _ = _steps(step, _t(x), _t(first), _lin0())
    out_ring, ring = _steps(step, _t(x), _t(first), _ring0())
    _close(out_ring, out_lin.numpy())
    assert ring[0]["idx"] == x.shape[1] % MAXLEN
    # the JAX ring step on the first maxlen + 3 steps (one wrap)
    jstep = jax.jit(_jax_blocks(1).apply)
    jstate = [jax_tf.ring_initial_state(2, MAXLEN, HID, jnp.float32, HEADS) for _ in range(NBLOCK)]
    for i in range(MAXLEN + 3):
        o, jstate = jstep(variables, jnp.asarray(x[:, i:i + 1]), jnp.asarray(first[:, i:i + 1]), jstate)
        _close(out_ring[:, i:i + 1], o)


@torch.no_grad()
def test_ring_state_to_linear_continues_chunkwise(block_setup):
    T, x, first, _, _, variables = block_setup
    step, chunk = _port_blocks(1, variables), _port_blocks(T, variables)
    n = 11  # ring index not at 0
    _, ring = _steps(step, _t(x[:, :n]), _t(first[:, :n]), _ring0())
    _, lin = _steps(step, _t(x[:, :n]), _t(first[:, :n]), _lin0())
    linear = [tf.ring_state_to_linear(s) for s in ring]
    a, _ = chunk(_t(x[:, n:n + T]), _t(first[:, n:n + T]), linear)
    b, _ = chunk(_t(x[:, n:n + T]), _t(first[:, n:n + T]), lin)
    _close(a, b.numpy())


def test_action_mask_sets_log0(head_pair):
    x, _, _ = head_pair
    ref = jax_heads.DictActionHead(specs=JAX_SPECS, temperature=2.0)
    variables = ref.init(jax.random.PRNGKey(1), jnp.asarray(x))
    mask = np.random.default_rng(8).random((2, 3, 1, 121)) < 0.5
    expect = ref.apply(variables, jnp.asarray(x), mask={"camera": jnp.asarray(mask)})
    got = _load(heads.DictActionHead(16, SPECS, temperature=2.0), variables)(_t(x), mask={"camera": _t(mask)})
    _close(got["camera"], expect["camera"])
    _close(got["buttons"], expect["buttons"])


def test_img_preprocessing_with_statistics(tmp_path):
    from vpt_tpu.models.policy import ImgPreprocessing as JaxPre
    from vpt_tpu_torch.models.policy import ImgPreprocessing

    rng = np.random.default_rng(9)
    path = str(tmp_path / "stats.npz")
    np.savez(path, mean=rng.random((8, 8, 3)).astype(np.float32) * 100,
             std=rng.random((8, 8, 3)).astype(np.float32) * 50 + 1)
    img = rng.integers(0, 256, (2, 3, 8, 8, 3), dtype=np.uint8)
    ref = JaxPre(img_statistics=path)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(img))
    port = _load(ImgPreprocessing(img_statistics=path), variables)
    _close(port(_t(img)), ref.apply(variables, jnp.asarray(img)))
    _close(ImgPreprocessing()(_t(img)), JaxPre().apply({}, jnp.asarray(img)))


@pytest.mark.parametrize("width", [1, 2, 3])
def test_config_matches_jax(width):
    import dataclasses

    from vpt_tpu.config import foundation_policy_config as jax_config
    from vpt_tpu_torch.config import foundation_policy_config

    ours, ref = foundation_policy_config(width), jax_config(width)
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert (ours.chans, ours.maxlen, ours.dense_use_layer_norm) == (ref.chans, ref.maxlen, ref.dense_use_layer_norm)
