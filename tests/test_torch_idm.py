"""The port's inverse dynamics model against vpt_tpu's at a tiny config (as
tests/test_streaming_idm.py), on weights carried by ``from_jax_variables``
and inputs from a numpy seed, on the CPU:

  * the conv3d FanInInitLayer: rtol/atol 1e-5 (f32 sums in another order);
  * InverseActionPolicy logits: 2e-3 (as tests/test_torch_policy.py), and
    bfloat16 on both sides 5e-2;
  * IDMAgent labels (predict_actions with the state carried, and
    predict_actions_batched from a fresh state) and StreamingIDMLabeler
    labels over six window geometries: exactly equal;
  * IDM_4X_KWARGS: equal to the root bench.py's, and the same parameter count
    as vpt_tpu's 4x IDM (0.482 B);
  * the labeling CLI end to end (skips without libav).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.agent import IDMAgent as JaxIDMAgent
from vpt_tpu.agent import StreamingIDMLabeler as JaxLabeler
from vpt_tpu.models.layers import FanInInitLayer as JaxFanInInitLayer
from vpt_tpu.models.policy import InverseActionPolicy as JaxPolicy
from vpt_tpu.models.policy import policy_initial_state as jax_initial_state
from vpt_tpu_torch.actions import IDMActionMapping
from vpt_tpu_torch.agent import IDMAgent, StreamingIDMLabeler, action_jsonl_row
from vpt_tpu_torch.checkpoint import from_jax_variables
from vpt_tpu_torch.config import IDM_4X_KWARGS, PolicyConfig
from vpt_tpu_torch.models.heads import head_specs_from_space
from vpt_tpu_torch.models.layers import FanInInitLayer
from vpt_tpu_torch.models.policy import InverseActionPolicy, idm_input_shape, policy_initial_state
from vpt_tpu_torch.ops.windowed_attention import MAX_KEYS
from vpt_tpu_torch.spaces import DictType

TOL = 2e-3
IDM_TINY_KWARGS = dict(
    hidsize=64,
    impala_width=1,
    impala_chans=[4, 8],
    img_shape=[64, 64, 8],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1},
    impala_kwargs={"post_pool_groups": 1},
    n_recurrence_layers=2,
    timesteps=8,
    attention_heads=4,
    attention_memory_size=16,
    recurrence_type="transformer",
    attention_mask_style="none",
    conv3d_params={"inchan": 3, "outchan": 8, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]},
    use_pre_lstm_ln=False,
    obs_processing_width=32,
)
PI_KWARGS = {"temperature": 1.0}


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 255, (n, 90, 160, 3), dtype=np.uint8)


def _same_actions(got, want, msg=""):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{msg} {k}")


@pytest.fixture(scope="module")
def agents():
    """vpt_tpu's IDMAgent and the port's on the same weights."""
    jax_agent = JaxIDMAgent(idm_net_kwargs=IDM_TINY_KWARGS, pi_head_kwargs=PI_KWARGS)
    jax_agent._ensure_variables()
    agent = IDMAgent(IDM_TINY_KWARGS, PI_KWARGS, device="cpu")
    agent.policy.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, jax_agent.variables)), strict=True)
    return jax_agent, agent


@pytest.mark.parametrize("kernel,padding,stride", [((5, 1, 1), (2, 0, 0), (1, 1, 1)), ((3, 3, 3), (1, 1, 1), (1, 2, 2))])
def test_conv3d_layer_matches_vpt_tpu(kernel, padding, stride):
    x = np.random.default_rng(0).standard_normal((2, 6, 10, 12, 3)).astype(np.float32)  # (B, T, H, W, C)
    ref = JaxFanInInitLayer(outchan=5, layer_type="conv3d", kernel_size=kernel, strides=stride,
                            padding=tuple((p, p) for p in padding))
    variables = ref.init(jax.random.PRNGKey(1), jnp.asarray(x))
    port = FanInInitLayer(3, 5, layer_type="conv3d", kernel_size=kernel, padding=padding, stride=stride)
    sd = from_jax_variables(jax.tree.map(np.asarray, variables))
    assert sd["layer.weight"].shape == (5, 3) + kernel and port.layer.bias is not None
    port.load_state_dict(sd, strict=True)
    # the fan-in init renormalises each output unit over all its other axes
    torch.testing.assert_close(port.layer.weight.flatten(1).norm(dim=1), torch.ones(5))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.apply(variables, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@torch.no_grad()
@pytest.mark.parametrize("compute_dtype,tol", [("float32", TOL), ("bfloat16", 5e-2)])
def test_idm_policy_logits_match_vpt_tpu(agents, compute_dtype, tol):
    """Two successive (2, 8) windows, the state carried from the first; then
    predict on the first from a fresh state."""
    jax_agent, agent = agents
    jcfg = jax_agent.cfg.replace(compute_dtype=compute_dtype)
    ref = JaxPolicy(cfg=jcfg, head_specs=jax_agent.head_specs, temperature=1.0)
    cfg = agent.cfg.replace(compute_dtype=compute_dtype)
    port = InverseActionPolicy(cfg, agent.head_specs).eval()
    port.load_state_dict(agent.policy.state_dict())
    assert not hasattr(port, "value_head") and port.net.conv3d_layer.layer.weight.shape == (8, 3, 5, 1, 1)
    img = np.random.default_rng(1).integers(0, 256, (2, 16, 64, 64, 3), dtype=np.uint8)
    first = np.zeros((2, 8), bool)
    jstate, state = jax_initial_state(jcfg, 2), policy_initial_state(cfg, 2)
    for w in range(2):
        window = img[:, 8 * w:8 * w + 8]
        jout, jstate = jax.jit(ref.apply)(jax_agent.variables, jnp.asarray(window), jnp.asarray(first), jstate)
        out, state = port(torch.from_numpy(window), torch.from_numpy(first), state)
        for k, v in out["pi_logits"].items():
            assert v.shape == (2, 8) + jout["pi_logits"][k].shape[2:] and v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), np.asarray(jout["pi_logits"][k]), atol=tol, rtol=tol,
                                       err_msg=f"window {w} {k}")
    # predict: the argmax decode and its log-probability, from a fresh state
    window = img[:, :8]
    jaction, _, jinfo = jax.jit(lambda *a: ref.apply(jax_agent.variables, *a, method="predict"))(
        jnp.asarray(window), jnp.asarray(first), jax_initial_state(jcfg, 2))
    action, _, info = port.predict(torch.from_numpy(window), torch.from_numpy(first), policy_initial_state(cfg, 2))
    np.testing.assert_allclose(info["log_prob"].numpy(), np.asarray(jinfo["log_prob"]), atol=tol, rtol=tol)
    if compute_dtype == "float32":
        for k in action:
            np.testing.assert_array_equal(action[k].numpy(), np.asarray(jaction[k]), err_msg=k)


def test_predict_actions_carries_state_like_vpt_tpu(agents):
    jax_agent, agent = agents
    frames = _frames(16, seed=5)
    jax_agent.reset()
    agent.reset()
    for w in range(2):  # the second window attends to the first's keys
        _same_actions(agent.predict_actions(frames[8 * w:8 * w + 8]),
                      jax_agent.predict_actions(frames[8 * w:8 * w + 8]), f"window {w}")
    agent.reset()
    carried = agent.predict_actions(frames[:8])
    again = agent.predict_actions(frames[:8])
    agent.reset()
    _same_actions(agent.predict_actions(frames[:8]), carried, "after reset")
    assert again["camera"].shape == (1, 8, 2)


def test_predict_actions_batched_matches_vpt_tpu(agents):
    """A fresh zero state a call: its maxlen zero keys are attended too."""
    jax_agent, agent = agents
    windows = np.random.default_rng(7).integers(0, 255, (3, 8, 64, 64, 3), dtype=np.uint8)
    got = agent.predict_actions_batched(windows)
    _same_actions(got, jax_agent.predict_actions_batched(windows))
    assert got["camera"].shape == (3, 8, 2) and set(got) >= {"attack", "forward", "camera"}
    handle = agent.dispatch_actions_batched(windows[:1])
    _same_actions(agent.collect_actions(handle), {k: v[:1] for k, v in got.items()}, "dispatch/collect")


def _stream(labeler, frames):
    labels = []
    for f in frames:
        labels.extend(labeler.feed(f))
    return labels + labeler.finish()


@pytest.mark.parametrize("n,window,stride,wb", [
    (20, 8, 4, 1),    # overlap, ragged tail
    (16, 8, 8, 1),    # disjoint (reference geometry), exact multiple
    (19, 8, 8, 2),    # disjoint, tail, batched windows
    (21, 8, 4, 3),    # overlap + batched, a ragged last group
    (5, 8, 4, 1),     # video shorter than one window
    (8, 8, 3, 1),     # single full window, stride not dividing window
])
def test_streaming_labels_match_vpt_tpu(agents, n, window, stride, wb):
    """Every frame labeled once, in order, with vpt_tpu's labels (which pads a
    ragged last group to window_batch; the port does not)."""
    jax_agent, agent = agents
    frames = _frames(n, seed=n)
    ours = _stream(StreamingIDMLabeler(agent, window=window, stride=stride, window_batch=wb), frames)
    theirs = _stream(JaxLabeler(jax_agent, window=window, stride=stride, window_batch=wb), frames)
    assert [i for i, _ in ours] == [i for i, _ in theirs] == list(range(n))
    for (i, a), (_, b) in zip(ours, theirs):
        _same_actions(a, b, f"frame {i}")


def test_streaming_label_is_owning_window_prediction(agents):
    _, agent = agents
    frames = _frames(20, seed=1)
    labels = dict(_stream(StreamingIDMLabeler(agent, window=8, stride=4, window_batch=2, max_inflight=2), frames))
    resized = np.stack([agent._video_obs_to_agent([f])[0, 0] for f in frames])
    for idx, win_start in [(10, 8), (0, 0), (1, 0), (19, 12)]:  # lo = 2; the tail window starts at 12
        direct = agent.predict_actions_batched(resized[win_start:win_start + 8][None])
        _same_actions(labels[idx], {k: v[0, idx - win_start] for k, v in direct.items()}, f"frame {idx}")


def test_predict_actions_past_max_keys_raises(agents):
    """N frames attend over N + maxlen keys; kernel B1 takes at most MAX_KEYS,
    and no call is routed elsewhere on any device."""
    _, agent = agents
    n = MAX_KEYS - agent.cfg.maxlen + 1
    with pytest.raises(ValueError, match=f"MAX_KEYS={MAX_KEYS}"):
        agent.predict_actions(np.zeros((n, 90, 160, 3), np.uint8))


def test_idm_4x_config_matches_bench_and_vpt_tpu():
    from bench import IDM_4X_KWARGS as BENCH_IDM_4X_KWARGS
    from vpt_tpu.actions.mapping import IDMActionMapping as JaxMapping
    from vpt_tpu.config import PolicyConfig as JaxConfig
    from vpt_tpu.models.heads import head_specs_from_space as jax_head_specs
    from vpt_tpu.spaces import DictType as JaxDictType

    assert IDM_4X_KWARGS == BENCH_IDM_4X_KWARGS
    cfg = PolicyConfig.from_kwargs(IDM_4X_KWARGS)
    assert idm_input_shape(cfg) == (128, 128, 3) and cfg.maxlen == 128 and cfg.hidsize // cfg.attention_heads == 128
    specs = head_specs_from_space(DictType(**IDMActionMapping(n_camera_bins=11).get_action_space_update()))
    port = InverseActionPolicy(cfg, specs, device="meta")
    n = sum(p.numel() for p in port.parameters())
    jcfg = JaxConfig.from_kwargs(IDM_4X_KWARGS)
    ref = JaxPolicy(cfg=jcfg, head_specs=jax_head_specs(JaxDictType(**JaxMapping(n_camera_bins=11)
                                                                    .get_action_space_update())))
    shapes = jax.eval_shape(ref.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 128, 128, 3), jnp.uint8),
                            jnp.zeros((1, 8), bool), jax_initial_state(jcfg, 1))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert abs(n - 0.482e9) < 0.0005e9, n


def test_labeling_cli_matches_vpt_tpu_labeler(agents, tmp_path):
    from vpt_tpu.data import video as jax_video
    from vpt_tpu_torch import run_inverse_dynamics_model as cli
    from vpt_tpu_torch.checkpoint import save_model_parameters, save_weights
    from vpt_tpu_torch.data import video

    try:
        video.build()
    except RuntimeError as e:
        pytest.skip(f"native video library of the port cannot be built: {e}")
    jax_agent, agent = agents
    frames = _frames(19, seed=9)
    path = str(tmp_path / "v.mp4")
    with video.VideoWriter(path, 160, 90, fps=20) as w:
        for f in frames:
            w.write(f)
    model, weights, out = (str(tmp_path / n) for n in ("idm.model", "idm.weights", "labels.jsonl"))
    save_model_parameters(model, IDM_TINY_KWARGS, PI_KWARGS)
    save_weights(weights, agent.policy)
    with pytest.raises(ValueError, match="resolution"):
        cli.main(["--model", model, "--weights", weights, "--video-path", path, "--n-frames", "8", "--device", "cpu"])
    cli.main(["--model", model, "--weights", weights, "--video-path", path, "--n-frames", "8", "--stride", "4",
              "--window-batch", "2", "--out", out, "--no-strict-resolution", "--device", "cpu"])
    rows = [json.loads(line) for line in open(out)]
    with jax_video.VideoReader(path) as cap:  # the same decoded frames, labeled by vpt_tpu
        decoded = [cap.read() for _ in range(len(frames))]
    theirs = _stream(JaxLabeler(jax_agent, window=8, stride=4, window_batch=2), decoded)
    assert [r["frame"] for r in rows] == list(range(len(frames)))
    for row, (_, action) in zip(rows, theirs):
        assert row["action"] == action_jsonl_row(action), row["frame"]
