"""MineRLAgent's frame preparation and serving options against vpt_tpu's,
on the CPU, at tests/test_torch_policy.py's tiny config:

  * ``resize_on_device=True`` (raw frames resized inside the step) against
    vpt_tpu's agent with the same option, on weights carried by
    ``from_jax_variables``: deterministic actions equal, vpred within 2e-3
    (the port's parity tolerance), over a stepped rollout with resets;
  * the host resize on the thread pool equal, bit for bit, to the same
    frames resized on one thread;
  * ``params_dtype="bfloat16"`` casts exactly the parameters of two or more
    dims, as tests/test_agent.py::test_params_dtype_bf16_serving holds
    vpt_tpu's, and serves finite actions; the IDM agent likewise."""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import jax
import numpy as np
import pytest
import torch

from vpt_tpu.agent import MineRLAgent as JaxAgent
from vpt_tpu_torch.agent import IDMAgent, MineRLAgent
from vpt_tpu_torch.checkpoint import from_jax_variables, load_state_dict_report, save_weights
from vpt_tpu_torch.ops.resize import resize_uint8_exact

TOL = 2e-3
TINY_KWARGS = dict(
    hidsize=64, impala_width=1, impala_chans=[4, 8], img_shape=[64, 64, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1}, impala_kwargs={"post_pool_groups": 1},
    n_recurrence_layers=2, timesteps=4, attention_heads=4, attention_memory_size=8,
    recurrence_type="transformer", attention_mask_style="clipped_causal", use_pre_lstm_ln=False,
    obs_processing_width=32,
)
PI_KWARGS = {"temperature": 2.0}


def _obs(n, seed):
    rng = np.random.default_rng(seed)
    return [{"pov": rng.integers(0, 256, (90, 160, 3), dtype=np.uint8)} for _ in range(n)]


@pytest.fixture(scope="module")
def device_resize_agents():
    ref = JaxAgent(policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS, batch_size=2, resize_on_device=True)
    ref._ensure_variables()
    port = MineRLAgent(device="cpu", policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS, batch_size=2,
                       resize_on_device=True)
    report = load_state_dict_report(port.policy, from_jax_variables(jax.tree.map(np.asarray, ref.variables)))
    assert not report["missing"] and not report["unexpected"] and not report["shape_mismatch"]
    return ref, port


def test_resize_on_device_rollout_matches_vpt_tpu(device_resize_agents):
    ref, port = device_resize_agents
    assert port._env_obs_to_agent(_obs(2, 0)).shape == (2, 1, 90, 160, 3)  # raw frames go to the device
    ref.reset()
    port.reset()
    for step in range(6):
        obs = _obs(2, 100 + step)
        first = np.array([step == 0, step in (0, 3)])
        a = port.get_action(obs, first=first, stochastic=False)
        b = ref.get_action(obs, first=first, stochastic=False)
        for i in range(2):
            assert a[i].keys() == b[i].keys()
            for k in a[i]:
                np.testing.assert_allclose(a[i][k], b[i][k], atol=1e-5)
        np.testing.assert_allclose(port._last_vpred, ref._last_vpred, atol=TOL, rtol=TOL)


def test_pooled_host_resize_equals_one_thread():
    agent = MineRLAgent(device="cpu", policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS, batch_size=5)
    assert agent._resize_pool is not None and agent._resize_pool._max_workers == 5
    obs = _obs(5, 1)
    pooled = agent._env_obs_to_agent(obs)
    one_thread = np.stack([resize_uint8_exact(o["pov"], (64, 64)) for o in obs])[:, None]
    assert pooled.dtype == np.uint8 and pooled.shape == (5, 1, 64, 64, 3)
    np.testing.assert_array_equal(pooled, one_thread)
    single = MineRLAgent(device="cpu", policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS, batch_size=1)
    assert single._resize_pool is None
    np.testing.assert_array_equal(single._env_obs_to_agent(obs[0]), one_thread[:1])


def _matrices_bf16_vectors_f32(module):
    for name, p in module.named_parameters():
        assert p.dtype == (torch.bfloat16 if p.dim() >= 2 else torch.float32), name
    for name, b in module.named_buffers():
        assert b.dtype != torch.bfloat16, name


def test_params_dtype_bf16_serving(tmp_path):
    base = MineRLAgent(device="cpu", policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS)
    path = str(tmp_path / "w.weights")
    save_weights(path, base.policy)
    agent = MineRLAgent(device="cpu", policy_kwargs=TINY_KWARGS, pi_head_kwargs=PI_KWARGS,
                        compute_dtype="bfloat16", params_dtype="bfloat16")
    _matrices_bf16_vectors_f32(agent.policy)
    agent.load_weights(path)
    _matrices_bf16_vectors_f32(agent.policy)
    for name, p in agent.policy.named_parameters():  # the loaded weights, rounded to bfloat16
        torch.testing.assert_close(p, base.policy.get_parameter(name).to(p.dtype), rtol=0, atol=0)
    action = agent.get_action(_obs(1, 9)[0], stochastic=False)
    assert np.isfinite(action["camera"]).all() and np.isfinite(agent._last_vpred).all()


def test_idm_params_dtype_bf16():
    kwargs = dict(TINY_KWARGS, img_shape=[64, 64, 4], attention_mask_style="none",
                  conv3d_params={"inchan": 3, "outchan": 4, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]})
    agent = IDMAgent(kwargs, {}, device="cpu", params_dtype="bfloat16")
    _matrices_bf16_vectors_f32(agent.policy)
    frames = np.random.default_rng(3).integers(0, 256, (6, 90, 160, 3), dtype=np.uint8)
    actions = agent.predict_actions(frames)
    assert actions["camera"].shape == (1, 6, 2) and np.isfinite(actions["camera"]).all()
