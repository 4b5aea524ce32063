"""The port's reference API against vpt_tpu's at tests/test_policy_api.py's
tiny config, on the CPU, from the same weights (crossed with
``from_jax_variables``): ``embed`` and ``heads_from_recurrent`` (whose
composition with the recurrent layer is ``forward``),
``get_output_for_observation``, ``v``, ``get_logprob_of_action``,
``get_kl_of_action_dists``, and MineRLAgent's action converters.

Tolerances: the port against vpt_tpu 2e-3 (tests/test_torch_policy.py); the
split forward against the whole one, and ``v`` against
``get_output_for_observation``, 1e-6 (the same arithmetic); the KL of a
distribution with itself 1e-6; the converters exactly."""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.agent import MineRLAgent as JaxAgent
from vpt_tpu.config import PolicyConfig as JaxConfig
from vpt_tpu.models import policy as jax_policy
from vpt_tpu.models.heads import HeadSpec as JaxHeadSpec
from vpt_tpu_torch.agent import MineRLAgent
from vpt_tpu_torch.checkpoint import from_jax_variables
from vpt_tpu_torch.config import PolicyConfig
from vpt_tpu_torch.models.heads import HeadSpec
from vpt_tpu_torch.models.policy import (
    MinecraftAgentPolicy,
    get_kl_of_action_dists,
    get_logprob_of_action,
    policy_initial_state,
)

TOL = 2e-3
TINY_KWARGS = dict(
    hidsize=64, impala_width=1, impala_chans=[4, 8], obs_processing_width=32, img_shape=[32, 32, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1}, impala_kwargs={"post_pool_groups": 1},
    recurrence_type="transformer", n_recurrence_layers=2, timesteps=4, attention_heads=4,
    attention_memory_size=8, use_pre_lstm_ln=False,
)
SPECS = (HeadSpec("buttons", (1,), 23), HeadSpec("camera", (1,), 9))
JAX_SPECS = (JaxHeadSpec("buttons", (1,), 23), JaxHeadSpec("camera", (1,), 9))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", params=["transformer", "multi_layer_lstm"])
def models(request):
    kwargs = dict(TINY_KWARGS, recurrence_type=request.param)
    jcfg = JaxConfig.from_kwargs(kwargs)
    ref = jax_policy.MinecraftAgentPolicy(cfg=jcfg, head_specs=JAX_SPECS, temperature=2.0)
    variables = jax.jit(ref.init)(jax.random.PRNGKey(0), jnp.zeros((2, 1, 32, 32, 3), jnp.uint8),
                                  jnp.zeros((2, 1), bool), jax_policy.policy_initial_state(jcfg, 2))
    variables = jax.tree.map(np.asarray, dict(variables))
    port = MinecraftAgentPolicy(PolicyConfig.from_kwargs(kwargs), SPECS, temperature=2.0).eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return ref, variables, port


def _img(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@torch.no_grad()
def test_heads_from_recurrent_of_embed_equals_forward_and_vpt_tpu(models):
    ref, variables, port = models
    img = _img((2, 4, 32, 32, 3), 0)
    first = np.zeros((2, 4), bool)
    first[:, 0] = True
    state = policy_initial_state(port.cfg, 2)
    x = port.embed(_t(img))
    assert x.shape == (2, 4, 64)
    y, state_split = port.net.recurrent_layer(x, _t(first), state)
    split = port.heads_from_recurrent(y)
    whole, state_whole = port(_t(img), _t(first), state)
    for k in ("buttons", "camera"):
        np.testing.assert_allclose(split["pi_logits"][k].numpy(), whole["pi_logits"][k].numpy(), atol=1e-6)
    np.testing.assert_allclose(split["vpred"].numpy(), whole["vpred"].numpy(), atol=1e-6)
    jstate = jax_policy.policy_initial_state(ref.cfg, 2)
    jx = ref.apply(variables, jnp.asarray(img), method="embed")
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=TOL, rtol=TOL)
    jy, _ = ref.apply(variables, jx, jnp.asarray(first), jstate,
                      method=lambda m, *a: m.net.recurrent_layer(*a))
    jsplit = ref.apply(variables, jy, method="heads_from_recurrent")
    for k in ("buttons", "camera"):
        np.testing.assert_allclose(split["pi_logits"][k].numpy(), np.asarray(jsplit["pi_logits"][k]), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_allclose(split["vpred"].numpy(), np.asarray(jsplit["vpred"]), atol=TOL, rtol=TOL)


@torch.no_grad()
def test_get_output_for_observation_and_v_match_vpt_tpu(models):
    """Three single observations per stream with the state carried."""
    ref, variables, port = models
    jstate = jax_policy.policy_initial_state(ref.cfg, 2)
    state = policy_initial_state(port.cfg, 2)
    for step in range(3):
        img = _img((2, 32, 32, 3), step + 1)
        first = np.array([step == 0, step == 2])
        pd, vpred, state_next = port.get_output_for_observation(_t(img), state, _t(first))
        assert pd["buttons"].shape == (2, 1, 23) and vpred.shape == (2,)
        np.testing.assert_allclose(port.v(_t(img), _t(first), state).numpy(), vpred.numpy(), atol=1e-6)
        jpd, jv, jstate = ref.apply(variables, jnp.asarray(img), jstate, jnp.asarray(first),
                                    method="get_output_for_observation")
        for k in ("buttons", "camera"):
            np.testing.assert_allclose(pd[k].numpy(), np.asarray(jpd[k]), atol=TOL, rtol=TOL)
        np.testing.assert_allclose(vpred.numpy(), np.asarray(jv), atol=TOL, rtol=TOL)
        state = state_next


@torch.no_grad()
def test_logprob_and_kl_functions_match_vpt_tpu(models):
    ref, variables, port = models
    img = _img((2, 32, 32, 3), 5)
    first = np.zeros(2, bool)
    pd, _, _ = port.get_output_for_observation(_t(img), policy_initial_state(port.cfg, 2), _t(first))
    pd2, _, _ = port.get_output_for_observation(_t(_img((2, 32, 32, 3), 6)), policy_initial_state(port.cfg, 2),
                                                _t(first))
    action = {"buttons": torch.tensor([[3], [22]]), "camera": torch.tensor([[0], [8]])}
    jpd, jpd2 = ({k: v.numpy() for k, v in d.items()} for d in (pd, pd2))
    jaction = {k: v.numpy() for k, v in action.items()}
    lp = get_logprob_of_action(SPECS, pd, action)
    assert lp.shape == (2,) and torch.isfinite(lp).all()
    np.testing.assert_allclose(lp.numpy(), np.asarray(jax_policy.get_logprob_of_action(JAX_SPECS, jpd, jaction)),
                               rtol=1e-6, atol=1e-6)
    kl = get_kl_of_action_dists(SPECS, pd, pd2)
    np.testing.assert_allclose(kl.numpy(), np.asarray(jax_policy.get_kl_of_action_dists(JAX_SPECS, jpd, jpd2)),
                               rtol=1e-5, atol=1e-7)
    assert (kl > 0).all()
    np.testing.assert_allclose(get_kl_of_action_dists(SPECS, pd, pd).numpy(), 0.0, atol=1e-6)


def test_agent_action_converters_match_vpt_tpu():
    """``_agent_action_to_env`` and ``_env_action_to_agent`` (with and
    without ``check_if_null``) against vpt_tpu's agent, for a LSTM policy
    (whose ``ring_cache`` is ignored) and a batch of actions."""
    kwargs = dict(TINY_KWARGS, recurrence_type="multi_layer_lstm")
    port = MineRLAgent(device="cpu", policy_kwargs=kwargs, batch_size=2, ring_cache=True)
    assert sorted(port.hidden_state[0]) == ["c", "h"]
    ref = JaxAgent(policy_kwargs=kwargs, batch_size=2)
    rng = np.random.default_rng(0)
    agent_action = {"buttons": rng.integers(0, 8641, (5, 1)), "camera": rng.integers(0, 121, (5, 1))}
    env = port._agent_action_to_env(agent_action)
    jenv = ref._agent_action_to_env(agent_action)
    assert env.keys() == jenv.keys()
    for k in env:
        np.testing.assert_array_equal(env[k], jenv[k], err_msg=k)
    back = port._env_action_to_agent(env)
    jback = ref._env_action_to_agent(jenv)
    for k in ("buttons", "camera"):
        np.testing.assert_array_equal(back[k], jback[k], err_msg=k)
    single = {k: v[0] for k, v in env.items()}
    one = port._env_action_to_agent({k: np.asarray(v)[None] for k, v in single.items()})
    np.testing.assert_array_equal(one["buttons"], back["buttons"][:1])
    null = {k: np.zeros_like(np.asarray(v))[None] for k, v in single.items()}
    assert port._env_action_to_agent(null, check_if_null=True) is None
    assert ref._env_action_to_agent(null, check_if_null=True) is None
    not_null = port._env_action_to_agent(null)
    np.testing.assert_array_equal(not_null["buttons"], ref._env_action_to_agent(null)["buttons"])


def test_agent_serves_none_and_lstm_policies():
    """MineRLAgent steps a "none" policy (no state) and an LSTM one (its
    carries advance; a reset clears them)."""
    obs = [{"pov": np.random.default_rng(i).integers(0, 256, (36, 64, 3), dtype=np.uint8)} for i in range(2)]
    for recurrence_type in ("none", "multi_masked_lstm"):
        agent = MineRLAgent(device="cpu", policy_kwargs=dict(TINY_KWARGS, recurrence_type=recurrence_type),
                            batch_size=2)
        actions = agent.get_action(obs, first=np.array([True, True]))
        assert len(actions) == 2 and "camera" in actions[0]
        if recurrence_type == "none":
            assert agent.hidden_state is None
            continue
        assert agent.hidden_state[0]["h"].abs().max() > 0
        agent.reset()
        assert agent.hidden_state[0]["h"].abs().max() == 0
