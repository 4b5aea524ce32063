"""The whole port against vpt_tpu at a tiny config: MinecraftAgentPolicy
forward (chunked and stepped) on weights carried by ``from_jax_variables``
at tolerance 2e-3 (as tests/test_full_geometry_parity.py), MineRLAgent
rollouts with resets, and checkpoint I/O."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.actions.mapping import CameraHierarchicalMapping as JaxMapping
from vpt_tpu.agent import MineRLAgent as JaxAgent
from vpt_tpu.checkpoint import save_model_parameters
from vpt_tpu.config import PolicyConfig as JaxConfig
from vpt_tpu.models.heads import head_specs_from_space as jax_head_specs
from vpt_tpu.models.policy import MinecraftAgentPolicy as JaxPolicy
from vpt_tpu.models.policy import policy_initial_state as jax_initial_state
from vpt_tpu.spaces import DictType as JaxDictType
from vpt_tpu_torch.actions import CameraHierarchicalMapping
from vpt_tpu_torch.agent import MineRLAgent
from vpt_tpu_torch.checkpoint import (
    from_jax_variables,
    load_model_parameters,
    load_state_dict_report,
)
from vpt_tpu_torch.config import PolicyConfig, foundation_policy_config
from vpt_tpu_torch.models.heads import head_specs_from_space
from vpt_tpu_torch.models.policy import MinecraftAgentPolicy, policy_initial_state
from vpt_tpu_torch.spaces import DictType

TOL = 2e-3
TINY_KWARGS = dict(
    hidsize=64,
    impala_width=1,
    impala_chans=[4, 8],
    img_shape=[32, 32, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1},
    impala_kwargs={"post_pool_groups": 1},
    n_recurrence_layers=2,
    timesteps=4,
    attention_heads=4,
    attention_memory_size=8,
    recurrence_type="transformer",
    attention_mask_style="clipped_causal",
    use_pre_lstm_ln=False,
    obs_processing_width=32,
)
PI_KWARGS = {"temperature": 2.0}
STATS = {"running_mean": jnp.asarray([0.5]), "running_mean_sq": jnp.asarray([1.5]),
         "debiasing_term": jnp.asarray(0.8)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def policies():
    jcfg = JaxConfig.from_kwargs(TINY_KWARGS)
    jspecs = jax_head_specs(JaxDictType(**JaxMapping(n_camera_bins=11).get_action_space_update()))
    ref = JaxPolicy(cfg=jcfg, head_specs=jspecs, temperature=2.0)
    img = jnp.zeros((1, 1, 32, 32, 3), jnp.uint8)
    variables = jax.jit(ref.init)(jax.random.PRNGKey(0), img, jnp.zeros((1, 1), bool),
                                  jax_initial_state(jcfg, 1))
    variables = {"params": variables["params"], "stats": {"value_head": STATS}}
    cfg = PolicyConfig.from_kwargs(TINY_KWARGS)
    specs = head_specs_from_space(DictType(**CameraHierarchicalMapping(n_camera_bins=11).get_action_space_update()))
    port = MinecraftAgentPolicy(cfg, specs, temperature=2.0).eval()
    port.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables)), strict=True)
    return ref, jcfg, variables, port, cfg


def _episode(T=12, B=2, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, T, 32, 32, 3), dtype=np.uint8)
    first = np.zeros((B, T), bool)
    first[:, 0] = True
    first[0, T // 2] = True  # mid-episode resets
    first[1, (3 * T) // 4] = True
    return img, first


def _compare(out, jout, sl=slice(None)):
    for k, v in out["pi_logits"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jout["pi_logits"][k])[:, sl], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out["vpred"].numpy(), np.asarray(jout["vpred"])[:, sl], atol=TOL, rtol=TOL)


@pytest.fixture(scope="module")
def jax_chunks(policies):
    """JAX outputs of a 12-frame episode, three (2, 4) chunks with carried state."""
    ref, jcfg, variables, _, _ = policies
    img, first = _episode()
    apply = jax.jit(ref.apply)
    jstate, outs = jax_initial_state(jcfg, 2), []
    for c in range(3):
        sl = slice(4 * c, 4 * c + 4)
        jout, jstate = apply(variables, jnp.asarray(img[:, sl]), jnp.asarray(first[:, sl]), jstate)
        outs.append(jax.tree.map(np.asarray, jout))
    return img, first, outs


@torch.no_grad()
def test_policy_chunked_forward_matches_jax(policies, jax_chunks):
    *_, port, cfg = policies
    img, first, outs = jax_chunks
    state = policy_initial_state(cfg, 2)
    for c, jout in enumerate(outs):
        sl = slice(4 * c, 4 * c + 4)
        out, state = port(_t(img[:, sl]), _t(first[:, sl]), state)
        _compare(out, jout)


@torch.no_grad()
@pytest.mark.parametrize("ring", [True, False])
def test_policy_stepped_matches_jax_chunked(policies, jax_chunks, ring):
    *_, port, cfg = policies
    img, first, outs = jax_chunks
    state = policy_initial_state(cfg, 2, ring=ring)
    for i in range(img.shape[1]):
        out, state = port(_t(img[:, i:i + 1]), _t(first[:, i:i + 1]), state)
        _compare(out, outs[i // 4], slice(i % 4, i % 4 + 1))


@torch.no_grad()
def test_policy_bfloat16_tracks_jax_bfloat16(policies):
    """compute_dtype="bfloat16" on both sides: bf16 rounds at other places in
    the two frameworks, so the bound is loose (5e-2 on log-probs and vpred)."""
    ref, jcfg, variables, port, cfg = policies
    img, first = _episode(T=4, seed=2)
    jref = JaxPolicy(cfg=jcfg.replace(compute_dtype="bfloat16"), head_specs=ref.head_specs, temperature=2.0)
    bf = MinecraftAgentPolicy(cfg.replace(compute_dtype="bfloat16"), port.head_specs, temperature=2.0).eval()
    bf.load_state_dict(port.state_dict())
    jout, _ = jax.jit(jref.apply)(variables, jnp.asarray(img), jnp.asarray(first),
                                  jax_initial_state(jcfg.replace(compute_dtype="bfloat16"), 2))
    out, state = bf(_t(img), _t(first), policy_initial_state(bf.cfg, 2))
    assert state[0]["k"].dtype == torch.bfloat16
    for k, v in out["pi_logits"].items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), np.asarray(jout["pi_logits"][k]), atol=5e-2)
    np.testing.assert_allclose(out["vpred"].numpy(), np.asarray(jout["vpred"]), atol=5e-2)


def test_policy_act_shapes(policies):
    *_, port, cfg = policies
    img, first = _episode(T=1)
    with torch.no_grad():
        action, _, info = port.act(_t(img[:, 0]), _t(first[:, 0]), policy_initial_state(cfg, 2),
                                   generator=torch.Generator().manual_seed(0))
    assert action["buttons"].shape == (2, 1) and action["camera"].shape == (2, 1)
    assert info["log_prob"].shape == (2,) and torch.isfinite(info["vpred"]).all()


def test_foundation_config_is_the_2x_model():
    cfg = foundation_policy_config(2)
    assert (cfg.hidsize, cfg.attention_heads, cfg.n_recurrence_layers, cfg.maxlen) == (2048, 16, 4, 128)
    assert cfg.chans == (128, 256, 256)
    with torch.device("meta"):
        specs = head_specs_from_space(DictType(**CameraHierarchicalMapping(n_camera_bins=11).get_action_space_update()))
        model = MinecraftAgentPolicy(cfg, specs, temperature=2.0, device="meta")
    n = sum(p.numel() for p in model.parameters()) + sum(b.numel() for b in model.buffers())
    assert n == 248_495_294


# ---------------------------------------------------------------------------
# MineRLAgent
# ---------------------------------------------------------------------------


def _obs(n, seed):
    rng = np.random.default_rng(seed)
    return [{"pov": rng.integers(0, 256, (90, 160, 3), dtype=np.uint8)} for _ in range(n)]


@pytest.fixture(scope="module")
def agents():
    kwargs = dict(TINY_KWARGS, img_shape=[64, 64, 3])
    ref = JaxAgent(policy_kwargs=kwargs, pi_head_kwargs=PI_KWARGS, batch_size=2)
    ref._ensure_variables()
    variables = jax.tree.map(np.asarray, ref.variables)
    port = MineRLAgent(device="cpu", policy_kwargs=kwargs, pi_head_kwargs=PI_KWARGS, batch_size=2)
    report = load_state_dict_report(port.policy, from_jax_variables(variables))
    assert not report["missing"] and not report["unexpected"] and not report["shape_mismatch"]
    return ref, port, variables


@pytest.mark.parametrize("ring_cache", [True, False])
def test_agent_deterministic_rollout_with_resets_matches_jax(agents, ring_cache):
    ref, port, _ = agents
    ref.ring_cache = port.ring_cache = ring_cache
    ref.reset()
    port.reset()
    for step in range(6):
        obs = _obs(2, step)
        first = np.array([step == 0, step in (0, 3)])
        a = port.get_action(obs, first=first, stochastic=False)
        b = ref.get_action(obs, first=first, stochastic=False)
        for i in range(2):
            assert a[i].keys() == b[i].keys()
            for k in a[i]:
                np.testing.assert_allclose(a[i][k], b[i][k], atol=1e-5)
        np.testing.assert_allclose(port._last_vpred, ref._last_vpred, atol=TOL, rtol=TOL)


def test_agent_stochastic_actions_are_valid_and_seeded(agents):
    _, port, _ = agents
    port.reset()
    actions = port.get_action(_obs(2, 9))
    assert isinstance(actions, list) and len(actions) == 2
    for act in actions:
        assert act["camera"].shape == (2,) and np.all(np.abs(act["camera"]) <= 10.0)
        assert all(act[k] in (0, 1) for k in act if k != "camera")
    handle = port.dispatch_action(_obs(2, 10))
    assert port.collect_action(handle)[0].keys() == actions[0].keys()


def test_agent_load_weights_from_reference_files(agents, tmp_path):
    _, port, variables = agents
    sd = from_jax_variables(variables)
    path = tmp_path / "tiny.weights"
    torch.save(sd, path)
    fresh = MineRLAgent(device="cpu", policy_kwargs=dict(TINY_KWARGS, img_shape=[64, 64, 3]),
                        pi_head_kwargs=PI_KWARGS, batch_size=2, seed=3)
    fresh.load_weights(str(path))
    for k, v in fresh.policy.state_dict().items():
        assert torch.equal(v, port.policy.state_dict()[k]), k

    model_path = tmp_path / "tiny.model"
    save_model_parameters(str(model_path), TINY_KWARGS, {"temperature": "2.0"})
    policy_kwargs, pi_kwargs = load_model_parameters(str(model_path))
    assert policy_kwargs == TINY_KWARGS and pi_kwargs == {"temperature": 2.0}


class _Extra:
    pass


def test_tolerant_unpickler_stubs_unknown_classes(tmp_path):
    blob = {"model": {"args": {"net": {"args": {"hidsize": 8}}, "pi_head_opts": {}}}, "extra": _Extra()}
    raw = pickle.dumps(blob, protocol=0).replace(_Extra.__module__.encode(), b"module_that_is_gone")
    path = tmp_path / "x.model"
    path.write_bytes(raw)
    assert load_model_parameters(str(path)) == ({"hidsize": 8}, {})
