"""The port's PPO trainer (vpt_tpu_torch/training/rl.py) and its head
functions against vpt_tpu's at tests/test_rl.py's tiny config, on the CPU.

The update is held against vpt_tpu's on a trajectory that vpt_tpu's
PPOTrainer collected (mid-window episode resets, random rewards), from the
same weights and anchor (crossed with ``from_jax_variables``), at
n_epochs=2 and n_minibatches=1 (a one-minibatch epoch makes the stream
permutation irrelevant).  Tolerances:
  * GAE against vpt_tpu's and against a per-episode loop oracle: 1e-5;
  * entropy, KL and the EWMA functions: rtol/atol 1e-6;
  * the metrics of the last (second) step: rtol 1e-4, and the KL estimates
    (anchor_kl, approx_kl, aux_clone_kl: means of differences of nearly
    equal log-probabilities, ~1e-5) rtol 2e-2, atol 1e-7.  The first step
    agrees to 1e-7; Adam's first step moves every entry by lr whatever the
    size of its gradient, so entries whose gradient is rounding noise move
    apart by up to 2·lr, and the second step's loss by ~1e-5 relative;
  * the folded EWMA stats: rtol 1e-6;
  * parameters after the update's two steps, as tests/test_torch_training.py:
    every entry within 3·lr a step taken (Adam divides each entry's moment by
    its square root, so an entry whose gradient is rounding noise may move by
    up to lr a step either way), all but 0.1% of each tensor's entries within
    atol 2e-6 + rtol 1e-5; after the aux phase's two more steps, all but 1%
    (the noise-gradient entries, such as a whole row of a weight behind a
    unit whose input is near zero, drift further with each step);
  * the snapshot re-forward against the stepped collection: rtol 1e-4,
    atol 1e-5 (as tests/test_rl.py).
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import io
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.checkpoint.torch_import import variables_to_state_dict
from vpt_tpu.models import heads as jax_heads
from vpt_tpu.parallel.mesh import make_mesh
from vpt_tpu.training import rl as jax_rl
from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
from vpt_tpu_torch.checkpoint import from_jax_variables, save_model_parameters, save_weights
from vpt_tpu_torch.models import heads
from vpt_tpu_torch.models.heads import dict_logprob
from vpt_tpu_torch.training import rl
from vpt_tpu_torch.utils.metrics import MetricsLogger

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_KWARGS = dict(
    hidsize=64,
    impala_width=1,
    impala_chans=[4, 8],
    img_shape=[32, 32, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1},
    impala_kwargs={"post_pool_groups": 1},
    n_recurrence_layers=2,
    timesteps=16,
    attention_heads=4,
    attention_memory_size=32,
    recurrence_type="transformer",
    attention_mask_style="clipped_causal",
    use_pre_lstm_ln=False,
    obs_processing_width=32,
)
PI_KWARGS = {"temperature": 2.0}
LR = 1e-3
PARITY_HP = dict(rollout_len=6, n_minibatches=1, n_epochs=2, learning_rate=LR, aux_phase_every=1000,
                 aux_epochs=2)


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _envs(n, done_prob=0.0):
    return [MockMinecraftEnv(seed=i, done_prob=done_prob) for i in range(n)]


def _trainer(**hp_kw):
    hp = dict(rollout_len=8, n_minibatches=2, n_epochs=2)
    hp.update(hp_kw)
    return rl.PPOTrainer(TINY_KWARGS, PI_KWARGS, hp=rl.PPOHyperparams(**hp), device="cpu", seed=0)


# ---------------------------------------------------------------------- GAE


def _gae_loop_oracle(rewards, values, firsts, last_value, last_first, gamma, lam):
    b, t_len = rewards.shape
    adv = np.zeros((b, t_len), np.float64)
    for i in range(b):
        next_adv = 0.0
        for t in reversed(range(t_len)):
            last = t == t_len - 1
            nonterm = 0.0 if (last_first[i] if last else firsts[i, t + 1]) else 1.0
            next_v = last_value[i] if last else values[i, t + 1]
            next_adv = rewards[i, t] + gamma * next_v * nonterm - values[i, t] + gamma * lam * nonterm * next_adv
            adv[i, t] = next_adv
    return adv, adv + values


@pytest.mark.parametrize("gamma,lam", [(0.99, 0.95), (0.999, 0.95), (0.0, 0.0)])
def test_gae_matches_vpt_tpu_and_loop_oracle(gamma, lam):
    rng = np.random.default_rng(0)
    b, t_len = 3, 17
    rewards = rng.normal(size=(b, t_len)).astype(np.float32)
    values = rng.normal(size=(b, t_len)).astype(np.float32)
    firsts = rng.random((b, t_len)) < 0.2
    firsts[:, 0] = True
    last_value = rng.normal(size=b).astype(np.float32)
    last_first = np.array([True, False, False])
    adv, ret = rl.compute_gae(rewards, values, firsts, last_value, last_first, gamma, lam)
    assert adv.dtype == ret.dtype == torch.float32 and adv.shape == (b, t_len)
    jadv, jret = jax_rl.compute_gae(rewards, values, firsts, last_value, last_first, gamma, lam)
    oadv, oret = _gae_loop_oracle(rewards, values, firsts, last_value, last_first, gamma, lam)
    for got, want in ((adv, jadv), (ret, jret), (adv, oadv), (ret, oret)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -------------------------------------------------------------------- heads


def _specs():
    from vpt_tpu.actions.mapping import CameraHierarchicalMapping as JaxMapping
    from vpt_tpu.spaces import DictType as JaxDictType
    from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
    from vpt_tpu_torch.spaces import DictType

    jspace = JaxMapping(n_camera_bins=11).get_action_space_update()
    space = CameraHierarchicalMapping(n_camera_bins=11).get_action_space_update()
    return jax_heads.head_specs_from_space(JaxDictType(**jspace)), heads.head_specs_from_space(DictType(**space))


def _logits(rng, shape):
    x = rng.normal(size=shape).astype(np.float32) * 3
    return x - np.log(np.exp(x).sum(-1, keepdims=True))  # log-softmax


def test_entropy_and_kl_match_vpt_tpu():
    jspecs, specs = _specs()
    rng = np.random.default_rng(1)
    q = {s.key: _logits(rng, (3, 5) + s.value_shape + (s.num_actions,)) for s in specs}
    p = {s.key: _logits(rng, (3, 5) + s.value_shape + (s.num_actions,)) for s in specs}
    tq = {k: torch.from_numpy(v) for k, v in q.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jq = {k: jnp.asarray(v) for k, v in q.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for s, js in zip(specs, jspecs):
        ent = heads.categorical_entropy(tq[s.key], s)
        kl = heads.categorical_kl(tq[s.key], tp[s.key], s)
        np.testing.assert_allclose(ent.numpy(), np.asarray(jax_heads.categorical_entropy(jq[s.key], js)),
                                   rtol=1e-6, atol=1e-6)
        jkl = np.asarray(jax_heads.categorical_kl(jq[s.key], jp[s.key], js))
        assert kl.shape == jkl.shape == (3, 5, 1)
        np.testing.assert_allclose(kl.numpy(), jkl, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(heads.dict_entropy(tq, specs).numpy(), np.asarray(jax_heads.dict_entropy(jq, jspecs)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(heads.dict_kl(tq, tp, specs).numpy(), np.asarray(jax_heads.dict_kl(jq, jp, jspecs)),
                               rtol=1e-6, atol=1e-6)
    assert np.all(heads.dict_kl(tq, tq, specs).numpy() == 0.0)


@pytest.mark.parametrize("per_element_update", [False, True])
def test_ewma_functions_match_vpt_tpu(per_element_update):
    rng = np.random.default_rng(2)
    stats = {"running_mean": np.array([0.3], np.float32), "running_mean_sq": np.array([1.7], np.float32),
             "debiasing_term": np.array(0.02, np.float32)}
    target = rng.normal(size=(4, 6, 1)).astype(np.float32) * 5 + 2
    ours = heads.ewma_updated_stats({k: torch.from_numpy(v) for k, v in stats.items()}, torch.from_numpy(target),
                                    per_element_update=per_element_update)
    theirs = jax_heads.ewma_updated_stats({k: jnp.asarray(v) for k, v in stats.items()}, jnp.asarray(target),
                                          per_element_update=per_element_update)
    for k in stats:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=1e-6, atol=1e-6, err_msg=k)
    x = rng.normal(size=(4, 6, 1)).astype(np.float32)
    for port_fn, jax_fn in ((heads.ewma_normalize, jax_heads.ewma_normalize),
                            (heads.ewma_denormalize, jax_heads.ewma_denormalize)):
        np.testing.assert_allclose(port_fn(ours, torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_fn(theirs, jnp.asarray(x))), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------- update against vpt_tpu


def _port_traj(jtraj):
    traj = {k: np.asarray(v) for k, v in jtraj.items() if k != "initial_state"}
    traj["initial_state"] = [{k: torch.from_numpy(np.array(v)) for k, v in blk.items()}
                             for blk in jtraj["initial_state"]]
    return traj


def _port_state_dict(pt):
    return {k: v.detach().clone() for k, v in pt.policy.state_dict().items()}


@pytest.fixture(scope="module")
def parity():
    """One trajectory collected by vpt_tpu's PPOTrainer; one update and then
    one aux phase on it by both trainers from the same weights and anchor."""
    mesh = make_mesh(n_dp=1, devices=jax.devices()[:1])
    jt = jax_rl.PPOTrainer(TINY_KWARGS, PI_KWARGS, hp=jax_rl.PPOHyperparams(**PARITY_HP), mesh=mesh, seed=0)
    jt.init()
    variables0 = _host(jt.variables)
    pt = rl.PPOTrainer(TINY_KWARGS, PI_KWARGS, hp=rl.PPOHyperparams(**PARITY_HP), device="cpu", seed=0)
    pt.init()
    pt.policy.load_state_dict(from_jax_variables(variables0), strict=True)
    pt.anchor = pt._snapshot_anchor()

    rng = np.random.default_rng(3)
    jtraj, _, _ = jt.collect(_envs(4, done_prob=0.3), reward_fn=lambda a, o, r, d: float(rng.normal()))
    assert np.asarray(jtraj["firsts"])[:, 1:].any(), "the fixture must hold mid-window resets"
    traj = _port_traj(jtraj)
    out = {"jt": jt, "pt": pt}
    out["j_metrics"] = jt.update(jtraj)
    out["p_metrics"] = pt.update(traj)
    out["j_after_update"] = variables_to_state_dict(_host(jt.variables))
    out["p_after_update"] = _port_state_dict(pt)
    out["j_aux"] = jt._aux_phase()
    out["p_aux"] = pt._aux_phase()
    out["j_after_aux"] = variables_to_state_dict(_host(jt.variables))
    out["p_after_aux"] = _port_state_dict(pt)
    return out


def _params_close(ours, theirs, steps, outliers):
    for name, p in ours.items():
        ref = np.asarray(theirs[name]).reshape(p.shape)
        np.testing.assert_allclose(p.numpy(), ref, rtol=0, atol=3 * LR * steps, err_msg=name)
        off = np.abs(p.numpy() - ref) > 2e-6 + 1e-5 * np.abs(ref)
        assert off.mean() <= outliers, (name, int(off.sum()), off.size)


def test_update_metrics_and_folded_stats_match_vpt_tpu(parity):
    ours, theirs = parity["p_metrics"], parity["j_metrics"]
    assert ours.keys() == theirs.keys()
    for key in ("loss", "pg_loss", "v_loss", "entropy", "grad_norm", "clip_frac", "mean_reward", "mean_return",
                "kl_coef"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-4, atol=1e-7, err_msg=key)
    for key in ("anchor_kl", "approx_kl"):
        assert theirs[key] > 1e-6, (key, theirs[key])  # one Adam step moved the policy off the anchor and θ_old
        np.testing.assert_allclose(ours[key], theirs[key], rtol=2e-2, atol=1e-7, err_msg=key)
    assert parity["pt"].update_count == 1
    for k in ("running_mean", "running_mean_sq", "debiasing_term"):
        name = f"value_head.normalizer.{k}"
        got, want = parity["p_after_update"][name], np.asarray(parity["j_after_update"][name])
        assert np.all(got.numpy() != 0.0), name
        np.testing.assert_allclose(got.numpy(), want.reshape(got.shape), rtol=1e-6, atol=0, err_msg=name)


def test_update_parameters_match_vpt_tpu(parity):
    """Both PPO steps move every parameter, the value head's too, as vpt_tpu's."""
    _params_close(parity["p_after_update"], parity["j_after_update"], steps=2, outliers=1e-3)
    moved = parity["p_after_update"]["value_head.linear.weight"] != parity["pt"].anchor.value_head.linear.weight
    assert moved.any()


def test_aux_phase_matches_vpt_tpu(parity):
    ours, theirs = parity["p_aux"], parity["j_aux"]
    assert ours.keys() == theirs.keys() == {"aux_v_loss", "aux_clone_kl"}
    np.testing.assert_allclose(ours["aux_v_loss"], theirs["aux_v_loss"], rtol=1e-4, err_msg="aux_v_loss")
    assert theirs["aux_clone_kl"] > 1e-6  # the first aux step moved the policy off its pre-phase snapshot
    np.testing.assert_allclose(ours["aux_clone_kl"], theirs["aux_clone_kl"], rtol=2e-2, atol=1e-7,
                               err_msg="aux_clone_kl")
    assert parity["pt"]._aux_buffer == []
    _params_close(parity["p_after_aux"], parity["j_after_aux"], steps=4, outliers=1e-2)


# ------------------------------------------------------------ the port alone


def test_collect_shapes_and_resets():
    trainer = _trainer(rollout_len=6)
    envs = _envs(2, done_prob=0.35)
    traj, obs, firsts = trainer.collect(envs, reward_fn=lambda a, o, r, d: 1.0)
    assert traj["frames"].shape == (2, 6, 32, 32, 3) and traj["frames"].dtype == np.uint8
    for key in ("buttons", "camera", "logp_old", "values", "rewards", "firsts"):
        assert traj[key].shape == (2, 6), key
    assert traj["last_value"].shape == (2,) and traj["last_first"].shape == (2,)
    assert np.all(traj["rewards"] == 1.0) and np.all(traj["firsts"][:, 0])
    assert np.isfinite(traj["logp_old"]).all() and np.isfinite(traj["values"]).all()
    assert traj["firsts"][:, 1:].any() or firsts.any()
    assert [tuple(blk["k"].shape) for blk in traj["initial_state"]] == [(2, 16, 64)] * 2
    traj2, _, _ = trainer.collect(envs, obs, firsts)
    np.testing.assert_array_equal(traj2["firsts"][:, 0], firsts)


@pytest.mark.parametrize("groups", [1, 2])
def test_collect_snapshot_reforward_consistency(groups):
    """Re-forwarding the collected frames as one chunk from
    ``initial_state`` reproduces the stepped collection's log-probs and
    values, with G groups' snapshots concatenated and mid-stream resets."""
    trainer = _trainer(rollout_len=6, n_minibatches=1, n_collect_groups=groups)
    envs = _envs(4, done_prob=0.3)
    traj, obs, firsts = trainer.collect(envs)
    traj, obs, firsts = trainer.collect(envs, obs, firsts)  # carried mid-stream state: the snapshot is not empty
    assert traj["initial_state"][0]["state_mask"].any()
    with torch.no_grad():
        out, _ = trainer.policy(torch.from_numpy(traj["frames"]), torch.from_numpy(traj["firsts"]),
                                traj["initial_state"])
    actions = {"buttons": torch.from_numpy(traj["buttons"])[..., None],
               "camera": torch.from_numpy(traj["camera"])[..., None]}
    logp = dict_logprob(out["pi_logits"], actions, trainer.head_specs)
    np.testing.assert_allclose(logp.numpy(), traj["logp_old"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["vpred"][..., 0].numpy(), traj["values"], rtol=1e-4, atol=1e-5)


def test_update_recompute_matches_collection_with_mid_window_resets():
    """At lr=0 the re-forward reproduces the collection's log-probs: ratio 1
    everywhere."""
    trainer = _trainer(rollout_len=6, n_minibatches=1, n_epochs=1, learning_rate=0.0, normalize_advantages=False)
    traj, _, _ = trainer.collect(_envs(4, done_prob=0.4), reward_fn=lambda a, o, r, d: 1.0)
    assert traj["firsts"][:, 1:].any()
    metrics = trainer.update(traj)
    assert metrics["approx_kl"] < 1e-6 and metrics["clip_frac"] == 0.0, metrics


def test_chunked_anchor_forward_matches_one_shot():
    trainer = _trainer(rollout_len=8)
    traj, _, _ = trainer.collect(_envs(4, done_prob=0.2))
    frames, firsts = torch.from_numpy(traj["frames"]), torch.from_numpy(traj["firsts"])
    trainer.hp.anchor_fwd_max_frames = 0  # one shot
    one_shot = trainer._anchor_logits(frames, firsts, traj["initial_state"])
    trainer.hp.anchor_fwd_max_frames = 17  # 2 streams a chunk: the largest divisor of 4 that fits
    calls = []
    forward = trainer.anchor.forward
    trainer.anchor.forward = lambda img, *a, **kw: calls.append(img.shape[0]) or forward(img, *a, **kw)
    chunked = trainer._anchor_logits(frames, firsts, traj["initial_state"])
    assert calls == [2, 2]
    for key in one_shot:
        np.testing.assert_allclose(chunked[key].numpy(), one_shot[key].numpy(), rtol=1e-6, atol=1e-6, err_msg=key)


def test_each_epoch_minibatches_partition_the_streams():
    trainer = _trainer(rollout_len=4, n_minibatches=3, n_epochs=2)
    traj, _, _ = trainer.collect(_envs(6), reward_fn=lambda a, o, r, d: 1.0)
    traj["logp_old"][:, 0] = -np.arange(6) - 1.0  # stream i's marker
    seen = []
    step = trainer._ppo_step
    trainer._ppo_step = lambda mb, state, kl: seen.append(sorted(int(-x - 1) for x in mb["logp_old"][:, 0])) \
        or step(mb, state, kl)
    trainer.update(traj)
    assert len(seen) == 6 and all(len(s) == 2 for s in seen)
    for epoch in (seen[:3], seen[3:]):
        assert sorted(i for s in epoch for i in s) == list(range(6))


def test_ppg_aux_phase_schedule():
    trainer = _trainer(rollout_len=4, n_minibatches=1, aux_phase_every=2, aux_epochs=2)
    envs = _envs(2)
    traj, obs, firsts = trainer.collect(envs, reward_fn=lambda a, o, r, d: 1.0)
    m1 = trainer.update(traj)
    assert "aux_v_loss" not in m1 and len(trainer._aux_buffer) == 1
    traj, obs, firsts = trainer.collect(envs, obs, firsts, reward_fn=lambda a, o, r, d: 1.0)
    m2 = trainer.update(traj)
    assert np.isfinite(m2["aux_v_loss"]) and np.isfinite(m2["aux_clone_kl"]) and trainer._aux_buffer == []


def test_anchor_is_a_frozen_copy():
    trainer = _trainer(rollout_len=4, n_minibatches=1, learning_rate=1e-2)
    trainer.init()
    anchor0 = {k: v.clone() for k, v in trainer.anchor.state_dict().items()}
    traj, _, _ = trainer.collect(_envs(2), reward_fn=lambda a, o, r, d: 1.0)
    metrics = trainer.update(traj)
    assert metrics["anchor_kl"] > 0 and not any(p.requires_grad for p in trainer.anchor.parameters())
    for name, p in trainer.anchor.named_parameters():
        assert torch.equal(p, anchor0[name]), name
        assert p.data_ptr() != trainer.policy.get_parameter(name).data_ptr(), name


def test_evaluate_leaves_training_untouched():
    """Evaluation draws from its own generator and state: a run with it
    collects the same actions and lands on the same parameters."""
    def run(with_eval):
        trainer = _trainer(rollout_len=4)
        envs = _envs(2)
        if with_eval:
            trainer.evaluate(_envs(2, done_prob=0.3), n_episodes=2, max_episode_steps=8)
        traj, obs, firsts = trainer.collect(envs, reward_fn=lambda a, o, r, d: 1.0)
        trainer.update(traj)
        if with_eval:
            states = [g.get_state() for g in (trainer.sample_generator, trainer.perm_generator)]
            trainer.evaluate(_envs(2, done_prob=0.3), n_episodes=2, max_episode_steps=8)
            assert all(torch.equal(s, g.get_state())
                       for s, g in zip(states, (trainer.sample_generator, trainer.perm_generator)))
        traj2, _, _ = trainer.collect(envs, obs, firsts, reward_fn=lambda a, o, r, d: 1.0)
        return traj, traj2, trainer

    a, a2, ta = run(False)
    b, b2, tb = run(True)
    np.testing.assert_array_equal(a["buttons"], b["buttons"])
    np.testing.assert_array_equal(a2["buttons"], b2["buttons"])
    for (name, p), q in zip(ta.policy.named_parameters(), tb.policy.parameters()):
        assert torch.equal(p, q), name


def test_evaluate_report_and_shaped_reward():
    trainer = _trainer(rollout_len=4)
    report = trainer.evaluate(_envs(2, done_prob=0.2), n_episodes=4, max_episode_steps=10,
                              reward_fn=lambda a, o, r, d: 1.0)
    assert report["episodes"] == 4 and report["mean_vpred"] is not None
    assert all(ep["return"] == ep["length"] for ep in report["per_episode"])
    assert 0.0 <= report["action_stats"]["null_action_rate"] <= 1.0
    det = trainer.evaluate(_envs(2), n_episodes=2, max_episode_steps=5, stochastic=False)
    assert det["episodes"] == 2 and det["truncated_episodes"] == 2


def test_train_logs_eval_events_and_writes_weights(tmp_path):
    trainer = _trainer(rollout_len=4)
    out = io.StringIO()
    path = str(tmp_path / "ppo.weights")
    report = trainer.train(_envs(2), 2, out_weights=path, reward_fn=lambda a, o, r, d: 1.0,
                           metrics=MetricsLogger(stream=out), eval_envs=_envs(2, done_prob=0.3), eval_every=2,
                           eval_episodes=2, eval_max_steps=6)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [e["update"] for e in lines if e.get("event") == "eval"] == [0, 2]
    assert [e["update"] for e in lines if "loss" in e] == [0, 1]
    assert trainer.update_count == 2 and np.isfinite(report["loss"]) and "eval_mean_return" in report
    saved = torch.load(path)
    assert all(torch.equal(saved[k], v) for k, v in trainer.policy.state_dict().items())


def test_ppo_learns_synthetic_reward():
    """+1 whenever the decoded env action presses attack, γ=0 (a bandit): the
    policy moves probability mass onto attack combos."""
    from vpt_tpu_torch.actions.buttons import Buttons

    trainer = _trainer(rollout_len=16, n_minibatches=1, n_epochs=3, learning_rate=6e-3, kl_coef=0.0,
                       gamma=0.0, lam=0.0)
    trainer.init()
    probe = torch.from_numpy(np.random.default_rng(0).integers(0, 255, (2, 4, 32, 32, 3), dtype=np.uint8))
    n = next(s.num_actions for s in trainer.head_specs if s.key == "buttons")
    factored = trainer.action_mapper.to_factored({"buttons": np.arange(n)[:, None], "camera": np.full((n, 1), 60)})
    attack = torch.from_numpy(factored["buttons"][:, Buttons.ALL.index("attack")].astype(bool))

    def attack_prob():
        state = rl.policy_initial_state(trainer.cfg, 2)
        logits = trainer._logits(trainer.policy, probe, torch.ones(2, 4, dtype=torch.bool), state)
        return float(torch.exp(logits["buttons"].double())[..., attack].sum(-1).mean())

    before = attack_prob()
    envs = _envs(4)
    obs = firsts = None
    for _ in range(10):
        traj, obs, firsts = trainer.collect(envs, obs, firsts, reward_fn=lambda a, o, r, d: float(a["attack"]))
        trainer.update(traj)
    assert attack_prob() > before + 0.02, (before, attack_prob())


def test_cli_end_to_end_on_mock_envs(tmp_path):
    model, weights, out = (str(tmp_path / n) for n in ("tiny.model", "tiny.weights", "out.weights"))
    save_model_parameters(model, TINY_KWARGS, PI_KWARGS)
    trainer = _trainer()
    trainer.init()
    save_weights(weights, trainer.policy)
    metrics = str(tmp_path / "metrics.jsonl")
    res = subprocess.run(
        [sys.executable, "-m", "vpt_tpu_torch.rl_fine_tune", "--in-model", model, "--in-weights", weights,
         "--out-weights", out, "--mock-env", "--streams", "4", "--updates", "2", "--rollout-len", "4",
         "--compute-dtype", "float32", "--aux-phase-every", "2", "--aux-epochs", "1", "--metrics-path", metrics,
         "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "(2 collection group(s))" in res.stdout and "Done:" in res.stdout
    lines = [json.loads(line) for line in open(metrics)]
    assert [e["update"] for e in lines] == [0, 1] and "aux_v_loss" in lines[1]
    tuned = torch.load(out)
    assert set(tuned) == set(trainer.policy.state_dict())
    assert any(not torch.equal(tuned[k], v) for k, v in trainer.policy.state_dict().items())
    from vpt_tpu_torch.rl_fine_tune import auto_collect_groups

    assert [auto_collect_groups(n) for n in (1, 2, 4, 6, 8, 64)] == [1, 1, 2, 2, 4, 4]
