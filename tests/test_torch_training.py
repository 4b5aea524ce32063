"""The port's BC trainer (vpt_tpu_torch/training/bc.py) against vpt_tpu's at
a tiny config, from the same weights (crossed with ``from_jax_variables``),
on the CPU.

Tolerances (float32 sums in another order in the two frameworks):
  * loss of each of three successive steps rtol 1e-5, grad norm rtol 1e-4;
  * every parameter's gradient of step 1: max-abs error <= max(2e-6,
    1e-4 * its max-abs) (as tests/test_grad_parity.py);
  * parameters after three steps: every entry within 3·lr (Adam divides each
    entry's moment by its square root, so an entry whose gradient is pure
    rounding noise may move by up to lr a step either way), and all but 0.1%
    of each tensor's entries within atol 2e-6 + rtol 1e-5;
  * the value head and the optimizer on a toy parameter with the clip active:
    rtol 1e-5, atol 1e-7; inject_episode_firsts and a .weights round trip: exact.
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.checkpoint import load_model_parameters as jax_load_model_parameters
from vpt_tpu.checkpoint import load_weights as jax_load_weights
from vpt_tpu.checkpoint import state_dict_to_variables
from vpt_tpu.checkpoint.torch_import import variables_to_state_dict
from vpt_tpu.models.heads import dict_logprob as jax_dict_logprob
from vpt_tpu.parallel.mesh import make_mesh
from vpt_tpu.training import bc as jax_bc
from vpt_tpu_torch.checkpoint import from_jax_variables, save_model_parameters, save_weights
from vpt_tpu_torch.training import bc

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
B, T = 3, 4
LR = 1e-3


def _batches(seed=0):
    """Three chunks: all streams start, then a mid-chunk reset, then a padded tail."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(3):
        firsts = np.zeros((B, T), bool)
        mask = np.ones((B, T), bool)
        if s == 0:
            firsts[:, 0] = True
        if s == 1:
            firsts[1, 2] = True
        if s == 2:
            mask[0, 2:] = False
            mask[2, 1:] = False
        out.append({
            "frames": rng.integers(0, 256, (B, T, 32, 32, 3), dtype=np.uint8),
            "buttons": rng.integers(0, 8641, (B, T)).astype(np.int32),
            "camera": rng.integers(0, 121, (B, T)).astype(np.int32),
            "firsts": firsts,
            "mask": mask,
        })
    return out


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


@pytest.fixture(scope="module")
def trainers():
    hp_kw = dict(batch_size=B, chunk_len=T, learning_rate=LR)
    jt = jax_bc.BCTrainer(TINY_KWARGS, PI_KWARGS, hp=jax_bc.BCHyperparams(**hp_kw),
                          mesh=make_mesh(n_dp=1, devices=jax.devices()[:1]), seed=0)
    jt.init()
    variables0 = _host(jt.variables)
    pt = bc.BCTrainer(TINY_KWARGS, PI_KWARGS, hp=bc.BCHyperparams(**hp_kw), device="cpu", seed=0)
    pt.init()
    pt.policy.load_state_dict(from_jax_variables(variables0), strict=True)
    return jt, pt, variables0


def _port_grads_step1(pt, batch):
    pt.policy.zero_grad(set_to_none=True)
    nll, _ = pt.masked_nll(pt.to_device(batch), pt.initial_state(B))
    (nll / (B * T)).backward()
    grads = {name: p.grad.clone() for name, p in pt.policy.named_parameters() if p.grad is not None}
    pt.policy.zero_grad(set_to_none=True)
    return grads


def _jax_grads_step1(jt, variables, batch):
    """BC loss gradient of vpt_tpu's policy, built as tests/test_grad_parity.py builds it."""
    state0 = jt.initial_state(B)

    def loss_fn(params):
        out, _ = jt.policy.apply({"params": params, "stats": variables["stats"]},
                                 jnp.asarray(batch["frames"]), jnp.asarray(batch["firsts"]), state0)
        actions = {"buttons": jnp.asarray(batch["buttons"])[..., None],
                   "camera": jnp.asarray(batch["camera"])[..., None]}
        logp = jax_dict_logprob(out["pi_logits"], actions, jt.head_specs)
        return -(logp * jnp.asarray(batch["mask"], jnp.float32)).sum() / (B * T)

    grads = jax.grad(loss_fn)(jax.tree.map(jnp.asarray, variables["params"]))
    return variables_to_state_dict({"params": _host(grads), "stats": variables["stats"]})


def test_gradients_and_three_steps_match_vpt_tpu(trainers):
    jt, pt, variables0 = trainers
    batches = _batches()

    # every parameter's gradient of the first step
    ours = _port_grads_step1(pt, batches[0])
    theirs = _jax_grads_step1(jt, variables0, batches[0])
    checked = 0
    for name, g in ours.items():
        assert not name.startswith("value_head"), name
        ref = np.asarray(theirs[name], np.float64).reshape(g.shape)
        err = np.abs(g.numpy().astype(np.float64) - ref).max()
        assert err <= max(2e-6, 1e-4 * np.abs(ref).max()), (name, err, np.abs(ref).max())
        checked += 1
    assert checked == len(list(pt.trainable_parameters()))

    # three optimizer steps with the state carried, a reset and a padded tail
    value_head0 = {k: v.clone() for k, v in pt.policy.value_head.state_dict().items()}
    js, ps = jt.initial_state(B), pt.initial_state(B)
    for i, batch in enumerate(batches):
        js, jloss, jnorm = jt.train_step(batch, js)
        ps, ploss, pnorm = pt.train_step(batch, ps)
        assert all(v.grad_fn is None for s in ps for v in s.values() if isinstance(v, torch.Tensor))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-5, err_msg=f"loss of step {i + 1}")
        np.testing.assert_allclose(float(pnorm), float(jnorm), rtol=1e-4, err_msg=f"grad norm of step {i + 1}")

    after = variables_to_state_dict(_host(jt.variables))
    for name, p in pt.policy.state_dict().items():
        ref = np.asarray(after[name]).reshape(p.shape)
        np.testing.assert_allclose(p.numpy(), ref, rtol=0, atol=3 * LR, err_msg=name)
        off = np.abs(p.numpy() - ref) > 2e-6 + 1e-5 * np.abs(ref)
        assert off.mean() <= 1e-3, (name, int(off.sum()), off.size)
    # the value head is untouched on both sides
    for name, v in pt.policy.value_head.state_dict().items():
        assert torch.equal(v, value_head0[name]), name
    jv0 = jax.tree.leaves(variables0["params"]["value_head"])
    jv1 = jax.tree.leaves(_host(jt.variables["params"]["value_head"]))
    assert all(np.array_equal(a, b) for a, b in zip(jv0, jv1))


def test_optimizer_matches_vpt_tpu_with_clip_active():
    import optax

    hp = bc.BCHyperparams(learning_rate=0.01, weight_decay=0.1, max_grad_norm=1.0)
    w0 = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
    grads = [np.array([0.5, 0.5, -1.0, 2.0], np.float32), np.array([2.0, -2.0, 2.0, 0.1], np.float32),
             np.array([0.01, 0.02, -0.03, 0.0], np.float32)]
    assert all(np.linalg.norm(g) > hp.max_grad_norm for g in grads[:2])  # clip active

    w = torch.nn.Parameter(torch.tensor(w0))
    opt = bc.make_optimizer([w], hp)
    norms = []
    for g in grads:
        opt.zero_grad()
        w.grad = torch.tensor(g)
        norms.append(float(opt.step()))

    chain = jax_bc.make_optimizer(jax_bc.BCHyperparams(learning_rate=0.01, weight_decay=0.1, max_grad_norm=1.0))
    params = jnp.asarray(w0)
    state = chain.init(params)
    for g in grads:
        updates, state = chain.update(jnp.asarray(g), state, params)
        params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(params), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(norms, [np.linalg.norm(g) for g in grads], rtol=1e-6)


def test_inject_episode_firsts_matches_vpt_tpu():
    rng = np.random.default_rng(3)
    last_ours = last_theirs = np.full(4, -1, np.int64)
    for _ in range(5):
        ids = rng.integers(0, 3, 4).astype(np.int64)
        firsts = rng.random((4, 6)) < 0.2
        ours = {"episode_ids": ids, "firsts": firsts.copy()}
        theirs = {"episode_ids": ids, "firsts": firsts.copy()}
        last_ours = bc.inject_episode_firsts(ours, last_ours, 6)
        last_theirs = jax_bc.inject_episode_firsts(theirs, last_theirs, 6)
        np.testing.assert_array_equal(ours["firsts"], theirs["firsts"])
        np.testing.assert_array_equal(last_ours, last_theirs)


def test_weights_written_by_the_port_load_into_vpt_tpu(trainers, tmp_path):
    _, _, variables0 = trainers
    pt = bc.BCTrainer(TINY_KWARGS, PI_KWARGS, device="cpu", seed=1)
    pt.init()
    pt.policy.load_state_dict(from_jax_variables(variables0), strict=True)
    path = str(tmp_path / "port.weights")
    save_weights(path, pt.policy)
    loaded, report = state_dict_to_variables(jax_load_weights(path), variables=variables0)
    assert not report["unexpected"] and not report["missing"] and not report["shape_mismatch"], report
    flat0 = jax.tree_util.tree_leaves_with_path(variables0)
    flat1 = dict(jax.tree_util.tree_leaves_with_path(_host(loaded)))
    assert len(flat0) == len(flat1)
    for path_, leaf in flat0:
        np.testing.assert_array_equal(np.asarray(flat1[path_]).reshape(np.shape(leaf)), leaf)

    # the port's trainer reads it back, and a .model it writes reads in vpt_tpu
    model = str(tmp_path / "port.model")
    save_model_parameters(model, TINY_KWARGS, PI_KWARGS)
    assert jax_load_model_parameters(model) == (TINY_KWARGS, PI_KWARGS)
    back = bc.BCTrainer.from_files(model, path, device="cpu", seed=2)
    for name, v in back.policy.state_dict().items():
        assert torch.equal(v, pt.policy.state_dict()[name]), name


def test_train_step_leaves_value_head_without_gradient():
    pt = bc.BCTrainer(TINY_KWARGS, PI_KWARGS, device="cpu", seed=3)
    state, loss, norm = pt.train_step(_batches(4)[0], pt.initial_state(B))
    assert torch.isfinite(loss) and torch.isfinite(norm) and pt.step_count == 1
    for name, p in pt.policy.named_parameters():
        assert (p.grad is None) == name.startswith("value_head."), name
    assert len(state) == 2 and all(s["k"].grad_fn is None for s in state)
