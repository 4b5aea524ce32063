"""Rematerialization (``remat``) and the chunked CNN (``cnn_scan_chunks``)
of the port change memory and recompute, not results: held against the
port without them and against vpt_tpu with them, at tests/test_remat.py's
tiny config, on the CPU.

Tolerances.  Port against port (the same arithmetic, recomputed): logits
rtol 1e-6 / atol 1e-7 and every grad within 1e-5, tests/test_remat.py's
numbers.  Port against vpt_tpu with the same options (float32 sums in
another order in two frameworks): logits within 2e-3 as
tests/test_torch_policy.py, grads within 1e-5 of vpt_tpu's.  A trainer's
step with remat against the same step without: loss and grad norm rtol
1e-6, parameters after the step within 1e-6."""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.config import PolicyConfig as JaxConfig
from vpt_tpu.models.heads import HeadSpec as JaxHeadSpec
from vpt_tpu.models.heads import dict_logprob as jax_dict_logprob
from vpt_tpu.models.policy import MinecraftAgentPolicy as JaxPolicy
from vpt_tpu.models.policy import policy_initial_state as jax_initial_state
from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
from vpt_tpu_torch.checkpoint import from_jax_variables
from vpt_tpu_torch.config import PolicyConfig
from vpt_tpu_torch.models.heads import HeadSpec, dict_logprob
from vpt_tpu_torch.models.policy import MinecraftAgentPolicy, policy_initial_state
from vpt_tpu_torch.training import bc, idm, rl

TINY_KWARGS = dict(
    hidsize=64, impala_width=1, impala_chans=[4, 8], obs_processing_width=32, img_shape=[32, 32, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1}, impala_kwargs={"post_pool_groups": 1},
    recurrence_type="transformer", n_recurrence_layers=2, timesteps=4, attention_heads=4,
    attention_memory_size=8, use_pre_lstm_ln=False,
)
SPECS = (("buttons", (1,), 23), ("camera", (1,), 9))
IDM_TINY = dict(TINY_KWARGS, img_shape=[32, 32, 4], attention_mask_style="none", attention_memory_size=8,
                conv3d_params={"inchan": 3, "outchan": 4, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]})
OPTIONS = [dict(remat=True), dict(cnn_scan_chunks=2), dict(remat=True, cnn_scan_chunks=2)]


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


@pytest.fixture(scope="module")
def jax_setup():
    img = np.random.default_rng(0).integers(0, 255, (2, 4, 32, 32, 3), dtype=np.uint8)
    first = np.zeros((2, 4), bool)
    first[1, 2] = True
    cfg = JaxConfig.from_kwargs(TINY_KWARGS)
    specs = tuple(JaxHeadSpec(*s) for s in SPECS)
    base = JaxPolicy(cfg=cfg, head_specs=specs, temperature=2.0)
    variables = jax.jit(base.init)(jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(first),
                                   jax_initial_state(cfg, 2))
    return img, first, cfg, specs, variables


def _actions(n=2, t=4):
    return {"buttons": np.arange(n * t).reshape(n, t, 1) % 23, "camera": np.arange(n * t).reshape(n, t, 1) % 9}


def _port(variables, **options):
    cfg = PolicyConfig.from_kwargs(dict(TINY_KWARGS, **options))
    policy = MinecraftAgentPolicy(cfg, tuple(HeadSpec(*s) for s in SPECS), temperature=2.0)
    policy.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables)), strict=True)
    return policy


def _port_logits_and_grads(policy, img, first):
    policy.zero_grad(set_to_none=True)
    state = policy_initial_state(policy.cfg, 2)
    out, _ = policy(torch.from_numpy(img), torch.from_numpy(first), state)
    actions = {k: torch.from_numpy(v) for k, v in _actions().items()}
    (-dict_logprob(out["pi_logits"], actions, policy.head_specs).mean()).backward()
    grads = {n: p.grad.clone() for n, p in policy.named_parameters() if p.grad is not None}
    return out["pi_logits"]["buttons"].detach(), grads


def _jax_logits_and_grads(jax_setup, **options):
    img, first, cfg, specs, variables = jax_setup
    model = JaxPolicy(cfg=cfg.replace(**options), head_specs=specs, temperature=2.0)
    state = jax_initial_state(cfg, 2)
    actions = {k: jnp.asarray(v, jnp.int32) for k, v in _actions().items()}

    def loss(params):
        out, _ = model.apply({"params": params, "stats": variables["stats"]}, img, first, state)
        return -jax_dict_logprob(out["pi_logits"], actions, specs).mean(), out["pi_logits"]["buttons"]

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return np.asarray(logits), from_jax_variables({"params": jax.tree.map(np.asarray, grads)})


@pytest.mark.parametrize("options", OPTIONS, ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_policy_matches_itself_without_remat_and_vpt_tpu_with_it(jax_setup, options):
    img, first, _, _, variables = jax_setup
    base_logits, base_grads = _port_logits_and_grads(_port(variables), img, first)
    logits, grads = _port_logits_and_grads(_port(variables, **options), img, first)
    torch.testing.assert_close(logits, base_logits, rtol=1e-6, atol=1e-7)
    assert grads.keys() == base_grads.keys()
    for name, g in grads.items():
        assert (g - base_grads[name]).abs().max().item() < 1e-5, name

    jax_logits, jax_grads = _jax_logits_and_grads(jax_setup, **options)
    np.testing.assert_allclose(logits.numpy(), jax_logits, rtol=2e-3, atol=2e-3)
    for name, g in grads.items():
        assert (g - jax_grads[name]).abs().max().item() < 1e-5, name


def test_chunked_cnn_runs_only_where_chunks_divide_the_frames(jax_setup):
    """vpt_tpu's rule: chunks > 1, dividing B·T, and fewer than B·T."""
    img, first, _, _, variables = jax_setup
    for chunks, runs in ((2, 2), (3, 1), (8, 1), (16, 1), (1, 1)):
        policy = _port(variables, cnn_scan_chunks=chunks)
        calls = []
        forward = policy.net.img_process.cnn.forward_nchw
        policy.net.img_process.cnn.forward_nchw = lambda x, remat=None: calls.append(len(x)) or forward(x, remat)
        with torch.no_grad():
            policy(torch.from_numpy(img), torch.from_numpy(first), policy_initial_state(policy.cfg, 2))
        assert len(calls) == runs and sum(calls) == 8, (chunks, calls)


def _same_step(make, step):
    """One step of two trainers made alike but for remat: the same loss,
    grad norm and weights after it."""
    plain, rematted = make(remat=False), make(remat=True)
    got = [step(t) for t in (plain, rematted)]
    for a, b in zip(*got):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
    for (name, p), q in zip(plain.policy.named_parameters(), rematted.policy.parameters()):
        assert (p - q).abs().max().item() <= 1e-6, name


def test_bc_step_with_remat_matches_step_without():
    rng = np.random.default_rng(3)
    batch = {"frames": rng.integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8),
             "buttons": rng.integers(0, 8641, (2, 4)), "camera": rng.integers(0, 121, (2, 4)),
             "firsts": np.array([[True, False, False, False], [False, False, True, False]]),
             "mask": np.array([[True] * 4, [True, True, True, False]])}

    def make(remat):
        return bc.BCTrainer(TINY_KWARGS, {"temperature": 2.0}, device="cpu", seed=1, remat=remat, cnn_scan_chunks=2)

    _same_step(make, lambda t: t.train_step(batch, t.initial_state(2))[1:])


def test_idm_step_with_remat_matches_step_without():
    rng = np.random.default_rng(4)
    batch = {"frames": rng.integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8),
             "buttons": rng.integers(0, 8641, (2, 4)), "camera": rng.integers(0, 121, (2, 4)),
             "firsts": np.zeros((2, 4), bool), "mask": np.ones((2, 4), bool)}

    def make(remat):
        return idm.IDMTrainer(IDM_TINY, {}, hp=idm.IDMHyperparams(window=4), device="cpu", seed=2, remat=remat)

    _same_step(make, lambda t: t.train_step(batch))


def test_ppo_update_with_remat_matches_update_without():
    """A collected window, then one update that ends in one PPG aux step,
    with and without remat, from the same weights."""
    hp = dict(rollout_len=4, n_minibatches=1, n_epochs=1, aux_phase_every=1, aux_epochs=1)

    def make(remat):
        return rl.PPOTrainer(dict(TINY_KWARGS, cnn_scan_chunks=2), {"temperature": 2.0},
                             hp=rl.PPOHyperparams(**hp), device="cpu", seed=0, remat=remat)

    plain = make(False)
    traj, _, _ = plain.collect([MockMinecraftEnv(seed=i, done_prob=0.2) for i in range(2)])

    def update(t):
        metrics = t.update(traj)
        return [metrics[k] for k in sorted(metrics)]

    _same_step(lambda remat: plain if not remat else make(True), update)
