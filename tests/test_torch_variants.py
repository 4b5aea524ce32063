"""The port's model variants against vpt_tpu's at tests/test_model_forward.py's
tiny config, on the CPU, from the same weights (crossed with
``from_jax_variables``): the LSTM recurrences (``multi_layer_lstm``,
``multi_layer_bilstm``, ``multi_masked_lstm``), ``recurrence_type="none"``,
batch norm, the diagonal-gaussian head with the ``dict_*`` functions, and
PPO with ``multi_masked_lstm``; and, on the port alone, the reset rules,
remat and the chunked CNN, and a BC run stopped and resumed with an LSTM's
carries or ``"none"``'s empty state.

Tolerances:
  * forward logits, vpred and the state out: 2e-3 (tests/test_torch_policy.py);
  * the reset cases of tests/test_model_forward.py on the port: 1e-6 as there;
  * a BC step's loss rtol 1e-5, every gradient max-abs <= max(2e-6, 1e-4 ×
    its max-abs) (tests/test_torch_training.py);
  * the batch-norm statistics after a train step: bit for bit;
  * gaussian and dict functions against vpt_tpu's: rtol 1e-6, atol 1e-6;
    tests/test_completeness.py's cases at their own tolerances;
  * PPO: tests/test_torch_rl.py's (metrics rtol 1e-4, the KL estimates rtol
    2e-2; the snapshot re-forward rtol 1e-4, atol 1e-5);
  * stepped against chunked 1e-5; remat and the chunked CNN against neither:
    loss rtol 1e-6, grad norm 1e-4, the carries 1e-6; the resumed run as
    tests/test_torch_checkpoint_native.py's.
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.config import PolicyConfig as JaxConfig
from vpt_tpu.models import heads as jax_heads
from vpt_tpu.models.policy import MinecraftAgentPolicy as JaxPolicy
from vpt_tpu.models.policy import policy_initial_state as jax_initial_state
from vpt_tpu.parallel.mesh import make_mesh
from vpt_tpu.spaces import DictType as JaxDictType
from vpt_tpu.spaces import Discrete as JaxDiscrete
from vpt_tpu.spaces import Real as JaxReal
from vpt_tpu.spaces import TensorType as JaxTensorType
from vpt_tpu.training import rl as jax_rl
from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
from vpt_tpu_torch.checkpoint import from_jax_variables
from vpt_tpu_torch.config import PolicyConfig
from vpt_tpu_torch.models import heads
from vpt_tpu_torch.models.heads import HeadSpec, dict_logprob
from vpt_tpu_torch.models.layers import init_parameters
from vpt_tpu_torch.models.policy import MinecraftAgentPolicy, policy_initial_state
from vpt_tpu_torch.spaces import DictType, Discrete, Real, TensorType
from vpt_tpu_torch.training import bc, rl

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
BN_KWARGS = dict(TINY_KWARGS, init_norm_kwargs={"batch_norm": True})
LSTM_TYPES = ("multi_layer_lstm", "multi_layer_bilstm", "multi_masked_lstm")
SPECS = (heads.HeadSpec("buttons", (1,), 23), heads.HeadSpec("camera", (1,), 9))
JAX_SPECS = (jax_heads.HeadSpec("buttons", (1,), 23), jax_heads.HeadSpec("camera", (1,), 9))


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


def _img(b, t, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, t, 32, 32, 3), dtype=np.uint8)


def _pair(kwargs, batch_norm_stats=False):
    """(vpt_tpu policy, its host variables, the port's policy with them)."""
    jcfg = JaxConfig.from_kwargs(kwargs)
    ref = JaxPolicy(cfg=jcfg, head_specs=JAX_SPECS, temperature=2.0)
    variables = jax.jit(ref.init)(jax.random.PRNGKey(0), jnp.zeros((2, 1, 32, 32, 3), jnp.uint8),
                                  jnp.zeros((2, 1), bool), jax_initial_state(jcfg, 2))
    variables = jax.tree.map(np.asarray, dict(variables))
    if batch_norm_stats:
        rng = np.random.default_rng(1)
        variables["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, x: (rng.uniform(0.5, 2.0, x.shape) if path[-1].key == "var"
                             else rng.normal(size=x.shape) * 0.3).astype(np.float32),
            variables["batch_stats"])
    port = MinecraftAgentPolicy(PolicyConfig.from_kwargs(kwargs), SPECS, temperature=2.0)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return ref, variables, port


@pytest.fixture(scope="module", params=LSTM_TYPES + ("none",))
def variant(request):
    kwargs = dict(TINY_KWARGS, recurrence_type=request.param)
    return (request.param,) + _pair(kwargs)


def _episode(T=12, B=2, seed=0):
    img = _img(B, T, seed)
    first = np.zeros((B, T), bool)
    first[:, 0] = True
    first[0, T // 2] = True
    first[1, 3] = True  # inside a chunk: multi_layer_lstm ignores it, multi_masked_lstm honours it
    return img, first


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


@torch.no_grad()
def test_variant_chunked_forward_and_state_match_vpt_tpu(variant):
    """Three (2, 4) chunks with the state carried and resets at and inside
    chunk starts: logits, vpred and every block's {h, c} out (None for "none")."""
    name, ref, variables, port = variant
    img, first = _episode()
    apply = jax.jit(ref.apply)
    jstate = jax_initial_state(ref.cfg, 2)
    state = policy_initial_state(port.cfg, 2, ring=True)  # ring is a transformer's: ignored here
    if name == "none":
        assert state is None and jstate is None
    else:
        assert [sorted(s) for s in state] == [["c", "h"]] * 2
    for c in range(3):
        sl = slice(4 * c, 4 * c + 4)
        jout, jstate = apply(variables, jnp.asarray(img[:, sl]), jnp.asarray(first[:, sl]), jstate)
        out, state = port(_t(img[:, sl]), _t(first[:, sl]), state)
        for k in ("buttons", "camera"):
            _close(out["pi_logits"][k], jout["pi_logits"][k])
        _close(out["vpred"], jout["vpred"])
        if name == "none":
            assert state is None and jstate is None
            continue
        for blk, jblk in zip(state, jstate):
            for k in ("h", "c"):
                _close(blk[k], jblk[k])


@torch.no_grad()
def test_lstm_bfloat16_tracks_vpt_tpu_bfloat16():
    """compute_dtype="bfloat16" on both sides: bf16 rounds at other places
    in the two frameworks (vpt_tpu's reset mask promotes its carries to
    f32; the port keeps them bf16), so the bound is
    tests/test_torch_policy.py's loose one (5e-2).  (vpt_tpu's
    multi_masked_lstm does not run in bf16: its scan's carry changes type.)"""
    kwargs = dict(TINY_KWARGS, recurrence_type="multi_layer_lstm")
    ref, variables, port = _pair(kwargs)
    jcfg = ref.cfg.replace(compute_dtype="bfloat16")
    jref = JaxPolicy(cfg=jcfg, head_specs=JAX_SPECS, temperature=2.0)
    bf = MinecraftAgentPolicy(port.cfg.replace(compute_dtype="bfloat16"), SPECS, temperature=2.0)
    bf.load_state_dict(port.state_dict())
    img, first = _episode(T=4, seed=2)
    jout, jstate = jax.jit(jref.apply)(variables, jnp.asarray(img), jnp.asarray(first), jax_initial_state(jcfg, 2))
    out, state = bf(_t(img), _t(first), policy_initial_state(bf.cfg, 2))
    assert state[0]["h"].dtype == torch.bfloat16
    for k in ("buttons", "camera"):
        _close(out["pi_logits"][k], jout["pi_logits"][k], tol=5e-2)
    _close(state[1]["h"].float(), np.asarray(jstate[1]["h"], np.float32), tol=5e-2)


def test_idm_with_bilstm_matches_vpt_tpu():
    """The inverse dynamics model takes the LSTM recurrences too (vpt_tpu's
    InverseActionNet builds its blocks from the config): logits of a
    multi_layer_bilstm IDM at tests/test_torch_idm.py's tiny config."""
    from vpt_tpu.models.policy import InverseActionPolicy as JaxIDMPolicy
    from vpt_tpu_torch.models.policy import InverseActionPolicy, idm_input_shape

    from test_torch_idm import IDM_TINY_KWARGS

    kwargs = dict(IDM_TINY_KWARGS, recurrence_type="multi_layer_bilstm")
    jcfg = JaxConfig.from_kwargs(kwargs)
    specs = (heads.HeadSpec("buttons", (20,), 2), heads.HeadSpec("camera", (2,), 11))
    jspecs = (jax_heads.HeadSpec("buttons", (20,), 2), jax_heads.HeadSpec("camera", (2,), 11))
    ref = JaxIDMPolicy(cfg=jcfg, head_specs=jspecs)
    img = np.random.default_rng(4).integers(0, 256, (2, 8) + idm_input_shape(PolicyConfig.from_kwargs(kwargs)),
                                            dtype=np.uint8)
    first = np.zeros((2, 8), bool)
    variables = jax.tree.map(np.asarray, dict(jax.jit(ref.init)(
        jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(first), jax_initial_state(jcfg, 2))))
    port = InverseActionPolicy(PolicyConfig.from_kwargs(kwargs), specs)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    jout, _ = jax.jit(ref.apply)(variables, jnp.asarray(img), jnp.asarray(first), jax_initial_state(jcfg, 2))
    with torch.no_grad():
        out, state = port(_t(img), _t(first), policy_initial_state(port.cfg, 2))
    assert sorted(state[0]) == ["c", "h"]
    for k in ("buttons", "camera"):
        _close(out["pi_logits"][k], jout["pi_logits"][k])


def _port_lstm(recurrence_type):
    """The port's policy alone, its weights drawn from a seed."""
    cfg = PolicyConfig.from_kwargs(dict(TINY_KWARGS, recurrence_type=recurrence_type))
    return init_parameters(MinecraftAgentPolicy(cfg, SPECS, temperature=2.0), torch.Generator().manual_seed(0))


@torch.no_grad()
@pytest.mark.parametrize("case", ["reset_zeroes_state", "masked_equals_plain_at_chunk_start",
                                  "masked_mid_window_reset_is_ragged_exact", "bilstm_sees_the_future"])
def test_port_lstm_reset_semantics(case):
    """tests/test_model_forward.py's LSTM cases, on the port."""
    img = _t(_img(2, 4))
    zeros = torch.zeros((2, 4), dtype=torch.bool)
    start = zeros.clone()
    start[:, 0] = True
    if case == "reset_zeroes_state":
        port = _port_lstm("multi_layer_lstm")
        fresh = policy_initial_state(port.cfg, 2)
        _, carried = port(img, zeros, fresh)
        assert carried[0]["h"].shape == (2, 64)
        a, _ = port(img, start, carried)
        b, _ = port(img, start, fresh)
        np.testing.assert_allclose(a["pi_logits"]["buttons"].numpy(), b["pi_logits"]["buttons"].numpy(), atol=1e-6)
    elif case == "masked_equals_plain_at_chunk_start":
        plain = _port_lstm("multi_layer_lstm")
        masked = MinecraftAgentPolicy(plain.cfg.replace(recurrence_type="multi_masked_lstm"), SPECS, 2.0)
        masked.load_state_dict(plain.state_dict())
        _, mid = plain(img, zeros, policy_initial_state(plain.cfg, 2))
        out_p, st_p = plain(img, start, mid)
        out_m, st_m = masked(img, start, mid)
        np.testing.assert_allclose(out_p["pi_logits"]["buttons"].numpy(), out_m["pi_logits"]["buttons"].numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(st_p[0]["h"].numpy(), st_m[0]["h"].numpy(), atol=1e-6)
    elif case == "masked_mid_window_reset_is_ragged_exact":
        port = _port_lstm("multi_masked_lstm")
        state0 = policy_initial_state(port.cfg, 2)
        first = zeros.clone()
        first[0, 2] = True
        ragged, st_ragged = port(img, first, state0)
        a, mid = port(img[:, :2], first[:, :2], state0)
        b, fin = port(img[:, 2:], first[:, 2:], mid)
        got = torch.cat([a["pi_logits"]["buttons"], b["pi_logits"]["buttons"]], dim=1)
        np.testing.assert_allclose(ragged["pi_logits"]["buttons"].numpy(), got.numpy(), atol=1e-6)
        np.testing.assert_allclose(st_ragged[0]["c"].numpy(), fin[0]["c"].numpy(), atol=1e-6)
        unreset, _ = port(img, zeros, state0)
        d0 = (ragged["pi_logits"]["buttons"][0, 2:] - unreset["pi_logits"]["buttons"][0, 2:]).abs().max()
        d1 = (ragged["pi_logits"]["buttons"][1] - unreset["pi_logits"]["buttons"][1]).abs().max()
        assert d0 > 1e-7 and d1 <= 1e-7
    else:
        port = _port_lstm("multi_layer_bilstm")
        assert [blk.reverse_lstm for blk in port.net.recurrent_layer.blocks] == [False, True]
        state = policy_initial_state(port.cfg, 2)
        out, _ = port(img, zeros, state)
        img2 = img.clone()
        img2[:, -1] = 255 - img2[:, -1]
        out2, _ = port(img2, zeros, state)
        assert (out["pi_logits"]["buttons"][:, 0] - out2["pi_logits"]["buttons"][:, 0]).abs().max() > 1e-7


@torch.no_grad()
@pytest.mark.parametrize("recurrence_type", ["multi_masked_lstm", "multi_layer_lstm"])
def test_stepped_equals_chunked(recurrence_type):
    """One step at a time equals the chunk: for the masked LSTM with resets
    anywhere, for the plain one with resets at chunk starts only (a reset
    inside its chunk is ignored there but honoured by a step)."""
    port = _port_lstm(recurrence_type)
    img, first = _episode(T=8)
    if recurrence_type == "multi_layer_lstm":
        first[:] = False
        first[:, 0] = first[0, 4] = True
    chunked, cstate = [], policy_initial_state(port.cfg, 2)
    for c in range(2):
        out, cstate = port(_t(img[:, 4 * c:4 * c + 4]), _t(first[:, 4 * c:4 * c + 4]), cstate)
        chunked.append(out["pi_logits"]["buttons"])
    state = policy_initial_state(port.cfg, 2)
    for i in range(8):
        out, state = port(_t(img[:, i:i + 1]), _t(first[:, i:i + 1]), state)
        np.testing.assert_allclose(out["pi_logits"]["buttons"][:, 0].numpy(),
                                   chunked[i // 4][:, i % 4].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(state[1]["h"].numpy(), cstate[1]["h"].numpy(), atol=1e-5, rtol=1e-5)


@torch.no_grad()
def test_batch_norm_forward_matches_vpt_tpu():
    ref, variables, port = _pair(BN_KWARGS, batch_norm_stats=True)
    names = [n for n, _ in port.named_buffers() if n.endswith("running_var")]
    assert names and "net.img_process.cnn.stacks.1.firstconv.norm.running_var" in names
    assert "net.img_process.cnn.stacks.0.firstconv.norm.running_var" not in names  # first_conv_norm False
    img, first = _episode(T=4)
    jout, _ = jax.jit(ref.apply)(variables, jnp.asarray(img), jnp.asarray(first), jax_initial_state(ref.cfg, 2))
    port.train()  # running statistics in train mode too
    out, _ = port(_t(img), _t(first), policy_initial_state(port.cfg, 2))
    for k in ("buttons", "camera"):
        _close(out["pi_logits"][k], jout["pi_logits"][k])


def _batch(B, T, seed=0):
    rng = np.random.default_rng(seed)
    firsts = np.zeros((B, T), bool)
    firsts[:, 0] = True
    firsts[1, 2] = True
    mask = np.ones((B, T), bool)
    mask[0, 3:] = False
    return {"frames": rng.integers(0, 256, (B, T, 32, 32, 3), dtype=np.uint8),
            "buttons": rng.integers(0, 8641, (B, T)).astype(np.int32),
            "camera": rng.integers(0, 121, (B, T)).astype(np.int32), "firsts": firsts, "mask": mask}


def _jax_bc_grads(ref, variables, batch, state):
    """vpt_tpu's BC loss and its gradient, as tests/test_torch_training.py
    builds them, with the batch statistics passed through."""
    from vpt_tpu.models.heads import dict_logprob as jax_dict_logprob

    B, T = batch["mask"].shape

    def loss_fn(params):
        out, _ = ref.apply({**variables, "params": params}, jnp.asarray(batch["frames"]),
                           jnp.asarray(batch["firsts"]), state)
        actions = {"buttons": jnp.asarray(batch["buttons"])[..., None],
                   "camera": jnp.asarray(batch["camera"])[..., None]}
        logp = jax_dict_logprob(out["pi_logits"], actions, ref.head_specs)
        return -(logp * jnp.asarray(batch["mask"], jnp.float32)).sum() / (B * T)

    return jax.value_and_grad(loss_fn)(variables["params"])


@pytest.mark.parametrize("kwargs", [dict(TINY_KWARGS, recurrence_type="multi_masked_lstm"),
                                    dict(TINY_KWARGS, recurrence_type="multi_layer_bilstm"),
                                    dict(TINY_KWARGS, recurrence_type="none"), BN_KWARGS],
                         ids=["multi_masked_lstm", "multi_layer_bilstm", "none", "batch_norm"])
def test_bc_step_loss_and_grads_match_vpt_tpu(kwargs):
    """The BC trainer's loss and every gradient; a batch-norm policy's
    running statistics stay bit for bit through a train step."""
    B, T = 3, 4
    pi = {"temperature": 2.0}
    trainer = bc.BCTrainer(kwargs, pi, hp=bc.BCHyperparams(batch_size=B, chunk_len=T), device="cpu")
    trainer.init()
    jcfg = JaxConfig.from_kwargs(kwargs)
    jspecs = jax_heads.head_specs_from_space(JaxDictType(**_jax_mapping().get_action_space_update()))
    ref = JaxPolicy(cfg=jcfg, head_specs=jspecs, temperature=2.0)
    variables = jax.tree.map(np.asarray, dict(jax.jit(ref.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 3), jnp.uint8), jnp.zeros((1, 1), bool),
        jax_initial_state(jcfg, 1))))
    if "batch_stats" in variables:
        rng = np.random.default_rng(1)
        variables["batch_stats"] = jax.tree.map(lambda x: (rng.uniform(0.5, 2.0, x.shape)).astype(np.float32),
                                                variables["batch_stats"])
    trainer.policy.load_state_dict(from_jax_variables(variables), strict=True)
    batch = _batch(B, T)
    jloss, jgrads = _jax_bc_grads(ref, variables, batch, jax_initial_state(jcfg, B))
    jgrads = from_jax_variables({"params": jax.tree.map(np.asarray, jgrads)})  # the LSTM's in torch's layout
    nll, _ = trainer.masked_nll(trainer.to_device(batch), trainer.initial_state(B))
    loss = nll / (B * T)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for name, p in trainer.policy.named_parameters():
        if name.startswith("value_head."):
            continue
        want = np.asarray(jgrads[name]).reshape(p.shape)
        err = np.abs(p.grad.numpy() - want).max()
        assert err <= max(2e-6, 1e-4 * np.abs(want).max()), (name, err)
    trainer.policy.zero_grad(set_to_none=True)

    before = {k: v.clone() for k, v in trainer.policy.state_dict().items()}
    state, _, _ = trainer.train_step(batch, trainer.initial_state(B))
    after = trainer.policy.state_dict()
    if kwargs["recurrence_type"] == "none":
        assert state is None
    stats = [k for k in after if k.endswith(("running_mean", "running_var")) and ".norm." in k]
    assert bool(stats) == kwargs["init_norm_kwargs"].get("batch_norm", False)
    for k in stats:
        assert torch.equal(after[k], before[k]), k
        assert not torch.equal(after[k.rsplit(".", 1)[0] + ".weight"], before[k.rsplit(".", 1)[0] + ".weight"])


def _jax_mapping():
    from vpt_tpu.actions.mapping import CameraHierarchicalMapping

    return CameraHierarchicalMapping(n_camera_bins=11)


def test_lstm_bc_remat_and_chunked_cnn_equal_plain():
    """remat and cnn_scan_chunks leave an LSTM policy's step as it was."""
    kwargs = dict(TINY_KWARGS, recurrence_type="multi_masked_lstm")
    batch = _batch(2, 4, seed=3)
    losses = []
    for remat, chunks in ((False, 0), (True, 4)):
        trainer = bc.BCTrainer(kwargs, {}, hp=bc.BCHyperparams(batch_size=2, chunk_len=4), remat=remat,
                               cnn_scan_chunks=chunks, device="cpu", seed=0)
        state, loss, norm = trainer.train_step(batch, trainer.initial_state(2))
        losses.append((float(loss), float(norm), state[1]["h"]))
    np.testing.assert_allclose(losses[1][0], losses[0][0], rtol=1e-6)
    np.testing.assert_allclose(losses[1][1], losses[0][1], rtol=1e-4)
    np.testing.assert_allclose(losses[1][2].numpy(), losses[0][2].numpy(), atol=1e-6)


@pytest.mark.parametrize("recurrence_type", ["multi_masked_lstm", "none"])
def test_bc_run_of_a_variant_stopped_and_resumed_equals_uninterrupted(recurrence_type, tmp_path):
    """PR 7's resume with the streams' state as a variant holds it: {h, c}
    carries, or None (tests/test_torch_checkpoint_native.py's BC case; skips
    without libav)."""
    from vpt_tpu_torch.checkpoint import native
    from vpt_tpu_torch.data import video

    from test_torch_checkpoint_native import _check_resumed, _stopped_and_resumed
    from test_torch_data import _dataset

    try:
        video.build()
    except RuntimeError as e:
        pytest.skip(f"native video library of the port cannot be built: {e}")
    data = tmp_path / "data"
    data.mkdir()
    _dataset(data)
    kwargs = dict(TINY_KWARGS, recurrence_type=recurrence_type)

    def make(**hp):
        return bc.BCTrainer(kwargs, {"temperature": 2.0}, device="cpu", seed=3, hp=bc.BCHyperparams(
            batch_size=2, chunk_len=4, epochs=2, learning_rate=1e-3, loss_report_rate=1, **hp))

    _check_resumed(*_stopped_and_resumed(make, tmp_path, str(data)))
    state = native.restore_checkpoint(str(tmp_path / "ckpt"), step=1)[0]["extra"]["recurrent_state"]
    if recurrence_type == "none":
        assert state is None
    else:
        assert [sorted(blk) for blk in state] == [["c", "h"]] * 2 and state[0]["h"].abs().max() > 0


# ------------------------------------------------------------------ gaussian

GAUSS = HeadSpec("cont", (3,), kind="gaussian")


def test_gaussian_spec_from_space():
    space = DictType(cont=TensorType(shape=(3,), eltype=Real()), disc=TensorType(shape=(1,), eltype=Discrete(5)))
    jspace = JaxDictType(cont=JaxTensorType(shape=(3,), eltype=JaxReal()),
                         disc=JaxTensorType(shape=(1,), eltype=JaxDiscrete(5)))
    specs = heads.head_specs_from_space(space)
    assert {s.key: s.kind for s in specs} == {"cont": "gaussian", "disc": "categorical"}
    assert [(s.key, s.value_shape, s.num_actions, s.kind) for s in specs] == [
        (s.key, s.value_shape, s.num_actions, s.kind) for s in jax_heads.head_specs_from_space(jspace)]


def test_gaussian_functions_match_scipy_and_vpt_tpu():
    from scipy.stats import norm

    pd = np.stack([[0.5, -1.0, 2.0], [0.1, 0.2, -0.3]], axis=-1)[None].astype(np.float32)  # (1, 3, 2)
    x = np.array([[0.7, -0.5, 1.0]], np.float32)
    lp = heads.gaussian_logprob(_t(pd), _t(x))
    expect = norm.logpdf([0.7, -0.5, 1.0], loc=[0.5, -1.0, 2.0], scale=np.exp([0.1, 0.2, -0.3])).sum()
    np.testing.assert_allclose(lp.numpy()[0], expect, rtol=1e-6)
    rng = np.random.default_rng(0)
    q, p = (rng.normal(size=(2, 4, 3, 2)).astype(np.float32) for _ in range(2))
    a = rng.normal(size=(2, 4, 3)).astype(np.float32)
    for ours, theirs in ((heads.gaussian_logprob(_t(q), _t(a)), jax_heads.gaussian_logprob(q, a)),
                         (heads.gaussian_entropy(_t(q)), jax_heads.gaussian_entropy(q)),
                         (heads.gaussian_kl(_t(q), _t(p)), jax_heads.gaussian_kl(q, p))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(heads.gaussian_kl(_t(q), _t(q)).numpy(), 0.0, atol=1e-6)
    unit = torch.zeros((1, 3, 2))  # entropy of a unit gaussian: 0.5 log(2πe) a dimension
    np.testing.assert_allclose(heads.gaussian_entropy(unit).numpy()[0], 3 * 1.4189385, rtol=1e-5)


def test_gaussian_sample_moments():
    pd = torch.stack([torch.full((2000, 2), 3.0), torch.full((2000, 2), float(np.log(0.5)))], dim=-1)
    s = heads.gaussian_sample(pd, generator=torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_allclose(s.mean(0), 3.0, atol=0.05)
    np.testing.assert_allclose(s.std(0), 0.5, atol=0.05)
    np.testing.assert_allclose(heads.gaussian_sample(pd, deterministic=True).numpy(), 3.0)
    eps = torch.randn((2000, 2), generator=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(heads.gaussian_sample(pd, normal=eps).numpy(), (3.0 + 0.5 * eps).numpy(), rtol=1e-6)


def test_dict_head_with_gaussian_matches_vpt_tpu():
    specs = (GAUSS, HeadSpec("disc", (1,), 7))
    jspecs = (jax_heads.HeadSpec("cont", (3,), kind="gaussian"), jax_heads.HeadSpec("disc", (1,), 7))
    x = np.random.default_rng(1).normal(size=(2, 4, 8)).astype(np.float32)
    jhead = jax_heads.DictActionHead(specs=jspecs, temperature=2.0)
    params = jax.tree.map(np.asarray, jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params["params"]["cont"]["log_std"] = np.array([0.1, -0.2, 0.3], np.float32)
    jout = jhead.apply(params, jnp.asarray(x))
    head = heads.DictActionHead(8, specs, temperature=2.0)
    head.load_state_dict(from_jax_variables(params), strict=True)
    out = head(_t(x))
    assert out["cont"].shape == (2, 4, 3, 2) and out["disc"].shape == (2, 4, 1, 7)
    for k in ("cont", "disc"):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]), rtol=1e-6, atol=1e-6)
    pd, jpd = {k: v.detach() for k, v in out.items()}, jax.tree.map(np.asarray, jout)
    act = heads.dict_sample(pd, specs, generator=torch.Generator().manual_seed(2))
    assert act["cont"].shape == (2, 4, 3) and act["disc"].shape == (2, 4, 1)
    jact = {k: np.asarray(v) for k, v in act.items()}
    other = {k: v + 0.1 * torch.randn(v.shape, generator=torch.Generator().manual_seed(3)) for k, v in pd.items()}
    other["disc"] = torch.log_softmax(other["disc"], dim=-1)
    jother = {k: v.numpy() for k, v in other.items()}
    for ours, theirs in ((heads.dict_logprob(pd, act, specs), jax_heads.dict_logprob(jpd, jact, jspecs)),
                         (heads.dict_entropy(pd, specs), jax_heads.dict_entropy(jpd, jspecs)),
                         (heads.dict_kl(pd, other, specs), jax_heads.dict_kl(jpd, jother, jspecs))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(heads.dict_kl(pd, pd, specs).numpy(), 0.0, atol=1e-5)
    det = heads.dict_sample(pd, specs, deterministic=True)
    jdet = jax_heads.dict_sample(jax.random.PRNGKey(0), jpd, jspecs, deterministic=True)
    for k in ("cont", "disc"):
        np.testing.assert_allclose(det[k].numpy(), np.asarray(jdet[k]), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------- PPO

PPO_KWARGS = dict(TINY_KWARGS, recurrence_type="multi_masked_lstm", timesteps=16, attention_memory_size=32)


def _envs(n, done_prob=0.0):
    return [MockMinecraftEnv(seed=i, done_prob=done_prob) for i in range(n)]


def test_ppo_masked_lstm_collect_and_update_match_vpt_tpu():
    """vpt_tpu's PPOTrainer collects with a multi_masked_lstm policy (resets
    mid-window); both trainers update on it from the same weights and
    anchor; the port's own collection re-forwards from its window-start
    carries to its stepped log-probs and values."""
    hp = dict(rollout_len=6, n_minibatches=1, n_epochs=2, learning_rate=1e-3, aux_phase_every=1000)
    jt = jax_rl.PPOTrainer(PPO_KWARGS, {"temperature": 2.0}, hp=jax_rl.PPOHyperparams(**hp),
                           mesh=make_mesh(n_dp=1, devices=jax.devices()[:1]), seed=0)
    jt.init()
    pt = rl.PPOTrainer(PPO_KWARGS, {"temperature": 2.0}, hp=rl.PPOHyperparams(**hp), device="cpu", seed=0)
    pt.init()
    pt.policy.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, jt.variables)), strict=True)
    pt.anchor = pt._snapshot_anchor()
    rng = np.random.default_rng(3)
    envs = _envs(4, done_prob=0.3)
    jtraj, obs, firsts = jt.collect(envs, reward_fn=lambda a, o, r, d: float(rng.normal()))
    jtraj, _, _ = jt.collect(envs, obs, firsts, reward_fn=lambda a, o, r, d: float(rng.normal()))
    assert np.asarray(jtraj["firsts"])[:, 1:].any()
    traj = {k: np.asarray(v) for k, v in jtraj.items() if k != "initial_state"}
    traj["initial_state"] = [{k: _t(v) for k, v in blk.items()} for blk in jtraj["initial_state"]]
    assert sorted(traj["initial_state"][0]) == ["c", "h"] and traj["initial_state"][0]["h"].abs().max() > 0
    theirs, ours = jt.update(jtraj), pt.update(traj)
    for key in ("loss", "pg_loss", "v_loss", "entropy", "grad_norm", "clip_frac", "mean_return"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-4, atol=1e-7, err_msg=key)
    for key in ("anchor_kl", "approx_kl"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=2e-2, atol=1e-7, err_msg=key)

    penvs = _envs(4, done_prob=0.3)
    _, pobs, pfirsts = pt.collect(penvs)
    ptraj, _, _ = pt.collect(penvs, pobs, pfirsts)  # carried mid-stream state: the snapshot is not zero
    with torch.no_grad():
        out, _ = pt.policy(_t(ptraj["frames"]), _t(ptraj["firsts"]), ptraj["initial_state"])
    actions = {"buttons": _t(ptraj["buttons"])[..., None], "camera": _t(ptraj["camera"])[..., None]}
    logp = dict_logprob(out["pi_logits"], actions, pt.head_specs)
    np.testing.assert_allclose(logp.numpy(), ptraj["logp_old"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["vpred"][..., 0].numpy(), ptraj["values"], rtol=1e-4, atol=1e-5)


def test_ppo_none_policy_collects_and_updates():
    """A "none" policy has no state: None passes through the collection, the
    snapshot and the update."""
    kwargs = dict(PPO_KWARGS, recurrence_type="none")
    pt = rl.PPOTrainer(kwargs, {}, hp=rl.PPOHyperparams(rollout_len=4, n_minibatches=2, n_epochs=1),
                       device="cpu", seed=0)
    traj, _, _ = pt.collect(_envs(2, done_prob=0.3))
    assert traj["initial_state"] is None
    metrics = pt.update(traj)
    assert np.isfinite(metrics["loss"])
