"""The port's BC step on a mesh of two gloo ranks on the CPU (DDP, FSDP2,
tensor parallelism; dp x fsdp on four ranks is in tests/test_torch_mesh.py)
against vpt_tpu's single-device step, from the same weights and on the same
global batch; and the port's
FSDP and tensor-parallel placement rules against vpt_tpu's ``leaf_spec`` and
``param_spec`` on every leaf of the tiny policy.

The vpt_tpu side runs in this process on a 1-device mesh; the port's ranks
run in their own interpreters (``run_ranks`` of tests/test_torch_mesh.py),
each given its rows of the global batch.  Tolerances are those of
tests/test_torch_training.py: the loss of each of three steps rtol 1e-5, the
grad norm rtol 1e-4, every parameter after the three steps within 3·lr.
"""

import os

import numpy as np
import pytest
import torch

from test_torch_mesh import run_ranks

TINY_KWARGS = dict(
    hidsize=64, impala_width=1, impala_chans=[4, 8], img_shape=[32, 32, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1}, impala_kwargs={"post_pool_groups": 1},
    n_recurrence_layers=2, timesteps=4, attention_heads=4, attention_memory_size=8,
    recurrence_type="transformer", attention_mask_style="clipped_causal", use_pre_lstm_ln=False,
    obs_processing_width=32,
)
PI_KWARGS = {"temperature": 2.0}
B, T, STEPS = 4, 4, 3
LR = 1e-3
HP = dict(batch_size=B, chunk_len=T, learning_rate=LR)


@pytest.fixture(autouse=True, scope="module")
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


def make_batches(seed=0, b=B, t=T, steps=STEPS):
    """Chunks: every stream starts, then a mid-chunk reset, then a padded tail."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        firsts = np.zeros((b, t), bool)
        mask = np.ones((b, t), bool)
        if s == 0:
            firsts[:, 0] = True
        if s == 1:
            firsts[1, 2] = True
        if s == 2:
            mask[0, 2:] = False
            mask[3, 1:] = False
        out.append({"frames": rng.integers(0, 256, (b, t, 32, 32, 3), dtype=np.uint8),
                    "buttons": rng.integers(0, 8641, (b, t)).astype(np.int32),
                    "camera": rng.integers(0, 121, (b, t)).astype(np.int32),
                    "firsts": firsts, "mask": mask})
    return out


def save_batches(path, batches):
    np.savez(path, **{f"{i}_{k}": v for i, b in enumerate(batches) for k, v in b.items()})


def load_batches(path):
    data = np.load(path)
    n = 1 + max(int(k.split("_", 1)[0]) for k in data.files)
    return [{k.split("_", 1)[1]: data[k] for k in data.files if k.startswith(f"{i}_")} for i in range(n)]


# ------------------------------------------------------------------ rank side


def bc_steps(rank, world, out_dir, meshes, kwargs=None, steps=STEPS):
    """For each named mesh shape: a BCTrainer on it, the shared initial
    weights loaded, ``steps`` steps on this rank's rows; rank 0 returns the
    losses, grad norms and whole weights after."""
    from vpt_tpu_torch.parallel import mesh as pm
    from vpt_tpu_torch.training import bc

    batches = load_batches(os.path.join(out_dir, "batches.npz"))
    out = {}
    for name, shape in meshes.items():
        mesh = pm.make_mesh(**shape)
        trainer = bc.BCTrainer(dict(TINY_KWARGS, **(kwargs or {})), PI_KWARGS, hp=bc.BCHyperparams(**HP),
                               device="cpu", mesh=mesh)
        report = trainer.load_weights(os.path.join(out_dir, "init.weights"))
        assert not report["missing"] and not report["unexpected"], report
        state = trainer.initial_state(B)
        losses, norms = [], []
        for batch in batches[:steps]:
            state, loss, norm = trainer.train_step(pm.local_batch(mesh, batch), state)
            losses.append(float(loss))
            norms.append(float(norm))
        weights = trainer.full_weights()
        out[name] = {"loss": losses, "grad_norm": norms, "weights": weights if rank == 0 else None,
                     "sharded": sorted(n for n, p in trainer.policy.named_parameters()
                                       if isinstance(p, torch.distributed.tensor.DTensor))}
    return out


def named_moments(trainer):
    """{parameter name: its Adam state, whole} (a collective under tp)."""
    from vpt_tpu_torch.parallel.mesh import full_tensor

    names = {id(p): n for n, p in trainer.policy.named_parameters()}
    return {names[id(p)]: {k: full_tensor(v).detach().clone().cpu() for k, v in trainer.optimizer.adam.state[p].items()}
            for p in trainer.optimizer.params}


def tp_resume(rank, world, out_dir):
    """A tp=2 trainer resumes the meshless checkpoint ``ckpt_meshless`` and
    writes it back (``ckpt_roundtrip``), takes one step on the second batch
    from a fresh state and writes ``ckpt_tp``; returns its Adam state by
    parameter name after the resume and after the step, and its weights."""
    from vpt_tpu_torch.parallel import mesh as pm
    from vpt_tpu_torch.training import bc

    batch = load_batches(os.path.join(out_dir, "batches.npz"))[1]
    trainer = bc.BCTrainer(dict(TINY_KWARGS), PI_KWARGS, hp=bc.BCHyperparams(**HP), device="cpu",
                           mesh=pm.make_mesh(n_tp=2))
    trainer.restore_checkpoint(os.path.join(out_dir, "ckpt_meshless"))
    restored = named_moments(trainer)
    trainer.save_checkpoint(os.path.join(out_dir, "ckpt_roundtrip"))
    trainer.train_step(batch, trainer.initial_state(B))
    trainer.save_checkpoint(os.path.join(out_dir, "ckpt_tp"))
    return {"restored": restored, "stepped": named_moments(trainer), "weights": trainer.full_weights(),
            "groups": len(trainer.optimizer.adam.param_groups)}


# ------------------------------------------------------------------ reference


def jax_reference(tmp_path, batches, steps=STEPS, kwargs=None):
    """vpt_tpu's BC trainer: initial weights written for the ranks, then its
    losses, grad norms and weights after ``steps`` steps."""
    import jax

    from vpt_tpu.parallel.mesh import make_mesh
    from vpt_tpu.training import bc as jax_bc
    from vpt_tpu_torch.checkpoint import from_jax_variables

    jt = jax_bc.BCTrainer(dict(TINY_KWARGS, **(kwargs or {})), PI_KWARGS, hp=jax_bc.BCHyperparams(**HP),
                          mesh=make_mesh(n_dp=1, devices=jax.devices()[:1]), seed=0)
    jt.init()
    torch.save(from_jax_variables(jax.tree.map(np.asarray, jt.variables)), os.path.join(tmp_path, "init.weights"))
    save_batches(os.path.join(tmp_path, "batches.npz"), batches)
    state = jt.initial_state(B)
    losses, norms = [], []
    for batch in batches[:steps]:
        state, loss, norm = jt.train_step(batch, state)
        losses.append(float(loss))
        norms.append(float(norm))
    return {"loss": losses, "grad_norm": norms,
            "weights": from_jax_variables(jax.tree.map(np.asarray, jt.variables))}


def shared_reference(tmp_path_factory, dest):
    """:func:`jax_reference` once a test session: the first of the session's
    test processes (pytest-xdist workers share the base temporary
    directory's parent) computes it under a file lock, the others read it;
    its initial weights and batches are copied into ``dest`` for the ranks."""
    import shutil

    from filelock import FileLock

    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    path = root / "bc_jax_reference"
    with FileLock(str(root / "bc_jax_reference.lock")):
        if not (path / "ref.pt").exists():
            path.mkdir(exist_ok=True)
            torch.save(jax_reference(path, make_batches()), path / "ref.pt")
    for name in ("init.weights", "batches.npz"):
        shutil.copy(path / name, os.path.join(dest, name))
    return torch.load(path / "ref.pt", weights_only=False)


def assert_matches(ours, ref, steps=STEPS, what=""):
    np.testing.assert_allclose(ours["loss"], ref["loss"][:steps], rtol=1e-5, err_msg=f"{what} loss")
    np.testing.assert_allclose(ours["grad_norm"], ref["grad_norm"][:steps], rtol=1e-4, err_msg=f"{what} grad norm")
    assert set(ours["weights"]) == set(ref["weights"]), what
    for name, value in ours["weights"].items():
        err = (value.double() - ref["weights"][name].double()).abs().max().item()
        assert err <= 3 * LR, (what, name, err)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bc_ref")
    return tmp, shared_reference(tmp_path_factory, tmp)


@pytest.fixture(scope="module")
def two_ranks(reference):
    tmp, _ = reference
    meshes = {"ddp": dict(n_dp=2), "fsdp": dict(n_fsdp=2), "tp": dict(n_tp=2)}
    return run_ranks(2, __file__, "bc_steps", tmp, meshes=meshes)


@pytest.mark.parametrize("wrapper", ["ddp", "fsdp", "tp"])
def test_two_rank_bc_step_equals_vpt_tpu(two_ranks, reference, wrapper):
    ours = two_ranks[0][wrapper]
    assert_matches(ours, reference[1], what=wrapper)
    for rank_out in two_ranks[1:]:  # every rank reports the global loss and norm
        np.testing.assert_allclose(rank_out[wrapper]["loss"], ours["loss"], rtol=1e-6)
        np.testing.assert_allclose(rank_out[wrapper]["grad_norm"], ours["grad_norm"], rtol=1e-6)
    sharded = ours["sharded"]
    if wrapper == "ddp":
        assert sharded == []
    elif wrapper == "fsdp":
        assert len(sharded) == len(ours["weights"]) - sum("normalizer" in k for k in ours["weights"])
    else:
        assert all(".r.orc_block." in n or ".mlp" in n for n in sharded) and len(sharded) >= 2 * 8


def _same(a, b, where=""):
    """Bit for bit: tensors of one dtype and value, and the containers around them."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (where, sorted(set(a) ^ set(b))[:5])
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}/{i}")
    else:
        assert a == b, (where, a, b)


def test_checkpoint_moves_between_tp_and_one_device(reference):
    """The optimizer state is saved in the single-device layout under tensor
    parallelism too, where the mixed plain and DTensor parameters are two
    Adam groups at run time.  A meshless checkpoint resumes on tp=2 with
    every parameter's Adam state its own, bit for bit, and saved again is
    the same file; a tp=2 checkpoint resumes on one device with the tp
    trainer's weights and Adam state, bit for bit, and saved again is the
    same file."""
    from vpt_tpu_torch.checkpoint import native as native_ckpt
    from vpt_tpu_torch.training import bc

    tmp, _ = reference

    def trainer():
        t = bc.BCTrainer(dict(TINY_KWARGS), PI_KWARGS, hp=bc.BCHyperparams(**HP), device="cpu")
        t.load_weights(os.path.join(tmp, "init.weights"))
        return t

    def payload(name):
        return native_ckpt.restore_checkpoint(os.path.join(tmp, name))[0]

    meshless = trainer()
    meshless.train_step(load_batches(os.path.join(tmp, "batches.npz"))[0], meshless.initial_state(B))
    meshless.save_checkpoint(os.path.join(tmp, "ckpt_meshless"))
    tp = run_ranks(2, __file__, "tp_resume", tmp)[0]
    assert tp["groups"] == 2  # plain and DTensor parameters apart
    _same(tp["restored"], named_moments(meshless), "restored on tp")
    for name in ("variables", "opt_state"):
        _same(payload("ckpt_roundtrip")[name], payload("ckpt_meshless")[name], name)

    resumed = trainer()
    resumed.restore_checkpoint(os.path.join(tmp, "ckpt_tp"))
    assert resumed.step_count == 2
    _same(named_moments(resumed), tp["stepped"], "restored on one device")
    _same(resumed.full_weights(), tp["weights"], "weights")
    resumed.save_checkpoint(os.path.join(tmp, "ckpt_tp_roundtrip"))
    for name in ("variables", "opt_state"):
        _same(payload("ckpt_tp_roundtrip")[name], payload("ckpt_tp")[name], name)


# ------------------------------------------------------------------ rules


def _policy():
    from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
    from vpt_tpu_torch.config import PolicyConfig
    from vpt_tpu_torch.models.heads import head_specs_from_space
    from vpt_tpu_torch.models.policy import MinecraftAgentPolicy
    from vpt_tpu_torch.spaces import DictType

    specs = head_specs_from_space(DictType(**CameraHierarchicalMapping(n_camera_bins=11).get_action_space_update()))
    return MinecraftAgentPolicy(PolicyConfig.from_kwargs(dict(TINY_KWARGS)), specs, 2.0)


def _jax_leaves():
    """{torch name: (JAX path, JAX shape)} of the tiny policy's params."""
    import jax
    import jax.numpy as jnp

    from vpt_tpu.actions.mapping import CameraHierarchicalMapping
    from vpt_tpu.config import PolicyConfig
    from vpt_tpu.models.heads import head_specs_from_space
    from vpt_tpu.models.policy import MinecraftAgentPolicy, policy_initial_state
    from vpt_tpu.spaces import DictType
    from vpt_tpu_torch.checkpoint.torch_import import torch_key

    cfg = PolicyConfig.from_kwargs(dict(TINY_KWARGS))
    specs = head_specs_from_space(DictType(**CameraHierarchicalMapping(n_camera_bins=11).get_action_space_update()))
    model = MinecraftAgentPolicy(cfg=cfg, head_specs=specs, temperature=2.0)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 32, 32, 3), jnp.uint8),
                            jnp.zeros((1, 1), bool), policy_initial_state(cfg, 1))
    out = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(shapes["params"])[0]:
        path = ("params",) + tuple(k.key for k in keypath)
        out[torch_key(path[1:])] = (path, tuple(leaf.shape))
    return out


@pytest.mark.parametrize("fsdp,tp", [(2, 1), (4, 1), (1, 2), (1, 4), (2, 2)])
def test_fsdp_and_tp_rules_agree_with_vpt_tpu(fsdp, tp):
    """Each leaf's sharded dims, in the JAX layout, are vpt_tpu's; the port's
    one departure is ``r_layer``, which the port splits by heads under tp."""
    from vpt_tpu.parallel.fsdp import leaf_spec
    from vpt_tpu_torch.parallel.fsdp import jax_dims, shard_dim
    from vpt_tpu_torch.parallel.tp import tp_plan, tp_shard_dim

    leaves = _jax_leaves()
    policy = _policy()
    planned = set()
    for name, p in policy.named_parameters():
        path, jshape = leaves[name]
        jd = jax_dims(name, p.dim())
        assert tuple(p.shape[i] for i in np.argsort(jd)) == jshape, name
        tp_dim = tp_shard_dim(name, tuple(p.shape), tp)
        ours = [None] * p.dim()
        if tp_dim is not None:
            ours[jd[tp_dim]] = "tp"
            owner = name[:-len(".weight")]
            planned.add(owner.rsplit(".", 1)[0] if owner.endswith((".layer", ".linear_layer")) else owner)
        f_dim = shard_dim(name, tuple(p.shape), fsdp, taken=tp_dim)
        if f_dim is not None:
            ours[jd[f_dim]] = "fsdp"
        theirs = list(leaf_spec(path, jshape, fsdp, tp))
        theirs += [None] * (p.dim() - len(theirs))
        if ".r_layer." in name and tp_dim is not None:
            assert jd[tp_dim] == 1 and p.shape[tp_dim] % tp == 0, name  # the n·H output, by heads
            continue
        assert ours == theirs, (name, ours, theirs)
    if tp > 1:
        assert set(tp_plan(policy, tp)) == planned
        assert len(planned) == 2 * 7  # q, k, v, r, proj, mlp0, mlp1 of both blocks: no head divides
