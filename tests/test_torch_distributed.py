"""The port's trainers and agents on two gloo ranks on the CPU against the
single process: vpt_tpu's PPO update (from the same weights, on the same
global batch, under DDP and FSDP2, two minibatches in each of two epochs,
the port taking the permutations vpt_tpu draws; the 2-rank IDM steps are in
tests/test_torch_sp.py, beside the sp one), the port's own single-process
collection, the update of what the ranks collected in two groups against
the single process's (each side's own permutations, from the shared seed),
the agents, and a 2-rank ``BCTrainer.train`` with checkpoints and a resume
against the 1-rank run.  One launch of two ranks computes every case
(``run_ranks`` of tests/test_torch_mesh.py); the tests read its results.

Tolerances: as tests/test_torch_training.py and tests/test_torch_rl.py (the
loss rtol 1e-5 a step, the grad norm rtol 1e-4, parameters within 3·lr a
step; PPO's metrics rtol 1e-4, its KL estimates rtol 2e-2).  The meshed
collection and agents take the same rows through the same arithmetic as the
single process: their sampled actions are equal, their log-probabilities and
values within 1e-5.
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_mesh import run_ranks

IDM_TINY = dict(
    hidsize=64, impala_width=1, impala_chans=[4, 8], img_shape=[32, 32, 4],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1}, impala_kwargs={"post_pool_groups": 1},
    n_recurrence_layers=2, timesteps=8, attention_heads=4, attention_memory_size=16,
    recurrence_type="transformer", attention_mask_style="none", use_pre_lstm_ln=False, obs_processing_width=32,
    conv3d_params={"inchan": 3, "outchan": 4, "kernel_size": [5, 1, 1], "padding": [2, 0, 0]},
)
POLICY_TINY = dict(
    hidsize=64, impala_width=1, impala_chans=[4, 8], img_shape=[32, 32, 3],
    init_norm_kwargs={"batch_norm": False, "group_norm_groups": 1}, impala_kwargs={"post_pool_groups": 1},
    n_recurrence_layers=2, timesteps=16, attention_heads=4, attention_memory_size=32,
    recurrence_type="transformer", attention_mask_style="clipped_causal", use_pre_lstm_ln=False,
    obs_processing_width=32,
)
PI_KWARGS = {"temperature": 2.0}
LR = 1e-3
IDM_B, IDM_T = 2, 8
PPO_HP = dict(rollout_len=6, n_minibatches=2, n_epochs=2, learning_rate=LR, aux_phase_every=1000)
COLLECT_HP = dict(rollout_len=4, n_collect_groups=2, n_minibatches=2, n_epochs=2, learning_rate=LR,
                  aux_phase_every=1000)
STREAMS = 4
BC_HP = dict(batch_size=2, chunk_len=4, epochs=1, learning_rate=LR, loss_report_rate=1, checkpoint_every=1)


@pytest.fixture(autouse=True, scope="module")
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield

# ------------------------------------------------------------------ rank side


def _rows(rank, n):
    return slice(rank * n, (rank + 1) * n)


def groups_to_process_major(x, n_groups: int, n_procs: int, gb_local: int):
    """Rows of a single process's G-group collection (group-major: group g's
    rows are [rank 0's gb_local streams | rank 1's | ...]) → the order the
    ranks' gathered rows take (process-major: rank r's rows [g0 | g1 | ...];
    vpt_tpu/training/rl.py)."""
    return x.reshape((n_groups, n_procs, gb_local) + tuple(x.shape[1:])).swapaxes(0, 1).reshape(
        (-1,) + tuple(x.shape[1:]))


def _process_major(traj):
    """A single process's 2-group trajectory of the 4 streams in the ranks' gathered order."""
    out = {k: groups_to_process_major(v, 2, 2, 1) for k, v in traj.items() if k != "initial_state"}
    out["initial_state"] = [{k: groups_to_process_major(v, 2, 2, 1) for k, v in blk.items()}
                            for blk in traj["initial_state"]]
    return out


def _fed_permutations(perms):
    """A stand-in for ``torch.randperm`` that returns ``perms`` in turn."""
    it = iter(perms)

    def randperm(n, generator=None, device=None):
        p = torch.as_tensor(next(it), dtype=torch.int64, device=device)
        assert p.numel() == n
        return p

    return randperm


def _idm_steps(rank, out_dir, shape):
    from vpt_tpu_torch.parallel import mesh as pm
    from vpt_tpu_torch.training import idm

    data = torch.load(os.path.join(out_dir, "idm_batches.pt"), weights_only=False)
    mesh = pm.make_mesh(**shape)
    trainer = idm.IDMTrainer(IDM_TINY, {"temperature": 1.0}, device="cpu", mesh=mesh,
                             hp=idm.IDMHyperparams(batch_size=IDM_B, window=IDM_T, learning_rate=LR))
    trainer.load_weights(os.path.join(out_dir, "idm_init.weights"))
    losses, norms = [], []
    for batch in data:
        loss, norm = trainer.train_step(pm.local_batch(mesh, batch))
        losses.append(float(loss))
        norms.append(float(norm))
    return {"loss": losses, "grad_norm": norms, "weights": trainer.full_weights()}


def _ppo(rank, out_dir):
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.parallel import mesh as pm
    from vpt_tpu_torch.training import rl

    mesh = pm.make_mesh(n_dp=2)
    traj = torch.load(os.path.join(out_dir, "ppo_traj.pt"), weights_only=False)
    rows = _rows(rank, STREAMS // 2)
    local = {k: v[rows] for k, v in traj.items() if k != "initial_state"}
    local["initial_state"] = [{k: v[rows] for k, v in blk.items()} for blk in traj["initial_state"]]
    perms = torch.load(os.path.join(out_dir, "ppo_perms.pt"), weights_only=False)
    out = {}
    for name, shape in (("dp", dict(n_dp=2)), ("fsdp", dict(n_fsdp=2))):
        trainer = rl.PPOTrainer(POLICY_TINY, PI_KWARGS, hp=rl.PPOHyperparams(**PPO_HP), device="cpu",
                                mesh=pm.make_mesh(**shape))
        trainer.load_weights(os.path.join(out_dir, "ppo_init.weights"))
        with mock.patch.object(torch, "randperm", _fed_permutations(perms)):  # vpt_tpu's minibatches
            metrics = trainer.update(local)
        out[name] = {"metrics": metrics, "weights": pm.full_state_dict(trainer.policy)}
    # the sharded policy collects too (FSDP2 gathers its parameters outside inference mode)
    buf, _, _ = trainer.collect([MockMinecraftEnv(seed=s) for s in (rank, 2 + rank)])
    out["fsdp_logp"] = buf["logp_old"]
    # collection: two round-robin groups of one local stream each; rank r's
    # streams are streams r and 2 + r of the single process's four
    collector = rl.PPOTrainer(POLICY_TINY, PI_KWARGS, device="cpu", mesh=mesh, hp=rl.PPOHyperparams(**COLLECT_HP))
    collector.load_weights(os.path.join(out_dir, "ppo_init.weights"))
    envs = [MockMinecraftEnv(seed=s, done_prob=0.3) for s in (rank, 2 + rank)]
    buf, _, _ = collector.collect(envs)
    out["collect"] = {k: collector._gather(buf[k]) for k in ("buttons", "camera", "logp_old", "values", "rewards",
                                                               "firsts", "last_value")}
    # and its update: two minibatches of the gathered (process-major) rows, two epochs
    out["collect_update"] = {"metrics": collector.update(buf), "weights": pm.full_state_dict(collector.policy)}
    return out


def _agents(rank, out_dir):
    from vpt_tpu_torch.agent.agent import MineRLAgent
    from vpt_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(n_dp=2)
    obs = np.load(os.path.join(out_dir, "agent_obs.npy"))  # (steps, streams, H, W, 3)
    out = {}
    for stochastic in (False, True):
        agent = MineRLAgent(device="cpu", policy_kwargs=POLICY_TINY, pi_head_kwargs=PI_KWARGS,
                            batch_size=STREAMS, seed=0, mesh=mesh)
        acts = []
        for t in range(obs.shape[0]):
            got = agent.get_action([{"pov": o} for o in obs[t, _rows(rank, STREAMS // 2)]],
                                   first=np.full(STREAMS // 2, t == 0), stochastic=stochastic)
            acts.append([{k: np.asarray(v) for k, v in a.items()} for a in got])
        out[stochastic] = acts
    return out


def _bc_train(rank, out_dir):
    import io
    import shutil

    from vpt_tpu_torch.parallel import mesh as pm
    from vpt_tpu_torch.training import bc
    from vpt_tpu_torch.utils.metrics import MetricsLogger

    mesh = pm.make_mesh(n_dp=2)
    data = os.path.join(out_dir, "corpus")
    ckpt = os.path.join(out_dir, "ckpt")
    log = io.StringIO()

    def trainer():
        t = bc.BCTrainer(POLICY_TINY, PI_KWARGS, hp=bc.BCHyperparams(**BC_HP, checkpoint_dir=ckpt), device="cpu",
                         mesh=mesh)
        t.load_weights(os.path.join(out_dir, "bc_init.weights"))
        return t

    whole = trainer()
    steps = whole.train(data, os.path.join(out_dir, "bc_2rank.weights"), metrics=MetricsLogger(stream=log))
    listing = {d: sorted(os.listdir(os.path.join(ckpt, d)) if os.path.isdir(os.path.join(ckpt, d)) else [])
               for d in ("", "shard0", "shard1")}
    pm.barrier()
    if rank == 0:  # an interrupted run: only the oldest checkpoint kept survives
        first = min((n for n in os.listdir(ckpt) if n.startswith("step_")), key=lambda n: int(n[5:]))
        for d in (ckpt, os.path.join(ckpt, "shard1")):
            for name in os.listdir(d):
                if name.startswith("step_") and name != first:
                    shutil.rmtree(os.path.join(d, name))
    pm.barrier()
    resumed = trainer()
    resumed.train(data, os.path.join(out_dir, "bc_resumed.weights"), resume_dir=ckpt)
    return {"steps": steps, "losses": [json.loads(line)["loss"] for line in log.getvalue().splitlines()
                                       if "loss" in line],
            "listing": listing, "resumed_steps": resumed.step_count}


def all_cases(rank, world, out_dir, bc_train):
    out = {"ppo": _ppo(rank, out_dir), "agents": _agents(rank, out_dir)}
    if bc_train:
        out["bc"] = _bc_train(rank, out_dir)
    return out


# ------------------------------------------------------------------ parent side


def _host(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _idm_reference(tmp):
    import jax

    from vpt_tpu.parallel.mesh import make_mesh
    from vpt_tpu.training import idm as jax_idm
    from vpt_tpu_torch.checkpoint import from_jax_variables

    rng = np.random.default_rng(0)
    batches = []
    for s in range(3):
        mask = np.ones((IDM_B, IDM_T), bool)
        if s == 2:
            mask[1, 5:] = False
        batches.append({"frames": rng.integers(0, 256, (IDM_B, IDM_T, 32, 32, 3), dtype=np.uint8),
                        "buttons": rng.integers(0, 8641, (IDM_B, IDM_T)).astype(np.int32),
                        "camera": rng.integers(0, 121, (IDM_B, IDM_T)).astype(np.int32),
                        "firsts": np.zeros((IDM_B, IDM_T), bool), "mask": mask})
    torch.save(batches, os.path.join(tmp, "idm_batches.pt"))
    jt = jax_idm.IDMTrainer(IDM_TINY, {"temperature": 1.0}, mesh=make_mesh(n_dp=1, devices=jax.devices()[:1]),
                            hp=jax_idm.IDMHyperparams(batch_size=IDM_B, window=IDM_T, learning_rate=LR), seed=0)
    jt.init()
    torch.save(from_jax_variables(_host(jt.variables)), os.path.join(tmp, "idm_init.weights"))
    losses, norms = [], []
    for batch in batches:
        loss, norm = jt.train_step(dict(batch))
        losses.append(float(loss))
        norms.append(float(norm))
    return {"loss": losses, "grad_norm": norms, "weights": from_jax_variables(_host(jt.variables))}


def _ppo_reference(tmp):
    import jax

    from vpt_tpu.parallel.mesh import make_mesh
    from vpt_tpu.training import rl as jax_rl
    from vpt_tpu_torch.agent.rollout import MockMinecraftEnv
    from vpt_tpu_torch.checkpoint import from_jax_variables
    from vpt_tpu_torch.training import rl

    jt = jax_rl.PPOTrainer(POLICY_TINY, PI_KWARGS, hp=jax_rl.PPOHyperparams(**PPO_HP),
                           mesh=make_mesh(n_dp=1, devices=jax.devices()[:1]), seed=0)
    jt.init()
    torch.save(from_jax_variables(_host(jt.variables)), os.path.join(tmp, "ppo_init.weights"))
    rng = np.random.default_rng(3)
    jtraj, _, _ = jt.collect([MockMinecraftEnv(seed=i, done_prob=0.3) for i in range(STREAMS)],
                             reward_fn=lambda a, o, r, d: float(rng.normal()))
    assert np.asarray(jtraj["firsts"])[:, 1:].any(), "the fixture must hold mid-window resets"
    traj = {k: np.asarray(v) for k, v in jtraj.items() if k != "initial_state"}
    traj["initial_state"] = [{k: torch.from_numpy(np.array(v)) for k, v in blk.items()}
                             for blk in jtraj["initial_state"]]
    torch.save(traj, os.path.join(tmp, "ppo_traj.pt"))
    # the permutations update() draws: one key split off the trainer's, one key an epoch
    _, key = jax.random.split(jt._rng)
    perms = [np.asarray(jax.random.permutation(k, STREAMS)) for k in jax.random.split(key, PPO_HP["n_epochs"])]
    torch.save(perms, os.path.join(tmp, "ppo_perms.pt"))
    out = {"update": {"metrics": jt.update(jtraj), "weights": from_jax_variables(_host(jt.variables))}}
    # the port's own single process collecting the four streams in two groups, then updating on them in the
    # ranks' gathered order
    single = rl.PPOTrainer(POLICY_TINY, PI_KWARGS, device="cpu", hp=rl.PPOHyperparams(**COLLECT_HP))
    single.load_weights(os.path.join(tmp, "ppo_init.weights"))
    buf, _, _ = single.collect([MockMinecraftEnv(seed=s, done_prob=0.3) for s in range(STREAMS)])
    out["collect"] = buf
    out["collect_update"] = {"metrics": single.update(_process_major(buf)),
                             "weights": {k: v.clone() for k, v in single.policy.state_dict().items()}}
    return out


def _agent_reference(tmp):
    from vpt_tpu_torch.agent.agent import MineRLAgent

    obs = np.random.default_rng(5).integers(0, 256, (3, STREAMS, 64, 96, 3), dtype=np.uint8)
    np.save(os.path.join(tmp, "agent_obs.npy"), obs)
    out = {}
    for stochastic in (False, True):
        agent = MineRLAgent(device="cpu", policy_kwargs=POLICY_TINY, pi_head_kwargs=PI_KWARGS, batch_size=STREAMS,
                            seed=0)
        out[stochastic] = [agent.get_action([{"pov": o} for o in obs[t]], first=np.full(STREAMS, t == 0),
                                            stochastic=stochastic) for t in range(obs.shape[0])]
    return out


def _corpus(path, n=4, frames=6):
    from vpt_tpu_torch.data import video

    keys = ["key.keyboard.w", "key.keyboard.a", "key.keyboard.s"]
    os.makedirs(path)
    for j in range(n):
        rng = np.random.default_rng(10 + j)
        with video.VideoWriter(os.path.join(path, f"t{j}.mp4"), 64, 36, fps=20) as w:
            for _ in range(frames + j):
                w.write(rng.integers(0, 256, (36, 64, 3), dtype=np.uint8))
        with open(os.path.join(path, f"t{j}.jsonl"), "w") as f:
            for i in range(frames + j):
                f.write(json.dumps({"keyboard": {"keys": [keys[(i + j) % 3]]}, "hotbar": 0, "isGuiOpen": False,
                                    "mouse": {"x": 10.0, "y": 10.0, "dx": float(i % 3), "dy": 0.0, "buttons": [],
                                              "newButtons": []}}) + "\n")


def _native_video() -> bool:
    from vpt_tpu_torch.data import video

    try:
        video.build()
        return True
    except RuntimeError:
        return False


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from vpt_tpu_torch.training import bc

    tmp = str(tmp_path_factory.mktemp("dist"))
    ref = {"ppo": _ppo_reference(tmp), "agents": _agent_reference(tmp)}
    bc_train = _native_video()
    if bc_train:
        _corpus(os.path.join(tmp, "corpus"))
        import io

        from vpt_tpu_torch.utils.metrics import MetricsLogger

        single = bc.BCTrainer(POLICY_TINY, PI_KWARGS, hp=bc.BCHyperparams(**BC_HP), device="cpu")
        single.init()
        torch.save(single.policy.state_dict(), os.path.join(tmp, "bc_init.weights"))
        log = io.StringIO()
        single.train(os.path.join(tmp, "corpus"), os.path.join(tmp, "bc_1rank.weights"),
                     metrics=MetricsLogger(stream=log))
        ref["bc"] = {"steps": single.step_count,
                     "losses": [json.loads(line)["loss"] for line in log.getvalue().splitlines() if "loss" in line]}
    outs = run_ranks(2, __file__, "all_cases", tmp, bc_train=bc_train)
    return tmp, ref, outs


def _weights_close(ours, theirs, atol):
    assert set(ours) == set(theirs)
    for name, v in ours.items():
        err = (v.double() - theirs[name].double().reshape(v.shape)).abs().max().item()
        assert err <= atol, (name, err)


def _assert_ppo_update(ours, theirs, steps):
    """PPO's metrics, the EWMA stats and the weights after ``steps`` minibatch steps."""
    for key in ("loss", "pg_loss", "v_loss", "entropy", "grad_norm", "clip_frac", "mean_reward", "mean_return",
                "kl_coef"):
        np.testing.assert_allclose(ours["metrics"][key], theirs["metrics"][key], rtol=1e-4, atol=1e-7, err_msg=key)
    for key in ("anchor_kl", "approx_kl"):
        np.testing.assert_allclose(ours["metrics"][key], theirs["metrics"][key], rtol=2e-2, atol=1e-7, err_msg=key)
    weights = ours["weights"]
    for k in ("running_mean", "running_mean_sq", "debiasing_term"):
        name = f"value_head.normalizer.{k}"
        np.testing.assert_allclose(weights[name].numpy(), theirs["weights"][name].numpy().reshape(-1)
                                   .reshape(weights[name].shape), rtol=1e-6, err_msg=name)
    _weights_close(weights, theirs["weights"], 3 * LR * steps)


@pytest.mark.parametrize("mesh", ["dp", "fsdp"])
def test_two_rank_ppo_update_equals_vpt_tpu(run, mesh):
    """Each rank updates on its two of the four streams: the advantages are
    normalised and the EWMA stats folded over all four, as in one process,
    with the policy and its anchor whole (DDP) or sharded (FSDP2); each rank
    steps its half of every one of vpt_tpu's two minibatches an epoch."""
    _, ref, outs = run
    ours = outs[0]["ppo"][mesh]
    _assert_ppo_update(ours, ref["ppo"]["update"], PPO_HP["n_epochs"] * PPO_HP["n_minibatches"])
    assert outs[1]["ppo"][mesh]["metrics"] == ours["metrics"]
    if mesh == "fsdp":
        assert np.isfinite(outs[0]["ppo"]["fsdp_logp"]).all()


def test_two_rank_update_of_a_two_group_collect_equals_one_process(run):
    """What the ranks collected in two groups, gathered process-major and
    updated in two minibatches over two epochs from the shared permutation
    generator, equals the single process's update of its own 2-group
    collection in that order."""
    _, ref, outs = run
    ours = outs[0]["ppo"]["collect_update"]
    _assert_ppo_update(ours, ref["ppo"]["collect_update"], COLLECT_HP["n_epochs"] * COLLECT_HP["n_minibatches"])
    assert outs[1]["ppo"]["collect_update"]["metrics"] == ours["metrics"]


def test_two_rank_collection_equals_one_process(run):
    """Rank r's local group g holds stream g·2 + r of the single process's
    four; with the group's noise drawn whole from the shared seed the ranks
    sample what one process does, its rows in process-major order."""
    _, ref, outs = run
    single, ours = ref["ppo"]["collect"], outs[0]["ppo"]["collect"]
    for key, value in ours.items():
        want = groups_to_process_major(np.asarray(single[key]), 2, 2, 1)
        if key in ("logp_old", "values", "last_value"):
            np.testing.assert_allclose(value, want, rtol=1e-5, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(value, want, err_msg=key)
    assert ours["firsts"][:, 1:].any()


@pytest.mark.parametrize("stochastic", [False, True])
def test_meshed_agent_equals_single_process(run, stochastic):
    _, ref, outs = run
    single = ref["agents"][stochastic]
    for t, step in enumerate(single):
        ours = outs[0]["agents"][stochastic][t] + outs[1]["agents"][stochastic][t]
        assert len(ours) == len(step) == STREAMS
        for a, b in zip(ours, step):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=f"step {t} {k}")
    if stochastic:  # sampling differs from the argmax somewhere
        det = ref["agents"][False]
        assert any(not np.array_equal(np.asarray(a["camera"]), np.asarray(b["camera"]))
                   for s, d in zip(single, det) for a, b in zip(s, d))


def test_two_rank_bc_train_checkpoints_and_resume(run):
    """Rank 0 writes the whole weights and checkpoints, rank 1 its cursor and
    state under shard1; a resume from the first checkpoint ends where the
    uninterrupted run ends; and the run equals the 1-rank run."""
    tmp, ref, outs = run
    if "bc" not in outs[0]:
        pytest.skip("the port's native video library cannot be built (libav)")
    ours = outs[0]["bc"]
    assert ours["steps"] == ref["bc"]["steps"] == outs[0]["bc"]["resumed_steps"] >= 3
    np.testing.assert_allclose(ours["losses"], ref["bc"]["losses"], rtol=1e-5)
    assert "shard1" in ours["listing"][""] and ours["listing"]["shard0"] == []
    assert ours["listing"]["shard1"] == [n for n in ours["listing"][""] if n.startswith("step_")]
    whole = torch.load(os.path.join(tmp, "bc_2rank.weights"), weights_only=True)
    resumed = torch.load(os.path.join(tmp, "bc_resumed.weights"), weights_only=True)
    single = torch.load(os.path.join(tmp, "bc_1rank.weights"), weights_only=True)
    assert set(whole) == set(single)
    for k, v in whole.items():
        assert torch.equal(v, resumed[k]), k
    _weights_close(whole, single, 3 * LR * ours["steps"])


def test_loader_shards_serve_the_global_streams(tmp_path, capsys):
    """Two shards of one stream each yield, together, what one loader of both
    streams yields; the cursor records the shard, and a resume from another
    shard's cursor drops it for the coarse trajectory cursor, as vpt_tpu's
    loader does."""
    if not _native_video():
        pytest.skip("the port's native video library cannot be built (libav)")
    from vpt_tpu_torch.data.loader import SequenceDataLoader

    data = str(tmp_path / "corpus")
    _corpus(data)
    kw = dict(chunk_len=4, n_epochs=1, seed=3, resolution=(32, 32))
    whole = SequenceDataLoader(data, batch_size=2, **kw)
    shards = [SequenceDataLoader(data, batch_size=1, shard_id=i, num_shards=2, **kw) for i in range(2)]
    try:
        n = 0
        for batch, *parts in zip(whole, *shards):
            for key in ("frames", "buttons", "camera", "firsts", "mask", "episode_ids"):
                np.testing.assert_array_equal(batch[key], np.concatenate([p[key] for p in parts]), err_msg=key)
            n += 1
        assert n >= 2
        assert shards[1].state()["shard"] == [1, 2]
        other = SequenceDataLoader(data, batch_size=1, shard_id=0, num_shards=2, resume_state=shards[1].state(), **kw)
        shards.append(other)
        assert "coarse trajectory cursor" in capsys.readouterr().out
        fresh = SequenceDataLoader(data, batch_size=1, shard_id=0, num_shards=2, **kw)
        shards.append(fresh)
        got, expect = list(other), list(fresh)
        assert len(got) == len(expect) >= 2
        for a, b in zip(got, expect):
            for key in ("frames", "buttons", "camera", "firsts", "mask", "episode_ids"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    finally:
        for loader in [whole] + shards:
            loader.close()
