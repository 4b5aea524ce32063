"""Pipeline parallelism on two gloo ranks on the CPU (vpt_tpu_torch/parallel/
pp.py, training/pp_bc.py): the tiny policy's two blocks, one a stage.

  * the pipelined block stack's output and its state after the chunk equal
    the sequential stack's at 2 and 4 microbatches (rtol 1e-5, atol 1e-6:
    the same arithmetic on fewer rows a product), the gradients of its
    blocks and of its input at tests/test_torch_training.py's rule (max-abs
    error within max(2e-6, 1e-4 of the max-abs));
  * ``PPBCTrainer``'s three steps equal vpt_tpu's single-device BC steps at
    tests/test_torch_fsdp_tp.py's tolerances, and its ``checkpoint_params``
    has the standard layout;
  * ``split_policy_params``/``merge_policy_params`` round-trip a state_dict.
"""

import os

import pytest
import torch

import test_torch_fsdp_tp as bc_cases
from test_torch_mesh import run_ranks


@pytest.fixture(autouse=True, scope="module")
def _grad_mode():
    """Autograd on: another module of the suite turns grad mode off when it
    is imported, and pytest imports every module of a run in each worker."""
    with torch.enable_grad():
        yield


def _blocks_and_inputs(b=4, t=4):
    from vpt_tpu_torch.actions.mapping import CameraHierarchicalMapping
    from vpt_tpu_torch.config import PolicyConfig
    from vpt_tpu_torch.models.heads import head_specs_from_space
    from vpt_tpu_torch.models.layers import init_parameters
    from vpt_tpu_torch.models.policy import MinecraftAgentPolicy, policy_initial_state
    from vpt_tpu_torch.spaces import DictType

    cfg = PolicyConfig.from_kwargs(dict(bc_cases.TINY_KWARGS))
    specs = head_specs_from_space(DictType(**CameraHierarchicalMapping(n_camera_bins=11).get_action_space_update()))
    policy = MinecraftAgentPolicy(cfg, specs, 2.0)
    init_parameters(policy, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn((b, t, cfg.hidsize), generator=g)
    first = torch.zeros((b, t), dtype=torch.bool)
    first[:, 0] = True
    first[1, 2] = True
    state = policy_initial_state(cfg, b)
    state[0]["k"].normal_(generator=g)
    state[0]["state_mask"][2:, -3:] = True
    w = torch.randn((b, t, cfg.hidsize), generator=g)
    return policy.net.recurrent_layer.blocks, x, first, state, w


def pipeline_cases(rank, world, out_dir):
    from vpt_tpu_torch.parallel import mesh as pm
    from vpt_tpu_torch.parallel.pp import PipelinedBlocks

    mesh = pm.make_mesh(n_pp=2)
    out = {}
    for n_micro in (2, 4):
        blocks, x, first, state, w = _blocks_and_inputs()
        x.requires_grad_(True)
        pipe = PipelinedBlocks([blocks[rank]], pm.group(mesh, ("pp",)), n_micro)
        y, state_out = pipe(x, first, [state[rank]])
        ((y * w).sum() / world).backward()
        out[n_micro] = {"y": y.detach(), "state": state_out,
                        "grads": {n: p.grad.clone() for n, p in blocks[rank].named_parameters()},
                        "x_grad": x.grad.clone() if rank == 0 else None}
    out["trainer"] = pp_trainer(rank, out_dir, mesh)
    return out


def pp_trainer(rank, out_dir, mesh):
    from vpt_tpu_torch.training import bc
    from vpt_tpu_torch.training.pp_bc import PPBCTrainer

    batches = bc_cases.load_batches(os.path.join(out_dir, "batches.npz"))
    trainer = PPBCTrainer(bc_cases.TINY_KWARGS, bc_cases.PI_KWARGS, hp=bc.BCHyperparams(**bc_cases.HP), mesh=mesh,
                          n_micro=2, device="cpu")
    trainer.load_weights(os.path.join(out_dir, "init.weights"))
    state = trainer.initial_state(bc_cases.B)
    losses, norms = [], []
    for batch in batches:
        state, loss, norm = trainer.train_step(batch, state)
        losses.append(float(loss))
        norms.append(float(norm))
    return {"loss": losses, "grad_norm": norms, "weights": trainer.checkpoint_params()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pp"))
    ref = bc_cases.shared_reference(tmp_path_factory, tmp)
    return tmp, ref, run_ranks(2, __file__, "pipeline_cases", tmp)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_pipelined_stack_equals_sequential(run, n_micro):
    _, _, outs = run
    blocks, x, first, state, w = _blocks_and_inputs()
    x.requires_grad_(True)
    h, states = x, []
    for block, s in zip(blocks, state):
        h, s = block(h, first, s)
        states.append(s)
    (h * w).sum().backward()
    for rank, out in enumerate(outs):
        got = out[n_micro]
        torch.testing.assert_close(got["y"], h.detach(), rtol=1e-5, atol=1e-6)
        for k, v in states[rank].items():
            torch.testing.assert_close(got["state"][0][k], v.detach() if isinstance(v, torch.Tensor) else v,
                                       rtol=1e-5, atol=1e-6)
        for name, p in blocks[rank].named_parameters():
            _grad_close(got["grads"][name], p.grad, name)
    _grad_close(outs[0][n_micro]["x_grad"], x.grad, "input")


def _grad_close(got, want, name):
    err = (got - want).abs().max().item()
    assert err <= max(2e-6, 1e-4 * want.abs().max().item()), (name, err)


def test_pp_bc_trainer_equals_vpt_tpu(run):
    _, ref, outs = run
    bc_cases.assert_matches(outs[0]["trainer"], ref, what="pp=2")
    assert outs[1]["trainer"]["loss"] == outs[0]["trainer"]["loss"]
    for k, v in outs[0]["trainer"]["weights"].items():
        assert torch.equal(v, outs[1]["trainer"]["weights"][k]), k


def test_split_and_merge_keep_the_checkpoint_layout():
    from vpt_tpu_torch.parallel.pp import merge_policy_params, split_policy_params

    blocks, *_ = _blocks_and_inputs()
    sd = {f"net.recurrent_layer.blocks.{k}": v for k, v in blocks.state_dict().items()}
    sd["net.lastlayer.layer.weight"] = torch.ones(2, 2)
    rest, stacked = split_policy_params(sd, 2)
    assert set(rest) == {"net.lastlayer.layer.weight"}
    assert stacked["r.orc_block.q_layer.weight"].shape == (2, 64, 64)
    back = merge_policy_params(rest, stacked, 2)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], v) for k, v in sd.items())
