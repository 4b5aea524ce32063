"""The benchmark's plain reference against the port at tiny widths on the
CPU, on the weights the benchmark draws (portbench/inputs.py): the policy
chunked with carried state and resets, stepped on the agent's ring cache,
one BC step with the clipped Adam update, and the IDM.  Also that the
reference's parameter list is the published models' at their full widths.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import inputs, manifest
from portbench.reference import actions as ref_actions
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train
from portbench.tests import tiny

TOL = 2e-5


def _arch(kind: str):
    return ref_model.arch_from_config(tiny.spec(kind)["config"])


def _port_policy(cfg_kwargs, head_temperature):
    from vpt_tpu_torch.actions import CameraHierarchicalMapping
    from vpt_tpu_torch.config import PolicyConfig
    from vpt_tpu_torch.models.heads import head_specs_from_space
    from vpt_tpu_torch.models.policy import MinecraftAgentPolicy
    from vpt_tpu_torch.spaces import DictType

    cfg = PolicyConfig.from_kwargs(cfg_kwargs)
    specs = head_specs_from_space(DictType(**CameraHierarchicalMapping(n_camera_bins=11).get_action_space_update()))
    return MinecraftAgentPolicy(cfg, specs, head_temperature).eval(), cfg


@pytest.mark.parametrize("config", ["policy2x", "idm4x"])
def test_parameter_count_is_the_published_models(config):
    bench = manifest.load()
    with open(manifest.config_file(bench, config)) as f:
        cfg = json.load(f)
    arch = ref_model.arch_from_config(cfg)
    n = sum(int(np.prod(shape)) for _, shape, _, _ in ref_model.param_spec(arch))
    assert n == cfg["parameters"]


def test_policy_chunks_with_resets_match_the_port():
    from vpt_tpu_torch.models.policy import policy_initial_state

    arch = _arch("bc")
    policy, cfg = _port_policy(tiny.POLICY, arch.temperature)
    weights = inputs.make_weights(arch, 7, "cpu")
    policy.load_state_dict(weights)
    g = torch.Generator().manual_seed(0)
    b, t = 3, 8
    frames = torch.randint(0, 256, (2, b, t, 32, 32, 3), generator=g, dtype=torch.uint8)
    first = torch.rand((2, b, t), generator=g) < 0.2
    state = policy_initial_state(cfg, b)
    ref_state = ref_model.initial_state(arch, b)
    with torch.no_grad():
        for c in range(2):
            out, state = policy(frames[c], first[c], state)
            ref, ref_state = ref_model.forward(weights, arch, frames[c], first[c], ref_state)
            for k in ("buttons", "camera"):
                torch.testing.assert_close(out["pi_logits"][k], ref[k], atol=TOL, rtol=0)
            torch.testing.assert_close(out["vpred"][..., 0], ref["vpred"], atol=TOL, rtol=0)


def test_agent_ring_steps_match_the_reference_chunks():
    """The served path (device resize, ring cache at t=1, resets) against
    the reference's chunked forward over the same frames."""
    from vpt_tpu_torch.agent.agent import MineRLAgent

    arch = _arch("serve")
    weights = inputs.make_weights(arch, 11, "cpu")
    agent = MineRLAgent(device="cpu", policy_kwargs=tiny.POLICY, batch_size=2, resize_on_device=True)
    agent.policy.load_state_dict(weights)
    got = []
    agent.policy.register_forward_hook(lambda m, a, o: got.append(o[0]["pi_logits"]["buttons"][:, -1, 0].clone()))
    r = np.random.default_rng(0)
    frames = r.integers(0, 256, (12, 2, 36, 64, 3), dtype=np.uint8)
    first = np.zeros((12, 2), bool)
    first[0] = True
    first[5, 1] = True
    for s in range(12):
        agent.get_action([{"pov": frames[s, i]} for i in range(2)], first=first[s])
    x = torch.as_tensor(frames).permute(1, 0, 2, 3, 4).flatten(0, 1).permute(0, 3, 1, 2).float()
    x = torch.nn.functional.interpolate(x, size=arch.img, mode="bilinear", align_corners=False)
    x = x.permute(0, 2, 3, 1).reshape(2, 12, *arch.img, 3)
    with torch.no_grad():
        ref, _ = ref_model.forward(weights, arch, x, torch.as_tensor(first.T), ref_model.initial_state(arch, 2))
    torch.testing.assert_close(torch.stack(got, 1), ref["buttons"][:, :, 0], atol=TOL, rtol=0)


def test_bc_step_matches_the_port():
    from vpt_tpu_torch.training.bc import BCHyperparams, BCTrainer

    spec = tiny.spec("bc")
    arch = ref_model.arch_from_config(spec["config"])
    hp = spec["traffic"]["hp"]
    trainer = BCTrainer(tiny.POLICY, spec["config"]["pi_head_kwargs"], hp=BCHyperparams(**hp), device="cpu")
    trainer.init()
    weights = inputs.make_weights(arch, 3, "cpu")
    trainer.policy.load_state_dict(weights)
    g = torch.Generator().manual_seed(1)
    batch = {"frames": torch.randint(0, 256, (2, 8, 32, 32, 3), generator=g, dtype=torch.uint8),
             "buttons": torch.randint(0, 8641, (2, 8), generator=g), "camera": torch.randint(0, 121, (2, 8), generator=g),
             "firsts": torch.rand((2, 8), generator=g) < 0.2, "mask": torch.rand((2, 8), generator=g) < 0.8}
    _, loss, _ = trainer.train_step(batch, trainer.initial_state(2))
    params = {k: v.clone() for k, v in weights.items()}
    ref_loss, grads, _ = ref_train.loss_and_grads(params, arch, batch, ref_model.initial_state(arch, 2), 1)
    ref_train.Adam(hp).step(params, grads)
    assert abs(float(loss) - ref_loss) < 1e-5 * abs(ref_loss)
    for name, p in trainer.policy.named_parameters():
        torch.testing.assert_close(p.detach(), params[name], atol=1e-6, rtol=0)


def test_idm_window_matches_the_port():
    from vpt_tpu_torch.agent.idm import IDMAgent

    arch = _arch("label")
    weights = inputs.make_weights(arch, 5, "cpu")
    agent = IDMAgent(tiny.IDM, {}, device="cpu")
    agent.policy.load_state_dict(weights)
    frames = torch.randint(0, 256, (2, 16, 32, 32, 3), generator=torch.Generator().manual_seed(2), dtype=torch.uint8)
    first = torch.zeros((2, 16), dtype=torch.bool)
    from vpt_tpu_torch.models.policy import policy_initial_state

    with torch.no_grad():
        out, _ = agent.policy(frames, first, policy_initial_state(agent.cfg, 2))
        ref, _ = ref_model.forward(weights, arch, frames, first, ref_model.initial_state(arch, 2))
    for k in ("buttons", "camera"):
        torch.testing.assert_close(out["pi_logits"][k], ref[k], atol=TOL, rtol=0)


def test_action_decode_matches_the_port():
    from vpt_tpu_torch.actions import ActionTransformer, CameraHierarchicalMapping
    from vpt_tpu_torch.config import ACTION_TRANSFORMER_KWARGS

    mapper, at = CameraHierarchicalMapping(n_camera_bins=11), ActionTransformer(**ACTION_TRANSFORMER_KWARGS)
    buttons = np.arange(8641)
    camera = np.arange(8641) % 121
    port = at.policy2env(mapper.to_factored({"buttons": buttons[:, None], "camera": camera[:, None]}))
    ref = ref_actions.decode_joint(buttons, camera)
    for name in ref_actions.BUTTONS:
        np.testing.assert_array_equal(port[name], ref[name])
    np.testing.assert_allclose(port["camera"], ref["camera"], atol=1e-12)
    np.testing.assert_array_equal(ref_actions.camera_bins(ref["camera"]), mapper.to_factored(
        {"buttons": buttons[:, None], "camera": camera[:, None]})["camera"])


def test_label_ownership_matches_the_labeler():
    """Which window labels each frame: the reference's rule against the
    labeler's, on a stand-in agent whose labels name their window."""
    from vpt_tpu_torch.agent.idm import StreamingIDMLabeler

    from portbench.drivers import label

    W, S, V = 16, 8, 60

    class Agent:
        cfg = type("Cfg", (), {"img_shape": (4, 4, 3), "timesteps": W})()

        def dispatch_actions_batched(self, windows):
            start = windows[:, :1, 0, 0, 0].astype(np.int64)  # each frame's pixels hold its index
            return np.broadcast_to(start, windows.shape[:2]), None

        def predict_actions_batched(self, windows):
            return self.collect_actions(self.dispatch_actions_batched(windows))

        def collect_actions(self, handle):
            return {"start": handle[0]}

    labeler = StreamingIDMLabeler(Agent(), window=W, stride=S, window_batch=2)
    emitted = {}
    for f in range(V):
        emitted.update(dict(labeler.feed_resized(np.full((4, 4, 3), f, np.uint8))))
    emitted.update(dict(labeler.finish()))
    assert sorted(emitted) == list(range(V))
    assert {i: int(a["start"]) for i, a in emitted.items()} == {i: label.owner(i, V, W, S) for i in range(V)}
