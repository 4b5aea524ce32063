"""The last of vpt_tpu's API the port lacked, against vpt_tpu on the CPU:

  * ``tools/profile_ops.py``'s geometry flags against ``tools/profile_hlo.py``'s
    argparse (each flag's default, type and parsed value), and the steps
    they build (the policy width, batch, chunk, remat rule, streams,
    windows and compute dtype), without running them;
  * ``ScaledMSEHead``'s ``normalize``, ``loss`` and ``updated_stats`` (with
    ``beta`` and ``per_element_update``) against vpt_tpu's on the same
    statistics, rtol 1e-6 (float32, the same arithmetic).

``trajectory_steps(apply_version_scalers=)`` is held in
tests/test_torch_data.py (it decodes video: libav).
"""

import torch_cpu  # noqa: F401  (first: torch at this worker's share of the cores)

import argparse
import importlib.util
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt_tpu.models import heads as jax_heads
from vpt_tpu_torch.models import heads
from vpt_tpu_torch.tools import profile_ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY = ("width", "batch", "chunk", "streams", "window_batch", "compute_dtype")
STATS = {"running_mean": [0.3, -1.2], "running_mean_sq": [2.0, 3.5], "debiasing_term": 0.9}


class _Parsed(Exception):
    pass


def _profile_hlo_parser() -> argparse.ArgumentParser:
    """profile_hlo.py's parser, caught as its ``main`` parses (nothing of
    the profile runs)."""
    spec = importlib.util.spec_from_file_location("_profile_hlo", os.path.join(REPO, "tools", "profile_hlo.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)

    def catch(parser, args=None, namespace=None):
        raise _Parsed(parser)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", catch), mock.patch.object(sys, "argv", ["x"]):
        with pytest.raises(_Parsed) as caught:
            module.main()
    return caught.value.args[0]


@pytest.fixture(scope="module")
def parsers():
    return _profile_hlo_parser(), profile_ops.parser()


@pytest.mark.parametrize("dest", GEOMETRY)
def test_profile_ops_flag_has_profile_hlos_default_and_type(parsers, dest):
    theirs, ours = ({a.dest: a for a in p._actions} for p in parsers)
    assert ours[dest].option_strings == theirs[dest].option_strings
    assert ours[dest].default == theirs[dest].default
    assert ours[dest].type == theirs[dest].type
    assert "pool_impl" in theirs and "pool_impl" not in ours  # TPU-only


@pytest.mark.parametrize("argv", [[], ["--width", "3", "--batch", "2", "--chunk", "64", "--compute-dtype", "float32"],
                                  ["--streams", "16", "--window-batch", "2"]])
def test_profile_ops_parses_as_profile_hlo(parsers, argv):
    theirs, ours = parsers
    a = argparse.ArgumentParser.parse_args(theirs, argv)
    b = argparse.ArgumentParser.parse_args(ours, ["--step", "bc"] + argv)
    assert {k: getattr(a, k) for k in GEOMETRY} == {k: getattr(b, k) for k in GEOMETRY}


@pytest.mark.parametrize("argv,builder,expect", [
    (["--step", "bc"], "make_bc_step", (1, 8, 32, "bfloat16")),
    (["--step", "bc", "--width", "2", "--batch", "4", "--chunk", "128", "--compute-dtype", "float32"],
     "make_bc_step", (2, 4, 128, "float32")),
    (["--step", "rollout"], "make_rollout_step", (2, 64, "bfloat16")),
    (["--step", "rollout", "--width", "1", "--streams", "8"], "make_rollout_step", (1, 8, "bfloat16")),
    (["--step", "idm", "--window-batch", "2"], "make_idm_label_step", (2,)),
    (["--step", "ppo", "--streams", "16", "--compute-dtype", "float32"], "make_ppo_step", (2, 16, "float32")),
])
def test_profile_ops_steps_take_the_flags_geometry(argv, builder, expect):
    """Each step is built from the flags (profile_hlo.py's width defaults:
    1 for bc, 2 for rollout), not at fixed shapes."""
    calls = []
    with mock.patch.object(profile_ops, builder, lambda dev, *a, **k: calls.append((a, k))):
        profile_ops.make_step(profile_ops.parser().parse_args(argv), torch.device("cpu"))
    (args, kwargs), = calls
    if builder == "make_idm_label_step":
        assert args == expect and kwargs == {"compute_dtype": "bfloat16"}
    else:
        assert args == expect and not kwargs


@pytest.mark.parametrize("width,batch,chunk,remat", [(1, 8, 32, False), (2, 4, 128, False), (1, 8, 256, True)])
def test_bc_step_takes_remat_where_profile_hlo_does(width, batch, chunk, remat):
    """Remat and 8 CNN chunks where batch·chunk·width passes 1024, as
    profile_hlo.py's bc step; the policy at hidsize 1024·width."""
    made = []
    from vpt_tpu_torch.training import bc

    class Stub:
        def __init__(self, policy_kwargs, pi_head_kwargs, hp, compute_dtype, remat, cnn_scan_chunks, seed, device):
            made.append((policy_kwargs["hidsize"], policy_kwargs["impala_width"], hp.batch_size, hp.chunk_len,
                         compute_dtype, remat, cnn_scan_chunks))

        def initial_state(self, b):
            return None

    with mock.patch.object(bc, "BCTrainer", Stub), mock.patch.object(profile_ops, "_bc_batch", lambda *a: None):
        profile_ops.make_bc_step(torch.device("cpu"), width, batch, chunk, "bfloat16")
    assert made == [(1024 * width, 4 * width, batch, chunk, "bfloat16", remat, 8 if remat else 0)]

# ------------------------------------------------------------------ ScaledMSEHead


def _heads(beta, per_element_update):
    x = np.random.default_rng(6).normal(size=(2, 3, 16)).astype(np.float32)
    ref = jax_heads.ScaledMSEHead(output_size=2, norm_axes=2, beta=beta, per_element_update=per_element_update)
    variables = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = {"params": variables["params"], "stats": {k: jnp.asarray(v, jnp.float32) for k, v in STATS.items()}}
    port = heads.ScaledMSEHead(16, output_size=2, norm_axes=2, beta=beta, per_element_update=per_element_update)
    with torch.no_grad():
        for k, v in STATS.items():
            getattr(port.normalizer, k).copy_(torch.tensor(v))
    return ref, variables, port


def _close(got, expect):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(got, torch.Tensor) else got),
                               np.asarray(expect), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("beta,per_element_update", [(0.99999, False), (0.9, False), (0.99, True)])
def test_scaled_mse_head_methods_equal_vpt_tpu(beta, per_element_update):
    ref, variables, port = _heads(beta, per_element_update)
    assert (port.beta, port.per_element_update, port.epsilon) == (ref.beta, ref.per_element_update, ref.epsilon)
    rng = np.random.default_rng(7)
    target = rng.normal(3.0, 2.0, size=(2, 3, 2)).astype(np.float32)
    pred = rng.normal(size=(2, 3, 2)).astype(np.float32)
    _close(port.normalize(torch.from_numpy(target)), ref.apply(variables, jnp.asarray(target), method="normalize"))
    _close(port.loss(torch.from_numpy(pred), torch.from_numpy(target)),
           ref.apply(variables, jnp.asarray(pred), jnp.asarray(target), method="loss"))
    ours = port.updated_stats(torch.from_numpy(target))
    theirs = ref.apply(variables, jnp.asarray(target), method="updated_stats")
    for a, b in zip(ours, theirs):
        _close(a, b)
    # the head's own statistics are left as they were
    assert torch.equal(port.normalizer.running_mean, torch.tensor(STATS["running_mean"]))
