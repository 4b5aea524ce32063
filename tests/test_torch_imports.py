"""The PyTorch port stands alone: importing every vpt_tpu_torch module loads
neither JAX nor the JAX package, and the entry points refuse to run without
CUDA unless the caller asks for the CPU.  Run in fresh interpreters, since
this test process has both packages loaded."""

import os
import pkgutil
import subprocess
import sys

import vpt_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, **env):
    full_env = dict(os.environ, PYTHONPATH=REPO, **env)
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=full_env, cwd=REPO, timeout=300)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(vpt_tpu_torch.__path__, "vpt_tpu_torch."))


def test_every_module_imports_without_jax_or_vpt_tpu():
    names = _modules()
    assert "vpt_tpu_torch.ops.windowed_attention" in names and "vpt_tpu_torch.agent.agent" in names
    assert "vpt_tpu_torch.agent.idm" in names and "vpt_tpu_torch.training.idm" in names
    assert "vpt_tpu_torch.run_inverse_dynamics_model" in names and "vpt_tpu_torch.inverse_dynamics_train" in names
    assert {"vpt_tpu_torch.training.rl", "vpt_tpu_torch.agent.rollout", "vpt_tpu_torch.agent.evaluation",
            "vpt_tpu_torch.data.annotate", "vpt_tpu_torch.rl_fine_tune"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}: importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'flax'"
        " or m == 'vpt_tpu' or m.startswith('vpt_tpu.'))\n"
        "print(bad)\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_default_device_raises_without_cuda():
    code = (
        "from vpt_tpu_torch.agent import IDMAgent, MineRLAgent\n"
        "from vpt_tpu_torch.device import resolve_device\n"
        "from vpt_tpu_torch.training.idm import IDMTrainer\n"
        "from vpt_tpu_torch.training.rl import PPOTrainer\n"
        "kw = {'hidsize': 8, 'timesteps': 128, 'attention_mask_style': 'none'}\n"
        "for make in (lambda: MineRLAgent(policy_kwargs={'hidsize': 8}), lambda: resolve_device(None),\n"
        "             lambda: IDMAgent(kw, {}), lambda: IDMTrainer(kw, {}), lambda: PPOTrainer({'hidsize': 8}, {})):\n"
        "    try:\n"
        "        make()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device is available' in str(e), e\n"
        "    else:\n"
        "        raise SystemExit('no error without CUDA')\n"
        "print('raised')\n"
    )
    res = _run(code, CUDA_VISIBLE_DEVICES="")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "raised"
