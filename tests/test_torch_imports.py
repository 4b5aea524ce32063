"""The PyTorch port stands alone: importing every vpt_tpu_torch module loads
neither JAX nor the JAX package, no file of the port or chip_smoke.py names
a path inside the JAX package (its own C++ sources included), and the entry
points refuse to run without CUDA unless the caller asks for the CPU.  The
imports run in fresh interpreters, since this test process has both
packages loaded."""

import ast
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

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
    assert {"vpt_tpu_torch.ops.host_resize", "vpt_tpu_torch.utils.profiling",
            "vpt_tpu_torch.tools.profile_ops"} <= set(names)
    assert {"vpt_tpu_torch.ops.int8", "vpt_tpu_torch.checkpoint.native",
            "vpt_tpu_torch.checkpoint.averaging"} <= set(names)
    assert {"vpt_tpu_torch.ops.strided_attention", "vpt_tpu_torch.utils.minecraft"} <= set(names)
    assert {"vpt_tpu_torch.parallel.mesh", "vpt_tpu_torch.parallel.fsdp", "vpt_tpu_torch.parallel.tp",
            "vpt_tpu_torch.parallel.pp", "vpt_tpu_torch.parallel.model", "vpt_tpu_torch.training.pp_bc"} <= set(names)
    assert {"vpt_tpu_torch.run_agent"} | {f"vpt_tpu_torch.tools.{t}" for t in ENTRY_TOOLS} <= set(names)
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


# the port's counterparts of the root tools/ (profile_ops is profile_hlo's)
ENTRY_TOOLS = ("label_videos", "eval_loss", "eval_agent", "average_weights", "record_demonstrations",
               "download_dataset", "bench_breakdown", "bench_bc_breakdown", "bench_dataplane", "profile_ops")
# modules of the repo's root that are the JAX package's: its tools and the reference harness
_ROOT_MODULES = {"tools", "bench_torch_reference", "bench_torch_ref", "bench", "run_agent",
                 "run_inverse_dynamics_model", "behavioural_cloning", "inverse_dynamics_train", "rl_fine_tune"}
# a string naming a file of the root tools/ or the reference harness (the port's own tools are
# vpt_tpu_torch/tools/)
_ROOT_PATH = re.compile(r"(^|[^\w/])tools[/\\]\w+\.py|(^|[/\\])tools$|bench_torch_ref")


def _root_references(path: Path):
    """Imports of the root's JAX modules, and string constants (docstrings
    aside) that name a file of tools/ or the reference harness."""
    tree = ast.parse(path.read_text())
    docs = {id(node) for node in _docstrings(tree)}
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            hits += [a.name for a in node.names if a.name.split(".")[0] in _ROOT_MODULES]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if node.module.split(".")[0] in _ROOT_MODULES:
                hits.append(node.module)
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs
              and _ROOT_PATH.search(node.value)):
            hits.append(node.value)
    return hits


def test_no_file_of_the_port_imports_or_opens_the_root_tools():
    root = Path(REPO)
    files = sorted((root / "vpt_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert {p.name for p in (root / "vpt_tpu_torch" / "tools").glob("*.py")} >= {f"{t}.py" for t in ENTRY_TOOLS}
    found = {str(p.relative_to(root)): hits for p in files if (hits := _root_references(p))}
    assert found == {}, found
    # the check finds what it looks for
    probe = root / "tests" / "_probe_root_refs.py"
    try:
        probe.write_text('import tools.eval_loss\nfrom bench_torch_reference import install_reference\n'
                         'import run_agent\nPATH = os.path.join(REPO, "tools/label_videos.py")\n'
                         'OK = "vpt_tpu_torch/tools/label_videos.py"\n')
        assert _root_references(probe) == ["tools.eval_loss", "bench_torch_reference", "run_agent",
                                           "tools/label_videos.py"]
    finally:
        probe.unlink()


# a path component naming the JAX package's directory: "vpt_tpu" alone, or
# followed or preceded by a path separator
_JAX_PATH = re.compile(r"(^|[/\\])vpt_tpu($|[/\\])")
# a "file:line" label of a TPU kernel (chip_smoke.py's "replaces" entries) names code, it opens nothing
_KERNEL_LABEL = re.compile(r"^vpt_tpu/[\w/]+\.py:\d+$")


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                yield body[0].value


def _jax_paths_in_python(path: Path):
    """String constants of a Python file, docstrings and comments aside,
    that name a path inside vpt_tpu/."""
    tree = ast.parse(path.read_text())
    docs = {id(node) for node in _docstrings(tree)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs
            and _JAX_PATH.search(node.value) and not _KERNEL_LABEL.match(node.value)]


def _jax_paths_in_source(path: Path):
    """#include lines of a C++/CUDA source that name a file inside vpt_tpu/."""
    return [line for line in path.read_text().splitlines()
            if line.lstrip().startswith("#include") and _JAX_PATH.search(line.split("include", 1)[1].strip(' "<>'))]


def test_no_file_of_the_port_names_a_path_inside_vpt_tpu():
    root = Path(REPO)
    files = sorted((root / "vpt_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    sources = [p for ext in ("*.cu", "*.cuh", "*.cpp", "*.h") for p in (root / "vpt_tpu_torch").rglob(ext)]
    assert len(files) > 40 and {p.name for p in sources} >= {"vpt_host.cpp", "host_resize.cpp"}
    found = {str(p.relative_to(root)): hits for p in files if (hits := _jax_paths_in_python(p))}
    found.update({str(p.relative_to(root)): hits for p in sources if (hits := _jax_paths_in_source(p))})
    assert found == {}, found
    # the check finds what it looks for: the path the video binding once built from
    probe = root / "vpt_tpu_torch" / "data" / "video.py"
    assert _jax_paths_in_python(probe) == []
    bad = ast.parse('SOURCE = PACKAGE.parent / "vpt_tpu" / "native" / "vpt_host.cpp"\n"""doc: vpt_tpu/x.py"""')
    assert [n.value for n in ast.walk(bad) if isinstance(n, ast.Constant) and _JAX_PATH.search(n.value)
            and id(n) not in {id(d) for d in _docstrings(bad)}] == ["vpt_tpu"]
