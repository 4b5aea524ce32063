"""The rules of ``tests/torch_cpu.py``, which every port test file imports
first: torch at this worker's share of the cores, passed on to the
processes a test starts, and vpt_tpu's native video library loaded again
after a load error that a parallel build left cached."""

import torch_cpu

import os
import subprocess
import sys
import time

import pytest
import torch


def test_torch_runs_at_the_workers_share_of_the_cores():
    share = max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    assert torch_cpu.THREADS == share
    assert torch.get_num_threads() == share
    omp = torch_cpu.OMP_NUM_THREADS_SET_BEFORE or str(share)
    assert os.environ["OMP_NUM_THREADS"] == omp
    child = subprocess.run([sys.executable, "-c", "import os; print(os.environ.get('OMP_NUM_THREADS'))"],
                           capture_output=True, text=True, check=True)
    assert child.stdout.strip() == omp


def test_a_cached_load_error_is_cleared_and_a_failed_build_is_not_retried(monkeypatch):
    from vpt_tpu.data import video as jax_video
    from vpt_tpu_torch.data import video

    try:
        video.build()
    except RuntimeError as e:
        pytest.skip(f"no native video library can be built here (libav): {e}")
    lib = torch_cpu.jax_native_video()
    assert lib is not None, f"vpt_tpu's native video library does not load here: {jax_video._lib_error}"
    # another worker's linker was still writing the library when this process first loaded it
    monkeypatch.setattr(jax_video, "_lib", None)
    monkeypatch.setattr(jax_video, "_lib_error", f"{jax_video._LIB_PATH}: file too short")
    lib = torch_cpu.jax_native_video(wait_s=0.0)
    assert lib is not None and jax_video._lib is lib and jax_video._lib_error is None
    assert jax_video.native_available()
    # no libav: the build itself failed, which waiting does not mend
    error = "could not build native library: make exited with 2"
    monkeypatch.setattr(jax_video, "_lib", None)
    monkeypatch.setattr(jax_video, "_lib_error", error)
    start = time.perf_counter()
    assert torch_cpu.jax_native_video(wait_s=30.0) is None
    assert time.perf_counter() - start < 30.0 and jax_video._lib_error == error
