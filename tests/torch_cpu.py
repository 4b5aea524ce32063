"""What every port test file (``tests/test_torch_*.py``) imports first: torch
at this process's share of the CPU cores, and one way to reach vpt_tpu's
native video library.  pytest does not collect this module.

**Threads.**  Tier-1 runs the suite in pytest-xdist workers (``-n 6`` on an
8-core host).  At torch's default of one intra-op thread per core each
worker ran 8 OpenMP threads, 48 on 8 cores, and every small op of a
tiny-config test waited at a barrier for threads that were not scheduled.
On that host the port's files took 6,229 of the suite's 7,427
worker-seconds and the whole run 1,298 s of its 1,470 s limit;
``test_ppo_learns_synthetic_reward`` took 346.6 s in the suite and 5.6 s
alone on one thread, and C1's plain-path gradcheck 82–89 s against 0.4 s.
Eight port files (188 tests) under ``-n 6 --dist loadfile`` took 149.5 s
at the default threads and 74.0 s at this module's.

So on import this module sets ``torch.set_num_threads`` to the worker's
share, ``os.cpu_count() // PYTEST_XDIST_WORKER_COUNT`` and at least 1
(every core in a lone pytest process), and ``OMP_NUM_THREADS`` to the same
count where it is not set already, so that the processes a test starts
(CLI subprocesses, ``run_ranks``' ranks) inherit it.  The rule reads only
what the process can observe.  ``vpt_tpu_torch`` itself leaves torch's
threads alone.  A new port test file imports this module before its other
imports.

**vpt_tpu's native library.**  ``vpt_tpu`` builds ``libvpt_host.so`` with
``make`` in place at first use, and several JAX test modules load it while
they are imported, in every worker at once.  A worker may then load the
file while another worker's linker is still writing it ("file too short"),
and ``vpt_tpu`` caches that load error for the life of the process.
:func:`jax_native_video` clears such an error and loads again; every port
test that reaches ``vpt_tpu``'s video library calls it first.
"""

import os
import time

import torch

THREADS = max(1, os.cpu_count() // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
OMP_NUM_THREADS_SET_BEFORE = os.environ.get("OMP_NUM_THREADS")  # a user's own setting wins
torch.set_num_threads(THREADS)
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))


def jax_native_video(attempts=5, wait_s=2.0):
    """vpt_tpu's native video library (its ctypes handle), loaded again where
    a load of a built library failed earlier in this process; None where it
    is unavailable.  The build finishes within seconds, so a cached load
    error is cleared and the load tried again.  A failed build (no libav) is
    not retried, nor is any error where vpt_tpu no longer caches it under
    these names."""
    from vpt_tpu.data import video as jax_video

    for attempt in range(attempts):
        if jax_video.native_available():
            return jax_video._lib
        if attempt + 1 == attempts or not _cached_load_error(jax_video):
            return None
        time.sleep(wait_s)
        jax_video._lib = jax_video._lib_error = None
    return None


def _cached_load_error(jax_video):
    """Whether vpt_tpu cached an error of loading a library that was built."""
    error = getattr(jax_video, "_lib_error", None)
    return (hasattr(jax_video, "_lib") and isinstance(error, str)
            and not error.startswith("could not build native library"))
