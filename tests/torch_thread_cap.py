"""Thread caps for the port's tests under pytest-xdist.

Imported at the top of every ``tests/test_torch_*.py``, so each xdist
worker runs it while it collects, before its first test.  Under ``-n N``
each worker would otherwise start two pools of one thread a core: torch's
intra-op pool, and the OpenBLAS pool that numpy and the JAX package's CPU
linear algebra use.  N workers then run 2·N·cores threads on the cores,
and the pools spin against each other.  numpy and scipy are loaded first,
so the cap reaches both OpenBLAS copies (jaxlib's CPU eigh and SVD call
scipy's LAPACK).  Each worker here gets
``cores // N`` threads (at least one) in both pools.  A run in one process
(no ``PYTEST_XDIST_WORKER``) keeps every core.
"""

from __future__ import annotations

import os

import numpy  # noqa: F401  (loads numpy's OpenBLAS)
import scipy.linalg  # noqa: F401  (loads scipy's, whose LAPACK jaxlib calls)
import torch
from threadpoolctl import threadpool_limits


def worker_threads():
    """Threads a worker may use, or None outside an xdist worker."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return None
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    return max(1, (os.cpu_count() or 1) // max(workers, 1))


THREADS = worker_threads()
if THREADS is not None:
    torch.set_num_threads(THREADS)
    # kept for the process's life: the limiter restores the old limits
    # only when it is used as a context manager and exited
    _BLAS_LIMITS = threadpool_limits(limits=THREADS, user_api="blas")
