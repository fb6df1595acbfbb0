"""joblib backend over ray_tpu_torch (counterpart of
``ray_tpu/util/joblib.py``; reference: python/ray/util/joblib/ —
``register_ray()`` + ``parallel_backend("ray")`` runs scikit-learn's
joblib-parallel loops on the cluster instead of local processes).
joblib is imported only when the backend is registered or used."""

from __future__ import annotations


def register_ray() -> None:
    """Register the 'ray' joblib parallel backend."""
    from joblib import register_parallel_backend

    register_parallel_backend("ray", _RayTpuBackend)


def _make_backend():
    from joblib._parallel_backends import MultiprocessingBackend

    class RayTpuBackend(MultiprocessingBackend):
        """joblib backend whose pool is ray_tpu_torch actors: inherit the
        multiprocessing backend's batching/dispatch logic and swap
        the pool implementation (the reference does exactly this)."""

        supports_timeout = True

        def effective_n_jobs(self, n_jobs):
            import os
            if n_jobs == 0:
                raise ValueError("n_jobs == 0 has no meaning")
            if n_jobs is None:
                n_jobs = 1
            if n_jobs < 0:
                n_jobs = max(1, (os.cpu_count() or 1) + 1 + n_jobs)
            return n_jobs

        def configure(self, n_jobs=1, parallel=None, prefer=None,
                      require=None, **kwargs):
            n_jobs = self.effective_n_jobs(n_jobs)
            from ray_tpu_torch.util.multiprocessing import Pool
            self._pool = Pool(n_jobs)
            self.parallel = parallel
            return n_jobs

        def terminate(self):
            if getattr(self, "_pool", None) is not None:
                self._pool.terminate()
                self._pool = None

    return RayTpuBackend


class _LazyBackendMeta(type):
    def __call__(cls, *args, **kwargs):
        return _make_backend()(*args, **kwargs)


class _RayTpuBackend(metaclass=_LazyBackendMeta):
    """Constructed lazily so importing this module never pulls
    joblib internals unless the backend is actually used."""
