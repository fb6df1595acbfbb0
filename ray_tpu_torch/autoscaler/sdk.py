"""Programmatic autoscaler commands (reference:
python/ray/autoscaler/sdk/sdk.py).

``request_resources`` is the load-independent scaling command: the
reconciler scales up to accommodate the requested bundles and holds
that capacity even while idle, until a later call overrides the
request. The cluster-lifecycle commands (up/down) live in
``autoscaler.launcher``.
"""

from __future__ import annotations


def request_resources(num_cpus: int | None = None,
                      bundles: list[dict] | None = None) -> None:
    """(reference: ray.autoscaler.sdk.request_resources)
    ``num_cpus=N`` is shorthand for N one-CPU bundles; ``bundles`` is
    an explicit list of resource dicts. Each call REPLACES the
    previous request; ``request_resources(bundles=[])`` clears it."""
    if num_cpus is None and bundles is None:
        raise ValueError("pass num_cpus and/or bundles")
    req: list[dict] = []
    if num_cpus:
        req.extend({"CPU": 1.0} for _ in range(int(num_cpus)))
    for b in bundles or []:
        if not isinstance(b, dict) or not b:
            raise ValueError(f"bundles must be non-empty dicts; "
                             f"got {b!r}")
        req.append(dict(b))
    from ray_tpu_torch.core.api import get_runtime
    get_runtime().request_resources(req)
