"""Head (control-plane) state snapshot & recovery (counterpart of
``ray_tpu/util/ha.py``).

Reference analog (SURVEY.md §5.3 GCS failure/HA): with Redis
persistence the GCS journals its tables (actors, placement groups,
KV, jobs) and a restarted GCS replays them. The JAX package has two
tiers:

- **Live head restart**: the head as a standalone journaled process
  (``ray_tpu/core/head.py``), whose daemons reconnect and whose
  surviving actor incarnations are re-adopted: the port's
  ``core/head.py``, with its op log (``core/oplog.py``).

- **Manual snapshot/replay** (this module): explicit
  ``save_head_state(path)`` / ``restore_head_state(path)`` for
  in-driver runtimes — named actors are restarted fresh (identity and
  reachability survive; state does not, since the old incarnations
  died with the driver).
"""

from __future__ import annotations

import json


def _rt():
    from ray_tpu_torch.core.api import get_runtime
    return get_runtime()


def save_head_state(path: str) -> dict:
    """Snapshot KV + named-actor specs + PG specs to ``path``
    (atomic). Returns the counts written."""
    return _rt().save_snapshot(path)


def restore_head_state(path: str) -> dict:
    """Replay a head snapshot into the CURRENT runtime: KV entries
    restored verbatim, named actors recreated, PGs re-reserved.
    Actors whose name is already live are skipped (idempotent replay).
    With no node daemons around to adopt surviving incarnations, the
    zero-second grace restarts every restored actor fresh."""
    with open(path) as f:
        state = json.load(f)
    return _rt().restore_snapshot(state, adopt_grace_s=0.0)
