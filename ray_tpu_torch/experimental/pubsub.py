"""General pub/sub over the head (counterpart of
``ray_tpu/experimental/pubsub.py``; reference: src/ray/pubsub/ —
long-poll publisher/subscriber channels; GcsPublisher/GcsSubscriber).

Model mirrors the reference's long-poll design: the head keeps a
bounded per-topic ring of (seq, payload); subscribers long-poll with
their cursor and receive everything newer (or block until something
arrives). Works identically for drivers, workers, and remote clients
because it rides the ordinary client channel, which node daemons' workers
and remote clients (``init(address=...)``) also speak.

    from ray_tpu_torch.experimental import pubsub
    pubsub.publish("events", {"k": 1})
    sub = pubsub.subscribe("events")
    for msg in sub.poll(timeout=5):
        ...
"""

from __future__ import annotations

from typing import Any


def publish(topic: str, message: Any) -> int:
    """Publish one message; returns its sequence number."""
    from ray_tpu_torch.core import serialization as ser
    from ray_tpu_torch.core.api import get_runtime

    return get_runtime().pubsub_publish(str(topic),
                                        ser.dumps(message))


class Subscriber:
    """Cursor-tracking subscriber. ``poll`` yields every message
    published after the previous poll (long-polling up to timeout
    when none are pending)."""

    def __init__(self, topic: str, from_latest: bool = True):
        from ray_tpu_torch.core.api import get_runtime

        self._topic = str(topic)
        self._rt = get_runtime()
        self._epoch, seq = self._rt.pubsub_cursor(self._topic)
        self._cursor = seq if from_latest else 0
        #: discontinuity indicator for the last poll: 0 = contiguous,
        #: >0 = that many messages evicted unseen, -1 = epoch changed
        #: (head restart / topic reaped) — unknown loss, possible
        #: duplicates. Cumulative counted losses in dropped_total.
        self.last_dropped = 0
        self.dropped_total = 0

    def poll(self, timeout: float | None = 1.0,
             max_messages: int = 256) -> list[Any]:
        """EAGER list of new messages (a lazy generator would drop
        the rest of a batch when the caller breaks mid-iteration —
        the cursor covers the whole delivery). One poll round waits
        at most ~60 s server-side even with timeout=None; loop to
        wait indefinitely.

        After each poll, ``last_dropped`` says whether the stream is
        contiguous: >0 = that many messages evicted unseen (slow
        subscriber fell > ring-size behind), -1 = epoch changed under
        us (unknown loss, possible re-delivery). Any nonzero value
        means stateful consumers should resync."""
        from ray_tpu_torch.core import serialization as ser

        self._epoch, self._cursor, blobs, dropped = \
            self._rt.pubsub_poll(
                self._topic, self._epoch, self._cursor, timeout,
                max_messages)
        self.last_dropped = int(dropped)
        if self.last_dropped > 0:
            self.dropped_total += self.last_dropped
        return [ser.loads(b) for b in blobs]


def subscribe(topic: str, from_latest: bool = True) -> Subscriber:
    return Subscriber(topic, from_latest=from_latest)
