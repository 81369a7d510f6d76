"""Continuous queries: the geofence and alert push tier.

Counterpart of ``geomesa_tpu/pubsub/`` (ref role: the geomesa-kafka
``FeatureListener``, standing queries over the live tier): "alert me when
anything enters this bbox / corridor / proximity", evaluated against the
streaming append traffic of the live layer (``store/stream.py``).

- ``registry``: the subscription registry (bbox / attribute-filter /
  dwithin predicates per type), persisted in its own WAL under the store
  root and shipped as the ``_pubsub`` pseudo-type on ``GET /wal/<type>``.
- ``matcher``: subscription envelopes are XZ-encoded once per registry
  generation into a join layout on the store's device; every acked append
  batch then matches against all subscriptions as one fused batch x
  subscriptions spatial join, with exact attribute / dwithin residuals and
  fail-closed visibility refining the pairs on the host.
- ``delivery``: long-lived chunked SSE (GeoJSON) and BIN push streams.
  Every delivery cursor rides the data WAL's seq: a reconnecting
  subscriber resumes exactly once from its acked watermark, records below
  it replayed from the WAL through the same fused matcher.
"""

from geomesa_tpu_torch.pubsub.delivery import CursorGoneError, PubSubHub
from geomesa_tpu_torch.pubsub.matcher import SubscriptionMatcher
from geomesa_tpu_torch.pubsub.registry import (
    REGISTRY_SHIP_NAME,
    Subscription,
    SubscriptionRegistry,
)

__all__ = [
    "CursorGoneError",
    "PubSubHub",
    "REGISTRY_SHIP_NAME",
    "Subscription",
    "SubscriptionMatcher",
    "SubscriptionRegistry",
]
