"""Tiered, bigger-than-device-memory embedding storage.

* ``storage.tiered``: ``TieredSource``, the frequency-tiered composition
  (hot fp / warm int8 / cold int4 or host) behind the ordinary
  ``lookup_bags`` entry point, planned by ``SourceSpec(tiers=TierPolicy(
  ...))`` and kept current by the online trainer's ``migrate``.
* ``storage.host_store``: ``HostStore``/``HostTier``, the host-resident
  cold tier: rows that never enter device memory, staged on demand (and
  prefetched ahead) through a bounded staging arena.

Hot rows equal the fp arena bit for bit, warm and cold rows lie within
their per-row quantization bounds, host-staged rows are exact fp32
copies, and every tier redirect reads a zero null slot (no masks).
"""
from repro_torch.storage.host_store import HostStore, HostTier
from repro_torch.storage.tiered import (Int4Arena, TieredSource, TierPolicy,
                                        build_tiered, host_stores_of,
                                        migrate, refresh_host_tiers,
                                        tier_bytes)

__all__ = [
    "HostStore", "HostTier", "Int4Arena", "TierPolicy", "TieredSource",
    "build_tiered", "host_stores_of", "migrate", "refresh_host_tiers",
    "tier_bytes",
]
