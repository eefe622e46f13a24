"""RowStore: where the full tables live.

Counterpart of ``repro/core/row_store.py``.  Only ``HostStore`` is ported:
the tables are whole tensors the engine hands to its backend.  Where they
sit is the placement's choice (``backend.prepare``): under the gather
placement in device memory, next to the model; under the cached placement
in host memory, as CPU tensors, with only the hot rows in the device cache
(``core.cache_tier``).  The paged SSD tier (``DiskStore``) comes with
ROADMAP queue A's SSD-tier item.
"""

from __future__ import annotations


class HostStore:
    """Resident tables (the default): a stateless placement tag."""

    kind = "host"

    def stats(self) -> dict:
        """Training-side meters of the store (none for resident tables)."""
        return {}

    def serve_stats(self) -> dict:
        """Serve-side meters of the store (none for resident tables)."""
        return {}


def make_store(store: str = "host"):
    """``store`` in {"host"} -> a RowStore instance ("disk" is not ported)."""
    if store == "host":
        return HostStore()
    if store == "disk":
        raise NotImplementedError(
            "store='disk' (DiskStore, the SSD tier) is not ported yet; see "
            "ROADMAP.md queue A, SSD tier")
    raise ValueError(f"unknown store {store!r}; use 'host' or 'disk'")
