"""Store maintenance, the port's copy of the parts of the JAX package's
maintenance/ that live updates need:

  * ``compact`` folds the generation chain and the base into a fresh
    compacted base (dead rows dropped, ids kept, byte-deterministic),
    swapped in with one atomic manifest dump; ``compaction_due`` is the
    JAX maintenance service's trigger;
  * ``lease`` keeps concurrent appends from assigning the same ids.

Rolling model migrations (``migrate``) and the background
``MaintenanceService`` are later slices (ROADMAP.md queue 1, items 5 and
7).
"""
from dnn_page_vectors_tpu_torch.maintenance.compact import (
    compact_store, compaction_due, purge_stale)
from dnn_page_vectors_tpu_torch.maintenance.lease import (
    AppendLease, LeaseHeld, LeaseLost, expire_stale_lease)

__all__ = [
    "AppendLease", "LeaseHeld", "LeaseLost", "compact_store",
    "compaction_due", "expire_stale_lease", "purge_stale",
]
