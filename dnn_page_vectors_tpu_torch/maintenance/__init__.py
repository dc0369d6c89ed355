"""Store maintenance, the port's copy of the JAX package's maintenance/:

  * ``compact`` folds the generation chain and the base into a fresh
    compacted base (dead rows dropped, ids kept, byte-deterministic),
    swapped in with one atomic manifest dump; ``compaction_due`` is the
    maintenance service's trigger;
  * ``lease`` keeps concurrent appends from assigning the same ids;
  * ``migrate`` re-embeds a live store to a new model step unit by unit
    (``MigrationPlan``, ``migrate_store``);
  * ``service`` runs compaction, off-path index rebuilds, the janitor, the
    migrator and the autoscaler in the background
    (``MaintenanceService``).
"""
from dnn_page_vectors_tpu_torch.maintenance.compact import (
    compact_store, compaction_due, purge_stale)
from dnn_page_vectors_tpu_torch.maintenance.lease import (
    AppendLease, LeaseHeld, LeaseLost, expire_stale_lease)
from dnn_page_vectors_tpu_torch.maintenance.migrate import (
    MigrationPlan, migrate_store)
from dnn_page_vectors_tpu_torch.maintenance.service import MaintenanceService

__all__ = [
    "AppendLease", "LeaseHeld", "LeaseLost", "MaintenanceService",
    "MigrationPlan", "compact_store", "compaction_due", "expire_stale_lease",
    "migrate_store", "purge_stale",
]
