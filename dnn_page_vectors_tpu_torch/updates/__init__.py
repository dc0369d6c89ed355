"""Live corpus updates, the port's copy of the JAX package's updates/:

  * ``append_corpus`` embeds only the new id range (and any updated pages)
    into a new store generation, with tombstones masking the stale rows
    (infer/vector_store.py ``GenerationWriter``), under the append lease
    (maintenance/lease.py);
  * ``IVFIndex.update`` (index/ivf.py) assigns only the new generation's
    shards to the existing centroids until the drift asks for a full
    rebuild;
  * ``SearchService.refresh`` (infer/serve.py) swaps the new store view
    and index generation in under live traffic.
"""
from dnn_page_vectors_tpu_torch.updates.append import append_corpus

__all__ = ["append_corpus"]
