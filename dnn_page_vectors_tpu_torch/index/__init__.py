"""The IVF/PQ index over the vector store: the port's copy of the JAX
package's index/ on one card.

`kmeans.py` trains the coarse quantizer (nlist unit-norm centroids) over
the store's shards streamed through the card, and the per-subspace
codebooks of PQ; `pq.py` is the OPQ+PQ codec (rotation, codebooks, the
ADC lookup tables and the running top-r of ADC scores); `ivf.py` keeps the
inverted file next to the store, in the JAX package's file layout, and
searches it: the top-nprobe lists' rows gathered at stored width and
re-ranked exactly, or, on a PQ index, their m-byte codes scored by ADC and
only the survivors re-ranked.
"""
from dnn_page_vectors_tpu_torch.index.ivf import (  # noqa: F401
    IndexUnavailable, IVFIndex)
from dnn_page_vectors_tpu_torch.index.kmeans import train_kmeans  # noqa: F401
from dnn_page_vectors_tpu_torch.index.pq import (  # noqa: F401
    PQCodec, auto_pq_m, train_pq)
