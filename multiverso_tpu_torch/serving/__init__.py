"""Online-serving plane for the sparse PS: read replicas and admission
(port of ``multiverso_tpu/serving``).

A recommender in production reads embedding rows for its users while
training keeps writing. Serving those reads from the owning shards
couples inference tail latency to the training write path; this package
decouples them with **read replicas** (bounded-staleness copies the hot
path reads instead) and **admission control** (budget the readers, never
the trainer):

* :mod:`multiverso_tpu_torch.serving.replica` — :class:`ReadReplica`, a
  bounded-staleness copy of one table refreshed through the
  ``MSG_SNAPSHOT`` subscription RPC, with a hot-row cache on the card
  seeded from the shards' Space-Saving sketch;
* :mod:`multiverso_tpu_torch.serving.pool` — ``ReplicaPool``, several
  replicas of one table behind least-staleness routing;
* :mod:`multiverso_tpu_torch.serving.admission` — per-(table, class)
  token-bucket QPS limits: training traffic is never shed by default,
  inference reads shed fast (``table[X].get.shed``).

The app over it is :mod:`multiverso_tpu_torch.apps.dlrm_serving`.
ps/service.py imports the replica module at module level (the serving
block of its stats), so nothing here imports the ps package at module
scope.
"""

from multiverso_tpu_torch.serving.admission import (AdmissionController,
                                                    SheddingError,
                                                    TokenBucket)
from multiverso_tpu_torch.serving.replica import ReadReplica, stats_snapshot

__all__ = ["AdmissionController", "SheddingError", "TokenBucket",
           "ReadReplica", "stats_snapshot"]
