"""Telemetry plane (port of ``multiverso_tpu/telemetry``): the per-process
pieces, each writing the JAX package's file formats with the same field
names, so either package's tools read the other's files.

* :mod:`~multiverso_tpu_torch.telemetry.histogram` — the log2-bucket
  histogram every Dashboard Monitor embeds.
* :mod:`~multiverso_tpu_torch.telemetry.trace` — per-request trace IDs
  carried in PS frame meta (``ps/wire.TRACE_META_KEY``) and
  ``trace_event`` spans on both endpoints (flag ``trace_ids``).
* :mod:`~multiverso_tpu_torch.telemetry.exporter` — the flag-gated
  thread writing ``metrics-rank<r>.jsonl`` and ``.prom``
  (``metrics_interval_s`` / ``metrics_dir``).
* :mod:`~multiverso_tpu_torch.telemetry.flightrec` — the always-on ring
  of wire events and the in-flight table, dumped as
  ``flightrec-rank<r>.jsonl`` at fault time.
* :mod:`~multiverso_tpu_torch.telemetry.watchdog` — slow/stuck verdicts
  over the in-flight table, served by ``MSG_HEALTH``.
* :mod:`~multiverso_tpu_torch.telemetry.hotkeys` — the shards'
  heavy-hitter sketch.
* :mod:`~multiverso_tpu_torch.telemetry.memstats` — the byte ledger,
  the sampler (host RSS and the CUDA allocator's census) and the leak
  verdicts.
* :mod:`~multiverso_tpu_torch.telemetry.devstats` — host<->device
  transfer counters and the per-device census.
* :mod:`~multiverso_tpu_torch.telemetry.profiler` — the per-step
  critical-path profiler (flag ``step_profile``).

The cluster plane, the same records and blocks as the JAX package's:

* :mod:`~multiverso_tpu_torch.telemetry.aggregator` — rank 0's poller
  (flag ``stats_poll_interval_s``) of every rank's MSG_STATS and
  MSG_HEALTH, merged into ``cluster.jsonl`` / ``cluster.prom`` records.
* :mod:`~multiverso_tpu_torch.telemetry.signals` — the typed autoscaling
  signals derived from each record, on a subscribable bus.
* :mod:`~multiverso_tpu_torch.telemetry.slo` — the SLO sentinel (flag
  ``slo_spec``): burn-rate episodes judged on every poll.
* :mod:`~multiverso_tpu_torch.telemetry.tenants` — tenant identity, the
  shards' per-tenant meters, the serve ledger and the noisy-neighbor
  verdict.

The tools that read these files are ``python -m
multiverso_tpu_torch.tools.postmortem``, ``.mvprof``, ``.dump_metrics``,
``.mvtop`` and ``.mvautoscale``; ``.check_obs_surface`` lints the
surface.
"""

from multiverso_tpu_torch.telemetry.histogram import Histogram  # noqa: F401
