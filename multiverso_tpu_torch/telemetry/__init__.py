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

The tools that read these files are ``python -m
multiverso_tpu_torch.tools.postmortem``, ``.mvprof`` and
``.dump_metrics``. The cluster plane (aggregator, signals, slo, tenants)
is not ported yet (ROADMAP.md §A, "Telemetry and tools").
"""

from multiverso_tpu_torch.telemetry.histogram import Histogram  # noqa: F401
