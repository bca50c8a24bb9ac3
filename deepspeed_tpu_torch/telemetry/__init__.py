"""Telemetry for the serving fleet (counterpart of the host-only half of
``deepspeed_tpu/telemetry``): the event and span tables (``events``),
span tracing (``tracing``), the fixed-bucket histogram (``metrics``),
the labeled metric registry (``registry``) and its Prometheus text
exposition (``prom``). No module here imports torch."""
