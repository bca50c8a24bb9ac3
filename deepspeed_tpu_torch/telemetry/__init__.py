"""Telemetry (counterpart of ``deepspeed_tpu/telemetry``): the event and
span tables (``events``), span and step tracing (``tracing``), the
fixed-bucket histogram (``metrics``), the labeled metric registry
(``registry``) and its Prometheus text exposition (``prom``), the JSONL
sink and monitor bridge (``sink``), the kernel-build and call-signature
watches (``compile_watch``, ``jit_watch``), exposed-comm accounting
(``exposed_comm``) and the per-engine facade (``manager.Telemetry``).
Importing the package imports no torch: the serving policy tier loads it
anywhere; ``manager`` and ``jit_watch`` import torch where they run."""
