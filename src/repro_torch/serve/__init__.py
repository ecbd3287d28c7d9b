"""Serving engine: paged KV, scheduled continuous batching, load gen.

Public surface:

* :class:`repro_torch.serve.engine.ServeEngine` / ``Request`` -- the engine
* :class:`repro_torch.serve.kv.PagedKV` -- paged KV-cache accounting
* :class:`repro_torch.serve.scheduler.Scheduler` / ``SchedulerConfig``
* :mod:`repro_torch.serve.loadgen` -- seeded arrivals + latency rollups
"""

from .engine import Request, ServeEngine          # noqa: F401
from .kv import PagedKV                           # noqa: F401
from .scheduler import Scheduler, SchedulerConfig  # noqa: F401
