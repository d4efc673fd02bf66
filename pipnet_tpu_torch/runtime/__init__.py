"""Runtime plumbing: the run directory's logs, profiling, and the mesh
(``mesh.py``: data parallelism and ZeRO-1 on ``torch.distributed``)."""

from .log import NullRunLog, RunLog, Tee, open_run_log
from .profiling import SPANS, span, trace

__all__ = ["NullRunLog", "RunLog", "Tee", "open_run_log", "SPANS", "span", "trace"]
