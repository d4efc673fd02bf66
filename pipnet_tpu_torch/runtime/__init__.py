"""Runtime plumbing: the run directory's logs, profiling, and the mesh
(``mesh.py``: data parallelism and ZeRO-1 on ``torch.distributed``)."""

from .log import NullRunLog, RunLog, Tee, open_run_log
from .profiling import StepTimer, annotate, trace

__all__ = ["NullRunLog", "RunLog", "Tee", "open_run_log", "StepTimer", "annotate", "trace"]
