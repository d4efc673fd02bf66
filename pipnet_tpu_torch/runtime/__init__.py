"""Runtime plumbing: the run directory's logs and profiling."""

from .log import RunLog, Tee
from .profiling import StepTimer, annotate, trace

__all__ = ["RunLog", "Tee", "StepTimer", "annotate", "trace"]
