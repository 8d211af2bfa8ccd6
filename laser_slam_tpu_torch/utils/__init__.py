"""Cross-cutting utilities: checkpointing, profiling, timestamps."""

from .checkpoint import load_pytree, save_pytree
from .profiling import Profiler, profiler, trace
from .timestamp import TimeStamp, now

__all__ = [
    "load_pytree",
    "save_pytree",
    "Profiler",
    "profiler",
    "trace",
    "TimeStamp",
    "now",
]
