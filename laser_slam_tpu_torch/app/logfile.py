"""Module-tagged file logging (the reference's ``LogFile``,
src/Main-Ctrl/LogFile/LogFile.cpp, module IDs MainCtrl_Define.h:19-23).

Each subsystem logs with a module tag; lines carry a wall-clock
timestamp and the tag, mirroring the reference's
``CallBack_LogFile(content, moduleIdx)`` sink. Thread-safe.
"""

from __future__ import annotations

import threading
import time

# Module ids (MainCtrl_Define.h:19-23).
LOG_NET = 0
LOG_SLAM = 1
LOG_IOA = 2
LOG_SUBCTRL = 3
LOG_TASK = 4

MODULE_NAMES = {
    LOG_NET: "NET",
    LOG_SLAM: "SLAM",
    LOG_IOA: "IOA",
    LOG_SUBCTRL: "SUBCTRL",
    LOG_TASK: "TASK",
}


class LogFile:
    def __init__(self, path: str, echo: bool = False):
        self._path = path
        self._echo = echo
        self._lock = threading.Lock()
        self._fh = open(path, "a", buffering=1)

    def log(self, module: int, message: str) -> None:
        tag = MODULE_NAMES.get(module, str(module))
        ts = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"{ts} [{tag}] {message}"
        with self._lock:
            self._fh.write(line + "\n")
        if self._echo:
            print(line)

    def close(self) -> None:
        with self._lock:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
