"""System health monitor: battery voltages + sensor/serial link watch.

The role of the reference's ``C_C::ThreadSystemMonitor`` + ``ErrList``
(src/Main-Ctrl/C_C.cpp:930-961): poll the chassis status, raise a
system error code when a battery sags below its safe voltage or a
serial/sensor link goes silent, and let the error code drive the robot
(the main loop spins until ``m_nSysErrList != 0`` then shuts down,
C_C.cpp:369-380). Error codes are the reference's own list
(src/version1/slam_v1.h:16-21); link-loss codes also mirror the
RTN_LOSS_* family (MainCtrl_Define.h:10-15).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

# Error codes (slam_v1.h:16-21).
SYS_OK = 0
SYS_ERR_CTRL_BATTERY_LOW = 1
SYS_ERR_POWER_BATTERY_LOW = 2
SYS_LOST_CNC_SICK_A = 3
SYS_LOST_CNC_SICK_B = 4
SYS_LOST_BN_SERIAL = 5
SYS_LOST_LOW_CTRL_SERIAL = 6

ERROR_NAMES = {
    SYS_OK: "ok",
    SYS_ERR_CTRL_BATTERY_LOW: "ctrl-battery-low",
    SYS_ERR_POWER_BATTERY_LOW: "power-battery-low",
    SYS_LOST_CNC_SICK_A: "lost-sick-a",
    SYS_LOST_CNC_SICK_B: "lost-sick-b",
    SYS_LOST_BN_SERIAL: "lost-beacon-serial",
    SYS_LOST_LOW_CTRL_SERIAL: "lost-chassis-serial",
}

_LINK_CODES = {
    "sick_a": SYS_LOST_CNC_SICK_A,
    "sick_b": SYS_LOST_CNC_SICK_B,
    "beacon": SYS_LOST_BN_SERIAL,
    "chassis": SYS_LOST_LOW_CTRL_SERIAL,
}


@dataclasses.dataclass
class SystemMonitor:
    """Host-side health state machine (no thread of its own — the
    composition root polls it from the control tick, so error handling
    is synchronous with the task engine it must stop).

    ``on_error(code)`` fires once per new nonzero code. Battery
    thresholds follow the reference's CTRL/POWER_BATTERY_SAFE_VOLT
    constants' role; links must be fed via :meth:`link_alive` at least
    every ``link_timeout`` seconds once announced.
    """

    ctrl_battery_safe_volt: float = 22.0
    power_battery_safe_volt: float = 22.0
    link_timeout: float = 3.0
    on_error: Callable[[int], None] | None = None
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self.error = SYS_OK
        self.volt_ctrl = float("inf")
        self.volt_power = float("inf")
        self._links: dict[str, float] = {}
        self._fired: set[int] = set()

    # -- inputs -----------------------------------------------------------

    def report_battery(self, ctrl_volt: float, power_volt: float) -> None:
        """Chassis status row (GetRobotStatus voltages, C_C.cpp:906)."""
        self.volt_ctrl = float(ctrl_volt)
        self.volt_power = float(power_volt)

    def link_alive(self, name: str) -> None:
        """Heartbeat for a named link (``sick_a``/``sick_b``/``beacon``/
        ``chassis``). First call announces the link; from then on it is
        supervised."""
        if name not in _LINK_CODES:
            raise ValueError(f"unknown link {name!r}")
        self._links[name] = self.clock()

    # -- polling ----------------------------------------------------------

    def poll(self) -> int:
        """Re-evaluate health; returns the current error code (latched
        until :meth:`clear`). Battery checks outrank link checks, like
        the reference's monitor ordering."""
        code = SYS_OK
        now = self.clock()
        for name, t in self._links.items():
            if now - t > self.link_timeout:
                code = _LINK_CODES[name]
        if self.volt_power < self.power_battery_safe_volt:
            code = SYS_ERR_POWER_BATTERY_LOW
        if self.volt_ctrl < self.ctrl_battery_safe_volt:
            code = SYS_ERR_CTRL_BATTERY_LOW
        if code != SYS_OK:
            self.error = code
            if code not in self._fired:
                self._fired.add(code)
                if self.on_error is not None:
                    self.on_error(code)
        return self.error

    def clear(self) -> None:
        """Operator acknowledgment: drop the latched error (the
        reference clears ``m_nSysErrList`` on recovery paths)."""
        self.error = SYS_OK
        self._fired.clear()
