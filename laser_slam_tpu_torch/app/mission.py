"""Mission scripts: multi-leg goal sequences with per-leg speed caps,
completion actions, and retry budgets (port of ``app/mission.py``; its
stop and spin commands are made on the task engine's device).

The role of the reference's Task.cpp mission layer (src/Main-Ctrl/Task/
Task.cpp, 2121 LoC): a task is a list of legs — drive to a waypoint at
a capped speed, optionally perform an action on arrival (hold position,
spin to a heading), retry a failed leg a bounded number of times —
executed by the task state machine and reported leg-by-leg (the
ROB_REACH_MIL milestone notifications, MainCtrl_Define.h:84). The
per-leg parameter rows mirror ``m_fTaskParams`` (C_C.h:78) and the
NEW_TASK_PATH payload's per-point MAX_SPD entries (Task.cpp:509-548).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from .task import TaskEngine, TaskState, command


class LegAction(enum.Enum):
    NONE = "none"
    PAUSE = "pause"    # hold position for `action_arg` seconds
    SPIN = "spin"      # turn in place by `action_arg` radians


@dataclasses.dataclass
class MissionLeg:
    goal: tuple[float, float]
    speed: float | None = None        # per-leg cap [m/s]; None = default
    action: LegAction = LegAction.NONE
    action_arg: float = 0.0
    retries: int = 1                  # re-plans allowed after FAILED


@dataclasses.dataclass
class Mission:
    legs: list[MissionLeg]

    @classmethod
    def from_rows(cls, rows) -> "Mission":
        """Rows of ``(x, y[, speed[, action[, arg[, retries]]]])`` — the
        tabular form a config or portal payload carries."""
        legs = []
        for row in rows:
            row = list(row)
            x, y = float(row[0]), float(row[1])
            speed = float(row[2]) if len(row) > 2 and row[2] is not None \
                else None
            action = LegAction(str(row[3])) if len(row) > 3 else LegAction.NONE
            arg = float(row[4]) if len(row) > 4 else 0.0
            retries = int(row[5]) if len(row) > 5 else 1
            legs.append(MissionLeg((x, y), speed, action, arg, retries))
        return cls(legs)

    @classmethod
    def from_config_tags(cls, tags: dict) -> "Mission":
        """Parse ``<Leg1>x y [speed [action [arg [retries]]]]`` …
        ``<LegN>`` rows from a Conf.xml-style tag dict (the reference
        stores its task parameter table in the same flat-tag config,
        ParseXML.cpp)."""
        rows = []
        i = 1
        while f"Leg{i}" in tags:
            rows.append(tags[f"Leg{i}"].split())
            i += 1
        return cls.from_rows(rows)


class MissionStatus(enum.Enum):
    IDLE = "idle"
    RUNNING = "running"
    ACTION = "action"        # leg reached; performing its action
    DONE = "done"
    FAILED = "failed"


class MissionRunner:
    """Drives a :class:`Mission` through a :class:`TaskEngine`, one
    control tick at a time.

    The runner owns leg sequencing, retry accounting, and arrival
    actions; the engine owns planning/tracking/dodging. ``on_reached``
    fires per completed leg (the ROB_REACH_MIL notification the
    reference's portal pushes to the console, NetPortal.cpp)."""

    def __init__(
        self,
        engine: TaskEngine,
        mission: Mission,
        on_reached=None,
        tick_dt: float = 0.1,
    ):
        self.engine = engine
        self.mission = mission
        self.on_reached = on_reached
        self.tick_dt = tick_dt
        self.status = MissionStatus.IDLE
        self._leg = -1
        self._retries_left = 0
        self._action_ticks = 0
        self._spin_target: float | None = None

    @property
    def current_leg(self) -> int:
        return self._leg

    def start(self) -> None:
        self.status = MissionStatus.RUNNING
        self._advance()

    def _advance(self) -> None:
        self._leg += 1
        if self._leg >= len(self.mission.legs):
            self.status = MissionStatus.DONE
            self.engine.cancel()
            return
        leg = self.mission.legs[self._leg]
        self._retries_left = leg.retries
        self.engine.cancel()
        self.engine.add_goal(leg.goal, leg.speed)

    def _begin_action(self, pose) -> None:
        leg = self.mission.legs[self._leg]
        if leg.action is LegAction.NONE:
            self._advance()
            return
        self.status = MissionStatus.ACTION
        if leg.action is LegAction.PAUSE:
            self._action_ticks = max(int(leg.action_arg / self.tick_dt), 1)
        else:  # SPIN
            self._spin_target = float(
                (pose[2] + leg.action_arg + np.pi) % (2 * np.pi) - np.pi
            )

    def tick(self, pose, scan):
        """One control tick; returns the engine's motor command (or an
        action command). Call at the control rate."""
        dev = self.engine.device
        stop = command(0.0, 0.0, dev)
        if self.status is MissionStatus.ACTION:
            leg = self.mission.legs[self._leg]
            if leg.action is LegAction.PAUSE:
                self._action_ticks -= 1
                if self._action_ticks <= 0:
                    self.status = MissionStatus.RUNNING
                    self._advance()
                return stop
            # SPIN: bang-bang toward the target heading.
            err = float(
                (self._spin_target - pose[2] + np.pi) % (2 * np.pi) - np.pi
            )
            if abs(err) < 0.1:
                self.status = MissionStatus.RUNNING
                self._advance()
                return stop
            return command(0.0, float(np.float32(np.sign(err) * self.engine.turn_rate)), dev)

        if self.status is not MissionStatus.RUNNING:
            return stop

        cmd = self.engine.step(pose, scan)
        if self.engine.state is TaskState.DONE:
            if self.on_reached is not None:
                self.on_reached(self._leg, self.mission.legs[self._leg].goal)
            self._begin_action(pose)
        elif self.engine.state is TaskState.FAILED:
            if self._retries_left > 0:
                self._retries_left -= 1
                leg = self.mission.legs[self._leg]
                self.engine.cancel()
                self.engine.add_goal(leg.goal, leg.speed)
            else:
                self.status = MissionStatus.FAILED
        return cmd
