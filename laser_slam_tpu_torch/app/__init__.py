"""Robot application layer (the reference's Main-Ctrl,
src/Main-Ctrl/): config, logging, beacon positioning, waypoint task
engine, remote-control portal, and the composition root."""

from .beacon import BeaconFix, trilaterate
from .config import RobotConfig, load_config, parse_tags
from .logfile import LogFile
from .mission import Mission, MissionLeg, MissionRunner, MissionStatus
from .monitor import SystemMonitor
from .portal import NetPortal
from .robot import RobotController
from .task import TaskEngine, TaskState

__all__ = [
    "BeaconFix",
    "trilaterate",
    "RobotConfig",
    "load_config",
    "parse_tags",
    "LogFile",
    "Mission",
    "MissionLeg",
    "MissionRunner",
    "MissionStatus",
    "SystemMonitor",
    "NetPortal",
    "RobotController",
    "TaskEngine",
    "TaskState",
]
