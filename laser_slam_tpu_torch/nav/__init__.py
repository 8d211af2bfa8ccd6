"""Navigation: path planning, trajectory tracking / obstacle-aware speed
control, and the rolling egocentric local map."""

from .controller import ControlCommand, pure_pursuit, security_speed_cap, track_step
from .local_map import (
    LocalMap,
    LocalMapService,
    empty_local_map,
    obstacle_distance_field,
    update_local_map,
)
from .planner import PlanResult, plan_path, wavefront

__all__ = [
    "ControlCommand",
    "pure_pursuit",
    "security_speed_cap",
    "track_step",
    "LocalMap",
    "LocalMapService",
    "empty_local_map",
    "obstacle_distance_field",
    "update_local_map",
    "PlanResult",
    "plan_path",
    "wavefront",
]
