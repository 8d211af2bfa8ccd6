"""Navigation: obstacle-aware speed control from the live scan."""

from .controller import security_speed_cap

__all__ = ["security_speed_cap"]
