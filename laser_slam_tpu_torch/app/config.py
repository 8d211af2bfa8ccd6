"""Robot configuration: Conf.xml-compatible parsing into dataclasses.

The reference's composition root loads a flat tag list from ``Conf.xml``
with a hand-rolled scanner (``ParseXML::ParseXMLRun``,
src/Main-Ctrl/ParseXML.{h,cpp}; sample config src/Main-Ctrl/Conf.xml).
The file is not well-formed XML (mismatched closing tags), so this
parser is deliberately lenient: it extracts ``<Tag>value`` pairs by
opening tag only, last occurrence wins — matching what the reference's
scanner tolerates.
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass
class Endpoint:
    ip: str = "127.0.0.1"
    port: int = 0


@dataclasses.dataclass
class RobotConfig:
    """Typed view of the Conf.xml parameter set (Conf.xml tags noted)."""

    # Network endpoints (IPA/PortA … LaserB, Conf.xml).
    slam_a: Endpoint = dataclasses.field(default_factory=Endpoint)
    slam_b: Endpoint = dataclasses.field(default_factory=Endpoint)
    control: Endpoint = dataclasses.field(default_factory=Endpoint)
    laser_a: Endpoint = dataclasses.field(default_factory=Endpoint)
    laser_b: Endpoint = dataclasses.field(default_factory=Endpoint)

    log_file: str = "robot.log"             # <LogFile>
    robot_id: int = 0                        # <RobotID>

    # Sensor fusion weights (<MainSICKWeight> etc.).
    weight_main_sick: float = 0.5
    weight_minor_sick: float = 0.0
    weight_beacon: float = 0.0
    weight_odometry: float = 0.5
    weight_global_sync: float = 0.8

    # Start pose (<OriX/OriY/OriT>; reference stores cm — kept verbatim
    # in the file's unit, exposed in meters).
    origin_x: float = 0.0
    origin_y: float = 0.0
    origin_theta: float = 0.0

    run_mode: int = 0                        # <RunMode>
    robot_length: float = 0.8                # <Robot_Len> [m]
    small_angle_deg: float = 20.0            # <Small_Angle>

    raw: dict[str, str] = dataclasses.field(default_factory=dict)


_TAG_RE = re.compile(r"<\s*([A-Za-z_][\w]*)\s*>\s*([^<\r\n]*)")


def parse_tags(text: str) -> dict[str, str]:
    """All ``<Tag>value`` pairs; later occurrences override earlier."""
    return {m.group(1): m.group(2).strip() for m in _TAG_RE.finditer(text)}


def _get(tags: dict[str, str], key: str, cast, default):
    v = tags.get(key)
    if v is None or v == "":
        return default
    try:
        return cast(v)
    except ValueError:
        return default


def load_config(path: str) -> RobotConfig:
    with open(path, "r", errors="replace") as f:
        tags = parse_tags(f.read())
    return config_from_tags(tags)


def config_from_tags(tags: dict[str, str]) -> RobotConfig:
    f, i, s = float, int, str
    cfg = RobotConfig(
        slam_a=Endpoint(_get(tags, "IPA", s, "127.0.0.1"), _get(tags, "PortA", i, 0)),
        slam_b=Endpoint(_get(tags, "IPB", s, "127.0.0.1"), _get(tags, "PortB", i, 0)),
        control=Endpoint(_get(tags, "IPC", s, "127.0.0.1"), _get(tags, "PortC", i, 0)),
        laser_a=Endpoint(_get(tags, "LaserAIP", s, "127.0.0.1"), _get(tags, "LaserAPort", i, 0)),
        laser_b=Endpoint(_get(tags, "LaserBIP", s, "127.0.0.1"), _get(tags, "LaserBPort", i, 0)),
        log_file=_get(tags, "LogFile", s, "robot.log"),
        robot_id=_get(tags, "RobotID", i, 0),
        weight_main_sick=_get(tags, "MainSICKWeight", f, 0.5),
        weight_minor_sick=_get(tags, "MinorSICKWeight", f, 0.0),
        weight_beacon=_get(tags, "BNWeight", f, 0.0),
        weight_odometry=_get(tags, "OdoWeight", f, 0.5),
        weight_global_sync=_get(tags, "SynGlobalWeight", f, 0.8),
        origin_x=_get(tags, "OriX", f, 0.0) / 100.0,   # cm → m
        origin_y=_get(tags, "OriY", f, 0.0) / 100.0,
        origin_theta=_get(tags, "OriT", f, 0.0),
        run_mode=_get(tags, "RunMode", i, 0),
        robot_length=_get(tags, "Robot_Len", f, 0.8),
        small_angle_deg=_get(tags, "Small_Angle", f, 20.0),
        raw=tags,
    )
    return cfg
