"""Remote-control portal: line-oriented TCP command server.

The role of the reference's ``NetPortal`` (src/Main-Ctrl/NetPortal/
NetPortal.cpp, 811 LoC of raw-socket framing): an operator console
connects over TCP and issues commands; the portal answers with robot
state. The reference's binary command codes (MainCtrl_Define.h:82-87)
map onto newline-delimited UTF-8 verbs, one command per line:

    GOTO <x> <y>           queue a navigation goal (meters)
    MISSION <leg>;<leg>... scripted mission: each leg is
                           "x y [speed [action [arg [retries]]]]"
                           (the reference's task parameter rows,
                           Task.cpp:509-548, C_C.h:78)
    PATH <x1> <y1> ...     queue a multi-waypoint task path
                           (NEW_TASK_PATH 0x0001, Task.cpp:518-548)
    REPATH <x1> <y1> ...   replace the running mission mid-task
                           (RE_TASK_PATH 0x0002, Task.cpp:561-588)
    STOP                   decelerate to a stop, clear the mission
                           (SLOW_BREAK 0x1000 / task type 10)
    CANCEL                 abort the current mission immediately
    POSE                   -> "POSE x y theta"
    STATE                  -> "STATE <task-state>"
    PING                   -> "PONG"
    ERR                    -> "ERR <code> <name>" system error state
                           (ErrList, C_C.cpp:952; codes slam_v1.h:16-21)
    MAP                    -> "MAP <w> <h> <res> <zlib+base64 cells>"
                           occupancy fetch (GRID_MAP_IN 0x0010 role)
    HEART                  -> "BEAT"; arms the heartbeat watchdog
                           (HEART_BIT 0xFFF0: the reference's portal
                           supervises the console link and stops the
                           robot when the beat goes silent)

Asynchronous events are PUSHED to every connected console with an
``EVENT`` prefix — ``EVENT REACHED <leg> <x> <y>`` mirrors the
ROB_REACH_MIL milestone notification (MainCtrl_Define.h:84).

Runs on a daemon thread; handlers are supplied by the composition root.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable


class NetPortal:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        on_goto: Callable[[float, float], None] | None = None,
        on_cancel: Callable[[], None] | None = None,
        get_pose: Callable[[], tuple] | None = None,
        get_state: Callable[[], str] | None = None,
        on_path: Callable[[list], None] | None = None,
        on_repath: Callable[[list], None] | None = None,
        on_slow_stop: Callable[[], None] | None = None,
        on_heartbeat_lost: Callable[[], None] | None = None,
        heartbeat_timeout: float = 3.0,
        on_mission: Callable[[list], None] | None = None,
        get_error: Callable[[], tuple] | None = None,
        get_map: Callable[[], tuple] | None = None,
    ):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.port = self._srv.getsockname()[1]
        self._on_goto = on_goto
        self._on_cancel = on_cancel
        self._get_pose = get_pose
        self._get_state = get_state
        self._on_path = on_path
        self._on_repath = on_repath
        self._on_slow_stop = on_slow_stop
        self._on_heartbeat_lost = on_heartbeat_lost
        self._on_mission = on_mission
        self._get_error = get_error
        self._get_map = get_map
        self._clients: list = []
        self._clients_lock = threading.Lock()
        self._heartbeat_timeout = heartbeat_timeout
        self._last_beat: float | None = None  # armed by the first HEART
        self._beat_lost_fired = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._watchdog = threading.Thread(
            target=self._watch_heartbeat, daemon=True
        )

    def start(self) -> None:
        self._thread.start()
        self._watchdog.start()

    def _watch_heartbeat(self) -> None:
        """Fire ``on_heartbeat_lost`` once when an armed heartbeat goes
        silent past the timeout (the reference portal's HEART_BIT link
        supervision — a lost console means the robot must stop)."""
        while not self._stop.wait(0.2):
            if self._last_beat is None or self._beat_lost_fired:
                continue
            if time.monotonic() - self._last_beat > self._heartbeat_timeout:
                self._beat_lost_fired = True
                if self._on_heartbeat_lost is not None:
                    self._on_heartbeat_lost()

    def stop(self) -> None:
        self._stop.set()
        try:
            # Unblock accept().
            socket.create_connection(("127.0.0.1", self.port), timeout=0.5).close()
        except OSError:
            pass
        self._srv.close()

    def _serve(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            ).start()

    def _handle(self, conn: socket.socket) -> None:
        with conn, conn.makefile("rw", encoding="utf-8", newline="\n") as f:
            with self._clients_lock:
                self._clients.append(f)
            try:
                for line in f:
                    if self._stop.is_set():
                        return
                    reply = self._dispatch(line.strip())
                    if reply is not None:
                        f.write(reply + "\n")
                        f.flush()
            finally:
                with self._clients_lock:
                    if f in self._clients:
                        self._clients.remove(f)

    def broadcast(self, line: str) -> None:
        """Push an EVENT line to every connected console (the portal's
        upstream notifications: ROB_REACH_MIL milestone reports,
        error announcements)."""
        with self._clients_lock:
            clients = list(self._clients)
        for f in clients:
            try:
                f.write("EVENT " + line + "\n")
                f.flush()
            except (OSError, ValueError):
                pass

    def _dispatch(self, line: str) -> str | None:
        parts = line.split()
        if not parts:
            return None
        cmd = parts[0].upper()
        if cmd == "PING":
            return "PONG"
        if cmd == "HEART":
            self._last_beat = time.monotonic()
            self._beat_lost_fired = False
            return "BEAT"
        if cmd == "GOTO" and len(parts) == 3 and self._on_goto:
            try:
                self._on_goto(float(parts[1]), float(parts[2]))
                return "OK"
            except ValueError:
                return "ERR bad args"
        if cmd in ("PATH", "REPATH"):
            handler = self._on_path if cmd == "PATH" else self._on_repath
            if handler is None:
                return "ERR unknown"
            try:
                vals = [float(v) for v in parts[1:]]
            except ValueError:
                return "ERR bad args"
            if len(vals) < 2 or len(vals) % 2:
                return "ERR bad args"
            handler([(vals[i], vals[i + 1]) for i in range(0, len(vals), 2)])
            return "OK"
        if cmd == "STOP" and self._on_slow_stop:
            self._on_slow_stop()
            return "OK"
        if cmd == "CANCEL" and self._on_cancel:
            self._on_cancel()
            return "OK"
        if cmd == "POSE" and self._get_pose:
            x, y, th = self._get_pose()
            return f"POSE {x:.4f} {y:.4f} {th:.4f}"
        if cmd == "STATE" and self._get_state:
            return f"STATE {self._get_state()}"
        if cmd == "MISSION" and self._on_mission:
            rows = []
            try:
                for leg in " ".join(parts[1:]).split(";"):
                    leg = leg.strip()
                    if leg:
                        rows.append(leg.split())
                if not rows:
                    return "ERR bad args"
                self._on_mission(rows)
                return "OK"
            except (ValueError, KeyError):
                return "ERR bad args"
        if cmd == "ERR" and self._get_error:
            code, name = self._get_error()
            return f"ERR {code} {name}"
        if cmd == "MAP" and self._get_map:
            import base64
            import zlib

            w, h, res, cells = self._get_map()
            payload = base64.b64encode(zlib.compress(bytes(cells))).decode()
            return f"MAP {w} {h} {res:.3f} {payload}"
        return "ERR unknown"
