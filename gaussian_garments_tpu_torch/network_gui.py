"""Live-viewer socket protocol (SIBR remote viewer compatible).

A copy of ``gaussian_garments_tpu/network_gui.py`` (numpy and sockets only;
``MiniCam`` at ``:21``, ``NetworkGUI`` at ``:42``, the module wrappers at
``:96-113``), kept in the port so that it imports nothing of the JAX package.
Reference ``gaussian_renderer/network_gui.py``, the original 3DGS viewer
protocol: a non-blocking listener, little-endian length-prefixed JSON camera
messages in, raw RGB bytes and a length-prefixed verify string out. The
reference defines it but never wires it into a stage script.

A class (no module globals), with module-level ``init/try_connect/read/
send/receive`` wrappers matching the reference call sites.
"""
from __future__ import annotations

import json
import socket
from typing import Optional, Tuple

import numpy as np


class MiniCam:
    """Viewer-posted camera (reference scene/cameras.py:64-75)."""

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view_transform, full_proj_transform):
        import math

        self.image_width = int(width)
        self.image_height = int(height)
        self.FoVy = fovy
        self.FoVx = fovx
        self.znear = znear
        self.zfar = zfar
        self.world_view_transform = world_view_transform
        self.full_proj_transform = full_proj_transform
        view_inv = np.linalg.inv(np.asarray(world_view_transform))
        self.camera_center = view_inv[3][:3]
        self.tanfovx = math.tan(fovx * 0.5)
        self.tanfovy = math.tan(fovy * 0.5)


class NetworkGUI:
    def __init__(self):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.conn: Optional[socket.socket] = None
        self.addr = None

    def init(self, wish_host: str = "127.0.0.1", wish_port: int = 6009):
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((wish_host, wish_port))
        self.listener.listen()
        self.listener.settimeout(0)

    def try_connect(self):
        try:
            self.conn, self.addr = self.listener.accept()
            print(f"\nConnected by {self.addr}")
            self.conn.settimeout(None)
        except Exception:
            pass

    def read(self) -> dict:
        n = int.from_bytes(self.conn.recv(4), "little")
        buf = b""
        while len(buf) < n:
            buf += self.conn.recv(n - len(buf))
        return json.loads(buf.decode("utf-8"))

    def send(self, message_bytes: Optional[bytes], verify: str):
        if message_bytes is not None:
            self.conn.sendall(message_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self) -> Tuple:
        """Returns (MiniCam, do_training, shs_python, rot_scale_python,
        keep_alive, scaling_modifier) or Nones for an empty resolution."""
        m = self.read()
        width, height = m["resolution_x"], m["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None, None
        wv = np.array(m["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] = -wv[:, 1]
        wv[:, 2] = -wv[:, 2]
        fp = np.array(m["view_projection_matrix"], np.float32).reshape(4, 4)
        fp[:, 1] = -fp[:, 1]
        cam = MiniCam(width, height, m["fov_y"], m["fov_x"], m["z_near"], m["z_far"], wv, fp)
        return (cam, bool(m["train"]), bool(m["shs_python"]),
                bool(m["rot_scale_python"]), bool(m["keep_alive"]), m["scaling_modifier"])


_default = NetworkGUI()
conn = None  # reference-compatible alias (read via the class in practice)


def init(wish_host: str = "127.0.0.1", wish_port: int = 6009):
    _default.init(wish_host, wish_port)


def try_connect():
    _default.try_connect()


def read():
    return _default.read()


def send(message_bytes, verify):
    _default.send(message_bytes, verify)


def receive():
    return _default.receive()
