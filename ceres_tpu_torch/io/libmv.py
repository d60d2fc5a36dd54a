"""libmv/Blender bundle-adjustment problem file loader.

Capability parity with the reference's examples/libmv_bundle_adjuster.cc
binary reader (EndianAwareFileReader + ReadProblemFromFile,
libmv_bundle_adjuster.cc:256-450): endian flag byte ('v' little / 'V' big),
marker-space flag ('P' image space / 'N' normalized), 8 float32 intrinsics
(f, cx, cy, k1, k2, k3, p1, p2), cameras (int image, 3x3 R column-major
float32, 3 t float32), points (int track, 3 float32), markers (int image,
int track, 2 float32). Fixture files ship with the reference at
data/libmv-ba-problems/problem_0{1,2,3}.bin (Tears of Steel scenes).

A copy of ceres_tpu/io/libmv.py (numpy only), so the port imports nothing
of the JAX package, and `write_libmv_test_problem`, a writer of the same
binary format for tests and smoke runs that generate their own problems
(the reference ships no writer).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

OFFSET_FOCAL_LENGTH = 0
OFFSET_PRINCIPAL_POINT_X = 1
OFFSET_PRINCIPAL_POINT_Y = 2
OFFSET_K1 = 3
OFFSET_K2 = 4
OFFSET_K3 = 5
OFFSET_P1 = 6
OFFSET_P2 = 7

BUNDLE_NO_INTRINSICS = 0
BUNDLE_FOCAL_LENGTH = 1
BUNDLE_PRINCIPAL_POINT = 2
BUNDLE_RADIAL_K1 = 4
BUNDLE_RADIAL_K2 = 8
BUNDLE_RADIAL = BUNDLE_RADIAL_K1 | BUNDLE_RADIAL_K2
BUNDLE_TANGENTIAL_P1 = 16
BUNDLE_TANGENTIAL_P2 = 32
BUNDLE_TANGENTIAL = BUNDLE_TANGENTIAL_P1 | BUNDLE_TANGENTIAL_P2


@dataclass
class LibmvProblem:
    is_image_space: bool
    intrinsics: np.ndarray                  # [8] float64
    cameras: Dict[int, np.ndarray]          # image -> (R [3,3], t [3])
    points: Dict[int, np.ndarray]           # track -> [3]
    markers: List[tuple]                    # (image, track, x, y)


class _Reader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.buf = f.read()
        self.off = 0
        flag = self._raw("B")
        if flag == ord("v"):
            self.end = "<"
        elif flag == ord("V"):
            self.end = ">"
        else:
            raise ValueError(f"unknown endian flag {flag!r}")

    def _raw(self, fmt, endian="<"):
        size = struct.calcsize(fmt)
        (v,) = struct.unpack_from(endian + fmt, self.buf, self.off)
        self.off += size
        return v

    def u8(self):
        return self._raw("B")

    def i32(self):
        return self._raw("i", self.end)

    def f32(self):
        return self._raw("f", self.end)

    def f32s(self, n):
        vals = struct.unpack_from(self.end + "f" * n, self.buf, self.off)
        self.off += 4 * n
        return np.asarray(vals, dtype=np.float64)


def read_libmv_problem(path: str) -> LibmvProblem:
    r = _Reader(path)
    space = r.u8()
    if space == ord("P"):
        is_image_space = True
    elif space == ord("N"):
        is_image_space = False
    else:
        raise ValueError(f"unknown marker space {space!r}")

    intrinsics = r.f32s(8)

    cameras: Dict[int, np.ndarray] = {}
    for _ in range(r.i32()):
        image = r.i32()
        R = r.f32s(9).reshape(3, 3, order="F")  # column-major in the file
        t = r.f32s(3)
        cameras[image] = (R, t)

    points: Dict[int, np.ndarray] = {}
    for _ in range(r.i32()):
        track = r.i32()
        points[track] = r.f32s(3)

    markers = []
    for _ in range(r.i32()):
        image = r.i32()
        track = r.i32()
        x = r.f32()
        y = r.f32()
        markers.append((image, track, x, y))

    return LibmvProblem(is_image_space, intrinsics, cameras, points,
                        markers)


def write_libmv_test_problem(path: str, problem: LibmvProblem,
                             big_endian: bool = False) -> None:
    """Write `problem` in the binary format read_libmv_problem reads
    (a test helper: the reference and the JAX package have no writer).
    Floats are stored as float32, as in the published files, so a written
    problem reads back rounded to float32."""
    end = ">" if big_endian else "<"
    out = [b"V" if big_endian else b"v",
           b"P" if problem.is_image_space else b"N",
           struct.pack(end + "8f", *np.asarray(problem.intrinsics,
                                               np.float64))]
    out.append(struct.pack(end + "i", len(problem.cameras)))
    for image, (R, t) in problem.cameras.items():
        out.append(struct.pack(end + "i", int(image)))
        out.append(struct.pack(end + "9f", *np.asarray(R).reshape(
            3, 3).ravel(order="F")))
        out.append(struct.pack(end + "3f", *np.asarray(t)))
    out.append(struct.pack(end + "i", len(problem.points)))
    for track, X in problem.points.items():
        out.append(struct.pack(end + "i", int(track)))
        out.append(struct.pack(end + "3f", *np.asarray(X)))
    out.append(struct.pack(end + "i", len(problem.markers)))
    for image, track, x, y in problem.markers:
        out.append(struct.pack(end + "iiff", int(image), int(track),
                               float(x), float(y)))
    with open(path, "wb") as f:
        f.write(b"".join(out))
