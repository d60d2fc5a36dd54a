"""PGM image IO (reference examples/pgm_image.h): P2 (ASCII) and P5 (binary)
grayscale, returned as float64 arrays.

A copy of ceres_tpu/io/pgm.py (numpy only), so the port imports nothing of
the JAX package."""

from __future__ import annotations

import numpy as np


def read_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()

    def tokens(b):
        i = 0
        while i < len(b):
            if b[i:i + 1].isspace():
                i += 1
                continue
            if b[i:i + 1] == b"#":
                while i < len(b) and b[i:i + 1] != b"\n":
                    i += 1
                continue
            j = i
            while j < len(b) and not b[j:j + 1].isspace():
                j += 1
            yield b[i:j], j
            i = j

    it = tokens(data)
    magic, _ = next(it)
    if magic not in (b"P2", b"P5"):
        raise ValueError(f"not a PGM file: {magic!r}")
    width, _ = next(it)
    height, _ = next(it)
    maxval, pos = next(it)
    w, h, mv = int(width), int(height), int(maxval)
    if magic == b"P2":
        vals = []
        for tok, _ in it:
            vals.append(int(tok))
            if len(vals) == w * h:
                break
        img = np.asarray(vals, dtype=np.float64)
    else:
        raw = data[pos + 1:pos + 1 + w * h * (2 if mv > 255 else 1)]
        dt = ">u2" if mv > 255 else np.uint8
        img = np.frombuffer(raw, dtype=dt).astype(np.float64)
    return img.reshape(h, w)


def write_pgm(path: str, img: np.ndarray, maxval: int = 255):
    img = np.clip(np.round(img), 0, maxval).astype(np.uint8)
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n{maxval}\n".encode())
        f.write(img.tobytes())
