"""The port's readers (ceres_tpu_torch/io/pgm.py, io/libmv.py,
io/nist.py) against the JAX package's on files the tests write: PGM and
libmv round trips, a NIST StRD file parsed by both packages to equal
arrays, compute_lre and NISTResidual."""

import numpy as np
import pytest
import torch

import torch_parity_kit  # noqa: F401  (one thread)
from ceres_tpu.io import libmv as jax_libmv
from ceres_tpu.io import nist as jax_nist
from ceres_tpu.io import pgm as jax_pgm
from ceres_tpu_torch.io import libmv, nist, pgm


def test_pgm_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(-10, 270, (13, 17))
    p = str(tmp_path / "a.pgm")
    pgm.write_pgm(p, img)
    back = pgm.read_pgm(p)
    want = np.clip(np.round(img), 0, 255)
    np.testing.assert_array_equal(back, want)
    np.testing.assert_array_equal(jax_pgm.read_pgm(p), back)


def test_pgm_ascii_with_comment(tmp_path):
    p = tmp_path / "b.pgm"
    p.write_bytes(b"P2\n# a comment\n3 2\n255\n0 10 20\n30 40 255\n")
    img = pgm.read_pgm(str(p))
    np.testing.assert_array_equal(img, [[0, 10, 20], [30, 40, 255]])
    np.testing.assert_array_equal(jax_pgm.read_pgm(str(p)), img)


def test_pgm_rejects_other_formats(tmp_path):
    p = tmp_path / "c.pgm"
    p.write_bytes(b"P6\n1 1\n255\n\x00\x00\x00")
    with pytest.raises(ValueError, match="not a PGM"):
        pgm.read_pgm(str(p))


def _libmv_problem(seed=0):
    rng = np.random.default_rng(seed)
    cams = {i: (rng.standard_normal((3, 3)), rng.standard_normal(3))
            for i in (0, 3, 7)}
    pts = {t: rng.standard_normal(3) for t in (1, 2, 5, 9)}
    markers = [(i, t, float(rng.uniform(0, 1920)), float(rng.uniform(0,
                                                                     1080)))
               for i in cams for t in pts]
    return libmv.LibmvProblem(True, rng.standard_normal(8), cams, pts,
                              markers)


@pytest.mark.parametrize("big_endian", [False, True])
def test_libmv_round_trip(tmp_path, big_endian):
    lp = _libmv_problem()
    p = str(tmp_path / "p.bin")
    libmv.write_libmv_test_problem(p, lp, big_endian=big_endian)
    got = libmv.read_libmv_problem(p)
    ref = jax_libmv.read_libmv_problem(p)
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)  # noqa
    assert got.is_image_space and ref.is_image_space
    np.testing.assert_array_equal(got.intrinsics, f32(lp.intrinsics))
    np.testing.assert_array_equal(got.intrinsics, ref.intrinsics)
    assert list(got.cameras) == list(lp.cameras) == list(ref.cameras)
    for i, (R, t) in lp.cameras.items():
        np.testing.assert_array_equal(got.cameras[i][0], f32(R))
        np.testing.assert_array_equal(got.cameras[i][1], f32(t))
        np.testing.assert_array_equal(got.cameras[i][0], ref.cameras[i][0])
    for t, X in lp.points.items():
        np.testing.assert_array_equal(got.points[t], f32(X))
        np.testing.assert_array_equal(got.points[t], ref.points[t])
    assert [(i, t) for i, t, _, _ in got.markers] == \
        [(i, t) for i, t, _, _ in lp.markers]
    np.testing.assert_array_equal(
        np.asarray([m[2:] for m in got.markers]),
        f32([m[2:] for m in lp.markers]))
    assert got.markers == ref.markers


def test_libmv_rejects_bad_flags(tmp_path):
    p = tmp_path / "bad.bin"
    p.write_bytes(b"xP" + bytes(40))
    with pytest.raises(ValueError, match="endian"):
        libmv.read_libmv_problem(str(p))
    p.write_bytes(b"vQ" + bytes(40))
    with pytest.raises(ValueError, match="marker space"):
        libmv.read_libmv_problem(str(p))


@pytest.mark.parametrize("name", ["Misra1a", "Nelson", "ENSO"])
def test_nist_file_parsed_by_both(tmp_path, name):
    rng = np.random.default_rng(1)
    k = nist.NIST_MODELS[name][0]
    p = 2 if name == "Nelson" else 1
    x = rng.uniform(1, 5, (11, p))
    y = rng.uniform(1, 3, 11)
    starts = (rng.standard_normal(k), rng.standard_normal(k))
    cert = rng.standard_normal(k) * 1e3
    path = str(tmp_path / f"{name}.dat")
    nist.write_nist_test_file(path, name, x, y, starts, cert, 0.123)
    a, b = nist.parse_nist_file(path), jax_nist.parse_nist_file(path)
    assert a.name == b.name == name and a.num_params == b.num_params == k
    for f in ("starts", "certified", "x", "y"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.x, x)
    np.testing.assert_array_equal(a.y, y)
    np.testing.assert_array_equal(a.starts, np.asarray(starts))
    np.testing.assert_array_equal(a.certified, cert)
    assert a.certified_cost == b.certified_cost == 0.5 * 0.123
    suite = nist.load_nist_suite(str(tmp_path))
    assert [s.name for s in suite] == [name]


@pytest.mark.parametrize("est,cert", [
    ([1.0, 2.0], [1.0, 2.0]), ([1.0 + 1e-7, 2.0], [1.0, 2.0]),
    ([0.0, 5e-4], [0.0, 5.0e-4 * (1 + 3e-9)]), ([1e-6, 3.0], [0.0, 3.0]),
    ([2.0, 1.0], [1.0, 1.0]), ([1.0, -4.0], [1.0, -4.00004])])
def test_compute_lre_equal(est, cert):
    assert nist.compute_lre(est, cert) == jax_nist.compute_lre(est, cert)


@pytest.mark.parametrize("name", sorted(nist.NIST_MODELS))
def test_nist_residual_matches_jax(name):
    import jax.numpy as jnp
    rng = np.random.default_rng(len(name))
    k = nist.NIST_MODELS[name][0]
    b = rng.uniform(0.5, 1.5, k)
    if name in ("Bennett5",):
        b[1] = 50.0
    for _ in range(3):
        xr = rng.uniform(0.5, 2.0, 2)
        yv = float(rng.uniform(1.0, 2.0))
        got = nist.NISTResidual(name, xr, yv)(torch.as_tensor(b))
        want = jax_nist.NISTResidual(name, xr, yv)(jnp.asarray(b))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-14,
                                   atol=1e-14)
