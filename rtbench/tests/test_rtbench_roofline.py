"""Each kernel's least work at a small shape, by hand, and the share."""

from __future__ import annotations

import pytest

from rtbench import harness, trace
from rtbench.obs import Obs
from rtbench.roofline import K4, K8, K9, K10, peaks, share

SHAPE = {"width": 4, "height": 2, "faces": 10, "spheres": 2, "bounces": 3}


def test_k4_bytes():
    # 8 pixels x 12 B of direction, 10 faces x 36 B, 2 spheres x 16 B,
    # 8 pixels x 12 B written
    assert K4.work(SHAPE) == (0.0, 8 * 12 + 360 + 32 + 8 * 12)


def test_k9_bytes():
    assert K9.work(SHAPE) == (0.0, 8 * 12 + 360 + 8 * 8)


def test_k8_bytes():
    # a call: 8 lanes x 2 rays x 24 B, 10 faces x 36 B, 8 x 9 B written
    assert K8.work(SHAPE) == (0.0, 3 * (8 * 48 + 360 + 8 * 9))


def test_k10_bytes():
    assert K10.work(SHAPE) == (0.0, 3 * (8 * 24 + 360 + 8 * 8))


def test_share_is_least_time_over_device_time():
    cell = harness.load_cell("refscene-terrain91.orbit-1080p")
    ops = [("frame_kernel(float const*)", 0.0, 400.0),
           ("frame_kernel(float const*)", 1000.0, 1400.0)]
    obs = Obs(cell=cell, traced=trace.Traced(device_ops=ops,
                                             window_us=2000.0, steps=2))
    least = K4.work(obs.shape())[1] / peaks()["bytes_per_s"]
    assert share(obs, K4) == pytest.approx(100.0 * least / 400e-6)
    assert harness.metric_reader("K4_roofline")(obs) == share(obs, K4)
    assert harness.metric_reader("K9_roofline")(obs) is None


@pytest.mark.parametrize("cell, nbytes", [
    # 3840 x 2160 pixels x 20 B, the 61,952 faces of the 64 copies x 36 B
    ("instances64-terrain23.still-4k", 168_118_272),
    # 1920 x 1080 x 20 B, 522,242 faces x 36 B: the mesh's own faces
    ("terrain512-bvh.orbit-1080p", 60_272_712)])
def test_k9_bytes_take_the_swept_faces(cell, nbytes):
    assert K9.work(Obs(cell=harness.load_cell(cell)).shape()) == (0.0,
                                                                  nbytes)
