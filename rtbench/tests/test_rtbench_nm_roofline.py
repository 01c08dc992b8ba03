"""K1's and K6's least work, the two kernels the normal-mapped cell puts
in a lit frame, by hand at a small shape and at the cell's sizes."""

from __future__ import annotations

import pytest

from rtbench import harness, trace
from rtbench.obs import Obs
from rtbench.roofline import K1, K6, peaks

SHAPE = {"width": 4, "height": 2, "faces": 10, "spheres": 2, "bounces": 3}
CELL = "refscene-terrain91-nm.orbit-1080p"


def test_k1_bytes():
    # 8 pixels x 12 B of direction, 10 faces x 36 B, 2 spheres x 16 B,
    # 8 pixels x 28 B written (mesh t, face; sphere t, id, normal)
    assert K1.work(SHAPE) == (0.0, 8 * 12 + 360 + 32 + 8 * 28)
    assert K1.work(dict(SHAPE, spheres=0)) == (0.0, 8 * 12 + 360 + 8 * 8)


def test_k6_bytes():
    # 8 pixels x (12 u16 taps + 2 f32 weights in, 3 f32 out)
    assert K6.work(SHAPE) == (0.0, 8 * (24 + 8 + 12))


@pytest.mark.parametrize("kernel, nbytes", [
    # 1920 x 1080 x (12 B in, 28 B out), 16,200 faces x 36 B, 2 x 16 B
    (K1, 83_527_232),
    # 1920 x 1080 x 44 B
    (K6, 91_238_400)])
def test_nm_cell_bytes(kernel, nbytes):
    cell = harness.load_cell(CELL)
    assert kernel.work(Obs(cell=cell).shape()) == (0.0, nbytes)


def test_nm_rooflines_read_their_kernels():
    cell = harness.load_cell(CELL)
    ops = [("closest_hit_kernel(float const*)", 0.0, 600.0),
           ("closest_hit_perray_kernel(float const*)", 600.0, 700.0),
           ("texfilter_kernel(unsigned short const*)", 700.0, 740.0)]
    obs = Obs(cell=cell, traced=trace.Traced(device_ops=ops,
                                             window_us=1000.0, steps=1))
    bw = peaks()["bytes_per_s"]
    assert harness.metric_reader("K1_roofline")(obs) == pytest.approx(
        100.0 * 83_527_232 / bw / 600e-6)
    assert harness.metric_reader("K6_roofline")(obs) == pytest.approx(
        100.0 * 91_238_400 / bw / 40e-6)
    assert harness.metric_reader("K4_roofline")(obs) is None
