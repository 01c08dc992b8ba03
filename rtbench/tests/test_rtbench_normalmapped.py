"""The normal-mapped scene kind (rtbench/scenes/normalmapped.py) and its
reference (normalmapped_ref.py) on the CPU, at tiny sizes: a 12x12
heightfield with a 64x64 normal map at 64x48, where every kernel wrapper
takes its plain PyTorch version.

The reference and the port's plain path agree on every pixel; a program
that draws without the normal map, or the reference that shades the flat
normal, reads above the cell's limit, so the reference sees the map; and
a tiny run decides `correct` true, and false with the bump map flattened
in the program's assets. The sensitivity cases light the mesh from the
camera's side (OVERHEAD), where the map shows on most of its pixels; the
cell's own light grazes the mesh (PERF.md §4).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from rtbench import check, harness, run, traffic
from rtbench.reference import frame as ref_frame
from rtbench.reference import scene as ref_scene
from rtbench.scenes import normalmapped, normalmapped_ref
from rtbench.tests import tiny
from rtbench.tests.test_rtbench_imports import JAX_SIDE, PORT, _top_names

CELL = "refscene-terrain91-nm.orbit-1080p"
LIMIT = harness.load_json(os.path.join(harness.HERE, "limits",
                                       CELL + ".json"))["bad_px_share"]
OVERHEAD = (0.2, -0.3, -1.0)  # toward the mesh, which faces +z
SEEDS = (2**31 + 91, 123456789)


def nm_config(light=None, grid=12, bump=64):
    cfg = copy.deepcopy(harness.load_json(os.path.join(
        harness.HERE, "configs", "refscene-terrain91-nm.json")))
    cfg["name"] = "tiny-nm"
    cfg["scene"]["mesh"].update(grid=grid, texture_size=16,
                                texture_cells=4, bump_size=bump)
    if light is not None:
        cfg["scene"]["mesh"]["light_direction"] = list(light)
    cfg["faces"] = 2 * (grid - 1) ** 2
    return cfg


def still_mix():
    """The tiny lit mix without a key or a seeded start: every frame
    from the configuration's camera, which sees the mesh's lit face."""
    mix = tiny.tiny_mix("tiny-still", script=[{"keys": [], "steps": 1}])
    del mix["start"]
    return mix


def _frame(cfg, seed, tmp_path, normal_mapping=True, mix=None):
    """(inputs, camera, presented codes (H*W, 3), xs, ys) of the plain
    path's first frame of `cfg` from the start of `mix` (the tiny lit
    mix, whose start the seed turns round the mesh)."""
    from rust_wgpu_raytracing_tpu_torch import Renderer

    mix = mix or tiny.tiny_mix("tiny-orbit")
    inputs = normalmapped.make_inputs(cfg, seed)
    directory = str(tmp_path / f"assets{seed}")
    assets = normalmapped.write_assets(inputs, directory)
    replay = traffic.Replay(mix, cfg, seed)
    sc = normalmapped.program_config(cfg, mix, replay.start, assets, seed)
    if not normal_mapping:
        sc = dataclasses.replace(sc, meshes=tuple(
            dataclasses.replace(m, normal_mapping=False) for m in sc.meshes))
    old = os.environ.get("RWRT_ASSETS")
    os.environ["RWRT_ASSETS"] = directory
    try:
        r = Renderer(sc, device="cpu")
        color, _ = r.render()
    finally:
        if old is None:
            del os.environ["RWRT_ASSETS"]
        else:
            os.environ["RWRT_ASSETS"] = old
    h, w = mix["height"], mix["width"]
    ys, xs = np.mgrid[0:h, 0:w]
    xs, ys = xs.ravel(), ys.ravel()
    codes = check.present_codes(color.numpy()[ys, xs])
    return inputs, replay.start, codes, xs, ys


def _nm_reference(cfg, inputs, cam, xs, ys):
    return normalmapped.reference_lit(
        normalmapped.reference_scene(inputs, 0, device="cpu"), cam,
        torch.as_tensor(xs), torch.as_tensor(ys), width=64, height=48,
        render=cfg["render"])


def _flatten_bump(directory):
    """Overwrite bump.png with the flat normal (0, 0, 1) everywhere."""
    from rtbench import scenegen

    flat = np.zeros((8, 8, 3), np.uint8) + np.array([128, 128, 255],
                                                    np.uint8)
    with open(os.path.join(directory, "bump.png"), "wb") as fh:
        fh.write(scenegen.encode_png(flat))


@pytest.mark.parametrize("module", [normalmapped, normalmapped_ref],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_kind_and_reference_take_nothing_of_the_program(module):
    # the kind names the port's config classes only through
    # rtbench/scenes/__init__.py, and its reference imports rtbench alone
    assert not _top_names(module.__file__) & (JAX_SIDE | {PORT})


@pytest.mark.parametrize("light", [None, OVERHEAD], ids=["own", "overhead"])
@pytest.mark.parametrize("seed", SEEDS)
def test_plain_path_matches_the_reference(tmp_path, light, seed):
    cfg = nm_config(light)
    inputs, cam, codes, xs, ys = _frame(cfg, seed, tmp_path)
    ref = _nm_reference(cfg, inputs, cam, xs, ys)
    assert check.bad_share(codes, ref, quantized=True) == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_sees_the_normal_map(tmp_path, seed):
    cfg = nm_config(OVERHEAD)
    inputs, cam, codes, xs, ys = _frame(cfg, seed, tmp_path, mix=still_mix())
    ref = _nm_reference(cfg, inputs, cam, xs, ys)
    assert check.bad_share(codes, ref, quantized=True) == 0.0
    # the same program without normal mapping, against this reference
    _, _, plain, _, _ = _frame(cfg, seed, tmp_path, normal_mapping=False,
                               mix=still_mix())
    assert check.bad_share(plain, ref, quantized=True) > LIMIT
    # the normal-mapped program against the heightfield kind's reference
    flat = ref_frame.lit_pixels(
        ref_scene.build(inputs, device="cpu"), cam, torch.as_tensor(xs),
        torch.as_tensor(ys), width=64, height=48, shadows=True)
    assert check.bad_share(codes, flat, quantized=True) > LIMIT


def test_assets_load_with_a_bump_map(tmp_path, monkeypatch):
    from rust_wgpu_raytracing_tpu_torch.core.scene import Scene

    cfg = nm_config()
    inputs = normalmapped.make_inputs(cfg, 7)
    assets = normalmapped.write_assets(inputs, str(tmp_path))
    with open(tmp_path / "mesh.mtl") as fh:
        mtl = fh.read()
    assert "map_Kd albedo.png\n" in mtl and "map_Bump bump.png\n" in mtl
    monkeypatch.setenv("RWRT_ASSETS", str(tmp_path))
    sc = normalmapped.program_config(cfg, tiny.tiny_mix("m"),
                                     traffic.Replay(tiny.tiny_mix("m"), cfg,
                                                    7).start, assets, 7)
    assert all(m.normal_mapping for m in sc.meshes)
    assert sc.render.variant == "split" and sc.render.shadows
    data = Scene.build(sc).data
    assert int(data.mat_bump_base[0]) >= 0
    assert (float(data.mat_bump_h[0]), float(data.mat_bump_w[0])) == (64, 64)
    assert data.tex_packed_bump.shape == (12, 64 * 64)


def test_normal_map_depends_on_the_seed_alone():
    cfg = nm_config(bump=128)
    a, b = (normalmapped.make_inputs(cfg, 2**33 + 5) for _ in range(2))
    c = normalmapped.make_inputs(cfg, 2**33 + 6)
    assert a.bump_u8.shape == (128, 128, 3) and a.bump_u8.dtype == np.uint8
    assert np.array_equal(a.bump_u8, b.bump_u8)
    assert not np.array_equal(a.bump_u8, c.bump_u8)
    # the texels' tilt from the surface normal: most lie in 10-35 degrees
    n = a.bump_u8.astype(np.float64) / 255.0 * 2.0 - 1.0
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    tilt = np.degrees(np.arccos(n[..., 2]))
    assert ((tilt >= 10) & (tilt <= 35)).mean() > 0.7


def test_reference_scene_is_built_once_per_device_and_dtype():
    inputs = normalmapped.make_inputs(nm_config(), 3)
    f32 = normalmapped.reference_scene(inputs, 0, device="cpu")
    assert normalmapped.reference_scene(inputs, 9, device="cpu") is f32
    bf16 = normalmapped.reference_scene(inputs, 0, device="cpu",
                                        dtype=torch.bfloat16)
    assert bf16 is not f32 and bf16.dtype == torch.bfloat16
    assert bf16.bump.dtype == bf16.tangent.dtype == torch.bfloat16
    assert isinstance(f32, normalmapped_ref.NMScene)
    # every face of the grid has a sound tangent frame
    assert torch.allclose(f32.tangent.norm(dim=-1), torch.ones(1))
    assert torch.allclose(f32.bitangent.norm(dim=-1), torch.ones(1))


def test_tangent_frame_is_zero_on_degenerate_uvs():
    pos = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    faces = torch.tensor([[0, 1, 2]])
    t, b = normalmapped_ref.tangent_frame(
        pos, torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]), faces)
    assert torch.equal(t, torch.tensor([[1.0, 0.0, 0.0]]))
    assert torch.equal(b, torch.tensor([[0.0, 1.0, 0.0]]))
    t, b = normalmapped_ref.tangent_frame(pos, torch.zeros(3, 2), faces)
    assert torch.equal(t, torch.zeros(1, 3)) and torch.equal(b,
                                                             torch.zeros(1, 3))


def _tiny_nm_cell(tmp_path):
    """still_mix() over nm_config(OVERHEAD) as a cell of a tiny
    benchmark root, at the real cell's limit; returns (root, cell)."""
    root = tiny.make_root(tmp_path)
    tiny.write(root, "rtbench/workloads/tiny-still.json", still_mix())
    tiny.write(root, "rtbench/configs/tiny-nm.json", nm_config(OVERHEAD))
    bench = harness.load_benchmark(root)
    bench["configs"].append({"name": "tiny-nm", "source": "a test",
                             "file": "rtbench/configs/tiny-nm.json",
                             "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": "tiny-nm.orbit", "config": "tiny-nm",
                               "traffic": "tiny-still", "chips": 1,
                               "why": "a CPU test"})
    tiny.write(root, "BENCHMARK.json", bench)
    tiny.write(root, "rtbench/limits/tiny-nm.orbit.json",
               {"bad_px_share": LIMIT})
    return root, harness.load_cell("tiny-nm.orbit", root)


@pytest.mark.parametrize("flat_bump, correct", [(False, True), (True, False)])
def test_tiny_cell_decides_correct(tmp_path, flat_bump, correct):
    root, cell = _tiny_nm_cell(tmp_path)
    assert cell.scene.reference_lit is normalmapped_ref.lit_pixels
    if flat_bump:
        write = cell.scene.write_assets

        def write_flat(inputs, directory):
            name = write(inputs, directory)
            _flatten_bump(directory)
            return name
        cell.scene.write_assets = write_flat
    res, _ = run.run_cell(cell, seed=2**31 + 93, seconds=1.0, trace=False,
                          device="cpu", t_start=time.perf_counter(),
                          root=root)
    assert res["correct"] is correct, res["checks"]
    assert res["checks"]["frames_checked"]["value"] >= 1
    if correct:
        assert res["checks"]["bad_px_share"]["value"] == 0.0
