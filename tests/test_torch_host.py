"""PyTorch port: host modules against the JAX package, plus the helpers the
other test_torch_* files share.

The host modules of the port (config, camera, controllers, OBJ/MTL
import, texture decode) are copies of the JAX package's; these tests
hold them to the same results on the same inputs.

This module imports JAX only inside its tests, so the helpers serve the
kernel test files, whose card tests (marked gpu) run where JAX is not
installed.
"""

import contextlib
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rust_wgpu_raytracing_tpu_torch as pt
from rust_wgpu_raytracing_tpu_torch import config as pcfg
from rust_wgpu_raytracing_tpu_torch.core import camera as pcam
from rust_wgpu_raytracing_tpu_torch.core import controls as pctl
from rust_wgpu_raytracing_tpu_torch.io import obj as pobj

REPO = Path(__file__).resolve().parents[1]
TESTS = REPO / "tests"

# XLA's CPU code generation capped below FMA: see jax_reference()
REFERENCE_XLA_FLAGS = "--xla_cpu_max_isa=SSE4_2"

# The suite runs in several worker processes on one host; at the tests'
# small sizes torch's CPU ops gain little from more intra-op threads,
# and a full pool per worker oversubscribes the cores. Every result is
# the same at any thread count (the reductions used are exact).
torch.set_num_threads(min(2, torch.get_num_threads()))


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def jax_reference(module: str, func: str, out_dir, host_devices: int = 1,
                  **kwargs) -> dict:
    """Run `module.func(out_path, **kwargs)` (a function of a tests/
    module that computes JAX results and np.savez-es them) in a fresh
    interpreter, and return the saved arrays.

    The interpreter runs JAX on the CPU with XLA's code generation capped
    at SSE4.2. On a host with FMA, XLA's CPU backend contracts a*b+c into
    one fused multiply-add (and approximates rsqrt under AVX); neither
    the TPU kernels nor the port round that way. With the cap every XLA
    operation rounds on its own, so the port is held to BIT equality
    with the JAX package. Pallas kernels run with interpret=True, as the
    JAX package's own tests run them. host_devices > 1 gives XLA that
    many virtual CPU devices (the sharded references' meshes)."""
    out = Path(out_dir) / f"{module}.{func}.npz"
    code = (f"import sys; sys.path[:0] = [{str(REPO)!r}, {str(TESTS)!r}]; "
            "import jax; jax.config.update('jax_platforms', 'cpu'); "
            f"import {module} as m; m.{func}({str(out)!r}, **{kwargs!r})")
    flags = REFERENCE_XLA_FLAGS
    if host_devices > 1:
        flags += f" --xla_force_host_platform_device_count={host_devices}"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise AssertionError(f"JAX reference {module}.{func} failed:\n"
                             f"{res.stderr[-6000:]}")
    with np.load(out) as z:
        return dict(z)


def terrain_config(cfg_mod, grid=23, width=96, height=64, shadows=True,
                   spheres=True, accel="cull"):
    """The terrain-golden view (tools/make_goldens.py) with the
    reference's two spheres, built from `cfg_mod` (the JAX or the port
    config module)."""
    return cfg_mod.SceneConfig(
        spheres=cfg_mod.reference_scene().spheres if spheres else (),
        meshes=(cfg_mod.MeshConfig(obj_path=f"builtin:terrain:{grid}",
                                   translation=(0.0, 0.0, -3.0),
                                   light_direction=(6.0, -1.0, 1.0)),),
        camera=cfg_mod.CameraConfig(eye=(0.0, -2.0, -1.0),
                                    target=(0.0, 0.0, -3.2)),
        render=cfg_mod.RenderConfig(width=width, height=height,
                                    shadows=shadows, accel=accel))


def cube_config(cfg_mod, width=64, height=64, shadows=False):
    """builtin:cube in front of the camera with the reference spheres."""
    return cfg_mod.SceneConfig(
        spheres=cfg_mod.reference_scene().spheres,
        meshes=(cfg_mod.MeshConfig(obj_path="builtin:cube",
                                   translation=(-0.3, -0.2, -3.2),
                                   scale=0.9),),
        render=cfg_mod.RenderConfig(width=width, height=height,
                                    shadows=shadows))


def sphere_cube_config(cfg_mod, width=64, height=32):
    """tests/test_sharding.py's small scene: one sphere and builtin:cube
    under the default camera."""
    return cfg_mod.SceneConfig(
        spheres=(cfg_mod.SphereConfig(center=(0.5, 0.2, -3.0),
                                      radius=0.6),),
        meshes=(cfg_mod.MeshConfig(obj_path="builtin:cube",
                                   translation=(-0.6, 0.0, -3.0),
                                   scale=0.8),),
        camera=cfg_mod.CameraConfig(),
        render=cfg_mod.RenderConfig(width=width, height=height))


@contextlib.contextmanager
def stream_faces(n, *modules):
    """STREAM_FACES set to n in each module (core.scene and ops.megakernel
    of either package) for the block: smaller meshes stream."""
    old = [m.STREAM_FACES for m in modules]
    for m in modules:
        m.STREAM_FACES = n
    try:
        yield
    finally:
        for m, v in zip(modules, old):
            m.STREAM_FACES = v


def write_textured_assets(root, bump: bool = False) -> str:
    """Write a textured quad-on-a-box OBJ + MTL + 8x8 PNG into `root`
    and return the OBJ's name (resolve through $RWRT_ASSETS=root).
    bump=True writes bump_box.obj instead: the same box with smooth
    vertex normals and a material that adds a seeded 8x8 map_Bump PNG.
    The PNGs are written with the port's stdlib encoder, so this runs
    where PIL is not installed."""
    from rust_wgpu_raytracing_tpu_torch.io.image_out import encode_png

    def save(img, name):
        with open(os.path.join(root, name), "wb") as fh:
            fh.write(encode_png(img))

    rng = np.random.default_rng(7)
    save(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8), "checker.png")
    stem = "bump_box" if bump else "box"
    mtl = ("newmtl boxmat\nKa 0.1 0.1 0.1\nKd 0.8 0.8 0.8\n"
           "Ks 0.3 0.3 0.3\nNs 32\nmap_Kd checker.png\n")
    if bump:
        # tangent-space normals leaning around +z, as a bump map holds them
        nrm = rng.normal([0.0, 0.0, 1.0], [0.35, 0.35, 0.1], (8, 8, 3))
        nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
        save(np.round((nrm * 0.5 + 0.5) * 255).astype(np.uint8), "bump.png")
        mtl += "map_Bump bump.png\n"
    with open(os.path.join(root, f"{stem}.mtl"), "w") as fh:
        fh.write(mtl)
    pos = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
           (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
    quads = [(1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2), (2, 6, 7, 3),
             (3, 7, 8, 4), (5, 1, 4, 8)]
    lines = [f"mtllib {stem}.mtl", "o box"]
    lines += [f"v {x * 0.8} {y * 0.8} {z * 0.8 - 3.5}" for x, y, z in pos]
    lines += ["vt 0 0", "vt 1.7 0", "vt 1.7 1.3", "vt 0 1.3"]
    if bump:
        lines += [f"vn {x} {y} {z}" for x, y, z in pos]
    lines += ["usemtl boxmat"]
    if bump:
        lines += [f"f {a}/1/{a} {b}/2/{b} {c}/3/{c} {d}/4/{d}"
                  for a, b, c, d in quads]
    else:
        lines += [f"f {a}/1 {b}/2 {c}/3 {d}/4" for a, b, c, d in quads]
    with open(os.path.join(root, f"{stem}.obj"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return f"{stem}.obj"


def textured_config(cfg_mod, width=64, height=64, shadows=True,
                    bump=False):
    """The box of write_textured_assets with the reference spheres;
    bump=True: the bump-mapped box with normal mapping on."""
    return cfg_mod.SceneConfig(
        spheres=cfg_mod.reference_scene().spheres,
        meshes=(cfg_mod.MeshConfig(obj_path="bump_box.obj" if bump
                                   else "box.obj",
                                   light_direction=(1.0, -2.0, -1.0),
                                   normal_mapping=bump),),
        camera=cfg_mod.CameraConfig(eye=(0.4, 0.6, 0.5),
                                    target=(0.0, 0.0, -3.5)),
        render=cfg_mod.RenderConfig(width=width, height=height,
                                    shadows=shadows))


def write_heightfield_assets(root, n: int = 17, seed: int = 29) -> str:
    """Write a textured heightfield (n x n vertices with vt, a seeded
    16x16 map_Kd) into `root` and return the OBJ's name: a concave,
    textured surface, so bounce rays hit it again (resolve through
    $RWRT_ASSETS=root)."""
    from rust_wgpu_raytracing_tpu_torch.io.image_out import encode_png

    rng = np.random.default_rng(seed)
    u = np.linspace(0.0, 1.0, n)
    gx, gy = np.meshgrid(u, u, indexing="xy")
    x, y = (gx - 0.5) * 2.0, (gy - 0.5) * 2.0
    z = 0.35 * np.sin(3.1 * x + 0.4) * np.cos(2.3 * y - 0.2)
    lines = ["mtllib field.mtl", "o field"]
    lines += [f"v {a:.6f} {b:.6f} {c:.6f}"
              for a, b, c in zip(x.ravel(), y.ravel(), z.ravel())]
    lines += [f"vt {a * 3.0:.6f} {b * 3.0:.6f}"
              for a, b in zip(gx.ravel(), gy.ravel())]
    lines.append("usemtl fieldmat")
    for j in range(n - 1):
        for i in range(n - 1):
            a = j * n + i + 1
            b, c, d = a + 1, a + n + 1, a + n
            lines.append(f"f {a}/{a} {b}/{b} {c}/{c}")
            lines.append(f"f {a}/{a} {c}/{c} {d}/{d}")
    with open(os.path.join(root, "field.obj"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "field.mtl"), "w") as fh:
        fh.write("newmtl fieldmat\nKa 0.08 0.08 0.08\nKd 0.8 0.8 0.8\n"
                 "Ks 0.3 0.3 0.3\nNs 32\nmap_Kd field.png\n")
    kd = rng.integers(40, 256, (16, 16, 3), dtype=np.uint8)
    with open(os.path.join(root, "field.png"), "wb") as fh:
        fh.write(encode_png(kd))
    return "field.obj"


def heightfield_config(cfg_mod, width=64, height=32, spheres=True):
    """The heightfield of write_heightfield_assets seen from above at a
    slant, with the reference spheres."""
    return cfg_mod.SceneConfig(
        spheres=cfg_mod.reference_scene().spheres if spheres else (),
        meshes=(cfg_mod.MeshConfig(obj_path="field.obj",
                                   translation=(0.0, 0.0, -3.0),
                                   light_direction=(6.0, -1.0, 1.0)),),
        camera=cfg_mod.CameraConfig(eye=(0.0, -1.6, -1.4),
                                    target=(0.0, 0.0, -3.1)),
        render=cfg_mod.RenderConfig(width=width, height=height))


def port_config(jax_cfg):
    """The port's SceneConfig equal to a JAX SceneConfig (via JSON)."""
    return pcfg.SceneConfig.from_json(jax_cfg.to_json())


def jax_config(port_cfg):
    """The JAX package's SceneConfig equal to a port SceneConfig."""
    from rust_wgpu_raytracing_tpu import config as jcfg

    return jcfg.SceneConfig.from_json(port_cfg.to_json())


def u8_levels(color):
    """Linear u8 levels of a (H,W,3) f32 frame (the frame bar's domain)."""
    if isinstance(color, torch.Tensor):
        color = color.numpy()
    return np.round(np.clip(np.asarray(color), 0, 1) * 255).astype(np.int32)


def assert_frame_bar(a, b):
    """At most 1 linear u8 level apart, at least 99.9% of subpixels
    exact (tests/test_goldens.py)."""
    diff = np.abs(u8_levels(a) - u8_levels(b))
    assert diff.max() <= 1, f"max linear u8 delta {diff.max()}"
    assert (diff == 0).mean() >= 0.999, f"exact frac {(diff == 0).mean()}"


@pytest.fixture
def cuda_device():
    """The card, or a skip when torch sees none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# host module parity
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_host():
    """The JAX package's host modules (config, camera, controls, obj)."""
    from rust_wgpu_raytracing_tpu import config
    from rust_wgpu_raytracing_tpu.core import camera, controls
    from rust_wgpu_raytracing_tpu.io import obj

    return config, camera, controls, obj

def test_config_json_roundtrip_matches_jax(jax_host):
    jcfg = jax_host[0]
    cfg = terrain_config(jcfg)
    pc = port_config(cfg)
    assert pc.to_json() == cfg.to_json()
    assert pcfg.SceneConfig.from_json(pc.to_json()) == pc
    assert pcfg.reference_scene(320, 200).to_json() == \
        jcfg.reference_scene(320, 200).to_json()


def test_resolve_asset_uses_env(tmp_path, monkeypatch):
    (tmp_path / "thing.obj").write_text("v 0 0 0\n")
    monkeypatch.setenv("RWRT_ASSETS", str(tmp_path))
    assert pcfg.resolve_asset("thing.obj") == str(tmp_path / "thing.obj")
    with pytest.raises(FileNotFoundError):
        pcfg.resolve_asset("missing.obj")


@pytest.mark.parametrize("eye,target,aspect", [
    ((0.0, 0.0, 0.0), (0.0, 0.0, -1.0), 1.0),
    ((0.0, -2.0, -1.0), (0.0, 0.0, -3.2), 16 / 9),
    ((1.5, 0.7, 2.5), (0.1, -0.2, -3.0), 0.75),
])
def test_camera_uniforms_match_jax(jax_host, eye, target, aspect):
    jcfg, jcam = jax_host[:2]
    jc = jcam.Camera.from_config(jcfg.CameraConfig(eye=eye, target=target),
                                 aspect)
    pc = pcam.Camera.from_config(pcfg.CameraConfig(eye=eye, target=target),
                                 aspect)
    np.testing.assert_array_equal(pc.uniforms().flat(), jc.uniforms().flat())
    u = pcam.CameraUniforms.unflat(pc.uniforms().flat())
    np.testing.assert_array_equal(u.origin, jc.uniforms().origin)


@pytest.mark.parametrize("keys", [("d",), ("a", "w"), ("s", "d")])
def test_controller_matches_jax(jax_host, keys):
    jcfg, jcam, jctl = jax_host[:3]
    jc = jcam.Camera.from_config(jcfg.CameraConfig(eye=(0.0, 0.5, 2.5)), 1.0)
    pc = pcam.Camera.from_config(pcfg.CameraConfig(eye=(0.0, 0.5, 2.5)), 1.0)
    jk, pk = jctl.CircleCameraController(), pctl.CircleCameraController()
    for k in keys:
        assert jk.process_key(k, True) and pk.process_key(k, True)
    for _ in range(7):
        jk.update_camera(jc)
        pk.update_camera(pc)
    np.testing.assert_array_equal(pc.eye, jc.eye)


@pytest.mark.parametrize("n", [2, 23, 91])
def test_builtin_meshes_match_jax(jax_host, n):
    jobj = jax_host[3]
    jt, pt_ = jobj.make_terrain(n), pobj.make_terrain(n)
    for f in ("positions", "uvs", "normals", "faces"):
        np.testing.assert_array_equal(getattr(pt_, f), getattr(jt, f))
    jc, pc = jobj.make_cube(), pobj.make_cube()
    np.testing.assert_array_equal(pc.positions, jc.positions)
    np.testing.assert_array_equal(pc.faces, jc.faces)


def test_obj_parser_matches_jax(jax_host, tmp_path):
    jobj = jax_host[3]
    name = write_textured_assets(str(tmp_path))
    path = str(tmp_path / name)
    jm, jmat = jobj.load_obj(path, use_native=False)
    pm, pmat = pobj.load_obj(path, use_native=False)
    assert [m.name for m in pm] == [m.name for m in jm]
    assert [dataclasses.asdict(m) for m in pmat] == \
        [dataclasses.asdict(m) for m in jmat]
    for a, b in zip(pm, jm):
        for f in ("positions", "uvs", "normals", "faces"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.material_id == b.material_id


def test_package_exports():
    assert pt.Renderer is pt.runtime.renderer.Renderer
    assert dataclasses.is_dataclass(pt.SceneData)
