"""PyTorch port: the native host library (native/rtnative.cpp, built with
g++ into build/native/) against the JAX package's native library and
against the port's own Python/NumPy paths.

Every case is bitwise: the Morton codes, the radix argsort (stable), the
LBVH's left/right/parent/node_lo/node_hi at 1, 2, 100 and 5,000 leaves,
the OBJ parser on files written into tmp_path (quads, negative indices,
several groups and materials; a missing file raises), and Scene.build's
bvh_pack on builtin:terrain:23 against the JAX package's Scene.build,
which also takes its native builder. RWRT_NO_NATIVE=1 turns the library
off: the callers take their Python/NumPy path and give the same arrays.
The tests skip only where g++ is absent.
"""

import fcntl
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from rust_wgpu_raytracing_tpu_torch import native as nat
from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
from rust_wgpu_raytracing_tpu_torch.io import obj as pobj
from rust_wgpu_raytracing_tpu_torch.ops import bvh
from test_torch_host import REPO, port_config, terrain_config

TREE_FIELDS = ("left", "right", "parent", "node_lo", "node_hi")


def whole_jax_native(native) -> None:
    """Build the JAX package's native library with its own make, under a
    file lock, and wait until it loads. That make writes the library in
    place, so where pytest workers start together one of them can load
    the file while another is still writing it; its loader then gives up
    for good in that process, so it is let try again here."""
    if shutil.which("make") is None:
        return
    lock_dir = REPO / "build"
    lock_dir.mkdir(exist_ok=True)
    load = "import ctypes, sys; ctypes.CDLL(sys.argv[1])"
    with open(lock_dir / ".jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(60):
            subprocess.run(["make", "-C", os.path.dirname(native._LIB_PATH),
                            "-s"], capture_output=True, timeout=300)
            if subprocess.run([sys.executable, "-c", load, native._LIB_PATH],
                              capture_output=True).returncode == 0:
                break
            time.sleep(1)
    if native._lib is None:
        native._tried = False


@pytest.fixture(scope="module")
def jnat():
    """The JAX package's native bindings, its library available."""
    if shutil.which("g++") is None:
        pytest.skip("g++ absent: no native library to build")
    from rust_wgpu_raytracing_tpu import native

    whole_jax_native(native)
    assert native.available()
    return native


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ absent: no native library to build")
    assert nat.available()
    return nat


def sorted_leaves(n, seed):
    """Sorted Morton codes of n seeded points (every fourth point moved
    onto the first, so codes repeat) and their boxes."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 3, (n, 3)).astype(np.float32)
    pts[::4] = pts[0]
    pts = pts[np.argsort(bvh.morton3d(pts), kind="stable")]
    return bvh.morton3d(pts), pts - 0.01, pts + 0.03


def test_library_builds_into_build_native(lib):
    path = nat.library_path()
    assert os.path.exists(path)
    assert os.path.dirname(path) == str(REPO / "build" / "native")
    assert not any(f.endswith(".so") for f in os.listdir(
        os.path.dirname(nat.__file__)))


@pytest.mark.parametrize("n", [1, 7, 500, 20000])
def test_morton3d_matches_jax_and_numpy(lib, jnat, n):
    rng = np.random.default_rng(n)
    pts = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    got = lib.morton3d_native(pts)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jnat.morton3d_native(pts))
    np.testing.assert_array_equal(got, bvh.morton3d(pts))


@pytest.mark.parametrize("n,dups", [(1, False), (2000, False),
                                    (3000, True)])
def test_radix_argsort_matches_jax_and_stable_argsort(lib, jnat, n, dups):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 2**30 if not dups else 16, n).astype(np.uint32)
    got = lib.radix_argsort_native(codes)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jnat.radix_argsort_native(codes))
    np.testing.assert_array_equal(got, np.argsort(codes, kind="stable"))


@pytest.mark.parametrize("n", [1, 2, 100, 5000])
def test_lbvh_matches_jax_native_and_numpy(lib, jnat, n):
    codes, lo, hi = sorted_leaves(n, 40 + n)
    got = bvh.build_lbvh(codes, lo, hi)
    numpy_build = bvh.build_lbvh(codes, lo, hi, use_native=False)
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(numpy_build, name), name)
    if n > 1:  # the builders take one leaf without the library
        want = jnat.lbvh_build_native(codes, lo, hi)
        mine = lib.lbvh_build_native(codes, lo, hi)
        for name, a, b in zip(TREE_FIELDS, mine, want):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, name)
            np.testing.assert_array_equal(a, getattr(got, name), name)
    np.testing.assert_array_equal(bvh.linearize_bvh(got),
                                  bvh.linearize_bvh(numpy_build))


OBJS = {
    "quad_negative": ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                      "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                      "f -4/-4 -3/-3 -2/-2 -1/-1\n"),
    "pentagon_normals": ("v 0 0 0\nv 2 0 0\nv 2.5 1.5 0\nv 1 2.25 0\n"
                         "v -0.5 1.5 0\nvn 0 0 1\n"
                         "f 1//1 2//1 3//1 4//1 5//1\nf 1//1 3//1 5//1\n"),
    "groups_materials": ("mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                         "v 1 1 0.5\nv 0 0 1\no first\nusemtl red\n"
                         "f 1 2 3\nf 2 4 3\ng second\nusemtl blue\n"
                         "f 1 3 5\nusemtl red\nf 3 4 5\n"),
    "one_group_two_materials": ("mtllib m.mtl\nv 0 0 0\nv 1 0 0\n"
                                "v 0 1 0\nv 1 1 0\nusemtl blue\n"
                                "f 1 2 3\nusemtl red\nf 2 4 3\n"),
}
MTL = ("newmtl red\nKd 1 0 0\nKa 0.1 0.1 0.1\n"
       "newmtl blue\nKd 0 0 1\nKs 0.5 0.5 0.5\nNs 8\n")


def write_obj(tmp_path, name):
    (tmp_path / "m.mtl").write_text(MTL)
    path = tmp_path / f"{name}.obj"
    path.write_text(OBJS[name])
    return str(path)


def mesh_arrays(meshes):
    return [(m.positions, m.uvs, m.normals, m.faces, m.material_id)
            for m in meshes]


def assert_same_meshes(a, b):
    (ma, mat_a), (mb, mat_b) = a, b
    assert [m.name for m in mat_a] == [m.name for m in mat_b]
    assert len(ma) == len(mb)
    for x, y in zip(mesh_arrays(ma), mesh_arrays(mb)):
        for u, v in zip(x[:4], y[:4]):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
        assert x[4] == y[4]


@pytest.mark.parametrize("name", sorted(OBJS))
def test_obj_parser_matches_jax_native_and_python(lib, jnat, tmp_path, name):
    from rust_wgpu_raytracing_tpu.io import obj as jobj

    path = write_obj(tmp_path, name)
    got = pobj.load_obj(path)
    assert_same_meshes(got, jobj.load_obj(path))
    python = pobj.load_obj(path, use_native=False)
    assert_same_meshes(got, python)
    raw = lib.obj_parse_native(path)
    for a, b in zip(raw[:6], jnat.obj_parse_native(path)[:6]):
        np.testing.assert_array_equal(a, b)
    assert raw[6:] == jnat.obj_parse_native(path)[6:]
    single = len(raw[5]) == 1 and len(np.unique(raw[4])) <= 1
    # the native parser serves single-group, single-material files; the
    # others take the Python path
    assert (got[0][0].name == f"{name}.obj") == single
    if not single:
        with pytest.raises(RuntimeError):
            pobj.load_obj(path, use_native=True)


def test_missing_obj_raises(lib):
    with pytest.raises(ValueError):
        lib.obj_parse_native("/nonexistent/file.obj")
    with pytest.raises((ValueError, FileNotFoundError)):
        pobj.load_obj("/nonexistent/file.obj")
    with pytest.raises(RuntimeError):
        pobj.load_obj("/nonexistent/file.obj", use_native=True)


def test_scene_bvh_pack_matches_jax():
    from rust_wgpu_raytracing_tpu import config as jcfg
    from rust_wgpu_raytracing_tpu.core.scene import Scene as JScene

    jc = terrain_config(jcfg, grid=23)
    data = Scene.build(port_config(jc)).data
    jd = JScene.build(jc).data
    assert data.bvh_nodes == jd.bvh_nodes > 1
    np.testing.assert_array_equal(data.bvh_pack.numpy(),
                                  np.asarray(jd.bvh_pack))


def test_no_native_env_takes_the_numpy_build(tmp_path):
    """RWRT_NO_NATIVE=1 in a fresh interpreter: no library, the same
    tree from the NumPy build."""
    code = (
        "import sys, numpy as np\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from rust_wgpu_raytracing_tpu_torch import native as nat\n"
        "from rust_wgpu_raytracing_tpu_torch.ops import bvh\n"
        "assert not nat.available()\n"
        "assert nat.lbvh_build_native(np.zeros(3, np.uint32), "
        "np.zeros((3, 3), np.float32), np.ones((3, 3), np.float32)) is None\n"
        "rng = np.random.default_rng(5)\n"
        "p = rng.uniform(size=(300, 3)).astype(np.float32)\n"
        "p = p[np.argsort(bvh.morton3d(p), kind='stable')]\n"
        "t = bvh.build_lbvh(bvh.morton3d(p), p, p + 0.1)\n"
        f"np.save({str(tmp_path / 'pack.npy')!r}, bvh.linearize_bvh(t))\n")
    env = dict(os.environ, RWRT_NO_NATIVE="1")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    rng = np.random.default_rng(5)
    p = rng.uniform(size=(300, 3)).astype(np.float32)
    p = p[np.argsort(bvh.morton3d(p), kind="stable")]
    want = bvh.linearize_bvh(bvh.build_lbvh(bvh.morton3d(p), p, p + 0.1))
    np.testing.assert_array_equal(np.load(tmp_path / "pack.npy"), want)
