"""The tensors the sweeps and frames derive from a SceneData alone, each
built once per SceneData object, with the operations in the order the
sweeps used to build them (bitwise the same).

The cache lives on the object, not in a dataclass field (`tensors()`,
`.to()` and the checkpoint format stay as they are): a new object
(`dataclasses.replace`, `.to`, a refit, a shard) starts empty, and code
that writes a scene's tensors in place must make a new SceneData. A
first request inside a CUDA graph capture raises, since capture runs no
kernel: the Renderer draws a frame eagerly before it captures it.
"""

from __future__ import annotations

import functools

import torch

from ..core.scene import GPACK_SRC_COLS, SC_DC, STREAM_COLS, SUPER_F, SceneData
from .rounding import sqrt

F32_INF = float("inf")


def _per_scene(build):
    """build(scene, *args), computed once per SceneData object and args."""
    @functools.wraps(build)
    def get(scene: SceneData, *args):
        cache = vars(scene).setdefault("_scene_packs", {})
        key = (build.__name__, *args)
        if key not in cache:
            if scene.tri_n.is_cuda and \
                    torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"scene constant {build.__name__} first requested "
                    f"inside a CUDA graph capture: run the frame eagerly "
                    f"once before capturing it")
            cache[key] = build(scene, *args)
        return cache[key]
    return get


@_per_scene
def pack_face_columns(scene: SceneData) -> torch.Tensor:
    """(F, 40) f32 per-face static pack, the JAX kernels' layout. The
    sweep kernels read columns 0-11 (N and the edge planes g0-g2)."""
    f = scene.tri_p0.shape[0]
    n = scene.tri_n
    nlen = sqrt(n[:, 0:1] * n[:, 0:1] + n[:, 1:2] * n[:, 1:2]
                + n[:, 2:3] * n[:, 2:3])
    un = torch.where(nlen > 0, n / torch.where(nlen > 0, nlen, 1.0), 0.0)
    cols = [
        n,  # 0-2
        scene.tri_g.reshape(f, 9),  # 3-11
        scene.tri_inv_denom[:, None],  # 12
        un,  # 13-15
        scene.tri_uv.reshape(f, 6),  # 16-21
        scene.tri_mat.to(torch.float32)[:, None],  # 22
        scene.tri_orig.to(torch.float32)[:, None],  # 23
        scene.tri_tangent,  # 24-26
        scene.tri_bitangent,  # 27-29
        scene.tri_vn.reshape(f, 9),  # 30-38
        torch.zeros((f, 1), dtype=torch.float32, device=n.device),  # 39 pad
    ]
    return torch.cat(cols, dim=1)


@_per_scene
def pack_plane_consts(scene: SceneData) -> torch.Tensor:
    """(F, 8) [d, c0, c1, c2, 0...]: the plane constants `dc` of the
    per-ray-origin sweeps and the frame kernel."""
    f = scene.tri_d.shape[0]
    return torch.cat([scene.tri_d[:, None], scene.tri_c,
                      torch.zeros((f, 4), dtype=torch.float32,
                                  device=scene.tri_d.device)], dim=1)


def pack_stream_columns(scene: SceneData) -> torch.Tensor:
    """The streaming record built from the scene's tensors in one shot
    (JAX pack_stream_columns): pack_face_columns' 40 columns, then
    [d, c0, c1, c2] at SC_DC, then zeros. JAX also keeps a chunked twin
    (pack_stream_columns_chunked) because the one-shot build's narrow
    operands pad to the TPU's (8, 128) tiles and ran out of memory at 2M
    faces; here the record is (F, 128) f32 and nothing more (1 GB at 2M
    faces on an 80 GB card), and the values are the same."""
    f = scene.padded_faces
    return torch.cat([pack_face_columns(scene), scene.tri_d[:, None],
                      scene.tri_c,
                      torch.zeros((f, STREAM_COLS - SC_DC - 4),
                                  dtype=torch.float32,
                                  device=scene.tri_d.device)], dim=1)


_GPACK_COLS = {}  # device -> GPACK_SRC_COLS as an int64 tensor there


def gpack_from_stream(spack: torch.Tensor) -> torch.Tensor:
    """The (GPACK_ROWS, F) winner-attribute table derived from a full
    streaming record (JAX gpack_from_stream), in one gather. The column
    indices go to the device once: a copy from pageable host memory at
    each call made the host wait for the card, once a frame in an
    instanced refit."""
    cols = _GPACK_COLS.get(spack.device)
    if cols is None:
        cols = _GPACK_COLS[spack.device] = torch.tensor(
            GPACK_SRC_COLS, dtype=torch.int64, device=spack.device)
    return spack.index_select(1, cols).t().contiguous()


@_per_scene
def stream_pack(scene: SceneData) -> torch.Tensor:
    """The (F, STREAM_COLS) streaming record (JAX _stream_pack):
    SceneData.spack when it covers the scene's faces (Scene.build past
    STREAM_FACES, an instanced refit), else built from the scene's
    tensors (a small scene forced onto the streamed path)."""
    if scene.spack.shape[0] == scene.padded_faces:
        return scene.spack
    return pack_stream_columns(scene)


@_per_scene
def winner_table(scene: SceneData) -> torch.Tensor:
    """The winner-attribute table (JAX _gpack_stream): SceneData.gpack
    when it covers the scene's faces, else derived from the streaming
    record. Every reader of the table goes through here, so a stale
    table (one whose width is not padded_faces) is rebuilt, never
    indexed."""
    if scene.gpack.shape[1] == scene.padded_faces:
        return scene.gpack
    return gpack_from_stream(stream_pack(scene))


@_per_scene
def cluster_boxes(scene: SceneData):
    """(blo, bhi, lo, hi): the cluster AABBs (clusters, 3) f32 with
    padding clusters turned into empty boxes (+inf / -inf), and their
    union, the root box (3,) f32."""
    finite = torch.isfinite(scene.blk_lo) & torch.isfinite(scene.blk_hi)
    blo = torch.where(finite, scene.blk_lo, F32_INF)
    bhi = torch.where(finite, scene.blk_hi, -F32_INF)
    return blo, bhi, blo.amin(dim=0), bhi.amax(dim=0)


@_per_scene
def super_boxes(scene: SceneData):
    """(slo, shi) (S, 3) f32: each 1024-face superblock's union of its
    cluster boxes, padding empty (JAX _super_aabbs)."""
    n_super = scene.padded_faces // SUPER_F
    blo, bhi, _, _ = cluster_boxes(scene)
    return (blo.reshape(n_super, -1, 3).amin(dim=1),
            bhi.reshape(n_super, -1, 3).amax(dim=1))


@_per_scene
def block_boxes(scene: SceneData, block_f: int):
    """(lo, hi) (F / block_f, 3) f32: each face block's box, the union
    of the cluster AABBs it holds (a block holds whole clusters: K8's
    blocks are the clusters, the streamed sweeps' 32-face blocks hold one
    cluster or four 8-face ones), for the per-ray culling of K1, K3, K4
    and K7-K11."""
    k = block_f * scene.blk_lo.shape[0] // scene.padded_faces
    if k == 1:
        return scene.blk_lo, scene.blk_hi
    return (scene.blk_lo.reshape(-1, k, 3).amin(dim=1),
            scene.blk_hi.reshape(-1, k, 3).amax(dim=1))


@_per_scene
def _frame_const_tail(scene: SceneData) -> torch.Tensor:
    blo, bhi, lo, hi = cluster_boxes(scene)
    parts = [lo, hi]
    if scene.num_spheres:
        parts.append(torch.cat(
            [scene.sphere_center, scene.sphere_radius[:, None],
             scene.sphere_color, scene.sphere_coeff, scene.sphere_light],
            dim=1).reshape(-1))
    parts.append(scene.mat_light.reshape(-1))
    parts.append(torch.cat([blo, bhi], dim=1).reshape(-1))
    ld = scene.mat_light[0]
    ln = sqrt((ld * ld).sum())
    sdir = -ld / torch.where(ln > 0, ln, 1.0)
    proj = ((blo + bhi) * 0.5 * sdir[None, :]).sum(dim=1)
    proj = torch.where(torch.isfinite(proj), proj, F32_INF)  # empty last
    parts.append(torch.argsort(proj, stable=True).to(torch.float32))
    return torch.cat(parts)


def frame_const(scene: SceneData, origin: torch.Tensor) -> torch.Tensor:
    """The frame kernel's const vector (kernels/frame.py docstring):
    origin, root AABB, 13 floats per sphere, the material lights, the
    cluster AABBs (empty clusters +inf / -inf) and the static
    near-to-far cluster order along material 0's light, as floats. The
    order only decides how early the in-kernel shadow loop meets
    occluders: any order gives the same frame. All but the origin is the
    scene's, built once."""
    return torch.cat([origin.reshape(3), _frame_const_tail(scene)])
