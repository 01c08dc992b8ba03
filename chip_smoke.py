#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — Renderer(cfg, device="cuda") with the
default variant="auto", which times the fused frame against the split
frame and keeps the faster, at 1920x1080 with shadows — and each frame
program on its own, and checks them:

1. environment: the card (nvidia-smi name and power limit), torch and
   CUDA versions, nvcc, whether triton imports;
2. build: the CUDA kernels from rust_wgpu_raytracing_tpu_torch/csrc
   (one nvcc per source, in parallel, linked into one shared library in
   the git-ignored build/kernels/); ptxas's registers and spills, and
   the per-ray culled walks' (K1, K3, K7-K11), K4's (per mode) and K5's
   registers, spills, shared memory and blocks an SM;
3. each kernel against its plain PyTorch version on the card, on the
   very arguments the 1080p frames give it: closest hit, texshade and
   any-hit from the split frame (K1 and K3 also without their boxes;
   K1's t bitwise, the sign of a zero t included), the frame kernel
   (sched branch) from
   the fused frame, at the smoke and the dense view (also without its
   boxes, sched and in-kernel) and at the Renderer's orbit frames 4-8
   (the frames --profile profiles); the frame kernel's
   nm branch and the texture filter from the normal-mapped fused frame,
   the texture filter also from the normal-mapped split frame and on
   seeded random u16 taps (texshade too: the smoke mesh's texture is
   solid white), and both on texels past 2^24 in a ~400 MB pool
   (testing.texels.far_texel_case: each ray's taps at its int64 address).
   Every plane equal by value (texshade and the texture filter within 0
   ulp). The frame kernel's in-kernel shadow branch against the sched
   branch: occlusion equal, unquantized frames equal;
4. the paths through the Renderer, each run with the launch counters
   set to 0 just before it and read just after, each needing every
   kernel it uses launched (and the fused path none of the closest-hit
   sweep, the split path none of the frame kernel): auto (3 warm-up +
   12 frames with the orbit key held; variant_ms and variant_chosen
   printed), fused and split (3 warm-up + 12 frames each: medians and
   Mrays/s), and a normal-mapped heightfield built at run time (map_Kd
   and map_Bump PNGs from a numpy seed, written with the port's stdlib
   PNG writer) rendered fused without shadows and split with shadows.
   Each last frame against the same frame composed from the plain
   versions, bitwise; fused against split at the same camera (the count
   of differing quantized subpixels printed, the frame bar held: at most
   1 linear u8 level, >= 99.9% exact); the 160x160 terrain frame through
   both programs against the committed golden
   tests/goldens/terrain_shadows.png at the same bar;
5. the progressive path tracer (BASELINE config 4's path at the
   heightfield: 4 bounces, 1920x1080): the per-ray closest hit (K7) and
   the fused extend+shadow sweep (K8) against their plain versions on
   the bounce-1 wavefront of a traced sample (both also without their
   boxes), the any-hit kernel on the last bounce's act-aware arguments
   and the closest hit on the primary sweep's (both also without boxes),
   K8 against K7 + K3 on the same rays (t, face, occ equal), K7's and
   K8's admitted and entered (ray, block) pairs, K1, K3, K4 (all four
   modes) and K7-K11 against their plain versions on the seeded
   adversarial set
   (raycull.write_grid_mesh x raycull.adversarial_rays, K1, K4 and K9 x
   raycull.adversarial_camera, with and without boxes), the split frame
   (all on chip and streamed) and the fused frame (both shadow modes)
   from a camera on a face's plane (raycull.plane_camera_config) against
   its plain-composed twin, one sample
   through the kernels against
   the same sample composed from the plain versions (bitwise), the
   compacted bounce loop (run with room for every live tile) and
   compact_cap='auto' (the branch it took printed) against the full
   loop (bitwise), and Renderer(pt_spp=64) on the card: 3 warm-up
   samples, then samples up to 64 with the orbit key released, its
   launch counts (closest_hit, extend_shadow, anyhit and texfilter
   launched; frame and texshade not) and host syncs, its first sample
   equal to the kernel-run sample, the median ms per sample, the time
   to 64 samples and paths/s;
6. timing with CUDA events: each kernel's time beside its plain
   version's at the path's shapes (K1 and K3 also at the dense view's
   and the path tracer's: the primary sweep, the last bounce; their
   longest walk alone; and at each of them by the threshold of their
   ray-major chunks, RAY_MAJORS, each output bitwise the default's; K4
   also at the dense view's, in modes inkernel, nm and none on the same
   rays, at the nm frame's and at each orbit frame's arguments, with
   their mean, which --profile's per-frame K4 time reads), and
   back-to-back frames of each
   program (the fused frame in both shadow modes) at both views. The
   kernels line gives each kernel's least possible time on the card
   (bound_ms: the larger of its bytes over 3.35 TB/s and its FP32
   operations over 67 TFLOP/s, counted at the timed arguments; see
   kernel_work for what is counted). 67 TFLOP/s counts a fused
   multiply-add as two operations; the kernels build with -fmad=false,
   so every multiply and add issues alone, and the text line also
   gives the operations bound at that issue rate (33.5 T/s); the per-ray
   culled walks (K1, K3, K4, K7, K8) also their face tests' bound alone
   (the box tests not counted), the mask walk's bound and their walk's
   parts (walk_parts); K7 beside K8 on the same bounce-1 rays;
7. streaming scale (meshes above STREAM_FACES, the JAX package's
   bench_configs.py configs 6 and 8 on builtin:terrain:512, 522,242
   faces): the 1080p shadowed frame through Renderer(device="cuda")
   under cull and then bvh (3 warm-up + 5 frames, orbit key held;
   median, Mrays/s, peak device memory; launch counts: the streamed
   sweeps K9 and K11 and K2, K5 under bvh only, none of K1, K3, K4),
   cull frame == bvh frame bitwise, the bvh words a superset of the flat
   scan's; K5 on the whole frame (its primary and shadow-wavefront culls)
   and K9, K11 on 8 of its batches (the
   one with the most admitted blocks among them) against their plain
   versions, also without boxes; the kernel-run frame (cull, bvh) against
   the plain-composed one on builtin:terrain:128 at 640x360; the 540p
   3-bounce path tracer through the Renderer (1 warm-up + 3 samples; K9,
   K10, K11, K6 and super_any launched, K1, K7, K8 not), super_any on
   each of the sample's three bounce wavefronts against its plain twin
   bitwise and timed at bounce 1 beside its bound (super_any_phase),
   K10 and K11 on 8 batches of
   its bounce-1 wavefronts against plain (with and without boxes), one
   terrain:128 320x180 sample against the plain-composed one; K9's and
   K11's admitted, entered and needed (ray, block) pairs (K10's too),
   the heaviest batch alone against the whole launch (tail), and both
   at other sizes of K9's and K11's work items (stream_sweep.SEG 32,
   64, 256, each output bitwise the default's); each streamed kernel's
   time,
   plain time (one call on 8 batches) and bound (the
   per-ray culled walks K8-K11 also the mask walk's bound and their
   walk's parts: walk_parts; K5 at both culls, also its device time by
   torch.profiler, which its kernels line reports: its wrapper's host
   work outlasts the kernel);
8. the oracle (oracle-1080p-terrain91): Renderer(backend="oracle") on the
   smoke scene at 1920x1080 with shadows, 1 warm-up and 2 timed frames
   (CUDA events), peak device memory, no kernel launched; its frame at
   the frame bar against the fused and the split frame at its camera
   (the brute-force spec: the first full-size independent check of the
   kernels' frame; the streamed scene is not drawn by it);
9. mip sampling (mip-1080p-heightfield91): the normal-mapped heightfield
   with RenderConfig.mip through the Renderer (split, shadows, normal
   mapping on and off, 3 warm-up + 12 frames each: launch counts, K6
   three or two times a frame, K2 and K4 never; medians); each frame
   through K6 bitwise the frame composed with texfilter_plain on the
   card, at the Renderer's last camera and at a far view (mean LOD and
   the share of hit pixels above LOD 1 printed: the pyramid's deeper
   levels); K6's time, plain time and bound at the mip frame's first tap;
10. the LBVH (stream-1080p-terrain512's scene): the host build of
   bench_configs.py config 9 (build_lbvh + linearize_bvh, host clock,
   best of 3) by the native C++ builder (native/rtnative.cpp, built with
   g++ into build/native/; the phase fails if it did not build) and by
   the NumPy build, their arrays equal, and the builder Scene.build
   takes; io/obj.load_obj of the scene's mesh written as an OBJ file by
   the native C++ parser and by the Python parser (host clock, arrays
   equal); bvh_walk_mask_words on the card at the 1080p frame's tiles,
   its words a superset of the flat scan's, and equal to them on
   builtin:terrain:23 at 128x128 (the JAX package's test_accel.py case);
11. instancing with the per-frame refit (BASELINE config 5,
   bench_configs.py config 5's frame loop: InstancedScene.instantiate +
   render_megakernel, the angle up 0.05 a frame, eye (0, 0, 18)) on
   builtin:terrain:23 (968 faces an instance): 64 instances (65,536
   padded faces, streamed) at 3840x2160 and 1920x1080 under cull and bvh
   without shadows, and at 1080p with shadows; 16 instances (16,384
   faces, all on chip) at 1080p with shadows, fused and split. Each cell
   WARMUP + 10 frames with the launch counters set to 0 before and read
   after (K9, K2; K5 under bvh; K11 with shadows; K4 or K1, with K2 and
   K3, for 16): the refit alone and the frame (refit + render) by CUDA
   events, medians, and the peak device memory. At one camera: bvh ==
   cull bitwise, fused vs split at the frame bar, the kernel-run frame
   against the plain-composed one bitwise (at 640x360), each kernel of
   the 1080p frames against its plain version (K9 and K11 on 8 batches),
   and the card's refit against the CPU refit field by field (0 ulp);
12. the raster pipeline (plain PyTorch): a seeded textured cube loaded by
   load_model_raster and drawn over reference_instance_grid(10) (1,200
   triangles) by RasterEncoder.draw_model_instanced at 600x600 and
   1920x1080 (ms per draw, median of 10); at 160x160 the card against
   the CPU (clip coordinates, winner keys and depth bitwise, colour
   within 1 u8 level) and the output at chunk sizes 1 and 7 against the
   default;
13. the runtime shells on the card: FrameLoop over the smoke scene for
   10 frames with key events, pipelined and not; RenderServer on
   127.0.0.1 fetched through urllib (/frame.png decodes to the presented
   frame, /stats is JSON, /key answers); a 4-bounce path trace of the
   heightfield at 960x540 checkpointed at 3 spp and resumed to 6, equal
   to the uninterrupted 6-spp image bitwise;
14. multi-device rendering (parallel/): a set of 2 gloo ranks and one of
   4 (parallel.launch.spawn, started at once, all on cuda:0; the kernels
   were built in phase 2). Each rank times its cases with CUDA events
   (MD_REPS frames, medians), records every kernel call of each case and
   holds each kernel against its plain version on its first call's
   arguments (the streamed sweeps on 8 batches), and prints its
   peak device memory. 2 ranks: the smoke scene's row slabs (dp=2) fused
   and split with shadows (each slab also against its plain-composed
   twin; the gather timed after a barrier), stream-1080p-terrain512's
   slabs under cull and bvh, render_pathtrace_gp over 2 shards of the
   1080p heightfield (4 bounces), and render_sharded_gp from phase 5's
   camera on a face's plane (grid48, 640x360, rays at t = +0.0 and
   -0.0) with the merged primary G-buffer's t. 4 ranks: dp=4 smoke slabs,
   render_sharded_gp on the smoke scene lit and shadowed (gp=4; the
   shard's own frame timed beside it) and on builtin:terrain:512
   shadowed (131k faces a shard, streamed), dp=2 x gp=2,
   render_pathtrace_gp on pt-540p-terrain512 (gp=4),
   render_pathtrace_sharded dp=2 x sp=2, make_train_step dp=2 x sp=2 at
   1080p for MD_STEPS steps on dryrun_multichip's scene, and
   Renderer(backend="megakernel_gp") inside the group. Here every frame,
   sample and mean is held bitwise against its single-device
   counterpart, the train step's loss must descend and its first update
   match the single-rank whole-image gradient (the mean of sp ranks 0
   and 1's jitter) within 1e-3 relative; the launches summed over ranks
   per path, each path's kernels required.

The kernels line's launches are each kernel's count from the first
path run of phases 4-7 that uses it, plus its counts on the instanced
paths of phase 11 and on the slab and gp paths of phase 14 (summed over
the ranks). A Renderer's lit frame on a plain scene is captured into a
CUDA graph at its second frame and replayed after that, and a replay
launches nothing from the host, so these counts cover the frames the
host launched: each path's [path] line gives their number beside the
graph captures and replays.

`python3 chip_smoke.py --multi` runs only phases 1-2 and 14.
`python3 chip_smoke.py --super-any` runs only phases 1-2 and
super_any_phase (one recorded pt-540p-terrain512 sample, ~1 min).
`python3 chip_smoke.py --sweep-front` runs only phases 1-2 and
sweep_front_phase: K13 (the culled sweeps' front end) against its plain
twin at the refscene orbit's two 1080p ray sets and one 4K ray set of
64 instances, bitwise (a zero tile bound up to its sign) and timed
beside its byte bound, then the orbit frame's launches (~2 min).
`python3 chip_smoke.py --profile` runs only phases 1-2 and then
profiles 5 frames of each frame program at the smoke view, 5 samples
of the path tracer, and 5 frames / samples of the streamed cells
(stream-1080p-terrain512 under cull, pt-540p-terrain512) with
torch.profiler (device kernels per frame, device time, busy share,
host syncs per frame, top operators).

The scene: the reference's two spheres and the procedural terrain
builtin:terrain:91 (16,200 faces, the largest mesh the all-on-chip path
takes) under the terrain golden's camera and low sun. Any failure raises
and the script exits non-zero; without CUDA it exits 2 before printing a
result. The last line is the result JSON.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

WIDTH, HEIGHT = 1920, 1080
WARMUP, FRAMES = 3, 12
# device_ms's fallback: a sleep (~25 ms at the H100's 1.98 GHz) that the
# timed launches queue behind, so their host work does not space them
SLEEP_CYCLES = 50_000_000
SMOKE_EYE, SMOKE_TARGET = (0.0, -2.0, -1.0), (0.0, 0.0, -3.2)
DENSE_EYE, DENSE_TARGET = (0.0, -0.3, -2.2), (0.0, 0.0, -3.0)
NM_GRID = 91  # vertices per side: 2 * 90^2 = 16,200 faces
PT_BOUNCES, PT_SPP, PT_SEED = 4, 64, 0
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 (non-tensor) op/s
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12
# the FP32 issue rate without FMA pairing (one mul or add per lane-cycle)
FP32_UNFUSED_S = FP32_OPS_S / 2
# FP32 operations (mul, add, sub, div) of one (face, ray) test: the
# shared-origin plane test (K1, K4: N.d 5, t 1, three edges 7 each) and
# the per-ray-origin one (K3, K7, K8: N.d 5, N.o 5, t 2, three edges 13).
# A divide counts as one operation, though the card runs the correctly
# rounded divide as a sequence of several instructions.
OPS_SHARED, OPS_PERRAY = 27, 51
# FP32 operations of one slab test of a tile's cone against a box (K5:
# per axis two subtractions, two products, a max and a min) and of a
# tile's cone terms (six reciprocals)
OPS_BOX, OPS_CONE = 18, 6
# FP32 operations of one per-ray box test of the culled walks (rt_common.cuh
# ray_box_enter): per axis two subtractions, two products with 1/d, a
# min, a max and the running max and min, 8; then the entry's product
# and difference and the exit's product and two sums, 5. The ray's terms
# (box_ray: p, q, 1/d) and the box's widening are made once per ray and
# per box and not counted, nor are comparisons and absolute values.
OPS_RAYBOX = 3 * 8 + 5
# FP32 operations of one (ray, superblock) pair of the admission super_any
# (traverse.perray_super_any): per axis two subtractions, two divides, a
# min, a max, the two comparisons of `inside` and the running max and min,
# 10; then the exit's absolute value, product and two sums, the entry's
# product and difference and the comparison, 7
OPS_SUPER_ANY = 3 * 10 + 7
# the streamed cells: the JAX package's bench_configs.py configs 6 (the
# shadowed frame, cull and bvh) and 8 (the path tracer), builtin:terrain:512
STREAM_GRID, STREAM_EYE, STREAM_TARGET = 512, (0.0, -0.4, -1.2), \
    (0.0, 0.0, -3.0)
STREAM_FRAMES, PTS_W, PTS_H, PTS_BOUNCES, PTS_SAMPLES = 5, 960, 540, 3, 3
# the plain-composed checks at streaming scale: builtin:terrain:128
# (32,258 faces, 32 superblocks; the JAX package's __graft_entry__.py
# streaming scene)
CHECK_GRID = 128
# the sizes of K9's and K11's work items timed beside the default
# (stream_sweep.SEG: admitted blocks an item)
SEGS = (32, 64, 256)
# the thresholds of K1's and K3's ray-major chunks timed beside the
# defaults (kernels.common.RAY_MAJOR: 0 takes every chunk ray-major, 65
# none)
RAY_MAJORS = (0, 16, 32, 48, 65)
# per-ray FP32 operations of the texture kernels (12 tap scales, 3
# bilinear mixes of 9; texshade adds the 4-op Blinn-Phong per channel)
OPS_TEXFILTER, OPS_TEXSHADE = 39, 51
# FP32 operations of K4's tail (csrc/frame.cu after the sweep): a mesh
# hit's winner attributes (N.d 5, two edge terms 7 each, barycentrics 4,
# uv 10: 33); every ray's nonlinear depth (3) and, outside mode "nm", the
# mesh's Blinn-Phong (|l| 6, its unit 3, lambert 6, the half vector 6 and
# its length 6, N.H and its scale 6, pow32 5: 38); per sphere the
# quadratic (33), the hit normal (15), its Blinn-Phong (38) and depth (3);
# in mode "inkernel" per relevant ray the shadow ray (|l| 6, its unit 3,
# origin 9) and the root exit (12), and per sphere its quadratic (33).
OPS_TAIL_HIT, OPS_TAIL_DEPTH, OPS_TAIL_BLINN = 33, 3, 38
OPS_TAIL_SPHERE, OPS_SHADOW_RAY, OPS_SHADOW_SPHERE = 89, 30, 33
# the oracle phase: timed frames after one warm-up
ORACLE_FRAMES = 2
# the mip phase's far view of the nm heightfield: ~15 units away the
# pyramid's level 2 serves most hit pixels at 1080p
MIP_FAR_EYE, MIP_FAR_TARGET = (0.0, -4.0, 12.0), (0.0, 0.0, -3.0)
# the instancing phase: bench_configs.py config 5 (64 instances at 4K and
# 1080p, per-frame refit) with builtin:terrain:23 (968 faces) as the base
# mesh; the timed frames after WARMUP, and the angle of the checks
INST_MESH, INST_EYE = "builtin:terrain:23", (0.0, 0.0, 18.0)
INST_FRAMES, INST_ANGLE = 10, 0.3
INST_4K, INST_CHECK = (3840, 2160), (640, 360)
INST_FIELDS = ("tri_p0", "tri_n", "tri_d", "tri_g", "tri_c",
               "tri_inv_denom", "tri_uv", "tri_vn", "tri_mat", "tri_valid",
               "tri_orig", "tri_tangent", "tri_bitangent", "tri_uvscale",
               "blk_lo", "blk_hi", "spack", "gpack")
# the raster phase: the reference's 10x10 instance grid seen from above
# its front edge; timed draws; the card-vs-CPU check's size
RASTER_EYE, RASTER_DRAWS, RASTER_CHECK = (0.0, 12.0, 20.0), 10, 160
# the shells phase: frame-loop frames; the checkpointed path trace's size
# and its samples at the checkpoint and at the end
SHELL_FRAMES, CKPT_W, CKPT_H, CKPT_SPP = 23, 960, 540, (3, 6)


def say(msg: str) -> None:
    print(msg, flush=True)


def profile_frames(renderer, frames: int = 5, warmup: int = 3) -> dict:
    """Profile `frames` renders (after `warmup` unprofiled ones), each
    with update() first and render(block=True), with rtbench/trace.py:
    device operations, device ms and the busy share a frame, host syncs a
    frame (torch's sync debug mode) and the operations with the most
    device time ([name, seconds])."""
    from rtbench import trace

    def run(n):
        for _ in range(n):
            renderer.update()
            renderer.render(block=True)

    run(warmup)
    with trace.host_syncs() as syncs:
        traced = trace.profile(run, frames)
    ops = traced.device_ops
    return {"frames": frames,
            "device_kernels_per_frame": len(ops) / frames,
            "device_ms_per_frame": sum(e - s for _, s, e in ops)
            / frames / 1e3,
            "busy_share": traced.busy_us() / traced.window_us,
            "wall_ms_per_frame": traced.window_us / frames / 1e3,
            "host_syncs_per_frame": len(syncs) / frames,
            "top": traced.by_name()}


def smoke_config(variant: str = "auto"):
    from rust_wgpu_raytracing_tpu_torch.config import (
        CameraConfig, MeshConfig, RenderConfig, SceneConfig, reference_scene)

    return SceneConfig(
        spheres=reference_scene().spheres,
        meshes=(MeshConfig(obj_path="builtin:terrain:91",
                           translation=(0.0, 0.0, -3.0),
                           light_direction=(6.0, -1.0, 1.0)),),
        camera=CameraConfig(eye=SMOKE_EYE, target=SMOKE_TARGET),
        render=RenderConfig(width=WIDTH, height=HEIGHT, shadows=True,
                            accel="cull", variant=variant))


def write_nm_assets(root: str) -> str:
    """A heightfield grid OBJ (NM_GRID^2 vertices with vt and vn) and its
    MTL with a map_Kd and a map_Bump PNG, all from a numpy seed, written
    into root with the port's stdlib PNG encoder. Returns the OBJ name."""
    from rust_wgpu_raytracing_tpu_torch.io.image_out import encode_png

    rng = np.random.default_rng(20261016)
    n = NM_GRID
    u = np.linspace(0.0, 1.0, n)
    gx, gy = np.meshgrid(u, u, indexing="xy")
    x, y = (gx - 0.5) * 2.0, (gy - 0.5) * 2.0
    k = rng.uniform(2.0, 9.0, (4, 2))
    ph = rng.uniform(0.0, 6.3, 4)
    amp = np.array([0.12, 0.06, 0.03, 0.015])
    z = sum(a * np.sin(kx * x + ky * y + p)
            for a, (kx, ky), p in zip(amp, k, ph))
    dzx = sum(a * kx * np.cos(kx * x + ky * y + p)
              for a, (kx, ky), p in zip(amp, k, ph))
    dzy = sum(a * ky * np.cos(kx * x + ky * y + p)
              for a, (kx, ky), p in zip(amp, k, ph))
    nrm = np.stack([-dzx, -dzy, np.ones_like(z)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    lines = ["mtllib nm_grid.mtl", "o grid"]
    lines += [f"v {a:.6f} {b:.6f} {c:.6f}"
              for a, b, c in zip(x.ravel(), y.ravel(), z.ravel())]
    lines += [f"vt {a * 4.0:.6f} {b * 4.0:.6f}"
              for a, b in zip(gx.ravel(), gy.ravel())]
    lines += [f"vn {a:.6f} {b:.6f} {c:.6f}" for a, b, c in nrm.reshape(-1, 3)]
    lines.append("usemtl gridmat")
    for j in range(n - 1):
        for i in range(n - 1):
            a = j * n + i + 1
            b, c, d = a + 1, a + n + 1, a + n
            lines.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}")
            lines.append(f"f {a}/{a}/{a} {c}/{c}/{c} {d}/{d}/{d}")
    with open(os.path.join(root, "nm_grid.obj"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "nm_grid.mtl"), "w") as fh:
        fh.write("newmtl gridmat\nKa 0.08 0.08 0.08\nKd 0.8 0.8 0.8\n"
                 "Ks 0.4 0.4 0.4\nNs 32\nmap_Kd nm_kd.png\n"
                 "map_Bump nm_bump.png\n")
    kd = rng.integers(40, 256, (64, 64, 3), dtype=np.uint8)
    tn = rng.normal([0.0, 0.0, 1.0], [0.3, 0.3, 0.1], (64, 64, 3))
    tn /= np.linalg.norm(tn, axis=-1, keepdims=True)
    bump = np.round((tn * 0.5 + 0.5) * 255.0).astype(np.uint8)
    for name, img in (("nm_kd.png", kd), ("nm_bump.png", bump)):
        with open(os.path.join(root, name), "wb") as fh:
            fh.write(encode_png(img))
    return "nm_grid.obj"


def nm_config(shadows: bool, variant: str = "auto"):
    from rust_wgpu_raytracing_tpu_torch.config import (
        CameraConfig, MeshConfig, RenderConfig, SceneConfig, reference_scene)

    return SceneConfig(
        spheres=reference_scene().spheres,
        meshes=(MeshConfig(obj_path="nm_grid.obj",
                           translation=(0.0, 0.0, -3.0),
                           light_direction=(6.0, -1.0, 1.0),
                           normal_mapping=True),),
        camera=CameraConfig(eye=DENSE_EYE, target=DENSE_TARGET),
        render=RenderConfig(width=WIDTH, height=HEIGHT, shadows=shadows,
                            accel="cull", variant=variant))


def pt_config():
    """The heightfield of write_nm_assets, path-traced: normal mapping
    off, the two reference spheres, the dense view's camera, 4 bounces,
    PT_SPP samples."""
    import dataclasses as dc

    cfg = nm_config(shadows=False)
    mesh = dc.replace(cfg.meshes[0], normal_mapping=False)
    return dc.replace(cfg, meshes=(mesh,), render=dc.replace(
        cfg.render, pt_bounces=PT_BOUNCES, pt_spp=PT_SPP, seed=PT_SEED))


def stream_config(accel: str = "cull", grid=None, width=None, height=None):
    """bench_configs.py config 6 with its low sun: builtin:terrain:512 at
    (0,0,-3), light (6,-1,1), no spheres, the close camera, shadows, at
    1920x1080 (None: STREAM_GRID, WIDTH, HEIGHT)."""
    from rust_wgpu_raytracing_tpu_torch.config import (
        CameraConfig, MeshConfig, RenderConfig, SceneConfig)

    grid, width, height = (grid or STREAM_GRID, width or WIDTH,
                           height or HEIGHT)
    return SceneConfig(
        meshes=(MeshConfig(obj_path=f"builtin:terrain:{grid}",
                           translation=(0.0, 0.0, -3.0),
                           light_direction=(6.0, -1.0, 1.0)),),
        camera=CameraConfig(eye=STREAM_EYE, target=STREAM_TARGET),
        render=RenderConfig(width=width, height=height, shadows=True,
                            accel=accel))


def pt_stream_config(grid=None, width=None, height=None):
    """bench_configs.py config 8: config 6's scene path-traced at
    960x540 (None: PTS_W, PTS_H), 3 bounces, seed 0."""
    import dataclasses as dc

    cfg = stream_config(grid=grid, width=width or PTS_W,
                        height=height or PTS_H)
    return dc.replace(cfg, render=dc.replace(
        cfg.render, shadows=False, pt_bounces=PTS_BOUNCES, pt_spp=PT_SPP,
        seed=PT_SEED))


def card_line() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run([smi, "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def u8(color):
    import torch

    return torch.round(color.clamp(0, 1) * 255).to(torch.int32)


def frame_bar(a, b):
    """(max linear u8 delta, exact fraction, bitwise equal)."""
    d = (u8(a) - u8(b)).abs()
    return int(d.max()), float((d == 0).float().mean()), bool(
        (a == b).all())


def ulp_gap(a, b) -> int:
    """Largest distance in f32 ulps between two finite f32 tensors."""
    import torch

    def key(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max())


def max_abs_err(a, b) -> float:
    """max |a - b| over elements; equal values (inf included) count 0."""
    import torch

    a, b = a.double(), b.double()
    same = a == b
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max())


def tensor_bytes(xs) -> int:
    import torch

    return sum(x.numel() * x.element_size() for x in xs
               if isinstance(x, torch.Tensor))


def mask_bits(words, nb: int):
    """(tiles,) count of the set bits below block nb of packed
    (tiles * nwords,) mask words."""
    import torch

    n_tiles = words.shape[0] // -(-nb // 32)
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[:, None] >> torch.arange(32, device=w.device)) & 1
    return bits.reshape(n_tiles, -1)[:, :nb].sum(1)


def walk_pairs(tlb, ray_bound, lanes, floor=None) -> int:
    """(block, lane) visits a front-to-back walk of the schedule needs:
    in each tile the admitted blocks (finite entry bound tlb (tiles,
    nb)) whose bound is at most the tile's largest ray_bound (R,), at
    least `floor` (tiles,) of them, times the tile's lanes (R,) bool
    that take the test."""
    import torch

    n_tiles = tlb.shape[0]
    reach = ray_bound.view(n_tiles, -1).amax(1)
    blocks = (torch.isfinite(tlb) & (tlb <= reach[:, None])).sum(1)
    if floor is not None:
        blocks = torch.maximum(blocks, floor)
    return int((blocks * lanes.view(n_tiles, -1).sum(1)).sum())


def sched_reach(name, args, outs):
    """(tiles,) how far K1's or K3's walk of the schedule reaches at these
    arguments and outputs: each tile's largest min(t, root exit) (K1), or
    root exit of an active ray that ends unoccluded, -1 for none (K3)."""
    import torch

    if name == "closest_hit":
        reach = torch.minimum(outs[0], args[5])
    else:
        reach = torch.where((args[8] > 0) & (outs[0] == 0), args[9], -1.0)
    return reach.view(-1, 1024).amax(1)


def culled_walk(name, args, kw, outs, mesh=None):
    """raycull.walk_counts of K8's two halves (closest hit, shadow) or of
    K1, K3, K7, K9, K10 or K11, at these arguments and outputs: the pairs
    the per-ray culled walk must test at least. K1's arguments end with
    the sphere block (the origin first) and the boxes, K9's with the
    origin and the boxes (origin, blk_lo, blk_hi), K3's, K7's and K11's
    with the boxes. K4 (its const vector holds the origin; the boxes last) counts
    its sweep as K1's on the same rays and, in mode "inkernel", its
    shadow loop as K3's over the live shadow rays and the clusters their
    cone admits: mesh = (t, face), the sweep's winners (K4's outputs do
    not hold them)."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.testing.raycull import (
        frame_shadow_rays, mask_pairs, sched_pairs, stream_pairs,
        walk_counts)

    def aimed(dx, dy, dz):
        return (dx != 0) | (dy != 0) | (dz != 0)
    if name == "frame":
        t, face = mesh
        o = [args[2][a].expand_as(args[3]) for a in range(3)]
        reach = torch.minimum(t, args[6]).view(-1, 1024).amax(1)
        sweep = walk_counts(sched_pairs(args[0], reach), args[10], args[11],
                            *args[3:6], *o, aimed(*args[3:6]), t_final=t)
        if kw["mode"] != "inkernel":
            return (sweep,)
        w = frame_shadow_rays(args, kw, t, face)
        occ = torch.where(w["live"], outs[2], 0.0)  # the clusters' share
        reach = torch.where(w["live"] & (occ == 0), w["cap"], -1.0).view(
            -1, 1024).amax(1)
        shadow = walk_counts(sched_pairs(w["tl"], reach), args[10],
                             args[11], *w["sd"], *w["p"], w["live"], occ=occ)
        return sweep, shadow
    if name == "closest_hit":
        # the camera origin broadcast to per-ray planes
        o = [args[8][a].expand_as(args[2]) for a in range(3)]
        return (walk_counts(sched_pairs(args[0], sched_reach(
            name, args, outs)), args[9], args[10], *args[2:5], *o,
            aimed(*args[2:5]), t_final=outs[0]),)
    if name == "anyhit":
        return (walk_counts(sched_pairs(args[0], sched_reach(
            name, args, outs)), args[12], args[13], *args[2:8],
            args[8] > 0, occ=outs[0]),)
    if name == "closest_hit_perray":
        reach = torch.minimum(outs[0], args[8]).view(-1, 1024).amax(1)
        return (walk_counts(sched_pairs(args[0], reach), args[11], args[12],
                            *args[2:8], aimed(*args[2:5]),
                            t_final=outs[0]),)
    if name == "extend_shadow":
        n_tiles = args[2].shape[0] // 1024
        nb = args[15].shape[0] // kw["block_f"]
        ext = walk_counts(mask_pairs(args[0], n_tiles, nb), args[17],
                          args[18], *args[2:8], aimed(*args[2:5]),
                          t_final=outs[0])
        shadow = walk_counts(mask_pairs(args[1], n_tiles, nb), args[17],
                             args[18], *args[8:14], args[14] > 0,
                             occ=outs[2])
        return ext, shadow
    if name == "stream_closest_hit":
        # the camera origin broadcast to per-ray planes
        o = [args[9][a].expand_as(args[3]) for a in range(3)]
        reach = torch.minimum(outs[0], args[6]).view(-1, 1024).amax(1)
        return (walk_counts(stream_pairs(args[0], args[2], reach), args[10],
                            args[11], *args[3:6], *o, aimed(*args[3:6]),
                            t_final=outs[0]),)
    if name == "stream_anyhit":
        act, occ = args[9] > 0, outs[0]
        reach = torch.where(act & (occ == 0), args[10], -1.0).view(
            -1, 1024).amax(1)
        return (walk_counts(stream_pairs(args[0], args[2], reach), args[12],
                            args[13], *args[3:9], act, occ=occ),)
    # K10: the words its walk visits, up to each subtile's reach
    reach = torch.minimum(outs[0], args[9]).view(-1, 1024).amax(1)
    return (walk_counts(stream_pairs(args[0], args[2], reach), args[11],
                        args[12], *args[3:9], aimed(*args[3:6]),
                        t_final=outs[0]),)


def note_box_tests(counts, walks) -> None:
    """Add the culled walks' box tests to counts["box_tests"] (a dict, or
    None for no count)."""
    if counts is not None:
        counts["box_tests"] = counts.get("box_tests", 0) + sum(
            n["box_tests"] for n in walks)


def kernel_work(name, args, kw, outs, mesh=None, walk="culled",
                counts=None):
    """(bytes, FP32 operations) of one call at these arguments: every
    input read once and every output written once; the face tests these
    rays need, or the texture kernels' per-ray mix. The sweeps count
    the lanes that can take a test (a direction that is not zero; for
    the any-hit tests, an active ray) over the blocks their walk must
    visit: the closest-hit walks (K1, K4, K7) up to the tile's largest
    min(t, root exit) among its rays (mesh = (t, face): K4's mesh
    winners, which its outputs do not hold), the any-hit walk (K3) up to
    the largest root exit among its active rays that end unoccluded (at
    least one block where an active ray ends occluded).

    K4 (culled) counts its sweep as K1's culled walk on the same rays and
    its in-kernel shadow loop as K3's over the live shadow rays
    (culled_walk), plus its tail (OPS_TAIL_*, OPS_SHADOW_*); it reads the
    face pack, origin terms and plane constants only in the staged rows
    and in each hit's winner row (columns 0-22 and two origin terms).

    K1, K3 and K7-K11 walk per ray (csrc/cull_walk.cuh), and their count
    follows that walk (culled_walk, raycull.walk_counts): a box test
    (OPS_RAYBOX) for every admitted (ray, block) pair of an aimed ray,
    of an active shadow ray that ends unoccluded, and one per occluded
    one; the face tests (block_f x OPS_PERRAY) of the pairs whose line
    enters the block's box, for closest hit only where that entry lies
    at or below the ray's final t, for any hit those of the rays that end
    unoccluded and one block per occluded ray; the record rows of the
    distinct blocks those pairs need, staged once. None of it can exceed
    what the kernels do: they box-test every admitted pair of an aimed or
    live ray (a shadow ray until it is occluded, so at least once), and
    keep a pair whenever its entry lies at or below the ray's best t so
    far, which never drops below the final t; an occluded ray needed at
    least the block that occluded it. The schedule walks (K1, K3, K7) count
    only the blocks within the tile's reach and the streamed walks
    (K9-K11) only the words within the subtile's reach (the largest
    min(t, root exit), or for K3 and K11 root exit of a ray that ends
    unoccluded); K1's and K9's face tests are the shared-origin test's
    (OPS_SHARED), their staged rows the face pack's 12 columns and the
    origin terms' 4.

    walk="mask" counts K1, K3, K4 and K7-K11 as the TPU kernels walk:
    every lane that can take a test against every admitted block (the
    schedule walks up to the tile's reach, K4's in-kernel shadow loop as
    K3's over the clusters its cone admits, K8 every set bit of each
    half's mask, the streamed sweeps the words up to each subtile's
    reach), the bound the mask walk would have.

    A culled walk also adds its box tests to counts["box_tests"] where
    counts is a dict (face_test_note)."""
    import torch

    moved = tensor_bytes(args) + tensor_bytes(outs)
    bf = kw.get("block_f", 1)
    if walk == "culled" and name == "frame":
        walks = culled_walk(name, args, kw, outs, mesh)
        note_box_tests(counts, walks)
        ops = walks[0]["box_tests"] * OPS_RAYBOX \
            + walks[0]["face_pairs"] * bf * OPS_SHARED
        if len(walks) == 2:
            ops += walks[1]["box_tests"] * OPS_RAYBOX \
                + walks[1]["face_pairs"] * bf * OPS_PERRAY
        r, ns = args[3].shape[0], kw["ns"]
        hits = int(torch.isfinite(mesh[0]).sum())
        ops += hits * OPS_TAIL_HIT + r * (
            OPS_TAIL_DEPTH + ns * OPS_TAIL_SPHERE
            + (0 if kw["mode"] == "nm" else OPS_TAIL_BLINN))
        if kw["mode"] == "inkernel":
            rel = int(((outs[1] > 0) & (outs[6] + outs[7] > 0)).sum())
            ops += rel * (OPS_SHADOW_RAY + ns * OPS_SHADOW_SPHERE)
        moved = tensor_bytes(args[:7] + args[10:]) + tensor_bytes(outs) \
            + sum(n["blocks"] for n in walks) * bf * 16 * 4 + hits * 25 * 4
        return moved, ops
    if walk == "culled" and name == "extend_shadow":
        ext, shadow = culled_walk(name, args, kw, outs)
        note_box_tests(counts, (ext, shadow))
        ops = (ext["box_tests"] + shadow["box_tests"]) * OPS_RAYBOX + (
            ext["face_pairs"] + shadow["face_pairs"]) * bf * OPS_PERRAY
        moved = tensor_bytes(args[:15] + args[17:]) + tensor_bytes(outs) \
            + max(ext["blocks"], shadow["blocks"]) * bf * 16 * 4
        return moved, ops
    # the schedule walks: the face pack and its plane constants or origin
    # terms (at args[r0], args[r0 + 1]) are read only in the staged rows
    sched_walks = {"closest_hit": 6, "anyhit": 10, "closest_hit_perray": 9}
    if walk == "culled" and name in sched_walks:
        (n,) = culled_walk(name, args, kw, outs)
        note_box_tests(counts, (n,))
        ops = n["box_tests"] * OPS_RAYBOX + n["face_pairs"] * bf * (
            OPS_SHARED if name == "closest_hit" else OPS_PERRAY)
        r0 = sched_walks[name]
        moved = tensor_bytes(args[:r0] + args[r0 + 2:]) + tensor_bytes(outs) \
            + n["blocks"] * bf * 16 * 4
        return moved, ops
    # the streamed culled walks: the record (K9 also its origin terms) is
    # read only in the staged rows
    record = {"stream_closest_hit_perray": (10, 11, OPS_PERRAY),
              "stream_closest_hit": (7, 9, OPS_SHARED),
              "stream_anyhit": (11, 12, OPS_PERRAY)}
    if walk == "culled" and name in record:
        r0, r1, per = record[name]
        (n,) = culled_walk(name, args, kw, outs)
        note_box_tests(counts, (n,))
        ops = n["box_tests"] * OPS_RAYBOX + n["face_pairs"] * 32 * per
        moved = tensor_bytes(args[:r0] + args[r1:]) + tensor_bytes(outs) \
            + n["blocks"] * 32 * 16 * 4
        return moved, ops

    def aimed(dx, dy, dz):
        return (dx != 0) | (dy != 0) | (dz != 0)

    # closest-hit sweeps: (index of dx, index of texit, operations/test)
    sweeps = {"closest_hit": (2, 5, OPS_SHARED), "frame": (3, 6, OPS_SHARED),
              "closest_hit_perray": (2, 8, OPS_PERRAY)}
    if name in sweeps:
        d0, te, per = sweeps[name]
        t = mesh[0] if name == "frame" else outs[0]
        pairs = walk_pairs(args[0], torch.minimum(t, args[te]),
                           aimed(*args[d0:d0 + 3]))
        ops = pairs * bf * per
        if name == "frame" and kw["mode"] == "inkernel":
            # the shadow loop: every live lane against every cluster the
            # cone admits within reach, as K3's mask walk
            from rust_wgpu_raytracing_tpu_torch.testing.raycull import \
                frame_shadow_rays

            w = frame_shadow_rays(args, kw, *mesh)
            occ = torch.where(w["live"], outs[2], 0.0)
            hit_any = (occ > 0).view(-1, 1024).any(1).long()
            ops += walk_pairs(w["tl"], torch.where(
                w["live"] & (occ == 0), w["cap"], -1.0), w["live"],
                floor=hit_any) * bf * OPS_PERRAY
    elif name == "anyhit":
        act, texit, occ = args[8] > 0, args[9], outs[0]
        open_ = act & (occ == 0)
        n_tiles = args[0].shape[0]
        hit_any = (act & (occ > 0)).view(n_tiles, -1).any(1).long()
        pairs = walk_pairs(args[0], torch.where(open_, texit, -1.0), act,
                           floor=hit_any)
        ops = pairs * bf * OPS_PERRAY
    elif name in ("stream_closest_hit", "stream_closest_hit_perray"):
        perray = name == "stream_closest_hit_perray"
        te = args[9] if perray else args[6]
        reach = torch.minimum(outs[0], te).view(-1, 1024).amax(1)
        pairs, staged = stream_walk(args[0], args[2], reach,
                                    aimed(*args[3:6]).view(-1, 1024).sum(1))
        ops = pairs * 32 * (OPS_PERRAY if perray else OPS_SHARED)
        moved = tensor_bytes(args[:7 + 3 * perray]) + tensor_bytes(outs) \
            + staged * 32 * 16 * 4
    elif name == "stream_anyhit":
        act, texit, occ = args[9] > 0, args[10], outs[0]
        open_ = act & (occ == 0)
        reach = torch.where(open_, texit, -1.0).view(-1, 1024).amax(1)
        hit_any = (act & (occ > 0)).view(-1, 1024).any(1).long()
        pairs, staged = stream_walk(args[0], args[2], reach,
                                    act.view(-1, 1024).sum(1), hit_any)
        ops = pairs * 32 * OPS_PERRAY
        moved = tensor_bytes(args[:11]) + tensor_bytes(outs) \
            + staged * 32 * 16 * 4
    elif name == "hier_cull":
        from rust_wgpu_raytracing_tpu_torch.ops.kernels.hier_cull import (
            _cone, box_test)

        sup, _, bounds = args
        n_tiles = bounds.shape[1]
        entered = int(box_test(sup, _cone(bounds)).sum())
        ops = (n_tiles * sup.shape[0] + entered * 32) * OPS_BOX \
            + n_tiles * OPS_CONE
    elif name == "extend_shadow":
        nb = args[15].shape[0] // bf
        ext = aimed(*args[2:5]).view(-1, 1024).sum(1)
        act = (args[14] > 0).view(-1, 1024).sum(1)
        pairs = int((mask_bits(args[0], nb) * ext
                     + mask_bits(args[1], nb) * act).sum())
        ops = pairs * bf * OPS_PERRAY
    else:
        per = OPS_TEXFILTER if name == "texfilter" else OPS_TEXSHADE
        ops = args[1].numel() * per
    return moved, ops


def stream_walk(mask3, tlb3, reach, lanes, floor=None):
    """((block, lane) tests, distinct blocks staged) of a streamed walk:
    each subtile visits the set bits of its words whose entry bound is
    finite and at most the subtile's reach (n_sub,), at least `floor`
    blocks, over its `lanes` (n_sub,) taking the test."""
    import torch

    nsub, n_super = mask3.shape[1] - 1, mask3.shape[2]
    words = mask3[:, :nsub].reshape(-1, n_super).to(torch.int64)
    tl = tlb3[:, :nsub].reshape(-1, n_super)
    ok = torch.isfinite(tl) & (tl <= reach[:, None])
    bits = ((words[:, :, None] >> torch.arange(32, device=words.device)) & 1
            ).bool() & ok[:, :, None]
    blocks = bits.sum((1, 2))
    if floor is not None:
        blocks = torch.maximum(blocks, floor)
    return int((blocks * lanes).sum()), int(bits.any(0).sum())


def stream_blocks(mask3, tlb3):
    """(n_sub,) blocks each subtile's schedule admits: the set bits of its
    words whose entry bound is finite."""
    import torch

    nsub, n_super = mask3.shape[1] - 1, mask3.shape[2]
    words = mask3[:, :nsub].reshape(-1, n_super).to(torch.int64)
    ok = torch.isfinite(tlb3[:, :nsub].reshape(-1, n_super))
    bits = (words[:, :, None] >> torch.arange(32, device=words.device)) & 1
    return (bits.sum(2) * ok).sum(1)


def heaviest_batch(mask3, tlb3):
    """(index, admitted blocks per batch (NB,)): the batch of a streamed
    schedule whose subtiles admit the most blocks together."""
    nb, nsub = mask3.shape[0], mask3.shape[1] - 1
    adm = stream_blocks(mask3, tlb3).view(nb, nsub).sum(1)
    return int(adm.argmax()), adm


def batch_args(args, sel):
    """A streamed sweep's arguments restricted to the batches `sel` (an
    index tensor): the schedule's rows and the rays' planes; the record,
    origin terms, origin and boxes as they are."""
    mask3 = args[0]
    nb = mask3.shape[0]
    r = nb * (mask3.shape[1] - 1) * 1024

    def take(a):
        if a.dim() == 1 and a.shape[0] == r:
            return a.view(nb, -1).index_select(0, sel).reshape(-1)
        return a
    return [a.index_select(0, sel) for a in args[:3]] + \
        [take(a) for a in args[3:]]


def subset_check(K, flat, errs, view, name, args, kw, n_batches=8):
    """A streamed sweep (K9-K11) on all batches against its plain version
    on n_batches of them (the most admitted blocks among them); its
    max_abs_err into errs. Returns (the subset's arguments, a note)."""
    import torch

    wrapper = {f.__name__: f for f in K.KERNELS}
    plain = {f.__name__: p for f, p in zip(K.KERNELS, K.PLAIN)}
    mask3 = args[0]
    nb, nsub = mask3.shape[0], mask3.shape[1] - 1
    top, adm = heaviest_batch(mask3, args[2])
    spread = [int(i) for i in np.linspace(0, nb - 1, n_batches)]
    pick = sorted({top} | set([i for i in spread
                               if i != top][:n_batches - 1]))
    sel = torch.tensor(pick, device=mask3.device)
    sub = batch_args(args, sel)
    got = flat(name, wrapper[name](*args, **kw))
    want = flat(name, plain[name](*sub, **kw))
    torch.cuda.synchronize()
    got = [g.view(nb, -1).index_select(0, sel).reshape(-1) for g in got]
    err = max(max_abs_err(x, y) for x, y in zip(got, want))
    exact = all(torch.equal(x, y) for x, y in zip(got, want))
    if name in SIGNED_T:  # a zero t with its sign
        exact = exact and torch.equal(got[0].view(torch.int32),
                                      want[0].view(torch.int32))
    say(f"[kernel] {view}: {name} {'OK' if exact else 'MISMATCH'} vs "
        f"plain on {len(sel)} of {nb} batches ({len(sel) * nsub} "
        f"subtiles, the batch with the most admitted blocks ({int(adm[top])}"
        f") among them), the kernel run on all {nb}; max_abs_err "
        f"{err!r}; bitwise {exact}")
    if not exact:
        raise AssertionError(f"{name} disagrees with its plain version")
    errs[name] = max(errs.get(name, 0.0), err)
    return sub, f"plain on {len(sel)} of {nb} batches"


def bound(moved: int, ops: int, ops_s: float = FP32_OPS_S):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes, t_ops = moved / HBM_BYTES_S, ops / ops_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, kernel: str) -> tuple:
    """The mean device time (ms) a call of fn spends in the kernels whose
    name holds `kernel`, over `reps` calls, and how it was timed: from
    torch.profiler's trace, or, where the trace holds no device event of
    the kernel (CUPTI gave none), by CUDA events around `reps` calls
    queued behind torch.cuda._sleep, so that they run back to back on the
    device. CUDA events around back-to-back calls time the host where a
    kernel takes less than its wrapper's host work (K5: ~40 us of Python
    a call); both ways time the kernel itself."""
    import torch

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == cuda and kernel in e.name)
    if us > 0:
        return us / reps / 1e3, f"torch.profiler, {reps} launches"
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / reps,
            f"no device event in torch.profiler's trace: CUDA events "
            f"around {reps} launches queued behind a "
            f"{SLEEP_CYCLES}-cycle sleep")


def mask_walk_note(name, args, kw, outs, ms, mesh=None) -> str:
    """The bound of the mask walk (the TPU kernels' walk, every lane of
    every admitted block) at these arguments, as a note to a timing line
    (mesh: K4's sweep winners, as for kernel_work)."""
    mw_ms, mw_by = bound(*kernel_work(name, args, kw, outs, mesh,
                                      walk="mask"))
    return (f"; the mask walk's bound {mw_ms:.4f} ms by {mw_by}, "
            f"{100 * mw_ms / ms:.1f}% of it")


def face_test_note(moved: int, ops: int, box_tests: int, ms) -> str:
    """The bound of a per-ray culled walk's face tests alone: its bytes
    and operations (kernel_work) less its box tests' operations, the
    culling's own work, as a note to a timing line."""
    ft_ms, ft_by = bound(moved, ops - box_tests * OPS_RAYBOX)
    return (f"; the face tests' bound alone {ft_ms:.4f} ms by {ft_by} "
            f"({box_tests} box tests not counted), {100 * ft_ms / ms:.1f}% "
            f"of it")


# the shared-origin closest-hit sweeps, whose t is held bitwise: a zero t
# keeps its sign (a camera on a face's plane draws the face by it)
SIGNED_T = ("closest_hit", "stream_closest_hit")
# the index of the per-ray culled walks' first box argument (blk_lo)
BOX_ARG = {"closest_hit": 9, "anyhit": 12, "frame": 10, "extend_shadow": 17,
           "closest_hit_perray": 11,
           "stream_closest_hit_perray": 11, "stream_closest_hit": 10,
           "stream_anyhit": 12}


def walk_parts(name, args, kw, reps: int) -> str:
    """Times of parts of a per-ray culled walk (K1, K3, K7-K11) on these
    arguments, as a note to a timing line: with boxes no ray enters
    (valid boxes at 1e6: the box tests and the chunk overheads alone, no
    face test) and, for K8, each half alone (the other half's mask words
    zeroed)."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.ops import kernels as K

    fn = getattr(K, name)
    n = BOX_ARG[name]
    far = torch.full_like(args[n], 1e6)
    runs = {"boxes no ray enters": (*args[:n], far, far + 1.0)}
    if name == "extend_shadow":
        zero = torch.zeros_like(args[0])
        runs["the closest-hit half alone"] = (args[0], zero, *args[2:])
        runs["the shadow half alone"] = (zero, *args[1:])
    return "; " + ", ".join(
        f"{label} {time_ms(lambda a=a: fn(*a, **kw), reps):.4f} ms"
        for label, a in runs.items())


def longest_walk(name, args, kw, outs, reps: int) -> str:
    """K1's or K3's tile with the longest walk (the most admitted blocks
    within the tile's reach, sched_reach) launched alone, as a note to a
    timing line: whether one walk sets the launch's time."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.ops import kernels as K

    tlb, r = args[0], args[2].shape[0]
    reach = sched_reach(name, args, outs)
    walk = (torch.isfinite(tlb) & (tlb <= reach[:, None])).sum(1)
    t = int(walk.argmax())
    one = [a[t:t + 1] if i < 2 else
           a[t * 1024:(t + 1) * 1024] if a.dim() == 1 and a.shape[0] == r
           else a for i, a in enumerate(args)]
    fn = getattr(K, name)
    ms = time_ms(lambda: fn(*one, **kw), reps)
    return (f"; its longest walk alone (tile {t}: {int(walk[t])} blocks "
            f"within reach, against a mean of {float(walk.float().mean()):.1f}"
            f") {ms:.4f} ms")


def texel_offset_phase(check, say):
    """Texels past 2^24 in a ~400 MB pool (testing.texels.far_texel_case: odd
    base offsets no f32 holds): the glue's i32 addresses give each ray
    its own taps, and K6 and K2 on them equal their plain versions."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.testing.texels import (
        F32_EXACT, far_texel_case)
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import \
        gather_packed_taps

    pool, base, hh, ww, u, v, want = far_texel_case("cuda")
    taps, fx, fy = gather_packed_taps(pool, base, hh, ww, u, v)
    addressed = torch.equal(taps.cpu(), want)
    exact = bool((base.float().long() == base.long()).any())
    say(f"[kernel] texels past 2^24: pool {tuple(pool.shape)} "
        f"({pool.numel() * 2 / 2 ** 20:.0f} MiB), base offsets "
        f"{sorted(set(base.tolist()))} (2^24 = {F32_EXACT}; any held by an "
        f"f32: {exact}); each ray's taps at its int64 address: {addressed}")
    if exact or not addressed:
        raise AssertionError("texels past 2^24 are mis-addressed")
    rng = np.random.default_rng(25)
    n = fx.shape[0]
    planes = [rng.uniform(0, 1, n), rng.uniform(0, 1, n) ** 8] + \
        [rng.uniform(0, 0.2, n) for _ in range(3)] + \
        [rng.uniform(0, 1, n) for _ in range(3)]
    planes = [torch.from_numpy(p.astype(np.float32)).to("cuda")
              for p in planes]
    check("texels past 2^24", "texfilter", (taps, fx, fy), {})
    check("texels past 2^24", "texshade", (taps, fx, fy, *planes), {})


def raycull_phase(record, check, say):
    """K1, K3, K4 and K7-K11 against their plain versions on the seeded
    adversarial set: raycull.write_grid_mesh's two meshes (8- and 32-face
    clusters, faces in their boxes' planes, edges shared by blocks, NaN
    padding faces and +inf padding boxes) under the five ray sets of
    raycull.adversarial_rays (K3, K7, K8, K10, K11) and the six cameras of
    raycull.adversarial_camera (K1, K4, K9: the ray sets' kinds from one
    origin and a camera on a face's plane), the arguments from the port's
    own glue on the card (gbuffer and anyhit_rays on the all-on-chip
    sweeps and forced onto the streamed ones, extend_shadow_rays,
    gbuffer_perray on both sweeps, fusedframe.frame_args: K4 in all four
    modes on the meshes with the reference's spheres and a grazing
    light); every output equal, with the boxes and without. Then the
    hazard of a zero
    t: the split frame from a camera on a face's plane
    (raycull.plane_camera_config; also forced onto the streamed sweeps on
    the 32-face mesh) and the fused frame in both shadow modes through
    the kernels against the plain-composed frame, bitwise."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.config import (MeshConfig,
                                                       RenderConfig,
                                                       SceneConfig)
    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
    from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
    from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
    from rust_wgpu_raytracing_tpu_torch.ops import megakernel as MK
    from rust_wgpu_raytracing_tpu_torch.config import reference_scene
    from rust_wgpu_raytracing_tpu_torch.ops.fusedframe import (
        frame_args, render_frame_fused)
    from rust_wgpu_raytracing_tpu_torch.testing.raycull import (
        ADVERSARIAL_KINDS, CAMERA_KINDS, adversarial_camera,
        adversarial_rays, plane_camera_config, write_grid_mesh)

    root = tempfile.mkdtemp(prefix="rt_cull_")
    before = os.environ.get("RWRT_ASSETS")
    os.environ["RWRT_ASSETS"] = root
    should_stream = MK._should_stream
    try:
        for cells in (16, 48):
            write_grid_mesh(os.path.join(root, f"grid{cells}.obj"), cells)
            data = Scene.build(SceneConfig(
                meshes=(MeshConfig(obj_path=f"grid{cells}.obj"),),
                render=RenderConfig(width=64, height=32))).data.to("cuda")
            for seed, kind in enumerate(CAMERA_KINDS):
                view = f"adversarial grid{cells} {kind}"
                origin, d = (torch.from_numpy(x).to("cuda") for x in
                             adversarial_camera(kind, cells, data.blk_lo,
                                                data.blk_hi, 600 + seed))
                calls = record(lambda ks: (
                    MK.gbuffer(data, origin, *d, stream=True, kernels=ks),
                    MK.gbuffer(data, origin, *d, stream=False, kernels=ks)))
                for name in ("stream_closest_hit", "closest_hit"):
                    args, kw = calls[name][0]
                    check(view, name, args, kw)
                    check(view, name, args[:BOX_ARG[name]], kw,
                          " (no boxes)")
                if kind not in ADVERSARIAL_KINDS:
                    continue
                o, d, so, sd, act = (torch.from_numpy(x).to("cuda") for x in
                                     adversarial_rays(kind, cells, data.blk_lo,
                                                      data.blk_hi, 500 + seed))
                calls = record(lambda ks: (
                    MK.extend_shadow_rays(data, *o, *d, *so, *sd, act,
                                          kernels=ks),
                    MK.gbuffer_perray(data, *o, *d, stream=True, kernels=ks),
                    MK.gbuffer_perray(data, *o, *d, stream=False,
                                      kernels=ks),
                    MK.anyhit_rays(data, *so, *sd, act, stream=True,
                                   kernels=ks),
                    MK.anyhit_rays(data, *so, *sd, act, stream=False,
                                   kernels=ks)))
                for name in ("extend_shadow", "stream_closest_hit_perray",
                             "closest_hit_perray", "stream_anyhit",
                             "anyhit"):
                    args, kw = calls[name][0]
                    check(view, name, args, kw)
                    check(view, name, args[:BOX_ARG[name]], kw,
                          " (no boxes)")
            # K4's scene: the reference's spheres, a light a few degrees
            # above the grids' plane (grazing shadow rays)
            lit = Scene.build(SceneConfig(
                spheres=reference_scene().spheres,
                meshes=(MeshConfig(obj_path=f"grid{cells}.obj",
                                   light_direction=(-1.0, -0.2, -0.05)),),
                render=RenderConfig(width=64, height=32))).data.to("cuda")
            for seed, kind in enumerate(CAMERA_KINDS):
                view = f"adversarial grid{cells} {kind}, spheres, low light"
                origin, d = (torch.from_numpy(x).to("cuda") for x in
                             adversarial_camera(kind, cells, lit.blk_lo,
                                                lit.blk_hi, 1300 + seed))
                for mode in ("none", "sched", "nm", "inkernel"):
                    args, kw = frame_args(lit, origin, *d)
                    kw["mode"] = mode
                    check(view, "frame", args, kw)
                    check(view, "frame", args[:BOX_ARG["frame"]], kw,
                          " (no boxes)")
            cfg = plane_camera_config(f"grid{cells}.obj", cells, 600, 640,
                                      360)
            plane = Scene.build(cfg).data.to("cuda")
            uni = Camera.from_config(cfg.camera, 640 / 360).uniforms().flat()
            for mode in ("sched", "inkernel"):
                K.reset_launch_counts()
                a, _ = render_frame_fused(plane, uni, width=640, height=360,
                                          shadows=True, shadow_mode=mode)
                launched = K.launch_counts()["frame"]
                b, _ = render_frame_fused(plane, uni, width=640, height=360,
                                          shadows=True, shadow_mode=mode,
                                          kernels=K.PLAIN)
                dmax, exact, bitwise = frame_bar(a, b)
                say(f"[frame] camera on a face's plane, grid{cells} 640x360 "
                    f"fused frame (shadow_mode {mode}; frame launched "
                    f"{launched}): kernels vs plain-composed bitwise "
                    f"{bitwise} (max linear u8 delta {dmax}, exact "
                    f"{exact:.6f})")
                if not bitwise or launched != 1:
                    raise AssertionError("the fused frame from a camera on a "
                                         "face's plane differs from its "
                                         "plain twin")
            for stream in (False, True) if cells == 48 else (False,):
                MK._should_stream = lambda f, bf, stream=stream: stream
                K.reset_launch_counts()
                a, _ = MK.render_megakernel(plane, uni, width=640,
                                            height=360, shadows=True,
                                            fused=False)
                sweep = "stream_closest_hit" if stream else "closest_hit"
                launched = K.launch_counts()[sweep]
                b, _ = MK.render_megakernel(plane, uni, width=640,
                                            height=360, shadows=True,
                                            fused=False, kernels=K.PLAIN)
                MK._should_stream = should_stream
                dmax, exact, bitwise = frame_bar(a, b)
                lit = float((u8(a) > 0).any(-1).float().mean())
                say(f"[frame] camera on a face's plane, grid{cells} 640x360 "
                    f"split frame through {sweep} (launched {launched}): "
                    f"kernels vs plain-composed bitwise {bitwise} (max "
                    f"linear u8 delta {dmax}, exact {exact:.6f}); "
                    f"{lit:.4f} of pixels lit")
                if not bitwise or launched != 1:
                    raise AssertionError("the frame from a camera on a "
                                         "face's plane differs from its "
                                         "plain twin")
    finally:
        MK._should_stream = should_stream
        if before is None:
            os.environ.pop("RWRT_ASSETS", None)
        else:
            os.environ["RWRT_ASSETS"] = before
        shutil.rmtree(root, ignore_errors=True)


def stream_phase(card, K, Renderer, drive, record, check, results, errs,
                 path_launches, flat, say):
    """Phase 7, streaming scale: the stream-1080p-terrain512 frame under
    cull and bvh and the pt-540p-terrain512 path tracer through the
    Renderer (launch counts, medians, peak memory), K5/K9/K10/K11 against
    their plain versions on the paths' own arguments, the kernel-run
    frame and sample against the plain-composed ones at terrain:128, and
    the new kernels' times beside their bounds into `results`. Returns
    the bvh frame's scene (on the card)."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
    from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
    from rust_wgpu_raytracing_tpu_torch.ops.kernels import stream_sweep
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import \
        render_megakernel
    from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (
        PRNGKey, fold_in, render_pathtrace)

    wrapper = {f.__name__: f for f in K.KERNELS}
    plain = {f.__name__: p for f, p in zip(K.KERNELS, K.PLAIN)}
    gib = 2.0 ** 30

    seg = stream_sweep.SEG

    def tail(at, name, args, kw, reps=5, rounds=2):
        """(ms on all batches, ms of the heaviest batch alone): whether the
        longest walks set the launch's time; then both at other sizes of
        the work items (stream_sweep.SEG), each output bitwise the
        default's. Each time is the median of `rounds` rounds that visit
        the sizes in turn, each round the mean of `reps` launches."""
        top, adm = heaviest_batch(args[0], args[2])
        one = batch_args(args, torch.tensor([top], device=args[0].device))
        nsub = args[0].shape[1] - 1
        per = stream_blocks(args[0], args[2]).view(-1, nsub)
        want = flat(name, wrapper[name](*args, **kw))
        runs = {s: [] for s in SEGS}
        try:
            for s in SEGS:
                stream_sweep.SEG = s
                got = flat(name, wrapper[name](*args, **kw))
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{name}: SEG {s} changes the "
                                         f"output")
            for _ in range(rounds):
                for s in SEGS:
                    stream_sweep.SEG = s
                    runs[s].append((
                        time_ms(lambda: wrapper[name](*args, **kw), reps),
                        time_ms(lambda: wrapper[name](*one, **kw), reps)))
        finally:
            stream_sweep.SEG = seg
        out = {s: tuple(float(np.median(x)) for x in zip(*r))
               for s, r in runs.items()}
        sizes = [f"{s}: {f:.4f} / {a:.4f} ({100 * a / f:.1f}%)"
                 for s, (f, a) in out.items()]
        full, alone = out[seg]
        say(f"[tail] {card}: {name} at {at}'s arguments: all "
            f"{args[0].shape[0]} batches {full:.4f} ms, the heaviest batch "
            f"alone (batch {top}: {int(adm[top])} admitted blocks, at most "
            f"{int(per[top].max())} in one subtile, against a mean of "
            f"{float(per.float().mean()):.1f} a subtile) {alone:.4f} ms, "
            f"{100 * alone / full:.1f}% of the launch (items of at most "
            f"SEG {seg} admitted blocks; CUDA events around the wrapper, the "
            f"median of {rounds} rounds of {reps} launches)")
        say(f"[tail] {card}: {name} at {at}'s arguments by SEG, all batches "
            f"/ the heaviest alone, ms: {'; '.join(sizes)} (each output "
            f"bitwise SEG {seg}'s; sizes interleaved, as above)")
        return full, alone

    def check_culled(view, name, sub):
        """K9 or K11 without its boxes on the subset batches against the
        plain version."""
        check(view + ", 8 batches", name, sub[0][:BOX_ARG[name]], {},
              " (no boxes: every ray of an admitted block)")

    def pairs(at, name, args, kw):
        """raycull.walk_counts of K9's or K11's walk at these arguments
        (with the origin and the 32-face blocks' boxes)."""
        (n,) = culled_walk(name, args, kw, flat(name, wrapper[name](
            *args, **kw)))
        say(f"[pairs] {name} at {at}'s arguments, (ray, block) pairs in the "
            f"words its walk visits: admitted {n['admitted']}, entered "
            f"{n['entered']}, needed {n['face_pairs']} ({n['blocks']} "
            f"distinct blocks; box tests at least {n['box_tests']})")
        return n

    def frame_of(data, uni, accel, kernels, width=WIDTH, height=HEIGHT):
        return render_megakernel(data, uni, width=width, height=height,
                                 shadows=True, accel=accel, fused=False,
                                 kernels=kernels)

    # (a) the frame through the Renderer, cull then bvh
    colors, calls, origins = {}, {}, {}
    for accel in ("cull", "bvh"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rv = Renderer(stream_config(accel), device="cuda")
        built = time.perf_counter() - t0
        need = ["stream_closest_hit", "stream_anyhit", "texshade"]
        absent = ["closest_hit", "anyhit", "frame", "closest_hit_perray",
                  "extend_shadow"]
        (need if accel == "bvh" else absent).append("hier_cull")
        times, path_launches[f"stream_{accel}"], color, depth = drive(
            f"stream-1080p-terrain512 {accel}", rv, need, absent,
            frames=STREAM_FRAMES)
        peak = torch.cuda.max_memory_allocated()
        med = times[len(times) // 2]
        data = rv.data
        say(f"[stream] terrain:{STREAM_GRID}: {data.num_faces} faces "
            f"(padded {data.padded_faces}, {data.padded_faces // 1024} "
            f"superblocks, {data.blk_lo.shape[0]} clusters), record "
            f"{tuple(data.spack.shape)}, Renderer built in {built:.1f} s; "
            f"variant {rv.variant_chosen!r}; "
            f"{float((depth < 1).float().mean()):.4f} of pixels hit")
        say(f"[timing] {card}: stream-1080p-terrain512 {accel}, "
            f"{WIDTH}x{HEIGHT} shadowed split frame: median {med:.3f} ms "
            f"over {STREAM_FRAMES} frames after {WARMUP} warm-up (CUDA "
            f"events; min {times[0]:.3f}, max {times[-1]:.3f}), "
            f"{WIDTH * HEIGHT / (med * 1e-3) / 1e6:.1f} Mrays/s; peak "
            f"device memory {peak / gib:.3f} GiB "
            f"(max_memory_allocated, scene included)")
        colors[accel] = color
        uni = rv.camera.uniforms().flat()
        origins[accel] = torch.tensor(uni[32:35], device="cuda")
        calls[accel] = record(lambda ks: frame_of(data, uni, accel, ks))
        if accel == "cull":
            del rv
    if not torch.equal(colors["cull"], colors["bvh"]):
        raise AssertionError("streamed cull and bvh frames differ")
    flat_w = calls["cull"]["stream_closest_hit"][0][0][0][:, :-1]
    hier_w = calls["bvh"]["stream_closest_hit"][0][0][0][:, :-1]
    missing = int(((flat_w & ~hier_w) != 0).sum())

    def per_tile(words):
        w = words.reshape(-1, words.shape[-1]).to(torch.int64)
        return float(((w[:, :, None] >> torch.arange(32, device=w.device))
                      & 1).sum((1, 2)).float().mean())
    say(f"[stream] cull frame == bvh frame bitwise: True; primary mask "
        f"words: bvh a superset of the flat scan ({missing} flat words "
        f"not covered); admitted clusters per tile: flat "
        f"{per_tile(flat_w):.2f}, bvh {per_tile(hier_w):.2f}, of "
        f"{data.blk_lo.shape[0]}")
    if missing:
        raise AssertionError("bvh words miss flat-scan bits")

    # (b) the kernels against their plain versions on the frame's arguments
    check("stream frame, bvh primary", "hier_cull",
          *calls["bvh"]["hier_cull"][0])
    check("stream frame, bvh shadow wavefront", "hier_cull",
          *calls["bvh"]["hier_cull"][1])

    k9_args, k9_kw = calls["cull"]["stream_closest_hit"][0]
    k11_args, k11_kw = calls["cull"]["stream_anyhit"][0]
    k9_sub = subset_check(K, flat, errs, "stream frame, cull",
                          "stream_closest_hit", k9_args, k9_kw)
    k11_sub = subset_check(K, flat, errs,
                           "stream frame, cull (shadow wavefront)",
                           "stream_anyhit", k11_args, k11_kw)
    say(f"[stream] frame: {int(torch.isfinite(wrapper['stream_closest_hit'](*k9_args)[0]).sum())}"
        f" of {k9_args[3].numel()} rays hit; {int((k11_args[9] > 0).sum())}"
        f" active shadow rays; admitted blocks per subtile: K9 "
        f"{float(stream_blocks(k9_args[0], k9_args[2]).float().mean()):.1f}"
        f", K11 {float(stream_blocks(k11_args[0], k11_args[2]).float().mean()):.1f}")
    del calls["bvh"]["stream_closest_hit"], calls["bvh"]["stream_anyhit"]
    if not torch.equal(k9_args[9], origins["cull"]):
        raise AssertionError("K9 was not handed the camera origin")
    check_culled("stream frame, cull", "stream_closest_hit", k9_sub)
    check_culled("stream frame, cull (shadow wavefront)", "stream_anyhit",
                 k11_sub)
    tails = {"frame K9": tail(
                 "the cull frame's primary sweep", "stream_closest_hit",
                 k9_args, k9_kw),
             "frame K11": tail("the cull frame's shadow sweep",
                               "stream_anyhit", k11_args, k11_kw)}
    pairs("the cull frame's primary sweep", "stream_closest_hit", k9_args,
          k9_kw)
    pairs("the cull frame's shadow sweep", "stream_anyhit", k11_args,
          k11_kw)

    # (c) the kernel-run frame against the plain-composed one, terrain:128
    cfg = stream_config(grid=CHECK_GRID, width=640, height=360)
    small = Scene.build(cfg).data.to("cuda")
    uni = Camera.from_config(cfg.camera, 640 / 360).uniforms().flat()
    for accel in ("cull", "bvh"):
        a, _ = frame_of(small, uni, accel, K.KERNELS, 640, 360)
        b, _ = frame_of(small, uni, accel, K.PLAIN, 640, 360)
        dmax, exact, bitwise = frame_bar(a, b)
        say(f"[frame] terrain:{CHECK_GRID} ({small.num_faces} faces, "
            f"{small.padded_faces // 1024} superblocks) 640x360 {accel}: "
            f"kernels vs plain-composed frame bitwise {bitwise} (max linear "
            f"u8 delta {dmax}, exact {exact:.6f}, mean colour "
            f"{float(a.mean()):.5f})")
        if not bitwise:
            raise AssertionError("streamed frame differs from its plain twin")

    # (d) the path tracer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rp = Renderer(pt_stream_config(), device="cuda")
    K.reset_launch_counts()
    pt_times = []
    for i in range(1 + PTS_SAMPLES):
        rp.update()
        color, _ = rp.render(block=True)
        if i >= 1:
            pt_times.append(rp.last_frame_ms)
    path_launches["pt_stream"] = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    say(f"[path] pt-540p-terrain512: launches over {1 + PTS_SAMPLES} "
        f"samples: {path_launches['pt_stream']}")
    need = ("stream_closest_hit", "stream_closest_hit_perray",
            "stream_anyhit", "texfilter", "super_any")
    absent = ("closest_hit", "closest_hit_perray", "extend_shadow",
              "anyhit", "frame", "texshade", "hier_cull")
    missing = [k for k in need if path_launches["pt_stream"][k] == 0]
    extra = [k for k in absent if path_launches["pt_stream"][k] != 0]
    if missing or extra or not bool(torch.isfinite(color).all()) or \
            tuple(color.shape) != (PTS_H, PTS_W, 3):
        raise AssertionError(f"streamed path tracer: never launched "
                             f"{missing}, off the path launched {extra}")
    pt_times.sort()
    med = pt_times[len(pt_times) // 2]
    say(f"[timing] {card}: pt-540p-terrain512 ({PTS_W}x{PTS_H}, "
        f"{PTS_BOUNCES} bounces): median {med:.3f} ms per sample over "
        f"{PTS_SAMPLES} samples after 1 warm-up (CUDA events; min "
        f"{pt_times[0]:.3f}, max {pt_times[-1]:.3f}), "
        f"{PTS_W * PTS_H / (med * 1e-3) / 1e6:.4f} Mpaths/s; peak device "
        f"memory {peak / gib:.3f} GiB; mean radiance "
        f"{float(color.mean()):.5f}")
    pt_uni = rp.camera.uniforms().flat()
    pt_calls = record(lambda ks: render_pathtrace(
        rp.data, pt_uni, fold_in(PRNGKey(PT_SEED), 0), width=PTS_W,
        height=PTS_H, bounces=PTS_BOUNCES, spp=1, compact_cap="auto",
        kernels=ks))
    say(f"[pt] streamed sample: kernel calls "
        f"{ {k: len(v) for k, v in pt_calls.items()} }")
    super_any_phase(card, K, Renderer, results, errs, say, pt_calls)
    sweep_front_phase(card, K, Renderer, results, say)
    k10_args, k10_kw = pt_calls["stream_closest_hit_perray"][0]
    k11b_args, k11b_kw = pt_calls["stream_anyhit"][0]
    k9b_args, k9b_kw = pt_calls["stream_closest_hit"][0]
    subset_check(K, flat, errs, "pt primary rays", "stream_closest_hit",
                 k9b_args, k9b_kw)
    k10_sub = subset_check(K, flat, errs, "pt bounce 1 (extension rays)",
                           "stream_closest_hit_perray", k10_args, k10_kw)
    k11b_sub = subset_check(K, flat, errs,
                            "pt bounce 1 (shadow rays of bounce 0)",
                            "stream_anyhit", k11b_args, k11b_kw)
    check_culled("pt bounce 1 (shadow rays of bounce 0)", "stream_anyhit",
                 k11b_sub)
    tails["PT K11"] = tail("the PT's bounce-1 shadow sweep", "stream_anyhit",
                           k11b_args, k11b_kw)
    tail("the PT's primary sweep", "stream_closest_hit", k9b_args, k9b_kw)
    pairs("the PT's bounce-1 shadow sweep", "stream_anyhit", k11b_args,
          k11b_kw)
    check("pt bounce 1 (extension rays), 8 batches",
          "stream_closest_hit_perray", k10_sub[0][:11], k10_kw,
          " (no boxes: every ray of an admitted block)")
    (k10n,) = culled_walk("stream_closest_hit_perray", k10_args, k10_kw,
                          flat("stream_closest_hit_perray", wrapper[
                              "stream_closest_hit_perray"](*k10_args)))
    say(f"[pt] K10 bounce 1, (ray, block) pairs in the words its walk "
        f"visits: admitted {k10n['admitted']}, entered {k10n['entered']}, "
        f"entered at or below the final t {k10n['face_pairs']} "
        f"({k10n['blocks']} distinct blocks)")
    say(f"[pt] bounce 1: {int((k10_args[3] != 0).sum())} aimed extension "
        f"rays, admitted blocks per subtile K10 "
        f"{float(stream_blocks(k10_args[0], k10_args[2]).float().mean()):.1f}"
        f", K11 {float(stream_blocks(k11b_args[0], k11b_args[2]).float().mean()):.1f}")
    del rp, pt_calls
    pcfg = pt_stream_config(CHECK_GRID, 320, 180)
    pdata = Scene.build(pcfg).data.to("cuda")
    puni = Camera.from_config(pcfg.camera, 320 / 180).uniforms().flat()
    samples = [render_pathtrace(pdata, puni, fold_in(PRNGKey(PT_SEED), 0),
                                width=320, height=180, bounces=PTS_BOUNCES,
                                spp=1, compact_cap="auto", kernels=ks)
               for ks in (K.KERNELS, K.PLAIN)]
    same = torch.equal(samples[0], samples[1])
    say(f"[pt] terrain:{CHECK_GRID} 320x180, {PTS_BOUNCES} bounces: one "
        f"sample through the kernels vs composed from the plain versions: "
        f"bitwise {same} (max_abs_err "
        f"{max_abs_err(samples[0], samples[1])!r}); radiance sum "
        f"{float(samples[0].sum()):.3f}")
    if not same:
        raise AssertionError("streamed sample differs from its plain twin")

    # (e) timing at the paths' arguments, turns plain, kernel, kernel (the
    # plain versions take 8-20 s a call here: timed once)
    # (key, kernel, its call, the plain version's (args, where), the path)
    timed = [("hier_cull", "hier_cull", calls["bvh"]["hier_cull"][0],
              (None, "plain on the same arguments"),
              "the bvh frame's primary cull"),
             ("hier_cull (shadow)", "hier_cull", calls["bvh"]["hier_cull"][1],
              (None, "plain on the same arguments"),
              "the bvh frame's shadow cull"),
             ("stream_closest_hit", "stream_closest_hit", (k9_args, k9_kw),
              k9_sub, "the cull frame's primary sweep"),
             ("stream_anyhit", "stream_anyhit", (k11_args, k11_kw), k11_sub,
              "the cull frame's shadow sweep"),
             ("stream_anyhit (PT)", "stream_anyhit", (k11b_args, k11b_kw),
              k11b_sub, "the PT's bounce-1 shadow sweep"),
             ("stream_closest_hit_perray", "stream_closest_hit_perray",
              (k10_args, k10_kw), k10_sub, "the PT's bounce-1 sweep")]
    for key, name, (args, kw), (sub, where), at in timed:
        p_args = sub if sub is not None else args

        def run_kernel():
            return wrapper[name](*args, **kw)

        def run_plain():
            return plain[name](*p_args, **kw)
        p1 = time_ms(run_plain, 1)
        k1 = time_ms(run_kernel, 10)
        k2 = time_ms(run_kernel, 10)
        outs = flat(name, run_kernel())
        moved, ops = kernel_work(name, args, kw, outs)
        bound_ms, bound_by = bound(moved, ops)
        unfused_ms, _ = bound(moved, ops, FP32_UNFUSED_S)
        ms = (k1 + k2) / 2
        if key == name:
            results[name] = dict(max_abs_err=errs[name], ms=ms,
                                 plain_ms=p1, bound_ms=bound_ms,
                                 bound_by=bound_by)
        note = ""
        if name != "hier_cull":
            note = mask_walk_note(name, args, kw, outs, ms) \
                + walk_parts(name, args, kw, 10)
        else:
            dev, how = device_ms(run_kernel, 20, "hier_cull_kernel")
            note = (f"; device time {dev:.4f} ms a launch ({how}; the "
                    f"events time the wrapper's host work), bound "
                    f"{100 * bound_ms / dev:.1f}% of it")
            if key == name:
                results[name]["ms"] = dev
        tail_ms = tails.get({"stream_closest_hit": "frame K9",
                             "stream_anyhit": "frame K11",
                             "stream_anyhit (PT)": "PT K11"}.get(key))
        if tail_ms:
            note += (f"; the heaviest batch alone {tail_ms[1]:.4f} ms of "
                     f"{tail_ms[0]:.4f}")
        say(f"[timing] {card}: {key} {ms:.4f} ms (kernel, {k1:.4f} / "
            f"{k2:.4f}) vs {p1:.4f} ms ({where}) at "
            f"{at}'s arguments; bound {bound_ms:.4f} ms by {bound_by} "
            f"({moved} bytes, {ops} FP32 operations), "
            f"{100 * bound_ms / ms:.1f}% of it; {unfused_ms:.4f} ms at the "
            f"unfused issue rate, {100 * unfused_ms / ms:.1f}% of it{note}")
    return data


def super_any_work(args, kw, out):
    """(bytes, FP32 operations, all pairs) of one super_any call: the ray
    planes and act in once, the boxes in once, the flags out once; the
    operations of the (live ray, superblock) pairs an admission needs: a
    tile rejects a superblock only after all its live rays, and admits it
    after one."""
    import torch

    slo, dx, tile_r = args[0], args[5], args[8]
    act = kw.get("act")
    n_rays, n_super = dx.shape[0], slo.shape[0]
    n_tiles = n_rays // tile_r
    live = (act.view(n_tiles, tile_r).sum(1) if act is not None else
            torch.full((n_tiles,), tile_r, device=dx.device))
    adm = out.sum(1)
    need = int((live * (n_super - adm) + adm * (live > 0)).sum())
    moved = n_rays * (6 * 4 + (1 if act is not None else 0)) \
        + n_super * 6 * 4 + n_tiles * n_super
    return moved, need * OPS_SUPER_ANY, int(live.sum()) * n_super


def super_any_phase(card, K, Renderer, results, errs, say, calls=None):
    """The admission kernel super_any (csrc/super_any.cu) at the
    pt-540p-terrain512 sample's bounce wavefronts (the benchmark cell
    terrain512-bvh.pt3-540p's scene and size): each call bitwise its plain
    twin (traverse.perray_super_any), and the bounce-1 call timed against
    it, beside its bound by bytes and by operations, into `results`.
    `calls`: the sample's recorded kernel calls (None: record one)."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (
        PRNGKey, fold_in, render_pathtrace)

    if calls is None:
        rp = Renderer(pt_stream_config(), device="cuda")
        ks, calls = _recording(K)
        render_pathtrace(rp.data, rp.camera.uniforms().flat(),
                         fold_in(PRNGKey(PT_SEED), 0), width=PTS_W,
                         height=PTS_H, bounces=PTS_BOUNCES, spp=1,
                         compact_cap="auto", kernels=ks)
        torch.cuda.synchronize()
        del rp
    sa = calls.get("super_any", [])
    if len(sa) != PTS_BOUNCES:
        raise AssertionError(f"super_any: {len(sa)} calls in a "
                             f"{PTS_BOUNCES}-bounce streamed sample")
    for i, (args, kw) in enumerate(sa):
        got = K.super_any(*args, **kw)
        want = K.PLAIN.super_any(*args, **kw)
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        moved, ops, pairs = super_any_work(args, kw, got)
        say(f"[super_any] bounce {i + 1}: {args[5].shape[0]} rays "
            f"({int(kw['act'].sum())} live), {args[0].shape[0]} "
            f"superblocks, {int(got.sum())} of {got.numel()} (tile, "
            f"superblock) pairs admitted; kernel vs plain bitwise {exact}")
        if not exact:
            raise AssertionError(f"super_any disagrees with its plain "
                                 f"version at bounce {i + 1}")
        errs["super_any"] = max(errs.get("super_any", 0.0),
                                max_abs_err(got, want))
    args, kw = sa[0]
    p1 = time_ms(lambda: K.PLAIN.super_any(*args, **kw), 2)
    k1 = time_ms(lambda: K.super_any(*args, **kw), 20)
    k2 = time_ms(lambda: K.super_any(*args, **kw), 20)
    dev, how = device_ms(lambda: K.super_any(*args, **kw), 20,
                         "super_any_kernel")
    moved, ops, pairs = super_any_work(args, kw, K.super_any(*args, **kw))
    bound_ms, bound_by = bound(moved, ops)
    all_ms, _ = bound(moved, pairs * OPS_SUPER_ANY)
    ms = (k1 + k2) / 2
    results["super_any"] = dict(max_abs_err=errs["super_any"], ms=ms,
                                plain_ms=p1, bound_ms=bound_ms,
                                bound_by=bound_by)
    say(f"[timing] {card}: super_any {ms:.4f} ms (kernel, CUDA events, "
        f"mean of 20 launches: {k1:.4f} / {k2:.4f}; device time "
        f"{dev:.4f} ms, {how}) vs {p1:.4f} ms (plain, mean of 2) at the "
        f"pt-540p-terrain512 bounce-1 wavefront; bound {bound_ms:.4f} ms "
        f"by {bound_by} ({moved} bytes, {ops} FP32 operations of the "
        f"pairs an admission needs), {100 * bound_ms / dev:.1f}% of the "
        f"device time; every live pair ({pairs} pairs) {all_ms:.4f} ms, "
        f"{100 * all_ms / dev:.1f}%; the bytes alone "
        f"{moved / HBM_BYTES_S * 1e3:.4f} ms")


def sweep_front_bytes(args, kw, out) -> int:
    """Bytes one sweep_front call moves at the least: the ray planes
    (three for a shared origin) and act in once, the boxes and given
    words in once, each output out once."""
    import torch

    o, dx, act = args[0], args[1], args[4]
    planes = 3 + (0 if torch.is_tensor(o) else 3) + (act is not None)
    moved = dx.shape[0] * 4 * planes
    for pair in (kw.get("cull_boxes"), kw.get("sched_boxes"),
                 kw.get("root")):
        moved += sum(b.numel() * 4 for b in pair or ())
    if kw.get("words") is not None:
        moved += kw["words"].numel() * 4
    outs = list(out.bounds)
    if out.mask_bounds is not out.bounds:
        outs += list(out.mask_bounds)
    if kw.get("words") is None:
        outs.append(out.words)
    outs += [out.tlb, out.order, out.texit]
    return moved + sum(t.numel() * 4 for t in outs if t is not None)


def sweep_front_same(got, want) -> bool:
    """K13 against its plain twin: every output bitwise, a tile bound up
    to the sign of a zero (kernels/sweep_front.py says why)."""
    import torch

    def bits(x, signless=False):
        if x.dtype != torch.float32:
            return x
        x = x + 0.0 if signless else x
        return torch.where(torch.isnan(x), float("nan"), x).view(torch.int32)
    for g, w in zip(got.bounds + got.mask_bounds,
                    want.bounds + want.mask_bounds):
        if not torch.equal(bits(g, True), bits(w, True)):
            return False
    for g, w in zip(got[2:], want[2:]):
        if (g is None) != (w is None) or (
                g is not None and not torch.equal(bits(g), bits(w))):
            return False
    return True


def sweep_front_phase(card, K, Renderer, results, say):
    """K13 (kernels.sweep_front, csrc/sweep_front.cu) at the ray sets of
    the benchmark cells refscene-terrain91.orbit-1080p (the fused 1080p
    frame's camera and shadow rays) and instances64-terrain23.still-4k
    (the 4K camera rays of 64 refit instances): each call bitwise its
    plain twin, timed against it (CUDA events: the kernel's mean of 20
    launches, the plain twin's of 2; the kernel's device time from
    torch.profiler) beside its byte bound; results["sweep_front"] takes
    the refscene camera rays'. Then the orbit Renderer's launches: K13
    and sweep_inputs calls over its eager and capture frames, and the
    device operations a replayed frame (torch.profiler)."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.config import (
        CameraConfig, MeshConfig, RenderConfig, SceneConfig, reference_scene)
    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
    from rust_wgpu_raytracing_tpu_torch.ops import instances as pinst
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import \
        render_megakernel
    from rust_wgpu_raytracing_tpu_torch.runtime import profiler

    # the refscene configuration (rtbench/configs/refscene-terrain91.json)
    orbit_cfg = SceneConfig(
        spheres=reference_scene().spheres,
        meshes=(MeshConfig(obj_path="builtin:terrain:91",
                           translation=(0.0, 0.0, -3.0),
                           light_direction=(6.0, -1.0, 1.0)),),
        camera=CameraConfig(eye=DENSE_EYE, target=DENSE_TARGET),
        render=RenderConfig(width=WIDTH, height=HEIGHT, shadows=True,
                            accel="cull", variant="fused"))
    rv = Renderer(orbit_cfg, device="cuda")
    ks, calls = _recording(K)
    render_megakernel(rv.data, rv.camera.uniforms().flat(), width=WIDTH,
                      height=HEIGHT, shadows=True, fused=True, kernels=ks)
    sets = [("refscene 1080p camera rays", *calls["sweep_front"][0]),
            ("refscene 1080p shadow rays", *calls["sweep_front"][1])]
    inst = pinst.InstancedScene.from_config(MeshConfig(obj_path=INST_MESH),
                                            64, device="cuda")
    soup = inst.instantiate(pinst.grid_transforms(64, z=-6.0,
                                                  angle=INST_ANGLE))
    w4, h4 = INST_4K
    uni4 = Camera.from_config(CameraConfig(eye=(0.0, 7.0, -2.0),
                                           target=(0.0, 0.0, -6.0)),
                              w4 / h4).uniforms().flat()
    ks, calls = _recording(K)
    render_megakernel(soup, uni4, width=w4, height=h4, accel="bvh",
                      fused=False, kernels=ks)
    sets.append(("instances64 4K camera rays", *calls["sweep_front"][0]))
    torch.cuda.synchronize()
    for label, args, kw in sets:
        got = K.sweep_front(*args, **kw)
        want = K.PLAIN.sweep_front(*args, **kw)
        torch.cuda.synchronize()
        exact = sweep_front_same(got, want)
        n_tiles = got.bounds[0].shape[0]
        what = ", ".join(k for k in ("cull_boxes", "words", "sched_boxes",
                                     "root") if kw.get(k) is not None)
        say(f"[sweep_front] {label}: {args[1].shape[0]} rays, {n_tiles} "
            f"tiles, {kw['faces'] // kw['block_f']} blocks of "
            f"{kw['block_f']} faces, gates {kw.get('gate')} / "
            f"{kw.get('mask_gate')}, given {what}; kernel vs plain bitwise "
            f"{exact}")
        if not exact:
            raise AssertionError(f"sweep_front disagrees with its plain "
                                 f"twin at the {label}")
        p1 = time_ms(lambda: K.PLAIN.sweep_front(*args, **kw), 2)
        k1 = time_ms(lambda: K.sweep_front(*args, **kw), 20)
        k2 = time_ms(lambda: K.sweep_front(*args, **kw), 20)
        p2 = time_ms(lambda: K.PLAIN.sweep_front(*args, **kw), 2)
        dev, how = device_ms(lambda: K.sweep_front(*args, **kw), 20,
                             "sweep_front_kernel")
        moved = sweep_front_bytes(args, kw, got)
        bound_ms, bound_by = bound(moved, 0)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        say(f"[timing] {card}: sweep_front {ms:.4f} ms (kernel, CUDA "
            f"events, mean of 20 launches: {k1:.4f} / {k2:.4f}; device "
            f"time {dev:.4f} ms, {how}) vs {plain_ms:.4f} ms (plain, "
            f"{p1:.4f} / {p2:.4f}) at the {label}; bound {bound_ms:.4f} ms "
            f"by {bound_by} ({moved} bytes), {100 * bound_ms / dev:.1f}% "
            f"of the device time")
        if "sweep_front" not in results:
            results["sweep_front"] = dict(max_abs_err=0.0, ms=ms,
                                          plain_ms=plain_ms,
                                          bound_ms=bound_ms,
                                          bound_by=bound_by)
    del soup, inst

    # the orbit Renderer: its eager and capture frames launch K13 once a
    # sweep_inputs call; a replay launches nothing from the host
    before = profiler.counters()
    rv.controller.process_key("d", True)
    for _ in range(4):
        rv.update()
        rv.render(block=True)
    now = profiler.counters()
    fronts, inputs, captures, replays = (
        now.get(k, 0) - before.get(k, 0)
        for k in ("launches.sweep_front", "sweep.inputs",
                  "frame.graph_captures", "frame.graph_replays"))
    say(f"[sweep_front] refscene orbit Renderer, 4 frames (graph captures "
        f"{captures}, replays {replays}): launches.sweep_front {fronts}, "
        f"sweep.inputs {inputs}, ratio "
        f"{fronts / inputs if inputs else float('nan'):.3f}")
    if inputs == 0 or fronts != inputs:
        raise AssertionError(f"sweep_front: {fronts} launches for {inputs} "
                             f"sweep_inputs calls")
    prof = profile_frames(rv)
    prof.pop("top")
    say(f"[sweep_front] {card}: refscene orbit 1080p, replayed frames "
        f"{json.dumps(prof)}")


def oracle_phase(card, K, Renderer, frame, say):
    """Phase 8: Renderer(backend="oracle") on the smoke scene at 1080p
    with shadows (1 warm-up, ORACLE_FRAMES timed frames, CUDA events;
    peak device memory), its frame held at the frame bar against the
    fused and the split frame at the same camera."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ro = Renderer(smoke_config(), backend="oracle", device="cuda")
    if ro.backend != "oracle" or ro.variant_chosen is not None:
        raise AssertionError("backend='oracle' did not take the oracle")
    K.reset_launch_counts()
    times = []
    for i in range(1 + ORACLE_FRAMES):
        color, depth = ro.render(block=True)
        if i >= 1:
            times.append(ro.last_frame_ms)
    launched = {k: v for k, v in K.launch_counts().items() if v}
    peak = torch.cuda.max_memory_allocated()
    if launched or tuple(color.shape) != (HEIGHT, WIDTH, 3) or \
            not bool(torch.isfinite(color).all()):
        raise AssertionError(f"oracle frame: bad frame or kernels launched "
                             f"{launched}")
    say(f"[timing] {card}: oracle-1080p-terrain91 (Renderer(backend="
        f"'oracle'), {WIDTH}x{HEIGHT} shadowed, {ro.data.num_faces} faces "
        f"brute force): {', '.join(f'{t:.1f}' for t in times)} ms per "
        f"frame over {ORACLE_FRAMES} frames after 1 warm-up (CUDA events), "
        f"mean {float(np.mean(times)):.1f}; peak device memory "
        f"{peak / 2.0 ** 30:.3f} GiB (max_memory_allocated, every resident "
        f"scene included); no kernel of the package launched; a spec, no "
        f"yardstick")
    uni = ro.camera.uniforms().flat()
    for variant, fused in (("fused", True), ("split", False)):
        kc, kd = frame(ro.data, uni, K.KERNELS, fused)
        dmax, exact, bitwise = frame_bar(color, kc)
        say(f"[frame] oracle vs {variant} frame at {WIDTH}x{HEIGHT}: "
            f"{int((color != kc).sum())} of {color.numel()} quantized "
            f"subpixels differ, max linear u8 delta {dmax}, exact "
            f"{exact:.6f}, bitwise {bitwise}; depth differs at "
            f"{int((depth != kd).sum())} pixels, max_abs_err "
            f"{max_abs_err(depth, kd)!r} (the frames' rays are d * (1/|d|), "
            f"the oracle's d / |d|, as in the JAX package)")
        if dmax > 1 or exact < 0.999:
            raise AssertionError(f"the {variant} frame disagrees with the "
                                 f"oracle")
    say(f"[frame] oracle: mean colour {float(color.mean()):.5f}, "
        f"{float((depth < 1).float().mean()):.4f} of pixels hit")


def mip_config(nm: bool, far: bool = False):
    """The nm heightfield (write_nm_assets) with mip sampling: split,
    shadows, normal mapping on or off; far: the camera MIP_FAR_EYE."""
    import dataclasses as dc

    from rust_wgpu_raytracing_tpu_torch.config import CameraConfig

    cfg = nm_config(shadows=True)
    cam = (CameraConfig(eye=MIP_FAR_EYE, target=MIP_FAR_TARGET) if far
           else cfg.camera)
    return dc.replace(cfg, meshes=(dc.replace(cfg.meshes[0],
                                              normal_mapping=nm),),
                      camera=cam, render=dc.replace(cfg.render, mip=True))


def mip_lods(data, uni):
    """(R_hit,) the ray-cone LOD of the hit pixels of a 1080p frame, as
    the mip frame computes it (ops/miptex.py ray_cone_lod on the split
    frame's tiled rays and G-buffer)."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.core.camera import CameraUniforms
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import (
        _pick_tile_shape, gbuffer, raygen_planar_tiled)
    from rust_wgpu_raytracing_tpu_torch.ops.miptex import ray_cone_lod

    u = CameraUniforms.unflat(np.asarray(uni, np.float32))
    tile_h, tile_w, render_h = _pick_tile_shape(WIDTH, HEIGHT)
    dx, dy, dz = raygen_planar_tiled(WIDTH, render_h, u, device="cuda",
                                     total_height=HEIGHT, tile_h=tile_h,
                                     tile_w=tile_w)
    origin = torch.tensor(u.origin, dtype=torch.float32, device="cuda")
    gb, _ = gbuffer(data, origin, dx, dy, dz)
    lod = ray_cone_lod(data, gb, dx, dy, dz, tile_w)
    return lod[torch.isfinite(gb.t)]


def host_frames(before, frames):
    """Of `frames` Renderer frames drawn since the profiler's counters
    read `before`, those whose kernels the host launched (and the launch
    counters counted): a replayed frame launches none, its kernels run as
    the captured graph's nodes, and a capture's own frame is counted
    once at the capture and once as a replay."""
    from rust_wgpu_raytracing_tpu_torch.runtime import profiler

    now = profiler.counters()
    captures, replays = (now.get(k, 0) - before.get(k, 0)
                         for k in ("frame.graph_captures",
                                   "frame.graph_replays"))
    return frames - replays + captures


def mip_phase(card, K, Renderer, drive, record, path_launches, say):
    """Phase 9: mip-1080p-heightfield91 through the Renderer (split,
    shadows, normal mapping on and off; WARMUP + FRAMES frames, orbit key
    held): launch counts (K6 twice a frame, three times with normal
    mapping; no K2, no K4), median ms; each frame through K6 bitwise the
    frame composed with texfilter_plain on the card, at the dense view
    and at a far view whose LOD exceeds 1 on most hit pixels (mean LOD
    printed); K6's time beside its plain version and bound at the mip
    frame's first tap."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import \
        render_megakernel
    from rust_wgpu_raytracing_tpu_torch.runtime import profiler

    plain_k6 = K.KERNELS._replace(texfilter=K.PLAIN.texfilter)
    for nm in (True, False):
        rv = Renderer(mip_config(nm), device="cuda")
        if rv.variant_chosen != "split":
            raise AssertionError("mip must render split")
        before = profiler.counters()
        times, launches, color, _ = drive(
            f"mip, normal mapping {nm}", rv,
            ("closest_hit", "texfilter", "anyhit"), ("frame", "texshade"))
        path_launches[f"mip_nm{int(nm)}"] = launches
        per = launches["texfilter"] / host_frames(before, WARMUP + FRAMES)
        if per != (3 if nm else 2):
            raise AssertionError(f"mip: {per} K6 launches a frame")
        med = times[len(times) // 2]
        say(f"[timing] {card}: mip-1080p-heightfield91 (mip, split, shadows, "
            f"normal mapping {nm}): median {med:.3f} ms/frame over {FRAMES} "
            f"frames after {WARMUP} warm-up (CUDA events; min {times[0]:.3f}"
            f", max {times[-1]:.3f}), {WIDTH * HEIGHT / (med * 1e-3) / 1e6:.1f}"
            f" Mrays/s; K6 launches {per:g} a frame")
        views = [("the Renderer's last", rv.camera.uniforms().flat()),
                 ("the far", Camera.from_config(mip_config(nm, far=True).camera,
                                                WIDTH / HEIGHT).uniforms().flat())]
        for view, uni in views:
            a, _ = render_megakernel(
                rv.data, uni, width=WIDTH, height=HEIGHT, shadows=True,
                normal_mapping=nm, mip=True, kernels=K.KERNELS)
            b, _ = render_megakernel(
                rv.data, uni, width=WIDTH, height=HEIGHT, shadows=True,
                normal_mapping=nm, mip=True, kernels=plain_k6)
            lod = mip_lods(rv.data, uni)
            say(f"[frame] mip, normal mapping {nm}, {view} view: through K6 "
                f"vs composed with texfilter_plain: bitwise "
                f"{bool(torch.equal(a, b))}; {lod.numel()} hit pixels, mean "
                f"LOD {float(lod.mean()):.3f}, LOD > 1 on "
                f"{float((lod > 1).float().mean()):.4f} of them")
            if not torch.equal(a, b):
                raise AssertionError("the mip frame through K6 differs from "
                                     "its texfilter_plain twin")
            if view == "the far" and float((lod > 1).float().mean()) <= 0.5:
                raise AssertionError("the far view does not reach level 1")
    # K6 at the mip frame's first pyramid tap (normal mapping off)
    calls = record(lambda ks: render_megakernel(
        rv.data, rv.camera.uniforms().flat(), width=WIDTH, height=HEIGHT,
        shadows=True, mip=True, kernels=ks))
    args, kw = calls["texfilter"][0]
    wrapper, plain = K.KERNELS.texfilter, K.PLAIN.texfilter
    p1 = time_ms(lambda: plain(*args, **kw), 2)
    k1 = time_ms(lambda: wrapper(*args, **kw), 20)
    k2 = time_ms(lambda: wrapper(*args, **kw), 20)
    p2 = time_ms(lambda: plain(*args, **kw), 2)
    ms = (k1 + k2) / 2
    moved, ops = kernel_work("texfilter", args, kw, wrapper(*args, **kw))
    bound_ms, bound_by = bound(moved, ops)
    say(f"[timing] {card}: texfilter {ms:.4f} ms (kernel, {k1:.4f} / "
        f"{k2:.4f}) vs {(p1 + p2) / 2:.4f} ms (plain PyTorch) at the mip "
        f"frame's first pyramid tap ({args[0].shape[1]} rays); bound "
        f"{bound_ms:.4f} ms by {bound_by} ({moved} bytes, {ops} FP32 "
        f"operations), {100 * bound_ms / ms:.1f}% of it")


def write_terrain_obj(path: str, n: int) -> int:
    """Write builtin:terrain:n (io/obj.make_terrain) as an OBJ file with
    positions, texture coordinates and normals (9 significant digits:
    every float32 read back exactly), one group and no material; returns
    its face count."""
    from rust_wgpu_raytracing_tpu_torch.io.obj import make_terrain

    m = make_terrain(n)
    f = m.faces.astype(np.int64) + 1
    with open(path, "w") as out:
        np.savetxt(out, m.positions, fmt="v %.9g %.9g %.9g")
        np.savetxt(out, m.uvs, fmt="vt %.9g %.9g")
        np.savetxt(out, m.normals, fmt="vn %.9g %.9g %.9g")
        np.savetxt(out, np.repeat(f, 3, axis=1),
                   fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
    return len(f)


def obj_parse_timing(card, say):
    """The OBJ import of the streamed scene's mesh (builtin:terrain:512,
    written as an OBJ file): io/obj.load_obj by the native C++ parser
    (best of 3) and by the pure-Python parser (once), host clock, their
    arrays equal."""
    from rust_wgpu_raytracing_tpu_torch.io.obj import load_obj

    root = tempfile.mkdtemp(prefix="rt_obj_")
    try:
        path = os.path.join(root, f"terrain{STREAM_GRID}.obj")
        n_faces = write_terrain_obj(path, STREAM_GRID)
        mb = os.path.getsize(path) / 2**20
        runs, meshes = {True: [], False: []}, {}
        for use_native, reps in ((True, 3), (False, 1)):
            for _ in range(reps):
                t0 = time.perf_counter()
                meshes[use_native], _ = load_obj(path, use_native=use_native)
                runs[use_native].append(time.perf_counter() - t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    (a,), (b,) = meshes[True], meshes[False]
    same = all(x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(
        (a.positions, a.uvs, a.normals, a.faces),
        (b.positions, b.uvs, b.normals, b.faces)))
    say(f"[obj] {card}: load_obj of terrain:{STREAM_GRID} as an OBJ file "
        f"({n_faces} faces, {mb:.1f} MiB): native C++ "
        f"{min(runs[True]) * 1e3:.1f} ms (best of 3), pure Python "
        f"{runs[False][0] * 1e3:.1f} ms (one parse); host clock on the card "
        f"machine's CPU, not the card; arrays equal: {same}")
    if not same:
        raise AssertionError("the native and Python OBJ parsers differ")


def lbvh_phase(card, data, say):
    """Phase 10: the LBVH on the streamed scene (the bvh frame's scene):
    the host build of bench_configs.py config 9 (cluster-centre Morton
    codes, build_lbvh + linearize_bvh, best of 3, host clock) by the
    native C++ builder (native/rtnative.cpp, built with g++ at first use;
    the phase fails where it did not build) and by the NumPy build, their
    arrays equal; the OBJ import of the scene's mesh by both parsers
    (obj_parse_timing); on the card
    bvh_walk_mask_words over the scene's bvh_pack at the tiles of the
    cell's 1080p frame (its configured camera), a superset of the flat
    scan's words (CUDA events, the call's host checks included); and on
    builtin:terrain:23 at 128x128 its words equal to the flat scan's (the
    JAX package's tests/test_accel.py)."""
    import torch

    from rust_wgpu_raytracing_tpu_torch import native
    from rust_wgpu_raytracing_tpu_torch.config import (CameraConfig,
                                                       MeshConfig,
                                                       RenderConfig,
                                                       SceneConfig)
    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
    from rust_wgpu_raytracing_tpu_torch.core.scene import Scene
    from rust_wgpu_raytracing_tpu_torch.ops.bvh import (build_lbvh,
                                                       linearize_bvh,
                                                       morton3d)
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import (
        _mask_words, _pick_tile_shape, raygen_planar, raygen_planar_tiled)
    from rust_wgpu_raytracing_tpu_torch.ops.traverse import (
        WALK_CHECK_STEPS, bvh_walk_mask_words, tile_ray_bounds)

    lo = data.blk_lo.cpu().numpy()
    hi = data.blk_hi.cpu().numpy()
    fin = np.isfinite(lo).all(1) & np.isfinite(hi).all(1)
    lo, hi = lo[fin], hi[fin]
    codes = morton3d((lo + hi) * 0.5)
    order = np.argsort(codes, kind="stable")
    codes, lo, hi = codes[order], lo[order].copy(), hi[order].copy()
    if not native.available():
        raise AssertionError(
            f"the native host library did not build (g++ "
            f"{shutil.which('g++')!r}, RWRT_NO_NATIVE "
            f"{os.environ.get('RWRT_NO_NATIVE')!r})")
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    runs = {True: [], False: []}
    trees, packs = {}, {}
    for _ in range(3):
        for use_native in (True, False):
            t0 = time.perf_counter()
            trees[use_native] = build_lbvh(codes, lo, hi,
                                           use_native=use_native)
            t1 = time.perf_counter()
            packs[use_native] = linearize_bvh(trees[use_native])
            runs[use_native].append((t1 - t0, time.perf_counter() - t1))
    same = all(np.array_equal(getattr(trees[True], f),
                              getattr(trees[False], f))
               for f in ("left", "right", "parent", "node_lo", "node_hi")) \
        and np.array_equal(packs[True], packs[False])
    lib = os.path.relpath(native.library_path())
    for use_native, label in ((True, f"native C++ ({lib}, {gxx})"),
                              (False, "NumPy")):
        b, l = min(runs[use_native], key=sum)
        say(f"[lbvh] {card}: host build of {len(codes)} cluster leaves "
            f"(terrain:{STREAM_GRID}, {data.num_faces} faces; "
            f"bench_configs.py config 9's leaves) by the {label} builder: "
            f"build_lbvh + linearize_bvh {(b + l) * 1e3:.3f} ms (build "
            f"{b * 1e3:.3f}, linearize {l * 1e3:.3f}; best of 3, host "
            f"clock on the card machine's CPU, not the card)")
    say(f"[lbvh] the two builders' arrays (left, right, parent, node_lo, "
        f"node_hi, the linearized pack {packs[True].shape}) equal: {same}; "
        f"Scene.build's builder: native C++ (build_lbvh's default, the "
        f"library built); the scene's own bvh_pack "
        f"{tuple(data.bvh_pack.shape)}, {data.bvh_nodes} nodes")
    if not same:
        raise AssertionError("the native and NumPy LBVH builds differ")
    obj_parse_timing(card, say)

    def words_of(d, u, width, height, tiled):
        """(walk words, flat-scan words), (T, nwords) each, and the walk's
        ms (CUDA events around the call after a warm-up call)."""
        if tiled:
            tile_h, tile_w, render_h = _pick_tile_shape(width, height)
            dx, dy, dz = raygen_planar_tiled(
                width, render_h, u, device="cuda", total_height=height,
                tile_h=tile_h, tile_w=tile_w)
        else:
            dx, dy, dz = raygen_planar(width, height, u, device="cuda")
        o = torch.tensor(u.origin, dtype=torch.float32, device="cuda")
        f = d.padded_faces
        nb = d.blk_lo.shape[0]
        bounds = tile_ray_bounds(o[0], o[1], o[2], dx, dy, dz, 1024)
        flat, nwords = _mask_words(d, "cull", bounds, f // nb)
        bvh_walk_mask_words(d.bvh_pack, d.bvh_nodes, *bounds, nwords)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        walk = bvh_walk_mask_words(d.bvh_pack, d.bvh_nodes, *bounds, nwords)
        end.record()
        end.synchronize()
        return walk, flat.view(-1, nwords), start.elapsed_time(end)

    def bits(w):
        return int(((w.to(torch.int64)[..., None] >> torch.arange(
            32, device=w.device)) & 1).sum())

    walk, flat, ms = words_of(data, Camera.from_config(
        stream_config().camera, WIDTH / HEIGHT).uniforms(), WIDTH, HEIGHT,
        True)
    missing = int(((flat & ~walk) != 0).sum())
    say(f"[lbvh] {card}: bvh_walk_mask_words on the card at the "
        f"stream-1080p-terrain512 frame's {walk.shape[0]} tiles: "
        f"{ms:.3f} ms (CUDA events around the call, its host check every "
        f"{WALK_CHECK_STEPS} steps included); admitted clusters walk "
        f"{bits(walk)}, flat scan {bits(flat)}; a superset of the flat "
        f"scan's words: {missing == 0} ({missing} words miss flat bits); "
        f"words equal {bool(torch.equal(walk, flat))}")
    if missing:
        raise AssertionError("the LBVH walk misses flat-scan bits")
    cfg = SceneConfig(
        meshes=(MeshConfig(obj_path="builtin:terrain:23",
                           translation=(0.0, 0.0, -3.0)),),
        camera=CameraConfig(eye=(0.0, -2.0, -1.0), target=(0.0, 0.0, -3.2)),
        render=RenderConfig(width=128, height=128))
    small = Scene.build(cfg).data.to("cuda")
    walk, flat, ms = words_of(small, Camera.from_config(
        cfg.camera, 1.0).uniforms(), 128, 128, False)
    same = bool(torch.equal(walk, flat))
    say(f"[lbvh] terrain:23 128x128 (tests/test_accel.py's case): walk "
        f"words equal to the flat scan's {same} ({bits(walk)} clusters "
        f"admitted; {ms:.3f} ms)")
    if not same:
        raise AssertionError("the LBVH walk differs from the flat scan")


def inst_uni(w, h):
    from rust_wgpu_raytracing_tpu_torch.config import CameraConfig
    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera

    return Camera.from_config(CameraConfig(eye=INST_EYE),
                              w / h).uniforms().flat()


def inst_transforms(n: int, angle: float):
    """bench_configs.py config 5's layout: an n-instance grid 2.5 apart
    at z = -6, turned by `angle` about y."""
    from rust_wgpu_raytracing_tpu_torch.ops.instances import grid_transforms

    return grid_transforms(n, spacing=2.5, z=-6.0, angle=angle)


def instancing_phase(card, ctx, say):
    """Phase 11: BASELINE config 5 on builtin:terrain:23 (bench_configs.py
    config 5's frame loop: InstancedScene.instantiate + render_megakernel, no
    Renderer). Each cell: WARMUP + INST_FRAMES frames, the angle up 0.05
    a frame, the launch counters set to 0 before and read after; the
    refit alone and the frame (refit + render) by CUDA events, medians;
    peak device memory. Then, at one camera: cull == bvh bitwise (4K,
    1080p), fused vs split at the frame bar, the kernel-run frame against
    the plain-composed one bitwise (at 640x360, where the plain streamed
    sweeps take seconds), each kernel of the 1080p frames and of both 4K
    frames against its plain version (K9, K11 on 8 batches), and
    the card's refit against the CPU refit of the same transforms, field
    by field (ulp gap printed, 0 required)."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.config import MeshConfig
    from rust_wgpu_raytracing_tpu_torch.ops.instances import InstancedScene
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import \
        render_megakernel

    K = ctx.K
    fields = {}
    for n in (64, 16):
        t0 = time.perf_counter()
        fields[n] = InstancedScene.from_config(
            MeshConfig(obj_path=INST_MESH), n, device="cuda")
        fb = fields[n].base_faces.shape[0]
        say(f"[inst] {n} x {INST_MESH}: {fields[n].fb_real} faces an "
            f"instance, padded to {fb}, {n * fb} in the soup; host set-up "
            f"{time.perf_counter() - t0:.2f} s")

    def render(n, angle, w, h, kernels=K.KERNELS, **kw):
        data = fields[n].instantiate(inst_transforms(n, angle))
        return render_megakernel(data, inst_uni(w, h), width=w, height=h,
                                 kernels=kernels, **kw)

    stream_k = ("closest_hit", "frame", "anyhit")
    onchip_k = ("stream_closest_hit", "stream_anyhit", "hier_cull")
    cells = [
        ("instances64-4k-terrain23, cull", 64, *INST_4K,
         dict(accel="cull"), ("stream_closest_hit", "texshade"),
         stream_k + ("stream_anyhit", "hier_cull")),
        ("instances64-4k-terrain23, bvh", 64, *INST_4K, dict(accel="bvh"),
         ("stream_closest_hit", "texshade", "hier_cull"),
         stream_k + ("stream_anyhit",)),
        ("instances64-1080p-terrain23, cull", 64, WIDTH, HEIGHT,
         dict(accel="cull"), ("stream_closest_hit", "texshade"),
         stream_k + ("stream_anyhit", "hier_cull")),
        ("instances64-1080p-terrain23, bvh", 64, WIDTH, HEIGHT,
         dict(accel="bvh"), ("stream_closest_hit", "texshade", "hier_cull"),
         stream_k + ("stream_anyhit",)),
        ("instances64-1080p-terrain23, cull, shadows", 64, WIDTH, HEIGHT,
         dict(accel="cull", shadows=True),
         ("stream_closest_hit", "stream_anyhit", "texshade"),
         stream_k + ("hier_cull",)),
        ("instances16-1080p-terrain23, fused, shadows", 16, WIDTH, HEIGHT,
         dict(fused=True, shadows=True), ("frame", "texshade", "anyhit"),
         ("closest_hit",) + onchip_k),
        ("instances16-1080p-terrain23, split, shadows", 16, WIDTH, HEIGHT,
         dict(fused=False, shadows=True),
         ("closest_hit", "texshade", "anyhit"), ("frame",) + onchip_k),
    ]
    last = {}
    for label, n, w, h, kw, need, absent in cells:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        K.reset_launch_counts()
        refit, total = [], []
        angle = 0.0
        for i in range(WARMUP + INST_FRAMES):
            angle += 0.05
            tr = inst_transforms(n, angle)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            data = fields[n].instantiate(tr)
            ev[1].record()
            color, depth = render_megakernel(data, inst_uni(w, h), width=w,
                                             height=h, **kw)
            ev[2].record()
            ev[2].synchronize()
            if i >= WARMUP:
                refit.append(ev[0].elapsed_time(ev[1]))
                total.append(ev[0].elapsed_time(ev[2]))
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        ctx.path_launches[f"inst:{label}"] = launches
        missing = [k for k in need if launches[k] == 0]
        extra = [k for k in absent if launches[k] != 0]
        if missing or extra:
            raise AssertionError(f"{label}: kernels of the path never "
                                 f"launched {missing}, kernels off the path "
                                 f"launched {extra}")
        if tuple(color.shape) != (h, w, 3) or \
                not bool(torch.isfinite(color).all()):
            raise AssertionError(f"{label}: bad frame {tuple(color.shape)}")
        hit = float((depth < 1).float().mean())
        if hit < 0.005:  # config 5's camera sees the field small
            raise AssertionError(f"{label}: the field covers {hit} of the "
                                 f"frame")
        refit.sort()
        total.sort()
        m = len(total) // 2
        say(f"[timing] {card}: {label} ({w}x{h}): refit median "
            f"{refit[m]:.3f} ms (min {refit[0]:.3f}, max {refit[-1]:.3f}), "
            f"frame (refit + render) median {total[m]:.3f} ms (min "
            f"{total[0]:.3f}, max {total[-1]:.3f}) over {INST_FRAMES} frames "
            f"after {WARMUP} warm-up (CUDA events), "
            f"{w * h / (total[m] * 1e-3) / 1e6:.1f} Mrays/s; peak device "
            f"memory {peak / 2**30:.3f} GiB, {(peak - resident) / 2**30:.3f}"
            f" above the {resident / 2**30:.3f} GiB resident before the "
            f"cell; {hit:.4f} of pixels hit; "
            f"launches {({k: v for k, v in launches.items() if v})}")
        last[label] = (color, depth)
    del data, color, depth

    for res in ("4k", "1080p"):
        (ca, da), (cb, db) = (last[f"instances64-{res}-terrain23, {a}"]
                              for a in ("cull", "bvh"))
        same = torch.equal(ca, cb) and torch.equal(da, db)
        say(f"[frame] instances64-{res}: bvh vs cull bitwise {same}")
        if not same:
            raise AssertionError("the instanced bvh frame differs from cull")
    (fc, fd), (sc, sd) = (last[f"instances16-1080p-terrain23, {v}, shadows"]
                          for v in ("fused", "split"))
    dmax, exact, bitwise = frame_bar(fc, sc)
    say(f"[frame] instances16-1080p: fused vs split (quantized): "
        f"{int((fc != sc).sum())} of {fc.numel()} subpixels differ, max "
        f"linear u8 delta {dmax}, exact {exact:.6f}, bitwise {bitwise}; "
        f"depth equal {bool(torch.equal(fd, sd))}")
    if dmax > 1 or exact < 0.999:
        raise AssertionError("instanced fused frame disagrees with split")
    del last

    # the kernel-run frame against the plain-composed one, one camera
    w, h = INST_CHECK
    for n, kw in ((16, dict(fused=True, shadows=True)),
                  (16, dict(fused=False, shadows=True)),
                  (64, dict(accel="cull", shadows=True)),
                  (64, dict(accel="bvh", shadows=True))):
        a, ad = render(n, INST_ANGLE, w, h, **kw)
        b, bd = render(n, INST_ANGLE, w, h, kernels=K.PLAIN, **kw)
        same = torch.equal(a, b) and torch.equal(ad, bd)
        say(f"[frame] {n} instances {w}x{h} {kw}: kernels vs plain-composed "
            f"frame bitwise {same} (mean colour {float(a.mean()):.5f})")
        if not same:
            raise AssertionError("instanced frame differs from its plain "
                                 "twin")

    # each kernel of the 1080p and 4K frames against its plain version
    hd = (WIDTH, HEIGHT)
    for n, (w, h), kw in ((16, hd, dict(fused=True, shadows=True)),
                          (16, hd, dict(fused=False, shadows=True)),
                          (64, hd, dict(accel="cull", shadows=True)),
                          (64, hd, dict(accel="bvh")),
                          (64, INST_4K, dict(accel="cull")),
                          (64, INST_4K, dict(accel="bvh"))):
        view = f"{n} instances {w}x{h} {kw}"
        calls = ctx.record(lambda ks: render(n, INST_ANGLE, w, h,
                                             kernels=ks, **kw))
        for name, c in sorted(calls.items()):
            for args, kwargs in c:
                if name in ("stream_closest_hit", "stream_anyhit"):
                    subset_check(K, ctx.flat, ctx.errs, view, name, args,
                                 kwargs)
                else:
                    ctx.check(view, name, args, kwargs)
        del calls

    # the card's refit against the CPU refit of the same transforms
    cpu = InstancedScene.from_config(MeshConfig(obj_path=INST_MESH), 64,
                                     device="cpu")
    tr = inst_transforms(64, INST_ANGLE)
    gpu_sd, cpu_sd = fields[64].instantiate(tr), cpu.instantiate(tr)
    gaps = {}
    for f in INST_FIELDS:
        a, b = getattr(gpu_sd, f).cpu(), getattr(cpu_sd, f)
        if a.shape != b.shape:
            raise AssertionError(f"refit {f}: {a.shape} vs {b.shape}")
        if a.dtype == torch.float32:
            both_inf = torch.isinf(a) & (a == b)
            gaps[f] = ulp_gap(torch.where(both_inf, 0.0, a),
                              torch.where(both_inf, 0.0, b))
        else:
            gaps[f] = 0 if torch.equal(a, b) else -1
    say(f"[inst] refit on the card vs on the CPU (64 instances, "
        f"{gpu_sd.padded_faces} faces), max ulp gap per field: {gaps}")
    if any(g != 0 for g in gaps.values()):
        raise AssertionError("the card's refit differs from the CPU's")


def write_raster_assets(root: str) -> str:
    """builtin:cube as an OBJ with a material whose map_Kd is a seeded
    16x16 PNG, written with the port's stdlib encoder; the OBJ's name."""
    from rust_wgpu_raytracing_tpu_torch.io.image_out import encode_png
    from rust_wgpu_raytracing_tpu_torch.io.obj import make_cube

    m = make_cube()
    lines = ["mtllib rcube.mtl", "o rcube"]
    lines += [f"v {a:.6f} {b:.6f} {c:.6f}" for a, b, c in m.positions]
    lines += [f"vt {a:.6f} {b:.6f}" for a, b in m.uvs]
    lines.append("usemtl rmat")
    lines += [f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}"
              for a, b, c in m.faces]
    with open(os.path.join(root, "rcube.obj"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "rcube.mtl"), "w") as fh:
        fh.write("newmtl rmat\nKa 0.1 0.1 0.1\nKd 0.8 0.8 0.8\n"
                 "map_Kd rcube.png\n")
    img = np.random.default_rng(20261017).integers(0, 256, (16, 16, 3),
                                                   dtype=np.uint8)
    with open(os.path.join(root, "rcube.png"), "wb") as fh:
        fh.write(encode_png(img))
    return "rcube.obj"


def raster_view_proj(w: int, h: int):
    """The forward CameraUniform (OPENGL_TO_WGPU @ proj @ view) looking
    at the reference's instance grid from above its front edge."""
    from rust_wgpu_raytracing_tpu_torch.config import CameraConfig
    from rust_wgpu_raytracing_tpu_torch.core import math3d
    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera

    cam = Camera.from_config(CameraConfig(eye=RASTER_EYE, target=(0, 0, 0)),
                             w / h)
    return (math3d.OPENGL_TO_WGPU @ cam.view_proj_matrix()).astype(
        np.float32)


def raster_phase(card, say):
    """Phase 12: the raster pipeline (plain PyTorch: the JAX module runs
    no Pallas kernel). load_model_raster on a seeded textured cube, drawn
    over reference_instance_grid(10) (100 cubes, 1,200 triangles) by
    RasterEncoder.draw_model_instanced at 600x600 and 1920x1080: ms per
    draw (a fresh encoder each, 1 warm-up, RASTER_DRAWS draws, CUDA
    events, median). At 160x160: the card against the CPU, winner keys
    and depth bitwise, colour within 1 u8 level; the output at chunk
    sizes 1, 7 and the default equal."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.ops import raster as R

    root = tempfile.mkdtemp(prefix="rt_raster_")
    try:
        model = R.load_model_raster(os.path.join(root,
                                                 write_raster_assets(root)))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    grid = R.reference_instance_grid(10)
    mesh = model.meshes[0]
    say(f"[raster] {grid.shape[0]} instances x {mesh.faces.shape[0]} "
        f"triangles = {grid.shape[0] * mesh.faces.shape[0]}")

    def draw(w, h, device):
        enc = R.RasterEncoder(w, h, device=device)
        return enc.draw_model_instanced(model, grid, raster_view_proj(w, h))

    for w, h in ((600, 600), (WIDTH, HEIGHT)):
        draw(w, h, "cuda")
        times = []
        for _ in range(RASTER_DRAWS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            enc = draw(w, h, "cuda")
            ev[1].record()
            ev[1].synchronize()
            times.append(ev[0].elapsed_time(ev[1]))
        times.sort()
        cover = float((enc.depth.data < 1).float().mean())
        say(f"[timing] {card}: raster-grid-{'600' if w == 600 else '1080p'}"
            f" ({w}x{h}): draw_model_instanced median "
            f"{times[len(times) // 2]:.3f} ms (min {times[0]:.3f}, max "
            f"{times[-1]:.3f}) over {RASTER_DRAWS} draws after 1 warm-up "
            f"(CUDA events, a fresh encoder each); {cover:.4f} of pixels "
            f"covered, MAX_CHUNK_PAIRS {R.MAX_CHUNK_PAIRS}")
        if cover < 0.05 or not bool(torch.isfinite(enc.color).all()):
            raise AssertionError("raster draw covers too little")

    n = RASTER_CHECK
    vp = raster_view_proj(n, n)
    outs = {}
    for dev in ("cuda", "cpu"):
        clip, uv = R.instance_triangles(mesh, grid, vp, device=dev)
        win = R.rasterize_winners(R.screen_triangles(clip, n, n), n, n)
        enc = draw(n, n, dev)
        outs[dev] = (clip.cpu(), win[1].cpu(), enc.depth.data.cpu(),
                     enc.color.cpu())
    same_clip = torch.equal(outs["cuda"][0], outs["cpu"][0])
    same_keys = torch.equal(outs["cuda"][1], outs["cpu"][1])
    same_depth = torch.equal(outs["cuda"][2], outs["cpu"][2])
    dmax = int((u8(outs["cuda"][3]) - u8(outs["cpu"][3])).abs().max())
    say(f"[raster] {n}x{n}, card vs CPU: clip coordinates bitwise "
        f"{same_clip}, winner keys bitwise {same_keys}, depth bitwise "
        f"{same_depth}, colour max linear u8 delta {dmax} (bound 1)")
    if not (same_keys and same_depth) or dmax > 1:
        raise AssertionError("the raster draw on the card differs from the "
                             "CPU's")
    tc, tu = R.instance_triangles(mesh, grid, vp, device="cuda")
    tex = torch.as_tensor(model.materials[mesh.material].diffuse,
                          device="cuda")
    ref = R.rasterize(tc, tu, n, n, tex)
    for chunk in (1, 7):
        c, d = R.rasterize(tc, tu, n, n, tex, chunk=chunk)
        same = torch.equal(c, ref[0]) and torch.equal(d, ref[1])
        say(f"[raster] chunk {chunk} vs the default chunk: bitwise {same}")
        if not same:
            raise AssertionError("the raster output depends on the chunk")


def shells_phase(card, Renderer, say):
    """Phase 13: the runtime shells on the card. FrameLoop over the smoke
    scene (fused) for SHELL_FRAMES frames with key events, pipelined and
    not, twice each in turn (presented count; the Profiler's mean and p99
    ms, the whole step()'s median after WARMUP); RenderServer on 127.0.0.1
    fetched through urllib (/frame.png decodes to the presented frame,
    /stats is JSON); a 4-bounce path trace of the heightfield (pt_config
    at CKPT_W x CKPT_H) checkpointed at CKPT_SPP[0] samples and resumed
    to CKPT_SPP[1]: equal to the uninterrupted run bitwise."""
    import dataclasses as dc
    import urllib.request

    import torch

    from rust_wgpu_raytracing_tpu_torch.io.checkpoint import (
        load_checkpoint, save_checkpoint)
    from rust_wgpu_raytracing_tpu_torch.io.image_out import read_png
    from rust_wgpu_raytracing_tpu_torch.runtime.frame_loop import FrameLoop
    from rust_wgpu_raytracing_tpu_torch.runtime.server import RenderServer

    for pipeline in (True, False, True, False):
        r = Renderer(smoke_config("fused"), device="cuda")
        shown, walls = [], []
        loop = FrameLoop(r, present=shown.append, pipeline=pipeline)
        for i in range(SHELL_FRAMES):
            loop.push_key("d" if i < SHELL_FRAMES // 2 else "w", True)
            t0 = time.perf_counter()
            loop.step()
            walls.append((time.perf_counter() - t0) * 1e3)
        loop.flush()
        last = r.present_image()
        s = loop.profiler.summary()
        ok = len(shown) == SHELL_FRAMES and all(
            x.shape == (HEIGHT, WIDTH, 3) for x in shown) and \
            np.array_equal(shown[-1], last)
        steady = sorted(walls[WARMUP:])
        say(f"[shell] {card}: FrameLoop(pipeline={pipeline}) "
            f"{SHELL_FRAMES} frames with key events: {len(shown)} presented,"
            f" last = the latest frame {np.array_equal(shown[-1], last)}; "
            f"step (render + present fetch) mean {s['mean_ms']:.3f} ms, p99 "
            f"{s['p99_ms']:.3f} ms; whole step() median "
            f"{steady[len(steady) // 2]:.3f} ms (min {steady[0]:.3f}, max "
            f"{steady[-1]:.3f}) after {WARMUP} warm-up (host clock)")
        if not ok:
            raise AssertionError("the frame loop presented wrong frames")

    loop = FrameLoop(Renderer(smoke_config("fused"), device="cuda"))
    srv = RenderServer(loop, port=0)
    srv.serve_async()
    root = tempfile.mkdtemp(prefix="rt_shell_")
    try:
        loop.push_key("a", True)
        loop.run(n_frames=3)
        base = f"http://127.0.0.1:{srv.port}"
        png = urllib.request.urlopen(base + "/frame.png", timeout=30).read()
        with open(os.path.join(root, "frame.png"), "wb") as fh:
            fh.write(png)
        same = np.array_equal(read_png(os.path.join(root, "frame.png")),
                              srv.latest)
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=30).read())
        key = urllib.request.urlopen(base + "/key?k=w&p=1",
                                     timeout=30).read()
    finally:
        srv.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    say(f"[shell] RenderServer on 127.0.0.1:{srv.port}: /frame.png "
        f"{len(png)} bytes, decodes to the presented frame {same}; /stats "
        f"{stats}; /key {key!r}")
    if not same or stats["frames_rendered"] != 3 or key != b"ok":
        raise AssertionError("the HTTP shell served wrong data")

    cfg = pt_config()
    cfg = dc.replace(cfg, render=dc.replace(
        cfg.render, width=CKPT_W, height=CKPT_H, pt_spp=CKPT_SPP[1]))
    full = Renderer(cfg, device="cuda")
    for _ in range(CKPT_SPP[1]):
        want, _ = full.render()
    part = Renderer(cfg, device="cuda")
    for _ in range(CKPT_SPP[0]):
        part.render()
    root = tempfile.mkdtemp(prefix="rt_ckpt_")
    try:
        path = os.path.join(root, "pt.ckpt")
        save_checkpoint(path, part)
        size = os.path.getsize(path)
        resumed = load_checkpoint(path, device="cuda")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    spp0 = resumed.spp_done
    while resumed.spp_done < CKPT_SPP[1]:
        got, _ = resumed.render()
    same = torch.equal(got, want)
    say(f"[shell] checkpoint of the {cfg.render.pt_bounces}-bounce path "
        f"trace at {CKPT_W}x{CKPT_H}: saved at {spp0} spp ({size} bytes), "
        f"resumed to {resumed.spp_done}: equal to the uninterrupted "
        f"{full.spp_done}-spp image bitwise {same}")
    if not same or spp0 != CKPT_SPP[0]:
        raise AssertionError("the resumed path trace differs")


# ---------------------------------------------------------------------------
# phase 14: multi-device rendering, gloo ranks sharing the card
# ---------------------------------------------------------------------------

# timed frames a rank after one warm-up; train steps
MD_REPS, MD_STEPS, MD_LR = 3, 5, 8.0
STREAMED = ("stream_closest_hit", "stream_closest_hit_perray",
            "stream_anyhit")


def flat_out(name, out):
    """A kernel's outputs as a tuple of tensors (closest_hit: its sphere
    planes too, where there are any)."""
    if name == "closest_hit":
        return (out[0], out[1], *(out[2] or ()))
    if name == "sweep_front":
        return (*out.bounds, *out.mask_bounds,
                *(t for t in out[2:] if t is not None))
    return (out,) if name in ("anyhit", "stream_anyhit", "hier_cull",
                              "super_any") else tuple(out)


def _recording(K):
    """A KernelSet that records every call's arguments, and the record:
    {name: [(args, kwargs), ...]} in call order."""
    calls = {}

    def wrap(fn):
        def call(*args, **kwargs):
            calls.setdefault(fn.__name__, []).append((args, kwargs))
            return fn(*args, **kwargs)
        call.__name__ = fn.__name__
        return call
    return K.KernelSet(*(wrap(f) for f in K.KERNELS)), calls


def _check_calls(K, calls, view, errs):
    """Each recorded kernel against its plain version on its first call's
    arguments (the streamed sweeps on 8 batches, subset_check), every
    plane equal by value (t bitwise for the shared-origin sweeps)."""
    import torch

    wrapper = {f.__name__: f for f in K.KERNELS}
    plain = {f.__name__: p for f, p in zip(K.KERNELS, K.PLAIN)}
    for name, lst in sorted(calls.items()):
        args, kw = lst[0]
        if name in STREAMED:
            subset_check(K, flat_out, errs, view, name, args, kw)
            continue
        got = flat_out(name, wrapper[name](*args, **kw))
        want = flat_out(name, plain[name](*args, **kw))
        torch.cuda.synchronize()
        exact = all(torch.equal(x, y) for x, y in zip(got, want))
        if name in SIGNED_T:
            exact = exact and torch.equal(got[0].view(torch.int32),
                                          want[0].view(torch.int32))
        if not exact:
            raise AssertionError(f"{view}: {name} disagrees with its "
                                 f"plain version")
        errs[name] = max(errs.get(name, 0.0), max(
            max_abs_err(x, y) for x, y in zip(got, want)))
    say(f"[multi] {view}: {sum(len(v) for v in calls.values())} kernel "
        f"calls; {sorted(calls)} each OK vs plain (its first call)")


def _median_ms(fn, reps=MD_REPS):
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _host_ms(fn, barrier=False):
    """fn's result and its host time in ms, the card synchronized before
    and after (barrier: every rank waits for the others first, so that a
    collective's time holds no wait for a slower rank)."""
    import torch
    import torch.distributed as dist

    torch.cuda.synchronize()
    if barrier:
        dist.barrier()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _md_run(K, label, run, report, errs, check=True):
    """run(kernels) once with the counters at 0 and every call recorded;
    the launches into report; the calls checked against plain."""
    import torch

    ks, calls = _recording(K)
    K.reset_launch_counts()
    out = run(ks)
    torch.cuda.synchronize()
    report["launches"][label] = K.launch_counts()
    if check:
        _check_calls(K, calls, f"{label}, rank {report['rank']}", errs)
    return out


def _md_scene(cfg):
    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
    from rust_wgpu_raytracing_tpu_torch.core.scene import Scene

    rc = cfg.render
    return (Scene.build(cfg).data.to("cuda"),
            Camera.from_config(cfg.camera, rc.width / rc.height)
            .uniforms().flat())


def _md_dp_frames(K, mesh, data, uni, report, errs, tag, accels=("cull",),
                  fused_options=(None,), plain_slab=True):
    """The dp cases of one scene: each program's slab (timed; against its
    plain-composed twin, or, plain_slab False, each kernel it launched
    against its plain version), the gather (timed) and the whole
    frame."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import \
        render_megakernel

    h = HEIGHT
    rows = h // mesh.size("dp")
    row0 = mesh.index("dp") * rows
    out = {}
    for accel in accels:
        for fused in fused_options:
            label = f"{tag} dp={mesh.size('dp')} " + (
                accel if fused is None else
                ("fused" if fused else "split"))

            def slab(ks, fused=fused, accel=accel):
                return render_megakernel(
                    data, uni, width=WIDTH, height=rows, shadows=True,
                    row0=row0, total_height=h, fused=fused, accel=accel,
                    kernels=ks)[0]
            c = _md_run(K, label, slab, report, errs,
                        check=not plain_slab)
            if plain_slab and not torch.equal(c, slab(K.PLAIN)):
                raise AssertionError(f"{label}: rank {report['rank']}'s "
                                     f"slab != its plain-composed slab")
            ms = _median_ms(lambda: slab(K.KERNELS))
            whole, gather = _host_ms(lambda: mesh.gather_rows(c, h),
                                     barrier=True)
            report["ms"][label] = {"slab_ms": ms, "gather_ms": gather}
            out[label] = whole
    return out


def md_ranks(n):
    """The phase's cases on each of n gloo ranks sharing cuda:0; returns
    (rank 0's whole results, every rank's report)."""
    import torch
    import torch.distributed as dist

    from rust_wgpu_raytracing_tpu_torch import Renderer
    from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import (
        gbuffer, render_megakernel)
    from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (
        PRNGKey, fold_in)
    from rust_wgpu_raytracing_tpu_torch.parallel import geometry_sharding \
        as G
    from rust_wgpu_raytracing_tpu_torch.testing.raycull import \
        plane_camera_config
    from rust_wgpu_raytracing_tpu_torch.parallel import tile_sharding as T
    from rust_wgpu_raytracing_tpu_torch.parallel.mesh import make_gp_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    report = {"rank": dist.get_rank(), "launches": {}, "ms": {}}
    errs = {}
    res = {}
    smoke, smoke_uni = _md_scene(smoke_config())
    dp_mesh = T.make_render_mesh(device="cuda")
    report["device"] = str(dp_mesh.device)
    res.update(_md_dp_frames(K, dp_mesh, smoke, smoke_uni, report, errs,
                             "smoke", fused_options=(True, False)))
    stream, stream_uni = _md_scene(stream_config())
    if n == 2:
        res.update(_md_dp_frames(K, dp_mesh, stream, stream_uni, report,
                                 errs, "stream", accels=("cull", "bvh"),
                                 plain_slab=False))
        pt, pt_uni = _md_scene(pt_config())
        gp2 = make_gp_mesh(device="cuda")
        res["pt gp=2"] = _md_run(K, "pt gp=2", lambda ks: G.render_pathtrace_gp(
            pt, pt_uni, PRNGKey(PT_SEED), gp2, width=WIDTH, height=HEIGHT,
            bounces=PT_BOUNCES, kernels=ks), report, errs)
        # a camera on a face's plane: zero t of both signs through the
        # merges (phase 5's view, grid48)
        plane, plane_uni = _md_scene(plane_camera_config(
            "grid48.obj", 48, 600, 640, 360))
        res["plane gp=2"] = _md_run(K, "plane gp=2", lambda ks:
                                    G.render_sharded_gp(
                                        plane, plane_uni, gp2, width=640,
                                        height=360, shadows=True,
                                        kernels=ks), report, errs)
        origin, rays = md_rays(plane_uni, 640, 360)
        local = G.local_shard(*G.shard_scene_faces(plane, 2),
                              gp2.index("gp"))
        res["plane gp=2 t"] = G._merge_gbuffer(gp2, gbuffer(
            local, origin, *rays, with_spheres=False)[0],
            local.padded_faces).t
    else:
        gp4 = make_gp_mesh(device="cuda")
        for shadows in (False, True):
            label = f"smoke gp=4 {'shadowed' if shadows else 'lit'}"

            def gp_frame(ks, shadows=shadows, mesh=gp4):
                return G.render_sharded_gp(smoke, smoke_uni, mesh,
                                           width=WIDTH, height=HEIGHT,
                                           shadows=shadows, kernels=ks)
            res[label] = _md_run(K, label, gp_frame, report, errs)
            local = G.local_shard(*G.shard_scene_faces(smoke, 4),
                                  gp4.index("gp"))
            report["ms"][label] = {
                "frame_ms": _median_ms(lambda: gp_frame(K.KERNELS)),
                "shard_frame_ms": _median_ms(lambda: render_megakernel(
                    local, smoke_uni, width=WIDTH, height=HEIGHT,
                    shadows=shadows))}
        label = "stream gp=4 shadowed"
        res[label] = _md_run(K, label, lambda ks: G.render_sharded_gp(
            stream, stream_uni, gp4, width=WIDTH, height=HEIGHT,
            shadows=True, kernels=ks), report, errs)
        report["ms"][label] = {"frame_ms": _median_ms(
            lambda: G.render_sharded_gp(stream, stream_uni, gp4,
                                        width=WIDTH, height=HEIGHT,
                                        shadows=True), reps=2)}
        dpgp = make_gp_mesh(dp=2, device="cuda")
        res["smoke dp=2 x gp=2"] = _md_run(
            K, "smoke dp=2 x gp=2", lambda ks: G.render_sharded_gp(
                smoke, smoke_uni, dpgp, width=WIDTH, height=HEIGHT,
                shadows=True, kernels=ks), report, errs)
        pts_uni = md_uni(pt_stream_config())
        res["pt540 gp=4"] = _md_run(K, "pt540 gp=4",
                                    lambda ks: G.render_pathtrace_gp(
                                        stream, pts_uni, fold_in(
                                            PRNGKey(PT_SEED), 0), gp4,
                                        width=PTS_W, height=PTS_H,
                                        bounces=PTS_BOUNCES, kernels=ks),
                                    report, errs)
        pt, pt_uni = _md_scene(pt_config())
        dpsp = T.make_render_mesh(sp=2, device="cuda")
        res["pt dp=2 x sp=2"] = _md_run(
            K, "pt dp=2 x sp=2", lambda ks: T.render_pathtrace_sharded(
                pt, pt_uni, PRNGKey(PT_SEED), dpsp, width=WIDTH,
                height=HEIGHT, bounces=PT_BOUNCES, kernels=ks), report,
            errs)
        tr, tr_uni = _md_scene(T.dryrun_scene(WIDTH, HEIGHT))
        from rust_wgpu_raytracing_tpu_torch.ops.oracle import render_oracle

        target = render_oracle(tr, tr_uni, width=WIDTH, height=HEIGHT,
                               quantize=False)[0]
        params = {"sphere_color": tr.sphere_color + 0.4,
                  "mat_ambient": tr.mat_ambient + 0.2}
        step = T.make_train_step(tr, dpsp, width=WIDTH, height=HEIGHT,
                                 lr=MD_LR)
        losses, steps_ms = [], []
        for i in range(MD_STEPS):
            (params, loss), ms = _host_ms(
                lambda i=i: step(params, tr, tr_uni, target, i))
            losses.append(float(loss))
            steps_ms.append(ms)
            if i == 0:
                res["train step1"] = {k: v.clone() for k, v in
                                      params.items()}
        res["train losses"] = losses
        report["ms"]["train dp=2 x sp=2"] = {"step_ms": float(
            np.median(steps_ms))}
        cfg = smoke_config()
        rg = Renderer(cfg, backend="megakernel_gp", device="cuda")
        K.reset_launch_counts()
        res["Renderer gp=4"] = rg.render(block=True)
        report["launches"]["Renderer gp=4"] = K.launch_counts()
        report["renderer"] = (rg.variant_chosen, rg._gp_mesh.size("gp"),
                              str(rg.device))
    report["peak_mb"] = torch.cuda.max_memory_allocated() / 2 ** 20
    report["errs"] = errs
    reports = [None] * n
    dist.all_gather_object(reports, report)
    return res, reports


def md_rays(uni_flat, width, height):
    """The camera origin and the planar primary rays (scanlines) of a
    view, on the card."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.core.camera import CameraUniforms
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import raygen_planar

    uni = CameraUniforms.unflat(uni_flat)
    return (torch.as_tensor(uni.origin, dtype=torch.float32, device="cuda"),
            raygen_planar(width, height, uni, device="cuda"))


def md_uni(cfg):
    """The camera vector of a config's view."""
    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera

    rc = cfg.render
    return Camera.from_config(cfg.camera, rc.width / rc.height) \
        .uniforms().flat()


def multidevice_phase(card, K, errs, say):
    """Phase 14: the sharded functions on gloo ranks sharing cuda:0 (a
    set of 2 ranks and one of 4, at once), each result against its
    single-device counterpart here, bitwise. Returns the launches summed
    over ranks by path."""
    import torch

    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import (
        gbuffer, render_megakernel)
    from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (
        PRNGKey, fold_in, render_pathtrace)
    from rust_wgpu_raytracing_tpu_torch.parallel import tile_sharding as T
    from rust_wgpu_raytracing_tpu_torch.parallel.launch import spawn

    from rust_wgpu_raytracing_tpu_torch.testing.raycull import (
        plane_camera_config, write_grid_mesh)

    write_grid_mesh(os.path.join(os.environ["RWRT_ASSETS"], "grid48.obj"),
                    48)
    # the 2-rank and the 4-rank set run at once: 6 processes share the
    # card, and each rank's times are taken under that sharing
    got, reports = {}, []
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = {n: pool.submit(spawn, md_ranks, n, n, backend="gloo",
                               timeout=900) for n in (2, 4)}
    say(f"[multi] {card}: 2 and 4 gloo ranks on cuda:0 at once ran their "
        f"cases in {time.perf_counter() - t0:.1f} s (spawn and scene "
        f"builds included)")
    for n, run in runs.items():
        res, reps = run.result()
        for rep in reps:
            say(f"[multi] {n} ranks, rank {rep['rank']} on "
                f"{rep['device']}: peak device memory "
                f"{rep['peak_mb']:.1f} MB; ms "
                f"{json.dumps(rep['ms'], sort_keys=True)}")
            for name, e in rep["errs"].items():
                errs[name] = max(errs.get(name, 0.0), e)
        got.update({(n, k): v for k, v in res.items()})
        reports.append(reps)

    def dev(a):
        if isinstance(a, torch.Tensor):
            return a.to("cuda")
        return torch.as_tensor(np.asarray(a)).to("cuda")

    def same(label, a, b):
        a, b = dev(a), dev(b)
        ok = a.shape == b.shape and torch.equal(
            a.view(torch.int32), b.view(torch.int32))
        diff = int((a != b).sum()) if a.shape == b.shape else -1
        say(f"[multi] {label}: {'OK' if ok else 'MISMATCH'} bitwise vs "
            f"the single-device result ({diff} of {b.numel()} values "
            f"differ)")
        if not ok:
            raise AssertionError(f"{label} != its single-device result")

    smoke, smoke_uni = _md_scene(smoke_config())
    for fused in (True, False):
        single = render_megakernel(smoke, smoke_uni, width=WIDTH,
                                   height=HEIGHT, shadows=True, fused=fused)
        name = "fused" if fused else "split"
        for n in (2, 4):
            same(f"smoke dp={n} {name} frame", got[(n, f"smoke dp={n} "
                                                    f"{name}")], single[0])
    for shadows in (False, True):
        single = render_megakernel(smoke, smoke_uni, width=WIDTH,
                                   height=HEIGHT, shadows=shadows,
                                   fused=None if not shadows else False)
        tag = "shadowed" if shadows else "lit"
        c, d = got[(4, f"smoke gp=4 {tag}")]
        same(f"smoke gp=4 {tag} colour", c, single[0])
        same(f"smoke gp=4 {tag} depth", d, single[1])
        if shadows:
            c, d = got[(4, "smoke dp=2 x gp=2")]
            same("smoke dp=2 x gp=2 colour", c, single[0])
            same("smoke dp=2 x gp=2 depth", d, single[1])
            c, _ = got[(4, "Renderer gp=4")]
            same("Renderer(backend='megakernel_gp') gp=4 frame", c,
                 single[0])
    del smoke
    stream, stream_uni = _md_scene(stream_config())
    for accel in ("cull", "bvh"):
        single = render_megakernel(stream, stream_uni, width=WIDTH,
                                   height=HEIGHT, shadows=True, accel=accel)
        same(f"stream dp=2 {accel} frame", got[(2, f"stream dp=2 {accel}")],
             single[0])
        if accel == "cull":
            c, d = got[(4, "stream gp=4 shadowed")]
            same("stream gp=4 shadowed colour", c, single[0])
            same("stream gp=4 shadowed depth", d, single[1])
    plane, plane_uni = _md_scene(plane_camera_config("grid48.obj", 48, 600,
                                                     640, 360))
    c, d = render_megakernel(plane, plane_uni, width=640, height=360,
                             shadows=True, fused=False)
    same("plane camera gp=2 colour", got[(2, "plane gp=2")][0], c)
    same("plane camera gp=2 depth", got[(2, "plane gp=2")][1], d)
    origin, rays = md_rays(plane_uni, 640, 360)
    t = gbuffer(plane, origin, *rays, with_spheres=False)[0].t
    zero = t == 0.0
    say(f"[multi] plane camera: {int((zero & torch.signbit(t)).sum())} "
        f"rays at t = -0.0, {int((zero & ~torch.signbit(t)).sum())} at "
        f"+0.0")
    same("plane camera gp=2 merged primary t (sign of a zero included)",
         got[(2, "plane gp=2 t")], t)
    del plane
    pts_uni = md_uni(pt_stream_config())
    single = render_pathtrace(stream, pts_uni, fold_in(PRNGKey(PT_SEED), 0),
                              width=PTS_W, height=PTS_H,
                              bounces=PTS_BOUNCES)
    same("pt-540p-terrain512 gp=4 sample", got[(4, "pt540 gp=4")], single)
    del stream
    pt, pt_uni = _md_scene(pt_config())
    key = PRNGKey(PT_SEED)
    single = render_pathtrace(pt, pt_uni, key, width=WIDTH, height=HEIGHT,
                              bounces=PT_BOUNCES)
    same("pt heightfield gp=2 sample", got[(2, "pt gp=2")], single)
    rows = HEIGHT // 2
    slabs = [sum(render_pathtrace(pt, pt_uni, fold_in(fold_in(key, spi),
                                                        dpi),
                                  width=WIDTH, height=rows, row0=dpi * rows,
                                  total_height=HEIGHT, bounces=PT_BOUNCES)
                 for spi in range(2)) * 0.5 for dpi in range(2)]
    same("render_pathtrace_sharded dp=2 x sp=2 mean",
         got[(4, "pt dp=2 x sp=2")], torch.cat(slabs))
    del pt

    # the train step against single-rank whole-image steps: the mean of
    # the gradients at sp rank 0's and 1's jitter keys
    tr, tr_uni = _md_scene(T.dryrun_scene(WIDTH, HEIGHT))
    from rust_wgpu_raytracing_tpu_torch.ops.oracle import render_oracle

    target = render_oracle(tr, tr_uni, width=WIDTH, height=HEIGHT,
                           quantize=False)[0]
    p0 = {"sphere_color": tr.sphere_color + 0.4,
          "mat_ambient": tr.mat_ambient + 0.2}
    grads = []
    for spi in range(2):
        p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        c, _ = T._render_rows(T._apply_params(tr, p), tr_uni, WIDTH, HEIGHT,
                              0, HEIGHT, jitter=T._jitter(
                                  fold_in(PRNGKey(0), spi), WIDTH, HEIGHT,
                                  "cuda"))
        loss = ((c - target) ** 2).mean()
        grads.append(torch.autograd.grad(loss, [p[k] for k in sorted(p)]))
    losses = got[(4, "train losses")]
    worst = 0.0
    for i, k in enumerate(sorted(p0)):
        want = p0[k] - MD_LR * (grads[0][i] + grads[1][i]) * 0.5
        g = dev(got[(4, "train step1")][k])
        rel = float(((g - p0[k]) - (want - p0[k])).abs().max()
                    / (want - p0[k]).abs().max())
        worst = max(worst, rel)
    say(f"[multi] train step dp=2 x sp=2 at {WIDTH}x{HEIGHT}: losses "
        f"{losses}; the first update against the single-rank whole-image "
        f"steps' mean gradient: max relative gap {worst!r} (bound 1e-3)")
    if not losses[-1] < losses[0] or worst > 1e-3:
        raise AssertionError("the sharded train step does not descend or "
                             "does not match the single-rank gradient")

    launches = {}
    for reps in reports:
        for rep in reps:
            for label, counts in rep["launches"].items():
                acc = launches.setdefault(label, {})
                for name, c in counts.items():
                    acc[name] = acc.get(name, 0) + c
    for label, counts in sorted(launches.items()):
        say(f"[multi] launches on {label}, summed over ranks: "
            f"{ {k: v for k, v in counts.items() if v} }")
    need = {"smoke dp=2 fused": ("frame", "texshade", "anyhit"),
            "smoke dp=2 split": ("closest_hit", "texshade", "anyhit"),
            "stream dp=2 cull": ("stream_closest_hit", "stream_anyhit"),
            "stream dp=2 bvh": ("hier_cull", "stream_closest_hit"),
            "smoke gp=4 lit": ("frame", "texshade"),
            "smoke gp=4 shadowed": ("closest_hit", "anyhit", "texshade"),
            "stream gp=4 shadowed": ("stream_closest_hit", "stream_anyhit"),
            "pt540 gp=4": ("stream_closest_hit", "stream_closest_hit_perray",
                           "stream_anyhit", "texfilter"),
            "pt gp=2": ("closest_hit", "extend_shadow", "anyhit",
                        "texfilter"),
            "Renderer gp=4": ("texshade",)}
    for label, names in need.items():
        missing = [k for k in names if not launches[label].get(k)]
        if missing:
            raise AssertionError(f"{label}: kernels of the path never "
                                 f"launched {missing}")
    return launches


def main() -> int:
    import torch

    # --- 1. environment ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr, flush=True)
        return 2
    card = card_line()
    say(f"[env] card: {card}")
    say(f"[env] torch {torch.__version__}, torch.version.cuda "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    from rust_wgpu_raytracing_tpu_torch.runtime import profiler
    from rust_wgpu_raytracing_tpu_torch.ops.kernels import build

    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    say(f"[env] nvcc --version: {' | '.join(nvcc)}")
    try:
        import triton
        say(f"[env] triton imports: yes ({triton.__version__})")
    except ImportError:
        say("[env] triton imports: no")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # --- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build(verbose=True)
    build.library()
    say(f"[build] {os.path.relpath(lib_path)} in "
        f"{time.perf_counter() - t0:.1f} s (flags: {' '.join(build.NVCC_FLAGS)})")
    for name in ("closest_hit", "anyhit", "closest_hit_perray",
                 "extend_shadow", "stream_closest_hit",
                 "stream_closest_hit_perray", "stream_anyhit"):
        out = (ctypes.c_int * 4)()
        err = getattr(build.library(), f"rt_{name}_resources")(out)
        if err:
            raise RuntimeError(f"rt_{name}_resources: CUDA error {err}")
        say(f"[build] {name} (per-ray culled walk): {out[0]} registers, "
            f"{out[1]} bytes spilled a thread, {out[2]} bytes of shared "
            f"memory a block, {out[3]} blocks an SM "
            f"(cudaFuncGetAttributes, "
            f"cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    from rust_wgpu_raytracing_tpu_torch.ops.kernels.frame import MODES

    # K4's kernel per mode, and K5's
    for label, fn, arg in [(f"frame, mode {m}", "rt_frame_resources", (v,))
                           for m, v in MODES.items()] + [
            ("hier_cull", "rt_hier_cull_resources", ()),
            ("super_any", "rt_super_any_resources", ()),
            ("sweep_front", "rt_sweep_front_resources", ())]:
        out = (ctypes.c_int * 4)()
        err = getattr(build.library(), fn)(*arg, out)
        if err:
            raise RuntimeError(f"{fn}{arg}: CUDA error {err}")
        say(f"[build] {label}: {out[0]} registers, {out[1]} bytes spilled "
            f"a thread, {out[2]} bytes of shared memory a block, {out[3]} "
            f"blocks an SM (cudaFuncGetAttributes, "
            f"cudaOccupancyMaxActiveBlocksPerMultiprocessor)")

    from rust_wgpu_raytracing_tpu_torch import Renderer

    if "--multi" in sys.argv[1:]:  # phase 14 alone
        from rust_wgpu_raytracing_tpu_torch.ops import kernels as K

        asset_dir = tempfile.mkdtemp(prefix="rt_nm_")
        os.environ["RWRT_ASSETS"] = asset_dir
        write_nm_assets(asset_dir)
        multidevice_phase(card, K, {}, say)
        shutil.rmtree(asset_dir, ignore_errors=True)
        return 0

    if "--super-any" in sys.argv[1:]:  # the admission kernel alone
        from rust_wgpu_raytracing_tpu_torch.ops import kernels as K

        super_any_phase(card, K, Renderer, {}, {}, say)
        say(card)
        return 0

    if "--sweep-front" in sys.argv[1:]:  # K13 alone
        from rust_wgpu_raytracing_tpu_torch.ops import kernels as K

        sweep_front_phase(card, K, Renderer, {}, say)
        say(card)
        return 0

    if "--profile" in sys.argv[1:]:
        asset_dir = tempfile.mkdtemp(prefix="rt_nm_")
        os.environ["RWRT_ASSETS"] = asset_dir
        write_nm_assets(asset_dir)
        for variant in ("fused", "split", "pathtrace", "stream",
                        "pt_stream"):
            # orbit key held: every profiled PT frame is one fresh sample
            cfg = {"pathtrace": pt_config, "stream": stream_config,
                   "pt_stream": pt_stream_config}.get(
                       variant, lambda: smoke_config(variant))()
            rv = Renderer(cfg, device="cuda")
            if variant == "pathtrace":
                pt_rv = rv
            rv.controller.process_key("d", True)
            prof = profile_frames(rv)
            top = prof.pop("top")
            say(f"[profile] {card}: {variant} frame {json.dumps(prof)}")
            for name, seconds in top:
                say(f"[profile]   {variant}: {name} {seconds * 1e3:.3f} ms")
        from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
        from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (
            PRNGKey, render_pathtrace)
        from rust_wgpu_raytracing_tpu_torch.runtime.profiler import count_ops

        ops = count_ops(lambda ks: render_pathtrace(
            pt_rv.data, pt_rv.camera.uniforms().flat(), PRNGKey(PT_SEED),
            width=WIDTH, height=HEIGHT, bounces=PT_BOUNCES,
            compact_cap="auto", kernels=ks), K.KERNELS)
        say(f"[profile] pathtrace: torch operations per sample "
            f"{sum(ops.values())} (kernels "
            f"{ {k: v for k, v in ops.items() if k.startswith('kernel')} }"
            f"); top {ops.most_common(8)}")
        shutil.rmtree(asset_dir, ignore_errors=True)
        return 0

    from rust_wgpu_raytracing_tpu_torch.config import (CameraConfig,
                                                       MeshConfig,
                                                       RenderConfig,
                                                       SceneConfig)
    from rust_wgpu_raytracing_tpu_torch.core.camera import Camera
    from rust_wgpu_raytracing_tpu_torch.ops import kernels as K
    from rust_wgpu_raytracing_tpu_torch.ops.fusedframe import \
        render_frame_fused
    from rust_wgpu_raytracing_tpu_torch.ops.megakernel import (
        render_megakernel, winner_occlusion)

    names = [f.__name__ for f in K.KERNELS]
    plain = dict(zip(names, K.PLAIN))
    wrapper = dict(zip(names, K.KERNELS))

    cfg = smoke_config()
    rc = cfg.render
    t0 = time.perf_counter()
    r = Renderer(cfg, device="cuda")
    say(f"[scene] {r.data.num_faces} faces (padded {r.data.padded_faces}), "
        f"{r.data.num_spheres} spheres, {r.data.blk_lo.shape[0]} face "
        f"blocks; built in {time.perf_counter() - t0:.1f} s")

    def frame(data, uni, kernels, fused, shadows=True, nm=False, **kw):
        return render_megakernel(
            data, uni, width=WIDTH, height=HEIGHT, near=rc.kernel_near,
            far=rc.kernel_far, background=tuple(cfg.background),
            shadows=shadows, quantize=kw.pop("quantize", rc.quantize_rgba8),
            accel=rc.accel, fused=fused, normal_mapping=nm, kernels=kernels,
            **kw)

    def record(run):
        """run(kernels) with every kernel call's arguments recorded:
        {name: [(args, kwargs), ...]} in call order."""
        ks, calls = _recording(K)
        run(ks)
        torch.cuda.synchronize()
        return calls

    def capture(data, uni, **kw):
        """Render one frame; each kernel's arguments at its last call."""
        calls = record(lambda ks: frame(data, uni, ks, **kw))
        return {name: c[-1] for name, c in calls.items()}

    def random_taps(args):
        """The captured arguments with the taps replaced by seeded random
        u16 (a solid texture makes the mix trivial)."""
        rng = np.random.default_rng(20261016)
        taps = rng.integers(0, 65536, tuple(args[0].shape), dtype=np.uint16)
        dev = args[0].device
        return (torch.from_numpy(taps.view(np.int16)).to(dev),) + \
            tuple(args[1:])

    planes_of = {"closest_hit": "t, face, st, sid, snx, sny, snz",
                 "texshade": "pr, pg, pb", "anyhit": "occ",
                 "texfilter": "r, g, b", "closest_hit_perray": "t, face",
                 "extend_shadow": "t, face, occ", "hier_cull": "words",
                 "stream_closest_hit": "t, face",
                 "stream_closest_hit_perray": "t, face",
                 "stream_anyhit": "occ"}

    flat = flat_out

    errs = {}

    def check(view, name, args, kw, tag=""):
        got = flat(name, wrapper[name](*args, **kw))
        want = flat(name, plain[name](*args, **kw))
        torch.cuda.synchronize()
        err = max(max_abs_err(x, y) for x, y in zip(got, want))
        exact = all(torch.equal(x, y) for x, y in zip(got, want))
        if name in ("texshade", "texfilter"):
            gap = max(ulp_gap(x, y) for x, y in zip(got, want))
            ok, bar = gap <= 0, f"max gap {gap} ulp (bound 0 ulp)"
        elif name in SIGNED_T:
            same_t = torch.equal(got[0].view(torch.int32),
                                 want[0].view(torch.int32))
            ok = exact and same_t
            bar = (f"every plane equal by value and t bitwise (the sign of "
                   f"a zero t) required; t bitwise {same_t}")
        else:
            ok, bar = exact, "every plane equal by value required"
        planes = planes_of.get(name, f"{len(got)} planes, mode "
                                     f"{kw.get('mode')}")
        if name == "closest_hit" and len(got) == 2:  # no spheres
            planes = "t, face"
        first = args[0] if torch.is_tensor(args[0]) else args[1]
        shape = "x".join(map(str, first.shape))
        say(f"[kernel] {view}: {name}{tag} {'OK' if ok else 'MISMATCH'} vs "
            f"plain on ({planes}), first arg {shape}; max_abs_err {err!r}; "
            f"bitwise {exact}; {bar}")
        if not ok:
            raise AssertionError(f"{name}{tag} disagrees with its plain "
                                 f"version at the {view}")
        errs[name] = max(errs.get(name, 0.0), err)
        return got

    def drive(label, renderer, need, absent=(), frames=FRAMES):
        """Reset the counters, render WARMUP + frames with the orbit key
        held, read the counters; returns (times, launches, last frame).
        The launches cover the frames the host launched: the eager ones
        and a capture, not the replays (printed beside them)."""
        K.reset_launch_counts()
        before = profiler.counters()
        renderer.controller.process_key("d", True)
        times = []
        for i in range(WARMUP + frames):
            renderer.update()
            color, depth = renderer.render(block=True)
            if i >= WARMUP:
                times.append(renderer.last_frame_ms)
        launches = K.launch_counts()
        now = profiler.counters()
        captures, replays = (now.get(k, 0) - before.get(k, 0)
                             for k in ("frame.graph_captures",
                                       "frame.graph_replays"))
        say(f"[path] {label}: launches over the "
            f"{WARMUP + frames - replays + captures} of {WARMUP + frames} "
            f"frames the host launched (graph captures {captures}, "
            f"replays {replays}): {launches}")
        missing = [k for k in need if launches[k] == 0]
        extra = [k for k in absent if launches[k] != 0]
        if missing or extra:
            raise AssertionError(f"{label}: kernels of the path never "
                                 f"launched {missing}, kernels off the path "
                                 f"launched {extra}")
        if tuple(color.shape) != (renderer.height, renderer.width, 3) or \
                not bool(torch.isfinite(color).all()):
            raise AssertionError(f"{label}: bad frame {tuple(color.shape)}")
        return sorted(times), launches, color, depth

    # --- 3. each kernel against its plain version at the frame's shapes ----
    smoke_uni = r.camera.uniforms().flat()
    dense_uni = Camera.from_config(CameraConfig(
        eye=DENSE_EYE, target=DENSE_TARGET), WIDTH / HEIGHT).uniforms().flat()
    split_args, fused_args = {}, {}
    for view, uni in (("smoke view", smoke_uni), ("dense view", dense_uni)):
        cap = capture(r.data, uni, fused=False)
        split_args[view] = cap
        for name in ("closest_hit", "texshade", "anyhit"):
            args, kw = cap[name]
            got = check(view, name, args, kw)
            if name in BOX_ARG:
                check(view, name, args[:BOX_ARG[name]], kw,
                      " (no boxes: every ray of an admitted block)")
            if name == "closest_hit":
                say(f"[kernel] {view}: {int(torch.isfinite(got[0]).sum())} "
                    f"of {got[0].numel()} rays hit the mesh, "
                    f"{int(torch.isfinite(got[2]).sum())} a sphere; "
                    f"{float(torch.isfinite(args[0]).sum(1).float().mean()):.1f}"
                    f" of {args[0].shape[1]} face blocks admitted per tile")
            if name == "anyhit":
                say(f"[kernel] {view}: {int(args[8].sum())} active shadow "
                    f"rays, {int((got[0] > 0).sum())} occluded")
            if name == "texshade":
                check(view, name, random_taps(args), kw, " (random taps)")
        cap = capture(r.data, uni, fused=True)
        fused_args[view] = cap
        args, kw = cap["frame"]
        sched = check(view, "frame", args, kw)
        ink = check(view, "frame", args, dict(kw, mode="inkernel"),
                    " (in-kernel shadows)")
        for mode in ("sched", "inkernel"):
            check(view, "frame", args[:BOX_ARG["frame"]], dict(kw, mode=mode),
                  " (no boxes: every ray of an admitted block)")
        dx, dy, dz = args[3:6]
        # the sched branch's occlusion, traced as the fused frame's tail
        # traces it
        occ_sched = winner_occlusion(
            r.data, args[2][:3], dx, dy, dz,
            (sched[1] > 0.0) & (sched[15] > 0.0), *sched[8:15]).float()
        torch.cuda.synchronize()
        same_occ = torch.equal(occ_sched, ink[2])
        f_s, _ = frame(r.data, uni, K.KERNELS, True, quantize=False)
        f_i, _ = render_frame_fused(
            r.data, uni, width=WIDTH, height=HEIGHT, near=rc.kernel_near,
            far=rc.kernel_far, background=tuple(cfg.background),
            shadows=True, quantize=False, accel=rc.accel,
            shadow_mode="inkernel")
        same_frame = torch.equal(f_s, f_i)
        say(f"[kernel] {view}: frame in-kernel shadows vs sched: occ equal "
            f"{same_occ} ({int((ink[2] > 0).sum())} occluded of "
            f"{int((sched[15] > 0).sum())} relevant), unquantized frames "
            f"equal {same_frame}")
        if not (same_occ and same_frame):
            raise AssertionError("in-kernel shadows disagree with sched")

    # K4 at the Renderer's orbit frames as torch.profiler sees them
    # (--profile, profile_frames: WARMUP unprofiled
    # frames, then 5, each after update() with the orbit key held)
    orbit = Renderer(smoke_config("fused"), device="cuda")
    orbit.controller.process_key("d", True)
    orbit_args = []
    for i in range(WARMUP + 5):
        orbit.update()
        if i >= WARMUP:
            orbit_args.append(capture(r.data, orbit.camera.uniforms().flat(),
                                      fused=True)["frame"])
    def walks(args, kw):
        """K4's sweep at these arguments: admitted blocks per tile (mean)
        and blocks within its reach (mean, max), the mask walk's visits;
        the mesh t from K1 on the same rays."""
        t = wrapper["closest_hit"](
            args[0], args[1], *args[3:9], args[2][:3].contiguous(),
            *args[10:12], block_f=kw["block_f"])[0]
        reach = torch.minimum(t, args[6]).view(-1, 1024).amax(1)
        adm = torch.isfinite(args[0])
        walk = (adm & (args[0] <= reach[:, None])).sum(1)
        return (f"{float(adm.sum(1).float().mean()):.1f} of {args[0].shape[1]}"
                f" face blocks admitted per tile, within the sweep's reach "
                f"{float(walk.float().mean()):.1f} (at most {int(walk.max())}"
                f", {int((walk >= 20).sum())} tiles at 20 or more)")

    for view in ("smoke view", "dense view"):
        say(f"[kernel] {view}, fused: {walks(*fused_args[view]['frame'])}")
    for k, (args, kw) in enumerate(orbit_args):
        got = wrapper["frame"](*args, **kw)
        say(f"[kernel] orbit frame {WARMUP + 1 + k}: "
            f"{int((got[1] == r.data.num_spheres + 1).sum())} of "
            f"{got[1].numel()} rays hit the mesh, "
            f"{int(((got[1] > 0) & (got[1] <= r.data.num_spheres)).sum())} a "
            f"sphere; {walks(args, kw)}")
    args, kw = orbit_args[-1]
    check(f"orbit frame {WARMUP + 5}", "frame", args, kw)
    check(f"orbit frame {WARMUP + 5}", "frame", args,
          dict(kw, mode="inkernel"), " (in-kernel shadows)")

    # the normal-mapped heightfield, built at run time
    asset_dir = tempfile.mkdtemp(prefix="rt_nm_")
    os.environ["RWRT_ASSETS"] = asset_dir
    write_nm_assets(asset_dir)
    nm_r = Renderer(nm_config(shadows=False), device="cuda")
    say(f"[scene] nm heightfield: {nm_r.data.num_faces} faces (padded "
        f"{nm_r.data.padded_faces}), bump pool "
        f"{tuple(nm_r.data.tex_packed_bump.shape)}, diffuse pool "
        f"{tuple(nm_r.data.tex_packed.shape)}")
    nm_uni = nm_r.camera.uniforms().flat()
    cap = capture(nm_r.data, nm_uni, fused=True, shadows=False, nm=True)
    nm_frame = cap["frame"]
    check("nm view", "frame", *nm_frame)
    nm_taps = cap["texfilter"][0]
    check("nm view", "texfilter", *cap["texfilter"])
    check("nm view", "texfilter", random_taps(nm_taps), {}, " (random taps)")
    check("nm view", "texshade", *cap["texshade"])
    cap = capture(nm_r.data, nm_uni, fused=False, shadows=True, nm=True)
    check("nm view, split with shadows", "texfilter", *cap["texfilter"])
    texel_offset_phase(check, say)

    # --- 4. the paths through the Renderer --------------------------------
    def against_plain(label, renderer, color, nm=False):
        fused = renderer.variant_chosen == "fused"
        ref, _ = frame(renderer.data, renderer.camera.uniforms().flat(),
                       K.PLAIN, fused, shadows=renderer.config.render.shadows,
                       nm=nm)
        dmax, exact, bitwise = frame_bar(color, ref)
        say(f"[frame] {label}: vs plain-composed frame: max linear u8 "
            f"delta {dmax}, exact {exact:.6f}, bitwise {bitwise}")
        if not bitwise:
            raise AssertionError(f"{label} differs from its plain-composed "
                                 f"frame")

    path_launches = {}
    auto = Renderer(smoke_config("auto"), device="cuda")
    times, path_launches["auto"], color, depth = drive(
        "auto (main path)", auto,
        ("frame", "closest_hit", "texshade", "anyhit"))
    say(f"[path] auto: variant_ms {auto.variant_ms}, variant_chosen "
        f"{auto.variant_chosen!r}")
    against_plain("auto", auto, color)
    say(f"[frame] auto: mean colour {float(color.mean()):.5f}, "
        f"{float((depth < 1).float().mean()):.4f} of pixels hit")

    medians = {}
    for variant, need, absent in (
            ("fused", ("frame", "texshade", "anyhit"), ("closest_hit",)),
            ("split", ("closest_hit", "texshade", "anyhit"), ("frame",))):
        rv = Renderer(smoke_config(variant), device="cuda")
        times, path_launches[variant], color, _ = drive(variant, rv, need,
                                                        absent)
        med = times[len(times) // 2]
        medians[variant] = med
        say(f"[timing] {card}: {WIDTH}x{HEIGHT} shadowed {variant} frame, "
            f"median {med:.3f} ms/frame over {FRAMES} frames (CUDA events; "
            f"min {times[0]:.3f}, max {times[-1]:.3f}), "
            f"{WIDTH * HEIGHT / (med * 1e-3) / 1e6:.1f} Mrays/s")
        against_plain(variant, rv, color)

    for view, uni in (("smoke view", smoke_uni), ("dense view", dense_uni)):
        fc, fd = frame(r.data, uni, K.KERNELS, True)
        sc, sd = frame(r.data, uni, K.KERNELS, False)
        dmax, exact, bitwise = frame_bar(fc, sc)
        say(f"[frame] {view}: fused vs split: {int((fc != sc).sum())} of "
            f"{fc.numel()} quantized subpixels differ, max linear u8 delta "
            f"{dmax}, exact {exact:.6f}, bitwise {bitwise}; depth equal "
            f"{bool(torch.equal(fd, sd))}")
        if dmax > 1 or exact < 0.999:
            raise AssertionError("fused frame disagrees with the split frame")

    nm_fused = Renderer(nm_config(shadows=False, variant="fused"),
                        device="cuda")
    _, path_launches["nm"], color, depth = drive(
        "nm fused, no shadows", nm_fused, ("frame", "texfilter", "texshade"),
        ("closest_hit",), frames=3)
    say(f"[frame] nm: variant_chosen {nm_fused.variant_chosen!r}, mean "
        f"colour {float(color.mean()):.5f}, "
        f"{float((depth < 1).float().mean()):.4f} of pixels hit")
    against_plain("nm fused", nm_fused, color, nm=True)
    nm_split = Renderer(nm_config(shadows=True), device="cuda")
    _, path_launches["nm_shadows"], color, _ = drive(
        "nm split, shadows", nm_split,
        ("closest_hit", "texfilter", "texshade", "anyhit"), ("frame",),
        frames=3)
    if nm_split.variant_chosen != "split":
        raise AssertionError("nm with shadows must render split")
    against_plain("nm split with shadows", nm_split, color, nm=True)

    from rust_wgpu_raytracing_tpu_torch.io.image_out import (
        framebuffer_to_image, read_png)

    golden = read_png(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests", "goldens", "terrain_shadows.png"))
    img = torch.from_numpy(golden[::-1].copy()).to(torch.int64)
    # golden holds the sRGB encode of linear u8 levels: compare levels
    # through the same encode (a level off is a neighbour's code)
    enc = [int(framebuffer_to_image(np.full((1, 1, 3), k / 255.0,
                                            np.float32))[0, 0, 0])
           for k in range(256)]
    lut = torch.tensor(enc)
    for variant in ("fused", "split"):
        golden_cfg = SceneConfig(
            meshes=(MeshConfig(obj_path="builtin:terrain:23",
                               translation=(0.0, 0.0, -3.0),
                               light_direction=(6.0, -1.0, 1.0)),),
            camera=CameraConfig(eye=SMOKE_EYE, target=SMOKE_TARGET),
            render=RenderConfig(width=160, height=160, shadows=True,
                                variant=variant))
        g, _ = Renderer(golden_cfg, device="cuda").render(block=True)
        levels = u8(g).cpu().long()
        exact_g = lut[levels] == img
        near_g = exact_g | (lut[(levels - 1).clamp(0, 255)] == img) | \
            (lut[(levels + 1).clamp(0, 255)] == img)
        say(f"[frame] 160x160 terrain frame ({variant}) vs committed golden: "
            f"exact {float(exact_g.float().mean()):.6f}, within 1 level "
            f"{bool(near_g.all())}")
        if not bool(near_g.all()) or float(exact_g.float().mean()) < 0.999:
            raise AssertionError("terrain frame disagrees with its golden")

    # --- 5. the progressive path tracer -----------------------------------
    from rust_wgpu_raytracing_tpu_torch.ops import megakernel as MK
    from rust_wgpu_raytracing_tpu_torch.ops.pathtrace import (
        PRNGKey, fold_in, render_pathtrace)

    pt_cfg = pt_config()
    pt_r = Renderer(pt_cfg, device="cuda")
    pt_data = pt_r.data
    pt_uni = pt_r.camera.uniforms().flat()
    pt_key = fold_in(PRNGKey(PT_SEED), 0)  # the Renderer's first sample

    def trace(kernels, compact_cap="auto"):
        return render_pathtrace(
            pt_data, pt_uni, pt_key, width=WIDTH, height=HEIGHT,
            bounces=PT_BOUNCES, spp=1, background=tuple(pt_cfg.background),
            compact_cap=compact_cap, kernels=kernels)

    compacted = profiler.counters().get("pt.compacted", 0)
    pt_frame = None

    def first_sample(ks):
        nonlocal pt_frame
        pt_frame = trace(ks)

    calls = record(first_sample)
    branch = ("compacted" if profiler.counters().get("pt.compacted", 0)
              > compacted else "full")
    say(f"[pt] heightfield {pt_data.num_faces} faces + "
        f"{pt_data.num_spheres} spheres, {WIDTH}x{HEIGHT}, {PT_BOUNCES} "
        f"bounces, one sample: kernel calls "
        f"{ {k: len(v) for k, v in calls.items()} }; compact_cap='auto' "
        f"took the {branch} loop")
    es_args, es_kw = calls["extend_shadow"][0]  # the bounce-1 wavefront
    ah_args, ah_kw = calls["anyhit"][-1]  # the last bounce's shadow rays
    ch_args, ch_kw = calls["closest_hit"][0]  # the primary sweep
    d, o = es_args[2:5], es_args[5:8]
    sd, so, act = es_args[8:11], es_args[11:14], es_args[14]
    # K7 and K3 on the same rays, through their own glue
    k7_args, k7_kw = record(lambda ks: MK.gbuffer_perray(
        pt_data, *o, *d, kernels=ks))["closest_hit_perray"][0]
    k3_args, k3_kw = record(lambda ks: MK.anyhit_rays(
        pt_data, *so, *sd, act > 0, kernels=ks))["anyhit"][0]
    k8 = check("pt bounce 1", "extend_shadow", es_args, es_kw)
    k7 = check("pt bounce 1", "closest_hit_perray", k7_args, k7_kw)
    check("pt bounce 1", "closest_hit_perray", k7_args[:BOX_ARG[
        "closest_hit_perray"]], k7_kw,
        " (no boxes: every ray of an admitted block)")
    check("pt last bounce", "anyhit", ah_args, ah_kw, " (act-aware mask)")
    check("pt last bounce", "anyhit", ah_args[:12], ah_kw,
          " (act-aware mask, no boxes: every ray of an admitted block)")
    pt_ch = check("pt primary", "closest_hit", ch_args, ch_kw)
    check("pt primary", "closest_hit", ch_args[:9], ch_kw,
          " (no boxes: every ray of an admitted block)")
    say(f"[pt] primary sweep: {int(torch.isfinite(pt_ch[0]).sum())} of "
        f"{pt_ch[0].numel()} rays hit the mesh; "
        f"{float(torch.isfinite(ch_args[0]).sum(1).float().mean()):.1f} of "
        f"{ch_args[0].shape[1]} face blocks admitted per tile")
    k3 = wrapper["anyhit"](*k3_args, **k3_kw)
    torch.cuda.synchronize()
    fused_ok = [torch.equal(k8[0], k7[0]), torch.equal(k8[1], k7[1]),
                torch.equal(k8[2], k3)]
    nb = es_args[15].shape[0] // es_kw["block_f"]
    say(f"[pt] bounce 1: {int(torch.isfinite(k8[0]).sum())} of "
        f"{k8[0].numel()} extension rays hit, {int((k8[2] > 0).sum())} of "
        f"{int(act.sum())} active shadow rays occluded; admitted (tile, "
        f"block) pairs: K8 closest-hit {int(mask_bits(es_args[0], nb).sum())}"
        f", K8 shadow {int(mask_bits(es_args[1], nb).sum())}, K7 "
        f"{int(torch.isfinite(k7_args[0]).sum())}; last bounce: "
        f"{int(ah_args[8].sum())} active shadow rays, K3 pairs "
        f"{int(torch.isfinite(ah_args[0]).sum())}")
    say(f"[pt] K8 vs K7 + K3 on the bounce-1 rays: t equal {fused_ok[0]}, "
        f"face equal {fused_ok[1]}, occ equal {fused_ok[2]}")
    if not all(fused_ok):
        raise AssertionError("the fused extend+shadow kernel disagrees with "
                             "the per-ray closest hit + any-hit kernels")
    check("pt bounce 1", "extend_shadow", es_args[:17], es_kw,
          " (no boxes: every ray of an admitted block)")
    ext, shadow = culled_walk("extend_shadow", es_args, es_kw, k8)
    (k7n,) = culled_walk("closest_hit_perray", k7_args, k7_kw, k7)
    say(f"[pt] K7 bounce 1, (ray, block) pairs of the blocks within its "
        f"tiles' reach: admitted {k7n['admitted']}, entered "
        f"{k7n['entered']}, entered at or below the final t "
        f"{k7n['face_pairs']} ({k7n['blocks']} distinct blocks)")
    say(f"[pt] K8 bounce 1, (ray, block) pairs: closest hit admitted "
        f"{ext['admitted']}, entered {ext['entered']}, entered at or below "
        f"the final t {ext['face_pairs']} ({ext['blocks']} distinct blocks); "
        f"shadow admitted {shadow['admitted']}, entered {shadow['entered']}, "
        f"face-tested at least {shadow['face_pairs']} "
        f"({shadow['blocks']} distinct blocks)")
    raycull_phase(record, check, say)
    pt_plain = trace(K.PLAIN)
    pt_full = trace(K.KERNELS, compact_cap=None)
    # room for every tile: the compacted loop runs whatever is live
    compacted = profiler.counters().get("pt.compacted", 0)
    pt_compact = trace(K.KERNELS, compact_cap=2 * WIDTH * HEIGHT)
    ran_compact = profiler.counters().get("pt.compacted", 0) == compacted + 1
    torch.cuda.synchronize()
    same_plain = torch.equal(pt_frame, pt_plain)
    same_full = torch.equal(pt_frame, pt_full)
    same_compact = torch.equal(pt_compact, pt_full)
    say(f"[pt] one sample through the kernels vs composed from the plain "
        f"versions: bitwise {same_plain} (max_abs_err "
        f"{max_abs_err(pt_frame, pt_plain)!r}); compact_cap='auto' "
        f"({branch}) vs the full loop: bitwise {same_full}; the compacted "
        f"loop (ran {ran_compact}) vs the full loop: bitwise "
        f"{same_compact} (max_abs_err {max_abs_err(pt_compact, pt_full)!r})"
        f"; radiance sum {float(pt_frame.sum()):.3f}, mean "
        f"{float(pt_frame.mean()):.5f}")
    if not (same_plain and same_full and same_compact and ran_compact):
        raise AssertionError("path-traced sample differs from its plain, "
                             "full-loop or compacted twin")

    # the Renderer: samples accumulate up to pt_spp, orbit key released
    from rtbench.trace import host_syncs

    K.reset_launch_counts()
    profiler.reset_counters("syncs.")
    pt_times, first = [], None
    with host_syncs() as syncs:
        t0 = time.perf_counter()
        while pt_r.spp_done < PT_SPP:
            pt_r.update()
            color, _ = pt_r.render(block=True)
            if first is None:
                first = color.clone()
            if pt_r.spp_done > WARMUP:
                pt_times.append(pt_r.last_frame_ms)
        torch.cuda.synchronize()
        pt_wall = time.perf_counter() - t0
    path_launches["pt"] = K.launch_counts()
    waits = {k: v for k, v in profiler.counters().items()
             if k.startswith("syncs.")}
    say(f"[path] path tracer, {PT_SPP} samples: launches "
        f"{path_launches['pt']}, host syncs {len(syncs)} (torch's sync "
        f"debug mode, render(block=True)'s synchronize not counted); the "
        f"program's waits {waits}")
    missing = [k for k in ("closest_hit", "extend_shadow", "anyhit",
                           "texfilter") if path_launches["pt"][k] == 0]
    extra = [k for k in ("frame", "texshade", "closest_hit_perray")
             if path_launches["pt"][k] != 0]
    again, _ = pt_r.render(block=True)
    if missing or extra or not pt_r.pt_converged:
        raise AssertionError(f"path tracer: kernels never launched "
                             f"{missing}, kernels off the path launched "
                             f"{extra}, converged {pt_r.pt_converged}")
    if tuple(color.shape) != (HEIGHT, WIDTH, 3) or not bool(
            torch.isfinite(color).all()) or float(color.min()) < 0:
        raise AssertionError(f"path tracer: bad frame {tuple(color.shape)}")
    same_first = torch.equal(first, pt_frame)
    say(f"[pt] Renderer: first sample equal to the kernel-run sample "
        f"{same_first}; after {pt_r.spp_done} samples mean colour "
        f"{float(color.mean()):.5f}; re-presented at the target "
        f"{torch.equal(again, color)}")
    if not (same_first and torch.equal(again, color)):
        raise AssertionError("the Renderer's path-traced frames are wrong")
    pt_times.sort()
    pt_med = pt_times[len(pt_times) // 2]
    say(f"[timing] {card}: path tracer {WIDTH}x{HEIGHT}, {PT_BOUNCES} "
        f"bounces: median {pt_med:.3f} ms per sample over "
        f"{len(pt_times)} samples after {WARMUP} warm-up (CUDA events; min "
        f"{pt_times[0]:.3f}, max {pt_times[-1]:.3f}), {PT_SPP} samples in "
        f"{pt_wall:.3f} s (host clock, warm-up included), "
        f"{WIDTH * HEIGHT / (pt_med * 1e-3) / 1e6:.3f} Mpaths/s at the "
        f"median, {WIDTH * HEIGHT * PT_SPP / pt_wall / 1e6:.3f} Mpaths/s "
        f"over the {PT_SPP} samples")

    # --- 6. timing --------------------------------------------------------
    def inkernel_frame(uni):
        return render_frame_fused(
            r.data, uni, width=WIDTH, height=HEIGHT, near=rc.kernel_near,
            far=rc.kernel_far, background=tuple(cfg.background),
            shadows=True, accel=rc.accel, shadow_mode="inkernel")

    for view, uni in (("smoke view", smoke_uni), ("dense view", dense_uni)):
        for label, fn in (
                ("fused", lambda: frame(r.data, uni, K.KERNELS, True)),
                ("fused in-kernel shadows", lambda: inkernel_frame(uni)),
                ("split", lambda: frame(r.data, uni, K.KERNELS, False))):
            say(f"[timing] {card}: {view} {WIDTH}x{HEIGHT} shadowed {label} "
                f"frame {time_ms(fn, 10):.3f} ms/frame (mean of 10 "
                f"back-to-back, CUDA events)")
    # each kernel's main arguments (timed beside its plain version) and
    # the other argument sets of its paths (the kernel alone)
    dense = split_args["dense view"]
    timed = {
        "closest_hit": (split_args["smoke view"]["closest_hit"],
                        [("the dense view's", dense["closest_hit"]),
                         ("the path tracer's primary-sweep",
                          (ch_args, ch_kw))]),
        "texshade": ((random_taps(split_args["smoke view"]["texshade"][0]),
                      {}), []),
        "anyhit": (split_args["smoke view"]["anyhit"],
                   [("the dense view's", dense["anyhit"]),
                    ("the path tracer's last-bounce", (ah_args, ah_kw))]),
        "frame": (fused_args["smoke view"]["frame"],
                  [("the dense view's", fused_args["dense view"]["frame"])]
                  + [(f"the {view} view's (mode {mode})",
                      (fused_args[f"{view} view"]["frame"][0],
                       dict(fused_args[f"{view} view"]["frame"][1],
                            mode=mode)))
                     for view, mode in (("smoke", "inkernel"),
                                        ("dense", "inkernel"),
                                        ("smoke", "nm"), ("smoke", "none"))]
                  + [("the nm frame's", nm_frame)]
                  + [(f"orbit frame {WARMUP + 1 + k}'s", a)
                     for k, a in enumerate(orbit_args)]),
        "texfilter": ((nm_taps, {}), []),
        "closest_hit_perray": ((k7_args, k7_kw), []),
        "extend_shadow": ((es_args, es_kw), []),
    }
    where = {"texfilter": "the nm frame's", "closest_hit_perray":
             "the path tracer's bounce-1", "extend_shadow":
             "the path tracer's bounce-1"}

    def bound_note(name, args, kw, outs, ms):
        """A timing line's bound: the culled walk's, then the unfused
        rate's and, for the per-ray culled walks, the face tests' bound
        alone, the mask walk's bound and the walk's parts."""
        mesh = None
        if name == "frame":
            # the frame's sweep is K1's: its mesh winners, from K1 on these
            # rays
            mesh = wrapper["closest_hit"](
                args[0], args[1], *args[3:9], args[2][:3].contiguous(),
                *args[10:12], block_f=kw["block_f"])[:2]
        counts = {}
        moved, ops = kernel_work(name, args, kw, outs, mesh, counts=counts)
        bound_ms, bound_by = bound(moved, ops)
        unfused_ms, _ = bound(moved, ops, FP32_UNFUSED_S)
        note = (f"bound {bound_ms:.4f} ms by {bound_by} ({moved} bytes, "
                f"{ops} FP32 operations), {100 * bound_ms / ms:.1f}% of it; "
                f"{unfused_ms:.4f} ms at the unfused issue rate, "
                f"{100 * unfused_ms / ms:.1f}% of it")
        if name in BOX_ARG:
            note += face_test_note(moved, ops, counts["box_tests"], ms) \
                + mask_walk_note(name, args, kw, outs, ms, mesh) \
                + walk_parts(name, args, kw, 20)
        if name in ("closest_hit", "anyhit"):
            note += longest_walk(name, args, kw, outs, 20)
        return note, bound_ms, bound_by

    def ray_major_sweep(name, at, args, kw, reps=10, rounds=2):
        """K1's or K3's time at these arguments at each RAY_MAJORS
        threshold of its ray-major chunks, each output bitwise the
        default's; each time the median of `rounds` rounds that visit the
        thresholds in turn, each round the mean of `reps` launches."""
        from rust_wgpu_raytracing_tpu_torch.ops.kernels import common

        default = common.RAY_MAJOR[name]
        want = flat(name, wrapper[name](*args, **kw))
        runs = {v: [] for v in RAY_MAJORS}
        try:
            for v in RAY_MAJORS:
                common.RAY_MAJOR[name] = v
                got = flat(name, wrapper[name](*args, **kw))
                torch.cuda.synchronize()
                if not all(torch.equal(x.view(torch.int32), y.view(
                        torch.int32)) for x, y in zip(got, want)):
                    raise AssertionError(f"{name}: RAY_MAJOR {v} changes "
                                         f"the output")
            for _ in range(rounds):
                for v in RAY_MAJORS:
                    common.RAY_MAJOR[name] = v
                    runs[v].append(time_ms(
                        lambda: wrapper[name](*args, **kw), reps))
        finally:
            common.RAY_MAJOR[name] = default
        say(f"[ray-major] {card}: {name} at {at} arguments by RAY_MAJOR "
            f"(0: every chunk ray-major, 65: every chunk by pairs), ms: "
            + "; ".join(f"{v}: {float(np.median(r)):.4f}"
                        for v, r in runs.items())
            + f" (each output bitwise RAY_MAJOR {default}'s; the median of "
              f"{rounds} interleaved rounds of {reps} launches)")

    results = {}
    for name, (main_call, others) in timed.items():
        args, kw = main_call
        reps = 1 if name in ("closest_hit_perray", "extend_shadow") else 2

        def run_kernel():
            return wrapper[name](*args, **kw)

        def run_plain():
            return plain[name](*args, **kw)
        # turns: plain, kernel, kernel, plain
        p1 = time_ms(run_plain, reps)
        k1 = time_ms(run_kernel, 20)
        k2 = time_ms(run_kernel, 20)
        p2 = time_ms(run_plain, reps)
        ms = (k1 + k2) / 2
        note, bound_ms, bound_by = bound_note(
            name, args, kw, flat(name, run_kernel()), ms)
        results[name] = dict(max_abs_err=errs[name], ms=ms,
                             plain_ms=(p1 + p2) / 2, bound_ms=bound_ms,
                             bound_by=bound_by)
        at = where.get(name, "the smoke frame's")
        say(f"[timing] {card}: {name} {ms:.4f} ms (kernel, {k1:.4f} / "
            f"{k2:.4f}) vs {results[name]['plain_ms']:.4f} ms (plain "
            f"PyTorch) at {at} arguments; {note}")
        orbit_ms = []
        for label, (o_args, o_kw) in others:
            o_ms = time_ms(lambda: wrapper[name](*o_args, **o_kw), 20)
            o_note, _, _ = bound_note(name, o_args, o_kw, flat(
                name, wrapper[name](*o_args, **o_kw)), o_ms)
            say(f"[timing] {card}: {name} {o_ms:.4f} ms (kernel) at "
                f"{label} arguments; {o_note}")
            if label.startswith("orbit"):
                orbit_ms.append(o_ms)
        if orbit_ms:
            say(f"[timing] {card}: {name} at the Renderer's orbit frames "
                f"{WARMUP + 1}-{WARMUP + len(orbit_ms)} (the frames "
                f"chip_smoke.py --profile profiles): mean "
                f"{float(np.mean(orbit_ms)):.4f} ms a frame (CUDA events, "
                f"20 launches each)")
        if name in ("closest_hit", "anyhit"):
            for label, (o_args, o_kw) in [(at, main_call)] + others:
                ray_major_sweep(name, label, o_args, o_kw)
    k7_ms = results["closest_hit_perray"]["ms"]
    k8_ms = results["extend_shadow"]["ms"]
    say(f"[timing] {card}: on the path tracer's bounce-1 extension rays K7 "
        f"(closest hit alone) {k7_ms:.4f} ms, K8 (closest hit + the shadow "
        f"rays' any hit) {k8_ms:.4f} ms: K7 below K8 {k7_ms < k8_ms}")
    say(f"[timing] {card}: medians fused {medians['fused']:.3f} ms, split "
        f"{medians['split']:.3f} ms")

    # --- 7. streaming scale -----------------------------------------------
    del timed, orbit_args  # the streamed cells' peak memory is their own
    stream_data = stream_phase(card, K, Renderer, drive, record, check,
                               results, errs, path_launches, flat, say)

    # --- 8. the oracle ----------------------------------------------------
    oracle_phase(card, K, Renderer, frame, say)

    # --- 9. mip sampling --------------------------------------------------
    mip_phase(card, K, Renderer, drive, record, path_launches, say)

    # --- 10. the LBVH build and its walk ----------------------------------
    lbvh_phase(card, stream_data, say)
    del stream_data

    # --- 11. instancing with the per-frame refit (BASELINE config 5) ------
    ctx = types.SimpleNamespace(K=K, record=record, check=check, flat=flat,
                                errs=errs, path_launches=path_launches)
    instancing_phase(card, ctx, say)

    # --- 12. the raster pipeline ------------------------------------------
    raster_phase(card, say)

    # --- 13. the runtime shells -------------------------------------------
    shells_phase(card, Renderer, say)

    # --- 14. multi-device rendering: gloo ranks sharing the card ----------
    md_launches = multidevice_phase(card, K, errs, say)

    # each kernel's launches from the first path run that uses it
    launches = {}
    for path in ("auto", "nm", "pt", "stream_cull", "stream_bvh",
                 "pt_stream"):
        for name, count in path_launches[path].items():
            if count and name not in launches:
                launches[name] = count
    # plus their launches on the instanced paths (phase 11)
    inst_paths = [p for p in path_launches if p.startswith("inst:")]
    for name in names:
        launches[name] = launches.get(name, 0) + sum(
            path_launches[p][name] for p in inst_paths)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"],
                                           errs.get(name, 0.0))
    say(f"[inst] launches on the instanced paths: "
        f"{ {n: sum(path_launches[p][n] for p in inst_paths) for n in names} }")
    # plus their launches on the slab and gp paths of phase 14, summed
    # over the ranks
    for name in names:
        launches[name] += sum(c.get(name, 0) for c in md_launches.values())
    base = "rust_wgpu_raytracing_tpu_torch/csrc/"
    replaces = {
        "closest_hit": "rust_wgpu_raytracing_tpu/ops/megakernel.py:382",
        "texshade": "rust_wgpu_raytracing_tpu/ops/megakernel.py:2540",
        "anyhit": "rust_wgpu_raytracing_tpu/ops/megakernel.py:612",
        "frame": "rust_wgpu_raytracing_tpu/ops/fusedframe.py:152",
        "texfilter": "rust_wgpu_raytracing_tpu/ops/megakernel.py:2490",
        "closest_hit_perray":
            "rust_wgpu_raytracing_tpu/ops/megakernel.py:580",
        "extend_shadow": "rust_wgpu_raytracing_tpu/ops/megakernel.py:688",
        "hier_cull": "rust_wgpu_raytracing_tpu/ops/traverse_pallas.py:159",
        "stream_closest_hit":
            "rust_wgpu_raytracing_tpu/ops/megakernel.py:1384",
        "stream_closest_hit_perray":
            "rust_wgpu_raytracing_tpu/ops/megakernel.py:1468",
        "stream_anyhit": "rust_wgpu_raytracing_tpu/ops/megakernel.py:1532",
        "super_any": "none: XLA's fusion of "
                     "rust_wgpu_raytracing_tpu/ops/traverse.py:155",
        "sweep_front": "none: XLA's fusion of "
                       "rust_wgpu_raytracing_tpu/ops/megakernel.py "
                       "tile_ray_bounds, _mask_words, _vmem_sched",
    }
    source = {"stream_closest_hit": "stream_sweep",
              "stream_closest_hit_perray": "stream_sweep",
              "stream_anyhit": "stream_sweep"}
    # no single PyTorch call computes any of these functions (the sweeps,
    # the packed-tap texture mixes, the slab-test cull): library_ms is
    # null throughout
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"{base}{source.get(name, name)}.cu",
         "replaces": replaces[name], "launches": launches.get(name, 0),
         **{k: results[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by")},
         "library_ms": None}
        for name in names]}))
    shutil.rmtree(asset_dir, ignore_errors=True)
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
