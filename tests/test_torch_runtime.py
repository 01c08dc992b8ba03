"""PyTorch port: the runtime shells on a CPU Renderer — the frame loop,
the HTTP shell, the window shell's headless parts, checkpoint / resume,
device limits, structured logging and the CLI's three shells — with the
behaviours of the JAX package's tests/test_runtime.py and
tests/test_limits.py, and a checkpoint carried between the packages in
both directions (the JAX side in the jax_reference subprocess).
"""

import dataclasses as dc
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from rust_wgpu_raytracing_tpu_torch import Renderer
from rust_wgpu_raytracing_tpu_torch.config import (MeshConfig, RenderConfig,
                                                   SceneConfig, SphereConfig,
                                                   reference_scene)
from rust_wgpu_raytracing_tpu_torch.io import load_checkpoint, save_checkpoint
from rust_wgpu_raytracing_tpu_torch.io.image_out import (
    framebuffer_to_image, read_png)
from rust_wgpu_raytracing_tpu_torch.runtime import limits as L
from rust_wgpu_raytracing_tpu_torch.runtime.frame_loop import (
    FrameLoop, classify_render_error)
from test_torch_host import jax_reference


def sphere_scene(**render_kw):
    return SceneConfig(
        spheres=(SphereConfig(center=(0.0, 0.0, -3.0), radius=0.8),),
        render=RenderConfig(width=32, height=32, **render_kw))


def tiny_renderer(**render_kw):
    return Renderer(sphere_scene(**render_kw), device="cpu")


def pt_scene(spp):
    return dc.replace(sphere_scene(), render=RenderConfig(
        width=16, height=16, pt_bounces=1, pt_spp=spp))


# ---------------------------------------------------------------------------
# the frame loop
# ---------------------------------------------------------------------------

def test_frame_loop_steps_and_input():
    r = tiny_renderer()
    frames = []
    loop = FrameLoop(r, present=frames.append)
    loop.push_key("d", True)
    eye0 = r.camera.eye.copy()
    loop.run(n_frames=3)
    assert len(frames) == 3 and frames[0].shape == (32, 32, 3)
    assert not np.array_equal(r.camera.eye, eye0)  # the orbit applied
    assert loop.profiler.summary()["frames"] == 3


def test_pipeline_presents_previous_frame_and_flushes_tail():
    """Step k presents frame k-1; flush presents the last frame once."""
    r = tiny_renderer()
    frames = []
    loop = FrameLoop(r, present=frames.append)
    loop.push_key("d", True)
    assert loop.pipeline and loop.step() is None
    first = r._last[0]
    second = loop.step()
    np.testing.assert_array_equal(second, r.present_image(color=first))
    assert loop.flush() is not None and loop.flush() is None
    assert len(frames) == 2


def test_pipeline_queues_the_previous_present_before_the_frame():
    """Step k queues frame k-1's encode and copy, then enqueues frame k,
    and only then waits for the copy: the host's enqueue of frame k
    overlaps frame k-1 on the card."""
    r = tiny_renderer()
    order = []
    real_render, real_fetch = r.render, r.fetch_image

    def render(block=False):
        order.append("render")
        return real_render(block)

    def fetch_image(srgb=True, color=None):
        order.append("queue present")
        wait = real_fetch(srgb=srgb, color=color)

        def waited():
            order.append("wait present")
            return wait()
        return waited

    r.render, r.fetch_image = render, fetch_image
    loop = FrameLoop(r)
    loop.step()
    loop.step()
    assert order == ["render", "queue present", "render", "wait present"]


def test_pipeline_off_presents_current_frame():
    r = tiny_renderer()
    loop = FrameLoop(r, pipeline=False)
    img = loop.step()
    assert img is not None and img.shape == (32, 32, 3)
    assert loop.flush() is None


def test_resize_request_drops_the_old_frame():
    r = tiny_renderer()
    frames = []
    loop = FrameLoop(r, present=frames.append)
    loop.step()
    loop.request_resize(24, 16)
    assert loop.step() is None  # the 32x32 frame in flight is dropped
    assert loop.flush().shape == (16, 24, 3)
    assert (r.width, r.height) == (24, 16)


def test_present_image_of_an_older_frame():
    """present_image(color=) encodes the frame given (1 u8 level of the
    host encode), not the latest."""
    r = tiny_renderer()
    r.controller.process_key("d", True)
    old, _ = r.render()
    r.update()
    new, _ = r.render()
    assert not torch.equal(old, new)
    img = r.present_image(color=old)
    host = framebuffer_to_image(old.numpy(), srgb=True)
    assert np.abs(img.astype(int) - host.astype(int)).max() <= 1
    assert not np.array_equal(img, r.present_image())


# ---------------------------------------------------------------------------
# errors (the reference's SurfaceError match, lib.rs:1338-1347)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exc,kind", [
    (MemoryError(), "oom"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     "oom"),
    (RuntimeError("CUDA error: out of memory"), "oom"),
    (RuntimeError("stream_anyhit: CUDA error 2 at launch"), "oom"),
    (RuntimeError("CUDA error: the launch timed out and was terminated"),
     "timeout"),
    (RuntimeError("frame: CUDA error 702 at launch"), "timeout"),
    (RuntimeError("CUDA error: unspecified launch failure"), "lost"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "lost"),
    (RuntimeError("closest_hit: CUDA error 719 at launch"), "lost"),
    (RuntimeError("CUDA error: device-side assert triggered"), "fatal"),
    (RuntimeError("frame: CUDA error 701 at launch"), "fatal"),
    (RuntimeError("shape mismatch"), "fatal"),
    (ValueError("CUDA error: out of memory"), "fatal"),
    (ValueError("bad shape"), "fatal"),
])
def test_classify_render_error(exc, kind):
    assert classify_render_error(exc) == kind


def test_programming_error_surfaces_as_itself():
    r = tiny_renderer()
    loop = FrameLoop(r)
    boom = ValueError("deterministic render bug")
    calls = []

    def bad_render(block=False):
        calls.append(1)
        raise boom

    r.render = bad_render
    with pytest.raises(ValueError) as ei:
        loop.step()
    assert ei.value is boom and len(calls) == 1 and not loop.running


def test_lost_device_resets_resizes_retries_then_reraises_original():
    r = tiny_renderer()
    loop = FrameLoop(r)
    first = RuntimeError("CUDA error: unspecified launch failure")
    calls, resets = [], []
    real_reset = r.reset_device

    def reset():
        resets.append(1)
        real_reset()

    def flaky_render(block=False):
        calls.append(1)
        raise first if len(calls) == 1 else RuntimeError(
            "CUDA error: unspecified launch failure (again)")

    r.render, r.reset_device = flaky_render, reset
    with pytest.raises(RuntimeError) as ei:
        loop.step()
    assert ei.value is first and len(calls) == 2 and len(resets) == 1


def test_lost_device_recovers_on_the_device():
    """A lost frame whose retry succeeds is presented; the data stays on
    the Renderer's device."""
    r = tiny_renderer()
    loop = FrameLoop(r, pipeline=False)
    real = r.render
    calls = []

    def once_lost(block=False):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("closest_hit: CUDA error 719 at launch")
        return real(block)

    r.render = once_lost
    img = loop.step()
    assert img.shape == (32, 32, 3) and len(calls) == 2
    assert r.data.tri_p0.device == r.device


def raiser(exc):
    def render(block=False):
        raise exc
    return render


def test_timeout_skips_the_frame_and_oom_stops():
    r = tiny_renderer()
    loop = FrameLoop(r)
    loop.step()  # frame 0 in flight
    r.render = raiser(RuntimeError(
        "CUDA error: the launch timed out and was terminated"))
    assert loop.step() is not None  # frame 0 presented, nothing queued
    assert loop.flush() is None
    r.render = raiser(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    loop.running = True
    with pytest.raises(torch.cuda.OutOfMemoryError):
        loop.step()
    assert not loop.running


# ---------------------------------------------------------------------------
# the HTTP shell
# ---------------------------------------------------------------------------

def test_server_endpoints():
    from rust_wgpu_raytracing_tpu_torch.runtime.server import RenderServer

    r = tiny_renderer()
    loop = FrameLoop(r)
    srv = RenderServer(loop, port=0)
    srv.serve_async()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        with pytest.raises(urllib.error.HTTPError):  # no frame yet: 503
            urllib.request.urlopen(base + "/frame.png", timeout=10)
        loop.run(n_frames=2)
        page = urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"rust_wgpu_raytracing_tpu_torch" in page
        png = urllib.request.urlopen(base + "/frame.png", timeout=10).read()
        assert png[:4] == b"\x89PNG"
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"rt_server_{os.getpid()}.png")
        with open(path, "wb") as fh:
            fh.write(png)
        np.testing.assert_array_equal(read_png(path), srv.latest)
        os.remove(path)
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=10).read())
        assert stats["frames_rendered"] == 2 and stats["size"] == [32, 32]
        assert urllib.request.urlopen(base + "/key?k=arrowup&p=1",
                                      timeout=10).read() == b"ok"
        ev = loop.events.get_nowait()
        assert (ev.key, ev.pressed) == ("up", True)
        with urllib.request.urlopen(base + "/stream", timeout=10) as s:
            assert s.headers["Content-Type"].startswith(
                "multipart/x-mixed-replace")
            head = s.read(64)
            assert head.startswith(b"--frame\r\nContent-Type: image/png")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nothing", timeout=10)
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# the window shell
# ---------------------------------------------------------------------------

def test_image_to_ppm_roundtrip():
    from rust_wgpu_raytracing_tpu_torch.runtime.window import image_to_ppm

    img = (np.arange(2 * 3 * 3) % 256).astype(np.uint8).reshape(2, 3, 3)
    header, dims, maxv, pixels = image_to_ppm(img).split(b"\n", 3)
    assert (header, dims, maxv) == (b"P6", b"3 2", b"255")
    np.testing.assert_array_equal(
        np.frombuffer(pixels, np.uint8).reshape(2, 3, 3), img)


def test_keysym_map_covers_reference_keys():
    from rust_wgpu_raytracing_tpu_torch.runtime.window import KEYSYM_MAP

    assert set(KEYSYM_MAP.values()) == {
        "w", "a", "s", "d", "up", "down", "left", "right", "space",
        "lshift"}


def test_window_without_display_raises(monkeypatch):
    import rust_wgpu_raytracing_tpu_torch.runtime.window as win

    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(RuntimeError, match="no display"):
        win.Window(tiny_renderer())


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    r = tiny_renderer()
    r.controller.process_key("d", True)
    r.update()
    r.render()
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, r)
    r2 = load_checkpoint(p, device="cpu")
    np.testing.assert_array_equal(r2.camera.eye, r.camera.eye)
    assert r2.controller.keys.right and r2.frame_count == r.frame_count
    c1, _ = r.render()
    c2, _ = r2.render()
    assert torch.equal(c1, c2)


def test_checkpoint_non_npz_path_round_trips(tmp_path):
    r = tiny_renderer()
    r.render(block=True)
    p = str(tmp_path / "run.ckpt")
    save_checkpoint(p, r)
    assert os.path.exists(p)
    assert load_checkpoint(p, device="cpu").frame_count == r.frame_count


def test_progressive_terminates_at_pt_spp():
    r = Renderer(pt_scene(3), device="cpu")
    for _ in range(3):
        r.render()
    assert r.spp_done == 3 and r.pt_converged
    c3, _ = r.render()
    c4, _ = r.render()
    assert r.spp_done == 3 and torch.equal(c3, c4)


def test_progressive_resume_equals_uninterrupted(tmp_path):
    """Checkpoint at 2 spp, resume, finish to 4: bit for bit the
    uninterrupted run."""
    ra = Renderer(pt_scene(4), device="cpu")
    for _ in range(4):
        c_full, _ = ra.render()
    rb = Renderer(pt_scene(4), device="cpu")
    rb.render()
    rb.render()
    p = str(tmp_path / "pt_mid.npz")
    save_checkpoint(p, rb)
    rc = load_checkpoint(p, device="cpu")
    assert rc.spp_done == 2
    rc.render()
    c_resumed, _ = rc.render()
    assert rc.spp_done == 4 and torch.equal(c_full, c_resumed)


def jax_checkpoint_reference(out, port_ckpt, jax_ckpt):
    """Load the port's checkpoint in the JAX package, and write one."""
    from rust_wgpu_raytracing_tpu import config as jcfg
    from rust_wgpu_raytracing_tpu.io.checkpoint import (load_checkpoint as
                                                        jload,
                                                        save_checkpoint as
                                                        jsave)
    from rust_wgpu_raytracing_tpu.runtime.renderer import Renderer as JR

    r = jload(port_ckpt, backend="oracle")
    res = {"from_port.eye": r.camera.eye, "from_port.spp": r.spp_done,
           "from_port.frames": r.frame_count,
           "from_port.config": r.config.to_json(),
           "from_port.right": r.controller.keys.right,
           "from_port.accum": np.asarray(r._accum)}
    cfg = jcfg.SceneConfig.from_json(pt_scene(4).to_json())
    j = JR(cfg, backend="oracle")
    j.controller.process_key("a", True)
    j.update()
    j.render()
    j.render()
    jsave(jax_ckpt, j)
    res.update({"jax.eye": j.camera.eye, "jax.spp": j.spp_done,
                "jax.frames": j.frame_count, "jax.config": j.config.to_json(),
                "jax.accum": np.asarray(j._accum)})
    np.savez(out, **res)


def test_checkpoint_carries_between_packages(tmp_path):
    """A checkpoint of a progressive path trace written by either package
    resumes in the other: the same config, camera, key flags, frame count
    and spp, and the accumulation buffer bit for bit."""
    rp = Renderer(pt_scene(4), device="cpu")
    rp.controller.process_key("d", True)
    rp.update()
    rp.render()
    port_ckpt, jax_ckpt = str(tmp_path / "port.npz"), str(tmp_path / "j.npz")
    save_checkpoint(port_ckpt, rp)
    ref = jax_reference("test_torch_runtime", "jax_checkpoint_reference",
                        tmp_path, port_ckpt=port_ckpt, jax_ckpt=jax_ckpt)
    np.testing.assert_array_equal(ref["from_port.eye"], rp.camera.eye)
    assert int(ref["from_port.spp"]) == 1 and bool(ref["from_port.right"])
    assert int(ref["from_port.frames"]) == rp.frame_count
    assert str(ref["from_port.config"]) == rp.config.to_json()
    np.testing.assert_array_equal(ref["from_port.accum"], rp._accum.numpy())

    r = load_checkpoint(jax_ckpt, device="cpu")
    assert r.config.to_json() == str(ref["jax.config"])
    np.testing.assert_array_equal(r.camera.eye, ref["jax.eye"])
    assert r.spp_done == int(ref["jax.spp"]) == 2
    assert r.frame_count == int(ref["jax.frames"]) and r.controller.keys.left
    np.testing.assert_array_equal(r._accum.numpy(), ref["jax.accum"])
    r.render()
    assert r.spp_done == 3


# ---------------------------------------------------------------------------
# device limits (tests/test_limits.py)
# ---------------------------------------------------------------------------

def sphere_only_scene(w=600, h=600):
    return SceneConfig(
        spheres=(SphereConfig(center=(0.6, 0.5, -4.0), radius=0.4),),
        render=RenderConfig(width=w, height=h))


def test_wasm_limits_exact_reference_values():
    lm = L.build_wasm_limits()
    assert lm.max_uniform_buffers_per_shader_stage == 11
    assert lm.max_storage_buffers_per_shader_stage == 0
    assert lm.max_storage_textures_per_shader_stage == 0
    assert lm.max_compute_workgroups_per_dimension == 0
    assert lm.max_storage_buffer_binding_size == 0
    assert lm.max_vertex_buffer_array_stride == 255
    assert lm.max_texture_dimension_2d == 4096
    assert lm.max_uniform_buffer_binding_size == 16 << 10
    assert lm.max_buffer_size == 1 << 28


def test_limits_equal_the_jax_packages():
    from rust_wgpu_raytracing_tpu.runtime import limits as JL

    for name in ("build_wasm_limits", "default_limits"):
        assert dc.asdict(getattr(L, name)()) == dc.asdict(
            getattr(JL, name)())
    for cfg in (reference_scene(), sphere_only_scene(),
                reference_scene(7680, 4320)):
        from rust_wgpu_raytracing_tpu import config as jcfg

        jc = jcfg.SceneConfig.from_json(cfg.to_json())
        for lm, jlm in ((L.build_wasm_limits(), JL.build_wasm_limits()),
                        (L.default_limits(), JL.default_limits())):
            assert L.validate_limits(cfg, lm) == JL.validate_limits(jc, jlm)


def test_reference_scene_fails_under_wasm_limits():
    bad = L.validate_limits(reference_scene(), L.build_wasm_limits())
    assert any("storage buffers" in b for b in bad)
    assert any("storage textures" in b for b in bad)
    assert any("dispatch" in b for b in bad)
    bad = L.validate_limits(sphere_only_scene(), L.build_wasm_limits())
    assert any("storage textures" in b for b in bad)
    assert not any("storage buffers" in b for b in bad)


def test_native_defaults_and_texture_dimension():
    assert L.validate_limits(reference_scene(), L.default_limits()) == []
    assert L.validate_limits(sphere_only_scene(), L.default_limits()) == []
    cfg = reference_scene(7680, 4320)
    assert any("framebuffer" in b for b in L.validate_limits(
        cfg, L.build_wasm_limits()))
    assert L.validate_limits(cfg, L.default_limits()) == []


def test_renderer_refuses_invalid_limits():
    cfg = dc.replace(reference_scene(64, 64), meshes=(dc.replace(
        reference_scene().meshes[0], obj_path="builtin:cube"),))
    with pytest.raises(ValueError, match="does not validate"):
        Renderer(cfg, device="cpu", limits=L.build_wasm_limits())
    r = Renderer(cfg, device="cpu", limits=L.default_limits())
    assert r.render()[0].shape == (64, 64, 3)


# ---------------------------------------------------------------------------
# logging and the CLI
# ---------------------------------------------------------------------------

def test_log_frame_stats(monkeypatch, caplog):
    import logging

    from rust_wgpu_raytracing_tpu_torch.utils import (get_logger,
                                                      log_frame_stats)

    log = get_logger("rwrt.test")
    monkeypatch.setenv("RWRT_LOG_JSON", "1")
    with caplog.at_level(logging.INFO, logger="rwrt.test"):
        log_frame_stats(log, frame=1, frame_ms=16.0, width=64, height=64,
                        device="cpu")
    stats = json.loads(caplog.records[-1].getMessage())
    assert stats["frame"] == 1 and stats["size"] == [64, 64]
    assert stats["mrays_per_s"] == round(64 * 64 / 16.0 / 1e3, 1)
    assert stats["device"] == "cpu"


def write_scene(tmp_path):
    p = tmp_path / "scene.json"
    p.write_text(dc.replace(sphere_scene(), meshes=(MeshConfig(
        obj_path="builtin:cube", translation=(0.3, 0.0, -3.0),
        scale=0.5),)).to_json())
    return str(p)


def test_cli_headless_renders_and_saves(tmp_path, capsys):
    from rust_wgpu_raytracing_tpu_torch.__main__ import main

    out = tmp_path / "frame.png"
    assert main(["--shell", "headless", "--scene", write_scene(tmp_path),
                 "--frames", "2", "--width", "40", "--height", "24",
                 "--device", "cpu", "--out", str(out)]) == 0
    assert read_png(str(out)).shape == (24, 40, 3)
    assert "2 frames at 40x24 on cpu" in capsys.readouterr().out


def test_cli_server_shell_serves_then_exits(tmp_path, capsys):
    from rust_wgpu_raytracing_tpu_torch.__main__ import main

    assert main(["--shell", "server", "--port", "0", "--scene",
                 write_scene(tmp_path), "--frames", "2", "--width", "16",
                 "--height", "16", "--device", "cpu"]) == 0
    assert "serving http://127.0.0.1:" in capsys.readouterr().out


def test_cli_shells_and_defaults(tmp_path, monkeypatch):
    from rust_wgpu_raytracing_tpu_torch.__main__ import build_parser, main

    args = build_parser().parse_args([])
    assert (args.shell, args.port, args.device, args.frames) == (
        "window", 8080, "cuda", None)
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--shell", "teapot"])
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(RuntimeError, match="no display"):
        main(["--scene", write_scene(tmp_path), "--width", "16",
              "--height", "16", "--device", "cpu"])
