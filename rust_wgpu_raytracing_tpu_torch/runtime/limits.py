"""Device-limits validation — the wasm "downlevel limits" quirk.

Counterpart of the JAX package's runtime/limits.py (a copy: that module
imports no JAX, but the port imports nothing of the JAX package).

The reference requests a hand-rolled limits struct on wasm32
(`build_wasm_limits()`, src/lib.rs:136-170, selected at
src/lib.rs:287-297): zero storage buffers / storage textures / compute
workgroups per stage, 4096-texel 2D textures, 11 uniform buffers. Under
those limits its own TriangleList pipeline (2 read-only storage buffers
at bindings 5-6, triangle_list.rs:116-141) and even the sphere pipeline
(storage color+depth textures, sphere.rs:35-60) could NOT validate —
evidence the wasm build targeted the sphere-only milestone. wgpu
surfaces this at pipeline/bind-group creation; here it is this explicit
validator, run before a frame is rendered.

None of these limits bind the card (the kernels and PyTorch own the
memory layout), so the module (a) replicates the quirk with the
reference's exact limit values and (b) gives the runtime shells a real
validation surface: `Renderer(cfg, limits=build_wasm_limits())` refuses
exactly the scenes the reference's wasm build would have refused.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class DeviceLimits:
    """wgpu::Limits, the fields the reference sets (src/lib.rs:136-170)."""

    max_uniform_buffers_per_shader_stage: int
    max_storage_buffers_per_shader_stage: int
    max_storage_textures_per_shader_stage: int
    max_dynamic_storage_buffers_per_pipeline_layout: int
    max_storage_buffer_binding_size: int
    max_vertex_buffer_array_stride: int
    max_compute_workgroup_storage_size: int
    max_compute_invocations_per_workgroup: int
    max_compute_workgroup_size_x: int
    max_compute_workgroup_size_y: int
    max_compute_workgroup_size_z: int
    max_compute_workgroups_per_dimension: int
    max_texture_dimension_1d: int
    max_texture_dimension_2d: int
    max_texture_dimension_3d: int
    max_texture_array_layers: int
    max_bind_groups: int
    max_bindings_per_bind_group: int
    max_dynamic_uniform_buffers_per_pipeline_layout: int
    max_sampled_textures_per_shader_stage: int
    max_samplers_per_shader_stage: int
    max_uniform_buffer_binding_size: int
    max_vertex_buffers: int
    max_vertex_attributes: int
    max_push_constant_size: int
    min_uniform_buffer_offset_alignment: int
    min_storage_buffer_offset_alignment: int
    max_inter_stage_shader_components: int
    max_buffer_size: int


def build_wasm_limits() -> DeviceLimits:
    """The reference's exact wasm limits (src/lib.rs:136-170)."""
    return DeviceLimits(
        max_uniform_buffers_per_shader_stage=11,
        max_storage_buffers_per_shader_stage=0,
        max_storage_textures_per_shader_stage=0,
        max_dynamic_storage_buffers_per_pipeline_layout=0,
        max_storage_buffer_binding_size=0,
        max_vertex_buffer_array_stride=255,
        max_compute_workgroup_storage_size=0,
        max_compute_invocations_per_workgroup=0,
        max_compute_workgroup_size_x=0,
        max_compute_workgroup_size_y=0,
        max_compute_workgroup_size_z=0,
        max_compute_workgroups_per_dimension=0,
        max_texture_dimension_1d=4096,
        max_texture_dimension_2d=4096,
        max_texture_dimension_3d=256,
        max_texture_array_layers=256,
        max_bind_groups=4,
        max_bindings_per_bind_group=640,
        max_dynamic_uniform_buffers_per_pipeline_layout=8,
        max_sampled_textures_per_shader_stage=16,
        max_samplers_per_shader_stage=16,
        max_uniform_buffer_binding_size=16 << 10,
        max_vertex_buffers=8,
        max_vertex_attributes=16,
        max_push_constant_size=0,
        min_uniform_buffer_offset_alignment=256,
        min_storage_buffer_offset_alignment=256,
        max_inter_stage_shader_components=60,
        max_buffer_size=1 << 28,
    )


def default_limits() -> DeviceLimits:
    """wgpu::Limits::default() for the fields above — what the native
    build requests (src/lib.rs:292 `wgpu::Limits::default()`)."""
    return DeviceLimits(
        max_uniform_buffers_per_shader_stage=12,
        max_storage_buffers_per_shader_stage=8,
        max_storage_textures_per_shader_stage=4,
        max_dynamic_storage_buffers_per_pipeline_layout=4,
        max_storage_buffer_binding_size=128 << 20,
        max_vertex_buffer_array_stride=2048,
        max_compute_workgroup_storage_size=16384,
        max_compute_invocations_per_workgroup=256,
        max_compute_workgroup_size_x=256,
        max_compute_workgroup_size_y=256,
        max_compute_workgroup_size_z=64,
        max_compute_workgroups_per_dimension=65535,
        max_texture_dimension_1d=8192,
        max_texture_dimension_2d=8192,
        max_texture_dimension_3d=2048,
        max_texture_array_layers=256,
        max_bind_groups=4,
        max_bindings_per_bind_group=640,
        max_dynamic_uniform_buffers_per_pipeline_layout=8,
        max_sampled_textures_per_shader_stage=16,
        max_samplers_per_shader_stage=16,
        max_uniform_buffer_binding_size=64 << 10,
        max_vertex_buffers=8,
        max_vertex_attributes=16,
        max_push_constant_size=0,
        min_uniform_buffer_offset_alignment=256,
        min_storage_buffer_offset_alignment=256,
        max_inter_stage_shader_components=60,
        max_buffer_size=1 << 28,
    )


def validate_limits(config, limits: DeviceLimits) -> List[str]:
    """Validate a SceneConfig's pipelines against device limits, the
    way wgpu would at creation time. Returns human-readable violations
    (empty = everything validates).

    Checked against the reference's actual resource usage:
    - every compute pipeline dispatches (W, H, 1) workgroups of size 1
      (src/lib.rs:1113,1147,1183; @workgroup_size(1));
    - every kernel binds 1 color + 1 depth STORAGE texture and samples
      1 depth texture (sphere.rs:35-75);
    - the sphere pipeline binds 3 uniform buffers (camera/screen/
      sphere, sphere.rs:60-95);
    - the mesh pipeline adds 2 read-only STORAGE buffers (vertices +
      faces, triangle_list.rs:116-141), a material uniform and a
      diffuse sampled texture + sampler in a 2nd bind group
      (triangle_list.rs:167-188);
    - framebuffer + depth textures are W x H 2D textures
      (src/lib.rs:470-515).
    """
    rc = config.render
    out = []
    w, h = rc.width, rc.height

    def need(field, needed, what):
        have = getattr(limits, field)
        if needed > have:
            out.append(f"{what}: needs {field}={needed}, device allows "
                       f"{have}")

    # compute dispatch shape (one workgroup per pixel)
    need("max_compute_workgroups_per_dimension", max(w, h),
         "per-pixel dispatch")
    need("max_compute_invocations_per_workgroup", 1, "workgroup size 1")
    need("max_compute_workgroup_size_x", 1, "workgroup size 1")

    # framebuffer-sized storage/sampled textures
    need("max_texture_dimension_2d", max(w, h), "framebuffer texture")

    # kernel bind groups
    has_spheres = len(config.spheres) > 0
    has_mesh = len(config.meshes) > 0
    if has_spheres or has_mesh:
        need("max_storage_textures_per_shader_stage", 2,
             "color+depth storage textures")
        need("max_sampled_textures_per_shader_stage", 1,
             "depth_input sampled texture")
        need("max_uniform_buffers_per_shader_stage", 3,
             "camera/screen/object uniforms")
    if has_mesh:
        need("max_storage_buffers_per_shader_stage", 2,
             "mesh vertex+face storage buffers")
        # storage buffer sizes: ModelVertexSmall is 32 B, ModelFaceSmall
        # 16 B (model.rs:45-79) — conservative static bound from the
        # config alone is not knowable pre-load, so validate the
        # BINDING capability, and the loaded sizes when available
        if limits.max_storage_buffer_binding_size == 0:
            out.append("mesh storage buffers: "
                       "max_storage_buffer_binding_size=0")
        need("max_bind_groups", 2, "scene + texture bind groups")
        need("max_samplers_per_shader_stage", 1, "diffuse sampler")
    return out
