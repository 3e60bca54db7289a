"""SceneData: the device-side scene representation (a JAX pytree).

The reference keeps per-object meshes + instance transforms and re-uploads
instance/BSDF/light buffers every frame (renderer/PathTracer.cpp:58-93).  For
a static scene we bake everything once at build time:

  * all triangles pre-transformed to world space (positions by the object
    transform, shading normals by its inverse-transpose — the reference does
    this per hit in rayhit.rchit:679-688),
  * per-triangle material attributes gathered into dense arrays,
  * triangle lights extracted exactly as the loader does
    (engine/Loader.cpp:316-330): every triangle of an emitting object becomes
    a light with world-space vertices.

Triangle arrays are padded to multiples of 128 with degenerate triangles;
`num_tris` / `num_lights` stay static Python ints so shapes are jit-stable.

Design decision — no instance level (vs renderer/Scene.h:17-21's
RenderObject{transform, mesh, material} + per-frame TLAS rebuild,
renderer/PathTracer.cpp:10-19): the reference keeps instances because
Vulkan's TLAS gives per-instance transforms for free in hardware and its
scenes could animate; in practice its loader bakes one static scene and the
TLAS rebuild per frame is pure overhead.  Here an instance level would put
a per-hit 4x4 transform + a two-level traversal in the hot kernels and make
shapes dynamic with instance count.  Baking to world-space triangle soup at
load costs duplicated storage for shared meshes (none of the shipped scenes
share meshes) and requires a scene rebuild (~LBVH sort, <1 s) to move an
object — the right trade for static production rendering.  Animation support
would slot in here as a `tri_object` id array + per-object (4x4) transform
pytree leaf applied in `build_scene` under jit, leaving kernels unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..bsdf.table import BSDFTable, NUM_PARAMS

PAD_MULTIPLE = 128
TEX_RES = 256  # atlas resolution every texture is resampled to
# Padding triangles are zero-area points at the origin: their edge cross
# product is exactly 0, so Moller-Trumbore rejects them as parallel — they
# can never alias a real hit and never produce inf/nan intermediates.
_PAD_POS = 0.0


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CameraData:
    to_world: jax.Array  # (4,4) camera-to-world
    fov: jax.Array  # scalar, radians (vertical, as the reference uses it)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneData:
    # geometry (world space), padded to PAD_MULTIPLE
    tri_pos: jax.Array  # (T,3,3) float32
    tri_nrm: jax.Array  # (T,3,3) float32 per-corner shading normals
    tri_uv: jax.Array  # (T,3,2) float32
    # per-triangle material bindings
    tri_bsdf: jax.Array  # (T,) int32 row into bsdf tables
    tri_emission: jax.Array  # (T,3) float32
    tri_twofaced: jax.Array  # (T,) bool
    tri_light_idx: jax.Array  # (T,) int32 light row for emissive tris, else -1
    tri_woop: jax.Array  # (T,12) precomputed Woop transforms (ops/woop.py)
    # bsdf tables
    bsdf_kind: jax.Array  # (B,) int32
    bsdf_params: jax.Array  # (B,NUM_PARAMS) float32
    # textures: fixed-size atlas; bsdf_tex maps bsdf row -> texture (-1 none).
    # The reference parses texture refs but never binds them
    # (Loader.cpp:122-143, BSDF hasTexture fields unused); here they shade.
    textures: jax.Array  # (N_tex, TEX_RES, TEX_RES, 3) float32, linear
    bsdf_tex: jax.Array  # (B,) int32
    # lights, padded to >=1
    light_pos: jax.Array  # (L,3,3) float32 world-space vertices
    light_emission: jax.Array  # (L,3) float32 radiance
    # environment emitter (lat-long radiance map, evaluated on ray miss).
    # The reference stubs this (Scene.h:116-119 Envmap struct, never
    # evaluated: miss.rmiss returns nothing); here it shades.
    envmap: jax.Array  # (He,We,3) float32; (1,1,3) zeros when absent
    envmap_rot: jax.Array  # (3,3) world->envmap rotation
    # envmap importance sampling (integrator/envmap.py:sample_envmap):
    # flattened luminance*sin(theta) texel CDF + per-texel solid-angle pdf
    envmap_cdf: jax.Array  # (He*We,) float32, monotone, last == 1
    envmap_pdf: jax.Array  # (He,We) float32 pdf per steradian
    # power-proportional light selection (optional alternative to the
    # reference's uniform pick): prefix-sum CDF + per-light probability
    light_cdf: jax.Array  # (L,)
    light_prob: jax.Array  # (L,)
    # SAH BVH (bvh/build.py); triangle arrays above are stored in leaf order
    # so BVH prim ids == array indices
    bvh_node_min: jax.Array  # (2C-1,3)
    bvh_node_max: jax.Array  # (2C-1,3)
    camera: CameraData
    # static metadata
    num_tris: int = dataclasses.field(metadata=dict(static=True))
    num_lights: int = dataclasses.field(metadata=dict(static=True))
    bvh_clusters: int = dataclasses.field(metadata=dict(static=True))
    bvh_leaf_size: int = dataclasses.field(metadata=dict(static=True))
    bvh_levels: int = dataclasses.field(metadata=dict(static=True))
    # which BSDF kinds actually occur (static): the dispatch only computes
    # these branches — a scene-specialized integrator compile
    kinds_present: tuple = dataclasses.field(metadata=dict(static=True))
    has_textures: bool = dataclasses.field(metadata=dict(static=True))
    has_envmap: bool = dataclasses.field(metadata=dict(static=True))
    # whether any geometric (area) lights exist; distinguishes the real light
    # table from the single zero-radiance pad light (NEE strategy selection)
    has_area_lights: bool = dataclasses.field(metadata=dict(static=True))

    @property
    def padded_tris(self) -> int:
        return self.tri_pos.shape[0]

    def replace(self, **kw) -> "SceneData":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SceneBuilder:
    """Host-side accumulation of scene objects before device packing."""

    tri_pos: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_nrm: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_uv: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_bsdf: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_emission: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_twofaced: List[np.ndarray] = dataclasses.field(default_factory=list)
    tri_light_idx: List[np.ndarray] = dataclasses.field(default_factory=list)
    light_pos: List[np.ndarray] = dataclasses.field(default_factory=list)
    light_emission: List[np.ndarray] = dataclasses.field(default_factory=list)
    bsdfs: BSDFTable = dataclasses.field(default_factory=BSDFTable)
    textures: List[np.ndarray] = dataclasses.field(default_factory=list)
    bsdf_tex: List[int] = dataclasses.field(default_factory=list)
    cam_to_world: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    envmap_image: Optional[np.ndarray] = None  # (He,We,3) linear radiance
    envmap_to_world: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    cam_fov: float = np.pi / 2
    film_width: int = 512
    film_height: int = 512
    film_spp: int = 64
    max_depth: int = 50

    def add_bsdf(self, kind_row, texture: Optional[np.ndarray] = None) -> int:
        """texture: optional (TEX_RES, TEX_RES, 3) linear float32 modulating
        the bsdf's diffuse/reflectance color."""
        idx = self.bsdfs.add(kind_row)
        if texture is not None:
            self.textures.append(np.asarray(texture, np.float32))
            self.bsdf_tex.append(len(self.textures) - 1)
        else:
            self.bsdf_tex.append(-1)
        return idx

    def add_object(
        self,
        positions: np.ndarray,  # (N,3,3) object space
        normals: np.ndarray,  # (N,3,3)
        uvs: Optional[np.ndarray],  # (N,3,2)
        transform: np.ndarray,  # (4,4) object-to-world
        bsdf_index: int,
        emission=(0.0, 0.0, 0.0),
        twofaced: bool = False,
    ) -> None:
        n = positions.shape[0]
        if n == 0:
            return
        transform = np.asarray(transform, np.float32)
        pos_h = positions @ transform[:3, :3].T + transform[:3, 3]
        inv_t = np.linalg.inv(transform[:3, :3]).T.astype(np.float32)
        nrm = normals @ inv_t.T
        if uvs is None:
            uvs = np.zeros((n, 3, 2), np.float32)
        if np.linalg.det(transform[:3, :3]) < 0.0:
            # Mirrored transform: baked winding flips relative to the
            # inverse-transpose shading normals, so winding-derived geometric
            # normals (and one-sided area-emitter gating, which follows them
            # per rayhit.rchit:760) would point the wrong way.  Mitsuba
            # semantics (and the Tungsten ground truths) emit along the
            # transformed +n side; swapping two corners restores agreement.
            # The reference bakes no such correction (Loader.cpp:284-293) and
            # consequently renders staircase2's six mirrored lights dark —
            # a bug we do not reproduce.
            pos_h = pos_h[:, [0, 2, 1]]
            nrm = nrm[:, [0, 2, 1]]
            uvs = np.asarray(uvs)[:, [0, 2, 1]]
        emission = np.asarray(emission, np.float32)
        self.tri_pos.append(pos_h.astype(np.float32))
        self.tri_nrm.append(nrm.astype(np.float32))
        self.tri_uv.append(uvs.astype(np.float32))
        self.tri_bsdf.append(np.full((n,), bsdf_index, np.int32))
        self.tri_emission.append(np.broadcast_to(emission, (n, 3)).copy())
        self.tri_twofaced.append(np.full((n,), twofaced, bool))
        if np.any(emission > 0.0):
            # every emitting triangle becomes a light (Loader.cpp:316-330)
            base = sum(x.shape[0] for x in self.light_pos)
            self.tri_light_idx.append(np.arange(base, base + n, dtype=np.int32))
            self.light_pos.append(pos_h.astype(np.float32))
            self.light_emission.append(np.broadcast_to(emission, (n, 3)).copy())
        else:
            self.tri_light_idx.append(np.full((n,), -1, np.int32))

    def set_envmap(self, image: np.ndarray, to_world=None, scale: float = 1.0) -> None:
        """Environment emitter: lat-long radiance map (use a (1,1,3) image
        for Mitsuba's `constant` emitter)."""
        self.envmap_image = np.asarray(image, np.float32) * np.float32(scale)
        if to_world is not None:
            self.envmap_to_world = np.asarray(to_world, np.float32)

    def set_camera(self, to_world: np.ndarray, fov_radians: float) -> None:
        self.cam_to_world = np.asarray(to_world, np.float32)
        self.cam_fov = float(fov_radians)

    def build(self) -> SceneData:
        return build_scene(self)


def _pad_to(x: np.ndarray, n: int, fill: float = 0.0) -> np.ndarray:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    shape = (pad,) + x.shape[1:]
    return np.concatenate([x, np.full(shape, fill, x.dtype)], axis=0)


def build_scene(b: SceneBuilder) -> SceneData:
    if b.tri_pos:
        pos = np.concatenate(b.tri_pos)
        nrm = np.concatenate(b.tri_nrm)
        uv = np.concatenate(b.tri_uv)
        bsdf_idx = np.concatenate(b.tri_bsdf)
        emission = np.concatenate(b.tri_emission)
        twofaced = np.concatenate(b.tri_twofaced)
        light_idx = np.concatenate(b.tri_light_idx)
    else:
        pos = np.zeros((0, 3, 3), np.float32)
        nrm = np.zeros((0, 3, 3), np.float32)
        uv = np.zeros((0, 3, 2), np.float32)
        bsdf_idx = np.zeros((0,), np.int32)
        emission = np.zeros((0, 3), np.float32)
        twofaced = np.zeros((0,), bool)
        light_idx = np.zeros((0,), np.int32)

    num_tris = pos.shape[0]
    padded = max(PAD_MULTIPLE, -(-num_tris // PAD_MULTIPLE) * PAD_MULTIPLE)
    pos = _pad_to(pos, padded, _PAD_POS)
    nrm = _pad_to(nrm, padded, 0.0)
    uv = _pad_to(uv, padded, 0.0)
    bsdf_idx = _pad_to(bsdf_idx, padded, 0)
    emission = _pad_to(emission, padded, 0.0)
    twofaced = _pad_to(twofaced, padded, False)
    light_idx = _pad_to(light_idx, padded, -1)

    # SAH BVH build + reorder all per-triangle arrays into leaf-DFS order so
    # that BVH leaf slices are contiguous and prim ids stay canonical.  The
    # permutation is slot-based: every leaf owns exactly leaf_size slots and
    # unused slots (-1) become degenerate never-hit triangles, so leaf AABBs
    # stay as tight as the real SAH leaves (bvh/build.py).
    from ..bvh.build import build_bvh

    bvh = build_bvh(pos, num_tris)
    perm = bvh.perm
    slots = perm.shape[0]
    if slots % PAD_MULTIPLE:
        perm = np.concatenate(
            [perm, np.full(-slots % PAD_MULTIPLE, -1, perm.dtype)]
        )
    empty = perm < 0
    safe = np.maximum(perm, 0)
    pos, nrm, uv = pos[safe], nrm[safe], uv[safe]
    bsdf_idx, emission, twofaced = bsdf_idx[safe], emission[safe], twofaced[safe]
    light_idx = light_idx[safe]
    pos[empty] = _PAD_POS
    emission[empty] = 0.0
    light_idx[empty] = -1

    from ..ops.woop import woop_transform

    woop = woop_transform(pos)
    woop[empty] = 0.0  # degenerate: the unit-triangle test can never pass

    if b.light_pos:
        lpos = np.concatenate(b.light_pos)
        lemit = np.concatenate(b.light_emission)
    else:
        lpos = np.zeros((1, 3, 3), np.float32)
        lemit = np.zeros((1, 3), np.float32)
    num_lights = max(1, lpos.shape[0])
    lpos = _pad_to(lpos, num_lights, 0.0)
    lemit = _pad_to(lemit, num_lights, 0.0)

    # emitted power per light: luminance-ish weight * triangle area
    areas = 0.5 * np.linalg.norm(
        np.cross(lpos[:, 1] - lpos[:, 0], lpos[:, 2] - lpos[:, 0]), axis=-1
    )
    power = lemit.sum(-1) * areas
    total = power.sum()
    prob = power / total if total > 0 else np.full((num_lights,), 1.0 / num_lights)
    cdf = np.cumsum(prob).astype(np.float32)
    cdf[-1] = 1.0

    # envmap importance-sampling tables: flattened texel CDF weighted by
    # luminance * sin(theta) (the lat-long area element), plus the per-texel
    # solid-angle pdf used for NEE weights and BSDF-hit MIS
    if b.envmap_image is not None:
        em = np.asarray(b.envmap_image, np.float32)
        he, we = em.shape[0], em.shape[1]
        lum = em @ np.array([0.2126, 0.7152, 0.0722], np.float32)
        # exact texel solid angles: Omega = (2pi/W) * (cos th0 - cos th1);
        # the sampler (integrator/envmap.py) draws uniformly in solid angle
        # WITHIN the chosen texel (theta via cos inversion), so the sampled
        # density is exactly piecewise constant = p_texel / Omega_texel.
        # (A row-center sin(theta) approximation is ~2x biased on a 1x1
        # constant map and a few % on small maps.)
        th = np.pi * np.arange(he + 1, dtype=np.float64) / he
        omega_row = (2.0 * np.pi / we) * (np.cos(th[:-1]) - np.cos(th[1:]))
        wgt = (lum + 1e-10) * omega_row[:, None].astype(np.float32)
        p_texel = wgt / wgt.sum()
        env_cdf = np.cumsum(p_texel.ravel()).astype(np.float32)
        env_cdf[-1] = 1.0
        env_pdf = (p_texel / omega_row[:, None]).astype(np.float32)
    else:
        env_cdf = np.ones((1,), np.float32)
        env_pdf = np.ones((1, 1), np.float32)

    kinds, params = b.bsdfs.pack()
    if b.textures:
        tex_atlas = np.stack(b.textures).astype(np.float32)
    else:
        tex_atlas = np.zeros((1, 1, 1, 3), np.float32)
    bsdf_tex = np.asarray(
        (b.bsdf_tex + [-1])[: len(kinds)] if b.bsdf_tex else [-1] * len(kinds),
        np.int32,
    )
    if bsdf_tex.shape[0] < len(kinds):
        bsdf_tex = np.concatenate(
            [bsdf_tex, np.full((len(kinds) - bsdf_tex.shape[0],), -1, np.int32)]
        )

    return SceneData(
        tri_pos=jnp.asarray(pos),
        tri_nrm=jnp.asarray(nrm),
        tri_uv=jnp.asarray(uv),
        tri_bsdf=jnp.asarray(bsdf_idx),
        tri_emission=jnp.asarray(emission),
        tri_twofaced=jnp.asarray(twofaced),
        tri_light_idx=jnp.asarray(light_idx),
        tri_woop=jnp.asarray(woop),
        bsdf_kind=jnp.asarray(kinds),
        bsdf_params=jnp.asarray(params),
        textures=jnp.asarray(tex_atlas),
        bsdf_tex=jnp.asarray(bsdf_tex),
        light_pos=jnp.asarray(lpos),
        light_emission=jnp.asarray(lemit),
        envmap=jnp.asarray(
            b.envmap_image if b.envmap_image is not None
            else np.zeros((1, 1, 3), np.float32)
        ),
        envmap_rot=jnp.asarray(
            np.linalg.inv(b.envmap_to_world[:3, :3]).astype(np.float32)
        ),
        envmap_cdf=jnp.asarray(env_cdf),
        envmap_pdf=jnp.asarray(env_pdf),
        light_cdf=jnp.asarray(cdf),
        light_prob=jnp.asarray(prob.astype(np.float32)),
        bvh_node_min=jnp.asarray(bvh.node_min),
        bvh_node_max=jnp.asarray(bvh.node_max),
        camera=CameraData(
            to_world=jnp.asarray(b.cam_to_world, jnp.float32),
            fov=jnp.asarray(b.cam_fov, jnp.float32),
        ),
        num_tris=int(num_tris),
        num_lights=int(lpos.shape[0]) if b.light_pos else 1,
        bvh_clusters=bvh.n_clusters,
        bvh_leaf_size=bvh.leaf_size,
        bvh_levels=bvh.n_levels,
        kinds_present=tuple(sorted(set(int(k) for k in kinds))),
        has_textures=bool(b.textures),
        has_envmap=b.envmap_image is not None,
        has_area_lights=bool(b.light_pos),
    )
