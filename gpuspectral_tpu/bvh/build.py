"""BVH construction: SAH leaf order + implicit binary tree over clusters.

This replaces what the Vulkan driver gave the reference in hardware
(`vkCmdBuildAccelerationStructuresKHR`, backend/vulkan/VulkanRays.cpp:6-86),
shaped for the packet traversal in bvh/traverse.py:

  * Triangles are ordered by a binned-SAH build (bvh/sah.py; a Morton
    centroid sort is the alternative) and grouped into fixed-size clusters
    of LEAF_SIZE slots.  A leaf hit tests a dense contiguous block of
    triangles, with no per-triangle gathers.
  * Above the clusters sits an implicit complete binary tree (node i's
    children are 2i+1 / 2i+2): no child pointers, no variable topology, and
    the whole node array is two dense (N,3) float arrays (min/max).
  * Build runs once at scene load in numpy (static scenes, like the
    reference's BLAS cache, renderer/Renderer.cpp:122-131).
"""

from __future__ import annotations

import dataclasses

import numpy as np

LEAF_SIZE = 16  # slots per leaf (sah mode: real leaves of <= this, padded)

# Slot-mode subtree cuts: maximal SAH subtrees of <= BIN_TARGET triangles,
# each occupying exactly BIN_TARGET slots (bvh/sah.sah_cuts), whose leaves
# are the fixed LEAF_SIZE-slot cuts of the subtree.
BIN_TARGET = 128

# Below this many triangles the sah build keeps the triangle arrays dense
# (fixed-size cuts of the SAH order, no -1 slots): small scenes are served by
# the brute-force megakernel whose loop bound is the REAL triangle count
# (integrator/mega.py MEGA_MAX_TRIS), and leaf-AABB tightness only pays on
# BVH-scale scenes.  Tests exercise slot mode by lowering this.
SLOT_DENSE_THRESHOLD = 2048


def morton_codes(centroids: np.ndarray, bbox_min, bbox_max) -> np.ndarray:
    """30-bit Morton codes (10 bits/axis) of points in the scene bbox."""
    extent = np.maximum(np.asarray(bbox_max) - np.asarray(bbox_min), 1e-12)
    q = (centroids - bbox_min) / extent
    q = np.clip((q * 1024.0).astype(np.uint32), 0, 1023).astype(np.uint64)

    def expand(v):
        v = (v | (v << np.uint64(16))) & np.uint64(0x030000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x0300F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x030C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x09249249)
        return v

    return (
        (expand(q[:, 0]) << np.uint64(2))
        | (expand(q[:, 1]) << np.uint64(1))
        | expand(q[:, 2])
    ).astype(np.uint32)


@dataclasses.dataclass(frozen=True)
class BVH:
    """Host-side build result (device packing happens in SceneData)."""

    node_min: np.ndarray  # (2C-1, 3) implicit-tree AABB minima
    node_max: np.ndarray  # (2C-1, 3)
    # slot -> original tri id; -1 marks an empty padding slot (sah mode pads
    # every variable-size leaf to exactly leaf_size slots).  Length is
    # C*leaf_size in sah mode, T in morton mode (no -1 entries there).
    perm: np.ndarray
    n_clusters: int  # C (power of two)
    n_clusters_real: int  # leaves actually holding triangles (<= C)
    leaf_size: int
    n_levels: int  # tree depth (root = level 0)


def build_bvh(
    tri_pos: np.ndarray,
    num_tris: int,
    leaf_size: int = LEAF_SIZE,
    order: str = "sah",
    bin_target: int = BIN_TARGET,
) -> BVH:
    """tri_pos: (T,3,3) padded triangle array; only the first num_tris are
    real.  Returns the BVH plus the permutation that must be applied to all
    per-triangle scene arrays (pad triangles sort to the end).

    order: "sah" (binned-SAH DFS preorder, bvh/sah.py — default) or
    "morton" (classic LBVH centroid sort).
    """
    t_total = tri_pos.shape[0]
    real = tri_pos[:num_tris]
    if num_tris == 0:
        c = 1
        return BVH(
            node_min=np.full((1, 3), np.inf, np.float32),
            node_max=np.full((1, 3), -np.inf, np.float32),
            perm=np.arange(t_total),
            n_clusters=1,
            n_clusters_real=1,
            leaf_size=leaf_size,
            n_levels=1,
        )

    if order == "sah":
        # Real SAH leaves, slot-padded: each variable-size leaf (<= leaf_size
        # tris) occupies exactly leaf_size slots; unused slots carry -1 in the
        # permutation (scene packing gives them degenerate all-zero Woop rows
        # that can never hit).  Real leaves are tighter than fixed-size cuts
        # of the DFS order, which pays for the padding in culled nodes.
        from .sah import sah_cuts

        tri_order, _lsizes, bsizes = sah_cuts(
            real, num_tris, leaf_target=leaf_size, bin_target=bin_target
        )
        if num_tris <= SLOT_DENSE_THRESHOLD:
            # dense mode: fixed cuts of the SAH order, original array length
            perm = np.concatenate([tri_order, np.arange(num_tris, t_total)])
            n_clusters_real = -(-num_tris // leaf_size)
            n_clusters = 1 << int(np.ceil(np.log2(max(1, n_clusters_real))))
            sorted_tris = real[tri_order]
            cluster_min = np.full((n_clusters, 3), np.inf, np.float32)
            cluster_max = np.full((n_clusters, 3), -np.inf, np.float32)
            for c in range(n_clusters_real):
                chunk = sorted_tris[c * leaf_size : (c + 1) * leaf_size]
                cluster_min[c] = chunk.min(axis=(0, 1))
                cluster_max[c] = chunk.max(axis=(0, 1))
        else:
            # slot mode: subtree-cut bins are the primary layout.  Bin b owns
            # slots [b*BIN_TARGET, (b+1)*BIN_TARGET): its triangles (a real
            # SAH subtree, <= BIN_TARGET of them) sit contiguously at the bin
            # start, -1 padding after.  Leaves are the fixed leaf_size-slot
            # cuts of each bin (8 per bin at the defaults) — fixed cuts are
            # only mildly loose *within* a <= BIN_TARGET-tri subtree.
            n_bins = len(bsizes)
            leaves_per_bin = bin_target // leaf_size
            n_clusters_real = n_bins * leaves_per_bin
            n_clusters = 1 << int(np.ceil(np.log2(max(1, n_clusters_real))))
            perm = np.full(n_clusters * leaf_size, -1, np.int64)
            starts = np.concatenate([[0], np.cumsum(bsizes)])
            for bi in range(n_bins):
                s0, s1 = starts[bi], starts[bi + 1]
                perm[bi * bin_target : bi * bin_target + (s1 - s0)] = (
                    tri_order[s0:s1]
                )

            cluster_min = np.full((n_clusters, 3), np.inf, np.float32)
            cluster_max = np.full((n_clusters, 3), -np.inf, np.float32)
            for c in range(n_clusters_real):
                ids = perm[c * leaf_size : (c + 1) * leaf_size]
                ids = ids[ids >= 0]
                if ids.size:
                    chunk = real[ids]
                    cluster_min[c] = chunk.min(axis=(0, 1))
                    cluster_max[c] = chunk.max(axis=(0, 1))
    else:
        centroids = real.mean(axis=1)
        bb_min = real.min(axis=(0, 1))
        bb_max = real.max(axis=(0, 1))
        codes = morton_codes(centroids, bb_min, bb_max)
        tri_order = np.argsort(codes, kind="stable")

        # full permutation: sorted real triangles first, padding after
        perm = np.concatenate([tri_order, np.arange(num_tris, t_total)])

        n_clusters_real = -(-num_tris // leaf_size)
        n_clusters = 1 << int(np.ceil(np.log2(max(1, n_clusters_real))))

        # per-cluster AABBs over the *sorted* triangle order; empty/pad
        # clusters get inverted boxes that fail every slab test
        sorted_tris = real[tri_order]
        cluster_min = np.full((n_clusters, 3), np.inf, np.float32)
        cluster_max = np.full((n_clusters, 3), -np.inf, np.float32)
        for c in range(n_clusters_real):
            chunk = sorted_tris[c * leaf_size : (c + 1) * leaf_size]
            cluster_min[c] = chunk.min(axis=(0, 1))
            cluster_max[c] = chunk.max(axis=(0, 1))

    # implicit complete binary tree: leaves at [n_clusters-1, 2*n_clusters-1)
    n_nodes = 2 * n_clusters - 1
    node_min = np.full((n_nodes, 3), np.inf, np.float32)
    node_max = np.full((n_nodes, 3), -np.inf, np.float32)
    node_min[n_clusters - 1 :] = cluster_min
    node_max[n_clusters - 1 :] = cluster_max
    for i in range(n_clusters - 2, -1, -1):
        node_min[i] = np.minimum(node_min[2 * i + 1], node_min[2 * i + 2])
        node_max[i] = np.maximum(node_max[2 * i + 1], node_max[2 * i + 2])

    return BVH(
        node_min=node_min,
        node_max=node_max,
        perm=perm,
        n_clusters=n_clusters,
        n_clusters_real=n_clusters_real,
        leaf_size=leaf_size,
        n_levels=int(np.log2(n_clusters)) + 1,
    )
