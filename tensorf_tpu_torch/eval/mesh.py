"""Mesh export: dense alpha grid -> iso-surface -> binary PLY (a copy of
tensorf_tpu/eval/mesh.py).

Iso-surface extraction runs on the host in the native marching-tetrahedra
library (csrc/marching.cpp, built with g++ into the package's build
directory at first use, utils/cuda_build.py) and only when that build or
load fails in the pure-numpy version of the same 6-tet decomposition, with
a printed notice.  ``native_available`` says which of the two runs.  The
vertex transform is the reference's: vertices in grid-index space scaled
by the per-axis voxel size and offset by bbox[0].
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np

from ..utils.cuda_build import load_library

# the native library once loaded; False once its build or load failed
_LIB = None


def _load_native() -> Optional[ctypes.CDLL]:
    global _LIB
    if _LIB is None:
        try:
            lib = load_library("marching")
        except (OSError, RuntimeError) as e:  # no compiler, a failed build or load
            print(f"[mesh] native extension unavailable ({e}); numpy fallback")
            _LIB = False
            return None
        lib.mt_count.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mt_count.restype = ctypes.c_int
        lib.mt_extract.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mt_extract.restype = ctypes.c_int
        _LIB = lib
    return _LIB or None


def native_available() -> bool:
    """True when ``marching_iso_surface`` runs the native library (built
    and loaded here on first call), False when it runs the numpy version."""
    return _load_native() is not None


# 6-tetrahedra cube decomposition (must match marching.cpp).
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 3, 6],
        [0, 3, 2, 6],
        [0, 2, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ]
)


def _marching_tetrahedra_numpy(grid: np.ndarray, level: float):
    """Vectorized marching tetrahedra; returns (verts (V,3) in grid-index
    coordinates, tris (T,3))."""
    nx, ny, nz = grid.shape
    flat = grid.reshape(-1).astype(np.float64)

    def gid(i, j, k):
        return (i * ny + j) * nz + k

    # cell corner index arrays
    i, j, k = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
    )
    base = np.stack([i.ravel(), j.ravel(), k.ravel()], axis=-1)  # (C, 3)
    corners = np.array(
        [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)]
    )  # (8, 3)
    corner_idx = (
        gid(
            base[:, None, 0] + corners[None, :, 0],
            base[:, None, 1] + corners[None, :, 1],
            base[:, None, 2] + corners[None, :, 2],
        )
    )  # (C, 8)
    corner_val = flat[corner_idx]
    crossed = (corner_val > level).any(1) & (corner_val <= level).any(1)
    corner_idx = corner_idx[crossed]
    corner_val = corner_val[crossed]

    # per-tet processing
    edge_a, edge_b = [], []  # global grid indices of crossing edges
    tri_edges = []  # (T, 3) indices into the edge list

    def add_edges(ga, gb):
        """Append edge endpoint arrays; returns their positions."""
        start = len(edge_a)
        edge_a.extend(ga.tolist())
        edge_b.extend(gb.tolist())
        return np.arange(start, start + len(ga))

    for tet in _TETS:
        tv = corner_val[:, tet]  # (C, 4)
        tg = corner_idx[:, tet]
        inside = tv > level
        n_in = inside.sum(1)

        for n, flip in ((1, False), (3, True)):
            sel = n_in == n
            if not sel.any():
                continue
            ins = inside[sel] if n == 1 else ~inside[sel]
            g = tg[sel]
            # the single inside (or outside) corner per row
            apex = g[np.arange(len(g)), ins.argmax(1)]
            others = g[~ins].reshape(len(g), 3)
            e0 = add_edges(apex, others[:, 0])
            e1 = add_edges(apex, others[:, 1])
            e2 = add_edges(apex, others[:, 2])
            if flip:
                tri_edges.append(np.stack([e0, e2, e1], -1))
            else:
                tri_edges.append(np.stack([e0, e1, e2], -1))

        sel = n_in == 2
        if sel.any():
            ins = inside[sel]
            g = tg[sel]
            order = np.argsort(~ins, axis=1, kind="stable")
            gs = np.take_along_axis(g, order, axis=1)  # in0, in1, out0, out1
            e00 = add_edges(gs[:, 0], gs[:, 2])
            e01 = add_edges(gs[:, 0], gs[:, 3])
            e10 = add_edges(gs[:, 1], gs[:, 2])
            e11 = add_edges(gs[:, 1], gs[:, 3])
            tri_edges.append(np.stack([e00, e10, e11], -1))
            tri_edges.append(np.stack([e00, e11, e01], -1))

    if not tri_edges:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)

    edge_a = np.asarray(edge_a, np.int64)
    edge_b = np.asarray(edge_b, np.int64)
    lo = np.minimum(edge_a, edge_b)
    hi = np.maximum(edge_a, edge_b)
    keys = lo * (nx * ny * nz) + hi
    uniq, inverse = np.unique(keys, return_inverse=True)
    u_lo = uniq // (nx * ny * nz)
    u_hi = uniq % (nx * ny * nz)

    def to_xyz(g):
        return np.stack([g // (ny * nz), (g // nz) % ny, g % nz], -1).astype(
            np.float64
        )

    va, vb = flat[u_lo], flat[u_hi]
    t = np.clip((level - va) / (vb - va), 0, 1)
    verts = to_xyz(u_lo) + t[:, None] * (to_xyz(u_hi) - to_xyz(u_lo))
    tris = inverse[np.concatenate(tri_edges, axis=0)]
    return verts, tris.astype(np.int64)


def marching_iso_surface(
    grid: np.ndarray, level: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the level-set mesh; native C++ unless its build failed."""
    grid = np.ascontiguousarray(grid, dtype=np.float32)
    lib = _load_native()
    if lib is not None:
        nv = ctypes.c_int64()
        nt = ctypes.c_int64()
        lib.mt_count(
            grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            *grid.shape,
            float(level),
            ctypes.byref(nv),
            ctypes.byref(nt),
        )
        verts = np.empty((nv.value, 3), np.float64)
        tris = np.empty((nt.value, 3), np.int64)
        lib.mt_extract(
            verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return verts, tris
    return _marching_tetrahedra_numpy(grid, level)


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray):
    """Binary little-endian PLY writer (replaces the plyfile dependency)."""
    with open(path, "wb") as f:
        header = (
            "ply\n"
            "format binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(tris)}\n"
            "property list uchar int vertex_indices\n"
            "end_header\n"
        )
        f.write(header.encode())
        f.write(verts.astype("<f4").tobytes())
        face_dtype = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
        faces = np.empty(len(tris), dtype=face_dtype)
        faces["n"] = 3
        faces["idx"] = tris.astype(np.int32)
        f.write(faces.tobytes())


class PlyMesh(NamedTuple):
    verts: np.ndarray  # (V, 3) float64 world-space points, as written
    tris: np.ndarray  # (T, 3) int64


def convert_alpha_samples_to_ply(
    alpha_grid: np.ndarray,
    ply_filename_out: str,
    bbox: np.ndarray,
    level: float = 0.005,
    offset=None,
    scale=None,
) -> PlyMesh:
    """Dense alpha grid -> mesh -> .ply (reference utils.py:139-205);
    returns the mesh written.

    Vertex transform matches the reference: grid-index coords scaled by the
    per-axis voxel size (bbox size / grid shape) plus bbox[0].
    """
    bbox = np.asarray(bbox, np.float64).reshape(2, 3)
    voxel_size = (bbox[1] - bbox[0]) / np.asarray(alpha_grid.shape)
    verts, tris = marching_iso_surface(np.asarray(alpha_grid), level)
    mesh_points = verts * voxel_size[None, :] + bbox[0][None, :]
    if scale is not None:
        mesh_points = mesh_points / scale
    if offset is not None:
        mesh_points = mesh_points - offset
    print(f"saving mesh to {ply_filename_out} "
          f"({len(verts)} verts, {len(tris)} faces)")
    write_ply(ply_filename_out, mesh_points, tris)
    return PlyMesh(mesh_points, tris)
