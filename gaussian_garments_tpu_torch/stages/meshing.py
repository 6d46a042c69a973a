"""Stage-1 meshing: oriented normals → screened-Poisson indicator (FFT
solve) → SurfaceNets extraction → largest component → clustering remesh
(port of ``gaussian_garments_tpu/stages/meshing.py``).

Replaces the reference's external meshing dependencies (open3d
``create_from_point_cloud_poisson(depth=13)`` and pyacvd
``Clustering(...).cluster(8000)``, ``utils/initialisation_utils.py:144,165-170``).

Only the Poisson solve runs on the device: a 3-axis complex FFT over a dense
grid through ``torch.fft`` (cuFFT on the card), at complex64 as the JAX
package's ``jnp.fft`` computes it. Splatting, extraction and remeshing are the
JAX package's host numpy/scipy code, copied, so both packages give the same
meshes from the same indicator.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# normals
# ---------------------------------------------------------------------------

def estimate_normals(points: np.ndarray, k: int = 16) -> np.ndarray:
    """PCA normals from k-NN neighborhoods with MST-propagated orientation
    (the role of open3d ``estimate_normals`` in the reference)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree, breadth_first_order
    from scipy.spatial import cKDTree

    n = len(points)
    tree = cKDTree(points)
    dists, idx = tree.query(points, k=min(k, n))
    nbrs = points[idx]                                    # (N,k,3)
    centered = nbrs - nbrs.mean(axis=1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", centered, centered)
    _, vecs = np.linalg.eigh(cov)                         # ascending eigenvalues
    normals = vecs[:, :, 0]                               # smallest = normal

    # orientation: propagate a consistent sign along the Euclidean MST
    # (Hoppe et al. '92; open3d does the same internally)
    rows = np.repeat(np.arange(n), idx.shape[1] - 1)
    cols = idx[:, 1:].ravel()
    w = dists[:, 1:].ravel() + 1e-12
    g = coo_matrix((w, (rows, cols)), shape=(n, n))
    mst = minimum_spanning_tree(g)
    mst = mst + mst.T
    order, preds = breadth_first_order(mst, i_start=0, directed=False)
    for v in order[1:]:
        p = preds[v]
        if p >= 0 and np.dot(normals[v], normals[p]) < 0.0:
            normals[v] = -normals[v]
    # global flip: make normals point outward on average (scan of a person:
    # centroid is inside)
    outward = points - points.mean(axis=0)
    if np.sum(np.einsum("ni,ni->n", normals, outward)) < 0.0:
        normals = -normals
    return normals


# ---------------------------------------------------------------------------
# screened Poisson on a regular grid (FFT)
# ---------------------------------------------------------------------------

def _splat_trilinear(points01: np.ndarray, values: np.ndarray, res: int) -> np.ndarray:
    """Trilinear scatter of per-point vectors into a (C,res,res,res) grid."""
    c = values.shape[1]
    grid = np.zeros((c, res, res, res), np.float32)
    p = np.clip(points01 * (res - 1), 0.0, res - 1 - 1e-4)
    i0 = p.astype(np.int32)
    f = p - i0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wgt = (np.abs(1 - dx - f[:, 0]) * np.abs(1 - dy - f[:, 1])
                       * np.abs(1 - dz - f[:, 2])).astype(np.float32)
                ii = (i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz)
                for ch in range(c):
                    np.add.at(grid[ch], ii, wgt * values[:, ch].astype(np.float32))
    return grid


def _sample_trilinear(grid: np.ndarray, points01: np.ndarray) -> np.ndarray:
    res = grid.shape[0]
    p = np.clip(points01 * (res - 1), 0.0, res - 1 - 1e-4)
    i0 = p.astype(np.int32)
    f = p - i0
    out = np.zeros(len(p), np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                wgt = (np.abs(1 - dx - f[:, 0]) * np.abs(1 - dy - f[:, 1])
                       * np.abs(1 - dz - f[:, 2]))
                out += wgt * grid[i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz]
    return out


def poisson_indicator(points: np.ndarray, normals: np.ndarray, res: int = 192,
                      screening: float = 4.0, pad: float = 0.1, device=None,
                      split=None):
    """Solve (∇² − α)χ = ∇·V on a res³ grid by FFT diagonalization, the
    spectral solve on ``device`` (the card unless the caller passes
    ``device="cpu"``).

    V is the trilinearly-splatted oriented-normal field (Kazhdan's screened
    Poisson, spectral variant). Returns (chi grid, points in grid coords,
    iso value at the samples, (origin, scale)). ``split`` (a
    ``utils.logging.PhaseSplit``) times ``splat``, ``fft_solve`` (to χ on the
    host) and ``iso``.

    The derivative eigenvalues are built in float64 and cast to
    complex64/float32 on ``device``, as JAX casts them with x64 off: kept at
    128/64 bits they would promote the whole solve (twice the spectrum's
    memory, and another result).
    """
    import torch

    from gaussian_garments_tpu_torch import resolve_device
    from gaussian_garments_tpu_torch.utils.logging import phase

    device = resolve_device(device)
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    scale = (hi - lo).max() / (1.0 - 2 * pad)
    origin = (lo + hi) / 2 - scale / 2
    p01 = (points - origin) / scale

    with phase(split, "splat"):
        v = _splat_trilinear(p01, normals, res)           # (3,R,R,R)

    # spectral solve: derivative eigenvalues ik for the DFT basis
    k = np.fft.fftfreq(res) * 2.0 * np.pi * res           # integer-frequency ω
    ikx = (1j * k)[:, None, None]
    iky = (1j * k)[None, :, None]
    ikz = (1j * k)[None, None, :]
    lap = (ikx ** 2 + iky ** 2 + ikz ** 2).real - screening   # −|k|² − α

    with phase(split, "fft_solve"):
        c64 = lambda a: torch.as_tensor(a.astype(np.complex64), device=device)
        lap_t = torch.as_tensor(lap.astype(np.float32), device=device)
        vf = torch.fft.fftn(torch.as_tensor(v, device=device), dim=(1, 2, 3))
        div = c64(ikx) * vf[0] + c64(iky) * vf[1] + c64(ikz) * vf[2]
        del vf
        chi_f = torch.where(lap_t.abs() < 1e-9,
                            torch.zeros((), dtype=div.dtype, device=device), div / lap_t)
        del div
        # ∇χ = −V at the boundary for an indicator (χ=1 inside, V outward), so
        # the RHS is −∇·V: negate to make χ positive inside
        chi = (-torch.fft.ifftn(chi_f).real).cpu().numpy().astype(np.float32)

    with phase(split, "iso"):
        iso = float(np.mean(_sample_trilinear(chi, p01)))
    return chi, p01, iso, (origin, scale)


# ---------------------------------------------------------------------------
# SurfaceNets iso-surface extraction
# ---------------------------------------------------------------------------

def surface_nets(chi: np.ndarray, iso: float,
                 origin_scale=None) -> Tuple[np.ndarray, np.ndarray]:
    """Naive SurfaceNets: one vertex per sign-changing cell (centroid of edge
    crossings), one quad per sign-changing grid edge → two triangles.

    The template is remeshed afterwards, so SurfaceNets' slightly smoother
    (non-MC) geometry is fine — and it is ~10× simpler than marching cubes.
    """
    res = chi.shape[0]
    s = chi - iso

    # cell corner values: cells are (res-1)³, corner (i+di, j+dj, k+dk)
    def corner(di, dj, dk):
        return s[di:res - 1 + di, dj:res - 1 + dj, dk:res - 1 + dk]

    corners = [corner(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    pos_any = np.zeros(corners[0].shape, bool)
    neg_any = np.zeros(corners[0].shape, bool)
    for cv in corners:
        pos_any |= cv > 0
        neg_any |= cv <= 0
    active = pos_any & neg_any                            # sign-changing cells
    cell_idx = np.full(active.shape, -1, np.int64)
    ids = np.nonzero(active)
    cell_idx[ids] = np.arange(len(ids[0]))

    # vertex = centroid of the edge crossings of each active cell
    # (accumulate crossings over the 12 edges, vectorized per edge)
    acc = np.zeros((len(ids[0]), 3), np.float64)
    cnt = np.zeros(len(ids[0]), np.float64)
    corner_off = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
    edges = [(u, v) for ui, u in enumerate(corner_off) for v in corner_off
             if sum(abs(np.array(u) - np.array(v))) == 1 and u < v]
    base = np.stack([ids[0], ids[1], ids[2]], axis=1).astype(np.float64)
    for u, v in edges:
        su = s[ids[0] + u[0], ids[1] + u[1], ids[2] + u[2]]
        sv = s[ids[0] + v[0], ids[1] + v[1], ids[2] + v[2]]
        crossing = (su > 0) != (sv > 0)
        t = su / (su - sv + 1e-30)
        pt = base + np.array(u, np.float64) + t[:, None] * (np.array(v, np.float64) - np.array(u, np.float64))
        acc += np.where(crossing[:, None], pt, 0.0)
        cnt += crossing
    verts = acc / np.maximum(cnt, 1.0)[:, None]

    # quads: for each grid edge along axis a with a sign change, connect the
    # 4 cells sharing that edge; winding from the sign of the lower end
    faces = []
    for axis in range(3):
        sl_lo = [slice(1, res - 1)] * 3
        sl_lo[axis] = slice(0, res - 1)
        lo_v = s[tuple(sl_lo)]
        sl_hi = list(sl_lo)
        sl_hi[axis] = slice(1, res)
        hi_v = s[tuple(sl_hi)]
        change = (lo_v > 0) != (hi_v > 0)
        ii = np.nonzero(change)
        if len(ii[0]) == 0:
            continue
        # the edge at (i, j+1, k+1) for axis 0 touches cells
        # (i, j+dy, k+dz) for dy, dz in {0,1}²  (analogous per axis)
        # np.nonzero is 0-based within the slice: non-axis dims start at 1
        coord = [ii[0].copy(), ii[1].copy(), ii[2].copy()]
        for a2 in range(3):
            if a2 != axis:
                coord[a2] += 1
        o1, o2 = [a for a in range(3) if a != axis]

        def cell(d1, d2):
            cc = [coord[0].copy(), coord[1].copy(), coord[2].copy()]
            cc[o1] -= d1
            cc[o2] -= d2
            return cell_idx[cc[0], cc[1], cc[2]]

        q = np.stack([cell(1, 1), cell(0, 1), cell(0, 0), cell(1, 0)], axis=1)
        ok = (q >= 0).all(axis=1)
        q = q[ok]
        # outward winding for a positive-inside field
        flip = (lo_v[ii] <= 0)[ok]
        if axis == 1:  # (axis, o1, o2) = (1, 0, 2) is an odd permutation
            flip = ~flip
        q = np.where(flip[:, None], q[:, ::-1], q)
        faces.append(np.stack([q[:, 0], q[:, 1], q[:, 2]], axis=1))
        faces.append(np.stack([q[:, 0], q[:, 2], q[:, 3]], axis=1))
    faces = np.concatenate(faces, axis=0) if faces else np.zeros((0, 3), np.int64)

    if origin_scale is not None:
        origin, scale = origin_scale
        verts = verts / (res - 1) * scale + origin
    return verts.astype(np.float32), faces.astype(np.int64)


# ---------------------------------------------------------------------------
# largest connected component + clustering remesh
# ---------------------------------------------------------------------------

def largest_component(verts: np.ndarray, faces: np.ndarray):
    """Keep the largest vertex-connected component (the role of open3d
    ``cluster_connected_triangles`` at initialisation_utils.py:145)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    n = len(verts)
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    g = coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])), shape=(n, n))
    ncomp, labels = connected_components(g, directed=False)
    if ncomp <= 1:
        return verts, faces
    keep_label = np.bincount(labels, minlength=ncomp).argmax()
    keep_v = labels == keep_label
    remap = np.cumsum(keep_v) - 1
    keep_f = keep_v[faces].all(axis=1)
    return verts[keep_v], remap[faces[keep_f]]


def farthest_point_sampling(points: np.ndarray, k: int, seed: int = 0) -> np.ndarray:
    """Greedy FPS (uniform-ish site distribution — the CVT role of ACVD)."""
    n = len(points)
    k = min(k, n)
    rng = np.random.RandomState(seed)
    sites = np.empty(k, np.int64)
    sites[0] = rng.randint(n)
    d = np.linalg.norm(points - points[sites[0]], axis=1)
    for i in range(1, k):
        sites[i] = int(np.argmax(d))
        d = np.minimum(d, np.linalg.norm(points - points[sites[i]], axis=1))
    return sites


def cluster_remesh(verts: np.ndarray, faces: np.ndarray, target_faces: int = 8000,
                   seed: int = 0, split=None):
    """Uniform clustering remesh (the role of pyacvd at
    initialisation_utils.py:165-170): FPS sites → nearest-site vertex
    clustering → one output triangle per input triangle spanning 3 distinct
    clusters (deduplicated), vertices at cluster centroids. ``split`` (a
    ``utils.logging.PhaseSplit``) times the farthest-point sampling as
    ``fps``."""
    from scipy.spatial import cKDTree

    from gaussian_garments_tpu_torch.utils.logging import phase

    # Euler: closed mesh has F ≈ 2V; aim sites at target_faces/2 (FPS can
    # only return len(verts) sites — clamp so the centroid buffers match)
    n_sites = min(max(target_faces // 2 + 2, 4), len(verts))
    with phase(split, "fps"):
        sites = farthest_point_sampling(verts, n_sites, seed)
    tree = cKDTree(verts[sites])
    _, label = tree.query(verts)

    # centroids of clusters (empty clusters keep the site position)
    sums = np.zeros((n_sites, 3), np.float64)
    cnts = np.zeros(n_sites, np.float64)
    np.add.at(sums, label, verts)
    np.add.at(cnts, label, 1.0)
    centers = np.where(cnts[:, None] > 0, sums / np.maximum(cnts, 1)[:, None],
                       verts[sites])

    tri = label[faces]                                    # (F,3) cluster ids
    distinct = (tri[:, 0] != tri[:, 1]) & (tri[:, 1] != tri[:, 2]) & (tri[:, 0] != tri[:, 2])
    tri = tri[distinct]
    # dedupe by sorted id triple, keep first occurrence's winding
    key = np.sort(tri, axis=1)
    _, first = np.unique(key, axis=0, return_index=True)
    tri = tri[np.sort(first)]

    # drop unreferenced sites
    used = np.zeros(n_sites, bool)
    used[tri.ravel()] = True
    remap = np.cumsum(used) - 1
    return centers[used].astype(np.float32), remap[tri].astype(np.int64)


def reconstruct_mesh(points: np.ndarray, target_faces: int = 8000,
                     res: int = 192, screening: float = 4.0,
                     normals: np.ndarray | None = None, device=None):
    """Full native pipeline: points → template mesh (reference post_process
    meshing steps, initialisation_utils.py:144-170); the Poisson solve runs
    on ``device``."""
    if normals is None:
        normals = estimate_normals(points)
    chi, _, iso, origin_scale = poisson_indicator(points, normals, res=res,
                                                  screening=screening, device=device)
    verts, faces = surface_nets(chi, iso, origin_scale)
    if len(faces) == 0:
        raise RuntimeError("Poisson indicator produced no iso-surface; "
                           "check normal orientation / point density")
    verts, faces = largest_component(verts, faces)
    verts, faces = cluster_remesh(verts, faces, target_faces)
    # orient outward: positive signed volume (divergence theorem)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    vol = np.sum(np.einsum("ij,ij->i", v0, np.cross(v1, v2))) / 6.0
    if vol < 0:
        faces = faces[:, ::-1].copy()
    return verts, faces
