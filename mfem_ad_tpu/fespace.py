"""Finite element spaces: global DOF numbering, boundary DOFs, projection.

The array-based replacement for MFEM's ``FiniteElementSpace``/``GridFunction``
pair (used throughout the reference, e.g. ex1.cpp:47-48, ex4.cpp:99-102):
a space is a set of *arrays* — an element-to-dof gather map ``edof
[n_elem, n_dof]``, canonical node coordinates ``node_coords [ndof, dim]`` and
boundary lookup tables — consumed by jitted batched assembly.

H1 continuity is established topologically (vertex/edge/face/interior dof
classes with orientation-canonical numbering), exactly as MFEM does
internally, so shared dofs match bitwise for any element orientation.

Vector spaces (vdim>1) use MFEM's byNODES ordering: global dof =
``component * ndof_scalar + scalar_dof`` (matches the reference's elfun
layout, src/ad_intg.hpp:223-229).
"""

from __future__ import annotations

import numpy as np

from .basis import lobatto_points, ref_element
from .mesh import Mesh
from .quadrature import CUBE, SEGMENT, SQUARE, TETRAHEDRON, TRIANGLE

H1 = "H1"
L2 = "L2"

# local edges as (corner, corner) index pairs into the lex corner ordering,
# and the lattice direction each runs along
_QUAD_EDGES = [(0, 1), (2, 3), (0, 2), (1, 3)]  # bottom, top, left, right
_TRI_EDGES = [(0, 1), (0, 2), (1, 2)]
_HEX_EDGES = [
    (0, 1), (2, 3), (4, 5), (6, 7),  # x-edges
    (0, 2), (1, 3), (4, 6), (5, 7),  # y-edges
    (0, 4), (1, 5), (2, 6), (3, 7),  # z-edges
]
_HEX_FACES = [
    (0, 1, 2, 3), (4, 5, 6, 7),  # z=0, z=1
    (0, 1, 4, 5), (2, 3, 6, 7),  # y=0, y=1
    (0, 2, 4, 6), (1, 3, 5, 7),  # x=0, x=1
]
_TET_EDGES = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
# triangular faces as corner triples (the barycentric coordinate that
# vanishes on each: k, j, i, lambda0 respectively)
_TET_FACES = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]


def _classify_tensor_nodes(geom: str, p: int):
    """Classify lex-ordered tensor nodes into vertex/edge/face/interior.

    Returns dict with per-node records; k-indices are lattice integers.
    """
    n1 = p + 1
    recs = []
    if geom == SQUARE:
        for node in range(n1 * n1):
            ix, iy = node % n1, node // n1
            onx = ix in (0, p)
            ony = iy in (0, p)
            if onx and ony:
                corner = (ix // p) + 2 * (iy // p)
                recs.append(("v", corner))
            elif ony:  # bottom/top edge, runs along x
                le = 0 if iy == 0 else 1
                recs.append(("e", le, ix))
            elif onx:  # left/right edge, runs along y
                le = 2 if ix == 0 else 3
                recs.append(("e", le, iy))
            else:
                recs.append(("i", (iy - 1) * (p - 1) + (ix - 1)))
    elif geom == CUBE:
        for node in range(n1**3):
            ix = node % n1
            iy = (node // n1) % n1
            iz = node // (n1 * n1)
            on = [c in (0, p) for c in (ix, iy, iz)]
            bits = (ix // p, iy // p, iz // p)
            if all(on):
                recs.append(("v", bits[0] + 2 * bits[1] + 4 * bits[2]))
            elif sum(on) == 2:
                if not on[0]:  # x-edge
                    le = bits[1] + 2 * bits[2]
                    recs.append(("e", le, ix))
                elif not on[1]:
                    le = 4 + bits[0] + 2 * bits[2]
                    recs.append(("e", le, iy))
                else:
                    le = 8 + bits[0] + 2 * bits[1]
                    recs.append(("e", le, iz))
            elif sum(on) == 1:
                if on[2]:  # z=const face: local axes (x, y)
                    lf = 0 + bits[2]
                    recs.append(("f", lf, ix, iy))
                elif on[1]:  # y=const face: local axes (x, z)
                    lf = 2 + bits[1]
                    recs.append(("f", lf, ix, iz))
                else:  # x=const face: local axes (y, z)
                    lf = 4 + bits[0]
                    recs.append(("f", lf, iy, iz))
            else:
                recs.append(
                    (
                        "i",
                        (iz - 1) * (p - 1) ** 2 + (iy - 1) * (p - 1) + (ix - 1),
                    )
                )
    elif geom == TRIANGLE:
        node = 0
        ii = 0
        for j in range(p + 1):
            for i in range(p + 1 - j):
                if (i, j) == (0, 0):
                    recs.append(("v", 0))
                elif (i, j) == (p, 0):
                    recs.append(("v", 1))
                elif (i, j) == (0, p):
                    recs.append(("v", 2))
                elif j == 0:
                    recs.append(("e", 0, i))
                elif i == 0:
                    recs.append(("e", 1, j))
                elif i + j == p:
                    recs.append(("e", 2, j))
                else:
                    recs.append(("i", ii))
                    ii += 1
                node += 1
    elif geom == TETRAHEDRON:
        # lattice (i, j, k), i+j+k <= p, loops k outer / j / i inner
        # (matching basis._tet_lattice); barycentrics
        # (l0, i, j, k) with l0 = p - i - j - k.
        ii = 0
        for k in range(p + 1):
            for j in range(p + 1 - k):
                for i in range(p + 1 - k - j):
                    l0 = p - i - j - k
                    nz = [(l0 > 0), (i > 0), (j > 0), (k > 0)]
                    n_nz = sum(nz)
                    if n_nz == 1:  # vertex
                        recs.append(("v", nz.index(True)))
                    elif n_nz == 2:  # edge interior
                        if j == 0 and k == 0:
                            recs.append(("e", 0, i))  # (0,1)
                        elif i == 0 and k == 0:
                            recs.append(("e", 1, j))  # (0,2)
                        elif i == 0 and j == 0:
                            recs.append(("e", 2, k))  # (0,3)
                        elif k == 0:
                            recs.append(("e", 3, j))  # (1,2), param along 1->2
                        elif j == 0:
                            recs.append(("e", 4, k))  # (1,3)
                        else:
                            recs.append(("e", 5, k))  # (2,3)
                    elif n_nz == 3:  # face interior: bary in local order
                        if k == 0:
                            recs.append(("f3", 0, (l0, i, j)))
                        elif j == 0:
                            recs.append(("f3", 1, (l0, i, k)))
                        elif i == 0:
                            recs.append(("f3", 2, (l0, j, k)))
                        else:  # l0 == 0
                            recs.append(("f3", 3, (i, j, k)))
                    else:
                        recs.append(("i", ii))
                        ii += 1
    else:
        raise ValueError(geom)
    return recs


def _tri_face_index(b1, b2, p):
    """Canonical index of a triangular-face interior node with
    barycentrics (p-b1-b2, b1, b2) w.r.t. the SORTED (ascending global
    id) face corners: enumeration b2 outer from 1, b1 inner from 1."""
    off = (b2 - 1) * (p - 1) - (b2 - 1) * b2 // 2
    return off + b1 - 1


def _reorder_enabled() -> bool:
    import os

    return os.environ.get("MFEM_AD_TPU_REORDER", "1") != "0"


def _edge_params(geom: str, p: int) -> np.ndarray:
    """Parameter t_k (k=0..p) along an edge for interior edge nodes."""
    if geom in (SQUARE, CUBE):
        return lobatto_points(p)
    return np.arange(p + 1, dtype=np.float64) / p  # triangle lattice


class FESpace:
    """Scalar-or-vector nodal FE space on a Mesh.

    Attributes:
        edof:        [n_elem, nd] int32 scalar-dof gather map.
        ndof_scalar: number of scalar dofs.
        node_coords: [ndof_scalar, dim] canonical dof coordinates.
        vdim:        vector dimension (byNODES global layout).
    """

    def __init__(self, mesh: Mesh, order: int, fe_type: str = H1, vdim: int = 1):
        if fe_type == H1 and order < 1:
            raise ValueError("H1 requires order >= 1")
        self.mesh = mesh
        self.order = order
        self.fe_type = fe_type
        self.vdim = vdim
        self.elem = ref_element(mesh.geom, order)
        self.nd = self.elem.ndof
        if fe_type == L2:
            self._build_l2()
        elif fe_type == H1:
            self._build_h1()
        else:
            raise ValueError(f"unknown fe_type {fe_type!r}")

    # ------------------------------------------------------------------
    @property
    def ndof(self) -> int:
        """Total dofs including vdim."""
        return self.ndof_scalar * self.vdim

    @property
    def num_elements(self) -> int:
        return self.mesh.num_elements

    def _geometry_node_coords(self) -> np.ndarray:
        """[ne, nd, dim] element-local node coords via the geometry map."""
        geo = ref_element(self.mesh.geom, 1)
        N = geo.eval(self.elem.nodes)  # [nd, ncorner]
        corners = self.mesh.corner_coords()  # [ne, nc, dim]
        return np.einsum("dc,eck->edk", N, corners, optimize=True)

    # ------------------------------------------------------------------
    def _build_l2(self):
        ne, nd = self.mesh.num_elements, self.nd
        self.edof = (
            np.arange(ne * nd, dtype=np.int64).reshape(ne, nd).astype(np.int32)
        )
        self.ndof_scalar = ne * nd
        self.node_coords = self._geometry_node_coords().reshape(-1, self.mesh.dim)
        self._edge_index = None
        self._face_index = None
        self._relabel = None
        # L2 dofs are element-contiguous by construction: the dof gather is
        # a pure reshape (no gather op) regardless of mesh structure.
        self.grid = ("l2",)

    # ------------------------------------------------------------------
    def _build_h1_structured(self) -> bool:
        """Direct lattice construction for structured quad/hex meshes.

        On a Cartesian mesh the H1 dof lattice IS the p-refined tensor
        grid, so the element-dof map and node coordinates are pure index
        arithmetic — no unique-edge/face enumeration, no orientation
        canonicalization, no relabel pass.  This is the multi-million-hex
        setup path (the reference inherits MFEM's C++ space builder,
        ex1.cpp:47); numbering is bit-identical to the topological path's
        lexicographic relabeling (tested).  Returns False when the mesh
        isn't a structured quad/hex (caller falls through).
        """
        mesh, p = self.mesh, self.order
        st = mesh.structured
        if st is None or mesh.geom not in (SQUARE, CUBE):
            return False
        t = lobatto_points(p)  # per-cell node params in [0, 1]
        n1 = p + 1

        def coords1d(n, s):
            c = (np.arange(n)[:, None] + t[None, :p]).reshape(-1) * (s / n)
            return np.concatenate([c, [s]])

        def axis_dofs(n):
            # [n, n1] lattice index i*p + k of local node k in cell i
            return (
                np.arange(n, dtype=np.int32)[:, None] * p
                + np.arange(n1, dtype=np.int32)[None, :]
            )

        if st[0] == "cart2d":
            _, nx, ny, sx, sy = st
            NX, NY = nx * p + 1, ny * p + 1
            self.ndof_scalar = NX * NY
            cx, cy = coords1d(nx, sx), coords1d(ny, sy)
            # dof id = gj*NX + gi (gj outer); element e = j*nx + i,
            # local node = iy*n1 + ix (lex, x fastest)
            X, Y = np.meshgrid(cx, cy, indexing="xy")  # [NY, NX]
            self.node_coords = np.stack([X.ravel(), Y.ravel()], axis=1)
            A = axis_dofs(nx)  # gi contribution [nx, n1]
            B = axis_dofs(ny) * np.int32(NX)  # gj*NX [ny, n1]
            # [ny(j), nx(i), n1(iy), n1(ix)]
            self.edof = (
                B[:, None, :, None] + A[None, :, None, :]
            ).reshape(ny * nx, n1 * n1)
            self.grid = ("h1", (nx, ny), (NY, NX))
            self._structured_lattice = ("2d", nx, ny, p, NX, NY)
        else:
            _, nx, ny, nz, sx, sy, sz = st
            NX, NY, NZ = nx * p + 1, ny * p + 1, nz * p + 1
            self.ndof_scalar = NX * NY * NZ
            cx, cy, cz = coords1d(nx, sx), coords1d(ny, sy), coords1d(nz, sz)
            # dof id = gi*(NY*NZ) + gj*NZ + gk (gk fastest); element
            # e = i*ny*nz + j*nz + k, local node = iz*n1^2 + iy*n1 + ix
            X, Y, Z = np.meshgrid(cx, cy, cz, indexing="ij")  # [NX, NY, NZ]
            self.node_coords = np.stack(
                [X.ravel(), Y.ravel(), Z.ravel()], axis=1
            )
            A = axis_dofs(nx) * np.int32(NY * NZ)  # (i, ix) [nx, n1]
            B = axis_dofs(ny) * np.int32(NZ)  # (j, iy) [ny, n1]
            C = axis_dofs(nz)  # (k, iz) [nz, n1]
            edof = (
                A[:, None, None, None, None, :]
                + B[None, :, None, None, :, None]
                + C[None, None, :, :, None, None]
            )  # [nx, ny, nz, iz, iy, ix]
            self.edof = edof.reshape(nx * ny * nz, n1 ** 3)
            self.grid = ("h1", (nx, ny, nz), (NX, NY, NZ))
            self._structured_lattice = ("3d", nx, ny, nz, p, NX, NY, NZ)
        self._relabel = None
        return True

    def _boundary_dofs_structured(self, bels: np.ndarray) -> np.ndarray:
        """Lattice-box boundary dofs for the structured direct path: each
        selected boundary face spans one (p+1)^(dim-1) lattice box whose
        origin comes from its corner vertex ids (original Cartesian vertex
        numbering, vid = i + j*(nx+1) [+ k*(nx+1)*(ny+1)])."""
        lat = self._structured_lattice
        p = self.order
        n1 = p + 1
        if lat[0] == "2d":
            _, nx, ny, p_, NX, NY = lat
            i = bels % (nx + 1)
            j = bels // (nx + 1)
            g = np.stack([i, j], axis=-1) * np.int64(p)  # [nb, 2, 2]
            gmin = g.min(axis=1)  # [nb, 2]
            vary_x = g[:, 0, 0] != g[:, 1, 0]  # segment runs along x
            base = gmin[:, 1] * NX + gmin[:, 0]
            stride = np.where(vary_x, 1, NX)
            ids = base[:, None] + stride[:, None] * np.arange(n1)[None, :]
            return np.unique(ids.ravel()).astype(np.int64)
        _, nx, ny, nz, p_, NX, NY, NZ = lat
        nvx, nvy = nx + 1, ny + 1
        i = bels % nvx
        j = (bels // nvx) % nvy
        k = bels // (nvx * nvy)
        g = np.stack([i, j, k], axis=-1) * np.int64(p)  # [nb, 4, 3]
        gmin, gmax = g.min(axis=1), g.max(axis=1)
        strides = np.array([NY * NZ, NZ, 1], dtype=np.int64)
        base = gmin @ strides
        out = []
        box = np.arange(n1)
        for const_ax in range(3):
            m = gmax[:, const_ax] == gmin[:, const_ax]
            if not m.any():
                continue
            ax1, ax2 = [a for a in range(3) if a != const_ax]
            ids = (
                base[m][:, None, None]
                + strides[ax1] * box[None, :, None]
                + strides[ax2] * box[None, None, :]
            )
            out.append(ids.ravel())
        if not out:  # attr_mask selected no boundary faces
            return np.empty(0, dtype=np.int64)
        return np.unique(np.concatenate(out))

    # ------------------------------------------------------------------
    def _build_h1(self):
        mesh, p = self.mesh, self.order
        if self._build_h1_structured():
            return
        ne, nv = mesh.num_elements, mesh.num_vertices
        geom = mesh.geom
        e = mesh.elements.astype(np.int64)

        if geom == SQUARE:
            ledges, lfaces = _QUAD_EDGES, []
        elif geom == TRIANGLE:
            ledges, lfaces = _TRI_EDGES, []
        elif geom == CUBE:
            ledges, lfaces = _HEX_EDGES, _HEX_FACES
        elif geom == TETRAHEDRON:
            ledges, lfaces = _TET_EDGES, _TET_FACES
        else:
            raise ValueError(geom)
        fw = len(lfaces[0]) if lfaces else 4  # face corner count (3 or 4)

        # ---- unique edges (sorted pairs) and faces (sorted tuples)
        el_edges = e[:, np.array(ledges)]  # [ne, nle, 2] one fancy gather
        flat_edges = np.sort(el_edges.reshape(-1, 2), axis=1)
        from .native import unique_rows as _native_unique

        uniq_edges, edge_inv = _native_unique(flat_edges)
        edge_inv = edge_inv.reshape(ne, len(ledges))
        n_edges = uniq_edges.shape[0]

        if lfaces:
            el_faces = e[:, np.array(lfaces)]  # [ne, nlf, fw]
            n_lf = len(lfaces)
        else:
            el_faces = np.zeros((ne, 0, fw), dtype=np.int64)
            n_lf = 0
        if n_lf:
            flat_faces = np.sort(el_faces.reshape(-1, fw), axis=1)
            uniq_faces, face_inv = _native_unique(flat_faces)
            face_inv = face_inv.reshape(ne, n_lf)
            n_faces = uniq_faces.shape[0]
        else:
            uniq_faces = np.zeros((0, fw), dtype=np.int64)
            face_inv = np.zeros((ne, 0), dtype=np.int64)
            n_faces = 0

        npe = p - 1  # dofs per edge
        # dofs per face: quad (p-1)^2, triangle (p-1)(p-2)/2
        npf = (p - 1) ** 2 if fw == 4 else (p - 1) * (p - 2) // 2
        recs = _classify_tensor_nodes(geom, p)
        n_int = sum(1 for r in recs if r[0] == "i")

        off_edge = nv
        off_face = off_edge + n_edges * npe
        off_int = off_face + n_faces * npf
        self.ndof_scalar = off_int + ne * n_int

        # ---- element dof map, orientation-canonical for edges/faces
        edof = np.empty((ne, self.nd), dtype=np.int64)
        tpar = _edge_params(geom, p)
        for li, rec in enumerate(recs):
            kind = rec[0]
            if kind == "v":
                edof[:, li] = e[:, rec[1]]
            elif kind == "e":
                le, k = rec[1], rec[2]
                a = e[:, ledges[le][0]]
                b = e[:, ledges[le][1]]
                # canonical orientation: along (min(a,b) -> max(a,b))
                kk = np.where(a < b, k, p - k)
                edof[:, li] = off_edge + edge_inv[:, le] * npe + (kk - 1)
            elif kind == "f":
                lf, ks, kt = rec[1], rec[2], rec[3]
                corners = el_faces[:, lf, :]  # local order [c00,c10,c01,c11]
                kks, kkt = _canonical_face_index(corners, ks, kt, p)
                edof[:, li] = (
                    off_face
                    + face_inv[:, lf] * npf
                    + (kkt - 1) * (p - 1)
                    + (kks - 1)
                )
            elif kind == "f3":
                # triangular face: barycentrics permute with the corners,
                # so the canonical index comes from sorting the global
                # corner ids ascending and permuting the node's local
                # barycentric triple the same way
                lf, bary = rec[1], np.array(rec[2], dtype=np.int64)
                g = el_faces[:, lf, :]  # [ne, 3] global ids, local order
                sigma = np.argsort(g, axis=1)  # canonical = ascending ids
                B = bary[sigma]  # [ne, 3] canonical barycentrics
                edof[:, li] = (
                    off_face
                    + face_inv[:, lf] * npf
                    + _tri_face_index(B[:, 1], B[:, 2], p)
                )
            else:
                edof[:, li] = off_int + np.arange(ne) * n_int + rec[1]
        self.edof = edof.astype(np.int32)

        # ---- canonical node coordinates per dof class
        V = mesh.vertices
        coords = np.empty((self.ndof_scalar, mesh.dim))
        coords[:nv] = V
        if npe > 0 and n_edges > 0:
            a = V[uniq_edges[:, 0]][:, None, :]  # [n_edges,1,dim]
            b = V[uniq_edges[:, 1]][:, None, :]
            t = tpar[1:p][None, :, None]
            coords[off_edge:off_face] = ((1.0 - t) * a + t * b).reshape(-1, mesh.dim)
        if npf > 0 and n_faces > 0:
            if fw == 3:
                # triangular faces: uniq rows are ascending = canonical;
                # enumeration b2 outer from 1, b1 inner (_tri_face_index)
                G0, G1, G2 = (V[uniq_faces[:, i]] for i in range(3))
                fc = np.empty((n_faces, npf, mesh.dim))
                pos = 0
                for b2 in range(1, p - 1):
                    for b1 in range(1, p - b2):
                        b0 = p - b1 - b2
                        fc[:, pos] = (b0 * G0 + b1 * G1 + b2 * G2) / p
                        pos += 1
                coords[off_face:off_int] = fc.reshape(-1, mesh.dim)
            else:
                cf = _canonical_face_corners(uniq_faces, el_faces, face_inv)
                A, B, C, D = (V[cf[:, i]][:, None, None, :] for i in range(4))
                s = tpar[1:p][None, :, None, None]
                t = tpar[1:p][None, None, :, None]
                bil = (
                    (1 - s) * (1 - t) * A
                    + s * (1 - t) * B
                    + (1 - s) * t * C
                    + s * t * D
                )
                # index layout: face*npf + (kt-1)*(p-1) + (ks-1)
                # -> t outer, s inner
                coords[off_face:off_int] = np.transpose(
                    bil, (0, 2, 1, 3)
                ).reshape(-1, mesh.dim)
        if n_int > 0:
            Xe = self._geometry_node_coords()
            ii = [li for li, r in enumerate(recs) if r[0] == "i"]
            order_ii = np.argsort([recs[li][1] for li in ii])
            ii = [ii[k] for k in order_ii]
            coords[off_int:] = Xe[:, ii, :].reshape(-1, mesh.dim)
        self.node_coords = coords

        # ---- lookup tables for boundary dof extraction
        self._edge_sorted = uniq_edges
        enc = uniq_edges[:, 0] * np.int64(nv) + uniq_edges[:, 1]
        self._edge_enc_order = np.argsort(enc)
        self._edge_enc = enc[self._edge_enc_order]
        if n_faces:
            fenc = _encode_rows(np.sort(uniq_faces, axis=1))
            self._face_enc_order = np.argsort(fenc)
            self._face_enc = fenc[self._face_enc_order]
        else:
            self._face_enc = np.zeros(0, dtype="V32")
            self._face_enc_order = np.zeros(0, dtype=np.int64)
        self._offsets = (nv, off_edge, off_face, off_int, npe, npf)

        # ---- lexicographic relabeling on structured Cartesian meshes.
        # Dof ids become grid indices, so the assembly dof gather/scatter is
        # expressible as strided slices / interior-dilated pads (contiguous
        # reads, no index arrays) — see integrator.py.  The id order matches the Cartesian element order
        # (2D: e = j*nx + i; 3D: e = i*ny*nz + j*nz + k).
        # Structured TRIANGLE meshes (each Cartesian cell split along the
        # SW-NE diagonal) relabel too: the union of P_p Lagrange nodes over
        # the triangulation fills the p-refined tensor grid EXACTLY
        # (vertices + edge nodes + interior nodes = (p*nx+1)(p*ny+1) points
        # — the diagonal-edge and interior nodes land on the grid), so the
        # same coordinate->grid-index map applies; the uniqueness check
        # below proves it per space.  Grid kind "h1t" tells the integrator
        # to use the 2-orientation grouped slice gather.
        self._relabel = None
        self.grid = None
        st = mesh.structured
        if st is not None and geom in (SQUARE, CUBE, TRIANGLE):
            c = self.node_coords
            if st[0] == "cart2d":
                _, nx, ny, sx, sy = st
                NX, NY = nx * p + 1, ny * p + 1
                gi = np.rint(c[:, 0] / sx * (nx * p)).astype(np.int64)
                gj = np.rint(c[:, 1] / sy * (ny * p)).astype(np.int64)
                new = gj * NX + gi
                dims, ndims = (nx, ny), (NY, NX)
            else:
                _, nx, ny, nz, sx, sy, sz = st
                NX, NY, NZ = nx * p + 1, ny * p + 1, nz * p + 1
                gi = np.rint(c[:, 0] / sx * (nx * p)).astype(np.int64)
                gj = np.rint(c[:, 1] / sy * (ny * p)).astype(np.int64)
                gk = np.rint(c[:, 2] / sz * (nz * p)).astype(np.int64)
                new = gi * (NY * NZ) + gj * NZ + gk
                dims, ndims = (nx, ny, nz), (NX, NY, NZ)
            if np.unique(new).size == self.ndof_scalar:
                self.edof = new[self.edof.astype(np.int64)].astype(np.int32)
                nc = np.empty_like(self.node_coords)
                nc[new] = self.node_coords
                self.node_coords = nc
                self._relabel = new
                self.grid = (
                    "h1t" if geom == TRIANGLE else "h1", dims, ndims
                )
        elif _reorder_enabled():
            # UNSTRUCTURED meshes: first-touch dof relabeling — dof ids
            # follow element scan order, so the edof gather reads
            # near-contiguous windows and the valence-transpose scatter
            # (integrator._edof_inverse) emits near-sequential slots.
            # Pair with mesh.spatial_sort (Morton element order) for the
            # full locality win; MFEM_AD_TPU_REORDER=0 disables for A/B.
            flat = self.edof.astype(np.int64).ravel()
            _, first = np.unique(flat, return_index=True)
            new = np.empty(self.ndof_scalar, dtype=np.int64)
            new[np.argsort(first, kind="stable")] = np.arange(
                self.ndof_scalar
            )
            self.edof = new[self.edof.astype(np.int64)].astype(np.int32)
            nc = np.empty_like(self.node_coords)
            nc[new] = self.node_coords
            self.node_coords = nc
            self._relabel = new

    # ------------------------------------------------------------------
    def boundary_dofs(self, attr_mask=None) -> np.ndarray:
        """Scalar dof ids on boundary faces whose attribute is selected.

        ``attr_mask``: None (all), or a boolean/0-1 array indexed by
        ``attribute-1`` like MFEM's ``is_bdr_ess`` arrays (ex4.cpp:88-92).
        """
        mesh = self.mesh
        if attr_mask is None:
            sel = np.ones(mesh.bdr_elements.shape[0], dtype=bool)
        else:
            attr_mask = np.asarray(attr_mask)
            sel = attr_mask[mesh.bdr_attributes - 1].astype(bool)
        bels = mesh.bdr_elements[sel].astype(np.int64)
        if self.fe_type == L2:
            # L2 spaces have no boundary-conforming dofs; MFEM returns none
            return np.zeros(0, dtype=np.int64)
        if getattr(self, "_structured_lattice", None) is not None:
            return self._boundary_dofs_structured(bels)
        p = self.order
        nv, off_edge, off_face, off_int, npe, npf = self._offsets
        dofs = [bels.ravel()]
        if p >= 2:
            if mesh.dim == 2:
                eidx = self._find_edges(bels)
                dofs.append(
                    (off_edge + eidx[:, None] * npe + np.arange(npe)[None, :]).ravel()
                )
            elif bels.shape[1] == 3:
                # boundary triangles [a,b,c]: edges ab, ac, bc + tri face
                for pr in [(0, 1), (0, 2), (1, 2)]:
                    eidx = self._find_edges(bels[:, list(pr)])
                    dofs.append(
                        (
                            off_edge
                            + eidx[:, None] * npe
                            + np.arange(npe)[None, :]
                        ).ravel()
                    )
                if npf > 0:
                    fidx = self._find_faces(bels)
                    dofs.append(
                        (
                            off_face
                            + fidx[:, None] * npf
                            + np.arange(npf)[None, :]
                        ).ravel()
                    )
            else:
                # boundary quads [a,b,c,d] lex: edges ab, cd, ac, bd
                for pr in [(0, 1), (2, 3), (0, 2), (1, 3)]:
                    eidx = self._find_edges(bels[:, list(pr)])
                    dofs.append(
                        (
                            off_edge
                            + eidx[:, None] * npe
                            + np.arange(npe)[None, :]
                        ).ravel()
                    )
                fidx = self._find_faces(bels)
                dofs.append(
                    (off_face + fidx[:, None] * npf + np.arange(npf)[None, :]).ravel()
                )
        ids = np.unique(np.concatenate(dofs)) if dofs else np.zeros(0, np.int64)
        if self._relabel is not None:
            ids = np.sort(self._relabel[ids])
        return ids

    def essential_dofs(self, attr_mask=None, components=None) -> np.ndarray:
        """Boundary dofs expanded over vdim components (byNODES layout)."""
        base = self.boundary_dofs(attr_mask)
        comps = range(self.vdim) if components is None else components
        return np.concatenate(
            [base + c * self.ndof_scalar for c in comps]
        ).astype(np.int64)

    def essential_mask(self, attr_mask=None, components=None) -> np.ndarray:
        mask = np.zeros(self.ndof, dtype=bool)
        mask[self.essential_dofs(attr_mask, components)] = True
        return mask

    def _find_edges(self, pairs: np.ndarray) -> np.ndarray:
        s = np.sort(pairs, axis=1)
        q = s[:, 0] * np.int64(self.mesh.num_vertices) + s[:, 1]
        pos = np.searchsorted(self._edge_enc, q)
        return self._edge_enc_order[pos]

    def _find_faces(self, quads: np.ndarray) -> np.ndarray:
        """Unique-face ids of [n, 4] vertex quadruples (any corner order)."""
        q = _encode_rows(np.sort(quads, axis=1))
        pos = np.searchsorted(self._face_enc, q)
        return self._face_enc_order[pos]

    # ------------------------------------------------------------------
    def project(self, fn) -> np.ndarray:
        """Nodal interpolation of ``fn(x)`` (x: [dim]) -> dof vector.

        For vdim>1, ``fn`` must return a length-vdim array; the result uses
        byNODES layout.  Equivalent of GridFunction::ProjectCoefficient.
        """
        n = self.node_coords.shape[0]
        try:  # vectorized: fn receives [dim, n] so x[0] is all first comps
            vals = np.asarray(fn(self.node_coords.T), dtype=np.float64)
            if self.vdim == 1 and vals.shape == (n,):
                pass
            elif vals.shape == (self.vdim, n):
                vals = vals.T
            elif vals.shape in ((self.vdim,), ()):
                vals = np.broadcast_to(np.atleast_1d(vals), (n, self.vdim))
            else:
                raise ValueError("not vectorized")
            v0 = np.atleast_1d(np.asarray(fn(self.node_coords[0]),
                                          dtype=np.float64))
            if not np.allclose(np.atleast_1d(vals[0] if vals.ndim > 1
                                             else vals[0]), v0,
                               rtol=1e-12, atol=1e-12):
                raise ValueError("vectorized result mismatch")
        except Exception:
            vals = np.array([fn(x) for x in self.node_coords])
        if self.vdim == 1:
            return vals.reshape(-1)
        return vals.reshape(n, self.vdim).T.reshape(-1)  # byNODES layout

    def project_bdr(self, u: np.ndarray, fn, attr_mask=None) -> np.ndarray:
        """Overwrite boundary nodal values with fn — ProjectBdrCoefficient."""
        u = np.array(u)
        ids = self.boundary_dofs(attr_mask)
        if len(ids) == 0:
            return u
        xs = self.node_coords[ids]  # [nb, sdim]
        vals = None
        try:  # vectorized evaluation (same contract as project())
            # When vdim > 1 and len(ids) == vdim the shapes (vdim, nb) and
            # (nb, vdim) coincide, so orientation sniffing is ambiguous and
            # the single-point cross-check can pass coincidentally — use
            # the per-point fallback there.
            if self.vdim > 1 and len(ids) == self.vdim:
                raise ValueError("ambiguous orientation")
            v = np.asarray(fn(xs), dtype=np.float64)
            if self.vdim == 1 and v.shape == (len(ids),):
                vals = v[None, :]
            elif v.shape == (self.vdim, len(ids)):
                vals = v
            elif v.shape == (len(ids), self.vdim):
                vals = v.T
            if vals is not None:
                v0 = np.atleast_1d(np.asarray(fn(xs[0]), dtype=np.float64))
                if not np.allclose(vals[:, 0], v0, rtol=1e-12, atol=1e-12):
                    vals = None  # fn vectorized over components, not points
        except Exception:
            vals = None
        if vals is None:  # per-point fallback
            vs = [np.atleast_1d(fn(x)) for x in xs]
            vals = np.asarray(vs, dtype=np.float64).T  # [vdim, nb]
        for c in range(self.vdim):
            u[ids + c * self.ndof_scalar] = vals[c]
        return u


def _canonical_face_index(corners: np.ndarray, ks: int, kt: int, p: int):
    """Map local face lattice index (ks,kt) to the canonical face frame.

    ``corners`` [n, 4] are the global vertex ids of the face in local lex
    order [c00, c10, c01, c11].  Canonical frame: origin = min id corner,
    s-axis toward its smaller-id (face-adjacent) neighbor.
    Returns canonical (ks', kt') arrays.
    """
    n = corners.shape[0]
    # local lattice coordinates of the 4 corners
    corner_st = np.array([(0, 0), (1, 0), (0, 1), (1, 1)])
    # adjacency on the quad: corner -> its two neighbors (local indices)
    nbrs = {0: (1, 2), 1: (0, 3), 2: (3, 0), 3: (2, 1)}
    o = np.argmin(corners, axis=1)  # local index of canonical origin
    ks_out = np.empty(n, dtype=np.int64)
    kt_out = np.empty(n, dtype=np.int64)
    # vectorize over the 4x2 possible (origin, first-axis) configurations
    for oi in range(4):
        m = o == oi
        if not m.any():
            continue
        n1, n2 = nbrs[oi]
        swap = corners[m, n1] > corners[m, n2]
        # origin local coords and axis directions in the local lattice
        o_st = corner_st[oi]
        d1 = corner_st[n1] - o_st  # direction to neighbor 1
        d2 = corner_st[n2] - o_st
        # canonical s runs toward the smaller neighbor
        for sw in (False, True):
            mm = np.zeros(n, dtype=bool)
            mm[m] = swap == sw
            if not mm.any():
                continue
            ds = d2 if sw else d1
            dt = d1 if sw else d2
            # local lattice coords measured from the canonical origin
            ls = _axis_coord(ds, o_st, ks, kt, p)
            lt = _axis_coord(dt, o_st, ks, kt, p)
            ks_out[mm] = ls
            kt_out[mm] = lt
    return ks_out, kt_out


def _axis_coord(d: np.ndarray, o_st: np.ndarray, ks: int, kt: int, p: int):
    """Lattice coordinate along canonical axis d from origin o_st."""
    if d[0] != 0:  # axis runs along local s
        return ks if o_st[0] == 0 else p - ks
    return kt if o_st[1] == 0 else p - kt


def _canonical_face_corners(uniq_faces, el_faces, face_inv):
    """[n_faces, 4] corner ids ordered canonically [g00, g10, g01, g11].

    Reconstructed from one incident element's local face (corner layout
    [c00, c10, c01, c11]).  Fully vectorized — this runs once per space
    build and is on the multi-million-hex setup path (the reference
    inherits MFEM's C++ face machinery, ex1.cpp:47).
    """
    n_faces = uniq_faces.shape[0]
    flat_inv = face_inv.ravel()
    flat_faces = el_faces.reshape(-1, 4)
    # first incident (element, local-face) per unique face: flat_inv's
    # values are exactly 0..n_faces-1, so unique's return_index gives the
    # first occurrence of each
    _, first = np.unique(flat_inv, return_index=True)
    c = flat_faces[first]  # [n_faces, 4] local-lex corner ids
    # quad adjacency in local lex layout [c00, c10, c01, c11]
    n1_tab = np.array([1, 0, 3, 2])
    n2_tab = np.array([2, 3, 0, 1])
    diag_tab = np.array([3, 2, 1, 0])
    oi = np.argmin(c, axis=1)  # canonical origin = min corner id
    n1, n2 = n1_tab[oi], n2_tab[oi]
    cn1 = np.take_along_axis(c, n1[:, None], axis=1)[:, 0]
    cn2 = np.take_along_axis(c, n2[:, None], axis=1)[:, 0]
    swap = cn1 > cn2  # s-axis runs toward the smaller neighbor
    out = np.empty((n_faces, 4), dtype=np.int64)
    out[:, 0] = np.take_along_axis(c, oi[:, None], axis=1)[:, 0]
    out[:, 1] = np.where(swap, cn2, cn1)
    out[:, 2] = np.where(swap, cn1, cn2)
    out[:, 3] = np.take_along_axis(c, diag_tab[oi][:, None], axis=1)[:, 0]
    return out


def _encode_rows(rows: np.ndarray) -> np.ndarray:
    """Order-preserving 1-D void encoding of non-negative int64 rows:
    big-endian bytes compare lexicographically like the numeric tuples,
    so sorted-row membership queries become one searchsorted over voids
    (replaces a Python dict on the multi-million-face setup path)."""
    rows = np.ascontiguousarray(rows.astype(">i8"))
    return rows.view(f"V{rows.shape[1] * 8}").ravel()


def qspace_to_fespace(mesh, ir, order: int | None = None):
    """L2 FE representation of per-qp data — the reference's QSpaceToFESpace
    (tools.hpp:156-177), which builds an L2 space matching a QuadratureSpace.

    Returns ``(space, transfer)`` where ``space`` is an L2 FESpace of the
    given order (default: enough to fit the rule) and
    ``transfer(values[ne, nq]) -> dofs[space.ndof]`` is the per-element
    weighted least-squares fit of the qp values (exact when the rule
    integrates degree-2*order polynomials, as the reference assumes for
    its tensor-product case).
    """
    if order is None:
        order = max(ir.order // 2, 0)
    space = FESpace(mesh, order, L2)
    phi = space.elem.eval(ir.points)  # [nq, nd]
    W = np.diag(ir.weights)
    A = np.linalg.solve(phi.T @ W @ phi, phi.T @ W)  # [nd, nq]

    def transfer(values):
        v = np.asarray(values)
        if v.ndim == 3:
            if v.shape[-1] != 1:
                raise ValueError("qspace transfer expects scalar qp data")
            v = v[..., 0]
        de = np.einsum("dq,eq->ed", A, v)  # [ne, nd]
        out = np.zeros(space.ndof)
        out[np.asarray(space.edof)] = de
        return out

    return space, transfer
