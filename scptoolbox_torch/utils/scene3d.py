"""From-scratch software 3D renderer on matplotlib (reference
src/utils/scene_3d.jl:249-1654): scene graph of meshes/cameras/lights/axes
with poses in a tree (utils/tree.py), perspective projection, clipping,
backface culling, Lambert shading, and painter's-algorithm z-sorting into a
matplotlib PolyCollection.

The port's copy of `scptoolbox_tpu/utils/scene3d.py`. Host-side (numpy,
and matplotlib imported lazily) by design: rendering is not a device
workload; inputs may be numpy arrays or tensors on any device. The
geometry pipeline is vectorized across faces (the reference loops per
face, scene_3d.jl:1370-1390); a starship-scale scene bakes in
milliseconds.

Conventions match the reference: vertices are stored row-wise here
((n, 3) instead of Julia's 3xN columns), faces are (m, 3) integer rows
with an optional 4th column indexing per-face normals, poses are 4x4
homogeneous transforms of body-wrt-parent, and the camera looks down its
local -z axis with the standard OpenGL-style frustum projection
(scene_3d.jl:1128-1188)."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from scptoolbox_torch.utils.plots import as_numpy
from scptoolbox_torch.utils.tree import TreeNode, find_common


def _arr(a, dtype=None) -> np.ndarray:
    return np.asarray(as_numpy(a), dtype)


def _plt():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


ColorSpec = Union[str, Sequence]


def homtransf(R: Optional[np.ndarray] = None,
              t: Optional[np.ndarray] = None) -> np.ndarray:
    """4x4 homogeneous transform (reference helper.jl:873-943)."""
    T = np.eye(4)
    if R is not None:
        T[:3, :3] = _arr(R, float)
    if t is not None:
        T[:3, 3] = _arr(t, float).reshape(3)
    return T


def rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return _arr([[1, 0, 0], [0, c, -s], [0, s, c]], float)


def rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return _arr([[c, 0, s], [0, 1, 0], [-s, 0, c]], float)


def rot_z(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return _arr([[c, -s, 0], [s, c, 0], [0, 0, 1]], float)


class SceneObject:
    """Base scene object: a name and a local (body-wrt-parent) pose
    (reference SceneProperties + PoseTrait, scene_3d.jl:200-247)."""

    def __init__(self, name: str):
        self.name = name
        self.local_pose = np.eye(4)
        self.node: Optional[TreeNode] = None   # set by Scene3D.add

    def set_pose(self, pose: np.ndarray) -> None:
        self.local_pose = _arr(pose, float)


class Mesh3D(SceneObject):
    """Renderable triangle mesh (reference Mesh3D, scene_3d.jl:249-345).

    V: (n, 3) vertices; F: (m, 3) or (m, 4) int faces (4th column = row
    into N, the (k, 3) per-face normals); colors/widths broadcast per
    face."""

    def __init__(self, V, F, N=None, *, name: str = "mesh",
                 face_color: ColorSpec = "none",
                 edge_color: ColorSpec = "black",
                 edge_width=0.1):
        super().__init__(name)
        self.V = _arr(V, float).reshape(-1, 3)
        self.F = _arr(F, int)
        assert self.F.ndim == 2 and self.F.shape[1] in (3, 4), self.F.shape
        self.N = None if N is None else _arr(N, float).reshape(-1, 3)
        m = self.F.shape[0]
        self.face_color = self._per_face(face_color, m)
        self.edge_color = self._per_face(edge_color, m)
        self.edge_width = np.broadcast_to(
            _arr(edge_width, float), (m,)).copy()

    @staticmethod
    def _per_face(spec: ColorSpec, m: int) -> np.ndarray:
        arr = np.empty(m, object)
        if isinstance(spec, str) or not isinstance(spec, (list, tuple,
                                                          np.ndarray)):
            arr[:] = spec
        else:
            assert len(spec) == m, (len(spec), m)
            arr[:] = list(spec)
        return arr

    @staticmethod
    def from_obj(filepath: str, **kw) -> "Mesh3D":
        """Wavefront .obj loader (reference load_wavefront,
        scene_3d.jl:1191-1240): v / vn / f records, `f i//n j//n k//n`
        carries the face normal index."""
        V: List[List[float]] = []
        N: List[List[float]] = []
        F: List[List[int]] = []
        with open(filepath) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                vals = line.split()
                if not vals:
                    continue
                if vals[0] == "v":
                    V.append([float(x) for x in vals[1:4]])
                elif vals[0] == "vn":
                    N.append([float(x) for x in vals[1:4]])
                elif vals[0] == "f":
                    parts = [v.split("//") for v in vals[1:4]]
                    face = [int(p[0]) - 1 for p in parts]
                    if len(parts[0]) == 2:
                        face.append(int(parts[0][1]) - 1)
                    F.append(face)
        return Mesh3D(_arr(V), _arr(F, int),
                      _arr(N) if N else None, **kw)


def sphere(r: float = 1.0, *, az: int = 20, el: int = 10,
           center=(0.0, 0.0, 0.0), **kw) -> Mesh3D:
    """UV-sphere mesh with outward per-face normals (reference Sphere3D,
    scene_3d.jl:602-660)."""
    azs = np.linspace(0.0, 2 * np.pi, az + 1)[:-1]
    els = np.linspace(-0.5 * np.pi, 0.5 * np.pi, el + 1)
    A, E = np.meshgrid(azs, els, indexing="ij")          # (az, el+1)
    V = r * np.stack([np.cos(A) * np.cos(E), np.sin(A) * np.cos(E),
                      np.sin(E)], axis=-1).reshape(-1, 3)
    V = V + _arr(center, float)[None, :]
    idx = np.arange(az * (el + 1)).reshape(az, el + 1)
    i00 = idx[:, :-1]
    i01 = idx[:, 1:]
    i10 = np.roll(idx, -1, axis=0)[:, :-1]
    i11 = np.roll(idx, -1, axis=0)[:, 1:]
    quads_a = np.stack([i00, i10, i11], axis=-1).reshape(-1, 3)
    quads_b = np.stack([i00, i11, i01], axis=-1).reshape(-1, 3)
    F = np.concatenate([quads_a, quads_b], axis=0)
    # outward normals: mean of the face's vertex directions
    ctr = (V[F[:, 0]] + V[F[:, 1]] + V[F[:, 2]]) / 3.0 - _arr(
        center, float)
    Nrm = ctr / np.maximum(np.linalg.norm(ctr, axis=1, keepdims=True),
                           1e-12)
    F = np.concatenate([F, np.arange(len(F))[:, None]], axis=1)
    return Mesh3D(V, F, Nrm, **kw)


def line(v0, v1, *, nseg: int = 1, name: str = "line",
         edge_color: ColorSpec = "black", edge_width=1.0) -> Mesh3D:
    """Polyline as degenerate triangles (reference Line3D,
    scene_3d.jl:700-760): renders as edges only."""
    v0 = _arr(v0, float)
    v1 = _arr(v1, float)
    ts = np.linspace(0.0, 1.0, nseg + 1)[:, None]
    V = v0[None, :] * (1 - ts) + v1[None, :] * ts
    seg = np.arange(nseg)
    F = np.stack([seg, seg + 1, seg], axis=1)
    return Mesh3D(V, F, name=name, face_color="none",
                  edge_color=edge_color, edge_width=edge_width)


def polyline(points, *, name: str = "polyline",
             edge_color: ColorSpec = "black", edge_width=1.0) -> Mesh3D:
    """Open polyline through `points` (n, 3) — the trajectory-drawing
    primitive used by the example plot suites."""
    V = _arr(points, float).reshape(-1, 3)
    seg = np.arange(len(V) - 1)
    F = np.stack([seg, seg + 1, seg], axis=1)
    return Mesh3D(V, F, name=name, face_color="none",
                  edge_color=edge_color, edge_width=edge_width)


def box(extents=(1.0, 1.0, 1.0), *, center=(0.0, 0.0, 0.0), **kw) -> Mesh3D:
    """Axis-aligned box with outward normals."""
    e = 0.5 * _arr(extents, float)
    c = _arr(center, float)
    sgn = _arr([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                      for sz in (-1, 1)], float)
    V = c[None, :] + sgn * e[None, :]
    quads = [                      # (4 verts, outward axis, sign)
        ([0, 1, 3, 2], 0, -1), ([4, 6, 7, 5], 0, 1),
        ([0, 4, 5, 1], 1, -1), ([2, 3, 7, 6], 1, 1),
        ([0, 2, 6, 4], 2, -1), ([1, 5, 7, 3], 2, 1),
    ]
    F: List[List[int]] = []
    Nrm: List[np.ndarray] = []
    for (a, b, cc, d), ax, sg in quads:
        n = np.zeros(3)
        n[ax] = sg
        for tri in ((a, b, cc), (a, cc, d)):
            F.append(list(tri) + [len(Nrm)])
            Nrm.append(n)
    return Mesh3D(V, _arr(F, int), _arr(Nrm), **kw)


def axis_mesh(length: float = 1.0, width: float = 0.05) -> Mesh3D:
    """RGB triad mesh for a visible Axis3D (reference MeshAxis3D +
    make_x_axis_mesh, scene_3d.jl:563-600, :762-830)."""
    Vs: List[np.ndarray] = []
    Fs: List[np.ndarray] = []
    colors: List[str] = []
    rots = [np.eye(3), rot_z(0.5 * np.pi), rot_y(-0.5 * np.pi)]
    for Rax, color in zip(rots, ["red", "green", "blue"]):
        b = box((length, width, width), center=(length / 2.0, 0.0, 0.0))
        V = b.V @ Rax.T
        off = sum(len(v) for v in Vs)
        Fs.append(b.F[:, :3] + off)
        Vs.append(V)
        colors.extend([color] * len(b.F))
    return Mesh3D(np.concatenate(Vs), np.concatenate(Fs),
                  name="axis_mesh", face_color=colors, edge_color="none",
                  edge_width=0.0)


class Camera3D(SceneObject):
    """Perspective camera looking down its local -z axis (reference
    Camera3D, scene_3d.jl:360-399)."""

    def __init__(self, *, fovy: float = 30.0, aspect: float = 1.0,
                 znear: float = 0.1, zfar: float = 100.0,
                 name: str = "camera"):
        super().__init__(name)
        self.fovy = float(fovy)
        self.aspect = float(aspect)
        self.znear = float(znear)
        self.zfar = float(zfar)

    def look_at(self, eye, target, up=(0.0, 0.0, 1.0)) -> None:
        """Place the camera at `eye` looking at `target` (convenience the
        reference builds by hand in its example plot suites)."""
        eye = _arr(eye, float)
        fwd = _arr(target, float) - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = _arr(up, float)
        if np.linalg.norm(np.cross(fwd, up)) < 1e-9:
            up = _arr([0.0, 1.0, 0.0])   # view axis parallel to up
            if np.linalg.norm(np.cross(fwd, up)) < 1e-9:
                up = _arr([1.0, 0.0, 0.0])
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        R = np.stack([right, true_up, -fwd], axis=1)  # camera axes as cols
        self.local_pose = homtransf(R, eye)


def frustum(left: float, right: float, bottom: float, top: float,
            near: float, far: float) -> np.ndarray:
    """Perspective frustum matrix (reference scene_3d.jl:1157-1188)."""
    P = np.zeros((4, 4))
    P[0, 0] = 2 * near / (right - left)
    P[1, 1] = 2 * near / (top - bottom)
    # off-center terms multiply z (standard OpenGL frustum column 2), so
    # asymmetric frusta shear correctly; perspective() only ever builds
    # the symmetric case where these vanish
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[2, 2] = -(far + near) / (far - near)
    P[2, 3] = 2 * near * far / (near - far)
    P[3, 2] = -1.0
    return P


def perspective(camera: Camera3D) -> np.ndarray:
    """Camera perspective matrix (reference scene_3d.jl:1128-1145)."""
    h = math.tan(0.5 * math.radians(camera.fovy)) * camera.znear
    w = h * camera.aspect
    return frustum(-w, w, -h, h, camera.znear, camera.zfar)


class Axis3D(SceneObject):
    """Pose-only frame node; optionally rendered as an RGB triad
    (reference Axis3D, scene_3d.jl:413-447)."""

    def __init__(self, *, name: str = "axis", visible: bool = False,
                 axis_length: float = 1.0, axis_width: float = 0.05):
        super().__init__(name)
        self.visible = visible
        self.axis_length = axis_length
        self.axis_width = axis_width


class Light3D(SceneObject):
    """Directional light by azimuth/elevation in degrees (reference
    Light3D, scene_3d.jl:451-483)."""

    def __init__(self, az: float = 315.0, el: float = 45.0,
                 *, name: str = "light"):
        super().__init__(name)
        assert 0.0 <= az <= 360.0 and 0.0 <= el <= 90.0
        self.az = float(az)
        self.el = float(el)

    def direction(self) -> np.ndarray:
        """Unit vector pointing TOWARD the light source."""
        az = math.radians(self.az)
        el = math.radians(self.el)
        return _arr([math.cos(el) * math.cos(az),
                           math.cos(el) * math.sin(az), math.sin(el)])


class BakedScene3D:
    """Matplotlib-ready projected scene (reference BakedScene3D,
    scene_3d.jl:1198-1238): z-sorted 2D triangles + per-face styling."""

    def __init__(self, tris=None, fc=(), ec=(), ew=()):
        self.tris = (np.zeros((0, 3, 2)) if tris is None
                     else _arr(tris))
        self.fc = list(fc)
        self.ec = list(ec)
        self.ew = _arr(ew, float)


class Scene3D:
    """Scene graph rooted at the world frame (reference Scene3D,
    scene_3d.jl:498-529)."""

    def __init__(self):
        world = Axis3D(name="cs_world")
        self.root = TreeNode(world)
        world.node = self.root

    def add(self, obj: SceneObject,
            parent: Optional[SceneObject] = None) -> SceneObject:
        """Attach `obj` under `parent` (default: the world frame)."""
        pnode = self.root if parent is None else parent.node
        assert pnode is not None, "parent is not in the scene"
        obj.node = TreeNode(obj, pnode)
        return obj

    def find(self, name: str) -> List[SceneObject]:
        return self.root.findall(lambda o: o.name == name)

    def objects(self) -> List[SceneObject]:
        return self.root.findall(lambda o: True)

    # -- pose algebra (reference get_pose/relative_pose,
    #    scene_3d.jl:1020-1115) ------------------------------------------

    def pose_wrt(self, obj: SceneObject, ancestor_node: TreeNode
                 ) -> np.ndarray:
        H = np.eye(4)
        node = obj.node
        while node is not ancestor_node:
            assert node is not None, "object not under the given ancestor"
            H = node.data.local_pose @ H
            node = node.parent
        return H

    def relative_pose(self, obj: SceneObject,
                      wrt: SceneObject) -> np.ndarray:
        """Pose of `obj`'s body frame in `wrt`'s body frame."""
        common = find_common(obj.node, wrt.node)
        H_obj = self.pose_wrt(obj, common)
        H_wrt = self.pose_wrt(wrt, common)
        return np.linalg.inv(H_wrt) @ H_obj

    def _find_light_for(self, obj: SceneObject) -> Optional[Light3D]:
        """Nearest light walking up from `obj` (reference find_light,
        scene_3d.jl:1540-1570)."""
        node = obj.node.parent if obj.node is not None else None
        while node is not None:
            lights = [c.data for c in node.children
                      if isinstance(c.data, Light3D)]
            if len(lights) > 1:
                raise ValueError(
                    f"{node.data.name} has {len(lights)} lights (1 allowed)")
            if lights:
                return lights[0]
            node = node.parent
        return None

    # -- bake: project + clip + cull + shade + z-sort ---------------------

    def bake(self, camera: Camera3D) -> BakedScene3D:
        """Project the scene onto `camera` (reference bake,
        scene_3d.jl:1332-1482), vectorized across faces."""
        persp = perspective(camera)
        tris_parts: List[np.ndarray] = []
        fc_parts: List[np.ndarray] = []
        ec_parts: List[np.ndarray] = []
        ew_parts: List[np.ndarray] = []

        for obj in self.objects():
            if isinstance(obj, (Camera3D, Light3D)):
                continue
            if isinstance(obj, Axis3D):
                if not obj.visible:
                    continue
                mesh = axis_mesh(obj.axis_length, obj.axis_width)
                mesh.node = obj.node           # borrow the axis pose
            elif isinstance(obj, Mesh3D):
                mesh = obj
            else:
                continue

            rel = self.relative_pose(obj, camera)
            proj = persp @ rel
            Vh = np.concatenate(
                [mesh.V, np.ones((len(mesh.V), 1))], axis=1)
            clip = Vh @ proj.T                            # (n, 4)
            w = clip[:, 3:4]
            ndc = clip[:, :3] / np.where(np.abs(w) < 1e-12, 1e-12, w)

            Fv = mesh.F[:, :3]
            tri = ndc[Fv]                                 # (m, 3, 3)
            # clip: drop faces entirely beyond ONE frustum plane — all
            # three vertices past the same side (reference
            # scene_3d.jl:1376-1381). Testing the two sides together
            # would wrongly cull faces/segments spanning the viewport
            # with vertices on opposite sides.
            keep = ~np.any(np.all(tri > 1.0, axis=1)
                           | np.all(tri < -1.0, axis=1), axis=1)
            # drop faces behind the camera: in front of the lens means
            # camera-frame z < 0, i.e. clip w = -z_cam > 0
            keep &= np.all(w[Fv[:, :], 0] > 0.0, axis=1)

            # backface culling (scene_3d.jl:1383-1398 culls via projected
            # normal depth with a fixed NDC buffer, which is scene-scale
            # dependent; here the exact perspective test: a face whose
            # outward normal has positive dot product with the
            # camera-to-face ray faces away). 5% relative buffer keeps
            # silhouette-grazing faces, matching the reference's intent.
            shade = np.ones(len(Fv))
            if mesh.N is not None and mesh.F.shape[1] == 4:
                nrm = mesh.N[mesh.F[:, 3]]                # (m, 3)
                base = mesh.V[Fv[:, 0]]
                R_c = rel[:3, :3]
                n_cam = nrm @ R_c.T
                p_cam = base @ R_c.T + rel[:3, 3][None, :]
                facing = np.sum(n_cam * p_cam, axis=1)
                scale = (np.linalg.norm(n_cam, axis=1)
                         * np.linalg.norm(p_cam, axis=1))
                keep &= facing <= 0.05 * np.maximum(scale, 1e-12)

                light = self._find_light_for(obj)
                if light is not None:
                    # Lambert shading against the light direction in the
                    # mesh body frame (reference uses matplotlib
                    # LightSource.shade_normals; same [0, 1] intensity)
                    ldir = light.direction()
                    H_rel = self.relative_pose(light, obj)
                    ldir_body = H_rel[:3, :3] @ ldir
                    lam = nrm @ ldir_body
                    shade = 0.3 + 0.7 * np.clip(lam, 0.0, 1.0)

            if not np.any(keep):
                continue
            tri = tri[keep]
            shade = shade[keep]

            from matplotlib.colors import to_rgb

            def shaded(colors, sh):
                out = np.empty(len(colors), object)
                for i, (col, s) in enumerate(zip(colors, sh)):
                    if col == "none" or s >= 0.999:
                        out[i] = col
                    else:
                        out[i] = tuple(s * v for v in to_rgb(col))
                return out

            tris_parts.append(tri)
            fc_parts.append(shaded(mesh.face_color[keep], shade))
            ec_parts.append(shaded(mesh.edge_color[keep], shade))
            ew_parts.append(mesh.edge_width[keep])

        if not tris_parts:
            return BakedScene3D()
        tri3 = np.concatenate(tris_parts, axis=0)          # (M, 3, 3) NDC
        fc = np.concatenate(fc_parts)
        ec = np.concatenate(ec_parts)
        ew = np.concatenate(ew_parts)
        # painter's algorithm: draw far faces first (largest mean NDC
        # depth last in +z toward viewer convention, scene_3d.jl:1466-1477)
        z = tri3[:, :, 2].mean(axis=1)
        order = np.argsort(-z)
        return BakedScene3D(tri3[order][:, :, :2], fc[order].tolist(),
                            ec[order].tolist(), ew[order])

    def render(self, camera: Optional[Union[Camera3D, str]] = None,
               path: Optional[str] = None, *, canvas_size=(5.0, 5.0),
               bg_color=(0, 0, 0, 0), dpi: int = 200, ax=None):
        """Render to a matplotlib figure (reference render,
        scene_3d.jl:1245-1316). Returns (fig, ax)."""
        if not isinstance(camera, Camera3D):
            cams = [o for o in self.objects() if isinstance(o, Camera3D)
                    and (camera is None or o.name == camera)]
            if len(cams) != 1:
                raise ValueError(
                    f"expected exactly one matching camera, got {len(cams)}")
            camera = cams[0]
        plt = _plt()
        if ax is None:
            fig = plt.figure(figsize=canvas_size)
            ax = fig.add_axes([0, 0, 1, 1], xlim=(-1, 1), ylim=(-1, 1),
                              aspect=1.0 / camera.aspect, frameon=False)
        else:
            fig = ax.figure
        ax.set_xticks([])
        ax.set_yticks([])
        baked = self.bake(camera)
        from matplotlib.collections import PolyCollection
        coll = PolyCollection(
            list(baked.tris), closed=True, linewidths=baked.ew,
            edgecolors=baked.ec, facecolors=baked.fc,
            capstyle="round", joinstyle="round")
        ax.add_collection(coll)
        if path is not None:
            fig.savefig(path, dpi=dpi, facecolor=bg_color)
            plt.close(fig)
        return fig, ax
