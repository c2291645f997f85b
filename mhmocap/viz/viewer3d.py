"""3D scene + humans visualization (C17 in the survey inventory).

Capability parity with reference `mhmocap/visualization.py`
(BaseVisualizer/SceneHumansVisualizer/SkeletonVisualizer,
visualization.py:26-305,603-844):

  * scene point clouds from aggregated or per-frame RGB-D;
  * per-frame SMPL meshes with validity gating (invalid bodies are
    parked behind the camera, reference :249-252);
  * 15-joint MuPoTs skeletons with per-joint visibility and optional
    GT overlay through the eval match list (reference :655-844);
  * key-driven frame stepping, camera-true view, render-option reload,
    camera rotate/translate, and color/depth frame capture
    (reference :169-305 key map);
  * RenderOption JSON (viz/renderoption.json, loaded with 'R' —
    reference data/renderoption.json contract).

The reference requires Open3D's interactive window. Open3D is an
optional dependency, so every capability has a headless counterpart:
`export()` writes PLY geometry, and `capture_frame()` renders color
(matplotlib splat) and depth (numpy z-buffer splat, uint16
millimeters — the same 1000x encoding as the reference's
capture_depth_float_buffer path, :189-198) without a display.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..ops.cameras import unproject_points

try:
    import open3d as o3d
    HAVE_OPEN3D = True
except Exception:  # pragma: no cover - environment dependent
    o3d = None
    HAVE_OPEN3D = False

# Distinct per-person colors (own palette; same role as the
# reference's default_vis_color_list, visualization.py:8-24).
DEFAULT_VIS_COLORS = np.asarray([
    [0.93, 0.42, 0.36], [0.36, 0.93, 0.44], [0.38, 0.44, 0.93],
    [0.78, 0.36, 0.76], [0.91, 0.87, 0.18], [0.18, 0.91, 0.76],
    [0.14, 0.85, 0.99], [0.26, 0.52, 0.52], [0.86, 0.74, 0.74],
    [0.74, 0.95, 0.59], [0.71, 0.13, 0.13], [0.13, 0.47, 0.59],
    [0.38, 0.75, 0.95], [0.86, 0.42, 0.25], [0.50, 0.81, 0.25],
], np.float32)

RENDEROPTION_PATH = os.path.join(os.path.dirname(
    os.path.abspath(__file__)), "renderoption.json")

# Open3D shows +y up / -z forward; camera-space geometry flips y and z
# (reference applies this transform to every geometry, e.g. :255,:647)
FLIP_YZ = np.array([[1, 0, 0, 0], [0, -1, 0, 0],
                    [0, 0, -1, 0], [0, 0, 0, 1]], np.float64)

# MuPoTs 17-joint skeleton links for full-layout exports
MUPOTS_LINKS = [
    (0, 16), (16, 1), (1, 15), (15, 14),
    (1, 2), (2, 3), (3, 4),
    (1, 5), (5, 6), (6, 7),
    (14, 8), (8, 9), (9, 10),
    (14, 11), (11, 12), (12, 13),
]

# Parent of each of the first 15 MuPoTs joints (-1 = none); the
# 15-joint skeleton the reference draws (visualization.py:604-620)
MUPOTS15_PARENT = [1, 2, 3, 4, -1, 1, 5, 6, 14, 8, 9, 14, 11, 12, 1]


def mupots15_pose_arrays(pose3d, vis, thr: float = 0.5):
    """(17+, 3) pose + (17+, 1) visibility -> 15-joint skeleton arrays.

    Returns (points (15, 3), links (15, 2) int, joint_ok (15,) bool).
    Reproduces the reference's gating quirks
    (visualization.py:624-645): sphere visibility uses `thr`, but the
    LINK gate is hard-coded at 0.5 regardless of `thr`; hidden joints
    collapse to the origin and their links to the degenerate (0, 0).
    """
    pose3d = np.asarray(pose3d)[:15]
    vis = np.asarray(vis).reshape(-1)[:15]
    joint_ok = vis > thr
    points = np.where(joint_ok[:, None], pose3d, 0.0)
    links = []
    for i, parent in enumerate(MUPOTS15_PARENT):
        if vis[i] > 0.5 and parent >= 0 and vis[parent] > 0.5:
            links.append([i, parent])
        else:
            links.append([0, 0])
    return points, np.asarray(links, np.int32), joint_ok


def scene_pointcloud_arrays(scene_img, scene_depth, scene_mask, cam_K,
                            stride: int = 1):
    """Colored scene point cloud from aggregated RGB-D
    (reference build_single_point_cloud_from_rgbd capability)."""
    import jax.numpy as jnp

    H, W = np.asarray(scene_depth).shape
    ys, xs = np.mgrid[0:H:stride, 0:W:stride]
    uvd = np.stack([xs + 0.5, ys + 0.5,
                    np.asarray(scene_depth)[ys, xs]],
                   axis=-1).reshape(-1, 3)
    pts = np.asarray(unproject_points(jnp.asarray(uvd, jnp.float32),
                                      jnp.asarray(cam_K)))
    ok = np.asarray(scene_mask)[ys, xs].reshape(-1) > 0.5
    colors = np.asarray(scene_img)[ys, xs].reshape(-1, 3).astype(
        np.float32) / 255.0
    return pts[ok], colors[ok]


def write_ply_points(path, pts, colors=None):
    """Minimal ASCII PLY point-cloud writer (no external deps)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write("end_header\n")
        for i, p in enumerate(pts):
            line = f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}"
            if colors is not None:
                c = (np.clip(colors[i], 0, 1) * 255).astype(int)
                line += f" {c[0]} {c[1]} {c[2]}"
            f.write(line + "\n")


def write_ply_mesh(path, verts, faces):
    """Minimal ASCII PLY triangle-mesh writer."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(verts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                f"element face {len(faces)}\n"
                "property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
        for tri in faces:
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def splat_depth(points: np.ndarray, cam_K, image_size) -> np.ndarray:
    """Z-buffer point splat -> (H, W) float32 depth (0 = empty).

    The headless stand-in for Open3D's capture_depth_float_buffer."""
    W, H = image_size
    depth = np.full((H, W), np.inf, np.float32)
    pts = np.asarray(points, np.float32)
    pts = pts[pts[:, 2] > 1e-3]
    if len(pts):
        u = np.clip((cam_K[0, 0] * pts[:, 0] / pts[:, 2]
                     + cam_K[0, 2]).astype(int), 0, W - 1)
        v = np.clip((cam_K[1, 1] * pts[:, 1] / pts[:, 2]
                     + cam_K[1, 2]).astype(int), 0, H - 1)
        np.minimum.at(depth, (v, u), pts[:, 2])
    return np.where(np.isfinite(depth), depth, 0.0)


class BaseVisualizer:
    """Camera + render-option state shared by both visualizers
    (reference BaseVisualizer, visualization.py:26-30)."""

    def __init__(self, camera: Dict,
                 renderoption_filename: str = RENDEROPTION_PATH,
                 output_path: Optional[str] = None):
        self.cam = camera
        self.window_size = camera["image_size"]
        self.K = np.asarray(camera["K"])
        self.renderoption_filename = renderoption_filename
        self.output_path = os.path.realpath(output_path or "./")
        self.curr_frame = 0
        self.curr_image_index = 0

    # -- Open3D callbacks ------------------------------------------------
    def _camera_true_view(self, vis):  # pragma: no cover - needs o3d
        """'U': set the viewpoint to the real camera
        (reference update_camera_callback, :40-61)."""
        ctr = vis.get_view_control()
        p = ctr.convert_to_pinhole_camera_parameters()
        win_w, win_h = p.intrinsic.width, p.intrinsic.height
        cam_w, cam_h = self.window_size
        p.intrinsic.set_intrinsics(
            win_w, win_h, win_w * self.K[0, 0] / cam_w,
            win_h * self.K[1, 1] / cam_h, win_w / 2 - 0.5,
            win_h / 2 - 0.5)
        p.extrinsic = FLIP_YZ
        ctr.convert_from_pinhole_camera_parameters(p)
        return False

    def _load_render_option(self, vis):  # pragma: no cover - needs o3d
        """'R' (reference load_render_option_callback, :33-38)."""
        print("Loading render options from", self.renderoption_filename)
        vis.get_render_option().load_from_json(self.renderoption_filename)
        return False

    def _o3d_capture(self, vis, color: bool, depth: bool):
        """Save the Open3D buffers like reference capture_frame
        (:181-203): color PNG + uint16 millimeter depth PNG."""
        # pragma: no cover - needs o3d window
        from PIL import Image
        if color:
            img = np.asarray(vis.capture_screen_float_buffer())
            Image.fromarray((255 * img).astype(np.uint8)).save(
                os.path.join(self.output_path,
                             f"img_{self.curr_image_index:06d}.png"))
        if depth:
            d = 1000.0 * np.asarray(vis.capture_depth_float_buffer())
            Image.fromarray(d.astype(np.uint16)).save(
                os.path.join(self.output_path,
                             f"depth_{self.curr_image_index:06d}.png"))
        self.curr_image_index += 1
        return False

    # -- headless capture ------------------------------------------------
    def _headless_capture(self, points, colors, color: bool,
                          depth: bool, extra_points=None):
        """Color (matplotlib splat) + depth (z-buffer splat) captures
        with the reference's file naming and uint16-mm depth
        encoding."""
        os.makedirs(self.output_path, exist_ok=True)
        if color:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import jax.numpy as jnp
            from ..ops.cameras import project_points

            fig, ax = plt.subplots(figsize=(6, 6))
            if len(points):
                uv = np.asarray(project_points(
                    jnp.asarray(points, jnp.float32),
                    jnp.asarray(self.K, jnp.float32)))
                ax.scatter(uv[:, 0], uv[:, 1], c=np.clip(colors, 0, 1),
                           s=1)
            W, H = self.window_size
            ax.set_xlim(0, W)
            ax.set_ylim(H, 0)
            ax.set_aspect("equal")
            fig.savefig(os.path.join(
                self.output_path,
                f"img_{self.curr_image_index:06d}.png"), dpi=100)
            plt.close(fig)
        if depth:
            from PIL import Image
            allpts = points if extra_points is None else np.concatenate(
                [points, extra_points], axis=0)
            d = splat_depth(allpts, self.K, self.window_size)
            Image.fromarray((1000.0 * d).astype(np.uint16)).save(
                os.path.join(self.output_path,
                             f"depth_{self.curr_image_index:06d}.png"))
        self.curr_image_index += 1


class SceneHumansVisualizer(BaseVisualizer):
    """Scene point cloud(s) + per-frame human meshes.

    Accepts a single aggregated scene (H, W, 3)/(H, W) or per-frame
    scenes (T, H, W, 3)/(T, H, W), like the reference (:106-115).
    Interactive key map (reference :273-290): N steps frames (with
    auto-capture when capture flags are set), U camera-true view,
    R reload render options, J/L/I/K rotate, W/S/A/D/X translate —
    and 'C', which the reference binds to capture_frame and then
    OVERWRITES with translate(-z); that final binding is reproduced
    (captures happen on frame steps).
    """

    def __init__(self, images, depths, camera,
                 vertices=None, faces=None, valid_vertices=None,
                 scene_mask=None, output_path=None,
                 capture_rendered_color: bool = False,
                 capture_rendered_depth: bool = False,
                 show_coordinate_axis: bool = True,
                 vis_color_list=DEFAULT_VIS_COLORS,
                 show_floor: bool = False,
                 floor_color=(0.2, 0.2, 0.2),
                 y1=-1, y2=-1, x1=-1, x2=1, z1=0, z2=4,
                 stride: int = 1, verbose: bool = True, **kw):
        super().__init__(camera, output_path=output_path,
                         **{k: v for k, v in kw.items()
                            if k == "renderoption_filename"})
        images = np.asarray(images)
        depths = np.asarray(depths)
        if images.ndim == 4 and depths.ndim == 3:
            self.multiple_scenes = True
            scenes = list(zip(images, depths))
        elif images.ndim == 3 and depths.ndim == 2:
            self.multiple_scenes = False
            scenes = [(images, depths)]
        else:
            raise ValueError(
                f"Invalid images/depths shape: {images.shape}, "
                f"{depths.shape}")
        if scene_mask is None:
            scene_mask = np.ones(scenes[0][1].shape, np.float32)
        self.scene_frames = [
            scene_pointcloud_arrays(im, de, scene_mask, camera["K"],
                                    stride)
            for im, de in scenes]

        self.verts = (None if vertices is None
                      else np.asarray(vertices))    # (T, N, V, 3)
        self.faces = None if faces is None else np.asarray(faces)
        if valid_vertices is None and self.verts is not None:
            valid_vertices = np.ones(self.verts.shape[:2] + (1,),
                                     np.float32)
        self.valid = (None if valid_vertices is None
                      else np.asarray(valid_vertices))
        self.max_frames = (len(self.verts) if self.verts is not None
                           else len(self.scene_frames))
        self.capture_rendered_color = capture_rendered_color
        self.capture_rendered_depth = capture_rendered_depth
        self.show_coordinate_axis = show_coordinate_axis
        self.colors = np.asarray(vis_color_list)
        self.show_floor = show_floor
        self.floor = dict(color=floor_color, y1=y1, y2=y2, x1=x1,
                          x2=x2, z1=z1, z2=z2)
        self.verbose = verbose

    # -- helpers --------------------------------------------------------
    def _scene_of(self, t):
        return self.scene_frames[t % len(self.scene_frames)]

    def frame_vertices(self, t):
        """Per-person vertices at frame t; invalid bodies are parked
        behind the camera (reference :249-252 dummy substitution)."""
        out = []
        for n in range(self.verts.shape[1]):
            v = self.verts[t, n]
            if self.valid is not None and self.valid[t, n, 0] <= 0.5:
                v = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32),
                            (len(v), 1))
            out.append(v)
        return out

    def capture_frame(self, t: Optional[int] = None):
        """Headless color/depth capture of frame t (defaults to the
        current frame)."""
        t = self.curr_frame if t is None else t
        pts, cols = self._scene_of(t)
        extra = None
        if self.verts is not None:
            bodies = [v for n, v in enumerate(self.frame_vertices(t))]
            extra = np.concatenate(bodies, axis=0)
            body_cols = np.concatenate([
                np.tile(self.colors[n % len(self.colors)], (len(b), 1))
                for n, b in enumerate(bodies)], axis=0)
            pts_all = np.concatenate([pts, extra], axis=0)
            cols_all = np.concatenate([cols, body_cols], axis=0)
        else:
            pts_all, cols_all = pts, cols
        self._headless_capture(pts_all, cols_all,
                               self.capture_rendered_color,
                               self.capture_rendered_depth)

    def step(self, capture: bool = True):
        """Advance one frame (the 'N' key), auto-capturing when the
        capture flags are set — the reference captures inside
        show_next_frame (:264). The o3d next_frame callbacks pass
        capture=False because they run their own Open3D buffer capture
        (:264,:181-203); the headless splat capture would double-write
        interleaved image indices."""
        self.curr_frame = (self.curr_frame + 1) % self.max_frames
        if self.verbose:
            print(f"frame {self.curr_frame}")
        if (capture and (self.capture_rendered_color
                         or self.capture_rendered_depth)
                and not getattr(self, "_in_o3d_run", False)):
            self.capture_frame()
        return self.curr_frame

    # -- headless path ---------------------------------------------------
    def export(self, out_dir: str, max_frames: Optional[int] = 10):
        os.makedirs(out_dir, exist_ok=True)
        self.output_path = os.path.realpath(out_dir)
        pts, cols = self._scene_of(0)
        write_ply_points(os.path.join(out_dir, "scene.ply"), pts, cols)
        T = self.max_frames if max_frames is None else min(
            self.max_frames, max_frames)
        for t in range(T):
            if self.verts is not None and self.faces is not None:
                for n, v in enumerate(self.frame_vertices(t)):
                    write_ply_mesh(
                        os.path.join(out_dir, f"human_{t:04d}_{n}.ply"),
                        v, self.faces)
            if self.capture_rendered_color or self.capture_rendered_depth:
                self.capture_frame(t)
        self.render_camera_view(
            os.path.join(out_dir, "camera_view_0000.png"), frame=0)
        return out_dir

    def render_camera_view(self, path: str, frame: int = 0):
        """Camera-true splat render via matplotlib (headless)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import jax.numpy as jnp
        from ..ops.cameras import project_points

        fig, ax = plt.subplots(figsize=(8, 8))
        pts, cols = self._scene_of(frame)
        uv = np.asarray(project_points(jnp.asarray(pts),
                                       jnp.asarray(self.K, jnp.float32)))
        ax.scatter(uv[:, 0], uv[:, 1], c=cols, s=1)
        if self.verts is not None:
            for n, v in enumerate(self.frame_vertices(frame)):
                vuv = np.asarray(project_points(
                    jnp.asarray(v), jnp.asarray(self.K, jnp.float32)))
                ax.scatter(vuv[:, 0], vuv[:, 1], s=1, alpha=0.5,
                           color=self.colors[n % len(self.colors)])
        W, H = self.window_size
        ax.set_xlim(0, W)
        ax.set_ylim(H, 0)
        ax.set_aspect("equal")
        fig.savefig(path, dpi=120)
        plt.close(fig)

    # -- interactive path -------------------------------------------------
    def run(self):  # pragma: no cover - needs a display + open3d
        if not HAVE_OPEN3D:
            raise RuntimeError(
                "Open3D is not installed; use export() for headless "
                "artifacts")
        self._in_o3d_run = True
        pts, cols = self._scene_of(0)
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(pts)
        pcd.colors = o3d.utility.Vector3dVector(cols)
        pcd.transform(FLIP_YZ)
        meshes = []
        if self.verts is not None and self.faces is not None:
            for n, v in enumerate(self.frame_vertices(0)):
                m = o3d.geometry.TriangleMesh()
                m.vertices = o3d.utility.Vector3dVector(v)
                m.triangles = o3d.utility.Vector3iVector(self.faces)
                m.compute_vertex_normals()
                m.paint_uniform_color(self.colors[n % len(self.colors)])
                m.transform(FLIP_YZ)
                meshes.append(m)

        vis = o3d.visualization.VisualizerWithKeyCallback()
        vis.create_window()
        vis.add_geometry(pcd)
        for m in meshes:
            vis.add_geometry(m)
        if self.show_coordinate_axis:
            axis = o3d.geometry.TriangleMesh.create_coordinate_frame()
            axis.transform(FLIP_YZ)
            vis.add_geometry(axis)
        if self.show_floor:
            f = self.floor
            fv = o3d.utility.Vector3dVector(np.array(
                [[f["x1"], f["y1"], f["z1"]], [f["x1"], f["y2"], f["z2"]],
                 [f["x2"], f["y2"], f["z2"]], [f["x2"], f["y1"], f["z1"]]]))
            ft = o3d.utility.Vector3iVector(
                np.array([[0, 3, 1], [1, 3, 2]]))
            floor = o3d.geometry.TriangleMesh(fv, ft)
            floor.paint_uniform_color(f["color"])
            floor.transform(FLIP_YZ)
            vis.add_geometry(floor)

        def next_frame(v):
            t = self.step(capture=False)   # _o3d_capture below instead
            if self.multiple_scenes:
                p, c = self._scene_of(t)
                pcd.points = o3d.utility.Vector3dVector(p)
                pcd.colors = o3d.utility.Vector3dVector(c)
                pcd.transform(FLIP_YZ)
                v.update_geometry(pcd)
            for n, m in enumerate(meshes):
                m.vertices = o3d.utility.Vector3dVector(
                    self.frame_vertices(t)[n])
                m.compute_vertex_normals()
                m.transform(FLIP_YZ)
                v.update_geometry(m)
            if self.capture_rendered_color or self.capture_rendered_depth:
                self._o3d_capture(v, self.capture_rendered_color,
                                  self.capture_rendered_depth)
            return True

        def rotate(dx, dy):
            def cb(v):
                v.get_view_control().rotate(dx, dy)
                return False
            return cb

        def translate(fw, right, up):
            def cb(v):
                v.get_view_control().camera_local_translate(
                    forward=fw, right=right, up=up)
                return False
            return cb

        vis.register_key_callback(ord("N"), next_frame)
        vis.register_key_callback(ord("U"), self._camera_true_view)
        vis.register_key_callback(ord("R"), self._load_render_option)
        vis.register_key_callback(ord("J"), rotate(1, 0))
        vis.register_key_callback(ord("L"), rotate(-1, 0))
        vis.register_key_callback(ord("I"), rotate(0, 1))
        vis.register_key_callback(ord("K"), rotate(0, -1))
        vis.register_key_callback(ord("W"), translate(0.01, 0, 0))
        vis.register_key_callback(ord("S"), translate(-0.01, 0, 0))
        vis.register_key_callback(ord("A"), translate(0, 0.01, 0))
        vis.register_key_callback(ord("D"), translate(0, -0.01, 0))
        vis.register_key_callback(ord("X"), translate(0, 0, 0.01))
        # the reference binds 'C' to capture and then overwrites it
        # with translate(-z) (visualization.py:274,:285) — final
        # binding reproduced; captures run on 'N'
        vis.register_key_callback(ord("C"), translate(0, 0, -0.01))
        try:
            vis.run()
        finally:
            vis.destroy_window()
            # re-enable step()-driven headless captures once
            # the interactive window is gone
            self._in_o3d_run = False


class SkeletonVisualizer(BaseVisualizer):
    """Per-frame 15-joint MuPoTs skeletons with optional GT overlay
    (reference visualization.py:655-844): colored prediction skeletons,
    gray GT skeletons paired through the eval Hungarian match list,
    optional flat backdrop image at a fixed distance, floor plane,
    N/U/R keys and color capture."""

    def __init__(self, camera, pred3d, pred_vis, pose_gt=None,
                 gt_vis=None, match_list=None, output_path=None,
                 capture_rendered_color: bool = False,
                 show_coordinate_axis: bool = False,
                 backimages=None, backdist: float = 6.0,
                 vis_color_list=DEFAULT_VIS_COLORS,
                 show_floor: bool = True,
                 floor_color=(0.2, 0.2, 0.2), radius: float = 0.03,
                 y1=-1, y2=-1, x1=-1, x2=1, z1=0, z2=4, **kw):
        super().__init__(camera, output_path=output_path,
                         **{k: v for k, v in kw.items()
                            if k == "renderoption_filename"})
        pred3d = np.asarray(pred3d)
        pred_vis = np.asarray(pred_vis)
        self.max_frames = len(pred3d)
        self.radius = radius
        self.colors = np.asarray(vis_color_list)
        self.capture_rendered_color = capture_rendered_color
        self.show_coordinate_axis = show_coordinate_axis
        self.show_floor = show_floor
        self.floor = dict(color=floor_color, y1=y1, y2=y2, x1=x1,
                          x2=x2, z1=z1, z2=z2)
        self.backimages = backimages
        self.backdist = backdist

        # per-frame skeleton arrays: [(points, links, color), ...]
        self.frames: List[List] = []
        for t in range(self.max_frames):
            skels = []
            if pose_gt is not None and gt_vis is not None:
                assert match_list is not None, \
                    "GT overlay needs the eval match list"
                gt_idx, pred_idx = match_list[t]
                for n, (pi, gi) in enumerate(zip(pred_idx, gt_idx)):
                    p, l, _ = mupots15_pose_arrays(
                        pred3d[t, pi], pred_vis[t, pi], thr=0.5)
                    skels.append((p, l,
                                  self.colors[n % len(self.colors)]))
                    g, gl, _ = mupots15_pose_arrays(
                        np.asarray(pose_gt)[t, gi],
                        np.asarray(gt_vis)[t, gi], thr=0.1)
                    skels.append((g, gl,
                                  np.array([0.25, 0.25, 0.25])))
            else:
                for n in range(pred3d.shape[1]):
                    p, l, _ = mupots15_pose_arrays(
                        pred3d[t, n], pred_vis[t, n], thr=0.5)
                    skels.append((p, l,
                                  self.colors[n % len(self.colors)]))
            self.frames.append(skels)

    def capture_frame(self, t: Optional[int] = None):
        """Headless color capture of frame t's skeletons."""
        t = self.curr_frame if t is None else t
        pts, cols = [], []
        for p, links, color in self.frames[t]:
            for a, b in links:
                if a == b:
                    continue
                seg = np.linspace(p[a], p[b], 12)
                pts.append(seg)
                cols.append(np.tile(color, (12, 1)))
        pts = (np.concatenate(pts, 0) if pts
               else np.zeros((0, 3), np.float32))
        cols = (np.concatenate(cols, 0) if cols
                else np.zeros((0, 3), np.float32))
        self._headless_capture(pts, cols, True, False)

    def step(self, capture: bool = True):
        self.curr_frame = (self.curr_frame + 1) % self.max_frames
        if (capture and self.capture_rendered_color
                and not getattr(self, "_in_o3d_run", False)):
            self.capture_frame()
        return self.curr_frame

    def export(self, out_dir: str, max_frames: Optional[int] = 10):
        os.makedirs(out_dir, exist_ok=True)
        self.output_path = os.path.realpath(out_dir)
        T = self.max_frames if max_frames is None else min(
            self.max_frames, max_frames)
        for t in range(T):
            pts, cols = [], []
            for p, links, color in self.frames[t]:
                for a, b in links:
                    if a == b:
                        continue
                    seg = np.linspace(p[a], p[b], 12)
                    pts.append(seg)
                    cols.append(np.tile(color, (12, 1)))
            if pts:
                write_ply_points(
                    os.path.join(out_dir, f"skeleton_{t:04d}.ply"),
                    np.concatenate(pts, 0), np.concatenate(cols, 0))
            if self.capture_rendered_color:
                self.capture_frame(t)
        return out_dir

    def run(self):  # pragma: no cover - needs a display + open3d
        if not HAVE_OPEN3D:
            raise RuntimeError(
                "Open3D is not installed; use export() for headless "
                "artifacts")
        self._in_o3d_run = True
        spheres, lines = [], []
        for p, l, color in self.frames[0]:
            ls = o3d.geometry.LineSet()
            ls.points = o3d.utility.Vector3dVector(p)
            ls.lines = o3d.utility.Vector2iVector(l)
            ls.colors = o3d.utility.Vector3dVector(
                np.tile(color, (len(l), 1)))
            ls.transform(FLIP_YZ)
            lines.append(ls)
            group = []
            for j in range(len(p)):
                s = o3d.geometry.TriangleMesh.create_sphere(
                    radius=self.radius, resolution=5)
                s.translate(p[j])
                s.paint_uniform_color(color)
                s.compute_vertex_normals()
                s.transform(FLIP_YZ)
                group.append(s)
            spheres.append(group)

        vis = o3d.visualization.VisualizerWithKeyCallback()
        vis.create_window()
        for group in spheres:
            for s in group:
                vis.add_geometry(s)
        for ls in lines:
            vis.add_geometry(ls)
        if self.backimages is not None:
            im = np.asarray(self.backimages)
            im0 = im[0] if im.ndim == 4 else im
            H, W = im0.shape[:2]
            pts, cols = scene_pointcloud_arrays(
                im0, self.backdist * np.ones((H, W), np.float32),
                np.ones((H, W), np.float32), self.cam["K"])
            pcd = o3d.geometry.PointCloud()
            pcd.points = o3d.utility.Vector3dVector(pts)
            pcd.colors = o3d.utility.Vector3dVector(cols)
            pcd.transform(FLIP_YZ)
            vis.add_geometry(pcd)
        if self.show_floor:
            f = self.floor
            fv = o3d.utility.Vector3dVector(np.array(
                [[f["x1"], f["y1"], f["z1"]], [f["x1"], f["y2"], f["z2"]],
                 [f["x2"], f["y2"], f["z2"]], [f["x2"], f["y1"], f["z1"]]]))
            ft = o3d.utility.Vector3iVector(
                np.array([[0, 3, 1], [1, 3, 2]]))
            floor = o3d.geometry.TriangleMesh(fv, ft)
            floor.paint_uniform_color(f["color"])
            floor.transform(FLIP_YZ)
            vis.add_geometry(floor)

        def next_frame(v):
            t = self.step(capture=False)   # _o3d_capture below instead
            for (p, l, _), ls, group in zip(self.frames[t], lines,
                                            spheres):
                ls.points = o3d.utility.Vector3dVector(p)
                ls.lines = o3d.utility.Vector2iVector(l)
                ls.transform(FLIP_YZ)
                v.update_geometry(ls)
                for j, s in enumerate(group):
                    s.translate(p[j], relative=False)
                    v.update_geometry(s)
            if self.capture_rendered_color:
                self._o3d_capture(v, True, False)
            return True

        vis.register_key_callback(ord("N"), next_frame)
        vis.register_key_callback(ord("U"), self._camera_true_view)
        vis.register_key_callback(ord("R"), self._load_render_option)
        try:
            vis.run()
        finally:
            vis.destroy_window()
            # re-enable step()-driven headless captures once
            # the interactive window is gone
            self._in_o3d_run = False


def write_default_renderoption(path: str = RENDEROPTION_PATH):
    """(Re)write the shipped RenderOption JSON (the contract of the
    reference's data/renderoption.json: an Open3D RenderOption dump
    loaded with the 'R' key)."""
    opt = {
        "class_name": "RenderOption",
        "version_major": 1,
        "version_minor": 0,
        "background_color": [1.0, 1.0, 1.0],
        "default_mesh_color": [0.7, 0.7, 0.7],
        "mesh_color_option": 1,
        "mesh_shade_option": 0,
        "mesh_show_back_face": False,
        "mesh_show_wireframe": False,
        "light_on": True,
        "light_ambient_color": [0.0, 0.0, 0.0],
        "point_color_option": 0,
        "point_show_normal": False,
        "point_size": 2.0,
        "line_width": 4.0,
        "show_coordinate_frame": False,
        "image_max_depth": 3000,
        "image_stretch_option": 0,
        "interpolation_option": 0,
    }
    with open(path, "w") as f:
        json.dump(opt, f, indent=2, sort_keys=True)
    return path
