"""Exercise the `_o3d_*` / `run()` Open3D wrapper paths of
viz/viewer3d.py with a mock open3d module (round-2 verdict weak #5:
Open3D is absent from CI, leaving the thin interactive wrappers
untested). The mock records every call so the tests can assert the
reference's key map, camera-true view math, render-option loading and
capture encoding without a display."""

import json
import os
import types

import numpy as np
import pytest
from PIL import Image

from mhmocap.viz import viewer3d as V


# ---------------------------------------------------------------------------
# Minimal open3d fake
# ---------------------------------------------------------------------------

class _Vec(list):
    def __init__(self, arr):
        super().__init__(np.asarray(arr).tolist())


class _Geometry:
    def __init__(self, *a):
        self.transforms = []
        self.color = None

    def transform(self, m):
        self.transforms.append(np.asarray(m))

    def paint_uniform_color(self, c):
        self.color = np.asarray(c)

    def compute_vertex_normals(self):
        pass

    def translate(self, p, relative=True):
        self.last_translate = (np.asarray(p), relative)


class _PointCloud(_Geometry):
    pass


class _TriangleMesh(_Geometry):
    @staticmethod
    def create_coordinate_frame(*a, **k):
        return _TriangleMesh()

    @staticmethod
    def create_sphere(radius=1.0, resolution=20):
        m = _TriangleMesh()
        m.radius = radius
        return m


class _LineSet(_Geometry):
    pass


class _Intrinsic:
    width, height = 640, 480

    def set_intrinsics(self, w, h, fx, fy, cx, cy):
        self.set = (w, h, fx, fy, cx, cy)


class _PinholeParams:
    def __init__(self):
        self.intrinsic = _Intrinsic()
        self.extrinsic = np.eye(4)


class _ViewControl:
    def __init__(self):
        self.rotations = []
        self.translations = []
        self.params_in = None

    def rotate(self, dx, dy):
        self.rotations.append((dx, dy))

    def camera_local_translate(self, forward=0, right=0, up=0):
        self.translations.append((forward, right, up))

    def convert_to_pinhole_camera_parameters(self):
        return _PinholeParams()

    def convert_from_pinhole_camera_parameters(self, p):
        self.params_in = p


class _RenderOption:
    def load_from_json(self, path):
        self.loaded = path
        json.load(open(path))          # must be valid JSON


class _FakeVis:
    def __init__(self):
        self.geometries = []
        self.updated = []
        self.callbacks = {}
        self.ctr = _ViewControl()
        self.ro = _RenderOption()
        self.ran = self.destroyed = False

    def create_window(self, *a, **k):
        pass

    def add_geometry(self, g):
        self.geometries.append(g)

    def update_geometry(self, g):
        self.updated.append(g)

    def register_key_callback(self, key, cb):
        self.callbacks[chr(key)] = cb

    def get_view_control(self):
        return self.ctr

    def get_render_option(self):
        return self.ro

    def capture_screen_float_buffer(self, *a):
        return 0.5 * np.ones((8, 8, 3), np.float32)

    def capture_depth_float_buffer(self, *a):
        return 2.5 * np.ones((8, 8), np.float32)

    def run(self):
        self.ran = True

    def destroy_window(self):
        self.destroyed = True


def _fake_o3d(created):
    def make_vis():
        v = _FakeVis()
        created.append(v)
        return v
    return types.SimpleNamespace(
        geometry=types.SimpleNamespace(
            PointCloud=_PointCloud, TriangleMesh=_TriangleMesh,
            LineSet=_LineSet),
        utility=types.SimpleNamespace(
            Vector3dVector=_Vec, Vector3iVector=_Vec,
            Vector2iVector=_Vec),
        visualization=types.SimpleNamespace(
            VisualizerWithKeyCallback=make_vis),
    )


@pytest.fixture
def o3d_mock(monkeypatch):
    created = []
    monkeypatch.setattr(V, "o3d", _fake_o3d(created))
    monkeypatch.setattr(V, "HAVE_OPEN3D", True)
    return created


# ---------------------------------------------------------------------------
# Shared fixtures (mirror tests/test_viewer3d.py)
# ---------------------------------------------------------------------------

def _camera(side=32):
    K = np.array([[side, 0, side / 2], [0, side, side / 2],
                  [0, 0, 1]], np.float32)
    return {"K": K, "image_size": (side, side)}


def _scene_viewer(tmp_path, **kw):
    img = np.full((32, 32, 3), 128, np.uint8)
    depth = np.full((32, 32), 4.0, np.float32)
    T, N = 3, 2
    verts = 0.1 * np.random.RandomState(0).randn(T, N, 8, 3) + \
        np.array([0, 0, 2.0])
    faces = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    return V.SceneHumansVisualizer(
        img, depth, _camera(), vertices=verts.astype(np.float32),
        faces=faces, output_path=str(tmp_path / "cap"),
        verbose=False, **kw)


def test_scene_run_registers_reference_key_map(tmp_path, o3d_mock):
    """The full reference key map (visualization.py:273-290) must be
    bound: N/U/R/J/L/I/K/W/S/A/D/X/C."""
    v = _scene_viewer(tmp_path)
    v.run()
    vis = o3d_mock[0]
    assert vis.ran and vis.destroyed
    assert set("NURJLIKWSADXC") <= set(vis.callbacks)

    # N steps the frame and updates the meshes
    t0 = v.curr_frame
    assert vis.callbacks["N"](vis) is True
    assert v.curr_frame == (t0 + 1) % v.max_frames
    assert len(vis.updated) >= 2          # both person meshes

    # J/L/I/K rotate, W/S/A/D/X/C translate through the view control
    vis.callbacks["J"](vis)
    vis.callbacks["I"](vis)
    assert vis.ctr.rotations == [(1, 0), (0, 1)]
    vis.callbacks["W"](vis)
    vis.callbacks["C"](vis)               # final binding: translate -z
    assert vis.ctr.translations == [(0.01, 0, 0), (0, 0, -0.01)]


def test_camera_true_view_sets_real_intrinsics(tmp_path, o3d_mock):
    """'U' (reference update_camera_callback :40-61): window-scaled
    focal lengths, centered principal point, FLIP_YZ extrinsic."""
    v = _scene_viewer(tmp_path)
    v.run()
    vis = o3d_mock[0]
    assert vis.callbacks["U"](vis) is False
    p = vis.ctr.params_in
    w, h, fx, fy, cx, cy = p.intrinsic.set
    assert (w, h) == (640, 480)
    K = _camera()["K"]
    np.testing.assert_allclose(fx, 640 * K[0, 0] / 32)
    np.testing.assert_allclose(fy, 480 * K[1, 1] / 32)
    np.testing.assert_allclose((cx, cy), (640 / 2 - 0.5, 480 / 2 - 0.5))
    np.testing.assert_array_equal(p.extrinsic, V.FLIP_YZ)


def test_render_option_reload(tmp_path, o3d_mock):
    """'R' loads the shipped RenderOption JSON (reference :33-38)."""
    v = _scene_viewer(tmp_path)
    v.run()
    vis = o3d_mock[0]
    assert vis.callbacks["R"](vis) is False
    assert vis.ro.loaded == V.RENDEROPTION_PATH


def test_o3d_capture_writes_color_and_mm_depth(tmp_path, o3d_mock):
    """_o3d_capture writes the reference capture contract
    (visualization.py:181-203): img_%06d.png uint8 color and
    depth_%06d.png uint16 millimeters."""
    v = _scene_viewer(tmp_path, capture_rendered_color=True,
                      capture_rendered_depth=True)
    os.makedirs(v.output_path, exist_ok=True)
    v.run()
    vis = o3d_mock[0]
    vis.callbacks["N"](vis)               # capture happens on step
    img = np.asarray(Image.open(
        os.path.join(v.output_path, "img_000000.png")))
    assert img.dtype == np.uint8 and img[0, 0, 0] == 127   # 255*0.5
    dep = np.asarray(Image.open(
        os.path.join(v.output_path, "depth_000000.png")))
    assert dep.dtype == np.uint16 and dep[0, 0] == 2500    # mm
    assert v.curr_image_index == 1


def test_skeleton_run_key_map_and_capture(tmp_path, o3d_mock):
    """SkeletonVisualizer.run binds N/U/R (reference :824-836) and
    captures color on step when enabled."""
    T, N = 2, 2
    pred = np.zeros((T, N, 17, 3), np.float32)
    pred[..., 2] = 3.0
    vis_j = np.ones((T, N, 17, 1), np.float32)
    sk = V.SkeletonVisualizer(_camera(), pred, vis_j,
                              output_path=str(tmp_path / "cap"),
                              capture_rendered_color=True)
    os.makedirs(sk.output_path, exist_ok=True)
    sk.run()
    fake = o3d_mock[0]
    assert fake.ran and fake.destroyed
    assert set("NUR") <= set(fake.callbacks)
    assert fake.callbacks["N"](fake) is True
    assert os.path.exists(
        os.path.join(sk.output_path, "img_000000.png"))
    # spheres were translated to the new frame positions (relative=False)
    moved = [g for g in fake.geometries
             if getattr(g, "last_translate", None) is not None]
    assert any(not rel for _, rel in
               (g.last_translate for g in moved))
