"""Offline 3D viewer + HUD: the Pangolin-viewer equivalent, headless.

Port of `vslam_tpu/viz/viewer.py`. The reference runs a live Pangolin
window (trajectory line, keyframe frustums, an EMA-smoothed current
frustum, height-coloured dense points, cyan sparse points, follow / top /
side camera modes) with an OpenCV HUD of match statistics; the JAX package
renders the same content with matplotlib to PNG frames. The card's Python
has no matplotlib, so the port splits `render_scene` in two:

- `Viewer.build_scene`: the geometry the JAX package hands to matplotlib,
  in its plot axes (x, z, -y): line strips with their colour and width,
  point sets with per-point RGBA colours (viridis by height, from a
  256-entry table copied here), the view's elevation / azimuth and the
  follow-camera limits;
- `rasterize`: draws a scene with cv2 on a black canvas, projecting
  through the same elevation and azimuth (an orthographic view of the
  axes box), with the HUD text top-left.

`render_run` renders a RunResult to PNG frames, as the JAX package's.
Also here: `hud_text` and `loop_edges_from_state`, which the web viewer
uses.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

# The StepOutputs fields `hud_text` reads.
HUD_FIELDS = ("num_matches", "num_inliers", "num_tracked", "epi_before", "epi_after",
              "used_3d3d", "is_keyframe", "tracking_ok", "bridged", "recovered")

# matplotlib's named colours the JAX viewer draws with, as RGB in [0, 1].
COLORS = {
    "lime": (0.0, 1.0, 0.0), "orange": (1.0, 0.6470588235294118, 0.0),
    "deepskyblue": (0.0, 0.7490196078431373, 1.0), "red": (1.0, 0.0, 0.0),
    "cyan": (0.0, 1.0, 1.0), "magenta": (1.0, 0.0, 1.0), "white": (1.0, 1.0, 1.0),
}

# matplotlib's viridis colormap: its 256 listed RGB entries.
VIRIDIS = np.array([
    (0.267004, 0.004874, 0.329415),
    (0.26851, 0.009605, 0.335427),
    (0.269944, 0.014625, 0.341379),
    (0.271305, 0.019942, 0.347269),
    (0.272594, 0.025563, 0.353093),
    (0.273809, 0.031497, 0.358853),
    (0.274952, 0.037752, 0.364543),
    (0.276022, 0.044167, 0.370164),
    (0.277018, 0.050344, 0.375715),
    (0.277941, 0.056324, 0.381191),
    (0.278791, 0.062145, 0.386592),
    (0.279566, 0.067836, 0.391917),
    (0.280267, 0.073417, 0.397163),
    (0.280894, 0.078907, 0.402329),
    (0.281446, 0.08432, 0.407414),
    (0.281924, 0.089666, 0.412415),
    (0.282327, 0.094955, 0.417331),
    (0.282656, 0.100196, 0.42216),
    (0.28291, 0.105393, 0.426902),
    (0.283091, 0.110553, 0.431554),
    (0.283197, 0.11568, 0.436115),
    (0.283229, 0.120777, 0.440584),
    (0.283187, 0.125848, 0.44496),
    (0.283072, 0.130895, 0.449241),
    (0.282884, 0.13592, 0.453427),
    (0.282623, 0.140926, 0.457517),
    (0.28229, 0.145912, 0.46151),
    (0.281887, 0.150881, 0.465405),
    (0.281412, 0.155834, 0.469201),
    (0.280868, 0.160771, 0.472899),
    (0.280255, 0.165693, 0.476498),
    (0.279574, 0.170599, 0.479997),
    (0.278826, 0.17549, 0.483397),
    (0.278012, 0.180367, 0.486697),
    (0.277134, 0.185228, 0.489898),
    (0.276194, 0.190074, 0.493001),
    (0.275191, 0.194905, 0.496005),
    (0.274128, 0.199721, 0.498911),
    (0.273006, 0.20452, 0.501721),
    (0.271828, 0.209303, 0.504434),
    (0.270595, 0.214069, 0.507052),
    (0.269308, 0.218818, 0.509577),
    (0.267968, 0.223549, 0.512008),
    (0.26658, 0.228262, 0.514349),
    (0.265145, 0.232956, 0.516599),
    (0.263663, 0.237631, 0.518762),
    (0.262138, 0.242286, 0.520837),
    (0.260571, 0.246922, 0.522828),
    (0.258965, 0.251537, 0.524736),
    (0.257322, 0.25613, 0.526563),
    (0.255645, 0.260703, 0.528312),
    (0.253935, 0.265254, 0.529983),
    (0.252194, 0.269783, 0.531579),
    (0.250425, 0.27429, 0.533103),
    (0.248629, 0.278775, 0.534556),
    (0.246811, 0.283237, 0.535941),
    (0.244972, 0.287675, 0.53726),
    (0.243113, 0.292092, 0.538516),
    (0.241237, 0.296485, 0.539709),
    (0.239346, 0.300855, 0.540844),
    (0.237441, 0.305202, 0.541921),
    (0.235526, 0.309527, 0.542944),
    (0.233603, 0.313828, 0.543914),
    (0.231674, 0.318106, 0.544834),
    (0.229739, 0.322361, 0.545706),
    (0.227802, 0.326594, 0.546532),
    (0.225863, 0.330805, 0.547314),
    (0.223925, 0.334994, 0.548053),
    (0.221989, 0.339161, 0.548752),
    (0.220057, 0.343307, 0.549413),
    (0.21813, 0.347432, 0.550038),
    (0.21621, 0.351535, 0.550627),
    (0.214298, 0.355619, 0.551184),
    (0.212395, 0.359683, 0.55171),
    (0.210503, 0.363727, 0.552206),
    (0.208623, 0.367752, 0.552675),
    (0.206756, 0.371758, 0.553117),
    (0.204903, 0.375746, 0.553533),
    (0.203063, 0.379716, 0.553925),
    (0.201239, 0.38367, 0.554294),
    (0.19943, 0.387607, 0.554642),
    (0.197636, 0.391528, 0.554969),
    (0.19586, 0.395433, 0.555276),
    (0.1941, 0.399323, 0.555565),
    (0.192357, 0.403199, 0.555836),
    (0.190631, 0.407061, 0.556089),
    (0.188923, 0.41091, 0.556326),
    (0.187231, 0.414746, 0.556547),
    (0.185556, 0.41857, 0.556753),
    (0.183898, 0.422383, 0.556944),
    (0.182256, 0.426184, 0.55712),
    (0.180629, 0.429975, 0.557282),
    (0.179019, 0.433756, 0.55743),
    (0.177423, 0.437527, 0.557565),
    (0.175841, 0.44129, 0.557685),
    (0.174274, 0.445044, 0.557792),
    (0.172719, 0.448791, 0.557885),
    (0.171176, 0.45253, 0.557965),
    (0.169646, 0.456262, 0.55803),
    (0.168126, 0.459988, 0.558082),
    (0.166617, 0.463708, 0.558119),
    (0.165117, 0.467423, 0.558141),
    (0.163625, 0.471133, 0.558148),
    (0.162142, 0.474838, 0.55814),
    (0.160665, 0.47854, 0.558115),
    (0.159194, 0.482237, 0.558073),
    (0.157729, 0.485932, 0.558013),
    (0.15627, 0.489624, 0.557936),
    (0.154815, 0.493313, 0.55784),
    (0.153364, 0.497, 0.557724),
    (0.151918, 0.500685, 0.557587),
    (0.150476, 0.504369, 0.55743),
    (0.149039, 0.508051, 0.55725),
    (0.147607, 0.511733, 0.557049),
    (0.14618, 0.515413, 0.556823),
    (0.144759, 0.519093, 0.556572),
    (0.143343, 0.522773, 0.556295),
    (0.141935, 0.526453, 0.555991),
    (0.140536, 0.530132, 0.555659),
    (0.139147, 0.533812, 0.555298),
    (0.13777, 0.537492, 0.554906),
    (0.136408, 0.541173, 0.554483),
    (0.135066, 0.544853, 0.554029),
    (0.133743, 0.548535, 0.553541),
    (0.132444, 0.552216, 0.553018),
    (0.131172, 0.555899, 0.552459),
    (0.129933, 0.559582, 0.551864),
    (0.128729, 0.563265, 0.551229),
    (0.127568, 0.566949, 0.550556),
    (0.126453, 0.570633, 0.549841),
    (0.125394, 0.574318, 0.549086),
    (0.124395, 0.578002, 0.548287),
    (0.123463, 0.581687, 0.547445),
    (0.122606, 0.585371, 0.546557),
    (0.121831, 0.589055, 0.545623),
    (0.121148, 0.592739, 0.544641),
    (0.120565, 0.596422, 0.543611),
    (0.120092, 0.600104, 0.54253),
    (0.119738, 0.603785, 0.5414),
    (0.119512, 0.607464, 0.540218),
    (0.119423, 0.611141, 0.538982),
    (0.119483, 0.614817, 0.537692),
    (0.119699, 0.61849, 0.536347),
    (0.120081, 0.622161, 0.534946),
    (0.120638, 0.625828, 0.533488),
    (0.12138, 0.629492, 0.531973),
    (0.122312, 0.633153, 0.530398),
    (0.123444, 0.636809, 0.528763),
    (0.12478, 0.640461, 0.527068),
    (0.126326, 0.644107, 0.525311),
    (0.128087, 0.647749, 0.523491),
    (0.130067, 0.651384, 0.521608),
    (0.132268, 0.655014, 0.519661),
    (0.134692, 0.658636, 0.517649),
    (0.137339, 0.662252, 0.515571),
    (0.14021, 0.665859, 0.513427),
    (0.143303, 0.669459, 0.511215),
    (0.146616, 0.67305, 0.508936),
    (0.150148, 0.676631, 0.506589),
    (0.153894, 0.680203, 0.504172),
    (0.157851, 0.683765, 0.501686),
    (0.162016, 0.687316, 0.499129),
    (0.166383, 0.690856, 0.496502),
    (0.170948, 0.694384, 0.493803),
    (0.175707, 0.6979, 0.491033),
    (0.180653, 0.701402, 0.488189),
    (0.185783, 0.704891, 0.485273),
    (0.19109, 0.708366, 0.482284),
    (0.196571, 0.711827, 0.479221),
    (0.202219, 0.715272, 0.476084),
    (0.20803, 0.718701, 0.472873),
    (0.214, 0.722114, 0.469588),
    (0.220124, 0.725509, 0.466226),
    (0.226397, 0.728888, 0.462789),
    (0.232815, 0.732247, 0.459277),
    (0.239374, 0.735588, 0.455688),
    (0.24607, 0.73891, 0.452024),
    (0.252899, 0.742211, 0.448284),
    (0.259857, 0.745492, 0.444467),
    (0.266941, 0.748751, 0.440573),
    (0.274149, 0.751988, 0.436601),
    (0.281477, 0.755203, 0.432552),
    (0.288921, 0.758394, 0.428426),
    (0.296479, 0.761561, 0.424223),
    (0.304148, 0.764704, 0.419943),
    (0.311925, 0.767822, 0.415586),
    (0.319809, 0.770914, 0.411152),
    (0.327796, 0.77398, 0.40664),
    (0.335885, 0.777018, 0.402049),
    (0.344074, 0.780029, 0.397381),
    (0.35236, 0.783011, 0.392636),
    (0.360741, 0.785964, 0.387814),
    (0.369214, 0.788888, 0.382914),
    (0.377779, 0.791781, 0.377939),
    (0.386433, 0.794644, 0.372886),
    (0.395174, 0.797475, 0.367757),
    (0.404001, 0.800275, 0.362552),
    (0.412913, 0.803041, 0.357269),
    (0.421908, 0.805774, 0.35191),
    (0.430983, 0.808473, 0.346476),
    (0.440137, 0.811138, 0.340967),
    (0.449368, 0.813768, 0.335384),
    (0.458674, 0.816363, 0.329727),
    (0.468053, 0.818921, 0.323998),
    (0.477504, 0.821444, 0.318195),
    (0.487026, 0.823929, 0.312321),
    (0.496615, 0.826376, 0.306377),
    (0.506271, 0.828786, 0.300362),
    (0.515992, 0.831158, 0.294279),
    (0.525776, 0.833491, 0.288127),
    (0.535621, 0.835785, 0.281908),
    (0.545524, 0.838039, 0.275626),
    (0.555484, 0.840254, 0.269281),
    (0.565498, 0.84243, 0.262877),
    (0.575563, 0.844566, 0.256415),
    (0.585678, 0.846661, 0.249897),
    (0.595839, 0.848717, 0.243329),
    (0.606045, 0.850733, 0.236712),
    (0.616293, 0.852709, 0.230052),
    (0.626579, 0.854645, 0.223353),
    (0.636902, 0.856542, 0.21662),
    (0.647257, 0.8584, 0.209861),
    (0.657642, 0.860219, 0.203082),
    (0.668054, 0.861999, 0.196293),
    (0.678489, 0.863742, 0.189503),
    (0.688944, 0.865448, 0.182725),
    (0.699415, 0.867117, 0.175971),
    (0.709898, 0.868751, 0.169257),
    (0.720391, 0.87035, 0.162603),
    (0.730889, 0.871916, 0.156029),
    (0.741388, 0.873449, 0.149561),
    (0.751884, 0.874951, 0.143228),
    (0.762373, 0.876424, 0.137064),
    (0.772852, 0.877868, 0.131109),
    (0.783315, 0.879285, 0.125405),
    (0.79376, 0.880678, 0.120005),
    (0.804182, 0.882046, 0.114965),
    (0.814576, 0.883393, 0.110347),
    (0.82494, 0.88472, 0.106217),
    (0.83527, 0.886029, 0.102646),
    (0.845561, 0.887322, 0.099702),
    (0.85581, 0.888601, 0.097452),
    (0.866013, 0.889868, 0.095953),
    (0.876168, 0.891125, 0.09525),
    (0.886271, 0.892374, 0.095374),
    (0.89632, 0.893616, 0.096335),
    (0.906311, 0.894855, 0.098125),
    (0.916242, 0.896091, 0.100717),
    (0.926106, 0.89733, 0.104071),
    (0.935904, 0.89857, 0.108131),
    (0.945636, 0.899815, 0.112838),
    (0.9553, 0.901065, 0.118128),
    (0.964894, 0.902323, 0.123941),
    (0.974417, 0.90359, 0.130215),
    (0.983868, 0.904867, 0.136897),
    (0.993248, 0.906157, 0.143936),
])


@dataclass
class ViewerConfig:
    width: int = 1024
    height: int = 768
    follow: bool = True  # follow-camera (Viewer.cpp:402-437)
    mode: str = "free"  # free | top | side (UI buttons, Viewer.cpp:60-66)
    show_dense: bool = True
    show_sparse: bool = True
    frustum_scale: float = 0.15
    ema_alpha: float = 0.15  # current-frustum smoothing (Viewer.cpp:244-253)
    trajectory_scale: float = 1.0
    max_points_drawn: int = 60000


def _frustum_lines(R, t, scale):
    """Camera frustum wireframe segments (world frame)."""
    w, h, z = 0.8 * scale, 0.6 * scale, 1.0 * scale
    corners = np.array([[0, 0, 0], [w, h, z], [-w, h, z], [-w, -h, z], [w, -h, z]],
                       dtype=np.float32)
    pts = corners @ R.T + t
    segs = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4), (4, 1)]
    return [(pts[a], pts[b]) for a, b in segs]


def viridis(x):
    """matplotlib's `cm.viridis(x)` for floats in [0, 1]: RGBA (..., 4)
    from the 256-entry table (index floor(x * 256), 1.0 -> 255)."""
    xa = np.array(x, dtype=np.float64) * 256
    xa[xa == 256] = 255
    idx = np.clip(xa, -1, 256).astype(int)
    idx = np.clip(idx, 0, 255)
    rgb = VIRIDIS[idx]
    return np.concatenate([rgb, np.ones(rgb.shape[:-1] + (1,))], axis=-1)


def _height_colors(y):
    """Height-based colour ramp (viridis, Viewer.cpp:328-344)."""
    lo, hi = np.percentile(y, 5), np.percentile(y, 95)
    tt = np.clip((y - lo) / max(hi - lo, 1e-6), 0, 1)
    return viridis(1.0 - tt)


def _plot_axes(p):
    """World points (..., 3) -> the viewer's plot axes (x, z, -y)."""
    p = np.asarray(p)
    return np.stack([p[..., 0], p[..., 2], -p[..., 1]], axis=-1)


@dataclass
class Scene:
    """What one frame draws, in plot axes: `lines` of (points (n, 3), RGB,
    width), `points` of (xyz (n, 3), RGB or RGBA per point (n, 3|4) or one
    RGB, size), the view (elevation, azimuth in degrees), the follow
    limits (or None) and the HUD lines."""

    lines: List[Tuple[np.ndarray, tuple, float]] = field(default_factory=list)
    points: List[Tuple[np.ndarray, np.ndarray, float]] = field(default_factory=list)
    elev: float = 25.0
    azim: float = -60.0
    limits: Optional[Tuple[tuple, tuple, tuple]] = None
    hud_lines: Tuple[str, ...] = ()


@dataclass
class Viewer:
    config: ViewerConfig = field(default_factory=ViewerConfig)
    _ema_R: Optional[np.ndarray] = None
    _ema_t: Optional[np.ndarray] = None

    def build_scene(self, trajectory, cur_R=None, cur_t=None, kf_R=None, kf_t=None,
                    dense_xyz=None, dense_rgb=None, sparse_xyz=None, gt_trajectory=None,
                    loop_edges=None, hud_lines=()) -> Scene:
        """The scene of one frame, as the JAX package's `render_scene`
        builds it (and advances the current frustum's EMA)."""
        cfg = self.config
        sc = Scene(hud_lines=tuple(hud_lines))
        traj = np.asarray(trajectory) * cfg.trajectory_scale
        if len(traj):
            sc.lines.append((_plot_axes(traj), COLORS["lime"], 1.2))
        if gt_trajectory is not None:
            g = np.asarray(gt_trajectory) * cfg.trajectory_scale
            sc.lines.append((_plot_axes(g), COLORS["orange"], 0.8))
        if kf_R is not None and kf_t is not None:
            for R, t in zip(np.asarray(kf_R), np.asarray(kf_t)):
                for a, b in _frustum_lines(R, t, cfg.frustum_scale * 0.6):
                    sc.lines.append((_plot_axes(np.stack([a, b])), COLORS["deepskyblue"], 0.5))
        if cur_R is not None and cur_t is not None:
            cur_R, cur_t = np.asarray(cur_R), np.asarray(cur_t)
            if self._ema_R is None:
                self._ema_R, self._ema_t = cur_R, cur_t
            a = cfg.ema_alpha
            self._ema_t = (1 - a) * self._ema_t + a * cur_t
            self._ema_R = cur_R  # rotation snaps (visual nicety only)
            for p, q in _frustum_lines(self._ema_R, self._ema_t, cfg.frustum_scale):
                sc.lines.append((_plot_axes(np.stack([p, q])), COLORS["red"], 1.5))
        if cfg.show_dense and dense_xyz is not None and len(dense_xyz):
            d = np.asarray(dense_xyz)
            if len(d) > cfg.max_points_drawn:
                sel = np.random.default_rng(0).choice(len(d), cfg.max_points_drawn, replace=False)
                d = d[sel]
                dense_rgb = None if dense_rgb is None else np.asarray(dense_rgb)[sel]
            colors = (np.asarray(dense_rgb) / 255.0 if dense_rgb is not None
                      else _height_colors(-d[:, 1]))
            sc.points.append((_plot_axes(d), colors, 0.3))
        if cfg.show_sparse and sparse_xyz is not None and len(sparse_xyz):
            s = np.asarray(sparse_xyz)
            if len(s) > cfg.max_points_drawn:
                s = s[np.random.default_rng(1).choice(len(s), cfg.max_points_drawn, replace=False)]
            sc.points.append((_plot_axes(s), np.array(COLORS["cyan"]), 0.8))
        if loop_edges is not None:
            for p, q in loop_edges:
                sc.lines.append((_plot_axes(np.stack([p, q])), COLORS["magenta"], 1.0))
        if cfg.mode == "top":
            sc.elev, sc.azim = 89.0, -90.0
        elif cfg.mode == "side":
            sc.elev, sc.azim = 0.0, -90.0
        if cfg.follow and cur_t is not None:
            c, r = np.asarray(cur_t), 3.0
            sc.limits = ((c[0] - r, c[0] + r), (c[2] - r, c[2] + r), (-c[1] - r, -c[1] + r))
        return sc

    def render_scene(self, trajectory, cur_R=None, cur_t=None, kf_R=None, kf_t=None,
                     dense_xyz=None, dense_rgb=None, sparse_xyz=None, gt_trajectory=None,
                     loop_edges=None, hud_lines=(), out_path=None):
        """Render one frame: the RGB image (H, W, 3) uint8, or the path of
        the PNG written to `out_path`."""
        sc = self.build_scene(trajectory, cur_R, cur_t, kf_R, kf_t, dense_xyz, dense_rgb,
                              sparse_xyz, gt_trajectory, loop_edges, hud_lines)
        img = rasterize(sc, self.config.width, self.config.height)
        if out_path:
            import cv2

            if not cv2.imwrite(out_path, img[..., ::-1]):
                raise OSError(f"could not write {out_path}")
            return out_path
        return img


def _view_matrix(elev, azim):
    """Plot axes -> (screen x, screen y up, depth) for a camera at
    elevation `elev` and azimuth `azim` (degrees), as matplotlib's 3D axes
    place their eye."""
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    eye = np.array([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)])
    right = np.array([-np.sin(a), np.cos(a), 0.0])
    up = np.cross(eye, right)
    return np.stack([right, up, eye])


def rasterize(scene: Scene, width: int, height: int) -> np.ndarray:
    """Draw `scene` with cv2 (anti-aliased lines, point splats, HUD text) on
    a black RGB canvas: an orthographic view of the limits' box (or of
    everything drawn) along the scene's elevation and azimuth."""
    import cv2

    img = np.zeros((height, width, 3), np.uint8)
    V = _view_matrix(scene.elev, scene.azim)
    pts = [p for p, _, _ in scene.lines] + [p for p, _, _ in scene.points]
    if scene.limits is not None:
        lo = np.array([lim[0] for lim in scene.limits])
        hi = np.array([lim[1] for lim in scene.limits])
    elif pts:
        allp = np.concatenate([p.reshape(-1, 3) for p in pts])
        lo, hi = allp.min(0), allp.max(0)
    else:
        lo, hi = -np.ones(3), np.ones(3)
    ctr = (lo + hi) / 2.0
    box = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                    for z in (lo[2], hi[2])]) - ctr
    ext = np.abs(box @ V[:2].T).max(0)
    scale = 0.9 * min(width / max(2 * ext[0], 1e-9), height / max(2 * ext[1], 1e-9))

    def to_px(p):
        s = (np.asarray(p, np.float64).reshape(-1, 3) - ctr) @ V[:2].T
        return np.stack([width / 2 + scale * s[:, 0], height / 2 - scale * s[:, 1]], -1)

    def rgb255(rgb):
        return tuple(int(round(255 * float(c))) for c in rgb[:3])

    for xyz, rgb, size in scene.points:
        px = np.round(to_px(xyz)).astype(np.int64)
        cols = np.asarray(rgb, np.float64)
        cols = np.broadcast_to(cols[..., :3], (len(px), 3)) if cols.ndim == 1 else cols[:, :3]
        ok = (px[:, 0] >= 0) & (px[:, 0] < width) & (px[:, 1] >= 0) & (px[:, 1] < height)
        c8 = np.clip(np.round(cols[ok] * 255), 0, 255).astype(np.uint8)
        r = max(int(round(size)), 0)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                y = np.clip(px[ok, 1] + dy, 0, height - 1)
                x = np.clip(px[ok, 0] + dx, 0, width - 1)
                img[y, x] = c8
    for xyz, rgb, lw in scene.lines:
        px = np.round(to_px(xyz)).astype(np.int32)
        if len(px) >= 2 and np.all(np.abs(px) < 1 << 20):
            cv2.polylines(img, [px.reshape(-1, 1, 2)], False, rgb255(rgb),
                          thickness=max(int(round(lw)), 1), lineType=cv2.LINE_AA)
    for i, line in enumerate(scene.hud_lines):
        cv2.putText(img, line, (8, 20 + 20 * i), cv2.FONT_HERSHEY_PLAIN, 1.1,
                    (255, 255, 255), 1, cv2.LINE_AA)
    return img


def hud_text(outputs, i):
    """Per-frame HUD lines from StepOutputs diagnostics (host numpy
    fields; `src/main.cpp:1220-1260`): counters, epipolar error
    before/after the fundamental gate, backend label, and event badges."""
    o = outputs
    lines = [
        f"frame {i}",
        f"matches  {int(np.asarray(o.num_matches)[i])}",
        f"inliers  {int(np.asarray(o.num_inliers)[i])}",
        f"tracked  {int(np.asarray(o.num_tracked)[i])}",
        f"epi err  {float(np.asarray(o.epi_before)[i]):.2f} -> "
        f"{float(np.asarray(o.epi_after)[i]):.2f} px",
        f"backend  {'3D-3D' if bool(np.asarray(o.used_3d3d)[i]) else 'E-matrix'}",
        f"keyframe {'YES' if bool(np.asarray(o.is_keyframe)[i]) else 'no'}",
        f"tracking {'OK' if bool(np.asarray(o.tracking_ok)[i]) else 'LOST'}",
    ]
    if bool(np.asarray(o.bridged)[i]):
        lines.append("BRIDGE KF")
    if bool(np.asarray(o.recovered)[i]):
        lines.append("PNP RECOVERY")
    return lines


def _host(x):
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def loop_edges_from_state(st):
    """Loop-closure edge segments (world positions of the two keyframe
    endpoints) from the tracked state's constraint ring; the reference
    implements `draw_loop_edges` (`src/Viewer.cpp:76-130`) but never calls
    it; here the edges render whenever constraints exist."""
    kf_t = _host(st.keyframes.t)
    kf_valid = _host(st.keyframes.valid)
    edges = []
    for a, b, v in zip(_host(st.loops.kf_from), _host(st.loops.kf_to), _host(st.loops.valid)):
        if v and 0 <= a < len(kf_t) and 0 <= b < len(kf_t):
            if kf_valid[a] and kf_valid[b]:
                edges.append((kf_t[a], kf_t[b]))
    return edges


def render_run(result, out_dir, every=10, seq=None, dense=None, config=None):
    """Render a RunResult to PNG frames (one per `every` frames); returns
    the list of file paths. The final state and the HUD fields are read
    back to the host once."""
    from types import SimpleNamespace

    os.makedirs(out_dir, exist_ok=True)
    viewer = Viewer(config or ViewerConfig())
    st = result.final_state
    kf_valid = _host(st.keyframes.valid)
    kf_R = _host(st.keyframes.R)[kf_valid]
    kf_t = _host(st.keyframes.t)[kf_valid]
    sparse = _host(st.map.pos)[_host(st.map.valid)]
    loop_edges = loop_edges_from_state(st) or None
    hud = SimpleNamespace(**{k: _host(getattr(result.outputs, k)) for k in HUD_FIELDS})
    R, t_s = _host(result.R), _host(result.t_smoothed)
    paths = []
    for i in range(0, t_s.shape[0], every):
        p = os.path.join(out_dir, f"frame_{i:05d}.png")
        viewer.render_scene(
            t_s[: i + 1], cur_R=R[i], cur_t=t_s[i], kf_R=kf_R, kf_t=kf_t, sparse_xyz=sparse,
            dense_xyz=None if dense is None else dense[0],
            dense_rgb=None if dense is None else dense[1],
            gt_trajectory=None if seq is None else seq.t[: i + 1],
            loop_edges=loop_edges, hud_lines=hud_text(hud, i), out_path=p)
        paths.append(p)
    return paths
