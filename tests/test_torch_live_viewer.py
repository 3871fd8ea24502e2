"""The port's live viewer (lgu_slam_tpu_torch/slam/live_viewer.py) and
the entry points that serve it: the JAX test's HTTP surface and versioned
snapshots (tests/test_live_viewer.py) on the port's incremental
reconstruction; every path answered as the JAX viewer answers it (status,
content type and body); ``/cloud`` bytes equal to
the JAX viewer's for the same numpy state, and the two packages'
incremental reconstructions of one staged video served alike; the demo
with ``--viewer`` on a JPEG image directory tracks the stream's frames and
serves its reconstruction; ``view_reconstruction_torch --serve`` serves
the saved one."""

import http.client
import importlib.util
import os
import struct

import numpy as np
import pytest
from test_lowmem import stage_video
from torch_port import (  # noqa: F401
    tiny_config_kwargs, torch_single_thread, video_from_jax)

from lgu_slam_tpu.slam.live_viewer import LiveViewer as JViewer
from lgu_slam_tpu.slam.visualization import (
    IncrementalReconstruction as JRecon,
)
from lgu_slam_tpu.utils.config import SLAMConfig as JConfig
from lgu_slam_tpu_torch.data import fixtures
from lgu_slam_tpu_torch.data.streams import image_stream
from lgu_slam_tpu_torch.slam.live_viewer import LiveViewer, free_port
from lgu_slam_tpu_torch.slam.visualization import IncrementalReconstruction
from lgu_slam_tpu_torch.utils.config import SLAMConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, r.getheader("Content-Type"), body


def _parse(body):
    ver, n, nc = struct.unpack_from("<III", body, 0)
    off = 12
    xyz = np.frombuffer(body, "<f4", n * 3, off).reshape(n, 3)
    off += n * 12
    rgb = np.frombuffer(body, "u1", n * 3, off).reshape(n, 3)
    off += n * 3
    cams = np.frombuffer(body, "<f4", nc * 12, off).reshape(nc, 12)
    assert off + nc * 48 == len(body)
    return ver, xyz, rgb, cams


def _staged(T=6, seed=1):
    """tests/test_live_viewer.py's staged video (disparities 0.5), in the
    JAX package and copied into a port Video on the CPU."""
    kw = dict(image_size=(64, 96), buffer=16)
    jv = stage_video(JConfig(**kw), T=T, seed=seed)
    jv.state = jv.state._replace(disps=jv.state.disps.at[:T].set(0.5))
    return jv, video_from_jax(jv, SLAMConfig(**kw))


def test_live_viewer_serves_and_versions():
    _, video = _staged()
    inc = IncrementalReconstruction(video, filter_thresh=10.0,
                                    filter_count=1)
    viewer = LiveViewer(inc, port=0)
    try:
        status, ctype, body = _get(viewer.port, "/")
        assert status == 200 and "text/html" in ctype
        assert b"webgl" in body

        status, _, body = _get(viewer.port, "/cloud")
        assert status == 200
        ver, xyz, _, cams = _parse(body)
        assert ver == 0 and len(xyz) == 0 and len(cams) == 0

        video.dirty[:4] = True
        assert viewer.refresh() == 4
        _, _, body = _get(viewer.port, "/cloud")
        ver1, xyz, rgb, cams = _parse(body)
        assert ver1 == 1 == viewer.version
        assert len(xyz) > 0 and len(rgb) == len(xyz) and len(cams) == 4
        assert np.isfinite(xyz).all() and np.isfinite(cams).all()

        assert _get(viewer.port, f"/cloud?have={ver1}")[0] == 304
        assert _get(viewer.port, "/cloud?have=0")[0] == 200

        assert viewer.refresh() == 0
        assert _parse(_get(viewer.port, "/cloud")[2])[0] == ver1

        video.dirty[4:6] = True
        assert viewer.refresh() == 2
        ver2, xyz2, _, cams2 = _parse(_get(viewer.port, "/cloud")[2])
        assert ver2 == 2 and len(cams2) == 6 and len(xyz2) >= len(xyz)
    finally:
        viewer.close()


class _Fixed:
    """The same numpy state for both packages' viewers: three frames with
    uint8, [0, 1] float and no colours, and their cameras."""

    def __init__(self, seed):
        rng = np.random.default_rng(seed)
        self.points = {
            0: (rng.normal(size=(50, 3)).astype(np.float32),
                rng.integers(0, 256, (50, 3)).astype(np.uint8)),
            2: (rng.normal(size=(7, 3)), rng.random((7, 3))),
            5: (rng.normal(size=(11, 3)).astype(np.float32), None)}
        q = rng.normal(size=(3, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        poses = np.concatenate([rng.normal(size=(3, 3)), q], 1)
        self.cameras = {f: poses[k].astype(np.float32)
                        for k, f in enumerate((5, 0, 2))}

    def update(self):
        return 1


def test_cloud_bytes_match_jax():
    """One numpy state, both viewers: the same /cloud bytes before and
    after a refresh.  Both packages' incremental reconstructions of one
    staged video: the same points (within 1e-5), colours and cameras."""
    port, ref = LiveViewer(_Fixed(3)), JViewer(_Fixed(3))
    try:
        for _ in range(2):
            got = _get(port.port, "/cloud")[2]
            assert got == _get(ref.port, "/cloud")[2]
            assert _parse(got)[1].shape == (68, 3)
            port.refresh()
            ref.refresh()
    finally:
        port.close()
        ref.close()

    jv, tv = _staged(T=5, seed=2)
    port = LiveViewer(IncrementalReconstruction(tv, filter_thresh=10.0,
                                                filter_count=1))
    ref = JViewer(JRecon(jv, filter_thresh=10.0, filter_count=1))
    try:
        jv.dirty[:5] = tv.dirty[:5] = True
        assert port.refresh() == ref.refresh() == 5
        got = _parse(_get(port.port, "/cloud")[2])
        want = _parse(_get(ref.port, "/cloud")[2])
        assert got[0] == want[0] == 1
        assert got[1].shape == want[1].shape and len(got[1]) > 0
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6, atol=1e-6)
    finally:
        port.close()
        ref.close()


ROUTES = ("/", "/nope", "/index.html", "/cloudy", "/cloud?x=1&have={v}",
          "/cloud?x=1&have={w}", "/cloudhave={v}", "/cloudhave={w}",
          "/cloud?have=x")


@pytest.mark.parametrize("refreshed", [False, True])
def test_routes_match_jax(refreshed):
    """Both viewers on the same numpy state answer every path alike:
    any path that starts with /cloud is the blob (304 where ``have=``,
    read anywhere in the path, is the version), every other one the
    page."""
    port, ref = LiveViewer(_Fixed(4)), JViewer(_Fixed(4))
    try:
        if refreshed:
            port.refresh()
            ref.refresh()
        assert port.version == ref._version
        for route in ROUTES:
            path = route.format(v=port.version, w=port.version + 1)
            got, want = _get(port.port, path), _get(ref.port, path)
            assert got == want, path
            assert got[0] == (304 if f"have={port.version}" in path
                              else 200)
    finally:
        port.close()
        ref.close()


@pytest.fixture(scope="module")
def demo_run(tmp_path_factory):
    """demo_torch --viewer on a JPEG image directory (8 frames of 64 x 96,
    the port's encoder) in tests/test_torch_demo.py's tiny fp32
    configuration, with the reconstruction saved."""
    root = tmp_path_factory.mktemp("jpegdir")
    imagedir, calib = fixtures.write_jpeg_imagedir(str(root), n_frames=8,
                                                   H=64, W=96, seed=3)
    demo = script("demo_torch")
    base, kw = demo.SLAMConfig, tiny_config_kwargs()
    kw.pop("image_size")
    kw.update(backend_edge_cap=8, backend_chunk=8)
    demo.SLAMConfig = lambda **k: base(**{**k, **kw})
    out = demo.main([
        "--imagedir", imagedir, "--calib", calib, "--stride", "1",
        "--target_pixels", str(64 * 96), "--buffer", "24",
        "--filter_thresh", "0", "--keyframe_thresh", "0", "--warmup", "5",
        "--frontend_window", "8", "--viewer", "--viewer_port",
        str(free_port()), "--trajectory_path", str(root / "traj.txt"),
        "--reconstruction_path", str(root / "rec.npz"), "--device", "cpu"])
    yield out, imagedir, calib, root
    out["viewer"].close()


def test_demo_viewer_on_jpeg_directory(demo_run):
    """The demo tracks every frame of the JPEG stream, and its viewer,
    still up, serves the page and the reconstruction: the version advanced
    with each refresh, one camera per keyframe, the points of the
    incremental reconstruction."""
    out, imagedir, calib, _ = demo_run
    stream = list(image_stream(imagedir, calib, 1, target_pixels=64 * 96))
    assert out["tstamps"] == [item[0] for item in stream]
    assert stream[0][1].shape == (64, 96, 3)
    viewer, inc = out["viewer"], out["reconstruction"]
    assert "view" in out["phases"]
    status, ctype, body = _get(viewer.port, "/")
    assert status == 200 and b"webgl" in body
    ver, xyz, rgb, cams = _parse(_get(viewer.port, "/cloud")[2])
    assert ver == viewer.version >= 2
    assert len(cams) == len(inc.cameras) == inc.video.counter > 0
    # random weights: the multi-view filter may keep no point at all
    assert len(xyz) == len(rgb) == sum(len(p) for p, _ in
                                        inc.points.values())
    assert np.isfinite(xyz).all()
    assert _get(viewer.port, "/nope")[2] == body


def test_view_reconstruction_serves(demo_run, monkeypatch):
    """view_reconstruction_torch --serve on the demo's reconstruction:
    the filtered cloud it would write, and the keyframes' cameras."""
    _, _, _, root = demo_run
    view = script("view_reconstruction_torch")
    served = []

    def wait(viewer):
        served.append(_parse(_get(viewer.port, "/cloud")[2]))
        viewer.close()
    monkeypatch.setattr(view, "wait", wait)
    n = view.main(["--reconstruction", str(root / "rec.npz"), "--serve",
                   "--port", str(free_port()), "--device", "cpu"])
    ver, xyz, rgb, cams = served[0]
    rec = np.load(root / "rec.npz")
    assert ver == 0 and len(xyz) == n and len(cams) == len(rec["poses"])
    assert view.main(["--reconstruction", str(root / "rec.npz"), "--out",
                      str(root / "r.ply"), "--device", "cpu"]) == n
