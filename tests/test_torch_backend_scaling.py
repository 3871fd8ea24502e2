"""scripts/bench_backend_scaling_torch.py (the port's sharded-backend
scaling measurement) against scripts/bench_backend_scaling.py's
construction, rebuilt here from its lines 51-82 (the graph is a closure of
its ``main``, which cannot be imported): at t = 8 with the JAX weights
bridged by ``utils/weights.py``, the same proximity edges and video, and
``steps=1`` passes at world size 1 (one process, no group) and 2 (gloo,
ranks started by the script's own launcher) equal to the JAX package's
pass with ``mesh=None`` and on a 2-device mesh."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from test_torch_parallel import DISPS_ATOL, DISPS_RTOL
from torch_port import close, torch_single_thread  # noqa: F401

from lgu_slam_tpu import lie
from lgu_slam_tpu.slam.factor_graph import FactorGraph
from lgu_slam_tpu.slam.state import Video
from lgu_slam_tpu.slam.system import init_params
from lgu_slam_tpu.utils.config import SLAMConfig
from lgu_slam_tpu_torch.utils.weights import state_dict_from_jax_params

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "bench_backend_scaling_torch.py")
T = 8


def load_script():
    """The script as a module, its CPU ranks at one thread each (the test
    shares the host with the suite's other workers)."""
    spec = importlib.util.spec_from_file_location(
        "bench_backend_scaling_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.threads_per_rank = lambda world: 1
    return mod


# the dtypes the passes are compared in: fp32, as tests/test_torch_parallel.py
# holds the backend (at the scripts' bf16 defaults the two packages' bf16
# convolutions round apart: one pose entry of 56 off by 1.2e-5 after one
# pass at world size 1)
FP32 = dict(compute_dtype="float32", backend_hidden_dtype="float32",
            feat_dtype="float32", volume_dtype="float32")


def jax_graphs(n_graphs, **over):
    """The JAX script's first ``n_graphs`` graphs (its ``fresh_graph`` over
    one ``default_rng(0)``) at T keyframes (``over``: the config fields
    set otherwise), and its params."""
    cfg = SLAMConfig(
        image_size=(64, 96), buffer=T, max_factors=16 * T,
        edge_bucket=16 * T, inactive_bucket=16, pose_bucket=T,
        backend_edge_cap=16 * T, backend_chunk=32,
    ).replace(**over)
    net, params = init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    h, w = cfg.ht8, cfg.wd8

    def fresh_graph():
        video = Video(cfg)
        video.counter = T
        fd = video.state.fmaps.dtype
        video.state = video.state._replace(
            fmaps=video.state.fmaps.at[:T].set(jnp.asarray(
                rng.normal(size=(T, 1, h, w, 128)), jnp.float32).astype(fd)),
            nets=video.state.nets.at[:T].set(jnp.asarray(
                rng.normal(size=(T, h, w, 128)), jnp.float32).astype(fd)),
            inps=video.state.inps.at[:T].set(jnp.asarray(
                rng.normal(size=(T, h, w, 128)), jnp.float32).astype(fd)),
            poses=video.state.poses.at[:T].set(lie.se3_exp(jnp.asarray(
                np.cumsum(rng.normal(size=(T, 6)) * 0.01, 0), jnp.float32))),
            disps=video.state.disps.at[:T].set(jnp.asarray(
                0.5 + 0.3 * rng.random((T, h, w)), jnp.float32)),
            intrinsics=video.state.intrinsics.at[:T].set(
                jnp.asarray([w * 4.0, w * 4.0, w / 2, h / 2])),
        )
        g = FactorGraph(net, params, video, cfg, corr_impl="alt",
                        max_factors=cfg.max_factors,
                        edge_bucket=cfg.backend_edge_cap, inactive_bucket=16)
        g.add_proximity_factors(rad=2, nms=2, thresh=1e9)
        return g

    return [fresh_graph() for _ in range(n_graphs)], params


@pytest.fixture(scope="module")
def runs():
    """The JAX script's graphs (draws 0 and 1) at its bf16 defaults; the
    script's passes at world sizes 1 and 2 (steps=1, the warm-up pass
    only) in fp32 with the bridged JAX weights, and the JAX package's
    passes on the same fp32 graphs with ``mesh=None`` and on a 2-device
    mesh."""
    mod = load_script()
    graphs, params = jax_graphs(2)
    sd = state_dict_from_jax_params(jax.device_get(params))
    before = [dict(ii=np.array(g.ii), jj=np.array(g.jj), **{
        k: np.asarray(getattr(g.video.state, k)[:T], np.float32)
        for k in ("fmaps", "nets", "inps", "poses", "disps", "intrinsics")})
        for g in graphs]
    graphs, _ = jax_graphs(2, **FP32)
    port = {n: mod.run_world(n, T, steps=1, reps=0, device="cpu",
                             state_dict=sd, draw=k, over=FP32)
            for k, n in enumerate((1, 2))}
    graphs[0].update_lowmem(steps=1, mesh=None)
    graphs[1].update_lowmem(steps=1, mesh=Mesh(np.asarray(
        jax.devices()[:2]), ("kf",)))
    return mod, sd, before, graphs, port


@pytest.mark.parametrize("k", [0, 1])
def test_graph_equals_jax_scripts(runs, k):
    """The port's graph of draw ``k`` (world sizes 1 and 2): the same edge
    list ``ii, jj`` as the JAX script's, and the same video: features
    bit for bit (both packages round the same float64 draws to float32,
    then bf16), poses within 1e-6 (each package's se3_exp), disparities
    and intrinsics exact."""
    mod, sd, before, _, _ = runs
    ref = before[k]
    cfg = mod.config(T)
    net = mod.LGUNet.from_config(cfg, device="cpu")
    net.load_state_dict(sd)
    g = mod.fresh_graph(cfg, net.eval(), mod.draw_video(
        T, cfg.ht8, cfg.wd8, k), "cpu")
    np.testing.assert_array_equal(g.ii, ref["ii"])
    np.testing.assert_array_equal(g.jj, ref["jj"])
    v = g.video
    for name in ("fmaps", "nets", "inps", "disps", "intrinsics"):
        np.testing.assert_array_equal(
            getattr(v, name)[:T].float().numpy(), ref[name], err_msg=name)
    close(v.poses[:T], ref["poses"], atol=1e-6)


@pytest.mark.parametrize("world", [1, 2])
def test_pass_matches_jax(runs, world):
    """One ``steps=1`` pass at world size 1 (one process, ``mesh=None`` in
    the JAX script) and 2 (the script's gloo ranks, a 2-device mesh), in
    fp32 (FP32): the same edges, poses within rtol 1e-4 / atol 1e-5,
    disparities
    within tests/test_torch_parallel.py's DISPS_RTOL / DISPS_ATOL (the
    two packages' host-rounding spread), of the JAX package's pass."""
    _, _, _, graphs, port = runs
    res, g = port[world], graphs[world - 1]
    assert res["edges"] == g.n_edges
    np.testing.assert_array_equal(res["ii"], np.array(g.ii))
    s = g.video.state
    close(res["poses"], s.poses[:T], atol=1e-5, rtol=1e-4)
    close(res["disps"], s.disps[:T], atol=DISPS_ATOL, rtol=DISPS_RTOL)
    assert bool(torch.isfinite(res["disps"]).all())


def test_main_prints_the_jax_scripts_json(runs, capsys):
    """``main`` on the CPU at t = 8, one step, one rep, world sizes cut to
    1 and 2: stderr has a line per world size, and the last stdout line is
    one JSON object with the JAX script's keys and ``"device"``."""
    mod = runs[0]
    out = mod.main(["--device", "cpu", "--t", "8", "--steps", "1", "--reps",
                    "1"], worlds=(1, 2))
    cap = capsys.readouterr()
    last = json.loads(cap.out.strip().splitlines()[-1])
    assert last == out
    assert set(last) == {"metric", "t", "steps", "ms", "device"}
    assert last["metric"] == "backend_lowmem_pass_ms_by_devices"
    assert (last["t"], last["steps"], last["device"]) == (8, 1, "cpu")
    assert set(last["ms"]) == {"1", "2"}
    assert all(v > 0 for v in last["ms"].values())
    assert "devices=1:" in cap.err and "devices=2:" in cap.err
    assert mod.CPU_WORLDS == (1, 2, 4, 8)


def test_cuda_is_required_where_asked(runs):
    """``--device cuda`` (the default) raises where CUDA is absent, and
    asks for no more ranks than cards; the script imports nothing of the
    JAX package."""
    mod = runs[0]
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--t", "8"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.run_world(2, T, device="cuda")
    src = open(SCRIPT).read()
    for name in ("jax", "flax", "lgu_slam_tpu.", "lgu_native"):
        assert f"import {name}" not in src and f"from {name}" not in src
