"""Port parity: the network modules of lgu_slam_tpu_torch.models against
the JAX package's, with the JAX parameter tree carried over by the weight
bridge (utils/weights.py).

The parameters are the JAX package's random init with N(0, 0.02) noise
added to every leaf, so that the zero-initialised offset and mean heads
compute something.  Everything runs in fp32 on the CPU; each tolerance
states the depth of the computation it covers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port import close, t, torch_single_thread  # noqa: F401

from lgu_slam_tpu.models import kan as jkan
from lgu_slam_tpu.models.extractor import BasicEncoder as JEncoder
from lgu_slam_tpu.models.gaussian_mask import GaussianMask as JMask
from lgu_slam_tpu.models.gru import ConvGRU as JConvGRU
from lgu_slam_tpu.models.gru import KanBiasConvGRU as JGRU
from lgu_slam_tpu.models.net import LGUNet as JNet
from lgu_slam_tpu.models.net import normalize_images as j_normalize
from lgu_slam_tpu.models.update import UpdateModule as JUpdate
from lgu_slam_tpu.models.update import cvx_upsample as j_cvx
from lgu_slam_tpu.models.update import upsample_disp as j_up_disp
from lgu_slam_tpu.slam.system import init_params
from lgu_slam_tpu.utils import config as jconfig
from lgu_slam_tpu.utils.checkpoint import convert_torch_checkpoint
from lgu_slam_tpu_torch.models import kan as tkan
from lgu_slam_tpu_torch.models.gru import ConvGRU
from lgu_slam_tpu_torch.models.net import LGUNet, init_state_dict
from lgu_slam_tpu_torch.models.net import normalize_images as t_normalize
from lgu_slam_tpu_torch.models.update import cvx_upsample as t_cvx
from lgu_slam_tpu_torch.models.update import upsample_disp as t_up_disp
from lgu_slam_tpu_torch.utils import config as tconfig
from lgu_slam_tpu_torch.utils.weights import (
    conv_gru_state_dict, state_dict_from_jax_params)

CFG = dict(image_size=(64, 96), volume_dtype="float32",
           feat_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def jax_params():
    _, params = init_params(jconfig.SLAMConfig(**CFG), seed=0)
    return jax.device_get(params)


@pytest.fixture(scope="module")
def nets(jax_params):
    """(JAX params with noise, the port's LGUNet loaded through the bridge)."""
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * rng.normal(size=a.shape))
        .astype(np.float32), jax_params)
    net = LGUNet(volume_dtype=torch.float32, device="cpu")
    net.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return params, net.eval()


def test_weight_bridge_round_trip(jax_params):
    """convert_torch_checkpoint(state_dict_from_jax_params(p)) == p."""
    back = convert_torch_checkpoint(state_dict_from_jax_params(jax_params))
    a, tree_a = jax.tree_util.tree_flatten(jax_params)
    b, tree_b = jax.tree_util.tree_flatten(back)
    assert tree_a == tree_b
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(y), np.asarray(x))


def test_init_state_dict_layout(jax_params):
    """The port's own init has the JAX tree's layout after conversion, and
    flax's zero-initialised heads."""
    sd = init_state_dict(tconfig.SLAMConfig(**CFG), seed=0)
    LGUNet(device="cpu").load_state_dict(sd, strict=True)
    conv = convert_torch_checkpoint(sd)
    shapes = jax.tree_util.tree_map(np.shape, conv)
    assert shapes == jax.tree_util.tree_map(np.shape, jax_params)
    for key in ("ofsMap", "ofs_residual", "GA.meanMap"):
        assert not sd[key + ".weight"].any() and not sd[key + ".bias"].any()
    # lecun-normal kernels: variance 1 / fan_in
    w = sd["update.gru.convz.weight"]
    assert abs(float(w.var()) * w[0].numel() - 1.0) < 0.05
    again = init_state_dict(tconfig.SLAMConfig(**CFG), seed=0)
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_config_matches():
    """The port's copy of the config has the JAX package's fields,
    defaults and presets."""
    def fields(c):
        return {k: v for k, v in vars(c).items()}

    assert fields(tconfig.SLAMConfig()) == fields(jconfig.SLAMConfig())
    assert fields(tconfig.TrainConfig()) == fields(jconfig.TrainConfig())
    for name in ("TUM_CONFIG", "EUROC_CONFIG", "ETH3D_CONFIG",
                 "TARTANAIR_CONFIG"):
        assert fields(getattr(tconfig, name)) == fields(getattr(jconfig, name))
    assert tconfig.SLAMConfig().ht8 == 48 and tconfig.SLAMConfig().wd8 == 64


@pytest.mark.parametrize("which", ["fnet", "cnet"])
def test_basic_encoder(nets, rng, which):
    """Instance norm (fnet) and no norm (cnet): 7 conv layers deep; fp32
    outputs of unit scale agree to 2e-4."""
    params, net = nets
    x = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    norm, dim = ("instance", 128) if which == "fnet" else ("none", 256)
    ref = JEncoder(dim, norm).apply({"params": params[which]},
                                    jnp.asarray(x))
    with torch.no_grad():
        out = getattr(net, which)(t(x))
    assert out.shape == (2, 4, 6, dim)
    close(out, ref, atol=2e-4, rtol=1e-4)


def test_bspline_bases(rng):
    """Inside, at the edge of and outside the grid; same arithmetic, fp32
    rounding only."""
    G, K, I = 3, 3, 8
    grid = (np.arange(-K, G + K + 1) * (2.0 / G) - 1.0).astype(np.float32)
    grid = np.tile(grid, (I, 1))
    x = rng.uniform(-3.0, 3.0, size=(20, I)).astype(np.float32)
    x[0, :4] = [-1.0, 1.0, grid[0, 0], grid[0, -1]]
    close(tkan.bspline_bases(t(x), t(grid), K),
          jkan.bspline_bases(jnp.asarray(x), jnp.asarray(grid), K),
          atol=1e-6)


def test_kan_linear(nets, rng):
    params, net = nets
    x = rng.normal(size=(6, 128)).astype(np.float32)
    ref = jkan.KANLinear(128, 128, grid_size=3).apply(
        {"params": params["update"]["gru"]["kanz_glo"]}, jnp.asarray(x))
    with torch.no_grad():
        out = net.update.gru.kanz_glo(t(x))
    close(out, ref, atol=1e-5, rtol=1e-5)


def test_kan_bias_conv_gru(nets, rng):
    params, net = nets
    shp = (2, 6, 8)
    h = np.tanh(rng.normal(size=shp + (128,))).astype(np.float32)
    ins = [rng.normal(size=shp + (c,)).astype(np.float32)
           for c in (128, 128, 64)]
    ref = JGRU(128, 320).apply({"params": params["update"]["gru"]},
                               jnp.asarray(h), *map(jnp.asarray, ins))
    with torch.no_grad():
        out = net.update.gru(t(h), *map(t, ins))
    close(out, ref, atol=2e-5)


def test_conv_gru(rng):
    """The vanilla ConvGRU(128, 320): the JAX cell's random init with
    N(0, 0.02) noise, bridged; the same tolerance as the KAN-bias cell
    (three 3x3 convs over 448 channels)."""
    shp = (2, 6, 8)
    h = np.tanh(rng.normal(size=shp + (128,))).astype(np.float32)
    ins = [rng.normal(size=shp + (c,)).astype(np.float32)
           for c in (128, 128, 64)]
    cell = JConvGRU(128, 320)
    params = jax.device_get(cell.init(jax.random.PRNGKey(3), jnp.asarray(h),
                                      *map(jnp.asarray, ins))["params"])
    noise = np.random.default_rng(2)
    params = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.02 * noise.normal(size=a.shape))
        .astype(np.float32), params)
    ref = cell.apply({"params": params}, jnp.asarray(h),
                     *map(jnp.asarray, ins))
    gru = ConvGRU(128, 320)
    gru.load_state_dict(conv_gru_state_dict(params), strict=True)
    assert sorted(gru.state_dict()) == sorted(
        f"{n}.{p}" for n in ("convz", "convr", "convq", "convz_glo",
                             "convr_glo", "convq_glo")
        for p in ("weight", "bias"))
    with torch.no_grad():
        out = gru(t(h), *map(t, ins))
    close(out, ref, atol=2e-5)


def test_gaussian_mask_predict(nets, rng):
    params, net = nets
    x = rng.normal(size=(2, 5, 7, 256)).astype(np.float32)
    ref = JMask().apply({"params": params["ga"]}, jnp.asarray(x),
                        method=JMask.predict)
    with torch.no_grad():
        out = net.GA.predict(t(x))
    for a, b, name in zip(out, ref, ("mean", "cov", "det")):
        close(a, b, atol=1e-5, rtol=1e-5, msg=name)


@pytest.mark.parametrize("graph", [False, True])
def test_update_module(nets, rng, graph):
    """Encoders + GRU + heads (+ GraphAgg over 4 frame slots, slot 3 with
    no edge); ~10 convs deep in fp32."""
    params, net = nets
    B, E, H, W = 1, 4, 6, 8
    x = [rng.normal(size=(B, E, H, W, c)).astype(np.float32)
         for c in (128, 128, 196, 4)]
    x[0] = np.tanh(x[0])
    extra_j, extra_t = (), ()
    if graph:
        ii = np.array([0, 2, 2, 1])
        extra_j = (jnp.asarray(ii), 4)
        extra_t = (t(ii), 4)
    ref = JUpdate().apply({"params": params["update"]},
                          *map(jnp.asarray, x), *extra_j)
    with torch.no_grad():
        out = net.update(*map(t, x), *extra_t)
    assert len(out) == len(ref) == (6 if graph else 3)
    names = ("net", "delta", "weight", "eta", "upmask", "slot_mask")
    for a, b, name in zip(out, ref, names):
        close(a, b, atol=5e-5, rtol=1e-4, msg=name)
    if graph:
        assert out[5].tolist() == [True, True, True, False]


def test_cvx_upsample(rng):
    data = rng.normal(size=(2, 4, 5, 3)).astype(np.float32)
    mask = rng.normal(size=(2, 4, 5, 576)).astype(np.float32)
    close(t_cvx(t(data), t(mask)), j_cvx(jnp.asarray(data),
                                         jnp.asarray(mask)), atol=1e-5)
    close(t_up_disp(t(data[..., 0]), t(mask)),
          j_up_disp(jnp.asarray(data[..., 0]), jnp.asarray(mask)), atol=1e-5)


def test_normalize_images_and_context(nets, rng):
    """BGR uint8 -> normalised RGB, then the context split (tanh/relu)."""
    params, net = nets
    img = rng.integers(0, 256, size=(1, 32, 48, 3)).astype(np.uint8)
    x_j = j_normalize(jnp.asarray(img))
    x_t = t_normalize(t(img))
    close(x_t, x_j, atol=1e-6)
    ref = JNet().apply({"params": params}, x_j, method=JNet.context)
    with torch.no_grad():
        out = net.context(x_t)
    for a, b in zip(out, ref):
        close(a, b, atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("hw", [(8, 12), (9, 13)])
def test_corr_pyramid_and_lookup(nets, rng, hw):
    """LGUNet.build_corr (FPN offsets, Gaussian parameters, K1's plain
    version, pooled levels) and LGUNet.lookup (K2's plain version) against
    the JAX volume path, including an odd plane whose nearest resize and
    pooling floor.  Correlations are O(10); 2e-4 is fp32 rounding of a
    128-channel dot product."""
    params, net = nets
    H, W = hw
    E = 3
    f1 = rng.normal(size=(E, H, W, 128)).astype(np.float32)
    f2 = rng.normal(size=(E, H, W, 128)).astype(np.float32)
    coords = (rng.uniform(-0.2, 1.2, size=(E, H, W, 2))
              * np.array([W, H])).astype(np.float32)
    jnet = JNet(volume_dtype=jnp.float32)
    pyr_j = jnet.apply({"params": params}, jnp.asarray(f1), jnp.asarray(f2),
                       method=JNet.build_corr)
    feats_j = jnet.apply({"params": params}, pyr_j, jnp.asarray(coords),
                         method=JNet.lookup)
    with torch.no_grad():
        pyr_t = net.build_corr(t(f1), t(f2))
        feats_t = net.lookup(pyr_t, t(coords))
    for lvl, (a, b) in enumerate(zip(pyr_t.levels, pyr_j.levels)):
        close(a, b, atol=2e-4, rtol=1e-4, msg=f"level {lvl}")
    for a, b in zip(pyr_t.offsets, pyr_j.offsets):
        close(a, b, atol=1e-4, msg="offsets")
        assert float(a.abs().max()) > 0.1  # the noisy heads are exercised
    close(pyr_t.mean, pyr_j.mean, atol=1e-5, rtol=1e-5)
    close(pyr_t.theta, pyr_j.theta, atol=1e-5, rtol=1e-5)
    close(feats_t, feats_j, atol=2e-4, rtol=1e-4)
