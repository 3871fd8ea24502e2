"""Port parity: lgu_slam_tpu_torch.lie against lgu_slam_tpu.lie on random
batches, large and small angles.  fp32 on both sides; tolerances are a few
ulp of the values' magnitude (the two evaluate the same expressions in a
different operation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_port import close, t, torch_single_thread  # noqa: F401

from lgu_slam_tpu import lie as jl
from lgu_slam_tpu_torch import lie as tl


def twists(rng, scale, n=16):
    return (rng.normal(size=(n, 6)) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [0.7, 1e-3, 1e-6])
def test_exp_log(rng, scale):
    xi = twists(rng, scale)
    g_j = jl.se3_exp(jnp.asarray(xi))
    g_t = tl.se3_exp(t(xi))
    close(g_t, g_j, atol=2e-6)
    # the log of a near-identity quaternion carries ~1e-7 absolute fp32
    # error (different product order), up to 1e-3 relative at these angles
    close(tl.se3_log(g_t), jl.se3_log(g_j), atol=2e-5 * scale, rtol=5e-3)
    close(tl.so3_exp(t(xi[:, 3:])), jl.so3_exp(jnp.asarray(xi[:, 3:])),
          atol=2e-6)
    close(tl.so3_log(g_t[:, 3:]), jl.so3_log(g_j[:, 3:]), atol=2e-5 * scale,
          rtol=5e-3)


@pytest.mark.parametrize("scale", [0.7, 1e-4])
def test_group_ops(rng, scale):
    a = np.asarray(jl.se3_exp(jnp.asarray(twists(rng, scale))))
    b = np.asarray(jl.se3_exp(jnp.asarray(twists(rng, scale))))
    x = rng.normal(size=(16, 3)).astype(np.float32)
    x4 = rng.normal(size=(16, 4)).astype(np.float32)
    y6 = rng.normal(size=(16, 6)).astype(np.float32)
    A, B = jnp.asarray(a), jnp.asarray(b)
    close(tl.se3_inv(t(a)), jl.se3_inv(A), atol=1e-6)
    close(tl.se3_mul(t(a), t(b)), jl.se3_mul(A, B), atol=2e-6)
    close(tl.se3_rel(t(a), t(b)), jl.se3_rel(A, B), atol=2e-6)
    close(tl.se3_act(t(a), t(x)), jl.se3_act(A, jnp.asarray(x)), atol=2e-6)
    close(tl.se3_act4(t(a), t(x4)), jl.se3_act4(A, jnp.asarray(x4)),
          atol=2e-6)
    close(tl.se3_adjT_apply(t(a), t(y6)),
          jl.se3_adjT_apply(A, jnp.asarray(y6)), atol=1e-5)
    close(tl.se3_retr(t(a), t(y6 * 0.1)),
          jl.se3_retr(A, jnp.asarray(y6 * 0.1)), atol=2e-6)
    close(tl.se3_matrix(t(a)), jl.se3_matrix(A), atol=2e-6)
    close(tl.se3_from_matrix(tl.se3_matrix(t(a))),
          jl.se3_from_matrix(jl.se3_matrix(A)), atol=2e-6)
    close(tl.quat_mul(t(a[:, 3:]), t(b[:, 3:])),
          jl.quat_mul(A[:, 3:], B[:, 3:]), atol=1e-6)
    close(tl.quat_rotate(t(a[:, 3:]), t(x)),
          jl.quat_rotate(A[:, 3:], jnp.asarray(x)), atol=2e-6)
    close(tl.quat_normalize(t(a[:, 3:] * 3.0)),
          jl.quat_normalize(A[:, 3:] * 3.0), atol=1e-6)
    close(tl.so3_matrix(t(a[:, 3:])), jl.so3_matrix(A[:, 3:]), atol=1e-6)


def test_identity_and_broadcast():
    close(tl.se3_identity((2, 3)), jl.se3_identity((2, 3)), atol=0)
    g = tl.se3_exp(t(np.full((4, 1, 6), 0.1, np.float32)))
    x = t(np.ones((4, 5, 3), np.float32))
    assert tl.se3_act(g, x).shape == (4, 5, 3)
