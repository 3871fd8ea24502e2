"""Render-quality evaluation for the Gaussian scene (port of the JAX
package's ``gs/eval.py``; reference: to3DGS/utils/eval_helpers.py --
PSNR/SSIM/LPIPS report over the trajectory).  LPIPS needs the pretrained
``lpips`` package's AlexNet weights; when it is importable it is used
exactly as the reference does (net='alex'), otherwise the metric is
reported as None rather than approximated."""

from __future__ import annotations

import json

import numpy as np
import torch

from lgu_slam_tpu_torch.gs.render import render_rgbd
from lgu_slam_tpu_torch.gs.ssim import ssim
from lgu_slam_tpu_torch.utils.device import to_device, to_host


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a - b) ** 2))
    return float(10.0 * np.log10(1.0 / max(mse, 1e-12)))


def _make_lpips():
    """Pretrained-LPIPS factory (eval_helpers uses lpips net='alex').
    Returns a callable (im_a, im_b in [0,1] HWC) -> float, or None when the
    package/weights are unavailable in this offline environment."""
    try:  # pragma: no cover - depends on optional package
        import lpips as lpips_pkg

        net = lpips_pkg.LPIPS(net="alex")

        def fn(a, b):
            ta = torch.from_numpy(
                (np.asarray(a, np.float32) * 2 - 1).transpose(2, 0, 1)
            )[None]
            tb = torch.from_numpy(
                (np.asarray(b, np.float32) * 2 - 1).transpose(2, 0, 1)
            )[None]
            with torch.no_grad():
                return float(net(ta, tb).item())

        return fn
    except Exception:
        return None


def evaluate_renders(params, alive, frames, img_size, span=6, k_max=96):
    """params: the map's tensors (on the device the renders run on); alive
    [N]; frames: list of (im_gt [H,W,3] in [0,1], depth_gt, w2c_rot,
    w2c_trans, intr) tensors or arrays.  Returns metrics dict."""
    psnrs, ssims, depth_l1, lpipss = [], [], [], []
    lpips_fn = _make_lpips()
    dev = params["means3D"].device
    for im_gt, depth_gt, R, t, intr in frames:
        with torch.no_grad():
            img, depth, sil, _ = render_rgbd(
                params, alive, R, t, intr, img_size, span=span, k_max=k_max
            )
            img = torch.clamp(img, 0, 1)
            gt = to_device(im_gt, dev)
            ssims.append(float(ssim(img, gt)))
        img, im_gt, depth = to_host(img), to_host(im_gt), to_host(depth)
        psnrs.append(psnr(img, im_gt))
        if lpips_fn is not None:
            lpipss.append(lpips_fn(img, im_gt))
        m = to_host(depth_gt) > 0
        if m.any():
            depth_l1.append(
                float(np.abs(depth - to_host(depth_gt))[m].mean())
            )
    report = {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "depth_l1": float(np.mean(depth_l1)) if depth_l1 else float("nan"),
        "lpips": float(np.mean(lpipss)) if lpipss else None,
        "n_frames": len(frames),
    }
    return report


def print_report(report: dict):
    print(json.dumps(report, indent=2))
