"""Factor graph over keyframes, a frozen plain copy of the port's
``slam/factor_graph.py`` on one device.

Edge topology (add/dedup, age- and capacity-based eviction, keyframe
removal, low-confidence filtering) is host numpy, and so is the proximity
planning with NMS (``planner.py``).  Per-edge state
(reprojection targets, confidence weights, GRU hidden state) is device
tensors holding exactly the live edges, in edge order.  The capacity rules
that decide which edges exist are kept: the ``edge_bucket`` hard cap, the
``max_factors`` eviction of the oldest edges, and the eviction of the oldest
stored inactive edges beyond ``inactive_bucket``.

Two correlation implementations, as in the JAX package: ``"volume"`` (the
frontend and the trajectory filler; per-edge pyramids,
:meth:`FactorGraph.update_n`) and ``"alt"`` (the backend; a pooled feature
pyramid and correlation on the fly, :meth:`FactorGraph.update_lowmem`, with
the per-edge GRU hidden state rounded to ``cfg.backend_hidden_dtype``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference.geom.dba import DbaPlan, dba_step
from perfbench.reference.geom.projective import coords_grid, projective_transform
from perfbench.reference.config import SLAMConfig
from perfbench.reference.models.corr import build_fmap_pyramid
from perfbench.reference.models.net import LGUNet
from perfbench.reference.models.update import upsample_disp
from perfbench.reference.precision import rnd
from perfbench.reference.slam import planner
from perfbench.reference.slam.state import Video


class _Chunk(NamedTuple):
    """One chunk of the low-memory update: its edges (a slice of the edge
    list, or edge ids), keyframe and rig-expanded feature indices, and
    GraphAgg frame slots."""

    sel: slice | torch.Tensor
    ii: torch.Tensor
    jj: torch.Tensor
    ii_rig: torch.Tensor
    jj_rig: torch.Tensor
    frame_ids: torch.Tensor
    edge_slot: torch.Tensor
    F: int
    written: torch.Tensor


class FactorGraph:
    def __init__(self, net: LGUNet, video: Video, cfg: SLAMConfig,
                 corr_impl: str = "volume", max_factors: int = -1,
                 edge_bucket: int | None = None,
                 inactive_bucket: int | None = None):
        self.net = net
        self.video = video
        self.cfg = cfg
        self.device = video.device
        self.max_factors = max_factors if max_factors > 0 else cfg.max_factors
        self.E = edge_bucket or cfg.edge_bucket  # hard cap on active edges
        # cap on stored inactive edges
        self.EI = inactive_bucket or cfg.inactive_bucket

        h, w = cfg.ht8, cfg.wd8
        empty = np.zeros(0, np.int64)
        self.ii, self.jj, self.age = empty, empty, empty
        self.ii_inac, self.jj_inac = empty, empty
        self.ii_bad, self.jj_bad = empty, empty

        f32 = dict(dtype=torch.float32, device=self.device)
        self.target = torch.zeros(0, h, w, 2, **f32)
        self.weight = torch.zeros(0, h, w, 2, **f32)
        # per-edge GRU state; the backend's global graph stores it in
        # cfg.backend_hidden_dtype (bf16 by default) to bound its memory
        self.hidden_dtype = (cfg.backend_hidden_dtype if corr_impl == "alt"
                             else "float32")
        self.hidden = torch.zeros(0, h, w, 128, device=self.device)
        self.target_inac = torch.zeros(0, h, w, 2, **f32)
        self.weight_inac = torch.zeros(0, h, w, 2, **f32)

        self.pyramid = None  # volume impl: per-edge correlation pyramids
        self.fmap_pyr = None  # alt impl: pooled feature pyramid
        self._pyr_dirty = True

    @property
    def n_edges(self) -> int:
        return len(self.ii)

    def _index(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _dedup(self, ii, jj):
        """Drop candidate edges already present (active or inactive)."""
        existing = set(zip(self.ii.tolist(), self.jj.tolist()))
        existing |= set(zip(self.ii_inac.tolist(), self.jj_inac.tolist()))
        keep = [k for k, e in enumerate(zip(ii.tolist(), jj.tolist()))
                if e not in existing]
        return ii[keep], jj[keep]

    # -- edge addition ------------------------------------------------------

    def add_factors(self, ii, jj, remove: bool = False):
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        ii, jj = self._dedup(ii, jj)
        if ii.size == 0:
            return

        # capacity limit: evict the oldest edges
        if (self.max_factors > 0 and self.n_edges + ii.size > self.max_factors
                and self.n_edges > 0 and remove):
            order = np.argsort(self.age)[::-1]
            n_drop = min(self.n_edges,
                         self.n_edges + ii.size - self.max_factors)
            drop = np.zeros(self.n_edges, bool)
            drop[order[:n_drop]] = True
            self.rm_factors(drop, store=True)

        space = self.E - self.n_edges
        if ii.size > space:  # hard cap
            ii, jj = ii[:space], jj[:space]
            if ii.size == 0:
                return

        v = self.video
        ii_t, jj_t = self._index(ii), self._index(jj)
        coords, _ = projective_transform(v.poses, v.disps, v.intrinsics,
                                         ii_t, jj_t)
        self.target = torch.cat([self.target, coords])
        self.weight = torch.cat([self.weight, torch.zeros_like(coords)])
        self.hidden = torch.cat([self.hidden,
                                 rnd(v.nets[ii_t], self.hidden_dtype)])

        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(ii.size, np.int64)])
        self._pyr_dirty = True

    # -- edge removal -------------------------------------------------------

    def rm_factors(self, mask, store: bool = False):
        """Remove edges by boolean mask; ``store`` keeps their targets and
        weights as inactive edges for the DBA."""
        mask = np.asarray(mask, bool)
        if mask.size != self.n_edges:
            raise ValueError("mask size mismatch")
        if not mask.any():
            return
        sel = self._index(np.nonzero(mask)[0])
        if store:
            self.ii_inac = np.concatenate([self.ii_inac, self.ii[mask]])
            self.jj_inac = np.concatenate([self.jj_inac, self.jj[mask]])
            self.target_inac = torch.cat([self.target_inac, self.target[sel]])
            self.weight_inac = torch.cat([self.weight_inac, self.weight[sel]])
            overflow = len(self.ii_inac) - self.EI
            if overflow > 0:  # drop the oldest stored edges first
                self.ii_inac = self.ii_inac[overflow:]
                self.jj_inac = self.jj_inac[overflow:]
                self.target_inac = self.target_inac[overflow:]
                self.weight_inac = self.weight_inac[overflow:]

        keep = self._index(np.nonzero(~mask)[0])
        self.target = self.target[keep]
        self.weight = self.weight[keep]
        self.hidden = self.hidden[keep]
        self.ii = self.ii[~mask]
        self.jj = self.jj[~mask]
        self.age = self.age[~mask]
        self._pyr_dirty = True

    def rm_keyframe(self, ix: int):
        """Delete keyframe ix: shift its video slot and re-index edges."""
        self.video.remove_keyframe(ix)

        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac = np.where(self.ii_inac >= ix, self.ii_inac - 1,
                                self.ii_inac)
        self.jj_inac = np.where(self.jj_inac >= ix, self.jj_inac - 1,
                                self.jj_inac)
        if m.any():
            keep = self._index(np.nonzero(~m)[0])
            self.target_inac = self.target_inac[keep]
            self.weight_inac = self.weight_inac[keep]
            self.ii_inac = self.ii_inac[~m]
            self.jj_inac = self.jj_inac[~m]

        m = (self.ii == ix) | (self.jj == ix)
        self.ii = np.where(self.ii >= ix, self.ii - 1, self.ii)
        self.jj = np.where(self.jj >= ix, self.jj - 1, self.jj)
        self.rm_factors(m, store=False)

    def filter_edges(self):
        """Drop the low-confidence long-range edges (mean weight under
        1e-3, more than two keyframes apart) and remember them as bad: the
        proximity planner suppresses around them."""
        if self.n_edges == 0:
            return
        conf = self.weight.mean(dim=(1, 2, 3)).cpu().numpy()
        mask = (np.abs(self.ii - self.jj) > 2) & (conf < 0.001)
        self.ii_bad = np.concatenate([self.ii_bad, self.ii[mask]])
        self.jj_bad = np.concatenate([self.jj_bad, self.jj[mask]])
        self.rm_factors(mask, store=False)

    def clear_edges(self):
        if self.n_edges:
            self.rm_factors(np.ones(self.n_edges, bool), store=False)

    # -- update -------------------------------------------------------------

    def _build_pyramid(self):
        """Correlation pyramids of all edges from the cached video features
        (stereo self-edges read the right camera).  K1 gets the features in
        the store's dtype: bf16 values stay bf16 (``feat_dtype``)."""
        fmaps = self.video.fmaps
        rig = fmaps.shape[1]
        cam = np.minimum((self.ii == self.jj).astype(np.int64), rig - 1)
        ii, jj = self._index(self.ii), self._index(self.jj)
        f1 = fmaps[ii, 0]
        f2 = fmaps[jj, self._index(cam)]
        self.pyramid = self.net.build_corr(f1, f2, operand_dtype=fmaps.dtype)
        self._pyr_dirty = False

    def _build_fmap_pyramid(self):
        """Pooled feature pyramid of the live keyframes, rig-flattened
        (feature index ``rig * frame + camera``), in float32."""
        fmaps = self.video.fmaps[:max(self.video.counter, 1)]
        t, rig, h, w, c = fmaps.shape
        self.fmap_pyr = build_fmap_pyramid(fmaps.reshape(t * rig, h, w, c))

    def _frame_slots(self, ii, bucket: int):
        """GraphAgg frame slots of the edges' source frames ``ii``:
        (frame ids, slot of each edge, slot count, the slots whose damping
        and upsampled disparity get written).  As in the JAX package: it
        pads the slots to ``bucket`` (doubled until they fit) with frame id
        0, and its duplicate-index scatter writes a padded slot's unchanged
        value last, so while any slot is padded frame 0 keeps its damping
        and its upsampled disparity."""
        frames, slot = np.unique(ii, return_inverse=True)
        F = len(frames)
        while bucket < F:
            bucket *= 2
        keep_0 = int(frames[0] == 0 and F < bucket)
        written = torch.as_tensor(np.arange(F) >= keep_0, device=self.device)
        return self._index(frames), self._index(slot), F, written

    @staticmethod
    def _scatter_slots(buf, frame_ids, slot_mask, values):
        """buf[frame_ids] = values where slot_mask (per-frame damping or
        upsampled disparity from the GraphAgg slots)."""
        buf[frame_ids] = torch.where(slot_mask[:, None, None], values,
                                     buf[frame_ids])

    @torch.no_grad()
    def update_n(self, n, t0=None, t1=None, itrs=2, use_inactive=False,
                 EP=1e-7, motion_only=False):
        """n x (GRU update over the active edges + DBA over the active and
        the selected inactive edges)."""
        if self.n_edges == 0:
            return
        cfg = self.cfg
        v = self.video
        if self._pyr_dirty:
            self._build_pyramid()

        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        if t1 is None:
            t1 = max(int(self.ii.max()), int(self.jj.max())) + 1

        # inactive edges near the window join the DBA (fixed over n)
        if use_inactive and len(self.ii_inac) > 0:
            sel = np.nonzero((self.ii_inac >= t0 - 3)
                             & (self.jj_inac >= t0 - 3))[0]
        else:
            sel = np.zeros(0, np.int64)
        sel_t = self._index(sel)
        target_inac = self.target_inac[sel_t]
        weight_inac = self.weight_inac[sel_t]
        plan = DbaPlan.build(
            np.concatenate([self.ii, self.ii_inac[sel]]),
            np.concatenate([self.jj, self.jj_inac[sel]]),
            t0, t1, self.device, strict_t0_quirk=cfg.strict_t0_quirk)

        frame_ids, edge_slot, F, written = self._frame_slots(
            self.ii, cfg.frame_bucket)
        ii, jj = self._index(self.ii), self._index(self.jj)
        ht, wd = v.disps.shape[1:]
        coords0 = coords_grid(ht, wd, device=self.device)
        inp = v.inps[ii].float()
        hidden, target, weight = self.hidden, self.target, self.weight
        upmask = None
        for _ in range(n):
            coords1, _ = projective_transform(v.poses, v.disps, v.intrinsics,
                                              ii, jj)
            motn = torch.clamp(
                torch.cat([coords1 - coords0, target - coords1], dim=-1),
                -64.0, 64.0)
            corr = self.net.lookup(self.pyramid, coords1)
            hidden, delta, weight, eta, upmask, slot_mask = \
                self.net.update_step(hidden[None], inp[None], corr[None],
                                     motn[None], edge_slot, F)
            hidden, upmask = hidden[0], upmask[0]
            target = coords1 + delta[0]
            weight = weight[0]
            slot_mask = slot_mask & written
            self._scatter_slots(v.damping, frame_ids, slot_mask, eta[0])

            v.poses, v.disps = dba_step(
                v.poses, v.disps, v.intrinsics[0], v.disps_sens,
                torch.cat([target, target_inac]),
                torch.cat([weight, weight_inac]),
                0.2 * v.damping + EP, plan, iters=itrs, lm=cfg.dba_lm,
                ep=cfg.dba_ep, motion_only=motion_only)

        self.hidden, self.target, self.weight = hidden, target, weight
        if cfg.upsample:
            self._scatter_slots(v.disps_up, frame_ids, slot_mask,
                                upsample_disp(v.disps[frame_ids], upmask))
        v.dirty[t0:t1] = True
        self.age += n

    def update(self, t0=None, t1=None, itrs=2, use_inactive=False, EP=1e-7,
               motion_only=False):
        """One GRU update + DBA: ``update_n(1, ...)`` (the JAX package's
        ``FactorGraph.update``)."""
        self.update_n(1, t0, t1, itrs, use_inactive, EP, motion_only)

    def make_chunk(self, sel, CH: int) -> _Chunk:
        """The chunk of the edges ``sel`` (a slice, or edge ids as numpy):
        keyframe and rig-expanded feature indices (stereo self-edges read
        the right camera) and GraphAgg frame slots, padded to ``CH`` as the
        JAX package pads them."""
        rig = self.video.fmaps.shape[1]
        ii, jj = self.ii[sel], self.jj[sel]
        jj_rig = rig * jj + ((ii == jj) if rig > 1 else 0)
        if not isinstance(sel, slice):
            sel = self._index(sel)
        return _Chunk(sel, self._index(ii), self._index(jj),
                      self._index(rig * ii), self._index(jj_rig),
                      *self._frame_slots(ii, CH))

    def _lowmem_chunk_plan(self, CH: int):
        """The one-process low-memory update's chunks: ``CH`` edges each, in
        edge order."""
        return [self.make_chunk(slice(lo, min(lo + CH, self.n_edges)), CH)
                for lo in range(0, self.n_edges, CH)]

    def prepare_lowmem(self):
        """The pooled feature pyramid of the live keyframes and the pixel
        grid, which the chunk updates read."""
        self._build_fmap_pyramid()
        return coords_grid(*self.video.disps.shape[1:], device=self.device)

    def lowmem_chunk_update(self, c: _Chunk, coords0):
        """One GRU update of chunk ``c`` with the correlation computed on
        the fly: it reads the poses of the last DBA and the hidden states,
        targets and weights of earlier chunks, stores the hidden state back
        in its dtype, and writes the damping (and the upsampled disparity)
        of the chunk's frame slots."""
        v, cfg = self.video, self.cfg
        coords1, _ = projective_transform(v.poses, v.disps, v.intrinsics,
                                          c.ii, c.jj)
        motn = torch.clamp(
            torch.cat([coords1 - coords0, self.target[c.sel] - coords1],
                      dim=-1), -64.0, 64.0)
        corr = self.net.alt_corr(self.fmap_pyr, c.ii_rig, c.jj_rig, coords1)
        hidden, delta, weight, eta, upmask, slot_mask = self.net.update_step(
            self.hidden[c.sel][None], v.inps[c.ii].float()[None], corr[None],
            motn[None], c.edge_slot, c.F)
        self.hidden[c.sel] = rnd(hidden[0], self.hidden_dtype)
        self.target[c.sel] = coords1 + delta[0]
        self.weight[c.sel] = weight[0]
        slot_mask = slot_mask & c.written
        self._scatter_slots(v.damping, c.frame_ids, slot_mask, eta[0])
        if cfg.upsample:
            self._scatter_slots(v.disps_up, c.frame_ids, slot_mask,
                                upsample_disp(v.disps[c.frame_ids],
                                              upmask[0]))

    @torch.no_grad()
    def update_lowmem(self, t0=None, t1=None, itrs=2, steps=8, EP=1e-7):
        """Global low-memory optimisation (the backend): ``steps`` rounds of
        {one GRU update per chunk of ``cfg.backend_chunk`` edges with the
        correlation computed on the fly, then one DBA over all edges with
        ``t0 = 1``, ``t1 = counter`` by default}.  Chunks see the poses of
        the last DBA and the hidden states, targets and weights of earlier
        chunks; the hidden state is stored back in its dtype after every
        chunk."""
        if self.n_edges == 0:
            return
        cfg = self.cfg
        v = self.video
        t = v.counter
        coords0 = self.prepare_lowmem()
        chunks = self._lowmem_chunk_plan(cfg.backend_chunk)
        plan = DbaPlan.build(self.ii, self.jj, 1 if t0 is None else t0,
                             t if t1 is None else t1, self.device,
                             strict_t0_quirk=cfg.strict_t0_quirk)
        for _ in range(steps):
            for c in chunks:
                self.lowmem_chunk_update(c, coords0)
            # dba_step clamps the disparities at 1e-3
            v.poses, v.disps = dba_step(
                v.poses, v.disps, v.intrinsics[0], v.disps_sens, self.target,
                self.weight, 0.2 * v.damping + EP, plan, iters=itrs,
                lm=cfg.dba_lm, ep=cfg.dba_ep)
        v.dirty[:t] = True

    # -- proximity edge selection (host-side NMS) ---------------------------

    def add_neighborhood_factors(self, t0, t1, r=3):
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        c = 1 if self.video.stereo else 0
        keep = (np.abs(ii - jj) > c) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def add_proximity_factors(self, t0=0, t1=0, rad=2, nms=2, beta=0.25,
                              thresh=16.0, remove=False):
        """Distance-ranked edge selection with non-maximum suppression over
        the candidates ``[t0, t) x [t1, t)`` (``planner.proximity_plan``)."""
        t = self.video.counter
        ix = np.arange(t0, t)
        jx = np.arange(t1, t)
        if ix.size == 0 or jx.size == 0:
            return
        ii, jj = np.meshgrid(ix, jx, indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        d = self.video.distance_rect(t0, t, t1, t, beta=beta).reshape(-1)
        es = planner.proximity_plan(
            d, ii, jj, np.concatenate([self.ii, self.ii_bad, self.ii_inac]),
            np.concatenate([self.jj, self.jj_bad, self.jj_inac]), t0, t1, t,
            rad, nms, thresh, self.max_factors, self.video.stereo)
        if len(es):
            self.add_factors(es[:, 0], es[:, 1], remove)
