"""Host-side graph planning in C (``csrc/host/proximity_plan.c``, built by
the host compiler at first use and called through ctypes), with the
contract of the JAX package's native extension: :func:`proximity_plan`, the
distance-ranked proximity edge selection with non-maximum suppression that
``FactorGraph.add_proximity_factors`` runs, and :func:`dba_group_rows`.
A failed build raises; nothing falls back.  The ``*_plain`` functions are
the same planners in Python, for the tests.
"""

from __future__ import annotations

import ctypes

import numpy as np

from lgu_slam_tpu_torch.ops import _build


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), np.int32)


def _lib() -> ctypes.CDLL:
    lib = _build.load("proximity_plan")
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.proximity_plan.argtypes = [ptr, ptr, ptr, i64, ptr, ptr, i64, i64,
                                   i64, i64, i64, i64, ctypes.c_double, i64,
                                   ctypes.c_int, ptr, i64]
    lib.proximity_plan.restype = i64
    lib.dba_group_rows.argtypes = [ptr, i64, i64, i64, ptr]
    lib.dba_group_rows.restype = i64
    return lib


def proximity_plan(d, ii, jj, existing_ii, existing_jj, t0, t1, t, rad, nms,
                   thresh, max_factors, stereo) -> np.ndarray:
    """The selected edges, ``int64 [K, 2]`` (i, j), from the candidate
    distances ``d`` of the grid ``[t0, t) x [t1, t)`` (row-major, with its
    ``ii``, ``jj``), suppressed around the ``existing`` edges: first the
    stereo self-edges and the ``rad`` neighbourhood of every frame, then
    the candidates under ``thresh`` in ascending distance (ties in index
    order), each with its reverse, until more than ``max_factors`` edges
    are chosen (the JAX package's factor_graph.py:1249-1289)."""
    d = np.ascontiguousarray(np.asarray(d).reshape(-1), np.float32)
    ii, jj = _i32(ii), _i32(jj)
    eii, ejj = _i32(existing_ii), _i32(existing_jj)
    if not len(d) == len(ii) == len(jj) or len(eii) != len(ejj):
        raise ValueError("proximity_plan: mismatched candidate or edge "
                         "lists")
    n, rad = len(d), int(rad)
    first = sum((1 if stereo else 0) + 2 * min(i, rad + 1)
                for i in range(int(t0), int(t)))
    cap = first + 2 * n + 2
    out = np.empty((cap, 2), np.int32)
    m = _lib().proximity_plan(
        d.ctypes.data, ii.ctypes.data, jj.ctypes.data, n, eii.ctypes.data,
        ejj.ctypes.data, len(eii), int(t0), int(t1), int(t), rad, int(nms),
        float(thresh), int(max_factors), int(bool(stereo)), out.ctypes.data,
        cap)
    if m == -1:
        raise MemoryError("proximity_plan: out of memory")
    if m < 0:
        raise RuntimeError("proximity_plan: output buffer too small")
    return out[:m].astype(np.int64)


def proximity_plan_plain(d, ii, jj, existing_ii, existing_jj, t0, t1, t,
                         rad, nms, thresh, max_factors,
                         stereo) -> np.ndarray:
    """:func:`proximity_plan` in Python (the JAX package's Python planner;
    ties rank in index order, as the native planner's stable sort does)."""
    d = np.array(np.asarray(d).reshape(-1), np.float32)
    ii = np.asarray(ii).reshape(-1)
    jj = np.asarray(jj).reshape(-1)
    d[ii - rad < jj] = np.inf
    d[d > 100] = np.inf

    def nms_suppress(i, j):
        for di in range(-nms, nms + 1):
            for dj in range(-nms, nms + 1):
                if abs(di) + abs(dj) <= max(min(abs(i - j) - 2, nms), 0):
                    i1, j1 = i + di, j + dj
                    if t0 <= i1 < t and t1 <= j1 < t:
                        d[(i1 - t0) * (t - t1) + (j1 - t1)] = np.inf

    for i, j in zip(np.asarray(existing_ii).tolist(),
                    np.asarray(existing_jj).tolist()):
        nms_suppress(i, j)

    es = []
    for i in range(t0, t):
        if stereo:
            es.append((i, i))
            if t1 <= i:
                d[(i - t0) * (t - t1) + (i - t1)] = np.inf
        for j in range(max(i - rad - 1, 0), i):
            es.append((i, j))
            es.append((j, i))
            if t1 <= j < t:
                d[(i - t0) * (t - t1) + (j - t1)] = np.inf

    for k in np.argsort(d, kind="stable"):
        if d[k] > thresh:
            continue
        if len(es) > max_factors:
            break
        i, j = int(ii[k]), int(jj[k])
        es.append((i, j))
        es.append((j, i))
        nms_suppress(i, j)
    return np.asarray(es, np.int64).reshape(-1, 2)


def dba_group_rows(ii, num_frames: int, dmax: int) -> np.ndarray:
    """``int32 [num_frames, dmax]``: frame k's own row k first, then the
    rows ``num_frames + e`` of the edges e whose ``ii[e] == k`` in edge
    order, -1 padding; edges outside ``[0, num_frames)`` are skipped.  A
    frame of more than ``dmax - 1`` edges raises ``ValueError``."""
    ii = _i32(ii)
    num_frames, dmax = int(num_frames), int(dmax)
    if dmax < 1:
        raise ValueError(f"dba_group_rows: dmax {dmax} < 1")
    rows = np.empty((num_frames, dmax), np.int32)
    status = _lib().dba_group_rows(ii.ctypes.data, len(ii), num_frames,
                                   dmax, rows.ctypes.data)
    if status < 0:
        raise MemoryError("dba_group_rows: out of memory")
    if status > 0:
        raise ValueError(f"frame {status - 1} degree exceeds dmax {dmax}")
    return rows


def dba_group_rows_plain(ii, num_frames: int, dmax: int) -> np.ndarray:
    """:func:`dba_group_rows` in numpy."""
    ii = np.asarray(ii).reshape(-1)
    if dmax < 1:
        raise ValueError(f"dba_group_rows: dmax {dmax} < 1")
    rows = np.full((num_frames, dmax), -1, np.int32)
    rows[:, 0] = np.arange(num_frames)
    fill = np.ones(num_frames, np.int64)
    for e, k in enumerate(ii.tolist()):
        if not 0 <= k < num_frames:
            continue
        if fill[k] >= dmax:
            raise ValueError(f"frame {k} degree exceeds dmax {dmax}")
        rows[k, fill[k]] = num_frames + e
        fill[k] += 1
    return rows
