"""The proximity edge planner in Python (a frozen copy of the port's
``proximity_plan_plain``, the JAX package's planner): distance-ranked edge
selection with non-maximum suppression."""

from __future__ import annotations

import numpy as np


def proximity_plan(d, ii, jj, existing_ii, existing_jj, t0, t1, t, rad, nms,
                   thresh, max_factors, stereo) -> np.ndarray:
    """The selected edges ``int64 [K, 2]`` from the candidate distances
    ``d`` of the grid ``[t0, t) x [t1, t)`` (row-major, with its ``ii``,
    ``jj``), suppressed around the ``existing`` edges: first the stereo
    self-edges and the ``rad`` neighbourhood of every frame, then the
    candidates under ``thresh`` in ascending distance (ties in index
    order), each with its reverse, until more than ``max_factors`` edges
    are chosen."""
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
