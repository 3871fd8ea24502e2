"""Training-graph utilities (port of the JAX package's
``geom/graph_utils.py``).

``build_frame_graph`` (covisibility from flow distance) lives in
:func:`lgu_slam_tpu_torch.data.base.build_frame_graph_from_depths`; this
module provides the edge-list helpers used by the trainer and losses.
"""

from __future__ import annotations

import numpy as np


def graph_to_edge_list(graph: dict):
    """OrderedDict {i: [j...]} -> (ii, jj, kk) arrays
    (graph_utils.py:4-15)."""
    ii, jj, kk = [], [], []
    for s, (i, js) in enumerate(graph.items()):
        for j in js:
            ii.append(i)
            jj.append(j)
            kk.append(s)
    return (
        np.asarray(ii, np.int32),
        np.asarray(jj, np.int32),
        np.asarray(kk, np.int32),
    )


def keyframe_indicies(graph: dict):
    return np.asarray(sorted(graph.keys()), np.int32)


def chain_graph(n_frames: int, radius: int = 2):
    """The trainer's fallback local graph (train.py:120-122)."""
    return {
        i: [j for j in range(n_frames) if i != j and abs(i - j) <= radius]
        for i in range(n_frames)
    }
