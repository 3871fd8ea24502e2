#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lgu_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Twenty-four phases; any failure exits non-zero.

1. Build the CUDA kernels from ``lgu_slam_tpu_torch/csrc`` with nvcc for
   sm_90a, all at once (printing ptxas' register/shared-memory summary),
   and hold each kernel against its plain PyTorch version on the card: K1
   (both kernels: fp32 operands on the 3xTF32 wgmma kernel, on features
   holding bf16 values and on full-mantissa fp32 features; bf16 operands on
   the bf16 wgmma kernel; fp32 and bf16 volumes) at the tracking shapes
   (E = 48 edges, 48 x 64 feature maps) and at odd geometries, with windows
   across tile edges; K2 at odd geometries and at E = 1, 2, 8, 24 and 48
   (the motion filter's probe, backend sub-chunks, the frontend's mean, the
   TPU probes' shape), with out-of-bounds coordinates and offsets beyond the
   +-4 clip, timed at each E beside its corner and 32-byte-sector bounds;
   K3/K4 (``window_lookup``) at E = 48,
   P1 = 3072 on bf16 planes of 48 x 64, 24 x 32 (49 taps, and the 9-tap
   probe), 12 x 16, 6 x 8 and 13 x 17, with out-of-bounds and NaN
   positions, timed on the device alone (a CUDA graph over input copies
   whose launches touch more than twice the L2 between two launches on
   one copy) beside its byte and 32-byte-sector bounds;
   K5 (``row_gather``) and K6 (``k2_stream_floor``, ``k2_one_level``) at
   the shapes of their TPU probes (E = 48, 48 x 64; [48, 3072, 24, 128])
   and at odd geometries, then the probes' own entry point,
   ``scripts/profile_torch_k2_parts.py``, which times them (K6
   ``one_level`` on the device alone, beside its sector bound).
2. Run ``LGUSlam.track`` and then ``terminate(stream)`` at a tiny size
   (64 x 96, fp32 dtypes, thresholds 0) on a synthetic stream twice -- on
   the card with the kernels and on the CPU with the plain versions, from
   one state dict -- and compare the keyframes, the edge lists, the
   keyframe poses and the filled trajectories; then one train step at
   64 x 96 (batch 1, 3 frames, 3 iterations) on both devices from one state
   dict: the loss, every metric, every gradient and the weights after the
   optimizer step.  The fp32 configuration launches K1's fp32-operand
   (3xTF32) kernel only.
3. Run ``LGUSlam.track`` at the full width of the default ``SLAMConfig()``
   (384 x 512 images, bf16 volumes/features/convs) on synthetic frames with
   random weights, thresholds 0 so that every frame is a keyframe and the
   frontend runs, then a few frames with the keyframe gate closed.  The
   kernels' launch counters must match the probes, pyramid rebuilds and
   GRU iterations the run made; every K1 launch is the bf16-operand
   kernel (bf16 keyframe store, bf16 encoder).  K2's launches are reported
   per edge count.
4. Run ``terminate(stream)`` on phase 3's system (backend passes of 7 and
   12 steps over its 24 keyframes, then the trajectory filled for the 28
   frames).  K2's launches must equal the backend's correlation
   sub-chunks plus the filler's GRU iterations, K1's (bf16 operands) the
   filler's pyramid rebuilds.
5. Train at the full width of the default ``TrainConfig()`` (384 x 512,
   batch 2, 4 frames, 10 edges per clip, 9 iterations, fp32) on synthetic
   clips for 3 steps: the loss, the metrics, every gradient and the weights
   stay finite, the weights move, and neither K1 nor K2 launches (the
   training forward is the differentiable formulation).
6. Run ``LGUSlam.track`` at full width in the fp32 configuration (the JAX
   package's evaluation dtypes: fp32 volumes, features and convolutions),
   10 keyframes with thresholds 0: every K1 launch is the fp32-operand
   kernel (probes + pyramid rebuilds), K2's launches are probes + GRU
   iterations; the median ms per keyframe update and the peak memory.
7. The multi-device paths at world size 1, under NCCL on one process group
   (``tcp://127.0.0.1`` at a free port, destroyed at the end): one sharded
   DBA step (12 frames of 48 x 64, 2 Gauss-Newton iterations) against the
   one-process ``dba_step`` on the same inputs; the sharded backend pass
   over 12 full-width keyframes tracked from phase 3's frames, through
   ``Backend`` over the group (K2's launches must equal the sharded
   sub-chunks times the steps), and once more with the edges sorted by
   source frame, where its chunks are the one-process pass's, against that
   pass from the same state; one full-width ``TrainConfig()`` step under
   ``data_parallel`` (DistributedDataParallel) against a plain
   ``train_step`` from the same weights, batch and carry: the loss, the
   clipped gradients and the weights after the step (a weight whose
   gradient's sign is held to fp32 rounding).  Each is timed beside its
   one-process path.
8. The entry points a user runs, through their ``main`` functions, on
   sequences written to disk with the port's own PNG encoder (rendered
   along known trajectories by ``data/synthetic.py``): a 40-frame TUM
   RGB-D sequence (480 x 640, fr1, 16-bit depth) and a 16-frame EuRoC
   stereo sequence (752 x 480 gray pairs), with a reference ``.pth`` of
   random weights (``module.`` prefixes, 3-output heads).
   ``scripts/demo_torch.py`` mono and RGB-D at full width (undistorted and
   resized to 384 x 512, thresholds 0, every 2nd frame),
   ``scripts/evaluate_tum_torch.py`` (240 x 320) and
   ``scripts/evaluate_euroc_torch.py`` (stereo, rectified to 320 x 512):
   each run's trajectory has a finite pose per frame and launched K1 (the
   bf16-operand kernel) and K2.  Beside them, the host's ms per frame of
   decoding, undistorting or rectifying, and resizing, and the demo's ms
   per tracked frame.  The mono demo runs with ``--upsample`` and writes
   its reconstruction ``.npz`` for phase 9, and with ``--export_every 4``
   its growing ``.ply`` snapshots (multi-view depth filter and dirty-flag
   export on the card).
9. The 3DGS stage (``gs/``; it launches none of the kernels, which is
   checked): the renderer and one mapping step on the card against the
   CPU on a 96 x 128 synthetic frame; ``scripts/bench_gs_mapping_torch.py``
   (one mapping iteration at 680 x 1200 with 200,000 live Gaussians of a
   400,000-capacity map: ms per iteration, peak memory, truncation
   telemetry); ``GaussianMapper`` under the Replica preset's schedule (60
   iterations per frame, window 24, pruning every 20) over 8 synthetic
   frames of 384 x 512 with ground-truth depth and poses: ms per mapped
   frame, the Gaussian count, the loss from the first iteration to the
   last, PSNR and depth L1 of ``gs/eval.py`` (PSNR must rise above the
   first frame's before mapping), and a TSDF mesh of the renders, which
   must not be empty; then ``scripts/gs_slam_torch.py --mesh`` on phase
   8's reconstruction (3 frames), which must write a scene and a mesh.
   The export: the mono demo's final snapshot holds a camera per keyframe
   and finite points; ``backproject_points`` on the card against the CPU
   on phase 8's reconstruction; ``scripts/view_reconstruction_torch.py``
   on the card writes the card's filtered cloud.
10. JPEG frames, the native planner, the live viewer and the frame-graph
   helpers.  Seeded 480 x 640 frames through the port's encoder
   (``encode_jpeg``, quality 95: 4:2:0, 4:4:4, 4:2:0 with restart markers)
   and its C decoder: PSNR against the source, the host's ms per decode
   and per fed frame (decode + resize to 384 x 512), medians of 20.  A
   24-frame ScanNet-layout RGB-D sequence (480 x 640 JPEG colour, 16-bit
   depth, poses) read through the port's ``ScanNet`` loader and tracked by
   ``track()`` + ``terminate()`` at the full width of ``SLAMConfig()``
   (384 x 512, bf16, thresholds 0): K1 and K2 launch, the poses are finite,
   the ms per keyframe update.  A Replica-layout scene (4 frames of 680 x
   1200) read through ``ReplicaDataset``: its frames equal the encoder's
   bytes decoded on the host.  ``demo_torch --viewer`` on a 12-frame JPEG
   image directory at full width: ``GET /``, ``/cloud``, another path (the
   page, as the JAX viewer serves it) and ``/cloudy?have=<version>`` (304)
   while the viewer is up, the version advanced and the points and cameras
   are the reconstruction's.  The C planner against its Python version on a
   t = 512 candidate grid (262,144 distances, 3,000 stored edges, the
   backend's parameters): equal edge lists, the host ms of each.  And
   ``FactorGraph.filter_edges``, ``Video.reproject`` and
   ``Video.distance_matrix`` on phase 3's state (copied before phase 4's
   ``terminate()``), cuda against cpu.
11. The oracle pipeline of ``tests/test_torch_oracle_pipeline.py`` (the
   real Frontend and Backend, the learned update replaced by the
   ground-truth oracle of ``tests/torch_oracle.py``, loaded from its file)
   at the full width of ``SLAMConfig()`` (384 x 512, a 48 x 64 grid), 24
   frames: once in this process, once through ``Backend(group=)`` on the
   NCCL group of world size 1 that phase 7 runs on; each must keep its
   Sim(3)-aligned ATE below 1 % of the trajectory's extent and cull a
   keyframe, and K1 and K2 launch 0 times (counted): the ATE, the ms per
   oracle keyframe update beside phase 3's learned one, the backend pass.
   ``models.gru.ConvGRU(128, 320)`` at E = 48 over 48 x 64, cuda against
   cpu (a few edges; TF32 convolutions) and timed.  ``FactorGraph.update``
   on phase 3's state (its graph's edges among the newest 4 keyframes,
   copied before ``terminate()``), cuda against cpu.  On the host, which
   has no OpenCV: the port's lossless fixtures of the image modes its
   readers took in last (PNG palette with tRNS and gray at 1-8 bits, plain
   and Adam7; Adam7 colour and 16-bit; BMP 8-, 24- and 32-bit, bottom-up
   and top-down) read back as the pixels written, and a 480 x 640 JPEG cut
   after a restart marker decodes to the full shape, its rows before the
   cut as the whole file's and the MCU rows past it gray.
12. The depth and frame formats ``cv2.imread`` reads that the port took in
   last, on the card machine's host (which has no OpenCV) with the port's
   own encoders: a rendered 480 x 640 frame and its depth through TIFF
   (LZW RGB; Deflate float32 depth with the floating-point predictor;
   tiled big-endian), 16-bit PGM, PPM, PFM, RLE8 BMP, each read back as
   written, and a CMYK JPEG within 35 dB of OpenCV's conversion of its
   source; the host's median decode ms of each.  A 24-frame TUM fr1
   sequence written twice, PPM colour with float32 TIFF depth and PNG
   colour with 16-bit PNG depth of the same values, read through
   ``evaluate_tum_torch``'s stream (``tum_rgbd_stream``) and resized to
   384 x 512: both streams feed equal frames and depth; each is tracked
   with depth at the full width of ``SLAMConfig()`` (bf16, thresholds 0)
   and ``terminate()``d: K1's launches in ``track()`` equal the probes
   plus the pyramid rebuilds, K2's the probes plus the GRU iterations, the
   trajectories are finite; the host ms to feed a frame, the ms per
   keyframe update.  ``rgbd_stream`` over 8 frames of 16-bit PGM depth
   (NYU Depth v2's raw form): the millimetres written.
13. The formats the port read last, on the card machine's host with the
   port's own encoders: a rendered 480 x 640 frame as arithmetic-coded
   JPEG, sequential and progressive (each must decode to the samples of
   the Huffman file of the same coefficients), lossless gray JPEG (the
   samples), JPEG-compressed TIFF in strips and in tiles (YCbCr 4:2:0,
   within 30 dB of the source) and its depth as a float64 BigTIFF (the
   values); the host's median decode ms of each.  A 24-frame TUM fr1
   sequence written twice, arithmetic JPEG colour with float64 BigTIFF
   depth and Huffman JPEG colour (the same coefficients) with 16-bit PNG
   depth (the same values), tracked as in phase 12: both streams feed
   equal frames and depth, and ``track()`` makes equal K1 and K2 launches
   over them.
14. WebP, GIF, Radiance HDR and Sun raster on the card machine's host:
   a rendered 480 x 640 frame and its depth through the port's own
   encoders (lossless WebP, GIF on a colour cube, run-length HDR depth
   read with and without ``anydepth``, 24-bit and colour-map Sun raster),
   each read back as written, and the committed lossy, alpha and animated
   WebP files of ``tests/data/webp`` (libwebp's, from
   ``scripts/make_webp_fixtures_torch.py``) decoded to the SHA-256 of
   ``cv2.imread``'s arrays in both read modes;
   the host's median decode ms of each; byte-encoded and RGB-order Sun
   raster files refused as OpenCV refuses them.  A 16-frame TUM fr1
   sequence written twice, lossless WebP colour with HDR depth and PNG
   colour with float32 TIFF depth of the values the HDR files hold,
   tracked as in phase 12: both streams feed equal frames and depth, and
   ``track()`` makes equal K1 and K2 launches over them.
15. The TIFF files the port reads since its CCITT, old-style LZW, extra
   sample, CMYK, YCbCr, CIE L*a*b* and SGI LogL readers, on the card
   machine's host: a rendered 480 x 640 frame and its depth through the
   port's own encoders (Group 4 and Group 3 2-D, old-style LZW, gray with
   alpha, CMYK, YCbCr 2 x 2, L*a*b*, LogL), each read back as written or
   within its PSNR, and the committed files of libtiff's own encoders
   (``tests/data/tiff`` but phases 17 and 18's, from
   ``scripts/make_tiff_fixtures_torch.py``)
   decoded to the SHA-256 of ``cv2.imread``'s arrays in both read modes;
   the host's median decode ms of each; a 16-bit palette, 16-bit CMYK and
   old-style JPEG refused as OpenCV refuses them.  A 16-frame TUM fr1
   sequence written twice, uncompressed YCbCr TIFF colour with 16-bit LZW
   TIFF depth and the PNG of the frames those TIFFs read as with 16-bit
   PNG depth of the same values, tracked as in phase 12: both streams feed
   equal frames and depth, ``track()`` makes equal K1 and K2 launches over
   them, and the TIFF stream's host ms per fed frame against the PNG's.
16. JPEG 2000 on the card machine's host: a rendered 480 x 640 frame and
   its 16-bit depth through the port's lossless writer (5/3, the RCT), each
   read back as written; the committed files of ``tests/data/jp2`` but
   phase 18's (from ``scripts/make_jp2_fixtures_torch.py``: Pillow's,
   ``cv2.imwrite``'s and OpenJPEG's, among them a whole 480 x 640 frame at
   ``cv2.imwrite``'s default and one in 9/7) decoded to the SHA-256 of
   ``cv2.imread``'s
   arrays in both read modes; the host's median decode ms of each; signed
   and subsampled components, a CMYK colour space, a gray codestream read
   in colour and a codestream without its EOC refused as OpenCV refuses
   them.  A 16-frame TUM fr1 sequence written twice, lossless JP2 colour
   with 16-bit JP2 depth and PNG colour with 16-bit PNG depth of the same
   values, tracked as in phase 12: both streams feed equal frames and
   depth, ``track()`` makes equal K1 and K2 launches over them, and the
   JP2 stream's host ms per fed frame against the PNG's.
17. The sharded backend's scaling script, ``scripts/
   bench_backend_scaling_torch.py``, at its defaults (t = 32, 2 steps, 3
   reps) on the card at world size 1 (its JSON line, the edge count, ms per
   pass, and the K1 / K2 launches of its passes), then with ``--device cpu
   --t 8 --steps 1 --reps 1`` at world sizes 1, 2 and 4 on the host
   (gloo); a one-step pass of the
   script's first graph on the card against the same pass on the CPU
   (same seed and weights), poses and disparities within phase 2's
   backend tolerance.  The TIFF files of ``tests/data/tiff`` that the
   port reads since its recounted strips, JPEG of separate planes, short
   JPEG strips, predicted YCbCr tiles and LogLuv32, against the SHA-256 of
   ``cv2.imread``'s arrays; one file of each kind cv2 returns None for
   that the port once refused as NotImplementedError, refused
   (ValueError); the host's decode ms of a 480 x 640 JPEG TIFF of
   separate planes.
18. TIFF LogLuv24 and 12-bit samples, and HTJ2K code blocks, on the card
   machine's host: the committed files of ``tests/data/tiff`` (LogLuv24
   of ``cv2.imwrite`` and of the port's encoder, 12-bit gray, RGB and
   signed tiles) and the HT files of ``tests/data/jp2`` (the port's HT
   writer: cleanup only, SigProp and MagRef, 9/7, tiles of 4 x 1024 code
   blocks, 1024 x 4 vertically causal, damaged, cut) decoded to the
   SHA-256 of ``cv2.imread``'s arrays (or refused where it returns None);
   a rendered 480 x 640 frame through the port's writer as HT JP2
   (lossless 5/3 and 9/7) and as EBCOT JP2 (lossless 5/3), its 16-bit
   depth as 12-bit TIFF, each read back (the 9/7 above a PSNR), with the
   host's median decode ms of each; HT files of more than one HT set or a
   quad's U_q past its bit-planes, a 12-bit TIFF read in colour and
   LogLuv24 of float samples refused.  A 16-frame TUM fr1 sequence written
   twice, HT JP2 colour with 12-bit TIFF depth and PNG colour with 16-bit
   PNG depth of the 12-bit values shifted up by 4, tracked as in phase 12:
   both streams feed equal frames and depth, ``track()`` makes equal K1
   and K2 launches over them, and the HT stream's host ms per fed frame
   against the PNG's.
19. The EXIF orientation of PNG and WebP files, and lossless AVIF, on the
   card machine's host: PNGs (8-bit colour in both byte orders, the
   ``eXIf`` chunk before and after the image data, and a 16-bit depth
   map) and lossless WebPs with an ``EXIF`` chunk at orientations 0-9,
   each read in both modes as the stored samples flipped and transposed
   by hand; the committed files of ``tests/data/avif`` (from
   ``scripts/make_avif_fixtures_torch.py``: libaom's through cv2.imwrite
   at speeds 0-9, 8 to 12 bits, colour and gray, screen content with
   palettes and intra block copy, Pillow's tiles, the port's writer's)
   decoded to the SHA-256 of ``cv2.imread``'s arrays, or refused where it
   returns None, the queued ones (lossy AV1, BT.601 colour, a sequence)
   raising NotImplementedError naming the feature; a rendered 480 x 640
   frame and its depth's top 12 bits through the port's AV1 writer, each
   read back as written, with the host's median decode ms; a cut and a
   damaged AVIF and one whose ``irot`` is not marked essential refused.
   A 16-frame TUM fr1 sequence written twice, lossless AVIF colour with
   12-bit AVIF depth and PNG colour with 16-bit PNG depth of the same
   12-bit values, tracked as in phase 12: both streams feed equal frames
   and depth, ``track()`` makes equal K1 and K2 launches over them, and
   the AVIF stream's host ms per fed frame against the PNG's.
20. Lossy AVIF on the card machine's host: the committed 480 x 640
   frames of cv2.imwrite (quality 95, OpenCV's default, 50, and 10-bit
   80: 4:2:0 under BT.601, quantiser matrices, delta q, deblocking, CDEF)
   decoded to the SHA-256 of ``cv2.imread``'s arrays in both modes, with
   the host's median decode ms; a 16-frame TUM fr1 sequence in the port
   writer's lossy 4:2:0 AVIF colour (``fixtures.LOSSY_AVIF``) with 12-bit
   lossless AVIF depth, each colour frame's AV1 planes equal to the
   writer's own reconstruction, tracked beside PNG colour of what those
   AVIF frames read back as with the 16-bit PNG depth, as in phase 12:
   both streams feed equal frames and depth, ``track()`` makes equal K1
   and K2 launches over them, and the AVIF stream's host ms per fed frame
   against the PNG's; the NotImplementedError of each committed file that
   holds a feature of a later reader (a sequence).
21. AVIF loop restoration and libavif's other YUV to RGB paths on the card
   machine's host: the committed 480 x 640 frames of cv2.imwrite at speed
   2 that restore (quality 30: self-guided luma, Wiener chroma; 60:
   switchable luma) decoded to the SHA-256 of ``cv2.imread``'s arrays in
   both modes, with the host's median decode ms and ms inside the
   restoration filter; a 16-frame TUM fr1 sequence in the writer's lossy
   4:2:0 AVIF colour with Wiener units on luma and self-guided units on
   chroma (``fixtures.LR_AVIF``) and 12-bit lossless AVIF depth, each
   colour frame's AV1 planes equal to the writer's own reconstruction,
   tracked beside PNG colour of what those frames read back as with 16-bit
   PNG depth, as in phase 12, with equal K1 and K2 launches in
   ``track()``; the committed 4:2:2, BT.709 and limited-range files
   against their hashes; the NotImplementedError of each committed file
   that holds a feature of a later reader.
22. AVIF film grain, grids, sequences and scaled frames on the card
   machine's host: the committed files (Pillow's grain with libaom's test
   vectors 1, 10 and 16 at 4:2:0, 4:4:4 and 4:0:0, the writer's 10-bit
   4:2:0 and 12-bit gray grain, a 1 x 2 and a cropped 2 x 2 grid with an
   alpha grid, Pillow's avis sequence, frames scaled down and up to their
   ispe) decoded to the SHA-256 of ``cv2.imread``'s arrays in both modes,
   with the host's median decode ms and ms of adding the grain; a
   16-frame TUM fr1 sequence in the writer's lossy 4:2:0 AVIF colour with
   film grain (``fixtures.GRAIN_AVIF``) and 12-bit AVIF depth with grain
   (``fixtures.GRAIN_DEPTH``), each colour frame the writer's file of its
   rendered frame with its grain, tracked beside PNG colour and 16-bit
   PNG depth of what those frames read back as, as in phase 12, with
   equal K1 and K2 launches in ``track()``; the NotImplementedError of
   each committed file that holds a feature of a later reader (none is
   left).
23. AVIF intra block copy, segmentation, superres and items of several
   frames on the card machine's host: the committed files (Pillow's
   lossless 4:2:0 / 4:2:2 and lossy 4:4:4 screen content, cv2's lossy
   text pages at 8 and 10 bits, the writer's 12-bit 4:2:2 lossy intra
   block copy, its segmented frames, superres
   frames with restoration over two tile columns and 14 samples wide,
   items of several frames, two AV1 frames in an item) decoded to the
   SHA-256 of ``cv2.imread``'s arrays in both modes, with the host's
   median decode ms and superres upscale ms; a rendered 480 x 640 frame
   through the writer with superres and restoration and one with
   segmentation, each decoding to the writer's reconstruction, with
   decode and upscale ms; a 16-frame TUM fr1 sequence in the writer's
   segmented superres AVIF colour (``fixtures.TOOLS_AVIF``) and 12-bit
   depth stored as items of three frames (``show_existing_frame``),
   tracked beside PNG colour and 16-bit PNG depth of the same values, as
   in phase 12, with equal K1 and K2 launches in ``track()``.
24. AV1 inter frames on the card machine's host: the committed layered
   (progressive) AVIF items cv2's libavif writes (2-4 layers, quality
   layers and scaled base layers, 8 / 10 / 12 bits, 4:2:0 / 4:4:4 / gray,
   alpha, lsel and a1op, two refused as cv2 refuses them) decoded to the
   SHA-256 of ``cv2.imread``'s arrays in both modes, with the host's
   median decode ms; for each of the eight committed 480 x 640 layered
   frames (a half-size base layer, then the full frame predicted from
   it) the median ms of its AV1 decode and of its inter prediction, the
   share printed with the card's name and power limit; a 16-frame TUM fr1
   sequence of those eight frames there and back, tracked beside the PNG
   of what they read back as (16-bit PNG depth in both), as in phase 12,
   with equal K1 and K2 launches in ``track()``.

Before the last line it prints the tracking, terminate, training, fp32
tracking, world-size-1, entry-point, 3DGS, JPEG, oracle, the five
format reports, the scaling report and phases 18 to 24's reports,
the run's wall time, the
card's name and power limit, and one JSON line with each kernel's error,
time, bound and launches.  The last line is ``{"ok": true, "device": {...}}``.
Data and weights come from fixed seeds; nothing needs the network.
"""

from __future__ import annotations

import hashlib
import http.client
import importlib.util
import inspect
import json
import socket
import struct
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from lgu_slam_tpu_torch.data import (avif, gif, hdr, jp2, pnm, sunras, tiff,
                                     webp)
from lgu_slam_tpu_torch.data.fixtures import (
    GRAIN_AVIF,
    GRAIN_DEPTH,
    LOSSY_AVIF,
    LR_AVIF,
    REPLICA_CAM,
    TOOLS_AVIF,
    TUM_FR1,
    gif_cube,
    render_sequence,
    write_euroc_sequence,
    write_frame,
    write_jpeg_imagedir,
    write_tum_with_colour,
    write_replica_scene,
    write_scannet_sequence,
    write_tum_sequence,
)
from lgu_slam_tpu_torch.data.image_io import (
    decode_jpeg,
    encode_bmp,
    encode_jpeg,
    encode_png,
    imread,
)
from lgu_slam_tpu_torch.data.imgproc import (
    NEAREST,
    FloatRemap,
    resize,
    undistort_maps,
)
from lgu_slam_tpu_torch.data.replica import ReplicaDataset
from lgu_slam_tpu_torch.data.rgbd_datasets import KNOWN_CAMERAS, ScanNet
from lgu_slam_tpu_torch.data.streams import (
    euroc_maps,
    rgbd_stream,
    tum_rgbd_stream,
)
from lgu_slam_tpu_torch.data.synthetic import (
    SyntheticDataset,
    SyntheticScene,
    make_trajectory,
)
from lgu_slam_tpu_torch.geom.dba import DbaPlan, dba_step
from lgu_slam_tpu_torch.geom.depth_filter import depth_filter
from lgu_slam_tpu_torch.geom.projective import projective_transform
from lgu_slam_tpu_torch.gs.configs import get_preset
from lgu_slam_tpu_torch.gs.eval import evaluate_renders
from lgu_slam_tpu_torch.gs.mapping import (
    GaussianMapper,
    GSConfig,
    adam_init,
    learning_rates,
    make_mapping_step,
)
from lgu_slam_tpu_torch.gs.params import PARAM_KEYS, pointcloud_from_depth
from lgu_slam_tpu_torch.gs.render import render_rgbd
from lgu_slam_tpu_torch.gs.tsdf import TSDFVolume
from lgu_slam_tpu_torch.lie import se3_exp, se3_inv, se3_mul, so3_matrix
from lgu_slam_tpu_torch.models.gru import ConvGRU
from lgu_slam_tpu_torch.models.net import LGUNet, init_state_dict
from lgu_slam_tpu_torch.ops import _build
from lgu_slam_tpu_torch.ops.k2_parts import (
    k2_one_level,
    k2_one_level_plain,
    k2_stream_floor,
    k2_stream_floor_plain,
)
from lgu_slam_tpu_torch.ops.masked_corr import (
    masked_corr_level0,
    masked_corr_level0_plain,
)
from lgu_slam_tpu_torch.ops.pyramid_lookup import (
    RD,
    fused_pyramid_lookup,
    fused_pyramid_lookup_plain,
    level_dims,
)
from lgu_slam_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from lgu_slam_tpu_torch.ops.sampler import sample_taps_flat, window_deltas
from lgu_slam_tpu_torch.ops.window_lookup import window_lookup
from lgu_slam_tpu_torch.parallel.backend_shard import backend_plan
from lgu_slam_tpu_torch.parallel.dba_shard import dba_step_sharded
from lgu_slam_tpu_torch.parallel.train_dp import (
    data_parallel,
    make_optimizer,
    train_step,
    window_edges,
)
from lgu_slam_tpu_torch.slam.backend import Backend
from lgu_slam_tpu_torch.slam.factor_graph import FactorGraph
from lgu_slam_tpu_torch.slam.motion_filter import MotionFilter
from lgu_slam_tpu_torch.slam.state import Video
from lgu_slam_tpu_torch.slam.system import LGUSlam
from lgu_slam_tpu_torch.slam.trajectory_filler import TrajectoryFiller
from lgu_slam_tpu_torch.slam.visualization import backproject_points
from lgu_slam_tpu_torch.utils import native
from lgu_slam_tpu_torch.utils.checkpoint import TRIMMED_HEADS
from lgu_slam_tpu_torch.utils.config import SLAMConfig, TrainConfig
from lgu_slam_tpu_torch.utils.device import use_full_fp32
from lgu_slam_tpu_torch.utils.measure import (
    BF16_FLOP_PER_S,
    FP32_FLOP_PER_S,
    TF32_FLOP_PER_S,
    bytes_ms,
    cold_graph_ms,
    cuda_ms,
    graph_ms,
    lookup_bytes,
    taps_plane_bytes,
)
from lgu_slam_tpu_torch.utils.synthetic import shifted_texture_frames

SEED = 0
KERNELS = ("masked_corr_tf32", "masked_corr_tc", "pyramid_lookup",
           "window_lookup", "row_gather", "k2_stream")
# K1's two kernels: (name, source, operand dtype)
K1_KERNELS = (
    ("masked_corr_level0_tf32", "masked_corr_tf32.cu", torch.float32),
    ("masked_corr_level0_tc", "masked_corr_tc.cu", torch.bfloat16))
SCRIPTS = Path(__file__).resolve().parent / "scripts"
PROBES = SCRIPTS / "profile_torch_k2_parts.py"
MAIN_E, MAIN_H, MAIN_W = 48, 48, 64  # frontend graph at 384 x 512
# K2's edge counts: the motion filter's probe, the backend's last sub-chunk
# of a chunk (phase 4 launches 223 of its 539 at E = 2) and a whole one,
# the frontend's mean, the TPU probes' shape
K2_EDGES = (1, 2, SLAMConfig().backend_sub_chunk, 24, MAIN_E)
# K3/K4 cases: (TPU kernel, its file:line, plane h x w, radius, max offset)
WINDOW_CASES = (
    ("window_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:172", 48,
     64, 3, 4),
    ("window_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:172", 24,
     32, 3, 4),
    ("window_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:172", 24,
     32, 1, 0),
    ("window_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:172", 13,
     17, 3, 4),
    ("dense_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:246", 12, 16,
     3, 0),
    ("dense_lookup_packed", "lgu_slam_tpu/ops/pallas_lookup.py:246", 6, 8,
     3, 0),
)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


# -- phase 1: kernels against their plain versions ---------------------------

def corr_inputs(gen, E, H, W, dev, full_mantissa=False):
    """fp32 features holding bf16 values (so that both K1 kernels see the
    same numbers), or with ``full_mantissa`` all 24 bits (so that the lo
    terms of the 3xTF32 kernel are exercised); means scattered around each
    pixel, a third of them on an integer and a third just below one
    (floor's edges), so that windows cross tile edges at every offset;
    covariances from 0.05 (a sharp Gaussian) to 20 (one felt at the
    window's edge)."""
    f1 = torch.randn(E, H, W, 128, generator=gen)
    f2 = torch.randn(E, H, W, 128, generator=gen)
    if not full_mantissa:
        f1, f2 = f1.bfloat16().float(), f2.bfloat16().float()
    f1, f2 = f1.to(dev), f2.to(dev)
    grid = torch.stack(torch.meshgrid(torch.arange(W), torch.arange(H),
                                      indexing="xy"), -1).float()
    mean = grid + 3.0 * torch.randn(E, H, W, 2, generator=gen)
    pick = torch.randint(0, 3, (E, H, W, 1), generator=gen)
    mean = torch.where(pick == 0, torch.round(mean), mean)
    mean = torch.where(pick == 1, torch.floor(mean) + 0.999, mean).to(dev)
    cov = 0.05 + 20.0 * torch.rand(E, H, W, 2, generator=gen) ** 2
    return f1, f2, mean, cov.to(dev)


def lookup_inputs(gen, E, H, W, dev, dtype):
    P1 = H * W
    levels = [torch.randn(E, P1, h * w, generator=gen).to(dev, dtype)
              for h, w in level_dims(H, W)]
    scale = torch.tensor([W, H], dtype=torch.float32)
    # coordinates from 20 % outside the plane on either side, offsets past
    # the +-4 clip
    cflat = ((torch.rand(E, P1, 2, generator=gen) * 1.4 - 0.2) * scale)
    off0 = torch.rand(E, P1, RD, RD, 2, generator=gen) * 9.0 - 4.5
    off1 = torch.rand(E, P1, RD, RD, 2, generator=gen) * 9.0 - 4.5
    return levels, cflat.to(dev), off0.to(dev), off1.to(dev)


def k1_check(args, tag):
    """K1 against its plain version on the same inputs, fp32 out (atol 2e-4,
    rtol 1e-4: a 128-channel dot summed in another order) and bf16 out
    (one bf16 step: |err| / (|ref| + 1) < 0.02).  Returns the max abs
    errors of the bf16 and the fp32 volumes."""
    out = masked_corr_level0(*args, out_dtype=torch.float32)
    ref = masked_corr_level0_plain(*args, out_dtype=torch.float32)
    torch.cuda.synchronize()
    err32 = (out - ref).abs().max().item()
    check(torch.allclose(out, ref, atol=2e-4, rtol=1e-4),
          f"K1 {tag} -> fp32: max err {err32}")
    del out, ref
    out = masked_corr_level0(*args, out_dtype=torch.bfloat16).float()
    ref = masked_corr_level0_plain(*args, out_dtype=torch.bfloat16).float()
    torch.cuda.synchronize()
    rel = ((out - ref).abs() / (ref.abs() + 1.0)).max().item()
    check(rel < 0.02, f"K1 {tag} -> bf16: rel err {rel}")
    return (out - ref).abs().max().item(), err32


def k1_cases(gen, dev) -> dict:
    """Both K1 kernels against the plain version at odd geometries (ragged
    last tiles; 7 x 9 rows of no multiple of 16 bytes) and at the tracking
    shapes, the fp32-operand kernel on bf16-valued and on full-mantissa
    features; then each timed at the tracking shapes (bf16 and fp32
    volumes) beside its bounds and one torch.bmm of the same operands (the
    product alone, fp32 without TF32), and at the probe's E = 1."""
    for E, H, W in ((3, 30, 40), (2, 7, 9), (1, 48, 64)):
        f1, f2, mean, cov = corr_inputs(gen, E, H, W, dev)
        k1_check((f1, f2, mean, cov), f"fp32 operands {E}x{H}x{W}")
        k1_check((f1.bfloat16(), f2.bfloat16(), mean, cov),
                 f"bf16 operands {E}x{H}x{W}")
        k1_check(corr_inputs(gen, E, H, W, dev, full_mantissa=True),
                 f"full-mantissa fp32 operands {E}x{H}x{W}")
    f1, f2, mean, cov = corr_inputs(gen, MAIN_E, MAIN_H, MAIN_W, dev,
                                    full_mantissa=True)
    k1_check((f1.bfloat16().float(), f2.bfloat16().float(), mean, cov),
             "bf16-valued fp32 operands main shapes")
    out = {}
    for name, source, dt in K1_KERNELS:
        args = (f1.to(dt), f2.to(dt), mean, cov)
        err, err32 = k1_check(args, f"{dt} operands main shapes")
        ms = cuda_ms(lambda: masked_corr_level0(*args,
                                                out_dtype=torch.bfloat16))
        ms32 = cuda_ms(lambda: masked_corr_level0(*args,
                                                  out_dtype=torch.float32))
        plain_ms = cuda_ms(lambda: masked_corr_level0_plain(
            *args, out_dtype=torch.bfloat16), reps=3, warmup=1)
        a = (args[0] / 4.0).reshape(MAIN_E, -1, 128)
        b = (args[1] / 4.0).reshape(MAIN_E, -1, 128).transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.bmm(a, b))
        del a, b
        # the motion filter's probe: one edge, timed on the device alone
        probe = tuple(x[:1] for x in args)
        probe_ms = graph_ms(lambda: masked_corr_level0(
            *probe, out_dtype=torch.bfloat16))
        bound, bound_by = k1_bound(MAIN_E, dt)
        operands = str(dt).replace("torch.", "")
        out[name] = dict(
            name=name, route="cuda",
            source=f"lgu_slam_tpu_torch/csrc/{source}",
            replaces="lgu_slam_tpu/ops/pallas_corr.py:61",
            operands=operands, max_abs_err=err, max_abs_err_fp32_out=err32,
            ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, library_ms=library_ms,
            library_call=f"torch.bmm of the {operands} operands (product "
                         "only; fp32 without TF32)",
            ms_fp32_out=ms32,
            bound_ms_fp32_out=k1_bound(MAIN_E, dt, torch.float32)[0],
            shapes=f"E={MAIN_E} {MAIN_H}x{MAIN_W} C=128 {operands} -> bf16 "
                   "(full-mantissa features)",
            probe_ms=probe_ms, probe_bound_ms=k1_bound(1, dt)[0])
        if dt == torch.float32:
            # the fp32 SIMT rate: the bound of the earlier kernel
            out[name]["simt_bound_ms"] = \
                1e3 * 2 * MAIN_E * (MAIN_H * MAIN_W) ** 2 * 128 \
                / FP32_FLOP_PER_S
        del args, probe
    return out


def k1_bound(E, dt, out_dt=torch.bfloat16):
    """K1's bound at E edges of the tracking shapes: the larger of its
    bytes (operands and mean/cov read once, the volume written once) over
    HBM's rate and its operations over the tensor cores' rate: for fp32
    operands three TF32 products (3xTF32), for bf16 one bf16 product."""
    P = MAIN_H * MAIN_W
    esize = torch.empty(0, dtype=dt).element_size()
    osize = torch.empty(0, dtype=out_dt).element_size()
    b_ms = bytes_ms(2 * E * P * 128 * esize + 2 * E * P * 2 * 4
                    + E * P * P * osize)
    flop = 2 * E * P * P * 128
    o_ms = 1e3 * (3 * flop / TF32_FLOP_PER_S if dt == torch.float32
                  else flop / BF16_FLOP_PER_S)
    return max(b_ms, o_ms), "operations" if o_ms >= b_ms else "bytes"


def phase_kernels(dev) -> dict:
    logs = _build.build_all(KERNELS)
    for name in KERNELS:
        print(f"== nvcc -gencode arch=compute_90a,code=sm_90a "
              f"lgu_slam_tpu_torch/csrc/{name}.cu")
        print(logs[name].strip())
    gen = torch.Generator().manual_seed(SEED)
    use_full_fp32()
    results = {}

    results.update(k1_cases(gen, dev))

    # K2 at odd halving chains and TUM's 30 x 40, both level dtypes
    for E, H, W in ((2, 12, 24), (2, 30, 40), (1, 13, 17)):
        for dt in (torch.float32, torch.bfloat16):
            lv, cflat, off0, off1 = lookup_inputs(gen, E, H, W, dev, dt)
            out = fused_pyramid_lookup(lv, cflat, off0, off1, H, W)
            ref = fused_pyramid_lookup_plain(lv, cflat, off0, off1, H, W)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(err < 2e-4, f"K2 {dt} {E}x{H}x{W}: max err {err}")
    results["fused_pyramid_lookup"] = k2_edge_cases(gen, dev)
    torch.cuda.empty_cache()

    for case in WINDOW_CASES:
        results[f"{case[0]}:{case[2]}x{case[3]}:r{case[4]}"] = \
            window_case(gen, dev, *case)
    torch.cuda.empty_cache()
    results.update(k2_parts_cases(gen, dev))
    torch.cuda.empty_cache()
    print("phase 1: kernels built for sm_90a and within tolerance of their "
          "plain versions")
    return results


def k2_edge_cases(gen, dev) -> dict:
    """K2 at the edge counts its call sites run, on the tracking planes,
    both level dtypes within 2e-4 of the plain version; timed (bf16 levels)
    on the device alone (a CUDA graph of 50 launches: at E = 1 the
    wrapper's host time exceeds the kernel's) and by CUDA events over
    launches back to back, beside its byte and 32-byte-sector bounds."""
    at = {}
    errs = []
    for E in K2_EDGES:
        for dt in (torch.float32, torch.bfloat16):
            lv, cflat, off0, off1 = lookup_inputs(gen, E, MAIN_H, MAIN_W,
                                                  dev, dt)
            out = fused_pyramid_lookup(lv, cflat, off0, off1, MAIN_H, MAIN_W)
            ref = fused_pyramid_lookup_plain(lv, cflat, off0, off1, MAIN_H,
                                             MAIN_W)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            check(err < 2e-4, f"K2 {dt} E={E} {MAIN_H}x{MAIN_W}: max err "
                  f"{err}")
            errs.append(err)
            del out, ref
            if dt != torch.bfloat16:
                continue

            def call():
                fused_pyramid_lookup(lv, cflat, off0, off1, MAIN_H, MAIN_W)

            at[E] = dict(
                ms=graph_ms(call), ms_eager=cuda_ms(call, reps=50),
                bound_ms=bytes_ms(lookup_bytes(lv, cflat, off0, off1, MAIN_H,
                                               MAIN_W)),
                sector_bound_ms=bytes_ms(lookup_bytes(
                    lv, cflat, off0, off1, MAIN_H, MAIN_W, sectors=True)))
            if E == MAIN_E:
                plain_ms = cuda_ms(lambda: fused_pyramid_lookup_plain(
                    lv, cflat, off0, off1, MAIN_H, MAIN_W), reps=3, warmup=1)
            del lv, cflat, off0, off1
    main = at[MAIN_E]
    return dict(
        name="fused_pyramid_lookup", route="cuda",
        source="lgu_slam_tpu_torch/csrc/pyramid_lookup.cu",
        replaces="lgu_slam_tpu/ops/pallas_lookup.py:524",
        max_abs_err=max(errs), ms=main["ms"], plain_ms=plain_ms,
        bound_ms=main["bound_ms"], bound_by="bytes",
        sector_bound_ms=main["sector_bound_ms"],
        library_ms=None, library_call=None,
        shapes=f"E={MAIN_E} {MAIN_H}x{MAIN_W} bf16 levels -> fp32 [E,P1,196]",
        at_edges=at)


def load_probes():
    """The K2-parts probes' entry point, scripts/profile_torch_k2_parts.py."""
    spec = importlib.util.spec_from_file_location("profile_torch_k2_parts",
                                                  PROBES)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def k2_parts_cases(gen, dev) -> dict:
    """K5 and K6 against their plain versions at odd geometries and at the
    probes' shapes; then the probes' entry point, whose launches are the
    kernels' path (counted from 0), and the plain and library times."""
    # odd geometries: rows that are no multiple of 8 (the scalar path of
    # the stream floor), fp32 planes, row indices outside [0, S)
    for E, H, W in ((2, 13, 17), (1, 12, 24)):
        lv, cflat, off0, off1 = lookup_inputs(gen, E, H, W, dev,
                                              torch.bfloat16)
        err = (k2_stream_floor(lv, cflat, off0, off1)
               - k2_stream_floor_plain(lv, cflat, off0, off1)).abs().max()
        check(err.item() < 1e-3, f"K6 stream {E}x{H}x{W}: max err {err}")
        for lvl in range(4):
            for v in (lv[lvl], lv[lvl].float()):
                err = (k2_one_level(v, cflat, lvl, H, W)
                       - k2_one_level_plain(v, cflat, lvl, H, W)).abs().max()
                check(err.item() < 2e-4, f"K6 level {lvl} {v.dtype} "
                      f"{E}x{H}x{W}: max err {err}")
    V = torch.randn(3, 40, 7, 48, generator=gen).to(dev, torch.bfloat16)
    s = torch.randint(-2, 9, (3, 40, 48), generator=gen, dtype=torch.int32)
    s = s.to(dev)
    check(torch.equal(row_gather(V, s), row_gather_plain(V, s)),
          "K5 with indices outside [0, S) differs from its plain version")

    probes = load_probes()
    inp = probes.probe_inputs(dev, SEED)
    lv, cflat, off0, off1, V, s = (inp[k] for k in ("levels", "cflat",
                                                     "off0", "off1", "V",
                                                     "s"))
    PH, PW = probes.H, probes.W
    errs = {"row_gather": (row_gather(V, s)
                           - row_gather_plain(V, s)).abs().max().item(),
            "k2_stream_floor": (
                k2_stream_floor(lv, cflat, off0, off1)
                - k2_stream_floor_plain(lv, cflat, off0, off1)).abs().max()
            .item()}
    for lvl in range(4):
        errs[f"k2_one_level:l{lvl}"] = (
            k2_one_level(lv[lvl], cflat, lvl, PH, PW)
            - k2_one_level_plain(lv[lvl], cflat, lvl, PH, PW)).abs().max()\
            .item()
    torch.cuda.synchronize()
    check(errs["row_gather"] == 0.0, f"K5: max err {errs['row_gather']}")
    check(errs["k2_stream_floor"] < 1e-3,
          f"K6 stream floor: max err {errs['k2_stream_floor']}")
    for lvl in range(4):
        err = errs[f"k2_one_level:l{lvl}"]
        check(err < 2e-4, f"K6 level {lvl}: max err {err}")

    # the probes' path, its launches counted from 0
    for fn in (row_gather, k2_stream_floor, k2_one_level):
        fn.launches = 0
    prof = probes.profile(dev, inp)
    launches = dict(row_gather=row_gather.launches,
                    k2_stream_floor=k2_stream_floor.launches,
                    k2_one_level=k2_one_level.launches)
    check(all(n > 0 for n in launches.values()),
          f"the probes' entry point launched {launches}")

    s64 = s.long()[:, :, None]
    srcs = [*lv, cflat, off0, off1]
    dsts = [torch.empty_like(x) for x in srcs]

    def copy_inputs():
        for d, x in zip(dsts, srcs):
            d.copy_(x)

    shapes = f"E={probes.E} {PH}x{PW} bf16 levels -> fp32 [E,P1,64]"
    out = {
        "row_gather": dict(
            name="row_gather", route="cuda",
            source="lgu_slam_tpu_torch/csrc/row_gather.cu",
            replaces="_prof_sublane.py:54", max_abs_err=errs["row_gather"],
            ms=prof["row_gather"]["ms"],
            plain_ms=cuda_ms(lambda: row_gather_plain(V, s), reps=3,
                             warmup=1),
            bound_ms=prof["row_gather"]["bound_ms"], bound_by="bytes",
            sector_bound_ms=prof["row_gather"]["sector_bound_ms"],
            sectors_of_v=prof["row_gather"]["sectors_of_v"],
            library_ms=cuda_ms(lambda: torch.gather(V, 2, s64)),
            library_call="torch.gather(V, 2, s) with int64 indices",
            launches=launches["row_gather"],
            launches_path="scripts/profile_torch_k2_parts.py",
            shapes=f"V bf16 {tuple(V.shape)}, s int32 {tuple(s.shape)} -> "
                   "fp32"),
        "k2_stream_floor": dict(
            name="k2_stream_floor", route="cuda",
            source="lgu_slam_tpu_torch/csrc/k2_stream.cu",
            replaces="_prof_kparts.py:58",
            max_abs_err=errs["k2_stream_floor"],
            ms=prof["k2_stream_floor"]["ms"],
            plain_ms=cuda_ms(lambda: k2_stream_floor_plain(
                lv, cflat, off0, off1), reps=3, warmup=1),
            bound_ms=prof["k2_stream_floor"]["bound_ms"], bound_by="bytes",
            library_ms=cuda_ms(copy_inputs),
            library_call="device-to-device copy_ of every input "
                         "(reads and writes the input bytes)",
            launches=launches["k2_stream_floor"],
            launches_path="scripts/profile_torch_k2_parts.py",
            k2_whole_ms=prof["k2_whole"]["ms"],
            k2_whole_bound_ms=prof["k2_whole"]["bound_ms"], shapes=shapes),
    }
    for lvl in range(4):
        key = f"k2_one_level_{lvl}"
        out[f"k2_one_level:l{lvl}"] = dict(
            name="k2_one_level", route="cuda",
            source="lgu_slam_tpu_torch/csrc/pyramid_lookup.cu",
            replaces="_prof_kparts.py:88",
            max_abs_err=errs[f"k2_one_level:l{lvl}"], ms=prof[key]["ms"],
            ms_eager=prof[key]["ms_eager"],
            plain_ms=cuda_ms(lambda lvl=lvl: k2_one_level_plain(
                lv[lvl], cflat, lvl, PH, PW), reps=3, warmup=1),
            bound_ms=prof[key]["bound_ms"], bound_by="bytes",
            sector_bound_ms=prof[key]["sector_bound_ms"],
            library_ms=None,
            library_call=None,
            launches=launches["k2_one_level"],
            launches_path="scripts/profile_torch_k2_parts.py (all levels)",
            shapes=f"level {lvl} ({prof[key]['plane']}) of {shapes}")
    return out


def window_inputs(gen, dev, h, w, radius, max_off):
    """K3/K4 inputs at E = 48, P1 = 3072: a bf16 plane [h, w] per (edge,
    pixel); tap positions of a (2r+1)^2 window plus offsets up to
    +-max_off around bases from 20 % outside the plane on either side,
    some of them NaN."""
    E, P1 = MAIN_E, MAIN_H * MAIN_W
    vol = torch.randn(E, P1, h * w, generator=gen).to(dev, torch.bfloat16)
    base = (torch.rand(E, P1, 2, generator=gen) * 1.4 - 0.2) \
        * torch.tensor([w, h], dtype=torch.float32)
    K = (2 * radius + 1) ** 2
    off = (torch.rand(E, P1, K, 2, generator=gen) * 2 - 1) * max_off
    dx, dy = window_deltas(radius)
    px = base[..., 0:1] + off[..., 0] + dx
    py = base[..., 1:2] + off[..., 1] + dy
    px[:, ::7, K // 2] = float("nan")
    py[:, 3::11, 0] = float("nan")
    return vol, px.to(dev), py.to(dev)


def window_case(gen, dev, name, replaces, h, w, radius, max_off) -> dict:
    """Hold K3/K4 against sample_taps_flat at one geometry; time both, the
    kernel on the device alone (a CUDA graph over input copies,
    ``cold_graph_ms``) and by CUDA events over eager launches, beside its byte
    and 32-byte-sector bounds."""
    vol, px, py = window_inputs(gen, dev, h, w, radius, max_off)
    out = window_lookup(vol, h, w, px, py)
    ref = sample_taps_flat(vol, h, w, px, py)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    check(err < 2e-4, f"{name} {h}x{w} r={radius}: max err {err}")
    check(bool(torch.isfinite(out).all()), f"{name} {h}x{w}: non-finite")
    del out, ref
    io = 3 * px.numel() * 4
    esize = vol.element_size()
    touched = io + taps_plane_bytes(px, py, h, w, esize, sectors=True)
    ms = cold_graph_ms(lambda v, x, y: window_lookup(v, h, w, x, y),
                       (vol, px, py), touched)
    ms_eager = cuda_ms(lambda: window_lookup(vol, h, w, px, py))
    plain_ms = cuda_ms(lambda: sample_taps_flat(vol, h, w, px, py), reps=3,
                       warmup=1)
    E, P1, K = px.shape
    return dict(
        name=name, route="cuda",
        source="lgu_slam_tpu_torch/csrc/window_lookup.cu",
        replaces=replaces, max_abs_err=err, ms=ms, ms_eager=ms_eager,
        plain_ms=plain_ms,
        bound_ms=bytes_ms(io + taps_plane_bytes(px, py, h, w, esize)),
        bound_by="bytes",
        sector_bound_ms=bytes_ms(touched),
        library_ms=None, library_call=None,
        shapes=f"E={E} P1={P1} bf16 plane {h}x{w}, K={K} -> fp32 [E,P1,K]")


# -- phases 2 and 3: track() --------------------------------------------------

def tiny_config() -> SLAMConfig:
    """The configuration of the JAX package's end-to-end test, in fp32."""
    return SLAMConfig(
        image_size=(64, 96), buffer=24, warmup=5, filter_thresh=0.0,
        keyframe_thresh=0.0, frontend_window=8, frontend_iters1=2,
        frontend_iters2=1, max_factors=24, edge_bucket=32, inactive_bucket=32,
        backend_edge_cap=64, backend_chunk=32, volume_dtype="float32",
        feat_dtype="float32", compute_dtype="float32")


def reset_counts():
    """Every count of K1 and K2 to 0."""
    masked_corr_level0.launches = 0
    masked_corr_level0.launches_bf16 = 0
    masked_corr_level0.launches_fp32 = 0
    masked_corr_level0.edges = 0
    fused_pyramid_lookup.launches = 0
    fused_pyramid_lookup.launches_by_edges = {}


def phase_small_track(dev, kernels: dict):
    cfg = tiny_config()
    sd = init_state_dict(cfg, SEED)
    frames = list(shifted_texture_frames(14, 64, 96, SEED + 3))
    runs = []
    for where in (dev, torch.device("cpu")):
        if where == dev:
            reset_counts()
        slam = LGUSlam(sd, cfg, device=where)
        for t, img, intr in frames:
            slam.track(float(t), img, intrinsics=intr)
        g = slam.frontend.graph
        n = slam.video.counter
        # copies: the backend rescales the poses in place
        track = (n, g.ii.copy(), g.jj.copy(),
                 slam.video.poses[:n].cpu().clone())
        with warnings.catch_warnings():  # the 16*t budget is capped at 64
            warnings.simplefilter("ignore", UserWarning)
            traj = slam.terminate(stream=iter(frames), backend_steps=(2, 1))
        runs.append(track + (slam.video.poses[:n].cpu().clone(), traj))
        if where == dev:
            k1_all = masked_corr_level0.launches
            k1_fp32 = masked_corr_level0.launches_fp32
            k1_bf16 = masked_corr_level0.launches_bf16
            k1_edges = masked_corr_level0.edges
    # the fp32 configuration runs K1's fp32-operand (3xTF32) kernel only
    check(k1_fp32 > 0 and k1_bf16 == 0 and k1_all == k1_fp32,
          f"tiny fp32 run: K1 launches {k1_all}, fp32-operand kernel "
          f"{k1_fp32}, bf16 kernel {k1_bf16}")
    kernels["masked_corr_level0_tf32"].update(launches_tiny=k1_fp32,
                                              edges_tiny=k1_edges)
    (n_c, ii_c, jj_c, p_c, b_c, x_c), (n_h, ii_h, jj_h, p_h, b_h, x_h) = runs
    check(n_c == n_h, f"keyframes: cuda {n_c} != cpu {n_h}")
    check(np.array_equal(ii_c, ii_h) and np.array_equal(jj_c, jj_h),
          "edge lists differ between cuda and cpu")
    err = (p_c - p_h).abs().max().item()
    # fp32 both sides; the two devices sum in different orders and the
    # difference grows through 14 frames of random-weight tracking
    check(err < 1e-2, f"keyframe poses: cuda vs cpu max err {err}")
    # terminate: on the card the backend's correlation is bf16 planes
    # through K2, on the CPU fp32 fused tap dots; the global BA amplifies
    # the tracking difference, and the filler's motion-only BA amplifies
    # any difference of its keyframes (tests/test_torch_terminate.py)
    check(x_c.shape == (14, 7) and np.isfinite(x_c).all(),
          f"cuda trajectory {x_c.shape} not finite")
    b_err = (b_c - b_h).abs().max().item()
    x_err = float(np.abs(x_c - x_h).max())
    check(b_err < 2e-2, f"backend keyframe poses: cuda vs cpu max err "
          f"{b_err}")
    check(x_err < 5e-2, f"trajectory: cuda vs cpu max err {x_err}")
    print(f"phase 2: tiny track() + terminate() agree on cuda and cpu: "
          f"{n_c} keyframes, {len(ii_c)} edges, pose max abs err "
          f"{err:.3g}, after the backend {b_err:.3g}, trajectory "
          f"{x_err:.3g}")


def synthetic_batch(db, idx, dev):
    """Clips ``idx`` of a SyntheticDataset as a training batch on ``dev``:
    (images, camera-to-world poses, full-resolution inverse depth,
    intrinsics)."""
    images, poses, depths, intr = (np.stack(x) for x in
                                   zip(*(db[i] for i in idx)))
    disps = np.where(depths > 0.01, 1.0 / np.maximum(depths, 0.01), 0.0)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(dev)
                 for x in (images, poses, disps, intr))


def phase_small_train(dev) -> dict:
    """One train step at 64 x 96 (batch 1, 3 frames, 3 iterations) on the
    card and on the CPU from one state dict, fp32 without TF32."""
    cfg = TrainConfig(batch=1, iters=3, steps=20, lr=1e-4, n_frames=3,
                      image_size=(64, 96))
    H, W = cfg.image_size
    sd = init_state_dict(SLAMConfig(), SEED)
    db = SyntheticDataset(n_scenes=1, frames_per_scene=5, n_frames=3,
                          crop_size=(H, W), seed=SEED)
    runs = []
    for where in (dev, torch.device("cpu")):
        net = LGUNet(device=where)
        net.load_state_dict(sd)
        opt = make_optimizer(net, cfg)
        ii, jj = (torch.from_numpy(x).to(where) for x in window_edges(3))
        metrics, _ = train_step(
            net, opt, synthetic_batch(db, [1], where),
            torch.zeros(1, 3, 7, device=where),
            torch.zeros(1, 3, H // 8, W // 8, device=where), cfg=cfg, ii=ii,
            jj=jj)
        runs.append(({k: v.item() for k, v in metrics.items()},
                     {n: p.grad.cpu() for n, p in net.named_parameters()},
                     {n: p.detach().cpu() for n, p in net.named_parameters()}))
    (m_c, g_c, p_c), (m_h, g_h, p_h) = runs
    # shares under a threshold move by one edge's (bad_rot, bad_tr: 1/6) or
    # one pixel's (1px) share when a value crosses it
    shares = ("bad_rot", "bad_tr", "1px")
    metric_err = {k: abs(m_c[k] - m_h[k]) / max(abs(m_h[k]), 1e-3)
                  for k in m_h if k not in shares}
    check(all(abs(m_c[k] - m_h[k]) <= 1 / 6 + 1e-6 for k in shares),
          f"train step shares cuda vs cpu: {m_c} {m_h}")
    # the gradients' relative difference per tensor, against a floor of
    # 1e-4 of the largest gradient (the biases that the encoder's instance
    # norm cancels have gradients of fp32 noise)
    floor = 1e-4 * max(g.abs().max().item() for g in g_h.values())
    grad_err = {n: (g_c[n] - g_h[n]).abs().max().item()
                / max(g_h[n].abs().max().item(), floor) for n in g_h}
    lr = opt.schedule(0)
    step_diff = torch.cat([(p_c[n] - p_h[n]).abs().reshape(-1) for n in p_h])
    worst = max(grad_err, key=grad_err.get)
    report = dict(
        metric_max_rel_err=max(metric_err.values()),
        grad_max_rel_err=grad_err[worst], grad_worst_tensor=worst,
        grad_median_rel_err=statistics.median(grad_err.values()),
        weights_max_abs_diff=step_diff.max().item(), lr=lr,
        weights_share_beyond_1pct_lr=(step_diff > 0.01 * lr).float().mean()
        .item())
    # the JAX package and the port agree on the CPU to 2e-4 (metrics) and
    # 2e-2 (the encoder's gradients, tests/test_torch_train.py); the card
    # sums in other orders, with atomics in the gathers' backward, and its
    # convolutions pick other algorithms: a few times those
    check(report["metric_max_rel_err"] < 5e-4,
          f"train step metrics cuda vs cpu: {metric_err}")
    check(report["grad_max_rel_err"] < 0.1,
          f"train step gradients cuda vs cpu: {worst} {grad_err[worst]}")
    check(report["weights_max_abs_diff"] <= 2 * lr + 1e-6,
          f"weights after the step differ by {report['weights_max_abs_diff']}")
    check(report["weights_share_beyond_1pct_lr"] < 0.05,
          f"weights after the step: {report['weights_share_beyond_1pct_lr']}"
          " of the entries differ by more than 1 % of the learning rate")
    print(f"phase 2: tiny train step agrees on cuda and cpu: metrics "
          f"{report['metric_max_rel_err']:.3g}, gradients "
          f"{report['grad_max_rel_err']:.3g} ({worst}), weights "
          f"{report['weights_max_abs_diff']:.3g}")
    return report


def sub_chunks(n_edges: int, chunk: int, sub_chunk: int) -> int:
    """K2 launches of one low-memory step: per chunk of ``chunk`` edges,
    one per sub-chunk (``sub_chunk`` halved until it divides the chunk)."""
    total = 0
    for lo in range(0, n_edges, chunk):
        e = min(chunk, n_edges - lo)
        sc = sub_chunk
        while e % sc:
            sc //= 2
        total += e // sc
    return total


class CallCounts:
    """Counts the calls that launch the kernels, independently of the
    wrappers' own launch counters, and times the backend passes and the
    filler's batches, while it is entered (it patches the methods and
    restores them on exit)."""

    def __init__(self):
        self.probes = self.rebuilds = self.iterations = 0
        self.lowmem = []  # (edges, steps) per FactorGraph.update_lowmem
        self.backend_ms = []  # per Backend call
        self.fill_ms = []  # per TrajectoryFiller batch
        self._saved = []

    def _patch(self, cls, name, wrap):
        orig = getattr(cls, name)
        self._saved.append((cls, name, orig))
        setattr(cls, name, wrap(orig))

    @staticmethod
    def _timed(out):
        def wrap(orig):
            def timed(*a, **kw):
                torch.cuda.synchronize()
                t_start = time.perf_counter()
                result = orig(*a, **kw)
                torch.cuda.synchronize()
                out.append(1e3 * (time.perf_counter() - t_start))
                return result
            return timed
        return wrap

    def __enter__(self):
        counts = self

        def probe(orig):
            def counted(self_, gmap):
                counts.probes += 1
                return orig(self_, gmap)
            return counted

        def build(orig):
            def counted(self_):
                counts.rebuilds += 1
                return orig(self_)
            return counted

        def update_n(orig):
            def counted(self_, n, *a, **kw):
                if self_.n_edges > 0:
                    counts.iterations += n
                return orig(self_, n, *a, **kw)
            return counted

        def lowmem(orig):
            sig = inspect.signature(orig)

            def counted(self_, *a, **kw):
                args = sig.bind(self_, *a, **kw)
                args.apply_defaults()
                counts.lowmem.append((self_.n_edges, args.arguments["steps"]))
                return orig(self_, *a, **kw)
            return counted

        self._patch(MotionFilter, "_flow_probe", probe)
        self._patch(FactorGraph, "_build_pyramid", build)
        self._patch(FactorGraph, "update_n", update_n)
        self._patch(FactorGraph, "update_lowmem", lowmem)
        self._patch(Backend, "__call__", self._timed(self.backend_ms))
        self._patch(TrajectoryFiller, "_fill", self._timed(self.fill_ms))
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)


def phase_full_track(dev, kernels: dict, cfg: SLAMConfig, n_kf: int,
                     n_gated: int):
    """track() at full width with thresholds 0 (every frame a keyframe),
    then ``n_gated`` frames with the keyframe gate closed.  K1's launches
    must all be the kernel of the configuration's feature dtype, and equal
    the motion filter's probes plus the pyramid rebuilds; K2's the probes
    plus the GRU iterations."""
    H, W = cfg.image_size
    fp32 = cfg.feat_dtype == "float32"
    k1_name = "masked_corr_level0_tf32" if fp32 else "masked_corr_level0_tc"
    slam = LGUSlam(init_state_dict(cfg, SEED), cfg, device=dev)
    frames = list(shifted_texture_frames(n_kf + n_gated, H, W, SEED + 1))

    def k1_launches():  # those of the configuration's K1 kernel
        return (masked_corr_level0.launches_fp32 if fp32
                else masked_corr_level0.launches_bf16)

    reset_counts()
    window_lookup.launches = 0
    kf_ms, gated_ms, snap = [], [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with CallCounts() as calls:
        for t, img, intr in frames:
            if t == n_kf:
                slam.filter.thresh = float("inf")  # close the keyframe gate
            before = slam.video.counter
            t_start = time.perf_counter()
            slam.track(float(t), img, intrinsics=intr)
            torch.cuda.synchronize()
            dt = 1e3 * (time.perf_counter() - t_start)
            (kf_ms if slam.video.counter > before else gated_ms).append(dt)
            if t in (cfg.warmup - 1, n_kf - 1):  # after initialise / update
                snap[t] = (k1_launches(), fused_pyramid_lookup.launches)
    k1, k2 = k1_launches(), fused_pyramid_lookup.launches
    k1_all, k1_edges = masked_corr_level0.launches, masked_corr_level0.edges

    n = slam.video.counter
    poses = slam.video.poses[:n]
    disps = slam.video.disps[:n]
    check(n == n_kf, f"video.counter {n} != {n_kf} keyframes")
    check(bool(torch.isfinite(poses).all()), "non-finite keyframe poses")
    check(bool(torch.isfinite(disps).all()) and disps.min().item() >= 1e-3,
          "non-finite or unclamped disparities")
    check(slam.frontend.is_initialized, "the frontend never initialised")
    check(len(gated_ms) == n_gated, "the closed gate still took keyframes")
    check(k1 > 0 and k2 > 0, f"kernel launches K1={k1} K2={k2}")
    # SLAMConfig() keeps bf16 features and computes the encoder in bf16:
    # every K1 launch is the bf16-operand kernel; the fp32 configuration's
    # are all the fp32-operand (3xTF32) kernel
    check(k1 == calls.probes + calls.rebuilds,
          f"K1 {k1_name} launches {k1} != probes {calls.probes} + rebuilds "
          f"{calls.rebuilds}")
    check(k1_all == k1, f"K1 launches of the other kernel: {k1_all - k1}")
    check(k2 == calls.probes + calls.iterations,
          f"K2 launches {k2} != probes {calls.probes} + GRU iterations "
          f"{calls.iterations}")
    # per keyframe the initialised frontend took (probe included), and per
    # frame the closed gate turned away
    n_updates = n_kf - cfg.warmup
    tag = "_track_fp32" if fp32 else "_track"
    kernels[k1_name]["edges" + tag] = k1_edges
    for i, name in enumerate((k1_name, "fused_pyramid_lookup")):
        steady = snap[n_kf - 1][i] - snap[cfg.warmup - 1][i]
        kernels[name].update({
            "launches" + tag: (k1, k2)[i],
            "launches_per_keyframe" + tag: steady / n_updates})
        if n_gated:
            kernels[name]["launches_per_non_keyframe" + tag] = \
                ((k1, k2)[i] - snap[n_kf - 1][i]) / n_gated
    kernels["fused_pyramid_lookup"]["launches_by_edges" + tag] = dict(
        sorted(fused_pyramid_lookup.launches_by_edges.items()))
    g = slam.frontend.graph
    report = dict(
        frames=len(frames), keyframes=n, edges=g.n_edges,
        inactive_edges=len(g.ii_inac), probes=calls.probes,
        pyramid_rebuilds=calls.rebuilds, gru_iterations=calls.iterations,
        ms_per_keyframe_median=statistics.median(kf_ms[cfg.warmup:]),
        ms_per_warmup_keyframe_median=statistics.median(kf_ms[1:cfg.warmup]),
        ms_initialize_frame=kf_ms[cfg.warmup - 1],
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        k1_launches=k1, k2_launches=k2,
        k2_launches_by_edges=kernels["fused_pyramid_lookup"][
            "launches_by_edges" + tag])
    if n_gated:
        report["ms_per_non_keyframe_median"] = statistics.median(gated_ms)
    return report, slam, frames


def phase_terminate(slam, frames, kernels: dict) -> dict:
    """terminate(stream) at full width on phase 3's system."""
    cfg = slam.cfg
    n = slam.video.counter
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    with CallCounts() as calls:
        traj = slam.terminate(stream=iter(frames), backend_steps=(7, 12))
    torch.cuda.synchronize()
    ms_total = 1e3 * (time.perf_counter() - t_start)
    k1, k2 = masked_corr_level0.launches_bf16, fused_pyramid_lookup.launches
    k1_all, k1_edges = masked_corr_level0.launches, masked_corr_level0.edges

    check(traj.shape == (len(frames), 7), f"trajectory shape {traj.shape}")
    check(bool(np.isfinite(traj).all()), "non-finite trajectory")
    qn = np.linalg.norm(traj[:, 3:], axis=-1)
    check(bool(np.abs(qn - 1.0).max() < 1e-3),
          f"quaternion norms off 1 by {np.abs(qn - 1.0).max()}")
    check(bool(torch.isfinite(slam.video.poses[:n]).all()),
          "non-finite keyframe poses after the backend")
    check([s for _, s in calls.lowmem] == [7, 12],
          f"backend passes {calls.lowmem}")
    per_step = [sub_chunks(e, cfg.backend_chunk, cfg.backend_sub_chunk)
                for e, _ in calls.lowmem]
    backend_k2 = sum(s * c for (_, s), c in zip(calls.lowmem, per_step))
    check(k1 > 0 and k2 > 0, f"kernel launches K1={k1} K2={k2}")
    check(calls.probes == 0, "terminate() ran the motion filter")
    check(k1 == calls.rebuilds,
          f"K1 bf16 launches {k1} != filler pyramid rebuilds "
          f"{calls.rebuilds}")
    check(k1_all == k1, f"K1 fp32-operand launches {k1_all - k1} in "
          "terminate()")
    check(k2 == backend_k2 + calls.iterations,
          f"K2 launches {k2} != backend sub-chunks {backend_k2} + filler "
          f"GRU iterations {calls.iterations}")
    for name, k in (("masked_corr_level0_tc", k1),
                    ("fused_pyramid_lookup", k2)):
        kernels[name]["launches_terminate"] = k
    kernels["masked_corr_level0_tc"]["edges_terminate"] = k1_edges
    kernels["fused_pyramid_lookup"]["launches_per_backend_step"] = per_step
    kernels["fused_pyramid_lookup"]["launches_by_edges_terminate"] = dict(
        sorted(fused_pyramid_lookup.launches_by_edges.items()))
    report = dict(
        keyframes=n, frames=len(frames), backend_edges=[e for e, _ in
                                                        calls.lowmem],
        backend_steps=[s for _, s in calls.lowmem],
        ms_per_backend_call=calls.backend_ms,
        ms_per_backend_step=[ms / s for ms, (_, s) in
                             zip(calls.backend_ms, calls.lowmem)],
        filler_batches=len(calls.fill_ms), ms_per_filler_batch=calls.fill_ms,
        filler_pyramid_rebuilds=calls.rebuilds,
        filler_gru_iterations=calls.iterations, ms_terminate=ms_total,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        k2_launches_by_edges=kernels["fused_pyramid_lookup"][
            "launches_by_edges_terminate"])
    print(f"phase 4: full-width terminate(): {len(calls.lowmem)} backend "
          f"passes over {report['backend_edges']} edges, "
          f"{len(calls.fill_ms)} filler batches, trajectory "
          f"{traj.shape} finite, K1 launches {k1}, K2 launches {k2}")
    return report


def phase_train(dev) -> dict:
    """Three train steps at the full width of the default TrainConfig()."""
    cfg = TrainConfig()
    H, W = cfg.image_size
    N = cfg.n_frames
    db = SyntheticDataset(n_scenes=2, frames_per_scene=N + 1, n_frames=N,
                          crop_size=(H, W), seed=SEED)
    batches = [synthetic_batch(db, idx, dev)
               for idx in ([0, 2], [1, 3], [2, 0])]
    net = LGUNet(device=dev)
    net.load_state_dict(init_state_dict(SLAMConfig(), SEED))
    w0 = [p.detach().clone() for p in net.parameters()]
    opt = make_optimizer(net, cfg)
    ii, jj = (torch.from_numpy(x).to(dev) for x in window_edges(N))
    Gs0 = torch.zeros(cfg.batch, N, 7, device=dev)
    disp0 = torch.zeros(cfg.batch, N, H // 8, W // 8, device=dev)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for batch in batches:
        t_start = time.perf_counter()
        metrics, carry = train_step(net, opt, batch, Gs0, disp0, cfg=cfg,
                                    ii=ii, jj=jj)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t_start))
        metrics = {k: v.item() for k, v in metrics.items()}
        losses.append(metrics)
        check(all(np.isfinite(v) for v in metrics.values()),
              f"non-finite metrics {metrics}")
        check(all(bool(torch.isfinite(p.grad).all())
                  for p in net.parameters()), "non-finite gradients")
        check(all(bool(torch.isfinite(c).all()) for c in carry),
              "non-finite carry")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(bool(torch.isfinite(p).all()) for p in net.parameters()),
          "non-finite weights")
    moved = max((p.detach() - q).abs().max().item()
                for p, q in zip(net.parameters(), w0))
    check(moved > 1e-6, f"the weights did not move ({moved})")
    k1, k2 = masked_corr_level0.launches, fused_pyramid_lookup.launches
    check(k1 == 0 and k2 == 0,
          f"the train steps launched K1 {k1} and K2 {k2} times")
    report = dict(
        image_size=[H, W], batch=cfg.batch, frames=N, iters=cfg.iters,
        edges_per_clip=len(ii), ms_per_step=step_ms,
        ms_per_step_mean_2_3=statistics.mean(step_ms[1:]),
        peak_memory_gb=peak, weights_max_move=moved, metrics=losses,
        launches_k1=k1, launches_k2=k2)
    print(f"phase 5: full-width training ({H}x{W}, batch {cfg.batch}, {N} "
          f"frames, {cfg.iters} iterations): 3 finite steps, "
          f"{report['ms_per_step_mean_2_3']:.1f} ms per step (steps 2-3), "
          f"peak {peak:.2f} GB, losses "
          f"{[round(m['loss'], 4) for m in losses]}, K1/K2 launches 0")
    return report


# -- phase 7: the multi-device paths at world size 1 --------------------------

def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def timed(fn):
    """(fn(), its wall ms on the card)."""
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t_start)


def dba_scene(dev, N=12, H=48, W=64):
    """tests/test_dba_shard.py's scene at the frontend's 1/8 resolution:
    N frames, every edge |i - j| <= 2, targets from the true poses, the
    start perturbed."""
    gen = torch.Generator().manual_seed(SEED)
    xi = torch.cumsum(torch.randn(N, 6, generator=gen) * 0.03, 0)
    poses_gt = se3_exp(xi).to(dev)
    disps_gt = (0.6 + 0.2 * torch.rand(N, H, W, generator=gen)).to(dev)
    intr = torch.tensor([W * 1.2, W * 1.2, W / 2, H / 2], device=dev)
    pairs = [(i, j) for i in range(N) for j in range(N)
             if 0 < abs(i - j) <= 2]
    ii, jj = (np.asarray(x) for x in zip(*pairs))
    target, _ = projective_transform(
        poses_gt, disps_gt, intr.expand(N, 4),
        torch.as_tensor(ii, device=dev), torch.as_tensor(jj, device=dev))
    poses0 = se3_mul(se3_exp((torch.randn(N, 6, generator=gen) * 0.02)
                             .to(dev)), poses_gt)
    disps0 = disps_gt + (torch.randn(N, H, W, generator=gen) * 0.02).to(dev)
    return (poses0, disps0, intr, torch.zeros_like(disps0), target,
            torch.ones_like(target), torch.full_like(disps0, 1e-3), ii, jj)


def phase_world_size_1_dba(dev, group) -> dict:
    """One sharded DBA step against the one-process dba_step."""
    poses0, disps0, intr, sens, target, weight, eta, ii, jj = dba_scene(dev)
    N = poses0.shape[0]
    plan = DbaPlan.build(ii, jj, 1, N, dev)
    ms, ms_ref = [], []
    for _ in range(3):  # the first of each builds its plans and warms up
        (p, d), t = timed(lambda: dba_step_sharded(
            group, poses0, disps0, intr, sens, target, weight, eta, ii, jj,
            1, N, iters=2))
        (p_ref, d_ref), t_ref = timed(lambda: dba_step(
            poses0, disps0, intr, sens, target, weight, eta, plan, iters=2))
        ms.append(t)
        ms_ref.append(t_ref)
    pose_err = (p - p_ref).abs().max().item()
    disp_err = ((d - d_ref).abs() / (2e-4 + 1e-3 * d_ref.abs())).max().item()
    # tests/test_dba_shard.py's tolerances: poses atol 2e-5 (rtol 1e-4),
    # disparities atol 2e-4 / rtol 1e-3
    check(pose_err < 2e-5 + 1e-4 * p_ref.abs().max().item(),
          f"sharded DBA poses vs dba_step: {pose_err}")
    check(disp_err <= 1.0, f"sharded DBA disparities vs dba_step: "
          f"{disp_err} of the tolerance")
    return dict(frames=N, edges=len(ii), pose_max_abs_err=pose_err,
                disp_err_share_of_tolerance=disp_err, ms_sharded=ms[-1],
                ms_one_process=ms_ref[-1], ms_sharded_all=ms,
                ms_one_process_all=ms_ref)


def phase_world_size_1_backend(dev, group, kernels: dict, n_kf=12,
                               steps=3) -> dict:
    """The sharded backend pass over n_kf full-width keyframes tracked from
    phase 3's frames: through Backend over the group, then with the edges
    sorted by ii against the one-process pass from the same state."""
    cfg = SLAMConfig().replace(filter_thresh=0.0, keyframe_thresh=0.0)
    H, W = cfg.image_size
    sd = init_state_dict(cfg, SEED)
    slam = LGUSlam(sd, cfg, device=dev, process_group=group)
    for t, img, intr in shifted_texture_frames(n_kf, H, W, SEED + 1):
        slam.track(float(t), img, intrinsics=intr)
    v = slam.video
    check(v.counter == n_kf, f"{v.counter} keyframes, not {n_kf}")
    del slam.frontend
    torch.cuda.empty_cache()
    state = {name: getattr(v, name).clone() for name in v._FIELDS}

    def restore():
        for name, x in state.items():
            getattr(v, name).copy_(x)

    # Backend over the group: proximity edges, K2 per sharded sub-chunk
    reset_counts()
    with CallCounts() as calls:
        with warnings.catch_warnings():  # the 16*t budget may be capped
            warnings.simplefilter("ignore", UserWarning)
            _, ms_backend = timed(lambda: slam.backend(steps))
    k2 = fused_pyramid_lookup.launches
    check(masked_corr_level0.launches == 0, "the backend launched K1")
    (n_edges, s), = calls.lowmem
    check(s == steps, f"backend steps {s}")
    check(bool(torch.isfinite(v.poses[:n_kf]).all())
          and bool(torch.isfinite(v.disps[:n_kf]).all()),
          "non-finite poses or disparities after the sharded pass")
    # at world size 1 the one rank holds every edge, in chunks of
    # backend_chunk in ii order: K2 once per sub-chunk of each chunk
    per_step = sub_chunks(n_edges, cfg.backend_chunk, cfg.backend_sub_chunk)
    check(k2 == per_step * steps,
          f"K2 launches {k2} != sharded sub-chunks {per_step} x {steps}")
    kernels["fused_pyramid_lookup"]["launches_sharded_backend"] = k2

    # edges sorted by ii: the sharded chunks are the one-process chunks
    restore()
    net = slam.net
    kw = dict(corr_impl="alt", max_factors=min(16 * n_kf,
                                               cfg.backend_edge_cap),
              edge_bucket=cfg.backend_edge_cap, inactive_bucket=8)
    graph = FactorGraph(net, v, cfg, **kw)
    graph.add_proximity_factors(rad=cfg.backend_radius, nms=cfg.backend_nms,
                                thresh=cfg.backend_thresh, beta=cfg.beta)
    order = np.argsort(graph.ii, kind="stable")
    ii, jj = graph.ii[order], graph.jj[order]
    plan = backend_plan(ii, v.poses.shape[0], 1)
    check(np.array_equal(plan.perm[0], np.arange(len(ii))),
          "sorted edges: the sharded plan reorders them")
    out = {}
    for name, g in (("sharded", group), ("one_process", None),
                    ("one_process_again", None)):
        restore()
        graph = FactorGraph(net, v, cfg, **kw)
        graph.add_factors(ii, jj)
        _, ms = timed(lambda: graph.update_lowmem(steps=steps, group=g))
        out[name] = (v.poses[:n_kf].clone(), v.disps[:n_kf].clone(), ms)
        del graph

    def gaps(a, b):
        """Max abs pose gap; disparity gaps relative to max(|d|, 1e-3):
        the 99th percentile and the max."""
        (p_a, d_a, _), (p_b, d_b, _) = out[a], out[b]
        rel = ((d_a - d_b).abs() / d_b.abs().clamp(min=1e-3)).flatten()
        return ((p_a - p_b).abs().max().item(),
                torch.quantile(rel[:2 ** 24].float(), 0.99).item(),
                rel.max().item())

    pose_err, disp_q99, disp_max = gaps("sharded", "one_process")
    self_pose, self_q99, self_max = gaps("one_process_again", "one_process")
    # the same chunks and GRU updates; the card's index_add_ scatters are
    # atomic, so the one-process pass differs from itself run to run (on
    # an H100: poses ~5e-6, disparities' 99th percentile ~1e-3 relative,
    # their max 0.08-0.24 at pixels that no edge constrains); the sharded
    # pass is held to 20 x and 10 x those
    check(pose_err < 1e-4, f"sorted edges: sharded vs one-process poses "
          f"{pose_err}")
    check(disp_q99 < 1e-2, f"sorted edges: sharded vs one-process "
          f"disparities, 99th percentile (relative) {disp_q99}")
    ms_s, ms_1 = out["sharded"][2], out["one_process"][2]
    report = dict(keyframes=n_kf, steps=steps, backend_edges=n_edges,
                  k2_launches=k2, k2_per_step=per_step,
                  ms_backend_call=ms_backend,
                  ms_per_step_backend_call=ms_backend / steps,
                  sorted_edges=len(ii),
                  ms_per_step_sharded=ms_s / steps,
                  ms_per_step_one_process=ms_1 / steps,
                  ms_per_step_one_process_again=out[
                      "one_process_again"][2] / steps,
                  sorted_pose_max_abs_err=pose_err,
                  sorted_disp_q99_rel_err=disp_q99,
                  sorted_disp_max_rel_err=disp_max,
                  one_process_self_pose_max_abs_err=self_pose,
                  one_process_self_disp_q99_rel_err=self_q99,
                  one_process_self_disp_max_rel_err=self_max)
    del slam, state
    torch.cuda.empty_cache()
    return report


def phase_world_size_1_train(dev, group) -> dict:
    """One full-width TrainConfig() step under DDP against a plain
    train_step from the same weights, batch and carry; a second step of
    each is timed too.  The carry is the ground-truth start (every frame
    after the first at frame 1's pose) moved by 1e-3 twists: at the start
    itself the edges among those frames sit on the lookup's integer grid,
    where the step's gradient moves by tens of percent under 1e-6 of pose
    (tests/test_torch_parallel.py), and the card's atomics differ by
    more."""
    cfg = TrainConfig()
    H, W = cfg.image_size
    N = cfg.n_frames
    db = SyntheticDataset(n_scenes=2, frames_per_scene=N + 1, n_frames=N,
                          crop_size=(H, W), seed=SEED)
    batch = synthetic_batch(db, [0, 2], dev)
    Ps = se3_inv(batch[1])
    Gs0 = torch.cat([Ps[:, :1], Ps[:, 1:2].expand(-1, N - 1, -1)], dim=1)
    gen = torch.Generator().manual_seed(SEED)
    tw = torch.randn(Gs0.shape[:2] + (6,), generator=gen).to(dev) * 1e-3
    tw[:, 0] = 0
    Gs0 = se3_mul(se3_exp(tw), Gs0)
    disp0 = torch.ones(cfg.batch, N, H // 8, W // 8, device=dev)
    sd = init_state_dict(SLAMConfig(), SEED)
    ii, jj = (torch.from_numpy(x).to(dev) for x in window_edges(N))
    runs = {}
    for name in ("ddp", "plain"):
        net = LGUNet(device=dev)
        net.load_state_dict(sd)
        model = data_parallel(net, group) if name == "ddp" else net
        opt = make_optimizer(model, cfg)

        def step():
            return train_step(model, opt, batch, Gs0, disp0, cfg=cfg, ii=ii,
                              jj=jj)

        (metrics, _), ms = timed(step)
        lr = opt.schedule(0)
        weights = {n: p.detach().clone() for n, p in net.named_parameters()}
        # the clipped gradients AdamW read: its first moment / (1 - beta1)
        grads = {n: opt.adamw.state[p]["exp_avg"] / (1.0 - 0.9)
                 for n, p in net.named_parameters()}
        _, ms_again = timed(step)  # DDP's first step also sets up buckets
        runs[name] = (metrics["loss"].item(), [ms, ms_again], weights, grads)
        del model, net, opt
    (loss_d, ms_d, w_d, g_d), (loss_p, ms_p, w_p, g_p) = runs["ddp"], \
        runs["plain"]
    loss_err = abs(loss_d - loss_p) / abs(loss_p)
    check(np.isfinite(loss_d) and loss_err < 1e-5,
          f"DDP loss {loss_d} vs plain {loss_p}")
    # each gradient tensor to 1e-2 of its largest entry; where the plain
    # gradient exceeds twice that, Adam's first step moves the weight by lr
    # in the gradient's sign, and the two agree to fp32 rounding; elsewhere
    # (an entry within the tolerance of 0) they lie within 2 lr.  The
    # feature encoder's biases in front of its instance norms (all but its
    # output conv's) have gradients of rounding noise: weights only.
    grad_err, sure_err, other_err, noise = 0.0, 0.0, 0.0, 0.0
    top_all = max(g.abs().max().item() for g in g_p.values())
    for n, g in g_p.items():
        top = g.abs().max().item()
        dw = (w_d[n] - w_p[n]).abs()
        other_err = max(other_err, dw.max().item() / lr)
        if (n.startswith("fnet.") and n.endswith(".bias")
                and n != "fnet.conv2.bias"):
            noise = max(noise, top / top_all)
            continue
        grad_err = max(grad_err,
                       (g_d[n] - g).abs().max().item() / max(top, 1e-30))
        sure = g.abs() > 2 * 1e-2 * top
        room = 1e-3 * lr + 1e-6 * w_p[n].abs()
        if sure.any():
            sure_err = max(sure_err, (dw[sure] / room[sure]).max().item())
    check(grad_err <= 1e-2, f"DDP gradients differ by {grad_err:.3g} of "
          "a tensor's largest entry")
    check(sure_err <= 1.0, "DDP weights with a held gradient sign differ "
          f"by {sure_err:.3g} x (1e-3 lr + 1e-6 |w|)")
    check(other_err <= 2 * (1 + 1e-3), f"DDP weights differ by "
          f"{other_err:.3g} lr")
    torch.cuda.empty_cache()
    return dict(loss_ddp=loss_d, loss_plain=loss_p, loss_rel_err=loss_err,
                grads_max_rel_err=grad_err, lr=lr,
                weights_sign_held_err_over_room=sure_err,
                weights_max_abs_diff_over_lr=other_err,
                noise_grads_max_over_top=noise, ms_step_ddp=ms_d,
                ms_step_plain=ms_p)


def nccl_group_1():
    """The NCCL process group of world size 1 (one process, one card) that
    phases 7 and 11 run on; main destroys it."""
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    group = dist.group.WORLD
    check(dist.get_backend(group) == "nccl" and
          dist.get_world_size(group) == 1, "not an NCCL group of 1")
    return group


def phase_world_size_1(dev, kernels: dict, group) -> dict:
    report = dict(world_size=1, backend="nccl",
                  dba=phase_world_size_1_dba(dev, group),
                  backend_pass=phase_world_size_1_backend(dev, group,
                                                          kernels),
                  train=phase_world_size_1_train(dev, group))
    d, b, t = report["dba"], report["backend_pass"], report["train"]
    print(f"phase 7: sharded DBA step {d['ms_sharded']:.2f} ms (one "
          f"process {d['ms_one_process']:.2f} ms), pose err "
          f"{d['pose_max_abs_err']:.3g}; sharded backend "
          f"{b['ms_per_step_sharded']:.1f} ms per step (one process "
          f"{b['ms_per_step_one_process']:.1f} ms) over "
          f"{b['sorted_edges']} edges, K2 launches {b['k2_launches']}; "
          f"DDP train steps {t['ms_step_ddp'][0]:.1f}, "
          f"{t['ms_step_ddp'][1]:.1f} ms (plain {t['ms_step_plain'][0]:.1f},"
          f" {t['ms_step_plain'][1]:.1f} ms), loss rel err "
          f"{t['loss_rel_err']:.3g}, gradients {t['grads_max_rel_err']:.3g}"
          f", weights {t['weights_max_abs_diff_over_lr']:.3g} lr")
    print("phase 7: the sharded DBA, the sharded backend pass and the DDP "
          "train step ran at world size 1 (one process, one card, NCCL)")
    return report


# -- phase 8: the entry points on on-disk sequences --------------------------

def load_script(name: str):
    """``scripts/<name>.py`` as a module (its ``main(argv)``)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_pth(path: Path, seed: int = SEED) -> None:
    """Random weights saved as a reference checkpoint: ``module.`` prefixes
    and 3-output weight/delta heads, which the loader strips and trims."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in init_state_dict(SLAMConfig(), seed).items():
        if k.startswith(TRIMMED_HEADS):
            v = torch.cat([v, torch.randn((1,) + v.shape[1:], generator=gen)])
        sd["module." + k] = v
    torch.save(sd, path)


def host_ms(fn, items) -> float:
    """Median host ms of ``fn`` over ``items``."""
    ms = []
    for item in items:
        t_start = time.perf_counter()
        fn(item)
        ms.append(1e3 * (time.perf_counter() - t_start))
    return statistics.median(ms)


def host_costs(tum: Path, euroc: Path) -> dict:
    """The host's ms per frame of each step that feeds a frame: the TUM
    sequence's 480 x 640 colour PNGs decoded, undistorted (fr1) and resized
    to 384 x 512 (the demo's path), and the EuRoC pairs' 752 x 480 gray
    PNGs decoded, rectified and resized to 320 x 512 (both cameras)."""
    rgb = sorted((tum / "rgb").iterdir())[:10]
    images = [imread(str(f)) for f in rgb]
    K = np.asarray([[517.3, 0, 318.6], [0, 516.5, 255.3], [0, 0, 1]])
    undist = undistort_maps(K, [0.2624, -0.9531, -0.0054, 0.0026, 1.1633],
                            (640, 480))
    flat = [undist(im) for im in images]
    cams = [sorted((euroc / "mav0" / c / "data").iterdir())[:6]
            for c in ("cam0", "cam1")]
    pairs = [[imread(str(f)) for f in fs] for fs in zip(*cams)]
    rectify = [FloatRemap(*m, (480, 752)) for m in euroc_maps()]
    rectified = [[r(im) for r, im in zip(rectify, pair)] for pair in pairs]
    return {
        "tum_480x640_to_384x512": dict(
            decode_ms=host_ms(lambda f: imread(str(f)), rgb),
            undistort_ms=host_ms(undist, images),
            resize_ms=host_ms(lambda im: resize(im, (512, 384)), flat)),
        "euroc_stereo_752x480_to_320x512": dict(
            decode_ms=host_ms(lambda fs: [imread(str(f)) for f in fs],
                              list(zip(*cams))),
            remap_ms=host_ms(lambda p: [r(im) for r, im in zip(rectify, p)],
                             pairs),
            resize_ms=host_ms(lambda p: [resize(im, (512, 320)) for im in p],
                              rectified))}


def entry_run(name: str, fn, kernels: dict, runs: dict):
    """Run one entry point with K1/K2's counts from 0; checks that it
    launched both, K1 only as the bf16-operand kernel (every configuration
    here keeps SLAMConfig()'s bf16 dtypes), and records the counts."""
    reset_counts()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    k1, k2 = masked_corr_level0.launches_bf16, fused_pyramid_lookup.launches
    check(k1 > 0 and k2 > 0, f"{name}: kernel launches K1={k1} K2={k2}")
    check(masked_corr_level0.launches == k1,
          f"{name}: K1 fp32-operand launches "
          f"{masked_corr_level0.launches - k1}")
    runs[name] = dict(seconds=time.perf_counter() - t_start, k1_launches=k1,
                      k2_launches=k2)
    for kname, k in (("masked_corr_level0_tc", k1),
                     ("fused_pyramid_lookup", k2)):
        kernels[kname]["launches_entry_points"] = \
            kernels[kname].get("launches_entry_points", 0) + k
    return out


def finite_trajectory(name: str, path: Path, n: int) -> None:
    traj = np.loadtxt(path)
    check(traj.shape == (n, 8), f"{name}: trajectory {traj.shape}, not "
          f"{n} poses")
    check(bool(np.isfinite(traj).all()), f"{name}: non-finite poses")


def phase_entry_points(dev, kernels: dict, recon: Path, export: Path,
                       n_tum: int = 40, n_euroc: int = 16,
                       stride: int = 2) -> dict:
    """The entry points a user runs, through their ``main`` functions on
    the card, on sequences written to disk with the port's PNG encoder:
    ``demo_torch`` mono (``--upsample``, its reconstruction written to
    ``recon`` and its ``.ply`` snapshots every 4 frames to ``export`` for
    phase 9) and RGB-D at full width (384 x 512, thresholds
    0, every ``stride``-th frame), ``evaluate_tum_torch`` (240 x 320) and
    ``evaluate_euroc_torch`` (stereo, 320 x 512), all with a reference
    ``.pth`` of random weights; beside them the host's ms per frame of
    decoding, undistorting or rectifying, and resizing."""
    demo = load_script("demo_torch")
    tum_eval = load_script("evaluate_tum_torch")
    euroc_eval = load_script("evaluate_euroc_torch")
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t_start = time.perf_counter()
        tum = Path(write_tum_sequence(
            str(root / "tum" / "rgbd_dataset_freiburg1_desk"), n_tum))
        euroc = Path(write_euroc_sequence(str(root / "euroc" / "MH_01_easy"),
                                          n_euroc))
        weights = root / "weights.pth"
        reference_pth(weights)
        calib = root / "calib.txt"
        calib.write_text("517.3 516.5 318.6 255.3 0.2624 -0.9531 -0.0054 "
                         "0.0026 1.1633\n")
        fixture_s = time.perf_counter() - t_start
        host = host_costs(tum, euroc)

        n_demo = len(range(0, n_tum, stride))
        demo_args = ["--imagedir", str(tum / "rgb"), "--calib", str(calib),
                     "--weights", str(weights), "--stride", str(stride),
                     "--filter_thresh", "0", "--keyframe_thresh", "0",
                     "--device", str(dev)]
        for name, extra in (("demo_mono", ["--upsample",
                                           "--reconstruction_path",
                                           str(recon), "--export_every", "4",
                                           "--export_dir", str(export)]),
                            ("demo_rgbd", ["--depthdir", str(tum / "depth")])):
            traj = root / f"{name}.txt"
            out = entry_run(name, lambda: demo.main(
                demo_args + extra + ["--trajectory_path", str(traj)]),
                kernels, runs)
            finite_trajectory(name, traj, n_demo)
            runs[name].update(frames=n_demo, ms_per_frame={
                k: v["mean_ms"] for k, v in out["phases"].items()})
        for name, script, path, n in (
                ("evaluate_tum", tum_eval, tum, n_tum),
                ("evaluate_euroc", euroc_eval, euroc, n_euroc)):
            out = entry_run(name, lambda: script.main(
                ["--datapath", str(path.parent), "--weights", str(weights),
                 "--sequences", path.name, "--device", str(dev)]),
                kernels, runs)
            result = out[path.name]
            check(result["poses"] == n and np.isfinite(result["ate"]),
                  f"{name}: {result}")
            runs[name].update(poses=result["poses"], ate=result["ate"])
    report = dict(fixture_seconds=fixture_s, host_ms_per_frame=host,
                  runs=runs)
    tum_host = host["tum_480x640_to_384x512"]
    print(f"phase 8: demo_torch mono and RGB-D ({n_demo} frames at 384 x "
          f"512), evaluate_tum_torch ({n_tum} poses) and "
          f"evaluate_euroc_torch (stereo, {n_euroc} poses) on sequences "
          f"written to disk: trajectories finite; host ms per 480 x 640 "
          f"frame: decode {tum_host['decode_ms']:.1f}, undistort "
          f"{tum_host['undistort_ms']:.1f}, resize "
          f"{tum_host['resize_ms']:.1f}; demo ms per tracked frame "
          f"{runs['demo_mono']['ms_per_frame']['track']:.1f}; K1 launches "
          f"{sum(r['k1_launches'] for r in runs.values())}, K2 launches "
          f"{sum(r['k2_launches'] for r in runs.values())}")
    return report


# -- phase 9: the 3DGS stage -------------------------------------------------

def kernel_counts() -> dict:
    """Every kernel wrapper's launch count."""
    return dict(k1=masked_corr_level0.launches,
                k2=fused_pyramid_lookup.launches,
                window_lookup=window_lookup.launches,
                row_gather=row_gather.launches,
                k2_stream_floor=k2_stream_floor.launches,
                k2_one_level=k2_one_level.launches)


def gs_frame(scene, pose_c2w, intr, H, W):
    """One RGB-D frame of ``scene`` as the mapper takes it: image in [0, 1],
    z-depth, world-to-camera rotation and translation, intrinsics."""
    img, depth = scene.render(pose_c2w, intr, H, W)
    q = pose_c2w[3:7].astype(np.float64)
    w2c = so3_matrix(torch.from_numpy(q / np.linalg.norm(q))).numpy().T \
        .astype(np.float32)
    return (img.astype(np.float32) / 255.0, depth, w2c,
            (-w2c @ pose_c2w[:3]).astype(np.float32),
            np.asarray(intr, np.float32))


def synthetic_gs_frames(n, H, W, seed=SEED):
    """``n`` frames of ``data/synthetic.py``'s billboard scene along a
    slow random walk (0.15 m and 0.02 rad steps), ground-truth depth and
    poses."""
    scene = SyntheticScene(seed=seed)
    poses = make_trajectory(np.random.default_rng(seed), n, t_step=0.15,
                            r_step=0.02)
    intr = np.float32([0.9 * W, 0.9 * W, W / 2.0, H / 2.0])
    return [gs_frame(scene, p, intr, H, W) for p in poses]


def phase_gs_cuda_vs_cpu(dev) -> dict:
    """The renderer and one mapping step on the card and on the CPU from the
    same Gaussians (one per pixel of a 96 x 128 synthetic frame, their log
    scales perturbed from a seed): the renders within 1e-4, the loss within
    1e-5, the gradients (Adam's first moments, 0.1 x the gradient) within
    1e-3 of each group's largest, the densification signal likewise, and
    the parameters after the step: the first step moves each entry by
    -lr sign(g), so an entry differs by 0 or 2 lr (where a gradient near 0
    takes another sign under the card's atomic scatter-adds); at least
    99 % of each group's entries must agree within 1e-6.  The rotations'
    gradient is rounding noise for isotropic Gaussians on both devices
    (below 1e-6)."""
    H, W = 96, 128
    im, depth, R, tr, intr = synthetic_gs_frames(1, H, W)[0]
    cfg = GSConfig(capacity=H * W)
    out = []
    for d in (dev, torch.device("cpu")):
        mapper = GaussianMapper(cfg, (H, W), device=d)
        mapper.add_frame_gaussians(im, depth, R, tr, intr, 0)
        gen = torch.Generator().manual_seed(SEED)
        n = mapper.map.count
        mapper.map.params["log_scales"][:n] += (
            0.3 * torch.randn(n, 1, generator=gen)).to(d)
        frame = mapper.frame_tensors(im, depth, R, tr, intr)
        params = mapper.map.live()
        alive = mapper.map.alive_device(n)
        with torch.no_grad():
            render = render_rgbd(params, alive, *frame[2:], (H, W),
                                 span=cfg.span, k_max=cfg.k_max)
        step = make_mapping_step(cfg, (H, W))
        p1, opt, loss, _, g2d = step(params, adam_init(params), alive,
                                     frame)
        out.append(dict(
            render=[x.cpu() for x in render], loss=float(loss),
            g2d=g2d.cpu(), mu={k: v.cpu() for k, v in opt["mu"].items()},
            params={k: v.cpu() for k, v in p1.items()}))
    a, b = out
    report = dict(gaussians=n, image=[H, W])
    report["render_max_abs_diff"] = max(
        float((x - y).abs().max()) for x, y in zip(a["render"], b["render"]))
    check(report["render_max_abs_diff"] <= 1e-4,
          f"phase 9: render cuda vs cpu {report['render_max_abs_diff']}")
    report["loss"] = [a["loss"], b["loss"]]
    check(abs(a["loss"] - b["loss"]) <= 1e-5,
          f"phase 9: loss cuda vs cpu {report['loss']}")
    scale = float(b["g2d"].abs().max())
    report["g2d_rel_diff"] = float((a["g2d"] - b["g2d"]).abs().max()) / scale
    check(report["g2d_rel_diff"] <= 1e-3,
          f"phase 9: densification signal {report['g2d_rel_diff']}")
    lrs = learning_rates(cfg)
    for k in PARAM_KEYS:
        mu_a, mu_b = a["mu"][k], b["mu"][k]
        dp = (a["params"][k] - b["params"][k]).abs()
        if k == "unnorm_rotations":
            check(float(mu_a.abs().max()) < 1e-6 and
                  float(mu_b.abs().max()) < 1e-6,
                  "phase 9: rotation gradients are not noise")
        else:
            rel = float((mu_a - mu_b).abs().max()) / float(mu_b.abs().max())
            agree = float((dp <= 1e-6).float().mean())
            report[f"{k}_grad_rel_diff"] = rel
            report[f"{k}_params_agreeing"] = agree
            check(rel <= 1e-3 and agree >= 0.99,
                  f"phase 9: {k} cuda vs cpu: gradients {rel}, "
                  f"entries agreeing {agree}")
        check(float(dp.max()) <= 2 * lrs[k] + 1e-6,
              f"phase 9: {k} moved apart by {float(dp.max())}")
    return report


def phase_gs_bench(dev) -> dict:
    """``scripts/bench_gs_mapping_torch.py`` itself: one mapping iteration
    at 680 x 1200 with 200,000 live Gaussians of a 400,000-capacity map
    (``GSConfig()``), 10 timed after a warm-up."""
    result = load_script("bench_gs_mapping_torch").run(dev, reps=10)
    check(np.isfinite(result["loss"]), f"phase 9: bench loss {result}")
    return result


def phase_gs_mapper(dev, n_frames=8, H=384, W=512) -> dict:
    """``GaussianMapper`` under the Replica preset's schedule (60 mapping
    iterations per frame, a 24-frame window, pruning every 20) over
    ``n_frames`` synthetic frames with ground-truth depth and poses; then
    the render metrics of ``gs/eval.py`` on the mapped frames, against the
    first frame's render before any iteration, and a TSDF fused from the
    renders, meshed."""
    preset = get_preset("replica")
    cfg = preset.gs
    frames = synthetic_gs_frames(n_frames, H, W)
    mapper = GaussianMapper(cfg, (H, W), device=dev)
    window, ms, losses = [], [], []
    psnr_initial = None
    for t, (im, depth, R, tr, intr) in enumerate(frames):
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        mapper.add_frame_gaussians(im, depth, R, tr, intr, t)
        window.append(mapper.frame_tensors(im, depth, R, tr, intr))
        window = window[-cfg.mapping_window_size:]
        if t == 0:
            torch.cuda.synchronize()
            t_eval = time.perf_counter()
            psnr_initial = evaluate_renders(
                mapper.map.live(), mapper.map.alive_device(mapper.map.count),
                window, (H, W), cfg.span, cfg.k_max)["psnr"]
            t_start += time.perf_counter() - t_eval
        losses.append(mapper.map_frame(window))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t_start))
    live = mapper.map.live()
    alive = mapper.map.alive_device(mapper.map.count)
    metrics = evaluate_renders(live, alive, window, (H, W), cfg.span,
                               cfg.k_max)
    check(np.isfinite(metrics["psnr"]) and metrics["psnr"] > psnr_initial,
          f"phase 9: PSNR {metrics['psnr']} not above the first frame's "
          f"{psnr_initial}")
    check(np.isfinite(metrics["depth_l1"]),
          f"phase 9: depth L1 {metrics['depth_l1']}")
    check(all(np.isfinite(x) for ls in losses for x in ls),
          "phase 9: non-finite mapping loss")

    pts = live["means3D"][alive].cpu().numpy()
    lo, hi = pts.min(0) - 0.2, pts.max(0) + 0.2
    voxel = max(0.02, float((hi - lo).max()) / 160)
    vol = TSDFVolume(lo, hi, voxel_size=voxel, device=dev)
    for _, _, R, tr, intr in window:
        with torch.no_grad():
            img_r, depth_r, sil, _ = render_rgbd(
                live, alive, R, tr, intr, (H, W), span=cfg.span,
                k_max=cfg.k_max)
        vol.integrate(torch.where(sil > 0.5, depth_r,
                                  torch.zeros_like(depth_r)),
                      img_r, intr, R, tr)
    V, _, Tri = vol.extract_mesh()
    check(len(V) > 0 and len(Tri) > 0, "phase 9: empty mesh")
    return dict(
        image=[H, W], frames=n_frames, mapping_iters=cfg.mapping_iters,
        window=cfg.mapping_window_size, prune_every=cfg.prune_every,
        ms_per_frame=ms, ms_per_frame_median=statistics.median(ms),
        ms_per_frame_after_first=statistics.fmean(ms[1:]),
        gaussians=mapper.map.count, alive=int(mapper.map.alive.sum()),
        loss_first=losses[0][0], loss_last=losses[-1][-1],
        psnr_first_frame_before_mapping=psnr_initial, eval=metrics,
        peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
        tsdf_dims=list(vol.dims), voxel=voxel, mesh_vertices=len(V),
        mesh_triangles=len(Tri))


def phase_gs_chain(dev, recon: Path, max_frames=3, mapping_iters=20) -> dict:
    """``scripts/gs_slam_torch.py --mesh`` on the reconstruction that phase
    8's mono demo wrote (``--upsample``: full-resolution disparities): it
    must exit, having written a scene and a mesh file.  The TSDF's voxel
    is sized from the reconstruction so that its grid holds at most 161
    voxels a side: random weights give depths up to the script's 1,000
    (disparities clamped at 1e-3), and against voxels of metres the
    script's 0.08 m truncation leaves few zero crossings, so the mesh's
    size is reported, not held (phase 9's mapper holds a mesh of known
    geometry)."""
    data = np.load(recon)
    disps, poses = data["disps"][:max_frames], data["poses"][:max_frames]
    intr = data["intrinsics"][0] * 8.0
    h, w = disps.shape[1:3]
    world = []
    for d, pose in zip(disps, poses):
        R = so3_matrix(torch.from_numpy(pose[3:7])).numpy()
        world.append(pointcloud_from_depth(
            np.zeros((h, w, 3)), 1.0 / np.maximum(d, 1e-3), intr, R.T,
            -R.T @ pose[:3])[0])
    extent = float((np.ptp(np.concatenate(world), axis=0) + 0.4).max())
    voxel = max(0.02, extent / 160)
    with tempfile.TemporaryDirectory() as tmp:
        t_start = time.perf_counter()
        out = load_script("gs_slam_torch").main([
            "--reconstruction", str(recon), "--max_frames", str(max_frames),
            "--mapping_iters", str(mapping_iters), "--voxel", str(voxel),
            "--out", str(Path(tmp) / "scene.npz"), "--mesh",
            str(Path(tmp) / "mesh.ply"), "--device", str(dev)])
        seconds = time.perf_counter() - t_start
        check((Path(tmp) / "scene.npz").stat().st_size > 0,
              "phase 9: gs_slam_torch wrote no scene")
        check((Path(tmp) / "mesh.ply").stat().st_size > 0,
              f"phase 9: gs_slam_torch wrote no mesh: {out}")
    check(all(np.isfinite(out["losses"])), f"phase 9: chain losses {out}")
    return dict(image=[h, w], frames=max_frames, mapping_iters=mapping_iters,
                voxel=voxel, seconds=seconds, **out)


def read_ply(path: Path) -> tuple:
    """The element counts of a binary ``.ply``'s header and the bytes
    after it."""
    data = path.read_bytes()
    head, body = data.split(b"end_header\n", 1)
    counts = {}
    for line in head.decode().splitlines():
        if line.startswith("element "):
            _, kind, n = line.split()
            counts[kind] = int(n)
    return counts, body


def phase_gs_export(dev, recon: Path, export: Path) -> dict:
    """The reconstruction export on the card.  The mono demo's final
    snapshot (``IncrementalReconstruction`` over the card's video,
    thresholds 0, so no keyframe is removed) holds 5 frustum vertices and
    8 edges per keyframe of the reconstruction, and finite points.
    ``backproject_points`` on phase 8's reconstruction (its full-resolution
    disparities read at 1/8, as ``view_reconstruction_torch`` reads them),
    on the card against the CPU: unfiltered (``filter_count=0``), the same
    pixels, points within 1e-5 of the cloud's largest coordinate (plus
    1e-5: random weights put points up to 1,000 m away, where a float32
    ulp is 6e-5) and equal colours; the multi-view filter's counts on at
    most 0.1 % of the pixels apart (a projection within rounding of a pixel
    edge or of the threshold can go either way), and the filtered clouds'
    sizes no further apart than that.  ``view_reconstruction_torch`` on the
    card writes as many points as the card's ``backproject_points``."""
    t_start = time.perf_counter()
    data = np.load(recon)
    n_kf = len(data["tstamps"])
    cams, _ = read_ply(export / "cameras_final.ply")
    check(cams == {"vertex": 5 * n_kf, "edge": 8 * n_kf},
          f"phase 9: final frusta {cams} for {n_kf} keyframes")
    snap, body = read_ply(export / "points_final.ply")
    pts = np.frombuffer(body, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
    check(len(pts) == snap["vertex"] and np.isfinite(pts["xyz"]).all(),
          f"phase 9: final snapshot {snap}, {len(pts)} records")
    snapshots = sorted(p.name for p in export.glob("points_*.ply"))

    disps8 = data["disps"][:, 3::8, 3::8]
    args = (data["poses"], disps8, data["intrinsics"][0])

    def on(d):
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(d) for x in args]
        counts = depth_filter(*t, torch.arange(len(disps8), device=d),
                              0.005 * t[1].mean(dim=(1, 2)))
        return dict(
            counts=counts.cpu(),
            all=backproject_points(*t, images=data["images"],
                                   filter_count=0),
            filtered=backproject_points(*t, images=data["images"])[0])
    a, b = on(dev), on(torch.device("cpu"))
    check(a["all"][0].shape == b["all"][0].shape,
          f"phase 9: unfiltered clouds {a['all'][0].shape} vs "
          f"{b['all'][0].shape}")
    err = np.abs(a["all"][0] - b["all"][0]) / (
        1.0 + np.abs(b["all"][0]).max())
    check(float(err.max()) <= 1e-5 and
          np.array_equal(a["all"][1], b["all"][1]),
          f"phase 9: backproject_points cuda vs cpu {float(err.max())}")
    counts_apart = int((a["counts"] != b["counts"]).sum())
    check(counts_apart <= 1e-3 * a["counts"].numel(),
          f"phase 9: depth_filter counts apart on {counts_apart} pixels")
    size_apart = abs(len(a["filtered"]) - len(b["filtered"]))
    check(size_apart <= counts_apart,
          f"phase 9: filtered clouds {len(a['filtered'])} vs "
          f"{len(b['filtered'])}")
    with tempfile.TemporaryDirectory() as tmp:
        ply = Path(tmp) / "reconstruction.ply"
        n_view = load_script("view_reconstruction_torch").main(
            ["--reconstruction", str(recon), "--out", str(ply),
             "--device", str(dev)])
        view, _ = read_ply(ply)
    check(n_view == view["vertex"] == len(a["filtered"]),
          f"phase 9: view_reconstruction_torch wrote {view} (returned "
          f"{n_view}), backproject_points {len(a['filtered'])}")
    return dict(keyframes=n_kf, snapshots=snapshots,
                snapshot_points=snap["vertex"], pixels=a["counts"].numel(),
                unfiltered_points=len(a["all"][0]),
                unfiltered_rel_err=float(err.max()),
                filter_counts_apart=counts_apart,
                filtered_points=[len(a["filtered"]), len(b["filtered"])],
                view_reconstruction_points=n_view,
                seconds=time.perf_counter() - t_start)


def phase_gs(dev, recon: Path, export: Path) -> dict:
    """Phase 9: the 3DGS stage (it launches none of the kernels)."""
    t_start = time.perf_counter()
    before = kernel_counts()
    report = dict(cuda_vs_cpu=phase_gs_cuda_vs_cpu(dev))
    torch.cuda.empty_cache()
    report["bench"] = phase_gs_bench(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    report["mapper"] = phase_gs_mapper(dev)
    torch.cuda.empty_cache()
    report["chain"] = phase_gs_chain(dev, recon)
    report["export"] = phase_gs_export(dev, recon, export)
    check(kernel_counts() == before,
          f"phase 9 launched a kernel: {before} -> {kernel_counts()}")
    report["seconds"] = time.perf_counter() - t_start
    b, m, c, e = (report[k] for k in ("bench", "mapper", "chain", "export"))
    print(f"phase 9: 3DGS renderer and mapping step agree on cuda and cpu "
          f"(render {report['cuda_vs_cpu']['render_max_abs_diff']:.2e}); "
          f"mapping iteration at 680 x 1200 / 200k live: "
          f"{b['ms_per_iter_median']:.1f} ms median, peak "
          f"{b['peak_memory_gb']:.2f} GB, {b['truncation']}; mapper "
          f"(Replica schedule, {m['frames']} frames at 384 x 512): "
          f"{m['ms_per_frame_median']:.0f} ms per frame, "
          f"{m['gaussians']} Gaussians, loss {m['loss_first']:.4f} -> "
          f"{m['loss_last']:.4f}, PSNR "
          f"{m['psnr_first_frame_before_mapping']:.2f} -> "
          f"{m['eval']['psnr']:.2f}, depth L1 "
          f"{m['eval']['depth_l1']:.4f}, mesh {m['mesh_vertices']} vertices; "
          f"gs_slam_torch on the demo's reconstruction: {c['gaussians']} "
          f"Gaussians, mesh {c['mesh_vertices']} vertices; export: "
          f"{len(e['snapshots'])} demo snapshots, "
          f"{e['snapshot_points']} points in the last, backproject_points "
          f"cuda vs cpu {e['unfiltered_rel_err']:.1e}, filtered "
          f"{e['filtered_points'][0]} points ({e['seconds']:.1f} s); "
          f"{report['seconds']:.0f} s")
    return report


# -- phase 10: JPEG frames, the native planner, the viewer, the helpers ------

def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))


# the codec's cases: subsampling and restart interval (MCUs) at quality 95
JPEG_CASES = {"420": dict(subsampling="420"),
              "444": dict(subsampling="444"),
              "420_restart_4": dict(subsampling="420", restart_interval=4)}
JPEG_PSNR_DB = 35.0  # decode against the rendered source, every case


def phase_jpeg_codec() -> dict:
    """Seeded 480 x 640 frames through ``encode_jpeg`` and the C decoder:
    PSNR against the source, the host's ms to encode (once), to decode and
    to feed a frame (decode + resize to 384 x 512; medians of 20)."""
    images = render_sequence(SEED + 10, len(JPEG_CASES), 480, 640, TUM_FR1,
                             0.02, 0.004)[0]
    out = {}
    for (name, kw), img in zip(JPEG_CASES.items(), images):
        t_start = time.perf_counter()
        data = encode_jpeg(img, 95, **kw)
        encode_ms = 1e3 * (time.perf_counter() - t_start)
        db = psnr(decode_jpeg(data), img)
        check(db >= JPEG_PSNR_DB, f"phase 10: JPEG {name} PSNR {db:.2f} dB")
        out[name] = dict(
            bytes=len(data), psnr_db=db, encode_ms=encode_ms,
            decode_ms=host_ms(decode_jpeg, [data] * 20),
            feed_ms=host_ms(lambda d: resize(decode_jpeg(d), (512, 384)),
                            [data] * 20))
    return out


def count_launches(name: str, kernels: dict) -> tuple:
    """K1's (the bf16-operand kernel) and K2's launches since the counts
    were reset, checked and added to the kernels' phase-10 counts."""
    k1, k2 = masked_corr_level0.launches_bf16, fused_pyramid_lookup.launches
    check(k1 > 0 and k2 > 0, f"phase 10 {name}: kernel launches K1={k1} "
          f"K2={k2}")
    check(masked_corr_level0.launches == k1,
          f"phase 10 {name}: K1 fp32-operand launches "
          f"{masked_corr_level0.launches - k1}")
    for kname, k in (("masked_corr_level0_tc", k1),
                     ("fused_pyramid_lookup", k2)):
        kernels[kname]["launches_jpeg"] = \
            kernels[kname].get("launches_jpeg", 0) + k
    return k1, k2


def phase_jpeg_track(dev, kernels: dict, root: Path, n_frames: int = 24,
                     size: tuple = (384, 512)) -> dict:
    """A ScanNet-layout RGB-D sequence written with the port's encoder,
    read through ``ScanNet`` (the 640 x 480 camera, resized to 384 x 512)
    and tracked with depth at the full width of ``SLAMConfig()``,
    thresholds 0, then ``terminate()`` over the stream."""
    t_start = time.perf_counter()
    write_scannet_sequence(str(root / "scene0000_00"), n_frames,
                           seed=SEED + 11)
    write_s = time.perf_counter() - t_start
    ds = ScanNet(str(root), "scene0000_00",
                 camera=KNOWN_CAMERAS["scannet_640"], desired=size)
    t_start = time.perf_counter()
    frames = list(ds.stream())
    read_ms = 1e3 * (time.perf_counter() - t_start) / len(frames)
    check(len(frames) == n_frames and frames[0][1].shape == (*size, 3),
          f"phase 10: ScanNet read {len(frames)} frames of "
          f"{frames[0][1].shape}")
    cfg = SLAMConfig().replace(filter_thresh=0.0, keyframe_thresh=0.0,
                               image_size=size)
    slam = LGUSlam(init_state_dict(cfg, SEED), cfg, device=dev)
    reset_counts()
    kf_ms = []
    for t, img, depth, intr in frames:
        before = slam.video.counter
        t_start = time.perf_counter()
        slam.track(float(t), img, depth=depth, intrinsics=intr)
        torch.cuda.synchronize()
        if slam.video.counter > before:
            kf_ms.append(1e3 * (time.perf_counter() - t_start))
    n_kf = slam.video.counter
    check(bool(torch.isfinite(slam.video.poses[:n_kf]).all()),
          "phase 10: non-finite keyframe poses")
    t_start = time.perf_counter()
    traj = slam.terminate(iter(frames))
    torch.cuda.synchronize()
    terminate_s = time.perf_counter() - t_start
    check(traj.shape == (n_frames, 7) and bool(np.isfinite(traj).all()),
          f"phase 10: ScanNet trajectory {traj.shape} not finite")
    k1, k2 = count_launches("ScanNet track", kernels)
    return dict(frames=n_frames, keyframes=n_kf, write_seconds=write_s,
                read_ms_per_frame=read_ms,
                ms_per_keyframe_median=statistics.median(kf_ms[cfg.warmup:]),
                terminate_seconds=terminate_s, k1_launches=k1,
                k2_launches=k2)


def phase_replica(root: Path, n_frames: int = 4) -> dict:
    """A Replica-layout scene at 680 x 1200 read through
    ``ReplicaDataset``: every frame equals the encoder's bytes of the
    rendered frame decoded on the host, flipped to RGB and resized as the
    loader resizes; the decode's PSNR against the rendered frame."""
    seed = SEED + 12
    scene = write_replica_scene(str(root / "room0"), n_frames, seed=seed)
    images, depths = render_sequence(seed, n_frames, 680, 1200, REPLICA_CAM,
                                     0.02, 0.004)[:2]
    ds = ReplicaDataset(scene)
    check(len(ds) == n_frames, f"phase 10: Replica {len(ds)} frames")
    H, W = ds.size
    dbs = []
    for i in range(n_frames):
        im, d, w2c, _ = ds[i]
        dec = decode_jpeg(encode_jpeg(images[i]))
        dbs.append(psnr(dec, images[i]))
        want = resize(dec[..., ::-1], (W, H)).astype(np.float32) / 255.0
        check(np.array_equal(im, want), f"phase 10: Replica frame {i} is "
              "not the encoder's decode")
        check(d.shape == (H, W) and bool(np.isfinite(w2c).all()),
              f"phase 10: Replica depth {d.shape} or pose")
    return dict(frames=n_frames, size=[H, W], psnr_db_min=min(dbs))


def http_get(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, body


def phase_jpeg_viewer(dev, kernels: dict, root: Path, n_frames: int = 12,
                      target_pixels: int = 384 * 512) -> dict:
    """``demo_torch --viewer`` on a JPEG image directory (480 x 640,
    resized to 384 x 512, thresholds 0): the page and the snapshot while
    the viewer is up."""
    imagedir, calib = write_jpeg_imagedir(str(root / "jpeg"), n_frames,
                                          seed=SEED + 13)
    demo = load_script("demo_torch")
    reset_counts()
    t_start = time.perf_counter()
    out = demo.main(["--imagedir", imagedir, "--calib", calib, "--stride",
                     "1", "--filter_thresh", "0", "--keyframe_thresh", "0",
                     "--viewer", "--viewer_port", str(free_port()),
                     "--target_pixels", str(target_pixels),
                     "--trajectory_path", str(root / "jpeg_traj.txt"),
                     "--device", str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t_start
    viewer, inc = out["viewer"], out["reconstruction"]
    try:
        status, page = http_get(viewer.port, "/")
        check(status == 200 and b"webgl" in page,
              f"phase 10: viewer page {status}")
        status, blob = http_get(viewer.port, "/cloud")
        ver, n_pts, n_cams = struct.unpack_from("<III", blob, 0)
        check(status == 200 and len(blob) == 12 + 15 * n_pts + 48 * n_cams,
              f"phase 10: /cloud {status}, {len(blob)} bytes")
        check(http_get(viewer.port, "/nope") == (200, page),
              "phase 10: another path does not serve the page")
        check(http_get(viewer.port, f"/cloudy?have={viewer.version}")[0]
              == 304, "phase 10: /cloudy?have=<version> not 304")
        want = sum(len(p) for p, _ in inc.points.values())
        check(ver == viewer.version and ver >= 2,
              f"phase 10: viewer version {ver} ({viewer.version})")
        check(n_pts == want and n_cams == len(inc.cameras)
              == inc.video.counter,
              f"phase 10: served {n_pts} points, {n_cams} cameras; the "
              f"reconstruction {want}, {len(inc.cameras)}")
    finally:
        viewer.close()
    finite_trajectory("phase 10 demo", root / "jpeg_traj.txt", n_frames)
    k1, k2 = count_launches("demo --viewer", kernels)
    return dict(frames=n_frames, seconds=seconds, version=ver,
                points=n_pts, cameras=n_cams, k1_launches=k1,
                k2_launches=k2, ms_per_frame={
                    k: v["mean_ms"] for k, v in out["phases"].items()})


def phase_planner(t: int = 512, n_existing: int = 3000) -> dict:
    """The C planner against its Python version on the t x t candidate
    grid ``terminate()`` plans over, with the backend's parameters (rad 2,
    nms 3, threshold 22, cap 16 t): distances growing with the frame gap,
    2 % loop closures and 2 % beyond 100, a few thousand stored edges."""
    rng = np.random.default_rng(SEED + 14)
    ii, jj = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    d = (0.4 * np.abs(ii - jj) * (0.5 + rng.random(ii.size))
         ).astype(np.float32)
    d[rng.random(d.size) < 0.02] = rng.random() * 20
    d[rng.random(d.size) < 0.02] = 150.0
    e = rng.integers(0, t, (n_existing, 2))
    args = (d, ii, jj, e[:, 0], e[:, 1], 0, 0, t, 2, 3, 22.0, 16 * t, False)
    c_ms = []
    for _ in range(5):
        t_start = time.perf_counter()
        got = native.proximity_plan(*args)
        c_ms.append(1e3 * (time.perf_counter() - t_start))
    t_start = time.perf_counter()
    plain = native.proximity_plan_plain(*args)
    plain_ms = 1e3 * (time.perf_counter() - t_start)
    check(np.array_equal(got, plain), f"phase 10: planner edge lists "
          f"differ ({len(got)} against {len(plain)})")
    return dict(t=t, candidates=int(d.size), stored_edges=n_existing,
                edges=len(got), c_ms_median=statistics.median(c_ms),
                plain_ms=plain_ms)


def frame_graph_helpers(dev, slam) -> dict:
    """``Video.reproject``, ``Video.distance_matrix`` and
    ``FactorGraph.filter_edges`` on a copy of phase 3's state (keyframes,
    the frontend's edges with every third weight scaled by 1e-4, and edges
    four keyframes apart added, half of them with zero weight), on the card
    against the CPU."""
    g, v = slam.frontend.graph, slam.video
    n = v.counter
    far = np.arange(4, n, 2)
    out = []
    for where in (dev, torch.device("cpu")):
        cv = Video(v.cfg.replace(buffer=n), where)
        for name in ("poses", "disps", "disps_sens", "intrinsics"):
            getattr(cv, name).copy_(getattr(v, name)[:n])
        cv.counter = n
        cg = FactorGraph(g.net, cv, g.cfg, max_factors=g.max_factors)
        cg.ii, cg.jj, cg.age = g.ii.copy(), g.jj.copy(), g.age.copy()
        cg.target, cg.hidden = g.target.to(where), g.hidden.to(where)
        cg.weight = g.weight.to(where).clone()
        cg.weight[::3] *= 1e-4
        cg.add_factors(far, far - 4)
        cg.weight[g.n_edges + 1::2] = 0.5
        t_start = time.perf_counter()
        coords, valid = cv.reproject(cg.ii, cg.jj)
        dist = cv.distance_matrix(beta=0.7)
        cg.filter_edges()
        if where == dev:
            torch.cuda.synchronize()
        out.append(dict(coords=coords.cpu(), valid=valid.cpu(), dist=dist,
                        ii=cg.ii, jj=cg.jj, bad=cg.ii_bad,
                        ms=1e3 * (time.perf_counter() - t_start)))
    a, b = out
    c_err = float((a["coords"] - b["coords"]).abs().max())
    scale = float(b["coords"].abs().max())
    d_rel = float(np.max(np.abs(a["dist"] - b["dist"])
                         / np.maximum(np.abs(b["dist"]), 1e-6)))
    check(c_err <= 1e-5 * max(scale, 1.0) + 1e-3,
          f"phase 10: reproject cuda vs cpu {c_err} (coordinates to {scale})")
    check(bool((a["valid"] == b["valid"]).float().mean() > 0.999),
          "phase 10: reproject validity differs")
    check(d_rel < 1e-4, f"phase 10: distance_matrix cuda vs cpu {d_rel}")
    check(np.array_equal(a["ii"], b["ii"]) and np.array_equal(a["jj"], b["jj"])
          and np.array_equal(a["bad"], b["bad"]) and len(a["bad"]) > 0,
          f"phase 10: filter_edges dropped {len(a['bad'])} edges on cuda, "
          f"{len(b['bad'])} on cpu, or kept other edges")
    return dict(keyframes=n, edges=len(g.ii) + len(far),
                filtered=len(a["bad"]),
                reproject_max_abs_diff=c_err, distance_max_rel_diff=d_rel,
                ms_cuda=a["ms"], ms_cpu=b["ms"])


def phase_jpeg(dev, kernels: dict, helpers: dict) -> dict:
    """Phase 10 (its frame-graph helpers ran on phase 3's state)."""
    t_start = time.perf_counter()
    report = dict(codec=phase_jpeg_codec(), helpers=helpers)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        report["scannet"] = phase_jpeg_track(dev, kernels, root)
        torch.cuda.empty_cache()
        report["replica"] = phase_replica(root)
        report["viewer"] = phase_jpeg_viewer(dev, kernels, root)
        torch.cuda.empty_cache()
    report["planner"] = phase_planner()
    report["seconds"] = time.perf_counter() - t_start + helpers["seconds"]
    c, sn, v, pl = (report[k] for k in ("codec", "scannet", "viewer",
                                        "planner"))
    print(f"phase 10: JPEG 480 x 640 at quality 95, host ms per decode "
          f"{c['420']['decode_ms']:.2f} (4:2:0) / {c['444']['decode_ms']:.2f}"
          f" (4:4:4), per fed frame {c['420']['feed_ms']:.2f}, PSNR >= "
          f"{min(x['psnr_db'] for x in c.values()):.1f} dB; ScanNet JPEG "
          f"RGB-D tracked at 384 x 512 ({sn['keyframes']} keyframes, "
          f"{sn['ms_per_keyframe_median']:.1f} ms per keyframe update, K1 "
          f"{sn['k1_launches']}, K2 {sn['k2_launches']}), poses finite; "
          f"Replica frames equal the encoder's decode; demo --viewer served "
          f"version {v['version']}, {v['points']} points, {v['cameras']} "
          f"cameras; planner at t = {pl['t']}: {pl['edges']} edges, C "
          f"{pl['c_ms_median']:.2f} ms, Python {pl['plain_ms']:.0f} ms, "
          f"equal; helpers cuda vs cpu: reproject "
          f"{helpers['reproject_max_abs_diff']:.2e}, distance "
          f"{helpers['distance_max_rel_diff']:.2e}, filter_edges dropped "
          f"{helpers['filtered']} alike; {report['seconds']:.0f} s")
    return report


# -- phase 11: the oracle pipeline, ConvGRU, FactorGraph.update, images ------

ORACLE = Path(__file__).resolve().parent / "tests" / "torch_oracle.py"
ORACLE_FRAMES = 24
CONV_GRU_ATOL = 1e-2  # cuDNN's TF32 convolutions against the CPU's fp32
# FactorGraph.update on phase 3's bf16 graph, cuda against cpu: bf16
# convolutions round each output to 8 bits of mantissa (3.9e-3 relative)
# on both devices, in another order of accumulation; a few such roundings
# per GRU iteration reach the targets (pixels), the weights and, through
# one damped DBA, the poses and disparities (relative)
UPDATE_TOL = dict(target=0.25, weight=0.05, poses=5e-3, disps=2e-2)


def load_oracle():
    """tests/torch_oracle.py (the oracle and scene of the port's
    end-to-end accuracy test) as a module."""
    spec = importlib.util.spec_from_file_location("torch_oracle", ORACLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_oracle(dev, group, T: int = ORACLE_FRAMES) -> dict:
    """The oracle pipeline (tests/test_torch_oracle_pipeline.py) at the
    full width of ``SLAMConfig()``: T frames through the real Frontend,
    then ``Backend(steps=6)``, once in this process and once sharded over
    the NCCL group of world size 1.  Each must keep its ATE below 1 % of
    the extent and cull a keyframe; neither launches K1 or K2 (the oracle
    replaces build_corr, lookup and alt_corr), which is counted."""
    oracle = load_oracle()
    cfg = oracle.full_width_config()
    runs = {}
    for name, g in (("one_process", None), ("nccl_world_size_1", group)):
        reset_counts()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "backend edge budget")
            r = oracle.run_pipeline(cfg, T, dev, group=g)
        updates = r["frontend_ms"][cfg.warmup:]  # after the initialising call
        check(r["culled"], f"phase 11 ({name}): the cull never fired")
        check(r["ate"] < 0.01 * r["extent"],
              f"phase 11 ({name}): oracle ATE {r['ate']} >= 1 % of the "
              f"extent {r['extent']}")
        runs[name] = dict(
            ate=r["ate"], extent=r["extent"],
            ate_over_extent=r["ate"] / r["extent"],
            keyframes=r["keyframes"], tstamps=r["tstamps"],
            ms_per_update_median=statistics.median(updates),
            ms_per_update_min=min(updates), ms_per_update_max=max(updates),
            ms_initialize=r["frontend_ms"][cfg.warmup - 1],
            backend_ms=r["backend_ms"],
            k1_launches=masked_corr_level0.launches,
            k2_launches=fused_pyramid_lookup.launches)
        torch.cuda.empty_cache()
    a, b = runs["one_process"], runs["nccl_world_size_1"]
    check(a["tstamps"] == b["tstamps"],
          "phase 11: the two oracle runs kept different keyframes")
    return dict(frames=T, image_size=list(cfg.image_size),
                thresholds=dict(keyframe=cfg.keyframe_thresh,
                                frontend=cfg.frontend_thresh,
                                backend=cfg.backend_thresh), **runs)


def phase_conv_gru(dev, E: int = 48, h: int = 48, w: int = 64,
                   cpu_edges=(0, 17, 31, 47)) -> dict:
    """``models.gru.ConvGRU(128, 320)`` at the update operator's full
    width (E = 48 edges over 48 x 64): its cuda output against the CPU's
    on the same weights and inputs, for a few of the edges (the cell is
    per edge: its pooling is over one edge's pixels)."""
    torch.manual_seed(SEED)
    gru = ConvGRU(128, 320).eval()
    gen = torch.Generator().manual_seed(SEED)
    net = torch.tanh(torch.randn(E, h, w, 128, generator=gen))
    ins = [torch.randn(E, h, w, c, generator=gen) for c in (128, 128, 64)]
    gru_c = ConvGRU(128, 320).to(dev).eval()
    gru_c.load_state_dict(gru.state_dict())
    net_c, ins_c = net.to(dev), [x.to(dev) for x in ins]
    with torch.no_grad():
        out = gru_c(net_c, *ins_c)
        ms = cuda_ms(lambda: gru_c(net_c, *ins_c))
        sel = list(cpu_edges)
        ref = gru(net[sel], *[x[sel] for x in ins])
    err = float((out[sel].cpu() - ref).abs().max())
    check(bool(torch.isfinite(out).all()), "phase 11: ConvGRU not finite")
    check(err <= CONV_GRU_ATOL, f"phase 11: ConvGRU cuda vs cpu {err} > "
          f"{CONV_GRU_ATOL}")
    return dict(edges=E, grid=[h, w], cpu_edges=sel, max_abs_diff=err,
                atol=CONV_GRU_ATOL, ms=ms)


def update_cuda_vs_cpu(dev, slam, window: int = 4) -> dict:
    """``FactorGraph.update`` (one GRU + DBA update) on a copy of phase
    3's state, on the card against the CPU: the keyframes, and the edges of
    the frontend's graph among its newest ``window`` keyframes with their
    hidden states, targets, weights and ages."""
    g, v = slam.frontend.graph, slam.video
    n = v.counter
    keep = np.nonzero((g.ii >= n - window) & (g.jj >= n - window))[0]
    check(len(keep) > 0, "phase 11: no edges among the newest keyframes")
    sel = torch.as_tensor(keep, device=g.target.device)
    out = []
    for where in (dev, torch.device("cpu")):
        cv = Video(v.cfg.replace(buffer=n), where)
        for name in Video._FIELDS:
            src = getattr(v, name)
            if src.shape[0] >= n:
                getattr(cv, name).copy_(src[:n])
        cv.counter = n
        net = slam.net if where == dev else \
            LGUNet.from_config(v.cfg, device="cpu").eval()
        if where != dev:
            net.load_state_dict(slam.net.state_dict())
        cg = FactorGraph(net, cv, g.cfg, max_factors=g.max_factors)
        cg.ii, cg.jj, cg.age = g.ii[keep], g.jj[keep], g.age[keep]
        cg.target, cg.weight = g.target[sel].to(where), \
            g.weight[sel].to(where)
        cg.hidden = g.hidden[sel].to(where)
        t_start = time.perf_counter()
        cg.update()
        if where == dev:
            torch.cuda.synchronize()
        out.append(dict(poses=cv.poses.cpu(), disps=cv.disps.cpu(),
                        target=cg.target.cpu(), weight=cg.weight.cpu(),
                        ms=1e3 * (time.perf_counter() - t_start)))
    a, b = out
    errs = dict(
        target=float((a["target"] - b["target"]).abs().max()),
        weight=float((a["weight"] - b["weight"]).abs().max()),
        poses=float((a["poses"] - b["poses"]).abs().max()),
        disps=float(((a["disps"] - b["disps"]).abs()
                     / b["disps"].abs().clamp(min=1e-3)).max()))
    for k, e in errs.items():
        check(e <= UPDATE_TOL[k], f"phase 11: FactorGraph.update cuda vs "
              f"cpu {k} differ by {e} > {UPDATE_TOL[k]}")
    check(bool(torch.isfinite(a["poses"]).all()),
          "phase 11: FactorGraph.update poses not finite")
    return dict(keyframes=n, edges=len(keep), max_diff=errs, tol=UPDATE_TOL,
                ms_cuda=a["ms"], ms_cpu=b["ms"])


def image_cases(rng) -> list:
    """(name, file bytes, reader kwargs, the pixels imread must return):
    the port's lossless fixtures of the modes its readers took in last."""
    H, W = 37, 53
    cases = []
    for depth in (1, 2, 4, 8):
        idx = rng.integers(0, 1 << depth, (H, W), np.uint8)
        pal = rng.integers(0, 256, (1 << depth, 3), np.uint8)
        trns = rng.integers(0, 256, 1 << depth, np.uint8)
        for interlace in (False, True):
            tag = f"{depth}-bit{' Adam7' if interlace else ''}"
            cases.append((f"PNG palette + tRNS {tag}", encode_png(
                idx, bit_depth=depth, palette=pal, trns=trns,
                interlace=interlace), {}, pal[idx]))
            gray = idx * np.uint8(255 // ((1 << depth) - 1))
            cases.append((f"PNG gray {tag}", encode_png(
                idx, bit_depth=depth, interlace=interlace),
                dict(anydepth=True), gray))
    for C, dtype in ((3, np.uint8), (4, np.uint16), (1, np.uint16)):
        top = 256 if dtype == np.uint8 else 65536
        im = rng.integers(0, top, (H, W, C), dtype)
        if C == 1:
            cases.append(("PNG gray 16-bit Adam7", encode_png(
                im, interlace=True), dict(anydepth=True), im[..., 0]))
        else:
            want = im[..., :3] if dtype == np.uint8 else \
                (im[..., :3] >> 8).astype(np.uint8)
            cases.append((f"PNG {C}-channel {8 * im.itemsize}-bit Adam7",
                          encode_png(im, interlace=True), {}, want))
    for C in (1, 3, 4):
        im = rng.integers(0, 256, (H, W, C), np.uint8)
        im = im[..., 0] if C == 1 else im
        want = im[..., :3] if C > 1 else np.repeat(im[..., None], 3, -1)
        for top_down in (False, True):
            cases.append((f"BMP {8 * C}-bit{' top-down' if top_down else ''}",
                          encode_bmp(im, top_down), {}, want))
    return cases


def truncated_jpeg(rng, H: int = 480, W: int = 640, cut_row: int = 12
                   ) -> dict:
    """A baseline 4:2:0 JPEG of the port's encoder with a restart marker
    after every MCU row, cut after the marker that ends MCU row
    ``cut_row``: the decode has the full shape, its rows before the cut
    equal the whole file's decode, and the MCU rows past the next one are
    uniform gray (their coefficients left at zero, as libjpeg leaves
    them)."""
    img = shifted_texture_frames(1, H, W, SEED + 2)
    img = next(iter(img))[1]
    data = encode_jpeg(img, 95, "420", restart_interval=W // 16)
    marks = [i for i in range(len(data) - 1) if data[i] == 0xFF
             and 0xD0 <= data[i + 1] <= 0xD7]
    cut = marks[cut_row - 1] + 2
    whole = decode_jpeg(data)
    part = decode_jpeg(data[:cut])
    exact = 16 * cut_row - 1  # h2v2 fancy upsampling reads the next row
    check(part.shape == whole.shape, f"phase 11: truncated JPEG decodes to "
          f"{part.shape}, not {whole.shape}")
    check(np.array_equal(part[:exact], whole[:exact]),
          "phase 11: truncated JPEG rows before the cut differ")
    check(bool((part[16 * (cut_row + 2):] == 128).all()),
          "phase 11: truncated JPEG rows past the cut are not gray")
    return dict(bytes=len(data), cut_at=cut, rows_equal=exact,
                gray_from_row=16 * (cut_row + 2))


def phase_images(root: Path) -> dict:
    """The image paths on the card machine's host, which has no OpenCV:
    each of the port's lossless fixtures (PNG palette with tRNS and gray at
    1, 2, 4 and 8 bits, plain and Adam7; Adam7 RGB, 16-bit RGBA and 16-bit
    gray; BMP 8-, 24- and 32-bit, bottom-up and top-down), written to disk,
    reads back as the pixels it was written from; and a truncated JPEG."""
    rng = np.random.default_rng(SEED)
    names = []
    t_start = time.perf_counter()
    for name, data, kw, want in image_cases(rng):
        path = root / "fixture"
        path.write_bytes(data)
        got = imread(str(path), **kw)
        check(got.shape == want.shape and got.dtype == want.dtype and
              np.array_equal(got, want),
              f"phase 11: {name} does not read back as written")
        names.append(name)
    ms = 1e3 * (time.perf_counter() - t_start)
    return dict(lossless=names, lossless_ms=ms,
                truncated_jpeg=truncated_jpeg(rng))


def phase_11(dev, group, update: dict) -> dict:
    """Phase 11 (its FactorGraph.update ran on phase 3's state)."""
    t_start = time.perf_counter()
    report = dict(oracle=phase_oracle(dev, group), update=update)
    report["conv_gru"] = phase_conv_gru(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        report["images"] = phase_images(Path(tmp))
    report["seconds"] = time.perf_counter() - t_start + update["seconds"]
    return report


def print_phase_11(report: dict, learned_ms: float) -> None:
    o, c, u = report["oracle"], report["conv_gru"], report["update"]
    a, b = o["one_process"], o["nccl_world_size_1"]
    print(f"phase 11: oracle pipeline at {tuple(o['image_size'])}, "
          f"{o['frames']} frames: ATE {a['ate']:.3g} ({a['ate_over_extent']:.2g}"
          f" of the extent) over {a['keyframes']} keyframes, "
          f"{a['ms_per_update_median']:.1f} ms per oracle keyframe update "
          f"(min {a['ms_per_update_min']:.1f}, max "
          f"{a['ms_per_update_max']:.1f}; phase 3's learned update "
          f"{learned_ms:.1f} ms), backend pass {a['backend_ms']:.1f} ms; "
          f"through Backend(group=) at world size 1 (NCCL): ATE "
          f"{b['ate']:.3g}, backend pass {b['backend_ms']:.1f} ms; K1 "
          f"{a['k1_launches'] + b['k1_launches']} and K2 "
          f"{a['k2_launches'] + b['k2_launches']} launches; ConvGRU E = "
          f"{c['edges']} cuda vs cpu {c['max_abs_diff']:.2e} "
          f"({c['ms']:.2f} ms); FactorGraph.update over {u['edges']} edges "
          f"cuda vs cpu: poses {u['max_diff']['poses']:.2e}, disps "
          f"{u['max_diff']['disps']:.2e}, targets "
          f"{u['max_diff']['target']:.2e}; "
          f"{len(report['images']['lossless'])} lossless fixtures and a "
          f"truncated JPEG read back; {report['seconds']:.0f} s")


# -- phase 12: TIFF, PNM / PAM / PFM, RLE BMP and CMYK JPEG frames ----------

def cmyk_bgr(cmyk: np.ndarray) -> np.ndarray:
    """OpenCV's BGR of Adobe (inverted) CMYK samples: R = K - ((255 - C) *
    K >> 8), G from M, B from Y (imgcodecs' icvCvt_CMYK2BGR_8u_C4C3R)."""
    c, m, y, k = (cmyk[..., i].astype(np.int64) for i in range(4))
    return np.stack([k - ((255 - y) * k >> 8), k - ((255 - m) * k >> 8),
                     k - ((255 - c) * k >> 8)], -1).astype(np.uint8)


CMYK_PSNR_DB = 35.0  # the CMYK JPEG's decode against cmyk_bgr(source)


def format_cases() -> list:
    """(name, file bytes, anydepth, what imread must return, the PSNR it
    must reach or None: the same array) of a rendered 480 x 640 frame and
    its depth (16-bit in 1/5000 m, and the same values as float32) in the
    formats phase 12 reads; the CMYK JPEG, which is lossy, must return
    cmyk_bgr of its source within CMYK_PSNR_DB."""
    images, depths = render_sequence(SEED + 13, 1, 480, 640, TUM_FR1, 0.02,
                                     0.004)[:2]
    img = images[0]
    d16 = np.clip(np.rint(depths[0] * 5000.0), 0, 65535).astype(np.uint16)
    d32 = d16.astype(np.float32)
    pal = np.stack([np.arange(0, 256, 4)] * 3, -1).astype(np.uint8)
    idx = (img[..., 1] >> 2).astype(np.uint8)
    idx[:, 320:] = idx[:, 320:321]  # long runs for RLE8
    cmyk = np.concatenate([img[..., ::-1], np.full_like(img[..., :1], 235)],
                          -1)
    return [
        ("TIFF LZW RGB", tiff.encode_tiff(img, "lzw", 2), False, img, None),
        ("TIFF Deflate float depth, floating-point predictor",
         tiff.encode_tiff(d32, "deflate", 3), True, d32, None),
        ("TIFF tiled big-endian RGB", tiff.encode_tiff(
            img, "deflate", 2, tile=(64, 64), big_endian=True), False, img,
         None),
        ("PGM 16-bit depth", pnm.encode_pnm(d16), True, d16, None),
        ("PPM", pnm.encode_pnm(img), False, img, None),
        ("PFM depth", pnm.encode_pfm(d32), True, d32, None),
        ("BMP RLE8", encode_bmp(idx, palette=pal, rle=True), False, pal[idx],
         None),
        ("JPEG CMYK", encode_jpeg(cmyk, 95, adobe_transform=0), False,
         cmyk_bgr(cmyk), CMYK_PSNR_DB),
    ]


def phase_format_codecs(root: Path, cases=None, phase: int = 12) -> dict:
    """Each format's file of ``cases`` (default :func:`format_cases`),
    written to disk on the host: ``imread`` returns the case's array (a
    lossy one within its PSNR of it), and the host's median ms of 10
    decodes."""
    out = {}
    path = root / "frame"
    for name, data, anydepth, want, min_db in cases or format_cases():
        path.write_bytes(data)
        got = imread(str(path), anydepth=anydepth)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"phase {phase}: {name} reads as {got.dtype} {got.shape}")
        if min_db is not None:
            db = psnr(got, want)
            check(db >= min_db, f"phase {phase}: {name} PSNR {db:.2f} dB")
        else:
            check(np.array_equal(got, want),
                  f"phase {phase}: {name} does not read back as written")
        out[name] = dict(bytes=len(data), decode_ms=host_ms(
            lambda _: imread(str(path), anydepth=anydepth), range(10)))
        if min_db is not None:
            out[name]["psnr_db"] = db
    return out


def tum_frames(root: Path, size: tuple) -> tuple:
    """``evaluate_tum_torch``'s stream (``tum_rgbd_stream``, stride 1) over
    a sequence, each frame resized to ``size`` (depth nearest) with its
    intrinsics scaled; and the host's median ms to feed a frame (the
    stream's decode, crop and halving, then the resize)."""
    H, W = size
    frames, ms = [], []
    stream = tum_rgbd_stream(str(root), stride=1)
    while True:
        t_start = time.perf_counter()
        item = next(stream, None)
        if item is None:
            break
        t, img, depth, intr = item
        h0, w0 = img.shape[:2]
        img = resize(img, (W, H))
        depth = resize(depth, (W, H), NEAREST)
        ms.append(1e3 * (time.perf_counter() - t_start))
        scale = np.asarray([W / w0, H / h0, W / w0, H / h0], np.float32)
        frames.append((t, img, depth, intr * scale))
    return frames, statistics.median(ms)


def phase_format_track(dev, kernels: dict, root: Path, n_frames: int = 24,
                       size: tuple = (384, 512),
                       pairs=(("ppm", "tiff"), ("png", "png")),
                       seed: int = SEED + 14, phase: int = 12,
                       key: str = "launches_formats", writer=None) -> dict:
    """A 24-frame TUM fr1 sequence written twice, in the (colour, depth)
    formats of ``pairs`` (``write_frame``'s kinds; phase 12: PPM colour
    with float32 TIFF depth and PNG colour with 16-bit PNG depth of the
    same values): the two streams feed equal frames and depth; each is
    tracked with depth at the full width of ``SLAMConfig()`` (thresholds
    0), then ``terminate()``.  K1's launches in track() equal the motion
    filter's probes plus the pyramid rebuilds, K2's the probes plus the
    GRU iterations (phase 3's count); the trajectories are finite.  The
    launches over both runs add to ``kernels[...][key]``.  ``writer(seq,
    color, depth)``, where given, writes each sequence instead of
    ``write_tum_sequence``."""
    runs, streams = {}, []
    cfg = SLAMConfig().replace(filter_thresh=0.0, keyframe_thresh=0.0,
                               image_size=size)
    for color, depth in pairs:
        seq = root / f"{color}_{depth}" / "rgbd_dataset_freiburg1_desk"
        t_start = time.perf_counter()
        if writer is not None:
            writer(seq, color, depth)
        else:
            write_tum_sequence(str(seq), n_frames, seed=seed, color=color,
                               depth=depth)
        write_s = time.perf_counter() - t_start
        frames, feed_ms = tum_frames(seq, size)
        streams.append(frames)
        slam = LGUSlam(init_state_dict(cfg, SEED), cfg, device=dev)
        reset_counts()
        kf_ms = []
        with CallCounts() as calls:
            for t, img, d, intr in frames:
                before = slam.video.counter
                t_start = time.perf_counter()
                slam.track(float(t), img, depth=d, intrinsics=intr)
                torch.cuda.synchronize()
                if slam.video.counter > before:
                    kf_ms.append(1e3 * (time.perf_counter() - t_start))
        k1, k2 = masked_corr_level0.launches_bf16, fused_pyramid_lookup.launches
        tag = f"{color} + {depth} depth"
        check(masked_corr_level0.launches == k1,
              f"phase {phase} {tag}: K1 fp32-operand launches")
        check(k1 > 0 and k1 == calls.probes + calls.rebuilds,
              f"phase {phase} {tag}: K1 launches {k1} != probes "
              f"{calls.probes} + rebuilds {calls.rebuilds}")
        check(k2 > 0 and k2 == calls.probes + calls.iterations,
              f"phase {phase} {tag}: K2 launches {k2} != probes "
              f"{calls.probes} + GRU iterations {calls.iterations}")
        n_kf = slam.video.counter
        check(bool(torch.isfinite(slam.video.poses[:n_kf]).all()),
              f"phase {phase} {tag}: non-finite keyframe poses")
        check(len(kf_ms) > cfg.warmup, f"phase {phase} {tag}: {len(kf_ms)} "
              f"keyframes, no update after the {cfg.warmup} of warm-up")
        t_start = time.perf_counter()
        traj = slam.terminate(iter(frames))
        torch.cuda.synchronize()
        terminate_s = time.perf_counter() - t_start
        check(traj.shape == (n_frames, 7) and bool(np.isfinite(traj).all()),
              f"phase {phase} {tag}: trajectory {traj.shape} not finite")
        k1_all = masked_corr_level0.launches_bf16
        k2_all = fused_pyramid_lookup.launches
        for kname, k in (("masked_corr_level0_tc", k1_all),
                         ("fused_pyramid_lookup", k2_all)):
            kernels[kname][key] = kernels[kname].get(key, 0) + k
        runs[tag] = dict(
            write_seconds=write_s, feed_ms=feed_ms, keyframes=n_kf,
            probes=calls.probes, pyramid_rebuilds=calls.rebuilds,
            gru_iterations=calls.iterations,
            ms_per_keyframe_median=statistics.median(kf_ms[cfg.warmup:]),
            terminate_seconds=terminate_s, k1_launches_track=k1,
            k2_launches_track=k2, k1_launches=k1_all, k2_launches=k2_all)
        del slam
        torch.cuda.empty_cache()
    a, b = streams
    check(len(a) == len(b) == n_frames,
          f"phase {phase}: the streams' lengths")
    names = [f"{c} + {d}" for c, d in pairs]
    for (ta, ia, da, xa), (tb, ib, db, xb) in zip(a, b):
        check(ta == tb and np.array_equal(ia, ib) and np.array_equal(xa, xb),
              f"phase {phase}: the {names[0]} and {names[1]} streams feed "
              "different frames")
        check(da.dtype == db.dtype == np.float32 and np.array_equal(da, db),
              f"phase {phase}: the {names[0]} and {names[1]} streams feed "
              "different depth")
    return runs


def phase_pgm_depth(root: Path, n_frames: int = 8) -> dict:
    """``rgbd_stream`` over a directory of 16-bit PGM depth maps (NYU Depth
    v2's raw form) beside PPM colour: 8 frames whose depth is the written
    millimetres / 1000, resized as the stream resizes."""
    images, depths = render_sequence(SEED + 15, n_frames, 480, 640, TUM_FR1,
                                     0.02, 0.004)[:2]
    for sub in ("rgb", "depth"):
        (root / sub).mkdir(parents=True)
    mm = np.clip(np.rint(depths * 1000), 0, 65535).astype(np.uint16)
    for k in range(n_frames):
        write_frame(str(root / "rgb" / f"{k:04d}"), images[k], "ppm")
        write_frame(str(root / "depth" / f"{k:04d}"), mm[k], "pgm")
    (root / "calib.txt").write_text(" ".join(map(str, TUM_FR1)) + "\n")
    t_start = time.perf_counter()
    items = list(rgbd_stream(str(root / "rgb"), str(root / "depth"),
                             str(root / "calib.txt")))
    ms = 1e3 * (time.perf_counter() - t_start) / max(len(items), 1)
    check(len(items) == n_frames, f"phase 12: rgbd_stream {len(items)} "
          "frames")
    for k, (_, img, d, _) in enumerate(items):
        h, w = img.shape[:2]
        want = resize(mm[k].astype(np.float32) / 1000.0, (w, h), NEAREST)
        check(d.dtype == np.float32 and np.array_equal(d, want),
              f"phase 12: PGM depth frame {k} is not the millimetres "
              "written")
    return dict(frames=n_frames, size=list(items[0][1].shape[:2]),
                ms_per_frame=ms)


def phase_12(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        report = dict(codecs=phase_format_codecs(root))
        report["tum"] = phase_format_track(dev, kernels, root / "tum")
        report["pgm_rgbd_stream"] = phase_pgm_depth(root / "nyu")
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_12(report: dict) -> None:
    codecs = ", ".join(f"{k} {v['decode_ms']:.2f}"
                       for k, v in report["codecs"].items())
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame (limit 33), "
        f"{v['keyframes']} "
        f"keyframes, {v['ms_per_keyframe_median']:.1f} ms per keyframe "
        f"update, K1 {v['k1_launches']} / K2 {v['k2_launches']} launches"
        for k, v in report["tum"].items())
    print(f"phase 12: host decode ms at 480 x 640: {codecs}; TUM RGB-D at "
          f"384 x 512, equal depth from both streams: {tum}; rgbd_stream "
          f"over 16-bit PGM depth {report['pgm_rgbd_stream']['frames']} "
          f"frames; {report['seconds']:.0f} s")


# -- phase 13: arithmetic and lossless JPEG, JPEG-in-TIFF, BigTIFF ---------

TIFF_JPEG_PSNR_DB = 30.0  # JPEG TIFF (quality 90, YCbCr 4:2:0) vs source


def arith_cases() -> list:
    """:func:`format_cases`' tuples of a rendered 480 x 640 frame and its
    depth (float64, in 1/5000 m) in the formats phase 13 reads: the
    arithmetic files must decode to the samples of the Huffman file of
    the same coefficients, the lossless one and the BigTIFF to their
    source, the JPEG TIFFs to within TIFF_JPEG_PSNR_DB of it."""
    images, depths = render_sequence(SEED + 16, 1, 480, 640, TUM_FR1, 0.02,
                                     0.004)[:2]
    img = images[0]
    d64 = depths[0].astype(np.float64) * 5000.0
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "huffman.jpg"
        path.write_bytes(encode_jpeg(img))
        huffman = imread(str(path))
    return [
        ("JPEG arithmetic sequential", encode_jpeg(img, arithmetic=True),
         False, huffman, None),
        ("JPEG arithmetic progressive", encode_jpeg(
            img, arithmetic=True, progressive=True), False, huffman, None),
        ("JPEG lossless gray", encode_jpeg(img[..., 1], lossless=True,
                                           predictor=6), True, img[..., 1],
         None),
        ("TIFF JPEG strips", tiff.encode_tiff(
            img, "jpeg", rows_per_strip=16, quality=90), False, img,
         TIFF_JPEG_PSNR_DB),
        ("TIFF JPEG tiles", tiff.encode_tiff(
            img, "jpeg", tile=(128, 128), quality=90), False, img,
         TIFF_JPEG_PSNR_DB),
        ("BigTIFF float64 depth", tiff.encode_tiff(
            d64, "deflate", 3, bigtiff=True), True, d64, None),
    ]


def phase_13(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        report = dict(codecs=phase_format_codecs(root, arith_cases(), 13))
        runs = phase_format_track(
            dev, kernels, root / "tum", seed=SEED + 17, phase=13,
            pairs=(("arith-jpg", "bigtiff"), ("jpg", "png")),
            key="launches_arith")
    arith, huffman = runs.values()
    for name in ("k1_launches_track", "k2_launches_track"):
        check(arith[name] == huffman[name],
              f"phase 13: {name} {arith[name]} (arithmetic JPEG + BigTIFF) "
              f"!= {huffman[name]} (Huffman JPEG + PNG)")
    report["tum"] = runs
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_13(report: dict) -> None:
    codecs = ", ".join(f"{k} {v['decode_ms']:.2f}"
                       for k, v in report["codecs"].items())
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame, {v['keyframes']} "
        f"keyframes, {v['ms_per_keyframe_median']:.1f} ms per keyframe "
        f"update, K1 {v['k1_launches']} / K2 {v['k2_launches']} launches "
        f"(track {v['k1_launches_track']} / {v['k2_launches_track']})"
        for k, v in report["tum"].items())
    print(f"phase 13: host decode ms at 480 x 640: {codecs}; TUM RGB-D at "
          f"384 x 512, equal frames and depth from both streams: {tum}; "
          f"{report['seconds']:.0f} s")


# -- phase 14: WebP, GIF, Radiance HDR, Sun raster ------------------------

WEBP_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "webp"
PHASE_14_FRAMES = 16  # the TUM sequence's length: the phase's 45 s budget


def formats_14_cases() -> list:
    """:func:`format_cases`' tuples of a rendered 480 x 640 frame and its
    depth (16-bit in 1/5000 m) in the formats phase 14 reads, written by
    the port's own encoders: each must read back as written (GIF: its
    colour-cube colours; HDR: the RGBE values of its depth, as float32
    with ``anydepth``, as ``round(255 f)`` without)."""
    images, depths = render_sequence(SEED + 18, 1, 480, 640, TUM_FR1, 0.02,
                                     0.004)[:2]
    img = images[0]
    d16 = np.clip(np.rint(depths[0] * 5000.0), 0, 65535).astype(np.uint16)
    idx, palette = gif_cube(img)
    cube = np.ascontiguousarray(palette[idx][..., ::-1])
    gray3 = np.repeat(d16.astype(np.float32)[..., None], 3, -1)
    hdr_file = hdr.encode_hdr(gray3)
    return [
        ("WebP lossless (VP8L)", webp.encode_webp_lossless(img), False, img,
         None),
        ("GIF", gif.encode_gif([idx], palette=palette), False, cube, None),
        ("HDR depth, anydepth", hdr_file, True, hdr.depth_values(d16), None),
        ("HDR depth, colour", hdr_file, False, hdr.to_uint8(
            hdr.rgbe_to_float(hdr.float_to_rgbe(gray3))), None),
        ("Sun raster 24-bit", sunras.encode_sunras(img), False, img, None),
        ("Sun raster colour map", sunras.encode_sunras(idx, colormap=palette),
         False, cube, None),
    ]


def phase_committed(folder: Path, phase: int, keep=None) -> dict:
    """The committed files of another library's encoder (``folder``:
    ``tests/data/webp``, libwebp's lossy VP8, VP8X with lossy and lossless
    alpha, an animation; ``tests/data/tiff``, libtiff's CCITT, gray with
    alpha, CMYK, YCbCr, L*a*b*, LogL, and phase 17's files; ``tests/data/
    jp2``, OpenJPEG's JPEG 2000 through Pillow, cv2.imwrite and its own
    API) decode to the SHA-256 of ``cv2.imread``'s arrays (``hashes.json``
    beside them) in both read modes, or are refused in a mode whose hash
    is null; the host's median ms of 10 colour decodes (IMREAD_ANYDEPTH
    ones where the colour read is refused, or refusals) of each.
    ``keep``: which names (default: all)."""
    hashes = json.loads((folder / "hashes.json").read_text())
    out = {}
    for name, want in sorted(hashes.items()):
        if keep is not None and not keep(name):
            continue
        path = str(folder / name)
        if want["color"] is None and want["anydepth"] is None:
            out[name] = dict(bytes=want["bytes"], refused=True, ms=host_ms(
                lambda mode: refused(path, mode, phase),
                ("color", "anydepth") * 5))
            continue
        for mode in ("color", "anydepth"):
            if want[mode] is None:
                refused(path, mode, phase)
                continue
            got = imread(path, anydepth=mode == "anydepth")
            digest = hashlib.sha256(np.ascontiguousarray(got).tobytes())
            check(digest.hexdigest() == want[mode]["sha256"]
                  and list(got.shape) == want[mode]["shape"]
                  and str(got.dtype) == want[mode]["dtype"],
                  f"phase {phase}: {name} ({mode}) is not cv2.imread's "
                  "array")
        gray = want["color"] is None  # time a mode that reads
        out[name] = dict(bytes=want["bytes"], decode_ms=host_ms(
            lambda _: imread(path, anydepth=gray), range(10)))
    return out


def refused(path: str, mode: str, phase: int) -> None:
    """``imread`` of ``path`` in ``mode`` raises ValueError."""
    try:
        imread(path, anydepth=mode == "anydepth")
    except ValueError:
        return
    fail(f"phase {phase}: {path} ({mode}) read; OpenCV refuses it")


def refusals(root: Path, cases, phase: int) -> dict:
    """Files of ``cases`` ((name, bytes)) OpenCV 5.0 returns None for:
    ValueError, timed."""
    out = {}
    for name, data in cases:
        path = root / "refused"
        path.write_bytes(data)
        t_start = time.perf_counter()
        try:
            imread(str(path))
            fail(f"phase {phase}: {name} read; OpenCV refuses it")
        except ValueError:
            pass
        out[name] = dict(refused=True, ms=1e3 * (time.perf_counter() -
                                                 t_start))
    return out


def refusals_14() -> list:
    """Sun raster files OpenCV refuses: its header check refuses the
    byte-encoded and RGB-order types."""
    img = render_sequence(SEED + 18, 1, 48, 64, TUM_FR1, 0.02, 0.004)[0][0]
    return [("Sun raster byte-encoded", sunras.encode_sunras(
        img[..., 0], kind=sunras.RT_BYTE_ENCODED)),
            ("Sun raster RGB order", sunras.encode_sunras(
                img, kind=sunras.RT_FORMAT_RGB))]


def phase_14(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        report = dict(codecs=phase_format_codecs(root, formats_14_cases(),
                                                 14))
        report["committed_webp"] = phase_committed(WEBP_FIXTURES, 14)
        report["refused"] = refusals(root, refusals_14(), 14)
        runs = phase_format_track(
            dev, kernels, root / "tum", n_frames=PHASE_14_FRAMES,
            seed=SEED + 19, phase=14,
            pairs=(("webp", "hdr"), ("png", "rgbe-tiff")),
            key="launches_formats_14")
    webp_run, png_run = runs.values()
    for name in ("k1_launches_track", "k2_launches_track"):
        check(webp_run[name] == png_run[name],
              f"phase 14: {name} {webp_run[name]} (WebP + HDR) != "
              f"{png_run[name]} (PNG + TIFF)")
    report["tum"] = runs
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_14(report: dict) -> None:
    codecs = ", ".join(f"{k} {v['decode_ms']:.2f}" for k, v in
                       {**report["codecs"],
                        **report["committed_webp"]}.items())
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame, {v['keyframes']} "
        f"keyframes, {v['ms_per_keyframe_median']:.1f} ms per keyframe "
        f"update, K1 {v['k1_launches']} / K2 {v['k2_launches']} launches "
        f"(track {v['k1_launches_track']} / {v['k2_launches_track']})"
        for k, v in report["tum"].items())
    print(f"phase 14: host decode ms at 480 x 640 (committed WebP files at "
          f"their sizes): {codecs}; TUM RGB-D at 384 x 512, equal frames and "
          f"depth from both streams: {tum}; {report['seconds']:.0f} s")


# -- phase 15: the TIFF files cv2.imread reads that the port last took in ----

TIFF_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "tiff"
PHASE_15_FRAMES = 16  # the TUM sequence's length, as phase 14's
PHASE_15_PSNR_DB = 30.0  # the lossy cases against their source frame


def logl_codes(depth: np.ndarray) -> tuple:
    """16-bit SGI LogL codes of the luminance ``depth / 10`` (m), and the
    8-bit gray libtiff's RGBA interface makes of them, computed apart from
    the port: 256 sqrt(Y) of Y = 2^((Le + 0.5) / 256 - 64)."""
    y = np.maximum(depth / 10.0, 1e-9)
    codes = np.clip(np.floor(256 * (np.log2(y) + 64)), 1, 32767)
    y_back = np.exp2((codes + 0.5) / 256 - 64)
    gray = np.where(y_back >= 1, 255, np.floor(256 * np.sqrt(y_back)))
    return codes.astype(np.int16), gray.astype(np.uint8)


def formats_15_cases() -> list:
    """:func:`format_cases`' tuples of a rendered 480 x 640 frame and its
    depth through each reader phase 15 adds, written by the port's own
    encoders: CCITT Group 4 and Group 3 2-D of the thresholded green
    channel (read as black and white, min-is-white), old-style LZW RGB and
    gray with alpha (the samples), CMYK with no black (the colours), YCbCr
    2 x 2 and CIE L*a*b* (lossy: within PHASE_15_PSNR_DB of the frame) and
    SGI LogL of the depth (the gray libtiff makes of it, within 40 dB)."""
    from lgu_slam_tpu_torch.data.fixtures import lab_samples, ycbcr_tiff

    images, depths = render_sequence(SEED + 20, 1, 480, 640, TUM_FR1, 0.02,
                                     0.004)[:2]
    img = images[0]
    bits = (img[..., 1] > 110).astype(np.uint8)
    shown = np.repeat((255 * (1 - bits))[..., None], 3, -1).astype(np.uint8)
    gray = img[..., 1]
    cmyk = np.concatenate([255 - img[..., ::-1], np.zeros_like(gray)[
        ..., None]], -1)
    codes, logl_gray = logl_codes(depths[0])
    return [
        ("TIFF CCITT Group 4", tiff.encode_tiff(bits, "group4", bilevel=True,
                                                photometric=0), False, shown,
         None),
        ("TIFF CCITT Group 3 2-D", tiff.encode_tiff(
            bits, "group3", bilevel=True, photometric=0, t4_options=5),
         False, shown, None),
        ("TIFF old-style LZW RGB", tiff.encode_tiff(img, "lzw_old"), False,
         img, None),
        ("TIFF gray + alpha", tiff.encode_tiff(
            np.stack([gray, img[..., 2]], -1), extra_samples=2), True, gray,
         None),
        ("TIFF CMYK", tiff.encode_tiff(cmyk, photometric=5), False, img,
         None),
        ("TIFF YCbCr 2x2", ycbcr_tiff(img), False, img, PHASE_15_PSNR_DB),
        ("TIFF CIE L*a*b*", tiff.encode_tiff(lab_samples(img),
                                             photometric=8), False, img,
         PHASE_15_PSNR_DB),
        ("TIFF SGI LogL depth", tiff.encode_tiff(codes, "sgilog"), False,
         np.repeat(logl_gray[..., None], 3, -1), 40.0),
    ]


def refusals_15() -> list:
    """TIFF files OpenCV refuses: a 16-bit palette, 16-bit CMYK, old-style
    JPEG with its JPEG tags (its libtiff is built without the codec)."""
    img = render_sequence(SEED + 20, 1, 48, 64, TUM_FR1, 0.02, 0.004)[0][0]
    jpg = encode_jpeg(img, 90)
    return [("TIFF 16-bit palette", tiff.encode_tiff(
        img[..., 0].astype(np.uint16) * 257,
        palette=np.zeros((1 << 16, 3), np.uint16))),
            ("TIFF 16-bit CMYK", tiff.encode_tiff(np.concatenate(
                [img, img[..., :1]], -1).astype(np.uint16) * 257,
                photometric=5)),
            ("TIFF old-style JPEG", tiff.encode_tiff(
                img, photometric=6, chunks=[jpg], tags={
                    259: (3, [6]), 513: (4, [8]), 514: (4, [len(jpg)])}))]


def phase_15(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        report = dict(codecs=phase_format_codecs(root, formats_15_cases(),
                                                 15))
        report["committed_tiff"] = phase_committed(
            TIFF_FIXTURES, 15,
            keep=lambda name: not tiff_17(name) and not tiff_18(name))
        report["refused"] = refusals(root, refusals_15(), 15)
        runs = phase_format_track(
            dev, kernels, root / "tum", n_frames=PHASE_15_FRAMES,
            seed=SEED + 21, phase=15,
            pairs=(("ycbcr-tiff", "lzw16-tiff"), ("ycbcr-png", "png")),
            key="launches_formats_15")
    tiff_run, png_run = runs.values()
    for name in ("k1_launches_track", "k2_launches_track"):
        check(tiff_run[name] == png_run[name],
              f"phase 15: {name} {tiff_run[name]} (YCbCr + LZW TIFF) != "
              f"{png_run[name]} (PNG + 16-bit PNG)")
    report["feed_ratio"] = tiff_run["feed_ms"] / png_run["feed_ms"]
    report["tum"] = runs
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_15(report: dict) -> None:
    codecs = ", ".join(f"{k} {v['decode_ms']:.2f}" for k, v in
                       {**report["codecs"],
                        **report["committed_tiff"]}.items())
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame, {v['keyframes']} "
        f"keyframes, {v['ms_per_keyframe_median']:.1f} ms per keyframe "
        f"update, K1 {v['k1_launches']} / K2 {v['k2_launches']} launches "
        f"(track {v['k1_launches_track']} / {v['k2_launches_track']})"
        for k, v in report["tum"].items())
    print(f"phase 15: host decode ms at 480 x 640 (committed TIFF files at "
          f"96 x 128): {codecs}; TUM RGB-D at 384 x 512, equal frames and "
          f"depth from both streams: {tum}; TIFF / PNG feed "
          f"{report['feed_ratio']:.3f}; {report['seconds']:.0f} s")


# -- phase 16: JPEG 2000 -----------------------------------------------------

JP2_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "jp2"
PHASE_16_FRAMES = 16  # the TUM sequence's length, as phases 14 and 15's


def formats_16_cases() -> list:
    """:func:`format_cases`' tuples of a rendered 480 x 640 frame and its
    depth (16-bit in 1/5000 m) as lossless JPEG 2000 from the port's
    writer: a JP2 of the colour frame, a raw codestream of the depth (read
    with ``anydepth``), each read back as written."""
    images, depths = render_sequence(SEED + 22, 1, 480, 640, TUM_FR1, 0.02,
                                     0.004)[:2]
    d16 = np.clip(np.rint(depths[0] * 5000.0), 0, 65535).astype(np.uint16)
    return [("JP2 lossless 5/3 + RCT", jp2.encode_jp2(images[0]), False,
             images[0], None),
            ("J2K 16-bit depth", jp2.encode_jp2(d16, codestream=True), True,
             d16, None)]


def refusals_16() -> list:
    """JPEG 2000 files OpenCV refuses: signed components, subsampled
    components, the CMYK colour space, a gray codestream read in colour
    (sRGB of one component), a colour codestream without its EOC."""
    img = render_sequence(SEED + 22, 1, 48, 64, TUM_FR1, 0.02, 0.004)[0][0]
    colour = jp2.encode_jp2(img)
    siz = colour.index(b"\xff\x51") + 40  # component 0's Ssiz, XRsiz

    def patched(at, value):
        return colour[:at] + value + colour[at + len(value):]

    colr = colour.index(b"colr") + 7
    gray = jp2.encode_jp2(img[..., 1], codestream=True)
    return [("JPEG 2000 signed components", patched(siz, b"\x87")),
            ("JPEG 2000 subsampled component", patched(siz + 1, b"\x02")),
            ("JPEG 2000 CMYK colour space", patched(colr, struct.pack(
                ">I", 12))),
            ("JPEG 2000 gray codestream in colour", gray),
            ("JPEG 2000 codestream without EOC",
             jp2.encode_jp2(img, codestream=True)[:-2])]


def phase_16(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        report = dict(codecs=phase_format_codecs(root, formats_16_cases(),
                                                 16))
        report["committed_jp2"] = phase_committed(
            JP2_FIXTURES, 16, keep=lambda name: not ht_18(name))
        report["refused"] = refusals(root, refusals_16(), 16)
        runs = phase_format_track(
            dev, kernels, root / "tum", n_frames=PHASE_16_FRAMES,
            seed=SEED + 23, phase=16, pairs=(("jp2", "jp2"), ("png", "png")),
            key="launches_formats_16")
    jp2_run, png_run = runs.values()
    for name in ("k1_launches_track", "k2_launches_track"):
        check(jp2_run[name] == png_run[name],
              f"phase 16: {name} {jp2_run[name]} (JP2 + JP2 depth) != "
              f"{png_run[name]} (PNG + 16-bit PNG)")
    report["feed_ratio"] = jp2_run["feed_ms"] / png_run["feed_ms"]
    report["tum"] = runs
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_16(report: dict) -> None:
    codecs = ", ".join(f"{k} {v['decode_ms']:.2f}" for k, v in
                       {**report["codecs"],
                        **report["committed_jp2"]}.items())
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame, {v['keyframes']} "
        f"keyframes, {v['ms_per_keyframe_median']:.1f} ms per keyframe "
        f"update, K1 {v['k1_launches']} / K2 {v['k2_launches']} launches "
        f"(track {v['k1_launches_track']} / {v['k2_launches_track']})"
        for k, v in report["tum"].items())
    print(f"phase 16: host decode ms (480 x 640 frames; committed JPEG 2000 "
          f"files at their sizes): {codecs}; TUM RGB-D at 384 x 512, equal "
          f"frames and depth from both streams: {tum}; JP2 / PNG feed "
          f"{report['feed_ratio']:.3f}; {report['seconds']:.0f} s")


# -- phase 17: the sharded backend's scaling script; the TIFF leftovers -----

PHASE_17_WORLDS_CPU = (1, 2, 4)  # the host's gloo worlds (8 would crowd it)
# the card run: the script's defaults at world size 1 in this process, so
# that the counts cover every pass of it (a warm-up and the timed reps)
PHASE_17_CARD_REPS = 3
# the host run's arguments: on the card machine's host a t = 16 pass of one
# step takes 3.8-7.3 s (phase 17 then took 73 s of its 60), so the host
# scales an 8-keyframe graph one step deep, one timed pass per world size
PHASE_17_HOST_ARGS = ["--device", "cpu", "--t", "8", "--steps", "1",
                      "--reps", "1"]
# phase 2's backend bound on cuda against cpu poses, also held on the
# disparities (about 0.5-0.8)
PHASE_17_TOL = 2e-2
TIFF_17 = ("short_strip.tif", "jpeg_separate.tif",
           "ycbcr_tiles_predictor.tif", "jpeg_short_strip.tif",
           "logluv32.tif")


def tiff_17(name: str) -> bool:
    """Whether a committed TIFF file is phase 17's (phase 15 reads the
    rest)."""
    return name in TIFF_17 or name.startswith("c2_")


def phase_scaling(dev, kernels: dict) -> dict:
    """The scaling script on the card (world size 1) and on the host
    (gloo), and one pass of its first graph on the card against the CPU."""
    scaling = load_script("bench_backend_scaling_torch")
    reset_counts()
    card = scaling.main(["--reps", str(PHASE_17_CARD_REPS)], worlds=(1,))
    passes = 1 + PHASE_17_CARD_REPS
    k1, k2 = masked_corr_level0.launches, fused_pyramid_lookup.launches
    check(k2 > 0, f"phase 17: the backend passes launched K2 {k2} times")
    for name, n in (("masked_corr_level0_tc", k1),
                    ("fused_pyramid_lookup", k2)):
        kernels[name]["launches_scaling_17"] = n
    host = scaling.main(PHASE_17_HOST_ARGS, worlds=PHASE_17_WORLDS_CPU)
    sd = init_state_dict(scaling.config(32), seed=0)
    on_card = scaling.run_world(1, 32, 1, 0, dev, state_dict=sd)
    on_cpu = scaling.run_world(1, 32, 1, 0, "cpu", state_dict=sd)
    check(np.array_equal(on_card["ii"], on_cpu["ii"])
          and np.array_equal(on_card["jj"], on_cpu["jj"]),
          "phase 17: the card's and the CPU's graphs differ")
    err = {k: float((on_card[k] - on_cpu[k]).abs().max())
           for k in ("poses", "disps")}
    for k, e in err.items():
        check(np.isfinite(e) and e < PHASE_17_TOL, f"phase 17: a pass's "
              f"{k} differ by {e} on cuda and cpu (> {PHASE_17_TOL})")
    return dict(card=card, host=host, edges=on_card["edges"],
                k1_launches=k1, k2_launches=k2,
                passes=passes, k2_launches_per_pass=k2 / passes,
                cuda_vs_cpu=err,
                tol=PHASE_17_TOL)


def phase_17(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    report = dict(scaling=phase_scaling(dev, kernels))
    report["committed_tiff"] = phase_committed(TIFF_FIXTURES, 17,
                                               keep=tiff_17)
    frame = render_sequence(SEED + 24, 1, 480, 640, TUM_FR1, 0.02,
                            0.004)[0][0]
    sep = tiff.encode_tiff(frame, "jpeg", planar=2, photometric=2,
                           rows_per_strip=16)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "separate.tif"
        path.write_bytes(sep)
        got = imread(str(path))
        check(got.shape == frame.shape and psnr(got, frame) > 30.0,
              f"phase 17: the JPEG TIFF of separate planes reads at "
              f"{psnr(got, frame):.1f} dB")
        report["jpeg_separate_480x640"] = dict(
            bytes=len(sep), psnr_db=psnr(got, frame),
            decode_ms=host_ms(lambda _: imread(str(path)), range(10)))
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_17(report: dict) -> None:
    s = report["scaling"]
    refused_ms = [v["ms"] for v in report["committed_tiff"].values()
                  if v.get("refused")]
    read_ms = ", ".join(f"{k} {v['decode_ms']:.2f}" for k, v in
                        report["committed_tiff"].items()
                        if not v.get("refused"))
    print(f"phase 17: scaling script on the card {s['card']['ms']} ms per "
          f"pass ({s['edges']} edges, t = {s['card']['t']}, "
          f"{s['card']['steps']} steps; K1 "
          f"{s['k1_launches']} / K2 {s['k2_launches']} launches over its "
          f"{s['passes']} passes), on the host (gloo, t = {s['host']['t']}, "
          f"{s['host']['steps']} steps) {s['host']['ms']}; one pass cuda vs "
          f"cpu: poses {s['cuda_vs_cpu']['poses']:.3g}, disparities "
          f"{s['cuda_vs_cpu']['disps']:.3g} (< {s['tol']}); committed TIFF "
          f"files equal to cv2's hashes ({read_ms} ms), "
          f"{len(refused_ms)} refused ({min(refused_ms):.2f}-"
          f"{max(refused_ms):.2f} ms); JPEG TIFF of separate planes at 480 "
          f"x 640 decoded in "
          f"{report['jpeg_separate_480x640']['decode_ms']:.2f} ms; "
          f"{report['seconds']:.0f} s")


# -- phase 18: TIFF LogLuv24 and 12-bit samples, HTJ2K code blocks ---------

# the TUM sequence's length, as phases 14-16's: SLAMConfig()'s warm-up
# takes 12 keyframes, and the check wants updates after it
PHASE_18_FRAMES = 16
# the 9/7 HT frame's least PSNR against the frame written (the writer's
# steps of 1/2 give 46.6 dB on a rendered frame)
PHASE_18_PSNR_DB = 40.0


def tiff_18(name: str) -> bool:
    """Whether a committed TIFF file is phase 18's."""
    return name.startswith(("logluv24_", "twelve_bit_"))


def ht_18(name: str) -> bool:
    """Whether a committed JPEG 2000 file is phase 18's (HT)."""
    return name.startswith("ht_")


def formats_18_cases() -> list:
    """:func:`format_cases`' tuples of a rendered 480 x 640 frame through
    the port's JPEG 2000 writer (HT lossless 5/3 + RCT, HT 9/7 + ICT, and
    the EBCOT lossless file of phase 16's kind beside them) and of its
    depth's top 12 bits as 12-bit TIFF samples (read back shifted up by
    4)."""
    images, depths = render_sequence(SEED + 25, 1, 480, 640, TUM_FR1, 0.02,
                                     0.004)[:2]
    img = images[0]
    d16 = np.clip(np.rint(depths[0] * 5000.0), 0, 65535).astype(np.uint16)
    top = np.minimum(d16 >> 4, 4095).astype(np.uint16)
    return [("HT JP2 lossless 5/3 + RCT", jp2.encode_jp2(img, ht=True),
             False, img, None),
            ("HT JP2 9/7 + ICT", jp2.encode_jp2(img, ht=True,
                                                irreversible=True),
             False, img, PHASE_18_PSNR_DB),
            ("EBCOT JP2 lossless 5/3 + RCT", jp2.encode_jp2(img), False,
             img, None),
            ("TIFF 12-bit depth", tiff.encode_tiff(top, twelve_bit=True),
             True, top << 4, None)]


def refusals_18() -> list:
    """Files OpenCV refuses: HT code blocks of more than one HT set (4
    passes with refinement), HT blocks whose missing MSBs leave a quad's
    U_q past its bit-planes, a 12-bit TIFF read in colour, LogLuv24 of
    32-bit float samples."""
    img = render_sequence(SEED + 25, 1, 48, 64, TUM_FR1, 0.02, 0.004)[0][0]
    codes = (img[..., 1].astype(np.uint32) << 14) | img[..., 2]
    return [("HT JPEG 2000 four passes", jp2.encode_jp2(
        img, ht=True, refine=2, placeholder=1)),
            ("HT JPEG 2000 U_q past its bit-planes", jp2.encode_jp2(
                img, ht=True, extra_missing=1)),
            ("TIFF 12-bit in colour", tiff.encode_tiff(
                img.astype(np.uint16) * 16, twelve_bit=True)),
            ("TIFF LogLuv24 of float samples", tiff.encode_tiff(
                codes, "sgilog24", tags={258: (3, [32] * 3),
                                         339: (3, [3] * 3)}))]


def phase_18(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        report = dict(codecs=phase_format_codecs(root, formats_18_cases(),
                                                 18))
        report["committed_tiff"] = phase_committed(TIFF_FIXTURES, 18,
                                                   keep=tiff_18)
        report["committed_jp2"] = phase_committed(JP2_FIXTURES, 18,
                                                  keep=ht_18)
        report["refused"] = refusals(root, refusals_18(), 18)
        runs = phase_format_track(
            dev, kernels, root / "tum", n_frames=PHASE_18_FRAMES,
            seed=SEED + 26, phase=18,
            pairs=(("ht-jp2", "12bit-tiff"), ("png", "12bit-png")),
            key="launches_formats_18")
    ht_run, png_run = runs.values()
    for name in ("k1_launches_track", "k2_launches_track"):
        check(ht_run[name] == png_run[name],
              f"phase 18: {name} {ht_run[name]} (HT JP2 + 12-bit TIFF) != "
              f"{png_run[name]} (PNG + 16-bit PNG)")
    codecs = report["codecs"]
    report["ht_over_ebcot_decode"] = \
        codecs["HT JP2 lossless 5/3 + RCT"]["decode_ms"] / \
        codecs["EBCOT JP2 lossless 5/3 + RCT"]["decode_ms"]
    report["feed_ratio"] = ht_run["feed_ms"] / png_run["feed_ms"]
    report["tum"] = runs
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_18(report: dict) -> None:
    codecs = ", ".join(f"{k} {v['decode_ms']:.2f}" for k, v in
                       report["codecs"].items())
    committed = ", ".join(
        f"{k} {v['decode_ms']:.2f}" for k, v in
        {**report["committed_tiff"], **report["committed_jp2"]}.items()
        if not v.get("refused"))
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame, {v['keyframes']} "
        f"keyframes, {v['ms_per_keyframe_median']:.1f} ms per keyframe "
        f"update, K1 {v['k1_launches']} / K2 {v['k2_launches']} launches "
        f"(track {v['k1_launches_track']} / {v['k2_launches_track']})"
        for k, v in report["tum"].items())
    print(f"phase 18: host decode ms of 480 x 640 frames: {codecs} (HT / "
          f"EBCOT {report['ht_over_ebcot_decode']:.3f}); committed files "
          f"equal to cv2's hashes: {committed}; {len(report['refused'])} "
          f"refusals; TUM RGB-D at 384 x 512, equal frames and depth from "
          f"both streams: {tum}; HT + 12-bit / PNG feed "
          f"{report['feed_ratio']:.3f}; {report['seconds']:.0f} s")


# -- phase 19: EXIF orientation of PNG and WebP, lossless AVIF ------------

AVIF_FIXTURES = Path(__file__).resolve().parent / "tests" / "data" / "avif"
PHASE_19_FRAMES = 16


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    import zlib

    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _exif_block(value: int, order: str) -> bytes:
    e = "<" if order == "II" else ">"
    return (order.encode() + struct.pack(e + "HIHHHIHHI", 42, 8, 1, 0x112,
                                         3, 1, value, 0, 0))


def orientation_cases() -> list:
    """(name, bytes, stored samples as cv2 returns them unoriented, read
    mode, orientation): PNGs with an eXIf chunk (before or after IDAT,
    both byte orders, a 16-bit depth map under IMREAD_ANYDEPTH) and
    lossless WebPs (VP8X with the EXIF flag) at orientations 0-9."""
    images, depths = render_sequence(SEED + 27, 1, 60, 80, TUM_FR1, 0.02,
                                     0.004)[:2]
    img = images[0]
    d16 = np.clip(np.rint(depths[0] * 5000.0), 0, 65535).astype(np.uint16)
    png, dpng = encode_png(img), encode_png(d16)
    vp8l = webp.encode_webp_lossless(img)[12:]
    vp8x = b"VP8X" + struct.pack("<I", 10) + struct.pack("<I", 8) + \
        (79).to_bytes(3, "little") + (59).to_bytes(3, "little")
    cases = []
    for o in range(10):
        for order, place in (("II", "before"), ("MM", "after")):
            chunk = _png_chunk(b"eXIf", _exif_block(o, order))
            at = 33 if place == "before" else len(png) - 12
            cases.append((f"PNG {order} {place} IDAT {o}",
                          png[:at] + chunk + png[at:], img, False, o))
        chunk = _png_chunk(b"eXIf", _exif_block(o, "MM"))
        cases.append((f"PNG 16-bit depth {o}", dpng[:33] + chunk + dpng[33:],
                      d16, True, o))
        block = _exif_block(o, "II")
        body = b"WEBP" + vp8x + vp8l + b"EXIF" + struct.pack(
            "<I", len(block)) + block
        cases.append((f"WebP {o}", b"RIFF" + struct.pack("<I", len(body))
                      + body, img, False, o))
    return cases


# EXIF orientation 2-8 applied to stored samples ``a`` ([H, W] or
# [H, W, C]), written out here apart from the port's own table
ORIENTED = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1],
            4: lambda a: a[::-1], 5: lambda a: a.swapaxes(0, 1),
            6: lambda a: a.swapaxes(0, 1)[:, ::-1],
            7: lambda a: a.swapaxes(0, 1)[::-1, ::-1],
            8: lambda a: a.swapaxes(0, 1)[::-1]}


def phase_orientation(root: Path) -> dict:
    """Each of :func:`orientation_cases` reads, in its mode, as its stored
    samples flipped and transposed by hand (``ORIENTED``; 0, 1 and 9 as
    stored)."""
    path = root / "oriented"
    n = 0
    for name, data, stored, anydepth, o in orientation_cases():
        path.write_bytes(data)
        want = ORIENTED.get(o, lambda a: a)(stored)
        got = imread(str(path), anydepth=anydepth)
        check(got.shape == want.shape and np.array_equal(got, want),
              f"phase 19: {name} is not oriented as cv2.imread orients it")
        n += 1
    return dict(files=n, ms=host_ms(lambda _: imread(str(path)), range(5)))


# phase 20's committed frames, which phase 19 leaves to it
# phase 21's committed files: the 480 x 640 frames that restore the loop,
# and 4:2:2, BT.709, limited-range and restored 48 x 64 colour
LR_480X640 = ("cv2_lr_q30_s2_480x640.avif", "cv2_lr_q60_s2_480x640.avif")
YUV_21 = ("pillow_c422.avif", "port_c420_bt709.avif", "pillow_limited.avif",
          "cv2_lossy_lr_s0.avif")
PHASE_21_FILES = LR_480X640 + YUV_21
# phase 22's committed files: film grain, grids, a sequence, scaled frames
GRAIN_22 = ("pillow_grain_v1_420.avif", "pillow_grain_v10_444.avif",
            "pillow_grain_v16_400.avif", "port_grain_c10.avif",
            "port_grain_g12.avif")
PHASE_22_FILES = GRAIN_22 + ("port_grid_1x2.avif", "port_grid_2x2_alpha.avif",
                             "pillow_avis.avif", "port_scaled_down.avif",
                             "port_scaled_up_g12.avif")
LOSSY_480X640 = ("cv2_lossy_q95_480x640.avif", "cv2_lossy_q50_480x640.avif",
                 "cv2_lossy_c10_q80_480x640.avif")
# phase 23's committed files: intra block copy in lossless 4:2:0 / 4:2:2
# and in lossy frames, segmentation, superres, items of several frames
IBC_23 = ("pillow_screen_c420_s2.avif", "pillow_screen_c422_s2.avif",
          "cv2_page_q95_s2.avif", "cv2_page_c_q80_s2.avif",
          "cv2_page_c10_q95_s2.avif", "pillow_screen_c444_q90.avif",
          "port_intrabc_c422_12.avif")
SUPERRES_23 = ("port_superres_lr_tiles.avif", "port_superres_narrow.avif")
PHASE_23_FILES = IBC_23 + SUPERRES_23 + (
    "port_seg_lossless.avif", "port_seg_skip_g12.avif",
    "port_frames_existing.avif", "port_frames_sizes.avif",
    "port_two_frames.avif")


def avif_queued(name: str) -> bool:
    hashes = json.loads((AVIF_FIXTURES / "hashes.json").read_text())
    return bool(hashes[name].get("queued"))


def formats_19_cases() -> list:
    """:func:`format_cases`' tuples of a rendered 480 x 640 frame through
    the port's lossless AVIF writer and of its depth's top 12 bits as a
    12-bit gray AVIF."""
    images, depths = render_sequence(SEED + 28, 1, 480, 640, TUM_FR1, 0.02,
                                     0.004)[:2]
    img = images[0]
    d16 = np.clip(np.rint(depths[0] * 5000.0), 0, 65535).astype(np.uint16)
    top = np.minimum(d16 >> 4, 4095).astype(np.uint16)
    return [("AVIF lossless colour", avif.encode_avif(img), False, img,
             None),
            ("AVIF 12-bit depth", avif.encode_avif(top, 12), True, top,
             None)]


def refusals_19() -> list:
    """Files OpenCV refuses: an AVIF cut inside its tile, one with three
    bytes of its tile data changed (libaom's trailing bit check), one
    whose irot is not marked essential, a gray image with alpha (OpenCV's
    reader takes no two-channel image), one whose sequence header's
    trailing bits are wrong (libaom's check)."""
    img = render_sequence(SEED + 28, 1, 48, 64, TUM_FR1, 0.02, 0.004)[0][0]
    data = avif.encode_avif(img)
    damaged = bytearray(data)
    for k in (40, 300, 900):
        damaged[-k] ^= 0x24
    trailing = bytearray(data)
    # the writer's sequence header OBU: 0x0a, its size 11, 11 bytes
    trailing[data.index(b"mdat") + 4 + 12] |= 1
    gray = img[..., 1].copy()
    return [("AVIF cut", data[:-500]), ("AVIF damaged", bytes(damaged)),
            ("AVIF irot not essential", avif.encode_avif(
                img, extra_props=[avif._box(b"irot", bytes([1]))])),
            ("AVIF gray with alpha", avif.encode_avif(gray, alpha=gray)),
            ("AVIF sequence header trailing bits", bytes(trailing))]


def phase_19(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        report = dict(orientation=phase_orientation(root))
        report["codecs"] = phase_format_codecs(root, formats_19_cases(), 19)
        report["committed_avif"] = phase_committed(
            AVIF_FIXTURES, 19, keep=lambda name: not avif_queued(name) and
            name not in LOSSY_480X640 + PHASE_21_FILES + PHASE_22_FILES +
            PHASE_23_FILES + PHASE_24_FILES)
        queued = {}
        for name, want in json.loads(
                (AVIF_FIXTURES / "hashes.json").read_text()).items():
            if not want.get("queued"):
                continue
            for mode in (False, True):
                try:
                    imread(str(AVIF_FIXTURES / name), anydepth=mode)
                    fail(f"phase 19: {name} read; it is queued")
                except NotImplementedError as e:
                    check(want["queued"] in str(e),
                          f"phase 19: {name} refused as {e}")
            queued[name] = want["queued"]
        report["queued"] = queued
        report["refused"] = refusals(root, refusals_19(), 19)
        runs = phase_format_track(
            dev, kernels, root / "tum", n_frames=PHASE_19_FRAMES,
            seed=SEED + 29, phase=19,
            pairs=(("avif", "12bit-avif"), ("png", "12bit-avif-png")),
            key="launches_formats_19")
    avif_run, png_run = runs.values()
    for name in ("k1_launches_track", "k2_launches_track"):
        check(avif_run[name] == png_run[name],
              f"phase 19: {name} {avif_run[name]} (AVIF + 12-bit AVIF) != "
              f"{png_run[name]} (PNG + 16-bit PNG)")
    report["feed_ratio"] = avif_run["feed_ms"] / png_run["feed_ms"]
    report["tum"] = runs
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_19(report: dict) -> None:
    codecs = ", ".join(f"{k} {v['decode_ms']:.2f}" for k, v in
                       report["codecs"].items())
    committed = [v["decode_ms"] for v in report["committed_avif"].values()
                 if not v.get("refused")]
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame, {v['keyframes']} "
        f"keyframes, {v['ms_per_keyframe_median']:.1f} ms per keyframe "
        f"update, K1 {v['k1_launches']} / K2 {v['k2_launches']} launches "
        f"(track {v['k1_launches_track']} / {v['k2_launches_track']})"
        for k, v in report["tum"].items())
    print(f"phase 19: {report['orientation']['files']} PNG / WebP files "
          f"oriented as cv2.imread orients them; host decode ms of 480 x "
          f"640 frames: {codecs}; {len(committed)} committed AVIF files "
          f"equal to cv2's hashes ({min(committed):.2f}-"
          f"{max(committed):.2f} ms), {len(report['queued'])} queued, "
          f"{len(report['refused'])} refusals; TUM RGB-D at 384 x 512, "
          f"equal frames and depth from both streams: {tum}; AVIF / PNG "
          f"feed {report['feed_ratio']:.3f}; {report['seconds']:.0f} s")


# -- phase 20: lossy AVIF ------------------------------------------------

PHASE_20_FRAMES = 16


def avif_planes_of(data: bytes) -> list:
    """The AV1 planes of an AVIF file's colour item."""
    box = avif.parse(data)
    return avif.av1_planes(avif._payload(data, box, box["color"]))[0]


def phase_20_writer(seq: Path, seed: int) -> dict:
    """Each colour frame of the lossy AVIF sequence is the writer's file of
    its rendered frame, and its AV1 planes equal the writer's own
    reconstruction (the decoder's inverse transforms and in-loop filters
    against the writer's)."""
    images = render_sequence(seed, PHASE_20_FRAMES, 480, 640, TUM_FR1,
                             0.02, 0.004)[0]
    files = sorted((seq / "rgb").iterdir())
    check(len(files) == PHASE_20_FRAMES, "phase 20: the sequence's frames")
    t_start = time.perf_counter()
    sizes = []
    for img, path in zip(images, files):
        data, rec = avif.encode_avif(img, lossy=LOSSY_AVIF, recon=True)
        check(path.read_bytes() == data,
              f"phase 20: {path.name} is not the writer's file")
        got = avif_planes_of(data)
        check(len(got) == 3 and all(np.array_equal(a, b) for a, b in
                                    zip(got, rec)),
              f"phase 20: {path.name} does not decode to the writer's "
              "reconstruction")
        sizes.append(len(data))
    return dict(frames=len(files), bytes_median=statistics.median(sizes),
                seconds=time.perf_counter() - t_start)


def phase_20(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    report = dict(committed=phase_committed(
        AVIF_FIXTURES, 20, keep=lambda name: name in LOSSY_480X640))
    check(len(report["committed"]) == len(LOSSY_480X640),
          "phase 20: the committed 480 x 640 frames")
    refusals_21 = {}
    for name, want in json.loads(
            (AVIF_FIXTURES / "hashes.json").read_text()).items():
        if not want.get("queued"):
            continue
        try:
            imread(str(AVIF_FIXTURES / name))
            fail(f"phase 20: {name} read; it is queued")
        except NotImplementedError as e:
            check(want["queued"] in str(e), f"phase 20: {name} refused as "
                  f"{e}")
            refusals_21[name] = str(e).split(": ", 1)[-1]
    report["refusals_21"] = refusals_21
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        runs = phase_format_track(
            dev, kernels, root / "tum", n_frames=PHASE_20_FRAMES,
            seed=SEED + 30, phase=20,
            pairs=(("lossy-avif", "12bit-avif"),
                   ("lossy-avif-png", "12bit-avif-png")),
            key="launches_formats_20")
        report["writer"] = phase_20_writer(
            root / "tum" / "lossy-avif_12bit-avif" /
            "rgbd_dataset_freiburg1_desk", SEED + 30)
    avif_run, png_run = runs.values()
    for name in ("k1_launches_track", "k2_launches_track"):
        check(avif_run[name] == png_run[name],
              f"phase 20: {name} {avif_run[name]} (lossy AVIF + 12-bit "
              f"AVIF) != {png_run[name]} (PNG + 16-bit PNG)")
    report["feed_ratio"] = avif_run["feed_ms"] / png_run["feed_ms"]
    report["tum"] = runs
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_20(report: dict) -> None:
    committed = ", ".join(f"{k} {v['decode_ms']:.2f} ms" for k, v in
                          report["committed"].items())
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame, {v['keyframes']} "
        f"keyframes, K1 {v['k1_launches']} / K2 {v['k2_launches']} "
        f"launches (track {v['k1_launches_track']} / "
        f"{v['k2_launches_track']})" for k, v in report["tum"].items())
    refusals = "; ".join(f"{k}: {v}" for k, v in
                         report["refusals_21"].items())
    print(f"phase 20: committed 480 x 640 lossy AVIF frames equal to cv2's "
          f"hashes, host decode {committed}; {report['writer']['frames']} "
          f"writer frames decode to its reconstruction; TUM RGB-D at 384 x "
          f"512, equal frames and depth from both streams: {tum}; lossy "
          f"AVIF / PNG feed {report['feed_ratio']:.3f}; refused for a later "
          f"reader: {refusals}; {report['seconds']:.0f} s")


# -- phase 21: AVIF loop restoration, other YUV to RGB paths ------------

PHASE_21_FRAMES = 16


def lr_units(data: bytes) -> tuple:
    """(unit counts by plane and type, restoration ms) of an AVIF file's
    colour item, decoded by the host."""
    box = avif.parse(data)
    return avif.lr_stats(avif._payload(data, box, box["color"]))


def phase_21_restoration() -> dict:
    """The committed 480 x 640 frames that restore: cv2.imread's hashes in
    both modes, the host's median decode ms, and the median ms of the
    decoder's restoration filter (10 decodes each) with the units used."""
    out = phase_committed(AVIF_FIXTURES, 21,
                          keep=lambda name: name in LR_480X640)
    check(len(out) == len(LR_480X640), "phase 21: the committed frames")
    for name in LR_480X640:
        data = (AVIF_FIXTURES / name).read_bytes()
        runs = [lr_units(data) for _ in range(10)]
        counts = runs[0][0]
        check(int(counts[:, 1:].sum()) > 0,
              f"phase 21: {name} uses no restoration unit")
        out[name]["restoration_ms"] = statistics.median(r[1] for r in runs)
        out[name]["units"] = counts.tolist()
    return out


def phase_21_writer(seq: Path, seed: int) -> dict:
    """Each colour frame of the restored AVIF sequence is the writer's file
    of its rendered frame, its AV1 planes equal the writer's own
    reconstruction (the decoder's restoration against the writer's), and
    its luma takes Wiener units, its chroma self-guided ones."""
    images = render_sequence(seed, PHASE_21_FRAMES, 480, 640, TUM_FR1,
                             0.02, 0.004)[0]
    files = sorted((seq / "rgb").iterdir())
    check(len(files) == PHASE_21_FRAMES, "phase 21: the sequence's frames")
    t_start = time.perf_counter()
    sizes, lr_ms = [], []
    for img, path in zip(images, files):
        data, rec = avif.encode_avif(img, lossy=LR_AVIF, recon=True)
        check(path.read_bytes() == data,
              f"phase 21: {path.name} is not the writer's file")
        got = avif_planes_of(data)
        check(len(got) == 3 and all(np.array_equal(a, b) for a, b in
                                    zip(got, rec)),
              f"phase 21: {path.name} does not decode to the writer's "
              "reconstruction")
        counts, ms = lr_units(data)
        check(counts[0, 1] > 0 and counts[1, 2] > 0 and counts[2, 2] > 0,
              f"phase 21: {path.name} units {counts.tolist()}")
        sizes.append(len(data))
        lr_ms.append(ms)
    return dict(frames=len(files), bytes_median=statistics.median(sizes),
                restoration_ms_median=statistics.median(lr_ms),
                seconds=time.perf_counter() - t_start)


def phase_21(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    report = dict(restoration=phase_21_restoration())
    report["yuv"] = phase_committed(AVIF_FIXTURES, 21,
                                    keep=lambda name: name in YUV_21)
    check(len(report["yuv"]) == len(YUV_21), "phase 21: the committed "
          "4:2:2, BT.709 and limited-range files")
    slice_22 = {}
    for name, want in json.loads(
            (AVIF_FIXTURES / "hashes.json").read_text()).items():
        if not want.get("queued"):
            continue
        try:
            imread(str(AVIF_FIXTURES / name))
            fail(f"phase 21: {name} read; it is queued")
        except NotImplementedError as e:
            check(want["queued"] in str(e), f"phase 21: {name} refused as "
                  f"{e}")
            slice_22[name] = str(e).split(": ", 1)[-1]
    report["slice_22"] = slice_22
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        runs = phase_format_track(
            dev, kernels, root / "tum", n_frames=PHASE_21_FRAMES,
            seed=SEED + 31, phase=21,
            pairs=(("lr-avif", "12bit-avif"),
                   ("lr-avif-png", "12bit-avif-png")),
            key="launches_formats_21")
        report["writer"] = phase_21_writer(
            root / "tum" / "lr-avif_12bit-avif" /
            "rgbd_dataset_freiburg1_desk", SEED + 31)
    avif_run, png_run = runs.values()
    for name in ("k1_launches_track", "k2_launches_track"):
        check(avif_run[name] == png_run[name],
              f"phase 21: {name} {avif_run[name]} (restored AVIF + 12-bit "
              f"AVIF) != {png_run[name]} (PNG + 16-bit PNG)")
    report["feed_ratio"] = avif_run["feed_ms"] / png_run["feed_ms"]
    report["tum"] = runs
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_21(report: dict) -> None:
    restored = ", ".join(
        f"{k} {v['decode_ms']:.2f} ms ({v['restoration_ms']:.2f} in "
        f"restoration)" for k, v in report["restoration"].items())
    yuv = ", ".join(f"{k} {v['decode_ms']:.2f} ms" for k, v in
                    report["yuv"].items())
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame, {v['keyframes']} "
        f"keyframes, K1 {v['k1_launches']} / K2 {v['k2_launches']} "
        f"launches (track {v['k1_launches_track']} / "
        f"{v['k2_launches_track']})" for k, v in report["tum"].items())
    refusals = "; ".join(f"{k}: {v}" for k, v in report["slice_22"].items())
    writer = report["writer"]
    print(f"phase 21: committed 480 x 640 AVIF frames with loop restoration "
          f"equal to cv2's hashes, host decode {restored}; 4:2:2, BT.709 "
          f"and limited-range files equal to cv2's hashes: {yuv}; "
          f"{writer['frames']} restored writer frames decode to its "
          f"reconstruction ({writer['restoration_ms_median']:.2f} ms in "
          f"restoration per frame); TUM RGB-D at 384 x 512, equal frames "
          f"and depth from both streams: {tum}; restored AVIF / PNG feed "
          f"{report['feed_ratio']:.3f}; refused for slice 22: {refusals}; "
          f"{report['seconds']:.0f} s")


# -- phase 22: AVIF film grain, grids, sequences, scaled frames ---------

PHASE_22_FRAMES = 16


def grain_ms(data: bytes) -> tuple:
    """(ms of the AV1 decode, ms of adding its film grain) of an AVIF
    file's colour item, decoded by the host."""
    box = avif.parse(data)
    return avif.grain_ms(avif._payload(data, box, box["color"]))


def phase_22_committed() -> dict:
    """The committed slice-22 files against cv2.imread's hashes in both
    modes, the host's median decode ms; for the grain files the median ms
    of the frame's AV1 decode and of its grain (10 decodes each)."""
    out = phase_committed(AVIF_FIXTURES, 22,
                          keep=lambda name: name in PHASE_22_FILES)
    check(len(out) == len(PHASE_22_FILES), "phase 22: the committed files")
    for name in GRAIN_22:
        runs = [grain_ms((AVIF_FIXTURES / name).read_bytes())
                for _ in range(10)]
        check(all(g > 0 for _, g in runs), f"phase 22: {name} adds no grain")
        out[name]["av1_ms"] = statistics.median(r[0] for r in runs)
        out[name]["grain_ms"] = statistics.median(r[1] for r in runs)
    return out


def phase_22_writer(seq: Path, seed: int) -> dict:
    """Each colour frame of the grain sequence is the writer's lossy file
    of its rendered frame with ``GRAIN_AVIF``'s grain (its parameters as
    the test vector's, the seed's), each depth frame carries
    ``GRAIN_DEPTH``'s; the host's median ms of the AV1 decode and of the
    grain of a 480 x 640 colour frame and of a depth frame."""
    images = render_sequence(seed, PHASE_22_FRAMES, 480, 640, TUM_FR1,
                             0.02, 0.004)[0]
    files = sorted((seq / "rgb").iterdir())
    depths = sorted((seq / "depth").iterdir())
    check(len(files) == len(depths) == PHASE_22_FRAMES,
          "phase 22: the sequence's frames")
    want = avif.grain_vector(GRAIN_AVIF)
    want_depth = avif.grain_vector(GRAIN_DEPTH)
    t_start = time.perf_counter()
    colour, depth = [], []
    for img, path, dpath in zip(images, files, depths):
        data = path.read_bytes()
        check(data == avif.encode_avif(img, lossy=LOSSY_AVIF,
                                       grain=GRAIN_AVIF),
              f"phase 22: {path.name} is not the writer's file")
        box = avif.parse(data)
        got = avif.grain_params(avif._payload(data, box, box["color"]))
        check(np.array_equal(got[:158], want[:158]) and got[-1] == want[-1],
              f"phase 22: {path.name}'s grain is not test vector "
              f"{GRAIN_AVIF}")
        ddata = dpath.read_bytes()
        dbox = avif.parse(ddata)
        check(avif.grain_params(avif._payload(ddata, dbox, dbox["color"]))[
            74] == want_depth[74], f"phase 22: {dpath.name}'s grain")
        colour.append(grain_ms(data))
        depth.append(grain_ms(ddata))
    return dict(frames=len(files),
                av1_ms_median=statistics.median(c[0] for c in colour),
                grain_ms_median=statistics.median(c[1] for c in colour),
                depth_av1_ms_median=statistics.median(d[0] for d in depth),
                depth_grain_ms_median=statistics.median(d[1] for d in depth),
                seconds=time.perf_counter() - t_start)


def phase_22(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    report = dict(committed=phase_22_committed())
    later = {}
    for name, want in json.loads(
            (AVIF_FIXTURES / "hashes.json").read_text()).items():
        if not want.get("queued"):
            continue
        for mode in (False, True):
            try:
                imread(str(AVIF_FIXTURES / name), anydepth=mode)
                fail(f"phase 22: {name} read; it is queued")
            except NotImplementedError as e:
                check(want["queued"] in str(e), f"phase 22: {name} refused "
                      f"as {e}")
                later[name] = str(e).split(": ", 1)[-1]
    report["later"] = later
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        runs = phase_format_track(
            dev, kernels, root / "tum", n_frames=PHASE_22_FRAMES,
            seed=SEED + 32, phase=22,
            pairs=(("grain-avif", "12bit-grain-avif"),
                   ("grain-avif-png", "12bit-grain-avif-png")),
            key="launches_formats_22")
        report["writer"] = phase_22_writer(
            root / "tum" / "grain-avif_12bit-grain-avif" /
            "rgbd_dataset_freiburg1_desk", SEED + 32)
    avif_run, png_run = runs.values()
    for name in ("k1_launches_track", "k2_launches_track"):
        check(avif_run[name] == png_run[name],
              f"phase 22: {name} {avif_run[name]} (grain AVIF + 12-bit "
              f"grain AVIF) != {png_run[name]} (PNG + 16-bit PNG)")
    report["feed_ratio"] = avif_run["feed_ms"] / png_run["feed_ms"]
    report["tum"] = runs
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_22(report: dict) -> None:
    committed = report["committed"]
    grain = ", ".join(f"{k} {v['decode_ms']:.2f} ms ({v['grain_ms']:.3f} "
                      f"grain)" for k, v in committed.items()
                      if k in GRAIN_22)
    others = ", ".join(f"{k} {v['decode_ms']:.2f} ms" for k, v in
                       committed.items() if k not in GRAIN_22)
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame, {v['keyframes']} "
        f"keyframes, K1 {v['k1_launches']} / K2 {v['k2_launches']} "
        f"launches (track {v['k1_launches_track']} / "
        f"{v['k2_launches_track']})" for k, v in report["tum"].items())
    writer = report["writer"]
    later = "; ".join(f"{k}: {v}" for k, v in report["later"].items())
    print(f"phase 22: committed AVIF files equal to cv2's hashes, host "
          f"decode {grain}; {others}; {writer['frames']} writer grain "
          f"frames at 480 x 640: AV1 decode {writer['av1_ms_median']:.2f} "
          f"ms, grain {writer['grain_ms_median']:.2f} ms per colour frame, "
          f"{writer['depth_av1_ms_median']:.2f} / "
          f"{writer['depth_grain_ms_median']:.2f} ms per 12-bit depth "
          f"frame; TUM RGB-D at 384 x 512, equal frames and depth from both "
          f"streams: {tum}; grain AVIF / PNG feed "
          f"{report['feed_ratio']:.3f}; refused for a later reader: "
          f"{later}; {report['seconds']:.0f} s")


# -- phase 23: AVIF intra block copy, segmentation, superres, frames ----

PHASE_23_FRAMES = 16


def superres_ms(data: bytes) -> tuple:
    """(ms of the AV1 decode, ms of its superres upscaling) of an AVIF
    file's colour item, decoded by the host."""
    box = avif.parse(data)
    return avif.superres_ms(avif._payload(data, box, box["color"]))


def phase_23_committed() -> dict:
    """The committed slice-23 files against cv2.imread's hashes in both
    modes, the host's median decode ms; for the superres files the median
    ms of the frame's AV1 decode and of its upscaling (10 decodes
    each)."""
    out = phase_committed(AVIF_FIXTURES, 23,
                          keep=lambda name: name in PHASE_23_FILES)
    check(len(out) == len(PHASE_23_FILES), "phase 23: the committed files")
    for name in SUPERRES_23:
        runs = [superres_ms((AVIF_FIXTURES / name).read_bytes())
                for _ in range(10)]
        out[name]["av1_ms"] = statistics.median(r[0] for r in runs)
        out[name]["upscale_ms"] = statistics.median(r[1] for r in runs)
    check(out[SUPERRES_23[0]]["upscale_ms"] > 0,
          "phase 23: the superres file is not upscaled")
    return out


def phase_23_frames() -> dict:
    """A rendered 480 x 640 frame through the writer with superres (8 /
    12, two tile columns) and loop restoration, and one with segmentation
    (``fixtures.TOOLS_AVIF``'s segments: one lossless): each decodes to
    the writer's reconstruction; the host's median ms of 10 decodes and of
    the upscale."""
    img = render_sequence(SEED + 33, 1, 480, 640, TUM_FR1, 0.02,
                          0.004)[0][0]
    cases = {"superres": dict(lossy=LR_AVIF, superres=12, tile_cols_log2=1),
             "segmented": dict(lossy=TOOLS_AVIF)}
    out = {}
    for name, kw in cases.items():
        data, rec = avif.encode_avif(img, recon=True, **kw)
        got = avif_planes_of(data)
        check(len(got) == 3 and all(np.array_equal(a, b) for a, b in
                                    zip(got, rec)),
              f"phase 23: the {name} frame does not decode to the writer's "
              "reconstruction")
        runs = [superres_ms(data) for _ in range(10)]
        out[name] = dict(bytes=len(data),
                         decode_ms=statistics.median(r[0] for r in runs),
                         upscale_ms=statistics.median(r[1] for r in runs))
    check(out["superres"]["upscale_ms"] > 0 and
          out["segmented"]["upscale_ms"] == 0, "phase 23: upscale times")
    return out


def phase_23_writer(seq: Path, seed: int) -> dict:
    """Each colour frame of the sequence is the writer's file of its
    rendered frame with ``TOOLS_AVIF`` and superres, each depth frame an
    item of three AV1 frames; the host's median ms of a colour frame's
    decode and upscale and of a depth item's decode."""
    images = render_sequence(seed, PHASE_23_FRAMES, 480, 640, TUM_FR1,
                             0.02, 0.004)[0]
    files = sorted((seq / "rgb").iterdir())
    depths = sorted((seq / "depth").iterdir())
    check(len(files) == len(depths) == PHASE_23_FRAMES,
          "phase 23: the sequence's frames")
    t_start = time.perf_counter()
    colour, depth = [], []
    for img, path, dpath in zip(images, files, depths):
        data = path.read_bytes()
        check(data == avif.encode_avif(img, lossy=dict(
            TOOLS_AVIF, lr=LR_AVIF["lr"]), superres=12, tile_cols_log2=1),
              f"phase 23: {path.name} is not the writer's file")
        ddata = dpath.read_bytes()
        dbox = avif.parse(ddata)
        kinds = [t for t, _ in avif.split_obus(avif._payload(
            ddata, dbox, dbox["color"]))]
        check(kinds == [1, 6, 6, 3], f"phase 23: {dpath.name} holds OBUs "
              f"{kinds}, not three frames")
        colour.append(superres_ms(data))
        depth.append(superres_ms(ddata)[0])
    return dict(frames=len(files),
                decode_ms_median=statistics.median(c[0] for c in colour),
                upscale_ms_median=statistics.median(c[1] for c in colour),
                depth_decode_ms_median=statistics.median(depth),
                seconds=time.perf_counter() - t_start)


def phase_23(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    report = dict(committed=phase_23_committed(), frames=phase_23_frames())
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        runs = phase_format_track(
            dev, kernels, root / "tum", n_frames=PHASE_23_FRAMES,
            seed=SEED + 34, phase=23,
            pairs=(("tools-avif", "12bit-frames-avif"),
                   ("tools-avif-png", "12bit-frames-avif-png")),
            key="launches_formats_23")
        report["writer"] = phase_23_writer(
            root / "tum" / "tools-avif_12bit-frames-avif" /
            "rgbd_dataset_freiburg1_desk", SEED + 34)
    avif_run, png_run = runs.values()
    for name in ("k1_launches_track", "k2_launches_track"):
        check(avif_run[name] == png_run[name],
              f"phase 23: {name} {avif_run[name]} (tools AVIF + 12-bit "
              f"frames AVIF) != {png_run[name]} (PNG + 16-bit PNG)")
    report["feed_ratio"] = avif_run["feed_ms"] / png_run["feed_ms"]
    report["tum"] = runs
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_23(report: dict) -> None:
    committed = report["committed"]
    files = ", ".join(
        f"{k} {v['decode_ms']:.2f} ms" + (f" ({v['upscale_ms']:.3f} "
                                          "upscale)" if k in SUPERRES_23
                                          else "")
        for k, v in committed.items())
    frames = ", ".join(f"{k} {v['decode_ms']:.2f} ms ({v['upscale_ms']:.3f} "
                       f"upscale)" for k, v in report["frames"].items())
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame, {v['keyframes']} "
        f"keyframes, K1 {v['k1_launches']} / K2 {v['k2_launches']} "
        f"launches (track {v['k1_launches_track']} / "
        f"{v['k2_launches_track']})" for k, v in report["tum"].items())
    writer = report["writer"]
    print(f"phase 23: committed AVIF files equal to cv2's hashes, host "
          f"decode {files}; writer frames at 480 x 640: {frames}; "
          f"{writer['frames']} writer sequence frames: decode "
          f"{writer['decode_ms_median']:.2f} ms (upscale "
          f"{writer['upscale_ms_median']:.2f}) per colour frame, "
          f"{writer['depth_decode_ms_median']:.2f} ms per three-frame depth "
          f"item; TUM RGB-D at 384 x 512, equal frames and depth from both "
          f"streams: {tum}; tools AVIF / PNG feed "
          f"{report['feed_ratio']:.3f}; {report['seconds']:.0f} s")


# -- phase 24: AV1 inter frames (layered AVIF items) ----------------------

# the committed layered items (libavif's progressive layers through cv2's
# libavif, scripts/make_avif_fixtures_torch.py), and the rendered TUM fr1
# frames of its 480 x 640 ones: seed 24 (LAYERED_TUM_SEED there)
PHASE_24_FILES = tuple(sorted(p.name for p in AVIF_FIXTURES.glob(
    "layered_*.avif")))
LAYERED_TUM = tuple(n for n in PHASE_24_FILES if "480x640" in n)
LAYERED_TUM_SEED = 24
# the sequence: the eight frames there and back
PHASE_24_ORDER = tuple(range(8)) + tuple(range(7, -1, -1))


def inter_ms(data: bytes) -> tuple:
    """(tool counts, ms of the AV1 decode, ms of its inter prediction) of
    an AVIF file's colour item, decoded by the host."""
    box = avif.parse(data)
    return avif.inter_stats(avif._payload(data, box, box["color"]))


def phase_24_committed() -> dict:
    """The committed layered items against cv2.imread's hashes in both
    modes (the host's median decode ms); for each 480 x 640 frame the
    median ms of 10 AV1 decodes and of their inter prediction, and its
    blocks by tool."""
    out = phase_committed(AVIF_FIXTURES, 24,
                          keep=lambda name: name in PHASE_24_FILES)
    check(len(out) == len(PHASE_24_FILES) and len(LAYERED_TUM) == 8,
          "phase 24: the committed files")
    for name in LAYERED_TUM:
        runs = [inter_ms((AVIF_FIXTURES / name).read_bytes())
                for _ in range(10)]
        out[name]["tools"] = runs[0][0]
        out[name]["av1_ms"] = statistics.median(r[1] for r in runs)
        out[name]["inter_ms"] = statistics.median(r[2] for r in runs)
        check(runs[0][0]["inter"] > 0 and runs[0][0]["scaled"] > 0,
              f"phase 24: {name} has no inter blocks from its scaled base")
    return out


def phase_24_writer(seq: Path, color: str, depth: str) -> None:
    """The TUM sequence of the committed layered frames there and back,
    or (``*-png``) of the PNG of what they read back as, with their
    rendered depth and poses."""
    colour = [("avif", (AVIF_FIXTURES / n).read_bytes()) for n in LAYERED_TUM]
    write_tum_with_colour(str(seq), colour, LAYERED_TUM_SEED,
                          order=PHASE_24_ORDER, png=color.endswith("-png"))


def phase_24(dev, kernels: dict) -> dict:
    t_start = time.perf_counter()
    report = dict(committed=phase_24_committed())
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        runs = phase_format_track(
            dev, kernels, root / "tum", n_frames=len(PHASE_24_ORDER),
            phase=24, pairs=(("layered-avif", "png"),
                             ("layered-avif-png", "png")),
            key="launches_formats_24", writer=phase_24_writer)
    avif_run, png_run = runs.values()
    for name in ("k1_launches_track", "k2_launches_track"):
        check(avif_run[name] == png_run[name],
              f"phase 24: {name} {avif_run[name]} (layered AVIF) != "
              f"{png_run[name]} (PNG)")
    report["feed_ratio"] = avif_run["feed_ms"] / png_run["feed_ms"]
    report["tum"] = runs
    report["seconds"] = time.perf_counter() - t_start
    return report


def print_phase_24(report: dict, smi: str) -> None:
    frames = [v for k, v in report["committed"].items() if k in LAYERED_TUM]
    av1 = statistics.median(v["av1_ms"] for v in frames)
    inter = statistics.median(v["inter_ms"] for v in frames)
    share = statistics.median(v["inter_ms"] / v["av1_ms"] for v in frames)
    small = [v["decode_ms"] for k, v in report["committed"].items()
             if k not in LAYERED_TUM and not v.get("refused")]
    tum = "; ".join(
        f"{k}: fed {v['feed_ms']:.2f} ms per frame, {v['keyframes']} "
        f"keyframes, K1 {v['k1_launches']} / K2 {v['k2_launches']} "
        f"launches (track {v['k1_launches_track']} / "
        f"{v['k2_launches_track']})" for k, v in report["tum"].items())
    print(f"phase 24 ({smi}; host times on this machine's CPU): "
          f"{len(report['committed'])} committed layered AVIF items equal "
          f"to cv2's hashes or refused as cv2 refuses them "
          f"({min(small):.2f}-{max(small):.2f} ms); 480 x 640 layered frames "
          f"(2 layers, half-size base): AV1 decode {av1:.2f} ms, inter "
          f"prediction {inter:.2f} ms ({100 * share:.1f} % of the decode), "
          f"median of 8; TUM RGB-D at 384 x 512, equal frames and depth "
          f"from both streams: {tum}; layered AVIF / PNG feed "
          f"{report['feed_ratio']:.3f}; {report['seconds']:.0f} s")


def main():
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke run needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    t_start = time.perf_counter()
    kernels = phase_kernels(dev)
    phase_small_track(dev, kernels)
    small_train = phase_small_train(dev)
    cfg = SLAMConfig().replace(filter_thresh=0.0, keyframe_thresh=0.0)
    report, slam, frames = phase_full_track(dev, kernels, cfg, 24, 4)
    print(f"phase 3: full-width track() ({cfg.image_size}, bf16): "
          f"{report['keyframes']} keyframes, {report['edges']} edges, K1 "
          f"launches {report['k1_launches']}, K2 launches "
          f"{report['k2_launches']}, poses finite")
    t_helpers = time.perf_counter()
    helpers = frame_graph_helpers(dev, slam)
    helpers["seconds"] = time.perf_counter() - t_helpers
    t_update = time.perf_counter()
    update = update_cuda_vs_cpu(dev, slam)
    update["seconds"] = time.perf_counter() - t_update
    terminate = phase_terminate(slam, frames, kernels)
    del slam, frames
    torch.cuda.empty_cache()
    train = phase_train(dev)
    train["small_cuda_vs_cpu"] = small_train
    torch.cuda.empty_cache()
    t_fp32 = time.perf_counter()
    cfg32 = cfg.replace(warmup=5, volume_dtype="float32",
                        feat_dtype="float32", compute_dtype="float32")
    fp32, slam, _ = phase_full_track(dev, kernels, cfg32, 10, 0)
    del slam
    fp32["seconds"] = time.perf_counter() - t_fp32
    print(f"phase 6: full-width track() ({cfg32.image_size}, fp32): "
          f"{fp32['keyframes']} keyframes, K1 fp32-operand launches "
          f"{fp32['k1_launches']}, K2 launches {fp32['k2_launches']}, "
          f"{fp32['ms_per_keyframe_median']:.1f} ms per keyframe update, "
          f"peak {fp32['peak_memory_gb']:.2f} GB, poses finite")
    torch.cuda.empty_cache()
    group = nccl_group_1()
    try:
        world1 = phase_world_size_1(dev, kernels, group)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            recon = Path(tmp) / "reconstruction.npz"
            export = Path(tmp) / "export"
            entry_points = phase_entry_points(dev, kernels, recon, export)
            torch.cuda.empty_cache()
            gs = phase_gs(dev, recon, export)
        torch.cuda.empty_cache()
        jpeg = phase_jpeg(dev, kernels, helpers)
        torch.cuda.empty_cache()
        oracle = phase_11(dev, group, update)
    finally:
        dist.destroy_process_group()
    print_phase_11(oracle, report["ms_per_keyframe_median"])
    torch.cuda.empty_cache()
    formats = phase_12(dev, kernels)
    print_phase_12(formats)
    torch.cuda.empty_cache()
    formats_13 = phase_13(dev, kernels)
    print_phase_13(formats_13)
    torch.cuda.empty_cache()
    formats_14 = phase_14(dev, kernels)
    print_phase_14(formats_14)
    torch.cuda.empty_cache()
    formats_15 = phase_15(dev, kernels)
    print_phase_15(formats_15)
    torch.cuda.empty_cache()
    formats_16 = phase_16(dev, kernels)
    print_phase_16(formats_16)
    torch.cuda.empty_cache()
    scaling_17 = phase_17(dev, kernels)
    print_phase_17(scaling_17)
    torch.cuda.empty_cache()
    formats_18 = phase_18(dev, kernels)
    print_phase_18(formats_18)
    torch.cuda.empty_cache()
    formats_19 = phase_19(dev, kernels)
    print_phase_19(formats_19)
    torch.cuda.empty_cache()
    formats_20 = phase_20(dev, kernels)
    print_phase_20(formats_20)
    torch.cuda.empty_cache()
    formats_21 = phase_21(dev, kernels)
    print_phase_21(formats_21)
    torch.cuda.empty_cache()
    formats_22 = phase_22(dev, kernels)
    print_phase_22(formats_22)
    torch.cuda.empty_cache()
    formats_23 = phase_23(dev, kernels)
    print_phase_23(formats_23)
    torch.cuda.empty_cache()
    formats_24 = phase_24(dev, kernels)
    print_phase_24(formats_24, smi.stdout.strip().splitlines()[0])
    # launches on the main path: K1 bf16 and K2 over track() +
    # terminate(), phase 8's entry points, phase 10's JPEG runs, phases
    # 12-16's and 18-24's TUM tracks and phase 17's backend
    # passes, K2 also over phase 7's sharded backend pass, K1 fp32 operands
    # over phase 6's track()
    for name in ("masked_corr_level0_tc", "fused_pyramid_lookup"):
        k = kernels[name]
        k["launches"] = k["launches_track"] + k["launches_terminate"] + \
            k.get("launches_sharded_backend", 0) + \
            k["launches_entry_points"] + k["launches_jpeg"] + \
            k["launches_formats"] + k["launches_arith"] + \
            k["launches_formats_14"] + k["launches_formats_15"] + \
            k["launches_formats_16"] + k["launches_scaling_17"] + \
            k["launches_formats_18"] + k["launches_formats_19"] + \
            k["launches_formats_20"] + k["launches_formats_21"] + \
            k["launches_formats_22"] + k["launches_formats_23"] + \
            k["launches_formats_24"]
    k = kernels["masked_corr_level0_tf32"]
    k["launches"] = k["launches_track_fp32"]
    for k in kernels.values():
        if "launches" not in k:
            k["launches"] = window_lookup.launches
    seconds = time.perf_counter() - t_start
    print(json.dumps({"tracking": report}))
    print(json.dumps({"terminate": terminate}))
    print(json.dumps({"training": train}))
    print(json.dumps({"tracking_fp32": fp32}))
    print(json.dumps({"world_size_1": world1}))
    print(json.dumps({"entry_points": entry_points}))
    print(json.dumps({"gs": gs}))
    print(json.dumps({"jpeg": jpeg}))
    print(json.dumps({"oracle": oracle}))
    print(json.dumps({"formats": formats}))
    print(json.dumps({"formats_13": formats_13}))
    print(json.dumps({"formats_14": formats_14}))
    print(json.dumps({"formats_15": formats_15}))
    print(json.dumps({"formats_16": formats_16}))
    print(json.dumps({"scaling_17": scaling_17}))
    print(json.dumps({"formats_18": formats_18}))
    print(json.dumps({"formats_19": formats_19}))
    print(json.dumps({"formats_20": formats_20}))
    print(json.dumps({"formats_21": formats_21}))
    print(json.dumps({"formats_22": formats_22}))
    print(json.dumps({"formats_23": formats_23}))
    print(json.dumps({"formats_24": formats_24}))
    print(json.dumps({"seconds": seconds}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
