#!/usr/bin/env python
"""Carry libaom's AV1 tables out of OpenCV's own copy of libaom into the
port's host C, as ``lgu_slam_tpu_torch/csrc/host/av1_tables.h``: the tables
the AV1 intra decoder (``av1_decode.c``) and the fixture writer
(``av1_encode.c``) read.

    python scripts/extract_av1_tables_torch.py [--check]

The library is ``opencv_python.libs/libaom-*.so`` beside cv2 (the libaom
that OpenCV's AVIF reader decodes with).  It keeps its ``.symtab``, which
this script parses itself (the ELF section headers, the symbol table and
its string table: no ``nm``), so each table is read by its name, at its
address and of its size; a name that appears twice (a static table in two
objects) must hold the same bytes both times.

libaom stores a CDF inverted (``32768 - cdf``) with one more slot that
counts its adaptations.  The header holds every CDF in the form of the AV1
specification, which ``av1_decode.c`` decodes and adapts: the cumulative
counts of symbols 0 .. N-1, increasing, the last 32768, then the counter
slot (0).  The few CDFs libaom builds into its code instead of a named table
(two-symbol ones, CfL, filter intra, palette modes and sizes, angle deltas,
tx_depth, delta q / lf) are the specification's default tables, written
below; each one of three symbols or more is checked against libaom's
bytes, where it is stored inverted.  The scans are the specification's
(row-major positions; libaom stores coefficients column by column), and
so is the rule of the 2-D coefficient context offsets, checked against
libaom's ``av1_nz_map_ctx_offset_*``.

``--check`` compares the committed header with what the library gives and
exits 1 where they differ.  Needs cv2's wheel (the card machine has none:
the header is committed).
"""

from __future__ import annotations

import argparse
import glob
import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADER = os.path.join(REPO, "lgu_slam_tpu_torch", "csrc", "host",
                      "av1_tables.h")

# (libaom symbol, C name, element type, shape); "cdf" tables are converted
CDFS = [
    ("default_partition_cdf", "partition_cdf", (20, 11)),
    ("default_kf_y_mode_cdf", "kf_y_mode_cdf", (5, 5, 14)),
    ("default_uv_mode_cdf", "uv_mode_cdf", (2, 13, 15)),
    ("default_palette_y_color_index_cdf", "palette_y_color_cdf", (7, 5, 9)),
    ("default_palette_uv_color_index_cdf", "palette_uv_color_cdf",
     (7, 5, 9)),
    ("av1_default_txb_skip_cdfs", "txb_skip_cdf", (4, 5, 13, 3)),
    ("av1_default_eob_multi16_cdfs", "eob_pt16_cdf", (4, 2, 2, 6)),
    ("av1_default_eob_extra_cdfs", "eob_extra_cdf", (4, 5, 2, 9, 3)),
    ("av1_default_dc_sign_cdfs", "dc_sign_cdf", (4, 2, 3, 3)),
    ("av1_default_coeff_base_eob_multi_cdfs", "coeff_base_eob_cdf",
     (4, 5, 2, 4, 4)),
    ("av1_default_coeff_base_multi_cdfs", "coeff_base_cdf",
     (4, 5, 2, 42, 5)),
    ("av1_default_coeff_lps_multi_cdfs", "coeff_br_cdf", (4, 5, 2, 21, 5)),
    ("av1_default_eob_multi32_cdfs", "eob_pt32_cdf", (4, 2, 2, 7)),
    ("av1_default_eob_multi64_cdfs", "eob_pt64_cdf", (4, 2, 2, 8)),
    ("av1_default_eob_multi128_cdfs", "eob_pt128_cdf", (4, 2, 2, 9)),
    ("av1_default_eob_multi256_cdfs", "eob_pt256_cdf", (4, 2, 2, 10)),
    ("av1_default_eob_multi512_cdfs", "eob_pt512_cdf", (4, 2, 2, 11)),
    ("av1_default_eob_multi1024_cdfs", "eob_pt1024_cdf", (4, 2, 2, 12)),
    ("default_intra_ext_tx_cdf", "intra_ext_tx_cdf", (3, 4, 13, 17)),
    ("default_inter_ext_tx_cdf", "inter_ext_tx_cdf", (4, 4, 17)),
]
# the number of symbols of each CDF row where it is not the last axis less
# one: the partition CDFs of 8 x 8 blocks have 4, of 128 x 128 blocks 8;
# a palette of n colours has n; the first uv mode row (CfL not allowed) 13
PLAIN = [
    ("dr_intra_derivative", "dr_intra_derivative", "<i2", "int16_t", (90,)),
    ("av1_filter_intra_taps", "filter_intra_taps", "i1", "int8_t",
     (5, 8, 8)),
    ("smooth_weights", "sm_weights", "u1", "uint8_t", (124,)),
    ("mode_to_angle_map", "mode_to_angle", "u1", "uint8_t", (13,)),
    ("av1_palette_color_index_context_lookup", "palette_color_context",
     "<i4", "int", (9,)),
    ("dc_qlookup_QTX", "dc_qlookup", "<i2", "int16_t", (256,)),
    ("dc_qlookup_10_QTX", "dc_qlookup_10", "<i2", "int16_t", (256,)),
    ("dc_qlookup_12_QTX", "dc_qlookup_12", "<i2", "int16_t", (256,)),
    ("ac_qlookup_QTX", "ac_qlookup", "<i2", "int16_t", (256,)),
    ("ac_qlookup_10_QTX", "ac_qlookup_10", "<i2", "int16_t", (256,)),
    ("ac_qlookup_12_QTX", "ac_qlookup_12", "<i2", "int16_t", (256,)),
    ("av1_ext_tx_inv", "ext_tx_inv", "<i4", "int8_t", (6, 16)),
    ("av1_ext_tx_used", "ext_tx_used", "<i4", "int8_t", (6, 16)),
    ("_intra_mode_to_tx_type.1", "mode_to_txfm", "u1", "uint8_t", (13,)),
    ("av1_sinpi_arr_data", "sinpi_arr", "<i4", "int32_t", (4, 5)),
    ("av1_cospi_arr_data", "cospi_arr", "<i4", "int32_t", (4, 64)),
    ("cdef_pri_taps", "cdef_pri_taps", "<i4", "int", (2, 2)),
    ("cdef_sec_taps", "cdef_sec_taps", "<i4", "int", (2,)),
    ("av1_sgr_params", "sgr_params", "<i4", "int", (16, 4)),
    ("av1_one_by_x", "one_by_x", "<i4", "int", (25,)),
    ("av1_x_by_xplus1", "x_by_xplus1", "<i4", "int", (256,)),
    ("iwt_matrix_ref", "qm_iwt", "u1", "uint8_t", (15, 2, 3344)),
    ("gaussian_sequence", "gaussian_sequence", "<i4", "int16_t", (2048,)),
    ("av1_resize_filter_normative", "resize_filter", "<i2", "int16_t",
     (64, 8)),
]
# libaom's aom_film_grain_t (aom_dsp/grain_params.h), int fields in this
# order (a name with a count: an array of that many ints), then the
# uint16_t random_seed and its padding: 648 bytes
GRAIN_FIELDS = [
    ("apply_grain", 1), ("update_parameters", 1), ("scaling_points_y", 28),
    ("num_y_points", 1), ("scaling_points_cb", 20), ("num_cb_points", 1),
    ("scaling_points_cr", 20), ("num_cr_points", 1), ("scaling_shift", 1),
    ("ar_coeff_lag", 1), ("ar_coeffs_y", 24), ("ar_coeffs_cb", 25),
    ("ar_coeffs_cr", 25), ("ar_coeff_shift", 1), ("cb_mult", 1),
    ("cb_luma_mult", 1), ("cb_offset", 1), ("cr_mult", 1),
    ("cr_luma_mult", 1), ("cr_offset", 1), ("overlap_flag", 1),
    ("clip_to_restricted_range", 1), ("bit_depth", 1),
    ("chroma_scaling_from_luma", 1), ("grain_scale_shift", 1),
    ("random_seed", 1)]
GRAIN_INTS = sum(n for _, n in GRAIN_FIELDS)


def grain_vector(raw: bytes) -> dict:
    """One aom_film_grain_t of libaom's bytes: {field: int or list}."""
    v = list(np.frombuffer(raw[:4 * (GRAIN_INTS - 1)], "<i4"))
    v.append(int.from_bytes(raw[4 * (GRAIN_INTS - 1):][:2], "little"))
    out, pos = {}, 0
    for name, n in GRAIN_FIELDS:
        out[name] = [int(x) for x in v[pos:pos + n]] if n > 1 else int(v[pos])
        pos += n
    return out


def check_grain_vectors(raw: bytes) -> np.ndarray:
    """libaom's 16 film_grain_test_vectors, read by GRAIN_FIELDS: each
    must be a grain libaom's bitstream can carry (at most 14 / 10 / 10
    points, increasing, shifts and lags in their fields' ranges, 8-bit
    coefficients, the seed's padding zero); ``[16, GRAIN_INTS]`` int32 in
    the struct's order."""
    size = len(raw) // 16
    if len(raw) != 16 * size or size != 4 * GRAIN_INTS:
        raise SystemExit(f"film_grain_test_vectors: {len(raw)} bytes, not "
                         f"16 of {4 * GRAIN_INTS}")
    rows = []
    for k in range(16):
        chunk = raw[k * size:(k + 1) * size]
        g = grain_vector(chunk)
        ok = g["apply_grain"] == 1 and chunk[-2:] == bytes(2) and \
            8 <= g["scaling_shift"] <= 11 and 6 <= g["ar_coeff_shift"] <= 9 \
            and 0 <= g["ar_coeff_lag"] <= 3 and \
            0 <= g["grain_scale_shift"] <= 3
        for plane, most in (("y", 14), ("cb", 10), ("cr", 10)):
            n = g[f"num_{plane}_points"]
            xs = g[f"scaling_points_{plane}"][0:2 * n:2]
            ok &= 0 <= n <= most and all(a < b for a, b in zip(xs, xs[1:]))
            ok &= all(-128 <= c < 128 for c in g[f"ar_coeffs_{plane}"])
        if not ok:
            raise SystemExit(f"film_grain_test_vectors[{k}] is not a grain "
                             "of aom_film_grain_t's layout")
        rows.append(np.frombuffer(chunk[:-4], "<i4").tolist()
                    + [g["random_seed"]])
    return np.array(rows, np.int32)

# the transform sizes whose scans libaom stores (the 64-point sizes use
# those of 32 x 32, 16 x 32 and 32 x 16), in the order of scan_offset
SCAN_SIZES = [(4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16),
              (16, 8), (16, 32), (32, 16), (4, 16), (16, 4), (8, 32),
              (32, 8)]

# the specification's default CDFs that libaom keeps in its code (values of
# symbols 0 .. N-2; the last, 32768, and the counter are added)
SPEC_CDFS = {
    "skip_cdf": [[31671], [16515], [4576]],
    "intrabc_cdf": [[30531]],
    "angle_delta_cdf": [
        [2180, 5032, 7567, 22776, 26989, 30217],
        [2301, 5608, 8801, 23487, 26974, 30330],
        [3780, 11018, 13699, 19354, 23083, 31286],
        [4581, 11226, 15147, 17138, 21834, 28397],
        [1737, 10927, 14509, 19588, 22745, 28823],
        [2664, 10176, 12485, 17650, 21600, 30495],
        [2240, 11096, 15453, 20341, 22561, 28917],
        [3605, 10428, 12459, 17676, 21244, 30655]],
    "filter_intra_cdf": [[v] for v in (
        4621, 6743, 5893, 7866, 12551, 9394, 12408, 14301, 12756, 22343,
        16384, 16384, 16384, 16384, 16384, 16384, 12770, 10368, 20229,
        18101, 16384, 16384)],
    "filter_intra_mode_cdf": [[8949, 12776, 17211, 29558]],
    "cfl_sign_cdf": [[1418, 2123, 13340, 18405, 26972, 28343, 32294]],
    "cfl_alpha_cdf": [
        [7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700,
         32704, 32708, 32712, 32716, 32720, 32724],
        [14365, 23603, 28135, 31168, 32167, 32395, 32487, 32573, 32620,
         32647, 32668, 32672, 32676, 32680, 32684],
        [11532, 22380, 28445, 31360, 32349, 32523, 32584, 32649, 32673,
         32677, 32681, 32685, 32689, 32693, 32697],
        [26990, 31402, 32282, 32571, 32692, 32696, 32700, 32704, 32708,
         32712, 32716, 32720, 32724, 32728, 32732],
        [17248, 26058, 28904, 30608, 31305, 31877, 32126, 32321, 32394,
         32464, 32516, 32560, 32576, 32593, 32622],
        [14738, 21678, 25779, 27901, 29024, 30302, 30980, 31843, 32144,
         32413, 32520, 32594, 32622, 32656, 32660]],
    "palette_y_mode_cdf": [[v] for v in (
        31676, 3419, 1261, 31912, 2859, 980, 31823, 3400, 781, 32030, 3561,
        904, 32309, 7337, 1462, 32265, 4015, 1521, 32450, 7946, 129)],
    "palette_uv_mode_cdf": [[32461], [21488]],
    "palette_y_size_cdf": [
        [7952, 13000, 18149, 21478, 25527, 29241],
        [7139, 11421, 16195, 19544, 23666, 28073],
        [7788, 12741, 17325, 20500, 24315, 28530],
        [8271, 14064, 18246, 21564, 25071, 28533],
        [12725, 19180, 21863, 24839, 27535, 30120],
        [9711, 14888, 16923, 21052, 25661, 27875],
        [14940, 20797, 21678, 24186, 27033, 28999]],
    "palette_uv_size_cdf": [
        [8713, 19979, 27128, 29609, 31331, 32272],
        [5839, 15573, 23581, 26947, 29848, 31700],
        [4426, 11260, 17999, 21483, 25863, 29430],
        [3228, 9464, 14993, 18089, 22523, 27420],
        [3768, 8886, 13091, 17852, 22495, 27207],
        [2464, 8451, 12861, 21632, 25525, 28555],
        [1269, 5435, 10433, 18963, 21700, 25865]],
}
SPEC_CDFS.update({
    # tx_depth: 8 x 8 blocks (2 symbols), then the 16, 32 and 64 classes
    "tx_8x8_cdf": [[19968], [19968], [24320]],
    "tx_cdf": [[12272, 30172], [12272, 30172], [18677, 30848],
               [12986, 15180], [12986, 15180], [24302, 25602],
               [5782, 11475], [5782, 11475], [16803, 22759]],
    "delta_q_cdf": [[28160, 32120, 32677]],
    "delta_lf_cdf": [[28160, 32120, 32677]],
    "delta_lf_multi_cdf": [[28160, 32120, 32677]] * 4,
    # loop restoration: restoration_type, use_wiener, use_sgrproj
    "switchable_restore_cdf": [[9413, 22581]],
    "wiener_restore_cdf": [[11570]],
    "sgrproj_restore_cdf": [[16855]],
    # txfm_split of the 21 contexts of txfm_partition_context
    "txfm_partition_cdf": [[v] for v in (
        28581, 23846, 20847, 24315, 18196, 12133, 18791, 10887, 11005,
        27179, 20004, 11281, 26549, 19308, 14224, 28015, 21546, 14400,
        28165, 22401, 16088)],
    # segment_id of an intra frame, by the spatial prediction's context
    "spatial_pred_seg_cdf": [
        [5622, 7893, 16093, 18233, 27809, 28373, 32533],
        [14274, 18230, 22557, 24935, 29980, 30851, 32344],
        [27527, 28487, 28723, 28890, 32397, 32647, 32679]],
})
SPEC_SHAPES = {"palette_y_mode_cdf": (7, 3), "cfl_sign_cdf": (),
               "filter_intra_mode_cdf": (), "intrabc_cdf": (),
               "tx_cdf": (3, 3), "delta_q_cdf": (), "delta_lf_cdf": (),
               "switchable_restore_cdf": (), "wiener_restore_cdf": (),
               "sgrproj_restore_cdf": ()}
# the specification's constants of loop restoration's coefficients: the
# Wiener taps 0-2 (the outer first) and the self-guided projection's xqd
SPEC_CONSTANTS = [
    ("wiener_taps_min", [-5, -23, -17]), ("wiener_taps_max", [10, 8, 46]),
    ("wiener_taps_k", [1, 2, 3]), ("wiener_taps_mid", [3, -7, 15]),
    ("sgrproj_xqd_min", [-96, -32]), ("sgrproj_xqd_max", [31, 95]),
    ("sgrproj_xqd_mid", [-32, 31]),
    # the vertical wedge prototype (Wedge_Master_Vertical), which libaom
    # keeps in code
    ("wedge_master_vertical", [0] * 29 + [2, 7, 21, 43, 57, 62] + [64] * 29),
]

# the inter CDFs libaom builds in code (av1_init_mode_probs): read out of a
# FRAME_CONTEXT that function fills, called through ctypes at its .symtab
# address; (C name, offset in uint16 of the FRAME_CONTEXT, shape).  The
# offsets follow libaom 3.14's field order (entropymode.h) and are checked
# against the tables the .symtab names at their own offsets (ANCHORS) and
# against the specification's first values of a few (FC_SPEC).
FC_CDFS = [
    ("newmv_cdf", 4045, (6, 3)), ("zeromv_cdf", 4063, (2, 3)),
    ("refmv_cdf", 4069, (6, 3)), ("drl_cdf", 4087, (3, 3)),
    ("interintra_cdf", 4608, (4, 3)),
    ("wedge_interintra_cdf", 4620, (22, 3)),
    ("interintra_mode_cdf", 4686, (4, 5)),
    ("motion_mode_cdf", 4706, (22, 4)), ("obmc_cdf", 4794, (22, 3)),
    ("comp_inter_cdf", 5671, (5, 3)), ("single_ref_cdf", 5686, (3, 6, 3)),
    ("skip_mode_cdf", 5926, (3, 3)), ("intra_inter_cdf", 5944, (4, 3)),
    ("seg_pred_cdf", 6245, (3, 3)), ("y_mode_cdf", 6363, (4, 14)),
    ("switchable_interp_cdf", 7029, (16, 4)),
]
FC_ANCHORS = [("default_wedge_idx_cdf", 4234), ("default_palette_y_color_index_cdf", 4972),
              ("default_uv_mode_cdf", 6419), ("default_partition_cdf", 6809),
              ("default_kf_y_mode_cdf", 7093), ("default_intra_ext_tx_cdf", 7585),
              ("default_inter_ext_tx_cdf", 10237)]
FC_SPEC = {"newmv_cdf": 24035, "zeromv_cdf": 2175, "refmv_cdf": 23974,
           "drl_cdf": 13104, "intra_inter_cdf": 806, "skip_mode_cdf": 32621}
FC_SIZE = 10618  # uint16 of av1_init_mode_probs's fields, up to cfl_alpha
# the interpolation filters in the specification's order of
# Subpel_Filters: regular, smooth, sharp, bilinear, 4-tap regular, 4-tap
# smooth (16 phases of 8 taps)
SUBPEL = ["av1_sub_pel_filters_8", "av1_sub_pel_filters_8smooth",
          "av1_sub_pel_filters_8sharp", "av1_bilinear_filters",
          "av1_sub_pel_filters_4", "av1_sub_pel_filters_4smooth"]
INTER_PLAIN = [
    ("av1_warped_filter", "warped_filter", "<i2", "int16_t", (193, 8)),
    ("div_lut", "div_lut", "<i2", "int16_t", (257,)),
    ("obmc_mask_2", "obmc_mask_2", "u1", "uint8_t", (2,)),
    ("obmc_mask_4", "obmc_mask_4", "u1", "uint8_t", (4,)),
    ("obmc_mask_8", "obmc_mask_8", "u1", "uint8_t", (8,)),
    ("obmc_mask_16", "obmc_mask_16", "u1", "uint8_t", (16,)),
    ("obmc_mask_32", "obmc_mask_32", "u1", "uint8_t", (32,)),
    ("ii_weights1d", "ii_weights1d", "u1", "uint8_t", (128,)),
    ("ii_size_scales", "ii_size_scales", "u1", "uint8_t", (22,)),
    ("wedge_master_oblique_even", "wedge_master_even", "u1", "uint8_t",
     (64,)),
    ("wedge_master_oblique_odd", "wedge_master_odd", "u1", "uint8_t", (64,)),
    ("wedge_signflip_lookup", "wedge_signflip", "u1", "uint8_t", (22, 16)),
    ("default_wedge_idx_cdf", None, None, None, (22, 17)),
]
# wedge codebooks (direction, x offset, y offset) of square, tall and wide
# blocks
WEDGE_BOOKS = ["wedge_codebook_16_heqw", "wedge_codebook_16_hgtw",
               "wedge_codebook_16_hltw"]


def _local_function(path: str, lib: bytes, name: str):
    """A function of the library's .symtab (a local one too) as a ctypes
    function taking one pointer: the library is loaded and the symbol's
    address placed by the load address of ``aom_codec_av1_dx``."""
    import ctypes

    shoff, = struct.unpack_from("<Q", lib, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", lib, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", lib, shoff + k * shentsize)
                for k in range(shnum)]
    _, _, _, _, off, size, link, _, _, entsize = [
        s for s in sections if s[1] == 2][0]
    strtab = sections[link][4]
    found = {}
    for k in range(size // entsize):
        name_off, info, _, _, value, _ = struct.unpack_from(
            "<IBBHQQ", lib, off + k * entsize)
        if info & 15 != 2:  # STT_FUNC
            continue
        found[lib[strtab + name_off:lib.index(b"\0", strtab + name_off)]
              .decode()] = value
    so = ctypes.CDLL(path)
    base = ctypes.cast(so.aom_codec_av1_dx, ctypes.c_void_p).value - \
        found["aom_codec_av1_dx"]
    fn = ctypes.CFUNCTYPE(None, ctypes.c_void_p)(base + found[name])
    fn._so = so  # keep the library loaded
    return fn


def frame_context_cdfs(path: str, lib: bytes, syms: dict) -> list:
    """The FC_CDFS tables in the specification's form, from a FRAME_CONTEXT
    that libaom's av1_init_mode_probs fills."""
    import ctypes

    buf = (ctypes.c_uint16 * (FC_SIZE + 64))()
    _local_function(path, lib, "av1_init_mode_probs")(ctypes.addressof(buf))
    fc = np.array(buf, np.uint16)
    for sym, pos in FC_ANCHORS:
        t = np.frombuffer(syms[sym][0], "<u2")
        if not np.array_equal(fc[pos:pos + len(t)], t):
            raise SystemExit(f"the frame context's layout: {sym} is not at "
                             f"{pos}")
    out = []
    for name, pos, shape in FC_CDFS:
        a = fc[pos:pos + int(np.prod(shape))].reshape(shape)
        if name in FC_SPEC and 32768 - int(a.reshape(-1)[0]) != FC_SPEC[name]:
            raise SystemExit(f"{name}: not the specification's default")
        out.append(_array("uint16_t", name, spec_form(a)))
    return out


# default_nmv_context (libaom's nmv_context): the joints' CDF row, then for
# the vertical and the horizontal component the rows of classes, class0_fp
# (2), fp, sign, class0_hp, hp, class0 and bits (10)
MV_COMPONENT = [12, 5, 5, 5, 3, 3, 3, 3] + [3] * 10
MV_ROWS = [5] + MV_COMPONENT * 2

LIBAOM_NOTICE = """\
 * The tables are libaom's (av1/common/entropymode.c, entropy.c,
 * token_cdfs.h, scan.c, reconintra.c, quant_common.c, txb_common.c,
 * av1_txfm.c, cdef_block.c, restoration.c, aom_dsp/grain_synthesis.c,
 * av1/encoder/grain_test_vectors.h):
 *
 * Copyright (c) 2016, Alliance for Open Media. All rights reserved.
 *
 * This source code is subject to the terms of the BSD 2 Clause License and
 * the Alliance for Open Media Patent License 1.0:
 *
 * Redistribution and use in source and binary forms, with or without
 * modification, are permitted provided that the following conditions are
 * met:
 * 1. Redistributions of source code must retain the above copyright
 *    notice, this list of conditions and the following disclaimer.
 * 2. Redistributions in binary form must reproduce the above copyright
 *    notice, this list of conditions and the following disclaimer in the
 *    documentation and/or other materials provided with the distribution.
 *
 * THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS
 * IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED
 * TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A
 * PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
 * HOLDER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
 * SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED
 * TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
 * PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
 * LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
 * NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
 * SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
"""


def library_path() -> str:
    """OpenCV's libaom: ``opencv_python.libs/libaom-*.so*`` beside cv2."""
    import cv2

    site = os.path.dirname(os.path.dirname(os.path.abspath(cv2.__file__)))
    found = sorted(glob.glob(os.path.join(site, "opencv_python.libs",
                                          "libaom-*.so*")))
    if not found:
        raise SystemExit("no libaom beside cv2")
    return found[0]


def symbols(lib: bytes) -> dict:
    """``{name: [bytes, ...]}`` of every sized data symbol of an ELF64
    little-endian library, read from its ``.symtab``."""
    if lib[:4] != b"\x7fELF" or lib[4] != 2 or lib[5] != 1:
        raise SystemExit("not an ELF64 little-endian library")
    shoff, = struct.unpack_from("<Q", lib, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", lib, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", lib, shoff + k * shentsize)
                for k in range(shnum)]
    symtab = [s for s in sections if s[1] == 2]  # SHT_SYMTAB
    if not symtab:
        raise SystemExit("the library has no .symtab")
    _, _, _, _, off, size, link, _, _, entsize = symtab[0]
    strtab = sections[link]
    out = {}
    for k in range(size // entsize):
        name_off, info, _, shndx, value, sym_size = struct.unpack_from(
            "<IBBHQQ", lib, off + k * entsize)
        if info & 15 != 1 or not sym_size or not 0 < shndx < shnum:
            continue  # STT_OBJECT with a size in a section only
        sec = sections[shndx]
        if sec[1] == 8:  # SHT_NOBITS
            continue
        s = strtab[4] + name_off
        name = lib[s:lib.index(b"\0", s)].decode()
        pos = sec[4] + value - sec[3]
        out.setdefault(name, []).append(lib[pos:pos + sym_size])
    return out


def table(syms: dict, name: str, nbytes: int) -> bytes:
    copies = syms.get(name)
    if not copies:
        raise SystemExit(f"{name}: not in the library's symbol table")
    if any(c != copies[0] for c in copies) or len(copies[0]) != nbytes:
        raise SystemExit(f"{name}: {len(copies[0])} bytes, not {nbytes}, "
                         "or copies that differ")
    return copies[0]


def spec_form(icdf: np.ndarray) -> np.ndarray:
    """libaom's inverted CDF rows (``32768 - cdf``: 0 for the last symbol,
    then the counter, then zeros up to the table's width) -> the
    specification's: ``cdf`` of each symbol (the last 32768), the counter
    (0) right after the last symbol, 32768 in the padding past it."""
    rows = icdf.astype(np.int64).reshape(-1, icdf.shape[-1])
    out = 32768 - rows
    for row, inv in zip(out, rows):
        last = int(np.flatnonzero(inv == 0)[0])
        row[last + 1] = 0
    return out.reshape(icdf.shape)


def _rows(values, per_line: int) -> str:
    items = [str(int(v)) for v in values]
    lines = [", ".join(items[i:i + per_line])
             for i in range(0, len(items), per_line)]
    return ",\n".join("    " + line for line in lines)


def _array(ctype: str, name: str, a: np.ndarray) -> str:
    dims = "".join(f"[{d}]" for d in a.shape)
    per = a.shape[-1] if a.shape[-1] <= 16 else 16
    return (f"static const {ctype} {name}{dims} = {{\n"
            + _rows(a.reshape(-1), per) + "\n};\n")


def check_spec_cdfs(lib: bytes) -> None:
    """Each specification CDF of 3 symbols or more must be in libaom's
    bytes, inverted: each row's first 8 values and its last 8 with the
    last symbol's 0 and the counter (the compiler copies a long row in
    overlapping 16-byte pieces); a shorter row's values alone."""
    for name, rows in SPEC_CDFS.items():
        for row in rows:
            if len(row) < 2:
                continue
            inv = [32768 - v for v in row] + [0, 0]
            for piece in (inv[:8], inv[-8:]) if len(row) > 8 else (
                    inv[:len(row)],):
                if lib.find(np.array(piece, "<u2").tobytes()) < 0:
                    raise SystemExit(f"{name}: {row[:3]}... is not in "
                                     "libaom")


def check_nz_map_offsets(syms: dict) -> None:
    """The 2-D base-level context offsets of av1_core.h's
    ``coeff_base_ctx`` (a rule of the position and the transform's shape,
    taken before a 64-point side is cut to 32) must equal libaom's
    ``av1_nz_map_ctx_offset_*`` tables, read column by column."""
    for name, copies in syms.items():
        if not name.startswith("av1_nz_map_ctx_offset_"):
            continue
        w, h = map(int, name.rsplit("_", 1)[1].split("x"))
        t = np.frombuffer(copies[0], "i1")
        # 32 x 64 and 64 x 32: a 32 x 32 grid, offsets of their own shape
        gw, gh = min(w, 32), min(h, 32)
        for r in range(gh):
            for c in range(gw):
                want = 0 if r == c == 0 else 11 if w < h and r < 2 else \
                    16 if w > h and c < 2 else 1 if r + c < 2 else \
                    6 if r + c < 4 else 21
                if t[c * gh + r] != want:
                    raise SystemExit(f"{name}: the offset rule fails at "
                                     f"({r}, {c})")


def render() -> dict:
    """``{path: text}`` of the header, from cv2's libaom."""
    with open(library_path(), "rb") as f:
        lib = f.read()
    syms = symbols(lib)
    check_spec_cdfs(lib)
    parts = []
    for sym, name, shape in CDFS:
        raw = table(syms, sym, 2 * int(np.prod(shape)))
        a = np.frombuffer(raw, "<u2").reshape(shape)
        parts.append(_array("uint16_t", name, spec_form(a)))
    for name, rows in SPEC_CDFS.items():
        n = max(len(r) for r in rows) + 1
        a = np.array([list(r) + [32768] * (n - len(r)) + [0] for r in rows])
        shape = SPEC_SHAPES.get(name, (len(rows),))
        parts.append(_array("uint16_t", name, a.reshape(shape + (n + 1,))))
    for sym, name, dtype, ctype, shape in PLAIN:
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        parts.append(_array(ctype, name, np.frombuffer(
            table(syms, sym, n), dtype).reshape(shape)))
    parts += frame_context_cdfs(library_path(), lib, syms)
    for sym, name, dtype, ctype, shape in INTER_PLAIN:
        n = int(np.prod(shape)) * (np.dtype(dtype).itemsize if dtype else 2)
        raw = table(syms, sym, n)
        if name is None:
            parts.append(_array("uint16_t", "wedge_idx_cdf", spec_form(
                np.frombuffer(raw, "<u2").reshape(shape))))
        else:
            parts.append(_array(ctype, name, np.frombuffer(
                raw, dtype).reshape(shape)))
    parts.append(_array("int16_t", "subpel_filters", np.stack([
        np.frombuffer(table(syms, sym, 256), "<i2").reshape(16, 8)
        for sym in SUBPEL])))
    parts.append(_array("int8_t", "wedge_codebook", np.stack([
        np.frombuffer(table(syms, sym, 192), "<i4").reshape(16, 3)
        for sym in WEDGE_BOOKS])))
    grain = check_grain_vectors(table(syms, "film_grain_test_vectors",
                                      16 * 4 * GRAIN_INTS))
    parts.append(_array("int32_t", "film_grain_test_vectors", grain))
    for name, values in SPEC_CONSTANTS:
        parts.append(_array("int", name, np.array(values)))
    mv = np.frombuffer(table(syms, "default_nmv_context", 286), "<u2")
    rows, pos = [], 0
    for n in MV_ROWS:
        rows.append(spec_form(mv[pos:pos + n][None])[0])
        pos += n
    parts.append(_array("uint16_t", "mv_cdf", np.concatenate(rows)))
    # libaom keeps coefficients column by column (index col * H + row):
    # the header holds row-major positions, row * W + col
    for kind in ("default", "mrow", "mcol"):
        scans = []
        for w, h in SCAN_SIZES:
            lib_scan = np.frombuffer(table(syms, f"{kind}_scan_{w}x{h}",
                                           2 * w * h), "<i2")
            scans.append((lib_scan % h) * w + lib_scan // h)
        parts.append(_array("int16_t", f"{kind}_scan",
                            np.concatenate(scans)))
    check_nz_map_offsets(syms)
    # cdef_directions: libaom's offsets in a buffer of stride 144 -> the
    # specification's (row, column) steps
    pad = np.frombuffer(table(syms, "cdef_directions_padded", 96), "<i4")
    steps = pad.reshape(12, 2)[2:10]
    rows = (steps + 72) // 144
    dirs = np.stack([rows, steps - rows * 144], -1)
    parts.append(_array("int8_t", "cdef_directions", dirs))
    for other in ("_intra_mode_to_tx_type.9", "_intra_mode_to_tx_type.16"):
        if set(syms[other]) != set(syms["_intra_mode_to_tx_type.1"]):
            raise SystemExit("the copies of intra_mode_to_tx_type differ")
    body = "\n".join(parts)
    text = f"""/* libaom's tables of the AV1 intra decoder, for av1_decode.c and
 * av1_encode.c.
 *
 * Every *_cdf table is in the form of the AV1 specification: for each
 * context, the cumulative count (out of 32768) of symbols 0 .. N-1,
 * increasing, the last 32768, then at index N one slot that counts the
 * symbol's adaptations (0 here); a row with fewer symbols than the table's
 * width (8 x 8 and 128 x 128 partitions, palettes of fewer than 8 colours,
 * uv modes without CfL, intra transform sets of fewer types) holds 32768
 * past its counter.  libaom stores them inverted (32768 - cdf); the
 * coefficient CDFs are indexed [q context][transform size][plane type]
 * [context] as libaom indexes them (the eob CDFs [q context][plane type]
 * [context]).  default_scan, mrow_scan and mcol_scan hold row-major
 * positions, libaom's column-major ones turned, for the transform sizes
 * up to 32 x 32 in the order of av1_core.h's scan_offset (64-point sizes
 * use the 32-point scans); qm_iwt holds libaom's inverse quantiser
 * matrices (levels 0-14, luma and chroma) in libaom's column-major order
 * at the same offsets.  cospi_arr and sinpi_arr are libaom's for cos_bit
 * 10-13 (row 2: 12 bits); cdef_directions the (row, column) steps of
 * libaom's offsets; sgr_params libaom's self-guided restoration sets
 * (r[2], s[2]), one_by_x and x_by_xplus1 its reciprocals; the wiener_taps_*
 * and sgrproj_xqd_* ranges are the specification's.  sm_weights holds the
 * weights of sizes 4, 8, 16, 32 and 64 (size n from offset n - 4).
 * inter_ext_tx_cdf holds the inter transform sets' CDFs (intra block
 * copy) [set][square size], txfm_partition_cdf txfm_split's,
 * spatial_pred_seg_cdf an intra frame's segment_id by context;
 * resize_filter is superres's 8-tap normative upscaling filter (64
 * phases).
 * gaussian_sequence is film grain's (2048 values, 12 bits);
 * film_grain_test_vectors libaom's 16 grains of its encoder's
 * film-grain-test option, each aom_film_grain_t's ints in its order
 * (apply, update, 14 y points (x, y), their count, 10 cb points, count,
 * 10 cr points, count, scaling shift, lag, 24 y, 25 cb, 25 cr AR
 * coefficients (less 128), AR shift, cb mult, luma mult, offset, cr's,
 * overlap, clip, bit depth, chroma from luma, grain scale shift, seed).  mv_cdf is libaom's default_nmv_context,
 * the CDFs of intra block copy vectors: at 0 the joints (4 symbols), then
 * for the vertical (at 5) and the horizontal component (at 74): classes
 * (11) at +0, class0_fp (2 x 4) at +12, fp (4) at +22, sign at +27,
 * class0_hp at +30, hp at +33, class0 at +36, bits (10 x 2) at +39;
 * inter blocks use the same defaults (libaom's nmvc).  The inter CDFs
 * (newmv_cdf ... switchable_interp_cdf) are those libaom's
 * av1_init_mode_probs writes; wedge_idx_cdf is indexed by block size.
 * subpel_filters holds the interpolation filters in the specification's
 * order (regular, smooth, sharp, bilinear, 4-tap regular, 4-tap smooth),
 * warped_filter the warp filter's 193 phases, div_lut the warp's
 * reciprocals, obmc_mask_* OBMC's blending masks, ii_weights1d and
 * ii_size_scales the smooth inter-intra masks, wedge_master_* the oblique
 * wedge prototypes, wedge_signflip the wedges' sign flips by block size
 * and wedge_codebook the (direction, x, y offset) codebooks of square,
 * tall and wide blocks.
 *
 * Written by scripts/extract_av1_tables_torch.py from the .symtab of
 * OpenCV's libaom (the CDFs libaom keeps in its code are the
 * specification's defaults, checked against the library's bytes); do not
 * edit.
 *
{LIBAOM_NOTICE} */
#ifndef AV1_TABLES_H
#define AV1_TABLES_H

#include <stdint.h>

{body}
#endif
"""
    return {HEADER: text}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--check", action="store_true",
                        help="compare the committed header, write nothing")
    args = parser.parse_args(argv)
    stale = []
    for path, text in render().items():
        if args.check:
            with open(path) as f:
                if f.read() != text:
                    stale.append(path)
        else:
            with open(path, "w") as f:
                f.write(text)
            print(f"wrote {os.path.relpath(path, REPO)}")
    for path in stale:
        print(f"{os.path.relpath(path, REPO)} differs from the library's "
              "tables", file=sys.stderr)
    return 1 if stale else 0


if __name__ == "__main__":
    sys.exit(main())
