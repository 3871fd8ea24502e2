"""The tables carried out of OpenCV's library into the port's host C
(scripts/extract_cv2_tables_torch.py): libtiff's uv table of the LogLuv24
decoder and OpenJPEG's HTJ2K VLC and MEL tables.  The committed headers
must equal what the script extracts from the installed cv2 now."""

import importlib.util
import os

import numpy as np
import pytest

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts",
                      "extract_cv2_tables_torch.py")


def _script():
    spec = importlib.util.spec_from_file_location("extract_cv2_tables",
                                                  SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_committed_headers_equal_the_library_tables():
    """Re-extract both headers from cv2's binary (found by structure: one
    uv_row run, one run of two prefix-code VLC tables, the MEL
    exponents) and compare them with the committed files byte for
    byte."""
    pytest.importorskip("cv2")
    script = _script()
    for path, text in script.render().items():
        with open(path) as fh:
            assert fh.read() == text, os.path.basename(path)


def test_tables_hold_their_invariants():
    """The extracted tables as the decoders use them: uv_row's cumulative
    counts end at UV_NDIVS; every VLC entry's e_1 bits lie in its e_k
    bits and those in its rho bits; in context 0 of both tables every
    code signals a significant sample (the MEL event carries rho = 0)."""
    pytest.importorskip("cv2")
    script = _script()
    lib = script.library_bytes()
    uv = script.find_uv_row(lib)
    assert int(uv["ncum"][-1]) + int(uv["nus"][-1]) == script.UV_NDIVS
    for tbl in script.find_vlc_tables(lib):
        t = tbl.astype(np.int64)
        rho, e1, ek = t >> 4 & 15, t >> 8 & 15, t >> 12 & 15
        assert not (e1 & ~ek).any() and not (ek & ~rho).any()
        assert (rho[:128] != 0).all()


AV1_SCRIPT = os.path.join(os.path.dirname(SCRIPT), "extract_av1_tables_torch.py")


def _av1_script():
    spec = importlib.util.spec_from_file_location("extract_av1_tables",
                                                  AV1_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_av1_header_equals_libaom_tables():
    """scripts/extract_av1_tables_torch.py --check: av1_tables.h equals
    what the script reads from the .symtab of cv2's libaom (the CDFs in
    the specification's form, the scan, the intra tables, the quantizer
    lookups; the CDFs libaom keeps in its code checked against its bytes):
    exit 0."""
    pytest.importorskip("cv2")
    assert _av1_script().main(["--check"]) == 0


def test_av1_cdfs_are_increasing_with_a_counter():
    """Every CDF row of the header: increasing to 32768 at its last symbol,
    its counter slot 0 right after it; libaom's partition CDFs of 8 x 8
    blocks have 4 symbols, of 128 x 128 blocks 8."""
    pytest.importorskip("cv2")
    script = _av1_script()
    with open(script.library_path(), "rb") as f:
        syms = script.symbols(f.read())
    part = np.frombuffer(script.table(syms, "default_partition_cdf", 440),
                         "<u2").reshape(20, 11)
    spec = script.spec_form(part)
    for row, n in zip(spec, [4] * 4 + [10] * 12 + [8] * 4):
        assert (np.diff(row[:n]) > 0).all() and row[n - 1] == 32768
        assert row[n] == 0
