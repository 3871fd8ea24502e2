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
