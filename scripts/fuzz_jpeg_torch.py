#!/usr/bin/env python
"""Memory-safety check of the port's JPEG decoder (``csrc/host/
jpeg_decode.c``): builds it with AddressSanitizer and UndefinedBehavior
Sanitizer beside a small C harness, then decodes every truncation of a few
seed files and ``--mutations`` copies of each with 1-4 random bytes
overwritten, to the colour and to the gray output.  Any out-of-bounds
access or undefined behaviour aborts the harness; otherwise it prints how
many inputs decoded, were refused as corrupt, or as unsupported.

    python scripts/fuzz_jpeg_torch.py [--mutations 20000] [--seed 1]

The seeds are baseline files of the port's encoder (4:2:0 with restart
markers, 4:4:4, 4:1:1, 4:4:0, gray) and two of them damaged as libjpeg
reads past (restart markers out of order, bytes before a marker);
``--files`` adds others (progressive files, whose truncations drive the
block smoothing, say).  Needs a C compiler with the sanitizers (gcc or clang); runs
on the host only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from lgu_slam_tpu_torch.data.image_io import encode_jpeg  # noqa: E402
from lgu_slam_tpu_torch.ops._build import CSRC, _cc  # noqa: E402

HARNESS = r"""
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
int jpeg_info(const uint8_t *, int64_t, int32_t *, char *, int);
int jpeg_decode_as(const uint8_t *, int64_t, uint8_t *, int64_t, int64_t,
                   int, char *, int);
int main(int argc, char **argv)
{
    long mutations = atol(argv[1]), counts[4] = {0};
    srand((unsigned)atoi(argv[2]));
    for (int f = 3; f < argc; f++) {
        FILE *fp = fopen(argv[f], "rb");
        fseek(fp, 0, SEEK_END);
        long n = ftell(fp);
        fseek(fp, 0, SEEK_SET);
        uint8_t *base = malloc((size_t)n);
        if (fread(base, 1, (size_t)n, fp) != (size_t)n)
            return 2;
        fclose(fp);
        for (long it = 0; it < n + mutations; it++) {
            long m = it < n ? it : n; /* every truncation, then mutations */
            uint8_t *d = malloc((size_t)(m > 0 ? m : 1));
            memcpy(d, base, (size_t)m);
            if (it >= n)
                for (int k = 1 + rand() % 4; k > 0; k--)
                    d[2 + rand() % (m - 2)] = (uint8_t)rand();
            int32_t info[3];
            char err[256];
            int st = jpeg_info(d, m, info, err, 256);
            /* a mutated frame header can name an image of up to 2^32
             * pixels, which now decodes (gray past the data's end): such
             * files count as refused, sparing the sanitizers' memory */
            if (st == 0 && (int64_t)info[0] * info[1] > (1 << 22))
                st = 1;
            if (st == 0) { /* the colour and the gray output */
                uint8_t *o = malloc((size_t)info[0] * info[1] * 3);
                st = jpeg_decode_as(d, m, o, info[0], info[1], 0, err, 256);
                int gst = jpeg_decode_as(d, m, o, info[0], info[1], 1, err,
                                         256);
                if (gst != st)
                    return 3; /* the two outputs must fail alike */
                free(o);
            }
            counts[st]++;
            free(d);
        }
        free(base);
    }
    printf("{\"decoded\": %ld, \"corrupt\": %ld, \"unsupported\": %ld, "
           "\"out_of_memory\": %ld}\n", counts[0], counts[1], counts[2],
           counts[3]);
    return 0;
}
"""


def seeds(rng) -> list:
    """Small files of the port's encoder in several modes, and the same
    with the damage libjpeg reads past: restart markers out of order and
    bytes before markers (the decoder's resync and skip paths); every
    seed's truncations drive the zero-bit padding."""
    im = rng.integers(0, 256, (37, 53, 3), np.uint8)
    files = [encode_jpeg(im, 90, "420", 2), encode_jpeg(im, 75, "444"),
             encode_jpeg(im, 95, "411", 3), encode_jpeg(im, 50, "440"),
             encode_jpeg(im[..., 1], 90, restart_interval=1)]
    def restarts(data):
        return [i for i in range(len(data) - 1)
                if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]

    rst = bytearray(files[0])
    for k, i in enumerate(restarts(rst)[:6]):  # RSTn -> RSTn+1..n+3
        rst[i + 1] = 0xD0 + ((rst[i + 1] - 0xD0 + 1 + k % 3) & 7)
    at = restarts(files[4])[0]
    junk = files[4][:at] + b"\x12\x34\xff\x00\x56" + files[4][at:]
    return files + [bytes(rst), junk]


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--mutations", type=int, default=20000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--files", nargs="*", default=[],
                   help="more seed files")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        harness = os.path.join(tmp, "harness.c")
        with open(harness, "w") as fh:
            fh.write(HARNESS)
        exe = os.path.join(tmp, "fuzz")
        subprocess.run([_cc(), "-O1", "-g", "-fsanitize=address,undefined",
                        "-fno-sanitize-recover=all", "-o", exe, harness,
                        str(CSRC / "host" / "jpeg_decode.c")], check=True)
        files = []
        for k, data in enumerate(seeds(np.random.default_rng(args.seed))):
            files.append(os.path.join(tmp, f"seed{k}.jpg"))
            with open(files[-1], "wb") as fh:
                fh.write(data)
        out = subprocess.run([exe, str(args.mutations), str(args.seed),
                              *files, *args.files], capture_output=True,
                             text=True)
    if out.returncode != 0:
        raise SystemExit(f"the sanitizers stopped the decoder:\n"
                         f"{out.stderr[-4000:]}")
    print(out.stdout.strip())
    return out.stdout


if __name__ == "__main__":
    main()
