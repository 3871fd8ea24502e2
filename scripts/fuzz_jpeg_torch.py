#!/usr/bin/env python
"""Memory-safety check of the port's JPEG decoder (``csrc/host/
jpeg_decode.c``): builds it with AddressSanitizer and UndefinedBehavior
Sanitizer beside a small C harness, then decodes every truncation of a few
seed files and ``--mutations`` copies of each with 1-4 random bytes
overwritten.  Any out-of-bounds access or undefined behaviour aborts the
harness; otherwise it prints how many inputs decoded, were refused as
corrupt, or as unsupported.

    python scripts/fuzz_jpeg_torch.py [--mutations 20000] [--seed 1]

The seeds are baseline files of the port's encoder (4:2:0 with restart
markers, 4:4:4, 4:1:1, 4:4:0, gray); ``--files`` adds others (progressive
files, say).  Needs a C compiler with the sanitizers (gcc or clang); runs
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
int jpeg_decode(const uint8_t *, int64_t, uint8_t *, int64_t, int64_t,
                char *, int);
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
            if (st == 0) {
                uint8_t *o = malloc((size_t)info[0] * info[1] * 3);
                st = jpeg_decode(d, m, o, info[0], info[1], err, 256);
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
    """Small files of the port's encoder in several modes."""
    im = rng.integers(0, 256, (37, 53, 3), np.uint8)
    return [encode_jpeg(im, 90, "420", 2), encode_jpeg(im, 75, "444"),
            encode_jpeg(im, 95, "411", 3), encode_jpeg(im, 50, "440"),
            encode_jpeg(im[..., 1], 90, restart_interval=1)]


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
