"""Host throughput of the port's zstd decoder (allophant_tpu_torch/native/zstd.py)
beside the ``zstandard`` package's, on frames ``zstandard`` writes from
random float32 data (what an Orbax checkpoint's zstd chunks hold) at sizes
up to the full-width flagship's largest chunk, the stacked FFN kernel
([24, 1024, 4096] f32, 384 MiB). Needs ``zstandard``, which the port itself
never imports. Prints one line a size and level; equal output is checked.

    python tools/bench_zstd_decoder.py [MIB ...]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import zstandard

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from allophant_tpu_torch.native import zstd  # noqa: E402


def main(sizes_mib) -> None:
    rng = np.random.default_rng(0)
    zstd.content_size(b"")  # builds the native library outside the timings
    for mib in sizes_mib:
        data = rng.standard_normal(mib << 18).astype(np.float32)
        for level in (1, 3):
            frame = zstandard.ZstdCompressor(level=level).compress(data.tobytes())
            output = np.empty_like(data)
            start = time.perf_counter()
            zstd.decompress_into(frame, output)
            ours = time.perf_counter() - start
            start = time.perf_counter()
            zstandard.ZstdDecompressor().decompress(frame)
            theirs = time.perf_counter() - start
            if not np.array_equal(output, data):
                raise SystemExit(f"{mib} MiB at level {level}: the port's output differs")
            print(
                f"{mib} MiB f32, level {level} (ratio {len(frame) / data.nbytes:.3f}): port {data.nbytes / ours / 1e6:.1f} MB/s,"
                f" zstandard {data.nbytes / theirs / 1e6:.1f} MB/s",
                flush=True,
            )


if __name__ == "__main__":
    main([int(value) for value in sys.argv[1:]] or [4, 64, 384])
