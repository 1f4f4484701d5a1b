"""Writes ``tests/data/zstd_timing/``: one zstd frame that is small on disk
but decodes to 32 MiB, for timing the port's zstd decoder
(``allophant_tpu_torch/native/zstd.py``) on a machine without ``zstandard``,
and a JSON of what it decodes to (size and SHA-256).

The content is a 64 KiB block of random normal float32 values, then that
block repeated with one random 4-byte word changed every 8 KiB: zstd level 3
writes the block as Huffman-coded literals, then long matches 64 KiB back
(most of them through the repeat offsets) between raw 4-byte literals. So it
times the sequence execution and match copies at a checkpoint chunk's size,
not the literal decoding of a chunk of random weights (which
``tools/bench_zstd_decoder.py`` times beside ``zstandard``).

Needs ``zstandard``, which the port never imports. Run from the repository
root:

    python tools/write_zstd_timing_frame.py [OUT_DIR]
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

SIZE = 32 << 20
BLOCK = 64 << 10
STRIDE = 8 << 10
LEVEL = 3
FRAME_FILE = "long_matches.zst"
META_FILE = "long_matches.json"


def content(seed: int = 0) -> bytes:
    """The frame's decoded bytes."""
    rng = np.random.default_rng(seed)
    block = rng.standard_normal(BLOCK // 4).astype(np.float32).view(np.uint8)
    data = np.tile(block, SIZE // BLOCK)
    words = data.view(np.uint32)
    positions = np.arange(BLOCK, SIZE, STRIDE) // 4 + rng.integers(0, STRIDE // 4, (SIZE - BLOCK) // STRIDE)
    words[positions] = rng.integers(0, 1 << 32, positions.size, dtype=np.uint64).astype(np.uint32)
    return data.tobytes()


def main(out_dir: Path) -> None:
    import zstandard

    data = content()
    frame = zstandard.ZstdCompressor(level=LEVEL, write_checksum=True).compress(data)
    if zstandard.ZstdDecompressor().decompress(frame) != data:
        raise SystemExit("zstandard's own round trip differs")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / FRAME_FILE).write_bytes(frame)
    meta = {"decoded_bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(), "level": LEVEL}
    (out_dir / META_FILE).write_text(json.dumps(meta, indent=1) + "\n", encoding="utf-8")
    print(f"{out_dir / FRAME_FILE}: {len(frame)} bytes, decodes to {len(data)}")


if __name__ == "__main__":
    root = Path(__file__).resolve().parent.parent
    main(Path(sys.argv[1]) if len(sys.argv) > 1 else root / "tests" / "data" / "zstd_timing")
