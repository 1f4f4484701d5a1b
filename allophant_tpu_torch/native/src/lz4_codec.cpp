// LZ4 block decompression for the zarr/Blosc cache interop layer.
//
// The reference framework's preprocessing caches are Blosc frames whose block
// payloads use the LZ4 block format (reference datasets/__main__.py:187,
// zarr's default compressor). The port depends on no lz4 library, so the
// decoder lives here (the port's copy of the JAX package's lz4_codec.cpp). The sequential token/literal/match structure cannot
// be vectorized in numpy — a pure-Python decode runs at single-digit MB/s,
// while this loop sustains GB/s-class throughput for multi-GB caches.
// Exposed through ctypes from allophant_tpu_torch/data/zarr_store.py, which keeps a
// complete pure-Python fallback.

#include <cstdint>
#include <cstring>

extern "C" {

// Decodes one raw LZ4 block (no frame header) of exactly `dst_len` bytes.
// Returns the number of bytes written, or -1 on malformed input.
int32_t allophant_lz4_decompress(const uint8_t* src, int32_t src_len,
                                 uint8_t* dst, int32_t dst_len) {
  int32_t in = 0;
  int32_t out = 0;
  while (in < src_len) {
    const uint8_t token = src[in++];
    // Literals.
    int32_t literal_length = token >> 4;
    if (literal_length == 15) {
      uint8_t extra;
      do {
        if (in >= src_len) return -1;
        extra = src[in++];
        literal_length += extra;
      } while (extra == 255);
    }
    if (in + literal_length > src_len || out + literal_length > dst_len) return -1;
    std::memcpy(dst + out, src + in, static_cast<size_t>(literal_length));
    in += literal_length;
    out += literal_length;
    if (in >= src_len) break;  // last sequence carries no match
    // Match.
    if (in + 2 > src_len) return -1;
    const int32_t offset = src[in] | (src[in + 1] << 8);
    in += 2;
    if (offset == 0 || offset > out) return -1;
    int32_t match_length = (token & 0xF) + 4;
    if ((token & 0xF) == 15) {
      uint8_t extra;
      do {
        if (in >= src_len) return -1;
        extra = src[in++];
        match_length += extra;
      } while (extra == 255);
    }
    if (out + match_length > dst_len) return -1;
    const uint8_t* match = dst + out - offset;
    if (offset >= match_length) {
      std::memcpy(dst + out, match, static_cast<size_t>(match_length));
      out += match_length;
    } else {
      // Overlapping match: byte-by-byte replication semantics.
      for (int32_t i = 0; i < match_length; ++i) {
        dst[out] = dst[out - offset];
        ++out;
      }
    }
  }
  return out;
}

}  // extern "C"
