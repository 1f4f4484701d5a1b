// Zstandard decompression (RFC 8878) for the Orbax checkpoint reader.
//
// Orbax writes each array chunk as a zstd frame inside a zarr v2 array, and
// tensorstore's OCDBT key-value store compresses its manifests and B-tree
// nodes with zstd as well. The port depends on no zstd library, so the
// decoder lives here: frames (concatenated, skippable, single-segment, with
// or without the content size, XXH64 checksum), raw/RLE/compressed blocks,
// raw/RLE/Huffman (1 or 4 streams, treeless) literals with direct or
// FSE-coded weights, and sequences in predefined, RLE, FSE and repeat modes.
// Dictionaries are not supported. It runs in linear time in the output.
// Exposed through ctypes from allophant_tpu_torch/native/zstd.py.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>

namespace {

struct ZstdError : std::exception {
  std::string message;
  explicit ZstdError(std::string text) : message(std::move(text)) {}
  const char* what() const noexcept override { return message.c_str(); }
};

thread_local std::string last_error;

[[noreturn]] void fail(const std::string& text) { throw ZstdError(text); }

inline uint32_t read_le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) | (uint32_t(p[3]) << 24);
}

inline uint64_t read_le64(const uint8_t* p) {
  uint64_t value;
  std::memcpy(&value, p, 8);
  return value;
}

inline int highest_bit(uint32_t value) { return 31 - __builtin_clz(value); }

// ---------------------------------------------------------------------------
// XXH64 (seed 0), the frame content checksum.

constexpr uint64_t kPrime1 = 11400714785074694791ULL;
constexpr uint64_t kPrime2 = 14029467366897019727ULL;
constexpr uint64_t kPrime3 = 1609587929392839161ULL;
constexpr uint64_t kPrime4 = 9650029242287828579ULL;
constexpr uint64_t kPrime5 = 2870177450012600261ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t accumulator, uint64_t input) {
  accumulator += input * kPrime2;
  return rotl64(accumulator, 31) * kPrime1;
}

inline uint64_t xxh_merge(uint64_t accumulator, uint64_t value) {
  accumulator ^= xxh_round(0, value);
  return accumulator * kPrime1 + kPrime4;
}

uint64_t xxh64(const uint8_t* data, size_t length) {
  const uint8_t* p = data;
  const uint8_t* end = data + length;
  uint64_t hash;
  if (length >= 32) {
    uint64_t v1 = kPrime1 + kPrime2, v2 = kPrime2, v3 = 0, v4 = 0 - kPrime1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxh_round(v1, read_le64(p));
      v2 = xxh_round(v2, read_le64(p + 8));
      v3 = xxh_round(v3, read_le64(p + 16));
      v4 = xxh_round(v4, read_le64(p + 24));
      p += 32;
    } while (p <= limit);
    hash = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    hash = xxh_merge(hash, v1);
    hash = xxh_merge(hash, v2);
    hash = xxh_merge(hash, v3);
    hash = xxh_merge(hash, v4);
  } else {
    hash = kPrime5;
  }
  hash += length;
  while (p + 8 <= end) {
    hash ^= xxh_round(0, read_le64(p));
    hash = rotl64(hash, 27) * kPrime1 + kPrime4;
    p += 8;
  }
  if (p + 4 <= end) {
    hash ^= uint64_t(read_le32(p)) * kPrime1;
    hash = rotl64(hash, 23) * kPrime2 + kPrime3;
    p += 4;
  }
  while (p < end) {
    hash ^= (*p++) * kPrime5;
    hash = rotl64(hash, 11) * kPrime1;
  }
  hash ^= hash >> 33;
  hash *= kPrime2;
  hash ^= hash >> 29;
  hash *= kPrime3;
  hash ^= hash >> 32;
  return hash;
}

// ---------------------------------------------------------------------------
// Bit readers.

// A backward bitstream (Huffman streams, FSE streams): read from its last
// byte towards its first, most significant bits first. The highest set bit
// of the last byte is the padding marker. Bits before the start read as 0,
// and `position` going below 0 marks an overread.
struct BackwardBits {
  const uint8_t* data = nullptr;
  int64_t size = 0;
  int64_t position = 0;  // bits left to read

  BackwardBits(const uint8_t* bytes, int64_t length) : data(bytes), size(length) {
    if (length <= 0) fail("corrupt frame: empty bitstream");
    const uint8_t last = bytes[length - 1];
    if (last == 0) fail("corrupt frame: bitstream without its end marker");
    position = (length - 1) * 8 + highest_bit(last);
  }

  inline uint64_t peek(int count) const {
    if (count == 0) return 0;
    const int64_t low = position - count;
    if (low >= 0) {
      const int64_t byte = low >> 3;
      uint64_t word = 0;
      if (byte + 8 <= size) {
        std::memcpy(&word, data + byte, 8);
      } else {
        std::memcpy(&word, data + byte, size_t(size - byte));
      }
      return (word >> (low & 7)) & ((uint64_t(1) << count) - 1);
    }
    if (position <= 0) return 0;
    uint64_t word = 0;
    std::memcpy(&word, data, size_t(std::min<int64_t>(8, size)));
    word &= (uint64_t(1) << position) - 1;
    return (word << (-low)) & ((uint64_t(1) << count) - 1);
  }

  inline uint64_t read(int count) {
    const uint64_t value = peek(count);
    position -= count;
    return value;
  }
};

// A forward little-endian bitstream (FSE table descriptions).
struct ForwardBits {
  const uint8_t* data;
  int64_t size;
  int64_t position = 0;  // in bits

  ForwardBits(const uint8_t* bytes, int64_t length) : data(bytes), size(length) {}

  uint32_t read(int count) {
    uint32_t value = 0;
    for (int i = 0; i < count; ++i, ++position) {
      const int64_t byte = position >> 3;
      if (byte >= size) fail("corrupt frame: FSE table description overruns its block");
      value |= uint32_t((data[byte] >> (position & 7)) & 1) << i;
    }
    return value;
  }

  uint32_t peek(int count) {
    const int64_t saved = position;
    uint32_t value = 0;
    for (int i = 0; i < count; ++i) {
      const int64_t byte = (saved + i) >> 3;
      if (byte < size) value |= uint32_t((data[byte] >> ((saved + i) & 7)) & 1) << i;
    }
    return value;
  }

  int64_t bytes_used() const { return (position + 7) >> 3; }
};

// ---------------------------------------------------------------------------
// FSE.

constexpr int kMaxFseLog = 9;

struct FseEntry {
  uint16_t base;
  uint8_t symbol;
  uint8_t bits;
};

struct FseTable {
  int accuracy_log = 0;
  FseEntry entries[1 << kMaxFseLog];
  bool valid = false;

  void build(const int16_t* counts, int symbols, int log) {
    accuracy_log = log;
    const int size = 1 << log;
    int high = size - 1;
    uint16_t next[256];
    for (int s = 0; s < symbols; ++s) {
      if (counts[s] == -1) {
        entries[high--].symbol = uint8_t(s);
        next[s] = 1;
      } else {
        next[s] = uint16_t(counts[s]);
      }
    }
    const int step = (size >> 1) + (size >> 3) + 3;
    const int mask = size - 1;
    int position = 0;
    for (int s = 0; s < symbols; ++s) {
      for (int i = 0; i < counts[s]; ++i) {
        entries[position].symbol = uint8_t(s);
        do {
          position = (position + step) & mask;
        } while (position > high);
      }
    }
    if (position != 0) fail("corrupt frame: FSE distribution does not fill its table");
    for (int u = 0; u < size; ++u) {
      const int s = entries[u].symbol;
      const uint32_t state = next[s]++;
      const int bits = log - highest_bit(state);
      entries[u].bits = uint8_t(bits);
      entries[u].base = uint16_t((state << bits) - size);
    }
    valid = true;
  }

  void build_rle(uint8_t symbol) {
    accuracy_log = 0;
    entries[0] = FseEntry{0, symbol, 0};
    valid = true;
  }

  // Reads a table description; returns the bytes it took.
  int64_t read(const uint8_t* src, int64_t length, int max_symbol, int max_log) {
    if (length < 1) fail("corrupt frame: missing FSE table description");
    ForwardBits bits(src, length);
    const int log = int(bits.read(4)) + 5;
    if (log > max_log) fail("corrupt frame: FSE accuracy log " + std::to_string(log) + " above " + std::to_string(max_log));
    int16_t counts[256];
    int remaining = (1 << log) + 1;
    int threshold = 1 << log;
    int width = log + 1;
    int symbol = 0;
    while (remaining > 1) {
      if (symbol > max_symbol) fail("corrupt frame: FSE distribution has too many symbols");
      const uint32_t max = uint32_t(2 * threshold - 1 - remaining);
      int count;
      const uint32_t low = bits.peek(width - 1);
      if (low < max) {
        count = int(low);
        bits.position += width - 1;
      } else {
        count = int(bits.peek(width));
        if (count >= threshold) count -= int(max);
        bits.position += width;
      }
      count -= 1;  // the value is the probability plus one
      remaining -= count < 0 ? -count : count;
      counts[symbol++] = int16_t(count);
      if (count == 0) {
        while (true) {
          const uint32_t repeat = bits.read(2);
          for (uint32_t r = 0; r < repeat; ++r) {
            if (symbol > max_symbol) fail("corrupt frame: FSE zero run past the last symbol");
            counts[symbol++] = 0;
          }
          if (repeat != 3) break;
        }
      }
      while (remaining < threshold && threshold > 1) {
        --width;
        threshold >>= 1;
      }
    }
    if (remaining != 1) fail("corrupt frame: FSE probabilities do not sum to the table size");
    if (bits.bytes_used() > length) fail("corrupt frame: FSE table description overruns its block");
    build(counts, symbol, log);
    return bits.bytes_used();
  }
};

struct FseState {
  const FseTable* table;
  uint32_t state;
  void init(const FseTable& t, BackwardBits& bits) {
    table = &t;
    state = uint32_t(bits.read(t.accuracy_log));
  }
  inline uint8_t symbol() const { return table->entries[state].symbol; }
  inline void update(BackwardBits& bits) {
    const FseEntry& e = table->entries[state];
    state = e.base + uint32_t(bits.read(e.bits));
  }
};

// ---------------------------------------------------------------------------
// Huffman.

constexpr int kMaxHuffmanBits = 11;

struct HuffmanTable {
  int max_bits = 0;
  uint8_t symbols[1 << kMaxHuffmanBits];
  uint8_t lengths[1 << kMaxHuffmanBits];
  bool valid = false;

  // Reads the tree description; returns the bytes it took.
  int64_t read(const uint8_t* src, int64_t length) {
    if (length < 1) fail("corrupt frame: missing Huffman tree description");
    uint8_t weights[256];
    int count = 0;
    const uint8_t header = src[0];
    int64_t used;
    if (header >= 128) {
      count = header - 127;
      used = 1 + (count + 1) / 2;
      if (used > length) fail("corrupt frame: Huffman weights overrun the literals");
      for (int i = 0; i < count; ++i) {
        const uint8_t byte = src[1 + i / 2];
        weights[i] = (i & 1) ? (byte & 15) : (byte >> 4);
      }
    } else {
      used = 1 + header;
      if (used > length || header == 0) fail("corrupt frame: Huffman weights overrun the literals");
      FseTable table;
      const int64_t description = table.read(src + 1, header, 255, 6);
      BackwardBits bits(src + 1 + description, header - description);
      FseState first, second;
      first.init(table, bits);
      second.init(table, bits);
      while (true) {
        if (count > 254) fail("corrupt frame: too many Huffman weights");
        weights[count++] = first.symbol();
        first.update(bits);
        if (bits.position < 0) {
          weights[count++] = second.symbol();
          break;
        }
        if (count > 254) fail("corrupt frame: too many Huffman weights");
        weights[count++] = second.symbol();
        second.update(bits);
        if (bits.position < 0) {
          if (count > 254) fail("corrupt frame: too many Huffman weights");
          weights[count++] = first.symbol();
          break;
        }
      }
    }
    // The last symbol's weight is implied: it completes the sum to a power of 2.
    uint32_t total = 0;
    for (int i = 0; i < count; ++i) {
      if (weights[i] > kMaxHuffmanBits) fail("corrupt frame: Huffman weight above the maximum");
      if (weights[i] > 0) total += uint32_t(1) << (weights[i] - 1);
    }
    if (total == 0) fail("corrupt frame: Huffman weights all zero");
    max_bits = highest_bit(total) + 1;
    if (max_bits > kMaxHuffmanBits) fail("corrupt frame: Huffman code longer than 11 bits");
    const uint32_t left = (uint32_t(1) << max_bits) - total;
    if (left == 0 || (left & (left - 1)) != 0) fail("corrupt frame: Huffman weights do not complete a power of two");
    if (count > 255) fail("corrupt frame: too many Huffman weights");
    weights[count++] = uint8_t(highest_bit(left) + 1);
    // Codes in order of increasing weight, then symbol.
    uint32_t rank_count[kMaxHuffmanBits + 2] = {0};
    for (int i = 0; i < count; ++i) rank_count[weights[i]]++;
    uint32_t start[kMaxHuffmanBits + 2];
    uint32_t next = 0;
    for (int w = 1; w <= max_bits; ++w) {
      start[w] = next;
      next += rank_count[w] << (w - 1);
    }
    for (int s = 0; s < count; ++s) {
      const int w = weights[s];
      if (w == 0) continue;
      const uint32_t span = uint32_t(1) << (w - 1);
      const uint8_t bits = uint8_t(max_bits + 1 - w);
      for (uint32_t i = 0; i < span; ++i) {
        symbols[start[w] + i] = uint8_t(s);
        lengths[start[w] + i] = bits;
      }
      start[w] += span;
    }
    valid = true;
    return used;
  }

  // Decodes four symbols from one 64-bit load when at least 57 bits lie
  // below the read position (4 x 11 bits); returns false, reading nothing,
  // when fewer do.
  inline bool decode_four(BackwardBits& bits, uint8_t* out) const {
    const int64_t byte = ((bits.position + 7) >> 3) - 8;
    if (byte < 0) return false;
    uint64_t word;
    std::memcpy(&word, bits.data + byte, 8);
    word <<= 64 - (bits.position - byte * 8);
    const int shift = 64 - max_bits;
    int consumed = 0;
    for (int k = 0; k < 4; ++k) {
      const uint32_t index = uint32_t(word >> shift);
      out[k] = symbols[index];
      word <<= lengths[index];
      consumed += lengths[index];
    }
    bits.position -= consumed;
    return true;
  }

  // Decodes symbols [from, count) of one stream, then checks that the
  // stream was consumed exactly.
  void finish_stream(BackwardBits& bits, uint8_t* out, int64_t from, int64_t count) const {
    int64_t i = from;
    while (i + 4 <= count && decode_four(bits, out + i)) i += 4;
    for (; i < count; ++i) {
      const uint32_t index = uint32_t(bits.peek(max_bits));
      out[i] = symbols[index];
      bits.position -= lengths[index];
    }
    if (bits.position != 0) fail("corrupt frame: Huffman stream not consumed exactly");
  }

  void decode_stream(const uint8_t* src, int64_t length, uint8_t* out, int64_t count) const {
    BackwardBits bits(src, length);
    finish_stream(bits, out, 0, count);
  }

  // Four streams, interleaved while each has symbols and bits for a
  // four-symbol step (independent streams keep the core's pipelines full).
  void decode_four_streams(const uint8_t* const src[4], const int64_t length[4], uint8_t* const out[4],
                           const int64_t count[4]) const {
    BackwardBits bits[4] = {{src[0], length[0]}, {src[1], length[1]}, {src[2], length[2]}, {src[3], length[3]}};
    const int64_t shortest = std::min(std::min(count[0], count[1]), std::min(count[2], count[3]));
    int64_t i = 0;
    while (i + 4 <= shortest) {
      bool room = true;
      for (int k = 0; k < 4; ++k) room = room && ((bits[k].position + 7) >> 3) >= 8;
      if (!room) break;
      for (int k = 0; k < 4; ++k) decode_four(bits[k], out[k] + i);
      i += 4;
    }
    for (int k = 0; k < 4; ++k) finish_stream(bits[k], out[k], i, count[k]);
  }
};

// ---------------------------------------------------------------------------
// Output buffer: a caller's fixed buffer, or one grown with realloc.

struct Output {
  uint8_t* data = nullptr;
  size_t size = 0;
  size_t capacity = 0;
  bool owned = false;

  void reserve(size_t extra) {
    if (size + extra <= capacity) return;
    if (!owned) fail("corrupt frame: output larger than its declared content size");
    size_t grown = capacity ? capacity : size_t(1) << 16;
    while (grown < size + extra) grown *= 2;
    uint8_t* bigger = static_cast<uint8_t*>(std::realloc(data, grown));
    if (bigger == nullptr) fail("out of memory");
    data = bigger;
    capacity = grown;
  }
};

// ---------------------------------------------------------------------------
// Sequence codes.

constexpr uint32_t kLiteralBase[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,  11,   12,   13,   14,   15,   16,   18,
                                       20, 22, 24, 28, 32, 40, 48,  64,  128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLiteralBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  1,  1,
                                      1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMatchBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
                                     21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
                                     43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMatchBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,
                                    0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr int16_t kLiteralDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                         2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMatchDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  1,  1,  1,  1,  1,  1,
                                       1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOffsetDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                        1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ---------------------------------------------------------------------------
// Frames and blocks.

constexpr uint32_t kFrameMagic = 0xFD2FB528u;
constexpr size_t kMaxBlockSize = 128 * 1024;

struct FrameState {
  HuffmanTable huffman;
  FseTable literal_table, offset_table, match_table;
  uint32_t repeat[3] = {1, 4, 8};
  uint8_t literals[kMaxBlockSize + 32];
};

void read_table(FseTable& table, int mode, const uint8_t*& p, const uint8_t* end, const int16_t* defaults,
                int default_symbols, int default_log, int max_symbol, int max_log, const char* name) {
  switch (mode) {
    case 0:
      table.build(defaults, default_symbols, default_log);
      break;
    case 1:
      if (p >= end) fail(std::string("corrupt frame: missing RLE symbol of the ") + name + " codes");
      if (*p > max_symbol) fail(std::string("corrupt frame: RLE symbol out of range for the ") + name + " codes");
      table.build_rle(*p++);
      break;
    case 2:
      p += table.read(p, end - p, max_symbol, max_log);
      break;
    default:
      if (!table.valid) fail(std::string("corrupt frame: repeat mode without a previous table for the ") + name + " codes");
  }
}

void decode_compressed_block(FrameState& state, const uint8_t* src, size_t length, Output& out, size_t frame_start) {
  const uint8_t* p = src;
  const uint8_t* end = src + length;
  if (length < 1) fail("corrupt frame: empty compressed block");

  // Literals section.
  const int literal_type = p[0] & 3;
  const int size_format = (p[0] >> 2) & 3;
  size_t regenerated = 0;
  const uint8_t* literals = state.literals;
  if (literal_type <= 1) {
    size_t header;
    if ((size_format & 1) == 0) {
      regenerated = p[0] >> 3;
      header = 1;
    } else if (size_format == 1) {
      if (length < 2) fail("corrupt frame: truncated literals header");
      regenerated = (p[0] >> 4) + (size_t(p[1]) << 4);
      header = 2;
    } else {
      if (length < 3) fail("corrupt frame: truncated literals header");
      regenerated = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
      header = 3;
    }
    if (regenerated > kMaxBlockSize) fail("corrupt frame: literals larger than a block");
    p += header;
    if (literal_type == 0) {
      if (size_t(end - p) < regenerated) fail("corrupt frame: raw literals overrun the block");
      std::memcpy(state.literals, p, regenerated);
      p += regenerated;
    } else {
      if (p >= end) fail("corrupt frame: RLE literals overrun the block");
      std::memset(state.literals, *p, regenerated);
      p += 1;
    }
  } else {
    const int header = size_format <= 1 ? 3 : size_format + 2;
    const int field = size_format <= 1 ? 10 : (size_format == 2 ? 14 : 18);
    if (length < size_t(header)) fail("corrupt frame: truncated literals header");
    uint64_t value = 0;
    for (int i = 0; i < header; ++i) value |= uint64_t(p[i]) << (8 * i);
    regenerated = size_t((value >> 4) & ((1u << field) - 1));
    const size_t compressed = size_t((value >> (4 + field)) & ((1u << field) - 1));
    const bool single = size_format == 0;
    p += header;
    if (regenerated > kMaxBlockSize) fail("corrupt frame: literals larger than a block");
    if (size_t(end - p) < compressed) fail("corrupt frame: compressed literals overrun the block");
    const uint8_t* streams = p;
    size_t streams_length = compressed;
    if (literal_type == 2) {
      const int64_t used = state.huffman.read(p, int64_t(compressed));
      streams += used;
      streams_length -= size_t(used);
    } else if (!state.huffman.valid) {
      fail("corrupt frame: treeless literals without a previous Huffman table");
    }
    if (single) {
      state.huffman.decode_stream(streams, int64_t(streams_length), state.literals, int64_t(regenerated));
    } else {
      if (streams_length < 10) fail("corrupt frame: truncated Huffman jump table");
      const size_t s1 = streams[0] | (size_t(streams[1]) << 8);
      const size_t s2 = streams[2] | (size_t(streams[3]) << 8);
      const size_t s3 = streams[4] | (size_t(streams[5]) << 8);
      if (s1 + s2 + s3 + 6 > streams_length) fail("corrupt frame: Huffman jump table overruns the literals");
      const size_t s4 = streams_length - 6 - s1 - s2 - s3;
      const size_t quarter = (regenerated + 3) / 4;
      if (3 * quarter > regenerated) fail("corrupt frame: too few literals for four streams");
      const uint8_t* q = streams + 6;
      const uint8_t* const sources[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
      const int64_t lengths[4] = {int64_t(s1), int64_t(s2), int64_t(s3), int64_t(s4)};
      uint8_t* const outputs[4] = {state.literals, state.literals + quarter, state.literals + 2 * quarter,
                                   state.literals + 3 * quarter};
      const int64_t counts[4] = {int64_t(quarter), int64_t(quarter), int64_t(quarter), int64_t(regenerated - 3 * quarter)};
      state.huffman.decode_four_streams(sources, lengths, outputs, counts);
    }
    p += compressed;
  }

  // Sequences section.
  if (p >= end) fail("corrupt frame: missing sequences section");
  size_t sequences;
  if (p[0] < 128) {
    sequences = p[0];
    p += 1;
  } else if (p[0] < 255) {
    if (end - p < 2) fail("corrupt frame: truncated sequences header");
    sequences = (size_t(p[0] - 128) << 8) + p[1];
    p += 2;
  } else {
    if (end - p < 3) fail("corrupt frame: truncated sequences header");
    sequences = size_t(p[1]) + (size_t(p[2]) << 8) + 0x7F00;
    p += 3;
  }
  if (sequences == 0) {
    if (p != end) fail("corrupt frame: bytes after an empty sequences section");
    out.reserve(regenerated);
    std::memcpy(out.data + out.size, literals, regenerated);
    out.size += regenerated;
    return;
  }
  if (p >= end) fail("corrupt frame: missing symbol compression modes");
  const uint8_t modes = *p++;
  if (modes & 3) fail("corrupt frame: reserved bits of the symbol compression modes are set");
  read_table(state.literal_table, modes >> 6, p, end, kLiteralDefault, 36, 6, 35, 9, "literal length");
  read_table(state.offset_table, (modes >> 4) & 3, p, end, kOffsetDefault, 29, 5, 31, 8, "offset");
  read_table(state.match_table, (modes >> 2) & 3, p, end, kMatchDefault, 53, 6, 52, 9, "match length");
  if (p >= end) fail("corrupt frame: missing sequences bitstream");

  BackwardBits bits(p, end - p);
  FseState literal_state, offset_state, match_state;
  literal_state.init(state.literal_table, bits);
  offset_state.init(state.offset_table, bits);
  match_state.init(state.match_table, bits);

  size_t literal_position = 0;
  uint32_t* repeat = state.repeat;
  for (size_t n = 0; n < sequences; ++n) {
    const uint8_t offset_code = offset_state.symbol();
    const uint8_t literal_code = literal_state.symbol();
    const uint8_t match_code = match_state.symbol();
    if (literal_code > 35 || match_code > 52) fail("corrupt frame: sequence code out of range");
    if (offset_code > 31) fail("corrupt frame: offset code out of range");
    const uint64_t offset_value = (uint64_t(1) << offset_code) + bits.read(offset_code);
    const size_t match_length = kMatchBase[match_code] + size_t(bits.read(kMatchBits[match_code]));
    const size_t literal_length = kLiteralBase[literal_code] + size_t(bits.read(kLiteralBits[literal_code]));

    uint64_t offset;
    if (offset_value > 3) {
      offset = offset_value - 3;
      repeat[2] = repeat[1];
      repeat[1] = repeat[0];
      repeat[0] = uint32_t(offset);
    } else {
      const int index = int(offset_value) - 1 + (literal_length == 0 ? 1 : 0);
      if (index == 0) {
        offset = repeat[0];
      } else if (index == 1) {
        offset = repeat[1];
        repeat[1] = repeat[0];
        repeat[0] = uint32_t(offset);
      } else if (index == 2) {
        offset = repeat[2];
        repeat[2] = repeat[1];
        repeat[1] = repeat[0];
        repeat[0] = uint32_t(offset);
      } else {
        offset = uint64_t(repeat[0]) - 1;
        if (offset == 0) fail("corrupt frame: repeat offset of zero");
        repeat[2] = repeat[1];
        repeat[1] = repeat[0];
        repeat[0] = uint32_t(offset);
      }
    }

    if (n + 1 < sequences) {
      literal_state.update(bits);
      match_state.update(bits);
      offset_state.update(bits);
    }

    if (literal_position + literal_length > regenerated) fail("corrupt frame: sequence takes more literals than decoded");
    out.reserve(literal_length + match_length);
    std::memcpy(out.data + out.size, literals + literal_position, literal_length);
    out.size += literal_length;
    literal_position += literal_length;
    if (offset > out.size - frame_start) fail("corrupt frame: match offset reaches before the frame");
    uint8_t* dst = out.data + out.size;
    const uint8_t* match = dst - offset;
    if (offset >= match_length) {
      std::memcpy(dst, match, match_length);
    } else {
      for (size_t i = 0; i < match_length; ++i) dst[i] = match[i];
    }
    out.size += match_length;
  }
  if (bits.position != 0) fail("corrupt frame: sequences bitstream not consumed exactly");
  const size_t rest = regenerated - literal_position;
  out.reserve(rest);
  std::memcpy(out.data + out.size, literals + literal_position, rest);
  out.size += rest;
}

struct FrameHeader {
  bool skippable = false;
  size_t header_size = 0;
  size_t skip_size = 0;
  bool has_content_size = false;
  uint64_t content_size = 0;
  bool checksum = false;
};

FrameHeader parse_header(const uint8_t* src, size_t length) {
  FrameHeader header;
  if (length < 4) fail("corrupt frame: truncated magic number");
  const uint32_t magic = read_le32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
    if (length < 8) fail("corrupt frame: truncated skippable frame");
    header.skippable = true;
    header.skip_size = read_le32(src + 4);
    if (header.skip_size > length - 8) fail("corrupt frame: skippable frame overruns the input");
    header.header_size = 8;
    return header;
  }
  if (magic != kFrameMagic) fail("not a zstd frame: bad magic number");
  if (length < 5) fail("corrupt frame: truncated frame header");
  const uint8_t descriptor = src[4];
  const int content_flag = descriptor >> 6;
  const bool single_segment = (descriptor >> 5) & 1;
  if (descriptor & 8) fail("corrupt frame: reserved bit of the frame header is set");
  header.checksum = (descriptor >> 2) & 1;
  const int dictionary_flag = descriptor & 3;
  size_t position = 5 + (single_segment ? 0 : 1);
  const int dictionary_bytes = dictionary_flag == 3 ? 4 : dictionary_flag;
  const int content_bytes = content_flag == 0 ? (single_segment ? 1 : 0) : (1 << content_flag);
  if (length < position + dictionary_bytes + content_bytes) fail("corrupt frame: truncated frame header");
  uint32_t dictionary = 0;
  for (int i = 0; i < dictionary_bytes; ++i) dictionary |= uint32_t(src[position + i]) << (8 * i);
  if (dictionary != 0) fail("zstd frame needs dictionary " + std::to_string(dictionary) + "; dictionaries are not supported");
  position += dictionary_bytes;
  if (content_bytes > 0) {
    uint64_t size = 0;
    for (int i = 0; i < content_bytes; ++i) size |= uint64_t(src[position + i]) << (8 * i);
    if (content_bytes == 2) size += 256;
    header.has_content_size = true;
    header.content_size = size;
    position += content_bytes;
  }
  header.header_size = position;
  return header;
}

// Decodes every frame of `src` into `out`.
void decode_all(const uint8_t* src, size_t length, Output& out) {
  size_t position = 0;
  FrameState* state = nullptr;
  struct Guard {
    FrameState*& s;
    ~Guard() { delete s; }
  } guard{state};
  while (position < length) {
    const FrameHeader header = parse_header(src + position, length - position);
    position += header.header_size;
    if (header.skippable) {
      position += header.skip_size;
      continue;
    }
    if (state == nullptr) state = new FrameState();
    state->huffman.valid = false;
    state->literal_table.valid = state->offset_table.valid = state->match_table.valid = false;
    state->repeat[0] = 1;
    state->repeat[1] = 4;
    state->repeat[2] = 8;
    const size_t frame_start = out.size;
    if (header.has_content_size) out.reserve(size_t(header.content_size));
    bool last = false;
    while (!last) {
      if (length - position < 3) fail("corrupt frame: truncated block header");
      const uint32_t block = uint32_t(src[position]) | (uint32_t(src[position + 1]) << 8) | (uint32_t(src[position + 2]) << 16);
      position += 3;
      last = block & 1;
      const int type = (block >> 1) & 3;
      const size_t size = block >> 3;
      if (type == 1) {
        if (position >= length) fail("corrupt frame: truncated RLE block");
        out.reserve(size);
        std::memset(out.data + out.size, src[position], size);
        out.size += size;
        position += 1;
        continue;
      }
      if (size > length - position) fail("corrupt frame: block overruns the input");
      if (type == 0) {
        out.reserve(size);
        std::memcpy(out.data + out.size, src + position, size);
        out.size += size;
      } else if (type == 2) {
        if (size > kMaxBlockSize) fail("corrupt frame: compressed block above 128 KiB");
        decode_compressed_block(*state, src + position, size, out, frame_start);
      } else {
        fail("corrupt frame: reserved block type");
      }
      position += size;
    }
    const size_t produced = out.size - frame_start;
    if (header.has_content_size && produced != header.content_size) {
      fail("corrupt frame: decoded " + std::to_string(produced) + " bytes, header says " +
           std::to_string(header.content_size));
    }
    if (header.checksum) {
      if (length - position < 4) fail("corrupt frame: truncated content checksum");
      const uint32_t expected = read_le32(src + position);
      const uint32_t actual = uint32_t(xxh64(out.data + frame_start, produced));
      if (expected != actual) fail("zstd content checksum mismatch");
      position += 4;
    }
  }
}

}  // namespace

extern "C" {

// The total decoded size declared by the frames' headers, or -1 when a frame
// does not declare it, or -2 on malformed input (see allophant_zstd_error).
int64_t allophant_zstd_content_size(const uint8_t* src, int64_t length) {
  try {
    size_t position = 0;
    int64_t total = 0;
    while (position < size_t(length)) {
      const FrameHeader header = parse_header(src + position, size_t(length) - position);
      if (header.skippable) {
        position += header.header_size + header.skip_size;
        continue;
      }
      if (!header.has_content_size) return -1;
      total += int64_t(header.content_size);
      position += header.header_size;
      // Walk the blocks to find the next frame.
      bool last = false;
      while (!last) {
        if (size_t(length) - position < 3) fail("corrupt frame: truncated block header");
        const uint32_t block = uint32_t(src[position]) | (uint32_t(src[position + 1]) << 8) | (uint32_t(src[position + 2]) << 16);
        position += 3;
        last = block & 1;
        const size_t size = ((block >> 1) & 3) == 1 ? 1 : size_t(block >> 3);
        if (size > size_t(length) - position) fail("corrupt frame: block overruns the input");
        position += size;
      }
      if (header.checksum) position += 4;
    }
    return total;
  } catch (const std::exception& error) {
    last_error = error.what();
    return -2;
  }
}

// Decodes all frames of `src` into `dst` (capacity `capacity`). Returns the
// bytes written, or -1 on error (see allophant_zstd_error).
int64_t allophant_zstd_decompress(const uint8_t* src, int64_t length, uint8_t* dst, int64_t capacity) {
  Output out;
  out.data = dst;
  out.capacity = size_t(capacity);
  try {
    decode_all(src, size_t(length), out);
    return int64_t(out.size);
  } catch (const std::exception& error) {
    last_error = error.what();
    return -1;
  }
}

// Decodes all frames of `src` into a buffer grown as needed; the caller frees
// it with allophant_zstd_free. Returns nullptr on error.
uint8_t* allophant_zstd_decompress_grown(const uint8_t* src, int64_t length, int64_t* produced) {
  Output out;
  out.owned = true;
  try {
    decode_all(src, size_t(length), out);
    *produced = int64_t(out.size);
    if (out.data == nullptr) out.data = static_cast<uint8_t*>(std::malloc(1));
    return out.data;
  } catch (const std::exception& error) {
    std::free(out.data);
    last_error = error.what();
    return nullptr;
  }
}

void allophant_zstd_free(uint8_t* buffer) { std::free(buffer); }

const char* allophant_zstd_error(void) { return last_error.c_str(); }

}  // extern "C"
