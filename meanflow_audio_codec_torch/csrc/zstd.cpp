// zstd frame decoder (RFC 8878) and CRC32C, behind a plain C interface.
//
// Orbax checkpoints store every zarr chunk and every OCDBT node as a zstd
// frame; this library reads them without libzstd. It decodes whole frames
// into a buffer the caller sizes:
//
//   * frames: magic 0xFD2FB528 and skippable frames 0x184D2A5?, the frame
//     header descriptor, window descriptor, single-segment flag, a content
//     size of 0/1/2/4/8 bytes (checked against what the frame decodes to)
//     and the XXH64 content checksum (checked when its flag is set); a
//     dictionary ID other than 0 is refused, orbax uses none;
//   * blocks: raw, RLE and compressed, up to 128 KiB;
//   * literals: raw, RLE, Huffman with 1 or 4 streams (6-byte jump table)
//     and treeless (the previous table), the tree given by FSE-compressed
//     or direct 4-bit weights;
//   * sequences: literal-length, offset and match-length codes in
//     predefined, RLE, FSE-compressed and repeat modes, the repeat offsets
//     with their literal-length-0 rule, matches reaching back across the
//     blocks of a frame;
//   * concatenated frames decode one after another into the same buffer.
//
// Every read is bounds-checked: malformed or truncated input returns a
// negative code (zstd_error_name gives its meaning) and never reads or
// writes outside the buffers it was given.
//
// C interface:
//   long long zstd_decompress(src, n, dst, cap)  decoded size or a code < 0
//   long long zstd_content_size(src, n)          the frames' declared total
//                                                size, -1 when one frame
//                                                declares none, or a code
//   const char* zstd_error_name(code)
//   unsigned zstd_crc32c(data, n, crc)           CRC32C (Castagnoli),
//                                                chained through crc (0 to
//                                                start)

#include <cstdint>
#include <cstring>

namespace {

enum Error : int {
    kTruncated = -1,
    kBadMagic = -2,
    kBadHeader = -3,
    kDictionary = -4,
    kDstTooSmall = -5,
    kCorrupt = -6,
    kChecksum = -7,
    kContentSize = -8,
    kBlockTooLarge = -9,
    kBadTable = -10,
    kBadHuffman = -11,
    kBadOffset = -12,
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint32_t kSkippableMask = 0xFFFFFFF0u;
constexpr uint32_t kSkippableMagic = 0x184D2A50u;
constexpr size_t kBlockMax = 128 * 1024;
constexpr int kHufMaxBits = 11;

inline uint32_t read_le(const uint8_t* p, int bytes) {
    uint32_t v = 0;
    for (int i = 0; i < bytes; ++i) v |= uint32_t(p[i]) << (8 * i);
    return v;
}

inline uint64_t read_le64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;  // little-endian hosts only (x86-64, aarch64)
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// Bit readers
// ---------------------------------------------------------------------------

// Forward bit reader, least significant bit first (FSE table headers).
struct ForwardBits {
    const uint8_t* data;
    size_t size;
    uint64_t pos = 0;  // in bits

    uint32_t read(int n) {  // bits past the end read as zeros
        uint32_t v = 0;
        for (int i = 0; i < n; ++i, ++pos) {
            size_t byte = pos >> 3;
            if (byte < size) v |= uint32_t((data[byte] >> (pos & 7)) & 1) << i;
        }
        return v;
    }
};

// Backward bit reader: the stream is read from its last bit towards its
// first, the last byte's highest set bit marking where it starts. ``pos``
// counts the bits still unread; reading past the first bit gives zeros
// and leaves ``pos`` negative (an overflow the callers check).
struct BackwardBits {
    const uint8_t* data = nullptr;
    size_t size = 0;
    int64_t pos = 0;

    int init(const uint8_t* p, size_t n) {
        if (n == 0) return kCorrupt;
        uint8_t last = p[n - 1];
        if (last == 0) return kCorrupt;
        data = p;
        size = n;
        pos = int64_t(8) * int64_t(n - 1) + highbit(last);
        return 0;
    }

    // The n (<= 56) bits below ``pos`` as a number, without consuming them.
    uint64_t peek(int n) const {
        if (n == 0) return 0;
        int64_t lo = pos - n;
        if (lo >= 0) {
            size_t byte = size_t(lo >> 3);
            uint64_t word;
            if (byte + 8 <= size) {
                word = read_le64(data + byte);
            } else {
                word = 0;
                for (size_t i = byte; i < size && i < byte + 8; ++i)
                    word |= uint64_t(data[i]) << (8 * (i - byte));
            }
            return (word >> (lo & 7)) & ((uint64_t(1) << n) - 1);
        }
        // fewer than n bits left: the missing low bits are zeros
        if (pos <= 0) return 0;
        int have = int(pos);
        uint64_t word = 0;
        for (size_t i = 0; i < size && i < 8; ++i)
            word |= uint64_t(data[i]) << (8 * i);
        return (word & ((uint64_t(1) << have) - 1)) << (n - have);
    }

    uint64_t read(int n) {
        uint64_t v = peek(n);
        pos -= n;
        return v;
    }
};

// ---------------------------------------------------------------------------
// FSE
// ---------------------------------------------------------------------------

struct FseEntry {
    uint16_t baseline;
    uint8_t symbol;
    uint8_t bits;
};

struct FseTable {
    int log = 0;
    FseEntry entries[1 << 9];
};

// Read a normalized-count table description; returns the bytes it took
// or a code < 0. ``counts`` gets max_symbol + 1 entries (-1: "less than
// one"), ``symbols`` how many were given.
int read_fse_counts(const uint8_t* p, size_t n, int max_log, int max_symbol,
                    int16_t* counts, int* symbols, int* log_out) {
    if (n == 0) return kTruncated;
    ForwardBits bits{p, n};
    int log = int(bits.read(4)) + 5;
    if (log > max_log) return kBadTable;
    int remaining = (1 << log) + 1;
    int threshold = 1 << log;
    int nbits = log + 1;
    int symbol = 0;
    while (remaining > 1) {
        if (symbol > max_symbol) return kBadTable;
        int max = (2 * threshold - 1) - remaining;
        int count;
        uint32_t low = bits.read(nbits - 1);
        if (int(low) < max) {
            count = int(low);
        } else {
            uint32_t high = bits.read(1);
            count = int(low | (high << (nbits - 1)));
            if (count >= threshold) count -= max;
        }
        count -= 1;  // -1 stands for a probability "less than one"
        remaining -= count < 0 ? -count : count;
        counts[symbol++] = int16_t(count);
        if (count == 0) {  // runs of zero counts: 2-bit repeat flags
            for (;;) {
                uint32_t repeat = bits.read(2);
                for (uint32_t i = 0; i < repeat; ++i) {
                    if (symbol > max_symbol) return kBadTable;
                    counts[symbol++] = 0;
                }
                if (repeat != 3) break;
            }
        }
        while (remaining < threshold && threshold > 1) {
            --nbits;
            threshold >>= 1;
        }
    }
    if (remaining != 1) return kBadTable;
    size_t used = size_t((bits.pos + 7) >> 3);
    if (used > n) return kTruncated;
    *symbols = symbol;
    *log_out = log;
    return int(used);
}

int build_fse(FseTable& table, const int16_t* counts, int symbols, int log) {
    int size = 1 << log;
    int high = size - 1;
    uint16_t next[256];
    for (int s = 0; s < symbols; ++s) {
        if (counts[s] == -1) {
            if (high < 0) return kBadTable;
            table.entries[high--].symbol = uint8_t(s);
            next[s] = 1;
        } else {
            next[s] = uint16_t(counts[s]);
        }
    }
    int step = (size >> 1) + (size >> 3) + 3;
    int mask = size - 1;
    int pos = 0;
    for (int s = 0; s < symbols; ++s) {
        for (int i = 0; i < counts[s]; ++i) {
            table.entries[pos].symbol = uint8_t(s);
            do {
                pos = (pos + step) & mask;
            } while (pos > high);
        }
    }
    if (pos != 0) return kBadTable;
    for (int u = 0; u < size; ++u) {
        uint8_t s = table.entries[u].symbol;
        uint32_t state = next[s]++;
        if (state == 0) return kBadTable;
        int bits = log - highbit(state);
        table.entries[u].bits = uint8_t(bits);
        table.entries[u].baseline = uint16_t((state << bits) - size);
    }
    table.log = log;
    return 0;
}

void build_rle(FseTable& table, uint8_t symbol) {
    table.log = 0;
    table.entries[0] = FseEntry{0, symbol, 0};
}

// ---------------------------------------------------------------------------
// Huffman literals
// ---------------------------------------------------------------------------

struct HufEntry {
    uint8_t symbol;
    uint8_t bits;
};

struct HufTable {
    int max_bits = 0;  // 0: no table yet
    HufEntry entries[1 << kHufMaxBits];
};

// Decode the Huffman weights (FSE-compressed or direct) and build the
// table; returns the bytes the description took or a code < 0.
int read_huffman_tree(const uint8_t* p, size_t n, HufTable& table) {
    if (n < 1) return kTruncated;
    uint8_t weights[258];
    int count = 0;
    size_t used;
    uint8_t header = p[0];
    if (header >= 128) {  // direct 4-bit weights
        count = header - 127;
        used = 1 + size_t((count + 1) / 2);
        if (used > n) return kTruncated;
        for (int i = 0; i < count; ++i) {
            uint8_t byte = p[1 + i / 2];
            weights[i] = (i % 2 == 0) ? (byte >> 4) : (byte & 15);
        }
    } else {  // FSE-compressed weights, two interleaved states
        size_t size = header;
        used = 1 + size;
        if (used > n || size == 0) return kTruncated;
        int16_t counts[256];
        int symbols = 0, log = 0;
        int head = read_fse_counts(p + 1, size, 6, 255, counts, &symbols,
                                   &log);
        if (head < 0) return head;
        static thread_local FseTable fse;
        int err = build_fse(fse, counts, symbols, log);
        if (err < 0) return err;
        BackwardBits bits;
        if (size_t(head) >= size) return kCorrupt;
        if (bits.init(p + 1 + head, size - size_t(head)) < 0) return kCorrupt;
        uint32_t s1 = uint32_t(bits.read(log));
        uint32_t s2 = uint32_t(bits.read(log));
        if (bits.pos < 0) return kCorrupt;
        for (;;) {
            if (count > 254) return kBadHuffman;
            const FseEntry& e1 = fse.entries[s1];
            weights[count++] = e1.symbol;
            s1 = e1.baseline + uint32_t(bits.read(e1.bits));
            if (bits.pos < 0) {
                weights[count++] = fse.entries[s2].symbol;
                break;
            }
            if (count > 254) return kBadHuffman;
            const FseEntry& e2 = fse.entries[s2];
            weights[count++] = e2.symbol;
            s2 = e2.baseline + uint32_t(bits.read(e2.bits));
            if (bits.pos < 0) {
                weights[count++] = fse.entries[s1].symbol;
                break;
            }
        }
    }
    if (count > 255) return kBadHuffman;
    // the last weight is implied: it completes the sum to a power of two
    uint32_t total = 0;
    for (int i = 0; i < count; ++i) {
        if (weights[i] > kHufMaxBits) return kBadHuffman;
        if (weights[i]) total += 1u << (weights[i] - 1);
    }
    if (total == 0) return kBadHuffman;
    int max_bits = highbit(total) + 1;
    if (max_bits > kHufMaxBits) return kBadHuffman;
    uint32_t rest = (1u << max_bits) - total;
    if (rest & (rest - 1)) return kBadHuffman;  // not a power of two
    weights[count++] = uint8_t(highbit(rest) + 1);
    // codes in order of increasing weight, symbols in order within one
    uint32_t pos = 0;
    for (int w = 1; w <= max_bits; ++w) {
        for (int s = 0; s < count; ++s) {
            if (weights[s] != w) continue;
            uint32_t span = 1u << (w - 1);
            if (pos + span > (1u << max_bits)) return kBadHuffman;
            for (uint32_t i = 0; i < span; ++i)
                table.entries[pos + i] = HufEntry{uint8_t(s),
                                                  uint8_t(max_bits + 1 - w)};
            pos += span;
        }
    }
    if (pos != (1u << max_bits)) return kBadHuffman;
    table.max_bits = max_bits;
    return int(used);
}

// A Huffman stream copied between 8 zero bytes on either side, so that
// every peek is one unaligned load: bits below the stream's first bit
// read as the zeros the format gives them.
struct PaddedBits {
    const uint8_t* data;  // the stream's first byte, 8 zero bytes before
    int64_t pos;

    inline uint64_t peek(int n) const {
        int64_t lo = pos - n;  // >= -kHufMaxBits while decoding
        uint64_t word = read_le64(data + (lo >> 3));
        return (word >> (lo & 7)) & ((uint64_t(1) << n) - 1);
    }
};

constexpr size_t kPad = 8;

// Decode ``count`` symbols of each stream, the streams side by side: their
// chains of bit reads are independent, so the core overlaps them.
int decode_huffman_streams(const HufTable& table, const uint8_t* data,
                           const size_t* sizes, uint8_t* out,
                           const size_t* counts, int streams) {
    static thread_local uint8_t padded[kBlockMax + 4 * (2 * kPad)];
    PaddedBits bits[4];
    uint8_t* dst[4];
    size_t offset = 0, written = 0, at = 0;
    for (int i = 0; i < streams; ++i) {
        BackwardBits check;
        if (check.init(data + offset, sizes[i]) < 0) return kCorrupt;
        if (at + sizes[i] + 2 * kPad > sizeof(padded)) return kCorrupt;
        std::memset(padded + at, 0, kPad);
        std::memcpy(padded + at + kPad, data + offset, sizes[i]);
        std::memset(padded + at + kPad + sizes[i], 0, kPad);
        bits[i] = PaddedBits{padded + at + kPad, check.pos};
        at += sizes[i] + 2 * kPad;
        offset += sizes[i];
        dst[i] = out + written;
        written += counts[i];
    }
    const int max_bits = table.max_bits;
    size_t shared = counts[streams - 1];  // the last stream is the shortest
    if (streams == 4) {
        for (size_t k = 0; k < shared; ++k) {
            for (int i = 0; i < 4; ++i) {
                const HufEntry& e = table.entries[bits[i].peek(max_bits)];
                dst[i][k] = e.symbol;
                bits[i].pos -= e.bits;
            }
            if ((bits[0].pos | bits[1].pos | bits[2].pos | bits[3].pos) < 0)
                return kCorrupt;
        }
    } else {
        shared = 0;
    }
    for (int i = 0; i < streams; ++i) {
        for (size_t k = shared; k < counts[i]; ++k) {
            const HufEntry& e = table.entries[bits[i].peek(max_bits)];
            dst[i][k] = e.symbol;
            bits[i].pos -= e.bits;
            if (bits[i].pos < 0) return kCorrupt;
        }
        if (bits[i].pos != 0) return kCorrupt;
    }
    return 0;
}

// ---------------------------------------------------------------------------
// Sequences
// ---------------------------------------------------------------------------

constexpr uint32_t kLLBase[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22, 24,
    28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
    65536};
constexpr uint8_t kLLBits[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
    4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41, 43, 47,
    51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771,
    65539};
constexpr uint8_t kMLBits[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
    12, 13, 14, 15, 16};
constexpr int16_t kLLDefault[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
    -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    -1, -1, -1, -1, -1};

// What a frame carries from one block to the next.
struct FrameState {
    HufTable huffman;
    FseTable ll, of, ml;
    bool have_ll = false, have_of = false, have_ml = false;
    uint32_t rep[3] = {1, 4, 8};
    uint8_t literals[kBlockMax];
};

// Read one table of the sequences section by its mode; returns the bytes
// the description took or a code < 0.
int read_sequence_table(int mode, const uint8_t* p, size_t n, FseTable& table,
                        bool& have, const int16_t* defaults, int default_count,
                        int default_log, int max_log, int max_symbol) {
    switch (mode) {
        case 0: {
            int err = build_fse(table, defaults, default_count, default_log);
            if (err < 0) return err;
            have = true;
            return 0;
        }
        case 1:
            if (n < 1) return kTruncated;
            if (p[0] > max_symbol) return kBadTable;
            build_rle(table, p[0]);
            have = true;
            return 1;
        case 2: {
            int16_t counts[256];
            int symbols = 0, log = 0;
            int used = read_fse_counts(p, n, max_log, max_symbol, counts,
                                       &symbols, &log);
            if (used < 0) return used;
            int err = build_fse(table, counts, symbols, log);
            if (err < 0) return err;
            have = true;
            return used;
        }
        default:  // repeat: the previous block's table
            return have ? 0 : kBadTable;
    }
}

// ---------------------------------------------------------------------------
// Blocks and frames
// ---------------------------------------------------------------------------

struct Output {
    uint8_t* dst;
    size_t cap;
    size_t pos;          // bytes written so far
    size_t frame_start;  // where the current frame's content starts
};

int decode_literals(const uint8_t* p, size_t n, FrameState& fs,
                    size_t* literal_count) {
    if (n < 1) return kTruncated;
    int type = p[0] & 3;
    int format = (p[0] >> 2) & 3;
    if (type <= 1) {  // raw or RLE
        size_t size, header;
        if ((format & 1) == 0) {
            header = 1;
            size = p[0] >> 3;
        } else if (format == 1) {
            header = 2;
            if (n < 2) return kTruncated;
            size = (p[0] >> 4) + (size_t(p[1]) << 4);
        } else {
            header = 3;
            if (n < 3) return kTruncated;
            size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
        }
        if (size > kBlockMax) return kCorrupt;
        if (type == 0) {
            if (header + size > n) return kTruncated;
            std::memcpy(fs.literals, p + header, size);
            *literal_count = size;
            return int(header + size);
        }
        if (header + 1 > n) return kTruncated;
        std::memset(fs.literals, p[header], size);
        *literal_count = size;
        return int(header + 1);
    }
    // Huffman-compressed (type 2) or treeless (type 3)
    size_t header, regen, comp;
    int streams = format == 0 ? 1 : 4;
    if (format <= 1) {
        header = 3;
        if (n < 3) return kTruncated;
        uint32_t h = read_le(p, 3);
        regen = (h >> 4) & 0x3FF;
        comp = (h >> 14) & 0x3FF;
    } else if (format == 2) {
        header = 4;
        if (n < 4) return kTruncated;
        uint32_t h = read_le(p, 4);
        regen = (h >> 4) & 0x3FFF;
        comp = (h >> 18) & 0x3FFF;
    } else {
        header = 5;
        if (n < 5) return kTruncated;
        uint64_t h = read_le(p, 4) | (uint64_t(p[4]) << 32);
        regen = (h >> 4) & 0x3FFFF;
        comp = (h >> 22) & 0x3FFFF;
    }
    if (regen > kBlockMax) return kCorrupt;
    if (header + comp > n) return kTruncated;
    const uint8_t* q = p + header;
    size_t left = comp;
    if (type == 2) {
        int used = read_huffman_tree(q, left, fs.huffman);
        if (used < 0) return used;
        q += used;
        left -= size_t(used);
    } else if (fs.huffman.max_bits == 0) {
        return kBadHuffman;  // treeless with no previous table
    }
    if (streams == 1) {
        int err = decode_huffman_streams(fs.huffman, q, &left, fs.literals,
                                         &regen, 1);
        if (err < 0) return err;
    } else {
        if (left < 6) return kTruncated;
        size_t s1 = read_le(q, 2), s2 = read_le(q + 2, 2),
               s3 = read_le(q + 4, 2);
        if (6 + s1 + s2 + s3 > left) return kCorrupt;
        size_t s4 = left - 6 - s1 - s2 - s3;
        size_t quarter = (regen + 3) / 4;
        if (3 * quarter > regen) return kCorrupt;
        const uint8_t* data = q + 6;
        const size_t sizes[4] = {s1, s2, s3, s4};
        const size_t counts[4] = {quarter, quarter, quarter,
                                  regen - 3 * quarter};
        int err = decode_huffman_streams(fs.huffman, data, sizes,
                                         fs.literals, counts, 4);
        if (err < 0) return err;
    }
    *literal_count = regen;
    return int(header + comp);
}

int decode_compressed_block(const uint8_t* p, size_t n, FrameState& fs,
                            Output& out) {
    size_t literal_count = 0;
    int used = decode_literals(p, n, fs, &literal_count);
    if (used < 0) return used;
    const uint8_t* q = p + used;
    size_t left = n - size_t(used);
    size_t block_start = out.pos;
    // number of sequences
    if (left < 1) return kTruncated;
    size_t sequences;
    if (q[0] < 128) {
        sequences = q[0];
        q += 1;
        left -= 1;
    } else if (q[0] < 255) {
        if (left < 2) return kTruncated;
        sequences = (size_t(q[0] - 128) << 8) + q[1];
        q += 2;
        left -= 2;
    } else {
        if (left < 3) return kTruncated;
        sequences = q[1] + (size_t(q[2]) << 8) + 0x7F00;
        q += 3;
        left -= 3;
    }
    size_t lit = 0;
    if (sequences > 0) {
        if (left < 1) return kTruncated;
        uint8_t modes = q[0];
        if (modes & 3) return kCorrupt;
        q += 1;
        left -= 1;
        int r = read_sequence_table(modes >> 6, q, left, fs.ll, fs.have_ll,
                                    kLLDefault, 36, 6, 9, 35);
        if (r < 0) return r;
        q += r;
        left -= size_t(r);
        r = read_sequence_table((modes >> 4) & 3, q, left, fs.of, fs.have_of,
                                kOFDefault, 29, 5, 8, 31);
        if (r < 0) return r;
        q += r;
        left -= size_t(r);
        r = read_sequence_table((modes >> 2) & 3, q, left, fs.ml, fs.have_ml,
                                kMLDefault, 53, 6, 9, 52);
        if (r < 0) return r;
        q += r;
        left -= size_t(r);
        BackwardBits bits;
        if (bits.init(q, left) < 0) return kCorrupt;
        uint32_t ll_state = uint32_t(bits.read(fs.ll.log));
        uint32_t of_state = uint32_t(bits.read(fs.of.log));
        uint32_t ml_state = uint32_t(bits.read(fs.ml.log));
        if (bits.pos < 0) return kCorrupt;
        uint32_t* rep = fs.rep;
        for (size_t i = 0; i < sequences; ++i) {
            const FseEntry& lle = fs.ll.entries[ll_state];
            const FseEntry& ofe = fs.of.entries[of_state];
            const FseEntry& mle = fs.ml.entries[ml_state];
            int of_code = ofe.symbol;
            if (of_code > 31 || mle.symbol > 52 || lle.symbol > 35)
                return kCorrupt;
            uint64_t offset_value = (uint64_t(1) << of_code)
                                    + bits.read(of_code);
            size_t match = kMLBase[mle.symbol] + bits.read(kMLBits[mle.symbol]);
            size_t literals = kLLBase[lle.symbol]
                              + bits.read(kLLBits[lle.symbol]);
            if (i + 1 < sequences) {
                ll_state = lle.baseline + uint32_t(bits.read(lle.bits));
                ml_state = mle.baseline + uint32_t(bits.read(mle.bits));
                of_state = ofe.baseline + uint32_t(bits.read(ofe.bits));
            }
            if (bits.pos < 0) return kCorrupt;
            uint64_t offset;
            if (offset_value > 3) {
                offset = offset_value - 3;
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = uint32_t(offset);
            } else {
                uint64_t v = offset_value + (literals == 0 ? 1 : 0);
                if (v == 1) {
                    offset = rep[0];
                } else if (v == 2) {
                    offset = rep[1];
                    rep[1] = rep[0];
                    rep[0] = uint32_t(offset);
                } else if (v == 3) {
                    offset = rep[2];
                    rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = uint32_t(offset);
                } else {
                    offset = uint64_t(rep[0]) - 1;
                    rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = uint32_t(offset);
                }
            }
            // literals, then the match
            if (literals > literal_count - lit) return kCorrupt;
            if (literals + match > out.cap - out.pos) return kDstTooSmall;
            std::memcpy(out.dst + out.pos, fs.literals + lit, literals);
            out.pos += literals;
            lit += literals;
            if (offset == 0 || offset > out.pos - out.frame_start)
                return kBadOffset;
            uint8_t* d = out.dst + out.pos;
            const uint8_t* s = d - offset;
            if (offset >= match) {
                std::memcpy(d, s, match);
            } else {
                for (size_t k = 0; k < match; ++k) d[k] = s[k];
            }
            out.pos += match;
            if (out.pos - block_start > kBlockMax) return kBlockTooLarge;
        }
        if (bits.pos != 0) return kCorrupt;
    } else if (left != 0) {
        return kCorrupt;
    }
    size_t rest = literal_count - lit;
    if (rest > out.cap - out.pos) return kDstTooSmall;
    std::memcpy(out.dst + out.pos, fs.literals + lit, rest);
    out.pos += rest;
    if (out.pos - block_start > kBlockMax) return kBlockTooLarge;
    return 0;
}

// ---------------------------------------------------------------------------
// XXH64 (the content checksum keeps its low 32 bits)
// ---------------------------------------------------------------------------

constexpr uint64_t kP1 = 11400714785074694791ULL;
constexpr uint64_t kP2 = 14029467366897019727ULL;
constexpr uint64_t kP3 = 1609587929392839161ULL;
constexpr uint64_t kP4 = 9650029242287828579ULL;
constexpr uint64_t kP5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t xxh_round(uint64_t acc, uint64_t input) {
    acc += input * kP2;
    acc = rotl(acc, 31);
    return acc * kP1;
}

inline uint64_t xxh_merge(uint64_t acc, uint64_t v) {
    acc ^= xxh_round(0, v);
    return acc * kP1 + kP4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
        uint64_t v1 = kP1 + kP2, v2 = kP2, v3 = 0, v4 = 0 - kP1;
        const uint8_t* limit = end - 32;
        do {
            v1 = xxh_round(v1, read_le64(p));
            v2 = xxh_round(v2, read_le64(p + 8));
            v3 = xxh_round(v3, read_le64(p + 16));
            v4 = xxh_round(v4, read_le64(p + 24));
            p += 32;
        } while (p <= limit);
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xxh_merge(h, v1);
        h = xxh_merge(h, v2);
        h = xxh_merge(h, v3);
        h = xxh_merge(h, v4);
    } else {
        h = kP5;
    }
    h += uint64_t(n);
    while (p + 8 <= end) {
        h ^= xxh_round(0, read_le64(p));
        h = rotl(h, 27) * kP1 + kP4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= uint64_t(read_le(p, 4)) * kP1;
        h = rotl(h, 23) * kP2 + kP3;
        p += 4;
    }
    while (p < end) {
        h ^= uint64_t(*p) * kP5;
        h = rotl(h, 11) * kP1;
        ++p;
    }
    h ^= h >> 33;
    h *= kP2;
    h ^= h >> 29;
    h *= kP3;
    h ^= h >> 32;
    return h;
}

// ---------------------------------------------------------------------------
// Frames
// ---------------------------------------------------------------------------

struct FrameHeader {
    size_t size;            // bytes of the header, magic included
    bool has_content_size;
    uint64_t content_size;
    bool checksum;
};

int read_frame_header(const uint8_t* p, size_t n, FrameHeader& h) {
    if (n < 5) return kTruncated;
    uint8_t fhd = p[4];
    int fcs_flag = fhd >> 6;
    bool single = (fhd >> 5) & 1;
    if (fhd & 0x08) return kBadHeader;  // reserved bit
    h.checksum = (fhd >> 2) & 1;
    static const int kDictBytes[4] = {0, 1, 2, 4};
    static const int kContentBytes[4] = {0, 2, 4, 8};
    int dict_bytes = kDictBytes[fhd & 3];
    int fcs_bytes = fcs_flag == 0 && single ? 1 : kContentBytes[fcs_flag];
    size_t pos = 5;
    if (!single) pos += 1;  // window descriptor: the caller sizes dst
    if (n < pos + size_t(dict_bytes) + size_t(fcs_bytes)) return kTruncated;
    if (dict_bytes && read_le(p + pos, dict_bytes) != 0) return kDictionary;
    pos += size_t(dict_bytes);
    h.has_content_size = fcs_bytes > 0;
    h.content_size = 0;
    if (fcs_bytes == 8) {
        h.content_size = read_le64(p + pos);
    } else if (fcs_bytes > 0) {
        h.content_size = read_le(p + pos, fcs_bytes);
        if (fcs_bytes == 2) h.content_size += 256;
    }
    pos += size_t(fcs_bytes);
    h.size = pos;
    return 0;
}

// Decode one frame at ``p``; returns the bytes of input it took.
long long decode_frame(const uint8_t* p, size_t n, Output& out,
                       FrameState& fs) {
    FrameHeader h;
    int err = read_frame_header(p, n, h);
    if (err < 0) return err;
    size_t pos = h.size;
    out.frame_start = out.pos;
    fs.huffman.max_bits = 0;
    fs.have_ll = fs.have_of = fs.have_ml = false;
    fs.rep[0] = 1;
    fs.rep[1] = 4;
    fs.rep[2] = 8;
    for (;;) {
        if (n - pos < 3) return kTruncated;
        uint32_t header = read_le(p + pos, 3);
        pos += 3;
        bool last = header & 1;
        int type = (header >> 1) & 3;
        size_t size = header >> 3;
        if (size > kBlockMax) return kBlockTooLarge;
        if (type == 0) {
            if (n - pos < size) return kTruncated;
            if (out.cap - out.pos < size) return kDstTooSmall;
            std::memcpy(out.dst + out.pos, p + pos, size);
            out.pos += size;
            pos += size;
        } else if (type == 1) {
            if (n - pos < 1) return kTruncated;
            if (out.cap - out.pos < size) return kDstTooSmall;
            std::memset(out.dst + out.pos, p[pos], size);
            out.pos += size;
            pos += 1;
        } else if (type == 2) {
            if (n - pos < size) return kTruncated;
            err = decode_compressed_block(p + pos, size, fs, out);
            if (err < 0) return err;
            pos += size;
        } else {
            return kCorrupt;
        }
        if (last) break;
    }
    size_t produced = out.pos - out.frame_start;
    if (h.has_content_size && produced != h.content_size) return kContentSize;
    if (h.checksum) {
        if (n - pos < 4) return kTruncated;
        uint32_t want = read_le(p + pos, 4);
        uint32_t got = uint32_t(xxh64(out.dst + out.frame_start, produced));
        if (want != got) return kChecksum;
        pos += 4;
    }
    return (long long)pos;
}

// CRC32C tables for slicing by 8 (reflected polynomial 0x82F63B78)
struct CrcTables {
    uint32_t t[8][256];
    CrcTables() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k)
                c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
            t[0][i] = c;
        }
        for (uint32_t i = 0; i < 256; ++i)
            for (int k = 1; k < 8; ++k)
                t[k][i] = (t[k - 1][i] >> 8) ^ t[0][t[k - 1][i] & 0xFF];
    }
};

}  // namespace

extern "C" {

long long zstd_decompress(const uint8_t* src, long long n, uint8_t* dst,
                          long long cap) {
    if (n < 0 || cap < 0) return kCorrupt;
    static thread_local FrameState* state = nullptr;
    if (state == nullptr) state = new FrameState();
    Output out{dst, size_t(cap), 0, 0};
    size_t pos = 0, size = size_t(n);
    if (size == 0) return kTruncated;
    while (pos < size) {
        if (size - pos < 4) return kTruncated;
        uint32_t magic = read_le(src + pos, 4);
        if ((magic & kSkippableMask) == kSkippableMagic) {
            if (size - pos < 8) return kTruncated;
            size_t skip = read_le(src + pos + 4, 4);
            if (size - pos - 8 < skip) return kTruncated;
            pos += 8 + skip;
            continue;
        }
        if (magic != kMagic) return kBadMagic;
        long long used = decode_frame(src + pos, size - pos, out, *state);
        if (used < 0) return used;
        pos += size_t(used);
    }
    return (long long)out.pos;
}

long long zstd_content_size(const uint8_t* src, long long n) {
    if (n < 0) return kCorrupt;
    size_t pos = 0, size = size_t(n);
    unsigned long long total = 0;
    if (size == 0) return kTruncated;
    while (pos < size) {
        if (size - pos < 4) return kTruncated;
        uint32_t magic = read_le(src + pos, 4);
        if ((magic & kSkippableMask) == kSkippableMagic) {
            if (size - pos < 8) return kTruncated;
            size_t skip = read_le(src + pos + 4, 4);
            if (size - pos - 8 < skip) return kTruncated;
            pos += 8 + skip;
            continue;
        }
        if (magic != kMagic) return kBadMagic;
        FrameHeader h;
        int err = read_frame_header(src + pos, size - pos, h);
        if (err < 0) return err;
        if (!h.has_content_size) return -1;
        total += h.content_size;
        // walk the blocks to the next frame
        size_t q = pos + h.size;
        for (;;) {
            if (size - q < 3) return kTruncated;
            uint32_t header = read_le(src + q, 3);
            size_t block = header >> 3;
            int type = (header >> 1) & 3;
            q += 3 + (type == 1 ? 1 : block);
            if (q > size) return kTruncated;
            if (header & 1) break;
        }
        if (h.checksum) q += 4;
        if (q > size) return kTruncated;
        pos = q;
    }
    if (total > (1ULL << 62)) return kContentSize;
    return (long long)total;
}

const char* zstd_error_name(int code) {
    switch (code) {
        case kTruncated: return "truncated input";
        case kBadMagic: return "not a zstd frame (bad magic number)";
        case kBadHeader: return "unsupported or reserved frame header bits";
        case kDictionary: return "frame needs a dictionary";
        case kDstTooSmall: return "frame decodes to more bytes than expected";
        case kCorrupt: return "corrupted block";
        case kChecksum: return "content checksum mismatch";
        case kContentSize: return "decoded size differs from the frame's "
                                  "content size";
        case kBlockTooLarge: return "block larger than 128 KiB";
        case kBadTable: return "malformed FSE table";
        case kBadHuffman: return "malformed Huffman table";
        case kBadOffset: return "match offset outside the decoded data";
        default: return "unknown error";
    }
}

unsigned zstd_crc32c(const uint8_t* p, long long n, unsigned crc) {
    static const CrcTables tables;  // built once, thread-safe
    const auto& crc_table = tables.t;
    uint32_t c = ~uint32_t(crc);
    size_t size = n > 0 ? size_t(n) : 0;
    while (size >= 8) {
        uint64_t word = read_le64(p) ^ c;
        c = crc_table[7][word & 0xFF] ^ crc_table[6][(word >> 8) & 0xFF]
            ^ crc_table[5][(word >> 16) & 0xFF]
            ^ crc_table[4][(word >> 24) & 0xFF]
            ^ crc_table[3][(word >> 32) & 0xFF]
            ^ crc_table[2][(word >> 40) & 0xFF]
            ^ crc_table[1][(word >> 48) & 0xFF]
            ^ crc_table[0][(word >> 56) & 0xFF];
        p += 8;
        size -= 8;
    }
    while (size--) c = (c >> 8) ^ crc_table[0][(c ^ *p++) & 0xFF];
    return ~c;
}

}  // extern "C"
