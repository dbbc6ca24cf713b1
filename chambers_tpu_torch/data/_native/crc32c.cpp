// CRC32C (Castagnoli, reflected poly 0x82F63B78), the TFRecord framing
// checksum (chambers_tpu_torch/data/tfrecord.py; the port's copy of
// chambers_tpu/data/_native/crc32c.cpp). The pure-Python table loop runs
// ~25 MB/s; this uses the SSE4.2 CRC32 instruction where the CPU has it,
// slice-by-8 tables otherwise.
//
// C ABI only (loaded via ctypes):
//   uint32_t chtpu_crc32c(const uint8_t* data, size_t n);
// Returns the finalized CRC (init 0xFFFFFFFF, final xor) — the same value
// as tfrecord.py's _crc32c_py(data).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <mutex>

namespace {

uint32_t kTable[8][256];
std::once_flag kTableOnce;

void init_tables() {
  for (int i = 0; i < 256; i++) {
    uint32_t c = static_cast<uint32_t>(i);
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    kTable[0][i] = c;
  }
  for (int i = 0; i < 256; i++)
    for (int s = 1; s < 8; s++)
      kTable[s][i] = (kTable[s - 1][i] >> 8) ^ kTable[0][kTable[s - 1][i] & 0xFF];
}

uint32_t crc_sw(const uint8_t* p, size_t n, uint32_t crc) {
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);      // little-endian hosts only (x86/arm64)
    std::memcpy(&hi, p + 4, 4);
    crc ^= lo;
    crc = kTable[7][crc & 0xFF] ^ kTable[6][(crc >> 8) & 0xFF] ^
          kTable[5][(crc >> 16) & 0xFF] ^ kTable[4][crc >> 24] ^
          kTable[3][hi & 0xFF] ^ kTable[2][(hi >> 8) & 0xFF] ^
          kTable[1][(hi >> 16) & 0xFF] ^ kTable[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = kTable[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc_hw(const uint8_t* p, size_t n, uint32_t crc) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t word;
    std::memcpy(&word, p, 8);
    c = __builtin_ia32_crc32di(c, word);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = __builtin_ia32_crc32qi(c32, *p++);
  return c32;
}

bool has_sse42() { return __builtin_cpu_supports("sse4.2"); }
#endif

}  // namespace

extern "C" uint32_t chtpu_crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
#if defined(__x86_64__)
  static const bool hw = has_sse42();
  if (hw) return crc_hw(data, n, crc) ^ 0xFFFFFFFFu;
#endif
  std::call_once(kTableOnce, init_tables);
  return crc_sw(data, n, crc) ^ 0xFFFFFFFFu;
}
