// Native host-side runtime ops for vettore.
//
// The accelerator owns the compute path (JAX/XLA/Pallas); this library accelerates
// the host-side ingest pipeline that feeds it — the role the reference's
// Rust crate plays for its BEAM host (/root/reference/native/vettore/).
// Exposed through a plain C ABI and loaded with ctypes (no pybind11 in the
// build image). All functions are deterministic and allocation-free.
//
// Ops:
//   fnv1a64_batch  — FNV-1a hash of N byte strings (HNSW level assignment,
//                    bit-identical to hnsw.rs:489-497)
//   levels_batch   — deterministic HNSW level from a hash
//                    (P(level+1)=1/4 per step, hnsw.rs:473-481)
//   pack_signs_u64 — sign-bit packing of an [N, d] float32 matrix into
//                    u64 words (distances.rs:413-423)
//   hamming_scan   — packed-Hamming distances of N rows vs one query
//                    (XOR + popcount, distances.rs:426-437)

#include <cstdint>
#include <cstring>

extern "C" {

// data: concatenated utf-8 bytes; offsets: N+1 prefix offsets.
void fnv1a64_batch(const uint8_t* data, const int64_t* offsets, int64_t count,
                   uint64_t* out) {
  for (int64_t i = 0; i < count; ++i) {
    uint64_t h = 0xcbf29ce484222325ULL;
    for (int64_t p = offsets[i]; p < offsets[i + 1]; ++p) {
      h ^= static_cast<uint64_t>(data[p]);
      h *= 0x00000100000001B3ULL;
    }
    out[i] = h;
  }
}

void levels_batch(const uint64_t* hashes, int64_t count, int32_t max_level,
                  int32_t* out) {
  for (int64_t i = 0; i < count; ++i) {
    uint64_t h = hashes[i];
    int32_t level = 0;
    while (level < max_level && (h & 0x3ULL) == 0) {
      ++level;
      h >>= 2;
    }
    out[i] = level;
  }
}

// vecs: [rows, dims] float32 row-major; out: [rows, words] u64 with
// words = (dims + 63) / 64. Bit set when value >= 0.0 (incl. -0.0).
void pack_signs_u64(const float* vecs, int64_t rows, int64_t dims,
                    uint64_t* out) {
  const int64_t words = (dims + 63) / 64;
  for (int64_t r = 0; r < rows; ++r) {
    const float* v = vecs + r * dims;
    uint64_t* w = out + r * words;
    std::memset(w, 0, sizeof(uint64_t) * words);
    for (int64_t i = 0; i < dims; ++i) {
      if (v[i] >= 0.0f) {
        w[i / 64] |= (1ULL << (i % 64));
      }
    }
  }
}

// rows: [n, words] u64; query: [words] u64; out: [n] float32 distances.
void hamming_scan(const uint64_t* rows, const uint64_t* query, int64_t n,
                  int64_t words, float* out) {
  for (int64_t r = 0; r < n; ++r) {
    const uint64_t* row = rows + r * words;
    uint64_t acc = 0;
    for (int64_t w = 0; w < words; ++w) {
      acc += static_cast<uint64_t>(__builtin_popcountll(row[w] ^ query[w]));
    }
    out[r] = static_cast<float>(acc);
  }
}

}  // extern "C"
