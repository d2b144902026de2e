// Native host runtime: element-dictionary interning + delta wire codec.
//
// The counterpart of the JAX package's native/codec.cpp, the same C ABI
// and the same bytes.  The reference keeps its element universe as Go map
// keys (awset.go:58) and ships delta payloads as in-memory maps computed
// against the receiver's version vector (awset-delta_test.go:79-105).  The
// host runtime around the device path owns two byte-level jobs:
//
//   1. interning element strings to dense ids 0..E-1 when packing and
//      unpacking states, where inputs arrive as flat utf-8 buffers (wire,
//      disk), and
//   2. serializing masked delta payloads into the compact wire format
//      (bitmask + varint dot pairs) of utils/wire.py.
//
// Exposed as a plain C ABI consumed via ctypes;
// go_crdt_playground_tpu_torch/native/__init__.py builds this file with g++
// on first use, and the Python codecs (utils/codec.py, utils/wire.py) give
// the same results when no toolchain is there.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Element dictionary
// ---------------------------------------------------------------------

struct ElementDict {
  std::unordered_map<std::string, int64_t> to_id;
  std::vector<std::string> to_str;
  int64_t capacity;
};

void* ed_new(int64_t capacity) {
  auto* d = new ElementDict();
  d->capacity = capacity;
  return d;
}

void ed_free(void* h) { delete static_cast<ElementDict*>(h); }

int64_t ed_len(void* h) {
  return static_cast<int64_t>(static_cast<ElementDict*>(h)->to_str.size());
}

int64_t ed_capacity(void* h) {
  return static_cast<ElementDict*>(h)->capacity;
}

void ed_set_capacity(void* h, int64_t capacity) {
  static_cast<ElementDict*>(h)->capacity = capacity;
}

// Non-mutating lookup: id of the string, or -1 if not interned.
int64_t ed_lookup(void* h, const char* buf, int64_t len) {
  auto* d = static_cast<ElementDict*>(h);
  auto it = d->to_id.find(std::string(buf, static_cast<size_t>(len)));
  return it == d->to_id.end() ? -1 : it->second;
}

// Encode n strings given as a concatenated utf-8 buffer with
// offsets[n+1] (string i = buf[offsets[i] .. offsets[i+1])).
// Fills out_ids[n].  Returns n on success, or -(i+1) if string i found
// the dictionary full (ids before i are assigned; i.. untouched) — the
// grow-and-repack overflow policy surfaces exactly like the Python
// codec's OverflowError.
int64_t ed_encode_batch(void* h, const char* buf, const int64_t* offsets,
                        int64_t n, int64_t* out_ids) {
  auto* d = static_cast<ElementDict*>(h);
  for (int64_t i = 0; i < n; ++i) {
    std::string s(buf + offsets[i],
                  static_cast<size_t>(offsets[i + 1] - offsets[i]));
    auto it = d->to_id.find(s);
    if (it != d->to_id.end()) {
      out_ids[i] = it->second;
      continue;
    }
    if (static_cast<int64_t>(d->to_str.size()) >= d->capacity) {
      return -(i + 1);
    }
    int64_t id = static_cast<int64_t>(d->to_str.size());
    d->to_id.emplace(std::move(s), id);
    d->to_str.push_back(
        std::string(buf + offsets[i],
                    static_cast<size_t>(offsets[i + 1] - offsets[i])));
    out_ids[i] = id;
  }
  return n;
}

// Total bytes of the concatenated decode of ids[n]; -1 on unknown id.
int64_t ed_decode_size(void* h, const int64_t* ids, int64_t n) {
  auto* d = static_cast<ElementDict*>(h);
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (ids[i] < 0 || ids[i] >= static_cast<int64_t>(d->to_str.size()))
      return -1;
    total += static_cast<int64_t>(d->to_str[ids[i]].size());
  }
  return total;
}

// Decode ids[n] into out (concatenated) + out_offsets[n+1].  Returns
// bytes written, or -1 if out_cap is too small / id unknown.
int64_t ed_decode_batch(void* h, const int64_t* ids, int64_t n, char* out,
                        int64_t out_cap, int64_t* out_offsets) {
  auto* d = static_cast<ElementDict*>(h);
  int64_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (ids[i] < 0 || ids[i] >= static_cast<int64_t>(d->to_str.size()))
      return -1;
    const std::string& s = d->to_str[ids[i]];
    if (pos + static_cast<int64_t>(s.size()) > out_cap) return -1;
    out_offsets[i] = pos;
    std::memcpy(out + pos, s.data(), s.size());
    pos += static_cast<int64_t>(s.size());
  }
  out_offsets[n] = pos;
  return pos;
}

// ---------------------------------------------------------------------
// Delta wire codec: bitmask + varint dot pairs
//
// Row format (one replica's changed or deleted payload over universe E):
//   varint E, varint n_set,
//   ceil(E/8) bitmask bytes (LSB-first within each byte),
//   then per set lane in ascending id order: varint dot_actor,
//   varint dot_counter.
// ---------------------------------------------------------------------

static inline int64_t put_varint(uint8_t* out, int64_t cap, int64_t pos,
                                 uint64_t v) {
  while (true) {
    if (pos >= cap) return -1;
    if (v < 0x80) {
      out[pos++] = static_cast<uint8_t>(v);
      return pos;
    }
    out[pos++] = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
}

static inline int64_t get_varint(const uint8_t* in, int64_t size,
                                 int64_t pos, uint64_t* v) {
  uint64_t out = 0;
  int shift = 0;
  while (true) {
    if (pos >= size || shift > 63) return -1;
    uint8_t b = in[pos++];
    out |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  *v = out;
  return pos;
}

// Worst case: header + bitmask + 2 x 5-byte varints per lane.
int64_t delta_encode_bound(int64_t e) { return 20 + (e + 7) / 8 + 10 * e; }

// mask: uint8[E] (0/1), da/dc: uint32[E].  Returns bytes written or -1.
int64_t delta_encode(const uint8_t* mask, const uint32_t* da,
                     const uint32_t* dc, int64_t e, uint8_t* out,
                     int64_t cap) {
  int64_t n_set = 0;
  for (int64_t i = 0; i < e; ++i) n_set += mask[i] != 0;
  int64_t pos = put_varint(out, cap, 0, static_cast<uint64_t>(e));
  if (pos < 0) return -1;
  pos = put_varint(out, cap, pos, static_cast<uint64_t>(n_set));
  if (pos < 0) return -1;
  int64_t nbytes = (e + 7) / 8;
  if (pos + nbytes > cap) return -1;
  std::memset(out + pos, 0, static_cast<size_t>(nbytes));
  for (int64_t i = 0; i < e; ++i)
    if (mask[i]) out[pos + (i >> 3)] |= static_cast<uint8_t>(1u << (i & 7));
  pos += nbytes;
  for (int64_t i = 0; i < e; ++i) {
    if (!mask[i]) continue;
    pos = put_varint(out, cap, pos, da[i]);
    if (pos < 0) return -1;
    pos = put_varint(out, cap, pos, dc[i]);
    if (pos < 0) return -1;
  }
  return pos;
}

// Inverse.  mask/da/dc are caller buffers of length E (E must match the
// encoded universe).  Unset lanes are zeroed.  Returns bytes consumed
// or -1 on malformed input / size mismatch.
int64_t delta_decode(const uint8_t* in, int64_t size, int64_t e,
                     uint8_t* mask, uint32_t* da, uint32_t* dc) {
  uint64_t enc_e = 0, n_set = 0;
  int64_t pos = get_varint(in, size, 0, &enc_e);
  if (pos < 0 || static_cast<int64_t>(enc_e) != e) return -1;
  pos = get_varint(in, size, pos, &n_set);
  if (pos < 0 || n_set > enc_e) return -1;
  int64_t nbytes = (e + 7) / 8;
  if (pos + nbytes > size) return -1;
  const uint8_t* bits = in + pos;
  pos += nbytes;
  int64_t seen = 0;
  for (int64_t i = 0; i < e; ++i) {
    bool set = (bits[i >> 3] >> (i & 7)) & 1;
    mask[i] = set ? 1 : 0;
    if (set) {
      uint64_t a = 0, c = 0;
      pos = get_varint(in, size, pos, &a);
      if (pos < 0 || a > 0xFFFFFFFFull) return -1;
      pos = get_varint(in, size, pos, &c);
      if (pos < 0 || c > 0xFFFFFFFFull) return -1;
      da[i] = static_cast<uint32_t>(a);
      dc[i] = static_cast<uint32_t>(c);
      ++seen;
    } else {
      da[i] = 0;
      dc[i] = 0;
    }
  }
  if (seen != static_cast<int64_t>(n_set)) return -1;
  return pos;
}

// Version-vector row: varint A then A varint counters.
int64_t vv_encode_bound(int64_t a) { return 10 + 5 * a; }

int64_t vv_encode(const uint32_t* vv, int64_t a, uint8_t* out, int64_t cap) {
  int64_t pos = put_varint(out, cap, 0, static_cast<uint64_t>(a));
  if (pos < 0) return -1;
  for (int64_t i = 0; i < a; ++i) {
    pos = put_varint(out, cap, pos, vv[i]);
    if (pos < 0) return -1;
  }
  return pos;
}

int64_t vv_decode(const uint8_t* in, int64_t size, int64_t a, uint32_t* vv) {
  uint64_t enc_a = 0;
  int64_t pos = get_varint(in, size, 0, &enc_a);
  if (pos < 0 || static_cast<int64_t>(enc_a) != a) return -1;
  for (int64_t i = 0; i < a; ++i) {
    uint64_t v = 0;
    pos = get_varint(in, size, pos, &v);
    if (pos < 0 || v > 0xFFFFFFFFull) return -1;
    vv[i] = static_cast<uint32_t>(v);
  }
  return pos;
}

}  // extern "C"
