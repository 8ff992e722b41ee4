// Native host runtime for sitewhere_tpu_torch (a copy of the JAX package's
// sitewhere_tpu/native/host_runtime.cc): the pieces of the ingest path that
// must run at millions of events/sec on the host CPU, ahead of the TPU step.
//
// The reference implements this tier on the JVM (per-event protobuf decode in
// sitewhere-communication ProtobufDeviceEventDecoder.java + per-event device
// lookups, InboundPayloadProcessingLogic.java:156); here it is a small C++
// library driven through ctypes:
//
//   1. swt_interner_*: string token -> dense int32 index table
//      (SURVEY.md §7 hard part (c): token interning at 1M+/s). FNV-1a hash,
//      open addressing, shared_mutex (concurrent receiver threads).
//   2. swt_decode_hot_frames: one pass over a wire-protocol byte stream
//      (transport/wire.py frame layout) producing SoA columns for the hot
//      event types and an index of control frames for the Python side.
//
// Built with: g++ -O3 -std=c++17 -shared -fPIC at first use
// (sitewhere_tpu_torch/native.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <vector>

namespace {

constexpr uint64_t kFnvOffset = 1469598103934665603ull;
constexpr uint64_t kFnvPrime = 1099511628211ull;

inline uint64_t fnv1a(const char* data, int64_t len) {
  uint64_t h = kFnvOffset;
  for (int64_t i = 0; i < len; ++i) {
    h ^= static_cast<uint8_t>(data[i]);
    h *= kFnvPrime;
  }
  return h;
}

inline size_t next_pow2(size_t v) {
  size_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

struct Interner {
  // 4x capacity hash slots: at most `capacity` tokens are ever hashed
  // (gap placeholders from swt_interner_add_gap never enter the hash),
  // so the load factor stays <= 0.25 and open-addressing probes short.
  explicit Interner(int32_t capacity)
      : capacity(capacity), mask(next_pow2(static_cast<size_t>(capacity) * 4) - 1),
        slots(mask + 1, -1), hashes(mask + 1, 0) {
    tokens.reserve(capacity);
    tokens.emplace_back();  // index 0 = UNKNOWN sentinel, never matched
  }

  int32_t capacity;
  size_t mask;
  std::vector<int32_t> slots;     // slot -> token index, -1 empty
  std::vector<uint64_t> hashes;   // slot -> full hash (cheap reject)
  std::vector<std::string> tokens;  // index -> bytes
  mutable std::shared_mutex mu;

  // Requires at least a shared lock. Gap placeholders (shard-congruent
  // allocator) are appended via add_gap WITHOUT a hash entry, so they can
  // never satisfy a lookup — no byte pattern is reserved, and arbitrary
  // wire tokens (including NUL-prefixed ones) intern normally.
  int32_t find(const char* tok, int64_t len, uint64_t h) const {
    size_t slot = h & mask;
    while (true) {
      int32_t idx = slots[slot];
      if (idx < 0) return -1;
      if (hashes[slot] == h) {
        const std::string& s = tokens[static_cast<size_t>(idx)];
        if (static_cast<int64_t>(s.size()) == len &&
            std::memcmp(s.data(), tok, static_cast<size_t>(len)) == 0)
          return idx;
      }
      slot = (slot + 1) & mask;
    }
  }

  // Requires the unique lock.
  int32_t add(const char* tok, int64_t len, uint64_t h) {
    int32_t idx = find(tok, len, h);
    if (idx >= 0) return idx;
    if (static_cast<int32_t>(tokens.size()) >= capacity) return -1;
    idx = static_cast<int32_t>(tokens.size());
    tokens.emplace_back(tok, static_cast<size_t>(len));
    size_t slot = h & mask;
    while (slots[slot] >= 0) slot = (slot + 1) & mask;
    slots[slot] = idx;
    hashes[slot] = h;
    return idx;
  }

  // Requires the unique lock. Append a gap placeholder: occupies the next
  // index in the token table but is NOT inserted into the hash, so no
  // lookup can ever return it. set_at later fills it with a real token.
  int32_t add_gap() {
    if (static_cast<int32_t>(tokens.size()) >= capacity) return -1;
    int32_t idx = static_cast<int32_t>(tokens.size());
    tokens.emplace_back();
    return idx;
  }
};

}  // namespace

extern "C" {

int32_t swt_version() { return 9; }

void* swt_interner_create(int32_t capacity) {
  if (capacity < 2) return nullptr;
  return new Interner(capacity);
}

void swt_interner_destroy(void* h) { delete static_cast<Interner*>(h); }

int32_t swt_interner_size(void* h) {
  Interner* in = static_cast<Interner*>(h);
  std::shared_lock<std::shared_mutex> lock(in->mu);
  return static_cast<int32_t>(in->tokens.size());
}

// Get-or-assign one token; returns its index, or -1 when capacity exceeded.
int32_t swt_interner_add(void* h, const char* tok, int32_t len) {
  Interner* in = static_cast<Interner*>(h);
  uint64_t hash = fnv1a(tok, len);
  {
    std::shared_lock<std::shared_mutex> lock(in->mu);
    int32_t idx = in->find(tok, len, hash);
    if (idx >= 0) return idx;
  }
  std::unique_lock<std::shared_mutex> lock(in->mu);
  return in->add(tok, len, hash);
}

// Append a gap placeholder slot (shard-congruent allocator —
// registry/interning.py): takes the next index without a hash entry, so
// it is unfindable by construction. Returns the new index, or -1 when
// capacity is exceeded.
int32_t swt_interner_add_gap(void* h) {
  Interner* in = static_cast<Interner*>(h);
  std::unique_lock<std::shared_mutex> lock(in->mu);
  return in->add_gap();
}

// Overwrite the token at an EXISTING index (a gap placeholder from the
// shard-congruent allocator — registry/interning.py). The real token is
// inserted into the hash pointing at idx; the placeholder had no hash
// entry, so nothing dangles, and the token table slot is replaced so
// token_at/snapshot read the real token. Returns 0, -1 for an
// out-of-range idx, -2 when the token already exists at a DIFFERENT
// index (caller bug).
int32_t swt_interner_set_at(void* h, int32_t idx, const char* tok,
                            int32_t len) {
  Interner* in = static_cast<Interner*>(h);
  uint64_t hash = fnv1a(tok, len);
  std::unique_lock<std::shared_mutex> lock(in->mu);
  if (idx <= 0 || idx >= static_cast<int32_t>(in->tokens.size())) return -1;
  int32_t existing = in->find(tok, len, hash);
  if (existing >= 0) return existing == idx ? 0 : -2;
  in->tokens[static_cast<size_t>(idx)].assign(tok, static_cast<size_t>(len));
  size_t slot = hash & in->mask;
  while (in->slots[slot] >= 0) slot = (slot + 1) & in->mask;
  in->slots[slot] = idx;
  in->hashes[slot] = hash;
  return 0;
}

// Copy token bytes for index `idx` into out (cap bytes); returns byte
// length, -1 if idx is out of range, or -(2 + needed_len) when the buffer
// is too small (so callers can retry with a bigger one).
int32_t swt_interner_token_at(void* h, int32_t idx, char* out, int32_t cap) {
  Interner* in = static_cast<Interner*>(h);
  std::shared_lock<std::shared_mutex> lock(in->mu);
  if (idx <= 0 || idx >= static_cast<int32_t>(in->tokens.size())) return -1;
  const std::string& s = in->tokens[static_cast<size_t>(idx)];
  if (static_cast<int32_t>(s.size()) > cap)
    return -(2 + static_cast<int32_t>(s.size()));
  std::memcpy(out, s.data(), s.size());
  return static_cast<int32_t>(s.size());
}

// Batch lookup: n tokens in `buf` delimited by offsets [n+1]; unknown -> 0.
int32_t swt_interner_lookup_offsets(void* h, const char* buf,
                                    const int64_t* off, int32_t n,
                                    int32_t* out_idx) {
  Interner* in = static_cast<Interner*>(h);
  std::shared_lock<std::shared_mutex> lock(in->mu);
  for (int32_t i = 0; i < n; ++i) {
    const char* tok = buf + off[i];
    int64_t len = off[i + 1] - off[i];
    int32_t idx = in->find(tok, len, fnv1a(tok, len));
    out_idx[i] = idx < 0 ? 0 : idx;
  }
  return 0;
}

// Batch get-or-assign. Returns 0, or -1 if capacity was exceeded (out_idx is
// filled with 0 for the tokens that no longer fit). With skip_empty != 0,
// zero-length tokens map to 0 without interning (an "absent" field in a
// decoded column, e.g. measurement names on location events).
int32_t swt_interner_intern_offsets(void* h, const char* buf,
                                    const int64_t* off, int32_t n,
                                    int32_t* out_idx, int32_t skip_empty) {
  Interner* in = static_cast<Interner*>(h);
  int32_t rc = 0;
  // Fast pass under the shared lock: most tokens already exist.
  std::vector<int32_t> missing;
  {
    std::shared_lock<std::shared_mutex> lock(in->mu);
    for (int32_t i = 0; i < n; ++i) {
      const char* tok = buf + off[i];
      int64_t len = off[i + 1] - off[i];
      if (skip_empty && len == 0) {
        out_idx[i] = 0;
        continue;
      }
      out_idx[i] = in->find(tok, len, fnv1a(tok, len));
      if (out_idx[i] < 0) missing.push_back(i);
    }
  }
  if (!missing.empty()) {
    std::unique_lock<std::shared_mutex> lock(in->mu);
    for (int32_t i : missing) {
      const char* tok = buf + off[i];
      int64_t len = off[i + 1] - off[i];
      int32_t idx = in->add(tok, len, fnv1a(tok, len));
      if (idx < 0) {
        out_idx[i] = 0;
        rc = -1;
      } else {
        out_idx[i] = idx;
      }
    }
  }
  return rc;
}

// ---------------------------------------------------------------------------
// Wire-protocol hot-frame decoder (layout doc: transport/wire.py).
//
// Frame: "SW" u8 version u8 msg_type u32 payload_len payload.
// Hot payloads (msg_type 3/4/5): u8 token_len, token, i64 ts_ms, then
//   MEASUREMENT(3): u8 name_len, name, f32 value
//   LOCATION(4):    f32 lat, f32 lon, f32 elevation
//   ALERT(5):       u8 type_len, type, u8 level, u16 msg_len, msg
//
// Event-type codes written to `event_type` are the model enum values
// (model/event.py DeviceEventType): MEASUREMENT=0, LOCATION=1, ALERT=2.
//
// counts[0]=n_hot, counts[1]=n_other, counts[2]=consumed_bytes,
// counts[3]=error (0 ok; 1 bad magic/version; 2 capacity; 3 malformed).
// A trailing partial frame is not an error: it is left unconsumed.
// ---------------------------------------------------------------------------

namespace {
inline uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
inline int64_t rd_i64(const uint8_t* p) {
  int64_t v;
  std::memcpy(&v, p, 8);
  return v;
}
inline float rd_f32(const uint8_t* p) {
  float v;
  std::memcpy(&v, p, 4);
  return v;
}
}  // namespace

int32_t swt_decode_hot_frames(
    const uint8_t* buf, int64_t len, int32_t cap,
    int32_t* event_type, int64_t* ts, float* value, float* lat, float* lon,
    float* elevation, int32_t* alert_level,
    char* tok_buf, int64_t tok_cap, int64_t* tok_off,
    char* name_buf, int64_t name_cap, int64_t* name_off,
    char* atype_buf, int64_t atype_cap, int64_t* atype_off,
    int32_t* other_type, int64_t* other_off, int64_t* other_len,
    int32_t other_cap, int64_t* counts) {
  int64_t pos = 0;
  int32_t n = 0, m = 0;
  int64_t tok_pos = 0, name_pos = 0, atype_pos = 0;
  tok_off[0] = name_off[0] = atype_off[0] = 0;
  counts[0] = counts[1] = counts[2] = counts[3] = 0;
  constexpr int64_t kMaxPayload = 16ll * 1024 * 1024;  // wire.MAX_FRAME_PAYLOAD

  while (len - pos >= 8) {
    const uint8_t* hdr = buf + pos;
    if (hdr[0] != 'S' || hdr[1] != 'W' || hdr[2] != 1) {
      counts[3] = 1;
      break;
    }
    uint8_t mtype = hdr[3];
    int64_t plen = static_cast<int64_t>(rd_u32(hdr + 4));
    if (plen > kMaxPayload) {
      counts[3] = 3;
      break;
    }
    if (len - pos - 8 < plen) break;  // partial frame: stop, not an error
    const uint8_t* p = buf + pos + 8;
    if (mtype < 3 || mtype > 5) {   // control frame: index for Python
      if (m >= other_cap) {
        counts[3] = 2;
        break;
      }
      other_type[m] = mtype;
      other_off[m] = pos + 8;
      other_len[m] = plen;
      ++m;
      pos += 8 + plen;
      continue;
    }
    if (n >= cap) {
      counts[3] = 2;
      break;
    }
    // hot event payload
    const uint8_t* end = p + plen;
    if (p >= end) {
      counts[3] = 3;
      break;
    }
    int64_t tlen = *p++;
    if (p + tlen + 8 > end || tok_pos + tlen > tok_cap) {
      counts[3] = tok_pos + tlen > tok_cap ? 2 : 3;
      break;
    }
    std::memcpy(tok_buf + tok_pos, p, static_cast<size_t>(tlen));
    tok_pos += tlen;
    p += tlen;
    int64_t ets = rd_i64(p);
    p += 8;
    int32_t etype;
    float ev = 0, ela = 0, elo = 0, eel = 0;
    int32_t elev = 0;
    int64_t nlen = 0, alen = 0;
    bool ok = true;
    if (mtype == 3) {  // MEASUREMENT
      etype = 0;
      ok = p < end;
      if (ok) {
        nlen = *p++;
        ok = p + nlen + 4 <= end && name_pos + nlen <= name_cap;
      }
      if (ok) {
        std::memcpy(name_buf + name_pos, p, static_cast<size_t>(nlen));
        p += nlen;
        ev = rd_f32(p);
      }
    } else if (mtype == 4) {  // LOCATION
      etype = 1;
      ok = p + 12 <= end;
      if (ok) {
        ela = rd_f32(p);
        elo = rd_f32(p + 4);
        eel = rd_f32(p + 8);
      }
    } else {  // ALERT
      etype = 2;
      ok = p < end;
      if (ok) {
        alen = *p++;
        ok = p + alen + 3 <= end && atype_pos + alen <= atype_cap;
      }
      if (ok) {
        std::memcpy(atype_buf + atype_pos, p, static_cast<size_t>(alen));
        p += alen;
        elev = *p;
      }
    }
    if (!ok) {
      counts[3] = 3;
      break;
    }
    event_type[n] = etype;
    ts[n] = ets;
    value[n] = ev;
    lat[n] = ela;
    lon[n] = elo;
    elevation[n] = eel;
    alert_level[n] = elev;
    name_pos += nlen;
    atype_pos += alen;
    ++n;
    tok_off[n] = tok_pos;
    name_off[n] = name_pos;
    atype_off[n] = atype_pos;
    pos += 8 + plen;
  }
  counts[0] = n;
  counts[1] = m;
  counts[2] = pos;
  return counts[3] == 0 ? 0 : -1;
}

// Shard routing of the wire blob (ops/pack.py v2 layout: 5 rows
// [dev|type|level|valid packed, ts, payloadA, payloadB, elevation];
// row 0 bits 0-21 = device_idx, bit 28 = valid).
// One pass with per-shard cursors replaces the Python router's argsort +
// 12 column gather/scatters. `out` is [S, 5, B] and must arrive zeroed
// (row-0 valid bit 0 == invalid). Valid rows beyond a shard's capacity
// report their flat-row indices through `overflow_rows` (stable order).
// The device field of the routed row 0 is rewritten to the LOCAL index
// dev / S (type/level/valid bits preserved). Returns the overflow count,
// or -1 when overflow_cap is too small.
static constexpr int kWireRows = 5;
static constexpr int32_t kWireDevMask = (1 << 22) - 1;
static constexpr int32_t kWireValidBit = 1 << 28;
static constexpr int32_t kIdxMask = (1 << 12) - 1;  // mm/alert-type width
static constexpr int32_t kEtMeasurement = 0;  // model/event.py DeviceEventType
static constexpr int32_t kEtLocation = 1;
static constexpr int32_t kEtAlert = 2;
// PACKED 3-row variant (ops/pack.py WIRE_ROWS_PACKED): ts travels as a
// 16-bit delta against a per-batch base embedded in row 0's spare bits
// (3 per lane, lanes 0..10); mm/alert idx shares row 1 with the delta.
static constexpr int32_t kTsDeltaMask = (1 << 16) - 1;
static constexpr int32_t kPkIdxShift = 16;
static constexpr int32_t kBaseShift = 29;
static constexpr int32_t kBaseLanes = 11;

// OR the 32-bit ts base into row0's spare bits (row0 has >= kBaseLanes
// lanes — enforced by the packed-variant eligibility check host-side).
static inline void embed_ts_base(int32_t* row0, int32_t ts_base) {
  uint32_t base = static_cast<uint32_t>(ts_base);
  for (int32_t lane = 0; lane < kBaseLanes; ++lane) {
    uint32_t bits = (base >> (3 * lane)) & 7u;
    row0[lane] |= static_cast<int32_t>(bits << kBaseShift);
  }
}

static inline int32_t extract_ts_base(const int32_t* row0) {
  uint32_t base = 0;
  for (int32_t lane = 0; lane < kBaseLanes; ++lane) {
    uint32_t bits =
        (static_cast<uint32_t>(row0[lane]) >> kBaseShift) & 7u;
    base |= bits << (3 * lane);
  }
  return static_cast<int32_t>(base);
}

namespace {
inline int32_t f32_bits(float v) {
  int32_t out;
  std::memcpy(&out, &v, 4);
  return out;
}
inline float bits_f32(int32_t v) {
  float out;
  std::memcpy(&out, &v, 4);
  return out;
}
}  // namespace

// Pack EventBatch columns into the wire blob (ops/pack.py layout doc)
// in one pass — replaces 8 numpy full-column passes (3 of them np.where
// selects) on the hottest host path. `out` is [wire_rows, n]; wire_rows
// is 5, or 4 for the COMPACT variant that omits the elevation row (the
// caller chooses it when no row carries a nonzero elevation — 16 B/event
// instead of 20 on a transfer-bound path). Returns 0, or -1 when a
// device_idx is outside [0, 2^22) (caller raises).
int32_t swt_pack_blob(const int32_t* device_idx, const int32_t* event_type,
                      const int32_t* ts, const int32_t* mm_idx,
                      const float* value, const float* lat, const float* lon,
                      const float* elevation, const int32_t* alert_type_idx,
                      const int32_t* alert_level, const uint8_t* valid,
                      int64_t n, int32_t wire_rows, int32_t ts_base,
                      int32_t* out) {
  int32_t* head = out;
  int32_t* ts_row = out + n;
  int32_t* pa = out + 2 * n;
  if (wire_rows == 3) {  // packed: delta ts | idx, value bits, no location
    for (int64_t i = 0; i < n; ++i) {
      int32_t dev = device_idx[i];
      if (dev < 0 || dev > kWireDevMask) return -1;
      int32_t et = event_type[i] & 7;
      head[i] = dev | (et << 22) | ((alert_level[i] & 7) << 25) |
                ((valid[i] ? 1 : 0) << 28);
      int32_t delta = valid[i] ? (ts[i] - ts_base) & kTsDeltaMask : 0;
      int32_t idx =
          (et == kEtAlert ? alert_type_idx[i] : mm_idx[i]) & kIdxMask;
      ts_row[i] = delta | (idx << kPkIdxShift);
      pa[i] = f32_bits(value[i]);
    }
    embed_ts_base(head, ts_base);
    return 0;
  }
  int32_t* pb = out + 3 * n;
  int32_t* elev = wire_rows >= 5 ? out + 4 * n : nullptr;
  for (int64_t i = 0; i < n; ++i) {
    int32_t dev = device_idx[i];
    if (dev < 0 || dev > kWireDevMask) return -1;
    int32_t et = event_type[i] & 7;
    head[i] = dev | (et << 22) | ((alert_level[i] & 7) << 25) |
              ((valid[i] ? 1 : 0) << 28);
    ts_row[i] = ts[i];
    if (et == kEtLocation) {
      pa[i] = f32_bits(lat[i]);
      pb[i] = f32_bits(lon[i]);
    } else {
      pa[i] = f32_bits(value[i]);
      pb[i] = (et == kEtAlert ? alert_type_idx[i] : mm_idx[i]) & kIdxMask;
    }
    if (elev) elev[i] = f32_bits(elevation[i]);
  }
  return 0;
}

// Inverse of swt_pack_blob (one pass; `blob` is [wire_rows, n]; a 4-row
// compact blob unpacks with elevation 0). tenant_idx is not on the wire —
// the caller zero-fills it.
void swt_unpack_blob(const int32_t* blob, int64_t n, int32_t wire_rows,
                     int32_t* device_idx,
                     int32_t* event_type, int32_t* ts, int32_t* mm_idx,
                     float* value, float* lat, float* lon, float* elevation,
                     int32_t* alert_type_idx, int32_t* alert_level,
                     uint8_t* valid) {
  const int32_t* head = blob;
  const int32_t* ts_row = blob + n;
  const int32_t* pa = blob + 2 * n;
  if (wire_rows == 3) {  // packed variant
    int32_t base = extract_ts_base(head);
    for (int64_t i = 0; i < n; ++i) {
      int32_t h = head[i];
      int32_t et = (h >> 22) & 7;
      device_idx[i] = h & kWireDevMask;
      event_type[i] = et;
      alert_level[i] = (h >> 25) & 7;
      valid[i] = (h & kWireValidBit) ? 1 : 0;
      ts[i] = base + (ts_row[i] & kTsDeltaMask);
      int32_t idx = (ts_row[i] >> kPkIdxShift) & kIdxMask;
      mm_idx[i] = et == kEtMeasurement ? idx : 0;
      alert_type_idx[i] = et == kEtAlert ? idx : 0;
      value[i] = et == kEtMeasurement ? bits_f32(pa[i]) : 0.0f;
      lat[i] = 0.0f;
      lon[i] = 0.0f;
      elevation[i] = 0.0f;
    }
    return;
  }
  const int32_t* pb = blob + 3 * n;
  const int32_t* elev = wire_rows >= 5 ? blob + 4 * n : nullptr;
  for (int64_t i = 0; i < n; ++i) {
    int32_t h = head[i];
    int32_t et = (h >> 22) & 7;
    device_idx[i] = h & kWireDevMask;
    event_type[i] = et;
    alert_level[i] = (h >> 25) & 7;
    valid[i] = (h & kWireValidBit) ? 1 : 0;
    ts[i] = ts_row[i];
    if (et == kEtLocation) {
      lat[i] = bits_f32(pa[i]);
      lon[i] = bits_f32(pb[i]);
      value[i] = 0.0f;
      mm_idx[i] = 0;
      alert_type_idx[i] = 0;
    } else {
      lat[i] = 0.0f;
      lon[i] = 0.0f;
      value[i] = et == kEtMeasurement ? bits_f32(pa[i]) : 0.0f;
      mm_idx[i] = et == kEtMeasurement ? pb[i] : 0;
      alert_type_idx[i] = et == kEtAlert ? pb[i] : 0;
    }
    elevation[i] = elev ? bits_f32(elev[i]) : 0.0f;
  }
}

// Fused pack+route: EventBatch columns -> routed [S, kWireRows, B] blob in
// ONE pass (replaces swt_pack_blob + swt_route_blob back to back — two full
// passes over the batch plus a zeroed 5*S*B intermediate). `out` does NOT
// need to arrive zeroed: after routing, only the head-row tails (positions
// cursor[s]..B, whose valid bit must read 0) are cleared — the other rows
// of unfilled positions are never read because the device step masks on the
// head valid bit. Invalid input rows are skipped (padding). Returns the
// overflow count, -1 when overflow_cap is too small, or -2 when a valid
// row's device_idx is outside [0, 2^22) (caller raises the shared
// diagnostic).
int32_t swt_pack_route_blob(
    const int32_t* device_idx, const int32_t* event_type, const int32_t* ts,
    const int32_t* mm_idx, const float* value, const float* lat,
    const float* lon, const float* elevation, const int32_t* alert_type_idx,
    const int32_t* alert_level, const uint8_t* valid, int64_t n, int32_t S,
    int32_t B, int32_t wire_rows, int32_t ts_base, int32_t* out,
    int64_t* overflow_rows, int64_t overflow_cap) {
  std::vector<int32_t> cursor(static_cast<size_t>(S), 0);
  int64_t n_over = 0;
  const int64_t shard_stride = static_cast<int64_t>(wire_rows) * B;
  const bool with_elev = wire_rows >= 5;
  const bool packed = wire_rows == 3;
  for (int64_t i = 0; i < n; ++i) {
    if (!valid[i]) continue;
    int32_t dev = device_idx[i];
    if (dev < 0 || dev > kWireDevMask) return -2;
    int32_t s = dev % S;
    int32_t pos = cursor[s];
    if (pos >= B) {
      if (n_over >= overflow_cap) return -1;
      overflow_rows[n_over++] = i;
      continue;
    }
    cursor[s] = pos + 1;
    int32_t* dst = out + s * shard_stride + pos;
    int32_t et = event_type[i] & 7;
    dst[0] = (dev / S) | (et << 22) | ((alert_level[i] & 7) << 25) |
             kWireValidBit;
    if (packed) {
      int32_t delta = (ts[i] - ts_base) & kTsDeltaMask;
      int32_t idx =
          (et == kEtAlert ? alert_type_idx[i] : mm_idx[i]) & kIdxMask;
      dst[B] = delta | (idx << kPkIdxShift);
      dst[2 * B] = f32_bits(value[i]);
      continue;
    }
    dst[B] = ts[i];
    if (et == kEtLocation) {
      dst[2 * B] = f32_bits(lat[i]);
      dst[3 * B] = f32_bits(lon[i]);
    } else {
      dst[2 * B] = f32_bits(value[i]);
      dst[3 * B] = (et == kEtAlert ? alert_type_idx[i] : mm_idx[i]) & kIdxMask;
    }
    if (with_elev) dst[4 * B] = f32_bits(elevation[i]);
  }
  for (int32_t s = 0; s < S; ++s) {
    int32_t filled = cursor[s];
    if (filled < B)
      std::memset(out + s * shard_stride + filled, 0,
                  static_cast<size_t>(B - filled) * 4);
    if (packed) embed_ts_base(out + s * shard_stride, ts_base);
  }
  return static_cast<int32_t>(n_over);
}

int32_t swt_route_blob(const int32_t* blob, int64_t n, int32_t S, int32_t B,
                       int32_t wire_rows, int32_t* out,
                       int64_t* overflow_rows, int64_t overflow_cap) {
  std::vector<int32_t> cursor(static_cast<size_t>(S), 0);
  const int32_t* head_row = blob;
  int64_t n_over = 0;
  const int64_t shard_stride = static_cast<int64_t>(wire_rows) * B;
  // packed 3-row blobs carry the ts base in row 0's spare bits by LANE
  // POSITION: routing scatters lanes, so the base must be lifted out of
  // the flat head first and re-embedded per shard afterwards (spare bits
  // are stripped from every routed head; they are zero on 4/5-row blobs)
  const bool packed = wire_rows == 3;
  const int32_t base =
      packed && n >= kBaseLanes ? extract_ts_base(head_row) : 0;
  constexpr int32_t kSpareClear = (1 << kBaseShift) - 1;
  for (int64_t i = 0; i < n; ++i) {
    int32_t head = head_row[i];
    if ((head & kWireValidBit) == 0) continue;  // padding row
    int32_t dev = head & kWireDevMask;
    int32_t s = dev % S;
    int32_t pos = cursor[s];
    if (pos >= B) {
      if (n_over >= overflow_cap) return -1;
      overflow_rows[n_over++] = i;
      continue;
    }
    cursor[s] = pos + 1;
    int32_t* dst = out + s * shard_stride + pos;
    dst[0] = ((head & ~kWireDevMask) & kSpareClear) | (dev / S);
    for (int r = 1; r < wire_rows; ++r) dst[r * B] = blob[r * n + i];
  }
  if (packed)
    for (int32_t s = 0; s < S; ++s)
      embed_ts_base(out + s * shard_stride, base);
  return static_cast<int32_t>(n_over);
}

}  // extern "C"
