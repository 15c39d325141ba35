// Framed binary codec — byte-compatible with torchbeast_tpu/runtime/wire.py
// (see that module for the format spec). Values are Nest<Array> plus
// scalar leaves folded into a tagged Message struct; decode is zero-copy:
// arrays alias the shared payload buffer.

#pragma once

#include <cstring>
#include <memory>
#include <optional>
#include <stdexcept>
#include <string>
#include <vector>

#include "array.h"
#include "nest.h"

namespace tbt {
namespace wire {

constexpr uint8_t kTagArray = 0x01;
constexpr uint8_t kTagList = 0x02;
constexpr uint8_t kTagDict = 0x03;
constexpr uint8_t kTagNone = 0x04;
constexpr uint8_t kTagInt = 0x05;
constexpr uint8_t kTagFloat = 0x06;
constexpr uint8_t kTagBool = 0x07;
constexpr uint8_t kTagString = 0x08;
// Versioned policy snapshot (fleet control plane, ISSUE 17). Python is
// the only publisher (fleet/snapshot_wire.py builds wire.PolicySnapshot
// messages); the C++ side decodes the frame into a reserved-key dict —
// {"__snapshot__": version, "params": nest, "dtypes": nest} — so a
// native observer on a control-plane socket never trips "unknown tag"
// on fleet traffic. Mirrors wire.py TAG_SNAPSHOT (WIRE-PARITY).
constexpr uint8_t kTagSnapshot = 0x09;

class WireError : public std::runtime_error {
 public:
  using std::runtime_error::runtime_error;
};

// Upper bound on a frame's payload length. A corrupt 4-byte header must
// surface as WireError before anyone allocates what it claims (a flipped
// bit can demand 4 GiB otherwise). Matches wire.py's
// DEFAULT_MAX_FRAME_BYTES; enforced at the frame readers (client.h).
constexpr size_t kMaxFrameBytes = 256ull * 1024 * 1024;

// A decoded wire value: arrays, strings, ints... The runtime only needs
// arrays + strings + ints for Step/Action messages, so the leaf is a small
// tagged struct rather than a full dynamic type.
struct Value {
  enum class Kind { kNone, kArray, kInt, kFloat, kBool, kString } kind =
      Kind::kNone;
  Array array;
  int64_t i = 0;
  double f = 0.0;
  bool b = false;
  std::string s;

  static Value of(Array a) {
    Value v;
    v.kind = Kind::kArray;
    v.array = std::move(a);
    return v;
  }
  static Value of_int(int64_t x) {
    Value v;
    v.kind = Kind::kInt;
    v.i = x;
    return v;
  }
  static Value of_string(std::string x) {
    Value v;
    v.kind = Kind::kString;
    v.s = std::move(x);
    return v;
  }
};

using ValueNest = Nest<Value>;

namespace detail {

inline void put_u32(std::vector<uint8_t>* buf, uint32_t x) {
  buf->push_back(x & 0xff);
  buf->push_back((x >> 8) & 0xff);
  buf->push_back((x >> 16) & 0xff);
  buf->push_back((x >> 24) & 0xff);
}

inline void put_i64(std::vector<uint8_t>* buf, int64_t x) {
  for (int i = 0; i < 8; ++i) buf->push_back((static_cast<uint64_t>(x) >> (8 * i)) & 0xff);
}

inline void put_bytes(std::vector<uint8_t>* buf, const void* p, size_t n) {
  const uint8_t* b = static_cast<const uint8_t*>(p);
  buf->insert(buf->end(), b, b + n);
}

struct Reader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  std::shared_ptr<void> owner;  // keeps the payload alive for array views

  uint8_t u8() {
    need(1);
    return data[pos++];
  }
  uint32_t u32() {
    need(4);
    uint32_t x = 0;
    for (int i = 0; i < 4; ++i) x |= static_cast<uint32_t>(data[pos + i]) << (8 * i);
    pos += 4;
    return x;
  }
  int64_t i64() {
    need(8);
    uint64_t x = 0;
    for (int i = 0; i < 8; ++i) x |= static_cast<uint64_t>(data[pos + i]) << (8 * i);
    pos += 8;
    return static_cast<int64_t>(x);
  }
  const uint8_t* bytes(size_t n) {
    need(n);
    const uint8_t* p = data + pos;
    pos += n;
    return p;
  }
  void need(size_t n) const {
    // Written as a subtraction so a huge `n` cannot wrap `pos + n` back
    // into range; `pos <= size` is an invariant of every advance above.
    if (n > size - pos) throw WireError("wire: truncated payload");
  }
};

}  // namespace detail

inline void encode_value(std::vector<uint8_t>* buf, const ValueNest& nest) {
  if (nest.is_leaf()) {
    const Value& v = nest.leaf();
    switch (v.kind) {
      case Value::Kind::kNone:
        buf->push_back(kTagNone);
        return;
      case Value::Kind::kBool:
        buf->push_back(kTagBool);
        buf->push_back(v.b ? 1 : 0);
        return;
      case Value::Kind::kInt:
        buf->push_back(kTagInt);
        detail::put_i64(buf, v.i);
        return;
      case Value::Kind::kFloat: {
        buf->push_back(kTagFloat);
        double d = v.f;
        detail::put_bytes(buf, &d, 8);
        return;
      }
      case Value::Kind::kString:
        buf->push_back(kTagString);
        detail::put_u32(buf, static_cast<uint32_t>(v.s.size()));
        detail::put_bytes(buf, v.s.data(), v.s.size());
        return;
      case Value::Kind::kArray: {
        const Array& a = v.array;
        buf->push_back(kTagArray);
        buf->push_back(static_cast<uint8_t>(a.dtype()));
        buf->push_back(static_cast<uint8_t>(a.ndim()));
        for (int64_t d : a.shape()) detail::put_i64(buf, d);
        detail::put_bytes(buf, a.data(), a.nbytes());
        return;
      }
    }
    throw WireError("wire: bad value kind");
  }
  if (nest.is_list()) {
    buf->push_back(kTagList);
    detail::put_u32(buf, static_cast<uint32_t>(nest.list().size()));
    for (const auto& n : nest.list()) encode_value(buf, n);
    return;
  }
  buf->push_back(kTagDict);
  detail::put_u32(buf, static_cast<uint32_t>(nest.dict().size()));
  for (const auto& [key, n] : nest.dict()) {
    uint16_t klen = static_cast<uint16_t>(key.size());
    buf->push_back(klen & 0xff);
    buf->push_back((klen >> 8) & 0xff);
    detail::put_bytes(buf, key.data(), key.size());
    encode_value(buf, n);
  }
}

// Full frame: u32 length prefix + payload.
inline std::vector<uint8_t> encode(const ValueNest& nest) {
  std::vector<uint8_t> payload;
  encode_value(&payload, nest);
  std::vector<uint8_t> framed;
  framed.reserve(payload.size() + 4);
  detail::put_u32(&framed, static_cast<uint32_t>(payload.size()));
  framed.insert(framed.end(), payload.begin(), payload.end());
  return framed;
}

inline ValueNest decode_value(detail::Reader* r) {
  uint8_t tag = r->u8();
  switch (tag) {
    case kTagNone:
      return ValueNest(Value{});
    case kTagBool: {
      Value v;
      v.kind = Value::Kind::kBool;
      v.b = r->u8() != 0;
      return ValueNest(std::move(v));
    }
    case kTagInt:
      return ValueNest(Value::of_int(r->i64()));
    case kTagFloat: {
      Value v;
      v.kind = Value::Kind::kFloat;
      std::memcpy(&v.f, r->bytes(8), 8);
      return ValueNest(std::move(v));
    }
    case kTagString: {
      uint32_t n = r->u32();
      const uint8_t* p = r->bytes(n);
      return ValueNest(
          Value::of_string(std::string(reinterpret_cast<const char*>(p), n)));
    }
    case kTagArray: {
      DType dtype = static_cast<DType>(r->u8());
      size_t isize = itemsize(dtype);  // throws on unknown dtype byte
      uint8_t ndim = r->u8();
      std::vector<int64_t> shape(ndim);
      for (auto& d : shape) d = r->i64();
      // Untrusted dims: reject negatives and anything whose byte count
      // could not fit in the frame anyway. The remaining payload bounds
      // the product, so overflow-check against that rather than SIZE_MAX.
      // Any zero dim makes the array empty regardless of the other dims.
      bool empty = false;
      for (int64_t d : shape) {
        if (d < 0) throw WireError("wire: negative array dim");
        if (d == 0) empty = true;
      }
      const size_t remaining = r->size - r->pos;
      size_t nbytes = empty ? 0 : isize;
      if (!empty) {
        for (int64_t d : shape) {
          if (nbytes > remaining / static_cast<size_t>(d))
            throw WireError("wire: array size exceeds payload");
          nbytes *= static_cast<size_t>(d);
        }
      }
      const uint8_t* p = r->bytes(nbytes);
      // Zero-copy: the array aliases the payload buffer via the owner.
      return ValueNest(Value::of(Array(
          dtype, std::move(shape), const_cast<uint8_t*>(p), r->owner)));
    }
    case kTagList: {
      uint32_t n = r->u32();
      // Each element is at least 1 byte, so an honest count is bounded by
      // the remaining payload — reserve() on a raw attacker u32 would be
      // a one-frame multi-GB allocation.
      if (n > r->size - r->pos)
        throw WireError("wire: list count exceeds payload");
      ValueNest::List out;
      out.reserve(n);
      for (uint32_t i = 0; i < n; ++i) out.push_back(decode_value(r));
      return ValueNest(std::move(out));
    }
    case kTagDict: {
      uint32_t n = r->u32();
      if (n > r->size - r->pos)
        throw WireError("wire: dict count exceeds payload");
      ValueNest::Dict out;
      for (uint32_t i = 0; i < n; ++i) {
        uint16_t klen = r->u8();
        klen |= static_cast<uint16_t>(r->u8()) << 8;
        const uint8_t* p = r->bytes(klen);
        std::string key(reinterpret_cast<const char*>(p), klen);
        out.emplace(std::move(key), decode_value(r));
      }
      return ValueNest(std::move(out));
    }
    case kTagSnapshot: {
      // u64le version + params value + dtypes value (wire.py layout).
      // Reuse the i64 reader: snapshot versions are update counts and
      // never approach the sign bit.
      int64_t version = r->i64();
      if (version < 0) throw WireError("wire: negative snapshot version");
      ValueNest params = decode_value(r);
      ValueNest dtypes = decode_value(r);
      ValueNest::Dict out;
      out.emplace("__snapshot__", ValueNest(Value::of_int(version)));
      out.emplace("params", std::move(params));
      out.emplace("dtypes", std::move(dtypes));
      return ValueNest(std::move(out));
    }
    default:
      throw WireError("wire: unknown tag " + std::to_string(tag));
  }
}

// Payload (no length prefix); `owner` must keep `data` alive as long as the
// decoded arrays are used.
inline ValueNest decode(const uint8_t* data, size_t size,
                        std::shared_ptr<void> owner) {
  detail::Reader r{data, size, 0, std::move(owner)};
  ValueNest out = decode_value(&r);
  if (r.pos != r.size) throw WireError("wire: trailing garbage");
  return out;
}

}  // namespace wire
}  // namespace tbt
