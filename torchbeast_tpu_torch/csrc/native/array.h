// Array: the framework-neutral dense array carried through the C++ runtime.
//
// Plays the role torch::Tensor plays inside the reference's libtorchbeast
// (SURVEY.md §2.1 N3-N5) without the torch dependency: the C++ layers only
// ever move, concatenate, and slice contiguous buffers; all math happens in
// XLA. Buffers are shared_ptr-owned so queue hand-offs are refcount bumps.

#pragma once

#include <cstdint>
#include <cstring>
#include <memory>
#include <numeric>
#include <stdexcept>
#include <string>
#include <vector>

namespace tbt {

// Dtype codes shared with the Python codec (torchbeast_tpu/runtime/wire.py).
enum class DType : uint8_t {
  kU8 = 0,
  kI8 = 1,
  kI32 = 2,
  kI64 = 3,
  kF32 = 4,
  kF64 = 5,
  kBool = 6,
  kU16 = 7,
  kI16 = 8,
  kU32 = 9,
  kU64 = 10,
  kF16 = 11,
  // bfloat16 (truncated f32; TPU-native activations). No host math ever
  // touches the payload here — the runtime only moves bytes — so no
  // bf16 arithmetic support is needed, just the itemsize.
  kBF16 = 12,
};

inline size_t itemsize(DType dtype) {
  switch (dtype) {
    case DType::kU8:
    case DType::kI8:
    case DType::kBool:
      return 1;
    case DType::kU16:
    case DType::kI16:
    case DType::kF16:
    case DType::kBF16:
      return 2;
    case DType::kI32:
    case DType::kU32:
    case DType::kF32:
      return 4;
    case DType::kI64:
    case DType::kU64:
    case DType::kF64:
      return 8;
  }
  throw std::invalid_argument("unknown dtype");
}

class Array {
 public:
  Array() : dtype_(DType::kU8) {}

  // Owns a fresh zeroed buffer.
  Array(DType dtype, std::vector<int64_t> shape)
      : dtype_(dtype), shape_(std::move(shape)) {
    storage_ = std::make_shared<std::vector<uint8_t>>(nbytes());
    data_ = storage_->data();
  }

  // Wraps external memory kept alive by `owner`.
  Array(DType dtype, std::vector<int64_t> shape, void* data,
        std::shared_ptr<void> owner)
      : dtype_(dtype),
        shape_(std::move(shape)),
        owner_(std::move(owner)),
        data_(static_cast<uint8_t*>(data)) {}

  DType dtype() const { return dtype_; }
  const std::vector<int64_t>& shape() const { return shape_; }
  int64_t ndim() const { return static_cast<int64_t>(shape_.size()); }
  int64_t dim(int64_t i) const { return shape_.at(i); }

  int64_t numel() const {
    return std::accumulate(shape_.begin(), shape_.end(), int64_t{1},
                           std::multiplies<int64_t>());
  }
  size_t nbytes() const { return static_cast<size_t>(numel()) * itemsize(dtype_); }

  const uint8_t* data() const { return data_; }
  uint8_t* mutable_data() { return data_; }

  // Deep copy into freshly-owned memory.
  Array clone() const {
    Array out(dtype_, shape_);
    std::memcpy(out.mutable_data(), data_, nbytes());
    return out;
  }

 private:
  DType dtype_;
  std::vector<int64_t> shape_;
  std::shared_ptr<std::vector<uint8_t>> storage_;  // when self-owned
  std::shared_ptr<void> owner_;                    // when wrapping
  uint8_t* data_ = nullptr;
};

// Concatenate along `dim`. All inputs must agree on dtype and on every
// other dimension (the queue-side batch former; the reference used
// torch::cat, actorpool.cc:49-55).
inline Array concatenate(const std::vector<Array>& arrays, int64_t dim) {
  if (arrays.empty()) throw std::invalid_argument("concatenate: no arrays");
  const Array& first = arrays.front();
  if (dim < 0 || dim >= first.ndim())
    throw std::out_of_range("concatenate: bad dim");

  std::vector<int64_t> out_shape = first.shape();
  int64_t cat_size = 0;
  for (const Array& a : arrays) {
    if (a.dtype() != first.dtype())
      throw std::invalid_argument("concatenate: dtype mismatch");
    if (a.ndim() != first.ndim())
      throw std::invalid_argument("concatenate: rank mismatch");
    for (int64_t d = 0; d < first.ndim(); ++d) {
      if (d != dim && a.dim(d) != first.dim(d))
        throw std::invalid_argument("concatenate: shape mismatch");
    }
    cat_size += a.dim(dim);
  }
  out_shape[dim] = cat_size;
  Array out(first.dtype(), out_shape);

  // Contiguous layout: view every array as [outer, inner_bytes] where
  // inner spans dims >= dim; interleave the blocks.
  int64_t outer = 1;
  for (int64_t d = 0; d < dim; ++d) outer *= first.dim(d);
  const size_t unit = itemsize(first.dtype());
  size_t out_inner = out.nbytes() / (outer ? outer : 1);
  size_t offset = 0;
  for (const Array& a : arrays) {
    size_t a_inner = outer ? a.nbytes() / outer : 0;
    for (int64_t o = 0; o < outer; ++o) {
      std::memcpy(out.mutable_data() + o * out_inner + offset,
                  a.data() + o * a_inner, a_inner);
    }
    offset += a_inner;
  }
  (void)unit;
  return out;
}

// View rows [start, start+count) along `dim` — zero-copy when dim==0,
// copying otherwise.
inline Array slice(const Array& a, int64_t dim, int64_t start, int64_t count) {
  if (dim < 0 || dim >= a.ndim()) throw std::out_of_range("slice: bad dim");
  if (start < 0 || start + count > a.dim(dim))
    throw std::out_of_range("slice: out of range");
  std::vector<int64_t> out_shape = a.shape();
  out_shape[dim] = count;

  int64_t outer = 1;
  for (int64_t d = 0; d < dim; ++d) outer *= a.dim(d);
  int64_t inner = 1;
  for (int64_t d = dim + 1; d < a.ndim(); ++d) inner *= a.dim(d);
  const size_t unit = itemsize(a.dtype());
  const size_t row = inner * unit;

  Array out(a.dtype(), out_shape);
  for (int64_t o = 0; o < outer; ++o) {
    std::memcpy(out.mutable_data() + o * count * row,
                a.data() + (o * a.dim(dim) + start) * row, count * row);
  }
  return out;
}

}  // namespace tbt
