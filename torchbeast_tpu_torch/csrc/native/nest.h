// Nest<T>: recursive container of leaves, sequences, and string maps.
//
// The C++ counterpart of JAX pytrees for the native runtime layers —
// capability parity with the reference's standalone nest library
// (/root/reference/nest/nest/nest.h: map/map2/flatten/pack_as/for_each/
// front), written fresh around std::variant with free-function visitors
// and sorted-key map traversal (matching the Python side's pytree order,
// torchbeast_tpu/nest.py).

#pragma once

#include <functional>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <utility>
#include <variant>
#include <vector>

namespace tbt {

template <typename T>
class Nest {
 public:
  using List = std::vector<Nest<T>>;
  using Dict = std::map<std::string, Nest<T>>;  // sorted keys
  using Value = std::variant<T, List, Dict>;

  Nest() : value_(List{}) {}
  /* implicit */ Nest(T leaf) : value_(std::move(leaf)) {}
  /* implicit */ Nest(List list) : value_(std::move(list)) {}
  /* implicit */ Nest(Dict dict) : value_(std::move(dict)) {}

  bool is_leaf() const { return std::holds_alternative<T>(value_); }
  bool is_list() const { return std::holds_alternative<List>(value_); }
  bool is_dict() const { return std::holds_alternative<Dict>(value_); }

  const T& leaf() const { return std::get<T>(value_); }
  T& leaf() { return std::get<T>(value_); }
  const List& list() const { return std::get<List>(value_); }
  List& list() { return std::get<List>(value_); }
  const Dict& dict() const { return std::get<Dict>(value_); }
  Dict& dict() { return std::get<Dict>(value_); }

  bool empty() const {
    if (is_leaf()) return false;
    if (is_list()) {
      for (const auto& n : list())
        if (!n.empty()) return false;
      return true;
    }
    for (const auto& [k, n] : dict())
      if (!n.empty()) return false;
    return true;
  }

  // Depth-first leaf visit.
  void for_each(const std::function<void(const T&)>& fn) const {
    if (is_leaf()) {
      fn(leaf());
    } else if (is_list()) {
      for (const auto& n : list()) n.for_each(fn);
    } else {
      for (const auto& [k, n] : dict()) n.for_each(fn);
    }
  }

  // First leaf in depth-first order; throws on empty.
  const T& front() const {
    const T* found = nullptr;
    try_front(&found);
    if (!found) throw std::invalid_argument("front() on empty nest");
    return *found;
  }

  std::vector<T> flatten() const {
    std::vector<T> out;
    for_each([&out](const T& t) { out.push_back(t); });
    return out;
  }

  // Structure-preserving unary transform.
  template <typename F>
  auto map(const F& fn) const -> Nest<decltype(fn(std::declval<T>()))> {
    using U = decltype(fn(std::declval<T>()));
    if (is_leaf()) return Nest<U>(fn(leaf()));
    if (is_list()) {
      typename Nest<U>::List out;
      out.reserve(list().size());
      for (const auto& n : list()) out.push_back(n.map(fn));
      return Nest<U>(std::move(out));
    }
    typename Nest<U>::Dict out;
    for (const auto& [k, n] : dict()) out.emplace(k, n.map(fn));
    return Nest<U>(std::move(out));
  }

  // Structure-checked binary transform.
  template <typename F>
  static Nest<T> map2(const F& fn, const Nest<T>& a, const Nest<T>& b) {
    if (a.is_leaf() && b.is_leaf()) return Nest<T>(fn(a.leaf(), b.leaf()));
    if (a.is_list() && b.is_list()) {
      if (a.list().size() != b.list().size())
        throw std::invalid_argument("map2: list length mismatch");
      List out;
      out.reserve(a.list().size());
      for (size_t i = 0; i < a.list().size(); ++i)
        out.push_back(map2(fn, a.list()[i], b.list()[i]));
      return Nest<T>(std::move(out));
    }
    if (a.is_dict() && b.is_dict()) {
      if (a.dict().size() != b.dict().size())
        throw std::invalid_argument("map2: dict size mismatch");
      Dict out;
      auto ita = a.dict().begin();
      auto itb = b.dict().begin();
      for (; ita != a.dict().end(); ++ita, ++itb) {
        if (ita->first != itb->first)
          throw std::invalid_argument("map2: dict key mismatch");
        out.emplace(ita->first, map2(fn, ita->second, itb->second));
      }
      return Nest<T>(std::move(out));
    }
    throw std::invalid_argument("map2: structure mismatch");
  }

  // Rebuild this structure from a flat leaf vector (inverse of flatten).
  Nest<T> pack_as(const std::vector<T>& flat) const {
    size_t index = 0;
    Nest<T> out = pack_from(flat, &index);
    if (index != flat.size())
      throw std::invalid_argument("pack_as: too many leaves");
    return out;
  }

  // Zip N structurally-equal nests into one nest of leaf-vectors — the
  // batch former's building block.
  static Nest<std::vector<T>> zip(const std::vector<Nest<T>>& nests) {
    if (nests.empty()) throw std::invalid_argument("zip: empty input");
    const Nest<T>& head = nests.front();
    if (head.is_leaf()) {
      std::vector<T> leaves;
      leaves.reserve(nests.size());
      for (const auto& n : nests) {
        if (!n.is_leaf()) throw std::invalid_argument("zip: structure mismatch");
        leaves.push_back(n.leaf());
      }
      return Nest<std::vector<T>>(std::move(leaves));
    }
    if (head.is_list()) {
      typename Nest<std::vector<T>>::List out;
      for (size_t i = 0; i < head.list().size(); ++i) {
        std::vector<Nest<T>> column;
        column.reserve(nests.size());
        for (const auto& n : nests) {
          if (!n.is_list() || n.list().size() != head.list().size())
            throw std::invalid_argument("zip: structure mismatch");
          column.push_back(n.list()[i]);
        }
        out.push_back(zip(column));
      }
      return Nest<std::vector<T>>(std::move(out));
    }
    typename Nest<std::vector<T>>::Dict out;
    for (const auto& [key, sub] : head.dict()) {
      std::vector<Nest<T>> column;
      column.reserve(nests.size());
      for (const auto& n : nests) {
        if (!n.is_dict()) throw std::invalid_argument("zip: structure mismatch");
        auto it = n.dict().find(key);
        if (it == n.dict().end() || n.dict().size() != head.dict().size())
          throw std::invalid_argument("zip: dict key mismatch");
        column.push_back(it->second);
      }
      out.emplace(key, zip(column));
    }
    return Nest<std::vector<T>>(std::move(out));
  }

 private:
  void try_front(const T** found) const {
    if (*found) return;
    if (is_leaf()) {
      *found = &leaf();
    } else if (is_list()) {
      for (const auto& n : list()) {
        n.try_front(found);
        if (*found) return;
      }
    } else {
      for (const auto& [k, n] : dict()) {
        n.try_front(found);
        if (*found) return;
      }
    }
  }

  Nest<T> pack_from(const std::vector<T>& flat, size_t* index) const {
    if (is_leaf()) {
      if (*index >= flat.size())
        throw std::invalid_argument("pack_as: too few leaves");
      return Nest<T>(flat[(*index)++]);
    }
    if (is_list()) {
      List out;
      out.reserve(list().size());
      for (const auto& n : list()) out.push_back(n.pack_from(flat, index));
      return Nest<T>(std::move(out));
    }
    Dict out;
    for (const auto& [k, n] : dict()) out.emplace(k, n.pack_from(flat, index));
    return Nest<T>(std::move(out));
  }

  Value value_;
};

}  // namespace tbt
