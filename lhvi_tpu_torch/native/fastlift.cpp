// fastlift: native color-refinement core for lifted compression.
//
// The reference's CompressedGraph fixpoint (SURVEY.md §4.2) is a symbolic,
// unjittable host loop: per round it re-hashes every factor's neighbor
// color tuple and every RV's multiset of (factor color, position) pairs.
// In Python (dict hashing per edge per round) this is the host-side
// bottleneck for ~1e5-variable pod-scale groundings; here it is a tight
// O(E log E)-per-round C++ loop exposed via a C ABI (loaded with ctypes —
// no pybind11 dependency).
//
// Colors are canonical ints; the caller provides initial colors (domain/
// evidence buckets for RVs, potential identity for factors).
//
// Build: g++ -O3 -march=native -shared -fPIC fastlift.cpp -o libfastlift.so

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <algorithm>

namespace {

inline uint64_t mix(uint64_t h, uint64_t v) {
  // splitmix64-style combine
  v += 0x9e3779b97f4a7c15ULL + h;
  v = (v ^ (v >> 30)) * 0xbf58476d1ce4e5b9ULL;
  v = (v ^ (v >> 27)) * 0x94d049bb133111ebULL;
  return v ^ (v >> 31);
}

// canonicalize 64-bit signatures to dense int colors (order of first
// appearance — deterministic given input order)
int32_t canonicalize(const std::vector<uint64_t>& sig, int32_t* out,
                     int64_t n) {
  std::unordered_map<uint64_t, int32_t> lut;
  lut.reserve(static_cast<size_t>(n) * 2);
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    auto it = lut.find(sig[i]);
    if (it == lut.end()) {
      lut.emplace(sig[i], next);
      out[i] = next++;
    } else {
      out[i] = it->second;
    }
  }
  return next;
}

}  // namespace

extern "C" {

// Returns the number of refinement rounds executed (>=1), or -1 on error.
// f_off:   [n_f+1] CSR offsets into f_rvs
// f_rvs:   [f_off[n_f]] ordered factor argument RV indices
// f_sym:   [n_f] 1 if the potential is argument-permutation invariant
// rv_color:[n_rv] in: initial colors; out: final canonical colors
// f_color: [n_f]  in: initial colors; out: final canonical colors
int64_t lhvi_color_refine(int64_t n_rv, int64_t n_f, const int64_t* f_off,
                          const int32_t* f_rvs, const uint8_t* f_sym,
                          int32_t* rv_color, int32_t* f_color,
                          int64_t max_rounds) {
  if (n_rv < 0 || n_f < 0) return -1;
  const int64_t n_edges = f_off[n_f];

  // RV->factor incidence (factor idx, position; position -1 if symmetric)
  std::vector<int64_t> rv_deg(n_rv + 1, 0);
  for (int64_t f = 0; f < n_f; ++f)
    for (int64_t e = f_off[f]; e < f_off[f + 1]; ++e) rv_deg[f_rvs[e] + 1]++;
  std::vector<int64_t> rv_off(n_rv + 1, 0);
  for (int64_t v = 0; v < n_rv; ++v) rv_off[v + 1] = rv_off[v] + rv_deg[v + 1];
  std::vector<int64_t> inc_f(n_edges);
  std::vector<int32_t> inc_pos(n_edges);
  {
    std::vector<int64_t> cursor(rv_off.begin(), rv_off.end() - 1);
    for (int64_t f = 0; f < n_f; ++f) {
      int32_t pos = 0;
      for (int64_t e = f_off[f]; e < f_off[f + 1]; ++e, ++pos) {
        int32_t v = f_rvs[e];
        int64_t c = cursor[v]++;
        inc_f[c] = f;
        inc_pos[c] = f_sym[f] ? -1 : pos;
      }
    }
  }

  std::vector<uint64_t> fsig(n_f), vsig(n_rv);
  std::vector<int32_t> scratch;
  std::vector<uint64_t> pair_sig;

  int32_t n_rv_colors = canonicalize(
      [&] {
        std::vector<uint64_t> s(n_rv);
        for (int64_t v = 0; v < n_rv; ++v)
          s[v] = static_cast<uint64_t>(rv_color[v]);
        return s;
      }(),
      rv_color, n_rv);
  int32_t n_f_colors = canonicalize(
      [&] {
        std::vector<uint64_t> s(n_f);
        for (int64_t f = 0; f < n_f; ++f)
          s[f] = static_cast<uint64_t>(f_color[f]);
        return s;
      }(),
      f_color, n_f);

  int64_t round = 0;
  for (; round < max_rounds; ++round) {
    // --- factor pass: hash (own color, nb rv colors in arg order/sorted)
    for (int64_t f = 0; f < n_f; ++f) {
      uint64_t h = mix(0x8b3f0ull, static_cast<uint64_t>(f_color[f]));
      const int64_t a = f_off[f], b = f_off[f + 1];
      if (f_sym[f]) {
        scratch.clear();
        for (int64_t e = a; e < b; ++e) scratch.push_back(rv_color[f_rvs[e]]);
        std::sort(scratch.begin(), scratch.end());
        for (int32_t c : scratch) h = mix(h, static_cast<uint64_t>(c));
      } else {
        for (int64_t e = a; e < b; ++e)
          h = mix(h, static_cast<uint64_t>(rv_color[f_rvs[e]]));
      }
      fsig[f] = h;
    }
    int32_t nf2 = canonicalize(fsig, f_color, n_f);

    // --- rv pass: hash (own color, sorted multiset of (f color, pos))
    for (int64_t v = 0; v < n_rv; ++v) {
      const int64_t a = rv_off[v], b = rv_off[v + 1];
      pair_sig.clear();
      for (int64_t c = a; c < b; ++c) {
        uint64_t p =
            (static_cast<uint64_t>(static_cast<uint32_t>(f_color[inc_f[c]]))
             << 32) |
            static_cast<uint64_t>(static_cast<uint32_t>(inc_pos[c] + 1));
        pair_sig.push_back(p);
      }
      std::sort(pair_sig.begin(), pair_sig.end());
      uint64_t h = mix(0x51ab7ull, static_cast<uint64_t>(rv_color[v]));
      for (uint64_t p : pair_sig) h = mix(h, p);
      vsig[v] = h;
    }
    int32_t nv2 = canonicalize(vsig, rv_color, n_rv);

    if (nv2 == n_rv_colors && nf2 == n_f_colors) {
      ++round;
      break;
    }
    n_rv_colors = nv2;
    n_f_colors = nf2;
  }
  return round;
}

}  // extern "C"
