// Host-side sparse-convolution rulebooks: the port's copy of the JAX
// package's native rulebook builder (csrc/abr_host.cpp:480-862 at the
// repository root: abr_subm_rulebook, abr_strided_layout,
// abr_block_rulebooks and the helpers they use; its voxelizer, IoU and
// evaluation functions are not copied).
//
// The input pipeline runs these on the host for every example of a
// host-rulebook config (people.fhd, car.lite, car.fhd.mixed), so the
// sparse middle receives its tables with the batch.  Semantics are
// bit-identical to the device merge builders in ops/sparse_conv.py
// (build_submanifold_rulebook_merge / build_strided_layout_merge): the
// same tap order, the same sorted-unique output sites, the same
// truncation at max_out.  coords are [N,3] int32 (z,y,x); rows with
// z < 0 are padding.
//
// Plain C ABI for ctypes (which releases the GIL during a call, so the
// loader's threads build rulebooks in parallel).  Built with g++ at first
// use by ops/_build.py::load_host:
//
//   g++ -O3 -std=c++17 -shared -fPIC -o _build/librulebook_host-<hash>.so
//       csrc/rulebook_host.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// DEPTH-MINOR key (y*W + x)*D + z — matches ops/sparse_conv.py::linearize.
// With (y, x, z)-sorted sites every kernel-tap neighbor stays within a few
// BEV rows in index space; dz taps differ by consecutive keys.
static inline int64_t lin_key(int32_t z, int32_t y, int32_t x,
                              const int32_t* grid) {
  if (z < 0 || z >= grid[0] || y < 0 || y >= grid[1] || x < 0 ||
      x >= grid[2])
    return -1;
  return ((int64_t)y * grid[2] + x) * grid[0] + z;
}

// Open-addressing hash table (linear probing, power-of-two capacity) —
// ~4x faster than std::unordered_map for these build-once/query-many
// coord tables.  Keys are non-negative linear voxel keys; empty = -1.
struct CoordTable {
  std::vector<int64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;

  explicit CoordTable(int64_t n) {
    uint64_t cap = 16;
    while (cap < (uint64_t)(n * 2 + 1)) cap <<= 1;
    keys.assign(cap, -1);
    vals.resize(cap);
    mask = cap - 1;
  }
  static inline uint64_t hash(int64_t k) {
    uint64_t h = (uint64_t)k;
    h ^= h >> 33; h *= 0xff51afd7ed558ccdULL; h ^= h >> 33;
    return h;
  }
  // first-wins insert (matches the device's stable-argsort semantics)
  inline void insert(int64_t key, int32_t val) {
    uint64_t i = hash(key) & mask;
    while (keys[i] != -1) {
      if (keys[i] == key) return;
      i = (i + 1) & mask;
    }
    keys[i] = key;
    vals[i] = val;
  }
  inline int32_t find(int64_t key) const {   // -1 when absent
    uint64_t i = hash(key) & mask;
    while (keys[i] != -1) {
      if (keys[i] == key) return vals[i];
      i = (i + 1) & mask;
    }
    return -1;
  }
};

static CoordTable build_coord_table(const int32_t* coords, int64_t N,
                                    const int32_t* grid) {
  CoordTable table(N);
  for (int64_t i = 0; i < N; ++i) {
    const int32_t* c = coords + i * 3;
    if (c[0] < 0) continue;
    const int64_t key = lin_key(c[0], c[1], c[2], grid);
    if (key >= 0) table.insert(key, (int32_t)i);
  }
  return table;
}

// coords [N,3] -> gather_idx [K,N] int32 + found [K,N] uint8 where
// K = kz*ky*kx, offsets enumerated (dz slowest, dx fastest), each centered
// (arange(k) - k//2).  gather_idx[k,i] = index j with coords[j] ==
// coords[i] + offset[k]; 0 (masked) when absent.
void abr_subm_rulebook(const int32_t* coords, int64_t N, const int32_t* grid,
                       const int32_t* ksize, int32_t* gather_idx,
                       uint8_t* found) {
  const CoordTable table = build_coord_table(coords, N, grid);
  const int32_t kz = ksize[0], ky = ksize[1], kx = ksize[2];
  int64_t k = 0;
  for (int32_t dz = -(kz / 2); dz < kz - kz / 2; ++dz)
    for (int32_t dy = -(ky / 2); dy < ky - ky / 2; ++dy)
      for (int32_t dx = -(kx / 2); dx < kx - kx / 2; ++dx, ++k) {
        int32_t* gi = gather_idx + k * N;
        uint8_t* fo = found + k * N;
        for (int64_t i = 0; i < N; ++i) {
          const int32_t* c = coords + i * 3;
          gi[i] = 0;
          fo[i] = 0;
          if (c[0] < 0) continue;
          const int64_t key = lin_key(c[0] + dz, c[1] + dy, c[2] + dx, grid);
          if (key < 0) continue;
          const int32_t j = table.find(key);
          if (j >= 0) {
            gi[i] = j;
            fo[i] = 1;
          }
        }
      }
}

// Strided sparse conv output layout + rulebook.  Output site o (per dim)
// receives input i iff o*s + t - p == i for some tap t in [0,k).  Output
// sites are the sorted-unique linear keys of all touched sites, truncated
// to max_out (ascending).  Taps enumerated (tz slowest, tx fastest).
// Returns the (untruncated-capped) number of outputs.
int abr_strided_layout(const int32_t* coords, int64_t N, const int32_t* grid,
                       const int32_t* ksize, const int32_t* stride,
                       const int32_t* pad, int64_t max_out,
                       int32_t* out_coords, uint8_t* out_valid,
                       int32_t* gather_idx, uint8_t* found) {
  int32_t out_grid[3];
  for (int d = 0; d < 3; ++d)
    out_grid[d] = (grid[d] + 2 * pad[d] - ksize[d]) / stride[d] + 1;

  // candidate output keys from every valid input
  std::vector<int64_t> cand;
  cand.reserve((size_t)N * 8);
  for (int64_t i = 0; i < N; ++i) {
    const int32_t* c = coords + i * 3;
    if (c[0] < 0) continue;
    int32_t lo[3], hi[3];
    for (int d = 0; d < 3; ++d) {
      const int32_t ip = c[d] + pad[d];
      int32_t l = ip - ksize[d] + 1;
      // ceil-div for possibly negative numerator
      lo[d] = l >= 0 ? (l + stride[d] - 1) / stride[d] : -((-l) / stride[d]);
      hi[d] = ip / stride[d];
      if (lo[d] < 0) lo[d] = 0;
      if (hi[d] >= out_grid[d]) hi[d] = out_grid[d] - 1;
    }
    for (int32_t oz = lo[0]; oz <= hi[0]; ++oz)
      for (int32_t oy = lo[1]; oy <= hi[1]; ++oy)
        for (int32_t ox = lo[2]; ox <= hi[2]; ++ox)
          cand.push_back(((int64_t)oy * out_grid[2] + ox) * out_grid[0] + oz);
  }
  std::sort(cand.begin(), cand.end());
  cand.erase(std::unique(cand.begin(), cand.end()), cand.end());
  const int64_t num_out =
      std::min<int64_t>((int64_t)cand.size(), max_out);

  for (int64_t o = 0; o < max_out; ++o) {
    if (o < num_out) {
      const int64_t key = cand[o];
      out_coords[o * 3 + 0] = (int32_t)(key % out_grid[0]);
      out_coords[o * 3 + 1] = (int32_t)(key / ((int64_t)out_grid[2] *
                                               out_grid[0]));
      out_coords[o * 3 + 2] = (int32_t)((key / out_grid[0]) % out_grid[2]);
      out_valid[o] = 1;
    } else {
      out_coords[o * 3 + 0] = -1;
      out_coords[o * 3 + 1] = -1;
      out_coords[o * 3 + 2] = -1;
      out_valid[o] = 0;
    }
  }

  // input hash table for tap lookups
  const CoordTable table = build_coord_table(coords, N, grid);

  int64_t t = 0;
  for (int32_t tz = 0; tz < ksize[0]; ++tz)
    for (int32_t ty = 0; ty < ksize[1]; ++ty)
      for (int32_t tx = 0; tx < ksize[2]; ++tx, ++t) {
        int32_t* gi = gather_idx + t * max_out;
        uint8_t* fo = found + t * max_out;
        for (int64_t o = 0; o < max_out; ++o) {
          gi[o] = 0;
          fo[o] = 0;
          if (o >= num_out) continue;
          const int32_t iz = out_coords[o * 3 + 0] * stride[0] + tz - pad[0];
          const int32_t iy = out_coords[o * 3 + 1] * stride[1] + ty - pad[1];
          const int32_t ix = out_coords[o * 3 + 2] * stride[2] + tx - pad[2];
          const int64_t key = lin_key(iz, iy, ix, grid);
          if (key < 0) continue;
          const int32_t j = table.find(key);
          if (j >= 0) {
            gi[o] = j;
            fo[o] = 1;
          }
        }
      }
  return (int)num_out;
}

// ---------------------------------------------------------------------------
// Combined per-block rulebook build — sort + two-pointer merge.
//
// The hash-table builders above cost ~25 ns/probe; this version exploits
// that every kernel tap's query stream is the (bounds-checked) input key
// stream plus a constant, hence already sorted: one sort of the active
// keys serves every tap of both the submanifold rulebook and the strided
// layout via sequential two-pointer merges (O(N) per tap, cache-friendly).
// Semantics identical to abr_subm_rulebook + abr_strided_layout.

namespace {

struct SortedKeys {
  std::vector<int64_t> keys;   // ascending, valid rows only
  std::vector<int32_t> idx;    // original row per sorted key
  std::vector<int32_t> cz, cy, cx;  // coords in sorted order (sequential)
};

SortedKeys sort_keys(const int32_t* coords, int64_t N, const int32_t* grid) {
  SortedKeys s;
  std::vector<std::pair<int64_t, int32_t>> kv;
  kv.reserve(N);
  for (int64_t i = 0; i < N; ++i) {
    const int32_t* c = coords + i * 3;
    if (c[0] < 0) continue;
    const int64_t key = lin_key(c[0], c[1], c[2], grid);
    if (key >= 0) kv.emplace_back(key, (int32_t)i);
  }
  std::sort(kv.begin(), kv.end());
  const int64_t M = (int64_t)kv.size();
  s.keys.resize(M); s.idx.resize(M);
  s.cz.resize(M); s.cy.resize(M); s.cx.resize(M);
  for (int64_t q = 0; q < M; ++q) {
    s.keys[q] = kv[q].first;
    const int32_t row = kv[q].second;
    s.idx[q] = row;
    s.cz[q] = coords[row * 3 + 0];
    s.cy[q] = coords[row * 3 + 1];
    s.cx[q] = coords[row * 3 + 2];
  }
  return s;
}

// One merge walk resolves ALL kz z-taps at once: for a fixed (dy, dx)
// the dz query keys are consecutive integers (depth-minor keys), so after
// advancing the pointer the candidates sit in keys[j..j+kz-1] (keys are
// unique).  gi/fo are the tap-major outputs with row stride N;
// k_base = tap index of (dz == -(kz/2), dy, dx); k_stride = ky*kx.
inline void merge_tapz(const SortedKeys& s, const int32_t* grid,
                       int32_t dy, int32_t dx, int32_t kz, int64_t k_base,
                       int64_t k_stride, int64_t N,
                       int32_t* gi, uint8_t* fo) {
  const int64_t M = (int64_t)s.keys.size();
  const int32_t D = grid[0];
  const int32_t z_lo = -(kz / 2);
  const int64_t delta = ((int64_t)dy * grid[2] + dx) * grid[0] + z_lo;
  int64_t j = 0;
  for (int64_t q = 0; q < M; ++q) {
    const int32_t y = s.cy[q] + dy, x = s.cx[q] + dx;
    if (y < 0 || y >= grid[1] || x < 0 || x >= grid[2]) continue;
    const int32_t z0 = s.cz[q] + z_lo;       // z of the first z-tap
    const int64_t qbase = s.keys[q] + delta;
    while (j < M && s.keys[j] < qbase) ++j;
    const int32_t row = s.idx[q];
    for (int64_t jj = j; jj < M && jj < j + kz &&
                         s.keys[jj] <= qbase + kz - 1; ++jj) {
      const int64_t d = s.keys[jj] - qbase;  // dz tap offset 0..kz-1
      if (d < 0 || d >= kz) continue;
      const int32_t zq = z0 + (int32_t)d;    // column-wrap guard
      if (zq < 0 || zq >= D) continue;
      gi[(k_base + d * k_stride) * N + row] = s.idx[jj];
      fo[(k_base + d * k_stride) * N + row] = 1;
    }
  }
}

// Ascending set-bit scan over a bitmap of out_total cells.
struct Bitmap {
  std::vector<uint64_t> words;
  explicit Bitmap(int64_t n) : words((size_t)((n + 63) / 64), 0) {}
  inline void set(int64_t i) { words[i >> 6] |= (1ULL << (i & 63)); }
};

}  // namespace

// One call builds everything models/middle.SparseMiddle needs for a block:
// the submanifold rulebook over the input sites and the strided layout +
// rulebook of the downsample conv.  Returns num_out of the strided conv.
int abr_block_rulebooks(const int32_t* coords, int64_t N,
                        const int32_t* grid, const int32_t* ksize,
                        const int32_t* stride, const int32_t* pad,
                        int64_t max_out, int32_t* subm_idx,
                        uint8_t* subm_found, int32_t* out_coords,
                        uint8_t* out_valid, int32_t* down_idx,
                        uint8_t* down_found) {
  const SortedKeys s = sort_keys(coords, N, grid);
  const int32_t kz = ksize[0], ky = ksize[1], kx = ksize[2];
  const int64_t M = (int64_t)s.keys.size();

  // submanifold rulebook: centered offsets, dz slowest in tap order.
  // Depth-minor keys make the kz z-taps of each (dy, dx) consecutive —
  // one merge walk resolves the whole z-column of taps.
  std::memset(subm_idx, 0, sizeof(int32_t) * kz * ky * kx * N);
  std::memset(subm_found, 0, sizeof(uint8_t) * kz * ky * kx * N);
  {
    const int64_t k_stride = (int64_t)ky * kx;
    int64_t base = 0;
    for (int32_t dy = -(ky / 2); dy < ky - ky / 2; ++dy)
      for (int32_t dx = -(kx / 2); dx < kx - kx / 2; ++dx, ++base)
        merge_tapz(s, grid, dy, dx, kz, base, k_stride, N, subm_idx,
                   subm_found);
  }

  // strided output sites: mark candidate cells in a bitmap over the
  // output grid, then scan words ascending — O(cands + out_total/64),
  // no sort.
  int32_t out_grid[3];
  for (int d = 0; d < 3; ++d)
    out_grid[d] = (grid[d] + 2 * pad[d] - ksize[d]) / stride[d] + 1;
  const int64_t out_total =
      (int64_t)out_grid[0] * out_grid[1] * out_grid[2];
  Bitmap bm(out_total);
  for (int64_t q = 0; q < M; ++q) {
    const int32_t c3[3] = {s.cz[q], s.cy[q], s.cx[q]};
    int32_t lo[3], hi[3];
    for (int d = 0; d < 3; ++d) {
      const int32_t ip = c3[d] + pad[d];
      int32_t l = ip - ksize[d] + 1;
      lo[d] = l >= 0 ? (l + stride[d] - 1) / stride[d] : -((-l) / stride[d]);
      hi[d] = ip / stride[d];
      if (lo[d] < 0) lo[d] = 0;
      if (hi[d] >= out_grid[d]) hi[d] = out_grid[d] - 1;
    }
    for (int32_t oz = lo[0]; oz <= hi[0]; ++oz)
      for (int32_t oy = lo[1]; oy <= hi[1]; ++oy)
        for (int32_t ox = lo[2]; ox <= hi[2]; ++ox)
          bm.set(((int64_t)oy * out_grid[2] + ox) * out_grid[0] + oz);
  }
  int64_t num_out = 0;
  const int64_t n_words = (int64_t)bm.words.size();
  for (int64_t w = 0; w < n_words && num_out < max_out; ++w) {
    uint64_t bits = bm.words[w];
    while (bits && num_out < max_out) {
      const int b = __builtin_ctzll(bits);
      bits &= bits - 1;
      const int64_t key = (w << 6) | b;
      out_coords[num_out * 3 + 0] = (int32_t)(key % out_grid[0]);
      out_coords[num_out * 3 + 1] =
          (int32_t)(key / ((int64_t)out_grid[2] * out_grid[0]));
      out_coords[num_out * 3 + 2] =
          (int32_t)((key / out_grid[0]) % out_grid[2]);
      out_valid[num_out] = 1;
      ++num_out;
    }
  }
  for (int64_t o = num_out; o < max_out; ++o) {
    out_coords[o * 3 + 0] = -1;
    out_coords[o * 3 + 1] = -1;
    out_coords[o * 3 + 2] = -1;
    out_valid[o] = 0;
  }

  // strided rulebook: out-site query keys ascend with out_coords
  // (sorted-unique); for any kz the z-taps of a fixed (ty, tx) give
  // consecutive query keys — one walk per (ty, tx).
  std::memset(down_idx, 0, sizeof(int32_t) * kz * ky * kx * max_out);
  std::memset(down_found, 0, sizeof(uint8_t) * kz * ky * kx * max_out);
  const int64_t t_stride = (int64_t)ky * kx;
  int64_t t_base = 0;
  for (int32_t ty = 0; ty < ky; ++ty)
    for (int32_t tx = 0; tx < kx; ++tx, ++t_base) {
      int64_t j = 0;
      for (int64_t o = 0; o < num_out; ++o) {
        const int32_t iy = out_coords[o * 3 + 1] * stride[1] + ty - pad[1];
        const int32_t ix = out_coords[o * 3 + 2] * stride[2] + tx - pad[2];
        if (iy < 0 || iy >= grid[1] || ix < 0 || ix >= grid[2]) continue;
        const int32_t iz0 = out_coords[o * 3 + 0] * stride[0] - pad[0];
        const int64_t qbase =
            ((int64_t)iy * grid[2] + ix) * grid[0] + iz0;
        while (j < M && s.keys[j] < qbase) ++j;
        for (int64_t jj = j; jj < M && jj < j + kz &&
                             s.keys[jj] <= qbase + kz - 1; ++jj) {
          const int64_t d = s.keys[jj] - qbase;   // tz = 0..kz-1
          if (d < 0 || d >= kz) continue;
          const int32_t zq = iz0 + (int32_t)d;
          if (zq < 0 || zq >= grid[0]) continue;
          down_idx[(t_base + d * t_stride) * max_out + o] = s.idx[jj];
          down_found[(t_base + d * t_stride) * max_out + o] = 1;
        }
      }
    }
  return (int)num_out;
}

}  // extern "C"
