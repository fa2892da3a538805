// hydrium-tpu native serialization plane.
//
// Implements the host-side hot path of the encoder: the LSB-first bit
// writer, hybrid-uint + LZ77 tokenization, depth-limited prefix coding,
// and the backwards rANS emission with alias tables.  Behaviorally
// equivalent to hydrium_tpu/jxl/{bitwriter,entropy}.py (which are the
// differential-tested Python oracles); serial per stream, parallel
// across groups (threaded at the call layer).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
// Reference behavior citations live in the Python twins; this file cites
// only where it matters for bit-exactness.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <atomic>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// BitWriter
// ---------------------------------------------------------------------------

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t cache = 0;
  int cache_bits = 0;

  void write(uint64_t value, int bits) {
    if (bits <= 0) return;
    cache |= (value & ((bits >= 64) ? ~0ull : ((1ull << bits) - 1)))
             << cache_bits;
    cache_bits += bits;
    while (cache_bits >= 8) {
      buf.push_back(cache & 0xFF);
      cache >>= 8;
      cache_bits -= 8;
    }
  }
  void write_bool(bool b) { write(b ? 1 : 0, 1); }
  void zero_pad() {
    if (cache_bits & 7) write(0, 8 - (cache_bits & 7));
  }
  void append_writer(const BitWriter& other) {
    // this must not assume alignment; other's bytes then tail bits
    for (uint8_t b : other.buf) write(b, 8);
    write(other.cache, other.cache_bits);
  }
  size_t bit_size() const { return buf.size() * 8 + cache_bits; }
};

struct U32Table {
  uint32_t cpos[4];
  uint32_t upos[4];
};

void write_u32(BitWriter& bw, const U32Table& t, uint32_t value) {
  for (int i = 0; i < 4; i++) {
    uint64_t maxv = (1ull << t.upos[i]) - 1;
    uint64_t vmc = (uint64_t)value - t.cpos[i];
    if (value >= t.cpos[i] && vmc <= maxv) {
      bw.write((vmc << 2) | i, t.upos[i] + 2);
      return;
    }
  }
  throw std::runtime_error("u32 not encodable");
}

const U32Table kMinSymbolTable = {{224, 512, 4096, 8}, {0, 0, 0, 15}};
const U32Table kMinLengthTable = {{3, 4, 5, 9}, {0, 0, 2, 8}};

int fllog2(uint64_t n) { return 63 - __builtin_clzll(n); }
int cllog2(uint64_t n) { return fllog2(n) + ((n & (n - 1)) ? 1 : 0); }

uint32_t bitswap32(uint32_t b) {
  b = ((b & 0x55555555u) << 1) | ((b >> 1) & 0x55555555u);
  b = ((b & 0x33333333u) << 2) | ((b >> 2) & 0x33333333u);
  b = ((b & 0x0F0F0F0Fu) << 4) | ((b >> 4) & 0x0F0F0F0Fu);
  b = ((b & 0x00FF00FFu) << 8) | ((b >> 8) & 0x00FF00FFu);
  return (b << 16) | (b >> 16);
}

// ---------------------------------------------------------------------------
// Hybrid-uint tokenization + LZ77
// ---------------------------------------------------------------------------

struct HybridConfig {
  uint8_t split_exponent = 0, msb_in_token = 0, lsb_in_token = 0;
};

struct Sym {
  uint32_t token;
  uint32_t residue;
  uint8_t residue_bits;
  uint8_t cluster;
};

void hybridize(uint32_t symbol, const HybridConfig& cfg, Sym* out) {
  uint32_t split = 1u << cfg.split_exponent;
  if (symbol < split) {
    out->token = symbol;
    out->residue = 0;
    out->residue_bits = 0;
    return;
  }
  uint32_t n = fllog2(symbol) - cfg.lsb_in_token - cfg.msb_in_token;
  uint32_t low = symbol & ((1u << cfg.lsb_in_token) - 1);
  symbol >>= cfg.lsb_in_token;
  out->residue = symbol & ((1u << n) - 1);
  symbol >>= n;
  uint32_t high = symbol & ((1u << cfg.msb_in_token) - 1);
  out->residue_bits = n;
  out->token = split + (low | (high << cfg.lsb_in_token) |
                        ((n - cfg.split_exponent + cfg.lsb_in_token +
                          cfg.msb_in_token)
                         << (cfg.msb_in_token + cfg.lsb_in_token)));
}

const HybridConfig kLz77LenConfig = {7, 0, 0};

// A tokenized stream plus per-cluster stats.
struct Stream {
  std::vector<uint8_t> cluster_map;  // num_dists entries
  size_t num_dists = 0;
  size_t num_clusters = 0;
  uint32_t lz77_min_symbol = 0;
  uint32_t lz77_min_length = 3;
  bool modular = false;
  std::vector<HybridConfig> configs;
  std::vector<Sym> syms;
  std::vector<uint32_t> alphabet_sizes;  // per cluster
  uint32_t max_alphabet_size = 0;

  // lz77 scan state
  uint32_t last_symbol = 0, last_dist = 0, rle_count = 0;

  void init(const uint8_t* cmap, size_t nd, uint32_t lz77_min, bool mod) {
    num_dists = nd + (lz77_min ? 1 : 0);
    lz77_min_symbol = lz77_min;
    modular = mod;
    cluster_map.assign(cmap, cmap + nd);
    num_clusters = 0;
    for (uint8_t c : cluster_map)
      num_clusters = std::max<size_t>(num_clusters, c + 1);
    if (lz77_min) cluster_map.push_back((uint8_t)num_clusters++);
    configs.assign(num_clusters, HybridConfig{4, 1, 1});
    if (lz77_min) configs[num_clusters - 1] = {7, 0, 0};
    alphabet_sizes.assign(num_clusters, 0);
  }
  void set_config(HybridConfig cfg) {
    for (auto& c : configs) c = cfg;
  }

  void push(const Sym& s) {
    syms.push_back(s);
    uint32_t a = s.token + 1;
    max_alphabet_size = std::max(max_alphabet_size, a);
    alphabet_sizes[s.cluster] = std::max(alphabet_sizes[s.cluster], a);
  }
  void send0(uint32_t dist, uint32_t symbol) {
    Sym s;
    s.cluster = cluster_map[dist];
    hybridize(symbol, configs[s.cluster], &s);
    push(s);
  }
  void flush_lz77() {
    uint32_t last = last_symbol - 1;
    if (rle_count > lz77_min_length) {
      uint32_t repeat = rle_count - lz77_min_length;
      Sym s;
      hybridize(repeat, kLz77LenConfig, &s);
      s.cluster = cluster_map[last_dist];
      s.token += lz77_min_symbol;
      push(s);
      send0(num_dists - 1, modular ? 1 : 0);
    } else if (last_symbol && rle_count) {
      for (uint32_t k = 0; k < rle_count; k++) send0(last_dist, last);
    }
    rle_count = 0;
  }
  void send(uint32_t dist, uint32_t symbol) {
    if (!lz77_min_symbol) {
      send0(dist, symbol);
      return;
    }
    if (last_symbol == symbol + 1 &&
        cluster_map[last_dist] == cluster_map[dist] && rle_count < 127) {
      rle_count++;
      return;
    }
    flush_lz77();
    last_symbol = symbol + 1;
    last_dist = dist;
    send0(dist, symbol);
  }
};

// ---------------------------------------------------------------------------
// Depth-limited Huffman + canonical tables
// ---------------------------------------------------------------------------

struct TreeEntry {
  int32_t token;
  uint32_t freq;
  int32_t depth, max_depth;
  int32_t left, right;
};

int huff_cmp(const TreeEntry& a, const TreeEntry& b) {
  if (a.freq != b.freq) {
    if (!b.freq) return -1;
    if (!a.freq) return 1;
    return (int)a.freq - (int)b.freq;
  }
  if (!b.token) return -1;
  if (!a.token) return 1;
  return a.token - b.token;
}

int collect(std::vector<TreeEntry>& tree, int slot) {
  if (slot < 0) return 0;
  TreeEntry& e = tree[slot];
  e.depth++;
  int l = collect(tree, e.left);
  int r = collect(tree, e.right);
  return e.max_depth = std::max({e.depth, l, r});
}

void build_huffman_lengths(const uint32_t* freqs, uint32_t A, int max_depth,
                           uint32_t* lengths) {
  std::vector<TreeEntry> tree(2 * A - 1, TreeEntry{0, 0, 0, 0, -1, -1});
  uint32_t nz = 0;
  for (uint32_t t = 0; t < A; t++) {
    tree[t].token = 1 + t;
    tree[t].freq = freqs[t];
    if (freqs[t]) nz++;
  }
  if (!nz) throw std::runtime_error("no nonzero frequencies");
  if (max_depth < 0) max_depth = cllog2(A + 1);
  for (uint32_t k = 0; k + 1 < A; k++, nz--) {
    int target = max_depth - cllog2(nz) + 1;
    int smallest = -1, second = -1;
    for (uint32_t j = 2 * k; j < A + k; j++) {
      if (!tree[j].freq || tree[j].max_depth >= target) continue;
      if (smallest < 0 || huff_cmp(tree[j], tree[smallest]) < 0) {
        second = smallest;
        smallest = j;
      } else if (second < 0 || huff_cmp(tree[j], tree[second]) < 0) {
        second = j;
      }
    }
    if (smallest < 0) throw std::runtime_error("huffman target fail");
    std::swap(tree[smallest], tree[2 * k]);
    if (second < 0) break;
    if (second == (int)(2 * k)) second = smallest;
    smallest = 2 * k;
    std::swap(tree[second], tree[2 * k + 1]);
    second = smallest + 1;
    TreeEntry& e = tree[A + k];
    e.freq = tree[smallest].freq + tree[second].freq;
    e.left = smallest;
    e.right = second;
    collect(tree, A + k);
  }
  std::fill(lengths, lengths + A, 0);
  for (auto& e : tree)
    if (e.token) lengths[e.token - 1] = e.depth;
}

struct VLC {
  uint32_t code;
  uint32_t length;
};

void build_prefix_table(const uint32_t* lengths, uint32_t A, VLC* table) {
  std::vector<uint32_t> counts(std::max<uint32_t>(A + 1, 16), 0);
  for (uint32_t j = 0; j < A; j++) counts[lengths[j]]++;
  for (uint32_t j = 1; j <= A; j++) counts[j] += counts[j - 1];
  std::vector<std::pair<uint32_t, uint32_t>> pre(A);  // (length, symbol)
  for (int32_t j = A - 1; j >= 0; j--) {
    uint32_t idx = --counts[lengths[j]];
    pre[idx] = {lengths[j], (uint32_t)j};
  }
  uint64_t code = 0;
  for (uint32_t j = 0; j < A; j++) table[j] = {0, 0};
  for (auto& [len, sym] : pre) {
    if (!len) continue;
    table[sym] = {bitswap32((uint32_t)code), len};
    code += 1ull << (32 - len);
  }
  if (code && code != (1ull << 32))
    throw std::runtime_error("VLC codes do not add up");
}

// code-length-code tables (JXL spec; entropy.py twins)
const uint32_t kPrefixZigZag[18] = {1, 2,  3, 4, 0, 5, 17, 6,  16,
                                    7, 8, 9, 10, 11, 12, 13, 14, 15};
const VLC kLevel0Table[6] = {{0, 2}, {7, 4}, {3, 3}, {2, 2}, {1, 2}, {15, 4}};

void flush_zeroes(BitWriter& bw, const VLC* lvl1, uint32_t num_zeroes) {
  if (num_zeroes >= 3) {
    uint32_t res[8];
    int k = 0;
    while (num_zeroes > 10) {
      uint32_t nn = (num_zeroes + 13) / 8;
      res[k++] = num_zeroes - 8 * nn + 16;
      num_zeroes = nn;
    }
    res[k++] = num_zeroes;
    for (int l = k - 1; l >= 0; l--) {
      bw.write(lvl1[17].code, lvl1[17].length);
      bw.write(res[l] - 3, 3);
    }
  } else {
    for (uint32_t k = 0; k < num_zeroes; k++)
      bw.write(lvl1[0].code, lvl1[0].length);
  }
}

void write_complex_prefix_lengths(BitWriter& bw, uint32_t A,
                                  const uint32_t* lengths) {
  bw.write(0, 2);  // hskip
  uint32_t lvl1_freqs[18] = {0};
  uint32_t num_zeroes = 0;
  for (uint32_t j = 0; j < A; j++) {
    uint32_t code = lengths[j];
    if (!code) {
      num_zeroes++;
      continue;
    }
    if (num_zeroes >= 3) {
      while (num_zeroes > 10) {
        lvl1_freqs[17]++;
        num_zeroes = (num_zeroes + 13) / 8;
      }
      lvl1_freqs[17]++;
    } else {
      lvl1_freqs[0] += num_zeroes;
    }
    num_zeroes = 0;
    lvl1_freqs[code]++;
  }
  uint32_t lvl1_lengths[18];
  build_huffman_lengths(lvl1_freqs, 18, 5, lvl1_lengths);
  uint32_t total = 0;
  for (uint32_t j = 0; j < 18; j++) {
    uint32_t code = lvl1_lengths[kPrefixZigZag[j]];
    bw.write(kLevel0Table[code].code, kLevel0Table[code].length);
    if (code) total += 32 >> code;
    if (total >= 32) break;
  }
  if (total && total != 32) throw std::runtime_error("level1 total mismatch");
  VLC lvl1[18];
  build_prefix_table(lvl1_lengths, 18, lvl1);
  total = 0;
  num_zeroes = 0;
  for (uint32_t j = 0; j < A; j++) {
    uint32_t code = lengths[j];
    if (!code) {
      num_zeroes++;
      continue;
    }
    flush_zeroes(bw, lvl1, num_zeroes);
    num_zeroes = 0;
    bw.write(lvl1[code].code, lvl1[code].length);
    total += 32768 >> code;
    if (total == 32768) break;
  }
  flush_zeroes(bw, lvl1, num_zeroes);
}

// ---------------------------------------------------------------------------
// Stream headers (common + prefix + ANS)
// ---------------------------------------------------------------------------

void write_hybrid_config(BitWriter& bw, const HybridConfig& cfg,
                         int log_alphabet_size) {
  bw.write(cfg.split_exponent, cllog2(1 + log_alphabet_size));
  if (cfg.split_exponent == log_alphabet_size) return;
  bw.write(cfg.msb_in_token, cllog2(1 + cfg.split_exponent));
  bw.write(cfg.lsb_in_token,
           cllog2(1 + cfg.split_exponent - cfg.msb_in_token));
}

void prefix_encode_stream(Stream& st, BitWriter& bw);  // fwd

void write_cluster_map(const std::vector<uint8_t>& cmap, size_t num_dists,
                       size_t num_clusters, BitWriter& bw) {
  if (num_dists == 1) return;
  int nbits = cllog2(num_clusters);
  if (nbits <= 3 && num_dists * nbits <= 32) {
    bw.write_bool(true);
    bw.write(nbits, 2);
    for (size_t i = 0; i < num_dists; i++) bw.write(cmap[i], nbits);
    return;
  }
  bw.write_bool(false);
  bw.write_bool(true);  // mtf
  Stream nested;
  uint8_t zero = 0;
  nested.init(&zero, 1, 64, false);
  nested.set_config({4, 1, 0});
  uint8_t mtf[256];
  for (int i = 0; i < 256; i++) mtf[i] = i;
  for (size_t j = 0; j < num_dists; j++) {
    int index = 0;
    for (int k = 0; k < 256; k++)
      if (mtf[k] == cmap[j]) {
        index = k;
        break;
      }
    nested.send(0, index);
    if (index) {
      uint8_t v = mtf[index];
      memmove(mtf + 1, mtf, index);
      mtf[0] = v;
    }
  }
  prefix_encode_stream(nested, bw);
}

void stream_header_common(Stream& st, BitWriter& bw, int log_alphabet_size) {
  bw.write_bool(st.lz77_min_symbol != 0);
  if (st.lz77_min_symbol) {
    st.flush_lz77();
    write_u32(bw, kMinSymbolTable, st.lz77_min_symbol);
    write_u32(bw, kMinLengthTable, st.lz77_min_length);
    write_hybrid_config(bw, kLz77LenConfig, 8);
  }
  write_cluster_map(st.cluster_map, st.num_dists, st.num_clusters, bw);
  bw.write_bool(log_alphabet_size == 0);  // use_prefix_codes
  if (log_alphabet_size) bw.write(log_alphabet_size - 5, 2);
  for (size_t c = 0; c < st.num_clusters; c++)
    write_hybrid_config(bw, st.configs[c],
                        log_alphabet_size ? log_alphabet_size : 15);
}

void count_frequencies(const Stream& st,
                       std::vector<std::vector<uint32_t>>& freqs) {
  freqs.assign(st.num_clusters, {});
  for (size_t c = 0; c < st.num_clusters; c++)
    freqs[c].assign(st.alphabet_sizes[c], 0);
  for (const Sym& s : st.syms) freqs[s.cluster][s.token]++;
}

void prefix_write_header(Stream& st, BitWriter& bw,
                         std::vector<std::vector<VLC>>& tables) {
  stream_header_common(st, bw, 0);
  std::vector<std::vector<uint32_t>> freqs;
  count_frequencies(st, freqs);

  for (size_t c = 0; c < st.num_clusters; c++) {
    uint32_t A = st.alphabet_sizes[c];
    if (A <= 1) {
      bw.write_bool(false);
      continue;
    }
    bw.write_bool(true);
    int n = fllog2(A - 1);
    bw.write(n, 4);
    bw.write(A - 1, n);
  }

  tables.assign(st.num_clusters, {});
  for (size_t c = 0; c < st.num_clusters; c++) {
    uint32_t A = st.alphabet_sizes[c];
    tables[c].assign(std::max<uint32_t>(A, 1), VLC{0, 0});
    if (A <= 1) continue;
    std::vector<uint32_t> lengths(A);
    build_huffman_lengths(freqs[c].data(), A, 15, lengths.data());
    // collect present symbols
    struct Tok {
      uint32_t symbol, length;
    };
    Tok toks[5];
    uint32_t nsym = 0;
    for (uint32_t j = 0; j < A && nsym <= 4; j++) {
      if (!lengths[j]) continue;
      if (nsym < 4) toks[nsym] = {j, lengths[j]};
      nsym++;
    }
    if (nsym > 4) {
      write_complex_prefix_lengths(bw, A, lengths.data());
      build_prefix_table(lengths.data(), A, tables[c].data());
      continue;
    }
    if (nsym == 0) {
      nsym = 1;
      toks[0] = {A - 1, 0};
    }
    bw.write(1, 2);  // hskip=1 simple
    bw.write(nsym - 1, 2);
    int las = cllog2(A);
    if (nsym == 3 && toks[0].length != 1) {
      if (toks[1].length == 1)
        std::swap(toks[0], toks[1]);
      else
        std::swap(toks[0], toks[2]);
    }
    bool tree_select = false;
    if (nsym == 4) {
      for (int i = 0; i < 4; i++)
        if (toks[i].length != 2) {
          tree_select = true;
          break;
        }
      if (tree_select && toks[0].length != 1) {
        if (toks[1].length == 1)
          std::swap(toks[0], toks[1]);
        else if (toks[2].length == 1)
          std::swap(toks[0], toks[2]);
        else
          std::swap(toks[0], toks[3]);
      }
      if (tree_select && toks[1].length != 2) {
        if (toks[2].length == 2)
          std::swap(toks[1], toks[2]);
        else
          std::swap(toks[1], toks[3]);
      }
    }
    for (uint32_t i = 0; i < nsym; i++) bw.write(toks[i].symbol, las);
    if (nsym == 4) bw.write_bool(tree_select);
    build_prefix_table(lengths.data(), A, tables[c].data());
  }
}

void prefix_encode_stream(Stream& st, BitWriter& bw) {
  std::vector<std::vector<VLC>> tables;
  prefix_write_header(st, bw, tables);
  for (const Sym& s : st.syms) {
    const VLC& e = tables[s.cluster][s.token];
    bw.write(e.code, e.length);
    bw.write(s.residue, s.residue_bits);
  }
}

// ---------------------------------------------------------------------------
// ANS
// ---------------------------------------------------------------------------

const VLC kAnsDistPrefix[14] = {{17, 5}, {11, 4}, {15, 4}, {3, 4}, {9, 4},
                                {7, 4},  {4, 3},  {2, 3},  {5, 3}, {6, 3},
                                {0, 3},  {33, 6}, {1, 7},  {65, 7}};

void write_ans_u8(BitWriter& bw, uint8_t b) {
  bw.write_bool(b != 0);
  if (!b) return;
  int l = fllog2(b);
  bw.write(l, 3);
  bw.write(b, l);
}

// returns true for the "all mass on last symbol" degenerate case
bool normalize_ans(std::vector<uint32_t>& f, uint32_t A) {
  uint64_t total = 0;
  for (uint32_t k = 0; k < A; k++) total += f[k];
  if (!total) throw std::runtime_error("all-zero ANS frequencies");
  uint64_t new_total = 0;
  for (uint32_t k = 0; k < A; k++) {
    if (!f[k]) continue;
    f[k] = (((uint64_t)f[k] << 12) / total) & 0xFFFFu;
    if (!f[k]) f[k] = 1;
    new_total += f[k];
  }
  int64_t j = A - 1;
  while (new_total > 4096) {
    uint64_t diff = new_total - 4096;
    if (diff < f[j]) {
      f[j] -= diff;
      new_total -= diff;
      break;
    } else if (f[j] > 1) {
      new_total -= f[j] - 1;
      f[j] = 1;
    }
    j--;
  }
  f[0] += 4096 - new_total;
  return f[A - 1] == 4096;
}

void write_ans_frequencies(BitWriter& bw, const std::vector<uint32_t>& f,
                           uint32_t A) {
  if (!A) {
    bw.write(1, 2);
    write_ans_u8(bw, 0);
    return;
  }
  int32_t nz1 = -1, nz2 = -1, nzc = 0;
  for (uint32_t k = 0; k < A; k++) {
    if (f[k] == 4096) {
      bw.write(1, 2);
      write_ans_u8(bw, k);
      return;
    }
    if (!f[k]) continue;
    if (++nzc > 2) break;
    if (nz1 < 0)
      nz1 = k;
    else if (f[nz1] + f[k] == 4096) {
      nz2 = k;
      break;
    }
  }
  if (nz1 >= 0 && nz2 >= 0) {
    bw.write(3, 2);
    write_ans_u8(bw, nz1);
    write_ans_u8(bw, nz2);
    bw.write(f[nz1], 12);
    return;
  }
  bw.write(0, 2);
  bw.write(7, 3);
  bw.write(6, 3);
  write_ans_u8(bw, A - 3);
  std::vector<int> log_counts(A);
  uint32_t omit_pos = 0;
  int omit_log = 0;
  for (uint32_t k = 0; k < A; k++) {
    log_counts[k] = f[k] ? 1 + fllog2(f[k]) : 0;
    bw.write(kAnsDistPrefix[log_counts[k]].code,
             kAnsDistPrefix[log_counts[k]].length);
    if (log_counts[k] > omit_log) {
      omit_log = log_counts[k];
      omit_pos = k;
    }
  }
  for (uint32_t k = 0; k < A; k++) {
    if (k == omit_pos || log_counts[k] <= 1) continue;
    bw.write(f[k], log_counts[k] - 1);
  }
}

struct AliasSlot {
  int32_t cutoff, offset, original;
};

struct AliasTable {
  // per symbol: 1 + count slots
  std::vector<std::vector<AliasSlot>> entries;
};

void build_alias(const std::vector<uint32_t>& f, uint32_t A,
                 int log_alphabet_size, int uniq_pos, AliasTable& out) {
  int log_bucket = 12 - log_alphabet_size;
  uint32_t bucket_size = 1u << log_bucket;
  uint32_t table_size = 1u << log_alphabet_size;
  std::vector<uint32_t> symbols(table_size, 0), cutoffs(table_size, 0),
      offsets(table_size, 0);
  out.entries.assign(A, {});
  if (uniq_pos >= 0) {
    for (uint32_t i = 0; i < table_size; i++) {
      symbols[i] = uniq_pos;
      offsets[i] = i * bucket_size;
    }
  } else {
    std::vector<uint8_t> underfull, overfull;
    underfull.reserve(table_size);
    overfull.reserve(table_size);
    for (uint32_t pos = 0; pos < A; pos++) {
      cutoffs[pos] = f[pos];
      if (cutoffs[pos] < bucket_size)
        underfull.push_back(pos);
      else if (cutoffs[pos] > bucket_size)
        overfull.push_back(pos);
    }
    for (uint32_t i = A; i < table_size; i++) underfull.push_back(i);
    while (!overfull.empty()) {
      if (underfull.empty()) throw std::runtime_error("alias underfull empty");
      uint8_t u = underfull.back();
      underfull.pop_back();
      uint8_t o = overfull.back();
      overfull.pop_back();
      int32_t by = bucket_size - cutoffs[u];
      cutoffs[o] -= by;
      offsets[u] = cutoffs[o];
      symbols[u] = o;
      if (cutoffs[o] < bucket_size)
        underfull.push_back(o);
      else if (cutoffs[o] > bucket_size)
        overfull.push_back(o);
    }
    for (uint32_t sym = 0; sym < table_size; sym++) {
      if (cutoffs[sym] == bucket_size) {
        symbols[sym] = sym;
        cutoffs[sym] = 0;
        offsets[sym] = 0;
      } else {
        offsets[sym] -= cutoffs[sym];
      }
    }
  }
  for (uint32_t sym = 0; sym < A; sym++)
    out.entries[sym].push_back({(int32_t)cutoffs[sym], 0, (int32_t)sym});
  for (uint32_t i = 0; i < table_size; i++)
    out.entries[symbols[i]].push_back(
        {(int32_t)cutoffs[i], (int32_t)offsets[i], (int32_t)i});
}

// Backwards rANS encode of syms[start, start+count) with interleaved
// 16-bit flushes and residue bits on the forward pass.
void ans_encode_slice(const Sym* syms, size_t count,
                      const std::vector<std::vector<uint32_t>>& freqs,
                      const std::vector<AliasTable>& aliases,
                      int log_alphabet_size, BitWriter& bw) {
  const int log_bucket = 12 - log_alphabet_size;
  const uint32_t pos_mask = (1u << log_bucket) - 1;
  uint32_t state = 0x130000u;
  std::vector<std::pair<uint32_t, uint16_t>> flushes;  // (diff, value)
  size_t last_push = count;
  uint16_t last_value = 0;
  for (size_t p2 = 0; p2 < count; p2++) {
    size_t p = count - 1 - p2;
    uint32_t token = syms[p].token;
    uint32_t cluster = syms[p].cluster;
    uint32_t freq = freqs[cluster][token];
    if ((state >> 20) >= freq) {
      if (last_push != count)
        flushes.push_back({(uint32_t)(last_push - p), last_value});
      last_push = p;
      last_value = state & 0xFFFF;
      state >>= 16;
    }
    uint32_t div = state / freq;
    uint32_t offset = state - div * freq;
    const auto& slots = aliases[cluster].entries[token];
    uint32_t i = 0, pos = 0;
    bool found = false;
    for (size_t j = 0; j < slots.size(); j++) {
      pos = offset - slots[j].offset;
      int32_t k = (int32_t)pos - slots[j].cutoff;
      if (!(pos & ~pos_mask) && (j > 0 ? k >= 0 : k < 0)) {
        i = slots[j].original;
        found = true;
        break;
      }
    }
    if (!found) throw std::runtime_error("alias lookup failed");
    state = (div << 12) | (i << log_bucket) | pos;
  }
  if (last_push != count)
    flushes.push_back({(uint32_t)last_push, last_value});
  flushes.push_back({0, (uint16_t)((state >> 16) & 0xFFFF)});
  flushes.push_back({0, (uint16_t)(state & 0xFFFF)});

  size_t last_pop = 0;
  for (size_t p = 0; p < count; p++) {
    while (!flushes.empty()) {
      auto [diff, value] = flushes.back();
      if (p - last_pop >= diff) {
        flushes.pop_back();
        bw.write(value, 16);
        last_pop = p;
      } else {
        break;
      }
    }
    bw.write(syms[p].residue, syms[p].residue_bits);
  }
}

}  // namespace

// ===========================================================================
// C ABI
// ===========================================================================

struct HydWriter {
  BitWriter bw;
};
struct HydStream {
  Stream st;
};

extern "C" {

HydWriter* hyd_writer_new() { return new HydWriter(); }
void hyd_writer_free(HydWriter* w) { delete w; }
// bits written so far
long hyd_writer_bit_size(HydWriter* w) { return (long)w->bw.bit_size(); }
void hyd_writer_write(HydWriter* w, uint64_t value, int bits) {
  w->bw.write(value, bits);
}
void hyd_writer_zero_pad(HydWriter* w) { w->bw.zero_pad(); }
// copy out: returns number of whole bytes; tail bits (<8) returned via
// *tail_val/*tail_bits without padding.
long hyd_writer_copy(HydWriter* w, uint8_t* out, long cap, uint32_t* tail_val,
                     int* tail_bits) {
  if ((long)w->bw.buf.size() > cap) return -1;
  memcpy(out, w->bw.buf.data(), w->bw.buf.size());
  *tail_val = (uint32_t)w->bw.cache;
  *tail_bits = w->bw.cache_bits;
  return (long)w->bw.buf.size();
}
void hyd_writer_append(HydWriter* dst, HydWriter* src) {
  dst->bw.append_writer(src->bw);
}
void hyd_writer_append_bytes(HydWriter* dst, const uint8_t* data, long n) {
  if (dst->bw.cache_bits == 0) {
    dst->bw.buf.insert(dst->bw.buf.end(), data, data + n);
  } else {
    for (long i = 0; i < n; i++) dst->bw.write(data[i], 8);
  }
}

HydStream* hyd_stream_new(const uint8_t* cluster_map, long num_dists,
                          uint32_t lz77_min_symbol, int modular,
                          int custom_config, int split, int msb, int lsb) {
  auto* s = new HydStream();
  s->st.init(cluster_map, num_dists, lz77_min_symbol, modular != 0);
  if (custom_config)
    s->st.set_config({(uint8_t)split, (uint8_t)msb, (uint8_t)lsb});
  return s;
}
void hyd_stream_free(HydStream* s) { delete s; }

void hyd_stream_send(HydStream* s, const uint32_t* dists,
                     const uint32_t* symbols, long n) {
  for (long i = 0; i < n; i++) s->st.send(dists[i], symbols[i]);
}
// all symbols share one dist
void hyd_stream_send_mono(HydStream* s, uint32_t dist, const uint32_t* symbols,
                          long n) {
  for (long i = 0; i < n; i++) s->st.send(dist, symbols[i]);
}

int hyd_stream_prefix_finalize(HydStream* s, HydWriter* w) {
  try {
    prefix_encode_stream(s->st, w->bw);
    return 0;
  } catch (const std::exception&) {
    return -1;
  }
}

// -- HF ANS batch path ------------------------------------------------------
//
// Pre-tokenized padded arrays from the device pipeline:
//   tokens u16 / clusters u8 / residues u32 / rbits u8 : [n, 3, 64]
//   valid_len i32: [n, 3]
// appended in emission order into an internal symbol array.

struct HydHF {
  std::vector<Sym> syms;
  std::vector<uint32_t> alphabet_sizes;
  uint32_t max_alphabet_size = 0;
  size_t num_clusters;
  std::vector<size_t> barriers;  // per group symbol counts
  std::vector<uint32_t> presets;
  std::vector<std::vector<uint32_t>> freqs;
  std::vector<AliasTable> aliases;
  int las = 0;
  int las_forced = 0;  // streaming mode fixes las so per-preset flushes
                       // stay consistent with the shared header
};

HydHF* hyd_hf_new(long num_clusters) {
  auto* h = new HydHF();
  h->num_clusters = num_clusters;
  h->alphabet_sizes.assign(num_clusters, 0);
  return h;
}
void hyd_hf_free(HydHF* h) { delete h; }

// HF coefficient context tables (JXL spec constants; encoder.c:53-66 and
// hydrium_tpu/ops/tables.py are the documented twins).
static const int32_t kCoeffFreqCtx[64] = {
    0,  0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14,
    15, 15, 16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 21, 21, 22, 22,
    23, 23, 23, 23, 24, 24, 24, 24, 25, 25, 25, 25, 26, 26, 26, 26,
    27, 27, 27, 27, 28, 28, 28, 28, 29, 29, 29, 29, 30, 30, 30, 30};
static const int32_t kCoeffNumNzCtx[64] = {
    0,   0,   31,  62,  62,  93,  93,  93,  93,  123, 123, 123, 123,
    152, 152, 152, 152, 152, 152, 152, 152, 180, 180, 180, 180, 180,
    180, 180, 180, 180, 180, 180, 180, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206,
    206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206, 206};

struct BitReader {
  const uint32_t* words;
  size_t bitpos = 0;
  // 12-bit lookahead for LUT prefix decode (transport codes are <= 12
  // bits, jxl/tokcode.py MAX_LEN); callers guarantee one slack word
  // past the last payload word (the host fetches +1).
  uint32_t peek12() const {
    size_t w = bitpos >> 5;
    int s = bitpos & 31;
    uint64_t v = ((uint64_t)words[w] | ((uint64_t)words[w + 1] << 32)) >> s;
    return (uint32_t)v & 0xFFF;
  }
  uint32_t read(int nbits) {
    if (!nbits) return 0;
    size_t w = bitpos >> 5;
    int s = bitpos & 31;
    uint64_t v = (uint64_t)words[w] >> s;
    if (s + nbits > 32) v |= (uint64_t)words[w + 1] << (32 - s);
    bitpos += nbits;
    return (uint32_t)(v & ((nbits >= 32) ? ~0u : ((1u << nbits) - 1)));
  }
};

// Walk one group's packed streams (payload format v3) into a
// caller-provided Sym range.  Tokens are transport-Huffman-coded
// (<=12-bit codes, LSB-first; LUT entry = symbol | length << 8) and
// there is no valid-length sidecar: the number of coefficient symbols
// per block-channel is reconstructed from the decoded nonzero count,
// exactly as a JXL decoder does (encoder.c:689-750 emits coefficients
// until the nonzeros are exhausted).  gbh/gbw give the group's true
// varblock extent; blocks beyond it emitted nothing on the device.
//
// Format v3 chunking (ops/pipeline.py module comment): the token
// stream realigns to a 32-bit word boundary every 64 block-channels
// (4096 slots), the residue stream every 32 block-channels, counting
// ALL block positions of the 32x32 buffer group (including those
// beyond gbh/gbw, which emitted 0 bits).  Chunks never straddle a
// group, so per-group offsets stay word-aligned.
// Returns symbols written, or SIZE_MAX on a corrupt/overflowing stream.
static size_t walk_group_packed(const uint32_t* token_words, long tok_bit_off,
                         const uint32_t* residue_words, long res_bit_off,
                         const uint16_t* lut, int tok_classes,
                         const uint8_t* cmap,
                         int gbh, int gbw, Sym* out, size_t out_cap,
                         uint32_t* alphabet_sizes, uint32_t* max_alphabet) {
  BitReader tr{token_words, (size_t)tok_bit_off};
  BitReader rr{residue_words, (size_t)res_bit_off};
  Sym* dst = out;
  Sym* end = out + out_cap;
  uint8_t counts[32][32][3];
  long tch = 0, rch = 0;  // current token/residue chunk index
  for (int by = 0; by < gbh; by++) {
    for (int bx = 0; bx < 32; bx++) {
      if (bx >= gbw) continue;  // beyond the group's true extent
      for (int c = 0; c < 3; c++) {
        if (dst == end) return SIZE_MAX;
        // format v3: realign to a word boundary on chunk entry (skipped
        // block-channels emitted 0 bits, so a single align collapses
        // any number of crossed empty chunks)
        long bc = ((long)by * 32 + bx) * 3 + c;
        if ((bc >> 6) != tch) {
          tr.bitpos = (tr.bitpos + 31) & ~(size_t)31;
          tch = bc >> 6;
        }
        if ((bc >> 5) != rch) {
          rr.bitpos = (rr.bitpos + 31) & ~(size_t)31;
          rch = bc >> 5;
        }
        // the context (hence cluster, hence transport code class) is
        // known BEFORE each token is decoded -- same property the ANS
        // decoder relies on
        uint32_t predicted;
        if (!bx && !by)
          predicted = 32;
        else if (!bx)
          predicted = counts[by - 1][0][c];
        else if (!by)
          predicted = counts[0][bx - 1][c];
        else
          predicted = (counts[by - 1][bx][c] + (uint32_t)counts[by][bx - 1][c]
                       + 1) >> 1;
        uint32_t nzctx = predicted < 8
                             ? predicted
                             : 4 + (std::min<uint32_t>(predicted, 64) >> 1);
        uint8_t cluster = cmap[3 * nzctx + c];
        uint16_t e = lut[(cluster % tok_classes) * 4096 + tr.peek12()];
        uint32_t tok = e & 0xFF;
        tr.bitpos += e >> 8;
        int rb = tok < 16 ? 0 : (int)((tok - 16) >> 1) + 3;
        uint32_t res = rr.read(rb);
        uint32_t count =
            tok < 16 ? tok : ((2u | ((tok - 16) & 1)) << rb) | res;
        counts[by][bx][c] = (uint8_t)count;
        Sym s;
        s.token = tok;
        s.residue = res;
        s.residue_bits = rb;
        s.cluster = cluster;
        *dst++ = s;
        uint32_t a = tok + 1;
        *max_alphabet = std::max(*max_alphabet, a);
        alphabet_sizes[s.cluster] = std::max(alphabet_sizes[s.cluster], a);

        uint32_t remaining = count;
        int prev = count <= 4;
        int hist = 458 * c + 111;
        for (int k = 1; k < 64 && remaining; k++) {
          if (dst == end) return SIZE_MAX;
          int ctx = hist + prev +
                    ((kCoeffNumNzCtx[remaining > 63 ? 63 : remaining]
                      + kCoeffFreqCtx[k]) << 1);
          uint8_t cl2 = cmap[ctx];
          e = lut[(cl2 % tok_classes) * 4096 + tr.peek12()];
          tok = e & 0xFF;
          tr.bitpos += e >> 8;
          rb = tok < 16 ? 0 : (int)((tok - 16) >> 1) + 3;
          res = rr.read(rb);
          Sym s2;
          s2.token = tok;
          s2.residue = res;
          s2.residue_bits = rb;
          s2.cluster = cl2;
          *dst++ = s2;
          a = tok + 1;
          *max_alphabet = std::max(*max_alphabet, a);
          alphabet_sizes[s2.cluster] = std::max(alphabet_sizes[s2.cluster], a);
          if (tok) {
            prev = 1;
            remaining--;
          } else {
            prev = 0;
          }
        }
        if (remaining) return SIZE_MAX;  // corrupt: nonzeros not exhausted
      }
    }
  }
  return dst - out;
}

// Walk a whole LF group's worth of groups in parallel: per-group bit
// offsets and symbol counts come from the device (aux payload), so each
// thread writes a disjoint range of the shared symbol array.  The
// buffer grid is gcy x gcx groups; vh/vw give the true varblock extent
// of the LF group, from which each buffer group's gbh/gbw (and whether
// it exists at all) follow.  Phantom groups (entirely beyond the
// extent) produce no HF section.  Returns 0, or -1 when any group's
// walked symbol count disagrees with the device's count (the caller
// must then discard this HydHF).
// Decode the format-v4 LF residual stream: lf_n bit-contiguous fields,
// each a transport-Huffman hybrid-uint token (class-9 LUT, 4096
// entries) followed by its raw residue bits.  out[i] receives the
// reconstructed pack_signed residual.  Returns the final bit position
// (the caller checks it equals aux[3]), or -1 if the cursor ever runs
// past max_bits (corrupt stream; checksums make this near-impossible,
// but the reader must not run off the fetched buffer).
long hyd_lf_decode(const uint32_t* words, const uint16_t* lut, long lf_n,
                   long max_bits, uint32_t* out) {
  BitReader br{words, 0};
  for (long i = 0; i < lf_n; i++) {
    // strict: every remaining field needs >= 1 code bit, so a valid
    // stream never enters an iteration at/past max_bits.  Keeps peek12
    // within the buffer's one guaranteed slack word (BitReader contract
    // above): bitpos <= max_bits-1 touches word index at most
    // ceil(max_bits/32), the slack word.
    if (br.bitpos >= (size_t)max_bits) return -1;
    uint16_t e = lut[br.peek12()];
    uint32_t tok = e & 0xFF;
    br.bitpos += e >> 8;
    int rb = tok < 16 ? 0 : (int)((tok - 16) >> 1) + 3;
    // mid-field guard: a corrupt stream can push the cursor past
    // max_bits via the code length or residue width; checking only
    // between fields let read() dereference past the fetched buffer
    // (the whole field must fit for read's word+1 access to stay
    // within the slack word)
    if (br.bitpos + (size_t)rb > (size_t)max_bits) return -1;
    uint32_t res = br.read(rb);
    out[i] = tok < 16 ? tok : ((2u | ((tok - 16) & 1)) << rb) | res;
  }
  return (long)br.bitpos;
}

int hyd_hf_add_lfg_packed(HydHF* h, const uint32_t* token_words,
                          const uint32_t* residue_words,
                          const uint16_t* tok_lut,  // [tok_classes, 4096]
                          int tok_classes,
                          const uint8_t* cluster_map, uint32_t preset,
                          long gcy, long gcx, long vh, long vw,
                          const int64_t* tok_bit_offs,
                          const int64_t* res_bit_offs,
                          const int64_t* sym_counts, int n_threads) {
  const uint8_t* cmap = cluster_map + (size_t)1485 * preset;
  long n_groups = gcy * gcx;
  std::vector<size_t> offsets(n_groups + 1, 0);
  for (long g = 0; g < n_groups; g++)
    offsets[g + 1] = offsets[g] + (size_t)sym_counts[g];
  size_t base = h->syms.size();
  h->syms.resize(base + offsets[n_groups]);
  if (n_threads < 1) n_threads = 1;
  std::vector<std::vector<uint32_t>> alpha(
      n_threads, std::vector<uint32_t>(h->num_clusters, 0));
  std::vector<uint32_t> maxa(n_threads, 0);
  std::vector<int> errs(n_threads, 0);
  auto extent = [&](long g, int* gbh, int* gbw) {
    long gy = g / gcx, gx = g % gcx;
    long bh = vh - gy * 32, bw = vw - gx * 32;
    *gbh = (int)std::max(0l, std::min(32l, bh));
    *gbw = (int)std::max(0l, std::min(32l, bw));
  };
  auto worker = [&](int t) {
    for (long g = t; g < n_groups; g += n_threads) {
      int gbh, gbw;
      extent(g, &gbh, &gbw);
      if (!gbh || !gbw) {
        if (sym_counts[g]) errs[t] = 1;
        continue;
      }
      size_t wrote = walk_group_packed(
          token_words, tok_bit_offs[g], residue_words, res_bit_offs[g],
          tok_lut, tok_classes, cmap, gbh, gbw,
          h->syms.data() + base + offsets[g],
          (size_t)sym_counts[g], alpha[t].data(), &maxa[t]);
      if (wrote != (size_t)sym_counts[g]) errs[t] = 1;
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; t++) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();
  for (int t = 0; t < n_threads; t++) {
    if (errs[t]) {
      // roll the symbol array back so the HydHF stays usable: callers
      // (multi-host with_retry) may retry the whole LF group after a
      // transient corrupt transfer
      h->syms.resize(base);
      return -1;
    }
    h->max_alphabet_size = std::max(h->max_alphabet_size, maxa[t]);
    for (size_t c = 0; c < h->num_clusters; c++)
      h->alphabet_sizes[c] = std::max(h->alphabet_sizes[c], alpha[t][c]);
  }
  for (long g = 0; g < n_groups; g++) {
    int gbh, gbw;
    extent(g, &gbh, &gbw);
    if (!gbh || !gbw) continue;  // phantom buffer group: no HF section
    h->barriers.push_back((size_t)sym_counts[g]);
    h->presets.push_back(preset);
  }
  return 0;
}

void hyd_hf_add_group(HydHF* h, const uint16_t* tokens,
                      const uint8_t* clusters, const uint32_t* residues,
                      const uint8_t* rbits, const int32_t* valid_len,
                      long n_blocks, uint32_t preset) {
  size_t before = h->syms.size();
  for (long b = 0; b < n_blocks; b++) {
    for (int c = 0; c < 3; c++) {
      long base = (b * 3 + c) * 64;
      int vl = valid_len[b * 3 + c];
      for (int k = 0; k < vl; k++) {
        Sym s;
        s.token = tokens[base + k];
        s.cluster = clusters[base + k];
        s.residue = residues[base + k];
        s.residue_bits = rbits[base + k];
        h->syms.push_back(s);
        uint32_t a = s.token + 1;
        h->max_alphabet_size = std::max(h->max_alphabet_size, a);
        h->alphabet_sizes[s.cluster] =
            std::max(h->alphabet_sizes[s.cluster], a);
      }
    }
  }
  h->barriers.push_back(h->syms.size() - before);
  h->presets.push_back(preset);
}

// Normalize + alias build over all clusters.
int hyd_hf_prepare(HydHF* h) {
  try {
    h->freqs.assign(h->num_clusters, {});
    for (size_t c = 0; c < h->num_clusters; c++)
      h->freqs[c].assign(h->alphabet_sizes[c], 0);
    for (const Sym& s : h->syms) h->freqs[s.cluster][s.token]++;
    h->las = h->las_forced ? h->las_forced
                           : std::max(cllog2(h->max_alphabet_size), 5);
    if ((uint32_t)(1u << h->las) < h->max_alphabet_size)
      throw std::runtime_error("alphabet exceeds forced las");
    if (h->las < 5 || h->las > 8)
      throw std::runtime_error("las outside [5, 8] (alphabet too large "
                               "or bad force_las)");
    h->aliases.assign(h->num_clusters, {});
    for (size_t c = 0; c < h->num_clusters; c++) {
      if (!h->alphabet_sizes[c]) continue;
      bool uniq = normalize_ans(h->freqs[c], h->alphabet_sizes[c]);
      build_alias(h->freqs[c], h->alphabet_sizes[c], h->las,
                  uniq ? (int)h->alphabet_sizes[c] - 1 : -1, h->aliases[c]);
    }
    return 0;
  } catch (const std::exception&) {
    return -1;
  }
}

// Encode group g's section into its own writer (call after prepare).
int hyd_hf_encode_group(HydHF* h, long g, int preset_bits, HydWriter* w) {
  try {
    size_t off = 0;
    for (long i = 0; i < g; i++) off += h->barriers[i];
    w->bw.write(h->presets[g], preset_bits);
    ans_encode_slice(h->syms.data() + off, h->barriers[g], h->freqs,
                     h->aliases, h->las, w->bw);
    return 0;
  } catch (const std::exception&) {
    return -1;
  }
}

long hyd_hf_num_groups(HydHF* h) { return (long)h->barriers.size(); }
int hyd_hf_las(HydHF* h) { return h->las; }
void hyd_hf_force_las(HydHF* h, int las) { h->las_forced = las; }
long hyd_hf_max_alphabet(HydHF* h) { return h->max_alphabet_size; }

// Copy out normalized frequencies for cluster c (for the Python-side
// header writer); returns alphabet size.
long hyd_hf_frequencies(HydHF* h, long c, uint32_t* out, long cap) {
  long A = h->alphabet_sizes[c];
  if (A > cap) return -1;
  if (A) memcpy(out, h->freqs[c].data(), A * sizeof(uint32_t));
  return A;
}

// Write the full ANS histogram header section (without the cluster-map /
// hybrid-config preamble, which the Python side writes since it owns the
// cluster map construction).
int hyd_hf_write_frequencies(HydHF* h, HydWriter* w) {
  try {
    for (size_t c = 0; c < h->num_clusters; c++)
      write_ans_frequencies(w->bw, h->freqs[c], h->alphabet_sizes[c]);
    return 0;
  } catch (const std::exception&) {
    return -1;
  }
}

// Full ANS stream header for the HF stream: no-lz77 bit, cluster map,
// log_alphabet_size, per-cluster hybrid config (4,1,0), histograms.
int hyd_hf_write_header(HydHF* h, const uint8_t* cmap, long num_dists,
                        HydWriter* w) {
  try {
    // las occupies a 2-bit field as (las - 5); anything outside [5, 8]
    // (oversized alphabet, bad force_las) would silently wrap into a
    // corrupt header, so fail loudly instead.
    if (h->las < 5 || h->las > 8) return -1;
    BitWriter& bw = w->bw;
    bw.write_bool(false);  // lz77
    std::vector<uint8_t> cm(cmap, cmap + num_dists);
    write_cluster_map(cm, num_dists, h->num_clusters, bw);
    bw.write_bool(false);  // use_prefix_codes = 0 => ANS
    bw.write(h->las - 5, 2);
    HybridConfig cfg{4, 1, 0};
    for (size_t c = 0; c < h->num_clusters; c++)
      write_hybrid_config(bw, cfg, h->las);
    return hyd_hf_write_frequencies(h, w);
  } catch (const std::exception&) {
    return -1;
  }
}

// Encode every group section in parallel into caller-provided writers.
int hyd_hf_encode_all(HydHF* h, int preset_bits, HydWriter** writers,
                      int n_threads) {
  size_t n = h->barriers.size();
  std::vector<size_t> offsets(n + 1, 0);
  for (size_t i = 0; i < n; i++) offsets[i + 1] = offsets[i] + h->barriers[i];
  std::atomic<int> failed{0};
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](size_t t0) {
    for (size_t g = t0; g < n; g += n_threads) {
      try {
        writers[g]->bw.write(h->presets[g], preset_bits);
        ans_encode_slice(h->syms.data() + offsets[g], h->barriers[g],
                         h->freqs, h->aliases, h->las, writers[g]->bw);
      } catch (const std::exception&) {
        failed.store(1);
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 1; t < n_threads; t++) threads.emplace_back(worker, t);
  worker(0);
  for (auto& th : threads) th.join();
  return failed.load() ? -1 : 0;
}

// PNG row defilter (spec 9.2): reconstruct one scanline in place.
// cur[0..n): filtered bytes (filter byte already stripped); prev is the
// reconstructed previous scanline or NULL for the first row.  Serial by
// nature (Sub/Paeth chain left-to-right) -- the hot loop of streaming
// PNG input (utils/pngio.py), the equivalent of the reference CLI's
// libspng row decode (hydrium.c:407-422).
int hyd_png_unfilter(uint8_t* cur, const uint8_t* prev, long n, int bpp,
                     int filter) {
  auto up = [&](long i) -> int { return prev ? prev[i] : 0; };
  switch (filter) {
    case 0:
      return 0;
    case 1:
      for (long i = bpp; i < n; i++) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
      return 0;
    case 2:
      for (long i = 0; i < n; i++) cur[i] = (uint8_t)(cur[i] + up(i));
      return 0;
    case 3:
      for (long i = 0; i < bpp; i++) cur[i] = (uint8_t)(cur[i] + up(i) / 2);
      for (long i = bpp; i < n; i++)
        cur[i] = (uint8_t)(cur[i] + ((cur[i - bpp] + up(i)) >> 1));
      return 0;
    case 4:
      for (long i = 0; i < n; i++) {
        int a = i >= bpp ? cur[i - bpp] : 0;
        int b = up(i);
        int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
        int p = a + b - c;
        int pa = p > a ? p - a : a - p;
        int pb = p > b ? p - b : b - p;
        int pc = p > c ? p - c : c - p;
        int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        cur[i] = (uint8_t)(cur[i] + pred);
      }
      return 0;
    default:
      return -1;
  }
}

// ---------------------------------------------------------------------------
// PXPACK v1: host-side lossless bitpack of u8/u16 pixel buffers so the
// host->device transfer of an LF group carries near-minimal bits (the
// reverse direction ships the near-entropy packed payload).  The device
// unpacks
// with vectorized shifts/masks (ops/pipeline.py _unpack_px_planes --
// the two sides share this format; change both together):
//
//   blocks of 32 consecutive pixels along a row, one channel per block,
//   in channel-planar raster order: block b = (c*H + y)*(W/32) + xb
//   hdr[b]  bits 0..4 = bit width (0..16), bit 7 = delta mode
//   base[b] u16: raw mode = block min; delta mode = first pixel value
//   words   per block exactly `width` u32 BIT-PLANE words (plane j holds
//           bit j of all 32 coded values, value k at bit position k)
//   coded values: raw = px - min; delta = zigzag(px[k] - px[k-1]) with
//   px[-1] := base, so a delta block's value 0 is always 0
//
// The per-block raw/delta choice keeps noisy blocks at their min-offset
// range width while gradient content drops to 1-3 bits/px.  Lossless by
// construction: the encoder's output is a function of the exact pixels
// either way (tests/test_pxpack.py pins pack->unpack identity and
// byte-identical encodes).
static inline int bitlen_u32(uint32_t v) {
  return v ? 32 - __builtin_clz(v) : 0;
}

// pass 1 of hyd_px_pack: header (width/mode) for blocks [b0, b1)
static void px_pack_widths(const uint8_t* px8, const uint16_t* px16, long h,
                           long w, long b0, long b1, uint8_t* hdr,
                           uint16_t* base) {
  const long wb = w >> 5;
  for (long b = b0; b < b1; b++) {
    const long c = b / (h * wb);
    const long y = (b / wb) % h;
    const long x0 = (b % wb) << 5;
    int vals[32];
    const long s = (y * w + x0) * 3 + c;
    if (px16) {
      for (int k = 0; k < 32; k++) vals[k] = px16[s + 3 * k];
    } else {
      for (int k = 0; k < 32; k++) vals[k] = px8[s + 3 * k];
    }
    int mn = vals[0], mx = vals[0];
    uint32_t dmax = 0;
    int prev = vals[0];
    for (int k = 0; k < 32; k++) {
      const int v = vals[k];
      mn = v < mn ? v : mn;
      mx = v > mx ? v : mx;
      const int d = v - prev;
      const uint32_t z = d >= 0 ? (uint32_t)(2 * d) : (uint32_t)(-2 * d - 1);
      dmax = z > dmax ? z : dmax;
      prev = v;
    }
    const int wr = bitlen_u32((uint32_t)(mx - mn));
    const int wd = bitlen_u32(dmax);
    if (wd < wr) {
      hdr[b] = (uint8_t)(wd | 0x80);
      base[b] = (uint16_t)vals[0];
    } else {
      hdr[b] = (uint8_t)wr;
      base[b] = (uint16_t)mn;
    }
  }
}

// pass 2: bit-plane fill for blocks [b0, b1) at precomputed offsets
static void px_pack_fill(const uint8_t* px8, const uint16_t* px16, long h,
                         long w, long b0, long b1, const uint8_t* hdr,
                         const uint16_t* base, const uint32_t* offs,
                         uint32_t* words) {
  const long wb = w >> 5;
  for (long b = b0; b < b1; b++) {
    const int width = hdr[b] & 31;
    if (!width) continue;
    const long c = b / (h * wb);
    const long y = (b / wb) % h;
    const long x0 = (b % wb) << 5;
    const long s = (y * w + x0) * 3 + c;
    uint32_t coded[32];
    if (hdr[b] & 0x80) {
      int prev = base[b];
      for (int k = 0; k < 32; k++) {
        const int v = px16 ? px16[s + 3 * k] : px8[s + 3 * k];
        const int d = v - prev;
        coded[k] = d >= 0 ? (uint32_t)(2 * d) : (uint32_t)(-2 * d - 1);
        prev = v;
      }
    } else {
      const int mn = base[b];
      for (int k = 0; k < 32; k++) {
        const int v = px16 ? px16[s + 3 * k] : px8[s + 3 * k];
        coded[k] = (uint32_t)(v - mn);
      }
    }
    uint32_t* out = words + offs[b];
    for (int j = 0; j < width; j++) {
      uint32_t m = 0;
      for (int k = 0; k < 32; k++) m |= ((coded[k] >> j) & 1u) << k;
      out[j] = m;
    }
  }
}

// Pack an interleaved [h, w, 3] u8/u16 buffer (w % 32 == 0).  hdr/base
// must hold 3*h*(w/32) entries; returns the packed word count, or -1
// when it would exceed words_cap (caller uploads raw instead).
long hyd_px_pack(const void* px, long h, long w, int is16, uint8_t* hdr,
                 uint16_t* base, uint32_t* words, long words_cap,
                 int n_threads) {
  if (w % 32 || h <= 0 || w <= 0) return -1;
  const uint8_t* px8 = is16 ? nullptr : (const uint8_t*)px;
  const uint16_t* px16 = is16 ? (const uint16_t*)px : nullptr;
  const long nb = 3 * h * (w >> 5);
  if (n_threads < 1) n_threads = 1;
  if (n_threads > 8) n_threads = 8;
  {
    std::vector<std::thread> ts;
    const long step = (nb + n_threads - 1) / n_threads;
    for (int t = 1; t < n_threads; t++) {
      const long b0 = t * step;
      if (b0 >= nb) break;
      ts.emplace_back(px_pack_widths, px8, px16, h, w, b0,
                      std::min(nb, b0 + step), hdr, base);
    }
    px_pack_widths(px8, px16, h, w, 0, std::min(nb, step), hdr, base);
    for (auto& t : ts) t.join();
  }
  std::vector<uint32_t> offs((size_t)nb);
  long total = 0;
  for (long b = 0; b < nb; b++) {
    offs[(size_t)b] = (uint32_t)total;
    total += hdr[b] & 31;
  }
  if (total > words_cap) return -1;
  {
    std::vector<std::thread> ts;
    const long step = (nb + n_threads - 1) / n_threads;
    for (int t = 1; t < n_threads; t++) {
      const long b0 = t * step;
      if (b0 >= nb) break;
      ts.emplace_back(px_pack_fill, px8, px16, h, w, b0,
                      std::min(nb, b0 + step), hdr, base, offs.data(), words);
    }
    px_pack_fill(px8, px16, h, w, 0, std::min(nb, step), hdr, base,
                 offs.data(), words);
    for (auto& t : ts) t.join();
  }
  return total;
}

}  // extern "C"
