// Native host-runtime components for quaff-tpu.
//
// The device compute path is JAX/XLA; this library provides the native host
// pieces that feed it, mirroring the roles of the reference's C/C++
// runtime (kseq/kseq.h streaming FASTQ parser; src/fastseq.cpp k-mer
// index; src/diagenv.cpp per-diagonal k-mer match counting):
//
//   * gzip-transparent FASTA/FASTQ record parser (arena-allocated)
//   * sequence tokenisation
//   * k-mer window codes and per-diagonal match counting for envelope
//     seeding (the host-side hot loop of the banded-DP pre-filter)
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (quaff_tpu/native.py), with a pure-Python fallback when the library is
// not built.  Build: make -C native (produces libquaffio.so).

#include <algorithm>
#include <cmath>
#include <limits>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>
#include <zlib.h>

namespace {

struct Record {
  std::string name, comment, seq, qual;
  int64_t filepos = -1;
};

struct SeqFile {
  std::vector<Record> records;
  std::string error;
};

// streaming line reader over a gzFile with uncompressed-offset tracking
class LineReader {
 public:
  explicit LineReader(gzFile f) : f_(f) {}

  // returns false at EOF; line excludes the trailing newline
  bool next(std::string& line, int64_t& start_offset) {
    line.clear();
    start_offset = offset_;
    bool any = false;
    while (true) {
      if (pos_ >= len_) {
        len_ = gzread(f_, buf_, sizeof(buf_));
        pos_ = 0;
        if (len_ <= 0) return any;
      }
      char* nl = (char*)memchr(buf_ + pos_, '\n', len_ - pos_);
      size_t take = nl ? (nl - (buf_ + pos_)) : (len_ - pos_);
      line.append(buf_ + pos_, take);
      pos_ += take;
      offset_ += take;
      any = true;
      if (nl) {
        ++pos_;
        ++offset_;
        // strip trailing CR
        if (!line.empty() && line.back() == '\r') line.pop_back();
        return true;
      }
    }
  }

 private:
  gzFile f_;
  char buf_[1 << 16];
  int len_ = 0;
  int pos_ = 0;
  int64_t offset_ = 0;
};

void parse_stream(LineReader& lr, SeqFile* out) {
  std::string line;
  int64_t pos = 0;
  bool have_line = lr.next(line, pos);
  while (have_line) {
    // skip to the next header
    while (have_line && line.empty() == false && line[0] != '>' &&
           line[0] != '@')
      have_line = lr.next(line, pos);
    while (have_line && line.empty())
      have_line = lr.next(line, pos);
    if (!have_line) break;
    if (line[0] != '>' && line[0] != '@') continue;

    Record rec;
    rec.filepos = pos;
    const size_t sp = line.find_first_of(" \t");
    if (sp == std::string::npos) {
      rec.name = line.substr(1);
    } else {
      rec.name = line.substr(1, sp - 1);
      const size_t cs = line.find_first_not_of(" \t", sp);
      if (cs != std::string::npos) rec.comment = line.substr(cs);
    }

    // sequence lines until header or '+'
    bool has_plus = false;
    while ((have_line = lr.next(line, pos))) {
      if (!line.empty() && (line[0] == '>' || line[0] == '@')) break;
      if (!line.empty() && line[0] == '+') {
        has_plus = true;
        break;
      }
      rec.seq += line;
    }
    if (has_plus) {
      std::string qual;
      while (qual.size() < rec.seq.size() && lr.next(line, pos))
        qual += line;
      if (qual.size() == rec.seq.size()) rec.qual = qual;
      have_line = lr.next(line, pos);
    }
    out->records.push_back(std::move(rec));
  }
}

int8_t g_token_table[256];
struct TokenTableInit {
  TokenTableInit() {
    memset(g_token_table, -1, sizeof(g_token_table));
    const char* alpha = "ACGT";
    for (int i = 0; i < 4; ++i) {
      g_token_table[(unsigned char)alpha[i]] = (int8_t)i;
      g_token_table[(unsigned char)tolower(alpha[i])] = (int8_t)i;
    }
  }
} g_token_table_init;

}  // namespace

extern "C" {

void* qio_open(const char* path) {
  SeqFile* sf = new SeqFile;
  gzFile f = gzopen(path, "rb");
  if (!f) {
    sf->error = "cannot open file";
    return sf;
  }
  LineReader lr(f);
  parse_stream(lr, sf);
  gzclose(f);
  return sf;
}

const char* qio_error(void* h) {
  SeqFile* sf = (SeqFile*)h;
  return sf->error.empty() ? nullptr : sf->error.c_str();
}

int64_t qio_num_seqs(void* h) { return (int64_t)((SeqFile*)h)->records.size(); }

const char* qio_name(void* h, int64_t i) {
  return ((SeqFile*)h)->records[i].name.c_str();
}
const char* qio_comment(void* h, int64_t i) {
  return ((SeqFile*)h)->records[i].comment.c_str();
}
const char* qio_seq(void* h, int64_t i) {
  return ((SeqFile*)h)->records[i].seq.c_str();
}
int64_t qio_seq_len(void* h, int64_t i) {
  return (int64_t)((SeqFile*)h)->records[i].seq.size();
}
const char* qio_qual(void* h, int64_t i) {
  return ((SeqFile*)h)->records[i].qual.c_str();
}
int64_t qio_qual_len(void* h, int64_t i) {
  return (int64_t)((SeqFile*)h)->records[i].qual.size();
}
int64_t qio_filepos(void* h, int64_t i) {
  return ((SeqFile*)h)->records[i].filepos;
}

void qio_close(void* h) { delete (SeqFile*)h; }

// tokenise ACGT (case-insensitive) into int32 tokens; returns the index of
// the first invalid character, or -1 on success
int64_t qio_tokenize(const char* seq, int64_t len, int32_t* out) {
  for (int64_t i = 0; i < len; ++i) {
    const int8_t t = g_token_table[(unsigned char)seq[i]];
    if (t < 0) return i;
    out[i] = t;
  }
  return -1;
}

// per-diagonal k-mer match counting (diagenv.cpp:34-40): counts, for every
// diagonal d = i - j, the number of k-mer windows shared between x and y.
// Returns the number of distinct diagonals written to out_diags/out_counts
// (caller provides buffers of capacity x_len + y_len).
int64_t qio_diag_kmer_counts(const int32_t* x_tok, int64_t x_len,
                             const int32_t* y_tok, int64_t y_len, int32_t k,
                             int64_t* out_diags, int64_t* out_counts) {
  if (x_len < k || y_len < k) return 0;
  const int64_t ny = y_len - k + 1;
  const uint64_t mask = (k < 32) ? ((1ull << (2 * k)) - 1) : ~0ull;

  if (k <= 12) {
    // counting-bucket index over the 4^k code space (k <= 12 -> <= 16M
    // buckets; default k = 6 -> 4096) + flat per-diagonal counters:
    // O(nx + ny + matches + x_len + y_len) with zero hashing/allocation
    // churn (the unordered_map version spent its time in node allocs).
    const int64_t nc = 1ll << (2 * k);
    std::vector<int32_t> bucket_count(nc + 1, 0);
    std::vector<int32_t> y_code(ny);
    uint64_t code = 0;
    for (int64_t j = 0; j < y_len; ++j) {
      code = ((code << 2) | (uint64_t)y_tok[j]) & mask;
      if (j >= k - 1) {
        y_code[j - k + 1] = (int32_t)code;
        ++bucket_count[code + 1];
      }
    }
    for (int64_t c = 0; c < nc; ++c) bucket_count[c + 1] += bucket_count[c];
    std::vector<int32_t> y_pos(ny);
    std::vector<int32_t> fill(bucket_count.begin(), bucket_count.end() - 1);
    for (int64_t j = 0; j < ny; ++j) y_pos[fill[y_code[j]]++] = (int32_t)j;

    // diagonal d = xi - j lies in [-(y_len-1), x_len-1]; offset by y_len-1
    std::vector<int64_t> diag_count(x_len + y_len - 1, 0);
    code = 0;
    for (int64_t i = 0; i < x_len; ++i) {
      code = ((code << 2) | (uint64_t)x_tok[i]) & mask;
      if (i < k - 1) continue;
      const int64_t xi = i - k + 1;
      const int32_t lo = bucket_count[code], hi = bucket_count[code + 1];
      for (int32_t t = lo; t < hi; ++t)
        ++diag_count[xi - y_pos[t] + y_len - 1];
    }
    int64_t n = 0;
    for (int64_t d = 0; d < (int64_t)diag_count.size(); ++d)
      if (diag_count[d]) {
        out_diags[n] = d - (y_len - 1);
        out_counts[n] = diag_count[d];
        ++n;
      }
    return n;
  }

  // large k: hash index (code space too big for counting buckets)
  std::unordered_map<uint64_t, std::vector<int32_t>> index;
  index.reserve((size_t)ny * 2);
  uint64_t code = 0;
  for (int64_t j = 0; j < y_len; ++j) {
    code = ((code << 2) | (uint64_t)y_tok[j]) & mask;
    if (j >= k - 1) index[code].push_back((int32_t)(j - k + 1));
  }
  std::unordered_map<int64_t, int64_t> diag_count;
  code = 0;
  for (int64_t i = 0; i < x_len; ++i) {
    code = ((code << 2) | (uint64_t)x_tok[i]) & mask;
    if (i < k - 1) continue;
    auto it = index.find(code);
    if (it == index.end()) continue;
    const int64_t xi = i - k + 1;
    for (int32_t j : it->second) ++diag_count[xi - j];
  }
  std::vector<std::pair<int64_t, int64_t>> items(diag_count.begin(),
                                                 diag_count.end());
  std::sort(items.begin(), items.end());
  int64_t n = 0;
  for (const auto& kv : items) {
    out_diags[n] = kv.first;
    out_counts[n] = kv.second;
    ++n;
  }
  return n;
}

// Prebuilt-index variant for all-vs-all prep (k <= 12 only): each read
// appears as the y side of ~N pairs, so rebuilding the counting-bucket
// index per pair (qio_diag_kmer_counts above) repays its cost N times.
// qio_diag_kmer_index writes the reusable index ONCE per read:
//   bucket_count [4^k + 1]  (prefix sums; bucket c spans
//                            [bucket_count[c], bucket_count[c+1]))
//   y_pos        [y_len - k + 1]  (window starts, bucket-grouped)
// qio_diag_kmer_counts_indexed then joins one x against it with zero
// per-call allocation beyond a thread-local diagonal counter.
void qio_diag_kmer_index(const int32_t* y_tok, int64_t y_len, int32_t k,
                         int32_t* bucket_count, int32_t* y_pos) {
  const int64_t nc = 1ll << (2 * k);
  const uint64_t mask = (1ull << (2 * k)) - 1;
  const int64_t ny = y_len - k + 1;
  std::fill(bucket_count, bucket_count + nc + 1, 0);
  if (ny <= 0) return;
  std::vector<int32_t> y_code(ny);
  uint64_t code = 0;
  for (int64_t j = 0; j < y_len; ++j) {
    code = ((code << 2) | (uint64_t)y_tok[j]) & mask;
    if (j >= k - 1) {
      y_code[j - k + 1] = (int32_t)code;
      ++bucket_count[code + 1];
    }
  }
  for (int64_t c = 0; c < nc; ++c) bucket_count[c + 1] += bucket_count[c];
  std::vector<int32_t> fill(bucket_count, bucket_count + nc);
  for (int64_t j = 0; j < ny; ++j) y_pos[fill[y_code[j]]++] = (int32_t)j;
}

int64_t qio_diag_kmer_counts_indexed(
    const int32_t* x_tok, int64_t x_len, int64_t y_len, int32_t k,
    const int32_t* bucket_count, const int32_t* y_pos,
    int64_t* out_diags, int64_t* out_counts) {
  if (x_len < k || y_len < k) return 0;
  const uint64_t mask = (1ull << (2 * k)) - 1;
  thread_local std::vector<int64_t> diag_count;
  const int64_t nd = x_len + y_len - 1;
  if ((int64_t)diag_count.size() < nd) diag_count.resize(nd);
  std::fill(diag_count.begin(), diag_count.begin() + nd, 0);
  uint64_t code = 0;
  for (int64_t i = 0; i < x_len; ++i) {
    code = ((code << 2) | (uint64_t)x_tok[i]) & mask;
    if (i < k - 1) continue;
    const int64_t xi = i - k + 1;
    const int32_t lo = bucket_count[code], hi = bucket_count[code + 1];
    for (int32_t t = lo; t < hi; ++t)
      ++diag_count[xi - y_pos[t] + y_len - 1];
  }
  int64_t n = 0;
  for (int64_t d = 0; d < nd; ++d)
    if (diag_count[d]) {
      out_diags[n] = d - (y_len - 1);
      out_counts[n] = diag_count[d];
      ++n;
    }
  return n;
}

}  // extern "C"

extern "C" {

// Sequential truncated log-sum-exp chain (the reference's lookup-table
// lse semantics, logsumexp.cpp:34-103, as emulated by
// quaff_tpu/dp/overlap._ref_lse): for each of n_steps terms, in order,
//   acc[e] = ref_lse(acc[e], terms[t*elems + e])
// where ref_lse(a,b) = max + log1p(exp(-|a-b|)) for |a-b| < 10, max
// otherwise (the table truncation), and -inf if both are -inf.  The
// overlap pair-table build runs thousands of tiny ordered steps; doing
// the chain here removes the per-step numpy dispatch overhead while
// keeping the float op order bit-exact.
void qref_lse_chain(double* acc, const double* terms, int64_t n_steps,
                    int64_t elems) {
  const double NEG_INF = -std::numeric_limits<double>::infinity();
  for (int64_t t = 0; t < n_steps; ++t) {
    const double* row = terms + t * elems;
    for (int64_t e = 0; e < elems; ++e) {
      const double a = acc[e], b = row[e];
      if (a == NEG_INF && b == NEG_INF) continue;
      const double m = a > b ? a : b;
      const double d = a > b ? a - b : b - a;
      if (d >= 10.0 || !(d == d) || d == INFINITY) {
        acc[e] = m;
      } else {
        acc[e] = m + std::log1p(std::exp(-d));
      }
    }
  }
}

}  // extern "C"
