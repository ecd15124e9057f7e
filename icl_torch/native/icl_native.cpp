// icl_native — fast IO paths for the icl framework (layer L3 native).
//
// Reference parity: the reference stack's native IO lived in its
// dependencies (gensim Cython readers; SURVEY.md §3.2 N2).  This library is
// the rebuild's equivalent: a single-pass `.feats` parser (LibSVM-style
// lines with trailing `# id` comments, SURVEY §6.1) and a `.scores` writer
// (§6.2, "%.6f" natural probabilities) exposed through a C ABI consumed via
// ctypes (icl/native/__init__.py).  Python fallbacks exist for both and are
// tested for byte/value equality (tests/unit/test_feats.py).
//
// Build: `make -C native` → icl/native/libicl_native.so

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct FeatsData {
  std::vector<double> labels;
  std::vector<int32_t> row_offsets;  // size n_examples+1 into indices/values
  std::vector<int32_t> indices;
  std::vector<float> values;
  std::string id_buffer;             // ids concatenated with '\0'
  std::vector<int64_t> id_offsets;   // size n_examples into id_buffer
  int64_t skipped = 0;               // malformed lines dropped whole
  bool needs_python = false;         // non-ASCII could change tokenization
  int64_t fallback_line = -1;        // 1-based line of the FIRST trigger
  std::string error;
};

// Universal-newline line iteration (Python text mode splits lines on
// "\n", "\r\n", AND bare "\r" — a mid-line CR is a line break there, so
// byte-level parsers must split identically or they merge two Python
// lines into one; caught by the native-vs-Python grammar fuzz).
// Sets *line_end to the line's end and returns the start of the next line.
inline const char* next_line(const char* p, const char* end,
                             const char** line_end) {
  const char* q = p;
  while (q < end && *q != '\n' && *q != '\r') ++q;
  *line_end = q;
  if (q < end) {
    if (*q == '\r' && q + 1 < end && q[1] == '\n') return q + 2;
    return q + 1;
  }
  return end;
}

// A label/index/value must end at whitespace, '#', or line end — strtod's
// numeric-prefix acceptance ("1x") must not diverge from Python float().
inline bool token_ends_ok(const char* next, const char* end) {
  return next >= end || *next == ' ' || *next == '\t' || *next == '\r' ||
         *next == '\n' || *next == '\v' || *next == '\f' || *next == '#';
}

// Python str.strip()/split() whitespace, ASCII subset (line breaks cannot
// occur within a next_line()-split line).  Any NON-ASCII byte that could
// change tokenization (Unicode whitespace/digits) routes the whole file
// to the Python parser via the needs_python flag instead.
inline bool py_ws(char c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

inline bool has_high_byte(const char* p, const char* end) {
  for (; p < end; ++p)
    if ((unsigned char)*p >= 0x80) return true;
  return false;
}

// memcpy with a zero-size no-op: an empty std::vector's data() may be
// null, and memcpy(dst, nullptr, 0) is UB (caught by the UBSAN harness).
inline void copy_out(void* dst, const void* src, size_t n) {
  if (n) memcpy(dst, src, n);
}

// strtod accepts C-only grammar Python float() rejects — hex floats
// ("0x1A").  Reject them so line-keeping matches the Python parser
// (which symmetrically rejects Python-only '1_0.5' underscores).
inline bool hex_prefixed(const char* p) {
  if (*p == '+' || *p == '-') ++p;
  return p[0] == '0' && (p[1] == 'x' || p[1] == 'X');
}

// strtod/strtof also accept C-only "nan(chars)" payload forms that Python
// float() rejects ("nan(x)" → float ValueError → line skipped).  Reject any
// token that begins (after sign) with nan( — if the paren sequence is
// malformed strtod stops at '(' and token_ends_ok already drops the line,
// but a well-formed payload parses clean and would diverge (ADVICE r3).
inline bool nan_paren(const char* p, const char* end) {
  if (p < end && (*p == '+' || *p == '-')) ++p;
  return end - p >= 4 && (p[0] == 'n' || p[0] == 'N') &&
         (p[1] == 'a' || p[1] == 'A') && (p[2] == 'n' || p[2] == 'N') &&
         p[3] == '(';
}

// Parse one line in place; 0 = blank/comment, 1 = example, -1 = malformed
// (the whole line is dropped and rolled back — matching the pure-Python
// parser, which skips any line whose label or idx:val tokens fail to parse,
// so behavior cannot differ by whether the .so built).
int parse_line(const char* p, const char* end, FeatsData* out) {
  while (p < end && py_ws(*p)) ++p;
  if (p >= end || *p == '#' || *p == '\n') return 0;

  char* next = nullptr;
  if (hex_prefixed(p) || nan_paren(p, end)) return -1;
  double label = strtod(p, &next);
  if (next == p || !token_ends_ok(next, end)) return -1;
  p = next;

  const size_t n0 = out->indices.size();
  out->labels.push_back(label);
  while (true) {
    while (p < end && py_ws(*p)) ++p;
    if (p >= end) break;
    if (*p == '#') {  // trailing id comment
      ++p;
      while (p < end && py_ws(*p)) ++p;
      const char* id_start = p;
      const char* id_end = end;
      while (id_end > id_start && py_ws(id_end[-1])) --id_end;
      if ((id_start < id_end && (unsigned char)*id_start >= 0x80) ||
          (id_start < id_end && (unsigned char)id_end[-1] >= 0x80))
        out->needs_python = true;   // Unicode-ws id padding: Python strips
      out->id_offsets.back() = (int64_t)out->id_buffer.size();
      out->id_buffer.append(id_start, id_end - id_start);
      out->id_buffer.push_back('\0');
      break;
    }
    long idx = strtol(p, &next, 10);
    if (next == p || *next != ':' ||
        idx < INT32_MIN || idx > INT32_MAX) {  // malformed/out-of-range:
      out->labels.pop_back();                  // drop the line (Python
      out->indices.resize(n0);                 // raises OverflowError and
      out->values.resize(n0);                  // skips it identically)
      return -1;
    }
    p = next + 1;
    // a whitespace value start must be rejected BEFORE strtof: strtox
    // functions skip leading whitespace themselves — including '\v' and
    // past line_end into the NEXT line's bytes (fuzz-caught).  Python
    // never sees this: split() tokens cannot start with whitespace, so
    // "1:<ws>..." is token "1:" with an empty value → line skipped.
    if (p >= end || py_ws(*p)) {
      out->labels.pop_back();
      out->indices.resize(n0);
      out->values.resize(n0);
      return -1;
    }
    float val = strtof(p, &next);
    if (next == p || hex_prefixed(p) || nan_paren(p, end) ||
        !token_ends_ok(next, end)) {
      out->labels.pop_back();
      out->indices.resize(n0);
      out->values.resize(n0);
      return -1;
    }
    p = next;
    out->indices.push_back((int32_t)idx);
    out->values.push_back(val);
  }
  out->row_offsets.push_back((int32_t)out->indices.size());
  return 1;
}

}  // namespace

extern "C" {

// Returns an opaque handle (or nullptr on IO failure).
void* feats_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (size > 0 && fread(&buf[0], 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  auto* data = new FeatsData();
  data->row_offsets.push_back(0);
  const char* p = buf.data();
  const char* end = p + buf.size();
  int64_t line_no = 0;
  while (p < end) {
    ++line_no;
    const char* line_end;
    const char* nxt = next_line(p, end, &line_end);
    const bool flagged_before = data->needs_python;
    data->id_offsets.push_back(-1);  // provisional; set by parse_line
    int r = parse_line(p, line_end, data);
    bool suspicious = data->needs_python && !flagged_before;
    if (r != 1) {
      data->id_offsets.pop_back();   // line produced no example
      if (r < 0) {
        ++data->skipped;
        if (has_high_byte(p, line_end)) {
          data->needs_python = true;
          suspicious = true;
        }
      }
    }
    if (suspicious && data->fallback_line < 0)
      data->fallback_line = line_no;   // sticky flag: only the FIRST
                                       // trigger is identifiable here;
                                       // icl-check censuses the rest
    p = nxt;
  }
  return data;
}

int64_t feats_num_examples(void* h) {
  return (int64_t)((FeatsData*)h)->labels.size();
}

int64_t feats_num_entries(void* h) {
  return (int64_t)((FeatsData*)h)->indices.size();
}

int64_t feats_id_buffer_size(void* h) {
  return (int64_t)((FeatsData*)h)->id_buffer.size();
}

int64_t feats_num_skipped(void* h) {
  return ((FeatsData*)h)->skipped;
}

// 1 when non-ASCII bytes could make tokenization differ from Python
// (Unicode whitespace/digits): callers re-parse with the Python reader.
int32_t feats_needs_python(void* h) {
  return ((FeatsData*)h)->needs_python ? 1 : 0;
}

// 1-based line number of the FIRST byte sequence the fast path could not
// prove equivalent to Python (-1 when none): surfaces WHY a whole-load
// demotion happened so a user with one stray non-ASCII byte in millions
// of rows has a path back to the fast loader (VERDICT r3 weak#5).
int64_t feats_fallback_line(void* h) {
  return ((FeatsData*)h)->fallback_line;
}

// Copies parsed columns into caller-allocated buffers.
void feats_fill(void* h, double* labels, int32_t* row_offsets,
                int32_t* indices, float* values, char* id_buffer,
                int64_t* id_offsets) {
  auto* d = (FeatsData*)h;
  copy_out(labels, d->labels.data(), d->labels.size() * sizeof(double));
  copy_out(row_offsets, d->row_offsets.data(),
         d->row_offsets.size() * sizeof(int32_t));
  copy_out(indices, d->indices.data(), d->indices.size() * sizeof(int32_t));
  copy_out(values, d->values.data(), d->values.size() * sizeof(float));
  copy_out(id_buffer, d->id_buffer.data(), d->id_buffer.size());
  copy_out(id_offsets, d->id_offsets.data(),
         d->id_offsets.size() * sizeof(int64_t));
}

void feats_free(void* h) { delete (FeatsData*)h; }

// ---------------------------------------------------------------------------
// Labels-only `.feats` parse: the relation/affinity/mention dataset loaders
// consume only (example_id, label) — the sparse feature columns feed the
// sklearn baseline path alone (SURVEY §4.1–4.4).  Skipping the idx:val
// tokenisation makes the scan memchr-bound and avoids materialising the
// nnz arrays at all, which is what keeps a 50k-image MSCOCO-scale split
// load bounded in time and memory (VERDICT r2 missing#2).
// ---------------------------------------------------------------------------

namespace {

struct FeatsLabels {
  std::vector<double> labels;
  std::string id_buffer;            // ids concatenated with '\0'
  std::vector<int64_t> id_offsets;  // -1 when a line carried no id comment
  int64_t skipped = 0;              // malformed lines dropped whole
  bool needs_python = false;        // non-ASCII could change tokenization
  int64_t fallback_line = -1;       // 1-based line of the FIRST trigger
};

}  // namespace

void* feats_parse_labels(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (size > 0 && fread(&buf[0], 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  auto* d = new FeatsLabels();
  const char* p = buf.data();
  const char* end = p + buf.size();
  int64_t line_no = 0;
  while (p < end) {
    ++line_no;
    const char* line_end;
    const char* nxt = next_line(p, end, &line_end);
    const bool flagged_before = d->needs_python;
    const char* q = p;
    while (q < line_end && py_ws(*q)) ++q;
    if (q < line_end && *q != '#') {     // not blank / comment-only
      char* next = nullptr;
      double label = ((hex_prefixed(q) || nan_paren(q, line_end))
                          ? (next = (char*)q, 0.0)
                          : strtod(q, &next));
      if (next != q && token_ends_ok(next, line_end)) {
        d->labels.push_back(label);      // else: malformed, counted below
        const char* hash = (const char*)memchr(q, '#', line_end - q);
        if (hash) {
          ++hash;
          while (hash < line_end && py_ws(*hash)) ++hash;
          const char* id_end = line_end;
          while (id_end > hash && py_ws(id_end[-1])) --id_end;
          if (hash < id_end && ((unsigned char)*hash >= 0x80 ||
                                (unsigned char)id_end[-1] >= 0x80))
            d->needs_python = true;  // Unicode-ws id padding: Python strips
          d->id_offsets.push_back((int64_t)d->id_buffer.size());
          d->id_buffer.append(hash, id_end - hash);
          d->id_buffer.push_back('\0');
        } else {
          d->id_offsets.push_back(-1);
        }
      } else {
        ++d->skipped;
        if (has_high_byte(q, line_end)) d->needs_python = true;
      }
    }
    if (d->needs_python && !flagged_before && d->fallback_line < 0)
      d->fallback_line = line_no;
    p = nxt;
  }
  return d;
}

int64_t featsl_num(void* h) {
  return (int64_t)((FeatsLabels*)h)->labels.size();
}

int64_t featsl_num_skipped(void* h) {
  return ((FeatsLabels*)h)->skipped;
}

int64_t featsl_fallback_line(void* h) {
  return ((FeatsLabels*)h)->fallback_line;
}

int32_t featsl_needs_python(void* h) {
  return ((FeatsLabels*)h)->needs_python ? 1 : 0;
}

int64_t featsl_id_buffer_size(void* h) {
  return (int64_t)((FeatsLabels*)h)->id_buffer.size();
}

void featsl_fill(void* h, double* labels, char* id_buffer,
                 int64_t* id_offsets) {
  auto* d = (FeatsLabels*)h;
  copy_out(labels, d->labels.data(), d->labels.size() * sizeof(double));
  copy_out(id_buffer, d->id_buffer.data(), d->id_buffer.size());
  copy_out(id_offsets, d->id_offsets.data(),
         d->id_offsets.size() * sizeof(int64_t));
}

void featsl_free(void* h) { delete (FeatsLabels*)h; }

void featsl_fill_labels(void* h, double* labels) {
  auto* d = (FeatsLabels*)h;
  copy_out(labels, d->labels.data(), d->labels.size() * sizeof(double));
}

// Write a .scores file (§6.2): one "<id>,<p0>,...,<pC-1>\n" per row with
// 6-decimal fixed formatting.  Returns 0 on success.  ``append`` != 0
// continues an earlier chunk — the Python wrapper streams MSCOCO-scale
// writes in bounded pieces instead of materializing millions of encoded
// id pointers at once.
int scores_write_chunk(const char* path, const char* const* ids,
                       const double* probs, int64_t n, int32_t c,
                       int32_t append) {
  FILE* f = fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  std::string line;
  // worst-case ",%.6f" of a finite double is ~318 chars (±1.8e308 → 309
  // integer digits + '.' + 6 decimals + sign + ',') — size for it, and
  // treat any truncation as an IO-level failure (the Python wrapper then
  // falls back to the pure-Python writer) instead of appending snprintf's
  // would-be length past the buffer (ADVICE r3).
  char num[352];
  for (int64_t i = 0; i < n; ++i) {
    line.assign(ids[i]);
    for (int32_t j = 0; j < c; ++j) {
      double v = probs[i * c + j];
      // glibc %.6f prints sign-bit NaNs as "-nan" (and may add a payload);
      // Python's float formatting always prints plain "nan" — pin the
      // Python bytes so which writer ran can't change the file (§7.3)
      int len = std::isnan(v)
                    ? snprintf(num, sizeof(num), ",nan")
                    : snprintf(num, sizeof(num), ",%.6f", v);
      if (len < 0 || len >= (int)sizeof(num)) {
        fclose(f);
        return -4;
      }
      line.append(num, len);
    }
    line.push_back('\n');
    if (fwrite(line.data(), 1, line.size(), f) != line.size()) {
      fclose(f);
      return -2;
    }
  }
  if (fclose(f) != 0) return -3;  // buffered flush can fail (disk full)
  return 0;
}

int scores_write(const char* path, const char* const* ids, const double* probs,
                 int64_t n, int32_t c) {
  return scores_write_chunk(path, ids, probs, n, c, 0);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Example-id table parser (SURVEY §6.1 id grammars).  Operating on a
// FeatsLabels handle, parses every example id into an int32 field table +
// a unique-doc string table, so MSCOCO-scale dataset loads never
// materialize per-row Python id strings (the id parse was ~60% of a 50k-
// image load wall — icl/data/pipeline.py).  STRICT PARITY CONTRACT with
// the manual Python parsers (icl/io/captions.py parse_*_padded): the
// grammar is `doc:<doc>;<marker><digits>...` where <doc> is nonempty and
// ';'-free and every field is nonempty ASCII [0-9]+ fitting int32.  Any
// row that deviates — bad grammar, an int32-overflowing field (Python
// int() is unbounded but the loaders' array('i') raises OverflowError),
// or a missing id comment — sets bad_row and the Python caller falls back
// WHOLE-LOAD to the pure-Python path, reproducing its exact error/skip
// behavior byte-for-byte.  Zero-padded fields (":07") are flagged per row:
// such ids don't round-trip re-serialization and take the exact-bytes
// override path (the flagged rows' id strings are returned verbatim).
// ---------------------------------------------------------------------------

namespace {

struct IdTable {
  std::vector<int32_t> fields;          // n * nfields
  std::vector<int32_t> doc_idx;         // n, index into the doc table
  std::vector<int64_t> padded_rows;     // rows with a zero-padded field
  std::string padded_ids;               // their exact ids, '\0'-joined
  std::string docs;                     // unique docs, '\0'-joined,
  std::vector<int64_t> doc_offsets;     //   first-appearance order
  int64_t ndocs = 0;
  int64_t bad_row = -1;                 // first deviating row, else -1
};

// kind 0: mention  doc:<d>;caption:<i>;mention:<i>
// kind 1: pair     doc:<d>;caption_1:<i>;mention_1:<i>;caption_2:<i>;mention_2:<i>
// kind 2: affinity doc:<d>;caption:<i>;mention:<i>;box:<i>
struct IdGrammar {
  const char* markers[4];
  int marker_len[4];
  int nfields;
};

const IdGrammar kGrammars[3] = {
    {{";caption:", ";mention:", nullptr, nullptr}, {9, 9, 0, 0}, 2},
    {{";caption_1:", ";mention_1:", ";caption_2:", ";mention_2:"},
     {11, 11, 11, 11}, 4},
    {{";caption:", ";mention:", ";box:", nullptr}, {9, 9, 5, 0}, 3},
};

// [0-9]+ with int32-overflow rejection; leading zeros flag `padded`
// (":07") exactly like the Python parsers ("0" alone is canonical).
inline bool parse_field(const char*& p, const char* end, int32_t* out,
                        bool* padded) {
  const char* s = p;
  int64_t v = 0;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');             // v <= INT32_MAX before the step,
    if (v > INT32_MAX) return false;     // so no int64 overflow possible
    ++p;
  }
  if (p == s) return false;
  if (*s == '0' && p - s > 1) *padded = true;
  *out = (int32_t)v;
  return true;
}

// One id against one grammar.  Equivalence with the Python partition-based
// parsers: they split at the FIRST occurrence of each marker and then
// require the captured field to be all-digits, which forces each marker to
// sit immediately after the digits — i.e. exactly this sequential scan
// (fuzz-tested in tests/unit/test_native_ids.py).
inline bool parse_id(const char* s, const char* e, const IdGrammar& g,
                     int32_t* f, bool* padded, const char** doc,
                     int* doc_len) {
  if (e - s < 5 || memcmp(s, "doc:", 4) != 0) return false;
  const char* p = s + 4;
  const char* semi = (const char*)memchr(p, ';', e - p);
  if (!semi || semi == p) return false;  // empty doc, or no ';' at all
  *doc = p;
  *doc_len = (int)(semi - p);
  p = semi;
  for (int i = 0; i < g.nfields; ++i) {
    if (e - p < g.marker_len[i] ||
        memcmp(p, g.markers[i], g.marker_len[i]) != 0)
      return false;
    p += g.marker_len[i];
    if (!parse_field(p, e, &f[i], padded)) return false;
  }
  return p == e;
}

}  // namespace

extern "C" {

// Parse every id of a FeatsLabels handle under grammar `kind` (0=mention,
// 1=pair, 2=affinity).  Always returns a table; check idt_bad_row.
void* featsl_parse_ids(void* h, int32_t kind) {
  auto* d = (FeatsLabels*)h;
  const IdGrammar& g = kGrammars[kind];
  auto* t = new IdTable();
  const int64_t n = (int64_t)d->labels.size();
  t->fields.reserve(n * g.nfields);
  t->doc_idx.reserve(n);
  std::unordered_map<std::string, int32_t> doc_map;
  // feats files are typically written image-by-image: cache the previous
  // doc so the map is touched ~once per image, not once per row
  std::string last_doc;
  int32_t last_idx = -1;
  const char* buf = d->id_buffer.data();
  for (int64_t i = 0; i < n; ++i) {
    const int64_t off = d->id_offsets[i];
    if (off < 0) { t->bad_row = i; break; }  // no id comment on the line
    const char* s = buf + off;
    const char* e = s + strlen(s);           // ids are '\0'-joined
    int32_t f[4];
    bool padded = false;
    const char* doc;
    int doc_len;
    if (!parse_id(s, e, g, f, &padded, &doc, &doc_len)) {
      t->bad_row = i;
      break;
    }
    if (last_idx < 0 || (size_t)doc_len != last_doc.size() ||
        memcmp(doc, last_doc.data(), doc_len) != 0) {
      last_doc.assign(doc, doc_len);
      auto it = doc_map.find(last_doc);
      if (it == doc_map.end()) {
        last_idx = (int32_t)t->ndocs++;
        doc_map.emplace(last_doc, last_idx);
        t->doc_offsets.push_back((int64_t)t->docs.size());
        t->docs.append(doc, doc_len);
        t->docs.push_back('\0');
      } else {
        last_idx = it->second;
      }
    }
    t->doc_idx.push_back(last_idx);
    t->fields.insert(t->fields.end(), f, f + g.nfields);
    if (padded) {
      t->padded_rows.push_back(i);
      t->padded_ids.append(s, e - s);
      t->padded_ids.push_back('\0');
    }
  }
  return t;
}

int64_t idt_bad_row(void* h) { return ((IdTable*)h)->bad_row; }
int64_t idt_num_docs(void* h) { return ((IdTable*)h)->ndocs; }
int64_t idt_docs_size(void* h) {
  return (int64_t)((IdTable*)h)->docs.size();
}
int64_t idt_num_padded(void* h) {
  return (int64_t)((IdTable*)h)->padded_rows.size();
}
int64_t idt_padded_ids_size(void* h) {
  return (int64_t)((IdTable*)h)->padded_ids.size();
}

void idt_fill(void* h, int32_t* fields, int32_t* doc_idx,
              int64_t* padded_rows, char* padded_ids, char* docs) {
  auto* t = (IdTable*)h;
  copy_out(fields, t->fields.data(), t->fields.size() * sizeof(int32_t));
  copy_out(doc_idx, t->doc_idx.data(), t->doc_idx.size() * sizeof(int32_t));
  copy_out(padded_rows, t->padded_rows.data(),
         t->padded_rows.size() * sizeof(int64_t));
  copy_out(padded_ids, t->padded_ids.data(), t->padded_ids.size());
  copy_out(docs, t->docs.data(), t->docs.size());
}

void idt_free(void* h) { delete (IdTable*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// mentions.txt columnar parser (SURVEY §3.1 C3).  Line grammar
// `<mention_id>\t<first>,<last>[\t<text>]` parsed straight into int32
// columns + a unique-doc table, so MSCOCO-scale loads never build per-
// mention Python objects.  PARITY CONTRACT with icl.io.captions.
// read_mentions: blank lines and lines starting with '#' are skipped;
// ANY other deviation — bad id grammar, span fields that are not plain
// [0-9]+ (Python int() also accepts '+1'/' 1'/'1_0' — rare; punt),
// first > last, int32 overflow, a missing tab, trailing '\r' — sets the
// fallback flag and the Python caller re-reads with read_mentions,
// reproducing its exact error messages.  The optional text field is
// ignored (columnar consumers never need it).
// ---------------------------------------------------------------------------

namespace {

struct MentionCols {
  std::vector<int32_t> cap, men, first, last, doc_idx;
  std::string docs;                 // unique docs, '\0'-joined
  std::vector<int64_t> doc_offsets;
  int64_t ndocs = 0;
  bool fallback = false;
  int64_t fallback_line = -1;       // 1-based line of the trigger
};

}  // namespace

extern "C" {

void* mentions_parse(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (size > 0 && fread(&buf[0], 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  auto* d = new MentionCols();
  std::unordered_map<std::string, int32_t> doc_map;
  std::string last_doc;
  int32_t last_idx = -1;
  const char* p = buf.data();
  const char* end = p + buf.size();
  int64_t line_no = 0;
  while (p < end) {
    ++line_no;
    const char* le;
    const char* nxt = next_line(p, end, &le);
    if (le == p || *p == '#') {          // blank / comment line
      p = nxt;
      continue;
    }
    const char* tab1 = (const char*)memchr(p, '\t', le - p);
    if (!tab1) { d->fallback = true; d->fallback_line = line_no; break; }
    int32_t fid[4];
    bool padded = false;  // canonicalized to ints either way — no override
    const char* doc;
    int doc_len;
    if (!parse_id(p, tab1, kGrammars[0], fid, &padded, &doc, &doc_len)) {
      d->fallback = true; d->fallback_line = line_no;
      break;
    }
    const char* q = tab1 + 1;
    const char* tab2 = (const char*)memchr(q, '\t', le - q);
    const char* f1e = tab2 ? tab2 : le;
    int32_t first_v, last_v;
    bool span_pad = false;
    if (!parse_field(q, f1e, &first_v, &span_pad) || q >= f1e || *q != ',') {
      d->fallback = true; d->fallback_line = line_no;
      break;
    }
    ++q;
    if (!parse_field(q, f1e, &last_v, &span_pad) || q != f1e ||
        first_v > last_v) {
      d->fallback = true; d->fallback_line = line_no;
      break;
    }
    if (last_idx < 0 || (size_t)doc_len != last_doc.size() ||
        memcmp(doc, last_doc.data(), doc_len) != 0) {
      last_doc.assign(doc, doc_len);
      auto it = doc_map.find(last_doc);
      if (it == doc_map.end()) {
        last_idx = (int32_t)d->ndocs++;
        doc_map.emplace(last_doc, last_idx);
        d->doc_offsets.push_back((int64_t)d->docs.size());
        d->docs.append(doc, doc_len);
        d->docs.push_back('\0');
      } else {
        last_idx = it->second;
      }
    }
    d->doc_idx.push_back(last_idx);
    d->cap.push_back(fid[0]);
    d->men.push_back(fid[1]);
    d->first.push_back(first_v);
    d->last.push_back(last_v);
    p = nxt;
  }
  return d;
}

int64_t men_num(void* h) { return (int64_t)((MentionCols*)h)->cap.size(); }
int32_t men_fallback(void* h) { return ((MentionCols*)h)->fallback ? 1 : 0; }
int64_t men_fallback_line(void* h) {
  return ((MentionCols*)h)->fallback_line;
}
int64_t men_num_docs(void* h) { return ((MentionCols*)h)->ndocs; }
int64_t men_docs_size(void* h) {
  return (int64_t)((MentionCols*)h)->docs.size();
}

void men_fill(void* h, int32_t* cap, int32_t* men, int32_t* first,
              int32_t* last, int32_t* doc_idx, char* docs) {
  auto* d = (MentionCols*)h;
  copy_out(cap, d->cap.data(), d->cap.size() * sizeof(int32_t));
  copy_out(men, d->men.data(), d->men.size() * sizeof(int32_t));
  copy_out(first, d->first.data(), d->first.size() * sizeof(int32_t));
  copy_out(last, d->last.data(), d->last.size() * sizeof(int32_t));
  copy_out(doc_idx, d->doc_idx.data(), d->doc_idx.size() * sizeof(int32_t));
  copy_out(docs, d->docs.data(), d->docs.size());
}

void men_free(void* h) { delete (MentionCols*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// captions.txt tokenizer (SURVEY §3.1 C3/C4).  Line grammar
// `<imgid>#<capIdx>\t<tok> <tok> ...` parsed straight into vocab-row id
// arrays: the caller passes the embedding vocabulary ('\n'-joined words in
// table-row order, row 1 first) and each token resolves exact-match-first,
// then ASCII-lowercased, else PAD/OOV row 0 — the lookup_id semantics of
// icl.data.embeddings.  PARITY RULES: any row whose token region contains
// a byte >= 0x80 is returned RAW instead of encoded (Python str.split()
// splits on Unicode whitespace and str.lower() is Unicode-aware — only
// the Python side can encode those rows exactly); any key the strict
// grammar cannot prove equivalent ('#'-less, non-[0-9] capIdx) sets the
// fallback flag and the caller re-reads whole-file with read_captions,
// reproducing its exact errors.
// ---------------------------------------------------------------------------

namespace {

struct CaptionIds {
  std::vector<int32_t> cap_idx, doc_idx;
  std::vector<int64_t> offsets;     // per-row [start, end) into ids
  std::vector<int32_t> ids;
  std::string docs;                 // unique img ids, '\0'-joined
  std::vector<int64_t> doc_offsets;
  int64_t ndocs = 0;
  std::vector<int64_t> flagged_rows;   // rows Python must re-encode
  std::string flagged_buf;             // their raw token bytes, '\0'-joined
  bool fallback = false;
  int64_t fallback_line = -1;          // 1-based line of the trigger
};

inline bool ascii_ws(char c) {
  // the ASCII subset of Python str.split() whitespace ('\n' ends the line)
  return c == ' ' || c == '\t' || c == '\r' || c == '\v' || c == '\f';
}

}  // namespace

extern "C" {

void* captions_parse(const char* path, const char* vocab) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (size > 0 && fread(&buf[0], 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  // vocab rows start at 1 (row 0 is PAD/OOV)
  std::unordered_map<std::string, int32_t> vmap;
  {
    const char* p = vocab;
    int32_t row = 1;
    while (*p) {
      const char* nl = strchr(p, '\n');
      size_t len = nl ? (size_t)(nl - p) : strlen(p);
      vmap.emplace(std::string(p, len), row++);
      p += len + (nl ? 1 : 0);
    }
  }

  auto* d = new CaptionIds();
  d->offsets.push_back(0);
  std::unordered_map<std::string, int32_t> doc_map;
  std::string last_doc, lowered;
  int32_t last_idx = -1;
  const char* p = buf.data();
  const char* end = p + buf.size();
  int64_t line_no = 0;
  while (p < end) {
    ++line_no;
    const char* le;
    const char* nxt = next_line(p, end, &le);
    if (le == p || *p == '#') {          // blank / comment line
      p = nxt;
      continue;
    }
    const char* tab = (const char*)memchr(p, '\t', le - p);
    const char* key_end = tab ? tab : le;      // no tab: empty caption
    // key = <img>#<cap>, split at the LAST '#' (rpartition)
    const char* hash = nullptr;
    for (const char* q = key_end; q > p;)
      if (*--q == '#') { hash = q; break; }
    if (!hash || hash == p) { d->fallback = true; d->fallback_line = line_no; break; }
    const char* cp = hash + 1;
    int32_t cap_v;
    bool pad = false;
    if (!parse_field(cp, key_end, &cap_v, &pad) || cp != key_end) {
      d->fallback = true; d->fallback_line = line_no;
      break;
    }
    const int doc_len = (int)(hash - p);
    if (last_idx < 0 || (size_t)doc_len != last_doc.size() ||
        memcmp(p, last_doc.data(), doc_len) != 0) {
      last_doc.assign(p, doc_len);
      auto it = doc_map.find(last_doc);
      if (it == doc_map.end()) {
        last_idx = (int32_t)d->ndocs++;
        doc_map.emplace(last_doc, last_idx);
        d->doc_offsets.push_back((int64_t)d->docs.size());
        d->docs.append(p, doc_len);
        d->docs.push_back('\0');
      } else {
        last_idx = it->second;
      }
    }
    const int64_t row = (int64_t)d->cap_idx.size();
    d->doc_idx.push_back(last_idx);
    d->cap_idx.push_back(cap_v);
    const char* t = tab ? tab + 1 : le;
    bool non_ascii = false;
    for (const char* q = t; q < le; ++q)
      if ((unsigned char)*q >= 0x80) { non_ascii = true; break; }
    if (non_ascii) {
      d->flagged_rows.push_back(row);
      d->flagged_buf.append(t, le - t);
      d->flagged_buf.push_back('\0');
    } else {
      while (t < le) {
        while (t < le && ascii_ws(*t)) ++t;
        const char* ts = t;
        while (t < le && !ascii_ws(*t)) ++t;
        if (t == ts) break;
        std::string tok(ts, t - ts);
        auto it = vmap.find(tok);
        if (it == vmap.end()) {
          lowered = tok;
          for (char& c : lowered)
            if (c >= 'A' && c <= 'Z') c += 'a' - 'A';
          it = vmap.find(lowered);
        }
        d->ids.push_back(it == vmap.end() ? 0 : it->second);
      }
    }
    d->offsets.push_back((int64_t)d->ids.size());
    p = nxt;
  }
  return d;
}

// Unique caption words (embedding-prune vocabulary, icl/cli/_common.py
// split_vocab).  Same grammar/fallback rules as captions_parse; rows with
// non-ASCII bytes return raw for Python's Unicode split.
void* captions_words(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf(size, '\0');
  if (size > 0 && fread(&buf[0], 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  auto* d = new CaptionIds();   // words ride in flagged_buf/docs fields:
  // docs = '\0'-joined unique words; flagged_buf = raw non-ASCII rows.
  // Two passes: read_captions is a DICT keyed <img>#<int(cap)> — duplicate
  // keys collapse last-wins, and words of overwritten lines must NOT enter
  // the prune vocabulary (they would change the pruned table, and through
  // the lowercase-OOV fallback, scores).  Pass 1 records the final token
  // region per canonical key; pass 2 tokenizes only the survivors.
  std::unordered_map<std::string, std::pair<const char*, const char*>> rows;
  std::vector<const std::string*> row_order;   // first-seen key order
  std::string keybuf;
  const char* p = buf.data();
  const char* end = p + buf.size();
  int64_t line_no = 0;
  while (p < end) {
    ++line_no;
    const char* le;
    const char* nxt = next_line(p, end, &le);
    if (le == p || *p == '#') {
      p = nxt;
      continue;
    }
    const char* tab = (const char*)memchr(p, '\t', le - p);
    const char* key_end = tab ? tab : le;
    // a high byte in the KEY region never reaches Python (only words are
    // returned), so invalid UTF-8 there would silently succeed here while
    // read_captions raises UnicodeDecodeError — route the whole file to
    // Python, matching the feats parsers' conservative treatment (ADVICE r3)
    if (has_high_byte(p, key_end)) {
      d->fallback = true; d->fallback_line = line_no;
      break;
    }
    const char* hash = nullptr;
    for (const char* q = key_end; q > p;)
      if (*--q == '#') { hash = q; break; }
    int32_t cap_v;
    bool pad = false;
    const char* cp = hash ? hash + 1 : key_end;
    if (!hash || hash == p || !parse_field(cp, key_end, &cap_v, &pad) ||
        cp != key_end) {
      d->fallback = true; d->fallback_line = line_no;
      break;
    }
    keybuf.assign(p, hash - p);
    keybuf.push_back('#');
    keybuf += std::to_string(cap_v);
    auto ins = rows.emplace(keybuf,
                            std::make_pair(tab ? tab + 1 : le, le));
    if (ins.second) {
      row_order.push_back(&ins.first->first);
    } else {
      ins.first->second = {tab ? tab + 1 : le, le};   // last-wins
    }
    p = nxt;
  }
  if (!d->fallback) {
    std::unordered_set<std::string> seen;
    std::string tok;
    for (const std::string* key : row_order) {
      const char* t = rows[*key].first;
      const char* le = rows[*key].second;
      bool non_ascii = false;
      for (const char* q = t; q < le; ++q)
        if ((unsigned char)*q >= 0x80) { non_ascii = true; break; }
      if (non_ascii) {
        d->flagged_buf.append(t, le - t);
        d->flagged_buf.push_back('\0');
        d->flagged_rows.push_back(0);   // count only; rows are irrelevant
        continue;
      }
      while (t < le) {
        while (t < le && ascii_ws(*t)) ++t;
        const char* ts = t;
        while (t < le && !ascii_ws(*t)) ++t;
        if (t == ts) break;
        tok.assign(ts, t - ts);
        if (seen.insert(tok).second) {
          d->docs.append(tok);
          d->docs.push_back('\0');
          ++d->ndocs;
        }
      }
    }
  }
  return d;
}

int64_t cap_num(void* h) { return (int64_t)((CaptionIds*)h)->cap_idx.size(); }
int32_t cap_fallback(void* h) { return ((CaptionIds*)h)->fallback ? 1 : 0; }
int64_t cap_fallback_line(void* h) {
  return ((CaptionIds*)h)->fallback_line;
}
int64_t cap_num_docs(void* h) { return ((CaptionIds*)h)->ndocs; }
int64_t cap_docs_size(void* h) {
  return (int64_t)((CaptionIds*)h)->docs.size();
}
int64_t cap_ids_total(void* h) {
  return (int64_t)((CaptionIds*)h)->ids.size();
}
int64_t cap_num_flagged(void* h) {
  return (int64_t)((CaptionIds*)h)->flagged_rows.size();
}
int64_t cap_flagged_bytes(void* h) {
  return (int64_t)((CaptionIds*)h)->flagged_buf.size();
}

void cap_fill(void* h, int32_t* cap_idx, int32_t* doc_idx, int64_t* offsets,
              int32_t* ids, char* docs, int64_t* flagged_rows,
              char* flagged_buf) {
  auto* d = (CaptionIds*)h;
  copy_out(cap_idx, d->cap_idx.data(), d->cap_idx.size() * sizeof(int32_t));
  copy_out(doc_idx, d->doc_idx.data(), d->doc_idx.size() * sizeof(int32_t));
  copy_out(offsets, d->offsets.data(), d->offsets.size() * sizeof(int64_t));
  copy_out(ids, d->ids.data(), d->ids.size() * sizeof(int32_t));
  copy_out(docs, d->docs.data(), d->docs.size());
  copy_out(flagged_rows, d->flagged_rows.data(),
         d->flagged_rows.size() * sizeof(int64_t));
  copy_out(flagged_buf, d->flagged_buf.data(), d->flagged_buf.size());
}

void cap_free(void* h) { delete (CaptionIds*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// word2vec binary loader (GoogleNews .bin: "V D\n" header, then per word:
// "<word> " + D little-endian float32).  Equivalent of gensim's Cython
// reader (SURVEY §3.2 N2).  Optional vocabulary filter: when `filter_words`
// is non-null (newline-joined list), only matching words are materialized —
// the gensim-era trick for fitting GoogleNews-scale tables.
// ---------------------------------------------------------------------------

namespace {

struct W2VData {
  int64_t vocab = 0;
  int32_t dim = 0;
  std::vector<float> table;     // vocab * dim
  std::string words;            // '\0'-joined
  std::vector<int64_t> word_offsets;
};

}  // namespace

extern "C" {

void* w2v_load(const char* path, const char* filter_words) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char header[64];
  if (!fgets(header, sizeof(header), f)) { fclose(f); return nullptr; }
  long total = 0; int dim = 0;
  // dim cap: a malicious/corrupt header ("2 2000000000") would otherwise
  // drive a dim*4-byte transient allocation before the short-read check
  // ever runs; real w2v dims are <= 1024 (GoogleNews: 300).  Oversized
  // headers return null and the pure-Python loader reports the malformed
  // file.
  if (sscanf(header, "%ld %d", &total, &dim) != 2 || dim <= 0 ||
      dim > 100000 || total < 0) {
    fclose(f);
    return nullptr;
  }

  std::unordered_set<std::string> filter;
  bool use_filter = filter_words != nullptr && filter_words[0] != '\0';
  if (use_filter) {
    const char* p = filter_words;
    while (*p) {
      const char* nl = strchr(p, '\n');
      size_t len = nl ? (size_t)(nl - p) : strlen(p);
      if (len) filter.emplace(p, len);
      p += len + (nl ? 1 : 0);
    }
  }

  auto* d = new W2VData();
  d->dim = dim;
  std::vector<float> vec(dim);
  std::string word;
  for (long i = 0; i < total; ++i) {
    word.clear();
    int ch;
    while ((ch = fgetc(f)) != EOF && ch != ' ') {
      if (ch != '\n') word.push_back((char)ch);
    }
    if (ch == EOF) break;
    if (fread(vec.data(), sizeof(float), dim, f) != (size_t)dim) break;
    if (use_filter && !filter.count(word)) continue;
    d->word_offsets.push_back((int64_t)d->words.size());
    d->words.append(word);
    d->words.push_back('\0');
    d->table.insert(d->table.end(), vec.begin(), vec.end());
    ++d->vocab;
  }
  fclose(f);
  return d;
}

int64_t w2v_vocab(void* h) { return ((W2VData*)h)->vocab; }
int32_t w2v_dim(void* h) { return ((W2VData*)h)->dim; }
int64_t w2v_words_size(void* h) {
  return (int64_t)((W2VData*)h)->words.size();
}

void w2v_fill(void* h, float* table, char* words, int64_t* word_offsets) {
  auto* d = (W2VData*)h;
  copy_out(table, d->table.data(), d->table.size() * sizeof(float));
  copy_out(words, d->words.data(), d->words.size());
  copy_out(word_offsets, d->word_offsets.data(),
         d->word_offsets.size() * sizeof(int64_t));
}

void w2v_free(void* h) { delete (W2VData*)h; }

}  // extern "C"
