// Native host-side code for deepdfa_tpu_torch: the port's own copy of the
// reference's deepdfa_tpu/native/src/native.cpp, byte for byte below this
// header (the port imports nothing of the JAX package, its C++ included).
//
// Corpus-scale preprocessing primitives behind a plain C ABI consumed via
// ctypes (no pybind11): host code, no CUDA.
//
//   rd_solve   — bitset worklist reaching-definitions over a CFG
//   lex_c      — C tokenizer (mirrors frontend/tokens.py semantics)
//
// Build: python -m deepdfa_tpu_torch.native.build  (g++ -O2 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Reaching definitions.
//
// Inputs:
//   n_nodes, n_edges: CFG sizes (dense node ids 0..n_nodes-1)
//   src/dst[n_edges]: CFG edges
//   def_var[n_nodes]: variable id defined at the node, or -1
// Output:
//   out_in: n_nodes * n_words uint64 words; bit d of node n's row set iff
//           definition-site #d (dense index over nodes with def_var >= 0,
//           in node order) reaches the entry of n.
// Returns the number of definition sites (<= n_nodes), or -1 on overflow.
int64_t rd_solve(int32_t n_nodes, int64_t n_edges, const int32_t* src,
                 const int32_t* dst, const int32_t* def_var,
                 uint64_t* out_in) {
  if (n_nodes <= 0) return 0;

  // dense definition-site indexing
  std::vector<int32_t> def_site(n_nodes, -1);
  std::vector<int32_t> site_node;
  for (int32_t n = 0; n < n_nodes; ++n) {
    if (def_var[n] >= 0) {
      def_site[n] = static_cast<int32_t>(site_node.size());
      site_node.push_back(n);
    }
  }
  const int64_t n_sites = static_cast<int64_t>(site_node.size());
  const int64_t n_words = (n_sites + 63) / 64;
  if (n_words == 0) {
    return 0;  // no definitions: all IN sets empty, out untouched
  }

  // kill masks per variable: all sites defining that variable
  int32_t max_var = 0;
  for (int32_t n = 0; n < n_nodes; ++n)
    if (def_var[n] > max_var) max_var = def_var[n];
  std::vector<uint64_t> var_mask(static_cast<size_t>(max_var + 1) * n_words, 0);
  for (int64_t s = 0; s < n_sites; ++s) {
    const int32_t v = def_var[site_node[s]];
    var_mask[static_cast<size_t>(v) * n_words + s / 64] |= 1ull << (s % 64);
  }

  // CSR adjacency (successors + predecessors)
  std::vector<int64_t> succ_off(n_nodes + 1, 0), pred_off(n_nodes + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    ++succ_off[src[e] + 1];
    ++pred_off[dst[e] + 1];
  }
  for (int32_t n = 0; n < n_nodes; ++n) {
    succ_off[n + 1] += succ_off[n];
    pred_off[n + 1] += pred_off[n];
  }
  std::vector<int32_t> succ(n_edges), pred(n_edges);
  std::vector<int64_t> scur(succ_off.begin(), succ_off.end() - 1),
      pcur(pred_off.begin(), pred_off.end() - 1);
  for (int64_t e = 0; e < n_edges; ++e) {
    succ[scur[src[e]]++] = dst[e];
    pred[pcur[dst[e]]++] = src[e];
  }

  std::vector<uint64_t> out(static_cast<size_t>(n_nodes) * n_words, 0);
  std::memset(out_in, 0, sizeof(uint64_t) * n_nodes * n_words);

  // worklist to fixpoint
  std::vector<int32_t> work;
  std::vector<uint8_t> in_work(n_nodes, 1);
  work.reserve(n_nodes);
  for (int32_t n = n_nodes - 1; n >= 0; --n) work.push_back(n);

  std::vector<uint64_t> tmp(n_words);
  while (!work.empty()) {
    const int32_t n = work.back();
    work.pop_back();
    in_work[n] = 0;

    // IN = union of OUT(preds)
    std::fill(tmp.begin(), tmp.end(), 0);
    for (int64_t e = pred_off[n]; e < pred_off[n + 1]; ++e) {
      const uint64_t* po = &out[static_cast<size_t>(pred[e]) * n_words];
      for (int64_t w = 0; w < n_words; ++w) tmp[w] |= po[w];
    }
    std::memcpy(&out_in[static_cast<size_t>(n) * n_words], tmp.data(),
                sizeof(uint64_t) * n_words);

    // OUT = gen U (IN - kill)
    if (def_var[n] >= 0) {
      const uint64_t* kill =
          &var_mask[static_cast<size_t>(def_var[n]) * n_words];
      for (int64_t w = 0; w < n_words; ++w) tmp[w] &= ~kill[w];
      const int32_t s = def_site[n];
      tmp[s / 64] |= 1ull << (s % 64);
    }
    uint64_t* on = &out[static_cast<size_t>(n) * n_words];
    bool changed = false;
    for (int64_t w = 0; w < n_words; ++w) {
      if (on[w] != tmp[w]) {
        changed = true;
        break;
      }
    }
    if (changed) {
      std::memcpy(on, tmp.data(), sizeof(uint64_t) * n_words);
      for (int64_t e = succ_off[n]; e < succ_off[n + 1]; ++e) {
        const int32_t s = succ[e];
        if (!in_work[s]) {
          in_work[s] = 1;
          work.push_back(s);
        }
      }
    }
  }
  return n_sites;
}

// ---------------------------------------------------------------------------
// C tokenizer. Token kinds mirror frontend/tokens.py.
enum TokKind : int32_t {
  TOK_ID = 0,
  TOK_KW = 1,
  TOK_NUM = 2,
  TOK_STR = 3,
  TOK_CHAR = 4,
  TOK_OP = 5,
};

static bool is_ident_start(char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || c == '_';
}
static bool is_ident(char c) {
  return is_ident_start(c) || (c >= '0' && c <= '9');
}
static bool is_digit(char c) { return c >= '0' && c <= '9'; }
static bool is_hex(char c) {
  return is_digit(c) || (c >= 'a' && c <= 'f') || (c >= 'A' && c <= 'F');
}

static const char* kKeywords[] = {
    "auto", "break", "case", "char", "const", "continue", "default", "do",
    "double", "else", "enum", "extern", "float", "for", "goto", "if",
    "inline", "int", "long", "register", "restrict", "return", "short",
    "signed", "sizeof", "static", "struct", "switch", "typedef", "union",
    "unsigned", "void", "volatile", "while", "_Bool", "bool", nullptr};

static bool is_keyword(const char* s, int64_t len) {
  for (int k = 0; kKeywords[k]; ++k) {
    if (static_cast<int64_t>(std::strlen(kKeywords[k])) == len &&
        std::strncmp(kKeywords[k], s, len) == 0)
      return true;
  }
  return false;
}

// three-char then two-char then one-char operators (maximal munch)
static const char* kOps3[] = {"<<=", ">>=", "...", nullptr};
static const char* kOps2[] = {"::", "->", "++", "--", "<<", ">>", "<=", ">=",
                              "==", "!=", "&&", "||", "+=", "-=", "*=",
                              "/=", "%=", "&=", "^=", "|=", nullptr};
static const char kOps1[] = "+-*/%=<>!~&|^?:.,;()[]{}";

// Tokenize `code[0..len)`. Writes up to max_tokens entries of
// (kind, start, end, line) into the parallel output arrays.
// Returns the token count (excluding EOF), or -1 if max_tokens exceeded.
int64_t lex_c(const char* code, int64_t len, int64_t max_tokens,
              int32_t* kinds, int64_t* starts, int64_t* ends,
              int32_t* lines) {
  int64_t i = 0, count = 0;
  int32_t line = 1;

  auto emit = [&](int32_t kind, int64_t s, int64_t e, int32_t l) -> bool {
    if (count >= max_tokens) return false;
    kinds[count] = kind;
    starts[count] = s;
    ends[count] = e;
    lines[count] = l;
    ++count;
    return true;
  };

  while (i < len) {
    const char c = code[i];
    if (c == '\n') {
      ++line;
      ++i;
      continue;
    }
    if (c == ' ' || c == '\t' || c == '\r' || c == '\f' || c == '\v') {
      ++i;
      continue;
    }
    // comments
    if (c == '/' && i + 1 < len && code[i + 1] == '/') {
      while (i < len && code[i] != '\n') ++i;
      continue;
    }
    if (c == '/' && i + 1 < len && code[i + 1] == '*') {
      i += 2;
      while (i + 1 < len && !(code[i] == '*' && code[i + 1] == '/')) {
        if (code[i] == '\n') ++line;
        ++i;
      }
      i = (i + 1 < len) ? i + 2 : len;
      continue;
    }
    // preprocessor: skip continued line. The Python spec strips comments
    // BEFORE seeing the '#', so a /* ... */ opening on the directive line
    // swallows its newlines and the skip must too.
    if (c == '#') {
      while (i < len && code[i] != '\n') {
        if (code[i] == '\\' && i + 1 < len && code[i + 1] == '\n') {
          i += 2;
          ++line;
        } else if (code[i] == '/' && i + 1 < len && code[i + 1] == '*') {
          // comment inside the directive: if it spans a newline, the
          // directive ends there (python strips comments first, so the
          // first newline inside the comment terminates the # line)
          bool had_newline = false;
          i += 2;
          while (i + 1 < len && !(code[i] == '*' && code[i + 1] == '/')) {
            if (code[i] == '\n') {
              ++line;
              had_newline = true;
            }
            ++i;
          }
          i = (i + 1 < len) ? i + 2 : len;
          if (had_newline) break;
        } else if (code[i] == '/' && i + 1 < len && code[i + 1] == '/') {
          break;  // line comment ends the directive at the newline
        } else {
          ++i;
        }
      }
      continue;
    }
    const int64_t start = i;
    const int32_t tline = line;
    if (is_ident_start(c)) {
      while (i < len && is_ident(code[i])) ++i;
      if (!emit(is_keyword(code + start, i - start) ? TOK_KW : TOK_ID, start,
                i, tline))
        return -1;
      continue;
    }
    if (is_digit(c) || (c == '.' && i + 1 < len && is_digit(code[i + 1]))) {
      if (c == '0' && i + 1 < len && (code[i + 1] == 'x' || code[i + 1] == 'X')) {
        i += 2;
        while (i < len && is_hex(code[i])) ++i;
      } else {
        while (i < len && (is_digit(code[i]) || code[i] == '.')) ++i;
        if (i < len && (code[i] == 'e' || code[i] == 'E')) {
          int64_t j = i + 1;
          if (j < len && (code[j] == '+' || code[j] == '-')) ++j;
          if (j < len && is_digit(code[j])) {
            i = j;
            while (i < len && is_digit(code[i])) ++i;
          }
        }
      }
      while (i < len && (code[i] == 'u' || code[i] == 'U' || code[i] == 'l' ||
                         code[i] == 'L' || code[i] == 'f' || code[i] == 'F'))
        ++i;
      if (!emit(TOK_NUM, start, i, tline)) return -1;
      continue;
    }
    if (c == '"' || c == '\'') {
      ++i;
      while (i < len && code[i] != c) {
        if (code[i] == '\\') ++i;
        if (i < len && code[i] == '\n') ++line;
        if (i < len) ++i;
      }
      if (i < len) ++i;  // closing quote
      if (!emit(c == '"' ? TOK_STR : TOK_CHAR, start, i, tline)) return -1;
      continue;
    }
    // operators: maximal munch
    bool matched = false;
    if (i + 3 <= len) {
      for (int k = 0; kOps3[k]; ++k) {
        if (std::strncmp(code + i, kOps3[k], 3) == 0) {
          if (!emit(TOK_OP, i, i + 3, tline)) return -1;
          i += 3;
          matched = true;
          break;
        }
      }
    }
    if (matched) continue;
    if (i + 2 <= len) {
      for (int k = 0; kOps2[k]; ++k) {
        if (std::strncmp(code + i, kOps2[k], 2) == 0) {
          if (!emit(TOK_OP, i, i + 2, tline)) return -1;
          i += 2;
          matched = true;
          break;
        }
      }
    }
    if (matched) continue;
    if (std::strchr(kOps1, c) != nullptr) {
      if (!emit(TOK_OP, i, i + 1, tline)) return -1;
      ++i;
      continue;
    }
    ++i;  // unknown byte: skip (robustness, same as python lexer)
  }
  return count;
}

}  // extern "C"
