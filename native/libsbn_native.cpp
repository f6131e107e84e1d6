// Native host-side core for libsbn_tpu: newick/nexus parsing and traversal
// schedule construction.
//
// This replaces the reference's bison/flex parser + Node machinery
// (/root/reference/src/driver.cpp, parser.yy, node.cpp) for the hot host
// paths: parsing large MCMC tree files and lowering sampled topologies to
// the dense index schedules the device kernels consume. Semantics mirror the
// Python implementation in libsbn_tpu/io/newick.py and ops/schedule.py:
//
//   * taxa are numbered by order of appearance in the first tree, or by
//     nexus translate-block order;
//   * children are sorted by max leaf id (canonicalization, node.cpp);
//   * leaves take their taxon number as node id; internal nodes are numbered
//     in postorder after sorting, root last;
//   * quoted labels and BEAST [&...] metadata comments are handled;
//   * schedules: postorder combine steps padded to 3 children with the ones
//     slot, preorder upper-partial steps, parent vectors, internal preorder.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <memory>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ParseNode {
  std::vector<int> children;  // indices into the node arena
  int leaf_id = -1;
  int max_leaf = -1;
  double bl = 0.0;
  int id = -1;  // assigned by polish
};

struct TreeArena {
  std::vector<ParseNode> nodes;
  int root = -1;
};

struct Parser {
  std::unordered_map<std::string, int> taxa;
  std::vector<std::string> taxa_order;
  bool taxa_complete = false;
  std::string error;

  // -- tokenizer over one line ------------------------------------------
  const char* p = nullptr;
  const char* end = nullptr;

  void skip_ws() {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) p++;
  }

  // Skip [&...] metadata comments (possibly several).
  void skip_comments() {
    skip_ws();
    while (p + 1 < end && p[0] == '[' && p[1] == '&') {
      while (p < end && *p != ']') p++;
      if (p < end) p++;  // ']'
      skip_ws();
    }
  }

  bool parse_label(std::string* out) {
    skip_ws();
    if (p >= end) return false;
    if (*p == '\'' || *p == '"') {
      const char delim = *p;
      std::string s(1, delim);
      p++;
      while (p < end) {
        if (*p == '\\' && p + 1 < end) {
          s += *p;
          s += *(p + 1);
          p += 2;
        } else if (*p == delim) {
          s += delim;
          p++;
          break;
        } else {
          s += *p;
          p++;
        }
      }
      *out = s;
      return true;
    }
    std::string s;
    while (p < end && !std::isspace(static_cast<unsigned char>(*p)) &&
           std::strchr("()[],:;", *p) == nullptr) {
      s += *p;
      p++;
    }
    if (s.empty()) return false;
    *out = s;
    return true;
  }

  int parse_fancy_node(TreeArena* arena) {
    int node = parse_node(arena);
    if (node < 0) return -1;
    skip_comments();
    if (p < end && *p == ':') {
      p++;
      skip_comments();
      char* next = nullptr;
      std::string num;
      skip_ws();
      while (p < end && !std::isspace(static_cast<unsigned char>(*p)) &&
             std::strchr("()[],:;", *p) == nullptr) {
        num += *p;
        p++;
      }
      const double bl = std::strtod(num.c_str(), &next);
      if (num.empty() || next == num.c_str()) {
        error = "Float conversion failed on branch length '" + num + "'";
        return -1;
      }
      arena->nodes[node].bl = bl;
    }
    return node;
  }

  int parse_node(TreeArena* arena) {
    skip_ws();
    if (p < end && *p == '(') {
      p++;
      std::vector<int> children;
      while (true) {
        const int child = parse_fancy_node(arena);
        if (child < 0) return -1;
        children.push_back(child);
        skip_ws();
        if (p < end && *p == ',') {
          p++;
          continue;
        }
        break;
      }
      skip_ws();
      if (p >= end || *p != ')') {
        error = "Expected ')' in newick string";
        return -1;
      }
      p++;
      // Optional internal label (support value) — ignore.
      skip_comments();
      if (p < end && std::strchr("()[],:;", *p) == nullptr &&
          !std::isspace(static_cast<unsigned char>(*p))) {
        std::string ignored;
        parse_label(&ignored);
      }
      // Canonicalize: sort children by max leaf id.
      std::sort(children.begin(), children.end(),
                [arena](int a, int b) {
                  return arena->nodes[a].max_leaf < arena->nodes[b].max_leaf;
                });
      for (size_t i = 1; i < children.size(); ++i) {
        if (arena->nodes[children[i - 1]].max_leaf ==
            arena->nodes[children[i]].max_leaf) {
          error = "Tie in max leaf ids; repeated taxon?";
          return -1;
        }
      }
      ParseNode n;
      n.children = std::move(children);
      n.max_leaf = arena->nodes[n.children.back()].max_leaf;
      arena->nodes.push_back(std::move(n));
      return static_cast<int>(arena->nodes.size()) - 1;
    }
    // Leaf.
    std::string name;
    if (!parse_label(&name)) {
      error = "Expected label in newick string";
      return -1;
    }
    skip_comments();
    int leaf_id;
    if (!taxa_complete) {
      auto it = taxa.find(name);
      if (it == taxa.end()) {
        leaf_id = static_cast<int>(taxa.size());
        taxa.emplace(name, leaf_id);
        taxa_order.push_back(name);
      } else {
        leaf_id = it->second;
      }
    } else {
      auto it = taxa.find(name);
      if (it == taxa.end()) {
        error = "Taxon '" + name + "' is not known in our taxon set.";
        return -1;
      }
      leaf_id = it->second;
    }
    ParseNode n;
    n.leaf_id = leaf_id;
    n.max_leaf = leaf_id;
    arena->nodes.push_back(std::move(n));
    return static_cast<int>(arena->nodes.size()) - 1;
  }

  bool parse_tree(const std::string& line, TreeArena* arena) {
    p = line.data();
    end = line.data() + line.size();
    arena->nodes.clear();
    arena->root = parse_fancy_node(arena);
    if (arena->root < 0) return false;
    skip_ws();
    if (p >= end || *p != ';') {
      error = "Expected ';' at end of newick string";
      return false;
    }
    taxa_complete = true;
    return true;
  }
};

// Polish: assign ids (leaves by taxon number, internals postorder) and emit
// parent vector + branch lengths by id.
void PolishAndEmit(TreeArena* arena, int n_taxa, std::vector<int32_t>* parents,
                   std::vector<double>* bls) {
  int next_id = n_taxa;
  // Iterative postorder id assignment.
  std::vector<std::pair<int, bool>> stack;
  stack.push_back({arena->root, false});
  while (!stack.empty()) {
    auto [idx, expanded] = stack.back();
    stack.pop_back();
    ParseNode& node = arena->nodes[idx];
    if (expanded || node.children.empty()) {
      node.id = node.children.empty() ? node.leaf_id : next_id++;
    } else {
      stack.push_back({idx, true});
      for (auto it = node.children.rbegin(); it != node.children.rend(); ++it) {
        stack.push_back({*it, false});
      }
    }
  }
  const int n_nodes = next_id;
  parents->assign(n_nodes - 1, -1);
  bls->assign(n_nodes, 0.0);
  for (const auto& node : arena->nodes) {
    // Nodes not reachable from the root (e.g. orphaned by the sampler's
    // deroot) keep id == -1 and are skipped.
    if (node.id < 0) continue;
    (*bls)[node.id] = node.bl;
    for (const int child : node.children) {
      (*parents)[arena->nodes[child].id] = node.id;
    }
  }
}

std::string Dequote(const std::string& s) {
  if (s.empty() || (s[0] != '\'' && s[0] != '"')) return s;
  const char delim = s[0];
  std::string out;
  size_t i = 1;
  while (i < s.size()) {
    if (s[i] == '\\' && i + 1 < s.size()) {
      out += s[i + 1];
      i += 2;
    } else if (s[i] == delim) {
      break;
    } else {
      out += s[i];
      i++;
    }
  }
  return out;
}

std::string ToLower(std::string s) {
  std::transform(s.begin(), s.end(), s.begin(),
                 [](unsigned char c) { return std::tolower(c); });
  return s;
}

}  // namespace

extern "C" {

struct LsbnParseResult {
  int32_t n_trees = 0;
  int32_t n_taxa = 0;
  int32_t n_nodes = 0;  // nodes per tree (uniform; 0 on error)
  int32_t* parent_vectors = nullptr;  // (n_trees, n_nodes - 1)
  double* branch_lengths = nullptr;   // (n_trees, n_nodes)
  char* taxon_names = nullptr;        // '\n'-joined, dequoted
  char* error = nullptr;              // non-null on failure
};

static LsbnParseResult* MakeError(const std::string& message) {
  auto* r = new LsbnParseResult();
  r->error = strdup(message.c_str());
  return r;
}

static LsbnParseResult* FinishParse(
    Parser& parser, const std::vector<std::vector<int32_t>>& parent_rows,
    const std::vector<std::vector<double>>& bl_rows,
    const std::vector<std::string>& names) {
  if (!parser.error.empty()) return MakeError(parser.error);
  if (parent_rows.empty()) return MakeError("No trees found");
  const size_t n_nodes = bl_rows[0].size();
  for (const auto& row : bl_rows) {
    if (row.size() != n_nodes) {
      return MakeError("Trees have differing node counts");
    }
  }
  auto* r = new LsbnParseResult();
  r->n_trees = static_cast<int32_t>(parent_rows.size());
  r->n_taxa = static_cast<int32_t>(names.size());
  r->n_nodes = static_cast<int32_t>(n_nodes);
  r->parent_vectors = static_cast<int32_t*>(
      std::malloc(sizeof(int32_t) * r->n_trees * (n_nodes - 1)));
  r->branch_lengths =
      static_cast<double*>(std::malloc(sizeof(double) * r->n_trees * n_nodes));
  for (int t = 0; t < r->n_trees; ++t) {
    std::memcpy(r->parent_vectors + t * (n_nodes - 1), parent_rows[t].data(),
                sizeof(int32_t) * (n_nodes - 1));
    std::memcpy(r->branch_lengths + t * n_nodes, bl_rows[t].data(),
                sizeof(double) * n_nodes);
  }
  std::string joined;
  for (size_t i = 0; i < names.size(); ++i) {
    if (i) joined += '\n';
    joined += Dequote(names[i]);
  }
  r->taxon_names = strdup(joined.c_str());
  return r;
}

LsbnParseResult* lsbn_parse_newick_file(const char* path) {
  std::ifstream in(path);
  if (!in) return MakeError(std::string("Cannot open the File : ") + path);
  Parser parser;
  std::vector<std::vector<int32_t>> parent_rows;
  std::vector<std::vector<double>> bl_rows;
  std::string line;
  TreeArena arena;
  while (std::getline(in, line)) {
    const auto start = line.find('(');
    if (start == std::string::npos) continue;
    line.erase(0, start);
    if (!parser.parse_tree(line, &arena)) return MakeError(parser.error);
    std::vector<int32_t> parents;
    std::vector<double> bls;
    PolishAndEmit(&arena, static_cast<int>(parser.taxa.size()), &parents, &bls);
    parent_rows.push_back(std::move(parents));
    bl_rows.push_back(std::move(bls));
  }
  return FinishParse(parser, parent_rows, bl_rows, parser.taxa_order);
}

LsbnParseResult* lsbn_parse_nexus_file(const char* path) {
  std::ifstream in(path);
  if (!in) return MakeError(std::string("Cannot open the File : ") + path);
  std::string line;
  if (!std::getline(in, line) || line.rfind("#NEXUS", 0) != 0) {
    return MakeError("Putative Nexus file doesn't begin with #NEXUS.");
  }
  // Find 'begin trees;'.
  bool found = false;
  while (std::getline(in, line)) {
    if (ToLower(line).find("begin trees;") != std::string::npos) {
      found = true;
      break;
    }
  }
  if (!found) return MakeError("Couldn't find 'begin trees;'");
  if (!std::getline(in, line)) return MakeError("EOF after begin trees");
  {
    std::string lower = ToLower(line);
    size_t pos = lower.find_first_not_of(" \t");
    if (pos == std::string::npos || lower.compare(pos, 9, "translate") != 0) {
      return MakeError("Missing translate block.");
    }
  }
  Parser parser;
  std::vector<std::string> long_names;
  // Parse translate items: "<short> <long>[,;]". A line that does not fit
  // this shape (e.g. the first tree when the block has no lone semicolon)
  // ends the block WITHOUT being consumed, mirroring io/newick.py.
  bool done_translate = false;
  std::string pending_line;
  bool have_pending = false;
  while (!done_translate && std::getline(in, line)) {
    // A translate item's long name may not contain ',' or ';' internally.
    std::istringstream ss(line);
    std::string short_name, rest;
    if (!(ss >> short_name)) break;
    std::getline(ss, rest);
    size_t b = rest.find_first_not_of(" \t");
    if (b == std::string::npos) rest.clear(); else rest = rest.substr(b);
    size_t e = rest.find_last_not_of(" \t\r");
    if (e != std::string::npos) rest = rest.substr(0, e + 1);
    if (short_name == ";") break;
    bool ends_with_semi = !rest.empty() && rest.back() == ';';
    bool ends_with_comma = !rest.empty() && rest.back() == ',';
    std::string body = rest;
    if (ends_with_semi || ends_with_comma) body.pop_back();
    const bool valid_item =
        short_name.find('(') == std::string::npos &&
        body.find(',') == std::string::npos &&
        body.find(';') == std::string::npos;
    if (!valid_item) {
      pending_line = line;
      have_pending = true;
      break;
    }
    const int leaf_id = static_cast<int>(parser.taxa.size());
    parser.taxa.emplace(short_name, leaf_id);
    long_names.push_back(body);
    if (ends_with_semi) done_translate = true;
  }
  if (parser.taxa.empty()) return MakeError("No taxa found in translate block!");
  parser.taxa_complete = true;
  std::vector<std::vector<int32_t>> parent_rows;
  std::vector<std::vector<double>> bl_rows;
  TreeArena arena;
  auto process_line = [&](std::string tree_line) -> bool {
    const auto start = tree_line.find('(');
    if (start == std::string::npos) return true;
    tree_line.erase(0, start);
    if (!parser.parse_tree(tree_line, &arena)) return false;
    std::vector<int32_t> parents;
    std::vector<double> bls;
    PolishAndEmit(&arena, static_cast<int>(parser.taxa.size()), &parents, &bls);
    parent_rows.push_back(std::move(parents));
    bl_rows.push_back(std::move(bls));
    return true;
  };
  if (have_pending && !process_line(pending_line)) return MakeError(parser.error);
  while (std::getline(in, line)) {
    if (!process_line(line)) return MakeError(parser.error);
  }
  return FinishParse(parser, parent_rows, bl_rows, long_names);
}

void lsbn_free_result(LsbnParseResult* r) {
  if (!r) return;
  std::free(r->parent_vectors);
  std::free(r->branch_lengths);
  std::free(r->taxon_names);
  std::free(r->error);
  delete r;
}

// -- schedule construction --------------------------------------------------
// Build the dense pruning schedules for a batch of same-shape trees directly
// from parent-id vectors (see ops/schedule.py for the layout contract).
// Output arrays are caller-allocated:
//   post_node      (n_trees, n_internal)
//   post_children  (n_trees, n_internal, 3)    padded with ones_slot = n_nodes
//   up_node        (n_trees, n_nodes - 1)
//   up_parent      (n_trees, n_nodes - 1)
//   up_sibs        (n_trees, n_nodes - 1, 2)   padded with ones_slot
// Returns 0 on success, nonzero on shape error.
int32_t lsbn_build_schedules(const int32_t* parent_vectors, int32_t n_trees,
                             int32_t n_nodes, int32_t n_leaves,
                             int32_t* post_node, int32_t* post_children,
                             int32_t* up_node, int32_t* up_parent,
                             int32_t* up_sibs) {
  const int32_t n_internal = n_nodes - n_leaves;
  const int32_t ones = n_nodes;
  std::vector<std::vector<int32_t>> children(n_nodes);
  std::vector<int32_t> order;
  order.reserve(n_nodes);
  for (int t = 0; t < n_trees; ++t) {
    const int32_t* pv = parent_vectors + t * (n_nodes - 1);
    for (auto& c : children) c.clear();
    for (int32_t i = 0; i < n_nodes - 1; ++i) {
      if (pv[i] < 0 || pv[i] >= n_nodes) return 1;
      children[pv[i]].push_back(i);
    }
    // Children arrive in ascending node-id order, which for polished trees
    // is NOT always the canonical order; but the canonical order is by max
    // leaf id, and for polished trees child ids are assigned postorder so
    // the subtree with smaller max leaf id is visited first and gets the
    // smaller internal id; leaves use taxon ids. Sorting by max-leaf is
    // still required when an internal id exceeds a sibling leaf id. Compute
    // max-leaf per node to sort exactly as the Python lowering does.
    std::vector<int32_t> max_leaf(n_nodes, -1);
    // Iterative postorder over node n_nodes-1.
    std::vector<std::pair<int32_t, bool>> stack;
    order.clear();
    stack.push_back({n_nodes - 1, false});
    while (!stack.empty()) {
      auto [node, expanded] = stack.back();
      stack.pop_back();
      if (expanded || children[node].empty()) {
        if (children[node].empty()) {
          max_leaf[node] = node;  // leaves have ids < n_leaves
        } else {
          int32_t m = -1;
          for (int32_t c : children[node]) m = std::max(m, max_leaf[c]);
          max_leaf[node] = m;
        }
        order.push_back(node);
      } else {
        stack.push_back({node, true});
        for (auto it = children[node].rbegin(); it != children[node].rend();
             ++it) {
          stack.push_back({*it, false});
        }
      }
    }
    // Sort each node's children canonically.
    for (auto& c : children) {
      std::sort(c.begin(), c.end(), [&max_leaf](int32_t a, int32_t b) {
        return max_leaf[a] < max_leaf[b];
      });
    }
    // Postorder steps over internal nodes (order already postorder).
    int32_t step = 0;
    for (const int32_t node : order) {
      if (children[node].empty()) continue;
      if (children[node].size() > 3) return 2;
      post_node[t * n_internal + step] = node;
      for (int k = 0; k < 3; ++k) {
        post_children[(t * n_internal + step) * 3 + k] =
            k < static_cast<int>(children[node].size())
                ? children[node][k]
                : ones;
      }
      step++;
    }
    if (step != n_internal) return 3;
    // Preorder upper-partial steps.
    int32_t up = 0;
    for (auto it = order.rbegin(); it != order.rend(); ++it) {
      const int32_t node = *it;
      if (children[node].empty()) continue;
      for (const int32_t c : children[node]) {
        up_node[t * (n_nodes - 1) + up] = c;
        up_parent[t * (n_nodes - 1) + up] = node;
        int k = 0;
        for (const int32_t s : children[node]) {
          if (s != c) {
            up_sibs[(t * (n_nodes - 1) + up) * 2 + k] = s;
            k++;
          }
        }
        for (; k < 2; ++k) up_sibs[(t * (n_nodes - 1) + up) * 2 + k] = ones;
        up++;
      }
    }
    if (up != n_nodes - 1) return 4;
  }
  return 0;
}

}  // extern "C"

// -- SBN indexer representations --------------------------------------------
// Digest unrooted topologies (canonical parent-id vectors) into dense
// indexer representations: one rooted representation [rootsplit idx, PCSP
// idxs...] per virtual rooting (sbn_maps.cpp UnrootedSBNMaps::
// IndexerRepresentationOf + node.cpp UnrootedPCSPPreorder; Python port in
// sbn/maps.py unrooted_indexer_representation_of). Bitset keys are packed
// big-endian (taxon 0 = bit 63 of word 0) so lexicographic uint64-word
// comparison matches the Python Bitset's string-order comparison.

namespace {

struct Clades {
  int n_taxa = 0;
  int W = 0;  // words per clade
  std::vector<uint64_t> data;  // node-major, W words per node

  uint64_t* of(int node) { return data.data() + static_cast<size_t>(node) * W; }
  const uint64_t* of(int node) const {
    return data.data() + static_cast<size_t>(node) * W;
  }
  uint64_t mask(int w) const {
    const int used = std::min(64, n_taxa - 64 * w);
    return used == 64 ? ~0ull : (~0ull << (64 - used));
  }
};

struct NativeIndexer {
  int n_taxa = 0;
  int W = 0;
  std::unordered_map<std::string, int32_t> splits;  // W-word keys
  std::unordered_map<std::string, int32_t> pcsps;   // 3W-word keys
};

inline std::string KeyOf(const uint64_t* words, int count) {
  return std::string(reinterpret_cast<const char*>(words),
                     sizeof(uint64_t) * count);
}

// Lexicographic (string-order) comparison of two W-word clades.
inline bool CladeLess(const uint64_t* a, const uint64_t* b, int W) {
  for (int w = 0; w < W; ++w) {
    if (a[w] != b[w]) return a[w] < b[w];
  }
  return false;
}

struct RepBuilder {
  const NativeIndexer* ix;
  const Clades* clades;
  int root_id;
  int32_t default_index;
  int R;  // entries per rooted representation (n_taxa - 1)
  const std::vector<std::vector<int>>* children;
  int32_t* out;            // (E, R) for the current tree
  std::vector<int> fill;   // next write slot per row
  bool ok = true;

  void leaves_of(int node, bool flip, uint64_t* dst) const {
    const uint64_t* src = clades->of(node);
    for (int w = 0; w < clades->W; ++w) {
      dst[w] = flip ? (~src[w] & clades->mask(w)) : src[w];
    }
  }

  void append(int row, int32_t position) {
    if (fill[row] >= R) {
      ok = false;
      return;
    }
    out[static_cast<size_t>(row) * R + fill[row]++] = position;
  }

  // The 8-argument PCSP visitor of unrooted_pcsp_preorder.
  void visit(int sister, bool sd, int focal, bool fd, int child0, bool c0d,
             int child1, bool c1d, int virtual_root_clade) {
    const int W = clades->W;
    std::vector<uint64_t> key(3 * W);
    leaves_of(sister, sd, key.data());
    leaves_of(focal, fd, key.data() + W);
    std::vector<uint64_t> c0(W), c1(W);
    leaves_of(child0, c0d, c0.data());
    leaves_of(child1, c1d, c1.data());
    const uint64_t* mn = CladeLess(c0.data(), c1.data(), W) ? c0.data()
                                                            : c1.data();
    std::copy(mn, mn + W, key.data() + 2 * W);
    auto it = ix->pcsps.find(KeyOf(key.data(), 3 * W));
    const int32_t position =
        it == ix->pcsps.end() ? default_index : it->second;
    if (sister == focal) {
      append(focal, position);
      return;
    }
    // Every rooting inside the virtual root clade except the sister/focal
    // clades and the root realizes this PCSP.
    std::vector<int> stack{virtual_root_clade};
    while (!stack.empty()) {
      const int node = stack.back();
      stack.pop_back();
      if (node == sister || node == focal) continue;
      if (node != root_id) append(node, position);
      for (const int c : (*children)[node]) stack.push_back(c);
    }
  }

  void f_root(int node0, int node1, int node2) {
    visit(node2, false, node2, true, node0, false, node1, false, -1);
    const auto& kids = (*children)[node2];
    if (!kids.empty()) {
      visit(node0, false, node2, false, kids[0], false, kids[1], false, node1);
      visit(node1, false, node2, false, kids[0], false, kids[1], false, node0);
      visit(node2, true, node2, false, kids[0], false, kids[1], false, -1);
      visit(kids[1], false, node2, true, node0, false, node1, false, kids[0]);
      visit(kids[0], false, node2, true, node0, false, node1, false, kids[1]);
    }
  }

  void f_internal(int node, int sister, int parent) {
    visit(node, false, node, true, parent, true, sister, false, -1);
    const auto& kids = (*children)[node];
    if (!kids.empty()) {
      visit(sister, false, node, false, kids[0], false, kids[1], false,
            root_id);
      visit(parent, true, node, false, kids[0], false, kids[1], false, sister);
      visit(node, true, node, false, kids[0], false, kids[1], false, -1);
      visit(kids[1], false, node, true, sister, false, parent, true, kids[0]);
      visit(kids[0], false, node, true, sister, false, parent, true, kids[1]);
    }
  }

  void recur(int node, int sister, int parent) {
    f_internal(node, sister, parent);
    const auto& kids = (*children)[node];
    if (!kids.empty()) {
      recur(kids[0], kids[1], node);
      recur(kids[1], kids[0], node);
    }
  }

  void run() {
    const auto& rc = (*children)[root_id];
    if (rc.size() != 3) {
      ok = false;
      return;
    }
    for (int i = 0; i < 3; ++i) {
      const int n = rc[i], s = rc[(i + 1) % 3], p = rc[(i + 2) % 3];
      f_root(n, s, p);
      const auto& kids = (*children)[n];
      if (!kids.empty()) {
        recur(kids[0], kids[1], n);
        recur(kids[1], kids[0], n);
      }
    }
  }
};

}  // namespace

extern "C" {

void* lsbn_indexer_create(const uint64_t* split_keys,
                          const int32_t* split_vals, int32_t n_splits,
                          const uint64_t* pcsp_keys, const int32_t* pcsp_vals,
                          int32_t n_pcsps, int32_t n_taxa) {
  auto* ix = new NativeIndexer();
  ix->n_taxa = n_taxa;
  ix->W = (n_taxa + 63) / 64;
  ix->splits.reserve(n_splits * 2);
  ix->pcsps.reserve(n_pcsps * 2);
  for (int32_t i = 0; i < n_splits; ++i) {
    ix->splits.emplace(KeyOf(split_keys + static_cast<size_t>(i) * ix->W, ix->W),
                       split_vals[i]);
  }
  for (int32_t i = 0; i < n_pcsps; ++i) {
    ix->pcsps.emplace(
        KeyOf(pcsp_keys + static_cast<size_t>(i) * 3 * ix->W, 3 * ix->W),
        pcsp_vals[i]);
  }
  return ix;
}

void lsbn_indexer_free(void* handle) {
  delete static_cast<NativeIndexer*>(handle);
}

// Unrooted indexer representations for a batch of canonical parent-id
// vectors. out is caller-allocated (n_trees, E, R) with E = n_nodes - 1 and
// R = n_taxa - 1. Returns 0 on success.
int32_t lsbn_indexer_representations(void* handle,
                                     const int32_t* parent_vectors,
                                     int32_t n_trees, int32_t n_nodes,
                                     int32_t default_index, int32_t* out) {
  auto* ix = static_cast<NativeIndexer*>(handle);
  const int n_taxa = ix->n_taxa;
  const int W = ix->W;
  const int E = n_nodes - 1;
  const int R = n_taxa - 1;
  const int root_id = n_nodes - 1;

  std::vector<std::vector<int>> children(n_nodes);
  Clades clades;
  clades.n_taxa = n_taxa;
  clades.W = W;
  clades.data.assign(static_cast<size_t>(n_nodes) * W, 0);

  for (int t = 0; t < n_trees; ++t) {
    const int32_t* pv = parent_vectors + static_cast<size_t>(t) * E;
    for (auto& c : children) c.clear();
    for (int i = 0; i < E; ++i) {
      if (pv[i] < 0 || pv[i] >= n_nodes) return 1;
      children[pv[i]].push_back(i);
    }
    // Clades bottom-up: ids are canonical (leaves 0..n_taxa-1, internals
    // postorder), so ascending id order is a valid postorder.
    std::fill(clades.data.begin(), clades.data.end(), 0);
    for (int node = 0; node < n_nodes; ++node) {
      uint64_t* dst = clades.of(node);
      if (children[node].empty()) {
        if (node >= n_taxa) return 2;
        dst[node / 64] |= 1ull << (63 - node % 64);
      } else {
        for (const int c : children[node]) {
          if (c >= node) return 3;
          const uint64_t* src = clades.of(c);
          for (int w = 0; w < W; ++w) dst[w] |= src[w];
        }
      }
    }
    // Canonical child order (by max leaf id): children of polished trees
    // arrive in ascending id order, which is postorder-consistent, but the
    // canonical order is by max leaf — recompute as the schedule builder
    // does.
    std::vector<int32_t> max_leaf(n_nodes, -1);
    for (int node = 0; node < n_nodes; ++node) {
      if (children[node].empty()) {
        max_leaf[node] = node;
      } else {
        int32_t m = -1;
        for (const int c : children[node]) m = std::max(m, max_leaf[c]);
        max_leaf[node] = m;
      }
    }
    for (auto& c : children) {
      std::sort(c.begin(), c.end(), [&max_leaf](int a, int b) {
        return max_leaf[a] < max_leaf[b];
      });
    }

    int32_t* tree_out = out + static_cast<size_t>(t) * E * R;
    RepBuilder rb;
    rb.ix = ix;
    rb.clades = &clades;
    rb.root_id = root_id;
    rb.default_index = default_index;
    rb.R = R;
    rb.children = &children;
    rb.out = tree_out;
    rb.fill.assign(E, 0);
    // Slot 0 of every row: the (minorized) split below that node.
    std::vector<uint64_t> minor(W);
    for (int node = 0; node < E; ++node) {
      const uint64_t* leaves = clades.of(node);
      std::vector<uint64_t> comp(W);
      for (int w = 0; w < W; ++w) comp[w] = ~leaves[w] & clades.mask(w);
      const uint64_t* mn =
          CladeLess(leaves, comp.data(), W) ? leaves : comp.data();
      std::copy(mn, mn + W, minor.begin());
      auto it = ix->splits.find(KeyOf(minor.data(), W));
      rb.append(node, it == ix->splits.end() ? default_index : it->second);
    }
    rb.run();
    if (!rb.ok) return 4;
    for (int row = 0; row < E; ++row) {
      if (rb.fill[row] != R) return 5;
    }
  }
  return 0;
}

// -- PSP representations -----------------------------------------------------
// Primary-subsplit-pair branch representations (psp_indexer.cpp
// RepresentationOf; Python port sbn/support.py PSPIndexer.representation_of):
// per tree, three rows indexed by node id — rootsplit / subsplit-down /
// subsplit-up PSP indices, sentinel where absent. Keys: rootsplit = the
// minorized clade below the node (W words); subsplit = focal clade + the
// lexicographically smaller of the two child clades (2W words). Values are
// traversal-order independent, so a simple recursion over canonical
// parent-id vectors suffices.

namespace {

struct NativePSP {
  int n_taxa = 0;
  int W = 0;
  std::unordered_map<std::string, int32_t> splits;     // W-word keys
  std::unordered_map<std::string, int32_t> subsplits;  // 2W-word keys
};

struct PSPBuilder {
  const NativePSP* ix;
  const Clades* clades;
  const std::vector<std::vector<int>>* children;
  int32_t sentinel;
  int E;
  int32_t* root_row;  // each (E,)
  int32_t* down_row;
  int32_t* up_row;

  void clade_of(int node, bool flip, uint64_t* dst) const {
    const uint64_t* src = clades->of(node);
    for (int w = 0; w < clades->W; ++w) {
      dst[w] = flip ? (~src[w] & clades->mask(w)) : src[w];
    }
  }

  int32_t split_index(int node) const {
    const int W = clades->W;
    std::vector<uint64_t> a(W), b(W);
    clade_of(node, false, a.data());
    clade_of(node, true, b.data());
    const uint64_t* mn = CladeLess(a.data(), b.data(), W) ? a.data() : b.data();
    auto it = ix->splits.find(KeyOf(mn, W));
    return it == ix->splits.end() ? sentinel : it->second;
  }

  // z + min(z1, z2) with (node, flip) triples.
  int32_t subsplit_index(int z1, bool f1, int z2, bool f2, int z,
                         bool fz) const {
    const int W = clades->W;
    std::vector<uint64_t> key(2 * W), c1(W), c2(W);
    clade_of(z, fz, key.data());
    clade_of(z1, f1, c1.data());
    clade_of(z2, f2, c2.data());
    const uint64_t* mn =
        CladeLess(c1.data(), c2.data(), W) ? c1.data() : c2.data();
    std::copy(mn, mn + W, key.data() + W);
    auto it = ix->subsplits.find(KeyOf(key.data(), 2 * W));
    return it == ix->subsplits.end() ? sentinel : it->second;
  }

  void f_root(int n0, int n1, int n2) {
    root_row[n0] = split_index(n0);
    up_row[n0] = subsplit_index(n1, false, n2, false, n0, true);
  }

  void recur(int node, int sister, int parent) {
    root_row[node] = split_index(node);
    up_row[node] = subsplit_index(parent, true, sister, false, node, true);
    down_row[parent] = subsplit_index(node, false, sister, false, parent, false);
    const auto& kids = (*children)[node];
    if (!kids.empty()) {
      recur(kids[0], kids[1], node);
      recur(kids[1], kids[0], node);
    }
  }

  void run(int root_id) {
    const auto& rc = (*children)[root_id];
    for (int i = 0; i < 3; ++i) {
      const int n = rc[i], s = rc[(i + 1) % 3], p = rc[(i + 2) % 3];
      f_root(n, s, p);
      const auto& kids = (*children)[n];
      if (!kids.empty()) {
        recur(kids[0], kids[1], n);
        recur(kids[1], kids[0], n);
      }
    }
  }
};

}  // namespace

void* lsbn_psp_create(const uint64_t* split_keys, const int32_t* split_vals,
                      int32_t n_splits, const uint64_t* subsplit_keys,
                      const int32_t* subsplit_vals, int32_t n_subsplits,
                      int32_t n_taxa) {
  auto* ix = new NativePSP();
  ix->n_taxa = n_taxa;
  ix->W = (n_taxa + 63) / 64;
  ix->splits.reserve(n_splits * 2);
  ix->subsplits.reserve(n_subsplits * 2);
  for (int32_t i = 0; i < n_splits; ++i) {
    ix->splits.emplace(
        KeyOf(split_keys + static_cast<size_t>(i) * ix->W, ix->W),
        split_vals[i]);
  }
  for (int32_t i = 0; i < n_subsplits; ++i) {
    ix->subsplits.emplace(
        KeyOf(subsplit_keys + static_cast<size_t>(i) * 2 * ix->W, 2 * ix->W),
        subsplit_vals[i]);
  }
  return ix;
}

void lsbn_psp_free(void* handle) { delete static_cast<NativePSP*>(handle); }

// out: (n_trees, 3, E) rows [rootsplit, down, up] per node id.
int32_t lsbn_psp_representations(void* handle, const int32_t* parent_vectors,
                                 int32_t n_trees, int32_t n_nodes,
                                 int32_t sentinel, int32_t* out) {
  auto* ix = static_cast<NativePSP*>(handle);
  const int n_taxa = ix->n_taxa;
  const int W = ix->W;
  const int E = n_nodes - 1;
  const int root_id = n_nodes - 1;

  std::vector<std::vector<int>> children(n_nodes);
  Clades clades;
  clades.n_taxa = n_taxa;
  clades.W = W;
  clades.data.assign(static_cast<size_t>(n_nodes) * W, 0);

  for (int t = 0; t < n_trees; ++t) {
    const int32_t* pv = parent_vectors + static_cast<size_t>(t) * E;
    for (auto& c : children) c.clear();
    for (int i = 0; i < E; ++i) {
      if (pv[i] < 0 || pv[i] >= n_nodes) return 1;
      children[pv[i]].push_back(i);
    }
    if (children[root_id].size() != 3) return 2;
    std::fill(clades.data.begin(), clades.data.end(), 0);
    for (int node = 0; node < n_nodes; ++node) {
      uint64_t* dst = clades.of(node);
      if (children[node].empty()) {
        if (node >= n_taxa) return 3;
        dst[node / 64] |= 1ull << (63 - node % 64);
      } else {
        for (const int c : children[node]) {
          if (c >= node) return 4;
          const uint64_t* src = clades.of(c);
          for (int w = 0; w < W; ++w) dst[w] |= src[w];
        }
      }
    }
    int32_t* tree_out = out + static_cast<size_t>(t) * 3 * E;
    std::fill(tree_out, tree_out + 3 * E, sentinel);
    PSPBuilder pb;
    pb.ix = ix;
    pb.clades = &clades;
    pb.children = &children;
    pb.sentinel = sentinel;
    pb.E = E;
    pb.root_row = tree_out;
    pb.down_row = tree_out + E;
    pb.up_row = tree_out + 2 * E;
    pb.run(root_id);
  }
  return 0;
}

}  // extern "C"

// -- SBN topology sampling --------------------------------------------------
// Ancestral sampling from a trained SBN, replacing the Python recursion in
// sbn/sampling.py (reference: generic_sbn_instance.hpp SampleTopology). The
// support's bitset recursion is pre-lowered on the Python side to dense
// integer tables (sbn/sampling.py build_sampler_tables): each entry (a
// rootsplit or a gpcsp index) has two sides, and each side is either a leaf
// (leaf >= 0) or a categorical range [start, end) over `probs` (normalized
// per sibling block). Sampled trees are optionally derooted (node.cpp
// Node::Deroot semantics) and emitted as canonical polished parent-id
// vectors via the same PolishAndEmit as the parser, so the output rows can
// key artifact caches directly.

namespace {

struct SplitMix64 {
  uint64_t s;
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

struct SbnSampler {
  const double* probs;
  const int32_t* root_tab;   // (rs_count, 6): leaf1,r1s,r1e,leaf2,r2s,r2e
  const int32_t* child_tab;  // (g_count, 6)
  int32_t rs_count = 0;
  int32_t g_count = 0;
  SplitMix64 rng;
  TreeArena* arena = nullptr;
  bool ok = true;

  int32_t sample_range(int32_t start, int32_t end) {
    const double u = rng.uniform();
    double c = 0.0;
    for (int32_t k = start; k < end; ++k) {
      c += probs[k];
      if (u < c) return k;
    }
    return end - 1;
  }

  int make_leaf(int32_t taxon) {
    ParseNode n;
    n.leaf_id = taxon;
    n.max_leaf = taxon;
    arena->nodes.push_back(std::move(n));
    return static_cast<int>(arena->nodes.size()) - 1;
  }

  int join2(int a, int b) {
    if (arena->nodes[a].max_leaf > arena->nodes[b].max_leaf) std::swap(a, b);
    ParseNode n;
    n.children = {a, b};
    n.max_leaf = arena->nodes[b].max_leaf;
    arena->nodes.push_back(std::move(n));
    return static_cast<int>(arena->nodes.size()) - 1;
  }

  int build_side(const int32_t* row, int side) {
    const int32_t leaf = row[side * 3 + 0];
    if (leaf >= 0) return make_leaf(leaf);
    const int32_t start = row[side * 3 + 1];
    const int32_t end = row[side * 3 + 2];
    if (start < 0 || start >= end || end > g_count) {
      ok = false;
      return make_leaf(0);
    }
    const int32_t j = sample_range(start, end);
    return build_entry(child_tab + static_cast<size_t>(j) * 6);
  }

  int build_entry(const int32_t* row) {
    const int left = build_side(row, 0);
    const int right = build_side(row, 1);
    return join2(left, right);
  }

  int sample_tree(bool rooted) {
    const int32_t s = sample_range(0, rs_count);
    int root = build_entry(root_tab + static_cast<size_t>(s) * 6);
    if (rooted) return root;
    // Deroot: merge the root's non-leaf child's children with the other
    // child and re-canonicalize (core/topology.py deroot).
    const int c0 = arena->nodes[root].children[0];
    const int c1 = arena->nodes[root].children[1];
    int other, has_desc;
    if (arena->nodes[c1].children.empty()) {
      other = c1;
      has_desc = c0;
    } else {
      other = c0;
      has_desc = c1;
    }
    if (arena->nodes[has_desc].children.empty()) {
      ok = false;  // < 3 taxa
      return root;
    }
    std::vector<int> kids = arena->nodes[has_desc].children;
    kids.push_back(other);
    std::sort(kids.begin(), kids.end(), [this](int a, int b) {
      return arena->nodes[a].max_leaf < arena->nodes[b].max_leaf;
    });
    ParseNode n;
    n.children = std::move(kids);
    n.max_leaf = arena->nodes[n.children.back()].max_leaf;
    arena->nodes.push_back(std::move(n));
    return static_cast<int>(arena->nodes.size()) - 1;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success. out_parents is caller-allocated
// (n_samples, n_nodes - 1) with n_nodes = 2*n_taxa-1 (rooted) or 2*n_taxa-2.
int32_t lsbn_sample_topologies(const double* probs, int32_t rs_count,
                               const int32_t* root_tab,
                               const int32_t* child_tab, int32_t g_count,
                               int32_t n_taxa, int32_t n_samples,
                               uint64_t seed, int32_t rooted,
                               int32_t* out_parents) {
  if (rs_count <= 0 || n_taxa < (rooted ? 2 : 3)) return 1;
  const int32_t n_nodes = rooted ? 2 * n_taxa - 1 : 2 * n_taxa - 2;
  TreeArena arena;
  SbnSampler sampler;
  sampler.probs = probs;
  sampler.root_tab = root_tab;
  sampler.child_tab = child_tab;
  sampler.rs_count = rs_count;
  sampler.g_count = g_count;
  sampler.rng = SplitMix64{seed};
  sampler.arena = &arena;
  std::vector<int32_t> parents;
  std::vector<double> bls;
  for (int32_t t = 0; t < n_samples; ++t) {
    arena.nodes.clear();
    arena.root = sampler.sample_tree(rooted != 0);
    if (!sampler.ok) return 2;
    PolishAndEmit(&arena, n_taxa, &parents, &bls);
    if (static_cast<int32_t>(parents.size()) != n_nodes - 1) return 3;
    std::memcpy(out_parents + static_cast<size_t>(t) * (n_nodes - 1),
                parents.data(), sizeof(int32_t) * (n_nodes - 1));
  }
  return 0;
}

}  // extern "C"
