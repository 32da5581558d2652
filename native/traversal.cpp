// Native gap-fill traversal engine: bounded breadth-first contig
// construction in the DBG (the IterativeExtensions + BranchingTerminator
// equivalent; reference src/Filler.cpp:866-884 — behavior reconstructed and
// calibrated in mindthegap_tpu/fill/traversal.py; this file is a scalar C++
// port of THAT python engine, bit-exact, for the fill hot loop #3 of
// SURVEY.md §3).
//
// Two membership backends behind one templated algorithm core:
//
//  - QGraph (k <= 32): the fused cuckoo quotient map built by
//    mindthegap_tpu/ops/extmap.py build_fused — one u64 slot probe per
//    canonical (k-1)-mer yields the full successor (ext) and predecessor
//    (pre) bitmap of a node. Slot layout (extmap.py ~:408):
//      [ rem : 64-log_size ][ valid:1 (bit 10) ][ choice:1 (bit 9) ][ payload:9 ]
//    Overflow stash: sorted u64 keys + u16 payloads, binary-searched.
//
//  - SpanGraph (32 < k <= 256): multi-word k-mers (MSW-first, the
//    ops/span.py layout) against the sorted big-endian solid key blob
//    (memcmp order == numeric order) — binary-search membership, removing
//    the python fallback the fill module used for spans.
//
// Exposed C ABI (ctypes bridge: mindthegap_tpu/fill/traversal_native.py):
//   mtg_tsession_new / mtg_tsession_new_span / free / reset_marks
//   mtg_traverse_right[_span]        — one right extension
//   mtg_construct_linear_seqs[_span] — one full gap-fill job's contig list
//
// Built on first use by mindthegap_tpu/utils/native_build.py (g++ -O3 -shared -fPIC),
// into native/libtraversal-<hash of source, flags and compiler>.so.

#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <unordered_set>
#include <vector>
#include <algorithm>

namespace {

// ---------------------------------------------------------------------------
// Needleman-Wunsch identity, same function as native/nw.cpp (reference
// src/Utils.cpp:87-189 semantics): gap -5, mismatch -5, match +10; identity
// = diagonal matches along traceback / max(len).
double nw_identity_(const char* a, int64_t n, const char* b, int64_t m)
{
    if (n == 0 || m == 0) return 0.0;
    const int32_t GAP = -5, MIS = -5, MATCH = 10;
    std::vector<int32_t> prev_s(m + 1), cur_s(m + 1), prev_f(m + 1), cur_f(m + 1);
    for (int64_t j = 0; j <= m; j++) { prev_s[j] = GAP * (int32_t)j; prev_f[j] = 0; }
    for (int64_t i = 1; i <= n; i++)
    {
        cur_s[0] = GAP * (int32_t)i;
        cur_f[0] = 0;
        const char ai = a[i - 1];
        for (int64_t j = 1; j <= m; j++)
        {
            const bool eq = ai == b[j - 1];
            const int32_t diag = prev_s[j - 1] + (eq ? MATCH : MIS);
            const int32_t up = prev_s[j] + GAP;
            const int32_t left = cur_s[j - 1] + GAP;
            int32_t s = std::max(diag, std::max(up, left));
            cur_s[j] = s;
            if (s == diag) cur_f[j] = prev_f[j - 1] + (eq ? 1 : 0);
            else if (s == up) cur_f[j] = prev_f[j];
            else cur_f[j] = cur_f[j - 1];
        }
        std::swap(prev_s, cur_s);
        std::swap(prev_f, cur_f);
    }
    return (double)prev_f[m] / (double)(n > m ? n : m);
}

// ---------------------------------------------------------------------------
// 2-bit k-mer helpers (alphabet A=0 C=1 T=2 G=3; complement = code ^ 2)

static inline uint64_t revcomp_u64(uint64_t x, int k)
{
    x = ((x & 0x3333333333333333ULL) << 2) | ((x >> 2) & 0x3333333333333333ULL);
    x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
    x = __builtin_bswap64(x);
    x ^= 0xAAAAAAAAAAAAAAAAULL;  // per-base complement (code ^ 2)
    return x >> (64 - 2 * k);
}

// 2-bit-group reversal + complement of one full 64-bit word
static inline uint64_t rc_word64(uint64_t x)
{
    x = ((x & 0x3333333333333333ULL) << 2) | ((x >> 2) & 0x3333333333333333ULL);
    x = ((x & 0x0F0F0F0F0F0F0F0FULL) << 4) | ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL);
    x = __builtin_bswap64(x);
    return x ^ 0xAAAAAAAAAAAAAAAAULL;
}

static inline uint64_t canonical_u64(uint64_t x, int k)
{
    uint64_t rc = revcomp_u64(x, k);
    return x < rc ? x : rc;
}

// bitmap positions b -> b ^ 2 (swap A<->T, C<->G lanes of a 4-bit mask)
static inline uint32_t shuffle02(uint32_t v)
{
    return ((v & 0x3u) << 2) | ((v >> 2) & 0x3u);
}

static const char* ALPHA = "ACTG";

// ---------------------------------------------------------------------------
// traversal policy — mirror of fill/traversal.py TraversalPolicy; the knob
// order is the ABI contract with traversal_native.py (POLICY_FIELDS).
struct Policy {
    int32_t in_branch_stop;
    int32_t explore_branching;
    int32_t bubble_max_depth;
    int32_t bubble_max_breadth;
    int32_t consensus_identity;
    int32_t start_mark;
    int32_t passed_branch_mark;
    int32_t branch_stop_mark;
    int32_t skip_marked_start;   // 0=skip 1=kmer 2=no
    int32_t stop_at_marked;
    int32_t explore_marked_fail;
    int32_t merge_reverse_check;
    int32_t swf_mode;            // 0=none 1=r_in_seq 2=seq_in_r 3=anchor_in_seq
    int32_t swf_noextend;
    int32_t push_on_marked_stop;
    int32_t marked_start_push;
    int32_t lifo;
    int32_t depth_with_kmer;
    int32_t max_nodes_strict;
};

enum Reason { R_TIP = 0, R_FORK = 1, R_MERGE = 2, R_MARKED = 3, R_MAXLEN = 4 };

// ---------------------------------------------------------------------------
// Backend 1: u64 nodes over the fused cuckoo quotient map (k <= 32)

struct QGraph {
    typedef uint64_t Node;
    struct NodeHash { size_t operator()(uint64_t v) const { return std::hash<uint64_t>()(v); } };

    const uint64_t* slots;
    int32_t log_size;
    const uint64_t* stash_keys;
    const uint16_t* stash_pay;
    int32_t n_stash;
    int32_t k;
    uint64_t kmask;   // (1 << 2k) - 1
    uint64_t qmask;   // (1 << 2(k-1)) - 1

    void init(int kk)
    {
        k = kk;
        kmask = (k >= 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
        qmask = (1ULL << (2 * (k - 1))) - 1;
    }

    // -- fused-map probe (traversal.py GraphView._payload_int) -------------
    inline uint32_t payload(uint64_t key) const
    {
        const int shift = 64 - log_size;
        const uint64_t rem_mask = (1ULL << shift) - 1;
        static const uint64_t consts[2] = {0x9E3779B97F4A7C15ULL, 0xC2B2AE3D27D4EB4FULL};
        for (int i = 0; i < 2; i++)
        {
            uint64_t h = (key ^ (key >> 33)) * consts[i];
            h ^= h >> 29;
            uint64_t v = slots[h >> shift];
            if ((v & 1024) && (v >> 11) == (h & rem_mask) && (((v >> 9) & 1) == (uint64_t)i))
                return (uint32_t)(v & 0x1FF);
        }
        int lo = 0, hi = n_stash;
        while (lo < hi)
        {
            int mid = (lo + hi) >> 1;
            if (stash_keys[mid] < key) lo = mid + 1; else hi = mid;
        }
        if (lo < n_stash && stash_keys[lo] == key) return stash_pay[lo];
        return 0;
    }

    inline uint32_t ext_bits(uint64_t q) const
    {
        uint64_t cq = canonical_u64(q, k - 1);
        uint32_t pay = payload(cq);
        return q == cq ? (pay & 0xF) : shuffle02((pay >> 4) & 0xF);
    }

    inline uint32_t pre_bits(uint64_t q) const
    {
        uint64_t cq = canonical_u64(q, k - 1);
        uint32_t pay = payload(cq);
        return q == cq ? ((pay >> 4) & 0xF) : shuffle02(pay & 0xF);
    }

    // nts/nodes filled in nt order 0..3 like the python engine
    inline int successors(Node fwd, int* nts, Node* nodes) const
    {
        uint32_t ext = ext_bits(fwd & qmask);
        int n = 0;
        for (int nt = 0; nt < 4; nt++)
            if ((ext >> nt) & 1) { nts[n] = nt; nodes[n] = ((fwd << 2) | (uint64_t)nt) & kmask; n++; }
        return n;
    }

    inline int predecessors(Node fwd, Node* nodes) const
    {
        uint32_t pre = pre_bits(fwd >> 2);
        int n = 0;
        const int shift = 2 * (k - 1);
        for (int nt = 0; nt < 4; nt++)
            if ((pre >> nt) & 1) nodes[n++] = (fwd >> 2) | ((uint64_t)nt << shift);
        return n;
    }

    inline int n_succ(Node fwd) const { return __builtin_popcount(ext_bits(fwd & qmask)); }
    inline int n_pred(Node fwd) const { return __builtin_popcount(pre_bits(fwd >> 2)); }

    inline bool is_branching(Node fwd) const
    {
        return n_succ(fwd) != 1 || n_pred(fwd) != 1;
    }

    inline Node canonical(Node fwd) const { return canonical_u64(fwd, k); }

    void kmer_str(Node x, std::string& out) const
    {
        for (int i = k - 1; i >= 0; i--) out.push_back(ALPHA[(x >> (2 * i)) & 3]);
    }
};

// ---------------------------------------------------------------------------
// Backend 2: multi-word nodes (MSW-first, ops/span.py layout, k <= 256)
// over the sorted big-endian solid key blob — binary-search membership.

const int MAXW = 8;

struct N256 {
    uint64_t w[MAXW];  // w[0] = most significant; unused trailing words = 0
    bool operator==(const N256& o) const
    {
        for (int i = 0; i < MAXW; i++) if (w[i] != o.w[i]) return false;
        return true;
    }
    bool operator<(const N256& o) const
    {
        for (int i = 0; i < MAXW; i++)
        {
            if (w[i] < o.w[i]) return true;
            if (w[i] > o.w[i]) return false;
        }
        return false;
    }
};

struct SpanGraph {
    typedef N256 Node;
    struct NodeHash {
        size_t operator()(const N256& n) const
        {
            uint64_t h = 0x9E3779B97F4A7C15ULL;
            for (int i = 0; i < MAXW; i++) { h ^= n.w[i]; h *= 0xC2B2AE3D27D4EB4FULL; h ^= h >> 29; }
            return (size_t)h;
        }
    };

    const uint8_t* keys_be;  // sorted big-endian rows, 8*W bytes each
    int64_t n_keys;
    int32_t k;
    int32_t W;               // words per k-mer = ceil(k/32)
    int32_t top_bits;        // 2k - 64*(W-1), bits used in w[0]
    uint64_t top_mask;

    void init(int kk)
    {
        k = kk;
        W = (k + 31) / 32;
        top_bits = 2 * k - 64 * (W - 1);
        top_mask = (top_bits >= 64) ? ~0ULL : ((1ULL << top_bits) - 1);
    }

    // -- multi-word ops -----------------------------------------------------
    inline Node append(const Node& u, int nt) const  // (u << 2 | nt) & kmask
    {
        Node v{};
        for (int i = 0; i < W - 1; i++) v.w[i] = (u.w[i] << 2) | (u.w[i + 1] >> 62);
        v.w[W - 1] = (u.w[W - 1] << 2) | (uint64_t)nt;
        v.w[0] &= top_mask;
        return v;
    }

    inline Node prepend(const Node& u, int nt) const  // (u >> 2) | nt << (2k-2)
    {
        Node v{};
        for (int i = W - 1; i > 0; i--) v.w[i] = (u.w[i] >> 2) | (u.w[i - 1] << 62);
        v.w[0] = u.w[0] >> 2;
        v.w[0] |= (uint64_t)nt << (top_bits - 2);
        return v;
    }

    inline int last_base(const Node& u) const { return (int)(u.w[W - 1] & 3); }
    inline int top_base(const Node& u) const { return (int)((u.w[0] >> (top_bits - 2)) & 3); }

    inline Node revcomp(const Node& u) const
    {
        // reverse+complement all 64W bits word-reversed, then shift right
        // by the 64W - 2k padding
        Node r{};
        for (int i = 0; i < W; i++) r.w[i] = rc_word64(u.w[W - 1 - i]);
        int rshift = 64 * W - 2 * k;
        if (rshift)
        {
            for (int i = W - 1; i > 0; i--)
                r.w[i] = (r.w[i] >> rshift) | (r.w[i - 1] << (64 - rshift));
            r.w[0] >>= rshift;
        }
        return r;
    }

    inline Node canonical(const Node& u) const
    {
        Node rc = revcomp(u);
        return rc < u ? rc : u;
    }

    inline bool contains_canon(const Node& c) const
    {
        uint8_t q[MAXW * 8];
        for (int i = 0; i < W; i++)
        {
            uint64_t be = __builtin_bswap64(c.w[i]);
            std::memcpy(q + 8 * i, &be, 8);
        }
        const size_t row = 8 * (size_t)W;
        int64_t lo = 0, hi = n_keys;
        while (lo < hi)
        {
            int64_t mid = (lo + hi) >> 1;
            if (std::memcmp(keys_be + row * mid, q, row) < 0) lo = mid + 1;
            else hi = mid;
        }
        return lo < n_keys && std::memcmp(keys_be + row * lo, q, row) == 0;
    }

    inline bool contains(const Node& u) const { return contains_canon(canonical(u)); }

    inline int successors(const Node& fwd, int* nts, Node* nodes) const
    {
        int n = 0;
        for (int nt = 0; nt < 4; nt++)
        {
            Node v = append(fwd, nt);
            if (contains(v)) { nts[n] = nt; nodes[n] = v; n++; }
        }
        return n;
    }

    inline int predecessors(const Node& fwd, Node* nodes) const
    {
        int n = 0;
        for (int nt = 0; nt < 4; nt++)
        {
            Node v = prepend(fwd, nt);
            if (contains(v)) nodes[n++] = v;
        }
        return n;
    }

    inline int n_succ(const Node& fwd) const
    {
        int nts[4]; Node nodes[4];
        return successors(fwd, nts, nodes);
    }
    inline int n_pred(const Node& fwd) const
    {
        Node nodes[4];
        return predecessors(fwd, nodes);
    }
    inline bool is_branching(const Node& fwd) const
    {
        return n_succ(fwd) != 1 || n_pred(fwd) != 1;
    }

    void kmer_str(const Node& x, std::string& out) const
    {
        for (int i = k - 1; i >= 0; i--)
        {
            int word = W - 1 - i / 32;
            int off = 2 * (i % 32);
            out.push_back(ALPHA[(x.w[word] >> off) & 3]);
        }
    }
};

// ---------------------------------------------------------------------------
// Templated algorithm core (bit-exact port of fill/traversal.py)

template <class G>
struct Sess {
    G g;
    Policy pol;
    std::unordered_set<typename G::Node, typename G::NodeHash> marked;

    inline void mark(const typename G::Node& n) { marked.insert(g.canonical(n)); }
    inline bool is_marked(const typename G::Node& n) const
    {
        return marked.count(g.canonical(n)) != 0;
    }
};

// _find_end_of_branching: frontline BFS from a branching node until the
// frontline collapses to one node.
template <class G>
struct BranchEnd { typename G::Node end; int depth; std::vector<typename G::Node> involved; };

template <class G>
static bool find_end_of_branching(const Sess<G>& S, const typename G::Node& start, BranchEnd<G>& out)
{
    typedef typename G::Node Node;
    const Policy& P = S.pol;
    std::unordered_set<Node, typename G::NodeHash> already;
    already.insert(S.g.canonical(start));
    int nts[4]; Node nodes[4], preds[4];
    std::vector<Node> frontline;
    int n = S.g.successors(start, nts, nodes);
    for (int i = 0; i < n; i++)
    {
        frontline.push_back(nodes[i]);
        already.insert(S.g.canonical(nodes[i]));
    }
    if (P.explore_marked_fail)
        for (const Node& f : frontline)
            if (S.is_marked(f)) return false;
    std::vector<Node> involved = frontline;
    int depth = 1;
    std::vector<Node> new_frontline;
    std::unordered_set<Node, typename G::NodeHash> seen_new;
    while (depth < P.bubble_max_depth)
    {
        if (frontline.empty()) return false;
        if (frontline.size() == 1)
        {
            out.end = frontline[0];
            out.depth = depth;
            out.involved = std::move(involved);
            return true;
        }
        if ((int)frontline.size() > P.bubble_max_breadth) return false;
        new_frontline.clear();
        seen_new.clear();
        for (const Node& node : frontline)
        {
            int ns = S.g.successors(node, nts, nodes);
            for (int i = 0; i < ns; i++)
            {
                Node nxt = nodes[i];
                // external in-branching check
                int np = S.g.predecessors(nxt, preds);
                for (int j = 0; j < np; j++)
                    if (!already.count(S.g.canonical(preds[j]))) return false;
                if (P.explore_marked_fail && S.is_marked(nxt)) return false;
                Node c = S.g.canonical(nxt);
                if (already.count(c)) continue;
                already.insert(c);
                seen_new.insert(c);
                new_frontline.push_back(nxt);
            }
        }
        involved.insert(involved.end(), new_frontline.begin(), new_frontline.end());
        frontline = new_frontline;
        depth++;
    }
    return false;
}

// _reverse_collapse_ok: reverse frontline BFS admissibility test for
// crossing a pure merge (policy.merge_reverse_check).
template <class G>
static bool reverse_collapse_ok(const Sess<G>& S, const typename G::Node& node)
{
    typedef typename G::Node Node;
    const Policy& P = S.pol;
    std::unordered_set<Node, typename G::NodeHash> already;
    already.insert(S.g.canonical(node));
    Node preds[4];
    std::vector<Node> frontline;
    int np = S.g.predecessors(node, preds);
    for (int i = 0; i < np; i++)
    {
        frontline.push_back(preds[i]);
        already.insert(S.g.canonical(preds[i]));
    }
    int depth = 1;
    std::vector<Node> new_frontline;
    while (depth < P.bubble_max_depth)
    {
        if (frontline.size() <= 1) return true;
        if ((int)frontline.size() > P.bubble_max_breadth) return false;
        new_frontline.clear();
        for (const Node& n : frontline)
        {
            int k2 = S.g.predecessors(n, preds);
            for (int i = 0; i < k2; i++)
            {
                Node c = S.g.canonical(preds[i]);
                if (already.count(c)) continue;
                already.insert(c);
                new_frontline.push_back(preds[i]);
            }
        }
        frontline = new_frontline;
        depth++;
    }
    return false;
}

// _all_paths_between: all nt strings start -> end of length <= max_depth;
// returns false when the path count exceeds max_breadth (fail).
template <class G>
static bool all_paths_between(const Sess<G>& S, const typename G::Node& start,
                              const typename G::Node& end,
                              int max_depth, int max_breadth,
                              std::vector<std::string>& out)
{
    typedef typename G::Node Node;
    out.clear();
    std::vector<std::pair<Node, std::string>> stack;
    stack.emplace_back(start, std::string());
    int nts[4]; Node nodes[4];
    while (!stack.empty())
    {
        Node node = stack.back().first;
        std::string s = std::move(stack.back().second);
        stack.pop_back();
        if (node == end && !s.empty())
        {
            out.push_back(s);
            if ((int)out.size() > max_breadth) return false;
            continue;
        }
        if ((int)s.size() >= max_depth) continue;
        int n = S.g.successors(node, nts, nodes);
        for (int i = 0; i < n; i++)
        {
            std::string t = s;
            t.push_back(ALPHA[nts[i]]);
            stack.emplace_back(nodes[i], std::move(t));
        }
    }
    return true;
}

// _explore_branching: cross a tip/clean bubble -> (consensus, end) or fail.
template <class G>
static bool explore_branching(Sess<G>& S, const typename G::Node& node,
                              std::string& consensus, typename G::Node& end)
{
    const Policy& P = S.pol;
    BranchEnd<G> be;
    if (!find_end_of_branching(S, node, be)) return false;
    std::vector<std::string> paths;
    if (!all_paths_between(S, node, be.end, be.depth + 1, P.bubble_max_breadth, paths))
        return false;
    if (paths.empty()) return false;
    if (paths.size() > 1)
        for (size_t i = 0; i < paths.size(); i++)
            for (size_t j = i + 1; j < paths.size(); j++)
                if (nw_identity_(paths[i].data(), paths[i].size(),
                                 paths[j].data(), paths[j].size()) * 100.0
                    < (double)P.consensus_identity)
                    return false;
    consensus = *std::min_element(paths.begin(), paths.end());
    for (const typename G::Node& n : be.involved)
        if (S.g.is_branching(n)) S.mark(n);
    end = be.end;
    return true;
}

// traverse_right: the composed host_walk + per-event automaton of
// fill/traversal.py traverse_right_co driven by host_walk — one function,
// identical control flow.
template <class G>
static void traverse_right(Sess<G>& S, const typename G::Node& start, int64_t maxlen,
                           std::string& seq, typename G::Node& node_out, int& reason_out)
{
    typedef typename G::Node Node;
    const Policy& P = S.pol;
    seq.clear();
    S.g.kmer_str(start, seq);
    int64_t slen = S.g.k;
    Node node = start;
    int reason = R_MAXLEN;
    int nts[4]; Node nodes[4];
    while (slen < maxlen)
    {
        // -- host_walk: extend a pure simple path within budget -------------
        int64_t budget = maxlen - slen;
        int wreason = 2;  // 0=tip 1=event 2=budget
        int64_t walked = 0;
        while (walked < budget)
        {
            int ns = S.g.successors(node, nts, nodes);
            if (ns == 0) { wreason = 0; break; }
            if (ns > 1) { wreason = 1; break; }
            Node nxt = nodes[0];
            if (S.g.n_pred(nxt) != 1) { wreason = 1; break; }
            if (S.g.n_succ(nxt) != 1) { wreason = 1; break; }
            seq.push_back(ALPHA[nts[0]]);
            walked++;
            node = nxt;
        }
        slen += walked;
        if (wreason == 2) break;            // budget: reason stays maxlen
        if (wreason == 0) { reason = R_TIP; break; }
        // -- event: replay ONE iteration of the reference loop body ---------
        int ns = S.g.successors(node, nts, nodes);
        if (ns == 0) { reason = R_TIP; break; }  // unreachable, kept for safety
        bool in_branch = ns > 1
            || (P.in_branch_stop && S.g.n_pred(nodes[0]) > 1);
        if (in_branch)
        {
            bool crossed = false;
            std::string cons;
            Node cend{};
            bool merge_only = ns == 1;
            bool admissible = true;
            if (merge_only && P.merge_reverse_check)
                admissible = reverse_collapse_ok(S, nodes[0]);
            if (P.explore_branching && admissible)
                crossed = explore_branching(S, node, cons, cend);
            if (!crossed)
            {
                reason = ns > 1 ? R_FORK : R_MERGE;
                if (P.branch_stop_mark && ns > 1) S.mark(node);
                break;
            }
            seq += cons;
            slen += (int64_t)cons.size();
            node = cend;
            continue;
        }
        Node nxt = nodes[0];
        if (S.g.is_branching(nxt))
        {
            if (P.stop_at_marked && S.is_marked(nxt)) { reason = R_MARKED; break; }
            if (P.passed_branch_mark) S.mark(nxt);
        }
        seq.push_back(ALPHA[nts[0]]);
        slen += 1;
        node = nxt;
    }
    node_out = node;
    reason_out = reason;
}

template <class G>
static bool swf_hit(const Sess<G>& S, const std::string& seq, const char* R, int64_t rlen)
{
    const Policy& P = S.pol;
    if (P.swf_mode == 0 || rlen == 0) return false;
    if (P.swf_mode == 1)  // r_in_seq
        return seq.find(std::string(R, rlen)) != std::string::npos;
    if (P.swf_mode == 2)  // seq_in_r
        return std::string(R, rlen).find(seq) != std::string::npos;
    // anchor_in_seq: any k-window of R at stride k found in seq
    for (int64_t i = 0; i + S.g.k <= rlen; i += S.g.k)
        if (seq.find(std::string(R + i, S.g.k)) != std::string::npos) return true;
    return false;
}

// construct_linear_seqs: the full per-job BFS (traversal.py
// construct_linear_seqs_co), contigs appended in emission order.
template <class G>
static void construct_linear_seqs(Sess<G>& S, const typename G::Node& start,
                                  const char* R, int64_t rlen,
                                  int64_t max_depth, int64_t max_nodes, int swf,
                                  std::vector<std::string>& contigs)
{
    typedef typename G::Node Node;
    const Policy& P = S.pol;
    S.marked.clear();
    std::deque<std::pair<Node, int64_t>> queue;
    queue.emplace_back(start, 0);
    contigs.clear();
    int nts[4]; Node nodes[4];
    std::string seq;
    while (!queue.empty())
    {
        Node cur;
        int64_t depth;
        if (P.lifo) { cur = queue.back().first; depth = queue.back().second; queue.pop_back(); }
        else { cur = queue.front().first; depth = queue.front().second; queue.pop_front(); }
        if (!contigs.empty() && S.is_marked(cur))
        {
            if (P.skip_marked_start == 0) continue;  // "skip"
            if (P.skip_marked_start == 1)            // "kmer"
            {
                seq.clear();
                S.g.kmer_str(cur, seq);
                contigs.push_back(seq);
                bool hit = swf != 0 && swf_hit(S, seq, R, rlen);
                if (hit && !P.swf_noextend) break;
                if (P.marked_start_push)
                {
                    int n = S.g.successors(cur, nts, nodes);
                    for (int i = 0; i < n; i++)
                        queue.emplace_back(nodes[i], depth + (int64_t)seq.size());
                }
                continue;
            }
            // "no": fall through to a normal extension
        }
        if (P.start_mark && S.g.is_branching(cur)) S.mark(cur);
        Node last{};
        int reason;
        traverse_right(S, cur, max_depth, seq, last, reason);
        contigs.push_back(seq);
        bool hit = swf != 0 && swf_hit(S, seq, R, rlen);
        if (hit && !P.swf_noextend) break;
        int64_t new_depth = depth + (P.depth_with_kmer ? (int64_t)seq.size()
                                                       : (int64_t)seq.size() - S.g.k);
        if (P.max_nodes_strict) { if ((int64_t)contigs.size() >= max_nodes) break; }
        else if ((int64_t)contigs.size() > max_nodes) break;
        if (new_depth > max_depth) continue;
        if (hit && P.swf_noextend) continue;
        if (reason == R_MARKED && !P.push_on_marked_stop) continue;
        int n = S.g.successors(last, nts, nodes);
        for (int i = 0; i < n; i++) queue.emplace_back(nodes[i], new_depth);
    }
}

template <class G>
static int64_t pack_contigs(const std::vector<std::string>& contigs, char* out, int64_t cap)
{
    int64_t total = 0;
    for (const std::string& c : contigs) total += (int64_t)c.size() + 1;
    if (total > cap) return -total;
    int64_t pos = 0;
    for (const std::string& c : contigs)
    {
        std::memcpy(out + pos, c.data(), c.size());
        pos += (int64_t)c.size();
        out[pos++] = '\n';
    }
    return total;
}

typedef Sess<QGraph> QSess;
typedef Sess<SpanGraph> SpanSess;

}  // namespace

// ---------------------------------------------------------------------------
extern "C" {

// ---- u64 / quotient-map sessions (k <= 32) --------------------------------

void* mtg_tsession_new(const uint64_t* slots, int32_t log_size,
                       const uint64_t* stash_keys, const uint16_t* stash_pay,
                       int32_t n_stash, int32_t k, const int32_t* policy)
{
    QSess* s = new QSess();
    s->g.slots = slots;
    s->g.log_size = log_size;
    s->g.stash_keys = stash_keys;
    s->g.stash_pay = stash_pay;
    s->g.n_stash = n_stash;
    s->g.init(k);
    std::memcpy(&s->pol, policy, sizeof(Policy));
    return s;
}

void mtg_tsession_free(void* sp) { delete (QSess*)sp; }

void mtg_tsession_reset_marks(void* sp) { ((QSess*)sp)->marked.clear(); }

void mtg_tsession_set_policy(void* sp, const int32_t* policy)
{
    std::memcpy(&((QSess*)sp)->pol, policy, sizeof(Policy));
}

// One right extension. Returns bytes written to out (or -(needed) when cap
// is too small); end node and stop reason via out params.
int64_t mtg_traverse_right(void* sp, uint64_t start, int64_t maxlen,
                           char* out, int64_t cap, uint64_t* end_node, int32_t* reason)
{
    QSess& S = *(QSess*)sp;
    std::string seq;
    uint64_t node;
    int r;
    traverse_right(S, start, maxlen, seq, node, r);
    *end_node = node;
    *reason = r;
    if ((int64_t)seq.size() > cap) return -(int64_t)seq.size();
    std::memcpy(out, seq.data(), seq.size());
    return (int64_t)seq.size();
}

// One full gap-fill job. Contigs are '\n'-joined in emission order.
// Returns total bytes written (or -(needed) when cap is too small).
int64_t mtg_construct_linear_seqs(void* sp, uint64_t start,
                                  const char* R, int64_t rlen,
                                  int64_t max_depth, int64_t max_nodes, int32_t swf,
                                  char* out, int64_t cap)
{
    QSess& S = *(QSess*)sp;
    std::vector<std::string> contigs;
    construct_linear_seqs(S, start, R, rlen, max_depth, max_nodes, swf, contigs);
    return pack_contigs<QGraph>(contigs, out, cap);
}

// ---- span sessions (32 < k <= 256, sorted big-endian key blob) ------------

void* mtg_tsession_new_span(const uint8_t* keys_be, int64_t n_keys,
                            int32_t k, const int32_t* policy)
{
    SpanSess* s = new SpanSess();
    s->g.keys_be = keys_be;
    s->g.n_keys = n_keys;
    s->g.init(k);
    std::memcpy(&s->pol, policy, sizeof(Policy));
    return s;
}

void mtg_tsession_free_span(void* sp) { delete (SpanSess*)sp; }

void mtg_tsession_reset_marks_span(void* sp) { ((SpanSess*)sp)->marked.clear(); }

void mtg_tsession_set_policy_span(void* sp, const int32_t* policy)
{
    std::memcpy(&((SpanSess*)sp)->pol, policy, sizeof(Policy));
}

// start: W uint64 words, MSW first (ops/span.py row layout)
int64_t mtg_traverse_right_span(void* sp, const uint64_t* start_words, int64_t maxlen,
                                char* out, int64_t cap, uint64_t* end_words, int32_t* reason)
{
    SpanSess& S = *(SpanSess*)sp;
    N256 start{};
    for (int i = 0; i < S.g.W; i++) start.w[i] = start_words[i];
    std::string seq;
    N256 node{};
    int r;
    traverse_right(S, start, maxlen, seq, node, r);
    for (int i = 0; i < S.g.W; i++) end_words[i] = node.w[i];
    *reason = r;
    if ((int64_t)seq.size() > cap) return -(int64_t)seq.size();
    std::memcpy(out, seq.data(), seq.size());
    return (int64_t)seq.size();
}

int64_t mtg_construct_linear_seqs_span(void* sp, const uint64_t* start_words,
                                       const char* R, int64_t rlen,
                                       int64_t max_depth, int64_t max_nodes, int32_t swf,
                                       char* out, int64_t cap)
{
    SpanSess& S = *(SpanSess*)sp;
    N256 start{};
    for (int i = 0; i < S.g.W; i++) start.w[i] = start_words[i];
    std::vector<std::string> contigs;
    construct_linear_seqs(S, start, R, rlen, max_depth, max_nodes, swf, contigs);
    return pack_contigs<SpanGraph>(contigs, out, cap);
}

}  // extern "C"
