// Native find-scan automaton: the sequential breakpoint state machine.
//
// Port of mindthegap_tpu/find/automaton.py + observers.py (which are the
// gate-verified reimplementation of the reference's FindBreakpoints scanner,
// reference src/FindBreakpoints.hpp + src/Find*.hpp). The device pass
// produces per-position planes; this consumes them at native speed —
// the python replay is the host bottleneck on genome-scale inputs.
//
// K-mers are Kmer<W> = W uint64 words, word 0 most significant, value
// right-aligned (the ops/span.py layout) — W=1 covers k<=32, W<=8 covers
// the KSIZE_LIST spans up to k=256. W is a compile-time template parameter
// (all word loops unroll); the C API dispatches on `words`.
//
// The output is the exact text of the .breakpoints and .othervariants.vcf
// record streams (headers excluded) plus the counters; python writes files.
//
// Built on first use by mindthegap_tpu/utils/native_build.py (g++ -O3 -shared -fPIC),
// into native/libautomaton-<hash of source, flags and compiler>.so.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

typedef uint64_t u64;

u64 revcomp_word_full(u64 x)
{
    x = x ^ 0xAAAAAAAAAAAAAAAAULL;
    x = ((x >> 2) & 0x3333333333333333ULL) | ((x & 0x3333333333333333ULL) << 2);
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((x & 0x0F0F0F0F0F0F0F0FULL) << 4);
    x = ((x >> 8) & 0x00FF00FF00FF00FFULL) | ((x & 0x00FF00FF00FF00FFULL) << 8);
    x = ((x >> 16) & 0x0000FFFF0000FFFFULL) | ((x & 0x0000FFFF0000FFFFULL) << 16);
    x = (x >> 32) | (x << 32);
    return x;
}

// Multi-word k-mer, span layout: value = sum w[i] << 64*(W-1-i).
template <int W>
struct Kmer
{
    u64 w[W];

    Kmer() { for (int i = 0; i < W; i++) w[i] = 0; }

    bool operator==(const Kmer& o) const
    {
        for (int i = 0; i < W; i++) if (w[i] != o.w[i]) return false;
        return true;
    }
    bool operator<(const Kmer& o) const
    {
        for (int i = 0; i < W; i++)
        {
            if (w[i] < o.w[i]) return true;
            if (w[i] > o.w[i]) return false;
        }
        return false;
    }

    // 2-bit field at bit offset `b` from the LSB of the value (b even, so
    // fields never straddle words)
    int get2(int b) const { return (int)((w[W - 1 - b / 64] >> (b % 64)) & 3ULL); }
    void set2(int b, u64 v)
    {
        u64& word = w[W - 1 - b / 64];
        int sh = b % 64;
        word = (word & ~(3ULL << sh)) | (v << sh);
    }

    void shl2() // value <<= 2 (no mask)
    {
        for (int i = 0; i < W - 1; i++) w[i] = (w[i] << 2) | (w[i + 1] >> 62);
        w[W - 1] <<= 2;
    }
    void shr2() // value >>= 2
    {
        for (int i = W - 1; i > 0; i--) w[i] = (w[i] >> 2) | (w[i - 1] << 62);
        w[0] >>= 2;
    }
    void shr(int s) // value >>= s, 0 <= s < 64
    {
        if (s == 0) return;
        for (int i = W - 1; i > 0; i--) w[i] = (w[i] >> s) | (w[i - 1] << (64 - s));
        w[0] >>= s;
    }
    void mask_top(int nbases) // value &= (1 << 2*nbases) - 1
    {
        int full = nbases * 2 / 64;          // words fully kept, from the low end
        int rem = nbases * 2 - full * 64;    // bits kept in the next word
        for (int i = 0; i < W; i++)
        {
            int from_low = W - 1 - i;  // 0 = least significant word
            if (from_low < full) continue;
            if (from_low == full && rem)
                w[i] &= (rem == 64) ? ~0ULL : ((1ULL << rem) - 1);
            else
                w[i] = 0;
        }
    }
};

template <int W>
Kmer<W> revcomp_n(const Kmer<W>& a, int nbases)
{
    // reverse word order, full-word revcomp, then shift the value (which now
    // occupies the TOP 2*nbases bits) back down (ops/span.py revcomp).
    // The shift s = 64W - 2*nbases can exceed 64 when nbases spans fewer
    // words than W (e.g. the (k-1)-mer suffix of a boundary k).
    Kmer<W> t;
    for (int i = 0; i < W; i++) t.w[i] = revcomp_word_full(a.w[W - 1 - i]);
    int s = 64 * W - 2 * nbases;
    int ws = s / 64, bs = s % 64;
    Kmer<W> out;
    for (int i = W - 1; i >= 0; i--)
    {
        int src = i - ws;
        u64 v = (src >= 0) ? t.w[src] : 0;
        if (bs)
        {
            v >>= bs;
            if (src - 1 >= 0) v |= t.w[src - 1] << (64 - bs);
        }
        out.w[i] = v;
    }
    return out;
}

template <int W>
Kmer<W> canonical_n(const Kmer<W>& a, int nbases)
{
    Kmer<W> rc = revcomp_n(a, nbases);
    return rc < a ? rc : a;
}

const char NUC[5] = "ACTG";  // A=0 C=1 T=2 G=3

// branchless char -> 2-bit code table (255 = invalid): a switch on random
// bases mispredicts ~every position and dominated the payload replay loop
struct CodeLut
{
    uint8_t v[256];
    CodeLut()
    {
        memset(v, 0xFF, sizeof(v));
        v['A'] = v['a'] = 0;
        v['C'] = v['c'] = 1;
        v['T'] = v['t'] = 2;
        v['G'] = v['g'] = 3;
    }
};
const CodeLut CODE_LUT;

struct Params
{
    int k;
    int max_repeat;
    int snp_min_val;
    int branching_threshold;
    uint8_t homo_only;
    uint8_t snp, deletion, small_homo, homo_insert, backup, hete_insert;
};

struct Stats
{
    long long homo_clean = 0, homo_fuzzy = 0, hetero_clean = 0, hetero_fuzzy = 0;
    long long fuzzy_deletion = 0, clean_deletion = 0, solo_snp = 0, multi_snp = 0;
    long long backup = 0, homo_clean_indel = 0, homo_fuzzy_indel = 0, hetero_indel = 0;
};

struct IScanner
{
    virtual ~IScanner() {}
    virtual void scan(const char* chrom_name, const char* chrom_seq, int64_t chrom_len,
                      int64_t n_pos, const uint8_t* valid, const u64* fwd,
                      const uint8_t* contains, const int32_t* nb_in, const int32_t* nb_out,
                      const uint8_t* suffix_rep, const uint8_t* prefix_rep,
                      const int64_t* bed, int64_t n_bed) = 0;
    // incremental packed-payload mode (the device qp/span packed streams):
    // begin resets per-sequence state; feed consumes payload entries and
    // replays every position whose pay[i] and pay[i+1] are both known.
    virtual void begin_sequence(const char* chrom_name, const char* chrom_seq,
                                int64_t chrom_len, const int64_t* bed, int64_t n_bed) = 0;
    virtual void feed_pay(const uint8_t* pay, const uint8_t* rep_bits,
                          const uint8_t* str_bits, int64_t n) = 0;
    virtual void feed_cls(const uint8_t* cls2, const uint16_t* exc16,
                          int64_t n_exc, int64_t n) = 0;
    std::string bkpt_out;
    std::string vcf_out;
    Stats stats;
};

inline int popcount4(unsigned b)
{
    return (int)(((b >> 0) & 1) + ((b >> 1) & 1) + ((b >> 2) & 1) + ((b >> 3) & 1));
}

// permute bitmap positions b -> b^2 (ops/extmap.py _shuffle02): the rc
// orientation transform of a 4-bit extension bitmap
inline unsigned shuffle02(unsigned b)
{
    return (((b >> 2) & 1) << 0) | (((b >> 3) & 1) << 1) | ((b & 1) << 2) | (((b >> 1) & 1) << 3);
}

template <int W>
struct Scanner : IScanner
{
    Params P;
    int RW;  // repeat-set row words = ceil((k-1)/32)
    const u64* solid;   // rows of W words
    int64_t n_solid;
    const u64* repeat;  // rows of RW words
    int64_t n_repeat;

    typedef Kmer<W> KM;

    // planes for the current sequence
    const uint8_t* valid;
    const u64* fwd;  // rows of W words
    const uint8_t* contains_p;
    const int32_t* nb_in_p;
    const int32_t* nb_out_p;
    const uint8_t* suffix_rep_p;
    const uint8_t* prefix_rep_p;
    const char* chrom_seq;
    int64_t chrom_len;
    std::string chrom_name;

    struct Info
    {
        KM kmer;
        int nb_in = 0;
        int nb_out = 0;
        bool is_repeated = false;
    };

    // scanner state
    long long breakpoint_id = 1;
    u64 position = 0;
    bool kmer_begin_valid = false, kmer_end_valid = false;
    KM kmer_begin_fwd, kmer_end_fwd;
    bool previous_valid = false;
    KM previous_fwd;
    u64 solid_stretch_size = 0, gap_stretch_size = 0;
    Info history[256];
    uint8_t het_begin_index = 0, het_end_index = 0;
    Info current_info;
    int recent_hetero = 0;
    bool kmer_end_is_repeated = false, kmer_begin_is_repeated = false;

    KM load_fwd(int64_t i) const
    {
        KM k;
        for (int j = 0; j < W; j++) k.w[j] = fwd[i * W + j];
        return k;
    }

    // ------- point queries ------------------------------------------------
    static bool member_rows(const u64* arr, int64_t n, int words, const u64* key)
    {
        int64_t lo = 0, hi = n;
        while (lo < hi)
        {
            int64_t mid = (lo + hi) >> 1;
            const u64* row = arr + mid * words;
            int cmp = 0;
            for (int j = 0; j < words; j++)
            {
                if (row[j] < key[j]) { cmp = -1; break; }
                if (row[j] > key[j]) { cmp = 1; break; }
            }
            if (cmp < 0) lo = mid + 1; else hi = mid;
        }
        if (lo >= n) return false;
        const u64* row = arr + lo * words;
        for (int j = 0; j < words; j++) if (row[j] != key[j]) return false;
        return true;
    }

    bool contains(const KM& kmer) const
    {
        KM c = canonical_n(kmer, P.k);
        return member_rows(solid, n_solid, W, c.w);
    }
    int nb_out_branch(const KM& kmer) const
    {
        int d = 0;
        for (u64 x = 0; x < 4; x++)
        {
            KM n = kmer;
            n.shl2();
            n.w[W - 1] |= x;
            n.mask_top(P.k);
            d += contains(n);
        }
        return d;
    }
    int nb_in_branch(const KM& kmer) const
    {
        int d = 0;
        for (u64 x = 0; x < 4; x++)
        {
            KM n = kmer;
            n.shr2();
            n.set2(2 * (P.k - 1), x);
            d += contains(n);
        }
        return d;
    }
    bool suffix_is_repeated(const KM& kmer) const
    {
        KM sfx = kmer;
        sfx.mask_top(P.k - 1);
        KM c = canonical_n(sfx, P.k - 1);
        // repeat rows are RW words; value < 2^(64*RW) so high words of c are 0
        return member_rows(repeat, n_repeat, RW, c.w + (W - RW));
    }

    std::string to_string(const KM& kmer) const
    {
        std::string s(P.k, 'A');
        for (int i = 0; i < P.k; i++) s[i] = NUC[kmer.get2(2 * (P.k - 1 - i))];
        return s;
    }
    static bool str_to_kmer(const char* s, int k, KM* out)
    {
        KM v;
        for (int i = 0; i < k; i++)
        {
            u64 c;
            switch (s[i])
            {
                case 'A': case 'a': c = 0; break;
                case 'C': case 'c': c = 1; break;
                case 'T': case 't': c = 2; break;
                case 'G': case 'g': c = 3; break;
                default: return false;
            }
            v.shl2();
            v.w[W - 1] |= c;
        }
        *out = v;
        return true;
    }
    bool code_seed_valid(int64_t offset) const
    {
        if (offset < 0 || offset + P.k > chrom_len) return false;
        KM tmp;
        return str_to_kmer(chrom_seq + offset, P.k, &tmp);
    }
    int count_leading_contained(const std::string& seq) const
    {
        int c = 0;
        int n = (int)seq.size() - P.k + 1;
        for (int i = 0; i < n; i++)
        {
            KM km;
            if (!str_to_kmer(seq.c_str() + i, P.k, &km)) return c;  // non-ACGT never contained
            if (!contains(km)) return c;
            c++;
        }
        return c;
    }
    bool seq_all_contained(const std::string& seq) const
    {
        int n = (int)seq.size() - P.k + 1;
        return count_leading_contained(seq) == n;
    }

    // ------- writers (formats from the python automaton) ------------------
    void write_breakpoint(long long id, const std::string& chrom, u64 pos, const std::string& kb,
                          const std::string& ke, int repeat_size, const char* type,
                          bool rep_begin, bool rep_end)
    {
        char buf[512];
        snprintf(buf, sizeof(buf), ">bkpt%lld_%s_pos_%llu_fuzzy_%i_%s %s left_kmer\n",
                 id, chrom.c_str(), (unsigned long long)(pos + 1), repeat_size, type,
                 rep_begin ? "REPEATED" : "");
        bkpt_out += buf;
        bkpt_out += kb;
        bkpt_out += '\n';
        snprintf(buf, sizeof(buf), ">bkpt%lld_%s_pos_%llu_fuzzy_%i_%s %s right_kmer\n",
                 id, chrom.c_str(), (unsigned long long)(pos + 1), repeat_size, type,
                 rep_end ? "REPEATED" : "");
        bkpt_out += buf;
        bkpt_out += ke;
        bkpt_out += '\n';
    }
    void write_vcf_variant(long long id, const std::string& chrom, u64 pos, const std::string& ref,
                           const std::string& alt, int repeat_size, const char* type)
    {
        int variant_size = 1;
        if (strcmp(type, "DEL") == 0) variant_size = (int)ref.size() - 1;
        char buf[256];
        vcf_out += chrom;
        snprintf(buf, sizeof(buf), "\t%llu\tbkpt%lld\t", (unsigned long long)(pos + 1), id);
        vcf_out += buf;
        vcf_out += ref;
        vcf_out += '\t';
        vcf_out += alt;
        snprintf(buf, sizeof(buf), "\t.\tPASS\tTYPE=%s;LEN=%i;FUZZY=%i\tGT\t1/1\n",
                 type, variant_size, repeat_size);
        vcf_out += buf;
    }
    void write_indel(long long id, const std::string& chrom, u64 pos, const std::string& ref,
                     const std::string& alt, int repeat_size, const char* type)
    {
        int variant_size = (int)alt.size() - 1;
        const char* gt = strcmp(type, "HOM") == 0 ? "1/1" : (strcmp(type, "HET") == 0 ? "0/1" : "./.");
        char buf[256];
        vcf_out += chrom;
        snprintf(buf, sizeof(buf), "\t%llu\tbkpt%lld\t", (unsigned long long)(pos + 1), id);
        vcf_out += buf;
        vcf_out += ref;
        vcf_out += '\t';
        vcf_out += alt;
        snprintf(buf, sizeof(buf), "\t.\tPASS\tTYPE=INS;LEN=%i;FUZZY=%i\tGT\t%s\n",
                 variant_size, repeat_size, gt);
        vcf_out += buf;
    }

    // ------- SNP machinery -------------------------------------------------
    KM mutate_kmer(const KM& kmer, u64 nuc, int pos) const
    {
        KM m = kmer;
        m.set2(2 * (P.k - pos), nuc);
        return m;
    }

    bool snp_at_end(uint8_t* beginpos, int limit, u64* ret_nuc, u64* ref_nuc, int* nb_val)
    {
        std::map<u64, int> nuc = {{0, 0}, {1, 0}, {2, 0}, {3, 0}};
        uint8_t beginpos_init = *beginpos;
        *ref_nuc = (u64)history[*beginpos].kmer.get2(0);
        nuc.erase(*ref_nuc);
        bool end = false;
        for (int j = 0; !end && j != P.k; (*beginpos)++, j++)
        {
            for (auto it = nuc.begin(); it != nuc.end();)
            {
                KM correct = mutate_kmer(history[*beginpos].kmer, it->first, P.k - j);
                if (contains(correct)) { it->second++; ++it; }
                else
                {
                    if (nuc.size() == 1) { end = true; (*beginpos)--; break; }
                    it = nuc.erase(it);
                }
            }
        }
        u64 best = nuc.begin()->first;
        for (auto& kv : nuc) if (kv.second > nuc[best]) best = kv.first;
        if (nuc[best] >= limit) { *ret_nuc = best; *nb_val = nuc[best]; return true; }
        *beginpos = beginpos_init;
        *nb_val = 0;
        return false;
    }

    bool snp_at_begin(uint8_t* beginpos, int limit, u64* ret_nuc, u64* ref_nuc, int* nb_val)
    {
        std::map<u64, int> nuc = {{0, 0}, {1, 0}, {2, 0}, {3, 0}};
        uint8_t beginpos_init = *beginpos;
        *ref_nuc = (u64)history[*beginpos].kmer.get2(2 * (P.k - 1));
        nuc.erase(*ref_nuc);
        bool end = false;
        for (int j = 0; !end && j != P.k; (*beginpos)--, j++)
        {
            for (auto it = nuc.begin(); it != nuc.end();)
            {
                KM correct = mutate_kmer(history[*beginpos].kmer, it->first, j + 1);
                if (contains(correct)) { it->second++; ++it; }
                else
                {
                    if (nuc.size() == 1) { end = true; (*beginpos)++; break; }
                    it = nuc.erase(it);
                }
            }
        }
        u64 best = nuc.begin()->first;
        for (auto& kv : nuc) if (kv.second > nuc[best]) best = kv.first;
        if (nuc[best] >= limit) { *ret_nuc = best; *nb_val = nuc[best]; return true; }
        *beginpos = beginpos_init;
        *nb_val = 0;
        return false;
    }

    void correct_history(uint8_t pos, u64 nuc)
    {
        for (int i = 0; i != P.k; i++)
        {
            uint8_t index = (uint8_t)(i + pos);
            KM mutated = mutate_kmer(history[index].kmer, nuc, P.k - i);
            history[index].kmer = mutated;
            if (contains(mutated))
            {
                history[index].nb_in = nb_in_branch(mutated);
                history[index].nb_out = nb_out_branch(mutated);
                history[index].is_repeated = suffix_is_repeated(mutated);
            }
        }
    }

    // ------- observers -----------------------------------------------------
    bool obs_solo_snp()
    {
        if (!(kmer_begin_valid && kmer_end_valid)) return false;
        if (gap_stretch_size == (u64)P.k)
        {
            uint8_t pos = (uint8_t)(het_begin_index - 1);
            uint8_t save_index = pos;
            u64 nuc, ref_nuc;
            int nb;
            if (snp_at_end(&pos, P.k, &nuc, &ref_nuc, &nb))
            {
                correct_history(save_index, nuc);
                write_vcf_variant(breakpoint_id, chrom_name, position - 2,
                                  std::string(1, NUC[ref_nuc]), std::string(1, NUC[nuc]), 0, "SNP");
                breakpoint_id++;
                stats.solo_snp++;
                return true;
            }
        }
        return false;
    }

    bool obs_multi_snp()
    {
        if (!(kmer_begin_valid && kmer_end_valid)) return false;
        int kt = P.snp_min_val;
        if (gap_stretch_size > (u64)(P.k + kt))
        {
            u64 begin_pos = position - 1 - gap_stretch_size + P.k - 1;
            u64 begin_pos_init = begin_pos;
            uint8_t index_end = (uint8_t)(het_begin_index + P.k - 1);
            uint8_t index_pos = (uint8_t)(index_end - gap_stretch_size);
            while (index_pos != index_end)
            {
                uint8_t save_index = index_pos;
                u64 nuc, ref_nuc;
                int nb_val;
                if (snp_at_end(&index_pos, kt, &nuc, &ref_nuc, &nb_val))
                {
                    if (begin_pos + (u64)nb_val - begin_pos_init > gap_stretch_size) break;
                    correct_history(save_index, nuc);
                    write_vcf_variant(breakpoint_id, chrom_name, begin_pos,
                                      std::string(1, NUC[ref_nuc]), std::string(1, NUC[nuc]), 0, "SNP");
                    breakpoint_id++;
                    stats.multi_snp++;
                    begin_pos += (u64)nb_val;
                }
                else break;
            }
            u64 nb_correct = begin_pos - begin_pos_init;
            if (nb_correct == 0) return false;
            if (nb_correct != gap_stretch_size)
            {
                gap_stretch_size -= nb_correct;
                solid_stretch_size += nb_correct;
                kmer_begin_fwd = history[(uint8_t)(index_pos - 1)].kmer;
                kmer_begin_valid = true;
                return false;
            }
            return true;
        }
        return false;
    }

    bool obs_multi_snp_rev()
    {
        if (!(kmer_begin_valid && kmer_end_valid)) return false;
        int kt = P.snp_min_val;
        if (gap_stretch_size > (u64)(P.k + kt))
        {
            u64 begin_pos = position - 2;
            u64 begin_pos_init = begin_pos;
            uint8_t index_limit = (uint8_t)(het_end_index - 2 - gap_stretch_size);
            uint8_t index_pos = (uint8_t)(het_end_index - 2);
            while (index_pos != index_limit)
            {
                uint8_t save_index = index_pos;
                u64 nuc, ref_nuc;
                int nb_val;
                if (snp_at_begin(&index_pos, kt, &nuc, &ref_nuc, &nb_val))
                {
                    if (begin_pos_init - (begin_pos - (u64)nb_val) > gap_stretch_size) break;
                    correct_history((uint8_t)(save_index - (P.k - 1)), nuc);
                    write_vcf_variant(breakpoint_id, chrom_name, begin_pos,
                                      std::string(1, NUC[ref_nuc]), std::string(1, NUC[nuc]), 0, "SNP");
                    breakpoint_id++;
                    stats.multi_snp++;
                    begin_pos -= (u64)nb_val;
                }
                else break;
            }
            u64 nb_correct = begin_pos_init - begin_pos;
            if (nb_correct == 0) return false;
            if (nb_correct != gap_stretch_size)
            {
                position -= nb_correct;
                het_end_index = (uint8_t)(het_end_index - nb_correct);
                het_begin_index = (uint8_t)(het_begin_index - nb_correct);
                gap_stretch_size -= nb_correct;
                kmer_end_fwd = history[(uint8_t)(index_pos + 1)].kmer;
                kmer_end_valid = true;
                return false;
            }
            return true;
        }
        return false;
    }

    unsigned fuzzy_site(const std::string& begin, const std::string& end) const
    {
        for (unsigned i = P.max_repeat; i != 0; i--)
            for (unsigned j = 1;; j++)
            {
                size_t blen = begin.size();
                std::string bs = begin.substr(blen - i, j);  // clamps like C++ substr
                std::string es = end.substr(0, j);
                if (bs != es) break;
                if (i == j) return j;
            }
        return 0;
    }

    bool obs_deletion()
    {
        if (!(kmer_begin_valid && kmer_end_valid)) return false;
        if (gap_stretch_size < (u64)(P.k - P.max_repeat)) return false;
        std::string begin = to_string(kmer_begin_fwd);
        std::string end = to_string(kmer_end_fwd);
        unsigned repeat_size = fuzzy_site(begin, end);
        if (repeat_size > (unsigned)P.max_repeat) return false;
        if (repeat_size != 0) begin = begin.substr(0, begin.size() - repeat_size);
        int del_size = (int)gap_stretch_size - P.k + (int)repeat_size + 1;
        std::string seq = begin + end;
        bool is_deletion = seq_all_contained(seq);
        if (!is_deletion)
        {
            if (repeat_size == 0) return false;
            seq = to_string(kmer_begin_fwd) + end;
            if (!seq_all_contained(seq)) return false;
            del_size -= (int)repeat_size;
            repeat_size = 0;
        }
        if (del_size <= 0) return false;
        u64 del_start_pos = position - 2 - (u64)del_size;
        // mirror the python slice semantics on out-of-range starts
        std::string del_sequence =
            (del_start_pos + (u64)del_size + 1 <= (u64)chrom_len)
                ? std::string(chrom_seq + del_start_pos, (size_t)(del_size + 1))
                : std::string();
        std::string alt = del_sequence.substr(0, del_sequence.empty() ? 0 : 1);
        write_vcf_variant(breakpoint_id, chrom_name, del_start_pos, del_sequence, alt,
                          (int)repeat_size, "DEL");
        breakpoint_id++;
        if (repeat_size != 0) stats.fuzzy_deletion++; else stats.clean_deletion++;
        return true;
    }

    // 1-2bp micro insertions (src/FindSmallInsertion.hpp candidate list)
    bool micro_assembly(const std::string& kb, const std::string& ke, const std::string& ref,
                        std::string* alt) const
    {
        static const char* NUCLEO[20] = {"A","C","G","T","AA","AC","AG","AT","CA","CC","CG","CT",
                                         "GA","GC","GG","GT","TA","TC","TG","TT"};
        for (int i = 0; i < 20; i++)
        {
            std::string seq = kb + NUCLEO[i] + ke;
            if (count_leading_contained(seq) >= P.k)
            {
                *alt = ref + NUCLEO[i];
                return true;
            }
        }
        return false;
    }

    bool obs_small_clean()
    {
        if (!(kmer_begin_valid && kmer_end_valid)) return false;
        if (gap_stretch_size == (u64)(P.k - 1))
        {
            std::string kb = to_string(kmer_begin_fwd);
            std::string ke = to_string(kmer_end_fwd);
            std::string ref = kb.substr(kb.size() - 1, 1);
            std::string alt;
            if (!micro_assembly(kb, ke, ref, &alt)) return false;
            write_indel(breakpoint_id, chrom_name, position - 2, ref, alt, 0, "HOM");
            stats.homo_clean_indel++;
            breakpoint_id++;
            return true;
        }
        return false;
    }

    bool obs_small_fuzzy()
    {
        if (!(kmer_begin_valid && kmer_end_valid)) return false;
        if (gap_stretch_size < (u64)(P.k - 1) &&
            gap_stretch_size >= (u64)(P.k - 1 - P.max_repeat))
        {
            int repeat_size = P.k - 1 - (int)gap_stretch_size;
            std::string kb = to_string(kmer_begin_fwd);
            int64_t off = (int64_t)position - 1 + repeat_size;
            if (nb_out_branch(kmer_begin_fwd) == 0 || nb_in_branch(kmer_end_fwd) == 0 ||
                !code_seed_valid(off))
                return false;
            std::string ke(chrom_seq + off, (size_t)P.k);
            std::string ref = kb.substr(kb.size() - 1 - repeat_size, 1);
            std::string alt;
            if (!micro_assembly(kb, ke, ref, &alt)) return false;
            write_indel(breakpoint_id, chrom_name, position - 2, ref, alt, repeat_size, "HOM");
            stats.homo_clean_indel++;
            breakpoint_id++;
            return true;
        }
        return false;
    }

    bool obs_clean_insertion()
    {
        if (!(kmer_begin_valid && kmer_end_valid)) return false;
        if (gap_stretch_size == (u64)(P.k - 1))
        {
            std::string kb = to_string(kmer_begin_fwd);
            std::string ke = to_string(kmer_end_fwd);
            if (nb_out_branch(kmer_begin_fwd) == 0 || nb_in_branch(kmer_end_fwd) == 0) return false;
            write_breakpoint(breakpoint_id, chrom_name, position - 2, kb, ke, 0, "HOM",
                             kmer_begin_is_repeated, kmer_end_is_repeated);
            breakpoint_id++;
            stats.homo_clean++;
            return true;
        }
        return false;
    }

    bool obs_fuzzy_insertion()
    {
        if (!(kmer_begin_valid && kmer_end_valid)) return false;
        if (gap_stretch_size < (u64)(P.k - 1) &&
            gap_stretch_size >= (u64)(P.k - 1 - P.max_repeat))
        {
            int repeat_size = P.k - 1 - (int)gap_stretch_size;
            std::string kb = to_string(kmer_begin_fwd);
            int64_t off = (int64_t)position - 1 + repeat_size;
            if (nb_out_branch(kmer_begin_fwd) == 0 || nb_in_branch(kmer_end_fwd) == 0 ||
                !code_seed_valid(off))
                return false;
            std::string ke(chrom_seq + off, (size_t)P.k);
            write_breakpoint(breakpoint_id, chrom_name, position - 2 + repeat_size, kb, ke,
                             repeat_size, "HOM", kmer_begin_is_repeated, kmer_end_is_repeated);
            breakpoint_id++;
            stats.homo_fuzzy++;
            return true;
        }
        return false;
    }

    bool obs_backup()
    {
        if (!(kmer_begin_valid && kmer_end_valid)) return false;
        if (gap_stretch_size > (u64)(P.k / 2))
        {
            std::string kb = to_string(kmer_begin_fwd);
            std::string ke = to_string(kmer_end_fwd);
            std::string chrom_bak = chrom_name + "_backup";
            write_breakpoint(breakpoint_id, chrom_bak, position - 1, kb, ke, 0, "BACKUP",
                             false, false);
            breakpoint_id++;
            stats.backup++;
            return true;
        }
        return false;
    }

    bool obs_hetero()
    {
        if (P.homo_only) return false;
        int branching_threshold = P.branching_threshold;
        int max_branching = branching_threshold;
        bool filtering = true;
        if (branching_threshold < 0) { filtering = false; max_branching = 100; }
        const int filter_window = 100;

        if (!kmer_end_is_repeated && current_info.nb_in == 2 && !recent_hetero)
        {
            for (int i = 0; i <= P.max_repeat; i++)
            {
                Info& hist_i = history[(uint8_t)(het_begin_index + i)];
                if (hist_i.nb_out == 2 && !hist_i.is_repeated)
                {
                    std::string kb = to_string(hist_i.kmer);
                    int64_t off = (int64_t)position + i;
                    if (!code_seed_valid(off)) return false;
                    std::string ke(chrom_seq + off, (size_t)P.k);
                    std::string ref = kb.substr(kb.size() - 1 - i, 1);
                    std::string alt;
                    bool found = micro_assembly(kb, ke, ref, &alt);
                    if (found)
                    {
                        write_indel(breakpoint_id, chrom_name, position - 1, ref, alt, i, "HET");
                        stats.hetero_indel++;
                        breakpoint_id++;
                        return true;
                    }
                    int nb_branching = 0;
                    if (filtering)
                    {
                        int nb_prev = 0;
                        uint8_t begin_index = (uint8_t)(het_begin_index - 1);
                        while (nb_branching <= max_branching && nb_prev < filter_window)
                        {
                            Info& h = history[(uint8_t)(begin_index - nb_prev)];
                            if (h.nb_out > 1 || h.nb_in > 1) nb_branching++;
                            nb_prev++;
                        }
                    }
                    if (nb_branching <= max_branching)
                    {
                        write_breakpoint(breakpoint_id, chrom_name, position - 1 + i, kb, ke, i,
                                         "HET", hist_i.is_repeated, kmer_end_is_repeated);
                        breakpoint_id++;
                        if (i == 0) stats.hetero_clean++; else stats.hetero_fuzzy++;
                        recent_hetero = P.max_repeat;
                        return true;
                    }
                    else
                    {
                        recent_hetero = recent_hetero > 0 ? recent_hetero - 1 : 0;
                        return false;
                    }
                }
            }
        }
        recent_hetero = recent_hetero > 0 ? recent_hetero - 1 : 0;
        return false;
    }

    // ------- notify / scan -------------------------------------------------
    // per-position plane values, decoupled from their source (plane arrays
    // or the packed payload stream)
    struct PosPlanes
    {
        KM fwd;
        bool contains;
        int nb_in, nb_out;
        bool sfx_rep, pfx_rep;
    };

    void store_kmer_info(const PosPlanes& p)
    {
        current_info.kmer = p.fwd;
        current_info.nb_in = p.nb_in;
        current_info.nb_out = p.nb_out;
        current_info.is_repeated = p.sfx_rep;
        history[het_end_index] = current_info;
        kmer_end_is_repeated = p.pfx_rep;
    }

    void gap_observers()
    {
        if (P.snp)
        {
            if (obs_solo_snp()) return;
            if (obs_multi_snp()) return;
            if (obs_multi_snp_rev()) return;
        }
        if (P.deletion && obs_deletion()) return;
        if (P.small_homo)
        {
            if (obs_small_clean()) return;
            if (obs_small_fuzzy()) return;
        }
        if (P.homo_insert)
        {
            if (obs_clean_insertion()) return;
            if (obs_fuzzy_insertion()) return;
        }
        if (P.backup && obs_backup()) return;
    }

    void notify(const PosPlanes& p)
    {
        bool in_graph = p.contains;
        store_kmer_info(p);
        if (P.hete_insert) obs_hetero();
        if (in_graph)
        {
            solid_stretch_size++;
            if (solid_stretch_size > 1 && gap_stretch_size > 0)
            {
                gap_observers();
                gap_stretch_size = 0;
            }
            if (solid_stretch_size == 1)
            {
                kmer_end_fwd = p.fwd;
                kmer_end_valid = true;
            }
        }
        else
        {
            if (solid_stretch_size == 1) gap_stretch_size += solid_stretch_size;
            if (solid_stretch_size > 1 && previous_valid)
            {
                kmer_begin_fwd = previous_fwd;
                kmer_begin_valid = true;
                kmer_begin_is_repeated = current_info.is_repeated;
            }
            gap_stretch_size++;
            solid_stretch_size = 0;
        }
    }

    // per-sequence iteration state shared by both scan modes (bed intervals
    // copied so the caller's buffer need not outlive begin_sequence)
    bool bed_mode = false, bed_done = false;
    int64_t bed_pairs = 0, bed_i = 0;
    u64 bed_start = 0, bed_end = 0;
    std::vector<int64_t> bed_v;

    // one position of the reference FindBreakpoints iteration
    // (src/FindBreakpoints.hpp:390-554), including the BED-restricted
    // variant's interval advance + state resets
    void step_position(bool is_valid, const PosPlanes& p)
    {
        if (bed_mode)
        {
            if (bed_done) { position++; het_begin_index++; het_end_index++; return; }
            if (position >= bed_end)
            {
                bed_i++;
                if (bed_i >= bed_pairs)
                {
                    bed_done = true;
                    position++; het_begin_index++; het_end_index++;
                    return;
                }
                bed_start = (u64)bed_v[2 * bed_i];
                bed_end = (u64)bed_v[2 * bed_i + 1];
            }
            if (!is_valid)
            {
                solid_stretch_size = 0;
                gap_stretch_size = 0;
                kmer_begin_valid = kmer_end_valid = false;
            }
            if (position == bed_start - 1)
            {
                solid_stretch_size = 0;
                gap_stretch_size = 0;
                kmer_begin_valid = kmer_end_valid = false;
                for (int q = 0; q < 256; q++) history[q] = Info();
            }
            if (is_valid && position >= bed_start)
            {
                u64 save_position = position;
                notify(p);
                position = save_position;
                previous_fwd = p.fwd;
                previous_valid = true;
            }
        }
        else
        {
            if (!is_valid)
            {
                solid_stretch_size = 0;
                gap_stretch_size = 0;
                kmer_begin_valid = kmer_end_valid = false;
            }
            else
            {
                u64 save_position = position;
                notify(p);
                position = save_position;
                previous_fwd = p.fwd;
                previous_valid = true;
            }
        }
        position++;
        het_begin_index++;
        het_end_index++;
    }

    void begin_sequence(const char* name, const char* seq, int64_t seq_len,
                        const int64_t* bed, int64_t n_bed) override
    {
        chrom_name = name;
        chrom_seq = seq;
        chrom_len = seq_len;

        kmer_begin_valid = kmer_end_valid = false;
        previous_valid = false;
        solid_stretch_size = gap_stretch_size = 0;
        for (int q = 0; q < 256; q++) history[q] = Info();
        het_end_index = (uint8_t)((P.k + 1) & 255);
        het_begin_index = 1;
        recent_hetero = 0;
        position = 0;

        bed_mode = n_bed >= 0;
        bed_done = (n_bed == 0);
        bed_pairs = n_bed > 0 ? n_bed / 2 : 0;
        bed_i = 0;
        bed_v.assign(bed, bed + (n_bed > 0 ? n_bed : 0));
        if (bed_pairs) { bed_start = (u64)bed_v[0]; bed_end = (u64)bed_v[1]; }

        // packed-payload mode rolling state
        pay_fed = 0;
        n_pos_seq = seq_len - P.k + 1;
        rolled_to = 0;
        last_bad = -1;
        cur_last_code = 0;
        roll_fwd = KM();
    }

    // ------- packed-payload feed (device qp / span packed streams) ---------
    int64_t pay_fed = 0;       // global payload index of the next entry
    int64_t n_pos_seq = 0;     // positions in this sequence
    int64_t rolled_to = 0;     // next base index to ingest into roll_fwd
    int64_t last_bad = -1;     // most recent non-ACGT base index
    int cur_last_code = 0;     // 2-bit code of the last ingested base (0 if bad)
    KM roll_fwd;
    uint8_t carry_pay = 0;
    bool carry_rep = false, carry_str = true;

    void ingest_base(int64_t b)
    {
        uint8_t c = CODE_LUT.v[(uint8_t)chrom_seq[b]];
        last_bad = (c & 0x80) ? b : last_bad;   // cmov, no branch
        u64 cv = (c & 0x80) ? 0 : c;            // invalid contributes 0 (plane-path parity)
        roll_fwd.shl2();
        roll_fwd.w[W - 1] |= cv;
        roll_fwd.mask_top(P.k);
        cur_last_code = (int)cv;
    }

    // position i from payloads of q_i (carried) and q_{i+1} (current):
    // the planes_from_pay / planes_from_pay_span math, one position at a
    // time (find/scan_device.py:421-448, 240-269)
    void pay_position(int64_t i, uint8_t pay_i, bool rep_i, bool str_i,
                      uint8_t pay_i1, bool rep_i1, bool str_i1)
    {
        while (rolled_to < i + P.k) ingest_base(rolled_to++);
        bool is_valid = last_bad < i;
        unsigned ext_i, pre_i, ext_i1;
        if (str_i) { ext_i = pay_i & 0xF; pre_i = (pay_i >> 4) & 0xF; }
        else { ext_i = shuffle02((pay_i >> 4) & 0xF); pre_i = shuffle02(pay_i & 0xF); }
        ext_i1 = str_i1 ? (pay_i1 & 0xF) : shuffle02((pay_i1 >> 4) & 0xF);
        PosPlanes p;
        p.fwd = roll_fwd;
        p.contains = ((ext_i >> cur_last_code) & 1) != 0;
        p.nb_out = p.contains ? popcount4(ext_i1) : 0;
        p.nb_in = p.contains ? popcount4(pre_i) : 0;
        p.sfx_rep = rep_i1;
        p.pfx_rep = rep_i;
        step_position(is_valid, p);
    }

    void feed_pay(const uint8_t* pay, const uint8_t* rep_bits,
                  const uint8_t* str_bits, int64_t n) override
    {
        // entries are global payload indices [pay_fed, pay_fed + n);
        // rep/str bit t (big-endian per byte, np.unpackbits order) belongs
        // to this chunk's local entry t. str_bits == NULL means payloads
        // are pre-oriented (the qp pair map) — strand reads as canonical.
        for (int64_t t = 0; t < n; t++)
        {
            int64_t g = pay_fed + t;
            if (g > n_pos_seq) break;  // ignore window padding past the end
            uint8_t p_cur = pay[t];
            bool r_cur = ((rep_bits[t >> 3] >> (7 - (t & 7))) & 1) != 0;
            bool s_cur = str_bits ? (((str_bits[t >> 3] >> (7 - (t & 7))) & 1) != 0) : true;
            if (g > 0)
                pay_position(g - 1, carry_pay, carry_rep, carry_str, p_cur, r_cur, s_cur);
            carry_pay = p_cur;
            carry_rep = r_cur;
            carry_str = s_cur;
        }
        pay_fed += n;
    }

    void feed_cls(const uint8_t* cls2, const uint16_t* exc16,
                  int64_t n_exc, int64_t n) override
    {
        // reference-delta stream (find/scan_device.py scan_cls_device_qp):
        // class 0 payloads are reconstructed from the sequence's own
        // continuation (the device only emits 0 where both adjacent bases
        // were real in ITS window view, so the chars here are real bases);
        // class 1 is the zero payload; class 2 pops the next exception.
        int64_t e = 0;
        (void)n_exc;
        for (int64_t t = 0; t < n; t++)
        {
            int64_t g = pay_fed + t;
            if (g > n_pos_seq) break;
            unsigned cls = (cls2[t >> 2] >> (2 * (t & 3))) & 3;
            unsigned pay16;
            if (cls == 0 || cls == 3)
            {
                unsigned hi = base_code(chrom_seq[g + P.k - 1]);
                unsigned lo = base_code(chrom_seq[g - 1]);
                pay16 = (1u << hi) | ((1u << lo) << 4) | (cls == 3 ? 0x100u : 0u);
            }
            else if (cls == 1) pay16 = 0;
            else pay16 = exc16[e++];
            uint8_t p_cur = (uint8_t)(pay16 & 0xFF);
            bool r_cur = (pay16 >> 8) & 1;
            if (g > 0)
                pay_position(g - 1, carry_pay, carry_rep, carry_str, p_cur, r_cur, true);
            carry_pay = p_cur;
            carry_rep = r_cur;
            carry_str = true;
        }
        pay_fed += n;
    }

    static unsigned base_code(char ch)
    {
        // cls 0/3 entries are only emitted where the device saw real bases
        return CODE_LUT.v[(uint8_t)ch] & 3;
    }

    void scan(const char* name, const char* seq, int64_t seq_len, int64_t n,
              const uint8_t* valid_p, const u64* fwd_p, const uint8_t* contains_pl,
              const int32_t* nb_in_pl, const int32_t* nb_out_pl, const uint8_t* suffix_rep_pl,
              const uint8_t* prefix_rep_pl, const int64_t* bed, int64_t n_bed) override
    {
        valid = valid_p;
        fwd = fwd_p;
        contains_p = contains_pl;
        nb_in_p = nb_in_pl;
        nb_out_p = nb_out_pl;
        suffix_rep_p = suffix_rep_pl;
        prefix_rep_p = prefix_rep_pl;

        begin_sequence(name, seq, seq_len, bed, n_bed);

        for (int64_t i = 0; i < n; i++)
        {
            if (bed_mode && bed_done) break;
            PosPlanes p;
            bool is_valid = valid[i] != 0;
            if (is_valid)
            {
                p.fwd = load_fwd(i);
                p.contains = contains_p[i] != 0;
                p.nb_in = nb_in_p[i];
                p.nb_out = nb_out_p[i];
                p.sfx_rep = suffix_rep_p[i] != 0;
                p.pfx_rep = prefix_rep_p[i] != 0;
            }
            else
            {
                p = PosPlanes{KM(), false, 0, 0, false, false};
            }
            step_position(is_valid, p);
        }
    }
};

template <int W>
IScanner* make_scanner(const Params& P, const u64* solid, int64_t n_solid,
                       const u64* repeat, int64_t n_repeat)
{
    Scanner<W>* s = new Scanner<W>();
    s->P = P;
    s->RW = (P.k - 1 + 31) / 32;
    s->solid = solid;
    s->n_solid = n_solid;
    s->repeat = repeat;
    s->n_repeat = n_repeat;
    return s;
}

}  // namespace

extern "C" {

// words: uint64 words per kmer row (ceil(k/32)); solid rows are `words` wide,
// repeat rows ceil((k-1)/32) wide. words=1 keeps the historical layout.
void* scanner_create_span(int k, int words, int max_repeat, int snp_min_val,
                          int branching_threshold, uint8_t homo_only, uint8_t snp,
                          uint8_t deletion, uint8_t small_homo, uint8_t homo_insert,
                          uint8_t backup, uint8_t hete_insert, const u64* solid,
                          int64_t n_solid, const u64* repeat, int64_t n_repeat)
{
    Params P{k, max_repeat, snp_min_val, branching_threshold, homo_only,
             snp, deletion, small_homo, homo_insert, backup, hete_insert};
    switch (words)
    {
        case 1: return make_scanner<1>(P, solid, n_solid, repeat, n_repeat);
        case 2: return make_scanner<2>(P, solid, n_solid, repeat, n_repeat);
        case 3: return make_scanner<3>(P, solid, n_solid, repeat, n_repeat);
        case 4: return make_scanner<4>(P, solid, n_solid, repeat, n_repeat);
        case 5: return make_scanner<5>(P, solid, n_solid, repeat, n_repeat);
        case 6: return make_scanner<6>(P, solid, n_solid, repeat, n_repeat);
        case 7: return make_scanner<7>(P, solid, n_solid, repeat, n_repeat);
        case 8: return make_scanner<8>(P, solid, n_solid, repeat, n_repeat);
        default: return nullptr;
    }
}

void* scanner_create(int k, int max_repeat, int snp_min_val, int branching_threshold,
                     uint8_t homo_only, uint8_t snp, uint8_t deletion, uint8_t small_homo,
                     uint8_t homo_insert, uint8_t backup, uint8_t hete_insert,
                     const u64* solid, int64_t n_solid, const u64* repeat, int64_t n_repeat)
{
    return scanner_create_span(k, 1, max_repeat, snp_min_val, branching_threshold, homo_only,
                               snp, deletion, small_homo, homo_insert, backup, hete_insert,
                               solid, n_solid, repeat, n_repeat);
}

void scanner_scan_sequence(void* h, const char* chrom_name, const char* chrom_seq,
                           int64_t chrom_len, int64_t n_pos, const uint8_t* valid,
                           const u64* fwd, const uint8_t* contains, const int32_t* nb_in,
                           const int32_t* nb_out, const uint8_t* suffix_rep,
                           const uint8_t* prefix_rep, const int64_t* bed, int64_t n_bed)
{
    ((IScanner*)h)->scan(chrom_name, chrom_seq, chrom_len, n_pos, valid, fwd, contains,
                         nb_in, nb_out, suffix_rep, prefix_rep, bed, n_bed);
}

// Packed-payload mode: begin a sequence, then feed the fused payload byte
// stream (+ bit-packed repeat and optional strand planes) in chunks; every
// position is replayed as soon as its pay[i]/pay[i+1] pair is known, so the
// host overlaps this with the next window's device compute. Output is
// byte-identical to scanner_scan_sequence over expanded planes.
void scanner_begin_sequence(void* h, const char* chrom_name, const char* chrom_seq,
                            int64_t chrom_len, const int64_t* bed, int64_t n_bed)
{
    ((IScanner*)h)->begin_sequence(chrom_name, chrom_seq, chrom_len, bed, n_bed);
}

void scanner_feed_pay(void* h, const uint8_t* pay, const uint8_t* rep_bits,
                      const uint8_t* str_bits, int64_t n)
{
    ((IScanner*)h)->feed_pay(pay, rep_bits, str_bits, n);
}

void scanner_feed_cls(void* h, const uint8_t* cls2, const uint16_t* exc16,
                      int64_t n_exc, int64_t n)
{
    ((IScanner*)h)->feed_cls(cls2, exc16, n_exc, n);
}

int64_t scanner_bkpt_size(void* h) { return (int64_t)((IScanner*)h)->bkpt_out.size(); }
int64_t scanner_vcf_size(void* h) { return (int64_t)((IScanner*)h)->vcf_out.size(); }
const char* scanner_bkpt(void* h) { return ((IScanner*)h)->bkpt_out.c_str(); }
const char* scanner_vcf(void* h) { return ((IScanner*)h)->vcf_out.c_str(); }

void scanner_stats(void* h, long long* out12)
{
    Stats& st = ((IScanner*)h)->stats;
    long long vals[12] = {st.homo_clean, st.homo_fuzzy, st.hetero_clean, st.hetero_fuzzy,
                          st.fuzzy_deletion, st.clean_deletion, st.solo_snp, st.multi_snp,
                          st.backup, st.homo_clean_indel, st.homo_fuzzy_indel, st.hetero_indel};
    memcpy(out12, vals, sizeof(vals));
}

void scanner_free(void* h) { delete (IScanner*)h; }

}  // extern "C"
