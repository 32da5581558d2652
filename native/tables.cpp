// Native membership-table builder: sequential 2-choice cuckoo insertion with
// random-walk eviction. The vectorized numpy build in ops/extmap.py works but
// converges slowly near the load threshold on tens of millions of keys; the
// sequential walk is O(n) with small constants (~10M inserts/s).
//
// Built on first use by mindthegap_tpu/utils/native_build.py (g++ -O3 -shared -fPIC),
// into native/libtables-<hash of source, flags and compiler>.so.

#include <cstdint>
#include <cstring>

namespace {

typedef uint64_t u64;

const u64 EMPTY = 0xFFFFFFFFFFFFFFFFULL;
const u64 H1 = 0x9E3779B97F4A7C15ULL;
const u64 H2 = 0xC2B2AE3D27D4EB4FULL;

inline u64 mix(u64 x, u64 c)
{
    u64 h = (x ^ (x >> 33)) * c;
    return h ^ (h >> 29);
}

}  // namespace

extern "C" {

// Places keys/values into table/payload (both pre-filled by caller: table
// with EMPTY, payload with 0). Returns the stash size (keys that could not
// be placed within the walk budget), or -1 if it exceeds max_stash.
// slot_choice scratch must hold (1 << log_size) bytes.
int64_t extmap_place(const u64* keys, const uint8_t* values, int64_t n, int log_size,
                     u64* table, uint8_t* payload, uint8_t* slot_choice,
                     u64* stash_keys, uint8_t* stash_vals, int64_t max_stash)
{
    const int shift = 64 - log_size;
    u64 rng = 0x853C49E6748FEA9BULL;
    int64_t n_stash = 0;

    for (int64_t i = 0; i < n; i++)
    {
        u64 cur = keys[i];
        uint8_t val = values ? values[i] : 1;
        int choice = 0;
        bool placed = false;
        for (int step = 0; step < 1000; step++)
        {
            u64 slot = mix(cur, choice == 0 ? H1 : H2) >> shift;
            if (table[slot] == EMPTY)
            {
                table[slot] = cur;
                payload[slot] = val;
                slot_choice[slot] = (uint8_t)choice;
                placed = true;
                break;
            }
            // evict the occupant, continue with it on its other hash (or a
            // random one to break cycles)
            u64 old_key = table[slot];
            uint8_t old_val = payload[slot];
            int old_choice = slot_choice[slot];
            table[slot] = cur;
            payload[slot] = val;
            slot_choice[slot] = (uint8_t)choice;
            cur = old_key;
            val = old_val;
            rng = rng * 6364136223846793005ULL + 1442695040888963407ULL;
            choice = (old_choice + 1 + (int)((rng >> 60) & 1) * 0) % 2;
        }
        if (!placed)
        {
            if (n_stash >= max_stash) return -1;
            stash_keys[n_stash] = cur;
            stash_vals[n_stash] = val;
            n_stash++;
        }
    }
    return n_stash;
}

// ---------------------------------------------------------------------------
// Fused quotient-map builder (ops/extmap.py build_fused): derives the
// (k-1)-mer extension bitmap pairs from the canonical solid k-mer set,
// upserts them (bitwise-or on duplicate keys) into a 2-choice cuckoo table
// together with the reference repeat set (payload bit 8), then packs the
// table into quotient slots [rem | valid | choice | payload]. One native
// pass replaces a numpy argsort+aggregate+place+encode chain that costs
// minutes at genome scale.

namespace {

inline u64 revcomp_u64(u64 x, int k)
{
    // complement every 2-bit base (A=0,C=1,T=2,G=3: complement = code^2)
    x ^= 0xAAAAAAAAAAAAAAAAULL;
    // reverse 2-bit groups within the word
    x = ((x >> 2) & 0x3333333333333333ULL) | ((x & 0x3333333333333333ULL) << 2);
    x = ((x >> 4) & 0x0F0F0F0F0F0F0F0FULL) | ((x & 0x0F0F0F0F0F0F0F0FULL) << 4);
    x = ((x >> 8) & 0x00FF00FF00FF00FFULL) | ((x & 0x00FF00FF00FF00FFULL) << 8);
    x = ((x >> 16) & 0x0000FFFF0000FFFFULL) | ((x & 0x0000FFFF0000FFFFULL) << 16);
    x = ((x >> 32) & 0x00000000FFFFFFFFULL) | ((x & 0x00000000FFFFFFFFULL) << 32);
    return x >> (64 - 2 * k);
}

struct QBuild {
    u64* keys;
    uint16_t* vals;
    uint8_t* choice;
    int log_size;
    u64* stash_k;
    uint16_t* stash_v;
    int64_t n_stash;
    int64_t max_stash;
    u64 rng;
    bool failed;

    inline u64 slot_of(u64 key, int ch) const
    {
        return mix(key, ch == 0 ? H1 : H2) >> (64 - log_size);
    }

    void upsert(u64 key, uint16_t bits)
    {
        u64 s1 = slot_of(key, 0);
        if (keys[s1] == key) { vals[s1] |= bits; return; }
        u64 s2 = slot_of(key, 1);
        if (keys[s2] == key) { vals[s2] |= bits; return; }
        if (keys[s1] == EMPTY) { keys[s1] = key; vals[s1] = bits; choice[s1] = 0; return; }
        if (keys[s2] == EMPTY) { keys[s2] = key; vals[s2] = bits; choice[s2] = 1; return; }
        // eviction walk
        u64 cur = key;
        uint16_t val = bits;
        int ch = 0;
        for (int step = 0; step < 1000; step++)
        {
            u64 s = slot_of(cur, ch);
            if (keys[s] == EMPTY) { keys[s] = cur; vals[s] = val; choice[s] = (uint8_t)ch; return; }
            u64 ok = keys[s]; uint16_t ov = vals[s]; int oc = choice[s];
            keys[s] = cur; vals[s] = val; choice[s] = (uint8_t)ch;
            cur = ok; val = ov;
            rng = rng * 6364136223846793005ULL + 1442695040888963407ULL;
            ch = (oc + 1) % 2;
        }
        if (n_stash >= max_stash) { failed = true; return; }
        stash_k[n_stash] = cur;
        stash_v[n_stash] = val;
        n_stash++;
    }
};

}  // namespace

// Returns stash size, or -1 when the table is too small (caller retries with
// log_size+1). tab_keys must be pre-filled with EMPTY; vals/choice/slots_out
// zeroed.
int64_t qmap_build(const u64* solid, int64_t n, int k,
                   const u64* repeat_keys, int64_t r, int log_size,
                   u64* tab_keys, uint16_t* tab_vals, uint8_t* tab_choice,
                   u64* slots_out,
                   u64* stash_keys, uint16_t* stash_vals, int64_t max_stash)
{
    QBuild b = {tab_keys, tab_vals, tab_choice, log_size,
                stash_keys, stash_vals, 0, max_stash,
                0x853C49E6748FEA9BULL, false};
    const int km1 = k - 1;
    const u64 mask_km1 = (k - 1 == 32) ? ~0ULL : ((1ULL << (2 * km1)) - 1);
    const int shift_first = 2 * km1;

    for (int64_t i = 0; i < n && !b.failed; i++)
    {
        u64 orient[2] = {solid[i], revcomp_u64(solid[i], k)};
        for (int o = 0; o < 2; o++)
        {
            u64 F = orient[o];
            // prefix rule: p = F >> 2 (as-read), x = last base -> ext_p[x]
            u64 p = (F >> 2) & mask_km1;
            int x = (int)(F & 3);
            u64 p_rc = revcomp_u64(p, km1);
            bool p_canon = p <= p_rc;
            int bit = p_canon ? x : 4 + (x ^ 2);
            b.upsert(p_canon ? p : p_rc, (uint16_t)(1u << bit));
            // suffix rule: s = F & mask, y = first base -> pre_s[y]
            u64 s = F & mask_km1;
            int y = (int)((F >> shift_first) & 3);
            u64 s_rc = revcomp_u64(s, km1);
            bool s_canon = s <= s_rc;
            bit = s_canon ? 4 + y : (y ^ 2);
            b.upsert(s_canon ? s : s_rc, (uint16_t)(1u << bit));
        }
    }
    for (int64_t j = 0; j < r && !b.failed; j++)
        b.upsert(repeat_keys[j], (uint16_t)(1u << 8));
    if (b.failed) return -1;

    // quotient-encode occupied slots
    const int shift = 64 - log_size;
    const u64 rem_mask = (shift == 64) ? ~0ULL : ((1ULL << shift) - 1);
    const int64_t size = 1LL << log_size;
    for (int64_t s = 0; s < size; s++)
    {
        if (tab_keys[s] == EMPTY) { slots_out[s] = 0; continue; }
        int ch = tab_choice[s];
        u64 h = mix(tab_keys[s], ch == 0 ? H1 : H2);
        slots_out[s] = ((h & rem_mask) << 11) | (1ULL << 10) | ((u64)ch << 9) | (u64)tab_vals[s];
    }
    return b.n_stash;
}

// ---------------------------------------------------------------------------
// Pair-coalesced map builder (ops/extmap.py build_fused_pair / QMapP):
// phase 1 builds the standard fused (k-1)-mer cuckoo table (as qmap_build);
// phase 2 derives the canonical (k-2)-mer bucket keys from its entries,
// places them in a second cuckoo, and packs each slot's two 64-bit lanes
// with the oriented 9-bit payloads of all eight (k-1)-mers containing the
// bucket key (L block = prepend y, R block = append x):
//   lane0: [0:8) L bits 28..35 | [8] choice | [9] valid | [10:55) rem45
//   lane1: [0:36) R | [36:64) L bits 0..27
// Returns the stash count, -1 when phase 1 overflows (grow log1), or -2
// when phase 2 overflows (grow log2). Requires log2_size >= 19.

namespace {

inline u64 shuffle02(u64 bits)
{
    // permute 4-bit bitmap positions b -> b^2 (swap 0<->2 and 1<->3)
    return ((bits >> 2) & 3) | ((bits & 3) << 2);
}

inline u64 flip9(u64 p)
{
    u64 ext = p & 0xF, pre = (p >> 4) & 0xF;
    return shuffle02(pre) | (shuffle02(ext) << 4) | (p & 0x100);
}

struct T1View {
    const u64* keys;
    const uint16_t* vals;
    int log_size;

    inline u64 get(u64 key) const
    {
        const int shift = 64 - log_size;
        u64 s1 = mix(key, H1) >> shift;
        if (keys[s1] == key) return vals[s1];
        u64 s2 = mix(key, H2) >> shift;
        if (keys[s2] == key) return vals[s2];
        return 0;
    }
};

}  // namespace

extern "C" int64_t qpmap_build(
    const u64* solid, int64_t n, int k,
    const u64* repeat_keys, int64_t r, int log1, int log2_size,
    u64* t1_keys, uint16_t* t1_vals, uint8_t* t1_choice,
    u64* t2_keys, uint8_t* t2_choice,
    u64* slots2,
    u64* stash_keys, u64* stash_l, u64* stash_r, int64_t max_stash)
{
    // ---- phase 1: fused (k-1)-mer map (same derivation as qmap_build) ----
    QBuild b1 = {t1_keys, t1_vals, t1_choice, log1,
                 nullptr, nullptr, 0, 0,  // no stash: overflow = fail
                 0x853C49E6748FEA9BULL, false};
    const int km1 = k - 1, km2 = k - 2;
    const u64 mask_km1 = (km1 == 32) ? ~0ULL : ((1ULL << (2 * km1)) - 1);
    const u64 mask_km2 = ((1ULL << (2 * km2)) - 1);
    const int shift_first = 2 * km1;

    for (int64_t i = 0; i < n && !b1.failed; i++)
    {
        u64 orient[2] = {solid[i], revcomp_u64(solid[i], k)};
        for (int o = 0; o < 2; o++)
        {
            u64 F = orient[o];
            u64 p = (F >> 2) & mask_km1;
            int x = (int)(F & 3);
            u64 p_rc = revcomp_u64(p, km1);
            bool p_canon = p <= p_rc;
            int bit = p_canon ? x : 4 + (x ^ 2);
            b1.upsert(p_canon ? p : p_rc, (uint16_t)(1u << bit));
            u64 s = F & mask_km1;
            int y = (int)((F >> shift_first) & 3);
            u64 s_rc = revcomp_u64(s, km1);
            bool s_canon = s <= s_rc;
            bit = s_canon ? 4 + y : (y ^ 2);
            b1.upsert(s_canon ? s : s_rc, (uint16_t)(1u << bit));
        }
    }
    for (int64_t j = 0; j < r && !b1.failed; j++)
        b1.upsert(repeat_keys[j], (uint16_t)(1u << 8));
    if (b1.failed) return -1;

    T1View t1 = {t1_keys, t1_vals, log1};

    // ---- phase 2a: place canonical (k-2)-mer bucket keys ----
    struct K2Build {
        u64* keys; uint8_t* choice; int log_size; u64 rng; bool failed;
        u64* stash; int64_t n_stash; int64_t max_stash;
        inline u64 slot_of(u64 key, int ch) const
        { return mix(key, ch == 0 ? H1 : H2) >> (64 - log_size); }
        void insert(u64 key)
        {
            u64 s1 = slot_of(key, 0);
            if (keys[s1] == key) return;
            u64 s2 = slot_of(key, 1);
            if (keys[s2] == key) return;
            for (int64_t i = 0; i < n_stash; i++) if (stash[i] == key) return;
            if (keys[s1] == EMPTY) { keys[s1] = key; choice[s1] = 0; return; }
            if (keys[s2] == EMPTY) { keys[s2] = key; choice[s2] = 1; return; }
            u64 cur = key; int ch = 0;
            for (int step = 0; step < 1000; step++)
            {
                u64 s = slot_of(cur, ch);
                if (keys[s] == EMPTY) { keys[s] = cur; choice[s] = (uint8_t)ch; return; }
                u64 ok = keys[s]; int oc = choice[s];
                keys[s] = cur; choice[s] = (uint8_t)ch;
                cur = ok;
                rng = rng * 6364136223846793005ULL + 1442695040888963407ULL;
                ch = (oc + 1) % 2;
            }
            if (n_stash >= max_stash) { failed = true; return; }
            stash[n_stash++] = cur;
        }
    };
    K2Build b2 = {t2_keys, t2_choice, log2_size, 0x2545F4914F6CDD1DULL, false,
                  stash_keys, 0, max_stash};
    const int64_t size1 = 1LL << log1;
    for (int64_t s = 0; s < size1 && !b2.failed; s++)
    {
        if (t1_keys[s] == EMPTY) continue;
        u64 orient[2] = {t1_keys[s], revcomp_u64(t1_keys[s], km1)};
        for (int o = 0; o < 2; o++)
        {
            u64 F = orient[o];
            u64 pre2 = (F >> 2) & mask_km2;
            u64 suf2 = F & mask_km2;
            u64 pre2_rc = revcomp_u64(pre2, km2);
            u64 suf2_rc = revcomp_u64(suf2, km2);
            b2.insert(pre2 <= pre2_rc ? pre2 : pre2_rc);
            b2.insert(suf2 <= suf2_rc ? suf2 : suf2_rc);
        }
    }
    if (b2.failed) return -2;

    // ---- phase 2b: pack lanes ----
    const int shift2 = 64 - log2_size;
    const u64 rem_mask2 = (1ULL << shift2) - 1;
    const int shift_first2 = 2 * km2;

    auto fetch9 = [&](u64 s_asread) -> u64 {
        u64 c = revcomp_u64(s_asread, km1);
        bool canon = s_asread <= c;
        u64 key = canon ? s_asread : c;
        u64 v = t1.get(key);
        return canon ? v : flip9(v);
    };
    auto lanes_of = [&](u64 rk, u64& L, u64& R) {
        L = 0; R = 0;
        for (u64 bb = 0; bb < 4; bb++)
        {
            L |= fetch9((bb << shift_first2) | rk) << (9 * bb);
            R |= fetch9((rk << 2) | bb) << (9 * bb);
        }
    };

    const int64_t size2 = 1LL << log2_size;
    for (int64_t s = 0; s < size2; s++)
    {
        if (t2_keys[s] == EMPTY) { slots2[2 * s] = 0; slots2[2 * s + 1] = 0; continue; }
        u64 key = t2_keys[s];
        int ch = t2_choice[s];
        u64 h = mix(key, ch == 0 ? H1 : H2);
        u64 L, R;
        lanes_of(key, L, R);
        slots2[2 * s] = (L >> 28) | ((u64)ch << 8) | (1ULL << 9)
                        | ((h & rem_mask2) << 10);
        slots2[2 * s + 1] = R | ((L & ((1ULL << 28) - 1)) << 36);
    }
    for (int64_t i = 0; i < b2.n_stash; i++)
    {
        u64 L, R;
        lanes_of(stash_keys[i], L, R);
        stash_l[i] = L;
        stash_r[i] = R;
    }
    return b2.n_stash;
}

// ---------------------------------------------------------------------------
// Bucketized single-probe map builder (ops/extmap.py build_fused_bucket):
// same fused (k-1)-mer entry derivation as qmap_build, but placement is one
// H1 bucket of 16 quotient slots per key — no eviction walk. Returns stash
// size (bucket-overflow keys) or -1 if it exceeds max_stash. slots must be
// zeroed by the caller; stash merge handles duplicate keys.

namespace {

struct QBBuild {
    u64* slots;      // [nb * 16]
    int log_nb;
    u64* stash_k;
    uint16_t* stash_v;
    int64_t n_stash;
    int64_t max_stash;
    bool failed;

    void upsert(u64 key, uint16_t bits)
    {
        const int shift = 64 - log_nb;
        u64 h = mix(key, H1);
        u64 rem = (shift == 64) ? h : (h & ((1ULL << shift) - 1));
        u64* b = slots + ((h >> shift) << 4);
        u64 tagged = (rem << 10) | (1ULL << 9);
        for (int s = 0; s < 16; s++)
        {
            if ((b[s] >> 9) == ((tagged >> 9)))  // same rem + valid
            {
                b[s] |= (u64)bits;
                return;
            }
            if (b[s] == 0)
            {
                b[s] = tagged | (u64)bits;
                return;
            }
        }
        for (int64_t i = 0; i < n_stash; i++)
            if (stash_k[i] == key) { stash_v[i] |= bits; return; }
        if (n_stash >= max_stash) { failed = true; return; }
        stash_k[n_stash] = key;
        stash_v[n_stash] = bits;
        n_stash++;
    }
};

}  // namespace

int64_t qbmap_build(const u64* solid, int64_t n, int k,
                    const u64* repeat_keys, int64_t r, int log_nb,
                    u64* slots,
                    u64* stash_keys, uint16_t* stash_vals, int64_t max_stash)
{
    QBBuild b = {slots, log_nb, stash_keys, stash_vals, 0, max_stash, false};
    const int km1 = k - 1;
    const u64 mask_km1 = (km1 == 32) ? ~0ULL : ((1ULL << (2 * km1)) - 1);
    const int shift_first = 2 * km1;

    for (int64_t i = 0; i < n && !b.failed; i++)
    {
        u64 orient[2] = {solid[i], revcomp_u64(solid[i], k)};
        for (int o = 0; o < 2; o++)
        {
            u64 F = orient[o];
            u64 p = (F >> 2) & mask_km1;
            int x = (int)(F & 3);
            u64 p_rc = revcomp_u64(p, km1);
            bool p_canon = p <= p_rc;
            int bit = p_canon ? x : 4 + (x ^ 2);
            b.upsert(p_canon ? p : p_rc, (uint16_t)(1u << bit));
            u64 s = F & mask_km1;
            int y = (int)((F >> shift_first) & 3);
            u64 s_rc = revcomp_u64(s, km1);
            bool s_canon = s <= s_rc;
            bit = s_canon ? 4 + y : (y ^ 2);
            b.upsert(s_canon ? s : s_rc, (uint16_t)(1u << bit));
        }
    }
    for (int64_t j = 0; j < r && !b.failed; j++)
        b.upsert(repeat_keys[j], (uint16_t)(1u << 8));
    if (b.failed) return -1;
    return b.n_stash;
}

// Same as extmap_place but with 16-bit payloads (used by the fused
// quotient map: 8 ext/pre bits + repeat bit).
int64_t extmap_place16(const u64* keys, const uint16_t* values, int64_t n, int log_size,
                       u64* table, uint16_t* payload, uint8_t* slot_choice,
                       u64* stash_keys, uint16_t* stash_vals, int64_t max_stash)
{
    const int shift = 64 - log_size;
    u64 rng = 0x853C49E6748FEA9BULL;
    int64_t n_stash = 0;

    for (int64_t i = 0; i < n; i++)
    {
        u64 cur = keys[i];
        uint16_t val = values ? values[i] : 1;
        int choice = 0;
        bool placed = false;
        for (int step = 0; step < 1000; step++)
        {
            u64 slot = mix(cur, choice == 0 ? H1 : H2) >> shift;
            if (table[slot] == EMPTY)
            {
                table[slot] = cur;
                payload[slot] = val;
                slot_choice[slot] = (uint8_t)choice;
                placed = true;
                break;
            }
            u64 old_key = table[slot];
            uint16_t old_val = payload[slot];
            int old_choice = slot_choice[slot];
            table[slot] = cur;
            payload[slot] = val;
            slot_choice[slot] = (uint8_t)choice;
            cur = old_key;
            val = old_val;
            rng = rng * 6364136223846793005ULL + 1442695040888963407ULL;
            choice = (old_choice + 1) % 2;
        }
        if (!placed)
        {
            if (n_stash >= max_stash) return -1;
            stash_keys[n_stash] = cur;
            stash_vals[n_stash] = val;
            n_stash++;
        }
    }
    return n_stash;
}

}  // extern "C"
