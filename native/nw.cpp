// Needleman-Wunsch identity with reference semantics (reference
// src/Utils.cpp:87-189: gap -5, mismatch -5, match +10; identity =
// #diagonal-matches-on-traceback / max(len); traceback prefers diagonal,
// then up (i-1,j), then left (i,j-1)).
//
// Instead of materializing the (n+1)x(m+1) matrix and walking it backwards,
// carry a second DP plane f[i][j] = matches along the path the backward
// traceback WOULD take from (i,j): the traceback makes purely local
// decisions on score values, so the preference order is reproduced exactly
// by a forward selection — O(m) memory, O(nm) time, bit-identical identity.
//
// Built on first use by mindthegap_tpu/utils/native_build.py (g++ -O3 -shared -fPIC),
// into native/libnw-<hash of source, flags and compiler>.so.

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

double nw_identity(const char* a, int64_t n, const char* b, int64_t m)
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

}  // extern "C"
