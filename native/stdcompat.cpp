// Native runtime helpers.
//
// stdmap_iteration_order: reproduce the iteration order of a libstdc++
// std::unordered_map<std::string, V> given keys in insertion order. The
// reference tool iterates such maps when grouping gap-fill solutions by
// target (reference src/Filler.cpp:924-936) and when scanning target
// dictionaries; the file output order of multi-target jobs depends on it.
// Using the real container guarantees byte-faithful ordering.
//
// Built on first use by mindthegap_tpu/utils/native_build.py (g++ -O2 -shared -fPIC),
// into native/libstdcompat-<hash of source, flags and compiler>.so.

#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// keys: array of n NUL-terminated strings, inserted in order 0..n-1.
// out: receives the original indices in map-iteration order.
// Returns the number of distinct keys (duplicate keys keep first index).
int stdmap_iteration_order(const char** keys, int n, int* out)
{
    std::unordered_map<std::string, int> m;
    for (int i = 0; i < n; i++)
    {
        m.insert({std::string(keys[i]), i});
    }
    int j = 0;
    for (auto& kv : m)
    {
        out[j++] = kv.second;
    }
    return j;
}

}  // extern "C"
