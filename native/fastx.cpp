// Native FASTA/FASTQ reader: the bank IO layer (GATB Bank equivalent —
// reference call sites src/Finder.cpp:306, src/Filler.cpp:285-292).
//
// Parses plain or gzip FASTA/FASTQ and returns, in one pass:
//   - a packed 2-bit code buffer (A=0 C=1 T=2 G=3, 255 = invalid) holding
//     all sequences concatenated,
//   - per-record offsets into that buffer,
//   - the concatenated NUL-separated header lines.
//
// The device pipeline consumes the code buffer directly (no per-record
// python string handling on the hot path).
//
// Built on first use by mindthegap_tpu/utils/native_build.py (g++ -O2 -shared -fPIC ... -lz),
// into native/libfastx-<hash of source, flags and compiler>.so.

#include <zlib.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Parsed
{
    std::vector<uint8_t> codes;
    std::vector<int64_t> offsets;  // n+1 entries
    std::string headers;           // NUL separated
    int64_t n = 0;
};

uint8_t g_lut[256];

void init_lut()
{
    static bool done = false;
    if (done) return;
    memset(g_lut, 255, sizeof(g_lut));
    g_lut[(int)'A'] = 0; g_lut[(int)'a'] = 0;
    g_lut[(int)'C'] = 1; g_lut[(int)'c'] = 1;
    g_lut[(int)'T'] = 2; g_lut[(int)'t'] = 2;
    g_lut[(int)'G'] = 3; g_lut[(int)'g'] = 3;
    done = true;
}

bool read_all(const char* path, std::string& out)
{
    gzFile f = gzopen(path, "rb");
    if (!f) return false;
    char buf[1 << 16];
    int n;
    while ((n = gzread(f, buf, sizeof(buf))) > 0)
    {
        out.append(buf, n);
    }
    gzclose(f);
    return true;
}

}  // namespace

extern "C" {

// Returns an opaque handle (Parsed*), or nullptr on failure.
void* fastx_parse(const char* path)
{
    init_lut();
    std::string data;
    if (!read_all(path, data)) return nullptr;
    if (data.empty()) return nullptr;

    Parsed* p = new Parsed();
    p->offsets.push_back(0);

    size_t i = 0;
    const size_t len = data.size();
    const bool fastq = data[0] == '@';
    const bool fasta = data[0] == '>';
    if (!fasta && !fastq)
    {
        delete p;
        return nullptr;
    }

    auto line_end = [&](size_t from) {
        const char* nl = (const char*)memchr(data.data() + from, '\n', len - from);
        return nl ? (size_t)(nl - data.data()) : len;
    };

    while (i < len)
    {
        if (data[i] == '\r' || data[i] == '\n') { i++; continue; }
        size_t e = line_end(i);
        size_t hdr_end = e;
        if (hdr_end > i && data[hdr_end - 1] == '\r') hdr_end--;
        // header line
        p->headers.append(data, i + 1, hdr_end - i - 1);
        p->headers.push_back('\0');
        i = e + 1;
        if (fasta)
        {
            while (i < len && data[i] != '>')
            {
                size_t e2 = line_end(i);
                size_t s_end = e2;
                if (s_end > i && data[s_end - 1] == '\r') s_end--;
                for (size_t j = i; j < s_end; j++)
                {
                    p->codes.push_back(g_lut[(uint8_t)data[j]]);
                }
                i = e2 + 1;
            }
        }
        else  // fastq: one sequence line, then '+' line, then quality line
        {
            size_t e2 = line_end(i);
            size_t s_end = e2;
            if (s_end > i && data[s_end - 1] == '\r') s_end--;
            for (size_t j = i; j < s_end; j++)
            {
                p->codes.push_back(g_lut[(uint8_t)data[j]]);
            }
            i = e2 + 1;
            i = line_end(i) + 1;  // '+'
            i = line_end(i) + 1;  // quality
        }
        p->offsets.push_back((int64_t)p->codes.size());
        p->n++;
    }
    return p;
}

int64_t fastx_n(void* h) { return ((Parsed*)h)->n; }
int64_t fastx_codes_size(void* h) { return (int64_t)((Parsed*)h)->codes.size(); }
int64_t fastx_headers_size(void* h) { return (int64_t)((Parsed*)h)->headers.size(); }
const uint8_t* fastx_codes(void* h) { return ((Parsed*)h)->codes.data(); }
const int64_t* fastx_offsets(void* h) { return ((Parsed*)h)->offsets.data(); }
const char* fastx_headers(void* h) { return ((Parsed*)h)->headers.data(); }
void fastx_free(void* h) { delete (Parsed*)h; }

}  // extern "C"
